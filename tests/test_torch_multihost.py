"""The port's mesh across processes on the CPU: init_multihost against
pob_tpu's (argument resolution), and the dist layer over gloo in worlds of
4 and 2 processes, held against the port's local functions with tolerance
0 (every rank's result bit-identical, and equal to the local one).

Each rank is this file run as a script (``python test_torch_multihost.py
SCENARIO RANK WORLD PORT DIR``): it joins the world through init_multihost
(device="cpu", a 60 s timeout), runs the scenario on data_mesh(), and
writes its results to DIR/rank<R>.json; the test compares them. The parent
picks a free port by binding port 0, computes the local references while the
ranks run, kills every rank as soon as one fails or the deadline passes, and
reports the failed ranks' output.

pob_tpu's ntt_sharded is no oracle at (3, 3) on 2 or 4 devices (its
all_to_all inserts the gathered axis at 2, which scrambles a row whenever a
shard holds more than one column): the four-step is held against the local
transform."""

import datetime
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from pob_tpu_torch.dist import mesh as tmesh
from pob_tpu_torch.dist.mesh import data_mesh, gather
from pob_tpu_torch.dist.msm_sharded import msm_g1_sharded, msm_g2_sharded
from pob_tpu_torch.dist.ntt_sharded import ntt_sharded, untranspose_host
from pob_tpu_torch.dist.pipeline import Groth16Pipeline
from pob_tpu_torch.dist.prove_sharded import prove_sharded, shard_pk
from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FR_MOD, G1_GEN, G2_GEN, g1_mul, g2_mul
from pob_tpu_torch.prover import curve, groth16, msm, ntt

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 60  # init_process_group's timeout in every rank
DEADLINE_S = 150  # a world's wall time before the test kills its ranks
RS = (1234, 5678)
MSM_M = 13  # padded with infinity to 16 on 4 ranks

torch.set_num_threads(1)


def _mont_vector(n: int):
    r = (1 << 256) % FR_MOD
    return limb.to_device(limb.ints_to_limbs([(i * 7919 + 13) % FR_MOD * r % FR_MOD
                                              for i in range(n)]), "cpu")


def _msm_inputs(group: str):
    """MSM_M points i + 3 times the generator, and 64-bit scalars."""
    gen, mul, to_dev = {"g1": (G1_GEN, g1_mul, curve.g1_points_to_device),
                        "g2": (G2_GEN, g2_mul, curve.g2_points_to_device)}[group]
    pts = to_dev([mul(gen, i + 3) for i in range(MSM_M)], "cpu")
    sc = limb.to_device(limb.ints_to_limbs([(i * 0x9E3779B97F4A7C15 + 5) % FR_MOD
                                            for i in range(MSM_M)]), "cpu")
    return pts, sc


def _jsonable(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# a rank (this file run as a script)
# ---------------------------------------------------------------------------


def _four_step(mesh, out: dict):
    a = _mont_vector(64)
    for key, inverse in (("ntt", False), ("intt", True)):
        c = ntt_sharded(mesh, a, 3, 3, inverse=inverse)
        out[key + "_block_shape"] = list(c[0].shape)
        out[key] = untranspose_host(list(gather(mesh, c))).tolist()


def _raises(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _world4(mesh, d: Path, rank: int, out: dict):
    _four_step(mesh, out)
    for group, fn in (("g1", msm_g1_sharded), ("g2", msm_g2_sharded)):
        pts, sc = _msm_inputs(group)
        out["msm_" + group] = curve.to_affine_host("fq" if group == "g1" else "fq2",
                                                   fn(mesh, pts, sc))
    pk, _ = groth16.load_pk(str(d / "pk.npz"), device="cpu")
    witness = np.load(d / "witness.npy")
    spk = shard_pk(pk, mesh)
    out["proof"] = prove_sharded(spk, witness, *RS)
    out["proofs_random_rs"] = [prove_sharded(spk, witness) for _ in range(2)]
    bad = pk
    if rank == len(mesh.devices) - 1:  # one limb of one h-query point differs
        x = pk.h_query[0].clone()
        x[5, 3] ^= 1
        bad = replace(pk, h_query=(x,) + pk.h_query[1:])
    out["shard_pk_refused"] = _raises(lambda: shard_pk(bad, mesh))
    out["pipeline_refused"] = [_raises(lambda: Groth16Pipeline(pk, None)),
                               _raises(lambda: Groth16Pipeline(pk, None, devices=mesh))]


def _rank_main(scenario: str, rank: int, world: int, port: int, d: Path):
    torch.set_num_threads(1)
    info = tmesh.init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    mesh = data_mesh()
    out = {"info": info, "mesh": [str(x) for x in mesh.devices], "rank": mesh.rank,
           "data_mesh_other_n": _raises(lambda: data_mesh(world + 1))}
    if scenario == "world4":
        _world4(mesh, d, rank, out)
    else:
        _four_step(mesh, out)
    torch.distributed.destroy_process_group()
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# the tests (the parent)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _World:
    """`world` ranks of `scenario` started now, each with its log in d; as a
    context manager, every rank still running is killed on exit."""

    def __init__(self, scenario: str, world: int, d: Path):
        self.d, self.t0 = d, time.monotonic()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]), OMP_NUM_THREADS="1")
        port = _free_port()
        self.logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(world), str(port), str(d)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop()

    def _stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for log in self.logs:
            log.close()

    def join(self) -> list:
        """Each rank's results; fails (after killing every rank still running)
        when a rank fails or the deadline passes."""
        try:
            while any(p.poll() is None for p in self.procs):
                if (time.monotonic() - self.t0 > DEADLINE_S
                        or any(p.poll() not in (None, 0) for p in self.procs)):
                    break
                time.sleep(0.05)
        finally:
            self._stop()
        rcs = [p.returncode for p in self.procs]
        if rcs != [0] * len(rcs):
            tails = {r: (self.d / f"rank{r}.log").read_text()[-3000:]
                     for r, rc in enumerate(rcs) if rc != 0}
            pytest.fail(f"ranks exited {rcs} after {time.monotonic() - self.t0:.1f} s: {tails}")
        return [json.loads((self.d / f"rank{r}.json").read_text()) for r in range(len(rcs))]


def _check_common(results, world: int):
    for r, res in enumerate(results):
        assert res["info"] == {"coordinator": res["info"]["coordinator"], "num_processes": world,
                               "process_id": r, "process_index": r, "global_devices": world,
                               "local_devices": 1}
        assert res["rank"] == r and res["mesh"] == ["cpu"] * world
        assert res["data_mesh_other_n"] is not None
    a = _mont_vector(64)
    for key, fn in (("ntt", ntt.ntt), ("intt", ntt.intt)):
        want = fn(a, 6).numpy().tolist()
        for res in results:
            assert res[key + "_block_shape"] == [8 // world, 8, 16]
            assert res[key] == want


def _line_key(d: Path):
    """test_torch_dist's _line_cs (domain 2^4) keyed from a fixed rng, saved
    for the ranks; its witness too."""
    sys.path.insert(0, str(Path(__file__).parent))
    from test_torch_dist import _line_cs, _line_witness

    cs = _line_cs()
    w, pub = _line_witness(31415, 92653)
    pk, vk = groth16.setup(cs, rng=iter(range(101, 200, 7)).__next__, plan=False, device="cpu")
    groth16.save_pk(str(d / "pk.npz"), pk, vk)
    witness = limb.ints_to_limbs(w)
    np.save(d / "witness.npy", witness)
    return pk, vk, witness, pub


def test_world_of_4(tmp_path):
    """ntt_sharded and its inverse at (3, 3), msm_sharded on G1 and G2 at
    m = 13 (padded to 16), prove_sharded of _line_cs at fixed (r, s) and
    twice at r = s = None, shard_pk refusing a key that differs on one rank,
    Groth16Pipeline refusing the mesh, over 4 gloo ranks."""
    pk, vk, witness, pub = _line_key(tmp_path)
    with _World("world4", 4, tmp_path) as world:
        # the local references, while the ranks run
        want_msm = {}
        for group in ("g1", "g2"):
            pts, sc = _msm_inputs(group)
            ops = curve.ops_for(group)
            want_msm[group] = _jsonable(curve.to_affine_host(
                ops.name, tuple(c[0] for c in msm.msm_plain(ops, pts, sc[None]))))
        want = groth16.prove_batch(pk, torch.from_numpy(witness)[None], rs=[RS])[0]
        assert groth16.verify(vk, want, pub)
        assert not groth16.verify(vk, want, [pub[0], (pub[1] + 1) % FR_MOD])
        results = world.join()

    _check_common(results, 4)
    for res in results:
        assert res["msm_g1"] == want_msm["g1"] and res["msm_g2"] == want_msm["g2"]
        assert res["proof"] == _jsonable(want)
        assert res["shard_pk_refused"] is not None and "ranks [3]" in res["shard_pk_refused"]
        assert all(msg is not None for msg in res["pipeline_refused"])
    for run in range(2):
        proof = results[0]["proofs_random_rs"][run]
        assert all(res["proofs_random_rs"][run] == proof for res in results)
        A, B2, C = proof
        assert groth16.verify(vk, (tuple(A), tuple(tuple(c) for c in B2), tuple(C)), pub)
    assert results[0]["proofs_random_rs"][0] != results[0]["proofs_random_rs"][1]


def test_world_of_2_four_step(tmp_path):
    """The four-step at (3, 3) on 2 ranks, where a shard holds 4 columns
    (pob_tpu's four-step goes wrong there), against the local transform."""
    with _World("world2", 2, tmp_path) as world:
        _check_common(world.join(), 2)


CASES = {
    # id: (args, environment)
    "explicit": (("host0:1234", 4, 2), {}),
    "environment": ((), {"POB_COORDINATOR": "host9:999", "POB_NUM_PROCESSES": "8",
                         "POB_PROCESS_ID": "5"}),
    "mixed": (("host1:42", None, 1), {"POB_COORDINATOR": "host9:999",
                                       "POB_NUM_PROCESSES": "8", "POB_PROCESS_ID": "5"}),
    "no_coordinator": ((None, 4, 2), {"POB_NUM_PROCESSES": "8", "POB_PROCESS_ID": "5"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_init_multihost_resolves_like_pob_tpu(monkeypatch, case):
    """Both init_multihosts with their process-group calls replaced: the
    same (coordinator, num_processes, process_id), or None from both."""
    import jax

    from pob_tpu.dist import mesh as jmesh

    args, env = CASES[case]
    for key in ("POB_COORDINATOR", "POB_NUM_PROCESSES", "POB_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: jcalls.append(kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: tcalls.append(dict(kw, backend=backend)))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a, **k: tcalls[-1]["rank"])
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda *a, **k: tcalls[-1]["world_size"])
    timeout = datetime.timedelta(seconds=7)
    jinfo = jmesh.init_multihost(*args)
    tinfo = tmesh.init_multihost(*args, device="cpu", timeout=timeout)
    if case == "no_coordinator":
        assert jinfo is None and tinfo is None and jcalls == [] and tcalls == []
        return
    (jkw,), (tkw,) = jcalls, tcalls
    resolved = (jkw["coordinator_address"], jkw["num_processes"], jkw["process_id"])
    assert tkw == {"backend": "gloo", "init_method": f"tcp://{resolved[0]}",
                   "world_size": resolved[1], "rank": resolved[2], "timeout": timeout}
    for info in (jinfo, tinfo):
        assert (info["coordinator"], info["num_processes"], info["process_id"]) == resolved
    assert tinfo["process_index"] == resolved[2] and tinfo["global_devices"] == resolved[1]
    assert tinfo["local_devices"] == 1


def test_init_multihost_without_card_raises(monkeypatch):
    """No card and no device="cpu": it raises and never falls back to gloo."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append(kw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_multihost("host0:1234", 2, 0)
    assert calls == []


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               Path(sys.argv[5]))
