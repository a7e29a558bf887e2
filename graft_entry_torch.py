"""Entry points of the PyTorch / CUDA port (pob_tpu_torch), beside
__graft_entry__.py for the JAX package.

- entry(): the flagship forward step on the card: a batch-2 ProofOfBurn
  forward (witness checks and public commitment) at TEST_CONFIG from the
  fixture tests/fixtures/pob_input.json. Returns (fn, args); fn(*args) gives
  (commitment limbs (2, 16), valid (2,)).
- dryrun_multichip(n, device=None): the multi-device path on an n-device
  mesh (the first n cards; with `device` n copies of that device: a
  virtual mesh; once init_multihost has run, the mesh across its n
  processes, each running this function): data-parallel PoB forward,
  point-sharded MSM with its collective reduction, the four-step
  distributed NTT, and a mesh-sharded Groth16 prove, one step each on small
  shapes, with a progress line after every step."""

import json
import os
import random
import time

_T0 = time.perf_counter()


def _log(msg):
    print(f"[dryrun +{time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def _pob_batch(batch: int):
    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG
    from pob_tpu_torch.harness.inputs import batch_stack, load_pob_input

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "pob_input.json")
    with open(fix) as f:
        inp = load_pob_input(json.load(f), TEST_CONFIG)
    return TEST_CONFIG, batch_stack([inp] * batch)


def entry(device=None):
    """(fn, example_args) for the batch-2 PoB forward on `device` (the card
    unless the caller asks for the CPU)."""
    from pob_tpu_torch import _build
    from pob_tpu_torch.circuits.proof_of_burn import pob_forward
    from pob_tpu_torch.harness.inputs import to_device

    dev = _build.resolve_device(device)
    cfg, kw = _pob_batch(2)
    kwargs = to_device(kw, dev)
    keys = sorted(kwargs)

    def fn(*arrs):
        out = pob_forward(cfg, **dict(zip(keys, arrs)))
        return out["commitment"], out["valid"]

    return fn, tuple(kwargs[k] for k in keys)


def _chain_cs(n_mul: int):
    """x, y secret; chain c_{i+1} = c_i * c_i from c_0 = x y; publics
    [c_last x, c_last y]."""
    from pob_tpu_torch.r1cs.builder import ConstraintSystem

    cs = ConstraintSystem()
    pub = cs.alloc_block("pub", (2,))
    cs.mark_public(2)
    priv = cs.alloc_block("priv", (2,))
    chain = cs.alloc_block("chain", (n_mul,))
    cs.add([(int(priv[0]), 1)], [(int(priv[1]), 1)], [(int(chain[0]), 1)])
    for i in range(1, n_mul):
        cs.add([(int(chain[i - 1]), 1)], [(int(chain[i - 1]), 1)], [(int(chain[i]), 1)])
    cs.add([(int(chain[-1]), 1)], [(int(priv[0]), 1)], [(int(pub[0]), 1)])
    cs.add([(int(chain[-1]), 1)], [(int(priv[1]), 1)], [(int(pub[1]), 1)])
    return cs


def dryrun_multichip(n_devices: int, device=None) -> None:
    import numpy as np
    import torch

    from pob_tpu_torch.circuits.proof_of_burn import pob_forward
    from pob_tpu_torch.dist.mesh import data_mesh, gather, local, on, shard
    from pob_tpu_torch.dist.msm_sharded import msm_g1_sharded
    from pob_tpu_torch.dist.ntt_sharded import ntt_sharded, untranspose_host
    from pob_tpu_torch.dist.prove_sharded import prove_sharded, shard_pk
    from pob_tpu_torch.field import limb
    from pob_tpu_torch.field.ref import FR_MOD, G1_GEN, g1_mul
    from pob_tpu_torch.prover import curve, groth16, ntt

    mesh = data_mesh(n_devices, device=device)
    dev = mesh.devices[mesh.local_ids[0]]
    where = "one process" if mesh.rank is None else f"rank {mesh.rank} of {n_devices}"
    _log(f"mesh {[str(d) for d in mesh.devices]} ({where})")
    # step 2's MSM length, and step 4's chain length (domain 2^k)
    k = max(6, 2 * (n_devices - 1).bit_length())
    n_msm = 1 << k

    # 1. data-parallel witness generation: the proof batch sharded over the
    # mesh, this process's shards forwarded
    cfg, kwargs = _pob_batch(n_devices)
    names = sorted(kwargs)
    shards = [shard(mesh, torch.from_numpy(np.ascontiguousarray(kwargs[name], np.int32)))
              for name in names]
    for _, d, *parts in local(mesh, *shards):
        with on(d):
            out = pob_forward(cfg, **dict(zip(names, parts)))
        if not bool(out["valid"].all()):
            raise AssertionError("sharded witness gen must validate")
    _log("step 1/4 ok: data-parallel PoB witness generation")

    # 2. point-sharded MSM with collective reduction over the mesh
    m = n_msm
    pts = curve.g1_points_to_device([g1_mul(G1_GEN, i + 1) for i in range(m)], dev)
    scalars = limb.to_device(limb.ints_to_limbs([i + 1 for i in range(m)]), dev)
    res = msm_g1_sharded(mesh, pts, scalars)
    expect = sum((i + 1) * (i + 1) for i in range(m))  # sum (i+1) * (i+1)G
    if curve.to_affine_host("fq", res) != g1_mul(G1_GEN, expect):
        raise AssertionError("point-sharded MSM gives the wrong point")
    _log(f"step 2/4 ok: point-sharded MSM (m={m})")

    # 3. distributed four-step NTT (all_to_all over the mesh)
    k1 = k2 = max(3, (n_devices - 1).bit_length())
    n = 1 << (k1 + k2)
    r = (1 << 256) % FR_MOD
    coeffs = [(i * 7919 + 13) % FR_MOD for i in range(n)]
    a = limb.to_device(limb.ints_to_limbs([c * r % FR_MOD for c in coeffs]), dev)
    c_out = list(gather(mesh, ntt_sharded(mesh, a, k1, k2)))
    if not np.array_equal(untranspose_host(c_out), ntt.ntt(a, k1 + k2).cpu().numpy()):
        raise AssertionError("four-step NTT differs from the local transform")
    _log(f"step 3/4 ok: four-step all_to_all NTT (n={n})")

    # 4. mesh-sharded Groth16 prove of ONE proof (point-sharded MSMs and the
    # all_to_all four-step h pipeline), verified by the host pairing. The
    # local-prover cross-check is opt-in via POB_DRYRUN_LOCAL_COMPARE, as in
    # __graft_entry__.py.
    n_mul = n_msm - 6
    cs = _chain_cs(n_mul)
    x, y = 31415, 92653
    cvals = [x * y % FR_MOD]
    for _ in range(1, n_mul):
        cvals.append(cvals[-1] * cvals[-1] % FR_MOD)
    w = [1, cvals[-1] * x % FR_MOD, cvals[-1] * y % FR_MOD, x, y] + cvals
    # toxic waste from one seed, so that every rank of a mesh across
    # processes makes the same key
    rnd = random.Random(7503)
    pk, vk = groth16.setup(cs, rng=lambda: rnd.randrange(1, FR_MOD), plan=False, device=dev)
    _log(f"step 4/4: setup done (domain 2^{pk.k}, nw={cs.num_wires})")
    witness = limb.ints_to_limbs(w)
    spk = shard_pk(pk, mesh)
    _log("step 4/4: pk sharded over mesh")
    proof = prove_sharded(spk, witness, r=1234, s=5678)
    _log("step 4/4: sharded prove complete")
    if not groth16.verify(vk, proof, w[1:3]):
        raise AssertionError("sharded proof must verify")
    if os.environ.get("POB_DRYRUN_LOCAL_COMPARE", "0") == "1":
        if proof != groth16.prove(pk, witness, r=1234, s=5678):
            raise AssertionError("sharded prove must be mesh-shape invariant")
        _log("step 4/4: local-prover cross-check ok")
    print(f"dryrun_multichip ok on {n_devices} devices in "
          f"{time.perf_counter() - _T0:.1f}s "
          f"(witness-dp, msm-shard, ntt-a2a, sharded-prove+verify)")
