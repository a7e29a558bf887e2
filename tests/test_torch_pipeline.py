"""The port's pipelined prover (pob_tpu_torch/dist/pipeline.py) on virtual
CPU device lists, as tests/test_pipeline.py drives pob_tpu's on its virtual
devices: the streamed proofs equal the port's prove_batch at the same (r, s)
and verify, with one MSM device and with an MSM group of 4 shards; the
port's prove_sharded at D = 1 gives the same proof.

The key is pob_tpu's (setup_host of toy_cs, read by the port's load_pk), and
the proofs are also held against pob_tpu's own: its h stage
(_h_batch_kernel), the five MSM sums by field/ref.py ints over its query
points, and its finish_proof. Its MSM programs (_msm_batch_kernel, used by
its prove and its Groth16Pipeline) cost minutes of tracing on the CPU, and
a sum of ints is the same point."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_groth16 import toy_cs, toy_witness  # noqa: E402

from pob_tpu.field import limb as jl  # noqa: E402
from pob_tpu.field import ref as jref  # noqa: E402
from pob_tpu.prover import curve as jc  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu_torch.dist.mesh import data_mesh  # noqa: E402
from pob_tpu_torch.dist.pipeline import Groth16Pipeline  # noqa: E402
from pob_tpu_torch.dist.prove_sharded import prove_sharded, shard_pk  # noqa: E402
from pob_tpu_torch.field import limb  # noqa: E402
from pob_tpu_torch.field.ref import FR_MOD  # noqa: E402
from pob_tpu_torch.prover import groth16  # noqa: E402

torch.set_num_threads(1)

# small witness values: the plain MSM folds only the bit positions they use
# (the h query's scalars take all of them in every proof)
REQS = [(3, 5), (123456, 789), (65537, 7), (42, 42)]
RS = [(1234 + i, 5678 + i) for i in range(len(REQS))]


def _witness_fn(x, y):
    w, _ = toy_witness(x, y)
    return limb.ints_to_limbs(w)


def _verify(vk, reqs, proofs):
    pubs = [toy_witness(x, y)[1] for x, y in reqs]
    for proof, pub in zip(proofs, pubs):
        assert groth16.verify(vk, proof, pub)
    assert not groth16.verify(vk, proofs[0], [pubs[0][0], (pubs[0][1] + 1) % FR_MOD])


def _pob_tpu_proofs(pk, reqs, rs):
    """pob_tpu's prove of each request at its (r, s), with the MSM sums as
    field/ref.py sums of its affine query points."""
    W = np.stack([jl.ints_to_limbs(toy_witness(x, y)[0]) for x, y in reqs])
    h = np.asarray(jg._h_batch_kernel(pk.k, pk.mats, jnp.asarray(W)))
    npub = pk.num_public

    def msm_sum(group, query, scalars):
        name, add, mul, to_dev = {
            "g1": ("fq", jref.g1_add, jref.g1_mul, jc.g1_points_to_device),
            "g2": ("fq2", jref.g2_add, jref.g2_mul, jc.g2_points_to_device)}[group]
        query = tuple(np.asarray(c) for c in query)
        total = None
        for i, s in enumerate(scalars):
            p = jc.to_affine_host(name, tuple(c[i] for c in query))
            if p is not None:
                total = add(total, mul(p, jl.limbs_to_int(s)))
        return tuple(c[0] for c in to_dev([total]))

    proofs = []
    for b, (r, s) in enumerate(rs):
        sums = (msm_sum("g1", pk.a_query, W[b]), msm_sum("g1", pk.b1_query, W[b]),
                msm_sum("g2", pk.b2_query, W[b]),
                msm_sum("g1", pk.l_query, W[b, npub + 1:]), msm_sum("g1", pk.h_query, h[b]))
        proofs.append(jg.finish_proof(pk, sums, r, s))
    return proofs


def test_pipeline_streams_equal_prove_batch(tmp_path):
    """One test, so that the key and the references are made once:
    prove_batch of REQS at RS equals pob_tpu's proofs; the stream on 3
    devices (one MSM device) over the 4 requests and on 6 (an MSM group of 4
    shards: pipeline x MSM-shard) over the first 2 equal them, and so does
    prove_sharded on a mesh of one device."""
    jpk, jvk = jg.setup_host(toy_cs(), rng=iter(range(101, 200, 7)).__next__)
    path = str(tmp_path / "toy_pk.npz")
    jg.save_pk(path, jpk, jvk)
    pk, vk = groth16.load_pk(path, device="cpu")
    W = torch.stack([torch.from_numpy(_witness_fn(x, y)) for x, y in REQS])
    want = groth16.prove_batch(pk, W, rs=RS)
    assert want == _pob_tpu_proofs(jpk, REQS, RS)
    _verify(vk, REQS, want)  # so every proof equal to these verifies
    pipe = Groth16Pipeline(pk, _witness_fn, devices=["cpu"] * 3)
    assert pipe.prove_stream(REQS, RS) == want
    pipe = Groth16Pipeline(pk, _witness_fn, devices=["cpu"] * 6)
    assert pipe.prove_stream(REQS[:2], RS[:2]) == want[:2]
    assert prove_sharded(shard_pk(pk, data_mesh(1, device="cpu")), W[0], *RS[0]) == want[0]


def test_pipeline_needs_three_devices():
    with pytest.raises(ValueError):
        Groth16Pipeline(None, _witness_fn, devices=["cpu"] * 2)
