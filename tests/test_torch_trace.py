"""The port's spans and launch counts on the CPU (no jax): MetricsRegistry's
spans (nesting, parents per thread, the bounded deque, enabled), the
timings prove_batch exports with them on a toy key, the witness's spans on
Spend, and the spans' clock, which must be torch.profiler's."""

import random
import threading
from pathlib import Path

import pytest
import torch

from pob_tpu_torch import _build
from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FR_MOD
from pob_tpu_torch.harness.inputs import load_spend_input
from pob_tpu_torch.prover import groth16
from pob_tpu_torch.r1cs.builder import ConstraintSystem
from pob_tpu_torch.r1cs.spend_circuit import assemble_witness, build_spend_cs, spend_witness
from pob_tpu_torch.utils import metrics
from pob_tpu_torch.utils.metrics import METRICS, MetricsRegistry

torch.set_num_threads(1)

SPEND_INPUT = Path(__file__).parent / "fixtures" / "spend_input.json"
SPEND_ARGS = ("burn_key", "balance", "withdrawn", "extra_commitment")


def test_spans_nest_with_parents_attrs_and_launches(monkeypatch):
    reg = MetricsRegistry()
    monkeypatch.setitem(_build.LAUNCHES, "mont", _build.LAUNCHES["mont"])
    with reg.span("outer", batch=3) as attrs:
        with reg.span("inner"):
            _build.LAUNCHES["mont"] += 2
        with reg.stage("inner") as holder:
            holder["out"] = torch.ones(2)
        attrs["extra"] = 1
    inner, inner2, outer = reg.spans()  # in the order they ended
    assert (outer.name, outer.parent_id) == ("outer", None)
    assert inner.parent_id == inner2.parent_id == outer.id
    assert len({outer.id, inner.id, inner2.id}) == 3
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns
    assert inner.attrs == {"launches": {"mont": 2}} and inner2.attrs == {"launches": {}}
    assert outer.attrs == {"batch": 3, "extra": 1, "launches": {"mont": 2}}
    rep = reg.report()["stages"]
    assert rep["inner"]["count"] == 2 and rep["outer"]["count"] == 1
    assert reg.recorded == 3


def test_parents_are_per_thread():
    reg = MetricsRegistry()
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with reg.span(f"root.{tag}"):
            both_open.wait()
            with reg.span(f"child.{tag}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in reg.spans()}
    assert len(by_name) == 4
    for tag in "ab":
        assert by_name[f"child.{tag}"].parent_id == by_name[f"root.{tag}"].id
        assert by_name[f"root.{tag}"].parent_id is None


def test_spans_are_bounded(monkeypatch):
    assert METRICS._spans.maxlen == metrics.MAX_SPANS == 65536
    monkeypatch.setattr(metrics, "MAX_SPANS", 4)
    reg = MetricsRegistry()
    for i in range(10):
        with reg.span(f"s{i}"):
            pass
    assert [s.name for s in reg.spans()] == ["s6", "s7", "s8", "s9"]
    assert reg.recorded == 10 and len(reg.stages) == 10


def test_disabled_records_nothing():
    reg = MetricsRegistry()
    reg.enabled = False
    with reg.span("a", batch=1) as attrs:
        with reg.stage("b") as holder:
            holder["out"] = torch.zeros(1)
    assert attrs == {"batch": 1}
    assert reg.spans() == [] and reg.stages == {} and reg.recorded == 0
    assert reg.report()["stages"] == {}


def _toy_cs():
    """x, y private; publics z1 = x y, z2 = (x + y) x."""
    cs = ConstraintSystem()
    z1, z2 = (int(w) for w in cs.alloc_block("pub", (2,)))
    cs.mark_public(2)
    x, y = (int(w) for w in cs.alloc_block("priv", (2,)))
    cs.add([(x, 1)], [(y, 1)], [(z1, 1)])
    cs.add([(x, 1), (y, 1)], [(x, 1)], [(z2, 1)])
    return cs


def _toy_witness(x, y):
    return [1, x * y % FR_MOD, (x + y) * x % FR_MOD, x, y]


@pytest.fixture(scope="module")
def toy_key():
    """The toy circuit's key on the plain path (no plan: K3 proves every
    MSM), set up on the CPU."""
    rng = random.Random(5)
    return groth16.setup(_toy_cs(), rng=lambda: rng.randrange(1, FR_MOD), plan=False,
                         device="cpu")


def test_prove_batch_exports_the_parts_of_its_stages(toy_key):
    pk, vk = toy_key
    ws = [_toy_witness(3 + i, 11 + i) for i in range(2)]
    W = torch.from_numpy(limb.ints_to_limbs([v for w in ws for v in w]).reshape(2, 5, 16))
    tm = {}
    n0 = METRICS.recorded
    proofs = groth16.prove_batch(pk, W, rs=[(7, 9), (8, 10)], timings=tm)
    assert groth16.verify(vk, proofs[1], ws[1][1:3])
    assert set(tm) == {"h_s", "msm_s", "chunk", "h_matvec_s", "h_ntt_s", "msm_k3_s",
                       "msm_k5_s", "finish_s", "launches"}
    assert tm["chunk"] == 2 and tm["launches"] == {}  # the plain kernels launch nothing
    assert 0 < tm["h_matvec_s"] and 0 < tm["h_ntt_s"] and 0 < tm["msm_k3_s"]
    assert tm["msm_k5_s"] == 0.0  # no plan: every MSM is K3
    assert tm["h_matvec_s"] + tm["h_ntt_s"] <= tm["h_s"] * 1.05
    assert tm["msm_k3_s"] + tm["msm_k5_s"] <= tm["msm_s"] * 1.05
    assert tm["finish_s"] > 0
    new = METRICS.spans()[-(METRICS.recorded - n0):]
    root = new[-1]
    assert (root.name, root.parent_id) == ("prove_batch", None)
    assert root.attrs["batch"] == 2 and root.attrs["chunk"] == 2
    chunk = [s for s in new if s.name == "prove.chunk"]
    assert len(chunk) == 1 and chunk[0].parent_id == root.id
    kids = sorted(s.name for s in new if s.parent_id == chunk[0].id)
    assert kids == ["h.matvec", "h.ntt", "host_tail.finish_proof", "host_tail.finish_proof",
                    "msm.k3", "msm.k3", "msm.k3", "msm.k3", "msm.k3"]


@pytest.fixture(scope="module")
def spend_blocks():
    """Spend's witness at batch 2, with the spans it recorded."""
    cs = build_spend_cs()
    n0 = METRICS.recorded
    inps = [load_spend_input(str(SPEND_INPUT)) for _ in range(2)]
    args = [limb.to_device(limb.ints_to_limbs([inp[k] for inp in inps]), "cpu")
            for k in SPEND_ARGS]
    blocks = spend_witness(*args)
    W = assemble_witness(cs, blocks)
    return cs, blocks, W, METRICS.spans()[-(METRICS.recorded - n0):]


def test_spend_witness_spans(spend_blocks):
    cs, _, W, spans = spend_blocks
    assert W.shape == (2, cs.num_wires, 16)
    names = [s.name for s in spans]
    assert names == ["witness.load", "witness.load", "witness.poseidon", "witness.poseidon",
                     "witness.keccak", "witness.trace", "witness.assemble"]
    trace = spans[5]
    assert all(s.parent_id == trace.id for s in spans[2:5])
    assert all(s.parent_id is None for s in spans[:2] + spans[5:])


def test_spans_are_on_the_profilers_clock(spend_blocks):
    cs, blocks, _, _ = spend_blocks
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    assemble_witness(cs, blocks)
    prof.stop()
    span = METRICS.spans()[-1]
    assert span.name == "witness.assemble"
    ops = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    assert len(ops) > 10
    slack = 1_000_000  # ns
    assert min(e.start_ns() for e in ops) >= span.start_ns - slack
    assert max(e.end_ns() for e in ops) <= span.end_ns + slack
