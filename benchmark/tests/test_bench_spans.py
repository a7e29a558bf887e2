"""The per-layer metrics read from the program's own spans and from
prove_batch's parts: their arithmetic on synthetic records and spans, that
they are left out where the program keeps nothing to read, and that a traced
run of the toy cell on the CPU reports those of prove_batch."""

import json
import os

import pytest

from benchmark import run as R
from benchmark.tests.test_bench_harness import TOY, TOY_BENCH
from pob_tpu_torch.utils import metrics

MS = 1_000_000  # ns
PROVE_METRICS = ("h_stage.matvec_ms_per_proof", "h_stage.ntt_ms_per_proof",
                 "msm_stage.k3_ms_per_proof", "msm_stage.k5_ms_per_proof",
                 "host_tail.finish_proof_ms_per_proof", "prove.launches_per_proof")
WITNESS_METRICS = ("witness.load_ms_per_proof", "witness.keccak_ms_per_proof",
                   "witness.poseidon_ms_per_proof", "witness.assemble_ms_per_proof",
                   "witness.device_wait_ms_per_proof", "witness.launches_per_proof")


def _span(sid, parent, name, start_ms, end_ms, **launches):
    return metrics.Span(sid, parent, name, start_ms * MS, end_ms * MS, {"launches": launches})


# a warm-up prove_batch, then two steps of two proofs each: the witness's
# load (twice in step 1), trace (keccak and poseidon inside) and assemble,
# then prove_batch
SPANS = [
    _span(1, None, "prove_batch", 0, 100, msm=9),
    _span(2, None, "witness.load", 200, 210),
    _span(3, None, "witness.load", 212, 216),
    _span(5, 4, "witness.keccak", 230, 260, mont=5),
    _span(6, 4, "witness.poseidon", 270, 290, mont=1),
    _span(4, None, "witness.trace", 220, 320, mont=6),
    _span(7, None, "witness.assemble", 330, 340, mont=2),
    _span(8, None, "prove_batch", 400, 500, msm=9),
    _span(9, None, "witness.load", 1200, 1206),
    _span(11, 10, "witness.keccak", 1210, 1230),
    _span(12, 10, "witness.poseidon", 1230, 1240),
    _span(13, 10, "witness.poseidon", 1240, 1250),
    _span(10, None, "witness.trace", 1206, 1286, mont=4, ntt=1),
    _span(14, None, "witness.assemble", 1286, 1300),
    _span(15, None, "prove_batch", 1400, 1500, msm=9),
]
STEPS = [{"witness_s": 0.150, "proofs": 2, "h_s": 0.5, "h_matvec_s": 0.25, "h_ntt_s": 0.125,
          "msm_s": 0.25, "msm_k3_s": 0.125, "msm_k5_s": 0.0625, "finish_s": 1.0,
          "launches": {"mont": 10, "msm": 8}},
         {"witness_s": 0.120, "proofs": 2, "h_s": 0.5, "h_matvec_s": 0.25, "h_ntt_s": 0.125,
          "msm_s": 0.25, "msm_k3_s": 0.125, "msm_k5_s": 0.0625, "finish_s": 1.0,
          "launches": {"mont": 10, "msm": 9}}]


def _registry(spans, recorded=None):
    reg = metrics.MetricsRegistry()
    reg._spans.extend(spans)
    reg.recorded = len(spans) if recorded is None else recorded
    return reg


@pytest.mark.parametrize("name, want", [
    ("witness.load_ms_per_proof", (10 + 4 + 6) / 4),
    ("witness.keccak_ms_per_proof", (30 + 20) / 4),
    ("witness.poseidon_ms_per_proof", (20 + 10 + 10) / 4),
    ("witness.assemble_ms_per_proof", (10 + 14) / 4),
    ("witness.device_wait_ms_per_proof", (150 + 120 - (10 + 4 + 100 + 10) - (6 + 80 + 14)) / 4),
    ("witness.launches_per_proof", (6 + 2 + 4 + 1) / 4),
])
def test_witness_readers_on_synthetic_spans(monkeypatch, name, want):
    monkeypatch.setattr(metrics, "METRICS", _registry(SPANS))
    assert R.read_metric(name, {"steps": STEPS}) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [
    ("h_stage.matvec_ms_per_proof", 1000 * 0.5 / 4),
    ("h_stage.ntt_ms_per_proof", 1000 * 0.25 / 4),
    ("msm_stage.k3_ms_per_proof", 1000 * 0.25 / 4),
    ("msm_stage.k5_ms_per_proof", 1000 * 0.125 / 4),
    ("host_tail.finish_proof_ms_per_proof", 1000 * 2.0 / 4),
    ("prove.launches_per_proof", (18 + 19) / 4),
])
def test_prove_readers_on_synthetic_timings(name, want):
    assert R.read_metric(name, {"steps": STEPS}) == pytest.approx(want)
    # a program whose prove_batch gives only h_s, msm_s and chunk
    old = [{k: st[k] for k in ("witness_s", "proofs", "h_s", "msm_s")} for st in STEPS]
    assert R.read_metric(name, {"steps": old}) is None


@pytest.mark.parametrize("case", ["no spans kept", "dropped", "fewer proves than steps",
                                  "a step without witness spans"])
def test_witness_readers_left_out_without_their_spans(monkeypatch, case):
    reg = {"no spans kept": object(),  # the registry of a program without spans
           "dropped": _registry(SPANS, recorded=len(SPANS) + 1),
           "fewer proves than steps": _registry(SPANS[1:8]),
           "a step without witness spans": _registry([s for s in SPANS if not (
               s.name.startswith("witness.") and s.start_ns > 1000 * MS)]),
           }[case]
    monkeypatch.setattr(metrics, "METRICS", reg)
    for name in WITNESS_METRICS:
        assert R.read_metric(name, {"steps": STEPS}) is None, name


def test_toy_cell_traced_reports_the_parts_of_prove_batch(tmp_path):
    # the toy cell's traffic with no step under the profiler, so that every
    # step of a short window is recorded
    with open(os.path.join(TOY, "toy_b2.json")) as f:
        traffic = dict(json.load(f), trace_steps=0)
    (tmp_path / "toy_b2.json").write_text(json.dumps(traffic))
    per_layer = [{"name": n, "unit": "ms"} for n in PROVE_METRICS + WITNESS_METRICS + (
        "h_stage.ms_per_proof", "msm_stage.ms_per_proof", "host_tail.ms_per_proof")]
    out = R.run("toy.b2", 12884901893, 0.5, True, bench=dict(TOY_BENCH, per_layer=per_layer),
                traffic_dir=str(tmp_path), require_card=False, device="cpu",
                log=lambda s: None)
    assert out["correct"] is True and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # the toy's witness is worked out on the host, outside the program: no
    # witness span, so no witness part
    assert set(got) == set(PROVE_METRICS) | {"h_stage.ms_per_proof", "msm_stage.ms_per_proof",
                                             "host_tail.ms_per_proof"}
    assert 0 < got["h_stage.matvec_ms_per_proof"] and 0 < got["h_stage.ntt_ms_per_proof"]
    assert 0 < got["msm_stage.k3_ms_per_proof"] and 0 < got["msm_stage.k5_ms_per_proof"]
    assert (got["h_stage.matvec_ms_per_proof"] + got["h_stage.ntt_ms_per_proof"]
            <= got["h_stage.ms_per_proof"] * 1.05)
    assert (got["msm_stage.k3_ms_per_proof"] + got["msm_stage.k5_ms_per_proof"]
            <= got["msm_stage.ms_per_proof"] * 1.05)
    assert 0 < got["host_tail.finish_proof_ms_per_proof"] <= got["host_tail.ms_per_proof"]
    assert got["prove.launches_per_proof"] == 0  # the CPU runs the kernels' plain versions
