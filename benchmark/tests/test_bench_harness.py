"""The harness on the CPU: BENCHMARK.json keeps to its format's names and
units, every cell finds its files by name, the metric arithmetic is right on
synthetic records, a run without a card prints no result, and a run's last
line has exactly the keys of the result format (a toy circuit proved by the
program on the CPU). The runs on the card are marked and skip here."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import run as R
from benchmark.harness import trace

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOY = os.path.join(R.HERE, "tests", "toy")
TOY_BENCH = {
    "configs": [{"name": "toy", "file": "benchmark/tests/toy/toy.json"}],
    "workloads": [{"name": "toy.b2", "config": "toy", "traffic": "toy_b2", "chips": 1}],
    "end_to_end": [{"name": "proofs_per_s", "unit": "proofs/s"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}


@pytest.fixture(scope="module")
def bench():
    return R.load_bench()


def test_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in bench["workloads"]] + [
            w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    moves = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"] and len(m["layer"]) <= 200
    for text in [c["source"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_resolves_its_files(bench):
    for w in bench["workloads"]:
        res = R.resolve(bench, w["name"])
        assert res["cfg"]["num_wires"] > 0 and res["traffic"]["batch"] >= 1
        for mod in (res["circuit"], res["inputs"], res["ref"], res["loop"]):
            assert os.path.exists(os.path.join(ROOT, *mod.split(".")) + ".py"), mod
        for m in R.metric_names(bench, w["name"], True):
            assert os.path.exists(os.path.join(R.HERE, "metrics", m["name"] + ".py"))
        assert {m["name"] for m in R.metric_names(bench, w["name"], False)} >= {"setup_s"}


def _rec(steps):
    peaks = {"int32_mul_per_s": 1e12, "hbm_bytes_per_s": 1e12}
    return {"steps": steps, "peaks": peaks, "setup": {"build_cs_s": 2.0, "scalars_s": 1.0,
            "k4_s": 0.5, "bases_s": 0.25, "plan_s": 0.25},
            "work": {"h_stage": {"int32_muls": 1e10, "bytes": 1e9},
                     "msm_stage": {"int32_muls": 1e9, "bytes": 2e9}}}


def test_metric_arithmetic_on_synthetic_records():
    steps = [{"witness_s": 1.0, "prove_s": 1.0, "step_s": 2.0, "h_s": 0.5, "msm_s": 0.25,
              "proofs": 2},
             {"witness_s": 3.0, "prove_s": 1.0, "step_s": 4.0, "h_s": 0.5, "msm_s": 0.25,
              "proofs": 2}]
    rec = _rec(steps)
    assert R.read_metric("witness.ms_per_proof", rec) == 1000.0  # 4 s over 4 proofs
    assert R.read_metric("host_tail.ms_per_proof", rec) == 125.0  # (2 - 1 - 0.5) / 4
    h = R.read_metric("h_stage_roofline", rec)
    assert h == {"value": 100 * 0.01 * 4 / 1.0, "bound_by": "operations"}
    m = R.read_metric("msm_stage_roofline", rec)
    assert m == {"value": 100 * 0.002 * 4 / 0.5, "bound_by": "bytes"}
    assert R.read_metric("step_mfu", rec) == pytest.approx(100 * 4 * 0.012 / 6.0)
    assert R.read_metric("setup.key_s", rec) == 2.0
    assert R.read_metric("device.idle_share", rec) is None  # no trace: nothing to read
    assert R.read_metric("witness.ms_per_proof", _rec([])) is None
    supplied = [{k: v for k, v in st.items() if k != "witness_s"} for st in steps]
    assert R.read_metric("witness.ms_per_proof", _rec(supplied)) is None


def test_rate_is_all_proofs_over_the_whole_window_and_a_stall_lowers_it():
    # the window's rate as run() takes it: proofs done over the window's time
    def rate(step_times, per_step=16):
        return per_step * len(step_times) / sum(step_times)

    even = rate([0.8] * 10)
    stalled = rate([0.8] * 9 + [4.0])
    assert even == pytest.approx(20.0) and stalled < even


def test_idle_share_from_device_intervals():
    class Ev:
        def __init__(self, name, s, e, dev):
            self._n, self._s, self._e, self._d = name, s, e, dev

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def end_ns(self):
            return self._e

        def device_type(self):
            return "DeviceType." + self._d

        def is_user_annotation(self):
            return self._n in trace.SPANS

    evs = [Ev("witness", 0, 100, "CPU"), Ev("prove_batch", 100, 200, "CPU"),
           Ev("aten::add", 10, 40, "CPU"), Ev("k1", 10, 30, "CUDA"), Ev("k1", 20, 50, "CUDA"),
           Ev("k2", 150, 160, "CUDA")]
    spans = [(0, 100, "witness"), (100, 200, "prove_batch")]
    s = trace.summarize(evs, spans)
    assert s["busy_s"] == 50e-9 and s["window_s"] == 200e-9
    assert R.read_metric("device.idle_share", {"trace": s}) == 75.0
    assert s["device_ops"][0] == ["k1", 50e-9]
    assert s["idle_gaps"][0] == ["prove_batch", 100e-9]
    assert s["idle_gaps"][2] == ["witness", 10e-9]  # aten::add starts after the gap
    assert trace.summarize([e for e in evs if e.device_type() != "DeviceType.CUDA"],
                           spans) is None


def test_no_card_no_result():
    p = subprocess.run([sys.executable, os.path.join(R.HERE, "run.py"), "--workload",
                        "spend.b16", "--seed", "2147483653", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2 and p.stdout == "" and "no result" in p.stderr


def test_last_line_has_the_result_keys():
    out = R.run("toy.b2", 4294967311, 0.5, False, bench=TOY_BENCH, traffic_dir=TOY,
                require_card=False, device="cpu", log=lambda s: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"proofs_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert {"platform", "count", "memory_peak_bytes"} <= set(out["device"])
    assert list(out["checks"]) == ["proofs_wrong", "public_wrong", "proofs_checked",
                                   "r1cs_changed"]
    assert out["device"]["host_probe_s"] > 0


@pytest.mark.parametrize("trace_on", [False, True])
def test_supplied_witness_loop_runs_from_its_traffic_file(trace_on):
    # a cell whose step takes witnesses made in set-up: files only, no edit
    # of run.py; every record keeps prove_batch's whole timings
    bench = dict(TOY_BENCH, workloads=TOY_BENCH["workloads"] + [
        {"name": "toy.supplied", "config": "toy", "traffic": "toy_supplied", "chips": 1}],
        per_layer=[{"name": n, "unit": u} for n, u in (
            ("witness.ms_per_proof", "ms"), ("h_stage.ms_per_proof", "ms"),
            ("host_tail.ms_per_proof", "ms"), ("h_stage_roofline", "%"), ("step_mfu", "%"))])
    seen = []
    out = R.run("toy.supplied", 8589934609, 0.5, trace_on, bench=bench, traffic_dir=TOY,
                require_card=False, device="cpu", log=seen.append)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    if trace_on:  # no witness span in this loop: its metric is left out
        assert set(out["metrics"]) == {"h_stage.ms_per_proof", "host_tail.ms_per_proof",
                                       "h_stage_roofline", "step_mfu"}
        assert 0 < out["metrics"]["h_stage_roofline"]["value"] <= 100


def test_work_counts_are_found_by_name():
    from benchmark.harness import r1cs
    from benchmark.tests.toy import toy

    cs = toy.build()
    W = torch.zeros(2, cs.num_wires, 16, dtype=torch.int32)
    W[:, 0, 0] = 1
    got = R.work_counts({"domain_log2": 3, "r1cs": r1cs.arrays(cs), "witnesses": [W]})
    assert set(got) == {"h_stage", "msm_stage"}
    assert all(v["int32_muls"] > 0 and v["bytes"] > 0 for v in got.values())


@pytest.mark.chip
@pytest.mark.parametrize("trace_on", [0, 1])
def test_cells_on_the_card(card, bench, trace_on):
    for w in bench["workloads"]:
        p = subprocess.run([sys.executable, os.path.join(R.HERE, "run.py"), "--workload",
                            w["name"], "--seed", "4294967291", "--seconds", "3", "--trace",
                            str(trace_on)], capture_output=True, text=True, timeout=1500,
                           cwd=ROOT)
        assert p.returncode == 0, p.stderr[-3000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] and out["device"]["platform"] == "gpu"
