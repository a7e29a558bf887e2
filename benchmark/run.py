#!/usr/bin/env python3
"""The benchmark of pob_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, kind of step,
work count or per-layer metric is a file of its own, found by name: the
configuration's file (BENCHMARK.json) with its circuit module, seeded input
generator and plain reference of the public input beside it
(configs/<name>.py, <name>_inputs.py, <name>_ref.py); the traffic file
(traffic/<name>.json), whose "loop" names the kind of step (loops/<loop>.py:
the witness made or supplied, closed loop); every count of work/ with a
work(ctx); one reader per per-layer metric (metrics/<metric>.py).

Set-up (counted in setup_s, from the start of this process): the circuit's
constraint system, the cell's inputs drawn from the seed, groth16.setup on
the card with toxic waste drawn from the seed, and the loop's own set-up and
warm-up steps of the window's shapes. Then the loop runs for --seconds; the
window ends with the step that ends after --seconds, and proofs_per_s is all
the proofs it completed over all its time. A seeded uniform sample of its
steps is kept, and after the window, with the program's key freed, the plain
reference judges their proofs (harness/check.py). --trace 1 reports the
per-layer metrics instead, from the loop's spans and prove_batch's own
timings per step, the work counts and torch.profiler over the window's
first steps.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, breakdown with --trace 1, then checks: each number
compared with its limit, also printed as the last lines of standard error).
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. --control 1 puts the check's control in the
program's place (benchmark/tests, PERF.md); the benchmark's runs never set
it."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "pob_tpu")
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class NoCard(RuntimeError):
    pass


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, traffic_dir: str = None) -> dict:
    """The cell's entry, its configuration (file and modules, found by the
    configuration file's name), its traffic mix (traffic/<name>.json) and the
    module of its kind of step (loops/<loop>.py)."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    stem = os.path.splitext(conf["file"])[0]
    traffic_dir = traffic_dir or os.path.join(HERE, "traffic")
    with open(os.path.join(traffic_dir, cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    dotted = stem.replace("/", ".")
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "circuit": dotted,
            "inputs": dotted + "_inputs", "ref": dotted + "_ref",
            "loop": "benchmark.loops." + traffic["loop"]}


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, rec: dict):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def work_counts(ctx: dict) -> dict:
    """{name: count} of every module of work/ that has a work(ctx)."""
    out = {}
    for f in sorted(os.listdir(os.path.join(HERE, "work"))):
        name = f[:-3]
        if f.endswith(".py") and not f.startswith("_"):
            mod = importlib.import_module("benchmark.work." + name)
            if hasattr(mod, "work"):
                out[name] = mod.work(ctx)
    return out


def device_line(torch, chips: int) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        lim, sm, smax = (v.strip() for v in q.stdout.strip().splitlines()[0].split(","))
        out.update(power_limit_w=float(lim), sm_clock_mhz=float(sm), sm_clock_max_mhz=float(smax))
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, bench: dict = None,
        traffic_dir: str = None, require_card: bool = True, device=None, control: bool = False,
        log=print) -> dict:
    """One run of a cell; returns the result object (without printing it).
    bench, traffic_dir, require_card and device stand in for BENCHMARK.json,
    benchmark/traffic, the look for a card and the card in the CPU tests."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_build", "triton")
    import torch

    bench = bench or load_bench()
    res = resolve(bench, workload, traffic_dir=traffic_dir)
    cell, cfg, traffic = res["cell"], res["cfg"], res["traffic"]
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        raise NoCard(f"{workload} needs {cell['chips']} CUDA card(s); this machine has "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device(device or "cuda:0")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    from pob_tpu_torch.prover import groth16

    from benchmark.harness import check, host, r1cs
    from benchmark.reference.groth16 import Shadow, domain_log2

    rng = {k: random.Random(f"{seed}:{k}") for k in ("inputs", "fresh", "toxic", "blind",
                                                        "sample")}
    with open(os.path.join(HERE, "peaks.json")) as f:
        rec = {"setup": {}, "peaks": json.load(f), "steps": []}
    ctx = SimpleNamespace(
        torch=torch, device=device, cuda=cuda, sync=sync, trace=trace, traffic=traffic,
        cfg=cfg, rng=rng, rec=rec, spans=[], groth16=groth16,
        gen=importlib.import_module(res["inputs"]),
        blinding=lambda n: [(rng["blind"].randrange(R_MOD), rng["blind"].randrange(R_MOD))
                            for _ in range(n)])
    loop = importlib.import_module(res["loop"])

    t0 = time.perf_counter()
    ctx.circuit = importlib.import_module(res["circuit"]).Circuit(cfg)
    rec["setup"]["build_cs_s"] = time.perf_counter() - t0
    cs = ctx.circuit.cs
    got = (cs.num_constraints, cs.num_wires, cs.num_public)
    want = (cfg["num_constraints"], cfg["num_wires"], cfg["num_public"])
    if got != want:
        raise RuntimeError(f"the program's constraint system has (constraints, wires, publics)"
                           f" {got}; the configuration states {want}")
    ctx.pool = ctx.gen.pool(cfg, rng["inputs"], traffic["pool"])
    toxic = [rng["toxic"].randrange(1, R_MOD) for _ in range(5)]
    st = {}
    ctx.pk, _ = groth16.setup(cs, rng=iter(toxic).__next__, device=device, timings=st)
    rec["setup"].update(st)
    loop.prepare(ctx)
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    with host.frozen_gc():
        setup_s = time.perf_counter() - T_START
        win = loop.window(ctx, seconds)
    sync()
    rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(setup_peak, rec["window_peak_bytes"])
    rec["trace"] = win.get("trace")
    probe = host.probe_s()

    # the reference, once the program's key is freed
    ctx.pk = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    arrs = r1cs.arrays(cs)
    kept = ctx.keeper.kept
    shadow = Shadow(arrs, toxic, device)
    numbers = check.judge(kept, shadow, importlib.import_module(res["ref"]).public_inputs,
                          cs.num_public, device, control=control)
    del shadow
    numbers["r1cs_changed"] = int(r1cs.sha256(arrs) != cfg["r1cs_sha256"])
    correct = check.passed(numbers)

    if trace:
        rec["work"] = work_counts({"domain_log2": domain_log2(cs.num_constraints, cs.num_public),
                                   "r1cs": arrs, "witnesses": [W for _, _, W, _ in kept]})
    done = win["done"]
    metrics = {}
    for m in metric_names(bench, workload, trace):
        if not trace:
            v = {"proofs_per_s": done / win["window_s"], "setup_s": setup_s}.get(m["name"])
        else:
            v = read_metric(m["name"], rec)
        if v is None:
            continue
        entry = dict(v) if isinstance(v, dict) else {"value": v}
        metrics[m["name"]] = {"value": entry.pop("value"), "unit": m["unit"], **entry}
    dev = device_line(torch, cell["chips"]) if cuda else {"platform": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(peak)
    dev["host_probe_s"] = probe
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["attempted"] - done + numbers["proofs_wrong"], "metrics": metrics,
           "device": dev}
    tr = rec["trace"]
    if trace and tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = check.lines(numbers)
    log(f"{workload} seed {seed}: {done} proofs in {win['window_s']:.3f} s, setup "
        f"{setup_s:.3f} s, setup parts {json.dumps(rec['setup'])}, host probe {probe:.4f} s; "
        f"the window's steps ended at {[round(t, 3) for t in win.get('ends', [])]} s")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace), control=bool(a.control),
                  log=lambda s: print(s, file=sys.stderr))
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"no result: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        word = "at most" if c["kind"] == "max" else "at least"
        print(f"check {name}: {c['value']} (limit: {word} {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
