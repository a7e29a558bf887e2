"""The comparison that decides `correct` fails where it must: the harness
driven through a whole run (set-up, window, reference) on the CPU with a toy
circuit, the look for a card skipped, and the timed path broken underneath
by the test alone: the control (the reference's own proofs without the
blinding in the program's place), a step that returns its state unchanged,
half of the batch left out, a proof altered where it is produced, a public
input altered where the witness produces it, and a constraint system
changed under the same counts. A clean run passes."""

import pytest

from benchmark import run as R
from benchmark.tests.test_bench_harness import TOY, TOY_BENCH
from benchmark.tests.toy import toy
from pob_tpu_torch.prover import groth16

Q_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _run(**kw):
    return R.run("toy.b2", 2147483659, 0.5, False, bench=TOY_BENCH, traffic_dir=TOY,
                 require_card=False, device="cpu", log=lambda s: None, **kw)


def _stale(prove):
    last = []

    def f(pk, W, rs=None, timings=None):  # a step that returns its state unchanged
        if not last:
            last.append(prove(pk, W, rs=rs, timings=timings))
        return last[0]
    return f


def _half(prove):
    def f(pk, W, rs=None, timings=None):  # half of the batch left out
        h = max(1, int(W.shape[0]) // 2)
        return (prove(pk, W[:h], rs=rs[:h], timings=timings) * 2)[:int(W.shape[0])]
    return f


def _altered(prove):
    def f(pk, W, rs=None, timings=None):  # an answer altered where it is produced
        out = prove(pk, W, rs=rs, timings=timings)
        a, b2, c = out[-1]
        out[-1] = (a, b2, (c[0], (Q_MOD - c[1]) % Q_MOD))  # C negated: still on the curve
        return out
    return f


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale", "half", "altered"])
def test_broken_runs_are_not_correct(monkeypatch, fault):
    monkeypatch.setattr(groth16, "prove_batch", fault(groth16.prove_batch))
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["proofs_wrong"]["value"] > 0


def test_control_is_not_correct():
    out = _run(control=True)
    assert out["correct"] is False
    assert out["checks"]["proofs_wrong"]["value"] > 0


def test_altered_public_input_is_not_correct(monkeypatch):
    witness = toy.Circuit.witness

    def altered(self, items, device):  # a public input altered where the witness produces it
        W = witness(self, items, device)
        W[:, 1, 0] ^= 1
        return W

    monkeypatch.setattr(toy.Circuit, "witness", altered)
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["public_wrong"]["value"] > 0


def test_changed_constraint_system_is_not_correct(monkeypatch):
    # the last constraint's coefficient of x changed on both of its sides:
    # the same counts, the same witnesses satisfy it, and the program and the
    # reference follow it alike, so only the digest sees it
    build = toy.build
    monkeypatch.setattr(toy, "build", lambda: build(5))
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["r1cs_changed"]["value"] == 1
    assert out["checks"]["proofs_wrong"]["value"] == 0


def test_clean_run_is_correct():
    out = _run()
    assert out["correct"] is True
    assert out["checks"]["proofs_wrong"]["value"] == 0
    assert out["checks"]["r1cs_changed"]["value"] == 0
