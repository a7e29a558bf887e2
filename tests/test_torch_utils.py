"""The port's metrics and the bytesops helpers it gained
with the multi-device slice, held against pob_tpu's on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pob_tpu.gadgets import bytesops as jb
from pob_tpu.utils import metrics as jm
from pob_tpu_torch.gadgets import bytesops as tb
from pob_tpu_torch.utils import metrics as tm

torch.set_num_threads(1)


def _drive(mod, out):
    """One sequence of stage and count calls on a fresh registry."""
    reg = mod.MetricsRegistry()
    for name in ("witness", "h", "witness", "msm"):
        with reg.stage(name) as holder:
            holder["out"] = out
    with reg.stage("host"):
        pass
    reg.count("proofs", 16)
    reg.count("proofs")
    reg.count("witnesses", 3)
    return reg


def _shape(report: dict):
    """Everything of a report but its clock readings."""
    return ({k: sorted(v) for k, v in report["stages"].items()},
            {k: v["count"] for k, v in report["stages"].items()},
            report["counters"], sorted(report), sorted(report["rates_per_s"]))


def test_metrics_report_equals_pob_tpu():
    want = _drive(jm, (jnp.ones(3), {"x": jnp.zeros(2)}))
    got = _drive(tm, (torch.ones(3), {"x": torch.zeros(2)}))
    assert _shape(got.report()) == _shape(want.report())
    assert sorted(got.stages) == sorted(want.stages)
    for name, st in got.stages.items():
        assert st.count == want.stages[name].count
        assert 0 <= st.min_s <= st.mean_s <= st.max_s <= st.total_s
    assert got.rate("proofs") > 0 and got.rate("absent") == 0.0
    assert isinstance(got.dump(), str) and isinstance(tm.METRICS, tm.MetricsRegistry)


def test_stage_stat_equals_pob_tpu():
    a, b = jm.StageStat(), tm.StageStat()
    for dt in (0.5, 0.25, 2.0):
        a.add(dt)
        b.add(dt)
    assert (a.count, a.total_s, a.min_s, a.max_s, a.mean_s) == (
        b.count, b.total_s, b.min_s, b.max_s, b.mean_s)
    assert tm.StageStat().mean_s == jm.StageStat().mean_s == 0.0


def test_bytesops_helpers_equal_pob_tpu():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, size=(3, 7))
    np.testing.assert_array_equal(tb.reverse(torch.from_numpy(a)).numpy(),
                                  np.asarray(jb.reverse(jnp.asarray(a))))
    for n in (1, 8, 31, 32):
        b = rng.integers(0, 256, size=(4, n)).astype(np.int32)
        np.testing.assert_array_equal(tb.be_bytes_to_limbs_any(torch.from_numpy(b)).numpy(),
                                      np.asarray(jb.be_bytes_to_limbs_any(jnp.asarray(b)),
                                                 np.int64))
    with pytest.raises(ValueError):
        tb.be_bytes_to_limbs_any(torch.zeros(33, dtype=torch.int32))
    x = np.array([0, 1, 65535, 65536, 2**31 - 1, 123456789], np.int32)
    np.testing.assert_array_equal(tb.limb_from_i32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jb.limb_from_i32(jnp.asarray(x)), np.int64))
    v = np.array([0, 1, 6, 7, 255, 256, 1000, 2**31 - 1, -1, -8], np.int32)
    for d in (1, 7, 256):
        got = tb.divide(torch.from_numpy(v), d)
        want = jb.divide(jnp.asarray(v), d)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
