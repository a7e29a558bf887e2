"""The work-count functions of the stage rooflines against hand counts at
toy sizes, and their inputs: the stage's inputs only, never a kernel's
parameters."""

import inspect
import re

import numpy as np

from benchmark.work import h_stage, msm_stage, prices

KERNEL_WORDS = ("window", "windows", "plan", "chunk", "shift", "levels", "sweep")


def test_prices():
    assert prices.FIELD_MUL == 2 * (8 * 8 + 8 * 8) + 8
    assert prices.G1_ADD == 6 * 264 and prices.G2_ADD == 17 * 264


def test_h_stage_at_domain_16():
    # n = 16: the mat-vecs' 10 + 7 products, 2 * 16 pointwise, six transforms
    # of (16 / 2) * 4 = 32 butterflies, three coset scalings of 16
    w = h_stage.count(4, nnz_a=10, nnz_b=7, num_wires=5)
    assert w["int32_muls"] == (17 + 32 + 6 * 32 + 48) * 264
    assert w["bytes"] == 17 * 40 + 5 * 32 + 16 * 32


def test_dense_additions_of_16_points():
    # m = 16: c = 3 gives 85 windows of 16 * 7/8 + 8 digits and buckets, plus
    # 84 joins; the least over c is that of a brute force over the formula
    def adds(c):
        return -(-255 // c) * (16 * (1 - 2.0 ** -c) + 2 ** c) + (-(-255 // c)) - 1

    assert msm_stage.dense_additions(16) == round(min(adds(c) for c in range(1, 32)))
    assert msm_stage.dense_additions(0) == 0


def test_msm_stage_counts_known_scalars():
    # 16 points with scalars 0 and 1 only: one addition per scalar 1
    ones, full = 5, 0
    w = msm_stage.count(0, {"a_query": ("g1", ones, full), "b2_query": ("g2", 3, 0)})
    h = msm_stage.dense_additions(1)
    assert w["int32_muls"] == prices.G1_ADD * (h + 5) + prices.G2_ADD * 3
    assert w["bytes"] == 1 * 96 + 5 * 96 + 3 * 160


def test_counts_take_only_stage_inputs():
    for fn in (h_stage.count, msm_stage.count, msm_stage.dense_additions):
        for p in inspect.signature(fn).parameters:
            assert not any(word in p for word in KERNEL_WORDS), (fn.__name__, p)
    # work(ctx) reads only the stage's inputs from its context
    for mod in (h_stage, msm_stage):
        src = inspect.getsource(mod)
        assert set(re.findall(r'ctx\["(\w+)"\]', src)) <= {"domain_log2", "r1cs", "witnesses"}


def test_query_scalars_count_ones_and_dense_over_finite_points():
    # wires 0 (one), 1 (public), 2-4 private; A has wires 2, 3; B wire 2; C wire 4
    r1cs = {"num_wires": 5, "num_public": 1,
            "a": ([0, 1], [2, 3], [0, 0]), "b": ([0], [2], [0]), "c": ([1], [4], [0])}
    w = np.zeros((2, 5, 16), np.int32)
    w[:, 0, 0] = 1
    w[0, 2, 0], w[0, 3, 0], w[0, 4, 5] = 1, 7, 1
    w[1, 2, 0], w[1, 4, 0] = 1, 1
    q = msm_stage.query_scalars(r1cs, [w])
    # a: wires 0, 1 (binding), 2, 3; per proof ones (2 + 2) / 2, dense (1 + 0) / 2
    assert q["a_query"] == ("g1", 2, 0)
    assert q["b2_query"] == ("g2", 1, 0)
    assert q["l_query"] == ("g1", 1, 1)  # wires 2, 3, 4: ones (1+2) // 2, dense (2+0) // 2
