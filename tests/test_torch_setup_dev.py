"""The setup's device route on the CPU (plain K1): the port's scans and
powers (limb.batch_inv_mont_scan, mont_powers_mont, mont_powers,
mont_pow_int), L_j(tau), the column sums u_i(tau) and the setup scalars
against pob_tpu's device functions and against the host ints, at k <= 4;
setup against setup_host; the rule for the K3 bases' shifted windows on
the sizes of Spend, TEST_CONFIG and PROD_CONFIG; the NTT tables made on a
device against the host tables. Tolerance 0."""

import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_groth16 import bit_cs, toy_cs  # noqa: E402

from pob_tpu.field import limb as jl  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.field.ref import FR_MOD  # noqa: E402
from pob_tpu_torch.prover import groth16 as tg  # noqa: E402
from pob_tpu_torch.prover import msm, ntt  # noqa: E402

torch.set_num_threads(1)

R = (1 << 256) % FR_MOD
CPU = torch.device("cpu")


def _mont(vals):
    return torch.from_numpy(tl.ints_to_limbs([v * R % FR_MOD for v in vals]))


def _ints(t) -> list:
    return tl.limb_rows_to_ints(np.asarray(t, np.int64))


def _canon(t) -> list:
    return _ints(tl.from_mont(tl.FR, torch.as_tensor(np.asarray(t, np.int64)).to(torch.int32)))


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def test_batch_inv_mont_scan_matches_jax_and_ints():
    """tests/test_serialize.py's values (zeros map to zero) followed by 31
    more (37 in all, not a power of two), zeros at both ends."""
    rng = random.Random(5)
    vals = ([1, 2, 3, 0, 12345678901234567890 % FR_MOD, FR_MOD - 1]
            + [rng.randrange(FR_MOD) for _ in range(30)] + [0])
    a = _mont(vals)
    got = tl.batch_inv_mont_scan(tl.FR, a)
    want = jax.jit(lambda x: jl.batch_inv_mont_scan(jl.FR, x))(_u32(a))
    assert _ints(got) == _ints(want)
    assert _canon(got) == [pow(v, FR_MOD - 2, FR_MOD) if v else 0 for v in vals]


def test_powers_and_pow_match_jax_and_ints():
    """mont_powers (tests/test_serialize.py's base 31337, n = 11) and
    mont_powers_mont at n = 37; mont_pow_int at e = 0 and r - 2 on 7, a
    wide value and 0."""
    got = tl.mont_powers(tl.FR, 31337, 11)
    assert _ints(got) == _ints(jax.jit(lambda: jl.mont_powers(jl.FR, 31337, 11))())
    assert _canon(got) == [pow(31337, j, FR_MOD) for j in range(11)]
    base = 0xDEADBEEF << 100
    bm = _mont([base])[0]
    for n in (37,):
        got = tl.mont_powers_mont(tl.FR, bm, n)
        assert _ints(got) == _ints(jax.jit(lambda b: jl.mont_powers_mont(jl.FR, b, n))(_u32(bm)))
        assert _canon(got) == [pow(base, j, FR_MOD) for j in range(n)]
    a = _mont([7, base, 0])
    for e in (0, FR_MOD - 2):
        got = tl.mont_pow_int(tl.FR, a, e)
        assert _ints(got) == _ints(jax.jit(lambda x: jl.mont_pow_int(jl.FR, x, e))(_u32(a)))
        assert _canon(got) == [pow(v, e, FR_MOD) for v in (7, base, 0)]


def test_lagrange_dev_matches_jax_and_host():
    """At k = 4 against pob_tpu's device and host functions; at k = 1, 2
    against the host ints."""
    tau = 0x1234567890ABCDEF1234567890ABCDEF % FR_MOD
    got = tg._lagrange_at_tau_mont_dev(4, tau, CPU)
    assert _ints(got) == _ints(jg._lagrange_at_tau_mont_dev(4, tau))
    assert _canon(got) == tg._lagrange_at_tau(4, tau) == jg._lagrange_at_tau(4, tau)
    for k in (1, 2):
        assert _canon(tg._lagrange_at_tau_mont_dev(k, tau, CPU)) == tg._lagrange_at_tau(k, tau)


def test_poly_evals_dev_matches_jax_and_host():
    """tests/test_serialize.py's COO (k = 3, 4 wires, repeated cells)."""
    tau, k, nw = 987654321987654321 % FR_MOD, 3, 4
    rows = np.array([0, 0, 1, 5, 7, 7, 7], np.int64)
    cols = np.array([0, 3, 1, 2, 0, 3, 2], np.int64)
    coeffs = [1, 2, FR_MOD - 1, 17, 5, 6, FR_MOD - 12345]
    coo = (rows, cols, np.arange(len(coeffs), dtype=np.int32), coeffs)
    lag = tg._lagrange_at_tau_mont_dev(k, tau, CPU)
    got = _ints(tg._poly_evals_dev(coo, lag, nw))
    want = jg._poly_evals_dev(coo, jnp.asarray(lag.numpy().astype(np.uint32)), nw)
    assert got == _ints(want)
    assert got == tg._poly_evals_at_tau(coo, tg._lagrange_at_tau(k, tau), nw)
    assert got == jg._poly_evals_at_tau((rows, cols, coeffs), jg._lagrange_at_tau(k, tau), nw)


def test_poly_evals_long_column(monkeypatch):
    """A column with many more terms than rows: wire 0 in every row of a
    domain of 8, 3,000 times over with coefficient r - 1 (its limb sums
    reach 2^27.6 before the carry fix), beside short columns; then the
    bound: a column of POLY_MAX_TERMS or more terms is refused."""
    k, nw, reps = 3, 3, 3000
    tau = 0x5EED % FR_MOD
    n = 1 << k
    rows = np.concatenate([np.tile(np.arange(n), reps), [2, 5]]).astype(np.int64)
    cols = np.concatenate([np.zeros(n * reps, np.int64), [1, 2]])
    cidx = np.concatenate([np.zeros(n * reps, np.int32), [1, 2]]).astype(np.int32)
    pal = [FR_MOD - 1, 9, FR_MOD - 2]
    coo = (rows, cols, cidx, pal)
    lag = tg._lagrange_at_tau_mont_dev(k, tau, CPU)
    got = _ints(tg._poly_evals_dev(coo, lag, nw))
    assert got == tg._poly_evals_at_tau(coo, tg._lagrange_at_tau(k, tau), nw)
    monkeypatch.setattr(tg, "POLY_MAX_TERMS", n * reps)
    with pytest.raises(ValueError):
        tg._poly_evals_dev(coo, lag, nw)


@pytest.mark.parametrize("make_cs", [toy_cs, bit_cs], ids=["toy_cs", "bit_cs"])
def test_setup_scalars_dev_and_setup_match_host(make_cs):
    """setup_scalars_dev equals setup_scalars (host ints) query by query,
    the only step where setup and setup_host differ; on toy_cs, setup and
    setup_host under the same rng give the same key points and vk."""
    cs = make_cs()
    toxic = tuple(random.Random(9).randrange(1, FR_MOD) for _ in range(5))
    k, host, _ = tg.setup_scalars(cs, toxic)
    k2, dev, _ = tg.setup_scalars_dev(cs, toxic, CPU)
    assert k == k2 and set(host) == set(dev)
    for q in host:
        assert _ints(dev[q]) == host[q], q
    if make_cs is bit_cs:
        return
    rng = lambda: iter(toxic).__next__  # noqa: E731
    pk, vk = tg.setup(cs, rng=rng(), plan=False, device=CPU)
    pk2, vk2 = tg.setup_host(cs, rng=rng(), plan=False, device=CPU)
    for q, _ in tg.MSM_QUERIES:
        for a, b in zip(getattr(pk, q), getattr(pk2, q)):
            assert torch.equal(a, b), q
    assert (vk.ic, vk.gamma2, vk.delta2) == (vk2.ic, vk2.gamma2, vk2.delta2)


def test_h_and_setup_scalar_kernels_match_jax():
    """_h_scalars_kernel and _setup_scalars_kernel against pob_tpu's at
    k = 3."""
    k, tau, s = 3, 0xABCDEF % FR_MOD, ntt.domain_root(4)
    c0 = 0x1234567 % FR_MOD
    c0_limbs = tl.int_to_limbs(c0)
    got = tg._h_scalars_kernel(k, _mont([tau])[0], _mont([s])[0], torch.from_numpy(c0_limbs))
    want = jg._h_scalars_kernel(k, jnp.asarray(tl.int_to_limbs(tau * R % FR_MOD).astype(np.uint32)),
                                jnp.asarray(tl.int_to_limbs(s * R % FR_MOD).astype(np.uint32)),
                                jnp.asarray(c0_limbs.astype(np.uint32)))
    assert _ints(got) == _ints(want)
    rng = random.Random(4)
    u, v, w = (torch.from_numpy(tl.ints_to_limbs([rng.randrange(FR_MOD) for _ in range(6)]))
               for _ in range(3))
    consts = [_mont([c])[0] for c in (3, 5, 7, 11)]
    got = tg._setup_scalars_kernel(2, u, v, w, *consts)
    want = jg._setup_scalars_kernel(2, *(jnp.asarray(x.numpy().astype(np.uint32))
                                         for x in (u, v, w, *consts)))
    assert all(_ints(a) == _ints(b) for a, b in zip(got, want))


# The three configurations as their keys lie on a card of 80 GB: (wires,
# domain k, nonzeros of A with binding rows and B, the plan's bytes). The
# plan of PROD_CONFIG is reckoned from TEST_CONFIG's 3.227 GB by wires.
SIZES = {
    "spend": (156_870, 18, 201_290 + 2 + 165_174, 86_300_000),
    "test": (3_962_976, 22, 8_107_115 + 2 + 4_086_778, 3_227_000_000),
    "prod": (13_330_191, 24, 32_287_036 + 2 + 13_482_377, 3_227_000_000 * 13_330_191 // 3_962_976),
}


def _free_beside(nw: int, k: int, nnz: int, card: int = 80 * 10**9) -> tuple:
    """(counts, free bytes): the query counts of a key with nw wires and
    one public, and what a card leaves beside its Jacobian points (192 B a
    G1 point, 384 B a G2 point) and its matrices (80 B a nonzero)."""
    counts = {"a_query": nw, "b1_query": nw, "b2_query": nw, "l_query": nw - 2,
              "h_query": 1 << k}
    jac = sum(counts[q] * (384 if g == "g2" else 192) for q, g in tg.MSM_QUERIES)
    return counts, card - jac - 80 * nnz


@pytest.mark.parametrize("name", ["spend", "test", "prod"])
def test_choose_windows_on_the_three_keys(name):
    """(32, 8) everywhere for Spend and TEST_CONFIG, planned or not; at
    PROD_CONFIG the planned queries keep window 0 and h takes the largest S
    whose key, plan and one proof fit MEM_SHARE of the card (16: 32 would
    take 34.4 GB of h bases); without a plan every query shares one S."""
    nw, k, nnz, plan = SIZES[name]
    counts, free = _free_beside(nw, k, nnz)
    planned = tg.choose_windows(counts, k, free, True, plan)
    plain = tg.choose_windows(counts, k, free)
    if name != "prod":
        assert planned == plain == dict.fromkeys(counts, 32)
        return
    assert planned == {"a_query": 1, "b1_query": 1, "b2_query": 1, "l_query": 1, "h_query": 16}
    assert len(set(plain.values())) == 1 and plain["h_query"] in msm.WINDOW_COUNTS
    assert plain["h_query"] < 32
    per = {q: counts[q] * msm._bases_width(g) * 4 for q, g in tg.MSM_QUERIES}
    used = sum(planned[q] * per[q] for q in per) + plan + tg.proof_bytes(k, 1 << k)
    assert used <= tg.MEM_SHARE * free < used + 16 * per["h_query"]


@pytest.mark.parametrize("k", [1, 6, 10])
def test_ntt_tables_made_on_device_equal_host(k):
    """The twiddle and coset tables as a card makes them (mont_powers_mont;
    here through the plain K1) equal the host tables bit for bit."""
    shift = ntt.domain_root(k + 1)
    for inverse in (False, True):
        assert np.array_equal(ntt._root_powers_dev(k, inverse, CPU).numpy(),
                              ntt._root_powers(k, inverse))
        assert np.array_equal(ntt._coset_powers_dev(k, shift, inverse, CPU).numpy(),
                              ntt._coset_powers(k, shift, inverse))
