"""Port NTT (pob_tpu_torch.prover.ntt, plain path of kernel K2) against
pob_tpu.prover.ntt: forward, inverse and both coset transforms on the same
numpy inputs, batched. Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pob_tpu.prover import ntt as jntt
from pob_tpu_torch.field import limb as tl
from pob_tpu_torch.prover import ntt as tntt

torch.set_num_threads(1)

K = 6


@pytest.fixture(scope="module")
def coeffs():
    x = np.random.default_rng(11).integers(0, 1 << 16, size=(2, 1 << K, 16), dtype=np.int64)
    x[..., 15] %= 0x3000
    return x.astype(np.int32)


@pytest.mark.parametrize("fn", ["ntt", "intt", "coeffs_to_coset_evals", "coset_evals_to_coeffs"])
def test_transform_matches_jax(coeffs, fn):
    want = np.asarray(jax.jit(lambda a: getattr(jntt, fn)(a, K))(
        jnp.asarray(coeffs.astype(np.uint32))))
    got = getattr(tntt, fn)(torch.from_numpy(coeffs), K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_trips_and_tables(coeffs):
    x = torch.from_numpy(coeffs)
    np.testing.assert_array_equal(tntt.intt(tntt.ntt(x, K), K).numpy(), coeffs)
    shift = tntt.domain_root(K + 1)
    back = tntt.coset_evals_to_coeffs(tntt.coeffs_to_coset_evals(x, K, shift), K, shift)
    np.testing.assert_array_equal(back.numpy(), coeffs)
    np.testing.assert_array_equal(tntt._bitrev(8), jntt._bitrev(8))
    np.testing.assert_array_equal(tntt._root_powers(8, True), jntt._root_powers(8, True))
    assert tntt.domain_root(18) == jntt.domain_root(18)


def _passes_replayed(x, k: int, roots, gather: bool):
    """K2's launches (csrc/ntt.cu) replayed with torch indexing and the plain
    field ops, every tile of a pass at once: the tile's element (j, c) is row
    element base + j 2^s0 + c, and stage s0 + st pairs j with j + 2^st."""
    y = x.clone()
    for s0, T, C in tntt.ntt_passes(k):
        tiles = torch.arange(1 << (k - T - C))
        lo = (tiles & ((1 << (s0 - C)) - 1)) << C
        base = ((tiles >> (s0 - C)) << (s0 + T)) + lo
        e = torch.arange(1 << (T + C))
        g = base[:, None] + ((e >> C) << s0)[None] + (e & ((1 << C) - 1))[None]
        src = g
        if gather and s0 == 0:
            src = torch.from_numpy(tntt._bitrev(k))[g]
        sm = (x if gather and s0 == 0 else y)[..., src.flatten(), :].reshape(
            x.shape[:-2] + g.shape + (16,))
        q = torch.arange(1 << (T + C - 1))
        c, jj = q & ((1 << C) - 1), q >> C
        for st in range(T):
            jm = jj & ((1 << st) - 1)
            u = ((((jj >> st) << (st + 1)) + jm) << C) + c
            v = u + (1 << (st + C))
            tw = roots[(((jm << s0)[None] + lo[:, None] + c[None]) << (k - 1 - s0 - st))]
            a, b = sm[..., u, :], tl.mont_mul_plain(tl.FR, sm[..., v, :], tw)
            sm = sm.clone()
            sm[..., u, :], sm[..., v, :] = tl.add_plain(tl.FR, a, b), tl.sub_plain(tl.FR, a, b)
        y = y.clone()
        y[..., g.flatten(), :] = sm.reshape(x.shape[:-2] + (-1, 16))
    return y


@pytest.mark.parametrize("k", [1, 5, 11])
def test_k2_pass_tiling_matches_plain(k):
    """The tiles, twiddle indices and folded bit-reversal gather of K2's
    passes give the plain transform, below one tile (k = 1, 5) and with two
    unevenly split passes (k = 11: 10 + 1 stages)."""
    x = np.random.default_rng(k).integers(0, 1 << 16, size=(2, 1 << k, 16), dtype=np.int64)
    x[..., 15] %= 0x3000
    x = torch.from_numpy(x.astype(np.int32))
    roots = torch.from_numpy(tntt._root_powers(k, False))
    br = x.index_select(-2, torch.from_numpy(tntt._bitrev(k)))
    want = tntt._transform_plain(br, k, roots)
    assert torch.equal(_passes_replayed(br, k, roots, False), want)
    assert torch.equal(_passes_replayed(x, k, roots, True), want)
    passes = tntt.ntt_passes(k)
    assert sum(t for _, t, _ in passes) == k and len(passes) == -(-k // tntt.TILE_LOG)
    assert all(t + c <= tntt.TILE_LOG and c <= s0 for s0, t, c in passes)


def test_plain_transform_in_chunks(monkeypatch):
    """The plain K2 goes PLAIN_CHUNK butterflies at a time (2^20: at the
    production domain 2^24 one stage at once would need some 20 GB of int64
    temporaries); in chunks of 8 it gives the same rows as in one."""
    k = 7
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 16, (2, 1 << k, 16))
                         .astype(np.int32))
    x[..., 15] %= 0x3000
    roots = tl.to_device(tntt._root_powers(k, False), "cpu")
    whole = tntt._transform_plain(x, k, roots)
    monkeypatch.setattr(tntt, "PLAIN_CHUNK", 8)
    assert torch.equal(tntt._transform_plain(x, k, roots), whole)
