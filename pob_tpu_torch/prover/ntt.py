"""Radix-2 NTT over BN254 Fr on tensors (batched, Montgomery limbs).

Used for the QAP quotient: evaluate on a multiplicative coset of the 2^k
domain, multiply pointwise, and MSM the coset evaluations (groth16.py).

The transform is an iterative Cooley-Tukey: a bit-reversal gather, then k
butterfly stages from the master twiddle table. On a CUDA tensor kernel K2
(``csrc/ntt.cu``) runs up to 10 stages per launch in shared memory, over
every row of the batch, the gather folded into its first launch; on a CPU
tensor the plain version ``_transform_plain`` runs the same stages with
PyTorch indexing and the plain field ops. 2-adicity of Fr is 28, generator 5."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD

TWO_ADICITY = 28
_ODD = (FR_MOD - 1) >> TWO_ADICITY
ROOT_OF_UNITY = pow(5, _ODD, FR_MOD)  # order 2^28
_R = (1 << 256) % FR_MOD
COSET_SHIFT = 5  # multiplicative generator of Fr*, not in the 2^k subgroup


def domain_root(k: int) -> int:
    """Primitive 2^k-th root of unity."""
    assert k <= TWO_ADICITY
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), FR_MOD)


def _powers(base: int, n: int) -> list:
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * base % FR_MOD
    return out


@functools.lru_cache(maxsize=None)
def _root_powers(k: int, inverse: bool) -> np.ndarray:
    """w^t * R for t in [0, 2^(k-1)): the master twiddle table every stage
    gathers from (stage s uses indices (j % 2^s) * 2^(k-1-s))."""
    w = domain_root(k)
    if inverse:
        w = pow(w, FR_MOD - 2, FR_MOD)
    return limb.ints_to_limbs(x * _R % FR_MOD for x in _powers(w, max(1, (1 << k) // 2)))


@functools.lru_cache(maxsize=None)
def _bitrev(k: int) -> np.ndarray:
    idx = np.arange(1 << k, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _n_inv_mont(k: int) -> np.ndarray:
    return limb.int_to_limbs(pow(1 << k, FR_MOD - 2, FR_MOD) * _R % FR_MOD)


@functools.lru_cache(maxsize=None)
def _coset_powers(k: int, shift: int, inverse: bool) -> np.ndarray:
    g = pow(shift, FR_MOD - 2, FR_MOD) if inverse else shift
    return limb.ints_to_limbs(x * _R % FR_MOD for x in _powers(g, 1 << k))


def _root_powers_dev(k: int, inverse: bool, device) -> torch.Tensor:
    """_root_powers made on `device` by limb.mont_powers_mont (K1 on a card):
    the same bits."""
    w = domain_root(k)
    if inverse:
        w = pow(w, FR_MOD - 2, FR_MOD)
    return limb.mont_powers(FR, w, max(1, (1 << k) // 2), device)


def _coset_powers_dev(k: int, shift: int, inverse: bool, device) -> torch.Tensor:
    """_coset_powers made on `device` by limb.mont_powers_mont: the same bits."""
    g = pow(shift, FR_MOD - 2, FR_MOD) if inverse else shift
    return limb.mont_powers(FR, g, 1 << k, device)


# On a card the twiddle and coset tables are made there: at 2^24 the host
# tables are some 33.6 M python ints (about a minute of host time).
_MADE_ON_CARD = {_root_powers: _root_powers_dev, _coset_powers: _coset_powers_dev}


@functools.lru_cache(maxsize=32)
def _on_device(fn, args: tuple, device: str) -> torch.Tensor:
    if torch.device(device).type == "cuda" and fn in _MADE_ON_CARD:
        return _MADE_ON_CARD[fn](*args, device)
    return limb.to_device(fn(*args), device)


def _table(fn, *args, like: torch.Tensor) -> torch.Tensor:
    return _on_device(fn, args, str(like.device))


PLAIN_CHUNK = 1 << 20  # butterflies per step of _transform_plain (bounds its int64 temporaries)


def _transform_plain(a, k: int, roots):
    """Bit-reversed input -> k butterfly stages with torch gathers and the
    plain field functions (the plain version of K2, on any device), each
    stage PLAIN_CHUNK butterflies at a time."""
    n = 1 << k
    for s in range(k):
        half = 1 << s
        out = torch.empty_like(a)
        for o in range(0, n // 2, PLAIN_CHUNK):
            j = torch.arange(o, min(o + PLAIN_CHUNK, n // 2), device=a.device)
            jm = j % half
            u_idx = (j // half) * (2 * half) + jm
            v_idx = u_idx + half
            tw = roots[jm * (n // 2 // half)]
            u = a.index_select(-2, u_idx)
            v = limb.mont_mul_plain(FR, a.index_select(-2, v_idx), tw)
            out[..., u_idx, :] = limb.add_plain(FR, u, v)
            out[..., v_idx, :] = limb.sub_plain(FR, u, v)
        a = out
    return a


TILE_LOG = 10  # most elements one K2 block holds in shared memory (csrc/ntt.cu)


def ntt_passes(k: int) -> list:
    """(s0, T, C) of each K2 launch for a 2^k transform: T stages from stage
    s0 on tiles of 2^T elements 2^s0 apart times 2^C adjacent columns, every
    tile at most 2^TILE_LOG elements (k = 18: (0, 10, 0), (10, 8, 2))."""
    out, s0 = [], 0
    while s0 < k:
        t = min(TILE_LOG, k - s0)
        out.append((s0, t, min(s0, TILE_LOG - t)))
        s0 += t
    return out


def ntt_stages_cuda(a, k: int, roots, gather: bool = False):
    """K2: the k butterfly stages over a (..., 2^k, 16) CUDA tensor, one
    launch per entry of ntt_passes(k); returns a new tensor. The input is in
    bit-reversed order, or in natural order with gather=True (the first pass
    then gathers it)."""
    x = a.contiguous()
    roots = roots.contiguous()
    _build.check_cuda(x, roots)
    if x.shape[-2:] != (1 << k, limb.L) or roots.shape != (max(1, (1 << k) // 2), limb.L):
        raise ValueError(f"bad NTT shapes {tuple(x.shape)} / {tuple(roots.shape)}")
    if k == 0:
        return x.clone()
    rows = x.numel() // ((1 << k) * limb.L)
    y = torch.empty_like(x)
    fn = _build.lib("ntt.cu").pob_ntt_pass
    src = x
    for s0, t, c in ntt_passes(k):
        rc = fn(src.data_ptr(), y.data_ptr(), roots.data_ptr(), rows, k, s0, t, c,
                int(gather and s0 == 0), _build.stream_ptr(x))
        _build.LAUNCHES["ntt"] += 1
        _build.check(rc, "pob_ntt_pass")
        src = y
    return y


def _transform(a, k: int, inverse: bool):
    if k == 0:
        return a
    roots = _table(_root_powers, k, inverse, like=a)
    if a.is_cuda:
        return ntt_stages_cuda(a, k, roots, gather=True)
    return _transform_plain(a.index_select(-2, _table(_bitrev, k, like=a)), k, roots)


def ntt(a, k: int):
    """Forward NTT. a: (..., 2^k, 16) Montgomery limbs, natural order in and out."""
    return _transform(a, k, inverse=False)


def intt(a, k: int):
    """Inverse NTT (includes the 1/n scaling)."""
    out = _transform(a, k, inverse=True)
    return limb.mont_mul(FR, out, limb.const(_n_inv_mont(k), out))


def coeffs_to_coset_evals(coeffs, k: int, shift: int = COSET_SHIFT):
    """Evaluate a coefficient vector on the coset shift * <w>."""
    return ntt(limb.mont_mul(FR, coeffs, _table(_coset_powers, k, shift, False, like=coeffs)), k)


def coset_evals_to_coeffs(evals, k: int, shift: int = COSET_SHIFT):
    coeffs = intt(evals, k)
    return limb.mont_mul(FR, coeffs, _table(_coset_powers, k, shift, True, like=coeffs))
