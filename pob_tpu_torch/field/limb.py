"""Batched BN254 Fr / Fq arithmetic on PyTorch tensors.

Layout (the JAX package's, so tests compare like with like): a field element
is a ``(..., 16)`` ``torch.int32`` tensor of 16-bit limbs, little-endian.
Hot paths run in Montgomery form (R = 2^256).

Every arithmetic entry point dispatches on where its tensors lie: on a CUDA
tensor it launches kernel K1 (``field/cuda_mont.py``, ``csrc/mont.cu``), on a
CPU tensor it runs the plain PyTorch version below. The plain versions are
the reference the kernels are checked against on the card; they compute in
``int64`` because PyTorch's CPU backend has no ``uint32`` add or shift."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tf

from .ref import FQ_MOD, FR_MOD

L = 16  # limbs per element
BITS = 16  # bits per limb
MASK = 0xFFFF
I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# host conversions (numpy)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, n: int = L) -> np.ndarray:
    """Python int -> little-endian int32 limb vector."""
    return np.array([(x >> (BITS * i)) & MASK for i in range(n)], dtype=np.int32)


def ints_to_limbs(xs, n: int = L) -> np.ndarray:
    """Iterable of ints -> (len, n) int32 limb array, through one byte buffer
    (one C-level to_bytes per element) so million-element conversions stay
    fast."""
    xs = list(xs)
    if not xs:
        return np.zeros((0, n), np.int32)
    buf = b"".join(int(x).to_bytes(2 * n, "little") for x in xs)
    return np.frombuffer(buf, np.uint16).reshape(len(xs), n).astype(np.int32)


def limbs_to_int(a) -> int:
    """Single limb vector -> python int."""
    a = np.asarray(a, dtype=np.int64)
    return sum(int(v) << (BITS * i) for i, v in enumerate(a))


def limb_rows_to_ints(a) -> list:
    """(m, n) limb array -> list of m python ints (one int.from_bytes each)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int64)).astype("<u2")
    buf = a.tobytes()
    n2 = a.shape[1] * 2
    return [int.from_bytes(buf[i * n2:(i + 1) * n2], "little")
            for i in range(a.shape[0])]


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Per-modulus constants (16-bit limbs, int64)."""

    mod: int
    field_id: int  # 0 = Fr, 1 = Fq (the kernels' selector)
    p: np.ndarray
    np_full: np.ndarray  # -p^{-1} mod 2^256 (full-word REDC)
    neg_p: np.ndarray  # 2^256 - p (conditional subtraction by addition)
    r_mont: np.ndarray  # R mod p
    r2: np.ndarray  # R^2 mod p

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(mod: int) -> "FieldSpec":
        big = 1 << (L * BITS)
        r = big % mod
        return FieldSpec(
            mod=mod,
            field_id=0 if mod == FR_MOD else 1,
            p=int_to_limbs(mod).astype(np.int64),
            np_full=int_to_limbs((-pow(mod, -1, big)) % big).astype(np.int64),
            neg_p=int_to_limbs(big - mod).astype(np.int64),
            r_mont=int_to_limbs(r).astype(np.int64),
            r2=int_to_limbs(r * r % mod).astype(np.int64),
        )


FR = FieldSpec.make(FR_MOD)
FQ = FieldSpec.make(FQ_MOD)


_CONSTS: dict = {}


def const(arr: np.ndarray, like: torch.Tensor, dtype=I32) -> torch.Tensor:
    """A host constant array as a tensor on `like`'s device (cached by
    identity: pass module-level or cached arrays only)."""
    key = (id(arr), dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(np.asarray(arr, np.int64)).to(
            dtype=dtype, device=like.device)
        t._pob_src = arr  # keep the array alive so its id is never reused
    return t


def to_device(arr, device) -> torch.Tensor:
    """Host limb array -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.int32))).to(device)


# ---------------------------------------------------------------------------
# plain carry plumbing (int64 columns)
# ---------------------------------------------------------------------------


def _shift_up(v, d: int = 1):
    """Shift limb columns toward higher indices by d, zero-filling."""
    return tf.pad(v[..., :-d], (d, 0))


def carry_fix(v, bits: int = 37):
    """Normalize non-negative int64 limb columns (each < 2^bits) to 16-bit
    limbs; arithmetic is mod 2^(16 n), so callers add a headroom column when
    the carry out of the top matters. Split-add passes bring every pending
    carry to 0/1; the remaining unit ripple is resolved in one prefix step:
    the carry out of column i is the generate bit of the last column at or
    below i that does not propagate (a running maximum of positions)."""
    while bits > BITS + 1:
        v = (v & MASK) + _shift_up(v >> BITS)
        bits = max(bits - BITS, BITS) + 1
    v = (v & MASK) + _shift_up(v >> BITS)  # <= 2^16: pending carries 0/1
    pos = torch.arange(v.shape[-1], device=v.device).expand(v.shape)
    last = torch.where(v != MASK, pos, -1).cummax(-1).values
    cout = torch.gather(v >> BITS, -1, last.clamp(min=0)) * (last >= 0)
    return ((v & MASK) + _shift_up(cout)) & MASK


@functools.lru_cache(maxsize=None)
def _candidates(spec: FieldSpec, kind: str) -> np.ndarray:
    """Offsets that give both conditional-subtraction candidates from one
    normalization (row 0 keeps the value, row 1 subtracts or adds p)."""
    k = np.zeros((2, L + 1), np.int64)
    if kind == "add":  # s, s + 2^256 - p
        k[1, :L] = spec.neg_p
    elif kind == "sub":  # a - b + 2^256, a - b + 2^256 + p
        k[:, 0] = 1 << BITS
        k[:, 1:L] = MASK
        k[1, :L] += spec.p
    else:  # "redc": u, u + (2^256 - p) R over 2L + 2 columns
        k = np.zeros((2, 2 * L + 2), np.int64)
        k[1, L:2 * L] = spec.neg_p
    return k


def _pick(cands, flag_col: int, lo: int):
    """Row 1 where its column flag_col is set (the subtraction did not go
    negative / the value reached p), else row 0; limbs lo .. lo+15."""
    take = cands[1][..., flag_col] == 1
    return torch.where(take[..., None], cands[1][..., lo:lo + L], cands[0][..., lo:lo + L])


_STRIDED_MAX = 1 << 16  # rows for the strided-diagonal form (4 KB of int64 each)


def _wide(a, b):
    """Unnormalized 32 product columns of two 16-limb values (int64)."""
    a, b = torch.broadcast_tensors(a.to(I64), b.to(I64))
    shape = a.shape[:-1]
    rows = int(np.prod(shape)) if shape else 1
    if rows <= _STRIDED_MAX:
        prod = (a[..., :, None] * b[..., None, :]).reshape(rows, L, L)
        q = torch.zeros(rows, L, 2 * L, dtype=I64, device=a.device)
        # row i of the product lands in columns i .. i+15
        q.as_strided((rows, L, L), (2 * L * L, 2 * L + 1, 1)).copy_(prod)
        return q.sum(1).reshape(shape + (2 * L,))
    c = torch.zeros(shape + (2 * L,), dtype=I64, device=a.device)
    for i in range(L):
        c[..., i:i + L] += a[..., i:i + 1] * b
    return c


def _redc_cols(spec: FieldSpec, c, c_bits: int):
    """Full-word REDC of product columns c (..., 32), each < 2^c_bits, with
    value < p * R: m = (c mod R) * (-p^{-1}) mod R, U = (c + m p) / R < 2p,
    then U or U - p."""
    m = carry_fix(_wide(c[..., :L], const(spec.np_full, c, I64))[..., :L], c_bits + 20)
    u = tf.pad(c + _wide(m, const(spec.p, c, I64)), (0, 2))
    cands = carry_fix(u.unsqueeze(-2) + const(_candidates(spec, "redc"), u, I64),
                      max(c_bits, 36) + 2)
    return _pick(cands.unbind(-2), 2 * L, L)


def mont_mul_plain(spec, a, b):
    return _redc_cols(spec, _wide(a, b), 36).to(I32)


def mont_reduce_plain(spec, c):
    return _redc_cols(spec, c.to(I64), BITS).to(I32)


def add_plain(spec, a, b):
    s = tf.pad(a.to(I64) + b.to(I64), (0, 1))
    cands = carry_fix(s.unsqueeze(-2) + const(_candidates(spec, "add"), s, I64), BITS + 1)
    return _pick(cands.unbind(-2), L, 0).to(I32)


def sub_plain(spec, a, b):
    d = tf.pad(a.to(I64) - b.to(I64), (0, 1))
    cands = carry_fix(d.unsqueeze(-2) + const(_candidates(spec, "sub"), d, I64), BITS + 2)
    c0, c1 = cands.unbind(-2)
    # row 0 reaches 2^256 exactly when a >= b; otherwise a - b + p is the answer
    keep = c0[..., L] == 1
    return torch.where(keep[..., None], c0[..., :L], c1[..., :L]).to(I32)


# ---------------------------------------------------------------------------
# public arithmetic: K1 on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def _on_cuda(*ts) -> bool:
    return any(t.is_cuda for t in ts)


def add(spec: FieldSpec, a, b):
    if _on_cuda(a, b):
        from . import cuda_mont
        return cuda_mont.field_op(cuda_mont.ADD, spec, a, b)
    return add_plain(spec, a, b)


def sub(spec: FieldSpec, a, b):
    if _on_cuda(a, b):
        from . import cuda_mont
        return cuda_mont.field_op(cuda_mont.SUB, spec, a, b)
    return sub_plain(spec, a, b)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a, b):
    if _on_cuda(a, b):
        from . import cuda_mont
        return cuda_mont.field_op(cuda_mont.MUL, spec, a, b)
    return mont_mul_plain(spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    if a.is_cuda:
        from . import cuda_mont
        return cuda_mont.field_op(cuda_mont.SQR, spec, a)
    return mont_mul_plain(spec, a, a)


def mont_reduce(spec: FieldSpec, c):
    """(..., 32) normalized limbs, value < p R -> c R^{-1} mod p."""
    if c.is_cuda:
        from . import cuda_mont
        return cuda_mont.field_op(cuda_mont.REDC, spec, c)
    return mont_reduce_plain(spec, c)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, const(spec.r2, a))


def from_mont(spec: FieldSpec, a):
    return mont_reduce(spec, tf.pad(a, (0, L)))


def small_to_limbs(x):
    """(...,) non-negative int tensor < 2^32 -> (..., 16) int32 limb scalar."""
    x = x.to(I64)
    return tf.pad(torch.stack([x & MASK, x >> BITS], -1), (0, L - 2)).to(I32)


def is_zero(a):
    return (a == 0).all(-1)


def sub_raw(a, b):
    """16-limb subtraction a - b mod 2^256: (limbs, borrow in {0, 1}), the
    borrow 1 exactly when a < b (plain torch on either device)."""
    v = tf.pad(a.to(I64) + (MASK - b.to(I64)), (0, 1))
    v[..., 0] += 1  # a + ~b + 1
    fixed = carry_fix(v, BITS + 2)
    return fixed[..., :L].to(I32), (1 - fixed[..., L]).to(I32)


def _exp_bits(e: int) -> list:
    return [(e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1)]


def mont_pow_bits(spec: FieldSpec, a, exp_bits):
    """a^e for a in Montgomery form, e given as MSB-first bits (a static
    list): a squaring per bit and a product per set bit, each through K1 on
    a CUDA tensor."""
    r = const(spec.r_mont, a).expand(a.shape)
    for bit in exp_bits:
        r = mont_sqr(spec, r)
        if bit:
            r = mont_mul(spec, r, a)
    return r


def mont_pow_int(spec: FieldSpec, a, e: int):
    """a^e for a in Montgomery form and a python int e >= 0."""
    return mont_pow_bits(spec, a, _exp_bits(e))


def inv_mont(spec: FieldSpec, a):
    """Inverse in Montgomery form by Fermat (a^(p-2)): aR -> a^-1 R; 0 -> 0."""
    return mont_pow_bits(spec, a, _exp_bits(spec.mod - 2))


def batch_inv_mont(spec: FieldSpec, a, axis: int = 0):
    """Montgomery's trick along `axis`: prefix products, one inversion of
    their total, and the inverses back down. Zero entries map to zero."""
    a = a.movedim(axis, 0)
    n = a.shape[0]
    zero = is_zero(a)[..., None]
    one = const(spec.r_mont, a).expand(a.shape[1:])
    safe = torch.where(zero, one, a)
    prefixes = [one]
    for i in range(n):
        prefixes.append(mont_mul(spec, prefixes[-1], safe[i]))
    acc = inv_mont(spec, prefixes[-1])
    outs = [None] * n
    for i in range(n - 1, -1, -1):
        outs[i] = mont_mul(spec, acc, prefixes[i])
        acc = mont_mul(spec, acc, safe[i])
    out = torch.stack(outs, 0)
    return torch.where(zero, 0, out).movedim(0, axis)


def _scan_products(spec: FieldSpec, x):
    """Inclusive prefix products along axis 0, x[i] <- x[0] ... x[i]: a
    Hillis-Steele scan, log2(n) steps of one batched product each (K1 on a
    CUDA tensor)."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], mont_mul(spec, x[d:], x[:-d])], 0)
        d *= 2
    return x


def batch_inv_mont_scan(spec: FieldSpec, a):
    """Montgomery's trick over a large leading axis by log-depth scans (the
    step-by-step batch_inv_mont suits small batches only): a (n, 16)
    Montgomery, n >= 1; zero entries map to zero; one field inversion in
    all. inv[i] = (prod of all)^-1 * (product before i) * (product after
    i), from an inclusive prefix scan and an inclusive suffix scan."""
    one = const(spec.r_mont, a).expand(a.shape)
    zero = is_zero(a)[..., None]
    safe = torch.where(zero, one, a)
    prefix = _scan_products(spec, safe)
    suffix = _scan_products(spec, safe.flip(0)).flip(0)
    total_inv = inv_mont(spec, prefix[-1:])
    pre_ex = torch.cat([one[:1], prefix[:-1]], 0)
    suf_ex = torch.cat([suffix[1:], one[:1]], 0)
    del prefix, suffix
    out = mont_mul(spec, mont_mul(spec, pre_ex, suf_ex), total_inv)
    return torch.where(zero, 0, out)


def mont_powers_mont(spec: FieldSpec, base_mont, n: int):
    """(n, 16) base^j in Montgomery form, j in [0, n), for a (16,) Montgomery
    base tensor: the powers so far times base^len, doubling the length each
    step (log2(n) products, K1 on a CUDA tensor)."""
    assert n >= 1
    acc = const(spec.r_mont, base_mont)[None]  # [base^0]
    step = base_mont[None]
    while acc.shape[0] < n:
        acc = torch.cat([acc, mont_mul(spec, acc, step)], 0)
        step = mont_sqr(spec, step)
    return acc[:n]


def mont_powers(spec: FieldSpec, base: int, n: int, device="cpu"):
    """(n, 16) base^j in Montgomery form on `device`, j in [0, n)."""
    base_m = torch.from_numpy(int_to_limbs(base % spec.mod * (1 << 256) % spec.mod)).to(device)
    return mont_powers_mont(spec, base_m, n)


# ---------------------------------------------------------------------------
# byte / bit conversions
# ---------------------------------------------------------------------------


def limbs_to_be_bytes(a):
    """(..., 16) limbs -> (..., 32) big-endian bytes (int32)."""
    le = torch.stack([a & 0xFF, (a >> 8) & 0xFF], -1).reshape(a.shape[:-1] + (2 * L,))
    return le.flip(-1).to(I32)


def be_bytes_to_limbs(b):
    """(..., 32) big-endian bytes -> (..., 16) limbs."""
    pairs = b.flip(-1).reshape(b.shape[:-1] + (L, 2)).to(I32)
    return pairs[..., 0] | (pairs[..., 1] << 8)


def limbs_to_bits_le(a, nbits: int = 256):
    """(..., 16) limbs -> (..., nbits) little-endian bits (int32)."""
    shifts = torch.arange(BITS, device=a.device, dtype=I32)
    bits = (a[..., :, None] >> shifts) & 1
    return bits.reshape(a.shape[:-1] + (L * BITS,))[..., :nbits].to(I32)
