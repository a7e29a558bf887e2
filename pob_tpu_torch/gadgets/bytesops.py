"""Byte/array plumbing gadgets (reference circuits/utils/{array,selector,
shift,concat,convert,divide}.circom), vectorized over leading batch axes.

Conventions:
- byte arrays: int32 tensors, trailing axis = position;
- small scalars (lengths, counts): int tensors, non-negative;
- big scalars (balances, keys): (..., 16) int32 limb tensors (field/limb.py);
- every gadget that can reject in-circuit returns an `ok` bool alongside data.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tf

from ..field import limb

I32 = torch.int32


def _arange(n: int, like):
    return torch.arange(n, device=like.device)


# ---------------------------------------------------------------------------
# masks / filters / selection
# ---------------------------------------------------------------------------


def filter_mask(count, n: int):
    """Filter (array.circom:26-40): first `count` positions 1, rest 0."""
    count = torch.as_tensor(count)
    return (_arange(n, count) < count[..., None]).to(I32)


def fit(a, n: int):
    """Fit (array.circom:47-57): truncate or zero-pad the trailing axis to n."""
    m = a.shape[-1]
    return a[..., :n] if m >= n else tf.pad(a, (0, n - m))


def reverse(a):
    return a.flip(-1)


def selector(vals, select):
    """Selector (selector.circom:21-46): vals[select]; ok iff 0<=select<n."""
    n = vals.shape[-1]
    ok = (select >= 0) & (select < n)
    oh = (_arange(n, vals) == select[..., None]).to(vals.dtype)
    return (vals * oh).sum(-1, dtype=vals.dtype), ok


def selector_array(arrays, select):
    """SelectorArray1D (selector.circom:62-77): arrays (..., n, p) -> (..., p)."""
    n = arrays.shape[-2]
    ok = (select >= 0) & (select < n)
    oh = (_arange(n, arrays) == select[..., None]).to(arrays.dtype)
    return (arrays * oh[..., None]).sum(-2, dtype=arrays.dtype), ok


def mask(a, count):
    """Mask (concat.circom:18-30): keep the first `count` entries."""
    return a * filter_mask(count, a.shape[-1]).to(a.device)


def _shifted(a, idx):
    """a[..., idx] where 0 <= idx < n, else 0 (idx broadcast against a's
    batch axes)."""
    n = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], idx.shape[:-1])
    idx = idx.expand(shape + idx.shape[-1:])
    gathered = torch.gather(a.expand(shape + (n,)), -1, idx.clamp(0, n - 1))
    return gathered * ((idx >= 0) & (idx < n))


def shift_left(a, count):
    """ShiftLeft (shift.circom:17-36): out[i] = a[i+count], zero fill.
    ok iff 0 <= count <= n."""
    n = a.shape[-1]
    ok = (count >= 0) & (count <= n)
    return _shifted(a, _arange(n, a) + count[..., None]), ok


def shift_right(a, count, max_shift: int):
    """ShiftRight (shift.circom:51-76): widen to n+max_shift, out[i]=a[i-count].
    ok iff 0 <= count <= max_shift."""
    n = a.shape[-1]
    ok = (count >= 0) & (count <= max_shift)
    return _shifted(a, _arange(n + max_shift, a) - count[..., None]), ok


def concat(a, a_len, b, b_len):
    """Concat (concat.circom:47-84). Returns (out, out_len, ok)."""
    max_a, max_b = a.shape[-1], b.shape[-1]
    ok = (a_len >= 0) & (a_len <= max_a) & (b_len >= 0) & (b_len <= max_b)
    shifted_b, ok2 = shift_right(mask(b, b_len), a_len, max_a)
    return fit(mask(a, a_len), max_a + max_b) + shifted_b, a_len + b_len, ok & ok2


# ---------------------------------------------------------------------------
# numeric conversions
# ---------------------------------------------------------------------------


def count_bytes(b):
    """CountBytes (rlp/integer.circom:16-49): significant bytes of BE array."""
    still_zero = torch.cumprod((b == 0).to(I32), -1)
    return b.shape[-1] - still_zero.sum(-1, dtype=I32)


def bytes_to_nibbles(b):
    """Bytes2Nibbles (convert.circom:103-120): high nibble first."""
    return torch.stack([b >> 4, b & 0xF], -1).flatten(-2)


def nibbles_to_bytes(nib):
    """Nibbles2Bytes (convert.circom:132-142). ok iff all nibbles < 16."""
    ok = ((nib >= 0) & (nib < 16)).all(-1)
    pairs = nib.reshape(nib.shape[:-1] + (nib.shape[-1] // 2, 2))
    return pairs[..., 0] * 16 + pairs[..., 1], ok


def limbs_to_be_bytes_checked(v, n: int):
    """Num2BigEndianBytes(n) on a limb scalar: returns (bytes (..., n), ok)
    where ok iff v < 2^(8n) (the implicit Num2Bits range check,
    convert.circom:46-96)."""
    be32 = limb.limbs_to_be_bytes(v)  # (..., 32)
    if n >= 32:
        return tf.pad(be32, (n - 32, 0)), torch.ones(v.shape[:-1], dtype=torch.bool,
                                                     device=v.device)
    return be32[..., 32 - n:], (be32[..., :32 - n] == 0).all(-1)


def be_bytes_to_limbs_any(b):
    """BigEndianBytes2Num for up to 32 bytes -> limb scalar."""
    n = b.shape[-1]
    if n > 32:
        raise ValueError(f"at most 32 bytes, got {n}")
    return limb.be_bytes_to_limbs(tf.pad(b.to(I32), (32 - n, 0)))


def is_byte_string(b):
    """AssertByteString (assert.circom:26-31) as a flag."""
    return ((b >= 0) & (b < 256)).all(-1)


# ---------------------------------------------------------------------------
# comparisons (small ints and limb scalars)
# ---------------------------------------------------------------------------


def fits_bits_i32(v, bits: int):
    """AssertBits for a small int scalar."""
    if bits >= 31:
        return v >= 0
    return (v >= 0) & (v < (1 << bits))


def limb_lt(a, b):
    """a < b on limb scalars (the borrow of a - b)."""
    return limb.sub_raw(a, b)[1] == 1


def limb_leq(a, b):
    return ~limb_lt(b, a)


def limb_fits_bits(v, bits: int):
    """v < 2^bits for a limb scalar (bits <= 256)."""
    if bits >= 256:
        return torch.ones(v.shape[:-1], dtype=torch.bool, device=v.device)
    full, rem = divmod(bits, 16)
    ok = (v[..., full + (1 if rem else 0):] == 0).all(-1)
    if rem:
        ok = ok & (v[..., full] < (1 << rem))
    return ok


def limb_from_i32(x, shape_like=None):
    """Small non-negative int32 scalar -> limb scalar (for mixed compares);
    as pob_tpu's, the value is taken as uint32."""
    return limb.small_to_limbs(torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF)


def divide(a, b_static: int):
    """Divide (divide.circom:17-33) with a static divisor: floor div + rem."""
    a = torch.as_tensor(a).to(I32)
    return a // b_static, a % b_static
