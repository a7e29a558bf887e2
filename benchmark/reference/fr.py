"""Arithmetic modulo BN254's scalar prime r in plain PyTorch, for the
benchmark's reference.

A value is a (..., 16) int64 tensor of 16-bit limbs, little-endian, below r.
Products are Montgomery products with R = 2^256 (mont_mul(a, b) = a b / R),
done as a schoolbook product and a limb-by-limb reduction, each a few dozen
element-wise torch operations: no kernel and no code of the program, so the
same functions run on the CPU in the tests and on the card after a run.
Long vectors go CHUNK rows at a time, which bounds the int64 temporaries."""

from __future__ import annotations

import numpy as np
import torch

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
L = 16
MASK = 0xFFFF
MONT_R = (1 << 256) % R_MOD
N0 = (-pow(R_MOD, -1, 1 << 16)) % (1 << 16)  # -r^-1 mod 2^16
CHUNK = 1 << 20  # rows per step of the element-wise functions


def to_limbs(xs) -> np.ndarray:
    """Python ints (reduced mod r) -> (n, 16) int64 limbs."""
    raw = b"".join((int(x) % R_MOD).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, "<u2").reshape(-1, L).astype(np.int64)


def from_limbs(t) -> list:
    """(n, 16) canonical limbs (tensor or array) -> python ints."""
    a = np.ascontiguousarray(torch.as_tensor(t).cpu().numpy().astype("<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in a.reshape(-1, L)]


def const(x: int, device) -> torch.Tensor:
    return torch.from_numpy(to_limbs([x])).to(device)


def _p(device) -> torch.Tensor:
    raw = R_MOD.to_bytes(32, "little")
    return torch.from_numpy(np.frombuffer(raw, "<u2").astype(np.int64)).to(device)


def _chunked(fn, *args):
    """fn over row chunks of (n, 16) arguments (a (1, 16) argument broadcasts)."""
    n = max(a.shape[0] for a in args)
    if n <= CHUNK:
        return fn(*args)
    out = torch.empty(n, L, dtype=torch.int64, device=args[0].device)
    for o in range(0, n, CHUNK):
        out[o:o + CHUNK] = fn(*(a if a.shape[0] == 1 else a[o:o + CHUNK] for a in args))
    return out


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries in place over the last axis (nonnegative limbs)."""
    for k in range(t.shape[1] - 1):
        t[:, k + 1] += t[:, k] >> 16
        t[:, k] &= MASK
    return t


def _reduce_once(t: torch.Tensor) -> torch.Tensor:
    """t (n, 16) normalized limbs of a value below 2r -> the value mod r."""
    d = t - _p(t.device)
    for k in range(L - 1):
        borrow = (d[:, k] < 0).to(torch.int64)
        d[:, k] += borrow << 16
        d[:, k + 1] -= borrow
    return torch.where((d[:, L - 1] < 0)[:, None], t, d)


def redc(t: torch.Tensor) -> torch.Tensor:
    """t (n, w <= 33) nonnegative int64 columns of a value T < r R, each
    column below 2^40 -> T / R mod r, canonical."""
    n = t.shape[0]
    w = torch.zeros(n, 2 * L + 1, dtype=torch.int64, device=t.device)
    w[:, :t.shape[1]] = t
    p = _p(t.device)
    for i in range(L):
        m = ((w[:, i] & MASK) * N0) & MASK
        w[:, i:i + L] += m[:, None] * p
        w[:, i + 1] += w[:, i] >> 16
    return _reduce_once(_carry(w[:, L:].clone())[:, :L])


def _mont_mul(a, b):
    n = max(a.shape[0], b.shape[0])
    t = torch.zeros(n, 2 * L, dtype=torch.int64, device=a.device)
    for i in range(L):
        t[:, i:i + L] += a[:, i:i + 1] * b
    return redc(t)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b / R mod r for (n, 16) or (1, 16) canonical limbs."""
    return _chunked(_mont_mul, a, b)


def _add(a, b):
    t = torch.zeros(max(a.shape[0], b.shape[0]), L + 1, dtype=torch.int64, device=a.device)
    t[:, :L] = a + b
    return _reduce_once(_carry(t)[:, :L])


def add(a, b):
    return _chunked(_add, a, b)


def _neg(b):
    d = _p(b.device) - b
    for k in range(L - 1):
        borrow = (d[:, k] < 0).to(torch.int64)
        d[:, k] += borrow << 16
        d[:, k + 1] -= borrow
    return torch.where((b == 0).all(1, keepdim=True), b, d)


def sub(a, b):
    return _chunked(lambda x, y: _add(x, _neg(y)), a, b)


def to_mont(a):
    return mont_mul(a, const(MONT_R * MONT_R % R_MOD, a.device))


def from_mont(a):
    return mont_mul(a, const(1, a.device))


def powers_mont(base: int, n: int, device) -> torch.Tensor:
    """base^0 .. base^(n-1), Montgomery form, by doubling the prefix."""
    out = const(MONT_R, device)
    while out.shape[0] < n:
        step = const(pow(base, out.shape[0], R_MOD) * MONT_R % R_MOD, device)
        out = torch.cat([out, mont_mul(out, step)])
    return out[:n]


def batch_inv_mont(x: torch.Tensor, cols: int = 256) -> torch.Tensor:
    """Inverses of nonzero Montgomery-form values x (n, 16), Montgomery form.
    Montgomery's trick in two levels: running products along rows of `cols`
    values on the device, the row products inverted with python ints."""
    n = x.shape[0]
    cols = min(cols, n)
    rows = -(-n // cols)
    pad = rows * cols - n
    if pad:
        x = torch.cat([x, const(MONT_R, x.device).expand(pad, L)])
    xs = x.reshape(rows, cols, L)
    pre = torch.empty_like(xs)
    pre[:, 0] = xs[:, 0]
    for k in range(1, cols):
        pre[:, k] = mont_mul(pre[:, k - 1], xs[:, k])
    # row totals: value tR (Montgomery form of t) -> (t^-1) R
    tot = [v * pow(MONT_R, -1, R_MOD) % R_MOD for v in from_limbs(pre[:, cols - 1])]
    inv = _batch_inv_ints(tot)
    acc = torch.from_numpy(to_limbs([v * MONT_R % R_MOD for v in inv])).to(x.device)
    out = torch.empty_like(xs)
    for k in range(cols - 1, 0, -1):
        out[:, k] = mont_mul(acc, pre[:, k - 1])
        acc = mont_mul(acc, xs[:, k])
    out[:, 0] = acc
    return out.reshape(rows * cols, L)[:n]


def _batch_inv_ints(xs: list) -> list:
    prefix = [1]
    for v in xs:
        prefix.append(prefix[-1] * v % R_MOD)
    acc = pow(prefix[-1], -1, R_MOD)
    out = [0] * len(xs)
    for j in range(len(xs) - 1, -1, -1):
        out[j] = acc * prefix[j] % R_MOD
        acc = acc * xs[j] % R_MOD
    return out


def dot_many(w: torch.Tensor, vecs: torch.Tensor, rows: int = 1 << 22) -> list:
    """sum_i w[b, i] vecs[i, q] mod r for every b and q, exactly.

    w: (B, n, 16) 16-bit limbs (any int dtype); vecs: (n, Q, 16) canonical
    limbs. Both are split into 8-bit limbs and multiplied as float64
    matrices: each product of two limbs is below 2^16, and a sum over n <
    2^37 / 255^2 terms stays below 2^53, so every float64 sum is exact.
    Returns B lists of Q python ints."""
    B, n, _ = w.shape
    Q = vecs.shape[1]
    if n * 255 * 255 >= 1 << 53:
        raise ValueError("too many terms for an exact float64 sum")
    acc = torch.zeros(B * 32, Q * 32, dtype=torch.float64, device=w.device)
    for o in range(0, n, rows):
        w8 = _bytes(w[:, o:o + rows].to(torch.int64))  # (B, c, 32)
        v8 = _bytes(vecs[o:o + rows])  # (c, Q, 32)
        c = w8.shape[1]
        acc += w8.permute(0, 2, 1).reshape(B * 32, c).to(torch.float64) @ v8.reshape(
            c, Q * 32).to(torch.float64)
    m = acc.reshape(B, 32, Q, 32).cpu().numpy()
    out = []
    for b in range(B):
        row = []
        for q in range(Q):
            s = 0
            for i in range(32):
                for j in range(32):
                    s += int(m[b, i, q, j]) << (8 * (i + j))
            row.append(s % R_MOD)
        out.append(row)
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """(..., 16) 16-bit limbs -> (..., 32) 8-bit limbs."""
    return torch.stack([t & 0xFF, (t >> 8) & 0xFF], -1).flatten(-2)
