"""Batched Keccak-f[1600] on tensors.

State: 25 64-bit lanes held as two planes of 32-bit halves (lo, hi), shape
(..., 25), stored in int64 tensors (PyTorch has no uint32 arithmetic on the
CPU). Every result is masked back to 32 bits, so values equal the JAX
package's uint32 lanes. One hash instance per batch lane."""

from __future__ import annotations

import numpy as np
import torch

RATE = 136  # bytes per block (keccak256: rate 1088, capacity 512)
M32 = 0xFFFFFFFF

# Per-output-lane (rho+pi) source index and rotation: B[y + 5((2x+3y)%5)] =
# rotl(A[x + 5y], R[x][y]).
_ROTC = np.array(
    [
        [0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14],
    ]
)
_SRC = np.zeros(25, np.int32)
_ROT = np.zeros(25, np.int32)
for _x in range(5):
    for _y in range(5):
        _SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROTC[_x][_y]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_RC_LO = np.array([rc & M32 for rc in _RC], np.int64)
_RC_HI = np.array([rc >> 32 for rc in _RC], np.int64)

# chi neighbor indices: out[i] = b[i] ^ (~b[n1[i]] & b[n2[i]])
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)], np.int32)
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)], np.int32)


def _idx(a, like):
    return torch.as_tensor(np.asarray(a, np.int64), device=like.device)


def _rotl64(lo, hi, r):
    """Rotate-left 64-bit lanes (lo, hi) by per-lane amounts r (int or a
    broadcastable array)."""
    r = torch.as_tensor(np.asarray(r, np.int64), device=lo.device)
    swap = r >= 32
    lo2 = torch.where(swap, hi, lo)
    hi2 = torch.where(swap, lo, hi)
    rr = torch.where(swap, r - 32, r)  # 0..31; x >> 32 is 0 for 32-bit x
    nlo = ((lo2 << rr) & M32) | (hi2 >> (32 - rr))
    nhi = ((hi2 << rr) & M32) | (lo2 >> (32 - rr))
    return nlo, nhi


def _not32(x):
    return x ^ M32


def _round(lo, hi, r: int):
    c_lo = lo[..., 0:5] ^ lo[..., 5:10] ^ lo[..., 10:15] ^ lo[..., 15:20] ^ lo[..., 20:25]
    c_hi = hi[..., 0:5] ^ hi[..., 5:10] ^ hi[..., 10:15] ^ hi[..., 15:20] ^ hi[..., 20:25]
    rot_lo, rot_hi = _rotl64(c_lo.roll(-1, -1), c_hi.roll(-1, -1), 1)
    d_lo = (c_lo.roll(1, -1) ^ rot_lo).tile(5)
    d_hi = (c_hi.roll(1, -1) ^ rot_hi).tile(5)
    lo, hi = lo ^ d_lo, hi ^ d_hi
    src = _idx(_SRC, lo)
    b_lo, b_hi = _rotl64(lo[..., src], hi[..., src], _ROT)
    c1, c2 = _idx(_CHI1, lo), _idx(_CHI2, lo)
    lo = b_lo ^ (_not32(b_lo[..., c1]) & b_lo[..., c2])
    hi = b_hi ^ (_not32(b_hi[..., c1]) & b_hi[..., c2])
    lo = torch.cat([lo[..., :1] ^ int(_RC_LO[r]), lo[..., 1:]], -1)
    hi = torch.cat([hi[..., :1] ^ int(_RC_HI[r]), hi[..., 1:]], -1)
    return lo, hi


def keccak_f(lo, hi):
    """Keccak-f[1600] on (..., 25) lane planes (int64 holding 32-bit halves)."""
    for r in range(24):
        lo, hi = _round(lo, hi, r)
    return lo, hi


def bytes_to_blocks(padded, max_blocks: int):
    """(..., max_blocks*136) bytes -> lo/hi lane planes (..., max_blocks, 17)."""
    b = padded.to(torch.int64).reshape(padded.shape[:-1] + (max_blocks, 17, 8))
    lo = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    hi = b[..., 4] | (b[..., 5] << 8) | (b[..., 6] << 16) | (b[..., 7] << 24)
    return lo, hi


def state_to_digest(lo, hi):
    """First 4 lanes of the state -> (..., 32) int32 digest bytes."""
    lanes_lo, lanes_hi = lo[..., :4], hi[..., :4]
    parts = [(lanes_lo >> s) & 0xFF for s in (0, 8, 16, 24)]
    parts += [(lanes_hi >> s) & 0xFF for s in (0, 8, 16, 24)]
    bytes_ = torch.stack(parts, -1)  # (..., 4, 8)
    return bytes_.reshape(bytes_.shape[:-2] + (32,)).to(torch.int32)


def pad_bytes(data, in_len, max_blocks: int):
    """Reference `Pad` semantics (keccak.circom:412-446): keep the first
    in_len bytes, add 0x01 at position in_len and 0x80 at the last byte of
    block num_blocks (0x81 when they coincide).

    data: (..., max_blocks*136) int32 bytes; in_len: (...,) int tensor.
    Returns (padded int32, num_blocks)."""
    idx = torch.arange(max_blocks * RATE, device=data.device)
    in_len = in_len.to(torch.int64)[..., None]
    num_blocks = in_len // RATE + 1
    padded = (data * (idx < in_len) + 0x01 * (idx == in_len)
              + 0x80 * (idx == num_blocks * RATE - 1))
    return padded.to(torch.int32), num_blocks[..., 0].to(torch.int32)


def keccak_bytes(data, in_len, max_blocks: int, return_states: bool = False):
    """Keccak256 of dynamic-length byte arrays (reference `KeccakBytes`,
    keccak.circom:454-489). data: (..., max_blocks*136) int32 bytes; in_len:
    (...,) with in_len < max_blocks*136 (callers check, as the circuit
    asserts at keccak.circom:460). Returns (..., 32) int32 digest bytes.

    Computes all max_blocks absorptions and selects the state after
    num_blocks, the compute-all-then-select pattern of `Final`
    (keccak.circom:330-349)."""
    padded, num_blocks = pad_bytes(data, in_len, max_blocks)
    blk_lo, blk_hi = bytes_to_blocks(padded, max_blocks)  # (..., max_blocks, 17)
    lo = torch.zeros(padded.shape[:-1] + (25,), dtype=torch.int64, device=padded.device)
    hi = torch.zeros_like(lo)
    states_lo, states_hi = [], []  # the state after each absorption
    for b in range(max_blocks):
        lo = torch.cat([lo[..., :17] ^ blk_lo[..., b, :], lo[..., 17:]], -1)
        hi = torch.cat([hi[..., :17] ^ blk_hi[..., b, :], hi[..., 17:]], -1)
        lo, hi = keccak_f(lo, hi)
        states_lo.append(lo)
        states_hi.append(hi)
    states_lo, states_hi = torch.stack(states_lo), torch.stack(states_hi)
    sel = torch.nn.functional.one_hot((num_blocks - 1).long(), max_blocks).movedim(-1, 0)
    fin_lo = (states_lo * sel[..., None]).sum(0)
    fin_hi = (states_hi * sel[..., None]).sum(0)
    digest = state_to_digest(fin_lo, fin_hi)
    if return_states:
        return digest, (states_lo, states_hi)
    return digest


def keccak_fixed(data):
    """Keccak256 of a fixed-length byte array (..., n), n known statically."""
    n = data.shape[-1]
    max_blocks = n // RATE + 1
    buf = torch.nn.functional.pad(data.to(torch.int32), (0, max_blocks * RATE - n))
    in_len = torch.full(data.shape[:-1], n, dtype=torch.int32, device=data.device)
    return keccak_bytes(buf, in_len, max_blocks)
