"""K5: the conditional-add sweep of the planned witness MSMs
(``csrc/bitsum.cuh``, built as ``bitsum_g1.cu`` / ``bitsum_g2.cu``), and its
plain PyTorch version.

A group's plan (``groth16.PlanGroup``) holds, per query q, M packed affine
points [bit points | (0, 0) up to mb | the 254 doublings 2^k P_j of each
full wire j, wire-major | (0, 0) up to M], the wires they stand for
(``bit_idx`` (q, mb), ``full_idx`` (q, mf), absolute) and the true counts
(q, 2) = (n_bit, n_full). The sum of query q for proof b is the sum of the
points whose bit is set: W[b, bit_idx[q, p], 0] & 1 for p < n_bit, and bit
k of W[b, full_idx[q, j]] at position mb + 254 j + k for j < n_full. That
is sum_i w_i P_i over the query's live wires, since bit wires hold 0 or 1
and a full wire's value is the sum of its bits times powers of two.

``bitsum_msm`` takes the plain version for CPU tensors only and launches the
kernel for CUDA tensors."""

from __future__ import annotations

import torch

from .. import _build
from ..field import limb
from . import curve, msm

FULL_BITS = 254  # witness values are field elements < 2^254
SWEEP_WAVES = 4  # K5's sweep grid: about this many waves of the card's resident warps
MIN_RUN = 1024  # fewest positions a sweep warp takes

_SRC = {"g1": "bitsum_g1.cu", "g2": "bitsum_g2.cu"}


def plan_bits(M: int, bit_idx, full_idx, counts, W):
    """(q, B, M) uint8 bits of every plan position (0 at the padding), from
    the witnesses W (B, nw, 16)."""
    q, mb = bit_idx.shape
    mf = full_idx.shape[1]
    dev = W.device
    nb, nf = counts[:, 0].to(dev), counts[:, 1].to(dev)
    bits_b = (W[:, bit_idx.long(), 0] & 1).to(torch.uint8)  # (B, q, mb)
    bits_b *= torch.arange(mb, device=dev) < nb[:, None]
    k = torch.arange(FULL_BITS, device=dev)
    full = W[:, full_idx.long()]  # (B, q, mf, 16)
    bits_f = ((full[..., k >> 4] >> (k & 15).to(torch.int32)) & 1).to(torch.uint8)
    bits_f *= (torch.arange(mf, device=dev) < nf[:, None])[..., None]
    B = W.shape[0]
    pad = torch.zeros((B, q, M - mb - mf * FULL_BITS), dtype=torch.uint8, device=dev)
    return torch.cat([bits_b, bits_f.reshape(B, q, -1), pad], -1).transpose(0, 1)


def bitsum_plain(group: str, pts, bit_idx, full_idx, counts, W):
    """Plain K5: gather the bits (plan_bits), select the finite points whose
    bit is set, and add them per (query, proof) with msm.segment_sum.
    Returns (q, B) Jacobian points."""
    ops = curve.ops_for(group)
    q, M = pts.shape[:2]
    B = W.shape[0]
    live = (pts != 0).any(-1)  # (q, M): (0, 0) adds nothing
    take = plan_bits(M, bit_idx, full_idx, counts, W).bool() & live[:, None]
    qi, b, p = take.nonzero(as_tuple=True)  # sorted by (qi, b, p)
    keys, pj = msm.segment_sum(ops, qi * B + b, msm.packed_to_jacobian(group, pts[qi, p]))
    out = msm._scatter(ops, q * B, keys, pj, W.device)
    return tuple(c.reshape((q, B) + c.shape[1:]) for c in out)


def bitsum_msm(group: str, pts, bit_idx, full_idx, counts, W, timing=None):
    """Sums of a group's planned witness MSMs: pts (q, M, 16 | 32) packed
    affine, bit_idx (q, mb), full_idx (q, mf), counts (q, 2) int32, W (B,
    nw, 16) canonical limbs -> (q, B) Jacobian points. On the card, a list
    given as `timing` gets one (label, start, end) CUDA-event triple per
    launch."""
    if not W.is_cuda:
        return bitsum_plain(group, pts, bit_idx, full_idx, counts, W)
    return bitsum_cuda(group, pts, bit_idx, full_idx, counts, W, timing)


def sweep_run(q: int, B: int, M: int, warps_per_sm: int, sms: int) -> int:
    """Positions per warp of K5's sweep (a multiple of 32): the q B M
    positions spread over about SWEEP_WAVES waves of the card's resident
    warps, and at least MIN_RUN, so that a warp's closing 5-level tree of
    full adds stays a small share of its run."""
    per_warp = -(-q * B * M // (SWEEP_WAVES * warps_per_sm * sms))
    return max(MIN_RUN, -(-per_warp // 32) * 32)


def bitsum_cuda(group: str, pts, bit_idx, full_idx, counts, W, timing=None):
    """K5's two launches: the sweep (a warp per run of sweep_run positions
    of one (query, proof), a packed Jacobian partial per run) and the reduce
    (a block per (query, proof)). Every buffer is sized from B, M and the
    card; nothing is read back to the host."""
    W = W.contiguous()
    _build.check_cuda(pts, bit_idx, full_idx, counts, W)
    width = msm._bases_width(group)
    if pts.dim() != 3 or pts.shape[2] != width:
        raise ValueError(f"pts must be (q, M, {width}), got {tuple(pts.shape)}")
    q, M = pts.shape[:2]
    if (bit_idx.dim(), full_idx.dim(), tuple(counts.shape)) != (2, 2, (q, 2)) or \
            bit_idx.shape[0] != q or full_idx.shape[0] != q:
        raise ValueError("bit_idx, full_idx and counts must have the plan's q rows")
    mb, mf = bit_idx.shape[1], full_idx.shape[1]
    if mb + mf * FULL_BITS > M or M >= 1 << 31:
        raise ValueError(f"M = {M} must be at least mb + 254 mf = {mb + mf * FULL_BITS} "
                         "and below 2^31")
    if W.dim() != 3 or W.shape[2] != limb.L:
        raise ValueError(f"W must be (B, nw, 16), got {tuple(W.shape)}")
    B, nw = W.shape[:2]
    out = msm._empty_points(group, q * B, W.device)
    if q * B == 0:
        return tuple(c.reshape((q, B) + c.shape[1:]) for c in out)
    lib = _build.lib(_SRC[group])
    run = sweep_run(q, B, M, lib.pob_bitsum_warps_per_sm(),
                    torch.cuda.get_device_properties(W.device).multi_processor_count)
    runs = -(-M // run)
    part = torch.empty((q, B, runs, 3 * width // 2), dtype=torch.int32, device=W.device)
    stream = _build.stream_ptr(W)
    key = f"bitsum_{group}"
    msm._launch(timing, "sweep", lib.pob_bitsum_sweep, pts.data_ptr(), bit_idx.data_ptr(),
                full_idx.data_ptr(), counts.data_ptr(), W.data_ptr(), B, nw, q, M, mb, mf,
                run, part.data_ptr(), stream, key=key)
    msm._launch(timing, "reduce", lib.pob_bitsum_reduce, part.data_ptr(), q * B, runs,
                *msm._ptrs(out), stream, key=key)
    return tuple(c.reshape((q, B) + c.shape[1:]) for c in out)
