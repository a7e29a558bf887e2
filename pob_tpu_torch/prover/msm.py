"""Multi-scalar multiplication on tensors: variable-base Pippenger (K3),
fixed-base scalar multiplication for the trusted setup (K4), and the
shifted affine points of K3's bases and of the witness-MSM plan (K6).

Each kernel has its plain PyTorch version here; the wrappers take the plain
version for CPU tensors only and launch the kernel for CUDA tensors.

- K3 ``msm_batched`` (``csrc/msm.cuh``): out[b] = sum_i s[b, i] P[i] with
  8-bit digits, by the bucket method over the key's shifted bases
  2^(8w) P_i, w < S (``affine_bases``): 32 / S passes of 255 buckets per
  proof, folded with 8 S doublings between passes (none at S = 32, the
  key's default). Plain version ``msm_plain``: buckets per (proof, window, digit)
  summed by sort and pairwise adds (``segment_sum``), then per bit
  position and a binary-tree Horner.
- K6 ``affine_bases`` (``csrc/msm.cuh``'s shifted-bases kernel): packed
  affine 2^(dbl w) P_i for w < windows, window- or wire-major: K3's bases
  (32, 8), the witness-MSM plan's doubling chains (254, 1), a plain
  conversion to affine (1, 0). Plain version ``affine_bases_plain``.
- K4 ``fixed_base_msm`` (``csrc/fixed_base.cu``): k_i G for every scalar,
  by mixed adds from the window table T[w][v] = v 2^(8w) G, kept as packed
  affine points (``window_table``, built on the card from the doublings
  2^j G). Plain versions: ``fixed_base_plain``, the table entries the
  digits use, each summed from the plain doublings 2^e G, then summed per
  scalar by ``segment_sum``; ``fixed_base_table_plain`` for the table.

msm_plain and fixed_base_plain do work in proportion to the nonzero digits,
so they can check the kernels at the main path's sizes."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ..field import limb
from ..field.ref import FQ_MOD, G1_GEN, G2_GEN
from . import curve

WINDOW_BITS = 8
N_WINDOWS = 256 // WINDOW_BITS
N_BUCKETS = 1 << WINDOW_BITS
SEG0 = 32  # most points one K3 thread sums at the first bucket-sum level
SEG = 8  # most partials one K3 thread sums at each later level
HIST_CHUNK = 256  # scalars per hist / scatter block (HT in csrc/msm.cuh)
K3_MAX_DIGITS = (1 << 31) - 1  # K3 indexes a call's B m 32 sorted digits with int32
WINDOW_COUNTS = (32, 16, 8, 4, 2, 1)  # the shifted windows S K3's bases may hold: divisors of 32

_GROUP_ID = {"g1": 0, "g2": 1}
_MSM_SRC = {"g1": "msm_g1.cu", "g2": "msm_g2.cu"}


def scalar_digits(scalars):
    """(..., 16) canonical limbs -> (..., 32) base-256 window digits."""
    lo, hi = scalars & 0xFF, (scalars >> 8) & 0xFF
    return torch.stack([lo, hi], -1).reshape(scalars.shape[:-1] + (N_WINDOWS,))


def _coord_shape(group: str):
    return curve.ops_for(group).coord_shape


def _empty_points(group: str, n: int, device):
    shape = (n,) + _coord_shape(group)
    return tuple(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(3))


def _check_points(group: str, points):
    _build.check_cuda(*points)
    m = points[0].shape[0]
    for c in points:
        if tuple(c.shape) != (m,) + _coord_shape(group):
            raise ValueError(f"bad {group} point shape {tuple(c.shape)}")
    return m


def _ptrs(points):
    return [c.data_ptr() for c in points]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


ADD_CHUNK = 1 << 19  # most point pairs in one plain point_add (bounds its int64 temporaries)


def _add_chunked(ops, p, q):
    n = p[0].shape[0]
    parts = [curve.point_add(ops, tuple(c[i:i + ADD_CHUNK] for c in p),
                             tuple(c[i:i + ADD_CHUNK] for c in q))
             for i in range(0, n, ADD_CHUNK)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(cs, 0) for cs in zip(*parts))


def segment_sum(ops, keys, points):
    """Sum the points that share a key. keys: (n,) int64, sorted; points:
    (n,) Jacobian. Returns (unique keys, their (k,) Jacobian sums). Each level
    adds the even-placed point of every run of equal keys to its right
    neighbour, so log2 of the longest run levels suffice, each one batched
    point_add over about half of what is left."""
    while keys.numel() > 1:
        n = keys.numel()
        pos = torch.arange(n, device=keys.device)
        head = torch.ones(n + 1, dtype=torch.bool, device=keys.device)
        head[1:n] = keys[1:] != keys[:-1]
        if bool(head.all()):
            break
        run_pos = pos - torch.cummax(torch.where(head[:n], pos, 0), 0).values
        left = pos[run_pos % 2 == 0]
        paired = ~head[left + 1]
        a = left[paired]
        sums = _add_chunked(ops, tuple(c[a] for c in points), tuple(c[a + 1] for c in points))
        points = tuple(c[left] for c in points)
        at = paired.nonzero().squeeze(1)
        for c, s in zip(points, sums):
            c[at] = s
        keys = keys[left]
    return keys, points


def _scatter(ops, n: int, keys, points, device):
    """(n,) Jacobian: points at keys, infinity elsewhere."""
    out = curve.infinity(ops, (n,), device)
    for c, p in zip(out, points):
        c[keys] = p
    return out


def horner_bits(ops, v):
    """sum_e 2^e V[..., e] for V with a power of two of points on axis 1
    (point tensors (B, 2^t, ...)): a binary tree of lo + 2^s hi, s = 1, 2,
    4, ..., 2^(t-1)."""
    s = 1
    while v[0].shape[1] > 1:
        lo = tuple(c[:, 0::2] for c in v)
        hi = curve.times_pow2(ops, tuple(c[:, 1::2] for c in v), s)
        v = curve.point_add(ops, lo, hi)
        s *= 2
    return tuple(c[:, 0] for c in v)


def msm_plain(ops, points, scalars):
    """Plain K3, the bucket method in PyTorch ops. points: (m, ...) Jacobian;
    scalars: (B, m, 16) canonical. Every nonzero window digit d of s[b, i]
    puts P_i into bucket (b, w, d), and segment_sum adds each bucket. Bucket
    (b, w, d) then counts once at bit position 8w + j for every set bit j of
    d; segment_sum adds those into (B, 256) bit sums, and horner_bits folds
    them, over the bit positions below the next power of two above the
    highest one any proof uses (small scalars need fewer doublings).
    Returns (B,) Jacobian sums."""
    B = scalars.shape[0]
    dev = scalars.device
    dig = scalar_digits(scalars).long()  # (B, m, 32)
    b, i, w = dig.nonzero(as_tuple=True)
    key, order = torch.sort((b * N_WINDOWS + w) * N_BUCKETS + dig[b, i, w], stable=True)
    i = i[order]
    bkey, bsum = segment_sum(ops, key, tuple(c[i] for c in points))
    bits = (bkey[:, None] >> torch.arange(WINDOW_BITS, device=dev)) & 1
    k, j = bits.nonzero(as_tuple=True)
    key, order = torch.sort((bkey[k] >> WINDOW_BITS) * WINDOW_BITS + j, stable=True)
    k = k[order]
    ekey, esum = segment_sum(ops, key, tuple(c[k] for c in bsum))
    e = ekey % 256
    nbits = 1 << int(e.max()).bit_length() if e.numel() else 1
    per_bit = _scatter(ops, B * nbits, ekey // 256 * nbits + e, esum, dev)
    return horner_bits(ops, tuple(c.reshape((B, nbits) + c.shape[1:]) for c in per_bit))


@functools.lru_cache(maxsize=8)
def _doublings(group: str, device: str):
    """(256, ...) Jacobian 2^e G, e < 256, by sequential plain doublings."""
    ops = curve.ops_for(group)
    gen = G1_GEN if group == "g1" else G2_GEN
    p = curve.points_to_device(group, [gen], device)
    out = [p]
    for _ in range(255):
        p = curve.point_double(ops, p)
        out.append(p)
    return tuple(torch.cat([q[c] for q in out], 0) for c in range(3))


def fixed_base_plain(group: str, scalars):
    """Plain K4: (m, 16) canonical scalars -> (m,) Jacobian k_i G, the sum
    over the nonzero window digits d_w of k_i of the table entries
    d_w 2^(8w) G. Only the entries the digits use are formed, each as the
    sum of the doublings 2^(8w + j) G over the set bits j of d_w; both sums
    go through segment_sum."""
    ops = curve.ops_for(group)
    dev = scalars.device
    dbl = _doublings(group, str(dev))
    dig = scalar_digits(scalars).long()  # (m, 32)
    i, w = dig.nonzero(as_tuple=True)  # sorted by i
    used, entry = torch.unique(w * N_BUCKETS + dig[i, w], return_inverse=True)
    bits = (used[:, None] >> torch.arange(WINDOW_BITS, device=dev)) & 1
    k, j = bits.nonzero(as_tuple=True)  # sorted by k; every used entry has a set bit
    e = (used[k] >> WINDOW_BITS) * WINDOW_BITS + j
    _, table = segment_sum(ops, k, tuple(c[e] for c in dbl))
    key, sums = segment_sum(ops, i, tuple(c[entry] for c in table))
    return _scatter(ops, scalars.shape[0], key, sums, dev)


# ---------------------------------------------------------------------------
# K3: batched Pippenger on the card
# ---------------------------------------------------------------------------


def level_segs(n: int) -> list:
    """Segment length of each bucket-sum level: SEG0 entries at level 0, then
    SEG partials, until one partial covers a bucket of n entries (K3 passes
    the most a bucket can hold: 32 m, one entry per point and window)."""
    segs = [SEG0]
    while math.prod(segs) < n:
        segs.append(SEG)
    return segs


def level_caps(B: int, m: int, segs, passes: int = 1) -> list:
    """Most items each level can have, from B, m and the passes alone: B m
    32 digits at level 0; a level of n items in k buckets (B passes 256) has
    at most n // s + 1 + k segments of s, and never more than n. These size
    K3's scratch and grids, so no count is read back from the card."""
    n_keys = B * passes * N_BUCKETS
    caps = [B * m * N_WINDOWS]
    for s in segs:
        caps.append(min(caps[-1], caps[-1] // s + 1 + n_keys))
    return caps


def k3_scratch_bytes(B: int, m: int) -> int:
    """Device bytes of one G1 K3 call's scratch over bases of 32 windows
    (pippenger_cuda): the counts, the block histograms, the sorted digits
    and every level's partials. Fewer windows add 256 keys a pass, some
    kilobytes."""
    segs = level_segs(N_WINDOWS * m)
    caps = level_caps(B, m, segs)
    n_keys = B * N_BUCKETS
    pw = 3 * _bases_width("g1") // 2
    return 4 * (2 * n_keys + B * -(-m // HIST_CHUNK) * N_BUCKETS + caps[0]
                + (len(segs) + 1) * (n_keys + 1) + pw * sum(caps[1:]))


def segment_layout_plain(counts, segs):
    """Plain version of K3's layout kernel: counts (n_keys,) -> (len(segs) +
    1, n_keys + 1) int32 P with P[l, k] = sum_{k' < k} ceil(counts[k'] / D_l),
    D_l the product of segs[:l], and the total in the last column."""
    c = counts.long()
    rows, d = [], 1
    for l in range(len(segs) + 1):
        v = (c + d - 1) // d
        rows.append(torch.cat([v.new_zeros(1), torch.cumsum(v, 0)]))
        if l < len(segs):
            d *= segs[l]
    return torch.stack(rows).to(torch.int32)


def pack_words(limbs):
    """(..., 2n) 16-bit limbs -> (..., n) int32 words of 32 bits (K3's packed
    layout; the bit pattern of each word, so words >= 2^31 read negative)."""
    w = limbs[..., 0::2].long() | (limbs[..., 1::2].long() << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _fq_inv_plain(a):
    """a^-1 for every element of a (..., 16), Montgomery form in and out; 0
    maps to 0. Montgomery's trick over a product tree: pairwise products up
    to one root, one square-and-multiply root^(q-2), and the inverses back
    down (a zero stands in as one, then gives 0)."""
    shape = a.shape
    a = a.reshape(-1, limb.L)
    zero = (a == 0).all(-1, keepdim=True)
    one = torch.from_numpy(limb.int_to_limbs((1 << 256) % FQ_MOD)).to(a.device)
    top, levels = torch.where(zero, one, a), []
    while top.shape[0] > 1:
        if top.shape[0] % 2:
            top = torch.cat([top, one[None]], 0)
        levels.append(top)
        top = limb.mont_mul_plain(limb.FQ, top[0::2], top[1::2])
    e = FQ_MOD - 2
    inv = top
    for bit in range(e.bit_length() - 2, -1, -1):
        inv = limb.mont_mul_plain(limb.FQ, inv, inv)
        if (e >> bit) & 1:
            inv = limb.mont_mul_plain(limb.FQ, inv, top)
    for lv in reversed(levels):  # 1 / x_j = (1 / (x_j x_sibling)) x_sibling
        sibling = lv.reshape(-1, 2, limb.L).flip(1).reshape(-1, limb.L)
        inv = limb.mont_mul_plain(limb.FQ, inv[:lv.shape[0] // 2].repeat_interleave(2, 0),
                                  sibling)
    inv = inv[:a.shape[0]]
    return torch.where(zero, torch.zeros_like(inv), inv).reshape(shape)


def _coord_inv_plain(group: str, a):
    if group == "g1":
        return _fq_inv_plain(a)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    n = _fq_inv_plain(limb.add_plain(limb.FQ, limb.mont_mul_plain(limb.FQ, a0, a0),
                                     limb.mont_mul_plain(limb.FQ, a1, a1)))
    c1 = limb.mont_mul_plain(limb.FQ, a1, n)
    return torch.stack([limb.mont_mul_plain(limb.FQ, a0, n),
                        limb.sub_plain(limb.FQ, torch.zeros_like(c1), c1)], -2)


def affine_bases_plain(group: str, points, windows: int = N_WINDOWS, dbl: int = WINDOW_BITS,
                       wire_major: bool = False):
    """Plain version of K6 (the shifted-bases kernel): (m,) Jacobian points
    P_i -> (windows m, 16) (G1) or (windows m, 32) (G2) int32, the packed
    words of x then y of 2^(dbl w) P_i, affine, Montgomery form, at row
    w m + i (window-major; K3's bases: 32 windows of 8 doublings) or
    i windows + w (wire-major; the plan's chains: 254 windows of 1);
    infinity gives (0, 0), since the inverse of Z = 0 is 0."""
    ops = curve.ops_for(group)
    shifted = [points]
    for _ in range(windows - 1):
        shifted.append(curve.times_pow2(ops, shifted[-1], dbl))
    axis = 1 if wire_major else 0
    return _packed_affine(group, tuple(torch.stack(cs, axis).flatten(0, 1)
                                       for cs in zip(*shifted)))


def _packed_affine(group: str, points):
    """(n,) Jacobian -> (n, 16) (G1) or (n, 32) (G2) int32: the packed words
    of x then y, affine, Montgomery form; infinity gives (0, 0), since the
    inverse of Z = 0 is 0."""
    ops = curve.ops_for(group)
    x, y, z = points
    zi = _coord_inv_plain(group, z)
    zi2 = ops.sqr(zi)
    ax, ay = ops.mul(x, zi2), ops.mul(y, ops.mul(zi2, zi))
    return pack_words(torch.cat([ax.flatten(1), ay.flatten(1)], -1))


K6_SCRATCH_BYTES = 3 << 28  # most bytes of Z scratch one K6 launch takes (768 MiB)


def affine_bases(group: str, points, windows: int = N_WINDOWS, dbl: int = WINDOW_BITS,
                 wire_major: bool = False):
    """K6: affine_bases_plain's table on the card, one thread and one
    inversion per point (Montgomery's trick over its windows; csrc/msm.cuh).
    With the defaults, the table K3 adds from (2^(8w) P_i for every window
    w; made once per key, ``ProvingKey.bases``); with (254, 1, wire_major)
    the doubling chains of the witness-MSM plan; with (1, 0) a conversion
    to packed affine. The points go as many to a launch as a scratch of
    K6_SCRATCH_BYTES holds the Z of all their windows."""
    if not points[0].is_cuda:
        return affine_bases_plain(group, points, windows, dbl, wire_major)
    points = tuple(c.contiguous() for c in points)
    m = _check_points(group, points)
    width = _bases_width(group)
    dev = points[0].device
    out = torch.empty((windows * m, width), dtype=torch.int32, device=dev)
    if m * windows:
        chunk = min(m, max(1, K6_SCRATCH_BYTES // (windows * width * 2)))
        zs = torch.empty((chunk * windows, width // 2), dtype=torch.int32, device=dev)
        fn = _build.lib(_MSM_SRC[group]).pob_msm_shifted_bases
        for i0 in range(0, m, chunk):
            _launch(None, "shifted_bases", fn, *_ptrs(points), m, windows, dbl, int(wire_major),
                    i0, min(chunk, m - i0), out.data_ptr(), zs.data_ptr(),
                    _build.stream_ptr(out), key="chains")
    return out


def unpack_words(words):
    """Inverse of pack_words: (..., n) int32 words -> (..., 2n) 16-bit limbs."""
    w = words.long()
    return torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], -1).flatten(-2).to(torch.int32)


def packed_to_jacobian(group: str, packed):
    """(n, 16) (G1) or (n, 32) (G2) packed affine words -> (n,) Jacobian
    points with Z = 1 (Montgomery); (0, 0) gives the port's infinity (one,
    one, 0)."""
    ops = curve.ops_for(group)
    n = packed.shape[0]
    limbs = unpack_words(packed).reshape((n, 2) + ops.coord_shape)
    inf = (packed == 0).all(-1)
    one = ops.one((n,), packed.device)
    pick = inf.reshape((n,) + (1,) * len(ops.coord_shape))
    x, y = (torch.where(pick, one, limbs[:, k]) for k in range(2))
    return x, y, torch.where(pick, torch.zeros_like(one), one)


def _bases_width(group: str) -> int:
    return limb.L * (1 if group == "g1" else 2)


def msm_batched(group: str, points, scalars, bases=None, timing=None):
    """sum_i scalars[b, i] * points[i] for every b. points: (m, ...) Jacobian
    (shared by the batch); scalars: (B, m, 16) canonical Fr limbs; bases:
    affine_bases(group, points) if the caller keeps it (made here if not).
    Returns (B,) Jacobian points. On the card, a list given as `timing`
    gets one (label, start, end) CUDA-event triple per K3 launch."""
    if scalars.is_cuda:
        return pippenger_cuda(group, points, scalars, bases, timing)
    return msm_plain(curve.ops_for(group), points, scalars)


def _launch(timing, label, fn, *args, key="msm"):
    """Launch one kernel (K3's, or K4's, K5's or K6's with its `key` in
    LAUNCHES): count it, time it into `timing` if that is a list, raise on a
    launch error."""
    if timing is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    rc = fn(*args)
    if timing is not None:
        ev[1].record()
        timing.append((label, *ev))
    _build.LAUNCHES[key] += 1
    _build.check(rc, label)


def _layout_cuda(lib, counts, segs, stream, timing=None):
    """K3's layout kernel: (P as segment_layout_plain gives it, cursor)."""
    n_keys = counts.shape[0]
    P = torch.empty((len(segs) + 1, n_keys + 1), dtype=torch.int32, device=counts.device)
    cursor = torch.empty(n_keys, dtype=torch.int32, device=counts.device)
    div = [math.prod(segs[:l]) for l in range(len(segs) + 1)]
    _launch(timing, "layout", lib.pob_msm_layout, counts.data_ptr(), n_keys, len(segs),
            (ctypes.c_int * len(div))(*div), P.data_ptr(), cursor.data_ptr(), stream)
    return P, cursor


def k3_max_batch(m: int) -> int:
    """The most proofs one K3 call over m points can take (K3_MAX_DIGITS)."""
    return K3_MAX_DIGITS // (N_WINDOWS * max(1, m))


def pippenger_cuda(group: str, points, scalars, bases=None, timing=None):
    """K3 launches (csrc/msm.cuh): hist, layout, scatter (the digits of each
    proof sorted into 255 buckets by value per pass, as indices into the
    shifted bases); one bucket-sum launch per level of level_segs(32 m);
    reduce; with more than one pass, fold. The bases hold S shifted windows
    per point (affine_bases(group, points, S), S dividing 32, read from
    their shape): window w of point i adds base (w mod S) m + i into the
    buckets of pass w div S, each proof has 32 / S passes of 255 buckets,
    the reduce forms each pass's weighted sum, and the fold sums the passes
    Horner-style with 8 S doublings between them (none at S = 32). Every
    buffer and grid is sized from B, m and S (level_caps), so nothing is
    read back to the host between the first launch and the output."""
    points = tuple(c.contiguous() for c in points)
    scalars = scalars.contiguous()
    m = _check_points(group, points)
    _build.check_cuda(scalars)
    if scalars.dim() != 3 or tuple(scalars.shape[1:]) != (m, limb.L):
        raise ValueError(f"scalars must be (B, {m}, 16), got {tuple(scalars.shape)}")
    B = scalars.shape[0]
    if B > k3_max_batch(m):
        raise ValueError(f"B * m = {B * m} is too large for one K3 call; split the batch")
    dev = scalars.device
    if B * m == 0:
        return curve.infinity(curve.ops_for(group), (B,), dev)
    if bases is None:
        bases = affine_bases(group, points)
    _build.check_cuda(bases)
    S = bases.shape[0] // m
    if (bases.dim() != 2 or tuple(bases.shape) != (S * m, _bases_width(group))
            or S not in WINDOW_COUNTS):
        raise ValueError(f"bases must be affine_bases of the points with S windows, S dividing "
                         f"32, got {tuple(bases.shape)} for m = {m}")
    lib = _build.lib(_MSM_SRC[group])
    stream = _build.stream_ptr(scalars)
    pw = 3 * _bases_width(group) // 2  # words of a packed Jacobian partial

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    passes = N_WINDOWS // S
    n_keys = B * passes * N_BUCKETS
    chunks = -(-m // (HIST_CHUNK * passes))
    counts = torch.zeros(n_keys, dtype=torch.int32, device=dev)
    blockhist = i32(B * passes * chunks * N_BUCKETS)
    _launch(timing, "hist", lib.pob_msm_hist, scalars.data_ptr(), B, m, S,
            blockhist.data_ptr(), counts.data_ptr(), stream)
    segs = level_segs(N_WINDOWS * m)
    if len(segs) > lib.pob_msm_max_levels():
        raise ValueError(f"m = {m} needs {len(segs)} bucket-sum levels, more than K3's "
                         f"{lib.pob_msm_max_levels()}")
    caps = level_caps(B, m, segs, passes)
    P, cursor = _layout_cuda(lib, counts, segs, stream, timing)
    idx = i32(caps[0])
    _launch(timing, "scatter", lib.pob_msm_scatter, scalars.data_ptr(), B, m, S,
            blockhist.data_ptr(), cursor.data_ptr(), idx.data_ptr(), stream)
    src, src_idx = bases, idx
    for level, seg in enumerate(segs):
        out = i32(caps[level + 1] * pw)
        _launch(timing, f"bucket_sum{level}", lib.pob_msm_bucket_sum, src.data_ptr(),
                None if src_idx is None else src_idx.data_ptr(), P[level].data_ptr(),
                P[level + 1].data_ptr(), n_keys, seg, caps[level + 1], out.data_ptr(), stream)
        src, src_idx = out, None
    out = _empty_points(group, B, dev)
    if passes == 1:
        _launch(timing, "reduce", lib.pob_msm_reduce, src.data_ptr(), P[-1].data_ptr(), B,
                None, *_ptrs(out), stream)
        return out
    sums = i32(B * passes * pw)  # each (proof, pass)'s weighted sum, packed Jacobian
    _launch(timing, "reduce", lib.pob_msm_reduce, src.data_ptr(), P[-1].data_ptr(),
            B * passes, sums.data_ptr(), None, None, None, stream)
    _launch(timing, "fold", lib.pob_msm_fold, sums.data_ptr(), B, passes, S, *_ptrs(out),
            stream)
    return out


# ---------------------------------------------------------------------------
# K4: fixed-base scalar multiplication on the card
# ---------------------------------------------------------------------------


TABLE_ROWS = N_WINDOWS * N_BUCKETS  # K4's window table: row w * 256 + v


def fixed_base_table_plain(group: str, device, windows=range(N_WINDOWS)):
    """Plain version of K4's table kernels: (8192, 16) (G1) or (8192, 32)
    (G2) int32, row w * 256 + v the packed affine words of v 2^(8w) G
    (as affine_bases_plain packs them; (0, 0) for v = 0), each entry the
    sum of the doublings 2^(8w + b) G over the set bits b of v. With
    `windows`, only those windows' rows, in that order (256 each)."""
    ops = curve.ops_for(group)
    dbl = _doublings(group, str(device))
    w = torch.as_tensor(list(windows), device=device)
    e = (w[:, None] * N_BUCKETS + torch.arange(N_BUCKETS, device=device)).flatten()
    bits = (e[:, None] >> torch.arange(WINDOW_BITS, device=device)) & 1  # bits of v
    k, b = bits.nonzero(as_tuple=True)  # sorted by k
    keys, sums = segment_sum(ops, k, tuple(c[(e[k] >> WINDOW_BITS) * WINDOW_BITS + b]
                                           for c in dbl))
    return _packed_affine(group, _scatter(ops, e.shape[0], keys, sums, device))


def fixed_base_table_cuda(group: str, device, timing=None):
    """K4's table kernels: the 255 doublings 2^j G by one warp, then one
    thread per entry (at most 7 adds and one inversion). Returns
    fixed_base_table_plain's table. A list given as `timing` gets one
    (label, start, end) CUDA-event triple per launch."""
    gen = curve.points_to_device(group, [G1_GEN if group == "g1" else G2_GEN], device)
    width = _bases_width(group)
    dbl = torch.empty((N_BUCKETS, 3 * width // 2), dtype=torch.int32, device=device)
    table = torch.empty((TABLE_ROWS, width), dtype=torch.int32, device=device)
    lib, stream = _build.lib("fixed_base.cu"), _build.stream_ptr(table)
    _launch(timing, "doublings", lib.pob_fb_doublings, _GROUP_ID[group], *_ptrs(gen),
            dbl.data_ptr(), stream, key="fixed_base_table")
    _launch(timing, "table", lib.pob_fb_table, _GROUP_ID[group], dbl.data_ptr(),
            table.data_ptr(), stream, key="fixed_base_table")
    return table


@functools.lru_cache(maxsize=8)
def window_table(group: str, device: str):
    """K4's window table on the card `device`, made once per group and
    device by fixed_base_table_cuda."""
    return fixed_base_table_cuda(group, device)


def fixed_base_window_cuda(group: str, table, scalars):
    """K4's window kernel: (m, 16) canonical scalars on the card -> (m,)
    Jacobian k_i G, a mixed add from `table` (window_table) per nonzero
    digit after the first."""
    scalars = scalars.contiguous()
    _build.check_cuda(table, scalars)
    if tuple(table.shape) != (TABLE_ROWS, _bases_width(group)):
        raise ValueError(f"table must be window_table's, got {tuple(table.shape)}")
    if scalars.dim() != 2 or scalars.shape[1] != limb.L:
        raise ValueError(f"scalars must be (m, 16), got {tuple(scalars.shape)}")
    n = scalars.shape[0]
    out = _empty_points(group, n, scalars.device)
    if n:
        _launch(None, "window", _build.lib("fixed_base.cu").pob_fb_window, _GROUP_ID[group],
                table.data_ptr(), scalars.data_ptr(), n, *_ptrs(out),
                _build.stream_ptr(scalars), key="fixed_base")
    return out


def fixed_base_msm(group: str, scalars):
    """k_i * G for (m, 16) canonical Fr scalars -> (m,) Jacobian points."""
    if scalars.is_cuda:
        return fixed_base_window_cuda(group, window_table(group, str(scalars.device)),
                                      scalars)
    return fixed_base_plain(group, scalars)
