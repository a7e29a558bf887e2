#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pob_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the repo root
    python3 chip_smoke.py --msm-breakdown  # phase 1, setup, witness, K3 and K5 breakdown
    python3 chip_smoke.py --k4             # phase 1, then K4's times alone
    python3 chip_smoke.py --k5-k6          # phase 1, then K5's and K6's times alone
    python3 chip_smoke.py --dist           # phase 1, then the multi-device phase (7) alone
    python3 chip_smoke.py --multihost      # phase 1, then the mesh across processes (8) alone
    python3 chip_smoke.py --prod           # phase 1, then the production ProofOfBurn (9) alone
    python3 chip_smoke.py --setup-routes   # phase 1, then the PoB setup both ways (host, card)

Phases (any failure exits non-zero; there is no CPU run):
  1. device: card name and power limit; build the CUDA kernels from
     pob_tpu_torch/csrc (one nvcc per source, in parallel) and print each
     kernel's registers and spill bytes as ptxas reports them.
  2. every kernel (K1 field ops, K2 NTT, K3 Pippenger MSM, K4 fixed-base) is
     held against its plain PyTorch version on the same card tensors, with
     tolerance 0 (integers mod p; points compared as affine points): K1 and
     K2 at the h stage's shapes (K2 also at k = 1, 5, 11, 13, with and
     without the folded bit reversal), K3 and K4 on the edge cases
     (infinity, doubling, cancel, zero scalars; for K3 also the digits
     0x7F, 0x80, 0xFF, r - 1 and an all-ones batch of 3 bucket-sum levels;
     for K4 also the top digit 0x30, a scalar with only window 31 nonzero,
     an all-zero batch and m = 1). K4's window table (built on the card,
     cache cleared, median of 3 builds as the caller sees them, and the
     median of 3 of its kernels' time alone) is held against its plain
     version. Both versions are timed with CUDA events.
  3. the main path at full width: build_spend_cs, setup at domain 2^18
     with the witness-MSM plan (pob_tpu's default), a batch-16 Spend
     witness on the card, one warm-up and two timed prove_batch calls on
     the planned path (K5 for the four witness MSMs, K3 for the h-MSM),
     host verification of 4 proofs (and rejection with a tampered public
     input). The kernels' launch counters are zeroed just before and read
     just after, and each kernel must have run. Then two timed proves of
     the same witnesses on the plain path (POB_NO_PLAN=1): the same 16
     proofs, bit for bit.
  4. K3, K4, K5 and K6 on the main path's own inputs: the MSM stage of one
     prove, planned and plain, under torch.cuda.set_sync_debug_mode("error")
     (K3 and K5 read nothing back to the host); K3's time per launch for
     each of the five MSMs and K5's for the planned ones; the five
     MSMs at B = 16 (proofs 0 and 15 against the plain version) and every
     query point of the setup (against the plain version over the setup's
     scalars); K4's two setup calls (G1, G2) timed, median of 3, beside
     two bounds: a mixed add per nonzero digit after each scalar's first
     (this design's least count) and a full add per nonzero digit (the first
     port's count). K5 per group on the planned MSMs at B = 16 (proofs 0
     and 15 against the plain version, every position), K6's doubling
     chains of every full point against the plain version and the plan's,
     the plan's bit points against the plain affine conversion, K6's
     (32, 8) bases of the key (K3's shifted bases) in all 32 windows at
     4,096 positions per query, infinite points of the a-query included,
     each kernel timed beside its bound; the plan written to a
     pob_tpu-format .npz and read back (the same plan, the same proofs).
  5. the ProofOfBurn path at bench.py's PoB size (TEST_CONFIG: 3,966,130
     constraints, domain 2^22, batch 4), with the Spend objects freed:
     build_pob_cs, setup on the card (the device scalars, K4, the key's
     affine bases and the witness-MSM plan timed apart; L_j(tau) and the h
     scalars held against the host ints at every position, u / v / w at
     4,097 wires through the a, b1, l and ic scalars), a batch-4 witness made
     on the card from the fixture as bench.py makes it
     (proof_extra_commitment = pec0 + 1 + i, wire 1
     held against pob_expected_commitment), one warm-up prove stage by stage
     and two timed prove_batch calls, 4 proofs verified and 4 tampered
     publics rejected; launch counters zeroed before and read after, each
     kernel must have run; peak device memory through setup, the witness,
     the h stage and the MSM stage; the witness again by part (a cProfile
     of it gives the hash traces' share); the 4 proofs again on the plain
     path (POB_NO_PLAN=1), bit for bit. Then every kernel on this path's
     own inputs against its plain version, each row's numbers from one
     input: K1 on the h stage's product A.W x B.W (4 x 2^22); K2 on its
     first transform, intt(A.W) (4 rows x 2^22, three passes, row 0 against
     the plain version; also one random row at k = 20 and 21); K3 on the
     whole a-MSM of proof 0 and on the B = 4 h- and b2-MSMs with scalars kept at 65,536 positions spread
     over [0, m), the last included, and the full h-MSM timed beside its
     bound; K4: the setup's query points at 16,384 positions per group
     against the plain version over the setup's own scalars (kept from its
     call), and the K4 call over all of them timed; K5 per group at B = 4
     on a copy of the plan whose points are kept at 65,536 positions per
     query, the full call timed; K6 on 512 full points of each query, timed
     over all of them, and on the key's (32, 8) bases at 512 positions per
     query, timed by the setup's own calls (CUDA events). Then a batch of
     16 (more than K3's int32 limit of 15 at m = 2^22 and more than free
     memory holds) in one prove_batch, which splits it into chunks: the
     first 4 proofs must equal the batch-4 proofs (same witnesses, same
     r, s), all 16 verify, one tampered public is rejected. Last, the key
     through a snarkjs .zkey: write_zkey (ZKEY_SAMPLE points of each point
     section against the plain msm._packed_affine bytes), the key freed,
     load_zkey (its vk equal to the setup's; its K6 calls timed), the
     batch-4 witnesses proved again with the same (r, s): the same proofs,
     which verify. One `pob {...}` JSON line.
  9. (run last, every earlier object freed) the production ProofOfBurn,
     PROD_CONFIG (13,341,537 constraints, domain 2^24), at batch 1: see
     prod_phase. One `prod {...}` JSON line.
  6. (run after phase 4, before phase 5) the command line at full width on
     Spend, in-process through pob_tpu_torch.cli.main: setup (zkey, r1cs,
     vk), witness (wtns), prove (from the zkey), verify (0, and 1 with a
     tampered public), export-verifier (the .sol parses back to the vk),
     grind (2 zero bytes); the .wtns must equal spend_full_witness on the
     card and the .r1cs read back to build_spend_cs's counts; launch counters
     zeroed before, K1-K4 and K6 must each have run (prove reads the zkey,
     so it takes the plain path and K5 does not run). One `cli {...}` JSON
     line.
  7. (run after phase 6, before phase 5, on phase 3's Spend key, witnesses,
     h and proofs) the multi-device layer on virtual meshes of the card,
     data_mesh(D, device=card) for D = 1, 2, 4: the four-step NTT and its
     inverse against the local K2 transform, shard_pk, the sharded h-MSM
     against the local K3 call, compute_h_sharded against compute_h under
     the h permutation, prove_sharded of witnesses 0 and 1 against
     prove_batch's proofs (verified, a tampered public rejected); the
     pipelined prover on [card] * 3 and [card] * 6 (an MSM group of 4
     shards) over 4 Spend requests, against prove_batch's proofs; and
     graft_entry_torch.dryrun_multichip(4, card). Launch counters zeroed
     before, K1, K2, K3 and K6 must each have run. One `dist {...}` JSON
     line (see dist_phase).
  8. (run after phase 7, before phase 5, on phase 3's Spend key, witnesses
     and proofs) the dist layer on a mesh across processes: one NCCL rank
     per visible card, each a process of this script started through
     subprocess and joined through init_multihost; the key reaches them by
     save_pk, the witnesses and (r, s) by files. In every rank, launch
     counters zeroed before: shard_pk, prove_sharded of witnesses 0 and 1
     (every rank's proofs equal prove_batch's), the four-step NTT and its
     inverse at (9, 9) against the local K2 transform, the sharded h-MSM
     against the local K3 call; K1, K2, K3 and K6 must each have run; then
     dryrun_multichip over the world in every rank. A rank's failure or
     the deadline (MULTIHOST_DEADLINE_S) kills the others and fails the
     script. One `multihost {...}` JSON line (world size, backend, NCCL
     version, shard_pk and prove_sharded seconds, the collectives' ms,
     peak memory per rank; see multihost_phase).
Each phase's end is printed with the script's elapsed time (`phases_s`).
Then the kernel table as one JSON line (Spend rows with their launches on
the main path, the cli phase, the dist phase, the multihost phase (summed
over its ranks), the PoB path and the PROD path, then the PoB rows, then
the PROD rows), the card, and last, the device line.

--k4 times K4 through entry points every tree of the port has
(msm.window_table, msm.fixed_base_msm, groth16.setup_scalars), so a copy of
this script in the root of an older tree times that tree's K4 the same way:
per group, the table's build as the caller sees it (cache cleared, host
work included, median of 3) and the setup's call (median of 3), after a
check of the edge scalars against the plain version; one JSON line. In
this mode and in --k5-k6 a ptxas spill is printed and does not fail the
run: the first port's G2 table kernel spilled.

--k5-k6 times K5 and K6 through entry points every tree of the port since
the planned path has (groth16.setup with timings, msm.affine_bases,
bitsum.bitsum_msm, groth16.prove_batch, write_zkey, load_zkey), so a copy
of this script in the root of an older tree times that tree the same way:
on Spend (2^18, B = 16) and PoB (TEST_CONFIG, B = 4) the setup and its K6
calls (CUDA events) and peak memory, K6's chains per group, K5 per group
with its launches, msm_s of the planned and the plain path (the same
proofs), and for PoB the key through a .zkey (load_zkey's time, peak and
K6 calls); one `k5k6 {label}: {...}` line per circuit."""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks used for the bounds: HBM 3.35 TB/s (data sheet); 32-bit
# integer multiply instructions at 64 per SM per clock (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1.98 GHz.
PEAK_BYTES_S = 3.35e12
PEAK_IMUL_S = 64 * 132 * 1.98e9
MONT_MULS = 264  # 32-bit multiplies in one 8-word CIOS Montgomery product
ADD_MULS = {"g1": 16, "g2": 44}  # field multiplies in one Jacobian add
MADD_MULS = {"g1": 11, "g2": 30}  # ... in one mixed (affine) add
DBL_MULS = {"g1": 7, "g2": 16}  # ... and in one doubling
COORD_BYTES = {"g1": 64, "g2": 128}


T_START = time.perf_counter()
PHASES = {}  # phase -> seconds since the script started, at its end


def phase_done(name: str):
    PHASES[name] = time.perf_counter() - T_START
    log(f"phase {name} done at {PHASES[name]:.1f} s")


def mark(label: str):
    """A line with the script's elapsed seconds at a step of a phase."""
    log(f"at {time.perf_counter() - T_START:.1f} s: {label}")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops * MONT_MULS / PEAK_IMUL_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def msm_bounds(group: str, B: int, m: int, nz: int, S: int = 32):
    """K3's bound for one call with nz nonzero digits over bases of S
    shifted windows: (ms, by) from the current design's least count (a
    mixed add per digit, one weighted sum of 255 buckets per proof and
    pass: 511 adds; between a proof's 32 / S passes, 8 S doublings and an
    add) and from the first port's count (a full add per digit, 511 adds per
    window sum, 256 doublings per proof). Bytes: points, scalars in, sums
    out."""
    nbytes = m * 3 * COORD_BYTES[group] + B * m * 64 + B * 3 * COORD_BYTES[group]
    npass = 32 // S
    fold = B * (npass - 1) * (8 * S * DBL_MULS[group] + ADD_MULS[group])
    return (bound(nbytes, nz * MADD_MULS[group] + B * npass * 511 * ADD_MULS[group] + fold),
            bound(nbytes, (nz + B * 32 * 511) * ADD_MULS[group] + B * 256 * DBL_MULS[group]))


TOXIC = tuple(range(12345, 12345 + 5 * 7919, 7919))  # tau, alpha, beta, gamma, delta


SPEND_KEYS = ("burn_key", "balance", "withdrawn", "extra_commitment")


def spend_cases(batch: int):
    """The main path's Spend requests as bench.py derives them from the
    fixture (extra_commitment = base + i): ((burn_key, balance, withdrawn,
    extra) field elements per proof, expected public commitments)."""
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.harness.inputs import load_spend_input, spend_expected_commitment

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "spend_input.json")
    base = load_spend_input(fix)
    cases = [dict(base, extra_commitment=base["extra_commitment"] + i) for i in range(batch)]
    return ([tuple(c[k] % FR_MOD for k in SPEND_KEYS) for c in cases],
            [spend_expected_commitment(c) for c in cases])


def spend_batch(dev, batch: int):
    """The main path's Spend inputs (spend_cases): (witness arguments on the
    card, expected public commitments)."""
    from pob_tpu_torch.field import limb

    reqs, pubs = spend_cases(batch)
    args = [limb.to_device(limb.ints_to_limbs([r[j] for r in reqs]), dev)
            for j in range(len(SPEND_KEYS))]
    return args, pubs


def five_msms(pk, W, h):
    """(name, group, points, scalars, affine bases) of the five MSMs of
    prove_batch (groth16.msm_stage)."""
    sc = {"a_query": W, "b1_query": W, "b2_query": W, "l_query": W[:, pk.num_public + 1:],
          "h_query": h}
    from pob_tpu_torch.prover.groth16 import MSM_QUERIES

    return [(q.split("_")[0], g, getattr(pk, q), sc[q], pk.bases[q]) for q, g in MSM_QUERIES]


def msm_breakdown(torch, msm, msms) -> dict:
    """K3's time per launch (CUDA events) for each MSM, on its second call;
    `other` is the rest of the call's time (torch ops between launches,
    waits for host reads)."""
    out = {}
    for name, group, pts, sc, bases in msms:
        msm.msm_batched(group, pts, sc, bases)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        timing = []
        s.record()
        msm.msm_batched(group, pts, sc, bases, timing)
        e.record()
        torch.cuda.synchronize()
        parts = {}
        for label, a, b in timing:
            parts[label] = parts.get(label, 0.0) + a.elapsed_time(b)
        total = s.elapsed_time(e)
        parts["other"] = total - sum(parts.values())
        B, m = sc.shape[0], sc.shape[1]
        nz = int((msm.scalar_digits(sc) != 0).sum())
        (bms, by), (bms_pr2, _) = msm_bounds(group, B, m, nz)
        out[name] = {"group": group, "B": B, "m": m, "nonzero_digits": nz,
                     "total_ms": total, "bound_ms": bms, "bound_by": by,
                     "bound_ms_full_adds": bms_pr2, "launches": len(timing), "ms": parts}
        log(f"K3 breakdown {name}-MSM ({group}, B={B}, m={m}, {nz} nonzero digits, "
            f"{len(timing)} launches): total_ms {total:.3f} bound_ms {bms:.3f} ({by}; "
            f"{bms_pr2:.3f} with full adds) | "
            + " ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return out


def plan_groups(pk):
    """(group, query names, PlanGroup) of each group of the key's plan."""
    from pob_tpu_torch.prover.groth16 import PLAN_GROUPS

    return [(g, names, getattr(pk.plan, g)) for g, names in PLAN_GROUPS]


def k5_call(group, g, W, timing=None):
    """K5 on the plan group g for the witnesses W."""
    from pob_tpu_torch.prover import bitsum

    return bitsum.bitsum_msm(group, g.pts, g.bit_idx, g.full_idx, g.counts, W, timing)


def k5_breakdown(torch, pk, W) -> dict:
    """K5's time per launch (CUDA events; second call) for each group call
    of the planned path and for each query of it alone (q = 1, a copy of
    its rows of the plan)."""
    from pob_tpu_torch.prover.groth16 import PlanGroup

    out = {}
    for group, names, g in plan_groups(pk):
        parts = [("+".join(n.split("_")[0] for n in names), g)]
        if len(names) > 1:
            parts += [(n.split("_")[0], PlanGroup(*(t[i:i + 1].clone() for t in (
                g.pts, g.bit_idx, g.full_idx, g.counts)))) for i, n in enumerate(names)]
        for label, sub in parts:
            k5_call(group, sub, W)
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            timing = []
            s.record()
            k5_call(group, sub, W, timing)
            e.record()
            torch.cuda.synchronize()
            ms = {lab: a.elapsed_time(b) for lab, a, b in timing}
            total = s.elapsed_time(e)
            ms["other"] = total - sum(ms.values())
            out[label] = {"group": group, "B": W.shape[0], "M": sub.pts.shape[1],
                          "total_ms": total, "launches": len(timing), "ms": ms}
            log(f"K5 breakdown {label} ({group}, B={W.shape[0]}, M={g.pts.shape[1]}, "
                f"{len(timing)} launches): total_ms {total:.3f} | "
                + " ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return out


def k5_bound(group, g, W):
    """K5's bound for one group call on the witnesses W: a mixed add per set
    bit of a live plan point (counted from W) against the plan's points,
    the witnesses and the index arrays read once and the sums written once.
    Returns (ms, by, set bits)."""
    from pob_tpu_torch.prover import bitsum

    q, M = g.pts.shape[:2]
    live = (g.pts != 0).any(-1)
    nset = int((bitsum.plan_bits(M, g.bit_idx, g.full_idx, g.counts, W).bool()
                & live[:, None]).sum())
    B, nw = W.shape[:2]
    nbytes = (g.pts.numel() * 4 + B * nw * 64 + (g.bit_idx.numel() + g.full_idx.numel()) * 4
              + q * B * 3 * COORD_BYTES[group])
    ms, by = bound(nbytes, nset * MADD_MULS[group])
    return ms, by, nset


def fq_inv_muls(group: str) -> int:
    """Fq products of one coordinate inversion (fe_inv: 253 squarings and a
    product per set bit of q - 2 below bit 253; on G2 4 Fq products around
    it)."""
    from pob_tpu_torch.field.ref import FQ_MOD

    return 253 + bin((FQ_MOD - 2) & ((1 << 253) - 1)).count("1") + (4 if group == "g2" else 0)


def k6_bound(group: str, n: int, windows: int, dbl: int):
    """K6's least work for n points: the doublings, then per output 3
    coordinate products (its share of one batched inversion of every Z) and
    the products to affine (4 / 11 Fq products), plus that one inversion;
    bytes: the Jacobian points in, the packed affine points out."""
    coord_mul = 1 if group == "g1" else 3
    to_affine = 4 if group == "g1" else 11
    ops = (n * (windows - 1) * dbl * DBL_MULS[group] + n * windows * (3 * coord_mul + to_affine)
           + fq_inv_muls(group))
    return bound(n * 3 * COORD_BYTES[group] + n * windows * COORD_BYTES[group], ops)


def plan_full_points(pk, group, names, g, keep=None):
    """The Jacobian points of the group's full wires, queries in order (as
    attach_msm_plan gathers them for K6); with keep, only those of each
    query's full wires."""
    import torch

    parts = []
    for qi, name in enumerate(names):
        nf = int(g.counts[qi, 1])
        off = pk.num_public + 1 if name == "l_query" else 0
        idx = g.full_idx[qi, :nf].long() - off
        if keep is not None:
            idx = idx[keep[keep < nf]]
        parts.append(tuple(c[idx] for c in getattr(pk, name)))
    return tuple(torch.cat(cs, 0) for cs in zip(*parts))


def make_rand(dev, seed: int):
    """rand_elems(shape): random canonical elements (< p of Fr and Fq: top
    limb < 0x3064) on dev, from a generator seeded with seed."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand_elems(shape, top=0x3000):
        x = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen, device=dev,
                          dtype=torch.int32)
        x[..., 15] %= top
        return x

    return rand_elems


def cuda_ms(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def median_ms(fn, reps=3):
    """Median of reps calls of fn after a warm-up, each timed with CUDA
    events."""
    fn()
    return sorted(once_ms(fn)[1] for _ in range(reps))[reps // 2]


def exact(name, a, b):
    import torch

    if a.shape != b.shape or not torch.equal(a, b):
        bad = (a != b).any(-1).nonzero()[:4].tolist() if a.shape == b.shape else "shape"
        fail(f"{name}: kernel and plain version differ (first rows {bad})")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def once_ms(fn):
    """One call of fn, timed with CUDA events: (result, ms)."""
    import torch

    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def same_points(name, group, p, q):
    """Kernel points p against plain points q, as affine points."""
    from pob_tpu_torch.prover import curve

    eq = curve.points_equal(curve.ops_for(group), p, q)
    if not bool(eq.all()):
        fail(f"{name}: kernel and plain version differ (first points "
             f"{(~eq).nonzero().squeeze(1)[:4].tolist()})")


def _flat(p):
    return tuple(c.flatten(0, 1) for c in p)


def plan_checks(pk, W, label, chk=None, keep_pos=None, keep_full=None, groups=("g1", "g2")):
    """K5 and K6 on a path's own inputs, against their plain versions
    (tolerance 0), with the kernel's time beside its bound. K5: each group's
    call on all of W, timed (3 calls); held against the plain version on
    the proofs `chk` (the kernel's sums of those proofs), or, with
    keep_pos, both on a copy of the plan whose points are kept at those
    positions of each query ((0, 0) elsewhere). K6: (254, 1, wire-major)
    on each group's full points, timed over all of them; its chains must
    equal the plan's, and it is held against the plain version on all of
    them or, with keep_full, on those of each query's full wires. Without
    keep_pos, the plan's bit points are held against the plain
    msm._packed_affine of the key's Jacobian points. Returns (rows, info)."""
    import torch

    from pob_tpu_torch.prover import bitsum, msm

    rows, info = [], {}
    fb = bitsum.FULL_BITS
    for group, names, g in plan_groups(pk):
        if group not in groups:
            continue
        G, q, M = group.upper(), g.pts.shape[0], g.pts.shape[1]
        B = W.shape[0]
        qnames = "+".join(n.split("_")[0] for n in names)
        km = cuda_ms(lambda: k5_call(group, g, W), 3)
        bms, by, nset = k5_bound(group, g, W)
        if keep_pos is None:
            kern = tuple(c[:, chk] for c in k5_call(group, g, W))
            Wc = W[chk]
            plain, pm = once_ms(lambda: bitsum.bitsum_plain(group, g.pts, g.bit_idx, g.full_idx,
                                                            g.counts, Wc))
            checked, sampled_ms = f"proofs {chk.tolist()} of the B={B} call, every position", None
        else:
            sp = torch.zeros_like(g.pts)
            sp[:, keep_pos] = g.pts[:, keep_pos]
            kern, sampled_ms = once_ms(lambda: bitsum.bitsum_msm(group, sp, g.bit_idx, g.full_idx,
                                                                 g.counts, W))
            plain, pm = once_ms(lambda: bitsum.bitsum_plain(group, sp, g.bit_idx, g.full_idx,
                                                            g.counts, W))
            checked = f"B={B}, the plan's points kept at {len(keep_pos)} positions per query"
            del sp
        same_points(f"K5 {label} {G} ({qnames})", group, _flat(kern), _flat(plain))
        log(f"K5 {label} {G} {qnames} (q={q}, M={M}, B={B}, {nset} set bits): exact on {checked}; "
            f"kernel_ms {km:.3f} (all of W) plain_ms {pm:.3f} bound_ms {bms:.4f} ({by}), "
            f"share {bms / km:.3f}")
        rows.append({"name": f"K5 bitsum ({label}: {G}, {qnames})", "key": f"bitsum_{group}",
                     "route": "cuda", "source": "pob_tpu_torch/csrc/bitsum.cuh",
                     "replaces": "pob_tpu/prover/groth16.py:801", "max_abs_err": 0, "ms": km,
                     "plain_ms": pm, "bound_ms": bms, "bound_by": by, "bound_share": bms / km,
                     "library_ms": None, "shape": f"q={q} x M={M} {G} points, B={B}",
                     "set_bits": nset, "checked_on": checked, "sampled_ms": sampled_ms})
        del kern, plain

        full = plan_full_points(pk, group, names, g)
        n = full[0].shape[0]
        chains = msm.affine_bases(group, full, fb, 1, True)
        k6_ms = cuda_ms(lambda: msm.affine_bases(group, full, fb, 1, True), 3)
        mb, o = g.bit_idx.shape[1], 0
        for qi in range(q):
            nf = int(g.counts[qi, 1])
            exact(f"K6 {label} {G}: the plan's chains of query {qi}",
                  g.pts[qi, mb:mb + nf * fb], chains[o * fb:(o + nf) * fb])
            o += nf
        if keep_full is None:
            sub, kern6 = full, chains
        else:
            sub = plan_full_points(pk, group, names, g, keep_full)
            kern6 = msm.affine_bases(group, sub, fb, 1, True)
        plain6, k6_pm = once_ms(lambda: msm.affine_bases_plain(group, sub, fb, 1, True))
        exact(f"K6 {label} {G} chains", kern6, plain6)
        k6_bms, k6_by = k6_bound(group, n, fb, 1)
        log(f"K6 {label} {G} chains (254 doublings of {n} full points; plain on "
            f"{sub[0].shape[0]}) exact, equal to the plan's: kernel_ms {k6_ms:.3f} plain_ms "
            f"{k6_pm:.3f} bound_ms {k6_bms:.4f} ({k6_by}), share {k6_bms / k6_ms:.4f}")
        rows.append({"name": f"K6 chains ({label}: {G}, the plan's full points)", "key": "chains",
                     "route": "cuda", "source": "pob_tpu_torch/csrc/msm.cuh",
                     "replaces": "pob_tpu/prover/groth16.py:674", "max_abs_err": 0,
                     "ms": k6_ms, "plain_ms": k6_pm, "bound_ms": k6_bms, "bound_by": k6_by,
                     "bound_share": k6_bms / k6_ms, "library_ms": None,
                     "shape": f"{n} {G} points x 254 doublings",
                     "plain_shape": f"{sub[0].shape[0]} of them"})
        del chains, kern6, plain6, full, sub
        if keep_pos is None:
            for qi, name in enumerate(names):
                nb = int(g.counts[qi, 0])
                off = pk.num_public + 1 if name == "l_query" else 0
                idx = g.bit_idx[qi, :nb].long() - off
                exact(f"plan {label} {name} bit points", g.pts[qi, :nb],
                      msm._packed_affine(group, tuple(c[idx] for c in getattr(pk, name))))
        info[group] = {"q": q, "M": M, "mb": mb, "mf": g.full_idx.shape[1],
                       "counts": g.counts.tolist(), "set_bits": nset, "full_points": n}
    return rows, info


@contextlib.contextmanager
def k6_calls(msm, rec: list):
    """Within the block, every msm.affine_bases call (K6, as groth16's
    setup, attach_msm_plan and load_zkey make them) is timed with CUDA
    events: rec gets one (group, m, windows, dbl, start, end) per call."""
    import torch

    real = msm.affine_bases

    def timed_k6(group, points, windows=msm.N_WINDOWS, dbl=msm.WINDOW_BITS, wire_major=False):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(group, points, windows, dbl, wire_major)
        ev[1].record()
        rec.append((group, int(points[0].shape[0]), windows, dbl, *ev))
        return out

    msm.affine_bases = timed_k6
    try:
        yield
    finally:
        msm.affine_bases = real


def k6_setup_ms(rec) -> list:
    """The K6 calls k6_calls recorded, synchronized: [{group, m, windows,
    dbl, ms}] in call order."""
    import torch

    torch.cuda.synchronize()
    return [{"group": g, "m": m, "windows": w, "dbl": d, "ms": a.elapsed_time(b)}
            for g, m, w, d, a, b in rec]


def k6_bases_ms(pk, calls) -> dict:
    """{query: ms} of the key's K6 calls at (S, 8), S its windows for the
    query (groth16.bases_windows), which attach_bases makes in MSM_QUERIES
    order."""
    from pob_tpu_torch.prover.groth16 import MSM_QUERIES, bases_windows

    ws = bases_windows(pk)
    calls = [c for c in calls if c["dbl"] == 8]
    if [(c["group"], c["m"], c["windows"]) for c in calls] != [
            (g, getattr(pk, q)[0].shape[0], ws[q]) for q, g in MSM_QUERIES]:
        fail(f"the key's K6 calls at (S, 8) are not one per query: {calls}")
    return {q: c["ms"] for (q, _), c in zip(MSM_QUERIES, calls)}


def bases_checks(pk, label, sample, call_ms=None):
    """K6 at K3's (S, 8) on the key's own bases, S its windows for each
    query (groth16.bases_windows; 32 but for a key too large for that):
    pk.bases of each query held against affine_bases_plain (tolerance 0) in
    all S windows at `sample` positions spread over the query, the last
    included, and at up to 16 infinite points of the a-query. The kernel's
    time per query is call_ms[query] (the key's own call, CUDA events) or,
    without it, timed here (3 calls); per group the sum beside the sum of
    the queries' k6_bound. Returns one row per group."""
    import torch

    from pob_tpu_torch.prover import msm
    from pob_tpu_torch.prover.groth16 import MSM_QUERIES, bases_windows

    acc, ws = {}, bases_windows(pk)
    for q, group in MSM_QUERIES:
        pts, S = getattr(pk, q), ws[q]
        m = pts[0].shape[0]
        pos = torch.from_numpy(spread_positions(m, min(sample, m))).to(pts[0].device)
        n_inf = 0
        if q == "a_query":
            inf = (pts[2].reshape(m, -1) == 0).all(1).nonzero().flatten()[:16]
            n_inf = int(inf.numel())
            pos = torch.unique(torch.cat([pos, inf]))
        sub = tuple(c[pos] for c in pts)
        plain, pm = once_ms(lambda: msm.affine_bases_plain(group, sub, S))
        got = pk.bases[q].view(S, m, -1)[:, pos].reshape(plain.shape)
        exact(f"K6 {label} {q} bases ({S}, 8) at {pos.numel()} positions", got, plain)
        ms = call_ms[q] if call_ms else cuda_ms(lambda: msm.affine_bases(group, pts, S), 3)
        bms, _ = k6_bound(group, m, S, msm.WINDOW_BITS)
        log(f"K6 {label} {q} bases ({S}, 8; {m} points) exact in all {S} windows at "
            f"{pos.numel()} positions ({n_inf} infinite): kernel_ms {ms:.3f} plain_ms {pm:.3f} "
            f"bound_ms {bms:.4f}, share {bms / ms:.4f}")
        a = acc.setdefault(group, {"queries": [], "S": set(), "n": 0, "ms": 0.0,
                                   "plain_ms": 0.0, "bound_ms": 0.0, "held": 0, "inf": 0})
        a["queries"].append(f"{q.split('_')[0]} ({S}, 8)")
        a["S"].add(S)
        a["n"] += m
        a["ms"] += ms
        a["plain_ms"] += pm
        a["bound_ms"] += bms
        a["held"] += int(pos.numel())
        a["inf"] += n_inf
        del plain, got, sub
    rows = []
    for group, a in acc.items():
        G = group.upper()
        shape = f"({a['S'].pop()}, 8)" if len(a["S"]) == 1 else "(S, 8)"
        rows.append({"name": f"K6 bases {shape} ({label}: {G}, the key's "
                             f"{'+'.join(q.split(' ')[0] for q in a['queries'])} queries)",
                     "key": "chains", "route": "cuda", "source": "pob_tpu_torch/csrc/msm.cuh",
                     "replaces": "pob_tpu/prover/groth16.py:674", "max_abs_err": 0,
                     "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                     "bound_by": "operations", "bound_share": a["bound_ms"] / a["ms"],
                     "library_ms": None,
                     "shape": f"{a['n']} {G} points, windows of 8 doublings: "
                              + ", ".join(a["queries"]),
                     "plain_shape": f"{a['held']} of them ({a['inf']} infinite), all their "
                                    f"windows",
                     "timed": "the key's own calls" if call_ms else "3 calls per query"})
    return rows


def plan_cache_roundtrip(pk, cs, W, rs, proofs) -> dict:
    """The key's plan written to a pob_tpu-format .npz (attach_msm_plan
    with a cache_path that does not exist yet) and read back: the plan read
    equals the plan built, and its proofs equal `proofs` for the same
    (r, s). The key keeps its original plan."""
    import torch

    from pob_tpu_torch.prover import groth16

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "spend_plan.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    orig = pk.plan
    try:
        _, write_s = timed(lambda: groth16.attach_msm_plan(pk, cs, cache_path=path))
        _, read_s = timed(lambda: groth16.attach_msm_plan(pk, cs, cache_path=path))
        for group in ("g1", "g2"):
            a, b = getattr(pk.plan, group), getattr(orig, group)
            for name in ("pts", "bit_idx", "full_idx", "counts"):
                if not torch.equal(getattr(a, name), getattr(b, name)):
                    fail(f"plan cache: {group} {name} read back differs from the plan built")
        if groth16.prove_batch(pk, W, rs=rs) != proofs:
            fail("plan cache: proofs from the plan read back differ")
    finally:
        pk.plan = orig
    out = {"bytes": os.path.getsize(path), "write_s": write_s, "read_s": read_s}
    os.remove(path)
    log(f"plan cache: {out['bytes']} bytes written in {write_s:.3f} s (the plan built again), "
        f"read back in {read_s:.3f} s; the plan read equals the plan built, and its "
        f"{len(proofs)} proofs are the same")
    return out


def plain_path(fn):
    """fn() with POB_NO_PLAN=1 (prove_batch's plain path)."""
    os.environ["POB_NO_PLAN"] = "1"
    try:
        return fn()
    finally:
        del os.environ["POB_NO_PLAN"]


POB_BATCH = 4  # bench.py's BENCH_POB_BATCH
POB_SAMPLE = 1 << 16  # positions kept in the sampled K3 and K5 checks
POB_K4_SAMPLE = 1 << 14  # setup scalars per group in the K4 check (65,536 until phase 9 came)
POB_K4_CHUNK = 1 << 14  # sampled K4 scalars per plain call (its G2 sums' memory)
POB_K2_ROWS = 1  # rows of intt(A.W) held against the plain K2 (all 4 until phase 9 came)
POB_K2_MORE = (20, 21)  # K2 also at these k, one random row each (2 and 3 passes)
POB_K6_SAMPLE = 512  # points of each query in the sampled K6 checks (chains, bases)
SPEND_K6_SAMPLE = 4096  # points of each query in the Spend K6 bases check
SCALAR_SAMPLE = 4096  # wires (and PROD_CONFIG's L_j and h_j positions) of the setup route check


def pob_batch(cfg, dev, batch: int):
    """PoB witness inputs as bench.py derives them from the fixture
    (proof_extra_commitment = pec0 + 1 + i): (kwargs on the card, expected
    public commitments)."""
    from pob_tpu_torch.field import limb
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.harness.inputs import (batch_stack, load_pob_input,
                                              pob_expected_commitment, to_device)

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "pob_input.json")
    with open(fix) as f:
        raw = json.load(f)
    base = load_pob_input(raw, cfg)
    pecs = [(int(raw.get("_proofExtraCommitment", 0)) + 1 + i) % FR_MOD for i in range(batch)]
    cases = [dict(base, proof_extra_commitment=limb.int_to_limbs(p)) for p in pecs]
    return (to_device(batch_stack(cases), dev),
            [pob_expected_commitment(dict(raw, _proofExtraCommitment=p), cfg) for p in pecs])


def timed(fn):
    """One call of fn on the host clock, synchronized: (result, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def witness_parts(cfg, cs, kw) -> dict:
    """A second PoB witness on the same inputs, by part: the blocks
    (pob_r1cs_witness) and their assembly, synchronized; then a third
    pob_r1cs_witness under cProfile, with the cumulative seconds of the
    hash traces it calls (witness.keccak_f_trace, witness.poseidon_trace)
    beside the call's own (host clock, the profiler's overhead included)."""
    import cProfile
    import pstats

    import torch

    from pob_tpu_torch.r1cs import witness as wit
    from pob_tpu_torch.r1cs.pob_circuit import pob_r1cs_witness
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

    blocks, blocks_s = timed(lambda: pob_r1cs_witness(cfg, **kw))
    _, assemble_s = timed(lambda: assemble_witness(cs, blocks))
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    pob_r1cs_witness(cfg, **kw)
    torch.cuda.synchronize()
    prof.disable()
    cum = {}
    for (path, _, fn), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
        if path == wit.__file__ or fn == "pob_r1cs_witness":
            cum[fn] = cum.get(fn, 0.0) + ct
    return {"blocks": blocks_s, "assemble": assemble_s,
            "profiled": {k: cum.get(k, 0.0) for k in ("pob_r1cs_witness", "keccak_f_trace",
                                                       "poseidon_trace")}}


def spread_positions(n: int, count: int):
    """count positions spread evenly over [0, n), 0 and n - 1 included."""
    import numpy as np

    return np.unique(np.arange(count, dtype=np.int64) * (n - 1) // (count - 1))


@contextlib.contextmanager
def keep_setup_route(groth16, kept: dict, pos=None):
    """Within the block, setup's device route leaves on the host what it
    computes and drops: kept["toxic"]; kept["scalars"][query] = (positions,
    rows) of setup_scalars_dev's canonical scalars; kept["lag"] = (positions,
    rows) of L_j(tau) in Montgomery form (_lagrange_at_tau_mont_dev). Every
    row, or with pos only the rows pos[name] (a sorted numpy array). And
    kept["digits"][query] = (nonzero digits, nonzero scalars) over all its
    scalars, for K4's bound."""
    import numpy as np

    real_sc, real_lag = groth16.setup_scalars_dev, groth16._lagrange_at_tau_mont_dev

    def take(name, t):
        import torch

        if pos is None:
            return np.arange(t.shape[0]), t.cpu().numpy()
        return pos[name], t[torch.from_numpy(pos[name]).to(t.device)].cpu().numpy()

    def scalars(cs, toxic, device):
        from pob_tpu_torch.prover import msm

        k, sc, mats = real_sc(cs, toxic, device)
        kept["toxic"] = toxic
        kept["scalars"] = {q: take(q, t) for q, t in sc.items()}
        digits = {q: msm.scalar_digits(t) != 0 for q, t in sc.items()}
        kept["digits"] = {q: (int(d.sum()), int(d.any(-1).sum())) for q, d in digits.items()}
        return k, sc, mats

    def lag(k, tau, device):
        out = real_lag(k, tau, device)
        kept["lag"] = take("lag", out)
        return out

    groth16.setup_scalars_dev, groth16._lagrange_at_tau_mont_dev = scalars, lag
    try:
        yield
    finally:
        groth16.setup_scalars_dev, groth16._lagrange_at_tau_mont_dev = real_sc, real_lag


def host_lagrange_at(k: int, tau: int, js, powers=None) -> list:
    """L_j(tau) = w^j (tau^n - 1) / (n (tau - w^j)) as host ints at the
    positions js (numpy), from `powers` (w^j for every j < n) if given."""
    import numpy as np

    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import groth16, ntt

    n, w = 1 << k, ntt.domain_root(k)
    c = (pow(tau, n, FR_MOD) - 1) * pow(n, FR_MOD - 2, FR_MOD) % FR_MOD
    pws = [powers[j] if powers else pow(w, j, FR_MOD) for j in np.asarray(js).tolist()]
    invs = groth16._batch_inv([(tau - x) % FR_MOD for x in pws])
    return [x * c % FR_MOD * i % FR_MOD for x, i in zip(pws, invs)]


def host_h_at(k: int, toxic, js, powers=None) -> list:
    """The h basis x_j (tau^{2n} - 1) / (2 n delta (tau - x_j)), x_j = s w^j,
    as host ints at the positions js, from `powers` (w^j for every j < n)
    if given."""
    import numpy as np

    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import groth16, ntt

    tau, delta = toxic[0], toxic[4]
    n, w, s = 1 << k, ntt.domain_root(k), ntt.domain_root(k + 1)
    c0 = ((pow(tau, 2 * n, FR_MOD) - 1) * pow(2 * n, FR_MOD - 2, FR_MOD)
          * pow(delta, FR_MOD - 2, FR_MOD) % FR_MOD)
    xs = [s * (powers[j] if powers else pow(w, j, FR_MOD)) % FR_MOD
          for j in np.asarray(js).tolist()]
    invs = groth16._batch_inv([(tau - x) % FR_MOD for x in xs])
    return [x * c0 % FR_MOD * i % FR_MOD for x, i in zip(xs, invs)]


def spread_wires(nw: int, count: int, npub: int):
    """count wires spread over [0, nw), wire 0, the public wires and the last
    one included."""
    import numpy as np

    return np.unique(np.concatenate([spread_positions(nw, count), np.arange(npub + 1)]))


def host_setup_digests(k: int, path: str):
    """--host-setup-digests: the host ints of L_j(tau) (Montgomery limbs)
    and of the h basis (canonical limbs) at every position of the domain
    2^k for TOXIC, as the SHA-256 of their limb bytes, written to `path` as
    JSON with the seconds they took. Run in a process of its own (started
    after the build), so these minutes of host ints overlap the card's work
    of phases 2-8; the PoB phase compares the digests with the setup's
    device values."""
    import hashlib

    from pob_tpu_torch.field import limb
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import ntt

    t0 = time.perf_counter()
    n, r_mont = 1 << k, (1 << 256) % FR_MOD
    powers = ntt._powers(ntt.domain_root(k), n)
    lag = [x * r_mont % FR_MOD for x in host_lagrange_at(k, TOXIC[0], range(n), powers)]
    out = {"k": k, "lag_sha256": hashlib.sha256(limb.ints_to_limbs(lag).tobytes()).hexdigest()}
    del lag
    h = host_h_at(k, TOXIC, range(n), powers)
    out["h_sha256"] = hashlib.sha256(limb.ints_to_limbs(h).tobytes()).hexdigest()
    out["host_s"] = time.perf_counter() - t0
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def scalar_checks(label: str, cs, k: int, kept: dict, wires, digests=None) -> dict:
    """The device setup route's values (kept by keep_setup_route) against
    the host ints (tolerance 0): L_j(tau) and the h basis at every position
    (their limb bytes against `digests`, host_setup_digests' SHA-256, when
    given) or at the kept ones; u, v, w at the sampled wires through the
    setup's a, b1, l and ic scalars (u, v, (beta u + alpha v + w) / delta
    or / gamma), u_i(tau) summed on the host over the COO entries of those
    wires with L_j at their rows. Returns the positions held and the host
    seconds."""
    import numpy as np

    import hashlib

    from pob_tpu_torch.field import limb
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import groth16, ntt

    t0 = time.perf_counter()
    toxic = kept["toxic"]
    tau, alpha, beta, gamma, delta = toxic
    n, npub = 1 << k, cs.num_public
    r_mont = (1 << 256) % FR_MOD
    sc = kept["scalars"]

    def rows_at(name, js):
        pos, rows = sc[name] if name != "lag" else kept["lag"]
        at = np.searchsorted(pos, js)
        if not np.array_equal(pos[np.minimum(at, len(pos) - 1)], js):
            fail(f"{label}: the setup route's {name} was not kept at every checked position")
        return limb.limb_rows_to_ints(rows[at])

    if digests is not None:
        for name, rows, key in (("L_j(tau)", kept["lag"][1], "lag_sha256"),
                                ("the h scalars", sc["h_query"][1], "h_sha256")):
            if len(rows) != n or hashlib.sha256(rows.tobytes()).hexdigest() != digests[key]:
                fail(f"{label}: {name} on the card differ from the host ints")
        js = hjs = np.arange(n)
    else:
        js, hjs = kept["lag"][0], sc["h_query"][0]
        if rows_at("lag", js) != [x * r_mont % FR_MOD for x in host_lagrange_at(k, tau, js)]:
            fail(f"{label}: L_j(tau) on the card differs from the host ints")
        if rows_at("h_query", hjs) != host_h_at(k, toxic, hjs):
            fail(f"{label}: the h scalars on the card differ from the host ints")
    powers = None

    mats = groth16._indexed_matrices(cs)
    sel = [np.isin(cols, wires) for _, cols, _, _ in mats]
    need = np.unique(np.concatenate([m[0][s_] for m, s_ in zip(mats, sel)]))
    if powers is None and len(need) > n // 16:
        powers = ntt._powers(ntt.domain_root(k), n)
    lag = dict(zip(need.tolist(), host_lagrange_at(k, tau, need, powers)))
    del powers
    uvw = []
    for (rows, cols, cidx, pal), s_ in zip(mats, sel):
        acc = dict.fromkeys(wires.tolist(), 0)
        for j, i, c in zip(rows[s_].tolist(), cols[s_].tolist(), np.asarray(cidx)[s_].tolist()):
            acc[i] += pal[c] * lag[j]
        uvw.append({i: v % FR_MOD for i, v in acc.items()})
    u, v, w = uvw
    kv = {i: (beta * u[i] + alpha * v[i] + w[i]) % FR_MOD for i in u}
    ginv, dinv = pow(gamma, FR_MOD - 2, FR_MOD), pow(delta, FR_MOD - 2, FR_MOD)
    priv = wires[wires > npub]
    pub = wires[wires <= npub]
    for name, js_, want in (
            ("a_query", wires, [u[i] for i in wires.tolist()]),
            ("b1_query", wires, [v[i] for i in wires.tolist()]),
            ("l_query", priv - npub - 1, [kv[i] * dinv % FR_MOD for i in priv.tolist()]),
            ("ic", pub, [kv[i] * ginv % FR_MOD for i in pub.tolist()])):
        if rows_at(name, js_) != want:
            fail(f"{label}: the setup's {name} scalars on the card differ from the host ints")
    nterms = sum(int(s_.sum()) for s_ in sel)
    out = {"lag_positions": int(len(js)), "h_positions": int(len(hjs)),
           "wires": int(len(wires)), "wire_terms": nterms, "rows": int(len(need)),
           "host_s": time.perf_counter() - t0}
    log(f"{label} setup route exact against the host ints: L_j at {out['lag_positions']} "
        f"positions, h at {out['h_positions']}, u / v / w at {out['wires']} wires (0, the "
        f"public ones and {cs.num_wires - 1} among them; {nterms} COO terms over "
        f"{len(need)} rows); host {out['host_s']:.1f} s")
    return out


def k4_sampled_check(label, dev, pk, vk, kept, count: int, chunk: int) -> list:
    """K4 on the setup's own scalars (kept by keep_setup_route): per group,
    the key's query points at `count` positions spread over the group's
    concatenated scalars (G1: a, b1, l, h, ic; G2: b2) against the plain
    version, `chunk` scalars per plain call. Returns (group, names, n,
    positions, plain ms) per group."""
    import numpy as np

    import torch

    from pob_tpu_torch.prover import curve, groth16, msm

    out = []
    ic_pts = curve.g1_points_to_device(vk.ic, dev)
    for group, names in (("g1", groth16.G1_QUERIES), ("g2", ("b2_query",))):
        sizes = [len(getattr(pk, q)[0]) if q != "ic" else len(vk.ic) for q in names]
        offs = np.cumsum([0] + sizes)
        pos = spread_positions(int(offs[-1]), count)
        q_of = np.searchsorted(offs, pos, side="right") - 1
        got, sc = [], []
        for qi, q in enumerate(names):
            local = pos[q_of == qi] - offs[qi]
            got.append(tuple(c[torch.from_numpy(local).to(dev)]
                             for c in (ic_pts if q == "ic" else getattr(pk, q))))
            kp, rows = kept["scalars"][q]
            at = np.searchsorted(kp, local)
            sc.append(torch.from_numpy(rows[at]))
        got = tuple(torch.cat(cs_, 0) for cs_ in zip(*got))
        sc = torch.cat(sc, 0).to(dev)
        pm = 0.0
        for o in range(0, len(pos), chunk):
            c = slice(o, o + chunk)
            plain, ms = once_ms(lambda: msm.fixed_base_plain(group, sc[c]))
            pm += ms
            same_points(f"K4 {label} {group} setup queries at positions [{o}, ...) of {len(pos)}",
                        group, tuple(x[c] for x in got), plain)
        out.append((group, names, int(offs[-1]), len(pos), pm))
        del got, sc, plain
    return out


def pob_phase(dev, card, digests_helper):
    """The ProofOfBurn path at bench.py's size (TEST_CONFIG, domain 2^22,
    batch 4): build, setup, witness on the card, warm-up and timed proves,
    verification; launch counts; peak device memory per stage; then each
    kernel on this path's own inputs against its plain version: K1 and K2
    on the h stage's (4, 2^22) tensors, K2 also at k = 20, 21, K3 on the
    a-MSM of proof 0 and the B = 4 h- and b2-MSMs with scalars kept at
    POB_SAMPLE positions, K4 on the setup's scalars at POB_K4_SAMPLE
    positions per group; the device setup scalars against the host ints
    (L_j and h_j at every position, u / v / w at SCALAR_SAMPLE wires).
    Returns (the pob JSON object, kernel rows)."""
    import numpy as np
    import torch

    from pob_tpu_torch import _build
    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG
    from pob_tpu_torch.field import cuda_mont, limb
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import curve, groth16, msm, ntt
    from pob_tpu_torch.r1cs.pob_circuit import build_pob_cs, pob_r1cs_witness
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

    gb = {}

    def peak(stage):
        torch.cuda.synchronize()
        gb[stage] = torch.cuda.max_memory_allocated() / 1e9
        log(f"PoB peak device memory through {stage}: {gb[stage]:.3f} GB "
            f"(allocated now {torch.cuda.memory_allocated() / 1e9:.3f} GB)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"PoB phase starts with {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    msm.window_table.cache_clear()  # setup builds K4's table, as a user's first setup does
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cs = build_pob_cs(TEST_CONFIG)
    build_cs_s = time.perf_counter() - t0
    (ra, _, _), (rb, _, _), (rc, _, _), pal = cs.matrices_indexed()
    nnz = {"A": len(ra), "B": len(rb), "C": len(rc)}
    log(f"PoB build_pob_cs(TEST_CONFIG): {cs.num_constraints} constraints, {cs.num_wires} wires, "
        f"nnz {nnz}, palette {len(pal)}, {build_cs_s:.3f} s")

    st, kept, k6_rec = {}, {}, []
    t0 = time.perf_counter()
    # the setup route's values are checked and K4's check reuses its scalars
    # (kept on the host); K6's calls are timed
    with keep_setup_route(groth16, kept), k6_calls(msm, k6_rec):
        pk, vk = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev, timings=st)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    k6_setup = k6_setup_ms(k6_rec)
    del k6_rec
    bases_ms = k6_bases_ms(pk, k6_setup)
    k_pob = pk.k
    if k_pob != 22:
        fail(f"PoB domain is 2^{k_pob}, expected 2^22")
    key_gb = sum(t.numel() * t.element_size() for t in pk.bases.values()) / 1e9
    jac_gb = sum(c.numel() * c.element_size() for q, _ in groth16.MSM_QUERIES
                 for c in getattr(pk, q)) / 1e9
    mats_gb = sum(t.numel() * t.element_size() for m in pk.mats for t in m) / 1e9
    if pk.plan is None:
        fail("PoB setup did not give the key its witness-MSM plan")
    plan_gb = pk.plan.nbytes() / 1e9
    log(f"PoB setup_s {setup_s:.3f} (scalars {st['scalars_s']:.3f}, K4 {st['k4_s']:.3f}, "
        f"attach_bases {st['bases_s']:.3f}, attach_msm_plan {st['plan_s']:.3f}, rest "
        f"{setup_s - sum(st.values()):.3f}); key on the card: shifted bases {key_gb:.3f} GB, "
        f"Jacobian queries {jac_gb:.3f} GB, matrices {mats_gb:.3f} GB, the plan {plan_gb:.3f} GB "
        f"(counts G1 {pk.plan.g1.counts.tolist()} G2 {pk.plan.g2.counts.tolist()}, M "
        f"{pk.plan.g1.pts.shape[1]} / {pk.plan.g2.pts.shape[1]})")
    peak("setup")
    mark("PoB setup done")
    digests = helper_result(digests_helper, 600, "PoB: the host setup scalars")
    setup_route = scalar_checks("PoB", cs, k_pob, kept,
                                spread_wires(cs.num_wires, SCALAR_SAMPLE, cs.num_public), digests)
    setup_route["digests_host_s"] = digests["host_s"]
    log("PoB setup's K6 calls: " + ", ".join(
        f"({c['windows']}, {c['dbl']}) {c['m']} {c['group'].upper()} {c['ms']:.1f} ms"
        for c in k6_setup))
    after_setup = dict(_build.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    kw, pubs = pob_batch(TEST_CONFIG, dev, POB_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W = assemble_witness(cs, pob_r1cs_witness(TEST_CONFIG, **kw))
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    if limb.limb_rows_to_ints(W[:, 1].cpu().numpy()) != pubs:
        fail("PoB witness wire 1 differs from pob_expected_commitment")
    log(f"PoB witness_s {witness_s:.4f} (batch {POB_BATCH}, wire 1 == expected commitment)")
    peak("witness")
    after_witness = dict(_build.LAUNCHES)

    mark("PoB witness done")
    rs = [(3000 + i, 4000 + i) for i in range(POB_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    h = groth16.compute_h(pk.k, pk.mats, W)  # the warm-up prove, stage by stage
    peak("h stage")
    torch.cuda.reset_peak_memory_stats()
    sums = groth16.msm_stage(pk, W, h)
    peak("MSM stage")
    del sums
    n = 1 << pk.k
    (aw, ta), (bw, tb) = (timed(lambda: groth16.sparse_matvec_mont(m, W, n))
                          for m in pk.mats[:2])
    matvec_s = [ta, tb]
    log(f"PoB h stage's sparse mat-vecs alone (synchronized): A {ta:.4f} s, B {tb:.4f} s")
    before = dict(_build.LAUNCHES)
    runs = []
    for _ in range(2):
        tm = {}
        t0 = time.perf_counter()
        proofs = groth16.prove_batch(pk, W, rs=rs, timings=tm)
        torch.cuda.synchronize()
        tm["prove_s"] = time.perf_counter() - t0
        runs.append(tm)
        log(f"PoB timed prove: h_s {tm['h_s']:.4f} msm_s {tm['msm_s']:.4f} "
            f"prove_s {tm['prove_s']:.4f}")
    counts = dict(_build.LAUNCHES)
    per_prove = {k: (counts[k] - before[k]) // len(runs) for k in counts}
    mean = {k: sum(tm[k] for tm in runs) / len(runs) for k in ("h_s", "msm_s", "prove_s")}
    pps = POB_BATCH / (witness_s + mean["prove_s"])
    log(f"PoB launches: setup {after_setup}, witness "
        f"{ {k: after_witness[k] - after_setup[k] for k in counts} }, one batch-{POB_BATCH} "
        f"prove {per_prove}, whole path {counts}")
    log(f"PoB proofs_per_s {pps:.4f} (batch / (witness_s + prove_s), prove_s the mean of "
        f"{len(runs)} timed proves)")
    for key in _build.LAUNCHES:
        if counts[key] <= 0:
            fail(f"kernel {key} was not launched on the PoB path")

    t0 = time.perf_counter()
    for i in range(POB_BATCH):
        if not groth16.verify(vk, proofs[i], [pubs[i]]):
            fail(f"PoB proof {i} does not verify")
        if groth16.verify(vk, proofs[i], [(pubs[i] + 1) % FR_MOD]):
            fail(f"PoB proof {i} verifies with a tampered public input")
    log(f"PoB verify: {POB_BATCH} proofs accepted, {POB_BATCH} tampered publics rejected "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    torch.cuda.reset_peak_memory_stats()
    tm_plain = {}
    before_plain = dict(_build.LAUNCHES)
    plain_proofs, plain_prove_s = timed(
        lambda: plain_path(lambda: groth16.prove_batch(pk, W, rs=rs, timings=tm_plain)))
    gb["plain prove"] = torch.cuda.max_memory_allocated() / 1e9
    per_plain = {k: _build.LAUNCHES[k] - before_plain[k] for k in counts}
    if plain_proofs != proofs:
        fail(f"PoB: the {POB_BATCH} planned proofs differ from the plain path's")
    tm_plain["prove_s"] = plain_prove_s
    log(f"PoB plain path (POB_NO_PLAN=1): the same {POB_BATCH} proofs bit for bit; h_s "
        f"{tm_plain['h_s']:.4f} msm_s {tm_plain['msm_s']:.4f} prove_s {plain_prove_s:.4f}, "
        f"peak {gb['plain prove']:.3f} GB")
    mark("PoB proves, verify and the plain path done")
    wit_parts = witness_parts(TEST_CONFIG, cs, kw)  # after the counts: its launches are extra
    log("PoB witness again, by part (s): " + json.dumps(wit_parts))
    rows = []

    # K1 on an h-stage product at (4, 2^22): A.W times B.W, compute_h's C.W;
    # the plain version in chunks of 2^20 elements (its int64 columns)
    fa, fb = aw.reshape(-1, limb.L), bw.reshape(-1, limb.L)
    kern = cuda_mont.field_op(cuda_mont.MUL, limb.FR, fa, fb)
    k1_err, k1_pm = 0, 0.0
    for o in range(0, fa.shape[0], 1 << 20):
        c = slice(o, o + (1 << 20))
        want, ms = once_ms(lambda: limb.mont_mul_plain(limb.FR, fa[c], fb[c]))
        k1_pm += ms
        k1_err = max(k1_err, exact(f"K1 PoB A.W x B.W elements [{o}, ...)", kern[c], want))
    k1_ms = cuda_ms(lambda: cuda_mont.field_op(cuda_mont.MUL, limb.FR, fa, fb), 10)
    bms, by = bound(3 * 64 * fa.shape[0], fa.shape[0])
    log(f"K1 PoB h-stage product ({POB_BATCH} x 2^{pk.k} Fr pairs) exact: kernel_ms {k1_ms:.4f} "
        f"plain_ms {k1_pm:.1f} bound_ms {bms:.4f} ({by})")
    rows.append({"name": "K1 mont (PoB: Fr mul, the h stage's A.W x B.W)", "key": "mont",
                 "route": "cuda", "source": "pob_tpu_torch/csrc/mont.cu",
                 "replaces": "pob_tpu/field/pallas_mont.py:107", "max_abs_err": k1_err,
                 "ms": k1_ms, "plain_ms": k1_pm, "bound_ms": bms, "bound_by": by,
                 "library_ms": None, "shape": f"{POB_BATCH} x 2^{pk.k} Fr pairs"})
    del kern, want, fa, fb

    mark("PoB K1 check done")
    # K2 on the h stage's first transform, intt(A.W): 4 rows x 2^22, three
    # passes, its first POB_K2_ROWS rows against the plain version; and one
    # random row at k = 20 (two passes) and 21 (three)
    rand_elems = make_rand(dev, 20261)
    for k in POB_K2_MORE:
        x = rand_elems((1, 1 << k))
        roots = limb.to_device(ntt._root_powers(k, False), dev)
        want = ntt._transform_plain(x.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev)),
                                    k, roots)
        exact(f"K2 k={k}", ntt.ntt_stages_cuda(x, k, roots, gather=True), want)
        log(f"K2 k={k} (passes {ntt.ntt_passes(k)}) exact against the plain version (1 row)")
    roots = limb.to_device(ntt._root_powers(pk.k, True), dev)
    bitrev = torch.from_numpy(ntt._bitrev(pk.k)).to(dev)
    kern = ntt.ntt_stages_cuda(aw, pk.k, roots, gather=True)
    k2_err, k2_pm = 0, 0.0
    for r in range(POB_K2_ROWS):
        want, ms = once_ms(lambda: ntt._transform_plain(aw[r:r + 1].index_select(-2, bitrev),
                                                        pk.k, roots))
        k2_pm += ms
        k2_err = max(k2_err, exact(f"K2 PoB intt(A.W) row {r}", kern[r:r + 1], want))
    k2_ms = cuda_ms(lambda: ntt.ntt_stages_cuda(aw, pk.k, roots, gather=True), 5)
    bms, by = bound(2 * POB_BATCH * n * 64 + n // 2 * 64, pk.k * POB_BATCH * n // 2)
    log(f"K2 PoB intt(A.W) stages ({POB_BATCH} rows x 2^{pk.k}, passes {ntt.ntt_passes(pk.k)}, "
        f"with the gather) exact: kernel_ms {k2_ms:.4f} plain_ms {k2_pm:.1f} (rows "
        f"0-{POB_K2_ROWS - 1}) "
        f"bound_ms {bms:.4f} ({by})")
    rows.append({"name": "K2 ntt (PoB: the h stage's intt(A.W), 3 passes)", "key": "ntt",
                 "route": "cuda", "source": "pob_tpu_torch/csrc/ntt.cu",
                 "replaces": "pob_tpu/prover/ntt.py:61", "max_abs_err": k2_err, "ms": k2_ms,
                 "plain_ms": k2_pm, "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "shape": f"{POB_BATCH} rows x 2^{pk.k}",
                 "plain_shape": f"rows 0-{POB_K2_ROWS - 1}"})
    del kern, want, aw, bw, x

    mark("PoB K2 checks done")
    # K3 on this path's own inputs: the whole a-MSM of proof 0, and the
    # h- and b2-MSMs at B = 4 with scalars kept at POB_SAMPLE positions
    # spread over [0, m), the last included (the rest zeroed)
    def sampled(sc):
        keep = torch.from_numpy(spread_positions(sc.shape[1], POB_SAMPLE)).to(dev)
        out = torch.zeros_like(sc)
        out[:, keep] = sc[:, keep]
        return out

    torch.cuda.empty_cache()  # the plain versions' temporaries beside a 58 GB key and plan
    checks = (("a-MSM proof 0", "g1", "a_query", W[:1]),
              ("h-MSM sampled", "g1", "h_query", sampled(h)),
              ("b2-MSM sampled", "g2", "b2_query", sampled(W)))
    for name, group, q, sc in checks:
        pts = getattr(pk, q)
        msm.msm_batched(group, pts, sc, pk.bases[q])  # refills the allocator's cache untimed
        (kern, km3), (plain, pm3) = (
            once_ms(lambda: msm.msm_batched(group, pts, sc, pk.bases[q])),
            once_ms(lambda: msm.msm_plain(curve.ops_for(group), pts, sc)))
        same_points(f"K3 PoB {name}", group, kern, plain)
        nz = int((msm.scalar_digits(sc) != 0).sum())
        log(f"K3 PoB {name} ({group}, B={sc.shape[0]}, m={sc.shape[1]}, {nz} nonzero digits): "
            f"exact; kernel_ms {km3:.3f} plain_ms {pm3:.3f}")
        if q == "h_query":
            h_sampled = (km3, pm3, nz)
    del checks, sc, kern, plain
    nz = sum(int((msm.scalar_digits(h[b]) != 0).sum()) for b in range(POB_BATCH))
    hm = cuda_ms(lambda: msm.msm_batched("g1", pk.h_query, h, pk.bases["h_query"]), 3)
    (bms, by), (bms_full, _) = msm_bounds("g1", POB_BATCH, n, nz)
    (sbms, _), _ = msm_bounds("g1", POB_BATCH, n, h_sampled[2])
    log(f"K3 PoB h-MSM B={POB_BATCH} m={n} ({nz} nonzero digits): kernel_ms {hm:.3f} bound_ms "
        f"{bms:.3f} ({by}; {bms_full:.3f} with a full add per digit)")
    rows.append({"name": "K3 msm (PoB h-MSM: G1, B=4 x 2^22)", "key": "msm", "route": "cuda",
                 "source": "pob_tpu_torch/csrc/msm.cuh",
                 "replaces": "pob_tpu/prover/msm.py:92", "max_abs_err": 0, "ms": hm,
                 "plain_ms": h_sampled[1], "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "shape": f"B={POB_BATCH} x 2^{pk.k} G1 points",
                 "checked_on": f"the same B={POB_BATCH} h with scalars kept at {POB_SAMPLE} "
                               f"positions (last included), the rest 0: plain_ms is the plain "
                               f"version's, sampled_ms the kernel's, sampled_bound_ms its bound",
                 "sampled_ms": h_sampled[0], "sampled_bound_ms": sbms})
    del h

    mark("PoB K3 checks done")
    # K5 and K6 on this path's own inputs: K5 at B = 4 with the plan's
    # points kept at POB_SAMPLE positions per query; K6 on POB_K6_SAMPLE
    # full points of each query, timed over all of them
    keep_full = torch.from_numpy(spread_positions(
        max(int(pk.plan.g1.counts[:, 1].max()), int(pk.plan.g2.counts[:, 1].max())),
        POB_K6_SAMPLE)).to(dev)
    prow, pinfo = [], {}
    torch.cuda.empty_cache()
    for group, _, g in plan_groups(pk):
        keep_pos = torch.from_numpy(spread_positions(g.pts.shape[1], POB_SAMPLE)).to(dev)
        r_, i_ = plan_checks(pk, W, "PoB", keep_pos=keep_pos, keep_full=keep_full,
                             groups=(group,))
        prow += r_
        pinfo.update(i_)
    rows += prow
    rows += bases_checks(pk, "PoB", POB_K6_SAMPLE, call_ms=bases_ms)
    mark("PoB K5 and K6 checks done")
    W = W.cpu()  # back on the card for the zkey round trip; off it for K4's plain sums

    # K4 on the setup's own scalars (kept from its call), at POB_K4_SAMPLE
    # positions per group: the setup's query points there against the plain
    # version (the plain G2 sums need ~4 GB per POB_K4_CHUNK); the kernel
    # timed over every scalar of the group
    torch.cuda.empty_cache()
    sc_host = {q: rows for q, (_, rows) in kept["scalars"].items()}
    k4_plain = {g: (n4, npos, pm) for g, _, n4, npos, pm in
                k4_sampled_check("PoB", dev, pk, vk, kept, POB_K4_SAMPLE, POB_K4_CHUNK)}
    del kept
    for group, names in (("g1", groth16.G1_QUERIES), ("g2", ("b2_query",))):
        n4, npos, pm4 = k4_plain[group]
        sc = torch.from_numpy(np.concatenate([sc_host[q] for q in names])).to(dev)
        pos = range(npos)
        km4 = median_ms(lambda: msm.fixed_base_msm(group, sc))
        dig = msm.scalar_digits(sc) != 0
        nz4, nz_scalars = int(dig.sum()), int(dig.any(-1).sum())
        nbytes = n4 * 64 + n4 * 3 * COORD_BYTES[group] + 8192 * 2 * COORD_BYTES[group] // 2
        bms, by = bound(nbytes, (nz4 - nz_scalars) * MADD_MULS[group])
        bms_full, _ = bound(nbytes, nz4 * ADD_MULS[group])
        log(f"K4 PoB {group} setup queries {'+'.join(names)} (n={n4}, {nz4} nonzero digits): "
            f"exact at {len(pos)} positions (plain_ms {pm4:.3f}); kernel_ms {km4:.3f} over all "
            f"(median of 3) bound_ms {bms:.3f} ({by}) {bms_full:.3f} (a full add per digit)")
        rows.append({"name": f"K4 fixed_base (PoB: {group.upper()} window, the setup's "
                             f"{group.upper()} queries)", "key": "fixed_base", "route": "cuda",
                     "source": "pob_tpu_torch/csrc/fixed_base.cu",
                     "replaces": "pob_tpu/prover/msm.py:248", "max_abs_err": 0, "ms": km4,
                     "plain_ms": pm4, "bound_ms": bms, "bound_by": by,
                     "bound_ms_full_adds": bms_full, "library_ms": None,
                     "shape": f"{n4} {group.upper()} scalars",
                     "plain_shape": f"{len(pos)} of them, spread over [0, {n4}), the last "
                                    f"included"})
        del sc, dig
    del sc_host
    mark("PoB K4 checks done")
    big = pob_big_batch(cs, pk, vk, proofs, rs)
    mark("PoB batch of 16 done")
    path, zk = pob_zkey_write(cs, pk, vk)
    del pk, pts
    gc.collect()
    torch.cuda.empty_cache()
    k6_rec = []
    with k6_calls(msm, k6_rec):
        zk.update(pob_zkey_load(path, vk, W.to(dev), proofs, rs, pubs))
    zk["k6_calls"] = k6_setup_ms(k6_rec)
    log(f"PoB load_zkey's K6 calls (32, 8): " + ", ".join(
        f"{c['m']} {c['group'].upper()} {c['ms']:.1f} ms" for c in zk["k6_calls"]
        if c["windows"] == msm.N_WINDOWS))
    for row in rows:
        key = row.pop("key")
        row["launches"] = counts[key]
        row["launches_per_prove"] = per_prove[key]
        row["launches_per_plain_prove"] = per_plain[key]

    out = {"constraints": cs.num_constraints, "wires": cs.num_wires, "nnz": nnz,
           "k": k_pob, "batch": POB_BATCH, "build_cs_s": build_cs_s, "setup_s": setup_s,
           **{f"setup_{k}": v for k, v in st.items()}, "witness_s": witness_s, **mean,
           "timed_proves": runs, "proofs_per_s": pps, "witness_parts_s": wit_parts,
           "matvec_s": matvec_s, "peak_gb": gb, "batch16": big, "zkey": zk,
           "plan_gb": plan_gb, "plan": pinfo, "plain_path": tm_plain,
           "k6_setup_calls": k6_setup,
           "launches_per_plain_prove": per_plain,
           "key_gb": {"bases": key_gb, "jacobian": jac_gb, "mats": mats_gb},
           "setup_route_check": setup_route,
           "launches": counts, "launches_per_prove": per_prove}
    return out, rows


POB_BIG_BATCH = 16  # the first B above K3's int32 limit at m = 2^22 (15)
ZKEY_SAMPLE = 4096  # points per section held against the plain version


def pob_big_batch(cs, pk, vk, proofs4, rs4) -> dict:
    """PoB at B = 16 in one prove_batch: more than K3's int32 limit (15 at
    m = 2^22) and more than free memory holds at once, so it goes in
    chunks. Witnesses from the fixture as pob_batch makes them (pec0 + 1 +
    i): the first 4 are the batch-4 witnesses, so with the same (r, s) their
    proofs must equal the batch-4 proofs; all 16 verify and one tampered
    public is rejected."""
    import torch

    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import groth16, msm
    from pob_tpu_torch.r1cs.pob_circuit import pob_r1cs_witness
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

    B = POB_BIG_BATCH
    kw, pubs = pob_batch(TEST_CONFIG, torch.device("cuda"), B)
    W, witness_s = timed(lambda: assemble_witness(cs, pob_r1cs_witness(TEST_CONFIG, **kw)))
    del kw
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    rs = list(rs4) + [(3000 + i, 4000 + i) for i in range(len(rs4), B)]
    tm = {}
    proofs, prove_s = timed(lambda: groth16.prove_batch(pk, W, rs=rs, timings=tm))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del W
    if proofs[:len(proofs4)] != proofs4:
        fail(f"PoB B={B} in chunks of {tm['chunk']}: the first {len(proofs4)} proofs differ from "
             f"the batch-{len(proofs4)} proofs of the same witnesses")
    t0 = time.perf_counter()
    for i in range(B):
        if not groth16.verify(vk, proofs[i], [pubs[i]]):
            fail(f"PoB B={B}: proof {i} does not verify")
    if groth16.verify(vk, proofs[B - 1], [(pubs[B - 1] + 1) % FR_MOD]):
        fail(f"PoB B={B}: proof {B - 1} verifies with a tampered public input")
    verify_s = time.perf_counter() - t0
    per_proof = groth16.h_stage_bytes(pk.k) / 1e9
    out = {"batch": B, "chunk": tm["chunk"], "chunks": -(-B // tm["chunk"]),
           "k3_max_batch": msm.k3_max_batch(1 << pk.k), "witness_s": witness_s,
           "prove_s": prove_s, "h_s": tm["h_s"], "msm_s": tm["msm_s"], "verify_s": verify_s,
           "allocated_before_gb": base_gb, "peak_gb": peak_gb,
           "h_stage_gb_per_proof_reckoned": per_proof,
           "peak_reckoned_gb": base_gb + tm["chunk"] * per_proof}
    log(f"PoB B={B}: one prove_batch in chunks of {tm['chunk']} ({out['chunks']} chunks; K3's "
        f"limit {out['k3_max_batch']}): prove_s {prove_s:.3f} (h_s {tm['h_s']:.3f}, msm_s "
        f"{tm['msm_s']:.3f}), peak {peak_gb:.2f} GB from {base_gb:.2f} allocated (reckoned "
        f"{out['peak_reckoned_gb']:.2f}); proofs 0-{len(proofs4) - 1} equal the batch-"
        f"{len(proofs4)} proofs; {B} verified, 1 tampered public rejected ({verify_s:.1f} s)")
    return out


def check_zkey_points(path: str, pk, label: str) -> int:
    """Hold ZKEY_SAMPLE points of each point section of the file, from the
    middle of the section, against the plain msm._packed_affine of the key's
    Jacobian points there (bytes, tolerance 0). Returns the points held."""
    from pob_tpu_torch.prover import msm, serialize

    d, held = serialize.read_zkey(path), 0
    for sid, q, group in serialize.ZKEY_QUERIES:
        m = int(getattr(pk, q)[0].shape[0])
        o = max(0, m // 2 - ZKEY_SAMPLE // 2)
        e = min(m, o + ZKEY_SAMPLE)
        plain = msm._packed_affine(group, tuple(c[o:e] for c in getattr(pk, q))).cpu().numpy()
        got = d[{5: "a_pts", 6: "b1_pts", 7: "b2_pts", 8: "c_pts", 9: "h_pts"}[sid]][o:e]
        if got.tobytes() != plain.tobytes():
            fail(f"{label}: zkey section {sid} ({q}) points [{o}, {e}) differ from the plain "
                 f"version's bytes")
        held += e - o
    return held


def pob_zkey_write(cs, pk, vk):
    """The first half of the PoB key's round trip through a snarkjs .zkey at
    2^22: write_zkey of the setup's key, then sampled point ranges of the
    file against the plain version. Returns (path, numbers)."""
    import torch

    from pob_tpu_torch.prover import serialize

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "pob.zkey")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    _, write_s = timed(lambda: serialize.write_zkey(path, pk, vk, cs))
    out = {"write_s": write_s, "bytes": os.path.getsize(path),
           "write_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "points_held_against_plain": check_zkey_points(path, pk, "PoB")}
    log(f"PoB zkey written at 2^{pk.k}: write_s {write_s:.3f}, {out['bytes']} bytes, "
        f"{out['points_held_against_plain']} sampled points equal the plain version's bytes")
    return path, out


def pob_zkey_load(path, vk, W, proofs, rs, pubs) -> dict:
    """The second half, after the setup's key is freed: load_zkey; its vk
    must equal the setup's, and the batch-4 witnesses proved with the same
    (r, s) must give the setup key's proofs, which verify."""
    import torch

    from pob_tpu_torch.prover import groth16

    freed_to = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    (lpk, lvk), load_s = timed(lambda: groth16.load_zkey(path))
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    if (lvk.alpha1, lvk.beta2, lvk.gamma2, lvk.delta2, lvk.ic) != (
            vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, vk.ic):
        fail("PoB zkey round trip: the loaded vk differs from the setup's")
    again, prove_s = timed(lambda: groth16.prove_batch(lpk, W, rs=rs))
    if again != proofs:
        fail("PoB zkey round trip: proofs from the loaded key differ from the setup key's")
    for i, p in enumerate(again):
        if not groth16.verify(lvk, p, [pubs[i]]):
            fail(f"PoB zkey round trip: proof {i} does not verify")
    os.remove(path)
    out = {"freed_to_gb": freed_to, "load_s": load_s, "load_peak_gb": load_peak,
           "prove_s": prove_s}
    log(f"PoB zkey loaded: the setup key freed to {freed_to:.2f} GB allocated; load_s "
        f"{load_s:.3f} (peak {load_peak:.2f} GB); the loaded vk equals the setup's; "
        f"{len(again)} proofs equal the setup key's and verify")
    return out


# The reference's production instantiation (circuits/main_proof_of_burn.circom:26)
# as PROD_R1CS.json records it (scripts/prod_r1cs_report.py)
PROD_R1CS = {"constraints": 13_341_537, "wires": 13_330_191, "nnz": 78_572_948,
             "palette": 8_867, "k": 24}
PROD_SAMPLE = 1 << 16  # positions kept in the PROD K3 and K5 checks
PROD_K4_SAMPLE = 1 << 14  # setup scalars per group held against the plain K4
PROD_RS = [(5000, 6000)]  # the PROD proof's (r, s)
PROD_TABLES_DEADLINE_S = 600  # the host NTT tables' process is killed after this


@contextlib.contextmanager
def k4_timed(msm, rec: list):
    """Within the block, every msm.fixed_base_msm call (K4, as setup makes
    them) is timed with CUDA events: rec gets (group, n, start, end)."""
    import torch

    real = msm.fixed_base_msm

    def timed_k4(group, scalars):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(group, scalars)
        ev[1].record()
        rec.append((group, int(scalars.shape[0]), *ev))
        return out

    msm.fixed_base_msm = timed_k4
    try:
        yield
    finally:
        msm.fixed_base_msm = real


@contextlib.contextmanager
def k3_timed(msm, rec: list):
    """Within the block, every msm.msm_batched call (K3, as msm_stage makes
    them) is timed with CUDA events: rec gets (group, m, start, end)."""
    import torch

    real = msm.msm_batched

    def timed_k3(group, points, scalars, bases=None, timing=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(group, points, scalars, bases, timing)
        ev[1].record()
        rec.append((group, int(points[0].shape[0]), *ev))
        return out

    msm.msm_batched = timed_k3
    try:
        yield
    finally:
        msm.msm_batched = real


def ntt_host_tables(k: int, path: str):
    """The host twiddle and coset tables of prover/ntt.py at domain 2^k
    (_root_powers(k, False) and _coset_powers(k, w_{2n}, False), as a
    prove's first call on the CPU makes them), each timed, and the SHA-256 of
    their bytes, written to `path` as JSON. Run in a process of its own
    beside the PROD phase (started by prod_phase), so the minute of host
    ints overlaps the card's work."""
    import hashlib

    from pob_tpu_torch.prover import ntt

    out = {"k": k}
    for name, fn in (("root_powers", lambda: ntt._root_powers(k, False)),
                     ("coset_powers", lambda: ntt._coset_powers(k, ntt.domain_root(k + 1), False))):
        t0 = time.perf_counter()
        table = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_sha256"] = hashlib.sha256(table.tobytes()).hexdigest()
        del table
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


CHILDREN = []  # helper processes of this script; killed when it exits


def start_helper(flag: str, k: int):
    """Start this script with `flag` k path (a helper mode that writes one
    JSON object to path) in a process of its own: returns (process, path)."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "chip_smoke", f"{flag.strip('-')}-{k}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(k), path],
                            cwd=root)
    CHILDREN.append(proc)
    return proc, path


def helper_result(helper, deadline_s: float, what: str) -> dict:
    """Wait at most deadline_s for a start_helper process; its JSON object."""
    proc, path = helper
    try:
        proc.wait(timeout=max(1.0, deadline_s))
    except subprocess.TimeoutExpired:
        fail(f"{what}: the helper process did not finish in time")
    if proc.returncode != 0:
        fail(f"{what}: the helper process failed ({proc.returncode})")
    with open(path) as f:
        out = json.load(f)
    os.remove(path)
    return out


def prod_phase(dev, card):
    """The production ProofOfBurn (PROD_CONFIG: 13,341,537 constraints,
    domain 2^24) on one card at batch 1, every earlier object freed:
    build_pob_cs (counts held against PROD_R1CS); setup on the card (the
    device scalars, K4, the K3 bases with the windows groth16's rule
    chooses, the plan; timed apart, K4's and K6's calls by CUDA events);
    the NTT's host tables at k = 24 timed in a process of their own and
    held against the tables made on the card; the fixture widened to
    PROD_CONFIG, its witness on the card twice (first and second call),
    wire 1 held against pob_expected_commitment, check_witness over every
    constraint on the host; one warm-up prove stage by stage and two timed
    prove_batch calls (the h-MSM by CUDA events beside its bound); verify,
    and public + 1 rejected; peak device memory through setup, the witness,
    the h stage and the MSM stage; launch counters zeroed before the setup
    and read after the timed proves. Then every kernel on this path's own
    inputs against its plain version, tolerance 0: K1 on the h stage's A.W x
    B.W, K2 on intt(A.W) (one row, 2^24), K3 on the h-MSM with scalars kept
    at PROD_SAMPLE positions, K5 on the plan kept at PROD_SAMPLE positions
    per query, K4 at PROD_K4_SAMPLE positions per group, K6 on the key's
    bases at POB_K6_SAMPLE positions per query and the plan's chains of
    POB_K6_SAMPLE full points; and the device scalars against the host ints
    at SCALAR_SAMPLE positions of L_j and h_j and wires of u / v / w.
    Returns (the prod JSON object, kernel rows)."""
    import hashlib

    import numpy as np
    import torch

    from pob_tpu_torch import _build
    from pob_tpu_torch.circuits.proof_of_burn import PROD_CONFIG
    from pob_tpu_torch.field import cuda_mont, limb
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.harness.inputs import (batch_stack, load_pob_input,
                                              pob_expected_commitment, to_device,
                                              widen_pob_input)
    from pob_tpu_torch.prover import curve, groth16, msm, ntt
    from pob_tpu_torch.r1cs.pob_circuit import build_pob_cs, pob_r1cs_witness
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

    gb, out = {}, {}

    def peak(stage):
        torch.cuda.synchronize()
        gb[stage] = torch.cuda.max_memory_allocated() / 1e9
        log(f"PROD peak device memory through {stage}: {gb[stage]:.3f} GB "
            f"(allocated now {torch.cuda.memory_allocated() / 1e9:.3f} GB)")
        torch.cuda.reset_peak_memory_stats()

    t_phase = time.perf_counter()
    gc.collect()
    ntt._on_device.cache_clear()  # the first PROD prove makes its tables, as a user's does
    msm.window_table.cache_clear()  # setup builds K4's table, as a user's first setup does
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["allocated_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    out["free_at_start_gb"] = groth16.device_free_bytes(dev) / 1e9
    log(f"PROD phase starts with {out['allocated_at_start_gb']:.3f} GB allocated, "
        f"{out['free_at_start_gb']:.3f} GB free")
    tables_helper = start_helper("--ntt-host-tables", PROD_R1CS["k"])
    t0 = time.perf_counter()
    cs = build_pob_cs(PROD_CONFIG)
    build_s = time.perf_counter() - t0
    (ra, _, _), (rb, _, _), (rc, _, _), pal = cs.matrices_indexed()
    nw, npub = cs.num_wires, cs.num_public
    k = groth16._next_pow2(cs.num_constraints + npub + 1)
    n = 1 << k
    r1cs = {"constraints": cs.num_constraints, "wires": nw,
            "nnz": len(ra) + len(rb) + len(rc), "palette": len(pal), "k": k}
    nnz = {"A": len(ra), "B": len(rb), "C": len(rc)}
    del ra, rb, rc, pal
    log(f"PROD build_pob_cs(PROD_CONFIG): {r1cs}, nnz {nnz}, {build_s:.3f} s")
    if r1cs != PROD_R1CS:
        fail(f"PROD R1CS counts {r1cs} differ from PROD_R1CS.json's {PROD_R1CS}")

    # the setup route's values kept at the positions the checks read
    wires = spread_wires(nw, SCALAR_SAMPLE, npub)
    sizes = {"a_query": nw, "b1_query": nw, "b2_query": nw, "l_query": nw - npub - 1,
             "h_query": n, "ic": npub + 1}
    pos = {"lag": spread_positions(n, SCALAR_SAMPLE), "a_query": wires, "b1_query": wires,
           "b2_query": wires, "l_query": wires[wires > npub] - npub - 1,
           "h_query": spread_positions(n, SCALAR_SAMPLE), "ic": np.arange(npub + 1)}
    for names in (groth16.G1_QUERIES, ("b2_query",)):  # and where K4's check reads
        offs = np.cumsum([0] + [sizes[q] for q in names])
        p4 = spread_positions(int(offs[-1]), PROD_K4_SAMPLE)
        q_of = np.searchsorted(offs, p4, side="right") - 1
        for qi, q in enumerate(names):
            pos[q] = np.union1d(pos[q], p4[q_of == qi] - offs[qi]).astype(np.int64)

    st, kept, k6_rec, k4_rec = {}, {}, [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with keep_setup_route(groth16, kept, pos), k6_calls(msm, k6_rec), k4_timed(msm, k4_rec):
        pk, vk = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev, timings=st)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if pk.k != k or pk.plan is None:
        fail(f"PROD setup: domain 2^{pk.k} or no plan")
    windows = groth16.bases_windows(pk)
    k6_setup = k6_setup_ms(k6_rec)
    bases_ms = k6_bases_ms(pk, k6_setup)
    k4_ms = [{"group": g, "n": m, "ms": a.elapsed_time(b)} for g, m, a, b in k4_rec]
    del k6_rec, k4_rec
    key_gb = {"bases": {q: t.numel() * t.element_size() / 1e9 for q, t in pk.bases.items()},
              "jacobian": sum(c.numel() * c.element_size() for q, _ in groth16.MSM_QUERIES
                              for c in getattr(pk, q)) / 1e9,
              "mats": sum(t.numel() * t.element_size() for m in pk.mats for t in m) / 1e9,
              "plan": pk.plan.nbytes() / 1e9}
    key_gb["total"] = (sum(key_gb["bases"].values()) + key_gb["jacobian"] + key_gb["mats"]
                       + key_gb["plan"])
    log(f"PROD setup_s {setup_s:.3f} (scalars {st['scalars_s']:.3f}, K4 {st['k4_s']:.3f}, "
        f"bases {st['bases_s']:.3f}, plan {st['plan_s']:.3f}); the K3 bases' windows "
        f"{windows}; key GB {json.dumps(key_gb)}; K4 calls {k4_ms}; K6 calls " + ", ".join(
            f"({c['windows']}, {c['dbl']}) {c['m']} {c['group'].upper()} {c['ms']:.1f} ms"
            for c in k6_setup))
    peak("setup")
    mark("PROD setup done")

    # the widened fixture's witness on the card, twice; the host check
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "pob_input.json")
    with open(fix) as f:
        raw = widen_pob_input(json.load(f), PROD_CONFIG)
    expected = pob_expected_commitment(raw, PROD_CONFIG)
    kw = to_device(batch_stack([load_pob_input(raw, PROD_CONFIG)]), dev)
    W, witness_s = timed(lambda: assemble_witness(cs, pob_r1cs_witness(PROD_CONFIG, **kw)))
    W2, witness2_s = timed(lambda: assemble_witness(cs, pob_r1cs_witness(PROD_CONFIG, **kw)))
    if not torch.equal(W, W2):
        fail("PROD: the second witness differs from the first")
    del W2, kw
    peak("witness")
    wire1 = limb.limb_rows_to_ints(W[:, 1].cpu().numpy())[0]
    if wire1 != expected:
        fail("PROD witness wire 1 differs from pob_expected_commitment")
    t0 = time.perf_counter()
    w_ints = limb.limb_rows_to_ints(W[0].cpu().numpy())
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cs.check_witness(w_ints):
        fail(f"PROD witness violates constraints {cs.failing_constraints(w_ints)}")
    check_s = time.perf_counter() - t0
    del w_ints
    log(f"PROD witness_s {witness_s:.3f} (first call), {witness2_s:.3f} (second, the same "
        f"witness); wire 1 == the expected commitment {expected}; check_witness over all "
        f"{cs.num_constraints} constraints passed in {check_s:.3f} s (decoding "
        f"{decode_s:.3f} s)")

    mark("PROD witness and its host check done")
    # one warm-up prove stage by stage, then two timed prove_batch calls
    h = groth16.compute_h(pk.k, pk.mats, W)
    peak("h stage")
    sums = groth16.msm_stage(pk, W, h)
    peak("MSM stage")
    del sums
    nz_h = int((msm.scalar_digits(h) != 0).sum())
    del h
    (h_bms, h_by), _ = msm_bounds("g1", 1, n, nz_h, windows["h_query"])
    runs = []
    for _ in range(2):
        tm, rec = {}, []
        with k3_timed(msm, rec):
            t0 = time.perf_counter()
            proofs = groth16.prove_batch(pk, W, rs=PROD_RS, timings=tm)
            torch.cuda.synchronize()
            tm["prove_s"] = time.perf_counter() - t0
        tm["h_msm_ms"] = sum(a.elapsed_time(b) for g, m, a, b in rec if m == n)
        tm["h_msm_bound_ms"] = h_bms
        runs.append(tm)
        log(f"PROD timed prove: h_s {tm['h_s']:.4f} msm_s {tm['msm_s']:.4f} h-MSM "
            f"{tm['h_msm_ms']:.3f} ms (bound {h_bms:.3f}, {h_by}) prove_s "
            f"{tm['prove_s']:.4f}, chunk {tm['chunk']}")
    counts = dict(_build.LAUNCHES)
    log(f"PROD launches (setup, witness x2, warm-up, 2 timed proves): {counts}")
    for key in ("mont", "ntt", "msm", "fixed_base", "fixed_base_table", "chains",
                "bitsum_g1", "bitsum_g2"):
        if counts[key] <= 0:
            fail(f"kernel {key} was not launched on the PROD path")
    t0 = time.perf_counter()
    if not groth16.verify(vk, proofs[0], [expected]):
        fail("PROD proof does not verify")
    if groth16.verify(vk, proofs[0], [(expected + 1) % FR_MOD]):
        fail("PROD proof verifies with public + 1")
    verify_s = time.perf_counter() - t0
    log(f"PROD verify: the proof accepted, public + 1 rejected ({verify_s:.1f} s)")

    mark("PROD proves and verify done")
    # the NTT's host tables at k = 24 (their own process) against the card's
    tables = {}
    for name, fn in (("root_powers", lambda: ntt._root_powers_dev(k, False, dev)),
                     ("coset_powers",
                      lambda: ntt._coset_powers_dev(k, ntt.domain_root(k + 1), False, dev))):
        t, tables[f"{name}_card_s"] = timed(fn)
        tables[f"{name}_card_sha256"] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
        del t
    host = helper_result(tables_helper, PROD_TABLES_DEADLINE_S - (time.perf_counter() - t_phase),
                         "PROD: the host NTT tables")
    for name in ("root_powers", "coset_powers"):
        if host[f"{name}_sha256"] != tables[f"{name}_card_sha256"]:
            fail(f"PROD: the {name} table made on the card differs from the host table")
        tables[f"{name}_host_s"] = host[f"{name}_s"]
    log(f"PROD NTT tables at k = {k}: made on the card equal to the host tables; seconds "
        + json.dumps({k_: v for k_, v in tables.items() if k_.endswith("_s")}))

    rows = []
    gb_checks = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the setup route's values against the host ints at the kept positions
    setup_route = scalar_checks("PROD", cs, k, kept, wires)

    mark("PROD setup route check done")
    # K1 on the h stage's A.W x B.W (2^24), plain in chunks of 2^20
    (aw, ta), (bw, tb) = (timed(lambda: groth16.sparse_matvec_mont(m, W, n)) for m in pk.mats[:2])
    fa, fb = aw.reshape(-1, limb.L), bw.reshape(-1, limb.L)
    kern = cuda_mont.field_op(cuda_mont.MUL, limb.FR, fa, fb)
    k1_pm = 0.0
    for o in range(0, fa.shape[0], 1 << 20):
        c = slice(o, o + (1 << 20))
        want, ms = once_ms(lambda: limb.mont_mul_plain(limb.FR, fa[c], fb[c]))
        k1_pm += ms
        exact(f"K1 PROD A.W x B.W elements [{o}, ...)", kern[c], want)
    k1_ms = cuda_ms(lambda: cuda_mont.field_op(cuda_mont.MUL, limb.FR, fa, fb), 10)
    bms, by = bound(3 * 64 * fa.shape[0], fa.shape[0])
    log(f"K1 PROD h-stage product (2^{k} Fr pairs) exact: kernel_ms {k1_ms:.4f} plain_ms "
        f"{k1_pm:.1f} bound_ms {bms:.4f} ({by}); the mat-vecs alone A {ta:.4f} s, B {tb:.4f} s")
    rows.append({"name": "K1 mont (PROD: Fr mul, the h stage's A.W x B.W)", "key": "mont",
                 "route": "cuda", "source": "pob_tpu_torch/csrc/mont.cu",
                 "replaces": "pob_tpu/field/pallas_mont.py:107", "max_abs_err": 0, "ms": k1_ms,
                 "plain_ms": k1_pm, "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "shape": f"1 x 2^{k} Fr pairs"})
    del kern, want, fa, fb, bw
    gb_checks["K1"] = torch.cuda.max_memory_allocated() / 1e9

    mark("PROD K1 check done")
    # K2 on intt(A.W): one row of 2^24, three passes, the inverse table made on the card
    roots = ntt._table(ntt._root_powers, k, True, like=aw)
    kern = ntt.ntt_stages_cuda(aw, k, roots, gather=True)
    want, k2_pm = once_ms(lambda: ntt._transform_plain(
        aw.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev)), k, roots))
    exact(f"K2 PROD intt(A.W) at k = {k}", kern, want)
    del kern, want
    k2_ms = cuda_ms(lambda: ntt.ntt_stages_cuda(aw, k, roots, gather=True), 5)
    bms, by = bound(2 * n * 64 + n // 2 * 64, k * n // 2)
    log(f"K2 PROD intt(A.W) stages (1 row x 2^{k}, passes {ntt.ntt_passes(k)}, with the gather) "
        f"exact: kernel_ms {k2_ms:.4f} plain_ms {k2_pm:.1f} bound_ms {bms:.4f} ({by})")
    rows.append({"name": f"K2 ntt (PROD: the h stage's intt(A.W), {len(ntt.ntt_passes(k))} "
                         f"passes)", "key": "ntt", "route": "cuda",
                 "source": "pob_tpu_torch/csrc/ntt.cu", "replaces": "pob_tpu/prover/ntt.py:61",
                 "max_abs_err": 0, "ms": k2_ms, "plain_ms": k2_pm, "bound_ms": bms,
                 "bound_by": by, "library_ms": None, "shape": f"1 row x 2^{k}"})
    del aw, roots
    gb_checks["K2"] = torch.cuda.max_memory_allocated() / 1e9

    mark("PROD K2 check done")
    # K3 on the h-MSM at the key's windows: scalars kept at PROD_SAMPLE
    # positions spread over [0, 2^24), the last included; the whole h-MSM timed
    h = groth16.compute_h(pk.k, pk.mats, W)
    keep = torch.from_numpy(spread_positions(n, PROD_SAMPLE)).to(dev)
    hs = torch.zeros_like(h)
    hs[:, keep] = h[:, keep]
    S = windows["h_query"]
    msm.msm_batched("g1", pk.h_query, hs, pk.bases["h_query"])
    (kern, km3), (plain, pm3) = (
        once_ms(lambda: msm.msm_batched("g1", pk.h_query, hs, pk.bases["h_query"])),
        once_ms(lambda: msm.msm_plain(curve.ops_for("g1"), pk.h_query, hs)))
    same_points(f"K3 PROD h-MSM sampled (S = {S})", "g1", kern, plain)
    nz_s = int((msm.scalar_digits(hs) != 0).sum())
    del hs, kern, plain
    hm = cuda_ms(lambda: msm.msm_batched("g1", pk.h_query, h, pk.bases["h_query"]), 3)
    (bms, by), (bms_full, _) = msm_bounds("g1", 1, n, nz_h, S)
    (sbms, _), _ = msm_bounds("g1", 1, n, nz_s, S)
    log(f"K3 PROD h-MSM (S = {S}: {32 // S} passes) sampled at {PROD_SAMPLE} positions exact "
        f"(kernel_ms {km3:.3f} plain_ms {pm3:.3f}); whole B=1 m={n} ({nz_h} nonzero digits): "
        f"kernel_ms {hm:.3f} bound_ms {bms:.3f} ({by}; {bms_full:.3f} with a full add per "
        f"digit)")
    rows.append({"name": f"K3 msm (PROD h-MSM: G1, B=1 x 2^{k}, S={S})", "key": "msm",
                 "route": "cuda", "source": "pob_tpu_torch/csrc/msm.cuh",
                 "replaces": "pob_tpu/prover/msm.py:92", "max_abs_err": 0, "ms": hm,
                 "plain_ms": pm3, "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "shape": f"B=1 x 2^{k} G1 points, bases of {S} shifted windows "
                          f"({32 // S} passes)",
                 "checked_on": f"the same h with scalars kept at {PROD_SAMPLE} positions (last "
                               f"included), the rest 0: plain_ms is the plain version's, "
                               f"sampled_ms the kernel's, sampled_bound_ms its bound",
                 "sampled_ms": km3, "sampled_bound_ms": sbms})
    del h
    gb_checks["K3"] = torch.cuda.max_memory_allocated() / 1e9

    mark("PROD K3 check done")
    # K5 on the plan kept at PROD_SAMPLE positions per query; K6's chains
    # on POB_K6_SAMPLE full points of each query; K6's bases at (S, 8)
    keep_full = torch.from_numpy(spread_positions(
        max(int(pk.plan.g1.counts[:, 1].max()), int(pk.plan.g2.counts[:, 1].max())),
        POB_K6_SAMPLE)).to(dev)
    pinfo = {}
    for group, _, g in plan_groups(pk):
        torch.cuda.empty_cache()
        keep_pos = torch.from_numpy(spread_positions(g.pts.shape[1], PROD_SAMPLE)).to(dev)
        r_, i_ = plan_checks(pk, W, "PROD", keep_pos=keep_pos, keep_full=keep_full,
                             groups=(group,))
        rows += r_
        pinfo.update(i_)
    gb_checks["K5"] = torch.cuda.max_memory_allocated() / 1e9
    mark("PROD K5 and K6 chains checks done")
    rows += bases_checks(pk, "PROD", POB_K6_SAMPLE, call_ms=bases_ms)
    mark("PROD K6 bases check done")

    # K4 at PROD_K4_SAMPLE positions per group of the setup's own scalars;
    # its time from the setup's own calls
    torch.cuda.empty_cache()
    W = W.cpu()
    for (group, names, n4, npos, pm4), call in zip(
            k4_sampled_check("PROD", dev, pk, vk, kept, PROD_K4_SAMPLE, PROD_K4_SAMPLE),
            k4_ms):
        nz4 = sum(kept["digits"][q][0] for q in names)
        nz_scalars = sum(kept["digits"][q][1] for q in names)
        if call["group"] != group or call["n"] != n4:
            fail(f"PROD: K4's setup calls are not one per group: {k4_ms}")
        nbytes = n4 * 64 + n4 * 3 * COORD_BYTES[group] + 8192 * 2 * COORD_BYTES[group] // 2
        bms, by = bound(nbytes, (nz4 - nz_scalars) * MADD_MULS[group])
        bms_full, _ = bound(nbytes, nz4 * ADD_MULS[group])
        log(f"K4 PROD {group} setup queries {'+'.join(names)} (n={n4}, {nz4} nonzero digits): "
            f"exact at {npos} positions (plain_ms {pm4:.3f}); the setup's call {call['ms']:.3f} "
            f"ms bound_ms {bms:.3f} ({by}) {bms_full:.3f} (a full add per digit)")
        rows.append({"name": f"K4 fixed_base (PROD: {group.upper()} window, the setup's "
                             f"{group.upper()} queries)", "key": "fixed_base", "route": "cuda",
                     "source": "pob_tpu_torch/csrc/fixed_base.cu",
                     "replaces": "pob_tpu/prover/msm.py:248", "max_abs_err": 0,
                     "ms": call["ms"], "plain_ms": pm4, "bound_ms": bms, "bound_by": by,
                     "bound_ms_full_adds": bms_full, "library_ms": None,
                     "shape": f"{n4} {group.upper()} scalars (the setup's call)",
                     "plain_shape": f"{npos} of them, spread over [0, {n4}), the last "
                                    f"included"})
    del kept
    out.update({"r1cs": r1cs, "nnz": nnz, "build_s": build_s, "setup_s": setup_s,
                **{f"setup_{k_}": v for k_, v in st.items()}, "windows": windows,
                "key_gb": key_gb, "k4_calls": k4_ms, "k6_setup_calls": k6_setup,
                "ntt_tables": tables, "witness_s": witness_s, "witness2_s": witness2_s,
                "commitment": str(expected), "check_witness_s": check_s,
                "witness_decode_s": decode_s, "timed_proves": runs, "verify": True,
                "reject_public_plus_one": True, "verify_s": verify_s, "peak_gb": gb,
                "peak_gb_checks": gb_checks, "plan": pinfo, "setup_route_check": setup_route,
                "launches": counts, "phase_s": time.perf_counter() - t_phase})
    for row in rows:
        row["launches"] = counts[row.pop("key")]
    return out, rows


def cli_phase(dev) -> dict:
    """The command line at full width on Spend (domain 2^18), in-process
    through cli.main: setup (zkey, r1cs, vk), witness (wtns), prove (from
    the zkey), verify (0, and 1 on a tampered public.json), export-verifier
    (from the zkey; the .sol parses back to the vk) and grind (2 zero
    bytes). Launch counters zeroed before; K1-K4 must each have run."""
    import numpy as np
    import torch

    from pob_tpu_torch import _build, cli
    from pob_tpu_torch.field import limb
    from pob_tpu_torch.harness import pow_grind
    from pob_tpu_torch.harness.inputs import load_spend_input
    from pob_tpu_torch.prover import msm, serialize
    from pob_tpu_torch.prover.solidity import parse_solidity_vk
    from pob_tpu_torch.r1cs.spend_circuit import build_spend_cs, spend_full_witness

    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, "build", "chip_smoke", "cli")
    os.makedirs(d, exist_ok=True)
    f = {k: os.path.join(d, k) for k in ("spend.zkey", "spend.r1cs", "vk.json", "spend.wtns",
                                          "proof.json", "public.json", "bad_public.json",
                                          "verifier.sol")}
    fix = os.path.join(root, "tests", "fixtures", "spend_input.json")
    secs = {}

    def run(name, argv, want=0):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if rc != want:
            fail(f"cli {name}: returned {rc}, expected {want}")

    msm.window_table.cache_clear()  # setup builds K4's table, as a user's first setup does
    torch.cuda.synchronize()
    _build.reset_launches()
    run("setup", ["setup", "--circuit", "spend", "--zkey", f["spend.zkey"], "--r1cs",
                  f["spend.r1cs"], "--vk", f["vk.json"]])
    run("witness", ["witness", "--circuit", "spend", "--input", fix, "--wtns", f["spend.wtns"]])
    run("prove", ["prove", "--circuit", "spend", "--input", fix, "--zkey", f["spend.zkey"],
                  "--proof", f["proof.json"], "--vk", f["vk.json"]])
    counts = dict(_build.LAUNCHES)
    for key, n in counts.items():  # prove reads the zkey: the plain path, as pob_tpu's cli
        if n <= 0 and not key.startswith("bitsum"):
            fail(f"kernel {key} was not launched by the cli's setup, witness and prove")
    run("verify", ["verify", "--vk", f["vk.json"], "--proof", f["proof.json"], "--public",
                   f["public.json"]])
    with open(f["public.json"]) as fh:
        pub = json.load(fh)
    with open(f["bad_public.json"], "w") as fh:
        json.dump([str(int(pub[0]) + 1)], fh)
    run("verify_tampered", ["verify", "--vk", f["vk.json"], "--proof", f["proof.json"],
                            "--public", f["bad_public.json"]], want=1)
    run("export_verifier", ["export-verifier", "--zkey", f["spend.zkey"], "--out",
                            f["verifier.sol"], "--proof", f["proof.json"], "--public",
                            f["public.json"]])
    with open(f["vk.json"]) as fh:
        vk = serialize.snarkjs_to_vk(json.load(fh))
    with open(f["verifier.sol"]) as fh:
        if parse_solidity_vk(fh.read())[1] != (vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, vk.ic):
            fail("cli export-verifier: the .sol does not parse back to the vk")
    run("grind", ["grind", "--zero-bytes", "2"])

    cs = build_spend_cs()
    inp = load_spend_input(fix)
    w = spend_full_witness(*[limb.to_device(limb.ints_to_limbs([inp[k]]), dev) for k in
                             ("burn_key", "balance", "withdrawn", "extra_commitment")])[0]
    if serialize.read_wtns(f["spend.wtns"])[1] != limb.limb_rows_to_ints(w.cpu().numpy()):
        fail("cli witness: the .wtns differs from spend_full_witness on the card")
    r1 = serialize.read_r1cs(f["spend.r1cs"])
    terms = [sum(len(c[i]) for c in r1["constraints"]) for i in range(3)]
    nnz = [len(m[0]) for m in cs.matrices_indexed()[:3]]
    if (r1["num_constraints"], r1["num_wires"], r1["num_public_out"], terms) != (
            cs.num_constraints, cs.num_wires, cs.num_public, nnz):
        fail("cli setup: the .r1cs does not read back to build_spend_cs's counts")
    if pub != [str(int(x)) for x in limb.limb_rows_to_ints(w[1:2].cpu().numpy())]:
        fail("cli prove: public.json is not the witness's public wire")
    out = {"s": secs, "zkey_bytes": os.path.getsize(f["spend.zkey"]),
           "r1cs_bytes": os.path.getsize(f["spend.r1cs"]),
           "wtns_bytes": os.path.getsize(f["spend.wtns"]), "launches": counts,
           "native_grinder": pow_grind._lib() is not None,
           "r1cs": {"constraints": r1["num_constraints"], "wires": r1["num_wires"],
                    "terms": terms}}
    log(f"cli: every command returned its expected code; the .wtns equals the card's witness, "
        f"the .r1cs reads back to build_spend_cs's counts, the .sol to the vk; K1-K4 and K6 "
        f"launched {counts}")
    return out


def k5_k6_key(label, cs, W, rs, pubs, zkey=False) -> dict:
    """--k5-k6 on one circuit: setup (its K6 calls timed with CUDA events,
    peak device memory), K6 at (32, 8) per query as setup calls it, K6's
    chains per group (3 calls), K5 per group (3 calls; one more with its
    per-launch times), msm_s of two timed proves on the planned path and
    on the plain one after a warm-up of each (the same proofs); with zkey,
    the key through a .zkey: load_zkey's time, peak and K6 calls."""
    import torch

    from pob_tpu_torch.prover import bitsum, groth16, msm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, rec = {}, []
    with k6_calls(msm, rec):
        (pk, vk), setup_s = timed(lambda: groth16.setup(cs, rng=iter(TOXIC).__next__,
                                                        device=W.device, timings=st))
    out = {"sweep_waves": getattr(bitsum, "SWEEP_WAVES", None), "setup_s": setup_s,
           "setup_parts_s": st,
           "setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "k6_setup_calls": k6_setup_ms(rec)}
    bases = {}
    for q, ms in k6_bases_ms(pk, out["k6_setup_calls"]).items():
        g = dict(groth16.MSM_QUERIES)[q]
        b = bases.setdefault(g, {"n": 0, "ms": 0.0})
        b["n"] += int(getattr(pk, q)[0].shape[0])
        b["ms"] += ms
    for g, b in bases.items():
        b["bound_ms"], _ = k6_bound(g, b["n"], msm.N_WINDOWS, msm.WINDOW_BITS)
    out["k6_bases"] = bases
    out["k6_chains"], out["k5"] = {}, {}
    for group, names, g in plan_groups(pk):
        full = plan_full_points(pk, group, names, g)
        n = int(full[0].shape[0])
        ms = cuda_ms(lambda: msm.affine_bases(group, full, bitsum.FULL_BITS, 1, True), 3)
        out["k6_chains"][group] = {"n": n, "ms": ms,
                                   "bound_ms": k6_bound(group, n, bitsum.FULL_BITS, 1)[0]}
        del full
        ms = cuda_ms(lambda: k5_call(group, g, W), 3)
        timing = []
        k5_call(group, g, W, timing)
        torch.cuda.synchronize()
        bms, _, nset = k5_bound(group, g, W)
        out["k5"][group] = {"q": int(g.pts.shape[0]), "M": int(g.pts.shape[1]),
                            "B": int(W.shape[0]), "set_bits": nset, "ms": ms, "bound_ms": bms,
                            "launches": len(timing),
                            "launch_ms": {lab: a.elapsed_time(b) for lab, a, b in timing}}
    for path, run in (("planned", lambda fn: fn()), ("plain", plain_path)):
        proofs = run(lambda: groth16.prove_batch(pk, W, rs=rs))  # warm-up
        msm_s = []
        for _ in range(2):
            tm = {}
            run(lambda: groth16.prove_batch(pk, W, rs=rs, timings=tm))
            msm_s.append(tm["msm_s"])
        out[f"msm_s_{path}"] = msm_s
        if path == "planned":
            planned = proofs
        elif proofs != planned:
            fail(f"--k5-k6 {label}: the planned proofs differ from the plain path's")
    if zkey:
        path, zk = pob_zkey_write(cs, pk, vk)
        del pk, g
        gc.collect()
        torch.cuda.empty_cache()
        rec = []
        with k6_calls(msm, rec):
            zk.update(pob_zkey_load(path, vk, W, planned, rs, pubs))
        zk["k6_calls"] = k6_setup_ms(rec)
        out["zkey"] = zk
    log(f"k5k6 {label}: " + json.dumps(out))
    return out


def k5_k6_mode(dev, card) -> dict:
    """--k5-k6: K5's and K6's times through entry points every tree of the
    port since the planned path has (groth16.setup with timings,
    msm.affine_bases, bitsum.bitsum_msm, groth16.prove_batch, write_zkey,
    load_zkey), so a copy of this script in the root of an older tree
    times that tree's kernels the same way: Spend (2^18, B = 16), then PoB
    (TEST_CONFIG, 2^22, B = 4) with its key through a .zkey."""
    import torch

    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG
    from pob_tpu_torch.r1cs.pob_circuit import build_pob_cs, pob_r1cs_witness
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness, build_spend_cs, spend_witness

    out = {"card": card}
    cs = build_spend_cs()
    args, pubs = spend_batch(dev, 16)
    W = assemble_witness(cs, spend_witness(*args))
    out["spend"] = k5_k6_key("spend", cs, W, [(1000 + i, 2000 + i) for i in range(16)], pubs)
    del cs, args, W
    gc.collect()
    cs = build_pob_cs(TEST_CONFIG)
    kw, pubs = pob_batch(TEST_CONFIG, dev, POB_BATCH)
    W = assemble_witness(cs, pob_r1cs_witness(TEST_CONFIG, **kw))
    del kw
    out["pob"] = k5_k6_key("pob", cs, W, [(3000 + i, 4000 + i) for i in range(POB_BATCH)],
                           pubs, zkey=True)
    return out


def setup_routes_mode(dev, card) -> dict:
    """--setup-routes: the PoB key (TEST_CONFIG, 2^22) set up twice in one
    process with the same toxic waste, through groth16.setup_host (the
    host-int scalars) and through groth16.setup (the device scalars), each
    timed by part (synchronized); the two keys must be equal (the SHA-256 of
    their query points, matrices and vk). The host-int key is freed before
    the second setup."""
    import hashlib

    import torch

    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG
    from pob_tpu_torch.prover import groth16
    from pob_tpu_torch.r1cs.pob_circuit import build_pob_cs

    cs = build_pob_cs(TEST_CONFIG)
    out = {"card": card}
    digests = {}
    for name, fn in (("setup_host", groth16.setup_host), ("setup", groth16.setup)):
        gc.collect()
        torch.cuda.empty_cache()
        st = {}
        (pk, vk), setup_s = timed(lambda: fn(cs, rng=iter(TOXIC).__next__, device=dev,
                                             timings=st))
        h = hashlib.sha256(repr((vk.ic, vk.gamma2, vk.delta2, pk.alpha1)).encode())
        for q, _ in groth16.MSM_QUERIES:
            for c in getattr(pk, q):
                h.update(c.cpu().numpy().tobytes())
        for m in pk.mats:
            for t in m:
                h.update(t.cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
        out[name] = {"setup_s": setup_s, **st}
        log(f"setup routes: {name} setup_s {setup_s:.3f} " + json.dumps(st))
        del pk, vk
    if digests["setup_host"] != digests["setup"]:
        fail("setup routes: setup and setup_host gave different keys")
    out["same_key"] = True
    return out


DIST_MESHES = (1, 2, 4)  # shards of the virtual meshes of the card in the dist phase
DIST_REQUESTS = 4  # Spend requests per prove_stream


def h_body_bound(k: int):
    """The sharded h stage's least work after the mat-vecs (pob_tpu's
    _h_body, compute_h's tail): six transforms of k n / 2 butterfly products
    and n twiddle products each, the two 1/N_i scales of each inverse
    four-step (2 n each), the coset scales (3 n), C = A.B, A.B and the REDC
    out of Montgomery form (n each): 72 n at k = 18; bytes: A.w and B.w in,
    h out."""
    n = 1 << k
    ops = 6 * (k * n // 2 + n) + 3 * 2 * n + 3 * n + 3 * n
    return bound(3 * n * 64, ops)


def four_step_bound(k: int, inverse: bool):
    """One four-step transform of 2^k elements: k n / 2 butterfly products,
    n twiddle products (and 2 n for the small inverse transforms' scales);
    bytes: the vector in and out."""
    n = 1 << k
    return bound(2 * n * 64, k * n // 2 + n + (2 * n if inverse else 0))


def dist_phase(dev, card, pk, vk, W, h, rs, proofs, pubs) -> dict:
    """The multi-device layer at the main path's size (Spend, 2^18) on
    virtual meshes of the card, data_mesh(D, device=card) for D = 1, 2, 4:
    the four-step NTT and its inverse at (k1, k2) = _split_k(18, D) on a
    random Montgomery vector against the local K2 transform; shard_pk (the
    h permutation, each shard's K3 bases by K6); msm_sharded of the h query
    over proof 0's h (permuted as the sharded key's points) against the
    local K3 h-MSM; compute_h_sharded against compute_h[perm]; prove_sharded
    of witnesses 0 and 1 at their (r, s) against prove_batch's proofs; then
    Groth16Pipeline on [card] * 3 and [card] * 6 (an MSM group of 4 shards)
    over DIST_REQUESTS Spend requests from the fixture with the same (r, s),
    against prove_batch's proofs; then dryrun_multichip(4, card). Every
    check exact. Launch counters zeroed before, K1, K2, K3 and K6 must each
    have run. Times: CUDA events for the transforms, the MSMs and the h
    stage (each beside the same work on one device), the host clock
    (synchronized) for shard_pk, the proves and the streams; the copies of
    the collectives alone at D = 4; peak device memory."""
    import numpy as np
    import torch

    import graft_entry_torch
    from pob_tpu_torch import _build
    from pob_tpu_torch.dist.mesh import all_to_all, data_mesh, gather, shard
    from pob_tpu_torch.dist.msm_sharded import msm_sharded
    from pob_tpu_torch.dist.ntt_sharded import (_outer_twiddle, four_step_local, ntt_sharded,
                                                table_shards, untranspose_host)
    from pob_tpu_torch.dist.pipeline import Groth16Pipeline, spend_witness_stage
    from pob_tpu_torch.dist.prove_sharded import (_split_k, compute_h_sharded, h_permutation,
                                                  prove_sharded, shard_pk)
    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import curve, groth16, msm, ntt

    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    k, n = pk.k, 1 << pk.k
    out = {"card": card, "k": k, "meshes": {}}
    x = make_rand(dev, 20261)((n,))
    local = {False: ntt.ntt(x, k), True: ntt.intt(x, k)}
    local_host = {inv: v.cpu().numpy() for inv, v in local.items()}
    h0 = h[0].contiguous()
    h_local = groth16.compute_h(k, pk.mats, W[:1])[0]
    want_h = curve.to_affine_host("fq", tuple(c[0] for c in msm.msm_batched(
        "g1", pk.h_query, h0[None], pk.bases["h_query"])))
    nz = int((msm.scalar_digits(h0) != 0).sum())
    out["local"] = {
        "ntt_ms": cuda_ms(lambda: ntt.ntt(x, k), 5),
        "intt_ms": cuda_ms(lambda: ntt.intt(x, k), 5),
        "h_msm_ms": cuda_ms(lambda: msm.msm_batched("g1", pk.h_query, h0[None],
                                                    pk.bases["h_query"]), 3),
        "compute_h_ms": cuda_ms(lambda: groth16.compute_h(k, pk.mats, W[:1]), 3),
        "h_nonzero_digits": nz}
    for label, fn in (("prove_s", lambda: groth16.prove(pk, W[0], *rs[0])),
                      ("prove_plain_s", lambda: plain_path(lambda: groth16.prove(pk, W[0],
                                                                                 *rs[0])))):
        fn()
        p, out["local"][label] = timed(fn)
        if p != proofs[0]:
            fail(f"dist: prove ({label}) differs from prove_batch's proof 0")
    b_ntt, b_intt = four_step_bound(k, False), four_step_bound(k, True)
    b_msm = msm_bounds("g1", 1, n, nz)[0]
    b_h = h_body_bound(k)
    out["bounds_ms"] = {"four_step_ntt": b_ntt, "four_step_intt": b_intt, "h_msm": b_msm,
                        "h_body": b_h, "local_ntt": bound(2 * n * 64 + n // 2 * 64, k * n // 2),
                        "shard_pk_bases": [k6_bound(g, int(getattr(pk, q)[0].shape[0]), 32, 8)
                                           for q, g in groth16.MSM_QUERIES]}

    for D in DIST_MESHES:
        mesh = data_mesh(D, device=dev)
        k1, k2 = _split_k(k, D)
        rec = {"k1": k1, "k2": k2}
        for inverse in (False, True):
            c = ntt_sharded(mesh, x, k1, k2, inverse=inverse)
            if not np.array_equal(untranspose_host(c), local_host[inverse]):
                fail(f"dist D={D}: four-step {'inverse ' if inverse else ''}NTT differs from "
                     "the local K2 transform")
        # the four-step as the sharded prove runs it: tables already on the
        # shards, the input's column shards copied in the timed call
        for key, inverse in (("ntt_ms", False), ("intt_ms", True)):
            tws = table_shards(mesh, _outer_twiddle(k1, k2, inverse), 1)
            rec[key] = cuda_ms(lambda: four_step_local(
                mesh, shard(mesh, x.reshape(1 << k1, 1 << k2, -1), 1), tws, k1, k2, inverse), 5)
        del tws
        spk, rec["shard_pk_s"] = timed(lambda: shard_pk(pk, mesh))
        perm = torch.from_numpy(h_permutation(spk.k1, spk.k2)).to(dev)
        hp = h0[perm]
        got = msm_sharded(mesh, spk.queries["h"], hp)
        if curve.to_affine_host("fq", got) != want_h:
            fail(f"dist D={D}: sharded h-MSM differs from the local K3 h-MSM")
        rec["h_msm_ms"] = cuda_ms(lambda: msm_sharded(mesh, spk.queries["h"], hp), 3)
        if not torch.equal(torch.cat(compute_h_sharded(spk, W[0])), h_local[perm]):
            fail(f"dist D={D}: compute_h_sharded differs from compute_h[perm]")
        rec["compute_h_sharded_ms"] = cuda_ms(lambda: compute_h_sharded(spk, W[0]), 3)
        rec["prove_sharded_s"] = []
        for i in (0, 1):
            p, s = timed(lambda: prove_sharded(spk, W[i], *rs[i]))
            if p != proofs[i]:
                fail(f"dist D={D}: prove_sharded of witness {i} differs from prove_batch's")
            rec["prove_sharded_s"].append(s)
        if D == DIST_MESHES[-1]:
            for i, p in enumerate(proofs[:2]):  # the sharded proofs, equal to these
                if not groth16.verify(vk, p, [pubs[i]]):
                    fail(f"dist: sharded proof {i} does not verify")
            if groth16.verify(vk, proofs[0], [(pubs[0] + 1) % FR_MOD]):
                fail("dist: a sharded proof verifies with a tampered public input")
            # launches of one call of each sharded function, and the collectives' copies alone
            calls = {"ntt_sharded": lambda: ntt_sharded(mesh, x, k1, k2),
                     "msm_sharded_h": lambda: msm_sharded(mesh, spk.queries["h"], hp),
                     "compute_h_sharded": lambda: compute_h_sharded(spk, W[0]),
                     "shard_pk": lambda: shard_pk(pk, mesh)}
            rec["launches_per_call"] = {}
            for name, fn in calls.items():
                before = dict(_build.LAUNCHES)
                fn()
                rec["launches_per_call"][name] = {key: v - before[key]
                                                  for key, v in _build.LAUNCHES.items()
                                                  if v != before[key]}
            blocks = [make_rand(dev, 20262 + s)((D, (1 << k1) // D, (1 << k2) // D))
                      for s in range(D)]
            parts = [make_rand(dev, 20270 + s)((1,))[0] for s in range(D)]
            rec["all_to_all_ms"] = cuda_ms(lambda: all_to_all(mesh, blocks, 0, 1), 5)
            rec["gather_ms"] = cuda_ms(lambda: [gather(mesh, parts) for _ in range(3)], 5)
        del spk
        gc.collect()
        out["meshes"][D] = rec
        log(f"dist D={D}: four-step NTT/iNTT, sharded h-MSM, compute_h_sharded, prove_sharded "
            f"of witnesses 0, 1 exact; {json.dumps(rec)}")

    reqs, _ = spend_cases(DIST_REQUESTS)
    fn = spend_witness_stage(dev)
    out["pipeline"] = {}
    for ndev in (3, 6):
        pipe, init_s = timed(lambda: Groth16Pipeline(pk, fn, devices=[dev] * ndev))
        got, s = timed(lambda: pipe.prove_stream(reqs, rs[:DIST_REQUESTS]))
        if got != proofs[:DIST_REQUESTS]:
            fail(f"dist: the pipeline on {ndev} devices differs from prove_batch's proofs")
        out["pipeline"][ndev] = {"init_s": init_s, "stream_s": s,
                                 "s_per_proof": s / DIST_REQUESTS}
        del pipe
    log(f"dist pipeline: {DIST_REQUESTS} proofs on [card] * 3 and * 6 equal prove_batch's: "
        f"{json.dumps(out['pipeline'])}")
    _, out["dryrun_s"] = timed(lambda: graft_entry_torch.dryrun_multichip(4, device=dev))
    counts = dict(_build.LAUNCHES)
    for key in ("mont", "ntt", "msm", "chains"):
        if counts[key] <= 0:
            fail(f"kernel {key} was not launched in the dist phase")
    out["launches"] = counts
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    return out



MULTIHOST_PROOFS = 2  # Spend witnesses proved by prove_sharded in the multihost phase
MULTIHOST_TIMEOUT_S = 120  # init_process_group's timeout in every rank
MULTIHOST_DEADLINE_S = 240  # the multihost phase's ranks are killed after this


def multihost_phase(card, pk, vk, W, rs, proofs, pubs) -> dict:
    """Phase 8: the dist layer on a mesh across processes, one NCCL rank per
    visible card (torch.cuda.device_count() ranks, each a process of this
    script with --multihost-rank, started with subprocess, never fork). The
    kernels are already built; the Spend key reaches the ranks through
    save_pk, the first MULTIHOST_PROOFS witnesses and their (r, s) through
    files, all under build/chip_smoke/multihost/ (deleted afterwards). Each
    rank (multihost_rank) checks its own results exactly and writes them;
    here every rank's prove_sharded proofs must equal prove_batch's (the
    plain path's; verified, a tampered public rejected), and K1, K2, K3 and
    K6 must each have run in every rank. A rank that fails, or a world that
    passes MULTIHOST_DEADLINE_S, kills the others and fails the phase."""
    import shutil
    import socket

    import numpy as np
    import torch

    from pob_tpu_torch.field.ref import FR_MOD
    from pob_tpu_torch.prover import groth16

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, "build", "chip_smoke", "multihost")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    want = proofs[:MULTIHOST_PROOFS]
    for i, p in enumerate(want):
        if not groth16.verify(vk, p, [pubs[i]]):
            fail(f"multihost: proof {i} of prove_batch does not verify")
    if groth16.verify(vk, want[0], [(pubs[0] + 1) % FR_MOD]):
        fail("multihost: a proof verifies with a tampered public input")
    t0 = time.perf_counter()
    groth16.save_pk(os.path.join(d, "pk.npz"), pk, vk)
    save_s = time.perf_counter() - t0
    np.save(os.path.join(d, "witnesses.npy"), W[:MULTIHOST_PROOFS].cpu().numpy())
    with open(os.path.join(d, "rs.json"), "w") as f:
        json.dump([list(x) for x in rs[:MULTIHOST_PROOFS]], f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank is on this host
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-rank",
                               str(r), str(world), str(port), d],
                              cwd=root, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        while any(p.poll() is None for p in procs):
            if (time.perf_counter() - t0 > MULTIHOST_DEADLINE_S
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    world_s = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                log(f"multihost rank {r} (exit {rcs[r]}), its output's end:\n{f.read()[-4000:]}")
        fail(f"multihost: ranks exited {rcs} after {world_s:.1f} s "
             f"(deadline {MULTIHOST_DEADLINE_S} s)")
    ranks = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    want = json.loads(json.dumps(want))
    for r, res in enumerate(ranks):
        if res.pop("proofs") != want:
            fail(f"multihost: rank {r}'s prove_sharded proofs differ from prove_batch's")
        for key in ("mont", "ntt", "msm", "chains"):
            if res["launches"][key] <= 0:
                fail(f"multihost: kernel {key} was not launched in rank {r}")
    shutil.rmtree(d)
    return {"card": card, "world": world, "backend": ranks[0]["backend"],
            "nccl": ranks[0]["nccl"], "save_pk_s": save_s, "world_s": world_s,
            "launches": {key: sum(res["launches"][key] for res in ranks)
                         for key in ranks[0]["launches"]},
            "ranks": ranks, "phase_s": time.perf_counter() - t_phase}


def multihost_rank(rank: int, world: int, port: int, d: str):
    """One rank of phase 8: join the NCCL world through init_multihost (its
    card: rank modulo the visible cards), load the key on the card, then,
    with the launch counters zeroed: shard_pk over data_mesh() (the mesh
    across processes), prove_sharded of each witness at its (r, s), the
    four-step NTT and its inverse at (9, 9) on a random Montgomery vector
    (the same on every rank), the sharded h-MSM over witness 0's h (permuted
    as the sharded key's points), each timed, and the collectives alone
    (all_to_all of the four-step's blocks, the all-gather of one Jacobian
    partial, broadcast_ints of r, s); the counters read; then against this
    card's local K2 transforms and K3 h-MSM, exactly; last,
    graft_entry_torch.dryrun_multichip over the world. Writes
    d/rank<R>.json."""
    import datetime

    import numpy as np
    import torch

    import graft_entry_torch
    from pob_tpu_torch import _build
    from pob_tpu_torch.dist.mesh import (all_to_all, broadcast_ints, data_mesh, gather,
                                         init_multihost, shard)
    from pob_tpu_torch.dist.msm_sharded import msm_sharded
    from pob_tpu_torch.dist.ntt_sharded import (_outer_twiddle, four_step_local, ntt_sharded,
                                                table_shards, untranspose_host)
    from pob_tpu_torch.dist.prove_sharded import h_permutation, prove_sharded, shard_pk
    from pob_tpu_torch.prover import curve, groth16, msm, ntt

    built = os.path.join(_build.BUILD, _build.sources_hash())
    missing = [s for s in _build.SOURCES
               if not os.path.exists(os.path.join(built, s.replace(".cu", ".so")))]
    if missing:  # the parent builds them: a rank never starts nvcc
        fail(f"multihost rank {rank}: kernels not built: {missing}")
    t0 = time.perf_counter()
    info = init_multihost(f"127.0.0.1:{port}", world, rank,
                          timeout=datetime.timedelta(seconds=MULTIHOST_TIMEOUT_S))
    mesh = data_mesh()
    dev = mesh.devices[rank]
    out = {"rank": rank, "info": info, "mesh": [str(x) for x in mesh.devices],
           "backend": torch.distributed.get_backend(), "nccl": str(torch.cuda.nccl.version()),
           "init_s": time.perf_counter() - t0}
    pk, vk = groth16.load_pk(os.path.join(d, "pk.npz"), device=dev)
    W = torch.from_numpy(np.load(os.path.join(d, "witnesses.npy"))).to(dev)
    with open(os.path.join(d, "rs.json")) as f:
        rs = json.load(f)
    k = pk.k
    k1, k2 = k // 2, k - k // 2
    x = make_rand("cpu", 20281)((1 << k,)).to(dev)  # the same vector on every rank
    out["ready_s"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    spk, out["shard_pk_s"] = timed(lambda: shard_pk(pk, mesh))
    proofs, out["prove_sharded_s"] = [], []
    for i in range(len(W)):
        p, s = timed(lambda: prove_sharded(spk, W[i], *rs[i]))
        proofs.append(p)
        out["prove_sharded_s"].append(s)
    four = {inv: untranspose_host(list(gather(mesh, ntt_sharded(mesh, x, k1, k2, inverse=inv))))
            for inv in (False, True)}
    h0 = groth16.compute_h(k, pk.mats, W[:1])[0]
    hp = h0[torch.from_numpy(h_permutation(spk.k1, spk.k2)).to(dev)]
    got_h = curve.to_affine_host("fq", msm_sharded(mesh, spk.queries["h"], hp))
    tws = table_shards(mesh, _outer_twiddle(k1, k2, False), 1)
    blocks = [make_rand(dev, 20282)((world, (1 << k1) // world, (1 << k2) // world))]
    partial = [make_rand(dev, 20283)((3, 16))]
    out["collectives_ms"] = {
        "four_step_ntt": cuda_ms(lambda: four_step_local(
            mesh, shard(mesh, x.reshape(1 << k1, 1 << k2, -1), 1), tws, k1, k2), 5),
        "msm_sharded_h": cuda_ms(lambda: msm_sharded(mesh, spk.queries["h"], hp), 3),
        "all_to_all": cuda_ms(lambda: all_to_all(mesh, blocks, 0, 1), 5),
        "all_gather_partial": cuda_ms(lambda: gather(mesh, partial), 5),
        "broadcast_ints": cuda_ms(lambda: broadcast_ints(mesh, rs[0]), 5)}
    out["launches"] = dict(_build.LAUNCHES)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    for inv, local in ((False, ntt.ntt), (True, ntt.intt)):
        if not np.array_equal(four[inv], local(x, k).cpu().numpy()):
            fail(f"multihost rank {rank}: the four-step {'inverse ' if inv else ''}NTT at "
                 f"({k1}, {k2}) differs from the local K2 transform")
    want_h = curve.to_affine_host("fq", tuple(c[0] for c in msm.msm_batched(
        "g1", pk.h_query, h0[None], pk.bases and pk.bases["h_query"])))
    if got_h != want_h:
        fail(f"multihost rank {rank}: the sharded h-MSM differs from the local K3 h-MSM")
    out["proofs"] = proofs
    _, out["dryrun_s"] = timed(lambda: graft_entry_torch.dryrun_multichip(world))
    torch.distributed.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    log(f"multihost rank {rank} of {world}: every check exact in "
        f"{time.perf_counter() - t0:.1f} s")

def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    if "--multihost-rank" in sys.argv[1:]:  # a rank of phase 8, started by multihost_phase
        i = sys.argv.index("--multihost-rank")
        multihost_rank(*(int(a) for a in sys.argv[i + 1:i + 4]), sys.argv[i + 4])
        return
    for flag, helper in (("--ntt-host-tables", ntt_host_tables),  # started by prod_phase
                         ("--host-setup-digests", host_setup_digests)):  # started by main
        if flag in sys.argv[1:]:
            i = sys.argv.index(flag)
            helper(int(sys.argv[i + 1]), sys.argv[i + 2])
            return
    try:
        from pob_tpu_torch import _build
    except ImportError as e:
        fail(f"pob_tpu_torch not importable (run from the repo root): {e}")

    from pob_tpu_torch.field import cuda_mont, limb
    from pob_tpu_torch.field.ref import FQ_MOD, FR_MOD
    from pob_tpu_torch.prover import curve, groth16, msm, ntt
    from pob_tpu_torch.r1cs.spend_circuit import assemble_witness, build_spend_cs, spend_witness

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"device: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build_s {time.perf_counter() - t0:.3f} (sources {_build.sources_hash()})")
    ptxas = _build.ptxas_report()
    for src, kernels in ptxas.items():
        log(f"ptxas {src}: " + ", ".join(f"{k} {r} regs {ss}/{sl} B spill st/ld"
                                         for k, r, ss, sl in kernels))
    spills = [f"{src} {k}" for src in ("ntt.cu", "msm_g1.cu", "msm_g2.cu", "fixed_base.cu",
                                        "bitsum_g1.cu", "bitsum_g2.cu")
              for k, _, ss, sl in ptxas.get(src, ()) if ss or sl]  # older trees: no K5
    log("K2-K6 spill bytes: " + (f"in {', '.join(spills)}" if spills else "0 in every kernel"))
    phase_done("1 build")
    timing_mode = "--k4" in sys.argv[1:] or "--k5-k6" in sys.argv[1:]
    if spills and not timing_mode:  # these also time older trees, whose K4 spilled
        fail(f"ptxas spills registers in {', '.join(spills)}")
    if "--k5-k6" in sys.argv[1:]:
        k5_k6_mode(dev, card)
        return
    if "--msm-breakdown" in sys.argv[1:]:
        args, _ = spend_batch(dev, 16)
        cs = build_spend_cs()
        pk, _ = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev)
        W = assemble_witness(cs, spend_witness(*args))
        msm_breakdown(torch, msm, five_msms(pk, W, groth16.compute_h(pk.k, pk.mats, W)))
        k5_breakdown(torch, pk, W)
        return
    if "--dist" in sys.argv[1:]:
        cs = build_spend_cs()
        args, pubs = spend_batch(dev, 16)
        pk, vk = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev)
        W = assemble_witness(cs, spend_witness(*args))
        rs = [(1000 + i, 2000 + i) for i in range(16)]
        proofs = groth16.prove_batch(pk, W, rs=rs)
        h = groth16.compute_h(pk.k, pk.mats, W)
        log("dist " + json.dumps(dist_phase(dev, card, pk, vk, W, h, rs, proofs, pubs)))
        return
    if "--setup-routes" in sys.argv[1:]:
        log("setup_routes " + json.dumps(setup_routes_mode(dev, card)))
        return
    if "--prod" in sys.argv[1:]:
        prod, prod_rows = prod_phase(dev, card)
        log("prod " + json.dumps(prod))
        phase_done("9 PROD")
        log(json.dumps({"kernels": prod_rows}))
        log(f"{card}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}}))
        return
    if "--multihost" in sys.argv[1:]:
        cs = build_spend_cs()
        args, pubs = spend_batch(dev, MULTIHOST_PROOFS)
        pk, vk = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev)
        W = assemble_witness(cs, spend_witness(*args))
        rs = [(1000 + i, 2000 + i) for i in range(MULTIHOST_PROOFS)]
        proofs = plain_path(lambda: groth16.prove_batch(pk, W, rs=rs))
        log("multihost " + json.dumps(multihost_phase(card, pk, vk, W, rs, proofs, pubs)))
        return

    rand_elems = make_rand(dev, 20260)
    # phase 5's host ints of L_j(tau) and the h basis at 2^22, beside phases 2-8
    pob_digests = None if "--k4" in sys.argv[1:] else start_helper("--host-setup-digests", 22)

    def build_table(group):
        """K4's window table built anew, as setup's first call builds it."""
        msm.window_table.cache_clear()
        return msm.window_table(group, str(dev))

    # K4's two setup calls: the G1 queries in one call, b2 on G2
    k4_calls = (("g1", groth16.G1_QUERIES), ("g2", ("b2_query",)))
    # K4 edges: 0, 1, r - 1, the largest top digit 0x30, only window 31 nonzero
    k4_edges = limb.to_device(limb.ints_to_limbs(
        [0, 1, FR_MOD - 1, 0x30 << 248, 0x17 << 248]), dev)
    if "--k4" in sys.argv[1:]:
        _, sc_host, _ = groth16.setup_scalars(build_spend_cs(), TOXIC)
        out = {"card": card}
        for group, names in k4_calls:
            same_points(f"K4 {group} edges", group, msm.fixed_base_msm(group, k4_edges),
                        msm.fixed_base_plain(group, k4_edges))
            sc = limb.to_device(limb.ints_to_limbs([x for q in names for x in sc_host[q]]), dev)
            out[group] = {"n": sc.shape[0],
                          "table_build_ms": median_ms(lambda: build_table(group)),
                          "call_ms": median_ms(lambda: msm.fixed_base_msm(group, sc))}
        log("k4 " + json.dumps(out))
        return

    rows = []

    # ---------------- K1: field ops ----------------
    n_fr = 1 << 22  # 16 x 2^18: the h stage's shape
    n_fq = 1 << 20
    k1 = {}
    for spec, n in ((limb.FR, n_fr), (limb.FQ, n_fq)):
        a, b = rand_elems((n,)), rand_elems((n,))
        edges = [0, 1, spec.mod - 1]
        a[:3] = limb.to_device(limb.ints_to_limbs(edges), dev)
        b[:3] = limb.to_device(limb.ints_to_limbs(edges[::-1]), dev)
        wide = torch.cat([a, rand_elems((n,))], -1)  # a + b' R < p R
        cases = [
            ("mul", lambda: cuda_mont.field_op(cuda_mont.MUL, spec, a, b),
             lambda: limb.mont_mul_plain(spec, a, b)),
            ("sqr", lambda: cuda_mont.field_op(cuda_mont.SQR, spec, a),
             lambda: limb.mont_mul_plain(spec, a, a)),
            ("add", lambda: cuda_mont.field_op(cuda_mont.ADD, spec, a, b),
             lambda: limb.add_plain(spec, a, b)),
            ("sub", lambda: cuda_mont.field_op(cuda_mont.SUB, spec, a, b),
             lambda: limb.sub_plain(spec, a, b)),
            ("redc", lambda: cuda_mont.field_op(cuda_mont.REDC, spec, wide),
             lambda: limb.mont_reduce_plain(spec, wide)),
        ]
        fname = "fr" if spec is limb.FR else "fq"
        for op, kern, plain in cases:
            err = exact(f"K1 {fname} {op}", kern(), plain())
            k1[(fname, op)] = err
        km, pm = cuda_ms(cases[0][1], 10), cuda_ms(cases[0][2], 1)
        log(f"K1 {fname} n={n}: 5 ops exact; mul kernel_ms {km:.4f} plain_ms {pm:.4f}")
        if spec is limb.FR:
            k1_fr = (km, pm, bound(3 * 64 * n, n))
    km, pm, (bms, by) = k1_fr
    rows.append({"name": "K1 mont (Fr mul)", "route": "cuda",
                 "source": "pob_tpu_torch/csrc/mont.cu",
                 "replaces": "pob_tpu/field/pallas_mont.py:107",
                 "launches": 0, "max_abs_err": max(k1.values()), "ms": km,
                 "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                 "library_ms": None, "shape": f"{n_fr} Fr pairs"})

    # ---------------- K2: NTT ----------------
    k_chk = 12
    x = rand_elems((2, 1 << k_chk))
    shift = ntt.domain_root(k_chk + 1)
    kern = ntt.coeffs_to_coset_evals(ntt.intt(x, k_chk), k_chk, shift)

    def plain_transform(a, k, inverse):
        br = a.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev))
        return ntt._transform_plain(br, k, limb.to_device(ntt._root_powers(k, inverse), dev))

    p = limb.mont_mul_plain(limb.FR, plain_transform(x, k_chk, True),
                            limb.to_device(ntt._n_inv_mont(k_chk), dev))
    p = limb.mont_mul_plain(limb.FR, p, limb.to_device(ntt._coset_powers(k_chk, shift, False), dev))
    p = plain_transform(p, k_chk, False)
    k2_err = exact(f"K2 intt->coset k={k_chk}", kern, p)
    k_main, rows_main = 18, 16  # the h stage: six transforms of 16 rows
    xm = rand_elems((rows_main, 1 << k_main))
    br = xm.index_select(-2, torch.from_numpy(ntt._bitrev(k_main)).to(dev))
    roots = limb.to_device(ntt._root_powers(k_main, False), dev)
    want = ntt._transform_plain(br, k_main, roots)
    k2_err = max(k2_err, exact(f"K2 stages k={k_main}", ntt.ntt_stages_cuda(br, k_main, roots),
                               want))
    k2_err = max(k2_err, exact(f"K2 gather + stages k={k_main}",
                               ntt.ntt_stages_cuda(xm, k_main, roots, gather=True), want))
    for k in (1, 5, 11, 13):  # below one tile, and two passes split unevenly
        xs = rand_elems((3, 1 << k))
        rk = limb.to_device(ntt._root_powers(k, k % 2 == 1), dev)
        brk = xs.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev))
        wk = ntt._transform_plain(brk, k, rk)
        k2_err = max(k2_err, exact(f"K2 k={k}", ntt.ntt_stages_cuda(brk, k, rk), wk),
                     exact(f"K2 gather k={k}", ntt.ntt_stages_cuda(xs, k, rk, gather=True), wk))
    km = cuda_ms(lambda: ntt.ntt_stages_cuda(br, k_main, roots), 5)
    km_gather = cuda_ms(lambda: ntt.ntt_stages_cuda(xm, k_main, roots, gather=True), 5)
    pm = cuda_ms(lambda: ntt._transform_plain(br, k_main, roots), 1)
    n_main = 1 << k_main
    bms, by = bound(2 * rows_main * n_main * 64 + n_main // 2 * 64,
                    k_main * rows_main * n_main // 2)
    log(f"K2 exact (intt->coset k={k_chk} B=2; stages k={k_main} rows={rows_main}, with and "
        f"without the gather; k = 1, 5, 11, 13): passes {ntt.ntt_passes(k_main)}; kernel_ms "
        f"{km:.4f} (with the gather {km_gather:.4f}) plain_ms {pm:.4f} bound_ms {bms:.4f}")
    rows.append({"name": "K2 ntt (k butterfly stages)", "route": "cuda",
                 "source": "pob_tpu_torch/csrc/ntt.cu",
                 "replaces": "pob_tpu/prover/ntt.py:61", "launches": 0,
                 "max_abs_err": k2_err, "ms": km, "plain_ms": pm, "bound_ms": bms,
                 "bound_by": by, "library_ms": None,
                 "shape": f"{rows_main} rows x 2^{k_main}"})

    # ---------------- K4 and K3 on the edge cases ----------------
    # (K4 is checked first: K3's points come from it.) Both are checked again
    # at the main path's shapes, on its own inputs, after the main path.
    k4_table = {}
    for group in ("g1", "g2"):
        build_ms = median_ms(lambda: build_table(group))
        launch_ms = []  # (doublings ms, entries ms) of 3 more builds
        for _ in range(3):
            timing = []
            msm.fixed_base_table_cuda(group, dev, timing)
            torch.cuda.synchronize()
            launch_ms.append(tuple(a.elapsed_time(b) for _, a, b in timing))
        dbl_ms, tab_ms = sorted(launch_ms, key=sum)[1]
        plain_table, plain_table_ms = once_ms(lambda: msm.fixed_base_table_plain(group, dev))
        exact(f"K4 {group} window table", msm.window_table(group, str(dev)), plain_table)
        k4_table[group] = (dbl_ms + tab_ms, build_ms, plain_table_ms)
        sc = rand_elems((1 << 10,))
        sc[:k4_edges.shape[0]] = k4_edges
        (kern, km), (plain, pm) = (once_ms(lambda: msm.fixed_base_msm(group, sc)),
                                   once_ms(lambda: msm.fixed_base_plain(group, sc)))
        same_points(f"K4 {group}", group, kern, plain)
        for name, few in (("all-zero batch", torch.zeros_like(sc[:64])), ("m = 1", sc[3:4])):
            same_points(f"K4 {group} {name}", group, msm.fixed_base_msm(group, few),
                        msm.fixed_base_plain(group, few))
        log(f"K4 {group} window table (8192 packed affine entries) exact; build_ms (cache "
            f"cleared, median of 3, host work included) {build_ms:.4f}; kernels alone "
            f"(median of 3) {dbl_ms + tab_ms:.4f} (doublings {dbl_ms:.4f}, entries "
            f"{tab_ms:.4f}); plain_ms {plain_table_ms:.4f}")
        log(f"K4 {group} m={sc.shape[0]} exact (incl. scalars 0, 1, r-1, 0x30 << 248, "
            f"0x17 << 248; an all-zero batch; m = 1): kernel_ms {km:.4f} plain_ms {pm:.4f}")

    s_star = limb.to_device(limb.ints_to_limbs([0x30 << 248]), dev)[0]
    for group, m in (("g1", 1 << 12), ("g2", 1 << 10)):
        ops = curve.ops_for(group)
        pts = [c.clone() for c in msm.fixed_base_msm(group, rand_elems((m,)))]
        for c in pts:  # repeated points: P0 at 1, 2; Q = P3 and -Q at 4
            c[1] = c[0]
            c[2] = c[0]
        pts[1][4] = limb.sub_plain(limb.FQ, torch.zeros_like(pts[1][3]), pts[1][3])
        pts[0][4], pts[2][4] = pts[0][3], pts[2][3]
        one = ops.one((2,), dev)
        pts[0][5:7], pts[1][5:7], pts[2][5:7] = one, one, torch.zeros_like(one)  # infinity
        sc = rand_elems((2, m)) & 0x2F2F  # every random digit below 0x30
        sc[:, 7:10] = 0
        # digit 0x30 (window 31) only for the special points: bucket 0x30 holds
        # {2^248 P0, 2^248 P0} (doubling) in proof 0 and {2^248 Q, -2^248 Q}
        # (cancel) in proof 1
        sc[0, 1], sc[0, 2] = s_star, s_star
        sc[1, 3], sc[1, 4] = s_star, s_star
        pts = tuple(pts)
        (kern, km), (plain, pm) = (once_ms(lambda: msm.msm_batched(group, pts, sc)),
                                   once_ms(lambda: msm.msm_plain(ops, pts, sc)))
        same_points(f"K3 {group}", group, kern, plain)
        bnd = [0x7F, 0x80, 0xFF, FR_MOD - 1, 0x7F << 240, 0x80 << 120, 0xFF << 8,
               int("80" * 31, 16), int("7F" * 31, 16), int("FF" * 31, 16) % FR_MOD]
        sc_b = limb.to_device(limb.ints_to_limbs(bnd * 2), dev).reshape(2, len(bnd), 16)
        sc_b[1] = sc_b[1].roll(3, 0)
        pts_b = tuple(c[:len(bnd)].contiguous() for c in pts)
        same_points(f"K3 {group} digit boundaries", group, msm.msm_batched(group, pts_b, sc_b),
                    msm.msm_plain(ops, pts_b, sc_b))
        m_skew = 2048  # all scalars 1: one bucket of m entries, 3 bucket-sum levels
        sc_1 = limb.to_device(limb.ints_to_limbs([1] * (2 * m_skew)), dev).reshape(2, m_skew, 16)
        pts_1 = tuple(c[:m_skew].contiguous() for c in msm.fixed_base_msm(group,
                                                                          rand_elems((m_skew,))))
        same_points(f"K3 {group} skew", group, msm.msm_batched(group, pts_1, sc_1),
                    msm.msm_plain(ops, pts_1, sc_1))
        log(f"K3 {group}: digit boundaries 0x7F, 0x80, 0xFF, r-1 and an all-ones batch (m = "
            f"{m_skew}, {len(msm.level_segs(m_skew))} levels) exact")
        log(f"K3 {group} m={m} B=2 exact (incl. infinity, doubling, cancel, zero scalars): "
            f"kernel_ms {km:.4f} plain_ms {pm:.4f}")

    phase_done("2 kernels against their plain versions")

    # ---------------- the main path: Spend, domain 2^18, batch 16 ----------------
    batch = 16
    args, pubs = spend_batch(dev, batch)

    msm.window_table.cache_clear()  # setup builds K4's table, as a user's first setup does
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cs = build_spend_cs()
    st = {}
    pk, vk = groth16.setup(cs, rng=iter(TOXIC).__next__, device=dev, timings=st)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    after_setup = dict(_build.LAUNCHES)
    if pk.k != 18:
        fail(f"Spend domain is 2^{pk.k}, expected 2^18")
    if pk.plan is None or not groth16.uses_plan(pk):
        fail("setup did not give the key its witness-MSM plan, or prove_batch would not use it")
    plan_mb = pk.plan.nbytes() / 1e6
    log(f"setup_s {setup_s:.3f} (k={pk.k}, {cs.num_constraints} constraints, "
        f"{cs.num_wires} wires; " + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
        + f"); the plan: {plan_mb:.1f} MB, counts (n_bit, n_full) G1 "
        f"{pk.plan.g1.counts.tolist()} G2 {pk.plan.g2.counts.tolist()}, M "
        f"{pk.plan.g1.pts.shape[1]} / {pk.plan.g2.pts.shape[1]}")

    t0 = time.perf_counter()
    W = assemble_witness(cs, spend_witness(*args))
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    wire1 = limb.limb_rows_to_ints(W[:, 1].cpu().numpy())
    if wire1 != pubs:
        fail("witness wire 1 differs from spend_expected_commitment")
    log(f"witness_s {witness_s:.4f} (batch {batch}, wire 1 == expected commitment)")

    rs = [(1000 + i, 2000 + i) for i in range(batch)]
    groth16.prove_batch(pk, W, rs=rs)  # warm-up
    runs = []
    for _ in range(2):
        tm = {}
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        proofs = groth16.prove_batch(pk, W, rs=rs, timings=tm)
        torch.cuda.synchronize()
        tm["prove_s"] = time.perf_counter() - t0
        runs.append(tm)
    counts = dict(_build.LAUNCHES)
    per_prove = {k: counts[k] - before[k] for k in counts}
    log(f"launches: setup {after_setup}, one batch-{batch} prove {per_prove}, "
        f"whole main path {counts}")
    for i, tm in enumerate(runs):
        log(f"timed prove {i}: h_s {tm['h_s']:.4f} msm_s {tm['msm_s']:.4f} "
            f"prove_s {tm['prove_s']:.4f}")
    mean = {k: sum(tm[k] for tm in runs) / len(runs) for k in ("h_s", "msm_s", "prove_s")}
    pps = batch / (witness_s + mean["prove_s"])
    log(f"proofs_per_s {pps:.4f} (batch / (witness_s + prove_s), prove_s the mean of "
        f"{len(runs)} timed proves)")

    t0 = time.perf_counter()
    for i in range(4):
        if not groth16.verify(vk, proofs[i], [pubs[i]]):
            fail(f"proof {i} does not verify")
        if groth16.verify(vk, proofs[i], [(pubs[i] + 1) % FR_MOD]):
            fail(f"proof {i} verifies with a tampered public input")
    log(f"verify: 4 proofs accepted, 4 tampered publics rejected "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    for key in _build.LAUNCHES:
        if counts[key] <= 0:
            fail(f"kernel {key} was not launched on the main path")

    # the plain path (POB_NO_PLAN=1) on the same witnesses and (r, s), after
    # the counts: the same proofs, bit for bit
    plain_runs = []
    for _ in range(2):
        tm = {}
        before_plain = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        plain_proofs = plain_path(lambda: groth16.prove_batch(pk, W, rs=rs, timings=tm))
        torch.cuda.synchronize()
        tm["prove_s"] = time.perf_counter() - t0
        plain_runs.append(tm)
        log(f"plain path (POB_NO_PLAN=1) timed prove: h_s {tm['h_s']:.4f} msm_s "
            f"{tm['msm_s']:.4f} prove_s {tm['prove_s']:.4f}")
    per_plain_prove = {k: _build.LAUNCHES[k] - before_plain[k] for k in counts}
    if plain_proofs != proofs:
        fail(f"the {batch} planned proofs differ from the plain path's for the same (r, s)")
    log(f"the {batch} planned proofs equal the plain path's bit for bit")
    log("slice " + json.dumps({"setup_s": setup_s, "setup_parts_s": st, "plan_mb": plan_mb,
                               "witness_s": witness_s, **mean, "timed_proves": runs,
                               "plain_path_proves": plain_runs,
                               "launches_per_plain_prove": per_plain_prove, "batch": batch,
                               "proofs_per_s": pps, "launches": counts}))
    phase_done("3 main path")

    # ---------------- K3 and K4 on the main path's own inputs ----------------
    # K3: every MSM of prove_batch at B = 16 on the same witnesses and h,
    # proofs 0 and 15 held against the plain version. K4: the setup's query
    # points against the plain version over the setup's scalars, in chunks.
    h = groth16.compute_h(pk.k, pk.mats, W)
    torch.cuda.synchronize()
    for path, stage in (("planned", lambda: groth16.msm_stage(pk, W, h)),
                        ("plain", lambda: plain_path(lambda: groth16.msm_stage(pk, W, h)))):
        torch.cuda.set_sync_debug_mode("error")  # any host read in K3 or K5 raises
        try:
            stage()
        except RuntimeError as e:
            fail(f"the {path} MSM stage synchronized with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"{path} MSM stage of one prove (groth16.msm_stage) ran under "
            "torch.cuda.set_sync_debug_mode('error'): no host read")
    msms = five_msms(pk, W, h)
    log("msm_breakdown " + json.dumps(msm_breakdown(torch, msm, msms)))
    log("k5_breakdown " + json.dumps(k5_breakdown(torch, pk, W)))
    chk = torch.tensor([0, batch - 1], device=dev)
    for name, group, pts, sc, bases in msms:
        (kern, km), (plain, pm) = (
            once_ms(lambda: msm.msm_batched(group, pts, sc, bases)),
            once_ms(lambda: msm.msm_plain(curve.ops_for(group), pts, sc[chk].contiguous())))
        same_points(f"K3 {name}-MSM", group, tuple(c[chk] for c in kern), plain)
        nz = int((msm.scalar_digits(sc) != 0).sum())
        log(f"K3 {name}-MSM ({group}, B={batch}, m={sc.shape[1]}, {nz} nonzero digits): "
            f"proofs 0, {batch - 1} exact; kernel_ms {km:.3f} (B={batch}) plain_ms {pm:.3f} "
            f"(B=2)")
    m_h = 1 << pk.k
    nz = int((msm.scalar_digits(h) != 0).sum())
    hm = cuda_ms(lambda: msm.msm_batched("g1", pk.h_query, h, pk.bases["h_query"]), 3)
    (bms, by), (bms_pr2, _) = msm_bounds("g1", batch, m_h, nz)
    log(f"K3 h-MSM B={batch} m={m_h}: kernel_ms {hm:.3f} bound_ms {bms:.3f} ({by}; "
        f"{bms_pr2:.3f} with a full add per digit)")
    rows.insert(2, {"name": "K3 msm (G1 Pippenger, the h-MSM)", "route": "cuda",
                    "source": "pob_tpu_torch/csrc/msm.cuh",
                    "replaces": "pob_tpu/prover/msm.py:92", "launches": 0,
                    "max_abs_err": 0, "ms": hm, "plain_ms": pm, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "shape": f"B={batch} x 2^{pk.k} G1 points",
                    "plain_shape": f"B=2 x 2^{pk.k} (proofs 0 and {batch - 1})"})

    _, sc_host, _ = groth16.setup_scalars(cs, TOXIC)
    ic_pts = curve.g1_points_to_device(vk.ic, dev)
    chunk = 1 << 16
    for group, names in k4_calls:
        sc = limb.to_device(limb.ints_to_limbs([x for q in names for x in sc_host[q]]), dev)
        kern = tuple(torch.cat(cs_, 0) for cs_ in zip(
            *[ic_pts if q == "ic" else getattr(pk, q) for q in names]))
        pm = 0.0
        for o in range(0, sc.shape[0], chunk):
            plain, ms = once_ms(lambda: msm.fixed_base_plain(group, sc[o:o + chunk]))
            pm += ms
            same_points(f"K4 {group} setup queries [{o}, {o + chunk})", group,
                        tuple(c[o:o + chunk] for c in kern), plain)
        km = median_ms(lambda: msm.fixed_base_msm(group, sc))
        n4 = sc.shape[0]
        dig = msm.scalar_digits(sc) != 0
        nz, nz_scalars = int(dig.sum()), int(dig.any(-1).sum())
        nbytes = n4 * 64 + n4 * 3 * COORD_BYTES[group] + 8192 * 2 * COORD_BYTES[group] // 2
        bms, by = bound(nbytes, (nz - nz_scalars) * MADD_MULS[group])
        bms_full, _ = bound(nbytes, nz * ADD_MULS[group])
        log(f"K4 {group} setup queries {'+'.join(names)} (n={n4}, {n4 - nz_scalars} zero, "
            f"{nz} nonzero digits): exact; kernel_ms {km:.3f} (median of 3) plain_ms {pm:.3f} "
            f"bound_ms {bms:.3f} ({by}; a mixed add per nonzero digit after the first) "
            f"{bms_full:.3f} (a full add per nonzero digit)")
        rows.append({"name": f"K4 fixed_base ({group.upper()} window, the setup's "
                             f"{group.upper()} queries)", "key": "fixed_base",
                     "route": "cuda", "source": "pob_tpu_torch/csrc/fixed_base.cu",
                     "replaces": "pob_tpu/prover/msm.py:248", "launches": 0,
                     "max_abs_err": 0, "ms": km, "plain_ms": pm, "bound_ms": bms,
                     "bound_by": by, "bound_ms_full_adds": bms_full, "library_ms": None,
                     "shape": f"{n4} {group.upper()} scalars"})
    for group in ("g1", "g2"):
        table_ms, build_ms, plain_table_ms = k4_table[group]
        # The least work: 255 doublings, then per entry (w, v), v > 0,
        # popcount(v) - 1 adds, 3 coordinate products as its share of one
        # batched inversion of every Z (Montgomery's trick) and the products
        # to affine (G1 4, G2 11 Fq products); plus that one inversion (fe_inv:
        # 253 squarings and a product per set bit of q - 2 below bit 253; on
        # G2 4 Fq products around it). The kernel inverts each entry's Z on
        # its own: bound_ms_inv_per_entry counts that.
        entries = 32 * 255
        adds = 32 * sum(bin(v).count("1") - 1 for v in range(1, 256))
        inv = 253 + bin((FQ_MOD - 2) & ((1 << 253) - 1)).count("1") + (4 if group == "g2" else 0)
        coord_mul = 1 if group == "g1" else 3  # Fq products in one coordinate product
        to_affine = 4 if group == "g1" else 11
        chain = 255 * DBL_MULS[group] + adds * ADD_MULS[group]
        nbytes = 8192 * COORD_BYTES[group] + 3 * COORD_BYTES[group]
        bms, by = bound(nbytes, chain + entries * (3 * coord_mul + to_affine) + inv)
        bms_inv, _ = bound(nbytes, chain + entries * (inv + to_affine))
        log(f"K4 {group} table bound_ms {bms:.4f} ({by}; one batched inversion) "
            f"{bms_inv:.4f} (an inversion per entry, as the kernel does)")
        rows.append({"name": f"K4 fixed_base table ({group.upper()}: doublings, 8192 entries)",
                     "key": "fixed_base_table", "route": "cuda",
                     "source": "pob_tpu_torch/csrc/fixed_base.cu",
                     "replaces": "pob_tpu/prover/groth16.py:131", "launches": 0,
                     "max_abs_err": 0, "ms": table_ms, "build_ms": build_ms,
                     "plain_ms": plain_table_ms, "bound_ms": bms, "bound_by": by,
                     "bound_ms_inv_per_entry": bms_inv, "library_ms": None,
                     "shape": f"32 x 256 {group.upper()} entries"})

    chk_plan = torch.tensor([0, batch - 1], device=dev)
    plan_rows, plan_info = plan_checks(pk, W, "Spend", chk=chk_plan)
    rows += plan_rows
    rows += bases_checks(pk, "Spend", SPEND_K6_SAMPLE)
    plan_cache = plan_cache_roundtrip(pk, cs, W, rs, proofs)
    log("plan " + json.dumps({"info": plan_info, "cache": plan_cache, "mb": plan_mb}))

    for key, row in zip(("mont", "ntt", "msm"), rows):
        row["key"] = key
    for row in rows:
        row["launches"] = counts[row["key"]]
        row["launches_per_prove"] = per_prove[row["key"]]
        row["launches_per_plain_prove"] = per_plain_prove[row["key"]]

    del msms, kern, plain, sc, ic_pts, args, xm, br, want, a, b, wide
    gc.collect()
    phase_done("4 K3 and K4 on the main path's inputs")

    # ---------------- the command line at full width: Spend ----------------
    cli = cli_phase(dev)
    log("cli " + json.dumps(cli))
    phase_done("6 cli")

    # ---------------- the multi-device layer on virtual meshes of the card: Spend ----------------
    dist = dist_phase(dev, card, pk, vk, W, h, rs, proofs, pubs)
    for row in rows:
        row["launches_dist"] = dist["launches"][row["key"]]
    log("dist " + json.dumps(dist))
    phase_done("7 dist")

    # ---------------- the dist layer on a mesh across processes: Spend ----------------
    multihost = multihost_phase(card, pk, vk, W, rs, proofs, pubs)
    for row in rows:
        row["launches_multihost"] = multihost["launches"][row["key"]]
    log("multihost " + json.dumps(multihost))
    del pk, vk, W, h
    gc.collect()
    phase_done("8 multihost")

    # ---------------- the ProofOfBurn path: TEST_CONFIG, 2^22, batch 4 ----------------
    pob, pob_rows = pob_phase(dev, card, pob_digests)
    log("pob " + json.dumps(pob))
    phase_done("5 ProofOfBurn")

    # ---------------- the production ProofOfBurn: PROD_CONFIG, 2^24, batch 1 ----------------
    gc.collect()
    prod, prod_rows = prod_phase(dev, card)
    for row in rows:
        key = row.pop("key")
        row["launches_cli"] = cli["launches"][key]
        row["launches_pob"] = pob["launches"][key]
        row["launches_per_pob_prove"] = pob["launches_per_prove"][key]
        row["launches_prod"] = prod["launches"][key]
    log("prod " + json.dumps(prod))
    phase_done("9 PROD")
    log("phases_s " + json.dumps(PHASES))
    log(json.dumps({"kernels": rows + pob_rows + prod_rows}))
    log(f"{card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
            child.wait()
