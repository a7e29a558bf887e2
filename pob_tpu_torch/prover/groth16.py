"""Groth16 over BN254 on tensors: setup, prove, verify.

Same proof system and conventions as pob_tpu's prover (snarkjs layout):
wire order [1, publics..., privates...]; nPublic+1 binding rows appended to
the A matrix; C on the domain is the pointwise product A.B; the h MSM runs
over the coset-Lagrange basis H_j = [x_j (tau^{2n} - 1) / (2 n delta
(tau - x_j))]_1 on the coset x_j = w_{2n} w_n^j, so the prover MSMs the coset
evaluations of A.B - C directly.

Per proof, everything runs on tensors of one device: the two sparse
mat-vecs and the six transforms of the h stage (K1, K2), then five MSMs.
On the planned path (pob_tpu's default: setup attaches the key's MsmPlan,
and POB_NO_PLAN is not set) the four witness MSMs are two K5 sweeps over
the plan's points and the h MSM is K3; on the plain path all five are K3.
Setup computes its scalars on the key's device (log-depth scans and
column sums over K1, pob_tpu's setup route; setup_host takes the python-int
route), forms every query point with K4, and makes K3's shifted bases (S
windows per query, choose_windows) and the plan's doubling chains with K6.
Verification is the host pairing check."""

from __future__ import annotations

import os
import secrets
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..field import limb
from ..field.limb import FR as FRS
from ..field.ref import (
    FQ_MOD,
    FR_MOD,
    G1_GEN,
    G2_GEN,
    g1_add,
    g1_mul,
    g1_neg,
    g2_add,
    g2_mul,
    pairing_product_is_one,
)
from ..r1cs.builder import ConstraintSystem
from ..utils.metrics import METRICS, DeviceLaps, lap, launches_since
from . import bitsum, curve, msm, ntt

_R = (1 << 256) % FR_MOD
_R2_FR = _R * _R % FR_MOD
_R2_LIMBS = limb.int_to_limbs(_R2_FR)
_R_FQ_LIMBS = limb.int_to_limbs((1 << 256) % FQ_MOD)


def _next_pow2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def _inv(x):
    return pow(x % FR_MOD, FR_MOD - 2, FR_MOD)


def _batch_inv(xs: list) -> list:
    """Montgomery-trick inversion of nonzero python ints: one pow in total."""
    prefix = [1]
    for x in xs:
        prefix.append(prefix[-1] * x % FR_MOD)
    acc = _inv(prefix[-1])
    out = [0] * len(xs)
    for j in range(len(xs) - 1, -1, -1):
        out[j] = acc * prefix[j] % FR_MOD
        acc = acc * xs[j] % FR_MOD
    return out


@dataclass
class ProvingKey:
    k: int  # log2 domain size
    num_public: int
    alpha1: tuple  # host affine points
    beta1: tuple
    delta1: tuple
    beta2: tuple
    delta2: tuple
    a_query: tuple  # Jacobian (nw,) tensors
    b1_query: tuple
    b2_query: tuple  # Jacobian G2 (nw,)
    l_query: tuple  # Jacobian (nw - num_public - 1,)
    h_query: tuple  # Jacobian (n,), coset-Lagrange basis
    # COO matrices (A with binding rows, B): (rows i64, cols i64, coeffs c*R^2 (nnz, 16))
    mats: tuple
    # on the card: msm.affine_bases of each query above, by name (K3's
    # mixed adds read these); None on the CPU, whose path adds Jacobian points
    bases: dict | None = None
    # the planned witness MSMs (attach_msm_plan); None proves on the plain path
    plan: MsmPlan | None = None


MSM_QUERIES = (("a_query", "g1"), ("b1_query", "g1"), ("b2_query", "g2"), ("l_query", "g1"),
               ("h_query", "g1"))


def proof_bytes(k: int, m: int) -> int:
    """Device bytes one proof at domain 2^k over queries of at most m points
    is reckoned to need beside its key: its h stage (h_stage_bytes) and its
    largest K3 call's scratch (msm.k3_scratch_bytes), counted as if they
    were alive at once (the allocator's cache does not return the first
    stage's blocks in the shapes the second asks for)."""
    return h_stage_bytes(k) + msm.k3_scratch_bytes(1, m)


def choose_windows(counts: dict, k: int, free: int, planned: bool = False,
                   plan_bytes: int = 0) -> dict:
    """The rule for the shifted windows S of each query's K3 bases (S
    divides 32; msm.affine_bases(group, points, S)). counts: {query: its
    points}; free: the device bytes the bases, the plan (plan_bytes) and
    one proof (proof_bytes) may take, of which they plan to use MEM_SHARE.
    (32, 8) everywhere when that fits: every Spend and TEST_CONFIG key.
    Otherwise the queries the key's plan covers (planned: K5 proves them;
    the plan gathers its bit points from window 0, and a zkey's point
    sections are window 0) keep window 0 only, S = 1, and the others (the h
    query; every query of a key without a plan) take the largest S that
    fits, or 1."""
    per = {q: counts[q] * msm._bases_width(g) * 4 for q, g in MSM_QUERIES}
    budget = int(free * MEM_SHARE) - plan_bytes - proof_bytes(k, max(counts.values()))
    for s in msm.WINDOW_COUNTS:
        ws = {q: 1 if planned and q in PLANNED_QUERIES and s < msm.N_WINDOWS else s
              for q in per}
        if sum(ws[q] * per[q] for q in per) <= budget:
            return ws
    return ws


def device_free_bytes(device) -> int:
    """Free bytes of a card: the driver's free memory and the blocks the
    caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def key_windows(pk: ProvingKey, device, planned: bool = False, plan_bytes: int = 0) -> dict:
    """choose_windows for the key's queries on the card `device`."""
    counts = {q: int(getattr(pk, q)[0].shape[0]) for q, _ in MSM_QUERIES}
    return choose_windows(counts, pk.k, device_free_bytes(device), planned, plan_bytes)


def bases_windows(pk: ProvingKey) -> dict | None:
    """{query: S} of the key's K3 bases (None for a key without bases)."""
    if pk.bases is None:
        return None
    return {q: int(pk.bases[q].shape[0]) // max(1, int(getattr(pk, q)[0].shape[0]))
            or msm.N_WINDOWS for q, _ in MSM_QUERIES}


def attach_bases(pk: ProvingKey, planned: bool = False, plan_bytes: int = 0) -> ProvingKey:
    """Make the K3 bases of a key whose points lie on the card (once per
    key, at setup and at load), S shifted windows per query by
    choose_windows: planned says whether the key will carry a plan of
    plan_bytes."""
    if pk.a_query[0].is_cuda:
        ws = key_windows(pk, pk.a_query[0].device, planned, plan_bytes)
        pk.bases = {q: msm.affine_bases(g, getattr(pk, q), ws[q]) for q, g in MSM_QUERIES}
    return pk


@dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list  # affine G1, len num_public + 1


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


def _lagrange_at_tau(k: int, tau: int) -> list:
    """L_j(tau) = w^j (tau^n - 1) / (n (tau - w^j)) for j in [0, 2^k)."""
    n = 1 << k
    pws = ntt._powers(ntt.domain_root(k), n)
    invs = _batch_inv([(tau - p) % FR_MOD for p in pws])
    c = (pow(tau, n, FR_MOD) - 1) * _inv(n) % FR_MOD
    return [p * c % FR_MOD * i % FR_MOD for p, i in zip(pws, invs)]


def _poly_evals_at_tau(coo, lag, nw) -> list:
    """u_i(tau) = sum over (row j, wire i, coeff c): c * L_j(tau)."""
    rows, cols, cidx, pal = coo
    out = [0] * nw
    for j, i, c in zip(rows.tolist(), cols.tolist(), np.asarray(cidx).tolist()):
        out[i] += pal[c] * lag[j]
    return [x % FR_MOD for x in out]


def _mont_const(c: int, device) -> torch.Tensor:
    """A constant c as (16,) limbs of c R mod r (Montgomery form) on
    `device`: mont_mul(x, _mont_const(c)) = x c."""
    return torch.from_numpy(limb.int_to_limbs(c % FR_MOD * _R % FR_MOD)).to(device)


def _lagrange_at_tau_mont_dev(k: int, tau: int, device):
    """(n, 16) Montgomery limbs of L_j(tau) = w^j (tau^n - 1) / (n (tau -
    w^j)) on `device`: the device twin of _lagrange_at_tau, by log-depth
    powers and scans (limb.mont_powers_mont, batch_inv_mont_scan), so
    the 2^24 domain of the production ProofOfBurn stays a few seconds."""
    n = 1 << k
    zt_over_n = (pow(tau, n, FR_MOD) - 1) * _inv(n) % FR_MOD
    pws = limb.mont_powers_mont(FRS, _mont_const(ntt.domain_root(k), device), n)
    denoms = limb.sub(FRS, _mont_const(tau, device).expand(pws.shape), pws)
    invs = limb.batch_inv_mont_scan(FRS, denoms)
    del denoms
    return limb.mont_mul(FRS, limb.mont_mul(FRS, pws, invs), _mont_const(zt_over_n, device))


# Column sums of _poly_evals_dev: a column of c terms gives int64 limb sums
# below c 2^16, which carry_fix(., 40) normalizes while c < 2^24; each term
# is below r, so the wide sum stays below c r < r R for the REDC. The
# production ProofOfBurn's largest column (wire 0 in A) has 3,240,390
# terms: limb sums below 2^37.7, a wide sum below 2^276.
POLY_MAX_TERMS = 1 << 24


def _poly_evals_dev(coo, lag_mont, nw: int):
    """Device twin of _poly_evals_at_tau: u_i(tau) = sum over (row j, wire
    i, coefficient c) of c L_j(tau), as (nw, 16) canonical limbs on
    lag_mont's device. The COO's Montgomery terms c L_j R (K1) go
    MATVEC_CHUNK at a time into int64 limb sums by column (index_add_),
    then every column's wide sum is normalized (carry_fix) and reduced
    once: REDC(sum of x R) = sum of x, canonical. The matvec's pattern
    (sparse_matvec_mont) with rows and columns swapped; a column may hold
    millions of terms (POLY_MAX_TERMS)."""
    rows, cols, cidx, pal = coo
    dev = lag_mont.device
    out = torch.zeros(nw, limb.L, dtype=torch.int32, device=dev)
    if len(cidx) == 0:
        return out
    most = int(np.bincount(np.asarray(cols), minlength=1).max())
    if most >= POLY_MAX_TERMS:
        raise ValueError(f"a column of {most} terms would overflow _poly_evals_dev's sums")
    pal_m = limb.to_mont(FRS, limb.to_device(limb.ints_to_limbs(pal), dev))
    sums = torch.zeros(nw, limb.L, dtype=torch.int64, device=dev)
    for o in range(0, len(cidx), MATVEC_CHUNK):
        c = slice(o, o + MATVEC_CHUNK)
        r = torch.from_numpy(np.asarray(rows[c], np.int64)).to(dev)
        ci = torch.from_numpy(np.asarray(cidx[c], np.int64)).to(dev)
        terms = limb.mont_mul(FRS, pal_m[ci], lag_mont[r])  # c L_j R
        sums.index_add_(0, torch.from_numpy(np.asarray(cols[c], np.int64)).to(dev),
                        terms.to(torch.int64))
    for o in range(0, nw, MATVEC_CHUNK):
        c = slice(o, o + MATVEC_CHUNK)
        norm = limb.carry_fix(torch.nn.functional.pad(sums[c], (0, limb.L)), 40)
        out[c] = limb.mont_reduce(FRS, norm.to(torch.int32))
    return out


def _setup_scalars_kernel(npub: int, u, v, w, beta_m, alpha_m, ginv_m, dinv_m):
    """The ic and l query scalars from the canonical QAP evaluations:
    k_i = beta u_i + alpha v_i + w_i, ic = k[:npub + 1] / gamma, l =
    k[npub + 1:] / delta (canonical limbs; the constants in Montgomery
    form)."""
    kv = limb.add(FRS, limb.add(FRS, limb.mont_mul(FRS, u, beta_m),
                                limb.mont_mul(FRS, v, alpha_m)), w)
    return limb.mont_mul(FRS, kv[:npub + 1], ginv_m), limb.mont_mul(FRS, kv[npub + 1:], dinv_m)


def _h_scalars_kernel(k: int, tau_m, s_m, mult):
    """The coset-Lagrange h basis x_j (tau^{2n} - 1) / (2 n delta (tau -
    x_j)) for x_j = s w^j, j < n, canonical limbs; tau_m and s_m in
    Montgomery form, mult the constant (tau^{2n} - 1) / (2 n delta) in
    plain form (its product with a Montgomery value is canonical)."""
    x = limb.mont_mul(FRS, limb.mont_powers_mont(FRS, _mont_const(ntt.domain_root(k), s_m.device),
                                                 1 << k), s_m)
    invs = limb.batch_inv_mont_scan(FRS, limb.sub(FRS, tau_m.expand(x.shape), x))
    return limb.mont_mul(FRS, limb.mont_mul(FRS, x, invs), mult)


def _indexed_matrices(cs: ConstraintSystem):
    """(A+binding rows, B, C) as palette-indexed COOs (rows, cols, cidx, pal)."""
    (ra, ca_, ia), mb, mc, pal = cs.matrices_indexed()
    extra = np.arange(cs.num_public + 1, dtype=np.int64)
    rows = np.concatenate([ra, cs.num_constraints + extra])
    cols = np.concatenate([ca_, extra])
    # palette index 0 is always the coefficient 1 (builder invariant)
    cidx = np.concatenate([ia, np.zeros(len(extra), np.int32)])
    pal_list = [int(c) for c in pal]
    return (rows, cols, cidx, pal_list), (*mb, pal_list), (*mc, pal_list)


def snarkjs_matrices(cs: ConstraintSystem):
    """(A, B) host COOs in snarkjs layout, (rows, cols, coefficients as
    python ints): A with its nPublic+1 binding rows (row m + i: 1 * wire i),
    as snarkjs zkey_new adds them; C is not needed by the prover (on the
    domain it equals A.B). The entries and order of _indexed_matrices."""
    (ra, ca_, ia, pal), (rb, cb, ib, _), _ = _indexed_matrices(cs)
    pal = np.asarray(pal, dtype=object)
    return (ra, ca_, pal[ia]), (rb, cb, pal[ib])


def _mats_to_device(host_mats, device):
    """Palette-indexed host COOs -> (rows, cols, coeff limbs c*R^2) tensors,
    so mont_mul(coeff, canonical w) lands in Montgomery form directly."""
    out = []
    for rows, cols, cidx, pal in host_mats:
        pal_r2 = limb.ints_to_limbs([int(c) * _R2_FR % FR_MOD for c in pal])
        cf = pal_r2[np.asarray(cidx, np.int64)] if len(cidx) else np.zeros((0, limb.L), np.int32)
        out.append((torch.from_numpy(np.asarray(rows, np.int64)).to(device),
                    torch.from_numpy(np.asarray(cols, np.int64)).to(device),
                    limb.to_device(cf, device)))
    return tuple(out)


def _fixed_base_many(group: str, scalar_lists, device):
    """One K4 call over every list's scalars (lists of python ints, or (m,
    16) limb tensors on `device`); returns one point tuple each."""
    sizes = [len(s) for s in scalar_lists]
    if all(torch.is_tensor(s) for s in scalar_lists):
        flat = torch.cat(scalar_lists, 0)
    else:
        flat = limb.to_device(limb.ints_to_limbs([x for s in scalar_lists for x in s]), device)
    pts = msm.fixed_base_msm(group, flat)
    del flat
    out, o = [], 0
    for n in sizes:
        out.append(tuple(c[o:o + n] for c in pts))
        o += n
    return out


def setup_scalars(cs: ConstraintSystem, toxic):
    """The query scalars of the setup for toxic waste (tau, alpha, beta,
    gamma, delta), on the host: (k, {query name: list of Fr ints}, host
    matrices (A with binding rows, B)). Names: a_query, b1_query, b2_query,
    l_query, h_query, ic."""
    tau, alpha, beta, gamma, delta = toxic
    npub = cs.num_public
    k = max(1, _next_pow2(cs.num_constraints + npub + 1))
    n = 1 << k
    nw = cs.num_wires

    lag = _lagrange_at_tau(k, tau)
    mat_a, mat_b, mat_c = _indexed_matrices(cs)
    u = _poly_evals_at_tau(mat_a, lag, nw)
    v = _poly_evals_at_tau(mat_b, lag, nw)
    w = _poly_evals_at_tau(mat_c, lag, nw)
    ginv, dinv = _inv(gamma), _inv(delta)
    kv = [(beta * u[i] + alpha * v[i] + w[i]) % FR_MOD for i in range(nw)]

    s = ntt.domain_root(k + 1)  # coset shift w_{2n}: s^n = -1
    c0 = (pow(tau, 2 * n, FR_MOD) - 1) * _inv(2 * n) % FR_MOD * dinv % FR_MOD
    xs = [s * p % FR_MOD for p in ntt._powers(ntt.domain_root(k), n)]
    h_scalars = [x * c0 % FR_MOD * i % FR_MOD
                 for x, i in zip(xs, _batch_inv([(tau - x) % FR_MOD for x in xs]))]
    scalars = {"a_query": u, "b1_query": v, "b2_query": v,
               "l_query": [x * dinv % FR_MOD for x in kv[npub + 1:]],
               "h_query": h_scalars, "ic": [x * ginv % FR_MOD for x in kv[: npub + 1]]}
    return k, scalars, (mat_a, mat_b)


def setup_scalars_dev(cs: ConstraintSystem, toxic, device):
    """setup_scalars on `device` (pob_tpu's setup route): (k, {query name:
    (m, 16) canonical limb tensor}, host matrices). L_j(tau) and the h basis
    by log-depth scans, u, v, w by column sums over the COOs, then the ic
    and l scalars; K1 does the products on a card, its plain version on
    the CPU. The same values as setup_scalars."""
    tau, alpha, beta, gamma, delta = toxic
    npub = cs.num_public
    k = max(1, _next_pow2(cs.num_constraints + npub + 1))
    n = 1 << k
    nw = cs.num_wires

    lag = _lagrange_at_tau_mont_dev(k, tau, device)
    mat_a, mat_b, mat_c = _indexed_matrices(cs)
    u, v, w = (_poly_evals_dev(m, lag, nw) for m in (mat_a, mat_b, mat_c))
    del lag
    ginv, dinv = _inv(gamma), _inv(delta)
    ic, l_sc = _setup_scalars_kernel(npub, u, v, w, *(_mont_const(c, device) for c in (
        beta, alpha, ginv, dinv)))
    del w
    s = ntt.domain_root(k + 1)  # coset shift w_{2n}: s^n = -1
    c0 = (pow(tau, 2 * n, FR_MOD) - 1) * _inv(2 * n) % FR_MOD * dinv % FR_MOD
    h_sc = _h_scalars_kernel(k, _mont_const(tau, device), _mont_const(s, device),
                             torch.from_numpy(limb.int_to_limbs(c0)).to(device))
    scalars = {"a_query": u, "b1_query": v, "b2_query": v, "l_query": l_sc,
               "h_query": h_sc, "ic": ic}
    return k, scalars, (mat_a, mat_b)


G1_QUERIES = ("a_query", "b1_query", "l_query", "h_query", "ic")  # one K4 call, this order


def setup(cs: ConstraintSystem, rng=None, plan: bool = True, device=None,
          timings: dict | None = None):
    """Trusted setup (toxic waste sampled locally: fine for benchmarking and
    self-verification). Draws tau, alpha, beta, gamma, delta from `rng` in
    that order, computes the query scalars on `device` (setup_scalars_dev)
    and the query points with K4 there. With `plan` (the default, as
    pob_tpu's setup has it) the key gets its witness-MSM plan
    (attach_msm_plan); plan=False proves on the plain path. Returns
    (ProvingKey, VerifyingKey). With a `timings` dict, the seconds of the
    scalars, of the K4 calls, of the key's K3 bases (their windows by
    choose_windows) and of the plan are stored under "scalars_s", "k4_s",
    "bases_s" and "plan_s" (each synchronized)."""
    device = _build.resolve_device(device)
    return _setup(cs, rng, plan, device, timings,
                  lambda toxic: setup_scalars_dev(cs, toxic, device))


def setup_host(cs: ConstraintSystem, rng=None, plan: bool = True, device=None,
               timings: dict | None = None):
    """setup through host scalars (setup_scalars, python ints), pob_tpu's
    setup_host: the plain version of setup's scalars, the rest as setup;
    under the same rng the same key."""
    device = _build.resolve_device(device)
    return _setup(cs, rng, plan, device, timings, lambda toxic: setup_scalars(cs, toxic))


def _setup(cs, rng, plan, device, timings, scalars_fn):
    rnd = rng or (lambda: secrets.randbelow(FR_MOD - 1) + 1)
    toxic = tuple(rnd() for _ in range(5))
    _, alpha, beta, gamma, delta = toxic
    t0 = time.perf_counter()
    k, sc, host_mats = scalars_fn(toxic)
    _sync(device)
    t1 = time.perf_counter()

    a_q, b1_q, l_q, h_q, ic_q = _fixed_base_many("g1", [sc[q] for q in G1_QUERIES], device)
    (b2_q,) = _fixed_base_many("g2", [sc["b2_query"]], device)
    del sc
    _sync(device)
    t2 = time.perf_counter()

    pk = ProvingKey(
        k=k, num_public=cs.num_public,
        alpha1=g1_mul(G1_GEN, alpha), beta1=g1_mul(G1_GEN, beta),
        delta1=g1_mul(G1_GEN, delta), beta2=g2_mul(G2_GEN, beta),
        delta2=g2_mul(G2_GEN, delta),
        a_query=a_q, b1_query=b1_q, b2_query=b2_q, l_query=l_q, h_query=h_q,
        mats=_mats_to_device(host_mats, device),
    )
    t3 = time.perf_counter()
    bit = classify_bit_wires(cs) if plan else None  # the plan's bytes size the bases
    classify_s = time.perf_counter() - t3
    attach_bases(pk, plan, plan_nbytes(pk, bit) if plan else 0)
    _sync(device)
    t4 = time.perf_counter()
    if plan:
        pk.plan = MsmPlan(*(_plan_group(pk, g, names, bit) for g, names in PLAN_GROUPS))
        _sync(device)
    if timings is not None:
        timings.update(scalars_s=t1 - t0, k4_s=t2 - t1, bases_s=t4 - t3 - classify_s,
                       plan_s=time.perf_counter() - t4 + classify_s)
    vk = VerifyingKey(alpha1=pk.alpha1, beta2=pk.beta2, gamma2=g2_mul(G2_GEN, gamma),
                      delta2=pk.delta2, ic=curve.to_affine_host_batch("fq", ic_q))
    return pk, vk


# ---------------------------------------------------------------------------
# width-classified witness MSMs: the plan (pob_tpu's default prove path)
#
# Most wires of these circuits hold bits (keccak state, bit decompositions,
# one-hot selectors). The plan classifies every wire once per key: a bit
# wire's point is added when its value is 1, and a full wire j is expanded
# into its 254 doublings 2^k P_j, added where bit k of its value is set. So
# each witness MSM becomes one conditional-add sweep (K5) over the plan's
# points. Infinity query points (u_i(tau) = 0) are compacted away.
# ---------------------------------------------------------------------------


FULL_BITS = bitsum.FULL_BITS
PLAN_GROUPS = (("g1", ("a_query", "b1_query", "l_query")), ("g2", ("b2_query",)))
PLAN_PAD = 4096  # the plan's points per query are padded to a multiple of this
PLANNED_QUERIES = tuple(q for _, names in PLAN_GROUPS for q in names)


def classify_bit_wires(cs: ConstraintSystem) -> np.ndarray:
    """(num_wires,) bool: wires that hold a bit in any satisfying witness.
    The union of the blocks declared width 1 at allocation and the wires
    with a booleanity row w * w = w (one term in each of A, B and C, on the
    same wire, coefficient index 0, which the constraint system's palette
    reserves for 1)."""
    declared = cs.bit_wires_declared()
    ma, mb, mc, _ = cs.matrices_indexed()
    nrows = cs.num_constraints

    def single(rows, cols, cidx):
        is_single = np.bincount(rows, minlength=nrows) == 1
        wire = np.full(nrows, -1, np.int64)
        ok = np.zeros(nrows, bool)
        m = is_single[rows]
        wire[rows[m]] = cols[m]
        ok[rows[m]] = cidx[m] == 0
        return is_single, wire, ok

    sa, wa, ka = single(*ma)
    sb, wb, kb = single(*mb)
    sc, wc, kc = single(*mc)
    rows_bool = sa & sb & sc & ka & kb & kc & (wa == wb) & (wb == wc)
    bit = np.zeros(cs.num_wires, bool)
    bit[wa[rows_bool]] = True
    return bit | declared


@dataclass
class PlanGroup:
    """One group's planned witness MSMs (queries stacked on axis 0), on the
    key's device. pts (q, M, 16 | 32) int32: packed affine words (x then y,
    Montgomery, (0, 0) for infinity), per query [bit points | (0, 0) up to
    mb | the 254 doublings of each full wire's point, wire-major | (0, 0)
    up to M]; bit_idx (q, mb) and full_idx (q, mf) int32: absolute wire
    indices (0 past a query's count); counts (q, 2) int32: the true
    (n_bit, n_full) of each query, so the padding costs nothing."""

    pts: torch.Tensor
    bit_idx: torch.Tensor
    full_idx: torch.Tensor
    counts: torch.Tensor

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.pts, self.bit_idx, self.full_idx, self.counts))


@dataclass
class MsmPlan:
    """The witness-MSM plan of a key: g1 holds the a, b1 and l queries (in
    that order), g2 the b2 query."""

    g1: PlanGroup
    g2: PlanGroup

    def nbytes(self) -> int:
        return self.g1.nbytes() + self.g2.nbytes()


def _padded_to(n: int, mult: int) -> int:
    n = max(n, 1)
    mult = min(mult, 1 << (n - 1).bit_length())  # tiny circuits stay small
    return -(-n // mult) * mult


def _wire_offset(pk: ProvingKey, name: str) -> int:
    return pk.num_public + 1 if name == "l_query" else 0


def _plan_layout(pk: ProvingKey, names, bit):
    """One group's plan layout: ({query: (its live bit wires, its live full
    wires)}, mb, mf, M), live meaning a finite query point."""
    idx = {}
    for name in names:
        z = getattr(pk, name)[2]
        live = (z.reshape(z.shape[0], -1) != 0).any(1).cpu().numpy()
        wires = np.arange(len(live)) + _wire_offset(pk, name)
        idx[name] = (np.nonzero(bit[wires] & live)[0], np.nonzero(~bit[wires] & live)[0])
    mb = max(len(b) for b, _ in idx.values())
    mf = max(max(len(f) for _, f in idx.values()), 1)
    return idx, mb, mf, _padded_to(mb + mf * FULL_BITS, PLAN_PAD)


def plan_nbytes(pk: ProvingKey, bit) -> int:
    """The device bytes of the plan _plan_group builds for the key (MsmPlan's
    nbytes), from its layout alone."""
    total = 0
    for group, names in PLAN_GROUPS:
        _, mb, mf, M = _plan_layout(pk, names, bit)
        total += len(names) * (M * msm._bases_width(group) + mb + mf + 2) * 4
    return total


def _plan_group(pk: ProvingKey, group: str, names, bit) -> PlanGroup:
    """Build one group's plan on the key's device: the live bit points from
    the key's affine bases (window 0 is P_i, packed affine: a gather, with
    no transient copy beside a key that fills most of the card) or, on the
    CPU, where the key has no bases, by K6 at (1, 0); the full points
    gathered from the Jacobian queries and expanded by one K6 call at
    (254, 1) for the whole group."""
    dev = getattr(pk, names[0])[0].device
    idx, mb, mf, M = _plan_layout(pk, names, bit)

    def gather(k):  # the group's Jacobian points of bit (k = 0) or full wires
        pts = [tuple(c[torch.from_numpy(idx[n][k]).to(dev)] for c in getattr(pk, n))
               for n in names]
        return tuple(torch.cat(cs, 0) for cs in zip(*pts))

    width = msm._bases_width(group)
    pts = torch.zeros((len(names), M, width), dtype=torch.int32, device=dev)
    bits = None if pk.bases is not None else msm.affine_bases(group, gather(0), 1, 0)
    chains = msm.affine_bases(group, gather(1), FULL_BITS, 1, wire_major=True)
    bit_idx = np.zeros((len(names), mb), np.int32)
    full_idx = np.zeros((len(names), mf), np.int32)
    counts = np.zeros((len(names), 2), np.int32)
    ob = of = 0
    for qi, name in enumerate(names):
        b, f = idx[name]
        pts[qi, :len(b)] = (pk.bases[name][torch.from_numpy(b).to(dev)] if bits is None
                            else bits[ob:ob + len(b)])
        pts[qi, mb:mb + len(f) * FULL_BITS] = chains[of * FULL_BITS:(of + len(f)) * FULL_BITS]
        ob, of = ob + len(b), of + len(f)
        off = _wire_offset(pk, name)
        bit_idx[qi, :len(b)] = b + off
        full_idx[qi, :len(f)] = f + off
        counts[qi] = (len(b), len(f))
    return PlanGroup(pts, *(torch.from_numpy(a).to(dev) for a in (bit_idx, full_idx, counts)))


def _group_to_npz(group: str, g: PlanGroup, arrs: dict):
    """pob_tpu's plan arrays of one group: Jacobian 16-bit limbs (uint32),
    Z = 1 for finite points and pob_tpu's infinity (X = Y = R mod q in every
    coordinate limb row, Z = 0); index arrays int32."""
    q, M, width = g.pts.shape
    x, y, z = msm.packed_to_jacobian(group, g.pts.reshape(q * M, width))
    inf = (z.reshape(q * M, -1) == 0).all(1)
    for ci, c in enumerate((x, y, z)):
        if ci < 2:
            c[inf] = torch.from_numpy(_R_FQ_LIMBS).to(c.device)
        arrs[f"{group}_pts{ci}"] = c.reshape((q, M) + c.shape[1:]).cpu().numpy().astype(np.uint32)
    arrs[f"{group}_bit_idx"] = g.bit_idx.cpu().numpy().astype(np.int32)
    arrs[f"{group}_full_idx"] = g.full_idx.cpu().numpy().astype(np.int32)


def _group_from_npz(group: str, d, device) -> PlanGroup:
    """A group of a plan file written by pob_tpu's attach_msm_plan (or by
    the port): the Jacobian points to packed affine by K6 at (1, 0), the
    counts from the points (a query's live points come first in each of its
    two blocks)."""
    coords = [torch.from_numpy(np.asarray(d[f"{group}_pts{i}"]).astype(np.int32)).to(device)
              for i in range(3)]
    q, M = coords[0].shape[:2]
    width = msm._bases_width(group)
    flat = tuple(c.reshape((q * M,) + c.shape[2:]).contiguous() for c in coords)
    pts = msm.affine_bases(group, flat, 1, 0).reshape(q, M, width)
    bit_idx = torch.from_numpy(np.asarray(d[f"{group}_bit_idx"], np.int32)).to(device)
    full_idx = torch.from_numpy(np.asarray(d[f"{group}_full_idx"], np.int32)).to(device)
    mb, mf = bit_idx.shape[1], full_idx.shape[1]
    live = (pts != 0).any(-1)
    heads = live[:, mb:mb + mf * FULL_BITS].reshape(q, mf, FULL_BITS)[..., 0]
    counts = torch.stack([live[:, :mb].sum(1), heads.sum(1)], 1).to(torch.int32)
    return PlanGroup(pts, bit_idx, full_idx, counts)


def attach_msm_plan(pk: ProvingKey, cs: ConstraintSystem,
                    cache_path: str | None = None) -> ProvingKey:
    """Build the key's witness-MSM plan (MsmPlan) on its device, from the
    constraint system's bit classification (classify_bit_wires) and the
    key's query points. With `cache_path`: if the file exists it is read
    (the .npz of pob_tpu's attach_msm_plan, or of this function), else the
    plan is built and written there in pob_tpu's format, which pob_tpu's
    attach_msm_plan reads."""
    dev = pk.a_query[0].device
    if cache_path is not None and os.path.exists(cache_path):
        with np.load(cache_path) as d:
            pk.plan = MsmPlan(*(_group_from_npz(g, d, dev) for g, _ in PLAN_GROUPS))
        return pk
    bit = classify_bit_wires(cs)
    pk.plan = MsmPlan(*(_plan_group(pk, g, names, bit) for g, names in PLAN_GROUPS))
    if cache_path is not None:
        arrs = {}
        for g, _ in PLAN_GROUPS:
            _group_to_npz(g, getattr(pk.plan, g), arrs)
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, cache_path)
    return pk


def uses_plan(pk: ProvingKey) -> bool:
    """Whether prove_batch takes the planned path: the key has a plan and
    POB_NO_PLAN is not 1 / true (pob_tpu's parse)."""
    no_plan = os.environ.get("POB_NO_PLAN", "0").strip().lower()
    return pk.plan is not None and no_plan not in ("1", "true")


# ---------------------------------------------------------------------------
# per-proof computation
# ---------------------------------------------------------------------------


MATVEC_CHUNK = 1 << 20  # nonzeros, then rows, per step of sparse_matvec_mont


def sparse_matvec_mont(mat, W, n: int):
    """COO (rows, cols, coeffs = c*R^2) x canonical witnesses W (B, nw, 16)
    -> (B, n, 16) Montgomery. Per-nonzero K1 multiply, a limb-wise int64
    index_add_ into rows, carry normalization, one K1 REDC and one K1
    multiply by R^2 per row. Per-row term counts are small, so each wide
    row sum stays below p R before the REDC. Both passes go MATVEC_CHUNK
    nonzeros or rows at a time, which bounds their temporaries (a few GB
    at domain 2^22, batch 4); integer sums make the result the same for
    any chunk size."""
    rows, cols, coeffs = mat
    B = W.shape[0]
    sums = torch.zeros(B, n, limb.L, dtype=torch.int64, device=W.device)
    for o in range(0, rows.shape[0], MATVEC_CHUNK):
        c = slice(o, o + MATVEC_CHUNK)
        terms = limb.mont_mul(FRS, coeffs[c], W[:, cols[c]])  # (B, chunk, 16) Montgomery
        sums.index_add_(1, rows[c], terms.to(torch.int64))  # limbs < count * 2^16
    out = torch.empty(B, n, limb.L, dtype=torch.int32, device=W.device)
    for o in range(0, n, MATVEC_CHUNK):
        c = slice(o, o + MATVEC_CHUNK)
        norm = limb.carry_fix(torch.nn.functional.pad(sums[:, c], (0, limb.L)), 40)
        red = limb.mont_reduce(FRS, norm.to(torch.int32))  # = S R^{-1}
        out[:, c] = limb.mont_mul(FRS, red, limb.const(_R2_LIMBS, red))  # = S
    return out


def compute_h(k: int, mats, W, laps: DeviceLaps | None = None):
    """Coset evaluations of A.B - C for a witness batch W (B, nw, 16): (B, n,
    16) canonical limbs on the coset x_j = w_{2n} w_n^j. C on the domain is
    A.B, so two sparse mat-vecs and six transforms suffice. Spans "h.matvec"
    and "h.ntt" (the rest); with laps, their device seconds under
    "h_matvec_s" and "h_ntt_s"."""
    n = 1 << k
    with METRICS.span("h.matvec"), lap(laps, "h_matvec_s"):
        aw = sparse_matvec_mont(mats[0], W, n)
        bw = sparse_matvec_mont(mats[1], W, n)
    with METRICS.span("h.ntt"), lap(laps, "h_ntt_s"):
        cw = limb.mont_mul(FRS, aw, bw)
        shift = ntt.domain_root(k + 1)
        ea, eb, ec = (ntt.coeffs_to_coset_evals(ntt.intt(x, k), k, shift)
                      for x in (aw, bw, cw))
        return limb.from_mont(FRS, limb.sub(FRS, limb.mont_mul(FRS, ea, eb), ec))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Bytes per proof that the h stage holds at its peak, per domain row: the
# mat-vec's int64 sums (128 B) and the three vectors A.W, B.W, C.W (3 x 64 B);
# and per row of one MATVEC_CHUNK step: the carry fix's (32-column) int64
# copies of the row's sums, eight at most alive at once (2 KB). At domain
# 2^22 that is 3.49 GB per proof; on an H100 the PoB h stage added 3.08 GB
# per proof to the peak, at batch 4 and in chunks of 6 (chip_smoke phase 5).
H_BYTES_PER_ROW = 128 + 3 * 64
MATVEC_TMP_BYTES = 8 * 256
MEM_SHARE = 0.9  # of the card's free memory one chunk of prove_batch may plan to use


def h_stage_bytes(k: int) -> int:
    """Device bytes one proof adds to the h stage's peak at domain 2^k."""
    n = 1 << k
    return H_BYTES_PER_ROW * n + MATVEC_TMP_BYTES * min(MATVEC_CHUNK, n)


def batch_chunk(pk: ProvingKey, B: int, device) -> int:
    """Proofs per pass of prove_batch: at most what K3's int32 indexing
    allows over the key's largest query (msm.k3_max_batch), and on the card
    at most what free device memory (the caching allocator's free blocks
    included) holds of the h stage's temporaries (h_stage_bytes)."""
    chunk = msm.k3_max_batch(max(1 << pk.k, int(pk.a_query[0].shape[0])))
    if device.type == "cuda":
        chunk = min(chunk, int(device_free_bytes(device) * MEM_SHARE) // h_stage_bytes(pk.k))
    return max(1, min(B, chunk))


def prove_batch(pk: ProvingKey, W, rs=None, timings: dict | None = None):
    """Batched Groth16: W (B, num_wires, 16) canonical limbs (wire 0 = 1) ->
    list of B (A, B2, C) proofs (host affine points). rs: optional list of
    (r, s) blinding pairs. The MSMs take the planned path when the key has a
    plan (uses_plan), with the same proofs as the plain path. Any B: the h
    stage, the MSMs and the host tail go batch_chunk proofs at a time, and a
    proof does not depend on its chunk.
    Spans (METRICS): "prove_batch" (attrs batch, chunk), one "prove.chunk"
    per chunk holding compute_h's and msm_stage's, and one
    "host_tail.finish_proof" per proof.
    With a `timings` dict, the h stage and the MSMs are synchronized and
    their seconds over all chunks stored under "h_s" and "msm_s", and the
    chunk under "chunk"; summed over chunks, the device seconds of the
    mat-vec, the rest of the h stage, K3 and K5 ("h_matvec_s", "h_ntt_s",
    "msm_k3_s", "msm_k5_s": CUDA events read once the sums reach the
    host), the host seconds of finish_proof ("finish_s"), and the kernel
    launches of the call by kernel ("launches")."""
    B = int(W.shape[0])
    chunk = batch_chunk(pk, B, W.device)
    proofs, h_s, msm_s, finish_s = [], 0.0, 0.0, 0.0
    laps = DeviceLaps(W.device) if timings is not None else None
    launches0 = dict(_build.LAUNCHES)
    with METRICS.span("prove_batch", batch=B, chunk=chunk):
        for o in range(0, B, chunk):
            with METRICS.span("prove.chunk"):
                Wc = W[o:o + chunk]
                t0 = time.perf_counter()
                h = compute_h(pk.k, pk.mats, Wc, laps)
                if timings is not None:
                    _sync(W.device)
                    t1 = time.perf_counter()
                sums = [tuple(c.cpu().numpy() for c in p) if p is not None else None
                        for p in msm_stage(pk, Wc, h, laps)]
                del h
                if timings is not None:
                    h_s += t1 - t0
                    msm_s += time.perf_counter() - t1
                    laps.read()
                for i in range(int(Wc.shape[0])):
                    si = [tuple(c[i] for c in p) if p is not None else None for p in sums]
                    r, s = rs[o + i] if rs is not None else (None, None)
                    t2 = time.perf_counter()
                    with METRICS.span("host_tail.finish_proof"):
                        proofs.append(finish_proof(pk, si, r, s))
                    finish_s += time.perf_counter() - t2
    if timings is not None:
        timings.update(h_s=h_s, msm_s=msm_s, chunk=chunk,
                       **{k: laps.totals.get(k, 0.0)
                          for k in ("h_matvec_s", "h_ntt_s", "msm_k3_s", "msm_k5_s")},
                       finish_s=finish_s, launches=launches_since(launches0))
    return proofs


def prove(pk: ProvingKey, witness_limbs, r: int | None = None, s: int | None = None):
    """One proof: witness_limbs (num_wires, 16) canonical limbs with w[0] ==
    1 -> (A, B2, C) host affine points, through prove_batch at B = 1 on the
    key's device."""
    dev = pk.a_query[0].device
    W = torch.as_tensor(np.asarray(witness_limbs, np.int32)) if not torch.is_tensor(
        witness_limbs) else witness_limbs
    return prove_batch(pk, W.to(dev)[None], rs=[(r, s)])[0]


def msm_stage(pk: ProvingKey, W, h, laps: DeviceLaps | None = None):
    """The five MSMs of a batch on W's device, left there: (A, B1, B2, L, H)
    sums, (B,) Jacobian each (L is None for a key without private wires on
    the plain path). On the planned path (uses_plan) A, B1 and L come from
    one K5 call on G1 and B2 from one on G2; H, and every MSM of the plain
    path, is a K3 call. On the card nothing is read back to the host. Spans
    "msm.k5" and "msm.k3", one per call; with laps, their device seconds
    under "msm_k5_s" and "msm_k3_s"."""
    npub = pk.num_public
    scalars = {"a_query": W, "b1_query": W, "b2_query": W, "l_query": W[:, npub + 1:],
               "h_query": h}
    planned = {}
    if uses_plan(pk):
        for group, names in PLAN_GROUPS:
            g = getattr(pk.plan, group)
            with METRICS.span("msm.k5"), lap(laps, "msm_k5_s"):
                sums = bitsum.bitsum_msm(group, g.pts, g.bit_idx, g.full_idx, g.counts, W)
            planned.update({q: tuple(c[i] for c in sums) for i, q in enumerate(names)})

    def one(q, group):
        if q in planned:
            return planned[q]
        if q == "l_query" and not int(pk.l_query[0].shape[0]):
            return None
        with METRICS.span("msm.k3"), lap(laps, "msm_k3_s"):
            return msm.msm_batched(group, getattr(pk, q), scalars[q],
                                   pk.bases and pk.bases[q])

    return [one(q, g) for q, g in MSM_QUERIES]


def finish_proof(pk: ProvingKey, sums, r: int | None = None, s: int | None = None):
    """Host tail of a proof: fold the five MSM sums with the blinding scalars
    r, s into the final (A, B2, C) affine points."""
    if r is None:
        r = secrets.randbelow(FR_MOD)
    if s is None:
        s = secrets.randbelow(FR_MOD)
    a_sum, b1_sum, b2_sum, c_l, c_h = sums

    def aff1(p):
        return curve.to_affine_host("fq", p)

    A = g1_add(g1_add(pk.alpha1, aff1(a_sum)), g1_mul(pk.delta1, r))
    B2 = g2_add(g2_add(pk.beta2, curve.to_affine_host("fq2", b2_sum)), g2_mul(pk.delta2, s))
    B1 = g1_add(g1_add(pk.beta1, aff1(b1_sum)), g1_mul(pk.delta1, s))

    C = aff1(c_h)
    if c_l is not None:
        C = g1_add(C, aff1(c_l))
    C = g1_add(C, g1_mul(A, s))
    C = g1_add(C, g1_mul(B1, r))
    C = g1_add(C, g1_neg(g1_mul(pk.delta1, r * s % FR_MOD)))
    return (A, B2, C)


def verify(vk: VerifyingKey, proof, public_inputs) -> bool:
    """public_inputs: list of Fr ints (len num_public)."""
    A, B2, C = proof
    ic = vk.ic[0]
    for x, pt in zip(public_inputs, vk.ic[1:]):
        ic = g1_add(ic, g1_mul(pt, x))
    return pairing_product_is_one(
        [(g1_neg(A), B2), (vk.alpha1, vk.beta2), (ic, vk.gamma2), (C, vk.delta2)]
    )


# ---------------------------------------------------------------------------
# proving-key interchange: the npz of save_pk (pob_tpu's save_pk writes the
# same arrays), and snarkjs .zkey files (prover/serialize.py)
# ---------------------------------------------------------------------------


def _enc_int(x: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(32, "little"), np.uint8)


def _enc_g1(p) -> np.ndarray:
    if p is None:
        return np.zeros(64, np.uint8)
    return np.concatenate([_enc_int(p[0]), _enc_int(p[1])])


def _enc_g2(p) -> np.ndarray:
    if p is None:
        return np.zeros(128, np.uint8)
    return np.concatenate([_enc_int(v) for c in p for v in c])


def save_pk(path: str, pk: ProvingKey, vk: VerifyingKey):
    """Write pk and vk as raw arrays (npz), the names and dtypes of
    pob_tpu's save_pk: limbs uint32, matrix indices int32. load_pk reads it
    back, and so does pob_tpu's load_pk."""
    arrs = {
        "k": np.int64(pk.k),
        "num_public": np.int64(pk.num_public),
        "alpha1": _enc_g1(pk.alpha1), "beta1": _enc_g1(pk.beta1),
        "delta1": _enc_g1(pk.delta1), "beta2": _enc_g2(pk.beta2),
        "delta2": _enc_g2(pk.delta2), "gamma2": _enc_g2(vk.gamma2),
        "ic": np.stack([_enc_g1(p) for p in vk.ic]),
    }
    for name, _ in MSM_QUERIES:
        for ci, c in enumerate(getattr(pk, name)):
            arrs[f"{name}{ci}"] = c.cpu().numpy().astype(np.uint32)
    for mi, (rows, cols, cf) in enumerate(pk.mats):
        arrs[f"m{mi}_rows"] = rows.cpu().numpy().astype(np.int32)
        arrs[f"m{mi}_cols"] = cols.cpu().numpy().astype(np.int32)
        arrs[f"m{mi}_cf"] = cf.cpu().numpy().astype(np.uint32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def _dec_int(a) -> int:
    return int.from_bytes(bytes(np.asarray(a, np.uint8)), "little")


def _dec_g1(a):
    x, y = _dec_int(a[:32]), _dec_int(a[32:])
    return None if x == 0 and y == 0 else (x, y)


def _dec_g2(a):
    v = [_dec_int(a[32 * i: 32 * (i + 1)]) for i in range(4)]
    return None if all(c == 0 for c in v) else ((v[0], v[1]), (v[2], v[3]))


def pk_from_arrays(d, device=None):
    """The arrays of a saved key (same names as the npz of save_pk) ->
    (ProvingKey, VerifyingKey) with the query points and matrices on
    `device`."""
    device = _build.resolve_device(device)

    def pts(name):
        return tuple(limb.to_device(d[f"{name}{i}"], device) for i in range(3))

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    pk = ProvingKey(
        k=int(d["k"]), num_public=int(d["num_public"]),
        alpha1=_dec_g1(d["alpha1"]), beta1=_dec_g1(d["beta1"]),
        delta1=_dec_g1(d["delta1"]), beta2=_dec_g2(d["beta2"]),
        delta2=_dec_g2(d["delta2"]),
        a_query=pts("a_query"), b1_query=pts("b1_query"), b2_query=pts("b2_query"),
        l_query=pts("l_query"), h_query=pts("h_query"),
        mats=tuple((idx(d[f"m{i}_rows"]), idx(d[f"m{i}_cols"]),
                    limb.to_device(d[f"m{i}_cf"], device)) for i in range(2)),
    )
    attach_bases(pk)
    vk = VerifyingKey(alpha1=pk.alpha1, beta2=pk.beta2, gamma2=_dec_g2(d["gamma2"]),
                      delta2=pk.delta2, ic=[_dec_g1(p) for p in d["ic"]])
    return pk, vk


def load_pk(path: str, device=None):
    """Read a key saved by pob_tpu.prover.groth16.save_pk (numpy only)."""
    with np.load(path) as d:
        return pk_from_arrays({k: d[k] for k in d.files}, device)


def _limbs_to_device(arr, device):
    """(..., 16) uint16 host limbs -> int32 limb tensor on `device` (sent as
    16 bits, widened there)."""
    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(device)
    return t.to(torch.int32) & limb.MASK


def _affine_limbs_to_jac(arr, device, g2: bool = False):
    """(m, 2 | 4, 16) uint16 affine Montgomery limbs (x then y; all zero for
    infinity) -> Jacobian point tensors on `device`, Z = R (Montgomery one)
    or 0 at infinity."""
    t = _limbs_to_device(arr, device)
    per = t.shape[1] // 2
    x, y = t[:, :per], t[:, per:]
    if not g2:
        x, y = x[:, 0], y[:, 0]
    z = torch.zeros_like(x)
    (z[:, 0] if g2 else z)[:] = torch.from_numpy(_R_FQ_LIMBS).to(device)
    z[(t == 0).flatten(1).all(1)] = 0
    return x.contiguous(), y.contiguous(), z


def zkey_vk(d: dict) -> VerifyingKey:
    """The VerifyingKey held in read_zkey's materials (host only)."""
    return VerifyingKey(alpha1=d["alpha1"], beta2=d["beta2"], gamma2=d["gamma2"],
                        delta2=d["delta2"], ic=d["ic"])


def load_zkey(path: str, device=None):
    """Build a ProvingKey and VerifyingKey from a snarkjs Groth16 .zkey file
    (serialize.read_zkey), the query points and matrices on `device`. The
    coefficients, stored as c R, become the key's c R^2 by one product with
    R^2 (K1 on the card); a foreign zkey has no palette, so every entry keeps
    its own coefficient. The affine bases are made as at setup."""
    from .serialize import ZkeyFormatError, read_zkey

    device = _build.resolve_device(device)
    d = read_zkey(path)
    k = _next_pow2(d["domain_size"])
    if (1 << k) != d["domain_size"]:
        raise ZkeyFormatError(f"zkey domain size {d['domain_size']} is not a power of two")
    mats = []
    for midx in (0, 1):
        rows, cols, vals = d["coeffs"][midx]
        cf = limb.mont_mul(FRS, _limbs_to_device(vals, device),
                           torch.from_numpy(_R2_LIMBS).to(device))
        mats.append(tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                          for a in (rows, cols)) + (cf,))
    pk = ProvingKey(
        k=k, num_public=d["n_public"],
        alpha1=d["alpha1"], beta1=d["beta1"], delta1=d["delta1"],
        beta2=d["beta2"], delta2=d["delta2"],
        a_query=_affine_limbs_to_jac(d["a_pts"], device),
        b1_query=_affine_limbs_to_jac(d["b1_pts"], device),
        b2_query=_affine_limbs_to_jac(d["b2_pts"], device, g2=True),
        l_query=_affine_limbs_to_jac(d["c_pts"], device),
        h_query=_affine_limbs_to_jac(d["h_pts"], device),
        mats=tuple(mats),
    )
    attach_bases(pk)
    return pk, zkey_vk(d)
