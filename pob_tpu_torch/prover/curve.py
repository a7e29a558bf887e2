"""BN254 curve arithmetic on tensors: Jacobian G1 (over Fq) and G2 (over Fq2),
generic over the coordinate field so both share one set of complete
branchless add/double formulas (selects, never data-dependent control flow).

Points: tuple (X, Y, Z) of coordinate tensors in Montgomery form, (m, 16) on
G1 and (m, 2, 16) on G2; the point at infinity is Z == 0, written as
(one, one, 0). These are the plain PyTorch versions of the device functions
in ``csrc/curve.cuh``: on the card, point arithmetic runs inside the
kernels, so with FqOps / Fq2Ops these formulas call the plain field
functions (``limb.*_plain``) on whatever device their tensors lie, and are
the plain versions those kernels are checked against. FqOpsK1 / Fq2OpsK1
give the same formulas K1's field products and sums on the card, for the
few point adds outside a kernel (the sharded MSM's reduction)."""

from __future__ import annotations

import numpy as np
import torch

from ..field import limb
from ..field.limb import FQ
from ..field.ref import FQ_MOD, fq2_inv, fq2_mul, fq2_sqr

_R = (1 << 256) % FQ_MOD
_R_INV = pow(_R, FQ_MOD - 2, FQ_MOD)


class FqOps:
    """Coordinate ops for Fq: element shape (..., 16)."""

    name = "fq"
    coord_shape = (limb.L,)

    @staticmethod
    def mul(a, b):
        return limb.mont_mul_plain(FQ, a, b)

    @staticmethod
    def sqr(a):
        return limb.mont_mul_plain(FQ, a, a)

    @staticmethod
    def add(a, b):
        return limb.add_plain(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return limb.sub_plain(FQ, a, b)

    @staticmethod
    def neg(a):
        return limb.sub_plain(FQ, torch.zeros_like(a), a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond[..., None], a, b)

    @staticmethod
    def zeros(batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (limb.L,), dtype=torch.int32, device=device)

    @staticmethod
    def one(batch_shape, device):
        one = torch.from_numpy(limb.int_to_limbs(_R)).to(device)
        return one.expand(tuple(batch_shape) + (limb.L,)).clone()


class Fq2Ops:
    """Coordinate ops for Fq2 = Fq[u]/(u^2+1): element shape (..., 2, 16),
    every Fq product and sum through the Fq ops `fq`."""

    name = "fq2"
    coord_shape = (2, limb.L)
    fq = FqOps

    @classmethod
    def mul(cls, a, b):
        # Karatsuba, the three Fq products stacked into one batched multiply
        f = cls.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        am = torch.stack(torch.broadcast_tensors(a0, a1, f.add(a0, a1)), -2)
        bm = torch.stack(torch.broadcast_tensors(b0, b1, f.add(b0, b1)), -2)
        t = f.mul(am, bm)
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        c0 = f.sub(t0, t1)
        c1 = f.sub(f.sub(t2, t0), t1)
        return torch.stack([c0, c1], -2)

    @classmethod
    def sqr(cls, a):
        # (c0 + c1 u)^2: c0' = (c0+c1)(c0-c1), c1' = 2 c0 c1
        f = cls.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        am = torch.stack([f.add(a0, a1), a0], -2)
        bm = torch.stack([f.sub(a0, a1), a1], -2)
        t = f.mul(am, bm)
        return torch.stack([t[..., 0, :], f.add(t[..., 1, :], t[..., 1, :])], -2)

    @classmethod
    def add(cls, a, b):
        return cls.fq.add(a, b)

    @classmethod
    def sub(cls, a, b):
        return cls.fq.sub(a, b)

    @classmethod
    def neg(cls, a):
        return cls.fq.neg(a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    @staticmethod
    def zeros(batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (2, limb.L), dtype=torch.int32, device=device)

    @staticmethod
    def one(batch_shape, device):
        c0 = FqOps.one(batch_shape, device)
        return torch.stack([c0, torch.zeros_like(c0)], -2)


class FqOpsK1(FqOps):
    """FqOps through the dispatching field functions: K1 on a CUDA tensor,
    the plain versions on a CPU one. For point arithmetic outside the
    kernels (the tree reduction of dist/msm_sharded.py), as pob_tpu's
    curve ops go through its limb.mont_mul."""

    @staticmethod
    def mul(a, b):
        return limb.mont_mul(FQ, a, b)

    @staticmethod
    def sqr(a):
        return limb.mont_sqr(FQ, a)

    @staticmethod
    def add(a, b):
        return limb.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return limb.sub(FQ, a, b)

    @staticmethod
    def neg(a):
        return limb.neg(FQ, a)


class Fq2OpsK1(Fq2Ops):
    """Fq2Ops over FqOpsK1."""

    fq = FqOpsK1


def ops_for(group: str):
    return FqOps if group == "g1" else Fq2Ops


def k1_ops_for(group: str):
    return FqOpsK1 if group == "g1" else Fq2OpsK1


def _stack(ops, elems):
    return torch.stack(torch.broadcast_tensors(*elems), -(len(ops.coord_shape) + 1))


def _unstack(ops, arr, n: int):
    return list(arr.unbind(-(len(ops.coord_shape) + 1)))[:n]


def mul_many(ops, pairs):
    """Independent products stacked into ONE batched multiply (fewer, larger
    tensor ops)."""
    out = ops.mul(_stack(ops, [a for a, _ in pairs]), _stack(ops, [b for _, b in pairs]))
    return _unstack(ops, out, len(pairs))


def sqr_many(ops, elems):
    return _unstack(ops, ops.sqr(_stack(ops, elems)), len(elems))


def point_double(ops, p):
    """Jacobian doubling (a = 0 curve). Infinity-safe (Z=0 stays Z=0)."""
    x, y, z = p
    a, b = sqr_many(ops, [x, y])
    c, t = sqr_many(ops, [b, ops.add(x, b)])
    tac = ops.sub(ops.sub(t, a), c)
    d = ops.add(tac, tac)  # 2(t-a-c)
    e = ops.add(ops.add(a, a), a)  # 3a
    f = ops.sqr(e)
    x3 = ops.sub(f, ops.add(d, d))
    c4 = ops.add(ops.add(c, c), ops.add(c, c))
    c8 = ops.add(c4, c4)
    y3m, z3 = mul_many(ops, [(e, ops.sub(d, x3)), (ops.add(y, y), z)])
    return (x3, ops.sub(y3m, c8), z3)


def point_add(ops, p, q):
    """Complete Jacobian addition via branchless selects: the infinity,
    doubling (P == Q) and cancel (P == -Q) cases are all handled."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    p_inf = ops.is_zero(z1)
    q_inf = ops.is_zero(z2)

    z1z1, z2z2 = sqr_many(ops, [z1, z2])
    u1, u2, t1, t2 = mul_many(ops, [(x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1)])
    s1, s2 = mul_many(ops, [(t1, z2z2), (t2, z1z1)])
    h = ops.sub(u2, u1)
    r = ops.sub(s2, s1)
    h_zero = ops.is_zero(h)
    r_zero = ops.is_zero(r)

    hh, rr = sqr_many(ops, [h, r])
    hhh, v, w = mul_many(ops, [(h, hh), (u1, hh), (z1, z2)])
    x3 = ops.sub(ops.sub(rr, hhh), ops.add(v, v))
    ya, yb, z3 = mul_many(ops, [(r, ops.sub(v, x3)), (s1, hhh), (w, h)])
    y3 = ops.sub(ya, yb)

    dbl = point_double(ops, p)
    both = ~p_inf & ~q_inf
    is_dbl = both & h_zero & r_zero
    is_cancel = both & h_zero & ~r_zero

    x3 = ops.select(is_dbl, dbl[0], x3)
    y3 = ops.select(is_dbl, dbl[1], y3)
    z3 = ops.select(is_dbl, dbl[2], z3)
    z3 = ops.select(is_cancel, torch.zeros_like(z3), z3)
    x3 = ops.select(p_inf, x2, x3)
    y3 = ops.select(p_inf, y2, y3)
    z3 = ops.select(p_inf, z2, z3)
    x3 = ops.select(q_inf, x1, x3)
    y3 = ops.select(q_inf, y1, y3)
    z3 = ops.select(q_inf, z1, z3)
    return (x3, y3, z3)


def points_equal(ops, p, q):
    """(m,) bool: P_i and Q_i are the same affine point (X1 Z2^2 = X2 Z1^2 and
    Y1 Z2^3 = Y2 Z1^3; infinity equals only infinity). No inversion, so it
    compares millions of points on the device."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = sqr_many(ops, [z1, z2])
    u1, u2, t1, t2 = mul_many(ops, [(x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1)])
    s1, s2 = mul_many(ops, [(t1, z2z2), (t2, z1z1)])
    inf1, inf2 = ops.is_zero(z1), ops.is_zero(z2)
    same = ops.is_zero(ops.sub(u1, u2)) & ops.is_zero(ops.sub(s1, s2))
    return torch.where(inf1 | inf2, inf1 & inf2, same)


def infinity(ops, batch_shape, device):
    return (ops.one(batch_shape, device), ops.one(batch_shape, device),
            ops.zeros(batch_shape, device))


def tree_reduce(ops, p, dim: int = 0):
    """Sum points along batch axis `dim` via a log-depth add tree."""
    x, y, z = (c.movedim(dim, 0) for c in p)
    while x.shape[0] > 1:
        m = x.shape[0]
        half = m // 2
        s = point_add(ops, (x[:half], y[:half], z[:half]),
                      (x[half:2 * half], y[half:2 * half], z[half:2 * half]))
        if m % 2:
            s = tuple(torch.cat([a, c[2 * half:]], 0) for a, c in zip(s, (x, y, z)))
        x, y, z = s
    return (x[0], y[0], z[0])


def times_pow2(ops, p, s: int):
    """2^s * P by s doublings."""
    for _ in range(s):
        p = point_double(ops, p)
    return p


# ---------------------------------------------------------------------------
# host <-> device point conversion
# ---------------------------------------------------------------------------


def _dec(v) -> int:
    return limb.limbs_to_int(v) * _R_INV % FQ_MOD


def to_affine_host(ops_name: str, p):
    """Host-side Jacobian -> affine for a single point (python ints, None at
    infinity). p: (X, Y, Z) arrays or tensors of one point."""
    x, y, z = (np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c) for c in p)
    if ops_name == "fq":
        zi = _dec(z)
        if zi == 0:
            return None
        zinv = pow(zi, FQ_MOD - 2, FQ_MOD)
        return (_dec(x) * zinv * zinv % FQ_MOD, _dec(y) * zinv * zinv % FQ_MOD * zinv % FQ_MOD)
    z2 = (_dec(z[0]), _dec(z[1]))
    if z2 == (0, 0):
        return None
    zinv = fq2_inv(z2)
    zinv2 = fq2_sqr(zinv)
    zinv3 = fq2_mul(zinv2, zinv)
    return (fq2_mul((_dec(x[0]), _dec(x[1])), zinv2),
            fq2_mul((_dec(y[0]), _dec(y[1])), zinv3))


def to_affine_host_batch(ops_name: str, p) -> list:
    """(m,) Jacobian points -> list of m affine points (host ints)."""
    x, y, z = (c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c) for c in p)
    return [to_affine_host(ops_name, (x[i], y[i], z[i])) for i in range(x.shape[0])]


def g1_points_to_device(points, device) -> tuple:
    """Affine G1 python-int points (or None) -> Jacobian (m, 16) x3 tensors,
    Montgomery form."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(_R)
            ys.append(_R)
            zs.append(0)
        else:
            xs.append(pt[0] * _R % FQ_MOD)
            ys.append(pt[1] * _R % FQ_MOD)
            zs.append(_R)
    return tuple(limb.to_device(limb.ints_to_limbs(v), device) for v in (xs, ys, zs))


def g2_points_to_device(points, device) -> tuple:
    """Affine G2 ((x0,x1),(y0,y1)) points (or None) -> Jacobian (m, 2, 16) x3
    tensors, Montgomery form."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs += [_R, 0]
            ys += [_R, 0]
            zs += [0, 0]
        else:
            xs += [pt[0][0] * _R % FQ_MOD, pt[0][1] * _R % FQ_MOD]
            ys += [pt[1][0] * _R % FQ_MOD, pt[1][1] * _R % FQ_MOD]
            zs += [_R, 0]
    shape = (len(points), 2, limb.L)
    return tuple(limb.to_device(limb.ints_to_limbs(v).reshape(shape), device)
                 for v in (xs, ys, zs))


def points_to_device(group: str, points, device) -> tuple:
    return (g1_points_to_device if group == "g1" else g2_points_to_device)(points, device)
