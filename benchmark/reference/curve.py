"""BN254's G1 and G2 in plain Python, for the benchmark's reference: scalar
multiples of the generators, as affine tuples in the layout the program's
proofs use (G1 (x, y); G2 ((x0, x1), (y0, y1)) with Fq2 = Fq[u] / (u^2 + 1);
None for the point at infinity).

Double-and-add in Jacobian coordinates (one inversion per multiple), over a
small field class for Fq and Fq2 alike."""

from __future__ import annotations

Q_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


class Fq:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v % Q_MOD

    def __add__(self, o):
        return Fq(self.v + o.v)

    def __sub__(self, o):
        return Fq(self.v - o.v)

    def __mul__(self, o):
        return Fq(self.v * o.v)

    def small(self, k: int):
        return Fq(self.v * k)

    def inv(self):
        return Fq(pow(self.v, -1, Q_MOD))

    def is_zero(self) -> bool:
        return self.v == 0

    def out(self):
        return self.v


class Fq2:
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a % Q_MOD, b % Q_MOD

    def __add__(self, o):
        return Fq2(self.a + o.a, self.b + o.b)

    def __sub__(self, o):
        return Fq2(self.a - o.a, self.b - o.b)

    def __mul__(self, o):
        return Fq2(self.a * o.a - self.b * o.b, self.a * o.b + self.b * o.a)

    def small(self, k: int):
        return Fq2(self.a * k, self.b * k)

    def inv(self):
        d = pow(self.a * self.a + self.b * self.b, -1, Q_MOD)
        return Fq2(self.a * d, -self.b * d)

    def is_zero(self) -> bool:
        return self.a == 0 and self.b == 0

    def out(self):
        return (self.a, self.b)


G1 = (Fq(1), Fq(2))
G2 = (Fq2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
          11559732032986387107991004021392285783925812861821192530917403151452391805634),
      Fq2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
          4082367875863433681332203403145435568316851327593401208105741076214120093531))


def _double(p):
    x, y, z = p
    if y.is_zero():
        return None
    a = x * x
    b = y * y
    c = b * b
    d = ((x + b) * (x + b) - a - c).small(2)
    e = a.small(3)
    x3 = e * e - d.small(2)
    return (x3, e * (d - x3) - c.small(8), (y * z).small(2))


def _add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1, z2 * z2
    u1, u2 = x1 * z2z2, x2 * z1z1
    s1, s2 = y1 * z2 * z2z2, y2 * z1 * z1z1
    h, r = u2 - u1, s2 - s1
    if h.is_zero():
        return _double(p) if r.is_zero() else None
    hh = h * h
    hhh = h * hh
    v = u1 * hh
    x3 = r * r - hhh - v.small(2)
    return (x3, r * (v - x3) - s1 * hhh, z1 * z2 * h)


def mul(base, k: int):
    """k * base (base affine, of G1 or G2) -> affine output tuple or None."""
    k %= R_MOD
    one = base[0].small(0)
    one = type(one)(1) if isinstance(one, Fq) else Fq2(1, 0)
    acc, run = None, (base[0], base[1], one)
    while k:
        if k & 1:
            acc = _add(acc, run)
        run = _double(run)
        k >>= 1
    if acc is None:
        return None
    x, y, z = acc
    zi = z.inv()
    zi2 = zi * zi
    return ((x * zi2).out(), (y * zi2 * zi).out())


def g1(k: int):
    return mul(G1, k)


def g2(k: int):
    return mul(G2, k)
