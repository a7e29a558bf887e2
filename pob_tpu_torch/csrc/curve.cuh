// BN254 G1 (over Fq) and G2 (over Fq2 = Fq[u]/(u^2+1)) Jacobian arithmetic
// on the device, generic over the coordinate type. The formulas are those of
// pob_tpu/prover/curve.py (point_double, point_add), written with branches:
// divergence on the rare infinity / doubling / cancel cases costs less on a
// GPU than computing both sides as the TPU's selects do.
//
// Layout in device memory: a G1 coordinate is 16 int32 (16-bit limbs), a G2
// coordinate 2 x 16; infinity is Z == 0, written as (one, one, 0).
#pragma once

#include "field.cuh"

namespace pob {

struct Fq2 {
  Fe c0, c1;
};

// ---- coordinate field operations, overloaded on Fe (Fq) and Fq2 ----

__device__ __forceinline__ Fe cmul(const Fe& a, const Fe& b) { return fe_mul<FQ>(a, b); }
__device__ __forceinline__ Fe csqr(const Fe& a) { return fe_mul<FQ>(a, a); }
__device__ __forceinline__ Fe cadd(const Fe& a, const Fe& b) { return fe_add<FQ>(a, b); }
__device__ __forceinline__ Fe csub(const Fe& a, const Fe& b) { return fe_sub<FQ>(a, b); }
__device__ __forceinline__ bool cis_zero(const Fe& a) { return fe_is_zero(a); }

__device__ __forceinline__ Fq2 cmul(const Fq2& a, const Fq2& b) {
  // Karatsuba, u^2 = -1; t0 + t1 is formed before the third product so
  // that t0 and t1 die early
  const Fe t0 = fe_mul<FQ>(a.c0, b.c0);
  const Fe t1 = fe_mul<FQ>(a.c1, b.c1);
  Fq2 r;
  r.c0 = fe_sub<FQ>(t0, t1);
  const Fe s = fe_add<FQ>(t0, t1);
  r.c1 = fe_sub<FQ>(fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_add<FQ>(b.c0, b.c1)), s);
  return r;
}
__device__ __forceinline__ Fq2 csqr(const Fq2& a) {
  Fq2 r;
  r.c0 = fe_mul<FQ>(fe_add<FQ>(a.c0, a.c1), fe_sub<FQ>(a.c0, a.c1));
  Fe t = fe_mul<FQ>(a.c0, a.c1);
  r.c1 = fe_add<FQ>(t, t);
  return r;
}
__device__ __forceinline__ Fq2 cadd(const Fq2& a, const Fq2& b) {
  return Fq2{fe_add<FQ>(a.c0, b.c0), fe_add<FQ>(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 csub(const Fq2& a, const Fq2& b) {
  return Fq2{fe_sub<FQ>(a.c0, b.c0), fe_sub<FQ>(a.c1, b.c1)};
}
__device__ __forceinline__ bool cis_zero(const Fq2& a) {
  return fe_is_zero(a.c0) && fe_is_zero(a.c1);
}

__device__ __forceinline__ Fe cinv(const Fe& a) { return fe_inv<FQ>(a); }
// (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0.
__device__ __forceinline__ Fq2 cinv(const Fq2& a) {
  const Fe n = fe_inv<FQ>(fe_add<FQ>(fe_mul<FQ>(a.c0, a.c0), fe_mul<FQ>(a.c1, a.c1)));
  return Fq2{fe_mul<FQ>(a.c0, n), fe_neg<FQ>(fe_mul<FQ>(a.c1, n))};
}

// ---- loads / stores in the 16-bit-limb layout ----

template <class T> struct Coord;
// WORDS: int32 words of a coordinate in the 16-bit-limb layout; PW: in the
// packed layout (loadp / storep).
template <> struct Coord<Fe> {
  static constexpr int WORDS = 16;
  static constexpr int PW = 8;
  __device__ static Fe load(const int32_t* p) { return load16(p); }
  __device__ static void store(int32_t* p, const Fe& a) { store16(p, a); }
  __device__ static Fe loadp(const int32_t* p) { return load8(p); }
  __device__ static void storep(int32_t* p, const Fe& a) { store8(p, a); }
  __device__ static Fe one() { return fe_one_q(); }
  __device__ static Fe zero() { return fe_zero(); }
};
template <> struct Coord<Fq2> {
  static constexpr int WORDS = 32;
  static constexpr int PW = 16;
  __device__ static Fq2 load(const int32_t* p) { return Fq2{load16(p), load16(p + 16)}; }
  __device__ static void store(int32_t* p, const Fq2& a) {
    store16(p, a.c0);
    store16(p + 16, a.c1);
  }
  __device__ static Fq2 loadp(const int32_t* p) { return Fq2{load8(p), load8(p + 8)}; }
  __device__ static void storep(int32_t* p, const Fq2& a) {
    store8(p, a.c0);
    store8(p + 8, a.c1);
  }
  __device__ static Fq2 one() { return Fq2{fe_one_q(), fe_zero()}; }
  __device__ static Fq2 zero() { return Fq2{fe_zero(), fe_zero()}; }
};

template <class T>
struct Jac {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ Jac<T> jac_inf() {
  return Jac<T>{Coord<T>::one(), Coord<T>::one(), Coord<T>::zero()};
}

template <class T>
__device__ __forceinline__ bool jac_is_inf(const Jac<T>& p) {
  return cis_zero(p.z);
}

template <class T>
__device__ __forceinline__ Jac<T> jac_load(const int32_t* X, const int32_t* Y,
                                           const int32_t* Z, long long i) {
  const long long o = i * Coord<T>::WORDS;
  return Jac<T>{Coord<T>::load(X + o), Coord<T>::load(Y + o), Coord<T>::load(Z + o)};
}

template <class T>
__device__ __forceinline__ void jac_store(int32_t* X, int32_t* Y, int32_t* Z,
                                          long long i, const Jac<T>& p) {
  const long long o = i * Coord<T>::WORDS;
  Coord<T>::store(X + o, p.x);
  Coord<T>::store(Y + o, p.y);
  Coord<T>::store(Z + o, p.z);
}

// Packed Jacobian points: X, Y, Z of point i at P + 3 PW i.
template <class T>
__device__ __forceinline__ Jac<T> jac_loadp(const int32_t* P, long long i) {
  const int32_t* p = P + i * 3 * Coord<T>::PW;
  return Jac<T>{Coord<T>::loadp(p), Coord<T>::loadp(p + Coord<T>::PW),
                Coord<T>::loadp(p + 2 * Coord<T>::PW)};
}

template <class T>
__device__ __forceinline__ void jac_storep(int32_t* P, long long i, const Jac<T>& a) {
  int32_t* p = P + i * 3 * Coord<T>::PW;
  Coord<T>::storep(p, a.x);
  Coord<T>::storep(p + Coord<T>::PW, a.y);
  Coord<T>::storep(p + 2 * Coord<T>::PW, a.z);
}

// Doubling on a = 0 curves; infinity stays infinity (Z3 = 2 Y Z = 0).
template <class T>
__device__ Jac<T> jac_double(const Jac<T>& p) {
  T a = csqr(p.x);
  T b = csqr(p.y);
  T c = csqr(b);
  T t = csqr(cadd(p.x, b));
  T d = csub(csub(t, a), c);
  d = cadd(d, d);
  T e = cadd(cadd(a, a), a);
  T f = csqr(e);
  Jac<T> r;
  r.x = csub(f, cadd(d, d));
  T c2 = cadd(c, c);
  T c4 = cadd(c2, c2);
  T c8 = cadd(c4, c4);
  r.y = csub(cmul(e, csub(d, r.x)), c8);
  r.z = cmul(cadd(p.y, p.y), p.z);
  return r;
}

// The second operand of jac_add_src: a point in registers, or a packed
// point in memory whose coordinates are loaded where each is first used
// (for G2 that keeps a whole operand, 48 registers, out of the register file
// while the other one is live).
template <class T>
struct InRegs {
  const Jac<T>& q;
  __device__ T x() const { return q.x; }
  __device__ T y() const { return q.y; }
  __device__ T z() const { return q.z; }
};

// (The empty asm with a memory clobber keeps each load where it is written
// and keeps q.z() from being held across the add: hoisted or shared, the
// loads would hold the whole operand in registers again.)
template <class T>
struct Packed {
  const int32_t* q;
  __device__ T x() const {
    asm volatile("" ::: "memory");
    return Coord<T>::loadp(q);
  }
  __device__ T y() const {
    asm volatile("" ::: "memory");
    return Coord<T>::loadp(q + Coord<T>::PW);
  }
  __device__ T z() const {
    asm volatile("" ::: "memory");
    return Coord<T>::loadp(q + 2 * Coord<T>::PW);
  }
};

// Complete addition: infinity operands, P == Q (doubling) and P == -Q
// (cancel, giving infinity) are handled as pob_tpu's curve.py:217-232 does.
// The order lets each coordinate of P die at its last use.
template <class T, class Q>
__device__ Jac<T> jac_add_src(const Jac<T>& p, const Q& q) {
  if (cis_zero(q.z())) return p;
  if (jac_is_inf(p)) return Jac<T>{q.x(), q.y(), q.z()};
  T z2z2 = csqr(q.z());
  T u1 = cmul(p.x, z2z2);
  T s1 = cmul(cmul(p.y, q.z()), z2z2);
  T z1z1 = csqr(p.z);
  T h = csub(cmul(q.x(), z1z1), u1);
  T r = csub(cmul(cmul(q.y(), p.z), z1z1), s1);
  T zz = cmul(p.z, q.z());
  if (cis_zero(h)) {
    if (cis_zero(r)) return jac_double(Jac<T>{q.x(), q.y(), q.z()});
    return jac_inf<T>();
  }
  T hh = csqr(h);
  T hhh = cmul(h, hh);
  T v = cmul(u1, hh);
  Jac<T> o;
  o.x = csub(csub(csqr(r), hhh), cadd(v, v));
  o.y = csub(cmul(r, csub(v, o.x)), cmul(s1, hhh));
  o.z = cmul(zz, h);
  return o;
}

template <class T>
__device__ __forceinline__ Jac<T> jac_add(const Jac<T>& p, const Jac<T>& q) {
  return jac_add_src(p, InRegs<T>{q});
}

// Mixed addition P += (x, y), (x, y) affine: 11 coordinate multiplies
// against jac_add's 16 (Z2 = 1). The affine point at infinity is (0, 0),
// which no curve point is (b != 0).
template <class T>
__device__ __forceinline__ void jac_madd(Jac<T>& p, const T& x, const T& y) {
  if (cis_zero(x) && cis_zero(y)) return;
  if (jac_is_inf(p)) {
    p = Jac<T>{x, y, Coord<T>::one()};
    return;
  }
  T z1z1 = csqr(p.z);
  T h = csub(cmul(x, z1z1), p.x);
  T r = csub(cmul(y, cmul(p.z, z1z1)), p.y);
  if (cis_zero(h)) {
    p = cis_zero(r) ? jac_double(p) : jac_inf<T>();
    return;
  }
  T hh = csqr(h);
  T hhh = cmul(h, hh);
  T v = cmul(p.x, hh);
  T x3 = csub(csub(csqr(r), hhh), cadd(v, v));
  p.y = csub(cmul(r, csub(v, x3)), cmul(p.y, hhh));
  p.z = cmul(p.z, h);
  p.x = x3;
}

}  // namespace pob
