// BN254 Fr / Fq arithmetic on Hopper: 8 x 32-bit limbs, Montgomery form
// (R = 2^256), every result canonical in [0, p).
//
// The port's tensors keep the JAX package's layout: a field element is 16
// int32 words, each holding one 16-bit limb, little-endian. A kernel loads
// an element as four 16-byte vectors, packs pairs of 16-bit limbs into
// 32-bit words in registers, computes on 8 words, and unpacks on store.
//
// Multiplication is CIOS (coarsely integrated operand scanning) with the
// per-word constant n0' = -p^{-1} mod 2^32; carries ride in 64-bit
// accumulators, which the compiler lowers to IMAD.WIDE / add-with-carry
// chains. The JAX package computes the same function with a full-word REDC
// (m = (c mod R) * (-p^{-1} mod R)); both return the canonical value, so
// outputs agree bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pob {

constexpr int FR = 0;
constexpr int FQ = 1;

struct Fe {
  uint32_t v[8];
};

// moduli, 32-bit words little-endian
__constant__ uint32_t c_mod[2][8] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
     0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
// -p^{-1} mod 2^32
__constant__ uint32_t c_n0[2] = {0xefffffffu, 0xe4866389u};
// R mod q: the Montgomery form of 1 in Fq (curve points at infinity use it)
__constant__ uint32_t c_one_q[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                                    0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                                    0x9a07df2fu, 0x0e0a77c1u};

__device__ __forceinline__ Fe load16(const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int4 w = q[k];
    r.v[2 * k] = (uint32_t)w.x | ((uint32_t)w.y << 16);
    r.v[2 * k + 1] = (uint32_t)w.z | ((uint32_t)w.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store16(int32_t* p, const Fe& a) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int4 w;
    w.x = (int32_t)(a.v[2 * k] & 0xFFFFu);
    w.y = (int32_t)(a.v[2 * k] >> 16);
    w.z = (int32_t)(a.v[2 * k + 1] & 0xFFFFu);
    w.w = (int32_t)(a.v[2 * k + 1] >> 16);
    q[k] = w;
  }
}

// The packed layout of K3's own buffers: 8 int32 words of 32 bits per
// element (half the bytes of the 16-bit-limb layout).
__device__ __forceinline__ Fe load8(const int32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(int32_t* p, const Fe& a) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one_q() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c_one_q[i];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) x |= a.v[i];
  return x == 0;
}

// t (8 words) plus a carry word `hi`, value < 2p: subtract p once if needed.
template <int F>
__device__ __forceinline__ Fe fe_csub(const uint32_t* t, uint32_t hi) {
  Fe d;
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)t[i] - (uint64_t)c_mod[F][i] - br;
    d.v[i] = (uint32_t)x;
    br = (x >> 63) & 1u;
  }
  bool take = hi != 0 || br == 0;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = take ? d.v[i] : t[i];
  return r;
}

template <int F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_csub<F>(s, (uint32_t)c);
}

template <int F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t x = (uint64_t)a.v[i] - (uint64_t)b.v[i] - br;
    d.v[i] = (uint32_t)x;
    br = (x >> 63) & 1u;
  }
  if (br) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      c += (uint64_t)d.v[i] + c_mod[F][i];
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

template <int F>
__device__ __forceinline__ Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

// a * b * 2^-256 mod p (CIOS).
template <int F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * c_n0[F];
    c = ((uint64_t)t[0] + (uint64_t)m * c_mod[F][0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * c_mod[F][j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return fe_csub<F>(t, t[8]);
}

template <int F>
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

// a^(p-2) = a^-1 (Montgomery form in and out) by square-and-multiply over
// the bits of p - 2; 0 maps to 0.
template <int F>
__device__ Fe fe_inv(const Fe& a) {
  Fe r = a;  // the top bit of p - 2 (bit 253 for Fr and Fq)
  for (int bit = 252; bit >= 0; bit--) {
    r = fe_mul<F>(r, r);
    const uint32_t e = c_mod[F][bit >> 5] - (bit < 32 ? 2u : 0u);
    if ((e >> (bit & 31)) & 1) r = fe_mul<F>(r, a);
  }
  return r;
}

// Montgomery reduction of a 512-bit value c (16 words, c < p * 2^256):
// c * 2^-256 mod p, canonical.
template <int F>
__device__ __forceinline__ Fe fe_redc(const uint32_t* c) {
  uint32_t t[17];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = c[i];
  t[16] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t m = t[i] * c_n0[F];
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      carry += (uint64_t)t[i + j] + (uint64_t)m * c_mod[F][j];
      t[i + j] = (uint32_t)carry;
      carry >>= 32;
    }
#pragma unroll
    for (int k = i + 8; k < 17; k++) {
      carry += t[k];
      t[k] = (uint32_t)carry;
      carry >>= 32;
    }
  }
  return fe_csub<F>(t + 8, t[16]);
}

}  // namespace pob
