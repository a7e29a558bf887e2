// K4: fixed-base scalar multiplication k_i * G over G1 and G2 for the
// trusted setup's query points.
//
// Replaces pob_tpu/prover/msm.py::windowed_fixed_base_msm (msm.py:248), as
// reached through groth16._fixed_base (groth16.py:178), and the window table
// built by groth16._window_table_kernel / _window_table (groth16.py:131,156).
//
// Bound on this card: integer multiplies. A scalar with n nonzero 8-bit
// digits costs n - 1 mixed adds (11 Fq products on G1, 30 on G2, 264 32-bit
// multiplies each: the first digit only loads its entry) against 64 bytes
// of scalar in and 192 / 384 bytes of point out.
//
// Design.
//  - The table T[w * 256 + v] = v 2^(8w) G holds packed affine points in
//    K3's layout (x then y, 8 32-bit words per Fq, Montgomery form; (0, 0)
//    for v = 0): 512 KB on G1, 1 MB on G2, so the gathers hit L1 / L2.
//    doublings_kernel forms D[j] = 2^j G, j < 256: 255 doublings, the
//    build's only serial chain (no addition chain reaches 2^255 G in
//    fewer steps), run by one warp whose lanes form the Fq products of
//    each doubling side by side (warp_double). table_kernel gives each
//    entry a thread that adds D[8w + b] over the set bits b of v (at most
//    7 adds, as groth16._window_table_kernel does) and divides by Z once.
//  - window_kernel gives each scalar a thread that keeps a Jacobian sum and
//    adds T[w * 256 + d_w] for each nonzero digit d_w, low window first,
//    with a mixed add (jac_madd). Taken in that order the sum is a G with
//    a < 2^(8w) <= d_w 2^(8w) < r (the top digit of a canonical scalar is
//    at most 0x30), so it never equals +-the entry; jac_madd handles
//    those cases all the same. A zero scalar makes no add and stores
//    infinity.
//  - Launch shape (threads per block, blocks per SM for __launch_bounds__)
//    chosen on the card per group: G1 (512, 1), G2 (128, 2).
#include "curve.cuh"

using namespace pob;

constexpr int NWIN = 32;
constexpr int NDIG = 256;         // entries per window: digit values
constexpr int NDBL = 256;         // doublings 2^j G
constexpr int TT = 64;            // table_kernel threads per block
constexpr int G1_PT = 512, G1_MINB = 1;  // window_kernel<Fe>'s launch shape
constexpr int G2_PT = 128, G2_MINB = 2;  // window_kernel<Fq2>'s
static_assert((NWIN * NDIG) % TT == 0, "table_kernel's grid covers the table exactly");

// A packed coordinate through the read-only data cache.
template <class T> __device__ __forceinline__ T ldg_coord(const int32_t* p);
template <> __device__ __forceinline__ Fe ldg_coord<Fe>(const int32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = __ldg(q), b = __ldg(q + 1);
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
template <> __device__ __forceinline__ Fq2 ldg_coord<Fq2>(const int32_t* p) {
  return Fq2{ldg_coord<Fe>(p), ldg_coord<Fe>(p + 8)};
}

// The Fq products of one coordinate product a b (Karatsuba on Fq2, as
// cmul), and the product from their results.
template <class T> struct Parts;
template <> struct Parts<Fe> {
  static constexpr int N = 1;
  __device__ static void operands(const Fe& a, const Fe& b, int, Fe& x, Fe& y) {
    x = a;
    y = b;
  }
  __device__ static Fe join(const Fe* r) { return r[0]; }
};
template <> struct Parts<Fq2> {
  static constexpr int N = 3;
  __device__ static void operands(const Fq2& a, const Fq2& b, int j, Fe& x, Fe& y) {
    x = j == 0 ? a.c0 : j == 1 ? a.c1 : fe_add<FQ>(a.c0, a.c1);
    y = j == 0 ? b.c0 : j == 1 ? b.c1 : fe_add<FQ>(b.c0, b.c1);
  }
  __device__ static Fq2 join(const Fe* r) {
    return Fq2{fe_sub<FQ>(r[0], r[1]), fe_sub<FQ>(r[2], fe_add<FQ>(r[0], r[1]))};
  }
};

// Lane k N + j of the warp takes the operands of the j-th Fq product of
// coordinate product k (a b), so that one fe_mul per lane forms up to 32
// Fq products at once.
template <class T>
__device__ __forceinline__ void pick(const T& a, const T& b, int k, Fe& x, Fe& y) {
  const int j = (int)(threadIdx.x & 31) - k * Parts<T>::N;
  if (j >= 0 && j < Parts<T>::N) Parts<T>::operands(a, b, j, x, y);
}

// sh[lane] = this lane's Fq product; every lane then reads all of them.
__device__ __forceinline__ void warp_mul(const Fe& x, const Fe& y, Fe* sh) {
  sh[threadIdx.x & 31] = fe_mul<FQ>(x, y);
  __syncwarp();
}

// jac_double's formulas with their products formed across the warp, in
// three rounds (X^2, Y^2, 2Y Z; b^2, (X + b)^2, e^2; e (d - X3)): the chain
// of 255 doublings waits for 3 products per doubling instead of 7 (G1) or
// 16 (G2) in one thread. Every lane holds the whole point.
template <class T>
__device__ Jac<T> warp_double(const Jac<T>& p, Fe* sh) {
  constexpr int N = Parts<T>::N;
  Fe x = fe_zero(), y = fe_zero();
  pick(p.x, p.x, 0, x, y);
  pick(p.y, p.y, 1, x, y);
  pick(cadd(p.y, p.y), p.z, 2, x, y);
  warp_mul(x, y, sh);
  const T a = Parts<T>::join(sh), b = Parts<T>::join(sh + N);
  Jac<T> r;
  r.z = Parts<T>::join(sh + 2 * N);
  const T e = cadd(cadd(a, a), a);
  const T xb = cadd(p.x, b);
  __syncwarp();
  pick(b, b, 0, x, y);
  pick(xb, xb, 1, x, y);
  pick(e, e, 2, x, y);
  warp_mul(x, y, sh);
  const T c = Parts<T>::join(sh);
  T d = csub(csub(Parts<T>::join(sh + N), a), c);
  d = cadd(d, d);
  r.x = csub(Parts<T>::join(sh + 2 * N), cadd(d, d));
  __syncwarp();
  pick(e, csub(d, r.x), 0, x, y);
  warp_mul(x, y, sh);
  const T c2 = cadd(c, c), c4 = cadd(c2, c2);
  r.y = csub(Parts<T>::join(sh), cadd(c4, c4));
  __syncwarp();
  return r;
}

// D[j] = 2^j G as packed Jacobian points (3 PW words each); one warp.
template <class T>
__global__ void __launch_bounds__(32)
doublings_kernel(const int32_t* __restrict__ gX, const int32_t* __restrict__ gY,
                 const int32_t* __restrict__ gZ, int32_t* __restrict__ D) {
  __shared__ Fe sh[32];
  Jac<T> p = jac_load<T>(gX, gY, gZ, 0);
  if (threadIdx.x == 0) jac_storep(D, 0, p);
  for (int j = 1; j < NDBL; j++) {
    p = warp_double(p, sh);
    if (threadIdx.x == 0) jac_storep(D, j, p);
  }
}

// Entry e = w * 256 + v of the table from the doublings: one thread each.
template <class T>
__global__ void __launch_bounds__(TT)
table_kernel(const int32_t* __restrict__ D, int32_t* __restrict__ table) {
  constexpr int PW = Coord<T>::PW;
  const int e = blockIdx.x * TT + threadIdx.x;
  const int w = e / NDIG, v = e % NDIG;
  Jac<T> acc = jac_inf<T>();
  for (int b = 0; b < 8; b++)
    if ((v >> b) & 1) acc = jac_add_src(acc, Packed<T>{D + (8 * w + b) * 3 * PW});
  const T zi = cinv(acc.z);  // 0 for v = 0, which gives (0, 0)
  const T zi2 = csqr(zi);
  int32_t* o = table + e * 2 * PW;
  Coord<T>::storep(o, cmul(acc.x, zi2));
  Coord<T>::storep(o + PW, cmul(acc.y, cmul(zi2, zi)));
}

// out[i] = k_i G; scalars: (n, 16) canonical 16-bit limbs.
template <class T, int PT, int MINB>
__global__ void __launch_bounds__(PT, MINB)
window_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ scalars,
              long long n, int32_t* __restrict__ oX, int32_t* __restrict__ oY,
              int32_t* __restrict__ oZ) {
  constexpr int PW = Coord<T>::PW;
  const long long i = (long long)blockIdx.x * PT + threadIdx.x;
  if (i >= n) return;
  const int32_t* s = scalars + i * 16;
  Jac<T> acc = jac_inf<T>();
  for (int w = 0; w < NWIN; w++) {
    const int d = (__ldg(s + (w >> 1)) >> (8 * (w & 1))) & 0xFF;
    if (d) {
      const int32_t* a = table + (w * NDIG + d) * 2 * PW;
      jac_madd(acc, ldg_coord<T>(a), ldg_coord<T>(a + PW));
    }
  }
  jac_store(oX, oY, oZ, i, acc);
}

static inline unsigned blocks_for(long long n, int t) { return (unsigned)((n + t - 1) / t); }

// G: the generator, one Jacobian point in the 16-bit-limb layout; D: 256
// packed Jacobian points of scratch.
extern "C" int pob_fb_doublings(int group, const void* gX, const void* gY, const void* gZ,
                                void* D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 0)
    doublings_kernel<Fe><<<1, 32, 0, s>>>((const int32_t*)gX, (const int32_t*)gY,
                                          (const int32_t*)gZ, (int32_t*)D);
  else
    doublings_kernel<Fq2><<<1, 32, 0, s>>>((const int32_t*)gX, (const int32_t*)gY,
                                           (const int32_t*)gZ, (int32_t*)D);
  return (int)cudaGetLastError();
}

// table: 8192 rows of 2 PW words.
extern "C" int pob_fb_table(int group, const void* D, void* table, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  constexpr unsigned g = NWIN * NDIG / TT;
  if (group == 0)
    table_kernel<Fe><<<g, TT, 0, s>>>((const int32_t*)D, (int32_t*)table);
  else
    table_kernel<Fq2><<<g, TT, 0, s>>>((const int32_t*)D, (int32_t*)table);
  return (int)cudaGetLastError();
}

#define POB_FB_WINDOW_ARGS                                                     \
  (const int32_t*)table, (const int32_t*)scalars, n, (int32_t*)oX, (int32_t*)oY, \
      (int32_t*)oZ

extern "C" int pob_fb_window(int group, const void* table, const void* scalars, long long n,
                             void* oX, void* oY, void* oZ, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 0)
    window_kernel<Fe, G1_PT, G1_MINB><<<blocks_for(n, G1_PT), G1_PT, 0, s>>>(POB_FB_WINDOW_ARGS);
  else
    window_kernel<Fq2, G2_PT, G2_MINB><<<blocks_for(n, G2_PT), G2_PT, 0, s>>>(POB_FB_WINDOW_ARGS);
  return (int)cudaGetLastError();
}
