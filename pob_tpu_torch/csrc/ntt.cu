// K2: the radix-2 Cooley-Tukey Fr NTT, several butterfly stages per pass
// over device memory, for all rows of a (rows, 2^k, 16) batch at once.
//
// Replaces pob_tpu/prover/ntt.py::_transform (the lax.scan over stages,
// ntt.py:61). The coset and 1/n scalings stay in K1, as in the JAX version's
// structure; the bit-reversal gather can be folded into the first pass.
//
// Bound on this card: integer multiplies. A 2^k transform reads and writes
// each element once (2 x 64 bytes in the 16-bit-limb layout) against k / 2
// Montgomery multiplies (264 32-bit multiplies each) per element: at k = 18
// about 1.8 ns of multiplies per 128 bytes (38 ps) on the H100. Running one
// launch per stage, as the first port did, paid k passes over memory
// instead. Design: one block loads a tile of 2^(T+C) elements into shared
// memory (packed, 32 bytes each: 1024 elements in 32 KB), runs T stages on
// it, and writes it back. After the bit reversal, stages s0 .. s0+T-1 only
// pair elements whose indices differ in bits s0 .. s0+T-1, so a tile takes
// 2^T elements 2^s0 apart (the stage's butterfly partners) times 2^C
// adjacent columns (for whole 64-byte runs on the loads). A 2^18 transform
// is two passes (T = 10, then T = 8 with C = 2): two reads and two writes
// of the data. Twiddles come from the master table (_root_powers: w^t R,
// t < 2^(k-1)) in L2, one 64-byte load per butterfly (reading the first
// pass's 512 through shared memory instead measured no faster).
#include "field.cuh"

using namespace pob;

constexpr int TILE_LOG = 10;  // most elements a tile holds: 2^10
constexpr int NT = 256;       // threads per block

__device__ __forceinline__ Fe sm_load(const uint4* sm, int e) {
  const uint4 a = sm[2 * e], b = sm[2 * e + 1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void sm_store(uint4* sm, int e, const Fe& a) {
  sm[2 * e] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  sm[2 * e + 1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// Stages s0 .. s0+T-1 on tiles of 2^T x 2^C elements. Tile element (j, c)
// is row element base + j 2^s0 + c; with gather, it is read from the natural
// order input x at the bit reversal of that index (the first pass only).
__global__ void __launch_bounds__(NT) ntt_pass_kernel(const int32_t* __restrict__ x,
                                                      int32_t* __restrict__ y,
                                                      const int32_t* __restrict__ roots,
                                                      int k, int s0, int T, int C,
                                                      int gather) {
  __shared__ uint4 sm[2 << TILE_LOG];
  const int n_tile = 1 << (T + C), cmask = (1 << C) - 1;
  const long long n = 1LL << k;
  const int tiles = 1 << (k - T - C);
  const long long row = blockIdx.x / tiles;
  const int t = blockIdx.x - (int)(row * tiles);
  const long long lo = (long long)(t & ((1 << (s0 - C)) - 1)) << C;
  const long long base = ((long long)(t >> (s0 - C)) << (s0 + T)) + lo;
  const int32_t* xr = x + row * n * 16;
  int32_t* yr = y + row * n * 16;
  for (int e = threadIdx.x; e < n_tile; e += NT) {
    long long g = base + ((long long)(e >> C) << s0) + (e & cmask);
    if (gather) g = (long long)(__brevll((unsigned long long)g) >> (64 - k));
    sm_store(sm, e, load16(xr + g * 16));
  }
  __syncthreads();
  for (int st = 0; st < T; st++) {
    const int s = s0 + st;
    for (int q = threadIdx.x; q < n_tile / 2; q += NT) {
      const int c = q & cmask, jj = q >> C;
      const int jm = jj & ((1 << st) - 1);
      const int u = ((((jj >> st) << (st + 1)) + jm) << C) + c;
      const int v = u + (1 << (st + C));
      const long long tw = (((long long)jm << s0) + lo + c) << (k - 1 - s);
      const Fe a = sm_load(sm, u);
      const Fe b = fe_mul<FR>(sm_load(sm, v), load16(roots + tw * 16));
      sm_store(sm, u, fe_add<FR>(a, b));
      sm_store(sm, v, fe_sub<FR>(a, b));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n_tile; e += NT)
    store16(yr + (base + ((long long)(e >> C) << s0) + (e & cmask)) * 16, sm_load(sm, e));
}

// One pass over every row: x -> y (x may be y unless gather is set).
extern "C" int pob_ntt_pass(const void* x, void* y, const void* roots, long long rows, int k,
                            int s0, int T, int C, int gather, void* stream) {
  if (k <= 0 || rows <= 0) return 0;
  if (T < 1 || C < 0 || C > s0 || T + C > TILE_LOG || s0 + T > k)
    return (int)cudaErrorInvalidValue;
  const long long blocks = rows << (k - T - C);
  ntt_pass_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)y, (const int32_t*)roots, k, s0, T, C, gather);
  return (int)cudaGetLastError();
}
