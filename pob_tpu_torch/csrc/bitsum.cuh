// K5: the conditional-add sweep of the planned witness MSMs, batched over
// proofs and queries: out[q, b] = sum over the positions p of query q's plan
// block whose bit is set in proof b of the plan point at p. bitsum_g1.cu and
// bitsum_g2.cu compile it for one group each (POB_BITSUM_T = Fe for G1 over
// Fq, Fq2 for G2), each its own nvcc, so neither grows msm_g2.cu's build.
//
// Replaces pob_tpu/prover/groth16.py::bitsum_msm and _planned_group_kernel
// (groth16.py:801,825): the same sums, from the same plan layout.
//
// The plan (groth16.attach_msm_plan) keeps, per query, a block of M packed
// affine points (x then y, Montgomery, (0, 0) for infinity):
// [bit points | (0, 0) up to mb | 254 doublings 2^k P_j of each full wire j,
// wire-major | (0, 0) up to M], with bit_idx (q, mb) and full_idx (q, mf)
// the absolute wire of each bit point and of each full wire, and counts
// (q, 2) the true (n_bit, n_full) of each query. The bit of position p
// comes straight from the witness W (B, nw, 16 limbs of 16 bits):
//   p < n_bit:                 W[b, bit_idx[q, p], 0] & 1
//   p = mb + 254 j + k, j < n_full: bit k of W[b, full_idx[q, j]]
//   anything else:             0 (padding is never read).
//
// Bound on this card: integer multiplies, one mixed add (11 Fq products on
// G1, 30 on G2) per set bit, against a 64-byte (G1) or 128-byte (G2) read of
// the point; a clear bit costs one witness read and no point read.
//
// Design (a plain first kernel, not tuned): the sweep's grid is (tile,
// proof, query); a tile is PT x PER positions, thread t taking positions
// t, t + PT, ... so that neighbouring threads read neighbouring points. Each
// thread adds its set positions into a Jacobian sum with jac_madd (which
// handles (0, 0), doubling and cancel), then the block sums its threads'
// sums in a shared-memory tree with full adds and writes one packed
// Jacobian partial per tile. The reduce launch gives one block to each
// (query, proof): its threads sum the tiles' partials, and the same tree
// leaves the sum in thread 0. Every buffer and grid is sized from B and M,
// so nothing is read back to the host.
#include "curve.cuh"

using namespace pob;
using T = POB_BITSUM_T;

constexpr int PT = 128;            // threads per block (sweep and reduce)
constexpr int PER = 32;            // positions per thread in one tile
constexpr int TILE = PT * PER;     // positions per sweep block
constexpr int FULL_BITS = 254;     // doublings per full wire (values < 2^254)
constexpr int PW = Coord<T>::PW;   // packed words per coordinate
// G1: 3 blocks per SM (at most 168 registers); G2: 2 (at most 255), as K3.
constexpr int MIN_BLOCKS = sizeof(T) == sizeof(Fe) ? 3 : 2;

// The bit of plan position p for the proof whose witness row starts at w.
__device__ __forceinline__ int plan_bit(const int32_t* __restrict__ w,
                                        const int* __restrict__ bidx,
                                        const int* __restrict__ fidx, int mb, int nb,
                                        int nf, long long p) {
  if (p < mb) return p < nb ? (w[(long long)bidx[p] * 16] & 1) : 0;
  const long long f = p - mb;
  const long long j = f / FULL_BITS;
  if (j >= nf) return 0;
  const int k = (int)(f - j * FULL_BITS);
  return (w[(long long)fidx[j] * 16 + (k >> 4)] >> (k & 15)) & 1;
}

// Sum of the PT threads' points v over the block, left in thread 0. pub:
// PT packed Jacobian slots in shared memory; each add takes its second
// operand from there (Packed), so one point per thread is live in registers.
__device__ Jac<T> block_sum(Jac<T> v, int32_t* pub) {
  const int t = threadIdx.x;
  for (int o = PT / 2; o >= 1; o >>= 1) {
    if (t >= o && t < 2 * o) jac_storep(pub, t, v);
    __syncthreads();
    if (t < o) v = jac_add_src(v, Packed<T>{pub + (long long)(t + o) * 3 * PW});
  }
  return v;
}

__global__ void __launch_bounds__(PT, MIN_BLOCKS)
sweep_kernel(const int32_t* __restrict__ pts, const int* __restrict__ bidx,
             const int* __restrict__ fidx, const int* __restrict__ counts,
             const int32_t* __restrict__ W, int nw, long long M, int mb, int mf,
             int32_t* __restrict__ part) {
  __shared__ uint4 sm4[PT * 3 * PW / 4];
  const int tile = blockIdx.x, b = blockIdx.y, q = blockIdx.z;
  const int nb = counts[2 * q], nf = counts[2 * q + 1];
  const int32_t* w = W + (long long)b * nw * 16;
  const int* bi = bidx + (long long)q * mb;
  const int* fi = fidx + (long long)q * mf;
  const int32_t* P = pts + (long long)q * M * 2 * PW;
  Jac<T> acc = jac_inf<T>();
  const long long p0 = (long long)tile * TILE + threadIdx.x;
  for (int k = 0; k < PER; k++) {
    const long long p = p0 + (long long)k * PT;
    if (p >= M) break;
    if (plan_bit(w, bi, fi, mb, nb, nf, p)) {
      const int32_t* a = P + p * 2 * PW;
      jac_madd(acc, Coord<T>::loadp(a), Coord<T>::loadp(a + PW));
    }
  }
  acc = block_sum(acc, reinterpret_cast<int32_t*>(sm4));
  if (threadIdx.x == 0)
    jac_storep(part, ((long long)q * gridDim.y + b) * gridDim.x + tile, acc);
}

// Block g = q B + b: the sum of its `tiles` packed partials, written to
// out[g] in the 16-bit-limb layout.
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
reduce_kernel(const int32_t* __restrict__ part, int tiles, int32_t* oX, int32_t* oY,
              int32_t* oZ) {
  __shared__ uint4 sm4[PT * 3 * PW / 4];
  const int32_t* P = part + (long long)blockIdx.x * tiles * 3 * PW;
  Jac<T> v = jac_inf<T>();
  for (int t = threadIdx.x; t < tiles; t += PT)
    v = jac_add_src(v, Packed<T>{P + (long long)t * 3 * PW});
  v = block_sum(v, reinterpret_cast<int32_t*>(sm4));
  if (threadIdx.x == 0) jac_store(oX, oY, oZ, blockIdx.x, v);
}

#define POB_CHECK() return (int)cudaGetLastError()

extern "C" int pob_bitsum_tile() { return TILE; }

// part: (q, B, tiles) packed Jacobian partials, tiles = ceil(M / TILE).
extern "C" int pob_bitsum_sweep(const void* pts, const void* bidx, const void* fidx,
                                const void* counts, const void* W, int B, int nw, int q,
                                long long M, int mb, int mf, void* part, void* stream) {
  const dim3 grid((unsigned)((M + TILE - 1) / TILE), (unsigned)B, (unsigned)q);
  sweep_kernel<<<grid, PT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const int*)bidx, (const int*)fidx, (const int*)counts,
      (const int32_t*)W, nw, M, mb, mf, (int32_t*)part);
  POB_CHECK();
}

extern "C" int pob_bitsum_reduce(const void* part, int groups, int tiles, void* oX, void* oY,
                                 void* oZ, void* stream) {
  reduce_kernel<<<groups, PT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)part, tiles, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  POB_CHECK();
}
