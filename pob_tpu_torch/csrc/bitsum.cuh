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
// Design: full warps. A warp owns a run of `run` consecutive live
// positions of one (query, proof) (those of [0, n_bit), then the full
// wires' chains; the padding is never visited, so every run but a query's
// last has the same work) and walks it 32 positions at a time: each
// lane reads one bit, __ballot_sync gathers the warp's mask, and each set
// position takes its slot in a ring of QCAP positions in shared memory by
// the __popc of the mask below its lane. Whenever the ring holds 32, every
// lane pops one and runs jac_madd, so every lane adds a point on every add
// step, as K3's sorted buckets do; what is left is drained at the end of
// the run, by the same call site. The warp's 32 sums are then folded in a 5-level tree (full adds,
// __syncwarp only) and lane 0 writes the run's packed Jacobian partial
// (infinity for a run past the query's live positions). The
// wrapper picks `run` (a multiple of 32) so that the grid is about
// SWEEP_WAVES waves of warps on this card, bitsum.sweep_run. The grid is
// (tile B + proof, query), a tile being WARPS runs, so the B proofs of a
// tile run side by side and a plan point is read from HBM about once, not
// B times. The reduce launch gives one block to each (query, proof): its
// threads sum the runs' partials and a shared-memory tree leaves the sum
// in thread 0. Every buffer and grid is sized from B, M and the card, so
// nothing is read back to the host.
#include "curve.cuh"

using namespace pob;
using T = POB_BITSUM_T;

constexpr int PT = 128;            // threads per block (sweep and reduce)
constexpr int WARPS = PT / 32;     // runs per sweep block
constexpr int QCAP = 64;           // a warp's ring of set positions
constexpr int FULL_BITS = 254;     // doublings per full wire (values < 2^254)
constexpr int PW = Coord<T>::PW;   // packed words per coordinate
constexpr unsigned FULL = 0xffffffffu;
// G1: 3 blocks per SM (at most 168 registers); G2: 2 (at most 255), as K3.
constexpr int MIN_BLOCKS = sizeof(T) == sizeof(Fe) ? 3 : 2;
static_assert(QCAP >= 64 && (QCAP & (QCAP - 1)) == 0,
              "the ring holds < 32 before a chunk's append of at most 32");

// Sum of the warp's 32 points v, left in lane 0. pub: the warp's 32 packed
// Jacobian slots in shared memory; each add takes its second operand from
// there (Packed), so one point per thread is live in registers.
__device__ Jac<T> warp_sum(Jac<T> v, int32_t* pub) {
  const int lane = threadIdx.x & 31;
  for (int o = 16; o >= 1; o >>= 1) {
    if (lane >= o && lane < 2 * o) jac_storep(pub, lane, v);
    __syncwarp();
    if (lane < o) v = jac_add_src(v, Packed<T>{pub + (long long)(lane + o) * 3 * PW});
    __syncwarp();
  }
  return v;
}

__global__ void __launch_bounds__(PT, MIN_BLOCKS)
sweep_kernel(const int32_t* __restrict__ pts, const int* __restrict__ bidx,
             const int* __restrict__ fidx, const int* __restrict__ counts,
             const int32_t* __restrict__ W, int B, int nw, long long M, int mb, int mf,
             int run, int runs, int32_t* __restrict__ part) {
  __shared__ uint4 sm4[PT * 3 * PW / 4];
  __shared__ int rings[WARPS][QCAP];
  const int b = blockIdx.x % B, q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = (blockIdx.x / B) * WARPS + warp;
  if (r >= runs) return;  // the whole warp: no block-wide barrier follows
  const int nb = counts[2 * q], nf = counts[2 * q + 1];
  const int32_t* w = W + (long long)b * nw * 16;
  const int* bi = bidx + (long long)q * mb;
  const int* fi = fidx + (long long)q * mf;
  const int32_t* P = pts + (long long)q * M * 2 * PW;
  // the run covers live offsets [lo, hi) of the query: offset t < n_bit is
  // position t, a later one position mb + t - n_bit (the full wires)
  const int live = nb + FULL_BITS * nf;
  const int lo = min(r * run, live), hi = min(lo + run, live);
  int* ring = rings[warp];
  int head = 0, fill = 0;  // the queued positions: ring[head, head + fill) mod QCAP
  Jac<T> acc = jac_inf<T>();
  // One loop, so that jac_madd has one call site (its code is large: one
  // Fq product is some 300 instructions). Each pass reads the bits of 32
  // live offsets, queues the set positions, and pops 32 (at the end of the
  // run, what is left) for one mixed add per lane.
  for (int c = lo;; c += 32) {
    const int t = c + lane;
    int bit = 0;
    if (t < hi) {
      if (t < nb) {
        bit = w[(long long)bi[t] * 16] & 1;
      } else {  // bit k of full wire j at position mb + 254 j + k
        const int f = t - nb, j = f / FULL_BITS, k = f - j * FULL_BITS;
        bit = (w[(long long)fi[j] * 16 + (k >> 4)] >> (k & 15)) & 1;
      }
    }
    const unsigned mask = __ballot_sync(FULL, bit);
    if (bit)
      ring[(head + fill + __popc(mask & ((1u << lane) - 1))) & (QCAP - 1)] =
          t < nb ? t : mb + t - nb;
    fill += __popc(mask);
    __syncwarp();
    const bool end = c + 32 >= hi;
    if (fill >= 32 || end) {
      const int take = min(fill, 32);
      const int pp = lane < take ? ring[(head + lane) & (QCAP - 1)] : -1;
      __syncwarp();  // every lane has read its entry before the next append
      head = (head + take) & (QCAP - 1);
      fill -= take;
      if (pp >= 0) {
        const int32_t* a = P + (long long)pp * 2 * PW;
        jac_madd(acc, Coord<T>::loadp(a), Coord<T>::loadp(a + PW));
      }
    }
    if (end && fill == 0) break;
  }
  __syncwarp();
  acc = warp_sum(acc, reinterpret_cast<int32_t*>(sm4) + warp * 32 * 3 * PW);
  if (lane == 0) jac_storep(part, ((long long)q * B + b) * runs + r, acc);
}

// Block g = q B + b: the sum of its `runs` packed partials, written to
// out[g] in the 16-bit-limb layout.
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
reduce_kernel(const int32_t* __restrict__ part, int runs, int32_t* oX, int32_t* oY,
              int32_t* oZ) {
  __shared__ uint4 sm4[PT * 3 * PW / 4];
  int32_t* pub = reinterpret_cast<int32_t*>(sm4);
  const int t = threadIdx.x;
  const int32_t* P = part + (long long)blockIdx.x * runs * 3 * PW;
  Jac<T> v = jac_inf<T>();
  for (int i = t; i < runs; i += PT) v = jac_add_src(v, Packed<T>{P + (long long)i * 3 * PW});
  for (int o = PT / 2; o >= 1; o >>= 1) {
    if (t >= o && t < 2 * o) jac_storep(pub, t, v);
    __syncthreads();
    if (t < o) v = jac_add_src(v, Packed<T>{pub + (long long)(t + o) * 3 * PW});
  }
  if (t == 0) jac_store(oX, oY, oZ, blockIdx.x, v);
}

#define POB_CHECK() return (int)cudaGetLastError()

// Warps of the sweep resident on one SM of the current card (its launch
// shape and registers), for bitsum.sweep_run.
extern "C" int pob_bitsum_warps_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sweep_kernel, PT, 0) !=
      cudaSuccess)
    return -1;
  return blocks * WARPS;
}

// part: (q, B, runs) packed Jacobian partials, runs = ceil(M / run).
extern "C" int pob_bitsum_sweep(const void* pts, const void* bidx, const void* fidx,
                                const void* counts, const void* W, int B, int nw, int q,
                                long long M, int mb, int mf, int run, void* part,
                                void* stream) {
  if (run <= 0 || run % 32 || M + run > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int runs = (int)((M + run - 1) / run);
  const dim3 grid((unsigned)((runs + WARPS - 1) / WARPS * B), (unsigned)q);
  sweep_kernel<<<grid, PT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, (const int*)bidx, (const int*)fidx, (const int*)counts,
      (const int32_t*)W, B, nw, M, mb, mf, run, runs, (int32_t*)part);
  POB_CHECK();
}

extern "C" int pob_bitsum_reduce(const void* part, int groups, int runs, void* oX, void* oY,
                                 void* oZ, void* stream) {
  reduce_kernel<<<groups, PT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)part, runs, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  POB_CHECK();
}
