// K3: variable-base multi-scalar multiplication, batched over proofs:
// out[b] = sum_i s[b, i] * P[i], with 8-bit digits. This header holds the
// kernels, and K6 (shifted_bases_kernel, at the end: the doubling chains
// that K3's bases and the witness-MSM plan are made of); msm_g1.cu and
// msm_g2.cu compile it for one group each (POB_MSM_T = Fe for G1 over Fq,
// Fq2 for G2), so the two build in parallel.
//
// Replaces pob_tpu/prover/msm.py::pippenger_msm with _combine_buckets
// (msm.py:92,199) and the TPU-only one-hot form pippenger_msm_dense
// (msm.py:142), which give the same sum.
//
// Bound on this card: integer multiplies. Each nonzero digit costs one
// mixed add (11 Fq multiplies on G1, 30 on G2, each 264 32-bit multiplies)
// against a 64-byte (G1) or 128-byte (G2) gather of an affine point.
//
// Design. The key keeps, per query, the shifted bases 2^(8w) P_i for all 32
// windows w as packed affine points (shifted_bases_kernel, once per key):
// then s P = sum_w d_w (2^(8w) P) needs no doublings per call, and every
// digit of a proof, whatever its window, goes to one of 255 buckets (digit
// value d) of that proof. The per-window sums and the Horner fold of the
// first port (248 dependent doublings per proof, 35-45% of a witness MSM)
// are gone. A key too large for 32 windows per point (the production
// ProofOfBurn's h query at 2^24) keeps S of them, S dividing 32: window w
// of point i then adds base (w mod S) m + i into the 255 buckets of pass
// w div S, so a proof has 32 / S passes (the keys below are (proof, pass)
// pairs), and a sixth step folds the passes' weighted sums Horner-style,
// with 8 S doublings between them: one key space for every pass keeps the
// launches of S = 32 and adds one, where a launch per pass would repeat
// all of them. Every size is fixed from B, m and S before the first
// launch, so the host reads nothing back between launches:
//  1. hist: one block per (proof, pass, 256 (32 / S) scalars), 32 digits
//     a thread, counts its digits per bucket in shared memory with
//     warp-aggregated increments (__match_any_sync: one shared atomic per
//     distinct digit in a warp, so the bit witnesses' hot bucket, digit 1,
//     costs one atomic per warp), keeps the histogram and adds it to the
//     key's counts: one global atomic per block and bucket.
//  2. layout: one block scans the counts into the bucket starts and, for
//     every reduction level l, the segment starts (a bucket of c entries
//     has ceil(c / D_l) segments at level l).
//  3. scatter: each block claims its run in every bucket with one global
//     atomic, sorts its digits by bucket in shared memory, and writes each
//     run contiguously (table index (w mod S) m + i).
//  4. bucket sum, one launch per level: a thread sums a segment of at most
//     SEG entries of one bucket (level 0: mixed adds from the table; later
//     levels: full adds of the level before's partials), so the longest
//     bucket is cut across threads. The number of levels is fixed by m.
//  5. reduce: one block of 32 threads per proof; thread c forms, by the
//     running sum over its 8 buckets d = 8c + j, L_c = sum_j j B_d and the
//     total T_c; suffix sums U_c = sum_{c' >= c} T_c' across the threads
//     give sum_d d B_d = sum_c L_c + 8 sum_{c >= 1} U_c, summed as a tree.
//     Per (proof, pass) when S < 32.
//  6. fold (S < 32 only): one thread per proof, sum_p 2^(8 S p) V_p.
#include "curve.cuh"

using namespace pob;
using T = POB_MSM_T;

constexpr int NWIN = 32;
constexpr int NBKT = 256;          // buckets per proof: digit values (0 unused)
constexpr int HT = 256;            // hist / scatter threads, one scalar each
constexpr int LT = 1024;           // layout threads (one block)
constexpr int MAX_LEVELS = 9;       // bucket-sum levels: level_segs(32 m) for m <= 2^24
constexpr int CW = 8;              // buckets per reduce thread
constexpr int NCH = NBKT / CW;     // reduce threads per proof
constexpr int PW = Coord<T>::PW;   // packed words per coordinate
constexpr unsigned FULL = 0xffffffffu;
static_assert(HT == NBKT, "hist and scatter give one thread to each bucket");

// 8 32-bit words of scalar (b, i) from its 16-bit limbs; zero past the end.
__device__ __forceinline__ void load_scalar(const int32_t* s, int m, int b, int i,
                                            uint32_t* w) {
  if (i >= m) {
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = 0;
    return;
  }
  const Fe e = load16(s + ((long long)b * m + i) * 16);
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = e.v[k];
}

__device__ __forceinline__ int digit(const uint32_t* w, int win) {
  return (w[win >> 2] >> (8 * (win & 3))) & 0xFF;
}

// The digits of a block of hist and scatter: block (b np + p) chunks + c
// takes pass p (windows p S .. p S + S - 1, np = 32 / S passes) of proof b
// over the np HT scalars of chunk c, thread t the scalars (c np + r) HT + t
// for r < np: np S = 32 digits per thread at any S. Its buckets are those
// of key b np + p; at S = 32 (one pass) this is one proof's 256 scalars.
struct BlockDigits {
  int key, b, p, c;
  __device__ BlockDigits(int chunks, int np) {
    key = blockIdx.x / chunks;
    b = key / np;
    p = key - b * np;
    c = blockIdx.x - key * chunks;
  }
};

__global__ void __launch_bounds__(HT) hist_kernel(const int32_t* __restrict__ s, int m,
                                                  int chunks, int S,
                                                  int* __restrict__ blockhist,
                                                  int* __restrict__ counts) {
  __shared__ int hist[NBKT];
  const int np = NWIN / S, lane = threadIdx.x & 31;
  const BlockDigits bd(chunks, np);
  hist[threadIdx.x] = 0;
  __syncthreads();
  for (int r = 0; r < np; r++) {
    uint32_t w[8];
    load_scalar(s, m, bd.b, (bd.c * np + r) * HT + threadIdx.x, w);
    for (int win = bd.p * S; win < bd.p * S + S; win++) {
      const int d = digit(w, win);
      const unsigned peers = __match_any_sync(FULL, d);
      if (d && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
  }
  __syncthreads();
  const int v = hist[threadIdx.x];
  blockhist[(long long)blockIdx.x * NBKT + threadIdx.x] = v;
  if (v) atomicAdd(&counts[bd.key * NBKT + threadIdx.x], v);
}

// Exclusive prefix sum of one int per thread over the block (at most 32
// warps); warp_tot: 32 ints of shared memory.
__device__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int r = x - v + (warp ? warp_tot[warp - 1] : 0);
  __syncthreads();
  return r;
}

struct Levels {
  int n;                    // P holds n + 1 prefix arrays
  int div[MAX_LEVELS + 1];  // D_l: entries of a bucket one level-l item covers
};

// P[l][k] = sum_{k' < k} ceil(counts[k'] / D_l), P[l][n_keys] the total;
// cursor = P[0] (the scatter's claim counters).
__global__ void __launch_bounds__(LT) layout_kernel(const int* __restrict__ counts,
                                                    int n_keys, Levels lv,
                                                    int* __restrict__ P,
                                                    int* __restrict__ cursor) {
  __shared__ int warp_tot[32];
  const int per = (n_keys + LT - 1) / LT;
  const int k0 = min(n_keys, (int)threadIdx.x * per), k1 = min(n_keys, k0 + per);
  for (int l = 0; l <= lv.n; l++) {
    const int D = lv.div[l];
    int t = 0;
    for (int k = k0; k < k1; k++) t += (counts[k] + D - 1) / D;
    int run = block_exclusive_scan(t, warp_tot);
    int* Pl = P + (long long)l * (n_keys + 1);
    for (int k = k0; k < k1; k++) {
      Pl[k] = run;
      if (l == 0) cursor[k] = run;
      run += (counts[k] + D - 1) / D;
    }
    if (threadIdx.x == LT - 1) Pl[n_keys] = run;
  }
}

// Largest k < n with P[k] <= g, given P[0] <= g < P[n] (P non-decreasing).
__device__ __forceinline__ int find_run(const int* P, int n, int g) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (P[mid] <= g) lo = mid;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(HT) scatter_kernel(const int32_t* __restrict__ s, int m,
                                                     int chunks, int S,
                                                     const int* __restrict__ blockhist,
                                                     int* __restrict__ cursor,
                                                     int* __restrict__ idx) {
  __shared__ int stage[HT * NWIN];  // this block's entries, sorted by bucket
  __shared__ int loc[NBKT + 1];     // start of each bucket's run in stage
  __shared__ int fill[NBKT];
  __shared__ int gpos[NBKT];        // start of each run in idx
  __shared__ int warp_tot[32];
  const int np = NWIN / S, lane = threadIdx.x & 31;
  const BlockDigits bd(chunks, np);
  const int v = blockhist[(long long)blockIdx.x * NBKT + threadIdx.x];
  gpos[threadIdx.x] = v ? atomicAdd(&cursor[bd.key * NBKT + threadIdx.x], v) : 0;
  const int ex = block_exclusive_scan(v, warp_tot);
  loc[threadIdx.x] = ex;
  fill[threadIdx.x] = ex;
  if (threadIdx.x == HT - 1) loc[NBKT] = ex + v;
  __syncthreads();
  for (int r = 0; r < np; r++) {
    const int i = (bd.c * np + r) * HT + threadIdx.x;
    uint32_t w[8];
    load_scalar(s, m, bd.b, i, w);
    for (int win = bd.p * S; win < bd.p * S + S; win++) {
      const int d = digit(w, win);
      const unsigned peers = __match_any_sync(FULL, d);
      if (d) {
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&fill[d], __popc(peers));
        base = __shfl_sync(peers, base, leader);
        // the base of window win of point i: 2^(8 (win - p S)) P_i
        stage[base + __popc(peers & ((1u << lane) - 1))] = (win - bd.p * S) * m + i;
      }
    }
  }
  __syncthreads();
  const int total = loc[NBKT];
  for (int t = threadIdx.x; t < total; t += HT) {
    const int d = find_run(loc, NBKT, t);
    idx[gpos[d] + t - loc[d]] = stage[t];
  }
}

// Register budget of the point kernels: blocks of 128 threads, at least
// MIN_BLOCKS of them resident on an SM (G1: 3, at most 168 registers; G2:
// 2, at most 255). At 4 G1 blocks the mixed-add level ran 0.4% faster on
// the h-MSM and 12% slower on the witness MSMs.
constexpr int PT = 128;
constexpr int MIN_BLOCKS = sizeof(T) == sizeof(Fe) ? 3 : 2;

// Level 0: thread g sums the table points of entries [start, end) of its
// bucket's run in idx. Pin: bucket starts in idx; Pout: segment starts.
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
bucket_sum0_kernel(const int32_t* __restrict__ aff, const int* __restrict__ idx,
                   const int* __restrict__ Pin, const int* __restrict__ Pout, int n_keys,
                   int seg, int32_t* __restrict__ out) {
  const int g = blockIdx.x * PT + threadIdx.x;
  if (g >= Pout[n_keys]) return;
  const int key = find_run(Pout, n_keys, g);
  int e = Pin[key] + (g - Pout[key]) * seg;
  Jac<T> acc = jac_inf<T>();
  for (int n = min(seg, Pin[key + 1] - e); n > 0; n--, e++) {
    const int32_t* a = aff + (long long)idx[e] * 2 * PW;
    jac_madd(acc, Coord<T>::loadp(a), Coord<T>::loadp(a + PW));
  }
  jac_storep(out, g, acc);
}

// Level l > 0: the same over the packed Jacobian partials of level l - 1.
// The running sum lives in the thread's slot of shared memory: each add
// consumes the partial it loads into registers and reads the sum from its
// slot coordinate by coordinate (Packed), so one G2 point is live at a time.
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
bucket_sum_kernel(const int32_t* __restrict__ in, const int* __restrict__ Pin,
                  const int* __restrict__ Pout, int n_keys, int seg,
                  int32_t* __restrict__ out) {
  __shared__ uint4 sm4[PT * 3 * PW / 4];
  int32_t* sum = reinterpret_cast<int32_t*>(sm4) + threadIdx.x * 3 * PW;
  const int g = blockIdx.x * PT + threadIdx.x;
  if (g >= Pout[n_keys]) return;
  const int key = find_run(Pout, n_keys, g);
  const int e = Pin[key] + (g - Pout[key]) * seg;
  const int n = min(seg, Pin[key + 1] - e);
  jac_storep(sum, 0, jac_loadp<T>(in, e));
  for (int k = 1; k < n; k++)
    jac_storep(sum, 0, jac_add_src(jac_loadp<T>(in, e + k), Packed<T>{sum}));
  jac_storep(out, g, jac_loadp<T>(sum, 0));
}

// Block b (one warp): out[b] = sum_d d bucket(b, d), for b a key's (proof,
// pass); written to oX, oY, oZ, or packed to sums when it is not null (the
// passes' weighted sums, which fold_kernel sums). A bucket whose key has
// one partial at the last level holds its sum at PL[key]; an empty one holds
// none. Every add takes one operand from registers, which it consumes, and
// the other from memory (Packed): the thread's running sum and weighted
// sum have homes in shared memory, so no more than one G2 point is live at
// a time (__syncwarp, a memory barrier, makes each read come from there).
__global__ void __launch_bounds__(NCH)
reduce_kernel(const int32_t* __restrict__ parts, const int* __restrict__ PL,
              int32_t* __restrict__ sums, int32_t* oX, int32_t* oY, int32_t* oZ) {
  static_assert(NCH == 32, "one warp per proof");
  __shared__ uint4 sm4[2 * NCH * 3 * PW / 4];
  const int c = threadIdx.x;
  int32_t* pub = reinterpret_cast<int32_t*>(sm4);  // each thread's published point
  int32_t* acc = pub + (NCH + c) * 3 * PW;         // this thread's L_c, then V_c
  int32_t* mine = pub + c * 3 * PW;
  const int* P = PL + blockIdx.x * NBKT + c * CW;
  jac_storep(acc, 0, jac_inf<T>());
  Jac<T> run = jac_inf<T>();
  for (int j = CW - 1; j >= 0; j--) {
    if (P[j + 1] > P[j]) run = jac_add_src(run, Packed<T>{parts + (long long)P[j] * 3 * PW});
    if (j) {  // L_c += run
      jac_storep(mine, 0, run);
      __syncwarp();
      jac_storep(acc, 0, jac_add_src(jac_loadp<T>(acc, 0), Packed<T>{mine}));
      __syncwarp();
      run = jac_loadp<T>(mine, 0);
    }
  }
  for (int o = 1; o < NCH; o <<= 1) {  // run: T_c -> U_c
    jac_storep(mine, 0, run);
    __syncwarp();
    if (c + o < NCH) run = jac_add_src(run, Packed<T>{pub + (c + o) * 3 * PW});
    __syncwarp();
  }
  if (c)
    for (int k = 0; k < 3; k++) run = jac_double(run);
  else
    run = jac_inf<T>();
  __syncwarp();
  Jac<T> v = jac_add_src(run, Packed<T>{acc});  // V_c = L_c + 8 U_c (V_0 = L_0)
  for (int o = NCH / 2; o >= 1; o >>= 1) {
    jac_storep(mine, 0, v);
    __syncwarp();
    if (c < o) v = jac_add_src(v, Packed<T>{pub + (c + o) * 3 * PW});
    __syncwarp();
  }
  if (c == 0) {
    if (sums)
      jac_storep(sums, blockIdx.x, v);
    else
      jac_store(oX, oY, oZ, blockIdx.x, v);
  }
}

// One thread per proof b: out[b] = sum_p 2^(8 S p) V[b, p] over its np
// passes' weighted sums V (packed), Horner-style from the top pass: 8 S
// doublings, then the next pass added from memory (Packed). As pob_tpu's
// pippenger_msm folds its windows (msm.py:92), with S windows to a pass.
__global__ void __launch_bounds__(32)
fold_kernel(const int32_t* __restrict__ sums, int B, int np, int S, int32_t* oX, int32_t* oY,
            int32_t* oZ) {
  const int b = blockIdx.x * 32 + threadIdx.x;
  if (b >= B) return;
  Jac<T> acc = jac_loadp<T>(sums, (long long)b * np + np - 1);
  for (int p = np - 2; p >= 0; p--) {
    for (int k = 0; k < 8 * S; k++) acc = jac_double(acc);
    acc = jac_add_src(acc, Packed<T>{sums + ((long long)b * np + p) * 3 * PW});
  }
  jac_store(oX, oY, oZ, b, acc);
}

// K6: Jacobian P_i (16-bit-limb layout) -> packed affine 2^(dbl w) P_i for
// w < windows, one thread per point, dbl doublings between windows; row
// w m + i (window-major: K3's shifted bases, windows 32, dbl 8) or
// i windows + w (wire-major: the plan's doubling chains, windows 254, dbl
// 1); windows 1 is a plain conversion to affine. Replaces
// pob_tpu/prover/groth16.py::_expand_doublings_kernel (a scan of doublings
// over every full wire's point). windows and dbl are run-time arguments, so
// one body serves every caller.
//
// Bound: integer multiplies. Design: one inversion per point, not per
// output (Montgomery's trick over the point's windows), and the doublings
// once. With c_w = Z_0 ... Z_w over the nonzero Z (c_{-1} = 1):
//  1. the doublings; row w gets U = X_w c_{w-1}^2, V = Y_w c_{w-1}^3 ((0, 0)
//     for Z_w = 0), the scratch zs gets Z_w; c lives in shared memory, so it
//     is not held in registers across the doublings (G2's registers);
//  2. one inversion, inv = c_{windows-1}^-1;
//  3. backwards: inv = c_w^-1, so x = U inv^2 = X_w / Z_w^2 and y = V inv^3
//     over row w, then inv <- inv Z_w (a zero Z_w is skipped: it leaves its
//     row (0, 0) and its neighbours alone).
// G1 at (32, 8): about 2,400 Fq products per point where an inversion per
// output took about 14,100. The wrapper gives a launch n points, i0 on,
// with n windows coordinates of scratch (bounded whatever m is). The
// chains (254, 1) stay a serial walk per point: latency-bound where there
// are few points.
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
shifted_bases_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                     const int32_t* __restrict__ Z, long long m, int windows, int dbl,
                     int wire_major, long long i0, long long n, int32_t* __restrict__ out,
                     int32_t* __restrict__ zs) {
  __shared__ uint4 cs4[PT * PW / 4];
  int32_t* cs = reinterpret_cast<int32_t*>(cs4) + threadIdx.x * PW;
  const long long j = (long long)blockIdx.x * PT + threadIdx.x;
  if (j >= n) return;
  const long long i = i0 + j;
  const long long step = (wire_major ? 1 : m) * 2 * PW;  // words between windows' rows
  int32_t* row0 = out + (wire_major ? i * windows : i) * 2 * PW;
  Jac<T> p = jac_load<T>(X, Y, Z, i);
  Coord<T>::storep(cs, Coord<T>::one());
  for (int w = 0; w < windows; w++) {
    if (w)
      for (int k = 0; k < dbl; k++) p = jac_double(p);
    asm volatile("" ::: "memory");  // c is read from cs after the doublings
    int32_t* o = row0 + w * step;
    Coord<T>::storep(zs + (w * n + j) * PW, p.z);
    if (cis_zero(p.z)) {
      Coord<T>::storep(o, Coord<T>::zero());
      Coord<T>::storep(o + PW, Coord<T>::zero());
      continue;
    }
    const T c = Coord<T>::loadp(cs);
    const T c2 = csqr(c);
    Coord<T>::storep(o, cmul(p.x, c2));
    Coord<T>::storep(o + PW, cmul(p.y, cmul(c2, c)));
    Coord<T>::storep(cs, cmul(c, p.z));
  }
  T inv = cinv(Coord<T>::loadp(cs));
  for (int w = windows - 1; w >= 0; w--) {
    const T z = Coord<T>::loadp(zs + (w * n + j) * PW);
    if (cis_zero(z)) continue;
    int32_t* o = row0 + w * step;
    const T i2 = csqr(inv);
    Coord<T>::storep(o, cmul(Coord<T>::loadp(o), i2));
    Coord<T>::storep(o + PW, cmul(Coord<T>::loadp(o + PW), cmul(i2, inv)));
    inv = cmul(inv, z);
  }
}

static inline unsigned blocks_for(long long n, int t) { return (unsigned)((n + t - 1) / t); }

#define POB_CHECK() return (int)cudaGetLastError()

// S: the shifted windows of the bases (a divisor of 32); 32 / S passes.
static inline int digit_chunks(int m, int S) {
  const int per = HT * (NWIN / S);
  return (m + per - 1) / per;
}

extern "C" int pob_msm_hist(const void* s, int B, int m, int S, void* blockhist, void* counts,
                            void* stream) {
  if (S < 1 || NWIN % S) return (int)cudaErrorInvalidValue;
  const int chunks = digit_chunks(m, S);
  hist_kernel<<<B * (NWIN / S) * chunks, HT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s, m, chunks, S, (int*)blockhist, (int*)counts);
  POB_CHECK();
}

extern "C" int pob_msm_max_levels() { return MAX_LEVELS; }

extern "C" int pob_msm_layout(const void* counts, int n_keys, int n_levels,
                              const int* div, void* P, void* cursor, void* stream) {
  if (n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l <= n_levels; l++) lv.div[l] = div[l];
  layout_kernel<<<1, LT, 0, (cudaStream_t)stream>>>((const int*)counts, n_keys, lv, (int*)P,
                                                     (int*)cursor);
  POB_CHECK();
}

extern "C" int pob_msm_scatter(const void* s, int B, int m, int S, const void* blockhist,
                               void* cursor, void* idx, void* stream) {
  if (S < 1 || NWIN % S) return (int)cudaErrorInvalidValue;
  const int chunks = digit_chunks(m, S);
  scatter_kernel<<<B * (NWIN / S) * chunks, HT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s, m, chunks, S, (const int*)blockhist, (int*)cursor, (int*)idx);
  POB_CHECK();
}

// src: the shifted-bases table with idx (level 0) or the partials (idx
// null); cap: most segments this level can have, the grid's size.
extern "C" int pob_msm_bucket_sum(const void* src, const void* idx, const void* Pin,
                                  const void* Pout, int n_keys, int seg, long long cap,
                                  void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (idx)
    bucket_sum0_kernel<<<blocks_for(cap, PT), PT, 0, st>>>(
        (const int32_t*)src, (const int*)idx, (const int*)Pin, (const int*)Pout, n_keys, seg,
        (int32_t*)out);
  else
    bucket_sum_kernel<<<blocks_for(cap, PT), PT, 0, st>>>(
        (const int32_t*)src, (const int*)Pin, (const int*)Pout, n_keys, seg, (int32_t*)out);
  POB_CHECK();
}

// n: the keys' (proof, pass) count; sums null: one pass, written to oX, oY, oZ.
extern "C" int pob_msm_reduce(const void* parts, const void* PL, int n, void* sums, void* oX,
                              void* oY, void* oZ, void* stream) {
  reduce_kernel<<<n, NCH, 0, (cudaStream_t)stream>>>(
      (const int32_t*)parts, (const int*)PL, (int32_t*)sums, (int32_t*)oX, (int32_t*)oY,
      (int32_t*)oZ);
  POB_CHECK();
}

extern "C" int pob_msm_fold(const void* sums, int B, int np, int S, void* oX, void* oY,
                            void* oZ, void* stream) {
  fold_kernel<<<blocks_for(B, 32), 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sums, B, np, S, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ);
  POB_CHECK();
}

extern "C" int pob_msm_shifted_bases(const void* X, const void* Y, const void* Z, long long m,
                                     int windows, int dbl, int wire_major, long long i0,
                                     long long n, void* out, void* zs, void* stream) {
  shifted_bases_kernel<<<blocks_for(n, PT), PT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z, m, windows, dbl, wire_major, i0,
      n, (int32_t*)out, (int32_t*)zs);
  POB_CHECK();
}
