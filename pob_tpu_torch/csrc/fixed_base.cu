// K4: fixed-base scalar multiplication k_i * G over G1 and G2 for the
// trusted setup's query points.
//
// Replaces pob_tpu/prover/msm.py::windowed_fixed_base_msm (msm.py:248), as
// reached through groth16._fixed_base (groth16.py:178), and the window table
// built by groth16._window_table_kernel (groth16.py:131).
//
// Bound on this card: integer multiplies. Each scalar costs up to 32
// Jacobian adds (16 Fq multiplies on G1, 44 on G2, 264 32-bit multiplies
// each) against 64 bytes of scalar in and 192 / 384 bytes of point out.
// Design: the window table T[w][v] = v * 2^(8w) * G (8192 points) is made
// once by pob_fb_scalar_mul, one thread per entry running double-and-add
// from G; then pob_fb_window gives each scalar one thread that gathers one
// table point per nonzero 8-bit digit and adds it in registers. The table
// (1.5 MB on G1, 3 MB on G2) stays in L2.
#include "curve.cuh"

using namespace pob;

template <class T>
__global__ void scalar_mul_kernel(const int32_t* __restrict__ gX,
                                  const int32_t* __restrict__ gY,
                                  const int32_t* __restrict__ gZ,
                                  const int32_t* __restrict__ scalars, long long n,
                                  int32_t* oX, int32_t* oY, int32_t* oZ) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<T> g = jac_load<T>(gX, gY, gZ, 0);
  const int32_t* s = scalars + i * 16;
  Jac<T> acc = jac_inf<T>();
  for (int bit = 255; bit >= 0; bit--) {
    acc = jac_double(acc);
    if ((s[bit >> 4] >> (bit & 15)) & 1) acc = jac_add(acc, g);
  }
  jac_store(oX, oY, oZ, i, acc);
}

template <class T>
__global__ void window_kernel(const int32_t* __restrict__ tX,
                              const int32_t* __restrict__ tY,
                              const int32_t* __restrict__ tZ,
                              const int32_t* __restrict__ scalars, long long n,
                              int32_t* oX, int32_t* oY, int32_t* oZ) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* s = scalars + i * 16;
  Jac<T> acc = jac_inf<T>();
  for (int w = 0; w < 32; w++) {
    int d = (s[w >> 1] >> (8 * (w & 1))) & 0xFF;
    if (d) acc = jac_add(acc, jac_load<T>(tX, tY, tZ, w * 256 + d));
  }
  jac_store(oX, oY, oZ, i, acc);
}

constexpr int PT = 64;

#define POB_FB_ARGS                                                           \
  (const int32_t*)X, (const int32_t*)Y, (const int32_t*)Z,                    \
      (const int32_t*)scalars, n, (int32_t*)oX, (int32_t*)oY, (int32_t*)oZ

extern "C" int pob_fb_scalar_mul(int group, const void* X, const void* Y,
                                 const void* Z, const void* scalars, long long n,
                                 void* oX, void* oY, void* oZ, void* stream) {
  if (n <= 0) return 0;
  unsigned g = (unsigned)((n + PT - 1) / PT);
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 0)
    scalar_mul_kernel<Fe><<<g, PT, 0, s>>>(POB_FB_ARGS);
  else
    scalar_mul_kernel<Fq2><<<g, PT, 0, s>>>(POB_FB_ARGS);
  return (int)cudaGetLastError();
}

extern "C" int pob_fb_window(int group, const void* X, const void* Y,
                             const void* Z, const void* scalars, long long n,
                             void* oX, void* oY, void* oZ, void* stream) {
  if (n <= 0) return 0;
  unsigned g = (unsigned)((n + PT - 1) / PT);
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 0)
    window_kernel<Fe><<<g, PT, 0, s>>>(POB_FB_ARGS);
  else
    window_kernel<Fq2><<<g, PT, 0, s>>>(POB_FB_ARGS);
  return (int)cudaGetLastError();
}
