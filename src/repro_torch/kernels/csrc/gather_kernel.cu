// Gathered Gibbs-kernel evaluation for the matrix-free Spar-Sink sketch.
//
// Replaces the TPU kernel src/repro/kernels/gather_kernel.py
// (gathered_kernel_call, the pallas_call at :68) together with the XLA
// gather and the padding of d to 128 lanes that its wrapper
// src/repro/kernels/ops.py::gathered_kernel does around it.
//
// For each of k index pairs e = (rows[e], cols[e]) it computes
//   sq  = ||x_i||^2 + ||y_j||^2 - 2 <x_i, y_j>, clamped at 0
//   C_e = sq                                      (sqeuclidean)
//   C_e = -2 log max(cos(min(z, pi/2)), 1e-30),   z = sqrt(sq + 1e-30) / (2 eta)  (wfr)
//   K_e = exp(-C_e / eps)
// in float32; WFR pairs with z >= pi/2 (d >= pi * eta) are blocked and come
// out exactly K_e = 0, C_e = +inf. This is the formula of the plain version,
// repro_torch/kernels/ref.py::gathered_kernel_ref.
//
// What bounds it on an H100: bytes. Per pair it reads two int64 indices,
// gathers 2 * d * 4 B of point data from rows that the sampler drew at
// random, and writes 8 B; the arithmetic (about 3d fused multiply-adds and
// one exp, plus sqrt/cos/log for wfr) is far below the card's float32 rate.
// The design follows from that: one thread per pair, the gather done here
// from the ungathered points (no gathered copy is ever written to device
// memory), nothing padded, and consecutive threads reading consecutive
// indices and writing consecutive outputs, so those accesses coalesce. The
// point rows themselves are read at random; at the main path's n = 2^17 and
// d = 5 both point sets (5 MB) stay in the 50 MB L2 cache.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gathered_kernel_f32(const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const int64_t* __restrict__ rows,
                                    const int64_t* __restrict__ cols,
                                    int64_t n, int64_t m, int64_t k, int d,
                                    float eps, int wfr, float eta,
                                    float* __restrict__ k_out,
                                    float* __restrict__ c_out,
                                    int* __restrict__ bad_index) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= k) return;
  const int64_t i = rows[e];
  const int64_t j = cols[e];
  if (i < 0 || i >= n || j < 0 || j >= m) {
    // never read outside the points: flag the call (the wrapper raises) and
    // leave NaN behind
    *bad_index = 1;
    k_out[e] = NAN;
    c_out[e] = NAN;
    return;
  }
  const float* xi = x + i * d;
  const float* yj = y + j * d;
  float xx = 0.0f, yy = 0.0f, xy = 0.0f;
  for (int t = 0; t < d; ++t) {
    const float a = __ldg(xi + t);
    const float b = __ldg(yj + t);
    xx += a * a;
    yy += b * b;
    xy += a * b;
  }
  const float sq = fmaxf(xx + yy - 2.0f * xy, 0.0f);
  float c = sq;
  float kv;
  if (wfr) {
    const float half_pi = 1.57079632679489661923f;
    const float z = sqrtf(sq + 1e-30f) / (2.0f * eta);
    if (z >= half_pi) {
      k_out[e] = 0.0f;
      c_out[e] = INFINITY;
      return;
    }
    c = -2.0f * logf(fmaxf(cosf(fminf(z, half_pi)), 1e-30f));
  }
  kv = expf(-c / eps);
  k_out[e] = kv;
  c_out[e] = c;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = success).
// Pointers are device pointers; x is (n, d) and y is (m, d), contiguous
// float32; rows/cols are (k,) int64; k_out/c_out are (k,) float32;
// bad_index is one int32 that the caller zeroed: the kernel sets it to 1
// if any rows[e] lies outside [0, n) or cols[e] outside [0, m).
int gathered_kernel_launch(const float* x, const float* y, const int64_t* rows,
                           const int64_t* cols, int64_t n, int64_t m, int64_t k,
                           int d, float eps, int wfr, float eta, float* k_out,
                           float* c_out, int* bad_index, void* stream) {
  if (k <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (k + kThreads - 1) / kThreads;
  gathered_kernel_f32<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, cols, n, m, k, d, eps, wfr, eta, k_out, c_out, bad_index);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
