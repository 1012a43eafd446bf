// Streaming ("online") Gibbs-kernel reductions for the O(n d)-memory dense
// Sinkhorn: the Gibbs kernel K is recomputed from the points, never stored.
//
// Replaces the TPU kernels of src/repro/kernels/fused_sinkhorn.py:
//   online_matvec_call (the pallas_call at :128):
//       out_i = sum_j exp(-C(x_i, y_j) / eps) v_j
//   online_lse_call (the pallas_call at :160):
//       out_i = LSE_j(-C(x_i, y_j) / eps + g_j / eps)
// together with the padding of n, m and d that their wrappers in
// src/repro/kernels/ops.py do around them (nothing is padded here).
//
// The cost of a pair is the formula of the plain versions
// (repro_torch/kernels/ref.py) and of the reference's _cost_tile:
//   sq = max(||x_i||^2 + ||y_j||^2 - 2 <x_i, y_j>, 0)
//   C  = sq                                                   (sqeuclidean)
//   C  = -2 log max(cos(min(z, pi/2)), 1e-30),  z = sqrt(sq + 1e-30) / (2 eta)  (wfr)
// A WFR pair with z >= pi/2 is blocked: it adds 0 to the matvec and enters
// the LSE as -1e30. Every LSE term is clamped at -1e30, so a -inf in g
// gives no NaN, and a row's result is log(s) + m from its running max m and
// rescaled sum s; a fully blocked row therefore comes out at -1e30. One
// deviation from the literal formula: -C/eps is computed as C * (-1/eps),
// which moves the exponent's argument by at most one rounding (a relative
// error of |C/eps| * 2^-23 on a kernel value, 1e-5 at C/eps = 88, where
// exp underflows), and g_j / eps is divided once per column as it is staged.
// expf, logf and cosf are the accurate library functions (no fast math):
// the WFR blocked set must be decided as the plain version decides it.
//
// The TPU kernels accumulate over column tiles on a grid axis that runs in
// order. Blocks on the H100 run in no order, so here each output row is
// owned by one thread, which walks over every column tile in order: the sum
// is taken in one fixed order, without atomics, and a repeated launch is
// bitwise equal. Each column tile (y_j, ||y_j||^2, and v_j or g_j / eps) is
// staged once in shared memory and read by the block's 128 rows; a thread
// keeps its x_i in registers when d <= 8 (one kernel per d, with the tile's
// rows padded to 16 bytes for vector loads) and reads it through the
// read-only cache otherwise. The tile's width is sized by d so that it
// stays within the default 48 KB of shared memory. The matvec sums each
// tile apart and adds the tile sums in order; the LSE takes the running max
// over chunks of 16 columns, so that one exponential per pair and one per
// chunk suffice (the flash-attention recurrence).
//
// What bounds it on an H100: the arithmetic, not bytes. A launch at the
// main path's n = m = 2^17, d = 5 visits 1.7e10 pairs, each of about
// 2 d + 7 float32 operations and one exponential, while it reads only
// O((n + m) d) bytes. Register-blocking several rows per thread, a cheaper
// exponential and the tensor cores (wgmma) for <x_i, y_j> are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // output rows per block, one per thread
constexpr int kMaxTileCols = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kLseChunk = 16;
constexpr float kNegInf = -1e30f;
constexpr float kHalfPi = 1.57079632679489661923f;

// Shared-memory row of one staged column: y_j[0..d), ||y_j||^2, then v_j
// (matvec) or g_j / eps (lse). With d known at compile time the row is
// padded to a multiple of 4 floats, so it is read as float4s.
template <int D>
__host__ __device__ constexpr int row_stride(int d) {
  return D > 0 ? (D + 2 + 3) / 4 * 4 : d + 2;
}

// The pair's ground cost from its squared distance; false if WFR blocks it.
template <bool kWfr>
__device__ __forceinline__ bool pair_cost(float sq, float two_eta, float* c) {
  if constexpr (kWfr) {
    const float z = sqrtf(sq + 1e-30f) / two_eta;
    if (z >= kHalfPi) return false;
    *c = -2.0f * logf(fmaxf(cosf(fminf(z, kHalfPi)), 1e-30f));
  } else {
    *c = sq;
  }
  return true;
}

// One thread's row: x_i in registers (D > 0) or read from memory (D == 0).
template <int D>
struct Row {
  float xr[D > 0 ? D : 1];
  const float* xi;
  float xx;

  __device__ Row(const float* x, int64_t i, bool live, int d) : xi(x + i * d), xx(0.0f) {
    if constexpr (D > 0) {
#pragma unroll
      for (int t = 0; t < D; ++t) {
        xr[t] = live ? __ldg(xi + t) : 0.0f;
        xx += xr[t] * xr[t];
      }
    } else {
      if (live)
        for (int t = 0; t < d; ++t) {
          const float a = __ldg(xi + t);
          xx += a * a;
        }
    }
  }

  // squared distance to the staged column at `row`; its last value in *w
  __device__ __forceinline__ float sq(const float* row, int d, float* w) const {
    float xy = 0.0f, yy;
    if constexpr (D > 0) {
      constexpr int S = row_stride<D>(0);
      float r[S];
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(row)[q];
        r[4 * q] = f.x;
        r[4 * q + 1] = f.y;
        r[4 * q + 2] = f.z;
        r[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int t = 0; t < D; ++t) xy += xr[t] * r[t];
      yy = r[D];
      *w = r[D + 1];
    } else {
      for (int t = 0; t < d; ++t) xy += __ldg(xi + t) * row[t];
      yy = row[d];
      *w = row[d + 1];
    }
    return fmaxf(xx + yy - 2.0f * xy, 0.0f);
  }
};

// Stage columns [j0, j0 + tc) of y with their squared norms and their
// weights w_j / w_div: v_j / 1 (matvec, exact) or g_j / eps (lse).
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ y,
                                      const float* __restrict__ w, int64_t j0, int tc, int d,
                                      float w_div) {
  const int S = row_stride<D>(d);
  const int dd = D > 0 ? D : d;
  for (int c = threadIdx.x; c < tc; c += kThreads) {
    const float* yj = y + (j0 + c) * dd;
    float* row = tile + c * S;
    float yy = 0.0f;
    for (int t = 0; t < dd; ++t) {
      const float b = __ldg(yj + t);
      row[t] = b;
      yy += b * b;
    }
    row[dd] = yy;
    row[dd + 1] = __ldg(w + j0 + c) / w_div;
    for (int t = dd + 2; t < S; ++t) row[t] = 0.0f;
  }
}

template <int D, bool kWfr>
__global__ void __launch_bounds__(kThreads)
    online_matvec_f32(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ v, int64_t n, int64_t m, int d, int tile_cols,
                      float neg_inv_eps, float two_eta, float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;
  const Row<D> xrow(x, live ? i : 0, live, d);
  const int S = row_stride<D>(d);
  float acc = 0.0f;
  for (int64_t j0 = 0; j0 < m; j0 += tile_cols) {
    const int tc = static_cast<int>(m - j0 < tile_cols ? m - j0 : tile_cols);
    __syncthreads();  // the previous tile has been read by every thread
    stage<D>(tile, y, v, j0, tc, d, 1.0f);
    __syncthreads();
    if (!live) continue;
    float part = 0.0f;
#pragma unroll 4
    for (int c = 0; c < tc; ++c) {
      float vj, cost;
      const float sq = xrow.sq(tile + c * S, d, &vj);
      if (pair_cost<kWfr>(sq, two_eta, &cost)) part += expf(cost * neg_inv_eps) * vj;
    }
    acc += part;
  }
  if (live) out[i] = acc;
}

template <int D, bool kWfr>
__global__ void __launch_bounds__(kThreads)
    online_lse_f32(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ g, int64_t n, int64_t m, int d, int tile_cols,
                   float eps, float neg_inv_eps, float two_eta, float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;
  const Row<D> xrow(x, live ? i : 0, live, d);
  const int S = row_stride<D>(d);
  float run_max = kNegInf;  // every term is >= -1e30, so this is a safe start
  float s = 0.0f;
  for (int64_t j0 = 0; j0 < m; j0 += tile_cols) {
    const int tc = static_cast<int>(m - j0 < tile_cols ? m - j0 : tile_cols);
    __syncthreads();
    stage<D>(tile, y, g, j0, tc, d, eps);
    __syncthreads();
    if (!live) continue;
    for (int c0 = 0; c0 < tc; c0 += kLseChunk) {
      float z[kLseChunk];
      float chunk_max = kNegInf;
#pragma unroll
      for (int q = 0; q < kLseChunk; ++q) {
        z[q] = kNegInf;
        if (c0 + q < tc) {
          float gj, cost;
          const float sq = xrow.sq(tile + (c0 + q) * S, d, &gj);
          const float zq = pair_cost<kWfr>(sq, two_eta, &cost) ? cost * neg_inv_eps + gj : kNegInf;
          z[q] = fmaxf(zq, kNegInf);
          chunk_max = fmaxf(chunk_max, z[q]);
        }
      }
      const float new_max = fmaxf(run_max, chunk_max);
      float add = 0.0f;
#pragma unroll
      for (int q = 0; q < kLseChunk; ++q)
        if (c0 + q < tc) add += expf(z[q] - new_max);
      s = s * expf(run_max - new_max) + add;
      run_max = new_max;
    }
  }
  // s >= 1 once any column was visited (the max term adds exp(0)); with no
  // columns at all the row is empty and gets the sentinel, as in the plain
  // version
  if (live) out[i] = s > 0.0f ? logf(s) + run_max : kNegInf;
}

// Column-tile width for points of dimension d: at most kMaxTileCols, and
// within kSmemBytes of shared memory.
template <int D>
int tile_cols_for(int d) {
  const int fit = kSmemBytes / (row_stride<D>(d) * static_cast<int>(sizeof(float)));
  return fit < kMaxTileCols ? fit : kMaxTileCols;
}

template <int D>
cudaError_t launch_matvec(const float* x, const float* y, const float* v, int64_t n, int64_t m,
                          int d, float eps, int wfr, float eta, float* out, cudaStream_t stream) {
  const int tc = tile_cols_for<D>(d);
  if (tc < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tc) * row_stride<D>(d) * sizeof(float);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if (wfr)
    online_matvec_f32<D, true><<<blocks, kThreads, smem, stream>>>(
        x, y, v, n, m, d, tc, -1.0f / eps, 2.0f * eta, out);
  else
    online_matvec_f32<D, false><<<blocks, kThreads, smem, stream>>>(
        x, y, v, n, m, d, tc, -1.0f / eps, 2.0f * eta, out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_lse(const float* x, const float* y, const float* g, int64_t n, int64_t m,
                       int d, float eps, int wfr, float eta, float* out, cudaStream_t stream) {
  const int tc = tile_cols_for<D>(d);
  if (tc < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tc) * row_stride<D>(d) * sizeof(float);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if (wfr)
    online_lse_f32<D, true><<<blocks, kThreads, smem, stream>>>(
        x, y, g, n, m, d, tc, eps, -1.0f / eps, 2.0f * eta, out);
  else
    online_lse_f32<D, false><<<blocks, kThreads, smem, stream>>>(
        x, y, g, n, m, d, tc, eps, -1.0f / eps, 2.0f * eta, out);
  return cudaGetLastError();
}

// d = 1..8 get a kernel each (x_i in registers); larger d the general one.
// Each comes in two, one per cost: a run-time cost switch inside the loop
// would put the WFR branch (with the slow-path call of cosf) around every
// pair and keep the unrolled pairs from overlapping.
#define DISPATCH_D(fn, d, ...)                 \
  switch (d) {                                 \
    case 1: return fn<1>(__VA_ARGS__);         \
    case 2: return fn<2>(__VA_ARGS__);         \
    case 3: return fn<3>(__VA_ARGS__);         \
    case 4: return fn<4>(__VA_ARGS__);         \
    case 5: return fn<5>(__VA_ARGS__);         \
    case 6: return fn<6>(__VA_ARGS__);         \
    case 7: return fn<7>(__VA_ARGS__);         \
    case 8: return fn<8>(__VA_ARGS__);         \
    default: return fn<0>(__VA_ARGS__);        \
  }

cudaError_t matvec(const float* x, const float* y, const float* v, int64_t n, int64_t m, int d,
                   float eps, int wfr, float eta, float* out, cudaStream_t stream) {
  DISPATCH_D(launch_matvec, d, x, y, v, n, m, d, eps, wfr, eta, out, stream)
}

cudaError_t lse(const float* x, const float* y, const float* g, int64_t n, int64_t m, int d,
                float eps, int wfr, float eta, float* out, cudaStream_t stream) {
  DISPATCH_D(launch_lse, d, x, y, g, n, m, d, eps, wfr, eta, out, stream)
}

}  // namespace

extern "C" {

// Both launch on `stream`, allocate nothing, and return the launch's
// cudaError_t (0 = success). Pointers are device pointers: x is (n, d) and
// y is (m, d), contiguous float32; v or g is (m,) float32; out is (n,)
// float32. wfr selects the WFR cost (eta its range parameter) over the
// squared euclidean one. d above 12,286 does not fit one staged column in
// shared memory and is refused (cudaErrorInvalidValue).
int online_matvec_launch(const float* x, const float* y, const float* v, int64_t n, int64_t m,
                         int d, float eps, int wfr, float eta, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      matvec(x, y, v, n, m, d, eps, wfr, eta, out, static_cast<cudaStream_t>(stream)));
}

int online_lse_launch(const float* x, const float* y, const float* g, int64_t n, int64_t m,
                      int d, float eps, int wfr, float eta, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      lse(x, y, g, n, m, d, eps, wfr, eta, out, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
