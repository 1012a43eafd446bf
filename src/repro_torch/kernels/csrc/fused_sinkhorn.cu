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
// the LSE as -1e30, so a fully blocked row comes out at 0 and at -1e30.
// g_j = -inf (a dead atom) carries no mass: its term is clamped at -1e30.
//
// What bounds it on an H100: the instructions a pair, not bytes. A launch at
// the fused path's n = m = 2^17, d = 5 visits 1.7e10 pairs and reads only
// O((n + m) d) bytes. The float32 pipes and the exponential unit (MUFU, 16
// a clock per SM against 128 float32 operations) are both near their limit
// at the bound, and an SM issues at most 4 warp instructions a clock, so
// the design's aim is few instructions a pair:
//
// 1. A pre-scaled base-2 exponent (sqeuclidean). With s = log2(e) / eps and
//    r = sqrt(s), each staged column holds y'_j = r y_j, each row
//    x'_i = r x_i, so that
//        t = -sum_k (x'_ik - y'_jk)^2 = -C_ij / eps * log2(e) <= 0
//    is d subtractions and d FMAs, and the matvec adds ex2(t) v_j with one
//    MUFU.EX2 (ex2.approx.ftz, chosen at its call site) and one FMA. The
//    LSE works in log2 units on z = g'_j + t (the chain of t starts at
//    g'_j = max(s g_j, -1e30), staged once a column), and returns
//    ln2 (m_i + log2 S_i) from a running max m_i and the sum S_i of
//    2^(z - m_i), or exactly -1e30 for a row with no mass (m_i still at the
//    sentinel: fully blocked, all g = -inf, or no columns). The max is kept
//    lazily: a chunk of 8 columns is summed against m_i as it stands (one
//    exponential a pair, no max a pair), and only when that sum passes 2^64
//    (a term far above m_i, or the first real term after the -1e30 start)
//    is m_i raised to the chunk's max, S_i rescaled and the chunk summed
//    again. Terms thus stay at most 2^64 and S_i at most m 2^64, far from
//    float32's overflow at 2^128.
//    Why differences and not the expansion of the plain version,
//    t = -s ||x||^2 - s ||y||^2 + 2 s <x, y> (one add and d FMAs, then a
//    clamp at 0; 3 instructions a pair fewer at d = 5): the expansion's
//    rounding is relative to s (||x_i||^2 + ||y_j||^2), not to |t|, and at
//    eps = 1e-3 that is a relative error of some 1e-4 on exp(-C/eps), the
//    size of the plain version's tolerance (tests/test_torch_fused.py
//    emulates both forms in float32 and holds this choice); for points far
//    from the origin the expansion cancels outright. The error here:
//    t is within a few roundings of |t| (each square and sum is relative to
//    |t|, the scaling of x and y by r adds one rounding each, relative to
//    2 r^2 |x - y| |x|); t <= 0 exactly, so no clamp is needed (the plain
//    version's max(sq, 0)). ex2.approx is within 2 ulp, and its flush to
//    zero drops terms below 2^-126 (about exp(-87.3)) that expf kept as
//    denormals: at most 2^-126 |v_j| a pair. No fast-math flag is used:
//    WFR keeps the plain formula sq = max(||x||^2 + ||y||^2 - 2 <x, y>, 0)
//    and the accurate sqrtf/logf/cosf, so that its blocked set is decided
//    as the plain version decides it, with z = fma(C, -s, g'_j).
// 2. Register blocking. A thread owns kRows rows (n/kRows threads; one row
//    for WFR and for d > 8, which are not speed targets), keeps
//    their x_i in registers (one kernel per d <= 8; larger d reads x_i
//    through the read-only cache) and reads each staged column from shared
//    memory once per kRows pairs: kRows independent FMA/MUFU chains (8
//    rows ran faster than 4 on the H100; PERF.md).
// 3. Column slices. n/kRows threads alone are too few warps to hide the
//    latency of MUFU and FMA (one a scheduler at n = 2^17), so the launcher
//    splits the columns into P slices (online_slices: about kWaves waves
//    of blocks on the card, at most kMaxSlices). Block (g, p) writes its
//    rows' partials over slice p (a sum, or a (max, sum) pair) to a scratch
//    buffer that the wrapper allocates; a second short kernel combines the
//    P partials of each row in slice order. With P = 1 the first kernel
//    writes the result. Every sum is taken in one fixed order, without
//    atomics, so a repeated launch is bitwise equal.
// 4. No tensor cores at d <= 8: the product <x_i, y_j> of the expansion is
//    d of its d + 4 instructions a pair, and TF32's rounding of it (2^-11
//    relative, some 2 s <x, y> 2^-11 absolute in the exponent, about 0.07 at
//    eps = 0.1 and unit points) would move exp(-C/eps) far beyond the plain
//    version's tolerance. A split-precision wgmma product for large d is
//    later work.
//
// Column tiles are staged in shared memory (the tile's rows padded to 16
// bytes for vector loads when d <= 8), kMaxTileCols wide within the default
// 48 KB, with the ragged end padded by neutral columns (v = 0, g' = -1e30),
// so that the inner loops run unmasked over whole chunks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kRows = 8;       // R: output rows a thread (sqeuclidean)
constexpr int kMaxTileCols = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxSlices = 16;
constexpr int64_t kWaves = 4;  // waves of blocks that the slice count aims at
constexpr int kCombineThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kLog2e = 1.44269504088896340736f;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr float kLazyMax = 18446744073709551616.0f;  // 2^64: the LSE's rescaling trigger

// Rows a thread: kRows, or one for WFR (its accurate sqrtf, division, cosf
// and logf call slow paths, around which the calling convention saves the
// live registers) and for the general-d kernel (x_i is read from memory).
template <int D, bool kWfr>
__host__ __device__ constexpr int rows_a_thread() {
  return kWfr || D == 0 ? 1 : kRows;
}

// Columns an inner step takes: the LSE's running-max chunk. The general-d
// kernel takes one, so that one staged column of d up to 12,286 fits.
template <int D>
__host__ __device__ constexpr int chunk() {
  return D > 0 ? 8 : 1;
}

// Shared-memory row of one staged column: y'_j[0..d) = r y_j, then v_j or
// g'_j (sqeuclidean); y_j[0..d), ||y_j||^2, then v_j or g'_j (WFR). With d
// known at compile time the row is padded to a multiple of 4 floats, so it
// is read as float4s.
template <int D, bool kWfr>
__host__ __device__ constexpr int row_stride(int d) {
  return D > 0 ? (D + (kWfr ? 2 : 1) + 3) / 4 * 4 : d + (kWfr ? 2 : 1);
}

// 2^t by the exponential unit: one MUFU.EX2, flushing results below 2^-126
// to 0
__device__ __forceinline__ float ex2(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}

// The WFR pair's ground cost from its squared distance; false if blocked.
__device__ __forceinline__ bool wfr_cost(float sq, float two_eta, float* c) {
  const float z = sqrtf(sq + 1e-30f) / two_eta;
  if (z >= kHalfPi) return false;
  *c = -2.0f * logf(fmaxf(cosf(fminf(z, kHalfPi)), 1e-30f));
  return true;
}

// One thread's R rows: x'_i = r x_i (sqeuclidean) or x_i and ||x_i||^2
// (WFR), in registers when D > 0; read from memory when D == 0.
template <int D, bool kWfr>
struct Rows {
  static constexpr int R = rows_a_thread<D, kWfr>();
  float xr[R][D > 0 ? D : 1];
  const float* xi[D > 0 ? 1 : R];  // D == 0: the rows in memory
  float xx[R];
  unsigned live = 0;  // bit r: row r is one of the n rows

  __device__ __forceinline__ Rows(const float* x, int64_t first, int64_t n, int d,
                                  float r_scale) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int64_t i = first + static_cast<int64_t>(r) * kThreads;
      if (i < n) live |= 1u << r;
      else i = n - 1;  // a dead row computes on a live one's x and is not stored
      const float* row = x + i * (D > 0 ? D : d);
      xx[r] = 0.0f;
      if constexpr (D > 0) {
#pragma unroll
        for (int t = 0; t < D; ++t) {
          const float b = __ldg(row + t);
          xx[r] += b * b;
          xr[r][t] = kWfr ? b : r_scale * b;
        }
      } else {
        xi[r] = row;
        if constexpr (kWfr) {
          for (int t = 0; t < d; ++t) {
            const float b = __ldg(row + t);
            xx[r] += b * b;
          }
        }
      }
    }
  }

  // coordinate t of row r: x_it (WFR) or x'_it
  __device__ __forceinline__ float coord(int r, int t, float r_scale) const {
    if constexpr (D > 0) {
      return xr[r][t];
    } else {
      const float b = __ldg(xi[r] + t);
      return kWfr ? b : r_scale * b;
    }
  }

  // base + t with the pair's exponent in log2 units, t = -C / eps * log2(e)
  // <= 0, against the staged column `col`; false if WFR blocks the pair.
  __device__ __forceinline__ bool term(int r, const float* col, int d, float s, float r_scale,
                                       float two_eta, float base, float* t) const {
    const int dd = D > 0 ? D : d;
    if constexpr (kWfr) {
      float xy = 0.0f;
#pragma unroll
      for (int k = 0; k < dd; ++k) xy += coord(r, k, r_scale) * col[k];
      const float sq = fmaxf(xx[r] + col[dd] - 2.0f * xy, 0.0f);
      float c;
      if (!wfr_cost(sq, two_eta, &c)) return false;
      *t = fmaf(c, -s, base);
    } else {
      float acc = base;
#pragma unroll
      for (int k = 0; k < dd; ++k) {
        const float diff = coord(r, k, r_scale) - col[k];
        acc = fmaf(-diff, diff, acc);
      }
      *t = acc;
    }
    return true;
  }
};

// Stage columns [j0, j0 + tc) of y, then neutral columns up to tcp (a
// multiple of the chunk), as rows of row_stride<D, kWfr>(d) floats.
template <int D, bool kWfr, bool kLse>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ y,
                                      const float* __restrict__ w, int64_t j0, int tc, int tcp,
                                      int d, float s, float r_scale) {
  const int S = row_stride<D, kWfr>(d);
  const int dd = D > 0 ? D : d;
  const int wi = kWfr ? dd + 1 : dd;  // the weight's place
  for (int c = threadIdx.x; c < tcp; c += kThreads) {
    float* row = tile + c * S;
    if (c < tc) {
      const float* yj = y + (j0 + c) * dd;
      float yy = 0.0f;
      for (int t = 0; t < dd; ++t) {
        const float b = __ldg(yj + t);
        row[t] = kWfr ? b : r_scale * b;
        yy += b * b;
      }
      if (kWfr) row[dd] = yy;
      const float wj = __ldg(w + j0 + c);
      row[wi] = kLse ? fmaxf(s * wj, kNegInf) : wj;
    } else {
      for (int t = 0; t < wi; ++t) row[t] = 0.0f;
      row[wi] = kLse ? kNegInf : 0.0f;
    }
    for (int t = wi + 1; t < S; ++t) row[t] = 0.0f;
  }
}

// The staged column at `src` in registers (D > 0: float4 loads), or `src`
// itself (D == 0).
template <int D, bool kWfr>
struct Col {
  float r[D > 0 ? row_stride<D, kWfr>(0) : 1];
  const float* p;

  __device__ __forceinline__ Col(const float* src) : p(src) {
    if constexpr (D > 0) {
#pragma unroll
      for (int q = 0; q < row_stride<D, kWfr>(0) / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(src)[q];
        r[4 * q] = f.x;
        r[4 * q + 1] = f.y;
        r[4 * q + 2] = f.z;
        r[4 * q + 3] = f.w;
      }
    }
  }
  __device__ __forceinline__ const float* get() const {
    if constexpr (D > 0) return r;
    else return p;
  }
};

__device__ __forceinline__ float lse_result(float mx, float sum) {
  return mx > kNegInf ? kLn2 * (mx + log2f(sum)) : kNegInf;
}

// Grid (row groups of kThreads * R rows, P column slices). Slice p covers columns
// [p * slice_cols, min((p + 1) * slice_cols, m)); with P = 1 the result goes
// to out, else the partials to part: (P, n) sums (matvec) or (P, 2, n)
// (max, sum) pairs (LSE).
template <int D, bool kWfr, bool kLse>
__global__ void __launch_bounds__(kThreads)
    online_f32(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ w, int64_t n, int64_t m, int d, int tile_cols,
               int64_t slice_cols, float s, float r_scale, float two_eta,
               float* __restrict__ part, float* __restrict__ out) {
  constexpr int K = chunk<D>();
  constexpr int R = rows_a_thread<D, kWfr>();
  extern __shared__ __align__(16) float tile[];
  const int S = row_stride<D, kWfr>(d);
  const int wi = (D > 0 ? D : d) + (kWfr ? 1 : 0);  // the weight's place in a staged row
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * R) + threadIdx.x;
  const Rows<D, kWfr> rows(x, first, n, d, r_scale);
  const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * slice_cols;
  const int64_t j_end = m < j_begin + slice_cols ? m : j_begin + slice_cols;

  float acc[R];  // matvec: the sum; LSE: the rescaled sum S_i
  float mx[R];   // LSE: the running max m_i (log2 units)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.0f;
    mx[r] = kNegInf;  // every term is >= -1e30, so this is a safe start
  }
  for (int64_t j0 = j_begin; j0 < j_end; j0 += tile_cols) {
    const int tc = static_cast<int>(j_end - j0 < tile_cols ? j_end - j0 : tile_cols);
    const int tcp = (tc + K - 1) / K * K;
    __syncthreads();  // the previous tile has been read by every thread
    stage<D, kWfr, kLse>(tile, y, w, j0, tc, tcp, d, s, r_scale);
    __syncthreads();
    float tile_sum[R];  // matvec: this tile's sum, added to acc in order
#pragma unroll
    for (int r = 0; r < R; ++r) tile_sum[r] = 0.0f;
    for (int c0 = 0; c0 < tcp; c0 += K) {
      float z[kLse ? R : 1][kLse ? K : 1];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const Col<D, kWfr> col(tile + (c0 + q) * S);
        const float* cv = col.get();
        const float wq = cv[wi];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // the LSE's z = t + g'_j: the chain of t starts at g'_j
          float t;
          const bool live = rows.term(r, cv, d, s, r_scale, two_eta, kLse ? wq : 0.0f, &t);
          if constexpr (kLse) {
            z[r][q] = live ? t : kNegInf;
          } else {
            if (live) tile_sum[r] = fmaf(ex2(t), wq, tile_sum[r]);
          }
        }
      }
      if constexpr (kLse) {
        // the chunk's terms against the running max as it stands; only if
        // their sum passes kLazyMax is the max raised to the chunk's and the
        // chunk summed again
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float add = 0.0f;
#pragma unroll
          for (int q = 0; q < K; ++q) add += ex2(z[r][q] - mx[r]);
          if (add <= kLazyMax) {
            acc[r] += add;
          } else {
            float cmax = z[r][0];
#pragma unroll
            for (int q = 1; q < K; ++q) cmax = fmaxf(cmax, z[r][q]);
            const float nm = fmaxf(mx[r], cmax);
            add = 0.0f;
#pragma unroll
            for (int q = 0; q < K; ++q) add += ex2(z[r][q] - nm);
            acc[r] = fmaf(acc[r], ex2(mx[r] - nm), add);
            mx[r] = nm;
          }
        }
      }
    }
    if constexpr (!kLse) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += tile_sum[r];
    }
  }
  // the rows' places from `first` and the live bits (no 64-bit row index is
  // kept across the loop)
  const int64_t slice = blockIdx.y;
  float* const dst = gridDim.y == 1 ? out + first : part + (kLse ? 2 * slice : slice) * n + first;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!(rows.live >> r & 1u)) continue;
    if (gridDim.y == 1) {
      dst[r * kThreads] = kLse ? lse_result(mx[r], acc[r]) : acc[r];
    } else if constexpr (kLse) {
      dst[r * kThreads] = mx[r];
      dst[n + r * kThreads] = acc[r];
    } else {
      dst[r * kThreads] = acc[r];
    }
  }
}

// out_i from the P slices' partials of row i, in slice order.
template <bool kLse>
__global__ void __launch_bounds__(kCombineThreads)
    online_combine_f32(const float* __restrict__ part, int64_t n, int slices,
                       float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= n) return;
  if constexpr (kLse) {
    float mx = kNegInf;
    for (int p = 0; p < slices; ++p) mx = fmaxf(mx, part[2 * p * n + i]);
    float sum = 0.0f;
    for (int p = 0; p < slices; ++p)
      sum = fmaf(part[(2 * p + 1) * n + i], ex2(part[2 * p * n + i] - mx), sum);
    out[i] = lse_result(mx, sum);
  } else {
    float sum = 0.0f;
    for (int p = 0; p < slices; ++p) sum += part[p * n + i];
    out[i] = sum;
  }
}

// Column-tile width for points of dimension d: at most kMaxTileCols, within
// kSmemBytes of shared memory, a multiple of the chunk (0 if d is too large).
template <int D>
int tile_cols_for(int d, bool wfr) {
  const int stride = wfr ? row_stride<D, true>(d) : row_stride<D, false>(d);
  const int fit = kSmemBytes / (stride * static_cast<int>(sizeof(float)));
  const int tc = fit < kMaxTileCols ? fit : kMaxTileCols;
  return tc / chunk<D>() * chunk<D>();
}

template <int D>
size_t smem_for(int tc, int d, bool wfr) {
  const int stride = wfr ? row_stride<D, true>(d) : row_stride<D, false>(d);
  return static_cast<size_t>(tc) * stride * sizeof(float);
}

template <int D, bool kLse>
const void* kernel_for(bool wfr) {
  return wfr ? reinterpret_cast<const void*>(online_f32<D, true, kLse>)
             : reinterpret_cast<const void*>(online_f32<D, false, kLse>);
}

// P: enough (row group, slice) blocks for about kWaves full waves on this
// card (several waves even out the blocks' finishing times), at most
// kMaxSlices and at most one slice a column tile.
template <int D>
int slices_for(int64_t n, int64_t m, int d, bool wfr, bool lse) {
  const int tc = tile_cols_for<D>(d, wfr);
  if (tc < 1 || n <= 0 || m <= 0) return 1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lse ? kernel_for<D, true>(wfr) : kernel_for<D, false>(wfr), kThreads,
          smem_for<D>(tc, d, wfr)) != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch reports its own errors
    return 1;
  }
  const int64_t block_rows = kThreads * (wfr ? rows_a_thread<D, true>() : rows_a_thread<D, false>());
  const int64_t groups = (n + block_rows - 1) / block_rows;
  const int64_t tiles = (m + tc - 1) / tc;
  int64_t p = (kWaves * sms * per_sm + groups - 1) / groups;
  if (p > kMaxSlices) p = kMaxSlices;
  if (p > tiles) p = tiles;
  return p < 1 ? 1 : static_cast<int>(p);
}

template <int D, bool kLse>
cudaError_t launch(const float* x, const float* y, const float* w, int64_t n, int64_t m, int d,
                   float eps, int wfr, float eta, int slices, float* part, float* out,
                   cudaStream_t stream) {
  const int tc = tile_cols_for<D>(d, wfr != 0);
  if (tc < 1 || slices < 1 || slices > kMaxSlices || (slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_for<D>(tc, d, wfr != 0);
  const int64_t tiles = (m + tc - 1) / tc;
  const int64_t slice_cols = (tiles + slices - 1) / slices * tc;
  const int64_t block_rows = kThreads * (wfr ? rows_a_thread<D, true>() : rows_a_thread<D, false>());
  const dim3 grid(static_cast<unsigned int>((n + block_rows - 1) / block_rows),
                  static_cast<unsigned int>(slices));
  const float s = kLog2e / eps;
  const float r_scale = sqrtf(s);
  if (wfr)
    online_f32<D, true, kLse><<<grid, kThreads, smem, stream>>>(
        x, y, w, n, m, d, tc, slice_cols, s, r_scale, 2.0f * eta, part, out);
  else
    online_f32<D, false, kLse><<<grid, kThreads, smem, stream>>>(
        x, y, w, n, m, d, tc, slice_cols, s, r_scale, 2.0f * eta, part, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const unsigned int blocks = static_cast<unsigned int>((n + kCombineThreads - 1) / kCombineThreads);
  online_combine_f32<kLse><<<blocks, kCombineThreads, 0, stream>>>(part, n, slices, out);
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

template <int D>
cudaError_t launch_matvec(const float* x, const float* y, const float* v, int64_t n, int64_t m,
                          int d, float eps, int wfr, float eta, int slices, float* part,
                          float* out, cudaStream_t stream) {
  return launch<D, false>(x, y, v, n, m, d, eps, wfr, eta, slices, part, out, stream);
}

template <int D>
cudaError_t launch_lse(const float* x, const float* y, const float* g, int64_t n, int64_t m,
                       int d, float eps, int wfr, float eta, int slices, float* part, float* out,
                       cudaStream_t stream) {
  return launch<D, true>(x, y, g, n, m, d, eps, wfr, eta, slices, part, out, stream);
}

cudaError_t matvec(const float* x, const float* y, const float* v, int64_t n, int64_t m, int d,
                   float eps, int wfr, float eta, int slices, float* part, float* out,
                   cudaStream_t stream) {
  DISPATCH_D(launch_matvec, d, x, y, v, n, m, d, eps, wfr, eta, slices, part, out, stream)
}

cudaError_t lse(const float* x, const float* y, const float* g, int64_t n, int64_t m, int d,
                float eps, int wfr, float eta, int slices, float* part, float* out,
                cudaStream_t stream) {
  DISPATCH_D(launch_lse, d, x, y, g, n, m, d, eps, wfr, eta, slices, part, out, stream)
}

int slices(int64_t n, int64_t m, int d, int wfr, int lse) {
  DISPATCH_D(slices_for, d, n, m, d, wfr != 0, lse != 0)
}

}  // namespace

extern "C" {

// The column slices P that the launch functions below should be given for
// these sizes on the current device (1 to 16): about four waves of
// blocks. The caller allocates the scratch for them: P * n floats for the
// matvec, 2 * P * n for the LSE (none when P = 1).
int online_slices(int64_t n, int64_t m, int d, int wfr, int lse_kernel) {
  return slices(n, m, d, wfr, lse_kernel);
}

// Both launch on `stream`, allocate nothing, and return the launch's
// cudaError_t (0 = success). Pointers are device pointers: x is (n, d) and
// y is (m, d), contiguous float32; v or g is (m,) float32; out is (n,)
// float32; part is the scratch for `slices` column slices (see
// online_slices; may be null when slices = 1). With slices > 1 each makes
// two kernel launches, the slices and their combination. wfr selects the
// WFR cost (eta its range parameter) over the squared euclidean one. d
// above 12,286 (WFR) or 12,287 (squared euclidean) does not fit one staged
// column in shared memory and is refused (cudaErrorInvalidValue), as is a
// slice count outside 1..16.
int online_matvec_launch(const float* x, const float* y, const float* v, int64_t n, int64_t m,
                         int d, float eps, int wfr, float eta, int slices, float* part,
                         float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(matvec(x, y, v, n, m, d, eps, wfr, eta, slices, part, out,
                                 static_cast<cudaStream_t>(stream)));
}

int online_lse_launch(const float* x, const float* y, const float* g, int64_t n, int64_t m,
                      int d, float eps, int wfr, float eta, int slices, float* part, float* out,
                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(lse(x, y, g, n, m, d, eps, wfr, eta, slices, part, out,
                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
