// Gathered Gibbs-kernel evaluation for the matrix-free Spar-Sink sketch, and
// its float64 cost-only mode for the log-domain sketch.
//
// Replaces the TPU kernel src/repro/kernels/gather_kernel.py
// (gathered_kernel_call, the pallas_call at :68) together with the XLA
// gather and the padding of d to 128 lanes that its wrapper
// src/repro/kernels/ops.py::gathered_kernel does around it. The float64
// cost-only mode computes what the reference's log-domain sketch gathers
// with XLA outside Pallas (src/repro/core/geometry.py::gathered_cost, called
// from src/repro/core/api/geometry.py:318).
//
// For each of k index pairs e = (rows[e], cols[e]) it computes
//   sq  = ||x_i||^2 + ||y_j||^2 - 2 <x_i, y_j>, clamped at 0
//   C_e = sq                                      (sqeuclidean)
//   C_e = -2 log max(cos(min(z, pi/2)), floor),   z = sqrt(sq + 1e-30) / (2 eta)  (wfr)
//   K_e = exp(-C_e / eps)
// gathered_kernel_f32: (K_e, C_e) in float32 with floor 1e-30, WFR pairs with
// z >= pi/2 (d >= pi * eta) exactly K_e = 0, C_e = +inf (the formula of
// repro_torch/kernels/ref.py::gathered_kernel_ref). gathered_cost_f64: C_e
// alone in float64 with floor 1e-300 and blocked pairs exactly +inf (the
// formula of repro_torch/core/geometry.py::gathered_cost).
//
// What bounds it on an H100: bytes. A pair reads two int64 indices (16 B)
// and writes 8 B; the arithmetic (about 3d fused multiply-adds and one exp,
// plus sqrt/cos/log for wfr) is far below the card's rate. The points
// (n = 2^17, d = 5: 5 MB) stay in the 50 MB L2, but the sampler draws the
// columns at random, so every pair's y row is a random read, and those
// reads, not the streamed indices and outputs, set the time: with the
// columns sorted the same launch runs near the bytes bound (chip_smoke.py
// --compare-with prints both). The cost of a random read is L1 wavefronts:
// a warp load whose lanes hit w distinct sectors takes w of them. Per 32
// pairs on the y side:
//   * the first port, one lane a pair reading the 20-byte rows with d = 5
//     scalar loads: 5 loads x 32 sectors = 160 wavefronts;
//   * packed rows, one lane a pair: two 16-byte loads of one 32-byte
//     sector, 2 x 32 = 64;
//   * packed rows, two lanes a pair (gathered_kernel_f32_halves, 4 <= d <=
//     7): one warp load brings 16 whole rows, 2 x 16 = 32.
// So each call first packs both point sets (pack_rows, one short launch)
// into aligned rows of packed_stride(d) = round_up(d + 1, 4) values: the d
// coordinates, the squared norm (summed in the order the first port summed
// it, so the float32 sums keep their bits), zeros. The pack pays for
// itself: it reads the float32 or float64 points as they are, so it takes
// the place of the wrapper's cast launches, and it moves about 9 MB at
// n = 2^17, while it puts every float32 row of d <= 7 in one sector and
// spares each of the ~77 pairs that read a row its norm. Then:
//   * 4 pairs a lane pair (2 a thread in float64): the indices first, as
//     16-byte longlong2 loads, then every point load, so the chain index ->
//     point becomes 4 overlapping requests instead of 1;
//   * in the two-lane kernel lane 0 sums t = 0..3 and lane 1 holds the rest
//     of the row and both norms; each lane finishes two of the four pairs
//     (a few shuffles hand over the partial sums and the high halves), so
//     no lane idles through the exp;
//   * the outputs go out as vector stores, coalesced across the warp.
// The arithmetic of the float32 kernels is the first port's, instruction for
// instruction (a fused dot product summed in the order t = 0..d-1, the
// same clamp, cost and expf), so their outputs are bitwise the first port's.
// gathered_cost_f64 keeps one lane a pair: its row of d = 5 spans two
// sectors, and it rounds every product and sum apart (no fused
// multiply-add), as torch's float64 gathered_cost does; the order of its
// sums over d is the kernel's own.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;    // pairs a thread (a lane pair in the two-lane kernel), float32
constexpr int kPairs64 = 2;  // pairs a thread, float64 cost kernel

__host__ __device__ inline int packed_stride(int d) { return (d + 4) & ~3; }

__device__ inline float accumulate(float acc, float a, float b) {
  // one FFMA, as the first port summed; written out, because the compiler
  // fuses acc + a * b only where both sit in one basic block
  return __fmaf_rn(a, b, acc);
}

__device__ inline double accumulate(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));  // rounded apart, as torch's x * y then sum
}

__device__ inline void store_row8(float* dst, const float (&row)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(row[0], row[1], row[2], row[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(row[4], row[5], row[6], row[7]);
}

__device__ inline void store_row8(double* dst, const double (&row)[8]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) reinterpret_cast<double2*>(dst)[v] = make_double2(row[2 * v], row[2 * v + 1]);
}

// One thread a point row: rows [0, n) of x into px, rows [n, n + m) of y
// into py (m = 0 when y is x), each as the d coordinates in Out, their
// squared norm summed in order t = 0..d-1, and zeros up to the stride. A
// row of 8 (4 <= d <= 7, the main path's) is built in registers and
// stored as 16-byte vectors.
template <typename In, typename Out>
__global__ void pack_rows(const In* __restrict__ x, int64_t n, const In* __restrict__ y, int64_t m, int d,
                          Out* __restrict__ px, Out* __restrict__ py) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int stride = packed_stride(d);
  const In* src;
  Out* dst;
  if (r < n) {
    src = x + r * d;
    dst = px + r * stride;
  } else {
    r -= n;
    if (r >= m) return;
    src = y + r * d;
    dst = py + r * stride;
  }
  Out norm = Out(0);
  if (stride == 8) {
    Out row[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) row[t] = t < d ? static_cast<Out>(src[t]) : Out(0);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < d) norm = accumulate(norm, row[t], row[t]);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t == d) row[t] = norm;
    }
    store_row8(dst, row);
    return;
  }
  for (int t = 0; t < d; ++t) {
    const Out a = static_cast<Out>(src[t]);
    norm = accumulate(norm, a, a);
    dst[t] = a;
  }
  dst[d] = norm;
  for (int t = d + 1; t < stride; ++t) dst[t] = Out(0);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The pair indices e0 .. e0 + cnt - 1 of a thread, as two 16-byte loads a
// side where the thread has all kPairs of them (vec); their range check.
template <int P>
__device__ inline void load_pairs(const int64_t* __restrict__ rows, const int64_t* __restrict__ cols, int64_t e0,
                                  int cnt, bool vec, int64_t n, int64_t m, int64_t (&i)[P], int64_t (&j)[P],
                                  bool (&ok)[P]) {
  if (vec && cnt == P) {
#pragma unroll
    for (int q = 0; q < P; q += 2) {
      const longlong2 r = __ldg(reinterpret_cast<const longlong2*>(rows + e0 + q));
      const longlong2 c = __ldg(reinterpret_cast<const longlong2*>(cols + e0 + q));
      i[q] = r.x;
      i[q + 1] = r.y;
      j[q] = c.x;
      j[q + 1] = c.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      i[q] = q < cnt ? __ldg(rows + e0 + q) : 0;
      j[q] = q < cnt ? __ldg(cols + e0 + q) : 0;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) ok[q] = q < cnt && i[q] >= 0 && i[q] < n && j[q] >= 0 && j[q] < m;
}

// The first port's per-pair formula, unchanged.
__device__ inline void pair_f32(float xx, float yy, float xy, float eps, int wfr, float eta, float& kv, float& cv) {
  const float sq = fmaxf(xx + yy - 2.0f * xy, 0.0f);
  float c = sq;
  if (wfr) {
    const float half_pi = 1.57079632679489661923f;
    const float z = sqrtf(sq + 1e-30f) / (2.0f * eta);
    if (z >= half_pi) {
      kv = 0.0f;
      cv = INFINITY;
      return;
    }
    c = -2.0f * logf(fmaxf(cosf(fminf(z, half_pi)), 1e-30f));
  }
  kv = expf(-c / eps);
  cv = c;
}

// torch's float64 gathered_cost: (xx + yy) - 2 xy, clamped; WFR's -2 log
// max(cos(min(z, pi/2)), 1e-300) with z >= pi/2 blocked (+inf).
__device__ inline double pair_cost64(double xx, double yy, double xy, int wfr, double eta) {
  const double sq = fmax(__dsub_rn(__dadd_rn(xx, yy), __dmul_rn(2.0, xy)), 0.0);
  if (!wfr) return sq;
  const double half_pi = 1.5707963267948966;  // math.pi / 2.0
  const double z = sqrt(__dadd_rn(sq, 1e-30)) / (2.0 * eta);
  if (z >= half_pi) return INFINITY;
  return __dmul_rn(-2.0, log(fmax(cos(fmin(z, half_pi)), 1e-300)));
}

// The dot product of two packed rows summed in order t = 0..d-1, with each
// row's norm (at index d). D > 0: d = D known here, the rows held as V
// vectors loaded before; D = 0: any d, the rows read as they are summed.
template <int D, typename T, typename Vec, int V>
__device__ inline void row_terms(const Vec (&a)[V], const Vec (&b)[V], T& xx, T& yy, T& xy) {
  const T* ar = reinterpret_cast<const T*>(a);
  const T* br = reinterpret_cast<const T*>(b);
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < D; ++t) acc = accumulate(acc, ar[t], br[t]);
  xy = acc;
  xx = ar[D];
  yy = br[D];
}

template <typename T, typename Vec>
__device__ inline void row_terms_any(const Vec* __restrict__ a, const Vec* __restrict__ b, int d, T& xx, T& yy,
                                     T& xy) {
  constexpr int kLanes = sizeof(Vec) / sizeof(T);
  T acc = T(0);
  for (int v = 0; v * kLanes <= d; ++v) {
    const Vec av = __ldg(a + v), bv = __ldg(b + v);
    const T* ar = reinterpret_cast<const T*>(&av);
    const T* br = reinterpret_cast<const T*>(&bv);
#pragma unroll
    for (int c = 0; c < kLanes; ++c) {
      const int t = v * kLanes + c;
      if (t < d) {
        acc = accumulate(acc, ar[c], br[c]);
      } else if (t == d) {
        xx = ar[c];
        yy = br[c];
      }
    }
  }
  xy = acc;
}

// One lane a pair: d <= 3, where a packed row is one 16-byte load, and any
// d (D = 0) above 7.
template <int D>
__global__ void __launch_bounds__(kThreads)
    gathered_kernel_f32(const float4* __restrict__ px, const float4* __restrict__ py,
                        const int64_t* __restrict__ rows, const int64_t* __restrict__ cols, int64_t n, int64_t m,
                        int64_t k, int d, float eps, int wfr, float eta, float* __restrict__ k_out,
                        float* __restrict__ c_out, int* __restrict__ bad_index, int vec) {
  constexpr int V = D > 0 ? (D + 4) / 4 : 1;  // float4s that hold the coordinates and the norm
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kPairs;
  if (e0 >= k) return;
  const int cnt = k - e0 < kPairs ? static_cast<int>(k - e0) : kPairs;
  const int s4 = packed_stride(d) / 4;
  int64_t i[kPairs], j[kPairs];
  bool ok[kPairs];
  load_pairs<kPairs>(rows, cols, e0, cnt, vec, n, m, i, j, ok);
  float kv[kPairs], cv[kPairs];
  if constexpr (D > 0) {
    float4 a[kPairs][V], b[kPairs][V];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[q][v] = ok[q] ? __ldg(px + i[q] * s4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
        b[q][v] = ok[q] ? __ldg(py + j[q] * s4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      float xx, yy, xy;
      row_terms<D, float>(a[q], b[q], xx, yy, xy);
      pair_f32(xx, yy, xy, eps, wfr, eta, kv[q], cv[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      float xx = 0.f, yy = 0.f, xy = 0.f;
      if (ok[q]) row_terms_any<float>(px + i[q] * s4, py + j[q] * s4, d, xx, yy, xy);
      pair_f32(xx, yy, xy, eps, wfr, eta, kv[q], cv[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    if (q < cnt && !ok[q]) {
      // never read outside the points: leave NaN behind, and flag the
      // call where the caller asked for the flag (the wrapper raises)
      if (bad_index) *bad_index = 1;
      kv[q] = NAN;
      cv[q] = NAN;
    }
  }
  if (vec && cnt == kPairs) {
    *reinterpret_cast<float4*>(k_out + e0) = make_float4(kv[0], kv[1], kv[2], kv[3]);
    *reinterpret_cast<float4*>(c_out + e0) = make_float4(cv[0], cv[1], cv[2], cv[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (q < cnt) {
        k_out[e0 + q] = kv[q];
        c_out[e0 + q] = cv[q];
      }
    }
  }
}

__device__ inline float lane(const float4& v, int c) { return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w; }

// gathered_kernel_f32 for 4 <= D <= 7, where a packed row is two 16-byte
// halves of one 32-byte sector: two lanes a pair. Lane 2 s + h loads half h
// of both rows of its slot s's 4 consecutive pairs, so one warp load brings
// 16 whole y rows, one sector each. Both lanes load the slot's indices (one
// 16-byte load a side for two pairs). Lane 0 finishes pairs 0 and 1, lane 1
// pairs 2 and 3, side by side: lane 0 sums t = 0..3 of every pair, hands
// lane 1 those of pairs 2 and 3 and gets the high halves of pairs 0 and 1
// in return; each lane then sums t = 4..D-1 onto its pairs' sums, in the
// same order and with the same fused multiply-adds as one lane would, reads
// both norms, computes the values and stores its two pairs' outputs.
template <int D>
__global__ void __launch_bounds__(kThreads)
    gathered_kernel_f32_halves(const float4* __restrict__ px, const float4* __restrict__ py,
                               const int64_t* __restrict__ rows, const int64_t* __restrict__ cols, int64_t n,
                               int64_t m, int64_t k, float eps, int wfr, float eta, float* __restrict__ k_out,
                               float* __restrict__ c_out, int* __restrict__ bad_index, int vec) {
  static_assert(D >= 4 && D <= 7 && kPairs == 4, "two 16-byte halves a row, two pairs a lane");
  const int h = threadIdx.x & 1;
  const int64_t e0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 1) * kPairs;
  // no early return: every lane of the warp takes part in the shuffle
  const int cnt = e0 >= k ? 0 : k - e0 < kPairs ? static_cast<int>(k - e0) : kPairs;
  int64_t i[kPairs], j[kPairs];
  bool ok[kPairs];
  load_pairs<kPairs>(rows, cols, e0, cnt, vec, n, m, i, j, ok);
  float4 a[kPairs], b[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    a[q] = ok[q] ? __ldg(px + i[q] * 2 + h) : make_float4(0.f, 0.f, 0.f, 0.f);
    b[q] = ok[q] ? __ldg(py + j[q] * 2 + h) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // lane 0 finishes pairs 0 and 1, lane 1 pairs 2 and 3, side by side: for
  // r = 0, 1 lane 0 sums t = 0..3 of pairs r and 2 + r and hands the second
  // sum to lane 1, which hands lane 0 the high half of pair r
  constexpr unsigned kAll = 0xffffffffu;
  float kv[2], cv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p0 = r, p1 = 2 + r;
    float lo0 = 0.0f, lo1 = 0.0f;  // lane 1's are not the pair's: unused
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      lo0 = accumulate(lo0, lane(a[p0], t), lane(b[p0], t));
      lo1 = accumulate(lo1, lane(a[p1], t), lane(b[p1], t));
    }
    const float got = __shfl_xor_sync(kAll, h == 0 ? lo1 : lane(a[p0], 0), 1);
    float acc = h == 0 ? lo0 : got;
    float ha[4], hb[4];
    ha[0] = h == 0 ? got : lane(a[p1], 0);
#pragma unroll
    for (int c = 1; c <= D - 4; ++c) {
      const float g = __shfl_xor_sync(kAll, lane(a[p0], c), 1);
      ha[c] = h == 0 ? g : lane(a[p1], c);
    }
#pragma unroll
    for (int c = 0; c <= D - 4; ++c) {
      const float g = __shfl_xor_sync(kAll, lane(b[p0], c), 1);
      hb[c] = h == 0 ? g : lane(b[p1], c);
    }
#pragma unroll
    for (int t = 4; t < D; ++t) acc = accumulate(acc, ha[t - 4], hb[t - 4]);
    pair_f32(ha[D - 4], hb[D - 4], acc, eps, wfr, eta, kv[r], cv[r]);
    const int q = h == 0 ? p0 : p1;
    if (q < cnt && !(h == 0 ? ok[p0] : ok[p1])) {
      if (bad_index) *bad_index = 1;
      kv[r] = NAN;
      cv[r] = NAN;
    }
  }
  const int64_t e = e0 + 2 * h;  // this lane's two pairs
  const int mine = cnt - 2 * h;
  if (vec && mine >= 2) {
    *reinterpret_cast<float2*>(k_out + e) = make_float2(kv[0], kv[1]);
    *reinterpret_cast<float2*>(c_out + e) = make_float2(cv[0], cv[1]);
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q < mine) {
        k_out[e + q] = kv[q];
        c_out[e + q] = cv[q];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    gathered_cost_f64(const double2* __restrict__ px, const double2* __restrict__ py,
                      const int64_t* __restrict__ rows, const int64_t* __restrict__ cols, int64_t n, int64_t m,
                      int64_t k, int d, int wfr, double eta, double* __restrict__ c_out, int* __restrict__ bad_index,
                      int vec) {
  constexpr int V = D > 0 ? (D + 2) / 2 : 1;  // double2s that hold the coordinates and the norm
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kPairs64;
  if (e0 >= k) return;
  const int cnt = k - e0 < kPairs64 ? static_cast<int>(k - e0) : kPairs64;
  const int s2 = packed_stride(d) / 2;
  int64_t i[kPairs64], j[kPairs64];
  bool ok[kPairs64];
  load_pairs<kPairs64>(rows, cols, e0, cnt, vec, n, m, i, j, ok);
  double cv[kPairs64];
  if constexpr (D > 0) {
    double2 a[kPairs64][V], b[kPairs64][V];
#pragma unroll
    for (int q = 0; q < kPairs64; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[q][v] = ok[q] ? __ldg(px + i[q] * s2 + v) : make_double2(0.0, 0.0);
        b[q][v] = ok[q] ? __ldg(py + j[q] * s2 + v) : make_double2(0.0, 0.0);
      }
    }
#pragma unroll
    for (int q = 0; q < kPairs64; ++q) {
      double xx, yy, xy;
      row_terms<D, double>(a[q], b[q], xx, yy, xy);
      cv[q] = pair_cost64(xx, yy, xy, wfr, eta);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPairs64; ++q) {
      double xx = 0.0, yy = 0.0, xy = 0.0;
      if (ok[q]) row_terms_any<double>(px + i[q] * s2, py + j[q] * s2, d, xx, yy, xy);
      cv[q] = pair_cost64(xx, yy, xy, wfr, eta);
    }
  }
#pragma unroll
  for (int q = 0; q < kPairs64; ++q) {
    if (q < cnt && !ok[q]) {
      if (bad_index) *bad_index = 1;
      cv[q] = NAN;
    }
  }
  if (vec && cnt == kPairs64) {
    *reinterpret_cast<double2*>(c_out + e0) = make_double2(cv[0], cv[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kPairs64; ++q) {
      if (q < cnt) c_out[e0 + q] = cv[q];
    }
  }
}

// Packs x (and y, unless y is x) into `packed` on `stream`; returns the
// launch's error. py is where y's rows start.
template <typename Out>
int pack(const void* x, const void* y, int points_f64, int64_t n, int64_t m, int d, Out* packed, Out** py,
         cudaStream_t stream) {
  const bool shared = x == y && n == m;
  *py = shared ? packed : packed + n * packed_stride(d);
  const int64_t rows = n + (shared ? 0 : m);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  if (points_f64) {
    pack_rows<double, Out><<<blocks, kThreads, 0, stream>>>(static_cast<const double*>(x), n,
                                                            static_cast<const double*>(y), shared ? 0 : m, d,
                                                            packed, *py);
  } else {
    pack_rows<float, Out><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(x), n,
                                                           static_cast<const float*>(y), shared ? 0 : m, d,
                                                           packed, *py);
  }
  return static_cast<int>(cudaGetLastError());
}

unsigned blocks_for(int64_t k, int pairs) {
  return static_cast<unsigned>(((k + pairs - 1) / pairs + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Values in one packed point row (float32 or float64): d coordinates and
// the squared norm, rounded up to a multiple of 4.
int gathered_packed_stride(int d) { return packed_stride(d); }

// Launches the pack and the kernel on `stream` and returns the first
// cudaError_t (0 = success). Pointers are device pointers; x is (n, d) and
// y is (m, d), contiguous, both float64 if points_f64 else both float32 (y
// may be x); rows/cols are (k,) int64; packed holds
// gathered_packed_stride(d) floats for each row of x and, unless y is x, of
// y; k_out/c_out are (k,) float32. bad_index is one int32 that the caller
// zeroed, which the kernel sets to 1 if any rows[e] lies outside [0, n) or
// cols[e] outside [0, m), or null: an index out of range is then not
// flagged. Either way such a pair reads no point and comes out NaN.
int gathered_kernel_launch(const void* x, const void* y, int points_f64, const int64_t* rows, const int64_t* cols,
                           int64_t n, int64_t m, int64_t k, int d, float eps, int wfr, float eta, float* packed,
                           float* k_out, float* c_out, int* bad_index, void* stream) {
  if (k <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  float* py = nullptr;
  const int err = pack(x, y, points_f64, n, m, d, packed, &py, s);
  if (err != 0) return err;
  const auto* px4 = reinterpret_cast<const float4*>(packed);
  const auto* py4 = reinterpret_cast<const float4*>(py);
  const int vec = aligned16(rows) && aligned16(cols) && aligned16(k_out) && aligned16(c_out);
  const unsigned blocks = blocks_for(k, kPairs);
  const unsigned blocks2 = static_cast<unsigned>((2 * ((k + kPairs - 1) / kPairs) + kThreads - 1) / kThreads);
#define GATHERED_HALVES(D)                                                                                    \
  gathered_kernel_f32_halves<D><<<blocks2, kThreads, 0, s>>>(px4, py4, rows, cols, n, m, k, eps, wfr, eta, k_out, \
                                                             c_out, bad_index, vec)
#define GATHERED_KERNEL(D)                                                                                      \
  gathered_kernel_f32<D><<<blocks, kThreads, 0, s>>>(px4, py4, rows, cols, n, m, k, d, eps, wfr, eta, k_out, c_out, \
                                                     bad_index, vec)
  switch (d) {
    case 1: GATHERED_KERNEL(1); break;
    case 2: GATHERED_KERNEL(2); break;
    case 3: GATHERED_KERNEL(3); break;
    case 4: GATHERED_HALVES(4); break;
    case 5: GATHERED_HALVES(5); break;
    case 6: GATHERED_HALVES(6); break;
    case 7: GATHERED_HALVES(7); break;
    default: GATHERED_KERNEL(0); break;
  }
#undef GATHERED_HALVES
#undef GATHERED_KERNEL
  return static_cast<int>(cudaGetLastError());
}

// The float64 cost-only mode: as gathered_kernel_launch, but packed holds
// gathered_packed_stride(d) doubles a row, the outputs are C_e alone in
// float64 (c_out, (k,)), and eta is a double.
int gathered_cost_launch(const void* x, const void* y, int points_f64, const int64_t* rows, const int64_t* cols,
                         int64_t n, int64_t m, int64_t k, int d, int wfr, double eta, double* packed, double* c_out,
                         int* bad_index, void* stream) {
  if (k <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  double* py = nullptr;
  const int err = pack(x, y, points_f64, n, m, d, packed, &py, s);
  if (err != 0) return err;
  const auto* px2 = reinterpret_cast<const double2*>(packed);
  const auto* py2 = reinterpret_cast<const double2*>(py);
  const int vec = aligned16(rows) && aligned16(cols) && aligned16(c_out);
  const unsigned blocks = blocks_for(k, kPairs64);
#define GATHERED_COST(D) \
  gathered_cost_f64<D><<<blocks, kThreads, 0, s>>>(px2, py2, rows, cols, n, m, k, d, wfr, eta, c_out, bad_index, vec)
  switch (d) {
    case 1: GATHERED_COST(1); break;
    case 2: GATHERED_COST(2); break;
    case 3: GATHERED_COST(3); break;
    case 4: GATHERED_COST(4); break;
    case 5: GATHERED_COST(5); break;
    case 6: GATHERED_COST(6); break;
    case 7: GATHERED_COST(7); break;
    default: GATHERED_COST(0); break;
  }
#undef GATHERED_COST
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
