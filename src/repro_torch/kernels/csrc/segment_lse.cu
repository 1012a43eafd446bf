// Gathered segment logsumexp over sorted segments: the half-step of the
// log-domain sparse Sinkhorn loop (repro_torch/batch/solvers.py::
// sparse_log_potentials, through repro_torch/kernels/ops.py::
// bind_coo_gather_logsumexp).
//
// Replaces no TPU kernel. The JAX package leaves these segment reductions to
// XLA (src/repro/core/sparsify.py::segment_logsumexp under jit), and the port
// first ran them as a chain of PyTorch operations: a gather and an add, a
// segment max, repeat_interleave of the max back to every entry, a subtract,
// exp and a mask, a segment sum. That chain wrote and read some ten
// full-length float64 arrays a half-step and held the loop at 4 % of its
// byte bound at n = 2^17 (PERF.md): the measured cost that ROADMAP D-3 asked
// for before a hand-written kernel.
//
// For each flat segment s of B * n (element b = s / n) and its entries e in
// [offsets[s], offsets[s + 1]) of the (B, cap) arrays, in segment order:
//   z_e    = vals[e] + y[b, idx[e]] / eps[b]
//   out[s] = log sum_e exp(z_e) = mx + log sum_e exp(z_e - mx),  mx = max_e z_e
// with the plain chain's semantics: a -inf entry adds exactly 0 (no
// -inf - -inf), an empty or all -inf segment gives exactly -inf, a NaN
// anywhere in a segment gives NaN. Everything is float64, each operation
// rounded apart (no fused multiply-add); the quotient y / eps is taken at
// the gathered entry, the same quotient as the plain (y / eps).gather(...).
//
// What bounds it on an H100: bytes. An entry reads its value and its index
// once (16 B, as perfbench/roofline/loop.py counts them); a segment reads
// two offsets and writes one value. The potentials y (1 MB at n = 2^17)
// stay in the 50 MB L2, so the random gathers hit L2 and not device memory.
// The design:
//   * one warp a segment, 256 threads a block;
//   * two passes over a segment: the max, lane-strided with the loads issued
//     two deep, then the sum of exp(z - max). The first 512 entries' z stay
//     in shared memory between the two, so each of those reads its value,
//     index and gathered potential once: every segment of the n = 2^17 cell
//     but the padding's (77 entries on average, 510 in the heaviest row).
//     The sum recomputes, two deep, the z of the entries past 512 (the
//     heavier rows of the served n = 2048 buckets: a mean of about 400, and
//     up to about 1200), mostly from L1 and L2;
//   * the sum in one fixed order that depends on the segment's entries
//     alone: chunks of 1024 entries in turn, lane v of a chunk adding
//     entries v, v + 32, v + 64, ... in turn, then a fixed shuffle tree
//     (v += v + 16, then v + 8, ..., v + 1). So an element of a batch gets
//     bitwise the output of its B = 1 launch, whatever its slot alignment.
//     No atomics, and no segment is split across blocks;
//   * a segment longer than 2048 entries (an element's last row or column,
//     where the sketch parks its padding among that atom's own entries:
//     66,676 entries at n = 2^17, 0.2-0.5 M in a served bucket) is left by
//     its warp to the whole block once the warps are done. The block takes
//     it in one pass, four loads deep a thread: each thread a running max
//     and a sum of exp(z - max) rescaled when the max rises, over entries
//     t, t + 256, ... in turn, then a fixed tree. The blocks that hold each
//     element's last segment run first, so those segments overlap the rest
//     of the launch. (Eight loads deep, or a branch that skipped the
//     division for -inf values, ran slower on an H100.)
// Measured on an H100 (PERF.md, section 6): at n = 2^17 0.17 ms a half-step
// against the 0.049 ms bound; the same launch with every segment empty
// takes 0.050 ms, so each segment's chain of dependent loads (offsets, then
// values and ids, then potentials) sets the time, not the bytes. In a served
// bucket (B = 16) 0.44-0.52 ms against 0.09, set by the one block that
// walks each element's longest segment.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;       // entries a chunk of a warp's sum order: 32 a lane
constexpr int kWarpLoads = 2;      // entries a lane loads at once in a warp's max pass
constexpr int kTailLoads = 2;      // the same in its sum over the entries past the staged ones
constexpr int kBlockLoads = 4;     // the same in the block's single pass
constexpr int kLong = 2 * kChunk;  // a segment over kLong entries goes to the block
constexpr int kStage = 512;        // entries of z a warp keeps in shared memory between the passes
constexpr int kMinBlocks = 4;      // blocks an SM holds at once (bounds the registers a thread)
constexpr double kNegInf = -INFINITY;

// The larger of m and z, keeping a NaN: once m is NaN no z replaces it.
__device__ inline double max_nan(double m, double z) { return (z > m || z != z) ? z : m; }

__device__ inline double entry(double v, double yv, double eb) { return __dadd_rn(v, __ddiv_rn(yv, eb)); }

// exp(z - mx), exactly 0 for a -inf entry.
__device__ inline double term(double z, double mx) { return z == kNegInf ? 0.0 : exp(__dsub_rn(z, mx)); }

__device__ inline double warp_max(double mx) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return mx;
}

// The fixed tree: lane 0's return is the warp's sum, in the same order
// whatever the warp.
__device__ inline double warp_sum(double acc) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  return acc;
}

__device__ inline double result(double mx, double total) {
  return mx == kNegInf ? mx : __dadd_rn(mx, log(total));
}

// The block's single pass keeps, a thread, the running max m of its z and
// the sum s of exp(z - m), rescaled when m rises; m = NaN once a z is NaN
// or +inf (the plain chain's exp(z - max) is then NaN too).
__device__ inline void online_add(double& m, double& s, double z) {
  if (z == kNegInf || m != m) return;
  if (!(z < INFINITY)) {
    m = NAN;
  } else if (z > m) {
    s = m == kNegInf ? 1.0 : __dadd_rn(__dmul_rn(s, exp(__dsub_rn(m, z))), 1.0);
    m = z;
  } else {
    s = __dadd_rn(s, exp(__dsub_rn(z, m)));
  }
}

__device__ inline void online_merge(double& m, double& s, double m2, double s2) {
  if (m != m || m2 == kNegInf) return;
  if (m2 != m2 || m == kNegInf) {
    m = m2;
    s = s2;
    return;
  }
  const double mx = m2 > m ? m2 : m;
  s = __dadd_rn(__dmul_rn(s, exp(__dsub_rn(m, mx))), __dmul_rn(s2, exp(__dsub_rn(m2, mx))));
  m = mx;
}

// One long segment by the whole block, in one pass: thread t takes entries
// t, t + 256, ... in turn, then a fixed tree over the warp and the warps'
// states in turn. Every thread calls it.
__device__ void block_segment(const int64_t* __restrict__ offsets, const double* __restrict__ vals,
                              const int64_t* __restrict__ idx, const double* __restrict__ y,
                              const double* __restrict__ eps, int64_t per_elem, int64_t n_other, int64_t seg,
                              double* __restrict__ out, double* part_m, double* part_s) {
  const int64_t start = offsets[seg], end = offsets[seg + 1];
  const int64_t b = seg / per_elem;
  const double* yb = y + b * n_other;
  const double eb = eps[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double m = kNegInf, s = 0.0;
  for (int64_t e0 = start + threadIdx.x; e0 < end; e0 += static_cast<int64_t>(kThreads) * kBlockLoads) {
    double v[kBlockLoads];
    int j[kBlockLoads];
#pragma unroll
    for (int u = 0; u < kBlockLoads; ++u) {
      const int64_t e = e0 + static_cast<int64_t>(u) * kThreads;
      if (e < end) {
        v[u] = vals[e];
        j[u] = static_cast<int>(idx[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBlockLoads; ++u) {
      if (e0 + static_cast<int64_t>(u) * kThreads < end) online_add(m, s, entry(v[u], yb[j[u]], eb));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    const double m2 = __shfl_down_sync(0xffffffffu, m, o), s2 = __shfl_down_sync(0xffffffffu, s, o);
    online_merge(m, s, m2, s2);
  }
  __syncthreads();  // the parts are free: the previous segment's last read is done
  if (lane == 0) {
    part_m[warp] = m;
    part_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) online_merge(m, s, part_m[w], part_s[w]);
    out[seg] = m != m ? m : result(m, s);
  }
}

// The block that the launch's block i takes: first the blocks that hold
// each element's last segment (the padding's), the last element's first,
// so that those long segments start early; then the others in turn. With
// fewer segments an element than a block has warps, the blocks from the
// last.
__device__ inline int64_t block_of(int64_t i, int64_t blocks, int64_t bsz, int64_t per_elem) {
  if (per_elem < kWarps) return blocks - 1 - i;
  if (i < bsz) return ((bsz - i) * per_elem - 1) / kWarps;
  int64_t k = i - bsz;  // the (i - bsz)-th block that holds no element's last segment
  for (int64_t b = 0; b < bsz; ++b) {
    if (((b + 1) * per_elem - 1) / kWarps <= k) ++k;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    segment_lse_kernel(const int64_t* __restrict__ offsets, const double* __restrict__ vals,
                       const int64_t* __restrict__ idx, const double* __restrict__ y,
                       const double* __restrict__ eps, int64_t segments, int64_t per_elem, int64_t n_other,
                       double* __restrict__ out) {
  __shared__ bool deferred[kWarps];
  __shared__ double part_m[kWarps], part_s[kWarps];
  __shared__ double stage[kWarps * kStage];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t first = block_of(blockIdx.x, gridDim.x, segments / per_elem, per_elem) * kWarps;
  const int64_t seg = first + warp;
  const bool mine = seg < segments;
  int64_t start = 0, end = 0;
  if (mine) {
    start = offsets[seg];
    end = offsets[seg + 1];
  }
  const bool is_long = end - start > kLong;
  // a warp's segment is at most kLong entries, so offsets within it and
  // the gathered ids (n_other < 2^31) fit 32 bits
  const int len = is_long ? 0 : static_cast<int>(end - start);
  const double* vs = vals + start;
  const int64_t* is = idx + start;
  const double* yb = y + (mine ? seg / per_elem : 0) * n_other;
  const double eb = eps[mine ? seg / per_elem : 0];
  double* zs = stage + warp * kStage;
  double mx = kNegInf;
  for (int i0 = lane; i0 < len; i0 += 32 * kWarpLoads) {
    double v[kWarpLoads];
    int j[kWarpLoads];
#pragma unroll
    for (int u = 0; u < kWarpLoads; ++u) {
      if (i0 + u * 32 < len) {
        v[u] = vs[i0 + u * 32];
        j[u] = static_cast<int>(is[i0 + u * 32]);
      }
    }
#pragma unroll
    for (int u = 0; u < kWarpLoads; ++u) {
      const int i = i0 + u * 32;
      if (i < len) {
        const double z = entry(v[u], yb[j[u]], eb);
        if (i < kStage) zs[i] = z;
        mx = max_nan(mx, z);
      }
    }
  }
  mx = warp_max(mx);
  __syncwarp();  // the staged z, written by each lane, seen by all
  double total = 0.0;
  if (mx != kNegInf) {  // one branch for the whole warp
    for (int c = 0; c < len; c += kChunk) {
      const int ce = c + kChunk < len ? c + kChunk : len;
      const int staged = ce < kStage ? ce : kStage;
      double acc = 0.0;
      int i = c + lane;
      for (; i < staged; i += 32) acc = __dadd_rn(acc, term(zs[i], mx));
      // the entries past the staged ones, recomputed, in the same order
      for (; i < ce; i += 32 * kTailLoads) {
        double v[kTailLoads], yv[kTailLoads];
        int j[kTailLoads];
#pragma unroll
        for (int u = 0; u < kTailLoads; ++u) {
          if (i + u * 32 < ce) {
            v[u] = vs[i + u * 32];
            j[u] = static_cast<int>(is[i + u * 32]);
          }
        }
#pragma unroll
        for (int u = 0; u < kTailLoads; ++u) {
          if (i + u * 32 < ce) yv[u] = yb[j[u]];
        }
#pragma unroll
        for (int u = 0; u < kTailLoads; ++u) {
          if (i + u * 32 < ce) acc = __dadd_rn(acc, term(entry(v[u], yv[u], eb), mx));
        }
      }
      total = __dadd_rn(total, warp_sum(acc));
    }
  }
  if (lane == 0) {
    if (mine && !is_long) out[seg] = result(mx, total);
    deferred[warp] = is_long;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (deferred[w]) block_segment(offsets, vals, idx, y, eps, per_elem, n_other, first + w, out, part_m, part_s);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns its cudaError_t (0 =
// success). Pointers are device pointers, every array contiguous and
// float64 but the int64 offsets and ids: offsets (segments + 1,),
// non-decreasing, into the flat (B, cap) vals and idx (each id in
// [0, n_other): not checked, and n_other < 2^31); y (B, n_other), eps (B,),
// out (segments,). Element b owns segments [b * per_elem, (b + 1) *
// per_elem) and row b of y.
int segment_lse_launch(const int64_t* offsets, const double* vals, const int64_t* idx, const double* y,
                       const double* eps, int64_t segments, int64_t per_elem, int64_t n_other, double* out,
                       void* stream) {
  if (segments <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (segments + kWarps - 1) / kWarps;
  segment_lse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, vals, idx, y, eps, segments, per_elem, n_other, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
