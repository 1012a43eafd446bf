// Block-ELL sketch mat-vec for the tile-granular Spar-Sink solver.
//
// Replaces the TPU kernel src/repro/kernels/block_ell.py
// (block_ell_matvec_call, the pallas_call at :58), together with the batch
// folding of its wrapper src/repro/kernels/ops.py::batched_block_ell_matvec:
//
//   out[r*Bk + i] = sum_e sum_k sum_j vals[e, k, i, j] * v[(b(r) * ncb + col_idx[e, k]) * Bk + j]
//
// over the ELL rows e of output row-block r, the slots k of max_blocks and
// the tile rows i and columns j of Bk. Row-block r is the ELL rows
// row_ptr[r]..row_ptr[r+1]-1, or ELL row r alone when row_ptr is null (the
// reference's layout, and the only one the Pallas kernel takes): the
// sketch's transposed layout gives a column-block that many row-blocks
// share several ELL rows instead of padding every row to the widest.
// b(r) = r / row_blocks_per_sketch is the sketch that row-block r belongs to
// when B sketches are folded into the row-block axis (b = 0 for one
// sketch), and ncb is a sketch's number of column blocks. Padded slots hold
// zero tiles with column id 0 and are summed like the others. A column id
// outside [0, ncb), or a row_ptr range outside [0, ell_rows), sets
// *bad_index and gives NaN; nothing is read out of bounds. This is the
// function of the plain version repro_torch/kernels/ref.py::block_ell_matvec_ref.
//
// K~^T u is the same kernel on the sketch's transposed layout, so no output
// is ever scattered to. Each output row is summed by one warp in one fixed
// order: lane l sums its tile columns j = l, l + 32, ... (Bk = 128: the four
// columns 4l..4l+3, loaded as one float4) in order, a fixed shuffle tree
// adds the 32 lane sums, and the tile sums are added to the row's running
// sum in slot order, as the Pallas kernel accumulates into o_ref. No
// atomics: two launches on the same inputs are bitwise equal.
//
// What bounds it on an H100: bytes. Each launch reads every tile once,
// ell_rows * max_blocks * Bk^2 * 4 bytes (29.4 MB for the n = 8192,
// Bk = 128, max_blocks = 7 row layout), and does 2 float32 operations per
// tile element. The design follows: a tile row is contiguous, so a warp's
// loads of one row coalesce (512 B at Bk = 128), each lane keeps the loads
// of 4 slots of its warp's 2 rows in flight, and the v blocks of the
// row-block's slots are staged once in shared memory (up to 32 KB, more
// slots in passes) and read by all 16 rows of the block. A block covers 16
// tile rows of one row-block, so Bk = 128 gives 8 blocks per row-block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // tile rows of one block
constexpr int kStageFloats = 8192;                    // 32 KB of staged v blocks
constexpr int kSlotsInFlight = 4;                     // Bk = 128: slots loaded at once

// The sum of x over the warp by a fixed butterfly: every lane ends with the
// same value, from the same additions on every launch.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Stage the v blocks of slots [slot0, slot0 + kn), kn x bk floats, checking
// each column id.
__device__ __forceinline__ void stage_v(const int32_t* __restrict__ col_idx,
                                        const float* __restrict__ v, int64_t slot0, int kn,
                                        int bk, int64_t ncb, int64_t v_block0, float* vs,
                                        int* __restrict__ bad_index) {
  for (int t = threadIdx.x; t < kn * bk; t += kThreads) {
    const int s = t / bk;
    const int j = t - s * bk;
    const int64_t c = col_idx[slot0 + s];
    if (c < 0 || c >= ncb) {
      if (j == 0) *bad_index = 1;
      vs[t] = NAN;
    } else {
      vs[t] = v[(v_block0 + c) * bk + j];
    }
  }
}

// The slots [*first, *first + *count) of output row-block r; false (and the
// flag set) for a row_ptr range outside [0, ell_rows).
__device__ __forceinline__ bool row_slots(const int32_t* __restrict__ row_ptr, int64_t r,
                                          int64_t ell_rows, int64_t max_blocks, int64_t* first,
                                          int64_t* count, int* __restrict__ bad_index) {
  const int64_t e0 = row_ptr ? row_ptr[r] : r;
  const int64_t e1 = row_ptr ? row_ptr[r + 1] : r + 1;
  if (e0 < 0 || e1 < e0 || e1 > ell_rows) {
    if (threadIdx.x == 0) *bad_index = 1;
    return false;
  }
  *first = e0 * max_blocks;
  *count = (e1 - e0) * max_blocks;
  return true;
}

// Any Bk: lane l sums the tile columns l, l + 32, ... of a row.
__global__ void __launch_bounds__(kThreads)
    block_ell_any(const float* __restrict__ vals, const int32_t* __restrict__ col_idx,
                  const float* __restrict__ v, const int32_t* __restrict__ row_ptr,
                  int64_t ell_rows, int64_t max_blocks, int bk, int64_t ncb,
                  int64_t row_blocks_per_sketch, int stage, float* __restrict__ out,
                  int* __restrict__ bad_index) {
  extern __shared__ float4 stage_smem[];
  float* vs = reinterpret_cast<float*>(stage_smem);
  const int64_t r = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kRowsPerBlock + warp;
  const int64_t v_block0 = (r / row_blocks_per_sketch) * ncb;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;
  int64_t first = 0, count = 0;
  if (!row_slots(row_ptr, r, ell_rows, max_blocks, &first, &count, bad_index)) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = NAN;
  }
  for (int64_t k0 = 0; k0 < count; k0 += stage) {
    const int kn = static_cast<int>(count - k0 < stage ? count - k0 : stage);
    __syncthreads();  // the previous pass's v blocks are consumed
    stage_v(col_idx, v, first + k0, kn, bk, ncb, v_block0, vs, bad_index);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int i = row0 + kWarps * q;
      if (i >= bk) continue;  // the same for the whole warp
      for (int s = 0; s < kn; ++s) {
        const float* tile_row = vals + ((first + k0 + s) * bk + i) * static_cast<int64_t>(bk);
        const float* vrow = vs + s * bk;
        float p = 0.0f;
        for (int j = lane; j < bk; j += 32) p = fmaf(__ldg(tile_row + j), vrow[j], p);
        acc[q] += warp_sum(p);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int i = row0 + kWarps * q;
    if (i < bk && lane == 0) out[r * bk + i] = acc[q];
  }
}

// Bk = 128, the solver's default: lane l sums the columns 4l..4l+3 of a row
// from one float4, and the loads of kSlotsInFlight slots of both of the
// warp's rows are issued before any of their sums.
__global__ void __launch_bounds__(kThreads)
    block_ell_bk128(const float* __restrict__ vals, const int32_t* __restrict__ col_idx,
                    const float* __restrict__ v, const int32_t* __restrict__ row_ptr,
                    int64_t ell_rows, int64_t max_blocks, int64_t ncb,
                    int64_t row_blocks_per_sketch, int stage, float* __restrict__ out,
                    int* __restrict__ bad_index) {
  constexpr int kBk = 128;
  extern __shared__ float4 stage_smem[];
  const int64_t r = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kRowsPerBlock + warp;
  const int64_t v_block0 = (r / row_blocks_per_sketch) * ncb;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;
  int64_t first = 0, count = 0;
  if (!row_slots(row_ptr, r, ell_rows, max_blocks, &first, &count, bad_index)) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = NAN;
  }
  for (int64_t k0 = 0; k0 < count; k0 += stage) {
    const int kn = static_cast<int>(count - k0 < stage ? count - k0 : stage);
    __syncthreads();
    stage_v(col_idx, v, first + k0, kn, kBk, ncb, v_block0,
            reinterpret_cast<float*>(stage_smem), bad_index);
    __syncthreads();
    for (int s = 0; s < kn; s += kSlotsInFlight) {
      float4 t[kRowsPerWarp][kSlotsInFlight];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int i = row0 + kWarps * q;
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          if (s + u < kn) {
            const float4* tile_row = reinterpret_cast<const float4*>(
                vals + ((first + k0 + s + u) * kBk + i) * kBk);
            t[q][u] = __ldg(tile_row + lane);
          } else {
            t[q][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
        for (int u = 0; u < kSlotsInFlight; ++u) {
          if (s + u < kn) {  // the same for the whole block
            const float4 w = stage_smem[(s + u) * (kBk / 4) + lane];
            float p = t[q][u].x * w.x;
            p = fmaf(t[q][u].y, w.y, p);
            p = fmaf(t[q][u].z, w.z, p);
            p = fmaf(t[q][u].w, w.w, p);
            acc[q] += warp_sum(p);
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) out[r * kBk + row0 + kWarps * q] = acc[q];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 = success). Pointers are device pointers: vals is
// (ell_rows, max_blocks, bk, bk) contiguous float32, col_idx is
// (ell_rows, max_blocks) int32, row_ptr is null or (row_blocks + 1,) int32,
// v holds col_blocks * bk float32 values for each sketch (row_blocks /
// row_blocks_per_sketch of them), out is (row_blocks * bk,) float32, and
// bad_index is one int32 that the caller zeroed: the kernel sets it to 1 if
// a column id lies outside [0, col_blocks) or a row_ptr range outside
// [0, ell_rows). bk above 8192 (one v block beyond the 32 KB stage) is
// refused with cudaErrorInvalidValue.
int block_ell_matvec_launch(const float* vals, const int32_t* col_idx, const float* v,
                            const int32_t* row_ptr, int64_t row_blocks, int64_t ell_rows,
                            int64_t max_blocks, int bk, int64_t col_blocks,
                            int64_t row_blocks_per_sketch, float* out, int* bad_index,
                            void* stream) {
  if (row_blocks <= 0 || bk <= 0) return static_cast<int>(cudaSuccess);
  if (bk > kStageFloats || row_blocks_per_sketch <= 0 || row_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t stage = kStageFloats / bk;
  if (stage > max_blocks) stage = max_blocks;
  if (stage < 1) stage = 1;
  const dim3 grid(static_cast<unsigned int>(row_blocks),
                  static_cast<unsigned int>((bk + kRowsPerBlock - 1) / kRowsPerBlock));
  const size_t smem = static_cast<size_t>(stage) * bk * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk == 128) {
    block_ell_bk128<<<grid, kThreads, smem, s>>>(vals, col_idx, v, row_ptr, ell_rows, max_blocks,
                                                 col_blocks, row_blocks_per_sketch,
                                                 static_cast<int>(stage), out, bad_index);
  } else {
    block_ell_any<<<grid, kThreads, smem, s>>>(vals, col_idx, v, row_ptr, ell_rows, max_blocks,
                                               bk, col_blocks, row_blocks_per_sketch,
                                               static_cast<int>(stage), out, bad_index);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
