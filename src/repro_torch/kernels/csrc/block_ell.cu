// Block-ELL sketch mat-vecs for the tile-granular Spar-Sink solver: K~ v and
// K~^T u, both on the sketch's row layout.
//
// K~ v replaces the TPU kernel src/repro/kernels/block_ell.py
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
// zero tiles with column id 0. Given the valid counts nblocks (the solver's
// launch), block_ell_bk128_valid reads only the valid slots, with the sums
// of the walk over every slot (its note says why, and how an inf in v block
// 0 still gives that walk's NaN); the other kernels sum every slot, padding
// included, as the TPU kernel does. A column id outside [0, ncb), a row_ptr
// range outside [0, ell_rows) or a valid count outside [0, max_blocks] sets
// *bad_index and gives NaN; nothing is read out of bounds. This is the
// function of the plain version repro_torch/kernels/ref.py::block_ell_matvec_ref.
//
// Each output row of K~ v is summed by one warp in one fixed order: lane l
// sums its tile columns j = l, l + 32, ... (Bk = 128: the four columns
// 4l..4l+3, loaded as one float4) in order, a fixed shuffle tree adds the
// 32 lane sums, and the tile sums are added to the row's running sum in
// slot order, as the Pallas kernel accumulates into o_ref. Both products
// take their float4 kernels only where vals starts on 16 bytes (every tile
// row then does); tiles at another offset go to the kernels for any Bk.
//
// K~^T u is the reference's block_ell_rmatvec (src/repro/core/sparsify.py:728,
// which its solver calls at src/repro/core/api/solvers.py:863): per tile,
// (Bk,) @ (Bk x Bk), added into the tile's column-block. It reads the same
// row-layout tiles as K~ v, through the sketch's column lists, built once
// with the sketch (repro_torch/kernels/block_ell.py::column_lists): for
// each column-block c, the valid tiles with column id c as (flat slot
// e * max_blocks + k, row-block of ELL row e), in the order of row-block,
// then slot, the order in which the reference's scatter adds them, at
// col_ptr[c] .. col_ptr[c+1]-1. Each column-block's list is cut into work
// units of kUnitTiles tiles (the last one shorter), col_unit_ptr[c] being
// the first unit of column-block c. Block q finds its column-block by a
// binary search of col_unit_ptr and sums unit q: warp w reads the tile rows
// w*16 .. w*16+15 of each of the unit's tiles in order (a tile row is 512
// contiguous bytes at Bk = 128: one float4 a lane), lane l accumulates the
// columns 4l..4l+3 over those rows, and the 8 warps' sums are added in warp
// order into the unit's partial, written to a scratch that the wrapper
// allocates (other Bk: thread j sums column j over the tiles and rows in
// order). A second kernel, inside the same
// launch function, adds the partials of each column-block's units in unit
// order (0 for a column-block with no tile). The function is that of the
// plain version repro_torch/kernels/ref.py::block_ell_rmatvec_ref. An entry
// of the lists outside the tiles or the row-blocks sets *bad_index and
// gives NaN.
//
// Both products read and write the path's own type, float32 or float64
// (the template parameter T): an input value is rounded to float32 with
// __double2float_rn, as .to(torch.float32) rounds it, sums are float32,
// and the output is written back in T, so a float64 caller needs no cast
// launches around the product and gets the bits of cast, float32 launch,
// cast. No atomics: two launches on the same inputs are bitwise equal.
//
// What bounds them on an H100: bytes. Each product needs every valid tile
// once (175 of the 448 slots of the n = 8192, Bk = 128, max_blocks = 7 row
// layout: 11.5 MB) and 2 float32 operations per element. K~^T u's kernel
// reads just those, and so does K~ v's where the solver passes the valid
// counts; the all-slot walk reads the zero tiles that pad the ELL rows too
// (29.4 MB). In the solve the two run back to back on the same tiles, which
// fit the 50 MB L2. K~ v's design over every slot: a tile
// row is contiguous, so a warp's loads of one row coalesce (512 B at
// Bk = 128), each lane keeps the loads of 4 slots of its warp's 2 rows in
// flight, and the v blocks of the row-block's slots are staged once in
// shared memory (up to 32 KB, more slots in passes) and read by all 16 rows
// of the block; a block covers 16 tile rows of one row-block, so Bk = 128
// gives 8 blocks per row-block. K~^T u's work is uneven across its
// outputs: rank-1 sampling probabilities force every row-block's heaviest
// tile into one column-block, which then holds some ten times the tiles of
// the others. Cut into units of kUnitTiles tiles, it costs several short
// blocks instead of one long walk, so no output sets the launch's time;
// each lane keeps a tile's 16 row loads in flight.
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
constexpr int kLoadsInFlight = 8;                     // Bk = 128, valid slots: tile-row loads a lane
// tiles of one K~^T u work unit (kernels/block_ell.py::UNIT_TILES cuts the lists)
constexpr int kUnitTiles = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

// The sum of x over the warp by a fixed butterfly: every lane ends with the
// same value, from the same additions on every launch.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Stage the v blocks of slots [slot0, slot0 + kn), kn x bk floats, checking
// each column id.
template <typename T>
__device__ __forceinline__ void stage_v(const int32_t* __restrict__ col_idx,
                                        const T* __restrict__ v, int64_t slot0, int kn,
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
      vs[t] = to_f32(v[(v_block0 + c) * bk + j]);
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

// K~ v, any Bk: lane l sums the tile columns l, l + 32, ... of a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_any(const float* __restrict__ vals, const int32_t* __restrict__ col_idx,
                  const T* __restrict__ v, const int32_t* __restrict__ row_ptr,
                  int64_t ell_rows, int64_t max_blocks, int bk, int64_t ncb,
                  int64_t row_blocks_per_sketch, int stage, T* __restrict__ out,
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
    if (i < bk && lane == 0) out[r * bk + i] = static_cast<T>(acc[q]);
  }
}

// K~ v at Bk = 128, the solver's default: lane l sums the columns 4l..4l+3
// of a row from one float4, and the loads of kSlotsInFlight slots of both
// of the warp's rows are issued before any of their sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_bk128(const float* __restrict__ vals, const int32_t* __restrict__ col_idx,
                    const T* __restrict__ v, const int32_t* __restrict__ row_ptr,
                    int64_t ell_rows, int64_t max_blocks, int64_t ncb,
                    int64_t row_blocks_per_sketch, int stage, T* __restrict__ out,
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
    for (int q = 0; q < kRowsPerWarp; ++q) out[r * kBk + row0 + kWarps * q] = static_cast<T>(acc[q]);
  }
}

// The float4 of lane `lane` in the tile rows row0, row0 + 8, ... (kRows of
// them) of slots first .. first + kInFlight - 1 (zeros from slot nb on).
template <int kRows, int kInFlight>
__device__ __forceinline__ void load_tile_rows(float4 (&t)[kRows][kInFlight], const float* __restrict__ vals,
                                               int64_t first, int nb, int row0, int lane) {
  constexpr int kBk = 128;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t row = (first + u) * kBk + row0 + kWarps * q;
      t[q][u] = u < nb ? __ldg(reinterpret_cast<const float4*>(vals + row * kBk) + lane)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The rows of block_ell_bk128_valid with kRows tile rows a warp: their
// tile rows' loads go out before the barrier that waits for the staged v
// blocks, and each row sums its slots as block_ell_bk128 does.
template <typename T, int kRows>
__device__ __forceinline__ void valid_rows(const float* __restrict__ vals, const float4* vs, int64_t r,
                                           int64_t first, int nb, int pad_bad, bool nan_rows,
                                           T* __restrict__ out) {
  constexpr int kBk = 128;
  constexpr int kInFlight = kLoadsInFlight / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * (kWarps * kRows) + warp;
  float4 t[kRows][kInFlight];
  load_tile_rows<kRows, kInFlight>(t, vals, first, nb, row0, lane);
  nan_rows |= __syncthreads_or(pad_bad) != 0;  // the v blocks are staged
  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    acc[q] = 0.0f;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (u < nb) {  // the same for the whole block
        const float4 w = vs[u * (kBk / 4) + lane];
        float p = t[q][u].x * w.x;
        p = fmaf(t[q][u].y, w.y, p);
        p = fmaf(t[q][u].z, w.z, p);
        p = fmaf(t[q][u].w, w.w, p);
        acc[q] += warp_sum(p);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      out[r * kBk + row0 + kWarps * q] = nan_rows ? static_cast<T>(NAN) : static_cast<T>(acc[q]);
  }
}

// K~ v at Bk = 128 over the valid slots alone: the row layout (one ELL row
// a row-block) with its valid counts nblocks and at most kLoadsInFlight
// slots a row. Row-block r holds nb = nblocks[r] valid tiles (at n = 8192,
// most hold 2, a few all 7), so a warp takes as many tile rows (4, 2 or 1)
// as keep rows x nb within kLoadsInFlight loads a lane: every warp sums its
// rows in one round of loads, the heaviest row-block with 16 blocks of 8
// rows, the lightest with 4 of 32; the blocks a row-block does not need
// return at once. Two round trips to memory: first the count, the ELL
// row's column ids and v block 0, all independent; then the valid slots' v
// blocks (staged in shared memory) and the warp's tile rows.
//
// The padding slots it skips hold zero tiles with column id 0 (the
// sketch's layout, checked once when the sketch is built), whose terms
// sum_j 0 * v_j over v block 0 the all-slot walk adds. For finite v each is
// +-0, and adding +-0 leaves every sum as it was: a sum starts at +0, and
// round-to-nearest gives -0 only from two -0 operands, so not even the sign
// of a zero moves (-0 against +0 is the one difference torch.equal would
// not see). Where v block 0 holds an inf or a NaN (after the rounding to
// float32 that staging applies), the all-slot walk makes every row of a
// row-block with padding NaN, and so does this kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_bk128_valid(const float* __restrict__ vals, const int32_t* __restrict__ col_idx,
                          const T* __restrict__ v, const int32_t* __restrict__ nblocks, int64_t max_blocks,
                          int64_t ncb, int64_t row_blocks_per_sketch, T* __restrict__ out,
                          int* __restrict__ bad_index) {
  constexpr int kBk = 128;
  constexpr int kPerThread = kLoadsInFlight * kBk / kThreads;  // staged v values a thread
  __shared__ float4 vs[kLoadsInFlight * kBk / 4];
  const int64_t r = blockIdx.x;
  const int64_t first = r * max_blocks;
  const int64_t v_block0 = (r / row_blocks_per_sketch) * ncb;
  // round trip 1
  int nb = nblocks[r];
  int64_t c[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = (threadIdx.x + i * kThreads) / kBk;
    c[i] = s < max_blocks ? col_idx[first + s] : 0;
  }
  const float v0 = threadIdx.x < kBk ? to_f32(v[v_block0 * kBk + threadIdx.x]) : 0.0f;
  bool nan_rows = false;
  if (nb < 0 || nb > max_blocks) {
    if (threadIdx.x == 0) *bad_index = 1;
    nan_rows = true;
    nb = 0;
  }
  const int rows = nb <= kLoadsInFlight / 4 ? 4 : nb <= kLoadsInFlight / 2 ? 2 : 1;
  if (blockIdx.y * kWarps * rows >= kBk) return;  // the whole block: the row-block needs fewer
  // round trip 2: the valid slots' v blocks, then (in valid_rows) the tile rows
  float* vsf = reinterpret_cast<float*>(vs);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int tt = threadIdx.x + i * kThreads;
    const int s = tt / kBk;
    if (s < nb) {
      if (c[i] < 0 || c[i] >= ncb) {
        if (tt % kBk == 0) *bad_index = 1;
        vsf[tt] = NAN;
      } else {
        vsf[tt] = to_f32(v[(v_block0 + c[i]) * kBk + tt % kBk]);
      }
    }
  }
  // |x| <= FLT_MAX is false for an inf and a NaN
  const int pad_bad = nb < max_blocks && !(fabsf(v0) <= 3.402823466e38f);
  if (rows == 4) {
    valid_rows<T, 4>(vals, vs, r, first, nb, pad_bad, nan_rows, out);
  } else if (rows == 2) {
    valid_rows<T, 2>(vals, vs, r, first, nb, pad_bad, nan_rows, out);
  } else {
    valid_rows<T, 1>(vals, vs, r, first, nb, pad_bad, nan_rows, out);
  }
}

// The list entries [*e0, *e1) of work unit q.
__device__ __forceinline__ void unit_entries(const int32_t* __restrict__ col_ptr,
                                             const int32_t* __restrict__ col_unit_ptr,
                                             int64_t col_blocks, int64_t q, int64_t* e0,
                                             int64_t* e1) {
  // the last column-block c with col_unit_ptr[c] <= q, which has units
  int64_t lo = 0, hi = col_blocks - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (col_unit_ptr[mid] <= q) lo = mid; else hi = mid - 1;
  }
  *e0 = col_ptr[lo] + (q - col_unit_ptr[lo]) * kUnitTiles;
  const int64_t end = col_ptr[lo + 1];
  *e1 = *e0 + kUnitTiles < end ? *e0 + kUnitTiles : end;
}

// The tile and the row-block of u of entry e of the column lists; false
// (and the flag set) for an entry outside the tiles or the row-blocks.
__device__ __forceinline__ bool list_entry(const int32_t* __restrict__ tile,
                                           const int32_t* __restrict__ urow, int64_t e,
                                           int64_t tiles, int64_t u_blocks, int64_t* t,
                                           int64_t* r, int* __restrict__ bad_index) {
  *t = tile[e];
  *r = urow[e];
  if (*t < 0 || *t >= tiles || *r < 0 || *r >= u_blocks) {
    if (threadIdx.x == 0) *bad_index = 1;
    return false;
  }
  return true;
}

// K~^T u work units, any Bk: thread j sums tile column j (and j + kThreads,
// ...) over the unit's tiles in list order and over the tile rows in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_rmatvec_any(const float* __restrict__ vals, const int32_t* __restrict__ tile,
                          const int32_t* __restrict__ urow, const int32_t* __restrict__ col_ptr,
                          const int32_t* __restrict__ col_unit_ptr, int64_t col_blocks,
                          int64_t tiles, int64_t u_blocks, int bk, const T* __restrict__ u,
                          float* __restrict__ part, int* __restrict__ bad_index) {
  const int64_t q = blockIdx.x;
  int64_t e0, e1;
  unit_entries(col_ptr, col_unit_ptr, col_blocks, q, &e0, &e1);
  for (int j = threadIdx.x; j < bk; j += kThreads) {
    float acc = 0.0f;
    for (int64_t e = e0; e < e1; ++e) {
      int64_t t, r;
      if (!list_entry(tile, urow, e, tiles, u_blocks, &t, &r, bad_index)) {
        acc = NAN;
        continue;
      }
      const float* col = vals + t * bk * static_cast<int64_t>(bk) + j;
      const T* ub = u + r * bk;
      for (int i = 0; i < bk; ++i) acc = fmaf(__ldg(col + static_cast<int64_t>(i) * bk), to_f32(ub[i]), acc);
    }
    part[q * bk + j] = acc;
  }
}

// K~^T u work units at Bk = 128: warp w owns the tile rows w*16 .. w*16+15,
// lane l the columns 4l..4l+3; a tile's 16 row loads of a lane are issued
// before any of its sums, and the u values of the warp's rows come from
// one load of lanes 0..15 and a shuffle.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_rmatvec_bk128(const float* __restrict__ vals, const int32_t* __restrict__ tile,
                            const int32_t* __restrict__ urow, const int32_t* __restrict__ col_ptr,
                            const int32_t* __restrict__ col_unit_ptr, int64_t col_blocks,
                            int64_t tiles, int64_t u_blocks, const T* __restrict__ u,
                            float* __restrict__ part, int* __restrict__ bad_index) {
  constexpr int kBk = 128;
  constexpr int kRows = kBk / kWarps;  // 16 tile rows a warp
  __shared__ float4 sums[kWarps][kBk / 4];
  const int64_t q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i0 = warp * kRows;
  int64_t e0, e1;
  unit_entries(col_ptr, col_unit_ptr, col_blocks, q, &e0, &e1);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t e = e0; e < e1; ++e) {
    int64_t t, r;
    if (!list_entry(tile, urow, e, tiles, u_blocks, &t, &r, bad_index)) {  // the same for the block
      acc = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    const float4* rows = reinterpret_cast<const float4*>(vals + (t * kBk + i0) * kBk) + lane;
    float4 w[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) w[k] = __ldg(rows + k * (kBk / 4));
    const float ul = lane < kRows ? to_f32(u[r * kBk + i0 + lane]) : 0.0f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float ui = __shfl_sync(0xffffffffu, ul, k);
      acc.x = fmaf(w[k].x, ui, acc.x);
      acc.y = fmaf(w[k].y, ui, acc.y);
      acc.z = fmaf(w[k].z, ui, acc.z);
      acc.w = fmaf(w[k].w, ui, acc.w);
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < kBk) {
    const float* flat = reinterpret_cast<const float*>(sums);
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += flat[w * kBk + threadIdx.x];
    part[q * kBk + threadIdx.x] = s;
  }
}

// out[c*Bk + j] = the partials of column-block c's units, added in unit order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_ell_rmatvec_combine(const float* __restrict__ part, const int32_t* __restrict__ col_unit_ptr,
                              int64_t col_blocks, int bk, T* __restrict__ out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= col_blocks * bk) return;
  const int64_t c = g / bk;
  const int64_t j = g - c * bk;
  float s = 0.0f;
  for (int64_t q = col_unit_ptr[c]; q < col_unit_ptr[c + 1]; ++q) s += part[q * bk + j];
  out[g] = static_cast<T>(s);
}

template <typename T>
int matvec(const float* vals, const int32_t* col_idx, const void* v, const int32_t* row_ptr,
           const int32_t* nblocks, int64_t row_blocks, int64_t ell_rows, int64_t max_blocks, int bk,
           int64_t col_blocks, int64_t row_blocks_per_sketch, void* out, int* bad_index, cudaStream_t s) {
  int64_t stage = kStageFloats / bk;
  if (stage > max_blocks) stage = max_blocks;
  if (stage < 1) stage = 1;
  const dim3 grid(static_cast<unsigned int>(row_blocks),
                  static_cast<unsigned int>((bk + kRowsPerBlock - 1) / kRowsPerBlock));
  const size_t smem = static_cast<size_t>(stage) * bk * sizeof(float);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const bool float4_tiles = bk == 128 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (float4_tiles && nblocks != nullptr && row_ptr == nullptr && max_blocks <= kLoadsInFlight) {
    block_ell_bk128_valid<T><<<dim3(grid.x, 128 / kWarps), kThreads, 0, s>>>(
        vals, col_idx, vt, nblocks, max_blocks, col_blocks, row_blocks_per_sketch, ot, bad_index);
  } else if (float4_tiles) {
    block_ell_bk128<T><<<grid, kThreads, smem, s>>>(vals, col_idx, vt, row_ptr, ell_rows, max_blocks,
                                                    col_blocks, row_blocks_per_sketch,
                                                    static_cast<int>(stage), ot, bad_index);
  } else {
    block_ell_any<T><<<grid, kThreads, smem, s>>>(vals, col_idx, vt, row_ptr, ell_rows, max_blocks,
                                                  bk, col_blocks, row_blocks_per_sketch,
                                                  static_cast<int>(stage), ot, bad_index);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rmatvec(const float* vals, const int32_t* tile, const int32_t* urow, const int32_t* col_ptr,
            const int32_t* col_unit_ptr, const void* u, int64_t units, int64_t tiles,
            int64_t u_blocks, int bk, int64_t col_blocks, float* part, void* out, int* bad_index,
            cudaStream_t s) {
  const T* ut = static_cast<const T*>(u);
  if (units > 0) {
    const unsigned int grid = static_cast<unsigned int>(units);
    if (bk == 128 && reinterpret_cast<uintptr_t>(vals) % 16 == 0) {
      block_ell_rmatvec_bk128<T><<<grid, kThreads, 0, s>>>(vals, tile, urow, col_ptr, col_unit_ptr,
                                                           col_blocks, tiles, u_blocks, ut, part,
                                                           bad_index);
    } else {
      block_ell_rmatvec_any<T><<<grid, kThreads, 0, s>>>(vals, tile, urow, col_ptr, col_unit_ptr,
                                                         col_blocks, tiles, u_blocks, bk, ut, part,
                                                         bad_index);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (col_blocks * bk + kThreads - 1) / kThreads;
  block_ell_rmatvec_combine<T><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      part, col_unit_ptr, col_blocks, bk, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K~ v. Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 = success). Pointers are device pointers: vals is
// (ell_rows, max_blocks, bk, bk) contiguous float32, col_idx is
// (ell_rows, max_blocks) int32, row_ptr is null or (row_blocks + 1,) int32,
// nblocks is null or (ell_rows,) int32, the valid slots at the start of
// each ELL row, the rest zero tiles with column id 0 (read as a hint: with
// it, the float4 tiles of a row layout with max_blocks <= kLoadsInFlight
// take block_ell_bk128_valid, every other launch walks every slot, with the
// same sums), v holds col_blocks * bk values for each sketch (row_blocks /
// row_blocks_per_sketch of them) and out (row_blocks * bk,) values, both
// float64 when f64 is 1 and float32 when it is 0, and bad_index is one
// int32 that the caller zeroed: the kernel sets it to 1 if a column id lies
// outside [0, col_blocks), a row_ptr range outside [0, ell_rows) or (in
// block_ell_bk128_valid) a valid count outside [0, max_blocks]. bk
// above 8192 (one v block beyond the 32 KB stage) is refused with
// cudaErrorInvalidValue.
int block_ell_matvec_launch(const float* vals, const int32_t* col_idx, const void* v,
                            const int32_t* row_ptr, const int32_t* nblocks, int64_t row_blocks,
                            int64_t ell_rows, int64_t max_blocks, int bk, int64_t col_blocks,
                            int64_t row_blocks_per_sketch, int f64, void* out, int* bad_index,
                            void* stream) {
  if (row_blocks <= 0 || bk <= 0) return static_cast<int>(cudaSuccess);
  if (bk > kStageFloats || row_blocks_per_sketch <= 0 || row_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? matvec<double>(vals, col_idx, v, row_ptr, nblocks, row_blocks, ell_rows, max_blocks, bk,
                              col_blocks, row_blocks_per_sketch, out, bad_index, s)
             : matvec<float>(vals, col_idx, v, row_ptr, nblocks, row_blocks, ell_rows, max_blocks, bk,
                             col_blocks, row_blocks_per_sketch, out, bad_index, s);
}

// K~^T u on the row layout, through its column lists: tile and urow are
// int32 (list length), the flat slot (< tiles = ell_rows * max_blocks) and
// the row-block of u (< u_blocks) of each entry; col_ptr and col_unit_ptr
// are int32 (col_blocks + 1,) offsets of each column-block's entries and of
// its first work unit (ceil(entries / kUnitTiles) units each, `units` in
// all). vals is the row layout's float32 tiles as for K~ v; u holds
// u_blocks * bk values and out col_blocks * bk values, float64 when f64 is
// 1 and float32 when it is 0; part is a float32 scratch of units * bk
// values; bad_index as for K~ v (set for a list entry out of range). Two
// kernels on `stream`: the units' partials, then their sums in unit order.
// Allocates nothing and returns the launches' cudaError_t; a grid of more
// than 2^31 - 1 blocks or bk above 8192 is refused with
// cudaErrorInvalidValue.
int block_ell_rmatvec_launch(const float* vals, const int32_t* tile, const int32_t* urow,
                             const int32_t* col_ptr, const int32_t* col_unit_ptr, const void* u,
                             int64_t units, int64_t tiles, int64_t u_blocks, int bk,
                             int64_t col_blocks, int f64, float* part, void* out, int* bad_index,
                             void* stream) {
  if (col_blocks <= 0 || bk <= 0) return static_cast<int>(cudaSuccess);
  if (bk > kStageFloats || units < 0 || units > 0x7fffffff ||
      (col_blocks * bk + kThreads - 1) / kThreads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? rmatvec<double>(vals, tile, urow, col_ptr, col_unit_ptr, u, units, tiles, u_blocks,
                               bk, col_blocks, part, out, bad_index, s)
             : rmatvec<float>(vals, tile, urow, col_ptr, col_unit_ptr, u, units, tiles, u_blocks,
                              bk, col_blocks, part, out, bad_index, s);
}

}  // extern "C"
