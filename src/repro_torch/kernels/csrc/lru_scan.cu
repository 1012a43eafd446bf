// Linear-recurrence (LRU) scan: h_t = a_t h_{t-1} + b_t, and its backward.
//
// Forward: replaces the TPU kernel src/repro/kernels/lru_scan.py
// (lru_scan_fwd_call, the pallas_call at :50), which the RG-LRU layers of
// the hybrid LM run with rglru_backend="pallas". Over (B, S, W) float32
// tensors, contiguous with W fastest, each channel (b, w) is an independent
// first-order recurrence along S with h_{-1} = 0, in float32 throughout.
// This is the function of the plain version
// repro_torch/kernels/ref.py::lru_scan_ref. The backward (lru_chunk_bwd,
// below) has its own note.
//
// The TPU kernel walks sequence tiles on a grid axis that runs in order and
// carries h from tile to tile in VMEM. Blocks here run in no order, and one
// thread walking a channel's whole sequence leaves B * W threads, 2560 at
// the prefill shape: far too few bytes in flight to cover the latency of
// HBM. So the sequence is cut into C chunks of L steps (lru_scan_chunk,
// below: L = 256 at the paths' shapes), and each (chunk, 32 channels) is
// one warp, a block of its own: B * ceil(W/32) * C blocks, 10,240 at the
// prefill shape. A block
//
// 1. takes a ticket from a counter that the launch zeroes (atomicAdd), and
//    the ticket, not blockIdx, names its rank r in the order the carries
//    flow and its channel group g (r = ticket / groups), so the block of
//    rank r - 1 of the same group has taken an earlier ticket: it runs or
//    has run, and a block never waits on one that is not resident
//    (take_ticket); the forward's rank r is chunk c = r;
// 2. copies its chunk's a and b into shared memory (stage_rows: cp.async,
//    16 bytes a copy where W is a multiple of 4 and the tensors start on 16
//    bytes, else 4; 64 KB at L = 256);
// 3. forms, in the recurrence's own order, the chunk's product
//    A_c = a_first * ... * a_last and its end state H_c from h = 0;
// 4. waits for the flag of rank r - 1 and reads its inclusive carry
//    h_in(c) (0 for r = 0; wait_carry), publishes h_in(c+1) = A_c h_in(c) +
//    H_c and raises its own flag (a fence, then a release store;
//    publish_carry);
// 5. re-runs the recurrence over the chunk from h_in(c) out of shared
//    memory, writing h.
//
// Every carry is the previous rank's inclusive one, in chunk order, so the
// sums do not depend on timing: no look-back combines whatever aggregates
// happen to be ready, no atomics touch a sum, and two launches give the
// same bits. Lengths and widths that are not multiples of L or 32 are
// masked. A block that polls a flag more than kMaxSpins times (a wait of
// a quarter of a second or more, against a launch of under a millisecond)
// traps rather than hang: the launch then fails with an error that the
// next synchronising call reports, never with quiet output. The flags, the
// counter and the carries live in a scratch that the caller allocates.
//
// What bounds it on an H100: bytes. It reads a and b once and writes h
// once, 3 * B*S*W * 4 bytes (1.007 GB at the prefill shape B = 1,
// S = 32768, W = 2560: 0.30 ms at 3.35 TB/s), plus 2 * B*C*W carries, and
// does one FMA (and in step 3 a multiply) an element. A three-pass form
// (aggregate, carry, re-scan as three kernels) reads a and b twice, 20
// bytes an element instead of 12.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;          // channels of a block, forward and backward: one warp
constexpr int kMaxChunk = 256;     // the forward's longest chunk (a and b staged: 64 KB of shared memory)
constexpr int kBwdMaxChunk = 128;  // the backward's longest chunk (a and g staged: 32 KB)
constexpr int kMinChunk = 32;      // the shortest chunk
constexpr int kTargetWarps = 640;  // blocks (warps) the chunks aim at
constexpr int kMaxSpins = 1 << 22; // polls of a predecessor's flag before the block traps
constexpr int kBwdAhead = 32;      // the backward's re-scan: steps of h loaded ahead

// Asynchronous copies of 4 and 16 bytes into shared memory; src_bytes
// below the copy's size fills the rest with zeros (0: a zero, nothing read).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();  // the other lanes' copies of this lane's column
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// A block of a chunked scan: its rank in the order the carries flow, its
// channel group, and this lane's batch row and channel.
struct ChunkBlock {
  int64_t rank, group, groups, batch, w;
  bool live;  // w < width
};

// Step 1 of the note: the ticket names the block's rank and group.
__device__ __forceinline__ ChunkBlock take_ticket(int* counter, int64_t batch_n, int64_t width) {
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int64_t width_groups = (width + kWarp - 1) / kWarp;
  ChunkBlock blk;
  blk.groups = batch_n * width_groups;
  blk.rank = ticket / blk.groups;
  blk.group = ticket - blk.rank * blk.groups;
  blk.batch = blk.group / width_groups;
  blk.w = (blk.group - blk.batch * width_groups) * kWarp + threadIdx.x;
  blk.live = blk.w < width;
  return blk;
}

// Issue the copies of rows row0 .. row0 + n - 1 of the block's 32 channels
// of x (batch, seq, width) into s[k * 32 + lane]; a row outside [0, seq)
// comes in as zeros and is read from nowhere. vec16: 16-byte copies, 8
// lanes a 128-byte row, 4 rows at a time; else one 4-byte copy a live lane.
__device__ __forceinline__ void stage_rows(float* s, const float* x, const ChunkBlock& blk, int64_t row0, int n,
                                           int64_t seq, int64_t width, bool vec16) {
  const int lane = threadIdx.x;
  if (vec16) {
    const int seg = lane & 7;
    const int64_t wseg = blk.w - lane + seg * 4;
    if (wseg < width) {
      for (int k = lane >> 3; k < n; k += 4) {
        const int64_t t = row0 + k;
        const bool in = t >= 0 && t < seq;
        cp_async16(s + k * kWarp + seg * 4, x + (blk.batch * seq + (in ? t : 0)) * width + wseg, in ? 16 : 0);
      }
    }
  } else if (blk.live) {
    for (int k = 0; k < n; ++k) {
      const int64_t t = row0 + k;
      const bool in = t >= 0 && t < seq;
      cp_async4(s + k * kWarp + lane, x + (blk.batch * seq + (in ? t : 0)) * width + blk.w, in ? 4 : 0);
    }
  }
}

// Step 4, first half: the inclusive carry of rank r - 1 for this lane's
// channel (0 for rank 0), after its flag is raised.
__device__ __forceinline__ float wait_carry(const int* flags, const float* carry, const ChunkBlock& blk,
                                            int64_t batch_n, int64_t width) {
  if (blk.rank == 0) return 0.0f;
  const int* flag = flags + (blk.rank - 1) * blk.groups + blk.group;
  int spins = 0;
  while (ld_acquire(flag) == 0) {
    if (++spins > kMaxSpins) __trap();
    __nanosleep(64);
  }
  return blk.live ? __ldcg(carry + ((blk.rank - 1) * batch_n + blk.batch) * width + blk.w) : 0.0f;
}

// Step 4, second half: publish this rank's inclusive carry, then its flag.
__device__ __forceinline__ void publish_carry(int* flags, float* carry, const ChunkBlock& blk, int64_t batch_n,
                                              int64_t width, float value) {
  if (blk.live) __stcg(carry + (blk.rank * batch_n + blk.batch) * width + blk.w, value);
  __threadfence();
  __syncwarp();
  if (threadIdx.x == 0) st_release(flags + blk.rank * blk.groups + blk.group, 1);
}

// The forward, one warp a block: steps 1-5 of the note above.
__global__ void __launch_bounds__(kWarp)
lru_chunk_onepass(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
                  float* __restrict__ carry, int* __restrict__ flags, int* __restrict__ counter,
                  int64_t batch_n, int64_t seq, int64_t width, int64_t chunk, int64_t chunks, bool vec16) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + chunk * kWarp;
  const int lane = threadIdx.x;
  const ChunkBlock blk = take_ticket(counter, batch_n, width);
  const int64_t t0 = blk.rank * chunk;
  const int n = static_cast<int>((t0 + chunk < seq ? t0 + chunk : seq) - t0);
  stage_rows(sa, a, blk, t0, n, seq, width, vec16);
  stage_rows(sb, b, blk, t0, n, seq, width, vec16);
  cp_async_wait_all();
  float prod = 1.0f, agg = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float x = sa[k * kWarp + lane];
    agg = fmaf(x, agg, sb[k * kWarp + lane]);
    prod *= x;
  }
  const float h_in = wait_carry(flags, carry, blk, batch_n, width);
  if (blk.rank + 1 < chunks) publish_carry(flags, carry, blk, batch_n, width, fmaf(prod, h_in, agg));
  const int64_t base = (blk.batch * seq + t0) * width + blk.w;
  float state = h_in;
  for (int k = 0; k < n; ++k) {
    state = fmaf(sa[k * kWarp + lane], state, sb[k * kWarp + lane]);
    if (blk.live) h[base + k * width] = state;
  }
}

// h_{t0+k-1} for the steps k = k_hi, k_hi - 1, ..., k_hi - kBwdAhead + 1 of
// a chunk that starts at t0 (0 for a step before the chunk, k < 0, and for
// h_{-1}); all 0 where not wanted.
__device__ __forceinline__ void load_h_prev(float (&out)[kBwdAhead], const float* __restrict__ h, int64_t base,
                                            int k_hi, int64_t t0, int64_t width, bool wanted) {
#pragma unroll
  for (int q = 0; q < kBwdAhead; ++q) {
    const int k = k_hi - q;
    out[q] = wanted && k >= 0 && t0 + k >= 1 ? __ldg(h + base + static_cast<int64_t>(k - 1) * width) : 0.0f;
  }
}

// Backward: replaces the TPU kernel src/repro/kernels/lru_scan.py
// (lru_scan_bwd_call, the pallas_call at :88) together with the custom VJP
// around it (src/repro/kernels/ops.py:309-325). Given the forward's a and h
// and the cotangent g of h, it runs the reverse recurrence
//   lam_t = g_t + a_{t+1} lam_{t+1}   (a_S = 0, lam_S = 0)
// and writes db_t = lam_t and da_t = lam_t h_{t-1} (h_{-1} = 0): the
// function of repro_torch/kernels/ref.py::lru_scan_bwd_ref. The reference
// makes a shifted copy a_next of a, runs the kernel for lam, and forms
// lam * h_prev in a second elementwise pass over a shifted copy of h. Here
// one pass, with no copy, writes db and da.
//
// What bounds it: bytes, 5 * B*S*W * 4 (a, h and g read once, da and db
// written once: 1.68 GB at B = 1, S = 32768, W = 2560, 0.50 ms at
// 3.35 TB/s; 0.031 ms at the train step's S = 2048). One thread a channel,
// walking all of S, left 2,560 threads at both shapes and ran at a fifth
// of that. So it takes the forward's blocks (steps 1-5 above, the same
// helpers), mirrored: the rank r of a block is
// chunk c = C - 1 - r, so the carries flow from the end. A block
//
// - stages, for the chunk's steps t = t0 .. t0 + n - 1, the shifted
//   a_{t+1} and g_t (a_S comes in as 0: masked, not padded; the chunk's
//   last a_{t0+n} is the next chunk's first row, one extra row, no copy);
// - meanwhile loads the first kBwdAhead h_{t-1} of its re-scan into
//   registers (h_{t0-1} is the previous chunk's last row; h_{-1} = 0);
// - forms, from the chunk's end down, A_c = a_{t0+1} ... a_{t0+n} and
//   G_c, the chunk's lam_{t0} from lam_{t0+n} = 0;
// - waits for rank r - 1 (chunk c + 1) and reads its inclusive carry
//   lam_in = lam_{t0+n}, publishes lam_{t0} = G_c + A_c lam_in;
// - re-runs lam from lam_in over the chunk out of shared memory, from the
//   end, writing db and da, with the next kBwdAhead rows of h loaded while
//   the current ones are used.
//
// Its chunks are at most kBwdMaxChunk = 128 steps (lru_scan_bwd_chunk's
// rule, the forward's from a shorter start): 32 KB of staged a and g a
// warp, so that 6 warps share an SM where the forward's 64 KB leave 3. The
// re-scan, with its two stores and the h it streams, needs the warps more
// than the forward does: on an H100 the shorter chunks take the backward
// from 0.85 to 0.70 ms at (1, 32768, 2560) and the forward from 0.41 to
// 0.48; chunks of 64 take the backward to 0.94. Staging h too would take
// half as much shared memory again, so h streams instead. The same
// determinism as the forward: carries in chunk order, no atomics on a sum,
// two launches bitwise equal, a trap instead of a hang. da may be null (its
// gradient not wanted); then only db is written and h is not read.
__global__ void __launch_bounds__(kWarp)
lru_chunk_bwd(const float* __restrict__ a, const float* __restrict__ h, const float* __restrict__ g,
              float* __restrict__ da, float* __restrict__ db, float* __restrict__ carry, int* __restrict__ flags,
              int* __restrict__ counter, int64_t batch_n, int64_t seq, int64_t width, int64_t chunk,
              int64_t chunks, bool vec16) {
  extern __shared__ float smem[];
  float* sa = smem;  // a_{t+1}
  float* sg = smem + chunk * kWarp;
  const int lane = threadIdx.x;
  const ChunkBlock blk = take_ticket(counter, batch_n, width);
  const int64_t t0 = (chunks - 1 - blk.rank) * chunk;
  const int n = static_cast<int>((t0 + chunk < seq ? t0 + chunk : seq) - t0);
  stage_rows(sa, a, blk, t0 + 1, n, seq, width, vec16);
  stage_rows(sg, g, blk, t0, n, seq, width, vec16);
  const int64_t base = (blk.batch * seq + t0) * width + blk.w;
  const bool want_h = da != nullptr && blk.live;
  float h_next[kBwdAhead];
  load_h_prev(h_next, h, base, n - 1, t0, width, want_h);
  cp_async_wait_all();
  float prod = 1.0f, agg = 0.0f;
  for (int k = n - 1; k >= 0; --k) {
    const float x = sa[k * kWarp + lane];
    agg = fmaf(x, agg, sg[k * kWarp + lane]);
    prod *= x;
  }
  const float lam_in = wait_carry(flags, carry, blk, batch_n, width);
  if (blk.rank + 1 < chunks) publish_carry(flags, carry, blk, batch_n, width, fmaf(prod, lam_in, agg));
  float lam = lam_in;
  for (int k_hi = n - 1; k_hi >= 0; k_hi -= kBwdAhead) {
    float h_cur[kBwdAhead];
#pragma unroll
    for (int q = 0; q < kBwdAhead; ++q) h_cur[q] = h_next[q];
    load_h_prev(h_next, h, base, k_hi - kBwdAhead, t0, width, want_h);
#pragma unroll
    for (int q = 0; q < kBwdAhead; ++q) {
      const int k = k_hi - q;
      if (k >= 0) {
        lam = fmaf(sa[k * kWarp + lane], lam, sg[k * kWarp + lane]);
        if (blk.live) {
          db[base + static_cast<int64_t>(k) * width] = lam;
          if (da != nullptr) da[base + static_cast<int64_t>(k) * width] = lam * h_cur[q];
        }
      }
    }
  }
}

// The chunk rule: the longest power of two from max_chunk down to
// kMinChunk at which batch * ceil(width / 32) * ceil(seq / L) warps reach
// kTargetWarps (or kMinChunk if none does).
int64_t chunk_rule(int64_t batch, int64_t seq, int64_t width, int64_t max_chunk) {
  const int64_t groups = batch * ((width + 31) / 32);
  int64_t chunk = max_chunk;
  while (chunk > kMinChunk && groups * ((seq + chunk - 1) / chunk) < kTargetWarps) chunk /= 2;
  return chunk;
}

// What both launches share: check the shape, point carry and flags into
// the scratch part, allow the kernel its shared memory (two streams of
// max_chunk steps) and zero the flags and the ticket counter on s. Returns
// the error to report (0 = go on).
cudaError_t chunk_setup(const void* kernel, int64_t max_chunk, int64_t batch, int64_t seq, int64_t width,
                        int64_t chunk, float* part, cudaStream_t s, int64_t* chunks, int64_t* groups,
                        float** carry, int** flags) {
  *chunks = chunk >= 1 ? (seq + chunk - 1) / chunk : 0;
  *groups = batch * ((width + kWarp - 1) / kWarp);
  if (*chunks < 1 || chunk > max_chunk || part == nullptr || *chunks * *groups > 0x7fffffff)
    return cudaErrorInvalidValue;
  *carry = part;
  *flags = reinterpret_cast<int*>(part + batch * *chunks * width);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(2 * max_chunk * kWarp * sizeof(float)));
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(*flags, 0, static_cast<size_t>(*chunks * *groups + 1) * sizeof(int), s);
}

// 16-byte copies need 16-byte addresses: every row of x and y starts on one
// when W is a multiple of 4 and the tensors themselves do.
bool rows_on_16_bytes(const float* x, const float* y, int64_t width) {
  return width % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
}

}  // namespace

extern "C" {

// The chunk length L of a forward launch over (batch, seq, width): the
// chunk rule from kMaxChunk; the launch runs C = ceil(seq / L) chunks.
int64_t lru_scan_chunk(int64_t batch, int64_t seq, int64_t width) {
  return chunk_rule(batch, seq, width, kMaxChunk);
}

// The chunk length of a backward launch: the chunk rule from kBwdMaxChunk.
int64_t lru_scan_bwd_chunk(int64_t batch, int64_t seq, int64_t width) {
  return chunk_rule(batch, seq, width, kBwdMaxChunk);
}

// The blocks (one warp each) of a forward (backward = 0) or backward launch
// with chunks of `chunk` steps that one SM holds at once, by the runtime's
// occupancy calculator (registers and shared memory); -1 on an error.
int lru_scan_blocks_per_sm(int backward, int64_t chunk) {
  const void* kernel = backward ? reinterpret_cast<const void*>(lru_chunk_bwd)
                                : reinterpret_cast<const void*>(lru_chunk_onepass);
  const int64_t max_chunk = backward ? kBwdMaxChunk : kMaxChunk;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(2 * max_chunk * kWarp * sizeof(float))) != cudaSuccess)
    return -1;
  int blocks = 0;
  const size_t smem = static_cast<size_t>(2 * chunk * kWarp) * sizeof(float);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWarp, smem) == cudaSuccess ? blocks : -1;
}

// Launches on `stream` (a memset that zeroes the flags and the ticket
// counter, then the kernel), allocates nothing, and returns the launches'
// cudaError_t (0 = success). a, b and h are device pointers to
// (batch, seq, width) contiguous float32 tensors; h is written whole.
// chunk is the chunk length, 1 .. kMaxChunk (lru_scan_chunk's); part is a
// scratch of at least 3 * batch * C * width 4-byte words, C = ceil(seq /
// chunk), for the carries, the flags and the counter (null is refused). A
// grid beyond the card's limits is refused with cudaErrorInvalidValue.
int lru_scan_fwd_launch(const float* a, const float* b, float* h, int64_t batch, int64_t seq,
                        int64_t width, int64_t chunk, float* part, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t chunks, groups;
  float* carry;
  int* flags;
  cudaError_t err = chunk_setup(reinterpret_cast<const void*>(lru_chunk_onepass), kMaxChunk, batch, seq, width,
                                chunk, part, s, &chunks, &groups, &carry, &flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(2 * chunk * kWarp) * sizeof(float);
  lru_chunk_onepass<<<static_cast<unsigned int>(chunks * groups), kWarp, smem, s>>>(
      a, b, h, carry, flags, flags + chunks * groups, batch, seq, width, chunk, chunks, rows_on_16_bytes(a, b, width));
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream` (a memset, then the kernel), allocates
// nothing, and returns the launches' cudaError_t. a and h are the forward's
// input and output, g the cotangent of h; da and db receive the gradients
// of a and b. All are device pointers to (batch, seq, width) contiguous
// float32 tensors; da may be null, and then only db is written. chunk is
// 1 .. kBwdMaxChunk (lru_scan_bwd_chunk's), part as for the forward (at
// least 3 * batch * C * width 4-byte words); refusals as for the forward.
int lru_scan_bwd_launch(const float* a, const float* h, const float* g, float* da, float* db, int64_t batch,
                        int64_t seq, int64_t width, int64_t chunk, float* part, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t chunks, groups;
  float* carry;
  int* flags;
  cudaError_t err = chunk_setup(reinterpret_cast<const void*>(lru_chunk_bwd), kBwdMaxChunk, batch, seq, width,
                                chunk, part, s, &chunks, &groups, &carry, &flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(2 * chunk * kWarp) * sizeof(float);
  lru_chunk_bwd<<<static_cast<unsigned int>(chunks * groups), kWarp, smem, s>>>(
      a, h, g, da, db, carry, flags, flags + chunks * groups, batch, seq, width, chunk, chunks,
      rows_on_16_bytes(a, g, width));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
