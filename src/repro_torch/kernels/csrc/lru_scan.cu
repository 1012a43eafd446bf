// Linear-recurrence (LRU) scan: h_t = a_t h_{t-1} + b_t, and its backward.
//
// Forward: replaces the TPU kernel src/repro/kernels/lru_scan.py
// (lru_scan_fwd_call, the pallas_call at :50), which the RG-LRU layers of
// the hybrid LM run with rglru_backend="pallas". Over (B, S, W) float32
// tensors, contiguous with W fastest, each channel (b, w) is an independent
// first-order recurrence along S with h_{-1} = 0, in float32 throughout.
// This is the function of the plain version
// repro_torch/kernels/ref.py::lru_scan_ref. The backward (lru_scan_bwd_f32,
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
//    the ticket, not blockIdx, names its chunk c and channel group g
//    (c = ticket / groups), so the block of chunk c - 1 of the same group
//    has taken an earlier ticket: it runs or has run, and a block never
//    waits on one that is not resident;
// 2. copies its chunk's a and b into shared memory (cp.async, 16 bytes a
//    copy where W is a multiple of 4 and a and b start on 16 bytes, else 4:
//    64 KB at L = 256);
// 3. forms, in the recurrence's own order, the chunk's product
//    A_c = a_first * ... * a_last and its end state H_c from h = 0;
// 4. waits for the flag of chunk c - 1 and reads its inclusive carry
//    h_in(c) (0 for c = 0), publishes h_in(c+1) = A_c h_in(c) + H_c and
//    raises its own flag (a fence, then a release store);
// 5. re-runs the recurrence over the chunk from h_in(c) out of shared
//    memory, writing h.
//
// Every carry is the previous chunk's inclusive one, in chunk order, so the
// sums do not depend on timing: no look-back combines whatever aggregates
// happen to be ready, no atomics touch a sum, and two launches give the
// same bits. Lengths and widths that are not multiples of L or 32 are
// masked. A block that polls a flag more than kMaxSpins times (a wait of
// a quarter of a second or more, against a launch of under a millisecond)
// traps rather than hang: the launch then fails with an error that the
// next synchronising call reports, never with quiet output. The flags, the
// counter and the carries live in a scratch that the caller allocates. The
// backward's reverse recurrence lam_t = g_t + a_{t+1} lam_{t+1} has the
// same form and can take the same blocks, walking the chunks from the end.
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
constexpr int kMaxChunk = 256;     // the longest chunk (its a and b: 64 KB of shared memory)
constexpr int kMinChunk = 32;      // the shortest chunk
constexpr int kTargetWarps = 640;  // blocks (warps) the chunks aim at
constexpr int kMaxSpins = 1 << 22; // polls of a predecessor's flag before the block traps
constexpr int kBwdAhead = 32;     // the backward: steps loaded ahead of the recurrence

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
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
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(counter, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int64_t width_groups = (width + kWarp - 1) / kWarp;
  const int64_t groups = batch_n * width_groups;
  const int64_t c = ticket / groups;
  const int64_t g = ticket - c * groups;
  const int64_t batch = g / width_groups;
  const int64_t w = (g - batch * width_groups) * kWarp + lane;
  const bool live = w < width;
  const int64_t t0 = c * chunk;
  const int n = static_cast<int>((t0 + chunk < seq ? t0 + chunk : seq) - t0);
  const int64_t base = (batch * seq + t0) * width + w;
  if (vec16) {
    // 16-byte copies: 8 lanes a 128-byte row, 4 rows at a time
    const int seg = lane & 7;
    const int64_t wseg = w - lane + seg * 4;
    if (wseg < width) {
      for (int k = lane >> 3; k < n; k += 4) {
        const int64_t off = (batch * seq + t0 + k) * width + wseg;
        cp_async16(sa + k * kWarp + seg * 4, a + off);
        cp_async16(sb + k * kWarp + seg * 4, b + off);
      }
    }
  } else if (live) {
    for (int k = 0; k < n; ++k) {
      cp_async4(sa + k * kWarp + lane, a + base + k * width);
      cp_async4(sb + k * kWarp + lane, b + base + k * width);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();  // the other lanes' copies of this lane's column
  float prod = 1.0f, agg = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float x = sa[k * kWarp + lane];
    agg = fmaf(x, agg, sb[k * kWarp + lane]);
    prod *= x;
  }
  float h_in = 0.0f;
  if (c > 0) {
    const int* flag = flags + (c - 1) * groups + g;
    int spins = 0;
    while (ld_acquire(flag) == 0) {
      if (++spins > kMaxSpins) __trap();
      __nanosleep(64);
    }
    h_in = live ? __ldcg(carry + ((c - 1) * batch_n + batch) * width + w) : 0.0f;
  }
  if (c + 1 < chunks) {
    if (live) __stcg(carry + (c * batch_n + batch) * width + w, fmaf(prod, h_in, agg));
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(flags + c * groups + g, 1);
  }
  float state = h_in;
  for (int k = 0; k < n; ++k) {
    state = fmaf(sa[k * kWarp + lane], state, sb[k * kWarp + lane]);
    if (live) h[base + k * width] = state;
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
// one thread owns one channel and walks S from the end to the start,
// reading a_{t+1} and h_{t-1} at an offset, and writes db and da in the
// same pass: 3 reads and 2 writes an element, no copy, no second pass.
//
// What bounds it: bytes, 5 * B*S*W * 4 (1.68 GB at B = 1, S = 32768,
// W = 2560: 0.50 ms at 3.35 TB/s). One thread a channel, one warp a
// block, and the loads of the next kBwdAhead steps (in reverse order) issued
// before the current kBwdAhead steps run, 3 * kBwdAhead loads in flight a
// thread. No atomics and one fixed order: two launches give the same bits.
// da may be null (its gradient not wanted); then only db is written.
__global__ void __launch_bounds__(kWarp)
lru_scan_bwd_f32(const float* __restrict__ a, const float* __restrict__ h, const float* __restrict__ g,
                 float* __restrict__ da, float* __restrict__ db, int64_t seq, int64_t width,
                 int64_t width_blocks) {
  const int64_t batch = blockIdx.x / width_blocks;
  const int64_t w = (blockIdx.x % width_blocks) * kWarp + threadIdx.x;
  if (w >= width) return;
  const int64_t base = batch * seq * width + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da == nullptr ? nullptr : da + base;
  float* dbp = db + base;

  // step k of a group that starts at t_hi is t = t_hi - k; what it reads:
  // g_t, a_{t+1} (0 past the end) and h_{t-1} (0 before the start)
  float g_next[kBwdAhead], a_next[kBwdAhead], h_next[kBwdAhead];
#pragma unroll
  for (int k = 0; k < kBwdAhead; ++k) {
    const int64_t t = seq - 1 - k;
    g_next[k] = t >= 0 ? __ldg(gp + t * width) : 0.0f;
    a_next[k] = t >= 0 && t + 1 < seq ? __ldg(ap + (t + 1) * width) : 0.0f;
    h_next[k] = t >= 1 ? __ldg(hp + (t - 1) * width) : 0.0f;
  }
  float lam = 0.0f;
  for (int64_t t_hi = seq - 1; t_hi >= 0; t_hi -= kBwdAhead) {
    float g_cur[kBwdAhead], a_cur[kBwdAhead], h_cur[kBwdAhead];
#pragma unroll
    for (int k = 0; k < kBwdAhead; ++k) {
      g_cur[k] = g_next[k];
      a_cur[k] = a_next[k];
      h_cur[k] = h_next[k];
    }
#pragma unroll
    for (int k = 0; k < kBwdAhead; ++k) {
      const int64_t t = t_hi - kBwdAhead - k;
      g_next[k] = t >= 0 ? __ldg(gp + t * width) : 0.0f;
      a_next[k] = t >= 0 ? __ldg(ap + (t + 1) * width) : 0.0f;
      h_next[k] = t >= 1 ? __ldg(hp + (t - 1) * width) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBwdAhead; ++k) {
      const int64_t t = t_hi - k;
      if (t >= 0) {
        lam = fmaf(a_cur[k], lam, g_cur[k]);
        dbp[t * width] = lam;
        if (dap != nullptr) dap[t * width] = lam * h_cur[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// The chunk length L of a forward launch over (batch, seq, width): the
// longest power of two from kMaxChunk down to kMinChunk at which
// batch * ceil(width / 32) * ceil(seq / L) warps reach kTargetWarps (or
// kMinChunk if none does); the launch runs C = ceil(seq / L) chunks.
int64_t lru_scan_chunk(int64_t batch, int64_t seq, int64_t width) {
  const int64_t groups = batch * ((width + 31) / 32);
  int64_t chunk = kMaxChunk;
  while (chunk > kMinChunk && groups * ((seq + chunk - 1) / chunk) < kTargetWarps) chunk /= 2;
  return chunk;
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
  const int64_t chunks = chunk >= 1 ? (seq + chunk - 1) / chunk : 0;
  const int64_t groups = batch * ((width + kWarp - 1) / kWarp);
  if (chunks < 1 || chunk > kMaxChunk || part == nullptr || chunks * groups > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* carry = part;
  int* flags = reinterpret_cast<int*>(part + batch * chunks * width);
  const size_t smem = static_cast<size_t>(2 * chunk * kWarp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lru_chunk_onepass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(2 * kMaxChunk * kWarp * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(flags, 0, static_cast<size_t>(chunks * groups + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need 16-byte addresses: every row of a and b starts on
  // one when W is a multiple of 4 and the tensors themselves do
  const bool vec16 = width % 4 == 0 && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  lru_chunk_onepass<<<static_cast<unsigned int>(chunks * groups), kWarp, smem, s>>>(
      a, b, h, carry, flags, flags + chunks * groups, batch, seq, width, chunk, chunks, vec16);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream`, allocates nothing, and returns the
// launch's cudaError_t. a and h are the forward's input and output, g the
// cotangent of h; da and db receive the gradients of a and b. All are
// device pointers to (batch, seq, width) contiguous float32 tensors; da
// may be null, and then only db is written. A grid of more than
// 2^31 - 1 blocks is refused with cudaErrorInvalidValue.
int lru_scan_bwd_launch(const float* a, const float* h, const float* g, float* da, float* db, int64_t batch,
                        int64_t seq, int64_t width, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const int64_t width_blocks = (width + kWarp - 1) / kWarp;
  const int64_t blocks = batch * width_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  lru_scan_bwd_f32<<<static_cast<unsigned int>(blocks), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, g, da, db, seq, width, width_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
