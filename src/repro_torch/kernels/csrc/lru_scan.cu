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
// carries h from tile to tile in VMEM. Blocks here run in no order, so the
// carry does not cross blocks: one thread owns one channel and walks the
// whole sequence in order, with one FMA a step. Neighbouring threads own
// neighbouring w, so each load and store of a warp is one 128-byte line.
// No atomics and one fixed order: two launches give the same bits.
//
// What bounds it on an H100: bytes. It reads a and b once and writes h
// once, 3 * B*S*W * 4 bytes (1.007 GB at the prefill shape B = 1,
// S = 32768, W = 2560: 0.30 ms at 3.35 TB/s), and does one FMA an element.
// The trouble is parallelism: at that shape there are only 2560 threads,
// so the kernel can keep few bytes in flight. The design does two things
// about it. A block is one warp, so W = 2560 spreads over 80 SMs instead of
// 20. And the loads of a and b for the next kAhead steps, which do not
// depend on h, are issued before the recurrence runs the current kAhead
// steps, so a thread has 2 * kAhead loads in flight while it computes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp a block
constexpr int kAhead = 32;    // steps of a and b loaded ahead of the recurrence

__global__ void __launch_bounds__(kThreads)
lru_scan_fwd_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
                 int64_t seq, int64_t width, int64_t width_blocks) {
  const int64_t batch = blockIdx.x / width_blocks;
  const int64_t w = (blockIdx.x % width_blocks) * kThreads + threadIdx.x;
  if (w >= width) return;
  const int64_t base = batch * seq * width + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;

  // the next group of kAhead steps, loaded while the current one runs
  float a_next[kAhead], b_next[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    a_next[k] = k < seq ? __ldg(ap + k * width) : 0.0f;
    b_next[k] = k < seq ? __ldg(bp + k * width) : 0.0f;
  }
  float state = 0.0f;
  for (int64_t t0 = 0; t0 < seq; t0 += kAhead) {
    float a_cur[kAhead], b_cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      a_cur[k] = a_next[k];
      b_cur[k] = b_next[k];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t t = t0 + kAhead + k;
      a_next[k] = t < seq ? __ldg(ap + t * width) : 0.0f;
      b_next[k] = t < seq ? __ldg(bp + t * width) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t t = t0 + k;
      if (t < seq) {
        state = fmaf(a_cur[k], state, b_cur[k]);
        hp[t * width] = state;
      }
    }
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
// W = 2560: 0.50 ms at 3.35 TB/s). The design is the forward's: one warp a
// block, and the loads of the next kAhead steps (in reverse order) issued
// before the current kAhead steps run, 3 * kAhead loads in flight a
// thread. No atomics and one fixed order: two launches give the same bits.
// da may be null (its gradient not wanted); then only db is written.
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_f32(const float* __restrict__ a, const float* __restrict__ h, const float* __restrict__ g,
                 float* __restrict__ da, float* __restrict__ db, int64_t seq, int64_t width,
                 int64_t width_blocks) {
  const int64_t batch = blockIdx.x / width_blocks;
  const int64_t w = (blockIdx.x % width_blocks) * kThreads + threadIdx.x;
  if (w >= width) return;
  const int64_t base = batch * seq * width + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da == nullptr ? nullptr : da + base;
  float* dbp = db + base;

  // step k of a group that starts at t_hi is t = t_hi - k; what it reads:
  // g_t, a_{t+1} (0 past the end) and h_{t-1} (0 before the start)
  float g_next[kAhead], a_next[kAhead], h_next[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int64_t t = seq - 1 - k;
    g_next[k] = t >= 0 ? __ldg(gp + t * width) : 0.0f;
    a_next[k] = t >= 0 && t + 1 < seq ? __ldg(ap + (t + 1) * width) : 0.0f;
    h_next[k] = t >= 1 ? __ldg(hp + (t - 1) * width) : 0.0f;
  }
  float lam = 0.0f;
  for (int64_t t_hi = seq - 1; t_hi >= 0; t_hi -= kAhead) {
    float g_cur[kAhead], a_cur[kAhead], h_cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      g_cur[k] = g_next[k];
      a_cur[k] = a_next[k];
      h_cur[k] = h_next[k];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t t = t_hi - kAhead - k;
      g_next[k] = t >= 0 ? __ldg(gp + t * width) : 0.0f;
      a_next[k] = t >= 0 ? __ldg(ap + (t + 1) * width) : 0.0f;
      h_next[k] = t >= 1 ? __ldg(hp + (t - 1) * width) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
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

// Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 = success). a, b and h are device pointers to
// (batch, seq, width) contiguous float32 tensors; h is written whole.
// A grid of more than 2^31 - 1 blocks is refused with
// cudaErrorInvalidValue.
int lru_scan_fwd_launch(const float* a, const float* b, float* h, int64_t batch, int64_t seq,
                        int64_t width, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const int64_t width_blocks = (width + kThreads - 1) / kThreads;
  const int64_t blocks = batch * width_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  lru_scan_fwd_f32<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, seq, width, width_blocks);
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
  const int64_t width_blocks = (width + kThreads - 1) / kThreads;
  const int64_t blocks = batch * width_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  lru_scan_bwd_f32<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, g, da, db, seq, width, width_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
