// The CELT windowed overlap-add on Hopper (sm_90a): K12a.
//
// af_celt_ola replaces the JAX package's ops/celt_dsp.py:celt_imdct_ola
// after its IMDCT einsum (the overlap-add unrolled over the blocks, an XLA
// fusion on the TPU).  Contract, as the twin ops/celt_dsp.py:celt_ola_torch:
//   halves [B, blocks, bs] f32  each block's IMDCT half-transform (bs >= 120)
//   tail   [B, 60] f32          the raw tail carried from the previous frame
//   win    [120] f32            the CELT window
//   out    [B, blocks * bs] f32, new_tail [B, 60] f32
// With b0[u] the previous raw sample (tail[u] for block 0, else the
// previous block's halves[bs - 60 + u]), b1[u] = halves[j][59 - u], u < 60:
//   out[j bs + u]       = fma(b0, win[119 - u], -(b1 win[u]))
//   out[j bs + 119 - u] = fma(b1, win[119 - u],   b0 win[u])
//   out[j bs + 120 + i] = halves[j][60 + i]
//   new_tail[u]         = halves[blocks - 1][bs - 60 + u]
// Each product rounds to f32 and each FMA once: the form XLA computes on
// the CPU, where it contracts the reference's b0 w[119-u] - b1 w[u] and
// b0 w[u] + b1 w[119-u].  So this file builds with -fmad=false and writes
// both FMAs out; the kernel is then bit-equal to its twin.
//
// What bounds it: bytes (each IMDCT sample and the tail read once, the
// output and the new tail written once: 8 bytes a sample), and at a
// bucket's size (a few hundred rows of 480 or 960 samples, ~1 MB) the
// launch.  Because bs >= 120, every output sample depends on at most two
// inputs, so the block loop of the reference carries nothing: one thread
// an output sample (or a new-tail sample), in a flat grid over the rows,
// each reading its one or two inputs.  Neighbouring threads read
// neighbouring addresses (b1 backwards), so the loads coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = 60;
constexpr int kOverlap = 120;

__global__ void __launch_bounds__(kThreads)
celt_ola_kernel(const float* __restrict__ halves,
                const float* __restrict__ tail, const float* __restrict__ win,
                float* __restrict__ out, float* __restrict__ new_tail,
                int64_t total, int blocks, int bs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int frame = blocks * bs;
  const int per = frame + kHalf;  // a row's outputs: the frame, then the tail
  const int64_t r = i / per;
  const int t = static_cast<int>(i - r * per);
  const float* h = halves + r * frame;
  if (t >= frame) {
    const int u = t - frame;
    new_tail[r * kHalf + u] = h[frame - kHalf + u];
    return;
  }
  const int j = t / bs;
  const int p = t - j * bs;
  float v;
  if (p >= kOverlap) {
    v = h[t - kHalf];  // halves[j][p - 60]
  } else {
    const bool lo = p < kHalf;
    const int u = lo ? p : kOverlap - 1 - p;
    const float b0 = j == 0 ? tail[r * kHalf + u] : h[t - p - kHalf + u];
    const float b1 = h[j * bs + kHalf - 1 - u];
    const float w_up = win[u], w_down = win[kOverlap - 1 - u];
    v = lo ? __fmaf_rn(b0, w_down, -__fmul_rn(b1, w_up))
           : __fmaf_rn(b1, w_down, __fmul_rn(b0, w_up));
  }
  out[r * frame + t] = v;
}

}  // namespace

extern "C" int af_celt_ola(const void* halves, const void* tail,
                           const void* win, void* out, void* new_tail, int B,
                           int blocks, int bs, void* stream) {
  if (B <= 0) return 0;
  if (blocks < 1 || bs < kOverlap)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total =
      static_cast<int64_t>(B) * (static_cast<int64_t>(blocks) * bs + kHalf);
  const int64_t grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  celt_ola_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(halves), static_cast<const float*>(tail),
      static_cast<const float*>(win), static_cast<float*>(out),
      static_cast<float*>(new_tail), total, blocks, bs);
  return static_cast<int>(cudaGetLastError());
}
