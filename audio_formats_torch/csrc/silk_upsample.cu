// The SILK 48 kHz polyphase upsample on Hopper (sm_90a): K13.
//
// af_silk_upsample replaces the JAX package's ops/resample.py:358
// _poly_conv_rows (a VALID conv_general_dilated at Precision.HIGHEST, an
// XLA convolution on the TPU), which BatchedFittedUpsampler.process runs
// once a packet step of the SILK and hybrid lockstep groups.  Contract, as
// the twin ops/resample.py:silk_upsample_torch:
//   x     [rows, W] f32    each row's native-rate window, W >= G + L - 1
//   h_rev [den, L] f32     the fitted polyphase taps, tap axis reversed
//                          (L = 96; den = 6, 4, 3 for NB, MB, WB)
//   out   [rows, G den] f32
//   out[r, g den + p] = sum_{k < L} x[r, g + k] h_rev[p, k],  g < G,
// summed k = 0..L-1 in order, in f32.
//
// What bounds it: at the SILK group's step (256 rows, G = 320, den 3) the
// work is 23.6 M multiply-adds and 1.4 MB, so the float32 pipe (~0.7 us)
// just outweighs the bytes (~0.4 us), and a launch (a few us) outweighs
// both.  The design keeps every operand of the multiply-adds in shared
// memory: a block takes a tile of kTileR rows x kTileG groups, stages the
// taps (at most 6 x 96 floats, rows padded to 97 so that the den phases a
// warp reads fall in distinct banks) and each row's input window (kTileG +
// L - 1 samples, read once from device memory, coalesced) and then runs one
// thread an output sample.  Neighbouring threads write neighbouring
// outputs, so the stores coalesce.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 96;
constexpr int kTapStride = kTaps + 1;
constexpr int kMaxDen = 6;
constexpr int kTileR = 2;
constexpr int kTileG = 64;
constexpr int kWin = kTileG + kTaps - 1;

__global__ void __launch_bounds__(kThreads)
silk_upsample_kernel(const float* __restrict__ x,
                     const float* __restrict__ h_rev, float* __restrict__ out,
                     int rows, int W, int G, int den) {
  __shared__ float taps[kMaxDen * kTapStride];
  __shared__ float win[kTileR * kWin];
  const int r0 = blockIdx.x * kTileR;
  const int g0 = blockIdx.y * kTileG;
  const int nr = min(kTileR, rows - r0);
  const int ng = min(kTileG, G - g0);
  const int nw = ng + kTaps - 1;
  for (int i = threadIdx.x; i < den * kTaps; i += kThreads) {
    const int p = i / kTaps;
    taps[p * kTapStride + (i - p * kTaps)] = h_rev[i];
  }
  for (int i = threadIdx.x; i < nr * kWin; i += kThreads) {
    const int rr = i / kWin;
    const int k = i - rr * kWin;
    if (k < nw) win[i] = x[static_cast<int64_t>(r0 + rr) * W + g0 + k];
  }
  __syncthreads();
  const int per = ng * den;  // a row's outputs in this tile
  for (int t = threadIdx.x; t < nr * per; t += kThreads) {
    const int rr = t / per;
    const int o = t - rr * per;
    const int g = o / den;
    const int p = o - g * den;
    const float* xs = win + rr * kWin + g;
    const float* hs = taps + p * kTapStride;
    float acc = 0.0f;
#pragma unroll 16
    for (int k = 0; k < kTaps; ++k) acc += xs[k] * hs[k];
    out[static_cast<int64_t>(r0 + rr) * G * den +
        static_cast<int64_t>(g0) * den + o] = acc;
  }
}

}  // namespace

extern "C" int af_silk_upsample(const void* x, const void* h_rev, void* out,
                                int rows, int W, int G, int den,
                                void* stream) {
  if (rows <= 0) return 0;
  if (den < 1 || den > kMaxDen || G < 1 || W < G + kTaps - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kTileR - 1) / kTileR, (G + kTileG - 1) / kTileG);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  silk_upsample_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h_rev),
      static_cast<float*>(out), rows, W, G, den);
  return static_cast<int>(cudaGetLastError());
}
