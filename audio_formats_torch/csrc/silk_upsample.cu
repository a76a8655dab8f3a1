// The SILK 48 kHz polyphase upsample on Hopper (sm_90a): K13.
//
// af_silk_upsample replaces the JAX package's ops/resample.py:358
// _poly_conv_rows (a VALID conv_general_dilated at Precision.HIGHEST, an
// XLA convolution on the TPU), which BatchedFittedUpsampler.process runs
// once a packet step of the SILK and hybrid lockstep groups.  Contract, as
// the twin ops/resample.py:silk_upsample_torch:
//   x     [rows, W] f32    each row's native-rate window, W >= G + L - 1
//   taps  [den, L] f32     the fitted polyphase taps, tap axis reversed
//                          (h_rev; L = 96; den = 6, 4, 3 for NB, MB, WB),
//                          passed by value from the host
//   out   [rows, G den] f32
//   out[r, g den + p] = sum_{k < L} x[r, g + k] h_rev[p, k],  g < G,
// each output one f32 FMA chain, k = 0..L-1 in order from 0.
//
// What bounds it: the float32 pipe.  At 4,096 rows of a 20 ms step (960
// outputs a row) the work is 377 M multiply-adds against 22 MB, so the
// FMAs (11 us at 33.5 T/s) outweigh the bytes (7 us); at the SILK group's
// step (256 rows) a launch outweighs both.  So the design feeds the FMA
// pipe with as few other instructions as it can:
//   - the taps are the same for every thread: they travel as a by-value
//     kernel parameter (at most 6 x 96 floats, 2,304 bytes), the kernel is
//     a template on den with k unrolled, so each FFMA takes its tap from
//     the constant bank (through a uniform register) at an offset fixed
//     when compiling, with no shared load;
//   - a thread owns R consecutive groups of one row for all den phases
//     (R den = 12 outputs at den 3, 4 and 6) and slides the row's window
//     through registers: one shared load of x a tap feeds R den FFMAs;
//   - a block of 8 warps takes 32 rows x 8 R groups (at most 32): a warp
//     a row, each row's window is copied into shared memory (coalesced,
//     asynchronous, every copy in flight at once) at an odd row stride;
//     then the 32 lanes of a warp take the 32 rows, so a warp's loads fall
//     in 32 distinct banks, and every thread computes its outputs once
//     (none idles on a ragged pass); the outputs go back through shared
//     memory (odd stride again), a warp a row, so the stores coalesce.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kTaps = 96;
constexpr int kMaxDen = 6;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOuts = 12;  // outputs a thread: R groups x den phases

struct Taps {
  float h[kMaxDen * kTaps];
};

__host__ __device__ constexpr int odd(int n) { return n | 1; }

template <int DEN>
struct Tile {
  // R groups a thread, a tile's groups at most 32
  static constexpr int R = kOuts / DEN < 32 / kWarps ? kOuts / DEN
                                                     : 32 / kWarps;
  static constexpr int TG = kWarps * R;          // groups a tile
  static constexpr int S = odd(TG + kTaps - 1);  // a staged row's stride
  static constexpr int PER = TG * DEN;           // a row's outputs a tile
  static constexpr int SO = odd(PER);
};

// six blocks an SM (40 registers a thread): enough warps to cover the
// windows' copies and the stores of the others
template <int DEN>
__global__ void __launch_bounds__(kThreads, 6)
silk_upsample_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int rows, int W, int G, const Taps taps) {
  using T = Tile<DEN>;
  constexpr int R = T::R, TG = T::TG, S = T::S, SO = T::SO;
  __shared__ float win[32 * S];
  __shared__ float res[32 * SO];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * 32;
  const int g0 = blockIdx.y * TG;
  const int nr = min(32, rows - r0);
  const int ng = min(TG, G - g0);
  // a warp a row: the rows' windows by asynchronous copies, all in flight
  // at once; past a row's window, or past the last row, zeros
  for (int rr = warp; rr < 32; rr += kWarps) {
    const float* src = x + static_cast<int64_t>(r0 + rr) * W + g0;
    const int nw = rr < nr ? ng + kTaps - 1 : 0;
    for (int k = lane; k < S; k += 32) {
      if (k < nw)
        __pipeline_memcpy_async(win + rr * S + k, src + k, sizeof(float));
      else
        win[rr * S + k] = 0.0f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // lane: a row; warp: R groups of it
  const float* xs = win + lane * S + warp * R;
  float acc[R][DEN];
  float xw[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    xw[i] = xs[i];
#pragma unroll
    for (int p = 0; p < DEN; ++p) acc[i][p] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int p = 0; p < DEN; ++p)
        acc[i][p] = __fmaf_rn(xw[i], taps.h[p * kTaps + k], acc[i][p]);
    }
    if (k + 1 < kTaps) {
#pragma unroll
      for (int i = 0; i + 1 < R; ++i) xw[i] = xw[i + 1];
      xw[R - 1] = xs[R + k];
    }
  }
  float* mine = res + lane * SO + warp * R * DEN;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int p = 0; p < DEN; ++p) mine[i * DEN + p] = acc[i][p];
  }
  __syncthreads();
  // a warp a row again: the row's outputs of this tile, coalesced
  const int nout = ng * DEN;
  for (int rr = warp; rr < nr; rr += kWarps) {
    float* dst = out + (static_cast<int64_t>(r0 + rr) * G + g0) * DEN;
    for (int c = lane; c < nout; c += 32) dst[c] = res[rr * SO + c];
  }
}

template <int DEN>
int launch(const float* x, float* out, int rows, int W, int G,
           const Taps& taps, cudaStream_t stream) {
  const dim3 grid((rows + 31) / 32, (G + Tile<DEN>::TG - 1) / Tile<DEN>::TG);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  silk_upsample_kernel<DEN><<<grid, kThreads, 0, stream>>>(x, out, rows, W,
                                                           G, taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: den x 96 floats on the host (h_rev, row-major), copied into the
// kernel's parameter; den is 6, 4 or 3 (NB, MB, WB), the instances built.
extern "C" int af_silk_upsample(const void* x, const void* taps, void* out,
                                int rows, int W, int G, int den,
                                void* stream) {
  if (rows <= 0) return 0;
  if (den < 1 || den > kMaxDen || G < 1 || W < G + kTaps - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t = {};
  std::memcpy(t.h, taps, sizeof(float) * den * kTaps);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (den) {
    case 3: return launch<3>(xf, of, rows, W, G, t, s);
    case 4: return launch<4>(xf, of, rows, W, G, t, s);
    case 6: return launch<6>(xf, of, rows, W, G, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
