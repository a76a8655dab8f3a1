// The Vorbis lapped-window chain on Hopper (sm_90a): K11.
//
// af_vorbis_win replaces the JAX package's ops/vorbis_win.py:
// vorbis_window_chain after its IMDCT matmuls (the lax.scan over a window's
// K packet slots, an XLA loop on the TPU).  Contract, as the twin
// ops/vorbis_win.py:lap_chain_torch:
//   y1 [K, L, bs1] f32  every slot's long IMDCT; y0 [K, L, bs0] its short one
//   ls, rs, re, valid [K, B] int32 (B = L / ch lanes, lane-major channels)
//   lap [L, bs1/2] f32, lap_len [B], had_prev [B] int32: the carry
//   slopes [bs0/2 + bs1/2] f32: slope(bs0/2) then slope(bs1/2)
// For each slot, on every lane-channel: y is the short IMDCT (zero past
// bs0) when rs == bs0/2 and re == bs0, else the long one; over
// [ls, ls + min(lap_len, n - ls)) y_mix = y w[j] + lap[j] w[lw - 1 - j]
// (j = t - ls, lw = lap_len's slope width), y elsewhere, zero past bs1;
// pcm = y_mix[ls:] up to out_len = had_prev ? rs - ls : 0, zero after;
// the new lap is y_mix[rs:re], zero past re - rs.  A slot with valid 0
// emits zeros and leaves the carry as it was.
//
// One block a lane-channel runs the K slots in order with its lap in shared
// memory (two buffers of bs1/2 floats, the old one read while the new one
// is written).  Offsets are plain indexes (the TPU's rolled copies and
// selects are not needed).  The work is bound by bytes: each slot reads one
// IMDCT row and writes one PCM row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vorbis_win_kernel(const float* __restrict__ y1, const float* __restrict__ y0,
                  const int32_t* __restrict__ ls_a,
                  const int32_t* __restrict__ rs_a,
                  const int32_t* __restrict__ re_a,
                  const int32_t* __restrict__ valid_a,
                  const float* __restrict__ lap_in,
                  const int32_t* __restrict__ lap_len_in,
                  const int32_t* __restrict__ had_prev_in,
                  const float* __restrict__ slopes, float* __restrict__ pcm,
                  float* __restrict__ lap_out, int32_t* __restrict__ lap_len_out,
                  int32_t* __restrict__ had_prev_out, int K, int L, int ch,
                  int bs0, int bs1) {
  extern __shared__ float smem[];
  const int l = blockIdx.x;
  const int b = l / ch;
  const int B = L / ch;
  const int h0 = bs0 / 2, h = bs1 / 2;
  float* lap = smem;
  float* nxt = smem + h;
  for (int j = threadIdx.x; j < h; j += kThreads)
    lap[j] = lap_in[static_cast<int64_t>(l) * h + j];
  int lap_len = lap_len_in[b];
  int had_prev = had_prev_in[b];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float* o = pcm + (static_cast<int64_t>(k) * L + l) * bs1;
    const int kb = k * B + b;
    if (!valid_a[kb]) {
      for (int j = threadIdx.x; j < bs1; j += kThreads) o[j] = 0.0f;
      continue;
    }
    const int ls = ls_a[kb], rs = rs_a[kb], re = re_a[kb];
    const bool is_short = rs == h0 && re == bs0;
    const int n = is_short ? bs0 : bs1;
    const float* y = is_short ? y0 + (static_cast<int64_t>(k) * L + l) * bs0
                              : y1 + (static_cast<int64_t>(k) * L + l) * bs1;
    const int lw = lap_len == h ? h : h0;
    const float* w = lap_len == h ? slopes + h0 : slopes;
    const int mix_end = ls + min(lap_len, n - ls);
    const auto y_mix = [&](int t) -> float {
      if (t >= n) return 0.0f;
      const float yt = __ldg(y + t);
      if (t < ls || t >= mix_end) return yt;
      const int j = t - ls;
      return yt * w[j] + lap[j] * w[lw - 1 - j];
    };
    const int out_len = had_prev ? rs - ls : 0;
    for (int j = threadIdx.x; j < bs1; j += kThreads)
      o[j] = j < out_len ? y_mix(ls + j) : 0.0f;
    const int nw = re - rs;
    for (int j = threadIdx.x; j < h; j += kThreads)
      nxt[j] = j < nw ? y_mix(rs + j) : 0.0f;
    __syncthreads();
    float* tmp = lap;
    lap = nxt;
    nxt = tmp;
    lap_len = nw;
    had_prev = 1;
  }
  for (int j = threadIdx.x; j < h; j += kThreads)
    lap_out[static_cast<int64_t>(l) * h + j] = lap[j];
  if (l % ch == 0 && threadIdx.x == 0) {
    lap_len_out[b] = lap_len;
    had_prev_out[b] = had_prev;
  }
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Launches without synchronising and returns
// cudaGetLastError() (0 on success).  The outputs must not alias the
// inputs: every lane's channels read lap_len and had_prev.
extern "C" int af_vorbis_win(const void* y1, const void* y0, const void* ls,
                             const void* rs, const void* re, const void* valid,
                             const void* lap, const void* lap_len,
                             const void* had_prev, const void* slopes,
                             void* pcm, void* lap_out, void* lap_len_out,
                             void* had_prev_out, int K, int L, int ch, int bs0,
                             int bs1, void* stream) {
  if (L <= 0) return 0;
  if (ch <= 0 || L % ch || bs0 < 2 || bs1 < bs0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bs1 * static_cast<int>(sizeof(float));  // two laps
  const cudaError_t e = cudaFuncSetAttribute(
      vorbis_win_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  vorbis_win_kernel<<<L, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y1), static_cast<const float*>(y0),
      static_cast<const int32_t*>(ls), static_cast<const int32_t*>(rs),
      static_cast<const int32_t*>(re), static_cast<const int32_t*>(valid),
      static_cast<const float*>(lap), static_cast<const int32_t*>(lap_len),
      static_cast<const int32_t*>(had_prev), static_cast<const float*>(slopes),
      static_cast<float*>(pcm), static_cast<float*>(lap_out),
      static_cast<int32_t*>(lap_len_out), static_cast<int32_t*>(had_prev_out),
      K, L, ch, bs0, bs1);
  return static_cast<int>(cudaGetLastError());
}
