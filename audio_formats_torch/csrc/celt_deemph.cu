// The CELT deemphasis on Hopper (sm_90a): K12b.
//
// af_celt_deemph replaces the JAX package's ops/celt_dsp.py:85
// deemphasis_scan (a lax.associative_scan, an XLA stage on the TPU).
// Contract, as the twin ops/celt_dsp.py:deemphasis_scan_torch:
//   x  [B, n] f32, m0 [B] f32 (the carried memory, pre-multiplied by c)
//   y[i] = x[i] + v_i,  v_0 = m0,  v_{i+1} = c y[i]   (c = 0.85000610 f32)
//   out [B, n] f32 = y / 32768,  m [B] f32 = v_n = c y[n - 1]
// The twin steps the recurrence one sample at a time, each product and sum
// rounded to f32.  This file builds with -fmad=false, so each step here
// rounds the same way (c y, then x + c y).
//
// What bounds it: bytes (x read once, out written once: 8 bytes a sample);
// two float operations a sample are nothing beside them.  A row is a
// first-order recurrence, so the design runs one warp a row: each lane
// steps its contiguous chunk of ceil(n / 32) samples from a zero carry,
// keeping its chunk's transfer v_out = a v_in + b (a = c^len, b = the
// chunk's own exit carry); an inclusive warp scan of the (a, b) pairs
// (__shfl_up_sync, compose (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2))
// gives each lane its entry carry v_in = a m0 + b of the lanes before it;
// then each lane steps its chunk again from v_in, which is the twin's
// recurrence exactly wherever v_in is, and writes y / 32768.  Only the
// entry carries differ from the twin, by the scan's rounding, and c^k
// damps that within a few dozen samples.  The chunk's samples are read
// again for the second pass from L1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
celt_deemph_kernel(const float* __restrict__ x, const float* __restrict__ m0,
                   float* __restrict__ out, float* __restrict__ m_out, int B,
                   int n, float c) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // a whole warp leaves together
  const float* xr = x + static_cast<int64_t>(row) * n;
  float* yr = out + static_cast<int64_t>(row) * n;
  const int chunk = (n + 31) >> 5;
  const int s = min(n, lane * chunk);
  const int e = min(n, s + chunk);
  // pass 1: the chunk from a zero carry: its transfer (a, b)
  float a = 1.0f, b = 0.0f;
  for (int i = s; i < e; ++i) {
    b = __fmul_rn(c, __fadd_rn(__ldg(xr + i), b));
    a = __fmul_rn(a, c);
  }
  // inclusive scan of the transfers over the lanes
  for (int d = 1; d < 32; d <<= 1) {
    const float ao = __shfl_up_sync(kFull, a, d);
    const float bo = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      b = __fadd_rn(__fmul_rn(bo, a), b);
      a = __fmul_rn(ao, a);
    }
  }
  // the entry carry: the composition of the lanes before this one on m0
  const float ae = __shfl_up_sync(kFull, a, 1);
  const float be = __shfl_up_sync(kFull, b, 1);
  const float v0 = m0[row];
  float v = lane == 0 ? v0 : __fadd_rn(__fmul_rn(ae, v0), be);
  // pass 2: the twin's recurrence from the entry carry
  const float inv = 1.0f / 32768.0f;  // exact: a power of two
  for (int i = s; i < e; ++i) {
    const float y = __fadd_rn(__ldg(xr + i), v);
    yr[i] = __fmul_rn(y, inv);
    v = __fmul_rn(c, y);
  }
  if (e == n && e > s) m_out[row] = v;
  if (n == 0 && lane == 0) m_out[row] = v0;
}

}  // namespace

extern "C" int af_celt_deemph(const void* x, const void* m0, void* out,
                              void* m, int B, int n, float c, void* stream) {
  if (B <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + kWarps - 1) / kWarps;
  celt_deemph_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m0),
      static_cast<float*>(out), static_cast<float*>(m), B, n, c);
  return static_cast<int>(cudaGetLastError());
}
