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
// [ls, ls + min(lap_len, n - ls)) y_mix = y wf + lap[min(j, h - 1)] wr, with
// j = t - ls, w the slope of width lw (bs1/2 when lap_len == bs1/2, else
// bs0/2), wf = w[min(j, lw - 1)] and wr = w[max(lw - 1 - j, 0)]; y
// elsewhere, zero past n; pcm = y_mix[ls:] up to out_len = had_prev ?
// rs - ls : 0, zero after; the new lap is y_mix[rs:re], zero past re - rs.
// A slot with valid 0 emits zeros and leaves the carry as it was.
//
// What bounds it: bytes.  A window reads each valid slot's IMDCT row over
// [ls, re) once and writes every PCM row (the slice's first window: 64.4 MB,
// 0.0192 ms at 3.35 TB/s).  The first version ran one block a lane-channel
// through its K slots in order, a barrier a slot and 4-byte loads: a slot's
// loads left only after the previous slot's barrier, ~8 dependent trips to
// memory a block.  The design:
//   * the slots of a lane are computed side by side.  In a stream whose
//     geometry is the spec's, a slot's mix ends at or before the previous
//     slot's rs, so the lap a slot mixes with is the raw IMDCT row
//     y[rs : re] of the lane's last valid slot before it (or the carry when
//     there is none), and the new carry is the last valid slot's raw
//     y[rs : re].  One block a lane-channel copies the lane's K geometry
//     into shared memory (a few dozen int32), one thread walks it once (is
//     the lane chained, each slot's previous valid slot, the last one), and
//     then the block's threads run over the K PCM rows as one flat range of
//     16-byte vectors, two in flight a thread, with no barrier between
//     slots;
//   * a lane whose lap' depends on the lap it mixes with (some slot's mix
//     reaches past its rs: what a damaged stream's geometry gives), or whose
//     geometry is not the spec's forms (edges that are not multiples of 4,
//     a lap width other than bs0/2 or bs1/2, rows not 16-byte aligned), is
//     chained: its block runs its K slots in order, the lap in two shared
//     buffers, a barrier a slot.  Both paths compute the same y_mix in the
//     same order: the serial one is the exact chain, not a second kernel;
//   * on the parallel path every edge is a multiple of 4 floats, so a
//     vector lies wholly inside or outside the mix, the PCM and the row; the
//     slopes come through the read-only cache (5 KB that stay resident), the
//     reversed one as a vector read backwards.
// One block a lane-channel (512 on the slice's window), not one a slot
// (4,096): a block a slot paid the geometry's round trip to memory before
// its own, with 64 registers a thread 4 blocks fit an SM, and the card ran
// ~8 waves of them.  The flat range over the K rows keeps the loads of one
// trip independent of the last trip's stores; a loop a slot, fewer
// instructions a vector, ran slower (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors a thread has in flight

struct Geo {
  int ls, rs, re, n;
  bool is_short;
};

// slot k's geometry from the block's copy: s_geo [4][K] = valid, ls, rs, re
__device__ __forceinline__ Geo slot_geo(const int* s_geo, int K, int k,
                                        int bs0, int bs1) {
  Geo g;
  g.ls = s_geo[K + k];
  g.rs = s_geo[2 * K + k];
  g.re = s_geo[3 * K + k];
  g.is_short = g.rs == bs0 / 2 && g.re == bs0;
  g.n = g.is_short ? bs0 : bs1;
  return g;
}

__device__ __forceinline__ const float* slot_row(
    const float* __restrict__ y1, const float* __restrict__ y0, int k, int L,
    int l, int bs0, int bs1, bool is_short) {
  return is_short ? y0 + (static_cast<int64_t>(k) * L + l) * bs0
                  : y1 + (static_cast<int64_t>(k) * L + l) * bs1;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// y wf + lap wr, the slopes' reversed vector read backwards
__device__ __forceinline__ float4 mix4(float4 y, float4 lap, float4 wf,
                                       float4 wr) {
  return make_float4(y.x * wf.x + lap.x * wr.w, y.y * wf.y + lap.y * wr.z,
                     y.z * wf.z + lap.z * wr.y, y.w * wf.w + lap.w * wr.x);
}

// The exact chain of lane-channel l through its K slots (the chained lanes)
__device__ void serial_chain(
    const float* __restrict__ y1, const float* __restrict__ y0,
    const int* s_geo, const float* __restrict__ lap_in,
    const float* __restrict__ slopes, float* __restrict__ pcm,
    float* __restrict__ lap_out, int lap_len, int had_prev, int K, int L,
    int l, int bs0, int bs1, float* s_lap) {
  const int h0 = bs0 / 2, h = bs1 / 2;
  float* lap = s_lap;
  float* nxt = s_lap + h;
  for (int j = threadIdx.x; j < h; j += kThreads)
    lap[j] = lap_in[static_cast<int64_t>(l) * h + j];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float* o = pcm + (static_cast<int64_t>(k) * L + l) * bs1;
    if (!s_geo[k]) {
      for (int j = threadIdx.x; j < bs1; j += kThreads) o[j] = 0.0f;
      continue;
    }
    const Geo g = slot_geo(s_geo, K, k, bs0, bs1);
    const float* y = slot_row(y1, y0, k, L, l, bs0, bs1, g.is_short);
    const bool wide = lap_len == h;
    const int lw = wide ? h : h0;
    const float* w = wide ? slopes + h0 : slopes;
    const int mix_end = g.ls + min(lap_len, g.n - g.ls);
    const auto y_mix = [&](int t) -> float {
      if (t < 0 || t >= g.n) return 0.0f;
      const float yt = __ldg(y + t);
      if (t < g.ls || t >= mix_end) return yt;
      const int j = t - g.ls;
      return yt * w[min(j, lw - 1)] +
             lap[min(j, h - 1)] * w[max(lw - 1 - j, 0)];
    };
    const int out_len = had_prev ? g.rs - g.ls : 0;
    for (int j = threadIdx.x; j < bs1; j += kThreads)
      o[j] = j < out_len ? y_mix(g.ls + j) : 0.0f;
    const int nw = g.re - g.rs;
    for (int j = threadIdx.x; j < h; j += kThreads)
      nxt[j] = j < nw ? y_mix(g.rs + j) : 0.0f;
    __syncthreads();
    float* tmp = lap;
    lap = nxt;
    nxt = tmp;
    lap_len = nw;
    had_prev = 1;
  }
  for (int j = threadIdx.x; j < h; j += kThreads)
    lap_out[static_cast<int64_t>(l) * h + j] = lap[j];
}

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
                  float* __restrict__ lap_out,
                  int32_t* __restrict__ lap_len_out,
                  int32_t* __restrict__ had_prev_out, int K, int L, int ch,
                  int bs0, int bs1) {
  // shared: the lane's geometry [4][K] (valid, ls, rs, re), each slot's
  // previous valid slot [K], then the serial path's two laps
  extern __shared__ int smem[];
  int* const s_geo = smem;
  int* const s_pred = smem + 4 * K;
  float* const s_lap = reinterpret_cast<float*>(smem + 5 * K);
  __shared__ int s_serial, s_last, s_last_nw;
  const int l = blockIdx.x;
  const int b = l / ch;
  const int B = L / ch;
  const int h0 = bs0 / 2, h = bs1 / 2;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const int kb = i * B + b;
    s_geo[i] = __ldg(valid_a + kb);
    s_geo[K + i] = __ldg(ls_a + kb);
    s_geo[2 * K + i] = __ldg(rs_a + kb);
    s_geo[3 * K + i] = __ldg(re_a + kb);
  }
  const int lap_len0 = __ldg(lap_len_in + b);
  const int had_prev0 = __ldg(had_prev_in + b);
  const bool write_meta = l % ch == 0 && threadIdx.x == 0;
  __syncthreads();

  // one thread walks the lane's slots: is the lane chained, each slot's
  // previous valid slot, the last one; rows that are not 16-byte aligned
  // take the serial path too
  if (threadIdx.x == 0) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(y1) |
                            reinterpret_cast<uintptr_t>(y0) |
                            reinterpret_cast<uintptr_t>(lap_in) |
                            reinterpret_cast<uintptr_t>(slopes) |
                            reinterpret_cast<uintptr_t>(pcm) |
                            reinterpret_cast<uintptr_t>(lap_out);
    bool serial = ((bases & 15) | ((h0 | h) & 3)) != 0 ||
                  !(lap_len0 == 0 || lap_len0 == h0 || lap_len0 == h);
    int last = -1, lap_len = lap_len0, last_nw = 0;
    for (int kk = 0; kk < K; ++kk) {
      s_pred[kk] = last;
      if (!s_geo[kk]) continue;
      const Geo g = slot_geo(s_geo, K, kk, bs0, bs1);
      const int nw = g.re - g.rs;
      const int mix_len = min(lap_len, g.n - g.ls);
      // lap' = y_mix[rs, rs + min(nw, h)) meets the mix [ls, ls + mix_len)
      const bool chained = nw > 0 && mix_len > 0 &&
                           max(g.rs, g.ls) < min(g.rs + min(nw, h),
                                                 g.ls + mix_len);
      const bool spec = ((g.ls | g.rs | g.re) & 3) == 0 && 0 <= g.ls &&
                        g.ls <= g.rs && g.rs <= g.re && g.re <= g.n &&
                        (nw == h0 || nw == h);
      serial = serial || chained || !spec;
      last = kk;
      last_nw = nw;
      lap_len = nw;
    }
    s_serial = serial;
    s_last = last;
    s_last_nw = last_nw;
  }
  __syncthreads();
  const int last = s_last;

  if (s_serial) {
    serial_chain(y1, y0, s_geo, lap_in, slopes, pcm, lap_out, lap_len0,
                 had_prev0, K, L, l, bs0, bs1, s_lap);
  } else {
    // every slot's PCM row at once: the flat index runs over K rows of nv
    // 16-byte vectors, two vectors a thread in flight
    const int nv = bs1 >> 2;
    const int total = K * nv;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kUnroll) {
      float4 yv[kUnroll], lv[kUnroll], wf[kUnroll], wr[kUnroll];
      int cls[kUnroll];  // 0 none, 1 zero, 2 raw, 3 mixed
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        cls[u] = 0;
        if (i >= total) continue;
        const int k = i / nv;
        const int v = i - k * nv;
        cls[u] = 1;
        if (!s_geo[k]) continue;
        const Geo g = slot_geo(s_geo, K, k, bs0, bs1);
        const int p = s_pred[k];
        const int out_len = (p >= 0 || had_prev0) ? g.rs - g.ls : 0;
        if (4 * v >= out_len) continue;
        yv[u] = ld4(slot_row(y1, y0, k, L, l, bs0, bs1, g.is_short) + g.ls +
                    4 * v);
        cls[u] = 2;
        // the lap: the previous valid slot's raw row from its rs, or the
        // carry
        const Geo q = slot_geo(s_geo, K, max(p, 0), bs0, bs1);
        const int lap_k = p >= 0 ? q.re - q.rs : lap_len0;
        if (4 * v >= min(lap_k, g.n - g.ls)) continue;
        const float* lapp =
            p >= 0 ? slot_row(y1, y0, p, L, l, bs0, bs1, q.is_short) + q.rs
                   : lap_in + static_cast<int64_t>(l) * h;
        const int lw = lap_k == h ? h : h0;
        const float* w = lap_k == h ? slopes + h0 : slopes;
        lv[u] = ld4(lapp + 4 * v);
        wf[u] = ld4(w + 4 * v);
        wr[u] = ld4(w + lw - 4 - 4 * v);
        cls[u] = 3;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!cls[u]) continue;
        const int i = i0 + u * kThreads;
        const int k = i / nv;
        st4(pcm + (static_cast<int64_t>(k) * L + l) * bs1 + 4 * (i - k * nv),
            cls[u] == 3   ? mix4(yv[u], lv[u], wf[u], wr[u])
            : cls[u] == 2 ? yv[u]
                          : zero);
      }
    }
    // the new carry: the last valid slot's y_mix[rs : re], past its mix
    // here, or the carry as it was
    float* dst = lap_out + static_cast<int64_t>(l) * h;
    if (last >= 0) {
      const Geo g = slot_geo(s_geo, K, last, bs0, bs1);
      const float* y = slot_row(y1, y0, last, L, l, bs0, bs1, g.is_short);
      const int nw = g.re - g.rs;
      for (int v = threadIdx.x; v < (h >> 2); v += kThreads)
        st4(dst + 4 * v, 4 * v < nw ? ld4(y + g.rs + 4 * v) : zero);
    } else {
      const float* src = lap_in + static_cast<int64_t>(l) * h;
      for (int v = threadIdx.x; v < (h >> 2); v += kThreads)
        st4(dst + 4 * v, ld4(src + 4 * v));
    }
  }
  if (write_meta) {
    lap_len_out[b] = last < 0 ? lap_len0 : s_last_nw;
    had_prev_out[b] = last < 0 ? had_prev0 : 1;
  }
}

// the dynamic shared memory the kernel has been allowed, per device
int g_smem_allowed[64];

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Launches one kernel without synchronising and returns
// cudaGetLastError() (0 on success).  The outputs must not alias the
// inputs: every block of a lane reads its geometry and carry.
extern "C" int af_vorbis_win(const void* y1, const void* y0, const void* ls,
                             const void* rs, const void* re, const void* valid,
                             const void* lap, const void* lap_len,
                             const void* had_prev, const void* slopes,
                             void* pcm, void* lap_out, void* lap_len_out,
                             void* had_prev_out, int K, int L, int ch, int bs0,
                             int bs1, void* stream) {
  if (L <= 0 || K <= 0) return 0;
  if (ch <= 0 || L % ch || bs0 < 2 || bs1 < bs0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the lane's geometry and each slot's previous valid slot, then two laps
  const int smem = static_cast<int>(5 * K * sizeof(int) + bs1 * sizeof(float));
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (g_smem_allowed[dev] < smem) {
      e = cudaFuncSetAttribute(vorbis_win_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      g_smem_allowed[dev] = smem;
    }
  }
  vorbis_win_kernel<<<L, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
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
