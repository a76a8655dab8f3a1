// CELT's IMDCT and windowed overlap-add on Hopper (sm_90a): K12a.
//
// Replaces the JAX package's ops/celt_dsp.py:46 celt_imdct_ola (the IMDCT
// einsum and the overlap-add unrolled over the blocks, XLA on the TPU).
// Both entries write JAX's own layout, a row's packed [frame + 60] f32
// buffer: the frame's output, then the raw tail carried to the next frame
// (buf[:, :frame + 60] of the reference).  With halves[j] block j's IMDCT
// half-transform (bs samples), tail the carried tail, w the CELT window,
// b0[u] the previous raw sample (tail[u] for block 0, else halves[j -
// 1][bs - 60 + u]) and b1[u] = halves[j][59 - u], u < 60:
//   out[j bs + u]       = fma(b0, w[119 - u], -(b1 w[u]))
//   out[j bs + 119 - u] = fma(b1, w[119 - u],   b0 w[u])
//   out[j bs + 120 + i] = halves[j][60 + i]
//   out[frame + u]      = halves[blocks - 1][bs - 60 + u]   (the new tail)
// Each product rounds to f32 and each FMA once: the form XLA computes on
// the CPU, where it contracts the reference's b0 w[119-u] - b1 w[u] and
// b0 w[u] + b1 w[119-u].  So this file builds with -fmad=false and writes
// every FMA out.
//
// af_celt_ola (blocks of bs >= 240, a long block): the halves are already
// in place, at columns [60, 60 + frame) of the packed buffer (the IMDCT
// matmul writes them there), so only each block's first 120 samples
// change.  One thread takes a pair u < 60: it reads tail[u] (or the
// previous block's raw sample at buf[j bs + u]) and buf[j bs + 119 - u],
// and writes buf[j bs + u] and buf[j bs + 119 - u]: no two threads touch
// one sample, and since bs >= 120 no block's pairs reach another's.  It
// moves 240 floats a row and the tail's 60; bytes bound it, and at a
// bucket's size the launch.
//
// af_celt_imdct_ola (bs == 120: every short-block frame, and LM0): the
// whole stage in one launch, from the interleaved spectra to the packed
// buffer; the halves never reach device memory.  The function's bound is
// its bytes: a fast IMDCT (an FFT of 60 points) needs about a tenth of the
// dense product's 120 multiply-adds a sample, and the route is held to its
// twin within a tolerance, not to a summation order.  The kernel does the
// dense product, and shared memory's 128 bytes a cycle is what keeps it
// from the float32 pipe's rate: each multiply-add needs a coefficient and
// a basis value.  A block stages the transposed
// basis (120 x 120 f32, 57,600 bytes) once in dynamic shared memory, by
// asynchronous copies, and walks over tiles of 32 blocks of 120
// coefficients (whole rows: 32 / blocks of them).  A tile's coefficients
// are de-interleaved (X[j][k] = coeffs[k blocks + j]) and scaled into
// shared memory, rows of 124 floats, each thread's 16-byte loads all in
// flight at once.  A warp takes 8 blocks and its lane 4 outputs: the 8
// blocks' coefficients are the same for every lane, so their 16-byte
// loads are broadcasts, and each lane's 16-byte load of 4 basis values
// feeds 32 FMAs.  The dot products run k = 0..119 in order (not cuBLAS's
// order: the route is held to its twin within 1e-6 of the peak, not bit
// for bit).  The halves go back into the tile's shared memory; then 120
// threads each take one pair u < 60 of every second block, the window's
// two values in registers and the tail samples read while the tile was
// staged, and write the pair's two samples of the packed rows.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHalf = 60;
constexpr int kOverlap = 120;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- bs >= 240
constexpr int kPairRows = 4;  // rows a block of the in-place mix

__global__ void __launch_bounds__(kHalf * kPairRows)
celt_ola_kernel(float* __restrict__ buf, const float* __restrict__ tail,
                const float* __restrict__ win, int B, int bs, int ld) {
  __shared__ float ws[kOverlap];
  const int tid = threadIdx.y * kHalf + threadIdx.x;
  if (tid < kOverlap) ws[tid] = win[tid];
  __syncthreads();
  const int r = blockIdx.x * kPairRows + threadIdx.y;
  if (r >= B) return;
  const int j = blockIdx.y;
  const int u = threadIdx.x;
  float* row = buf + static_cast<int64_t>(r) * ld + static_cast<int64_t>(j) *
                                                       bs;
  const float b0 = j == 0 ? tail[static_cast<int64_t>(r) * kHalf + u] : row[u];
  const float b1 = row[kOverlap - 1 - u];
  const float w_up = ws[u], w_down = ws[kOverlap - 1 - u];
  row[u] = __fmaf_rn(b0, w_down, -__fmul_rn(b1, w_up));
  row[kOverlap - 1 - u] = __fmaf_rn(b1, w_down, __fmul_rn(b0, w_up));
}

// ---------------------------------------------------------------- bs == 120
constexpr int kN = kOverlap;  // the short block
constexpr int kTileV = 32;    // blocks of 120 a tile
constexpr int kXK = 124;      // a staged block's row stride, floats
constexpr int kWarpV = 8;     // blocks a warp
constexpr int kThreadsI = 32 * kTileV / kWarpV;
constexpr int kSmemI = (kN * kN + kTileV * kXK) * 4;
constexpr int kMixIt = kTileV / 2;  // blocks a mix thread takes a tile

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// two blocks an SM: registers for the 8 x 4 sums and two k-steps' operands
template <int BLOCKS>
__global__ void __launch_bounds__(kThreadsI, 2)
celt_imdct_ola_kernel(const float* __restrict__ co,
                      const float* __restrict__ tail,
                      const float* __restrict__ basis_t,
                      const float* __restrict__ win, float* __restrict__ out,
                      int B, float scale) {
  extern __shared__ float4 smem4[];
  float* mt = reinterpret_cast<float*>(smem4);  // [k][m]: M[m][k]
  float* xs = mt + kN * kN;                      // [v][kXK]: X, then halves
  constexpr int T = kThreadsI;
  constexpr int RT = kTileV / BLOCKS;  // rows a tile
  constexpr int FRAME = BLOCKS * kN;
  constexpr int PER = FRAME + kHalf;   // a packed row
  constexpr int NX = kTileV * kN / 4;  // the tile's float4s
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wv = (tid >> 5) * kWarpV;  // the warp's first block
  const bool mixer = tid < 2 * kHalf;  // the mix's threads: (half, u)
  const int half = tid < kHalf ? 0 : 1;
  const int u = tid - half * kHalf;
  for (int i = tid; i < kN * kN / 4; i += T)
    __pipeline_memcpy_async(smem4 + i,
                            reinterpret_cast<const float4*>(basis_t) + i, 16);
  __pipeline_commit();
  const float w_up = mixer ? win[u] : 0.0f;
  const float w_down = mixer ? win[kOverlap - 1 - u] : 0.0f;
  const int ntiles = (B + RT - 1) / RT;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * RT;
    const int nr = min(RT, B - r0);
    __syncthreads();  // the last tile's mix is done with xs
    // the tile's coefficients: every 16-byte load in flight at once, then
    // each value scaled into its block's row (de-interleaved)
    const float4* src =
        reinterpret_cast<const float4*>(co + static_cast<int64_t>(r0) * FRAME);
    float4 cv[(NX + T - 1) / T];
#pragma unroll
    for (int it = 0; it < (NX + T - 1) / T; ++it) {
      const int i = it * T + tid;
      cv[it] = i < NX && i * 4 < nr * FRAME
                   ? src[i]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // meanwhile the tail samples that this thread mixes into the rows'
    // first blocks
    float b0t[kMixIt];
#pragma unroll
    for (int it = 0; it < kMixIt; ++it) {
      const int v = 2 * it + half;
      const int rr = v / BLOCKS;
      b0t[it] = mixer && v % BLOCKS == 0 && rr < nr
                    ? tail[static_cast<int64_t>(r0 + rr) * kHalf + u]
                    : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < (NX + T - 1) / T; ++it) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (it * T + tid) * 4 + e;
        const int rr = i / FRAME;
        const int c = i - rr * FRAME;
        const int k = c / BLOCKS;
        if (i < 4 * NX)
          xs[(rr * BLOCKS + c - k * BLOCKS) * kXK + k] =
              __fmul_rn(part(cv[it], e), scale);
      }
    }
    __pipeline_wait_prior(0);  // the basis (the first tile)
    __syncthreads();
    // the IMDCT: this warp's 8 blocks (the same for every lane, so their
    // coefficients are broadcast loads) x the lane's 4 outputs
    float acc[kWarpV][4];
#pragma unroll
    for (int a = 0; a < kWarpV; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    }
    const float* xa = xs + wv * kXK;
    const float* mb = mt + 4 * lane;  // lanes 30 and 31 read past: unused
#pragma unroll 2
    for (int k0 = 0; k0 < kN; k0 += 4) {
      float4 xv[kWarpV], mv[4];
#pragma unroll
      for (int a = 0; a < kWarpV; ++a)
        xv[a] = *reinterpret_cast<const float4*>(xa + a * kXK + k0);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mv[q] = *reinterpret_cast<const float4*>(mb + (k0 + q) * kN);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int a = 0; a < kWarpV; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] =
                __fmaf_rn(part(xv[a], q), part(mv[q], b), acc[a][b]);
        }
      }
    }
    __syncthreads();  // every thread has read the coefficients
    if (lane < kN / 4) {
#pragma unroll
      for (int a = 0; a < kWarpV; ++a)
        *reinterpret_cast<float4*>(xs + (wv + a) * kXK + 4 * lane) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();
    // the window mix: thread (half, u) takes the pair u < 60 of blocks
    // half, half + 2, ...: lo and hi from b0 (the tail for a row's first
    // block, else the block before's raw sample) and b1; then the new tails
    float* dst = out + static_cast<int64_t>(r0) * PER;
    if (mixer) {
#pragma unroll
      for (int it = 0; it < kMixIt; ++it) {
        const int v = 2 * it + half;
        const int rr = v / BLOCKS;
        const int j = v - rr * BLOCKS;
        const float b0 = j == 0 ? b0t[it] : xs[(v - 1) * kXK + kHalf + u];
        const float b1 = xs[v * kXK + kHalf - 1 - u];
        if (rr < nr) {
          float* o = dst + rr * PER + j * kN;
          o[u] = __fmaf_rn(b0, w_down, -__fmul_rn(b1, w_up));
          o[kN - 1 - u] = __fmaf_rn(b1, w_down, __fmul_rn(b0, w_up));
        }
      }
#pragma unroll
      for (int it = 0; it < (RT + 1) / 2; ++it) {
        const int rr = 2 * it + half;
        if (rr < nr)
          dst[rr * PER + FRAME + u] =
              xs[(rr * BLOCKS + BLOCKS - 1) * kXK + kHalf + u];
      }
    }
  }
}

// The grid of a persistent launch on the current device: as many blocks
// as fit at once, at most one a tile, so each block stages the basis once
// for all its tiles (chip_smoke.py --grid, an H100 80GB HBM3 at 700 W: 8%
// faster than one block a tile at 4,096 rows x 8 x 120, 10% at 16,384).
// The shared memory attribute is set, and the occupancy read, once a
// device.
template <int BLOCKS>
int imdct_ola_grid(int ntiles, int* grid) {
  static int fit[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (fit[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(celt_imdct_ola_kernel<BLOCKS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemI);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, celt_imdct_ola_kernel<BLOCKS>, kThreadsI, kSmemI);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit[dev] = sms * per_sm;
  }
  *grid = ntiles < fit[dev] ? ntiles : fit[dev];
  return 0;
}

template <int BLOCKS>
int imdct_ola_launch(const float* co, const float* tail, const float* basis_t,
                     const float* win, float* out, int B, float scale,
                     cudaStream_t stream) {
  constexpr int RT = kTileV / BLOCKS;
  int grid = 0;
  const int rc = imdct_ola_grid<BLOCKS>((B + RT - 1) / RT, &grid);
  if (rc != 0) return rc;
  celt_imdct_ola_kernel<BLOCKS><<<grid, kThreadsI, kSmemI, stream>>>(
      co, tail, basis_t, win, out, B, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// In place: buf [B, blocks bs + 60] holds the halves at [60, 60 + frame).
extern "C" int af_celt_ola(void* buf, const void* tail, const void* win,
                           int B, int blocks, int bs, void* stream) {
  if (B <= 0) return 0;
  if (blocks < 1 || blocks > 65535 || bs < kOverlap ||
      static_cast<int64_t>(blocks) * bs + kHalf > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kPairRows - 1) / kPairRows, blocks);
  celt_ola_kernel<<<grid, dim3(kHalf, kPairRows), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), static_cast<const float*>(tail),
      static_cast<const float*>(win), B, bs, blocks * bs + kHalf);
  return static_cast<int>(cudaGetLastError());
}

// co [B, blocks 120] (short blocks interleaved), tail [B, 60], basis_t the
// transposed 120-point basis [120, 120], out [B, blocks 120 + 60].
extern "C" int af_celt_imdct_ola(const void* co, const void* tail,
                                 const void* basis_t, const void* win,
                                 void* out, int B, int blocks, float scale,
                                 void* stream) {
  if (B <= 0) return 0;
  const float* c = static_cast<const float*>(co);
  const float* t = static_cast<const float*>(tail);
  const float* m = static_cast<const float*>(basis_t);
  const float* w = static_cast<const float*>(win);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks) {
    case 1: return imdct_ola_launch<1>(c, t, m, w, o, B, scale, s);
    case 2: return imdct_ola_launch<2>(c, t, m, w, o, B, scale, s);
    case 4: return imdct_ola_launch<4>(c, t, m, w, o, B, scale, s);
    case 8: return imdct_ola_launch<8>(c, t, m, w, o, B, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
