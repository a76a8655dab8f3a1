// The CELT deemphasis on Hopper (sm_90a): K12b.
//
// af_celt_deemph replaces the JAX package's ops/celt_dsp.py:85
// deemphasis_scan (a lax.associative_scan, an XLA stage on the TPU).
// Contract, as the twin ops/celt_dsp.py:deemphasis_scan_torch:
//   x  [B, n] f32, m0 [B] f32 (the carried memory, pre-multiplied by c)
//   y[i] = x[i] + v_i,  v_0 = m0,  v_{i+1} = c y[i]   (c = 0.85000610 f32)
//   out [B, n] f32 = y / 32768,  m [B] f32 = v_n = c y[n - 1]
// x and out are taken by rows: row r of x starts sx floats after row r - 1
// (out: sy), its samples contiguous, so a caller can pass a column slice of
// a wider buffer (the [rows, 960] view of K12a's packed [rows, 1020]
// output) without a copy.  The twin steps the recurrence one sample at a
// time, each product and sum rounded to f32.  This file builds with
// -fmad=false, so each step here rounds the same way (c y, then x + c y).
//
// What bounds it: bytes.  x is read once and out written once, 8 bytes a
// sample; five float operations a sample are nothing beside them.  The
// design moves those bytes in full 128-byte lines and keeps the serial
// work short:
//
// * One block of 128 threads (4 warps) a row, which it walks in tiles of
//   1,024 samples.  Warp w owns the tile's samples [256 w, 256 w + 256);
//   its lane l owns two chunks of 4 samples, set 0 at 256 w + 4 l and
//   set 1 at 256 w + 128 + 4 l.  So each of a warp's loads and stores is
//   one 16-byte vector a lane over 512 contiguous bytes.  (Eight
//   contiguous samples a thread would give each instruction 16 useful
//   bytes of every 32-byte sector.)
// * Pass 1 steps each chunk from a zero carry: its transfer
//   v_out = a v_in + b (a = c^len, b = the chunk's exit carry).  An
//   inclusive __shfl_up_sync scan of each set's transfers over the lanes
//   (compose (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2)) gives every
//   chunk the transfer of the chunks of its set before it; the lanes 31
//   put each warp's two set totals in shared memory.  Each thread then
//   applies the totals of the warps before its own to the tile's entry
//   carry one after the other (at most six steps) and its lane's
//   exclusive transfer to that: its chunks' entry carries.
// * Pass 2 steps each chunk again from its entry carry, the samples still
//   in registers from the one read, which is the twin's recurrence exactly
//   wherever the carry is, and writes y / 32768.  Only the entry carries
//   differ from the twin, by the scan's rounding, and c^k damps that
//   within a few dozen samples (the card tests hold it within 1e-6 of the
//   peak).  The thread whose chunk holds the tile's
//   last sample hands its exact exit carry to the next tile, and thread 0
//   writes m after the last tile (m0 itself where n == 0).
// * A row whose x or out does not start on a 16-byte boundary, and the
//   chunk that holds a ragged row end, take the same steps with scalar
//   loads or stores; a chunk past the row's end has the identity
//   transfer (1, 0) and touches no memory.
//
// Per sample the chains are 4 steps in each of two independent chunks,
// where one warp a row gave each lane two chains of 30 steps with a
// scattered load in each; at 512 rows the card holds 512 blocks of 4 warps
// instead of 128 of 4.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;                   // samples a chunk: one float4
constexpr int kSet = 32 * kChunk;           // samples of one set of a warp
constexpr int kTile = kWarps * 2 * kSet;    // 1,024 samples a tile
constexpr unsigned kFull = 0xFFFFFFFFu;

// v -> a v + b
struct Transfer {
  float a, b;
};

// `first`, then `then`
__device__ __forceinline__ Transfer compose(Transfer first, Transfer then) {
  return {__fmul_rn(first.a, then.a),
          __fadd_rn(__fmul_rn(first.b, then.a), then.b)};
}

__device__ __forceinline__ float apply(Transfer t, float v) {
  return __fadd_rn(__fmul_rn(t.a, v), t.b);
}

__device__ __forceinline__ Transfer shfl_up(Transfer t, int d) {
  return {__shfl_up_sync(kFull, t.a, d), __shfl_up_sync(kFull, t.b, d)};
}

// the k (0..4) samples of a chunk at p; a float4 where `vec` and k == 4
__device__ __forceinline__ void load_chunk(const float* p, int k, bool vec,
                                           float (&v)[kChunk]) {
  if (vec && k == kChunk) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = i < k ? __ldg(p + i) : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(float* p, int k, bool vec,
                                            const float (&v)[kChunk]) {
  if (vec && k == kChunk) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < k) p[i] = v[i];
  }
}

// pass 1: the chunk's transfer from a zero carry
__device__ __forceinline__ Transfer chunk_transfer(const float (&v)[kChunk],
                                                   int k, float c) {
  Transfer t{1.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < k) {
      t.b = __fmul_rn(c, __fadd_rn(v[i], t.b));
      t.a = __fmul_rn(t.a, c);
    }
  }
  return t;
}

// pass 2: the twin's recurrence from the entry carry v; the samples become
// y / 32768 and v the exit carry
__device__ __forceinline__ void chunk_steps(float (&s)[kChunk], int k, float c,
                                            float& v) {
  const float inv = 1.0f / 32768.0f;  // exact: a power of two
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < k) {
      const float y = __fadd_rn(s[i], v);
      s[i] = __fmul_rn(y, inv);
      v = __fmul_rn(c, y);
    }
  }
}

__device__ __forceinline__ Transfer warp_inclusive_scan(Transfer t, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Transfer o = shfl_up(t, d);
    if (lane >= d) t = compose(o, t);
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
celt_deemph_kernel(const float* __restrict__ x, int64_t sx,
                   const float* __restrict__ m0, float* __restrict__ out,
                   int64_t sy, float* __restrict__ m_out, int n, float c) {
  __shared__ Transfer totals[kWarps][2];  // each warp's two set totals
  __shared__ float exit_carry;            // the tile's last sample's
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * sx;
  float* yr = out + row * sy;
  const bool xvec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const bool yvec = (reinterpret_cast<uintptr_t>(yr) & 15) == 0;
  float carry = m0[row];
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int s0 = t0 + warp * 2 * kSet + lane * kChunk;  // set 0's chunk
    const int s1 = s0 + kSet;                             // set 1's
    const int k0 = min(kChunk, max(0, n - s0));
    const int k1 = min(kChunk, max(0, n - s1));
    float v0[kChunk], v1[kChunk];
    load_chunk(xr + s0, k0, xvec, v0);
    load_chunk(xr + s1, k1, xvec, v1);
    const Transfer i0 = warp_inclusive_scan(chunk_transfer(v0, k0, c), lane);
    const Transfer i1 = warp_inclusive_scan(chunk_transfer(v1, k1, c), lane);
    const Transfer e0 = shfl_up(i0, 1), e1 = shfl_up(i1, 1);
    const Transfer h0{__shfl_sync(kFull, i0.a, 31),
                      __shfl_sync(kFull, i0.b, 31)};
    if (lane == 31) totals[warp][0] = i0, totals[warp][1] = i1;
    __syncthreads();
    // the carry into this warp's samples: the warps before it, in order
    float u = carry;
    for (int w = 0; w < warp; ++w)
      u = apply(totals[w][1], apply(totals[w][0], u));
    float c0 = lane == 0 ? u : apply(e0, u);
    const float u1 = apply(h0, u);  // the carry into set 1
    float c1 = lane == 0 ? u1 : apply(e1, u1);
    chunk_steps(v0, k0, c, c0);
    chunk_steps(v1, k1, c, c1);
    store_chunk(yr + s0, k0, yvec, v0);
    store_chunk(yr + s1, k1, yvec, v1);
    const int last = min(n, t0 + kTile) - 1;
    if (last >= s0 && last < s0 + kChunk) exit_carry = c0;
    if (last >= s1 && last < s1 + kChunk) exit_carry = c1;
    __syncthreads();  // also: totals is free for the next tile
    carry = exit_carry;
  }
  if (threadIdx.x == 0) m_out[row] = carry;
}

}  // namespace

extern "C" int af_celt_deemph(const void* x, long long sx, const void* m0,
                              void* out, long long sy, void* m, int B, int n,
                              float c, void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || sx < 0 || sy < 0) return static_cast<int>(cudaErrorInvalidValue);
  celt_deemph_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sx, static_cast<const float*>(m0),
      static_cast<float*>(out), sy, static_cast<float*>(m), n, c);
  return static_cast<int>(cudaGetLastError());
}
