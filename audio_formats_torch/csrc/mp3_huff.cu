// MP3 Layer III Huffman decode on Hopper (sm_90a).
//
// af_mp3_huff replaces audio_formats_tpu/ops/mp3_huff.py:_huff_core (two
// lax.scan loops that XLA compiled on the TPU, not a Pallas kernel).
// Contract, as ops/mp3_huff.py:huff_decode, for L independent lanes (one
// granule-channel each):
//   pool  [N] u32  big-endian words, lane after lane; lane l starts at
//                  offs[l] (the exclusive cumsum of the spans)
//   meta  [L, 16] int16  bit_start, bit_limit, big_values, bnd0, bnd1,
//                  tab0..2, lin0..2, count1 table, pattern, (stereo,
//                  block type: unused here), span
//   blob  the lookup tables of ops/mp3_huff.py:_build_blob
//   W     the window's row width
//   -> q [L, 576] int32 (every position written: 0 where no phase writes),
//      err [L] (all false, as in the reference, which never sets it)
// Word w of a lane is pool[offs + w] when w < span and w < W, else 0.  The
// big-values phase runs min(bv, 288) pairs, takes the region table from
// BAND_OF_PAIR[pattern][i] against bnd0/bnd1, peeks 19 bits, reads linbits
// for x or y == 15 and a sign bit for a value that is not 0, never checks
// bit_limit, and clamps the position to (W - 3) * 32 after each pair.  A
// count1 step at s0 = 2 bv + 4 j runs while it is not stopped and s0 <= 572;
// it is taken only if its codeword ends at or before bit_limit; sign bits
// are read where s0 < tw (first pair) and s0 + 2 < tw (second pair); after
// it, stopped |= !bit_ok | (s0 + 2 >= tw).
//
// What bounds it: every lane is a serial chain of up to 432 steps, each a
// few dependent loads (three pool words, one or two table entries) and
// shifts, so the kernel is latency-bound on that chain; bytes are small (a
// window reads ~25 MB of pool words and writes its 226 MB q plane once:
// each block first zeroes its rows with coalesced stores, so the caller
// need not fill the plane).  The design keeps the chain short and the
// schedulers fed:
//   * one thread a lane, 256 lanes a block: a 98,304-lane window is 384
//     blocks, all resident at once (~23 warps an SM) to cover each other's
//     load latency;
//   * the tables (two-level code lookup, count1, TOTAL_W, BAND_OF_PAIR,
//     ~45 KB) are copied once a block into shared memory, so the lookups
//     with lane-varying indices hit shared memory, not the constant cache;
//   * the three words of a step come through the read-only cache: a lane's
//     words are contiguous, so consecutive steps hit the same lines.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// word offsets in the blob (ops/mp3_huff.py BLOB_*)
constexpr int kBases = 0;
constexpr int kCount1 = 32;
constexpr int kTotalW = 160;
constexpr int kBandOfPair = 208;
constexpr int kFirstBits = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shift64(uint32_t a, uint32_t b,
                                            uint32_t o) {
  // the 32 bits starting at bit o (0..31) of a‖b
  return (a << o) | ((b >> (31u - o)) >> 1);
}

// bits [o, o + width) of a‖b‖c, width 0..19; 0 when width == 0
__device__ __forceinline__ uint32_t extract(uint32_t a, uint32_t b,
                                            uint32_t c, int o, int width) {
  if (o >= 32) { a = b; b = c; c = 0u; o -= 32; }
  if (o >= 32) { a = b; b = c; o -= 32; }
  const uint32_t hi = shift64(a, b, static_cast<uint32_t>(o));
  return width > 0 ? hi >> ((32 - width) & 31) : 0u;
}

__global__ void __launch_bounds__(kThreads)
mp3_huff_kernel(const uint32_t* __restrict__ pool,
                const int32_t* __restrict__ offs,
                const int16_t* __restrict__ meta,
                const uint32_t* __restrict__ blob, int blob_len, int L,
                int W, int32_t* __restrict__ q, bool* __restrict__ err) {
  extern __shared__ uint32_t s_blob[];
  for (int i = threadIdx.x; i < blob_len; i += blockDim.x)
    s_blob[i] = blob[i];
  // zero the block's rows of q with coalesced 16-byte stores (a row is
  // 2,304 bytes, so rows stay 16-byte aligned); the lanes then write only
  // the positions their phases reach
  const int l0 = blockIdx.x * blockDim.x;
  const int n_vec = min(L - l0, kThreads) * (576 / 4);
  int4* q_vec = reinterpret_cast<int4*>(q + static_cast<int64_t>(l0) * 576);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    q_vec[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;

  const int16_t* m = meta + static_cast<int64_t>(l) * 16;
  const int bit_limit = m[1];
  const int bv = m[2];
  const int bnd0 = m[3], bnd1 = m[4];
  const int tab0 = m[5] & 31, tab1 = m[6] & 31, tab2 = m[7] & 31;
  const int lin0 = m[8], lin1 = m[9], lin2 = m[10];
  const int c1base = kCount1 + 64 * (m[11] & 1);
  const int pattern = min(max(static_cast<int>(m[12]), 0), 47);
  const int span = min(static_cast<int>(m[15]), W);
  const uint32_t* row = pool + offs[l];
  int32_t* out = q + static_cast<int64_t>(l) * 576;
  const uint8_t* bop =
      reinterpret_cast<const uint8_t*>(s_blob + kBandOfPair) + pattern * 288;
  const int max_pos = (W - 3) * 32;
  err[l] = false;

  auto word = [&](int w) -> uint32_t {
    return w < span ? __ldg(row + w) : 0u;
  };

  int pos = m[0];
  // ---- big values: pairs (x, y) ----
  const int npairs = min(bv, 288);
  for (int i = 0; i < npairs; ++i) {
    const int band = bop[i];
    const bool in1 = band >= bnd0, in2 = band >= bnd1;
    const int t = in2 ? tab2 : (in1 ? tab1 : tab0);
    const int linb = in2 ? lin2 : (in1 ? lin1 : lin0);
    const int w0 = pos >> 5;
    const int sh = pos & 31;
    const uint32_t a = word(w0), b = word(w0 + 1), c = word(w0 + 2);
    const uint32_t peek = shift64(a, b, sh) >> 13;
    uint32_t e = s_blob[s_blob[kBases + t] + (peek >> (19 - kFirstBits))];
    if (e & 0x80000000u) {
      const int ext = (e >> 24) & 15;
      e = s_blob[(e & 0xFFFFFFu) +
                 ((peek >> (19 - kFirstBits - ext)) & ((1u << ext) - 1u))];
    }
    const int ln = e & 31;
    const int x = (e >> 8) & 15, y = (e >> 12) & 15;
    int o = sh + ln;
    const int lx = x == 15 ? linb : 0;
    const int xv = x + static_cast<int>(extract(a, b, c, o, lx));
    o += lx;
    const int px = xv != 0;
    const bool xneg = px && extract(a, b, c, o, 1) == 1u;
    o += px;
    const int ly = y == 15 ? linb : 0;
    const int yv = y + static_cast<int>(extract(a, b, c, o, ly));
    o += ly;
    const int py = yv != 0;
    const bool yneg = py && extract(a, b, c, o, 1) == 1u;
    o += py;
    pos = min(pos + (o - sh), max_pos);
    *reinterpret_cast<int2*>(out + 2 * i) =
        make_int2(xneg ? -xv : xv, yneg ? -yv : yv);
  }

  // ---- count1: quads of -1/0/1 from position 2 bv ----
  const int tw = static_cast<int>(s_blob[kTotalW + pattern]);
  for (int s0 = 2 * bv; s0 <= 572; s0 += 4) {
    const int w0 = pos >> 5;
    const int sh = pos & 31;
    const uint32_t a = word(w0), b = word(w0 + 1), c = word(w0 + 2);
    const uint32_t e = s_blob[c1base + (shift64(a, b, sh) >> 26)];
    const int ln = e & 7;
    const int vmask = (e >> 8) & 15;
    if (pos + ln > bit_limit) break;  // codeword past the region: stop
    int o = sh + ln;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool pv = s < 2 ? s0 < tw : s0 + 2 < tw;
      if (pv && ((vmask >> (3 - s)) & 1)) {
        out[s0 + s] = extract(a, b, c, o, 1) ? -1 : 1;
        ++o;
      }
    }
    pos = min(pos + (o - sh), max_pos);
    if (s0 + 2 >= tw) break;
  }
}

}  // namespace

extern "C" int af_mp3_huff(const void* pool, const void* offs,
                           const void* meta, const void* blob, int blob_len,
                           int L, int W, void* q, void* err, void* stream) {
  if (L <= 0) return 0;
  const size_t smem = static_cast<size_t>(blob_len) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        mp3_huff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = (L + kThreads - 1) / kThreads;
  mp3_huff_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), static_cast<const int32_t*>(offs),
      static_cast<const int16_t*>(meta), static_cast<const uint32_t*>(blob),
      blob_len, L, W, static_cast<int32_t*>(q), static_cast<bool*>(err));
  return static_cast<int>(cudaGetLastError());
}
