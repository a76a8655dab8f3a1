// QOA LMS decode and the encoder's scalefactor search on Hopper (sm_90a).
//
// af_qoa_decode replaces the TPU kernel
// audio_formats_tpu/ops/lms.py:_lms_pallas_kernel (launched by
// qoa_decode_pallas) and, in its fused form, decode_slices.  Contract, as
// ops/lms.py:qoa_decode:
//   history, weights [L, 4] int32, dequantized [L, T] int32 -> out [L, T]
//   p = (sum_i h[i]*w[i]) >> 13;  recon = clamp_s16(p + r)
//   w[i] += h[i] < 0 ? -(r >> 4) : (r >> 4);  h shifts in recon
// The fused form takes int8 scalefactors [L, S] and codes [L, S, 20]
// (T = 20 S) and reads r = DEQUANT_TAB[sf][code] itself.
//
// af_qoa_encode replaces ops/lms.py:qoa_encode_frame_scan and
// qoa_encode_frame_words (a scan XLA compiled on the TPU, not a Pallas
// kernel): for every 20-sample slice, all 16 scalefactors run the encode
// chain, the one with the least squared error wins (the first on ties, as
// the reference's strict `<`), and its 20 codes become one slice word
// sf<<60 | code_t<<(57-3t).
//
// Every add, multiply and sum that wraps in the reference runs in uint32
// and is read back as int32 (signed overflow is undefined in C++); right
// shifts are arithmetic shifts of that int32.
//
// What bounds them: each lane is a serial chain of 5120 steps, and there
// are few lanes for the card (8192 decode lanes, 2048 encode lanes x 16
// candidates), so both kernels are bound by the chain's dependent latency
// and by the integer instructions of a step, not by memory: the decoder
// moves ~5 bytes a sample (an int8 code in, an int32 sample out), the
// encoder 2 bytes in and 0.4 out.  In both the 4-tap history and weights
// live in registers and the step loops unroll, so the history shift is
// register renaming; the decoder's own design is in its section below.
// The encoder's step is cut to few instructions and a short serial chain,
// its instructions split about evenly between the IMAD pipe and the INT32
// ALU pipe, which run side by side (each takes 16 lanes a cycle on a
// scheduler):
//   * a full 20-sample slice runs a body with no per-step guard (one
//     branch a slice, uniform over a lane's 16 threads); only a lane's
//     last, partial slice takes the guarded loop;
//   * the slice's samples come in as five 16-byte shared loads;
//   * the quantizer caps |n| at 7 (every |n| >= 6 gives the same code),
//     the code is 2m + sign, and the dequantized value is one byte permute
//     of the candidate's four DEQUANT_TAB entries of that sign, packed in
//     two registers; qoa_div's product comes from the prediction in one
//     multiply-add;
//   * the code word is built in 32-bit halves at bit positions fixed by
//     the unrolled step, one multiply-add a step;
//   * a history sample's sign enters as +-1 once, so each weight update is
//     one multiply-add; the squared error is one widening multiply-add;
//   * the next step's prediction sum is split into terms summed while the
//     quantizer runs, so two multiply-adds follow the dequantized value on
//     the serial chain;
//   * the arg-min over the 16 candidates is a warp-shuffle butterfly on
//     one 64-bit key, err << 4 | candidate, so the first minimum wins.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSliceLen = 20;
constexpr int kSlices = 256;
constexpr int kFrameLen = kSliceLen * kSlices;  // 5120
constexpr int kTileSteps = 160;                 // 8 slices an encoder tile

// DEQUANT_TAB[sf][q] (qoa.d:197-215); rows are (+a, -a, +b, -b, ...)
__constant__ int32_t kDequant[16][8] = {
    {1, -1, 3, -3, 5, -5, 7, -7},
    {5, -5, 18, -18, 32, -32, 49, -49},
    {16, -16, 53, -53, 95, -95, 147, -147},
    {34, -34, 113, -113, 203, -203, 315, -315},
    {63, -63, 210, -210, 378, -378, 588, -588},
    {104, -104, 345, -345, 621, -621, 966, -966},
    {158, -158, 528, -528, 950, -950, 1477, -1477},
    {228, -228, 760, -760, 1368, -1368, 2128, -2128},
    {316, -316, 1053, -1053, 1895, -1895, 2947, -2947},
    {422, -422, 1405, -1405, 2529, -2529, 3934, -3934},
    {548, -548, 1828, -1828, 3290, -3290, 5117, -5117},
    {696, -696, 2320, -2320, 4176, -4176, 6496, -6496},
    {868, -868, 2893, -2893, 5207, -5207, 8099, -8099},
    {1064, -1064, 3548, -3548, 6386, -6386, 9933, -9933},
    {1286, -1286, 4288, -4288, 7718, -7718, 12005, -12005},
    {1536, -1536, 5120, -5120, 9216, -9216, 14336, -14336},
};

// RECIPROCAL_TAB[sf] = ceil(2^16 / SCALEFACTOR_TAB[sf])
__constant__ int32_t kReciprocal[16] = {
    65536, 9363, 3121, 1457, 781, 475, 311, 216,
    156, 117, 90, 71, 57, 47, 39, 32,
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clamp_s16(int32_t v) {
  return min(max(v, -32768), 32767);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// ------------------------------------------------------------------ decode
// Every thread runs one lane's chain, kDecLanes = 32 lanes a one-warp
// block: 8,192 lanes are 256 warps, fewer than the card's 528 schedulers,
// so the kernel's time is one warp's time a step, 5,120 times.  A warp
// issues in order, so that time is the longer of its instructions a step
// and its stalls; the step's arithmetic alone runs at ~21 cycles.  The
// design keeps the chain short, the step's instructions few, and every
// stall off the warp's path; the staging runs on the chain's own thread:
//   * one multiply-add follows recon on the chain: the other three terms
//     of the next sum and the weight updates need only older samples and
//     r, which is known ahead;
//   * each weight update is one multiply-add by its history sample's sign
//     (+-1, made once as the sample enters);
//   * a tile of 80 steps (4 slices) is unrolled, so the history rotates by
//     register renaming;
//   * the chain reads its residuals from, and writes its samples to, the
//     lane's staged row in shared memory, 4 at a time: loads and stores of
//     one base address, which ptxas can tell apart, so each load runs ahead
//     of the stores before it (a load from another array cannot pass them,
//     and its latency lands on the chain);
//   * the fused form's codes come in as 16-byte loads of the thread's own
//     row a tile ahead (4-byte loads where a row is not 16-byte aligned),
//     and become the row's residuals before the tile's chain: a code's r is
//     one byte permute, which builds the address of its DEQUANT_TAB entry,
//     and one conflict-free shared load from the thread's own copy of the
//     table; the int32 form's residuals come in by cp.async, a tile ahead;
//   * the warp writes the staged samples out while the next ones run, in
//     coalesced 16-byte stores, each loaded from shared memory a code word
//     before it is stored, so the load's latency passes beside the chain;
//   * the fused form writes each row 1,280 bytes (320 steps) at a time:
//     the card's memory took 320-byte pieces of 20 KB-apart rows at 0.94
//     TB/s, and 1,280-byte ones at 2.86 TB/s.  (One bulk async copy a lane
//     and tile, by the TMA unit, kept the warp waiting.)
constexpr int kDecLanes = 32;                 // lanes (threads) a block
constexpr int kDecTile = 4 * kSliceLen;       // 80 steps a tile
constexpr int kTileWords = kDecTile / 4;      // a tile's code words: 20
// a staged row's stride in words: rows stay 16-byte aligned, and the 8
// threads of each phase of a 16-byte shared access hit distinct banks
constexpr int kRowWords = kDecTile + 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (4 or 16) from src to dst, zeros where !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's latest group of cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One staged row (steps valid steps) out to global dst by the whole warp:
// thread x stores the row's 16-byte chunk x (kVec: dst 16-byte aligned) or
// its words x, x + 32, x + 64, so each store instruction writes one row's
// contiguous bytes.
template <bool kVec>
__device__ __forceinline__ void store_row(const int32_t* row, int32_t* dst,
                                          int steps, int x) {
  if constexpr (kVec) {
    if (4 * x < steps)
      *reinterpret_cast<int4*>(dst + 4 * x) =
          *reinterpret_cast<const int4*>(row + 4 * x);
  } else {
#pragma unroll
    for (int c = x; c < kDecTile; c += kDecLanes)
      if (c < steps) dst[c] = row[c];
  }
}

// One lane's LMS state: the 4-tap history h, its signs sg (h < 0 ? -1 :
// 1), the weights w, and acc = sum_i h[i] * w[i] (wrapped), the next step's
// prediction before its >> 13.
struct DecState {
  int32_t h[4], sg[4], w[4];
  uint32_t acc;
};

__device__ __forceinline__ DecState dec_state(const int32_t* history,
                                              const int32_t* weights,
                                              int64_t l, bool live) {
  DecState s;
  s.acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.h[i] = live ? history[l * 4 + i] : 0;
    s.w[i] = live ? weights[l * 4 + i] : 0;
    s.sg[i] = (s.h[i] >> 31) | 1;
    s.acc += static_cast<uint32_t>(s.h[i]) * static_cast<uint32_t>(s.w[i]);
  }
  return s;
}

// One step on the dequantized residual r (qoa.d:231-254): recon =
// clamp_s16((acc >> 13) + r), the add wrapped; w += (r >> 4) * sg; h
// shifts in recon.  The next sum is
//   h1 w0' + h2 w1' + h3 w2' + recon w3',
// whose first three terms need only older samples, so one multiply-add
// follows recon on the chain.
__device__ __forceinline__ int32_t dec_step(DecState& s, int32_t r) {
  const int32_t recon =
      clamp_s16(wrap_add(static_cast<int32_t>(s.acc) >> 13, r));
  const uint32_t delta = static_cast<uint32_t>(r >> 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s.w[i] = static_cast<int32_t>(static_cast<uint32_t>(s.w[i]) +
                                  delta * static_cast<uint32_t>(s.sg[i]));
  uint32_t a = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    a += static_cast<uint32_t>(s.h[i + 1]) * static_cast<uint32_t>(s.w[i]);
  s.acc = static_cast<uint32_t>(recon) * static_cast<uint32_t>(s.w[3]) + a;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.h[i] = s.h[i + 1];
    s.sg[i] = s.sg[i + 1];
  }
  s.h[3] = recon;
  s.sg[3] = (recon >> 31) | 1;
  return recon;
}

// The fused form's loads of the tile at step t0 of one lane into
// registers: its 80 codes, 4 a word, and its 4 scalefactors, a byte each;
// zeros past the row.  kVec: 16-byte loads (T a multiple of 80, so every
// tile is whole, and the rows aligned).
template <bool kVec>
__device__ __forceinline__ void load_codes(const int8_t* crow,
                                           const int8_t* srow, int t0, int T,
                                           bool live,
                                           uint32_t (&cw)[kTileWords],
                                           uint32_t& sf4) {
  if constexpr (kVec) {
#pragma unroll
    for (int v = 0; v < kTileWords / 4; ++v) {
      const uint4 u =
          live ? __ldg(reinterpret_cast<const uint4*>(crow + t0) + v)
               : make_uint4(0, 0, 0, 0);
      cw[4 * v] = u.x;
      cw[4 * v + 1] = u.y;
      cw[4 * v + 2] = u.z;
      cw[4 * v + 3] = u.w;
    }
    sf4 = live ? __ldg(reinterpret_cast<const uint32_t*>(srow +
                                                         t0 / kSliceLen))
               : 0u;
  } else {
#pragma unroll
    for (int m = 0; m < kTileWords; ++m)
      cw[m] = live && t0 + 4 * m < T
                  ? __ldg(reinterpret_cast<const uint32_t*>(crow + t0 + 4 * m))
                  : 0u;
    sf4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (live && t0 + kSliceLen * j < T)
        sf4 |= static_cast<uint32_t>(
                   static_cast<uint8_t>(srow[t0 / kSliceLen + j]))
               << (8 * j);
    }
  }
}

// r of the 4 steps of code word w, in a slice of scalefactor sf, for
// thread x: dq holds DEQUANT_TAB[sf][code] for thread x at byte offset
// code << 11 | sf << 7 | x << 2, so each thread reads its own bank.  The
// word's bytes become code << 3 | sf >> 1 (address bits 8..15) with one
// shift and one LOP3; the permute of byte b beside (sf & 1) << 7 | x << 2
// (bits 0..7) is the address.
__device__ __forceinline__ void dequant4(const int32_t* dq, uint32_t w,
                                         uint32_t sf, uint32_t x,
                                         int32_t (&r)[4]) {
  const char* table = reinterpret_cast<const char*>(dq);
  const uint32_t lo = (sf & 1) << 7 | x << 2;
  const uint32_t q = ((w << 3) & 0x38383838u) | (sf >> 1) * 0x01010101u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    r[b] = *reinterpret_cast<const int32_t*>(
        table + prmt(lo, q, 0x1140 + 0x10 * b));
}

// The chain over one staged tile: row holds this lane's 80 residuals,
// replaced in place by its samples, 4 at a time (a shared load and store
// of one base address, which ptxas keeps apart, so each word's load runs
// ahead of the stores before it).  after(m) runs after code word m: the
// warp's stores of earlier rows go there, beside the chain.
template <typename After>
__device__ __forceinline__ void chain_tile(DecState& s, int32_t* row,
                                           After&& after) {
#pragma unroll
  for (int m = 0; m < kTileWords; ++m) {
    int4 v = *reinterpret_cast<const int4*>(row + 4 * m);
    v.x = dec_step(s, v.x);
    v.y = dec_step(s, v.y);
    v.z = dec_step(s, v.z);
    v.w = dec_step(s, v.w);
    *reinterpret_cast<int4*>(row + 4 * m) = v;
    after(m);
  }
}

// The fused form stages a lane's samples in segments of 4 tiles, 320 steps:
// its rows go out 1,280 bytes at a time, which the card's memory takes at
// ~3 times the rate of 320-byte pieces.  A segment goes out during the next
// one as 80 pieces of 512 bytes, one a code word: piece p is the 16-byte
// chunks 32 (p % 5) + x of rows 2 (p / 5) and 2 (p / 5) + 1, taken as one
// run of 160 chunks.
constexpr int kSegTiles = 4;
constexpr int kSegSteps = kSegTiles * kDecTile;       // 320
constexpr int kSegWords = kSegSteps + 4;              // a row's stride
constexpr int kFusedSmem = (8 * 16 + 2 * kSegWords) * kDecLanes * 4;

// The fused form: int8 scalefactors [L, S] and codes [L, S, 20], T = 20 S.
// A tile's codes, loaded a tile ahead, become the lane's residuals in its
// staged row (a slice at a time: 20 table loads, then 5 stores), then
// chain_tile runs.  Dynamic shared memory: kFusedSmem bytes.
template <bool kVec>
__global__ void __launch_bounds__(kDecLanes)
qoa_decode_fused(const int32_t* __restrict__ history,
                 const int32_t* __restrict__ weights,
                 const int8_t* __restrict__ scalefactors,
                 const int8_t* __restrict__ codes, int32_t* __restrict__ out,
                 int L, int T) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* dq = smem;
  auto* seg = reinterpret_cast<int32_t (*)[kDecLanes][kSegWords]>(
      smem + 8 * 16 * kDecLanes);
  const int x = threadIdx.x;
  const int lane0 = blockIdx.x * kDecLanes;
  const int l = lane0 + x;
  const bool live = l < L;
  for (int k = x; k < 8 * 16 * kDecLanes; k += kDecLanes)
    dq[k] = kDequant[(k >> 5) & 15][k >> 9];
  DecState s = dec_state(history, weights, l, live);
  const int8_t* crow = codes + static_cast<int64_t>(l) * T;
  const int8_t* srow =
      scalefactors + static_cast<int64_t>(l) * (T / kSliceLen);
  const int rows_live = min(kDecLanes, L - lane0);
  int32_t* dst = out + static_cast<int64_t>(lane0) * T;
  // this thread's share of a piece of a row pair, by p % 5: its row (0 or
  // 1), and its chunk's offset in the staged rows and in out
  int prow[5], soff[5], goff[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int c = 32 * j + x;
    prow[j] = c / kDecTile;
    soff[j] = prow[j] * kSegWords + 4 * (c % kDecTile);
    goff[j] = prow[j] * T + 4 * (c % kDecTile);
  }
  uint32_t next[kTileWords], next_sf;
  load_codes<kVec>(crow, srow, 0, T, live, next, next_sf);
  __syncwarp();
  int t0 = 0, n = 0;
  for (; t0 < T; t0 += kDecTile, ++n) {
    uint32_t cw[kTileWords];
#pragma unroll
    for (int m = 0; m < kTileWords; ++m) cw[m] = next[m];
    const uint32_t sf4 = next_sf;
    if (t0 + kDecTile < T)
      load_codes<kVec>(crow, srow, t0 + kDecTile, T, live, next, next_sf);
    const int k = n / kSegTiles, sub = n % kSegTiles;
    int32_t* row = seg[k & 1][x] + sub * kDecTile;
    // a slice's table loads go before the previous slice's stores, which
    // they could not pass
    int32_t r[2][5][4];
#pragma unroll
    for (int j = 0; j <= kDecTile / kSliceLen; ++j) {
      if (j < kDecTile / kSliceLen) {
#pragma unroll
        for (int w = 0; w < 5; ++w)
          dequant4(dq, cw[5 * j + w], (sf4 >> (8 * j)) & 15, x, r[j & 1][w]);
      }
      if (j > 0) {
        const int32_t (&q)[5][4] = r[(j - 1) & 1];
#pragma unroll
        for (int w = 0; w < 5; ++w)
          *reinterpret_cast<int4*>(row + 20 * (j - 1) + 4 * w) =
              make_int4(q[w][0], q[w][1], q[w][2], q[w][3]);
      }
    }
    // pieces sub * 20 .. sub * 20 + 19 of the previous segment (its rows
    // 8 sub .. 8 sub + 7), each loaded a word before it is stored (the
    // tile's last at once)
    const int32_t* prev = &seg[(k + 1) & 1][8 * sub][0];
    int32_t* pdst =
        dst + static_cast<int64_t>(8 * sub) * T + (k - 1) * kSegSteps;
    const int rows = k > 0 ? rows_live - 8 * sub : 0;
    int4 o;
    int orow = 0;
    int32_t* odst = pdst;
    chain_tile(s, row, [&](int m) {
      if (m > 0 && orow < rows) __stcs(reinterpret_cast<int4*>(odst), o);
      const int j = m % 5, pair = 2 * (m / 5);
      orow = pair + prow[j];
      o = *reinterpret_cast<const int4*>(prev + pair * kSegWords + soff[j]);
      odst = pdst + (pair * T + goff[j]);
      if (m == kTileWords - 1 && orow < rows)
        __stcs(reinterpret_cast<int4*>(odst), o);
    });
    __syncwarp();
  }
  // what is left: the previous segment's pieces past the last segment's
  // tiles, then the last segment
  const int k = (n - 1) / kSegTiles;
  if (k > 0) {
    const int32_t* prev = &seg[(k + 1) & 1][0][0];
    int32_t* pdst = dst + static_cast<int64_t>(k - 1) * kSegSteps;
    for (int p = (n - k * kSegTiles) * kTileWords; p < kSegTiles * kTileWords;
         ++p) {
      const int c = 32 * (p % 5) + x;
      const int i = 2 * (p / 5) + c / kDecTile;
      if (i < rows_live)
        *reinterpret_cast<int4*>(pdst + static_cast<int64_t>(i) * T +
                                 4 * (c % kDecTile)) =
            *reinterpret_cast<const int4*>(prev + i * kSegWords +
                                           4 * (c % kDecTile));
    }
  }
  const int steps = T - k * kSegSteps;
  for (int i = 0; i < rows_live; ++i)
    for (int c = 4 * x; c < steps; c += 4 * kDecLanes)
      *reinterpret_cast<int4*>(dst + static_cast<int64_t>(i) * T +
                               k * kSegSteps + c) =
          *reinterpret_cast<const int4*>(&seg[k & 1][i][c]);
}

// The int32 form: residuals [L, T] of any int32 (p + r wraps), any T.  A
// lane's tile comes in by cp.async a tile ahead into one of three staged
// rows (16-byte copies where kVec: T a multiple of 4 and the residuals
// 16-byte aligned; 4-byte copies else); then chain_tile runs, while the
// warp writes out the previous tile's rows, two a code word, each row
// loaded a word before it is stored (threads 20..31 repeat chunk 19: the
// same bytes to the same place).  Not kVec: the rows go out in words after
// the chain.
template <bool kVec>
__global__ void __launch_bounds__(kDecLanes)
qoa_decode_int32(const int32_t* __restrict__ history,
                 const int32_t* __restrict__ weights,
                 const int32_t* __restrict__ dequantized,
                 int32_t* __restrict__ out, int L, int T) {
  __shared__ __align__(16) int32_t tile[3][kDecLanes][kRowWords];
  const int x = threadIdx.x;
  const int lane0 = blockIdx.x * kDecLanes;
  const int l = lane0 + x;
  const bool live = l < L;
  DecState s = dec_state(history, weights, l, live);
  const int32_t* rrow = dequantized + static_cast<int64_t>(l) * T;
  const auto stage = [&](int32_t* into, int t0) {
    constexpr int kStep = kVec ? 4 : 1;
#pragma unroll
    for (int k = 0; k < kDecTile; k += kStep) {
      const bool valid = live && t0 + k < T;
      cp_async<4 * kStep>(into + k, valid ? rrow + t0 + k : dequantized,
                          valid);
    }
    cp_async_commit();
  };
  const int rows_live = min(kDecLanes, L - lane0);
  const int c = 4 * min(x, kDecTile / 4 - 1);
  int32_t* dst = out + static_cast<int64_t>(lane0) * T;
  stage(tile[0][x], 0);
  int t0 = 0;
  for (int n = 0; t0 < T; t0 += kDecTile, ++n) {
    // the next tile's row was last read by the warp's stores a tile ago,
    // before the last __syncwarp
    if (t0 + kDecTile < T) {
      stage(tile[(n + 1) % 3][x], t0 + kDecTile);
    } else {
      cp_async_commit();   // an empty group, so the wait below is the same
    }
    cp_async_wait_prior();
    const int32_t (*prev)[kRowWords] = tile[(n + 2) % 3];
    int32_t* pdst = dst + t0 - kDecTile;
    const int rows = n > 0 ? rows_live : 0;
    int4 o[2];
    chain_tile(s, tile[n % 3][x], [&](int m) {
      if constexpr (kVec) {
        if (m >= 1 && m <= kDecLanes / 2) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int i = 2 * m - 2 + b;
            if (i < rows)
              *reinterpret_cast<int4*>(pdst + static_cast<int64_t>(i) * T +
                                       c) = o[b];
          }
        }
        if (m < kDecLanes / 2) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
            o[b] = *reinterpret_cast<const int4*>(prev[2 * m + b] + c);
        }
      }
    });
    if constexpr (!kVec) {
      for (int i = 0; i < rows; ++i)
        store_row<false>(prev[i], pdst + static_cast<int64_t>(i) * T,
                         kDecTile, x);
    }
    __syncwarp();
  }
  t0 -= kDecTile;
  dst += t0;
  for (int i = 0; i < rows_live; ++i, dst += T)
    store_row<kVec>(tile[((T - 1) / kDecTile) % 3][i], dst, T - t0, x);
}

// ------------------------------------------------------------------ encode
constexpr int kCand = 16;                        // scalefactor candidates
constexpr int kLanesPerBlock = 8;                // 128 threads
constexpr int kEncThreads = kLanesPerBlock * kCand;
// a staged row's stride: 16-byte aligned rows for the slices' vector
// loads; the two lanes of a warp read banks 4 apart
constexpr int kRowStride = kTileSteps + 4;

__device__ __forceinline__ int32_t sgn(int32_t x) { return (x > 0) - (x < 0); }

// One scalefactor's constants: its RECIPROCAL_TAB entry and its
// DEQUANT_TAB magnitudes a[0..3] (columns 0, 2, 4, 6) as 16-bit pairs,
// +a in pos01:pos23 and -a in neg01:neg23.
struct Cand {
  int32_t recip;
  uint32_t pos01, pos23, neg01, neg23;
};

__device__ __forceinline__ Cand candidate(int c) {
  const auto pair = [](int32_t lo, int32_t hi) {
    return (static_cast<uint32_t>(lo) & 0xFFFFu) | static_cast<uint32_t>(hi)
                                                       << 16;
  };
  return {kReciprocal[c], pair(kDequant[c][0], kDequant[c][2]),
          pair(kDequant[c][4], kDequant[c][6]),
          pair(kDequant[c][1], kDequant[c][3]),
          pair(kDequant[c][5], kDequant[c][7])};
}

struct Quant {
  int32_t code;         // QUANT_TAB's 3-bit code
  int32_t dequantized;  // DEQUANT_TAB[sf][code]
};

// qoa_div (qoa.d:263-269: a fixed-point reciprocal, rounded away from
// zero), the clamp to +-8 and QUANT_TAB, then DEQUANT_TAB, for one
// scalefactor; x = residual * recip + 2^15 and nx = 2^15 - 1 - residual *
// recip, both wrapped (the caller makes them with one multiply-add each).
// With n = x >> 16, the reference's n + sgn(residual) - sgn(n) is
//   n + (x < 0) - (x >= 2^16) + sgn(residual),
// and -(x >= 2^16) = nx >> 31; the two are off by one only where n =
// -2^15, which the clamp maps to the same code.  QUANT_TAB[v + 8] = 2m +
// (v < 0) with m = min(|v| >> 1, 3), so every |v| >= 6 gives one code and
// |v| caps at 7; the dequantized value is bytes 2m, 2m+1 of the sign's
// pair of registers, sign-extended by the permute's sign-replicate mode.
// quant_mismatches holds it to quantize_ref on every int32 residual.
__device__ __forceinline__ Quant quantize(int32_t residual, uint32_t x,
                                          uint32_t nx, const Cand& k) {
  const int32_t v = (static_cast<int32_t>(x) >> 16) +
                    static_cast<int32_t>(x >> 31) +
                    (static_cast<int32_t>(nx) >> 31) +
                    min(max(residual, -1), 1);
  const int32_t neg = v >> 31;                 // 0 or -1
  const int32_t m2 = min(abs(v), 7) & 6;       // 2m
  const uint32_t sel = static_cast<uint32_t>(m2) * 0x1111u + 0x9910u;
  const uint32_t lo = neg ? k.neg01 : k.pos01;
  const uint32_t hi = neg ? k.neg23 : k.pos23;
  return {m2 - neg, static_cast<int32_t>(prmt(lo, hi, sel))};
}

// The quantizer in its direct form (the clamp to +-8, m, the magnitude by
// selects, the sign), with the DEQUANT_TAB magnitudes a[0..3] of the
// scalefactor: the oracle of quant_mismatches.
__device__ __forceinline__ Quant quantize_ref(int32_t residual, int32_t recip,
                                              const int32_t (&a)[4]) {
  int32_t n = static_cast<int32_t>(static_cast<uint32_t>(residual) *
                                       static_cast<uint32_t>(recip) +
                                   (1u << 15)) >> 16;
  n += sgn(residual) - sgn(n);
  const int32_t v = min(max(n, -8), 8);
  const int32_t m = min(abs(v) >> 1, 3);
  const bool neg = v < 0;
  const int32_t mag = (m & 2) ? ((m & 1) ? a[3] : a[2])
                              : ((m & 1) ? a[1] : a[0]);
  return {2 * m + neg, neg ? -mag : mag};
}

// One candidate's state on a lane: the 4-tap history h, its signs sg (+-1:
// h < 0 ? -1 : 1), the weights w, and acc = sum_i h[i] * w[i] (wrapped),
// the next step's prediction before its >> 13.
struct LmsState {
  int32_t h[4], sg[4], w[4];
  uint32_t acc;
};

__device__ __forceinline__ uint32_t lms_sum(const LmsState& s) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc += static_cast<uint32_t>(s.h[i]) * static_cast<uint32_t>(s.w[i]);
  return acc;
}

// One candidate's encode step on sample x (qoa.d:345-368): predict,
// quantize, reconstruct, add the squared error, update the weights by the
// history's signs, shift the history.  Returns the code.  The next sum is
//   h1 w0' + h2 w1' + h3 w2' + recon w3',  w' = w + delta * sg,
// = (h1 w0 + h2 w1 + h3 w2) + delta (h1 sg0 + h2 sg1 + h3 sg2) + recon w3':
// the two brackets are summed while the quantizer runs, so two
// multiply-adds follow the dequantized value on the chain.  With kS16 the
// samples are s16, so |x - recon| <= 65535 and the square is exact as one
// widening multiply-add of int32s; otherwise it is the reference's u32
// product.
template <bool kS16>
__device__ __forceinline__ int32_t encode_step(int32_t x, LmsState& s,
                                               const Cand& k,
                                               unsigned long long& err) {
  const uint32_t xr = static_cast<uint32_t>(x) * static_cast<uint32_t>(k.recip);
  const int32_t predicted = static_cast<int32_t>(s.acc) >> 13;
  // residual * recip + 2^15 and 2^15 - 1 - residual * recip
  const uint32_t xq = (xr + 0x8000u) + static_cast<uint32_t>(predicted) *
                                           (0u - static_cast<uint32_t>(k.recip));
  const uint32_t nxq = (0x7FFFu - xr) + static_cast<uint32_t>(predicted) *
                                            static_cast<uint32_t>(k.recip);
  uint32_t a = 0, b = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a += static_cast<uint32_t>(s.h[i + 1]) * static_cast<uint32_t>(s.w[i]);
    b += static_cast<uint32_t>(s.h[i + 1]) * static_cast<uint32_t>(s.sg[i]);
  }
  const Quant qd = quantize(wrap_sub(x, predicted), xq, nxq, k);
  const int32_t recon = clamp_s16(wrap_add(predicted, qd.dequantized));
  const int32_t e = wrap_sub(x, recon);
  if constexpr (kS16) {
    err += static_cast<unsigned long long>(static_cast<long long>(e) * e);
  } else {
    err += static_cast<uint32_t>(e) * static_cast<uint32_t>(e);
  }
  const uint32_t delta = static_cast<uint32_t>(qd.dequantized >> 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s.w[i] = static_cast<int32_t>(static_cast<uint32_t>(s.w[i]) +
                                  delta * static_cast<uint32_t>(s.sg[i]));
  s.acc = static_cast<uint32_t>(recon) * static_cast<uint32_t>(s.w[3]) +
          (delta * b + a);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.h[i] = s.h[i + 1];
    s.sg[i] = s.sg[i + 1];
  }
  s.h[3] = recon;
  s.sg[3] = (recon >> 31) | 1;
  return qd.code;
}

// One candidate's search of one slice of slice_len samples at row (16-byte
// aligned): the chain from the state s (updated in place) with scalefactor
// c.  Returns the squared error, and the slice word sf<<60 |
// code_t<<(57-3t) as hi:lo; code 9 straddles bit 32 (bits 30..32).
template <bool kS16>
__device__ __forceinline__ unsigned long long search_slice(
    const int32_t* row, int slice_len, int c, LmsState& s, const Cand& k,
    uint32_t& hi, uint32_t& lo) {
  unsigned long long err = 0;
  if (slice_len == kSliceLen) {
    int32_t x[kSliceLen];
#pragma unroll
    for (int j = 0; j < kSliceLen / 4; ++j) {
      const int4 v = reinterpret_cast<const int4*>(row)[j];
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    }
    hi = static_cast<uint32_t>(c) << 28;
    lo = 0;
#pragma unroll
    for (int t = 0; t < kSliceLen; ++t) {
      const uint32_t q =
          static_cast<uint32_t>(encode_step<kS16>(x[t], s, k, err));
      if (t < 9) {
        hi += q * (1u << (25 - 3 * t));
      } else if (t == 9) {
        hi += q >> 2;
        lo = q << 30;
      } else {
        lo += q * (1u << (57 - 3 * t));
      }
    }
  } else {
    // a lane's last, partial slice: the codes past slice_len stay 0; the
    // slices past frame_len run no step, so every candidate's error is 0,
    // candidate 0 wins and the word is 0
    unsigned long long word = static_cast<unsigned long long>(c);
    for (int t = 0; t < slice_len; ++t)
      word = (word << 3) |
             static_cast<uint32_t>(encode_step<kS16>(row[t], s, k, err));
    word <<= 3 * (kSliceLen - slice_len);
    hi = static_cast<uint32_t>(word >> 32);
    lo = static_cast<uint32_t>(word);
  }
  return err;
}

// One lane per 16 threads (two lanes a warp); thread c of a lane tries
// scalefactor c.  frame[i][k] holds lane lane0+i's sample at step t0+k.
template <typename Sample>
__global__ void __launch_bounds__(kEncThreads)
qoa_encode_kernel(const Sample* __restrict__ samples,
                  const int32_t* __restrict__ history,
                  const int32_t* __restrict__ weights,
                  const int32_t* __restrict__ frame_len,
                  int64_t* __restrict__ words, int32_t* __restrict__ h_out,
                  int32_t* __restrict__ w_out, int L) {
  constexpr bool kS16 = sizeof(Sample) == 2;
  __shared__ __align__(16) int32_t frame[kLanesPerBlock][kRowStride];
  const int tid = threadIdx.x;
  const int li = tid / kCand;           // lane within the block
  const int c = tid % kCand;            // candidate scalefactor
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int l = lane0 + li;
  const bool live = l < L;
  const unsigned group = 0xFFFFu << (tid & 16);   // this lane's 16 threads

  LmsState st;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.h[i] = live ? history[static_cast<int64_t>(l) * 4 + i] : 0;
    st.w[i] = live ? weights[static_cast<int64_t>(l) * 4 + i] : 0;
    st.sg[i] = (st.h[i] >> 31) | 1;
  }
  st.acc = lms_sum(st);
  const int len = live ? frame_len[l] : 0;
  const Cand k = candidate(c);

  // a thread's share of a tile's samples, loaded a tile ahead so the loads
  // fly while the previous tile's search runs
  constexpr int kLoads = kLanesPerBlock * kTileSteps / kEncThreads;  // 10
  int32_t next[kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = (tid + kEncThreads * j) / kTileSteps;
      next[j] = lane0 + i < L
                    ? static_cast<int32_t>(
                          samples[static_cast<int64_t>(lane0 + i) * kFrameLen +
                                  t0 + (tid + kEncThreads * j) % kTileSteps])
                    : 0;
    }
  };
  load(0);

  for (int t0 = 0; t0 < kFrameLen; t0 += kTileSteps) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + kEncThreads * j;
      frame[i / kTileSteps][i % kTileSteps] = next[j];
    }
    __syncthreads();
    if (t0 + kTileSteps < kFrameLen) load(t0 + kTileSteps);
#pragma unroll 1
    for (int s = 0; s < kTileSteps / kSliceLen; ++s) {
      const int slice = t0 / kSliceLen + s;
      const int slice_len = min(max(len - slice * kSliceLen, 0), kSliceLen);
      // st becomes this candidate's state, then the winner's
      uint32_t hi, lo;
      const unsigned long long err = search_slice<kS16>(
          &frame[li][s * kSliceLen], slice_len, c, st, k, hi, lo);
      // arg-min of (err, c) over the lane's 16 threads as one key (err <
      // 20 * 2^32 < 2^37): the first minimum wins, as the reference's
      // strict `<` best-error update
      unsigned long long key = err << 4 | static_cast<unsigned>(c);
#pragma unroll
      for (int off = kCand / 2; off > 0; off >>= 1)
        key = min(key, __shfl_xor_sync(group, key, off));
      const int best = static_cast<int>(key & (kCand - 1));
      const int src = (tid & 16) + best;  // winner's lane in the warp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st.h[i] = __shfl_sync(group, st.h[i], src);
        st.w[i] = __shfl_sync(group, st.w[i], src);
        st.sg[i] = (st.h[i] >> 31) | 1;
      }
      st.acc = __shfl_sync(group, st.acc, src);
      if (c == best && live)
        words[static_cast<int64_t>(l) * kSlices + slice] =
            static_cast<int64_t>(static_cast<unsigned long long>(hi) << 32 |
                                 lo);
    }
  }
  if (c == 0 && live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h_out[static_cast<int64_t>(l) * 4 + i] = st.h[i];
      w_out[static_cast<int64_t>(l) * 4 + i] = st.w[i];
    }
  }
}

// Counts, for candidate blockIdx.y, the int32 residuals on which quantize
// and quantize_ref disagree in code or dequantized value: every one of the
// 2^32, in a grid-stride loop.
__global__ void __launch_bounds__(256)
quant_mismatches(unsigned long long* __restrict__ counts) {
  const int c = blockIdx.y;
  const Cand k = candidate(c);
  const int32_t a[4] = {kDequant[c][0], kDequant[c][2], kDequant[c][4],
                        kDequant[c][6]};
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned long long bad = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const int32_t r = static_cast<int32_t>(static_cast<uint32_t>(i));
    const uint32_t rq = static_cast<uint32_t>(r) * static_cast<uint32_t>(k.recip);
    const Quant got = quantize(r, rq + 0x8000u, 0x7FFFu - rq, k);
    const Quant want = quantize_ref(r, k.recip, a);
    bad += got.code != want.code || got.dequantized != want.dequantized;
  }
  if (bad) atomicAdd(counts + c, bad);
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Each launches without synchronising and returns
// cudaGetLastError() (0 on success).

// dequantized != nullptr: the [L, T] int32 form.  Otherwise the fused form
// with int8 scalefactors [L, T/20] and codes [L, T/20, 20] (4-byte
// aligned).  out 16-byte aligned.
extern "C" int af_qoa_decode(const void* history, const void* weights,
                             const void* dequantized, const void* scalefactors,
                             const void* codes, void* out, int L, int T,
                             void* stream) {
  if (L <= 0 || T <= 0) return 0;
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + kDecLanes - 1) / kDecLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(history);
  const auto* w = static_cast<const int32_t*>(weights);
  auto* o = static_cast<int32_t*>(out);
  if (dequantized != nullptr) {
    const auto* r = static_cast<const int32_t*>(dequantized);
    if (T % 4 == 0 && aligned(r, 16)) {
      qoa_decode_int32<true><<<grid, kDecLanes, 0, s>>>(h, w, r, o, L, T);
    } else {
      qoa_decode_int32<false><<<grid, kDecLanes, 0, s>>>(h, w, r, o, L, T);
    }
  } else {
    if (T % kSliceLen != 0 || !aligned(codes, 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* sf = static_cast<const int8_t*>(scalefactors);
    const auto* c = static_cast<const int8_t*>(codes);
    const auto launch = [&](auto kernel) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFusedSmem);
      if (e == cudaSuccess)
        kernel<<<grid, kDecLanes, kFusedSmem, s>>>(h, w, sf, c, o, L, T);
      return e;
    };
    const cudaError_t e =
        T % kDecTile == 0 && aligned(c, 16) && aligned(sf, 4)
            ? launch(qoa_decode_fused<true>)
            : launch(qoa_decode_fused<false>);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// samples [L, 5120] of sample_bytes 2 (int16) or 4 (int32); history,
// weights [L, 4] int32; frame_len [L] int32 -> words [L, 256] int64 (the
// u64 slice words' bits), history' and weights' [L, 4] int32.
extern "C" int af_qoa_encode(const void* samples, int sample_bytes,
                             const void* history, const void* weights,
                             const void* frame_len, void* words, void* h_out,
                             void* w_out, int L, void* stream) {
  if (L <= 0) return 0;
  const dim3 grid((L + kLanesPerBlock - 1) / kLanesPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(history);
  const auto* w = static_cast<const int32_t*>(weights);
  const auto* fl = static_cast<const int32_t*>(frame_len);
  auto* wd = static_cast<int64_t*>(words);
  auto* ho = static_cast<int32_t*>(h_out);
  auto* wo = static_cast<int32_t*>(w_out);
  if (sample_bytes == 2) {
    qoa_encode_kernel<int16_t><<<grid, kEncThreads, 0, s>>>(
        static_cast<const int16_t*>(samples), h, w, fl, wd, ho, wo, L);
  } else if (sample_bytes == 4) {
    qoa_encode_kernel<int32_t><<<grid, kEncThreads, 0, s>>>(
        static_cast<const int32_t*>(samples), h, w, fl, wd, ho, wo, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts [16] uint64, zeroed by the caller: for each scalefactor, the int32
// residuals (all 2^32) on which the encoder's quantizer and its direct
// form disagree.  A check, not on the encode path.
extern "C" int af_qoa_quant_mismatches(void* counts, void* stream) {
  quant_mismatches<<<dim3(1024, kCand), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
