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
// candidates: ~2 warps for each of the card's 528 schedulers), so both
// kernels are bound by the chain's dependent latency and by the integer
// instructions of a step, which two warps a scheduler barely cover.  Memory
// traffic is small: the decoder moves ~5 bytes a sample (an int8 code in,
// an int32 sample out), the encoder 2 bytes in and 0.4 out.  The design
// keeps the chain short and the schedulers busy:
//   * the 4-tap history and weights live in registers, and the step loops
//     unroll, so the history shift is register renaming;
//   * a decode warp runs only 8 lanes, so 8192 lanes make 1024 warps, ~2
//     for each of the card's 528 schedulers, to cover each other's stalls;
//   * the [L, T] layout is kept at the boundary; tiles of 160 steps (8
//     slices) stage through shared memory, so global loads and stores stay
//     coalesced while each thread walks its own lane, and the next tile's
//     loads are in flight while the current tile runs.
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
constexpr int kTileSteps = 160;                 // 8 slices a staged tile
constexpr int kWarp = 32;

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

// (sum_i h[i]*w[i]) >> 13 with int32 wraparound (qoa.d:231-238)
__device__ __forceinline__ int32_t lms_predict(const int32_t h[4],
                                               const int32_t w[4]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc += static_cast<uint32_t>(h[i]) * static_cast<uint32_t>(w[i]);
  return static_cast<int32_t>(acc) >> 13;
}

// sign-sign update (qoa.d:241-254), then recon shifts into the history
__device__ __forceinline__ void lms_update(int32_t h[4], int32_t w[4],
                                           int32_t recon, int32_t residual) {
  const int32_t delta = residual >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = wrap_add(w[i], h[i] < 0 ? -delta : delta);
#pragma unroll
  for (int i = 0; i < 3; ++i) h[i] = h[i + 1];
  h[3] = recon;
}

// ------------------------------------------------------------------ decode
// A one-warp block decodes kDecLanes lanes: with 8,192 lanes a call that is
// 1,024 warps, ~2 per scheduler, so one warp's stalls on its chain are
// another's issue slots (a full warp of lanes would leave half the
// schedulers without a warp).  All 32 threads stage the tiles.
constexpr int kDecLanes = 8;
constexpr int kTileSlices = kTileSteps / kSliceLen;   // 8
constexpr int kCodeWords = kTileSteps / 4;            // a lane's code words
constexpr int kWordLoads = kDecLanes * kCodeWords / kWarp;   // a thread's
constexpr int kSfLoads = kDecLanes * kTileSlices / kWarp;    // a thread's

// The fused form's loads of the tile at step t0 into registers: 4 codes a
// 32-bit word, a lane's 160 codes are 40 words read by consecutive threads,
// and its 8 scalefactors.  T is a multiple of 20, so a lane's row is 4-byte
// aligned and a word lies wholly inside or past the row, and its 4 codes
// share one slice.  All loads of a tile are independent and in flight
// together.
__device__ __forceinline__ void load_code_tile(
    const int8_t* __restrict__ scalefactors, const int8_t* __restrict__ codes,
    int lane0, int x, int L, int T, int t0, uint32_t (&c4)[kWordLoads],
    int32_t (&sf)[kSfLoads]) {
  const int S = T / kSliceLen;
#pragma unroll
  for (int j = 0; j < kWordLoads; ++j) {
    const int k = x + kWarp * j;
    const int li = lane0 + k / kCodeWords;
    const int t = t0 + (k % kCodeWords) * 4;
    c4[j] = (li < L && t < T)
                ? *reinterpret_cast<const uint32_t*>(
                      codes + static_cast<int64_t>(li) * T + t)
                : 0u;
  }
#pragma unroll
  for (int j = 0; j < kSfLoads; ++j) {
    const int k = x + kWarp * j;
    const int li = lane0 + k / kTileSlices;
    const int s = t0 / kSliceLen + k % kTileSlices;
    sf[j] = (li < L && s < S)
                ? scalefactors[static_cast<int64_t>(li) * S + s] & 15
                : 0;
  }
}

// One thread per lane, kDecLanes lanes a one-warp block.  tile[i][k] holds
// lane lane0+i at step t0+k: first its residual, then its reconstructed
// sample.  The fused form loads the next tile's codes while the current
// one decodes.
template <bool kFused>
__global__ void __launch_bounds__(kWarp)
qoa_decode_kernel(const int32_t* __restrict__ history,
                  const int32_t* __restrict__ weights,
                  const int32_t* __restrict__ dequantized,
                  const int8_t* __restrict__ scalefactors,
                  const int8_t* __restrict__ codes,
                  int32_t* __restrict__ out, int L, int T) {
  // the +1 column keeps a thread's walk along its own row free of bank
  // conflicts
  __shared__ int32_t tile[kDecLanes][kTileSteps + 1];
  __shared__ int32_t dequant[16 * 8];
  __shared__ int32_t sf_tile[kDecLanes][kTileSlices];
  const int x = threadIdx.x;
  const int lane0 = blockIdx.x * kDecLanes;
  const int l = lane0 + x;
  const bool lane = x < kDecLanes;        // this thread runs a lane's chain
  const bool live = lane && l < L;
  uint32_t c4[kWordLoads];
  int32_t sf[kSfLoads];
  if constexpr (kFused) {
    // table lookups with lane-varying indices: shared memory, not the
    // constant cache (which serializes distinct addresses)
    for (int k = x; k < 16 * 8; k += kWarp) dequant[k] = kDequant[k >> 3][k & 7];
    load_code_tile(scalefactors, codes, lane0, x, L, T, 0, c4, sf);
  }

  int32_t h[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = live ? history[static_cast<int64_t>(l) * 4 + i] : 0;
    w[i] = live ? weights[static_cast<int64_t>(l) * 4 + i] : 0;
  }

  for (int t0 = 0; t0 < T; t0 += kTileSteps) {
    __syncwarp();
    if constexpr (kFused) {
#pragma unroll
      for (int j = 0; j < kSfLoads; ++j) {
        const int k = x + kWarp * j;
        sf_tile[k / kTileSlices][k % kTileSlices] = sf[j];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kWordLoads; ++j) {
        const int k = x + kWarp * j;
        const int i = k / kCodeWords;
        const int kk = (k % kCodeWords) * 4;
        const int32_t* row = dequant + sf_tile[i][kk / kSliceLen] * 8;
#pragma unroll
        for (int b = 0; b < 4; ++b) tile[i][kk + b] = row[(c4[j] >> (8 * b)) & 7];
      }
      if (t0 + kTileSteps < T)
        load_code_tile(scalefactors, codes, lane0, x, L, T, t0 + kTileSteps,
                       c4, sf);
    } else {
      // coalesced: the warp reads 32 consecutive steps of row i at once
#pragma unroll
      for (int i = 0; i < kDecLanes; ++i) {
        const int li = lane0 + i;
#pragma unroll
        for (int k = x; k < kTileSteps; k += kWarp) {
          const int t = t0 + k;
          tile[i][k] = (li < L && t < T)
                           ? dequantized[static_cast<int64_t>(li) * T + t]
                           : 0;
        }
      }
    }
    __syncwarp();
    if (lane) {
      const int steps = min(kTileSteps, T - t0);
#pragma unroll 4
      for (int k = 0; k < steps; ++k) {
        const int32_t r = tile[x][k];
        const int32_t recon = clamp_s16(wrap_add(lms_predict(h, w), r));
        lms_update(h, w, recon, r);
        tile[x][k] = recon;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kDecLanes; ++i) {
      const int li = lane0 + i;
#pragma unroll
      for (int k = x; k < kTileSteps; k += kWarp) {
        const int t = t0 + k;
        if (li < L && t < T) out[static_cast<int64_t>(li) * T + t] = tile[i][k];
      }
    }
  }
}

// ------------------------------------------------------------------ encode
constexpr int kCand = 16;                        // scalefactor candidates
constexpr int kLanesPerBlock = 8;                // 128 threads
constexpr int kEncThreads = kLanesPerBlock * kCand;
// a staged row's stride: 16-byte aligned rows for the slices' vector
// loads; the two lanes of a warp read banks 4 apart
constexpr int kRowStride = kTileSteps + 4;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

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
// with int8 scalefactors [L, T/20] and codes [L, T/20, 20].
extern "C" int af_qoa_decode(const void* history, const void* weights,
                             const void* dequantized, const void* scalefactors,
                             const void* codes, void* out, int L, int T,
                             void* stream) {
  if (L <= 0 || T <= 0) return 0;
  const dim3 grid((L + kDecLanes - 1) / kDecLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const int32_t*>(history);
  const auto* w = static_cast<const int32_t*>(weights);
  auto* o = static_cast<int32_t*>(out);
  if (dequantized != nullptr) {
    qoa_decode_kernel<false><<<grid, kWarp, 0, s>>>(
        h, w, static_cast<const int32_t*>(dequantized), nullptr, nullptr, o,
        L, T);
  } else {
    if (T % kSliceLen != 0) return static_cast<int>(cudaErrorInvalidValue);
    qoa_decode_kernel<true><<<grid, kWarp, 0, s>>>(
        h, w, nullptr, static_cast<const int8_t*>(scalefactors),
        static_cast<const int8_t*>(codes), o, L, T);
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
