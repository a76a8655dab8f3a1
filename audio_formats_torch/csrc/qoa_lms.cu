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
// candidates), so both kernels are latency-bound on that chain.  Memory
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
//     loads are in flight while the current tile runs;
//   * the encoder's quant and dequant lookups are arithmetic on registers
//     (no table load on the chain), its squared error is a native u64, and
//     the arg-min over the 16 candidates is a warp-shuffle butterfly.

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
  __shared__ int32_t frame[kLanesPerBlock][kTileSteps + 1];  // +1: the two
  // lanes of a warp read different banks
  const int tid = threadIdx.x;
  const int li = tid / kCand;           // lane within the block
  const int c = tid % kCand;            // candidate scalefactor
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int l = lane0 + li;
  const bool live = l < L;
  const unsigned group = 0xFFFFu << (tid & 16);   // this lane's 16 threads

  int32_t h[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = live ? history[static_cast<int64_t>(l) * 4 + i] : 0;
    w[i] = live ? weights[static_cast<int64_t>(l) * 4 + i] : 0;
  }
  const int len = live ? frame_len[l] : 0;
  const int32_t recip = kReciprocal[c];
  // DEQUANT_TAB[c][2m] = a[m], DEQUANT_TAB[c][2m+1] = -a[m]
  const int32_t a0 = kDequant[c][0], a1 = kDequant[c][2];
  const int32_t a2 = kDequant[c][4], a3 = kDequant[c][6];

  // a thread's share of a tile's samples, loaded a tile ahead so the loads
  // fly while the previous tile's search runs
  constexpr int kLoads = kLanesPerBlock * kTileSteps / kEncThreads;  // 10
  int32_t next[kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int k = tid + kEncThreads * j;
      const int i = k / kTileSteps;
      next[j] = lane0 + i < L
                    ? static_cast<int32_t>(
                          samples[static_cast<int64_t>(lane0 + i) * kFrameLen +
                                  t0 + k % kTileSteps])
                    : 0;
    }
  };
  load(0);

  for (int t0 = 0; t0 < kFrameLen; t0 += kTileSteps) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int k = tid + kEncThreads * j;
      frame[k / kTileSteps][k % kTileSteps] = next[j];
    }
    __syncthreads();
    if (t0 + kTileSteps < kFrameLen) load(t0 + kTileSteps);
    for (int s = 0; s < kTileSteps / kSliceLen; ++s) {
      const int slice = t0 / kSliceLen + s;
      const int slice_len = min(max(len - slice * kSliceLen, 0), kSliceLen);
      int32_t th[4], tw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        th[i] = h[i];
        tw[i] = w[i];
      }
      unsigned long long err = 0;
      unsigned long long word = static_cast<unsigned long long>(c);
#pragma unroll
      for (int t = 0; t < kSliceLen; ++t) {
        uint32_t q = 0;
        if (t < slice_len) {
          const int32_t sample = frame[li][s * kSliceLen + t];
          const int32_t predicted = lms_predict(th, tw);
          const int32_t residual = wrap_sub(sample, predicted);
          // qoa_div (qoa.d:263-269): fixed-point reciprocal, round away
          int32_t n = static_cast<int32_t>(static_cast<uint32_t>(residual) *
                                               static_cast<uint32_t>(recip) +
                                           (1u << 15)) >> 16;
          n += ((residual > 0) - (residual < 0)) - ((n > 0) - (n < 0));
          const int32_t v = min(max(n, -8), 8);
          // QUANT_TAB[v + 8] = 2m + (v < 0) with m = min(|v| >> 1, 3)
          const int32_t m = min(abs(v) >> 1, 3);
          const bool neg = v < 0;
          q = static_cast<uint32_t>(2 * m + neg);
          const int32_t mag = (m & 2) ? ((m & 1) ? a3 : a2)
                                      : ((m & 1) ? a1 : a0);
          const int32_t dequantized = neg ? -mag : mag;
          const int32_t recon = clamp_s16(wrap_add(predicted, dequantized));
          const uint32_t e = static_cast<uint32_t>(wrap_sub(sample, recon));
          err += static_cast<unsigned long long>(e * e);
          lms_update(th, tw, recon, dequantized);
        }
        word = (word << 3) | q;
      }
      // arg-min of (err, c) over the lane's 16 threads: the first minimum
      // wins, as the reference's strict `<` best-error update
      unsigned long long best_err = err;
      int best = c;
#pragma unroll
      for (int off = kCand / 2; off > 0; off >>= 1) {
        const unsigned long long oe = __shfl_xor_sync(group, best_err, off);
        const int oc = __shfl_xor_sync(group, best, off);
        if (oe < best_err || (oe == best_err && oc < best)) {
          best_err = oe;
          best = oc;
        }
      }
      const int src = (tid & 16) + best;  // winner's lane in the warp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __shfl_sync(group, th[i], src);
        w[i] = __shfl_sync(group, tw[i], src);
      }
      word = __shfl_sync(group, word, src);
      if (c == 0 && live)
        words[static_cast<int64_t>(l) * kSlices + slice] =
            static_cast<int64_t>(word);
    }
  }
  if (c == 0 && live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h_out[static_cast<int64_t>(l) * 4 + i] = h[i];
      w_out[static_cast<int64_t>(l) * 4 + i] = w[i];
    }
  }
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
