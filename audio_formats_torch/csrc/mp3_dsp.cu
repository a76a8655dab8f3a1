// MP3 Layer III window DSP after the Huffman stage on Hopper (sm_90a): K14.
//
// af_mp3_window_dsp replaces no TPU kernel.  The JAX package wrote this
// chain as array ops and XLA fused it on the TPU
// (audio_formats_tpu/ops/mp3_huff.py packed_device_stage and
// audio_formats_tpu/ops/mp3_dsp.py:292 mp3_window_dsp).  In PyTorch the same
// chain is about a hundred small launches a window, each costing the card
// a few microseconds however few bytes it moves; this kernel does all of
// it in one launch.  Its plain twin is ops/mp3_huff.py spectrum_stage +
// ops/mp3_dsp.py mp3_window_dsp, which the CPU takes.
//
// Contract, as ops/mp3_dsp.py:window_dsp_cuda, for a window of B lanes x G
// granules x nch channels, lane l = (b G + g) nch + c:
//   q      [L, 576] int32  the Huffman stage's quantized values (K3)
//   meta   [L, 16] int16   side info; read: pattern (column 12), stereo
//                  bits (13: bit 0 is mid/side), block type (14)
//   scfq   [L, 40] int16   quarter-exponent gain of each scalefactor band
//   n_act  [B] int32       leading active granules of each lane
//   ov_in  [B, nch, 32, 18] f32  carried IMDCT overlap
//   sh_in  [B, nch, 16, 32] f32  carried subband slot history
//   abcd   [B G, 4, 40] f32, or null outside intensity windows: the
//                  per-band stereo mix l' = a l + b r, r' = c l + d r of
//                  the left channel's bands
//   blob   the tables of ops/mp3_dsp.py dsp_blob (DSP_* word offsets)
//   short_blocks  0 when no lane of the window has a short-block pattern
//   -> out    [L, 1088] f32: row (b, g, c) holds slots [18 g, 18 g + 34)
//             of (sh_in ‖ S), S the lane's 18 G subband slots of 32 bands:
//             the operand of the synthesis product (SYNTH_TOEPLITZ)
//      ov_out [B, nch, 32, 18]: the overlap granule n_act - 1 emits
//             (ov_in where n_act is 0)
//      sh_out [B, nch, 16, 32]: slots [18 n_act, 18 n_act + 16) of
//             (sh_in ‖ S)
// Each granule-channel, as the twin: x = sign(q) |q|^(4/3) 2^(e/4), e the
// gain of the coefficient's band; in intensity windows the abcd mix (before
// the reorder), else the mid/side butterfly of the left channel's flag
// (after it); the short-block reorder PERM[pattern]; the antialias
// butterflies across the pattern's first aa band boundaries; per band the
// [18] -> [36] IMDCT of its window type; the overlap-add with the previous
// granule's tail (ov_in at g = 0); the frequency inversion.  Granules at or
// past n_act are computed the same way (garbage the caller drops).  The
// dequant, the mix and the butterflies round each product and sum alone
// (__fmul_rn, __fadd_rn), as the twin's separate torch ops do; the IMDCT's
// dot products are FMA chains in coefficient order, cuBLAS's order differs.
//
// What bounds it: at the benchmark's window (B 32, G 48, stereo: 3,072
// granule-channels) it reads 7.1 MB of q and writes 13.4 MB of operand,
// 6.2 us at 3.35 TB/s; the IMDCT's 63.7 M multiply-adds take 1.9 us at
// 33.5 T/s.  So bytes, and at this size the latency of a block's chain of
// dependent loads.  The design:
//   * one block a (lane, granule), both channels (the stereo mix needs
//     both); every intermediate stays in shared memory;
//   * blocks share nothing: a block recomputes the previous granule's front
//     end (dequant, stereo, reorder, antialias) and that granule's IMDCT
//     tail alone, which the overlap-add needs.  So q is read twice (the
//     second read mostly from L2), and the IMDCT does the twin's
//     multiply-adds: U of granule g and V of granule g - 1, 648 a band,
//     plus V of granule n_act - 1 in the one block that emits the overlap;
//   * a granule's 18 slots go straight to their two places in the operand:
//     slots 0..17 of its own row (after the 16 of history) and slots 2..17
//     to the first 16 of the next granule's row; a warp writes one slot's
//     32 bands, 128 contiguous bytes;
//   * the IMDCT matrices sit in shared memory transposed, an output's 18
//     coefficients contiguous (12 KB), so a thread reads its band's 18
//     coefficients and its output's 18 matrix entries as 16-byte loads; a
//     warp is one output slot of its 32 bands, which read at most four
//     window types at once, padded onto distinct banks;
//   * every thread reads its lanes' side info itself (one broadcast load),
//     so the loads of q, the band and reorder tables and the gains start
//     at once, with no barrier before them.
//
// K15, the polyphase synthesis of K14's operand (af_mp3_synth), follows
// K14 in this file, with its own note.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// word offsets in the blob (ops/mp3_dsp.py DSP_*)
constexpr int kUV = 0;          // [4][18][36] f32: (coeffs) -> (pcm ‖ overlap')
constexpr int kP43 = 2592;      // [8208] f32: |q|^(4/3)
constexpr int kBand = 10800;    // [48][576] u8: scalefactor band of a position
constexpr int kPerm = 17712;    // [48][576] u16: short-block reorder
constexpr int kWinType = 31536; // [48][4][32] u8: window type by block type
constexpr int kAA = 33072;      // [48] i8: antialias band boundaries
constexpr int kCs = 33084;      // [8] f32: antialias cs
constexpr int kCa = 33092;      // [8] f32: antialias ca
constexpr int kPow4 = 33100;    // [4] f32: 2^(j/4)

constexpr int kThreads = 576;   // a coefficient, or a (slot, band), a thread
constexpr int kRow = 20;        // 18 floats, padded to 16 B
// a window type's transposed matrix in shared memory: 36 outputs of kRow,
// padded so the four types start on different banks
constexpr int kTypeStride = 36 * kRow + 4;
constexpr int kRowLen = 1088;   // an operand row: 34 slots x 32 bands
constexpr int kMaxQ = 8207;
constexpr int kMatrix = 18 * 36;

// meta16 columns (ops/mp3_huff.py M_*)
constexpr int kMPattern = 12;
constexpr int kMStereo = 13;
constexpr int kMBtype = 14;

__device__ __forceinline__ void load_row(const float* p, float (&r)[18]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = p4[j];
    r[4 * j] = v.x;
    r[4 * j + 1] = v.y;
    r[4 * j + 2] = v.z;
    r[4 * j + 3] = v.w;
  }
  const float2 v = reinterpret_cast<const float2*>(p)[8];
  r[16] = v.x;
  r[17] = v.y;
}

// sum_k r[k] m[k], k in order: one IMDCT output of a band (m an output's
// row of a transposed matrix in shared memory, 16-byte aligned)
__device__ __forceinline__ float dot18(const float (&r)[18], const float* m) {
  const float4* m4 = reinterpret_cast<const float4*>(m);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = m4[j];
    acc = fmaf(r[4 * j], v.x, acc);
    acc = fmaf(r[4 * j + 1], v.y, acc);
    acc = fmaf(r[4 * j + 2], v.z, acc);
    acc = fmaf(r[4 * j + 3], v.w, acc);
  }
  const float2 v = reinterpret_cast<const float2*>(m)[8];
  acc = fmaf(r[16], v.x, acc);
  return fmaf(r[17], v.y, acc);
}

template <int NCH, bool SHORT, bool MIX>
__global__ void __launch_bounds__(kThreads) mp3_dsp_kernel(
    const int32_t* __restrict__ q, const int16_t* __restrict__ meta,
    const int16_t* __restrict__ scfq, const int32_t* __restrict__ n_act,
    const float* __restrict__ ov_in, const float* __restrict__ sh_in,
    const float* __restrict__ abcd, const int32_t* __restrict__ blob, int G,
    float* __restrict__ out, float* __restrict__ ov_out,
    float* __restrict__ sh_out) {
  __shared__ __align__(16) float uv[4 * kTypeStride];  // [type][out][k]
  __shared__ float xs[2][NCH][576];                // before the reorder
  __shared__ __align__(16) float xb[2][NCH][32 * kRow];
  // per (granule slot, channel): pattern, block type (0..3)
  __shared__ int info[2][NCH][2];

  const float* fblob = reinterpret_cast<const float*>(blob);
  const uint8_t* band_tab = reinterpret_cast<const uint8_t*>(blob + kBand);
  const uint16_t* perm_tab = reinterpret_cast<const uint16_t*>(blob + kPerm);
  const uint8_t* wt_tab = reinterpret_cast<const uint8_t*>(blob + kWinType);
  const int8_t* aa_tab = reinterpret_cast<const int8_t*>(blob + kAA);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x - b * G;
  // granule slot 0 is granule g - 1 (absent at g = 0), slot 1 granule g
  const int first = g > 0 ? 0 : 1;

  // 1. dequant (and the intensity mix), position tid of each granule-channel
  // registers indexed by granule slot: the loops over it unroll, and the
  // absent slot is skipped at run time
  int src[2][NCH];   // the reorder's source position of tid
  bool ms[2];        // the left channel's mid/side flag
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < first) continue;
    const size_t lane0 = static_cast<size_t>(b * G + g - 1 + s) * NCH;
    float x[NCH];
    int band0 = 0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const size_t l = lane0 + c;
      const int qi = __ldg(q + l * 576 + tid);
      const int16_t* m = meta + l * 16;
      const int p = min(max(static_cast<int>(__ldg(m + kMPattern)), 0), 47);
      if (c == 0) ms[s] = (__ldg(m + kMStereo) & 1) != 0;
      if (tid == 0) {
        const int bt = __ldg(m + kMBtype);
        info[s][c][0] = p;
        info[s][c][1] = bt >= 0 && bt <= 3 ? bt : 0;
      }
      src[s][c] = SHORT ? __ldg(perm_tab + p * 576 + tid) : tid;
      const int band = __ldg(band_tab + p * 576 + tid);
      if (c == 0) band0 = band;
      const int e = __ldg(scfq + l * 40 + band);
      const float gain = ldexpf(__ldg(fblob + kPow4 + (e & 3)), e >> 2);
      const float v = __fmul_rn(__ldg(fblob + kP43 + min(abs(qi), kMaxQ)),
                                gain);
      x[c] = qi < 0 ? -v : (qi > 0 ? v : 0.f);
    }
    if (MIX) {
      const float* m = abcd + (lane0 / NCH) * 160 + band0;
      const float l = x[0], r = x[NCH - 1];
      x[0] = __fadd_rn(__fmul_rn(__ldg(m), l), __fmul_rn(__ldg(m + 40), r));
      x[NCH - 1] = __fadd_rn(__fmul_rn(__ldg(m + 80), l),
                             __fmul_rn(__ldg(m + 120), r));
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) xs[s][c][tid] = x[c];
  }
  // the matrices, transposed: uv[type][out][k] = UV_MATS[type][k][out]
  for (int j = tid; j < 4 * kMatrix; j += kThreads) {
    const int w = j / kMatrix, r = j - w * kMatrix;
    const int k = r / 36, o = r - k * 36;
    uv[w * kTypeStride + o * kRow + k] = __ldg(fblob + kUV + j);
  }
  __syncthreads();

  // 2. the short-block reorder, then the mid/side butterfly
  {
    const int band = tid / 18, k = tid - band * 18;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s < first) continue;
      float v[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) v[c] = xs[s][c][src[s][c]];
      if (NCH == 2 && !MIX && ms[s]) {
        const float l = v[0], r = v[NCH - 1];
        v[0] = __fadd_rn(l, r);
        v[NCH - 1] = __fsub_rn(l, r);
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) xb[s][c][band * kRow + k] = v[c];
    }
  }
  __syncthreads();

  // 3. antialias: 8 butterflies across each of the first aa boundaries;
  // each touches its own two coefficients, so they run in place
  const int n_items = (2 - first) * NCH * 31 * 8;
  for (int j = tid; j < n_items; j += kThreads) {
    const int bf = j & 7;
    const int rest = j >> 3;
    const int kb = rest % 31;          // between band kb and kb + 1
    const int sc = rest / 31;
    const int s = first + sc / NCH, c = sc - (sc / NCH) * NCH;
    if (kb < aa_tab[info[s][c][0]]) {
      float* row = xb[s][c];
      const float u = row[(kb + 1) * kRow + bf];
      const float d = row[kb * kRow + 17 - bf];
      const float cs = __ldg(fblob + kCs + bf), ca = __ldg(fblob + kCa + bf);
      row[(kb + 1) * kRow + bf] = __fsub_rn(__fmul_rn(u, cs),
                                            __fmul_rn(d, ca));
      row[kb * kRow + 17 - bf] = __fadd_rn(__fmul_rn(u, ca),
                                           __fmul_rn(d, cs));
    }
  }
  __syncthreads();

  // 4. IMDCT, overlap-add, frequency inversion: slot t of band kband
  const int t = tid >> 5;
  const int kband = tid & 31;
  const int n = min(max(__ldg(n_act + b), 0), G);
  const size_t row_g = static_cast<size_t>(b * G + g) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const size_t bc = static_cast<size_t>(b) * NCH + c;
    float cur[18];
    load_row(&xb[1][c][kband * kRow], cur);
    const int wcur = wt_tab[(info[1][c][0] * 4 + info[1][c][1]) * 32 + kband];
    const float y = dot18(cur, uv + wcur * kTypeStride + t * kRow);
    float prev;
    if (first == 0) {
      float pr[18];
      load_row(&xb[0][c][kband * kRow], pr);
      const int wp = wt_tab[(info[0][c][0] * 4 + info[0][c][1]) * 32 + kband];
      prev = dot18(pr, uv + wp * kTypeStride + (18 + t) * kRow);
    } else {
      prev = __ldg(ov_in + (bc * 32 + kband) * 18 + t);
    }
    float sv = y + prev;
    if (kband & t & 1) sv = -sv;
    float* orow = out + (row_g + c) * kRowLen;
    orow[(16 + t) * 32 + kband] = sv;
    if (t >= 2 && g + 1 < G)
      orow[NCH * kRowLen + (t - 2) * 32 + kband] = sv;
    if (g == 0 && t < 16)
      orow[t * 32 + kband] = __ldg(sh_in + (bc * 16 + t) * 32 + kband);
    if (g == n - 1) {
      ov_out[(bc * 32 + kband) * 18 + t] =
          dot18(cur, uv + wcur * kTypeStride + (18 + t) * kRow);
      if (t >= 2) sh_out[(bc * 16 + t - 2) * 32 + kband] = sv;
    } else if (n == 0 && g == 0) {
      ov_out[(bc * 32 + kband) * 18 + t] =
          __ldg(ov_in + (bc * 32 + kband) * 18 + t);
      if (t < 16)
        sh_out[(bc * 16 + t) * 32 + kband] =
            __ldg(sh_in + (bc * 16 + t) * 32 + kband);
    }
  }
}

template <int NCH, bool SHORT, bool MIX>
int launch(const void* q, const void* meta, const void* scfq,
           const void* n_act, const void* ov_in, const void* sh_in,
           const void* abcd, const void* blob, int B, int G, void* out,
           void* ov_out, void* sh_out, cudaStream_t stream) {
  mp3_dsp_kernel<NCH, SHORT, MIX><<<B * G, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(q), static_cast<const int16_t*>(meta),
      static_cast<const int16_t*>(scfq), static_cast<const int32_t*>(n_act),
      static_cast<const float*>(ov_in), static_cast<const float*>(sh_in),
      static_cast<const float*>(abcd), static_cast<const int32_t*>(blob), G,
      static_cast<float*>(out), static_cast<float*>(ov_out),
      static_cast<float*>(sh_out));
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- K15
// MP3 Layer III polyphase synthesis on Hopper (sm_90a): af_mp3_synth.
//
// It replaces no TPU kernel: the JAX package leaves this step to XLA as one
// dense Toeplitz matmul, [rows, 1088] x [1088, 576]
// (audio_formats_tpu/ops/mp3_dsp.py:286 SYNTH_TOEPLITZ, :383), and the
// port ran it as a cuBLAS fp32 GEMM: 626,688 multiply-adds a row, half of
// them on structural zeros.  This kernel computes the same linear map the
// way minimp3 does (tools/gen_mp3_synth.py extracted SYNTH_FIR from that
// simulation): the 32-point DCT-II of each subband slot (mp3d_DCT_II,
// g_sec), then the 16-tap window over the slots' DCT outputs (mp3d_synth,
// g_win / 32768), 27,624 operations a row.  Its plain version is
// ops/mp3_dsp.py synth_twin.
//
// Contract, as ops/mp3_dsp.py:synth_cuda:
//   in   [L, 1088] f32  K14's operand: row l holds slots [18 g, 18 g + 34)
//                       of its lane's (history ‖ slots), 32 bands a slot
//   blob the tables of ops/mp3_dsp.py synth_blob (SYN_* word offsets)
//   -> out [L, 576] f32 slot t of row l: sum over ages r = 0..15 of
//                       coef[j, r] V[t + 16 - r][m[j, r & 1]], V[u] the
//                       DCT of the row's slot u (slot 0 is never read:
//                       SYNTH_FIR's tap 16 is zero)
// Each step rounds alone (__fadd_rn, __fmul_rn: no contraction), in the
// order of dct2_32 and, per output, the pairs of ages (k, 15 - k) summed
// for k = 0..7 as mp3d_synth's steps do; tests/test_torch_mp3_dsp.py
// _k15_emulate does the same in numpy.
//
// What bounds it: a row reads 4,224 bytes (33 slots) and writes 2,304, so
// at the benchmark's sized window (73,728 rows) 481 MB, 0.144 ms at
// 3.35 TB/s; its 2.04 G float32 operations (none fused: 296 a slot's DCT,
// 31 a sample) take 0.061 ms at 33.5 T/s.  So bytes, and the shared-memory
// traffic of the window.  The design:
//   * a block takes kSynthRows rows: all its threads stage the rows'
//     slots 1..33 with 16-byte loads into shared memory, a slot padded to
//     33 floats, so a thread reading its own slot's 32 bands and a warp
//     reading one band of 32 slots both hit 32 banks;
//   * one thread a slot runs the DCT in registers and writes the slot's
//     DCT back in place;
//   * one thread an (output sample j, parity of the output slot): its 16
//     taps and two DCT indices in registers, it reads the 32 DCT values
//     its 9 output slots need once (an output slot t and t + 2 share 14
//     of their 16 taps' inputs: the DCT index depends on the age's parity
//     only) and writes 9 samples; a warp writes an output slot's 32
//     samples, 128 contiguous bytes.
constexpr int kSynthRows = 4;
constexpr int kSynthThreads = 64 * kSynthRows;
constexpr int kSlots = 33;       // slots 1..33 of a row
constexpr int kSlotPad = 33;     // a slot's 32 bands in shared memory
constexpr int kRowFloat4 = kSlots * 8;

// word offsets in the blob (ops/mp3_dsp.py SYN_*)
constexpr int kSynCoef = 0;      // [32][16] f32: tap of age r of sample j
constexpr int kSynM = 512;       // [32][2] i32: DCT index at even, odd ages
constexpr int kSynSec = 576;     // [24] f32: g_sec
constexpr int kSynK = 600;       // [9] f32: the 8-point stages' scales

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// minimp3's 32-point DCT-II (tools/gen_mp3_synth.py dct2_32), in place
__device__ __forceinline__ void dct32(float (&y)[32], const float* sec,
                                      const float* kc) {
  float t[4][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x0 = y[i], x1 = y[15 - i], x2 = y[16 + i], x3 = y[31 - i];
    const float t0 = add(x0, x3), t1 = add(x1, x2);
    const float t2 = mul(sub(x1, x2), __ldg(sec + 3 * i));
    const float t3 = mul(sub(x0, x3), __ldg(sec + 3 * i + 1));
    const float s2 = __ldg(sec + 3 * i + 2);
    t[0][i] = add(t0, t1);
    t[1][i] = mul(sub(t0, t1), s2);
    t[2][i] = add(t3, t2);
    t[3][i] = mul(sub(t3, t2), s2);
  }
  const float k0 = __ldg(kc), k1 = __ldg(kc + 1), k2 = __ldg(kc + 2);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float(&x)[8] = t[q];
    float xt = sub(x[0], x[7]);
    x[0] = add(x[0], x[7]);
    float x7 = sub(x[1], x[6]);
    x[1] = add(x[1], x[6]);
    float x6 = sub(x[2], x[5]);
    x[2] = add(x[2], x[5]);
    float x5 = sub(x[3], x[4]);
    x[3] = add(x[3], x[4]);
    const float x4 = sub(x[0], x[3]);
    x[0] = add(x[0], x[3]);
    float x3 = sub(x[1], x[2]);
    x[1] = add(x[1], x[2]);
    const float a0 = x[0], a1 = x[1];
    x[0] = add(a0, a1);
    x[4] = mul(sub(a0, a1), k0);
    x5 = add(x5, x6);
    x6 = mul(add(x6, x7), k0);
    x7 = add(x7, xt);
    x3 = mul(add(x3, x4), k0);
    x5 = sub(x5, mul(x7, k1));
    x7 = add(x7, mul(x5, k2));
    x5 = sub(x5, mul(x7, k1));
    const float x0 = sub(xt, x6);
    xt = add(xt, x6);
    x[1] = mul(add(xt, x7), __ldg(kc + 3));
    x[2] = mul(add(x4, x3), __ldg(kc + 4));
    x[3] = mul(sub(x0, x5), __ldg(kc + 5));
    x[5] = mul(add(x0, x5), __ldg(kc + 6));
    x[6] = mul(sub(x4, x3), __ldg(kc + 7));
    x[7] = mul(sub(xt, x7), __ldg(kc + 8));
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    y[4 * i] = t[0][i];
    y[4 * i + 1] = add(add(t[2][i], t[3][i]), t[3][i + 1]);
    y[4 * i + 2] = add(t[1][i], t[1][i + 1]);
    y[4 * i + 3] = add(add(t[2][i + 1], t[3][i]), t[3][i + 1]);
  }
  y[28] = t[0][7];
  y[29] = add(t[2][7], t[3][7]);
  y[30] = t[1][7];
  y[31] = t[3][7];
}

__global__ void __launch_bounds__(kSynthThreads) mp3_synth_kernel(
    const float* __restrict__ in, const float* __restrict__ blob, int L,
    float* __restrict__ out) {
  __shared__ float v[kSynthRows * kSlots * kSlotPad];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kSynthRows;
  const int rows =
      L - row0 < kSynthRows ? static_cast<int>(L - row0) : kSynthRows;

  // 1. stage slots 1..33 of the block's rows
  for (int f = tid; f < rows * kRowFloat4; f += kSynthThreads) {
    const int r = f / kRowFloat4, o = f - r * kRowFloat4;
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        in + (row0 + r) * kRowLen + 32) + o);
    float* d = v + r * kSlots * kSlotPad + (o >> 3) * kSlotPad + (o & 7) * 4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
  __syncthreads();

  // 2. the DCT of each slot, in place
  if (tid < rows * kSlots) {
    float* s = v + tid * kSlotPad;  // row tid / 33, slot tid % 33
    float y[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) y[k] = s[k];
    dct32(y, reinterpret_cast<const float*>(blob) + kSynSec,
          reinterpret_cast<const float*>(blob) + kSynK);
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = y[k];
  }
  __syncthreads();

  // 3. the window: sample j of the output slots p, p + 2, .., p + 16
  const int q = tid >> 6, p = (tid >> 5) & 1, j = tid & 31;
  if (q >= rows) return;
  float c[16];
  const float4* c4 = reinterpret_cast<const float4*>(blob + kSynCoef) + 4 * j;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 w = __ldg(c4 + i);
    c[4 * i] = w.x;
    c[4 * i + 1] = w.y;
    c[4 * i + 2] = w.z;
    c[4 * i + 3] = w.w;
  }
  const int* mt = reinterpret_cast<const int*>(blob + kSynM) + 2 * j;
  const int m_even = __ldg(mt), m_odd = __ldg(mt + 1);
  // x[k]: DCT of local slot p + k (row slot p + k + 1), at the index its
  // age takes: the age of output slot p + 2 i is 2 i + 15 - k
  const float* vr = v + q * kSlots * kSlotPad + p * kSlotPad;
  float x[32];
#pragma unroll
  for (int k = 0; k < 32; ++k)
    x[k] = vr[k * kSlotPad + ((k & 1) ? m_even : m_odd)];
  float* o = out + (row0 + q) * 576 + p * 32 + j;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float pair = add(mul(c[k], x[2 * i + 15 - k]),
                             mul(c[15 - k], x[2 * i + k]));
      acc = k == 0 ? pair : add(acc, pair);
    }
    o[i * 64] = acc;
  }
}

}  // namespace

extern "C" int af_mp3_window_dsp(const void* q, const void* meta,
                                 const void* scfq, const void* n_act,
                                 const void* ov_in, const void* sh_in,
                                 const void* abcd, const void* blob, int B,
                                 int G, int nch, int short_blocks, void* out,
                                 void* ov_out, void* sh_out, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (static_cast<int64_t>(B) * G > 0x7FFFFFFF || nch < 1 || nch > 2 ||
      (abcd != nullptr && nch != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AF_DSP_LAUNCH(NCH, SHORT, MIX)                                     \
  launch<NCH, SHORT, MIX>(q, meta, scfq, n_act, ov_in, sh_in, abcd, blob, \
                          B, G, out, ov_out, sh_out, s)
  if (nch == 1)
    return short_blocks ? AF_DSP_LAUNCH(1, true, false)
                        : AF_DSP_LAUNCH(1, false, false);
  if (abcd != nullptr)
    return short_blocks ? AF_DSP_LAUNCH(2, true, true)
                        : AF_DSP_LAUNCH(2, false, true);
  return short_blocks ? AF_DSP_LAUNCH(2, true, false)
                      : AF_DSP_LAUNCH(2, false, false);
#undef AF_DSP_LAUNCH
}

extern "C" int af_mp3_synth(const void* in, const void* blob, int L,
                            void* out, void* stream) {
  if (L <= 0) return 0;
  const int blocks = L / kSynthRows + (L % kSynthRows != 0);
  mp3_synth_kernel<<<blocks, kSynthThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(blob), L,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
