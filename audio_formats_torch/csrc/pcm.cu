// PCM sample conversion on Hopper (sm_90a): K10.
//
// af_pcm_decode replaces the JAX package's ops/pcm.py:_int_to_f32 (an XLA
// elementwise kernel on the TPU) and the host unpack before it
// (models/wav.py:_unpack_int_pcm): little-endian payload bytes of kind u8,
// s16, s24 or s32 -> f32 samples, the correctly rounded quotient
//   u8: (b - 128) / 127;  s16, s24: s / (2^m - 1);  s32: f32(s) / 2^31.
//
// af_pcm_quantize replaces ops/pcm.py:_quantize_nodither,
// _quantize_dither and _quantize_pack_rows: f32 rows [L, n] -> each row's
// payload bytes [L, n * bytes] (u8 biased by 128), with
//   no dither (and s32): floor(clamp(x, -1, 1) * scale + 0.5), exact;
//   dither: floor(fma(x, scale, 0.3125) + 0.25 u1 + 0.125 u2), each step
//           rounded to f32, where u1, u2 are JAX's threefry uniforms of the
//           row's seed at the sample's position;
// then clamped to +-scale (NaN -> 0, saturated to int32, as XLA's
// convert).  The FMA is the form JAX computes on the CPU, where XLA
// contracts x * scale + 0.3125; every other float step must round alone, so
// this file builds with -fmad=false and writes its one FMA out.
//
// The dither's bits: ks = threefry2x32((0, 0x7D17), (0, seed)) (fold_in);
// k1 = threefry2x32(ks, (0, 0)), k2 = threefry2x32(ks, (0, 1)) (split); at
// position p, (a, b) = threefry2x32(k_i, (0, p)), u_i = f32 with mantissa
// (a ^ b) >> 9 and exponent 0, minus 1.  A row's keys are made once a
// block; each sample then runs two threefry2x32 (20 rounds each).
//
// Both entries are elementwise, one thread a sample; decode is bound by
// bytes (2 in and 4 out a sample for s16), the dithered quantize by its
// integer operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr float kind_scale(int kind) {
  return kind == 0 ? 127.0f
       : kind == 1 ? 32767.0f
       : kind == 2 ? 8388607.0f
                   : 2147483648.0f;
}

// ---------------------------------------------------------------- decode
__global__ void __launch_bounds__(kThreads)
pcm_decode_kernel(const uint8_t* __restrict__ raw, float* __restrict__ out,
                  int64_t n, int kind) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float v;
  if (kind == 0) {
    v = __fdiv_rn(__int2float_rn(static_cast<int>(raw[i]) - 128), 127.0f);
  } else if (kind == 1) {
    const uint8_t* p = raw + 2 * i;
    const int s = static_cast<int16_t>(p[0] | (p[1] << 8));
    v = __fdiv_rn(__int2float_rn(s), 32767.0f);
  } else if (kind == 2) {
    const uint8_t* p = raw + 3 * i;
    const uint32_t u = p[0] | (p[1] << 8) | (static_cast<uint32_t>(p[2]) << 16);
    const int s = static_cast<int>(u << 8) >> 8;  // sign-extend 24 bits
    v = __fdiv_rn(__int2float_rn(s), 8388607.0f);
  } else {
    const uint8_t* p = raw + 4 * i;
    const uint32_t u = p[0] | (p[1] << 8) | (static_cast<uint32_t>(p[2]) << 16)
                     | (static_cast<uint32_t>(p[3]) << 24);
    v = __fdiv_rn(__int2float_rn(static_cast<int>(u)), 2147483648.0f);
  }
  out[i] = v;
}

// ------------------------------------------------------------- threefry
__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// Threefry-2x32, 20 rounds, as jax.random: key (k0, k1), counter (x0, x1)
// in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ float uniform01(uint32_t k0, uint32_t k1,
                                           uint32_t pos) {
  uint32_t a = 0u, b = pos;
  threefry2x32(k0, k1, a, b);
  return __fsub_rn(__uint_as_float(((a ^ b) >> 9) | 0x3F800000u), 1.0f);
}

// ------------------------------------------------------------- quantize
// floor(x * scale + 0.5) of the clamped x, exactly: for 2^m - 1 scales the
// f64 product is exact (24 x 24 bits) and so is the f64 sum wherever the
// floor depends on it; for s32 the f32 product by 2^31 is exact.
template <int kKind>
__device__ __forceinline__ float quantize_nodither(float x) {
  if (x != x) return x;  // NaN quantizes to 0 (to_int32)
  const float xc = fminf(fmaxf(x, -1.0f), 1.0f);
  if (kKind == 3) return floorf(__fadd_rn(__fmul_rn(xc, 2147483648.0f), 0.5f));
  const double p = __dmul_rn(static_cast<double>(xc),
                             static_cast<double>(kind_scale(kKind)));
  return static_cast<float>(floor(__dadd_rn(p, 0.5)));
}

__device__ __forceinline__ int32_t to_int32(float k, float scale) {
  if (k != k) return 0;  // NaN
  k = fminf(fmaxf(k, -scale), scale);
  return __float2int_rz(k);  // saturates at 2^31
}

// One instance a kind and dither, so that a sample's path has no branch:
// the threefry rounds of the dithered kinds run straight through.
template <int kKind, bool kDither>
__global__ void __launch_bounds__(kThreads)
pcm_quantize_kernel(const float* __restrict__ x,
                    const int32_t* __restrict__ seeds,
                    uint8_t* __restrict__ out, int L, int n) {
  constexpr int bps = kKind + 1;
  const float scale = kind_scale(kKind);
  __shared__ uint32_t keys[4];
  for (int row = blockIdx.y; row < L; row += gridDim.y) {
    if (kDither) {
      __syncthreads();
      if (threadIdx.x == 0) {
        uint32_t ka = 0u, kb = static_cast<uint32_t>(seeds[row]);
        threefry2x32(0u, 0x7D17u, ka, kb);
        uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
        threefry2x32(ka, kb, a0, a1);
        threefry2x32(ka, kb, b0, b1);
        keys[0] = a0; keys[1] = a1; keys[2] = b0; keys[3] = b1;
      }
      __syncthreads();
    }
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= n) continue;
    const float xv = x[static_cast<int64_t>(row) * n + p];
    float k;
    if (kDither) {
      const float u1 = uniform01(keys[0], keys[1], static_cast<uint32_t>(p));
      const float u2 = uniform01(keys[2], keys[3], static_cast<uint32_t>(p));
      float y = __fmaf_rn(xv, scale, 0.3125f);
      y = __fadd_rn(y, __fmul_rn(0.25f, u1));
      y = __fadd_rn(y, __fmul_rn(0.125f, u2));
      k = floorf(y);
    } else {
      k = quantize_nodither<kKind>(xv);
    }
    const int32_t v = to_int32(k, scale);
    uint8_t* o = out + (static_cast<int64_t>(row) * n + p) * bps;
    const uint32_t u = static_cast<uint32_t>(kKind == 0 ? v + 128 : v);
    o[0] = static_cast<uint8_t>(u);
    if (bps > 1) o[1] = static_cast<uint8_t>(u >> 8);
    if (bps > 2) o[2] = static_cast<uint8_t>(u >> 16);
    if (bps > 3) o[3] = static_cast<uint8_t>(u >> 24);
  }
}

template <int kKind, bool kDither>
void launch_quantize(dim3 grid, cudaStream_t stream, const void* x,
                     const void* seeds, void* out, int L, int n) {
  pcm_quantize_kernel<kKind, kDither><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(seeds),
      static_cast<uint8_t*>(out), L, n);
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Each launches without synchronising and returns
// cudaGetLastError() (0 on success).  kind: 0 u8, 1 s16, 2 s24, 3 s32.

// raw [n * (kind + 1)] uint8 -> out [n] f32.
extern "C" int af_pcm_decode(const void* raw, void* out, long long n,
                             int kind, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  pcm_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<float*>(out), n, kind);
  return static_cast<int>(cudaGetLastError());
}

// x [L, n] f32, seeds [L] int32 (the uint32 seeds' bits) -> out
// [L, n * (kind + 1)] uint8.
extern "C" int af_pcm_quantize(const void* x, const void* seeds, void* out,
                               int L, int n, int kind, int dither,
                               void* stream) {
  if (L <= 0 || n <= 0) return 0;
  if (kind < 0 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, L < 65535 ? L : 65535);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dither || kind == 3) {
    switch (kind) {
      case 0: launch_quantize<0, false>(grid, s, x, seeds, out, L, n); break;
      case 1: launch_quantize<1, false>(grid, s, x, seeds, out, L, n); break;
      case 2: launch_quantize<2, false>(grid, s, x, seeds, out, L, n); break;
      default: launch_quantize<3, false>(grid, s, x, seeds, out, L, n);
    }
  } else {
    switch (kind) {
      case 0: launch_quantize<0, true>(grid, s, x, seeds, out, L, n); break;
      case 1: launch_quantize<1, true>(grid, s, x, seeds, out, L, n); break;
      default: launch_quantize<2, true>(grid, s, x, seeds, out, L, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
