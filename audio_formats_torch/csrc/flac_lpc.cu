// FLAC LPC synthesis on Hopper (sm_90a), one thread per lane, 16 lanes a
// warp, each warp on one compiled instance of the step for its lanes' kind.
//
// Replaces the TPU kernel audio_formats_tpu/ops/lpc.py:_lpc_pallas_kernel
// (launched by flac_lpc_pallas).  Contract, as ops/lpc.py:flac_lpc:
//   residual [L, B] int32, coeffs [L, 32] int32, order [L] int32,
//   shift [L] int32 (0..31), exact [L] bool  ->  out [L, B] int32
//   s[t] = r[t]                                   for t < order
//   s[t] = r[t] + (sum_j c[j] * s[t-1-j]) >> shift   otherwise
// Wrap lanes (subframe bps <= 16) take the sum modulo 2^32 as int32;
// exact lanes (bps 17..18) take the int64 sum (modulo 2^64, as the twin).
// af_flac_lpc takes perm [L] int32, a permutation of the lanes: block b
// runs lanes perm[16b .. 16b + 15], reading and writing their rows in
// place, so nothing is copied, and any permutation gives the same output.
// af_flac_lpc_plan makes the one the wrapper passes: the lanes grouped by
// kind, ops/lpc.py:lpc_lane_perm on the card (three small launches).
//
// What bounds it: every lane is a serial chain of B steps, and a window has
// few lanes for the card (12,288 in the FLAC slice); bytes are ~8 a sample
// (one residual in, one sample out: 0.12 ms for a 12,288 x 4,096 window at
// 3.35 TB/s), and the multiply-adds of a 32-tap lane are issue-bound on the
// INT32 pipes (16 lanes a scheduler).  The first version (one warp of 32
// lanes, every lane 32 int64 taps, the history shifted each step, tile
// loads not in flight) ran ~690 cycles a step.  The design:
//   * 16 lanes a warp: 12,288 lanes are 768 warps, all resident, ~1.5 for
//     each of the card's 528 schedulers; all 32 threads stage the tiles;
//   * a warp runs the instance <TAPS, MODE> its lanes need: TAPS the
//     warp's largest count of taps up to the last nonzero coefficient,
//     rounded up to 4, 8, 12, 16 or 32 (0: every lane copies its residual),
//     MODE wrap (uint32 sums, one IMAD a tap) or wide (some lane exact:
//     int64 sums by mad.wide.s32, one IMAD.WIDE a tap, and each wrap lane
//     reading the low 32 bits); the plan makes nearly every warp one kind
//     (the FLAC corpus: LPC mid lanes wrap, side lanes exact);
//   * the step loop runs blocks of 8 steps unrolled, so every history index
//     inside a block is a constant; the history moves once a block (TAPS
//     register moves), which keeps each instance's code small: a 32-step
//     rotating window unrolled whole made the kernel's code too large for
//     the instruction cache once a window held many kinds;
//   * a short chain: the sum over taps 1.. of step t+1, oldest first, is
//     formed while step t runs, so step t's dependent chain is one
//     multiply-add, the shift, the add of r and a select;
//   * the [L, B] layout is kept at the boundary: 16 rows x 128 steps (512
//     bytes a row, 16-byte copies) stage through a ring of shared-memory
//     tiles by cp.async, two tiles in flight while one runs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 32;   // MAX_ORDER of the contract
constexpr int kWarp = 32;
constexpr int kLanes = 16;  // lanes (chains) a warp
constexpr int kTile = 128;  // steps a staged tile: 512 bytes of a row
constexpr int kPitch = kTile + 4;  // a tile row in shared memory (16-byte
                                   // aligned)
constexpr int kStages = 3;  // tiles in the ring: 2 in flight while one runs
constexpr int kBlock = 8;   // steps a block of the unrolled step loop

// kWrap: every lane of the warp wraps (uint32 sums); kWide: some lane is
// exact (int64 sums, each wrap lane reading the low 32 bits)
enum Mode { kWrap, kWide };

template <int MODE>
struct Acc {
  using T = uint64_t;
};
template <>
struct Acc<kWrap> {
  using T = uint32_t;
};

// acc + c s: an IMAD modulo 2^32, or one widening IMAD (mad.wide.s32, the
// 64-bit sum modulo 2^64); written as C++, the widening product of two
// int32 compiles to an unsigned IMAD.WIDE and two sign corrections
template <int MODE>
__device__ __forceinline__ typename Acc<MODE>::T mac(
    typename Acc<MODE>::T acc, int32_t c, int32_t s) {
  if constexpr (MODE == kWrap) {
    return acc + static_cast<uint32_t>(c) * static_cast<uint32_t>(s);
  } else {
    uint64_t d;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(c), "r"(s), "l"(acc));
    return d;
  }
}

__device__ __forceinline__ void cp_async4(int32_t* smem,
                                          const int32_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(int32_t* smem,
                                           const int32_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the lanes of `row` (this thread's chain: lane, ord, sh, ex); TAPS == 0
// copies
template <int TAPS, int MODE>
__device__ __forceinline__ void run(const int32_t* __restrict__ residual,
                                    const int32_t* __restrict__ coeffs,
                                    int32_t* __restrict__ out,
                                    int32_t (*ring)[kLanes][kPitch],
                                    const int64_t* row, int lane,
                                    bool chain, int ord, int sh, bool ex,
                                    int B) {
  constexpr int NC = TAPS > 0 ? TAPS : 1;
  using A = typename Acc<MODE>::T;
  const int x = threadIdx.x;
  int32_t c[NC];
  int32_t h[NC];  // h[j] = s[T - 1 - j], T the first step of the block
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    c[j] = (chain && TAPS > 0) ? coeffs[static_cast<int64_t>(lane) * kTaps + j]
                               : 0;
    h[j] = 0;
  }
  A rest = 0;  // sum over taps 1.. of the coming step

  // tile n lands in ring slot n % kStages: thread x copies steps
  // n kTile + 4x .. + 3 of each row, 16 bytes at once where the rows are
  // 16-byte aligned (vec) and the four steps lie before B; every thread
  // commits one group a tile (empty past B), so the group count stays in
  // step
  const bool vec = B % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(residual) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  auto issue = [&](int n) {
    const int t = n * kTile + 4 * x;
    if (n * kTile < B) {
      int32_t(*slot)[kPitch] = ring[n % kStages];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        if (row[i] >= 0 && vec && t + 3 < B) {
          cp_async16(&slot[i][4 * x], residual + row[i] + t);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (row[i] >= 0 && t + e < B)
              cp_async4(&slot[i][4 * x + e], residual + row[i] + t + e);
            else
              slot[i][4 * x + e] = 0;
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);

  for (int n = 0, t0 = 0; t0 < B; ++n, t0 += kTile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile n
    __syncwarp();                  // everyone's; slot (n - 1) is written out
    issue(n + kStages - 1);
    int32_t(*tile)[kPitch] = ring[n % kStages];
    if (TAPS > 0 && chain) {
      // blocks of kBlock steps, each from its residuals in registers
#pragma unroll 1
      for (int k0 = 0; k0 < kTile; k0 += kBlock) {
        int32_t rv[kBlock];
#pragma unroll
        for (int u = 0; u < kBlock; ++u) rv[u] = tile[x][k0 + u];
        int32_t sv[kBlock];  // s[T + u]
        const int lim = ord - t0 - k0;  // steps u < lim pass r through
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          // s[T + i]: this block's sv, before it the history
#define AF_S(i) ((i) >= 0 ? sv[(i) >= 0 ? (i) : 0] : h[(i) >= 0 ? 0 : -1 - (i)])
          const A sum = mac<MODE>(rest, c[0], AF_S(u - 1));
          int32_t pred;
          if constexpr (MODE == kWrap)
            pred = static_cast<int32_t>(sum) >> sh;
          else
            pred = ex ? static_cast<int32_t>(static_cast<int64_t>(sum) >> sh)
                      : static_cast<int32_t>(static_cast<uint32_t>(sum)) >> sh;
          // r + pred modulo 2^32, as the int32 reference adds
          sv[u] = u < lim
                      ? rv[u]
                      : static_cast<int32_t>(static_cast<uint32_t>(rv[u]) +
                                             static_cast<uint32_t>(pred));
          // taps 1.. of the next step read s[T + u - j], all known now:
          // the oldest first, so that only the last two multiply-adds wait
          // on this step's predecessor; two partial sums halve the chain
          A p0 = 0, p1 = 0;
#pragma unroll
          for (int j = TAPS - 1; j >= 1; --j) {
            if (j & 1)
              p1 = mac<MODE>(p1, c[j], AF_S(u - j));
            else
              p0 = mac<MODE>(p0, c[j], AF_S(u - j));
          }
          rest = p0 + p1;
#undef AF_S
        }
#pragma unroll
        for (int u = 0; u < kBlock; ++u) tile[x][k0 + u] = sv[u];
        // the history moves by kBlock: TAPS moves a block
#pragma unroll
        for (int j = NC - 1; j >= 0; --j)
          h[j] = j < kBlock ? sv[kBlock - 1 - (j < kBlock ? j : 0)]
                            : h[j >= kBlock ? j - kBlock : 0];
      }
    }
    __syncwarp();
    const int t = t0 + 4 * x;
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (row[i] < 0) continue;
      if (vec && t + 3 < B) {
        *reinterpret_cast<int4*>(out + row[i] + t) =
            *reinterpret_cast<const int4*>(&tile[i][4 * x]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t + e < B) out[row[i] + t + e] = tile[i][4 * x + e];
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

template <int TAPS>
__device__ __forceinline__ void run_mode(int mode,
                                         const int32_t* __restrict__ residual,
                                         const int32_t* __restrict__ coeffs,
                                         int32_t* __restrict__ out,
                                         int32_t (*ring)[kLanes][kPitch],
                                         const int64_t* row,
                                         int lane, bool chain, int ord, int sh,
                                         bool ex, int B) {
  if (mode == kWrap)
    run<TAPS, kWrap>(residual, coeffs, out, ring, row, lane, chain, ord, sh,
                     ex, B);
  else
    run<TAPS, kWide>(residual, coeffs, out, ring, row, lane, chain, ord, sh,
                     ex, B);
}

// 1 + a lane's last nonzero coefficient; 0 when every step copies its
// residual (order >= B, or no nonzero coefficient)
__device__ __forceinline__ int lane_taps(const int32_t* __restrict__ coeffs,
                                         int ord, int lane, int B) {
  int taps = 0;
  if (ord < B) {
    const int4* c4 =
        reinterpret_cast<const int4*>(coeffs + static_cast<int64_t>(lane) * kTaps);
#pragma unroll
    for (int q = 0; q < kTaps / 4; ++q) {
      const int4 v = c4[q];
      if (v.x) taps = 4 * q + 1;
      if (v.y) taps = 4 * q + 2;
      if (v.z) taps = 4 * q + 3;
      if (v.w) taps = 4 * q + 4;
    }
  }
  return taps;
}

constexpr int kKinds = 11;
constexpr int kPlanThreads = 256;

// ops/lpc.py:lpc_lane_key: 0 for a pass-through lane, else 2 b - 1 + exact
// for tap bucket b = 1..5 (taps within 4, 8, 12, 16, 32)
__device__ __forceinline__ int lane_kind(const int32_t* __restrict__ coeffs,
                                         const int32_t* __restrict__ order,
                                         const bool* __restrict__ exact,
                                         int lane, int B) {
  const int b = min((lane_taps(coeffs, order[lane], lane, B) + 3) >> 2, 5);
  return b == 0 ? 0 : 2 * b - 1 + (exact[lane] ? 1 : 0);
}

// The lane grouping of ops/lpc.py:lpc_lane_perm (a stable sort of the lanes
// by kind) in three launches: each lane's kind and each block's count of
// every kind; the first slot of every (block, kind); each lane's slot, after
// the lanes of its kind in earlier blocks and warps (ranks by ballot).

// plan 1: kinds[l], counts[block][kind]
__global__ void __launch_bounds__(kPlanThreads)
plan_kinds_kernel(const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ order,
                  const bool* __restrict__ exact, int L, int B,
                  uint8_t* __restrict__ kinds, int32_t* __restrict__ counts) {
  __shared__ int cnt[kKinds];
  const int tid = threadIdx.x, x = tid & 31;
  if (tid < kKinds) cnt[tid] = 0;
  __syncthreads();
  const int l = blockIdx.x * kPlanThreads + tid;
  const int k = l < L ? lane_kind(coeffs, order, exact, l, B) : -1;
  if (l < L) kinds[l] = static_cast<uint8_t>(k);
#pragma unroll
  for (int kk = 0; kk < kKinds; ++kk) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, k == kk);
    if (x == 0 && m) atomicAdd(&cnt[kk], __popc(m));
  }
  __syncthreads();
  if (tid < kKinds) counts[blockIdx.x * kKinds + tid] = cnt[tid];
}

// plan 2, one block, a warp a kind: counts[block][kind] becomes the slot of
// the block's first lane of that kind
__global__ void __launch_bounds__(kKinds * 32)
plan_bases_kernel(int32_t* __restrict__ counts, int nb) {
  __shared__ int total[kKinds];
  const int k = threadIdx.x >> 5, x = threadIdx.x & 31;
  const unsigned all = 0xFFFFFFFFu;
  int sum = 0;
  for (int b = x; b < nb; b += 32) sum += counts[b * kKinds + k];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(all, sum, d);
  if (x == 0) total[k] = sum;
  __syncthreads();
  int run = 0;  // lanes of the kinds before k
  for (int kk = 0; kk < k; ++kk) run += total[kk];
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int b = b0 + x;
    const int c = b < nb ? counts[b * kKinds + k] : 0;
    int inc = c;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(all, inc, d);
      if (x >= d) inc += v;
    }
    if (b < nb) counts[b * kKinds + k] = run + inc - c;
    run += __shfl_sync(all, inc, 31);
  }
}

// plan 3: perm[slot] = lane
__global__ void __launch_bounds__(kPlanThreads)
plan_scatter_kernel(const uint8_t* __restrict__ kinds,
                    const int32_t* __restrict__ bases, int L,
                    int32_t* __restrict__ perm) {
  __shared__ int wcnt[kPlanThreads / 32][kKinds];
  const int tid = threadIdx.x, w = tid >> 5, x = tid & 31;
  const int l = blockIdx.x * kPlanThreads + tid;
  const int k = l < L ? kinds[l] : -1;
  int rank = 0;
#pragma unroll
  for (int kk = 0; kk < kKinds; ++kk) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, k == kk);
    if (x == 0) wcnt[w][kk] = __popc(m);
    if (k == kk) rank = __popc(m & ((1u << x) - 1u));
  }
  __syncthreads();
  if (k >= 0) {
    int slot = bases[blockIdx.x * kKinds + k] + rank;
    for (int ww = 0; ww < w; ++ww) slot += wcnt[ww][k];
    perm[slot] = l;
  }
}

__global__ void __launch_bounds__(kWarp)
flac_lpc_kernel(const int32_t* __restrict__ residual,
                const int32_t* __restrict__ coeffs,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ shift,
                const bool* __restrict__ exact,
                const int32_t* __restrict__ perm,
                int32_t* __restrict__ out, int L, int B) {
  // ring[n % kStages][i][k]: lane i of the block at step n kTile + k
  __shared__ __align__(16) int32_t ring[kStages][kLanes][kPitch];
  const int x = threadIdx.x;
  const int slot0 = blockIdx.x * kLanes;
  // the first element of each lane's row, -1 past L
  __shared__ int64_t row[kLanes];
  if (x < kLanes)
    row[x] = slot0 + x < L ? static_cast<int64_t>(perm[slot0 + x]) * B : -1;
  __syncwarp();
  const bool chain = x < kLanes && slot0 + x < L;
  const int lane = chain ? perm[slot0 + x] : 0;
  const int ord = chain ? order[lane] : B;
  const int sh = chain ? shift[lane] : 0;
  const bool ex = chain && exact[lane];
  const int taps = chain ? lane_taps(coeffs, ord, lane, B) : 0;
  const unsigned all = 0xFFFFFFFFu;
  const int wtaps = __reduce_max_sync(all, taps);
  const int mode = __any_sync(all, taps > 0 && ex) ? kWide : kWrap;
  if (wtaps == 0)
    run<0, kWrap>(residual, coeffs, out, ring, row, lane, chain, ord, sh, ex,
                  B);
  else if (wtaps <= 4)
    run_mode<4>(mode, residual, coeffs, out, ring, row, lane, chain, ord, sh,
                ex, B);
  else if (wtaps <= 8)
    run_mode<8>(mode, residual, coeffs, out, ring, row, lane, chain, ord, sh,
                ex, B);
  else if (wtaps <= 12)
    run_mode<12>(mode, residual, coeffs, out, ring, row, lane, chain, ord, sh,
                 ex, B);
  else if (wtaps <= 16)
    run_mode<16>(mode, residual, coeffs, out, ring, row, lane, chain, ord, sh,
                 ex, B);
  else
    run_mode<32>(mode, residual, coeffs, out, ring, row, lane, chain, ord, sh,
                 ex, B);
}

}  // namespace

// Plain C entries for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Each launches without synchronising and returns
// cudaGetLastError() (0 on success).

// perm [L] int32 <- the lanes grouped by kind (ops/lpc.py:lpc_lane_perm);
// scratch: plan_scratch_words(L) int32 words
extern "C" int af_flac_lpc_plan(const void* coeffs, const void* order,
                                const void* exact, void* scratch, void* perm,
                                int L, int B, void* stream) {
  if (L <= 0) return 0;
  const int nb = (L + kPlanThreads - 1) / kPlanThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* counts = static_cast<int32_t*>(scratch);
  uint8_t* kinds = reinterpret_cast<uint8_t*>(counts + nb * kKinds);
  plan_kinds_kernel<<<nb, kPlanThreads, 0, st>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const int32_t*>(order),
      static_cast<const bool*>(exact), L, B, kinds, counts);
  plan_bases_kernel<<<1, kKinds * 32, 0, st>>>(counts, nb);
  plan_scatter_kernel<<<nb, kPlanThreads, 0, st>>>(
      kinds, counts, L, static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}

// the scratch words af_flac_lpc_plan needs for L lanes
extern "C" int af_flac_lpc_plan_scratch(int L) {
  const int nb = (L + kPlanThreads - 1) / kPlanThreads;
  return nb * kKinds + (L + 3) / 4;
}

extern "C" int af_flac_lpc(const void* residual, const void* coeffs,
                           const void* order, const void* shift,
                           const void* exact, const void* perm, void* out,
                           int L, int B, void* stream) {
  if (L <= 0 || B <= 0) return 0;
  const dim3 grid((L + kLanes - 1) / kLanes);
  flac_lpc_kernel<<<grid, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(residual),
      static_cast<const int32_t*>(coeffs),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(shift),
      static_cast<const bool*>(exact), static_cast<const int32_t*>(perm),
      static_cast<int32_t*>(out), L, B);
  return static_cast<int>(cudaGetLastError());
}
