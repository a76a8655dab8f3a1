// MP3 Layer III Huffman decode on Hopper (sm_90a).
//
// af_mp3_huff replaces audio_formats_tpu/ops/mp3_huff.py:_huff_core (two
// lax.scan loops that XLA compiled on the TPU, not a Pallas kernel).
// Contract, as ops/mp3_huff.py:huff_decode, for L independent lanes (one
// granule-channel each):
//   pool  [N] u32  big-endian words, frame after frame: lpf consecutive
//                  lanes (a frame's granule-channels) share a frame's
//                  words, which start at offs[l] (the exclusive cumsum of
//                  the spans of the frames before it; lpf 1: lane after
//                  lane)
//   meta  [L, 16] int16  bit_start, bit_limit, big_values, bnd0, bnd1,
//                  tab0..2, lin0..2, count1 table, pattern, (stereo,
//                  block type: unused here), span (the frame's words);
//                  bit positions count from the frame's first word
//   perm  [L] int32  a permutation of the lanes: warp w runs lanes
//                  perm[32w .. 32w + 31]; any permutation gives the same
//                  output.  af_mp3_huff_plan makes offs and the one the
//                  wrapper passes (lanes by pair count, the order of
//                  ops/mp3_huff.py:huff_lane_perm)
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
// What bounds it: bytes are few (a window of the MP3 slice reads ~10 MB of
// pool words and meta and writes its 226 MB q plane once: ~0.07 ms at 3.35
// TB/s), and each lane is a serial chain of ~180 steps.  The first version
// (one thread a lane in the window's order, three pool loads a step, each
// pair stored as an int2 to the lane's own row) ran 0.49 ms: a warp's load
// or store touches 32 rows, so the load/store unit took ~128 L1 wavefronts
// a warp-step, and a warp ran as long as its longest lane (1.54x the mean
// on the slice's window, whose warps mix tonal, dense and quiet granules).
// The design:
//   * uniform warps: a plan on the card (a stable counting sort and the
//     span cumsum, three small launches) orders the lanes by pair count
//     (count1 is ~1 step a lane there), so a warp's lanes run nearly the
//     same number of steps (1.004x the mean); the kernel reads meta and
//     offsets through the permutation and writes each lane's own row, so
//     nothing moves;
//   * a sliding word window: the three words a step reads (a, b, c) and the
//     next one (d) stay in registers; a step shifts in only the words it
//     consumed (0 to 2 a pair), and the word it loads is the one after the
//     window, so no load is on the step's own chain.  A clamp that moves the
//     position backwards (a lane that starts past (W - 3) * 32) reloads the
//     window;
//   * the fields after a codeword (linbits, sign, linbits, sign: at most 28
//     bits) come from one 32-bit funnel shift of the window and are taken
//     off its top by shifts, not read one by one across three words (a lane
//     whose side info gives more than the tables' 13 linbits reads them one
//     by one, as the reference);
//   * coalesced stores: a warp's pairs stage in shared memory, 8 pairs (64
//     bytes) a lane, and every 8 pairs the warp writes the 32 segments with
//     16-byte stores, whole 32-byte sectors, zeros past a lane's pairs
//     included; the warp zeroes the rest of its rows with coalesced stores
//     before count1, whose few values each lane then stores itself;
//   * the tables (two-level code lookup, count1, TOTAL_W, BAND_OF_PAIR,
//     ~45 KB) are copied once a block into shared memory, so the lookups
//     with lane-varying indices hit shared memory; with the 16 KB of
//     staging a 256-thread block takes ~62 KB, so 3 blocks fit an SM and a
//     98,304-lane window's 384 blocks run in one wave.

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
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;  // q positions a lane stages (8 pairs, 64 bytes)

__device__ __forceinline__ uint32_t shift64(uint32_t a, uint32_t b,
                                            uint32_t o) {
  // the 32 bits starting at bit o (0..31) of a‖b: one funnel shift
  return __funnelshift_l(b, a, o);
}

// the 32 bits starting at bit o (0..63) of a‖b‖c
__device__ __forceinline__ uint32_t bits32(uint32_t a, uint32_t b,
                                           uint32_t c, int o) {
  return o < 32 ? __funnelshift_l(b, a, o) : __funnelshift_l(c, b, o);
}

// the top `width` bits of v (0 when width == 0)
__device__ __forceinline__ uint32_t top(uint32_t v, int width) {
  return width > 0 ? v >> (32 - width) : 0u;
}

// bits [o, o + width) of a‖b‖c, width 0..19; 0 when width == 0
__device__ __forceinline__ uint32_t extract(uint32_t a, uint32_t b,
                                            uint32_t c, int o, int width) {
  if (o >= 32) { a = b; b = c; c = 0u; o -= 32; }
  if (o >= 32) { a = b; b = c; o -= 32; }
  const uint32_t hi = shift64(a, b, static_cast<uint32_t>(o));
  return width > 0 ? hi >> ((32 - width) & 31) : 0u;
}

// A lane's words wbase .. wbase + 3 in registers
struct Window {
  const uint32_t* row;
  int span;
  int wbase;
  uint32_t a, b, c, d;

  __device__ __forceinline__ uint32_t word(int w) const {
    return w < span ? __ldg(row + w) : 0u;
  }
  __device__ __forceinline__ void load(int w0) {
    wbase = w0;
    a = word(w0);
    b = word(w0 + 1);
    c = word(w0 + 2);
    d = word(w0 + 3);
  }
  // slide to the window that starts at word pos >> 5
  __device__ __forceinline__ void seek(int pos) {
    const int w0 = pos >> 5;
    const int k = w0 - wbase;
    if (k == 0) return;
    if (k == 1) {
      a = b; b = c; c = d; d = word(w0 + 3);
    } else if (k == 2) {
      a = c; b = d; c = word(w0 + 2); d = word(w0 + 3);
    } else {
      load(w0);  // backwards (the clamp) or a jump
      return;
    }
    wbase = w0;
  }
};

// Write segment `seg` (q positions 16 seg .. 16 seg + 15) of the warp's 32
// rows from the staging area: 4 rounds of 8 rows x 64 bytes, 16 bytes a
// thread.  A lane's pair i of the segment sits at int2 slot i ^ ((lane >> 1)
// & 7), which keeps both the lanes' int2 writes and these reads free of
// bank conflicts.
__device__ __forceinline__ void flush(const int32_t* stage, int x,
                                      int my_lane, int seg,
                                      int32_t* __restrict__ q) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 8 * k + (x >> 2);
    const int part = x & 3;  // 16-byte part of the segment: pairs 2p, 2p+1
    const int sw = (r >> 1) & 7;
    const int slot = (2 * part) ^ (sw & 6);
    int4 v = *reinterpret_cast<const int4*>(stage + r * kSeg + 2 * slot);
    if (sw & 1) v = make_int4(v.z, v.w, v.x, v.y);
    const int lane = __shfl_sync(0xFFFFFFFFu, my_lane, r);
    if (lane >= 0)
      *reinterpret_cast<int4*>(q + static_cast<int64_t>(lane) * 576 +
                               seg * kSeg + 4 * part) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
mp3_huff_kernel(const uint32_t* __restrict__ pool,
                const int32_t* __restrict__ offs,
                const int16_t* __restrict__ meta,
                const int32_t* __restrict__ perm,
                const uint32_t* __restrict__ blob, int blob_len, int L,
                int W, int32_t* __restrict__ q, bool* __restrict__ err) {
  extern __shared__ uint32_t s_blob[];
  // staging after the blob: [warp][lane][16] int32, 16-byte aligned
  int32_t* const s_stage = reinterpret_cast<int32_t*>(
      s_blob + ((blob_len + 3) & ~3));
  for (int i = threadIdx.x; i < blob_len; i += blockDim.x)
    s_blob[i] = blob[i];
  __syncthreads();
  const int x = threadIdx.x & 31;
  int32_t* const stage = s_stage + (threadIdx.x >> 5) * 32 * kSeg;
  const unsigned all = 0xFFFFFFFFu;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of a warp stays to the end: the warp writes its rows
  // together; a thread past L has lane -1 and no pairs
  const int l = slot < L ? perm[slot] : -1;
  const bool live = l >= 0;

  int m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    m[k] = live ? meta[static_cast<int64_t>(l) * 16 + k] : 0;
  const int bit_limit = m[1];
  const int bv = m[2];
  const int bnd0 = m[3], bnd1 = m[4];
  const int tab0 = m[5] & 31, tab1 = m[6] & 31, tab2 = m[7] & 31;
  const int lin0 = m[8], lin1 = m[9], lin2 = m[10];
  const int c1base = kCount1 + 64 * (m[11] & 1);
  const int pattern = min(max(m[12], 0), 47);
  Window win;
  win.span = min(m[15], W);
  win.row = pool + (live ? offs[l] : 0);
  int32_t* out = q + static_cast<int64_t>(live ? l : 0) * 576;
  const uint8_t* bop =
      reinterpret_cast<const uint8_t*>(s_blob + kBandOfPair) + pattern * 288;
  const int max_pos = (W - 3) * 32;
  if (live) err[l] = false;

  int pos = m[0];
  win.load(pos >> 5);
  // ---- big values: pairs (x, y), the warp in step to its longest lane ----
  const int npairs = live ? min(bv, 288) : 0;
  const int wpairs = __reduce_max_sync(all, max(npairs, 0));
  const int swz = (x >> 1) & 7;
  for (int i = 0; i < wpairs; ++i) {
    int xs = 0, ys = 0;
    if (i < npairs) {
      const int band = bop[i];
      const bool in1 = band >= bnd0, in2 = band >= bnd1;
      const int t = in2 ? tab2 : (in1 ? tab1 : tab0);
      const int linb = in2 ? lin2 : (in1 ? lin1 : lin0);
      const int sh = pos & 31;
      const uint32_t a = win.a, b = win.b, c = win.c;
      const uint32_t peek = shift64(a, b, sh) >> 13;
      uint32_t e = s_blob[s_blob[kBases + t] + (peek >> (19 - kFirstBits))];
      if (e & 0x80000000u) {
        const int ext = (e >> 24) & 15;
        e = s_blob[(e & 0xFFFFFFu) +
                   ((peek >> (19 - kFirstBits - ext)) & ((1u << ext) - 1u))];
      }
      const int ln = e & 31;
      const int xq = (e >> 8) & 15, yq = (e >> 12) & 15;
      const int lx = xq == 15 ? linb : 0;
      const int ly = yq == 15 ? linb : 0;
      int xv, yv, used;
      bool xneg, yneg;
      if (linb <= 13) {
        // linbits, sign, linbits, sign: at most 28 bits after the codeword,
        // which ends by bit 50, so one 32-bit funnel holds them all
        uint32_t v = bits32(a, b, c, sh + ln);
        xv = xq + static_cast<int>(top(v, lx));
        v <<= lx;
        const int px = xv != 0;
        xneg = px && (v >> 31);
        v <<= px;
        yv = yq + static_cast<int>(top(v, ly));
        v <<= ly;
        const int py = yv != 0;
        yneg = py && (v >> 31);
        used = ln + lx + px + ly + py;
      } else {
        // linbits past the tables' 13 (side info no stream gives): the
        // field-by-field reads of the reference
        int o = sh + ln;
        xv = xq + static_cast<int>(extract(a, b, c, o, lx));
        o += lx;
        const int px = xv != 0;
        xneg = px && extract(a, b, c, o, 1) == 1u;
        o += px;
        yv = yq + static_cast<int>(extract(a, b, c, o, ly));
        o += ly;
        const int py = yv != 0;
        yneg = py && extract(a, b, c, o, 1) == 1u;
        used = o + py - sh;
      }
      pos = min(pos + used, max_pos);
      win.seek(pos);
      xs = xneg ? -xv : xv;
      ys = yneg ? -yv : yv;
    }
    *reinterpret_cast<int2*>(stage + x * kSeg + 2 * ((i & 7) ^ swz)) =
        make_int2(xs, ys);
    if ((i & 7) == 7) {
      __syncwarp();
      flush(stage, x, l, i >> 3, q);
      __syncwarp();
    }
  }
  const int nseg = (wpairs + 7) >> 3;  // segments the flushes write
  if (wpairs & 7) {
    for (int k = wpairs & 7; k < 8; ++k)
      *reinterpret_cast<int2*>(stage + x * kSeg + 2 * (k ^ swz)) =
          make_int2(0, 0);
    __syncwarp();
    flush(stage, x, l, nseg - 1, q);
  }
  // zeros past the flushed segments, row after row, 32 x 16 bytes a store
  const int tail = 576 / 4 - nseg * (kSeg / 4);  // int4s a row
  for (int r = 0; r < 32; ++r) {
    const int lane = __shfl_sync(all, l, r);
    if (lane < 0) continue;
    int4* dst = reinterpret_cast<int4*>(q + static_cast<int64_t>(lane) * 576 +
                                        nseg * kSeg);
    for (int k = x; k < tail; k += 32) dst[k] = make_int4(0, 0, 0, 0);
  }
  __syncwarp();  // the zeros before any count1 value of the same rows
  if (!live) return;

  // ---- count1: quads of -1/0/1 from position 2 bv ----
  const int tw = static_cast<int>(s_blob[kTotalW + pattern]);
  for (int s0 = 2 * bv; s0 <= 572; s0 += 4) {
    win.seek(pos);
    const int sh = pos & 31;
    const uint32_t a = win.a, b = win.b, c = win.c;
    const uint32_t e = s_blob[c1base + (shift64(a, b, sh) >> 26)];
    const int ln = e & 7;
    const int vmask = (e >> 8) & 15;
    if (pos + ln > bit_limit) break;  // codeword past the region: stop
    // at most 4 sign bits after a codeword that ends by bit 37
    uint32_t v = bits32(a, b, c, sh + ln);
    int used = ln;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool pv = s < 2 ? s0 < tw : s0 + 2 < tw;
      if (pv && ((vmask >> (3 - s)) & 1)) {
        out[s0 + s] = (v >> 31) ? -1 : 1;
        v <<= 1;
        ++used;
      }
    }
    pos = min(pos + used, max_pos);
    if (s0 + 2 >= tw) break;
  }
}

// ---- the plan: each lane's first pool word and the lane order ----
// ops/mp3_huff.py:huff_lane_perm (a stable sort of the lanes by big-values
// pair count) and ops/mp3_huff.py:_lane_offsets (the exclusive cumsum of
// the frames' spans, each frame's counted at its first lane, modulo 2^32,
// as the int32 offsets the kernel reads), in three launches: each block's
// count of every pair count, their prefix and its span sum; the first slot
// of every (block, pair count), a warp a pair count, and each block's first
// word; each lane's slot and word.
constexpr int kKeys = 289;  // pair counts 0..288
constexpr int kPlanThreads = 256;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kMetaBv = 2, kMetaSpan = 15;

__device__ __forceinline__ int lane_key(const int16_t* __restrict__ meta,
                                        int l) {
  return min(max(static_cast<int>(meta[static_cast<int64_t>(l) * 16 +
                                       kMetaBv]), 0), kKeys - 1);
}

__device__ __forceinline__ uint32_t lane_span(
    const int16_t* __restrict__ meta, int l) {
  return static_cast<uint32_t>(
      static_cast<int>(meta[static_cast<int64_t>(l) * 16 + kMetaSpan]));
}

// exclusive prefix over the warp, and the warp's total
__device__ __forceinline__ uint32_t warp_exclusive(uint32_t v, int x,
                                                   uint32_t* total) {
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (x >= d) inc += u;
  }
  *total = __shfl_sync(0xFFFFFFFFu, inc, 31);
  return inc - v;
}

// plan 1: counts[block][key]; below[block][key], the block's lanes of
// smaller pair counts; bsum[block]
__global__ void __launch_bounds__(kPlanThreads)
plan_count_kernel(const int16_t* __restrict__ meta, int L, int lpf,
                  int32_t* __restrict__ counts, int32_t* __restrict__ below,
                  uint32_t* __restrict__ bsum) {
  __shared__ int hist[kKeys];
  __shared__ uint32_t wsum[kPlanWarps];
  const int tid = threadIdx.x, x = tid & 31;
  for (int k = tid; k < kKeys; k += kPlanThreads) hist[k] = 0;
  __syncthreads();
  const int l = blockIdx.x * kPlanThreads + tid;
  uint32_t span = 0;  // a frame's words, counted at its first lane
  if (l < L) {
    atomicAdd(&hist[lane_key(meta, l)], 1);
    if (l % lpf == 0) span = lane_span(meta, l);
  }
  uint32_t total;
  warp_exclusive(span, x, &total);
  if (x == 0) wsum[tid >> 5] = total;
  __syncthreads();
  int32_t* const cnt = counts + blockIdx.x * kKeys;
  int32_t* const blw = below + blockIdx.x * kKeys;
  if (tid < 32) {  // one warp: the block's counts and their prefix
    uint32_t run = 0;
    for (int k0 = 0; k0 < kKeys; k0 += 32) {
      const int k = k0 + x;
      const uint32_t v = k < kKeys ? static_cast<uint32_t>(hist[k]) : 0u;
      uint32_t chunk;
      const uint32_t ex = warp_exclusive(v, x, &chunk);
      if (k < kKeys) {
        cnt[k] = static_cast<int32_t>(v);
        blw[k] = static_cast<int32_t>(run + ex);
      }
      run += chunk;
    }
  } else if (tid == 32) {
    uint32_t sum = 0;
    for (int w = 0; w < kPlanWarps; ++w) sum += wsum[w];
    bsum[blockIdx.x] = sum;
  }
}

// plan 2, a warp a pair count k (and one more warp for the words): the
// slot of k's first lane is the lanes of smaller pair counts in all blocks;
// counts[block][k] becomes the slot of the block's first lane of k, and
// bsum[block] the block's first word
__global__ void __launch_bounds__(kPlanThreads)
plan_base_kernel(int32_t* __restrict__ counts,
                 const int32_t* __restrict__ below,
                 uint32_t* __restrict__ bsum, int nb) {
  const int k = blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
  const int x = threadIdx.x & 31;
  const unsigned all = 0xFFFFFFFFu;
  if (k > kKeys) return;
  if (k == kKeys) {
    uint32_t run = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + x;
      const uint32_t v = b < nb ? bsum[b] : 0u;
      uint32_t total;
      const uint32_t ex = warp_exclusive(v, x, &total);
      if (b < nb) bsum[b] = run + ex;
      run += total;
    }
    return;
  }
  int start = 0;
  for (int b = x; b < nb; b += 32) start += below[b * kKeys + k];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) start += __shfl_xor_sync(all, start, d);
  uint32_t run = static_cast<uint32_t>(start);
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int b = b0 + x;
    const uint32_t v =
        b < nb ? static_cast<uint32_t>(counts[b * kKeys + k]) : 0u;
    uint32_t total;
    const uint32_t ex = warp_exclusive(v, x, &total);
    if (b < nb) counts[b * kKeys + k] = static_cast<int32_t>(run + ex);
    run += total;
  }
}

// plan 3: perm[slot] = lane, offs[lane]; a lane's slot follows the lanes of
// its pair count in earlier blocks, earlier warps (wcnt) and earlier lanes
// of its warp (match_any); its word is its frame's first lane's
__global__ void __launch_bounds__(kPlanThreads)
plan_place_kernel(const int16_t* __restrict__ meta, int L, int lpf,
                  const int32_t* __restrict__ bases,
                  const uint32_t* __restrict__ bfirst,
                  int32_t* __restrict__ perm, int32_t* __restrict__ offs) {
  __shared__ int wcnt[kPlanWarps][kKeys];
  __shared__ uint32_t wsum[kPlanWarps];
  const int tid = threadIdx.x, w = tid >> 5, x = tid & 31;
  for (int i = tid; i < kPlanWarps * kKeys; i += kPlanThreads)
    (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const int l = blockIdx.x * kPlanThreads + tid;
  const bool live = l < L;
  const int key = live ? lane_key(meta, l) : -1;
  const int in_frame = live ? l % lpf : 0;
  const uint32_t span = live && in_frame == 0 ? lane_span(meta, l) : 0u;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
  const unsigned below = peers & ((1u << x) - 1u);
  if (live && below == 0) wcnt[w][key] = __popc(peers);
  uint32_t total;
  const uint32_t ex = warp_exclusive(span, x, &total);
  if (x == 0) wsum[w] = total;
  __syncthreads();
  if (!live) return;
  int slot = bases[blockIdx.x * kKeys + key] + __popc(below);
  uint32_t word = bfirst[blockIdx.x] + ex;
  for (int ww = 0; ww < w; ++ww) {
    slot += wcnt[ww][key];
    word += wsum[ww];
  }
  // past the frame's first lane, the cumsum holds its frame's span
  if (in_frame) word -= lane_span(meta, l - in_frame);
  perm[slot] = l;
  offs[l] = static_cast<int32_t>(word);
}

// shared memory of a block: the blob, then 32 lanes x 16 int32 a warp
size_t smem_bytes(int blob_len) {
  return static_cast<size_t>((blob_len + 3) & ~3) * sizeof(uint32_t) +
         static_cast<size_t>(kWarps) * 32 * kSeg * sizeof(int32_t);
}

}  // namespace

// scratch int32 words af_mp3_huff_plan needs for L lanes
extern "C" int af_mp3_huff_plan_scratch(int L) {
  const int nb = (L + kPlanThreads - 1) / kPlanThreads;
  return nb * (2 * kKeys + 1);
}

// offs [L] int32, perm [L] int32 <- the plan of meta [L, 16] int16 whose
// lanes make frames of lpf
extern "C" int af_mp3_huff_plan(const void* meta, int L, int lpf,
                                void* scratch, void* offs, void* perm,
                                void* stream) {
  if (L <= 0) return 0;
  if (lpf < 1 || L % lpf) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (L + kPlanThreads - 1) / kPlanThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* below = counts + nb * kKeys;
  uint32_t* bsum = reinterpret_cast<uint32_t*>(below + nb * kKeys);
  const int16_t* m = static_cast<const int16_t*>(meta);
  plan_count_kernel<<<nb, kPlanThreads, 0, st>>>(m, L, lpf, counts, below,
                                                 bsum);
  plan_base_kernel<<<(kKeys + kPlanWarps) / kPlanWarps, kPlanThreads, 0,
                     st>>>(counts, below, bsum, nb);
  plan_place_kernel<<<nb, kPlanThreads, 0, st>>>(
      m, L, lpf, counts, bsum, static_cast<int32_t*>(perm),
      static_cast<int32_t*>(offs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int af_mp3_huff(const void* pool, const void* offs,
                           const void* meta, const void* perm,
                           const void* blob, int blob_len, int L, int W,
                           void* q, void* err, void* stream) {
  if (L <= 0) return 0;
  const size_t smem = smem_bytes(blob_len);
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
      static_cast<const int16_t*>(meta), static_cast<const int32_t*>(perm),
      static_cast<const uint32_t*>(blob), blob_len, L, W,
      static_cast<int32_t*>(q), static_cast<bool*>(err));
  return static_cast<int>(cudaGetLastError());
}
