// FLAC subframe headers and partitioned-Rice residuals on Hopper (sm_90a).
//
// af_flac_rice replaces audio_formats_tpu/ops/flac_rice.py:282
// flac_frame_entropy (a masked lax.scan FSM over every lane, the scan at
// :461, that XLA compiled on the TPU; not a Pallas kernel).  Contract, as
// ops/flac_rice.py:flac_frame_entropy, for L frame lanes:
//   pool  [NPOOL, 64] u32  big-endian words, every lane's frame bytes at a
//                          block-aligned offset; the last two blocks zero
//   start_bits, bs, bps0, chass  [L] int32  each lane's first subframe bit
//                          (absolute), block size, frame sample bits and
//                          channel assignment
//   -> residual [L, nch, nsamp] int32 (warm-ups at [0, order), a constant
//      subframe's value below bs, zeros from bs on), coeffs [L, nch, 32],
//      fields [4, L, nch] (order, shift, wasted, sub_bps; constant and
//      verbatim subframes report order == bs), err [L], end_bits [L] (the
//      absolute cursor after the last subframe, before byte alignment).
// Semantics of the reference's masked FSM, kept bit for bit so that err
// and end_bits agree on corrupt lanes too: bits outside the pool read 0;
// the channels decode in sequence (subframe 1 starts where subframe 0
// ends); a width or shift amount n is used as the reference uses it (n & 31
// for shifts, 0 bits for n <= 0, so a 33-bit side channel's read takes 1
// bit); a unary run stops at 63 with err set, and that sample is still
// emitted; err is sticky across channels and stops the scan; before
// residual samples 0, 8, 16, ... < 8 ceil(nsamp / 8) the cursor is clamped
// to [0, (NPOOL - 2) 2048 - 64], whether the lane is still decoding or not.
//
// What bounds it: bytes are few (a dispatch of the FLAC slice reads ~90 MB
// of frames and writes ~200 MB of residuals: ~0.09 ms at 3.35 TB/s) and so
// are its operations (~16 a Rice sample: ~0.05 ms at 16.7 T int32/s), but
// each lane is one serial chain of bs samples a channel, every sample's
// cursor depending on the last one's unary run and parameter.  With one
// thread a lane the 6,144 lanes of a dispatch are ~192 warps, fewer than
// the card's 528 schedulers, so nothing hides a warp's latency: the time
// is one warp's ~8,192 samples, each the instructions it issues and the
// dependent chain it waits on; a lone warp pays each instruction's
// latency and each branch's reconvergence.  The design keeps both short,
// branch-free and the same for all 32 lanes of a warp:
//   * a lane's cursor lives in registers: three pool words and a bit offset
//     (`Win`).  A sample is the 32 bits at the cursor (one funnel shift),
//     their unary count (one FLO), the sample's length (one multiply-add
//     of constants set a group), and the window moved on by funnel shifts
//     of 0 or 32 bits, the next word coming in behind.  That word is read
//     from shared memory a sample before the window takes it, so no load
//     sits on the chain;
//   * groups of kGroup samples, one vote a group: where every lane decodes
//     all of the group or none of it, in one partition, the group runs the
//     chain alone (keeping each sample's 32 bits and FLO) and then the
//     values, which are independent of each other; elsewhere (a lane
//     starts, stops or crosses a partition) each sample applies the
//     partition header and the lane's own state by selects.  Raw and Rice
//     values are both computed and one is selected; a lane outside its
//     samples moves 0 bits.  What the window cannot decode (a unary run of
//     32 zeros or more, a sample of more than 32 bits, a word not yet
//     staged, a cursor near the pool's end where the clamp may move it)
//     marks the lane, and one vote a group sends the warp to a slow path
//     in which the marked lanes decode the group again from its start by
//     the reference's per-sample steps, reading the pool;
//   * the frame bits are staged in shared memory by cp.async: each lane
//     keeps a ring of kRingBlocks pool blocks (256 bytes each, by absolute
//     block number, so a corrupt lane may run on into its neighbour's
//     blocks; blocks past the pool are zero-filled).  At each 32-sample
//     chunk the warp waits for the copies it issued during the chunk
//     before and lists the lanes that lack a block; the warp copies their
//     blocks a few a group, with coalesced 4-byte copies, while the group
//     decodes.  The ring is word-major ([word][lane]), so a sample's read
//     is free of bank conflicts whatever the lanes' cursors;
//   * the stores stay coalesced and off the chain: each lane writes its 32
//     samples of a chunk into a double-buffered tile in shared memory (16
//     bytes a store), and during the next chunk eight threads a row store
//     16 bytes each, one instruction writing four lanes' 128-byte row
//     segments; chunks past every lane's block size are stored as zeros
//     without decoding;
//   * no branch around work in the sample loop: values are picked by
//     arithmetic and stores and copies are predicated, since a branch and
//     its reconvergence cost a lone warp more than the work;
//   * headers, warm-ups and coefficients (a few hundred serial reads a
//     lane) read the pool through the read-only path, as before;
//   * 32-thread blocks, so the few warps spread over every SM.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlkW = 64;             // words a pool block
constexpr int kBlkBits = kBlkW * 32;  // bits a pool block
constexpr int kSamp = 8;              // residual samples between clamps
constexpr int kThreads = 32;          // one warp a block
constexpr int kChunk = 32;            // output samples a stage tile
constexpr int kStageW = kChunk + 4;   // a tile row, padded to 16 bytes
constexpr int kGroup = 16;            // samples between two votes
constexpr int kRingBlocks = 4;        // pool blocks a lane keeps staged
constexpr int kRingW = kRingBlocks * kBlkW;
constexpr unsigned kFull = 0xffffffffu;

static_assert((kRingW & (kRingW - 1)) == 0, "ring words: a power of two");

__constant__ int32_t kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

struct Pool {
  const uint32_t* w;
  int n;  // words
  __device__ __forceinline__ uint32_t word(int i) const {
    return (i >= 0 && i < n) ? __ldg(w + i) : 0u;
  }
  // the 32 bits from bit p
  __device__ __forceinline__ uint32_t top32(int p) const {
    const int i = p >> 5;
    return __funnelshift_l(word(i + 1), word(i), p & 31);
  }
};

// the first w bits of hi: the reference's width masking
__device__ __forceinline__ uint32_t take(uint32_t hi, int w) {
  return w > 0 ? hi >> ((32u - static_cast<uint32_t>(w)) & 31u) : 0u;
}

__device__ __forceinline__ int sext(uint32_t v, int n) {
  const uint32_t s = n > 0 ? 1u << (static_cast<uint32_t>(n - 1) & 31u) : 0u;
  return static_cast<int>((v ^ s) - s);
}

// zeros before the first 1 of w1:w2; 63 and q64 when there is none
__device__ __forceinline__ int unary(uint32_t w1, uint32_t w2, bool& q64) {
  q64 = (w1 | w2) == 0u;
  return w1 ? __clz(static_cast<int>(w1))
            : (w2 ? 32 + __clz(static_cast<int>(w2)) : 63);
}

__device__ __forceinline__ int clamp_pos(int p, int max_pos) {
  return min(max(p, 0), max_pos);
}

// a partition's state and the subframe's partition constants
struct Part {
  int cnt, k, base_n, pbits, escape;
  bool raw;
};

// the reference's residual sample, reading the pool: a partition crossing
// when the count is spent, then a Rice or raw value; the slow path's step
__device__ int exact_sample(const Pool& P, int& pos, Part& pt, bool& err) {
  if (pt.cnt == 0 && pt.pbits > 0) {
    const int pr = static_cast<int>(take(P.top32(pos), pt.pbits));
    const bool esc = pr == pt.escape;
    const int nb = static_cast<int>(take(P.top32(pos + pt.pbits), 5));
    pos += pt.pbits + (esc ? 5 : 0);
    pt.raw = esc;
    pt.k = esc ? nb : pr;
    pt.cnt = pt.base_n;
  }
  const uint32_t t1 = P.top32(pos);
  int v;
  if (pt.raw) {
    v = sext(take(t1, pt.k), pt.k);
    pos += pt.k;
  } else {
    bool q64;
    const int q = unary(t1, P.top32(pos + 32), q64);
    err |= q64;
    const uint32_t rem = take(P.top32(pos + q + 1), pt.k);
    const int ui = static_cast<int>(
        (static_cast<uint32_t>(q) << (static_cast<uint32_t>(pt.k) & 31u)) |
        rem);
    v = (ui >> 1) ^ -(ui & 1);
    pos += q + 1 + pt.k;
  }
  if (pt.pbits > 0) pt.cnt -= 1;
  return v;
}

// a lane's cursor in registers: pool words wi, wi + 1, wi + 2 and the bit
// offset o (0..31) into the first.  The 32 bits at the cursor are one
// funnel shift of w0:w1; a fast-path sample (at most 32 bits) lies within
// them.  The cursor is wi * 32 + o.
struct Win {
  uint32_t w0, w1, w2;
  int o, wi;

  __device__ __forceinline__ int pos() const { return wi * 32 + o; }
  __device__ __forceinline__ uint32_t top() const {
    return __funnelshift_l(w1, w0, o);
  }

  // the window at bit p, read from the pool
  __device__ __forceinline__ void load(const Pool& P, int p) {
    wi = p >> 5;
    o = p & 31;
    w0 = P.word(wi);
    w1 = P.word(wi + 1);
    w2 = P.word(wi + 2);
  }

  // move on c (0..32) bits: the window moves one word where the offset
  // passes 32, w3 (word wi + 3, read before) coming in behind; funnel
  // shifts by 0 or 32 bits make both cases one form, no branch
  __device__ __forceinline__ void step(int c, uint32_t w3) {
    const int o1 = o + c;
    const unsigned s = static_cast<unsigned>(o1 & 32);
    w0 = __funnelshift_rc(w0, w1, s);
    w1 = __funnelshift_rc(w1, w2, s);
    w2 = __funnelshift_rc(w2, w3, s);
    wi += o1 >> 5;
    o = o1 & 31;
  }
};

// cp.async of one word into shared memory where `on`; 0 in place of a word
// outside the pool
__device__ __forceinline__ void stage_word(uint32_t* dst, const uint32_t* src,
                                           bool inside, bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.ca.shared.global [%0], [%1], 4, %2;\n}\n" ::"r"(d),
      "l"(src), "r"(inside ? 4 : 0), "r"(on ? 1 : 0)
      : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the bit position of x's leading 1, -1 for 0 (FLO): a unary run of
// 31 - flo(x) zeros
__device__ __forceinline__ int flo(uint32_t x) {
  int r;
  asm("bfind.u32 %0, %1;" : "=r"(r) : "r"(x));
  return r;
}

// shared memory of one warp
struct __align__(16) Smem {
  int32_t stage[2][kThreads][kStageW];       // [tile][lane][sample], padded
  int32_t warm[kThreads][kThreads + 1];      // [lane][warm-up]
  uint32_t ring[kRingW][kThreads];           // [word mod kRingW][lane]
};

// a lane's scan of one subframe: its window, partition, limits and ring
struct Scan {
  Win b;
  Part pt;
  int wcount;   // warm-ups: output samples before the scan's first
  int s_lim;    // samples to decode (s + 1 once err is set at sample s)
  int fill;     // ring: blocks below fill are issued
  int staged;   // ring: words below staged have landed
  int dflt;     // the output where the lane decodes nothing: cval or 0
};

// the warp copies one block of lane src (fill's block) into src's column
// of the ring: 64 words, two coalesced cp.async a thread; nothing where
// src < 0
__device__ __forceinline__ void ring_block(Smem& sm, const uint32_t* pool,
                                           int npw, int src, int fill,
                                           int lane) {
  const int blk = __shfl_sync(kFull, fill, src & 31);
#pragma unroll
  for (int h = 0; h < kBlkW; h += kThreads) {
    const int w = blk * kBlkW + h + lane;
    const bool inside = w >= 0 && w < npw;
    stage_word(&sm.ring[w & (kRingW - 1)][src & 31], inside ? pool + w : pool,
               inside, src >= 0);
  }
}

// the lanes whose ring lacks a block: for a lane that scans, the blocks up
// to kRingBlocks past the one holding the word it reads next (wi + 3)
__device__ __forceinline__ int ring_todo(Scan& sc, bool scans) {
  const int b0 = (sc.b.wi + 3) >> 6;
  if (sc.fill < b0) sc.fill = b0;
  return scans ? b0 + kRingBlocks - sc.fill : 0;
}

// every missing block, copied now (a channel's start, a lane that moved)
__device__ __forceinline__ void ring_fill_all(Smem& sm, const uint32_t* pool,
                                              int npw, Scan& sc, bool scans,
                                              int lane) {
  int todo = ring_todo(sc, scans);
  unsigned m;
  while ((m = __ballot_sync(kFull, todo > 0)) != 0u) {
    const int src = __ffs(m) - 1;
    ring_block(sm, pool, npw, src, sc.fill, lane);
    if (lane == src) {
      sc.fill += 1;
      todo -= 1;
    }
  }
  stage_commit();
}

// after a reload: a cursor moved below what the ring holds restarts the
// ring there (nothing staged until the next chunk's copies land)
__device__ __forceinline__ void ring_follow(Scan& sc) {
  const int b0 = (sc.b.wi + 3) >> 6;
  if (b0 < sc.fill - kRingBlocks) {
    sc.fill = b0;
    sc.staged = min(sc.staged, b0 * kBlkW);
  }
}

// p ? a : b without a branch: the compiler would otherwise branch around
// the work of a in a sample loop, and a branch costs a lone warp more than
// the work
__device__ __forceinline__ int pick(bool p, int a, int b) {
  return b ^ ((a ^ b) & -static_cast<int>(p));
}

// *dst = v where p, as one predicated store
__device__ __forceinline__ void store_if(int32_t* dst, int32_t v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q st.global.b32 [%0], %1;\n}\n" ::"l"(dst),
      "r"(v), "r"(p ? 1 : 0)
      : "memory");
}

// the 16 bytes v to dst where p, as one predicated store
__device__ __forceinline__ void store4_if(int32_t* dst, int4 v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(p ? 1 : 0)
      : "memory");
}

// a Rice sample's value from the 32 bits at its start (it lies within
// them) and their FLO f: q = 31 - f zeros, a 1, then k bits, zigzag decoded
__device__ __forceinline__ int rice_value(uint32_t hi, int f, int k,
                                          uint32_t pk) {
  const uint32_t rem = __funnelshift_rc(
      __funnelshift_lc(0u, hi, static_cast<unsigned>(32 - f)), 0u,
      static_cast<unsigned>(32 - k));
  const int ui = static_cast<int>(static_cast<uint32_t>(31 - f) * pk + rem);
  return (ui >> 1) ^ -(ui & 1);
}

// a raw k-bit sample's value: its top k bits, sign-extended
__device__ __forceinline__ int raw_value(uint32_t hi, int k) {
  return k > 0 ? static_cast<int>(hi) >> ((32 - k) & 31) : 0;
}

// kGroup samples at tile columns j0 .. j0 + kGroup - 1 (output samples
// t0 + j), branch-free.  kEach: whether a lane decodes a sample, and its
// partition, may change from sample to sample (a lane may start, stop or
// cross a partition in the group), and a partition may be raw; otherwise
// the lane decodes all of the group or none of it, in one Rice
// partition.
// Each sample's chain is the funnel shift to the cursor, the unary count
// (FLO), the sample's length c and the window's move; the value, the ring
// read and the bookkeeping hang off it.  Returns whether the lane needs
// the slow path for this group.
template <bool kEach>
__device__ __forceinline__ bool fast_group(Smem& sm, Scan& sc, int tile,
                                           int t0, int j0, int bs_c, int lane,
                                           int wlim) {
  bool slow = false;
  Win& b = sc.b;
  Part& pt = sc.pt;
  const int s0 = t0 + j0 - sc.wcount;
  // the partition's constants: a Rice sample is 32 + k - flo bits, a raw
  // one k
  const bool act0 = static_cast<unsigned>(s0) < static_cast<unsigned>(sc.s_lim);
  int mq = pt.raw || !act0 ? 0 : 1;
  int base = !act0 ? 0 : (pt.raw ? pt.k : 32 + pt.k);
  uint32_t pk = 1u << (pt.k & 31);
  int val[kGroup];
  if (kEach) {
#pragma unroll
    for (int jj = 0; jj < kGroup; jj++) {
      const int t = t0 + j0 + jj;
      const bool act =
          static_cast<unsigned>(s0 + jj) < static_cast<unsigned>(sc.s_lim);
      // the partition header, applied by selects where the count is spent
      const bool cross = act && pt.cnt == 0 && pt.pbits > 0;
      const uint32_t h0 = b.top();
      const int pr = static_cast<int>(
          __funnelshift_rc(h0, 0u, static_cast<unsigned>(32 - pt.pbits)));
      const bool esc = pr == pt.escape;
      const int nb = static_cast<int>((h0 << pt.pbits) >> 27);
      pt.raw = cross ? esc : pt.raw;
      pt.k = cross ? (esc ? nb : pr) : pt.k;
      pt.cnt = (cross ? pt.base_n : pt.cnt) - ((act && pt.pbits > 0) ? 1 : 0);
      mq = pt.raw || !act ? 0 : 1;
      base = !act ? 0 : (pt.raw ? pt.k : 32 + pt.k);
      pk = 1u << (pt.k & 31);
      b.step(cross ? pt.pbits + (esc ? 5 : 0) : 0,
             sm.ring[(b.wi + 3) & (kRingW - 1)][lane]);
      const uint32_t w3 = sm.ring[(b.wi + 3) & (kRingW - 1)][lane];
      const uint32_t hi = b.top();
      const int f = flo(hi);
      const int c = base - f * mq;
      slow |= c > 32;
      val[jj] = pick(act,
                     pt.raw ? raw_value(hi, pt.k) : rice_value(hi, f, pt.k, pk),
                     t < bs_c ? sc.dflt : 0);
      b.step(c, w3);
    }
  } else {
    // the chain alone, each sample's bits and unary count kept; then the
    // values, independent of each other
    uint32_t his[kGroup];
    int fs[kGroup];
#pragma unroll
    for (int jj = 0; jj < kGroup; jj++) {
      // the word the window may take, read ahead of the chain
      const uint32_t w3 = sm.ring[(b.wi + 3) & (kRingW - 1)][lane];
      const uint32_t hi = b.top();
      const int f = flo(hi);
      const int c = base - f * mq;
      slow |= c > 32;   // a unary run of 32 zeros or more, or a long sample
      his[jj] = hi;
      fs[jj] = f;
      b.step(c, w3);
    }
    const int dv = t0 + j0 < bs_c ? sc.dflt : 0;
#pragma unroll
    for (int jj = 0; jj < kGroup; jj++)
      val[jj] = pick(act0, rice_value(his[jj], fs[jj], pt.k, pk), dv);
  }
  // the samples decoded count down the partition
  if (!kEach && act0 && pt.pbits > 0) pt.cnt -= kGroup;
#pragma unroll
  for (int jj = 0; jj < kGroup; jj += 4) {
    *reinterpret_cast<int4*>(&sm.stage[tile][lane][j0 + jj]) =
        make_int4(val[jj], val[jj + 1], val[jj + 2], val[jj + 3]);
  }
  // every word the window took was staged; the clamps of these samples
  // move no cursor while the cursor stays below the pool's last 64 bits
  const bool any = s0 + kGroup > 0 && s0 < sc.s_lim;
  return any && (slow || b.wi + 2 >= sc.staged || b.wi > wlim);
}

// rows 4 i .. 4 i + 3 of a tile's store (lanes wbase + row, the kChunk
// samples from t0): v, read from the tile, and their address; eight
// threads a row, 16 bytes a thread, so one store instruction writes four
// 128-byte row segments
struct Rows {
  int4 v;
  int32_t* dst;
  bool ok;
  int nleft;   // samples of the row left from dst

  __device__ __forceinline__ void load(const Smem& sm, int tile, int i,
                                       int lane, int32_t* rbase,
                                       size_t rstride, int t0, int nsamp,
                                       int rows, bool on) {
    const int r = 4 * i + (lane >> 3);
    const int c = 4 * (lane & 7);
    v = *reinterpret_cast<const int4*>(&sm.stage[tile][r & 31][c]);
    dst = rbase + r * rstride + t0 + c;
    nleft = nsamp - t0 - c;
    ok = on && r < rows && nleft > 0;
  }
  // kVec: nsamp is a multiple of 4, so dst is 16-byte aligned
  template <bool kVec>
  __device__ __forceinline__ void store() const {
    if (kVec) {
      store4_if(dst, v, ok);
    } else {
      store_if(dst, v.x, ok);
      store_if(dst + 1, v.y, ok && nleft > 1);
      store_if(dst + 2, v.z, ok && nleft > 2);
      store_if(dst + 3, v.w, ok && nleft > 3);
    }
  }
};

// rows per group: a tile's kThreads rows over its kChunk / kGroup groups
constexpr int kRowQuads = kThreads / 4 / (kChunk / kGroup);

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
flac_rice_kernel(const uint32_t* __restrict__ pool, int npool,
                 const int32_t* __restrict__ start_bits,
                 const int32_t* __restrict__ bs_in,
                 const int32_t* __restrict__ bps_in,
                 const int32_t* __restrict__ chass_in, int L, int nsamp,
                 int nch, int32_t* __restrict__ residual,
                 int32_t* __restrict__ coeffs, int32_t* __restrict__ fields,
                 bool* __restrict__ err_out, int32_t* __restrict__ end_out) {
  __shared__ Smem sm;
  const int lane = threadIdx.x;
  const int l = blockIdx.x * kThreads + lane;
  const int wbase = l - lane;
  const bool valid = l < L;
  const Pool P{pool, npool * kBlkW};
  const int max_pos = (npool - 2) * kBlkBits - 64;
  // a window whose first word is at most wlim has its cursor at most
  // max_pos
  const int wlim = (npool - 2) * kBlkW - 3;
  const int nblk = (nsamp + kSamp - 1) / kSamp;
  const int s_cap = nblk * kSamp;
  const int nchunk = (nsamp + kChunk - 1) / kChunk;
  int pos = valid ? start_bits[l] : 0;
  const int bs = valid ? bs_in[l] : 0;
  const int bps0 = valid ? bps_in[l] : 0;
  const int chass = valid ? chass_in[l] : 0;
  const size_t LC = static_cast<size_t>(L) * nch;
  const size_t rstride = static_cast<size_t>(nch) * nsamp;
  const int rows = min(L - wbase, kThreads);
  bool err = false;
  Scan sc;
  sc.fill = 0;
  sc.staged = 0;

  for (int ci = 0; ci < nch; ci++) {
    const size_t lc = static_cast<size_t>(l) * nch + ci;
    // ---------------- subframe header
    bool is_const = false;
    int cval = 0, wcount = 0, n_scan = 0, bs_c = 0;
    Part pt{0, 0, 0, 0, 0, false};
    if (valid) {
      int sub_bps = bps0 + ((ci == 1 && (chass == 8 || chass == 10)) ||
                                    (ci == 0 && chass == 9)
                                ? 1
                                : 0);
      const uint32_t hdr = take(P.top32(pos), 8);
      pos += 8;
      err |= (hdr & 0x80u) != 0u;
      const int t = static_cast<int>((hdr & 0x7Eu) >> 1);
      int wasted = 0;
      if (hdr & 1u) {
        bool q64;
        wasted = unary(P.top32(pos), P.top32(pos + 32), q64) + 1;
        err |= q64;
        pos += wasted;
      }
      err |= wasted >= sub_bps;
      sub_bps = max(sub_bps - wasted, 1);
      is_const = t == 0;
      const bool is_verb = t == 1;
      const bool is_lpc = (t & 0x20) != 0;
      const bool is_fixed = (t & 0x08) != 0 && !is_lpc;
      err |= !(is_const || is_verb || is_lpc || is_fixed);
      const int order = is_lpc ? (t & 0x1F) + 1 : (is_fixed ? (t & 7) : 0);
      err |= is_fixed && order > 4;
      if (is_const) {
        cval = sext(take(P.top32(pos), sub_bps), sub_bps);
        pos += sub_bps;
      }
      const bool has_res = is_lpc || is_fixed;
      if (has_res) {
        // warm-ups (order <= 32), put into the first tile after its decode
        for (int i = 0; i < order; i++) {
          sm.warm[lane][i] = sext(take(P.top32(pos), sub_bps), sub_bps);
          pos += sub_bps;
        }
      }
      int32_t* crow = coeffs + lc * 32;
      int shv = 0;
      if (is_lpc) {
        const int p4 = static_cast<int>(take(P.top32(pos), 4));
        err |= p4 == 15;
        const int prec = p4 + 1;
        shv = max(sext(take(P.top32(pos + 4), 5), 5), 0);
        pos += 9;
        for (int j = 0; j < order; j++) {
          crow[j] = sext(take(P.top32(pos), prec), prec);
          pos += prec;
        }
        for (int j = order; j < 32; j++) crow[j] = 0;
      } else {
        const int fo = is_fixed ? min(order, 4) : 0;
        for (int j = 0; j < 4; j++) crow[j] = kFixed[fo][j];
        for (int j = 4; j < 32; j++) crow[j] = 0;
      }
      if (has_res) {
        const int method = static_cast<int>(take(P.top32(pos), 2));
        err |= method > 1;
        pt.pbits = method == 0 ? 4 : 5;
        pt.escape = (1 << pt.pbits) - 1;
        const int po = static_cast<int>(take(P.top32(pos + 2), 4));
        pos += 6;
        pt.base_n = bs >> po;
        pt.cnt = pt.base_n - order;
        err |= pt.cnt < 0;
        const int pr = static_cast<int>(take(P.top32(pos), pt.pbits));
        pos += pt.pbits;
        pt.raw = pr == pt.escape;
        pt.k = pr;
        if (pt.raw) {
          pt.k = static_cast<int>(take(P.top32(pos), 5));
          pos += 5;
        }
        wcount = order;
      } else if (is_verb) {
        pt.raw = true;
        pt.k = sub_bps;
        pt.cnt = bs;
      }
      n_scan = (is_const || err) ? 0 : (is_verb ? bs : bs - order);
      fields[lc] = (is_const || is_verb) ? bs : order;
      fields[LC + lc] = shv;
      fields[2 * LC + lc] = wasted;
      fields[3 * LC + lc] = sub_bps;
      bs_c = bs;
    }

    // ---------------- residual scan, kChunk output samples a tile
    sc.pt = pt;
    sc.wcount = wcount;
    sc.s_lim = min(n_scan, s_cap);
    sc.dflt = is_const ? cval : 0;
    sc.b.load(P, pos);
    ring_follow(sc);
    const bool scans = sc.s_lim > 0;
    // the first blocks, waited for
    ring_fill_all(sm, pool, P.n, sc, scans, lane);
    stage_wait();
    sc.staged = sc.fill * kBlkW;
    int32_t* const rbase =
        residual + (static_cast<size_t>(wbase) * nch + ci) * nsamp;
    bool pending = false;   // the other tile holds a chunk to store
    int tile = 0;
    for (int k = 0; k < nchunk; k++) {
      const int t0 = k * kChunk;
      if (__all_sync(kFull, t0 >= bs_c)) {
        // no lane decodes from here: the last tile, then zeros
        for (int i = 0; i < kThreads / 4; i++) {
          Rows rw;
          rw.load(sm, tile ^ 1, i, lane, rbase, rstride, t0 - kChunk, nsamp,
                  rows, pending);
          rw.template store<kVec>();
          rw.load(sm, tile ^ 1, i, lane, rbase, rstride, t0, nsamp, rows,
                  true);
          rw.v = make_int4(0, 0, 0, 0);
          rw.template store<kVec>();
        }
        pending = false;
        continue;
      }
      // the copies issued a chunk ago have landed (each thread reads only
      // its own lane's column); the lanes that lack a block get one each,
      // kGroup / 4 lanes a group, copied while the group decodes
      stage_wait();
      sc.staged = sc.fill * kBlkW;
      unsigned need = __ballot_sync(kFull, ring_todo(sc, scans) > 0);
#pragma unroll 1
      for (int j0 = 0; j0 < kChunk; j0 += kGroup) {
        const Win b0 = sc.b;
        const Part p0 = sc.pt;
        // the previous tile's rows, kRowQuads x 4 a group
        Rows rw[kRowQuads];
#pragma unroll
        for (int e = 0; e < kRowQuads; e++) {
          rw[e].load(sm, tile ^ 1, j0 / kGroup * kRowQuads + e, lane, rbase,
                     rstride, t0 - kChunk, nsamp, rows, pending);
        }
#pragma unroll
        for (int e = 0; e < kGroup / 4; e++) {
          const int src = __ffs(need) - 1;
          ring_block(sm, pool, P.n, src, sc.fill, lane);
          sc.fill += lane == src ? 1 : 0;
          need &= need - 1;
        }
        // the same for every sample of the group: whether the lane
        // decodes, whether the sample lies below the block size, the
        // partition (Rice, no crossing)
        const int s0 = t0 + j0 - wcount;
        const int e0 = t0 + j0;
        const bool each =
            !((s0 >= 0 && s0 + kGroup <= sc.s_lim) ||
              s0 + kGroup <= 0 || s0 >= sc.s_lim) ||
            !(e0 + kGroup <= bs_c || e0 >= bs_c) ||
            (sc.pt.pbits > 0 && sc.pt.cnt < kGroup && s0 + kGroup > 0 &&
             s0 < sc.s_lim) ||
            (sc.pt.raw && s0 + kGroup > 0 && s0 < sc.s_lim);
        const bool slow =
            __any_sync(kFull, each)
                ? fast_group<true>(sm, sc, tile, t0, j0, bs_c, lane, wlim)
                : fast_group<false>(sm, sc, tile, t0, j0, bs_c, lane, wlim);
        // the previous tile's rows, coalesced
#pragma unroll
        for (int e = 0; e < kRowQuads; e++) rw[e].template store<kVec>();
        if (__any_sync(kFull, slow) && slow) {
          // this group again from its start, the reference's steps
          int p = b0.pos();
          sc.pt = p0;
#pragma unroll 1
          for (int j = j0; j < j0 + kGroup; j++) {
            const int t = t0 + j;
            const int s = t - wcount;
            int v = t < bs_c ? sc.dflt : 0;
            if (s >= 0 && s < sc.s_lim) {
              if ((s & (kSamp - 1)) == 0) p = clamp_pos(p, max_pos);
              v = exact_sample(P, p, sc.pt, err);
              if (err) sc.s_lim = s + 1;
            }
            sm.stage[tile][lane][j] = v;
          }
          sc.b.load(P, p);
          ring_follow(sc);
        }
      }
      stage_commit();
      // the warm-ups below the block size
      if (k == 0) {
        for (int i = 0; i < min(wcount, bs_c); i++)
          sm.stage[tile][lane][i] = sm.warm[lane][i];
      }
      __syncwarp();
      pending = true;
      tile ^= 1;
    }
    // the last tile
    if (pending) {
      for (int i = 0; i < kThreads / 4; i++) {
        Rows rw;
        rw.load(sm, tile ^ 1, i, lane, rbase, rstride, (nchunk - 1) * kChunk,
                nsamp, rows, true);
        rw.template store<kVec>();
      }
    }
    stage_wait();
    __syncwarp();
    // samples past the last tile (a block size above nsamp) still move
    // the cursor
    pos = sc.b.pos();
    for (int s = max(nchunk * kChunk - wcount, 0); s < sc.s_lim; s++) {
      if ((s & (kSamp - 1)) == 0) pos = clamp_pos(pos, max_pos);
      exact_sample(P, pos, sc.pt, err);
      if (err) sc.s_lim = s + 1;
    }
    // the clamp before the next block of samples, if the scan has one
    if ((sc.s_lim + kSamp - 1) / kSamp < nblk) pos = clamp_pos(pos, max_pos);
  }
  if (valid) {
    err_out[l] = err;
    end_out[l] = pos;
  }
}

}  // namespace

// residual [L, nch, nsamp], coeffs [L, nch, 32], fields [4, L, nch] int32,
// err [L] bool, end_bits [L] int32 <- the frame pool and the lanes
extern "C" int af_flac_rice(const void* pool, int npool,
                            const void* start_bits, const void* bs,
                            const void* bps0, const void* chass, int L,
                            int nsamp, int nch, void* residual, void* coeffs,
                            void* fields, void* err, void* end_bits,
                            void* stream) {
  if (L <= 0) return 0;
  const int blocks = (L + kThreads - 1) / kThreads;
  // 16-byte row stores where every row starts 16-byte aligned
  auto* kernel = nsamp % 4 == 0 ? flac_rice_kernel<true>
                                : flac_rice_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), npool,
      static_cast<const int32_t*>(start_bits),
      static_cast<const int32_t*>(bs), static_cast<const int32_t*>(bps0),
      static_cast<const int32_t*>(chass), L, nsamp, nch,
      static_cast<int32_t*>(residual), static_cast<int32_t*>(coeffs),
      static_cast<int32_t*>(fields), static_cast<bool*>(err),
      static_cast<int32_t*>(end_bits));
  return static_cast<int>(cudaGetLastError());
}
