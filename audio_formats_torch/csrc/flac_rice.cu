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
// thread a lane the 6,144 lanes of a dispatch are ~192 warps, ~1.5 an SM,
// and the time is one warp's chain of ~8,192 dependent decodes, each
// waiting on the one before with no other warp to hide it: the kernel runs
// far from its bound by design, a first version held to the reference.
// What the design does about the rest:
//   * a lane reads its frame through a four-word register window at its
//     cursor: a sample's unary run (at most 64 bits) and remainder (at most
//     31 bits after it) lie within it, so a sample needs no load on its own
//     chain; the window shifts in the words the sample consumed, usually one,
//     and each new 128-byte line it enters prefetches the line two ahead
//     into L1, so the shifts find their words there (a warp waits for the
//     slowest of its 32 lanes' loads);
//   * coalesced stores: a warp's lanes stage 32 consecutive output samples
//     each in shared memory, then the warp writes each lane's 128-byte row
//     segment with one store instruction, instead of 32 rows 16 KB apart per
//     instruction; chunks past every lane's block size are stored as zeros
//     without decoding;
//   * 32-thread blocks, so the few warps spread over every SM.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlkBits = 64 * 32;  // bits a pool block
constexpr int kSamp = 8;           // residual samples between cursor clamps
constexpr int kThreads = 32;       // one warp a block
constexpr unsigned kFull = 0xffffffffu;

__constant__ int32_t kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

struct Pool {
  const uint32_t* w;
  int n;  // words
  __device__ __forceinline__ uint32_t word(int i) const {
    return (i >= 0 && i < n) ? __ldg(w + i) : 0u;
  }
  // bring word i's 128-byte line into L1 ahead of the reads
  __device__ __forceinline__ void prefetch(int i) const {
    if (i >= 0 && i < n) asm volatile("prefetch.global.L1 [%0];" ::"l"(w + i));
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

// four pool words from word index wi: the residual scan's read window
struct Window {
  int wi;
  uint32_t w0, w1, w2, w3;

  __device__ __forceinline__ void load(const Pool& P, int p) {
    wi = p >> 5;
    w0 = P.word(wi);
    w1 = P.word(wi + 1);
    w2 = P.word(wi + 2);
    w3 = P.word(wi + 3);
  }
  // move the window to bit p's word; on entering a new 128-byte line,
  // prefetch the line two after it
  __device__ __forceinline__ void seek(const Pool& P, int p) {
    const int d = (p >> 5) - wi;
    if (d == 0) return;
    const int line = wi >> 5;
    if (d == 1) {
      w0 = w1; w1 = w2; w2 = w3; w3 = P.word(wi + 4);
      wi += 1;
    } else if (d == 2) {
      w0 = w2; w1 = w3; w2 = P.word(wi + 4); w3 = P.word(wi + 5);
      wi += 2;
    } else {
      load(P, p);
    }
    if ((wi >> 5) != line) P.prefetch(wi + 64);
  }
  // the 32 bits from bit r (0..95) of the window
  __device__ __forceinline__ uint32_t at(int r) const {
    const uint32_t x = r < 32 ? w0 : (r < 64 ? w1 : w2);
    const uint32_t y = r < 32 ? w1 : (r < 64 ? w2 : w3);
    return __funnelshift_l(y, x, r & 31);
  }
};

// the residual scan's state of one lane and channel
struct Scan {
  int pos, cnt, kpar, base_n, pbits, escape;
  bool raw;
};

// one residual sample: a partition crossing when the count is spent, then
// a Rice or raw value; advances the cursor and the window
__device__ __forceinline__ int rice_step(const Pool& P, Window& win, Scan& sc,
                                         bool& err) {
  if (sc.cnt == 0 && sc.pbits > 0) {
    const int o = sc.pos & 31;
    const int pr = static_cast<int>(take(win.at(o), sc.pbits));
    const bool esc = pr == sc.escape;
    const int nb = static_cast<int>(take(win.at(o + sc.pbits), 5));
    sc.pos += sc.pbits + (esc ? 5 : 0);
    sc.raw = esc;
    sc.kpar = esc ? nb : pr;
    sc.cnt = sc.base_n;
    win.seek(P, sc.pos);
  }
  const int o = sc.pos & 31;
  const uint32_t t1 = win.at(o);
  int v;
  if (sc.raw) {
    v = sext(take(t1, sc.kpar), sc.kpar);
    sc.pos += sc.kpar;
  } else {
    bool q64;
    const int q = unary(t1, win.at(o + 32), q64);
    err |= q64;
    const uint32_t rem = take(win.at(o + q + 1), sc.kpar);
    const int ui = static_cast<int>(
        (static_cast<uint32_t>(q) << (static_cast<uint32_t>(sc.kpar) & 31u)) |
        rem);
    v = (ui >> 1) ^ -(ui & 1);
    sc.pos += q + 1 + sc.kpar;
  }
  if (sc.pbits > 0) sc.cnt -= 1;
  win.seek(P, sc.pos);
  return v;
}

__device__ __forceinline__ int clamp_pos(int p, int max_pos) {
  return min(max(p, 0), max_pos);
}

__global__ void __launch_bounds__(kThreads)
flac_rice_kernel(const uint32_t* __restrict__ pool, int npool,
                 const int32_t* __restrict__ start_bits,
                 const int32_t* __restrict__ bs_in,
                 const int32_t* __restrict__ bps_in,
                 const int32_t* __restrict__ chass_in, int L, int nsamp,
                 int nch, int32_t* __restrict__ residual,
                 int32_t* __restrict__ coeffs, int32_t* __restrict__ fields,
                 bool* __restrict__ err_out, int32_t* __restrict__ end_out) {
  // [lane][sample of the chunk], padded: a lane's column writes and the
  // warp's row reads are both free of bank conflicts
  __shared__ int32_t stage[32][33];
  const int lane = threadIdx.x;
  const int l = blockIdx.x * kThreads + lane;
  const int wbase = l - lane;
  const bool valid = l < L;
  const Pool P{pool, npool * 64};
  const int max_pos = (npool - 2) * kBlkBits - 64;
  const int nblk = (nsamp + kSamp - 1) / kSamp;
  const int s_cap = nblk * kSamp;
  int pos = valid ? start_bits[l] : 0;
  const int bs = valid ? bs_in[l] : 0;
  const int bps0 = valid ? bps_in[l] : 0;
  const int chass = valid ? chass_in[l] : 0;
  const size_t LC = static_cast<size_t>(L) * nch;
  bool err = false;

  for (int ci = 0; ci < nch; ci++) {
    const size_t lc = static_cast<size_t>(l) * nch + ci;
    // ---------------- subframe header
    bool is_const = false;
    int cval = 0, wcount = 0, n_scan = 0, bs_c = 0;
    Scan sc{0, 0, 0, 0, 0, 0, false};
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
        // warm-ups (order <= 32) go to the first chunk's stage row
        for (int i = 0; i < order; i++) {
          stage[lane][i] = sext(take(P.top32(pos), sub_bps), sub_bps);
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
        sc.pbits = method == 0 ? 4 : 5;
        sc.escape = (1 << sc.pbits) - 1;
        const int po = static_cast<int>(take(P.top32(pos + 2), 4));
        pos += 6;
        sc.base_n = bs >> po;
        sc.cnt = sc.base_n - order;
        err |= sc.cnt < 0;
        const int pr = static_cast<int>(take(P.top32(pos), sc.pbits));
        pos += sc.pbits;
        sc.raw = pr == sc.escape;
        sc.kpar = pr;
        if (sc.raw) {
          sc.kpar = static_cast<int>(take(P.top32(pos), 5));
          pos += 5;
        }
        wcount = order;
      } else if (is_verb) {
        sc.raw = true;
        sc.kpar = sub_bps;
        sc.cnt = bs;
      }
      n_scan = (is_const || err) ? 0 : (is_verb ? bs : bs - order);
      fields[lc] = (is_const || is_verb) ? bs : order;
      fields[LC + lc] = shv;
      fields[2 * LC + lc] = wasted;
      fields[3 * LC + lc] = sub_bps;
      bs_c = bs;
    }

    // ---------------- residual scan, 32 output samples a chunk
    const int s_lim = min(n_scan, s_cap);
    int s = 0;
    sc.pos = pos;
    Window win;
    if (s_lim > 0) win.load(P, sc.pos);
    for (int t0 = 0; t0 < nsamp; t0 += 32) {
      if (__all_sync(kFull, t0 >= bs_c)) {
        for (int r = 0; r < 32; r++) {
          if (wbase + r < L && t0 + lane < nsamp)
            residual[(static_cast<size_t>(wbase + r) * nch + ci) * nsamp +
                     t0 + lane] = 0;
        }
        continue;
      }
      for (int j = 0; j < 32; j++) {
        const int t = t0 + j;
        int v = 0;
        if (t < bs_c) {
          if (is_const) {
            v = cval;
          } else if (t < wcount) {
            v = stage[lane][t];
          } else if (!err && s < s_lim) {
            if ((s & (kSamp - 1)) == 0) {
              sc.pos = clamp_pos(sc.pos, max_pos);
              win.seek(P, sc.pos);
            }
            v = rice_step(P, win, sc, err);
            s++;
          }
        }
        stage[lane][j] = v;
      }
      __syncwarp();
      for (int r = 0; r < 32; r++) {
        if (wbase + r < L && t0 + lane < nsamp)
          residual[(static_cast<size_t>(wbase + r) * nch + ci) * nsamp + t0 +
                   lane] = stage[r][lane];
      }
      __syncwarp();
    }
    // samples past nsamp (a block size above it) still move the cursor
    while (!err && s < s_lim) {
      if ((s & (kSamp - 1)) == 0) {
        sc.pos = clamp_pos(sc.pos, max_pos);
        win.seek(P, sc.pos);
      }
      rice_step(P, win, sc, err);
      s++;
    }
    pos = sc.pos;
    // the clamp before the next block of samples, if the scan has one
    if ((s + kSamp - 1) / kSamp < nblk) pos = clamp_pos(pos, max_pos);
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
  flac_rice_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), npool,
      static_cast<const int32_t*>(start_bits),
      static_cast<const int32_t*>(bs), static_cast<const int32_t*>(bps0),
      static_cast<const int32_t*>(chass), L, nsamp, nch,
      static_cast<int32_t*>(residual), static_cast<int32_t*>(coeffs),
      static_cast<int32_t*>(fields), static_cast<bool*>(err),
      static_cast<int32_t*>(end_bits));
  return static_cast<int>(cudaGetLastError());
}
