"""The port's FLAC device-Rice wire against the JAX package's, on the CPU.

* ``ops.flac_rice.flac_frame_entropy`` (the plain twin on a CPU tensor)
  against JAX's ``flac_frame_entropy`` on every output and every lane, at
  one shape (so JAX compiles once): the ten subframe cases of
  tests/test_flac_device_rice.py, 24-bit frames, corrupt frames (byte flips,
  a zeroed run, frames cut short), a pool too small for its frames (the
  cursor clamp) and random-bit lanes.  Tolerance 0: an integer path.
* The pool builders: the torch gather equals JAX's word for word and the
  host pool on every frame's own bytes; the C builder equals numpy's.
* ``BatchDecoder(..., device="cpu", flac_wire="rice")`` against JAX's
  ``BatchDecoder`` under ``AF_TPU_FLAC_DEVICE_RICE=1`` and against the
  port's packed wire: PCM bit-equal, the same lane errors, no demotion.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_formats_tpu import AudioStream
from audio_formats_tpu.ops import flac_rice as jrice
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder
from audio_formats_torch.host import native
from audio_formats_torch.ops import flac_rice
from audio_formats_torch.parallel.groups import flac_rice as rice_groups

from golden import flac_ref

import test_flac_device_rice as ref_cases
import torch_flac_cases as cases

#: one shape for every twin-against-JAX case: JAX compiles it once
L, NSAMP, NCH, NPOOL = 32, 1024, 2, 320
KEYS = ("residual", "coeffs", "order", "shift", "wasted", "sub_bps", "err",
        "end_bits")


def _entropy_both(pool, sb, bs, bps, ca):
    """(port twin, JAX) outputs as numpy dicts, after holding them equal."""
    want = jrice.flac_frame_entropy(
        jnp.asarray(pool), sb, bs, bps, ca, L=L, NSAMP=NSAMP, nch=NCH,
        NPOOL=NPOOL)
    got = flac_rice.flac_frame_entropy(pool, sb, bs, bps, ca, L, NSAMP, NCH,
                                       NPOOL)
    got = {k: got[k].numpy() for k in KEYS}
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    return got


def test_cases_are_the_references():
    assert cases.CASES == ref_cases.CASES
    for _, kw in cases.CASES[:4] + [("24", {"bps": 24, "n": 1500})]:
        assert cases.make_stream(np.random.default_rng(1), **kw) == \
            ref_cases._make(np.random.default_rng(1), **kw)


@pytest.mark.parametrize("name,kw", cases.CASES,
                         ids=[c[0] for c in cases.CASES])
def test_twin_matches_jax_on_subframe_cases(name, kw):
    frames = cases.case_frames(name, kw)
    pool, sb, bs, bps, ca = cases.lanes(frames, L, NPOOL)
    got = _entropy_both(pool, sb, bs, bps, ca)
    n = len(frames)
    assert not got["err"][:n].any()
    # the chain: the end of each frame, byte-aligned, plus its CRC-16
    # meets the next one's start
    base = sb[:n] - np.array([f[3] for f in frames])
    for i in range(n - 1):
        endb = int(got["end_bits"][i]) - int(base[i])
        assert ((endb + 7) // 8) * 8 + 16 == frames[i][2] * 8


def test_twin_matches_jax_on_24bit_frames():
    frames = cases.frames_24bit()
    got = _entropy_both(*cases.lanes(frames, L, NPOOL))
    assert not got["err"][:len(frames)].any()
    assert got["sub_bps"][:len(frames)].max() == 25   # the side channel


@pytest.mark.parametrize("how", ["flips", "zeroed", "headers", "cut"])
def test_twin_matches_jax_on_corrupt_frames(how):
    frames = cases.corrupt_frames(7, how)
    got = _entropy_both(*cases.lanes(frames, L, NPOOL))
    if how in ("zeroed", "cut"):
        # a zero run of 64 bits is a unary run the reference stops at
        assert got["err"][:len(frames)].any()


def test_twin_matches_jax_when_the_pool_is_too_small():
    """24-bit verbatim frames need more blocks than the pool has: the pool
    builder cuts them, and the lanes run through the zero guard, their
    cursors clamped every 8 samples."""
    rng = np.random.default_rng(5)
    frames = cases.stream_frames(cases.make_stream(
        rng, bps=24, mode="verbatim", n=16 * 1024))
    assert flac_rice.pool_blocks_needed([f[2] for f in frames]) > NPOOL
    got = _entropy_both(*cases.lanes(frames, L, NPOOL))
    max_pos = (NPOOL - 2) * flac_rice.BLK_BITS - 64
    assert (got["end_bits"][:len(frames)] == max_pos).any()


@pytest.mark.parametrize("seed", range(3))
def test_twin_matches_jax_on_random_bit_lanes(seed):
    got = _entropy_both(*cases.random_lanes(seed, L, NPOOL, NSAMP))
    assert got["err"].any() and not got["err"].all()


@pytest.mark.parametrize("name", cases.EDGE_CASES)
def test_twin_matches_jax_on_edge_lanes(name):
    """The kernel's edge cases (unary runs of 60-63 zeros across a block
    boundary and a ring's wrap, escape widths 0 and 31, partition orders 0
    to 8, ragged block sizes, cursors clamped back at the pool's end, runs
    into its zero blocks), each a 32-lane warp, twin against JAX."""
    pool, sb, bs, bps, ca = cases.edge_lanes(name)
    got = _entropy_both(pool, sb, bs, bps, ca)
    max_pos = (NPOOL - 2) * flac_rice.BLK_BITS - 64
    tail = got["end_bits"] == max_pos
    if name in ("clamp_back", "zero_tail"):
        assert tail.sum() == 2 and got["err"][tail].all()
        assert not got["err"][~tail].any()
    else:
        assert not got["err"].any() and not tail.any()
    if name.startswith("unary"):
        # partition 1's sample 5 of channel 1 (order 2, partition order 3,
        # 128 samples a partition) is a run of 60 + i // 3 % 4 zeros
        for i in range(0, L, 3):
            ui = ((60 + i // 3 % 4) << 1) | 1
            assert got["residual"][i, 1, 128 + 5] == (ui >> 1) ^ -(ui & 1)
    if name == "ragged_stops":
        assert sorted(set(bs.tolist())) == [1, 2, 31, 100, 513, 777, 1000,
                                            1024]
        assert (got["residual"][np.arange(NSAMP) >= bs[:, None, None]
                                .repeat(NCH, 1)] == 0).all()


def test_twin_takes_only_cpu_tensors():
    pool, sb, bs, bps, ca = cases.lanes([], L, NPOOL)
    with pytest.raises(ValueError):
        flac_rice.flac_frame_entropy(torch.from_numpy(pool.view(np.int32))
                                     .to("meta"), sb, bs, bps, ca, L, NSAMP,
                                     NCH, NPOOL)


# ------------------------------------------------------------------ pools
def _corpus(streams):
    """Every stream's bytes end to end with the zero tail, as the batch
    builds it: (words, stream_base, zero_off, frames as scheduler lanes,
    the streams' views)."""
    blk_b = flac_rice.BLK_W * 4
    views, lanes = [], []
    for bi, data in enumerate(streams):
        view, idx = cases.index(data)
        views.append(view)
        lanes += [(bi, off, size) + tuple(rest)
                  for off, size, *rest in idx]
    total = sum(len(v) for v in views)
    zero_off = total + (-total) % 4
    buf = np.zeros(zero_off + 2 * blk_b, np.uint8)
    stream_base = np.cumsum([0] + [len(v) for v in views])[:-1]
    for b, v in zip(stream_base, views):
        buf[b: b + len(v)] = np.frombuffer(v, np.uint8)
    return buf.view(np.uint32), stream_base, zero_off, lanes, views


def _pool_streams(seed):
    rng = np.random.default_rng(seed)
    return [cases.make_stream(rng, mode="lpc8", stereo="mid_side"),
            cases.make_stream(rng, n=3001),
            cases.make_stream(rng, mode="verbatim", n=1111)]


def test_gather_pool_matches_jax_word_for_word():
    words, stream_base, zero_off, lanes, _ = _corpus(_pool_streams(1))
    S = len(lanes) + 3                   # pad lanes read the zero tail
    npool = flac_rice.pool_blocks_needed([p[2] for p in lanes]) + 5
    lane_src, cum_dst, base_bits = flac_rice.gather_pool_meta(
        stream_base, lanes, S, zero_off)
    j_src, j_cum, j_base = jrice.gather_pool_meta(stream_base, lanes, S,
                                                  zero_off)
    np.testing.assert_array_equal(lane_src, j_src)
    np.testing.assert_array_equal(cum_dst, j_cum)
    np.testing.assert_array_equal(base_bits, j_base)
    got = flac_rice.gather_frame_pool(torch.from_numpy(words.view(np.int32)),
                                      lane_src, cum_dst, zero_off, npool, S)
    want = np.asarray(jrice.gather_frame_pool(
        jnp.asarray(words), lane_src, cum_dst, np.int32(zero_off),
        NPOOL=npool, S=S))
    assert got.dtype == torch.int32 and got.shape == (npool, 64)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_gather_pool_matches_host_pool_on_each_frames_bytes():
    """Byte for byte over each frame's own bytes, the frame's trailing
    partial word included; past a frame's end the host pool holds zeros
    and the gather the corpus's next bytes, which the decode never
    reads."""
    words, stream_base, zero_off, lanes, views = _corpus(_pool_streams(2))
    npool = flac_rice.pool_blocks_needed([p[2] for p in lanes])
    lane_src, cum_dst, base_bits = flac_rice.gather_pool_meta(
        stream_base, lanes, len(lanes), zero_off)
    got = flac_rice.gather_frame_pool(words, lane_src, cum_dst, zero_off,
                                      npool, len(lanes))
    host, host_bits = flac_rice.build_frame_pool(
        [(views[p[0]], p[1], p[2]) for p in lanes], npool)
    np.testing.assert_array_equal(base_bits, host_bits)
    g = got.numpy().view(np.uint32).astype(">u4").reshape(-1).view(np.uint8)
    h = np.concatenate([host, np.zeros((2, 64), np.uint32)])\
        .astype(">u4").reshape(-1).view(np.uint8)
    blk_b = flac_rice.BLK_W * 4
    assert any(p[2] % 4 for p in lanes)     # frames with a partial word
    for (bi, off, size, *_), b in zip(lanes, base_bits // 8):
        np.testing.assert_array_equal(g[b: b + size], h[b: b + size])
        np.testing.assert_array_equal(
            g[b: b + size], np.frombuffer(views[bi], np.uint8, size, off))
        end = b + -(-size // blk_b) * blk_b
        assert not h[b + size: end].any()
    # the two guard blocks read zeros in both
    assert not g[-2 * blk_b:].any() and not h[-2 * blk_b:].any()


@pytest.mark.parametrize("short", [0, 3])
def test_native_pool_matches_numpy(short):
    """af_flac_build_pool equals the numpy builder, including the cut when
    the pool is too small for every frame."""
    _, _, _, lanes, views = _corpus(_pool_streams(3))
    npool = flac_rice.pool_blocks_needed([p[2] for p in lanes]) - short
    addrs, keep = np.zeros(len(views), np.uint64), []
    for i, v in enumerate(views):
        addrs[i], _, k = native.buf_addr(v)
        keep.append(k)
    got, got_bits = flac_rice.build_frame_pool_native(
        native.get_lib(), addrs, lanes, npool)
    want, want_bits = flac_rice.build_frame_pool(
        [(views[p[0]], p[1], p[2]) for p in lanes], npool)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_bits, want_bits)
    jwant, _ = jrice.build_frame_pool(
        [(views[p[0]], p[1], p[2]) for p in lanes], npool)
    np.testing.assert_array_equal(got, jwant)


def test_pad_pool_matches_jax():
    pool = np.arange(5 * 64, dtype=np.uint32).reshape(5, 64) * 0x01010101
    for n in (3, 5, 9):
        got = flac_rice.pad_pool(pool, n).numpy().view(np.uint32)
        np.testing.assert_array_equal(
            got, np.asarray(jrice.pad_pool(jnp.asarray(pool), n)))


# ------------------------------------------------------------------ batch
def _rice_both(streams, monkeypatch, gather=False):
    """JAX's Rice wire, the port's Rice wire (both output modes) and the
    port's packed wire on `streams`: PCM and lane errors all equal, no
    demotion.  Returns (port Rice decoder, its PCM)."""
    monkeypatch.setenv("AF_TPU_FLAC_DEVICE_RICE", "1")
    if gather:
        monkeypatch.setenv("AF_TPU_FLAC_POOL", "gather")
        monkeypatch.setattr(rice_groups, "RICE_GATHER_MIN_BYTES", 0)
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    tdec = BatchDecoder(streams, device="cpu", flac_wire="rice")
    got = tdec.decode_all()
    dev = BatchDecoder(streams, device="cpu", flac_wire="rice")\
        .decode_all(output="device")
    got_dev = dev.sync().to_numpy()
    pdec = BatchDecoder(streams, device="cpu")
    packed = pdec.decode_all()
    for res in (got_dev, packed, want):
        for a, b in zip(got, res, strict=True):
            if b is None:
                assert a is None
            else:
                assert a is not None and a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    assert tdec.errors == jdec.errors == pdec.errors
    assert tdec.stats["group_demotions"] == 0
    assert not tdec.stats.get("lanes_demoted")
    assert tdec.stats["windows_by_format"]["flac"] >= 1
    return tdec, got


def test_batch_rice_mixed_modes_ragged_lengths(monkeypatch):
    rng = np.random.default_rng(11)
    streams = [cases.make_stream(rng, mode="lpc8", stereo="mid_side"),
               cases.make_stream(rng, n=3000),
               cases.make_stream(rng, mode="lpc8", wasted=2),
               cases.make_stream(rng, mode="verbatim", n=2500),
               cases.make_stream(rng, mode="constant", n=1700),
               cases.make_stream(rng, escape_bits=14, stereo="left_side")]
    tdec, _ = _rice_both(streams, monkeypatch)
    assert tdec.stats.get("rice_host_redo", 0) == 0
    assert tdec.stats["h2d_bytes"] > 0


def test_batch_rice_corrupt_lane_isolated(monkeypatch):
    rng = np.random.default_rng(12)
    good = cases.make_stream(rng)
    bad = bytearray(cases.make_stream(rng))
    bad[len(bad) // 2:] = b"\xff" * (len(bad) - len(bad) // 2)
    _, got = _rice_both([good, bytes(bad), good], monkeypatch)
    s = AudioStream().open_from_memory(good)
    ref = s.read_samples_float(10 ** 6)
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(got[2], ref)


def test_batch_rice_one_sample_final_frame(monkeypatch):
    rng = np.random.default_rng(13)
    streams = []
    for tail in (1, 2, 17):
        x = (rng.standard_normal((1024 * 3 + tail, 2)) * 6000)\
            .astype(np.int64)
        streams.append(flac_ref.build_flac(x, 44100, 16, block_size=1024))
    tdec, _ = _rice_both(streams, monkeypatch)
    assert tdec.errors == [None] * 3


def test_batch_rice_truncates_at_unparseable_frame(monkeypatch):
    """A frame the device flags and the host cannot parse ends its lane
    there, as the single-stream decoder ends, and is counted."""
    rng = np.random.default_rng(14)
    good = cases.make_stream(rng)
    bad = bytearray(cases.make_stream(rng, n=3000))
    bad[len(bad) // 2:] = b"\x55" * (len(bad) - len(bad) // 2)
    bad = bytes(bad)
    tdec, got = _rice_both([good, bad, good], monkeypatch)
    ref_bad = AudioStream().open_from_memory(bad).read_samples_float(10 ** 6)
    np.testing.assert_array_equal(got[1], ref_bad)
    assert tdec.stats["flac_truncated_lanes"] == 1


def test_batch_rice_24bit_lanes_redo_on_host(monkeypatch):
    rng = np.random.default_rng(15)
    streams = [cases.make_stream(rng, bps=24, mode="lpc8", stereo="left_side"),
               cases.make_stream(rng, n=2000)]
    tdec, _ = _rice_both(streams, monkeypatch)
    # every 24-bit frame is wider than the device's 18 bits
    assert tdec.stats["rice_host_redo"] == 4


def test_batch_rice_ogg_flac(monkeypatch):
    from test_torch_flac_batch import _expected, _flac, _ogg_flac

    rng = np.random.default_rng(19)
    native, pcm = _flac(rng, 3000, "left_side", modes=("lpc4", "fixed2"))
    _, got = _rice_both([_ogg_flac(native, 3000), native], monkeypatch)
    np.testing.assert_array_equal(got[0], _expected(pcm, 16))


def test_batch_rice_18bit_lanes_mix_host_and_device_frames(monkeypatch):
    """18-bit frames: the independent ones decode on the device (exact LPC
    lanes), the mid/side ones (a 19-bit side channel) again on the host."""
    from test_torch_flac_batch import _mixed_18bit

    rng = np.random.default_rng(18)
    data, pcm = _mixed_18bit(rng)
    tdec, got = _rice_both([data, cases.make_stream(rng, n=1500)],
                           monkeypatch)
    np.testing.assert_array_equal(
        got[0], ((pcm << 14).astype(np.float64) / 2147483647.0)
        .astype(np.float32))
    assert tdec.stats["rice_host_redo"] == 3


def test_batch_rice_gather_pool(monkeypatch):
    """The pool gathered on the device from the group's corpus (forced by
    the module constant) decodes as the host pool does."""
    rng = np.random.default_rng(16)
    streams = [cases.make_stream(rng, mode="lpc8", stereo="mid_side"),
               cases.make_stream(rng, n=3000),
               cases.make_stream(rng, mode="fixed2", wasted=1),
               cases.make_stream(rng, mode="constant")]
    monkeypatch.setattr(rice_groups, "RICE_GATHER_MIN_BYTES", 1 << 40)
    host = BatchDecoder(streams, device="cpu", flac_wire="rice")
    ref = host.decode_all()
    tdec, got = _rice_both(streams, monkeypatch, gather=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # the corpus crosses once, in place of a host pool a dispatch
    assert tdec.stats["h2d_bytes"] >= sum(len(s) for s in streams)
    assert tdec.stats.get("rice_host_redo", 0) == 0


def test_batch_rice_mono_and_stereo_groups_at_once(monkeypatch):
    """Two FLAC groups decode concurrently, each gathering from its own
    corpus: each equals its decode alone, the packed wire, and JAX's Rice
    wire (whose groups this small build host pools, so they share no
    corpus)."""
    rng = np.random.default_rng(17)
    mono = [flac_ref.build_flac(
        (rng.standard_normal((2500 + 333 * i, 1)) * 5000).astype(np.int64),
        44100, 16, block_size=1024, modes=["lpc8"]) for i in range(3)]
    stereo = [cases.make_stream(rng, mode="lpc8", stereo="mid_side"),
              cases.make_stream(rng, n=3500)]
    monkeypatch.setattr(rice_groups, "RICE_GATHER_MIN_BYTES", 0)
    streams = [mono[0], stereo[0], mono[1], stereo[1], mono[2]]
    dec = BatchDecoder(streams, device="cpu", flac_wire="rice")
    got = dec.decode_all()
    assert dec.stats["group_demotions"] == 0
    assert dec.stats["windows_by_format"]["flac"] == 2
    alone = {}
    for group in (mono, stereo):
        for s, pcm in zip(group, BatchDecoder(
                group, device="cpu", flac_wire="rice").decode_all()):
            alone[s] = pcm
    packed = BatchDecoder(streams, device="cpu").decode_all()
    monkeypatch.setenv("AF_TPU_FLAC_DEVICE_RICE", "1")
    jdec = JaxBatchDecoder(streams)
    want = jdec.decode_all()
    assert dec.errors == jdec.errors
    for s, a, p, w in zip(streams, got, packed, want, strict=True):
        np.testing.assert_array_equal(a, alone[s])
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(a, w)


def test_flac_wire_argument():
    assert BatchDecoder([], device="cpu").flac_wire == "packed"
    with pytest.raises(ValueError):
        BatchDecoder([], device="cpu", flac_wire="device")


@pytest.mark.parametrize("Lx,NSAMPx,nchx,NPOOLx", [(33, 31, 3, 2),
                                                   (5, 7, 1, 3)])
def test_twin_matches_jax_at_edge_shapes(Lx, NSAMPx, nchx, NPOOLx):
    """Block counts below 8 and not a multiple of it, three channels, the
    smallest pools (a negative clamp bound at NPOOL 2)."""
    pool, sb, bs, bps, ca = cases.random_lanes(Lx, Lx, NPOOLx, NSAMPx)
    want = jrice.flac_frame_entropy(
        jnp.asarray(pool), sb, bs, bps, ca, L=Lx, NSAMP=NSAMPx, nch=nchx,
        NPOOL=NPOOLx)
    got = flac_rice.flac_frame_entropy(pool, sb, bs, bps, ca, Lx, NSAMPx,
                                       nchx, NPOOLx)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
