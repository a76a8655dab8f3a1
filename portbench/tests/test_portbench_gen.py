"""The fast generators against the frozen golden copies, on short streams:
FLAC frames decode bit for bit (a plain bit-level decoder here, with the
golden CRCs and frame-number code, and again through the port), and MP3
frames decode to the reference (the golden decoder's steps, and the
port)."""

import numpy as np
import pytest

from portbench.gen import flac as gen_flac
from portbench.gen import mp3 as gen_mp3
from portbench.ref import flac as ref_flac
from portbench.ref import golden_flac, golden_mp3
from portbench.ref import mp3 as ref_mp3
from portbench.tests.tiny import tiny_cell


class _Bits:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos * 8

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | (byte >> (7 - (self.pos & 7)) & 1)
            self.pos += 1
        return v

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v >> (n - 1) else v

    def unary(self) -> int:
        q = 0
        while self.u(1) == 0:
            q += 1
        return q


def _decode_flac(data: bytes):
    """A plain FLAC decoder for what the generator writes (mono, fixed
    blocks, LPC or VERBATIM subframes, Rice partitions): PCM and each
    frame's number, CRCs held to the golden encoder's."""
    assert data[:4] == b"fLaC"
    pos = 4
    while True:
        last, size = data[pos] & 0x80, int.from_bytes(data[pos + 1:pos + 4],
                                                      "big")
        pos += 4 + size
        if last:
            break
    out, numbers = [], []
    bps = 16
    while pos < len(data):
        b = _Bits(data, pos)
        assert b.u(16) == 0xFFF8
        bcode, _ = b.u(4), b.u(4)
        assert b.u(4) == 0 and b.u(3) == 4 and b.u(1) == 0
        lead = b.u(8)
        num = lead if lead < 0x80 else ((lead & 0x1F) << 6) | (b.u(8) & 0x3F)
        numbers.append(num)
        bs = {12: 4096, 6: None, 7: None}[bcode]
        if bcode == 6:
            bs = b.u(8) + 1
        elif bcode == 7:
            bs = b.u(16) + 1
        hlen = b.pos // 8 - pos
        assert b.u(8) == golden_flac._crc8(data[pos: pos + hlen])
        assert b.u(1) == 0
        typ = b.u(6)
        assert b.u(1) == 0
        if typ == 1:
            x = [b.s(bps) for _ in range(bs)]
        else:
            order = (typ & 0x1F) + 1
            x = [b.s(bps) for _ in range(order)]
            prec, shift = b.u(4) + 1, b.s(5)
            coefs = [b.s(prec) for _ in range(order)]
            assert b.u(2) == 0
            porder = b.u(4)
            for p in range(1 << porder):
                k = b.u(4)
                cnt = (bs >> porder) - (order if p == 0 else 0)
                for _ in range(cnt):
                    uu = (b.unary() << k) | b.u(k)
                    res = (uu >> 1) ^ -(uu & 1)
                    pred = sum(c * x[-1 - j] for j, c in enumerate(coefs))
                    x.append(res + (pred >> shift))
        b.pos = (b.pos + 7) // 8 * 8
        end = b.pos // 8
        crc = golden_flac._crc16(data[pos:end])
        assert int.from_bytes(data[end:end + 2], "big") == crc
        pos = end + 2
        out.extend(x)
    return np.array(out, np.int64), numbers


def test_flac_frames_round_trip_bit_for_bit():
    cfg, traffic, _, _ = tiny_cell("librispeech_flac.b64")
    corpus = gen_flac.build(cfg, traffic, np.random.default_rng(11))
    t = corpus.truth
    for i in range(3):
        pcm, numbers = _decode_flac(corpus.streams[i])
        want = ref_flac.pcm_int(t, t["frames_of"][i])[:, 0]
        np.testing.assert_array_equal(pcm, want)
        assert numbers == list(range(len(numbers)))
        # the golden frame-number code gives the same bytes
        bw = golden_flac._BW()
        for n in numbers:
            golden_flac._utf8(bw, n)
        code, lens = gen_flac._utf8(np.array(numbers))
        ours = b"".join(bytes(code[j, :lens[j]].tolist())
                        for j in range(len(numbers)))
        assert ours == bytes(bw.bytes)


def test_flac_verbatim_tail_and_tiny_blocks():
    """Tails shorter than the predictor take VERBATIM; 8- and 16-bit
    explicit block sizes both decode."""
    cfg, _, _, _ = tiny_cell("librispeech_flac.b64")
    rng = np.random.default_rng(3)
    pcm = gen_flac.speech_frames(rng, 4, 4096, 16000, cfg["content"])
    lens = np.array([4096, 40, 200, 3000])
    data, offs, flen, order = gen_flac.encode_frames(
        pcm, lens, np.array([0, 1, 2, 3]), cfg)
    assert order[1] == 0 and (order[[0, 2, 3]] > 0).all()
    stream = gen_flac._stream_head(cfg, int(lens.sum())) + data.tobytes()
    got, _ = _decode_flac(stream)
    want = np.concatenate([pcm[f, :lens[f]] for f in range(4)])
    np.testing.assert_array_equal(got, want)


def test_flac_through_the_port():
    from audio_formats_torch import BatchDecoder

    cfg, traffic, _, _ = tiny_cell("librispeech_flac.b64")
    corpus = gen_flac.build(cfg, traffic, np.random.default_rng(12))
    out = BatchDecoder(corpus.streams[:4], device="cpu").decode_all()
    for i in range(4):
        want = ref_flac.expected(corpus, i)
        assert out[i].shape == want.shape
        assert ref_flac.gap(corpus, out[i], want) == 0.0


def _golden_channel(truth, frames, ch):
    """One left/right channel by the golden decoder's steps, granule by
    granule, with each band's scalefactors applied in a plain loop."""
    overlap = np.zeros((32, 18))
    bufs = []
    width_l = [4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34, 42,
               50, 54, 76, 158]
    width_s = golden_mp3.SFB_SHORT_44100[::3]
    pretab = [0] * 11 + [1, 1, 1, 1, 2, 2, 3, 3, 3, 2]
    for f in frames:
        for gr in range(2):
            bt = int(truth["bt"][f, gr])
            x = golden_mp3.dequant(truth["q"][f, gr, ch],
                                   int(truth["gain"][f, gr, ch]))
            mult = 0.5 * (1 + int(truth["scale"][f, gr, ch]))
            pos = 0
            if bt == 2:
                for sfb, w in enumerate(width_s):
                    for win in range(3):
                        sf = truth["sf_s"][f, gr, ch, sfb, win] \
                            if sfb < 12 else 0
                        sbg = truth["sbg"][f, gr, ch, win]
                        x[pos: pos + w] *= 2.0 ** (-2 * sbg - mult * sf)
                        pos += w
                x = golden_mp3.reorder_short(x)
                out, overlap = golden_mp3.imdct_short(x.reshape(32, 18),
                                                      overlap)
            else:
                for sfb, w in enumerate(width_l):
                    if sfb < 21:
                        sf = truth["sf_l"][f, gr, ch, sfb] \
                            + truth["pre"][f, gr, ch] * pretab[sfb]
                        x[pos: pos + w] *= 2.0 ** (-mult * sf)
                    pos += w
                x = golden_mp3.antialias(x)
                out, overlap = golden_mp3.imdct_long(x.reshape(32, 18),
                                                     overlap, kind=bt)
            bufs.append(out * golden_mp3._SIGNMASK)
    return golden_mp3.synth_granules(bufs)


def test_mp3_reference_is_the_golden_pipeline():
    """The vectorised float64 reference equals the golden decoder's steps
    on a left/right clip, both channels: long, start, short and stop
    blocks, with seeded scalefactors, preflag, scalefac_scale, subblock
    gains and global gains."""
    cfg, _, _, _ = tiny_cell("fma_mp3.b32")
    rng = np.random.default_rng(5)
    pat = np.array([0, 1, 2, 3, 0, 0, 1, 3, 1, 2, 3, 0])
    bt = gen_mp3.PATTERNS[pat]
    q = gen_mp3.spectra(rng, bt == 2, [0.6, 0.25, 0.15])
    sf = gen_mp3.scalefactors(rng, bt, cfg["global_gain"])
    assert sf["scfsi"].any() and sf["pre"].any() and sf["scale"].any()
    assert sf["sbg"].any() and len(np.unique(sf["gain"])) > 4
    truth = {"q": q.astype(np.int16), "bt": bt, "ms": np.zeros(12, bool),
             **{k: sf[k] for k in ("sf_l", "sf_s", "pre", "scale", "sbg",
                                   "gain")}}
    frames = np.arange(12)
    ours = ref_mp3.decode_clip(truth, frames)
    for ch in range(2):
        golden = _golden_channel(truth, frames, ch)
        np.testing.assert_allclose(ours[:, ch], golden, rtol=0, atol=1e-12)


def test_mp3_clip_block_types_follow_an_encoder():
    """Clips switch blocks as an encoder does (long, start, short, stop),
    a tenth of the granules short; scfsi only in frames of two long
    granules, and the reused groups repeat the first granule's values."""
    cfg, traffic, _, _ = tiny_cell("fma_mp3.b32")
    traffic["lengths"]["seconds"] = 20.0
    corpus = gen_mp3.build(cfg, traffic, np.random.default_rng(9))
    t = corpus.truth
    allowed = {(0, 0), (0, 1), (1, 2), (2, 2), (2, 3), (3, 0), (3, 1)}
    n_short = n_gr = 0
    for ids in t["frames_of"]:
        seq = t["bt"][ids].reshape(-1)
        assert set(zip(seq[:-1].tolist(), seq[1:].tolist())) <= allowed
        n_short += int((seq == 2).sum())
        n_gr += seq.size
    assert 0.05 < n_short / n_gr < 0.15
    sf = gen_mp3.scalefactors(np.random.default_rng(4), t["bt"],
                              cfg["global_gain"])
    long_frames = (t["bt"] != 2).all(1)
    assert not sf["scfsi"][~long_frames].any()
    reuse = sf["scfsi"][:, :, gen_mp3.SCFSI_GROUP]
    assert reuse.any()
    np.testing.assert_array_equal(sf["sf_l"][:, 1][reuse],
                                  sf["sf_l"][:, 0][reuse])


def test_mp3_frames_decode_to_the_reference():
    from audio_formats_torch import BatchDecoder

    cfg, traffic, _, _ = tiny_cell("fma_mp3.b32")
    traffic["lengths"]["seconds"] = 3.0
    corpus = gen_mp3.build(cfg, traffic, np.random.default_rng(13))
    assert corpus.truth["ms"].any() and not corpus.truth["ms"].all()
    assert (corpus.truth["bt"] == 1).any() and (corpus.truth["bt"] == 3).any()
    assert len(corpus.streams[0]) == 1044 * len(corpus.truth["frames_of"][0])
    out = BatchDecoder(corpus.streams[:4], device="cpu").decode_all()
    for i in range(4):
        want = ref_mp3.expected(corpus, i)
        assert out[i].shape == want.shape
        assert ref_mp3.gap(corpus, out[i], want) < 1e-5


@pytest.mark.parametrize("fmt", ["flac", "mp3"])
def test_same_seed_same_corpus(fmt):
    cell = {"flac": "librispeech_flac.b64", "mp3": "fma_mp3.b32"}[fmt]
    cfg, traffic, _, _ = tiny_cell(cell)
    gen = {"flac": gen_flac, "mp3": gen_mp3}[fmt]
    a = gen.build(cfg, traffic, np.random.default_rng(2 ** 33 + 1))
    b = gen.build(cfg, traffic, np.random.default_rng(2 ** 33 + 1))
    c = gen.build(cfg, traffic, np.random.default_rng(2 ** 33 + 2))
    assert a.streams == b.streams and a.streams != c.streams
    # every seed draws the same set of lengths
    np.testing.assert_array_equal(np.sort(a.seconds), np.sort(c.seconds))
