"""The port's Ogg Vorbis slice against the JAX package's, on the CPU: the
window chain's twin (the lapped OLA of K11) and the IMDCT matmul against
JAX's, and the batch decoder's Vorbis groups against JAX's batch decoder
(both outputs) and its single-stream facade, within 4e-6 of the peak (the
bound tests/test_batch.py holds between batch and facade)."""

import numpy as np
import pytest
import torch

from audio_formats_tpu import AudioStream
from audio_formats_tpu.ops import mdct as jmdct
from audio_formats_tpu.ops import vorbis_win as jwin
from audio_formats_tpu.parallel import BatchDecoder as JaxBatchDecoder

from audio_formats_torch import BatchDecoder, models
from audio_formats_torch.io.source import MemorySource
from audio_formats_torch.models import opus as topus
from audio_formats_torch.models import vorbis as tvorbis
from audio_formats_torch.ops import mdct as tmdct
from audio_formats_torch.ops import vorbis_win as twin

from golden import opus_ref, vorbis_ref

import torch_pcm_cases as cases

TOL = 4e-6   # max abs error over the peak


def _close(got, want, tol=TOL):
    peak = np.abs(want).max() + 1e-9
    assert got.shape == want.shape
    assert np.abs(got - want).max() / peak < tol


CHAIN_CASES = [
    # (seed, B, ch, K, bs0, bs1, lies)
    (1, 6, 2, 8, 512, 2048, False),
    (2, 5, 1, 8, 256, 1024, False),
    (3, 4, 2, 8, 512, 2048, True),
    (4, 3, 1, 5, 64, 8192, False),
    (5, 4, 2, 8, 512, 512, False),
]


@pytest.mark.parametrize("case", CHAIN_CASES,
                         ids=[f"s{c[0]}-ch{c[2]}-{c[4]}-{c[5]}"
                              + ("-lies" if c[6] else "")
                              for c in CHAIN_CASES])
def test_window_chain_twin_matches_jax(case):
    """Two windows in a row (the carry of the first feeds the second):
    long and short packets with their transitions, empty slots, unprimed
    lanes and carried laps of both widths; with ``lies`` the long
    packets' window flags do not match their neighbours."""
    seed, B, ch, K, bs0, bs1, lies = case
    jstate = tstate = None
    for w in range(2):
        X, geom, lap, lap_len, had_prev = cases.vorbis_chain_case(
            seed + 100 * w, B, ch, K, bs0, bs1, lies=lies)
        if jstate is None:
            jstate = (lap, lap_len, had_prev)
            tstate = tuple(torch.from_numpy(a) for a in jstate)
        want = jwin.vorbis_window_chain(X, *geom, *jstate, bs0=bs0,
                                        bs1=bs1, ch=ch)
        got = twin.vorbis_window_chain(
            torch.from_numpy(X), *torch.from_numpy(geom), *tstate,
            bs0=bs0, bs1=bs1, ch=ch)
        for g, a in zip(got, want):
            a = np.asarray(a)
            if a.dtype == np.float32:
                _close(g.numpy(), a)
            else:
                np.testing.assert_array_equal(g.numpy(), a)
        # the pcm is zero past each slot's output length
        pcm = got[0].numpy()
        assert not pcm[:, :, bs1 - (bs1 - bs0) // 4:].any() or bs0 == bs1
        jstate = tuple(want[1:])
        tstate = tuple(got[1:])


def test_window_chain_twin_matches_host_overlap_add():
    """One lane, one long packet after a short one: the twin's output
    region equals the host path's overlap_add of the same IMDCT rows."""
    bs0, bs1 = 256, 1024
    X, geom, lap, lap_len, had_prev = cases.vorbis_chain_case(
        9, 1, 1, 1, bs0, bs1)
    geom[:, 0, 0] = (*cases.vorbis_geometry(bs1, True, False, True, bs0), 1)
    X[0, 0] = np.random.default_rng(0).standard_normal(bs1 // 2) * 0.1
    lap[0, :bs0 // 2] = 0.25
    lap_len[0], had_prev[0] = bs0 // 2, 1
    pcm, *_ = twin.vorbis_window_chain(
        torch.from_numpy(X), *torch.from_numpy(geom),
        *(torch.from_numpy(a) for a in (lap, lap_len, had_prev)),
        bs0=bs0, bs1=bs1, ch=1)
    y = tmdct.imdct_host(X[0], bs1)
    tmdct.overlap_add(y, lap[:, :bs0 // 2], int(geom[0, 0, 0]))
    ls, rs = int(geom[0, 0, 0]), int(geom[1, 0, 0])
    _close(pcm[0, 0, :rs - ls].numpy(), y[0, ls:rs], 1e-5)


CLASSIFY_CASES = [
    # (seed, B, ch, K, bs0, bs1, lies)
    (31, 24, 2, 8, 512, 2048, True),
    (32, 24, 1, 8, 256, 1024, True),
    (33, 24, 2, 8, 512, 2048, 0.3),
    (34, 12, 2, 8, 512, 2048, False),
    (35, 8, 1, 5, 64, 8192, False),
]


@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_chained_lanes_match_a_perturbed_lap(case):
    """chained_lanes, the lanes K11 runs slot after slot, against brute
    force: a lane is chained where, at some valid slot, changing the lap
    the slot is given changes the lap it passes on (the twin run slot by
    slot)."""
    seed, B, ch, K, bs0, bs1, lies = case
    X, geom, lap, lap_len, had_prev = cases.vorbis_chain_case(
        seed, B, ch, K, bs0, bs1, lies=lies)
    h0, h = bs0 // 2, bs1 // 2
    Xt, g = torch.from_numpy(X), torch.from_numpy(geom)
    y1 = tmdct.imdct_batch(Xt.reshape(-1, h), bs1).reshape(K, -1, bs1)
    y0 = tmdct.imdct_batch(Xt[..., :h0].reshape(-1, h0), bs0) \
        .reshape(K, -1, bs0)
    got = twin.chained_lanes(*g, torch.from_numpy(lap_len), bs0=bs0,
                             bs1=bs1)
    state = tuple(torch.from_numpy(a) for a in (lap, lap_len, had_prev))
    rng = np.random.default_rng(seed)
    brute = torch.zeros(B, dtype=torch.bool)
    for k in range(K):
        gk = g[:, k:k + 1]
        base = twin.lap_chain_torch(y1[k:k + 1], y0[k:k + 1], *gk, *state,
                                    bs0=bs0, bs1=bs1, ch=ch)
        moved = state[0] + torch.from_numpy(
            rng.uniform(1.0, 2.0, state[0].shape).astype(np.float32))
        pert = twin.lap_chain_torch(y1[k:k + 1], y0[k:k + 1], *gk, moved,
                                    *state[1:], bs0=bs0, bs1=bs1, ch=ch)
        changed = (base[1] != pert[1]).reshape(B, ch * h).any(1)
        brute |= changed & (g[3, k] != 0)
        state = base[1:]
    assert torch.equal(got, brute)
    if lies is not False:
        assert bool(got.any()) and (lies is True or not bool(got.all()))


@pytest.mark.parametrize("n", [64, 512, 2048])
def test_imdct_batch_matches_jax(n):
    X = np.random.default_rng(n).standard_normal((7, n // 2)) \
        .astype(np.float32)
    want = np.asarray(jmdct.imdct_batch(X, n))
    got = tmdct.imdct_batch(torch.from_numpy(X), n).numpy()
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(tmdct.imdct_matrix(n),
                                  jmdct.imdct_matrix(n))
    np.testing.assert_array_equal(tmdct.vorbis_slope(n // 2),
                                  jmdct.vorbis_slope(n // 2))


def _frames(fix, rng, count, pattern=None, silent=0.0):
    """Audio packets of a fixture: random floor posts and grid residues;
    `pattern` gives each packet's block size (1 long), with matching
    window flags; `silent` the share of unused channels."""
    ch = fix.channels
    frames = []
    for i in range(count):
        lb = bool(pattern[i]) if pattern else False
        n2 = (fix.bs1 if lb else fix.bs0) // 2
        posts, res = [], []
        for _c in range(ch):
            if i and rng.random() < silent:
                posts.append(None)
                res.append(np.zeros(n2))
                continue
            posts.append([int(rng.integers(40, 100)) for _ in range(4)])
            r = np.zeros(n2)
            idx = rng.choice(n2, size=n2 // 4, replace=False)
            r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
            res.append(r)
        pl = bool(pattern[i - 1]) if pattern and i else True
        nl = bool(pattern[i + 1]) if pattern and i + 1 < count else True
        frames.append(fix.audio_packet(posts, res, long_block=lb,
                                       prev_flag=int(pl), next_flag=int(nl)))
    return frames


def _group(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "mono":
        fix = vorbis_ref.Fixture(channels=1)
        return [fix.build(_frames(fix, rng, c, silent=0.1))
                for c in (12, 5, 20)]
    if kind == "stereo_coupled":
        fix = vorbis_ref.Fixture(channels=2, coupling=True)
        return [fix.build(_frames(fix, rng, c, silent=0.1))
                for c in (8, 17)]
    if kind == "transitions":
        fix = vorbis_ref.Fixture(channels=1, bs0=256, bs1=1024)
        pats = ([0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0],
                [1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1])
        return [fix.build(_frames(fix, rng, len(p), p)) for p in pats]
    if kind == "ragged_stereo_long":
        # lanes that end in the middle of a window, stereo, long blocks
        # with an occasional short pair
        fix = vorbis_ref.Fixture(channels=2, bs0=512, bs1=2048,
                                 coupling=True)
        out = []
        for count in (3, 9, 16, 25):
            p = [1] * count
            if count > 6:
                p[4] = p[5] = 0
            out.append(fix.build(_frames(fix, rng, count, p)))
        return out
    if kind == "final_granule":
        fix = vorbis_ref.Fixture(channels=1)
        out = []
        for count, cut in ((8, 100), (11, 1), (9, 300)):
            frames = _frames(fix, rng, count)
            n = AudioStream().open_from_memory(fix.build(frames)) \
                .get_length_in_frames()
            out.append(fix.build(frames, final_granule=n - cut))
        return out
    raise ValueError(kind)


GROUPS = ["mono", "stereo_coupled", "transitions", "ragged_stereo_long",
          "final_granule"]


def _facade(data):
    s = AudioStream().open_from_memory(data)
    assert not s.is_error(), s.error_message()
    return s.read_samples_float(10 ** 7)


@pytest.mark.parametrize("output", ["numpy", "device"])
@pytest.mark.parametrize("kind", GROUPS)
def test_batch_groups_match_jax(kind, output):
    """The port's Vorbis group (one IMDCT and K11 chain a window of 8
    packets) against JAX's batch decoder with both outputs and against
    its facade, lane by lane."""
    streams = _group(kind)
    jdec = JaxBatchDecoder(streams)
    tdec = BatchDecoder(streams, device="cpu")
    got = tdec.decode_all(output=output)
    if output == "device":
        assert {k for k, _ in got.windows()} == {"vorbis"}
        got = got.sync().to_numpy()
    jnum = jdec.decode_all()
    jdev = JaxBatchDecoder(streams).decode_all(output="device").to_numpy()
    assert tdec.errors == jdec.errors == [None] * len(streams)
    for data, g, a, b in zip(streams, got, jnum, jdev, strict=True):
        assert g.dtype == np.float32
        _close(g, a)
        _close(g, b)
        _close(g, _facade(data))
    st = tdec.stats
    assert st["group_demotions"] == 0
    assert st["windows_by_format"]["vorbis"] == st["windows"] > 0
    assert st["decoded_seconds_by_format"]["vorbis"] > 0


def test_probe_finds_vorbis_and_names_opus():
    """Vorbis after QOA and before MP3; an Ogg Opus stream, probed first,
    gets an OpusDecoder and decodes beside the Vorbis lane as JAX's batch
    and facade decode it."""
    data = _group("mono")[0]
    assert isinstance(models.probe_all(MemorySource(data), "cpu"),
                      tvorbis.VorbisDecoder)
    opus = opus_ref.build_ogg_opus([(b"\xfc\xff\xfe", 960)], channels=1,
                                   preskip=0)
    assert isinstance(models.probe_all(MemorySource(opus), "cpu"),
                      topus.OpusDecoder)
    dec = BatchDecoder([data, opus], device="cpu")
    out = dec.decode_all()
    jout = JaxBatchDecoder([data, opus]).decode_all()
    assert dec.errors == [None, None]
    assert out[1].shape == (960, 1)
    _close(out[1], _facade(opus), tol=1e-5)
    _close(out[1], jout[1], tol=1e-5)
    _close(out[0], _facade(data))
