"""Entry points: the flagship compute step, and a multi-device dryrun.

``entry()`` returns the batched MP3 window DSP (antialias, the IMDCT and
overlap-add as masked matmuls, the polyphase synthesis as one Toeplitz
matmul) with example inputs: the matmul-heavy core of the decoder.

``dryrun_multichip(n)`` builds an n-device ('data', 'model') mesh, runs that
step with its lanes split over 'data' and the carried overlap and slot
history split on their channel axis over 'model', runs the BatchDecoder
scheduler and both batch encoders sharded, and holds each to its unsharded
run.

    python -m audio_formats_torch.entry
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .device import device_of
from .ops import mp3_dsp
from .parallel import mesh as pmesh

#: the sharded step and the scheduler's float lanes against their
#: unsharded runs, of the peak
FLOAT_TOL = 4e-6
#: decoders whose PCM is integer-exact whatever the sharding
_EXACT_KINDS = ("FlacDecoder", "WavDecoder", "QoaDecoder", "ModDecoder",
                "XmDecoder")
#: the channel axis of each of the step's inputs (n_act has none)
_CHANNEL_AXES = (2, 2, 2, 1, 1, 1)


def _example_inputs(B=8, ngr=2, nch=2):
    """The step's example inputs as numpy, drawn as the JAX package's
    ``_example_inputs`` draws them (the same values), in the port's order:
    (xq, aa_bands, wtype, overlap, shist, n_act)."""
    rng = np.random.default_rng(0)
    xq = (rng.standard_normal((B, ngr, nch, 576)) * 0.05).astype(np.float32)
    aa = np.full((B, ngr, nch), 31, np.int32)
    wt = np.zeros((B, ngr, nch, 32), np.int32)
    overlap = np.zeros((B, nch, 32, 18), np.float32)
    shist = np.zeros((B, nch, 16, 32), np.float32)
    n_act = np.full((B,), ngr, np.int32)
    return (xq, aa, wt, overlap, shist, n_act)


def entry(device="cuda"):
    """Returns (fn, example_args): the batched MP3 window DSP step
    (``ops.mp3_dsp.mp3_window_dsp``, batch 8, stereo, two granules) and its
    inputs as tensors on `device` ("cuda", the default, raises without a
    GPU)."""
    dev = device_of(device)
    fn = functools.partial(mp3_dsp.mp3_window_dsp, nch=2, ngr=2)
    return fn, tuple(torch.from_numpy(a).to(dev) for a in _example_inputs())


def _rel_err(want: np.ndarray, got: np.ndarray) -> float:
    if want.size == 0:
        return 0.0
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-9))


def sharded_step(mesh, args):
    """The step over `mesh`: each input split by lanes over 'data' and on
    its channel axis over 'model' (channels are independent: the port's
    window DSP mixes no channels), the step run once a mesh position on its
    device, and the outputs joined on the mesh's first device."""
    nch = args[0].shape[2] // mesh.shape["model"]
    grids = [pmesh.batch_channel_sharding(mesh, a.ndim, ax).split(a)
             for a, ax in zip(args, _CHANNEL_AXES)]
    D, M = mesh.devices.shape
    outs = [[mp3_dsp.mp3_window_dsp(*(g[d][m] for g in grids), nch=nch,
                                    ngr=args[0].shape[1])
             for m in range(M)] for d in range(D)]
    return tuple(
        pmesh.batch_channel_sharding(mesh, 4, ax).gather(
            [[o[k] for o in row] for row in outs])
        for k, ax in enumerate((2, 1, 1)))


def _default_items(device, n_lanes):
    """WAV (s16) and QOA lanes the port encodes itself from tones."""
    from .config import AudioSampleFormat, EncodingOptions
    from .parallel import encode_qoa_batch, encode_wav_batch

    pcms = []
    for i in range(n_lanes // 2):
        t = np.arange(9000 + 700 * i)[:, None]
        pcms.append((0.45 * np.sin(2 * np.pi * (220 + 55 * i) * t
                                   * [1.0, 1.5] / 44100)).astype(np.float32))
    wav = encode_wav_batch(pcms, 44100, EncodingOptions(
        sample_format=AudioSampleFormat.s16, enable_dither=False),
        device=device)
    return wav + encode_qoa_batch(pcms, 44100, device=device)


def _encode_pcms(n):
    """The JAX package's dryrun encode streams: n stereo tones with noise,
    6,000 + 128 i frames."""
    rng = np.random.default_rng(7)
    pcms = []
    for i in range(n):
        t = np.arange(6000 + 128 * i)[:, None]
        x = (0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t * [1.0, 1.31]
                          / 44100)
             + 0.02 * rng.standard_normal((t.size, 2)))
        pcms.append(x.astype(np.float32))
    return pcms


def compare_lanes(ref, got, exact, tol=FLOAT_TOL, label="lane"):
    """Each lane of `got` against `ref` (numpy arrays, or None where a lane
    has no PCM): the same dtype and shape, finite, and bit-equal where
    ``exact(i)``, else within `tol` of the peak.  Raises AssertionError;
    returns the largest error over the peak of the other lanes."""
    worst = 0.0
    for i, (r, g) in enumerate(zip(ref, got, strict=True)):
        if (r is None) != (g is None):
            raise AssertionError(f"{label} {i}: only one run has PCM")
        if r is None:
            continue
        if r.shape != g.shape or r.dtype != g.dtype or \
                not np.isfinite(g).all():
            raise AssertionError(f"{label} {i}: PCM {g.dtype} {g.shape}, "
                                 f"want {r.dtype} {r.shape}, finite")
        if exact(i):
            if not np.array_equal(r, g):
                raise AssertionError(f"{label} {i}: not bit-equal")
        else:
            err = _rel_err(r, g)
            worst = max(worst, err)
            if not err < tol:
                raise AssertionError(f"{label} {i}: {err} of the peak "
                                     f"away (bound {tol})")
    return worst


def compare_decoders(ref_dec, ref, got_dec, got, label="lane"):
    """A sharded decode (`got_dec`, its PCM `got`) against the unsharded
    one: the same errors, and compare_lanes with FLAC, WAV, QOA, MOD and
    XM lanes bit for bit, the others within FLOAT_TOL of the peak.
    Returns the largest float error over the peak."""
    if got_dec.errors != ref_dec.errors:
        raise AssertionError(f"sharded errors {got_dec.errors}, unsharded "
                             f"{ref_dec.errors}")
    return compare_lanes(
        ref, got,
        lambda i: type(ref_dec.decoders[i]).__name__ in _EXACT_KINDS,
        label=label)


def check_decode(items, mesh, **kw):
    """Decode `items` unsharded on the mesh's first device and sharded over
    `mesh`, and hold them together with compare_decoders.  Returns the
    unsharded decoder."""
    from .parallel import BatchDecoder

    ref_dec = BatchDecoder(items, device=mesh.devices[0, 0], **kw)
    ref = ref_dec.decode_all()
    got_dec = BatchDecoder(items, mesh=mesh, **kw)
    compare_decoders(ref_dec, ref, got_dec, got_dec.decode_all())
    return ref_dec


def dryrun_multichip(n_devices: int, devices=None, items=None) -> dict:
    """Run the step, the scheduler and both batch encoders over an
    n_devices mesh (model 2 where n_devices is even), each held to its
    unsharded run on the mesh's first device.

    ``devices``: the mesh's devices, in order (an entry may repeat, e.g.
    ``["cpu"] * 8`` or ``["cuda:0"] * 4``); default ``cuda:0`` ..
    ``cuda:n-1``, which raises where fewer exist.  ``items``: the
    scheduler's streams; default WAV and QOA lanes encoded by the port.
    FLAC lanes among them run again over the Rice wire where the C host
    stage loaded.  Prints one summary line and returns its fields."""
    from .config import AudioSampleFormat, EncodingOptions
    from .host import native
    from .parallel import encode_qoa_batch, encode_wav_batch

    n = n_devices
    model = 2 if n % 2 == 0 and n > 1 else 1
    mesh = pmesh.make_mesh(n, data=n // model, model=model, devices=devices)
    first = mesh.devices[0, 0]
    B = max(8, n)
    args = _example_inputs(B=B)
    ref = mp3_dsp.mp3_window_dsp(
        *(torch.from_numpy(a).to(first) for a in args), nch=2, ngr=2)
    got = sharded_step(mesh, args)
    for name, r, g in zip(("pcm", "overlap", "shist"), ref, got):
        r, g = r.cpu().numpy(), g.cpu().numpy()
        if r.shape != g.shape or not np.isfinite(g).all() or \
                not _rel_err(r, g) < FLOAT_TOL:
            raise AssertionError(f"sharded step {name} differs from "
                                 "unsharded")
    pcm_shape = tuple(got[0].shape)

    t0 = time.perf_counter()
    if items is None:
        items = _default_items(first, max(8, n))
    ref_dec = check_decode(items, mesh)
    kinds = {}
    for d in ref_dec.decoders:
        if d is not None:
            k = type(d).__name__.replace("Decoder", "").lower()
            kinds[k] = kinds.get(k, 0) + 1
    lane_kinds = [f"{k} x{c}" for k, c in kinds.items()]
    flac = [x for x, d in zip(items, ref_dec.decoders)
            if type(d).__name__ == "FlacDecoder"]
    if flac and native.get_lib() is not None:
        check_decode(flac, mesh, flac_wire="rice")
        lane_kinds.append(f"flac rice wire x{len(flac)}")

    enc = _encode_pcms(max(8, n))
    if encode_qoa_batch(enc, 44100, device=first) != \
            encode_qoa_batch(enc, 44100, mesh=mesh):
        raise AssertionError("sharded QOA encode is not byte-equal")
    opt = EncodingOptions(sample_format=AudioSampleFormat.s24)
    if encode_wav_batch(enc, 44100, opt, device=first) != \
            encode_wav_batch(enc, 44100, opt, mesh=mesh):
        raise AssertionError("sharded WAV s24 encode is not byte-equal")
    lane_kinds.append(f"qoa+wav batched encode x{len(enc)} (byte-exact "
                      "sharded)")
    summary = {"mesh": dict(mesh.shape), "step_pcm": pcm_shape,
               "lanes": len(items), "kinds": lane_kinds,
               "seconds": time.perf_counter() - t0}
    print(f"dryrun_multichip ok: mesh={summary['mesh']}, step pcm "
          f"{pcm_shape}, scheduler lanes={len(items)} "
          f"({' + '.join(lane_kinds)}), sharded==unsharded")
    return summary


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
