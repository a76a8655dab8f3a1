#!/usr/bin/env python3
"""Drive the audio_formats_torch FLAC, QOA, MP3, WAV, Vorbis and Opus slices,
the single-stream facade of all eight formats and the mesh once on one CUDA
GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device — a CUDA GPU is present (no fallback), its name and power limit,
   and the C host entropy stage loads;
2. build  — nvcc builds every CUDA kernel from csrc/, all at once;
3. kernel — each kernel against its plain PyTorch twin on the card at the
   main path's shape, bit for bit, both timed, each beside its bound (the
   least time for its bytes or its int32 operations on an H100 SXM): the
   LPC kernel at 12,288 random lanes x 4,096 samples (and against the
   exact int64 host oracle on a subset of lanes), and again at the FLAC
   slice's own first window (phase 4 keeps that call's arguments); the QOA
   decode kernel at 8,192 x 5,120 in both input forms (int32 residuals,
   int8 scalefactors and codes), and again at the QOA decode slice's own
   first and last (6,584-lane) windows (phase 6 keeps their arguments);
   the QOA encode search at 2,048 x 5,120
   with frame lengths around slice edges and full-scale square waves, and
   its quantizer against its direct form on all 2^32 int32 residuals; the
   MP3 Huffman kernel at one full window of the MP3 slice (98,304
   granule-channel lanes parsed by the C stage from the MP3 corpus, four
   a frame addressing their frame's main data in the pool) and on
   random-bit lanes at two row widths; K14, the MP3 window kernel, and the
   synthesis product after it against their twin (K3's output of the MP3
   slice's first 32 and first 128 lanes, one window, 70% of granules
   mid/side), timed beside the twin.  The LPC, Huffman and QOA decode
   kernels are timed through their wrappers, alone (a launch into a
   pre-made output) and by their host enqueue, the first two also by
   their lane grouping;
4. FLAC   — ``BatchDecoder(streams, device="cuda").decode_all(output="device")``
   over 512 FLAC lanes cut from 16 synthetic masters (16-bit stereo 44.1 kHz
   mid/side LPC-8, block 4096, 6-10 s), then ``.sync()``; the PCM stays on
   the card, every lane equals its source PCM bit for bit after
   ``.to_numpy()``, no group was demoted, and the LPC kernel launched once
   per window; then the same lanes with ``flac_wire="rice"`` (the raw frame
   bytes uploaded once as a corpus, the frame pool gathered on the card,
   the frame-entropy kernel K4): every lane bit-exact, no frame decoded
   again on the host, one K4 and one LPC launch per dispatch, its wall
   beside the packed wire's; then K4 at that slice's own first dispatch
   (6,144 frame lanes x 2 channels x 4,096 samples, its arguments kept by
   wrapping ``ops.flac_rice.flac_frame_entropy``), bit-equal to its twin on
   every output, timed through its wrapper and alone beside its bound, the
   pool gather timed, and K4 again on that dispatch with its pool damaged,
   bit-equal;
5. QOA encode — ``encode_qoa_batch`` over 64 distinct stereo 44.1 kHz
   masters of 4 s (the JAX bench's encode shape: 4,480 frame lanes), one
   search launch per chunk; frames equal to the golden encoder's; the
   sequential layout on 4 masters equal to the streaming QoaEncoder; the
   search again at the slice's own first (full) and last (tail) chunks
   (their arguments kept by wrapping ``ops.lms.qoa_encode_frame_words``
   during the slice), bit-equal to the twin and timed;
6. QOA decode — ``decode_all(output="device")`` over 512 QOA lanes cut as
   frame prefixes (10-35 frames) of the 64 encoded masters: every lane
   equals an independent numpy decode, two equal the golden decoder, each
   master is > 25 dB from its source, one decode launch per window;
7. mixed  — mono lanes, 24-bit lanes (host frames), 18-bit lanes that mix
   host and device frames in one window, corpus lanes, 8 QOA lanes and a
   corrupt FLAC and a corrupt QOA lane in one batch: every other lane
   exact; then the same batch over the FLAC Rice wire, where the frames
   wider than 18 bits are decoded again on the host;
8. MP3    — ``decode_all(output="device")`` over 1,024 stereo 44.1 kHz
   MPEG-1 Layer III lanes cut as frame slices of 24 masters of 18 s (the
   JAX bench's recipe, bench.py:41-67 and 194-212, with a global gain that
   puts the PCM in [-1, 1]), then ``.sync()``: every lane within 1e-4 of an
   independent float64 decode (mp3_ref.decode_mono of the master from the
   lane's second frame on, of the lane's own first frame before), no
   demotion, one Huffman launch per window;
9. mixed MP3 — MS and intensity stereo, MPEG-2 mono and intensity stereo,
   Layer I and II, a corrupt MP3 lane, FLAC and QOA lanes in one batch:
   every lane within 1e-4 of the port's own device="cpu" decode;
10. WAV    — ``decode_all(output="device")`` over 256 distinct stereo
   44.1 kHz s16 masters of 10 s (225.8 M samples, 451.6 MB of payload up
   as it is, one K10 launch), every lane bit-exact against the reference's
   double math; then K10 alone: its decode at that payload (wrapper, alone,
   the twin, and ``torch.div(int16, 32767.)``, the one PyTorch call that
   computes the same function), every u8, s16 and s24 value against the
   double math, and a TPDF-dithered s24 encode of [256, 2^18] rows (the JAX
   bench's shape) against the twin; then mixed WAV lanes (u8, s24, s32,
   extensible, float, truncated), each equal to the port's CPU decode;
11. WAV encode — ``encode_wav_batch`` over the QOA encode slice's 64
   masters as s24 with TPDF dither and as s16 without, every byte equal to
   the CPU encode (the twin);
12. Vorbis — ``decode_all(output="device")`` over 256 stereo coupled lanes
   (block sizes 512/2048) of 16 masters of 72 packets (mostly long blocks,
   a short pair every so often: 9 windows of 8 packets), each lane within
   4e-6 of the peak of the port's CPU decode and within 1e-4 of the peak
   of the golden float64 synthesis (tests/golden/vorbis_ref.py, loaded with
   the port's Ogg page writer and inverse-dB table); then K11 at that
   slice's first window (kept by wrapping
   ``ops.vorbis_win.vorbis_window_chain``), against its twin within 4e-6
   of the peak, timed through its wrapper and alone, by its device time
   (``torch.profiler``) and its host enqueue, beside the IMDCT matmuls of
   the same window, with the lanes it ran in order counted;
13. Opus  — ``decode_all(output="device")`` over 256 stereo CELT-only lanes
   cut as packet prefixes (2-4 s, preskip 0, 130 or 312) of the four stereo
   masters of the committed libopus corpus (tests/torch_opus_cases.py) and
   a mono lane of the four real CELT packets of tests/test_opus_celt.py:
   every stereo lane within 1e-5 of the peak of its master's per-stream
   read on the host (models/celt.py's f64 IMDCT, a path K12a is not on),
   the mono lane's spot samples and RMS (checked there against libopus)
   within 1e-5, no demotion, one K12a launch a bucket a step (the fused
   kernel for blocks of 120, the in-place mix after the IMDCT matmul for
   long blocks: launches held to the buckets counted by (blocks, bs)); the
   realtime factor and the host, upload, download and postfilter times;
   then each route of K12a at that slice's first bucket of it (kept by
   wrapping ``ops.celt_dsp.celt_imdct_ola_packed``) and alone at 4,096 rows x 8 x
   120 (fused) and 4,096 x 1 x 960 (in place) from random spectra: the
   fused route within 1e-6 of the peak of its twin, one kernel and no
   matmul a call, beside the matmul it replaces; the in-place mix bit-equal
   to its twin on the matmul's halves, with the kernels a call of the
   route runs (no copy after the GEMM); each timed through its wrapper,
   alone, by its device time and its host enqueue; then mixed Opus lanes
   (corpus stereo and mono, the four CELT packets, a stereo-coded lane with a mono header,
   mono and stereo SILK and hybrid lanes and a mode tour in their groups,
   a DTX lane, a corrupt lane), each within 1e-5 of the peak of the port's
   CPU decode;
14. Opus speech — ``decode_all(output="device")`` over 256 mono WB SILK
   lanes (the SILK group: one K13 launch a packet step), 256 mono FB
   hybrid lanes (K13 and the CELT buckets' K12a) and 64 mode-tour lanes
   (the mixed group on its device path), packet prefixes of 2-4 s of the
   committed libopus speech corpus (tests/torch_opus_speech_cases.py),
   every lane within 1e-5 of the peak of the host per-stream read (made
   once for each distinct lane), every lane in its group, no demotion,
   K12a's launches by route held to the CELT buckets by (blocks, bs);
   then K13 at the SILK slice's first step (kept by wrapping
   ``ops.resample.silk_upsample``) and at 4,096 rows for den 6, 4 and 3,
   within 1e-6 of the peak of its twin (with the share of samples
   bit-equal), beside the twin and ``conv1d`` (cuDNN, TF32 off), timed as
   K12a is; K12b at
   [512, 960] and [4,096, 960] within 1e-6 of its twin, alone and chained
   after the IMDCT and K12a over 12 frames with the memory carried (the
   JAX bench's CELT chain; K12b reads K12a's packed buffer by row stride,
   and one frame's device work runs no copy between K12a and K12b); and
   the mixed group's host and device CELT answers at 8, 16 and 32 lanes,
   in turns;
15. facade — one track a format through
   ``AudioStream(device="cuda").open_from_memory``, read to the end in
   1,024-frame chunks (examples/transcode.py's), the launch counters set to
   0 just before each: FLAC (flac_master's coding, its frames built in
   pieces by the process pool while nvcc builds), WAV s16 and QOA (encoded
   on the card) of the same 180 s of stereo PCM; MP3, 10 masters of 18 s
   (mp3_master) in one stream; 78.7 s of Vorbis of the golden builder;
   the 16 s of the four stereo masters of the libopus corpus in turn; a
   MOD and an XM song of 8 patterns of 64 rows (61.4 s).  Each is held to
   the port's facade on the CPU (a process pool: the first 20 s of FLAC
   and QOA, whose twins take ~0.5 s a second of audio on one core, three
   20 s pieces of MP3 from seeks, the whole of the others) and to an
   independent reference over the whole track (FLAC, WAV,
   QOA: bit-equal to the source or numpy-decoded PCM; MP3 within 1e-4 of
   mp3_ref), passes transcode.py's seek check (16 windows after
   seek_position, frame-exact for FLAC, WAV and QOA; Opus windows, which
   decode from a pre-roll as the reference's do, against the CPU's after
   the same seek), and K1, K2 and K10 launch on FLAC, QOA and WAV.  The
   FLAC track's card decode is encoded on the card as dithered s24 WAV
   (its first 20 s byte-equal to the CPU's) and as QOA (K5; its first 4
   frames byte-equal to the CPU's), ``to_wav`` of its first 20 s on both
   (byte-equal), and the four examples of
   examples_torch/ run on the card as subprocesses: transcode
   --check-seeking on the FLAC and MP3 tracks, dump_patterns on the XM,
   batch_decode on a file of each format, midi2wav on a small MIDI file;
16. mesh  — ``make_mesh(1)``, and ``make_mesh(4, data=4, devices=["cuda:0"]
   * 4)`` (make_mesh of one device more than the card count raises); over
   the latter, ``BatchDecoder(..., mesh=).decode_all(output="device")`` of
   the FLAC slice's 512 lanes on both wires (bit-equal to the same lanes
   unsharded and to their source) and of the MP3 slice's 1,024 lanes
   (within 4e-6 of the unsharded run's peak and 1e-4 of mp3_ref), then a
   mixed set (Layer II, QOA, WAV, Vorbis, CELT, SILK, hybrid and
   mode-switching Opus, one corrupt lane, the only one that may err or
   leave its group; the mixed Opus group on the device path under 16
   lanes) against its unsharded run, the QOA encode (4,480 frame lanes)
   and the dithered s24 WAV encode of the encode slice's masters
   byte-equal to the unsharded encodes, and ``entry.dryrun_multichip(4,
   devices=["cuda:0"] * 4, items=...)`` on the JAX dryrun's lanes and the
   mixed set; each timed sharded and unsharded, and each kernel's
   launches a shard counted (``mesh_launches``).

Prints a JSON line with the kernels' launches (and the facade's launches
of K1, K2, K5 and K10, and the mesh phase's), errors, times and bounds,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX or of the JAX package, and checks so
before the result.

    python3 chip_smoke.py --ab DIR [mp3_huff flac_lpc qoa_encode qoa_decode
                                    flac_rice vorbis_win silk_upsample
                                    celt_ola celt_deemph]
    python3 chip_smoke.py --divergence                            # CPU
    python3 chip_smoke.py --sass [DIR ...]          # nvcc and cuobjdump
    python3 chip_smoke.py --wires                   # the card
    python3 chip_smoke.py --ring                    # the card
    python3 chip_smoke.py --grid                    # the card
    python3 chip_smoke.py --dsp                     # the card
    python3 chip_smoke.py --windows                 # the card

``--dsp`` (on the card) builds K3 and K14 (with K15) and runs their
phases at the fma_mp3.b32 cell's window (the size ``mp3_window_frames``
gives 32 stereo clips on this card: K3 bit-equal to its twin, K14 and K15
within K14_TOL of theirs and K15 within K15_TOL of the Toeplitz product,
timed beside the route with the product) and K14's and K15's at 24-frame
windows of 32 and 128 lanes, on 128 lanes cut from 8 masters of 18 s.

``--windows`` (on the card) decodes calls of the fma_mp3.b32 cell's shape
(32 clips of 30 s from portbench's generator) with Layer III windows of 24
frames and of the size ``mp3_window_frames`` gives, in turns, and prints
the device time a call of K3, its plan, K14, K15, any matmul and the
uploads, K3's launches and share of its bound, and the memory peak.

``--grid`` (on the card) builds K12a's fused route with one block a tile
beside the source's grid, capped at the blocks that fit on the card at
once, holds the two bit-equal and times each launch by device time in
turns at the GRID_PROBES shapes; it prints no result line.

``--wires`` decodes the FLAC slice's 512 lanes over the packed and the Rice
wire in turns (packed, rice, rice, packed: each wall, realtime factor,
bytes to the card and host times), then once each under ``torch.profiler``:
the card's busy share of that run's wall (its kernels' and copies' summed
device time, all on one stream) and the device time by kernel.  It prints
no result line.

``--ring`` (on the card) builds K4 with each staging ring of RING_PROBES
(word-major or lane-major, 1, 2 or 4 blocks a lane), holds each bit-equal
to this tree's K4 at the FLAC Rice slice's first dispatch and times it
there alone and as one warp, in turns; it prints no result line.

``--ab`` (on the card) times the Huffman, LPC, QOA encode, QOA decode,
frame-entropy, Vorbis window, SILK upsample, CELT IMDCT and
overlap-add and CELT deemphasis kernels of this tree (or those named)
against those built from DIR/audio_formats_torch/csrc (an earlier
commit's sources, e.g. from ``git archive``), parent / change / change /
parent in one process, each pair first held equal (K13 bit for bit at
the SILK slice's first step and at 4,096 rows for den 6, 4, 3; K12a,
against the parent's IMDCT matmul and K12a, within 1e-6 of the peak at
the Opus slice's first bucket of each route and at both large shapes;
K12b, each side within 1e-6 of the peak of the twin at both
DEEMPH_SHAPES, by device time), and the MP3, FLAC, QOA
encode, QOA decode, FLAC Rice and Vorbis slices with either side's
kernel; where DIR holds the earlier
commit's whole tree, its own K3 phase and MP3 slice (its wire and bytes to
the card) run from DIR in a process of their own.  It prints no result
line.  ``--divergence`` (CPU) counts the
paths a warp of the branching frame-entropy kernel (the design before the
register window) ran a sample at the FLAC Rice slice's first dispatch
(the twin's scan with each lane's branches recorded), then each lane's
Huffman FSM steps on one MP3 window with the twin and the warp ratio in
the window's order and in the order the Huffman wrapper gives the kernel.
``--sass`` (nvcc and cuobjdump) counts,
in this tree's kernels and in each DIR's, the SASS instructions of one
step of K5's full-slice body by pipe, of one step of K2's chain loop by
pipe with its dependent chain from one sample to the next and the tile
loop's instructions outside it, of K4's sample loop: its shortest and
longest paths that decode, by pipe, with their dependent chains and the
loads on them, of one sample of K10's dithered s24 quantize, of K11's
PCM row loop a 16-byte vector, K13's FFMAs with the shared loads and
constant-bank operands that feed them, and K12b's loops that read x:
their instructions a sample and their global loads and stores by width.
"""

import json
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))  # golden FLAC/QOA coders

SR = 44100
BLOCK = 4096
N_MASTERS = 16
N_LANES = 512
L_KERNEL = 12288      # 512 lanes x 12 frames x 2 channels: one full window
B_KERNEL = 4096
QOA_MASTERS = 64      # bench.py's bench_batch_encode(B=64, secs=4)
QOA_SECONDS = 4
QOA_LANES = 512
QOA_FRAME = 5120
L_QOA_DECODE = 8192   # one full decode window
L_QOA_ENCODE = 2048   # one full encode chunk
MP3_MASTERS = 24      # bench.py: 24 masters of 18 s
MP3_SECONDS = 18.0
MP3_LANES = 1024
MP3_GAIN = 162        # global gain: the masters' PCM peaks near 0.5
MP3_TOL = 1e-4        # max abs PCM error of a transform codec (ROADMAP)
WAV_LANES = 256       # stereo 44.1 kHz s16 masters of 10 s
WAV_SECONDS = 10
ENC_ROWS = 256        # K10's encode alone: bench.py's [256, 2^18] s24 rows
ENC_N = 1 << 18
VORBIS_LANES = 256    # stereo coupled lanes, bs 512/2048 (bench.py:532-560)
VORBIS_MASTERS = 16
VORBIS_PACKETS = 72   # 9 windows of 8 packets
VORBIS_TOL = 4e-6     # of the peak: batch against the CPU decode
VORBIS_REF_TOL = 1e-4  # of the peak: against the golden synthesis
OPUS_LANES = 256      # stereo CELT lanes (bench.py:731's B=256)
OPUS_TOL = 1e-5       # of the peak: batch against the per-stream read
OPUS_BIG = ((4096, 8, 120), (4096, 1, 960))  # K12a alone: rows, blocks, bs
SPEECH_LANES = 256    # mono WB SILK lanes, and mono FB hybrid lanes
TOUR_LANES = 64       # mode tours: above OPUS_MIXED_DEVICE_MIN_LANES
SPEECH_PACKETS = (100, 133, 166, 200)  # lane prefixes: 2-4 s of 20 ms
SILK_BIG_ROWS = 4096  # K13 alone, at each of den 6, 4, 3
DEEMPH_SHAPES = ((512, 960), (4096, 960))  # K12b: bench.py:731's 512 rows
DEEMPH_FRAMES = 12    # K12a then K12b, m carried (bench.py:800-810)
DEEMPH_TOL = 1e-6     # of the peak: K12b against its twin
K13_TOL = 1e-6        # of the peak: K13 against its twin
MIXED_PROBE = (8, 16, 32)  # mixed group lanes timed on host and device
FACADE_CHUNK = 1024   # examples/transcode.py's CHUNK: the facade's reads
FACADE_MP3_PIECES = 10  # the MP3 track: 10 masters of 18 s concatenated
FACADE_FLAC_PIECES = 24  # the FLAC track's frames, encoded by the pool
FACADE_VORBIS_PACKETS = 3876  # 78.7 s: long blocks, a short pair every 12
FACADE_ORDERS = 8     # MOD and XM: 8 patterns x 64 rows, speed 6, 125 BPM
FACADE_SEEKS = 16     # transcode.py --check-seeking's windows
FACADE_CPU_SECONDS = 20  # the CPU facade's share of the FLAC, QOA and
                      # MP3 reads and of the WAV encodes (its twins take
                      # 0.35-0.55 s a second of audio on one core)
FACADE_QOA_CPU_FRAMES = 4  # the CPU's QOA encode: its first frames only
FACADE_WORKERS = 6    # processes of the CPU facade's reads and encodes
FACADE_FORMATS = ("flac", "wav", "qoa", "mp3", "vorbis", "opus", "mod",
                  "xm")
#: the card's facade PCM against the CPU facade's: max abs (MP3) or of the
#: peak (Vorbis, Opus); the others bit-equal
FACADE_TOL = {"mp3": (MP3_TOL, False), "vorbis": (VORBIS_TOL, True),
              "opus": (OPUS_TOL, True)}
F32_RECIP = np.float32(1.0) / np.float32(32767.0)  # QOA's s16 -> float
MESH_SHARDS = 4       # phase 16: a mesh that names cuda:0 four times
                      # on the card (the JAX dryrun's, __graft_entry__.py:248)

_GOLDEN = {}


def golden(name, olds):
    """tests/golden/<name>.py loaded with each import line of `olds` (found
    there once) pointed from the JAX package at the port's byte-identical
    copies, so that this script imports nothing of the JAX package."""
    if name not in _GOLDEN:
        path = os.path.join(ROOT, "tests", "golden", name + ".py")
        with open(path) as f:
            src = f.read()
        for old in olds:
            if src.count(old) != 1:
                raise AssertionError(f"{path}: {old!r} is not there once")
            src = src.replace(old, old.replace("audio_formats_tpu",
                                               "audio_formats_torch"))
        mod = types.ModuleType("golden_" + name)
        mod.__file__ = path
        sys.modules[mod.__name__] = mod
        exec(compile(src, path, "exec"), mod.__dict__)
        _GOLDEN[name] = mod
    return _GOLDEN[name]


def golden_mp3_ref():
    """The golden MP3 coder and float64 decoder, with the spec tables and
    the synthesis FIR of audio_formats_torch/utils/tables."""
    return golden("mp3_ref", ("from audio_formats_tpu.utils.tables import",
                              '"audio_formats_tpu", "utils", "tables"'))


def golden_vorbis_ref():
    """The golden Vorbis fixture builder and float64 synthesis, with the
    port's Ogg page writer and inverse-dB table.  Its IMDCT builds the same
    cosine matrix for every frame; here each block size's is built once."""
    mod = golden("vorbis_ref", (
        "from audio_formats_tpu.io import ogg",
        "from audio_formats_tpu.utils.tables.vorbis_tables import"))
    if not hasattr(mod, "_imdct64_per_frame"):
        mats = {}

        def imdct64(X, n):
            if n not in mats:
                m = n // 2
                k = np.arange(m)[:, None]
                t = np.arange(n)[None, :]
                mats[n] = np.cos(np.pi / (2 * n) * (2 * t + 1 + m)
                                 * (2 * k + 1))
            return X @ mats[n]

        mod._imdct64_per_frame = mod.imdct64
        mod.imdct64 = imdct64
    return mod


def golden_opus_ref():
    """The golden Ogg Opus stream builder, with the port's Ogg page
    writer."""
    return golden("opus_ref", ("from audio_formats_tpu.io import ogg",))


def read_constants(name, names):
    """Module-level constants `names` of tests/<name>.py, read from its
    source (the file imports the JAX package, so it is not imported)."""
    import ast

    path = os.path.join(ROOT, "tests", name + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id in names:
            found[node.targets[0].id] = ast.literal_eval(node.value)
    missing = set(names) - set(found)
    if missing:
        raise AssertionError(f"{path}: no {sorted(missing)}")
    return found


# --------------------------------------------------------------- corpus
def flac_master(seed: int, seconds: float):
    """One FLAC master: stereo mid/side 16-bit, mixed tonal+noise content
    (the FLAC half of the repo's benchmark corpus).  Returns (bytes, pcm)."""
    from golden import flac_ref

    x = flac_master_pcm(seed, seconds)
    data = flac_ref.build_flac(x, SR, 16, block_size=BLOCK,
                               stereo_mode="mid_side", modes=["lpc8", "lpc8"])
    return data, x


def flac_master_pcm(seed: int, seconds: float):
    """The s16 PCM [frames, 2] int64 of flac_master(seed, seconds)."""
    rng = np.random.default_rng([7, seed])
    frames = int(seconds * SR)
    t = np.arange(frames)[:, None]
    f0 = rng.uniform(80, 800)
    amp = rng.uniform(4000, 16000)
    noise = rng.uniform(100, 1500)
    x = np.clip(
        np.round(
            amp * np.sin(2 * np.pi * f0 * t * [1.0, 1.003] / SR)
            + 0.35 * amp * np.sin(2 * np.pi * 2.7 * f0 * t * [1.0, 0.99] / SR)
            + noise * rng.standard_normal((frames, 2))
        ),
        -32768, 32767,
    ).astype(np.int64)
    return x


def flac_frames(pcm, first: int) -> bytes:
    """flac_master's frames of `pcm` ([n, 2] s16, n a multiple of BLOCK
    but for the last piece), numbered from frame `first`."""
    from golden import flac_ref

    pcm = pcm.astype(np.int64)
    return b"".join(flac_ref.encode_frame(
        pcm[k: k + BLOCK], first + k // BLOCK, SR, 16, "mid_side",
        ["lpc8", "lpc8"]) for k in range(0, len(pcm), BLOCK))


def flac_header(n_samples: int) -> bytes:
    """The metadata flac_master's stream of `n_samples` stereo frames
    starts with (build_flac's): STREAMINFO and a padding block."""
    from golden import flac_ref

    si = flac_ref._BW()
    for value, bits in ((BLOCK, 16), (BLOCK, 16), (0, 24), (0, 24),
                        (SR, 20), (1, 3), (15, 5), (n_samples, 36)):
        si.w(value, bits)
    info = bytes(si.bytes) + b"\0" * 16
    return (b"fLaC" + bytes([0]) + len(info).to_bytes(3, "big") + info
            + bytes([0x81]) + (16).to_bytes(3, "big") + b"\0" * 16)


def frame_offsets(data: bytes):
    """Byte offsets of every frame, found by a CRC8-validated sync scan."""
    from golden.flac_ref import _crc8

    pos = 4
    while True:
        hdr = data[pos: pos + 4]
        pos += 4 + int.from_bytes(hdr[1:4], "big")
        if hdr[0] & 0x80:
            break
    b = np.frombuffer(data, np.uint8)
    # 14-bit sync + the golden encoder's header shape (block size code 7)
    cand = np.flatnonzero((b[pos:-8] == 0xFF) & ((b[pos + 1:-7] & 0xFC) == 0xF8)
                          & ((b[pos + 2:-6] >> 4) == 7)) + pos
    offs = []
    for i in cand.tolist():
        if offs and i < offs[-1] + 16:
            continue
        # header: 4 fixed bytes, utf8 frame index, 16-bit (bs-1), crc8
        fb = data[i + 4]
        ext = 0 if fb < 0x80 else (
            1 if fb >> 5 == 0b110 else 2 if fb >> 4 == 0b1110 else
            3 if fb >> 3 == 0b11110 else 4 if fb >> 2 == 0b111110 else
            5 if fb >> 1 == 0b1111110 else 6)
        j = i + 5 + ext + 2
        if j < len(data) and _crc8(data[i:j]) == data[j]:
            offs.append(i)
    return offs


def flac_prefix(data: bytes, offs, n_keep: int):
    """The stream cut to its first n_keep frames, with STREAMINFO's total
    sample count patched to match; the whole stream when it is shorter."""
    if len(offs) <= n_keep:
        return data
    body_off = 8  # 4 ('fLaC') + 4 (STREAMINFO block header)
    si = int.from_bytes(data[body_off: body_off + 18], "big")
    shift = 18 * 8 - 108 - 36
    si &= ~(((1 << 36) - 1) << shift)
    si |= (n_keep * BLOCK) << shift
    return (data[:body_off] + si.to_bytes(18, "big")
            + data[body_off + 18: offs[n_keep]])


def build_corpus(n_lanes=N_LANES, n_masters=N_MASTERS, workers=8):
    """n_lanes FLAC lanes cut as frame prefixes of n_masters masters.
    Returns (streams, expected s32-source pcm per lane)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    secs = [6.0 + (i % 5) for i in range(n_masters)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        masters = list(ex.map(flac_master, range(n_masters), secs))
    offs = [frame_offsets(d) for d, _ in masters]
    streams, pcms = [], []
    for k in range(n_lanes):
        mi = k % n_masters
        data, pcm = masters[mi]
        nfr = len(offs[mi])
        keep = nfr - (k // n_masters * 3) % (nfr - 8)
        streams.append(flac_prefix(data, offs[mi], keep))
        pcms.append(pcm[: keep * BLOCK])
    return streams, pcms


def edge_streams(rng, corpus, corpus_pcm):
    """Mono 16-bit lanes, 24-bit stereo lanes, 18-bit lanes mixing host and
    device frames, a few corpus lanes and one corrupt lane (last)."""
    from golden import flac_ref

    streams, pcms, bps = [], [], []

    def tone(frames, ch, bits):
        t = np.arange(frames)[:, None]
        a = 0.3 * (1 << (bits - 1))
        x = (a * np.sin(2 * np.pi * rng.uniform(100, 900) * t
                        * [1.0, 1.01][:ch] / SR)
             + a / 50 * rng.standard_normal((frames, ch)))
        lim = (1 << (bits - 1)) - 1
        return np.clip(np.round(x), -lim - 1, lim).astype(np.int64)

    for i in range(4):
        x = tone(SR + 1234 * i, 1, 16)
        streams.append(flac_ref.build_flac(x, SR, 16, block_size=BLOCK,
                                           modes=["lpc8"]))
        pcms.append(x), bps.append(16)
    for i in range(2):
        x = tone(SR // 2 + 777 * i, 2, 24)
        streams.append(flac_ref.build_flac(x, SR, 24, block_size=BLOCK,
                                           stereo_mode="left_side",
                                           modes=["lpc8", "fixed2"]))
        pcms.append(x), bps.append(24)
    for i in range(2):
        # 18-bit stereo: independent frames (18-bit exact lanes on the
        # card) alternate with mid/side frames (19-bit side: host)
        nf = 6 + i
        x = tone(BLOCK * nf, 2, 18)
        out = bytearray(b"fLaC")
        si = flac_ref._BW()
        si.w(BLOCK, 16); si.w(BLOCK, 16); si.w(0, 24); si.w(0, 24)
        si.w(SR, 20); si.w(1, 3); si.w(17, 5); si.w(BLOCK * nf, 36)
        info = bytes(si.bytes) + b"\0" * 16
        out += bytes([0x80]) + len(info).to_bytes(3, "big") + info
        for fi in range(nf):
            mode = "independent" if fi % 2 == 0 else "mid_side"
            out += flac_ref.encode_frame(x[fi * BLOCK:(fi + 1) * BLOCK], fi,
                                         SR, 18, mode, ["lpc8", "lpc8"])
        streams.append(bytes(out))
        pcms.append(x), bps.append(18)
    for k in range(0, 64, 8):
        streams.append(corpus[k])
        pcms.append(corpus_pcm[k]), bps.append(16)
    bad = bytearray(corpus[1])
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    streams.append(bytes(bad))
    return streams, pcms, bps


def expected_f32(pcm, bits):
    return ((pcm << (32 - bits)).astype(np.float64)
            * (1.0 / 2147483647.0)).astype(np.float32)


def qoa_masters(n=QOA_MASTERS, seconds=QOA_SECONDS):
    """n distinct stereo float masters: two detuned partials under a slow
    swell, plus a little noise, each from its own seed."""
    frames = int(seconds * SR)
    t = np.arange(frames)[:, None] / SR
    out = []
    for i in range(n):
        rng = np.random.default_rng([11, i])
        f0 = rng.uniform(60, 900)
        amp = rng.uniform(0.1, 0.6)
        swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        x = (amp * swell * np.sin(2 * np.pi * f0 * t * [1.0, 1.002])
             + 0.3 * amp * np.sin(2 * np.pi * 3.1 * f0 * t * [1.0, 0.997])
             + amp * rng.uniform(0.005, 0.03)
             * rng.standard_normal((frames, 2)))
        out.append(np.clip(x, -1.0, 1.0).astype(np.float32))
    return out


def qoa_s16(master):
    from audio_formats_torch.ops import pcm

    return pcm.quantize_float_to_int_np(master.reshape(-1), "s16")\
        .reshape(-1, master.shape[1]).astype(np.int16)


def qoa_frame_bytes(ch, samples=QOA_FRAME):
    return 8 + 16 * ch + 8 * (-(-samples // 20)) * ch


def qoa_prefix(data: bytes, keep: int):
    """The QOA stream cut to its first `keep` frames, the file header's
    sample count patched to match.  Returns (bytes, samples per channel)."""
    total = int.from_bytes(data[:8], "big") & 0xFFFFFFFF
    ch = data[8]
    n = min(total, keep * QOA_FRAME)
    body = data[8:] if n == total else data[8: 8 + keep * qoa_frame_bytes(ch)]
    return ((0x716F6166 << 32) | n).to_bytes(8, "big") + body, n


def numpy_qoa_decode(streams):
    """Independent decode of whole QOA streams: every (frame, channel) of
    every stream is one lane (QOA frames carry their LMS state), run as one
    vectorised int32 recurrence with numpy's wraparound.  Returns the s16
    PCM of each stream."""
    from golden import qoa_ref

    dq = np.array(qoa_ref.DEQUANT_TAB, np.int32)
    shifts = np.uint64(57) - np.uint64(3) * np.arange(20, dtype=np.uint64)
    hist, wts, res, meta = [], [], [], []
    for si, data in enumerate(streams):
        total = int.from_bytes(data[:8], "big") & 0xFFFFFFFF
        pos, done = 8, 0
        while done < total:
            hdr = int.from_bytes(data[pos: pos + 8], "big")
            ch, n, size = hdr >> 56, (hdr >> 16) & 0xFFFF, hdr & 0xFFFF
            state = np.frombuffer(data, ">i2", 8 * ch, pos + 8).reshape(ch, 2, 4)
            ns = -(-n // 20)
            words = np.frombuffer(data, ">u8", ns * ch, pos + 8 + 16 * ch)\
                .reshape(ns, ch).T
            codes = ((words[..., None] >> shifts) & np.uint64(7)).astype(np.int64)
            r = np.zeros((ch, QOA_FRAME), np.int32)
            r[:, : ns * 20] = dq[(words >> np.uint64(60)).astype(np.int64)[..., None],
                                 codes].reshape(ch, -1)
            hist.append(state[:, 0])
            wts.append(state[:, 1])
            res.append(r)
            meta.append((si, ch, n))
            pos += size
            done += n
    h = np.concatenate(hist).astype(np.int32)
    w = np.concatenate(wts).astype(np.int32)
    r = np.concatenate(res)
    out = np.empty_like(r)
    for t in range(QOA_FRAME):
        p = (h * w).sum(axis=1, dtype=np.int32) >> 13
        x = np.clip(p + r[:, t], -32768, 32767)
        delta = (r[:, t] >> 4)[:, None]
        w += np.where(h < 0, -delta, delta)
        h = np.concatenate([h[:, 1:], x[:, None]], axis=1)
        out[:, t] = x
    pcm = [[] for _ in streams]
    row = 0
    for si, ch, n in meta:
        pcm[si].append(out[row: row + ch, :n].T)
        row += ch
    return [np.concatenate(p).astype(np.int16) for p in pcm]


# --------------------------------------------------------------- phases
def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernel_lanes(rng, L, B, n_sig):
    """Random lanes for kernel-vs-twin (exact and wrap lanes, orders 0..32,
    shifts 0..31, 15-bit coefficients, pad lanes), whose first n_sig lanes
    are instead built from bounded signals, so the int64 host oracle and the
    signal itself must come back from them.  Returns (args, signal)."""
    residual = rng.integers(-(1 << 17), 1 << 17, (L, B), dtype=np.int32)
    order = rng.integers(0, 33, L).astype(np.int32)
    shift = rng.integers(0, 32, L).astype(np.int32)
    exact = rng.random(L) < 0.5
    lim = np.where(exact, 1 << 14, 1 << 9)
    coeffs = np.zeros((L, 32), np.int32)
    taps = np.arange(32)[None, :] < order[:, None]
    coeffs[taps] = (rng.integers(-(1 << 14), 1 << 14, (L, 32))
                    % (2 * lim[:, None]) - lim[:, None])[taps]
    pad = rng.random(L) < 0.1
    pad[:n_sig] = False
    order[pad] = B
    # signal lanes: |s| < 2^15 (wrap) or 2^17 (exact), residual = s - pred
    t = np.arange(B)
    amp = np.where(exact[:n_sig], 1 << 16, 1 << 14)[:, None]
    sig = np.round(amp * np.sin(2 * np.pi * rng.uniform(1e-3, 0.2, (n_sig, 1))
                                * t)
                   + rng.integers(-300, 300, (n_sig, B))).astype(np.int64)
    acc = np.zeros((n_sig, B), np.int64)
    for j in range(32):
        acc[:, j + 1:] += coeffs[:n_sig, j: j + 1].astype(np.int64) \
            * sig[:, : B - j - 1]
    wrapped = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    pred = np.where(exact[:n_sig, None], acc, wrapped) >> shift[:n_sig, None]
    res = np.where(t[None, :] < order[:n_sig, None], sig, sig - pred)
    residual[:n_sig] = res.astype(np.int32)
    return (residual, coeffs, order, shift, exact), sig


def time_cuda(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_host(fn, reps=20):
    """The host's time to enqueue one call, in ms: where it exceeds the
    card's time, back-to-back calls leave the card waiting, and time_cuda
    of the call measures the host."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


# Late in a long run (after the Opus speech slices) a trace can miss the
# card's records of some launches: of the port's kernels from 2 of 20 to
# all of them, at random, of torch's own kernels in the same trace fewer.
# ``device_ms(..., per_launch=True)``, ``kernel_names`` and
# ``deemph_chain`` read what a trace holds and trace again where it holds
# too little (a trace can also hold no device event at all).
TRACE_TRIES = 3


def traced(fn, reps):
    """torch.profiler's CUPTI trace of `reps` calls of `fn` (one call
    before it, untraced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, kernel, reps=20, per_launch=False):
    """The card's own time, in ms a call, that `reps` calls of `fn` spend
    in kernels whose name holds `kernel`: torch.profiler's CUPTI trace of
    those calls (``traced``).  With `per_launch` (for an `fn` that
    launches such a kernel once), the mean of the launches the trace
    holds, which a record missing from the trace does not lower, traced
    again (TRACE_TRIES in all) while it holds fewer than half of them.
    None where the trace shows no device time for it."""
    from torch.autograd import DeviceType

    for _ in range(TRACE_TRIES if per_launch else 1):
        us, count = 0.0, 0
        for evt in traced(fn, reps).key_averages():
            if evt.device_type == DeviceType.CUDA and kernel in evt.key:
                t = getattr(evt, "self_device_time_total", None)
                us += evt.self_cuda_time_total if t is None else t
                count += evt.count
        if 2 * count >= reps:
            break
    return us / (count if per_launch else reps) / 1e3 if us > 0 else None


_FLUSH = []


def l2_flush():
    """Read a 128 MB buffer on the card (more than its 50 MB L2), so that
    what the next kernel reads comes from device memory."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.ones(1 << 25, device="cuda"))
    _FLUSH[0].sum()


def cold_device_ms(fn, kernel, reps=20, per_launch=False):
    """``device_ms`` of `fn` with the L2 flushed (``l2_flush``, a kernel of
    another name) before each call."""
    return device_ms(lambda: (l2_flush(), fn()), kernel, reps, per_launch)


# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its integer operations over the INT32 rate.  NVIDIA H100 SXM:
# 3.35 TB/s of HBM3; 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T
# int32 operations/s (a multiply-add counted as one), at a 700 W limit.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
HUFF_STEP_OPS = 40    # int operations of one K3 step (lookups, shifts, selects)
LMS_STEP_OPS = 12     # K2: 4 multiply-adds, 4 weight updates, shift, clamp
QOA_ENC_OPS = 30      # K5: one candidate's step (predict, divide, quantize,
                      # dequantize, clamp, error, update)
RICE_STEP_OPS = 16    # K4: one Rice sample (unary count, remainder funnel
                      # shift and mask, zigzag, cursor, window shift, count)
# float32 outside the tensor cores: 67 TFLOP/s counts a fused multiply-add
# as two, so 33.5 T instructions/s
F32_OPS_S = 33.5e12
# K10's dithered quantize, a sample: the integer work the function needs,
# what a row shares (its keys, their xor, the injections' key + i) made
# once a row, and a three-input add counted once.  Each of the two
# threefry2x32(k, (0, p)): x1's key add; 20 rounds of add, rotate and xor
# (the first round's add takes in x0's key, k0, as x0 starts at 0);
# injections 1-4 one add each to x1 (their add to x0 joins the next
# round's add), injection 5 two; then the uniform's bits: the xor of the
# two words, and the shift right by 9 with the exponent's or as one
# shift-and-add (the bits do not overlap).  The index, the addresses and
# the pack are left out, so the bound is if anything low.  8 float32 (2
# subtracts, the FMA, 2 scales, 2 adds, the floor).  `--sass` counts the
# kernel's own instructions a sample beside it.
DITHER_INT_OPS = 2 * (1 + 20 * 3 + 4 + 2 + 2)
DITHER_F32_OPS = 8


def bound(nbytes, ops, flops=0):
    """{"bound_ms", "bound_by"} of a kernel that moves nbytes and does ops
    int32 operations and flops float32 ones (the two pipes issue side by
    side: the slower sets the time)."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = max(ops / INT32_OPS_S, flops / F32_OPS_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def lpc_work(targs):
    """(bytes, multiply-adds) of K1 on these lanes: the residual in and
    the samples out, the lane parameters; each predicted step's taps up to
    the lane's last nonzero coefficient."""
    import torch

    residual, coeffs, order, _, _ = targs
    L, B = residual.shape
    taps = torch.where(coeffs != 0, torch.arange(1, 33, device=coeffs.device),
                       0).amax(1)
    steps = (B - order.to(torch.int64)).clamp(min=0)
    macs = int((steps * taps).sum())
    return 2 * residual.numel() * 4 + L * (32 * 4 + 4 + 4 + 1), macs


def time_lpc(targs, reps=20):
    """K1 at these lanes: the wrapper (the plan kernel's lane grouping and
    the launch), the launch alone with the grouping made beforehand, and
    the plan kernel alone, in ms."""
    import torch
    from audio_formats_torch.ops import lpc

    B = targs[0].shape[1]
    for _ in range(3):
        lpc.flac_lpc(*targs)
    ms = time_cuda(lambda: lpc.flac_lpc(*targs), reps)
    perm = lpc.lpc_plan_cuda(targs[1], targs[2], targs[4], B)
    out = torch.empty_like(targs[0])
    kernel_ms = time_cuda(lambda: lpc.flac_lpc_launch(*targs, perm, out), reps)
    plan_ms = time_cuda(
        lambda: lpc.lpc_plan_cuda(targs[1], targs[2], targs[4], B), reps)
    return ms, kernel_ms, plan_ms, time_host(lambda: lpc.flac_lpc(*targs))


def check_lpc(targs):
    """K1 against its twin on these lanes, bit for bit.  Returns (the
    kernel's output, the twin's time in ms)."""
    import torch
    from audio_formats_torch.ops import lpc

    got = lpc.flac_lpc(*targs)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(lpc.flac_lpc_torch(*targs)), 1)
    err = int((got.to(torch.int64) - want[0].to(torch.int64)).abs().max())
    if not torch.equal(got, want[0]):
        raise AssertionError(f"LPC kernel != twin: max abs err {err}")
    return got, plain_ms


def phase_kernel(card, L=L_KERNEL, B=B_KERNEL, n_sig=256):
    """K1 on random lanes (every order, shift and kind; the window PRs 1-3
    timed), bit-equal to the twin, and to the int64 host oracle on the
    signal lanes."""
    import torch
    from audio_formats_torch.ops import lpc

    rng = np.random.default_rng(2024)
    args, sig = kernel_lanes(rng, L, B, n_sig)
    dev = torch.device("cuda")
    targs = [torch.from_numpy(a).to(dev) for a in args]
    got, plain_ms = check_lpc(targs)
    sub = got[:n_sig].cpu().numpy()
    # drflac stores the exact sum's sample into int32
    oracle = lpc.flac_lpc_np(*(a[:n_sig] for a in args[:4])).astype(np.int32)
    if not (np.array_equal(sub, oracle) and np.array_equal(sub, sig)):
        raise AssertionError("LPC kernel != int64 host oracle on the "
                             "signal lanes")
    ms, kernel_ms, plan_ms, host_ms = time_lpc(targs)
    b = bound(*lpc_work(targs))
    print(f"# kernel flac_lpc, random lanes L={L} B={B}: bit-equal to the "
          f"twin on all lanes, to the int64 oracle on {n_sig}; wrapper "
          f"{ms:.4f} ms (its host enqueue {host_ms:.4f} ms), kernel alone "
          f"{kernel_ms:.4f} ms, plan {plan_ms:.4f} ms, twin "
          f"{plain_ms:.1f} ms; bound_ms "
          f"{b['bound_ms']:.4f} ({b['bound_by']}), share "
          f"{b['bound_ms'] / ms:.3f} [{card}]")
    return {"random_ms": ms, "random_kernel_ms": kernel_ms,
            "random_bound_ms": b["bound_ms"], "random_plain_ms": plain_ms}


def phase_flac_kernel(card, targs):
    """K1 at the FLAC slice's own window (the arguments of the slice's
    first flac_lpc call), bit-equal to the twin, timed."""
    from audio_formats_torch.ops import lpc

    L, B = targs[0].shape
    _, plain_ms = check_lpc(targs)
    ms, kernel_ms, plan_ms, host_ms = time_lpc(targs)
    nbytes, macs = lpc_work(targs)
    b = bound(nbytes, macs)
    kinds = np.bincount(lpc.lpc_lane_key(targs[1], targs[2], targs[4], B)
                        .cpu().numpy(), minlength=11)
    print(f"# kernel flac_lpc, the FLAC slice's first window L={L} B={B} "
          f"(lanes by kind {kinds.tolist()}, {macs} multiply-adds): "
          f"bit-equal to the twin; wrapper {ms:.4f} ms, kernel alone "
          f"{kernel_ms:.4f} ms, plan {plan_ms:.4f} ms, host enqueue "
          f"{host_ms:.4f} ms, twin "
          f"{plain_ms:.1f} ms; bound_ms {b['bound_ms']:.4f} "
          f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f} [{card}]")
    return {"max_abs_err": 0, "ms": ms, "kernel_ms": kernel_ms,
            "plan_ms": plan_ms, "host_ms": host_ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "share": b["bound_ms"] / ms}


RICE_KEYS = ("residual", "coeffs", "order", "shift", "wasted", "sub_bps",
             "err", "end_bits")


def rice_work(args, out):
    """(bytes, int32 operations) of K4 on these lanes: the frame bits the
    lanes consume (first subframe to end cursor) and the lane arrays in,
    every output written once; RICE_STEP_OPS a residual sample of a
    predicted subframe (bs - order of them; the corpus has no verbatim
    subframes)."""
    import torch

    sb = args[1]
    consumed = int((out["end_bits"].to(torch.int64) - sb.to(torch.int64))
                   .clamp(min=0).sum()) // 8
    nbytes = consumed + 4 * sb.numel() * 4 + sum(
        out[k].numel() * out[k].element_size() for k in RICE_KEYS)
    bs = args[2].to(torch.int64)[:, None]
    samples = int((bs - out["order"].to(torch.int64)).clamp(min=0).sum())
    return nbytes, samples * RICE_STEP_OPS, samples


def check_rice(full):
    """K4 against its twin on the card at these arguments, every output bit
    for bit.  Returns (K4's output, the twin's time in ms)."""
    import torch
    from audio_formats_torch.ops import flac_rice

    got = flac_rice.flac_frame_entropy(*full)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(
        lambda: want.append(flac_rice.flac_frame_entropy_torch(*full)), 1)
    for k in RICE_KEYS:
        if not torch.equal(got[k], want[0][k]):
            a, b = got[k].to(torch.int64), want[0][k].to(torch.int64)
            raise AssertionError(f"frame entropy kernel != twin on {k}: "
                                 f"{int((a != b).sum())} elements differ")
    return got, plain_ms


def phase_rice_kernel(card, kept):
    """K4 at the Rice slice's own first dispatch (its arguments kept by
    wrapping ops.flac_rice.flac_frame_entropy during the slice), bit-equal
    to the twin, timed through its wrapper and alone beside its bound; the
    torch pool gather of that dispatch timed; then K4 on the same dispatch
    with its pool damaged (bit flips and zeroed runs), bit-equal again."""
    import torch
    from audio_formats_torch.ops import flac_rice

    args, kw = kept["flac_frame_entropy"]
    full = list(args) + [kw[k] for k in ("L", "NSAMP", "nch", "NPOOL")]
    blocks, sb, bs, bps0, chass, L, NSAMP, nch, NPOOL = full
    got, plain_ms = check_rice(full)
    for _ in range(3):
        flac_rice.flac_frame_entropy(*full)
    ms = time_cuda(lambda: flac_rice.flac_frame_entropy(*full), 20)
    out = flac_rice.rice_outputs(L, NSAMP, nch, blocks.device)
    kernel_ms = time_cuda(lambda: flac_rice.rice_launch(
        blocks, sb, bs, bps0, chass, NSAMP, nch, out), 20)
    host_ms = time_host(lambda: flac_rice.flac_frame_entropy(*full))
    # the first 32 lanes alone, one warp: the time of one lane chain with
    # the card otherwise idle
    few = [a[:32].contiguous() for a in (sb, bs, bps0, chass)]
    out32 = flac_rice.rice_outputs(32, NSAMP, nch, blocks.device)
    warp_ms = time_cuda(lambda: flac_rice.rice_launch(
        blocks, *few, NSAMP, nch, out32), 5)
    gargs, gkw = kept["gather_frame_pool"]
    gather_ms = time_cuda(
        lambda: flac_rice.gather_frame_pool(*gargs, **gkw), 20)
    nbytes, ops, samples = rice_work(full, got)
    b = bound(nbytes, ops)
    print(f"# kernel flac_rice, the FLAC Rice slice's first dispatch L={L} "
          f"nch={nch} NSAMP={NSAMP} NPOOL={NPOOL} ({samples} Rice samples, "
          f"{nbytes / 1e6:.1f} MB): bit-equal to the twin on every output; "
          f"wrapper {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms (its "
          f"first 32 lanes alone, one warp: {warp_ms:.4f} ms), host "
          f"enqueue {host_ms:.4f} ms, twin {plain_ms:.1f} ms; bound_ms "
          f"{b['bound_ms']:.4f} ({b['bound_by']}), share "
          f"{b['bound_ms'] / ms:.3f}; its pool gather (torch ops) "
          f"{gather_ms:.4f} ms [{card}]")
    del got, out, out32
    # the same dispatch with a damaged pool: flipped bits in 1 word of
    # 500 and a zeroed 64-word run in 1 block of 50
    rng = np.random.default_rng(4)
    bad = blocks.clone().view(-1)
    live = (NPOOL - 2) * 64
    idx = torch.from_numpy(rng.integers(0, live, live // 500)).to(bad.device)
    bad[idx] ^= torch.from_numpy(rng.integers(1, 1 << 31, idx.numel(),
                                              dtype=np.int64)
                                 .astype(np.int32)).to(bad.device)
    for blk in rng.integers(0, NPOOL - 2, (NPOOL - 2) // 50).tolist():
        bad[blk * 64: blk * 64 + 64] = 0
    cfull = [bad.view(NPOOL, 64)] + full[1:]
    cgot, cplain_ms = check_rice(cfull)
    n_err = int(cgot["err"].sum())
    print(f"# kernel flac_rice, that dispatch with its pool damaged: "
          f"bit-equal to the twin on every output, {n_err} of {L} lanes "
          f"flagged, twin {cplain_ms:.1f} ms [{card}]")
    return {"max_abs_err": 0, "ms": ms, "kernel_ms": kernel_ms,
            "host_ms": host_ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "share": b["bound_ms"] / ms,
            "one_warp_ms": warp_ms, "gather_ms": gather_ms,
            "corrupt_lanes_flagged": n_err}


def qoa_encode_work(samples, flen):
    """(bytes, int32 operations) of K5 on these lanes: the samples, the
    states in, the slice words and the states out; 16 candidates run each
    sample of a frame."""
    L = samples.shape[0]
    return (samples.numel() * samples.element_size() + L * 32
            + L * 256 * 8 + L * 32,
            int(flen.clamp(0, QOA_FRAME).sum()) * 16 * QOA_ENC_OPS)


def qoa_kernel_inputs():
    """The QOA kernels' random inputs, numpy, from one seed.  Decode, one
    full window: history, weights (some lanes int32-range), int8
    scalefactors and codes.  Encode, one full chunk: full-scale squares
    (qoa_div's int32 product overflows), noise and tones; frame lengths
    around slice edges; carried and int32-range starting states."""
    from audio_formats_torch.ops import lms

    rng = np.random.default_rng(2025)
    L, S = L_QOA_DECODE, QOA_FRAME // 20
    history = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    weights = rng.integers(-(1 << 15), 1 << 15, (L, 4)).astype(np.int32)
    wild = rng.random(L) < 0.05
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (int(wild.sum()), 4))
    sf = rng.integers(0, 16, (L, S)).astype(np.int8)
    codes = rng.integers(0, 8, (L, S, 20)).astype(np.int8)
    decode = (history, weights, sf, codes)

    L = L_QOA_ENCODE
    t = np.arange(QOA_FRAME)
    kind = (np.arange(L) % 4)[:, None]
    square = np.where((t // rng.integers(2, 400, (L, 1))) % 2, 32767, -32768)
    noise = rng.integers(-32768, 32768, (L, QOA_FRAME))
    tone = (rng.uniform(1000, 30000, (L, 1))
            * np.sin(2 * np.pi * rng.uniform(20, 2000, (L, 1)) * t / SR)
            + rng.normal(0, 200, (L, QOA_FRAME)))
    x = np.clip(np.round(np.select([kind == 0, kind == 1], [square, noise],
                                   tone)), -32768, 32767)
    flen = np.full(L, QOA_FRAME, np.int32)
    flen[:7] = [0, 1, 19, 20, 21, 5119, 5120]
    short = rng.random(L) < 0.1
    short[:7] = False
    flen[short] = rng.integers(0, QOA_FRAME + 1, int(short.sum()))
    x = (x * (t[None, :] < flen[:, None])).astype(np.int16)
    history = np.zeros((L, 4), np.int32)
    weights = np.tile(lms.INITIAL_WEIGHTS, (L, 1))
    carried = rng.random(L) < 0.25
    history[carried] = rng.integers(-32768, 32768, (int(carried.sum()), 4))
    weights[carried] = rng.integers(-32768, 32768, (int(carried.sum()), 4))
    wild = rng.random(L) < 0.02
    weights[wild] = rng.integers(-(1 << 31), 1 << 31, (int(wild.sum()), 4))
    return decode, (x, history, weights, flen)


def check_time_qoa_encode(args, label):
    """K5 on these arguments (samples, history, weights, frame_len on the
    card) against its twin, bit for bit: scalefactors, codes and the
    carried state through qoa_encode_frame_scan, and the word plane of the
    launch alone; then the launch alone timed.  Returns (ms, twin ms)."""
    import torch
    from audio_formats_torch.ops import lms

    got = lms.qoa_encode_frame_scan(*args)
    words = lms.qoa_encode_cuda(*args)[0]
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(
        lambda: want.append(lms.qoa_encode_frame_torch(*args)), 1)
    if not all(torch.equal(g, v) for g, v in zip(got, want[0])) or \
            not torch.equal(words, lms.pack_words(*want[0][:2])):
        raise AssertionError(f"QOA encode kernel != twin at the {label}")
    for _ in range(3):
        lms.qoa_encode_cuda(*args)
    return time_cuda(lambda: lms.qoa_encode_cuda(*args), 20), plain_ms


def qoa_decode_bound(sf, codes):
    """bound() of K2's fused form on these lanes: scalefactors and codes
    in, history and weights in, samples out; LMS_STEP_OPS a step."""
    L, S = sf.shape
    T = S * 20
    return bound(sf.numel() + codes.numel() + 2 * L * 16 + L * T * 4,
                 L * T * LMS_STEP_OPS)


def check_time_qoa_decode(args, label):
    """K2's fused form on these arguments (history, weights, int8
    scalefactors and codes on the card) against its twin, bit for bit;
    then timed through its wrapper (decode_slices), alone (a launch into a
    pre-made output) and by its host enqueue.  Returns (the kernel's
    output, the dequantized residuals, the twin's output, {times, bound,
    share})."""
    import torch
    from audio_formats_torch.ops import lms

    h, w, sf, codes = args
    L = sf.shape[0]
    tab = torch.from_numpy(lms.DEQUANT_TAB).to(sf.device)
    deq = tab[sf.long()[..., None], codes.long()].reshape(L, -1).contiguous()
    got = lms.decode_slices(*args)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(lms.qoa_decode_torch(h, w, deq)),
                         1)
    if not torch.equal(got, want[0]):
        err = int((got.long() - want[0].long()).abs().max())
        raise AssertionError(f"QOA decode kernel != twin at the {label}: "
                             f"max abs err {err}")
    # ~15 ms of launches first: after the twin's small kernels the card's
    # clock takes that long to come back up
    for _ in range(100):
        lms.decode_slices(*args)
    ms = time_cuda(lambda: lms.decode_slices(*args), 20)
    out = torch.empty_like(got)
    kernel_ms = time_cuda(
        lambda: lms.qoa_decode_launch(h, w, out, scalefactors=sf, codes=codes),
        20)
    host_ms = time_host(lambda: lms.decode_slices(*args))
    b = qoa_decode_bound(sf, codes)
    return got, deq, want[0], {
        "ms": ms, "kernel_ms": kernel_ms, "host_ms": host_ms,
        "plain_ms": plain_ms, **b, "share": b["bound_ms"] / ms}


def phase_qoa_decode_kernel(card, captured):
    """K2 at the QOA decode slice's first window and at its last (tail)
    window: bit-equal to the twin, timed, beside its bound."""
    out = {}
    for label, args in (("slice_first", captured[0]),
                        ("slice_tail", captured[-1])):
        L = args[0].shape[0]
        r = check_time_qoa_decode(args, f"QOA decode slice's {label} "
                                  "window")[3]
        print(f"# kernel qoa_decode, the QOA decode slice's {label} window "
              f"L={L}: bit-equal to the twin; wrapper {r['ms']:.4f} ms (its "
              f"host enqueue {r['host_ms']:.4f} ms), kernel alone "
              f"{r['kernel_ms']:.4f} ms, twin {r['plain_ms']:.1f} ms; "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share "
              f"{r['share']:.3f} [{card}]")
        out.update({f"{label}_L": L, f"{label}_ms": r["ms"],
                    f"{label}_kernel_ms": r["kernel_ms"],
                    f"{label}_plain_ms": r["plain_ms"],
                    f"{label}_bound_ms": r["bound_ms"],
                    f"{label}_share": r["share"]})
    return out


def phase_qoa_kernels(card):
    """The QOA decode kernel (both forms) at one full window and the encode
    search at one full chunk, each against its twin, bit for bit; the
    encode kernel's quantizer on every int32 residual."""
    import torch
    from audio_formats_torch.ops import lms

    dev = torch.device("cuda")
    dec_in, enc_in = qoa_kernel_inputs()
    L = L_QOA_DECODE
    args = [torch.from_numpy(a).to(dev) for a in dec_in]
    h, w, _, _ = args
    fused, deq, want, dres = check_time_qoa_decode(args, "random window")
    plain = lms.qoa_decode(h, w, deq)
    torch.cuda.synchronize()
    dec_err = int((plain.long() - want.long()).abs().max())
    if not torch.equal(plain, want):
        raise AssertionError(f"QOA decode kernel, int32 form != twin: max "
                             f"abs err {dec_err}")
    for _ in range(3):
        lms.qoa_decode(h, w, deq)
    dres["int32_ms"] = time_cuda(lambda: lms.qoa_decode(h, w, deq), 20)
    print(f"# kernel qoa_decode L={L} T={QOA_FRAME}: both forms bit-equal to "
          f"the twin; int8 sf/codes: wrapper {dres['ms']:.4f} ms (its host "
          f"enqueue {dres['host_ms']:.4f} ms), kernel alone "
          f"{dres['kernel_ms']:.4f} ms; int32 residuals "
          f"{dres['int32_ms']:.4f} ms; twin {dres['plain_ms']:.1f} ms; "
          f"bound_ms {dres['bound_ms']:.4f} ({dres['bound_by']}), share "
          f"{dres['share']:.3f} (kernel alone "
          f"{dres['bound_ms'] / dres['kernel_ms']:.3f}) [{card}]")
    del args, fused, deq, want, plain

    L = L_QOA_ENCODE
    args = [torch.from_numpy(a).to(dev) for a in enc_in]
    enc_ms, enc_plain_ms = check_time_qoa_encode(args, "random chunk")
    enc_b = bound(*qoa_encode_work(args[0], args[3]))
    print(f"# kernel qoa_encode L={L} T={QOA_FRAME}: words, scalefactors, "
          f"codes, history' and weights' equal to the twin; kernel "
          f"{enc_ms:.4f} ms, twin {enc_plain_ms:.1f} ms; bound_ms "
          f"{enc_b['bound_ms']:.4f} ({enc_b['bound_by']}), share "
          f"{enc_b['bound_ms'] / enc_ms:.3f} [{card}]")
    # the quantizer on every int32 residual, each scalefactor
    t0 = time.perf_counter()
    bad = lms.qoa_quant_mismatches(dev).tolist()
    sweep_s = time.perf_counter() - t0
    if any(bad):
        raise AssertionError(f"QOA encode quantizer != its direct form: "
                             f"mismatches by scalefactor {bad}")
    print(f"# qoa_encode quantizer: equal to its direct form on all 2^32 "
          f"int32 residuals for each of the 16 scalefactors (mismatches "
          f"{bad}), sweep {sweep_s:.2f} s [{card}]")
    return ({"max_abs_err": dec_err, **dres, "library_ms": None},
            {"max_abs_err": 0, "ms": enc_ms, "plain_ms": enc_plain_ms,
             **enc_b, "library_ms": None,
             "share": enc_b["bound_ms"] / enc_ms})


#: the launch counters of the decode kernels: (key, module, counter)
DECODE_COUNTERS = (
    ("flac_lpc", "lpc", "KERNEL_LAUNCHES"),
    ("qoa_decode", "lms", "DECODE_LAUNCHES"),
    ("mp3_huff", "mp3_huff", "HUFF_LAUNCHES"),
    ("mp3_dsp", "mp3_dsp", "DSP_LAUNCHES"),
    ("mp3_synth", "mp3_dsp", "SYNTH_LAUNCHES"),
    ("flac_rice", "flac_rice", "RICE_LAUNCHES"),
    ("pcm", "pcm", "DECODE_LAUNCHES"),
    ("vorbis_win", "vorbis_win", "WIN_LAUNCHES"),
    ("celt_ola", "celt_dsp", "OLA_LAUNCHES"),
    ("celt_imdct_ola", "celt_dsp", "IMDCT_OLA_LAUNCHES"),
    ("silk_upsample", "resample", "UPSAMPLE_LAUNCHES"),
    ("celt_deemph", "celt_dsp", "DEEMPH_LAUNCHES"))


def zero_launches():
    """Set every decode kernel's launch count to 0."""
    import importlib

    for _, mod, name in DECODE_COUNTERS:
        setattr(importlib.import_module("audio_formats_torch.ops." + mod),
                name, 0)


def read_launches():
    """{kernel: launches} of the decode kernels since zero_launches()."""
    import importlib

    return {key: getattr(importlib.import_module(
        "audio_formats_torch.ops." + mod), name)
        for key, mod, name in DECODE_COUNTERS}


def check_window_launches(launches, st, flac_wire):
    """Every FLAC, QOA, MP3 Layer III, WAV and Vorbis window, every Opus
    CELT bucket and every SILK upsample step launches exactly one kernel
    (LPC, LMS, Huffman, PCM, lapped window, one of K12a's two routes, SILK
    upsample), and a FLAC window of the Rice wire the frame entropy kernel
    too; Layer I/II windows are synthesis only, and no decode path runs the
    CELT deemphasis on the card.  Under a mesh each shard's window is one
    window."""
    wbf = st["windows_by_format"]
    want_launches = {"flac_lpc": wbf.get("flac", 0),
                     "qoa_decode": wbf.get("qoa", 0),
                     "mp3_huff": wbf.get("mp3", 0),
                     "mp3_dsp": wbf.get("mp3", 0),
                     "mp3_synth": wbf.get("mp3", 0),
                     "flac_rice": wbf.get("flac", 0)
                     if flac_wire == "rice" else 0,
                     "pcm": wbf.get("wav", 0),
                     "vorbis_win": wbf.get("vorbis", 0),
                     "celt_ola": wbf.get("opus", 0),
                     "silk_upsample": wbf.get("opus_silk", 0),
                     "celt_deemph": 0}
    got = dict(launches)
    got["celt_ola"] += got.pop("celt_imdct_ola")
    if got != want_launches:
        raise AssertionError(f"kernel launches {launches} != windows "
                             f"{wbf}")


def decode_run(streams, device, flac_wire="packed", mesh=None):
    """Run the main path on `streams` (FLAC over `flac_wire`; with `mesh`,
    sharded over it) through decode_all(output="device") and .sync(): every
    PCM window on the card (under a mesh, on a shard's device), no
    demotion, a kernel launch a window.  The kernel counts are set to 0
    just before the run and read just after.  Returns (decoder, wall
    seconds, launches by kernel, output as numpy)."""
    import torch
    from audio_formats_torch import BatchDecoder

    dec = BatchDecoder(streams, device=device, flac_wire=flac_wire,
                       mesh=mesh)
    zero_launches()
    t0 = time.perf_counter()
    res = dec.decode_all(output="device")
    res.sync()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = dec.stats
    want_dev = {torch.device(device).type} if mesh is None else \
        set(mesh.data_devices)
    for _, wins in res.windows():
        for w in wins:
            if (w.device.type if mesh is None else w.device) not in want_dev:
                raise AssertionError(f"a PCM window lies on {w.device}")
    if st["group_demotions"] or st.get("lanes_demoted"):
        raise AssertionError(f"demotions: {st.get('group_exceptions')}")
    check_window_launches(launches, st, flac_wire)
    return dec, wall, launches, res.to_numpy()


def decode_checked(streams, expect, device, corrupt=(), tol=0.0,
                   flac_wire="packed", rel=False, mesh=None):
    """decode_run, then every good lane held to `expect(i)`, its PCM: bit
    for bit, or within max abs `tol` (with `rel`, `tol` times the expected
    PCM's peak).  Returns (decoder, wall seconds, launches by kernel,
    output, the largest error seen, over the peak with `rel`)."""
    dec, wall, launches, out = decode_run(streams, device, flac_wire, mesh)
    max_err = 0.0
    for i in range(len(streams)):
        if i in corrupt:
            if out[i] is not None and not np.isfinite(out[i]).all():
                raise AssertionError(f"corrupt lane {i}: non-finite PCM")
            continue
        if dec.errors[i] is not None:
            raise AssertionError(f"lane {i}: {dec.errors[i]}")
        want = expect(i)
        got = out[i]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"lane {i}: PCM {got.shape}, want "
                                 f"{want.shape}")
        err = float(np.abs(got - want).max()) if got.size else 0.0
        if rel:
            err /= float(np.abs(want).max()) + 1e-12
        max_err = max(max_err, err)
        if not err <= tol:
            raise AssertionError(f"lane {i} differs from its expected PCM: "
                                 f"max abs err {err}")
    return dec, wall, launches, out, max_err


def phase_qoa_encode(card, masters):
    """encode_qoa_batch over the masters on the card (the frame-parallel
    main path), checked against the golden encoder frame by frame, and the
    sequential layout against the streaming encoder.  The arguments of
    each chunk's qoa_encode_frame_words call are kept (wrapping it here
    costs the run nothing).  Returns (streams, launches, the chunks'
    (samples, frame_len))."""
    from golden import qoa_ref

    from audio_formats_torch import encode_qoa_batch
    from audio_formats_torch.config import EncodingOptions
    from audio_formats_torch.io.source import ByteSink
    from audio_formats_torch.models.qoa import QoaEncoder
    from audio_formats_torch.ops import lms

    st = {}
    captured = []
    words_fn = lms.qoa_encode_frame_words

    def keep_args(samples, frame_len):
        captured.append((samples, frame_len))
        return words_fn(samples, frame_len)

    lms.qoa_encode_frame_words = keep_args
    try:
        lms.ENCODE_LAUNCHES = 0
        t0 = time.perf_counter()
        streams = encode_qoa_batch(masters, SR, device="cuda", stats=st)
        wall = time.perf_counter() - t0
        launches = lms.ENCODE_LAUNCHES
    finally:
        lms.qoa_encode_frame_words = words_fn
    if launches != st["windows"]:
        raise AssertionError(f"QOA encode launches {launches} != windows "
                             f"{st['windows']}")
    # under the frame-parallel layout every frame is a fresh stream's first
    # frame: the golden encoder of that frame's samples alone gives it
    n_frames = -(-masters[0].shape[0] // QOA_FRAME)
    for mi, k in ((0, 0), (1, 0), (2, n_frames // 2), (3, n_frames - 1)):
        s16 = qoa_s16(masters[mi])[k * QOA_FRAME: (k + 1) * QOA_FRAME]
        gold = qoa_ref.encode(s16, SR)[8:]
        off = 8 + k * qoa_frame_bytes(2)
        if streams[mi][off: off + len(gold)] != gold:
            raise AssertionError(f"QOA master {mi} frame {k} != golden")
    for m, data in zip(masters, streams):
        n = m.shape[0]
        size = 8 + (n // QOA_FRAME) * qoa_frame_bytes(2) + \
            (qoa_frame_bytes(2, n % QOA_FRAME) if n % QOA_FRAME else 0)
        if len(data) != size or data[:8] != ((0x716F6166 << 32) | n)\
                .to_bytes(8, "big"):
            raise AssertionError("QOA stream framing")
    seq = encode_qoa_batch(masters[:4], SR, parallel_frames=False,
                           device="cuda")
    for m, data in zip(masters[:4], seq):
        sink = ByteSink()
        enc = QoaEncoder(sink, SR, 2, EncodingOptions(), device="cuda")
        enc.write(m)
        enc.finalize()
        if sink.getvalue() != data:
            raise AssertionError("sequential QOA batch != QoaEncoder")
    secs = sum(m.shape[0] for m in masters) / SR
    print(f"# QOA encode: {len(masters)} stereo masters, {secs:.1f} s of "
          f"audio in {wall:.3f} s wall = {secs / wall:.1f}x realtime; "
          f"windows {st['windows']}, encode launches {launches}, h2d_bytes "
          f"{st['h2d_bytes']}, d2h_bytes {st['d2h_bytes']}; 4 frames equal "
          f"to the golden encoder, sequential layout on 4 masters equal to "
          f"QoaEncoder [{card}]")
    return streams, launches, captured


def qoa_chunk_args(samples, flen):
    """K5's arguments at one chunk of the encode slice: the chunk's samples
    and frame lengths, and the encoder's initial state."""
    import torch
    from audio_formats_torch.ops import lms

    L = samples.shape[0]
    h0 = torch.zeros((L, 4), dtype=torch.int32, device=samples.device)
    w0 = torch.from_numpy(np.tile(lms.INITIAL_WEIGHTS, (L, 1))).to(
        samples.device)
    return samples, h0, w0, flen


def phase_qoa_encode_kernel(card, captured):
    """K5 at the QOA encode slice's first (full) chunk and at its last
    (tail) chunk: bit-equal to the twin, timed alone, beside its bound."""
    import torch
    from audio_formats_torch.ops import lms

    out = {}
    for label, (samples, flen) in (("slice_full", captured[0]),
                                   ("slice_tail", captured[-1])):
        L = samples.shape[0]
        ms, plain_ms = check_time_qoa_encode(qoa_chunk_args(samples, flen),
                                             f"encode slice's {label} chunk")
        b = bound(*qoa_encode_work(samples, flen))
        print(f"# kernel qoa_encode, the QOA encode slice's {label} chunk "
              f"L={L} ({int(flen.sum())} samples): equal to the twin; kernel "
              f"{ms:.4f} ms, twin {plain_ms:.1f} ms; bound_ms "
              f"{b['bound_ms']:.4f} ({b['bound_by']}), share "
              f"{b['bound_ms'] / ms:.3f} [{card}]")
        out.update({f"{label}_L": L, f"{label}_ms": ms,
                    f"{label}_plain_ms": plain_ms,
                    f"{label}_bound_ms": b["bound_ms"],
                    f"{label}_share": b["bound_ms"] / ms})
    return out


def qoa_lanes(streams):
    """QOA_LANES lanes cut as frame prefixes (10 to all 35 frames) of the
    encoded masters.  Returns (lanes, [(master, samples)])."""
    lanes, info = [], []
    for k in range(QOA_LANES):
        mi = k % len(streams)
        keep = 10 + (k // len(streams) * 7 + mi) % 26
        data, n = qoa_prefix(streams[mi], keep)
        lanes.append(data)
        info.append((mi, n))
    return lanes, info


def phase_qoa_decode(card, masters, streams):
    """The QOA decode slice (decode_checked) against an independent numpy
    decode.  Returns (lanes, [(master, samples)], that decode, launches,
    each window's decode_slices arguments)."""
    from golden import qoa_ref

    from audio_formats_torch.ops import lms

    t0 = time.perf_counter()
    ref = numpy_qoa_decode(streams)
    print(f"# independent numpy decode of {len(streams)} masters: "
          f"{time.perf_counter() - t0:.1f} s")
    for mi, (m, got) in enumerate(zip(masters, ref)):
        src = qoa_s16(m).astype(np.float64)
        snr = 10 * np.log10((src ** 2).mean()
                            / max(((got - src) ** 2).mean(), 1e-12))
        if got.shape != src.shape or snr <= 25.0:
            raise AssertionError(f"QOA master {mi}: SNR {snr:.1f} dB")
    lanes, info = qoa_lanes(streams)
    # keep each window's decode_slices arguments: phase_qoa_decode_kernel
    # times K2 at the slice's own windows (holding them costs the run
    # nothing)
    captured = []
    decode_slices = lms.decode_slices

    def keep_args(*args):
        captured.append(args)
        return decode_slices(*args)

    lms.decode_slices = keep_args
    try:
        dec, wall, launches, out, _ = decode_checked(
            lanes, lambda i: ref[info[i][0]][: info[i][1]].astype(np.float32)
            * F32_RECIP, "cuda")
    finally:
        lms.decode_slices = decode_slices
    if launches["qoa_decode"] != dec.stats["windows"]:
        raise AssertionError(f"QOA decode launches {launches}")
    short = [k for k, (mi, n) in enumerate(info) if n == 10 * QOA_FRAME][:2]
    for k in short:
        gold, _ = qoa_ref.decode(lanes[k])
        if not np.array_equal(out[k], gold.astype(np.float32) * F32_RECIP):
            raise AssertionError(f"QOA lane {k} != golden decoder")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# QOA slice: {len(lanes)} lanes equal to the independent decode "
          f"(lanes {short} also to the golden decoder), every master > 25 "
          f"dB; {secs:.1f} s of audio in {wall:.3f} s wall = "
          f"{secs / wall:.1f}x realtime; h2d_bytes {st['h2d_bytes']}, "
          f"windows {st['windows']}, decode launches "
          f"{launches['qoa_decode']}, host_ms {st['host_ms']:.0f}, "
          f"enqueue_ms {st['enqueue_ms']:.0f} [{card}]")
    return lanes, info, ref, launches["qoa_decode"], captured


# --------------------------------------------------------------- MP3
def mp3_master(seed: int, seconds: float = MP3_SECONDS):
    """One MP3 master by the JAX bench's recipe (bench.py:_mp3_master):
    stereo 44.1 kHz MPEG-1 Layer III, both channels the same spectra —
    tonal, dense and quiet granules in turn, a short-block granule pair
    every ninth — at MP3_GAIN, with no bit reservoir.  Returns (bytes,
    quantized spectra [granules, 576] int16, block types [granules],
    the float64 decode of one channel by mp3_ref.decode_mono)."""
    mp3_ref = golden_mp3_ref()

    rng = np.random.default_rng([13, seed])
    n_gr = max(2, int(seconds * SR / 576) // 2 * 2)
    frames, qs, bts = [], [], []
    for i in range(0, n_gr, 2):
        grs = []
        for g in (i, i + 1):
            q = np.zeros(576, dtype=np.int64)
            kind = (g // 8) % 3
            if kind == 0:  # tonal: few strong partials
                idx = rng.choice(300, size=25, replace=False)
                q[idx] = rng.integers(-60, 61, size=25)
            elif kind == 1:  # dense spectrum
                idx = rng.choice(480, size=90, replace=False)
                q[idx] = rng.integers(-12, 13, size=90)
            else:  # quiet tail
                idx = rng.choice(200, size=12, replace=False)
                q[idx] = rng.integers(-4, 5, size=12)
            gr = {"q": q, "global_gain": MP3_GAIN}
            bt = 2 if (g // 2) % 9 == 4 else 0  # short blocks (transient)
            if bt:
                gr["block_type"] = bt
            grs.append([dict(gr) for _ in range(2)])
            qs.append(q)
            bts.append(bt)
        frames.append(grs)
    data = mp3_ref.build_mp3(frames, channels=2)
    ref = mp3_ref.decode_mono(qs, global_gain=MP3_GAIN, block_types=bts)
    return data, np.array(qs, np.int16), np.array(bts, np.uint8), ref


def mp3_lane_slices(n_frames: int, k: int, n_masters: int):
    """bench.py's slice of lane k: (start frame, end frame)."""
    v = k // n_masters
    start = (v * 211) % max(1, n_frames // 3)
    length = n_frames - start - (v * 53) % max(1, n_frames // 4)
    length = max(40, length)
    return start, min(n_frames, start + length)


def mp3_corpus(masters, n_lanes=MP3_LANES):
    """n_lanes lanes cut as frame slices of the masters (each a distinct
    byte stream that starts mid-master).  The golden encoder writes frames
    of one size.  Returns (streams, [(master, start, end)])."""
    streams, info = [], []
    for k in range(n_lanes):
        mi = k % len(masters)
        data = masters[mi][0]
        h = data[:4]
        kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320][h[2] >> 4]
        fb = 1152 * kbps * 125 // SR
        start, end = mp3_lane_slices(len(data) // fb, k, len(masters))
        streams.append(data[start * fb: end * fb])
        info.append((mi, start, end))
    return streams, info


def mp3_lane_expected(masters, mi, start, end):
    """The PCM of a lane: the lane's own first frame decoded from silence,
    then the master's decode (no reservoir, so from its second frame on a
    lane's state is the master's).  Float64 [frames * 1152, 2]."""
    mp3_ref = golden_mp3_ref()

    _, qs, bts, ref = masters[mi]
    g0 = 2 * start
    first = mp3_ref.decode_mono(list(qs[g0: g0 + 2].astype(np.int64)),
                                global_gain=MP3_GAIN,
                                block_types=[int(b) for b in bts[g0: g0 + 2]])
    mono = np.concatenate([first, ref[(g0 + 2) * 576: 2 * end * 576]])
    return np.stack([mono, mono], axis=1)


def mp3_window_sizes():
    """The frames of the Layer III windows the kernel phases take: the
    batch path's fixed window (parallel/groups/mp3.py's MP3_WINDOW_FRAMES,
    24)
    and the window mp3_window_frames sizes on this card for a call of the
    fma_mp3.b32 cell (32 stereo MPEG-1 clips of 1,148 frames; 576 on 132
    SMs)."""
    import torch
    from audio_formats_torch.parallel.groups import mp3 as mp3_groups

    wave = mp3_groups.mp3_wave_lanes(torch.device("cuda"))
    return mp3_groups.MP3_WINDOW_FRAMES, mp3_groups.mp3_window_frames(
        32 * 4, 1148, wave)


def mp3_window(streams, frames=None):
    """The first window of the MP3 slice as the batch path ships it to the
    Huffman kernel: the C stage parses `frames` frames of every lane (the
    batch path's 24 by default; a lane shorter than that ends inside the
    window); the frames' words pack into one pool, each frame's 4
    granule-channel lanes addressing its words.  Returns (pool int32,
    meta16 [L, 16] int16, row width W, lanes a frame, scfq [L, 40] int16,
    the frames of each stream in the window [B] int32)."""
    from audio_formats_torch.host import native
    from audio_formats_torch.io.source import MemorySource
    from audio_formats_torch.models.mp3 import Mp3Decoder
    from audio_formats_torch.ops import mp3_huff
    from audio_formats_torch.parallel.groups import mp3 as mp3_groups

    F = frames or mp3_groups.MP3_WINDOW_FRAMES
    lib = native.get_lib()
    FW = native.FRAME_WORDS
    G = F * 2
    NL = G * 2
    LPF = NL // F
    B = len(streams)
    bits = np.zeros((B, F, FW), np.uint32)
    meta = np.zeros((B, NL, 16), np.int32)
    scfq = np.zeros((B, NL, 40), np.int16)
    n_fr = np.zeros(B, np.int32)
    mw = 16
    for bi, data in enumerate(streams):
        d = Mp3Decoder(MemorySource(data), device="cpu")
        state = (np.zeros(511, np.uint8), np.zeros(1, np.int32), d._ist_pos)
        n, _, w, _ = native.mp3_parse_window_packed(
            lib, d._view, d._offset, d._hdr0, F, 2, 2, state,
            bits[bi], meta[bi], scfq[bi],
            np.zeros((G, 2), np.int32), np.zeros((G, 2, 32), np.int32),
            np.zeros(F, np.uint8),
            ist=np.zeros((G, 40), np.int16))
        if n != min(F, len(d._index_offsets)):
            raise AssertionError(f"MP3 lane {bi}: {n} frames in a window "
                                 f"of {F}")
        n_fr[bi] = n
        mw = max(mw, w)
    meta16 = mp3_huff.meta16_from_c(meta.reshape(B * NL, 16))
    span = meta16[::LPF, mp3_huff.M_SPAN]
    pool = bits.reshape(B * F, FW)[
        np.arange(FW)[None, :] < span[:, None]]
    return (pool.view(np.int32), meta16, mp3_huff.row_width(mw), LPF,
            scfq.reshape(B * NL, 40), n_fr)


def mp3_read_words(meta16, lpf):
    """The pool words K3's lanes read, frame by frame: the union of each
    lane's words from its bit_start to 3 past its bit_limit (the lookahead
    a codeword's peek takes), cut at its frame's span.  A frame's main data
    beyond that (what the reservoir carries on to later frames, and a
    coder's padding) ships with the pool, but no well-formed lane reads
    it."""
    from audio_formats_torch.ops import mp3_huff

    m = meta16.astype(np.int64).reshape(-1, lpf, 16)
    span = m[:, :1, mp3_huff.M_SPAN]
    start = m[..., mp3_huff.M_BIT_START]
    lo = np.minimum(start >> 5, span)
    hi = np.minimum((np.maximum(start, m[..., mp3_huff.M_BIT_LIMIT]) >> 5)
                    + 3, span)
    order = np.argsort(lo, axis=1, kind="stable")
    lo = np.take_along_axis(lo, order, 1)
    hi = np.take_along_axis(hi, order, 1)
    words = np.zeros(len(m), np.int64)
    reached = np.zeros(len(m), np.int64)
    for k in range(lpf):
        a = np.maximum(lo[:, k], reached)
        words += np.maximum(hi[:, k] - a, 0)
        reached = np.maximum(reached, hi[:, k])
    return int(words.sum())


def mp3_random_lanes(rng, L, W):
    """Random words and side info: spans up to the row width, bit limits
    anywhere up to it, any table, region bounds and sfb pattern, a fifth
    of the lanes near the 288-pair maximum."""
    from audio_formats_torch.ops import mp3_huff

    pats = [p for p in range(48) if mp3_huff._sfb_widths(p)]
    span = rng.integers(0, W - 3, L)
    pool = rng.integers(0, 2 ** 32, int(span.sum()), dtype=np.uint64)\
        .astype(np.uint32)
    tabs = rng.integers(0, 32, (L, 3))
    meta = np.zeros((L, 16), np.int16)
    meta[:, 0] = rng.integers(0, 8, L)
    meta[:, 1] = meta[:, 0] + rng.integers(0, W * 32, L)
    meta[:, 2] = np.where(rng.random(L) < 0.2, rng.integers(250, 289, L),
                          rng.integers(0, 289, L))
    meta[:, 3] = rng.integers(1, 17, L)
    meta[:, 4] = meta[:, 3] + rng.integers(1, 30, L)
    meta[:, 5:8] = tabs
    meta[:, 8:11] = mp3_huff.LINBITS_TAB[tabs]
    meta[:, 11] = rng.integers(0, 2, L)
    meta[:, 12] = rng.choice(pats, L)
    meta[:, 15] = span
    return pool.view(np.int32), meta


def warp_step_ratio(steps, order=None):
    """What divergence costs K3: the sum over warps of the longest lane's
    steps against the sum of all steps / 32, for the lanes taken in
    `order` (the window's own order when None)."""
    s = np.asarray(steps, np.int64)
    if order is not None:
        s = s[np.asarray(order)]
    s = np.concatenate([s, np.zeros(-s.size % 32, np.int64)])
    return float(s.reshape(-1, 32).max(1).sum() / max(s.sum() / 32, 1))


def divergence(workers=4):
    """CPU only: the step counts of one 98,304-lane window of the MP3
    slice (the twin's count of each lane's big-values pairs and count1
    iterations) and the warp ratio in the window's order, sorted by the
    steps, and in the order the K3 wrapper gives the kernel
    (mp3_huff.huff_lane_perm, from the side info alone).  Prints one
    line."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from audio_formats_torch.ops import mp3_huff

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        masters = list(ex.map(mp3_master, range(MP3_MASTERS)))
    streams, _ = mp3_corpus(masters)
    pool, meta16, W, lpf, _, _ = mp3_window(streams)
    _, _, steps = mp3_huff.huff_decode_steps(
        torch.from_numpy(pool), torch.from_numpy(meta16), W, lpf)
    steps = steps.numpy()
    perm = mp3_huff.huff_lane_perm(torch.from_numpy(meta16)).numpy()
    print(f"# K3 divergence, one MP3 window (L={steps.size}, W={W}): steps "
          f"a lane mean {steps.mean():.1f}, max {steps.max()}; warp max / "
          f"mean: window order {warp_step_ratio(steps):.4f}, sorted by "
          f"steps {warp_step_ratio(steps, np.argsort(steps, kind='stable')):.4f}"
          f", in the wrapper's order {warp_step_ratio(steps, perm):.4f}")


def rice_first_dispatch(streams):
    """The arguments of the FLAC Rice slice's first frame-entropy call,
    from a decode of the streams on the CPU (grouped as on the card)
    stopped at that call."""
    from audio_formats_torch import BatchDecoder
    from audio_formats_torch.ops import _kernels, flac_rice

    class Kept(_kernels.KernelError):
        """raised out of decode_all, never demoted around"""

    kept = []
    fn = flac_rice.flac_frame_entropy

    def keep(*args, **kw):
        kept.append(list(args) + [kw[k] for k in ("L", "NSAMP", "nch",
                                                  "NPOOL")])
        raise Kept

    flac_rice.flac_frame_entropy = keep
    try:
        # output="device": the card's grouping, every lane in one group
        BatchDecoder(streams, device="cpu", flac_wire="rice").decode_all(
            output="device")
    except Kept:
        pass
    finally:
        flac_rice.flac_frame_entropy = fn
    return kept[0]


def rice_paths(blocks, start_bits, bs, bps0, chass, L, NSAMP, nch, NPOOL):
    """The twin's scan (ops.flac_rice.flac_frame_entropy_torch) with the
    path the branching design of K4 (the kernel before the register
    window) took at each lane and output sample t (one thread a
    lane, a sample loop over t, a four-word window at the cursor): the
    branch that leaves the sample undecoded (t past the block size, a
    constant subframe, a warm-up, a stopped scan) or, for a decoded
    sample, the clamp every 8 samples, the partition crossing, raw or
    Rice, the unary count's second word, the window's move after the
    sample (none, one or two words, a reload) and the line prefetch.
    Returns (residual, end_bits, err, [nch x NSAMP int64 [L] path codes]),
    the first three equal to the twin's."""
    import torch
    from audio_formats_torch.ops import flac_rice as R

    blocks, start_bits, bs, bps0, chass = R._lanes(blocks, start_bits, bs,
                                                   bps0, chass)
    words = blocks.reshape(-1).to(torch.int64) & R._M32
    nw = words.shape[0]
    wz = torch.cat([words, torch.zeros(1, dtype=torch.int64)])

    def word(i):
        return wz[torch.where((i >= 0) & (i < nw), i, nw)]

    def top32(p):
        return R._funnel(word(p >> 5), word((p >> 5) + 1), p & 31)

    i64 = torch.int64
    pos = start_bits.to(i64)
    bs = bs.to(i64)
    err = torch.zeros(L, dtype=torch.bool)
    max_pos = (NPOOL - 2) * R.BLK_BITS - 64
    nblk = -(-NSAMP // R.K_SAMP)
    res_all, codes = [], []
    for ci in range(nch):
        # the subframe header, as the twin reads it
        sub_bps = bps0.to(i64) + ((((chass == 8) | (chass == 10)) if ci == 1
                                   else (chass == 9) if ci == 0 else 0))
        hdr = R._take(top32(pos), 8)
        pos = pos + 8
        err = err | ((hdr & 0x80) != 0)
        t = (hdr & 0x7E) >> 1
        uq, q64 = R._unary(top32(pos), top32(pos + 32))
        has_w = (hdr & 1) == 1
        wasted = torch.where(has_w, uq + 1, 0)
        err = err | (has_w & q64) | (wasted >= sub_bps)
        pos = pos + wasted
        sub_bps = (sub_bps - wasted).clamp(min=1)
        is_const, is_verb = t == 0, t == 1
        is_lpc = (t & 0x20) != 0
        is_fixed = ((t & 0x08) != 0) & ~is_lpc
        err = err | ~(is_const | is_verb | is_lpc | is_fixed)
        order = torch.where(is_lpc, (t & 0x1F) + 1,
                            torch.where(is_fixed, t & 0x07, 0))
        err = err | (is_fixed & (order > 4))
        pos = pos + torch.where(is_const, sub_bps, 0)
        has_res = is_lpc | is_fixed
        pos = pos + torch.where(has_res, order * sub_bps, 0)
        prec = R._take(top32(pos), 4)
        err = err | (is_lpc & (prec == 15))
        pos = pos + torch.where(is_lpc, 9 + order * (prec + 1), 0)
        method = R._take(top32(pos), 2)
        err = err | (has_res & (method > 1))
        pbits = torch.where(has_res, torch.where(method == 0, 4, 5), 0)
        escape = (1 << torch.where(method == 0, 4, 5)) - 1
        po = R._take(top32(pos + 2), 4)
        pos = pos + torch.where(has_res, 6, 0)
        base_n = bs >> po
        cnt = base_n - order
        err = err | (has_res & (cnt < 0))
        pr = R._take(top32(pos), pbits)
        pos = pos + pbits
        esc = has_res & (pr == escape)
        nb = R._take(top32(pos), 5)
        pos = pos + torch.where(esc, 5, 0)
        raw = is_verb | esc
        kpar = torch.where(is_verb, sub_bps, torch.where(esc, nb, pr))
        cnt = torch.where(is_verb, bs, cnt)
        wcount = torch.where(has_res, order, 0)
        s_lim = torch.where(is_const | err, 0,
                            torch.where(is_verb, bs, bs - order)).clamp(
            max=nblk * R.K_SAMP)
        # the residual scan in output order, with the branching design's
        # window
        wi = pos >> 5
        s = torch.zeros(L, dtype=i64)
        res = torch.zeros((L, NSAMP), dtype=i64)

        def seek(p, wi, on):
            d = (p >> 5) - wi
            move = torch.where(d == 0, 0, torch.where(d == 1, 1, torch.where(
                d == 2, 2, 3)))
            nwi = torch.where(on & (d != 0), p >> 5, wi)
            pf = on & (d != 0) & ((nwi >> 5) != (wi >> 5))
            return nwi, torch.where(on, move, 0), pf

        for tt in range(NSAMP):
            act = (tt < bs) & ~is_const & (tt >= wcount) & ~err & (s < s_lim)
            code = torch.where(tt >= bs, 1, torch.where(
                is_const, 2, torch.where(tt < wcount, 3, torch.where(
                    act, 0, 4))))
            clamp = act & ((s & (R.K_SAMP - 1)) == 0)
            pos = torch.where(clamp, pos.clamp(0, max_pos), pos)
            wi, mv_c, pf_c = seek(pos, wi, clamp)
            cross = act & (cnt == 0) & (pbits > 0)
            pr = R._take(top32(pos), pbits)
            esc = cross & (pr == escape)
            nb = R._take(top32(pos + pbits), 5)
            pos = pos + torch.where(cross, pbits + torch.where(esc, 5, 0), 0)
            raw = torch.where(cross, esc, raw)
            kpar = torch.where(cross, torch.where(esc, nb, pr), kpar)
            cnt = torch.where(cross, base_n, cnt)
            wi, mv_x, pf_x = seek(pos, wi, cross)
            w1 = top32(pos)
            q, q64 = R._unary(w1, top32(pos + 32))
            err = err | (act & ~raw & q64)
            rem = R._take(top32(pos + q + 1), kpar)
            ui = R._wrap32(((q << (kpar & 31)) & R._M32) | rem)
            v = torch.where(raw, R._sext(R._take(w1, kpar), kpar),
                            (ui >> 1) ^ -(ui & 1))
            pos = pos + torch.where(act, torch.where(raw, kpar,
                                                     q + 1 + kpar), 0)
            cnt = cnt - (act & (pbits > 0)).to(i64)
            wi, mv, pf = seek(pos, wi, act)
            res[:, tt] = torch.where(act, v, 0)
            s = s + act.to(i64)
            # a decoded sample's path: 5 bits of branches, the seeks
            path = (clamp.to(i64) | cross.to(i64) << 1 | raw.to(i64) << 2
                    | ((w1 == 0) & ~raw).to(i64) << 3
                    | (pf | pf_c | pf_x).to(i64) << 4
                    | mv << 5 | mv_c << 7 | mv_x << 9)
            codes.append(torch.where(act, 16 + path, code))
        # samples past NSAMP still move the cursor (none in the slice)
        while bool(((s < s_lim) & ~err).any()):
            act = (s < s_lim) & ~err
            clamp = act & ((s & (R.K_SAMP - 1)) == 0)
            pos = torch.where(clamp, pos.clamp(0, max_pos), pos)
            cross = act & (cnt == 0) & (pbits > 0)
            pr = R._take(top32(pos), pbits)
            esc = cross & (pr == escape)
            nb = R._take(top32(pos + pbits), 5)
            pos = pos + torch.where(cross, pbits + torch.where(esc, 5, 0), 0)
            raw = torch.where(cross, esc, raw)
            kpar = torch.where(cross, torch.where(esc, nb, pr), kpar)
            cnt = torch.where(cross, base_n, cnt)
            q, q64 = R._unary(top32(pos), top32(pos + 32))
            err = err | (act & ~raw & q64)
            pos = pos + torch.where(act, torch.where(raw, kpar,
                                                     q + 1 + kpar), 0)
            cnt = cnt - (act & (pbits > 0)).to(i64)
            s = s + act.to(i64)
        pos = torch.where((s + R.K_SAMP - 1) // R.K_SAMP < nblk,
                          pos.clamp(0, max_pos), pos)
        res_all.append(res)
    return torch.stack(res_all, 1), pos, err, codes


def rice_divergence(workers=8):
    """CPU only: the paths a warp of the branching K4 ran a sample at the FLAC
    Rice slice's first dispatch (rice_paths over its arguments, taken from
    a CPU decode of the slice's corpus), held to the twin on that dispatch.
    Prints one line."""
    import collections

    import torch
    from audio_formats_torch.ops import flac_rice

    streams, _ = build_corpus(workers=workers)
    args = rice_first_dispatch(streams)
    L, NSAMP, nch = args[5], args[6], args[7]
    res, end, err, codes = rice_paths(*args)
    # residual below the warm-ups is the twin's (the warm-ups themselves
    # and constant subframes are not the scan's)
    want = flac_rice.flac_frame_entropy_torch(*args)
    order = want["order"].to(torch.int64)
    scan = torch.arange(NSAMP)[None, None, :] >= order[:, :, None]
    if not (torch.equal(end.to(torch.int32), want["end_bits"])
            and torch.equal(err, want["err"])
            and torch.equal(torch.where(scan, res, 0),
                            torch.where(scan, want["residual"].to(torch.int64),
                                        0))):
        raise AssertionError("rice_paths differs from the twin")
    codes = torch.stack(codes, 1)                  # [L, nch * NSAMP]
    pad = -L % 32
    codes = torch.cat([codes, torch.full((pad, codes.shape[1]), 1)])
    warps = codes.reshape(-1, 32, codes.shape[1]).permute(0, 2, 1)
    distinct, dec_steps, share = [], 0, collections.Counter()
    for w in warps:                                # [steps, 32]
        dec = (w >= 16).any(1)
        srt = w.sort(1).values
        n = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1)
        distinct.append(n[dec])
        dec_steps += int(dec.sum())
        p = w[w >= 16] - 16
        for name, bit in (("clamp", 1), ("crossing", 2), ("raw", 4),
                          ("unary second word", 8), ("prefetch", 16)):
            share[name] += int(((p & bit) != 0).sum())
        for name, code in (("window move 1", 1), ("window move 2", 2),
                           ("window reload", 3)):
            share[name] += int((((p >> 5) & 3) == code).sum())
        share["decoded"] += int(p.numel())
    d = torch.cat(distinct).to(torch.float64)
    n_dec = share.pop("decoded")
    print(f"# K4 divergence (the branching design), the FLAC Rice slice's "
          f"first dispatch (L={L}, nch={nch}, NSAMP={NSAMP}; paths held to "
          f"the twin): distinct paths a warp runs at a decoding sample, mean "
          f"{float(d.mean()):.3f}, max {int(d.max())}, histogram "
          f"{dict(sorted(collections.Counter(d.long().tolist()).items()))}; "
          f"{dec_steps} warp-samples; of {n_dec} decoded lane-samples: "
          + ", ".join(f"{k} {v / n_dec:.4f}" for k, v in share.items()))


def phase_mp3_kernel(card, streams):
    """The Huffman kernel against its twin at one full window of the MP3
    slice (timed: the wrapper, the launch alone, its plan alone, the host's
    enqueue, the twin), on random-bit lanes at two row widths, and at the
    window mp3_window_frames sizes for the fma_mp3.b32 cell's call (the
    slice's first 32 lanes; bit-equal, the launch and its plan timed)."""
    import torch
    from audio_formats_torch.ops import mp3_huff

    dev = torch.device("cuda")
    pool, meta16, W, lpf, _, _ = mp3_window(streams)
    L = meta16.shape[0]
    p_d, m_d = (torch.from_numpy(a).to(dev) for a in (pool, meta16))
    # the kernel's q comes from torch.empty: hand it a block of -7s, so a
    # position the kernel does not write shows in the comparison
    torch.full((L, 576), -7, dtype=torch.int32, device=dev)
    q, err = mp3_huff.huff_decode(p_d, m_d, W, lpf)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(
        lambda: want.append(mp3_huff.huff_decode_steps(p_d, m_d, W, lpf)), 1)
    qt, errt, steps = want[0]
    max_err = int((q.long() - qt.long()).abs().max())
    if not (torch.equal(q, qt) and torch.equal(err, errt)):
        raise AssertionError(f"MP3 Huffman kernel != twin on the corpus "
                             f"window: max abs err {max_err}")
    nz = int((q != 0).sum())
    rng = np.random.default_rng(2026)
    for Wr in (20, 136):
        pr, mr = (torch.from_numpy(a).to(dev)
                  for a in mp3_random_lanes(rng, 16384, Wr))
        torch.full((16384, 576), -7, dtype=torch.int32, device=dev)
        qr, er = mp3_huff.huff_decode(pr, mr, Wr, 1)
        qrt, ert = mp3_huff.huff_decode_torch(pr, mr, Wr, 1)
        e = int((qr.long() - qrt.long()).abs().max())
        max_err = max(max_err, e)
        if not (torch.equal(qr, qrt) and torch.equal(er, ert)):
            raise AssertionError(f"MP3 Huffman kernel != twin on random "
                                 f"lanes at W={Wr}: max abs err {e}")
    for _ in range(3):
        mp3_huff.huff_decode(p_d, m_d, W, lpf)
    ms = time_cuda(lambda: mp3_huff.huff_decode(p_d, m_d, W, lpf), 20)

    offs, perm = mp3_huff.huff_plan_cuda(m_d, lpf)
    if not (torch.equal(perm, mp3_huff.huff_lane_perm(m_d)) and torch.equal(
            offs, mp3_huff._lane_offsets(m_d[:, mp3_huff.M_SPAN], lpf)
            .to(torch.int32))):
        raise AssertionError("MP3 Huffman plan != its twins")
    q2 = torch.empty_like(q)
    e2 = torch.empty_like(err)
    kernel_ms = time_cuda(
        lambda: mp3_huff.huff_launch(p_d, m_d, W, offs, perm, q2, e2), 20)
    plan_ms = time_cuda(lambda: mp3_huff.huff_plan_cuda(m_d, lpf), 20)
    host_ms = time_host(lambda: mp3_huff.huff_decode(p_d, m_d, W, lpf))
    steps_np = steps.cpu().numpy()
    ratio = warp_step_ratio(steps_np)
    ratio_perm = warp_step_ratio(steps_np, perm.cpu().numpy())
    # q and err out; the pool words the lanes read and meta in
    read = mp3_read_words(meta16, lpf)
    b = bound(L * 576 * 4 + L + read * 4 + L * 32,
              int(steps_np.sum()) * HUFF_STEP_OPS)
    print(f"# kernel mp3_huff L={L} W={W} (one MP3 window, {pool.size} pool "
          f"words ({pool.size * 4} bytes, each frame's main data once, "
          f"{lpf} lanes a frame; the lanes read {read} of them, "
          f"{read * 4} bytes, the bound's), {nz} nonzero q, "
          f"{int(steps_np.sum())} "
          f"steps, warp max / "
          f"mean {ratio:.4f} in the window's order, {ratio_perm:.4f} in the "
          f"wrapper's): bit-equal to the twin, and on 2 x 16,384 random-bit "
          f"lanes at W=20 and 136; wrapper {ms:.4f} ms (its host enqueue "
          f"{host_ms:.4f} ms), kernel alone "
          f"{kernel_ms:.4f} ms, plan (offsets and lane order, equal to "
          f"their twins) {plan_ms:.4f} ms, twin "
          f"{plain_ms:.1f} ms; bound_ms {b['bound_ms']:.4f} "
          f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f} [{card}]")
    del q, err, qt, errt, steps, q2, e2
    cell = phase_mp3_kernel_cell(card, streams)
    return {"max_abs_err": max_err, "ms": ms, "kernel_ms": kernel_ms,
            "plan_ms": plan_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "share": b["bound_ms"] / ms,
            "cell": cell}


def phase_mp3_kernel_cell(card, streams):
    """K3 at the fma_mp3.b32 cell's sized window: the first window of the
    MP3 slice's first 32 lanes at mp3_window_frames' size (lanes shorter
    than the window end inside it), bit-equal to the twin; the launch
    alone and its plan timed, beside the bound."""
    import torch
    from audio_formats_torch.ops import mp3_huff

    dev = torch.device("cuda")
    _, frames = mp3_window_sizes()
    pool, meta16, W, lpf, _, n_fr = mp3_window(streams[:32], frames)
    L = meta16.shape[0]
    p_d, m_d = (torch.from_numpy(a).to(dev) for a in (pool, meta16))
    torch.full((L, 576), -7, dtype=torch.int32, device=dev)
    q, err = mp3_huff.huff_decode(p_d, m_d, W, lpf)
    qt, errt, steps = mp3_huff.huff_decode_steps(p_d, m_d, W, lpf)
    if not (torch.equal(q, qt) and torch.equal(err, errt)):
        e = int((q.long() - qt.long()).abs().max())
        raise AssertionError(f"MP3 Huffman kernel != twin at the cell's "
                             f"window of {frames} frames: max abs err {e}")
    offs, perm = mp3_huff.huff_plan_cuda(m_d, lpf)
    q2 = torch.empty_like(q)
    e2 = torch.empty_like(err)
    kernel_ms = time_cuda(
        lambda: mp3_huff.huff_launch(p_d, m_d, W, offs, perm, q2, e2), 20)
    plan_ms = time_cuda(lambda: mp3_huff.huff_plan_cuda(m_d, lpf), 20)
    read = mp3_read_words(meta16, lpf)
    n_steps = int(steps.sum())
    b = bound(L * 576 * 4 + L + read * 4 + L * 32, n_steps * HUFF_STEP_OPS)
    share = b["bound_ms"] / (kernel_ms + plan_ms)
    print(f"# kernel mp3_huff at the fma_mp3.b32 cell's window: 32 lanes x "
          f"{frames} frames (L={L}, {L // 256 + (L % 256 > 0)} blocks; "
          f"lanes of {n_fr.min()}-{n_fr.max()} frames in it), W={W}, "
          f"{n_steps} steps: bit-equal to the twin; kernel alone "
          f"{kernel_ms:.4f} ms, plan {plan_ms:.4f} ms; bound_ms "
          f"{b['bound_ms']:.4f} ({b['bound_by']}), share of the launch and "
          f"its plan {share:.3f} [{card}]")
    return {"frames": frames, "L": L, "kernel_ms": kernel_ms,
            "plan_ms": plan_ms, **b, "share": share}


#: K14 and K15 at the 24-frame window of 32 clips and of 4x their lanes,
#: and at the benchmark cell's sized window (fma_mp3.b32: 32 clips,
#: mp3_window_frames); the share of granules coded mid/side there (the
#: masters are LR)
MP3_DSP_LANES = (32, 128)
MP3_DSP_MS = 0.7
K14_TOL = 1e-5        # of the peak: K14 and K15 against the twin
K15_TOL = 1e-5        # of the peak: K15 against the Toeplitz product
#: float32 operations of K15 a granule-channel, none fused: the DCT of 33
#: slots (296 adds, subtracts and multiplies each, as dct32 writes them)
#: and 576 samples of 16 products and 15 sums
SYNTH_F32_OPS = 33 * 296 + 576 * 31


def mp3_dsp_work(B, G, nch):
    """(bytes, multiply-adds) of K14 on a window: q, meta16, scfq, n_act
    and the carried state read once, the synthesis operand and the new
    state written once; 648 IMDCT multiply-adds (18 x 36) a band of each
    granule-channel."""
    L = B * G * nch
    state = B * nch * (32 * 18 + 16 * 32) * 4
    return (L * (576 * 4 + 16 * 2 + 40 * 2 + 1088 * 4) + B * 4 + 2 * state,
            L * 32 * 18 * 36)


def mp3_synth_work(L):
    """(bytes, float32 operations) of K15 on L rows: the 33 slots of a row
    that the synthesis reads (its first slot is SYNTH_FIR's zero tap) read
    once and the PCM written once."""
    return L * (33 * 32 + 576) * 4, L * SYNTH_F32_OPS


def phase_mp3_dsp_kernel(card, streams):
    """K14, the MP3 window kernel, and K15, the synthesis kernel after it,
    at the first 24-frame window of the MP3 slice's first 32 and first 128
    lanes (G 48, stereo) and at the window mp3_window_frames sizes for the
    fma_mp3.b32 cell's call (the first 32 lanes, G twice its frames; a
    lane shorter than the window ends inside it, as n_act says), its
    granules flagged mid/side at the benchmark's share: the port's route
    on the card (K14, then K15) against the twin's chain (spectrum_stage,
    mp3_window_dsp) on the same K3 output, PCM and carried state; K14's
    device time (torch.profiler), its wrapper, the route's, the route
    before K15's (K14, then the Toeplitz product) and the twin's device
    time and kernels a call and their walls, beside K14's bound.  K15 on
    K14's operand: within K15_TOL of its plain version (synth_twin), its
    device time and wrapper beside its bound, the plain version's time and
    the Toeplitz torch.matmul's (library_ms, the call K15 replaced).
    Returns K14's results, K15's under "synth"."""
    import torch
    from audio_formats_torch.ops import mp3_dsp, mp3_huff

    dev = torch.device("cuda")
    toeplitz = mp3_dsp.device_const(mp3_dsp.SYNTH_TOEPLITZ, dev)
    nch = 2
    w24, sized = mp3_window_sizes()
    shapes = [(B, w24) for B in MP3_DSP_LANES] + [(MP3_DSP_LANES[0], sized)]
    res, synth = {}, {}
    for B, frames in shapes:
        G = 2 * frames
        pool, meta16, W, lpf, scfq, n_fr = mp3_window(streams[:B], frames)
        L = meta16.shape[0]
        rng = np.random.default_rng(B)
        ms = np.repeat(rng.random(L // nch) < MP3_DSP_MS, nch)
        meta16[:, mp3_huff.M_STEREO] |= ms.astype(np.int16)
        short = bool(np.isin(meta16[:, mp3_huff.M_PATTERN],
                             mp3_huff.SHORT_PATTERNS).any())
        p_d, m_d, s_d = (torch.from_numpy(a).to(dev)
                         for a in (pool, meta16, scfq))
        n_act = torch.from_numpy(2 * n_fr).to(dev)
        ov, sh = (torch.from_numpy(rng.normal(0, 0.05, shape)
                                   .astype(np.float32)).to(dev)
                  for shape in ((B, nch, 32, 18), (B, nch, 16, 32)))
        q, _ = mp3_huff.huff_decode(p_d, m_d, W, lpf)

        def k14():
            return mp3_dsp.window_dsp_cuda(q, m_d, s_d, n_act, ov, sh, B=B,
                                           G=G, nch=nch, short=short)

        def route():
            operand, o2, s2 = k14()
            return (mp3_dsp.synth_cuda(operand).view(B, G, nch, 576), o2,
                    s2)

        def product_route():
            operand, o2, s2 = k14()
            return (torch.matmul(operand, toeplitz).view(B, G, nch, 576),
                    o2, s2)

        def twin():
            xq, aa, wt = mp3_huff.spectrum_stage(q, m_d, s_d, B, G, nch,
                                                 short=short)
            return mp3_dsp.mp3_window_dsp(xq, aa, wt, ov, sh, n_act,
                                          nch=nch, ngr=G)

        got, want = route(), twin()
        # granules past a lane's n_act are garbage the batch path drops
        live = (torch.arange(G, device=dev)[None, :] < n_act[:, None]).view(
            B, G, 1, 1)
        got = (torch.where(live, got[0], 0.0), *got[1:])
        want = (torch.where(live, want[0], 0.0), *want[1:])
        gaps = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        if not max(gaps) <= K14_TOL:
            raise AssertionError(f"K14, K15 at B={B} G={G}: PCM, overlap, "
                                 f"history {gaps} of the twin's peak")
        for _ in range(3):
            route()
            product_route()
            twin()
        torch.cuda.synchronize()
        dev_ms = device_ms(k14, "mp3_dsp_kernel", per_launch=True)
        route_dev = device_ms(route, "")
        product_dev = device_ms(product_route, "")
        twin_dev = device_ms(twin, "")
        route_ops = len(kernel_names(route))
        product_ops = len(kernel_names(product_route))
        twin_ops = len(kernel_names(twin))
        ms = time_cuda(k14, 20)
        route_ms = time_cuda(route, 20)
        product_ms = time_cuda(product_route, 20)
        twin_ms = time_cuda(twin, 20)
        host_ms = time_host(k14)
        nbytes, macs = mp3_dsp_work(B, G, nch)
        b = bound(nbytes, 0, macs)
        share = b["bound_ms"] / dev_ms if dev_ms else None
        print(f"# kernel mp3_dsp B={B} G={G} nch={nch} (L={L}, the MP3 "
              f"slice's first window, lanes of {n_fr.min()}-{n_fr.max()} "
              f"frames in it, {MP3_DSP_MS:.0%} of granules mid/side"
              f", short blocks {short}): PCM, overlap and history within "
              f"{max(gaps):.3g} of the twin's peak (PCM {gaps[0]:.3g}); "
              f"device time {dev_ms} ms, wrapper {ms:.4f} ms (its host "
              f"enqueue {host_ms:.4f} ms); route (K14 and K15): device "
              f"{route_dev} ms, {route_ops} kernels, wall {route_ms:.4f} "
              f"ms; K14 and the Toeplitz product: device {product_dev} ms, "
              f"{product_ops} kernels, wall {product_ms:.4f} ms; twin from "
              f"q: device {twin_dev} ms, {twin_ops} kernels, wall "
              f"{twin_ms:.4f} ms; bound_ms {b['bound_ms']:.4f} "
              f"({b['bound_by']}: {nbytes} bytes, {macs} multiply-adds), "
              f"share of device time {share} [{card}]")
        key = f"b{B}" if frames == w24 else f"b{B}_w{frames}"
        res[key] = {"max_gap_of_peak": max(gaps), "device_ms": dev_ms,
                    "ms": ms, "host_ms": host_ms,
                    "route_device_ms": route_dev,
                    "route_kernels": route_ops, "route_ms": route_ms,
                    "product_route_device_ms": product_dev,
                    "product_route_kernels": product_ops,
                    "product_route_ms": product_ms,
                    "plain_device_ms": twin_dev, "plain_kernels": twin_ops,
                    "plain_ms": twin_ms, **b, "share": share}

        # K15 alone on K14's operand
        operand = k14()[0]

        def k15():
            return mp3_dsp.synth_cuda(operand)

        def plain():
            return mp3_dsp.synth_twin(operand)

        def library():
            return torch.matmul(operand, toeplitz)

        want15 = plain()
        gap15 = float((k15() - want15).abs().max() / want15.abs().max())
        if not gap15 <= K15_TOL:
            raise AssertionError(f"K15 at B={B} G={G}: {gap15:.3g} of the "
                                 "plain version's peak")
        del want15
        s_dev = device_ms(k15, "mp3_synth_kernel", per_launch=True)
        s_ms = time_cuda(k15, 20)
        s_host = time_host(k15)
        plain_ms = time_cuda(plain, 20)
        library_ms = time_cuda(library, 20)
        library_dev = device_ms(library, "")
        nbytes, ops = mp3_synth_work(L)
        sb = bound(nbytes, 0, ops)
        s_share = sb["bound_ms"] / s_dev if s_dev else None
        print(f"# kernel mp3_synth B={B} G={G} nch={nch} (L={L} rows of "
              f"K14's operand): within {gap15:.3g} of the plain version's "
              f"peak; device time {s_dev} ms, wrapper {s_ms:.4f} ms (its "
              f"host enqueue {s_host:.4f} ms); plain version (synth_twin) "
              f"{plain_ms:.4f} ms; library_ms (the Toeplitz torch.matmul) "
              f"{library_ms:.4f} ms, device {library_dev} ms; bound_ms "
              f"{sb['bound_ms']:.4f} ({sb['bound_by']}: {nbytes} bytes, "
              f"{ops} float32 operations), share of device time {s_share} "
              f"[{card}]")
        synth[key] = {"max_gap_of_peak": gap15, "device_ms": s_dev,
                      "ms": s_ms, "host_ms": s_host, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_device_ms": library_dev, **sb,
                      "share": s_share}
        del operand
    return {"max_abs_err": max(r["max_gap_of_peak"] for r in res.values()),
            **res,
            "synth": {"max_abs_err": max(r["max_gap_of_peak"]
                                         for r in synth.values()),
                      **synth}}


def dsp_probe(workers=8):
    """--dsp (on the card): K3 at the fma_mp3.b32 cell's sized window
    (phase_mp3_kernel_cell) and phase_mp3_dsp_kernel alone, on 8 MP3
    masters of MP3_SECONDS built in a process pool while nvcc builds K3
    and K14."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from audio_formats_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: --dsp runs on the card")
    card = card_line()
    print(card)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        masters = pool.map(mp3_master, range(8))
        for name in ("mp3_huff", "mp3_dsp"):
            _kernels.load(name)
        masters = list(masters)
    for name, (secs, log) in _kernels.BUILD_LOG.items():
        print(f"#   {name}: nvcc {secs:.2f} s")
        for line in log.strip().splitlines():
            print(f"#   {name}: {line.strip()}")
    streams, _ = mp3_corpus(masters, n_lanes=max(MP3_DSP_LANES))
    print(json.dumps({"mp3_huff_cell": phase_mp3_kernel_cell(card, streams),
                      "mp3_dsp": phase_mp3_dsp_kernel(card, streams)}))
    print(card)


#: --windows: the device operations of an MP3 call, by the names of their
#: kernels and copies (the rest fall under "other")
WINDOW_OPS = (
    ("k3", ("mp3_huff_kernel",)),
    ("plan", ("plan_count_kernel", "plan_base_kernel", "plan_place_kernel")),
    ("k14", ("mp3_dsp_kernel",)),
    ("k15", ("mp3_synth_kernel",)),
    ("product", ("gemm", "splitK", "splitk")),
    ("upload", ("Memcpy HtoD",)),
)
WINDOW_CALLS = 3          # traced calls a turn
WINDOW_SEED = 2718281829  # the clips' seed (the generator's and the draw's)


def window_probe(seed=WINDOW_SEED, calls=WINDOW_CALLS):
    """--windows (on the card): calls of the fma_mp3.b32 cell's shape (32
    FMA-shaped 30 s clips of portbench's generator, drawn from its pool of
    128) with Layer III windows forced to 24 frames or sized by
    parallel/groups/mp3.py's mp3_window_frames, in turns (forward, then
    backward), each turn one call untraced then `calls` calls under a
    CUDA-only torch.profiler trace: the device time a call of each
    operation (K3, its plan, K14, K15, any GEMM, the uploads, the
    rest) and the union of the card's busy intervals, K3's launches and
    its share of the kernel.k3_roofline bound, K15's share of the
    kernel.mp3_synth_roofline bound, windows and frames a window, and the
    memory peak; the sized windows' PCM within K14_TOL of the peak of the
    24-frame call on the same clips (K3, K14 and K15 act on each lane's
    rows alone)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_formats_torch import BatchDecoder
    from audio_formats_torch.ops import mp3_huff
    from audio_formats_torch.parallel.groups import mp3 as mp3_groups
    from portbench import harness, peaks
    from portbench import trace as ptrace
    from portbench.gen import mp3 as gen

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: --windows runs on the card")
    card = card_line()
    print(card)
    cfg = harness.load_json("portbench/configs/fma_mp3.json")
    traffic = harness.load_json("portbench/traffic/clips30_b32.json")
    t0 = time.perf_counter()
    corpus = gen.build(cfg, traffic, np.random.default_rng(seed))
    print(f"# corpus: {len(corpus.streams)} clips in "
          f"{time.perf_counter() - t0:.1f} s")
    B = int(traffic["batch"])
    rng = np.random.default_rng(seed + 1)
    batches = [rng.choice(len(corpus.streams), B, replace=False)
               for _ in range(calls)]
    k3_bytes = sum(576 * 4 * corpus.work["huff_gc"][idx].sum()
                   + corpus.work["huff_bits"][idx].sum() / 8
                   for idx in batches)
    k15_bytes = sum(576 * 8 * corpus.work["huff_gc"][idx].sum()
                    for idx in batches)
    audio_s = sum(corpus.seconds[idx].sum() for idx in batches)
    sized = mp3_groups.mp3_window_frames

    def forced(lanes_per_frame, frames_left, wave_lanes):
        return mp3_groups.MP3_WINDOW_FRAMES

    def call(idx):
        dec = BatchDecoder([corpus.streams[i] for i in idx], device="cuda")
        res = dec.decode_all(output="device").sync()
        return dec.stats, res

    def turn(label, rule):
        mp3_groups.mp3_window_frames = rule
        try:
            call(batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            h0 = mp3_huff.HUFF_LAUNCHES
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stats = []
                for idx in batches:
                    st, res = call(idx)
                    stats.append(st)
                    del res
                torch.cuda.synchronize()
            launches = mp3_huff.HUFF_LAUNCHES - h0
            mem = int(torch.cuda.max_memory_allocated())
            pcm = call(batches[0])[1].to_numpy()
        finally:
            mp3_groups.mp3_window_frames = sized
        op_ms = {k: 0.0 for k, _ in WINDOW_OPS}
        op_ms["other"] = 0.0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            t = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if t is None else t
            key = next((k for k, names in WINDOW_OPS
                        if any(n in evt.key for n in names)), "other")
            op_ms[key] += us / 1e3 / calls
        busy_ms = ptrace.device_time(prof)["busy_s"] * 1e3 / calls
        k3_s = (op_ms["k3"] + op_ms["plan"]) * calls / 1e3
        k15_s = op_ms["k15"] * calls / 1e3
        out = {"label": label, "op_ms_a_call": op_ms,
               "busy_ms_a_call": busy_ms,
               "device_ms_per_audio_s": busy_ms * calls / audio_s,
               "k3_launches_a_call": launches / calls,
               "k3_share_of_bound": (peaks.bound_s(k3_bytes) / k3_s
                                     if k3_s else None),
               "k15_share_of_bound": (peaks.bound_s(k15_bytes) / k15_s
                                      if k15_s else None),
               "windows": [st["windows"] for st in stats],
               "frames_a_window": stats[0]["mp3_window_frames"],
               "memory_peak_bytes": mem}
        print(f"# windows {label}: " + json.dumps(out) + f" [{card}]")
        return out, pcm

    variants = (("w24", forced), ("sized", sized))
    res, pcms = {}, {}
    for label, rule in variants + variants[::-1]:
        out, pcm = turn(label, rule)
        res.setdefault(label, []).append(out)
        pcms.setdefault(label, pcm)
    gaps = {}
    for label, got in pcms.items():
        gap = 0.0
        for a, b in zip(got, pcms["w24"]):
            if a.shape != b.shape:
                raise AssertionError(f"--windows {label}: shapes {a.shape} "
                                     f"{b.shape}")
            gap = max(gap, float(np.abs(a - b).max() / np.abs(b).max()))
        gaps[label] = gap
    print(json.dumps({"windows": res, "max_gap_of_peak": gaps,
                      "card": card}))
    if not max(gaps.values()) <= K14_TOL:
        raise AssertionError(f"--windows: PCM {gaps} of the 24-frame "
                             "PCM's peak")
    print(card)


def phase_mp3(card, streams, info, masters):
    dec, wall, launches, _, err = decode_checked(
        streams, lambda i: mp3_lane_expected(masters, *info[i]), "cuda",
        tol=MP3_TOL)
    st = dec.stats
    if launches["mp3_huff"] != st["windows"] or \
            launches["mp3_dsp"] != st["windows"] or \
            launches["mp3_synth"] != st["windows"]:
        raise AssertionError(f"MP3 launches {launches}")
    secs = st["decoded_seconds"]
    print(f"# MP3 slice: {len(streams)} stereo lanes within {MP3_TOL} of "
          f"the independent float64 decode (max abs err {err:.3g}); "
          f"{secs:.1f} s of audio in {wall:.3f} s wall = "
          f"{secs / wall:.1f}x realtime; h2d_bytes {st['h2d_bytes']}, "
          f"windows {st['windows']}, Huffman launches "
          f"{launches['mp3_huff']}, window DSP launches "
          f"{launches['mp3_dsp']}, synthesis launches "
          f"{launches['mp3_synth']}, host_ms {st['host_ms']:.0f}, "
          f"host_cpu_ms {st['host_cpu_ms']:.0f}, enqueue_ms "
          f"{st['enqueue_ms']:.0f} [{card}]")
    return launches["mp3_huff"], err


def mp3_mixed_streams(flac_lanes, qoa_lanes):
    """MS, intensity (mode_ext 1 and 3, switching per frame) and LR
    stereo, MPEG-2 mono and intensity stereo, Layer I and II, a corrupt
    MP3 lane (last), 4 FLAC and 4 QOA lanes."""
    mp3_ref = golden_mp3_ref()

    rng = np.random.default_rng(77)

    def spectrum(n, hi, maxv):
        q = np.zeros(576, np.int64)
        q[rng.choice(hi, n, replace=False)] = rng.integers(-maxv, maxv + 1, n)
        return q

    def mpeg1(n_frames, mode_ext):
        frames = []
        for i in range(n_frames):
            grs = []
            for _ in range(2):
                q = spectrum(60, 500, 40)
                q[rng.choice(100, 3, replace=False)] = \
                    rng.integers(-900, 901, 3)     # linbits escapes
                qr = q.copy()
                qr[180:] = 0                       # intensity bands pan
                bt = {"block_type": 2} if i % 5 == 3 else {}
                grs.append([dict(q=q, global_gain=146, **bt),
                            dict(q=qr, global_gain=146, **bt)])
            frames.append(grs)
        return mp3_ref.build_mp3(frames, channels=2, mode_ext=mode_ext)

    def mpeg2(channels, mode_ext):
        frames = []
        for i in range(30):
            bt = {"block_type": 2} if i % 4 == 2 else {}
            chans = [dict(q=spectrum(45, 400, 60), global_gain=162, **bt)]
            if channels == 2:
                chans.append(dict(q=spectrum(25, 96, 30), global_gain=162))
            frames.append([chans])
        return mp3_ref.build_mp3_mpeg2(
            frames, channels=channels, mode_ext=mode_ext, ch1_sfc=2 * 70,
            ch1_iscf=[1, 3, 5, 2, 4, 6, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 5, 6])

    l1 = mp3_ref.build_mp3_l1(rng.integers(0, 64, (30, 32, 12)).tolist(),
                              rng.integers(10, 60, (30, 32)).tolist(),
                              ba=6)[0]
    l2 = mp3_ref.build_mp3_l2(rng.integers(0, 16, (30, 3, 30, 12)).tolist(),
                              rng.integers(10, 60, (30, 30)).tolist(),
                              ba=4)[0]
    ms = mpeg1(40, 2)
    bad = bytearray(ms)
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    return ([ms, mpeg1(40, [1, 3, 1, 0, 2] * 8), mpeg1(30, None),
             mpeg2(1, None), mpeg2(2, 1), l1, l2]
            + list(flac_lanes) + list(qoa_lanes) + [bytes(bad)])


def phase_mp3_mixed(card, flac_lanes, qoa_lanes):
    from audio_formats_torch import BatchDecoder

    streams = mp3_mixed_streams(flac_lanes, qoa_lanes)
    bad = len(streams) - 1
    cpu = BatchDecoder(streams, device="cpu")
    ref = cpu.decode_all()
    if any(e is not None for e in cpu.errors[:bad]):
        raise AssertionError(f"CPU decode errors {cpu.errors}")
    dec, _, launches, out, err = decode_checked(
        streams, lambda i: ref[i], "cuda", corrupt=(bad,), tol=MP3_TOL)
    if dec.errors[bad] != cpu.errors[bad] or (out[bad] is None) != \
            (ref[bad] is None):
        raise AssertionError("corrupt MP3 lane: card and CPU differ")
    if ref[bad] is not None:
        e = float(np.abs(out[bad] - ref[bad]).max()) if ref[bad].size else 0
        if out[bad].shape != ref[bad].shape or not e <= MP3_TOL:
            raise AssertionError(f"corrupt MP3 lane: err {e}")
        err = max(err, e)
    print(f"# mixed MP3 lanes (MS, intensity, LR, MPEG-2 mono and "
          f"intensity, Layer I and II, 4 FLAC, 4 QOA, a corrupt MP3 lane): "
          f"every lane within {MP3_TOL} of the CPU decode (max abs err "
          f"{err:.3g}), windows {dec.stats['windows_by_format']}, launches "
          f"{launches} [{card}]")
    return err


# --------------------------------------------------------------- WAV
def wav_corpus(n=WAV_LANES, seconds=WAV_SECONDS):
    """n distinct stereo 44.1 kHz s16 WAV masters of `seconds`: noise at a
    level of its own and a tone each, with both extremes in every lane.
    Returns (streams, each lane's int samples [frames * 2] int16)."""
    from golden import wav_ref

    frames = int(seconds * SR)
    t = np.arange(frames * 2) // 2
    streams, ints = [], []
    for i in range(n):
        rng = np.random.default_rng([19, i])
        amp = int(rng.integers(500, 30000))
        x = rng.integers(-amp, amp, frames * 2, dtype=np.int32)
        x += (2000 * np.sin(2 * np.pi * rng.uniform(50, 5000) / SR * t))\
            .astype(np.int32)
        x[:2] = (-32768, 32767)
        x = np.clip(x, -32768, 32767).astype(np.int16)
        streams.append(wav_ref.build_wav(x.tobytes(), fmt_tag=1, channels=2,
                                         sample_rate=SR, bits=16))
        ints.append(x)
    return streams, ints


def wav_slice(card, streams, ints):
    """The WAV decode slice on the card (decode_checked), every lane bit
    for bit against the reference's double math; the arguments of its
    first K10 call (the group's payload bytes) are kept.  Returns (K10's
    launches, the kept payload)."""
    import torch_pcm_cases
    from audio_formats_torch.ops import pcm

    kept = []
    decode_bytes = pcm.decode_bytes

    def first_call(raw, kind):
        if not kept:
            kept.append((raw, kind))
        return decode_bytes(raw, kind)

    pcm.decode_bytes = first_call
    try:
        dec, wall, launches, _, _ = decode_checked(
            streams, lambda i: torch_pcm_cases.int_pcm_to_float_np(
                ints[i], "s16").reshape(-1, 2), "cuda")
    finally:
        pcm.decode_bytes = decode_bytes
    st = dec.stats
    secs = st["decoded_seconds"]
    n = sum(x.size for x in ints)
    print(f"# WAV slice: {len(streams)} stereo s16 lanes, {n} samples, "
          f"bit-exact against the double-math reference; {secs:.1f} s of "
          f"audio in {wall:.3f} s wall = {secs / wall:.1f}x realtime; "
          f"h2d_bytes {st['h2d_bytes']}, windows {st['windows']}, K10 "
          f"launches {launches['pcm']}, host_ms {st['host_ms']:.0f}, "
          f"enqueue_ms {st['enqueue_ms']:.0f} [{card}]")
    return launches["pcm"], kept[0]


def wav_mixed_streams():
    """u8, s24 and s32 lanes (mono and stereo), an extensible s16 lane, a
    float lane (the per-stream read) and a truncated lane (last)."""
    from golden import wav_ref

    rng = np.random.default_rng(31)
    streams = []
    for bits, ch, n in ((8, 1, 44100), (8, 2, 30001), (24, 2, 44100),
                        (24, 1, 12345), (32, 2, 44100), (32, 1, 999)):
        lo, hi = (0, 256) if bits == 8 else \
            (-(1 << (bits - 1)), 1 << (bits - 1))
        x = rng.integers(lo, hi, n * ch)
        streams.append(wav_ref.build_wav(wav_ref.pack_pcm(x, bits),
                                         fmt_tag=1, channels=ch,
                                         sample_rate=SR, bits=bits))
    x = rng.integers(-32768, 32768, 2 * 20000)
    streams.append(wav_ref.build_wav(wav_ref.pack_pcm(x, 16), fmt_tag=1,
                                     channels=2, sample_rate=SR, bits=16,
                                     extensible=True))
    f = rng.uniform(-1, 1, 2 * 5000).astype("<f4")
    streams.append(wav_ref.build_wav(f.tobytes(), fmt_tag=3, channels=2,
                                     sample_rate=SR, bits=32))
    streams.append(b"RIFF\x04\x00\x00\x00WAVE")
    return streams


def phase_wav_mixed(card):
    """Mixed WAV lanes on the card, each lane bit-equal to the port's CPU
    decode; the truncated lane's error equal too."""
    from audio_formats_torch import BatchDecoder

    streams = wav_mixed_streams()
    bad = len(streams) - 1
    cpu = BatchDecoder(streams, device="cpu")
    want = cpu.decode_all()
    dec, _, launches, _, _ = decode_checked(
        streams, lambda i: want[i], "cuda", corrupt=(bad,))
    if dec.errors != cpu.errors:
        raise AssertionError(f"WAV lane errors {dec.errors} != CPU "
                             f"{cpu.errors}")
    print(f"# mixed WAV lanes (u8, s24, s32 mono and stereo, extensible "
          f"s16, float, a truncated lane): {len(streams) - 1} lanes "
          f"bit-equal to the CPU decode, truncated lane error "
          f"{dec.errors[bad]!r}, windows {dec.stats['windows_by_format']}, "
          f"K10 launches {launches['pcm']} [{card}]")


def phase_wav_encode(card, masters):
    """encode_wav_batch over the QOA encode slice's 64 stereo 4 s masters,
    as s24 with TPDF dither and as s16 without, on the card: every byte
    equal to the CPU encode (the twin).  Returns K10's launches."""
    from audio_formats_torch import encode_wav_batch
    from audio_formats_torch.config import AudioSampleFormat, EncodingOptions
    from audio_formats_torch.ops import pcm

    total = 0
    secs = sum(m.shape[0] for m in masters) / SR
    for fmt, dither in ((AudioSampleFormat.s24, True),
                        (AudioSampleFormat.s16, False)):
        opt = EncodingOptions(sample_format=fmt, enable_dither=dither)
        st = {}
        pcm.ENCODE_LAUNCHES = 0
        t0 = time.perf_counter()
        got = encode_wav_batch(masters, SR, opt, device="cuda", stats=st)
        wall = time.perf_counter() - t0
        launches = pcm.ENCODE_LAUNCHES
        if launches != st["windows"]:
            raise AssertionError(f"WAV encode launches {launches} != "
                                 f"windows {st['windows']}")
        t0 = time.perf_counter()
        want = encode_wav_batch(masters, SR, opt, device="cpu")
        cpu_wall = time.perf_counter() - t0
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"WAV encode {fmt.value} dither={dither}: "
                                 f"streams {bad[:5]} differ from the CPU's")
        total += launches
        print(f"# WAV encode {fmt.value}, dither {dither}: "
              f"{len(masters)} stereo masters, {secs:.1f} s of audio in "
              f"{wall:.3f} s wall = {secs / wall:.1f}x realtime, byte-equal "
              f"to the CPU encode ({cpu_wall:.1f} s); K10 launches "
              f"{launches}, h2d_bytes {st['h2d_bytes']}, d2h_bytes "
              f"{st['d2h_bytes']} [{card}]")
    return total


def phase_pcm_kernel(card, kept):
    """K10 alone: its decode at the WAV slice's own payload (kept) and a
    dithered s24 encode of [256, 2^18] rows (the JAX bench's shape), each
    through its wrapper and alone, beside its bound, the twin on the card
    and, for decode, the one PyTorch call that computes the same function;
    then the decode of every u8, s16 and s24 value against the reference's
    double math."""
    import torch
    import torch_pcm_cases
    from audio_formats_torch.ops import pcm

    raw, kind = kept
    n = raw.numel() // pcm.KIND_BYTES[kind]
    got = pcm.decode_bytes(raw, kind)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(
        lambda: want.append(pcm.decode_bytes_torch(raw, kind)), 1)
    if not torch.equal(got.view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError("K10 decode != twin")
    del want
    # the one PyTorch call: int16 over a float32 tensor divides in float32
    # (over a Python float torch would multiply by its reciprocal)
    scale = torch.tensor(32767.0, device=raw.device)
    lib = torch.div(raw.view(torch.int16), scale)
    lib_equal = bool(torch.equal(lib.view(torch.int32),
                                 got.view(torch.int32)))
    del lib
    for _ in range(3):
        pcm.decode_bytes(raw, kind)
    ms = time_cuda(lambda: pcm.decode_bytes(raw, kind), 20)
    kernel_ms = time_cuda(lambda: pcm.decode_launch(raw, kind, got), 20)
    library_ms = time_cuda(
        lambda: torch.div(raw.view(torch.int16), scale), 20)
    b = bound(raw.numel() + 4 * n, 0)
    print(f"# kernel pcm (decode), the WAV slice's payload ({n} s16 "
          f"samples, {raw.numel() / 1e6:.1f} MB in, {4 * n / 1e6:.1f} MB "
          f"out): bit-equal to the twin; wrapper {ms:.4f} ms, kernel alone "
          f"{kernel_ms:.4f} ms, twin {plain_ms:.2f} ms, torch.div(int16, "
          f"f32 tensor) {library_ms:.4f} ms (bit-equal: {lib_equal}); "
          f"bound_ms "
          f"{b['bound_ms']:.4f} ({b['bound_by']}), share "
          f"{b['bound_ms'] / ms:.3f} [{card}]")
    dec = {"max_abs_err": 0, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, **b, "library_ms": library_ms,
           "share": b["bound_ms"] / ms, "library_bit_equal": lib_equal}

    # every u8, s16 and s24 value
    for k in ("u8", "s16", "s24"):
        if k == "s24":
            ints = np.arange(-(1 << 23), 1 << 23, dtype=np.int32)
        else:
            ints = torch_pcm_cases.decode_ints(k)
        r = torch.from_numpy(torch_pcm_cases.pack_ints(ints, k)).cuda()
        out = pcm.decode_bytes(r, k).cpu().numpy()
        ref = torch_pcm_cases.int_pcm_to_float_np(ints, k)
        if not np.array_equal(out.view(np.int32), ref.view(np.int32)):
            raise AssertionError(f"K10 decode of every {k} value != the "
                                 "double-math reference")
    print(f"# kernel pcm (decode): every u8, s16 and s24 value (2^24 + "
          f"2^16 + 2^8) bit-equal to the double-math reference [{card}]")

    # dithered s24 encode of [256, 2^18] rows
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = (torch.rand((ENC_ROWS, ENC_N), device="cuda", generator=gen) * 2.2
         - 1.1)
    seeds = torch.arange(ENC_ROWS, dtype=torch.int64, device="cuda")
    got = pcm.quantize_pack(x, seeds, "s24", True)
    torch.cuda.synchronize()
    want = []
    eplain_ms = time_cuda(lambda: want.append(pcm.pack_rows_torch(
        pcm.quantize_rows_torch(x, seeds, "s24", True), "s24")), 1)
    if not torch.equal(got, want[0]):
        raise AssertionError("K10 dithered s24 encode != twin")
    del want
    for _ in range(3):
        pcm.quantize_pack(x, seeds, "s24", True)
    ems = time_cuda(lambda: pcm.quantize_pack(x, seeds, "s24", True), 20)
    s32 = seeds.to(torch.int32)
    ekernel_ms = time_cuda(
        lambda: pcm.quantize_launch(x, s32, "s24", True, got), 20)
    samples = ENC_ROWS * ENC_N
    eb = bound(samples * (4 + 3) + ENC_ROWS * 4, samples * DITHER_INT_OPS,
               samples * DITHER_F32_OPS)
    print(f"# kernel pcm (dithered s24 encode), [{ENC_ROWS}, {ENC_N}] rows "
          f"({samples} samples, {DITHER_INT_OPS} int32 and "
          f"{DITHER_F32_OPS} f32 operations a sample): bytes equal to the "
          f"twin; wrapper {ems:.4f} ms, kernel alone {ekernel_ms:.4f} ms, "
          f"twin {eplain_ms:.1f} ms; bound_ms {eb['bound_ms']:.4f} "
          f"({eb['bound_by']}), share {eb['bound_ms'] / ems:.3f} [{card}]")
    enc = {"max_abs_err": 0, "ms": ems, "kernel_ms": ekernel_ms,
           "plain_ms": eplain_ms, **eb, "library_ms": None,
           "share": eb["bound_ms"] / ems}
    return dec, enc


# --------------------------------------------------------------- Vorbis
def vorbis_master(mi: int, packets: int = VORBIS_PACKETS):
    """One stereo coupled Vorbis master (bs0 512, bs1 2048) by the JAX
    bench's recipe (bench.py:532-560): random floor posts, grid residues,
    mostly long blocks with a short pair every so often.  Returns (bytes,
    the golden float64 synthesis [frames, 2])."""
    ref = golden_vorbis_ref()
    rng = np.random.default_rng([23, mi])
    fix = ref.Fixture(channels=2, bs0=512, bs1=2048, coupling=True)
    pattern = [1] * packets
    for j in range(3 + mi % 5, packets - 2, 12 + mi % 7):
        pattern[j] = pattern[j + 1] = 0
    frames, pkts = [], []
    for j in range(packets):
        lb = bool(pattern[j])
        n2 = (2048 if lb else 512) // 2
        posts = [[int(rng.integers(40, 100)) for _ in range(4)]
                 for _ in range(2)]
        res = []
        for _ in range(2):
            r = np.zeros(n2)
            idx = rng.choice(n2, size=n2 // 4, replace=False)
            r[idx] = rng.integers(-5, 6, size=idx.size) * fix.vq_delta
            res.append(r)
        fr = {"posts": posts, "residues": res, "long": lb,
              "prev": int(pattern[j - 1]) if j else 1,
              "next": int(pattern[j + 1]) if j + 1 < packets else 1}
        frames.append(fr)
        pkts.append(fix.audio_packet(posts, res, long_block=lb,
                                     prev_flag=fr["prev"],
                                     next_flag=fr["next"]))
    return fix.build(pkts), ref.expected_output(fix, frames)


def vorbis_slice(card, masters):
    """The Vorbis slice on the card: VORBIS_LANES lanes cycling through the
    masters, each within VORBIS_TOL of the peak of the port's CPU decode
    and within VORBIS_REF_TOL of the peak of the golden synthesis; the
    arguments of its first window chain call are kept.  Returns (K11's
    launches, the kept arguments)."""
    from audio_formats_torch import BatchDecoder
    from audio_formats_torch.ops import vorbis_win

    streams = [masters[i % len(masters)][0] for i in range(VORBIS_LANES)]
    t0 = time.perf_counter()
    cpu = BatchDecoder([m[0] for m in masters], device="cpu").decode_all()
    cpu_wall = time.perf_counter() - t0
    kept = {}
    chain = vorbis_win.vorbis_window_chain

    def first_call(*args, **kw):
        kept.setdefault("args", (args, kw))
        return chain(*args, **kw)

    vorbis_win.vorbis_window_chain = first_call
    try:
        dec, wall, launches, out, err = decode_checked(
            streams, lambda i: cpu[i % len(masters)], "cuda",
            tol=VORBIS_TOL, rel=True)
    finally:
        vorbis_win.vorbis_window_chain = chain
    ref_err = 0.0
    for i, got in enumerate(out):
        want = masters[i % len(masters)][1]
        if got.shape != want.shape:
            raise AssertionError(f"Vorbis lane {i}: {got.shape}, golden "
                                 f"{want.shape}")
        e = float(np.abs(got - want).max() / np.abs(want).max())
        ref_err = max(ref_err, e)
        if not e <= VORBIS_REF_TOL:
            raise AssertionError(f"Vorbis lane {i}: {e:.3g} of the peak "
                                 "from the golden synthesis")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# Vorbis slice: {len(streams)} stereo lanes of "
          f"{len(masters)} masters ({VORBIS_PACKETS} packets each), "
          f"{secs:.1f} s of audio in {wall:.3f} s wall = "
          f"{secs / wall:.1f}x realtime; within {err:.3g} of the peak of "
          f"the CPU decode ({cpu_wall:.1f} s for the masters) and "
          f"{ref_err:.3g} of the golden synthesis; h2d_bytes "
          f"{st['h2d_bytes']}, windows {st['windows']}, K11 launches "
          f"{launches['vorbis_win']}, host_ms {st['host_ms']:.0f}, "
          f"enqueue_ms {st['enqueue_ms']:.0f} [{card}]")
    return launches["vorbis_win"], kept["args"]


def vorbis_win_work(y1, y0, ls, rs, re, valid, bs0, bs1, ch):
    """(bytes) of K11 at this window: each valid slot's IMDCT row over
    [ls, re) read once, every PCM row written, the lap and the geometry
    read and written."""
    v = valid.to(bool)
    span = int(((re - ls) * v).sum()) * ch
    K, L, _ = y1.shape
    return span * 4 + K * L * bs1 * 4 + 2 * L * (bs1 // 2) * 4 \
        + 4 * ls.numel() * 4 + 4 * (L // ch) * 4


def phase_vorbis_kernel(card, kept):
    """K11 at the Vorbis slice's first window (its arguments kept): the
    IMDCT matmuls beside it, K11 through its wrapper and alone, the twin
    on the card, the chain against the twin within VORBIS_TOL of the
    peak."""
    import torch
    from audio_formats_torch.ops import mdct, vorbis_win

    args, kw = kept
    X, ls, rs, re, valid, lap, lap_len, had_prev = args
    bs0, bs1, ch = kw["bs0"], kw["bs1"], kw["ch"]
    K, L, h = X.shape
    h0 = bs0 // 2

    def imdct():
        y1 = mdct.imdct_batch(X.reshape(K * L, h), bs1).reshape(K, L, bs1)
        y0 = mdct.imdct_batch(X[..., :h0].reshape(K * L, h0), bs0)\
            .reshape(K, L, bs0)
        return y1, y0

    y1, y0 = imdct()
    st = (lap, lap_len, had_prev)
    geo = (ls, rs, re, valid)
    got = vorbis_win.lap_chain(y1, y0, *geo, *st, bs0=bs0, bs1=bs1, ch=ch)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(vorbis_win.lap_chain_torch(
        y1, y0, *geo, *st, bs0=bs0, bs1=bs1, ch=ch)), 1)
    want = want[0]
    err = 0.0
    for g, w in zip(got[:2], want[:2]):
        e = float((g - w).abs().max()) / (float(w.abs().max()) + 1e-12)
        err = max(err, e)
    if not (err <= VORBIS_TOL and torch.equal(got[2], want[2])
            and torch.equal(got[3], want[3])):
        raise AssertionError(f"K11 != twin: {err:.3g} of the peak")
    for _ in range(3):
        vorbis_win.lap_chain(y1, y0, *geo, *st, bs0=bs0, bs1=bs1, ch=ch)
    ms = time_cuda(lambda: vorbis_win.lap_chain(
        y1, y0, *geo, *st, bs0=bs0, bs1=bs1, ch=ch), 20)
    kernel_ms = time_cuda(lambda: vorbis_win.lap_chain_launch(
        y1, y0, *geo, *st, got, bs0=bs0, bs1=bs1, ch=ch), 20)
    dev_ms = device_ms(lambda: vorbis_win.lap_chain_launch(
        y1, y0, *geo, *st, got, bs0=bs0, bs1=bs1, ch=ch), "vorbis_win")
    host_ms = time_host(lambda: vorbis_win.lap_chain(
        y1, y0, *geo, *st, bs0=bs0, bs1=bs1, ch=ch))
    launch_host_ms = time_host(lambda: vorbis_win.lap_chain_launch(
        y1, y0, *geo, *st, got, bs0=bs0, bs1=bs1, ch=ch))
    chained = int(vorbis_win.chained_lanes(*geo, lap_len, bs0=bs0,
                                           bs1=bs1).sum())
    imdct_ms = time_cuda(imdct, 20)
    chain_ms = time_cuda(lambda: vorbis_win.vorbis_window_chain(
        *args, **kw), 20)
    b = bound(vorbis_win_work(y1, y0, *geo, bs0, bs1, ch), 0)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"# kernel vorbis_win, the Vorbis slice's first window (K={K}, "
          f"L={L} lane-channels, bs {bs0}/{bs1}, "
          f"{int(valid.sum())} valid slots, {chained} of {L // ch} lanes "
          f"chained): within {err:.3g} of the peak "
          f"of the twin; wrapper {ms:.4f} ms (its host enqueue "
          f"{host_ms:.4f} ms), kernel alone {kernel_ms:.4f} ms (its host "
          f"enqueue {launch_host_ms:.4f} ms), the kernel's device time "
          f"(torch.profiler) {dev_txt}, twin {plain_ms:.1f} ms; the IMDCT "
          f"matmuls beside it {imdct_ms:.4f} ms, the whole window chain "
          f"{chain_ms:.4f} ms; bound_ms {b['bound_ms']:.4f} "
          f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f} through the "
          f"wrapper, "
          + ("not measured" if dev_ms is None
             else f"{b['bound_ms'] / dev_ms:.3f}")
          + f" of its device time [{card}]")
    return {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
            "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, **b, "library_ms": None,
            "share": b["bound_ms"] / ms, "imdct_ms": imdct_ms,
            "chain_ms": chain_ms}


# --------------------------------------------------------------- Opus
def opus_read(data):
    """The port's per-stream read of an Opus stream on the host (its IMDCT
    models/celt.py ``imdct_half``, an f64 FFT: a path that K12a is not on)."""
    from audio_formats_torch import models
    from audio_formats_torch.io.source import MemorySource

    dec = models.probe_all(MemorySource(data), "cpu")
    chunks = []
    while True:
        c = dec.read(1 << 16)
        if c.shape[0] == 0:
            break
        chunks.append(c)
    return np.concatenate(chunks)


def opus_streams(n_lanes=OPUS_LANES):
    """The Opus slice's streams (``opus_corpus``), without the references:
    (streams, each stereo lane's (master, preskip, end), the constants of
    test_opus_celt.py)."""
    import torch_opus_cases

    ref = golden_opus_ref()
    masters = [m for m in torch_opus_cases.load() if m[0] == 2]
    streams, spans = [], []
    for i in range(n_lanes):
        mi = i % len(masters)
        n = 100 + (37 * i) % 101
        skip = (0, 130, 312)[i % 3]
        streams.append(torch_opus_cases.stream(
            ref.build_ogg_opus, masters[mi], n, preskip=skip))
        spans.append((mi, skip, n * masters[mi][1]))
    celt = read_constants("test_opus_celt", (
        "PACKETS", "SAMPLE_IDX", "SAMPLES", "RMS"))
    streams.append(ref.build_ogg_opus(
        [(bytes.fromhex(h), 480) for h in celt["PACKETS"]], channels=1,
        preskip=0))
    return streams, spans, celt


def opus_corpus(n_lanes=OPUS_LANES):
    """The Opus slice's lanes: packet prefixes of 2-4 s (100-200 packets of
    20 ms) of the committed corpus's four stereo masters
    (tests/torch_opus_cases.py), with preskip 0, 130 or 312, and last a
    mono lane of the four real CELT packets of tests/test_opus_celt.py.
    Returns (streams, each lane's expected PCM, the constants of
    test_opus_celt.py): a stereo lane's PCM is its master's per-stream read
    at preskip 0, cut to the lane's span."""
    import torch_opus_cases

    ref = golden_opus_ref()
    masters = [m for m in torch_opus_cases.load() if m[0] == 2]
    full = [opus_read(torch_opus_cases.stream(ref.build_ogg_opus, m,
                                              preskip=0)) for m in masters]
    streams, spans, celt = opus_streams(n_lanes)

    def expect(i):
        if i == n_lanes:
            return opus_read(streams[i])
        mi, skip, end = spans[i]
        return full[mi][skip:end]

    return streams, expect, celt


def keep_buckets(run):
    """Run `run()` with ``ops.celt_dsp.celt_imdct_ola_packed`` wrapped: its
    calls (the CELT buckets) counted by (blocks, bs), and the first call of
    each of K12a's routes kept ("short": bs == 120, "long": bs >= 240).
    Returns (run's result, {route: (args, kwargs)}, {(blocks, bs): calls})."""
    import collections

    from audio_formats_torch.ops import celt_dsp

    kept, buckets = {}, collections.Counter()
    imdct_ola = celt_dsp.celt_imdct_ola_packed

    def counted(co, tail, blocks, bs, *args, **kw):
        buckets[(blocks, bs)] += 1
        kept.setdefault("short" if bs == celt_dsp.OVERLAP else "long",
                        ((co, tail, blocks, bs, *args), kw))
        return imdct_ola(co, tail, blocks, bs, *args, **kw)

    celt_dsp.celt_imdct_ola_packed = counted
    try:
        res = run()
    finally:
        celt_dsp.celt_imdct_ola_packed = imdct_ola
    return res, kept, dict(sorted(buckets.items()))


def route_counts(label, launches, buckets):
    """K12a's launches by route, held to the buckets by (blocks, bs): one
    fused launch a bucket of 120-sample blocks, one in-place mix a bucket
    of longer ones.  Returns the line's text."""
    short = sum(n for (_, bs), n in buckets.items() if bs == 120)
    long_ = sum(buckets.values()) - short
    if (launches["celt_imdct_ola"], launches["celt_ola"]) != (short, long_):
        raise AssertionError(f"{label}: K12a launches fused "
                             f"{launches['celt_imdct_ola']}, in place "
                             f"{launches['celt_ola']}; buckets {buckets}")
    return (f"K12a launches {short} fused (bs 120) + {long_} in place (bs "
            f">= 240), buckets by (blocks, bs) "
            + ", ".join(f"{b}x{bs}: {n}" for (b, bs), n in buckets.items()))


def opus_slice(card, streams, expect, celt):
    """The Opus slice on the card: every stereo lane within OPUS_TOL of the
    peak of its expected PCM; the lane of the four real CELT packets at its
    spot samples and RMS (tests/test_opus_celt.py, checked there against
    libopus) within 1e-5, the stream's R128 gain undone; the first
    celt_imdct_ola call of each of K12a's routes kept.  Returns (launches
    by kernel, the kept arguments by route)."""
    (dec, wall, launches, out, err), kept, buckets = keep_buckets(
        lambda: decode_checked(streams, expect, "cuda", tol=OPUS_TOL,
                               rel=True))
    pk = out[-1][:, 0] / np.float32(10.0 ** (-1024 / 5120.0))
    spot = max(abs(float(pk[i]) - v)
               for i, v in zip(celt["SAMPLE_IDX"], celt["SAMPLES"]))
    rms = abs(float(np.sqrt((pk ** 2).mean())) - celt["RMS"])
    if not (spot <= 1e-5 and rms <= 1e-5):
        raise AssertionError(f"CELT packets lane: spot samples off by "
                             f"{spot}, RMS by {rms}")
    routes = route_counts("Opus slice", launches, buckets)
    if not (launches["celt_imdct_ola"] and launches["celt_ola"]):
        raise AssertionError(f"Opus slice: a K12a route never launched: "
                             f"{routes}")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# Opus slice: {len(streams) - 1} stereo CELT lanes (packet "
          f"prefixes of 2-4 s of 4 masters) and the 4-packet mono lane, "
          f"{secs:.1f} s of audio in {wall:.3f} s wall = "
          f"{secs / wall:.1f}x realtime; within {err:.3g} of the peak of "
          f"the per-stream read; CELT packets lane spot samples within "
          f"{spot:.3g}, RMS within {rms:.3g}; {routes}; h2d_bytes "
          f"{st['h2d_bytes']}, d2h_bytes {st['d2h_bytes']}, host_ms "
          f"{st['host_ms']:.0f} (host_cpu_ms {st['host_cpu_ms']:.0f}), "
          f"enqueue_ms {st['enqueue_ms']:.0f} [{card}]")
    return launches, kept


K12A_TOL = 1e-6   # of the peak: the fused short-block route against its twin


def imdct_ola_work(rows, blocks, bs):
    """(bytes, operations, dense multiply-adds) of celt_imdct_ola: the
    spectra and the tail (and the basis and the window) read once, the
    packed output written once; the float32 operations of a fast IMDCT
    of every block (``fast_imdct_ops``: the least the function needs, since
    the route is held to its twin within a tolerance, not to a summation
    order), and the bs multiply-adds an IMDCT sample that the kernel's
    dense product does."""
    frame = blocks * bs
    return (4 * (rows * frame + rows * 60 + rows * (frame + 60) + bs * bs
                 + 120), rows * blocks * fast_imdct_ops(bs),
            rows * frame * bs)


def fast_imdct_ops(n):
    """Float32 operations, a multiply-add counted as one, of an n-point
    IMDCT half-transform (a DCT-IV of n points) by a fast algorithm, as
    CELT computes it: n/2 complex twiddles before and after an n/2-point
    complex FFT, 6 flops a twiddle and 5 (n/2) log2(n/2) flops the FFT,
    halved as if every multiply fused into an add."""
    m = n // 2
    return (2 * 6 * m + 5 * m * np.log2(m)) / 2


def celt_ola_work(rows, blocks):
    """(bytes) of K12a's in-place mix: a block's 60 b1 samples, the tail
    or the previous block's 60 raw samples and the window read once, a
    block's 120 mixed samples written once."""
    return 4 * (rows * blocks * (60 + 60 + 120) + 120)


def kernel_names(fn, reps=10):
    """The names of the kernels one call of `fn` runs on the card, each as
    often as it runs: torch.profiler's device events of `reps` calls (as
    ``device_ms`` reads them), their counts over `reps`; traced again
    (TRACE_TRIES in all) while the trace holds no device event at all."""
    from torch.autograd import DeviceType

    for _ in range(TRACE_TRIES):
        names = [evt.key for evt in traced(fn, reps).key_averages()
                 if evt.device_type == DeviceType.CUDA
                 for _ in range(round(evt.count / reps))]
        if names:
            break
    return names


def time_imdct_ola_short(card, label, co, tail, blocks, scale):
    """K12a's fused route (bs == 120) at one shape: within K12A_TOL of the
    peak of its twin (the matmul and the mix) on the card, one kernel and
    no matmul a call, timed through its wrapper (celt_imdct_ola), alone,
    by its device time and by its host enqueue, beside its bound, the
    twin and the matmul it replaces (library_ms: imdct_halves, cuBLAS in
    full float32)."""
    import torch
    from audio_formats_torch.ops import celt_dsp

    rows = co.shape[0]
    frame = blocks * 120
    got = celt_dsp.celt_imdct_ola_packed(co, tail, blocks, 120, scale)
    celt_dsp.celt_imdct_ola_packed_torch(co, tail, blocks, 120, scale)  # warm
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(
        celt_dsp.celt_imdct_ola_packed_torch(co, tail, blocks, 120, scale)),
        1)
    want = want[0]
    peak = float(want.abs().max())
    err = float((got - want).abs().max()) / peak
    if not err <= K12A_TOL:
        raise AssertionError(f"K12a fused at {label}: {err:.3g} of the peak "
                             "from its twin")
    names = kernel_names(lambda: celt_dsp.celt_imdct_ola(co, tail, blocks,
                                                         120, scale))
    if len(names) != 1 or "celt_imdct_ola" not in names[0]:
        raise AssertionError(f"K12a fused at {label}: kernels {names}")

    def wrapper():
        return celt_dsp.celt_imdct_ola(co, tail, blocks, 120, scale)

    def alone():
        celt_dsp.imdct_ola_short_launch(co, tail, blocks, scale, got)

    def matmul():
        return celt_dsp.imdct_halves(co, blocks, 120, scale)

    for _ in range(3):
        wrapper()
    ms = time_cuda(wrapper, 50)
    kernel_ms = time_cuda(alone, 50)
    dev_ms = device_ms(alone, "celt_imdct_ola")
    host_ms = time_host(wrapper)
    matmul()
    library_ms = time_cuda(matmul, 50)
    library_dev_ms = device_ms(matmul, "")
    nbytes, ops, macs = imdct_ola_work(rows, blocks, 120)
    b = bound(nbytes, 0, ops)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"# kernel celt_imdct_ola (K12a fused, bs 120), {label} ({rows} "
          f"rows x {blocks} x 120, scale {scale}): {err:.3g} of the peak "
          f"from its twin; one kernel a call ({names[0][:40]}); wrapper "
          f"{ms:.4f} ms (its host enqueue {host_ms:.4f} ms), kernel alone "
          f"{kernel_ms:.4f} ms, device time (torch.profiler) {dev_txt}, twin "
          f"{plain_ms:.3f} ms, the matmul it replaces (imdct_halves) "
          f"{library_ms:.4f} ms (device time "
          + ("not measured" if library_dev_ms is None
             else f"{library_dev_ms:.4f} ms")
          + f"); {nbytes} bytes, {ops:.0f} float32 operations of a fast "
          f"IMDCT ({macs} multiply-adds in the kernel's dense product), "
          f"bound_ms {b['bound_ms']:.5f} ({b['bound_by']}), share "
          f"{b['bound_ms'] / ms:.3f} through the wrapper, "
          + ("not measured" if dev_ms is None
             else f"{b['bound_ms'] / dev_ms:.3f}")
          + f" of its device time [{card}]")
    return {"max_abs_err": err * peak, "rel_err": err, "ms": ms,
            "kernel_ms": kernel_ms, "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, **b, "library_ms": library_ms,
            "library_device_ms": library_dev_ms, "share": b["bound_ms"] / ms}


def time_celt_ola(card, label, co, tail, blocks, bs, scale):
    """K12a's in-place mix (bs >= 240) at one shape: bit-equal to its twin
    (celt_ola_torch) on the half-transforms that the matmul writes into the
    packed buffer; the route's kernels a call (the GEMM and the mix, no
    copy); the mix timed through its wrapper (celt_ola, which allocates
    nothing: the launch alone) and by its device time, the whole route
    through celt_imdct_ola and by its host enqueue, beside the mix's bound,
    the twin and the matmul in front of it.  No PyTorch call computes the
    mix: library_ms is null."""
    import torch
    from audio_formats_torch.ops import celt_dsp

    rows = co.shape[0]
    frame = blocks * bs
    buf = celt_dsp._packed_halves(co, blocks, bs, scale)
    halves = buf[:, 60:].clone().unflatten(1, (blocks, bs))
    celt_dsp.celt_ola(buf, tail, blocks)
    got = (buf[:, :frame], buf[:, frame:])
    celt_dsp.celt_ola_torch(halves, tail)  # warm
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(
        celt_dsp.celt_ola_torch(halves, tail)), 1)
    want = want[0]
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        d = max(float((g - w).abs().max()) for g, w in zip(got, want))
        raise AssertionError(f"K12a in place != twin at {label}: max abs "
                             f"diff {d}")
    names = kernel_names(lambda: celt_dsp.celt_imdct_ola(co, tail, blocks,
                                                         bs, scale))
    extra = [n for n in names if "celt_ola" not in n and "gemm" not in
             n.lower() and "sgemm" not in n.lower()]

    def wrapper():
        return celt_dsp.celt_imdct_ola(co, tail, blocks, bs, scale)

    def alone():
        celt_dsp.celt_ola(buf, tail, blocks)

    def matmul():
        return celt_dsp._packed_halves(co, blocks, bs, scale)

    for _ in range(3):
        wrapper()
    route_ms = time_cuda(wrapper, 50)
    ms = time_cuda(alone, 50)
    dev_ms = device_ms(alone, "celt_ola")
    host_ms = time_host(wrapper)
    matmul()
    imdct_ms = time_cuda(matmul, 50)
    b = bound(celt_ola_work(rows, blocks), 0)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"# kernel celt_ola (K12a in place, bs >= 240), {label} ({rows} "
          f"rows x {blocks} x {bs}): bit-equal to its twin; a call of the "
          f"route runs {len(names)} kernels "
          f"{[n[:48] for n in names]}, "
          + (f"of which neither GEMM nor the mix: {extra}" if extra
             else "no copy after the GEMM")
          + f"; the mix through its wrapper {ms:.4f} ms, its device time "
          f"(torch.profiler) {dev_txt}, the route through celt_imdct_ola "
          f"{route_ms:.4f} ms (its host enqueue {host_ms:.4f} ms), the "
          f"matmul into the packed buffer {imdct_ms:.4f} ms, twin "
          f"{plain_ms:.3f} ms; bound_ms {b['bound_ms']:.5f} "
          f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f} through the "
          f"wrapper, "
          + ("not measured" if dev_ms is None
             else f"{b['bound_ms'] / dev_ms:.3f}")
          + f" of its device time [{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "route_ms": route_ms,
            "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "share": b["bound_ms"] / ms,
            "imdct_ms": imdct_ms, "route_kernels": len(names),
            "copy_kernels": extra}


def phase_celt_kernel(card, kept):
    """K12a's two routes at the Opus slice's first bucket of each (their
    arguments kept) and at OPUS_BIG from random spectra: the fused
    short-block kernel at 4,096 rows of 8 x 120, the in-place mix at 4,096
    rows of one block of 960.  Returns ({route's kernel: result})."""
    import torch

    res = {}
    for route, name in (("short", "celt_imdct_ola"), ("long", "celt_ola")):
        args, kw = kept[route]
        co, tail, blocks, bs = args[:4]
        scale = args[4] if len(args) > 4 else kw.get("scale", 1.0)
        label = "the Opus slice's first bucket"
        res[name] = (time_imdct_ola_short(card, label, co, tail, blocks,
                                          scale)
                     if route == "short" else
                     time_celt_ola(card, label, co, tail, blocks, bs, scale))
    rng = np.random.default_rng(12)
    for rows, nb, nbs in OPUS_BIG:
        co = torch.from_numpy((rng.standard_normal((rows, nb * nbs))
                               * 400).astype(np.float32)).cuda()
        tl = torch.from_numpy((rng.standard_normal((rows, 60))
                               * 400).astype(np.float32)).cuda()
        if nbs == 120:
            name = "celt_imdct_ola"
            r = time_imdct_ola_short(card, "random spectra", co, tl, nb, 1.0)
            keys = ("ms", "kernel_ms", "device_ms", "bound_ms", "plain_ms",
                    "library_ms", "library_device_ms", "rel_err")
        else:
            name = "celt_ola"
            r = time_celt_ola(card, "random spectra", co, tl, nb, nbs, 1.0)
            keys = ("ms", "route_ms", "device_ms", "bound_ms", "plain_ms",
                    "imdct_ms")
        res[name].setdefault("large", {})[f"{rows}x{nb}x{nbs}"] = {
            k: r[k] for k in keys}
    return res


def opus_mixed_streams(rng):
    """Mixed Opus lanes: corpus lanes of both channel counts, the four
    mono CELT packets, a stereo-coded lane with a mono header, a SILK lane
    of the in-repo packets, a DTX lane, stereo SILK and stereo hybrid
    lanes, a mono hybrid lane and a mode tour of the speech corpus, and
    last a corpus lane with bytes flipped in its packets."""
    import torch_opus_cases
    import torch_opus_speech_cases as sc

    ref = golden_opus_ref()
    corpus = torch_opus_cases.load()
    speech = sc.load()
    kinds = sc.kinds()

    def master(kind, ch):
        return next(m for m, k in zip(speech, kinds)
                    if k == kind and m[0] == ch)
    celt = read_constants("test_opus_celt", ("PACKETS",))["PACKETS"]
    silk = read_constants("test_opus_silk", ("SILK_PACKETS",))[
        "SILK_PACKETS"]
    streams = [torch_opus_cases.stream(ref.build_ogg_opus, corpus[i], n,
                                       preskip=ps)
               for i, n, ps in ((0, 50, 312), (1, 73, 0), (4, 50, 130))]
    streams += [
        ref.build_ogg_opus([(bytes.fromhex(h), 480) for h in celt],
                           channels=1, preskip=130),
        torch_opus_cases.stream(ref.build_ogg_opus, corpus[2], 44,
                                channels=1, preskip=0),
        ref.build_ogg_opus([(bytes.fromhex(h), 960) for h in silk],
                           channels=1, preskip=0),
        ref.build_ogg_opus([ref.dtx_packet()] * 3
                           + [ref.silence_packet()] * 2, channels=1,
                           preskip=0),
        sc.stream(ref.build_ogg_opus, master("silk", 2), 60, preskip=312),
        sc.stream(ref.build_ogg_opus, master("hybrid", 2), 45, preskip=0),
        sc.stream(ref.build_ogg_opus, master("hybrid", 1), 52, preskip=312),
        sc.stream(ref.build_ogg_opus, master("tour", 1), 70, preskip=0)]
    bad = bytearray(torch_opus_cases.stream(ref.build_ogg_opus, corpus[3],
                                            60, preskip=0))
    for pos in rng.integers(len(bad) // 4, len(bad), 16):
        bad[pos] ^= 0xFF
    streams.append(bytes(bad))
    return streams


def phase_opus_mixed(card):
    """Mixed Opus lanes on the card, each within OPUS_TOL of the peak of
    the port's CPU decode; the corrupt lane's error and length equal the
    CPU's."""
    from audio_formats_torch import BatchDecoder

    streams = opus_mixed_streams(np.random.default_rng(77))
    bad = len(streams) - 1
    cpu = BatchDecoder(streams, device="cpu")
    want = cpu.decode_all()
    if any(e is not None for e in cpu.errors[:bad]):
        raise AssertionError(f"CPU decode errors {cpu.errors}")
    dec, _, launches, out, err = decode_checked(
        streams, lambda i: want[i], "cuda", corrupt=(bad,), tol=OPUS_TOL,
        rel=True)
    if dec.errors != cpu.errors or (out[bad] is None) != (want[bad] is None):
        raise AssertionError(f"corrupt Opus lane: card {dec.errors[bad]!r}, "
                             f"CPU {cpu.errors[bad]!r}")
    st = dec.stats
    groups = {g: st.get(f"opus_{g}_lanes", 0)
              for g in ("silk", "hybrid", "mixed")}
    if groups != {"silk": 2, "hybrid": 2, "mixed": 1} or \
            not st["windows_by_format"].get("opus_silk"):
        raise AssertionError(f"mixed Opus lanes by group {groups}, windows "
                             f"{st['windows_by_format']}")
    if want[bad] is not None:
        if out[bad].shape != want[bad].shape:
            raise AssertionError(f"corrupt Opus lane: {out[bad].shape}, CPU "
                                 f"{want[bad].shape}")
        if want[bad].size:
            e = float(np.abs(out[bad] - want[bad]).max()
                      / (np.abs(want[bad]).max() + 1e-12))
            if not e <= OPUS_TOL:
                raise AssertionError(f"corrupt Opus lane: {e:.3g} of the "
                                     "peak")
            err = max(err, e)
    print(f"# mixed Opus lanes (corpus stereo and mono, the 4 CELT packets, "
          f"a stereo-coded lane with a mono header, mono and stereo SILK, "
          f"DTX, mono and stereo hybrid, a mode tour, a corrupt lane): "
          f"every lane within {err:.3g} of the peak of the CPU decode, "
          f"corrupt lane {len(out[bad]) if out[bad] is not None else None} "
          f"frames, error {dec.errors[bad]!r}; lanes by group {groups}, "
          f"lanes demoted {st.get('lanes_demoted', 0)}, windows by format "
          f"{st['windows_by_format']}, K12a launches "
          f"{launches['celt_ola'] + launches['celt_imdct_ola']}, K13 launches "
          f"{launches['silk_upsample']} [{card}]")


# --------------------------------------------------------------- speech Opus
def speech_corpus(kind, n_lanes):
    """A speech slice's lanes: packet prefixes of 2-4 s (SPEECH_PACKETS)
    of the speech corpus's mono masters of `kind` (tests/
    torch_opus_speech_cases.py: "silk", "hybrid" or "tour"), preskip 0 or
    312, the distinct (master, packets, preskip) in turn.  Returns
    (streams, each lane's expected PCM): the port's per-stream read on the
    host, made once for each distinct lane."""
    distinct = speech_distinct(kind)
    with ThreadPoolExecutor(max_workers=8) as ex:
        refs = list(ex.map(opus_read, distinct))
    streams = [distinct[i % len(distinct)] for i in range(n_lanes)]
    return streams, lambda i: refs[i % len(distinct)]


def speech_distinct(kind):
    """The distinct lanes of a speech slice (``speech_corpus``): each mono
    master of `kind`, cut at each of SPEECH_PACKETS, preskip 0 and 312."""
    import torch_opus_speech_cases as sc

    ref = golden_opus_ref()
    masters = [m for m, k in zip(sc.load(), sc.kinds())
               if k == kind and m[0] == 1]
    return [sc.stream(ref.build_ogg_opus, m, n, preskip=skip)
            for m in masters for n in SPEECH_PACKETS for skip in (0, 312)]


def speech_slice(card, kind, n_lanes, group):
    """A speech slice on the card through decode_all(output="device"):
    every lane within OPUS_TOL of the peak of its per-stream read, every
    lane in `group`, no demotion; the first K13 call's arguments kept.
    Returns (launches by kernel, the kept arguments)."""
    from audio_formats_torch.ops import resample

    t0 = time.perf_counter()
    streams, expect = speech_corpus(kind, n_lanes)
    t_ref = time.perf_counter() - t0
    kept = {}
    upsample = resample.silk_upsample

    def first_call(*args, **kw):
        kept.setdefault("args", (args, kw))
        return upsample(*args, **kw)

    resample.silk_upsample = first_call
    try:
        (dec, wall, launches, _, err), _, buckets = keep_buckets(
            lambda: decode_checked(streams, expect, "cuda", tol=OPUS_TOL,
                                   rel=True))
    finally:
        resample.silk_upsample = upsample
    routes = route_counts(f"{kind} slice", launches, buckets)
    st = dec.stats
    if st.get(f"opus_{group}_lanes") != n_lanes:
        raise AssertionError(f"{kind} slice: {st.get(f'opus_{group}_lanes')} "
                             f"of {n_lanes} lanes in the {group} group")
    if kind != "tour" and launches["silk_upsample"] == 0:
        raise AssertionError(f"{kind} slice: K13 never launched")
    secs = st["decoded_seconds"]
    print(f"# Opus {kind} slice: {n_lanes} mono lanes in the {group} group "
          f"(packet prefixes of 2-4 s, preskip 0/312; per-stream references "
          f"of the distinct lanes {t_ref:.1f} s), {secs:.1f} s of audio in "
          f"{wall:.3f} s wall = {secs / wall:.1f}x realtime; within "
          f"{err:.3g} of the peak of the per-stream read; host_ms "
          f"{st['host_ms']:.0f} (host_cpu_ms {st['host_cpu_ms']:.0f}), "
          f"enqueue_ms {st['enqueue_ms']:.0f}, h2d_bytes {st['h2d_bytes']}, "
          f"d2h_bytes {st['d2h_bytes']}, windows {st['windows_by_format']}, "
          f"K13 launches {launches['silk_upsample']}, {routes}, mixed "
          f"host rounds "
          f"{st.get('opus_mixed_host_rounds', 0)} [{card}]")
    return launches, kept.get("args")


def silk_upsample_work(rows, W, G, den):
    """(bytes, multiply-adds) of K13: the input rows and the taps read
    once, the output written once; 96 multiply-adds an output sample."""
    return 4 * (rows * W + den * 96 + rows * G * den), rows * G * den * 96


def time_silk_upsample(card, label, x, taps, G):
    """K13 at one shape: within K13_TOL of the peak of its twin on the
    card (the twin a full-float32 matmul), with the share of its samples
    bit-equal to the twin's; timed through its wrapper, alone, by its
    device time and by its host enqueue, beside its bound, the twin and
    torch.nn.functional.conv1d (cuDNN, TF32 off: the library yardstick,
    which the port never calls)."""
    import torch
    from audio_formats_torch.ops import resample

    rows, W = x.shape
    den = taps.shape[0]
    h_rev = torch.from_numpy(taps).to(x.device)
    got = resample.silk_upsample(x, taps, G)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(
        resample.silk_upsample_torch(x, h_rev, G)), 1)
    want = want[0]
    peak = float(want.abs().max())
    err = float((got - want).abs().max()) / peak
    if not err <= K13_TOL:
        raise AssertionError(f"K13 at {label}: {err:.3g} of the peak from "
                             "its twin")
    equal = float((got == want).float().mean())
    for _ in range(3):
        resample.silk_upsample(x, taps, G)
    ms = time_cuda(lambda: resample.silk_upsample(x, taps, G), 50)
    kernel_ms = time_cuda(lambda: resample.silk_upsample_launch(
        x, taps, G, got), 50)
    dev_ms = device_ms(lambda: resample.silk_upsample_launch(
        x, taps, G, got), "silk_upsample")
    host_ms = time_host(lambda: resample.silk_upsample(x, taps, G))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = lambda: torch.nn.functional.conv1d(  # noqa: E731
            x[:, None, : G + 95], h_rev[:, None, :])
        conv()
        library_ms = time_cuda(conv, 50)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    nbytes, macs = silk_upsample_work(rows, W, G, den)
    b = bound(nbytes, 0, macs)
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"# kernel silk_upsample, {label} ({rows} rows x {W} -> {G} x "
          f"{den}): {err:.3g} of the peak from its twin ({equal:.3f} of "
          f"samples bit-equal); wrapper {ms:.4f} ms (its host "
          f"enqueue {host_ms:.4f} ms), kernel alone {kernel_ms:.4f} ms, "
          f"device time (torch.profiler) {dev_txt}, twin {plain_ms:.3f} ms, "
          f"conv1d (cuDNN, TF32 off) {library_ms:.4f} ms; {nbytes} bytes, "
          f"{macs} multiply-adds, bound_ms {b['bound_ms']:.5f} "
          f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f} through the "
          f"wrapper, "
          + ("not measured" if dev_ms is None
             else f"{b['bound_ms'] / dev_ms:.3f}")
          + f" of its device time [{card}]")
    return {"max_abs_err": err * peak, "rel_err": err, "ms": ms,
            "kernel_ms": kernel_ms, "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, **b, "library_ms": library_ms,
            "share": b["bound_ms"] / ms, "bit_equal": equal == 1.0}


def phase_silk_kernel(card, kept):
    """K13 at the SILK slice's first step (its arguments kept) and at
    SILK_BIG_ROWS random rows of a 20 ms step for each of den 6, 4, 3."""
    import torch
    from audio_formats_torch.ops import resample

    args, kw = kept
    x, taps, G = args[:3]
    res = time_silk_upsample(card, "the SILK slice's first step", x, taps,
                             G)
    rng = np.random.default_rng(13)
    t = resample._fit_tables()
    big = {}
    for bw, key in enumerate(("h_nb", "h_mb", "h_wb")):
        h = resample.pack_taps(np.asarray(t[key], np.float64)[:, ::-1])
        den = h.shape[0]
        G = 960 // den
        xb = torch.from_numpy((rng.standard_normal(
            (SILK_BIG_ROWS, G + 95)) * 3000).astype(np.float32)).cuda()
        r = time_silk_upsample(card, f"random rows, den {den}", xb, h, G)
        big[f"{SILK_BIG_ROWS}x{G}x{den}"] = {k: r[k] for k in (
            "ms", "kernel_ms", "device_ms", "bound_ms", "plain_ms",
            "library_ms", "rel_err", "bit_equal")}
    res["large"] = big
    return res


def deemph_work(B, n):
    """(bytes) of K12b: x and m0 read once, y and m written once."""
    return 4 * (2 * B * n + 2 * B)


def time_deemph(card, B, n, rng):
    """K12b alone at [B, n]: within DEEMPH_TOL of the peak of its twin on
    the card, timed through its wrapper, alone, by its device time and its
    host enqueue, beside its bound and the twin (no PyTorch call computes
    a linear recurrence: library_ms is null)."""
    import torch
    from audio_formats_torch.ops import celt_dsp

    x = torch.from_numpy(rng.uniform(-8000, 8000, (B, n)).astype(
        np.float32)).cuda()
    m0 = torch.from_numpy(rng.uniform(-8000, 8000, B).astype(
        np.float32)).cuda()
    y, m = celt_dsp.deemphasis_scan(x, m0)
    torch.cuda.synchronize()
    want = []
    plain_ms = time_cuda(lambda: want.append(
        celt_dsp.deemphasis_scan_torch(x, m0)), 1)
    wy, wm = want[0]
    err = max(float((y - wy).abs().max()) / float(wy.abs().max()),
              float((m - wm).abs().max()) / float(wm.abs().max()))
    if not err <= DEEMPH_TOL:
        raise AssertionError(f"K12b at [{B}, {n}]: {err:.3g} of the peak "
                             "from its twin")
    equal = float((y == wy).float().mean())
    for _ in range(3):
        celt_dsp.deemphasis_scan(x, m0)
    ms = time_cuda(lambda: celt_dsp.deemphasis_scan(x, m0), 50)
    kernel_ms = time_cuda(lambda: celt_dsp.deemphasis_launch(
        x, m0, (y, m)), 50)

    def alone():
        celt_dsp.deemphasis_launch(x, m0, (y, m))

    dev_ms = device_ms(alone, "celt_deemph", per_launch=True)
    cold_ms = cold_device_ms(alone, "celt_deemph", per_launch=True)
    host_ms = time_host(lambda: celt_dsp.deemphasis_scan(x, m0))
    b = bound(deemph_work(B, n), 0, 2 * B * n)

    def shares(t):
        return ("not measured" if t is None else
                f"{t:.4f} ms, share {b['bound_ms'] / t:.3f}")

    print(f"# kernel celt_deemph, [{B}, {n}] random x (amplitude 8000) and "
          f"m0: {err:.3g} of the peak from its twin ({equal:.3f} of samples "
          f"bit-equal); wrapper {ms:.4f} ms (its host enqueue {host_ms:.4f} "
          f"ms), kernel alone {kernel_ms:.4f} ms, device time "
          f"(torch.profiler) {shares(dev_ms)} (x still in L2 from the last "
          f"launch), with the L2 flushed before each launch "
          f"{shares(cold_ms)}; twin {plain_ms:.3f} ms; bound_ms "
          f"{b['bound_ms']:.5f} ({b['bound_by']}), share "
          f"{b['bound_ms'] / ms:.3f} through the wrapper [{card}]")
    return {"max_abs_err": err * float(wy.abs().max()), "rel_err": err,
            "ms": ms, "kernel_ms": kernel_ms, "device_ms": dev_ms,
            "cold_device_ms": cold_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, **b, "library_ms": None,
            "share": b["bound_ms"] / ms}


def kernel_sequence(fn, reps=5):
    """The names of the kernels and device copies that `reps` calls of
    `fn` run on the card, in the order they started: torch.profiler's
    device events of those calls (``traced``)."""
    from torch.autograd import DeviceType

    evts = [e for e in traced(fn, reps).events()
            if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(evts, key=lambda e: e.time_range.start)]


def deemph_chain(card, rows, rng):
    """The JAX bench's device CELT synthesis (bench.py:800-810): for
    DEEMPH_FRAMES frames of random long-block spectra, celt_imdct_ola (the
    IMDCT matmul into the packed buffer, then K12a in place) and
    deemphasis_scan (K12b, which reads the output columns of the packed
    buffer by row stride), the tail and the memory m carried from frame to
    frame (the tail copied out of the packed buffer after K12b), counted
    from 0 just before the run; then the same chain with the twins, held
    within DEEMPH_TOL of the peak.  One frame's kernels, in order, must
    run K12b right after K12a, with no copy between.  Returns (K12b's
    launches in the kernel chain, ms a frame (the median of five chains),
    that frame's kernels, the card's work a frame by torch.profiler)."""
    import torch
    from audio_formats_torch.ops import celt_dsp

    X = torch.from_numpy((rng.standard_normal((DEEMPH_FRAMES, rows, 960))
                          * 400).astype(np.float32)).cuda()
    tail0 = torch.zeros((rows, 60), device="cuda")
    m0 = torch.zeros(rows, device="cuda")

    def frame(imdct_ola, deemph, k, tail, m):
        # raw and the new tail are column slices of one packed buffer:
        # K12b takes raw's rows by stride, K12a a contiguous tail
        raw, tail = imdct_ola(X[k], tail, 1, 960)
        y, m = deemph(raw, m)
        return y, tail.contiguous(), m

    def chain(imdct_ola, deemph):
        tail, m, ys = tail0, m0, []
        for k in range(DEEMPH_FRAMES):
            y, tail, m = frame(imdct_ola, deemph, k, tail, m)
            ys.append(y)
        return torch.stack(ys), m

    # frames in a row, each from a K12a to the next: in every frame whose
    # K12b the trace holds (TRACE_TRIES traces until one holds a frame),
    # K12b must be the kernel right after K12a
    for _ in range(TRACE_TRIES):
        seq = kernel_sequence(lambda: frame(
            celt_dsp.celt_imdct_ola, celt_dsp.deemphasis_scan, 0, tail0,
            m0))
        at = [i for i, name in enumerate(seq) if "celt_ola_kernel" in name]
        frames = [seq[a:b] for a, b in zip(at, at[1:])
                  if any("celt_deemph" in name for name in seq[a:b])]
        if frames:
            break
    if not frames or any("celt_deemph" not in f[1] for f in frames):
        raise AssertionError(f"chain frames at {rows} rows do not run K12b "
                             f"right after K12a: {seq}")
    seq = frames[0]
    chain(celt_dsp.celt_imdct_ola, celt_dsp.deemphasis_scan)
    torch.cuda.synchronize()
    celt_dsp.DEEMPH_LAUNCHES = 0
    celt_dsp.OLA_LAUNCHES = 0
    got = [chain(celt_dsp.celt_imdct_ola, celt_dsp.deemphasis_scan)]
    launches = celt_dsp.DEEMPH_LAUNCHES
    ola = celt_dsp.OLA_LAUNCHES
    runs = [time_cuda(lambda: chain(celt_dsp.celt_imdct_ola,
                                    celt_dsp.deemphasis_scan), 1)
            for _ in range(5)]
    ms = float(np.median(runs))
    dev = device_ms(lambda: chain(celt_dsp.celt_imdct_ola,
                                  celt_dsp.deemphasis_scan), "", 3)
    want = []
    plain_ms = time_cuda(lambda: want.append(chain(
        celt_dsp.celt_imdct_ola_torch, celt_dsp.deemphasis_scan_torch)), 1)
    (gy, gm), (wy, wm) = got[0], want[0]
    err = max(float((gy - wy).abs().max()) / float(wy.abs().max()),
              float((gm - wm).abs().max()) / float(wm.abs().max()))
    if not err <= DEEMPH_TOL:
        raise AssertionError(f"K12a+K12b chain at {rows} rows: {err:.3g} of "
                             "the peak from the twins' chain")
    if launches != DEEMPH_FRAMES or ola != DEEMPH_FRAMES:
        raise AssertionError(f"chain launches K12b {launches}, K12a {ola}")
    print(f"# CELT synthesis chain (bench.py:800-810), {rows} rows x "
          f"{DEEMPH_FRAMES} frames of 960 (random spectra): IMDCT matmul, "
          f"K12a and K12b a frame, tail and m carried; {err:.3g} of the peak "
          f"from the twins' chain; {ms / DEEMPH_FRAMES:.4f} ms a frame (the "
          f"median of five chains: "
          f"{[round(r / DEEMPH_FRAMES, 4) for r in runs]}), the card's "
          f"work (torch.profiler, every kernel and copy of three chains) "
          + ("not measured" if dev is None
             else f"{dev / DEEMPH_FRAMES:.4f} ms a frame")
          + f", the twins' chain {plain_ms / DEEMPH_FRAMES:.3f} ms a frame; "
          f"K12b launches {launches}, K12a {ola}; a frame's device work "
          f"in order from K12a "
          f"{[name[:40] for name in seq]}, no copy between K12a and K12b "
          f"[{card}]")
    return (launches, ms / DEEMPH_FRAMES, seq,
            None if dev is None else dev / DEEMPH_FRAMES)


def phase_deemph_kernel(card):
    """K12b alone at DEEMPH_SHAPES, then chained after K12a at each row
    count.  Returns (its result at bench.py:731's 512 rows, the launches
    of the 512-row chain)."""
    rng = np.random.default_rng(85)
    res = None
    chains = {}
    for B, n in DEEMPH_SHAPES:
        r = time_deemph(card, B, n, rng)
        if res is None:
            res = r
        else:
            res.setdefault("large", {})[f"{B}x{n}"] = {k: r[k] for k in (
                "ms", "kernel_ms", "device_ms", "cold_device_ms", "bound_ms",
                "plain_ms", "rel_err")}
        chains[B] = deemph_chain(card, B, rng)
    res["chain_ms_a_frame"] = {str(B): c[1] for B, c in chains.items()}
    res["chain_device_ms_a_frame"] = {str(B): c[3]
                                      for B, c in chains.items()}
    return res, chains[DEEMPH_SHAPES[0][0]][0]


def phase_mixed_threshold(card):
    """The mixed group's CELT answers on the host and on the device, at
    MIXED_PROBE lanes of mode tours (50 packets, 1 s): each size's wall
    with OPUS_MIXED_DEVICE_MIN_LANES set so that the group takes the host
    path and then the device path, in turns (host, device, device, host),
    the two outputs within OPUS_TOL of the peak of each other."""
    from audio_formats_torch import BatchDecoder
    import torch_opus_speech_cases as sc
    from audio_formats_torch.parallel.groups import opus as opus_groups

    ref = golden_opus_ref()
    tours = [m for m, k in zip(sc.load(), sc.kinds()) if k == "tour"]
    saved = opus_groups.OPUS_MIXED_DEVICE_MIN_LANES
    walls = {}
    try:
        for n in MIXED_PROBE:
            streams = [sc.stream(ref.build_ogg_opus, tours[i % 2], 50,
                                 preskip=(0, 312)[i % 2]) for i in range(n)]
            outs = {}
            for path in ("host", "device", "device", "host"):
                opus_groups.OPUS_MIXED_DEVICE_MIN_LANES = \
                    n + 1 if path == "host" else 1
                dec = BatchDecoder(streams, device="cuda")
                t0 = time.perf_counter()
                outs[path] = dec.decode_all()
                walls.setdefault((n, path), []).append(
                    time.perf_counter() - t0)
            for a, b in zip(outs["host"], outs["device"]):
                e = float(np.abs(a - b).max() / (np.abs(a).max() + 1e-12))
                if not e <= OPUS_TOL:
                    raise AssertionError(f"mixed group at {n} lanes: device "
                                         f"path {e:.3g} of the peak from the "
                                         "host path")
    finally:
        opus_groups.OPUS_MIXED_DEVICE_MIN_LANES = saved
    print("# mixed Opus group, host against device CELT answers (50-packet "
          "mode tours, walls in s, host/device/device/host): " + "; ".join(
              f"{n} lanes host {walls[(n, 'host')]} device "
              f"{walls[(n, 'device')]}" for n in MIXED_PROBE)
          + f" [{card}]")
    return walls


# --------------------------------------------------------------- facade
def facade_vorbis(packets):
    """The facade phase's Vorbis track: a stereo coupled stream (block
    sizes 512/2048) of the golden builder, `packets` packets."""
    import torch_stream_cases

    return torch_stream_cases.vorbis_stream(golden_vorbis_ref(), 0, packets)


def facade_submit(pool):
    """Start the facade phase's slow tracks in the pool: the MP3 masters,
    the Vorbis track and the FLAC track's frames in pieces.  Returns the
    futures (facade_tracks takes them)."""
    pcm = flac_master_pcm(0, MP3_SECONDS * FACADE_MP3_PIECES)
    n_blocks = -(-len(pcm) // BLOCK)
    step = -(-n_blocks // FACADE_FLAC_PIECES)
    return {
        "mp3": pool.map(mp3_master, range(100, 100 + FACADE_MP3_PIECES),
                        [MP3_SECONDS] * FACADE_MP3_PIECES),
        "vorbis": pool.submit(facade_vorbis, FACADE_VORBIS_PACKETS),
        "flac": [pool.submit(flac_frames, pcm[b * BLOCK:
                                               (b + step) * BLOCK]
                             .astype(np.int16), b)
                 for b in range(0, n_blocks, step)],
        "pcm": pcm,
    }


def facade_tracks(futures):
    """The facade phase's tracks: {format: (bytes, the independent
    reference or None)}.  FLAC and WAV: flac_master's 180 s (its frames
    from the pool) and its PCM as the reference; MP3: 10 masters of 18 s
    (Layer III frames with no reservoir concatenate into one stream), the
    reference mp3_ref.decode_mono's, each master's first two granules
    decoded again after the last two of the one before; Vorbis: the
    golden builder's stream; Opus: the packets of the four stereo masters
    of the committed libopus corpus in turn; MOD and XM: songs of
    tests/torch_stream_cases.py (QOA is encoded on the card by
    phase_facade)."""
    import torch_pcm_cases
    import torch_opus_cases
    import torch_stream_cases

    from golden import wav_ref

    pcm = futures["pcm"]
    flac = flac_header(len(pcm)) + b"".join(
        f.result() for f in futures["flac"])
    wav = wav_ref.build_wav(pcm.astype("<i2").tobytes(), fmt_tag=1,
                            channels=2, sample_rate=SR, bits=16)
    mp3_ref = golden_mp3_ref()
    masters = list(futures["mp3"])
    refs = [masters[0][3]]
    for prev, cur in zip(masters, masters[1:]):
        warm = mp3_ref.decode_mono(
            list(np.concatenate([prev[1][-2:], cur[1][:2]]).astype(
                np.int64)), global_gain=MP3_GAIN,
            block_types=[int(b) for b in np.concatenate([prev[2][-2:],
                                                         cur[2][:2]])])
        refs.append(np.concatenate([warm[2 * 576:], cur[3][2 * 576:]]))
    mono = np.concatenate(refs)
    opus_ref = golden_opus_ref()
    stereo = [m for m in torch_opus_cases.load() if m[0] == 2]
    opus = torch_opus_cases.stream(
        opus_ref.build_ogg_opus,
        (2, stereo[0][1], [p for m in stereo for p in m[2]]))
    return {
        "flac": (flac, expected_f32(pcm, 16)),
        "wav": (wav, torch_pcm_cases.int_pcm_to_float_np(
            pcm.reshape(-1), "s16").reshape(-1, 2)),
        "mp3": (b"".join(m[0] for m in masters),
                np.stack([mono, mono], axis=1)),
        "vorbis": (futures["vorbis"].result(), None),
        "opus": (opus, None),
        "mod": (torch_stream_cases.mod_song(0, FACADE_ORDERS), None),
        "xm": (torch_stream_cases.xm_song(0, FACADE_ORDERS), None),
    }


def facade_read(stream, frames=None):
    """`frames` frames of an open AudioStream (every frame when None), read
    in FACADE_CHUNK chunks; raises on its sticky error."""
    parts, got = [], 0
    while frames is None or got < frames:
        c = stream.read_samples_float(
            FACADE_CHUNK if frames is None else min(FACADE_CHUNK,
                                                    frames - got))
        if c.shape[0] == 0:
            break
        parts.append(c)
        got += c.shape[0]
    if stream.is_error():
        raise AssertionError(f"facade read: {stream.error_message()}")
    return np.concatenate(parts)


def facade_cpu(job, *args):
    """`job(*args)` on the CPU on one thread, in the phase's process pool.
    Returns (its result, its seconds)."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    return job(*args), time.perf_counter() - t0


def facade_cpu_read(data, start=0, frames=None):
    """The port's facade on the CPU, AudioStream(device="cpu"): `frames`
    frames from frame `start` (a seek_position there), read in
    FACADE_CHUNK chunks."""
    from audio_formats_torch import AudioStream

    s = AudioStream("cpu").open_from_memory(data)
    if s.is_error() or (start and not s.seek_position(start)):
        raise AssertionError(f"CPU facade open/seek: {s.error_message()}")
    return facade_read(s, frames)


def facade_encode(device, pcm, fmt, options):
    """AudioStream(device).open_to_buffer(fmt, ...) fed `pcm` in
    FACADE_CHUNK writes, as transcode does; the encoded bytes."""
    from audio_formats_torch import AudioStream

    s = AudioStream(device).open_to_buffer(fmt, SR, pcm.shape[1], options)
    for k in range(0, len(pcm), FACADE_CHUNK):
        if s.write_samples_float(pcm[k: k + FACADE_CHUNK]) == 0:
            raise AssertionError(f"{fmt} encode: {s.error_message()}")
    out = s.finalize_and_get_encoded_result()
    if out is None:
        raise AssertionError(f"{fmt} encode: {s.error_message()}")
    return out


def facade_to_wav(device, pcm):
    """to_wav(pcm) on `device`, as s16 with TPDF dither (K10 on the card)."""
    from audio_formats_torch import AudioSampleFormat, EncodingOptions, to_wav

    return to_wav(pcm, SR, pcm.shape[1], EncodingOptions(
        sample_format=AudioSampleFormat.s16, enable_dither=True),
        device=device)


def facade_s24():
    from audio_formats_torch import AudioSampleFormat, EncodingOptions

    return EncodingOptions(sample_format=AudioSampleFormat.s24,
                           enable_dither=True)


def facade_cpu_jobs(pool, tracks, card_pcm):
    """The CPU facade's reads and encodes, submitted to `pool`: every
    track of Vorbis, Opus, WAV, MOD and XM; the first FACADE_CPU_SECONDS
    of FLAC and QOA; MP3 in three pieces of FACADE_CPU_SECONDS from seeks
    at a third and two thirds; the first FACADE_CPU_SECONDS of the FLAC
    track's card decode as dithered s24 WAV and by to_wav, and its first
    FACADE_QOA_CPU_FRAMES frames as QOA.  Returns {key: [(start, future)]}
    (start: the first frame of the card's PCM a read holds)."""
    n = FACADE_CPU_SECONDS * SR // FACADE_CHUNK * FACADE_CHUNK
    head = card_pcm["flac"][:n]
    jobs = {
        "wav_s24": [(0, pool.submit(facade_cpu, facade_encode, "cpu", head,
                                    "wav", facade_s24()))],
        "to_wav": [(0, pool.submit(facade_cpu, facade_to_wav, "cpu",
                                   head))],
        "qoa_enc": [(0, pool.submit(
            facade_cpu, facade_encode, "cpu",
            head[:FACADE_QOA_CPU_FRAMES * QOA_FRAME], "qoa", None))],
    }
    for fmt in FACADE_FORMATS:
        data = tracks[fmt][0]
        if fmt in ("flac", "qoa"):
            starts = [0]
        elif fmt == "mp3":
            total = len(card_pcm[fmt])
            starts = [0, total // 3, 2 * total // 3]
        else:
            jobs[fmt] = [(0, pool.submit(facade_cpu, facade_cpu_read,
                                         data))]
            continue
        jobs[fmt] = [(a, pool.submit(facade_cpu, facade_cpu_read, data, a,
                                     n)) for a in starts]
    return jobs


def facade_error(fmt, got, want):
    """The card's facade PCM against `want`: 0.0 where bit-equal, else the
    max abs (over the peak where FACADE_TOL says so); raises past the
    format's bound."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"facade {fmt}: PCM {got.shape}, want "
                             f"{want.shape}")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    tol, rel = FACADE_TOL.get(fmt, (0.0, False))
    if rel:
        err /= float(np.abs(want).max()) + 1e-12
    if not err <= tol:
        raise AssertionError(f"facade {fmt}: {err:.3g} from the reference "
                             f"(bound {tol:g})")
    return err


def facade_launches():
    """K1, K2, K5 and K10's counts (decode and encode)."""
    from audio_formats_torch.ops import lms, lpc, pcm

    return {"flac_lpc": lpc.KERNEL_LAUNCHES,
            "qoa_decode": lms.DECODE_LAUNCHES,
            "qoa_encode": lms.ENCODE_LAUNCHES,
            "pcm": pcm.DECODE_LAUNCHES, "pcm_encode": pcm.ENCODE_LAUNCHES}


def facade_reset():
    from audio_formats_torch.ops import lms, lpc, pcm

    lpc.KERNEL_LAUNCHES = lms.DECODE_LAUNCHES = lms.ENCODE_LAUNCHES = 0
    pcm.DECODE_LAUNCHES = pcm.ENCODE_LAUNCHES = 0


#: the kernel each format's facade read runs on the card
FACADE_KERNEL = {"flac": "flac_lpc", "wav": "pcm", "qoa": "qoa_decode"}


def facade_seek_check(fmt, stream, linear, data):
    """transcode.py's seek check on the card's stream: FACADE_SEEKS
    windows of FACADE_CHUNK at random frames re-read after seek_position,
    each equal to the linear decode (frame-exact for FLAC, WAV and QOA;
    within 1e-6, transcode's bound, for MP3 and Vorbis).  An Opus seek
    decodes from its pre-roll, which the reference does too and which is
    not the linear decode (up to 0.13 on this track, in both packages):
    there each window is held to the CPU facade's window after the same
    seek, within OPUS_TOL of the peak.  Returns the largest distance of a
    window from the linear decode."""
    from audio_formats_torch import AudioStream

    cpu = AudioStream("cpu").open_from_memory(data) if fmt == "opus" \
        else None
    rng = np.random.default_rng(1234)
    total = len(linear)
    far = 0.0
    for _ in range(FACADE_SEEKS):
        pos = int(rng.integers(0, max(1, total - FACADE_CHUNK)))
        n = min(FACADE_CHUNK, total - pos)
        if not stream.seek_position(pos):
            raise AssertionError(f"facade {fmt}: seek to {pos} refused")
        win = stream.read_samples_float(n)
        want = linear[pos: pos + n]
        if win.shape != want.shape:
            raise AssertionError(f"facade {fmt}: {win.shape} after a seek")
        far = max(far, float(np.abs(win - want).max()))
        if fmt in ("flac", "wav", "qoa"):
            ok = np.array_equal(win, want)
        elif cpu is None:
            ok = np.allclose(win, want, atol=1e-6)
        else:
            cpu.seek_position(pos)
            ref = cpu.read_samples_float(n)
            ok = ref.shape == win.shape and float(np.abs(win - ref).max()) \
                <= OPUS_TOL * (float(np.abs(ref).max()) + 1e-12)
        if not ok:
            raise AssertionError(f"facade {fmt}: the window at {pos} "
                                 "differs")
    return far


def facade_midi(path):
    """A small format-0 MIDI file: an arpeggio and a chord."""
    import struct

    trk = bytearray(b"\x00\xff\x51\x03" + (500000).to_bytes(3, "big"))
    for k, note in enumerate((60, 64, 67, 72, 76)):
        trk += bytes([0 if k == 0 else 48, 0x90, note, 100, 96, note, 0])
    trk += b"\x00\x90\x3c\x5a\x00\x40\x5a\x81\x00\x80\x3c\x00\x00\x80\x40" \
        b"\x00\x00\xff\x2f\x00"
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, 96) + b"MTrk"
                + struct.pack(">I", len(trk)) + bytes(trk))


def facade_examples(card, tracks, tmp):
    """The four ported examples on the card, as subprocesses started
    together over files written under `tmp`: transcode --check-seeking on
    the FLAC and MP3 tracks, dump_patterns on the XM, batch_decode on one
    file of each format, midi2wav on a small MIDI file.  Each must exit 0;
    every process is gone when this returns."""
    paths = {}
    for fmt, (data, _) in tracks.items():
        paths[fmt] = os.path.join(tmp, f"track.{fmt}")
        with open(paths[fmt], "wb") as f:
            f.write(data)
    facade_midi(os.path.join(tmp, "song.mid"))
    ex = os.path.join(ROOT, "examples_torch")
    runs = {
        "transcode flac": ["transcode.py", paths["flac"],
                           os.path.join(tmp, "flac.wav"), "--check-seeking"],
        "transcode mp3": ["transcode.py", paths["mp3"],
                          os.path.join(tmp, "mp3.wav"), "--check-seeking"],
        "dump_patterns xm": ["dump_patterns.py", paths["xm"],
                             os.path.join(tmp, "xm")],
        "batch_decode": ["batch_decode.py",
                         *(paths[f] for f in FACADE_FORMATS)],
        "midi2wav": ["midi2wav.py", os.path.join(tmp, "song.mid"),
                     os.path.join(tmp, "midi.wav")],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ex, argv[0]), *argv[1:],
         "--device", "cuda"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=tmp)
        for name, argv in runs.items()}
    failed = []
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=600)
            last = out.strip().splitlines()[-1] if out.strip() else ""
            print(f"#   example {name}: exit {p.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s; {last}")
            if p.returncode != 0:
                failed.append((name, out[-2000:]))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    n_dumped = len([f for f in os.listdir(tmp) if f.startswith("xm-")])
    if n_dumped != FACADE_ORDERS:
        raise AssertionError(f"dump_patterns wrote {n_dumped} files")
    print(f"# facade examples: transcode --check-seeking (FLAC, MP3), "
          f"dump_patterns (XM, {n_dumped} patterns), batch_decode (8 "
          f"files), midi2wav: all exit 0 in {time.perf_counter() - t0:.1f} "
          f"s [{card}]")


def phase_facade(card, futures):
    """The single-stream facade on the card, at the size a user's file has:
    one track a format through AudioStream(device="cuda").open_from_memory,
    read to the end in FACADE_CHUNK chunks with the launch counters set to
    0 just before; held to the CPU facade (a process pool, on the frames
    facade_cpu_jobs names) and to an independent reference; the seek check
    of transcode.py; the FLAC track's card decode encoded as dithered s24
    WAV, as QOA and by to_wav on the card, byte-equal to the CPU's where
    the CPU encodes; the four examples.  Returns the facade's launches by
    kernel."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from audio_formats_torch import AudioSampleFormat, AudioStream, \
        EncodingOptions, encode_qoa_batch

    t_phase = time.perf_counter()
    tracks = facade_tracks(futures)
    flac_pcm = futures["pcm"]
    # QOA: the FLAC track's PCM as float, encoded on the card (frames
    # held to the golden encoder in the QOA encode phase); the reference
    # an independent numpy decode
    qoa = encode_qoa_batch([(flac_pcm / 32768.0).astype(np.float32)], SR,
                           device="cuda")[0]
    tracks["qoa"] = (qoa, numpy_qoa_decode([qoa])[0].astype(np.float32)
                     * F32_RECIP)
    print(f"# facade tracks: {', '.join(f'{k} {len(v[0]) / 1e6:.1f} MB' for k, v in tracks.items())}; "
          f"assembled in {time.perf_counter() - t_phase:.1f} s")

    launches, card_pcm, rows = {}, {}, {}
    for fmt in FACADE_FORMATS:
        data, ref = tracks[fmt]
        facade_reset()
        t0 = time.perf_counter()
        s = AudioStream("cuda").open_from_memory(data)
        if s.is_error() or s.get_format().value != \
                {"vorbis": "ogg"}.get(fmt, fmt):
            raise AssertionError(f"facade {fmt}: {s.error_message()}")
        pcm = facade_read(s)
        wall = time.perf_counter() - t0
        launches[fmt] = facade_launches()
        kernel = FACADE_KERNEL.get(fmt)
        if kernel and not launches[fmt][kernel]:
            raise AssertionError(f"facade {fmt}: {kernel} never launched")
        others = {k: v for k, v in launches[fmt].items()
                  if v and k != kernel}
        if others:
            raise AssertionError(f"facade {fmt}: launched {others}")
        card_pcm[fmt] = pcm
        ref_err = None if ref is None else facade_error(fmt, pcm, ref)
        seek_far = None if fmt in ("mod", "xm") else \
            facade_seek_check(fmt, s, pcm, data)
        secs = len(pcm) / s.get_samplerate()
        s.close()
        rows[fmt] = [secs, wall, ref_err, seek_far]
        print(f"#   facade {fmt}: {secs:.1f} s of audio read in {wall:.3f} "
              f"s on the card")

    with ProcessPoolExecutor(
            max_workers=FACADE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        t0 = time.perf_counter()
        jobs = facade_cpu_jobs(pool, tracks, card_pcm)
        # meanwhile on the card: the encodes of the FLAC track's decode,
        # then the examples
        facade_reset()
        head = card_pcm["flac"][:FACADE_CPU_SECONDS * SR // FACADE_CHUNK
                                * FACADE_CHUNK]
        t1 = time.perf_counter()
        s24 = facade_encode("cuda", card_pcm["flac"], "wav", facade_s24())
        wav_wall = time.perf_counter() - t1
        tw = facade_to_wav("cuda", head)
        t1 = time.perf_counter()
        qenc = facade_encode("cuda", card_pcm["flac"], "qoa", None)
        qoa_wall = time.perf_counter() - t1
        enc_launches = facade_launches()
        if not (enc_launches["pcm_encode"] and enc_launches["qoa_encode"]):
            raise AssertionError(f"facade encodes: launches {enc_launches}")
        with tempfile.TemporaryDirectory() as tmp:
            facade_examples(card, tracks, tmp)
        cpu = {k: [(a, f.result()) for a, f in v] for k, v in jobs.items()}
        cpu_wall = time.perf_counter() - t0
    print(f"# facade CPU reads and encodes: {cpu_wall:.1f} s in "
          f"{FACADE_WORKERS} processes; each job's seconds: "
          + ", ".join(f"{k} " + "/".join(f"{r[1]:.1f}" for _, r in v)
                      for k, v in cpu.items()))

    for fmt in FACADE_FORMATS:
        err = 0.0
        for a, (got, _) in cpu[fmt]:
            err = max(err, facade_error(fmt, card_pcm[fmt][a: a + len(got)],
                                        got))
        secs, wall, ref_err, seek_far = rows[fmt]
        k = launches[fmt]
        held = sum(len(r[0]) for _, r in cpu[fmt])
        print(f"# facade {fmt}: {secs:.1f} s of audio, wall {wall:.3f} s = "
              f"{secs / wall:.1f}x realtime, launches "
              f"{ {n: v for n, v in k.items() if v} }, largest error "
              f"{err:.3g} against the CPU facade (on "
              f"{held / len(card_pcm[fmt]):.0%} of the frames)"
              + ("" if ref_err is None else
                 f", {ref_err:.3g} against the independent reference")
              + ("; no frame seek (a module)" if seek_far is None else
                 f"; {FACADE_SEEKS} seek windows passed (largest distance "
                 f"from the linear decode {seek_far:.3g})")
              + f" [{card}]")
    cw, ct, cq = (cpu[k][0][1][0] for k in ("wav_s24", "to_wav", "qoa_enc"))
    if len(cw) <= 44 or s24[44: len(cw)] != cw[44:] or tw != ct:
        raise AssertionError("facade WAV encode: card bytes != CPU bytes")
    if len(cq) <= 8 or qenc[8: len(cq)] != cq[8:]:
        raise AssertionError("facade QOA encode: the card's first frames != "
                             "the CPU's")
    print(f"# facade encodes of the FLAC track's card decode "
          f"({len(card_pcm['flac']) / SR:.1f} s): s24 dithered WAV "
          f"{len(s24)} bytes in {wav_wall:.3f} s (its first "
          f"{FACADE_CPU_SECONDS} s byte-equal to the CPU's), QOA "
          f"{len(qenc)} bytes in {qoa_wall:.3f} s (its first "
          f"{FACADE_QOA_CPU_FRAMES} frames byte-equal to the CPU's), "
          f"to_wav (s16 dithered) of its first {FACADE_CPU_SECONDS} s "
          f"byte-equal to the CPU's; launches {enc_launches} [{card}]")
    print(f"# facade phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    launches["encode"] = enc_launches
    return launches


# --------------------------------------------------------------- mesh
def jax_dryrun_items():
    """The JAX package's dryrun lanes at 4 devices
    (tests/torch_stream_cases.py dryrun_items): 4 stereo Layer III and 4
    mid/side FLAC lanes, two Layer II lanes, a SILK-only and a
    mode-switching Opus lane, two Vorbis lanes."""
    import torch_stream_cases

    silk = read_constants("test_opus_silk", ("SILK_PACKETS",))[
        "SILK_PACKETS"]
    return torch_stream_cases.dryrun_items(
        8, golden_mp3_ref(), golden_opus_ref(), golden_vorbis_ref(), silk)


def mesh_mixed_streams(qoa_lanes, vorbis_masters):
    """Phase 16's mixed set: two Layer II lanes, 4 QOA lanes, the mixed WAV
    lanes but the truncated one, two Vorbis masters, three mode tours and
    the mixed Opus lanes (CELT corpus lanes, SILK, hybrid, a tour, DTX),
    whose last is the one corrupt lane (a CELT lane with bytes flipped in
    its packets, which decodes to the end).  Returns (streams, the corrupt
    lane's index)."""
    import torch_opus_speech_cases as sc

    mp3_ref, opus_ref = golden_mp3_ref(), golden_opus_ref()
    rng = np.random.default_rng(16)
    l2 = [mp3_ref.build_mp3_l2(
        rng.integers(0, 16, (20 + 7 * k, 3, 30, 12)).tolist(),
        rng.integers(10, 60, (20 + 7 * k, 30)).tolist(), ba=4)[0]
        for k in range(2)]
    tours = [m for m, k in zip(sc.load(), sc.kinds()) if k == "tour"]
    streams = (l2 + list(qoa_lanes[:4]) + wav_mixed_streams()[:-1]
               + [m[0] for m in vorbis_masters[:2]]
               + [sc.stream(opus_ref.build_ogg_opus, tours[k % len(tours)],
                            60 + 20 * k, preskip=(0, 312)[k % 2])
                  for k in range(3)]
               + opus_mixed_streams(np.random.default_rng(77)))
    return streams, len(streams) - 1


def phase_mesh(card, flac, pcms, mp3, mp3_info, mp3_masters, qoa_lanes,
               vorbis_masters, enc_masters):
    """Phase 16: the mesh on the card, cuda:0 named MESH_SHARDS times.
    Returns each kernel's launches in the phase's sharded runs."""
    import torch
    from audio_formats_torch import (BatchDecoder, encode_qoa_batch,
                                     encode_wav_batch, entry)
    from audio_formats_torch.config import AudioSampleFormat, EncodingOptions
    from audio_formats_torch.ops import lms, pcm
    from audio_formats_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    one = make_mesh(1)
    if one.shape != {"data": 1, "model": 1} or \
            one.devices[0, 0] != torch.device("cuda", 0):
        raise AssertionError(f"make_mesh(1) gave {one}")
    mesh = make_mesh(MESH_SHARDS, data=MESH_SHARDS,
                     devices=["cuda:0"] * MESH_SHARDS)
    try:
        make_mesh(torch.cuda.device_count() + 1)
    except RuntimeError:
        pass
    else:
        raise AssertionError("make_mesh of one device more than the card "
                             "count did not raise")
    launches = {}

    def count(run):
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v

    def walls(label, d0, w0, d1, w1, extra=""):
        """Print a slice's walls: w0 and w1 lists of seconds (unsharded,
        sharded) of the same work, with the host split of d0's and d1's
        runs."""
        secs = d1.stats["decoded_seconds"]
        w0, w1 = list(w0), list(w1)
        split = "; host_ms / enqueue_ms / host_cpu_ms " + " -> ".join(
            "/".join(f"{d.stats.get(k, 0):.0f}" for k in
                     ("host_ms", "enqueue_ms", "host_cpu_ms"))
            for d in (d0, d1))
        print(f"# mesh {label}: unsharded "
              f"{' / '.join(f'{w:.3f}' for w in w0)} s wall = "
              f"{' / '.join(f'{secs / w:.1f}' for w in w0)}x realtime, "
              f"sharded over cuda:0 x {MESH_SHARDS} "
              f"{' / '.join(f'{w:.3f}' for w in w1)} s = "
              f"{' / '.join(f'{secs / w:.1f}' for w in w1)}x; windows "
              f"{d0.stats['windows']} -> {d1.stats['windows']}{split}"
              f"{extra} [{card}]")

    # full width: the FLAC slice on both wires, the MP3 slice, each in
    # turns (unsharded, sharded, sharded, unsharded); the first sharded run
    # is held to the lanes' references and to the first unsharded run
    slices = [(f"FLAC {wire} ({len(flac)} lanes, bit-equal)", flac,
               {"flac_wire": wire}, lambda i: expected_f32(pcms[i], 16),
               0.0, True) for wire in ("packed", "rice")]
    slices.append((f"MP3 ({len(mp3)} lanes)", mp3, {},
                   lambda i: mp3_lane_expected(mp3_masters, *mp3_info[i]),
                   MP3_TOL, False))
    for label, streams, kw, expect, tol, exact in slices:
        d0, w0, _, out0 = decode_run(streams, "cuda", **kw)
        d1, w1, run, out1, err = decode_checked(
            streams, expect, "cuda", tol=tol, mesh=mesh, **kw)
        worst = entry.compare_lanes(out0, out1, lambda i: exact,
                                    label=label + " lane")
        del out0, out1
        w1b = decode_run(streams, "cuda", mesh=mesh, **kw)[1]
        w0b = decode_run(streams, "cuda", **kw)[1]
        count(run)
        walls(label, d0, (w0, w0b), d1, (w1, w1b),
              "" if exact else f"; {worst:.3g} of the peak from unsharded, "
              f"max abs err {err:.3g} from mp3_ref")

    # the mixed set, a corrupt lane last; the mixed Opus group on the
    # device path under 16 lanes
    items, bad = mesh_mixed_streams(qoa_lanes, vorbis_masters)
    d0 = BatchDecoder(items, device="cuda")
    t0 = time.perf_counter()
    ref = d0.decode_all()
    w0 = time.perf_counter() - t0
    d1 = BatchDecoder(items, mesh=mesh)
    zero_launches()
    t0 = time.perf_counter()
    res = d1.decode_all(output="device")
    res.sync()
    w1 = time.perf_counter() - t0
    run = read_launches()
    check_window_launches(run, d1.stats, "packed")
    out = res.to_numpy()
    del res
    st = d1.stats
    worst = entry.compare_decoders(d0, ref, d1, out, label="mixed lane")
    if any(e is not None for i, e in enumerate(d1.errors) if i != bad):
        raise AssertionError(f"mixed set errors {d1.errors}")
    if st.get("lanes_demoted", 0) > 1:
        raise AssertionError(f"{st['lanes_demoted']} lanes demoted")
    if not 0 < st["opus_mixed_lanes"] < 16 or \
            "opus_mixed_host_rounds" in st:
        raise AssertionError("the mixed Opus group did not take the device "
                             "path under the mesh")
    count(run)
    walls(f"mixed set ({len(items)} lanes: Layer II, QOA, WAV, Vorbis, "
          "CELT, SILK, hybrid, mode tours, a corrupt lane)", d0, [w0], d1,
          [w1],
          f"; {worst:.3g} of the peak, corrupt lane {d1.errors[bad]!r}, "
          f"lanes demoted {st.get('lanes_demoted', 0)}, mixed Opus lanes "
          f"{st['opus_mixed_lanes']} on the device path")

    # the encodes at the encode slice's shape
    secs = sum(m.shape[0] for m in enc_masters) / SR
    opt = EncodingOptions(sample_format=AudioSampleFormat.s24,
                          enable_dither=True)
    for name, mod, counter, enc in (
            ("qoa_encode", lms, "ENCODE_LAUNCHES",
             lambda **kw: encode_qoa_batch(enc_masters, SR, **kw)),
            ("pcm_encode", pcm, "ENCODE_LAUNCHES",
             lambda **kw: encode_wav_batch(enc_masters, SR, opt, **kw))):
        t0 = time.perf_counter()
        want = enc(device="cuda")
        w0 = time.perf_counter() - t0
        st = {}
        setattr(mod, counter, 0)
        t0 = time.perf_counter()
        got = enc(mesh=mesh, stats=st)
        w1 = time.perf_counter() - t0
        n = getattr(mod, counter)
        if got != want:
            raise AssertionError(f"sharded {name} is not byte-equal")
        if n != st["windows"] or n < MESH_SHARDS:
            raise AssertionError(f"sharded {name}: {n} launches, windows "
                                 f"{st['windows']}")
        launches[name] = n
        print(f"# mesh {name} ({len(enc_masters)} stereo masters, "
              f"{secs:.1f} s): byte-equal; unsharded {w0:.3f} s wall = "
              f"{secs / w0:.1f}x realtime, sharded {w1:.3f} s = "
              f"{secs / w1:.1f}x, {n} launches [{card}]")

    # the dryrun on the JAX dryrun's lanes and the mixed set
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(
        MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS,
        items=jax_dryrun_items() + items)
    print(f"# mesh dryrun: {summary['lanes']} lanes in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"# mesh launches (phase 16, counted a shard): {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: this smoke test runs on the card")
    from audio_formats_torch.host import native
    from audio_formats_torch.ops import _kernels

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the C host stage did not build or load")
    print(f"# host stage loaded in {time.perf_counter() - t0:.1f} s")

    # 2. build: one nvcc per source, all started together, while the MP3
    # masters build in a process pool that is gone before any timed phase
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    names = ("flac_lpc", "qoa_lms", "mp3_huff", "flac_rice", "pcm",
             "vorbis_win", "celt_ola", "silk_upsample", "celt_deemph",
             "mp3_dsp")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=8,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        facade = facade_submit(pool)
        mp3_masters = pool.map(mp3_master, range(MP3_MASTERS))
        vorbis_masters = pool.map(vorbis_master, range(VORBIS_MASTERS))
        with ThreadPoolExecutor(max_workers=len(names)) as ex:
            list(ex.map(_kernels.build, names))
        for name in names:
            _kernels.load(name)
        print(f"# nvcc builds of {', '.join(names)}: "
              f"{time.perf_counter() - t0:.2f} s")
        mp3_masters = list(mp3_masters)
        vorbis_masters = list(vorbis_masters)
    print(f"# MP3 and Vorbis masters: {len(mp3_masters)} and "
          f"{len(vorbis_masters)}, and the facade's FLAC, MP3 and Vorbis "
          f"tracks, built {time.perf_counter() - t0:.1f} s after the builds "
          "started")
    for name, (secs, log) in _kernels.BUILD_LOG.items():
        print(f"#   {name}: nvcc {secs:.2f} s")
        for line in log.strip().splitlines():
            print(f"#   {name}: {line.strip()}")
    run_phases(card, mp3_masters, vorbis_masters, facade)


def flac_slice(streams, pcms):
    """The FLAC slice on the card (decode_checked), with the arguments of
    its first flac_lpc call kept: the slice's own window of K1, which
    phase_flac_kernel times.  Holding the tensors costs the run nothing.
    Returns (decoder, wall seconds, launches by kernel, K1's arguments)."""
    from audio_formats_torch.ops import lpc

    captured = []
    flac_lpc = lpc.flac_lpc

    def first_call(*args):
        if not captured:
            captured.extend(args)
        return flac_lpc(*args)

    lpc.flac_lpc = first_call
    try:
        dec, wall, launches, _, _ = decode_checked(
            streams, lambda i: expected_f32(pcms[i], 16), "cuda")
    finally:
        lpc.flac_lpc = flac_lpc
    return dec, wall, launches, captured


def rice_slice(streams, pcms):
    """The FLAC slice over the device-Rice wire (decode_checked), with the
    arguments of its first frame-entropy and pool-gather calls kept: the
    slice's own dispatch of K4, which phase_rice_kernel times.  Returns
    (decoder, wall seconds, launches by kernel, the kept arguments)."""
    from audio_formats_torch.ops import flac_rice

    kept = {}
    fns = {n: getattr(flac_rice, n)
           for n in ("flac_frame_entropy", "gather_frame_pool")}

    def keeping(name):
        def first_call(*args, **kw):
            kept.setdefault(name, (args, kw))
            return fns[name](*args, **kw)
        return first_call

    for name in fns:
        setattr(flac_rice, name, keeping(name))
    try:
        dec, wall, launches, _, _ = decode_checked(
            streams, lambda i: expected_f32(pcms[i], 16), "cuda",
            flac_wire="rice")
    finally:
        for name, fn in fns.items():
            setattr(flac_rice, name, fn)
    return dec, wall, launches, kept


def run_phases(card, mp3_masters, vorbis_masters, facade):
    import torch

    # 3. kernels vs twins
    kres = phase_kernel(card)
    dres, eres = phase_qoa_kernels(card)

    # 4. FLAC slice
    t0 = time.perf_counter()
    streams, pcms = build_corpus()
    print(f"# corpus: {len(streams)} lanes, "
          f"{sum(len(s) for s in streams) / 1e6:.1f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    dec, wall, launches, captured = flac_slice(streams, pcms)
    if launches["flac_lpc"] != dec.stats["windows"]:
        raise AssertionError(f"LPC launches {launches}")
    st = dec.stats
    secs = st["decoded_seconds"]
    print(f"# FLAC slice: {len(streams)} lanes bit-exact, {secs:.1f} s of "
          f"audio in {wall:.3f} s wall = {secs / wall:.1f}x realtime; "
          f"h2d_bytes {st['h2d_bytes']}, windows {st['windows']}, "
          f"LPC launches {launches['flac_lpc']}, host_ms "
          f"{st['host_ms']:.0f}, enqueue_ms {st['enqueue_ms']:.0f} [{card}]")

    fres = phase_flac_kernel(card, captured)
    del captured

    # 4b. the FLAC slice over the device-Rice wire, and K4 at its first
    # dispatch
    rdec, rwall, rlaunches, kept = rice_slice(streams, pcms)
    rst = rdec.stats
    n_disp = rst["windows_by_format"]["flac"]
    if rlaunches["flac_rice"] != n_disp or rlaunches["flac_lpc"] != n_disp:
        raise AssertionError(f"Rice slice launches {rlaunches}, dispatches "
                             f"{n_disp}")
    if rst.get("rice_host_redo", 0):
        raise AssertionError(f"{rst['rice_host_redo']} frames of the 16-bit "
                             "corpus were decoded again on the host")
    print(f"# FLAC Rice slice: {len(streams)} lanes bit-exact, "
          f"{rst['decoded_seconds']:.1f} s of audio in {rwall:.3f} s wall = "
          f"{rst['decoded_seconds'] / rwall:.1f}x realtime; h2d_bytes "
          f"{rst['h2d_bytes']}, dispatches {n_disp}, K4 launches "
          f"{rlaunches['flac_rice']}, K1 launches {rlaunches['flac_lpc']}, "
          f"host_ms {rst['host_ms']:.0f}, enqueue_ms {rst['enqueue_ms']:.0f}, "
          f"pool build ms {rst.get('enq_flac_poolbuild_ms', 0):.1f}, host "
          f"redo {rst.get('rice_host_redo', 0)}; packed wire, same run: "
          f"{wall:.3f} s wall = {secs / wall:.1f}x, h2d_bytes "
          f"{st['h2d_bytes']}, host_ms {st['host_ms']:.0f}, enqueue_ms "
          f"{st['enqueue_ms']:.0f} [{card}]")
    rres = phase_rice_kernel(card, kept)
    del kept

    # 5. QOA encode, 6. QOA decode
    masters = qoa_masters()
    qoa_streams, enc_launches, enc_chunks = phase_qoa_encode(card, masters)
    eres.update(phase_qoa_encode_kernel(card, enc_chunks))
    del enc_chunks
    q_lanes, q_info, q_ref, dec_launches, dec_windows = phase_qoa_decode(
        card, masters, qoa_streams)
    dres.update(phase_qoa_decode_kernel(card, dec_windows))
    del dec_windows

    # 7. mixed batch: FLAC edge lanes (corrupt FLAC lane last), 8 QOA lanes
    # and a corrupt QOA lane
    rng = np.random.default_rng(99)
    e_streams, e_pcms, e_bps = edge_streams(rng, streams, pcms)
    bad_flac = len(e_streams) - 1
    bad = bytearray(q_lanes[8])
    for pos in rng.integers(len(bad) // 4, len(bad), 32):
        bad[pos] ^= 0xFF
    m_streams = e_streams + q_lanes[:8] + [bytes(bad)]
    bad_qoa = len(m_streams) - 1

    def expect(i):
        if i < bad_flac:
            return expected_f32(e_pcms[i], e_bps[i])
        mi, n = q_info[i - bad_flac - 1]
        return q_ref[mi][:n].astype(np.float32) * F32_RECIP

    mdec, _, m_launches, _, _ = decode_checked(
        m_streams, expect, "cuda", corrupt=(bad_flac, bad_qoa))
    print(f"# mixed lanes (mono 16-bit, 24-bit, 18-bit mixed host/device, "
          f"FLAC corpus, 8 QOA, a corrupt FLAC and a corrupt QOA lane): "
          f"{len(m_streams) - 2} good lanes bit-exact, corrupt lane errors "
          f"{mdec.errors[bad_flac]!r} and {mdec.errors[bad_qoa]!r}, windows "
          f"{mdec.stats['windows']}, launches {m_launches}")
    # 7b. the same batch with FLAC over the Rice wire: the 24-bit frames
    # and the 18-bit lanes' 19-bit side frames are decoded again on the host
    rmdec, _, rm_launches, _, _ = decode_checked(
        m_streams, expect, "cuda", corrupt=(bad_flac, bad_qoa),
        flac_wire="rice")
    redo = rmdec.stats.get("rice_host_redo", 0)
    wide = sum(-(-len(e_pcms[i]) // BLOCK) for i in range(bad_flac)
               if e_bps[i] == 24) + sum(
        len(e_pcms[i]) // BLOCK // 2 for i in range(bad_flac)
        if e_bps[i] == 18)
    if redo < wide:
        raise AssertionError(f"Rice wire: {redo} host redos, want at least "
                             f"the {wide} frames wider than 18 bits")
    print(f"# mixed lanes over the Rice wire: {len(m_streams) - 2} good "
          f"lanes bit-exact, {redo} frames decoded again on the host "
          f"({wide} wider than 18 bits), corrupt lane errors "
          f"{rmdec.errors[bad_flac]!r} and {rmdec.errors[bad_qoa]!r}, "
          f"truncated lanes {rmdec.stats.get('flac_truncated_lanes', 0)}, "
          f"dispatches {rmdec.stats['windows_by_format'].get('flac')}, "
          f"launches {rm_launches}")

    # 3b. the MP3 Huffman kernel, 8. the MP3 slice, 9. mixed MP3
    mp3_streams, mp3_info = mp3_corpus(mp3_masters)
    print(f"# MP3 corpus: {len(mp3_masters)} masters, {len(mp3_streams)} "
          f"lanes, {sum(len(s) for s in mp3_streams) / 1e6:.1f} MB")
    hres = phase_mp3_kernel(card, mp3_streams)
    kres14 = phase_mp3_dsp_kernel(card, mp3_streams)
    kres15 = kres14.pop("synth")
    mp3_launches, _ = phase_mp3(card, mp3_streams, mp3_info, mp3_masters)
    phase_mp3_mixed(card, streams[:4], q_lanes[:4])

    # 10. WAV decode, K10 alone, mixed WAV, 11. WAV encode
    t0 = time.perf_counter()
    w_streams, w_ints = wav_corpus()
    print(f"# WAV corpus: {len(w_streams)} lanes, "
          f"{sum(len(x) for x in w_streams) / 1e6:.1f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    wav_launches, kept = wav_slice(card, w_streams, w_ints)
    del w_streams, w_ints
    pres, pres_enc = phase_pcm_kernel(card, kept)
    del kept
    phase_wav_mixed(card)
    wenc_launches = phase_wav_encode(card, masters)

    # 12. Vorbis, and K11 at its first window
    vorbis_launches, kept = vorbis_slice(card, vorbis_masters)
    vres = phase_vorbis_kernel(card, kept)
    del kept

    # 13. Opus, K12a's two routes at their first buckets and alone at two
    # large shapes, and mixed Opus lanes
    t0 = time.perf_counter()
    o_streams, o_expect, o_celt = opus_corpus()
    print(f"# Opus corpus: {len(o_streams)} lanes, "
          f"{sum(len(x) for x in o_streams) / 1e6:.1f} MB, per-stream "
          f"references in {time.perf_counter() - t0:.1f} s")
    opus_launches, kept = opus_slice(card, o_streams, o_expect, o_celt)
    del o_streams
    ores = phase_celt_kernel(card, kept)
    del kept
    phase_opus_mixed(card)

    # 14. speech Opus: the SILK, hybrid and mode-tour slices, K13 at the
    # SILK slice's first step and alone, K12b alone and chained after
    # K12a, and the mixed group's host and device paths by lane count
    silk_l, kept = speech_slice(card, "silk", SPEECH_LANES, "silk")
    sres = phase_silk_kernel(card, kept)
    del kept
    speech_slice(card, "hybrid", SPEECH_LANES, "hybrid")
    speech_slice(card, "tour", TOUR_LANES, "mixed")
    zres, deemph_launches = phase_deemph_kernel(card)
    phase_mixed_threshold(card)

    # 15. the single-stream facade: a track of each format read on the
    # card, held to the CPU facade and an independent reference, seeks,
    # encodes, and the four examples
    fl = phase_facade(card, facade)
    del facade

    # 16. the mesh: the FLAC (both wires) and MP3 slices, a mixed set, the
    # encodes and the dryrun over cuda:0 named four times
    ml = phase_mesh(card, streams, pcms, mp3_streams, mp3_info, mp3_masters,
                    q_lanes, vorbis_masters, masters)
    del streams, pcms, mp3_streams

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "audio_formats_tpu"))
    if foreign:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{foreign[:5]}")

    print(json.dumps({"kernels": [
        {"name": "flac_lpc", "route": "cuda",
         "mesh_launches": ml["flac_lpc"],
         "source": "audio_formats_torch/csrc/flac_lpc.cu",
         "replaces": "audio_formats_tpu/ops/lpc.py:158",
         "launches": launches["flac_lpc"],
         "facade_launches": fl["flac"]["flac_lpc"], **fres, **kres},
        {"name": "qoa_decode", "route": "cuda",
         "mesh_launches": ml["qoa_decode"],
         "source": "audio_formats_torch/csrc/qoa_lms.cu",
         "replaces": "audio_formats_tpu/ops/lms.py:135",
         "launches": dec_launches,
         "facade_launches": fl["qoa"]["qoa_decode"], **dres},
        {"name": "qoa_encode", "route": "cuda",
         "mesh_launches": ml["qoa_encode"],
         "source": "audio_formats_torch/csrc/qoa_lms.cu",
         "replaces": "audio_formats_tpu/ops/lms.py:187",
         "launches": enc_launches,
         "facade_launches": fl["encode"]["qoa_encode"], **eres},
        {"name": "mp3_huff", "route": "cuda",
         "mesh_launches": ml["mp3_huff"],
         "source": "audio_formats_torch/csrc/mp3_huff.cu",
         "replaces": "audio_formats_tpu/ops/mp3_huff.py:351",
         "launches": mp3_launches, **hres},
        {"name": "mp3_dsp", "route": "cuda",
         "mesh_launches": ml["mp3_dsp"],
         "source": "audio_formats_torch/csrc/mp3_dsp.cu",
         "replaces": None, "launches": mp3_launches, **kres14},
        {"name": "mp3_synth", "route": "cuda",
         "mesh_launches": ml["mp3_synth"],
         "source": "audio_formats_torch/csrc/mp3_dsp.cu",
         "replaces": None, "launches": mp3_launches, **kres15},
        {"name": "flac_rice", "route": "cuda",
         "mesh_launches": ml["flac_rice"],
         "source": "audio_formats_torch/csrc/flac_rice.cu",
         "replaces": "audio_formats_tpu/ops/flac_rice.py:282",
         "launches": rlaunches["flac_rice"], **rres},
        {"name": "pcm", "route": "cuda",
         "mesh_launches": ml["pcm"],
         "source": "audio_formats_torch/csrc/pcm.cu",
         "replaces": "audio_formats_tpu/ops/pcm.py:81",
         "launches": wav_launches,
         "facade_launches": fl["wav"]["pcm"], **pres},
        {"name": "pcm_encode", "route": "cuda",
         "mesh_launches": ml["pcm_encode"],
         "source": "audio_formats_torch/csrc/pcm.cu",
         "replaces": "audio_formats_tpu/ops/pcm.py:235",
         "launches": wenc_launches,
         "facade_launches": fl["encode"]["pcm_encode"], **pres_enc},
        {"name": "vorbis_win", "route": "cuda",
         "mesh_launches": ml["vorbis_win"],
         "source": "audio_formats_torch/csrc/vorbis_win.cu",
         "replaces": "audio_formats_tpu/ops/vorbis_win.py:62",
         "launches": vorbis_launches, **vres},
        {"name": "celt_imdct_ola", "route": "cuda",
         "mesh_launches": ml["celt_imdct_ola"],
         "source": "audio_formats_torch/csrc/celt_ola.cu",
         "replaces": "audio_formats_tpu/ops/celt_dsp.py:46",
         "path": "K12a's fused route: blocks of 120 (short blocks, LM0)",
         "launches": opus_launches["celt_imdct_ola"],
         **ores["celt_imdct_ola"]},
        {"name": "celt_ola", "route": "cuda",
         "mesh_launches": ml["celt_ola"],
         "source": "audio_formats_torch/csrc/celt_ola.cu",
         "replaces": "audio_formats_tpu/ops/celt_dsp.py:46",
         "path": "K12a's in-place route: a long block after the IMDCT "
                 "matmul",
         "launches": opus_launches["celt_ola"], **ores["celt_ola"]},
        {"name": "silk_upsample", "route": "cuda",
         "mesh_launches": ml["silk_upsample"],
         "source": "audio_formats_torch/csrc/silk_upsample.cu",
         "replaces": "audio_formats_tpu/ops/resample.py:358",
         "launches": silk_l["silk_upsample"], **sres},
        {"name": "celt_deemph", "route": "cuda",
         "mesh_launches": ml["celt_deemph"],
         "source": "audio_formats_torch/csrc/celt_deemph.cu",
         "replaces": "audio_formats_tpu/ops/celt_dsp.py:85",
         "path": "the CELT synthesis chain of bench.py:800-810 (no decode "
                 "path runs it)",
         "launches": deemph_launches, **zres},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


SASS_PIPES = {"fma": ("IMAD", "IMUL"),
              "shared/shuffle": ("LDS", "STS", "SHFL"),
              "global/async": ("LDG", "STG", "LDGSTS", "UBLKCP", "SYNCS",
                               "DEPBAR", "FENCE", "LDGDEPBAR"),
              "control": ("BRA", "BSSY", "BSYNC", "WARPSYNC", "BAR")}


def by_pipe(ops, steps):
    """{pipe: instructions a step} of the opcodes `ops` over `steps`."""
    import collections

    count = collections.Counter()
    for o in ops:
        head = o.split(".")[0]
        count[next((p for p, heads in SASS_PIPES.items() if head in heads),
                   "alu")] += 1
    return {p: n / steps for p, n in sorted(count.items())}


def kernel_sass(tree, name="qoa_lms"):
    """The SASS (cuobjdump) of tree/audio_formats_torch/csrc/<name>.cu
    built with the kernels' nvcc flags: {function name: [(address,
    instruction)]}.  Needs nvcc and cuobjdump, not a card."""
    import tempfile

    from audio_formats_torch.ops import _kernels

    nvcc = _kernels._nvcc()
    src = os.path.join(tree, "audio_formats_torch", "csrc", name + ".cu")
    flags = [f for f in _kernels.NVCC_FLAGS + _kernels.EXTRA_FLAGS.get(name, ())
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, name + ".cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src],
                       check=True, capture_output=True, timeout=600)
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], check=True, capture_output=True, text=True,
            timeout=120).stdout
    return parse_sass(sass)


def parse_sass(sass):
    """cuobjdump -sass text -> {function name: [(address, instruction)]}."""
    import re

    funcs = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        funcs[f.split("\n")[0].strip()] = [
            (int(a, 16), i.strip()) for a, i in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", f)]
    return funcs


def _opcode(ins):
    import re

    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def k5_sass(funcs):
    """K5's instructions a candidate-step, by pipe: int16 samples, from the
    full-slice body's first shared load (the first after the tile's last
    barrier where the body has no 16-byte loads) to the arg-min's first
    shuffle (20 steps).  Returns ({pipe: count a step}, the body's opcodes
    counted)."""
    import collections

    body = next(v for k, v in funcs.items() if "qoa_encode_kernelIs" in k)
    ops = [_opcode(i) for _, i in body]
    # the full-slice body opens with its 16-byte loads where it has them
    # (the partial slice's loop is laid out before it)
    bar = max(k for k, o in enumerate(ops) if o.startswith("BAR"))
    a = next((k for k, o in enumerate(ops) if o == "LDS.128"),
             next(k for k in range(bar, len(ops)) if ops[k].startswith("LDS")))
    b = next(k for k in range(a, len(ops)) if ops[k].startswith("SHFL"))
    return by_pipe(ops[a:b], 20), collections.Counter(ops[a:b])


def _regs(ins):
    """(the register an instruction writes or None, the registers it
    reads) of one SASS instruction."""
    import re

    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    op, _, rest = ins.partition(" ")
    args = [a.strip() for a in rest.split(",")]
    writes = not op.startswith(("ST", "BRA", "BAR", "RED", "ATOM", "UBLKCP",
                                "SYNCS", "LDGSTS", "EXIT", "RET"))
    dest = None
    if writes and args and re.fullmatch(r"R\d+", args[0].split(".")[0]):
        dest, args = args[0].split(".")[0], args[1:]
    return dest, {r for a in args for r in re.findall(r"\bR\d+\b", a)}


def k2_sass(funcs):
    """K2's fused form (qoa_decode_kernel<true>, or qoa_decode_fused and its
    16-byte instance): the innermost loop that runs the most steps (two
    clamp instructions a step) is the chain loop.  Returns (steps in its
    body, {pipe: instructions a step}, the dependent instructions from one
    step's reconstructed sample to the next (the longest path, averaged
    over the body's steps), the tile loop's instructions outside the chain
    loop by pipe, the body's opcodes counted)."""
    import collections
    import re

    name = next(k for k in funcs
                if re.search(r"qoa_decode_kernelILb1E|qoa_decode_fusedILb1E",
                             k))
    body = funcs[name]
    ops = [_opcode(i) for _, i in body]
    at = {a: k for k, (a, _) in enumerate(body)}
    loops = []   # (first, last): a branch back to an earlier address
    for k, (a, i) in enumerate(body):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)",
                      re.sub(r"^@!?U?P\w+\s+", "", i))
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], k))
    clamp = ("VIMNMX", "IMNMX", "VIADDMNMX")

    def n_clamps(span):
        return sum(ops[k].split(".")[0] in clamp
                   for k in range(span[0], span[1] + 1))

    # the loop with the most steps, the innermost among equals (a tile
    # loop may hold the steps itself, and wait loops besides)
    chain = max(loops, key=lambda s: (n_clamps(s), s[0] - s[1]))
    steps = n_clamps(chain) // 2
    span = range(chain[0], chain[1] + 1)
    recon = [k for k in span if ops[k].split(".")[0] in clamp][1::2]
    lengths = []
    for a, b in zip(recon, recon[1:]):
        dist = {_regs(body[a][1])[0]: 0}
        for k in range(a + 1, b + 1):
            dest, srcs = _regs(body[k][1])
            d = [dist[r] for r in srcs if r in dist]
            if dest is not None:
                if d:
                    dist[dest] = max(d) + 1
                else:
                    dist.pop(dest, None)
        lengths.append(dist.get(_regs(body[b][1])[0], 0))
    outer = [s for s in loops if s != chain and s[0] <= chain[0]
             and chain[1] <= s[1]]
    staging = []
    if outer:
        tile = min(outer, key=lambda s: s[1] - s[0])
        nested = [s for s in loops if s != tile and tile[0] <= s[0]
                  and s[1] <= tile[1]]
        staging = [ops[k] for k in range(tile[0], tile[1] + 1)
                   if not any(s[0] <= k <= s[1] for s in nested)]
    return (steps, by_pipe([ops[k] for k in span], steps),
            sum(lengths) / max(len(lengths), 1), by_pipe(staging, 1),
            collections.Counter(ops[k] for k in span))


def _operands(ins):
    """(registers and predicates an instruction writes, those it reads) of
    one SASS instruction; a 64-bit operand Rn.64 names Rn and Rn+1."""
    import re

    guard = re.match(r"^@!?(U?P\w+)\s+", ins)
    op, _, rest = ins[guard.end() if guard else 0:].partition(" ")
    args = [a.strip() for a in rest.split(",")] if rest else []

    def regs(a):
        out = set()
        for r, wide in re.findall(r"\b(U?R\d+|U?P\d)\b(\.64)?", a):
            out.add(r)
            if wide:
                out.add(re.sub(r"\d+$", lambda m: str(int(m.group()) + 1), r))
        return out

    writes = not op.startswith(("ST", "BRA", "BAR", "RED", "ATOM", "UBLKCP",
                                "SYNCS", "LDGSTS", "EXIT", "RET", "BSSY",
                                "BSYNC", "WARPSYNC", "CCTL", "NOP",
                                "DEPBAR"))
    dests, srcs = set(), {guard.group(1)} if guard else set()
    for k, a in enumerate(args):
        first = k == 0 or (k <= 2 and re.fullmatch(r"!?U?P(\d|T)", a)
                           and op.startswith(("IADD3", "LEA", "ISETP",
                                              "LOP3", "PLOP3", "VOTE",
                                              "IMAD", "SHF", "ULEA",
                                              "UIADD3")))
        (dests if writes and first else srcs).update(regs(a))
    return dests, srcs


def sample_loop(body):
    """The sample loop of K4's SASS: of the loops (a branch back to an
    earlier address) whose own instructions, outside their nested loops,
    both count a unary run (FLO) and write the stage tile (STS), the one
    with the most FLOs, the shortest among equals.  Returns (first index,
    index of the branch back)."""
    import re

    at = {a: k for k, (a, _) in enumerate(body)}
    loops = []
    for k, (a, i) in enumerate(body):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)",
                      re.sub(r"^@!?U?P\w+\s+", "", i))
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], k))

    def own(lp, head):
        inner = [s for s in loops if s != lp and lp[0] <= s[0]
                 and s[1] <= lp[1]]
        return sum(_opcode(body[k][1]).startswith(head)
                   for k in range(lp[0], lp[1] + 1)
                   if not any(s[0] <= k <= s[1] for s in inner))

    return max(loops, key=lambda lp: (own(lp, "FLO") > 0 < own(lp, "STS"),
                                      own(lp, "FLO"), lp[0] - lp[1]))


def extreme_paths(body, head, back):
    """The shortest and the longest path, by instructions, through one
    iteration of the loop [head, back] of a function's SASS that decode a
    sample (pass a FLO instruction): from its first instruction to its
    branch back, following forward branches both ways where they are
    predicated, never a nested loop's branch back.  Returns two lists of
    instruction indices (None where no path decodes)."""
    import re

    at = {a: k for k, (a, _) in enumerate(body)}

    def succ(k):
        ins = body[k][1]
        bare = re.sub(r"^@!?U?P\w+\s+", "", ins)
        if bare.startswith("EXIT") and not ins.startswith("@"):
            return []
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)",
                      bare)
        if not m:
            return [k + 1]
        t = at.get(int(m.group(1), 16), -1)
        nxt = [t] if t > k else []         # a branch back is not followed
        if ins.startswith("@") or not re.match(r"BRA(\.\w+)*\s+0x", bare):
            nxt.append(k + 1)
        return [t for t in nxt if head <= t <= back]

    # best[k][f]: (length, next index) of the shortest / longest way from k
    # to the branch back, f: a FLO was passed before k
    out = []
    for pick in (min, max):
        best = {}
        for k in range(back, head - 1, -1):
            flo = _opcode(body[k][1]).startswith("FLO")
            for f in (False, True):
                if k == back:
                    best[k, f] = (1, None) if f or flo else None
                    continue
                ways = [(best[t, f or flo][0] + 1, t) for t in succ(k)
                        if best.get((t, f or flo)) is not None]
                best[k, f] = pick(ways) if ways else None
        if best[head, False] is None:
            out.append(None)
            continue
        path, k, f = [], head, False
        while k is not None:
            path.append(k)
            f = f or _opcode(body[k][1]).startswith("FLO")
            k = best[k, f][1] if k != back else None
        out.append(path)
    return out


def path_cost(body, path):
    """(instructions, {pipe: count}, the longest chain of
    dependent instructions from a value carried into the iteration to one
    it carries out (through registers and predicates), the loads on that
    chain) of one path."""
    ops = [_opcode(body[k][1]) for k in path]
    dist = {}   # register -> (chain length, loads on it)
    read_first, written = set(), set()
    for k in path:
        dests, srcs = _operands(body[k][1])
        read_first |= srcs - written
        d = max((dist.get(r, (0, 0)) for r in srcs), default=(0, 0))
        op = _opcode(body[k][1])
        d = (d[0] + 1, d[1] + op.startswith(("LDG", "LDS", "LD.", "LDL")))
        for r in dests:
            dist[r] = d
        written |= dests
    carried = (read_first & written) - {"PT", "RZ", "URZ", "UPT"}
    chain = max((dist[r] for r in carried), default=(0, 0))
    return len(path), by_pipe(ops, 1), chain[0], chain[1]


def k4_sass(funcs):
    """K4's sample loop: its span in the SASS, its instructions, and the
    shortest and the longest path through one iteration that decode: for
    each (instructions a sample, {pipe: instructions a sample}, dependent
    chain a sample, loads on the chain, samples on the path).  A path's
    samples are its FLO.U32 instructions, each sample's unary count."""
    # the instance with 16-byte row stores, the main path's
    names = [k for k in funcs if "flac_rice_kernel" in k]
    body = funcs[next((k for k in names if "ILb1E" in k), names[0])]
    head, back = sample_loop(body)
    paths = []
    for path in extreme_paths(body, head, back):
        n, pipes, chain, loads = path_cost(body, path)
        samples = max(sum(_opcode(body[k][1]) == "FLO.U32" for k in path), 1)
        paths.append((n / samples, {p: v / samples for p, v in pipes.items()},
                      chain / samples, loads, samples))
    return (body[head][0], body[back][0]), back - head + 1, paths


#: K10 opcodes that issue to the integer pipe (IMAD to the FMA pipe, at
#: the same rate an SM)
K10_INT_OPS = ("IADD3", "LOP3", "SHF", "LEA", "IMAD", "ISETP", "PRMT", "SEL",
               "IMNMX", "VIMNMX", "MOV", "IABS", "IMUL")


def k10_sass(funcs):
    """K10's dithered s24 quantize (pcm_quantize_kernel<2, true>): the
    instructions of one sample, from the row's last barrier to the row
    loop's branch back.  Returns (the integer-pipe instructions, the
    others, the opcodes counted)."""
    import collections
    import re

    body = next(v for k, v in funcs.items()
                if "pcm_quantize_kernelILi2ELb1E" in k)
    ops = [_opcode(i) for _, i in body]
    a = max(k for k, o in enumerate(ops) if o.startswith("BAR"))

    def target(ins):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?"
                      r"(0x[0-9a-f]+)", re.sub(r"^@!?U?P\w+\s+", "", ins))
        return int(m.group(1), 16) if m else None

    back = next(k for k in range(a, len(body))
                if (target(body[k][1]) or 1 << 62) <= body[a][0])
    span = collections.Counter(ops[a + 1:back + 1])
    n_int = sum(v for o, v in span.items() if o.split(".")[0] in K10_INT_OPS)
    return n_int, sum(span.values()) - n_int, span


def k11_sass(funcs):
    """K11's parallel path (vorbis_win_kernel): of its loops, the one whose
    own instructions, outside nested loops, hold the most 16-byte global
    loads: the PCM row's loop.  Returns (its instructions, the 16-byte
    vectors it stores a trip, the opcodes counted)."""
    import collections
    import re

    body = next(v for k, v in funcs.items() if "vorbis_win_kernel" in k)
    at = {a: k for k, (a, _) in enumerate(body)}
    loops = []
    for k, (a, i) in enumerate(body):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)",
                      re.sub(r"^@!?U?P\w+\s+", "", i))
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], k))

    def own(lp):
        inner = [s for s in loops if s != lp and lp[0] <= s[0]
                 and s[1] <= lp[1]]
        return collections.Counter(
            _opcode(body[k][1]) for k in range(lp[0], lp[1] + 1)
            if not any(s[0] <= k <= s[1] for s in inner))

    def wide(ops, head):
        return sum(n for o, n in ops.items()
                   if o.startswith(head) and ".128" in o)

    best = max(loops, key=lambda lp: (wide(own(lp), "LDG"), lp[0] - lp[1]))
    ops = own(best)
    return sum(ops.values()), wide(ops, "STG"), ops


def k13_sass(funcs):
    """K13's multiply-adds and what feeds them: for each silk_upsample
    kernel (one a den in this tree), over the whole function, its FFMAs,
    those of them whose tap comes from the constant bank (a c[] operand,
    or a uniform register that a ULDC loaded from it), its ULDCs and its
    shared loads.  Returns {function: (FFMA, FFMA with a constant tap,
    ULDC, LDS)}."""
    import re

    out = {}
    for name, body in funcs.items():
        if "silk_upsample_kernel" not in name:
            continue
        ops = [(_opcode(i).split(".")[0], i) for _, i in body]
        ffma = [i for o, i in ops if o == "FFMA"]
        out[name] = (len(ffma),
                     sum(bool(re.search(r"c\[|\bUR\d", i)) for i in ffma),
                     sum(o == "ULDC" for o, _ in ops),
                     sum(o == "LDS" for o, _ in ops))
    return out


def k12b_sass(funcs):
    """K12b's loops that read x (celt_deemph_kernel's outermost loops
    that hold a global load): for each, its instructions (static, nested
    loops included), the samples a thread steps a trip (4 a 16-byte load
    where the loop has them: the tile's vector path; else one a 4-byte
    load) and its global loads and stores by width.  Returns
    [(instructions, samples, {"LDG128": count, ...})]."""
    import collections
    import re

    body = next(v for k, v in funcs.items() if "celt_deemph_kernel" in k)
    at = {a: k for k, (a, _) in enumerate(body)}
    loops = []
    for k, (a, i) in enumerate(body):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)",
                      re.sub(r"^@!?U?P\w+\s+", "", i))
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], k))
    out = []
    for lo, hi in sorted(loops):
        if any(o != (lo, hi) and o[0] <= lo and hi <= o[1] for o in loops):
            continue
        ops = [_opcode(body[k][1]) for k in range(lo, hi + 1)]
        mem = collections.Counter(
            o.split(".")[0] + ("128" if ".128" in o else "64" if ".64" in o
                               else "32")
            for o in ops if o.startswith(("LDG", "STG")))
        if any(k.startswith("LDG") for k in mem):
            samples = 4 * mem["LDG128"] or mem["LDG32"] + 2 * mem["LDG64"]
            out.append((len(ops), samples, dict(mem)))
    return out


def print_sass(trees):
    """--sass [DIR ...]: K5's, K2's, K4's, K10's, K11's, K13's and K12b's
    SASS counts, this tree's and each DIR's."""
    for tree in (ROOT, *trees):
        funcs = kernel_sass(tree)
        per_step, ops = k5_sass(funcs)
        print(f"# K5 SASS, {tree}: {sum(per_step.values()):.2f} instructions "
              f"a candidate-step, by pipe {per_step}; "
              f"{dict(ops.most_common())}")
        steps, per_step, chain, staging, ops = k2_sass(funcs)
        print(f"# K2 SASS, {tree}: chain loop of {steps} steps, "
              f"{sum(per_step.values()):.2f} instructions a step, by pipe "
              f"{per_step}; {chain:.2f} dependent instructions from one "
              f"reconstructed sample to the next; the tile loop's "
              f"instructions outside the chain loop "
              f"{sum(staging.values()):.0f}, by pipe {staging}; "
              f"{dict(ops.most_common())}")
        span, n, paths = k4_sass(kernel_sass(tree, "flac_rice"))
        for label, (ins, pipes, chain, loads, samples) in zip(
                ("shortest", "longest"), paths):
            print(f"# K4 SASS, {tree}: sample loop {span[0]:#x}-{span[1]:#x}"
                  f" ({n} instructions); its {label} path that decodes "
                  f"({samples} samples): {ins:.2f} instructions a sample, by "
                  f"pipe { {p: round(v, 2) for p, v in pipes.items()} }; "
                  f"{chain:.2f} dependent instructions a sample from the "
                  f"values carried in to those carried out, {loads} loads "
                  f"on that chain")
        if os.path.exists(os.path.join(tree, "audio_formats_torch", "csrc",
                                       "pcm.cu")):
            n_int, n_other, ops = k10_sass(kernel_sass(tree, "pcm"))
            print(f"# K10 SASS, {tree}: dithered s24 quantize, "
                  f"{n_int} integer-pipe instructions a sample (the bound "
                  f"counts {DITHER_INT_OPS}), {n_other} others; "
                  f"{dict(ops.most_common())}")
        if os.path.exists(os.path.join(tree, "audio_formats_torch", "csrc",
                                       "vorbis_win.cu")):
            n, vecs, ops = k11_sass(kernel_sass(tree, "vorbis_win"))
            print(f"# K11 SASS, {tree}: the PCM row's loop, {n} "
                  f"instructions, {vecs} 16-byte vectors stored a trip = "
                  f"{n / max(vecs, 1):.2f} instructions a vector; "
                  f"{dict(ops.most_common())}")
        if os.path.exists(os.path.join(tree, "audio_formats_torch", "csrc",
                                       "silk_upsample.cu")):
            for fn, (ffma, const, uldc, lds) in k13_sass(
                    kernel_sass(tree, "silk_upsample")).items():
                print(f"# K13 SASS, {tree}, {fn}: {ffma} FFMA, {const} of "
                      f"them with the tap from the constant bank, {uldc} "
                      f"ULDC, {lds} shared loads: {lds / max(ffma, 1):.3f} "
                      f"shared loads and {const / max(ffma, 1):.3f} "
                      f"constant taps an FFMA")
        if os.path.exists(os.path.join(tree, "audio_formats_torch", "csrc",
                                       "celt_deemph.cu")):
            for ins, samples, mem in k12b_sass(kernel_sass(tree,
                                                           "celt_deemph")):
                w = "128" if mem.get("LDG128") else "32"
                vecs = samples / 4
                print(f"# K12b SASS, {tree}: a loop that reads x, {ins} "
                      f"instructions (static: nested loops and the ragged "
                      f"path's code included) for {samples} samples a "
                      f"thread a trip = {ins / max(samples, 1):.2f} a "
                      f"sample; global loads and stores {mem}: on its "
                      f"{w}-bit path {mem.get('LDG' + w, 0) / vecs:.2f} "
                      f"loads and {mem.get('STG' + w, 0) / vecs:.2f} stores "
                      f"per 16 bytes")


AB_KERNELS = ("mp3_huff", "flac_lpc", "qoa_encode", "qoa_decode",
              "flac_rice", "vorbis_win", "silk_upsample", "celt_ola",
              "celt_deemph")


def ab_compare(parent, names=AB_KERNELS):
    """--ab PARENT [NAME ...]: K3, K1, K5, K2, K4, K11, K13, K12a and K12b
    of this tree (or those NAMEd; K13, K12a and K12b in
    ``ab_silk_upsample``, ``ab_celt_ola`` and ``ab_celt_deemph``) against
    the kernels built from
    PARENT/audio_formats_torch/csrc (an earlier commit's sources, called
    through the C entries and wrappers they had then), in one process on
    one card, in turns parent / change / change / parent: K3's wrapper and
    launch alone at one 98,304-lane window of the MP3 slice (its frame
    pool; the parent's kernel given this tree's plan), then, where PARENT
    holds the earlier commit's whole tree, that tree's own K3 phase and
    MP3 slice (its wire, its h2d_bytes), imported in the same process as
    parent_audio_formats_torch, beside this tree's; K11's wrapper, launch alone and device time at the Vorbis
    slice's first window, with the largest difference between the two;
    K1's at the FLAC slice's first
    window and at the random-lane window of phase_kernel, K5 at the random
    chunk of phase_qoa_kernels and at the QOA encode slice's first (full)
    and last (tail) chunks, K2's wrapper and launch alone at the random
    window of phase_qoa_kernels and at the QOA decode slice's first and
    last windows, and its int32 form at the random window, K4's wrapper,
    launch alone and first 32 lanes alone (one warp) at the FLAC Rice
    slice's first dispatch.  Each pair is first held equal, bit for bit
    (K11 within VORBIS_TOL of the peak, its largest difference printed).
    Then the MP3, FLAC, QOA encode, QOA decode, FLAC Rice and Vorbis slices
    with either side's kernel, in turns.  Prints one line a measurement and
    the card; no result line."""
    import ctypes
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from audio_formats_torch.ops import (_kernels, flac_rice, lms, lpc, mdct,
                                         mp3_huff, vorbis_win)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: the comparison runs on the card")
    unknown = set(names) - set(AB_KERNELS)
    if unknown:
        raise ValueError(f"--ab: no kernel {sorted(unknown)}; "
                         f"choose from {AB_KERNELS}")
    card = card_line()
    print(card)
    V, I = ctypes.c_void_p, ctypes.c_int
    old_entries = {"flac_lpc": ("af_flac_lpc", [V] * 6 + [I, I, V]),
                   "mp3_huff": ("af_mp3_huff", [V] * 5 + [I, I, I, V, V, V]),
                   "vorbis_win": ("af_vorbis_win", [V] * 14 + [I] * 5 + [V]),
                   "qoa_encode": ("af_qoa_encode",
                                  [V, I, V, V, V, V, V, V, I, V]),
                   "qoa_decode": ("af_qoa_decode", [V] * 6 + [I, I, V]),
                   "flac_rice": ("af_flac_rice",
                                 [V, I, V, V, V, V, I, I, I] + [V] * 6),
                   "silk_upsample": ("af_silk_upsample", [V] * 3 + [I] * 4
                                     + [V]),
                   "celt_ola": ("af_celt_ola", [V] * 5 + [I] * 3 + [V]),
                   "celt_deemph": ("af_celt_deemph", [V] * 4 + [
                       I, I, ctypes.c_float, V])}
    sources = {"flac_lpc": "flac_lpc", "mp3_huff": "mp3_huff",
               "qoa_encode": "qoa_lms", "qoa_decode": "qoa_lms",
               "flac_rice": "flac_rice", "vorbis_win": "vorbis_win",
               "silk_upsample": "silk_upsample", "celt_ola": "celt_ola",
               "celt_deemph": "celt_deemph"}

    def build_parent(name):
        src = os.path.join(parent, "audio_formats_torch", "csrc",
                           sources[name] + ".cu")
        out = os.path.join(os.path.abspath(parent), "build", name + ".so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                        *_kernels.EXTRA_FLAGS.get(sources[name], ()), "-o",
                        out, src], check=True, capture_output=True,
                       timeout=600)
        fn = getattr(ctypes.CDLL(out), old_entries[name][0])
        fn.argtypes, fn.restype = old_entries[name][1], ctypes.c_int
        return fn

    names = [n for n in AB_KERNELS if n in names]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=8, mp_context=ctx) as pool:
        if "mp3_huff" in names:
            mp3_masters = pool.map(mp3_master, range(MP3_MASTERS))
        if "vorbis_win" in names:
            vorbis_masters = pool.map(vorbis_master, range(VORBIS_MASTERS))
        with ThreadPoolExecutor(max_workers=2 * len(names)) as ex:
            olds = dict(zip(names, ex.map(build_parent, names)))
            list(ex.map(_kernels.build, {sources[n] for n in names}))
        if "mp3_huff" in names:
            mp3_masters = list(mp3_masters)
        if "vorbis_win" in names:
            vorbis_masters = list(vorbis_masters)
    dev = torch.device("cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def turns(label, parent_fn, change_fn, reps=20):
        for fn in (parent_fn, change_fn):
            for _ in range(3):
                fn()
        t = [time_cuda(fn, reps) for fn in (parent_fn, change_fn, change_fn,
                                            parent_fn)]
        print(f"# ab {label}: parent {t[0]:.4f} ms, change {t[1]:.4f} ms, "
              f"change {t[2]:.4f} ms, parent {t[3]:.4f} ms [{card}]")

    # the parent's wrappers: q and err (or out, or the word plane and
    # states) from torch.empty; `out` given: the launch alone.  K3's takes
    # this tree's plan (the frame pool's offsets and the lane order): the
    # parent's plan addressed a pool of lane rows
    def huff_old(pool_d, meta_d, Wd, lpf=1, offs=None, perm=None, out=None):
        Ld = meta_d.shape[0]
        if offs is None:
            offs, perm = mp3_huff.huff_plan_cuda(meta_d, lpf)
        q_d, e_d = out or (torch.empty((Ld, 576), dtype=torch.int32,
                                       device=dev),
                           torch.empty(Ld, dtype=torch.bool, device=dev))
        _kernels.check_launch("old huff", olds["mp3_huff"](
            pool_d.data_ptr(), offs.data_ptr(), meta_d.data_ptr(),
            perm.data_ptr(), blob.data_ptr(), blob.shape[0], Ld, Wd,
            q_d.data_ptr(), e_d.data_ptr(), stream()))
        return q_d, e_d

    def lpc_old(residual, coeffs, order, shift, exact, out=None):
        out = torch.empty_like(residual) if out is None else out
        _kernels.check_launch("old lpc", olds["flac_lpc"](
            residual.data_ptr(), coeffs.data_ptr(), order.data_ptr(),
            shift.data_ptr(), exact.data_ptr(), out.data_ptr(),
            *residual.shape, stream()))
        return out

    def encode_old(samples, history, weights, frame_len):
        Ld = samples.shape[0]
        words = torch.empty((Ld, 256), dtype=torch.int64, device=dev)
        h_out, w_out = torch.empty_like(history), torch.empty_like(weights)
        _kernels.check_launch("old qoa_encode", olds["qoa_encode"](
            samples.data_ptr(), samples.element_size(), history.data_ptr(),
            weights.data_ptr(), frame_len.data_ptr(), words.data_ptr(),
            h_out.data_ptr(), w_out.data_ptr(), Ld, stream()))
        return words, h_out, w_out

    slices = []   # (label, module, attribute, the parent's function, run)
    if "mp3_huff" in names:
        # K3 at one window of the MP3 slice
        mp3_streams, mp3_info = mp3_corpus(mp3_masters)
        pool, meta16, W, lpf, _, _ = mp3_window(mp3_streams)
        p_d, m_d = (torch.from_numpy(a).to(dev) for a in (pool, meta16))
        L = meta16.shape[0]
        blob = mp3_huff.device_const(mp3_huff.HUFF_BLOB, dev)
        q_old, e_old = huff_old(p_d, m_d, W, lpf)
        q_new, e_new = mp3_huff.huff_decode(p_d, m_d, W, lpf)
        torch.cuda.synchronize()
        if not (torch.equal(q_old, q_new) and torch.equal(e_old, e_new)):
            raise AssertionError("K3: parent and change differ")
        offs32, perm = mp3_huff.huff_plan_cuda(m_d, lpf)
        turns(f"mp3_huff wrapper L={L} W={W}",
              lambda: huff_old(p_d, m_d, W, lpf),
              lambda: mp3_huff.huff_decode(p_d, m_d, W, lpf))
        turns(f"mp3_huff kernel alone L={L} W={W}",
              lambda: huff_old(p_d, m_d, W, lpf, offs32, perm,
                               (q_old, e_old)),
              lambda: mp3_huff.huff_launch(p_d, m_d, W, offs32, perm, q_new,
                                           e_new))
        del q_old, q_new
        # the MP3 slice over each tree's own wire (C stage, pool, plan and
        # kernel), where PARENT holds the whole earlier tree
        pkg = parent_package(parent)
        if pkg is not None:
            import audio_formats_torch

            sides, pcm = [], []
            for side in (pkg, audio_formats_torch):
                (st, wall), (a, k) = first_call_of(
                    side.ops.mp3_huff, "huff_decode",
                    lambda: decode_stats(side, mp3_streams, pcm))
                sides.append((st, wall, a, k, side.ops.mp3_huff.huff_decode))
                print(f"# ab MP3 slice over the {side.__name__} wire: "
                      f"h2d_bytes {st['h2d_bytes']}, windows "
                      f"{st['windows']}, {st['decoded_seconds'] / wall:.1f}x "
                      f"realtime; its first window {a[0].numel()} pool "
                      f"words for {a[1].shape[0]} lanes, W={a[2]} [{card}]")
            diff = max(float(np.abs(x - y).max()) for x, y in zip(*pcm))
            if diff:
                raise AssertionError(f"the MP3 slice's PCM differs between "
                                     f"the two wires by {diff}")
            print(f"# ab MP3 slice: the {len(pcm[0])} lanes' PCM bit-equal "
                  f"over the two wires [{card}]")
            del pcm
            turns("mp3_huff wrapper at each wire's own first window",
                  lambda: sides[0][4](*sides[0][2], **sides[0][3]),
                  lambda: sides[1][4](*sides[1][2], **sides[1][3]))
            runs = [(who, *decode_stats(side, mp3_streams))
                    for who, side in (("parent", pkg),
                                      ("change", audio_formats_torch),
                                      ("change", audio_formats_torch),
                                      ("parent", pkg)) * 2]
            print("# ab MP3 slice over each wire, realtime factor (wall, "
                  "enqueue_ms, host_ms): " + ", ".join(
                      f"{who} {st['decoded_seconds'] / wall:.1f}x "
                      f"({wall:.3f} s, {st['enqueue_ms']:.0f}, "
                      f"{st['host_ms']:.0f})" for who, st, wall in runs)
                  + f" [{card}]")
            del sides
        slices.append(("MP3 slice", mp3_huff, "huff_decode",
                       lambda p_, m_, W_, lpf_=1: huff_old(p_, m_, W_, lpf_),
                       lambda: decode_realtime(mp3_streams)))

    def win_old(y1, y0, ls, rs, re, valid, lap, lap_len, had_prev, *, bs0,
                bs1, ch, out=None):
        K, L_, _ = y1.shape
        B = L_ // ch
        out = out or (torch.empty((K, L_, bs1), device=dev),
                      torch.empty((L_, bs1 // 2), device=dev),
                      torch.empty(B, dtype=torch.int32, device=dev),
                      torch.empty(B, dtype=torch.int32, device=dev))
        slopes = mp3_huff.device_const(vorbis_win.slope_rows(bs0, bs1), dev)
        _kernels.check_launch("old vorbis_win", olds["vorbis_win"](
            y1.data_ptr(), (y1 if y0 is None else y0).data_ptr(),
            ls.data_ptr(), rs.data_ptr(), re.data_ptr(), valid.data_ptr(),
            lap.data_ptr(), lap_len.data_ptr(), had_prev.data_ptr(),
            slopes.data_ptr(), *(o.data_ptr() for o in out), K, L_, ch, bs0,
            bs1, stream()))
        return out

    if "vorbis_win" in names:
        # K11 at the Vorbis slice's first window (its arguments kept from
        # one run of the slice)
        v_streams = [vorbis_masters[i % len(vorbis_masters)][0]
                     for i in range(VORBIS_LANES)]
        kept = {}
        chain = vorbis_win.vorbis_window_chain

        def first_call(*a, **k):
            kept.setdefault("args", (a, k))
            return chain(*a, **k)

        vorbis_win.vorbis_window_chain = first_call
        try:
            decode_realtime(v_streams)
        finally:
            vorbis_win.vorbis_window_chain = chain
        (X, *geo_st), kw = kept["args"]
        Kv, Lv, hv = X.shape
        bs0, bs1 = kw["bs0"], kw["bs1"]
        y1 = mdct.imdct_batch(X.reshape(Kv * Lv, hv), bs1)\
            .reshape(Kv, Lv, bs1)
        y0 = mdct.imdct_batch(X[..., :bs0 // 2].reshape(Kv * Lv, bs0 // 2),
                              bs0).reshape(Kv, Lv, bs0)
        got_old = win_old(y1, y0, *geo_st, **kw)
        got_new = vorbis_win.lap_chain(y1, y0, *geo_st, **kw)
        torch.cuda.synchronize()
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(got_old[:2], got_new[:2]))
        peak = float(got_old[0].abs().max())
        if not (diff <= VORBIS_TOL * peak and torch.equal(got_old[2],
                                                          got_new[2])
                and torch.equal(got_old[3], got_new[3])):
            raise AssertionError(f"K11: parent and change differ by {diff}")
        print(f"# ab vorbis_win: largest difference between parent and "
              f"change {diff:.6g} (PCM peak {peak:.6g}), lap_len' and "
              f"had_prev' equal [{card}]")
        label = f"the Vorbis slice's first window K={Kv} L={Lv}"
        turns(f"vorbis_win wrapper, {label}",
              lambda: win_old(y1, y0, *geo_st, **kw),
              lambda: vorbis_win.lap_chain(y1, y0, *geo_st, **kw))
        turns(f"vorbis_win kernel alone, {label}",
              lambda: win_old(y1, y0, *geo_st, **kw, out=got_old),
              lambda: vorbis_win.lap_chain_launch(y1, y0, *geo_st, got_new,
                                                  **kw))
        alone = (lambda: win_old(y1, y0, *geo_st, **kw, out=got_old),
                 lambda: vorbis_win.lap_chain_launch(y1, y0, *geo_st,
                                                     got_new, **kw))
        d = [device_ms(fn, "vorbis_win") for fn in alone + alone[::-1]]
        h = [time_host(fn) for fn in (
            lambda: win_old(y1, y0, *geo_st, **kw),
            lambda: vorbis_win.lap_chain(y1, y0, *geo_st, **kw))]
        print(f"# ab vorbis_win device time (torch.profiler), {label}: "
              f"parent, change, change, parent: "
              + ", ".join("not measured" if t is None else f"{t:.4f} ms"
                          for t in d)
              + f"; host enqueue of the wrapper: parent {h[0]:.4f} ms, "
              f"change {h[1]:.4f} ms [{card}]")
        pkg = parent_package(parent)
        if pkg is not None:
            # the parent's own wrapper (its checks, allocations and launch)
            pw = pkg.ops.vorbis_win
            p_out = pw.lap_chain(y1, y0, *geo_st, **kw)
            turns(f"vorbis_win wrappers as each tree has them, {label}",
                  lambda: pw.lap_chain(y1, y0, *geo_st, **kw),
                  lambda: vorbis_win.lap_chain(y1, y0, *geo_st, **kw))
            turns(f"vorbis_win launches alone as each tree has them, {label}",
                  lambda: pw.lap_chain_launch(y1, y0, *geo_st, p_out, **kw),
                  lambda: vorbis_win.lap_chain_launch(y1, y0, *geo_st,
                                                      got_new, **kw))
            hp = [time_host(fn) for fn in (
                lambda: pw.lap_chain(y1, y0, *geo_st, **kw),
                lambda: vorbis_win.lap_chain(y1, y0, *geo_st, **kw),
                lambda: pw.lap_chain_launch(y1, y0, *geo_st, p_out, **kw),
                lambda: vorbis_win.lap_chain_launch(y1, y0, *geo_st,
                                                    got_new, **kw))]
            print(f"# ab vorbis_win host enqueue as each tree has it, "
                  f"{label}: wrapper parent {hp[0]:.4f} ms, change "
                  f"{hp[1]:.4f} ms; launch alone parent {hp[2]:.4f} ms, "
                  f"change {hp[3]:.4f} ms [{card}]")
            del p_out
        del got_old, got_new, y1, y0
        slices.append(("Vorbis slice", vorbis_win, "lap_chain", win_old,
                       lambda: decode_realtime(v_streams)))

    if "silk_upsample" in names:
        ab_silk_upsample(olds["silk_upsample"], card, turns, stream)
    if "celt_ola" in names:
        ab_celt_ola(olds["celt_ola"], card, turns, stream)
    if "celt_deemph" in names:
        ab_celt_deemph(olds["celt_deemph"], card, turns, stream, parent)

    if "flac_lpc" in names or "flac_rice" in names:
        streams, pcms = build_corpus()
    if "flac_lpc" in names:
        # K1 at the FLAC slice's first window and at the random lanes
        captured = flac_slice(streams, pcms)[3]
        rng = np.random.default_rng(2024)
        rand = [torch.from_numpy(a).to(dev)
                for a in kernel_lanes(rng, L_KERNEL, B_KERNEL, 256)[0]]
        for label, targs in (("FLAC slice window", captured),
                             ("random-lane window", rand)):
            Lk, B = targs[0].shape
            got_old = lpc_old(*targs)
            got_new = lpc.flac_lpc(*targs)
            torch.cuda.synchronize()
            if not torch.equal(got_old, got_new):
                raise AssertionError(f"K1 at the {label}: parent and change "
                                     "differ")
            perm = lpc.lpc_plan_cuda(targs[1], targs[2], targs[4], B)
            turns(f"flac_lpc wrapper, {label} L={Lk} B={B}",
                  lambda: lpc_old(*targs), lambda: lpc.flac_lpc(*targs))
            turns(f"flac_lpc kernel alone, {label} L={Lk} B={B}",
                  lambda: lpc_old(*targs, out=got_old),
                  lambda: lpc.flac_lpc_launch(*targs, perm, got_new))
        slices.append(("FLAC slice", lpc, "flac_lpc", lpc_old,
                       lambda: decode_realtime(streams)))

    def rice_old(blocks, sb, bs, bps0, chass, L, NSAMP, nch, NPOOL,
                 out=None):
        out = out or flac_rice.rice_outputs(sb.shape[0], NSAMP, nch, dev)
        _kernels.check_launch("old flac_rice", olds["flac_rice"](
            blocks.data_ptr(), blocks.shape[0], sb.data_ptr(), bs.data_ptr(),
            bps0.data_ptr(), chass.data_ptr(), sb.shape[0], NSAMP, nch,
            *(out[k].data_ptr() for k in ("residual", "coeffs", "fields",
                                          "err", "end_bits")), stream()))
        return out

    if "flac_rice" in names:
        # K4 at the FLAC Rice slice's first dispatch: through its wrapper,
        # alone, and its first 32 lanes alone (one warp)
        args, kw = rice_slice(streams, pcms)[3]["flac_frame_entropy"]
        full = list(args) + [kw[k] for k in ("L", "NSAMP", "nch", "NPOOL")]
        blocks, sb, bs, bps0, chass, Lr, NSAMP, nch, NPOOL = full
        got_old = rice_old(*full)
        got_new = flac_rice.flac_frame_entropy(*full)
        torch.cuda.synchronize()
        if not all(torch.equal(got_old[k], got_new[k]) for k in RICE_KEYS):
            raise AssertionError("K4: parent and change differ")
        label = f"the Rice slice's first dispatch L={Lr} nch={nch}"
        turns(f"flac_rice wrapper, {label}", lambda: rice_old(*full),
              lambda: flac_rice.flac_frame_entropy(*full))
        turns(f"flac_rice kernel alone, {label}",
              lambda: rice_old(*full, out=got_old),
              lambda: flac_rice.rice_launch(blocks, sb, bs, bps0, chass,
                                            NSAMP, nch, got_new))
        few = [a[:32].contiguous() for a in (sb, bs, bps0, chass)]
        o32 = [flac_rice.rice_outputs(32, NSAMP, nch, dev) for _ in range(2)]
        turns(f"flac_rice one warp (its first 32 lanes), {label}",
              lambda: rice_old(blocks, *few, 32, NSAMP, nch, NPOOL,
                               out=o32[0]),
              lambda: flac_rice.rice_launch(blocks, *few, NSAMP, nch, o32[1]),
              reps=5)
        del got_old, got_new, o32, args, kw, full
        slices.append(("FLAC Rice slice", flac_rice, "flac_frame_entropy",
                       rice_old, lambda: decode_realtime(streams,
                                                         flac_wire="rice")))

    if "qoa_encode" in names:
        # K5 at the random chunk and at the encode slice's full and tail
        # chunks (their arguments kept from one run of the slice)
        from audio_formats_torch import encode_qoa_batch

        masters = qoa_masters()
        _, _, chunks = phase_qoa_encode(card, masters)
        for label, args in (
                ("random chunk", [torch.from_numpy(a).to(dev)
                                  for a in qoa_kernel_inputs()[1]]),
                ("encode slice's full chunk", qoa_chunk_args(*chunks[0])),
                ("encode slice's tail chunk", qoa_chunk_args(*chunks[-1]))):
            got_old = encode_old(*args)
            got_new = lms.qoa_encode_cuda(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got_old, got_new)):
                raise AssertionError(f"K5 at the {label}: parent and change "
                                     "differ")
            turns(f"qoa_encode {label} L={args[0].shape[0]}",
                  lambda: encode_old(*args), lambda: lms.qoa_encode_cuda(*args))
        del chunks

        def encode_realtime():
            t0 = time.perf_counter()
            encode_qoa_batch(masters, SR, device="cuda")
            return (sum(m.shape[0] for m in masters) / SR
                    / (time.perf_counter() - t0))

        slices.append(("QOA encode slice", lms, "qoa_encode_cuda", encode_old,
                       encode_realtime))

    def decode_old(history, weights, sf, codes, out=None, deq=None):
        out = torch.empty((history.shape[0], (codes if deq is None else deq)
                           [0].numel()), dtype=torch.int32, device=dev) \
            if out is None else out
        _kernels.check_launch("old qoa_decode", olds["qoa_decode"](
            history.data_ptr(), weights.data_ptr(),
            None if deq is None else deq.data_ptr(),
            None if deq is not None else sf.data_ptr(),
            None if deq is not None else codes.data_ptr(), out.data_ptr(),
            *out.shape, stream()))
        return out

    if "qoa_decode" in names:
        # K2 at the random window and at the QOA decode slice's first and
        # tail windows (their arguments kept from one run of the slice);
        # the int32 form at the random window
        from audio_formats_torch import encode_qoa_batch

        q_lanes = qoa_lanes(encode_qoa_batch(qoa_masters(), SR,
                                             device="cuda"))[0]
        windows = []
        decode_slices = lms.decode_slices

        def keep_args(*args):
            windows.append(args)
            return decode_slices(*args)

        lms.decode_slices = keep_args
        try:
            decode_realtime(q_lanes)
        finally:
            lms.decode_slices = decode_slices
        rand = [torch.from_numpy(a).to(dev) for a in qoa_kernel_inputs()[0]]
        for label, args in (("random window", rand),
                            ("decode slice's first window", windows[0]),
                            ("decode slice's tail window", windows[-1])):
            h, w, sf, codes = args
            got_old = decode_old(*args)
            got_new = lms.decode_slices(*args)
            torch.cuda.synchronize()
            if not torch.equal(got_old, got_new):
                raise AssertionError(f"K2 at the {label}: parent and change "
                                     "differ")
            turns(f"qoa_decode wrapper, {label} L={h.shape[0]}",
                  lambda: decode_old(*args), lambda: lms.decode_slices(*args))
            turns(f"qoa_decode kernel alone, {label} L={h.shape[0]}",
                  lambda: decode_old(*args, out=got_old),
                  lambda: lms.qoa_decode_launch(h, w, got_new, scalefactors=sf,
                                                codes=codes))
        h, w, sf, codes = rand
        tab = torch.from_numpy(lms.DEQUANT_TAB).to(dev)
        deq = tab[sf.long()[..., None], codes.long()].reshape(
            h.shape[0], -1).contiguous()
        got_old = decode_old(h, w, None, None, deq=deq)
        got_new = lms.qoa_decode(h, w, deq)
        torch.cuda.synchronize()
        if not torch.equal(got_old, got_new):
            raise AssertionError("K2's int32 form: parent and change differ")
        turns(f"qoa_decode int32 form, random window L={h.shape[0]}",
              lambda: decode_old(h, w, None, None, deq=deq),
              lambda: lms.qoa_decode(h, w, deq))
        del windows, rand, deq, got_old, got_new
        slices.append(("QOA decode slice", lms, "decode_slices", decode_old,
                       lambda: decode_realtime(q_lanes)))

    # the slices, each with the parent's kernel swapped in, in turns
    def with_kernel(module, name, fn, run):
        keep = getattr(module, name)
        if fn is not None:
            setattr(module, name, fn)
        try:
            return run()
        finally:
            setattr(module, name, keep)

    for label, module, name, fn, run in slices:
        with_kernel(module, name, None, run)   # warm
        r = [with_kernel(module, name, f, run) for f in (fn, None, None, fn)]
        print(f"# ab {label} realtime factor: parent {r[0]:.1f}x, change "
              f"{r[1]:.1f}x, change {r[2]:.1f}x, parent {r[3]:.1f}x [{card}]")
    print(card)


def ab_silk_upsample(old_fn, card, turns, stream):
    """--ab for K13: the parent's kernel (its C entry: the taps by device
    pointer) against this tree's (the taps a host array, by value) at the SILK slice's first step (its
    arguments kept from one decode of the slice's lanes) and at
    SILK_BIG_ROWS random rows of a 20 ms step for den 6, 4 and 3: the
    largest difference (it must be 0: both are one FMA chain an output, k
    in order), then the wrapper, the launch alone and the device time, in
    turns."""
    import torch
    from audio_formats_torch.ops import _kernels, resample

    distinct = speech_distinct("silk")
    _, (args, _) = first_call_of(resample, "silk_upsample", lambda: (
        decode_realtime([distinct[i % len(distinct)]
                         for i in range(SPEECH_LANES)])))
    x, h, G = args[:3]
    shapes = [("the SILK slice's first step", x, h, G)]
    rng = np.random.default_rng(13)
    t = resample._fit_tables()
    for key in ("h_nb", "h_mb", "h_wb"):
        hb = resample.pack_taps(np.asarray(t[key], np.float64)[:, ::-1])
        Gb = 960 // hb.shape[0]
        xb = torch.from_numpy((rng.standard_normal(
            (SILK_BIG_ROWS, Gb + 95)) * 3000).astype(np.float32)).cuda()
        shapes.append((f"random rows, den {hb.shape[0]}", xb, hb, Gb))

    # the parent's taps: a tensor on the card
    on_card = {id(h): torch.from_numpy(h).to(x.device)
               for _, x, h, _ in shapes}

    def old(x, h, G, out=None):
        out = torch.empty((x.shape[0], G * h.shape[0]), device=x.device) \
            if out is None else out
        _kernels.check_launch("old silk_upsample", old_fn(
            x.data_ptr(), on_card[id(h)].data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], G, h.shape[0], stream()))
        return out

    for label, x, h, G in shapes:
        label = f"{label} ({x.shape[0]} rows x {G} x {h.shape[0]})"
        got_old, got_new = old(x, h, G), resample.silk_upsample(x, h, G)
        torch.cuda.synchronize()
        diff = float((got_old - got_new).abs().max())
        if diff != 0.0:
            raise AssertionError(f"K13 at {label}: parent and change differ "
                                 f"by {diff}")
        print(f"# ab silk_upsample, {label}: largest difference between "
              f"parent and change {diff} [{card}]")
        turns(f"silk_upsample wrapper, {label}", lambda: old(x, h, G),
              lambda: resample.silk_upsample(x, h, G))
        turns(f"silk_upsample kernel alone, {label}",
              lambda: old(x, h, G, got_old),
              lambda: resample.silk_upsample_launch(x, h, G, got_new))
        alone = (lambda: old(x, h, G, got_old),
                 lambda: resample.silk_upsample_launch(x, h, G, got_new))
        d = [device_ms(fn, "silk_upsample") for fn in alone + alone[::-1]]
        print(f"# ab silk_upsample device time (torch.profiler), {label}: "
              "parent, change, change, parent: "
              + ", ".join("not measured" if v is None else f"{v:.4f} ms"
                          for v in d) + f" [{card}]")


def ab_celt_ola(old_fn, card, turns, stream):
    """--ab for K12a: the parent's stage (the IMDCT matmul, imdct_halves,
    then its K12a out of place, and the concatenation into one tensor that
    its batch downloaded) against this tree's celt_imdct_ola (the fused
    kernel for blocks of 120; the matmul into the packed buffer and the
    in-place mix for long blocks), at the Opus slice's first bucket of
    each route (their arguments kept from one decode of the slice's lanes)
    and at OPUS_BIG from random spectra: the largest difference, then the
    stage's time and its device time (every kernel of a call), in turns."""
    import torch
    from audio_formats_torch.ops import _kernels, celt_dsp

    _, kept, _ = keep_buckets(lambda: decode_realtime(opus_streams()[0]))
    shapes = []
    for route in ("short", "long"):
        args, kw = kept[route]
        scale = args[4] if len(args) > 4 else kw.get("scale", 1.0)
        shapes.append(("the Opus slice's first bucket", *args[:4], scale))
    rng = np.random.default_rng(12)
    for rows, nb, nbs in OPUS_BIG:
        shapes.append(("random spectra", torch.from_numpy((
            rng.standard_normal((rows, nb * nbs)) * 400).astype(
                np.float32)).cuda(), torch.from_numpy((rng.standard_normal(
                    (rows, 60)) * 400).astype(np.float32)).cuda(), nb, nbs,
            1.0))
    win = celt_dsp.device_const(celt_dsp.WINDOW_F32, torch.device("cuda"))

    def old(co, tail, blocks, bs, scale):
        halves = celt_dsp.imdct_halves(co, blocks, bs, scale)
        out = (torch.empty((co.shape[0], blocks * bs), device=co.device),
               torch.empty((co.shape[0], 60), device=co.device))
        _kernels.check_launch("old celt_ola", old_fn(
            halves.data_ptr(), tail.data_ptr(), win.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), co.shape[0], blocks, bs,
            stream()))
        return torch.cat(out, dim=1)

    def new(co, tail, blocks, bs, scale):
        return celt_dsp.celt_imdct_ola_packed(co, tail, blocks, bs, scale)

    for label, co, tail, blocks, bs, scale in shapes:
        label = (f"{label} ({co.shape[0]} rows x {blocks} x {bs}, scale "
                 f"{scale})")
        a, b = old(co, tail, blocks, bs, scale), new(co, tail, blocks, bs,
                                                     scale)
        torch.cuda.synchronize()
        diff = float((a - b).abs().max())
        peak = float(a.abs().max())
        if not diff <= K12A_TOL * peak:
            raise AssertionError(f"K12a at {label}: parent and change differ "
                                 f"by {diff} (peak {peak})")
        print(f"# ab celt_ola, {label}: largest difference between the "
              f"parent's stage and the change's {diff:.6g} (peak "
              f"{peak:.6g}) [{card}]")
        sides = (lambda: old(co, tail, blocks, bs, scale),
                 lambda: new(co, tail, blocks, bs, scale))
        turns(f"celt_imdct_ola stage, {label}", *sides)
        d = [device_ms(fn, "") for fn in sides + sides[::-1]]
        print(f"# ab celt_imdct_ola stage device time (torch.profiler, every "
              f"kernel of a call), {label}: parent, change, change, parent: "
              + ", ".join("not measured" if v is None else f"{v:.4f} ms"
                          for v in d) + f" [{card}]")


def ab_celt_deemph(old_fn, card, turns, stream, parent):
    """--ab for K12b: the parent's kernel against this tree's at
    DEEMPH_SHAPES from random x and m0 (amplitude 8000), each through its
    own tree's wrappers where PARENT holds the whole earlier tree (else
    the parent's C entry, contiguous rows, called bare): each side within
    DEEMPH_TOL of the peak of the twin (the two need not be bit-equal:
    their scans round the entry carries each their own way), then the
    wrapper, the launch alone and the device time, warm and with the L2
    flushed before each launch, in turns.  Then the CELT synthesis chain
    of ``deemph_chain`` at each row count with either side's K12b (the
    parent's on a contiguous copy of K12a's output columns, as its chain
    ran), each within DEEMPH_TOL of the peak of the twins' chain: its
    wall and the card's work (every kernel and copy), in turns."""
    import torch
    from audio_formats_torch.ops import _kernels, celt_dsp

    c = float(np.float32(celt_dsp.DEEMPH_COEFF))
    pkg = parent_package(parent)
    rng = np.random.default_rng(15)

    def old(x, m0, out=None):
        if pkg is not None:
            if out is None:
                return pkg.ops.celt_dsp.deemphasis_scan(x, m0)
            return pkg.ops.celt_dsp.deemphasis_launch(x, m0, out)
        out = out or (torch.empty_like(x), torch.empty_like(m0))
        _kernels.check_launch("old celt_deemph", old_fn(
            x.data_ptr(), m0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), x.shape[0], x.shape[1], c, stream()))
        return out

    for B, n in DEEMPH_SHAPES:
        x = torch.from_numpy(rng.uniform(-8000, 8000, (B, n)).astype(
            np.float32)).cuda()
        m0 = torch.from_numpy(rng.uniform(-8000, 8000, B).astype(
            np.float32)).cuda()
        got = {"parent": old(x, m0),
               "change": celt_dsp.deemphasis_scan(x, m0)}
        wy, wm = celt_dsp.deemphasis_scan_torch(x, m0)
        torch.cuda.synchronize()
        errs = {who: max(float((y - wy).abs().max()) / float(wy.abs().max()),
                         float((m - wm).abs().max()) / float(wm.abs().max()))
                for who, (y, m) in got.items()}
        if not all(e <= DEEMPH_TOL for e in errs.values()):
            raise AssertionError(f"K12b at [{B}, {n}]: of the peak from the "
                                 f"twin {errs}")
        label = f"[{B}, {n}]"
        print(f"# ab celt_deemph, {label}: of the peak from the twin, parent "
              f"{errs['parent']:.3g}, change {errs['change']:.3g}; the "
              f"parent through "
              + ("its own wrappers" if pkg is not None
                 else "its C entry, called bare") + f" [{card}]")
        turns(f"celt_deemph wrapper, {label}", lambda: old(x, m0),
              lambda: celt_dsp.deemphasis_scan(x, m0))
        alone = (lambda: old(x, m0, got["parent"]),
                 lambda: celt_dsp.deemphasis_launch(x, m0, got["change"]))
        turns(f"celt_deemph kernel alone, {label}", *alone)
        for how, timer in (("", device_ms),
                           (", the L2 flushed before each launch",
                            cold_device_ms)):
            d = [timer(fn, "celt_deemph", per_launch=True)
                 for fn in alone + alone[::-1]]
            print(f"# ab celt_deemph device time (torch.profiler){how}, "
                  f"{label}: parent, change, change, parent: "
                  + ", ".join("not measured" if v is None else f"{v:.4f} ms"
                              for v in d) + f" [{card}]")

    for rows in sorted({B for B, _ in DEEMPH_SHAPES}):
        X = torch.from_numpy((rng.standard_normal((DEEMPH_FRAMES, rows, 960))
                              * 400).astype(np.float32)).cuda()
        zeros = torch.zeros((rows, 60), device="cuda")

        def chain(imdct_ola, deemph):
            tail, m, ys = zeros, zeros[:, 0].contiguous(), []
            for k in range(DEEMPH_FRAMES):
                raw, tail = imdct_ola(X[k], tail, 1, 960)
                y, m = deemph(raw, m)
                tail = tail.contiguous()
                ys.append(y)
            return torch.stack(ys), m

        sides = (lambda: chain(celt_dsp.celt_imdct_ola,
                               lambda r, m: old(r.contiguous(), m)),
                 lambda: chain(celt_dsp.celt_imdct_ola,
                               celt_dsp.deemphasis_scan))
        wy, wm = chain(celt_dsp.celt_imdct_ola_torch,
                       celt_dsp.deemphasis_scan_torch)
        for who, fn in zip(("parent", "change"), sides):
            gy, gm = fn()
            err = max(float((gy - wy).abs().max()) / float(wy.abs().max()),
                      float((gm - wm).abs().max()) / float(wm.abs().max()))
            if not err <= DEEMPH_TOL:
                raise AssertionError(f"the {who}'s chain at {rows} rows: "
                                     f"{err:.3g} of the peak from the twins'")
        label = f"CELT synthesis chain, {rows} rows x {DEEMPH_FRAMES} frames"
        turns(label + " (wall a chain)", *sides, reps=5)
        d = [device_ms(fn, "", 3) for fn in sides + sides[::-1]]
        print(f"# ab celt_deemph {label}, the card's work a frame "
              f"(torch.profiler, every kernel and copy): parent, change, "
              "change, parent: "
              + ", ".join("not measured" if v is None
                          else f"{v / DEEMPH_FRAMES:.4f} ms" for v in d)
              + f" [{card}]")


def parent_package(parent):
    """The earlier commit's whole package, where PARENT holds it (``git
    archive <commit> | tar -x -C PARENT``), imported beside this tree's as
    ``parent_audio_formats_torch``: its wrappers, C stage and kernels, built
    into PARENT.  None where PARENT holds only the kernel sources."""
    import importlib
    import importlib.util

    name = "parent_audio_formats_torch"
    if name in sys.modules:
        return sys.modules[name]
    init = os.path.join(os.path.abspath(parent), "audio_formats_torch",
                        "__init__.py")
    if not os.path.exists(init):
        return None
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("ops.mp3_huff", "ops.vorbis_win"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def first_call_of(module, fn_name, run):
    """Run `run()` with module.fn_name wrapped to keep its first call's
    arguments; returns (run's result, (args, kwargs))."""
    fn = getattr(module, fn_name)
    kept = {}

    def keep(*a, **k):
        kept.setdefault("call", (a, k))
        return fn(*a, **k)

    setattr(module, fn_name, keep)
    try:
        return run(), kept["call"]
    finally:
        setattr(module, fn_name, fn)


def decode_stats(package, streams, keep=None):
    """One decode_all(output="device") of the streams with `package`'s
    BatchDecoder on the card, synced: (its stats, wall seconds); the
    lanes' PCM appended to `keep` where it is a list."""
    import torch

    dec = package.BatchDecoder(streams, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dec.decode_all(output="device").sync()
    wall = time.perf_counter() - t0
    if keep is not None:
        keep.append(res.to_numpy())
    return dec.stats, wall


RING_PROBES = tuple((layout, depth) for layout in ("word-major", "lane-major")
                    for depth in (1, 2, 4))


def ring_source(layout, depth):
    """csrc/flac_rice.cu with its staging ring kRingBlocks blocks deep and
    laid out word-major (ring[word][lane], as the source has it) or
    lane-major (ring[lane][word])."""
    import re

    with open(os.path.join(ROOT, "audio_formats_torch", "csrc",
                           "flac_rice.cu")) as f:
        src = f.read()
    src, n = re.subn(r"constexpr int kRingBlocks = \d+;",
                     f"constexpr int kRingBlocks = {depth};", src)
    if layout == "lane-major":
        src = src.replace("uint32_t ring[kRingW][kThreads];",
                          "uint32_t ring[kThreads][kRingW];")
        src, m = re.subn(r"sm\.ring\[([^\]]+)\]\[([^\]]+)\]",
                         r"sm.ring[\2][\1]", src)
        n = n and m
    if not n:
        raise RuntimeError("flac_rice.cu: no ring to vary")
    return src


def ring_probe():
    """--ring (on the card): K4 built with each staging ring of
    RING_PROBES, each held bit-equal to this tree's kernel at the FLAC Rice
    slice's first dispatch, then timed there alone and as its first 32
    lanes (one warp), the variants in turns forward and back.  Prints one
    line a variant and the card; no result line."""
    import ctypes
    import tempfile

    import torch
    from audio_formats_torch.ops import _kernels, flac_rice

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: --ring runs on the card")
    card = card_line()
    print(card)
    tmp = tempfile.mkdtemp(prefix="k4ring", dir=os.path.join(ROOT, "_checkout")
                           if os.path.isdir(os.path.join(ROOT, "_checkout"))
                           else None)

    def build(v):
        src = os.path.join(tmp, f"{v[0]}-{v[1]}.cu")
        with open(src, "w") as f:
            f.write(ring_source(*v))
        out = src[:-3] + ".so"
        res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                              out, src], check=True, capture_output=True,
                             text=True, timeout=600)
        fn = ctypes.CDLL(out).af_flac_rice
        fn.argtypes = _kernels._ENTRIES["flac_rice"][0][1]
        fn.restype = ctypes.c_int
        regs = [ln.split(":", 1)[1].strip() for ln in
                (res.stdout + res.stderr).splitlines() if "Used" in ln]
        return fn, regs

    with ThreadPoolExecutor(max_workers=len(RING_PROBES) + 1) as ex:
        built = ex.map(build, RING_PROBES)
        _kernels.build("flac_rice")
        _kernels.build("flac_lpc")
        built = dict(zip(RING_PROBES, built))
    streams, pcms = build_corpus()
    args, kw = rice_slice(streams, pcms)[3]["flac_frame_entropy"]
    full = list(args) + [kw[k] for k in ("L", "NSAMP", "nch", "NPOOL")]
    blocks, sb, bs, bps0, chass, L, NSAMP, nch, NPOOL = full
    dev = blocks.device
    want = flac_rice.flac_frame_entropy(*full)
    few = [a[:32].contiguous() for a in (sb, bs, bps0, chass)]

    def launch(fn, lanes, out):
        _kernels.check_launch("ring probe", fn(
            blocks.data_ptr(), blocks.shape[0],
            *(a.data_ptr() for a in lanes), lanes[0].shape[0], NSAMP, nch,
            *(out[k].data_ptr() for k in ("residual", "coeffs", "fields",
                                          "err", "end_bits")),
            torch.cuda.current_stream().cuda_stream))

    outs = {}
    for v, (fn, _) in built.items():
        outs[v] = (flac_rice.rice_outputs(L, NSAMP, nch, dev),
                   flac_rice.rice_outputs(32, NSAMP, nch, dev))
        launch(fn, (sb, bs, bps0, chass), outs[v][0])
        torch.cuda.synchronize()
        if not all(torch.equal(outs[v][0][k], want[k]) for k in RICE_KEYS):
            raise AssertionError(f"ring {v}: differs from this tree's K4")
    times = {v: ([], []) for v in built}
    for order in (RING_PROBES, RING_PROBES[::-1]):
        for v in order:
            fn = built[v][0]
            times[v][0].append(time_cuda(lambda: launch(
                fn, (sb, bs, bps0, chass), outs[v][0]), 20))
            times[v][1].append(time_cuda(lambda: launch(
                fn, few, outs[v][1]), 5))
    for v, (alone, warp) in times.items():
        print(f"# ring {v[0]}, {v[1]} blocks a lane "
              f"({v[1] * 64 * 32 * 4} bytes a warp; ptxas: "
              f"{'; '.join(built[v][1])}): the Rice slice's first dispatch "
              f"L={L} nch={nch}, kernel alone "
              + " / ".join(f"{t:.4f}" for t in alone) + " ms, one warp "
              + " / ".join(f"{t:.4f}" for t in warp) + f" ms [{card}]")
    print(card)


#: (rows, blocks) of 120 at which --grid times K12a's fused route
GRID_PROBES = ((512, 8), (4096, 1), (4096, 4), (4096, 8), (16384, 8))
GRID_CAP = "*grid = ntiles < fit[dev] ? ntiles : fit[dev];"


def grid_probe():
    """--grid (on the card): K12a's fused route (af_celt_imdct_ola) as the
    source has it, its grid capped at the blocks that fit on the card at
    once (each block loops over tiles), against the same source with one
    block a tile, at each GRID_PROBES shape from random spectra: the two
    held bit-equal (a tile's sums do not depend on the grid), then each
    launch's device time (torch.profiler) in turns, capped, one a tile,
    one a tile, capped.  Prints one line a shape and the card; no result
    line."""
    import ctypes
    import tempfile

    import torch
    from audio_formats_torch.ops import _kernels, celt_dsp

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: --grid runs on the card")
    card = card_line()
    print(card)
    with open(os.path.join(ROOT, "audio_formats_torch", "csrc",
                           "celt_ola.cu")) as f:
        src = f.read()
    if GRID_CAP not in src:
        raise RuntimeError("celt_ola.cu: no grid cap to vary")
    tmp = tempfile.mkdtemp(prefix="k12grid", dir=os.path.join(
        ROOT, "_checkout") if os.path.isdir(os.path.join(ROOT, "_checkout"))
        else None)
    var = os.path.join(tmp, "celt_ola_tile.cu")
    with open(var, "w") as f:
        f.write(src.replace(GRID_CAP, "*grid = ntiles;"))
    flags = _kernels.NVCC_FLAGS + _kernels.EXTRA_FLAGS["celt_ola"]

    def build_var():
        subprocess.run([_kernels._nvcc(), *flags, "-o", var[:-3] + ".so",
                        var], check=True, capture_output=True, timeout=600)
        fn = ctypes.CDLL(var[:-3] + ".so").af_celt_imdct_ola
        fn.argtypes = _kernels._ENTRIES["celt_ola"][1][1]
        fn.restype = ctypes.c_int
        return fn

    with ThreadPoolExecutor(max_workers=2) as ex:
        fut = ex.submit(build_var)
        capped = _kernels.load("celt_ola").af_celt_imdct_ola
        tiled = fut.result()
    dev = torch.device("cuda")
    _, _, win, basis_t = celt_dsp._entry(dev)
    rng = np.random.default_rng(12)
    for rows, nb in GRID_PROBES:
        co = torch.from_numpy((rng.standard_normal((rows, nb * 120))
                               * 400).astype(np.float32)).cuda()
        tl = torch.from_numpy((rng.standard_normal((rows, 60))
                               * 400).astype(np.float32)).cuda()
        outs = [torch.empty((rows, nb * 120 + 60), device=dev)
                for _ in range(2)]

        def launch(fn, out):
            _kernels.check_launch("grid probe", fn(
                co.data_ptr(), tl.data_ptr(), basis_t, win, out.data_ptr(),
                rows, nb, 1.0, torch.cuda.current_stream().cuda_stream))

        launch(capped, outs[0])
        launch(tiled, outs[1])
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"grid probe {rows}x{nb}x120: the two "
                                 "grids differ")
        runs = [(capped, 0), (tiled, 1), (tiled, 1), (capped, 0)]
        d = [device_ms(lambda: launch(fn, outs[i]), "celt_imdct_ola",
                       reps=50) for fn, i in runs]
        tiles = (rows + 32 // nb - 1) // (32 // nb)
        print(f"# grid {rows} rows x {nb} x 120 ({tiles} tiles of 32 "
              f"blocks): device time (torch.profiler), capped, one block a "
              f"tile, one block a tile, capped: "
              + ", ".join("not measured" if v is None else f"{v:.5f} ms"
                          for v in d) + f" [{card}]")
    print(card)


def decode_realtime(streams, **kw):
    """Audio seconds over wall seconds of one decode_all(output="device")
    of the streams on the card, synced; kw: BatchDecoder's options."""
    from audio_formats_torch import BatchDecoder

    dec = BatchDecoder(streams, device="cuda", **kw)
    t0 = time.perf_counter()
    dec.decode_all(output="device").sync()
    return dec.stats["decoded_seconds"] / (time.perf_counter() - t0)


def wire_compare():
    """The FLAC slice over both wires on the card: walls in turns, then one
    profiled run of each (see the module's docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_formats_torch import BatchDecoder
    from audio_formats_torch.host import native
    from audio_formats_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: --wires runs on the card")
    card = card_line()
    print(card)
    if native.get_lib() is None:
        raise RuntimeError("the C host stage did not build or load")
    with ThreadPoolExecutor(max_workers=2) as ex:
        list(ex.map(_kernels.build, ("flac_lpc", "flac_rice")))
    streams, _ = build_corpus()

    def run(wire):
        dec = BatchDecoder(streams, device="cuda", flac_wire=wire)
        t0 = time.perf_counter()
        dec.decode_all(output="device").sync()
        return dec, time.perf_counter() - t0

    run("packed")
    run("rice")
    for wire in ("packed", "rice", "rice", "packed"):
        dec, wall = run(wire)
        st = dec.stats
        print(f"# wires: {wire} {wall:.4f} s wall = "
              f"{st['decoded_seconds'] / wall:.1f}x realtime, h2d_bytes "
              f"{st['h2d_bytes']}, host_ms {st['host_ms']:.1f}, host_cpu_ms "
              f"{st['host_cpu_ms']:.1f}, enqueue_ms {st['enqueue_ms']:.1f}, "
              f"windows {st['windows']} [{card}]")
    for wire in ("packed", "rice"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = run(wire)
        # the device's own rows (kernels, copies, memsets): a host op's row
        # counts the device time of the kernels it launched again
        by_name = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if us > 0:
                by_name[evt.key] = us / 1e3
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"# wires, profiled: {wire} wall {wall * 1e3:.1f} ms, device "
              f"busy {busy:.1f} ms = {busy / (wall * 1e3):.3f} of the wall; "
              f"by kernel (ms): "
              + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top)
              + f" [{card}]")
    print(card)


if __name__ == "__main__":
    if sys.argv[1:] == ["--divergence"]:
        rice_divergence()
        divergence()
    elif sys.argv[1:] == ["--ring"]:
        ring_probe()
    elif sys.argv[1:] == ["--grid"]:
        grid_probe()
    elif sys.argv[1:] == ["--wires"]:
        wire_compare()
    elif sys.argv[1:] == ["--dsp"]:
        dsp_probe()
    elif sys.argv[1:] == ["--windows"]:
        window_probe()
    elif sys.argv[1:2] == ["--sass"]:
        print_sass(sys.argv[2:])
    elif sys.argv[1:2] == ["--ab"] and len(sys.argv) >= 3:
        ab_compare(sys.argv[2], sys.argv[3:] or AB_KERNELS)
    else:
        main()
