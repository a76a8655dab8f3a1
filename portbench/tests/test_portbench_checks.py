"""The comparison that decides ``correct``: a sound run passes; the
control (the reference in the precision below the configuration's) fails
its limit; and a run with the timed path broken underneath comes out not
correct, for each fault a cell can have: an answer altered where it is
produced, half of the batch left out, a carried state returned unchanged
(MP3's overlap and synthesis history; FLAC frames carry none).  A cell
on one card has no exchange between chips to leave out."""

import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.tests.tiny import ROOT_DIR, run_tiny, tiny_cell

CELLS = ["librispeech_flac.b64", "fma_mp3.b32"]


def _correct(out):
    return harness.passed(out["checks"]) and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert _correct(out), out["checks"]
    assert out["checks"]["lanes_compared"][0] >= 4


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    """The reference computed one precision lower (FLAC: its float32
    output through bfloat16; MP3: TF32 matrix products) reads above the
    limit on every lane, where the reference itself reads 0."""
    import importlib

    cfg, traffic, _, _ = tiny_cell(cell)
    gen = importlib.import_module("portbench.gen." + cfg["format"])
    ref = importlib.import_module("portbench.ref." + cfg["format"])
    corpus = gen.build(cfg, traffic, np.random.default_rng(2 ** 33 + 9))
    limit = cfg["check"]["limit"]
    for i in range(4):
        want = ref.expected(corpus, i)
        assert ref.gap(corpus, want, want) == 0.0
        assert ref.gap(corpus, ref.control(corpus, i), want) > 3 * limit


def _alter_flac(monkeypatch):
    from audio_formats_torch.ops import lpc

    real = lpc.flac_lpc

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[..., 0] += 1
        return out
    monkeypatch.setattr(lpc, "flac_lpc", altered)


def _alter_mp3(monkeypatch):
    from audio_formats_torch.ops import mp3_huff

    real = mp3_huff.packed_window

    def altered(*a, **k):
        pcm, ov, sh = real(*a, **k)
        pcm = pcm.clone()
        pcm[..., 0] += 1e-3
        return pcm, ov, sh
    monkeypatch.setattr(mp3_huff, "packed_window", altered)


def _half_batch(monkeypatch):
    from audio_formats_torch.parallel import batch

    real = batch.BatchDecoder.decode_all

    def half(self, output="numpy"):
        n = len(self.decoders)
        self.decoders[n - n // 2:] = [None] * (n // 2)
        return real(self, output)
    monkeypatch.setattr(batch.BatchDecoder, "decode_all", half)


def _mp3_state_unchanged(monkeypatch):
    from audio_formats_torch.ops import mp3_huff

    real = mp3_huff.packed_window

    def stale(pool, meta, scf, ist, overlap, shist, *a, **k):
        pcm, _, _ = real(pool, meta, scf, ist, overlap, shist, *a, **k)
        return pcm, overlap, shist
    monkeypatch.setattr(mp3_huff, "packed_window", stale)


FAULTS = [("librispeech_flac.b64", _alter_flac),
          ("librispeech_flac.b64", _half_batch),
          ("fma_mp3.b32", _alter_mp3),
          ("fma_mp3.b32", _half_batch),
          ("fma_mp3.b32", _mp3_state_unchanged)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(cell)
    assert not _correct(out), out["checks"]


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "librispeech_flac.b64", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT_DIR,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A short run of the cell at its own size on the card is correct."""
    import json
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 33 + 3), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT_DIR, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
