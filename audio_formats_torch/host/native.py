"""ctypes bindings for the native host entropy stage (src/af_host.cc).

The library compiles lazily on first import (g++ -O3 -shared) and is cached
next to the source.  Set AF_TPU_NO_NATIVE=1 to force the pure-Python
reference paths (models fall back automatically if the toolchain or binary
is unavailable).  Tests assert native == Python bit-for-bit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "af_host.cc")
_SO = os.path.join(_DIR, "src", "af_host.so")

_lock = threading.Lock()
_lib = None
_tables_loaded = False


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        tag = _SO + ".flags"
        cur = os.environ.get("AF_TPU_NATIVE_CFLAGS", "")
        prev = open(tag).read() if os.path.exists(tag) else ""
        if (os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime
                and cur == prev):
            return True
        # -ffp-contract=off: no FMA contraction, so float expressions round
        # exactly like the numpy reference paths (bit-for-bit A/B tests)
        flags = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]
        extra = os.environ.get("AF_TPU_NATIVE_CFLAGS")
        if extra:
            # sanitizer / instrumentation hook (tools/native_sanitize.sh)
            flags += extra.split()
        # build under a private name and rename into place, so a process
        # that builds concurrently never loads a half-written library
        tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
        res = subprocess.run(
            ["g++", "-march=native"] + flags + ["-o", tmp, _SRC],
            capture_output=True,
            timeout=120,
        )
        if res.returncode != 0:
            res = subprocess.run(  # retry without -march=native
                ["g++"] + flags + ["-o", tmp, _SRC],
                capture_output=True,
                timeout=120,
            )
        if res.returncode == 0:
            os.replace(tmp, _SO)
            with open(tag, "w") as f:
                f.write(cur)
        return res.returncode == 0
    except Exception:
        return False


def get_lib():
    """Returns the loaded library or None (fallback to Python paths)."""
    global _lib, _tables_loaded
    if os.environ.get("AF_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.af_mp3_set_table.argtypes = [
            ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int
        ]
        lib.af_mp3_set_table.restype = ctypes.c_int
        lib.af_mp3_huffman.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, i8p, f32p,
            ctypes.c_int32, ctypes.c_int32, i32p, f32p,
        ]
        lib.af_mp3_huffman.restype = ctypes.c_int64
        lib.af_flac_parse_frame.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p, i32p, i64p,
        ]
        lib.af_flac_parse_frame.restype = ctypes.c_int
        lib.af_flac_parse_window.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p, i32p, i64p,
        ]
        lib.af_flac_parse_window.restype = ctypes.c_int
        lib.af_mp3_set_l3_tables.argtypes = [i8p] * 7
        lib.af_mp3_set_l3_tables.restype = ctypes.c_int
        lib.af_mp3_granules_scf_huff.argtypes = [
            i8p, i8p, ctypes.c_int64, i32p, i8p,
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, f32p, i32p,
        ]
        lib.af_mp3_granules_scf_huff.restype = ctypes.c_int
        i64p_ = ctypes.POINTER(ctypes.c_int64)
        lib.af_mp3_parse_window.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64, i8p, ctypes.c_int32,
            ctypes.c_int32,
            i8p, i32p, i32p,
            f32p, i32p, i32p, i8p, i64p_,
        ]
        lib.af_mp3_parse_window.restype = ctypes.c_int
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.af_mp3_parse_window_packed.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64, i8p, ctypes.c_int32,
            ctypes.c_int32,
            i8p, i32p, i32p,
            u32p, i32p, i32p, i16p, i16p, i32p, i32p, i8p, i64p_,
        ]
        lib.af_mp3_parse_window_packed.restype = ctypes.c_int
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i16p_ = ctypes.POINTER(ctypes.c_int16)
        u32p_ = ctypes.POINTER(ctypes.c_uint32)
        lib.af_mp3_parse_window_packed_multi.argtypes = [
            i32p, ctypes.c_int32,                    # lanes, n_lanes
            u64p, i64p, i64p, i8p,                   # ptrs, lens, offs, hdr0s
            ctypes.c_int32, i32p,                    # W, ffbytes
            i8p, i32p, i32p,                         # rb, rl, ist state
            u32p_, ctypes.c_int64, i32p,             # bits, stride, max_words
            i32p, ctypes.c_int64,                    # meta, stride
            i16p_, ctypes.c_int64,                   # scfq, stride
            i16p_, ctypes.c_int64,                   # ist_out, stride
            i32p, ctypes.c_int64,                    # aa, stride
            i32p, ctypes.c_int64,                    # wt, stride
            i8p, ctypes.c_int64,                     # flags, stride
            i32p,                                    # n_out
        ]
        lib.af_mp3_parse_window_packed_multi.restype = ctypes.c_int
        lib.af_flac_sync_index.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64p,
            i64p, i64p, i32p, i32p, i32p]
        lib.af_flac_sync_index.restype = ctypes.c_int
        lib.af_flac_sync_index_multi.argtypes = [
            i32p, ctypes.c_int32,                    # lanes, n_lanes
            ctypes.POINTER(ctypes.c_uint64), i64p,   # ptrs, lens
            i32p, ctypes.c_int32,                    # bps_in, expect_ch
            ctypes.c_int32, ctypes.c_int32,          # max_block, W
            i64p, i64p, i64p, i32p, i32p, i32p, i32p,
        ]
        lib.af_flac_sync_index_multi.restype = ctypes.c_int
        lib.af_flac_build_pool.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), i64p, i64p, ctypes.c_int32,
            ctypes.c_int32, i8p, ctypes.c_int64, i64p]
        lib.af_flac_build_pool.restype = ctypes.c_int
        lib.af_flac_parse_window_multi.argtypes = [
            i32p, ctypes.c_int32,                    # lanes, n_lanes
            ctypes.POINTER(ctypes.c_uint64), i64p,   # ptrs, lens
            i64p, i32p,                              # cur_bits, bps_in
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ch,stride,W
            i32p, i32p, i32p, i32p, i32p, i32p, i64p, i32p,
        ]
        lib.af_flac_parse_window_multi.restype = ctypes.c_int
        lib.af_flac_widths.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32,
                                       i32p, i32p]
        lib.af_flac_widths.restype = ctypes.c_int
        lib.af_flac_pack.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32,
                                     i32p, ctypes.c_int32, u32p,
                                     ctypes.c_int32]
        lib.af_flac_pack.restype = ctypes.c_int
        # gather variants: pack straight from parse-window rows (per-row
        # pointers + valid lengths), skipping the padded residual scatter
        lib.af_flac_widths_gather.argtypes = [
            i64p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
        lib.af_flac_widths_gather.restype = ctypes.c_int
        lib.af_flac_pack_gather.argtypes = [
            i64p, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
            ctypes.c_int32, u32p, ctypes.c_int32, i32p]
        lib.af_flac_pack_gather.restype = ctypes.c_int
        lib.af_u32_pack_prefix_rows.argtypes = [
            u32p, ctypes.c_int32, ctypes.c_int32, i32p, u32p]
        lib.af_u32_pack_prefix_rows.restype = ctypes.c_int64
        lib.af_mp3_index.argtypes = [
            i8p, ctypes.c_int64, i8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, i64p, i64p, i64p]
        lib.af_mp3_index.restype = ctypes.c_int64

        # install the MP3 Huffman tables
        from ..utils.tables import mp3_tables as T

        for t, codes in enumerate(T.HUFF_TABLES):
            arr = np.array(codes, dtype=np.int32).reshape(-1, 4) if codes else \
                np.zeros((0, 4), np.int32)
            lib.af_mp3_set_table(
                t, arr.ctypes.data_as(i32p), len(arr), int(T.LINBITS[t])
            )
        for t, codes in enumerate((T.COUNT1_A, T.COUNT1_B)):
            # count1 payload: store v mask in the x byte slot, y unused
            arr = np.array(
                [(c, l, v, 0) for c, l, v in codes], dtype=np.int32
            )
            lib.af_mp3_set_table(32 + t, arr.ctypes.data_as(i32p), len(arr), 0)
        sizes = {"SCF_LONG": 184, "SCF_SHORT": 320, "SCF_MIXED": 320}

        def _padded(name, a):
            a = np.asarray(a, dtype=np.uint8)
            want = sizes.get(name, a.size)
            if a.size < want:  # zero-terminated flat tables: pad the tail
                a = np.concatenate([a, np.zeros(want - a.size, np.uint8)])
            return a

        _keep = [_padded(n, getattr(T, n)) for n in (
            "SCF_LONG", "SCF_SHORT", "SCF_MIXED", "SCF_PARTITIONS",
            "SCFC_DECODE", "SCF_MOD", "PREAMP")]
        lib.af_mp3_set_l3_tables(*[a.ctypes.data_as(i8p) for a in _keep])

        _install_celt(lib)
        _lib = lib
        _tables_loaded = True
        return _lib


def _install_celt(lib) -> None:
    """Register + install the CELT symbol-stage tables (af_host.cc:
    af_celt_set_tables / af_celt_decode_symbols)."""
    i8p = ctypes.POINTER(ctypes.c_uint8)
    s8p = ctypes.POINTER(ctypes.c_int8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.af_celt_set_tables.argtypes = [
        i8p, i8p, i8p, u16p, u16p, u16p, u16p,
        f64p, f64p, f64p, f64p, f64p,
        i8p, s8p, i8p, i8p, i8p, i16p, i8p, i8p, i8p, i8p, u16p, u64p,
    ]
    lib.af_celt_set_tables.restype = ctypes.c_int
    lib.af_celt_decode_symbols.argtypes = [
        i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f64p, f64p, i32p, u32p, f32p, i64p, i32p, f64p,
    ]
    lib.af_celt_decode_symbols.restype = ctypes.c_int
    lib.af_celt_finish_channel.argtypes = [
        f64p, ctypes.c_int32, i32p, f64p, f64p, f32p,
    ]
    lib.af_celt_finish_channel.restype = ctypes.c_int
    lib.af_silk_synth.argtypes = [
        f32p, f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        f32p, f32p, f32p, i32p, f32p, ctypes.c_float,
    ]
    lib.af_silk_synth.restype = ctypes.c_int
    lib.af_silk_excitation.argtypes = [
        i8p, ctypes.c_int32, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u16p, u16p, u16p, u16p, u16p, u16p, i32p, f32p,
    ]
    lib.af_silk_excitation.restype = ctypes.c_int
    lib.af_silk_lsf2lpc.argtypes = [i32p, ctypes.c_int32, i32p, i8p, f64p]
    lib.af_silk_lsf2lpc.restype = ctypes.c_int
    lib.af_ogg_crc.argtypes = [i8p, ctypes.c_int64, ctypes.c_uint32]
    lib.af_ogg_crc.restype = ctypes.c_uint32
    lib.af_vorbis_residue.argtypes = [
        i8p, ctypes.c_int64, i64p,
        i32p, i32p, i8p, i32p, f32p, i64p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, i8p,
        f32p, ctypes.c_int64, i64p, ctypes.c_int64,
    ]
    lib.af_vorbis_residue.restype = ctypes.c_int
    lib.af_vorbis_floor1.argtypes = [
        i8p, ctypes.c_int64, i64p,
        i32p, i32p, i8p, i32p,
        i32p, i64p,
        i32p, ctypes.c_int32, ctypes.c_int64,
        f32p, f32p, i8p,
    ]
    lib.af_vorbis_floor1.restype = ctypes.c_int

    from ..utils.tables import celt_tables as CT

    def u8(a):
        return np.ascontiguousarray(np.asarray(a).reshape(-1), np.uint8)

    tapset = np.zeros(5, np.uint16)
    tapset[:4] = CT.MODEL_TAPSET
    pvq_u = np.zeros((16, 178), np.uint64)
    for n, row in CT.PVQ_U_ROWS.items():
        # entries touched during decode are < 2^32 (the codeword index is
        # range-coder bounded); saturate the never-read bigint tail
        pvq_u[n] = np.array([min(v, (1 << 64) - 1) for v in row],
                            dtype=np.uint64)
    tabs = [
        u8(CT.FREQ_BANDS), u8(CT.FREQ_RANGE), u8(CT.LOG_FREQ_RANGE),
        tapset,
        np.asarray(CT.MODEL_SPREAD, np.uint16),
        np.asarray(CT.MODEL_ALLOC_TRIM, np.uint16),
        np.asarray(CT.MODEL_ENERGY_SMALL, np.uint16),
        np.asarray(CT.MEAN_ENERGY, np.float64),
        np.asarray(CT.ALPHA_COEF, np.float64),
        np.asarray(CT.BETA_COEF, np.float64),
        np.asarray(CT.WINDOW, np.float64),
        np.ascontiguousarray(np.asarray(CT.POSTFILTER_TAPS,
                                        np.float64).reshape(-1)),
        u8(CT.COARSE_ENERGY_DIST),
        np.ascontiguousarray(
            np.asarray(CT.TF_SELECT).reshape(-1), np.int8),
        u8(CT.STATIC_ALLOC), u8(CT.STATIC_CAPS), u8(CT.CACHE_BITS),
        np.asarray(CT.CACHE_INDEX, np.int16),
        u8(CT.LOG2_FRAC), u8(CT.BIT_INTERLEAVE), u8(CT.BIT_DEINTERLEAVE),
        u8(CT.HADAMARD_ORDERY),
        np.asarray(CT.QN_EXP2, np.uint16), pvq_u,
    ]
    ptrs = [a.ctypes.data_as(t)
            for a, t in zip(tabs, lib.af_celt_set_tables.argtypes)]
    lib.af_celt_set_tables(*ptrs)


_I8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _u8ptr(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), _I8P)


def _buf_ptr(data):
    """Zero-copy pointer to any buffer-protocol object (incl. read-only
    mmap views).  Returns (ptr, nbytes, keepalive)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return ctypes.cast(arr.ctypes.data, _I8P), arr.size, arr


def mp3_huffman(lib, maindata: bytes, start_bits: int, limit_bits: int,
                table_select, region_count, sfbtab, scf, big_values: int,
                count1_table: int):
    """Native mirror of models.mp3._huffman.  Returns (q, gains) or None."""
    q = np.zeros(576, dtype=np.int32)
    gains = np.zeros(576, dtype=np.float32)
    ts = np.asarray(table_select, dtype=np.int32)
    rc = np.asarray(region_count, dtype=np.int32)
    sfb = np.zeros(48, dtype=np.uint8)
    tab = np.asarray(sfbtab, dtype=np.uint8)
    sfb[: len(tab)] = tab
    scf_arr = np.asarray(scf, dtype=np.float32)
    end = lib.af_mp3_huffman(
        _u8ptr(maindata), len(maindata), start_bits, limit_bits,
        ts.ctypes.data_as(_I32P), rc.ctypes.data_as(_I32P),
        sfb.ctypes.data_as(_I8P), scf_arr.ctypes.data_as(_F32P),
        big_values, count1_table,
        q.ctypes.data_as(_I32P), gains.ctypes.data_as(_F32P),
    )
    if end < 0:
        return None
    return q, gains


def flac_parse_frame(lib, data, start_bits: int, streaminfo_bps: int,
                     channels: int, max_block: int):
    """Native mirror of FlacDecoder._parse_frame.  Returns dict or None."""
    residual = np.zeros((channels, max_block), dtype=np.int32)
    coeffs = np.zeros((channels, 32), dtype=np.int32)
    order = np.zeros(channels, dtype=np.int32)
    shift = np.zeros(channels, dtype=np.int32)
    wasted = np.zeros(channels, dtype=np.int32)
    bps = np.zeros(channels, dtype=np.int32)
    meta = np.zeros(8, dtype=np.int64)
    ptr, nbytes, _keep = _buf_ptr(data)
    rc = lib.af_flac_parse_frame(
        ptr, nbytes, start_bits,
        streaminfo_bps, channels, max_block,
        residual.ctypes.data_as(_I32P), coeffs.ctypes.data_as(_I32P),
        order.ctypes.data_as(_I32P), shift.ctypes.data_as(_I32P),
        wasted.ctypes.data_as(_I32P), bps.ctypes.data_as(_I32P),
        meta.ctypes.data_as(_I64P),
    )
    if rc != 0:
        return None
    blocksize = int(meta[0])
    return {
        "blocksize": blocksize,
        "chan_assignment": int(meta[1]),
        "residual": residual[:, :blocksize],
        "coeffs": coeffs,
        "order": order,
        "shift": shift,
        "wasted": wasted,
        "bps": bps,
        "end_bits": int(meta[3]),
    }


def flac_parse_window(lib, data, start_bits: int, streaminfo_bps: int,
                      channels: int, max_block: int, W: int):
    """Parse up to W consecutive frames in one C call (the scheduler's
    window unit — one FFI crossing + one allocation set per lane-window
    instead of per frame).  Returns (n_frames, residual [W*ch, max_block],
    coeffs [W*ch, 32], order/shift/wasted/bps [W*ch], meta [W, 4] int64
    rows: blocksize, chan_assignment, nch, end_bits) — n_frames may be 0."""
    ch = channels
    # np.empty, not zeros: the C parser fully writes residual[0:bs] for
    # every subframe type (constant/verbatim fill too), zeroes all 32
    # coeffs itself, and consumers only read rows/meta for f < n — zeroing
    # ~400 KB per lane-window here was ~20% of the whole host stage
    residual = np.empty((W * ch, max_block), dtype=np.int32)
    coeffs = np.empty((W * ch, 32), dtype=np.int32)
    osw = np.empty((4, W * ch), dtype=np.int32)  # order/shift/wasted/bps
    meta = np.empty((W, 4), dtype=np.int64)
    ptr, nbytes, _keep = _buf_ptr(data)
    n = lib.af_flac_parse_window(
        ptr, nbytes, start_bits, streaminfo_bps, ch, max_block, W,
        residual.ctypes.data_as(_I32P), coeffs.ctypes.data_as(_I32P),
        osw[0].ctypes.data_as(_I32P), osw[1].ctypes.data_as(_I32P),
        osw[2].ctypes.data_as(_I32P), osw[3].ctypes.data_as(_I32P),
        meta.ctypes.data_as(_I64P),
    )
    return n, residual, coeffs, osw[0], osw[1], osw[2], osw[3], meta


def mp3_granules_scf_huff(lib, hdr4: bytes, maindata: bytes,
                          gr_params: np.ndarray, sfbtabs: np.ndarray,
                          ngr: int, nch: int, ist_pos: np.ndarray):
    """Scalefactors + Huffman for every granule-channel of one frame.

    gr_params: [ngr*nch, 21] int32 (layout in af_host.cc); sfbtabs:
    [ngr*nch, 40] uint8; ist_pos: persistent [2, 40] int32 (updated).
    Returns (q [ngr,nch,576] i32, gains f32, ist_snapshots [ngr,40]) or
    None on invalid codes.
    """
    q = np.zeros((ngr, nch, 576), np.int32)
    gains = np.zeros((ngr, nch, 576), np.float32)
    snaps = np.zeros((ngr, 40), np.int32)
    rc = lib.af_mp3_granules_scf_huff(
        _u8ptr(hdr4), _u8ptr(maindata), len(maindata),
        gr_params.ctypes.data_as(_I32P), sfbtabs.ctypes.data_as(_I8P),
        ngr, nch, ist_pos.ctypes.data_as(_I32P),
        q.ctypes.data_as(_I32P), gains.ctypes.data_as(_F32P),
        snaps.ctypes.data_as(_I32P),
    )
    if rc != 0:
        return None
    return q, gains, snaps


_F64P = ctypes.POINTER(ctypes.c_double)


def celt_decode_symbols(lib, data, ec_state: np.ndarray, coded_channels: int,
                        frame_size: int, startband: int, endband: int,
                        output_channels: int, energy: np.ndarray,
                        prev_energy: np.ndarray, collapse: np.ndarray,
                        seed: int):
    """Native mirror of CeltDecoder.decode_frame_symbols' entropy +
    denormalize stage.  ec_state (int64[9]) and the state arrays are
    updated in place; returns (coeffs [2,960] f32, out_ints, out_doubles,
    seed) or None on a frame the C path rejects."""
    # no zeroing needed: the C stage memsets/overwrites every output
    coeffs = np.empty((2, 960), np.float32)
    out_i = np.zeros(8, np.int32)
    out_d = np.zeros(4, np.float64)
    seed_c = ctypes.c_uint32(seed)
    ptr, nbytes, _keep = _buf_ptr(data)
    rc = lib.af_celt_decode_symbols(
        ptr, nbytes, coded_channels, frame_size, startband, endband,
        output_channels,
        energy.ctypes.data_as(_F64P), prev_energy.ctypes.data_as(_F64P),
        collapse.ctypes.data_as(_I32P), ctypes.byref(seed_c),
        coeffs.ctypes.data_as(_F32P), ec_state.ctypes.data_as(_I64P),
        out_i.ctypes.data_as(_I32P), out_d.ctypes.data_as(_F64P),
    )
    if rc != 0:
        return None
    return coeffs, out_i, out_d, seed_c.value


def celt_finish_channel(lib, buf: np.ndarray, frame_size: int,
                        periods: np.ndarray, gains: np.ndarray,
                        deemph: float):
    """Native mirror of CeltDecoder._finish_channel (postfilter + buffer
    shift + deemphasis).  periods (int32[3]) and gains (f64[9]) are
    [old, cur, new] and updated in place; returns (pcm f32[frame_size],
    new deemph memory)."""
    out = np.empty(frame_size, np.float32)
    m = ctypes.c_double(deemph)
    lib.af_celt_finish_channel(
        buf.ctypes.data_as(_F64P), frame_size,
        periods.ctypes.data_as(_I32P), gains.ctypes.data_as(_F64P),
        ctypes.byref(m), out.ctypes.data_as(_F32P),
    )
    return out, m.value


def silk_synth(lib, residual, out, lpch, subframes, sflength, order,
               voiced, has_leadin, interp4, lpc_leadin, lpc_body,
               sf_gain, sf_pitchlag, sf_ltptaps, ltpscale):
    """Native mirror of SilkDecoder._decode_frame's synthesis loops
    (re-whitening + LTP + LPC) in SINGLE precision — the reference's own
    float pipeline (dopus.d:5168-5226 is FFmpeg's float SILK decoder).
    Buffers (np.float32) updated in place."""
    lib.af_silk_synth(
        residual.ctypes.data_as(_F32P), out.ctypes.data_as(_F32P),
        lpch.ctypes.data_as(_F32P), subframes, sflength, order, voiced,
        has_leadin, interp4,
        lpc_leadin.ctypes.data_as(_F32P), lpc_body.ctypes.data_as(_F32P),
        sf_gain.ctypes.data_as(_F32P), sf_pitchlag.ctypes.data_as(_I32P),
        sf_ltptaps.ctypes.data_as(_F32P), ltpscale,
    )


_U16P = ctypes.POINTER(ctypes.c_uint16)
_silk_exc_tables = None


def _get_silk_exc_tables():
    global _silk_exc_tables
    if _silk_exc_tables is None:
        from ..utils.tables import silk_tables as ST

        def u16(a):
            return np.ascontiguousarray(np.asarray(a).reshape(-1),
                                        np.uint16)

        _silk_exc_tables = (
            u16(ST.MODEL_LCG_SEED), u16(ST.MODEL_EXC_RATE),
            u16(ST.MODEL_PULSE_COUNT), u16(ST.MODEL_PULSE_LOCATION),
            u16(ST.MODEL_EXCITATION_LSB), u16(ST.MODEL_EXCITATION_SIGN),
            np.ascontiguousarray(
                np.asarray(ST.QUANT_OFFSET).reshape(-1), np.int32),
        )
    return _silk_exc_tables


def silk_excitation(lib, data, ec_state: np.ndarray, shellblocks: int,
                    voiced: int, qoffset_high: int, active: int):
    """Native mirror of SilkDecoder._decode_excitation.  ec_state
    (int64[9]) updated in place; returns the dequantized excitation
    (f32[shellblocks*16]; the quotients by 2^23 are exact in single)."""
    tabs = _get_silk_exc_tables()
    out = np.empty(shellblocks * 16, np.float32)
    ptr, nbytes, _keep = _buf_ptr(data)
    lib.af_silk_excitation(
        ptr, nbytes, ec_state.ctypes.data_as(_I64P),
        shellblocks, voiced, qoffset_high, active,
        tabs[0].ctypes.data_as(_U16P), tabs[1].ctypes.data_as(_U16P),
        tabs[2].ctypes.data_as(_U16P), tabs[3].ctypes.data_as(_U16P),
        tabs[4].ctypes.data_as(_U16P), tabs[5].ctypes.data_as(_U16P),
        tabs[6].ctypes.data_as(_I32P), out.ctypes.data_as(_F32P),
    )
    return out


_silk_lsf_tables = None


def silk_lsf2lpc(lib, nlsf, order: int):
    """Native mirror of models/silk.py _lsf2lpc (fixed-point NLSF->LPC)."""
    global _silk_lsf_tables
    if _silk_lsf_tables is None:
        from ..utils.tables import silk_tables as ST

        _silk_lsf_tables = (
            np.asarray(ST.COSINE, np.int32),
            np.asarray(ST.LSF_ORDERING_NBMB, np.uint8),
            np.asarray(ST.LSF_ORDERING_WB, np.uint8),
        )
    cosine, ord_nbmb, ord_wb = _silk_lsf_tables
    ordering = ord_wb if order == 16 else ord_nbmb
    nlsf_arr = np.asarray(nlsf[:order], np.int32)
    out = np.empty(order, np.float64)
    lib.af_silk_lsf2lpc(
        nlsf_arr.ctypes.data_as(_I32P), order,
        cosine.ctypes.data_as(_I32P), ordering.ctypes.data_as(_I8P),
        out.ctypes.data_as(_F64P),
    )
    return out


def ogg_crc(lib, data, crc: int = 0) -> int:
    """CRC-32 (0x04C11DB7, unreflected) over a buffer, continuing from
    crc."""
    ptr, nbytes, _keep = _buf_ptr(data)
    return int(lib.af_ogg_crc(ptr, nbytes, crc))


class VorbisCodebookBank:
    """Per-stream codebook pack for af_vorbis_residue: every codebook's
    two-level bit-reversed LUT and VQ vectors concatenated into flat
    arrays (models/vorbis.py Codebook keeps the Python-structured
    originals for the fallback path)."""

    _UNUSED = np.int32(np.iinfo(np.int32).min)

    def __init__(self, codebooks, l1_bits: int = 10):
        n = len(codebooks)
        self.lut1 = np.full((n << l1_bits,), self._UNUSED, np.int32)
        subs_off, subs_ext, subs_chunks = [], [], []
        vec_chunks = []
        self.vec_off = np.full(n, -1, np.int64)
        self.dims = np.zeros(n, np.int32)
        spos = vpos = 0
        for bi, cb in enumerate(codebooks):
            self.dims[bi] = cb.dims
            base = bi << l1_bits
            gsub0 = len(subs_off)
            for ext, sub in cb.subs:
                subs_off.append(spos)
                subs_ext.append(ext)
                chunk = np.full(1 << ext, self._UNUSED, np.int32)
                for k, e in enumerate(sub):
                    if e is not None:
                        chunk[k] = (e[0] << 24) | e[1]
                subs_chunks.append(chunk)
                spos += chunk.size
            for k, e in enumerate(cb.lut1):
                if e is None:
                    continue
                if e[0] < 0:
                    self.lut1[base + k] = -(gsub0 + (-e[0] - 1)) - 1
                else:
                    self.lut1[base + k] = (e[0] << 24) | e[1]
            if cb.vectors is not None:
                self.vec_off[bi] = vpos
                vec_chunks.append(
                    np.ascontiguousarray(cb.vectors.reshape(-1)))
                vpos += vec_chunks[-1].size
        self.subs_off = np.asarray(subs_off, np.int32)
        self.subs_ext = np.asarray(subs_ext, np.uint8)
        self.subs_flat = (np.concatenate(subs_chunks)
                          if subs_chunks else np.zeros(1, np.int32))
        self.vec_flat = (np.concatenate(vec_chunks)
                         if vec_chunks else np.zeros(1, np.float32))
        if self.subs_off.size == 0:
            self.subs_off = np.zeros(1, np.int32)
            self.subs_ext = np.zeros(1, np.uint8)


def vorbis_residue(lib, bank: VorbisCodebookBank, buf, nbits: int,
                   bitpos: int, classbook: int, classifications: int,
                   books: np.ndarray, rtype: int, part_size: int,
                   begin: int, eff_ch: int, partitions_to_read: int,
                   do_not_decode: np.ndarray, target: np.ndarray,
                   row_stride: int, classifs: np.ndarray) -> int:
    """Decode one residue block natively; returns the new bit position.
    target/classifs are updated in place (partial data stands at
    end-of-packet, matching the Python path)."""
    ptr, _, _keep = _buf_ptr(buf)
    pos = ctypes.c_int64(bitpos)
    lib.af_vorbis_residue(
        ptr, nbits, ctypes.byref(pos),
        bank.lut1.ctypes.data_as(_I32P),
        bank.subs_off.ctypes.data_as(_I32P),
        bank.subs_ext.ctypes.data_as(_I8P),
        bank.subs_flat.ctypes.data_as(_I32P),
        bank.vec_flat.ctypes.data_as(_F32P),
        bank.vec_off.ctypes.data_as(_I64P),
        bank.dims.ctypes.data_as(_I32P),
        classbook, classifications, books.ctypes.data_as(_I32P),
        rtype, part_size, begin, eff_ch, partitions_to_read,
        do_not_decode.ctypes.data_as(_I8P),
        target.ctypes.data_as(_F32P), row_stride,
        classifs.ctypes.data_as(_I64P), classifs.shape[1],
    )
    return pos.value


class VorbisFloorBank:
    """Per-stream floor1 config pack for af_vorbis_floor1: every floor's
    class tables, xlist, sort order, and neighbor pairs concatenated into
    one int32 blob (layout documented at af_host.cc:af_vorbis_floor1).
    Entries for floor0 configs (None in models/vorbis.py) stay -1 — a
    packet referencing one errors out before the native call."""

    def __init__(self, floors):
        blobs = []
        self.off = np.full(max(len(floors), 1), -1, np.int64)
        pos = 0
        for fi, fl in enumerate(floors):
            if fl is None:
                continue
            npts = len(fl.xlist)
            # header + class tables + xlist + sorted_idx + (lo,hi) pairs
            blob = np.zeros(3 + 31 + 16 * 3 + 128 + 4 * npts, np.int32)
            blob[0] = fl.partitions
            blob[1] = fl.multiplier
            blob[2] = npts
            blob[3 : 3 + len(fl.partition_class)] = fl.partition_class
            o = 3 + 31
            blob[o : o + len(fl.class_dims)] = fl.class_dims
            o += 16
            blob[o : o + len(fl.class_subclasses)] = fl.class_subclasses
            o += 16
            blob[o : o + len(fl.class_masterbooks)] = fl.class_masterbooks
            o += 16
            for ci, row in enumerate(fl.subclass_books):
                blob[o + 8 * ci : o + 8 * ci + len(row)] = row
            o += 128
            blob[o : o + npts] = fl.xlist
            o += npts
            blob[o : o + npts] = np.asarray(fl.sorted_idx, np.int32)
            o += npts
            for i in range(2, npts):
                lo, hi = fl.neighbors[i - 2]
                blob[o + 2 * i] = lo
                blob[o + 2 * i + 1] = hi
            self.off[fi] = pos
            blobs.append(blob)
            pos += blob.size
        self.blob = (np.concatenate(blobs) if blobs
                     else np.zeros(1, np.int32))


def vorbis_floor1(lib, cbank: VorbisCodebookBank, fbank: VorbisFloorBank,
                  buf, nbits: int, bitpos: int, ch_floor: np.ndarray,
                  n2: int, inv_db: np.ndarray, curves: np.ndarray,
                  used: np.ndarray) -> int:
    """Decode one packet's floor1 curves (all channels) natively; returns
    the new bit position.  curves [ch, n2] f32 and used [ch] u8 are filled
    in place; a channel hit by end-of-packet stays unused (Python
    parity)."""
    ptr, _, _keep = _buf_ptr(buf)
    pos = ctypes.c_int64(bitpos)
    lib.af_vorbis_floor1(
        ptr, nbits, ctypes.byref(pos),
        cbank.lut1.ctypes.data_as(_I32P),
        cbank.subs_off.ctypes.data_as(_I32P),
        cbank.subs_ext.ctypes.data_as(_I8P),
        cbank.subs_flat.ctypes.data_as(_I32P),
        fbank.blob.ctypes.data_as(_I32P),
        fbank.off.ctypes.data_as(_I64P),
        ch_floor.ctypes.data_as(_I32P), ch_floor.size, n2,
        inv_db.ctypes.data_as(_F32P),
        curves.ctypes.data_as(_F32P), used.ctypes.data_as(_I8P),
    )
    return pos.value


def mp3_parse_window(lib, view, off: int, hdr0: bytes, W: int, ngr: int,
                     nch: int, state, xq, aa, wt, flags,
                     free_format_bytes: int = 0):
    """Parse up to W frames of one stream into window tensors (one C call).

    ``state`` is (reserv_buf u8[511], reserv_len i32[1], ist_pos i32[2,40]);
    the window tensors are views over the lane's slots with shapes
    xq [W*ngr, nch, 576] f32 (requantized, stereo-mixed, reordered
    spectrum), aa [W*ngr, nch] i32, wt [W*ngr, nch, 32] i32, flags u8[W].
    Returns (frames_consumed, new_off).
    """
    reserv_buf, reserv_len, ist_pos = state
    ptr, nbytes, _keep = _buf_ptr(view)
    new_off = ctypes.c_int64(off)
    n = lib.af_mp3_parse_window(
        ptr, nbytes, off, _u8ptr(hdr0), W, free_format_bytes,
        reserv_buf.ctypes.data_as(_I8P),
        reserv_len.ctypes.data_as(_I32P),
        ist_pos.ctypes.data_as(_I32P),
        xq.ctypes.data_as(_F32P),
        aa.ctypes.data_as(_I32P), wt.ctypes.data_as(_I32P),
        flags.ctypes.data_as(_I8P), ctypes.byref(new_off),
    )
    return n, new_off.value


FRAME_WORDS = 1154  # af_host.cc AF_MP3_FRAME_WORDS


def mp3_parse_window_packed(lib, view, off: int, hdr0: bytes, W: int,
                            ngr: int, nch: int, state, bits, meta, scfq,
                            aa, wt, flags, free_format_bytes: int = 0,
                            ist=None):
    """Packed (device-Huffman) window parse: one C call per (stream,
    window) emits each frame's reservoir-spliced main data as big-endian
    uint32 words and then 2 zero words (a row of FRAME_WORDS a frame) + the
    FSM side info of each granule-channel lane (bit positions from its
    frame's first word) + int16 quarter-exponent scalefactors.

    bits [W, FRAME_WORDS] u32, meta [W*ngr*nch, 16] i32 (zeroed by
    the caller), scfq [W*ngr*nch, 40] i16, aa [W*ngr, nch] i32,
    wt [W*ngr, nch, 32] i32, flags u8[W], ist (optional, stereo) per-
    granule right-channel intensity positions [W*ngr, 40] i16 for the
    device pan mix (minimp3.d:963).
    Returns (frames_consumed, new_off, max_words: the widest lane reach,
    has_intensity).
    """
    reserv_buf, reserv_len, ist_pos = state
    ptr, nbytes, _keep = _buf_ptr(view)
    new_off = ctypes.c_int64(off)
    max_words = np.zeros(1, np.int32)
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _I16P = ctypes.POINTER(ctypes.c_int16)
    n = lib.af_mp3_parse_window_packed(
        ptr, nbytes, off, _u8ptr(hdr0), W, free_format_bytes,
        reserv_buf.ctypes.data_as(_I8P),
        reserv_len.ctypes.data_as(_I32P),
        ist_pos.ctypes.data_as(_I32P),
        bits.ctypes.data_as(_U32P),
        max_words.ctypes.data_as(_I32P),
        meta.ctypes.data_as(_I32P),
        scfq.ctypes.data_as(_I16P),
        ist.ctypes.data_as(_I16P) if ist is not None
        else ctypes.cast(None, _I16P),
        aa.ctypes.data_as(_I32P), wt.ctypes.data_as(_I32P),
        flags.ctypes.data_as(_I8P), ctypes.byref(new_off),
    )
    has_ist = bool(np.any(flags[:max(0, n)] & 4))
    return n, new_off.value, int(max_words[0]), has_ist


def buf_addr(data):
    """Raw integer address of a buffer-protocol object for the multi-lane
    entry points (cheaper than a per-call ctypes cast; the keepalive array must
    outlive every C call that uses the address)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.ctypes.data, arr.size, arr


def flac_parse_window_multi(lib, lanes, data_ptrs, data_lens, cur_bits,
                            bps_in, ch, stride, W, residual, coeffs,
                            order_o, shift_o, wasted_o, bps_o, meta,
                            n_out):
    """One C call Rice-decodes a whole lane CHUNK of packed FLAC windows
    into [B, W*ch, stride] batch rows.  stride must equal every lane's
    streaminfo max_block (it doubles as af_flac_parse_frame's
    validation bound); cur_bits is read-only — the Python post-pass
    advances it past the frames actually taken."""
    _U64P = ctypes.POINTER(ctypes.c_uint64)
    lanes = np.ascontiguousarray(lanes, np.int32)
    lib.af_flac_parse_window_multi(
        lanes.ctypes.data_as(_I32P), lanes.size,
        data_ptrs.ctypes.data_as(_U64P), data_lens.ctypes.data_as(_I64P),
        cur_bits.ctypes.data_as(_I64P), bps_in.ctypes.data_as(_I32P),
        ch, stride, W,
        residual.ctypes.data_as(_I32P), coeffs.ctypes.data_as(_I32P),
        order_o.ctypes.data_as(_I32P), shift_o.ctypes.data_as(_I32P),
        wasted_o.ctypes.data_as(_I32P), bps_o.ctypes.data_as(_I32P),
        meta.ctypes.data_as(_I64P), n_out.ctypes.data_as(_I32P),
    )


def flac_build_pool(lib, ptrs, offs, sizes, blk_b, pool, base_bits):
    """One C pass assembles the device-Rice frame pool: each raw frame
    copied to a BLK-aligned offset, whole pool byteswapped to the
    kernel's BE u32 word order.  pool is a zeroed u8 array; base_bits
    [n] receives each frame's first pool bit."""
    _U64P = ctypes.POINTER(ctypes.c_uint64)
    lib.af_flac_build_pool(
        ptrs.ctypes.data_as(_U64P), offs.ctypes.data_as(_I64P),
        sizes.ctypes.data_as(_I64P), ptrs.size, blk_b,
        pool.ctypes.data_as(_I8P), pool.size,
        base_bits.ctypes.data_as(_I64P))


def flac_sync_index_multi(lib, lanes, data_ptrs, data_lens, bps_in,
                          expect_ch, max_block, W, states, offs, dbits,
                          bs, ca, bps_out, n_out):
    """One C call frame-indexes a whole lane CHUNK (device-Rice mode's
    entire host stage).  states [B,3] rows are each lane's persistent
    sync state, updated in place; results land in the [B,W] rows."""
    _U64P = ctypes.POINTER(ctypes.c_uint64)
    lanes = np.ascontiguousarray(lanes, np.int32)
    lib.af_flac_sync_index_multi(
        lanes.ctypes.data_as(_I32P), lanes.size,
        data_ptrs.ctypes.data_as(_U64P), data_lens.ctypes.data_as(_I64P),
        bps_in.ctypes.data_as(_I32P), expect_ch, max_block, W,
        states.ctypes.data_as(_I64P), offs.ctypes.data_as(_I64P),
        dbits.ctypes.data_as(_I64P), bs.ctypes.data_as(_I32P),
        ca.ctypes.data_as(_I32P), bps_out.ctypes.data_as(_I32P),
        n_out.ctypes.data_as(_I32P),
    )


def mp3_parse_window_packed_multi(lib, lanes, data_ptrs, data_lens, offs,
                                  hdr0s, W, ffbytes, rb_all, rl_all,
                                  ist_all, bits, max_words_all, meta, scfq,
                                  ist_out, aa, wt, flags, n_out):
    """One C call parses a whole lane CHUNK of packed MP3 windows (the
    per-lane ctypes crossing cost more Python marshalling than the C
    parse itself at batch 1024).  All per-lane tensors are rows of the
    batch arrays; C derives lane pointers from base + lane * stride.
    offs / rb_all / rl_all / ist_all are updated in place; results land
    in n_out / max_words_all / flags rows."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _I16P = ctypes.POINTER(ctypes.c_int16)
    _U64P = ctypes.POINTER(ctypes.c_uint64)
    lanes = np.ascontiguousarray(lanes, np.int32)
    lib.af_mp3_parse_window_packed_multi(
        lanes.ctypes.data_as(_I32P), lanes.size,
        data_ptrs.ctypes.data_as(_U64P), data_lens.ctypes.data_as(_I64P),
        offs.ctypes.data_as(_I64P), hdr0s.ctypes.data_as(_I8P),
        W, ffbytes.ctypes.data_as(_I32P),
        rb_all.ctypes.data_as(_I8P), rl_all.ctypes.data_as(_I32P),
        ist_all.ctypes.data_as(_I32P),
        bits.ctypes.data_as(_U32P), bits[0].size,
        max_words_all.ctypes.data_as(_I32P),
        meta.ctypes.data_as(_I32P), meta[0].size,
        scfq.ctypes.data_as(_I16P), scfq[0].size,
        ist_out.ctypes.data_as(_I16P) if ist_out is not None
        else ctypes.cast(None, _I16P),
        ist_out[0].size if ist_out is not None else 0,
        aa.ctypes.data_as(_I32P), aa[0].size,
        wt.ctypes.data_as(_I32P), wt[0].size,
        flags.ctypes.data_as(_I8P), flags[0].size,
        n_out.ctypes.data_as(_I32P),
    )


def flac_sync_index(lib, view, off: int, streaminfo_bps: int,
                    channels: int, max_block: int, max_frames: int,
                    state):
    """Byte-level FLAC frame index (af_flac_sync_index): header-validated
    frame offsets WITHOUT walking the Rice residuals — the host side of
    the device-Rice mode.  state: int64[3] (expected number, sample-
    numbering flag, resume byte); frame 0 passes state[0] = -1.
    Returns (n, offs, data_bits, bs, ca, bps) arrays of length n."""
    ptr, nbytes, _keep = _buf_ptr(view)
    offs = np.empty(max_frames, np.int64)
    data_bits = np.empty(max_frames, np.int64)
    bs = np.empty(max_frames, np.int32)
    ca = np.empty(max_frames, np.int32)
    bps = np.empty(max_frames, np.int32)
    _I64P = ctypes.POINTER(ctypes.c_int64)
    n = lib.af_flac_sync_index(
        ptr, nbytes, off, streaminfo_bps, channels, max_block, max_frames,
        state.ctypes.data_as(_I64P),
        offs.ctypes.data_as(_I64P), data_bits.ctypes.data_as(_I64P),
        bs.ctypes.data_as(_I32P), ca.ctypes.data_as(_I32P),
        bps.ctypes.data_as(_I32P))
    return n, offs[:n], data_bits[:n], bs[:n], ca[:n], bps[:n]


def mp3_index(lib, view, hdr0: bytes, free_format_bytes: int, layer: int,
              spf_ch: int, state, offsets, samples) -> int:
    """Native frame-index walk (af_mp3_index): fills per-frame offsets +
    cumulative samples while headers match hdr0; state [4] int64 carries
    (total, reserv, had_success, off) across calls so the python caller
    can chunk the walk and take over on resync."""
    ptr, nbytes, _keep = _buf_ptr(view)
    _I64P = ctypes.POINTER(ctypes.c_int64)
    return int(lib.af_mp3_index(
        ptr, nbytes, _u8ptr(hdr0), free_format_bytes, layer, spf_ch,
        offsets.shape[0],
        offsets.ctypes.data_as(_I64P),
        samples.ctypes.data_as(_I64P),
        state.ctypes.data_as(_I64P)))
