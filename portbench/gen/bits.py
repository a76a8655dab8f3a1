"""Vectorised bit writing and CRCs for the stream generators.

A stream is described as fields: (bit position, value, width), MSB first,
at most 57 bits wide.  Fields never overlap, so they are OR-ed into 64-bit
big-endian words in a few array passes, with no loop over bits or fields.
"""

from __future__ import annotations

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def pack(pos, val, width, n_bytes: int) -> np.ndarray:
    """Bytes (uint8[n_bytes]) holding every field (pos, val, width): field i
    occupies bits pos[i] .. pos[i] + width[i] - 1, MSB first.  Bits no field
    covers are zero.  Fields of width 0 are ignored."""
    pos = np.asarray(pos, np.int64)
    width = np.asarray(width, np.int64)
    keep = width > 0
    pos, width = pos[keep], width[keep]
    val = np.asarray(val, np.uint64)[keep] & (
        (np.uint64(1) << width.astype(np.uint64)) - np.uint64(1))
    if pos.size and (width.max() > 57 or pos.min() < 0
                     or (pos + width).max() > 8 * n_bytes):
        raise ValueError("field wider than 57 bits or out of range")
    if np.any(pos[1:] < pos[:-1]):
        order = np.argsort(pos, kind="stable")
        pos, width, val = pos[order], width[order], val[order]
    n_words = (n_bytes + 7) // 8 + 1
    words = np.zeros(n_words, np.uint64)
    w = pos >> 6
    end = (pos & 63) + width
    fits = end <= 64
    lo = np.where(fits, val << (64 - np.minimum(end, 64)).astype(np.uint64),
                  val >> np.maximum(end - 64, 0).astype(np.uint64))
    if w.size:
        first = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
        words[w[first]] |= np.bitwise_or.reduceat(lo, first)
        sp = ~fits
        # at most one field straddles each word boundary: no duplicates
        words[w[sp] + 1] |= (val[sp] << (128 - end[sp]).astype(np.uint64)) \
            & _MASK64
    return words.astype(">u8").view(np.uint8)[:n_bytes].copy()


def _crc_table(poly: int, bits: int) -> np.ndarray:
    top = 1 << (bits - 1)
    mask = (1 << bits) - 1
    table = np.zeros(256, np.int64)
    for b in range(256):
        crc = b << (bits - 8)
        for _ in range(8):
            crc = (crc << 1) ^ poly if crc & top else crc << 1
            crc &= mask
        table[b] = crc
    return table


CRC8_TABLE = _crc_table(0x07, 8)
CRC16_TABLE = _crc_table(0x8005, 16)


def crc_rows(rows: np.ndarray, lengths, bits: int) -> np.ndarray:
    """FLAC's CRC-8 (poly 0x07) or CRC-16 (poly 0x8005), initial value 0,
    of each row's first lengths[i] bytes: one pass over byte columns,
    vectorised over rows."""
    table = CRC8_TABLE if bits == 8 else CRC16_TABLE
    lengths = np.asarray(lengths, np.int64)
    crc = np.zeros(rows.shape[0], np.int64)
    for j in range(int(lengths.max(initial=0))):
        live = lengths > j
        b = rows[:, j].astype(np.int64)
        if bits == 8:
            nxt = table[crc ^ b]
        else:
            nxt = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ b) & 0xFF]
        crc = np.where(live, nxt, crc)
    return crc
