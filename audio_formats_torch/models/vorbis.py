"""Ogg Vorbis decoder.

Parity target: stb_vorbis2.d — Ogg page/packet layer (here io/ogg.py),
setup-header parse (start_decoder, stb_vorbis2.d:2669: codebooks with
ordered/sparse lengths and lookup types 1/2, floor1, residues 0/1/2,
mappings, modes), packet decode (floor1 posts + render_line Bresenham curve
via the inverse-dB table, residue partition decode with coupled-channel
interleave, inverse coupling stb_vorbis2.d:2495-2514), IMDCT (ops/mdct.py
matmul form of stb_vorbis2.d:1941-2250), lapped windowing per the
finish_frame contract (stb_vorbis2.d:2606-2640), first-frame discard
(vorbis_pump_first_frame), last-page granule duration
(stb_vorbis2.d:3797-3869) and sample-exact page-anchor seek
(seek_to_sample_coarse, stb_vorbis2.d:3538-3695).

Host side: all entropy decoding (codebooks, floor posts, residue) and the
integer Bresenham floor curve (vectorized closed form of the spec's
render_line).  The single-stream decoder also runs its IMDCT (an f64 FFT,
ops/mdct.imdct_host) and lapped overlap-add on the host; the batch path
(parallel/batch.py) runs both on the device, the IMDCT as a matmul and the
lapped chain as K11 (ops/vorbis_win.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import AudioFileFormat
from ..errors import AudioFormatError
from ..host import native
from ..io import ogg
from ..io.bits import BitReaderLSB
from ..io.source import ByteSource
from ..ops import mdct as mdct_ops
from ..utils.tables.vorbis_tables import INVERSE_DB_TABLE


def ilog(x: int) -> int:
    r = 0
    while x > 0:
        r += 1
        x >>= 1
    return r


def _float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exp = (x & 0x7FE00000) >> 21
    v = mantissa * (2.0 ** (exp - 788))
    return -v if sign else v


def _lookup1_values(entries: int, dims: int) -> int:
    r = int(np.floor(np.exp(np.log(entries) / dims)))
    if int(np.floor(pow(r + 1, dims))) <= entries:
        r += 1
    assert pow(r + 1, dims) > entries
    assert pow(r, dims) <= entries
    return r


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

_L1 = 10  # first-level LUT bits


class Codebook:
    __slots__ = ("dims", "entries", "lut1", "subs", "vectors", "seq_p")

    def __init__(self, br: BitReaderLSB):
        if br.read(24) != 0x564342:
            raise AudioFormatError("Vorbis: bad codebook sync")
        self.dims = br.read(16)
        self.entries = br.read(24)
        ordered = br.read(1)
        lengths = np.zeros(self.entries, dtype=np.int32)
        if not ordered:
            sparse = br.read(1)
            for i in range(self.entries):
                if sparse:
                    if br.read(1):
                        lengths[i] = br.read(5) + 1
                    else:
                        lengths[i] = 0  # unused entry
                else:
                    lengths[i] = br.read(5) + 1
        else:
            cur_len = br.read(5) + 1
            i = 0
            while i < self.entries:
                num = br.read(ilog(self.entries - i))
                lengths[i : i + num] = cur_len
                i += num
                cur_len += 1
                if cur_len > 32:
                    break

        codes = self._assign_codewords(lengths)
        self._build_lut(codes, lengths)

        lookup = br.read(4)
        self.vectors = None
        self.seq_p = 0
        if lookup == 0:
            return
        if lookup > 2:
            raise AudioFormatError("Vorbis: reserved codebook lookup type")
        minimum = _float32_unpack(br.read(32))
        delta = _float32_unpack(br.read(32))
        value_bits = br.read(4) + 1
        self.seq_p = br.read(1)
        if lookup == 1:
            quantvals = _lookup1_values(self.entries, self.dims)
        else:
            quantvals = self.entries * self.dims
        mults = np.array([br.read(value_bits) for _ in range(quantvals)],
                         dtype=np.float64)
        vec = np.zeros((self.entries, self.dims), dtype=np.float32)
        if lookup == 1:
            for e in range(self.entries):
                last = 0.0
                idx_div = 1
                for d in range(self.dims):
                    idx = (e // idx_div) % quantvals
                    v = mults[idx] * delta + minimum + last
                    vec[e, d] = v
                    if self.seq_p:
                        last = v
                    idx_div *= quantvals
        else:
            for e in range(self.entries):
                last = 0.0
                for d in range(self.dims):
                    v = mults[e * self.dims + d] * delta + minimum + last
                    vec[e, d] = v
                    if self.seq_p:
                        last = v
        self.vectors = vec

    @staticmethod
    def _assign_codewords(lengths: np.ndarray) -> np.ndarray:
        """Canonical Vorbis codeword assignment (spec §3.2.1)."""
        codes = np.zeros(len(lengths), dtype=np.uint32)
        used = np.flatnonzero(lengths > 0)
        if used.size == 0:
            return codes
        if used.size == 1:
            codes[used[0]] = 0
            return codes
        available = [0] * 33
        first = True
        for i in used:
            ln = int(lengths[i])
            if first:
                codes[i] = 0
                for j in range(1, ln + 1):
                    available[j] = 1 << (32 - j)
                first = False
                continue
            # find lowest available marker at depth <= ln
            j = ln
            while j > 0 and not available[j]:
                j -= 1
            if j == 0:
                raise AudioFormatError("Vorbis: over-subscribed codebook")
            res = available[j]
            available[j] = 0
            codes[i] = res >> (32 - ln)
            # split the remainder back into markers
            for k in range(j + 1, ln + 1):
                available[k] = res + (1 << (32 - k))
        return codes

    def _build_lut(self, codes, lengths) -> None:
        """LUTs keyed on BIT-REVERSED codewords (Vorbis reads Huffman MSB of
        the codeword first from an LSB-first stream)."""
        lut1 = [None] * (1 << _L1)
        long_groups = {}
        for i in np.flatnonzero(lengths > 0):
            ln = int(lengths[i])
            rev = int(f"{int(codes[i]):0{ln}b}"[::-1], 2) if ln else 0
            if ln <= _L1:
                for j in range(1 << (_L1 - ln)):
                    lut1[rev | (j << ln)] = (ln, int(i))
            else:
                prefix = rev & ((1 << _L1) - 1)
                long_groups.setdefault(prefix, []).append((rev, ln, int(i)))
        subs = []
        for prefix, group in long_groups.items():
            maxlen = max(ln for _, ln, _ in group)
            ext = maxlen - _L1
            sub = [None] * (1 << ext)
            for rev, ln, entry in group:
                rest = rev >> _L1
                for j in range(1 << (maxlen - ln)):
                    sub[rest | (j << (ln - _L1))] = (ln, entry)
            subs.append((ext, sub))
            lut1[prefix] = (-len(subs), None)
        self.lut1 = lut1
        self.subs = subs

    def decode(self, br: BitReaderLSB) -> int:
        peek = br.peek(24)
        e = self.lut1[peek & ((1 << _L1) - 1)]
        if e is None:
            raise AudioFormatError("Vorbis: invalid codeword")
        if e[0] < 0:
            ext, sub = self.subs[-e[0] - 1]
            e = sub[(peek >> _L1) & ((1 << ext) - 1)]
            if e is None:
                raise AudioFormatError("Vorbis: invalid codeword")
        br.skip(e[0])
        return e[1]


# ---------------------------------------------------------------------------
# Setup structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Floor1:
    partitions: int
    partition_class: List[int]
    class_dims: List[int]
    class_subclasses: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]
    multiplier: int
    xlist: List[int]
    sorted_idx: np.ndarray
    neighbors: List[tuple]


@dataclasses.dataclass
class Residue:
    rtype: int
    begin: int
    end: int
    part_size: int
    classifications: int
    classbook: int
    books: List[List[int]]


@dataclasses.dataclass
class Mapping:
    submaps: int
    coupling_mag: List[int]
    coupling_ang: List[int]
    mux: List[int]
    submap_floor: List[int]
    submap_residue: List[int]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def probe(src: ByteSource, device="cuda"):
    """A VorbisDecoder for an Ogg Vorbis stream, else None.  The decoder
    works on the host; `device` is taken for the cascade's uniform call."""
    head = src.peek(64)
    if len(head) < 35 or bytes(head[:4]) != b"OggS":
        return None
    # first page's first packet must be the Vorbis ID header
    page = ogg.parse_page(src.view(), 0)
    if page is None:
        return None
    body = src.view()[page.body_offset : page.body_offset + page.body_size]
    if len(body) < 7 or bytes(body[:7]) != b"\x01vorbis":
        return None
    try:
        return VorbisDecoder(src)
    except AudioFormatError:
        return None


class VorbisDecoder:
    format = AudioFileFormat.ogg

    def __init__(self, src: ByteSource):
        self._src = src
        self._view = src.view()
        self._parse_headers()
        self._page_index = ogg.page_offsets(self._view, self._serial)
        total = ogg.last_granule(self._view, self._serial)
        self.length_frames = max(0, int(total)) if total >= 0 else 0
        self._start_stream()

    # ------------------------------------------------------------- headers
    def _parse_headers(self) -> None:
        reader = ogg.OggPacketReader(self._view)
        pk = reader.next_packet()
        if pk is None:
            raise AudioFormatError("Vorbis: no ID header")
        ident, _ = pk
        if len(ident) < 30 or ident[:7] != b"\x01vorbis":
            raise AudioFormatError("Vorbis: bad ID header")
        page0 = ogg.parse_page(self._view, 0)
        self._serial = page0.serial
        br = BitReaderLSB(ident, 7)
        version = br.read(32)
        if version != 0:
            raise AudioFormatError("Vorbis: unsupported version")
        self.channels = br.read(8)
        self.sample_rate = br.read(32)
        br.read(32)  # bitrate max
        br.read(32)  # nominal
        br.read(32)  # min
        self._bs0 = 1 << br.read(4)
        self._bs1 = 1 << br.read(4)
        if not (64 <= self._bs0 <= self._bs1 <= 8192) or not br.read(1):
            raise AudioFormatError("Vorbis: invalid blocksizes")
        if self.channels == 0 or self.sample_rate == 0:
            raise AudioFormatError("Vorbis: invalid ID header")

        pk = reader.next_packet()  # comment header
        if pk is None or pk[0][:7] != b"\x03vorbis":
            raise AudioFormatError("Vorbis: missing comment header")
        pk = reader.next_packet()
        if pk is None or pk[0][:7] != b"\x05vorbis":
            raise AudioFormatError("Vorbis: missing setup header")
        self._parse_setup(pk[0])
        self._data_start = reader._pos  # byte offset after header pages

    def _parse_setup(self, setup: bytes) -> None:
        br = BitReaderLSB(setup, 7)
        n_books = br.read(8) + 1
        self._codebooks = [Codebook(br) for _ in range(n_books)]
        self._cbank = None  # lazy native codebook pack (host/native.py)
        self._fbank = None  # lazy native floor1 config pack

        # time transforms (placeholder in Vorbis I)
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise AudioFormatError("Vorbis: bad time transform")

        self._floors = []
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            if ftype == 0:
                # floor0 configs parse at setup (keeping the header bit
                # stream aligned); only a packet that USES one errors —
                # matching stb_vorbis, which accepts floor0 setup
                # (stb_vorbis2.d:3019-3031) and fails at decode time
                # (stb_vorbis2.d:2260)
                br.read(8)   # order
                br.read(16)  # rate
                br.read(16)  # bark_map_size
                br.read(6)   # amplitude_bits
                br.read(8)   # amplitude_offset
                n_books = br.read(4) + 1
                for _ in range(n_books):
                    if br.read(8) >= len(self._codebooks):
                        raise AudioFormatError("Vorbis: bad floor0 book")
                self._floors.append(None)  # floor0 marker: error on use
                continue
            if ftype != 1:
                raise AudioFormatError("Vorbis: bad floor type")
            partitions = br.read(5)
            partition_class = [br.read(4) for _ in range(partitions)]
            maxclass = max(partition_class) if partitions else -1
            class_dims = []
            class_subclasses = []
            class_masterbooks = []
            subclass_books = []
            for c in range(maxclass + 1):
                class_dims.append(br.read(3) + 1)
                sub = br.read(2)
                class_subclasses.append(sub)
                class_masterbooks.append(br.read(8) if sub else -1)
                subclass_books.append(
                    [br.read(8) - 1 for _ in range(1 << sub)]
                )
            multiplier = br.read(2) + 1
            rangebits = br.read(4)
            xlist = [0, 1 << rangebits]
            for p in range(partitions):
                cls = partition_class[p]
                for _ in range(class_dims[cls]):
                    xlist.append(br.read(rangebits))
            sorted_idx = np.argsort(np.array(xlist, dtype=np.int64),
                                    kind="stable")
            # low/high neighbors per spec (greatest below / least above
            # among PRECEDING entries)
            neighbors = []
            for i in range(2, len(xlist)):
                lo = 0
                hi = 1
                for j in range(i):
                    if xlist[lo] < xlist[j] < xlist[i]:
                        lo = j
                    if xlist[i] < xlist[j] < xlist[hi]:
                        hi = j
                neighbors.append((lo, hi))
            self._floors.append(Floor1(
                partitions, partition_class, class_dims, class_subclasses,
                class_masterbooks, subclass_books, multiplier, xlist,
                sorted_idx, neighbors,
            ))

        self._residues = []
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype > 2:
                raise AudioFormatError("Vorbis: bad residue type")
            begin = br.read(24)
            end = br.read(24)
            part_size = br.read(24) + 1
            classifications = br.read(6) + 1
            classbook = br.read(8)
            cascade = []
            for _ in range(classifications):
                high = 0
                low = br.read(3)
                if br.read(1):
                    high = br.read(5)
                cascade.append((high << 3) | low)
            books = []
            for c in range(classifications):
                row = []
                for pass_ in range(8):
                    if cascade[c] & (1 << pass_):
                        row.append(br.read(8))
                    else:
                        row.append(-1)
                books.append(row)
            self._residues.append(Residue(
                rtype, begin, end, part_size, classifications, classbook,
                books,
            ))

        self._mappings = []
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise AudioFormatError("Vorbis: bad mapping type")
            submaps = br.read(4) + 1 if br.read(1) else 1
            coupling_mag = []
            coupling_ang = []
            if br.read(1):
                steps = br.read(8) + 1
                bits = ilog(self.channels - 1)
                for _ in range(steps):
                    coupling_mag.append(br.read(bits))
                    coupling_ang.append(br.read(bits))
            if br.read(2) != 0:
                raise AudioFormatError("Vorbis: reserved mapping bits")
            if submaps > 1:
                mux = [br.read(4) for _ in range(self.channels)]
            else:
                mux = [0] * self.channels
            submap_floor = []
            submap_residue = []
            for _ in range(submaps):
                br.read(8)  # unused time config
                submap_floor.append(br.read(8))
                submap_residue.append(br.read(8))
            self._mappings.append(Mapping(
                submaps, coupling_mag, coupling_ang, mux, submap_floor,
                submap_residue,
            ))

        self._modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read(1)
            if br.read(16) != 0 or br.read(16) != 0:
                raise AudioFormatError("Vorbis: bad mode transform/window")
            mapping = br.read(8)
            self._modes.append((blockflag, mapping))
        if not br.read(1):
            raise AudioFormatError("Vorbis: setup framing error")

    # -------------------------------------------------------------- stream
    def _start_stream(self) -> None:
        self._reader = ogg.OggPacketReader(self._view, self._serial,
                                           self._data_start)
        self._prev: Optional[np.ndarray] = None  # [ch, prev_len]
        self._pos = 0  # absolute sample index of the next returned sample
        self._emitted = 0
        self._buf = np.zeros((0, self.channels), np.float32)
        self._buf_start = 0

    # ---------------------------------------------------------- floor curve
    def _decode_floor1(self, br: BitReaderLSB, fl: Floor1, n2: int):
        """Returns the multiplicative floor curve [n2] or None (unused)."""
        if not br.read(1):
            return None
        ranges = [256, 128, 86, 64][fl.multiplier - 1]
        ybits = ilog(ranges - 1)
        y = [br.read(ybits), br.read(ybits)]
        for p in range(fl.partitions):
            cls = fl.partition_class[p]
            cdim = fl.class_dims[cls]
            cbits = fl.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = self._codebooks[fl.class_masterbooks[cls]].decode(br)
            for _ in range(cdim):
                book = fl.subclass_books[cls][cval & csub]
                cval >>= cbits
                if book >= 0:
                    y.append(self._codebooks[book].decode(br))
                else:
                    y.append(0)

        # amplitude synthesis (spec §7.2.4)
        n_pts = len(fl.xlist)
        final_y = [0] * n_pts
        step2 = [False] * n_pts
        final_y[0] = y[0]
        final_y[1] = y[1]
        step2[0] = step2[1] = True
        for i in range(2, n_pts):
            lo, hi = fl.neighbors[i - 2]
            pred = _render_point(fl.xlist[lo], final_y[lo],
                                 fl.xlist[hi], final_y[hi], fl.xlist[i])
            val = y[i]
            high_room = ranges - pred
            low_room = pred
            room = 2 * min(high_room, low_room)
            if val:
                step2[lo] = True
                step2[hi] = True
                step2[i] = True
                if val >= room:
                    if high_room > low_room:
                        final_y[i] = val - low_room + pred
                    else:
                        final_y[i] = pred - val + high_room - 1
                else:
                    if val & 1:
                        final_y[i] = pred - ((val + 1) >> 1)
                    else:
                        final_y[i] = pred + (val >> 1)
            else:
                step2[i] = False
                final_y[i] = pred

        # curve synthesis: walk sorted points, draw lines between step2 pts
        # (do_floor, stb_vorbis2.d:2255-2295)
        curve = np.zeros(n2, dtype=np.float32)
        mult = fl.multiplier
        xs = fl.xlist
        order = fl.sorted_idx
        lx = 0
        ly = final_y[int(order[0])] * mult
        for idx in order[1:]:
            idx = int(idx)
            if not step2[idx]:
                continue
            hx = xs[idx]
            hy = final_y[idx] * mult
            if lx < n2:
                _render_line(lx, ly, min(hx, n2), hy, curve)
            lx, ly = hx, hy
        if lx < n2:  # constant continuation at the last post's level
            curve[lx:] = INVERSE_DB_TABLE[min(ly, 255)]
        return curve

    # --------------------------------------------------------------- residue
    def _decode_residue(self, br: BitReaderLSB, res: Residue, n2: int,
                        do_not_decode: List[bool]) -> np.ndarray:
        """Returns [ch_in_submap, n2] float residue vectors."""
        ch = len(do_not_decode)
        out = np.zeros((ch, n2), dtype=np.float32)
        rtype = res.rtype
        if rtype == 2:
            if all(do_not_decode):
                return out
            eff_ch = 1
            vec = np.zeros(ch * n2, dtype=np.float32)
        else:
            eff_ch = ch
            vec = None

        actual_size = n2 if rtype != 2 else n2 * ch
        begin = min(res.begin, actual_size)
        end = min(res.end, actual_size)
        n_to_read = end - begin
        if n_to_read == 0:
            return out
        classbook = self._codebooks[res.classbook]
        cw = classbook.dims
        partitions_to_read = n_to_read // res.part_size

        classifs = np.zeros((eff_ch, partitions_to_read + cw), dtype=np.int64)
        lib = native.get_lib()
        if lib is not None:
            # C mirror (af_host.cc:af_vorbis_residue) over the packed
            # codebook bank; end-of-packet partials stand either way
            if self._cbank is None:
                self._cbank = native.VorbisCodebookBank(self._codebooks)
            books_flat = getattr(res, "books_flat", None)
            if books_flat is None:
                books_flat = np.full((res.classifications, 8), -1, np.int32)
                for c in range(res.classifications):
                    books_flat[c] = res.books[c]
                res.books_flat = books_flat
            dnd = np.array(
                [1 if d else 0 for d in do_not_decode[:eff_ch]] or [0],
                np.uint8)
            target = vec if rtype == 2 else out
            row_stride = 0 if rtype == 2 else out.shape[1]
            br._bitpos = native.vorbis_residue(
                lib, self._cbank, br._buf, br._nbits, br._bitpos,
                res.classbook, res.classifications, books_flat, rtype,
                res.part_size, begin, eff_ch, partitions_to_read, dnd,
                target, row_stride, classifs)
        else:
            try:
                self._residue_passes(br, res, classbook, cw, eff_ch,
                                     partitions_to_read, begin,
                                     do_not_decode, rtype, out, vec,
                                     classifs)
            except AudioFormatError:
                pass  # end-of-packet: partial residue data stands

        if rtype == 2:
            for j in range(ch):
                out[j] = vec[j::ch]
        return out

    def _residue_passes(self, br, res, classbook, cw, eff_ch,
                        partitions_to_read, begin, do_not_decode, rtype,
                        out, vec, classifs):
        for pass_ in range(8):
            pcount = 0
            while pcount < partitions_to_read:
                if pass_ == 0:
                    for j in range(eff_ch):
                        if rtype != 2 and do_not_decode[j]:
                            continue
                        temp = classbook.decode(br)
                        for i in range(cw - 1, -1, -1):
                            classifs[j, pcount + i] = temp % res.classifications
                            temp //= res.classifications
                for i in range(cw):
                    if pcount >= partitions_to_read:
                        break
                    offset = begin + pcount * res.part_size
                    for j in range(eff_ch):
                        if rtype != 2 and do_not_decode[j]:
                            continue
                        vqclass = int(classifs[j, pcount])
                        book_idx = res.books[vqclass][pass_]
                        if book_idx < 0:
                            continue
                        book = self._codebooks[book_idx]
                        target = vec if rtype == 2 else out[j]
                        if rtype == 0:
                            step = res.part_size // book.dims
                            for k in range(step):
                                entry = book.decode(br)
                                target[offset + k::step][: book.dims] += (
                                    book.vectors[entry]
                                )
                        else:
                            k = 0
                            while k < res.part_size:
                                entry = book.decode(br)
                                d = book.dims
                                target[offset + k : offset + k + d] += (
                                    book.vectors[entry]
                                )
                                k += d
                    pcount += 1

    # ---------------------------------------------------------- packet decode
    def _decode_packet(self, packet: bytes, granule):
        """Returns (pcm [ret, ch] float32 | None, virtual_ret).

        ``pcm`` is None for lap-priming packets (no previous window);
        ``virtual_ret`` is the sample count the packet *would* have returned
        — needed for position accounting after a seek."""
        ent = self._packet_entropy(packet)
        if ent is None:
            return None, 0
        spec, geom = ent
        y = mdct_ops.imdct_host(spec, geom[0])  # [ch, n] raw (writable)
        return self._finish_packet(y, geom, granule)

    def _packet_entropy(self, packet: bytes):
        """Host entropy half of one audio packet: floors, residues,
        coupling, floor-dot — everything up to the IMDCT.  Returns
        (spec [ch, n/2] f32, (n, left_start, right_start, right_end)) or
        None for non-audio/invalid packets.  The batched scheduler stacks
        many lanes' spectra into one device IMDCT matmul."""
        br = BitReaderLSB(packet)
        try:
            if br.read(1) != 0:
                return None  # not an audio packet
            mode_idx = br.read(ilog(len(self._modes) - 1))
        except AudioFormatError:
            return None
        if mode_idx >= len(self._modes):
            return None
        blockflag, mapping_idx = self._modes[mode_idx]
        m = self._mappings[mapping_idx]
        n = self._bs1 if blockflag else self._bs0
        prev_flag = next_flag = 0
        if blockflag:
            prev_flag = br.read(1)
            next_flag = br.read(1)
        n2 = n >> 1
        window_center = n2
        if blockflag and not prev_flag:
            left_start = (n - self._bs0) >> 2
        else:
            left_start = 0
        if blockflag and not next_flag:
            right_start = (n * 3 - self._bs0) >> 2
            right_end = (n * 3 + self._bs0) >> 2
        else:
            right_start = window_center
            right_end = n

        ch = self.channels
        # floors (end-of-packet mid-floor leaves remaining channels unused,
        # Vorbis I spec §1.3.2/4.3.2)
        curves = [None] * ch
        zero_channel = [True] * ch
        for c in range(ch):
            if self._floors[m.submap_floor[m.mux[c]]] is None:
                # a packet actually using a floor0 config is an error —
                # but only now, not at setup (stb_vorbis2.d:2260)
                raise AudioFormatError("Vorbis: floor type 0 unsupported")
        lib = native.get_lib()
        if lib is not None:
            # C mirror (af_host.cc:af_vorbis_floor1) over the packed
            # codebook + floor banks; one call decodes every channel's
            # curve (A/B bit-identical vs the Python loop below)
            if self._cbank is None:
                self._cbank = native.VorbisCodebookBank(self._codebooks)
            if self._fbank is None:
                self._fbank = native.VorbisFloorBank(self._floors)
            chf = getattr(m, "ch_floor_np", None)
            if chf is None:
                chf = np.array([m.submap_floor[m.mux[c]]
                                for c in range(ch)], np.int32)
                m.ch_floor_np = chf
            curves_arr = np.empty((ch, n2), np.float32)
            used = np.zeros(ch, np.uint8)
            br._bitpos = native.vorbis_floor1(
                lib, self._cbank, self._fbank, br._buf, br._nbits,
                br._bitpos, chf, n2, INVERSE_DB_TABLE, curves_arr, used)
            for c in range(ch):
                if used[c]:
                    curves[c] = curves_arr[c]
                    zero_channel[c] = False
        else:
            try:
                for c in range(ch):
                    fl = self._floors[m.submap_floor[m.mux[c]]]
                    curve = self._decode_floor1(br, fl, n2)
                    curves[c] = curve
                    zero_channel[c] = curve is None
            except AudioFormatError:
                pass
        # coupling magic: if one of a coupled pair is nonzero, decode both
        really_zero = list(zero_channel)
        for i in range(len(m.coupling_mag)):
            mc, ac = m.coupling_mag[i], m.coupling_ang[i]
            if not (zero_channel[mc] and zero_channel[ac]):
                zero_channel[mc] = zero_channel[ac] = False

        # residues per submap (end-of-packet mid-residue keeps partial data)
        residues = np.zeros((ch, n2), dtype=np.float32)
        try:
            for s in range(m.submaps):
                idxs = [c for c in range(ch) if m.mux[c] == s]
                dnd = [zero_channel[c] for c in idxs]
                res = self._residues[m.submap_residue[s]]
                r = self._decode_residue(br, res, n2, dnd)
                for k, c in enumerate(idxs):
                    residues[c] = r[k]
        except AudioFormatError:
            pass

        # inverse coupling (spec §4.3.5)
        for i in range(len(m.coupling_mag) - 1, -1, -1):
            M = residues[m.coupling_mag[i]]
            A = residues[m.coupling_ang[i]]
            newM = M.copy()
            newA = A.copy()
            pos_m = M > 0
            pos_a = A > 0
            newA[pos_m & pos_a] = (M - A)[pos_m & pos_a]
            newM[pos_m & ~pos_a] = (M + A)[pos_m & ~pos_a]
            newA[pos_m & ~pos_a] = M[pos_m & ~pos_a]
            newA[~pos_m & pos_a] = (M + A)[~pos_m & pos_a]
            newM[~pos_m & ~pos_a] = (M - A)[~pos_m & ~pos_a]
            newA[~pos_m & ~pos_a] = M[~pos_m & ~pos_a]
            residues[m.coupling_mag[i]] = newM
            residues[m.coupling_ang[i]] = newA

        # floor dot
        spec = np.zeros((ch, n2), dtype=np.float32)
        for c in range(ch):
            if not really_zero[c] and curves[c] is not None:
                spec[c] = residues[c] * curves[c]
            elif not really_zero[c]:
                # channel pulled in by coupling but its own floor unused:
                # spectrum stays zero (stb: really_zero suppresses output)
                pass
        return spec, (n, left_start, right_start, right_end)

    def _finish_packet(self, y, geom, granule):
        """Lapped-windowing half (finish_frame contract): overlap-add with
        the carried half-window, slice the returned region, save the lap."""
        n, left_start, right_start, right_end = geom
        ch = self.channels
        had_prev = self._prev is not None
        if had_prev and self._prev.shape[1] > 0:
            mdct_ops.overlap_add(y, self._prev, left_start)
        length = right_end  # *len = right_end (stb_vorbis2.d:2594)
        # final-packet truncation against the stream's total length —
        # ONLY for the packet that completes on the EOS page (stb checks
        # PAGEFLAG_last_page, stb_vorbis2.d:2565-2579); intermediate
        # pages with granules below the natural sample count must not
        # shorten the saved lap window
        page = getattr(self._reader, "_page", None)
        if granule is not None and self.length_frames and had_prev and \
                page is not None and page.is_eos:
            remaining = self.length_frames - self._pos
            if remaining < (right_end - left_start):
                length = left_start + max(0, remaining)
        self._prev = y[:, right_start:length].copy() if length > right_start \
            else np.zeros((ch, 0), np.float32)
        ret_end = min(right_start, length)
        virtual_ret = max(0, ret_end - left_start)
        if not had_prev:
            return None, virtual_ret  # pump_first_frame: priming only
        pcm = y[:, left_start:ret_end].T  # [ret, ch]
        return pcm, virtual_ret

    # ----------------------------------------------------------------- read
    def read(self, max_frames: int, dtype=np.float32) -> np.ndarray:
        chunks = []
        got = 0
        while got < max_frames:
            avail = self._buf.shape[0] - self._buf_start
            if avail == 0:
                if self.length_frames and self._pos >= self.length_frames:
                    break
                pk = self._reader.next_packet()
                if pk is None:
                    break
                pcm, _virtual = self._decode_packet(pk[0], pk[1])
                if pcm is None or pcm.shape[0] == 0:
                    continue
                if self.length_frames:
                    pcm = pcm[: max(0, self.length_frames - self._pos)]
                self._buf = np.ascontiguousarray(pcm, dtype=np.float32)
                self._buf_start = 0
                avail = self._buf.shape[0]
                if avail == 0:
                    continue
            take = min(avail, max_frames - got)
            chunks.append(self._buf[self._buf_start : self._buf_start + take])
            self._buf_start += take
            self._pos += take
            got += take
        if not chunks:
            return np.zeros((0, self.channels), dtype=dtype)
        return np.concatenate(chunks).astype(dtype)

    # ----------------------------------------------------------------- seek
    def tell(self) -> int:
        return self._pos

    def seek(self, frame: int) -> bool:
        if frame < 0 or frame > self.length_frames:
            return False
        if frame == self._pos:
            return True  # buffer (if any) already starts at this position
        # page anchor: last data page whose granule <= frame; restart AT it
        # so the lap-priming packet (its first full packet) ends at or
        # before the anchor granule — i.e. strictly before the target.
        data_pages = [
            (off, g) for off, g in self._page_index
            if off >= self._data_start and g >= 0
        ]
        anchor_idx = None
        for i, (off, g) in enumerate(data_pages):
            if g <= frame:
                anchor_idx = i
            else:
                break
        self._start_stream()
        to_skip = frame
        # at stream start the priming packet's would-be samples don't exist
        # (the stream's sample 0 is the second packet's first output)
        primed_counts = anchor_idx is None or anchor_idx == 0
        if anchor_idx is not None:
            self._reader.reset(data_pages[anchor_idx][0])
            prev_granule = (
                data_pages[anchor_idx - 1][1] if anchor_idx > 0 else 0
            )
            self._pos = prev_granule
            to_skip = frame - prev_granule
        # decode-and-discard to the target
        while to_skip > 0:
            pk = self._reader.next_packet()
            if pk is None:
                return self._pos == frame
            pcm, virtual = self._decode_packet(pk[0], pk[1])
            if pcm is None:
                if not primed_counts:
                    # after a seek the priming packet's samples are real:
                    # account for them (they lie strictly before the target)
                    self._pos += virtual
                    to_skip -= virtual
                continue
            take = min(to_skip, pcm.shape[0])
            if take < pcm.shape[0]:
                self._buf = np.ascontiguousarray(
                    pcm[take:], dtype=np.float32
                )
                self._buf_start = 0
            self._pos += take
            to_skip -= take
        return True


def _render_point(x0, y0, x1, y1, X):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (X - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, curve):
    """Vectorized closed form of the spec's Bresenham render_line
    (stb_vorbis2.d:1534): y(x0+k) = y0 + base·k ± floor(k·ady'/adx)."""
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    base = dy // adx if dy >= 0 else -((-dy) // adx)  # trunc toward zero
    ady = abs(dy) - abs(base) * adx
    k = np.arange(adx, dtype=np.int64)
    step = (k * ady) // adx
    y = y0 + base * k + (step if dy >= 0 else -step)
    np.clip(y, 0, 255, out=y)
    curve[x0:x1] = INVERSE_DB_TABLE[y]
