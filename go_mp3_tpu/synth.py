"""Seeded generator of valid MPEG-1/2 Layer III streams.

Test and benchmark data: the repository carries no recorded MP3s, so every
real-size workload is written here from a seed. Streams go through the same
tables the decoder reads (`bitstream/huffman_tables.py`, the header rules
of `bitstream/frameheader.py`, the scalefactor layouts of
`bitstream/maindata.py`). There is no psychoacoustic model: the audio is
shaped noise, not music.

Two kinds, one fixed format per stream:

- ``"mpeg1_stereo"``: MPEG-1 44.1 kHz joint stereo. Frames mix LR, MS,
  intensity and MS+intensity stereo. Granules follow a legal window
  sequence (long -> start -> short or mixed -> stop -> long), the two
  channels of a granule sharing its block type. Long granules carry scfsi,
  preflag and scalefac_scale, short ones subblock gain.
- ``"mpeg2_mono"``: MPEG-2 22.05 kHz mono with the same spread, less what
  the format lacks (stereo modes, scfsi) and mixed blocks, whose MPEG-2
  scalefactor layout the reference decoder leaves undefined (it reads 38
  values into a 39-slot table).

Spectral model, per granule and channel, in integers only so that a seed
gives the same bytes on every platform:

- Nonzero lines end at a random extent of at most line 418, which is
  16 kHz at 44.1 kHz and 8 kHz at 22.05 kHz.
- Magnitudes fall with frequency: below ``1 + K*64 // (line + 64)`` for a
  loudness K drawn per granule. The top eighth to third of the extent holds
  only 0 and +-1, which the encoder codes as the count1 region.
- Lines below 36 escape with probability 1/24 (MPEG-1) or 1/12 (MPEG-2)
  to 16..2063, the widest range at line 0 and narrowing with frequency, so
  the energy sits low as in music (the alignment search of
  `tools/compliance.py` relies on that). Both Huffman families with linbits
  appear, and MPEG-2 streams carry |value| > 127. Lines from 36 up stay
  within 15: line 36 is the first line a short-block reorder can move, so
  no line from 64 up (the int8 tail plane of `native/lib.py`) ever exceeds
  int8.

Rate control: each frame's main data is byte-aligned. Frame by frame, the
writer borrows all of the bit reservoir the format allows
(main_data_begin up to 511 or 255 bytes), then takes the smallest bitrate
and padding whose slot holds the rest. Streams are therefore VBR, and most
frames borrow from the reservoir.

Streams are assembled from a seeded pool of encoded frames. Each lane
draws its own sequence from the pool, keeping the window sequence legal,
and the reservoir and bitrates are laid out per lane. Encoding a pool once
and assembling lanes from it keeps the continuity corpus (193,792
granules) to seconds on one core.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from .bitstream.frameheader import FrameHeader
from .bitstream.huffman_tables import TABLES
from .bitstream.maindata import N_SLEN2, SCALEFAC_SIZES_MPEG1, SCALEFAC_SIZES_MPEG2
from .consts import SAMPLES_PER_GR, SF_BAND_INDICES

STEREO = "mpeg1_stereo"
MONO = "mpeg2_mono"

# The continuity corpus: (kind, lanes, frames per lane). 48 x 1540 frames x
# 2 granules + 16 x 2872 frames x 1 granule = 193,792 granules, ~3,130 s.
CONTINUITY_LANES = ((STEREO, 48, 1540), (MONO, 16, 2872))

_ESCAPE_LINES = 36  # lines a short-block reorder cannot move


class BitWriter:
    """MSB-first bit packer."""

    def __init__(self) -> None:
        self._acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self._acc = (self._acc << n) | (int(value) & ((1 << n) - 1))
        self.nbits += n

    def tobytes(self, pad_to: int | None = None) -> bytes:
        """The bits so far, zero-padded to a whole byte, then with zero
        bytes up to `pad_to` bytes."""
        pad = -self.nbits % 8
        out = (self._acc << pad).to_bytes((self.nbits + pad) // 8, "big")
        if pad_to is not None:
            out += bytes(pad_to - len(out))
        return out


# ---------------------------------------------------------------------------
# Huffman encoding
# ---------------------------------------------------------------------------

# table -> ({(x, y): (code, length)}, linbits); None for the empty tables
_ENC = [
    None
    if book is None
    else ({(x, y): (code, length) for length, code, x, y in book}, linbits)
    for book, linbits in TABLES
]
# tables without linbits, grouped by the largest value they code
_TABLE_CLASSES = (
    (1, (1,)), (2, (2, 3)), (3, (5, 6)), (5, (7, 8, 9)), (7, (10, 11, 12)),
    (15, (13, 15)),
)


def _pick_table(rng, vmax: int) -> int:
    if vmax == 0:
        return 0
    for cap, tabs in _TABLE_CLASSES:
        if vmax <= cap:
            return tabs[int(rng.integers(len(tabs)))]
    first = 16 if rng.integers(2) == 0 else 24
    for t in range(first, first + 8):
        if 15 + (1 << TABLES[t][1]) - 1 >= vmax:
            return t
    raise ValueError(f"magnitude {vmax} exceeds every Huffman table")


def _write_huffman(w: BitWriter, rng, spec: list, long_bands, block_type: int):
    """Code 576 quantized lines (coded order) as big values + count1.
    Returns the side-info fields the decoder needs to read them back."""
    big = [i for i, v in enumerate(spec) if abs(v) > 1]
    nz = [i for i, v in enumerate(spec) if v]
    bv_end = (big[-1] // 2 + 1) * 2 if big else 0
    end = nz[-1] + 1 if nz else 0
    n_quads = max(0, -(-(end - bv_end) // 4))
    if bv_end + 4 * n_quads > SAMPLES_PER_GR:
        bv_end += 2
        n_quads = max(0, -(-(end - bv_end) // 4))

    # region boundaries as the decoder derives them (maindata.py
    # _read_huffman); window-switched granules have implicit counts
    r0 = r1 = 0
    if block_type == 2:
        starts = (36, SAMPLES_PER_GR)
    elif block_type:
        starts = (long_bands[8], SAMPLES_PER_GR)
    else:
        r0 = max(
            [k for k in range(16) if long_bands[k + 1] <= bv_end // 3] or [0]
        )
        r1 = max(
            [
                k
                for k in range(8)
                if r0 + k + 2 < 23 and long_bands[r0 + k + 2] <= 2 * bv_end // 3
            ]
            or [0]
        )
        j = r0 + r1 + 2
        starts = (long_bands[r0 + 1], long_bands[j] if j < 23 else 576)
    bounds = (0, min(starts[0], bv_end), min(starts[1], bv_end), bv_end)
    tables = [
        _pick_table(
            rng, max((abs(v) for v in spec[lo:hi]), default=0)
        )
        for lo, hi in zip(bounds, bounds[1:])
    ]
    n_tables = 2 if block_type else 3  # region 2 is empty when 2
    for region in range(3):
        enc = _ENC[tables[region]]
        if enc is None:
            continue  # all-zero region: table 0 reads no bits
        book, linbits = enc
        for i in range(bounds[region], bounds[region + 1], 2):
            x, y = spec[i], spec[i + 1]
            ax, ay = abs(x), abs(y)
            cx, cy = (min(ax, 15), min(ay, 15)) if linbits else (ax, ay)
            code, length = book[(cx, cy)]
            w.write(code, length)
            if linbits and cx == 15:
                w.write(ax - 15, linbits)
            if ax:
                w.write(x < 0, 1)
            if linbits and cy == 15:
                w.write(ay - 15, linbits)
            if ay:
                w.write(y < 0, 1)

    count1_table = int(rng.integers(2))
    book = _ENC[32 + count1_table][0]
    for i in range(bv_end, bv_end + 4 * n_quads, 4):
        quad = spec[i : i + 4]
        val = 0
        for v in quad:
            val = (val << 1) | (v != 0)
        code, length = book[(0, val)]
        w.write(code, length)
        for v in quad:
            if v:
                w.write(v < 0, 1)
    return {
        "big_values": bv_end // 2,
        "table_select": tables[:n_tables],
        "region0_count": r0,
        "region1_count": r1,
        "count1_table": count1_table,
    }


# ---------------------------------------------------------------------------
# Granule content
# ---------------------------------------------------------------------------

# window sequence: state -> (kinds, cumulative weights out of 100)
# kinds: L long, A start, S short, M mixed, E stop
_NEXT = {
    "long": (("L", "A"), (88, 100)),
    "pre_short": (("S", "M"), (80, 100)),
    "short": (("S", "M", "E"), (40, 50, 100)),
}
_AFTER = {"L": "long", "E": "long", "A": "pre_short", "S": "short", "M": "short"}
_BLOCK = {"L": (0, 0, 0), "A": (1, 1, 0), "S": (1, 2, 0), "M": (1, 2, 1), "E": (1, 3, 0)}
_SBG = (0, 0, 0, 1, 1, 2, 3)  # subblock gain draws: mostly 0


def _next_kind(rng, state: str, mixed: bool) -> str:
    kinds, cum = _NEXT[state]
    r = int(rng.integers(100))
    kind = next(k for k, c in zip(kinds, cum) if r < c)
    return "S" if kind == "M" and not mixed else kind


def _spectrum(rng, limit: int, escape_odds: int, loud: int) -> list:
    """One granule-channel's quantized lines (coded order), nonzero below
    `limit` at most."""
    line = np.arange(SAMPLES_PER_GR)
    extent = int(rng.integers(limit // 3, limit + 1))
    c1 = extent - int(rng.integers(extent // 8, extent // 3 + 1))
    cap = 1 + (loud * 64) // (line + 64)
    mag = rng.integers(0, cap + 1)
    dense = rng.integers(0, 8, SAMPLES_PER_GR) < 6
    mag = np.where(dense, mag, 0)
    tail = (line >= c1) & (line < extent)
    mag = np.where(tail, rng.integers(0, 10, SAMPLES_PER_GR) < 3, mag)
    mag[extent:] = 0
    esc = (line < min(_ESCAPE_LINES, extent)) & (
        rng.integers(0, escape_odds, SAMPLES_PER_GR) == 0
    )
    exp = rng.integers(3, 12, SAMPLES_PER_GR) - line // 6  # largest lowest
    big = 16 + rng.integers(0, 1 << 11, SAMPLES_PER_GR) % (1 << np.maximum(exp, 2))
    mag = np.where(esc, big, mag)
    sign = rng.integers(0, 2, SAMPLES_PER_GR) * 2 - 1
    return (mag * sign).tolist()


class _Redraw(Exception):
    """An encoded frame overflows a side-info field or the largest slot."""


@dataclass
class _Frame:
    """One encoded frame of a pool: everything but main_data_begin."""

    side: bytes  # side info with main_data_begin = 0
    payload: bytes  # byte-aligned main data
    mode_ext: int
    state_in: str
    state_out: str


def _mpeg1_frame(rng, state_in: str) -> _Frame:
    long_bands = SF_BAND_INDICES[0][0][0]
    short_bands = SF_BAND_INDICES[0][0][1]
    kinds, state = [], state_in
    for _ in range(2):
        kinds.append(_next_kind(rng, state, mixed=True))
        state = _AFTER[kinds[-1]]
    mode_ext = (0, 1, 2, 2, 2, 2, 3, 3, 0, 2)[int(rng.integers(10))]
    scfsi = [
        [
            int(rng.integers(2))
            if "S" not in kinds and "M" not in kinds
            else 0
            for _ in range(4)
        ]
        for _ in range(2)
    ]
    base_gain = int(rng.integers(134, 160))
    loud = int(rng.integers(6, 22))
    fields = [[None, None], [None, None]]
    md = BitWriter()
    for gr in range(2):
        ws, bt, mixed = _BLOCK[kinds[gr]]
        for ch in range(2):
            limit = 419
            if ch == 1 and mode_ext & 1:  # intensity: right channel ends low
                if bt == 2:
                    limit = 3 * short_bands[int(rng.integers(4, 10))]
                else:
                    limit = long_bands[int(rng.integers(8, 17))]
            spec = _spectrum(rng, limit, 24, loud)
            compress = int(rng.integers(16))
            slen1, slen2 = SCALEFAC_SIZES_MPEG1[compress]
            start = md.nbits
            if bt == 2:
                if mixed:
                    for sfb in range(8):
                        md.write(int(rng.integers(1 << slen1)), slen1)
                sfb_lo = 3 if mixed else 0
                for sfb in range(sfb_lo, 12):
                    n = slen1 if sfb < 6 else slen2
                    for _ in range(3):
                        md.write(int(rng.integers(1 << n)), n)
            else:
                for band, (lo, hi) in enumerate(((0, 6), (6, 11), (11, 16), (16, 21))):
                    n = slen1 if band < 2 else slen2
                    if gr == 1 and scfsi[ch][band]:
                        continue  # copied from granule 0
                    for v in rng.integers(0, 1 << n, hi - lo).tolist():
                        md.write(v, n)
            f = _write_huffman(md, rng, spec, long_bands, bt)
            f.update(
                part2_3_length=md.nbits - start,
                global_gain=base_gain + int(rng.integers(-4, 5)),
                scalefac_compress=compress,
                ws=ws,
                block_type=bt,
                mixed=mixed,
                subblock_gain=[_SBG[int(rng.integers(7))] for _ in range(3)],
                preflag=int(bt != 2 and rng.integers(5) == 0),
                scalefac_scale=int(rng.integers(4) == 0),
            )
            fields[gr][ch] = f
    si = BitWriter()
    si.write(0, 9)  # main_data_begin, patched at assembly
    si.write(0, 3)  # private bits
    for ch in range(2):
        for band in range(4):
            si.write(scfsi[ch][band], 1)
    for gr in range(2):
        for ch in range(2):
            _write_granule_side(si, fields[gr][ch], lsf=False)
    return _Frame(si.tobytes(), md.tobytes(), mode_ext, state_in, state)


def _mpeg2_frame(rng, state: str) -> _Frame:
    long_bands = SF_BAND_INDICES[1][0][0]
    kind = _next_kind(rng, state, mixed=False)
    ws, bt, mixed = _BLOCK[kind]
    md = BitWriter()
    spec = _spectrum(rng, 419, 12, int(rng.integers(6, 22)))
    r = int(rng.integers(20))
    if r < 12:
        compress = int(rng.integers(0, 400))
    elif r < 17:
        compress = int(rng.integers(400, 500))
    else:
        compress = int(rng.integers(500, 512))  # preflag
    slen = N_SLEN2[compress]
    d = (slen >> 12) & 7
    for i in range(4):
        n = (slen >> (3 * i)) & 7
        for _ in range(SCALEFAC_SIZES_MPEG2[1 if bt == 2 else 0][d][i]):
            if n:
                md.write(int(rng.integers(1 << n)), n)
    f = _write_huffman(md, rng, spec, long_bands, bt)
    f.update(
        part2_3_length=md.nbits,
        global_gain=int(rng.integers(132, 160)),
        scalefac_compress=compress,
        ws=ws,
        block_type=bt,
        mixed=mixed,
        subblock_gain=[_SBG[int(rng.integers(7))] for _ in range(3)],
        scalefac_scale=int(rng.integers(4) == 0),
    )
    si = BitWriter()
    si.write(0, 8)  # main_data_begin, patched at assembly
    si.write(0, 1)  # private bit
    _write_granule_side(si, f, lsf=True)
    return _Frame(si.tobytes(), md.tobytes(), 0, state, _AFTER[kind])


def _write_granule_side(si: BitWriter, f: dict, lsf: bool) -> None:
    """One granule-channel of side info (sideinfo.py's read order)."""
    if f["part2_3_length"] >= 1 << 12:
        raise _Redraw()
    si.write(f["part2_3_length"], 12)
    si.write(f["big_values"], 9)
    si.write(f["global_gain"], 8)
    si.write(f["scalefac_compress"], 9 if lsf else 4)
    si.write(f["ws"], 1)
    if f["ws"]:
        si.write(f["block_type"], 2)
        si.write(f["mixed"], 1)
        for t in f["table_select"]:
            si.write(t, 5)
        for g in f["subblock_gain"]:
            si.write(g, 3)
    else:
        for t in f["table_select"]:
            si.write(t, 5)
        si.write(f["region0_count"], 4)
        si.write(f["region1_count"], 3)
    if not lsf:
        si.write(f["preflag"], 1)
    si.write(f["scalefac_scale"], 1)
    si.write(f["count1_table"], 1)


# ---------------------------------------------------------------------------
# Pools and assembly
# ---------------------------------------------------------------------------

# kind -> (frame encoder, largest payload, version bits, mode, sample-rate
# index, side-info bytes, main_data_begin bits)
_KINDS = {
    STEREO: (_mpeg1_frame, 1000, 3, 1, 0, 32, 9),
    MONO: (_mpeg2_frame, 500, 2, 3, 0, 9, 8),
}


class FramePool:
    """`size` encoded frames of one kind, consecutive frames forming a legal
    window sequence, grouped by the window state they start from."""

    def __init__(self, kind: str, size: int, seed: int):
        encode, max_payload, version, mode, sfreq, self.side_len, mdb_bits = (
            _KINDS[kind]
        )
        self.max_mdb = (1 << mdb_bits) - 1
        rng = np.random.default_rng([seed, list(_KINDS).index(kind)])
        self.frames: list[_Frame] = []
        self.groups: dict[str, list[int]] = {s: [] for s in _NEXT}
        state = "long"
        while len(self.frames) < size or not all(self.groups.values()):
            try:
                frame = encode(rng, state)
                if len(frame.payload) > max_payload:
                    raise _Redraw()
            except _Redraw:
                continue  # too loud for its fields or the largest frame
            state = frame.state_out
            self.groups[frame.state_in].append(len(self.frames))
            self.frames.append(frame)
        # (slot bytes, bitrate index, padding), smallest slot first
        self._options = []
        for br in range(1, 15):
            for pad in (0, 1):
                word = (
                    0xFFE00000 | version << 19 | 1 << 17 | 1 << 16
                    | br << 12 | sfreq << 10 | pad << 9 | mode << 6
                )
                slot = FrameHeader(word).frame_size() - 4 - self.side_len
                self._options.append((slot, br, pad))
        self._options.sort()
        self._slots = [o[0] for o in self._options]
        self._word = 0xFFE00000 | version << 19 | 1 << 17 | 1 << 16 | sfreq << 10 | mode << 6

    def assemble(self, n_frames: int, seed) -> bytes:
        """A stream of `n_frames` frames drawn from the pool by a seeded
        sequence, with bitrates and main_data_begin laid out for it."""
        draws = np.random.default_rng(seed).integers(0, 1 << 30, n_frames).tolist()
        heads, sides, slots = [], [], []
        main = bytearray()
        state, reservoir = "long", 0
        for r in draws:
            group = self.groups[state]
            frame = self.frames[group[r % len(group)]]
            state = frame.state_out
            n = len(frame.payload)
            mdb = min(reservoir, self.max_mdb)
            # payloads are capped below the largest slot (_KINDS)
            slot, br, pad = self._options[bisect.bisect_left(self._slots, n - mdb)]
            main += bytes(reservoir - mdb)  # stuffing the format cannot reach
            main += frame.payload
            reservoir = mdb + slot - n
            word = self._word | br << 12 | pad << 9 | frame.mode_ext << 4
            heads.append(word.to_bytes(4, "big"))
            side = bytearray(frame.side)
            if self.max_mdb == 511:
                side[0] = mdb >> 1
                side[1] |= (mdb & 1) << 7
            else:
                side[0] = mdb
            sides.append(bytes(side))
            slots.append(slot)
        main += bytes(reservoir)
        out = bytearray()
        pos = 0
        for head, side, slot in zip(heads, sides, slots):
            out += head
            out += side
            out += main[pos : pos + slot]
            pos += slot
        return bytes(out)


def generate_stream(kind: str, n_frames: int, seed: int = 0) -> bytes:
    """One stream of `n_frames` frames of `kind` (STEREO or MONO)."""
    pool = FramePool(kind, min(256, max(n_frames, 16)), seed)
    return pool.assemble(n_frames, [seed, 1 << 20])


def lane_sample_rates() -> list[int]:
    """Sample rate of each lane of the continuity corpus, in lane order."""
    rate = {STEREO: 44100, MONO: 22050}
    return [rate[kind] for kind, n, _ in CONTINUITY_LANES for _ in range(n)]


def continuity_corpus(seed: int = 0) -> list[bytes]:
    """The continuity corpus of CONTINUITY_LANES: 48 MPEG-1 stereo lanes,
    then 16 MPEG-2 mono lanes, each lane's frame sequence distinct."""
    lanes = []
    for kind, n_lanes, n_frames in CONTINUITY_LANES:
        pool = FramePool(kind, 768, seed)
        lanes += [pool.assemble(n_frames, [seed, k]) for k in range(n_lanes)]
    return lanes
