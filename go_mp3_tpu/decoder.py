"""Public streaming decoder API.

Functional parity with the reference's Decoder (/root/reference/decode.go):
a pull-based PCM stream (read/seek) over any binary file-like object, with
frame indexing for length/duration, byte-accurate seeking with a one-frame
warm-up re-decode, and graceful handling of trailing metadata. Output is
always 16-bit little-endian stereo (4 bytes per sample), mono duplicated.

The DSP backend is selectable:
 - "device" (default): the batched JAX path (go_mp3_tpu.ops.granule) with
   read-ahead so device dispatches amortize over many frames; uses the C++
   parser when the source fits in memory,
 - "exact": C++ parse + C++ DSP replicating the reference decoder's float32
   operation order (bit-exact mode; no accelerator involved),
 - "golden": the numpy float64 golden chain (correctness oracle, host-only).
"""

from __future__ import annotations

import io
from typing import BinaryIO

from .bitstream.frameheader import read_header
from .bitstream.parser import FrameReader, ParsedFrame
from .bitstream.source import Source
from .consts import (
    EOFError_,
    MP3Error,
    SyncSearchLimitError,
    UnexpectedEOFError,
)

INVALID_LENGTH = -1


class NotSeekableError(MP3Error):
    def __init__(self) -> None:
        super().__init__("mp3: seek not supported on non-seekable source")


class Decoder:
    """A decoded MP3 stream.

    Not safe for concurrent use (like the reference, decode.go:31-33); wrap
    with a lock if shared across threads.
    """

    def __init__(
        self,
        reader: BinaryIO | bytes,
        backend: str = "device",
        readahead_frames: int = 64,
        use_native: bool | None = None,
    ):
        """use_native: parse with the C++ host parser (requires an in-memory
        or seekable source). None = auto (on when available)."""
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(reader)
        # Native fast paths: C++ parse + batched device DSP ("device"), or
        # C++ parse + exact-arithmetic C++ DSP ("exact" — bit-exact to the
        # reference decoder's float32 pipeline, no accelerator needed).
        # Both require the whole stream in memory; anything else uses the
        # pure-Python parser.
        self._native: "_NativeStream | None" = None
        if backend in ("device", "exact") and use_native is not False:
            self._native = _maybe_native_stream(reader, dsp=backend)
            if self._native is None and (use_native is True or backend == "exact"):
                from .native.lib import build_error

                raise MP3Error(
                    "mp3: native parser unavailable for this source"
                    + (f" ({build_error()})" if build_error() else "")
                )
        self._source = Source(reader)
        self._frame_reader = FrameReader()
        self._backend_name = backend
        self._readahead = max(1, readahead_frames)
        self._dsp = _make_backend(backend)
        self._buf = bytearray()
        self._pos = 0  # decoded-byte position (exact arithmetic, decode.go:244)
        self._length = INVALID_LENGTH
        self._frame_starts: list[int] = []
        self._bytes_per_frame = 0
        self._sample_rate = 0
        self._have_frame = False  # a previous frame exists (reservoir warm)
        self._at_end = False  # set by a seek at/past the end of the stream
        # Seek warm-up parameters, refined from the first frame's header
        # (_set_warmup_params). Defaults are the safe maxima: 38 = 4 header
        # + 2 CRC + 32 side info; 511 = the 9-bit MPEG-1 main_data_begin.
        self._frame_overhead = 38
        self._mdb_window = 511

        if self._native is not None:
            if not self._decode_more():
                raise MP3Error("mp3: no decodable frame found")
            self._sample_rate = self._native.sample_rate()
            self._have_frame = True
            idx = self._native.index()
            if idx is not None:
                starts, bpf, _sr = idx
                self._frame_starts = list(starts)
                self._bytes_per_frame = bpf
                self._length = int(bpf * len(starts))
                if self._frame_starts:
                    word = int.from_bytes(
                        self._native._data[
                            self._frame_starts[0] : self._frame_starts[0] + 4
                        ],
                        "big",
                    )
                    from .bitstream.frameheader import FrameHeader

                    self._set_warmup_params(FrameHeader(word))
            # else: non-materializable source — Length/Duration/seeking
            # degrade exactly like the reference's non-Seeker case
            # (decode.go:159-161); decoding itself streams in bounded memory
            return

        self._source.skip_tags()
        if not self._decode_more():
            raise MP3Error("mp3: no decodable frame found")
        self._ensure_frame_starts_and_length()

    # -- internal: decode-ahead --------------------------------------------
    def _read_one_frame(self) -> ParsedFrame | None:
        """Parse the next frame; None on end-of-audio (EOF / trailing junk),
        mirroring readFrame's error folding (decode.go:45-67)."""
        try:
            f = self._frame_reader.read(self._source, self._source.pos)
        except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
            return None
        if not self._have_frame:
            self._sample_rate = f.header.sampling_frequency_value()
            self._set_warmup_params(f.header)
            self._have_frame = True
        return f

    def _set_warmup_params(self, header) -> None:
        """Per-stream seek warm-up geometry from the first frame's header.

        Overhead always budgets the 2 CRC bytes even for unprotected streams
        (the protection bit can in principle vary frame-to-frame; counting it
        only ever deepens the warm-up, never breaks the bit-identical seek
        guarantee). The backreference window is 255 for MPEG-2 (8-bit
        main_data_begin) vs 511 for MPEG-1 (9-bit, sideinfo.go:94)."""
        self._frame_overhead = 4 + 2 + header.side_info_size
        self._mdb_window = 255 if header.low_sampling_frequency else 511

    def _decode_more(self) -> bool:
        """Parse+decode up to readahead frames into the buffer."""
        if self._native is not None:
            pcm = self._native.decode_more()
            if pcm is None:
                return False
            self._buf += pcm
            return True
        frames = []
        for _ in range(self._readahead):
            f = self._read_one_frame()
            if f is None:
                break
            frames.append(f)
        if not frames:
            return False
        self._buf += self._dsp.decode_frames(frames)
        return True

    # -- io.Reader ----------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        """Read up to n bytes of PCM (all remaining if n < 0). Returns b''
        at end of stream."""
        if n is None or n < 0:
            chunks = []
            while True:
                c = self.read(1 << 20)
                if not c:
                    break
                chunks.append(c)
            return b"".join(chunks)
        while len(self._buf) < n:
            if self._at_end or not self._decode_more():
                break
        take = min(n, len(self._buf))
        out = bytes(self._buf[:take])
        del self._buf[:take]
        self._pos += take
        return out

    def read_all(self) -> bytes:
        return self.read(-1)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    # -- io.Seeker ----------------------------------------------------------
    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """Byte-accurate seek in the decoded PCM stream (decode.go:89-145).

        Samples are 4-byte aligned; seek to multiples of 4 to stay on sample
        boundaries."""
        if offset == 0 and whence == io.SEEK_CUR:
            return self._pos
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()

        if whence == io.SEEK_SET:
            npos = offset
        elif whence == io.SEEK_CUR:
            npos = self._pos + offset
        elif whence == io.SEEK_END:
            npos = self._length + offset
        else:
            raise MP3Error("mp3: invalid whence")

        self._pos = max(npos, 0)
        self._buf.clear()
        self._frame_reader.reset()
        self._dsp.reset()
        if self._native is not None:
            self._native.reset_state()
        self._have_frame = False

        if self._pos >= self._length:
            # At/after the end: subsequent reads report end-of-stream.
            # (The reference leaves its byte source wherever it was, so a
            # read would decode stale data from that position — we treat
            # the stream as ended instead, which is what its callers expect.)
            self._at_end = True
            return npos
        self._at_end = False

        f = self._pos // self._bytes_per_frame
        if f > 0:
            k = self._warmup_depth(f)
            self._restart_at(self._frame_starts[f - k])
            if not self._decode_n_frames(k + 1):
                return npos
            skip = k * self._bytes_per_frame + (
                self._pos % self._bytes_per_frame
            )
            del self._buf[:skip]
        else:
            self._restart_at(self._frame_starts[0])
            if not self._decode_n_frames(1):
                return npos
            del self._buf[: self._pos]
        return npos

    def _warmup_depth(self, f: int) -> int:
        """How many frames before target frame f to decode (and discard) so
        the seek lands bit-identical to a linear decode.

        The reference always uses exactly one warm-up frame
        (decode.go:120-134) — an approximation that cannot recharge a
        511-byte reservoir from small (low-bitrate) frames. Here the depth
        is computed from the real frame byte index. Frame f's PCM depends on
        its own spectra, frame f-1's (IMDCT overlap + the 16-row polyphase
        FIFO), and — via the overlap term inside f-1's FIFO rows — frame
        f-2's. Both f-1 and f-2 therefore need exact spectra, so the warm
        frames before f-2 must cover f-2's backreference window: the main
        data bytes in frames f-k..f-3 must reach the stream's
        main_data_begin maximum. Per-frame main bytes are frame spacing
        minus the (conservative, CRC-counted) header overhead; covering
        f-2's window also covers f-1's (which has f-2's own main bytes in
        addition). Unbounded above (walks to frame 0 on pathological
        low-bitrate streams — a full linear re-decode, still correct)."""
        if f < 2:
            return f  # decode from frame 0
        need = self._mdb_window
        ov = self._frame_overhead
        k = 2
        while (
            f - k > 0
            and self._frame_starts[f - 2] - self._frame_starts[f - k]
            < need + ov * (k - 2)
        ):
            k += 1
        return k

    def _restart_at(self, byte_offset: int) -> None:
        if self._native is not None:
            self._native.restart(byte_offset)
        else:
            self._source.seek(byte_offset)

    def _decode_n_frames(self, n: int) -> bool:
        if self._native is not None:
            pcm = self._native.decode_frames(n, self._bytes_per_frame)
            if pcm is None:
                return False
            self._buf += pcm
            return True
        frames = []
        for _ in range(n):
            f = self._read_one_frame()
            if f is None:
                break
            frames.append(f)
        if not frames:
            return False
        self._buf += self._dsp.decode_frames(frames)
        return True

    # -- checkpoint / resume -------------------------------------------------
    def checkpoint(self) -> dict:
        """Snapshot the full decode state for sample-exact resumption.

        The reference keeps this state implicit ({reservoir bytes, IMDCT
        store, polyphase vVec, byte position}, SURVEY.md §5); here it is an
        explicit dict of plain bytes/numpy values. Restore with `resume()`
        on a Decoder over the same stream — unlike seek() (which re-warms
        state approximately), resumption is exact."""
        import numpy as np

        ck: dict = {
            "pos": self._pos,
            "buf": bytes(self._buf),
            "at_end": self._at_end,
            "backend": self._backend_name,
        }
        if self._native is not None:
            ck["parser_offset"] = self._native._parser.tell()
            ck["reservoir"] = self._native._parser.get_reservoir()
            if self._native._dsp_kind == "exact":
                store, vvec = self._native._cpu_dsp.get_state()
                ck["dsp"] = ("exact", store, vvec)
            else:
                st = self._native._state
                ck["dsp"] = (
                    "device",
                    np.asarray(st.store),
                    np.asarray(st.v_fifo),
                )
            return ck
        # pure-Python parse path
        prev = self._frame_reader.prev_bits
        ck["reservoir"] = prev.vec if prev is not None else b""
        ck["source_pos"] = self._source.pos
        ck["have_frame"] = self._have_frame
        if self._backend_name == "golden":
            gd = self._dsp._gd
            ck["dsp"] = ("golden", gd.store.copy(), gd.v_fifo.copy())
        else:
            st = self._dsp._sd.state
            ck["dsp"] = ("device", np.asarray(st.store), np.asarray(st.v_fifo))
        return ck

    def checkpoint_bytes(self) -> bytes:
        """checkpoint() serialized to a stable wire format (utils.state) —
        suitable for persisting or shipping to another host."""
        from .utils.state import checkpoint_to_bytes

        return checkpoint_to_bytes(self.checkpoint())

    def resume_bytes(self, data: bytes) -> None:
        """Restore a checkpoint_bytes() snapshot (same stream, same backend)."""
        from .utils.state import checkpoint_from_bytes

        self.resume(checkpoint_from_bytes(data))

    def resume(self, ck: dict) -> None:
        """Restore a checkpoint() snapshot (same stream, same backend)."""
        if ck["backend"] != self._backend_name:
            raise MP3Error("mp3: checkpoint backend mismatch")
        self._pos = ck["pos"]
        self._buf = bytearray(ck["buf"])
        self._at_end = ck["at_end"]
        kind, a, b = ck["dsp"]
        if self._native is not None:
            self._native.restart(ck["parser_offset"])
            self._native._parser.set_reservoir(ck["reservoir"])
            if kind == "exact":
                self._native._cpu_dsp.set_state(a, b)
            else:
                import jax.numpy as jnp

                from .ops.granule import DecodeState

                self._native._state = DecodeState(
                    store=jnp.asarray(a), v_fifo=jnp.asarray(b)
                )
            return
        from .bitstream.bits import BitReader

        self._source.seek(ck["source_pos"])
        self._frame_reader.prev_bits = (
            BitReader(ck["reservoir"]) if ck["reservoir"] else None
        )
        self._have_frame = ck["have_frame"]
        if kind == "golden":
            gd = self._dsp._gd
            gd.store = a.copy()
            gd.v_fifo = b.copy()
        else:
            import jax.numpy as jnp

            from .ops.granule import DecodeState

            self._dsp._sd.state = DecodeState(
                store=jnp.asarray(a), v_fifo=jnp.asarray(b)
            )

    # -- metadata / navigation ---------------------------------------------
    def _ensure_frame_starts_and_length(self) -> None:
        """Index pass over the whole file, headers only (decode.go:154-216)."""
        if self._length != INVALID_LENGTH:
            return
        if not self._source.seekable():
            return
        pos = self._source.seek(0, io.SEEK_CUR)
        self._source.rewind()
        self._source.skip_tags()
        total = 0
        while True:
            try:
                h, start = read_header(self._source, self._source.pos)
            except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
                break
            self._frame_starts.append(start)
            self._bytes_per_frame = h.bytes_per_frame
            total += self._bytes_per_frame
            framesize = h.frame_size()
            self._source.seek(framesize - 4, io.SEEK_CUR)
        self._length = total
        self._source.seek(pos, io.SEEK_SET)

    def sample_rate(self) -> int:
        """Sample rate in Hz, from the first frame (decode.go:150-152)."""
        return self._sample_rate

    def length(self) -> int:
        """Total decoded size in bytes, or -1 if not seekable."""
        return self._length

    def bytes_per_frame(self) -> int:
        return self._bytes_per_frame

    def duration(self) -> float:
        """Total duration in seconds, or -1.0 if unknown."""
        if self._length == INVALID_LENGTH:
            return -1.0
        return self._length / (self._sample_rate * 4)

    def position(self) -> float:
        """Current position in seconds (pure byte arithmetic)."""
        return self._pos / (self._sample_rate * 4)

    def tell(self) -> int:
        return self._pos

    def remaining(self) -> float:
        d = self.duration()
        if d < 0:
            return -1.0
        return d - self.position()

    def progress(self) -> float:
        if self._length == INVALID_LENGTH:
            return -1.0
        if self._length == 0:
            return 0.0
        return self._pos / self._length

    def sample_position(self) -> int:
        return self._pos // 4

    def sample_count(self) -> int:
        if self._length == INVALID_LENGTH:
            return -1
        return self._length // 4

    def seek_to_sample(self, sample: int) -> None:
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()
        sample = min(max(sample, 0), self.sample_count())
        self.seek(sample * 4, io.SEEK_SET)

    def skip(self, delta_seconds: float) -> None:
        self.seek_to_time(self.position() + delta_seconds)

    def seek_to_time(self, t: float) -> None:
        """Seek to an absolute time in seconds, clamped and 4-byte aligned
        (decode.go:320-341)."""
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()
        t = min(max(t, 0.0), self.duration())
        nbytes = int(t * self._sample_rate * 4) & ~3
        self.seek(nbytes, io.SEEK_SET)


def _maybe_native_stream(reader, dsp: str = "device") -> "_NativeStream | None":
    """Build the native fast path: whole-buffer parse for materializable
    sources (BytesIO / seekable file — enables Length + seeking), or the
    chunked-feed streaming parser for pipe/socket-style readers (bounded
    memory; Length/seeking degrade as for the reference's non-Seeker case)."""
    try:
        from .native import lib as native
    except Exception:
        return None
    if not native.available():
        return None
    data: bytes | None = None
    seekable = False
    if isinstance(reader, io.BytesIO):
        start = reader.tell()
        data = reader.getvalue()[start:]
        seekable = True
    else:
        try:
            seekable = bool(reader.seekable())
        except Exception:
            seekable = False
        if seekable:
            try:
                start = reader.tell()
                data = reader.read()
                reader.seek(start)
            except Exception:
                return None
    try:
        if seekable:
            if not data:
                return None
            return _NativeStream(data, dsp=dsp)
        return _StreamingNativeStream(reader, dsp=dsp)
    except Exception:
        return None


class _NativeStream:
    """C++ parse -> (batched device DSP | exact C++ DSP), with the Decoder's
    frame-oriented contract (decode-ahead, restart-at-offset for seeks)."""

    CHUNK = 128  # granules per device call; fixed so one XLA compilation

    def __init__(self, data: bytes, dsp: str = "device"):
        import numpy as np

        from .native.lib import META_WIDTH, NativeParser, index_stream

        self._np = np
        self._data = data
        self._parser = NativeParser(data)
        self._index_stream = index_stream
        self._NativeParser = NativeParser
        self._meta_width = META_WIDTH
        self._dsp_kind = dsp
        if dsp == "exact":
            from .native.lib import NativeDsp

            self._cpu_dsp = NativeDsp()
            self._state = None
        else:
            from .ops.granule import init_state

            self._init_state = init_state
            self._state = init_state()

    def sample_rate(self) -> int:
        return self._parser.sample_rate

    def index(self):
        return self._index_stream(self._data)

    def reset_state(self) -> None:
        if self._dsp_kind == "exact":
            self._cpu_dsp.reset()
        else:
            self._state = self._init_state()

    def restart(self, byte_offset: int) -> None:
        self._parser.close()
        self._parser = self._NativeParser(self._data, byte_offset)

    def _parse(self, spectra, sfl, sfs, meta) -> int:
        return self._parser.parse_into(spectra, sfl, sfs, meta)

    def _parse_packed(self, spectra, side) -> int:
        return self._parser.parse_packed_into(spectra, side)

    def _decode_granules(self, want: int) -> bytes | None:
        np = self._np
        want = min(want, self.CHUNK)

        if self._dsp_kind == "exact":
            spectra = np.zeros((want, 2, 576), np.int16)
            sfl = np.zeros((want, 2, 22), np.int32)
            sfs = np.zeros((want, 2, 39), np.int32)
            meta = np.zeros((want, self._meta_width), np.int32)
            n = self._parse(spectra, sfl, sfs, meta)
            if n == 0:
                return None
            pcm = self._cpu_dsp.decode(
                spectra[:n], sfl[:n], sfs[:n], meta[:n]
            )
            return pcm.tobytes()

        # device path: the packed int16 interface (two flat arrays, unpacked
        # on device inside jit — same layout family the corpus pipeline
        # ships). Arrays are CHUNK-sized so there is exactly one compilation;
        # rows past `n` stay zero and are masked by `valid`.
        from .native.lib import SIDE_WIDTH

        spectra = np.zeros((self.CHUNK, 1152), np.int16)
        side = np.zeros((self.CHUNK, SIDE_WIDTH), np.int16)
        n = self._parse_packed(spectra[:want], side[:want])
        if n == 0:
            return None

        import jax.numpy as jnp

        from .ops.granule import decode_chunk_packed

        pcm, self._state = decode_chunk_packed(
            spectra, side, self._state, jnp.int32(n)
        )
        return np.asarray(pcm[: n * 576]).tobytes()

    def decode_more(self) -> bytes | None:
        return self._decode_granules(self.CHUNK)

    def decode_frames(self, n_frames: int, bytes_per_frame: int) -> bytes | None:
        gpf = max(1, bytes_per_frame // (576 * 4))
        # the native parse loop keeps 2 output slots free per iteration
        # (a frame may yield 2 granules), so a capacity of N produces only
        # N-1 granules for single-granule (MPEG-2) frames: pad the request
        # — any extra decoded granule simply stays buffered for later reads
        return self._decode_granules(n_frames * gpf + (1 if gpf == 1 else 0))


class _StreamingNativeStream(_NativeStream):
    """Chunked-feed native path for non-materializable sources (pipes,
    sockets, unbounded streams): the C++ parser owns a compacting buffer
    fed on demand, so memory stays bounded regardless of stream length.
    Length/seeking are unavailable, mirroring the reference's non-Seeker
    degradation (decode.go:159-161)."""

    FEED = 1 << 16  # bytes per reader.read()

    def __init__(self, reader, dsp: str = "device"):
        import numpy as np

        from .native.lib import META_WIDTH, StreamingNativeParser

        self._np = np
        self._reader = reader
        self._data = b""
        self._parser = StreamingNativeParser()
        self._meta_width = META_WIDTH
        self._dsp_kind = dsp
        if dsp == "exact":
            from .native.lib import NativeDsp

            self._cpu_dsp = NativeDsp()
            self._state = None
        else:
            from .ops.granule import init_state

            self._init_state = init_state
            self._state = init_state()

    def _feed_more(self) -> bool:
        if self._parser.eof:
            return False
        chunk = self._reader.read(self.FEED)
        self._parser.feed(chunk or b"", eof=not chunk)
        return True

    def _parse(self, spectra, sfl, sfs, meta) -> int:
        while True:
            n = self._parser.parse_into(spectra, sfl, sfs, meta)
            if n > 0:
                return n
            if not self._feed_more():
                return 0

    def _parse_packed(self, spectra, side) -> int:
        while True:
            n = self._parser.parse_packed_into(spectra, side)
            if n > 0:
                return n
            if not self._feed_more():
                return 0

    def index(self):
        return None  # not materializable: Length unknown

    def restart(self, byte_offset: int) -> None:
        raise NotSeekableError()


def _make_backend(name: str):
    if name == "device":
        return _DeviceBackend()
    if name == "exact":
        # decoding runs entirely in the native stream; nothing to build here
        # (keeps the exact path accelerator-free)
        return _NullBackend()
    if name == "golden":
        return _GoldenBackend()
    raise MP3Error(f"mp3: unknown DSP backend {name!r}")


class _NullBackend:
    def reset(self) -> None:
        pass

    def decode_frames(self, frames):  # pragma: no cover - guarded in __init__
        raise MP3Error("mp3: exact backend requires the native parser")


class _DeviceBackend:
    def __init__(self) -> None:
        from .models.pipeline import StreamDecoder

        self._sd = StreamDecoder()

    def reset(self) -> None:
        self._sd.reset()

    def decode_frames(self, frames: list[ParsedFrame]) -> bytes:
        for f in frames:
            self._sd.feed_frame(f)
        return self._sd.decode_pending(flush=True)


class _GoldenBackend:
    def __init__(self) -> None:
        from .ops.reference_dsp import GoldenDecoder

        self._gd = GoldenDecoder()

    def reset(self) -> None:
        from .ops.reference_dsp import GoldenDecoder

        self._gd = GoldenDecoder()

    def decode_frames(self, frames: list[ParsedFrame]) -> bytes:
        out = b""
        for f in frames:
            out += self._gd.decode_frame(f.header, f.side_info, f.main_data)
        return out
