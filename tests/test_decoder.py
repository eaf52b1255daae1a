"""Public Decoder API: read/seek/length/duration semantics
(model: time_seek_test.go, trailing_tags_test.go, compliance_test.go)."""

import io

import numpy as np
import pytest

from go_mp3_tpu import Decoder, NotSeekableError
from util_synth import apev2_tag, id3v1_tag, id3v2_tag, silent_frame


class NonSeekable(io.RawIOBase):
    def __init__(self, data: bytes):
        self._b = io.BytesIO(data)

    def read(self, n=-1):
        return self._b.read(n)

    def readable(self):
        return True

    def seekable(self):
        return False


# ---------------------------------------------------------------------------
# Synthetic-stream tests (hermetic)
# ---------------------------------------------------------------------------


def test_silent_frames_decode_to_silence():
    d = Decoder(silent_frame() * 4, backend="golden")
    pcm = d.read_all()
    assert len(pcm) == 4 * 1152 * 4
    assert set(pcm) == {0}


def test_length_excludes_trailing_id3v1():
    data = silent_frame() * 3 + id3v1_tag()
    d = Decoder(data, backend="golden")
    assert d.length() == 3 * 1152 * 4
    assert len(d.read_all()) == 3 * 1152 * 4


def test_length_excludes_trailing_ape():
    data = silent_frame() * 3 + apev2_tag()
    d = Decoder(data, backend="golden")
    assert d.length() == 3 * 1152 * 4
    assert len(d.read_all()) == 3 * 1152 * 4


def test_length_excludes_both_trailing_tags():
    data = silent_frame() * 2 + apev2_tag() + id3v1_tag()
    d = Decoder(data, backend="golden")
    assert d.length() == 2 * 1152 * 4


def test_large_trailing_garbage():
    data = silent_frame() * 2 + bytes(100_000)
    d = Decoder(data, backend="golden")
    assert d.length() == 2 * 1152 * 4
    assert len(d.read_all()) == 2 * 1152 * 4


def test_leading_id3v2_tags_skipped():
    data = id3v2_tag(1000) + id3v2_tag(50) + silent_frame() * 2
    d = Decoder(data, backend="golden")
    assert d.length() == 2 * 1152 * 4


def test_leading_id3v1_then_id3v2():
    data = id3v1_tag() + id3v2_tag(10) + silent_frame()
    d = Decoder(data, backend="golden")
    assert d.length() == 1152 * 4


def test_non_seekable_source_degrades():
    d = Decoder(NonSeekable(silent_frame() * 2), backend="golden")
    assert d.length() == -1
    assert d.duration() == -1.0
    assert d.sample_count() == -1
    assert d.progress() == -1.0
    with pytest.raises(NotSeekableError):
        d.seek(0, io.SEEK_SET)
    with pytest.raises(NotSeekableError):
        d.seek_to_time(1.0)
    # but reading still works
    assert len(d.read_all()) == 2 * 1152 * 4


def test_crc_protected_frames():
    """protection_bit == 0 frames carry a 2-byte CRC that is read and
    ignored (ref: frame.go:56-65, value never checked)."""
    from util_synth import mpeg1_layer3_header

    word = mpeg1_layer3_header(protection=0)
    frame = bytearray(417)
    frame[0:4] = word.to_bytes(4, "big")
    frame[4:6] = b"\xde\xad"  # arbitrary CRC value
    data = bytes(frame) * 3
    d = Decoder(data, backend="golden")
    assert d.length() == 3 * 1152 * 4
    assert set(d.read_all()) == {0}


def test_vbr_mixed_bitrates():
    """Frames of different bitrates (VBR) in one stream: frame sizes differ
    but PCM-bytes-per-frame stays constant, so length/seek math holds."""
    data = (
        silent_frame(bitrate_index=9)
        + silent_frame(bitrate_index=11)
        + silent_frame(bitrate_index=14)
        + silent_frame(bitrate_index=9)
    )
    d = Decoder(data, backend="golden")
    assert d.length() == 4 * 1152 * 4
    assert len(d.read_all()) == 4 * 1152 * 4
    d.seek(2 * 4608)
    assert len(d.read(4608)) == 4608


def test_garbage_input_rejected():
    from go_mp3_tpu.consts import MP3Error

    with pytest.raises(MP3Error):
        Decoder(bytes(200_000), backend="golden")


# ---------------------------------------------------------------------------
# Real-fixture tests
# ---------------------------------------------------------------------------


def test_metadata_classic(reference_classic_lame):
    d = Decoder(reference_classic_lame, backend="golden")
    assert d.sample_rate() == 44100
    assert d.bytes_per_frame() == 1152 * 4
    assert d.length() == 385 * 1152 * 4
    assert abs(d.duration() - 10.057) < 0.01
    assert d.sample_count() == 385 * 1152


def test_metadata_mpeg2(reference_mpeg2):
    d = Decoder(reference_mpeg2, backend="golden")
    assert d.sample_rate() == 22050
    assert d.bytes_per_frame() == 576 * 4
    assert d.length() == 2872 * 576 * 4
    assert abs(d.duration() - 75.0) < 0.1


def test_read_in_chunks_matches_bulk(fixture_classic_lame):
    d1 = Decoder(fixture_classic_lame, backend="golden", readahead_frames=8)
    bulk = b""
    while len(bulk) < 8 * 4608:
        c = d1.read(1000)
        if not c:
            break
        bulk += c
    d2 = Decoder(fixture_classic_lame, backend="golden", readahead_frames=3)
    again = d2.read(len(bulk))
    assert bulk == again


def test_position_progress_tracking(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    assert d.position() == 0.0
    d.read(44100 * 4)  # one second
    assert abs(d.position() - 1.0) < 1e-9
    assert abs(d.progress() - (44100 * 4 / d.length())) < 1e-12
    assert d.sample_position() == 44100
    assert abs(d.remaining() - (d.duration() - 1.0)) < 1e-9


def test_seek_determinism(fixture_classic_lame):
    """Seek away and back must reproduce byte-identical PCM
    (time_seek_test.go:1010-1082)."""
    d = Decoder(fixture_classic_lame, backend="golden")
    d.seek(3 * 4608, io.SEEK_SET)
    first = d.read(4608 * 2)
    d.seek(40 * 4608, io.SEEK_SET)
    d.read(100)
    d.seek(3 * 4608, io.SEEK_SET)
    second = d.read(4608 * 2)
    assert first == second


def test_seek_to_start_reproduces_first_read(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    first = d.read(9000)
    d.seek(0, io.SEEK_SET)
    assert d.read(9000) == first


def test_seek_matches_linear_decode(fixture_classic_lame):
    """After a mid-file seek, the first granule may differ (the reference
    also discards pre-warm-up state, decode.go:120-134), but from the second
    granule of the target frame on, PCM must be bit-identical to a linear
    decode — the warm-up frame fully recharges reservoir/overlap/polyphase."""
    d = Decoder(fixture_classic_lame, backend="golden")
    linear = d.read(30 * 4608)
    target = 25 * 4608
    d.seek(target, io.SEEK_SET)
    seeked = d.read(4608 * 2)
    lin_slice = np.frombuffer(linear[target : target + 4608 * 2], dtype="<i2")
    skd = np.frombuffer(seeked, dtype="<i2")
    diff = np.abs(lin_slice.astype(np.int32) - skd.astype(np.int32))
    # 2304 int16 values = one granule (1152 samples x 2 ch) at 44.1 kHz
    assert (diff[2304:] == 0).all()  # exact from granule 1 onward
    assert diff[:2304].max() < 2000  # warm-up divergence is bounded


def test_seek_current_and_end(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    assert d.seek(0, io.SEEK_CUR) == 0
    d.read(4608)
    assert d.seek(0, io.SEEK_CUR) == 4608
    d.seek(-4608, io.SEEK_END)
    assert d.tell() == d.length() - 4608
    got = d.read_all()
    assert len(got) == 4608


def test_seek_negative_clamps(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    d.seek(-100, io.SEEK_SET)  # must clamp, not crash
    assert d.tell() == 0
    assert len(d.read(100)) == 100


def test_seek_past_eof(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    d.seek(d.length() + 5000, io.SEEK_SET)
    assert d.read(100) == b""


def test_seek_to_time_accuracy(fixture_classic_lame):
    """Position after seek_to_time within 30 ms of target
    (time_seek_test.go:949-956)."""
    d = Decoder(fixture_classic_lame, backend="golden")
    for t in (0.0, 1.5, 5.0, 9.9):
        d.seek_to_time(t)
        assert abs(d.position() - t) < 0.03
        assert d.tell() % 4 == 0


def test_seek_to_sample_and_skip(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="golden")
    d.seek_to_sample(44100)
    assert d.sample_position() == 44100
    d.skip(1.0)
    assert abs(d.position() - 2.0) < 0.03
    d.skip(-10.0)  # clamps to 0
    assert d.position() == 0.0
    d.seek_to_sample(10**12)  # clamps to end
    assert d.sample_position() == d.sample_count()


def test_device_backend_matches_golden(fixture_classic_lame):
    gold = Decoder(fixture_classic_lame, backend="golden")
    dev = Decoder(fixture_classic_lame, backend="device")
    a = np.frombuffer(gold.read(20 * 4608), dtype="<i2").astype(np.int32)
    b = np.frombuffer(dev.read(20 * 4608), dtype="<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 2


def test_source_unread_prepends_not_appends():
    """Unread bytes must come back BEFORE the remaining stream, not after
    (time_seek_test.go:15-43 — the regression that motivated the test)."""
    import io

    from go_mp3_tpu.bitstream import Source

    src = Source(io.BytesIO(b"cdef"))
    first, _short = src.read_full(2)
    assert first == b"cd"
    src.unread(b"ab")
    assert src.read_full(4)[0] == b"abef"


def test_seek_to_time_no_duration_multiplication_bug(fixture_classic_lame):
    """seek_to_time(1.0) must land at ~1 s, not 1 s squared/doubled
    (time_seek_test.go:421-449, a historical fork bug)."""
    d = Decoder(fixture_classic_lame)
    d.seek_to_time(1.0)
    assert abs(d.position() - 1.0) <= 0.030


def test_seek_to_time_result_is_sample_aligned(fixture_classic_lame):
    """Byte position after seek_to_time is 4-byte aligned (decode.go:337)."""
    d = Decoder(fixture_classic_lame)
    for t in (0.313, 1.7217, 4.99999):
        d.seek_to_time(t)
        assert d._pos % 4 == 0


def test_skip_clamps_beyond_start_and_end(fixture_classic_lame):
    """skip() clamps at stream boundaries (time_seek_test.go:515-574)."""
    d = Decoder(fixture_classic_lame)
    d.seek_to_time(1.0)
    d.skip(-100.0)
    assert d.position() == 0.0
    d.skip(10_000.0)
    assert abs(d.position() - d.duration()) < 0.05
    assert d.read(4096) == b""  # at end


def test_seek_with_trailing_tags():
    """Seeking still works when trailing APE/ID3v1 junk follows the audio
    (trailing_tags_test.go:309-372)."""
    from util_synth import apev2_tag, id3v1_tag, silent_frame

    audio = silent_frame() * 40
    data = audio + apev2_tag(3) + id3v1_tag()
    d = Decoder(data, backend="golden")
    n = d.length()
    assert n == 40 * 4608
    d.seek(20 * 4608)
    mid = d.read(4608)
    assert len(mid) == 4608
    d.seek(0)
    total = d.read_all()
    assert len(total) == n


def test_python_parse_device_path_matches_native(fixture_classic_lame):
    """backend='device' with use_native=False (pure-Python parse feeding the
    batched device DSP) produces byte-identical PCM to the native-parse
    device path — the two host parsers and the two staging pipelines agree
    end to end."""
    a = Decoder(fixture_classic_lame, backend="device", use_native=False)
    b = Decoder(fixture_classic_lame, backend="device")
    assert a.read_all() == b.read_all()


def test_mpeg2_seek_determinism(fixture_mpeg2):
    """MPEG-2 (single-granule frames, 2304 bytes/frame) seek semantics:
    warm-up convergence and byte-identical re-reads, mirroring the MPEG-1
    integration checks (time_seek_test.go:969-1008)."""
    d = Decoder(fixture_mpeg2, backend="device")
    assert d.bytes_per_frame() == 2304
    d.seek_to_time(30.0)
    assert abs(d.position() - 30.0) <= 0.030
    first = d.read(2304 * 4)
    d.seek_to_time(60.0)
    d.read(2304)
    d.seek_to_time(30.0)
    assert d.read(2304 * 4) == first


def test_mpeg2_seek_matches_linear(fixture_mpeg2):
    """MPEG-2 seeks land bit-identical to the linear decode FROM THE TARGET.

    Beyond the reference: its fixed one-frame warm-up (decode.go:120-134)
    cannot recharge a 511-byte bit reservoir from ~180-byte low-bitrate
    MPEG-2 frames, so its seeks only converge a couple frames later. This
    decoder sizes the warm-up window from the frame byte index instead."""
    lin = Decoder(fixture_mpeg2, backend="device")
    ref = lin.read_all()
    d = Decoder(fixture_mpeg2, backend="device")
    off = 500 * 2304  # frame 500
    d.seek(off)
    got = d.read(2304 * 8)
    assert got == ref[off : off + 2304 * 8]


def test_long_cbr_stream_index_seek_duration():
    """Hermetic stand-in for the reference's primary fixture classic.mp3
    (~355 s CBR, absent from this mount — .MISSING_LARGE_BLOBS): a
    multi-minute CBR stream at thousands-of-frames scale gates the index /
    length / duration / deep-seek math (decode.go:154-216 semantics)."""
    from util_synth import silent_frame

    frame = silent_frame()  # 417 B, 128 kbps 44.1 kHz -> 1152 samples
    n = 13600  # ~355 s, classic.mp3 scale
    data = frame * n
    d = Decoder(data, backend="device")
    assert d.length() == n * 4608
    assert len(d._frame_starts) == n
    assert d._frame_starts[1] - d._frame_starts[0] == 417
    assert abs(d.duration() - n * 1152 / 44100) < 1e-9

    # deep seek: position math stays exact at minute offsets
    d.seek_to_time(300.0)
    assert abs(d.position() - 300.0) <= 0.030
    got = d.read(4608)
    assert len(got) == 4608
    pos_after = d.position()
    assert abs(pos_after - (300.0 + 1152 / 44100)) <= 0.031

    # seek near the end: the tail reads exactly to length
    d.seek(d.length() - 2 * 4608)
    assert len(d.read(-1)) == 2 * 4608
    assert d.tell() == d.length()

    # python (non-native) index agrees on a prefix of the same stream
    d2 = Decoder(frame * 64, backend="golden", use_native=False)
    d2._ensure_frame_starts_and_length()
    assert d2.length() == 64 * 4608
    assert d2._frame_starts == [417 * i for i in range(64)]


def test_seek_pathological_low_bitrate_reservoir():
    """Seeks stay bit-identical when the reservoir backreference spans many
    tiny frames (8 kbps MPEG-2: 26-byte frames, 13 main-data bytes each —
    a 247-byte main_data_begin reaches 19 frames back). A fixed warm-up
    window (the reference's 1 frame; this repo's former 8-frame cap) cannot
    recharge that reservoir. Hermetic: the stream is built in code
    (util_synth.low_bitrate_mpeg2_stream)."""
    from util_synth import low_bitrate_mpeg2_stream

    data, content_f, n_frames = low_bitrate_mpeg2_stream()
    bpf = 2304
    for backend, use_native in (("golden", False), ("device", None)):
        full = Decoder(data, backend=backend, use_native=use_native).read(-1)
        assert len(full) == n_frames * bpf
        # targets: the content frame and the two frames whose PCM still
        # depends on its spectra through the overlap store / polyphase FIFO
        for f in (content_f, content_f + 1, content_f + 2):
            d = Decoder(data, backend=backend, use_native=use_native)
            d.seek(f * bpf)
            got = d.read(-1)
            assert got == full[f * bpf :], (backend, f)


def test_seek_pathological_stream_defeats_capped_warmup(monkeypatch):
    """The fixture above is a real stress: with the warm-up depth clamped
    to the former 8-frame cap, the same seek does NOT reproduce the linear
    decode (guards the fixture against becoming vacuous)."""
    from util_synth import low_bitrate_mpeg2_stream

    data, content_f, _ = low_bitrate_mpeg2_stream()
    bpf = 2304
    full = Decoder(data, backend="golden", use_native=False).read(-1)
    orig = Decoder._warmup_depth
    monkeypatch.setattr(
        Decoder, "_warmup_depth", lambda self, f: min(orig(self, f), 8)
    )
    d = Decoder(data, backend="golden", use_native=False)
    d.seek((content_f + 1) * bpf)
    assert d.read(-1) != full[(content_f + 1) * bpf :]


def test_warmup_depth_geometry():
    """Unit check of the warm-up window math: the chosen depth always
    covers the stream's main_data_begin window with main-data bytes, using
    the conservative (CRC-counted) per-frame overhead."""
    from util_synth import low_bitrate_mpeg2_stream

    data, content_f, n_frames = low_bitrate_mpeg2_stream()
    d = Decoder(data, backend="golden", use_native=False)
    assert d._mdb_window == 255  # MPEG-2: 8-bit main_data_begin
    assert d._frame_overhead == 4 + 2 + 9
    for f in range(2, n_frames):
        k = d._warmup_depth(f)
        covered = (
            d._frame_starts[f - 2] - d._frame_starts[f - k]
            - d._frame_overhead * (k - 2)
        )
        assert covered >= 255 or f - k == 0, (f, k, covered)


def test_mpeg2_midframe_seek_matches_linear(fixture_mpeg2):
    """Mid-frame byte seeks on MPEG-2 land bit-identical to linear decode.

    Regression: the native parse loop's keep-2-slots-free guard yielded one
    granule fewer than requested for single-granule frames, so the seek
    trim (warm frames + intra-frame offset) over-ran the decode buffer and
    every subsequent read came back shifted by the intra-frame offset."""
    full = Decoder(fixture_mpeg2, backend="device").read_all()
    for off in (88 * 2304 + 1000, 500 * 2304 + 4, 1148 * 2304 + 1008):
        d = Decoder(fixture_mpeg2, backend="device")
        d.seek(off)
        assert d.read(9216) == full[off : off + 9216], off
