"""lameinfo parsing (model: lameinfo/lameinfo_test.go)."""

import io
import struct

import pytest

from go_mp3_tpu import lameinfo


def build_xing_frame(
    tag=b"Xing",
    flags=0x0F,
    frame_count=1000,
    byte_count=500000,
    vbr_scale=50,
    lame_version=b"LAME3.100",
    delay=576,
    padding=1345,
    mpeg1=True,
    mono=False,
    frame_size=417,
) -> bytes:
    frame = bytearray(frame_size)
    # MPEG-1 Layer III 128kbps 44.1kHz header (or MPEG-2 variant)
    if mpeg1:
        word = 0xFFE00000 | (3 << 19) | (1 << 17) | (1 << 16) | (9 << 12)
    else:
        word = 0xFFE00000 | (2 << 19) | (1 << 17) | (1 << 16) | (4 << 12)
    if mono:
        word |= 3 << 6
    frame[0:4] = word.to_bytes(4, "big")
    side = (17 if mono else 32) if mpeg1 else (9 if mono else 17)
    pos = 4 + side
    frame[pos : pos + 4] = tag
    pos += 4
    frame[pos : pos + 4] = struct.pack(">I", flags)
    pos += 4
    if flags & lameinfo.FLAG_FRAME_COUNT:
        frame[pos : pos + 4] = struct.pack(">I", frame_count)
        pos += 4
    if flags & lameinfo.FLAG_BYTE_COUNT:
        frame[pos : pos + 4] = struct.pack(">I", byte_count)
        pos += 4
    if flags & lameinfo.FLAG_TOC:
        frame[pos : pos + 100] = bytes(min(int(i * 2.56), 255) for i in range(100))
        pos += 100
    if flags & lameinfo.FLAG_VBR_SCALE:
        frame[pos : pos + 4] = struct.pack(">I", vbr_scale)
        pos += 4
    if lame_version:
        frame[pos : pos + 9] = lame_version.ljust(9)
        pos += 9 + 12
        frame[pos] = (delay >> 4) & 0xFF
        frame[pos + 1] = ((delay & 0xF) << 4) | ((padding >> 8) & 0xF)
        frame[pos + 2] = padding & 0xFF
    return bytes(frame)


def test_full_xing_parse():
    info = lameinfo.parse(build_xing_frame())
    assert info.is_xing
    assert info.has_frame_count and info.frame_count == 1000
    assert info.has_byte_count and info.byte_count == 500000
    assert info.has_toc and len(info.toc) == 100
    assert info.has_vbr_scale and info.vbr_scale == 50
    assert info.lame_version == "LAME3.100"
    assert info.encoder_delay == 576
    assert info.encoder_padding == 1345


def test_info_tag_is_cbr():
    info = lameinfo.parse(build_xing_frame(tag=b"Info"))
    assert not info.is_xing


def test_flag_combinations():
    info = lameinfo.parse(build_xing_frame(flags=0x01, lame_version=b""))
    assert info.has_frame_count and not info.has_byte_count
    assert not info.has_lame_info
    info = lameinfo.parse(build_xing_frame(flags=0x0A, lame_version=b""))
    assert info.has_byte_count and info.has_vbr_scale
    assert not info.has_frame_count and not info.has_toc


def test_delay_padding_bit_packing():
    """12-bit delay / 12-bit padding packing across 3 bytes
    (lameinfo_test.go:428-467 model)."""
    for delay, padding in ((0, 0), (4095, 4095), (576, 1848), (1, 2)):
        info = lameinfo.parse(build_xing_frame(delay=delay, padding=padding))
        assert (info.encoder_delay, info.encoder_padding) == (delay, padding)


def test_gapless_math():
    info = lameinfo.parse(build_xing_frame(delay=576, padding=1345))
    assert info.total_delay() == 576 + 529
    assert info.total_padding() == 1345 - 529
    no_lame = lameinfo.parse(build_xing_frame(lame_version=b""))
    assert no_lame.total_delay() == 529
    assert no_lame.total_padding() == 0
    small_pad = lameinfo.parse(build_xing_frame(padding=100))
    assert small_pad.total_padding() == 0


def test_mpeg2_mono_offset():
    info = lameinfo.parse(
        build_xing_frame(mpeg1=False, mono=True, frame_size=300)
    )
    assert info.has_frame_count


def test_no_header_raises():
    with pytest.raises(lameinfo.NoXingHeaderError):
        lameinfo.parse(bytes(417))
    with pytest.raises(lameinfo.NoXingHeaderError):
        lameinfo.parse(b"\xff\xfb\x90\x00" + bytes(413))  # no Xing magic
    with pytest.raises(lameinfo.NoXingHeaderError):
        lameinfo.parse(b"")


def test_parse_from_reader():
    frame = build_xing_frame()
    info = lameinfo.parse_from_reader(io.BytesIO(frame + bytes(1000)))
    assert info.frame_count == 1000


def test_real_fixture_lame_header(reference_classic_lame):
    """classic_lame.mp3 was encoded by LAME: must carry a Xing tag with
    delay/padding (lameinfo_test.go:471-558 model)."""
    from go_mp3_tpu.bitstream.source import Source

    src = Source(io.BytesIO(reference_classic_lame))
    src.skip_tags()

    class R:
        def read(self, n):
            return src.read_full(n)[0]

    info = lameinfo.parse_from_reader(R())
    assert info.is_xing
    assert info.has_frame_count
    assert info.frame_count in (384, 385)  # audio frames after the tag frame
    assert info.lame_version.startswith("LAME")
    assert info.encoder_delay == 576
    assert info.total_delay() == 576 + 529


def test_toc_seek_point():
    info = lameinfo.parse(build_xing_frame())
    assert info.seek_point(0.0, 100000) == 0
    mid = info.seek_point(0.5, 100000)
    assert 40000 < mid < 60000
    assert info.seek_point(1.0, 100000) <= 100000


def test_gapless_decoder(reference_classic_lame):
    from go_mp3_tpu import Decoder, GaplessDecoder

    g = GaplessDecoder(reference_classic_lame, backend="golden")
    assert g.info is not None and g.info.is_xing
    plain = Decoder(reference_classic_lame, backend="golden")
    trim = (g.info.total_delay() + g.info.total_padding()) * 4
    assert g.length() == plain.length() - trim
    first = g.read(4096)
    assert len(first) == 4096
    # gapless start must equal plain stream at the delay offset
    plain.seek(g.info.total_delay() * 4)
    assert first == plain.read(4096)
