"""The seeded stream generator (go_mp3_tpu.synth): valid streams that both
host parsers read to a clean end, the feature spread its docstring
promises, and decodes within ISO full compliance across the backends."""

import io
import time

import numpy as np
import pytest

from go_mp3_tpu import Decoder, synth
from go_mp3_tpu.bitstream import Source
from go_mp3_tpu.bitstream.parser import FrameReader
from go_mp3_tpu.consts import EOFError_

KINDS = (synth.STEREO, synth.MONO)


def python_frames(data: bytes):
    """Every frame through the Python parser; raises unless the stream ends
    cleanly at a frame boundary."""
    src = Source(io.BytesIO(data))
    src.skip_tags()
    fr = FrameReader()
    frames = []
    while True:
        try:
            frames.append(fr.read(src, src.pos))
        except EOFError_:
            return frames


@pytest.fixture(scope="module", params=KINDS)
def stream(request):
    kind = request.param
    return kind, synth.generate_stream(kind, 240, seed=7)


def test_both_parsers_read_to_clean_eof(stream):
    from go_mp3_tpu.models.native_pipeline import (
        granule_batch_from_native,
        parse_stream_native,
    )
    from go_mp3_tpu.models.pipeline import granules_from_frame, pack_granule_batch
    from go_mp3_tpu.native.lib import index_stream

    kind, data = stream
    frames = python_frames(data)
    assert len(frames) == 240
    granules = [g for f in frames for g in granules_from_frame(f)]
    assert len(granules) == 240 * (2 if kind == synth.STEREO else 1)

    starts, _, _ = index_stream(data)
    assert len(starts) == 240
    (sp, sl, ss, me), _ = parse_stream_native(data)
    native, n = granule_batch_from_native(sp, sl, ss, me)
    python, m = pack_granule_batch(granules)
    assert n == m == len(granules)
    for field in native._fields:
        assert np.array_equal(
            np.asarray(getattr(native, field)), np.asarray(getattr(python, field))
        ), field


def test_feature_spread(stream):
    """Every feature the generator's docstring lists shows up in the parsed
    side info of a 240-frame stream."""
    kind, data = stream
    frames = python_frames(data)
    stereo = kind == synth.STEREO
    bitrates = {f.header.bitrate_index for f in frames}
    assert len(bitrates) >= 3, "VBR: frames take different bitrates"
    assert {f.header.padding_bit for f in frames} == {0, 1} or not stereo
    mdb = [f.side_info.main_data_begin for f in frames]
    assert mdb[0] == 0 and sum(b > 0 for b in mdb) > len(mdb) // 4
    assert max(mdb) <= (511 if stereo else 255)

    nch = 2 if stereo else 1
    ngr = 2 if stereo else 1
    blocks, tables, count1, preflag, sbg, scale = set(), set(), 0, 0, 0, 0
    for f in frames:
        si = f.side_info
        for gr in range(ngr):
            for ch in range(nch):
                ws = si.win_switch_flag[gr][ch]
                blocks.add((si.block_type[gr][ch], si.mixed_block_flag[gr][ch]))
                tables.update(si.table_select[gr][ch][: 2 if ws else 3])
                count1 += si.count1[gr][ch] > 2 * si.big_values[gr][ch]
                preflag += si.preflag[gr][ch]
                sbg += ws and any(si.subblock_gain[gr][ch])
                scale += si.scalefac_scale[gr][ch]
    want_blocks = {(0, 0), (1, 0), (2, 0), (3, 0)} | ({(2, 1)} if stereo else set())
    assert blocks == want_blocks
    assert tables & set(range(1, 16)) and tables & set(range(16, 24))
    assert tables & set(range(24, 32))
    assert count1 and preflag and sbg and scale

    spectra = np.stack([f.main_data.is_[:ngr, :nch] for f in frames])
    assert np.abs(spectra).max() > 127  # escapes with linbits
    assert np.abs(spectra[..., 36:]).max() <= 15  # int8 tail never clips
    if stereo:
        modes = {f.header.mode_extension for f in frames}
        assert modes == {0, 1, 2, 3}  # LR, IS, MS, MS+IS
        assert any(any(s) for f in frames for s in f.side_info.scfsi)
        assert {f.header.mode for f in frames} == {1}
    else:
        assert {f.header.mode for f in frames} == {3}


def test_deterministic_and_distinct():
    a = synth.generate_stream(synth.STEREO, 50, seed=3)
    assert a == synth.generate_stream(synth.STEREO, 50, seed=3)
    assert a != synth.generate_stream(synth.STEREO, 50, seed=4)
    pool = synth.FramePool(synth.MONO, 64, seed=0)
    assert pool.assemble(80, [0, 1]) != pool.assemble(80, [0, 2])


def test_continuity_corpus_shape():
    """48 stereo lanes of 1540 frames and 16 mono lanes of 2872: 193,792
    granules, every lane distinct, generated in well under 30 s."""
    from go_mp3_tpu.native.lib import index_stream

    t0 = time.perf_counter()
    lanes = synth.continuity_corpus(seed=0)
    elapsed = time.perf_counter() - t0
    assert elapsed < 30, f"corpus took {elapsed:.1f} s"
    assert len(lanes) == 64 and len(set(lanes)) == 64
    granules = 0
    for lane, rate in zip(lanes, synth.lane_sample_rates()):
        starts, bpf, sr = index_stream(lane)
        assert sr == rate
        granules += len(starts) * bpf // (576 * 4)
    assert granules == 193_792


@pytest.mark.parametrize("kind", KINDS)
def test_backends_full_compliance(kind):
    """golden (float64) vs exact (C++ float32) and the CPU-XLA device path
    vs exact: ISO/IEC 11172-4 full compliance (RMS < 0.289 LSB,
    maxdiff <= 2) on generated streams."""
    data = synth.generate_stream(kind, 80, seed=11)
    exact = np.frombuffer(Decoder(data, backend="exact").read_all(), "<i2")
    assert np.abs(exact).max() > 1000, "generated audio is not silence"
    for backend in ("golden", "device"):
        got = np.frombuffer(Decoder(data, backend=backend).read_all(), "<i2")
        assert got.shape == exact.shape
        d = got.astype(np.int64) - exact
        rms = float(np.sqrt((d.astype(np.float64) ** 2).mean()))
        assert rms < 0.289 and np.abs(d).max() <= 2, (backend, rms)


def test_bit_writer_packs_msb_first():
    w = synth.BitWriter()
    w.write(0b101, 3)
    w.write(0xFF, 4)  # only the low 4 bits count
    assert w.nbits == 7
    assert w.tobytes() == bytes([0b10111110])
    assert w.tobytes(pad_to=3) == bytes([0b10111110, 0, 0])
