"""Native (C++) parser and exact DSP: parity with the Python/golden paths."""

import numpy as np
import pytest

from go_mp3_tpu import Decoder

try:
    from go_mp3_tpu.native import lib as native

    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="native lib not built")


def test_native_parser_matches_python(fixture_classic_lame, fixture_mpeg2):
    """Granule records from the C++ parser are bit-identical to the Python
    parser's on both fixtures."""
    from go_mp3_tpu.models.native_pipeline import (
        granule_batch_from_native,
        parse_stream_native,
    )
    from go_mp3_tpu.models.pipeline import pack_granule_batch
    from go_mp3_tpu.parallel.corpus import parse_stream_granules

    for data in (fixture_classic_lame, fixture_mpeg2):
        (sp, sl, ss, me), _sr = parse_stream_native(data)
        nb, nv = granule_batch_from_native(sp, sl, ss, me)
        pg = parse_stream_granules(data)
        pb, pv = pack_granule_batch(pg)
        assert nv == pv == len(pg)
        for f in nb._fields:
            assert np.array_equal(
                np.asarray(getattr(nb, f)), np.asarray(getattr(pb, f))
            ), f


def test_native_index_matches_python(fixture_classic_lame):
    from go_mp3_tpu.native.lib import index_stream

    starts, bpf, sr = index_stream(fixture_classic_lame)
    d = Decoder(fixture_classic_lame, backend="golden")
    assert bpf == d.bytes_per_frame()
    assert sr == d.sample_rate()
    assert len(starts) * bpf == d.length()
    assert list(starts) == d._frame_starts


def test_exact_backend_full_compliance(fixture_classic_lame, fixture_mpeg2):
    """C++ exact DSP vs float64 golden: within 1 LSB everywhere."""
    for data in (fixture_classic_lame, fixture_mpeg2):
        de = Decoder(data, backend="exact")
        dg = Decoder(data, backend="golden")
        n = 60 * de.bytes_per_frame()
        a = np.frombuffer(de.read(n), "<i2").astype(np.int32)
        b = np.frombuffer(dg.read(n), "<i2").astype(np.int32)
        assert len(a) == len(b)
        assert np.abs(a - b).max() <= 1


def test_exact_backend_deterministic_seek(fixture_classic_lame):
    d = Decoder(fixture_classic_lame, backend="exact")
    d.seek(11 * 4608)
    first = d.read(4608)
    d.seek(0)
    d.read(64)
    d.seek(11 * 4608)
    assert d.read(4608) == first


def test_device_backend_uses_native_and_matches_exact(fixture_classic_lame):
    dn = Decoder(fixture_classic_lame, backend="device")
    assert dn._native is not None
    de = Decoder(fixture_classic_lame, backend="exact")
    a = np.frombuffer(dn.read(30 * 4608), "<i2").astype(np.int32)
    b = np.frombuffer(de.read(30 * 4608), "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 2


def test_native_parse_from_offset(fixture_classic_lame):
    """NativeParser(data, offset) parses from a frame boundary (seek path)."""
    from go_mp3_tpu.native.lib import NativeParser, index_stream

    starts, bpf, _ = index_stream(fixture_classic_lame)
    p = NativeParser(fixture_classic_lame, offset=int(starts[10]))
    n, sp, sl, ss, me = p.parse(8)
    assert n == 8
    full = NativeParser(fixture_classic_lame)
    fsp, _, _, _ = full.parse_all()
    gr_per_frame = bpf // (576 * 4)
    # The first frames after an offset restart decode against an empty bit
    # reservoir (exactly the reference's seek warm-up situation); after two
    # frames (> 511 reservoir bytes) the spectra converge to the linear parse.
    warm = 2 * gr_per_frame
    lin = fsp[10 * gr_per_frame : 10 * gr_per_frame + 8]
    assert np.array_equal(sp[warm:8], lin[warm:8])


def test_packed_interface_matches_legacy(fixture_classic_lame, fixture_mpeg2):
    """gmp_parse_packed (spectra [n,1152] + sidecar [n,144] i16) carries
    exactly the legacy four-array records, and batch_from_packed
    reconstructs an identical GranuleBatch on device."""
    import jax.numpy as jnp

    from go_mp3_tpu.models.native_pipeline import granule_batch_from_native
    from go_mp3_tpu.native.lib import SIDE_WIDTH, NativeParser
    from go_mp3_tpu.ops.granule import batch_from_packed

    for data in (fixture_classic_lame, fixture_mpeg2):
        p = NativeParser(data)
        sp, sl, ss, me = p.parse_all()
        p.close()
        n = sp.shape[0]

        q = NativeParser(data)
        spp = np.zeros((n + 2, 1152), np.int16)
        side = np.zeros((n + 2, SIDE_WIDTH), np.int16)
        got = 0
        while True:
            k = q.parse_packed_into(spp[got:], side[got:])
            if k == 0:
                break
            got += k
        q.close()
        assert got == n

        legacy, _ = granule_batch_from_native(sp, sl, ss, me)
        packed = batch_from_packed(jnp.asarray(spp[:n]), jnp.asarray(side[:n]))
        for f in legacy._fields:
            a = np.asarray(getattr(legacy, f))
            b = np.asarray(getattr(packed, f))
            assert a.dtype == b.dtype or f == "spectra", f
            assert np.array_equal(a, b), f


def test_decode_chunk_packed_matches_batch(fixture_classic_lame):
    """decode_chunk_packed_batch == decode_chunk_batch on a real chunk."""
    from go_mp3_tpu.models.native_pipeline import granule_batch_from_native
    from go_mp3_tpu.native.lib import SIDE_WIDTH, NativeParser
    from go_mp3_tpu.ops.granule import (
        decode_chunk_batch,
        decode_chunk_packed_batch,
    )
    from go_mp3_tpu.parallel.mesh import init_states

    t = 24
    p = NativeParser(fixture_classic_lame)
    spp = np.zeros((t, 1152), np.int16)
    side = np.zeros((t, SIDE_WIDTH), np.int16)
    got = 0
    while got < t:
        k = p.parse_packed_into(spp[got:], side[got:])
        assert k > 0
        got += k
    p.close()

    q = NativeParser(fixture_classic_lame)
    sp, sl, ss, me = q.parse_all()
    q.close()
    legacy, _ = granule_batch_from_native(sp[:t], sl[:t], ss[:t], me[:t])

    states = init_states(1)
    valid = np.array([t], np.int32)
    import jax

    stack = lambda a: np.asarray(a)[None]
    batch1 = jax.tree_util.tree_map(stack, legacy)
    pcm_a, st_a = decode_chunk_batch(batch1, states, valid)
    pcm_b, st_b = decode_chunk_packed_batch(spp[None], side[None], states, valid)
    assert np.array_equal(np.asarray(pcm_a), np.asarray(pcm_b))
    assert np.array_equal(np.asarray(st_a.store), np.asarray(st_b.store))
    assert np.array_equal(np.asarray(st_a.v_fifo), np.asarray(st_b.v_fifo))


def test_sharded_packed_decoder_on_mesh(fixture_classic_lame):
    """The mesh-sharded packed decoder matches the unsharded packed path."""
    import jax

    from go_mp3_tpu.native.lib import SIDE_WIDTH, NativeParser
    from go_mp3_tpu.ops.granule import decode_chunk_packed_batch
    from go_mp3_tpu.parallel.mesh import (
        init_states,
        make_mesh,
        make_sharded_packed_decoder,
    )

    n_dev = len(jax.devices())
    t = 8
    p = NativeParser(fixture_classic_lame)
    spp = np.zeros((t, 1152), np.int16)
    side = np.zeros((t, SIDE_WIDTH), np.int16)
    got = 0
    while got < t:
        k = p.parse_packed_into(spp[got:], side[got:])
        assert k > 0
        got += k
    p.close()

    spectra_s = np.broadcast_to(spp, (n_dev, t, 1152)).copy()
    side_s = np.broadcast_to(side, (n_dev, t, SIDE_WIDTH)).copy()
    states = init_states(n_dev)
    valid = np.full(n_dev, t, np.int32)

    fn = make_sharded_packed_decoder(make_mesh())
    pcm, _ = fn(spectra_s, side_s, states, valid)
    ref, _ = decode_chunk_packed_batch(spectra_s, side_s, states, valid)
    assert np.array_equal(np.asarray(pcm), np.asarray(ref))


def test_packed8_interface_matches_legacy(fixture_classic_lame, fixture_mpeg2):
    """The int8-quantized interface (int16 head plane + int8 tail + byte
    sidecar) reconstructs bit-identical GranuleBatches; mpeg2 exercises real
    |x| > 127 values (which must land in the head plane)."""
    import jax.numpy as jnp

    from go_mp3_tpu.models.native_pipeline import granule_batch_from_native
    from go_mp3_tpu.native.lib import (
        HEAD_WIDTH,
        SIDE8_WIDTH,
        SP8_TAIL_WIDTH,
        NativeParser,
    )
    from go_mp3_tpu.ops.granule import batch_from_packed8

    for data in (fixture_classic_lame, fixture_mpeg2):
        p = NativeParser(data)
        sp, sl, ss, me = p.parse_all()
        p.close()
        n = sp.shape[0]

        q = NativeParser(data)
        sp8 = np.zeros((n + 2, SP8_TAIL_WIDTH), np.int8)
        head = np.zeros((n + 2, HEAD_WIDTH), np.int16)
        sd8 = np.zeros((n + 2, SIDE8_WIDTH), np.uint8)
        got = 0
        while True:
            k = q.parse_packed8_into(sp8[got:], head[got:], sd8[got:])
            if k == 0:
                break
            got += k
        q.close()
        assert got == n
        if data is not fixture_classic_lame:
            assert (np.abs(sp.reshape(n, 1152)) > 127).any(), "want |x| > 127"

        legacy, _ = granule_batch_from_native(sp, sl, ss, me)
        packed = batch_from_packed8(
            jnp.asarray(sp8[:n]), jnp.asarray(head[:n]), jnp.asarray(sd8[:n])
        )
        for f in legacy._fields:
            assert np.array_equal(
                np.asarray(getattr(legacy, f)), np.asarray(getattr(packed, f))
            ), f


class _PipeReader:
    """Non-seekable, read-only stream (pipe/socket stand-in)."""

    def __init__(self, data: bytes, chunk: int = 3789):
        self._data = data
        self._off = 0
        self._chunk = chunk

    def read(self, n: int = -1) -> bytes:
        n = self._chunk if n is None or n < 0 else min(n, self._chunk)
        out = self._data[self._off : self._off + n]
        self._off += len(out)
        return out

    def seekable(self) -> bool:
        return False


def test_streaming_native_path_nonseekable(fixture_classic_lame, fixture_mpeg2):
    """A pipe-style source keeps the native fast path (chunked feed, bounded
    memory) and produces byte-identical PCM; Length/seek degrade like the
    reference's non-Seeker case (decode.go:159-161)."""
    from go_mp3_tpu import Decoder, NotSeekableError
    from go_mp3_tpu.decoder import _StreamingNativeStream

    for data in (fixture_classic_lame, fixture_mpeg2):
        ref = Decoder(data, backend="exact").read_all()
        d = Decoder(_PipeReader(data), backend="exact")
        assert isinstance(d._native, _StreamingNativeStream)
        assert d.length() == -1
        pcm = d.read_all()
        assert pcm == ref
        with pytest.raises(NotSeekableError):
            d.seek(4608)


def test_streaming_native_path_device_backend(fixture_classic_lame):
    from go_mp3_tpu import Decoder
    from go_mp3_tpu.decoder import _StreamingNativeStream

    ref = Decoder(fixture_classic_lame, backend="device").read_all()
    d = Decoder(_PipeReader(fixture_classic_lame), backend="device")
    assert isinstance(d._native, _StreamingNativeStream)
    assert d.read_all() == ref


def test_streaming_parser_split_feeds_match(fixture_mpeg2):
    """Byte-identical granules regardless of feed-chunk boundaries."""
    from go_mp3_tpu.native.lib import (
        META_WIDTH,
        NativeParser,
        StreamingNativeParser,
    )

    p = NativeParser(fixture_mpeg2)
    ref = p.parse_all()
    p.close()
    for chunk in (1 << 20, 4096, 517):
        sp = np.zeros((512, 2, 576), np.int16)
        sl = np.zeros((512, 2, 22), np.int32)
        ss = np.zeros((512, 2, 39), np.int32)
        me = np.zeros((512, META_WIDTH), np.int32)
        s = StreamingNativeParser()
        got, off = [], 0
        while True:
            piece = fixture_mpeg2[off : off + chunk]
            off += len(piece)
            s.feed(piece, eof=off >= len(fixture_mpeg2))
            while True:
                n = s.parse_into(sp, sl, ss, me)
                if n == 0:
                    break
                got.append(sp[:n].copy())
            if off >= len(fixture_mpeg2):
                break
        s.close()
        allsp = np.concatenate(got)
        assert np.array_equal(allsp, ref[0]), chunk


def test_streaming_sync_limit_is_terminal_bounded_memory(fixture_classic_lame):
    """A >=64 KiB un-syncable run in a fed stream must kill the parse
    (reference sync-limit semantics) WITHOUT the parser buffering the rest
    of the stream forever: eof turns True and further feeds are dropped."""
    from go_mp3_tpu.native.lib import META_WIDTH, StreamingNativeParser

    good = fixture_classic_lame[:4000]
    s = StreamingNativeParser()
    s.feed(good)
    sp = np.zeros((64, 2, 576), np.int16)
    sl = np.zeros((64, 2, 22), np.int32)
    ss = np.zeros((64, 2, 39), np.int32)
    me = np.zeros((64, META_WIDTH), np.int32)
    got = 0
    while True:
        n = s.parse_into(sp, sl, ss, me)
        if n == 0:
            break
        got += n
    assert got > 0
    # now feed > 64 KiB of un-syncable garbage in pieces
    junk = b"\x00" * 8192
    fed = 0
    while not s.eof and fed < 40:
        s.feed(junk)
        s.parse_into(sp, sl, ss, me)
        fed += 1
    assert s.eof, "sync-limit must terminate the stream"
    assert fed <= 12, f"should die within ~64KiB of junk, took {fed} feeds"
    # further feeds must be no-ops (no unbounded buffering) and parses 0
    for _ in range(3):
        s.feed(junk)
        assert s.parse_into(sp, sl, ss, me) == 0
    s.close()


def test_streaming_giant_id3_tag_skipped_incrementally(fixture_classic_lame):
    """A multi-MB leading ID3v2 tag fed in small pieces is consumed
    incrementally (the buffer compacts instead of accumulating the tag)."""
    from go_mp3_tpu.native.lib import META_WIDTH, StreamingNativeParser

    audio = fixture_classic_lame
    size = 5_000_000
    hdr = b"ID3\x04\x00\x00" + bytes(
        [(size >> 21) & 0x7F, (size >> 14) & 0x7F, (size >> 7) & 0x7F,
         size & 0x7F]
    )
    s = StreamingNativeParser()
    s.feed(hdr)
    sp = np.zeros((64, 2, 576), np.int16)
    sl = np.zeros((64, 2, 22), np.int32)
    ss = np.zeros((64, 2, 39), np.int32)
    me = np.zeros((64, META_WIDTH), np.int32)
    assert s.parse_into(sp, sl, ss, me) == 0
    # feed the tag body in 64 KiB pieces; position must ADVANCE through it
    piece = b"\x00" * 65536
    fed = 0
    while fed < size:
        s.feed(piece[: min(65536, size - fed)])
        fed += min(65536, size - fed)
        s.parse_into(sp, sl, ss, me)
    pos_after_tag = s.tell()
    assert pos_after_tag >= size, "tag must be consumed incrementally"
    s.feed(audio, eof=True)
    n = s.parse_into(sp, sl, ss, me)
    assert n > 0, "audio after the giant tag must decode"
    s.close()


def test_packed8_large_and_small_caps_byte_identical(
    fixture_classic_lame, fixture_mpeg2
):
    """Corpus-sized requests (cap >= 192) take the non-temporal-store
    emission path; small requests keep cached stores. Both must produce
    byte-identical planes for the same stream (mp3parse.cpp
    gmp_parse_packed8's `nt` gate)."""
    from go_mp3_tpu.native.lib import (
        HEAD_WIDTH,
        SIDE8_WIDTH,
        SP8_TAIL_WIDTH,
        NativeParser,
    )

    for data in (fixture_classic_lame, fixture_mpeg2):
        def parse_all_with_cap(cap):
            p = NativeParser(data)
            sp = np.zeros((4096, SP8_TAIL_WIDTH), np.int8)
            hd = np.zeros((4096, HEAD_WIDTH), np.int16)
            sd = np.zeros((4096, SIDE8_WIDTH), np.uint8)
            got = 0
            while True:
                k = p.parse_packed8_into(
                    sp[got : got + cap], hd[got : got + cap], sd[got : got + cap]
                )
                if k == 0:
                    break
                got += k
            p.close()
            return sp[:got], hd[:got], sd[:got]

        big = parse_all_with_cap(256)  # NT path
        small = parse_all_with_cap(128)  # cached path
        assert big[0].shape == small[0].shape
        for a, b in zip(big, small):
            assert np.array_equal(a, b)


def test_batch_parser_hard_error_names_stream(fixture_classic_lame):
    """A malformed stream mid-corpus raises ValueError naming the lane
    (gmp_parse_packed8_many's err_stream out-param)."""
    import numpy as np
    import pytest

    from go_mp3_tpu.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
    from go_mp3_tpu.native.lib import BatchParser, index_stream

    good = fixture_classic_lame
    starts, _, _ = index_stream(good)
    # corrupt a frame header to bitrate_index 0 (free-bitrate format):
    # still a valid sync, then the reference's hard "free bitrate" error
    # (frameheader.go:323-326 semantics)
    bad = bytearray(good)
    off = int(starts[3])
    bad[off + 2] &= 0x0F  # bitrate_index -> 0
    bp = BatchParser([good, bytes(bad), good])
    sp = np.zeros((3, 64, SP8_TAIL_WIDTH), np.int8)
    he = np.zeros((3, 64, HEAD_WIDTH), np.int16)
    sd = np.zeros((3, 64, SIDE8_WIDTH), np.uint8)
    valids = np.zeros(3, np.int32)
    with pytest.raises(ValueError, match="stream 1"):
        for _ in range(64):
            if bp.parse_chunk_into(sp, he, sd, valids) == 0:
                break
    bp.close()


def test_batch_parser_lane_blocks(fixture_classic_lame, fixture_mpeg2):
    """parse_chunk_into(lo, hi) over disjoint contiguous lane blocks is
    byte-identical to the full-corpus call (the per-worker many-call the
    threaded parse uses), errors name the ABSOLUTE lane index, and bad
    ranges raise (not assert: the bound guards raw C pointers)."""
    import numpy as np
    import pytest

    from go_mp3_tpu.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
    from go_mp3_tpu.native.lib import BatchParser

    streams = [
        fixture_classic_lame,
        fixture_mpeg2[:40_000],
        fixture_classic_lame[:30_000],
    ]

    def run(blocks):
        bp = BatchParser(streams)
        sp = np.zeros((3, 64, SP8_TAIL_WIDTH), np.int8)
        he = np.zeros((3, 64, HEAD_WIDTH), np.int16)
        sd = np.zeros((3, 64, SIDE8_WIDTH), np.uint8)
        out = []
        while True:
            valids = np.zeros(3, np.int32)
            n = 0
            for lo, hi in blocks:
                n = max(n, bp.parse_chunk_into(sp, he, sd, valids, lo, hi))
            if not valids.any():
                break
            assert n == valids.max()  # return value = max granules
            out.append((sp.copy(), he.copy(), sd.copy(), valids.copy(), n))
        bp.close()
        return out

    full = run([(0, 3)])
    split = run([(0, 2), (2, 3)])
    assert len(full) == len(split) > 0
    for a, b in zip(full, split):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)

    bp = BatchParser(streams)
    sp = np.zeros((3, 16, SP8_TAIL_WIDTH), np.int8)
    he = np.zeros((3, 16, HEAD_WIDTH), np.int16)
    sd = np.zeros((3, 16, SIDE8_WIDTH), np.uint8)
    valids = np.zeros(3, np.int32)
    with pytest.raises(ValueError, match="lane block"):
        bp.parse_chunk_into(sp, he, sd, valids, 2, 5)
    assert bp.parse_chunk_into(sp, he, sd, valids, 1, 1) == 0  # empty ok
    bp.close()


def test_pack_fused_tail_matches_numpy():
    """The SSE 16x16-blocked fused-tail transpose is byte-identical to
    the numpy fallback across full/capped widths and non-multiple-of-16
    shapes (the generic edge tiles)."""
    import numpy as np

    from go_mp3_tpu.native.lib import pack_fused_tail
    from go_mp3_tpu.ops.granule import fused_stream_nbytes

    rng = np.random.default_rng(3)
    for s, t, l in [(4, 64, 512), (4, 64, 464), (3, 50, 464), (2, 17, 33),
                    (1, 16, 16), (5, 31, 100)]:
        spectra = rng.integers(-128, 128, size=(s, t, 1024)).astype(np.int8)
        a = 2 * l * t
        bn = np.zeros((s, fused_stream_nbytes(t, l)), np.uint8)
        bp = np.zeros_like(bn)
        assert pack_fused_tail(spectra, bn, l)
        bp[:, :a].reshape(s, 2, l, t)[:] = spectra.reshape(
            s, t, 2, 512
        ).transpose(0, 2, 3, 1)[:, :, :l].view(np.uint8)
        # compare the WHOLE zero-initialized buffers, not just the tail
        # region: a stray native store past 2*l*t bytes per row would be
        # masked in production (head/side overwrite it) — only this test
        # can see an overrun
        assert np.array_equal(bn, bp), (s, t, l)
    # contract violations fall back (return False), never reach C with
    # wrong strides
    bad = rng.integers(-128, 128, size=(2, 16, 1000)).astype(np.int8)
    assert not pack_fused_tail(bad, np.zeros((2, 99999), np.uint8), 464)
    good = rng.integers(-128, 128, size=(2, 16, 1024)).astype(np.int8)
    assert not pack_fused_tail(good, np.zeros((2, 99999), np.uint8), 600)
