"""Cross-implementation parity: JAX batched DSP vs the numpy golden decoder.

The two paths are independent implementations of the same reference flow
(loop-faithful float64 vs vectorized float32), so agreement within ISO
full-compliance bounds (RMS < 0.289 LSB, maxdiff <= 2) validates both.
"""

import io

import numpy as np
import pytest

from go_mp3_tpu.bitstream import Source
from go_mp3_tpu.bitstream.parser import FrameReader
from go_mp3_tpu.consts import (
    EOFError_,
    SyncSearchLimitError,
    UnexpectedEOFError,
)
from go_mp3_tpu.models.pipeline import StreamDecoder
from go_mp3_tpu.ops.reference_dsp import GoldenDecoder

FULL_COMPLIANCE_RMS = 0.289
FULL_COMPLIANCE_MAXDIFF = 2


def parse_frames(data: bytes, nmax: int):
    src = Source(io.BytesIO(data))
    src.skip_tags()
    fr = FrameReader()
    frames = []
    while len(frames) < nmax:
        try:
            frames.append(fr.read(src, src.pos))
        except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
            break
    return frames


def compare(data: bytes, nmax: int, chunk_size: int = 64):
    frames = parse_frames(data, nmax)
    assert frames, "no frames parsed"
    gd = GoldenDecoder()
    sd = StreamDecoder(chunk_size=chunk_size)
    g_pcm = b""
    for f in frames:
        g_pcm += gd.decode_frame(f.header, f.side_info, f.main_data)
        sd.feed_frame(f)
    j_pcm = sd.decode_pending(flush=True)
    a = np.frombuffer(g_pcm, dtype="<i2").astype(np.int32)
    b = np.frombuffer(j_pcm, dtype="<i2").astype(np.int32)
    assert len(a) == len(b)
    d = np.abs(a - b)
    rms = float(np.sqrt(((a - b).astype(np.float64) ** 2).mean()))
    return d.max(), rms


def test_parity_mpeg1_stereo(fixture_classic_lame):
    maxdiff, rms = compare(fixture_classic_lame, nmax=60)
    assert maxdiff <= FULL_COMPLIANCE_MAXDIFF
    assert rms < FULL_COMPLIANCE_RMS


def test_parity_mpeg2_mono(fixture_mpeg2):
    maxdiff, rms = compare(fixture_mpeg2, nmax=120)
    assert maxdiff <= FULL_COMPLIANCE_MAXDIFF
    assert rms < FULL_COMPLIANCE_RMS


def test_chunking_invariance(fixture_classic_lame):
    """Chunk size must not change device output (state carry correctness)."""
    frames = parse_frames(fixture_classic_lame, nmax=20)
    outs = []
    for cs in (2, 7, 64):
        sd = StreamDecoder(chunk_size=cs)
        pcm = b""
        for f in frames:
            sd.feed_frame(f)
            pcm += sd.decode_pending()
        pcm += sd.decode_pending(flush=True)
        outs.append(pcm)
    assert outs[0] == outs[1] == outs[2]


def test_chunking_invariance_deep(fixture_classic_lame):
    """A granule's PCM must not depend on its row position in the chunk:
    decoding 768 granules split at arbitrary (odd, mid-frame, short-block-
    heavy) boundaries is byte-identical to uniform 128-granule chunks.
    Regression: a one-hot-matmul IMDCT window formulation broke exactly
    this (XLA fused the windowing multiply differently near the dot),
    silently desyncing streaming vs whole-file decode by 1 LSB on a
    handful of samples."""
    import jax.numpy as jnp

    import go_mp3_tpu.ops.granule as G
    from go_mp3_tpu.native.lib import SIDE_WIDTH, NativeParser

    try:
        from go_mp3_tpu.native import lib as native

        if not native.available():
            pytest.skip("native lib not built")
    except Exception:
        pytest.skip("native lib not built")

    total = 768
    sp = np.zeros((total, 1152), np.int16)
    sd = np.zeros((total, SIDE_WIDTH), np.int16)
    p = NativeParser(fixture_classic_lame)
    got = 0
    while got < total:
        n = p.parse_packed_into(sp[got:], sd[got:])
        if n == 0:
            break
        got += n
    p.close()
    assert got >= total

    import jax

    f = jax.jit(G.decode_chunk_packed_impl)
    cap = 128

    def run(cuts):
        bounds, lo = [], 0
        for hi in sorted(set(cuts) | {total}):
            while lo < hi:
                step = min(cap, hi - lo)
                bounds.append((lo, lo + step))
                lo += step
        st = G.init_state()
        out = []
        for lo_, hi_ in bounds:
            cs = np.zeros((cap, 1152), np.int16)
            cd = np.zeros((cap, SIDE_WIDTH), np.int16)
            cs[: hi_ - lo_] = sp[lo_:hi_]
            cd[: hi_ - lo_] = sd[lo_:hi_]
            pcm, st = f(jnp.asarray(cs), jnp.asarray(cd), st,
                        jnp.int32(hi_ - lo_))
            out.append(np.asarray(pcm)[: (hi_ - lo_) * 576])
        return np.concatenate(out)

    ref = run([])
    for cut in (37, 85, 168, 291, 340, 505, 699):
        got_pcm = run([cut])
        assert np.array_equal(ref, got_pcm), f"cut at granule {cut}"


def test_padding_does_not_leak(fixture_classic_lame):
    """Decoding N granules padded to a larger chunk equals unpadded decode."""
    frames = parse_frames(fixture_classic_lame, nmax=6)
    sd1 = StreamDecoder(chunk_size=12)  # exactly 6 frames * 2 granules
    sd2 = StreamDecoder(chunk_size=128)  # heavy padding
    for f in frames:
        sd1.feed_frame(f)
        sd2.feed_frame(f)
    assert sd1.decode_pending(flush=True) == sd2.decode_pending(flush=True)


def test_xing_frame_decodes_silent(reference_classic_lame):
    """Frame 0 of a LAME file is the Xing/Info header frame: pure silence."""
    frames = parse_frames(reference_classic_lame, nmax=1)
    gd = GoldenDecoder()
    pcm = gd.decode_frame(
        frames[0].header, frames[0].side_info, frames[0].main_data
    )
    assert np.frombuffer(pcm, dtype="<i2").max() == 0


def test_golden_state_is_serializable(fixture_classic_lame):
    """Decode state round-trips through plain numpy (checkpoint/resume)."""
    frames = parse_frames(fixture_classic_lame, nmax=8)
    sd = StreamDecoder(chunk_size=4)
    for f in frames[:4]:
        sd.feed_frame(f)
    first = sd.decode_pending(flush=True)

    # snapshot state, continue, then restore and re-continue
    snap = tuple(np.asarray(x).copy() for x in sd.state)
    sd_b = StreamDecoder(chunk_size=4)
    import go_mp3_tpu.ops.granule as G
    import jax.numpy as jnp

    sd_b.state = G.DecodeState(*(jnp.asarray(x) for x in snap))
    for f in frames[4:]:
        sd.feed_frame(f)
        sd_b.feed_frame(f)
    assert sd.decode_pending(flush=True) == sd_b.decode_pending(flush=True)
