"""Multi-stream batched + sharded decode on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from go_mp3_tpu.parallel.corpus import decode_corpus, parse_stream_granules
from go_mp3_tpu.parallel.mesh import make_mesh, make_sharded_decoder


@pytest.fixture(scope="module")
def small_streams(fixture_classic_lame, fixture_mpeg2):
    s1 = parse_stream_granules(fixture_classic_lame, limit=40)
    s2 = parse_stream_granules(fixture_mpeg2, limit=25)  # ragged + mono
    return [s1, s2, s1[:17], s2[:8]]


def single_stream_pcm(granules):
    from go_mp3_tpu.models.pipeline import StreamDecoder

    sd = StreamDecoder(chunk_size=16)
    sd._pending = list(granules)
    return sd.decode_pending(flush=True)


def test_batched_corpus_matches_single_stream(small_streams):
    res = decode_corpus(small_streams, chunk_t=16)
    assert res.granules == sum(len(s) for s in small_streams)
    for s, pcm in zip(small_streams, res.pcm):
        assert pcm == single_stream_pcm(s)


def test_sharded_corpus_on_mesh(small_streams):
    """Same decode, sharded across 8 virtual devices; streams padded to a
    multiple of the mesh size."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh()
    fn = make_sharded_decoder(mesh)
    streams = small_streams * 2  # 8 streams, one per device
    res = decode_corpus(streams, chunk_t=16, decode_fn=fn)
    base = decode_corpus(streams, chunk_t=16)
    assert res.pcm == base.pcm


def test_mono_stereo_mix_in_one_batch(small_streams):
    """Mono (mpeg2) and stereo (classic) streams decode correctly side by
    side in one batch: mono output has identical channels."""
    res = decode_corpus(small_streams, chunk_t=16)
    mono_pcm = np.frombuffer(res.pcm[1], dtype="<i2").reshape(-1, 2)
    assert (mono_pcm[:, 0] == mono_pcm[:, 1]).all()
    stereo_pcm = np.frombuffer(res.pcm[0], dtype="<i2").reshape(-1, 2)
    assert (stereo_pcm[:, 0] != stereo_pcm[:, 1]).any()


def test_decode_corpus_fast_matches_decoder(fixture_classic_lame, fixture_mpeg2):
    """The production fast-corpus pipeline (packed8 parse -> line-major
    uploads -> one scan) produces byte-identical PCM to the per-stream
    device Decoder, across mixed variants and ragged lengths."""
    from go_mp3_tpu import Decoder
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    streams = [
        fixture_classic_lame,
        fixture_mpeg2[:40_000],
        fixture_classic_lame[:30_000],
    ]
    result = decode_corpus_fast(streams, chunk_t=64)
    assert len(result.pcm) == 3
    for data, pcm in zip(streams, result.pcm):
        ref = Decoder(data, backend="device").read_all()
        assert pcm == ref
    assert result.granules > 0
    assert result.samples == result.granules * 576


def test_decode_corpus_fast_device_resident(fixture_classic_lame):
    """fetch=False keeps PCM on device; validity masks line up."""
    import numpy as np

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    pcms, valids = decode_corpus_fast(
        [fixture_classic_lame, fixture_classic_lame[:20_000]],
        chunk_t=64,
        fetch=False,
    )
    assert pcms.shape[0] == valids.shape[0]
    assert pcms.shape[1] == 2
    assert pcms.shape[2] == 64 * 576
    assert valids[0, 0] == 64  # full first chunk for the full stream
    assert (np.asarray(valids) >= 0).all()


def test_decode_corpus_fast_sharded_matches_unsharded(fixture_classic_lame):
    """decode_corpus_fast over an 8-device mesh == single-device output."""
    import jax

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast
    from go_mp3_tpu.parallel.mesh import make_mesh

    streams = [fixture_classic_lame[:30_000]] * len(jax.devices())
    ref = decode_corpus_fast(streams, chunk_t=32)
    sharded = decode_corpus_fast(streams, chunk_t=32, mesh=make_mesh())
    assert sharded.pcm == ref.pcm
    # chunked drain composes with mesh sharding (state/PCM stay sharded)
    drained = decode_corpus_fast(
        streams, chunk_t=32, mesh=make_mesh(), drain=2
    )
    assert drained.pcm == ref.pcm


def test_decode_corpus_fast_chunked_drain(fixture_classic_lame, fixture_mpeg2):
    """drain=k segments the corpus through one k-chunk compiled scan and
    fetches each segment while the next computes: byte-identical output to
    the whole-corpus scan (incl. the zero-padded final segment), with
    device-resident PCM bounded at O(k) instead of O(corpus)."""
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    streams = [fixture_classic_lame * 2, fixture_mpeg2[: len(fixture_mpeg2) // 2]]
    ref = decode_corpus_fast(streams, chunk_t=64)
    got = decode_corpus_fast(streams, chunk_t=64, drain=4)
    assert got.granules == ref.granules
    assert got.pcm == ref.pcm

    # a 4x-longer corpus decodes through the same k-chunk program
    streams4 = [fixture_classic_lame * 8, fixture_mpeg2]
    ref4 = decode_corpus_fast(streams4, chunk_t=64)
    got4 = decode_corpus_fast(streams4, chunk_t=64, drain=4)
    assert got4.pcm == ref4.pcm


def test_decode_corpus_fast_escape_overflow_fallback():
    """A stream whose granules clip the int8 tail plane (lines 64..79
    carry |x| > 127, hand-built via Huffman table 23 linbits escapes) must
    fall back to the int16 packed interface and still produce
    byte-identical PCM to the per-stream device Decoder."""
    from util_synth import escape_heavy_frame

    from go_mp3_tpu import Decoder
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    data = escape_heavy_frame() * 3
    result = decode_corpus_fast([data], chunk_t=16)
    ref = Decoder(data, backend="device").read_all()
    assert result.pcm[0] == ref
    assert result.granules == 6


def test_decode_corpus_fast_fused_matches_unfused(
    fixture_classic_lame, fixture_mpeg2
):
    """The fused one-buffer-per-chunk transfer layout (and its bucketed
    tail-line capping) is byte-identical to the three-array interface,
    including ragged lengths and aggressive caps that force zero-padding
    of most of the tail plane."""
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    streams = [
        fixture_classic_lame,
        fixture_mpeg2[:40_000],
        fixture_classic_lame[:30_000],
    ]
    ref = decode_corpus_fast(streams, chunk_t=64, fused=False)
    got = decode_corpus_fast(streams, chunk_t=64)  # fused default
    assert got.pcm == ref.pcm and got.granules == ref.granules
    capped = decode_corpus_fast(
        streams, chunk_t=64, tail_buckets=(64, 192, 448, 512)
    )
    assert capped.pcm == ref.pcm


def test_tail_cap_lines_buckets():
    """tail_cap_lines picks the smallest bucket covering all nonzero
    lines, and build_fused_chunk's capped emission round-trips exactly."""
    import numpy as np

    from go_mp3_tpu.parallel.corpus import tail_cap_lines

    sp = np.zeros((2, 4, 1024), np.int8)
    assert tail_cap_lines(sp, (64, 448, 512)) == 64
    sp.reshape(2, 4, 2, 512)[1, 2, 1, 300] = 5  # line 300 of ch1
    assert tail_cap_lines(sp, (64, 448, 512)) == 448
    sp.reshape(2, 4, 2, 512)[0, 0, 0, 460] = -3
    assert tail_cap_lines(sp, (64, 448, 512)) == 512


def test_tail_need_and_bucket_helpers():
    """tail_need_lines is the exact nonzero extent; bucket_tail_lines maps
    it to the smallest legal compiled-width bucket."""
    import numpy as np

    from go_mp3_tpu.parallel.corpus import (
        bucket_tail_lines,
        tail_need_lines,
    )

    sp = np.zeros((2, 4, 1024), np.int8)
    assert tail_need_lines(sp) == 0
    sp.reshape(2, 4, 2, 512)[1, 2, 1, 300] = 5
    assert tail_need_lines(sp) == 301
    assert bucket_tail_lines(301, (64, 448, 512)) == 448
    assert bucket_tail_lines(513, (64, 448, 512)) == 512  # over-need: full
    assert bucket_tail_lines(0, (600,)) == 512  # invalid bucket ignored


def test_decode_corpus_fast_threaded_parse_identical(
    fixture_classic_lame, fixture_mpeg2
):
    """n_threads=2 (disjoint lane subsets, GIL-free C parser calls) is
    byte-identical to the serial parse — the SURVEY section 7(b) threaded
    fleet-parse capability (correctness only; speed is not measured
    here)."""
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    streams = [
        fixture_classic_lame,
        fixture_mpeg2[:60_000],
        fixture_classic_lame[:30_000],
        fixture_mpeg2[:25_000],
    ]
    ref = decode_corpus_fast(streams, chunk_t=64)
    got = decode_corpus_fast(streams, chunk_t=64, n_threads=2)
    assert got.pcm == ref.pcm and got.granules == ref.granules
    got3 = decode_corpus_fast(streams, chunk_t=64, n_threads=3)
    assert got3.pcm == ref.pcm


def test_mono_split_wire_layout(fixture_classic_lame, fixture_mpeg2):
    """Mono lanes ship the half-width wire layout (channel-0 planes only);
    output is byte-identical to the unsplit layout and to the per-stream
    Decoder, including INTERLEAVED mono/stereo lane order (the internal
    regrouping must map PCM back to the caller's order)."""
    from go_mp3_tpu import Decoder
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    # interleaved: mono, stereo, mono, stereo
    streams = [
        fixture_mpeg2[:60_000],
        fixture_classic_lame,
        fixture_mpeg2[:25_000],
        fixture_classic_lame[:30_000],
    ]
    ref = decode_corpus_fast(streams, chunk_t=64, mono_split=False)
    got = decode_corpus_fast(streams, chunk_t=64)  # mono_split default
    assert got.pcm == ref.pcm and got.granules == ref.granules
    for data, pcm in zip(streams, got.pcm):
        assert pcm == Decoder(data, backend="device").read_all()
    # with capping + threads too
    got2 = decode_corpus_fast(
        streams, chunk_t=64, tail_buckets=(448, 512), n_threads=2
    )
    assert got2.pcm == ref.pcm
    # all-mono corpus (single half-width group)
    mono_only = [fixture_mpeg2[:60_000], fixture_mpeg2[:25_000]]
    refm = decode_corpus_fast(mono_only, chunk_t=64, mono_split=False)
    gotm = decode_corpus_fast(mono_only, chunk_t=64)
    assert gotm.pcm == refm.pcm


def test_drain_with_tail_buckets_matches(
    fixture_classic_lame, fixture_mpeg2
):
    """Tail capping stays ACTIVE in drain mode via a corpus-global width
    (one compiled program for every segment): byte-identical output to
    the uncapped whole-corpus scan."""
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    streams = [
        fixture_classic_lame * 2,
        fixture_mpeg2[: len(fixture_mpeg2) // 2],
    ]
    ref = decode_corpus_fast(streams, chunk_t=64)
    got = decode_corpus_fast(
        streams, chunk_t=64, drain=4, tail_buckets=(448, 512)
    )
    assert got.granules == ref.granules
    assert got.pcm == ref.pcm
    # aggressive buckets (force small corpus-global width) too
    got2 = decode_corpus_fast(
        streams, chunk_t=64, drain=4,
        tail_buckets=(64, 192, 320, 448, 512),
    )
    assert got2.pcm == ref.pcm


def test_mono_split_on_mesh_and_device_resident(
    fixture_classic_lame, fixture_mpeg2
):
    """mono_split stays active under a mesh when each lane group divides
    the mesh evenly (per-group zero-collective sharding), and under
    fetch=False (device-resident PCM returned in CALLER order)."""
    import jax
    import numpy as np

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast
    from go_mp3_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    stereo = [fixture_classic_lame[:25_000]] * n_dev
    mono = [fixture_mpeg2[:25_000]] * n_dev
    # interleave so the internal regrouping is exercised
    streams = [s for pair in zip(mono, stereo) for s in pair]
    ref = decode_corpus_fast(streams, chunk_t=32, mono_split=False)
    got = decode_corpus_fast(
        streams, chunk_t=32, mesh=make_mesh(),
        tail_buckets=(448, 512), drain=2,
    )
    assert got.pcm == ref.pcm and got.granules == ref.granules

    # fetch=False: device-resident PCM + valids, caller lane order, on one
    # device and sharded over the mesh (where the lane groups stay joined:
    # re-joining them on the devices would move PCM between them)
    refb = [np.frombuffer(p, "<i2").reshape(-1, 2) for p in ref.pcm]
    for mesh in (None, make_mesh()):
        pcms, valids = decode_corpus_fast(
            streams, chunk_t=32, fetch=False, mesh=mesh
        )
        host = np.asarray(pcms)
        for s in range(len(streams)):
            got_s = np.concatenate(
                [
                    host[c, s, : int(valids[c, s]) * 576]
                    for c in range(host.shape[0])
                    if int(valids[c, s])
                ]
            )
            np.testing.assert_array_equal(got_s, refb[s])


def test_mono_split_mesh_indivisible_group_falls_back(
    fixture_classic_lame, fixture_mpeg2
):
    """A lane group whose size does not divide the mesh falls back to the
    universal (unsplit) layout instead of failing."""
    import jax

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast
    from go_mp3_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    # 1 mono + (n_dev - 1) stereo: total divides the mesh, groups do not
    streams = [fixture_mpeg2[:20_000]] + [
        fixture_classic_lame[:20_000]
    ] * (n_dev - 1)
    ref = decode_corpus_fast(streams, chunk_t=32, mono_split=False)
    got = decode_corpus_fast(streams, chunk_t=32, mesh=make_mesh())
    assert got.pcm == ref.pcm


def test_sharded_decode_compiles_zero_collective(
    fixture_classic_lame, fixture_mpeg2
):
    """Machine-check the zero-collective claim (SURVEY §2 item 3/4):
    the compiled sharded decode programs contain NO cross-device
    communication ops. Covers the GranuleBatch decoder and a fused
    per-group (stereo + half-width mono) scan step shaped like
    decode_corpus_fast's production program."""
    import re

    import jax
    import jax.numpy as jnp

    from jax.sharding import NamedSharding, PartitionSpec as P

    from go_mp3_tpu.ops.granule import (
        decode_chunk_packed8_impl,
        fused_stream_nbytes,
        fused_stream_nbytes_mono,
        unpack_fused,
        unpack_fused_mono,
    )
    from go_mp3_tpu.parallel.mesh import (
        STREAM_AXIS,
        init_states,
        make_mesh,
        make_sharded_decoder,
    )

    collective = re.compile(
        r"all-reduce|all-gather|all-to-all|collective-permute"
        r"|reduce-scatter|partition-id|replica-id"
    )

    def assert_no_collectives(compiled, name):
        txt = compiled.as_text()
        hits = sorted(set(collective.findall(txt)))
        assert not hits, f"{name} compiled with collectives: {hits}"

    mesh = make_mesh()
    n_dev = len(jax.devices())

    # 1) GranuleBatch sharded decoder
    fn = make_sharded_decoder(mesh)
    from __graft_entry__ import _example_inputs

    from go_mp3_tpu.ops.granule import GranuleBatch

    batch_1, _, _ = _example_inputs(4)
    stacked = GranuleBatch(
        *[jnp.stack([jnp.asarray(x)] * n_dev) for x in batch_1]
    )
    valid = jnp.full((n_dev,), 4, jnp.int32)
    lowered = fn.lower(stacked, init_states(n_dev), valid)
    assert_no_collectives(lowered.compile(), "make_sharded_decoder")

    # 2) fused per-group scan step (stereo group + half-width mono group,
    # each sharded on its own stream axis — the decode_corpus_fast shape)
    t, w = 8, 64
    s_lead = NamedSharding(mesh, P(STREAM_AXIS))
    st_states = init_states(n_dev)
    mo_states = init_states(n_dev)
    sharded_states = type(st_states)(store=s_lead, v_fifo=s_lead)

    def step(buf_st, buf_mo, sts, vls):
        outs = []
        new_sts = []
        for buf, st, v, unpack in (
            (buf_st, sts[0], vls[0], unpack_fused),
            (buf_mo, sts[1], vls[1], unpack_fused_mono),
        ):
            ta, he, sd = unpack(buf, t, w)
            pcm, st = jax.vmap(decode_chunk_packed8_impl)(
                ta, he, sd, st, v
            )
            outs.append(pcm)
            new_sts.append(st)
        return tuple(outs), tuple(new_sts)

    buf_st = jnp.zeros((n_dev, fused_stream_nbytes(t, w)), jnp.uint8)
    buf_mo = jnp.zeros((n_dev, fused_stream_nbytes_mono(t, w)), jnp.uint8)
    vls = (
        jnp.full((n_dev,), t, jnp.int32),
        jnp.full((n_dev,), t, jnp.int32),
    )
    step_sharded = jax.jit(
        step,
        in_shardings=(
            s_lead, s_lead,
            (sharded_states, sharded_states),
            (s_lead, s_lead),
        ),
        out_shardings=(
            (s_lead, s_lead),
            (sharded_states, sharded_states),
        ),
    )
    lowered = step_sharded.lower(
        buf_st, buf_mo, (st_states, mo_states), vls
    )
    assert_no_collectives(lowered.compile(), "fused per-group step")


def test_mono_split_mismatch_falls_back():
    """A lane whose FIRST frame is mono but later turns stereo cannot use
    the half-width layout; the pipeline must detect it from the sidecar
    mono bits and re-run with the universal layout, byte-identically."""
    import sys

    sys.path.insert(0, "tests")
    import util_synth as U

    from go_mp3_tpu import Decoder
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    # mono first frame, then stereo silent frames (valid MPEG-1 stream)
    tricky = U.escape_heavy_frame(
        n_pairs=8, linbit_value=500, global_gain=148
    ) + b"".join(U.silent_frame(mode=0) for _ in range(6))
    plain = b"".join(U.silent_frame(mode=0) for _ in range(8))
    streams = [plain, tricky]
    ref = decode_corpus_fast(streams, chunk_t=8, mono_split=False)
    got = decode_corpus_fast(streams, chunk_t=8)
    assert got.pcm == ref.pcm and got.granules == ref.granules
    for data, pcm in zip(streams, got.pcm):
        assert pcm == Decoder(data, backend="device").read_all()
