"""Multi-stream corpus decoding: N files -> batched granule decode on a mesh.

The host parses each stream serially (its bitstream is inherently
sequential), interleaving streams into fixed [S, T] granule chunks; the
device decodes all streams of a chunk in one sharded call. Ragged stream
lengths are handled by per-stream `valid` counts (shorter streams pad).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..bitstream import Source
from ..bitstream.parser import FrameReader
from ..consts import (
    SAMPLES_PER_GR,
    EOFError_,
    SyncSearchLimitError,
    UnexpectedEOFError,
)
from ..models.pipeline import GranuleMeta, granules_from_frame, pack_granule_batch
from ..ops.granule import GranuleBatch, decode_chunk_batch
from .mesh import init_states


def parse_stream_granules(data: bytes, limit: int | None = None) -> list[GranuleMeta]:
    """Parse a whole MP3 byte stream into granule metadata records."""
    src = Source(io.BytesIO(data))
    src.skip_tags()
    fr = FrameReader()
    out: list[GranuleMeta] = []
    while limit is None or len(out) < limit:
        try:
            f = fr.read(src, src.pos)
        except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
            break
        out.extend(granules_from_frame(f))
    return out


class _MonoSplitMismatch(Exception):
    """A lane classified mono (first frame) produced a stereo granule
    mid-stream — the half-width mono wire layout cannot carry it, so the
    corpus re-runs with the universal stereo layout."""


@dataclass
class CorpusResult:
    pcm: list[bytes]  # per-stream s16le stereo PCM
    granules: int  # total granules decoded
    samples: int  # total output samples (per channel)


def build_fused_chunk(
    spectra: np.ndarray,
    head: np.ndarray,
    side: np.ndarray,
    tail_lines: int = 512,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Pack one parsed chunk (pool arrays tail8 [S,T,1024] i8, head16
    [S,T,128] i16, side8 [S,T,168] u8) into the fused one-transfer buffer
    [S, stream_bytes] u8 (ops.granule.unpack_fused layout): per stream, the
    CHANNEL-MAJOR LINE-MAJOR int8 tail [2, tail_lines, T], then the head
    plane's LE bytes, then the sidecar. tail_lines < 512 caps the shipped
    tail at that per-channel line count — the caller must have verified
    every granule of the chunk is zero past the cap (see tail_cap_lines)."""
    from ..consts import HEAD_WIDTH, SIDE8_WIDTH
    from ..ops.granule import fused_stream_nbytes

    from ..native.lib import pack_fused_tail

    s, t = spectra.shape[:2]
    a = 2 * tail_lines * t
    b = a + t * 2 * HEAD_WIDTH
    buf = out
    if buf is None:
        buf = np.empty((s, fused_stream_nbytes(t, tail_lines)), np.uint8)
    # [S,T,1024] -> [S,T,2,512] -> [S,2,lines,T] prefix slice. The native
    # 16x16-blocked transpose is ~5x numpy's strided assignment here
    # (dest-order iteration cache-misses every source element); the numpy
    # path remains as the no-native fallback and the equality oracle
    # (tests pin both byte-identical).
    if not pack_fused_tail(spectra, buf, tail_lines):
        buf[:, :a].reshape(s, 2, tail_lines, t)[:] = spectra.reshape(
            s, t, 2, 512
        ).transpose(0, 2, 3, 1)[:, :, :tail_lines].view(np.uint8)
    buf[:, a:b].reshape(s, t, HEAD_WIDTH, 2)[:] = head.view(np.uint8).reshape(
        s, t, HEAD_WIDTH, 2
    )
    buf[:, b:].reshape(s, t, SIDE8_WIDTH)[:] = side
    return buf


def build_fused_chunk_mono(
    spectra: np.ndarray,
    head: np.ndarray,
    side: np.ndarray,
    tail_lines: int = 512,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """build_fused_chunk for MONO lanes: only the channel-0 planes ship
    ([S, mono_stream_bytes], ops.granule.unpack_fused_mono layout — ch1 is
    all-zero by the parser's mono contract and is reconstructed on
    device). The caller must have verified every granule of the chunk has
    the mono meta bit set (decode_corpus_fast does, falling back to the
    unsplit layout otherwise)."""
    from ..consts import HEAD_LINES, SIDE8_WIDTH
    from ..native.lib import pack_fused_tail
    from ..ops.granule import fused_stream_nbytes_mono

    s, t = spectra.shape[:2]
    a = tail_lines * t
    b = a + t * 2 * HEAD_LINES
    buf = out
    if buf is None:
        buf = np.empty((s, fused_stream_nbytes_mono(t, tail_lines)), np.uint8)
    if not pack_fused_tail(spectra, buf, tail_lines, nch=1):
        buf[:, :a].reshape(s, tail_lines, t)[:] = spectra.reshape(
            s, t, 2, 512
        )[:, :, 0].transpose(0, 2, 1)[:, :tail_lines].view(np.uint8)
    buf[:, a:b].reshape(s, t, HEAD_LINES, 2)[:] = head.view(
        np.uint8
    ).reshape(s, t, 2 * HEAD_LINES, 2)[:, :, :HEAD_LINES]
    buf[:, b:].reshape(s, t, SIDE8_WIDTH)[:] = side
    return buf


def chunk_all_mono(side: np.ndarray, valids: np.ndarray) -> bool:
    """True iff every VALID granule of the chunk has the mono meta bit
    set (sidecar meta word 1 bit 2; padding rows are zeroed and excluded
    via the per-lane valid counts)."""
    for s in range(side.shape[0]):
        v = int(valids[s])
        if v and not (side[s, :v, 2] & 4).all():
            return False
    return True


def tail_need_lines(spectra: np.ndarray) -> int:
    """Exact per-channel tail-line extent of the chunk: the number of
    leading tail lines covering every nonzero line (spectra [S,T,1024] i8,
    per-granule [2ch, 512]). Scans the POST-reorder spectra — the ground
    truth; a count1-derived bound is NOT equivalent (count1 is a
    pre-reorder boundary and the short-block permutation can move nonzero
    lines above it; a count1-based helper was deleted round 5 for exactly
    that reason, see round-4 review finding)."""
    nz = spectra.reshape(-1, 2, 512).any(axis=(0, 1))
    idx = np.nonzero(nz)[0]
    return int(idx.max()) + 1 if idx.size else 0


def bucket_tail_lines(need: int, buckets=(448, 512)) -> int:
    """Smallest bucketed width >= need; each distinct width implies one
    compiled program variant, hence the bucketing. 512 (full) is always a
    legal answer; buckets past the 512-line tail are invalid."""
    for w in buckets:
        if need <= w <= 512:
            return w
    return 512


def tail_cap_lines(spectra: np.ndarray, buckets=(448, 512)) -> int:
    """Smallest bucketed per-channel tail-line count covering every
    nonzero line of the chunk — bucket_tail_lines(tail_need_lines(...)).
    This spectra scan is what the production fused path uses (exact by
    construction)."""
    return bucket_tail_lines(tail_need_lines(spectra), buckets)


def _drained_result(n_chunks, k, run_segment, valids, emit, n_streams):
    """Shared drain pipeline: segment the corpus through a k-chunk
    compiled scan and fetch each segment's PCM while the NEXT segment
    computes (the device works under the blocking host-side np.asarray of
    the previous segment). run_segment(seg, v_seg) executes the scan for
    chunk slice `seg` (padding to k chunks itself) and returns the device
    PCM (an array, or a tuple of per-lane-group arrays on the fused
    path); both the fused and three-array paths plug in here so the
    pipelining/padding/emit logic exists once.

    INVARIANT: at most ONE segment is pending (dispatched but not yet
    fetched) at a time — segment N's PCM is fetched before segment N+2
    is dispatched. The fused path's double-buffered host upload stacks
    rely on exactly this depth (segment N+2 reuses segment N's buffer,
    safe only because N's transfers completed before its fetch
    returned); deepen the pipelining here and those buffers must grow
    to match."""
    import jax

    parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    pending = None  # (pcms on device, valids of that segment)
    for lo in range(0, n_chunks, k):
        seg = slice(lo, min(lo + k, n_chunks))
        v_seg = np.zeros((k, n_streams), np.int32)
        v_seg[: seg.stop - seg.start] = valids[seg]
        pcms_dev = run_segment(seg, v_seg)
        if pending is not None:
            emit(parts, jax.tree_util.tree_map(np.asarray, pending[0]),
                 pending[1])
        pending = (pcms_dev, v_seg)
    if pending is not None:
        emit(parts, jax.tree_util.tree_map(np.asarray, pending[0]),
             pending[1])
    total = int(valids.sum())
    return CorpusResult(
        pcm=[b"".join(p) for p in parts],
        granules=total,
        samples=total * SAMPLES_PER_GR,
    )


def decode_corpus_fast(
    stream_bytes: list[bytes],
    chunk_t: int = 256,
    fetch: bool = True,
    mesh=None,
    drain: int | None = None,
    fused: bool = True,
    tail_buckets: tuple[int, ...] | None = None,
    n_threads: int = 1,
    mono_split: bool = True,
):
    """High-throughput corpus decode: the production pipeline.

    C++ packed parse (gmp_parse_packed8: int8 tail spectra + exact int16
    head plane + byte sidecar — the minimal-byte device interface) ->
    asynchronous line-major uploads -> ONE jitted lax.scan over all chunks
    with the DSP state as carry (amortizes per-execute dispatch latency).

    This is the same pipeline bench.py measures; `decode_corpus` below
    keeps the pure-Python parse for auditability.

    Returns CorpusResult when fetch=True (PCM pulled to host); pass
    fetch=False to keep the PCM on device and get (pcms [C,S,chunk_t*576,2]
    int16 jax.Array, valids [C,S] np.ndarray) for on-device consumption.

    Falls back to the int16 packed interface if a (pathological) stream
    clips the int8 tail plane (|value| > 127 past per-channel line 64).

    drain: segment size in chunks. By default the whole corpus's PCM
    ([C, S, chunk_t*576, 2] int16) lives in device memory until fetched —
    ~45 MB per chunk at the default shapes, capping corpus length by HBM.
    With drain=k the corpus decodes in segments of k chunks through ONE
    compiled k-chunk scan (DSP state carried across segments), each
    segment's PCM is fetched while the NEXT segment computes, and each
    segment's INPUT buffers are packed + uploaded only when its turn
    comes (the host keeps the parsed pool chunks) — device memory stays
    O(k) for inputs and outputs alike, flat in corpus length. Requires
    fetch=True.

    Pass a jax.sharding.Mesh (1-D, axis 'streams' — see mesh.make_mesh) to
    shard the stream axis across chips: streams are independent, so the
    whole scan partitions with zero cross-device communication. len(streams)
    must then divide evenly by the mesh size.

    fused=True (default) ships each chunk as ONE [S, stream_bytes] uint8
    buffer (build_fused_chunk) instead of three arrays — one transfer
    dispatch per chunk instead of three. fused=False keeps the three-array
    interface (kept for A/B measurement and as the documented layout).

    tail_buckets: optional ascending per-channel tail-line widths (e.g.
    (448, 512)); each fused chunk then ships only up to the smallest
    bucket covering its nonzero lines, determined by SCANNING the parsed
    spectra (tail_cap_lines) so exactness is unconditional. One scan
    program is compiled per distinct per-corpus width TUPLE. In drain
    mode the cap is CORPUS-GLOBAL (the bucketed max extent over all
    chunks): every segment then runs the same single compiled program —
    capping stays active in the memory-bounded production mode without
    the |buckets|^drain compile explosion per-segment tuples would
    cause. None = always full width.

    n_threads: parse the (independent) streams with a pool of k worker
    threads, each owning a fixed disjoint lane subset — SURVEY section 7(b)
    "many independent streams parsed in parallel threads". The C parser
    calls drop the GIL and each lane's parser/output rows are touched by
    exactly one worker, so output is byte-identical to serial (tested with
    k=2). Fused path only.

    mono_split=True (default) ships lanes whose FIRST frame is mono with
    a half-width wire layout (only the channel-0 planes; ch1 of a mono
    granule is all-zero by the parser's contract and is reconstructed on
    device — exactness is structural). Lanes are grouped internally
    (stereo first), each group decodes separately (no device-side
    concat), and the PCM list is mapped back to the caller's order (with
    fetch=False, via one device-side gather). Every chunk is verified
    against the sidecar mono bits; a stereo granule appearing mid-stream
    in a "mono" lane re-runs the corpus with the universal layout. Under
    a mesh the split stays active when each lane group's size divides
    the mesh evenly (both groups then shard zero-collective) and the PCM
    is fetched; otherwise it falls back to the universal layout. Fused
    path only.
    """
    import jax
    import jax.numpy as jnp

    from ..native.lib import (
        HEAD_WIDTH,
        SIDE8_WIDTH,
        SIDE_WIDTH,
        SP8_TAIL_WIDTH,
        NativeParser,
    )
    from ..ops.granule import decode_chunk_packed8_impl, decode_chunk_packed_impl

    n_streams = len(stream_bytes)
    if n_streams == 0:
        return CorpusResult(pcm=[], granules=0, samples=0)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .mesh import STREAM_AXIS

        def put_streamwise(a, axis):
            spec = [None] * a.ndim
            spec[axis] = STREAM_AXIS
            return jax.device_put(a, NamedSharding(mesh, P(*spec)))
    else:
        def put_streamwise(a, axis):
            return jax.device_put(a)

    def parse_all(int8: bool):
        parsers = [NativeParser(d) for d in stream_bytes]
        if int8:
            sp8 = np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8)
            head = np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16)
            side = np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8)
        else:
            sp16 = np.empty((n_streams, chunk_t, 1152), np.int16)
            side16 = np.empty((n_streams, chunk_t, SIDE_WIDTH), np.int16)
        sp_chunks, aux_chunks, valid_rows = [], [], []
        try:
            while True:
                valids = np.zeros(n_streams, np.int32)
                for s, p in enumerate(parsers):
                    if int8:
                        n = p.parse_packed8_into(sp8[s], head[s], side[s])
                    else:
                        n = p.parse_packed_into(sp16[s], side16[s])
                    valids[s] = n
                    if n < chunk_t:
                        if int8:
                            sp8[s, n:] = 0
                            head[s, n:] = 0
                            side[s, n:] = 0
                        else:
                            sp16[s, n:] = 0
                            side16[s, n:] = 0
                if not valids.any():
                    break
                sp = sp8 if int8 else sp16
                # line-major for the transfer; re-transposed on device
                sp_chunks.append(
                    put_streamwise(
                        np.ascontiguousarray(sp.transpose(0, 2, 1)), 0
                    )
                )
                aux_chunks.append(
                    (head.copy(), side.copy()) if int8 else (side16.copy(),)
                )
                valid_rows.append(valids.copy())
        finally:
            for p in parsers:
                p.close()
        return sp_chunks, aux_chunks, valid_rows

    def emit(parts, host, valids_seg):
        for c in range(valids_seg.shape[0]):
            for s in range(n_streams):
                v = int(valids_seg[c, s])
                if v:
                    parts[s].append(
                        host[c, s, : v * SAMPLES_PER_GR].tobytes()
                    )

    def _mono_first_frame(data: bytes) -> bool:
        import io as _io

        from ..bitstream import Source, read_header
        from ..bitstream.frameheader import Mode

        try:
            src = Source(_io.BytesIO(data))
            src.skip_tags()
            h, _ = read_header(src, src.pos)
            return h.mode == Mode.SINGLE_CHANNEL
        except Exception:
            return False  # unclassifiable -> stereo layout (safe superset)

    def pack_groups(sp8, head, side, group_bounds, ws):
        """Pool chunk -> per-group fused device buffers at widths ws."""
        bufs = []
        for (lo, hi, nch), w in zip(group_bounds, ws):
            build = build_fused_chunk if nch == 2 else build_fused_chunk_mono
            bufs.append(
                put_streamwise(
                    build(sp8[lo:hi], head[lo:hi], side[lo:hi], w), 0
                )
            )
        return tuple(bufs)

    def parse_all_fused(streams, group_bounds, defer_pack):
        """Parse `streams` (internal lane order) into fused chunks.

        group_bounds: ((lo, hi, nch), ...) lane groups — nch=2 ships the
        stereo layout, nch=1 the half-width mono layout (verified per
        chunk against the sidecar mono bits; a stereo granule in a mono
        group raises _MonoSplitMismatch and the caller re-runs unsplit).

        defer_pack=False: each chunk is packed at its own bucketed width
        and device_put immediately (uploads ride under the remaining
        parse) -> (buf_chunks, widths, valid_rows).
        defer_pack=True (drain mode): HOST copies of the pool arrays are
        kept with each chunk's exact per-group extents; the caller packs
        per segment at corpus-global widths, so device input memory stays
        O(drain) and ONE scan program serves every segment ->
        (pool_chunks, needs, valid_rows)."""
        from ..native.lib import BatchParser

        batch = BatchParser(streams)
        sp8 = np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8)
        head = np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16)
        side = np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8)
        chunk_store, meta_rows, valid_rows = [], [], []

        executor = None
        lane_blocks = None
        if n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            k = min(n_threads, n_streams)
            executor = ThreadPoolExecutor(max_workers=k)
            # contiguous disjoint lane blocks: each worker owns its
            # parsers and its rows of the pool arrays for the whole run,
            # and makes ONE C call per chunk for its block (the same
            # many-call batching the serial path uses)
            bounds = [round(i * n_streams / k) for i in range(k + 1)]
            lane_blocks = [
                (bounds[i], bounds[i + 1]) for i in range(k)
            ]

        def parse_block(lo, hi, valids):
            batch.parse_chunk_into(sp8, head, side, valids, lo=lo, hi=hi)

        try:
            while True:
                valids = np.zeros(n_streams, np.int32)
                if executor is not None:
                    futs = [
                        executor.submit(parse_block, lo, hi, valids)
                        for lo, hi in lane_blocks
                    ]
                    for f in futs:
                        f.result()  # re-raises worker exceptions
                else:
                    # serial path: one C call for the whole [S, T] chunk
                    batch.parse_chunk_into(sp8, head, side, valids)
                if not valids.any():
                    break
                for lo, hi, nch in group_bounds:
                    if nch == 1 and not chunk_all_mono(
                        side[lo:hi], valids[lo:hi]
                    ):
                        raise _MonoSplitMismatch()
                # spectra-scan extents (tail_need_lines) — the exact
                # ground truth, so capped exactness is unconditional
                # (count1-based capping is NOT safe: count1 is a
                # pre-reorder boundary, round-4 review finding)
                if defer_pack:
                    chunk_store.append(
                        (sp8.copy(), head.copy(), side.copy())
                    )
                    meta_rows.append(
                        tuple(
                            tail_need_lines(sp8[lo:hi])
                            for lo, hi, _ in group_bounds
                        )
                    )
                else:
                    ws = tuple(
                        tail_cap_lines(sp8[lo:hi], tail_buckets)
                        if tail_buckets
                        else 512
                        for lo, hi, _ in group_bounds
                    )
                    chunk_store.append(
                        pack_groups(sp8, head, side, group_bounds, ws)
                    )
                    meta_rows.append(ws)
                valid_rows.append(valids.copy())
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
            batch.close()
        return chunk_store, meta_rows, valid_rows

    def run_fused(split: bool):
        # lane grouping: with the split active, streams are processed in
        # INTERNAL order (stereo lanes first, then mono) and the PCM list
        # is mapped back to the caller's order at the end. Each lane
        # group decodes separately (no device-side concat), so under a
        # mesh both groups shard zero-collective — provided each group's
        # size divides the mesh evenly (otherwise fall back unsplit).
        n_stereo = None
        order = list(range(n_streams))
        if split:
            flags = [_mono_first_frame(d) for d in stream_bytes]
            ns = sum(1 for f in flags if not f)
            # Under a mesh each lane group shards on its own. The host can
            # re-join the groups in caller order (fetch=True); the cards
            # cannot without moving PCM between them, so a device-resident
            # result keeps the universal layout there.
            mesh_ok = mesh is None or (
                (fetch or mesh.size == 1)
                and ns % mesh.size == 0
                and (n_streams - ns) % mesh.size == 0
            )
            if any(flags) and mesh_ok:
                order = [i for i, f in enumerate(flags) if not f] + [
                    i for i, f in enumerate(flags) if f
                ]
                n_stereo = ns
        streams_internal = [stream_bytes[i] for i in order]

        group_bounds = (
            ((0, n_streams, 2),)
            if n_stereo is None
            else tuple(
                g
                for g in (
                    (0, n_stereo, 2),
                    (n_stereo, n_streams, 1),
                )
                if g[1] > g[0]
            )
        )
        defer_pack = drain is not None and fetch
        chunk_store, meta_rows, valid_rows = parse_all_fused(
            streams_internal, group_bounds, defer_pack
        )
        if not chunk_store:
            return CorpusResult(pcm=[b""] * n_streams, granules=0,
                                samples=0)
        valids = np.stack(valid_rows)  # [C, S] (internal order)

        def group_states():
            sts = []
            for lo, hi, _ in group_bounds:
                st = init_states(hi - lo)
                if mesh is not None:
                    st = jax.tree_util.tree_map(
                        lambda a: put_streamwise(a, 0), st
                    )
                sts.append(st)
            return tuple(sts)

        def group_valids(v):  # [k, S] -> per-group tuple
            return tuple(v[:, lo:hi] for lo, hi, _ in group_bounds)

        import functools

        # one compiled scan per distinct per-corpus width-tuple sequence
        # (tail_buckets bounds the variants; None -> all 512, one
        # program; drain mode passes one corpus-global tuple -> one
        # program regardless of corpus length)
        @functools.lru_cache(maxsize=None)
        def scan_for(seg_widths: tuple[tuple[int, ...], ...]):
            from ..ops.granule import unpack_fused, unpack_fused_mono

            @jax.jit
            def scan_fused(bufs, sts, vls):
                xs = []
                for gi, (lo, hi, nch) in enumerate(group_bounds):
                    unpack = (
                        unpack_fused if nch == 2 else unpack_fused_mono
                    )
                    parts = [
                        unpack(cb[gi], chunk_t, ws[gi])
                        for cb, ws in zip(bufs, seg_widths)
                    ]
                    xs.append(
                        (
                            jnp.stack([p[0] for p in parts]),
                            jnp.stack([p[1] for p in parts]),
                            jnp.stack([p[2] for p in parts]),
                            vls[gi],
                        )
                    )

                def step(st_t, x_t):
                    new_sts, pcms = [], []
                    for st, (ta, he, si, v) in zip(st_t, x_t):
                        pcm, st = jax.vmap(decode_chunk_packed8_impl)(
                            ta, he, si, st, v
                        )
                        new_sts.append(st)
                        pcms.append(pcm)
                    return tuple(new_sts), tuple(pcms)

                sts_out, pcms = jax.lax.scan(step, sts, tuple(xs))
                return pcms, sts_out

            return scan_fused

        def emit_groups(parts, hosts, valids_seg):
            # hosts: per-group [k, S_g, t*576, 2]; valids_seg [k, S]
            for h, (lo, hi, _) in zip(hosts, group_bounds):
                for c in range(valids_seg.shape[0]):
                    for s in range(lo, hi):
                        v = int(valids_seg[c, s])
                        if v:
                            parts[s].append(
                                h[c, s - lo, : v * SAMPLES_PER_GR]
                                .tobytes()
                            )

        def reorder_result(res: CorpusResult) -> CorpusResult:
            if order == list(range(n_streams)):
                return res
            pcm = [b""] * n_streams
            for internal, orig in enumerate(order):
                pcm[orig] = res.pcm[internal]
            return CorpusResult(
                pcm=pcm, granules=res.granules, samples=res.samples
            )

        states = group_states()
        n_chunks = len(chunk_store)
        if defer_pack:
            k = min(drain, n_chunks)
            # corpus-global width per group (max exact extent over all
            # chunks, bucketed): every segment runs the SAME compiled
            # program, so tail capping stays active in the memory-bounded
            # drain mode (round-4 verdict item)
            w_g = tuple(
                bucket_tail_lines(
                    max(n[gi] for n in meta_rows), tail_buckets
                )
                if tail_buckets
                else 512
                for gi in range(len(group_bounds))
            )
            from ..ops.granule import (
                fused_stream_nbytes,
                fused_stream_nbytes_mono,
            )

            # stacked per-segment host buffers: ONE device_put per group
            # per segment (measured 20-30% faster than per-chunk puts
            # through a congested link, parity otherwise) and O(drain)
            # device input memory. Double-buffered because device_put is
            # async: segment N+1 must not overwrite the host stack while
            # segment N's transfer may still be in flight.
            def alloc_stacks():
                return tuple(
                    np.zeros(
                        (
                            k,
                            hi - lo,
                            fused_stream_nbytes(chunk_t, w)
                            if nch == 2
                            else fused_stream_nbytes_mono(chunk_t, w),
                        ),
                        np.uint8,
                    )
                    for (lo, hi, nch), w in zip(group_bounds, w_g)
                )

            stacks_ab = (alloc_stacks(), alloc_stacks())
            seg_idx = 0

            @jax.jit
            def scan_stacked(stacked, sts, vls):
                bufs = [tuple(g[c] for g in stacked) for c in range(k)]
                return scan_for((w_g,) * k)(bufs, sts, vls)

            def run_segment(seg, v_seg):
                nonlocal states, seg_idx
                # pack + upload THIS segment only: device input memory
                # stays O(drain) (host keeps the parsed pool chunks)
                stacks = stacks_ab[seg_idx % 2]
                seg_idx += 1
                n_seg = seg.stop - seg.start
                if n_seg < k:  # zero the padding chunks' stale rows
                    for g in stacks:
                        g[n_seg:] = 0
                for i, (sp8c, headc, sidec) in enumerate(chunk_store[seg]):
                    for gi, ((lo, hi, nch), w) in enumerate(
                        zip(group_bounds, w_g)
                    ):
                        build = (
                            build_fused_chunk
                            if nch == 2
                            else build_fused_chunk_mono
                        )
                        build(
                            sp8c[lo:hi], headc[lo:hi], sidec[lo:hi], w,
                            out=stacks[gi][i],
                        )
                stacked_dev = tuple(put_streamwise(g, 1) for g in stacks)
                pcms_dev, states = scan_stacked(
                    stacked_dev, states, group_valids(v_seg)
                )
                return pcms_dev

            return reorder_result(
                _drained_result(
                    n_chunks, k, run_segment, valids, emit_groups,
                    n_streams,
                )
            )

        pcms, _ = scan_for(tuple(meta_rows))(
            chunk_store, states, group_valids(valids)
        )
        if not fetch:
            # device-resident result in CALLER order: concatenate the
            # lane groups and invert the internal regrouping with one
            # device-side take (no-op when no split happened)
            pcm_all = (
                pcms[0]
                if len(pcms) == 1
                else jnp.concatenate(pcms, axis=1)
            )
            if order != list(range(n_streams)):
                inv = np.argsort(np.asarray(order))
                pcm_all = jnp.take(pcm_all, jnp.asarray(inv), axis=1)
                return pcm_all, valids[:, inv]
            return pcm_all, valids
        hosts = [np.asarray(p) for p in pcms]
        parts = [[] for _ in range(n_streams)]
        emit_groups(parts, hosts, valids)
        total = int(valids.sum())
        return reorder_result(
            CorpusResult(
                pcm=[b"".join(p) for p in parts],
                granules=total,
                samples=total * SAMPLES_PER_GR,
            )
        )

    if fused:
        try:
            split = mono_split and n_streams > 0
            try:
                return run_fused(split)
            except _MonoSplitMismatch:
                # a "mono" lane produced a stereo granule mid-stream:
                # re-run with the universal stereo layout
                return run_fused(False)
        except OverflowError:
            int8 = False
            sp_chunks, aux_chunks, valid_rows = parse_all(int8=False)
    else:
        try:
            int8 = True
            sp_chunks, aux_chunks, valid_rows = parse_all(int8=True)
        except OverflowError:
            int8 = False
            sp_chunks, aux_chunks, valid_rows = parse_all(int8=False)

    if not sp_chunks:
        return CorpusResult(pcm=[b""] * n_streams, granules=0, samples=0)

    valids = np.stack(valid_rows)  # [C, S]
    states = init_states(n_streams)
    if mesh is not None:
        states = jax.tree_util.tree_map(lambda a: put_streamwise(a, 0), states)

    if int8:
        chunk_impl = decode_chunk_packed8_impl
        aux_all = tuple(
            put_streamwise(np.stack([a[i] for a in aux_chunks]), 1)
            for i in range(2)
        )
    else:
        chunk_impl = decode_chunk_packed_impl
        aux_all = (
            put_streamwise(np.stack([a[0] for a in aux_chunks]), 1),
        )
    batched = jax.vmap(chunk_impl)

    @jax.jit
    def scan_corpus(sp_chunks, aux_all, states, valids):
        sp_all = jnp.stack([jnp.swapaxes(c, 1, 2) for c in sp_chunks])

        def step(st, xs):
            sp, v = xs[0], xs[-1]
            pcm, st = batched(sp, *xs[1:-1], st, v)
            return st, pcm

        states, pcms = jax.lax.scan(
            step, states, (sp_all, *aux_all, valids)
        )
        return pcms, states

    n_chunks = len(sp_chunks)
    if drain is not None and fetch and drain < n_chunks:
        k = drain
        pad_sp = jnp.zeros_like(sp_chunks[0])
        pad_aux = tuple(jnp.zeros_like(a[0]) for a in aux_all)

        def run_segment(seg, v_seg):
            nonlocal states
            n_pad = k - (seg.stop - seg.start)
            sp_seg = sp_chunks[seg] + [pad_sp] * n_pad
            aux_seg = tuple(
                jnp.concatenate(
                    [a[seg]] + [p[None]] * n_pad, axis=0
                ) if n_pad else a[seg]
                for a, p in zip(aux_all, pad_aux)
            )
            pcms_dev, states = scan_corpus(sp_seg, aux_seg, states, v_seg)
            return pcms_dev

        return _drained_result(
            n_chunks, k, run_segment, valids, emit, n_streams
        )

    pcms, _ = scan_corpus(sp_chunks, aux_all, states, valids)
    if not fetch:
        return pcms, valids

    host = np.asarray(pcms)  # [C, S, chunk_t*576, 2]
    parts = [[] for _ in range(n_streams)]
    emit(parts, host, valids)
    total = int(valids.sum())
    return CorpusResult(
        pcm=[b"".join(p) for p in parts],
        granules=total,
        samples=total * SAMPLES_PER_GR,
    )


def decode_corpus(
    streams: list[list[GranuleMeta]],
    chunk_t: int = 128,
    decode_fn=None,
) -> CorpusResult:
    """Decode pre-parsed streams with the batched device path.

    decode_fn defaults to the single-host vmapped decoder
    (ops.granule.decode_chunk_batch); pass the result of
    mesh.make_sharded_decoder(mesh) to spread streams across chips.
    """
    if decode_fn is None:
        decode_fn = decode_chunk_batch
    n_streams = len(streams)
    states = init_states(n_streams)
    pcm_parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    max_len = max(len(s) for s in streams)
    total = sum(len(s) for s in streams)

    for start in range(0, max_len, chunk_t):
        batches = []
        valids = []
        for s in streams:
            part = s[start : start + chunk_t]
            batch, valid = pack_granule_batch(part, pad_to=chunk_t)
            batches.append(batch)
            valids.append(valid)
        stacked = GranuleBatch(
            *[np.stack([getattr(b, f) for b in batches]) for f in GranuleBatch._fields]
        )
        valid_arr = np.array(valids, dtype=np.int32)
        pcm, states = decode_fn(stacked, states, valid_arr)
        pcm_host = np.asarray(pcm)
        for i, v in enumerate(valids):
            if v:
                pcm_parts[i].append(pcm_host[i, : v * SAMPLES_PER_GR].tobytes())

    return CorpusResult(
        pcm=[b"".join(p) for p in pcm_parts],
        granules=total,
        samples=total * SAMPLES_PER_GR,
    )
