#!/usr/bin/env python3
"""Benchmark: aggregate MP3 decode throughput on one GPU.

Pipeline: the native C++ parser fills three flat pool arrays per
chunk (int8 tail spectra [S,T,1024] + exact int16 head plane [S,T,128] +
byte sidecar [S,T,168] — gmp_parse_packed8), which the host packs into ONE
fused uint8 buffer per lane group per chunk ([S, stream_bytes];
channel-major line-major tail, optionally capped at the chunk's bucketed
max nonzero tail line as measured from the parsed spectra; mono lanes ship
a HALF-WIDTH layout carrying only the channel-0 planes, ch1 reconstructed
as zeros on device). The whole corpus then decodes in ONE jitted lax.scan
over chunks (state carried on-device). The program is AOT-compiled from
shapes before timing (one-time, reported separately).

Four pipeline schedules are all measured and the best one carries the
headline (per-run numbers for each land in detail):
  strict      parse+pack ALL chunks, then a per-chunk device_put burst,
              then execute
  overlap     device_put each fused chunk as soon as it is packed (async),
              so transfers ride under the remaining parse
  strict_mega strict wire (per-chunk widths), but each run of equal-width
              chunks uploads as ONE stacked buffer per lane group
  pipelined   parse+pack ALL chunks at one corpus-global width, then decode
              as TWO half-corpus scans: segment 2's (stacked) uploads are
              enqueued while segment 1's scan runs on the card. Pays the
              corpus-global (uncapped-chunk-0) wire width.

Corpus: the continuity corpus of go_mp3_tpu.synth, generated from --seed
(GOMP3_SEED): 48 MPEG-1 44.1 kHz joint-stereo VBR lanes + 16 MPEG-2
22.05 kHz mono VBR lanes, every lane distinct.

The timed region of a run ends at a fetch of the (tiny) per-chunk energies
output, the proof that the whole pipeline completed. Runs repeat and the
minimum is reported, with the full spread in detail.

The decoder ceiling — parse plus device compute, with the data already on
the card — is reported three ways, each at min AND median over
full-corpus parse samples (all chunks of all streams) at process-CPU cost:
  decoder_ceiling_x_realtime            serial parse + scan-amortized
                                        compute; no fused pack
  decoder_ceiling_fused_x_realtime      adds the fused packing copy the
                                        timed runs pay
  decoder_ceiling_pipelined_x_realtime  parse of corpus N+1 under device
                                        compute of corpus N (bound by the
                                        slower phase)
These are arithmetic on probe timings, not timed pipelines.

Refuses to run without a GPU. Prints ONE JSON line on stdout naming the
device; diagnostics on stderr.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sig3(x: float) -> float:
    """Round to 3 significant figures (the spread does not support 5)."""
    from math import floor, log10

    if x == 0:
        return 0.0
    return round(x, 2 - int(floor(log10(abs(x)))))


def main() -> None:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX reports {devices[0].platform} "
            "devices"
        )
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }

    from go_mp3_tpu.synth import CONTINUITY_LANES, continuity_corpus
    from go_mp3_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from go_mp3_tpu.consts import SAMPLES_PER_GR
    from go_mp3_tpu.native.lib import (
        HEAD_WIDTH,
        SIDE8_WIDTH,
        SP8_TAIL_WIDTH,
        BatchParser,
        NativeParser,
    )
    from go_mp3_tpu.ops.granule import (
        decode_chunk_fused_batch_impl,
        decode_chunk_fused_mono_batch_impl,
        fused_stream_nbytes,
        fused_stream_nbytes_mono,
        unpack_fused,
        unpack_fused_mono,
    )
    from go_mp3_tpu.parallel.corpus import (
        build_fused_chunk,
        build_fused_chunk_mono,
        tail_cap_lines,
    )
    from go_mp3_tpu.parallel.mesh import init_states

    # lane counts: a prefix of each lane group of the continuity corpus
    max_stereo, max_mono = (n for _, n, _ in CONTINUITY_LANES)
    n_classic = int(os.environ.get("GOMP3_N_CLASSIC", str(max_stereo)))
    n_mpeg2 = int(os.environ.get("GOMP3_N_MPEG2", str(max_mono)))
    if not (0 <= n_classic <= max_stereo and 0 <= n_mpeg2 <= max_mono):
        raise SystemExit(
            f"GOMP3_N_CLASSIC <= {max_stereo} and GOMP3_N_MPEG2 <= {max_mono}"
        )
    n_streams = n_classic + n_mpeg2
    # 240 granules/chunk: the stereo lanes are 3080 granules (12.83 x 240),
    # so 13 chunks carry 3% padding slots instead of 9.9% at 256
    chunk_t = int(os.environ.get("GOMP3_CHUNK_T", "240"))
    buckets = tuple(
        int(b)
        for b in os.environ.get("GOMP3_TAIL_BUCKETS", "464,512").split(",")
        if b
    ) or None
    # mono lanes (contiguous at the tail of the corpus) ship the half-width
    # wire layout: channel-0 planes only, ch1 reconstructed as zeros on
    # device (decode_corpus_fast mono_split semantics; exactness is
    # structural and pinned by tests)
    mono_split = os.environ.get("GOMP3_MONO_SPLIT", "1") == "1"
    n_stereo = n_classic if mono_split and n_mpeg2 else n_streams

    seed = int(os.environ.get("GOMP3_SEED", "0"))
    corpus = continuity_corpus(seed)
    stream_data = corpus[:n_classic] + corpus[max_stereo : max_stereo + n_mpeg2]

    log(f"devices: {devices}")

    # geometry pass (untimed): per-lane lengths/rates + per-chunk tail
    # caps. n_chunks is counted with CHUNK-SIZED parse calls, not derived
    # as ceil(granules/chunk_t): a chunk of 1-granule-per-frame (MPEG-2
    # LSF) streams holds at most chunk_t-1 granules (the parser keeps 2
    # slots free per frame), so the arithmetic bound can undercount and
    # silently leave a stream tail unparsed.
    spp = np.zeros((chunk_t, SP8_TAIL_WIDTH), np.int8)
    escp = np.zeros((chunk_t, HEAD_WIDTH), np.int16)
    sdp = np.zeros((chunk_t, SIDE8_WIDTH), np.uint8)
    gr_by_stream, sr_by_stream = [], []
    n_chunks = 0
    for data in stream_data:
        p = NativeParser(data)
        total, calls = 0, 0
        while True:
            n = p.parse_packed8_into(spp, escp, sdp)
            if n == 0:
                break
            total += n
            calls += 1
        gr_by_stream.append(total)
        sr_by_stream.append(p.sample_rate)
        n_chunks = max(n_chunks, calls)
        p.close()
    audio_secs = sum(
        g * SAMPLES_PER_GR / sr for g, sr in zip(gr_by_stream, sr_by_stream)
    )
    total_granules = sum(gr_by_stream)

    # chunk buffer pool (parser emission targets) + fused transfer buffers,
    # allocated once and reused (page-faulting fresh pages every attempt
    # would be measured as parse time; a production pipeline reuses rings)
    pool = [
        (
            np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8),
            np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16),
            np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8),
        )
        for _ in range(n_chunks)
    ]

    # ---- full-corpus parse probe (the ceiling's host term) -----------------
    # Parses EVERY chunk of EVERY stream into the pool — no extrapolation.
    # Sampled at separated points of the run; both wall and process-CPU,
    # min AND median reported.
    parse_samples_wall: list[float] = []
    parse_samples_cpu: list[float] = []

    probe_valids = np.zeros(n_streams, np.int32)

    def parse_probe(reps: int):
        for _ in range(reps):
            bp = BatchParser(stream_data)
            t0 = time.perf_counter()
            c0 = time.process_time()
            for spectra, head, side in pool:
                bp.parse_chunk_into(spectra, head, side, probe_valids)
            parse_samples_wall.append(time.perf_counter() - t0)
            parse_samples_cpu.append(time.process_time() - c0)
            bp.close()

    parse_probe(3)  # also warms the pool pages before anything is timed

    # per-chunk tail caps (corpus metadata, like shapes — computed in this
    # untimed geometry pass from the parsed spectra via tail_cap_lines,
    # the exact ground truth; count1-based capping is NOT equivalent —
    # count1 is a pre-reorder boundary and the short-block permutation
    # can move nonzero lines above it, see tail_need_lines' docstring)
    if buckets:
        widths = [
            (
                tail_cap_lines(sp[:n_stereo], buckets),
                tail_cap_lines(sp[n_stereo:], buckets),
            )
            if n_stereo < n_streams
            else (tail_cap_lines(sp, buckets),)
            for sp, _, _ in pool
        ]
    else:
        widths = [
            (512, 512) if n_stereo < n_streams else (512,)
            for _ in range(n_chunks)
        ]
    wire_bytes = sum(
        n_stereo * fused_stream_nbytes(chunk_t, w[0])
        + (
            (n_streams - n_stereo)
            * fused_stream_nbytes_mono(chunk_t, w[-1])
            if n_stereo < n_streams
            else 0
        )
        for w in widths
    )
    wire_bpg_eff = wire_bytes / (n_chunks * n_streams * chunk_t)
    log(f"tail caps per chunk: {widths} (eff wire {wire_bpg_eff:.0f} B/gr)")

    def group_nbytes(w):
        per = [
            (n_stereo, fused_stream_nbytes(chunk_t, w[0]))
        ] if n_stereo else []
        if n_stereo < n_streams:
            per.append(
                (
                    n_streams - n_stereo,
                    fused_stream_nbytes_mono(chunk_t, w[-1]),
                )
            )
        return per

    def alloc_fused(w):
        return tuple(np.empty(s, np.uint8) for s in group_nbytes(w))

    fused_pool = [alloc_fused(w) for w in widths]

    # schedules to measure (env-tunable: each of strict_mega/pipelined
    # costs one extra compiled program, so a run can trim the list; their
    # pools are only allocated when selected)
    all_modes = ("overlap", "strict", "strict_mega", "pipelined")
    sel = [
        s.strip()
        for s in os.environ.get(
            "GOMP3_SCHEDULES", ",".join(all_modes)
        ).split(",")
        if s.strip()
    ]
    for s in sel:
        if s not in all_modes:
            log(f"WARNING: unknown schedule {s!r} in GOMP3_SCHEDULES "
                f"(valid: {', '.join(all_modes)})")
    modes = tuple(m for m in all_modes if m in sel) or ("strict",)

    # corpus-global width per group (the pipelined schedule's and drain
    # mode's width: one compiled program serves every segment). The
    # pipelined pool is ONE 3-D [n_chunks, S_g, nb] array per group —
    # each half-corpus segment then uploads with a single device_put per
    # group (4 dispatches per corpus instead of 28)
    w_glob = tuple(max(w[g] for w in widths) for g in range(len(widths[0])))
    n_even = n_chunks + (n_chunks % 2)  # pad to two equal segments
    wire_bpg_pipe = (
        n_even
        * sum(s * nb for s, nb in group_nbytes(w_glob))
        / (n_chunks * n_streams * chunk_t)
    )
    fused_pool_g3 = fused_pool_g = None
    if "pipelined" in modes:
        fused_pool_g3 = tuple(
            np.zeros((n_even,) + s, np.uint8) for s in group_nbytes(w_glob)
        )
        # per-chunk contiguous views into the 3-D pool (pack targets)
        fused_pool_g = [
            tuple(g[c] for g in fused_pool_g3) for c in range(n_even)
        ]

    # runs of consecutive equal-width chunks, stacked: the strict_mega
    # schedule ships each run as ONE buffer per lane group (4 puts per
    # corpus on this corpus's 512/464 split) at the SAME per-chunk wire
    # as strict
    runs_idx = []  # (width_tuple, lo, hi)
    lo = 0
    for c in range(1, n_chunks + 1):
        if c == n_chunks or widths[c] != widths[lo]:
            runs_idx.append((widths[lo], lo, c))
            lo = c
    mega_pool = mega_views = None
    if "strict_mega" in modes:
        mega_pool = tuple(
            tuple(
                np.empty((hi - lo,) + s, np.uint8)
                for s in group_nbytes(w)
            )
            for (w, lo, hi) in runs_idx
        )
        # per-chunk pack targets into the runs
        mega_views = [None] * n_chunks
        for r, (_, lo, hi) in enumerate(runs_idx):
            for c in range(lo, hi):
                mega_views[c] = tuple(g[c - lo] for g in mega_pool[r])

    def pack_chunk(c, spectra, head, side, pool_out=None, w=None):
        """Pool chunk -> fused transfer buffer tuple (stereo [+ mono])."""
        out = (pool_out or fused_pool)[c]
        w = w or widths[c]
        if n_stereo:
            build_fused_chunk(
                spectra[:n_stereo], head[:n_stereo], side[:n_stereo],
                w[0], out=out[0],
            )
        if n_stereo < n_streams:
            build_fused_chunk_mono(
                spectra[n_stereo:], head[n_stereo:], side[n_stereo:],
                w[-1], out=out[-1],
            )
        return out

    # ---- untimed: AOT-compile + load the corpus program --------------------
    import functools

    import jax.numpy as jnp

    states0 = init_states(n_streams)
    valids0 = np.zeros((n_chunks, n_streams), np.int32)

    def make_decode(widths_seq):
        # bufs: per-chunk TUPLES of fused u8 buffers (stereo group
        # [+ half-width mono group]), widths_seq[c] tail lines per group.
        # Returns per-stream energies — tiny [C, S] scalars out; the full
        # PCM cannot be skipped by XLA (energies and the carried DSP state
        # depend on it); PCM correctness is pinned by the validation probe
        # and the test suite's parity gates.
        from go_mp3_tpu.ops.granule import decode_chunk_packed8_impl

        @jax.jit
        def decode_corpus(bufs, states, valids):
            def unpack_chunk(chunk_bufs, w):
                parts = []
                if n_stereo:
                    parts.append(
                        unpack_fused(chunk_bufs[0], chunk_t, w[0])
                    )
                if n_stereo < n_streams:
                    parts.append(
                        unpack_fused_mono(chunk_bufs[-1], chunk_t, w[-1])
                    )
                return tuple(
                    jnp.concatenate([p[i] for p in parts])
                    for i in range(3)
                )

            tails = [
                unpack_chunk(b, w) for b, w in zip(bufs, widths_seq)
            ]
            ta_all = jnp.stack([x[0] for x in tails])
            he_all = jnp.stack([x[1] for x in tails])
            sd_all = jnp.stack([x[2] for x in tails])

            batched = jax.vmap(decode_chunk_packed8_impl)

            def step(st, xs):
                ta, he, sd, v = xs
                pcm, st = batched(ta, he, sd, st, v)
                energy = jnp.sum(
                    jnp.abs(pcm.astype(jnp.int32)), axis=(1, 2)
                )
                return st, energy

            states, energies = jax.lax.scan(
                step, states, (ta_all, he_all, sd_all, valids)
            )
            return energies, states  # energies: [C, S] int32

        return decode_corpus

    sds = lambda shape, dt: jax.ShapeDtypeStruct(shape, dt)
    state_shapes = jax.tree_util.tree_map(
        lambda x: sds(x.shape, x.dtype), states0
    )

    t0 = time.perf_counter()
    shapes = (
        [tuple(sds(b.shape, np.uint8) for b in fp) for fp in fused_pool],
        state_shapes,
        sds(valids0.shape, np.int32),
    )
    compiled = make_decode(widths).lower(*shapes).compile()
    log(f"compile+load: {time.perf_counter() - t0:.2f}s (one-time, untimed)")

    # the half-corpus segment program for the pipelined schedule: every
    # chunk at the corpus-global width, so BOTH halves run this one
    # program (the same property drain mode uses)
    parse_probe(1)  # separated sampling point between the two compiles
    # warm the pipelined and run-stacked pools' pages untimed
    # (np.empty/np.zeros are lazily mapped; hundreds of MB of first-touch
    # faults would otherwise land inside the first timed run of each)
    for c, (spectra, head, side) in enumerate(pool):
        if fused_pool_g is not None:
            pack_chunk(c, spectra, head, side,
                       pool_out=fused_pool_g, w=w_glob)
        if mega_views is not None:
            pack_chunk(c, spectra, head, side, pool_out=mega_views)
    for fb in (fused_pool_g or [])[n_chunks:]:
        for b in fb:
            b[:, ::4096] = 0
    k_seg = n_even // 2

    def make_decode_stacked(k, ws):
        # segment program over STACKED per-group arrays ([k, S_g, nb]
        # each): one device_put per group per segment
        inner = make_decode((ws,) * k)

        @jax.jit
        def decode(stacked, states, valids):
            bufs = [tuple(g[c] for g in stacked) for c in range(k)]
            return inner(bufs, states, valids)

        return decode

    compiled_seg = None
    if "pipelined" in modes:
        t0 = time.perf_counter()
        seg_shapes = (
            tuple(
                sds((k_seg,) + g.shape[1:], np.uint8)
                for g in fused_pool_g3
            ),
            state_shapes,
            sds((k_seg, n_streams), np.int32),
        )
        compiled_seg = (
            make_decode_stacked(k_seg, w_glob).lower(*seg_shapes).compile()
        )
        log(
            f"segment compile+load: {time.perf_counter() - t0:.2f}s "
            f"({k_seg} chunks at {w_glob}, one-time, untimed)"
        )
    t0 = time.perf_counter()

    def make_decode_runs():
        # full-corpus program over run-stacked inputs (strict_mega): the
        # same per-chunk widths as the strict program, different input
        # packaging (tuple over runs of per-group [n_run, S_g, nb])
        inner = make_decode(widths)

        @jax.jit
        def decode(run_bufs, states, valids):
            bufs = [
                tuple(g[c - lo] for g in run_bufs[r])
                for r, (_, lo, hi) in enumerate(runs_idx)
                for c in range(lo, hi)
            ]
            return inner(bufs, states, valids)

        return decode

    compiled_mega = None
    if "strict_mega" in modes:
        mega_shapes = (
            tuple(
                tuple(sds(g.shape, np.uint8) for g in run)
                for run in mega_pool
            ),
            state_shapes,
            sds(valids0.shape, np.int32),
        )
        compiled_mega = make_decode_runs().lower(*mega_shapes).compile()
        log(
            f"run-stacked compile+load: {time.perf_counter() - t0:.2f}s "
            f"({len(runs_idx)} runs "
            f"{[(hi - lo, w) for w, lo, hi in runs_idx]}, "
            "one-time, untimed)"
        )

    # ---- timed: the full pipeline, end to end ------------------------------
    # parse -> fused pack -> device_put (1/chunk) -> one scan -> FETCH of
    # the [C,S] energies (the only proof the whole pipeline completed).
    def one_run(mode: str):
        states = init_states(n_streams)
        pipelined = mode == "pipelined"
        t_start = time.perf_counter()
        bp = BatchParser(stream_data)
        valids = np.zeros((n_even, n_streams), np.int32)
        bufs, host_bufs = [], []
        t0 = time.perf_counter()
        for c, (spectra, head, side) in enumerate(pool):
            bp.parse_chunk_into(spectra, head, side, valids[c])
            if pipelined:
                pack_chunk(c, spectra, head, side,
                           pool_out=fused_pool_g, w=w_glob)
                continue
            if mode == "strict_mega":
                pack_chunk(c, spectra, head, side, pool_out=mega_views)
                continue
            fb = pack_chunk(c, spectra, head, side)
            if mode == "overlap":
                # async enqueue: the transfers ride under the remaining
                # chunks' parse (which can also slow the parse — see
                # detail runs_wall_s per schedule)
                bufs.append(tuple(jax.device_put(b) for b in fb))
            else:
                host_bufs.append(fb)
        parse_wall = time.perf_counter() - t0
        bp.close()
        # every stream must have exhausted within the pool's chunk budget
        assert int(valids.sum()) == total_granules, (
            int(valids.sum()), total_granules
        )
        if pipelined:
            # two half-corpus scans through ONE compiled program: segment
            # 2's uploads are enqueued while segment 1 runs on the card;
            # each segment ships ONE buffer per lane group
            bufs1 = tuple(
                jax.device_put(g[:k_seg]) for g in fused_pool_g3
            )
            en1, states = compiled_seg(bufs1, states, valids[:k_seg])
            bufs2 = tuple(
                jax.device_put(g[k_seg:]) for g in fused_pool_g3
            )
            en2, _ = compiled_seg(bufs2, states, valids[k_seg:])
            en = np.concatenate(
                [np.asarray(en1), np.asarray(en2)]
            )[:n_chunks]  # the fence: pipeline provably done
            total_wall = time.perf_counter() - t_start
            del bufs1, bufs2, en1, en2
            return total_wall, parse_wall, en
        if mode == "strict_mega":
            # strict wire (per-chunk widths), stacked uploads: one
            # device_put per equal-width run per lane group
            run_bufs = tuple(
                tuple(jax.device_put(g) for g in run)
                for run in mega_pool
            )
            energies, _ = compiled_mega(
                run_bufs, states, valids[:n_chunks]
            )
            en = np.asarray(energies)
            total_wall = time.perf_counter() - t_start
            del run_bufs, energies
            return total_wall, parse_wall, en
        if mode == "strict":
            bufs = [
                tuple(jax.device_put(b) for b in fb) for fb in host_bufs
            ]
        energies, _ = compiled(bufs, states, valids[:n_chunks])
        en = np.asarray(energies)  # the fence: pipeline provably done
        total_wall = time.perf_counter() - t_start
        del bufs, host_bufs, energies
        return total_wall, parse_wall, en

    # fixed protocol: 3 runs per schedule, round-robin so drift hits all
    # schedules alike, with only a global wall budget as an escape (each
    # schedule keeps >= 2 runs). Headline = best per-schedule MIN; the
    # raw per-run lists land in detail (no cross-schedule median).
    runs = {m: [] for m in modes}
    en = None
    en_by_mode: dict = {}
    order = [m for _ in range(3) for m in modes]
    budget_s = float(os.environ.get("GOMP3_RUN_BUDGET_S", "300"))
    spent = 0.0
    for rep, mode in enumerate(order):
        total_wall, parse_wall, en = one_run(mode)
        runs[mode].append((total_wall, parse_wall))
        spent += total_wall
        # the decode is deterministic, so every schedule must produce the
        # SAME per-chunk energies — this pins the pipelined path's
        # two-segment state carry against the one-scan schedules
        prev = en_by_mode.setdefault(mode, en)
        assert np.array_equal(prev, en), f"{mode} energies changed"
        for m2, e2 in en_by_mode.items():
            assert np.array_equal(e2, en), (
                f"schedule {mode} energies != {m2}"
            )
        log(
            f"run {rep} [{mode}]: wall {total_wall:.3f}s "
            f"(parse+pack {parse_wall:.3f}s inside)"
        )
        if spent > budget_s and all(len(r) >= 2 for r in runs.values()):
            log(f"run budget {budget_s:.0f}s spent; stopping at {rep + 1}")
            break
    best = {m: min(rs) for m, rs in runs.items() if rs}
    best_mode = min(best, key=lambda m: best[m][0])
    total_wall, parse_wall = best[best_mode]

    # non-silence fence: the int32 |pcm| sums WRAP at big chunk_t (wrap
    # is order-independent, which is exactly why int32 is right for the
    # cross-schedule equality assert above), so test nonzero, not sign
    assert (en[:2] != 0).all(), "every stream's first chunks should be non-silent"

    end_to_end_x = audio_secs / total_wall

    # ---- untimed probes: per-phase steady-state costs ----------------------
    parse_probe(3)  # separated sampling points for the ceiling term

    # fused pack cost (the transfer-layout copy; inside every timed run,
    # excluded from the transfer-free ceiling — see module docstring)
    t0 = time.process_time()
    for c, (spectra, head, side) in enumerate(pool):
        pack_chunk(c, spectra, head, side)
    probe_pack = (time.process_time() - t0) / n_chunks

    # upload probe: one fused chunk, fetch-fenced
    # (chunk 1 when it exists)
    t0 = time.perf_counter()
    dbuf = tuple(
        jax.device_put(b) for b in fused_pool[min(1, n_chunks - 1)]
    )
    jax.block_until_ready(dbuf)
    np.asarray(dbuf[0][0, :4])
    probe_upload = time.perf_counter() - t0

    # scan-amortized device compute: re-run the loaded corpus program on
    # resident data and fetch the energies — the per-chunk cost production
    # pays (dispatch amortized over the whole corpus)
    bufs_res = [
        tuple(jax.device_put(b) for b in fb) for fb in fused_pool
    ]
    jax.block_until_ready(bufs_res)
    valids_full = np.full((n_chunks, n_streams), chunk_t, np.int32)
    probe_scan = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        e2, _ = compiled(bufs_res, init_states(n_streams), valids_full)
        np.asarray(e2)
        probe_scan = min(probe_scan, time.perf_counter() - t0)
    probe_compute = probe_scan / n_chunks
    parse_probe(2)  # final sampling points

    parse_min = min(parse_samples_cpu)
    parse_med = statistics.median(parse_samples_cpu)
    compute_total = probe_compute * n_chunks
    ceiling_min = audio_secs / (parse_min + compute_total)
    ceiling_med = audio_secs / (parse_med + compute_total)
    # the fused variant additionally pays the fused-layout packing copy
    # (the pool-array ceiling above device_puts the parser's pool arrays
    # directly)
    pack_total = probe_pack * n_chunks
    ceiling_fused_min = audio_secs / (parse_min + pack_total + compute_total)
    ceiling_fused_med = audio_secs / (parse_med + pack_total + compute_total)
    # overlapping host parse of corpus N+1 with device decode of corpus N
    # bounds the pipelined ceiling by the slower phase; the serial sum
    # above stays the headline ceiling
    ceiling_pipe = audio_secs / max(parse_min, compute_total)
    ceiling_pipe_med = audio_secs / max(parse_med, compute_total)

    chunk_audio = sum(chunk_t * SAMPLES_PER_GR / sr for sr in sr_by_stream)
    log(
        f"full-corpus parse: cpu min {parse_min:.3f}s med {parse_med:.3f}s "
        f"wall min {min(parse_samples_wall):.3f}s over "
        f"{len(parse_samples_cpu)} samples ({total_granules} granules); "
        f"pack {probe_pack:.3f}s/chunk; upload {probe_upload:.3f}s/chunk; "
        f"compute {probe_compute:.4f}s/chunk (scan {probe_scan:.3f}s / "
        f"{n_chunks}); ceiling min {ceiling_min:.0f}x med {ceiling_med:.0f}x "
        f"(fused {ceiling_fused_min:.0f}/{ceiling_fused_med:.0f}x, "
        f"pipelined {ceiling_pipe:.0f}/{ceiling_pipe_med:.0f}x)"
    )

    # validation probe: decode one chunk of lane group 0, check the PCM is
    # not silence. With an all-mono corpus (GOMP3_N_CLASSIC=0) group 0
    # is the half-width mono buffer, so the probe must use the mono
    # unpack and the mono group's width.
    n_probe = n_stereo if n_stereo else n_streams
    one_step = jax.jit(
        functools.partial(
            decode_chunk_fused_batch_impl
            if n_stereo
            else decode_chunk_fused_mono_batch_impl,
            t=chunk_t,
            tail_lines=widths[0][0] if n_stereo else widths[0][-1],
        )
    )
    pcm, _ = one_step(
        jax.device_put(fused_pool[0][0]),
        init_states(n_probe),
        np.full(n_probe, chunk_t, np.int32),
    )
    probe = np.asarray(pcm[0, 20 * SAMPLES_PER_GR : 60 * SAMPLES_PER_GR])
    assert np.abs(probe).max() > 100, "decoded PCM should not be silence"
    del pcm

    log(
        f"audio={audio_secs:.1f}s wall={total_wall:.3f}s [{best_mode}] "
        f"end-to-end {end_to_end_x:.1f}x on {device['kind']}"
    )

    result = {
        "metric": "aggregate end-to-end decode throughput",
        "value": sig3(end_to_end_x),
        "unit": "x realtime",
        "device": device,
        "detail": {
            # decoder ceilings from full-corpus parse timings, three ways
            # (see the module docstring): pool-array (parse + compute),
            # fused (adds the fused-layout packing copy the timed runs
            # pay) and pipelined (bound by the slower phase)
            "decoder_ceiling_x_realtime": sig3(ceiling_min),
            "decoder_ceiling_x_realtime_median": sig3(ceiling_med),
            "decoder_ceiling_fused_x_realtime": sig3(ceiling_fused_min),
            "decoder_ceiling_fused_x_realtime_median": sig3(
                ceiling_fused_med
            ),
            "decoder_ceiling_pipelined_x_realtime": sig3(ceiling_pipe),
            "decoder_ceiling_pipelined_x_realtime_median": sig3(
                ceiling_pipe_med
            ),
            "parse_full_corpus_cpu_s": {
                "min": round(parse_min, 3),
                "median": round(parse_med, 3),
                "n": len(parse_samples_cpu),
            },
            "parse_full_corpus_wall_s_min": round(
                min(parse_samples_wall), 3
            ),
            "host_parse_x_realtime_cpu": sig3(audio_secs / parse_min),
            "end_to_end_x_by_schedule": {
                m: sig3(audio_secs / min(w for w, _ in rs))
                for m, rs in runs.items()
                if rs
            },
            "probe_pack_s_per_chunk": round(probe_pack, 4),
            "probe_upload_s_per_chunk_fused": round(probe_upload, 3),
            "probe_compute_s_per_chunk_scan_amortized": round(
                probe_compute, 4
            ),
            "probe_scan_total_s": round(probe_scan, 3),
            "chunk_audio_seconds": round(chunk_audio, 1),
            "wire_bytes_per_granule_effective": round(wire_bpg_eff, 1),
            "wire_bytes_per_granule_pipelined": round(wire_bpg_pipe, 1),
            "tail_lines_corpus_global": list(w_glob),
            "tail_cap_lines_per_chunk": [list(w) for w in widths],
            "mono_split_lanes": n_streams - n_stereo,
            "tail_buckets": list(buckets) if buckets else None,
            "transfers_per_corpus_by_schedule": {
                m: n
                for m, n in (
                    ("strict", n_chunks * len(fused_pool[0])),
                    ("overlap", n_chunks * len(fused_pool[0])),
                    ("strict_mega", len(runs_idx) * len(fused_pool[0])),
                    ("pipelined", 2 * len(fused_pool[0])),
                )
                if m in modes
            },
            "schedule": best_mode,
            "runs_wall_s": {
                m: [round(w, 3) for w, _ in rs] for m, rs in runs.items()
            },
            "parse_pack_wall_in_best_run_s": round(parse_wall, 3),
            "n_streams": n_streams,
            "corpus": (
                f"synth.continuity_corpus(seed={seed}): {n_classic} MPEG-1 "
                f"stereo + {n_mpeg2} MPEG-2 mono lanes"
            ),
            "chunk_t": chunk_t,
            "n_chunks": n_chunks,
            "granules": total_granules,
            "audio_seconds": round(audio_secs, 1),
            "host_cores": len(os.sched_getaffinity(0)),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
