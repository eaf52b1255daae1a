#!/usr/bin/env python3
"""Standalone full-corpus parse probe — the ceiling's host term, without
importing jax. Mirrors bench.py's geometry + parse probe exactly: the 64
streams of synth.continuity_corpus(0) (48 stereo + 16 mono), chunk_t=240,
BatchParser.parse_chunk_into over a reusable pool, process-CPU time,
min/median over N samples. Use to A/B parser changes quickly.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from go_mp3_tpu.consts import SAMPLES_PER_GR
from go_mp3_tpu.native.lib import (
    HEAD_WIDTH,
    SIDE8_WIDTH,
    SP8_TAIL_WIDTH,
    BatchParser,
    NativeParser,
)
from go_mp3_tpu.synth import continuity_corpus


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    n_classic = int(os.environ.get("GOMP3_N_CLASSIC", "48"))
    n_mpeg2 = int(os.environ.get("GOMP3_N_MPEG2", "16"))
    n_streams = n_classic + n_mpeg2
    chunk_t = int(os.environ.get("GOMP3_CHUNK_T", "240"))

    corpus = continuity_corpus(0)
    stream_data = corpus[:n_classic] + corpus[48 : 48 + n_mpeg2]

    # geometry: count chunks with chunk-sized parse calls (LSF invariant)
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

    pool = [
        (
            np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8),
            np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16),
            np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8),
        )
        for _ in range(n_chunks)
    ]
    valids = np.zeros(n_streams, np.int32)

    cpu_samples, wall_samples = [], []
    for r in range(reps):
        bp = BatchParser(stream_data)
        t0 = time.perf_counter()
        c0 = time.process_time()
        for spectra, head, side in pool:
            bp.parse_chunk_into(spectra, head, side, valids)
        cpu_samples.append(time.process_time() - c0)
        wall_samples.append(time.perf_counter() - t0)
        bp.close()
        print(
            f"rep {r}: cpu {cpu_samples[-1]:.3f}s wall {wall_samples[-1]:.3f}s",
            file=sys.stderr,
        )

    mn, md = min(cpu_samples), statistics.median(cpu_samples)
    print(
        f"parse full corpus ({total_granules} gr, {n_chunks} chunks): "
        f"cpu min {mn:.3f}s med {md:.3f}s "
        f"({total_granules/mn/1e3:.0f}k gr/s min) "
        f"ceiling-at-0.129s-compute min {audio_secs/(mn+0.129):.0f}x "
        f"med {audio_secs/(md+0.129):.0f}x"
    )


if __name__ == "__main__":
    main()
