#!/usr/bin/env python3
"""Micro-profile of the native parse path (host side of the decoder).

Times the interfaces that differ only by emission work, so the deltas
attribute cost to pipeline stages:
  gmp_index         headers only (sync + size hop)
  gmp_parse         full parse -> int16 spectra + separate sfl/sfs/meta
  gmp_parse_packed  full parse -> int16 spectra + packed sidecar
  gmp_parse_packed8 full parse -> int8 spectra + escapes + byte sidecar

Prints granules/s and the x-realtime each sustains on this host, from the
best of interleaved repeats.
"""

from __future__ import annotations

import sys
import time

from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from go_mp3_tpu.consts import SAMPLES_PER_GR
from go_mp3_tpu.native.lib import (
    HEAD_WIDTH,
    META_WIDTH,
    SIDE8_WIDTH,
    SIDE_WIDTH,
    SP8_TAIL_WIDTH,
    NativeParser,
    index_stream,
)


def best_interleaved(fns: dict, n=9) -> dict:
    """Min PROCESS-CPU time per labeled thunk, alternating between them each
    round so host drift hits all variants equally. CPU time (not wall)
    excludes descheduling on a shared host — the right metric for
    comparing instruction-count changes."""
    out = {k: float("inf") for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            t0 = time.process_time()
            fn()
            out[k] = min(out[k], time.process_time() - t0)
    return out


def main() -> None:
    from go_mp3_tpu.synth import MONO, STEREO, generate_stream

    corpora = [
        ("MPEG-1 stereo, 1540 frames", generate_stream(STEREO, 1540, seed=1), 44100),
        ("MPEG-2 mono, 2872 frames", generate_stream(MONO, 2872, seed=2), 22050),
    ]

    cap = 8192
    sp16 = np.zeros((cap, 2, 576), np.int16)
    sfl = np.zeros((cap, 2, 22), np.int32)
    sfs = np.zeros((cap, 2, 39), np.int32)
    meta = np.zeros((cap, META_WIDTH), np.int32)
    spp = np.zeros((cap, 1152), np.int16)
    sdp = np.zeros((cap, SIDE_WIDTH), np.int16)
    sp8 = np.zeros((cap, SP8_TAIL_WIDTH), np.int8)
    esc = np.zeros((cap, HEAD_WIDTH), np.int16)
    sd8 = np.zeros((cap, SIDE8_WIDTH), np.uint8)

    for name, data, sr in corpora:
        # count granules once
        p = NativeParser(data)
        total = 0
        while True:
            n = p.parse_packed8_into(sp8, esc, sd8)
            if n == 0:
                break
            total += n
        p.close()
        audio_s = total * SAMPLES_PER_GR / sr

        def run_index():
            index_stream(data)

        def run(parse_name):
            p = NativeParser(data)
            while True:
                if parse_name == "parse":
                    n = p.parse_into(sp16, sfl, sfs, meta)
                elif parse_name == "packed":
                    n = p.parse_packed_into(spp, sdp)
                else:
                    n = p.parse_packed8_into(sp8, esc, sd8)
                if n == 0:
                    break
            p.close()

        times = best_interleaved(
            {
                "index (headers)": run_index,
                "parse int16": lambda: run("parse"),
                "parse packed": lambda: run("packed"),
                "parse packed8": lambda: run("packed8"),
            }
        )
        print(f"== {name}: {total} granules, {audio_s:.1f}s audio")
        for label, t in times.items():
            print(
                f"  {label:18s} {t*1e3:8.2f} ms   "
                f"{total/t/1e3:8.0f}k gr/s   {audio_s/t:8.0f}x realtime"
            )


if __name__ == "__main__":
    main()
