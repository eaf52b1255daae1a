#!/usr/bin/env python3
"""Single-stream decode benchmark — the reference's own harness metric.

Mirrors bench_test.go:24-57 (BenchmarkDecode/{small,large} with
b.SetBytes(len(file)) -> MB/s of compressed input) for each backend.
Inputs come from the stream generator (go_mp3_tpu.synth): small = a
385-frame MPEG-1 44.1 kHz joint-stereo VBR stream (~10 s), large = 1540
frames (~40 s). The device rows run on whatever platform JAX selects
(`make bench-single` pins the CPU).

Usage: python tools/bench_single.py [--backend exact|device|golden|all]
Prints one JSON line per (fixture, backend).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))



def run_one(data: bytes, backend: str, reps: int) -> dict:
    from go_mp3_tpu import Decoder

    best = float("inf")
    pcm = b""
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            pcm = Decoder(data, backend=backend).read_all()
        best = min(best, (time.perf_counter() - t0) / reps)
    sr = Decoder(data, backend=backend).sample_rate()
    audio_s = len(pcm) / 4 / sr
    return {
        "backend": backend,
        "compressed_mb_s": round(len(data) / 1e6 / best, 2),
        "x_realtime": round(audio_s / best, 1),
        "ms_per_file": round(best * 1000, 1),
        "bytes_in": len(data),
        "bytes_out": len(pcm),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="all")
    args = ap.parse_args()

    from go_mp3_tpu.synth import STEREO, generate_stream

    small = generate_stream(STEREO, 385, seed=1)
    large = generate_stream(STEREO, 1540, seed=1)
    backends = (
        ["exact", "device", "golden"]
        if args.backend == "all"
        else [args.backend]
    )
    for name, data in (("small", small), ("large", large)):
        for b in backends:
            reps = 1 if b == "golden" else (4 if name == "large" else 8)
            r = run_one(data, b, reps)
            r["fixture"] = name
            print(json.dumps(r))


if __name__ == "__main__":
    main()
