#!/usr/bin/env python3
"""Profile the decode pipeline (the analogue of the reference's
`make profile-cpu` pprof workflow, Makefile:65-75):

 - host parse: cProfile over the Python parser + wall time of the native one,
 - device: a JAX profiler trace of the chunked decode (view with xprof /
   tensorboard against the written trace directory).
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    from go_mp3_tpu.models.native_pipeline import parse_stream_native
    from go_mp3_tpu.models.pipeline import pack_granule_batch
    from go_mp3_tpu.ops.granule import decode_chunk
    from go_mp3_tpu.parallel.corpus import parse_stream_granules
    from go_mp3_tpu.ops.granule import init_state

    from go_mp3_tpu.synth import STEREO, generate_stream

    data = generate_stream(STEREO, 385, seed=1)

    print("== host parse (python) ==")
    prof = cProfile.Profile()
    prof.enable()
    granules = parse_stream_granules(data)
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(12)

    print("== host parse (native) ==")
    t0 = time.perf_counter()
    parse_stream_native(data)
    print(f"native parse: {time.perf_counter() - t0:.4f}s")

    print("== device trace ==")
    batch, valid = pack_granule_batch(granules[:256], pad_to=256)
    state = init_state()
    import jax.numpy as jnp

    pcm, _ = decode_chunk(batch, state, jnp.int32(valid))  # compile
    pcm.block_until_ready()
    trace_dir = "/tmp/gomp3_trace"
    with jax.profiler.trace(trace_dir):
        pcm, _ = decode_chunk(batch, state, jnp.int32(valid))
        pcm.block_until_ready()
    print(f"trace written to {trace_dir}")


if __name__ == "__main__":
    main()
