#!/usr/bin/env python3
"""Start-up proof on an NVIDIA GPU: the production decode path, run once.

    python chip_smoke.py [--seed N]     # one card
    python chip_smoke.py --four         # sharded over four cards

One process holds the card(s) for the whole run; the phases run in order
and the first failure ends the script with a traceback and a non-zero exit:

1. device: JAX must report a GPU (no CPU fallback); prints the card's
   name and power limit and the JAX, jaxlib and CUDA-plugin versions.
2. native: builds libmp3parse.so from the tracked sources and requires
   it (the pure-Python parser may not stand in).
3. main path: decodes the continuity corpus (synth.continuity_corpus,
   193,792 granules) through decode_corpus_fast with its defaults, cold
   (compile included) and three times warm, then with fetch=False, whose
   PCM must stay on the card and equal the fetched PCM.
4. parity: the card's PCM of 4 stereo and 2 mono lanes, at full length,
   against the exact (native/mp3dsp.cpp) and golden (ops/reference_dsp.py,
   float64) backends at ISO/IEC 11172-4 full compliance (RMS < 0.289 LSB,
   maxdiff <= 2); and one lane through Decoder(...).read() on the device
   backend against the corpus decode (maxdiff <= 1 LSB).

--four replaces phases 3-4 with the sharded path alone: the corpus over a
four-card mesh must equal the one-card decode byte for byte, and no program
compiled in the process may contain a collective (checked on XLA's dump of
the optimized HLO, fetch=False path included).

The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FULL_COMPLIANCE_RMS = 0.289
FULL_COMPLIANCE_MAXDIFF = 2
PARITY_LANES = (0, 1, 2, 3, 48, 49)  # 4 stereo, 2 mono (corpus order)
COLLECTIVE = re.compile(
    r"all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter"
    r"|collective-broadcast|ragged-all-to-all"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def phase_device(n_cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX reports {devices[0].platform} devices; this script "
            "runs on the card only"
        )
    if len(devices) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, JAX reports {len(devices)}")
    from importlib import metadata

    import jaxlib

    plugins = sorted(
        f"{d.metadata['Name']} {d.version}"
        for d in metadata.distributions()
        if d.metadata["Name"] and "cuda" in d.metadata["Name"].lower()
        and "jax" in d.metadata["Name"].lower()
    )
    log(f"device_kind: {devices[0].device_kind} x{len(devices)}")
    log(f"nvidia-smi: {card_name_and_power()}")
    log(
        f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"cuda plugin: {', '.join(plugins) or 'none found'}"
    )
    return devices


def phase_native() -> None:
    from go_mp3_tpu.native import lib as native

    t0 = time.perf_counter()
    native.require()  # builds from the tracked sources; raises with stderr
    log(f"native parser: libmp3parse.so ready ({time.perf_counter() - t0:.1f} s)")


def lane_pcm(pcms_host: np.ndarray, valids: np.ndarray, lane: int) -> bytes:
    return b"".join(
        pcms_host[c, lane, : int(valids[c, lane]) * 576].tobytes()
        for c in range(pcms_host.shape[0])
        if valids[c, lane]
    )


def diff_stats(a: bytes, b: bytes) -> tuple[float, int]:
    x = np.frombuffer(a, "<i2").astype(np.int64)
    y = np.frombuffer(b, "<i2").astype(np.int64)
    if x.shape != y.shape:
        raise AssertionError(f"length {x.size} != {y.size} samples")
    d = x - y
    return float(np.sqrt((d.astype(np.float64) ** 2).mean())), int(np.abs(d).max())


def phase_main(corpus: list[bytes], card: str):
    import jax

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    t0 = time.perf_counter()
    res = decode_corpus_fast(corpus)
    cold = time.perf_counter() - t0
    warm_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        warm_res = decode_corpus_fast(corpus)
        warm_runs.append(time.perf_counter() - t0)
        if warm_res.pcm != res.pcm:
            raise AssertionError("warm decode differs from cold decode")
    from go_mp3_tpu.synth import lane_sample_rates

    audio = sum(len(p) // 4 / sr for p, sr in zip(res.pcm, lane_sample_rates()))
    warm = min(warm_runs)
    log(
        f"main path: {res.granules} granules ({audio:.1f} s of audio) on "
        f"{card}: cold {cold:.2f} s (compile included), warm "
        f"{' / '.join(f'{w:.3f}' for w in warm_runs)} s "
        f"(best {audio / warm:.1f}x realtime)"
    )
    if res.granules != 193_792:
        raise AssertionError(f"expected 193792 granules, got {res.granules}")

    pcms, valids = decode_corpus_fast(corpus, fetch=False)
    if not isinstance(pcms, jax.Array):
        raise AssertionError(f"fetch=False returned {type(pcms)}")
    platforms = {d.platform for d in pcms.devices()}
    if platforms != {"gpu"}:
        raise AssertionError(f"fetch=False PCM lives on {platforms}")
    host = np.asarray(pcms)
    for lane in range(len(corpus)):
        if lane_pcm(host, valids, lane) != res.pcm[lane]:
            raise AssertionError(f"fetch=False PCM differs on lane {lane}")
    log(f"fetch=False: PCM {pcms.shape} {pcms.dtype} on the card, equal to fetched")
    return res


def phase_parity(corpus: list[bytes], res) -> None:
    from go_mp3_tpu import Decoder

    worst = {}
    for lane in PARITY_LANES:
        for backend in ("exact", "golden"):
            ref = Decoder(corpus[lane], backend=backend).read_all()
            rms, maxdiff = diff_stats(res.pcm[lane], ref)
            log(f"parity lane {lane} card vs {backend}: rms {rms:.4f} LSB, maxdiff {maxdiff}")
            w = worst.get(backend, (0.0, 0))
            worst[backend] = (max(w[0], rms), max(w[1], maxdiff))
    for backend, (rms, maxdiff) in worst.items():
        log(f"parity card vs {backend} (worst lane): rms {rms:.4f} LSB, maxdiff {maxdiff}")
        if not (rms < FULL_COMPLIANCE_RMS and maxdiff <= FULL_COMPLIANCE_MAXDIFF):
            raise AssertionError(
                f"card vs {backend} outside ISO full compliance: rms {rms}, "
                f"maxdiff {maxdiff}"
            )
    pcm = Decoder(io.BytesIO(corpus[0])).read()
    _, maxdiff = diff_stats(pcm, res.pcm[0])
    log(f"Decoder(device) lane 0 vs corpus decode: {len(pcm)} bytes, maxdiff {maxdiff}")
    if maxdiff > 1:
        raise AssertionError(f"Decoder vs corpus lane maxdiff {maxdiff} > 1")


def phase_four(corpus: list[bytes], devices, dump_dir: Path) -> None:
    import jax

    from go_mp3_tpu.parallel.corpus import decode_corpus_fast
    from go_mp3_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(devices[:4])
    one = decode_corpus_fast(corpus)
    t0 = time.perf_counter()
    four = decode_corpus_fast(corpus, mesh=mesh)
    log(f"four cards: {four.granules} granules in {time.perf_counter() - t0:.2f} s (compile included)")
    if four.pcm != one.pcm:
        bad = [i for i, (a, b) in enumerate(zip(four.pcm, one.pcm)) if a != b]
        raise AssertionError(f"four-card PCM differs from one card on lanes {bad}")
    log(f"four cards vs one card: {len(corpus)} lanes byte-identical")

    pcms, valids = decode_corpus_fast(corpus, mesh=mesh, fetch=False)
    spread = {d.id for d in pcms.devices()}
    host = np.asarray(pcms)
    for lane in range(len(corpus)):
        if lane_pcm(host, valids, lane) != one.pcm[lane]:
            raise AssertionError(f"four-card fetch=False PCM differs on lane {lane}")
    log(f"four cards fetch=False: PCM sharded over devices {sorted(spread)}, equal to one card")
    jax.effects_barrier()

    dumps = sorted(dump_dir.glob("*after_optimizations.txt"))
    partitioned = 0
    for path in dumps:
        txt = path.read_text()
        hits = sorted(set(COLLECTIVE.findall(txt)))
        if hits:
            raise AssertionError(f"{path.name} contains collectives: {hits}")
        partitioned += "num_partitions=4" in txt
    if not partitioned:
        raise AssertionError("no four-way partitioned program was dumped")
    log(
        f"HLO: {len(dumps)} optimized programs dumped, {partitioned} of them "
        "partitioned over 4 cards; no collective in any"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="corpus seed")
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card sharded decode and its comparison",
    )
    args = ap.parse_args(argv)

    dump_dir = None
    if args.four:
        dump_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_hlo_"))
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump_dir}"
        ).strip()

    devices = phase_device(4 if args.four else 1)
    from go_mp3_tpu.synth import continuity_corpus
    from go_mp3_tpu.utils.cache import enable_compilation_cache

    log(f"compilation cache: {enable_compilation_cache()}")
    phase_native()
    card = card_name_and_power()
    t0 = time.perf_counter()
    corpus = continuity_corpus(args.seed)
    log(f"corpus: {len(corpus)} lanes, {sum(map(len, corpus)) / 1e6:.1f} MB, "
        f"generated in {time.perf_counter() - t0:.1f} s (seed {args.seed})")
    if args.four:
        phase_four(corpus, devices, dump_dir)
    else:
        res = phase_main(corpus, card)
        phase_parity(corpus, res)

    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
