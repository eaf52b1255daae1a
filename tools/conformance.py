#!/usr/bin/env python3
"""One-command conformance bundle (`make conformance`).

The reference's keystone correctness test shells out to mpg123
(compliance_test.go:80-92) — an EXTERNAL oracle. Without mpg123 or a Go
toolchain, bit-exactness against the actual reference decoder cannot be
proven. This tool closes as much of that gap as it can: it produces a
self-contained artifact (`conformance/`) that an oracle-equipped machine —
this repo plus mpg123 — can verify in one command per file.

The bundle contains:
  REPORT.json   input SHA-256s; per-backend (exact/golden/device) PCM
                SHA-256 + byte counts; pairwise ISO/IEC 11172-4 metrics
                between the independent backends; the exact oracle
                invocations to run elsewhere
  README.md     how to run the oracle check
  generated_stereo.mp3, generated_mono.mp3
                the test suite's two fixture streams (go_mp3_tpu.synth;
                written by this tool, not kept in git)
  synthetic_escape.mp3, synthetic_lowrate.mp3
                deterministic in-repo streams (escape-heavy MPEG-1 and
                low-bitrate MPEG-2 edge cases)

Run: python tools/conformance.py  (writes conformance/, prints a summary)
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

BACKENDS = ["exact", "golden", "device"]
ORACLE_CMD = "mpg123 -e s16 --stereo -s -q"


def build_synthetic(outdir: pathlib.Path) -> list[tuple[str, str]]:
    """Deterministic synthetic conformance streams from the test suite's
    frame builders (tests/util_synth.py — the trailing_tags_test.go:15-98
    analog)."""
    import util_synth as U

    # global_gain 148 keeps the escape-heavy (13-bit linbits) spectra in
    # audio range — at the builder's default 210 the PCM saturates so hard
    # that independent float pipelines clip opposite signs at zero
    # crossings (measured maxdiff 65534), which tests clipping, not
    # conformance; the fuzz suite owns that case
    esc = b"".join(
        [U.escape_heavy_frame(n_pairs=24, linbit_value=2000 + 97 * i,
                              global_gain=148)
         for i in range(8)]
        + [U.silent_frame() for _ in range(4)]
    )
    low, _, _ = U.low_bitrate_mpeg2_stream(n_fillers=19, n_trailing=6)
    from go_mp3_tpu.synth import MONO, STEREO, generate_stream

    files = []
    for name, data in [
        ("generated_stereo.mp3", generate_stream(STEREO, 385, seed=1)),
        ("generated_mono.mp3", generate_stream(MONO, 2872, seed=2)),
        ("synthetic_escape.mp3", esc),
        ("synthetic_lowrate.mp3", low),
    ]:
        (outdir / name).write_bytes(data)
        path = (outdir / name).relative_to(ROOT)
        files.append((str(path), name.rsplit(".", 1)[0]))
    return files


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")  # correctness artifact: the
    # device backend's XLA chain is platform-portable (the card's parity
    # is checked by chip_smoke.py)

    from compliance import FULL_MAXDIFF, FULL_RMS, compare, _stereo
    from go_mp3_tpu import Decoder

    outdir = ROOT / "conformance"
    outdir.mkdir(exist_ok=True)
    files = build_synthetic(outdir)

    report: dict = {
        "purpose": (
            "self-contained conformance artifact; run the oracle_commands "
            "on a machine with mpg123 to verify against external ground "
            "truth (ISO/IEC 11172-4: full compliance RMS < 0.289 LSB, "
            "maxdiff <= 2)"
        ),
        "oracle_commands": [],
        "files": {},
    }

    for path, name in files:
        data = (ROOT / path).read_bytes()
        entry: dict = {
            "path": path,
            "input_sha256": hashlib.sha256(data).hexdigest(),
            "input_bytes": len(data),
            "backends": {},
            "pairwise_iso_metrics": {},
        }
        pcms = {}
        for backend in BACKENDS:
            pcm = Decoder(data, backend=backend).read_all()
            pcms[backend] = pcm
            entry["backends"][backend] = {
                "pcm_sha256": hashlib.sha256(pcm).hexdigest(),
                "pcm_bytes": len(pcm),
            }
        # pairwise ISO metrics between independent implementations
        # (identical pipeline alignment -> offset 0)
        for a, b in [("device", "golden"), ("exact", "golden"),
                     ("device", "exact")]:
            m = compare(_stereo(pcms[b]), _stereo(pcms[a]), 0)
            entry["pairwise_iso_metrics"][f"{a}_vs_{b}"] = {
                "rms_lsb": round(m["rms"], 6),
                "max_diff_lsb": m["max_diff"],
                "full_compliance": m["full"],
            }
            if not m["full"]:
                print(f"FAIL: {name} {a} vs {b}: {m}", file=sys.stderr)
                return 2
        for backend in ("exact", "device"):
            report["oracle_commands"].append(
                f"python tools/compliance.py {path} --backend {backend} "
                f"--oracle-cmd '{ORACLE_CMD}'"
            )
        report["files"][name] = entry
        print(
            f"{name}: 3 backends decoded, all pairs FULL COMPLIANCE "
            f"(device-vs-golden rms "
            f"{entry['pairwise_iso_metrics']['device_vs_golden']['rms_lsb']}"
            f" LSB)"
        )

    # production multi-stream pipeline: decode ALL bundle files in one
    # corpus through decode_corpus_fast with every production feature on
    # (fused transfers, bucketed caps, mono_split, threaded parse, drain),
    # assert byte-identity with the per-stream device decodes above, and
    # freeze the corpus PCM SHA-256s
    from go_mp3_tpu.parallel.corpus import decode_corpus_fast

    corpus_streams = [(ROOT / path).read_bytes() for path, _ in files]
    corpus = decode_corpus_fast(
        corpus_streams,
        chunk_t=64,
        tail_buckets=(464, 512),
        n_threads=2,
        drain=6,
    )
    corpus_entry = {}
    for (path, name), pcm in zip(files, corpus.pcm):
        sha = hashlib.sha256(pcm).hexdigest()
        # the per-stream device decode above already froze its SHA-256:
        # compare against that instead of re-decoding
        if sha != report["files"][name]["backends"]["device"]["pcm_sha256"]:
            print(f"FAIL: corpus pipeline != device Decoder for {name}",
                  file=sys.stderr)
            return 2
        corpus_entry[name] = {"pcm_sha256": sha, "pcm_bytes": len(pcm)}
    report["corpus_pipeline"] = {
        "config": "decode_corpus_fast chunk_t=64 tail_buckets=(464,512) "
                  "n_threads=2 drain=6 (fused + mono_split defaults)",
        "granules": corpus.granules,
        "streams": corpus_entry,
        "matches_per_stream_device_decoder": True,
    }
    print(
        f"corpus pipeline: {corpus.granules} granules over "
        f"{len(files)} streams — byte-identical to per-stream decodes"
    )

    report["thresholds"] = {
        "full_rms_lsb": FULL_RMS,
        "full_maxdiff_lsb": FULL_MAXDIFF,
    }
    (outdir / "REPORT.json").write_text(json.dumps(report, indent=1) + "\n")

    (outdir / "README.md").write_text(
        """# Conformance bundle

Self-contained artifact for verifying go_mp3_tpu against EXTERNAL ground
truth (the reference's own keystone test shells out to mpg123 —
`compliance_test.go:80-92`).

`REPORT.json` freezes, for each fixture and each of the three independent
backends (`exact` C++ f32 / `golden` numpy f64 / `device` JAX-XLA):
the input SHA-256, the decoded PCM SHA-256 and byte count, and pairwise
ISO/IEC 11172-4 metrics (all pairs must be FULL COMPLIANCE: RMS < 0.289
LSB, maxdiff <= 2).

## On a machine with mpg123

```
for each command in REPORT.json "oracle_commands":
    run it; expect exit 0 (FULL COMPLIANCE) and read the printed RMS /
    maxdiff / alignment / histogram
```

The two `generated_*.mp3` files are the test suite's fixture streams,
written by `make conformance` from `go_mp3_tpu.synth` (run it first: they
are not kept in git). The two `synthetic_*.mp3` files are deterministic
in-repo edge-case streams (escape-heavy MPEG-1; low-bitrate MPEG-2) built
by `tests/util_synth.py`; regenerate + re-verify everything with
`make conformance`.
"""
    )
    print(f"wrote {outdir}/REPORT.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
