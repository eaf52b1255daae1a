#!/usr/bin/env python3
"""Extended fuzz soak: packed8 vs int16 native parse parity on mutants.

test_fuzz.py's parity gate compares the PYTHON parser against the native
int16 interface on bit-flipped streams; this soak additionally pins the
packed8 interface (int8 tail + head plane + byte sidecar — the interface
the corpus pipeline ships) against the int16 parse on every mutant:
reconstructed spectra must be byte-identical wherever no int8 overflow
fired, and OverflowError must only fire when the int16 values really
exceed the tail's int8 range.

Usage: python tools/fuzz_soak.py [n_mutants_per_fixture=200] [seed0=0]
Exits nonzero on any mismatch.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from go_mp3_tpu.consts import (  # noqa: E402
    HEAD_LINES,
    HEAD_WIDTH,
    SIDE8_WIDTH,
    SP8_TAIL_WIDTH,
)
from go_mp3_tpu.native import lib as native  # noqa: E402


def packed8_all(data: bytes):
    """Parse a whole stream through the packed8 interface; returns
    (spectra int16 [n,2,576], side8 [n, SIDE8_WIDTH]) or None on
    overflow (with the parser's sticky flag checked by the caller)."""
    p = native.NativeParser(data)
    sp8 = np.zeros((8192, SP8_TAIL_WIDTH), np.int8)
    hd = np.zeros((8192, HEAD_WIDTH), np.int16)
    sd = np.zeros((8192, SIDE8_WIDTH), np.uint8)
    got = 0
    try:
        while True:
            k = p.parse_packed8_into(sp8[got:], hd[got:], sd[got:])
            if k == 0:
                break
            got += k
    except OverflowError:
        p.close()
        return None
    except ValueError:
        p.close()
        return "error"
    p.close()
    head = hd[:got].reshape(got, 2, HEAD_LINES)
    tail = sp8[:got].reshape(got, 2, 576 - HEAD_LINES).astype(np.int16)
    return np.concatenate([head, tail], axis=2), sd[:got]


def main() -> int:
    n_mut = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 0

    from go_mp3_tpu.synth import MONO, STEREO, generate_stream

    fixtures = {
        "classic": generate_stream(STEREO, 385, seed=1)[:60_000],
        "mpeg2": generate_stream(MONO, 2872, seed=2)[:60_000],
    }

    checked = overflowed = errored = 0
    for fname, base in fixtures.items():
        for i in range(n_mut):
            rng = random.Random(seed0 + i * 7919 + hash(fname) % 1000)
            m = bytearray(base)
            for _ in range(rng.randint(1, 60)):
                pos = rng.randrange(len(m))
                m[pos] ^= 1 << rng.randrange(8)
            m = bytes(m)

            # int16 reference parse
            p = native.NativeParser(m)
            try:
                sp16, sfl, sfs, me = p.parse_all()
            except ValueError:
                p.close()
                r = packed8_all(m)
                if r is not None and r != "error":
                    print(f"FAIL {fname}#{i}: int16 errored, packed8 did not")
                    return 1
                errored += 1
                continue
            finally:
                p.close()

            r = packed8_all(m)
            if r == "error":
                print(f"FAIL {fname}#{i}: packed8 errored, int16 did not")
                return 1
            n = sp16.shape[0]
            ref = sp16.reshape(n, 2, 576)
            if r is None:
                # overflow fallback must be justified: some tail line of
                # the int16 parse must exceed int8 range
                tail_ref = ref[:, :, HEAD_LINES:]
                if not ((tail_ref > 127) | (tail_ref < -128)).any():
                    print(f"FAIL {fname}#{i}: overflow fired with no "
                          f"out-of-range tail line")
                    return 1
                overflowed += 1
                continue
            spec8, sd = r
            if spec8.shape[0] != n:
                print(f"FAIL {fname}#{i}: granule count {spec8.shape[0]} "
                      f"vs int16 {n}")
                return 1
            if not np.array_equal(spec8, ref):
                bad = np.argwhere(spec8 != ref)[:3]
                print(f"FAIL {fname}#{i}: spectra mismatch at {bad.tolist()}")
                return 1
            # sidecar scalefactors must match the int16 parse's outputs
            if not np.array_equal(
                sd[:, 44:88].astype(np.int8).astype(np.int32),
                sfl.reshape(n, 44),
            ):
                print(f"FAIL {fname}#{i}: scalefac_l mismatch")
                return 1
            checked += 1
    print(f"OK: {checked} parity-checked, {overflowed} overflow-fallbacks "
          f"(all justified), {errored} hard-errors (both parsers agree)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
