#!/usr/bin/env python3
"""Interleaved A/B of two libmp3parse variants: alternate full-corpus
parses A,B,A,B,... in ONE process so host drift hits both equally.
Reports min and median process-CPU per variant + the pairwise ratio (the
decision statistic — single-variant timings are noise on a shared host).
The corpus is synth.continuity_corpus(0).

Usage: python tools/parse_ab.py A.so B.so [rounds=9]
Build variants with the FLAGS from tools/build_native.sh."""
import ctypes
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from go_mp3_tpu.synth import continuity_corpus  # noqa: E402

SO_A, SO_B = sys.argv[1], sys.argv[2]
ROUNDS = int(sys.argv[3]) if len(sys.argv) > 3 else 9


def bind(so):
    lib = ctypes.CDLL(so)
    lib.gmp_create.restype = ctypes.c_void_p
    lib.gmp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gmp_destroy.argtypes = [ctypes.c_void_p]
    lib.gmp_parse_packed8_many.restype = ctypes.c_int
    lib.gmp_parse_packed8_many.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    return lib


libs = {"A": bind(SO_A), "B": bind(SO_B)}

streams = continuity_corpus(0)

S, T, NC = len(streams), 240, 13
tail = np.empty((S, T, 1024), np.int8)
head = np.empty((S, T, 128), np.int16)
side = np.empty((S, T, 168), np.uint8)
valids = np.zeros(S, np.int32)
err = ctypes.c_int32(-1)


def one(lib):
    ps = [lib.gmp_create(d, len(d)) for d in streams]
    handles = (ctypes.c_void_p * S)(*ps)
    c0 = time.process_time()
    for _ in range(NC):
        r = lib.gmp_parse_packed8_many(
            handles, S, T,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            head.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            side.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            valids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(err))
        assert r >= 0, r
    dt = time.process_time() - c0
    for p in ps:
        lib.gmp_destroy(p)
    return dt


one(libs["A"]), one(libs["B"])  # warm both code paths + pool pages
res = {"A": [], "B": []}
for r in range(ROUNDS):
    for k in ("A", "B") if r % 2 == 0 else ("B", "A"):
        res[k].append(one(libs[k]))
mA, mB = min(res["A"]), min(res["B"])
print(f"A {SO_A}: min {mA:.3f} med {statistics.median(res['A']):.3f}")
print(f"B {SO_B}: min {mB:.3f} med {statistics.median(res['B']):.3f}")
print(f"B/A min ratio {mB/mA:.4f}   "
      f"pairwise-med {statistics.median([b/a for a, b in zip(res['A'], res['B'])]):.4f}")
