"""The compliance harness itself (tools/compliance.py), wired against the
framework's own backends as oracle — the same two-phase alignment + ISO
verdict machinery as compliance_test.go, runnable against any external
decoder via --oracle-cmd when one exists."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import compliance  # noqa: E402

try:
    from go_mp3_tpu.native import lib as native

    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False


@pytest.mark.parametrize("name", ["classic_lame", "mpeg2"])
def test_device_vs_golden_full_compliance(request, name, tmp_path):
    data_path = tmp_path / f"{name}.mp3"
    data_path.write_bytes(request.getfixturevalue(f"fixture_{name}"))
    result = compliance.run(str(data_path), "device", "golden", None)
    assert result["verdict"] == "FULL COMPLIANCE", result
    assert result["offset"] == 0  # same decoder family: no delay skew


def test_alignment_search_recovers_known_offset(fixture_classic_lame):
    """Shift the test stream by a known delay; the two-phase search must
    find it (the encoder-delay situation the reference handles)."""
    from go_mp3_tpu import Decoder

    pcm = Decoder(fixture_classic_lame, backend="golden").read_all()
    ref = compliance._stereo(pcm)
    for shift in (-777, 0, 123, 2000):
        if shift >= 0:
            test = np.concatenate([np.zeros((shift, 2), np.int32), ref])
        else:
            test = ref[-shift:]
        found = compliance.find_best_alignment(ref, test)
        assert found == shift, (shift, found)
        result = compliance.compare(ref, test, found)
        assert result["full"] and result["rms"] == 0.0


def test_verdict_thresholds():
    """FULL / LIMITED / FAIL boundaries on synthetic diffs."""
    rng = np.random.default_rng(0)
    ref = rng.integers(-1000, 1000, size=(50_000, 2)).astype(np.int32)
    # full: zero diff
    r = compliance.compare(ref, ref.copy(), 0)
    assert r["full"] and r["limited"]
    # limited: +8 everywhere (RMS 8 > 4.62 -> fail) ... use sparse 8s
    test = ref.copy()
    test[::100, 0] += 8  # RMS ~0.8, maxdiff 8 -> limited only
    r = compliance.compare(ref, test, 0)
    assert not r["full"] and r["limited"]
    # fail: large diffs
    test = ref.copy()
    test[::10, 0] += 200
    r = compliance.compare(ref, test, 0)
    assert not r["full"] and not r["limited"]
