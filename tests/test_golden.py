"""Pinned golden PCM vectors: exactness as a regression gate.

The reference's acceptance bar is bit-exact PCM (BASELINE.md); with no Go
toolchain or mpg123 at hand the external oracle cannot run, so the full
decodes of the two generated fixture streams (tests/conftest.py, from
go_mp3_tpu.synth) are FROZEN as SHA-256 pins
(tests/golden/pcm_sha256.json). Any change that drifts a single output
byte of the exact (C++ reference-order f32) or golden (numpy f64) backend
fails these tests, and so does any change to the generator's bytes; the
device (JAX) backend is held to the exact backend per-sample with an
explicit bound. To re-pin after an intended change, decode each fixture
with Decoder(data, backend=...).read_all() and store its SHA-256 and
length under "<fixture>.<backend>".

Model: compliance_test.go:30-45 (the ISO thresholds these pins substitute
for, given the missing oracle).
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from go_mp3_tpu import Decoder

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "pcm_sha256.json").read_text()
)

try:
    from go_mp3_tpu.native import lib as native

    HAVE_NATIVE = native.available()
except Exception:
    HAVE_NATIVE = False


def _fixture(request, name):
    return request.getfixturevalue(f"fixture_{name}")


@pytest.mark.parametrize("name", ["classic_lame", "mpeg2"])
@pytest.mark.parametrize("backend", ["exact", "golden"])
def test_full_decode_matches_pinned_hash(request, name, backend):
    if backend == "exact" and not HAVE_NATIVE:
        pytest.skip("native lib not built")
    data = _fixture(request, name)
    d = Decoder(data, backend=backend)
    pcm = d.read_all()
    pin = GOLDEN[f"{name}.{backend}"]
    assert len(pcm) == pin["bytes"]
    assert hashlib.sha256(pcm).hexdigest() == pin["sha256"], (
        f"{backend} backend PCM drifted from the pinned golden vector for "
        f"{name} — exactness regression"
    )


@pytest.mark.parametrize("name", ["classic_lame", "mpeg2"])
def test_device_backend_within_bound_of_exact_full_file(request, name):
    """Full-file per-sample bound, device (batched JAX DSP) vs exact.

    Bound rationale: the device path runs f32 matmul reductions in a
    different (batched) summation order than the reference's serial f32
    loops; the worst observed divergence on full decodes of both fixtures
    is 2 LSB, which is also the ISO/IEC 11172-4 "full compliance" maxdiff
    (compliance_test.go:30-35). Pinned here so any regression past the
    compliance ceiling fails.
    """
    if not HAVE_NATIVE:
        pytest.skip("native lib not built")
    data = _fixture(request, name)
    de = Decoder(data, backend="exact")
    dd = Decoder(data, backend="device")
    a = np.frombuffer(de.read_all(), "<i2").astype(np.int32)
    b = np.frombuffer(dd.read_all(), "<i2").astype(np.int32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2
