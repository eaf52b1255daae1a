"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite checks numerics and sharding on host-platform virtual devices;
what needs a GPU is checked by chip_smoke.py on the card.
"""

import os

# Force CPU whatever the outer environment selects (both the variable and
# config.update, which also wins over a platform picked before import).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax as _jax

_jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

# Persistent XLA compilation cache: first run compiles (~30-60 s per distinct
# chunk shape on CPU), subsequent runs are fast.
import jax

from go_mp3_tpu.synth import MONO, STEREO, generate_stream
from go_mp3_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()
assert jax.devices()[0].platform == "cpu", "tests must run on virtual CPU mesh"

# The two recorded LAME files the project was first checked against. They
# are not part of the repository; the few tests that assert their own
# facts (frame counts, the LAME tag) run only where a developer has put
# them here.
REFERENCE_FILES = pathlib.Path(__file__).parent / "reference"


@pytest.fixture(scope="session")
def fixture_classic_lame() -> bytes:
    """A generated MPEG-1 44.1 kHz joint-stereo VBR stream, 385 frames
    (~10.1 s), the shape of the classic_lame.mp3 reference file."""
    return generate_stream(STEREO, 385, seed=1)


@pytest.fixture(scope="session")
def fixture_mpeg2() -> bytes:
    """A generated MPEG-2 22.05 kHz mono VBR stream, 2872 frames (~75 s),
    the shape of the mpeg2.mp3 reference file."""
    return generate_stream(MONO, 2872, seed=2)


def _reference_file(name: str) -> bytes:
    p = REFERENCE_FILES / name
    if not p.exists():
        pytest.skip(f"{name} (recorded reference file) is not in the repository")
    return p.read_bytes()


@pytest.fixture(scope="session")
def reference_classic_lame() -> bytes:
    return _reference_file("classic_lame.mp3")


@pytest.fixture(scope="session")
def reference_mpeg2() -> bytes:
    return _reference_file("mpeg2.mp3")
