"""Deployment-surface smoke: the wheel must build and work standalone.

The framework ships as a pure-Python wheel whose native engine sources
(aadx.cc/aadx.h/Makefile, declared in pyproject [tool.setuptools.package-data])
auto-build on first use at the install site. This test builds the wheel
with pip, unpacks it into a clean directory, and — in a subprocess whose
import path contains ONLY the unpacked wheel (the repo checkout must not
leak in) — decodes a golden fixture bit-exactly and round-trips an encode
through the packaged native engine.
"""

import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def unpacked_wheel(tmp_path_factory):
    out = tmp_path_factory.mktemp("wheel")
    # build from a copied tree: --no-build-isolation writes build/ and
    # egg-info into the source dir, which must not dirty the checkout
    src = out / "src"
    src.mkdir()
    import shutil

    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    shutil.copytree(
        REPO / "aad_tpu", src / "aad_tpu",
        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"),
    )
    try:
        subprocess.run(
            [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
             "--no-build-isolation", "-w", str(out)],
            check=True, capture_output=True, timeout=300,
        )
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.fail(f"pip wheel failed:\n{e.stderr.decode()[-2000:]}")
    wheels = list(out.glob("aad_tpu-*.whl"))
    assert len(wheels) == 1, f"expected one wheel, got {wheels}"
    site = out / "site"
    with zipfile.ZipFile(wheels[0]) as zf:
        zf.extractall(site)
    return site


def test_wheel_contains_native_sources(unpacked_wheel):
    native = unpacked_wheel / "aad_tpu" / "native"
    for name in ("aadx.cc", "aadx.h", "Makefile", "__init__.py"):
        assert (native / name).exists(), f"wheel is missing native/{name}"
    # prebuilt artifacts must NOT ship (the .so is host-specific)
    assert not list(native.glob("*.so")), "wheel must not package a .so"


def test_wheel_decodes_golden_and_round_trips(unpacked_wheel, fixture_dir):
    script = """
import sys, os
site = sys.argv[1]
# only the unpacked wheel on the path (plus the stdlib/site-packages deps)
sys.path.insert(0, site)
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import aad_tpu
assert aad_tpu.__file__.startswith(site), aad_tpu.__file__

data = open(sys.argv[2], "rb").read()
from aad_tpu.format.wav import read_wav
header, pcm = aad_tpu.decode(data)
_, golden = read_wav(sys.argv[3])
assert np.array_equal(pcm, golden >> 16), "golden decode mismatch from wheel"

# native engine auto-builds from the packaged sources at the install site
from aad_tpu import native
assert native.available(), "packaged native sources failed to build"
cfg = aad_tpu.EncodeConfig(num_channels=2, sampling_rate=8000,
                           max_block_size=128)
rng = np.random.default_rng(0)
pcm2 = rng.integers(-2048, 2048, (2, 700)).astype(np.int32)
enc = native.encode(pcm2, cfg)
h2, dec = aad_tpu.decode(enc, engine="scan")
assert dec.shape == (2, 700)
print("WHEEL_OK")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script, str(unpacked_wheel),
         str(fixture_dir / "sin300Hz.aad"),
         str(fixture_dir / "sin300Hz_decoded.wav")],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "WHEEL_OK" in proc.stdout, (
        f"stdout:\n{proc.stdout[-1000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
