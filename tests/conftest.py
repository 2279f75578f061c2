"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-chip sharding paths are
exercised without a GPU: the CPU is pinned before JAX initialises. A
process that already imported JAX before pytest started (``chip_smoke.py``
runs the ``gpu``-marked tests in-process on the card) keeps its platform.
"""

import os
import pathlib
import shutil
import subprocess
import sys

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def _map_count() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


# Every jitted executable keeps live JIT code mappings; a full-suite run
# accumulates ~60 new mappings/s and deterministically segfaults inside an
# XLA compile at ~79% when the process hits the kernel's vm.max_map_count
# ceiling (65530 by default). Drop compiled executables once we get near the
# ceiling; correctness state is unaffected — only recompiles.
_MAP_CLEAR_THRESHOLD = 40_000


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    try:
        high = _map_count() > _MAP_CLEAR_THRESHOLD
    except OSError:
        return
    if high:
        import gc

        jax.clear_caches()
        gc.collect()

# The upstream AAD checkout serving as conformance oracle (fixtures +
# buildable C sources). Overridable so CI can clone it anywhere
# (github.com/aikiriao/AAD).
REFERENCE_DIR = pathlib.Path(
    os.environ.get("AAD_TPU_REFERENCE_DIR", "/root/reference")
)
FIXTURE_DIR = REFERENCE_DIR / "test"


@pytest.fixture(scope="session")
def fixture_dir():
    if not FIXTURE_DIR.is_dir():
        pytest.skip("reference fixture corpus not available")
    return FIXTURE_DIR


@pytest.fixture(scope="session")
def reference_cli(tmp_path_factory):
    """Build the reference codec out-of-tree and return the binary path.

    Used purely as a conformance oracle (never linked or vendored). Skips
    when the reference sources or a C compiler are unavailable.
    """
    if not REFERENCE_DIR.is_dir() or shutil.which("gcc") is None:
        pytest.skip("reference sources or gcc not available")
    build = tmp_path_factory.mktemp("refbuild")
    src = build / "src"
    shutil.copytree(REFERENCE_DIR / "src", src)
    shutil.copy(REFERENCE_DIR / "Makefile", build / "Makefile")
    try:
        subprocess.run(
            ["make", "-s"], cwd=build, check=True, capture_output=True, timeout=120
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"reference build failed: {e}")
    binary = build / "aad"
    if not binary.exists():
        pytest.skip("reference binary missing after build")
    return binary


@pytest.fixture(scope="session")
def fused_engine():
    """The fused decode engine as this platform runs it: compiled on a GPU,
    interpreted elsewhere."""
    return "fused" if jax.default_backend() == "gpu" else "fused_interpret"


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (for tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
