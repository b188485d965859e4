import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SHIMS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_shims")

if SRC not in sys.path:
    sys.path.insert(0, SRC)

# Older JAX lacks jax.sharding.AxisType / make_mesh(axis_types=...);
# importing the compat module patches them in-process before any test
# does ``from jax.sharding import AxisType``.
import repro.distributed.jax_compat  # noqa: E402,F401

# Prefer a real hypothesis installation; fall back to the vendored shim
# (tests/_shims) when the container doesn't have it.
try:
    import hypothesis  # noqa: F401
except ImportError:                                    # pragma: no cover
    sys.path.append(SHIMS)

# run in subprocesses *before* their first ``from jax.sharding import``:
_SUBPROC_PREAMBLE = "import repro.distributed.jax_compat\n"

# the static-analysis fixture mini-trees contain deliberately broken
# files (some named test_*.py inside their fake tests/ dirs); they are
# analyzer *inputs*, never test modules
collect_ignore = ["fixtures"]


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run the heavy nightly-profile sweeps (marked slow)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy hypothesis sweeps (nightly profile; needs --runslow)")
    config.addinivalue_line(
        "markers",
        "chaos: deep fault-injection sweeps (nightly profile; "
        "needs --runslow)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="nightly-profile sweep: "
                                        "pass --runslow to run")
    for item in items:
        if "slow" in item.keywords or "chaos" in item.keywords:
            item.add_marker(skip_slow)


def run_subprocess(code: str, devices: int = 8, timeout: int = 900):
    """Run python code in a subprocess with a forced multi-device host
    platform (tests in-process must keep the default single device)."""
    env = os.environ.copy()
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    r = subprocess.run([sys.executable, "-c", _SUBPROC_PREAMBLE + code],
                       capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, \
        f"subprocess failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


@pytest.fixture
def subproc():
    return run_subprocess


@pytest.fixture(autouse=True)
def _ownership_sanitizer():
    """Wires the ownership-write sanitizer (repro.core.sanitize) into
    every tier-1 test: under ``REPRO_SANITIZE=1`` the module enables
    itself at import and every cluster built during the test runs with
    write-barriered caches.  Either way, the owner-context stack must
    unwind by test end -- a leak means some engine path pushed a
    context it never popped."""
    from repro.core import sanitize
    yield
    assert not sanitize._CTX, "sanitizer context stack leaked"
