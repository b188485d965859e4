"""Structural rules of the port (src/repro_torch and chip_smoke.py):
it imports neither JAX nor the reference package, every kernel package
ships a plain torch ref.py and is named in a parity test, and its entry
points run on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch import device, state  # noqa: E402
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402
from repro_torch.kernels import cache_transition as tct  # noqa: E402
from repro_torch.kvcache import paged_store  # noqa: E402
from repro_torch.launch.serve import PagedServer  # noqa: E402
from repro_torch.models import mamba2, ssm_lm, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
# the modules of the KN window slice, which the scan must reach
KN_SLICE = ("core/dac.py", "core/cluster.py", "core/transition.py",
            "kernels/cache_transition/__init__.py",
            "kernels/cache_transition/cache_transition.py",
            "kernels/cache_transition/ops.py",
            "kernels/cache_transition/ref.py")
# the modules of the DPM pool slice (the pool, what it imports, and the
# planned merge on the card's table), which the scan must reach too
DPM_POOL_SLICE = ("core/dpm_pool.py", "core/faults.py", "core/sanitize.py",
                  "core/clht.py", "core/log.py", "core/transition.py",
                  "kernels/clht_probe/ops.py", "kernels/log_merge/ops.py")
FORBIDDEN = ("jax", "jaxlib", "repro")
# the one environment variable the port reads: the ownership sanitizer's
# switch, the reference's own (it chooses no device)
SANITIZE_SWITCH = 'os.environ.get("REPRO_SANITIZE", "0")'


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_reaches_the_kn_window_slice():
    for name in KN_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_dpm_pool_slice():
    for name in DPM_POOL_SLICE:
        assert PORT / name in PORT_FILES, name


def test_every_kernel_package_has_ref_and_parity_test():
    kernels = sorted(p for p in (PORT / "kernels").iterdir()
                     if p.is_dir() and not p.name.startswith("_"))
    assert [k.name for k in kernels] == ["cache_transition", "clht_probe",
                                         "decode_attention",
                                         "flash_attention", "log_merge",
                                         "ssd_scan"]
    tests = "\n".join(p.read_text()
                      for p in (REPO / "tests").glob("test_torch_*.py"))
    for k in kernels:
        assert (k / "ref.py").exists(), f"{k.name} has no ref.py"
        assert f"repro_torch.kernels import {k.name}" in tests, \
            f"{k.name} is named in no parity test"
    sources = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sources == ["cache_transition.cu", "clht_insert.cu",
                       "clht_probe.cu", "flash_attention.cu",
                       "log_merge.cu", "paged_decode_attention.cu",
                       "ssd_scan.cu"]


@pytest.mark.parametrize("entry", [
    lambda: tc.clht_init(8),
    lambda: tl.segment_init(8),
    lambda: tl.heap_init(8, 4),
    lambda: state.from_jax_arrays(heap={"data": [[1]], "head": 0}),
    lambda: device.resolve_device(),
    lambda: device.resolve_device("cuda"),
    lambda: transformer.init_params(0, get_smoke_config("qwen1.5-0.5b")),
    lambda: paged_store.pool_init(1, 2, 4, 1, 16),
    lambda: PagedServer("qwen1.5-0.5b"),
    lambda: state.params_from_jax({"layers": {}}, None),
    lambda: ssm_lm.init_params(0, get_smoke_config("mamba2-2.7b")),
    lambda: build_model(get_smoke_config("mamba2-2.7b")).init(0),
    lambda: ssm_lm.init_cache(get_smoke_config("mamba2-2.7b"), 1),
    lambda: build_model(get_smoke_config("mamba2-2.7b")).init_cache(1),
    lambda: mamba2.mamba_state_init(get_smoke_config("mamba2-2.7b"), 1),
    lambda: tct.plan_window_transitions(*np.zeros((4, 16), np.int64),
                                        np.zeros(1), 0, 0, cap=4096,
                                        value_bytes=64),
    lambda: DPMPool(),
    lambda: DPMPool(num_buckets=8, device="cuda"),
])
def test_entry_points_need_a_card_unless_asked_for_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert device.resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_mixed_devices():
    with pytest.raises(ValueError, match="mixed"):
        device.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_no_env_switch_in_the_port():
    for path in PORT_FILES:
        text = path.read_text()
        if path == PORT / "core" / "sanitize.py":
            assert text.count(SANITIZE_SWITCH) == 1
            text = text.replace(SANITIZE_SWITCH, "")
        assert "os.environ" not in text and "getenv" not in text, path
