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
from repro_torch import device, optim, state  # noqa: E402
from repro_torch.core import DinomoCluster  # noqa: E402
from repro_torch.core import scenarios  # noqa: E402
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402
from repro_torch.kernels import cache_transition as tct  # noqa: E402
from repro_torch.kvcache import paged_store  # noqa: E402
from repro_torch.launch.serve import PagedServer  # noqa: E402
from repro_torch.models import (encdec, mamba2, ssm_lm,  # noqa: E402
                                transformer, zamba2)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.embedding import build_replica  # noqa: E402
from repro_torch.launch.elastic import resize  # noqa: E402
from repro_torch.launch.train import make_host_mesh, train  # noqa: E402
from repro_torch.models.model_zoo import (build_model,  # noqa: E402
                                          make_batch)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + \
    sorted((REPO / "examples").glob("*_torch.py"))
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
# the modules of the cluster slice (the host engine and what it imports
# beside the pool), which the scan must reach as well
CLUSTER_SLICE = ("core/cluster.py", "core/ownership.py", "core/mnode.py",
                 "core/netmodel.py", "core/hashring.py")
# the modules of the compiled batch engine's slice (the engine and
# kernel E's package), which the scan must reach too
JIT_SLICE = ("core/jit_engine.py", "kernels/batch_executor/__init__.py",
             "kernels/batch_executor/ops.py",
             "kernels/batch_executor/ref.py")
# the modules of the planes around the cluster (the timed simulation,
# the request plane, the scenario harness, the linearizability checker),
# which the scan must reach as well
PLANES_SLICE = ("core/linearizability.py", "core/requestplane.py",
                "core/simulate.py", "core/scenarios.py",
                "core/netmodel.py", "data/ycsb.py")
# the modules of the attention families' slice (the MoE feed-forward, the
# dense-cache decode, the step functions and the configs it adds), which
# the scan must reach as well
FAMILIES_SLICE = ("models/moe.py", "models/transformer.py",
                  "models/layers.py", "models/model_zoo.py",
                  "launch/steps.py", "launch/serve.py",
                  "configs/llama3_2_3b.py", "configs/internlm2_20b.py",
                  "configs/nemotron_4_15b.py", "configs/chameleon_34b.py",
                  "configs/olmoe_1b_7b.py",
                  "configs/granite_moe_1b_a400m.py")
# the modules of the hybrid and encoder-decoder families' slice, which the
# scan must reach as well
HYBRID_ENCDEC_SLICE = ("models/__init__.py", "models/zamba2.py",
                       "models/encdec.py", "configs/zamba2_1_2b.py",
                       "configs/seamless_m4t_medium.py")
# the modules of the training slice (the optimizer, the losses and the
# train step, the state carried across), which the scan must reach too
TRAIN_SLICE = ("optim/__init__.py", "optim/adamw.py", "launch/steps.py",
               "state.py", "models/layers.py", "models/transformer.py",
               "models/ssm_lm.py", "models/zamba2.py", "models/encdec.py",
               "kernels/flash_attention/flash_attention.py",
               "kernels/flash_attention/ops.py",
               "kernels/ssd_scan/ssd_scan.py")
# the modules of the training loop's slice (the loader, the checkpoint
# store, the driver, the elastic restore, the hot-row replica), which the
# scan must reach as well
LOOP_SLICE = ("data/__init__.py", "data/lm_data.py",
              "checkpoint/__init__.py", "checkpoint/ckpt.py", "state.py",
              "launch/train.py", "launch/elastic.py",
              "embedding/__init__.py", "embedding/hot_rows.py")
# the modules of the launch side (meshes, partition rules, the step
# builders, the dry run and its op analysis, the long-sequence attention)
# and the examples, which the scan must reach as well
LAUNCH_SLICE = ("launch/mesh.py", "launch/steps.py", "launch/dryrun.py",
                "launch/op_analysis.py", "launch/train.py",
                "launch/elastic.py", "distributed/__init__.py",
                "distributed/sharding.py", "distributed/act_sharding.py",
                "configs/base.py", "kernels/flash_attention/ref.py",
                "kernels/flash_attention/ops.py", "device.py")
# the modules of the static analysis (its core, CLI and six passes), which
# the scan must reach as well
ANALYSIS_SLICE = ("analysis/__init__.py", "analysis/__main__.py",
                  "analysis/passes/__init__.py",
                  "analysis/passes/plan_purity.py",
                  "analysis/passes/crash_points.py",
                  "analysis/passes/fence_coverage.py",
                  "analysis/passes/determinism.py",
                  "analysis/passes/kernel_hygiene.py",
                  "analysis/passes/deprecations.py")
EXAMPLES = ("quickstart_torch.py", "kvs_elasticity_torch.py",
            "serve_paged_torch.py", "train_elastic_torch.py")
# the card's machine has no ml_dtypes: bf16 goes through torch's views
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
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


def test_the_scan_reaches_the_cluster_slice():
    for name in CLUSTER_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_jit_slice():
    for name in JIT_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_planes_slice():
    for name in PLANES_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_families_slice():
    for name in FAMILIES_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_hybrid_and_encdec_slice():
    for name in HYBRID_ENCDEC_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_train_slice():
    for name in TRAIN_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_loop_slice():
    for name in LOOP_SLICE:
        assert PORT / name in PORT_FILES, name


def test_the_scan_reaches_the_launch_slice_and_the_examples():
    for name in LAUNCH_SLICE:
        assert PORT / name in PORT_FILES, name
    for name in EXAMPLES:
        assert REPO / "examples" / name in PORT_FILES, name


def test_the_scan_reaches_the_analysis_slice():
    for name in ANALYSIS_SLICE:
        assert PORT / name in PORT_FILES, name
    assert sorted(p.relative_to(PORT).as_posix() for p in PORT_FILES
                  if p.is_relative_to(PORT / "analysis")) == \
        sorted(ANALYSIS_SLICE)


def test_meta_only_when_asked_for(monkeypatch):
    """resolve_device gives meta when asked, and the card otherwise (so
    raises with none); the wrappers take plain versions on meta as on the
    CPU, and refuse a mix."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.resolve_device("meta").type == "meta"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    assert device.on_cuda(torch.zeros(1, device="meta")) is False
    with pytest.raises(ValueError, match="mixed"):
        device.on_cuda(torch.zeros(1, device="meta"), torch.zeros(1))


def test_optimizer_state_follows_its_params(monkeypatch):
    """optim.init_state makes its state on the parameters' device and asks
    for no card: meta parameters give meta moments even with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"layers": [{"w": torch.zeros((2, 3), device="meta")}]}
    opt_state = optim.init_state(params)
    assert opt_state["step"].device.type == "meta"
    assert opt_state["mu"]["layers"][0]["w"].device.type == "meta"


def test_every_kernel_package_has_ref_and_parity_test():
    kernels = sorted(p for p in (PORT / "kernels").iterdir()
                     if p.is_dir() and not p.name.startswith("_"))
    assert [k.name for k in kernels] == ["batch_executor",
                                         "cache_transition", "clht_probe",
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
                       "fused_window.cu",
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
    lambda: state.opt_state_from_jax({"mu": {"layers": {}},
                                      "nu": {"layers": {}}, "step": 0}, None),
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
    lambda: DinomoCluster(num_kns=1, num_buckets=8),
    lambda: scenarios.run_scenario("crash", "dinomo", smoke=True),
    lambda: scenarios.run_overload(smoke=True),
    lambda: scenarios.run_suite(smoke=True),
    lambda: build_model(get_smoke_config("olmoe-1b-7b")).init(0),
    lambda: transformer.init_cache(get_smoke_config("llama3.2-3b"), 1, 4),
    lambda: transformer.init_cache_v2(get_smoke_config("llama3.2-3b"), 1, 4),
    lambda: build_model(get_smoke_config("chameleon-34b")).init_cache(1, 4),
    lambda: steps.init_cache(get_smoke_config("llama3.2-3b"), 1, 4, "v3"),
    lambda: make_batch(get_smoke_config("llama3.2-3b"), 1, 4),
    lambda: PagedServer("olmoe-1b-7b"),
    lambda: zamba2.init_params(0, get_smoke_config("zamba2-1.2b")),
    lambda: zamba2.init_cache(get_smoke_config("zamba2-1.2b"), 1, 4),
    lambda: build_model(get_smoke_config("zamba2-1.2b")).init_cache(1, 4),
    lambda: encdec.init_params(0, get_smoke_config("seamless-m4t-medium")),
    lambda: encdec.init_cache(get_smoke_config("seamless-m4t-medium"), 1, 4,
                              4),
    lambda: steps.init_cache(get_smoke_config("seamless-m4t-medium"), 1, 4),
    lambda: make_batch(get_smoke_config("seamless-m4t-medium"), 1, 4),
    lambda: train("qwen1.5-0.5b", steps=1, batch=1, seq=8),
    lambda: build_replica(np.zeros((4, 2), np.float32), np.array([1]), 2),
    lambda: make_host_mesh(),
])
def test_entry_points_need_a_card_unless_asked_for_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert device.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", [
    lambda store, tree: store.restore(tree),
    lambda store, tree: resize(store, tree),
], ids=["CheckpointStore.restore", "resize"])
def test_restores_need_a_card_unless_asked_for_cpu(entry, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = CheckpointStore(str(tmp_path), async_flush=False)
    tree = {"w": torch.ones(3)}
    store.save(1, tree).result()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(store, tree)
    got, _, _ = store.restore(tree, device="cpu")
    assert got["w"].device.type == "cpu"


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
