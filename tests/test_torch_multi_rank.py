"""The port's multi-device paths on worlds of gloo ranks on the CPU: the
mesh of ranks (``launch/mesh.py:make_mesh``), the collectives
(``distributed/collectives.py``), placement (``distributed/sharding.py``),
the expert-parallel MoE (``models/moe.py:moe_ff_sharded``), the
partitioned train step (``launch/steps.py``) and the restore across meshes
(``checkpoint/ckpt.py``, ``launch/elastic.py:resize``).

Twins of the reference's multi-device tests: ``tests/test_system.py:101``
(the 2 x 4 train step), ``:135`` (``moe_ff_sharded``) and ``:158`` (the
remesh restore), at their bars, plus the MoE inside a 2 x 4 step against
the reference's own 2 x 4 step (run in a subprocess with 8 host devices).
Beyond them: every collective, forward and gradient, against one process;
the f32 2 x 4 steps against one rank's (the loss within 1e-5 relative,
every gradient leaf within 1e-4 of its max |g|); the data-parallel SSM
step; and the builders' checks. The SSM, hybrid and encoder-decoder
families on a model axis > 1, the prefill and decode bundles and the
training loop on a mesh of ranks are held in
``test_torch_multi_rank_paths.py`` and ``test_torch_multi_rank_twins.py``.
The ranks run ``tests/torch_multi_rank_cases.py``; inputs come from numpy
seeds and the weights from the JAX package through
``state.params_from_jax``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType  # noqa: E402

import torch_multi_rank_cases as mr  # noqa: E402
import torch_train_cases as tc  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.distributed.sharding import make_rules as jax_rules  # noqa: E402
from repro.launch.steps import build_train_step as jax_train_step  # noqa: E402,E501
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro_torch import optim, state  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.ckpt import _leaf_paths  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

MESHES = {"2x4": (2, 4), "1x1": (1, 1)}
B, S = 4, 32                       # ShapeConfig("t", 32, 4, "train")
STEP = {"remat": "full", "loss_chunk": 16}
F32_LOSS_TOL, GRAD_TOL = tc.F32_LOSS_TOL, tc.GRAD_TOL
# the reference's bars: a sharded step's loss (test_system.py:126), the
# MoE (:148), the restored loss in bf16 (:179)
STEP_LOSS_TOL, RESTORE_LOSS_TOL = 2e-2, 1e-2


def world(mshape) -> int:
    return int(np.prod(mshape))


def np_batch(cfg, seed: int) -> dict:
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# collectives and placement
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    """Each mesh's ranks' collectives, run once for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            mshape = MESHES[name]
            runs[name] = mr.run_ranks(tmp_path_factory.mktemp("coll"),
                                      world(mshape), mr.collectives_case,
                                      mshape, 11)
        return runs[name]
    return get


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("op", sorted(mr.COLLECTIVES))
def test_collective_matches_one_process(collective_runs, mesh_name, op):
    """Each rank's output, and the gradient of the sum over ranks of
    sum(w_r * y_r) with respect to its input, against the same computed in
    one process on every rank's tensors."""
    mshape = MESHES[mesh_name]
    outs = collective_runs(mesh_name)
    _, shape = mr.COLLECTIVES[op]
    xs = [mr.rank_input(11, r, shape) for r in range(world(mshape))]
    ws = [mr.rank_input(12, r, o[op][0].shape) for r, o in enumerate(outs)]
    ys, gs = mr.emulate(op, xs, ws, mshape)
    for r, o in enumerate(outs):
        y, g = o[op]
        np.testing.assert_allclose(y, ys[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g, gs[r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mshape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_place_gather_and_global_norm(tmp_path, mshape):
    """A tree placed by its train specs comes back whole through
    ``gather_tree`` bit for bit; each block has its spec's shard shape;
    ``global_norm`` of the blocks equals the whole tree's, each element
    counted once (the replicated ``odd`` leaf and the model-only ones
    included); ``make_host_mesh`` is the reference's (n/2, 2) mesh of
    ranks."""
    outs = mr.run_ranks(tmp_path, world(mshape), mr.norm_case, mshape, 3)
    for o in outs:
        assert o["round_trip"]
        assert o["host_mesh"] == (4, 2)
        np.testing.assert_allclose(o["norm"], o["whole_norm"], rtol=1e-6)
    assert outs[0]["local_shapes"] == outs[0]["shard_shapes"]
    assert {o["odd_holder"] for o in outs} == {True, False}


@pytest.mark.parametrize("mshape,all_to_alls", [((2, 4), 2), ((4, 1), 0)],
                         ids=["2x4-expert-parallel", "4x1-gathered"])
def test_moe_ff_on_ranks_matches_the_reference(tmp_path, mshape, all_to_alls):
    """Twin of tests/test_system.py:135: olmoe's smoke MoE layer, x (4, 16,
    d) f32 x 0.1, capacity 8.0: the port's ``moe_ff`` on 8 ranks (2 x 4,
    ``moe_ff_sharded``: two all-to-alls) against the reference's
    ``_moe_ff_ref``, at its bars; and on 4 ranks of a model axis of 1,
    where the reference routes the whole batch and the port gathers it to
    every rank (no all-to-all)."""
    cfg = jax_smoke("olmoe-1b-7b")
    p = jmoe.moe_init(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32) * 0.1
    y_ref, aux_ref = jmoe._moe_ff_ref(p, x, cfg, capacity_factor=8.0)
    # the bf16 experts in f32 (exact): torch multiplies no mixed types
    p_np = {k: np.asarray(v, np.float32) for k, v in p.items()}
    nd, nm = mshape
    outs = mr.run_ranks(tmp_path, world(mshape), mr.moe_case, mshape, p_np,
                        np.asarray(x), 8.0)
    y = np.concatenate([np.concatenate([outs[d * nm + m]["y"]
                                        for m in range(nm)], axis=1)
                        for d in range(nd)], axis=0)
    np.testing.assert_allclose(np.asarray(y_ref), y, atol=2e-5, rtol=2e-4)
    for o in outs:
        np.testing.assert_allclose(o["expert_load"],
                                   np.asarray(aux_ref["expert_load"]),
                                   rtol=1e-6)
        assert o["calls"]["all_to_all"] == all_to_alls


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def run_step(tmp_path, arch, mshape, f32, steps_n=1, seed=7):
    """(port cfg, carried reference params, the port's params, batch, the
    ranks' step_case results)."""
    jcfg, cfg, jp, tp = tc.carried(arch, seed=seed, **STEP)
    params_np = state.params_to_numpy(tp, cfg)
    batch = np_batch(cfg, seed)
    outs = mr.run_ranks(tmp_path, world(mshape), mr.step_case, arch, mshape,
                        params_np, batch, f32, STEP, steps_n)
    return jcfg, cfg, jp, tp, batch, outs


def test_sharded_step_matches_the_single_device_reference(tmp_path):
    """Twin of tests/test_system.py:101: llama3.2-3b's smoke config,
    ShapeConfig("t", 32, 4, "train"), remat "full", loss_chunk 16: the
    port's (2, 4) step (bf16, the gathered-sequence attention: 6 heads and
    2 KV heads on M = 4) against the reference's single-device
    ``build_train_step``."""
    jcfg, cfg, jp, _, batch, outs = run_step(tmp_path, "llama3_2_3b", (2, 4),
                                             f32=False)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    bundle = jax_train_step(jcfg, JaxShape("t", S, B, "train"),
                            jax_rules(mesh))
    with mesh:
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings)
        _, _, metrics = fn(jp, jax_init_state(jp), jax_batch(batch))
    want = float(metrics["loss"])
    for o in outs:
        assert abs(o["steps"][0]["loss"] - want) < STEP_LOSS_TOL, \
            (o["steps"][0]["loss"], want)
    assert outs[0]["calls"]["all_to_all"] == 0


@pytest.mark.parametrize("arch,mshape", [
    ("llama3_2_3b", (2, 4)), ("qwen1_5_0_5b", (2, 4)),
    ("mamba2_2_7b", (4, 1))], ids=["llama3.2-3b-2x4", "qwen1.5-0.5b-2x4",
                                   "mamba2-2.7b-4x1"])
def test_sharded_step_matches_one_rank_in_f32(tmp_path, arch, mshape):
    """The port's partitioned step in f32 against its (1, 1) step, one
    process: the loss within 1e-5 relative, every gradient leaf (gathered
    whole) within 1e-4 of its max |g|, and after one AdamW step the
    metrics within 1e-5. llama gathers the sequence for attention, qwen (4
    heads on M = 4) moves to the heads layout by all-to-alls, mamba2 runs
    data-parallel (its model axis is 1)."""
    _, cfg, _, tp, batch, outs = run_step(tmp_path, arch, mshape, f32=True)
    tp = tc.as_f32(tp)
    tb = torch_batch(batch)
    loss, _, grads = steps.value_and_grad(tp, tb, cfg)
    want = state.params_to_numpy(grads, cfg)
    for o in outs:
        assert o["local_tokens"] == (B // mshape[0], S // mshape[1])
        assert abs(o["loss"] - float(loss)) <= F32_LOSS_TOL * abs(float(loss))
    worst, where = tc.worst_leaf_gap(outs[0]["grads"], want)
    assert worst < GRAD_TOL, (worst, where)
    _, _, m = steps.train_step(tp, optim.init_state(tp), tb, cfg,
                               optim.AdamWConfig())
    for k, v in m.items():
        for o in outs:
            np.testing.assert_allclose(o["steps"][0][k], float(v),
                                       rtol=F32_LOSS_TOL, atol=1e-12)
    heads = cfg.num_heads % mshape[1] == 0 and \
        cfg.num_kv_heads % mshape[1] == 0 and mshape[1] > 1
    assert (outs[0]["calls"]["all_to_all"] > 0) == heads


def test_moe_step_matches_the_reference_2x4(tmp_path, subproc):
    """olmoe-1b-7b's smoke config on (2, 4), ``moe_ff_sharded`` in every
    layer: the port's step loss against the reference's own (2, 4) step
    (``build_train_step`` jitted with its shardings over 8 host devices,
    in a subprocess), within the reference's sharded-step bar."""
    jcfg = jax_smoke("olmoe-1b-7b").replace(**STEP)
    cfg = get_smoke_config("olmoe-1b-7b").replace(**STEP)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    batch = np_batch(cfg, 5)
    np.save(os.path.join(tmp_path, "tokens.npy"), batch["tokens"])
    out = subproc(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import make_rules
from repro.launch.steps import build_train_step
from repro.models import build_model
from repro.optim import init_state

cfg = get_smoke_config("olmoe-1b-7b").replace(remat="full", loss_chunk=16)
params = build_model(cfg).init(jax.random.PRNGKey(0))
tokens = np.load(r'{tmp_path}/tokens.npy').astype(np.int32)
batch = {{"tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
bundle = build_train_step(cfg, ShapeConfig("t", {S}, {B}, "train"),
                          make_rules(mesh))
with mesh:
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                 out_shardings=bundle.out_shardings)
    _, _, m = fn(params, init_state(params), batch)
print("LOSS", repr(float(m["loss"])))
""", devices=8)
    want = float(out.split("LOSS")[1].split()[0])
    outs = mr.run_ranks(tmp_path, 8, mr.step_case, "olmoe-1b-7b", (2, 4),
                        tree, batch, False, STEP, 1)
    for o in outs:
        assert abs(o["steps"][0]["loss"] - want) < STEP_LOSS_TOL, \
            (o["steps"][0]["loss"], want)
        assert o["calls"]["all_to_all"] > 0


# ---------------------------------------------------------------------------
# save under one mesh, restore under another
# ---------------------------------------------------------------------------
def test_remesh_restore(tmp_path):
    """Twin of tests/test_system.py:158: qwen1.5-0.5b's smoke state saved
    under 4 x 2 (8 ranks), restored under 2 x 2 (4 ranks) through
    ``resize``: every leaf gathered back equals the saved one bit for bit,
    the loss within 1e-2 of the reference's ``model.loss``, and the
    checkpoint's files equal, byte for byte, those one process saves for
    the same values."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    jcfg = jax_smoke("qwen1.5-0.5b")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tree_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    batch = np_batch(cfg, 9)
    ref = float(jax_build(jcfg).loss(jp, jax_batch(batch))[0])
    ranks_dir, one_dir = str(tmp_path / "ranks"), str(tmp_path / "one")
    saved = mr.run_ranks(tmp_path, 8, mr.save_case, (4, 2), "qwen1.5-0.5b",
                         tree_np, ranks_dir)
    got = mr.run_ranks(tmp_path, 4, mr.restore_case, (2, 2), "qwen1.5-0.5b",
                       ranks_dir)
    params = state.params_from_jax(tree_np, cfg, device="cpu")
    whole = state.checkpoint_tree(params, optim.init_state(params), cfg)
    CheckpointStore(one_dir, async_flush=False).save(
        1, whole, extra={"mesh": [4, 2]}).result()
    want = dict(_leaf_paths(whole))
    restored = dict(_leaf_paths(got[0]["whole"]))
    assert sorted(restored) == sorted(want)
    for name, t in restored.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name
    assert {o["step"] for o in got} == {1}
    assert saved[0]["local_shapes"] != got[0]["local_shapes"]
    files = sorted(os.path.relpath(os.path.join(d, f), one_dir)
                   for d, _, fs in os.walk(one_dir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ranks_dir)
                           for d, _, fs in os.walk(ranks_dir) for f in fs)
    for f in files:
        with open(os.path.join(one_dir, f), "rb") as a, \
                open(os.path.join(ranks_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    restored, _ = state.from_checkpoint(got[0]["whole"], cfg, device="cpu")
    with torch.no_grad():
        loss = float(build_model(cfg).loss(restored, torch_batch(batch))[0])
    assert abs(loss - ref) < RESTORE_LOSS_TOL, (loss, ref)


# ---------------------------------------------------------------------------
# the builders' and the mesh's own checks
# ---------------------------------------------------------------------------
def fake_ranks(shape):
    """A mesh of ranks as one rank sees it, with no groups: enough for the
    builders' checks, which raise before any collective."""
    return mesh_mod.Mesh(("data", "model"), shape, place=mesh_mod.RankPlace(
        (0,) * len(shape), torch.device("cpu"), {}))


def test_what_a_mesh_of_ranks_refuses(tmp_path):
    """On a mesh of ranks every builder builds for every family, and the
    train and prefill builders refuse a batch or a sequence that does not
    divide; in a world of one gloo rank, ``make_mesh`` refuses a shape of
    another size and a device whose backend is not the world's."""
    rules = sharding.make_rules(fake_ranks((2, 4)))
    for arch in ("qwen1.5-0.5b", "mamba2-2.7b", "zamba2-1.2b",
                 "seamless-m4t-medium"):
        cfg = get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            bundle = steps.build_step(cfg, ShapeConfig("p", S, B, kind),
                                      rules)
            assert callable(bundle.fn)
    cfg = get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="do not divide"):
        steps.build_train_step(cfg, ShapeConfig("t", S, 3, "train"), rules)
    with pytest.raises(ValueError, match="do not divide"):
        steps.build_prefill_step(cfg, ShapeConfig("p", 30, B, "prefill"),
                                 rules)
    mesh_mod.init_ranks(1, 0, f"file://{tmp_path}/store", device="cpu",
                        timeout=mr.JOIN_S)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks"):
            mesh_mod.make_mesh((2, 4), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="no collective backend"):
            mesh_mod.make_mesh((1, 1), ("data", "model"), device="meta")
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.device == torch.device("cpu") and mesh.place.groups == {}
    finally:
        torch.distributed.destroy_process_group()
