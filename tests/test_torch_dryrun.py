"""The port's step builders and dry run (``launch/steps.py``,
``launch/dryrun.py``) against the reference's.

* ``param_structs`` and ``input_specs``: the meta trees equal the real
  init on the CPU at smoke size, and the reference's ShapeDtypeStructs at
  full size (stacked as the reference stacks, every leaf's shape and
  type).
* Argument bytes per device: every cell's bundle on both production meshes
  against the reference's arithmetic, each leaf's shard shape from the
  reference's own shardings (on a JAX ``AbstractMesh``) over the
  reference's leaves; one decode cell also run through ``run_cell``.
* ``"SKIP(full-attn)"`` exactly where the reference skips.
* A bundle's ``fn`` at smoke size on the CPU equals the single-card step
  it wraps, bit for bit (train, prefill, and decode in each of its three
  implementations).
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_sh  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.model_zoo import build_model as ref_model  # noqa: E402
from repro.optim.adamw import init_state as ref_init_state  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import make_rules  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.train import make_host_mesh  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_batch  # noqa: E402
from repro_torch.optim import init_state  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

def signature(tree) -> dict:
    """{path: (shape, dtype name)} of a port tree of tensors."""
    return {"/".join(map(str, p)): (tuple(t.shape), str(t.dtype)[6:])
            for p, t in leaves(tree)}


def ref_signature(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


@functools.cache
def ref_params(arch: str):
    return ref_steps.param_structs(ref_model(ref_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_structs_and_input_specs(arch):
    """Smoke size: the meta tree is the CPU init's, leaf for leaf. Full
    size: stacked as the reference stacks, its param_structs; and every
    cell's input_specs equal the reference's."""
    smoke = get_smoke_config(arch)
    real = build_model(smoke).init(0, device="cpu")
    stand_in = steps.param_structs(build_model(smoke))
    assert all(t.device.type == "meta" for _, t in leaves(stand_in))
    assert signature(stand_in) == signature(real)
    cfg = get_config(arch)
    params = steps.param_structs(build_model(cfg))
    stacked, _ = state.checkpoint_template(params, init_state(params), cfg)
    assert signature(stacked) == ref_signature(ref_params(arch))
    for name, shape in SHAPES.items():
        got = steps.input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert signature(got) == ref_signature(
            ref_steps.input_specs(ref_config(arch), REF_SHAPES[name]))


def ref_argument_bytes(arch: str, shape_name: str, multi_pod: bool) -> int:
    """One device's argument bytes of the reference's bundle for the cell:
    its input leaves (build_step's in_specs) under its own shardings,
    computed on an AbstractMesh of the production mesh's shape."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = ref_sh.make_rules(AbstractMesh(mesh.sizes, mesh.axis_names))
    cfg, shape = ref_config(arch), REF_SHAPES[shape_name]
    p = ref_params(arch)
    if shape.kind == "train":
        o = jax.eval_shape(ref_init_state, p)
        leaves_ = [(p, ref_sh.param_shardings(p, rules, "train")),
                   (o["mu"], ref_sh.param_shardings(o["mu"], rules)),
                   (o["nu"], ref_sh.param_shardings(o["nu"], rules)),
                   (o["step"], ref_sh.replicated(rules))]
        b = ref_steps.input_specs(cfg, shape)
        leaves_.append((b, ref_sh.batch_shardings(b, rules)))
    elif shape.kind == "prefill":
        b = ref_steps.input_specs(cfg, shape)
        leaves_ = [(p, ref_sh.param_shardings(p, rules, "serve")),
                   (b, ref_sh.batch_shardings(b, rules))]
    else:
        kw = {"enc_len": 4096} if cfg.encoder_layers else {}
        c = jax.eval_shape(functools.partial(
            ref_model(cfg).init_cache, shape.global_batch, shape.seq_len,
            **kw))
        t = jax.ShapeDtypeStruct((shape.global_batch,), np.int32)
        pos = jax.ShapeDtypeStruct((), np.int32)
        leaves_ = [(p, ref_sh.param_shardings(p, rules, "serve")),
                   (c, ref_sh.cache_shardings(c, rules)),
                   (t, ref_sh.batch_shardings(t, rules)),
                   (pos, ref_sh.replicated(rules))]
    total = 0
    for tree, shardings in leaves_:
        is_sh = lambda x: isinstance(x, jax.sharding.NamedSharding)  # noqa
        flat_sh = jax.tree_util.tree_leaves(shardings, is_leaf=is_sh)
        flat = jax.tree_util.tree_leaves(tree)
        if len(flat_sh) == 1:
            flat_sh = flat_sh * len(flat)
        for leaf, sh in zip(flat, flat_sh, strict=True):
            total += math.prod(sh.shard_shape(leaf.shape)) \
                * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference(arch, multi_pod):
    rules = make_rules(make_production_mesh(multi_pod=multi_pod))
    for name, shape in SHAPES.items():
        bundle = steps.build_step(get_config(arch), shape, rules)
        got = dryrun.per_device_bytes(bundle.in_specs, bundle.in_shardings)
        assert got == ref_argument_bytes(arch, name, multi_pod), name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_cell_decode_32k(multi_pod):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=multi_pod)
    assert rec["status"] == "OK"
    assert rec["devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    mem = rec["memory"]
    assert mem["argument_bytes"] == ref_argument_bytes(
        "qwen1.5-0.5b", "decode_32k", multi_pod)
    # the cache is updated in place: the outputs alias it, and add the
    # logits (128 x 151,936 f32, batch over the data axes)
    cfg = get_config("qwen1.5-0.5b")
    logits = 128 * cfg.vocab_size * 4 // (32 if multi_pod else 16)
    assert mem["output_bytes"] == mem["alias_bytes"] + logits
    assert 0 < mem["alias_bytes"] < mem["argument_bytes"]
    assert rec["flops"] > 0 and rec["bytes"] > 0 and mem["temp_bytes"] > 0
    assert rec["flops_per_device"] == rec["flops"] / rec["devices"]
    assert rec["collectives"] == {} and rec["collective_bytes"] == 0
    assert set(rec) >= {"arch", "shape", "status", "mesh", "devices",
                        "step", "lower_s", "compile_s", "flops_per_device",
                        "bytes_per_device", "collective_bytes",
                        "collectives", "xla_flops_per_device",
                        "xla_bytes_per_device", "memory"}


def test_long_500k_is_skipped_exactly_where_the_reference_skips():
    from repro.launch.dryrun import LONG_OK_FAMILIES as REF_OK
    assert dryrun.LONG_OK_FAMILIES == REF_OK
    for arch in ARCHS:
        skip = get_config(arch).family not in REF_OK
        if skip:
            rec = dryrun.run_cell(arch, "long_500k")
            assert rec == {"arch": arch, "shape": "long_500k",
                           "status": "SKIP(full-attn)"}
        assert skip == (ref_config(arch).family not in REF_OK)
    rec = dryrun.run_cell("mamba2-2.7b", "long_500k", multi_pod=True)
    assert rec["status"] == "OK" and rec["step"] == "serve_step"


def copy(tree):
    if isinstance(tree, dict):
        return {k: copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def as_lists(tree):
    if isinstance(tree, dict):
        return {k: as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_lists(v) for v in tree]
    return tree


def assert_bitwise(a, b):
    pa, pb = list(leaves(as_lists(a))), list(leaves(as_lists(b)))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


BUNDLE_ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", BUNDLE_ARCHS)
def test_bundle_fns_equal_the_steps_bit_for_bit(arch):
    cfg = get_smoke_config(arch)
    rules = make_rules(make_host_mesh("cpu"))
    b, s = 2, 16
    params = build_model(cfg).init(0, device="cpu")
    batch = make_batch(cfg, b, s, device="cpu")
    # train: both update their own copies in place
    bundle = steps.build_train_step(cfg, ShapeConfig("c", s, b, "train"),
                                    rules)
    p1, o1 = copy(params), init_state(params)
    p2, o2 = copy(params), init_state(params)
    p1, o1, m1 = bundle.fn(p1, o1, batch)
    p2, o2, m2 = steps.train_step(p2, o2, batch, cfg)
    assert_bitwise((p1, o1, m1), (p2, o2, m2))
    assert bundle.donate == (0, 1)
    # prefill
    bundle = steps.build_prefill_step(cfg, ShapeConfig("c", s, b, "prefill"),
                                      rules)
    pre = {"tokens": batch["tokens"]}
    if cfg.encoder_layers:
        pre["frames"] = batch["frames"]
    with torch.no_grad():
        got = bundle.fn(params, pre)
        want = steps.prefill_step(params, batch["tokens"], cfg,
                                  frames=pre.get("frames"))
    assert_bitwise(got, want)
    # decode, each implementation
    for optimized in (False, "v2", True):
        bundle = steps.build_decode_step(cfg, ShapeConfig("c", s, b,
                                                          "decode"),
                                         rules, optimized=optimized)
        impl = optimized if cfg.family == "dense" else False
        c1 = steps.init_cache(cfg, b, s, impl, device="cpu", enc_len=4096)
        c2 = copy(c1)
        with torch.no_grad():
            for pos in range(3):
                tok = batch["tokens"][:, pos]
                l1, c1 = bundle.fn(params, c1, tok, pos)
                l2, c2 = steps.serve_step(params, c2, tok, pos, cfg, impl)
                assert_bitwise((l1, c1), (l2, c2))
        assert bundle.donate == (1,)
