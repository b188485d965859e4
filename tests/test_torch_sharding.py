"""The port's partition rules (``distributed/sharding.py``) against the
reference's on every architecture's full config, leaf by leaf: parameter
specs in both modes, batch specs and the decode cells' cache specs, on
the 16 x 16, 2 x 16 x 16 and 2 x 4 meshes; and the activation-sharding
policy's ``head_sharding_active``.

The reference runs on a JAX ``AbstractMesh`` of each shape (axis names and
sizes, no devices), so its own ``param_shardings``, ``batch_shardings``
and ``cache_shardings`` run unchanged; the port on its ``Mesh`` of the
same shape. JAX's ``PartitionSpec`` holds a one-axis tuple as the axis's
name, and so does the port. The port keeps per-layer lists where the
reference stacks: its stacked tree (``state.checkpoint_template``) must
give the reference's specs exactly, and each leaf of a list the
reference's spec without its leading (scan) entry. Every comparison is
exact.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import act_sharding as ref_act  # noqa: E402
from repro.distributed import sharding as ref_sh  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.model_zoo import build_model as ref_model  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed import act_sharding  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import LONG_OK_FAMILIES  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import init_state  # noqa: E402

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": make_smoke_mesh()}


def rules(name: str):
    """(the reference's rules on an AbstractMesh, the port's) of a mesh."""
    mesh = MESHES[name]
    ref = AbstractMesh(mesh.sizes, mesh.axis_names)
    return ref_sh.make_rules(ref), sharding.make_rules(mesh)


@functools.cache
def ref_params(arch: str):
    return jax.eval_shape(ref_model(ref_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.cache
def port_params(arch: str):
    return build_model(get_config(arch)).init(0, device="meta")


def ref_flat(tree) -> dict:
    """{path of keys: leaf} of a reference tree (shardings included)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            leaf for path, leaf in flat}


def port_flat(tree, path=()) -> dict:
    """{path: leaf} of a port tree; a list's index is kept as an int."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_flat(v, path + (i,)))
        return out
    return {path: tree}


def assert_specs_equal(ref_tree, port_tree):
    """Every reference leaf's spec against the port's: the same path in a
    stacked tree, or the path without its list index for a leaf of a
    layer list (the leading scan entry dropped)."""
    ref = {p: tuple(s.spec) for p, s in ref_flat(ref_tree).items()}
    seen = set()
    for path, sh in port_flat(port_tree).items():
        key = tuple(k for k in path if not isinstance(k, int))
        want = ref[key]
        if len(key) < len(path):
            want = want[1:]
        assert sh.spec == want, (path, sh.spec, ref[key])
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    ref_rules, port_rules = rules(mesh)
    cfg = get_config(arch)
    params = port_params(arch)
    stacked, opt = state.checkpoint_template(params, init_state(params), cfg)
    for mode in ("train", "serve"):
        ref = ref_sh.param_shardings(ref_params(arch), ref_rules, mode)
        # the port's layout (layer lists) and the reference's (stacked)
        assert_specs_equal(ref, sharding.param_shardings(params, port_rules,
                                                         mode))
        assert_specs_equal(ref, sharding.param_shardings(stacked, port_rules,
                                                         mode))
        # AdamW's moments follow their parameters
        assert_specs_equal(ref, sharding.param_shardings(opt["mu"],
                                                         port_rules, mode))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh):
    ref_rules, port_rules = rules(mesh)
    for b in sorted({s.global_batch for s in SHAPES.values()} | {3, 6, 64}):
        assert sharding.batch_spec(b, port_rules) == \
            tuple(ref_sh.batch_spec(b, ref_rules)), b
    for arch in ("qwen1.5-0.5b", "seamless-m4t-medium"):
        for name, shape in SHAPES.items():
            # a decode step's token (its position is replicated)
            ref = ref_steps.input_specs(ref_config(arch), REF_SHAPES[name])
            port = steps.input_specs(get_config(arch), shape)
            ref.pop("pos", None)
            port.pop("pos", None)
            assert_specs_equal(ref_sh.batch_shardings(ref, ref_rules),
                               sharding.batch_shardings(port, port_rules))


def decode_cells():
    return [(a, s) for a in ARCHS for s, shape in SHAPES.items()
            if shape.kind == "decode" and (
                s != "long_500k"
                or get_config(a).family in LONG_OK_FAMILIES)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", decode_cells())
def test_cache_specs_equal_the_reference(arch, shape, mesh):
    """The cache of each decode cell as the reference's build_decode_step
    makes it (the encoder families' with 4096 positions of memory)."""
    ref_rules, port_rules = rules(mesh)
    cfg, sh = get_config(arch), SHAPES[shape]
    model = ref_model(ref_config(arch))
    kw = {"enc_len": 4096} if cfg.encoder_layers else {}
    ref = jax.eval_shape(functools.partial(
        model.init_cache, sh.global_batch, sh.seq_len, **kw))
    port = steps.init_cache(cfg, sh.global_batch, sh.seq_len, device="meta",
                            enc_len=4096)
    assert_specs_equal(ref_sh.cache_shardings(ref, ref_rules),
                       sharding.cache_shardings(port, port_rules))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_head_sharding_active_follows_the_policy(mesh):
    ref_rules, port_rules = rules(mesh)
    heads = sorted({get_config(a).num_heads for a in ARCHS} | {0, 6, 8, 24})
    assert not any(act_sharding.head_sharding_active(h) for h in heads)
    with act_sharding.activation_sharding(port_rules.mesh,
                                          port_rules.data_axes, "model"), \
            ref_act.activation_sharding(ref_rules.mesh, ref_rules.data_axes,
                                        "model"):
        got = [act_sharding.head_sharding_active(h) for h in heads]
        assert got == [ref_act.head_sharding_active(h) for h in heads]
        assert any(got) and not all(got)
    assert not any(act_sharding.head_sharding_active(h) for h in heads)


def test_shard_shapes_and_one_device_placement():
    mesh = MESHES["2x16x16"]
    sh = sharding.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((48, 3, 32))
    with pytest.raises(ValueError, match="cannot place"):
        mesh.device
