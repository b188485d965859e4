"""The port's op analysis (``launch/op_analysis.py``) against the
reference's HLO analysis (``launch/hlo_analysis.py``): the twins of
tests/test_analysis_substrate.py:16-57, the peak-bytes tracker against
hand arithmetic, and whole steps of the smoke configs against
``analyze_hlo`` of the reference's step compiled for one CPU device.

The steps run the bundles of both packages' ``build_step`` at 2 x 64
tokens (qwen) and 2 x 128 (mamba2: two SSD chunks; at one chunk XLA folds
away the products of the all-zero carried state, which the port still
multiplies). Prefill: the same products, so the FLOPs are equal (bar 1 %).
Train, bar 5 %: the port does every product the reference does, plus one
more forward of each kernel's plain version per call. The reference's
VJP differentiates the forward it rematerialized; the port's
``FlashAttention.backward`` and ``SSDScan.backward`` recompute the plain
forward under autograd, since the card's kernel keeps no residuals (on
the card the forward and the rematerialized forward are kernel launches,
and this recompute is the third). Attributed op by op:

  * qwen1.5-0.5b smoke (2 layers, 4 heads of 16), 2 x 64: two products a
    layer, Q.K^T and P.V, 2 x 2 x 4 x 64 x 64 x 16 = 1,048,576 FLOPs
    each: 4,194,304 of the reference's 133,169,152 (3.15 %).
  * mamba2-2.7b smoke (2 layers), 2 x 128: one ``ssd_chunked`` forward a
    layer, 10,485,760 FLOPs: 20,971,520 of 236,978,176 (8.85 %), past
    the 5 % bar. The test holds the attribution (the port's count minus
    the recomputes equals the reference's within 1 %) and, for mamba2,
    leaves the 5 % bar unmet: the SSD's products are a larger share of
    its step than attention's are of qwen's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.distributed.sharding import make_rules as ref_rules  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo, traffic_breakdown  # noqa: E402,E501
from repro.launch.train import make_host_mesh as ref_host_mesh  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import make_rules  # noqa: E402
from repro_torch.kernels.flash_attention import plain_attention  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.launch.train import make_host_mesh  # noqa: E402

STEP_CELLS = {"qwen1.5-0.5b": (2, 64), "mamba2-2.7b": (2, 128)}
PREFILL_TOL, TRAIN_TOL = 0.01, 0.05


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_and_bytes_equal_the_reference():
    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    ref = analyze_hlo(jax.jit(lambda a, b: a @ b).lower(x, x)
                      .compile().as_text())
    t = analyze(lambda a, b: a @ b, meta(128, 128), meta(128, 128))
    assert t.flops == ref.flops == 2 * 128 ** 3
    assert t.bytes == ref.bytes == 3 * 128 * 128 * 4
    assert t.collectives == {} and t.collective_bytes == 0


def test_loop_counts_every_trip():
    """The twin of the reference's scan trip count: a 12-pass loop
    counts 12 x one product."""
    def loop(x, w):
        for _ in range(12):
            x = x @ w
        return x

    t12 = analyze(loop, meta(64, 64), meta(64, 64))
    t1 = analyze(lambda a, b: a @ b, meta(64, 64), meta(64, 64))
    assert t12.flops == 12 * t1.flops
    assert t12.ops == 12


def test_a_slice_is_not_billed_as_its_buffer():
    """An op on one (256, 256) slice of a (64, 256, 256) pool reads the
    slice: the view bills nothing, and the product reads and writes one
    slice each."""
    slice_bytes = 256 * 256 * 4
    t = analyze(lambda pool, i: pool[i] * 2.0, meta(64, 256, 256), 3)
    assert t.bytes == 2 * slice_bytes
    assert t.bytes < 16 * slice_bytes
    assert "select" not in t.traffic_breakdown


def test_breakdown_keys():
    ref = traffic_breakdown(jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((64, 64), jnp.float32)).compile().as_text())
    t = analyze(lambda a, b: a @ b, meta(64, 64), meta(64, 64))
    assert ref and t.traffic_breakdown
    assert all(v >= 0 for v in t.traffic_breakdown.values())
    assert sum(t.traffic_breakdown.values()) == t.bytes
    assert set(t.traffic_breakdown) == {"mm"}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_bytes_of_a_matmul_chain(device):
    """x @ w four times, each result replacing the last: at most two
    results live at once (the one being read and the one being made),
    and the arguments are not counted. The last result is returned."""
    n = 48
    x = torch.ones((n, n), device=device)
    w = torch.ones((n, n), device=device)

    def chain(x, w):
        y = x
        for _ in range(4):
            y = y @ w
        return y

    t = analyze(chain, x, w)
    assert t.peak_bytes == 2 * n * n * 4
    assert t.flops == 4 * 2 * n ** 3
    assert t.bytes == 4 * 3 * n * n * 4
    assert tuple(t.outputs.shape) == (n, n)
    # a result kept alive beside the next: three at once
    t = analyze(lambda x, w: [x @ w, (x @ w) @ w], x, w)
    assert t.peak_bytes == 3 * n * n * 4


def step_flops(arch: str, kind: str) -> tuple[float, float]:
    """(the reference's analyze_hlo FLOPs, the port's op-analysis FLOPs)
    of ``build_step``'s bundle at STEP_CELLS[arch]: the reference's
    jitted and compiled on a 1 x 1 CPU mesh, the port's run on meta."""
    b, s = STEP_CELLS[arch]
    mesh = ref_host_mesh()
    bundle = ref_steps.build_step(ref_smoke(arch), RefShape("c", s, b, kind),
                                  ref_rules(mesh))
    with mesh:
        compiled = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                           out_shardings=bundle.out_shardings
                           ).lower(*bundle.in_specs).compile()
    ref = analyze_hlo(compiled.as_text()).flops
    port = steps.build_step(get_smoke_config(arch),
                            ShapeConfig("c", s, b, kind),
                            make_rules(make_host_mesh("meta")))
    return ref, analyze(port.fn, *port.in_specs).flops


def recompute_flops(arch: str) -> float:
    """The FLOPs of the plain forwards the port's backward recomputes, one
    per kernel call of a step: every layer's attention (qwen) or SSD
    (mamba2) at STEP_CELLS' shapes."""
    cfg = get_smoke_config(arch)
    b, s = STEP_CELLS[arch]
    if cfg.family == "ssm":
        h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        g = cfg.ssm_groups
        one = analyze(lambda *a: ssd_chunked(*a, min(64, s)),
                      meta(b, s, h, p), meta(b, s, h), meta(h),
                      meta(b, s, g, n), meta(b, s, g, n), meta(h)).flops
    else:
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        one = analyze(lambda q, k, v: plain_attention(q, k, v, True),
                      meta(b, h, s, d), meta(b, kh, s, d),
                      meta(b, kh, s, d)).flops
    return cfg.num_layers * one


@pytest.mark.parametrize("arch", sorted(STEP_CELLS))
def test_prefill_flops_equal_the_reference(arch):
    ref, port = step_flops(arch, "prefill")
    assert abs(port - ref) <= PREFILL_TOL * ref, (port, ref)


@pytest.mark.parametrize("arch", sorted(STEP_CELLS))
def test_train_flops_equal_the_reference_plus_the_recomputes(arch):
    ref, port = step_flops(arch, "train")
    extra = recompute_flops(arch)
    assert extra > 0
    assert abs(port - extra - ref) <= PREFILL_TOL * ref, (port, extra, ref)
    want = {"qwen1.5-0.5b": (133_169_152, 4_194_304),
            "mamba2-2.7b": (236_978_176, 20_971_520)}[arch]
    assert (ref, extra) == want
    if arch == "qwen1.5-0.5b":
        assert port <= (1 + TRAIN_TOL) * ref
    else:
        # the docstring's unmet bar, measured: 8.85 % over
        assert np.isclose(port / ref, 1.0885, atol=5e-4)
