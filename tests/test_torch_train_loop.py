"""The port's training loop (``repro_torch/launch/train.py``) against the
JAX package's ``repro/launch/train.py``, at smoke size on the CPU.

The reference's ``train(steps=12, batch=2, seq=32, fail_at=11,
log_every=5)`` writes one sealed checkpoint, step 10. On copies of it the
reference and the port each resume for 5 steps: both start at step 10
from the same bytes (the port's restored state is held to the
reference's restore bit for bit), and the two logged losses agree within
LOSS_RTOL. The reverse: the port's run writes a checkpoint from which the
reference resumes. Fresh runs are not compared value for value: the two
packages draw their initial weights differently.

The losses are bf16 models on both sides (CPU arithmetic, different
operation orders); the largest relative gap measured is printed with -s.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from torch_train_cases import assert_same_bits  # noqa: E402

LOSS_RTOL = 1e-2
RUN = dict(batch=2, seq=32, log_every=5)
ARCHS = ["qwen1.5-0.5b", "seamless-m4t-medium"]


def first_run(train, arch, d, **kw):
    """Steps 0-11 with a failure injected after step 11: one sealed
    checkpoint, step 10."""
    train(arch, steps=12, ckpt_dir=d, fail_at=11, **RUN, **kw)
    assert CheckpointStore(d).steps() == [10]


def resumed(train, arch, d, capsys, **kw):
    """The logged losses of 5 steps resumed from ``d``; the run must say it
    resumed from step 10."""
    capsys.readouterr()
    _, _, losses = train(arch, steps=5, ckpt_dir=d, resume=True, **RUN, **kw)
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out, out
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    return losses


def restored_by_the_loop(monkeypatch):
    """Records the (params, opt_state) the port's loop restores."""
    seen = []
    real = state.from_checkpoint

    def keep(tree, cfg, device=None):
        out = real(tree, cfg, device)
        # copies: the loop's steps then update the state in place
        seen.append(tuple(tree_map(torch.clone, half)
                          for half in state.checkpoint_tree(*out, cfg)))
        return out

    monkeypatch.setattr(ttrain.state, "from_checkpoint", keep)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_the_port_resumes_from_the_reference_checkpoint(arch, tmp_path,
                                                        capsys, monkeypatch):
    d = str(tmp_path / "ref")
    first_run(jtrain.train, arch, d)
    shutil.copytree(d, tmp_path / "for_ref")
    shutil.copytree(d, tmp_path / "for_port")
    want = resumed(jtrain.train, arch, str(tmp_path / "for_ref"), capsys)
    seen = restored_by_the_loop(monkeypatch)
    got = resumed(ttrain.train, arch, str(tmp_path / "for_port"), capsys,
                  device="cpu")
    # the state the port's loop resumed from is the reference's, bit for
    # bit (the reference's store restores the same bytes)
    assert len(seen) == 1
    ref_state, _, step = JaxStore(d).restore(_jax_template(arch))
    assert step == 10
    assert_same_bits(seen[0], ref_state)
    gap = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"\n{arch}: losses after resuming at step 10, reference {want}, "
          f"port {got}, largest relative gap {gap:.3e}")
    assert gap <= LOSS_RTOL, (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reference_resumes_from_the_port_checkpoint(arch, tmp_path,
                                                        capsys):
    d = str(tmp_path / "port")
    first_run(ttrain.train, arch, d, device="cpu")
    ours, _, _ = CheckpointStore(d).restore(_port_template(arch),
                                            device="cpu")
    ref_state, _, _ = JaxStore(d).restore(_jax_template(arch))
    assert_same_bits(ours, ref_state)
    resumed(jtrain.train, arch, d, capsys)


def test_train_resume_after_injected_failure(tmp_path):
    ck = str(tmp_path / "ck")
    ttrain.train("qwen1.5-0.5b", steps=12, batch=2, seq=32, ckpt_dir=ck,
                 fail_at=11, log_every=5, device="cpu")
    params, _, losses = ttrain.train("qwen1.5-0.5b", steps=5, batch=2,
                                     seq=32, ckpt_dir=ck, resume=True,
                                     log_every=5, device="cpu")
    assert losses and np.isfinite(losses[-1])


def test_a_failure_that_is_not_injected_propagates(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ttrain.step_fns, "train_step", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        ttrain.train("qwen1.5-0.5b", steps=2, batch=1, seq=8,
                     ckpt_dir=str(tmp_path), device="cpu")


def test_main_runs_the_cli_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "qwen1.5-0.5b", "--steps", "11", "--batch", "1",
                 "--seq", "16", "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 10 loss" in out and "11 steps in" in out
    assert CheckpointStore(str(tmp_path)).steps() == [10]


def test_the_example_runs_on_the_cpu(capsys):
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_elastic_torch.py")
    spec = importlib.util.spec_from_file_location("train_elastic_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--steps", "25", "--resume-steps", "2", "--batch", "2",
                  "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and "final loss" in out


def _jax_template(arch):
    import jax
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro.optim import init_state
    params = build_model(get_smoke_config(arch)).init(jax.random.PRNGKey(0))
    return params, init_state(params)


def _port_template(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import init_state
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    return state.checkpoint_template(params, init_state(params), cfg)
