"""The port's log-structured checkpoint store
(``repro_torch/checkpoint/ckpt.py``) and the training state it carries
(``state.checkpoint_tree``, ``state.from_checkpoint``) against the JAX
package's ``repro/checkpoint/ckpt.py``: the reference's store tests on
torch trees, torn and unsealed manifests, a save followed at once by an
in-place write to the saved tensors, and cross-loading bit for bit both
ways -- a tree either package saves restores in the other, and the same
values give the same files and manifests."""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_cases as cases  # noqa: E402
from torch_train_cases import assert_same_bits  # noqa: E402
from repro.checkpoint import CheckpointStore as JaxStore  # noqa: E402
from repro.checkpoint.ckpt import _leaf_paths as jax_leaf_paths  # noqa: E402
from repro_torch import optim, state  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.ckpt import _leaf_paths  # noqa: E402

CPU = "cpu"
def files(directory: str, step: int) -> dict:
    """{file name: bytes} of a checkpoint's segments, and its manifest."""
    seg = os.path.join(directory, "segments", str(step))
    out = {f: open(os.path.join(seg, f), "rb").read()
           for f in sorted(os.listdir(seg))}
    with open(os.path.join(directory, f"MANIFEST-{step}.json")) as f:
        return out, json.load(f)


def mixed_tree(seed=0):
    """(port tree, reference tree) of the same values: bf16, f32, int32,
    a 0-d step, float8, nested dicts, a tuple and a list."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    m = rng.standard_normal((3, 4)).astype(np.float32)
    ids = rng.integers(-9, 9, (7,)).astype(np.int32)
    f8 = rng.standard_normal((4,)).astype(np.float32)
    ours = ({"layers": {"w": torch.from_numpy(w).to(torch.bfloat16),
                        "b": [torch.from_numpy(ids)]},
             "embed": torch.from_numpy(m)},
            {"step": torch.tensor(7, dtype=torch.int32),
             "f8": torch.from_numpy(f8).to(torch.float8_e4m3fn)})
    ref = ({"layers": {"w": jnp.asarray(w, jnp.bfloat16),
                       "b": [jnp.asarray(ids)]},
            "embed": jnp.asarray(m)},
           {"step": jnp.int32(7),
            "f8": jnp.asarray(f8, jnp.float8_e4m3fn)})
    return ours, ref


class TestCheckpointStore:
    def test_roundtrip_and_elastic_restore(self, tmp_path):
        cs = CheckpointStore(str(tmp_path))
        tree = {"layers": {"w": torch.ones((8, 8), dtype=torch.bfloat16)},
                "step": torch.tensor(7, dtype=torch.int32)}
        cs.save(5, tree, extra={"loss": 1.5}).result()
        got, extra, step = cs.restore(tree, device=CPU)
        assert step == 5 and extra["loss"] == 1.5
        assert got["layers"]["w"].dtype == torch.bfloat16
        assert torch.equal(got["layers"]["w"], tree["layers"]["w"])
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 7

    def test_torn_manifest_and_segment(self, tmp_path):
        d = str(tmp_path)
        cs = CheckpointStore(d)
        tree = {"w": torch.ones((4,))}
        cs.save(1, tree).result()
        cs.save(2, tree).result()
        # tear step 2's segment: restore must fall back to step 1
        seg = os.path.join(d, "segments", "2")
        with open(os.path.join(seg, os.listdir(seg)[0]), "wb") as f:
            f.write(b"garbage")
        assert cs.latest_valid() == 1
        _, _, step = cs.restore(tree, device=CPU)
        assert step == 1

    def test_gc_keeps_recent(self, tmp_path):
        cs = CheckpointStore(str(tmp_path), keep=2)
        tree = {"w": torch.ones((4,))}
        for s in range(5):
            cs.save(s, tree).result()
        assert len(cs.steps()) <= 2

    def test_async_futures(self, tmp_path):
        cs = CheckpointStore(str(tmp_path), async_flush=True)
        futs = [cs.save(s, {"w": torch.full((64, 64), float(s))})
                for s in range(4)]
        cs.wait()
        assert all(f.done() for f in futs)
        got, _, step = cs.restore({"w": torch.zeros((64, 64))}, device=CPU)
        assert step == 3 and float(got["w"][0, 0]) == 3.0

    @pytest.mark.parametrize("fault", ["garbage", "unsealed", "missing",
                                       "tmp_only"])
    def test_torn_or_unsealed_manifest(self, tmp_path, fault):
        d = str(tmp_path)
        cs = CheckpointStore(d, async_flush=False)
        for s in (1, 2):
            cs.save(s, {"w": torch.full((4,), float(s)),
                        "v": torch.zeros(2)}).result()
        path = os.path.join(d, "MANIFEST-2.json")
        if fault == "garbage":
            with open(path, "w") as f:
                f.write('{"step": 2, "entr')
        elif fault == "unsealed":
            manifest = json.load(open(path))
            manifest["sealed"] = False
            with open(path, "w") as f:
                json.dump(manifest, f)
        elif fault == "missing":
            seg = os.path.join(d, "segments", "2")
            os.remove(os.path.join(seg, sorted(os.listdir(seg))[0]))
        else:       # the crash came before the manifest's rename
            os.replace(path, os.path.join(d, ".MANIFEST-2.tmp"))
        assert cs.latest_valid() == 1
        got, _, step = cs.restore({"w": 0, "v": 0}, device=CPU)
        assert step == 1 and float(got["w"][0]) == 1.0
        with pytest.raises(IOError, match="failed validation"):
            cs.restore({"w": 0, "v": 0}, step=2, device=CPU)

    def test_no_valid_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointStore(str(tmp_path)).restore({"w": 0}, device=CPU)

    def test_save_copies_before_it_returns(self, tmp_path, monkeypatch):
        """The flush is held until the saved tensors have been written in
        place (as the next train step writes them): the restore gives back
        the values from before the write."""
        cs = CheckpointStore(str(tmp_path), async_flush=True)
        go = threading.Event()
        write = CheckpointStore._write_segment

        def held(self, *args):
            assert go.wait(timeout=30)
            return write(self, *args)

        monkeypatch.setattr(CheckpointStore, "_write_segment", held)
        params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  "h": torch.ones(5, dtype=torch.bfloat16)}
        want = {k: v.clone() for k, v in params.items()}
        fut = cs.save(1, params)
        assert not fut.done()
        with torch.no_grad():
            for v in params.values():
                v.add_(100)
        go.set()
        cs.wait()
        got, _, _ = cs.restore(params, device=CPU)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert cs.stats["crc_passes"] > 0 and cs.stats["bytes_written"] > 0

    def test_leaf_names_are_the_reference_names(self):
        ours, ref = mixed_tree()
        assert [n for n, _ in _leaf_paths(ours)] == \
            [n for n, _ in jax_leaf_paths(ref)]
        assert [n for n, _ in _leaf_paths(ours)][:2] == ["0/embed",
                                                         "0/layers/b/0"]


class TestCrossLoading:
    def test_the_reference_checkpoint_restores_in_the_port(self, tmp_path):
        ours, ref = mixed_tree(1)
        JaxStore(str(tmp_path)).save(3, ref, extra={"a": 1}).result()
        got, extra, step = CheckpointStore(str(tmp_path)).restore(
            ours, device=CPU)
        assert step == 3 and extra == {"a": 1}
        assert_same_bits(got, ref)

    def test_the_port_checkpoint_restores_in_the_reference(self, tmp_path):
        ours, ref = mixed_tree(2)
        CheckpointStore(str(tmp_path)).save(4, ours, extra={"b": 2}).result()
        got, extra, step = JaxStore(str(tmp_path)).restore(ref)
        assert step == 4 and extra == {"b": 2}
        assert_same_bits(ours, got)
        assert got[0]["layers"]["w"].dtype == jnp.bfloat16

    def test_same_values_same_files_and_manifests(self, tmp_path):
        ours, ref = mixed_tree(3)
        a, b = str(tmp_path / "port"), str(tmp_path / "ref")
        CheckpointStore(a).save(9, ours, extra={"loss": 2.5}).result()
        JaxStore(b).save(9, ref, extra={"loss": 2.5}).result()
        (fa, ma), (fb, mb) = files(a, 9), files(b, 9)
        assert fa == fb
        assert ma == mb
        assert open(os.path.join(a, "MANIFEST-9.json")).read() == \
            open(os.path.join(b, "MANIFEST-9.json")).read()

    @pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b",
                                      "seamless-m4t-medium"])
    def test_training_state_cross_loads(self, tmp_path, arch):
        """(params, opt_state) of a smoke config mid-training: the port's
        ``checkpoint_tree`` and the reference's tree of the same values
        write the same files; each restores in the other package, and
        ``from_checkpoint`` gives back the port's state exactly."""
        jcfg, cfg, jp, tp = cases.carried(arch)
        rng = np.random.default_rng(5)
        moments = lambda: jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        jstate = {"mu": moments(), "nu": moments(), "step": np.int32(7)}
        tstate = state.opt_state_from_jax(jstate, cfg, device=CPU)
        jstate = jax.tree.map(jnp.asarray, jstate)
        ours = state.checkpoint_tree(tp, tstate, cfg)
        assert_same_bits(ours, (jp, jstate))
        a, b = str(tmp_path / "port"), str(tmp_path / "ref")
        CheckpointStore(a).save(10, ours).result()
        JaxStore(b).save(10, (jp, jstate)).result()
        assert files(a, 10) == files(b, 10)
        # each package restores the other's
        got, _, _ = CheckpointStore(b).restore(ours, device=CPU)
        assert_same_bits(got, (jp, jstate))
        jgot, _, _ = JaxStore(a).restore((jp, jstate))
        assert_same_bits(ours, jgot)
        params, opt_state = state.from_checkpoint(got, cfg, device=CPU)
        for (pa, x), (_, y) in zip(optim.adamw.leaves([params, opt_state]),
                                   optim.adamw.leaves([tp, tstate]),
                                   strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), pa
