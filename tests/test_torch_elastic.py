"""The port's elastic restore and straggler policy
(``repro_torch/launch/elastic.py``) and its hot-row replication
(``repro_torch/embedding/hot_rows.py``) against the JAX package's
``repro/launch/elastic.py`` and ``repro/embedding/hot_rows.py``, on the
same numpy inputs: the policies exactly, the lookups bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.embedding import hot_rows as jhr  # noqa: E402
from repro.launch.elastic import straggler_scales as jax_scales  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.embedding import (build_replica, lookup,  # noqa: E402
                                   refresh_after_update, select_cold_rows,
                                   select_hot_rows)
from repro_torch.launch.elastic import resize, straggler_scales  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.train import make_host_mesh, train, upload  # noqa: E402,E501
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

RNG = np.random.default_rng(0)


class TestElasticHelpers:
    def test_straggler_scales(self):
        t = {"w0": 100.0, "w1": 100.0, "w2": 100.0, "w3": 40.0}
        scales = straggler_scales(t)
        assert scales["w3"] < min(scales["w0"], scales["w1"])
        # shares renormalize to the same total work
        assert abs(sum(scales.values()) - len(scales)) < 1e-6
        assert scales == jax_scales(t)

    def test_no_stragglers_identity(self):
        t = {"w0": 100.0, "w1": 101.0}
        scales = straggler_scales(t)
        assert all(abs(s - 1.0) < 0.02 for s in scales.values())
        assert scales == jax_scales(t)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_rates_equal_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        t = {f"w{i}": float(r) for i, r in
             enumerate(rng.uniform(1, 200, rng.integers(1, 9)))}
        assert straggler_scales(t) == jax_scales(t)
        assert straggler_scales({}) == jax_scales({}) == {}


class TestHotRows:
    def test_policy_rules(self):
        counts = np.ones(1000)
        counts[[3, 14, 159]] = [900, 700, 800]
        hot = select_hot_rows(counts, 3.0)
        assert set(hot.tolist()) == {3, 14, 159}
        counts[3] = 0.0
        cold = select_cold_rows(counts, hot, 0.0)
        assert 3 in cold.tolist()

    @pytest.mark.parametrize("seed", range(3))
    def test_policies_equal_the_reference(self, seed):
        """Zipfian counts with more hot rows than max_rows and ties among
        them: the same rows in the same order."""
        rng = np.random.default_rng(seed)
        counts = np.bincount(rng.zipf(1.3, 20_000) % 4096,
                             minlength=4096).astype(np.float64)
        counts[rng.integers(0, 4096, 40)] = counts.max()
        for k, m in ((1.0, 16), (3.0, 256), (0.5, 8)):
            hot = select_hot_rows(counts, k, m)
            want = jhr.select_hot_rows(counts, k, m)
            assert hot.dtype == want.dtype and hot.tolist() == want.tolist()
            later = counts * rng.random(4096)       # some went cold
            for ks in (0.0, 1.0):
                cold = select_cold_rows(later, hot, ks)
                want = jhr.select_cold_rows(later, hot, ks)
                assert cold.dtype == want.dtype
                assert cold.tolist() == want.tolist()
        flat = np.ones(64)
        assert select_hot_rows(flat).shape == (0,)
        assert select_cold_rows(flat, np.zeros(0, np.int32)).shape == (0,)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_lookup_correct_and_flags(self, dtype):
        table_np = RNG.standard_normal((256, 16)).astype(np.float32)
        table = torch.from_numpy(table_np).to(dtype)
        hot = np.array([5, 200], np.int32)
        st = build_replica(table, hot, pad_to=8)
        assert st.hot_ids.tolist() == [5, 200] + [-1] * 6
        assert not st.hot_rows[2:].any()
        ids_np = RNG.integers(0, 256, (4, 7)).astype(np.int32)
        ids_np[0, :2] = hot
        out, is_hot = lookup(table, st, torch.from_numpy(ids_np))
        assert out.dtype == dtype
        assert torch.equal(out, table[torch.from_numpy(ids_np).long()])
        np.testing.assert_array_equal(is_hot.numpy(), np.isin(ids_np, hot))
        jst = jhr.build_replica(jnp.asarray(table_np), hot, pad_to=8)
        jout, jhot = jhr.lookup(jnp.asarray(table_np), jst,
                                jnp.asarray(ids_np))
        np.testing.assert_array_equal(is_hot.numpy(), np.asarray(jhot))
        if dtype == torch.float32:
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout))

    def test_refresh_after_update(self):
        table = torch.zeros((16, 4))
        st = build_replica(table, np.array([2], np.int32), pad_to=2)
        table[2] = 7.0
        st = refresh_after_update(table, st)
        out, is_hot = lookup(table, st, torch.tensor([2]))
        assert bool(is_hot[0]) and float(out[0, 0]) == 7.0

    def test_a_host_table_goes_to_the_device_asked_for(self):
        st = build_replica(np.eye(4, dtype=np.float32), np.array([1]), 2,
                           device="cpu")
        assert st.hot_rows.device.type == "cpu"
        assert st.hot_rows[0].tolist() == [0.0, 1.0, 0.0, 0.0]


def test_resize_restores_the_state_train_saved(tmp_path):
    """The one-card form of the reference's elastic restore
    (tests/test_system.py's remesh test): the state ``train`` saved last,
    restored by ``resize``, gives the same loss as the state itself."""
    arch, seq = "qwen1.5-0.5b", 16
    cfg = get_smoke_config(arch).replace(loss_chunk=seq)
    store = CheckpointStore(str(tmp_path))
    params, opt_state, _ = train(arch, steps=10, batch=2, seq=seq,
                                 ckpt_dir=str(tmp_path), device="cpu")
    template = state.checkpoint_template(params, opt_state, cfg)
    tree, _, step = resize(store, template, device="cpu")
    assert step == 10
    restored, restored_opt = state.from_checkpoint(tree, cfg, device="cpu")
    assert int(restored_opt["step"]) == 10
    batch = upload(SyntheticLM(cfg.vocab_size, seq, 4, seed=3).batch(0),
                   "cpu")
    loss = build_model(cfg).loss
    with torch.no_grad():
        want = float(loss(params, batch)[0])
        got = float(loss(restored, batch)[0])
    assert got == want


def test_resize_onto_a_mesh_maps_each_leaf_by_the_rules(tmp_path):
    """With a mesh, ``resize`` takes each leaf's sharding from the new
    mesh's partition rules (the reference's step 4) and restores onto the
    mesh's one device: the host mesh's, bit for bit. A production mesh (of
    256 devices, none here) raises before any byte is read, and so does
    a device that is not the mesh's."""
    store = CheckpointStore(str(tmp_path), async_flush=False)
    g = torch.Generator().manual_seed(0)
    tree = ({"layers": {"w": torch.randn((2, 16, 32), generator=g)}},
            {"step": torch.tensor(3, dtype=torch.int32)})
    store.save(7, tree).result()
    got, _, step = resize(store, tree, make_host_mesh("cpu"))
    assert step == 7
    assert torch.equal(got[0]["layers"]["w"], tree[0]["layers"]["w"])
    assert got[0]["layers"]["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="cannot place"):
        resize(store, tree, make_production_mesh())
    with pytest.raises(ValueError, match="not the mesh's"):
        resize(store, tree, make_host_mesh("cpu"), device="meta")
