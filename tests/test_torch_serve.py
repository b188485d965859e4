"""The port's serving control plane and server against the JAX package's:
the consistent-hash ring, the per-op DAC, the prefix cache and the paged
store's controller must decide exactly as the reference does (same
owners, same cache statistics, same pages), and ``PagedServer`` with the
reference's weights carried across must give the same logits (5e-2, the
bar of tests/test_serve_equivalence.py: bf16 activations rounded in
other places by XLA and torch), the same greedy tokens, statistics and
local-copy ratios, and logits unchanged by a reconfiguration (1e-4, the
reference server's own bar)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dac as jdac  # noqa: E402
from repro.core import hashring as jhr  # noqa: E402
from repro.kvcache import paged_store as jps  # noqa: E402
from repro.kvcache import prefix_cache as jpc  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import dac as tdac  # noqa: E402
from repro_torch.core import hashring as thr  # noqa: E402
from repro_torch.kernels import decode_attention as td  # noqa: E402
from repro_torch.kvcache import paged_store as tps  # noqa: E402
from repro_torch.kvcache import prefix_cache as tpc  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("vnodes", [8, 32, 64])
def test_hashring_owners_match_reference(vnodes):
    keys = [("page", i) for i in range(300)] + list(range(200)) + \
        [f"k{i}" for i in range(100)] + [b"\x00\xffab"]
    assert [thr.stable_hash(k) for k in keys] == \
        [jhr.stable_hash(k) for k in keys]
    a = thr.HashRing(["w0", "w1", "w2"], vnodes=vnodes)
    b = jhr.HashRing(["w0", "w1", "w2"], vnodes=vnodes)
    for step in (None, ("add", "w3"), ("remove", "w1"), ("add", "w1"),
                 ("remove", "w9"), ("add", "w0")):
        if step:
            getattr(a, step[0])(step[1])
            getattr(b, step[0])(step[1])
        assert a.members == b.members and len(a) == len(b)
        assert ("w3" in a) == ("w3" in b)
        assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
    with pytest.raises(RuntimeError, match="empty"):
        thr.HashRing().owner(1)


def dac_state(d):
    return (d.stats.__dict__, list(d.values), sorted(d.shortcuts),
            {k: (e.ptr, e.length, e.count) for k, e in
             {**d.values, **d.shortcuts}.items()}, d.used, d.avg_miss_rts)


@pytest.mark.parametrize("capacity,seed", [(41 * 8, 0), (41 * 3 + 64, 1),
                                           (2000, 2)])
def test_dac_matches_reference_on_a_random_op_stream(capacity, seed):
    rng = np.random.default_rng(seed)
    a, b = tdac.DAC(capacity), jdac.DAC(capacity)
    for _ in range(3000):
        op = rng.choice(["lookup"] * 6 + ["miss", "write", "inval",
                                          "demote", "ptr", "rts"])
        key = int(rng.zipf(1.3)) % 40
        length = int(rng.integers(1, 30))
        for d in (a, b):
            if op == "lookup":
                got = d.lookup(key)
                if got is None:
                    d.fill_after_miss(key, ptr=key * 10, length=length)
            elif op == "miss":
                d.fill_after_miss(key, ptr=key, length=length)
            elif op == "write":
                d.fill_after_write(key, key + 1, length, bool(length % 2))
            elif op == "inval":
                d.invalidate(key)
            elif op == "demote":
                d.demote_to_shortcut(key)
            elif op == "ptr":
                d.update_pointer(key, key + 2, length)
            else:
                d.note_miss_rts(float(length) / 7)
        assert dac_state(a) == dac_state(b), op
    assert a.stats.lookups == b.stats.lookups
    assert a.stats.hit_ratio == b.stats.hit_ratio
    assert (a.num_values, a.num_shortcuts) == (b.num_values, b.num_shortcuts)


def controllers(num_pages=64, page_size=4):
    return (tps.PagedKVController(num_pages, page_size, ["w0", "w1"]),
            jps.PagedKVController(num_pages, page_size, ["w0", "w1"]))


def test_paged_controller_and_prefix_cache_match_reference():
    rng = np.random.default_rng(3)
    (tc, jc) = controllers()
    tp, jp = tpc.PrefixCache(tc, max_entries=6), jpc.PrefixCache(jc,
                                                                 max_entries=6)
    shared = [int(t) for t in rng.integers(0, 512, 8)]
    for sid in range(8):
        prompt = shared[:int(rng.integers(0, 9))] + \
            [int(t) for t in rng.integers(0, 512, int(rng.integers(1, 9)))]
        got, want = tp.lookup(prompt), jp.lookup(prompt)
        assert got == want
        for ctl, pc in ((tc, tp), (jc, jp)):
            ctl.new_sequence(sid)
            if want[1]:
                pc.attach(sid, *want)
            for _ in prompt[want[1]:]:
                ctl.append_slot(sid)
            pc.seal_prefix(sid, prompt)
        assert tc.page_tables([sid]).keys() == jc.page_tables([sid]).keys()
        if sid == 4:
            tc.add_worker("w2")
            jc.add_worker("w2")
        if sid == 6:
            tc.remove_worker("w0")
            jc.remove_worker("w0")
    sids = list(range(8))
    got, want = tc.page_tables(sids, pad_to=6), jc.page_tables(sids, pad_to=6)
    assert got.keys() == want.keys()
    for w in want:
        for x, y in zip(got[w], want[w]):
            np.testing.assert_array_equal(x, y)
    assert {k: (n.pages, n.hits) for k, n in tp.table.items()} == \
        {k: (n.pages, n.hits) for k, n in jp.table.items()}
    assert tp.hot_prefixes(1) == jp.hot_prefixes(1)
    assert tc.stats == jc.stats and tc.workers == jc.workers
    assert [tc.local_copy_ratio(w) for w in tc.workers] == \
        [jc.local_copy_ratio(w) for w in jc.workers]
    np.testing.assert_array_equal(tc.refcount, jc.refcount)
    for sid in (1, 5):
        tc.release(sid)
        jc.release(sid)
    assert tc.free == jc.free
    with pytest.raises(RuntimeError, match="exhausted"):
        tc.new_sequence(99)
        for _ in range(64 * 4):
            tc.append_slot(99)


def test_pool_append_and_decode_over_owners():
    rng = np.random.default_rng(4)
    L, NP, PS, KH, D = 2, 16, 8, 2, 16
    tpool = tps.pool_init(L, NP, PS, KH, D, torch.float32, device="cpu")
    jpool = jps.pool_init(L, NP, PS, KH, D, jnp.float32)
    tc, jc = controllers(NP, PS)
    for ctl in (tc, jc):
        ctl.new_sequence(0)
    for _ in range(20):
        kv = rng.standard_normal((2, L, KH, D)).astype(np.float32)
        (pid, off), _ = tc.append_slot(0), jc.append_slot(0)
        assert tps.pool_append(tpool, pid, off, torch.from_numpy(kv[0]),
                               torch.from_numpy(kv[1])) is tpool
        jpool = jps.pool_append(jpool, pid, off, jnp.asarray(kv[0]),
                                jnp.asarray(kv[1]))
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jpool.k))
    q = rng.standard_normal((1, 4, D)).astype(np.float32)
    for action in (None, "w2", "w3"):
        if action:
            tc.add_worker(action)
            jc.add_worker(action)
        got = tps.decode_over_owners(torch.from_numpy(q), tpool, 1,
                                     tc.page_tables([0]), [20])
        want = jps.decode_over_owners(jnp.asarray(q), jpool, 1,
                                      jc.page_tables([0]), [20])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def as_f32(tree):
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.float()


def serve_pair(arch, f32_weights=False):
    """The reference's smoke server of ``arch`` and the port's, with one
    set of weights (f32 on both sides with ``f32_weights``), fed the same
    requests: 4 prompts of 10 tokens sharing an 8-token prefix, a worker
    added after the second, then 3 greedy decode steps each."""
    jsrv = jserve.PagedServer(arch, page_size=4, seed=3)
    tsrv = tserve.PagedServer(arch, page_size=4, seed=3, device="cpu")
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), jsrv.params)
    tsrv.params = state.params_from_jax(host, tsrv.cfg, device="cpu")
    if f32_weights:
        jsrv.params = jax.tree.map(lambda x: x.astype(jnp.float32),
                                   jsrv.params)
        tsrv.params = as_f32(tsrv.params)
    rng = np.random.default_rng(1)
    shared = [int(t) for t in rng.integers(0, tsrv.cfg.vocab_size, 8)]
    out = {"admit": [], "reconfig": [], "decode": []}
    for r in range(4):
        prompt = shared + [int(t) for t in rng.integers(
            0, tsrv.cfg.vocab_size, 2)]
        pair = [srv.admit(prompt) for srv in (jsrv, tsrv)]
        out["admit"].append(pair)
        if r == 1:
            for srv in (jsrv, tsrv):
                before = srv.logits_for_next(0)
                srv.reconfigure(add="w2")
                out["reconfig"].append((before, srv.logits_for_next(0)))
    for sid in range(4):
        out["decode"].append([srv.decode(sid, 3) for srv in (jsrv, tsrv)])
    return jsrv, tsrv, out


@pytest.fixture(scope="module")
def servers():
    return serve_pair("qwen1.5-0.5b")


def test_server_admit_logits_match_reference(servers):
    _, _, out = servers
    for (jsid, jlog), (tsid, tlog) in out["admit"]:
        assert jsid == tsid
        assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (512,)
        np.testing.assert_allclose(f32(tlog), f32(jlog), atol=5e-2,
                                   rtol=5e-2)


def test_server_decode_stats_and_ratios_match_reference(servers):
    jsrv, tsrv, out = servers
    for jtoks, ttoks in out["decode"]:
        assert ttoks == jtoks
    assert tsrv.stats == jsrv.stats
    assert tsrv.stats["prefix_hits"] == 3
    assert tsrv.ctl.stats == jsrv.ctl.stats
    assert tsrv.ctl.workers == jsrv.ctl.workers == ["w0", "w1", "w2"]
    assert [tsrv.ctl.local_copy_ratio(w) for w in tsrv.ctl.workers] == \
        [jsrv.ctl.local_copy_ratio(w) for w in jsrv.ctl.workers]
    for w in jsrv.ctl.workers:
        assert tsrv.ctl.dac[w].stats.__dict__ == \
            jsrv.ctl.dac[w].stats.__dict__
    assert {s: q.pages for s, q in tsrv.ctl.sequences.items()} == \
        {s: q.pages for s, q in jsrv.ctl.sequences.items()}
    assert tsrv.tokens == jsrv.tokens
    np.testing.assert_allclose(f32(tsrv.pool.k), f32(jsrv.pool.k),
                               atol=5e-2, rtol=5e-2)


def test_server_logits_survive_reconfiguration(servers):
    _, _, out = servers
    (jb, ja), (tb, ta) = out["reconfig"]
    np.testing.assert_allclose(f32(ta), f32(tb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(ja), f32(jb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(tb), f32(jb), atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module", params=["llama3.2-3b", "olmoe-1b-7b",
                                        "chameleon-34b"])
def family_servers(request):
    """The same requests on the llama (dense, GQA group 3), olmoe (MoE)
    and chameleon (VLM) smoke servers. llama's and olmoe's run with f32
    weights on both sides. Greedy decode and top-k routing are
    discontinuous: where the two best logits, or a token's top experts,
    nearly tie, bf16 rounded in other places by XLA and torch picks
    another token or expert (at bf16, llama's third greedy token of one
    request differs: 395 against 185), and every later step follows it.
    chameleon's runs in bf16."""
    arch = request.param
    return serve_pair(arch, f32_weights=arch != "chameleon-34b")


def test_family_server_admit_logits_match_reference(family_servers):
    jsrv, tsrv, out = family_servers
    assert tsrv.cfg.__dict__ == jsrv.cfg.__dict__
    for (jsid, jlog), (tsid, tlog) in out["admit"]:
        assert jsid == tsid
        assert tlog.dtype == torch.float32
        assert tuple(tlog.shape) == (tsrv.cfg.vocab_size,)
        np.testing.assert_allclose(f32(tlog), f32(jlog), atol=5e-2,
                                   rtol=5e-2)


def test_family_server_decode_and_stats_match_reference(family_servers):
    jsrv, tsrv, out = family_servers
    for jtoks, ttoks in out["decode"]:
        assert ttoks == jtoks
    assert tsrv.stats == jsrv.stats
    assert tsrv.stats["prefix_hits"] == 3
    assert tsrv.ctl.stats == jsrv.ctl.stats
    assert {s: q.pages for s, q in tsrv.ctl.sequences.items()} == \
        {s: q.pages for s, q in jsrv.ctl.sequences.items()}
    assert tsrv.tokens == jsrv.tokens
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(getattr(tsrv.pool, name)),
                                   f32(getattr(jsrv.pool, name)),
                                   atol=5e-2, rtol=5e-2)


def test_family_server_logits_survive_reconfiguration(family_servers):
    _, _, out = family_servers
    (jb, ja), (tb, ta) = out["reconfig"]
    np.testing.assert_allclose(f32(ta), f32(tb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(tb), f32(jb), atol=5e-2, rtol=5e-2)


def test_server_refuses_the_ssm_family():
    with pytest.raises(ValueError, match="attention families"):
        tserve.PagedServer("mamba2-2.7b", device="cpu")


@pytest.mark.parametrize("batch,workers", [(1, 3), (2, 3), (1, 5)])
def test_stacked_owners_equal_the_per_owner_loop_and_the_reference(
        batch, workers):
    """decode_over_owners stacks every owner's table as rows of one call:
    on the CPU that equals, bit for bit, the per-owner loop it replaces
    (one call per owner, merged in worker order), and the JAX package's
    decode_over_owners at 2e-5 (f32, another order of sums)."""
    rng = np.random.default_rng(batch * 10 + workers)
    L, NP, PS, KH, D, H = 2, 64, 4, 2, 16, 4
    names = [f"w{i}" for i in range(workers)]
    tc = tps.PagedKVController(NP, PS, names)
    jc = jps.PagedKVController(NP, PS, names)
    kv = rng.standard_normal((2, L, NP, PS, KH, D)).astype(np.float32)
    tpool = tps.PagePool(k=torch.from_numpy(kv[0]), v=torch.from_numpy(kv[1]))
    jpool = jps.PagePool(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    lengths = []
    for sid in range(batch):
        n = int(rng.integers(20, 60))
        for ctl in (tc, jc):
            ctl.new_sequence(sid)
            for _ in range(n):
                ctl.append_slot(sid)
        lengths.append(n)
    sids = list(range(batch))
    tables = tc.page_tables(sids)
    assert tables.keys() == jc.page_tables(sids).keys()
    assert sum(bool((pt >= 0).sum()) for pt, _ in tables.values()) > 1
    q = rng.standard_normal((batch, H, D)).astype(np.float32)
    qt = torch.from_numpy(q)
    for layer in range(L):
        got = tps.decode_over_owners(qt, tpool, layer, tables, lengths)
        lens = torch.tensor(lengths, dtype=torch.int32)
        parts = [td.paged_decode_partial(qt, tpool.k[layer], tpool.v[layer],
                                         torch.from_numpy(pt),
                                         torch.from_numpy(pos), lens)
                 for pt, pos in tables.values() if (pt >= 0).sum()]
        loop = td.normalize(*td.merge_partials(parts))
        assert torch.equal(got, loop)
        want = jps.decode_over_owners(jnp.asarray(q), jpool, layer,
                                      jc.page_tables(sids), lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_stack_owners_sends_one_table_per_owner_with_pages():
    tables = {"a": (np.array([[3, -1]], np.int32), np.array([[0, 0]],
                                                            np.int32)),
              "b": (np.array([[-1, -1]], np.int32), np.zeros((1, 2),
                                                             np.int32)),
              "c": (np.array([[5, 7]], np.int32), np.array([[8, 16]],
                                                           np.int32))}
    st = tps.stack_owners(tables, [20], "cpu")
    assert st.owners == 2
    assert st.page_table.tolist() == [[3, -1], [5, 7]]
    assert st.page_pos.tolist() == [[0, 0], [8, 16]]
    assert st.lengths.tolist() == [20, 20]
    assert st.page_table.is_contiguous() and st.lengths.dtype == torch.int32
    assert tps.stack_owners({"b": tables["b"]}, [20], "cpu") is None
