"""The port's CUDA kernels against their plain torch versions, on the
card (marked ``cuda``; they skip without one). The integer kernels are
compared exactly, the float kernels at the stated tolerances.

On the card, where JAX is absent, run them without the repository's
conftest (which loads the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import clht_probe as tp  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def filled(dev, nb, nkeys, space, seed, overflow=None, width=8):
    g = np.random.default_rng(seed)
    keys = torch.from_numpy(g.choice(space, nkeys, replace=False)
                            .astype(np.int32)).to(dev)
    table = tc.clht_init(nb, overflow, device=dev)
    heap = tl.heap_init(nkeys, width, device=dev)
    vals = torch.from_numpy(g.integers(0, 2**31 - 1, (nkeys, width))
                            .astype(np.int32)).to(dev)
    heap, ptrs = tl.heap_append(heap, vals)
    tc.clht_insert(table, keys, ptrs)
    return table, heap, keys, g


@pytest.mark.parametrize("nb,nkeys,width", [(64, 300, 8), (1024, 4000, 256),
                                            (256, 900, 6)])
def test_probe_and_fused_lookup_match_plain(dev, nb, nkeys, width):
    table, heap, keys, g = filled(dev, nb, nkeys, 10 * nkeys, nb,
                                  width=width)
    probe = torch.cat([keys[::2], torch.tensor([-1, -3, 10**8], device=dev,
                                               dtype=torch.int32)])
    bids = tc.bucket_of(probe, nb)
    n0 = _build.launches["clht_probe"]
    for got, ref in zip(tp.clht_probe(table.lines, bids, probe),
                        tp.clht_probe_ref(table.lines, bids, probe)):
        assert torch.equal(got, ref)
    assert _build.launches["clht_probe"] == n0 + 1
    for got, ref in zip(
            tp.kvs_lookup_fused(table.lines, heap.data, bids, probe),
            tp.kvs_lookup_fused_ref(table.lines, heap.data, bids, probe)):
        assert torch.equal(got, ref)
    real = probe[probe >= 0]
    for got, ref in zip(tp.kvs_lookup(table, heap, real),
                        tp.kvs_lookup_ref(table, heap, real)):
        assert torch.equal(got, ref)


def probe_equal(lines, bids, keys):
    """Kernel A against its plain version, bit for bit, one counted
    launch."""
    want = tp.clht_probe_ref(lines.cpu(), bids.cpu(), keys.cpu())
    n0 = _build.launches["clht_probe"]
    got = tp.clht_probe(lines, bids, keys)
    assert _build.launches["clht_probe"] == n0 + (keys.numel() > 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [1, 31, 33, 4097, 1 << 20])
def test_probe_redesign_matches_plain_at_sizes(dev, n):
    """Kernel A on a filled table with chains, at batch sizes around a
    warp and the read-back's 2^20 keys (more than one pass of the grid
    the card holds, and not a multiple of it): present keys, absent keys,
    negative keys and bucket ids out of range on both sides."""
    nb = 1 << 12
    table, _, keys, g = filled(dev, nb, 3 * nb, 1 << 24, n % 997, width=4)
    pick = torch.from_numpy(g.integers(0, keys.numel(), n)).to(dev)
    probe = keys[pick]
    probe[torch.from_numpy(g.random(n) < 0.2).to(dev)] = 77_777_777
    probe[torch.from_numpy(g.random(n) < 0.05).to(dev)] = -1
    bids = tc.bucket_of(probe, nb)
    wild = torch.from_numpy(g.random(n) < 0.05).to(dev)
    bids[wild] = torch.from_numpy(g.choice(
        [-5, -1, table.total_buckets, 2**31 - 1], n).astype(np.int32)
                                  ).to(dev)[wild]
    probe_equal(table.lines, bids, probe)


def test_probe_redesign_adversarial_lines(dev):
    """Lines that no insert makes: empty and full lines, a key twice and
    three times in one line (the pointers' 32-bit wrapping sum), keys
    equal to the empty mark, the chain link or the pad, negative probe
    keys, and pointers at int32's ends."""
    g = np.random.default_rng(11)
    tb = 4096
    lines = g.integers(0, 6, (tb, 8)).astype(np.int32)
    lines[:, 3:6] = g.choice([0, 1, 2**31 - 1, -2**31, -1, 12345],
                             (tb, 3))
    lines[g.random(tb) < 0.1, :3] = -1                  # empty lines
    lines[:, 6] = g.choice([-1, 3, 5], tb)               # links 'match'
    lines[:, 7] = g.choice([-1, 4], tb)                  # pad 'matches'
    lines = torch.from_numpy(lines).to(dev)
    for n in (1, 31, 4097, 1 << 16):
        keys = torch.from_numpy(g.integers(-3, 7, n).astype(np.int32)
                                ).to(dev)
        bids = torch.from_numpy(g.integers(-2, tb + 2, n).astype(np.int32)
                                ).to(dev)
        probe_equal(lines, bids, keys)
    twice = torch.tensor([[5, 5, 5, 2**31 - 1, 1, 7, -1, -1],
                          [4, 9, 4, 10, 20, 30, -1, -1]], dtype=torch.int32,
                         device=dev)
    ptrs, found = tp.clht_probe(twice, torch.tensor([0, 1, 1], device=dev,
                                                    dtype=torch.int32),
                                torch.tensor([5, 4, 9], device=dev,
                                             dtype=torch.int32))
    assert ptrs.tolist() == [-2**31 + 7, 40, 20] and found.tolist() == [1] * 3


def test_pool_mirror_on_the_card(dev):
    """The DPM pool's packed copy of its index on the card, after rounds
    of writes that grow chains, tombstones (deletes), budgeted and full
    merges, replicated keys and a recovery: every batched read (kernel A
    and the chain walk) equals the host index's walk, the copy equals
    the host index row for row, and a pool on the CPU returns the same."""
    g = np.random.default_rng(5)
    pools = [DPMPool(num_buckets=64, segment_capacity=16, device=d)
             for d in (dev, "cpu")]
    for p in pools:
        for kn in ("a", "b"):
            p.register_kn(kn)
    space = 400
    reads = np.concatenate([np.arange(space), [-1, -3, 10**6]])
    for r in range(12):
        ops = g.integers(0, space, 96)
        tomb = g.random(96) < 0.1
        n0 = _build.launches["clht_probe"]
        outs = []
        for p in pools:
            for kn, sel in (("a", ops % 2 == 0), ("b", ops % 2 == 1)):
                keys = np.where(tomb, -ops - 1, ops)[sel].tolist()
                p.log_write_batch(kn, keys, [f"v{r}"] * len(keys),
                                  [4] * len(keys))
            p.merge_budget(40)
            if r == 5:
                p.merge_all()
                p.install_indirect(int(ops[0]))
            if r == 8:
                p.recover_kn("a")
            outs.append(p.index_lookup_batch(reads))
        assert _build.launches["clht_probe"] == n0 + 1
        host = pools[0].index.lookup_batch(reads)
        plain = ~np.isin(reads, list(pools[0].indirect))
        for got, cpu, h in zip(outs[0], outs[1], host):
            assert np.array_equal(got, cpu)
            assert np.array_equal(got[plain], h[plain])
        t, ix = pools[0].index_dev, pools[0].index
        lines = t.lines.cpu().numpy()
        assert np.array_equal(lines[:, :3], ix.keys)
        assert np.array_equal(lines[:, 3:6], ix.ptrs)
        assert np.array_equal(lines[:, 6], ix.nxt)
        assert int(t.overflow_head) == ix.overflow_head
    assert pools[0].index.overflow_head > 64        # chains grew
    assert pools[0].verify_integrity() == pools[1].verify_integrity()


@pytest.mark.parametrize("nb,n,space", [(128, 200, 30), (32, 220, 3),
                                        (512, 400, 6)])
def test_merge_segment_planned_on_the_card(dev, nb, n, space):
    """The planned merge on the card's table (bulk scatters, its tail
    through kernel D) equals the same merge on the CPU and
    merge_segment_fast on the card."""
    g = np.random.default_rng(n)
    keys = torch.from_numpy(g.integers(0, nb * space, n).astype(np.int32))
    pre = torch.from_numpy(g.integers(0, nb * space, nb).astype(np.int32))
    outs = []
    for d, fn in ((dev, tm.merge_segment_planned), ("cpu",
                                                    tm.merge_segment_planned),
                  (dev, tm.merge_segment_fast)):
        t = tc.clht_init(nb, device=d)
        tc.clht_insert(t, pre.to(d), pre.to(d) + 9000)
        seg = tl.segment_init(n + 8, device=d)
        tl.log_append(seg, keys.to(d),
                      torch.arange(n, dtype=torch.int32, device=d) + 5000)
        t, old, ok = fn(t, seg)
        outs.append([x.cpu() for x in (t.lines, t.overflow_head, old, ok)])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("nb,entries,space", [(64, 500, 2), (16, 2000, 6)])
def test_log_merge_matches_plain(dev, nb, entries, space):
    table, _, _, g = filled(dev, nb, nb, nb * space, 3)
    keys = torch.from_numpy(g.integers(0, nb * space, entries)
                            .astype(np.int32)).to(dev)
    keys[::13] = -3
    ptrs = torch.arange(entries, dtype=torch.int32, device=dev)
    bids = tc.bucket_of(keys.clamp(min=0), nb)
    lines_k, lines_r = table.lines.clone(), table.lines.clone()
    _, old_k, ok_k = tm.log_merge(lines_k, bids, keys, ptrs)
    bs, order, starts = tm.sort_by_bucket(bids)
    old_s, ok_s = tm.log_merge_sorted_ref(lines_r, starts, bs,
                                          keys[order], ptrs[order])
    assert torch.equal(lines_k, lines_r)
    assert torch.equal(old_k[order], old_s)
    assert torch.equal(ok_k[order], ok_s)


@pytest.mark.parametrize("nb,overflow,n", [(64, None, 600), (32, 8, 800)])
def test_clht_insert_matches_plain(dev, nb, overflow, n):
    g = np.random.default_rng(n)
    keys = torch.from_numpy(g.integers(0, 3 * n, n).astype(np.int32)).to(dev)
    ptrs = torch.arange(n, dtype=torch.int32, device=dev)
    mask = torch.from_numpy(g.random(n) < 0.9).to(dev)
    a = tc.clht_init(nb, overflow, device=dev)
    b = tc.clht_init(nb, overflow, device=dev)
    got = tc.clht_insert(a, keys, ptrs, mask)
    ref = tc.clht_insert_plain(b, keys, ptrs, mask)
    assert torch.equal(a.lines, b.lines)
    assert int(a.overflow_head) == int(b.overflow_head)
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)


def chain_keys(nb, bucket, count, start=0):
    """``count`` distinct keys from ``start`` up whose primary bucket is
    ``bucket``."""
    cand = torch.arange(start, start + 400 * count * nb, dtype=torch.int32)
    sel = cand[tc.bucket_of(cand, nb) == bucket][:count]
    assert sel.numel() == count
    return sel.numpy()


def insert_case(name):
    """Adversarial batches for kernel D: (nb, overflow, keys inserted
    first, keys, ptrs)."""
    g = np.random.default_rng(len(name))
    if name == "long_chains":        # chains far past MAX_CHAIN lines
        nb, ov, pre = 4, 4096, None
        keys = g.integers(0, 1500, 3000)
    elif name == "hot_key_in_overflow":
        # bucket 5 holds three keys; the hot key sits in an overflow line
        # and repeats 4000 times among 300 fresh keys of its own chain
        nb, ov = 64, 1024
        own = chain_keys(nb, 5, 304)
        pre, hot, fresh = own[:4], own[3], own[4:]
        keys = np.concatenate([np.full(4000, hot), fresh,
                               g.integers(0, 10**6, 300)])
        keys = keys[g.permutation(keys.size)]
    else:                            # exhaustion mid-batch, duplicates after
        assert name == "exhaustion"
        nb, ov, pre = 16, 6, None
        keys = g.integers(0, 400, 1500)
    keys = keys.astype(np.int32)
    ptrs = g.integers(0, 2**31 - 1, keys.size).astype(np.int32)
    return nb, ov, pre, keys, ptrs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["long_chains", "hot_key_in_overflow",
                                  "exhaustion"])
def test_clht_insert_adversarial_matches_plain(dev, name, masked):
    """Kernel D's parallel per-chain insert against the sequential plain
    version, bit for bit, where its shortcuts are tested hardest."""
    nb, ov, pre, keys, ptrs = insert_case(name)
    g = np.random.default_rng(7)
    mask = torch.from_numpy(g.random(keys.size) < 0.8).to(dev) \
        if masked else None
    a = tc.clht_init(nb, ov, device=dev)
    if pre is not None:
        tc.clht_insert_plain(a, torch.from_numpy(pre).to(dev),
                             torch.from_numpy(pre).to(dev) + 9)
    b = tc.CLHT(a.lines.clone(), a.overflow_head.clone(), nb)
    kd, pd = torch.from_numpy(keys).to(dev), torch.from_numpy(ptrs).to(dev)
    n0 = _build.launches["clht_insert"]
    got = tc.clht_insert(a, kd, pd, mask)
    assert _build.launches["clht_insert"] == n0 + 1
    ref = tc.clht_insert_plain(b, kd, pd, mask)
    assert torch.equal(a.lines, b.lines)
    assert int(a.overflow_head) == int(b.overflow_head)
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)
    if name == "exhaustion":
        assert int(a.overflow_head) == a.total_buckets
        okv = ref[2] if mask is None else ref[2][mask]
        assert bool(okv.any()) and not bool(okv.all())


def test_write_path_and_read_back(dev):
    table = tc.clht_init(128, device=dev)
    seg = tl.segment_init(2000, device=dev)
    heap = tl.heap_init(2000, 16, device=dev)
    g = np.random.default_rng(1)
    last = {}
    for _ in range(4):
        keys = torch.from_numpy(g.integers(0, 700, 400).astype(np.int32))
        vals = torch.from_numpy(g.integers(0, 99, (400, 16)).astype(np.int32))
        table, seg, heap, ptrs, _, ok = tm.log_append_merge(
            table, seg, heap, keys.to(dev), vals.to(dev))
        for k, p, o, v in zip(keys.tolist(), ptrs.tolist(), ok.tolist(),
                              vals):
            if o:
                last[k] = (p, v)
    probe = torch.tensor(sorted(last), dtype=torch.int32, device=dev)
    vals, ptrs, found = tp.kvs_lookup(table, heap, probe)
    assert bool(found.all())
    assert ptrs.tolist() == [last[k][0] for k in sorted(last)]
    assert torch.equal(vals.cpu(), torch.stack([last[k][1]
                                                for k in sorted(last)]))


def test_wrappers_refuse_bad_inputs(dev):
    table = tc.clht_init(8, device=dev)
    keys = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tp.clht_probe(table.lines, tc.bucket_of(keys, 8), keys.long())
    with pytest.raises(ValueError):
        tp.clht_probe(table.lines, tc.bucket_of(keys, 8)[::1], keys[::2])
    with pytest.raises(ValueError):
        tp.clht_probe(table.lines[:, :4], tc.bucket_of(keys, 8), keys)


# --------------------------------------------------------- attention kernels
# f32: the kernels and their plain versions compute the same f32 softmax in
# another order of sums (3e-5 / 2e-5, test_kernels.py's bars); bf16: the
# flash kernel rounds p to bf16 for P.V and its output to bf16, 2^-8
# relative (2.5e-2 / 3e-2, test_kernels.py's bf16 bars).
from repro_torch.kernels import decode_attention as td  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,dtype", [
    (1, 4, 4, 64, 64, 32, True, torch.float32),
    (2, 8, 2, 128, 128, 64, True, torch.bfloat16),
    (1, 4, 1, 32, 128, 32, False, torch.float32),
    (1, 2, 2, 256, 256, 16, True, torch.float32),
    (2, 4, 2, 200, 200, 64, True, torch.bfloat16),   # ragged tiles
    (1, 4, 4, 64, 64, 32, True, torch.bfloat16),
    (1, 2, 2, 256, 256, 16, True, torch.bfloat16),
    (1, 4, 2, 100, 300, 64, False, torch.bfloat16),
    (1, 16, 16, 2048, 2048, 64, True, torch.bfloat16),
    # the wgmma kernel's edges: one query, ragged 128-row blocks, GQA
    # group 4, head dims 16 and 32, non-causal Sq != Sk both ways
    (1, 4, 1, 1, 1, 64, True, torch.bfloat16),
    (1, 8, 2, 127, 127, 64, True, torch.bfloat16),
    (2, 4, 1, 128, 128, 32, True, torch.bfloat16),
    (1, 4, 4, 129, 129, 16, True, torch.bfloat16),
    (1, 8, 2, 200, 200, 32, True, torch.bfloat16),
    (1, 4, 1, 77, 300, 16, False, torch.bfloat16),
    (1, 4, 2, 300, 77, 32, False, torch.bfloat16),
    (1, 8, 2, 2048, 2048, 32, True, torch.bfloat16),
    (1, 4, 4, 2048, 2048, 16, True, torch.bfloat16),
])
def test_flash_attention_matches_plain(dev, b, h, kh, sq, sk, d, causal,
                                       dtype):
    g = torch.Generator(device=dev).manual_seed(sq)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
    n0 = _build.launches["flash_attention"]
    got = tf.flash_attention(q, k, v, causal=causal)
    assert _build.launches["flash_attention"] == n0 + 1
    ref = tf.mha_ref(q, k, v, causal=causal)
    tol = 2.5e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    # model layout through strides, no copy
    out = tf.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal)
    torch.testing.assert_close(out.transpose(1, 2).float(), got.float(),
                               atol=0, rtol=0)


def test_flash_attention_refuses_unaligned_bf16_rows(dev):
    q = torch.zeros((1, 2, 8, 20), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tf.flash_attention(q[..., 2:18], q[..., 2:18], q[..., 2:18])
    with pytest.raises(ValueError, match="head dim"):
        tf.flash_attention(q, q, q)


def paged_case(dev, b, h, kh, d, ps, npages, p, dtype, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, d))).to(dev, dtype)
    kp = torch.from_numpy(rng.standard_normal((npages, ps, kh, d))
                          ).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((npages, ps, kh, d))
                          ).to(dev, dtype)
    pt = np.full((b, p), -1, np.int32)
    pos = np.zeros((b, p), np.int32)
    lens = np.zeros((b,), np.int32)
    for bi in range(b):
        used = rng.integers(1, p + 1)
        pt[bi, :used] = rng.choice(npages, used, replace=False)
        pos[bi, :used] = np.arange(used) * ps
        lens[bi] = (used - 1) * ps + rng.integers(1, ps + 1)
    return q, kp, vp, pt, pos, lens


def assert_partials_close(got, ref, tol):
    acc, m, l = got
    racc, rm, rl = ref
    torch.testing.assert_close(acc, racc, atol=tol, rtol=tol)
    torch.testing.assert_close(l, rl, atol=tol, rtol=tol)
    torch.testing.assert_close(m, rm, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,kh,d,ps,npages,p,dtype", [
    (2, 8, 2, 32, 16, 12, 4, torch.float32),
    (1, 4, 4, 64, 8, 20, 6, torch.float32),
    (2, 4, 2, 16, 16, 8, 2, torch.bfloat16),
    (3, 16, 16, 64, 8, 300, 40, torch.float32),      # the server's shapes
    (2, 32, 4, 128, 16, 64, 9, torch.bfloat16),      # GQA group 8
])
def test_paged_decode_matches_plain(dev, b, h, kh, d, ps, npages, p, dtype):
    q, kp, vp, pt, pos, lens = paged_case(dev, b, h, kh, d, ps, npages, p,
                                          dtype, npages)
    tables = [torch.from_numpy(x).to(dev) for x in (pt, pos, lens)]
    for qq in (q, q.to(torch.bfloat16)):       # mixed types: bf16 q
        n0 = _build.launches["paged_decode_attention"]
        got = td.paged_decode_attention(qq, kp, vp, *tables)
        assert _build.launches["paged_decode_attention"] == n0 + 1
        ref = td.paged_decode_ref(qq, kp, vp, *tables)
        assert_partials_close(got, ref,
                              3e-2 if dtype == torch.bfloat16 else 2e-5)


def server_case(dev, context, owners=1, slots=None, seed=0, ps=8, kh=16,
                d=64):
    """The server's shape (f32 pages of 8 tokens, 16 kv heads of 64, one
    query head each): one sequence of ``context`` tokens whose pages are
    dealt round-robin to ``owners`` owners, each owner's table compacted
    to the front and padded with -1 to ``slots``, one row per owner."""
    rng = np.random.default_rng(seed)
    npages = -(-context // ps)
    slots = slots or npages
    pool = npages + 8
    kp = torch.from_numpy(rng.standard_normal((pool, ps, kh, d)).astype(
        np.float32)).to(dev)
    vp = torch.from_numpy(rng.standard_normal((pool, ps, kh, d)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((1, kh, d)).astype(
        np.float32)).to(dev)
    pids = rng.choice(pool, npages, replace=False)
    pt = np.full((owners, slots), -1, np.int32)
    pos = np.zeros((owners, slots), np.int32)
    for j, pid in enumerate(pids):
        o, c = j % owners, j // owners
        pt[o, c], pos[o, c] = pid, j * ps
    lens = np.full((owners,), context, np.int32)
    tables = [torch.from_numpy(x).to(dev) for x in (pt, pos, lens)]
    return q, kp, vp, tables


@pytest.mark.parametrize("context", [1, 7, 64, 65, 120, 2048, 4096])
def test_paged_decode_splits_match_plain(dev, context):
    """One sequence at the server's widths, from one split to many: each
    launch merges its splits in-kernel and equals the plain version."""
    q, kp, vp, tables = server_case(dev, context)
    slots = tables[0].shape[1]
    n = td.split_count(16, slots, 8)
    assert (n > 1) == (context >= 128)
    n0 = _build.launches["paged_decode_attention"]
    got = td.paged_decode_attention(q, kp, vp, *tables)
    assert _build.launches["paged_decode_attention"] == n0 + 1
    assert_partials_close(got, td.paged_decode_ref(q, kp, vp, *tables), 2e-5)
    # the counters are left at zero: the next launch gives the same
    again = td.paged_decode_attention(q, kp, vp, *tables)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def test_paged_decode_stacked_owners_equal_separate_calls(dev):
    """The server's three owners as three rows of one call (q a stride-0
    view, lengths repeated) give each owner's separate call bit for bit,
    where both split the slots alike, as at the server's 41 slots."""
    q, kp, vp, (pt, pos, lens) = server_case(dev, 120, owners=3, slots=41)
    assert td.split_count(3 * 16, 41, 8) == td.split_count(16, 41, 8) > 1
    stacked = td.paged_decode_attention(q.expand(3, -1, -1), kp, vp, pt, pos,
                                        lens)
    for o in range(3):
        alone = td.paged_decode_attention(q, kp, vp, pt[o:o + 1],
                                          pos[o:o + 1], lens[o:o + 1])
        for x, y in zip(stacked, alone):
            assert torch.equal(x[o:o + 1], y)
    assert_partials_close(stacked, td.paged_decode_ref(
        q.expand(3, -1, -1), kp, vp, pt, pos, lens), 2e-5)


def test_paged_decode_split_launches_on_two_streams(dev):
    """Split launches in flight at once on two streams keep their tickets
    apart: each equals its plain version and its single-stream run."""
    cases = [server_case(dev, 4096, seed=1), server_case(dev, 2048, seed=2)]
    single = [td.paged_decode_attention(q, kp, vp, *t)
              for q, kp, vp, t in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(8):
        for i, (s, (q, kp, vp, t)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(td.paged_decode_attention(q, kp, vp, *t))
    torch.cuda.synchronize()
    for i, (q, kp, vp, t) in enumerate(cases):
        assert td.split_count(16, t[0].shape[1], 8) > 1
        ref = td.paged_decode_ref(q, kp, vp, *t)
        for got in outs[i]:
            for x, y in zip(got, single[i]):
                assert torch.equal(x, y)
            assert_partials_close(got, ref, 2e-5)


@pytest.mark.parametrize("context", [120, 2048])
def test_paged_decode_bf16_q_equals_q_converted_first(dev, context):
    q, kp, vp, tables = server_case(dev, context, seed=1)
    qb = q.to(torch.bfloat16)
    for x, y in zip(td.paged_decode_attention(qb, kp, vp, *tables),
                    td.paged_decode_attention(qb.float(), kp, vp, *tables)):
        assert torch.equal(x, y)


def test_paged_decode_all_invalid_rows_in_a_split_batch(dev):
    """Rows without a valid token inside a batch whose rows are split:
    exactly (0, -1e30, 0), and no page of theirs is read."""
    q, kp, vp, (pt, pos, lens) = server_case(dev, 2048, owners=2, seed=2)
    pt, pos = pt.repeat(2, 1), pos.repeat(2, 1)
    lens = torch.tensor([2048, 2048, 0, 2048], dtype=torch.int32, device=dev)
    pt[1] = -1                                  # no page at all
    pos[3] = 4096                               # every slot past the length
    assert td.split_count(4 * 16, pt.shape[1], 8) > 1
    got = td.paged_decode_attention(q.expand(4, -1, -1), kp, vp, pt, pos,
                                    lens)
    ref = td.paged_decode_ref(q.expand(4, -1, -1), kp, vp, pt, pos, lens)
    assert_partials_close(got, ref, 2e-5)
    for row in (1, 2, 3):
        assert float(got[0][row].abs().max()) == 0
        assert float(got[2][row].abs().max()) == 0
        assert bool((got[1][row] == np.float32(-1e30)).all())
    # rows 1-3 read nothing: poisoning every page they do not share with
    # row 0 leaves them as they are
    kp[...] = float("nan")
    again = td.paged_decode_attention(q.expand(4, -1, -1), kp, vp, pt, pos,
                                      lens)
    for x, y in zip(again, got):
        assert torch.equal(x[1:], y[1:])


def test_paged_decode_all_invalid_tables(dev):
    """Page ids -1, and slots at or past the length, are never read: the
    partials are exactly (0, -1e30, 0), as the plain version gives."""
    q, kp, vp, _, _, _ = paged_case(dev, 3, 4, 2, 16, 8, 6, 3,
                                    torch.float32, 1)
    pt = torch.tensor([[-1, -1, -1], [2, 3, -1], [4, 5, 1]],
                      dtype=torch.int32, device=dev)
    pos = torch.tensor([[0, 8, 16], [8, 16, 0], [0, 8, 16]],
                       dtype=torch.int32, device=dev)
    lens = torch.tensor([5, 8, 0], dtype=torch.int32, device=dev)
    kp[...] = float("nan")                      # any read would show
    got = td.paged_decode_attention(q, kp, vp, pt, pos, lens)
    ref = td.paged_decode_ref(q, kp.nan_to_num(0.0), vp, pt, pos, lens)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert float(got[1].max()) == np.float32(-1e30)


def test_paged_decode_split_merge_invariance(dev):
    b, h, kh, d, ps, npages, p = 2, 4, 2, 16, 8, 16, 6
    q, kp, vp, _, _, _ = paged_case(dev, b, h, kh, d, ps, npages, p,
                                    torch.float32, 2)
    pt = torch.tensor([[0, 1, 2, 3, 4, 5], [6, 7, 8, -1, -1, -1]],
                      dtype=torch.int32, device=dev)
    pos = torch.tensor([[0, 8, 16, 24, 32, 40], [0, 8, 16, 0, 0, 0]],
                       dtype=torch.int32, device=dev)
    lens = torch.tensor([44, 20], dtype=torch.int32, device=dev)
    whole = td.normalize(*td.paged_decode_ref(q, kp, vp, pt, pos, lens))
    for nsplit in (2, 3):
        parts = []
        for s in range(nsplit):
            mask = (torch.arange(p, device=dev) % nsplit) == s
            parts.append(td.paged_decode_attention(
                q, kp, vp, torch.where(mask[None], pt, -1), pos, lens))
        torch.testing.assert_close(td.normalize(*td.merge_partials(parts)),
                                   whole, atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ ssd_scan
# kernel 7 against the plain chunked version and the sequential
# recurrence: both in f32 from the same inputs, in another order of sums
# (3e-4, test_kernels.py's f32 bar); bf16 adds one rounding of y (4e-2)
from repro_torch.kernels import ssd_scan as tss  # noqa: E402


def ssd_case(dev, b, s, h, g, n, p, dtype, seed, a_range=(0.5, 2.0),
             dt_range=(0.01, 0.2)):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    return (f(rng.standard_normal((b, s, h, p))).to(dtype),
            f(rng.uniform(*dt_range, (b, s, h))),
            f(-rng.uniform(*a_range, (h,))),
            f(rng.standard_normal((b, s, g, n)) * 0.3).to(dtype),
            f(rng.standard_normal((b, s, g, n)) * 0.3).to(dtype),
            f(rng.standard_normal(h) * 0.1))


@pytest.mark.parametrize("b,s,h,g,n,p,chunk,dtype", [
    (1, 64, 2, 1, 16, 8, 16, torch.float32),
    (2, 128, 4, 2, 32, 16, 32, torch.float32),
    (1, 64, 2, 1, 16, 8, 64, torch.float32),
    (1, 64, 2, 1, 16, 8, 16, torch.bfloat16),
    (2, 128, 8, 2, 64, 32, 32, torch.bfloat16),      # G = 2
    (1, 256, 6, 2, 128, 64, 64, torch.float32),      # G = 2, N 128, P 64
    (2, 256, 16, 1, 128, 64, 64, torch.bfloat16),    # mamba2's N, P, L
    (1, 90, 4, 2, 16, 8, 30, torch.float32),         # chunk not a multiple of 4
    (2, 7, 2, 1, 16, 8, 7, torch.bfloat16),          # a short prompt: chunk = S
    (1, 1, 2, 1, 16, 8, 1, torch.float32),           # one token
])
def test_ssd_scan_matches_plain(dev, b, s, h, g, n, p, chunk, dtype):
    args = ssd_case(dev, b, s, h, g, n, p, dtype, s + h + g)
    n0 = _build.launches["ssd_scan"]
    got = tss.ssd_scan(*args, chunk=chunk)
    assert _build.launches["ssd_scan"] == n0 + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    tol = 4e-2 if dtype == torch.bfloat16 else 3e-4
    for ref in (tss.ssd_chunked(*args, chunk), tss.ssd_ref(*args)[0]):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)
    assert torch.equal(tss.ssd(*args, chunk=chunk), got)


def test_ssd_scan_strided_views_and_underflow(dev):
    """x, B and C as slices of one projection, as the model hands them;
    a = -16 with dt up to 2 underflows exp(cum) to 0 without a NaN."""
    b, s, h, g, n, p = 2, 128, 4, 1, 32, 16
    x, dt, a, bm, cm, d = ssd_case(dev, b, s, h, g, n, p, torch.bfloat16, 9,
                                   a_range=(15.0, 16.0), dt_range=(0.5, 2.0))
    xbc = torch.cat([x.reshape(b, s, -1), bm.reshape(b, s, -1),
                     cm.reshape(b, s, -1)], dim=-1)
    xv = xbc[..., :h * p].view(b, s, h, p)
    bv = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    cv = xbc[..., h * p + g * n:].view(b, s, g, n)
    got = tss.ssd_scan(xv, dt, a, bv, cv, d, chunk=64)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, tss.ssd_scan(x, dt, a, bm, cm, d),
                               atol=0, rtol=0)
    torch.testing.assert_close(got.float(), tss.ssd_ref(x, dt, a, bm, cm, d)
                               [0].float(), atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_bf16_at_prefill_shape(dev, g):
    """The tensor-core path at mamba2-2.7b's widths (80 heads of 64, N 128,
    L 64), x, B and C as strided views of one projection, against the
    plain chunked scan at chip_smoke.py's main-path bar: both round y to
    bf16 once, so rtol 2^-7 (one unit in y's last place) and atol 2^-8 of
    max |y|."""
    b, s, h, n, p = 2, 2048, 80, 128, 64
    x, dt, a, bm, cm, d = ssd_case(dev, b, s, h, g, n, p, torch.bfloat16, g)
    xbc = torch.cat([x.reshape(b, s, -1), bm.reshape(b, s, -1),
                     cm.reshape(b, s, -1)], dim=-1)
    xv = xbc[..., :h * p].view(b, s, h, p)
    bv = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    cv = xbc[..., h * p + g * n:].view(b, s, g, n)
    got = tss.ssd_scan(xv, dt, a, bv, cv, d, chunk=64)
    ref = tss.ssd_chunked(x, dt, a, bm, cm, d, 64).float()
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7,
                               atol=2 ** -8 * float(ref.abs().max()))


def test_ssd_scan_refuses_bad_inputs(dev):
    x, dt, a, bm, cm, d = ssd_case(dev, 1, 128, 2, 1, 16, 8, torch.bfloat16,
                                   1)
    with pytest.raises(TypeError):
        tss.ssd_scan(x, dt.to(torch.bfloat16), a, bm, cm, d)
    with pytest.raises(TypeError):
        tss.ssd_scan(x.float(), dt, a, bm, cm, d)
    with pytest.raises(TypeError):
        tss.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), d)
    with pytest.raises(ValueError, match="chunk"):
        tss.ssd_scan(x, dt, a, bm, cm, d, chunk=128)
    with pytest.raises(ValueError, match="multiple"):
        tss.ssd_scan(x, dt, a, bm, cm, d, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        tss.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a,
                     bm, cm, d)
    with pytest.raises(ValueError, match="contiguous"):
        tss.ssd_scan(x, dt.transpose(1, 2).contiguous().transpose(1, 2), a,
                     bm, cm, d)
    big = torch.zeros((1, 128, 1, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="state size"):
        tss.ssd_scan(x, dt, a, big, big, d)
    with pytest.raises(ValueError, match="head dim"):
        tss.ssd_scan(torch.zeros((1, 128, 2, 128), dtype=torch.bfloat16,
                                 device=dev), dt, a, bm, cm, d)
    with pytest.raises(ValueError, match="mixed"):
        tss.ssd_scan(x, dt.cpu(), a, bm, cm, d)


@pytest.mark.parametrize("s", [1, 7, 64, 192])
def test_ssm_prefill_step_on_the_card_matches_the_cpu(dev, s):
    """mamba2's smoke config through prefill_step on the card (kernel 7 on
    the conv output's strided views) against the same weights on the CPU
    (ssd_chunked); bf16 products rounded by two backends, 5e-2 as in
    tests/test_torch_ssm.py."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import ssm_lm
    cfg = get_smoke_config("mamba2-2.7b")
    params = ssm_lm.init_params(0, cfg, device="cpu")
    on_dev = {"embed": params["embed"].to(dev), "ln_f": params["ln_f"].to(dev),
              "layers": [{"ln": lp["ln"].to(dev),
                          "mamba": {k: v.to(dev)
                                    for k, v in lp["mamba"].items()}}
                         for lp in params["layers"]]}
    tokens = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)))
    n0 = _build.launches["ssd_scan"]
    got = steps.prefill_step(on_dev, tokens.to(dev), cfg)
    assert _build.launches["ssd_scan"] == n0 + cfg.num_layers
    want = steps.prefill_step(params, tokens, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=5e-2)


# ------------------------------------------------------------------ kernel 4
# The integer space machine: exact against the torch loop and the
# plain-python reference on every output.
from repro_torch.kernels import cache_transition as tct  # noqa: E402


def transition_case(n, cap_base, seed, value_bytes=128):
    """tests/test_kernels.py's random windows: op kinds, prior kinds,
    counts and lengths, a frozen victim queue, a starting occupancy and
    zero count."""
    rng = np.random.default_rng(seed)
    cap = cap_base + int(rng.integers(0, 2048))
    opk = rng.choice([0, 0, 0, 1, 1, 2], n).astype(np.int64)
    kd = rng.choice([0, 1, 2], n).astype(np.int64)
    pc = rng.choice([0, 0, 1, 5], n).astype(np.int64)
    plen = rng.choice([64, 128, 256], n).astype(np.int64)
    vic = rng.choice([104, 168, 296], 200).astype(np.int32)
    rows = tct.encode_window(opk, kd, pc, plen, value_bytes=value_bytes)
    return rows, vic, int(rng.integers(0, cap)), int(rng.integers(0, 50)), cap


def floor_div_case():
    """Promotes whose Eq. 1 deficit is negative and not a multiple of 32,
    with the zero count at the truncated quotient: floor division must
    refuse them."""
    rows = np.zeros((256, tct.OP_LANES), np.int32)
    rows[:, 0] = 1                                   # promote
    rows[:, 2] = 232 + np.arange(256) % 31           # need 200..230
    cap = 1 << 16
    return rows, np.full(64, 1064, np.int32), cap - 100, 3, cap


def dry_case():
    """A full cache, write fills and a three-entry victim queue: the
    make-space loop runs the queue dry and occupancy passes cap."""
    rows = tct.encode_window(np.ones(256, np.int64), np.zeros(256, np.int64),
                             np.zeros(256, np.int64), np.zeros(256, np.int64),
                             value_bytes=1024)
    cap = 1 << 15
    return rows, np.full(3, 1064, np.int32), cap - 10, 0, cap


def make_space_window():
    """A 512-op window in the make-space regime at the KN's widths: a
    1 GiB cache full of 1 KB values, shortcut reads (promotes) and writes,
    one victim per insert."""
    rng = np.random.default_rng(7)
    n = 512
    opk = rng.choice([0, 1], n).astype(np.int64)
    kd = rng.choice([1, 2], n).astype(np.int64)
    pc = rng.choice([0, 1, 3], n).astype(np.int64)
    rows = tct.encode_window(opk, kd, pc, np.full(n, 1024, np.int64),
                             value_bytes=1024)
    cap = 1 << 30
    return rows, np.full(1100, 1064, np.int32), cap - 500, 40, cap


@pytest.mark.parametrize("case", [
    lambda: transition_case(256, 4096, 0),
    lambda: transition_case(512, 8192, 1),
    lambda: transition_case(256, 2048, 2), floor_div_case, dry_case,
    make_space_window], ids=["sweep0", "sweep1", "sweep2", "floor_div", "dry",
                             "make_space_512"])
def test_cache_transition_matches_plain(dev, case):
    rows, vic, used0, z0, cap = case()
    n0 = _build.launches["cache_transition"]
    got = tct.cache_transition(torch.from_numpy(rows).to(dev),
                               torch.from_numpy(vic).to(dev), used0, z0,
                               cap=cap)
    assert _build.launches["cache_transition"] == n0 + 1
    ref = tct.cache_transition_ref(torch.from_numpy(rows).to(dev),
                                   torch.from_numpy(vic).to(dev), used0, z0,
                                   cap=cap)
    plain = tct.cache_transition_np(rows, vic, used0, z0, cap=cap)
    for g, r, p in zip(got, ref, plain):
        assert torch.equal(g, r)
        np.testing.assert_array_equal(g.cpu().numpy(), p)


def test_cache_transition_edges_are_hit(dev):
    """The floor-division case refuses the promotes (a truncating
    division would take them), the dry case passes cap."""
    rows, vic, used0, z0, cap = floor_div_case()
    dec, nvic, used = tct.cache_transition(torch.from_numpy(rows).to(dev),
                                           torch.from_numpy(vic).to(dev),
                                           used0, z0, cap=cap)
    assert not bool(dec.any())
    rows, vic, used0, z0, cap = dry_case()
    dec, nvic, used = tct.cache_transition(torch.from_numpy(rows).to(dev),
                                           torch.from_numpy(vic).to(dev),
                                           used0, z0, cap=cap)
    assert int(nvic[-1]) == 3 and int(used.max()) > cap


def test_cache_transition_refuses_bad_inputs(dev):
    rows, vic, used0, z0, cap = transition_case(256, 4096, 0)
    r, v = torch.from_numpy(rows).to(dev), torch.from_numpy(vic).to(dev)
    with pytest.raises(TypeError):
        tct.cache_transition(r.long(), v, used0, z0, cap=cap)
    with pytest.raises(ValueError):
        tct.cache_transition(r[:, :4], v, used0, z0, cap=cap)
    with pytest.raises(OverflowError):
        tct.cache_transition(r, v, used0, z0, cap=2**31 - 100)
    with pytest.raises(ValueError, match="mixed"):
        tct.cache_transition(r, v.cpu(), used0, z0, cap=cap)


# --------------------------------------- kernels C and 4: adversarial inputs
import importlib  # noqa: E402

import torch_cases as cases  # noqa: E402

from repro_torch.data import Workload  # noqa: E402

tm_k = importlib.import_module("repro_torch.kernels.log_merge.log_merge")


def merge_on(dev, lines, starts, bids, keys, ptrs, fn):
    """``fn`` (the kernel's wrapper or its plain version) on a copy of
    ``lines`` on ``dev``: (lines after, old, ok)."""
    lt = torch.from_numpy(lines).to(dev)
    old, ok = fn(lt, *(torch.from_numpy(x).to(dev)
                       for x in (starts, bids, keys, ptrs)))
    return lt, old, ok


@pytest.mark.parametrize("walk_max", [0, 32])
@pytest.mark.parametrize("name", cases.MERGE_CASES)
def test_log_merge_sorted_adversarial_matches_plain(dev, monkeypatch, name,
                                                    walk_max):
    """Kernel C bit for bit against its plain version: hot keys, more new
    keys than empty slots, -1 and -3 keys, lines holding a key twice,
    clamped bucket ids; with every group on the block path (WALK_MAX 0)
    and with the wrapper's split."""
    monkeypatch.setattr(tm_k, "WALK_MAX", walk_max)
    case = cases.merge_case(name)
    n0 = _build.launches["log_merge_sorted"]
    got = merge_on(dev, *case, tm.log_merge_sorted)
    assert _build.launches["log_merge_sorted"] == n0 + 1
    ref = merge_on(dev, *case, tm.log_merge_sorted_ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_log_merge_sorted_on_a_zipf_write_batch(dev):
    """Kernel C on the updates of a YCSB write_heavy_update batch of 2^20
    ops at zipf 0.99 over 2^25 keys, into 2^22 half-full lines: a group
    of more than 25 K entries (the hottest key's bucket)."""
    nb = 1 << 22
    kinds, keys = Workload(1 << 25, zipf=0.99, mix="write_heavy_update",
                           seed=3).ops_arrays(1 << 20)
    wk = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
    bs, order, starts = tm.sort_by_bucket(tc.bucket_of(wk, nb))
    ks = wk[order].contiguous()
    ps = torch.arange(ks.numel(), dtype=torch.int32, device=dev)
    assert int((starts[1:] - starts[:-1]).max()) > 25_000
    g = np.random.default_rng(3)
    lines = np.full((nb, 8), -1, np.int32)
    lines[:, :3] = np.where(g.random((nb, 3)) < 0.5,
                            g.integers(0, 1 << 25, (nb, 3)), -1)
    lines[:, 3:6] = g.integers(0, 2**31 - 1, (nb, 3))
    base = torch.from_numpy(lines).to(dev)
    lk, lr = base.clone(), base.clone()
    got = tm.log_merge_sorted(lk, starts, bs, ks, ps)
    ref = tm.log_merge_sorted_ref(lr, starts, bs, ks, ps)
    assert torch.equal(lk, lr)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", cases.TRANSITION_CASES)
def test_cache_transition_adversarial_matches_plain(dev, name):
    """Kernel 4 bit for bit against its torch loop and its numpy oracle:
    victims <= 0, an empty queue, a queue run dry mid-window, make-spaces
    of tens of small victims (past the staged queue), promotes at Eq. 1's
    floor, and a 2^13-op window with a 4,096-victim queue across the
    staged tiles."""
    rows, vic, used0, z0, cap = cases.transition_case(name)
    r, v = torch.from_numpy(rows).to(dev), torch.from_numpy(vic).to(dev)
    got = tct.cache_transition(r, v, used0, z0, cap=cap,
                               top=int(rows[:, 2].max()))
    ref = tct.cache_transition_ref(r, v, used0, z0, cap=cap)
    plain = tct.cache_transition_np(rows, vic, used0, z0, cap=cap)
    for g, rr, p in zip(got, ref, plain):
        assert torch.equal(g, rr)
        np.testing.assert_array_equal(g.cpu().numpy(), p)


def test_kernels_c_and_4_do_not_synchronize(dev):
    """log_merge_sorted and kernel 4's launch read nothing back to the
    host: under sync debug mode "error" any synchronizing call raises."""
    lines, starts, bids, keys, ptrs = (
        torch.from_numpy(x).to(dev) for x in cases.merge_case("hot_key"))
    rows, vic, used0, z0, cap = cases.transition_case("window_8192")
    r, v = torch.from_numpy(rows).to(dev), torch.from_numpy(vic).to(dev)
    outs = [torch.empty(rows.shape[0], dtype=torch.int32, device=dev)
            for _ in range(3)]
    tm.log_merge_sorted(lines.clone(), starts, bids, keys, ptrs)  # build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.log_merge_sorted(lines, starts, bids, keys, ptrs)
        tct.launch(r, v, used0, z0, cap, *outs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tct.cache_transition_np(rows, vic.astype(np.int64), used0, z0,
                                   cap=cap)
    for g, w in zip(outs, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
