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


def test_fused_lookup_adversarial_lines(dev):
    """Kernel B on the lines of kernel A's adversarial test: a key twice
    or three times in one line gives the wrapping sum of the matching
    slots' pointers (and the row at it, zeros where it is negative), as
    kernel A and both plain versions do."""
    g = np.random.default_rng(12)
    tb = 4096
    lines = g.integers(0, 6, (tb, 8)).astype(np.int32)
    lines[:, 3:6] = g.choice([0, 1, 2, 5, 2**31 - 1, -2**31, -1], (tb, 3))
    lines[g.random(tb) < 0.1, :3] = -1
    lines[:, 6] = g.choice([-1, 3, 5], tb)
    lines = torch.from_numpy(lines).to(dev)
    heap = torch.from_numpy(g.integers(0, 2**31 - 1, (16, 8))
                            .astype(np.int32)).to(dev)
    for n in (1, 31, 4097):
        keys = torch.from_numpy(g.integers(-3, 7, n).astype(np.int32)
                                ).to(dev)
        bids = torch.from_numpy(g.integers(-2, tb + 2, n).astype(np.int32)
                                ).to(dev)
        n0 = _build.launches["kvs_lookup_fused"]
        got = tp.kvs_lookup_fused(lines, heap, bids, keys)
        assert _build.launches["kvs_lookup_fused"] == n0 + 1
        want = tp.kvs_lookup_fused_ref(lines.cpu(), heap.cpu(), bids.cpu(),
                                       keys.cpu())
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
    twice = torch.tensor([[5, 5, 5, 2**31 - 1, 1, 7, -1, -1],
                          [4, 9, 4, 10, 2, 3, -1, -1]], dtype=torch.int32,
                         device=dev)
    vals, ptrs, found = tp.kvs_lookup_fused(
        twice, heap, torch.tensor([0, 1, 1], device=dev, dtype=torch.int32),
        torch.tensor([5, 4, 9], device=dev, dtype=torch.int32))
    assert ptrs.tolist() == [-2**31 + 7, 13, 2] and found.tolist() == [1] * 3
    assert torch.equal(vals[0], torch.zeros_like(vals[0]))
    assert torch.equal(vals[1], heap[13]) and torch.equal(vals[2], heap[2])


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
# flash kernel rounds each p to bf16 for P.V (at most 2^-9 of the softmax
# average of |v|) and its output to bf16 (one unit in the last place), so
# it is held at twice the first and the second: atol 2^-8 of the same
# softmax over |v|, rtol 2^-7 (chip_smoke.py's main-path bar; a fixed
# 2.5e-2 is about the size of the outputs over 1,500 keys, 0.04); the
# decode kernel 3e-2 (test_kernels.py's bf16 bar).
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
    # D = 128, each tile two 64-column halves: one query, ragged 128-row
    # blocks, GQA groups 1, 3, 6 and 8, non-causal Sq != Sk both ways,
    # llama3.2-3b's heads at its prefill length, and the f32 kernel
    (1, 3, 1, 1, 1, 128, True, torch.bfloat16),
    (1, 6, 2, 127, 127, 128, True, torch.bfloat16),
    (2, 6, 1, 129, 129, 128, True, torch.bfloat16),
    (1, 8, 1, 200, 200, 128, True, torch.bfloat16),
    (1, 4, 4, 77, 300, 128, False, torch.bfloat16),
    (1, 6, 2, 300, 77, 128, False, torch.bfloat16),
    (1, 24, 8, 2048, 2048, 128, True, torch.bfloat16),
    (1, 6, 2, 200, 200, 128, True, torch.float32),
    (1, 4, 1, 77, 150, 128, False, torch.float32),
    # seamless-m4t-medium's encoder (non-causal, Sq = Sk = 1,500 frames,
    # both ragged: 1,500 = 23 x 64 + 28) and its cross-attention (256
    # decoder tokens over the 1,500-frame memory); zamba2-1.2b's shared
    # block (causal, 32 heads of 64, group 1)
    (1, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    (2, 16, 16, 256, 1500, 64, False, torch.bfloat16),
    (1, 32, 32, 2048, 2048, 64, True, torch.bfloat16),
])
def test_flash_attention_matches_plain(dev, b, h, kh, sq, sk, d, causal,
                                       dtype):
    g = torch.Generator(device=dev).manual_seed(sq)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
    n0 = _build.launches["flash_attention"]
    got = tf.flash_attention(q, k, v, causal=causal)
    assert _build.launches["flash_attention"] == n0 + 1
    ref = tf.mha_ref(q, k, v, causal=causal).float()
    if dtype == torch.bfloat16:
        bar = 2 ** -8 * tf.mha_ref(q, k, v.abs(), causal=causal).float() \
            + 2 ** -7 * ref.abs()
        diff = (got.float() - ref).abs()
        assert bool(torch.isfinite(got).all())
        assert int((diff > bar).sum()) == 0, float(diff.max())
    else:
        torch.testing.assert_close(got, ref, atol=3e-5, rtol=3e-5)
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
    (2, 24, 8, 128, 8, 40, 6, torch.float32),        # llama: group 3
    (1, 12, 2, 128, 16, 30, 5, torch.bfloat16),      # group 6
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


def test_ssd_scan_bf16_at_zamba2_shape(dev):
    """The tensor-core path at zamba2-1.2b's widths (64 heads of 64, N 64,
    G 1, L 64), x, B and C as strided views of one projection, against the
    plain chunked scan at chip_smoke.py's main-path bar, as
    test_ssd_scan_bf16_at_prefill_shape."""
    b, s, h, g, n, p = 2, 2048, 64, 1, 64, 64
    x, dt, a, bm, cm, d = ssd_case(dev, b, s, h, g, n, p, torch.bfloat16, 5)
    xbc = torch.cat([x.reshape(b, s, -1), bm.reshape(b, s, -1),
                     cm.reshape(b, s, -1)], dim=-1)
    xv = xbc[..., :h * p].view(b, s, h, p)
    bv = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    cv = xbc[..., h * p + g * n:].view(b, s, g, n)
    n0 = _build.launches["ssd_scan"]
    got = tss.ssd_scan(xv, dt, a, bv, cv, d, chunk=64)
    assert _build.launches["ssd_scan"] == n0 + 1
    ref = tss.ssd_chunked(x, dt, a, bm, cm, d, 64).float()
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7,
                               atol=2 ** -8 * float(ref.abs().max()))
    torch.testing.assert_close(got.float(), tss.ssd_ref(x, dt, a, bm, cm, d)
                               [0].float(), atol=4e-2, rtol=4e-2)


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


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b",
                                  "chameleon-34b"])
def test_transformer_families_on_the_card_match_the_cpu(dev, arch):
    """The dense (GQA group 3), MoE and VLM smoke configs through
    prefill_step (kernel 5 on the model's strided views) and the three
    dense-cache decodes on the card, against the same weights on the CPU
    (mha_ref). The weights are f32 and the MoE runs at capacity factor
    8.0: bf16 rounded in other places by two backends can route a token
    whose top experts nearly tie to another expert
    (tests/test_torch_decode.py); f32 attention takes the f32 kernel.
    5e-2, as tests/test_torch_ssm.py."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_smoke_config(arch).replace(moe_capacity_factor=8.0)
    params = transformer.init_params(0, cfg, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.float().to(device)

    host, card = to(params, "cpu"), to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    n0 = _build.launches["flash_attention"]
    got, kv = steps.prefill_step(card, tokens[:, :36].to(dev), cfg)
    assert _build.launches["flash_attention"] == n0 + cfg.num_layers
    want, wkv = steps.prefill_step(host, tokens[:, :36], cfg)
    torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=5e-2)
    for optimized in (False, "v2", "v3"):
        caches = []
        for tree, d, k_v in ((card, dev, kv), (host, "cpu", wkv)):
            c = steps.init_cache(cfg, 2, 40, optimized, torch.float32, d)
            for name in ("k", "v"):
                dst = c[name].transpose(2, 3) if optimized else c[name]
                dst[:, :, :36] = k_v[name]
            caches.append(c)
        for t in range(36, 40):
            a, caches[0] = steps.serve_step(card, caches[0],
                                            tokens[:, t].to(dev), t, cfg,
                                            optimized)
            b, caches[1] = steps.serve_step(host, caches[1], tokens[:, t],
                                            t, cfg, optimized)
            torch.testing.assert_close(a.cpu(), b, atol=5e-2, rtol=5e-2)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def test_hybrid_on_the_card_matches_the_cpu(dev):
    """zamba2-1.2b's smoke config (bf16; two groups and a tail layer)
    through prefill_step on the card -- kernel 7 a mamba layer, kernel 5 a
    shared-block site -- and 6 teacher-forced serve_steps, against the
    same weights on the CPU (the plain versions); 5e-2, as
    tests/test_torch_ssm.py."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import zamba2
    cfg = get_smoke_config("zamba2-1.2b")
    host = zamba2.init_params(0, cfg, device="cpu")
    card = _to(host, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 48)))
    n0 = dict(_build.launches)
    got = steps.prefill_step(card, tokens.to(dev), cfg)
    _, groups, _ = zamba2._group_shape(cfg)
    assert _build.launches["ssd_scan"] == n0["ssd_scan"] + cfg.num_layers
    assert _build.launches["flash_attention"] == \
        n0["flash_attention"] + groups
    want = steps.prefill_step(host, tokens, cfg)
    torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=5e-2)
    caches = [steps.init_cache(cfg, 2, 8, device=d) for d in (dev, "cpu")]
    for t in range(6):
        a, caches[0] = steps.serve_step(card, caches[0],
                                        tokens[:, t].to(dev), t, cfg)
        b, caches[1] = steps.serve_step(host, caches[1], tokens[:, t], t,
                                        cfg)
        torch.testing.assert_close(a.cpu(), b, atol=5e-2, rtol=5e-2)


def test_encdec_on_the_card_matches_the_cpu(dev):
    """seamless-m4t-medium's smoke config (bf16) through prefill_step on
    the card with 40 frames and 24 tokens -- kernel 5 non-causal over the
    frames, causal over the tokens, non-causal Sq = 24 against Sk = 40 over
    the memory -- then encode, prepare_cross and 6 teacher-forced
    serve_steps, against the same weights on the CPU; 5e-2."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    cfg = get_smoke_config("seamless-m4t-medium")
    host = encdec.init_params(0, cfg, device="cpu")
    card = _to(host, dev)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    frames = torch.from_numpy(
        (rng.standard_normal((2, 40, cfg.d_model)) * 0.02).astype(np.float32))
    n0 = _build.launches["flash_attention"]
    got = steps.prefill_step(card, tokens.to(dev), cfg, frames=frames.to(dev))
    assert _build.launches["flash_attention"] == \
        n0 + cfg.encoder_layers + 2 * cfg.num_layers
    want = steps.prefill_step(host, tokens, cfg, frames=frames)
    torch.testing.assert_close(got.cpu(), want, atol=5e-2, rtol=5e-2)
    caches = []
    for tree, d in ((card, dev), (host, "cpu")):
        mem = encdec.encode(tree, frames.to(d), cfg)
        caches.append(encdec.prepare_cross(
            tree, mem, cfg, steps.init_cache(cfg, 2, 8, enc_len=40,
                                             device=d)))
    torch.testing.assert_close(caches[0]["xk"].cpu().float(),
                               caches[1]["xk"].float(), atol=5e-2, rtol=5e-2)
    for t in range(6):
        a, caches[0] = steps.serve_step(card, caches[0],
                                        tokens[:, t].to(dev), t, cfg)
        b, caches[1] = steps.serve_step(host, caches[1], tokens[:, t], t,
                                        cfg)
        torch.testing.assert_close(a.cpu(), b, atol=5e-2, rtol=5e-2)


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


# ------------------------------------------- the cluster's host engine
from repro_torch.core import cluster as tcl  # noqa: E402
from torch_cluster_cases import batch_result, cluster_state  # noqa: E402

probe_ops = importlib.import_module("repro_torch.kernels.clht_probe.ops")


def test_cluster_on_the_card_equals_its_cpu_twin(dev, monkeypatch):
    """A dinomo cluster whose pool reads its index on the card and its
    twin on the CPU, through mixed YCSB batches with merges between them,
    a KN added and one failed: every BatchResult and the whole state
    (tests/torch_cluster_cases.py:cluster_state) equal after each batch,
    and every kernel-A launch of the card's batched reads equal to
    clht_probe_ref on its lines, bucket ids and keys."""
    checked = []
    real = probe_ops.clht_probe

    def checking(*args):
        # held at the call: the pool's next sync writes into the lines
        out = real(*args)
        want = tp.clht_probe_ref(*args)
        checked.append((args[0].is_cuda, torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])))
        return out

    monkeypatch.setattr(probe_ops, "clht_probe", checking)
    kw = dict(num_kns=4, cache_bytes=int(6000 * 1024 * 0.03),
              value_bytes=1024, num_buckets=1 << 12, segment_capacity=64)
    card = tcl.DinomoCluster(device=dev, **kw)
    host = tcl.DinomoCluster(device="cpu", **kw)
    for c in (card, host):
        c.load(((k, f"v{k}") for k in range(6000)), warm=True)
    assert card.pool.device.type == "cuda"
    n0 = _build.launches["clht_probe"]
    for step, mix in enumerate(["write_heavy_update", "read_mostly_update"]
                               * 2):
        kinds, keys = Workload(6000, zipf=0.99, mix=mix,
                               seed=step).ops_arrays(3000)
        got = [batch_result(c.execute_batch(kinds, keys,
                                            values=lambda i: f"w{i}",
                                            collect_values=True))
               for c in (card, host)]
        assert got[0] == got[1]
        for c in (card, host):
            c.advance_merge(1 << 20)
        if step == 1:
            for c in (card, host):
                c.add_kn()
        if step == 2:
            for c in (card, host):
                c.fail_kn("kn2")
        assert cluster_state(card) == cluster_state(host)
    on_card = [ok for cuda, ok in checked if cuda]
    assert on_card and all(ok for _, ok in checked)
    assert _build.launches["clht_probe"] - n0 == len(on_card)


@pytest.mark.parametrize("variant", ["dinomo-s", "clover"])
def test_baseline_on_the_card_equals_its_cpu_twin(dev, monkeypatch,
                                                  variant):
    """The baselines as the dinomo case above: a cluster whose pool reads
    its index on the card and its CPU twin, through mixed YCSB batches
    (with deletes and inserts), a read-only batch, a KN added and one
    failed: every BatchResult and the whole state equal after each batch,
    the card's index copy equal to the host index row for row, and every
    kernel-A launch equal to clht_probe_ref. Clover reads the index for
    every op of every batch, so kernel A launches once a batch."""
    from torch_cluster_cases import mirror_equals_host
    checked = []
    real = probe_ops.clht_probe

    def checking(*args):
        out = real(*args)
        want = tp.clht_probe_ref(*args)
        checked.append((args[0].is_cuda, torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])))
        return out

    monkeypatch.setattr(probe_ops, "clht_probe", checking)
    kw = dict(num_kns=4, cache_bytes=int(6000 * 1024 * 0.03),
              value_bytes=1024, num_buckets=1 << 12, segment_capacity=64)
    card = tcl.DinomoCluster(tcl.VARIANTS[variant], device=dev, **kw)
    host = tcl.DinomoCluster(tcl.VARIANTS[variant], device="cpu", **kw)
    for c in (card, host):
        c.load(((k, f"v{k}") for k in range(6000)), warm=True)
    n0 = _build.launches["clht_probe"]
    batches = 0
    mixes = ["write_heavy_update", "write_heavy_insert", "read_only",
             "read_mostly_update"]
    for step, mix in enumerate(mixes):
        kinds, keys = Workload(6000, zipf=0.99, mix=mix,
                               seed=step).ops_arrays(3000)
        kinds = kinds.copy()
        kinds[(kinds == 1) & (np.arange(kinds.size) % 9 == 0)] = 2
        got = [batch_result(c.execute_batch(kinds, keys,
                                            values=lambda i: f"w{i}",
                                            collect_values=True))
               for c in (card, host)]
        assert got[0] == got[1]
        batches += 1
        for c in (card, host):
            c.advance_merge(1 << 20)
        if step == 1:
            for c in (card, host):
                c.add_kn()
        if step == 2:
            for c in (card, host):
                c.fail_kn("kn2")
        assert cluster_state(card) == cluster_state(host)
        mirror_equals_host(card.pool)
    on_card = [ok for cuda, ok in checked if cuda]
    assert on_card and all(ok for _, ok in checked)
    assert _build.launches["clht_probe"] - n0 == len(on_card)
    if variant == "clover":
        assert len(on_card) >= batches


# ------------------------------------------ kernel E, the batch executor
from repro_torch.kernels import batch_executor as tbe  # noqa: E402


def window_equal(dev, state, dstate, win, cap, wb, amr, trees=None):
    """One kernel-E launch on ``dstate`` (updated in place) against
    fused_window_ref on host copies of the same inputs: n_exec, the cut,
    the events and out_ptr (whole tapes) and all eight state arrays equal.
    Returns the plain version's state."""
    vmax = tbe.build_promote_table(amr)
    ref = tbe.fused_window_ref(tuple(a.copy() for a in state), *win, cap,
                               wb, vmax)
    n0 = _build.launches["fused_window"]
    out = tbe.fused_window(dstate, *(torch.from_numpy(a).to(dev)
                                     for a in win[:6]), win[6], cap, wb,
                           torch.from_numpy(vmax).to(dev), trees=trees)
    assert _build.launches["fused_window"] == n0 + 1
    assert (int(out[0]), int(out[4])) == (ref[0], ref[4])
    assert np.array_equal(out[2].cpu().numpy(), ref[2])
    assert np.array_equal(out[3].cpu().numpy(), ref[3])
    assert np.array_equal(out.packed[2:tbe.HEADER].cpu().numpy(), ref[1][7])
    for a, b in zip(ref[1], out[1]):
        assert np.array_equal(a, b.cpu().numpy())
    return ref[1]


@pytest.mark.parametrize("nslots,w,windows,hot,seed",
                         [(32, 64, 3, None, s) for s in range(8)]
                         + [(1024, 512, 3, None, s) for s in range(2)]
                         + [(1 << 21, 300, 2, 64, 0)])
def test_fused_window_chains_match_plain(dev, nslots, w, windows, hot, seed):
    """Chained random windows (tests/test_kernels.py:_be_run_chain's, and
    one over 2^21 slots whose keys come from 64 of them): the state and
    its trees stay on the card across the windows, each launch held to
    the plain version on host copies of its inputs."""
    state, wins, cap, wb, amr = cases.window_chain(seed, nslots, w, windows,
                                                   hot)
    dstate = tuple(torch.from_numpy(a.copy()).to(dev) for a in state)
    trees = tbe.build_trees(dstate)
    for win in wins:
        state = window_equal(dev, state, dstate, win, cap, wb, amr, trees)


@pytest.mark.parametrize("nslots", [64, 1 << 21])
@pytest.mark.parametrize("name", cases.WINDOW_CUTS)
def test_fused_window_cut_reasons(dev, name, nslots):
    """Each cut reason (and an Eq. 1 promote and refusal on the table)
    at the op where the plain version stops."""
    state, win, cap, wb, amr = cases.window_cut_case(name, nslots)
    dstate = tuple(torch.from_numpy(a.copy()).to(dev) for a in state)
    window_equal(dev, state, dstate, win, cap, wb, amr)


def test_jit_cluster_on_the_card_equals_the_host_engine(dev):
    """engine="jit" on the card (kernel E over each KN's resident state)
    against the host engine on the card, through mixed YCSB batches, a KN
    added and one failed: every BatchResult and the whole state but the
    caches' lazy-heap records equal after each batch, and kernel E
    launched."""
    kw = dict(num_kns=4, cache_bytes=int(4096 * 1024 * 0.03),
              value_bytes=1024, num_buckets=1 << 12, segment_capacity=64)
    jit, host = (tcl.DinomoCluster(device=dev, **kw) for _ in range(2))
    for c in (jit, host):
        c.load(((k, f"v{k}") for k in range(4096)), warm=True)
    n0 = _build.launches["fused_window"]
    for step, mix in enumerate(["write_heavy_update", "read_mostly_update"]
                               * 2):
        kinds, keys = Workload(4096, zipf=0.99, mix=mix,
                               seed=step).ops_arrays(3000)
        got = [batch_result(c.execute_batch(kinds, keys,
                                            values=lambda i: f"w{i}",
                                            collect_values=True,
                                            engine=e))
               for c, e in ((jit, "jit"), (host, "host"))]
        assert got[0] == got[1]
        for c in (jit, host):
            c.advance_merge(1 << 20)
        if step == 1:
            for c in (jit, host):
                c.add_kn()
        if step == 2:
            for c in (jit, host):
                c.fail_kn("kn2")
        assert cluster_state(jit, heaps=False) == \
            cluster_state(host, heaps=False)
    counts = jit._jit.counts
    assert _build.launches["fused_window"] - n0 == counts["launches"] > 0
    assert counts["dispatches"] >= counts["launches"]


def trees_valid(dstate, trees):
    """The trees a launch leaves equal a fresh build from its state
    (node 0 is unused)."""
    fresh = tbe.build_trees(dstate)
    return all(torch.equal(a[1:], b[1:]) for a, b in zip(trees, fresh))


def held_jobs(dev, cases_, launches):
    """``launches`` launches of kernel E, each over every case's next
    window at once (one job a case, each state with its trees and a dirty
    record on the card), each job held to fused_window_ref on host copies
    of its inputs and its dirty record to the slots that changed; the
    trees valid after each launch. Returns the host states, the card
    states and their dirty records."""
    host = [c[0] for c in cases_]
    dstates = [tuple(torch.from_numpy(a.copy()).to(dev) for a in c[0])
               for c in cases_]
    trees = [tbe.build_trees(d) for d in dstates]
    dirty = [tbe.new_dirty(d[0].shape[0], dev) for d in dstates]
    changed = [set() for _ in cases_]
    for step in range(launches):
        jobs, wants = [], []
        for i, (state, wins, cap, wb, amr) in enumerate(cases_):
            win = wins[step]
            vmax = tbe.build_promote_table(amr)
            wants.append(tbe.fused_window_ref(
                tuple(a.copy() for a in host[i]), *win, cap, wb, vmax))
            jobs.append(tbe.WindowJob(
                dstates[i], tuple(torch.from_numpy(a).to(dev)
                                  for a in win[:6]), win[6], cap, wb,
                torch.from_numpy(vmax).to(dev), trees[i], dirty[i]))
        n0 = _build.launches["fused_window"]
        outs = tbe.fused_windows(jobs)
        assert _build.launches["fused_window"] == n0 + 1
        for i, (out, want) in enumerate(zip(outs, wants)):
            assert (int(out[0]), int(out[4])) == (want[0], want[4])
            assert np.array_equal(out[2].cpu().numpy(), want[2])
            assert np.array_equal(out[3].cpu().numpy(), want[3])
            for a, b in zip(want[1], dstates[i]):
                assert np.array_equal(a, b.cpu().numpy())
            changed[i] |= set(tbe.dirty_slots_ref(host[i], want[1])
                              .tolist())
            host[i] = want[1]
            n = int(out.packed[-1])
            got = dirty[i][1 + (host[i][0].size + 31) // 32:][:n]
            assert int(dirty[i][0]) == n
            assert changed[i] <= set(got.cpu().tolist())
            assert len(set(got.cpu().tolist())) == n
            assert trees_valid(dstates[i], trees[i])
    return host, dstates, dirty


def test_fused_windows_four_kns_in_one_launch(dev):
    """Four KNs' windows in each launch (32, 1024, 4096 and 2^21 slots,
    chained three deep): every job equal to fused_window_ref on its own
    inputs, its dirty record holding every slot that changed, once."""
    cases_ = [cases.window_chain(0, 32, 64, 3),
              cases.window_chain(1, 1024, 512, 3),
              cases.window_victims_case(2, 1 << 12, 1024),
              cases.window_chain(0, 1 << 21, 300, 3, 64)]
    held_jobs(dev, cases_, 3)


@pytest.mark.parametrize("seed", range(3))
def test_deferred_repair_on_windows_that_consume_victims(dev, seed):
    """Windows whose hits change leaves of both trees between
    make-spaces that demote values and evict shortcuts (thousands of
    victims): equal to the plain version, the trees valid after each."""
    state, wins, cap, wb, amr = cases.window_victims_case(seed)
    host, _, _ = held_jobs(dev, [(state, wins, cap, wb, amr)], 3)
    assert host[0][7][6] > 1000 and host[0][7][7] > 100


def test_dirty_gather_and_scatter_match_plain(dev):
    """gather_dirty after a launch returns each dirty slot's fields (the
    plain version's, whatever the record's order), empties the record and
    clears the slots' wrote flags; scatter_slots writes a record's slots
    into a state and repairs its trees, for a few slots (the repair) and
    for many (the rebuild)."""
    case = cases.window_victims_case(4, 1 << 12, 1024, 1)
    host, dstates, dirty = held_jobs(dev, [case], 1)
    st, d = dstates[0], dirty[0]
    n = int(d[0])
    cpu = tuple(torch.from_numpy(a.copy()) for a in host[0])
    dcpu = d.cpu().clone()
    n_launch = _build.launches["fused_window_gather"]
    got = tbe.gather_dirty(st, d, n).cpu().numpy()
    want = tbe.gather_dirty(cpu, dcpu, n).numpy()
    assert _build.launches["fused_window_gather"] == n_launch + 1
    meta = tbe.META
    assert np.array_equal(got[:meta], want[:meta])
    go, wo = np.argsort(got[meta:meta + n]), np.argsort(want[meta:meta + n])
    for f in range(1 + tbe.FIELDS):
        blk = slice(meta + f * n, meta + (f + 1) * n)
        assert np.array_equal(got[blk][go], want[blk][wo])
    assert torch.equal(d.cpu(), dcpu) and int(d[0]) == 0
    for a, b in zip(st, cpu):
        assert torch.equal(a.cpu(), b)
    rng = np.random.default_rng(5)
    s = st[0].shape[0]
    trees = tbe.build_trees(st)
    for m in (7, 3000):
        keys = rng.choice(s, m, replace=False).astype(np.int32)
        kind = rng.integers(0, 3, m).astype(np.int32)
        rec = np.concatenate([rng.integers(0, 9, tbe.META), keys, kind,
                              *(rng.integers(-5, 1 << 20, m)
                                for _ in range(4))]).astype(np.int32)
        tbe.scatter_slots(st, trees, torch.from_numpy(rec).to(dev))
        tbe.scatter_slots(cpu, None, torch.from_numpy(rec))
        for a, b in zip(st, cpu):
            assert torch.equal(a.cpu(), b)
        assert trees_valid(st, trees)


@pytest.mark.parametrize("nslots", [2, 1000, 1 << 21])
def test_guard_maxima_at_the_edges(dev, nslots):
    """The guards' three maxima over live slots equal the plain
    version's where a live value sits at each guard's edge (2^30 - 1,
    2^30, 2^31 - 1), dead slots and slots past nslots hold larger ones,
    and where no slot is live."""
    s = 2
    while s < nslots:
        s <<= 1
    rng = np.random.default_rng(nslots)
    for edge in (2**30 - 1, 2**30, 2**31 - 1, None):
        arrs = [np.zeros(s, np.int32) for _ in range(6)]
        live = (rng.random(s) < 0.3) & (edge is not None)
        arrs[0][:] = np.where(live, rng.integers(1, 3, s), 0)
        for j in (1, 3, 4):
            arrs[j][:] = rng.integers(-10, 1 << 20, s)
            arrs[j][~live] = 2**31 - 1
        if edge is not None:
            for j in (1, 3, 4):
                k = int(rng.integers(0, nslots))
                arrs[0][k] = 1
                arrs[j][k] = edge
        arrs[0][nslots:] = 2
        arrs[1][nslots:] = 2**31 - 1
        state = (*arrs, np.zeros(65, np.int32), np.zeros(8, np.int32))
        dstate = tuple(torch.from_numpy(a).to(dev) for a in state)
        n0 = _build.launches["fused_window_guards"]
        got = tbe.guard_maxima(dstate, nslots).cpu().numpy()
        assert _build.launches["fused_window_guards"] == n0 + 1
        want = tbe.guard_maxima_ref(arrs[0], arrs[1], arrs[4], arrs[3],
                                    nslots)
        assert np.array_equal(got, want), (edge, got, want)


# ------------------------------------------- the planes around the cluster
import dataclasses  # noqa: E402

from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core.mnode import PolicyConfig  # noqa: E402
from repro_torch.core.simulate import TimedSimulation  # noqa: E402


@pytest.mark.parametrize("scenario,variant", [("crash", "dinomo"),
                                              ("composed", "clover"),
                                              ("zombie", "dinomo")])
def test_smoke_scenario_on_the_card_equals_the_cpu(dev, scenario, variant):
    """A smoke-profile scenario row and its events on the card equal the
    CPU's (which the CPU tests hold to the reference); clover probes the
    index through kernel A every batch."""
    n0 = _build.launches["clht_probe"]
    card = tscen.run_scenario(scenario, variant, seed=0, smoke=True,
                              device=dev)
    launched = _build.launches["clht_probe"] - n0
    cpu = tscen.run_scenario(scenario, variant, seed=0, smoke=True,
                             device="cpu")
    assert card.row() == cpu.row() and card.events == cpu.events
    assert card.violations == []
    assert launched > 0 or variant != "clover"


def test_timed_simulation_jit_on_the_card_equals_the_host_engine(dev):
    """TimedSimulation with engine="jit" on the card step for step equal
    to the host engine on the card through joins and removals, whose
    outages reach execute_batch as blocked KNs, and an injected failure:
    every TimePoint, event, outage and the whole state but the caches'
    lazy-heap records."""
    sims = []
    for engine in ("jit", "host"):
        c = tcl.DinomoCluster(
            num_kns=4, cache_bytes=1 << 19, value_bytes=1024,
            num_buckets=1 << 13, segment_capacity=256, device=dev,
            policy=PolicyConfig(grace_period_s=10.0, epoch_s=5.0,
                                max_kns=8))
        c.load(((k, f"v{k}") for k in range(3000)), warm=True)
        w = Workload(3000, zipf=0.99, mix="write_heavy_update", seed=5)
        sims.append(TimedSimulation(c, w.timed_batched, dt=1.0,
                                    sample_ops=600, engine=engine))
    blocked = []
    real = sims[0].c.execute_batch

    def noting(*args, **kwargs):
        blocked.append(bool(kwargs.get("blocked_kns")))
        return real(*args, **kwargs)

    sims[0].c.execute_batch = noting
    for sim in sims:
        sim.run(30.0, lambda t: 6e6 if 8 <= t <= 18 else 2e5)
        sim.inject_failure(sorted(sim.c.kns)[1])
        sim.run(36.0, lambda t: 2e5)
    jit, host = sims
    events = [r["event"] for r in jit.c.reconfig_log]
    assert "add" in events and "remove" in events and any(blocked)
    assert [dataclasses.astuple(p) for p in jit.trace] == \
        [dataclasses.astuple(p) for p in host.trace]
    assert (jit.event_log, jit.outages) == (host.event_log, host.outages)
    assert cluster_state(jit.c, heaps=False) == \
        cluster_state(host.c, heaps=False)
    assert jit.c._jit.counts["launches"] > 0


# ------------------------------------------- kernels 5 and 7 under autograd
# The kernels' outputs carry a graph: the forward is the kernel, the
# backward the plain version's recomputed under autograd (the reference
# differentiates its plain paths and has no backward kernel). So the
# gradients through a kernel equal the plain version's on the same inputs
# up to the order of f32 sums in the same functions on one card: 1e-5 of
# each gradient's max. Kernel 6 and flash_attention(out=) carry none and
# raise on an input that requires grad.
def grads_of(fn, inputs, weight):
    """fn's output, and the gradients of sum(fn(*inputs) * weight) with
    respect to every input that requires grad."""
    out = fn(*inputs)
    loss = (out.float() * weight).sum()
    return out, torch.autograd.grad(loss, [t for t in inputs
                                           if t.requires_grad])


def leaf(t):
    return t.detach().clone().requires_grad_()


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,dtype", [
    (2, 4, 4, 128, 128, 64, True, torch.bfloat16),
    (1, 6, 2, 200, 200, 128, True, torch.bfloat16),      # GQA group 3
    (1, 8, 2, 77, 300, 64, False, torch.bfloat16),       # ragged Sk
    (2, 4, 1, 129, 129, 32, True, torch.float32),
    (1, 4, 2, 64, 150, 64, False, torch.float32),
])
def test_flash_attention_gradients_match_plain(dev, b, h, kh, sq, sk, d,
                                               causal, dtype):
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
    weight = torch.randn((b, h, sq, d), generator=g, device=dev)
    n0 = _build.launches["flash_attention"]
    out, got = grads_of(lambda *t: tf.flash_attention(*t, causal=causal),
                        [leaf(q), leaf(k), leaf(v)], weight)
    assert _build.launches["flash_attention"] == n0 + 1
    assert out.grad_fn is not None
    ref, want = grads_of(lambda *t: tf.mha_ref(*t, causal=causal),
                         [leaf(q), leaf(k), leaf(v)], weight)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=1e-5 * scale, msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_gradients_through_model_layout_views(dev, dtype):
    """q, k and v as the model hands them: (B, S, H, D) views of one
    projection (the kernel reads their transposes through strides); the
    gradient reaches the projection and the weight behind it."""
    b, s, h, kh, d, dm = 2, 256, 8, 2, 64, 128
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, s, dm), generator=g, device=dev).to(dtype)
    w = (torch.randn((dm, (h + 2 * kh) * d), generator=g, device=dev)
         * dm ** -0.5).to(dtype)
    weight = torch.randn((b, s, h, d), generator=g, device=dev)

    def model(x, w, attn):
        proj = x @ w
        q = proj[..., :h * d].view(b, s, h, d)
        k = proj[..., h * d:(h + kh) * d].view(b, s, kh, d)
        v = proj[..., (h + kh) * d:].view(b, s, kh, d)
        return attn(q, k, v)

    def plain(q, k, v):
        return tf.mha_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True).transpose(1, 2)

    n0 = _build.launches["flash_attention"]
    _, got = grads_of(lambda x, w: model(x, w, tf.attention),
                      [leaf(x), leaf(w)], weight)
    assert _build.launches["flash_attention"] == n0 + 1
    _, want = grads_of(lambda x, w: model(x, w, plain), [leaf(x), leaf(w)],
                       weight)
    for name, a, ref in zip(("x", "w"), got, want):
        torch.testing.assert_close(a.float(), ref.float(), rtol=0,
                                   atol=1e-5 * float(ref.float().abs().max()),
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_gradients_match_plain(dev, dtype):
    """All six inputs: x, B and C as views of one projection (the
    gradient reaches the projection), dt, a = -exp(a_log) (it reaches
    a_log) and d."""
    b, s, h, g, n, p = 2, 256, 8, 1, 64, 64
    x, dt, a, bm, cm, d = ssd_case(dev, b, s, h, g, n, p, dtype, 17)
    xbc = torch.cat([x.reshape(b, s, -1), bm.reshape(b, s, -1),
                     cm.reshape(b, s, -1)], dim=-1)
    a_log = torch.log(-a)
    weight = torch.randn((b, s, h, p), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)

    def model(xbc, dt, a_log, d, scan):
        xv = xbc[..., :h * p].view(b, s, h, p)
        bv = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
        cv = xbc[..., h * p + g * n:].view(b, s, g, n)
        return scan(xv, dt, -torch.exp(a_log), bv, cv, d)

    inputs = [xbc, dt, a_log, d]
    n0 = _build.launches["ssd_scan"]
    out, got = grads_of(
        lambda *t: model(*t, lambda *u: tss.ssd_scan(*u, chunk=64)),
        [leaf(t) for t in inputs], weight)
    assert _build.launches["ssd_scan"] == n0 + 1
    assert out.grad_fn is not None
    _, want = grads_of(
        lambda *t: model(*t, lambda *u: tss.ssd_chunked(*u, 64)),
        [leaf(t) for t in inputs], weight)
    for name, a_, w in zip(("xbc", "dt", "a_log", "d"), got, want):
        assert a_.dtype == w.dtype and a_.shape == w.shape, name
        torch.testing.assert_close(a_.float(), w.float(), rtol=0,
                                   atol=1e-5 * float(w.float().abs().max()),
                                   msg=name)


def test_kernels_without_a_graph_refuse_inputs_that_require_grad(dev):
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=dev,
                    requires_grad=True)
    out = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        tf.flash_attention(q, q, q, out=out)
    with torch.no_grad():
        tf.flash_attention(q, q, q, out=out)
    q, kp, vp, pt, pos, lens = paged_case(dev, 2, 4, 2, 64, 8, 16, 3,
                                          torch.bfloat16, 0)
    args = [kp, vp, *(torch.from_numpy(x).to(dev) for x in (pt, pos, lens))]
    qd = q.detach().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd graph"):
        td.paged_decode_attention(qd, *args)
    n0 = _build.launches["paged_decode_attention"]
    with torch.no_grad():
        td.paged_decode_attention(qd, *args)
    assert _build.launches["paged_decode_attention"] == n0 + 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One steps.train_step of the smoke config (f32 weights, TF32 off)
    on the card -- kernel 5 (and 7) in the forward and again in each
    checkpointed block's recompute, the plain versions' backward --
    against the same step on the CPU: the metrics within 1e-4 and the
    parameters within 5e-2 of the learning rate (a gradient element near 0
    carries a last-place difference into Adam's normalized step)."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import zamba2
    from repro_torch.models.model_zoo import build_model, make_batch
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config(arch)
    host = _to(build_model(cfg).init(0, device="cpu"), "cpu")
    host = optim.adamw.tree_map(lambda t: t.float(), host)
    card = _to(host, dev)
    batch = make_batch(cfg, 2, 64, device="cpu")
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    outs = []
    for params, d in ((card, dev), (host, "cpu")):
        st_ = optim.init_state(params)
        n0 = dict(_build.launches)
        params, st_, m = steps.train_step(params, st_, _to(batch, d), cfg,
                                          opt)
        outs.append((params, m, {k: _build.launches[k] - n0[k]
                                 for k in ("flash_attention", "ssd_scan")}))
    (p_card, m_card, launched), (p_host, m_host, _) = outs
    _, groups, _ = zamba2._group_shape(cfg)
    want = {"flash_attention": 2 * cfg.num_layers, "ssd_scan": 0} \
        if cfg.family == "dense" else \
        {"flash_attention": groups, "ssd_scan": 2 * cfg.num_layers}
    assert launched == want
    for k in m_host:
        torch.testing.assert_close(m_card[k].cpu(), m_host[k], rtol=1e-4,
                                   atol=1e-6, msg=k)
    for (path, a), (_, w) in zip(optim.adamw.leaves(p_card),
                                 optim.adamw.leaves(p_host), strict=True):
        gap = float((a.cpu() - w).abs().max()) / opt.lr
        assert gap <= 5e-2, (path, gap)


@pytest.mark.parametrize("async_flush", [True, False])
def test_checkpoint_store_round_trip_on_the_card(dev, tmp_path, async_flush):
    """Card tensors of every stored type saved, written in place at once
    (as the next train step writes them), and restored onto the card: the
    values from before the write, on the card."""
    from repro_torch.checkpoint import CheckpointStore
    g = torch.Generator(device=dev).manual_seed(0)
    tree = ({"w": torch.randn((64, 32), generator=g, device=dev)
             .to(torch.bfloat16),
             "m": torch.randn((5, 7), generator=g, device=dev)},
            {"step": torch.tensor(3, dtype=torch.int32, device=dev),
             "f8": torch.randn(9, generator=g, device=dev)
             .to(torch.float8_e4m3fn)})
    want = [t.clone() for t in (tree[0]["w"], tree[0]["m"],
                                tree[1]["step"], tree[1]["f8"])]
    store = CheckpointStore(str(tmp_path), async_flush=async_flush)
    fut = store.save(3, tree)
    with torch.no_grad():
        for t in (tree[0]["w"], tree[0]["m"]):
            t.add_(1)
    fut.result()
    got, _, step = store.restore(tree)
    assert step == 3
    leaves = (got[0]["w"], got[0]["m"], got[1]["step"], got[1]["f8"])
    for a, w in zip(leaves, want):
        assert a.device.type == "cuda" and a.dtype == w.dtype
        assert torch.equal(a.view(torch.uint8) if a.dtype ==
                           torch.float8_e4m3fn else a,
                           w.view(torch.uint8) if w.dtype ==
                           torch.float8_e4m3fn else w)


def test_train_loop_saves_and_resumes_on_the_card(dev, tmp_path, capsys):
    """launch.train.train at qwen1.5-0.5b's smoke size on the card: 12
    steps with a failure injected after step 11 (kernel 5 twice a layer a
    step), then 5 resumed from the sealed step 10; the restored state on
    the card equals what was saved (its leaves serialized as the store
    writes them have the manifest's CRCs)."""
    import io
    import json
    import zlib
    from repro_torch import state
    from repro_torch.checkpoint import CheckpointStore, ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as ttrain
    cfg = get_smoke_config("qwen1.5-0.5b")
    d = str(tmp_path)
    run = dict(batch=2, seq=64, ckpt_dir=d, log_every=5)
    n0 = _build.launches["flash_attention"]
    ttrain.train("qwen1.5-0.5b", steps=12, fail_at=11, **run)
    assert _build.launches["flash_attention"] - n0 == 12 * 2 * cfg.num_layers
    assert CheckpointStore(d).steps() == [10]
    capsys.readouterr()
    params, opt_state, losses = ttrain.train("qwen1.5-0.5b", steps=5,
                                             resume=True, **run)
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out
    assert all(t.device.type == "cuda"
               for _, t in optim_leaves([params, opt_state]))
    assert np.isfinite(losses).all()
    template = state.checkpoint_template(params, opt_state, cfg)
    tree, _, step = CheckpointStore(d).restore(template)
    entries = json.load(open(f"{d}/MANIFEST-10.json"))["entries"]
    for name, leaf in ckpt._leaf_paths(tree):
        assert leaf.device.type == "cuda", name
        stored, dtype = ckpt._to_storage(leaf)
        buf = io.BytesIO()
        np.save(buf, stored)
        assert zlib.crc32(buf.getbuffer()) & 0xFFFFFFFF == \
            entries[name]["crc"], name
        assert dtype == entries[name]["dtype"], name


def test_hot_row_lookup_on_the_card_equals_the_gather(dev):
    from repro_torch import embedding
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((4096, 256), generator=g, device=dev) \
        .to(torch.bfloat16)
    rng = np.random.default_rng(0)
    counts = np.bincount(rng.zipf(1.2, 50_000) % 4096, minlength=4096)
    hot = embedding.select_hot_rows(counts, 3.0, 64)
    st = embedding.build_replica(table, hot, pad_to=64)
    assert st.hot_rows.device.type == "cuda"
    ids = torch.from_numpy(rng.zipf(1.2, (8, 512)) % 4096).to(dev)
    out, is_hot = embedding.lookup(table, st, ids)
    assert torch.equal(out, table[ids])
    np.testing.assert_array_equal(is_hot.cpu().numpy(),
                                  np.isin(ids.cpu().numpy(), hot))
    table.mul_(2)
    st = embedding.refresh_after_update(table, st)
    out, _ = embedding.lookup(table, st, ids)
    assert torch.equal(out, table[ids])


def optim_leaves(tree):
    from repro_torch.optim.adamw import leaves
    return leaves(tree)
