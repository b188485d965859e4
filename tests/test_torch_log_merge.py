"""Port parity for the write path: repro_torch.kernels.log_merge (plain
torch versions on the CPU) against repro.kernels.log_merge (Pallas in
interpret mode), mirroring the reference's kernel sweeps, plus the
port's restriction of merge_segment_fast to the pending window. Exact
comparisons (integers)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clht as jc  # noqa: E402
from repro.core import log as jl  # noqa: E402
from repro.kernels import clht_probe as jp  # noqa: E402
from repro.kernels import log_merge as jm  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.core import clht as tc  # noqa: E402
from repro_torch.core import log as tl  # noqa: E402
from repro_torch.kernels import log_merge as tm  # noqa: E402

RNG = np.random.default_rng(7)


def jfields(x) -> dict:
    return {f.name: np.array(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def assert_same(jx, tx):
    ref, got = jfields(jx), state.to_numpy(tx)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def assert_same_lines(got, jlines):
    """8-lane port lines against the reference's 128-lane lines."""
    j = np.asarray(jlines)
    np.testing.assert_array_equal(got[:, :7].numpy(), j[:, :7])


def t(a):
    return torch.tensor(np.asarray(a, dtype=np.int32))


def prefilled(nb, space, n):
    """A reference table with ``n`` keys already merged, and its lines."""
    pk = RNG.integers(0, nb * space, n).astype(np.int32)
    tab, *_ = jc.clht_insert(jc.clht_init(nb), jnp.asarray(pk),
                             jnp.asarray(pk + 7000))
    return tab


@pytest.mark.parametrize("nb,entries,space", [
    (64, 200, 2), (128, 500, 2), (32, 64, 2), (16, 300, 4)])
def test_log_merge_sweep(nb, entries, space):
    keys = RNG.integers(0, nb * space, entries).astype(np.int32)
    keys[::17] = -3                                   # padding entries
    ptrs = np.arange(entries, dtype=np.int32)
    tab = prefilled(nb, space, nb // 2)
    jlines = jp.pack_table(tab.keys, tab.ptrs, tab.nxt)
    bids = np.asarray(jc.bucket_of(jnp.asarray(np.maximum(keys, 0)), nb))
    l_j, o_j, k_j = jm.log_merge(jlines, jnp.asarray(bids), jnp.asarray(keys),
                                 jnp.asarray(ptrs))
    tt, _, _ = state.from_jax_arrays(table=jfields(tab), device="cpu")
    lines, o_t, k_t = tm.log_merge(tt.lines, t(bids), t(keys), t(ptrs))
    assert lines is tt.lines                          # merged in place
    assert_same_lines(lines, l_j)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))


@pytest.mark.parametrize("nb,entries,space", [
    (64, 200, 6), (128, 500, 3), (32, 64, 2), (16, 300, 4)])
def test_merge_window_plan_ref_matches_sequential(nb, entries, space):
    """The planned-layout oracle and the entry-at-a-time oracle agree,
    and both agree with the reference's numpy oracles."""
    keys = RNG.integers(0, nb * space, entries).astype(np.int32)
    ptrs = RNG.integers(0, 10**6, entries).astype(np.int32)
    tab = prefilled(nb, space, 40)
    jlines = np.asarray(jp.pack_table(tab.keys, tab.ptrs, tab.nxt))
    bids = np.asarray(jc.bucket_of(jnp.asarray(keys), nb))
    l_r, o_r, k_r = jm.log_merge_ref(jlines, bids, keys, ptrs)
    tt, _, _ = state.from_jax_arrays(table=jfields(tab), device="cpu")
    for fn in (tm.log_merge_ref, tm.merge_window_plan_ref):
        l_t, o_t, k_t = fn(tt.lines, t(bids), t(keys), t(ptrs))
        assert_same_lines(l_t, l_r)
        np.testing.assert_array_equal(o_t.numpy(), o_r)
        np.testing.assert_array_equal(k_t.numpy(), k_r)
    l_p, o_p, k_p = jm.merge_window_plan_ref(jlines, bids, keys, ptrs)
    np.testing.assert_array_equal(l_p, l_r)


def test_log_merge_sorted_groups_full_buckets_and_padding():
    """Kernel C's plain version on hand-made groups: updates, claims until
    the line is full, a claim that fails, and a padding key."""
    tab = tc.clht_init(4, device="cpu")
    starts = t([0, 6, 7])
    bids = t([1, 1, 1, 1, 1, 1, 3])
    keys = t([5, 6, 5, 7, 8, -3, 9])
    ptrs = t([50, 60, 51, 70, 80, 99, 90])
    old, ok = tm.log_merge_sorted(tab.lines, starts, bids, keys, ptrs)
    np.testing.assert_array_equal(old.numpy(), [-1, -1, 50, -1, -1, -1, -1])
    np.testing.assert_array_equal(ok.numpy(), [1, 1, 1, 1, 0, 0, 1])
    np.testing.assert_array_equal(tab.lines[1].numpy(),
                                  [5, 6, 7, 51, 60, 70, -1, -1])
    np.testing.assert_array_equal(tab.lines[3, :4].numpy(), [9, -1, -1, 90])


def test_merge_segment_fast_equals_sequential_insert():
    keys = RNG.choice(4000, 200, replace=False).astype(np.int32)
    seg = tl.segment_init(256, device="cpu")
    seg, _ = tl.log_append(seg, t(keys), torch.arange(200, dtype=torch.int32))
    t1, _, ok1 = tm.merge_segment_fast(tc.clht_init(128, device="cpu"), seg)
    t2, _, ok2, _ = tc.clht_insert(tc.clht_init(128, device="cpu"),
                                   seg.keys, seg.ptrs,
                                   torch.arange(256) < 200)
    np.testing.assert_array_equal(ok1.numpy(), ok2[:200].numpy())
    p1, f1, _ = tc.clht_lookup(t1, t(keys))
    p2, f2, _ = tc.clht_lookup(t2, t(keys))
    assert torch.equal(f1, f2) and torch.equal(p1, p2)


@pytest.mark.parametrize("nb,merged,count", [(16, 0, 80), (16, 30, 80),
                                              (64, 50, 60), (8, 20, 20)])
def test_merge_segment_fast_pending_window(nb, merged, count):
    """The port merges only [merged, count); the reference masks the rest
    of the segment, which reports old=-1, ok=False and changes nothing.
    Torn seals inside the window are masked the same way."""
    js = jl.segment_init(96)
    keys = RNG.integers(0, nb * 4, count).astype(np.int32)
    js, _ = jl.log_append(js, jnp.asarray(keys),
                          jnp.arange(count, dtype=jnp.int32) + 100)
    seal = np.array(js.seal)
    seal[merged + 3:count:11] = jl.TORN
    js = jl.LogSegment(keys=js.keys, ptrs=js.ptrs, seal=jnp.asarray(seal),
                       count=js.count, merged=jnp.int32(merged))
    jt = prefilled(nb, 4, nb)
    jt2, o_j, k_j = jm.merge_segment_fast(jt, js)
    tt, ts, _ = state.from_jax_arrays(table=jfields(jt), seg=jfields(js),
                                      device="cpu")
    tt, o_t, k_t = tm.merge_segment_fast(tt, ts)
    assert_same(jt2, tt)
    assert o_t.shape == (count - merged,)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j)[merged:count])
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j)[merged:count])
    outside = np.r_[0:merged, count:96]
    assert (np.asarray(o_j)[outside] == -1).all()
    assert not np.asarray(k_j)[outside].any()


@pytest.mark.parametrize("nb,cap,width,batches,space", [
    (64, 96, 8, 3, 128), (128, 64, 4, 2, 256), (32, 48, 4, 3, 64),
    (4, 90, 4, 3, 64)])
def test_log_append_merge_fused_matches_ref(nb, cap, width, batches, space):
    """Fused heap-append + log-append + merge == the reference's fused op
    and the port's un-fused path, across successive batches with
    duplicate keys (and, at 4 buckets, overflow exhaustion), and a final
    batch that overflows the segment."""
    jt, js, jh = jc.clht_init(nb), jl.segment_init(cap), jl.heap_init(
        2 * cap + 8, width)
    rng = np.random.default_rng(nb)
    failed = False
    planes = []
    for _ in range(2):
        tt, ts, th = state.from_jax_arrays(table=jfields(jt), seg=jfields(js),
                                           heap=jfields(jh), device="cpu")
        planes.append([tt, ts, th])
    for _ in range(batches):
        n = int(rng.integers(cap // (2 * batches), cap // batches))
        keys = rng.integers(0, space, n).astype(np.int32)
        vals = rng.integers(0, 99, (n, width)).astype(np.int32)
        jt, js, jh, p_j, o_j, k_j = jm.log_append_merge(
            jt, js, jh, jnp.asarray(keys), jnp.asarray(vals))
        failed |= not np.asarray(k_j).all()
        for plane, fn in zip(planes, (tm.log_append_merge,
                                      tm.log_append_merge_ref)):
            *state_t, p_t, o_t, k_t = fn(*plane, t(keys), t(vals))
            assert all(a is b for a, b in zip(state_t, plane))  # in place
            np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
            np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
            np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
            for jx, tx in zip((jt, js, jh), plane):
                assert_same(jx, tx)
    assert failed == (nb == 4)        # the overflow region ran out at 4
    big = rng.integers(0, nb, cap).astype(np.int32)
    # overflowing batch: state unchanged, ok all-False on every path
    bv = np.zeros((cap, width), np.int32)
    jt2, js2, jh2, p_j, o_j, k_j = jm.log_append_merge(
        jt, js, jh, jnp.asarray(big), jnp.asarray(bv))
    assert not np.asarray(k_j).any()
    for plane, fn in zip(planes, (tm.log_append_merge,
                                  tm.log_append_merge_ref)):
        *_, p_t, o_t, k_t = fn(*plane, t(big), t(bv))
        assert (p_t == -1).all() and (o_t == -1).all() and not k_t.any()
        for jx, tx in zip((jt2, js2, jh2), plane):
            assert_same(jx, tx)


# ------------------------------------------- kernel C on adversarial groups
import importlib  # noqa: E402

import torch_cases as cases  # noqa: E402

jmk = importlib.import_module("repro.kernels.log_merge.log_merge")


def mirror_merge_sorted(lines, starts, bids, keys, ptrs, walk_max, tile):
    """numpy mirror of csrc/log_merge.cu: a group of at most ``walk_max``
    entries walked in log order; a larger one in tiles of ``tile``
    entries, where each tile's new keys claim the empty slots in log order
    and every entry's old is its slot's previous entry."""
    lines = lines.copy()
    old = np.full(keys.size, -1, np.int32)
    ok = np.zeros(keys.size, np.int32)
    tb = lines.shape[0]
    for g in range(starts.size - 1):
        lo, hi = int(starts[g]), int(starts[g + 1])
        if hi <= lo:
            continue
        b = min(max(int(bids[lo]), 0), tb - 1)
        v = lines[b].copy()
        if hi - lo <= walk_max:
            for i in range(lo, hi):
                k = int(keys[i])
                match = [s for s in range(3) if v[s] == k]
                empty = [s for s in range(3) if v[s] == -1]
                target = (match or empty or [-1])[0]
                if k >= 0 and target >= 0:
                    old[i] = v[3 + target] if match else -1
                    ok[i] = 1
                    v[target], v[3 + target] = k, ptrs[i]
            lines[b] = v
            continue
        want = [int(v[s]) if v[s] >= 0 and v[s] not in v[:s] else -1
                for s in range(3)]
        empties = [s for s in range(3) if v[s] == -1]
        claimed = 0
        last = [-1, -1, -1]
        for base in range(lo, hi, tile):
            span = range(base, min(hi, base + tile))
            while claimed < len(empties):
                fresh = [i for i in span if keys[i] >= 0
                         and int(keys[i]) not in want]
                if not fresh:
                    break
                want[empties[claimed]] = int(keys[fresh[0]])
                claimed += 1
            for i in span:
                k = int(keys[i])
                if k < 0 or k not in want:
                    continue
                s = want.index(k)
                old[i] = (ptrs[last[s]] if last[s] >= 0
                          else (-1 if v[s] == -1 else v[3 + s]))
                ok[i] = 1
                last[s] = i
        for s in range(3):
            if last[s] >= 0:
                lines[b, s], lines[b, 3 + s] = want[s], ptrs[last[s]]
    return lines, old, ok


@pytest.mark.parametrize("name", [c for c in cases.MERGE_CASES
                                  if c != "clamp"])
def test_log_merge_sorted_adversarial_matches_the_jax_kernel(name):
    """Kernel C's plain version (what the wrapper runs on the CPU) against
    the Pallas kernel in interpret mode: hot keys, more new keys than
    empty slots, -1 and -3 keys, lines holding a key twice."""
    lines, starts, bids, keys, ptrs = cases.merge_case(name)
    first = np.zeros(keys.size, np.int32)
    first[starts[:-1]] = 1
    wide = np.full((lines.shape[0], 128), -1, np.int32)
    wide[:, :8] = lines
    rows, o_j, k_j = jmk.log_merge_sorted(
        jnp.asarray(wide), jnp.asarray(bids), jnp.asarray(first),
        jnp.asarray(keys), jnp.asarray(ptrs), interpret=True)
    lt = torch.from_numpy(lines.copy())
    o_t, k_t = tm.log_merge_sorted(lt, *map(torch.from_numpy,
                                            (starts, bids, keys, ptrs)))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    want = lines.copy()
    want[bids[starts[:-1]]] = np.asarray(rows)[starts[1:] - 1, :8]
    np.testing.assert_array_equal(lt.numpy(), want)


@pytest.mark.parametrize("walk_max,tile", [(32, 1024), (4, 8), (0, 1)])
@pytest.mark.parametrize("name", cases.MERGE_CASES)
def test_the_kernels_parallel_merge_matches_plain(name, walk_max, tile):
    """The CUDA kernel's design, mirrored in numpy, equals the plain
    version bit for bit: groups split by size, claims found tile by tile,
    each old from the slot's previous entry (small tiles cross many tile
    edges)."""
    lines, starts, bids, keys, ptrs = cases.merge_case(name)
    lt = torch.from_numpy(lines.copy())
    o_t, k_t = tm.log_merge_sorted_ref(lt, *map(torch.from_numpy,
                                                (starts, bids, keys, ptrs)))
    lm, o_m, k_m = mirror_merge_sorted(lines, starts, bids, keys, ptrs,
                                       walk_max, tile)
    np.testing.assert_array_equal(o_m, o_t.numpy())
    np.testing.assert_array_equal(k_m, k_t.numpy())
    np.testing.assert_array_equal(lm, lt.numpy())


def test_clamped_buckets_merge_into_the_edge_lines():
    """Bucket ids outside the table merge into the first and last lines,
    as the kernel's clamp does: the entry-at-a-time oracle on the clamped
    ids gives the same result."""
    lines, starts, bids, keys, ptrs = cases.merge_case("clamp")
    lt = torch.from_numpy(lines.copy())
    o_t, k_t = tm.log_merge_sorted(lt, *map(torch.from_numpy,
                                            (starts, bids, keys, ptrs)))
    live = keys >= 0
    clamped = np.clip(bids, 0, lines.shape[0] - 1)
    l_r, o_r, k_r = tm.log_merge_ref(torch.from_numpy(lines),
                                     t(clamped[live]), t(keys[live]),
                                     t(ptrs[live]))
    np.testing.assert_array_equal(lt.numpy(), l_r.numpy())
    np.testing.assert_array_equal(o_t.numpy()[live], o_r.numpy())
    np.testing.assert_array_equal(k_t.numpy()[live], k_r.numpy())
    assert (o_t.numpy()[~live] == -1).all() and not k_t.numpy()[~live].any()
    assert (lt.numpy()[[0, -1], :3] != lines[[0, -1], :3]).any(axis=1).all()
