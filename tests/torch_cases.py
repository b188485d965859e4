"""Adversarial inputs for the port's kernels C (log_merge_sorted), 4
(cache_transition) and E (fused_window), shared by the CPU parity tests,
the card tests, chip_smoke.py and tools/ab_kernels.py. numpy only; every
case is made from a seed."""

import numpy as np

SLOTS = 3
LANES = 8
INT32_MAX = 2**31 - 1


# ------------------------------------------------------------- kernel C
def merge_groups(spec, tb: int, seed: int):
    """Bucket-sorted entries from ``spec``, a list of (bucket, the line's
    slot keys, the group's keys in log order) in bucket order, on ``tb``
    random lines (about half their slots full). Returns (lines (tb, 8),
    starts (G+1,), bucket_ids, keys, ptrs), int32 each."""
    rng = np.random.default_rng(seed)
    lines = np.full((tb, LANES), -1, np.int32)
    full = rng.random((tb, SLOTS)) < 0.5
    lines[:, :SLOTS] = np.where(full, rng.integers(0, 1 << 20, (tb, SLOTS)),
                                -1)
    lines[:, SLOTS:2 * SLOTS] = rng.integers(0, INT32_MAX, (tb, SLOTS))
    lines[:, 2 * SLOTS] = rng.integers(-1, tb, tb)      # chain links
    lines[:, 2 * SLOTS + 1] = rng.integers(0, INT32_MAX, tb)
    bids, keys, starts = [], [], [0]
    for b, slot_keys, group in spec:
        lines[min(max(b, 0), tb - 1), :SLOTS] = slot_keys
        bids += [b] * len(group)
        keys += [int(k) for k in group]
        starts.append(len(keys))
    keys = np.asarray(keys, np.int32)
    ptrs = rng.integers(0, INT32_MAX, keys.size).astype(np.int32)
    return (lines, np.asarray(starts, np.int32), np.asarray(bids, np.int32),
            keys, ptrs)


def _draw(rng, n, choices, p=None):
    return rng.choice(np.asarray(choices), n, p=p).tolist()


def merge_case(name: str, seed: int = 0):
    """A named adversarial batch for kernel C (see ``MERGE_CASES``): each
    puts its pattern in a group larger than a block's tile of 1024
    entries, in one between 33 and 1024, and in one of at most 32, so a
    kernel that splits groups by size meets it on every path."""
    rng = np.random.default_rng(seed)
    sizes = (4000, 500, 20)
    if name == "hot_key":
        # a new key repeated thousands of times in a line with empty
        # slots, beside updates of the line's key and a few later keys
        spec = [(3 + 10 * i, [5, -1, -1],
                 _draw(rng, n, [9, 5, 11, 12, 13],
                       [0.85, 0.1, 0.02, 0.02, 0.01]))
                for i, n in enumerate(sizes)]
    elif name == "claims_overflow":
        # more new keys than empty slots, interleaved with updates
        spec = [(2 + 9 * i, line, _draw(rng, n, [7, *range(100, 141)]))
                for i, (n, line) in enumerate(zip(
                    sizes, ([7, -1, -1], [-1, -1, -1], [-1, 7, -1])))]
    elif name == "negatives":
        # key -1 against empty slots and -3 padding inside a hot group
        spec = [(1 + 11 * i, line, _draw(rng, n, [-1, -3, 4, 30, 31, 32, 33],
                                         [0.3, 0.2, 0.2, 0.1, 0.1, 0.05,
                                          0.05]))
                for i, (n, line) in enumerate(zip(
                    sizes, ([-1, 4, -1], [-1, -1, -1], [4, -1, -1])))]
    elif name == "dup_line":
        # lines that hold one key twice (the lower slot takes the
        # updates), a negative key that is not the empty mark, a full line
        lines = ([8, -1, 8], [6, 6, -1], [-2, 3, -1], [5, 5, 5])
        spec = [(4 + 7 * i, line,
                 _draw(rng, n, [line[0], line[1], 8, 6, 3, 5, 50, 51, 52]))
                for i, line in enumerate(lines) for n in (sizes[i % 3],)]
    elif name == "clamp":
        # bucket ids outside the table: the first group's clamps to line
        # 0, the last group's to the last line
        spec = [(-4, [-1, 2, -1], _draw(rng, 1500, [2, 60, 61, 62, -3])),
                (20, [-1, -1, -1], _draw(rng, 40, [1, 2, 3, 4])),
                (95, [9, -1, -1], _draw(rng, 12, [9, 70, 71, 72]))]
        return merge_groups(spec, 64, seed)
    else:
        assert name == "mixed", name
        # 200 groups, sizes from 1 to 2000, keys of each from a space
        # of 1-40 keys (a few negative)
        buckets = np.sort(rng.choice(1 << 12, 200, replace=False))
        spec = []
        for b in buckets.tolist():
            n = int(min(2000, rng.zipf(1.6)))
            space = int(rng.integers(1, 40))
            keys = rng.integers(0, space, n) + 1000 * (b % 7)
            keys[rng.random(n) < 0.05] = -1
            line = np.where(rng.random(3) < 0.5,
                            rng.integers(0, space, 3) + 1000 * (b % 7), -1)
            spec.append((b, line.tolist(), keys.tolist()))
        return merge_groups(spec, 1 << 12, seed)
    return merge_groups(spec, 64, seed)


MERGE_CASES = ("hot_key", "claims_overflow", "negatives", "dup_line",
               "clamp", "mixed")


# ------------------------------------------------------------- kernel 4
def _rows(code, rm=0, vb=0, zhit=0, zfill=0):
    n = len(code)
    rows = np.zeros((n, LANES), np.int32)
    for lane, x in enumerate((code, rm, vb, zhit, zfill)):
        rows[:, lane] = np.broadcast_to(np.asarray(x, np.int64), (n,))
    return rows


def transition_case(name: str, seed: int = 0):
    """A named adversarial window for kernel 4 (see
    ``TRANSITION_CASES``): (rows (N, 8) int32, victims int32, used0, z0,
    cap)."""
    rng = np.random.default_rng(seed)
    cap = 1 << 16
    if name == "victims_nonpositive":
        # promotes and fills into a full cache, with victims of <= 0 bytes
        # among the positive ones
        n = 512
        code = rng.choice([0, 1, 2, 2, 3], n)
        rows = _rows(code, rng.choice([0, 40, 1064], n),
                     rng.choice([296, 1064], n), rng.choice([0, 1], n),
                     rng.choice([0, 1], n))
        vic = rng.choice([-300, -64, 0, 0, 104, 296, 1064], 900)
        return rows, vic.astype(np.int32), cap - 50, 50, cap
    if name == "zero_victims":
        # nonnegative, with runs of 0-byte victims: the prefix sums are
        # flat there
        n = 512
        rows = _rows(rng.choice([1, 2], n), 0, 1064, 0, 1)
        vic = np.where(rng.random(3000) < 0.5, 0, 1064)
        return rows, vic.astype(np.int32), cap - 10, 1 << 20, cap
    if name == "empty_queue":
        # inserts that need space and no victim at all
        n = 256
        rows = _rows(rng.choice([1, 2], n), 0, 1064, rng.choice([0, 1], n),
                     1)
        return rows, np.zeros(0, np.int32), cap - 3000, 2, cap
    if name == "dry_mid":
        # promotes that each take a victim: the queue runs dry about
        # two fifths into the window
        n = 512
        rows = _rows(rng.choice([0, 1, 1, 2], n), 0, 1064, 0, 1)
        return rows, np.full(100, 1064, np.int32), cap - 10, 1 << 20, cap
    if name == "many_small":
        # each promote's make-space consumes tens of small victims, past
        # the staged tiles of the queue (prefix sums are staged 2048 at a
        # time)
        n = 512
        rows = _rows(np.full(n, 1), 0, rng.choice([1064, 2048], n))
        vic = rng.integers(8, 48, 40000)
        return rows, vic.astype(np.int32), cap - 100, 1 << 20, cap
    if name == "floor_mix":
        # promotes whose Eq. 1 deficit free - need is negative and not a
        # multiple of 32, the zero count near the quotient on both sides
        n = 512
        rows = _rows(np.full(n, 1), 0, 150 + rng.integers(0, 150, n),
                     rng.random(n) < 1 / 64)
        return rows, np.full(400, 1064, np.int32), cap - 100, 6, cap
    if name == "wide_values":
        # values near int32's range: a 1 GiB cache, inserts of up to 768
        # MiB and victims of 256 MiB (the kernel scans them in int64)
        n = 512
        cap = 1 << 30
        code = rng.choice([0, 1, 1, 2], n)
        rows = _rows(code, 0, rng.choice([1 << 20, 3 << 27], n),
                     rng.choice([0, 1], n), 1)
        vic = rng.choice([1 << 28, 3 << 26, 1064], 600)
        return rows, vic.astype(np.int32), cap - 4096, 1 << 25, cap
    if name == "long_make_space":
        # single make-spaces of about 7,500 victims of 8 bytes: more than
        # the kernel stages at a time
        n = 256
        code = np.where(np.arange(n) % 32 == 5, 1, 0)
        rows = _rows(code, 0, 60000)
        return rows, np.full(40000, 8, np.int32), cap - 10, 1 << 20, cap
    assert name == "window_8192", name
    # a 2^13-op window of a full cache whose fills make space, with a
    # queue of 4,096 victims of 1,064 bytes: the rows and the queue cross
    # the staged tiles
    n = 1 << 13
    code = rng.choice([0, 1, 2], n, p=[0.5, 0.25, 0.25])
    rows = _rows(code, np.where(code == 2, rng.choice([0, 32], n), 0), 1064,
                 rng.choice([0, 1], n), 1)
    cap = 1 << 30
    return rows, np.full(4096, 1064, np.int32), cap - 500, 40, cap


TRANSITION_CASES = ("victims_nonpositive", "zero_victims", "empty_queue",
                    "dry_mid", "many_small", "floor_mix", "wide_values",
                    "long_make_space", "window_8192")


# ------------------------------------------------------------- kernel E
# the batch executor's constants (kernels/batch_executor/ref.py)
HIST = 65
PM_INVALID, PM_ABSENT = -2, -1


def window_state(nslots: int, kind=(), count=(), length=(), used=0,
                 zshort=0, nvals=0, nshort=0, ema_dirty=0, clock=1):
    """A fused_window state tuple of ``nslots`` slots: entries given as
    {key: value} dicts per field, the histogram of the shortcuts' counts
    and the registers derived from them."""
    arrs = [np.zeros(nslots, np.int32) for _ in range(6)]
    for j, d in enumerate((kind, count, {}, length)):
        for k, v in dict(d).items():
            arrs[j][k] = v
    arrs[2][:] = np.where(arrs[0] == 2, np.arange(nslots), 0)
    hist = np.zeros(HIST, np.int32)
    for c in arrs[1][arrs[0] == 1].tolist():
        hist[min(c, HIST - 1)] += 1
    regs = np.array([used, clock + nslots, zshort, nvals, nshort, ema_dirty,
                     0, 0], np.int32)
    return (*arrs, hist, regs)


def window_chain(seed: int, nslots: int, w: int, windows: int, hot=None):
    """tests/test_kernels.py:_be_run_chain's random windows: a cache of
    40-2000 bytes over ``nslots`` slots (keys drawn from ``hot`` slots
    spread over them, if given), reads and writes, prefetches invalid,
    absent or found, a few segcache-backed reads. Returns (state, [(ops,
    keys, wptr, pm_ptr, pm_len, seg0, n), ...], cap, write_bytes, amr)."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(40, 2000))
    wb = int(rng.integers(8, 200))
    amr = float(rng.choice([0.5, 1.0, 3.7, 10.0, 0.125]))
    pool = (np.arange(nslots) if hot is None else
            rng.choice(nslots, hot, replace=False)).astype(np.int32)
    state = window_state(nslots, clock=-nslots)
    out = []
    for _ in range(windows):
        ops = rng.integers(0, 2, w).astype(np.int32)
        n = int(rng.integers(1, w + 1))
        keys = rng.choice(pool, w).astype(np.int32)
        wptr = rng.integers(0, 10000, w).astype(np.int32)
        pm_ptr = rng.choice(
            np.array([PM_INVALID, PM_ABSENT, 5, 77, 1234], np.int32), w,
            p=[0.08, 0.2, 0.24, 0.24, 0.24]).astype(np.int32)
        pm_len = rng.integers(1, 300, w).astype(np.int32)
        seg0 = (rng.random(w) < 0.05).astype(np.int32)
        out.append((ops, keys, wptr, pm_ptr, pm_len, seg0, n))
    return state, out, cap, wb, amr


def window_cut_case(name: str, nslots: int = 64, prefix: int = 5):
    """A window that runs ``prefix`` proven-absent misses, then stops at
    an op for cut reason ``name`` (or, for "promote" and "no_promote",
    decides Eq. 1 on the table and runs on). Returns (state, (ops, keys,
    wptr, pm_ptr, pm_len, seg0, n), cap, write_bytes, amr).

    The cache holds 40 shortcuts (keys 1-40, count 63; 64 for "spill")
    and the candidate, key 0, a shortcut of length 200; it is full, so
    the candidate's promotion needs 7 evictions (victim sum 441)."""
    c0 = {"table": 5000, "promote": 30, "no_promote": 2}.get(name, 3)
    vc = 64 if name == "spill" else 63
    kind = {k: 1 for k in range(41)}
    count = {0: c0, **{k: vc for k in range(1, 41)}}
    length = {k: 200 for k in range(41)}
    cap = 41 * 32
    state = window_state(nslots, kind, count, length, used=cap, nshort=41,
                         ema_dirty=int(name == "ema"))
    w = prefix + 3
    ops = np.zeros(w, np.int32)
    keys = np.full(w, nslots - 1, np.int32)
    keys[:prefix] = np.arange(50, 50 + prefix) % nslots
    keys[prefix] = 0
    pm_ptr = np.full(w, PM_ABSENT, np.int32)
    pm_len = np.full(w, 100, np.int32)
    seg0 = np.zeros(w, np.int32)
    if name == "segcache":
        keys[prefix] = nslots - 2
        seg0[prefix] = 1
    elif name == "prefetch":
        keys[prefix] = nslots - 2
        pm_ptr[prefix] = PM_INVALID
    # amr 10: row c of the table is floor(c / 10), so 441 promotes from
    # count 4410 and the table's last row (409) never suffices
    amr = 10.0 if name in ("table", "no_promote") else 0.05
    return (state, (ops, keys, np.zeros(w, np.int32), pm_ptr, pm_len, seg0,
                    w), cap, 64, amr)


WINDOW_CUTS = ("segcache", "prefetch", "spill", "ema", "table", "promote",
               "no_promote")


def window_victims_case(seed: int, nslots: int = 1 << 12, w: int = 2048,
                        windows: int = 3, nvals: int | None = None):
    """A full cache over ``nslots`` slots -- ``nvals`` values (nslots/32
    if None; stamps ascending) and nslots/4 shortcuts, most of them never
    hit -- and
    windows of value and shortcut hits (leaves of both trees changed
    between make-spaces), misses that fill, writes and promotions, each
    of which makes space: the values are demoted first, then shortcuts
    evicted, so the windows consume victims from both trees. Returns
    (state, [(ops, keys, wptr, pm_ptr, pm_len, seg0, n), ...], cap,
    write_bytes, amr)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(nslots)
    nv, ns = (nslots // 32 if nvals is None else nvals), nslots // 4
    vk, sk, rest = perm[:nv], perm[nv:nv + ns], perm[nv + ns:]
    length = 100
    vcnt = rng.integers(1, 50, nv)
    scnt = np.where(rng.random(ns) < 0.6, 0, rng.integers(1, 40, ns))
    kind = {**{int(k): 2 for k in vk}, **{int(k): 1 for k in sk}}
    count = {**dict(zip(vk.tolist(), vcnt.tolist())),
             **dict(zip(sk.tolist(), scnt.tolist()))}
    lens = {int(k): length for k in perm[:nv + ns]}
    cap = nv * (length + 40) + ns * 32
    state = window_state(nslots, kind, count, lens, used=cap,
                         zshort=int((scnt == 0).sum()), nvals=nv, nshort=ns)
    out = []
    for _ in range(windows):
        # reads of the values, the shortcuts and half the rest; writes to
        # the other half (a read of a written key would cut the window)
        src = rng.choice(3, w, p=[0.4, 0.35, 0.25])
        ops = (rng.random(w) < 0.15).astype(np.int32)
        half = rest.size // 2
        keys = np.where(src == 0, rng.choice(vk, w),
                        np.where(src == 1, rng.choice(sk, w),
                                 rng.choice(rest[:half], w)))
        keys = np.where(ops == 1, rng.choice(rest[half:], w),
                        keys).astype(np.int32)
        wptr = rng.integers(0, 1 << 20, w).astype(np.int32)
        pm_ptr = np.where(rng.random(w) < 0.8,
                          rng.integers(0, 1 << 20, w),
                          PM_ABSENT).astype(np.int32)
        pm_len = np.full(w, length, np.int32)
        seg0 = np.zeros(w, np.int32)
        out.append((ops, keys, wptr, pm_ptr, pm_len, seg0, w))
    return state, out, cap, length, 0.5
