"""Planned cache transitions for one KN's ArrayDAC window (paper Sec.
3.3): the port's copy of the DAC half of the reference's
``core/transition.py``, decision for decision.

One vectorized NumPy state machine sweeps a whole window's ops over
``ArrayDAC``'s kind / ptr / len / frequency / recency vectors (plus the
live-shortcut count histogram) and emits a :class:`DacWindowPlan` of
bulk decisions -- which keys promote, which LRU values demote (and
whether each victim's shortcut re-insert fits), which fills land as
values vs shortcuts, every op's RT charge, and the exact final per-key
state.  ``ArrayDAC.apply_plan`` then mutates the cache with O(window)
numpy work.

Exactness contract: a plan is only returned when every decision is
*provably* identical to what the per-op path would make.  The planner
assumes the dominant regime -- on a warm full cache every shortcut hit
promotes through Eq. 1's free-space / zero-shortcut fast paths and
every fill keeps its entry class; on a cold roomy cache everything
lands as a value -- and then *verifies* each assumption per op against
the cumulative space trajectory (with the demotion schedule solved by a
single scan over the frozen LRU victim queue).  Any op it cannot prove
truncates the plan there, or aborts it (the caller replays the window
through the exact per-op machinery):

  * an Eq. 1 decision that needs the exact victim count sum,
  * an eviction (the value pool runs dry mid-window),
  * a demotion victim that the window itself touches ("victim created
    inside the same window" -- its stamp order would shift),
  * a fill whose value/shortcut class flips mid-window,
  * segcache trims that could race a segcache-hit read.

Each op's prior state (passes A and B: membership, miss resolution,
regime, kind / count / length) comes from ``prior_state``, which the
device twin's gather (``kernels.cache_transition.ops.gather_window``)
calls too: the ``cache_transition`` kernel runs the planner's
structural space machine on those vectors.

The static-split planner (``plan_static_window``: the same contract over
an ``ArrayStaticCache``, no counts and no promotions), the merge plane's
planner (``plan_merge_window``, the DPM pool's planned merge) and the
Clover read plan (``plan_clover_reads``: a read-only batch's slice of one
Clover KN, planned only where it cannot evict) are copied from the
reference too.
"""

from __future__ import annotations

import numpy as np

from .dac import CNT_HIST_MAX, SHORTCUT_BYTES, VALUE_OVERHEAD_BYTES

# Windows below this size replay through the per-op machinery: the
# plan's fixed numpy overhead (~30 vector ops) would dominate.
MIN_PLAN_OPS = 16

# planned/replayed window counters (the window loop adds to them)
PLAN_STATS = {"planned_windows": 0, "planned_ops": 0,
              "replayed_windows": 0, "replayed_ops": 0}


# merge-plane coverage counters: entries merged through a
# MergeWindowPlan vs replayed through the scalar insert/_merge_entry
MERGE_PLAN_STATS = {"planned_windows": 0, "planned_entries": 0,
                    "replayed_windows": 0, "replayed_entries": 0}

# the batch engines' wall clock (perf_counter seconds) by stage: the host
# window engine's planning, bulk apply and per-op replay (the cluster adds
# to them), and the compiled engine's (core/jit_engine.py) window prep,
# kernel-E dispatch with its copy back, fold, scatter-back and (a key the
# reference does not have) upload. Same-run ratios only; absolute values
# depend on the host.
ENGINE_WALL = {"host_plan": 0.0, "host_apply": 0.0, "host_replay": 0.0,
               "jit_prep": 0.0, "jit_dispatch": 0.0, "jit_fold": 0.0,
               "jit_sync": 0.0, "jit_upload": 0.0, "jit_full_upload": 0.0}


def reset_plan_stats() -> None:
    for k in PLAN_STATS:
        PLAN_STATS[k] = 0


def reset_merge_plan_stats() -> None:
    for k in MERGE_PLAN_STATS:
        MERGE_PLAN_STATS[k] = 0


def reset_engine_wall() -> None:
    for k in ENGINE_WALL:
        ENGINE_WALL[k] = 0.0


def _last_occurrence(keys: np.ndarray):
    """Indices of the last op per distinct key (ascending key sort is
    irrelevant -- only the last-wins selection matters)."""
    order = np.argsort(keys, kind="stable")
    s = keys[order]
    last = np.ones(s.size, bool)
    last[:-1] = s[1:] != s[:-1]
    return order[last]


class DacWindowPlan:
    """One ArrayDAC window's bulk transition decisions."""

    __slots__ = (
        # cache-side scatters (already deduplicated, last op wins)
        "kk_keys", "kk_kind", "kk_cnt",          # final kind/count per key
        "fill_keys", "fill_ptr", "fill_len",     # last fill per key
        "stp_keys", "stp_vals",                  # last stamp per key
        "lru_records",                           # ascending (stamp, key)
        "lfu_push",                              # (count, key) heappushes
        "hist_inc", "hist_dec",                  # clamped histogram slots
        "victims", "victim_reinsert", "victim_counts",
        # scalar state
        "clock_delta", "used_final", "nvals_final", "nshort_final",
        "zero_final",
        # cache stats deltas
        "value_hits", "shortcut_hits", "misses", "promotions",
        "demotions",
        # kn side
        "ops", "reads", "writes", "rts", "ema_rts",
        "seg_puts", "seg_replay", "out_vals",
        # the port's own: read by the cache_transition twin's gather
        "include_refills", "to_val",
    )


class StaticWindowPlan:
    """One ArrayStaticCache window's bulk transition decisions."""

    __slots__ = (
        "kk_keys", "kk_kind",
        "fill_keys", "fill_ptr", "fill_len",
        "stp_keys", "stp_vals",
        "vlru_records", "slru_records",
        "vvic", "svic",                          # per-side eviction keys
        "clock_delta", "vused_final", "sused_final",
        "nvals_final", "nshort_final",
        "value_hits", "shortcut_hits", "misses", "evictions",
        "ops", "reads", "writes", "rts", "ema_rts",
        "seg_puts", "seg_replay", "out_vals",
    )


def _resolve_miss(k, p, segd, seg_dead, probe_map, dkeys, dbuckets, pool):
    """Exact miss resolution for one read of an absent key: segcache
    first (0 RTs), else the prefetched probe when provably fresh, else
    the live index walk -- mirrors _scalar_read_dac.  ``seg_dead``:
    keys an earlier in-window delete popped from the segcache.
    Returns (kind, ptr, length, probes): kind 0 absent / 1 probe-found
    / 2 segcache."""
    if k not in seg_dead:
        seg = segd.get(k)
        if seg is not None:
            return 2, seg[0], seg[1], 0.0
    pr = probe_map.get(p)
    if pr is None or k in dkeys or pr[2] in dbuckets:
        ptr, probes = pool.index_lookup(k)
    else:
        ptr, probes = pr[0], pr[1]
    if ptr is None:
        return 0, -1, 0, float(probes)
    return 1, ptr, pool.heap_len[ptr], float(probes)


def _dup_split(keys: np.ndarray, opk: np.ndarray, kd: np.ndarray,
               loop_kinds: tuple):
    """Group the window's ops by key and split repeated-key handling.

    Returns (loop_idx, bump_idx, bump_rank):
      loop_idx  -- ascending op indices of repeated-key groups that
                   need exact python evolution: any write/delete in the
                   group, or a first kind in ``loop_kinds`` (an entry
                   class that evolves under reads);
      bump_idx / bump_rank -- ops of the remaining repeated groups
                   (pure hits on a stable entry class): their per-op
                   prior count is just first-count + occurrence rank.
    All None when every key is distinct."""
    m = keys.shape[0]
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.ones(m, bool)
    first[1:] = sk[1:] != sk[:-1]
    if first.all():
        return None, None, None
    gstart = np.flatnonzero(first)
    gid = np.cumsum(first) - 1
    anyw = np.add.reduceat((opk[order] != 0).astype(np.int64),
                           gstart) > 0
    firstkd = kd[order[gstart]]
    loop_first = np.zeros(gstart.size, bool)
    for lk in loop_kinds:
        loop_first |= firstkd == lk
    glen = np.diff(np.append(gstart, m))
    dup = glen > 1
    need = dup & (anyw | loop_first)
    rankable = dup & ~need
    loop_idx = np.sort(order[need[gid]]) if need.any() else None
    bump_idx = bump_rank = None
    if rankable.any():
        selm = rankable[gid]
        ranks = np.arange(m, dtype=np.int64) - gstart[gid]
        bump_idx = order[selm]
        bump_rank = ranks[selm]
    return loop_idx, bump_idx, bump_rank


class PriorState:
    """Each op of a window with its exact prior entry state, as passes A
    and B evolve it (see ``prior_state``)."""

    __slots__ = ("keys_l", "is_rd", "is_wr", "is_dl", "dup_idx",
                 "kd", "pc", "plen",                  # prior kind/count/len
                 "miss", "n_miss", "res_kind", "res_ptr", "res_len",
                 "res_probes", "fillm", "all_fits")


def _pass_a(keys_l, opk, pos, kd, dup_idx, segd, probe_map, dkeys,
            dbuckets, pool):
    """Pass A: membership evolution for repeated keys + misses.  Which
    reads are misses is regime-independent (any fill makes the key
    present), so resolve misses first; the segcache state an in-window
    delete popped is tracked via ``seg_dead``.  Returns (kd_m,
    res_cache, seg_dead): membership-evolved kinds (0 = miss for
    reads), the misses resolved on the way, the popped keys."""
    seg_dead: set = set()
    res_cache: dict = {}
    kd_m = kd
    if dup_idx is not None:
        kd_m = kd.copy()
        present: dict = {}
        opk_l = opk[dup_idx].tolist()
        for i, o in zip(dup_idx.tolist(), opk_l):
            k = keys_l[i]
            pres = present.get(k)
            if pres is None:
                pres = kd_m[i] != 0
            elif o == 0:
                kd_m[i] = 2 if pres else 0   # hit kind fixed in pass B
            if o == 0:
                if not pres:
                    r = _resolve_miss(k, int(pos[i]), segd, seg_dead,
                                      probe_map, dkeys, dbuckets, pool)
                    res_cache[i] = r
                    if r[0]:
                        pres = True
            elif o == 1:
                pres = True
                seg_dead.discard(k)
            else:
                pres = False
                seg_dead.add(k)
            present[k] = pres
    return kd_m, res_cache, seg_dead


def _pass_b(keys_l, opk, kd, pc, plen, dup_idx, res_cache, value_bytes,
            value_fills):
    """Pass B: exact per-op prior state (kind / count / length) of the
    repeated-key groups, evolved op by op.  ``value_fills``: the regime
    lets every fill land as a value (all_fits, or the refill retry);
    otherwise a write keeps its class and a miss lands a shortcut."""
    kd = kd.copy()
    kd_l = kd.tolist()
    pc_l = pc.tolist()
    plen_l = plen.tolist()
    state: dict = {}
    opk_l = opk[dup_idx].tolist()
    for i, o in zip(dup_idx.tolist(), opk_l):
        k = keys_l[i]
        st = state.get(k)
        if st is None:
            st = [kd_l[i], pc_l[i], plen_l[i]]
        else:
            kd_l[i], pc_l[i], plen_l[i] = st
        if o == 0:
            if st[0] == 0:
                r = res_cache.get(i)
                if r is not None and r[0]:
                    # filled: value when roomy, else shortcut
                    st[0] = 2 if value_fills else 1
                    st[1] = 1 if r[0] == 1 else 0
                    st[2] = r[2]
            else:
                st[1] += 1
                st[0] = 2            # value hit, or promoted hit
        elif o == 1:
            st[0] = 2 if (value_fills or st[0] == 2) else 1
            st[2] = value_bytes
        else:
            st[0], st[1], st[2] = 0, 0, 0
        state[k] = st
    return (np.asarray(kd_l, np.int64), np.asarray(pc_l, np.int64),
            np.asarray(plen_l, np.int64))


def prior_state(cache, kn, keys, opk, pos, probe_map, dkeys, dbuckets,
                pool, value_bytes, include_refills=False):
    """Passes A and B of ``plan_dac_window`` over one window: which reads
    miss and how each miss resolves, the regime (does the whole window
    fit without any space-making?), and each op's exact prior kind /
    count / length under that regime.  None when a segcache trim could
    race a segcache-hit read (the caller replays the window)."""
    m = keys.shape[0]
    ovh = VALUE_OVERHEAD_BYTES
    vbb = value_bytes + ovh
    kind_a = cache.kind
    cnt_a = cache.count
    len_a = cache.length
    segd = kn.segcache
    s = PriorState()

    kd = kind_a[keys].astype(np.int64)
    is_rd = opk == 0
    is_wr = opk == 1
    keys_l = keys.tolist()
    s.keys_l = keys_l
    s.is_rd, s.is_wr, s.is_dl = is_rd, is_wr, opk == 2
    # repeated keys: exact python evolution only for groups with
    # writes/deletes or an evolving first kind; repeated pure value
    # hits just increment their prior count by occurrence rank
    dup_idx, bump_idx, bump_rank = _dup_split(keys, opk, kd, (0, 1))
    s.dup_idx = dup_idx

    kd_m, res_cache, seg_dead = _pass_a(keys_l, opk, pos, kd, dup_idx,
                                        segd, probe_map, dkeys, dbuckets,
                                        pool)
    miss = is_rd & (kd_m == 0)
    n_miss = int(miss.sum())
    res_kind = res_ptr = res_len = res_probes = None
    if n_miss:
        # segcache trims by in-window puts could evict a key that a
        # later segcache-hit read in this window depends on: replay.
        if len(segd) + int(is_wr.sum()) > kn.segcache_cap:
            for i in np.flatnonzero(miss).tolist():
                if keys_l[i] in segd:
                    return None
        res_kind = np.zeros(m, np.int64)
        res_ptr = np.full(m, -1, np.int64)
        res_len = np.zeros(m, np.int64)
        res_probes = np.zeros(m, np.float64)
        for i in np.flatnonzero(miss).tolist():
            r = res_cache.get(i)
            if r is None:
                r = _resolve_miss(keys_l[i], int(pos[i]), segd, seg_dead,
                                  probe_map, dkeys, dbuckets, pool)
            res_kind[i], res_ptr[i], res_len[i], res_probes[i] = r
        fillm = miss & (res_kind > 0)
    else:
        fillm = np.zeros(m, bool)
    s.miss, s.n_miss, s.fillm = miss, n_miss, fillm
    s.res_kind, s.res_ptr, s.res_len, s.res_probes = \
        res_kind, res_ptr, res_len, res_probes

    # ---- regime: does the whole window fit without any space-making? -
    pvb0 = len_a[keys] + ovh          # prior value bytes (start state)
    worst = vbb * int(is_wr.sum()) + int(pvb0[is_rd & (kd == 1)].sum())
    if n_miss:
        worst += int((res_len[fillm] + ovh).sum())
    s.all_fits = cache.used + worst <= cache.capacity

    # ---- pass B: exact per-op prior state (kind / count / length) ----
    pc = np.where(kd == 0, 0, cnt_a[keys])
    plen = np.where(kd == 0, 0, len_a[keys])
    if bump_idx is not None:
        pc[bump_idx] += bump_rank        # repeated pure value hits
    if dup_idx is not None:
        kd, pc, plen = _pass_b(keys_l, opk, kd, pc, plen, dup_idx,
                               res_cache, value_bytes,
                               s.all_fits or include_refills)
    s.kd, s.pc, s.plen = kd, pc, plen
    return s


def plan_dac_window(cache, kn, keys, opk, pos, wplan, probe_map, dkeys,
                    dbuckets, pool, value_bytes, collect,
                    _include_refills=False):
    """Plan one ArrayDAC window.  Returns a DacWindowPlan covering the
    first ``plan.ops`` ops of the window (the planner truncates itself
    at the first op whose exactness it cannot prove cheaply -- e.g. a
    demotion victim the window touches later), or None when nothing can
    be planned (caller replays).

    keys/opk/pos: the window's ops in order (int64 keys, uint8 op kind
    0 read / 1 write / 2 delete, global batch positions).
    wplan: the staged _WritePlan (pointers / flush RTs per write rank).
    """
    m = keys.shape[0]
    if m < MIN_PLAN_OPS:
        return None
    ps = prior_state(cache, kn, keys, opk, pos, probe_map, dkeys,
                     dbuckets, pool, value_bytes, _include_refills)
    if ps is None:
        return None
    cap = cache.capacity
    ovh = VALUE_OVERHEAD_BYTES
    vbb = value_bytes + ovh
    sb = SHORTCUT_BYTES
    hmax = CNT_HIST_MAX
    kind_a = cache.kind
    cnt_a = cache.count
    len_a = cache.length
    keys_l = ps.keys_l
    is_rd, is_wr, is_dl = ps.is_rd, ps.is_wr, ps.is_dl
    dup_idx = ps.dup_idx
    kd, pc, plen = ps.kd, ps.pc, ps.plen
    miss, n_miss, fillm = ps.miss, ps.n_miss, ps.fillm
    res_kind, res_ptr, res_len, res_probes = \
        ps.res_kind, ps.res_ptr, ps.res_len, ps.res_probes
    all_fits = ps.all_fits

    vhit = is_rd & (kd == 2)
    shit = is_rd & (kd == 1)
    pvb = plen + ovh

    # ---- structural scan: exact space machine over the window --------
    # The python loop visits only ops that can change occupancy or the
    # zero-shortcut counter: promotes, class-ambiguous or byte-moving
    # fills, and deletes.  Shortcut->shortcut refills (byte- and
    # z-neutral) and length-preserving value refills (always fit) are
    # excluded and verified vectorized afterwards against the
    # piecewise-constant occupancy the loop records.  The loop
    # truncates the plan at the first op it cannot prove: a demotion
    # victim first touched later in the window (the prefix before that
    # touch stays exact), an Eq. 1 decision needing the exact victim
    # sum, a dry victim pool (eviction territory), or a duplicate-key
    # fill whose class contradicts the pass-B evolution.
    rem = is_wr | is_dl
    z = cache._zero_shortcuts
    vic_keys_l: list = []
    vic_cnt_l: list = []
    reinsert_l: list = []
    fills = is_wr | fillm
    used_final = cache.used
    cut = m
    # shortcut->shortcut refills are normally excluded from the loop
    # and verified vectorized; in the warm-up transition regime (free
    # space lets them re-fill as values) the retry plans them through
    # the adaptive loop instead
    sc_refill = is_wr & (kd == 1) if not _include_refills \
        else np.zeros(m, bool)
    eq_refill = is_wr & (kd == 2) & (plen == value_bytes)
    dec_val = np.zeros(m, bool)
    bp: list = []          # (gidx, used, zero_count, victims) per entry
    if all_fits:
        dec_val = fills
        r_b = np.zeros(m, np.int64)
        sel = rem & (kd == 2)
        r_b[sel] = pvb[sel]
        r_b[rem & (kd == 1)] = sb
        r_b[shit] = sb
        v_b = np.zeros(m, np.int64)
        v_b[shit] = pvb[shit]
        v_b[is_wr] = vbb
        if n_miss:
            v_b[fillm] = res_len[fillm] + ovh
        used_final = cache.used + int(v_b.sum()) - int(r_b.sum())
        # zero-shortcut counter: promoted zero-count shortcuts and
        # removed zero-count shortcut priors
        z -= int((shit & (pc == 0)).sum())
        z -= int((rem & (kd == 1) & (pc == 0)).sum())
    else:
        # Frozen LRU victim queue, prefetched lazily.  A queue entry
        # the window touches is exact by *when*: touched before the
        # consume moment -> its stamp was refreshed (or it was
        # removed), no longer the LRU minimum, skip it; touched after
        # -> truncate the plan at the touch (prefix stays exact).
        BIG = 1 << 60
        pool_keys = None
        vst = None
        vic_iter = {"est": 0, "vic": None, "vg": None}
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        first_s = np.ones(m, bool)
        first_s[1:] = sk[1:] != sk[:-1]
        ft_su = sk[first_s]
        ft_fi = order[first_s]

        def _grow_victims():
            nonlocal pool_keys, vst
            if pool_keys is None:
                pool_keys = np.flatnonzero(kind_a == 2)
                vst = cache.stamp[pool_keys] if pool_keys.size else None
            if vic_iter["est"] >= pool_keys.size:
                return False
            # first fetch sized to the window (demotion demand rarely
            # exceeds one victim per op); doubled on exhaustion
            est = min(pool_keys.size,
                      max(2 * vic_iter["est"], 32, m // 2))
            if est >= pool_keys.size:
                sel = np.argsort(vst, kind="stable")
            else:
                part = np.argpartition(vst, est)[:est]
                sel = part[np.argsort(vst[part], kind="stable")]
            vic = pool_keys[sel]
            j = np.searchsorted(ft_su, vic)
            j = np.minimum(j, ft_su.size - 1)
            vft = np.where(ft_su[j] == vic, ft_fi[j], BIG)
            vic_iter["est"] = est
            vic_iter["vic"] = vic.tolist()
            vic_iter["vg"] = (len_a[vic] + ovh).tolist()
            vic_iter["vc"] = cnt_a[vic].tolist()
            vic_iter["vft"] = vft.tolist()
            return True

        struct = shit | is_dl | (fills & ~sc_refill & ~eq_refill)
        sidx = np.flatnonzero(struct)
        u = cache.used
        if sidx.size:
            ns = sidx.size
            code = np.full(ns, 1, np.int64)            # fill
            code[shit[sidx]] = 0                       # promote
            code[is_dl[sidx]] = 2                      # delete
            # removal bytes of the prior entry
            rm_b = np.zeros(ns, np.int64)
            kd_s = kd[sidx]
            rm_sel = rem[sidx]
            rm_b[rm_sel & (kd_s == 2)] = pvb[sidx][rm_sel & (kd_s == 2)]
            rm_b[rm_sel & (kd_s == 1)] = sb
            # value bytes each fill/promote would insert
            vbv = np.full(ns, vbb, np.int64)
            vbv[shit[sidx]] = pvb[sidx][shit[sidx]]
            if n_miss:
                mm = fillm[sidx]
                vbv[mm] = res_len[sidx][mm] + ovh
            # duplicate-key fills were evolved under the steady
            # assumption (write keeps its class, miss lands shortcut):
            # the adaptive decision must agree or the plan truncates
            dupset = set(keys[dup_idx].tolist()) \
                if dup_idx is not None else ()
            code_l = code.tolist()
            rm_l = rm_b.tolist()
            vb_l = vbv.tolist()
            pc_s = pc[sidx].tolist()
            kd_sl = kd_s.tolist()
            keys_s = keys[sidx].tolist()
            zfill_l = np.where(
                fillm[sidx] & (res_kind[sidx] == 2) if n_miss
                else np.zeros(ns, bool), 1,
                np.where(is_wr[sidx] & (kd_s == 0), 1, 0)).tolist()
            if _include_refills:
                # transition regime: every fill is assumed to land as
                # a value (the retry's pass-B evolution matches)
                asm_l = (is_wr[sidx] | (fillm[sidx] if n_miss
                                        else False)).tolist()
            else:
                asm_l = (is_wr[sidx] & (kd_s == 2)).tolist()
            dec_l = [0] * ns
            sidx_l = sidx.tolist()
            # batch-advance precompute: maximal uniform runs (promotes,
            # deletes, victim-free fresh shortcut fills) advance in one
            # step, recording exact per-entry occupancy breakpoints
            # vectorized -- sc-refill verification stays exact *inside*
            # an advance, not just at its boundary
            pvp = vbv[code == 0]
            uni_vb = int(pvp[0]) if pvp.size and \
                bool((pvp == pvp[0]).all()) else 0
            uni_net = uni_vb - sb
            ne_max = -(-(uni_vb - sb) // sb) if uni_vb else 0
            pc_sa = pc[sidx]
            in_dup_s = np.isin(keys[sidx], keys[dup_idx]) \
                if dup_idx is not None else np.zeros(ns, bool)
            # fresh write fills (absent prior, not duplicate-evolved)
            # are advance candidates when they land as shortcuts
            sc_adv = np.zeros(ns, bool) if _include_refills else \
                ((code == 1) & is_wr[sidx] & (rm_b == 0) & ~in_dup_s)
            sc_adv_l = sc_adv.tolist()
            code2 = code + np.where(sc_adv, 10, 0)
            bnds = np.append(np.flatnonzero(np.diff(code2)) + 1, ns)
            run_end = bnds[np.searchsorted(bnds, np.arange(ns),
                                           side="right")]
            zdec_np = np.cumsum((code == 0) & (pc_sa == 0))
            rm_cum = np.cumsum(rm_b)
            zrm_np = np.cumsum((kd_s == 1) & (pc_sa == 0))
            vi = 0
            nvic = 0
            vg_l = vc_l = vk_l = vft_l = None
            t = 0
            ns_used = ns
            while t < ns:
                gidx = sidx_l[t]
                if gidx >= cut:
                    ns_used = t
                    break
                c = code_l[t]
                if c == 0 and uni_vb:
                    # batch-advance a run of promotes up to the next
                    # make-space event (all fit, all pass Eq. 1 via the
                    # free-space or zero-shortcut fast path); exact
                    # per-entry breakpoints recorded vectorized
                    k = int((cap + sb - uni_vb - u) // uni_net + 1)
                    e_end = int(run_end[t])
                    if k > e_end - t:
                        k = e_end - t
                    if k >= 2 and sidx_l[t + k - 1] < cut:
                        base = int(zdec_np[t - 1]) if t else 0
                        zdec = int(zdec_np[t + k - 1]) - base
                        if z - zdec >= ne_max:
                            nvv = len(vic_keys_l)
                            bp.extend(zip(
                                sidx_l[t:t + k],
                                (u + uni_net
                                 * np.arange(1, k + 1)).tolist(),
                                (z - (zdec_np[t:t + k]
                                      - base)).tolist(),
                                [nvv] * k))
                            u += k * uni_net
                            z -= zdec
                            t += k
                            continue
                if c == 2:                             # delete run
                    k = int(run_end[t]) - t
                    if k > 1:
                        k = min(k, int(np.searchsorted(
                            sidx, cut, side="left")) - t)
                    if k > 1:
                        base_r = int(rm_cum[t - 1]) if t else 0
                        base_z = int(zrm_np[t - 1]) if t else 0
                        nvv = len(vic_keys_l)
                        bp.extend(zip(
                            sidx_l[t:t + k],
                            (u - (rm_cum[t:t + k] - base_r)).tolist(),
                            (z - (zrm_np[t:t + k] - base_z)).tolist(),
                            [nvv] * k))
                        u -= int(rm_cum[t + k - 1]) - base_r
                        z -= int(zrm_np[t + k - 1]) - base_z
                        t += k
                        continue
                    u -= rm_l[t]
                    if kd_sl[t] == 1 and pc_s[t] == 0:
                        z -= 1
                    bp.append((gidx, u, z, len(vic_keys_l)))
                    t += 1
                    continue
                if c == 1 and sc_adv_l[t] and u + vb_l[t] > cap:
                    # batch-advance a run of fresh write fills that all
                    # land as shortcuts with free shortcut room (no
                    # victims): occupancy grows by exactly sb per entry,
                    # so the value-vs-shortcut class is stable over the
                    # whole run
                    k = min(int(run_end[t]) - t, int((cap - u) // sb))
                    if k > 1:
                        k = min(k, int(np.searchsorted(
                            sidx, cut, side="left")) - t)
                    if k > 1:
                        nvv = len(vic_keys_l)
                        bp.extend(zip(
                            sidx_l[t:t + k],
                            (u + sb * np.arange(1, k + 1)).tolist(),
                            (z + np.arange(1, k + 1)).tolist(),
                            [nvv] * k))
                        u += sb * k
                        z += k
                        t += k
                        continue
                # entry snapshot: an entry that cannot complete (Eq. 1
                # exact path, class mismatch, dry victim pool) must
                # leave no trace -- the cut excludes it from the plan
                u0, z0, cut0 = u, z, cut
                nv0 = len(vic_keys_l)
                vb = vb_l[t]
                abort = False
                if c == 0:                             # promote (Eq. 1)
                    if pc_s[t] == 0:
                        z -= 1
                    free = cap - u
                    need = vb - sb
                    if free < need and z < -((free - need) // sb):
                        abort = True      # exact Eq. 1 path: cut here
                    else:
                        u -= sb
                else:                                  # fill
                    u -= rm_l[t]
                    if u + vb <= cap:                  # lands as value
                        if keys_s[t] in dupset and not asm_l[t]:
                            u, z = u0, z0
                            ns_used = t
                            cut = gidx
                            break
                        dec_l[t] = 1
                        # removing a zero-count shortcut prior
                        if kd_sl[t] == 1 and pc_s[t] == 0:
                            z -= 1
                        u += vb
                        bp.append((gidx, u, z, len(vic_keys_l)))
                        t += 1
                        continue
                    if keys_s[t] in dupset and asm_l[t]:
                        abort = True      # class mismatch: cut here
                    else:
                        z += zfill_l[t]
                        vb = sb           # shortcut entry
                if not abort and u + vb > cap:
                    while u + vb > cap:
                        if vi >= nvic:
                            if not _grow_victims():
                                abort = True           # pool dry
                                break
                            vk_l = vic_iter["vic"]
                            vg_l = vic_iter["vg"]
                            vc_l = vic_iter["vc"]
                            vft_l = vic_iter["vft"]
                            nvic = len(vk_l)
                            continue
                        ft = vft_l[vi]
                        if ft <= gidx:
                            vi += 1       # refreshed/removed: not LRU
                            continue
                        if ft < cut:
                            # victim first touched later in the window:
                            # truncate the plan there
                            cut = ft
                        g = vg_l[vi]
                        u -= g
                        vic_keys_l.append(vk_l[vi])
                        vic_cnt_l.append(vc_l[vi])
                        vi += 1
                        if u + sb + vb <= cap:
                            u += sb
                            reinsert_l.append(True)
                            if vc_l[vi - 1] == 0:
                                z += 1
                        else:
                            reinsert_l.append(False)
                if abort:
                    # roll the partial entry back and cut before it
                    u, z, cut = u0, z0, cut0
                    del vic_keys_l[nv0:]
                    del vic_cnt_l[nv0:]
                    del reinsert_l[nv0:]
                    ns_used = t
                    cut = min(cut, gidx)
                    break
                u += vb
                bp.append((gidx, u, z, len(vic_keys_l)))
                t += 1
        # verify the excluded shortcut->shortcut refills against the
        # loop's occupancy breakpoints: at each one, a value must
        # genuinely not have fit (otherwise the reference would have
        # promoted the refill to a value entry).  A failing refill
        # does not kill the plan -- it cuts it back to the last sound
        # breakpoint before the failure (warm-up windows transition
        # through exactly this regime).
        if bp:
            bpp, bpu, bpz, bpn = (np.asarray(x, np.int64)
                                  for x in zip(*bp))
        else:
            bpp = bpu = bpz = bpn = np.empty(0, np.int64)
        if sc_refill.any():
            ridx = np.flatnonzero(sc_refill)
            ridx = ridx[ridx < cut]
            if ridx.size:
                if bpp.size:
                    at = np.searchsorted(bpp, ridx, side="left")
                    u_at = np.where(at > 0,
                                    bpu[np.maximum(at - 1, 0)],
                                    cache.used)
                else:
                    u_at = np.full(ridx.size, cache.used, np.int64)
                bad = ridx[~(u_at - sb + vbb > cap)]
                if bad.size:
                    fb = int(bad[0])
                    j = int(np.searchsorted(bpp, fb, side="left"))
                    if j == 0:
                        # no structural entry completed before the
                        # failure (every completed entry -- including
                        # batch-advanced ones -- records exactly one
                        # breakpoint): the window-initial state is the
                        # last sound state
                        cut = min(cut, fb)
                        u = cache.used
                        z = cache._zero_shortcuts
                        nvk = 0
                    else:
                        cut = min(cut, int(bpp[j - 1]) + 1)
                        u = int(bpu[j - 1])
                        z = int(bpz[j - 1])
                        nvk = int(bpn[j - 1])
                    vic_keys_l = vic_keys_l[:nvk]
                    vic_cnt_l = vic_cnt_l[:nvk]
                    reinsert_l = reinsert_l[:nvk]
                    if cut < MIN_PLAN_OPS:
                        # the window opens in the refill-transition
                        # regime: plan refills adaptively instead
                        return plan_dac_window(
                            cache, kn, keys, opk, pos, wplan,
                            probe_map, dkeys, dbuckets, pool,
                            value_bytes, collect,
                            _include_refills=True)
        if cut < MIN_PLAN_OPS:
            return None
        if sidx.size:
            ns_used = int(np.searchsorted(sidx, cut, side="left"))
            dec_val[sidx[:ns_used]] = \
                np.asarray(dec_l[:ns_used], bool)
        used_final = u
        if cut < m:
            # truncate every per-op array to the proven prefix
            m = cut
            keys = keys[:m]
            opk = opk[:m]
            pos = pos[:m]
            kd = kd[:m]
            pc = pc[:m]
            plen = plen[:m]
            pvb = pvb[:m]
            is_rd = is_rd[:m]
            is_wr = is_wr[:m]
            is_dl = is_dl[:m]
            rem = rem[:m]
            vhit = vhit[:m]
            shit = shit[:m]
            miss = miss[:m]
            fillm = fillm[:m]
            fills = fills[:m]
            dec_val = dec_val[:m]
            sc_refill = sc_refill[:m]
            eq_refill = eq_refill[:m]
            keys_l = keys_l[:m]
            if n_miss:
                res_kind = res_kind[:m]
                res_ptr = res_ptr[:m]
                res_len = res_len[:m]
                res_probes = res_probes[:m]
                n_miss = int(miss.sum())
                if not n_miss:
                    fillm = np.zeros(m, bool)
        dec_val[eq_refill] = True
    to_val = shit | (fills & dec_val)
    to_sc = fills & ~dec_val
    n_promo = int(shit.sum())

    wr_sc = is_wr & to_sc
    post_kind = np.where(to_val, 2,
                         np.where(to_sc, 1,
                                  np.where(is_dl, 0, kd))) \
        .astype(np.int8)
    post_cnt = pc.copy()
    post_cnt[vhit | shit] += 1
    if n_miss:
        post_cnt[miss & (res_kind == 1)] = 1
        post_cnt[miss & (res_kind == 2)] = 0

    plan = DacWindowPlan()
    last = _last_occurrence(keys)
    plan.kk_keys = keys[last]
    plan.kk_kind = post_kind[last]
    plan.kk_cnt = post_cnt[last]

    fidx = np.flatnonzero(fills)
    if fidx.size:
        fptr = np.empty(fidx.size, np.int64)
        flen = np.empty(fidx.size, np.int64)
        wsub = is_wr[fidx]
        if wsub.any():
            ranks = wplan.wrank[pos[fidx[wsub]]]
            fptr[wsub] = wplan.ptrs[ranks]
            flen[wsub] = value_bytes
        if (~wsub).any():
            msub = fidx[~wsub]
            fptr[~wsub] = res_ptr[msub]
            flen[~wsub] = res_len[msub]
        flast = _last_occurrence(keys[fidx])
        plan.fill_keys = keys[fidx][flast]
        plan.fill_ptr = fptr[flast]
        plan.fill_len = flen[flast]
    else:
        plan.fill_keys = np.empty(0, np.int64)
        plan.fill_ptr = np.empty(0, np.int64)
        plan.fill_len = np.empty(0, np.int64)

    # clock/stamps: value hits, promotes and value fills bump the clock
    bump = vhit | shit | to_val
    bump_idx = np.flatnonzero(bump)
    clocks = cache._clock + np.arange(bump_idx.size, dtype=np.int64)
    plan.clock_delta = int(bump_idx.size)
    blast = _last_occurrence(keys[bump_idx]) if bump_idx.size else None
    if blast is not None:
        plan.stp_keys = keys[bump_idx][blast]
        plan.stp_vals = clocks[blast]
    else:
        plan.stp_keys = np.empty(0, np.int64)
        plan.stp_vals = np.empty(0, np.int64)
    # LRU records: promotes + value fills (ascending clocks => extend)
    rec = (shit | to_val)[bump_idx] if bump_idx.size else None
    plan.lru_records = list(zip(clocks[rec].tolist(),
                                keys[bump_idx][rec].tolist())) \
        if rec is not None else []

    # LFU pushes: entries that need a live exact record -- fresh
    # shortcut fills (absent/value prior) and re-inserted victims.  A
    # shortcut->shortcut refill keeps its count, so the existing
    # record stays exact and no push is needed.
    lfu: list = []
    fresh_sc = to_sc & (kd != 1)
    if fresh_sc.any():
        fi = np.flatnonzero(fresh_sc)
        lfu.extend(zip(post_cnt[fi].tolist(), keys[fi].tolist()))
    for t, kk in enumerate(vic_keys_l):
        if reinsert_l[t]:
            lfu.append((vic_cnt_l[t], kk))
    plan.lfu_push = lfu

    # histogram updates (clamped slots)
    inc = []
    dec = []
    c0c = np.minimum(pc, hmax)
    if n_promo:
        dec.append(c0c[shit])             # net effect of hit + promote
    rem_other = rem & (kd == 1) & ~(wr_sc & (kd == 1))
    if rem_other.any():
        dec.append(c0c[rem_other])
    if fresh_sc.any():
        inc.append(np.minimum(post_cnt[fresh_sc], hmax))
    if vic_keys_l:
        ri = np.asarray(reinsert_l, bool)
        if ri.any():
            inc.append(np.minimum(
                np.asarray(vic_cnt_l, np.int64)[ri], hmax))
    plan.hist_inc = np.concatenate(inc) if inc else np.empty(0, np.int64)
    plan.hist_dec = np.concatenate(dec) if dec else np.empty(0, np.int64)

    plan.victims = vic_keys_l
    plan.victim_reinsert = reinsert_l
    plan.victim_counts = vic_cnt_l
    nre = sum(reinsert_l)
    plan.used_final = used_final
    # occupancy: per-op transitions telescope (kd is each op's exact
    # prior kind, post_kind its exact post kind), so summing per-op
    # deltas gives the net change even across repeated keys.
    pk2 = post_kind == 2
    pk1 = post_kind == 1
    dnv = (int((pk2 & (kd != 2)).sum())
           - int(((kd == 2) & ~pk2).sum()) - len(vic_keys_l))
    dns = (int((pk1 & (kd != 1)).sum())
           - int(((kd == 1) & ~pk1).sum()) + nre)
    plan.nvals_final = cache._nvals + dnv
    plan.nshort_final = cache._nshort + dns
    plan.zero_final = z

    # stats
    plan.value_hits = int(vhit.sum())
    plan.shortcut_hits = n_promo
    plan.misses = n_miss
    plan.promotions = n_promo
    plan.demotions = len(vic_keys_l)
    plan.ops = m
    plan.reads = int(is_rd.sum())
    plan.writes = m - plan.reads
    rts = float(n_promo)
    if n_miss:
        found = miss & (res_kind == 1)
        rts += float(res_probes[miss].sum()) + float(found.sum())
        plan.ema_rts = (res_probes[found] + 1.0).tolist()
    else:
        plan.ema_rts = []
    wd = np.flatnonzero(rem)
    if wd.size:
        rts += float(wplan.rts[wplan.wrank[pos[wd]]].sum())
    plan.rts = rts

    # segcache effects: writes put, deletes pop.  Put/pop order per
    # key (and pop/trim interleaving) matters, so any window with
    # deletes replays its segcache sequence per op; pure-put windows
    # use the LRU invariant (final state = most recent cap puts).
    has_dl = bool(is_dl.any())
    wsel = np.flatnonzero(is_wr)
    if has_dl:
        seq = []
        for i in np.flatnonzero(rem).tolist():
            if opk[i] == 2:
                seq.append((keys_l[i], None))
            else:
                seq.append((keys_l[i],
                            int(wplan.ptrs[wplan.wrank[pos[i]]])))
        plan.seg_replay = seq
        plan.seg_puts = None
    else:
        plan.seg_replay = None
        if wsel.size:
            ranks = wplan.wrank[pos[wsel]]
            plan.seg_puts = (keys[wsel].tolist(),
                             wplan.ptrs[ranks].tolist())
        else:
            plan.seg_puts = None

    # the device twin's inputs: the regime the plan was made in, and
    # each planned op's landing (a promote, or a fill as a value)
    plan.include_refills = _include_refills
    plan.to_val = to_val
    plan.out_vals = _collect_values(
        cache, pool, keys_l, opk, pos, miss, res_kind, res_ptr,
        wplan, m) if collect else None
    return plan


def _collect_values(cache, pool, keys_l, opk, pos, miss, res_kind,
                    res_ptr, wplan, m):
    """Exact per-read results (only built under collect_values)."""
    heap = pool.heap_val
    out = []
    cur: dict = {}
    opk_l = opk.tolist()
    pos_l = pos.tolist()
    miss_l = miss.tolist()
    ptr0 = cache.ptr[np.asarray(keys_l)].tolist()
    res_k = res_kind.tolist() if res_kind is not None else None
    res_p = res_ptr.tolist() if res_ptr is not None else None
    wrank = wplan.wrank_l
    wptrs = wplan.ptrs_l
    for j in range(m):
        k = keys_l[j]
        o = opk_l[j]
        if o == 1:
            cur[k] = wptrs[wrank[pos_l[j]]]
        elif o == 2:
            cur[k] = -1
        else:
            if miss_l[j]:
                p = res_p[j] if res_k[j] else -1
                if p >= 0:
                    cur[k] = p
            else:
                p = cur.get(k)
                if p is None:
                    p = ptr0[j]
            out.append((pos_l[j], heap[p] if p >= 0 else None))
    return out


def plan_static_window(cache, kn, keys, opk, pos, wplan, probe_map,
                       dkeys, dbuckets, pool, value_bytes, collect):
    """Plan one ArrayStaticCache window (fig. 3 static-split planes).

    Simpler machine than DAC: no counts, no promotions; each fill's
    side is statically determined by its size vs the side capacity, and
    each side evicts its own LRU tail.  Exact under the same victim
    conditions (frozen victim queue untouched by the window)."""
    m = keys.shape[0]
    if m < MIN_PLAN_OPS:
        return None
    ovh = VALUE_OVERHEAD_BYTES
    sb = SHORTCUT_BYTES
    vcap = cache.value_cap
    scap = cache.shortcut_cap
    kind_a = cache.kind
    len_a = cache.length
    segd = kn.segcache
    kd = kind_a[keys].astype(np.int64)
    is_rd = opk == 0
    is_wr = opk == 1
    is_dl = opk == 2
    keys_l = keys.tolist()

    # repeated pure hits keep their entry class in the static planes
    # (no promotions), so only groups with writes/deletes or an absent
    # first kind need the exact evolution loop
    dup_idx, _, _ = _dup_split(keys, opk, kd, (0,))
    seg_dead: set = set()
    res_cache: dict = {}
    if dup_idx is not None:
        kd = kd.copy()
        kd_l = kd.tolist()
        plen_l = np.where(kd == 0, 0, len_a[keys]).tolist()
        state: dict = {}
        for i, o in zip(dup_idx.tolist(), opk[dup_idx].tolist()):
            k = keys_l[i]
            st = state.get(k)
            if st is None:
                st = [kd_l[i], plen_l[i]]
            else:
                kd_l[i], plen_l[i] = st
            if o == 0:
                if st[0] == 0:
                    r = _resolve_miss(k, int(pos[i]), segd, seg_dead,
                                      probe_map, dkeys, dbuckets, pool)
                    res_cache[i] = r
                    if r[0]:
                        st[0] = 2 if r[2] + ovh <= vcap else 1
                        st[1] = r[2]
            elif o == 1:
                st[0] = 2 if value_bytes + ovh <= vcap else 1
                st[1] = value_bytes
                seg_dead.discard(k)
            else:
                st[0], st[1] = 0, 0
                seg_dead.add(k)
            state[k] = st
        kd = np.asarray(kd_l, np.int64)
        plen = np.asarray(plen_l, np.int64)
    else:
        plen = np.where(kd == 0, 0, len_a[keys])

    vhit = is_rd & (kd == 2)
    shit = is_rd & (kd == 1)
    miss = is_rd & (kd == 0)
    n_miss = int(miss.sum())
    res_kind = res_ptr = res_len = res_probes = None
    if n_miss:
        if len(segd) + int(is_wr.sum()) > kn.segcache_cap:
            for i in np.flatnonzero(miss).tolist():
                if keys_l[i] in segd:
                    return None
        res_kind = np.zeros(m, np.int64)
        res_ptr = np.full(m, -1, np.int64)
        res_len = np.zeros(m, np.int64)
        res_probes = np.zeros(m, np.float64)
        for i in np.flatnonzero(miss).tolist():
            r = res_cache.get(i)
            if r is None:
                r = _resolve_miss(keys_l[i], int(pos[i]), segd, seg_dead,
                                  probe_map, dkeys, dbuckets, pool)
            res_kind[i], res_ptr[i], res_len[i], res_probes[i] = r
        fillm = miss & (res_kind > 0)
    else:
        fillm = np.zeros(m, bool)

    # fill sides (static decision per op)
    fills = is_wr | fillm
    fill_len_op = np.where(is_wr, value_bytes, res_len
                           if n_miss else 0)
    fill_vb = fill_len_op + ovh
    fill_val = fills & (fill_vb <= vcap)
    fill_sc = fills & ~fill_val
    # degenerate shortcut side that cannot hold one entry: the library
    # path silently skips the insert; replay those windows.
    if fill_sc.any() and sb > scap:
        return None

    # per-side byte trajectories (invalidate prior, then insert)
    pvb = plen + ovh
    dv = np.zeros(m, np.int64)
    ds = np.zeros(m, np.int64)
    remk = (is_wr | is_dl)
    sel = remk & (kd == 2)
    dv[sel] -= pvb[sel]
    ds[remk & (kd == 1)] -= sb
    dv[fill_val] += fill_vb[fill_val]
    ds[fill_sc] += sb
    Av = cache.value_used + np.cumsum(dv)
    As = cache.shortcut_used + np.cumsum(ds)

    vvic_l: list = []
    svic_l: list = []
    for side, (traj, side_cap, side_kind) in enumerate(
            ((Av, vcap, 2), (As, scap, 1))):
        demand = int(traj.max()) - side_cap
        if demand <= 0:
            continue
        pool_keys = np.flatnonzero(kind_a == side_kind)
        if pool_keys.size == 0:
            return None
        vst = cache.stamp[pool_keys]
        gb = (len_a[pool_keys] + ovh) if side_kind == 2 else None
        order = np.argsort(vst, kind="stable")
        vic = pool_keys[order]
        if side_kind == 2:
            freed = np.cumsum(gb[order])
        else:
            freed = sb * np.arange(1, vic.size + 1, dtype=np.int64)
        t = int(np.searchsorted(freed, demand, side="left")) + 1
        if t > vic.size:
            return None
        vic = vic[:t]
        if np.isin(vic, keys).any():
            return None
        if side_kind == 2:
            vvic_l = vic.tolist()
        else:
            svic_l = vic.tolist()
    # NOTE: per-op eviction interleaving does not matter here: each
    # side's victims are consumed in frozen LRU order and eviction
    # frees monotonically accumulate; verifying final demand per side
    # is enough because side trajectories are independent and each
    # insert's while-loop stops exactly at its cumulative demand.

    plan = StaticWindowPlan()
    post_kind = np.where(fill_val, 2,
                         np.where(fill_sc, 1,
                                  np.where(is_dl, 0, kd))) \
        .astype(np.int8)
    last = _last_occurrence(keys)
    plan.kk_keys = keys[last]
    plan.kk_kind = post_kind[last]
    fidx = np.flatnonzero(fills)
    if fidx.size:
        fptr = np.empty(fidx.size, np.int64)
        wsub = is_wr[fidx]
        if wsub.any():
            fptr[wsub] = wplan.ptrs[wplan.wrank[pos[fidx[wsub]]]]
        if (~wsub).any():
            fptr[~wsub] = res_ptr[fidx[~wsub]]
        flast = _last_occurrence(keys[fidx])
        plan.fill_keys = keys[fidx][flast]
        plan.fill_ptr = fptr[flast]
        plan.fill_len = fill_len_op[fidx][flast]
    else:
        plan.fill_keys = np.empty(0, np.int64)
        plan.fill_ptr = np.empty(0, np.int64)
        plan.fill_len = np.empty(0, np.int64)

    bump = vhit | shit | fills
    bump_idx = np.flatnonzero(bump)
    clocks = cache._clock + np.arange(bump_idx.size, dtype=np.int64)
    plan.clock_delta = int(bump_idx.size)
    if bump_idx.size:
        blast = _last_occurrence(keys[bump_idx])
        plan.stp_keys = keys[bump_idx][blast]
        plan.stp_vals = clocks[blast]
    else:
        plan.stp_keys = np.empty(0, np.int64)
        plan.stp_vals = np.empty(0, np.int64)
    vrec = fill_val[bump_idx] if bump_idx.size else None
    srec = fill_sc[bump_idx] if bump_idx.size else None
    plan.vlru_records = list(zip(clocks[vrec].tolist(),
                                 keys[bump_idx][vrec].tolist())) \
        if vrec is not None else []
    plan.slru_records = list(zip(clocks[srec].tolist(),
                                 keys[bump_idx][srec].tolist())) \
        if srec is not None else []
    plan.vvic = vvic_l
    plan.svic = svic_l
    plan.vused_final = int(Av[-1]) - (int((len_a[vvic_l] + ovh).sum())
                                      if vvic_l else 0)
    plan.sused_final = int(As[-1]) - sb * len(svic_l)
    # per-op transitions telescope across repeated keys (see DAC plan)
    pk2 = post_kind == 2
    pk1 = post_kind == 1
    dnv = (int((pk2 & (kd != 2)).sum())
           - int(((kd == 2) & ~pk2).sum()) - len(vvic_l))
    dns = (int((pk1 & (kd != 1)).sum())
           - int(((kd == 1) & ~pk1).sum()) - len(svic_l))
    plan.nvals_final = cache._nvals + dnv
    plan.nshort_final = cache._nshort + dns

    plan.value_hits = int(vhit.sum())
    plan.shortcut_hits = int(shit.sum())
    plan.misses = n_miss
    plan.evictions = len(vvic_l) + len(svic_l)
    plan.ops = m
    plan.reads = int(is_rd.sum())
    plan.writes = m - plan.reads
    rts = float(plan.shortcut_hits)
    if n_miss:
        found = miss & (res_kind == 1)
        rts += float(res_probes[miss].sum()) + float(found.sum())
    plan.ema_rts = []
    wd = np.flatnonzero(remk)
    if wd.size:
        rts += float(wplan.rts[wplan.wrank[pos[wd]]].sum())
    plan.rts = rts

    # segcache effects: writes put, deletes pop.  Put/pop order per
    # key (and pop/trim interleaving) matters, so any window with
    # deletes replays its segcache sequence per op; pure-put windows
    # use the LRU invariant (final state = most recent cap puts).
    has_dl = bool(is_dl.any())
    wsel = np.flatnonzero(is_wr)
    if has_dl:
        seq = []
        for i in np.flatnonzero(remk).tolist():
            if opk[i] == 2:
                seq.append((keys_l[i], None))
            else:
                seq.append((keys_l[i],
                            int(wplan.ptrs[wplan.wrank[pos[i]]])))
        plan.seg_replay = seq
        plan.seg_puts = None
    else:
        plan.seg_replay = None
        if wsel.size:
            plan.seg_puts = (keys[wsel].tolist(),
                             wplan.ptrs[wplan.wrank[pos[wsel]]]
                             .tolist())
        else:
            plan.seg_puts = None

    plan.out_vals = _collect_values(
        cache, pool, keys_l, opk, pos, miss, res_kind, res_ptr,
        wplan, m) if collect else None
    return plan


# ===========================================================================
# Planned merge plane: the staged DPM-processor merge path
# (DPMPool.merge_entries_batch -> NumpyCLHT inserts) as a plan/apply
# split, mirroring the DacWindowPlan contract.  DINOMO's log-free
# P-CLHT indexing (paper Sec. 4.4) evolves deterministically given the
# chain-walk results, so one vectorized sweep over a flush's merge
# entries resolves grouped bucket targets, old-pointer supersession,
# indirect-pointer filtering and per-bucket slot assignment as arrays.
# The plan self-truncates (``plan.ops``) at the first entry whose
# exactness it cannot prove cheaply -- a tombstone (delete semantics),
# a bucket whose chain must grow (overflow allocation + nxt relink),
# or the per-epoch merge allowance running out (the budget clamps the
# plan itself, never a scalar replay) -- and the caller replays that
# entry through the exact scalar machinery before re-planning.
# ===========================================================================

# Merge windows below this size replay scalar: the plan's fixed numpy
# overhead (~15 vector ops) would dominate.
MIN_MERGE_PLAN_OPS = 8

# mirrors clht.MAX_CHAIN / clht.SLOTS semantics; clht.py imports this
# module (apply_merge_plan), so the constant lives here and clht.py
# asserts agreement at import time.
MERGE_MAX_CHAIN = 8


class MergeWindowPlan:
    """One merge window's bulk index decisions (covers ``ops`` entries,
    log order, tombstone-free, every covered entry provably exact)."""

    __slots__ = (
        "ops",                      # entries covered (self-truncated)
        "old",                      # per-entry superseded ptr (-1 fresh)
        "n_index",                  # live (non-indirect) entries
        "n_new",                    # fresh slot claims
        "upd_rows", "upd_slots", "upd_ptrs",    # in-place final-ptr
        "new_rows", "new_slots", "new_keys", "new_ptrs",   # slot claims
        "inv_ptrs",                 # value ptrs superseded by the window
        "live_keys",                # unique live keys (dirty tracking)
    )


def _merge_locate(tk, tn, keys, b0):
    """Vectorized chain walk locating each key's (row, slot) over raw
    table arrays; mirrors the scalar insert walk's match search."""
    n = keys.shape[0]
    cur = b0.copy()
    rows = np.zeros(n, np.int64)
    slots = np.zeros(n, np.int64)
    found = np.zeros(n, bool)
    active = np.ones(n, bool)
    for _ in range(MERGE_MAX_CHAIN):
        if not active.any():
            break
        rk = tk[cur]
        hit = (rk == keys[:, None]) & active[:, None]
        hit_any = hit.any(axis=1)
        if hit_any.any():
            s = np.argmax(hit, axis=1)
            rows[hit_any] = cur[hit_any]
            slots[hit_any] = s[hit_any]
            found |= hit_any
        nxt = tn[cur]
        active = active & ~hit_any & (nxt != -1)
        cur = np.where(active, nxt, cur)
    return rows, slots, found


def _merge_chain_empties(tk, tn, ub):
    """Empty (row, slot) positions along each bucket's chain, in the
    exact order the scalar insert sequence would claim them (chain
    position first, then ascending slot).  Returns (rows, slots, bidx)
    grouped by bucket index into ``ub``."""
    parts_b: list = []
    parts_r: list = []
    parts_s: list = []
    cur = ub.copy()
    active = np.ones(ub.size, bool)
    for _ in range(MERGE_MAX_CHAIN):
        em = (tk[cur] == -1) & active[:, None]
        if em.any():
            bi, sl = np.nonzero(em)
            parts_b.append(bi)
            parts_r.append(cur[bi])
            parts_s.append(sl.astype(np.int64))
        nxt = tn[cur]
        active = active & (nxt != -1)
        if not active.any():
            break
        cur = np.where(active, nxt, cur)
    if not parts_b:
        z = np.empty(0, np.int64)
        return z, z, z
    eb = np.concatenate(parts_b)
    er = np.concatenate(parts_r)
    es = np.concatenate(parts_s)
    o = np.argsort(eb, kind="stable")   # group by bucket, keep chain order
    return er[o], es[o], eb[o]


def _merge_bucket_batch(keys, num_buckets):
    """Vectorized primary-bucket hash (mirrors NumpyCLHT._bucket)."""
    m = np.uint32(0xFFFFFFFF)
    x = (np.asarray(keys, dtype=np.int64)
         & np.int64(0xFFFFFFFF)).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = (x ^ (x >> np.uint32(16))) & m
    return (x & np.uint32(num_buckets - 1)).astype(np.int64)


def plan_merge_window(index, keys, ptrs, indirect_keys=None,
                      max_ops=None, tombstones=True):
    """Plan one merge window over ``index`` (anything exposing numpy
    ``keys``/``ptrs``/``nxt`` arrays + ``num_buckets``: NumpyCLHT, or a
    host view of the card's CLHT, ``kernels.log_merge.ops.
    _HostTableView``).  keys/ptrs are the window's (key, ptr)
    entries in log order; ``indirect_keys`` is the sorted replicated-key
    array (entries for those keys are filtered -- they published via CAS
    and must not touch the index); ``max_ops`` is the remaining
    per-epoch merge allowance (clamps the plan itself).

    Returns a MergeWindowPlan covering the first ``plan.ops`` entries,
    or None when the window head cannot be planned (caller replays one
    entry scalar and re-plans).  Every covered decision is identical to
    the scalar insert sequence: same superseded pointers (within-window
    duplicate chains included), same slot placement (first empty along
    the chain, claims in first-occurrence order), same version/size
    evolution.  Truncation points: a tombstone, a key whose chain would
    have to grow (no empty left along it), or the allowance."""
    n = keys.shape[0]
    if max_ops is not None and max_ops < n:
        n = int(max_ops)
        keys = keys[:n]
        ptrs = ptrs[:n]
    if n < MIN_MERGE_PLAN_OPS:
        return None
    if tombstones:
        tpos = np.flatnonzero(keys < 0)
        if tpos.size:
            n = int(tpos[0])
            if n < MIN_MERGE_PLAN_OPS:
                return None
            keys = keys[:n]
            ptrs = ptrs[:n]
    tk = index.keys
    tp = index.ptrs
    tn = index.nxt
    # indirect-pointer filtering: one vectorized membership pass
    # replaces the per-entry dict check
    if indirect_keys is not None and indirect_keys.size:
        skip = np.isin(keys, indirect_keys)
        li = np.flatnonzero(~skip)
        lk = keys[li]
        lp = ptrs[li]
    else:
        li = None
        lk = keys
        lp = ptrs
    nl = lk.shape[0]
    old = np.full(n, -1, np.int64)
    plan = MergeWindowPlan()
    plan.ops = n
    plan.old = old
    plan.n_index = nl
    e = np.empty(0, np.int64)
    if nl == 0:
        plan.n_new = 0
        plan.upd_rows = plan.upd_slots = plan.upd_ptrs = e
        plan.new_rows = plan.new_slots = e
        plan.new_keys = plan.new_ptrs = e
        plan.inv_ptrs = e
        plan.live_keys = e
        return plan
    # ---- group by key: last-wins final ptr, per-entry supersession ---
    order = np.argsort(lk, kind="stable")
    sk = lk[order]
    sp = lp[order]
    first = np.ones(nl, bool)
    first[1:] = sk[1:] != sk[:-1]
    last = np.ones(nl, bool)
    last[:-1] = first[1:]
    uk = sk[first]
    ufinal = sp[last]
    gpos = li[order] if li is not None else order
    ufirst = gpos[first]                 # global first-occurrence pos
    # one chain walk resolves the pre-window mapping (old ptrs) and the
    # in-place update targets for present keys
    b0 = _merge_bucket_batch(uk, index.num_buckets)
    rows, slots, found = _merge_locate(tk, tn, uk, b0)
    ucur = np.where(found, tp[rows, slots], -1)
    prev = np.empty(nl, np.int64)
    prev[first] = ucur
    if nl > 1:
        dup = ~first
        prev[dup] = sp[:-1][dup[1:]]
    old[gpos] = prev
    # ---- per-bucket slot assignment for absent keys ------------------
    ab = ~found
    if ab.any():
        ak = uk[ab]
        afirst = ufirst[ab]
        ub, binv = np.unique(b0[ab], return_inverse=True)
        er, es, eb = _merge_chain_empties(tk, tn, ub)
        cnt = np.bincount(eb, minlength=ub.size)
        off = np.concatenate(([0], np.cumsum(cnt)[:-1]))
        # rank of each absent key within its bucket, in first-occurrence
        # order (the order the scalar sequence claims empties in)
        ordk = np.lexsort((afirst, binv))
        gb = binv[ordk]
        gfirst = np.ones(ak.size, bool)
        gfirst[1:] = gb[1:] != gb[:-1]
        gstart = np.flatnonzero(gfirst)
        gid = np.cumsum(gfirst) - 1
        rank = np.empty(ak.size, np.int64)
        rank[ordk] = np.arange(ak.size, dtype=np.int64) - gstart[gid]
        fits = rank < cnt[binv]
        if not fits.all():
            # a contested/overflowing bucket breaks provable exactness
            # (the scalar walk would allocate an overflow bucket and
            # relink the chain): truncate at the first such key's first
            # occurrence and re-plan the prefix
            cut = int(afirst[~fits].min())
            if cut < MIN_MERGE_PLAN_OPS:
                return None
            return plan_merge_window(index, keys[:cut], ptrs[:cut],
                                     indirect_keys, None, False)
        eidx = off[binv] + rank
        plan.new_rows = er[eidx]
        plan.new_slots = es[eidx]
        plan.new_keys = ak
        plan.new_ptrs = ufinal[ab]
        plan.n_new = int(ab.sum())
    else:
        plan.new_rows = plan.new_slots = e
        plan.new_keys = plan.new_ptrs = e
        plan.n_new = 0
    upd = found
    plan.upd_rows = rows[upd]
    plan.upd_slots = slots[upd]
    plan.upd_ptrs = ufinal[upd]
    # one-pass supersession: per-entry superseded ptrs (within-window
    # duplicate chains included), unchanged re-inserts excluded
    plan.inv_ptrs = old[(old >= 0) & (old != ptrs)]
    plan.live_keys = uk
    return plan


class CloverReadPlan:
    """One Clover KN's planned read-batch cache transitions."""

    __slots__ = ("fill_keys", "fill_ver", "stp_keys", "stp_vals",
                 "lru_records", "clock_delta", "n_final",
                 "shortcut_hits", "misses", "rts", "out_ptr", "hit")


def plan_clover_reads(cache, keys, cur_vers, found):
    """Plan one Clover KN's slice of a read-only batch.

    keys: the KN's read keys in op order; cur_vers: each key's version
    counter; found: whether the index resolves the key.  Returns a
    CloverReadPlan, or None when the batch could evict (the planned
    fill set would overflow cap_entries -- the per-op path then keeps
    its exact LRU eviction semantics).

    Exact per the per-op path: every read of a resolvable key fills
    (key, cur); a key is a hit from its first fill on, with staleness
    cur - cached version; membership never shrinks because the plan
    guarantees no eviction."""
    m = keys.shape[0]
    if m < MIN_PLAN_OPS:
        return None
    cache._ensure(int(keys.max()))
    present0 = cache.present[keys]
    ver0 = cache.ver[keys]
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first_s = np.ones(m, bool)
    first_s[1:] = sk[1:] != sk[:-1]
    fo = np.zeros(m, bool)
    fo[order[first_s]] = True
    # group-level membership/fill facts propagate to later occurrences
    gid = np.cumsum(first_s) - 1
    g_pres = present0[order[first_s]]
    g_found = found[order[first_s]]
    newly = int((g_found & ~g_pres).sum())
    if cache._n + newly > cache.cap_entries:
        return None                       # evictions possible: replay
    op_gpres = np.empty(m, bool)
    op_gpres[order] = g_pres[gid]
    op_gfound = np.empty(m, bool)
    op_gfound[order] = g_found[gid]
    hit = np.where(fo, present0, op_gpres | op_gfound)
    # cached version at op time: later touches of a filled key read the
    # version the first fill wrote (= its own cur; versions are frozen
    # in a read-only batch)
    cached = np.where(~fo & op_gfound, cur_vers, ver0)
    stale = np.where(hit & (cur_vers > cached), cur_vers - cached, 0)
    rts = (np.where(hit, 0.0, 1.0)
           + np.where(found, 2.0 + stale, 0.0))
    plan = CloverReadPlan()
    bump = hit.astype(np.int64) + found
    clocks = cache._clock + np.cumsum(bump) - 1   # clock after op's
    plan.clock_delta = int(bump.sum())            # last bump
    fsel = np.flatnonzero(found)
    if fsel.size:
        flast = _last_occurrence(keys[fsel])
        plan.fill_keys = keys[fsel][flast]
        plan.fill_ver = cur_vers[fsel][flast]
        # fill records are the per-key last fill clocks; every fill
        # pushes in the per-op path, one valid record per key suffices
        fclk = clocks[fsel][flast]
        ordrec = np.argsort(fclk, kind="stable")
        plan.lru_records = list(zip(fclk[ordrec].tolist(),
                                    plan.fill_keys[ordrec].tolist()))
    else:
        plan.fill_keys = np.empty(0, np.int64)
        plan.fill_ver = np.empty(0, np.int64)
        plan.lru_records = []
    # recency: last bump per key (hits without fills also refresh)
    bsel = np.flatnonzero(hit | (found > 0))
    if bsel.size:
        blast = _last_occurrence(keys[bsel])
        plan.stp_keys = keys[bsel][blast]
        plan.stp_vals = clocks[bsel][blast]
    else:
        plan.stp_keys = np.empty(0, np.int64)
        plan.stp_vals = np.empty(0, np.int64)
    plan.n_final = cache._n + newly
    plan.shortcut_hits = int(hit.sum())
    plan.misses = m - plan.shortcut_hits
    plan.rts = float(rts.sum())
    plan.hit = hit
    plan.out_ptr = None
    return plan
