#!/usr/bin/env python3
"""Drive the PyTorch port's DPM data plane on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels (src/repro_torch/csrc/*.cu, nvcc for
sm_90a, into build/repro_torch/), holds every kernel against its plain
torch version on the card, then serves the repo's own dataset -- 2^25
keys with 1 KB values (the paper's 32 GB dataset) in a device-resident
CLHT index, log segment and value heap:

  load       every key through log_append_merge, in batches of 2^20
  serve      YCSB read_only and write_heavy_update at zipf 0.99, reads
             through kvs_lookup, writes through log_append_merge, every
             read checked against a host shadow of the last acknowledged
             version of its key
  read-back  every key written while serving, through lookup (its
             pointer) and kvs_lookup (its value row)

and times each kernel at the shapes the serving path gives it. Every
failure raises. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels.
Without a card, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import clht, log  # noqa: E402
from repro_torch.data import Workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import clht_probe as probe  # noqa: E402
from repro_torch.kernels import log_merge as merge  # noqa: E402

KEYS_LOG2 = 25              # the paper's 32 GB of 1 KB values
WIDTH = 256                 # int32 lanes per value row = 1 KB
ZIPF = 0.99
BATCH = 1 << 20             # keys or ops per load / served batch
BATCHES = 8                 # served batches per mix
REPS = 20                   # timed runs per kernel
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def value_rows(keys: torch.Tensor, versions: torch.Tensor) -> torch.Tensor:
    """Value rows as a fixed integer hash of (key, version, lane), so any
    read can be checked by regenerating its row."""
    k = keys.to(torch.int64)[:, None]
    v = versions.to(torch.int64)[:, None]
    lane = torch.arange(WIDTH, dtype=torch.int64, device=keys.device)[None]
    h = (k * 0x9E3779B1) ^ (v * 0x85EBCA77) ^ (lane * 0xC2B2AE3D)
    return ((h ^ (h >> 15)) & 0x7FFFFFFF).to(torch.int32)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over matching integer outputs; raises on
    any difference of shape or value (the kernels must be exact)."""
    worst = 0
    for name, got, ref in pairs:
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        diff = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        if err:
            bad = int((diff != 0).sum())
            raise AssertionError(f"{name}: {bad} elements differ from the "
                                 f"plain version (max |diff| {err})")
        worst = max(worst, err)
    return worst


def synced(fn, *args):
    """(fn(*args), seconds on the host clock), synchronized on both
    sides so the device work is inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, setup=None):
    """(mean device ms of ``fn(*setup())`` over ``reps`` runs, the last
    run's output), from CUDA events around each call (``setup`` runs
    outside the timed region)."""
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps, out


class Smoke:
    def __init__(self):
        self.dev = torch.device("cuda")
        self.errors: dict[str, int] = {}

    def clone_table(self, t):
        return clht.CLHT(lines=t.lines.clone(),
                         overflow_head=t.overflow_head.clone(),
                         num_buckets=t.num_buckets)

    # ---------------------------------------------------------------- 1-2
    def environment(self) -> str:
        emit({"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]})
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        cap = torch.cuda.get_device_capability(0)
        emit({"device": torch.cuda.get_device_name(0), "capability": cap})
        if cap != (9, 0):
            raise RuntimeError(f"needs an sm_90 card, found {cap}")
        return smi

    def build_kernels(self) -> None:
        t0 = time.perf_counter()
        _build.build()
        so = _build.library_path()
        build_log = so.with_suffix(".log")
        regs = [ln.strip() for ln in
                (build_log.read_text().splitlines()
                 if build_log.exists() else [])
                if "registers" in ln or "spill" in ln]
        emit({"build_s": round(time.perf_counter() - t0, 3),
              "library": str(so.relative_to(ROOT)), "ptxas": regs})

    # ------------------------------------------------------------------ 3
    def check_kernels(self) -> None:
        g = np.random.default_rng(SEED)
        dev = self.dev
        # A and B: 2^16 buckets, 2^18 keys, chains and an exhausted
        # overflow region
        nb, nk = 1 << 16, 1 << 18
        keys = torch.from_numpy(g.choice(1 << 24, nk, replace=False)
                                .astype(np.int32)).to(dev)
        table = clht.clht_init(nb, device=dev)
        heap = log.heap_init(nk, WIDTH, device=dev)
        heap, ptrs = log.heap_append(
            heap, value_rows(keys, torch.zeros_like(keys)))
        clht.clht_insert(table, keys, ptrs)
        miss = torch.from_numpy(g.integers(1 << 24, 1 << 25, nk // 2 - 8)
                                .astype(np.int32)).to(dev)
        pk = torch.cat([keys[:nk // 2], miss,
                        torch.full((8,), -1, dtype=torch.int32, device=dev)])
        pk = pk[torch.from_numpy(g.permutation(nk)).to(dev)].contiguous()
        bids = clht.bucket_of(pk, nb)
        got = probe.clht_probe(table.lines, bids, pk)
        ref = probe.clht_probe_ref(table.lines, bids, pk)
        # the full lookups against the chain walk on real keys only (a
        # negative key matches empty slots in the reference's chain walk)
        real = pk[pk >= 0].contiguous()
        full = probe.lookup(table, real)
        walk = clht.clht_lookup(table, real)[:2]
        self.errors["clht_probe"] = max_abs_err(
            [("ptrs", got[0], ref[0]), ("found", got[1], ref[1]),
             ("lookup.ptrs", full[0], walk[0]),
             ("lookup.found", full[1], walk[1])])
        got = probe.kvs_lookup_fused(table.lines, heap.data, bids, pk)
        ref = probe.kvs_lookup_fused_ref(table.lines, heap.data, bids, pk)
        full = probe.kvs_lookup(table, heap, real)
        oracle = probe.kvs_lookup_ref(table, heap, real)
        self.errors["kvs_lookup_fused"] = max_abs_err(
            [(n, a, b) for n, a, b in zip(
                ("vals", "ptrs", "found", "kvs_lookup.vals",
                 "kvs_lookup.ptrs", "kvs_lookup.found"),
                got + full, ref + oracle)])
        assert bool(full[2].any()) and not bool(full[2].all())

        # C: ~2^15 entries with duplicates and full buckets
        nb = 1 << 12
        table = clht.clht_init(nb, device=dev)
        pre = torch.from_numpy(g.integers(0, 4 * nb, nb).astype(np.int32))
        clht.clht_insert(table, pre.to(dev), pre.to(dev) + 7000)
        ek = torch.from_numpy(g.integers(0, 4 * nb, 1 << 15)
                              .astype(np.int32)).to(dev)
        ek[::97] = -3
        ep = torch.arange(1 << 15, dtype=torch.int32, device=dev)
        eb = clht.bucket_of(torch.clamp(ek, min=0), nb)
        bs, order, starts = merge.sort_by_bucket(eb)
        ks, ps = ek[order].contiguous(), ep[order].contiguous()
        lk, lr = table.lines.clone(), table.lines.clone()
        got = merge.log_merge_sorted(lk, starts, bs, ks, ps)
        ref = merge.log_merge_sorted_ref(lr, starts, bs, ks, ps)
        # log_merge against the entry-at-a-time oracle, which knows no
        # padding keys
        pos = ek >= 0
        lo = table.lines.clone()
        _, o1, k1 = merge.log_merge(lo, eb[pos], ek[pos], ep[pos])
        l2, o2, k2 = merge.log_merge_ref(table.lines, eb[pos], ek[pos],
                                         ep[pos])
        self.errors["log_merge_sorted"] = max_abs_err(
            [("lines", lk, lr), ("old", got[0], ref[0]),
             ("ok", got[1], ref[1]), ("log_merge.lines", lo[:, :7], l2[:, :7]),
             ("log_merge.old", o1, o2), ("log_merge.ok", k1, k2)])
        assert not bool(got[1].all())        # some buckets were full

        # D: chain growth and overflow exhaustion (64 overflow buckets)
        table = clht.clht_init(1 << 10, 64, device=dev)
        dk = torch.from_numpy(g.integers(0, 1 << 13, 1 << 13)
                              .astype(np.int32)).to(dev)
        dp = torch.arange(1 << 13, dtype=torch.int32, device=dev)
        dm = torch.from_numpy(g.random(1 << 13) < 0.95).to(dev)
        tk, tr = self.clone_table(table), self.clone_table(table)
        got = clht.clht_insert(tk, dk, dp, dm)
        ref = clht.clht_insert_plain(tr, dk, dp, dm)
        self.errors["clht_insert"] = max_abs_err(
            [("lines", tk.lines, tr.lines),
             ("overflow_head", tk.overflow_head, tr.overflow_head),
             ("old", got[1], ref[1]), ("ok", got[2], ref[2]),
             ("num_new", got[3], ref[3])])
        assert int(tk.overflow_head) == tk.total_buckets   # exhausted
        assert not bool(got[2][dm].all())
        torch.cuda.synchronize()
        emit({"kernels_vs_plain": self.errors})

    # ------------------------------------------------------------ 4-6
    def serve(self) -> dict:
        n = 1 << KEYS_LOG2
        batch = BATCH
        dev = self.dev
        t0 = time.perf_counter()
        reads = Workload(n, zipf=ZIPF, mix="read_only", seed=SEED)
        ro_keys = [reads.ops_arrays(batch)[1] for _ in range(BATCHES)]
        writes = Workload(n, zipf=ZIPF, mix="write_heavy_update",
                          seed=SEED + 1)
        wh_ops = [writes.ops_arrays(batch) for _ in range(BATCHES)]
        n_writes = int(sum(int(k.sum()) for k, _ in wh_ops))
        emit({"workload_s": round(time.perf_counter() - t0, 3),
              "keys": n, "batch": batch, "serve_writes": n_writes})

        cap = n + n_writes + batch       # + the profiled batch
        table = clht.clht_init(n, device=dev)
        seg = log.segment_init(cap, device=dev)
        heap = log.heap_init(cap, WIDTH, device=dev)
        shadow_ver = np.full(n, -1, np.int32)    # last acknowledged version
        shadow_ptr = np.full(n, -1, np.int32)
        heap_rows = heap.data.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        perm = torch.randperm(n, generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)

        def ack(keys_h, vers_h, ptrs, ok):
            """Record the acknowledged writes of a batch, last in log
            order winning; returns the keys of its failed writes."""
            ok_h = ok.cpu().numpy()
            ptrs_h = ptrs.cpu().numpy()
            sel = np.flatnonzero(ok_h)[::-1]
            _, last = np.unique(keys_h[sel], return_index=True)
            last = sel[last]
            shadow_ver[keys_h[last]] = vers_h[last]
            shadow_ptr[keys_h[last]] = ptrs_h[last]
            return keys_h[~ok_h]

        def write(keys_d, vals):
            """One write batch through log_append_merge; returns (ptrs,
            ok, seconds on the host clock, synchronized)."""
            nonlocal table, seg, heap
            count0 = seg.count
            (table, seg, heap, ptrs, _, ok), sec = synced(
                merge.log_append_merge, table, seg, heap, keys_d, vals)
            if seg.count != count0 + keys_d.numel():
                raise AssertionError("a write batch did not fit the segment")
            if heap.head > heap_rows:
                raise AssertionError("the value heap overflowed")
            return ptrs, ok, sec

        def check_reads(keys_h, vals, ptrs, found):
            ver = torch.from_numpy(shadow_ver[keys_h]).to(dev)
            want_ptr = torch.from_numpy(shadow_ptr[keys_h]).to(dev)
            if not torch.equal(found, ver >= 0):
                raise AssertionError("a read's presence disagrees with the "
                                     "last acknowledged write")
            if not torch.equal(ptrs, torch.where(ver >= 0, want_ptr, -1)):
                raise AssertionError("a read's pointer disagrees with the "
                                     "last acknowledged write")
            want = value_rows(torch.from_numpy(keys_h).to(dev), ver)
            if not torch.equal(vals[found], want[found]):
                raise AssertionError("a read returned another value than "
                                     "the last acknowledged write")

        # set every count to 0 just before the main path
        _build.reset_counts()
        torch.cuda.reset_peak_memory_stats()

        # 4. load (data generation and the shadow are set-up: untimed)
        load_s = 0.0
        failed_load = 0
        for lo in range(0, n, batch):
            kd = perm[lo:lo + batch].contiguous()
            kh = kd.cpu().numpy().astype(np.int64)
            zero = np.zeros(kh.size, np.int32)
            vals = value_rows(kd, torch.from_numpy(zero).to(dev))
            ptrs, ok, sec = write(kd, vals)
            load_s += sec
            failed_load += ack(kh, zero, ptrs, ok).size
        slow = _build.work["clht_insert"]
        emit({"phase": "load", "keys": n, "seconds": load_s,
              "keys_per_s": n / load_s, "slow_path_entries": slow,
              "slow_path_share": slow / n, "failed_inserts": failed_load,
              "overflow_buckets_used": int(table.overflow_head) - n})

        # 5. serve
        served = {}
        t_serve = 0.0
        for keys in ro_keys:
            kd = torch.from_numpy(keys.astype(np.int32)).to(dev)
            out, sec = synced(probe.kvs_lookup, table, heap, kd)
            t_serve += sec
            check_reads(keys, *out)
        served["read_only"] = {"ops": BATCHES * batch, "seconds": t_serve,
                               "ops_per_s": BATCHES * batch / t_serve}
        t_serve = 0.0
        written, failed = [], []
        slow0 = _build.work["clht_insert"]
        for b, (kinds, keys) in enumerate(wh_ops):
            rk, wk = keys[kinds == 0], keys[kinds == 1]
            vers = (1 + b * batch + np.flatnonzero(kinds == 1)).astype(
                np.int32)
            rd = torch.from_numpy(rk.astype(np.int32)).to(dev)
            wd = torch.from_numpy(wk.astype(np.int32)).to(dev)
            vals = value_rows(wd, torch.from_numpy(vers).to(dev))
            out, sec = synced(probe.kvs_lookup, table, heap, rd)
            t_serve += sec
            check_reads(rk, *out)
            ptrs, ok, sec = write(wd, vals)
            t_serve += sec
            failed.append(ack(wk, vers, ptrs, ok))
            written.append(wk)
        failed_writes = int(sum(f.size for f in failed))
        served["write_heavy_update"] = {
            "ops": BATCHES * batch, "seconds": t_serve,
            "ops_per_s": BATCHES * batch / t_serve,
            "writes": n_writes, "failed_writes": failed_writes,
            "slow_path_entries": _build.work["clht_insert"] - slow0}
        emit({"phase": "serve", "zipf": ZIPF, **served})

        # 6. read-back of every key written while serving
        keys_w = np.unique(np.concatenate(written))
        for lo in range(0, keys_w.size, batch):
            kh = keys_w[lo:lo + batch]
            kd = torch.from_numpy(kh.astype(np.int32)).to(dev)
            ptrs, found = probe.lookup(table, kd)
            if not bool(found.all()) or not torch.equal(
                    ptrs, torch.from_numpy(shadow_ptr[kh]).to(dev)):
                raise AssertionError("read-back: lookup disagrees with the "
                                     "last acknowledged write")
            check_reads(kh, *probe.kvs_lookup(table, heap, kd))
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        emit({"phase": "read_back", "keys": int(keys_w.size),
              "failed_writes": failed_writes,
              "keys_with_failed_writes": int(
                  np.unique(np.concatenate(failed)).size),
              "heap_head": heap.head, "heap_capacity": heap_rows,
              "last_fit": True,
              "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30})
        emit({"launches": counts})
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        self.counts = counts
        self.slow_per_launch = max(
            1, _build.work["clht_insert"]
            // max(1, counts["clht_insert"]))
        return {"table": table, "seg": seg, "heap": heap,
                "read_keys": ro_keys[0], "write_ops": wh_ops[0], "n": n}

    # ------------------------------------------------------------------ 7
    def time_kernels(self, st) -> list[dict]:
        """Each kernel and its plain version at the shapes the main path
        gives it. Every callable returns its outputs, state it updated
        included, named by ``outs``; the last kernel run and the last
        plain run (each on a fresh copy of that state) are held against
        each other, and that comparison is the kernel's max_abs_err."""
        table, heap, dev = st["table"], st["heap"], self.dev
        mbytes = lambda b: b / HBM_BYTES_PER_S * 1e3   # noqa: E731

        # A and B on one served read batch against the full table
        kd = torch.from_numpy(st["read_keys"].astype(np.int32)).to(dev)
        bids = clht.bucket_of(kd, table.num_buckets)
        nk = kd.numel()
        lines_touched = int(torch.unique(bids).numel())
        a_bytes = nk * 16 + lines_touched * 32
        ptrs, found = probe.clht_probe(table.lines, bids, kd)
        rows_found = int(torch.unique(ptrs[found.bool()]).numel())
        b_bytes = a_bytes + nk * WIDTH * 4 + rows_found * WIDTH * 4
        safe = ptrs.long().clamp(0, heap.data.shape[0] - 1)
        out = [
            self._timed(
                "clht_probe", "clht_probe.cu",
                "src/repro/kernels/clht_probe/clht_probe.py:143",
                ("ptrs", "found"),
                lambda: probe.clht_probe(table.lines, bids, kd),
                lambda: probe.clht_probe_ref(table.lines, bids, kd), None,
                a_bytes, REPS),
            self._timed(
                "kvs_lookup_fused", "clht_probe.cu",
                "src/repro/kernels/clht_probe/clht_probe.py:97",
                ("vals", "ptrs", "found"),
                lambda: probe.kvs_lookup_fused(table.lines, heap.data, bids,
                                               kd),
                lambda: probe.kvs_lookup_fused_ref(table.lines, heap.data,
                                                   bids, kd),
                lambda: torch.index_select(heap.data, 0, safe), b_bytes,
                REPS),
        ]

        # C on one served write batch: sorted entries, fresh copy of the
        # lines for every run. Per entry 8 B read (key, ptr) and 8 B
        # written (old, ok); per group its start and one bucket id read
        # and its line read and written once.
        kinds, keys = st["write_ops"]
        wk = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
        bs, order, starts = merge.sort_by_bucket(
            clht.bucket_of(wk, table.num_buckets))
        ks = wk[order].contiguous()
        ps = torch.arange(wk.numel(), dtype=torch.int32, device=dev)
        groups = starts.numel() - 1
        c_bytes = wk.numel() * 16 + groups * 4 + (groups + 1) * 4 \
            + groups * 64
        fresh = lambda: (table.lines.clone(),)        # noqa: E731
        out.append(self._timed(
            "log_merge_sorted", "log_merge.cu",
            "src/repro/kernels/log_merge/log_merge.py:74",
            ("lines", "old", "ok"),
            lambda lines: (lines, *merge.log_merge_sorted(lines, starts, bs,
                                                          ks, ps)),
            lambda lines: (lines, *merge.log_merge_sorted_ref(
                lines, starts, bs, ks, ps)),
            None, c_bytes, REPS, setup=fresh, plain_reps=1,
            extra={"entries": wk.numel(), "groups": groups,
                   "largest_group": int((starts[1:] - starts[:-1]).max())}))

        # D on the load's mean slow-path batch: fresh keys into the full
        # table (a copy per run), with no mask, as the main path calls it.
        # Per entry 8 B read (key, ptr), 8 B written (old, ok) and one
        # line written; one line read per chain step.
        k = self.slow_per_launch
        dk = torch.arange(st["n"], st["n"] + k, dtype=torch.int32,
                          device=dev)
        dp = dk.clone()
        probes = int(clht.clht_lookup(table, dk)[2].sum())
        d_bytes = k * 16 + probes * 32 + k * 32
        copy = lambda: (self.clone_table(table),)     # noqa: E731

        def insert_outs(res):
            t, old, ok, num_new = res
            return t.lines, t.overflow_head, old, ok, num_new

        out.append(self._timed(
            "clht_insert", "clht_insert.cu", "src/repro/core/clht.py:184",
            ("lines", "overflow_head", "old", "ok", "num_new"),
            lambda t: insert_outs(clht.clht_insert(t, dk, dp)),
            lambda t: insert_outs(clht.clht_insert_plain(t, dk, dp)), None,
            d_bytes, max(2, REPS // 4), setup=copy, plain_reps=1,
            extra={"entries": k, "lines_walked": probes}))
        for row in out:
            row["bound_ms"] = mbytes(row.pop("bytes"))
            row["bound_by"] = "bytes"
        return out

    def profile(self, st) -> None:
        """torch.profiler over one write_heavy_update batch (its reads,
        then its writes) on the loaded table: device time by kernel and
        the device's busy share of the batch's wall time."""
        from torch.profiler import ProfilerActivity, profile
        kinds, keys = st["write_ops"]
        dev = self.dev
        rd = torch.from_numpy(keys[kinds == 0].astype(np.int32)).to(dev)
        wd = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
        vals = value_rows(wd, torch.full_like(wd, -7))

        def batch():
            probe.kvs_lookup(st["table"], st["heap"], rd)
            merge.log_append_merge(st["table"], st["seg"], st["heap"],
                                        wd, vals)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(batch)
        kernels: dict[str, list] = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                k = kernels.setdefault(e.name[:60], [0, 0.0])
                k[0] += 1
                k[1] += e.time_range.elapsed_us() / 1e3
        busy_ms = sum(ms for _, ms in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        emit({"profile": "write_heavy_update batch", "wall_ms": wall * 1e3,
              "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / (wall * 1e3),
              "top": [{"name": name, "calls": c, "device_ms": ms}
                      for name, (c, ms) in top]})

    def _timed(self, name, source, replaces, outs, fn, plain, library,
               nbytes, reps, setup=None, plain_reps=None, extra=None):
        ms, got = event_ms(fn, reps, setup)
        plain_ms, ref = event_ms(plain, plain_reps or max(1, reps // 4),
                                 setup)
        err = max_abs_err([(f"{name}.{o}", a, b)
                           for o, a, b in zip(outs, got, ref, strict=True)])
        del got, ref
        lib_ms = event_ms(library, reps)[0] if library else None
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{source}",
               "replaces": replaces, "launches": self.counts[name],
               "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bytes": nbytes, "library_ms": lib_ms}
        emit({"timing": name, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "max_abs_err": err, **(extra or {})})
        return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smoke = Smoke()
    smoke.environment()
    smoke.build_kernels()
    smoke.check_kernels()
    st = smoke.serve()
    kernels = smoke.time_kernels(st)
    smoke.profile(st)
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
