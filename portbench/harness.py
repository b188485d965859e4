"""One run of one cell of the port's benchmark, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic; the
configuration is ``configs/<config>.json``, the traffic
``workloads/<traffic>.json``, and each metric is read by
``metrics/<metric>.py`` (its ``read(run)`` returns a number, or None where
the run holds nothing to read). Adding a cell or a metric adds files.

A traffic mix has a ``phase``:

* ``run``: YCSB's run phase over a pool loaded in set-up. Batches of
  ``2^batch_log2`` keys drawn from the configuration's zipfian,
  ``key_batches`` of them made on the device in set-up and issued in turn
  by one closed-loop issuer; a reservoir of ``sample_batches`` outputs,
  drawn from the seed, is kept for the comparison. Reads only.
* ``load``: YCSB's load phase, repeated. Each iteration makes a fresh
  pool and inserts every record in batches, in one of ``insert_orders``
  seeded orders; the value rows come from ``value_batches`` batches made
  in set-up, used in turn. The pool's creation is inside the window and
  synchronized before its first batch, so it counts in the rate and in
  no batch's latency.

A batch is timed by CUDA events recorded on the stream at its issue and
after its outputs exist, and the host synchronizes after each. The
window is closed after the first batch that ends past ``seconds``. A
traced run profiles a slice of its own after the window has closed, so
that its window runs as an untraced run's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import least_bytes, trace as trace_mod, ycsb  # noqa: E402
from portbench.reference import KVReference, value_rows  # noqa: E402
from portbench.store import PortStore  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    device: torch.device
    cfg: dict
    traffic: dict
    setup_s: float = 0.0
    ops: int = 0
    window_s: float = 0.0
    batch_ms: list = dataclasses.field(default_factory=list)
    calls: dict = dataclasses.field(default_factory=dict)     # kind -> [s]
    counters: dict = dataclasses.field(default_factory=dict)
    trace: trace_mod.Trace | None = None
    traced_bytes: dict = dataclasses.field(default_factory=dict)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str, root: str = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def mine(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    return {"cell": cell,
            "cfg": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(HERE, "workloads",
                                          cell["traffic"] + ".json")),
            "end_to_end": mine(spec["end_to_end"]),
            "per_layer": mine(spec["per_layer"])}


def read_metric(name: str, run: Run):
    """The value that ``metrics/<name>.py`` reads from ``run``, or None."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one the port must not
    load (the JAX package and JAX itself), compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FOREIGN})


class Clock:
    """Times batches: CUDA events on the stream (the host clock on the
    CPU), and the host's span of each call ended by a synchronize."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: list = []
        self.spans: list[float] = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def batch(self, fn, *args):
        """(fn(*args), host clock at its end)."""
        h0 = time.perf_counter()
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        out = fn(*args)
        if self.cuda:
            e1.record()
            torch.cuda.synchronize()
            self.events.append((e0, e1))
        h1 = time.perf_counter()
        self.spans.append(h1 - h0)
        return out, h1

    def batch_ms(self) -> list[float]:
        if self.cuda:
            return [e0.elapsed_time(e1) for e0, e1 in self.events]
        return [s * 1e3 for s in self.spans]


def _traced(clock: Clock, body):
    """Run ``body(span)`` under torch.profiler; returns the events.
    ``span(kind)`` is a context that marks one call for the reader."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            body(lambda kind: record_function(trace_mod.SPAN + kind))
            clock.sync()
    return trace_mod.events_of(prof)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, spec=None,
             overrides: dict | None = None, store_cls=None) -> dict:
    """One run of cell ``name``; returns its result line as a dict.
    ``overrides`` replaces configuration and traffic values (the CPU
    tests' small sizes); ``store_cls`` replaces the system under test."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = find_cell(spec or load_spec(), name)
    cfg = {**c["cfg"], **(overrides or {}).get("cfg", {})}
    traffic = {**c["traffic"], **(overrides or {}).get("traffic", {})}
    dev = torch.device(device)
    run = Run(device=dev, cfg=cfg, traffic=traffic)
    store = (store_cls or PortStore)(cfg, dev)
    store.build()
    phase = {"run": _RunPhase, "load": _LoadPhase}[traffic["phase"]]
    cell = phase(run, store, seed, Clock(dev))
    cell.setup()
    run.setup_s = time.perf_counter() - t_start
    cell.window(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    checks, compared, failed = cell.compare(trace)
    line = {"correct": all(v <= lim for v, lim in checks.values())
            and compared > 0,
            "attempted": run.ops, "failed": failed}
    wanted = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in wanted:
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["compared"] = compared
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


class _Phase:
    def __init__(self, run: Run, store, seed: int, clock: Clock):
        self.run, self.store, self.seed, self.clock = run, store, seed, clock
        cfg, traffic = run.cfg, run.traffic
        self.dev = run.device
        self.n = 1 << cfg["records_log2"]
        self.lanes = cfg["value_lanes"]
        self.b = 1 << traffic["batch_log2"]
        self.gen = ycsb.generator(seed, self.dev)

    def _order(self, gen: torch.Generator) -> torch.Tensor:
        """An insert order of every record, drawn from ``gen``."""
        return torch.randperm(self.n, generator=gen, device=self.dev,
                              dtype=torch.int64).to(torch.int32)

    def _values(self, slots: torch.Tensor) -> torch.Tensor:
        return value_rows(self.seed, slots, self.lanes)


class _RunPhase(_Phase):
    """YCSB's run phase, reads only, over a pool loaded in set-up."""

    def __init__(self, *args):
        super().__init__(*args)
        self.kept: list = []

    def setup(self) -> None:
        t, store = self.run.traffic, self.store
        zipf = ycsb.Zipf(self.n, self.run.cfg["zipf"], self.gen)
        self.order = self._order(self.gen)
        self.pool = torch.stack([zipf.keys(self.b, self.gen)
                                 for _ in range(t["key_batches"])])
        del zipf
        store.create()
        self.setup_ok = []
        for lo in range(0, self.n, self.b):
            keys = self.order[lo:lo + self.b]
            slots = torch.arange(lo, lo + keys.numel(), device=self.dev)
            self.setup_ok.append(store.write(keys, self._values(slots)))
        # hold as many outputs as the window keeps, so the allocator has
        # their blocks cached before the window
        held = [store.read(self.pool[i % len(self.pool)])
                for i in range(t["sample_batches"] + 2)]
        del held
        for i in range(t["warmup_batches"]):
            store.read(self.pool[i % len(self.pool)])
        gc.collect()
        self.clock.sync()

    def _trace(self) -> None:
        store, pool = self.store, self.pool
        self.traced = [i % len(pool)
                       for i in range(self.run.traffic["traced_batches"])]

        def body(span):
            for i in self.traced:
                with span("read"):
                    store.read(pool[i])
                    self.clock.sync()

        self.run.trace = trace_mod.summarize(*_traced(self.clock, body))

    def window(self, seconds: float) -> None:
        store, pool, clock, run = self.store, self.pool, self.clock, self.run
        k = run.traffic["sample_batches"]
        rng = random.Random(self.seed)
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            (vals, found), t1 = clock.batch(store.read, pool[i % len(pool)])
            if i < k:
                self.kept.append((i, vals, found))
            else:
                j = rng.randrange(i + 1)
                if j < k:
                    self.kept[j] = (i, vals, found)
            del vals, found
            i += 1
            if t1 >= deadline:
                break
        run.ops = i * self.b
        run.window_s = t1 - t0
        run.batch_ms = clock.batch_ms()
        run.calls["read"] = clock.spans

    def compare(self, trace: bool):
        """Profiles the traced slice if ``trace``, then frees the pool and
        checks the reservoir against the reference."""
        if trace:
            self._trace()
        self.store.release()
        ref = KVReference(self.n, self.dev)
        acked = torch.cat(self.setup_ok)
        ref.write(self.order[acked],
                  torch.arange(self.n, device=self.dev)[acked])
        failed_setup = int((~acked).sum())
        wrong = missed = 0
        for i, vals, found in self.kept:
            wrong += ref.mismatches(self.seed, self.lanes,
                                    self.pool[i % len(self.pool)], found,
                                    vals)
            missed += int((~found).sum())
        compared = len(self.kept) * self.b
        self.kept.clear()
        if self.run.trace is not None:
            self.run.traced_bytes["read"] = [
                least_bytes.lookup_bytes(self.pool[i],
                                         ref.slot[self.pool[i].long()] >= 0,
                                         4 * self.lanes)
                for i in self.traced]
        return ({"wrong_reads": (wrong, 0),
                 "failed_setup_inserts": (failed_setup, 0)},
                compared, missed)


class _LoadPhase(_Phase):
    """YCSB's load phase, repeated into a fresh pool each iteration."""

    def setup(self) -> None:
        t = self.run.traffic
        if self.n % self.b:
            raise ValueError("the records must fill whole batches")
        self.orders = [self._order(self.gen)
                       for _ in range(t["insert_orders"])]
        self.slots = t["value_batches"] * self.b
        self.values = self._values(
            torch.arange(self.slots, device=self.dev)).view(
                t["value_batches"], self.b, self.lanes)
        self.ok_total = torch.zeros((), dtype=torch.int64, device=self.dev)
        for it in range(t["warmup_loads"]):
            self._load(self.orders[it % len(self.orders)])
        gc.collect()
        self.ok_total.zero_()
        self.clock.sync()

    def _write(self, keys, vals):
        ok = self.store.write(keys, vals)
        self.ok_total.add_(ok.sum())
        return ok

    def _load(self, order, deadline=None, span=None):
        """One load of every record in ``order`` into a fresh pool; stops
        after the batch that ends past ``deadline``. Returns the batches
        written. ``span`` marks the calls of a traced load."""
        store, nb = self.store, self.n // self.b
        store.release()
        with span("create") if span else contextlib.nullcontext():
            store.create()
            self.clock.sync()
        for bi in range(nb):
            keys = order[bi * self.b:(bi + 1) * self.b]
            vals = self.values[bi % len(self.values)]
            if span:
                # the program's call alone: no ok is counted here
                with span("write"):
                    store.write(keys, vals)
                    self.clock.sync()
                continue
            _, t1 = self.clock.batch(self._write, keys, vals)
            if deadline is not None and t1 >= deadline:
                return bi + 1
        return nb

    def _trace(self) -> None:
        t = self.run.traffic
        self.traced = [it % len(self.orders)
                       for it in range(t["traced_loads"])]

        def body(span):
            for o in self.traced:
                self._load(self.orders[o], span=span)

        self.run.trace = trace_mod.summarize(*_traced(self.clock, body))

    def window(self, seconds: float) -> None:
        run, clock = self.run, self.clock
        work0 = self.store.counters().get("clht_insert", 0)
        clock.events.clear()
        clock.spans.clear()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        it = done = 0
        while True:
            order = it % len(self.orders)
            done = self._load(self.orders[order], deadline)
            it += 1
            if time.perf_counter() >= deadline:
                break
        run.window_s = time.perf_counter() - t0
        self.last = (order, done)
        run.ops = len(clock.spans) * self.b
        run.batch_ms = clock.batch_ms()
        run.calls["write"] = list(clock.spans)
        run.counters = {
            "keys_inserted": run.ops,
            "slow_path_entries":
                self.store.counters().get("clht_insert", 0) - work0}

    def compare(self, trace: bool):
        """Reads every key back from the window's last pool against the
        reference, then profiles the traced slice if ``trace`` (its loads
        replace that pool) and frees the pool."""
        failed = self.run.ops - int(self.ok_total)
        order, done = self.last
        ref = KVReference(self.n, self.dev)
        inserted = done * self.b
        ref.write(self.orders[order][:inserted],
                  torch.arange(inserted, device=self.dev) % self.slots)
        wrong = 0
        for lo in range(0, self.n, self.b):
            keys = torch.arange(lo, min(lo + self.b, self.n),
                                dtype=torch.int32, device=self.dev)
            vals, found = self.store.read(keys)
            wrong += ref.mismatches(self.seed, self.lanes, keys, found, vals)
            del vals, found
        if trace:
            self._trace()
        self.store.release()
        if self.run.trace is not None:
            self.run.traced_bytes["write"] = [
                least_bytes.merge_bytes(
                    self.orders[o][bi * self.b:(bi + 1) * self.b],
                    4 * self.lanes)
                for o in self.traced for bi in range(self.n // self.b)]
        return ({"failed_inserts": (failed, 0),
                 "wrong_read_back": (wrong, 0)},
                self.run.ops + self.n, failed)
