"""Port parity for the open-loop request plane: the arrival processes
(repro_torch.core.netmodel.ArrivalProcess, PhasedArrival) and
repro_torch.core.requestplane.RequestPlane against the reference's.

The arrival processes return bit-equal arrays from equal generators and
leave them in equal states; the deprecated ``op_latency`` shim returns the
reference's numbers with its warning. ``RequestPlane`` runs on twin
clusters (the reference's and the port's, ``device="cpu"``) through the
streams of tests/test_requestplane.py: TestEngineBehavior, the armed
``log.pre_seal`` crashes of TestExactlyOnceAcrossCrash and
TestRunOpenLoop. After each run the counters, every record (statuses,
times, request IDs, hedges), the events, ``percentiles()``,
``goodput()``, the never-applied request IDs and the history are equal,
and so are the clusters' whole states; the port's card copy of its index
equals its host index after every crash and recovery. Exact comparisons:
nothing here reads a clock."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jf  # noqa: E402
from repro.core import linearizability as jl  # noqa: E402
from repro.core import netmodel as jn  # noqa: E402
from repro.core import requestplane as jr  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data import Workload as JWorkload  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import linearizability as tl  # noqa: E402
from repro_torch.core import netmodel as tn  # noqa: E402
from repro_torch.core import requestplane as tr  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.data import Workload as TWorkload  # noqa: E402
from torch_cluster_cases import mirror_equals_host  # noqa: E402
from torch_plane_cases import Twin, assert_same, plain  # noqa: E402

MIX = "read_mostly_update"
PKG = {"ref": (jn, jr, jsc, jf, JWorkload, jsim, jl),
       "port": (tn, tr, tsc, tf, TWorkload, tsim, tl)}


# ---------------------------------------------------------------- arrivals
ARRIVALS = [
    ("poisson", {"rate": 5000.0}, 0.0, 2.0),
    ("bursty", {"rate": 2000.0, "kind": "bursty", "burst_factor": 4.0,
                "burst_s": 0.2}, 0.0, 8.0),
    ("bursty_scaled", {"rate": 8e6, "kind": "bursty"}, 1.5, 3.25),
    ("empty_window", {"rate": 100.0}, 2.0, 2.0),
    ("zero_rate", {"rate": 0.0}, 0.0, 1.0),
]


@pytest.mark.parametrize("seed", (0, 3, 7))
@pytest.mark.parametrize("name, kw, t0, t1", ARRIVALS,
                         ids=[a[0] for a in ARRIVALS])
def test_arrival_process_draws_as_the_reference(name, kw, t0, t1, seed):
    a, b = jn.ArrivalProcess(**kw), tn.ArrivalProcess(**kw)
    if name == "bursty_scaled":
        a, b = a.scaled(1e-3), b.scaled(1e-3)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):      # the generators carry on alike
        xa, xb = a.arrivals(ga, t0, t1), b.arrivals(gb, t0, t1)
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
        assert ga.bit_generator.state == gb.bit_generator.state
        t0, t1 = t1, t1 + (t1 - t0 or 1.0)
    for t in np.linspace(0.0, 3.0, 31).tolist():
        assert a._phase_rate(t) == b._phase_rate(t)


def phased(mod, factor=1.0):
    lo, hi = mod.ArrivalProcess(rate=100.0), mod.ArrivalProcess(rate=1e4)
    mid = mod.ArrivalProcess(rate=2e3, kind="bursty", burst_factor=3.0)
    return mod.PhasedArrival(((1.0, lo), (0.5, mid), (1.0, hi)),
                             t0=0.25).scaled(factor)


@pytest.mark.parametrize("factor", (1.0, 0.5))
@pytest.mark.parametrize("t0, t1", ((0.0, 2.0), (0.5, 1.4), (1.0, 9.0),
                                    (4.0, 6.0)))
def test_phased_arrival_draws_as_the_reference(t0, t1, factor):
    a, b = phased(jn, factor), phased(tn, factor)
    assert a.rate == b.rate
    for t in (0.0, 0.3, 1.3, 1.8, 2.6, 99.0):
        assert dataclasses.asdict(a.phase_at(t)) == \
            dataclasses.asdict(b.phase_at(t))
    ga, gb = np.random.default_rng(11), np.random.default_rng(11)
    xa, xb = a.arrivals(ga, t0, t1), b.arrivals(gb, t0, t1)
    assert np.array_equal(xa, xb) and xa.dtype == xb.dtype
    assert ga.bit_generator.state == gb.bit_generator.state


@pytest.mark.parametrize("kw", ({"rate": 1.0, "kind": "diurnal"},
                                {"rate": 1.0, "kind": "bursty",
                                 "burst_factor": 1.0}))
def test_arrival_process_refuses_as_the_reference(kw):
    msgs = []
    for mod in (jn, tn):
        with pytest.raises(ValueError) as e:
            mod.ArrivalProcess(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("rts", (1.0, 2.0, 3.0, 4.4, 6.0))
@pytest.mark.parametrize("qf", (0.25, 1.0, 2.5, 8.0))
def test_op_latency_shim_matches_the_reference(rts, qf):
    got = []
    for mod in (jn, tn):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            v = mod.DEFAULT_MODEL.op_latency(rts, qf, two_sided_rts=0.5)
        assert [x.category for x in w] == [DeprecationWarning]
        got.append((v, str(w[0].message)))
    assert got[0] == got[1]
    assert tn.NetModel().request_latency(rts, queue_depth=qf,
                                         service_rate=1e3) == \
        jn.NetModel().request_latency(rts, queue_depth=qf, service_rate=1e3)


def test_net_model_is_a_frozen_dataclass_as_the_reference():
    """Scenarios sweep the timing constants with dataclasses.replace."""
    a = dataclasses.replace(jn.DEFAULT_MODEL, detect_s=0.2, handoff_s=0.3)
    b = dataclasses.replace(tn.DEFAULT_MODEL, detect_s=0.2, handoff_s=0.3)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tn.NetModel(kn_cpu_ops=2e6) == tn.NetModel(kn_cpu_ops=2e6)
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.detect_s = 1.0


@pytest.mark.parametrize("kw", ({"policy": "drop"}, {"priorities": 0},
                                {"op_scale": 0.0}))
def test_config_validation_matches_the_reference(kw):
    msgs = []
    for mod in (jr, tr):
        with pytest.raises(ValueError) as e:
            mod.RequestPlaneConfig(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ the engine
def make_twin(num_kns=4, num_keys=1500, seed=0, value_bytes=256) -> Twin:
    """test_requestplane.py:make_cluster, as twins."""
    t = Twin("dinomo", num_kns=num_kns, cache_bytes=1 << 18,
             value_bytes=value_bytes, num_buckets=1 << 11,
             segment_capacity=64, seed=seed)
    t.load(num_keys)
    return t


def run_plane(side, c, *, load_frac, duration=0.25, seed=1, mix=MIX,
              num_keys=1500, cfg=None, kind="poisson", crash=None):
    """test_requestplane.py:run_plane with ``side``'s package. ``crash``
    arms (point, after) on a FaultPlane of the same seed; the port's
    recovery handler is the reference's default, then holds the pool's
    card copy of its index to the host index."""
    netm, rp, sc, fm, W = PKG[side][:5]
    if crash is not None:
        seed_f, point, after = crash
        fp = fm.FaultPlane(seed=seed_f)
        c.pool.faults = fp
        fp.arm_crash(point, after=after)
    wl = W(num_keys=num_keys, zipf=0.99, mix=mix,
           value_bytes=c.value_bytes, seed=seed)
    cap = sc.estimated_capacity(netm.DEFAULT_MODEL, len(c.kns), mix,
                                value_bytes=c.value_bytes)

    def on_crash(plane, e):
        rp.RequestPlane.default_recover(plane, e)
        if side == "port":
            mirror_equals_host(plane.c.pool)

    plane = rp.RequestPlane(
        c, netm.ArrivalProcess(rate=load_frac * cap, kind=kind),
        wl.timed_batched,
        cfg=rp.RequestPlaneConfig(**(cfg or {})),
        model=netm.DEFAULT_MODEL, seed=seed,
        on_crash=on_crash if crash is not None else None)
    return plane, plane.run(duration)


def result_of(plane, res) -> dict:
    """Everything a run returns and leaves in its plane."""
    return {"counters": plain(res.counters),
            "records": plain(res.records),
            "latencies": plain(res.latencies),
            "events": plain(res.events),
            "percentiles": res.percentiles(), "goodput": res.goodput(),
            "row": plain(res.row()),
            "never_applied": list(plane.never_applied_reqs),
            "retire_horizon": plane.retire_horizon,
            "history": plain(plane.history()),
            "queues": {nm: [plain(list(q)) for q in kq.qs]
                       for nm, kq in plane.queues.items()},
            "free_at": plane.free_at, "rts_est": plane.rts_est,
            "credit": plane.credit, "pending": plain(plane.pending),
            "rng": plane.rng.bit_generator.state,
            "req_index": dict(plane.c.pool.req_index)}


def twin_run(t: Twin, **kw):
    """The same plane run on both clusters; every result and the whole
    states equal. Returns the port's (plane, result)."""
    out = {}
    for side, c in zip(("ref", "port"), t.clusters):
        out[side] = run_plane(side, c, **kw)
    assert_same(result_of(*out["ref"]), result_of(*out["port"]), "plane")
    t.check()
    return out["port"]


def test_low_load_everything_completes():
    t = make_twin()
    plane, res = twin_run(t, load_frac=0.25)
    cnt = res.counters
    assert cnt["offered"] > 100 and cnt["completed"] == cnt["offered"]
    for op in res.records:
        assert op.arrival <= op.enq_t <= op.dispatch_t < op.done_t


def test_overload_sheds_lowest_priority_first():
    t = make_twin()
    plane, res = twin_run(t, load_frac=2.5,
                          cfg={"queue_capacity": 8, "max_retries": 1})
    assert res.counters["shed"] > 0
    assert res.counters["shed_by_prio"][-1] > res.counters["shed_by_prio"][0]
    assert not any(t.port.pool.req_applied(r)
                   for r in plane.never_applied_reqs)


def test_defer_policy_never_sheds():
    t = make_twin()
    _, res = twin_run(t, load_frac=2.5,
                      cfg={"queue_capacity": 8, "policy": "defer",
                           "max_retries": 1})
    assert res.counters["shed"] == 0 and res.counters["deferred"] > 0


def test_counters_partition_offered_ops():
    """Two runs back to back on the same clusters."""
    t = make_twin()
    for frac in (0.25, 2.5):
        _, res = twin_run(t, load_frac=frac, cfg={"queue_capacity": 8})
        cnt = res.counters
        assert cnt["offered"] == (cnt["completed"] + cnt["shed"]
                                  + cnt["failed"] + cnt["censored"])


@pytest.mark.parametrize("kind", ("poisson", "bursty"))
def test_hedged_reads_fire_under_queueing(kind):
    t = make_twin()
    _, res = twin_run(t, load_frac=1.5, mix="read_only", kind=kind,
                      cfg={"hedge_after_s": 1e-3, "queue_capacity": 64})
    assert res.counters["hedges"] > 0


def test_priority_weights_and_one_class():
    t = make_twin()
    twin_run(t, load_frac=1.2, cfg={"priorities": 3, "queue_capacity": 8,
                                    "priority_weights": (1, 2, 5)})
    twin_run(t, load_frac=1.2, seed=2, cfg={"priorities": 1,
                                            "keep_records": False})


def test_crash_retry_applies_exactly_once():
    """TestExactlyOnceAcrossCrash's armed log.pre_seal crash (also the
    stream of its req_index retirement test)."""
    t = make_twin(num_keys=800)
    plane, res = twin_run(t, load_frac=0.7, num_keys=800,
                          mix="write_heavy_update",
                          cfg={"max_retries": 3, "deadline_s": 0.05},
                          crash=(5, "log.pre_seal", 40))
    cnt = res.counters
    assert cnt["crashes"] >= 1 and cnt["retries"] > 0
    assert cnt["retired_reqs"] > 0
    assert not t.port.pool.verify_integrity()


def test_history_with_timeouts_retries_hedges_sheds():
    t = make_twin(num_kns=2, num_keys=12)
    plane, res = twin_run(t, load_frac=1.2, num_keys=12, duration=0.2,
                          mix="write_heavy_update",
                          cfg={"queue_capacity": 6, "deadline_s": 0.01,
                               "hedge_after_s": 2e-3, "op_scale": 2e-4,
                               "record_values": True},
                          crash=(2, "log.pre_seal", 20))
    cnt = res.counters
    assert cnt["crashes"] >= 1 and cnt["retries"] > 0 and cnt["shed"] > 0
    ops = plane.history()
    verdicts = tl.check_history(ops, initial=lambda k: f"v{k}")
    assert all(verdicts.values())


def test_failed_never_dispatched_writes_are_noops():
    t = make_twin(num_kns=2, num_keys=100)
    for c in t.clusters:
        for kn in c.kns.values():
            kn.alive = False
    plane, res = twin_run(t, load_frac=0.1, num_keys=100, duration=0.1,
                          cfg={"max_retries": 1, "backoff_s": 1e-3})
    assert res.counters["refused"] > 0
    assert res.counters["failed"] == res.counters["offered"]


def test_retire_reqs_drops_only_below_watermark():
    from repro.core.dpm_pool import DPMPool as JPool
    from repro_torch.core.dpm_pool import DPMPool as TPool
    got = []
    for P, kw in ((JPool, {}), (TPool, {"device": "cpu"})):
        pool = P(num_buckets=1 << 8, segment_capacity=16, **kw)
        pool.register_reqs([3, 7, 11, -1], [100, 101, 102, 103])
        got.append((pool.retire_reqs(8), dict(pool.req_index),
                    pool.retire_reqs(8)))
    assert got[0] == got[1] == (2, {11: 102}, 0)


def test_run_open_loop():
    """TestRunOpenLoop: TimedSimulation.run_open_loop on twins."""
    t = make_twin()
    sims, results = [], []
    for side, c in zip(("ref", "port"), t.clusters):
        netm, rp, sc, fm, W, simm, _ = PKG[side]
        wl = W(num_keys=1500, zipf=0.99, mix=MIX, value_bytes=256, seed=0)
        sim = simm.TimedSimulation(c, wl.timed_batched,
                                   model=netm.DEFAULT_MODEL, dt=1.0,
                                   sample_ops=10)
        cap = sc.estimated_capacity(netm.DEFAULT_MODEL, 4, MIX,
                                    value_bytes=256)
        res = sim.run_open_loop(0.2, netm.ArrivalProcess(rate=0.3 * cap))
        assert res.events is sim.event_log
        sims.append(sim)
        results.append(plain((res.row(), res.records, res.events,
                              sim.now, sim.rng.bit_generator.state)))
    assert results[0] == results[1]
    assert sims[1].event_log[-1]["kind"] == "open_loop_done"
    t.check()
