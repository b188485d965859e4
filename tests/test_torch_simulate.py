"""Port parity for the timed simulation
(repro_torch.core.simulate.TimedSimulation against the reference's).

On twin clusters (the reference's and the port's, ``device="cpu"``): the
three streams of tests/test_system.py's TestTimedSimulation (autoscaling
over 100 s, the failure window, dinomo-n's slower failure) and a stream
that runs a join, removals with their outages, ``inject_failure`` under
a fault plane's delayed heartbeats, and ``scenarios._crash_and_recover``
with an armed crash point, by the batched and the per-op step. After each
the traces (every TimePoint field), the event log, the outages, the
M-node's decisions, the epoch's key frequencies and the clusters' whole
states are equal, the port's card copy of its index equal to its host
index.

In the port alone, the same stream by ``batched=False`` (``_step_scalar``)
against ``batched=True``, held to what the reference holds its own two
steps to (tests/test_dataplane.py's TestTimedSimEquivalence), and by
``engine="jit"`` against the host engine, exactly: after a join or
removal the participants' outages reach ``execute_batch`` as
``blocked_kns`` on the jit path, and the armed crash unwinds through a
jit batch."""

import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jf  # noqa: E402
from repro.core import mnode as jm  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data import Workload as JWorkload  # noqa: E402
from repro_torch.core import cluster as tcl  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import mnode as tm  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.data import Workload as TWorkload  # noqa: E402
from torch_cluster_cases import (cluster_state,  # noqa: E402
                                 mirror_equals_host)
from torch_plane_cases import (Twin, assert_sims_equal,  # noqa: E402
                               sim_state)

PKG = {"ref": (jsim, jm, JWorkload, jf, jsc),
       "port": (tsim, tm, TWorkload, tf, tsc)}


POLICY = {"grace_period_s": 10.0, "epoch_s": 5.0, "max_kns": 8}


def twin(variant, kns, with_policy=True) -> Twin:
    """test_system.py's cluster, as twins."""
    t = Twin(variant, num_kns=kns, cache_bytes=1 << 19, value_bytes=1024,
             num_buckets=1 << 13, segment_capacity=256,
             policy=POLICY if with_policy else None)
    t.load(3000)
    return t


def sims_of(t: Twin, wl_seed, mix=None, **kw):
    out = []
    for c, side in zip(t.clusters, ("ref", "port")):
        W = PKG[side][2]
        w = W(num_keys=3000, zipf=0.99, seed=wl_seed,
              **({"mix": mix} if mix else {}))
        out.append(PKG[side][0].TimedSimulation(c, w.timed, **kw))
    return out


def check(t: Twin, sims) -> None:
    assert_sims_equal(*sims, "twins")
    t.check()


def test_autoscale_up_and_down():
    t = twin("dinomo", 4)
    sims = sims_of(t, 2, mix="write_heavy_update", dt=1.0, sample_ops=400)
    for sim in sims:
        sim.run(100.0, lambda x: 8e6 if 15 <= x <= 70 else 2e5)
    check(t, sims)
    kns = [p.num_kns for p in sims[1].trace]
    assert max(kns) > 4 and kns[-1] < max(kns)


def test_failure_recovery_window():
    t = twin("dinomo", 8, with_policy=False)
    sims = sims_of(t, 3, dt=1.0, sample_ops=300)
    windows = []
    for sim in sims:
        sim.run(5.0, lambda x: 1e5)
        windows.append(sim.inject_failure(sorted(sim.c.kns)[0]))
        sim.run(10.0, lambda x: 1e5)
    assert windows[0] == windows[1] < 1.0
    check(t, sims)


def test_dinomo_n_failure_slower():
    windows = {}
    for variant in ("dinomo", "dinomo-n"):
        t = twin(variant, 8, with_policy=False)
        sims = sims_of(t, 3, dt=1.0, sample_ops=200, dataset_bytes=32e9)
        got = []
        for sim in sims:
            sim.run(3.0, lambda x: 1e5)
            got.append(sim.inject_failure(sorted(sim.c.kns)[0]))
        assert got[0] == got[1]
        check(t, sims)
        windows[variant] = got[1]
    assert windows["dinomo-n"] > 5 * windows["dinomo"]


def offered(x: float) -> float:
    """Low, then a peak the policy adds KNs for, then low again (the
    policy removes them)."""
    return 6e6 if 8 <= x <= 18 else 2e5


def drive(sim, side, faults, point="log.pre_seal", check_mirror=False,
          before_crash=None):
    """Joins and removals with their outages, a failure, an armed crash
    and its recovery; returns the crash's ScenarioResult. ``before_crash``
    is called with the simulation just before the crash."""
    sc = PKG[side][4]
    sim.run(30.0, offered)
    assert [r["event"] for r in sim.c.reconfig_log].count("add") >= 1
    assert [r["event"] for r in sim.c.reconfig_log].count("remove") >= 1
    sim.inject_failure(sorted(sim.c.kns)[1])
    if check_mirror:
        mirror_equals_host(sim.c.pool)
    sim.run(34.0, offered)
    res = sc.ScenarioResult(
        scenario="stream", variant=sim.c.variant.name, seed=0,
        crash_point=point, duration_s=40.0, recovery_window_s=None,
        min_tput_during_frac=None, zero_tput_epochs=0,
        membership_changes=0, replication_actions=0, flush_rts_dropped=0,
        recovery=None)
    if before_crash is not None:
        before_crash(sim)
    sc._crash_and_recover(sim, faults, point, offered, res)
    if check_mirror:
        mirror_equals_host(sim.c.pool)
    sim.run(40.0, offered)
    return res


def stream_sim(c, side, batched=True, engine=None):
    simm, _, W, fm, _ = PKG[side]
    faults = fm.FaultPlane(seed=4, heartbeat_delay_s=0.01,
                           heartbeat_jitter_s=0.01)
    c.pool.faults = faults
    w = W(num_keys=3000, zipf=0.99, mix="write_heavy_update", seed=5)
    sim = simm.TimedSimulation(c, w.timed_batched if batched else w.timed,
                               dt=1.0, sample_ops=600, batched=batched,
                               faults=faults, engine=engine)
    return sim, faults


@pytest.mark.parametrize("point", ("log.pre_seal", "merge.mid_apply"))
@pytest.mark.parametrize("batched", (True, False))
def test_reconfig_failure_and_crash_stream(batched, point):
    t = twin("dinomo", 4)
    rows = []
    sims = []
    for c, side in zip(t.clusters, ("ref", "port")):
        sim, faults = stream_sim(c, side, batched)
        rows.append(drive(sim, side, faults, point,
                          check_mirror=side == "port").row())
        sims.append(sim)
    assert rows[0] == rows[1]
    assert rows[1]["recovery"] is not None
    check(t, sims)


def port_cluster():
    c = tcl.DinomoCluster(tcl.VARIANTS["dinomo"], num_kns=4,
                          cache_bytes=1 << 19, value_bytes=1024,
                          num_buckets=1 << 13, segment_capacity=256,
                          policy=tm.PolicyConfig(**POLICY),
                          device="cpu")
    c.load(((k, f"v{k}") for k in range(3000)), warm=True)
    return c


def test_scalar_step_against_batched_step():
    """The reference's TestTimedSimEquivalence bar through joins,
    removals and a failure: the same times, KN counts, events,
    decisions, outages, reconfigurations and key frequencies, the
    throughputs and latencies within float rounding (the RT sums add in
    another order). Then an armed crash: the same victim, point and
    recovery, and the same timeline after it. The crash's failover may
    merge a different number of entries, as in the reference: the
    batched step stages its batch's writes before the point fires."""
    legs = [stream_sim(port_cluster(), "port", batched=b)
            for b in (False, True)]
    pre = []
    rows = [drive(sim, "port", faults, before_crash=lambda s: pre.append(
        (sim_state(s), [dict(r) for r in s.c.reconfig_log])))
        for sim, faults in legs]
    (a, ra), (b, rb) = pre
    for k in ("event_log", "outages", "now", "next_epoch", "freq",
              "decisions", "rng"):
        assert a[k] == b[k], k
    assert ra == rb
    n_pre = len(a["trace"])
    ta, tb = legs[0][0].trace, legs[1][0].trace
    assert len(ta) == len(tb)
    for i, (pa, pb) in enumerate(zip(ta, tb)):
        assert (pa.t, pa.num_kns, pa.offered, pa.events) == \
            (pb.t, pb.num_kns, pb.offered, pb.events)
        if i < n_pre:
            assert pa.throughput == pytest.approx(pb.throughput)
            assert pa.avg_latency == pytest.approx(pb.avg_latency)
            assert pa.p99_latency == pytest.approx(pb.p99_latency)
    for k in ("crash_point", "recovery", "violations", "events"):
        assert getattr(rows[0], k) == getattr(rows[1], k), k
    assert [r["event"] for r in legs[0][0].c.reconfig_log] == \
        [r["event"] for r in legs[1][0].c.reconfig_log]


@pytest.mark.parametrize("point", ("log.pre_seal", "merge.mid_apply"))
def test_jit_engine_against_host_engine(point):
    """engine="jit" step for step equal to the host engine, with
    blocked KNs on the jit path after every join and removal and an
    armed crash unwinding through a jit batch."""
    legs = {e: stream_sim(port_cluster(), "port", engine=e)
            for e in ("host", "jit")}
    blocked = []
    cj = legs["jit"][0].c
    real = cj.execute_batch

    def noting(*a, **kw):
        if kw.get("blocked_kns"):
            blocked.append(sorted(kw["blocked_kns"]))
        return real(*a, **kw)

    cj.execute_batch = noting
    res = {e: drive(sim, "port", faults, point, check_mirror=True)
           for e, (sim, faults) in legs.items()}
    assert res["host"].row() == res["jit"].row()
    assert res["host"].events == res["jit"].events
    # log.pre_seal fires inside a jit batch; merge.mid_apply is not
    # reached by this step, so _crash_and_recover forces it
    how = "crashed mid-batch" if point == "log.pre_seal" else "forced"
    assert any(how in e for e in res["jit"].events)
    assert blocked, "no step of the jit leg had a blocked KN"
    assert cj._jit is not None and cj._jit.counts["launches"] > 0
    assert_sims_equal(legs["host"][0], legs["jit"][0], "engines")
    a = cluster_state(legs["host"][0].c, heaps=False)
    b = cluster_state(cj, heaps=False)
    for k in a:
        assert a[k] == b[k], k
