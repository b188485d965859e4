"""Port parity for the scenario harness (repro_torch.core.scenarios
against repro.core.scenarios): every smoke-profile row of ``SCENARIOS``
for dinomo, dinomo-n and clover, and the fencing scenarios (partition,
zombie) for dinomo, with their events; the smoke overload run for dinomo
and clover, its phases and gates; ``estimated_capacity``,
``admitted_latency_bound`` and ``StormWorkload.timed_batched``; the
failure-timing and last-KN guards of tests/test_scenarios.py on twin
quiesced simulations; and one full-profile row, composed on dinomo at
seed 0, which ends with the reference's own post-recovery violation
(ROADMAP Queue 3): the port holds the same violation, naming the same
heap row. The port's runs build their clusters with ``device="cpu"``.
Exact comparisons. The reference's chaos matrix stays out of tier-1, as
the reference keeps it."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jf  # noqa: E402
from repro.core import mnode as jm  # noqa: E402
from repro.core import netmodel as jn  # noqa: E402
from repro.core import requestplane as jr  # noqa: E402
from repro.core import scenarios as js  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data import Workload as JWorkload  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import mnode as tm  # noqa: E402
from repro_torch.core import netmodel as tn  # noqa: E402
from repro_torch.core import requestplane as tr  # noqa: E402
from repro_torch.core import scenarios as ts  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.data import Workload as TWorkload  # noqa: E402
from torch_plane_cases import Twin, plain  # noqa: E402

BENCH_VARIANTS = ("dinomo", "dinomo-n", "clover")


def test_the_matrix_is_the_reference_s():
    assert ts.SCENARIOS == js.SCENARIOS
    assert ts.FENCE_SCENARIOS == js.FENCE_SCENARIOS
    assert ts.BENCH_VARIANTS == js.BENCH_VARIANTS == BENCH_VARIANTS
    assert dataclasses.asdict(ts.ScenarioConfig()) == \
        dataclasses.asdict(js.ScenarioConfig())
    assert dataclasses.asdict(ts.ScenarioConfig.smoke()) == \
        dataclasses.asdict(js.ScenarioConfig.smoke())


def rows_equal(a, b) -> None:
    assert plain(a.row()) == plain(b.row())
    assert a.events == b.events


@pytest.mark.parametrize("variant", BENCH_VARIANTS)
@pytest.mark.parametrize("scenario", js.SCENARIOS)
def test_smoke_scenario_matches_the_reference(scenario, variant):
    a = js.run_scenario(scenario, variant, seed=0, smoke=True)
    b = ts.run_scenario(scenario, variant, seed=0, smoke=True,
                        device="cpu")
    rows_equal(a, b)
    assert b.violations == []


@pytest.mark.parametrize("scenario", js.FENCE_SCENARIOS)
def test_smoke_fence_scenario_matches_the_reference(scenario):
    a = js.run_scenario(scenario, "dinomo", seed=0, smoke=True)
    b = ts.run_scenario(scenario, "dinomo", seed=0, smoke=True,
                        device="cpu")
    rows_equal(a, b)
    assert b.violations == []
    if scenario == "zombie":
        assert b.extra["zombie_fenced"] == b.extra["zombie_attempts"] > 0
        assert b.extra["linearizable"]


def test_named_crash_point_matches_the_reference():
    """An explicit crash point (rep.post_cas, forced) and another seed."""
    a = js.run_scenario("crash", "dinomo", seed=1, smoke=True,
                        crash_point="rep.post_cas")
    b = ts.run_scenario("crash", "dinomo", seed=1, smoke=True,
                        crash_point="rep.post_cas", device="cpu")
    rows_equal(a, b)


@pytest.mark.parametrize("variant", ("dinomo", "clover"))
def test_smoke_overload_matches_the_reference(variant):
    a = js.run_overload(variant=variant, seed=0, smoke=True)
    b = ts.run_overload(variant=variant, seed=0, smoke=True, device="cpu")
    assert plain(a.row()) == plain(b.row())
    assert plain(a.phases) == plain(b.phases)
    assert plain(a.gates) == plain(b.gates)
    assert a.passed == b.passed


def test_full_profile_composed_dinomo_holds_the_reference_fault():
    """bench_scenarios.py's profile (ScenarioConfig()): the reference
    ends with one post-recovery violation (a dead value row behind index
    key 7326; the row depends on PYTHONHASHSEED, through the order of a
    set of KN names). The port ends with the same one, row and all."""
    a = js.run_scenario("composed", "dinomo", seed=0)
    b = ts.run_scenario("composed", "dinomo", seed=0, device="cpu")
    rows_equal(a, b)
    assert len(b.violations) == 1
    assert b.violations[0].startswith(
        "post-recovery: index key 7326: dead value row ")
    assert b.crash_point == "rep.post_cas"


@pytest.mark.parametrize("mix", ("read_mostly_update", "write_heavy_update",
                                 "read_only"))
@pytest.mark.parametrize("kns", (1, 4, 7))
def test_estimated_capacity_matches_the_reference(kns, mix):
    for vb, rts in ((1024, 2.0), (256, 3.5)):
        assert js.estimated_capacity(jn.DEFAULT_MODEL, kns, mix, vb, rts) \
            == ts.estimated_capacity(tn.DEFAULT_MODEL, kns, mix, vb, rts)


@pytest.mark.parametrize("kw", ({}, {"deadline_s": 0.02, "max_retries": 2,
                                     "backoff_s": 1e-3, "round_s": 0.01}))
def test_admitted_latency_bound_matches_the_reference(kw):
    assert js.admitted_latency_bound(jr.RequestPlaneConfig(**kw)) == \
        ts.admitted_latency_bound(tr.RequestPlaneConfig(**kw))


def test_storm_workload_matches_the_reference():
    out = []
    for mod, W in ((js, JWorkload), (ts, TWorkload)):
        base = W(num_keys=1000, zipf=0.99, mix="read_mostly_update",
                 value_bytes=64, seed=0)
        w = mod.StormWorkload(base, base.hot_keys(4), frac=0.6, t0=10.0,
                              t1=20.0)
        rng = np.random.default_rng(0)
        got = [w.timed_batched(t, rng, 4000) for t in (5.0, 15.0, 25.0)]
        out.append((plain(got), rng.bit_generator.state))
    assert out[0] == out[1]


def test_unknown_scenario_rejected_as_the_reference():
    msgs = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.run_scenario("earthquake", "dinomo", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------- tests/test_scenarios.py guards
NO_OPS = lambda t, rng, n: []  # noqa: E731  (timing tests never sample)
PKG = {"ref": (jsim, jn, jf, jm), "port": (tsim, tn, tf, tm)}


def quiesced(variant, num_kns=4, model=None, faults=None):
    """test_scenarios.py:quiesced_sim on twins: a loaded, fully merged
    cluster with a simulation that never samples. ``model`` and
    ``faults`` take the package's module."""
    t = Twin(variant, num_kns=num_kns, cache_bytes=1 << 18,
             value_bytes=256, num_buckets=1 << 10, segment_capacity=64)
    t.load(200)
    sims = []
    for c, side in zip(t.clusters, ("ref", "port")):
        simm, netm, fm, _ = PKG[side]
        m = model(netm) if model else netm.DEFAULT_MODEL
        c.model = m
        sims.append(simm.TimedSimulation(
            c, NO_OPS, model=m, dt=1.0, sample_ops=10,
            faults=faults(fm) if faults else None))
    return t, sims


def assert_twins(t, sims) -> None:
    assert plain(sims[0].event_log) == plain(sims[1].event_log)
    assert plain(sims[0].outages) == plain(sims[1].outages)
    t.check()


@pytest.mark.parametrize("variant, model, faults", [
    ("dinomo", lambda m: dataclasses.replace(m.DEFAULT_MODEL, detect_s=0.2,
                                             handoff_s=0.3), None),
    ("clover", lambda m: dataclasses.replace(m.DEFAULT_MODEL, detect_s=0.2,
                                             clover_refresh_s=0.7), None),
    ("dinomo", None, lambda f: f.FaultPlane(seed=0, heartbeat_delay_s=0.5)),
    ("dinomo-n", None, None),
], ids=["dinomo-window", "clover-window", "heartbeat-delay", "dinomo-n"])
def test_failure_windows_match_the_reference(variant, model, faults):
    t, sims = quiesced(variant, model=model, faults=faults)
    windows = [sim.inject_failure(sorted(sim.c.kns)[0]) for sim in sims]
    assert windows[0] == windows[1]
    assert_twins(t, sims)


def test_last_kn_guards_match_the_reference():
    t, sims = quiesced("dinomo", num_kns=1)
    for sim in sims:
        (name,) = sim.c.kns
        assert sim.inject_failure(name) == 0.0
        assert sim.inject_failure("kn-nope") == 0.0
    assert_twins(t, sims)
    t, sims = quiesced("dinomo", num_kns=2)
    for sim, side in zip(sims, ("ref", "port")):
        a, b = sorted(sim.c.kns)
        sim.inject_failure(a)
        sim._apply(PKG[side][3].Action("remove_kn", node=b))
        assert sim.c.kns[b].alive
    assert_twins(t, sims)
    assert [e["kind"] for e in sims[1].event_log] == ["kn_failed",
                                                       "refused"]
