"""Port parity on tests/test_ownership_reconfig.py's streams: the
low-vnode join that must merge every participant (fig. 6's vnode count),
on twin clusters (the reference's and the port's, ``device="cpu"``);
``snapshot_blob`` / ``from_blob`` equal to the reference's blobs, through
JSON too, each package rebuilding from the other's blob; and
``_repair_replicas`` after failures (TestReplicaRepair) on twin ownership
maps. After every step the maps (ring, replication, fences, version,
blob) and the routing of a key sample are equal; the clusters' whole
states too. Exact comparisons."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ownership import OwnershipMap as JMap  # noqa: E402
from repro_torch.core.ownership import OwnershipMap as TMap  # noqa: E402
from test_ownership_reconfig import exact_moved  # noqa: E402
from torch_plane_cases import Twin  # noqa: E402

KEYS = np.random.default_rng(1).integers(0, 1 << 62, 3000)


def map_state(m) -> dict:
    ids, names = m.primary_ids(KEYS)
    return {"ring": (list(m.ring._points), list(m.ring._owners)),
            "members": m.ring.members, "replicated": m.replicated,
            "fence": m.fence, "version": m.version,
            "blob": m.snapshot_blob(),
            "primary": (ids.tolist(), list(names)),
            "owners": [m.owners(int(k)) for k in KEYS[:500]],
            "factors": {k: m.replication_factor(k) for k in m.replicated}}


def assert_maps_equal(a, b) -> None:
    sa, sb = map_state(a), map_state(b)
    for k in sa:
        assert sa[k] == sb[k], k


def test_cluster_reconfig_low_vnodes_merges_every_participant():
    t = Twin("dinomo", num_kns=5, cache_bytes=1 << 18, value_bytes=256,
             num_buckets=1 << 10, vnodes=8, seed=3)
    t.load(800, warm=True)
    t.check()
    evs = []
    for c in t.clusters:
        old = c.ownership.ring.snapshot()
        name, ev = c.add_kn()
        assert exact_moved(c.ownership.ring, old) <= ev.participants
        for p in ev.participants:
            if p == name or p not in c.kns:
                continue
            kn = c.kns[p]
            assert kn.cache.num_values + kn.cache.num_shortcuts == 0
            assert len(kn.segcache) == 0
        evs.append((name, ev.kind, ev.node, sorted(ev.participants),
                    ev.old_version, ev.new_version))
    assert evs[0] == evs[1]
    t.check()
    assert_maps_equal(t.ref.ownership, t.port.ownership)


def replicated_map(M, seed=0):
    """TestSnapshotRoundTrip._replicated_map in package ``M``."""
    m = M(vnodes=16)
    for i in range(5):
        m.add_kn(f"kn{i}")
    rng = np.random.default_rng(seed)
    for key in rng.integers(0, 10_000, 12).tolist():
        m.replicate(int(key), int(rng.integers(2, 5)))
    return m


@pytest.mark.parametrize("seed", (0, 2, 5))
def test_snapshot_blobs_match_the_reference(seed):
    a, b = replicated_map(JMap, seed), replicated_map(TMap, seed)
    assert_maps_equal(a, b)
    assert a.snapshot_blob() == b.snapshot_blob()
    # each package rebuilds from either blob, directly and through JSON
    for blob in (a.snapshot_blob(), b.snapshot_blob()):
        for form in (blob, json.loads(json.dumps(blob))):
            ra, rb = JMap.from_blob(form), TMap.from_blob(form)
            assert_maps_equal(ra, rb)
            assert_maps_equal(rb, b)


def test_cluster_persists_snapshot_on_reconfig():
    t = Twin("dinomo", num_kns=3, cache_bytes=1 << 18, value_bytes=256,
             num_buckets=1 << 10, seed=0)
    t.load(200)
    for c in t.clusters:
        c.add_kn()
    t.check()
    blobs = [c.pool.policy_metadata["ownership"] for c in t.clusters]
    assert blobs[0] == blobs[1]
    assert_maps_equal(JMap.from_blob(blobs[0]), TMap.from_blob(blobs[1]))
    assert TMap.from_blob(blobs[1]).ring.members == \
        t.port.ownership.ring.members


def map_with_replica(M, key, factor):
    """TestReplicaRepair._map_with_replica in package ``M``."""
    m = M(vnodes=16)
    for i in range(4):
        m.add_kn(f"kn{i}")
    owners = m.replicate(key, factor)
    return m, owners


def repair_streams():
    """TestReplicaRepair's four streams, as functions of (map, owners)."""

    def failed_secondary(m, owners):
        m.remove_kn(owners[1], failed=True)

    def failed_primary(m, owners):
        m.remove_kn(owners[0], failed=True)

    def degenerate(m, owners):
        for o in owners:
            if len(m.ring.members) > 1:
                m.remove_kn(o, failed=True)

    def post_failure(m, owners):
        m.remove_kn(owners[1], failed=True)

    return [("failed_secondary", 42, 3, failed_secondary),
            ("failed_primary", 7, 3, failed_primary),
            ("degenerate", 9, 2, degenerate),
            ("post_failure_snapshot", 11, 3, post_failure)]


@pytest.mark.parametrize("name, key, factor, stream", repair_streams(),
                         ids=[s[0] for s in repair_streams()])
def test_replica_repair_matches_the_reference(name, key, factor, stream):
    (a, oa), (b, ob) = (map_with_replica(M, key, factor)
                        for M in (JMap, TMap))
    assert oa == ob
    assert_maps_equal(a, b)
    evs = []
    for m, owners in ((a, oa), (b, ob)):
        stream(m, owners)
        for k, reps in m.replicated.items():
            assert reps[0] == m.primary(k)
            assert all(o in m.ring for o in reps)
        evs.append(m.snapshot_blob())
    assert evs[0] == evs[1]
    assert_maps_equal(a, b)
    # a map rebuilt from the port's blob routes as the survivors do
    assert_maps_equal(TMap.from_blob(b.snapshot_blob()), a)
