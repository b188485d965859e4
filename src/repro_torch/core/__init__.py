"""The DINOMO cluster and the DPM structures under it: the cluster's
host engine for the DAC variants (cluster.py), the DPM pool
(dpm_pool.py) over the CLHT index (clht.py) and the log segment and
value heap (log.py), the KN caches (dac.py), ownership (ownership.py,
hashring.py), the M-node policy (mnode.py), the cost model and arrival
processes (netmodel.py), and the planes around the cluster: the timed
simulation (simulate.py), the open-loop request plane
(requestplane.py), the scenario harness (scenarios.py) and the
linearizability checker (linearizability.py).

The exports below load on first use: the kernels import ``core.clht``,
and the cluster imports the kernels through its pool."""

import importlib

_EXPORTS = {
    "cluster": ("DinomoCluster", "VariantConfig", "BatchResult", "DINOMO",
                "DINOMO_S", "DINOMO_N", "CLOVER", "VARIANTS"),
    "linearizability": ("Op", "check_history", "check_key_history"),
    "mnode": ("Action", "EpochStats", "PolicyConfig", "PolicyEngine"),
    "netmodel": ("NetModel", "DEFAULT_MODEL", "ArrivalProcess",
                 "PhasedArrival"),
    "requestplane": ("OpRecord", "RequestPlane", "RequestPlaneConfig",
                     "RequestPlaneResult"),
    "simulate": ("TimedSimulation",),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_HOME)


def __getattr__(name):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
