"""The DINOMO cluster and the DPM structures under it: the cluster's
host engine for the DAC variants (cluster.py), the DPM pool
(dpm_pool.py) over the CLHT index (clht.py) and the log segment and
value heap (log.py), the KN caches (dac.py), ownership (ownership.py,
hashring.py), the M-node policy (mnode.py) and the cost model
(netmodel.py).

The exports below load on first use: the kernels import ``core.clht``,
and the cluster imports the kernels through its pool."""

import importlib

_EXPORTS = {
    "cluster": ("DinomoCluster", "VariantConfig", "BatchResult", "DINOMO",
                "DINOMO_S", "DINOMO_N", "CLOVER", "VARIANTS"),
    "mnode": ("Action", "EpochStats", "PolicyConfig", "PolicyEngine"),
    "netmodel": ("NetModel", "DEFAULT_MODEL"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_HOME)


def __getattr__(name):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
