from .clht_probe import clht_probe, kvs_lookup_fused, pack_table
from .ops import kvs_lookup, lookup, lookup_walk
from .ref import clht_probe_ref, kvs_lookup_fused_ref, kvs_lookup_ref
