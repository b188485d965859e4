"""The paged KV store (page pool, controller, per-owner decode) and the
prefix cache of the serving path."""
from .paged_store import (PagedKVController, PagePool, Sequence,
                          decode_over_owners, pool_append, pool_init)
from .prefix_cache import PrefixCache, PrefixNode
