from .sharding import (MeshRules, NamedSharding, batch_shardings, batch_spec,
                       cache_sharding, cache_shardings, make_rules,
                       param_shardings, param_spec, replicated)
