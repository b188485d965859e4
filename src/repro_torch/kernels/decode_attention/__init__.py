from .decode_attention import (H100_SMS, TILE, head_block,
                               paged_decode_attention, split_bounds,
                               split_count)
from .ops import merge_partials, paged_decode, paged_decode_partial
from .ref import normalize, paged_decode_ref
