from .decode_attention import paged_decode_attention
from .ops import merge_partials, paged_decode, paged_decode_partial
from .ref import normalize, paged_decode_ref
