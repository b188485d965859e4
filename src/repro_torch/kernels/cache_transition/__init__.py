from .cache_transition import OP_LANES, cache_transition, launch
from .ops import (CAUSES, Window, encode_window, gather_window,
                  miss_free_prefix, plan_window_transitions, twin_verdict)
from .ref import cache_transition_np, cache_transition_ref
