from .log_merge import log_merge, log_merge_sorted, sort_by_bucket
from .ops import log_append_merge, merge_segment_fast, unpack_table
from .ref import (log_append_merge_ref, log_merge_ref, log_merge_sorted_ref,
                  merge_window_plan_ref)
