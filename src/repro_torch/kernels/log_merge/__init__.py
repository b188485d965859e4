from .log_merge import log_merge, log_merge_sorted, sort_by_bucket
from .ops import (apply_merge_plan_tables, log_append_merge,
                  merge_segment_fast, merge_segment_planned, unpack_table)
from .ref import (log_append_merge_ref, log_merge_ref, log_merge_sorted_ref,
                  merge_window_plan_ref)
