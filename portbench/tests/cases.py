"""Sizes and cells the CPU tests share."""

# small enough for the CPU and the port's plain versions: 2^10 records of
# 8 lanes, batches of 2^6
TINY = {"cfg": {"records_log2": 10, "buckets_log2": 10,
                "overflow_buckets_log2": 9, "segment_entries_log2": 10,
                "heap_rows_log2": 10, "value_lanes": 8},
        "traffic": {"batch_log2": 6, "key_batches": 4, "sample_batches": 3,
                    "warmup_batches": 2, "traced_batches": 3,
                    "warmup_loads": 1, "traced_loads": 1}}
CELLS = ("ycsb-32g-z099.read_only", "ycsb-32g-z099.load",
         "ycsb-32g-z05.read_only")
