# Hand-written CUDA kernels for the DPM data plane (csrc/*.cu, built by
# _build.py), each behind a torch wrapper with a plain torch version in
# the package's ref.py:
#   clht_probe  index probe (kernel A) and probe + value gather (kernel B)
#   log_merge   in-order merge of log entries into bucket lines (kernel C)
# The sequential insert (kernel D) sits behind core.clht.clht_insert.
