# Hand-written CUDA kernels (csrc/*.cu, built by _build.py), each behind a
# torch wrapper with a plain torch version in the package's ref.py:
#   clht_probe        index probe (kernel A) and probe + value gather (B)
#   log_merge         in-order merge of log entries into bucket lines (C)
#   flash_attention   prefill attention (kernel 5)
#   decode_attention  paged decode attention partials (kernel 6)
#   ssd_scan          Mamba2 chunked SSD scan (kernel 7)
#   cache_transition  the DAC window planner's space machine (kernel 4)
#   batch_executor    one KN window of the DAC state machine (kernel E)
# The sequential insert (kernel D) sits behind core.clht.clht_insert.
