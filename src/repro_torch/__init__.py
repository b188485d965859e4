"""PyTorch + CUDA port of the DINOMO reproduction (the JAX package
``repro`` is its reference). It holds the DPM data plane (the CLHT
index, the log segment and the value heap, with hand-written Hopper
kernels for the probe, the fused lookup, the log merge and the
sequential insert) and the paged LLM serving path (the dense
transformer, the paged KV store and its server, with hand-written
kernels for prefill attention and paged decode attention)."""
