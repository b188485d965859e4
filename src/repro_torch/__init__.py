"""PyTorch + CUDA port of the DINOMO reproduction (the JAX package
``repro`` is its reference). This slice holds the DPM data plane: the
CLHT index, the log segment and the value heap, with hand-written Hopper
kernels for the probe, the fused lookup, the log merge and the
sequential insert."""
