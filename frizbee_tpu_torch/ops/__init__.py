"""Device operations: stage-1 presence, the CUDA kernels and the batch path."""
