"""Host operations, plant matrices, and the fused engines with their
CUDA kernels."""
