"""Host operations, plant matrices and the fused rollout with its CUDA
kernel."""
