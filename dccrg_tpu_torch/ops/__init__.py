"""Device kernels: hand-written CUDA with plain PyTorch twins."""
