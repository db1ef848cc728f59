"""Small-matrix math and the hand-written CUDA kernels, each beside its
plain PyTorch version."""
