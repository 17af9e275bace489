"""Ops: convolution, norms, pooling and the hand-written CUDA kernels."""
