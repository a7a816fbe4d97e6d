"""Kernels of the serving path (attention and the quantized matmul):
each wrapper launches its CUDA kernel for tensors on the card and runs
its plain PyTorch version for tensors on the CPU."""
