"""Attention kernels of the serving path: each wrapper launches its
CUDA kernel for tensors on the card and runs its plain PyTorch version
for tensors on the CPU."""
