"""kaito-tpu's serving engine in PyTorch and CUDA, for NVIDIA Hopper.

A port of ``kaito_tpu.engine`` that keeps its layout and names: the
same ``EngineConfig`` surface, paged KV pool (page 0 is the null page),
scheduler and OpenAI HTTP API.  Plain tensor work is PyTorch; the
attention kernels the JAX package wrote in Pallas for the TPU are CUDA
C++ kernels for ``sm_90a`` under ``csrc/``, built at first use with
``nvcc`` (``kaito_tpu_torch.ops.build``).

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``kaito_tpu``.  Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU.
"""
