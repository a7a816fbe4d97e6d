"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only
when the caller asks for it; a CUDA request on a machine without a
usable card raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (CUDA with its index); raises when
    CUDA is requested and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # an explicit index: worker threads pin it with set_device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
