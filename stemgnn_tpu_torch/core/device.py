"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A missing
card is an error, never a silent slide to the CPU: a CPU run measures
PyTorch's CPU kernels and none of this package's CUDA kernels.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: stemgnn_tpu_torch runs on an NVIDIA GPU "
            "by default.  Pass device='cpu' (--device cpu on the command "
            "line) to run the plain PyTorch versions on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
