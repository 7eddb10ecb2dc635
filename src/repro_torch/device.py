"""Device selection for the port's entry points.

Every entry point resolves its ``device`` argument here: ``cuda`` is the
default, ``cpu`` is an explicit request (the CPU tests make it), and asking
for ``cuda`` where there is no GPU raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if CUDA is asked for but absent.

    Also turns TF32 off for matmuls and cuDNN: the JAX reference computes in
    full fp32, and TF32 keeps about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
