"""Device selection for the port's entry points: the card unless the caller
asks for the CPU; no silent CPU fallback.

Under ``torchrun`` (``LOCAL_RANK`` in the environment) or an initialized
process group, a bare ``"cuda"`` names this process's card,
``cuda:{LOCAL_RANK}``, which becomes the current device: one process a
card, as PyTorch's launcher starts them.  An explicit index (``"cuda:0"``)
is kept as it is given.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if device.type == "cuda" and device.index is None:
        rank = os.environ.get("LOCAL_RANK")
        if rank is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            rank = torch.distributed.get_rank() % torch.cuda.device_count()
        if rank is not None:
            device = torch.device("cuda", int(rank))
            torch.cuda.set_device(device)
    return device


def place(module: torch.nn.Module, device="cuda") -> torch.nn.Module:
    """``module`` moved to :func:`resolve_device`'s device and put in eval
    mode, as every entry point of the port starts; ``device=None`` leaves
    it where it is (a submodule that its model places)."""
    if device is not None:
        module.to(resolve_device(device))
        module.eval()
    return module
