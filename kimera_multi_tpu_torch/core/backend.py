"""Device detection for kernel-path selection.

Counterpart of the JAX package's core/backend.py: the hand-written CUDA
kernels engage whenever a tensor lies on the card; the plain PyTorch
versions run only for tensors on the CPU.
"""

from __future__ import annotations

import time

import torch


def has_cuda() -> bool:
    """True when a CUDA device is visible to this process."""
    return torch.cuda.is_available()


def kernel_path() -> str:
    """Name of the path the kernels take by default — "cuda" (hand-written
    kernels) when a card is present, else "torch" (plain versions)."""
    return "cuda" if has_cuda() else "torch"


def default_device() -> torch.device:
    """The device entry points run on unless told otherwise: the card."""
    return resolve_device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. Asking for the card where there is none
    raises: nothing carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def synced_clock(device) -> float:
    """`time.perf_counter()` once the work queued on `device` is done (a
    host clock read on a card must wait for it)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
