"""Where the port's tensors live: the card, unless the caller asks for the
CPU. Nothing quietly lands on the CPU because there is no GPU."""

from __future__ import annotations

import torch

CUDA = torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for the card where torch
    has no CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the card "
                           "unless given device='cpu'")
    return device


def as_tensor_on(a, device) -> torch.Tensor:
    """``a`` as a tensor: a tensor keeps its own device, anything else
    (numpy arrays, lists) goes to ``device``, row-major contiguous whatever
    the array's own layout (a column selection of a numpy table is not;
    the CUDA kernels take contiguous inputs). Asking for the card where
    torch has no CUDA device raises; nothing quietly lands on the CPU."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=resolve(device)).contiguous()


def points_like(a, X: torch.Tensor) -> torch.Tensor:
    """Query points ``a`` as an at least 2-D tensor in the dtype and on the
    device of the training inputs ``X``, row-major contiguous (a transposed
    numpy grid is not; the CUDA kernels take contiguous inputs)."""
    return torch.atleast_2d(torch.as_tensor(
        a, dtype=X.dtype, device=X.device)).contiguous()
