"""Where an entry point of the port runs: the card unless the caller names another device."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device of an entry point: the card unless the caller names another.

    ``None`` is ``"cuda"``; without a card that raises instead of carrying on
    on the CPU.  A CUDA device without an index is the current one.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ergo_uvo_tpu_torch runs on an NVIDIA GPU by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def upload(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To the card it goes from pinned memory
    without a wait, so it adds no host sync of its own."""
    x = torch.as_tensor(x)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)
