"""Where the port's entry points run: the card unless the caller asks for
the CPU. A CUDA device that is not there raises; nothing falls back."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` ("cuda", "cuda:N", "cpu" or a torch.device) as a
    torch.device with its index set; raises RuntimeError for CUDA without
    a card and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r}: no CUDA device is available; "
                "pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def constants_on(device: torch.device, *arrays) -> tuple[torch.Tensor, ...]:
    """Numpy arrays uploaded to ``device`` as kernel constants. On a card
    the upload is waited for: it runs on whatever stream is current, and
    the constants are then read from other streams (the engine's, each
    mesh shard's), which a copy still in flight would race."""
    out = tuple(torch.from_numpy(a).to(device) for a in arrays)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out
