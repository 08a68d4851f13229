"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None. Raises when the card is asked
    for (or defaulted to) and there is none: an entry point runs on the CPU
    only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); "
                           "pass device='cpu' to run on the CPU")
    return dev
