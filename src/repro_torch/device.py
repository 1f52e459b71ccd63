"""Device selection for the entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no card is
    present, so an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def expect(data, device) -> torch.device:
    """``resolve(device)``, and raise unless ``data`` (a ``CoxData`` or
    anything else with a ``device``) lies there: an entry point computes
    where it was asked to, never where its data happens to be."""
    dev = resolve(device)
    if data.device.type != dev.type:
        raise ValueError(f"data lies on {data.device}, the call was asked "
                         f"to run on {dev}; prepare it there")
    return dev
