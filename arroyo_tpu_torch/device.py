"""Device resolution for the port's entry points.

``LocalRunner`` and ``KeyedBinState`` take ``device=None``, which means
the CUDA device.  A caller who wants the host passes ``device="cpu"``
(the CPU tests do).  Asking for CUDA on a machine without it raises: the
port never moves to the CPU on its own, so a run that claims the card
really ran there."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
