"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it raises when there is none, so that no entry
    point silently carries on on the CPU.  The CPU is used only when the
    caller names it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
