"""Device selection for the port's entry points.

Entry points run on the CUDA device by default. The CPU is used only when
the caller asks for it (``device="cpu"``), as the tests do; with no GPU
and no explicit request, the call raises instead of quietly running on
the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else is taken as given. A CUDA
    device without a visible GPU raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mallorn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev
