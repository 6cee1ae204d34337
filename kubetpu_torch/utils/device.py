"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument.  The default is the CUDA
card; the CPU runs only when the caller names it (the tests do), and a
missing card raises instead of quietly falling back.

Float32 matrix products and convolutions stay in full float32: the
placement contract is bitwise, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on: ``cuda`` unless the
    caller asks for something else; raises when CUDA is asked for (or
    defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubetpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def copy_to(x, device) -> torch.Tensor:
    """A copy of a numpy array or tensor on ``device`` — never a view of
    the source, so neither side's later in-place update reaches the
    other."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return torch.tensor(np.asarray(x), device=device)
