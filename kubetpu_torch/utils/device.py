"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument.  The default is the CUDA
card; the CPU runs only when the caller names it (the tests do), and a
missing card raises instead of quietly falling back.

Float32 matrix products and convolutions stay in full float32: the
placement contract is bitwise, and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

from typing import List, Sequence, Union

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


def upload_packed(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Copies of several small numpy arrays on ``device`` through ONE
    host->device copy: the arrays are packed into one byte buffer (each
    segment 16-byte aligned), copied once, and viewed back at their
    dtypes and shapes.  A pageable copy is synchronous, so a cycle's
    ~26 delta tables as separate copies would wait ~26 times."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    buf = np.zeros((max(total, 16),), np.uint8)
    for a, off in zip(arrays, offs):
        buf[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = torch.from_numpy(buf).to(device)
    out = []
    for a, off in zip(arrays, offs):
        dt = torch.from_numpy(np.zeros((0,), a.dtype)).dtype
        seg = dev[off:off + a.nbytes]
        out.append(seg.view(dt).reshape(a.shape) if a.size
                   else torch.zeros(a.shape, dtype=dt, device=device))
    return out


def shard_copy(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` for another shard of a mesh (parallel/mesh.py):
    every call counts in ``shard_copy.copies``, and one that crosses
    devices in ``shard_copy.cross_device``.  The copy is synchronous
    (non_blocking=False): a copy between two cards waits for the work
    queued on both cards' current streams, so a shard never reads a
    piece its producer has not finished.  On a shared device it returns
    ``x`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shard_copy.copies += 1
    if x.device != device:
        shard_copy.cross_device += 1
    return x.to(device, non_blocking=False)


shard_copy.copies = 0
shard_copy.cross_device = 0
