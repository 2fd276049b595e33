"""Device and dtype policy for ``repro_torch``.

* Every public entry point takes ``device=`` and defaults to ``"cuda"``.
  When no card is present and the caller did not ask for the CPU,
  ``resolve_device`` raises ``RuntimeError`` — there is no silent CPU
  path. Tests pass ``device="cpu"``.
* Values are float32 (``FLOAT``), picks and indices int32 (``INDEX``).
* float32 matrix products and convolutions run in full float32: TF32 is
  switched off for both cuBLAS and cuDNN when this module is imported.
"""

from __future__ import annotations

import contextlib
from typing import Union

import numpy as np
import torch

FLOAT = torch.float32
INDEX = torch.int32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names a CUDA device and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch entry point asked for device {str(dev)!r} but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU explicitly")
    return dev


def as_float(x, device: DeviceLike) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested sequence) as a float32 tensor
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=FLOAT)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def canonical_device(device: DeviceLike) -> torch.device:
    """``device`` resolved (``RuntimeError`` for a card that is not there)
    with a CUDA index filled in, so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_context(device: torch.device):
    """The context a shard's work runs in: its card's for a CUDA device
    (so that per-device choices such as phase 2's route are that card's),
    none on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
