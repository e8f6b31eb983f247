"""The port's device rule: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Without a card, ``None`` raises instead of quietly running on the CPU:
    the plain PyTorch versions run there only when asked for by name.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def kernel_switch(flag: Optional[bool], device: Union[str, torch.device]) -> bool:
    """A kernel switch (``use_kernel``, ``use_update_kernel``) as a bool.

    ``None`` follows the tables' device: on for tables on the card, off on
    the CPU, where the wrappers would take their plain versions anyway.
    ``True`` or ``False`` is kept as given."""
    return torch.device(device).type == "cuda" if flag is None else bool(flag)


def numpy_dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.int32`` -> ``'int32'``).

    State fingerprints are shared with the JAX package, which prints its
    dtypes the numpy way."""
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def as_index_tensor(x, device: Optional[torch.device]) -> torch.Tensor:
    """Keys, chunks or indices (numpy uint32 or a tensor) as int64 on
    ``device``.  torch has no usable uint32 lanes, so the port's integer
    hashing runs in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)
