"""The F field planes that a rebuild kernel (B2 in ``migrate_cuda``, B6 in
``migrate_cuda3``) reads, each through its own pointer.

Both wrappers take the planes in either of two forms: a sequence of
planes, read where they lie, or one stacked (F, ...) tensor, checked once
and addressed from its base. A view a plane of a stacked tensor would cost
host time of the order of the short kernels themselves.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import torch

Planes = Union[torch.Tensor, Sequence[torch.Tensor]]


def shaped(planes: Planes) -> List[Tuple[torch.Tensor, Tuple[int, ...]]]:
    """Each tensor to check, with the shape of one plane in it: a stacked
    tensor once, or every plane of a sequence."""
    if isinstance(planes, torch.Tensor):
        return [(planes, tuple(planes.shape[1:]))]
    return [(f, tuple(f.shape)) for f in planes]


def stacked(planes: Planes) -> torch.Tensor:
    """The planes as one (F, ...) tensor: the plain versions' input."""
    return planes if isinstance(planes, torch.Tensor) else torch.stack(list(planes))


def pointers(planes: Planes) -> ctypes.Array:
    """The planes' device addresses, F of them, for the launcher's array of
    plane pointers."""
    if isinstance(planes, torch.Tensor):
        step = planes.stride(0) * planes.element_size()
        ptrs = [planes.data_ptr() + k * step for k in range(planes.shape[0])]
    else:
        ptrs = [f.data_ptr() for f in planes]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)
