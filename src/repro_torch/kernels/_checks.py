"""Argument checks shared by the kernel wrappers: the kernels take only
contiguous CUDA tensors of the stated dtypes, shapes and one device; and
whether TMA can read a tensor, which the route choices ask."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, t: torch.Tensor, ndim: int,
                 dtypes: Sequence[torch.dtype], device: torch.device) -> None:
    require(isinstance(t, torch.Tensor), f"{name}: expected a tensor")
    require(t.device.type == "cuda", f"{name}: the kernel takes CUDA tensors, got {t.device}")
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dim() == ndim, f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    require(t.dtype in dtypes, f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    require(t.is_contiguous(), f"{name}: must be contiguous")


def tma_ready(*ts: torch.Tensor) -> bool:
    """Whether TMA can read every tensor: 16-byte-aligned base addresses,
    and every stride but the innermost (one element) a multiple of 16
    bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])
               for t in ts)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
