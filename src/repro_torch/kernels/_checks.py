"""Argument checks shared by the kernel wrappers: the kernels take only
contiguous CUDA tensors of the stated dtypes, shapes and one device."""
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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
