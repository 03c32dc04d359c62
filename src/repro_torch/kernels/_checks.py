"""Argument checks shared by the kernel wrappers: the kernels take only
contiguous CUDA tensors (gmm: or transposed views of them) of the stated
dtypes, shapes and one device, and no tensor that autograd would follow;
and whether TMA can read a tensor, which the route choices ask."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch


def require(cond: bool, msg: Union[str, Callable[[], str]]) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``; a callable ``msg`` is
    called only then, so a passing check formats nothing."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def require_no_grad(name: str, *ts: Optional[torch.Tensor], missing: str = "") -> None:
    """Raise when grad mode is on and a tensor that requires grad reaches a
    kernel.  A kernel writes its result into a fresh ``torch.empty``
    through a foreign call, so autograd sees no ``grad_fn`` and would drop
    the gradient of everything upstream without a word.  The
    differentiable ops reach their kernels inside a
    ``torch.autograd.Function`` (:mod:`repro_torch.kernels.dispatch`),
    whose forward runs with grad mode off; every other caller must detach
    or run under ``torch.no_grad``.  ``missing`` names the Function that
    differentiates through the kernel, for the message."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: a tensor that requires grad reached the CUDA kernel "
            f"outside its autograd.Function; the kernel's output has no "
            f"grad_fn, so the gradient would be lost (call the op through "
            f"repro_torch.kernels.dispatch, or detach)"
            + (f"; {name}'s autograd.Function is {missing}" if missing else ""))


def check_tensor(name: str, t: torch.Tensor, ndim: int,
                 dtypes: Sequence[torch.dtype], device: torch.device,
                 transposed_ok: bool = False) -> None:
    """The messages are built only when a check fails: this runs on every
    kernel call.  ``transposed_ok``: the transpose of a contiguous tensor in
    the last two axes passes too (:func:`stored_transposed`)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor")
    on = t.device
    if on.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {on}")
    if on != device:
        raise ValueError(f"{name}: on {on}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    if not t.is_contiguous() and not (transposed_ok and stored_transposed(t)):
        raise ValueError(f"{name}: must be contiguous" + (
            " or the transpose of a contiguous tensor in its last two axes"
            if transposed_ok else ""))


def stored_transposed(t: torch.Tensor) -> bool:
    """Whether ``t`` is not contiguous but the transpose of its last two
    axes is: a view that reads a contiguous tensor as its transpose."""
    return not t.is_contiguous() and t.transpose(-2, -1).is_contiguous()


def tma_ready(*ts: torch.Tensor) -> bool:
    """Whether TMA can read every tensor: 16-byte-aligned base addresses,
    and every stride but the innermost (one element) a multiple of 16
    bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])
               for t in ts)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address, as the C entry points take it (their argument
    types are declared, so ctypes converts the int); None, a null pointer,
    for a missing tensor."""
    return None if t is None else t.data_ptr()


# the current stream's raw handle without building a Stream object, where
# this torch has the accessor its own kernel launchers use
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream."""
    if _raw_stream is not None:
        return _raw_stream(device.index if device.index is not None
                           else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream
