"""The plain reference: the configuration's model and LITE training step in
plain PyTorch, one task at a time, in float32, written from the papers and
the configuration file alone.

* Conv backbone (Conv-4 of Snell et al. 2017, with the configuration's
  departures): per block a 3x3 SAME convolution, its bias, relu, a 2x2 max
  pool while the map is at least 2 x 2; then the spatial mean and a linear
  head.  Inputs NHWC, weights OIHW.
* ProtoNets (Snell et al. 2017): class means of the support features,
  logits the negative squared Euclidean distances of the query features to
  them.  The loss is the cross-entropy of the queries, the mean over
  queries and then over tasks.
* LITE (Bronskill et al. 2021, Eq. 8): the class sums over the support set
  are the exact sums in value, computed under ``no_grad`` in chunks, while
  their gradient is N / H times that of the H subset's sums.  H is the
  ``h`` lowest-scored support examples of the task.
* The step: the gradient of the mean loss, clipped to a global norm, one
  AdamW update with bias correction.

``lower`` (a dtype) runs every convolution and linear layer on operands
rounded to it, the rest in float32: the control, the reference put in the
program's place one precision below the configuration's.

Nothing here imports the program: the trees it reads are the benchmark's
own weights, inputs and scores.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_fp32():
    """float32 throughout: TF32 off for cuDNN and matmuls, the flags
    restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv(h, w, lower):
    if lower is None:
        return F.conv2d(h, w, padding=1)
    return F.conv2d(h.to(lower), w.to(lower), padding=1).float()


def _linear(h, w, b, lower):
    if lower is None:
        return h @ w + b
    return (h.to(lower) @ w.to(lower)).float() + b


def backbone(p: Dict, x: torch.Tensor, lower=None) -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    for blk in p["blocks"]:
        h = F.relu(_conv(h, blk["w"], lower) + blk["b"][:, None, None])
        if h.shape[2] >= 2 and h.shape[3] >= 2:
            h = F.max_pool2d(h, 2)
    return _linear(h.mean(dim=(2, 3)), p["head"]["w"], p["head"]["b"], lower)


def class_sums(params: Dict, x: torch.Tensor, y: torch.Tensor, way: int, lower=None):
    """(way, F) sums of the features of ``x`` by class ``y``."""
    f = backbone(params["bb"], x, lower)
    return F.one_hot(y, way).to(f.dtype).t() @ f


def adapt(cfg: Dict, params: Dict, sx: torch.Tensor, sy: torch.Tensor, h_idx: torch.Tensor,
          chunk: int, lower=None) -> Dict:
    """One task's class means under LITE (Bronskill et al. 2021, Eq. 8): the
    exact sums in value, computed under ``no_grad`` in chunks of ``chunk``
    images, with N / H times the gradient of the H subset ``h_idx``'s sums."""
    if cfg["learner"]["kind"] != "protonets":
        raise ValueError(f"the reference has ProtoNets only, not {cfg['learner']['kind']!r}")
    way, n = cfg["learner"]["way"], sx.shape[0]
    with torch.no_grad():
        full = sum(class_sums(params, sx[s:s + chunk], sy[s:s + chunk], way, lower)
                   for s in range(0, n, chunk))
    hv = class_sums(params, sx[h_idx], sy[h_idx], way, lower)
    s = full + (n / h_idx.numel()) * (hv - hv.detach())
    counts = torch.bincount(sy, minlength=way).to(torch.float32)
    return dict(mu=s / counts.clamp(min=1.0)[:, None])


def logits(cfg: Dict, params: Dict, state: Dict, qx: torch.Tensor, lower=None) -> torch.Tensor:
    """(M, way) logits of queries ``qx`` under an adapted state."""
    qf = backbone(params["bb"], qx, lower)
    return -((qf[:, None, :] - state["mu"][None]) ** 2).sum(-1)
