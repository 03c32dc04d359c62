"""The one generator every traffic mix is read by: task batches made on the
device and LITE's H scores, each a pure function of the seed and the mix's
parameters (``bench/traffic/*.json``).  Every seed draws the same shapes:
runs with different seeds differ by the system's noise, not the work's.

Images follow ``repro_torch.data.episodic.task_batch_at``'s recipe, written
again here: per class a (size/4, size/4, C) normal pattern, upsampled
bilinearly and scaled to RMS ``class_sep``, and per image the pattern plus
``noise`` times unit normals.
"""
from __future__ import annotations

from typing import Dict, List

from harness.weights import sub_seed


def _generator(torch, seed: int, stream: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def _patterns(torch, gen, lead, size: int, channels: int, class_sep: float, device):
    """(*lead, size, size, C) class patterns, RMS ``class_sep`` over the
    last three axes and the one before them (a task's classes)."""
    small = torch.randn(tuple(lead) + (size // 4, size // 4, channels), generator=gen,
                        device=device)
    x = small.reshape((-1, size // 4, size // 4, channels)).permute(0, 3, 1, 2)
    x = torch.nn.functional.interpolate(x, size=(size, size), mode="bilinear",
                                        align_corners=False, antialias=False)
    base = x.permute(0, 2, 3, 1).reshape(tuple(lead) + (size, size, channels))
    rms = torch.sqrt(torch.mean(base ** 2, dim=(-4, -3, -2, -1), keepdim=True) + 1e-8)
    return class_sep * base / rms


def train_batches(torch, traffic: Dict, image_size: int, channels: int, seed: int,
                  device) -> List[Dict]:
    """``pool_batches`` task batches of ``tasks_per_step`` tasks, each task
    ``way * shot`` support images in a random order and ``way *
    query_per_class`` queries class by class: dicts of support_x (T, N, H,
    W, C), support_y (T, N), query_x (T, M, H, W, C), query_y (T, M)."""
    t, way = traffic["tasks_per_step"], traffic["way"]
    shot, qpc = traffic["shot"], traffic["query_per_class"]
    out = []
    for b in range(traffic["pool_batches"]):
        gen = _generator(torch, seed, 100 + b, device)
        base = _patterns(torch, gen, (t, way), image_size, channels, traffic["class_sep"],
                         device)

        def draw(per):
            x = base[:, :, None] + traffic["noise"] * torch.randn(
                (t, way, per, image_size, image_size, channels), generator=gen, device=device)
            y = torch.arange(way, device=device).repeat_interleave(per).expand(t, -1)
            return x.reshape((t, way * per, image_size, image_size, channels)), y

        sx, sy = draw(shot)
        qx, qy = draw(qpc)
        perm = torch.argsort(torch.rand(sy.shape, generator=gen, device=device), dim=1)
        lanes = torch.arange(t, device=device)[:, None]
        out.append(dict(support_x=sx[lanes, perm], support_y=sy[lanes, perm].contiguous(),
                        query_x=qx, query_y=qy.contiguous()))
        del base, sx, qx
    return out


def h_scores(torch, seed: int, step: int, shape) -> "torch.Tensor":
    """Step ``step``'s (T, N) scores on the host: each task's H subset is
    its ``lite_h`` lowest-scored support examples."""
    gen = torch.Generator()
    gen.manual_seed(sub_seed(seed, 2, step))
    return torch.rand(shape, generator=gen)
