"""The system under test, built from a configuration file: the port's
learner over its conv backbone, nothing else."""
from __future__ import annotations

from typing import Dict

# what every block and the readout of ``models/conv_backbone.py`` are
PORT_BLOCK = (3, 2, False, "global_mean_linear")


def make_learner(cfg: Dict):
    from repro_torch.core.meta_learners import MetaLearnerConfig
    from repro_torch.core.meta_learners import make_learner as _make
    from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
    ln, bb = cfg["learner"], cfg["backbone"]
    if (bb["kernel"], bb["pool"], bb["batch_norm"], bb["readout"]) != PORT_BLOCK:
        raise ValueError(f"the port's conv backbone runs {PORT_BLOCK} (kernel, pool, "
                         f"batch_norm, readout), not the configuration's")
    mcfg = MetaLearnerConfig(kind=ln["kind"], way=ln["way"])
    bcfg = ConvBackboneConfig(in_channels=bb["in_channels"], widths=tuple(bb["widths"]),
                              feature_dim=bb["feature_dim"])
    return _make(mcfg, make_conv_backbone(bcfg))
