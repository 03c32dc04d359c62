"""A cell cut to a size the CPU runs in seconds (32 px, a few dozen
images), and the run's arguments, for the tests."""
from __future__ import annotations

import argparse
import copy

from harness import common

TRAIN = dict(image_size=32, shot=5, query_per_class=2, lite_h=8, lite_chunk=16,
             pool_batches=3, steps_per_call=2)


def small_cell(workload: str) -> common.Cell:
    cell = copy.deepcopy(common.load_cell(workload))
    cell.config["image_size"] = TRAIN["image_size"]
    cell.traffic.update({k: v for k, v in TRAIN.items() if k in cell.traffic})
    return cell


def args(workload: str, seed: int = 7, seconds: float = 1.0, trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
