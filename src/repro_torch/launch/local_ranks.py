"""Run the ranks of a small data-parallel world as processes of this host,
without ``torchrun`` and without a TCP port: each rank is one ``argv``
process with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` set, and ``RANKS_INIT_METHOD`` a ``file://`` store in
``store_dir`` for :func:`repro_torch.launch.mesh.init_distributed`'s
``init_method``.  Every rank has a time limit; when one exits non-zero the
others are killed at once, so a rank that dies never leaves its peers
waiting in a collective.

    outs = run_ranks([sys.executable, "-c", code], world=4, store_dir=tmp)
"""
from __future__ import annotations

import itertools
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

_STORES = itertools.count()


class RanksFailed(RuntimeError):
    """A rank exited non-zero or ran past the time limit."""


def run_ranks(argv: Sequence[str], world: int, store_dir, env: Optional[Dict] = None,
              timeout: float = 240.0, cwd=None,
              clock: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep) -> List[str]:
    """Run ``world`` copies of ``argv`` and return each rank's output
    (stdout and stderr), in rank order; raise :class:`RanksFailed` with the
    failing rank's output if one fails, after killing the rest."""
    os.makedirs(store_dir, exist_ok=True)
    init = f"file://{os.path.abspath(store_dir)}/pg_{os.getpid()}_{next(_STORES)}"
    base = dict(os.environ if env is None else env)
    procs = []
    for r in range(world):
        e = dict(base, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), RANKS_INIT_METHOD=init)
        log = open(os.path.join(store_dir, f"rank{r}.log"), "w+")
        procs.append((subprocess.Popen(list(argv), env=e, cwd=cwd, stdout=log,
                                       stderr=subprocess.STDOUT, text=True), log))
    deadline = clock() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit {procs[bad[0]][0].returncode}")
                break
            if clock() > deadline:
                failed = (next(r for r, (p, _) in enumerate(procs) if p.poll() is None),
                          f"still running after {timeout:.0f} s")
                break
            sleep(0.05)
        else:
            bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], f"exit {procs[bad[0]][0].returncode}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        for p, _ in procs:
            p.wait()
    outs = []
    for _, log in procs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is not None:
        r, why = failed
        raise RanksFailed(f"rank {r} of {world}: {why}\n{outs[r][-4000:]}")
    return outs
