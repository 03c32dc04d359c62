"""Batched serving example, the port of the JAX package's
``examples/serve_lm.py``: continuous-batching KV-cache decode of the arch's
smoke config through :class:`repro_torch.serve.engine.ServeEngine`.

    python -m repro_torch.examples.serve_lm --arch gemma2-2b --requests 6

It runs on ``--device`` (default ``cuda``: flash attention on every GQA
prefill layer, whisper's encoder layers included, the gmm kernel on every
MoE expert projection, the ssd_chunk kernel on every SSD chunk of a mamba2
or zamba2 prefill; it raises without a card unless ``--device cpu`` is
given).  Every family is served: the transformers (dense GQA, MoE, MLA),
mamba2, zamba2 and whisper (prefilled on zero frames, as the JAX engine
does).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.episodic import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs without a GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    api = get_api(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, n_slots=args.slots, max_seq=128)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=8).astype(np.int32),
                    max_new_tokens=args.max_new, temperature=args.temperature)
            for i in range(args.requests)]
    print(f"serving {len(reqs)} requests on {args.slots} slots "
          f"({cfg.name}, {cfg.family} cache) device={device}", flush=True)
    engine.run_to_completion(reqs)
    for r in reqs:
        print(f"  req {r.uid}: prompt={r.prompt.tolist()} -> {r.out_tokens}")
    if not all(r.done for r in reqs):
        raise RuntimeError(f"requests left unfinished: "
                           f"{[r.uid for r in reqs if not r.done]}")
    print("all requests complete", flush=True)


if __name__ == "__main__":
    main()
