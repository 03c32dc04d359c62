"""Batched LM serving engine: continuous-batching KV-cache decode over the
model API, the port of the JAX package's ``repro/serve/engine.py`` with
its semantics.

A request joins by having its prompt prefilled into a batch-1 cache,
spliced into a slot's ``max_seq`` cache; it leaves on EOS or at its token
budget (the token sampled from the prefill's logits counts against it).
Active slots whose caches agree on the decode position are stacked into one
batched decode; ragged positions decode slot by slot.  The stacked cache of
an unchanged cohort stays resident across steps and is written back to the
slots only when the cohort changes.  Tokens are sampled in slot order:
greedy is ``argmax``; temperature sampling draws from an explicit
``torch.Generator`` seeded with ``seed`` (its draws are not the JAX
package's ``jax.random.categorical`` draws; the same seed gives the same
stream).

Prefill and decode run on ``kernel_backend`` (``auto``: the kernels on a
CUDA device: flash attention on every GQA prefill layer, zamba2's shared
block and both of whisper's stacks included, the gmm kernel on every MoE
expert projection, prefill and decode, the ssd_chunk kernel on every SSD
chunk of a mamba2 or zamba2 prefill).  A model with a frontend (whisper's
encoder, phi-3-vision's stub) is prefilled on zero frame embeddings, as
the reference engine does: whisper's encoder then gives exactly zero.
The matmul weights are cast to the compute dtype once, at construction
(the model API's ``compute_params``).
The episodic workload is served by
:class:`repro_torch.serve.episodic.EpisodicServeEngine`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import BACKENDS
from repro_torch.models.registry import get_api


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                   # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0             # 0 => greedy
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-device engine (batch = n_slots, one sequence each)."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_seq: int = 256, eos_id: Optional[int] = None,
                 seed: int = 0, batched_decode: bool = True,
                 kernel_backend: str = "auto"):
        if kernel_backend not in BACKENDS:
            raise ValueError(f"kernel_backend={kernel_backend!r} (want one of "
                             f"{BACKENDS})")
        self.cfg = cfg
        self.api = get_api(cfg)
        self.params = self.api.compute_params(params, cfg)
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.batched_decode = batched_decode
        self.kernel_backend = kernel_backend
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # per-slot caches (batch axis 1), so a prefill can be spliced into
        # one slot without touching the others
        self._caches = [self._empty_cache() for _ in range(n_slots)]
        self._reqs: List[Optional[Request]] = [None] * n_slots
        # resident stacked cache of an unchanged decoding cohort:
        # (active slot list, stacked cache); re-stacking copies every
        # slot's max_seq region, so it happens only when the cohort changes
        self._stacked: Optional[tuple] = None

    def _empty_cache(self) -> Dict:
        return self.api.init_cache(self.cfg, 1, self.max_seq, self.device)

    # -- scheduling ----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._reqs):
            if r is None:
                return i
        return None

    def add_request(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        self._flush_stacked()          # a splice changes the cohort
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None, :]
        batch = dict(tokens=tokens)
        if self.cfg.frontend is not None:
            batch["frontend_embeds"] = torch.zeros(
                (1, self.cfg.n_frontend_tokens, self.cfg.d_model),
                dtype=getattr(torch, self.cfg.compute_dtype), device=self.device)
        logits, cache = self.api.prefill(self.params, batch, self.cfg,
                                         backend=self.kernel_backend)
        self._caches[slot] = _splice_cache(self._empty_cache(), cache)
        self._reqs[slot] = req
        # the prefill-sampled token counts against the budget and may be
        # EOS: _commit retires the request (and frees the slot) if so
        self._commit(slot, logits)
        return True

    def _sample(self, logits: torch.Tensor, req: Request) -> List[int]:
        if req.temperature <= 0.0:
            return logits.argmax(dim=-1).reshape(-1).tolist()
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen).reshape(-1).tolist()

    # -- decode --------------------------------------------------------------

    def _stack_caches(self, caches: List[Dict]) -> Optional[Dict]:
        """The per-slot (batch 1) caches concatenated on the batch axis into
        one decode batch, or None: stacking needs every slot at the same
        decode position ``len`` (positions are shared across the batch) and
        leaves of one shape, and a ragged mix decodes per slot."""
        first = caches[0]
        if any(sorted(c) != sorted(first) for c in caches):
            return None
        if any(int(c["len"]) != int(first["len"]) for c in caches[1:]):
            return None
        out = {}
        for k in first:
            if k == "len":
                out[k] = first[k]
                continue
            leaves = [c[k] for c in caches]
            if any(t.dim() < 2 or t.shape != leaves[0].shape for t in leaves):
                return None
            out[k] = torch.cat(leaves, dim=1)
        return out

    @staticmethod
    def _unstack_cache(cache: Dict, n: int) -> List[Dict]:
        # copies, not views: decode writes its cache in place, so a slot's
        # cache must own its storage, apart from any stacked cohort
        return [{k: (v if k == "len" else v[:, j:j + 1].clone())
                 for k, v in cache.items()} for j in range(n)]

    def _flush_stacked(self) -> None:
        """Write the resident stacked cache back into the per-slot caches
        (whenever the decoding cohort is about to change)."""
        if self._stacked is None:
            return
        cohort, cache = self._stacked
        self._stacked = None
        for i, c in zip(cohort, self._unstack_cache(cache, len(cohort))):
            self._caches[i] = c

    def _commit(self, i: int, logits: torch.Tensor) -> None:
        """Sample and append the next token of slot ``i``; retire on EOS or
        at the token budget."""
        req = self._reqs[i]
        nxt = self._sample(logits, req)[0]
        req.out_tokens.append(nxt)
        if (len(req.out_tokens) >= req.max_new_tokens or
                (self.eos_id is not None and nxt == self.eos_id)):
            req.done = True
            self._reqs[i] = None

    def _tokens(self, slots: List[int]) -> torch.Tensor:
        return torch.tensor([[self._reqs[i].out_tokens[-1]] for i in slots],
                            dtype=torch.long, device=self.device)

    def step(self) -> int:
        """One decode step over the active slots: one stacked decode when
        their caches stack, the per-slot loop otherwise.  Returns the number
        of active slots."""
        active = [i for i, r in enumerate(self._reqs) if r is not None]
        if not active:
            return 0
        stacked = None
        if self.batched_decode and len(active) > 1:
            if self._stacked is not None and self._stacked[0] == active:
                stacked = self._stacked[1]         # unchanged cohort
            else:
                self._flush_stacked()
                stacked = self._stack_caches([self._caches[i] for i in active])
        else:
            self._flush_stacked()
        if stacked is not None:
            logits, new_cache = self.api.decode_step(self.params, stacked,
                                                     self._tokens(active), self.cfg,
                                                     backend=self.kernel_backend)
            self._stacked = (list(active), new_cache)
            # sample in slot order (the per-slot path's order too, so a
            # seeded run does not depend on the path)
            for j, i in enumerate(active):
                self._commit(i, logits[j:j + 1])
        else:
            for i in active:
                logits, self._caches[i] = self.api.decode_step(
                    self.params, self._caches[i], self._tokens([i]), self.cfg,
                    backend=self.kernel_backend)
                self._commit(i, logits)
        return len(active)

    def run_to_completion(self, requests: List[Request],
                          max_steps: int = 10000) -> List[Request]:
        pending = list(requests)
        steps = 0
        while (pending or any(r is not None for r in self._reqs)) \
                and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            self.step()
            steps += 1
        return requests


# leaves of a prefill cache that do not grow with the decoder's sequence:
# the SSM layers' states and whisper's cross k and v of the encoder's frames
_WHOLE_LEAVES = ("conv", "ssm", "cross_k", "cross_v")


def _splice_cache(full: Dict, pre: Dict) -> Dict:
    """Copy a prefill cache into a ``max_seq`` cache, in place; returns
    ``full`` at the prefill's ``len``.  The SSM layers' states (``conv``,
    ``ssm``, O(1) in the sequence) and whisper's ``cross_k`` and ``cross_v``
    (the encoder's frames) are copied whole, as the reference does; every
    other leaf is (L, B, S, ...) with the prompt's S positions (k, v (..,
    H, D); MLA's ckv, krope (.., R); zamba2's per-site k, v), copied into
    the head of the sequence axis."""
    for k, t in pre.items():
        if k in _WHOLE_LEAVES:
            full[k].copy_(t)
        elif k != "len":
            full[k][:, :, :t.shape[2]] = t
    full["len"] = pre["len"]
    return full
