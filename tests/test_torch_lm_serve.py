"""The port's LM serving engine against the JAX package's ``ServeEngine``,
on the CPU: the scenarios of tests/test_serve.py's LM engine tests, each
driven through both engines on the same weights
(``bridge.lm_params_from_numpy``) and prompts at fp32 compute and greedy
sampling, where the tokens must be equal request for request; the port's
own contracts (cache ownership after a cohort change, seeded temperature
sampling, the backend knob); and ``python -m repro_torch.launch.serve
--device cpu`` without ``--episodic`` as a subprocess."""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.registry import get_api as j_get_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jc = dataclasses.replace(jreg.get_smoke_config(arch), compute_dtype="float32")
    tc = dataclasses.replace(treg.get_smoke_config(arch), compute_dtype="float32")
    jp = j_get_api(jc).init(jax.random.key(0), jc)
    return jc, jp, tc, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _both(arch, prompts, max_new, **kw):
    """The same requests through the JAX engine and the port's; returns
    (jax requests, port requests), whose tokens must be equal."""
    jc, jp, tc, tp = _models(arch)
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    JEngine(jc, jp, **kw).run_to_completion(jr)
    ServeEngine(tc, tp, **kw).run_to_completion(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    return jr, tr


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma2-2b", "minicpm-2b", "qwen2-72b",
                                  "phi-3-vision-4.2b"])
def test_engine_completes_requests_as_jax(arch):
    _, out = _both(arch, [np.arange(4, dtype=np.int32) + i for i in range(5)], 5,
                   n_slots=2, max_seq=64)
    assert all(r.done and len(r.out_tokens) == 5 for r in out)


def test_engine_greedy_matches_full_forward():
    """Greedy continuation == argmax over a full re-prefill of (prompt +
    generated) at each step: the KV cache end to end."""
    _, _, tc, tp = _models("minitron-4b")
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    _, (req,) = _both("minitron-4b", [prompt], 4, n_slots=1, max_seq=32)
    seq, want = list(prompt), []
    for _ in range(4):
        logits, _ = get_api(tc).prefill(tp, dict(tokens=torch.tensor([seq])), tc)
        want.append(int(logits[0].argmax()))
        seq.append(want[-1])
    assert req.out_tokens == want


def test_prefill_splice_vs_token_by_token_decode():
    """The prefill-then-splice continuation equals a decode that fed the
    prompt token by token from an empty cache."""
    _, _, tc, tp = _models("minitron-4b")
    api = get_api(tc)
    prompt = np.asarray([7, 2, 9, 4], np.int32)
    _, (req,) = _both("minitron-4b", [prompt], 4, n_slots=1, max_seq=32)
    cache = api.init_cache(tc, 1, 32, "cpu")
    for t in prompt:
        logits, cache = api.decode_step(tp, cache, torch.tensor([[int(t)]]), tc)
    want = []
    for _ in range(4):
        want.append(int(logits[0].argmax()))
        logits, cache = api.decode_step(tp, cache, torch.tensor([[want[-1]]]), tc)
    assert req.out_tokens == want


def test_slot_reuse_after_eos():
    """A slot freed by EOS takes the next request, whose continuation is a
    solo run's (the splice resets the slot's cache region)."""
    p0 = np.asarray([3, 1, 4, 1, 5], np.int32)
    p1 = np.asarray([2, 7, 1, 8, 2], np.int32)
    _, (probe,) = _both("minitron-4b", [p0], 4, n_slots=1, max_seq=32)
    eos = probe.out_tokens[1]
    _, (solo,) = _both("minitron-4b", [p1], 4, n_slots=1, max_seq=32)
    _, (first, second) = _both("minitron-4b", [p0, p1], 4, n_slots=1, max_seq=32,
                               eos_id=eos)
    assert first.done and first.out_tokens[-1] == eos and len(first.out_tokens) <= 2
    want = solo.out_tokens
    if eos in want:
        want = want[: want.index(eos) + 1]
    assert second.done and second.out_tokens == want


def test_prefill_token_respects_budget_and_eos():
    """The prefill-sampled token counts against max_new_tokens and is
    checked for EOS."""
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    _, (one,) = _both("minitron-4b", [prompt], 1, n_slots=1, max_seq=32)
    assert one.done and len(one.out_tokens) == 1
    _, (req,) = _both("minitron-4b", [prompt], 8, n_slots=1, max_seq=32,
                      eos_id=one.out_tokens[0])
    assert req.done and req.out_tokens == one.out_tokens


def test_temperature_sampling_seeded_determinism():
    """temperature > 0: the same seed gives the same streams, another seed
    other draws (torch's generator: the draws are not the JAX package's)."""
    _, _, tc, tp = _models("minitron-4b")

    def run(seed):
        eng = ServeEngine(tc, tp, n_slots=2, max_seq=32, seed=seed)
        reqs = [Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i,
                        max_new_tokens=6, temperature=0.8) for i in range(3)]
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        assert all(0 <= t < tc.vocab for r in reqs for t in r.out_tokens)
        return [r.out_tokens for r in reqs]

    a, b, c = run(5), run(5), run(6)
    assert a == b
    assert a != c


def test_batched_decode_matches_per_slot_across_a_cohort_change():
    """Equal-length prompts decode as one stacked cohort; a request retiring
    early (a smaller budget) changes the cohort mid-stream.  Tokens equal
    the per-slot engine's and the JAX engine's."""
    _, _, tc, tp = _models("minitron-4b")
    prompts = [np.arange(5, dtype=np.int32) + 3 * i for i in range(3)]

    def run(batched):
        jc, jp = _models("minitron-4b")[:2]
        budgets = (6, 3, 6)
        jr = [JRequest(uid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(zip(prompts, budgets))]
        tr = [Request(uid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(zip(prompts, budgets))]
        JEngine(jc, jp, n_slots=3, max_seq=32, batched_decode=batched).run_to_completion(jr)
        eng = ServeEngine(tc, tp, n_slots=3, max_seq=32, batched_decode=batched)
        eng.run_to_completion(tr)
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
        return [r.out_tokens for r in tr]

    assert run(True) == run(False)


def test_unstacked_caches_own_their_storage():
    """After a cohort flush each slot's cache is its own copy: decoding one
    slot in place leaves the others' caches untouched."""
    _, _, tc, tp = _models("minitron-4b")
    eng = ServeEngine(tc, tp, n_slots=2, max_seq=32)
    for i in range(2):
        assert eng.add_request(Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i,
                                       max_new_tokens=8))
    eng.step()
    assert eng._stacked is not None and eng._stacked[0] == [0, 1]
    eng._flush_stacked()
    c0, c1 = eng._caches
    assert c0["k"].untyped_storage().data_ptr() != c1["k"].untyped_storage().data_ptr()
    before = c1["k"].clone()
    get_api(tc).decode_step(tp, c0, torch.tensor([[1]]), tc)
    assert torch.equal(c1["k"], before)


def test_stack_caches_refuses_ragged_positions():
    """Slots at different decode positions cannot share one stacked decode;
    the engine decodes them slot by slot, as the JAX engine does."""
    _, _, tc, tp = _models("minitron-4b")
    eng = ServeEngine(tc, tp, n_slots=2, max_seq=32)
    assert eng.add_request(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                                   max_new_tokens=8))
    assert eng.add_request(Request(uid=1, prompt=np.arange(6, dtype=np.int32),
                                   max_new_tokens=8))
    caches = [c for c, r in zip(eng._caches, eng._reqs) if r is not None]
    assert eng._stack_caches(caches) is None
    eng.run_to_completion([])
    assert eng.step() == 0
    _both("minitron-4b", [np.arange(4, dtype=np.int32), np.arange(6, dtype=np.int32)], 8,
          n_slots=2, max_seq=32)


def test_engine_backends_agree_on_cpu():
    """``kernel_backend='cuda'`` on CPU tensors (the plain flash attention in
    every prefill) serves the ``ref`` engine's tokens; an unknown backend
    is refused."""
    _, _, tc, tp = _models("gemma2-2b")
    out = {}
    for backend in ("ref", "cuda", "auto"):
        reqs = [Request(uid=i, prompt=np.arange(40, dtype=np.int32) + i, max_new_tokens=4)
                for i in range(2)]
        ServeEngine(tc, tp, n_slots=2, max_seq=48, kernel_backend=backend) \
            .run_to_completion(reqs)
        out[backend] = [r.out_tokens for r in reqs]
    assert out["ref"] == out["cuda"] == out["auto"]
    with pytest.raises(ValueError, match="kernel_backend"):
        ServeEngine(tc, tp, kernel_backend="pallas")


def test_launcher_lm_path_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--slots", "2", "--max-new", "4", "--arch", "gemma2-2b"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "gemma2-smoke (transformer cache): 3 requests, 12 tokens" in out.stdout
    assert "tok/s on device=cpu" in out.stdout
