"""The port's own copy of the JAX package's ``MetaTrainConfig``
(``repro/configs/base.py``), with the same construction-time checks.

One difference: ``kernel_backend`` takes the port's backends
(``naive | ref | cuda | auto``) and defaults to ``auto``, which is the
hand-written kernels on a CUDA device (the JAX package defaults to
``ref`` because its kernels run in interpret mode off the TPU).

Beside it, the model configs of the JAX package (``AttentionConfig``,
``MoEConfig``, ``SSMConfig``, ``ModelConfig``), copied field for field so
that every architecture's ``CONFIG`` and ``SMOKE`` equal the JAX package's,
and its step shapes (``ShapeSpec``, ``SHAPES``, ``SHAPES_BY_NAME``), the
(arch x shape) cells that the roofline (:mod:`repro_torch.roofline`) and
the abstract specs (:mod:`repro_torch.launch.specs`) cover.
The port reads the fields of the model (widths, attention variant, scales,
``compute_dtype``); the JAX package's sharding and rematerialisation knobs
(``remat_policy``, ``shard_activations_model``, ``moe_shard_map``,
``attn_head_constraints``, ``tp_enabled``, ``activation_layout``) are kept
so the configs stay equal, and change nothing on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.kernels.dispatch import BACKENDS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Attention sub-config. kind='gqa' covers MHA (n_kv_heads == n_heads)
    and GQA; kind='mla' is DeepSeek-style Multi-head Latent Attention."""

    kind: str = "gqa"                # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False           # qwen2
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    rope_theta: float = 10000.0
    # MLA-only fields (DeepSeek-V2):
    q_lora_rank: int = 0             # 0 -> dense q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0                # always-on shared experts
    d_ff: int = 2048                 # per-expert hidden width
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2                  # d_inner = expand * d_model
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified model config covering all assigned families.

    family:
      'transformer'  decoder-only LM (dense or MoE FFN, GQA or MLA attn)
      'mamba2'       pure SSM LM
      'hybrid'       zamba2: mamba2 trunk + shared attention block
      'encdec'       whisper: transformer encoder-decoder
    """

    name: str = "model"
    family: str = "transformer"
    n_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024                  # dense FFN hidden (per layer)
    vocab: int = 32000
    max_seq: int = 8192
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # gemma2-style alternating local/global attention. window applies to
    # every layer whose index % 2 == 0 when local_global=True.
    local_global: bool = False
    sliding_window: int = 4096
    final_softcap: Optional[float] = None   # gemma2: 30.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # minicpm-style mup-ish scaling knobs (1.0 = off)
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # zamba2: apply the shared attention block after every k-th mamba layer
    hybrid_attn_every: int = 6
    # whisper: encoder depth (decoder depth = n_layers)
    n_encoder_layers: int = 0
    frontend: Optional[str] = None    # None | 'vision_stub' | 'audio_stub'
    n_frontend_tokens: int = 256      # patch / frame count provided by stub
    # numerics & memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "nothing"     # 'nothing'|'dots'|'none'
    shard_activations_model: bool = True
    loss_chunk: int = 0               # >0: chunked cross-entropy over seq
    # optimizer-state dtype policy ('float32'|'bfloat16'|'int8')
    opt_state_dtype: str = "float32"
    moe_shard_map: bool = True
    attn_head_constraints: bool = True
    tp_enabled: bool = True
    activation_layout: str = "hidden"

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 2048; true-vocab entries beyond
        ``vocab`` are never produced and their logits are masked."""
        return _round_up(self.vocab, 2048)


@dataclasses.dataclass(frozen=True)
class MetaTrainConfig:
    """Task-batched LITE meta-training knobs (repro_torch.core.episodic_train).

    tasks_per_step: tasks whose gradients are averaged into ONE optimizer
      step (1 reproduces paper Algorithm 1).
    dp_shards: ranks of the data-parallel ``data`` axis (one node's cards).
    dcn_shards: ranks of the node-level ``dcn`` axis; > 1 needs a two-level
      mesh (repro_torch.launch.mesh.make_two_level_dp_mesh).
    grad_reduce: the cross-node gradient reduction, 'pmean' (exact) or
      'compressed' (int8 error feedback, repro_torch.optim.compress).
    accum_steps: sequential gradient-accumulation chunks of the tasks per
      optimizer step, so tasks_per_step can exceed what one pass holds.
      Divisibility (tasks_per_step % (dp_shards * dcn_shards *
      accum_steps)) is checked here at construction time.
    lite_h, lite_chunk, lite_dtype: the LiteSpec of every aggregation site
      (H size, complement chunk, complement compute dtype; None = fp32).
    lr, max_grad_norm: AdamW's (peak) learning rate and the global-norm
      clip.
    schedule: LR schedule name (None = constant ``lr``; 'cosine' | 'wsd'
      over warmup_steps / total_steps, repro_torch.optim.schedules).
    prefetch: background batch lookahead depth of the train loop (0 =
      synchronous).  donate: accepted for the JAX launcher's flag; eager
      PyTorch has no buffer donation, so it changes nothing.
    kernel_backend: repro_torch.kernels.dispatch backend of the class sums,
      Simple CNAPs second moments and Mahalanobis head, bound per step.
    skip_nonfinite: a NaN/inf gradient leaves params and optimizer state
      bit-identical (metrics['nonfinite'] reports it); the loop bounds how
      many consecutive skips count as divergence.
    """

    tasks_per_step: int = 8
    dp_shards: int = 1
    dcn_shards: int = 1
    grad_reduce: str = "pmean"       # 'pmean' | 'compressed'
    accum_steps: int = 1
    lite_h: int = 8
    lite_chunk: Optional[int] = None
    lite_dtype: Optional[str] = None
    lr: float = 1e-3
    max_grad_norm: float = 10.0
    schedule: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 0
    prefetch: int = 2
    donate: bool = True
    kernel_backend: str = "auto"
    skip_nonfinite: bool = True

    def __post_init__(self):
        if self.grad_reduce not in ("pmean", "compressed"):
            raise ValueError(
                f"grad_reduce={self.grad_reduce!r} (want 'pmean' or "
                f"'compressed')")
        if self.grad_reduce == "compressed" and self.dcn_shards < 2:
            raise ValueError(
                "grad_reduce='compressed' compresses CROSS-HOST traffic; "
                f"with dcn_shards={self.dcn_shards} there is none to "
                "compress and gradients would be quantized for a "
                "singleton reduction — set dcn_shards >= 2 (or keep "
                "grad_reduce='pmean')")
        for name in ("dp_shards", "dcn_shards", "accum_steps",
                     "tasks_per_step"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        denom = self.dp_shards * self.dcn_shards * self.accum_steps
        if self.tasks_per_step % denom:
            raise ValueError(
                f"tasks_per_step={self.tasks_per_step} must be divisible by "
                f"dp_shards*dcn_shards*accum_steps = {self.dp_shards}*"
                f"{self.dcn_shards}*{self.accum_steps} = {denom} (every "
                f"shard scans accum_steps equal task chunks)")
        if self.kernel_backend not in BACKENDS:
            raise ValueError(f"kernel_backend={self.kernel_backend!r} (want one "
                             f"of {BACKENDS})")


# -- step shapes (the input-shape set of the LM-family archs) ----------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
