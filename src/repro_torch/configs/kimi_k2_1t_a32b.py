"""kimi-k2-1t-a32b — Kimi K2 trillion-param MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared, per the K2 report).
Optimizer states int8-blockwise + bf16 params.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="transformer",
    n_layers=61,
    d_model=7168,
    d_ff=2048,                      # unused for MoE layers (kept for record)
    vocab=163840,
    max_seq=131072,
    attention=AttentionConfig(
        kind="gqa", n_heads=64, n_kv_heads=8, head_dim=128,
        rope_theta=50000.0),
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_ff=2048,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    opt_state_dtype="int8",
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=128, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=2, head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff=64),
    remat_policy="none",
)
