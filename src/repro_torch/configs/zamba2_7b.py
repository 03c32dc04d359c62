"""zamba2-7b — Mamba2 trunk + shared attention blocks [arXiv:2411.15242].

81L d_model=3584 32H (MHA at the shared block) d_ff=14336 ssm_state=64.
Depth layout: 13 x (5 mamba + shared attn) + 3 tail mamba (=81 positions,
hybrid_attn_every=6).  Runs long_500k: mamba state is O(1); the 13 shared
KV caches are O(S) memory but O(S) — not O(S^2) — per decoded token.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32000,
    max_seq=1 << 20,
    attention=AttentionConfig(kind="gqa", n_heads=32, n_kv_heads=32,
                              head_dim=112, rope_theta=10000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    hybrid_attn_every=6,
    tie_embeddings=True,
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=7, d_model=64, d_ff=128, vocab=256, max_seq=2048,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    hybrid_attn_every=3,
    tie_embeddings=True,
    remat_policy="none",
)
