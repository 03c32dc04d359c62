"""minitron-4b — pruned Nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="transformer",
    n_layers=32,
    d_model=3072,
    d_ff=9216,
    vocab=256000,
    max_seq=131072,
    attention=AttentionConfig(kind="gqa", n_heads=24, n_kv_heads=8,
                              head_dim=128, rope_theta=10000.0),
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=192, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=2, head_dim=16),
    remat_policy="none",
)
