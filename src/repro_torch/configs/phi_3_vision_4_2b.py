"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA) d_ff=8192 vocab=32064.  Vision frontend is a
stub: the caller provides precomputed patch embeddings (B, 256, d_model),
which the model prepends to the token embeddings.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="transformer",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32064,
    max_seq=131072,
    attention=AttentionConfig(kind="gqa", n_heads=32, n_kv_heads=32,
                              head_dim=96, rope_theta=10000.0),
    frontend="vision_stub",
    n_frontend_tokens=256,
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=128, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    frontend="vision_stub", n_frontend_tokens=8,
    remat_policy="none",
)
