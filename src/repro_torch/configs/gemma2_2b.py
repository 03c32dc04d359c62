"""gemma2-2b — local+global alternating attention with logit softcaps
[arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Even layers: sliding-window 4096; odd layers: global.  Attention softcap
50.0; final-logit softcap 30.0; tied embeddings scaled by sqrt(d_model).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="transformer",
    n_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab=256000,
    max_seq=131072,
    attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=4,
                              head_dim=256, attn_softcap=50.0,
                              rope_theta=10000.0),
    local_global=True,
    sliding_window=4096,
    final_softcap=30.0,
    tie_embeddings=True,
    embed_scale=2304.0 ** 0.5,
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=128, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
                              attn_softcap=50.0),
    local_global=True, sliding_window=32, final_softcap=30.0,
    tie_embeddings=True, embed_scale=8.0,
    remat_policy="none",
)
