"""minicpm-2b — WSD schedule, llama-like with mup-style scaling
[arXiv:2404.06395].

40L d_model=2304 36H (MHA) d_ff=5760 vocab=122753.  Carries the paper's
scaling knobs: embed x12 (scale_emb), residual x(1.4/sqrt(40)), logits
x(1/(2304/256)).  The WSD LR schedule lives in repro.optim.schedules.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="transformer",
    n_layers=40,
    d_model=2304,
    d_ff=5760,
    vocab=122753,
    max_seq=131072,
    attention=AttentionConfig(kind="gqa", n_heads=36, n_kv_heads=36,
                              head_dim=64, rope_theta=10000.0),
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / (40 ** 0.5),
    logit_scale=256.0 / 2304.0,
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="minicpm-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=128, vocab=250, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    tie_embeddings=True, embed_scale=12.0,
    residual_scale=1.4 / (2 ** 0.5), logit_scale=0.25,
    remat_policy="none",
)
