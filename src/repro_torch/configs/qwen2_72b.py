"""qwen2-72b — GQA with QKV bias [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="transformer",
    n_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab=152064,
    max_seq=131072,
    attention=AttentionConfig(kind="gqa", n_heads=64, n_kv_heads=8,
                              head_dim=128, qkv_bias=True,
                              rope_theta=1000000.0),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=224, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=2, head_dim=16,
                              qkv_bias=True),
    remat_policy="none",
)
