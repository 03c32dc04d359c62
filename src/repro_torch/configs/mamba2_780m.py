"""mamba2-780m — SSD state-space LM [arXiv:2405.21060].

48L d_model=1536 attn-free, ssm_state=128, vocab=50280.
d_inner = 2*1536 = 3072, head_dim 64 -> 48 SSD heads. Runs long_500k
(O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="mamba2",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50280,
    max_seq=1 << 20,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    tie_embeddings=True,
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="mamba2",
    n_layers=2, d_model=64, d_ff=0, vocab=256, max_seq=2048,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    tie_embeddings=True,
    remat_policy="none",
)
