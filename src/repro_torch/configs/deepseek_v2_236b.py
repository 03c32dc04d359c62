"""deepseek-v2-236b — MLA + MoE [arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), expert d_ff=1536, 2 shared + 160 routed top-6,
vocab=102400.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="transformer",
    n_layers=60,
    d_model=5120,
    d_ff=12288,                      # dense d_ff (kept for record; layers are MoE)
    vocab=102400,
    max_seq=131072,
    attention=AttentionConfig(
        kind="mla", n_heads=128, n_kv_heads=128, head_dim=128,
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, rope_theta=10000.0),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff=1536,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    loss_chunk=512,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    family="transformer",
    n_layers=2, d_model=64, d_ff=128, vocab=256, max_seq=512,
    attention=AttentionConfig(kind="mla", n_heads=4, n_kv_heads=4, head_dim=16,
                              q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                              qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_ff=64),
    remat_policy="none",
)
