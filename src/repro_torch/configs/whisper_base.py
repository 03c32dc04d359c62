"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6L (x2: encoder + decoder) d_model=512 8H (MHA) d_ff=2048 vocab=51865.
Audio (conv/mel) frontend is a STUB: input_specs provides precomputed
frame embeddings (B, S_enc, d_model).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    d_ff=2048,
    vocab=51865,
    max_seq=65536,
    attention=AttentionConfig(kind="gqa", n_heads=8, n_kv_heads=8,
                              head_dim=64, rope_theta=10000.0),
    frontend="audio_stub",
    n_frontend_tokens=1500,
    tie_embeddings=True,
    loss_chunk=512,
    # the JAX package's sharding knobs (the port runs on one device)
    tp_enabled=False,
    shard_activations_model=False,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, d_ff=128, vocab=256,
    max_seq=512,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    frontend="audio_stub", n_frontend_tokens=16,
    tie_embeddings=True,
    remat_policy="none",
)
