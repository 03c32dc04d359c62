"""Blockwise int8 quantization (the serving weights' storage form), and the
repo's own AdamW, global-norm clipping and learning-rate schedules (written
out as the JAX package has them, not ``torch.optim``)."""
