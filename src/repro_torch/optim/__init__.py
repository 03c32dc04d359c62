"""Blockwise int8 quantization (the serving weights' storage form)."""
