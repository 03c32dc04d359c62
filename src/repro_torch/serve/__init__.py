"""Episodic serving: quantized frozen weights and the serving engine."""
