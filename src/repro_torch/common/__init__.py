"""Shared helpers on nested dicts, lists and tuples of tensors."""
