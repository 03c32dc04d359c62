"""PyTorch port of the episodic meta-learning system in ``repro``, for
NVIDIA Hopper GPUs.

This package imports ``torch``, numpy and the standard library only; it
never imports JAX or the ``repro`` package.  Its modules mirror
``src/repro/`` file for file.  The episodic serving path runs through
hand-written CUDA kernels (:mod:`repro_torch.kernels`); entry points run on
the card unless the caller passes ``device="cpu"``.
"""
