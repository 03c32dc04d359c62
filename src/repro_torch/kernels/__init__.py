"""Hand-written CUDA kernels for the episodic serving path (``csrc/``), each
beside its plain PyTorch version, and the backend policy that picks between
them (:mod:`repro_torch.kernels.dispatch`).

Kernels: segment_pool (segment sums, class second moments), mahalanobis
(Simple CNAPs head), int8_matmul (quantized serving head, forward only).
"""
