"""Hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version, the backend policy of the episodic path
(:mod:`repro_torch.kernels.dispatch`), and the kernel entry point for
LM-side kernels and direct use (:mod:`repro_torch.kernels.ops`).

Kernels: segment_pool (segment sums, class second moments), mahalanobis
(Simple CNAPs head), int8_matmul (quantized serving head), flash_attention
(causal / sliding window / softcap, GQA), gmm (per-expert matmul) and
ssd_scan (Mamba-2 intra-chunk SSD); all forward only.  The plain oracles of
the JAX package's kernel tests are in :mod:`repro_torch.kernels.ref`.
"""
