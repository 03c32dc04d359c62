"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), the port's target device.

From NVIDIA's H100 data sheet, SXM part, dense rates (without sparsity),
which assume the card's full power limit of 700 W; a card set below it
(``nvidia-smi --query-gpu=power.limit``) runs slower under load, so a share
of these peaks is stated beside the card's limit.  The JAX package's
``repro/roofline/constants.py`` is TPU v5e's: none of its numbers apply
here.

The links of a data-parallel mesh (:func:`repro_torch.roofline.
dp_collective_ms`): NVLink 4 on the H100 SXM moves 900 GB/s a card, both
directions together (NVIDIA's H100 data sheet), so 450 GB/s each way,
between the cards of a node; between nodes, one 400 Gb/s InfiniBand NDR
port a card, as NVIDIA's DGX H100 system has (its data sheet), 50 GB/s
each way.
"""

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
FP16_FLOPS = 989e12          # dense fp16 tensor-core FLOP/s
FP8_FLOPS = 1979e12          # dense fp8 tensor-core FLOP/s
INT8_OPS = 1979e12           # dense int8 tensor-core OP/s
TF32_FLOPS = 495e12          # dense TF32 tensor-core FLOP/s
FP32_FLOPS = 67e12           # fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes/s
HBM_BYTES = 80e9             # HBM3 capacity
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction, a card
IB_BYTES_PER_S = 50e9        # one InfiniBand NDR 400 Gb/s port, one direction
