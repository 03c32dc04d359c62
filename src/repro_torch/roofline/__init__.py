"""The analytical H100 roofline of the port: the card's peaks
(:mod:`~repro_torch.roofline.constants`), the bounds of every path that
``chip_smoke.py`` times, and the three-term analysis of every (arch x
shape) cell (:mod:`~repro_torch.roofline.analysis`)::

    from repro_torch.roofline import cell_rows, format_markdown
    print(format_markdown(cell_rows()))       # the 40-cell table
"""
from repro_torch.roofline.analysis import (analyze_cell, attn_pairs, bound_ms, cell_rows,
                                           dp_collective_ms, dp_payloads, dp_wire_bytes,
                                           dp_wire_stages, format_markdown, lm_bounds,
                                           model_flops, moe_bounds, moe_train_bound,
                                           param_counts, pretrain_bound, ssm_bounds, ssm_flops,
                                           ssm_shape, ssm_train_bound, state_bytes,
                                           whisper_bounds, whisper_fwd_flops,
                                           whisper_train_bound)
from repro_torch.roofline.constants import (BF16_FLOPS, FP8_FLOPS, FP16_FLOPS, FP32_FLOPS,
                                            HBM_BYTES, HBM_BYTES_PER_S, IB_BYTES_PER_S,
                                            INT8_OPS, NVLINK_BYTES_PER_S, TF32_FLOPS)

__all__ = [
    "BF16_FLOPS", "FP8_FLOPS", "FP16_FLOPS", "FP32_FLOPS", "HBM_BYTES", "HBM_BYTES_PER_S",
    "IB_BYTES_PER_S", "INT8_OPS", "NVLINK_BYTES_PER_S", "TF32_FLOPS", "analyze_cell",
    "attn_pairs", "bound_ms", "cell_rows", "dp_collective_ms", "dp_payloads", "dp_wire_bytes",
    "dp_wire_stages", "format_markdown", "lm_bounds", "model_flops", "moe_bounds",
    "moe_train_bound", "param_counts", "pretrain_bound", "ssm_bounds", "ssm_flops",
    "ssm_shape", "ssm_train_bound", "state_bytes", "whisper_bounds", "whisper_fwd_flops",
    "whisper_train_bound",
]
