"""The analytical H100 roofline of the port: the card's peaks
(:mod:`~repro_torch.roofline.constants`), the bounds of every path that
``chip_smoke.py`` times, and the three-term analysis of every (arch x
shape) cell and the serving layouts' payloads and chooser
(:mod:`~repro_torch.roofline.analysis`)::

    from repro_torch.roofline import cell_rows, format_markdown
    print(format_markdown(cell_rows()))       # the 40-cell table
"""
from repro_torch.roofline.analysis import (PRODUCTION_MESHES, SERVING_LAYOUTS, analyze_cell,
                                           attn_pairs, ep_layer_payloads, lm_step_collective_s,
                                           lm_step_payloads, mesh_state_bytes,
                                           batch_shardings, bound_ms, cell_rows,
                                           choose_replica_serving_layout,
                                           choose_serving_layout, dp_collective_ms,
                                           dp_payloads, dp_wire_bytes, dp_wire_stages,
                                           format_markdown, lm_bounds, model_flops,
                                           moe_bounds, moe_train_bound, param_counts,
                                           pretrain_bound, score_serving_layout,
                                           serving_payloads, serving_predict_work,
                                           serving_shardings, serving_wire_bytes, split_dim,
                                           ssm_bounds, ssm_flops, ssm_shape, ssm_train_bound,
                                           state_bytes, whisper_bounds, whisper_fwd_flops,
                                           whisper_train_bound)
from repro_torch.roofline.constants import (BF16_FLOPS, FP8_FLOPS, FP16_FLOPS, FP32_FLOPS,
                                            HBM_BYTES, HBM_BYTES_PER_S, IB_BYTES_PER_S,
                                            INT8_OPS, NVLINK_BYTES_PER_S, TF32_FLOPS)

__all__ = [
    "BF16_FLOPS", "FP8_FLOPS", "FP16_FLOPS", "FP32_FLOPS", "HBM_BYTES", "HBM_BYTES_PER_S",
    "IB_BYTES_PER_S", "INT8_OPS", "NVLINK_BYTES_PER_S", "PRODUCTION_MESHES", "SERVING_LAYOUTS",
    "TF32_FLOPS", "analyze_cell", "attn_pairs", "ep_layer_payloads", "lm_step_collective_s",
    "lm_step_payloads", "mesh_state_bytes", "batch_shardings", "bound_ms", "cell_rows",
    "choose_replica_serving_layout", "choose_serving_layout", "dp_collective_ms",
    "dp_payloads", "dp_wire_bytes", "dp_wire_stages", "format_markdown", "lm_bounds",
    "model_flops", "moe_bounds", "moe_train_bound", "param_counts", "pretrain_bound",
    "score_serving_layout", "serving_payloads", "serving_predict_work", "serving_shardings",
    "serving_wire_bytes", "split_dim", "ssm_bounds", "ssm_flops", "ssm_shape",
    "ssm_train_bound", "state_bytes", "whisper_bounds", "whisper_fwd_flops",
    "whisper_train_bound",
]
