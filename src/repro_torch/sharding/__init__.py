"""The distribution layer of the LM: partition rules, specs and the active
mesh (the JAX package's ``repro/sharding``).

LM mesh contract (the sharded LM step,
:func:`repro_torch.train.step.make_train_step` with ``mesh=``):

* the mesh is ``(data, model)`` or ``(pod, data, model)``
  (:func:`repro_torch.launch.mesh.make_production_mesh`,
  :func:`~repro_torch.launch.mesh.make_test_mesh`), one rank a process;
* every leaf of the params and the AdamW state rests as this rank's block
  under the sanitized rules (:mod:`~repro_torch.sharding.rules`,
  :mod:`~repro_torch.sharding.place`): ``model`` splits heads, FFN hidden,
  vocab and the MoE expert dim, ``FSDP`` = (pod, data) the second param
  dim; the int8 state's ``q`` and ``scale`` take their own rules;
* the batch splits over (pod, data); the ``model`` ranks of a data shard
  hold the same tokens, and the dense compute is replicated over them:
  before use each leaf is gathered over every axis its spec names, but
  the expert banks of an expert-parallel MoE layer, which stay split over
  ``model``, each rank running its E/m experts
  (:func:`repro_torch.models.moe.moe_ffn_sharded`: one all-gather and one
  reduce-scatter over ``model`` a layer, on the residual's 'hidden' or
  'seq' block);
* a rank's gradient is its data shard's: it is summed over (pod, data),
  never over ``model``, and a leaf stored split keeps only its block (a
  gather over data has a reduce-scatter as its VJP, one over ``model`` a
  slice; a leaf whole on every data rank is all-reduced over data);
* the loss is normalised by the global token count; the global-norm clip
  counts each block's squares once; AdamW updates the blocks in place; a
  non-finite gradient anywhere skips the step on every rank;
* ``batch_axes`` holding ``model`` (a config with ``tp_enabled=False``
  whose batch covers the mesh, :func:`~repro_torch.sharding.rules.
  tp_off_batch_axes`) makes the step pure data parallel: ``model``
  stripped from every spec, the batch over (pod,) data and model.

LM serving over the same mesh (every family's ``prefill`` and
``decode_step`` under :func:`~repro_torch.sharding.ctx.use_mesh`) reads
its params, rows and cache through :mod:`~repro_torch.sharding.serve`:
the params as placed above, each layer's leaves gathered as reached; the
cache as this rank's blocks under the sanitized ``cache_specs``
(:func:`~repro_torch.sharding.place.place_lm_cache`).

The reference's ``sharding/__init__.py`` also re-exports ``shard_map``
across a JAX relocation; the port has no such API to re-export.  Its
``ctx.constrain`` (a GSPMD layout hint) has no counterpart either: eager
PyTorch lays out every tensor explicitly.
"""
from repro_torch.sharding.ctx import P, active_mesh, residual_spec, sanitize_tree, use_mesh
from repro_torch.sharding.rules import (FSDP, batch_specs, cache_specs, opt_state_specs,
                                        param_specs, sanitize, strip_axes, tp_off_batch_axes)

__all__ = ["FSDP", "P", "active_mesh", "batch_specs", "cache_specs", "opt_state_specs",
           "param_specs", "residual_spec", "sanitize", "sanitize_tree", "strip_axes",
           "tp_off_batch_axes", "use_mesh"]
