"""Training steps in the loop's ``(state, batch) -> (state, metrics)``
form (the JAX package's ``repro/train/step.py``): LM training of the model
zoo (``make_init_state``, ``make_train_step``, ``make_eval_step``), and
the episodic meta-training adapters, so both inherit checkpoint, resume
and straggler handling.

The LM step's ``batch`` is ``dict(tokens=(B, S) int64)`` on the params'
device (:func:`repro_torch.data.tokens.batch_to_device`).  With ``mesh=``
(a (data, model) or (pod, data, model)
:class:`repro_torch.launch.mesh.DPMesh`) the state is this rank's blocks
(:func:`make_sharded_init_state`, :func:`lm_state_specs`), every rank
passes the global batch, and the step keeps its data shard's rows; the
contract is :mod:`repro_torch.sharding`'s docstring.  The LM step
updates the state it is given in place (:func:`repro_torch.optim.adamw.
adamw_update_`), as the JAX loop's jitted step updates its donated
buffers: a caller that needs the old state copies it first.

The episodic step's ``batch`` is ``dict(tasks=TaskBatch, key=(seed,
step))``, with an optional ``scores`` (T, N) tensor; without it the step
derives each task's H scores from ``key``, the task's index and the
example's index (:func:`repro_torch.core.lite.index_scores`), so a batch
is a pure function of its step.  It returns a new state.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_paths, tree_rebuild
from repro_torch.configs.base import ModelConfig
from repro_torch.core.episodic_train import _tree_all_finite
from repro_torch.core.lite import index_scores
from repro_torch.kernels import dispatch
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update_
from repro_torch.optim.clip import clip_scale
from repro_torch.optim.schedules import cosine_schedule, schedule_for

State = Dict[str, Any]


def make_init_state(cfg: ModelConfig, adamw_cfg: AdamWConfig) -> Callable:
    """``init_state(gen: torch.Generator, device) -> dict(params, opt)``:
    the model's params drawn on ``gen`` (see ``api.init``), floating leaves
    in ``cfg.param_dtype`` (each cast as it is drawn), and a zero AdamW
    state."""
    api = get_api(cfg)

    def init_state(gen: torch.Generator, device=None) -> State:
        params = api.init(gen, cfg, device, at_param_dtype=True)
        return dict(params=params, opt=adamw_init(params, adamw_cfg))

    return init_state


def lm_state_specs(cfg: ModelConfig, adamw_cfg: AdamWConfig, mesh) -> Tuple[State, Any]:
    """(the whole state on ``meta``, its sanitized spec tree): the rules'
    ``param_specs`` and ``opt_state_specs`` of ``make_init_state``'s
    tree (params in ``cfg.param_dtype``), sanitized for ``mesh`` (anything
    with a ``shape`` dict)."""
    from repro_torch.sharding import rules
    state, specs = _abstract_lm_state(cfg, adamw_cfg)
    return state, rules.sanitize(specs, state, mesh)


@functools.lru_cache(maxsize=8)
def _abstract_lm_state(cfg: ModelConfig, adamw_cfg: AdamWConfig):
    """The whole state on ``meta`` and its raw spec tree (a fake-tensor run
    of init, a second or two at full width: kept, read only)."""
    from repro_torch.launch.specs import abstract_params_for
    from repro_torch.sharding import rules
    dt = getattr(torch, cfg.param_dtype)
    params = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                      abstract_params_for(cfg))
    state = dict(params=params, opt=adamw_init(params, adamw_cfg))
    return state, dict(params=rules.param_specs(state["params"]),
                       opt=rules.opt_state_specs(state["opt"]))


def make_sharded_init_state(cfg: ModelConfig, adamw_cfg: AdamWConfig, mesh) -> Callable:
    """``init_state(gen, device) -> dict(params, opt)``: this rank's blocks
    of :func:`make_init_state`'s state under :func:`lm_state_specs`.  The
    params are drawn one leaf at a time on ``gen``, each cut to its block
    before the next (:func:`repro_torch.sharding.place.init_sharded`), so
    the blocks are the single-device init's and the peak is the largest
    leaf; the AdamW state is made as its blocks (its zero state is one value
    a leaf part, so a block is that value in the block's shape)."""
    from repro_torch.sharding.place import block_shape, init_sharded
    api = get_api(cfg)
    whole, specs = lm_state_specs(cfg, adamw_cfg, mesh)
    # the zero state of a one-element leaf: each part's single value
    tiny = adamw_init(tree_map(lambda t: torch.zeros((1,) * t.dim(), dtype=t.dtype),
                               whole["params"]), adamw_cfg)

    def init_state(gen: torch.Generator, device=None) -> State:
        params = init_sharded(lambda g, d: api.init(g, cfg, d, at_param_dtype=True), gen,
                              device, specs["params"], mesh)
        dev = tree_leaves(params)[0].device

        def block(w, spec, one):
            if not torch.is_tensor(w):
                return w                    # an int8 part's trailing dim n
            return torch.full(block_shape(w.shape, spec, mesh.shape), one.reshape(-1)[0].item(),
                              dtype=w.dtype, device=dev)

        opt = {k: tree_map(block, whole["opt"][k], specs["opt"][k], tiny[k])
               for k in ("mu", "nu")}
        opt["count"] = torch.zeros((), dtype=torch.int32, device=dev)
        return dict(params=params, opt=opt)

    return init_state


def make_train_step(cfg: ModelConfig, adamw_cfg: AdamWConfig,
                    schedule: Callable | None = None,
                    max_grad_norm: float = 1.0,
                    skip_nonfinite: bool = True, mesh=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient (attention on the current kernel backend,
    :func:`repro_torch.kernels.dispatch.use_backend`; ``auto`` by default),
    the global-norm clip at ``max_grad_norm``, the lr of ``schedule`` at
    the update count (default: cosine, peak 3e-4, warmup 2000, total
    100000) and AdamW.

    The step consumes ``state``: params and optimizer state are updated in
    place and the same dict is returned, each gradient freed once its leaf
    is updated, so the peak is params, grads and state once each.
    ``skip_nonfinite`` (default on): a NaN/inf gradient leaves params and
    state bit-identical and ``metrics['nonfinite']`` is 1.  Metrics
    (``loss``, ``grad_norm``, ``lr``, ``nll``, ``aux``, ``nonfinite``) are
    0-dim device tensors.

    ``mesh``: the step over a (data, model) mesh on this rank's blocks
    (:func:`make_sharded_init_state`); every rank passes the global batch
    and gets the global metrics."""
    api = get_api(cfg)
    if schedule is None:
        schedule = functools.partial(cosine_schedule, peak=3e-4, warmup_steps=2000,
                                     total_steps=100000)
    if mesh is not None:
        return _mesh_train_step(cfg, adamw_cfg, schedule, max_grad_norm, skip_nonfinite,
                                mesh)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        leaves = tree_leaves(state["params"])
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = api.loss(tree_rebuild(state["params"], live), batch, cfg,
                                     backend=None)
            grads = list(torch.autograd.grad(loss, live))
        del live
        ok = _tree_all_finite(grads) if skip_nonfinite else None
        scale, gnorm = clip_scale(grads, max_grad_norm)
        lr = schedule(state["opt"]["count"])
        adamw_update_(state["params"], grads, state["opt"], lr, adamw_cfg, grad_scale=scale,
                      ok=ok)
        out = dict(loss=loss.detach(), grad_norm=gnorm, lr=lr,
                   **{k: v.detach() for k, v in metrics.items()})
        if ok is not None:
            out["nonfinite"] = (~ok).to(torch.float32)
        return state, out

    return train_step


def expert_bank(path: str, ndim: int) -> bool:
    """A leaf the rules split over ``model`` on its expert dim: an MoE
    layer's (L, E, D, F) / (L, E, F, D) ``w_gate``, ``w_up``, ``w_down``."""
    name = path.rsplit("/", 1)[-1]
    return "ffn" in path and "shared" not in path and ndim >= 3 \
        and name in ("w_gate", "w_up", "w_down")


def ep_layer(cfg: ModelConfig, mesh, t_loc: int) -> bool:
    """Whether the MoE layers of ``cfg`` run expert-parallel on ``mesh`` at
    ``t_loc`` tokens a data shard (``transformer.moe_dispatch``'s choice)."""
    from repro_torch.models.moe import ep_applies
    layout = cfg.activation_layout if cfg.shard_activations_model else "seq"
    return cfg.moe is not None and cfg.moe_shard_map \
        and ep_applies(cfg.moe, mesh.shape, t_loc, cfg.d_model, layout)


def _at(tree, path: str):
    """The subtree of a nested dict / list at ``path`` (keys joined by '/')."""
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _update_views(params, paths, pspecs, grads, opt, specs, mesh, adamw_cfg):
    """What AdamW updates, leaf by leaf, and how to put it back: a leaf's
    block, its gradient and its ``mu`` / ``nu`` in one layout.  fp32 and
    bf16 state take the param's rule, so the stored blocks are the views
    and nothing moves.  An int8 state's ``q`` and ``scale`` take their own
    rules (``opt_state_specs``), and its blocks of 128 run along the last
    dim: its parts are resharded to the param's layout, the last dim
    gathered too where the param's block cuts a quantisation block (the
    update then runs on the rows that dim spans, on every rank of its
    group)."""
    from repro_torch.optim.quant import BLOCK, is_quantized
    from repro_torch.sharding.ctx import P, entry_names
    from repro_torch.sharding.place import reshard
    if adamw_cfg.state_dtype != "int8":
        return params, grads, opt, None
    views_p, views_g, back = [], [], []
    views = {"mu": [], "nu": []}
    for i, (path, p) in enumerate(zip(paths, tree_leaves(params))):
        sp = tuple(pspecs[i])
        last = entry_names(sp[-1]) if p.dim() else ()
        u = sp
        if last and mesh.size_of(last) > 1 and p.shape[-1] % BLOCK:
            u = sp[:-1] + (None,)
        u = P(*u)
        views_p.append(reshard(p, sp, u, mesh))
        views_g.append(reshard(grads[i], sp, u, mesh))
        stored = {}
        for k in ("mu", "nu"):
            qs, qspec = _at(opt[k], path), _at(specs["opt"][k], path)
            views[k].append(dict(q=reshard(qs["q"], qspec["q"], u, mesh),
                                 scale=reshard(qs["scale"], qspec["scale"], u, mesh),
                                 n=qs["n"]))
            stored[k] = (qs, qspec)
        back.append((p, sp, u, stored, views_p[-1], {k: views[k][-1] for k in views}))
    vopt = {k: _rebuild_quantized(opt[k], views[k], is_quantized) for k in views}
    vopt["count"] = opt["count"]
    return tree_rebuild(params, views_p), views_g, vopt, back


def _write_back(back, mesh) -> None:
    """Copy the updated views of :func:`_update_views` into the stored
    blocks, each cut to its own spec."""
    from repro_torch.sharding.place import reshard
    for p, sp, u, stored, vp, parts in back:
        if vp is not p:
            p.copy_(reshard(vp, u, sp, mesh))
        for k, (qs, qspec) in stored.items():
            for part in ("q", "scale"):
                if parts[k][part] is not qs[part]:
                    qs[part].copy_(reshard(parts[k][part], u, qspec[part], mesh))


def _rebuild_quantized(tmpl, parts: list, is_quantized):
    it = iter(parts)
    return tree_map(lambda _: next(it), tmpl, is_leaf=is_quantized)


def make_mesh_grads(cfg: ModelConfig, adamw_cfg: AdamWConfig, mesh) -> Callable:
    """``grads(params, batch) -> (loss, metrics, {path: gradient block})``:
    the sharded step's loss and gradient (:mod:`repro_torch.sharding`).
    Each leaf is gathered for use (the expert banks of an expert-parallel
    layer stay split over model); this data shard's rows of the global
    batch go through ``api.loss`` under ``use_mesh``; its NLL is averaged
    over the data ranks (every shard holds B / n whole rows, so the mean of
    the shards' means is the global count's mean) and the aux loss comes
    averaged from the MoE layers; the gradient lands as this rank's blocks,
    summed over the data axes (a leaf no data axis splits is all-reduced
    over them).  ``params`` are this rank's blocks."""
    from repro_torch.launch.mesh import pmean
    from repro_torch.models.moe import data_axes
    from repro_torch.models.transformer import AUX_COEF
    from repro_torch.sharding.ctx import entry_names, use_mesh
    from repro_torch.sharding.place import gather_for_use, spec_paths
    api = get_api(cfg)
    _, specs = lm_state_specs(cfg, adamw_cfg, mesh)
    spec_at = spec_paths(specs["params"])
    dax = data_axes(mesh)
    n_data = mesh.size_of(dax)

    def grads_of(params, batch: Dict):
        rows = batch["tokens"].shape[0]
        if rows % n_data:
            raise ValueError(f"a batch of {rows} rows does not split over {n_data} data "
                             f"ranks")
        lo = mesh.index_of(dax) * (rows // n_data)
        local = {k: v[lo:lo + rows // n_data] for k, v in batch.items()}
        t_loc = sum(v.shape[1] for k, v in local.items() if k in ("tokens", "frontend_embeds")) \
            * (rows // n_data)
        keep = ep_layer(cfg, mesh, t_loc)
        paths = list(tree_paths(params))
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad(), use_mesh(mesh):
            used = [gather_for_use(x, spec_at[path], mesh, keep and expert_bank(path, x.dim()))
                    for path, x in zip(paths, live)]
            _, metrics = api.loss(tree_rebuild(params, used), local, cfg, backend=None)
            del used
            nll = pmean(metrics["nll"], mesh, dax)
            loss = nll + AUX_COEF * metrics["aux"]
            grads = list(torch.autograd.grad(loss, live, allow_unused=True))
        del live
        for i, (path, p) in enumerate(zip(paths, leaves)):
            if grads[i] is None:
                grads[i] = torch.zeros_like(p)
            named = {a for e in spec_at[path] for a in entry_names(e)}
            if n_data > 1 and not set(dax) <= named:
                mesh.all_reduce(grads[i], dax)
        return loss.detach(), dict(nll=nll.detach(), aux=metrics["aux"].detach()), \
            dict(zip(paths, grads))

    return grads_of


def _mesh_train_step(cfg: ModelConfig, adamw_cfg: AdamWConfig, schedule: Callable,
                     max_grad_norm: float, skip_nonfinite: bool, mesh) -> Callable:
    """The LM step over a (data, model) mesh: :func:`make_mesh_grads`, the
    global-norm clip summing each block's squares once (on the first rank
    that holds it) over every axis, AdamW on the blocks in place, skipped
    on every rank if any rank's gradient is not finite."""
    from repro_torch.sharding.place import owns_block, spec_paths
    _, specs = lm_state_specs(cfg, adamw_cfg, mesh)
    spec_at = spec_paths(specs["params"])
    grads_of = make_mesh_grads(cfg, adamw_cfg, mesh)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        loss, metrics, by_path = grads_of(state["params"], batch)
        paths = list(by_path)
        pspecs = [spec_at[k] for k in paths]
        grads = list(by_path.values())
        del by_path
        dev = grads[0].device
        ok = None
        if skip_nonfinite:
            bad = not bool(_tree_all_finite(grads))
            ok = torch.tensor(not mesh.any_rank(bad), device=dev)
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for g, s in zip(grads, pspecs):
            if owns_block(s, mesh):
                sq = sq + torch.sum(torch.square(g.float()))
        for axis in mesh.axis_names:
            if mesh.shape[axis] > 1:
                mesh.all_reduce(sq, axis)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        lr = schedule(state["opt"]["count"])
        vp, vg, vopt, back = _update_views(state["params"], paths, pspecs, grads, state["opt"],
                                           specs, mesh, adamw_cfg)
        del grads
        adamw_update_(vp, vg, vopt, lr, adamw_cfg, grad_scale=scale, ok=ok)
        if back is not None:
            _write_back(back, mesh)
        out = dict(loss=loss, grad_norm=gnorm, lr=lr, **metrics)
        if ok is not None:
            out["nonfinite"] = (~ok).to(torch.float32)
        return state, out

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(params, batch) -> dict(loss, nll, aux)``, without grad."""
    api = get_api(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = api.loss(params, batch, cfg, backend=None)
        return dict(loss=loss, **metrics)

    return eval_step


def make_episodic_init_state(learner, adamw_cfg: AdamWConfig, meta_cfg=None) -> Callable:
    """``init_state(gen: torch.Generator, device) -> dict(params, opt)``.
    A ``meta_cfg`` with ``grad_reduce='compressed'`` adds the error-feedback
    residual of every ``dcn`` row to the optimizer state (``opt['ef']``,
    :func:`repro_torch.core.episodic_train.init_ef_state`), so checkpoints
    carry it and compressed restarts stay exact."""
    from repro_torch.core.episodic_train import init_ef_state

    def init_state(gen: torch.Generator, device) -> State:
        params = learner.init(gen, device)
        opt = adamw_init(params, adamw_cfg)
        if meta_cfg is not None and meta_cfg.grad_reduce == "compressed":
            opt["ef"] = init_ef_state(params, meta_cfg.dcn_shards)
        return dict(params=params, opt=opt)

    return init_state


def batch_scores(batch: Dict) -> torch.Tensor:
    """The batch's (T, N) H scores: given, or derived from its key."""
    if batch.get("scores") is not None:
        return batch["scores"]
    tasks = batch["tasks"]
    seed, step = batch["key"]
    t, n = tasks.support_y.shape
    return index_scores(seed, step, range(t), n, tasks.support_y.device)


def make_episodic_train_step(learner, lite, meta_cfg,
                             adamw_cfg: AdamWConfig = None, mesh=None,
                             dp_axis: str = "data", dcn_axis: str = "dcn") -> Callable:
    """``meta_cfg``: :class:`repro_torch.configs.base.MetaTrainConfig`
    (``tasks_per_step`` is the data side's concern; ``dp_shards > 1``,
    ``dcn_shards > 1`` or ``compressed`` need ``mesh``, a 1-D
    :func:`repro_torch.launch.mesh.make_dp_mesh` or a two-level
    ``make_two_level_dp_mesh``, and every rank passes the global batch).  A
    configured ``meta_cfg.schedule`` replaces the constant lr with one
    keyed on the optimizer's update count."""
    from repro_torch.core.episodic_train import make_batched_meta_train_step

    adamw_cfg = adamw_cfg or AdamWConfig(weight_decay=0.0)
    needs_mesh = meta_cfg.dp_shards > 1 or meta_cfg.dcn_shards > 1 \
        or meta_cfg.grad_reduce == "compressed"
    if needs_mesh and mesh is None:
        raise ValueError(f"dp_shards={meta_cfg.dp_shards} / "
                         f"dcn_shards={meta_cfg.dcn_shards} / "
                         f"grad_reduce={meta_cfg.grad_reduce!r} requires a "
                         f"mesh (repro_torch.launch.mesh.make_dp_mesh or "
                         f"make_two_level_dp_mesh)")
    inner = make_batched_meta_train_step(
        learner, lite, adamw=adamw_cfg, lr=meta_cfg.lr,
        max_grad_norm=meta_cfg.max_grad_norm,
        schedule=schedule_for(meta_cfg.schedule, meta_cfg.lr,
                              meta_cfg.warmup_steps, meta_cfg.total_steps),
        mesh=mesh, dp_axis=dp_axis, dcn_axis=dcn_axis,
        grad_reduce=meta_cfg.grad_reduce, accum_steps=meta_cfg.accum_steps,
        skip_nonfinite=meta_cfg.skip_nonfinite)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        # the configured kernel backend is bound here, for the whole step
        with dispatch.use_backend(meta_cfg.kernel_backend):
            params, opt, metrics = inner(state["params"], state["opt"],
                                         batch["tasks"], batch_scores(batch))
        return dict(params=params, opt=opt), metrics

    return train_step


def adamw_for(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_state_dtype)
