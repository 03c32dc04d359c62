"""How one LM prefill or decode step sees its params and cache: on one
device, or on this rank's blocks over a (data, model) / (pod, data, model)
mesh (the JAX package's ``api.prefill`` / ``api.decode_step`` on params
placed by ``rules.param_specs`` and caches placed by ``rules.cache_specs``,
``repro/launch/dryrun.py:154-195``).

Every family's ``prefill`` and ``decode_step`` opens a view with
:func:`begin` and reads its params, its rows and its cache through it.
Without an active mesh (:func:`repro_torch.sharding.ctx.active_mesh`) the
view is :class:`LocalView`: the whole params, every row, the whole cache,
and the arithmetic the one-device code had.  Under a mesh it is
:class:`MeshView`:

* params are this rank's blocks (:func:`repro_torch.sharding.place.
  place_lm_params`); a stacked layer's leaves are gathered whole one layer
  at a time as the step reaches the layer (``gather_for_use`` under
  no_grad), a top-level leaf (the embedding, the LM head, zamba2's shared
  block) at its first use and kept to the step's end, so a rank's peak
  holds those and one layer's leaves, never the whole model; an
  expert-parallel layer's expert banks stay split over ``model``
  (``transformer.moe_dispatch`` runs ``moe_ffn_sharded`` on them), as in
  the sharded train step;
* the rows are this rank's block of the global batch along the cache's
  batch entry (every rank passes the global batch, as to the train step);
  dense compute is replicated over the other axes;
* the cache is this rank's blocks under the sanitized ``cache_specs``
  (:func:`cache_specs_for`), held in ``cache["specs"]``; prefill cuts its
  block out of what it computes for its rows, decode writes the new
  position only where this rank's block holds it and attends on the block:
  the partial softmax of its keys (running max, sum, weighted values)
  merged over the axes that split the sequence
  (:func:`repro_torch.models.layers.block_attention`), the heads gathered
  over the axes that split them.  The cache is never gathered whole.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import tree_map
from repro_torch.sharding.ctx import P, active_mesh, entry_names

Params = Dict
# cache entries that are no tensors of the model's
META_KEYS = ("len", "specs")


class _Sizes:
    """Axis sizes and nothing else: what ``sanitize`` reads."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=16)
def _param_specs(cfg, sizes: Tuple[Tuple[str, int], ...]) -> Dict[str, P]:
    from repro_torch.launch.specs import abstract_params_for
    from repro_torch.sharding import rules
    from repro_torch.sharding.place import spec_paths
    params = abstract_params_for(cfg)
    return spec_paths(rules.sanitize(rules.param_specs(params), params, _Sizes(dict(sizes))))


def param_spec_at(cfg, mesh_shape: Dict[str, int]) -> Dict[str, P]:
    """``{path: spec}`` of ``cfg``'s params under the rules, sanitized for
    a mesh of axis sizes ``mesh_shape`` (the layout
    :func:`repro_torch.sharding.place.place_lm_params` gives)."""
    return _param_specs(cfg, tuple(sorted(dict(mesh_shape).items())))


def cache_shapes(cfg, batch: int, seq: int, s_enc: Optional[int] = None) -> Dict[str, tuple]:
    """The whole shape of each tensor of ``cfg``'s cache of ``batch`` rows
    and ``seq`` positions (``s_enc`` encoder positions for whisper's cross
    k and v, the config's by default)."""
    from repro_torch.models.registry import get_api
    cache = get_api(cfg).init_cache(cfg, batch, seq, "meta")
    out = {k: tuple(v.shape) for k, v in cache.items() if k not in META_KEYS}
    if s_enc is not None:
        for k in ("cross_k", "cross_v"):
            if k in out:
                out[k] = out[k][:2] + (s_enc,) + out[k][3:]
    return out


def cache_specs_for(shapes: Dict[str, tuple], batch: int, mesh_shape: Dict[str, int]
                    ) -> Dict[str, P]:
    """The sanitized ``rules.cache_specs`` of a cache of these shapes, the
    reference's call (``data_size`` the mesh's ``data`` axis, ``model_size``
    left at its 16): heads over ``model`` where 16 divides them, else the
    sequence; the batch over (pod,) data where ``data`` divides it, else the
    sequence over data too.  ``sanitize`` drops what does not divide."""
    from repro_torch.sharding import rules
    sizes = dict(mesh_shape)
    abstract = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    raw = rules.cache_specs(abstract, batch, sizes.get("data", 1))
    return rules.sanitize(raw, abstract, _Sizes(sizes))


def _group(spec, dim: int, sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The axes that split ``dim`` of a leaf under ``spec`` (() if none or a
    group of one)."""
    if spec is None or dim >= len(spec):
        return ()
    names = entry_names(spec[dim])
    n = 1
    for a in names:
        n *= sizes[a]
    return names if n > 1 else ()


def row_axes(specs: Dict[str, P], sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The axes the cache's batch dim (dim 1 of every leaf) splits over."""
    found = {_group(s, 1, sizes) for s in specs.values()}
    if len(found) != 1:
        raise ValueError(f"the cache's leaves split their batch dims differently: {specs}")
    return found.pop()


class LocalView:
    """One device: whole params, every row, the whole cache."""

    mesh = None

    def __init__(self, params: Params):
        self.params = params
        self._positions: Dict[Tuple[int, Any], Tuple[torch.Tensor, torch.Tensor]] = {}

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def get(self, path: str) -> Any:
        t = self.params
        for k in path.split("/"):
            t = t[k]
        return t

    def layer(self, stack: str, i: int) -> Params:
        return tree_map(lambda t: t[i], self.get(stack))

    def empty(self, name: str, shape: tuple, dtype, device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=device)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t

    def write(self, blk: torch.Tensor, name: str, pos: int, val: torch.Tensor) -> None:
        blk[:, pos] = val

    def channels(self, name: str, dim: int, size: int) -> Tuple[int, int]:
        return 0, size

    def join(self, name: str, dim: int, t: torch.Tensor, at: int) -> torch.Tensor:
        return t

    def attend(self, name: str, q, k, v, pos: Optional[int], *, window=None, cap=None):
        """Decode attention of q (B, 1, Hq, Dh) on cache leaf ``name``'s
        k and v: positions 0..pos (all of them where ``pos`` is None, the
        cross attention)."""
        from repro_torch.models import layers as L
        if pos is None:
            return L.attention_scores(q, k, v, causal=False)
        key = (pos, q.device)
        if key not in self._positions:          # made once a step, not once a layer
            self._positions[key] = (torch.full((1,), pos, device=q.device),
                                    torch.arange(pos + 1, device=q.device))
        q_pos, k_pos = self._positions[key]
        return L.attention_scores(q, k[:, :pos + 1], v[:, :pos + 1], causal=False, window=window,
                                  cap=cap, q_positions=q_pos, k_positions=k_pos, k_len=pos + 1)

    def finish(self, cache: Dict) -> Dict:
        return cache

    def seq_len(self, name: str, leaf: torch.Tensor) -> int:
        """The whole sequence length of cache leaf ``name`` (L, B, S, ...)."""
        return leaf.shape[2]

    def check_room(self, name: str, leaf: torch.Tensor, pos: int) -> None:
        """Raise where decode would write position ``pos`` past the end of
        cache leaf ``name``."""
        n = self.seq_len(name, leaf)
        if pos >= n:
            raise ValueError(f"the cache holds {n} positions; it is full")


class MeshView(LocalView):
    """This rank's part of a step over ``mesh`` (module docstring).
    ``specs``: the cache's sanitized specs; ``tokens_per_row``: the tokens
    each row puts through the layers (an MoE layer runs expert-parallel on
    this rank's rows times that many tokens where ``train.step.ep_layer``
    says so, as the train step decides)."""

    def __init__(self, params: Params, cfg, mesh, specs: Dict[str, P], batch: int,
                 tokens_per_row: int):
        super().__init__(params)
        from repro_torch.models.moe import data_axes
        from repro_torch.train.step import ep_layer
        self.cfg, self.mesh, self.specs = cfg, mesh, dict(specs)
        self.sizes = dict(mesh.shape)
        self.row_axes = row_axes(self.specs, self.sizes)
        self.spec_at = param_spec_at(cfg, self.sizes)
        dax = data_axes(mesh)
        if cfg.moe is not None and mesh.size_of(dax) > 1 and self.row_axes != dax:
            raise ValueError(f"{cfg.name}: an MoE layer under a mesh takes its tokens split "
                             f"over {dax}; this cache splits its rows over {self.row_axes}")
        self.n_rows = mesh.size_of(self.row_axes) if self.row_axes else 1
        if batch % self.n_rows:
            raise ValueError(f"a batch of {batch} rows does not split over {self.n_rows} "
                             f"ranks of {self.row_axes}")
        self.ep = ep_layer(cfg, mesh, batch // self.n_rows * tokens_per_row)
        self._whole: Dict[str, Any] = {}

    def _keep(self, path: str, ndim: int) -> bool:
        from repro_torch.train.step import expert_bank
        return self.ep and expert_bank(path, ndim)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        if not self.row_axes:
            return t
        step = t.shape[0] // self.n_rows
        return t.narrow(0, self.mesh.index_of(self.row_axes) * step, step)

    def _use(self, t: torch.Tensor, spec, keep: bool) -> torch.Tensor:
        from repro_torch.sharding.place import gather_for_use
        with torch.no_grad():
            return gather_for_use(t, spec, self.mesh, keep_model=keep)

    def get(self, path: str) -> Any:
        """The whole leaf (or subtree) at ``path``, gathered at its first
        use in this call and kept to the call's end: the tied embedding
        serves the embedding and the head, zamba2's shared block every
        site."""
        if path not in self._whole:
            t = super().get(path)
            self._whole[path] = self._tree(t, path, None) if isinstance(t, dict) \
                else self._use(t, self.spec_at[path], False)
        return self._whole[path]

    def _tree(self, tree, prefix: str, i: Optional[int]):
        out = {}
        for k, t in tree.items():
            path = f"{prefix}/{k}"
            if isinstance(t, dict):
                out[k] = self._tree(t, path, i)
                continue
            spec = self.spec_at[path]
            if i is not None:
                t, spec = self._layer_block(t, spec, i), P(*spec[1:])
            out[k] = self._use(t, spec, self._keep(path, t.dim() + (i is not None)))
        return out

    def _layer_block(self, t: torch.Tensor, spec, i: int) -> torch.Tensor:
        """Layer ``i``'s block of a stacked leaf.  Where the rules split the
        layer dim itself (a dense FFN's (L, D, F) leaves take the expert
        banks' rule, ``model`` on dim 0), the rank that holds layer i
        broadcasts its block over that axis."""
        axes = _group(spec, 0, self.sizes)
        if not axes:
            return t[i]
        if len(axes) != 1:
            raise ValueError(f"a layer dim split over {axes}: one axis is supported")
        per = t.shape[0]
        with torch.no_grad():
            return self.mesh.broadcast(t[i % per].clone(), axes[0], src=i // per)

    def layer(self, stack: str, i: int) -> Params:
        return self._tree(super().get(stack), stack, i)

    def _range(self, name: str, dim: int, size_loc: int) -> Tuple[Tuple[str, ...], int]:
        axes = _group(self.specs[name], dim, self.sizes)
        return axes, (self.mesh.index_of(axes) * size_loc if axes else 0)

    def empty(self, name: str, shape: tuple, dtype, device) -> torch.Tensor:
        from repro_torch.sharding.place import block_shape
        return torch.empty(block_shape(shape, self.specs[name], self.sizes), dtype=dtype,
                           device=device)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of one layer's entry ``t`` of leaf ``name``,
        computed whole for this rank's rows (the leaf's dims less L)."""
        spec = self.specs[name]
        for d in range(2, len(spec)):
            axes = _group(spec, d, self.sizes)
            if axes:
                step = t.shape[d - 1] // self.mesh.size_of(axes)
                t = t.narrow(d - 1, self.mesh.index_of(axes) * step, step)
        return t

    def write(self, blk: torch.Tensor, name: str, pos: int, val: torch.Tensor) -> None:
        """Position ``pos``'s ``val`` (B_loc, ...whole) into one layer's
        block ``blk`` (B_loc, S_loc, ...), only where the block holds it."""
        axes, lo = self._range(name, 2, blk.shape[1])
        if lo <= pos < lo + blk.shape[1]:
            spec = self.specs[name]
            for d in range(3, len(spec)):
                hx = _group(spec, d, self.sizes)
                if hx:
                    step = val.shape[d - 2] // self.mesh.size_of(hx)
                    val = val.narrow(d - 2, self.mesh.index_of(hx) * step, step)
            blk[:, pos - lo] = val

    def channels(self, name: str, dim: int, size: int) -> Tuple[int, int]:
        """(first, count) of this rank's block of dim ``dim`` (of the whole
        leaf) of ``size``."""
        axes = _group(self.specs[name], dim, self.sizes)
        if not axes:
            return 0, size
        n = size // self.mesh.size_of(axes)
        return self.mesh.index_of(axes) * n, n

    def join(self, name: str, dim: int, t: torch.Tensor, at: int) -> torch.Tensor:
        """``t``'s blocks along ``at`` gathered over the axes that split dim
        ``dim`` of leaf ``name``."""
        axes = _group(self.specs[name], dim, self.sizes)
        return self.mesh.all_gather_tensor(t, axes, at) if axes else t

    def attend(self, name: str, q, k, v, pos: Optional[int], *, window=None, cap=None):
        from repro_torch.models import layers as L
        hx = _group(self.specs[name], 3, self.sizes)
        b, sq, hq, dh = q.shape
        h_loc = k.shape[2]
        if hx:
            g = hq // (h_loc * self.mesh.size_of(hx))
            h0 = self.mesh.index_of(hx) * h_loc
            q = q.reshape(b, sq, hq // g, g, dh)[:, :, h0:h0 + h_loc].reshape(b, sq, h_loc * g, dh)
        sx, lo = self._range(name, 2, k.shape[1])
        o = L.block_attention(q, k, v, lo=lo, pos=pos, window=window, cap=cap,
                              mesh=self.mesh, axes=sx)
        return self.mesh.all_gather_tensor(o, hx, 2) if hx else o

    def attend_latent(self, q_lat, q_rope, ckv, krope, pos: int, *, scale: float, cap):
        """MLA's absorbed decode on this rank's block of ``ckv`` / ``krope``."""
        from repro_torch.models import layers as L
        sx, lo = self._range("ckv", 2, ckv.shape[1])
        return L.mla_block_attention(q_lat, q_rope, ckv, krope, lo=lo, pos=pos, cap=cap,
                                     scale=scale, mesh=self.mesh, axes=sx)

    def finish(self, cache: Dict) -> Dict:
        return dict(cache, specs=self.specs)

    def seq_len(self, name: str, leaf: torch.Tensor) -> int:
        axes = _group(self.specs[name], 2, self.sizes)
        return leaf.shape[2] * (self.mesh.size_of(axes) if axes else 1)


def begin(params: Params, cfg, batch: int, tokens_per_row: int,
          cache: Optional[Dict] = None, seq: Optional[int] = None,
          s_enc: Optional[int] = None):
    """The view of one step: :class:`LocalView` without an active mesh;
    under one, :class:`MeshView` with the cache's specs (``cache["specs"]``
    at decode, or :func:`cache_specs_for` of the cache of ``seq`` positions,
    and ``s_enc`` encoder positions, that prefill will write for a global
    batch of ``batch`` rows)."""
    mesh = active_mesh()
    if mesh is None:
        return LocalView(params)
    if cache is not None:
        if "specs" not in cache:
            raise ValueError("a cache under a mesh holds its specs: make it with "
                             "repro_torch.sharding.place.place_lm_cache or a prefill under "
                             "the mesh")
        specs = cache["specs"]
    else:
        specs = cache_specs_for(cache_shapes(cfg, batch, seq, s_enc), batch, mesh.shape)
    return MeshView(params, cfg, mesh, specs, batch, tokens_per_row)
