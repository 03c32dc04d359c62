"""The port's LITE training estimators against the JAX package's, on the
same numpy inputs, the same parameters and the same H subsets: the port is
given the scores that the JAX package's ``_index_scores(key_t, n)`` draws
for each task key, so both back-propagate the same examples.

Each case takes the value and the parameter gradients of ``sum(out * R)``
(R a fixed random cotangent) for ``lite_sum``, ``lite_segment_sum`` and
``lite_class_stats`` (per-class sums and second moments, port ``ref``
against JAX ``ref`` and port ``cuda`` on CPU tensors against JAX
``pallas`` in interpret mode), in exact mode, in LITE mode (h 3, chunks of
2) with and without padding, with ``compute_dtype="bfloat16"``, and for
the naive baseline ``subsampled_task_sum``.

Tolerances, relative to each output's or gradient's max|reference|:
TOL = 1e-5 for fp32 (measured at most 3.1e-7); with a bf16 complement the
value is held to TOL_BF16 = 2e-2 of the fp32 value (measured 1.9e-3:
bf16 inputs and params, fp32 accumulation) and the gradients to TOL, since
they flow through the fp32 H pass alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lite as jlite
from repro.kernels import dispatch as jd
from repro_torch.core import lite as tlite

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
TOL_BF16 = 2e-2
T, N, D, F, C = 3, 11, 6, 5, 3
PAD = (0, 3, 5)                      # padded rows at the end of each task


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(pad=True, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, N, D)).astype(np.float32)
    ys = rng.integers(0, C, (T, N)).astype(np.int32)
    ys[:, :C] = np.arange(C)
    mask = np.ones((T, N), np.float32)
    if pad:
        for t, p in enumerate(PAD):
            if p:
                mask[t, -p:] = 0.0
                ys[t, -p:] = -1
                xs[t, -p:] = 0.0
    params = dict(w=(rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
                  b=rng.standard_normal((F,)).astype(np.float32))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(T))
    scores = np.array(jax.vmap(lambda k: jlite._index_scores(k, N))(keys))
    return xs, ys, mask, params, keys, scores


def _encode(p, x):
    """A small nonlinear encoder; the same formula in both packages."""
    lib = jnp if isinstance(x, jax.Array) else torch
    return lib.tanh(x @ p["w"]) + p["b"]


def _grads_both(j_fn, t_fn, params, seed=1):
    """Value and parameter gradients of sum(out * R) over every output leaf
    in both packages; R fixed per leaf."""
    jout = jax.jit(j_fn)(params)
    rs = jax.tree.map(lambda o: np.random.default_rng(seed).standard_normal(
        o.shape).astype(np.float32), jout)
    jgrad = jax.jit(jax.grad(lambda p: sum(jnp.sum(o * r) for o, r in zip(
        jax.tree.leaves(j_fn(p)), jax.tree.leaves(rs)))))(params)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tout = t_fn(tp)
    loss = sum((o * torch.from_numpy(r)).sum() for o, r in zip(
        jax.tree.leaves(tout), jax.tree.leaves(rs)))
    loss.backward()
    return jout, tout, jgrad, {k: v.grad for k, v in tp.items()}


def _check(jout, tout, jgrad, tgrad, tol=TOL):
    for o_j, o_t in zip(jax.tree.leaves(jout), jax.tree.leaves(tout)):
        assert _rel(o_t.detach().numpy(), o_j) <= tol
    for k in jgrad:
        assert _rel(tgrad[k].numpy(), jgrad[k]) <= TOL, k


SPECS = {
    "exact": dict(exact=True),
    "lite": dict(h=3, chunk_size=2),
    "lite_one_chunk": dict(h=4),
}


@pytest.mark.parametrize("spec,pad", [("exact", True), ("lite", False), ("lite", True),
                                      ("lite_one_chunk", True)])
def test_lite_sum_matches_jax(spec, pad):
    xs, _, mask, params, keys, scores = _inputs(pad)
    js, ts = jlite.LiteSpec(**SPECS[spec]), tlite.LiteSpec(**SPECS[spec])
    j_fn = lambda p: jax.vmap(lambda x, m, k: jlite.lite_sum(
        _encode, p, x, k, js, mask=m))(xs, mask, keys)
    t_fn = lambda p: tlite.lite_sum(_encode, p, torch.from_numpy(xs), ts,
                                    torch.from_numpy(mask), torch.from_numpy(scores))
    _check(*_grads_both(j_fn, t_fn, params))


@pytest.mark.parametrize("t_backend,j_backend", [("ref", "ref"), ("cuda", "pallas")])
@pytest.mark.parametrize("spec", ["exact", "lite"])
def test_lite_segment_sum_matches_jax(spec, t_backend, j_backend):
    xs, ys, mask, params, keys, scores = _inputs()
    js, ts = jlite.LiteSpec(**SPECS[spec]), tlite.LiteSpec(**SPECS[spec])

    def j_fn(p):
        with jd.use_backend(j_backend):
            return jax.vmap(lambda x, y, m, k: jlite.lite_segment_sum(
                _encode, p, x, y, C, k, js, mask=m))(xs, ys, mask, keys)

    def t_fn(p):
        return tlite.lite_segment_sum(_encode, p, torch.from_numpy(xs),
                                      torch.from_numpy(ys).long(), C, ts,
                                      torch.from_numpy(mask), torch.from_numpy(scores),
                                      backend=t_backend)
    jout, tout, jgrad, tgrad = _grads_both(j_fn, t_fn, params)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))   # counts
    _check(jout[0], tout[0], jgrad, tgrad)


@pytest.mark.parametrize("t_backend,j_backend", [("ref", "ref"), ("cuda", "pallas")])
@pytest.mark.parametrize("spec", ["exact", "lite"])
def test_lite_class_stats_matches_jax(spec, t_backend, j_backend):
    """Class sums and raw second moments, the kernels' backward included."""
    xs, ys, mask, params, keys, scores = _inputs()
    js, ts = jlite.LiteSpec(**SPECS[spec]), tlite.LiteSpec(**SPECS[spec])

    def j_fn(p):
        with jd.use_backend(j_backend):
            return jax.vmap(lambda x, y, m, k: jlite.lite_class_stats(
                _encode, p, x, y, C, k, js, mask=m, second_moment=True)[0])(
                    xs, ys, mask, keys)

    def t_fn(p):
        return tlite.lite_class_stats(_encode, p, torch.from_numpy(xs),
                                      torch.from_numpy(ys).long(), C, ts,
                                      torch.from_numpy(mask), torch.from_numpy(scores),
                                      second_moment=True, backend=t_backend)[0]
    _check(*_grads_both(j_fn, t_fn, params))


def test_bf16_complement_keeps_gradients():
    """compute_dtype="bfloat16": the value within bf16 rounding of the fp32
    estimator's, the gradients those of the fp32 H pass, as in JAX."""
    xs, ys, mask, params, keys, scores = _inputs()
    spec = SPECS["lite"]
    outs = {}
    for cd in (None, "bfloat16"):
        js, ts = jlite.LiteSpec(**spec, compute_dtype=cd), tlite.LiteSpec(**spec, compute_dtype=cd)
        j_fn = lambda p: jax.vmap(lambda x, y, m, k: jlite.lite_segment_sum(
            _encode, p, x, y, C, k, js, mask=m)[0])(xs, ys, mask, keys)
        t_fn = lambda p: tlite.lite_segment_sum(
            _encode, p, torch.from_numpy(xs), torch.from_numpy(ys).long(), C, ts,
            torch.from_numpy(mask), torch.from_numpy(scores))[0]
        outs[cd] = _grads_both(j_fn, t_fn, params)
    jout, tout, jgrad, tgrad = outs["bfloat16"]
    assert tout.dtype == torch.float32
    assert _rel(tout.detach().numpy(), outs[None][1].detach().numpy()) <= TOL_BF16
    assert _rel(tout.detach().numpy(), jout) <= TOL_BF16
    for k in jgrad:
        assert _rel(tgrad[k].numpy(), outs[None][3][k].numpy()) <= TOL
        assert _rel(tgrad[k].numpy(), jgrad[k]) <= TOL


def test_subsampled_task_sum_matches_jax():
    xs, _, mask, params, keys, scores = _inputs()
    js, ts = jlite.LiteSpec(h=3), tlite.LiteSpec(h=3)
    j_fn = lambda p: jax.vmap(lambda x, m, k: jlite.subsampled_task_sum(
        _encode, p, x, k, js, mask=m))(xs, mask, keys)
    t_fn = lambda p: tlite.subsampled_task_sum(
        _encode, p, torch.from_numpy(xs), ts, torch.from_numpy(mask),
        torch.from_numpy(scores))
    _check(*_grads_both(j_fn, t_fn, params))


def test_complement_runs_without_grad_one_chunk_at_a_time():
    """One differentiable encode call over the T x h subset; every other
    call runs under no_grad on a chunk of T x chunk_size rows."""
    xs, _, mask, params, _, scores = _inputs()
    calls = []

    def enc(p, x):
        calls.append((torch.is_grad_enabled(), x.shape[0], p["w"].requires_grad))
        return _encode(p, x)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tlite.lite_sum(enc, tp, torch.from_numpy(xs), tlite.LiteSpec(h=3, chunk_size=2),
                   torch.from_numpy(mask), torch.from_numpy(scores))
    assert calls[0] == (True, T * 3, True)
    assert calls[1:] and all(c == (False, T * 2, False) for c in calls[1:])
    assert len(calls) == 1 + -(-(N - 3) // 2)


def test_samplers_match_jax_and_keep_their_contracts():
    xs, ys, mask, params, keys, scores = _inputs()
    ts, tm = torch.from_numpy(scores), torch.from_numpy(mask)
    h_t, c_t = tlite.sample_h_indices(ts, 4, tm)
    strat_t = tlite.sample_stratified_indices(ts, torch.from_numpy(ys).long(), C, 4, tm)
    h_j, c_j, s_j = jax.jit(jax.vmap(lambda k, y, m: jlite.sample_h_indices(k, N, 4, m)
                                     + (jlite.sample_stratified_indices(k, y, C, 4, m),)))(
        keys, ys, mask)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(strat_t.numpy(), np.asarray(s_j))
    for t in range(T):
        # padded rows never enter H while real rows remain; >= 1 a class
        assert (mask[t][h_t[t].numpy()] == 1).all()
        assert set(ys[t][strat_t[t].numpy()]) >= set(range(C))


def test_index_scores_contract():
    """A pure function of (seed, step, task, example): padding a task to a
    larger N keeps its scores and so its H draw; other steps, tasks and
    seeds draw otherwise; values in [0, 1)."""
    a = tlite.index_scores(3, 5, range(4), 10)
    b = tlite.index_scores(3, 5, range(4), 16)
    assert a.dtype == torch.float32 and a.shape == (4, 10)
    assert ((a >= 0) & (a < 1)).all()
    np.testing.assert_array_equal(a.numpy(), b[:, :10].numpy())
    np.testing.assert_array_equal(a[2:].numpy(),
                                  tlite.index_scores(3, 5, [2, 3], 10).numpy())
    for other in (tlite.index_scores(3, 6, range(4), 10),
                  tlite.index_scores(4, 5, range(4), 10)):
        assert (other != a).float().mean() > 0.9
    assert len(torch.unique(a[0])) == 10 and (a[0] != a[1]).all()
    mask = torch.ones(4, 16)
    mask[:, 10:] = 0
    np.testing.assert_array_equal(tlite.sample_h_indices(a, 4)[0].numpy(),
                                  tlite.sample_h_indices(b, 4, mask)[0].numpy())


def test_straight_through_value_and_gradient():
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    full = torch.tensor([[10.0, 20.0], [30.0, 40.0]])
    out = tlite.straight_through(full, g * 1.0, torch.tensor([2.0, 0.5]))
    assert torch.equal(out.detach(), full)
    out.sum().backward()
    assert torch.equal(g.grad, torch.tensor([[2.0, 2.0], [0.5, 0.5]]))
