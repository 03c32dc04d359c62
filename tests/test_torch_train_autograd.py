"""Gradients of the three differentiable dispatch ops against the JAX
package's, and the guard that keeps a kernel out of autograd's sight.

On the ``cuda`` backend each op reaches its kernel through a
``torch.autograd.Function`` whose backward is the JAX package's
``custom_vjp`` backward written over the task-lane axis.  On CPU tensors
the Function's forward runs the kernel's plain version, so these tests
hold the port's ``cuda`` path (plain forward + the Function's backward)
against ``jax.grad`` through the JAX ``pallas`` backend (interpret mode),
and the port's ``ref`` against the JAX ``ref``, on the same numpy inputs
and the same cotangent.  The CUDA kernels themselves run only on a card
(chip_smoke.py holds the gradients there).

Tolerance: TOL = 1e-5 of each gradient's max|reference| (fp32 sums in
other orders; measured at most 2.6e-7, the Mahalanobis head's Cholesky
gradient through ``cholesky_inverse`` included, compared on the lower
triangle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jd
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import flash_attention, gmm, int8_matmul, mahalanobis
from repro_torch.kernels import segment_pool, ssd_scan
from repro_torch.kernels._checks import require_no_grad

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
BACKENDS = [("ref", "ref"), ("cuda", "pallas")]      # (port, JAX)
T, B, F, C, M = 3, 9, 12, 4, 5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _onehot(rng, pad=2):
    w = np.eye(C, dtype=np.float32)[rng.integers(0, C, (T, B))]
    w[:, B - pad:] = 0.0                       # collator padding rows
    return w


def _spd_chol(rng):
    a = rng.standard_normal((T, C, F, F)).astype(np.float32) / np.sqrt(F)
    sigma = a @ np.swapaxes(a, -1, -2) + np.eye(F, dtype=np.float32)
    return np.linalg.cholesky(sigma.astype(np.float64)).astype(np.float32)


def _both(op_t, op_j, args, t_backend, j_backend, seed):
    """Value and input gradients of ``sum(op(args) * R)`` in both packages,
    R a fixed random cotangent; the JAX op is vmapped over T."""
    out_shape = jax.eval_shape(lambda *a: jax.vmap(lambda *x: op_j(*x, j_backend))(*a),
                               *args).shape
    r = np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)

    def j_loss(*a):
        return jnp.sum(jax.vmap(lambda *x: op_j(*x, j_backend))(*a) * r)
    jval = jax.vmap(lambda *x: op_j(*x, j_backend))(*args)
    jgrads = jax.grad(j_loss, argnums=tuple(range(len(args))))(*args)

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = op_t(*targs, t_backend)
    (out * torch.from_numpy(r)).sum().backward()
    return out, jval, [a.grad for a in targs], jgrads


OPS = {
    "segment_sum": (lambda e, w, b: td.segment_sum(e, w, backend=b),
                    lambda e, w, b: jd.segment_sum(e, w, backend=b),
                    lambda rng: (rng.standard_normal((T, B, F)).astype(np.float32),
                                 _onehot(rng)), "_SegmentSum"),
    "class_second_moment": (lambda f, w, b: td.class_second_moment(f, w, backend=b),
                            lambda f, w, b: jd.class_second_moment(f, w, backend=b),
                            lambda rng: (rng.standard_normal((T, B, F)).astype(np.float32),
                                         _onehot(rng)), "_SecondMoment"),
    "mahalanobis_head": (lambda q, mu, L, b: td.mahalanobis_head(q, mu, L, backend=b),
                         lambda q, mu, L, b: jd.mahalanobis_head(q, mu, L, backend=b),
                         lambda rng: (rng.standard_normal((T, M, F)).astype(np.float32),
                                      rng.standard_normal((T, C, F)).astype(np.float32),
                                      _spd_chol(rng)), "_Mahalanobis"),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_op_gradients_match_jax(op, t_backend, j_backend):
    op_t, op_j, make, fn_name = OPS[op]
    args = make(np.random.default_rng(0))
    out, jval, tgrads, jgrads = _both(op_t, op_j, args, t_backend, j_backend, seed=1)
    assert _rel(out.detach().numpy(), jval) <= TOL
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        tg, jg = tg.numpy(), np.asarray(jg)
        if op == "mahalanobis_head" and i == 2:
            # only the lower triangle of a Cholesky factor is a variable:
            # the JAX solve reads just that triangle, torch's inverse the
            # whole matrix; the Cholesky's own backward reads the lower
            # triangle of its cotangent alone
            tg, jg = np.tril(tg), np.tril(jg)
        assert _rel(tg, jg) <= TOL, (op, i)
    # the cuda backend's gradient comes from the op's autograd.Function
    names = set()
    fn = out.grad_fn
    while fn is not None and len(names) < 50:
        names.add(type(fn).__name__)
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert any(fn_name in n for n in names) == (t_backend == "cuda"), names


def test_second_moment_backward_symmetrises():
    """An asymmetric cotangent on the (symmetric) second moment: the
    Function's df takes g + g^T, as finite differences of the forward do."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((1, 4, 3), np.float32)).requires_grad_(True)
    w = torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, (1, 4))])
    g = torch.from_numpy(rng.standard_normal((1, 2, 3, 3), np.float32))
    out = td._SecondMoment.apply(f, w)
    (df,) = torch.autograd.grad((out * g).sum(), f)
    want = torch.autograd.functional.vjp(
        lambda x: torch.einsum("tbc,tbi,tbj->tcij", w, x, x), f.detach(), g)[1]
    assert _rel(df.numpy(), want.numpy()) <= TOL


def _meta(*shape, dtype=torch.float32, grad=True):
    t = torch.empty(*shape, device="meta", dtype=dtype)
    return t.requires_grad_(True) if grad else t


WRAPPERS = {
    "segment_pool_weighted": lambda g: segment_pool.segment_pool_weighted(
        _meta(2, 3, 4, grad=g), _meta(2, 3, 5)),
    "class_second_moment": lambda g: segment_pool.class_second_moment(
        _meta(2, 3, 4, grad=g), _meta(2, 3, 5)),
    "mahalanobis": lambda g: mahalanobis.mahalanobis(
        _meta(2, 3, 4, grad=g), _meta(2, 5, 4), _meta(2, 5, 4, 4)),
    "int8_matmul": lambda g: int8_matmul.int8_matmul(
        _meta(3, 4, grad=g), _meta(4, 8, dtype=torch.int8, grad=False),
        _meta(4, 1, grad=False)),
    "gmm": lambda g: gmm.gmm(_meta(2, 3, 4, grad=g), _meta(2, 4, 5)),
    "flash_attention": lambda g: flash_attention.flash_attention(
        _meta(2, 8, 16, grad=g), _meta(2, 8, 16), _meta(2, 8, 16)),
    "ssd_chunk": lambda g: ssd_scan.ssd_chunk(
        _meta(2, 8, 16, grad=g), _meta(2, 8), _meta(2), _meta(2, 8, 16),
        _meta(2, 8, 16)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrappers_refuse_grad_outside_their_function(name):
    """Every kernel wrapper's device path (reached here with "meta" tensors,
    which are not CPU tensors) refuses a tensor that requires grad while
    grad mode is on, before anything else; under no_grad the guard passes
    and the argument checks (CUDA tensors only) refuse instead."""
    call = WRAPPERS[name]
    with pytest.raises(RuntimeError, match="outside its autograd.Function"):
        call(True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        call(True)
    # the remaining operands require grad too (int8 q cannot); with the
    # first one detached the guard still fires, except for int8_matmul
    # whose int8 weight carries no grad
    if name != "int8_matmul":
        with pytest.raises(RuntimeError, match="outside its autograd.Function"):
            call(False)


def test_require_no_grad_contract():
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="x_kernel"):
        require_no_grad("x_kernel", torch.ones(2), x)
    with torch.no_grad():
        require_no_grad("x_kernel", x)
    with torch.inference_mode():
        require_no_grad("x_kernel", torch.ones(2))
    require_no_grad("x_kernel", x.detach())
