"""The port's feature extractors against the JAX package on identical
weights (carried with repro_torch.bridge): conv backbone features with and
without FiLM and with the int8 head, and the conv set encoder.  fp32 on both
sides; tolerance 1e-5 relative to max|out| (XLA's and PyTorch's CPU
convolutions sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.film import apply_film as j_apply_film
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.core.set_encoder import encode_set as j_encode_set
from repro.core.set_encoder import init_set_encoder as j_init_set
from repro.kernels import dispatch as jd
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import conv_features as j_features
from repro.models.conv_backbone import init_conv_backbone as j_init_bb
from repro.optim.quant import quantize as j_quantize
from repro_torch.bridge import params_from_numpy
from repro_torch.core.film import apply_film
from repro_torch.core.set_encoder import SetEncoderConfig, encode_set
from repro_torch.kernels import dispatch as td
from repro_torch.models.conv_backbone import ConvBackboneConfig, conv_features

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
WIDTHS, FDIM = (8, 16), 40


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def bb():
    jp = j_init_bb(jax.random.key(3), JBBCfg(widths=WIDTHS, feature_dim=FDIM))
    return jp, params_from_numpy(_np(jp), device="cpu")


@pytest.mark.parametrize("film_kind", ["none", "shared", "per_task"])
@pytest.mark.parametrize("image_size", [16, 3])
def test_conv_features_match(bb, film_kind, image_size):
    jp, tp = bb
    rng = np.random.default_rng(0)
    t, n = 3, 4
    x = rng.standard_normal((t * n, image_size, image_size, 3)).astype(np.float32)
    jcfg = JBBCfg(widths=WIDTHS, feature_dim=FDIM)
    tcfg = ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)
    if film_kind == "none":
        want = j_features(jp, jnp.asarray(x), None, jcfg)
        got = conv_features(tp, torch.from_numpy(x), None, tcfg)
    else:
        lead = (t,) if film_kind == "per_task" else ()
        film = [dict(gamma=0.3 * rng.standard_normal(lead + (w,)).astype(np.float32),
                     beta=0.3 * rng.standard_normal(lead + (w,)).astype(np.float32))
                for w in WIDTHS]
        if film_kind == "per_task":     # JAX runs one task at a time (vmap)
            want = np.concatenate([np.asarray(j_features(
                jp, jnp.asarray(x[i * n:(i + 1) * n]),
                [{k: jnp.asarray(v[i]) for k, v in f.items()} for f in film],
                jcfg)) for i in range(t)])
        else:
            want = j_features(jp, jnp.asarray(x), _np(film), jcfg)
        tfilm = [{k: torch.from_numpy(v) for k, v in f.items()} for f in film]
        got = conv_features(tp, torch.from_numpy(x), tfilm, tcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("t_backend,j_backend", [("ref", "ref"), ("cuda", "pallas")])
def test_conv_features_int8_head_match(bb, t_backend, j_backend):
    jp, _ = bb
    jq = dict(jp, head=dict(jp["head"], w=j_quantize(jp["head"]["w"])))
    tp = params_from_numpy(_np(jq), device="cpu")
    assert tp["head"]["w"]["q"].dtype == torch.int8
    x = np.random.default_rng(1).standard_normal((6, 16, 16, 3)).astype(np.float32)
    with jd.use_backend(j_backend):
        want = j_features(jq, jnp.asarray(x), None,
                          JBBCfg(widths=WIDTHS, feature_dim=FDIM))
    with td.use_backend(t_backend):
        got = conv_features(tp, torch.from_numpy(x), None,
                            ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM))
    _close(got.numpy(), want)


def test_encode_set_match():
    jcfg = JSetCfg(kind="conv", conv_blocks=2, conv_width=8, task_dim=16)
    jp = j_init_set(jax.random.key(5), jcfg)
    tp = params_from_numpy(_np(jp), device="cpu")
    assert tp["blocks"][0]["w"].shape == (8, 3, 3, 3)          # OIHW
    x = np.random.default_rng(2).standard_normal((7, 16, 16, 3)).astype(np.float32)
    want = j_encode_set(jp, jnp.asarray(x), jcfg)
    got = encode_set(tp, torch.from_numpy(x),
                     SetEncoderConfig(kind="conv", conv_blocks=2, conv_width=8,
                                      task_dim=16))
    _close(got.numpy(), want)


def test_apply_film_shared_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 5, 6)).astype(np.float32)       # NHWC
    g, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    want = j_apply_film(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = apply_film(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(g),
                     torch.from_numpy(b), channel_axis=1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
