"""The port's abstract specs (``repro_torch.launch.specs``) against the JAX
package's ``repro.launch.specs``, on the CPU.

* ``abstract_params_for``: the same paths, shapes and dtypes as the
  reference's ``jax.ShapeDtypeStruct`` tree for all ten archs at full
  config, every leaf on ``meta`` (nothing allocated);
* ``abstract_cache_for``: the same for the ``decode_32k`` and
  ``prefill_32k`` caches, but for one layout difference the test names:
  ``len`` is a Python ``int`` in the port and an int32 scalar in the
  reference;
* ``batch_specs_for``: the reference's keys and shapes in every (arch x
  shape) cell, ``frontend_embeds`` in its dtype; the tokens are int64, the
  port's index dtype, where the reference's are int32 (the stated
  difference);
* at the smoke configs, the abstract trees against a real ``init`` and
  ``init_cache`` on the CPU.

All comparisons are exact; the card's own check of full-size trees
against real ones is phase 1b of ``chip_smoke.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch import specs as J
from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import specs as T
from repro_torch.models.registry import get_api

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCHS = treg.ARCH_IDS
CELLS = [(a, s.name) for a in ARCHS for s in tbase.SHAPES]


def _torch_specs(tree) -> dict:
    """{path: (shape, dtype name)} of a tree's tensors; other leaves as they
    are."""
    return {p: (tuple(t.shape), str(t.dtype).split(".")[1]) if isinstance(t, torch.Tensor)
            else t for p, t in tree_paths(tree).items()}


def _jax_specs(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[p] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference(arch):
    got = T.abstract_params_for(treg.get_config(arch))
    assert all(t.is_meta for t in tree_leaves(got))
    assert _torch_specs(got) == _jax_specs(J.abstract_params_for(jreg.get_config(arch)))


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_equals_the_reference_but_len(arch, shape):
    got = T.abstract_cache_for(treg.get_config(arch), tbase.SHAPES_BY_NAME[shape])
    want = _jax_specs(J.abstract_cache_for(jreg.get_config(arch), jbase.SHAPES_BY_NAME[shape]))
    assert all(t.is_meta for t in tree_leaves(got) if isinstance(t, torch.Tensor))
    got = _torch_specs(got)
    # the one layout difference: len is the host's int here, an int32
    # scalar in the reference
    assert got.pop("len") == 0 and want.pop("len") == ((), "int32")
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_equal_the_reference(arch, shape):
    got = _torch_specs(T.batch_specs_for(treg.get_config(arch), tbase.SHAPES_BY_NAME[shape]))
    want = _jax_specs(J.batch_specs_for(jreg.get_config(arch), jbase.SHAPES_BY_NAME[shape]))
    # the stated difference: int64 tokens (the port's index dtype), int32
    # in the reference
    assert got.pop("tokens") == (want.pop("tokens")[0], "int64")
    assert got == want


def test_shape_by_name():
    for s in tbase.SHAPES:
        assert T.shape_by_name(s.name) is s
    with pytest.raises(KeyError):
        T.shape_by_name("train_1m")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_specs_match_a_real_init_at_smoke_config(arch):
    cfg = treg.get_smoke_config(arch)
    api = get_api(cfg)
    real = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(real))
    assert _torch_specs(T.abstract_params_for(cfg)) == _torch_specs(real)
    shape = tbase.ShapeSpec("smoke", 32, 2, "decode")
    assert _torch_specs(T.abstract_cache_for(cfg, shape)) == \
        _torch_specs(api.init_cache(cfg, 2, 32, "cpu"))
