"""The port's numpy data path and its int8 quantization, bit-exact with the
JAX package on the same inputs: quantize/dequantize (round half to even,
the 1e-12 scale floor), plan_buckets, bucket_for, collate_task_batch,
iter_query_chunks and host_task_batch_at."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.episodic import Task as JTask
from repro.data import episodic as jdata
from repro.optim import quant as jquant
from repro_torch.core.episodic import Task as TTask
from repro_torch.data import episodic as tdata
from repro_torch.optim import quant as tquant

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7,), (3, 130), (2, 3, 4, 260), (5, 128)])
def test_quantize_dequantize_bit_exact(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    if x.ndim > 1:
        x[0] = 0.0                      # an all-zero block: the 1e-12 floor
    jq = jquant.quantize(jnp.asarray(x))
    tq = tquant.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    assert tq["n"] == jq["n"]
    np.testing.assert_array_equal(tquant.dequantize(tq).numpy(),
                                  np.asarray(jquant.dequantize(jq)))


def test_quantize_rounds_half_to_even():
    # absmax 127 gives scale 1.0, so the block's values round as they are
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    jq = jquant.quantize(jnp.asarray(x))
    tq = tquant.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["q"].numpy()[0, 1:],
                                  np.array([0, 2, 2, 0, -2, -2, 4], np.int8))
    assert tquant.resolve_n(tq) == jquant.resolve_n(jq) == 8


@pytest.mark.parametrize("sizes,max_buckets", [
    ([50, 50, 33, 12, 7, 64, 65, 100], 2),
    ([5, 9, 17, 33, 65, 129], 3),
    ([40], 4),
])
def test_plan_buckets_and_bucket_for_match(sizes, max_buckets):
    plan = tdata.plan_buckets(sizes, max_buckets=max_buckets)
    assert plan == jdata.plan_buckets(sizes, max_buckets=max_buckets)
    for s in sizes:
        assert tdata.bucket_for(s, plan) == jdata.bucket_for(s, plan)
    with pytest.raises(ValueError):
        tdata.bucket_for(plan[-1] + 1, plan)


def test_collate_task_batch_bit_exact():
    rng = np.random.default_rng(1)
    raw = []
    for n, m in ((5, 3), (9, 4), (7, 1)):
        raw.append((rng.standard_normal((n, 4, 4, 3)).astype(np.float32),
                    rng.integers(0, 5, n).astype(np.int32),
                    rng.standard_normal((m, 4, 4, 3)).astype(np.float32),
                    rng.integers(0, 5, m).astype(np.int32)))
    jb = jdata.collate_task_batch([JTask(*r, way=5) for r in raw],
                                  support_size=16, query_size=8)
    tb = tdata.collate_task_batch([TTask(*r, way=5) for r in raw],
                                  support_size=16, query_size=8)
    for name in ("support_x", "support_y", "support_mask", "query_x",
                 "query_y", "query_mask"):
        np.testing.assert_array_equal(getattr(tb, name),
                                      np.asarray(getattr(jb, name)), name)
    tt = tb.to("cpu")
    assert tt.support_x.dtype == torch.float32 and tt.support_y.dtype == torch.int64
    np.testing.assert_array_equal(tt.support_y.numpy(), np.asarray(jb.support_y))


def test_iter_query_chunks_bit_exact():
    q = np.random.default_rng(2).standard_normal((19, 2, 2, 3)).astype(np.float32)
    got = list(tdata.iter_query_chunks(q, 8))
    want = list(jdata.iter_query_chunks(q, 8))
    assert len(got) == len(want) == 3
    for (a, am, an), (b, bm, bn) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(am, bm)
        assert an == bn


@pytest.mark.parametrize("augment,image_size", [(True, 12), (False, 9)])
def test_host_task_batch_at_bit_exact(augment, image_size):
    jcfg = jdata.HostEpisodicConfig(way=5, shot=3, query_per_class=2,
                                    image_size=image_size, augment=augment)
    tcfg = tdata.HostEpisodicConfig(way=5, shot=3, query_per_class=2,
                                    image_size=image_size, augment=augment)
    jb = jdata.host_task_batch_at(7, jcfg, 3, 11)
    tb = tdata.host_task_batch_at(7, tcfg, 3, 11)
    for name in ("support_x", "support_y", "support_mask", "query_x",
                 "query_y", "query_mask"):
        a, b = getattr(tb, name), np.asarray(getattr(jb, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
