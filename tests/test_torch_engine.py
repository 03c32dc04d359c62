"""The port's episodic serving engine and launcher against the JAX engine.

The same requests (a cold wave of distinct users, then a warm wave of
repeats) through both engines, on identical weights, give the same
predictions and the same counters.  The JAX engine runs its ``ref``
backend and the port its ``ref`` backend on the CPU (both Cholesky solves);
logits are held to the tolerances of tests/test_torch_learners.py."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.episodic import EpisodicRequest as JRequest
from repro.serve.episodic import EpisodicServeEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.launch import serve as t_launch
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

WIDTHS, FDIM, IMG = (8, 16), 48, 12
TOLS = {"protonets": 1e-5, "simple_cnaps": 4e-3}
REPO = pathlib.Path(__file__).resolve().parents[1]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _requests(cls, cold, warm):
    return [cls(uid=r.uid, support_x=r.support_x, support_y=r.support_y,
                query_x=r.query_x, way=5) for r in cold], \
        [cls(uid=r.uid, support_x=r.support_x, support_y=r.support_y,
             query_x=r.query_x, way=5) for r in warm]


@pytest.mark.parametrize("kind,quant", [("protonets", "none"),
                                        ("simple_cnaps", "int8")])
def test_engine_matches_jax_engine(kind, quant):
    jl = j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(conv_blocks=2, conv_width=8, task_dim=16))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))
    jp = jl.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cold, warm = t_launch.build_requests(7, 0.43, 3, 4, IMG, seed=5)
    kw = dict(n_slots=3, query_chunk=8, support_buckets=(16,), serve_quant=quant)
    je = JEngine(jl, jp, lite=JLite(exact=True, chunk_size=8),
                 kernel_backend="ref", clock=_Clock(), **kw)
    te = EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8),
                             kernel_backend="ref", clock=_Clock(), device="cpu",
                             **kw)
    assert te.kernel_backend == "ref"
    jc, jw = _requests(JRequest, cold, warm)
    tc, tw = _requests(EpisodicRequest, cold, warm)
    for reqs_j, reqs_t in ((jc, tc), (jw, tw)):
        je.run_to_completion(reqs_j)
        te.run_to_completion(reqs_t)
    tol = TOLS[kind]
    for rj, rt in zip(jc + jw, tc + tw):
        assert rt.done and rt.cache_hit == rj.cache_hit
        lj, lt = rj.all_logits(), rt.all_logits()
        assert lt.shape == lj.shape == (rj.n_queries, 5)
        assert np.abs(lt - lj).max() <= tol * np.abs(lj).max()
        np.testing.assert_array_equal(rt.predictions(), rj.predictions())
    sj, st = je.stats(), te.stats()
    for k in ("tasks_adapted", "queries_served", "cache_hits", "cache_misses",
              "hit_rate", "steps", "param_bytes_resident",
              "frozen_param_bytes_resident"):
        assert st[k] == sj[k], k
    assert st["tasks_adapted"] == 4 and st["hit_rate"] > 0


def test_launcher_runs_on_cpu(capsys):
    s = t_launch.main(["--episodic", "--device", "cpu", "--learner",
                       "simple_cnaps", "--serve-quant", "int8", "--requests",
                       "4", "--image-size", "12", "--shot", "2",
                       "--kernel-backend", "cuda"])
    out = capsys.readouterr().out
    assert "episodic serve: learner=simple_cnaps 4 requests" in out
    assert s["tasks_adapted"] == 2 and s["queries_served"] == 4 * 20
    assert s["frozen_param_bytes_resident"] * 3 < s["frozen_param_bytes_fp32"]


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the default construction is valid")
    tl = make_learner(MetaLearnerConfig(kind="protonets", way=5),
                      make_conv_backbone(ConvBackboneConfig(widths=(4,), feature_dim=8)))
    tp = tl.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        EpisodicServeEngine(tl, tp)
    with pytest.raises(RuntimeError, match="cuda"):
        t_launch.main(["--episodic"])


def test_kernel_wrappers_refuse_what_they_do_not_take():
    from repro_torch.kernels import dispatch, segment_pool
    from repro_torch.kernels._checks import check_tensor
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        check_tensor("x", x, 3, (torch.float32,), x.device)
    # a CPU tensor takes the plain version, whatever the backend
    w = torch.zeros(2, 3, 5)
    assert segment_pool.segment_pool_weighted(x, w).shape == (2, 5, 4)
    assert dispatch.resolve_backend("auto", torch.device("cpu")) == "ref"
    assert dispatch.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("pallas")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
