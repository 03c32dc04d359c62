"""The port's linter (``repro_torch.lint``): each rule on fixtures at a
port path, at the JAX package's path and outside its scope; the pragma
contract; the self-scan of the port; the CLI.

Fixture sources stay inside strings, so that neither package's self-scan
reads them as calls, and a pragma without a reason is assembled at run
time (pragmas are matched line by line on the raw source, strings
included).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.lint import engine, rules

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")


def hits(src: str, rel: str, rule: str):
    found = engine.lint_source(textwrap.dedent(src), rel, rules.ALL_RULES)
    return [f for f in found if f.rule == rule]


# -- seeded-rng -------------------------------------------------------------------

DRAWS = [
    "torch.rand(3)", "torch.randn(2, 3)", "torch.randint(0, 5, (4,))", "torch.randperm(8)",
    "torch.normal(mean, std)", "torch.bernoulli(p)", "torch.multinomial(p, 2)",
    "torch.poisson(rates)", "torch.rand_like(x)", "torch.randn_like(x)",
    "torch.randint_like(x, 5)", "x.normal_()", "x.uniform_(-1, 1)", "x.bernoulli_(0.5)",
    "x.exponential_()", "x.random_(0, 9)", "x.geometric_(0.3)", "x.cauchy_()",
    "x.log_normal_()", "torch.empty(3).normal_(0, 1)", "torch.nn.init.normal_(w)",
    "nn.init.kaiming_uniform_(w)", "init.xavier_normal_(w)", "nn.init.trunc_normal_(w)",
    "nn.init.orthogonal_(w)",
]


def _with_generator(call: str) -> str:
    return call[:-1] + ("generator=g)" if call.endswith("()") else ", generator=g)")


@pytest.mark.parametrize("call", DRAWS)
def test_seeded_rng_flags_a_torch_draw_without_generator(call):
    assert len(hits(f"y = {call}\n", "src/repro_torch/models/x.py", "seeded-rng")) == 1
    assert hits(f"y = {_with_generator(call)}\n", "src/repro_torch/models/x.py",
                "seeded-rng") == []


@pytest.mark.parametrize("call", DRAWS[:3] + ["x.normal_()"])
def test_seeded_rng_stays_silent_outside_the_port(call):
    for rel in ("src/repro/models/x.py", "tests/test_torch_x.py", "chip_smoke.py"):
        assert hits(f"y = {call}\n", rel, "seeded-rng") == []


@pytest.mark.parametrize("call", ["torch.manual_seed(0)", "torch.seed()",
                                  "torch.random.manual_seed(0)",
                                  "torch.cuda.manual_seed(0)",
                                  "torch.cuda.manual_seed_all(0)"])
def test_seeded_rng_flags_global_seeding(call):
    found = hits(f"{call}\n", "src/repro_torch/train/x.py", "seeded-rng")
    assert len(found) == 1 and "global generator" in found[0].message


def test_seeded_rng_allows_explicit_generators():
    src = """
        g = torch.Generator(device=dev).manual_seed(0)
        gen.manual_seed(1)
        x = torch.randn(3, generator=g)
        y = torch.empty(4).uniform_(generator=g)
        rng = np.random.default_rng(0)
        z = torch.zeros(3).normal_mean
        nn.init.zeros_(w)
        nn.init.constant_(w, 0.5)
    """
    assert hits(src, "src/repro_torch/models/x.py", "seeded-rng") == []


@pytest.mark.parametrize("call,flagged", [("np.random.rand(3)", True),
                                          ("numpy.random.seed(0)", True),
                                          ("np.random.default_rng()", True),
                                          ("np.random.default_rng(0)", False),
                                          ("np.random.Generator(np.random.PCG64(1))", False)])
def test_seeded_rng_numpy_half(call, flagged):
    assert bool(hits(f"y = {call}\n", "src/repro_torch/data/x.py", "seeded-rng")) == flagged


# -- clock-discipline ----------------------------------------------------------------

CLOCK_CALLS = ["time.time()", "time.monotonic()", "time.sleep(0.1)", "time.perf_counter()"]


@pytest.mark.parametrize("call", CLOCK_CALLS)
@pytest.mark.parametrize("layer", ["serve", "train", "faults", "launch"])
def test_clock_discipline_flags_bare_calls_in_its_layers(call, layer):
    src = f"import time\ndef step(self):\n    t = {call}\n"
    assert len(hits(src, f"src/repro_torch/{layer}/x.py", "clock-discipline")) == 1


@pytest.mark.parametrize("rel", ["src/repro_torch/models/x.py", "src/repro_torch/kernels/x.py",
                                 "src/repro/serve/x.py", "tests/test_torch_x.py"])
def test_clock_discipline_stays_silent_outside_its_scope(rel):
    src = "import time\ndef step(self):\n    time.sleep(0.1)\n"
    assert hits(src, rel, "clock-discipline") == []


def test_clock_discipline_reads_from_imports_and_allows_defaults():
    src = """
        from time import sleep as nap, monotonic
        def step(self, clock=monotonic):
            nap(0.5)
            return clock()
    """
    found = hits(src, "src/repro_torch/serve/x.py", "clock-discipline")
    assert [f.line for f in found] == [4]


# -- atomic-publish ---------------------------------------------------------------------

@pytest.mark.parametrize("write,flagged", [
    ('open(path, "wb")', True), ('open(tmp, "wb")', False), ('open(path, "rb")', False),
    ('open(path, "r+b")', False), ('open(path, mode="w")', True),
    ("final.write_text('ok')", True), ("(tmp / 'COMMIT').write_text('ok')", False),
    ("path.write_bytes(b)", True),
    ("torch.save(state, path)", True), ("torch.save(state, tmp_path)", False),
    ("torch.save(state, f=final)", True), ("torch.save(state, f=home / '.tmp_x')", False),
])
def test_atomic_publish_in_the_checkpointer(write, flagged):
    src = f"def save(path, tmp, tmp_path, final, home, state, b):\n    {write}\n"
    for rel in ("src/repro_torch/train/checkpoint.py", "src/repro_torch/serve/episodic.py"):
        assert bool(hits(src, rel, "atomic-publish")) == flagged, rel


@pytest.mark.parametrize("rel", ["src/repro_torch/train/loop.py", "src/repro/serve/x.py",
                                 "src/repro/train/checkpoint.py", "tests/test_torch_x.py"])
def test_atomic_publish_stays_silent_outside_its_scope(rel):
    src = 'def save(path, state):\n    open(path, "wb")\n    torch.save(state, path)\n'
    assert hits(src, rel, "atomic-publish") == []


# -- pragmas -----------------------------------------------------------------------------

def test_a_reasoned_pragma_suppresses_its_rule_only():
    src = """
        import time
        def step(self):
            time.sleep(1)  # lint: allow(clock-discipline): fixture
            # lint: allow(clock-discipline): a comment line covers the next line
            time.sleep(2)
            time.sleep(3)  # lint: allow(seeded-rng): wrong rule named
    """
    found = hits(src, "src/repro_torch/serve/x.py", "clock-discipline")
    assert [f.line for f in found] == [7]


def test_pragma_without_reason_is_a_finding():
    src = "import time\ndef step(self):\n    time.sleep(1)  {} allow(clock-discipline)\n"
    found = engine.lint_source(src.format("# lint:"), "src/repro_torch/serve/x.py",
                               rules.ALL_RULES)
    assert any(f.rule == engine.BAD_PRAGMA_RULE for f in found)
    assert any(f.rule == "clock-discipline" for f in found)   # and it does not suppress


def test_a_file_that_does_not_parse_is_a_finding():
    found = engine.lint_source("def (:\n", "src/repro_torch/x.py", rules.ALL_RULES)
    assert [f.rule for f in found] == ["syntax-error"]


# -- the self-scan and the CLI ----------------------------------------------------------

def test_port_self_scan_is_clean():
    root = engine.repo_root()
    targets = engine.default_targets(root)
    assert root / "src" / "repro_torch" in targets
    assert any(t.name.startswith("test_torch_") for t in targets)
    assert not any(t.name == "test_lint.py" for t in targets)
    findings = engine.lint_paths(targets, root, rules.ALL_RULES)
    assert findings == [], "\n".join(f.format() for f in findings)


def _cli(args):
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=SRC), timeout=120)


def test_cli_json_exits_0_on_the_port():
    out = _cli(["--json"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout) == []


def test_cli_exits_nonzero_on_a_planted_file(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "serve" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\ndef step(self):\n    time.sleep(1)\n")
    out = _cli(["--json", str(bad)])
    assert out.returncode == 1
    assert [(f["path"], f["line"], f["rule"]) for f in json.loads(out.stdout)] == \
        [("src/repro_torch/serve/bad.py", 3, "clock-discipline")]
    assert _cli(["--rules", "seeded-rng", str(bad)]).returncode == 0


def test_cli_lists_the_rules():
    out = _cli(["--list-rules"])
    assert out.returncode == 0
    assert [line for line in out.stdout.splitlines() if not line.startswith(" ")] == \
        ["clock-discipline", "atomic-publish", "seeded-rng"]
