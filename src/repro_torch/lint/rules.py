"""The port's rule set: the counterparts of the JAX package's
``seeded-rng``, ``clock-discipline`` and ``atomic-publish``
(``repro/lint/rules.py``), scoped to ``src/repro_torch/...``.

Each rule holds an invariant that the reference already paid for once and
that the port took over: draws only from explicit generators, time only
through an injectable clock, durable state published only whole.  Each
stays silent outside the layers where its invariant carries weight, and
the JAX package's rules, which match ``src/repro/...`` only, do not reach
the port.  The rules import neither torch nor the port.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.lint.engine import Finding, LintContext, Rule

PORT = "src/repro_torch"


def _dotted(node: ast.AST) -> str:
    """'torch.nn.init.normal_' for a chain of names and attributes, '' for
    anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _under(rel: str, *prefixes: str) -> bool:
    return any(rel == p or rel.startswith(p.rstrip("/") + "/") for p in prefixes)


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


class ClockDisciplineRule(Rule):
    name = "clock-discipline"
    invariant = ("the port's serve/train/faults/launch code reads time only "
                 "through an injectable clock parameter (default "
                 "time.monotonic); wall-clock CALLS are confined to defaults "
                 "and shims")
    recurrence = ("inline time.time() made SLO accounting untestable and "
                  "non-monotonic under clock steps; the reference moved every "
                  "component onto injected clocks and the port copied them — "
                  "a bare call brings the untestable path back")

    _FNS = {"time", "monotonic", "sleep", "perf_counter"}

    def applies(self, rel: str) -> bool:
        return _under(rel, *(f"{PORT}/{d}" for d in ("serve", "train", "faults", "launch")))

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        # names bound by `from time import sleep [as z]`
        local = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in self._FNS:
                        local[a.asname or a.name] = a.name
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = None
            if isinstance(fn, ast.Attribute) and fn.attr in self._FNS and \
                    _dotted(fn.value) == "time":
                hit = f"time.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in local:
                hit = f"time.{local[fn.id]}"
            if hit:
                yield ctx.finding(
                    node, self.name,
                    f"bare {hit}() call — take an injectable "
                    f"`clock: Callable[[], float] = time.monotonic` parameter "
                    f"(referencing time.monotonic as a default is fine; "
                    f"calling it inline is not) so tests can drive a fake clock")


class AtomicPublishRule(Rule):
    name = "atomic-publish"
    invariant = ("durable state under the port's serve/ and its checkpointer "
                 "is written to a tmp path and published with os.replace — "
                 "never written in place")
    recurrence = ("a crash between open('wb') and close left a torn "
                  "checkpoint / warm-tier entry that a restart then trusted; "
                  "the fault suite (ckpt.pre_*, warm.corrupt) exists because "
                  "of it, in both packages")

    def applies(self, rel: str) -> bool:
        return _under(rel, f"{PORT}/serve") or rel == f"{PORT}/train/checkpoint.py"

    def _in_place(self, ctx: LintContext, node: ast.Call, path: ast.AST, what: str):
        path_src = ctx.segment(path)
        if "tmp" not in path_src.lower():
            return ctx.finding(node, self.name,
                               f"{what} writes a durable path in place — write to a "
                               f"tmp sibling and publish with os.replace")
        return None

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = None
            if isinstance(fn, ast.Name) and fn.id == "open" and node.args:
                mode = node.args[1] if len(node.args) > 1 else None
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = kw.value
                if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
                    continue  # dynamic mode: out of static reach
                if not set(mode.value) & set("wax"):
                    continue  # read and update modes create no torn file
                hit = self._in_place(ctx, node, node.args[0],
                                     f"open({ctx.segment(node.args[0])!r}, "
                                     f"{mode.value!r})")
            elif isinstance(fn, ast.Attribute) and fn.attr in ("write_text", "write_bytes"):
                hit = self._in_place(ctx, node, fn.value,
                                     f"{ctx.segment(fn.value)}.{fn.attr}(...)")
            elif _dotted(fn) == "torch.save":
                path = node.args[1] if len(node.args) > 1 else next(
                    (kw.value for kw in node.keywords if kw.arg == "f"), None)
                if path is not None:
                    hit = self._in_place(ctx, node, path,
                                         f"torch.save(..., {ctx.segment(path)})")
            if hit:
                yield hit


class SeededRngRule(Rule):
    name = "seeded-rng"
    invariant = ("the port's library code draws randomness only from "
                 "explicit generators: seeded np.random.default_rng streams "
                 "and torch draws given generator=; nothing seeds or reads "
                 "torch's global generators")
    recurrence = ("legacy np.random.* globals made fault soaks and episodic "
                  "samplers irreproducible across processes in the reference; "
                  "torch's global generator is the same trap (a draw without "
                  "generator= depends on every draw before it in the process, "
                  "and torch.manual_seed resets it for every caller)")

    _NP_CONSTRUCTORS = {"default_rng", "Generator", "PCG64", "PCG64DXSM", "Philox",
                        "SFC64", "MT19937", "SeedSequence", "BitGenerator"}
    _TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                    "multinomial", "poisson", "rand_like", "randn_like", "randint_like"}
    _IN_PLACE = {"normal_", "uniform_", "bernoulli_", "exponential_", "random_",
                 "geometric_", "cauchy_", "log_normal_"}
    _NN_INIT = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_", "xavier_normal_",
                "kaiming_uniform_", "kaiming_normal_", "orthogonal_", "sparse_"}
    _GLOBAL_SEEDING = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                       "torch.random.seed", "torch.cuda.manual_seed",
                       "torch.cuda.manual_seed_all"}

    def applies(self, rel: str) -> bool:
        return _under(rel, PORT)

    def _numpy(self, ctx: LintContext, node: ast.Call):
        fn = node.func
        if fn.attr not in self._NP_CONSTRUCTORS:
            return ctx.finding(node, self.name,
                               f"legacy global-state np.random.{fn.attr}(...) — thread an "
                               f"explicit np.random.default_rng(seed) Generator instead")
        if fn.attr == "default_rng" and not node.args and not node.keywords:
            return ctx.finding(node, self.name,
                               "np.random.default_rng() with no seed is entropy-seeded — "
                               "pass an explicit seed so runs replay bit-exactly")
        return None

    def _torch(self, ctx: LintContext, node: ast.Call, dotted: str):
        fn = node.func
        if dotted in self._GLOBAL_SEEDING:
            return ctx.finding(node, self.name,
                               f"{dotted}(...) seeds torch's global generator for every "
                               f"caller in the process — draw on an explicit "
                               f"torch.Generator(...).manual_seed(seed)")
        if _has_kw(node, "generator"):
            return None
        head, _, attr = dotted.rpartition(".")
        if head in ("torch.nn.init", "nn.init", "init") and attr in self._NN_INIT:
            what = f"{dotted}(...)"
        elif head == "torch" and attr in self._TORCH_DRAWS:
            what = f"{dotted}(...)"
        elif fn.attr in self._IN_PLACE:
            what = f"Tensor.{fn.attr}(...)"
        else:
            return None
        return ctx.finding(node, self.name,
                           f"{what} without generator= draws on torch's global "
                           f"generator — pass an explicit seeded torch.Generator")

    def check(self, ctx: LintContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            if _dotted(node.func.value) in ("np.random", "numpy.random"):
                hit = self._numpy(ctx, node)
            else:
                hit = self._torch(ctx, node, _dotted(node.func))
            if hit:
                yield hit


ALL_RULES = (
    ClockDisciplineRule(),
    AtomicPublishRule(),
    SeededRngRule(),
)

RULES_BY_NAME = {r.name: r for r in ALL_RULES}
