"""repro_torch.lint: the port's static analysis, an AST scan of
``src/repro_torch/`` and ``tests/test_torch_*.py``::

    PYTHONPATH=src python -m repro_torch.lint                 # the self-scan
    PYTHONPATH=src python -m repro_torch.lint --json          # findings as JSON
    PYTHONPATH=src python -m repro_torch.lint path/to/file.py # a scoped scan
    PYTHONPATH=src python -m repro_torch.lint --list-rules    # the catalog

The exit status is non-zero if and only if findings remain; each prints
as ``path:line: rule-id: message``.  The engine (:mod:`.engine`) is the
port's own copy of the JAX package's; the rules (:mod:`.rules`):

=====================  ==================================================
``seeded-rng``         draws only from explicit generators: seeded
                       ``np.random.default_rng``, torch draws with
                       ``generator=``; no legacy ``np.random.*``, no
                       torch draw on the global generator, no global
                       seeding (``torch.manual_seed`` and kin)
``clock-discipline``   serve/train/faults/launch take an injectable
                       ``clock``; bare ``time.time()`` /
                       ``time.monotonic()`` / ``time.sleep()`` CALLS are
                       findings
``atomic-publish``     durable writes under serve/ and the checkpointer
                       go tmp-then-``os.replace``; an in-place
                       ``open('wb')``, ``write_text`` or ``torch.save``
                       on a path that is not a tmp path is a finding
=====================  ==================================================

Suppression, inline and audited, the reason mandatory::

    do_thing()  # lint: allow(clock-discipline): the launcher's wall clock

A pragma on a comment line of its own (or a block of them) covers the next
code line.  ``allow(...)`` without a reason is itself a finding
(``lint-pragma``).

``--contracts`` also runs the contract cells on the port's running
program (:mod:`repro_torch.lint.contracts`, the counterpart of the JAX
package's compiled-HLO cells): ``replica_2x2`` and ``int8_ws`` on 4 gloo
ranks of this host, ``compile_flat`` and ``lite_outer`` in this process;
a cell's violation prints as ``contracts/<cell>:0: contract-<rule>: ...``::

    PYTHONPATH=src python -m repro_torch.lint --contracts --no-ast --device cpu
"""
from repro_torch.lint.engine import (Finding, LintContext, Rule, default_targets,
                                     findings_json, lint_file, lint_paths, lint_source,
                                     repo_root)
from repro_torch.lint.rules import ALL_RULES, RULES_BY_NAME

__all__ = [
    "Finding", "LintContext", "Rule", "ALL_RULES", "RULES_BY_NAME",
    "default_targets", "findings_json", "lint_file", "lint_paths",
    "lint_source", "repo_root",
]
