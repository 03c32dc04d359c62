"""CLI: ``python -m repro_torch.lint [paths] [--json] [--rules R] [--list-rules]``,
the AST scan of the port (default: ``src/repro_torch/`` and
``tests/test_torch_*.py``); exits 1 if any finding remains.

``--contracts [--cells C] [--no-ast] [--device cpu|cuda]``
also runs the contract cells on the port's running program
(:mod:`repro_torch.lint.contracts`; the cells that need ranks start 4 gloo
ranks of this host).  They run on the card unless ``--device cpu`` is
given."""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.lint import engine, rules


def _list_rules() -> None:
    for r in rules.ALL_RULES:
        print(f"{r.name}")
        print(f"    invariant:  {r.invariant}")
        print(f"    recurrence: {r.recurrence}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="the port's static analysis: AST rules over src/repro_torch and "
                    "tests/test_torch_*.py (see repro_torch.lint.__doc__ for the catalog)")
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files or directories to scan (default: the port and its tests)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the findings as JSON")
    ap.add_argument("--rules", action="append", default=[], metavar="RULE",
                    help="run only these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the contract cells on the running program")
    ap.add_argument("--cells", action="append", default=[], metavar="CELL",
                    help="restrict --contracts to these cells")
    ap.add_argument("--no-ast", action="store_true", help="skip the AST scan")
    ap.add_argument("--device", default="cuda", help="the contract cells' device")
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0
    active = list(rules.ALL_RULES)
    if args.rules:
        unknown = set(args.rules) - set(rules.RULES_BY_NAME)
        if unknown:
            ap.error(f"unknown rule(s): {sorted(unknown)} — see --list-rules")
        active = [rules.RULES_BY_NAME[r] for r in args.rules]
    findings = []
    if not args.no_ast:
        root = engine.repo_root()
        findings = engine.lint_paths(args.paths or engine.default_targets(root), root, active)
    if args.contracts:
        from repro_torch.lint import contracts
        findings += contracts.run_cells(args.cells or None, args.device)
    if args.as_json:
        print(engine.findings_json(findings))
    else:
        for f in findings:
            print(f.format())
        if findings:
            print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
