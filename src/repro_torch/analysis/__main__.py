"""CLI for the port's static-analysis pass.

Usage::

    python -m repro_torch.analysis [paths...] [--format=text|json|github]
                                   [--baseline FILE] [--no-baseline]
                                   [--write-baseline] [--out FILE]
                                   [--root DIR] [--list-rules]

Paths (files, directories or globs relative to the root) default to the
port's own files: ``src/repro_torch``, ``tests/test_torch_*.py``,
``examples/torch_*.py`` and ``chip_smoke.py``.  The root is the directory
holding ``ROADMAP.md`` or the port's baseline, found by walking up from
the working directory.  The baseline is the port's own file,
``src/repro_torch/analysis/baseline.json``; ``analysis_baseline.json`` is
the JAX package's, read and written only by ``python -m repro.analysis``.
Exit codes: 0 clean, 1 findings, 2 usage/config error.
``--format=github`` emits one ``::error`` workflow command per finding.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.engine import (all_rules, analyze_paths,
                                         apply_baseline, format_findings,
                                         is_glob, load_baseline,
                                         write_baseline)

DEFAULT_TARGETS = ["src/repro_torch", "tests/test_torch_*.py",
                   "examples/torch_*.py", "chip_smoke.py"]
BASELINE_NAME = "src/repro_torch/analysis/baseline.json"


def _find_root(start: Path) -> Path:
    for p in (start, *start.parents):
        if (p / "ROADMAP.md").exists() or (p / BASELINE_NAME).exists():
            return p
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis for the PyTorch port's invariants "
                    "(RPR001-RPR006).")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files, directories or globs to analyze "
                         f"(default: {' '.join(DEFAULT_TARGETS)})")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the report to this file (as JSON)")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root override (default: auto-detect)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    root = (args.root or _find_root(Path.cwd())).resolve()

    if args.list_rules:
        for r in all_rules():
            doc = (r.__class__.__doc__ or
                   type(r).__module__).strip().splitlines()[0]
            print(f"{r.id}  {r.title}  [{r.design_ref}]")
            print(f"       {doc}")
        return 0

    if args.paths:
        targets = args.paths
        missing = [t for t in targets if not (
            any(root.glob(t)) if is_glob(t)
            else (root / t).exists() or Path(t).exists())]
        if missing:
            print(f"error: no such path(s): {', '.join(missing)} "
                  f"(root={root})", file=sys.stderr)
            return 2
    else:
        # a default target the root lacks (no examples, say) is skipped;
        # a root with none of them is not the port's
        targets = DEFAULT_TARGETS
        if not any((root / t).exists() or (is_glob(t) and any(root.glob(t)))
                   for t in targets):
            print(f"error: none of the default targets under {root}; "
                  f"pass --root or paths", file=sys.stderr)
            return 2

    findings, suppressed = analyze_paths(root, targets)

    baseline_path = args.baseline or (root / BASELINE_NAME)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baselined = 0
    if not args.no_baseline:
        findings, baselined = apply_baseline(
            findings, load_baseline(baseline_path))

    report = format_findings(findings, args.format,
                             suppressed=suppressed, baselined=baselined)
    if args.out is not None:
        # the artifact is always JSON, whatever the console format
        args.out.write_text(format_findings(
            findings, "json", suppressed=suppressed,
            baselined=baselined) + "\n")
    if report:
        print(report)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
