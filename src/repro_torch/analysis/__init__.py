"""repro_torch.analysis — the port's own static analysis.

``python -m repro_torch.analysis [paths...]`` walks the port's Python
sources and enforces the invariants that its CPU tests cannot see:
host-sync-free hot paths (RPR001), the CommSpec call form of
``communicate`` (RPR002), the aliasing contract of the overlap buffer and
of in-place kernel launches (RPR003), runtime data kept out of the
step-variant keys (RPR004), the counter hash as the only randomness of
the device modules (RPR005), and the ctypes launch contract of the CUDA
kernels (RPR006).  The rule ids, the engine's names and the
``# repro: allow(RPRnnn)`` markers are the reference's (``repro.analysis``);
the engine is the port's own copy and the rules check the port.

The modules import only the standard library; importing the package
loads ``torch`` all the same, through ``repro_torch/__init__.py``.
"""
from __future__ import annotations

from repro_torch.analysis.engine import (Baseline, FileContext, Finding,
                                         Rule, all_rules, analyze_file,
                                         analyze_paths, apply_baseline,
                                         format_findings, load_baseline)

__all__ = [
    "Baseline", "FileContext", "Finding", "Rule", "all_rules",
    "analyze_file", "analyze_paths", "apply_baseline", "format_findings",
    "load_baseline",
]
