"""Rule pack for :mod:`repro_torch.analysis`.

Importing this package registers every rule with the engine registry
(each module's ``@register`` decorator runs at import time); the engine's
``all_rules()`` imports it for exactly that side effect.
"""
from __future__ import annotations

from repro_torch.analysis.rules import commspec  # noqa: F401
from repro_torch.analysis.rules import donation  # noqa: F401
from repro_torch.analysis.rules import host_sync  # noqa: F401
from repro_torch.analysis.rules import pallas_contracts  # noqa: F401
from repro_torch.analysis.rules import randomness  # noqa: F401
from repro_torch.analysis.rules import recompile  # noqa: F401
