"""Strict-JSON metric dumping (counterpart of ``mptpu/utils/jsonio.py``,
kept here as a copy). ``json.dump`` writes ``Infinity`` and ``NaN`` by
default, which RFC 8259 forbids; run metrics can hold them (a best SNR
still at ``-inf``), so they are written as ``null``."""

from __future__ import annotations

import json
import math
from typing import IO, Any


def sanitize(obj: Any) -> Any:
    """``obj`` with every non-finite float replaced by None, recursively."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def dump_json(obj: Any, fp: IO[str], **kwargs: Any) -> None:
    """``json.dump`` that always writes RFC 8259-valid output."""
    json.dump(sanitize(obj), fp, allow_nan=False, **kwargs)
