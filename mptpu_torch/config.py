"""The impulse-response directory from the environment or a ``.env`` file
(counterpart of the ``IMPULSE_RESPONSE_PATH`` part of
``mptpu/config/dotenv.py``).

``mptpu`` copies ``.env`` into ``os.environ`` once per process, keeping
variables already set; here the file is read at each call and nothing is
written, which gives the same value.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def parse_dotenv(path: str = ".env") -> Dict[str, str]:
    """``KEY=value`` lines of ``path`` (blank lines, ``#`` comments and lines
    without ``=`` skipped); empty when the file does not exist."""
    if not os.path.exists(path):
        return {}
    found = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            found.setdefault(key.strip(), value.strip())
    return found


def impulse_response_path() -> Optional[str]:
    """``IMPULSE_RESPONSE_PATH`` from the environment, else from ``.env`` in
    the working directory, else None."""
    name = "IMPULSE_RESPONSE_PATH"
    return os.environ.get(name, parse_dotenv().get(name))
