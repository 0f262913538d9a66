"""Paths from the environment or a ``.env`` file (counterpart of
``Config.audio_path``, ``Config.impulse_response_path`` and
``Config.s3_bucket``, ``Config.port`` and ``Config.cache_path`` in
``mptpu/config/dotenv.py``, as module functions over the same variables:
``AUDIO_PATH``, ``IMPULSE_RESPONSE_PATH``, ``S3_BUCKET``, ``PORT``,
``MPTPU_CACHE``; :class:`Config` holds them as static methods, so that
``mptpu``'s call sites read the same).

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


def _setting(name: str) -> Optional[str]:
    """``name`` from the environment, else from ``.env`` in the working
    directory, else None."""
    return os.environ.get(name, parse_dotenv().get(name))


def audio_path() -> Optional[str]:
    """The audio corpus directory, ``AUDIO_PATH``, or None."""
    return _setting("AUDIO_PATH")


def impulse_response_path() -> Optional[str]:
    """The impulse-response directory, ``IMPULSE_RESPONSE_PATH``, or None."""
    return _setting("IMPULSE_RESPONSE_PATH")


def s3_bucket() -> Optional[str]:
    """The bucket of the remote weight store, ``S3_BUCKET``, or None."""
    return _setting("S3_BUCKET")


def port(default: int = 9999) -> int:
    """The dashboard's port, ``PORT``, else ``default``."""
    value = _setting("PORT")
    return int(default if value is None else value)


def cache_path() -> str:
    """The directory of the KV stores and the demo corpus, ``MPTPU_CACHE``,
    else ``~/.mptpu_cache``; created when missing."""
    path = _setting("MPTPU_CACHE") or os.path.join(os.path.expanduser("~"), ".mptpu_cache")
    os.makedirs(path, exist_ok=True)
    return path


class Config:
    """The settings as ``mptpu``'s ``Config`` exposes them."""

    audio_path = staticmethod(audio_path)
    impulse_response_path = staticmethod(impulse_response_path)
    s3_bucket = staticmethod(s3_bucket)
    port = staticmethod(port)
    cache_path = staticmethod(cache_path)
