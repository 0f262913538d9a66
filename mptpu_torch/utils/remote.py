"""Remote storage of trained weights, keyed by the experiment's date
(counterpart of ``mptpu/utils/remote.py``): a checkpoint goes to
``<remote root>/<date>_weights.dat`` and comes back from there.

The remote is a directory: ``MPTPU_REMOTE_WEIGHTS``, else
``remote_weights`` under the cache directory (``config.cache_path``).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from ..config.dotenv import Config


def _remote_root() -> str:
    root = os.environ.get("MPTPU_REMOTE_WEIGHTS",
                          os.path.join(Config.cache_path(), "remote_weights"))
    os.makedirs(root, exist_ok=True)
    return root


def weights_key(experiment_date: str) -> str:
    """The remote name of an experiment's weights."""
    return f"{experiment_date}_weights.dat"


def store_trained_weights_remotely(experiment_date: str, local_path: str) -> str:
    """Copy the checkpoint at ``local_path`` to the remote under the
    experiment's key; returns the remote path."""
    dest = os.path.join(_remote_root(), weights_key(experiment_date))
    shutil.copyfile(local_path, dest)
    return dest


def load_trained_weights_for_inference(experiment_date: str,
                                       local_path: Optional[str] = None) -> Optional[str]:
    """Copy the experiment's weights from the remote to ``local_path``
    (``trained_weights/<key>`` under the working directory when None) and
    return that path; None when the remote has no such key."""
    src = os.path.join(_remote_root(), weights_key(experiment_date))
    if not os.path.exists(src):
        return None
    local_path = local_path or os.path.join("trained_weights", weights_key(experiment_date))
    os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
    shutil.copyfile(src, local_path)
    return local_path
