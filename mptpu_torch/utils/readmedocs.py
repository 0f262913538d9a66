"""An experiment's docstring from its ``readme.md`` (counterpart of
``mptpu/utils/readmedocs.py``)."""

from __future__ import annotations

import os


def readme(path: str):
    """Class decorator: set ``__doc__`` from the ``readme.md`` in the
    directory of ``path`` (pass the experiment module's ``__file__``); with
    no such file ``__doc__`` stays as it is."""

    def decorator(cls):
        readme_path = os.path.join(os.path.dirname(os.path.abspath(path)), "readme.md")
        try:
            with open(readme_path) as f:
                cls.__doc__ = f.read()
        except OSError:
            pass
        return cls

    return decorator
