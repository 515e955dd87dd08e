"""Shared filesystem locations (counterpart of `maskbit_tpu/utils/paths.py`)."""

import os


def user_cache_dir(*subdirs: str) -> str:
    """Per-user cache root (``$XDG_CACHE_HOME`` or ``~/.cache``) under a
    ``maskbit_tpu_torch`` namespace, with optional sub-path components
    appended. Used for artifacts keyed to the machine, not the run: the
    native decode library when the checkout cannot be written."""
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(root, "maskbit_tpu_torch", *subdirs)
