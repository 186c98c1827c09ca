"""Dataset cache helpers (counterpart of ``paddle_tpu/dataset/common.py``)."""

from __future__ import annotations

import os

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def cached_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)
    return path
