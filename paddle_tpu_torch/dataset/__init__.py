"""Datasets (counterpart of ``paddle_tpu/dataset``): the readers the port's
paths use, numpy only.  With no network, each is a deterministic synthetic
generator with the real shapes, dtypes and cardinalities."""

from . import common, conll05

__all__ = ["conll05", "common"]
