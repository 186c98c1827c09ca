"""Datasets (counterpart of ``paddle_tpu/dataset``), numpy only: the
readers of upstream ``python/paddle/dataset`` (mnist, cifar, uci_housing,
imdb, imikolov, movielens, wmt14, wmt16, flowers, conll05, sentiment,
voc2012, mq2007).  With no network, each falls back to a deterministic
synthetic generator with the real shapes, dtypes and cardinalities when
no cached copy is present; nothing is downloaded."""

from . import (cifar, common, conll05, flowers, imdb, imikolov, mnist,
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "movielens",
           "wmt14", "wmt16", "flowers", "conll05", "sentiment", "voc2012",
           "mq2007", "common"]
