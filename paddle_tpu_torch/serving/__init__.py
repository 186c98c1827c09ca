"""Serving on the card (counterpart of ``paddle_tpu/serving``): the
continuous-batching decode engine, its paged KV pool, its metrics and
speculative decoding."""

from .decode import DecodeConfig, DecodeEngine, create_decode_engine
from .engine import (DrainTimeout, EngineClosed, EngineOverloaded,
                     RequestTimeout)
from .kvpool import PageGrant, PagePool
from .metrics import ServingMetrics
from .specdec import DraftSource, SpecController, SpecDecoder

__all__ = ["DecodeConfig", "DecodeEngine", "create_decode_engine",
           "DrainTimeout", "EngineClosed", "EngineOverloaded",
           "RequestTimeout", "PagePool", "PageGrant", "ServingMetrics",
           "SpecDecoder", "DraftSource", "SpecController"]
