"""Serving on the card (counterpart of ``paddle_tpu/serving``): the
continuous-batching decode engine and its paged KV pool."""

from .decode import DecodeConfig, DecodeEngine, create_decode_engine
from .engine import (DrainTimeout, EngineClosed, EngineOverloaded,
                     RequestTimeout)

__all__ = ["DecodeConfig", "DecodeEngine", "create_decode_engine",
           "DrainTimeout", "EngineClosed", "EngineOverloaded",
           "RequestTimeout"]
