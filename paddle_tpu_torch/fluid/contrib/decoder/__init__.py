"""Decoder DSL (counterpart of ``paddle_tpu/fluid/contrib/decoder``)."""

from . import beam_search_decoder
from .beam_search_decoder import (BeamSearchDecoder, InitState,
                                  JitBeamSearchDecoder, StateCell,
                                  TrainingDecoder)

__all__ = ["beam_search_decoder", "InitState", "StateCell",
           "TrainingDecoder", "BeamSearchDecoder", "JitBeamSearchDecoder"]
