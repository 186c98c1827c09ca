"""Speculative decoding for the DecodeEngine (counterpart of
``paddle_tpu/serving/specdec``).

With ``DecodeConfig(spec=k)`` (or ``PADDLE_SERVE_SPEC=k``), k > 0, the
engine's one-token tick becomes a draft + verify tick:

 - a :class:`~.draft.DraftSource`, a self-draft built from the target's
   first ``draft_layers`` decoder layers (weights copied by name), runs
   k + 1 one-token steps over its own dense KV cache;
 - ONE verify dispatch (``DecodeModel.spec_program(k)``) scores all k + 1
   positions per slot, and the device-side ``spec_accept`` op takes the
   longest draft == argmax prefix plus the correction token, so the
   committed tokens are bitwise those of sequential greedy decode;
 - rejected speculative positions roll back through the page pool's
   ``rewind``: pages grown for them return through its single release
   path.

A :class:`~.controller.SpecController` watches the rolling acceptance
rate and falls back to plain ticks below ``PADDLE_SERVE_SPEC_MIN_ACCEPT``,
re-arming after a cooldown.  Each of the draft's programs and the verify
is a CUDA graph of the engine's closed set on the card.
"""

from .controller import SpecController
from .decoder import SpecDecoder
from .draft import DraftSource

__all__ = ["SpecDecoder", "DraftSource", "SpecController"]
