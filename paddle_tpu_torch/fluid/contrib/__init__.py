"""contrib utilities (counterpart of ``paddle_tpu/fluid/contrib``): the
decoder DSL.  ``memory_usage_calc`` is not ported."""

from . import decoder

__all__ = ["decoder"]
