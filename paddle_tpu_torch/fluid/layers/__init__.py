"""fluid.layers namespace (counterpart of ``paddle_tpu/fluid/layers``)."""

from . import control_flow, io, nn, ops, tensor
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = control_flow.__all__ + io.__all__ + nn.__all__ + ops.__all__ + tensor.__all__
