"""fluid.layers namespace (counterpart of ``paddle_tpu/fluid/layers``)."""

from . import (control_flow, detection, device, io,
               layer_function_generator, metric_op, nn, ops, sequence,
               tensor)
from . import learning_rate_scheduler, math_op_patch
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .device import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .layer_function_generator import (  # noqa: F401
    autodoc, deprecated, generate_layer_fn, templatedoc)

math_op_patch.monkey_patch_variable()

__all__ = (control_flow.__all__ + detection.__all__ + device.__all__
           + io.__all__
           + metric_op.__all__ + nn.__all__ + ops.__all__ + tensor.__all__
           + learning_rate_scheduler.__all__ + sequence.__all__)
