"""Device-placement layer (counterpart of
``paddle_tpu/fluid/layers/device.py``): ``get_places``, whose op gives the
indices of the place's devices (the list ``ParallelDo`` would take)."""

from ..layer_helper import LayerHelper

__all__ = ["get_places"]


def get_places(device_count=None, device_type=None):
    helper = LayerHelper("get_places")
    out = helper.create_variable_for_type_inference(dtype="int64")
    out.stop_gradient = True
    attrs = {}
    if device_count is not None:
        attrs["device_count"] = int(device_count)
    if device_type is not None:
        attrs["device_type"] = str(device_type)
    helper.append_op(type="get_places", outputs={"Out": [out]},
                     attrs=attrs)
    return out
