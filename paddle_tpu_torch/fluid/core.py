"""Places and dtypes (counterpart of ``paddle_tpu/fluid/core.py``).

A Place names a ``torch.device``.  ``CUDAPlace`` is the card and the
default of every entry point; ``CPUPlace`` runs each op's plain PyTorch
version and is what the CPU tests pass; ``TPUPlace`` is accepted so code
written against the reference keeps working, and maps to the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class VarType:
    """Mirror of the reference's framework.proto VarType (stable small ints
    so programs compare and serialize alike in both packages)."""

    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    UINT8 = 7
    INT8 = 8
    BF16 = 9
    LOD_TENSOR = 20


_STR_TO_VARTYPE = {
    "bool": VarType.BOOL,
    "int16": VarType.INT16,
    "int32": VarType.INT32,
    "int64": VarType.INT64,
    "float16": VarType.FP16,
    "float32": VarType.FP32,
    "float64": VarType.FP64,
    "uint8": VarType.UINT8,
    "int8": VarType.INT8,
    "bfloat16": VarType.BF16,
}

_VARTYPE_TO_STR = {v: k for k, v in _STR_TO_VARTYPE.items()}

_STR_TO_TORCH = {
    "bool": torch.bool,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
}


def convert_dtype(dtype) -> str:
    """Normalize any dtype spec (string, numpy or torch dtype, VarType int)
    to the reference's dtype string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        if dtype in _STR_TO_VARTYPE:
            return dtype
        return np.dtype(dtype).name
    if isinstance(dtype, int):
        if dtype in _VARTYPE_TO_STR:
            return _VARTYPE_TO_STR[dtype]
        raise ValueError(f"unknown VarType enum {dtype}")
    if isinstance(dtype, torch.dtype):
        for name, td in _STR_TO_TORCH.items():
            if td == dtype:
                return name
        raise ValueError(f"cannot convert dtype {dtype!r}")
    try:
        name = np.dtype(dtype).name
        if name in _STR_TO_VARTYPE:
            return name
    except TypeError:
        pass
    raise ValueError(f"cannot convert dtype {dtype!r}")


def np_dtype(dtype) -> np.dtype:
    name = convert_dtype(dtype)
    if name == "bfloat16":
        raise TypeError("numpy has no bfloat16; keep bfloat16 data in torch")
    return np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    return _STR_TO_TORCH[convert_dtype(dtype)]


@dataclass(frozen=True)
class Place:
    device_type: str  # "cpu" | "gpu" | "tpu"
    device_id: int = 0

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class TPUPlace(Place):
    """Accepted for API parity with the reference; runs on the card."""

    def __init__(self, device_id: int = 0):
        super().__init__("tpu", device_id)


def torch_device(place: Place) -> torch.device:
    """The ``torch.device`` a Place names.  A card place raises when this
    process sees no CUDA device: the port never falls back to the CPU on
    its own — a caller who wants the CPU passes ``CPUPlace()``."""
    if place.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{place!r} needs a CUDA device and torch sees none; pass "
            f"CPUPlace() to run the plain PyTorch path on the CPU")
    return torch.device("cuda", place.device_id)

