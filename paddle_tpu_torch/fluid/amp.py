"""Mixed precision (counterpart of ``paddle_tpu/fluid/amp.py``): bf16 or fp16
contractions with fp32 master weights, an execution mode of the op library.

When enabled, the contraction ops (``mul``, ``matmul``, ``conv2d``) cast
fp32 operands to the compute dtype; parameters, optimizer state,
normalization statistics and the loss stay fp32:

 - default regime: the contraction's result is cast back to fp32
   (:func:`restore_astype`);
 - ``keep_activations=True``: the result STAYS in the compute dtype, so the
   activations between layers move at half the bytes.  Norms compute in
   fp32 and return the input's dtype, softmax and the losses upcast, and an
   elementwise op's broadcast operand follows the main operand's dtype.
 - ``"float16"`` arms a dynamic loss scaler by default: ``Optimizer.
   minimize`` creates the persistable scale vars (:func:`create_loss_
   scaling_vars`) and divides the raw grads by the scale
   (``clip.append_unscale_ops``); the Executor multiplies the backward
   seed by the scale and, after the backward, commits the step only if the
   loss and every raw grad are finite (``fluid/guardian.py``).

On the card the products run on the tensor cores.  cuBLAS may sum a
split-K bf16/fp16 product's partials in the low dtype unless told not to;
the reference's contractions accumulate in fp32, so :func:`fp32_sums`
switches that off around the port's AMP products and restores the
caller's setting.

Enable with ``fluid.amp.enable("bfloat16")`` / ``amp_guard(...)``, or the
environment: ``PADDLE_TPU_AMP=bfloat16`` at import.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

_SUPPORTED = ("bfloat16", "float16")
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}

#: persistable scope vars carrying the dynamic loss-scale state; created by
#: Optimizer.minimize (via create_loss_scaling_vars) when scaling is active
#: at build time, updated by the Executor's guarded step every run
LOSS_SCALE_VAR = "@LOSS_SCALE@"
LOSS_SCALE_GOOD_VAR = "@LOSS_SCALE_GOOD@"

_state = {"dtype": None, "keep": False, "dynamic_scaling": None,
          "init_loss_scale": 2.0 ** 15, "scale_growth_interval": 1000}


def enable(dtype: str = "bfloat16", keep_activations=None,
           dynamic_loss_scaling=None, init_loss_scale=None,
           growth_interval=None) -> None:
    """Enable mixed precision in ``dtype``.  ``keep_activations``: leave
    contraction results in the compute dtype (default: the
    ``PADDLE_TPU_AMP_KEEP`` env var, else False).  ``dynamic_loss_scaling``:
    None = on for float16 only; it is a build-time decision (set it before
    ``minimize``).  ``init_loss_scale`` and ``growth_interval`` configure
    the scaler built next."""
    if dtype not in _SUPPORTED:
        raise ValueError(f"amp dtype must be one of {_SUPPORTED}, got {dtype!r}")
    _state["dtype"] = dtype
    if keep_activations is None:
        from . import envcontract

        keep_activations = bool(envcontract.get("PADDLE_TPU_AMP_KEEP"))
    _state["keep"] = bool(keep_activations)
    _state["dynamic_scaling"] = dynamic_loss_scaling
    if init_loss_scale is not None:
        _state["init_loss_scale"] = float(init_loss_scale)
    if growth_interval is not None:
        _state["scale_growth_interval"] = max(1, int(growth_interval))


def disable() -> None:
    _state["dtype"] = None
    _state["keep"] = False
    _state["dynamic_scaling"] = None


def dynamic_scaling_active() -> bool:
    """True when programs built NOW should carry dynamic loss scaling."""
    ds = _state["dynamic_scaling"]
    if ds is not None:
        return bool(ds) and _state["dtype"] is not None
    return _state["dtype"] == "float16"


def scaling_config():
    """(init_loss_scale, growth_interval) for the scaler being built."""
    return _state["init_loss_scale"], _state["scale_growth_interval"]


def create_loss_scaling_vars(program, startup_program):
    """Create (or reuse) the persistable loss-scale state vars in
    ``program`` and record them on it for the guarded executor step.
    Returns the scale Variable (read by the unscale ops)."""
    from .framework import program_guard
    from .layers import tensor as _tensor

    block = program.global_block()
    with program_guard(program, startup_program):
        if block.has_var(LOSS_SCALE_VAR):
            scale = block.var(LOSS_SCALE_VAR)
        else:
            scale = _tensor.create_global_var(
                shape=[1], value=_state["init_loss_scale"], dtype="float32",
                persistable=True, name=LOSS_SCALE_VAR)
            _tensor.create_global_var(
                shape=[1], value=0, dtype="int32",
                persistable=True, name=LOSS_SCALE_GOOD_VAR)
    program._loss_scale_vars = (LOSS_SCALE_VAR, LOSS_SCALE_GOOD_VAR)
    program._loss_scale_growth = _state["scale_growth_interval"]
    return scale


def is_enabled() -> bool:
    return _state["dtype"] is not None


def compute_dtype():
    """The active low-precision compute dtype name, or None."""
    return _state["dtype"]


def keep_low_activations() -> bool:
    """True when AMP is on in the pure-low-activation regime."""
    return _state["dtype"] is not None and _state["keep"]


def is_low_float(dtype) -> bool:
    """True for sub-32-bit float dtypes (bf16/fp16): the predicate ops use
    to decide 'compute this norm/loss internally in fp32'."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


@contextlib.contextmanager
def amp_guard(dtype: str = "bfloat16", keep_activations=None):
    prev = dict(_state)
    enable(dtype, keep_activations=keep_activations)
    try:
        yield
    finally:
        _state.update(prev)


@contextlib.contextmanager
def fp32_sums():
    """cuBLAS sums bf16 and fp16 products in fp32 inside the block (no
    reduced-precision split-K reductions), whatever the caller's setting;
    the setting is restored after.  Nothing to do while AMP is off."""
    if _state["dtype"] is None:
        yield
        return
    m = torch.backends.cuda.matmul
    prev = (m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction)
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = prev


@functools.lru_cache(maxsize=256)
def _rounded(v: float, dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def weak_scalar(v, dtype):
    """A python scalar as the reference's JAX arithmetic meets a tensor of
    ``dtype``: a weakly typed scalar takes the tensor's dtype, so against a
    bf16 / fp16 activation it is rounded to that dtype first (torch would
    multiply by it in fp32 and round once, an ulp apart)."""
    if dtype in (torch.bfloat16, torch.float16):
        return _rounded(float(v), dtype)
    return v


def promote(a, b):
    """``a`` and ``b`` in their common dtype: ``jnp.matmul`` / ``einsum``
    promote mixed operands (a bf16 activation against an fp32 one that
    ``cast_operands`` passed through), ``torch.matmul`` refuses them."""
    if a.dtype != b.dtype:
        d = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(d), b.to(d)
    return a, b


def matmul(a, b):
    """``a @ b`` in the AMP compute dtype; identity when AMP is off.  The
    result is restored to fp32 in the default regime, or LEFT in the
    compute dtype under keep_activations."""
    a2, b2, back = cast_operands(a, b)
    with fp32_sums():
        out = torch.matmul(*promote(a2, b2))
    return restore_astype(out, back)


def einsum(spec, a, b):
    """Two-operand einsum under the same AMP recipe (and keep_activations
    behavior) as :func:`matmul`."""
    a2, b2, back = cast_operands(a, b)
    with fp32_sums():
        out = torch.einsum(spec, *promote(a2, b2))
    return restore_astype(out, back)


def cast_operands(*arrays):
    """Cast fp32 contraction operands to the AMP dtype.

    Returns ``(arrays..., restore_dtype)``.  Default regime: when AMP is
    off (or any operand is not fp32) the operands pass through unchanged
    and restore_dtype is None; otherwise the caller computes the
    contraction in the low dtype and casts its result back with
    :func:`restore_astype`.

    keep_activations regime: operands may arrive fp32 (params, feeds) or
    already in the compute dtype (upstream activations); fp32 ones are
    cast down, restore_dtype is None, and the result STAYS low.  Any other
    operand dtype passes the whole contraction through.
    """
    d = _state["dtype"]
    if d is None:
        return (*arrays, None)
    cd = _TORCH[d]
    if _state["keep"]:
        if any(a is None or a.dtype not in (torch.float32, cd)
               for a in arrays):
            return (*arrays, None)
        return (*(a.to(cd) if a.dtype == torch.float32 else a
                  for a in arrays), None)
    if any(a is None or a.dtype != torch.float32 for a in arrays):
        return (*arrays, None)
    return (*(a.to(cd) for a in arrays), torch.float32)


def restore_astype(out, restore_dtype):
    """Cast a contraction result back to the pre-AMP dtype (no-op when
    cast_operands passed through)."""
    return out if restore_dtype is None else out.to(restore_dtype)


# environment bridge, read once at import as in the reference
_env = os.environ.get("PADDLE_TPU_AMP", "").strip().lower()
if _env in ("bf16", "bfloat16", "1", "true"):
    enable("bfloat16")
elif _env in ("fp16", "float16"):
    enable("float16")
_env_scale = os.environ.get("PADDLE_TPU_AMP_INIT_SCALE", "").strip()
if _env_scale:
    _state["init_loss_scale"] = float(_env_scale)
_env_interval = os.environ.get("PADDLE_TPU_AMP_SCALE_INTERVAL", "").strip()
if _env_interval:
    _state["scale_growth_interval"] = max(1, int(_env_interval))
