"""Softmax-with-cross-entropy and Adam: the CUDA kernels' wrappers and their
plain versions (counterpart of ``paddle_tpu/ops/pallas_fused.py``).

 - :func:`softmax_xent_fwd` replaces ``_xent_partial_kernel`` + the
   ``_finalize_loss`` arithmetic: per row of logits ``[R, V]`` it returns
   the loss, the logsumexp and, for soft labels, ``sum(y)``; the
   ``[R, V]`` probability matrix never exists.
 - :func:`softmax_xent_bwd` replaces ``_xent_bwd_kernel``:
   ``dx = g1 · exp(x − lse) − g2 · target``; :func:`xent_bwd_coeffs` is
   the reference's ``_bwd_coeffs`` on the device.
 - :class:`SoftmaxXent` ties the two into a ``torch.autograd.Function``,
   so the op's generic grad (``torch.autograd.grad`` over the forward)
   reaches the backward kernel.
 - :func:`adam` replaces ``_adam_kernel``: one in-place update of
   ``p, m1, m2`` per parameter with the bias-corrected ``lr_eff`` read
   from a ``[1]`` device tensor.

Every wrapper uses its plain version (``*_ref``) only for tensors on the
CPU; for CUDA tensors it launches the kernel (``csrc/softmax_xent.cu``,
``csrc/adam.cu``; float32, contiguous) or raises.  ``xent_fwd_launches``,
``xent_bwd_launches`` and ``adam_launches`` count kernel launches, so a
run can show the main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_ref", "softmax_xent_bwd",
           "softmax_xent_bwd_ref", "xent_bwd_coeffs", "SoftmaxXent", "adam",
           "adam_ref"]

#: kernel launches since the last reset (each wrapper adds one per launch)
xent_fwd_launches = 0
xent_bwd_launches = 0
adam_launches = 0

_libs = {}


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        from . import _build

        lib = _build.load(name)
        if name == "softmax_xent":
            lib.pta_xent_fwd_f32.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p])
            lib.pta_xent_bwd_f32.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            lib.pta_xent_fwd_f32.restype = ctypes.c_int
            lib.pta_xent_bwd_f32.restype = ctypes.c_int
            lib.pta_xent_error_string.argtypes = [ctypes.c_int]
            lib.pta_xent_error_string.restype = ctypes.c_char_p
        else:
            lib.pta_adam_f32.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                + [ctypes.c_float] * 5 + [ctypes.c_void_p])
            lib.pta_adam_f32.restype = ctypes.c_int
            lib.pta_adam_error_string.argtypes = [ctypes.c_int]
            lib.pta_adam_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _on_cpu(*tensors) -> bool:
    """True for all-CPU tensors (the plain version); raises unless they all
    lie on one CUDA device."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    return False


def _check(name, t, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the kernel (other "
                        f"dtypes come with the AMP slice); got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise(lib_err, rc, what):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib_err(rc).decode()} (cudaError {rc})")


# ---------------------------------------------------------------------------
# softmax with cross entropy
# ---------------------------------------------------------------------------


def _check_xent(x, label, soft):
    if x.dim() != 2:
        raise ValueError(f"logits must be [R, V]; got {tuple(x.shape)}")
    want = tuple(x.shape) if soft else (x.shape[0],)
    if tuple(label.shape) != want:
        raise ValueError(f"{'soft' if soft else 'hard'} labels must be "
                         f"{list(want)}; got {tuple(label.shape)}")


def softmax_xent_fwd_ref(x, label, soft, ignore_index=-100):
    """The plain version: ``(loss [R, 1], lse [R, 1], sum_y [R, 1] or
    None)`` by the kernel's formulas (``_finalize_loss``): ``lse = m +
    log(max(l, 1e-30))``; soft ``loss = lse · Σy − Σ y·x``; hard ``loss =
    lse − x[label]`` (a label outside ``[0, V)`` picks 0; 0 where label ==
    ignore_index ≥ 0)."""
    m = x.max(dim=-1, keepdim=True).values
    lse = m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)
                        .clamp_min(1e-30))
    if soft:
        b = label.sum(-1, keepdim=True)
        return lse * b - (label * x).sum(-1, keepdim=True), lse, b
    lab = label.reshape(-1, 1).long()
    v = x.shape[-1]
    valid = (lab >= 0) & (lab < v)
    picked = torch.where(valid, x.gather(-1, lab.clamp(0, v - 1)), 0.0)
    loss = lse - picked
    if ignore_index >= 0:
        loss = torch.where(lab == ignore_index, 0.0, loss)
    return loss, lse, None


def softmax_xent_fwd(x, label, soft, ignore_index=-100):
    """Per-row softmax cross entropy of logits ``x [R, V]`` against hard
    labels ``[R]`` (int) or soft labels ``[R, V]``.  Returns ``(loss [R, 1],
    lse [R, 1], sum_y [R, 1] or None)``."""
    global xent_fwd_launches
    _check_xent(x, label, soft)
    if _on_cpu(x, label):
        return softmax_xent_fwd_ref(x, label, soft, ignore_index)
    _check("logits", x)
    if soft:
        _check("soft labels", label)
    else:
        label = label.to(torch.int64).contiguous()
    r, v = x.shape
    lib = _lib("softmax_xent")
    loss = torch.empty(r, 1, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    sum_y = torch.empty_like(loss) if soft else None
    with torch.cuda.device(x.device):
        rc = lib.pta_xent_fwd_f32(
            x.data_ptr(), label.data_ptr() if soft else None,
            None if soft else label.data_ptr(), int(soft), loss.data_ptr(),
            lse.data_ptr(), sum_y.data_ptr() if soft else None, r, v,
            int(ignore_index), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_xent_error_string, rc, "softmax_xent forward")
    xent_fwd_launches += 1
    return loss, lse, sum_y


def xent_bwd_coeffs(label, sum_y, dloss, dlse, soft, ignore_index=-100):
    """The per-row ``(g1, g2)`` of the backward (the reference's
    ``_bwd_coeffs``): ``g2`` is the loss cotangent (0 at ignored hard
    labels), ``g1 = g2 · Σy + dlse`` (``Σy`` = 1 for hard labels)."""
    e = dloss.to(torch.float32).reshape(-1, 1)
    if not soft and ignore_index >= 0:
        e = torch.where(label.reshape(-1, 1) == ignore_index, 0.0, e)
    g1 = e * sum_y if soft else e
    if dlse is not None:
        g1 = g1 + dlse.to(torch.float32).reshape(-1, 1)
    return g1.contiguous(), e.contiguous()


def softmax_xent_bwd_ref(x, label, lse, g1, g2, soft):
    """The plain version: ``g1 · exp(x − lse) − g2 · target``."""
    if soft:
        tgt = label
    else:
        cols = torch.arange(x.shape[-1], device=x.device)
        tgt = (cols[None, :] == label.reshape(-1, 1)).to(x.dtype)
    return g1 * torch.exp(x - lse) - g2 * tgt


def softmax_xent_bwd(x, label, lse, g1, g2, soft):
    """``dx [R, V] = g1 · exp(x − lse) − g2 · target`` with per-row
    ``lse``, ``g1``, ``g2`` ``[R, 1]``; target is the one-hot of a hard
    label or the soft label row."""
    global xent_bwd_launches
    _check_xent(x, label, soft)
    if _on_cpu(x, label, lse, g1, g2):
        return softmax_xent_bwd_ref(x, label, lse, g1, g2, soft)
    r, v = x.shape
    for name, t in (("logits", x), ("lse", lse), ("g1", g1), ("g2", g2)):
        _check(name, t)
        if name != "logits" and t.numel() != r:
            raise ValueError(f"{name} must hold one value per row")
    if soft:
        _check("soft labels", label)
    else:
        label = label.to(torch.int64).contiguous()
    lib = _lib("softmax_xent")
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.pta_xent_bwd_f32(
            x.data_ptr(), label.data_ptr() if soft else None,
            None if soft else label.data_ptr(), int(soft), lse.data_ptr(),
            g1.data_ptr(), g2.data_ptr(), dx.data_ptr(), r, v,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_xent_error_string, rc, "softmax_xent backward")
    xent_bwd_launches += 1
    return dx


class SoftmaxXent(torch.autograd.Function):
    """``SoftmaxXent.apply(x, label, soft, ignore_index)`` -> ``(loss
    [R, 1], lse [R, 1])`` of :func:`softmax_xent_fwd`, differentiable in
    the logits through :func:`softmax_xent_bwd`; labels get no
    gradient."""

    @staticmethod
    def forward(ctx, x, label, soft, ignore_index):
        loss, lse, sum_y = softmax_xent_fwd(x, label, soft, ignore_index)
        ctx.save_for_backward(x, label, lse, sum_y)
        ctx.soft, ctx.ignore_index = soft, ignore_index
        return loss, lse

    @staticmethod
    def backward(ctx, dloss, dlse):
        x, label, lse, sum_y = ctx.saved_tensors
        if dloss is None:
            dloss = torch.zeros_like(lse)
        g1, g2 = xent_bwd_coeffs(label, sum_y, dloss, dlse, ctx.soft,
                                 ctx.ignore_index)
        return (softmax_xent_bwd(x, label, lse, g1, g2, ctx.soft), None,
                None, None)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps):
    """The plain version: new ``(p, m1, m2)`` in the kernel's order of
    operations."""
    m1o = b1 * m1 + (1.0 - b1) * g
    m2o = b2 * m2 + (1.0 - b2) * g * g
    return p - lr_eff * m1o / (torch.sqrt(m2o) + eps), m1o, m2o


def adam(p, g, m1, m2, lr_eff, b1, b2, eps):
    """One Adam update of ``p``, ``m1``, ``m2`` IN PLACE from grad ``g``
    and the bias-corrected ``lr_eff`` (a ``[1]`` tensor on the same
    device).  Returns ``(p, m1, m2)``."""
    global adam_launches
    if not (p.shape == g.shape == m1.shape == m2.shape):
        raise ValueError(f"param, grad and moments must share a shape; got "
                         f"{[tuple(t.shape) for t in (p, g, m1, m2)]}")
    if lr_eff.numel() != 1:
        raise ValueError("lr_eff must hold one value")
    if _on_cpu(p, g, m1, m2, lr_eff):
        po, m1o, m2o = adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps)
        p.copy_(po)
        m1.copy_(m1o)
        m2.copy_(m2o)
        return p, m1, m2
    for name, t in (("param", p), ("grad", g), ("moment1", m1),
                    ("moment2", m2), ("lr_eff", lr_eff)):
        _check(name, t)
    lib = _lib("adam")
    with torch.cuda.device(p.device):
        rc = lib.pta_adam_f32(
            p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            lr_eff.data_ptr(), p.numel(), float(b1), float(1.0 - b1),
            float(b2), float(1.0 - b2), float(eps),
            torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_adam_error_string, rc, "adam")
    adam_launches += 1
    return p, m1, m2
