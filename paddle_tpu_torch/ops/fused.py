"""Softmax-with-cross-entropy, Adam and momentum: the CUDA kernels' wrappers
and their plain versions (counterpart of ``paddle_tpu/ops/pallas_fused.py``).

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
 - :func:`softmax_xent_partial` is ``_xent_partial_kernel`` itself: the
   per-row partials ``(m, l, a[, b])``, unfinished.
   :class:`SoftmaxXentSharded` is the reference's
   ``softmax_xent_sharded`` (``pallas_fused.py:361``) on one rank of a tp
   group: the partials of the rank's vocabulary slice (hard labels
   shifted by its offset), one max and one sum exchange over the group,
   ``_finalize_loss`` with the ignore mask on the original label; its
   backward is the backward kernel on the slice with the global lse.
 - :func:`adam_group` replaces ``_adam_kernel`` and the adam op's scalar
   math: one launch updates ``p, m1, m2`` of every entry of a group in
   place, each with its bias-corrected ``lr_eff`` computed in the kernel
   from its own ``[1]`` learning rate and beta pows, which it then moves
   on; :func:`adam` is a one-entry group given ``lr_eff`` itself.
 - :func:`momentum_group` replaces ``_momentum_kernel``: one launch
   updates ``p, v`` of every entry (plain or Nesterov), each entry's
   ``lr`` read from its own ``[1]`` tensor; :func:`momentum` is a
   one-entry group.

Every wrapper uses its plain version (``*_ref``) only for tensors on the
CPU; for CUDA tensors it launches the kernel (``csrc/softmax_xent.cu``,
``csrc/adam.cu``, ``csrc/momentum.cu``; contiguous) or raises.  The xent
kernels take float32, bfloat16 or float16 logits (soft labels float32 or
the logits' dtype), compute in fp32, and write ``dx`` in the logits'
dtype; the optimizer kernels take float32.  ``xent_fwd_launches``,
``xent_bwd_launches`` (with ``xent_fwd_launches_by_dtype`` /
``xent_bwd_launches_by_dtype`` splitting them by the logits' dtype, and
``xent_fwd_launches_by_layout`` / ``xent_bwd_launches_by_layout`` by the
kernels' layout: ``narrow``, tiles of whole rows, for rows of up to 256
logits forward and 128 backward, or ``wide``, a block a row),
``xent_partial_launches`` (with ``xent_partial_launches_by_dtype`` and
``xent_partial_launches_by_layout``),
``adam_launches`` and ``momentum_launches`` count kernel launches, so a
run can show the main path went through them; ``adam_tensors`` and
``momentum_tensors`` count the parameters those launches updated.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_ref", "softmax_xent_bwd",
           "softmax_xent_bwd_ref", "xent_bwd_coeffs", "SoftmaxXent",
           "softmax_xent_partial", "softmax_xent_partial_ref",
           "SoftmaxXentSharded",
           "adam_group", "adam_group_ref", "adam", "adam_ref",
           "momentum_group", "momentum_group_ref", "momentum", "momentum_ref"]

#: kernel launches since the last reset (each wrapper adds one per launch)
xent_fwd_launches = 0
xent_bwd_launches = 0
#: the xent launches by the logits' dtype (their sums are the totals above)
xent_fwd_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
xent_bwd_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
#: ... and by the layout the kernel entry chose (``pta_xent_layout``)
xent_fwd_launches_by_layout = {"narrow": 0, "wide": 0}
xent_bwd_launches_by_layout = {"narrow": 0, "wide": 0}
#: the partials entry's launches, by dtype and by layout as the forward's
xent_partial_launches = 0
xent_partial_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
xent_partial_launches_by_layout = {"narrow": 0, "wide": 0}
adam_launches = 0
momentum_launches = 0
#: parameters the Adam and momentum launches updated since the last reset
adam_tensors = 0
momentum_tensors = 0

_libs = {}


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        from . import _build

        lib = _build.load(name)
        if name == "softmax_xent":
            for sx, sy in _XENT_ENTRIES:
                fwd = getattr(lib, f"pta_xent_fwd_{sx}_{sy}")
                bwd = getattr(lib, f"pta_xent_bwd_{sx}_{sy}")
                fwd.argtypes = (
                    [ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p])
                bwd.argtypes = (
                    [ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
                part = getattr(lib, f"pta_xent_partial_{sx}_{sy}")
                part.argtypes = (
                    [ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
                fwd.restype = bwd.restype = part.restype = ctypes.c_int
            lib.pta_xent_layout.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int]
            lib.pta_xent_layout.restype = ctypes.c_int
            lib.pta_xent_error_string.argtypes = [ctypes.c_int]
            lib.pta_xent_error_string.restype = ctypes.c_char_p
        elif name == "momentum":
            lib.pta_momentum_group_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
            lib.pta_momentum_group_f32.restype = ctypes.c_int
            lib.pta_momentum_error_string.argtypes = [ctypes.c_int]
            lib.pta_momentum_error_string.restype = ctypes.c_char_p
        else:
            lib.pta_adam_group_f32.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_float] * 5
                + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
            lib.pta_adam_group_f32.restype = ctypes.c_int
            lib.pta_adam_group_capacity.argtypes = []
            lib.pta_adam_group_capacity.restype = ctypes.c_int
            lib.pta_adam_error_string.argtypes = [ctypes.c_int]
            lib.pta_adam_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _on_cpu(*tensors) -> bool:
    """True for all-CPU tensors (the plain version); raises unless they all
    lie on one CUDA device.  ``None`` entries (absent optional inputs) are
    skipped."""
    tensors = [t for t in tensors if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    return False


def _check(name, t, dtypes=(torch.float32,)):
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)} for the "
                        f"kernel; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise(lib_err, rc, what):
    raise RuntimeError(f"{what} kernel launch failed: "
                       f"{lib_err(rc).decode()} (cudaError {rc})")


# ---------------------------------------------------------------------------
# softmax with cross entropy
# ---------------------------------------------------------------------------


# logits dtypes the kernels take, by the suffix of their entries; soft
# labels come in float32 or the logits' dtype, hard labels as int64
_XENT_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
_XENT_ENTRIES = [(sx, sy) for sx in _XENT_DTYPES.values()
                 for sy in dict.fromkeys(("f32", sx, "i64"))]


def _check_xent(x, label, soft):
    if x.dim() != 2:
        raise ValueError(f"logits must be [R, V]; got {tuple(x.shape)}")
    want = tuple(x.shape) if soft else (x.shape[0],)
    if tuple(label.shape) != want:
        raise ValueError(f"{'soft' if soft else 'hard'} labels must be "
                         f"{list(want)}; got {tuple(label.shape)}")


def _xent_entry(kind, x, label, soft):
    """The name of the kernel entry for the logits' and labels' dtypes;
    raises for dtypes the kernels do not take."""
    _check("logits", x, tuple(_XENT_DTYPES))
    sx = _XENT_DTYPES[x.dtype]
    if soft:
        _check("soft labels", label, tuple(dict.fromkeys(
            (torch.float32, x.dtype))))
        sy = _XENT_DTYPES[label.dtype]
    else:
        sy = "i64"
    return f"pta_xent_{kind}_{sx}_{sy}"


def _xent_layout(lib, x, backward):
    """``"narrow"`` or ``"wide"``: the layout the forward or backward
    kernel entry takes for logits ``x`` (the C library's own rule,
    ``pta_xent_layout``)."""
    r, v = x.shape
    return ("wide", "narrow")[lib.pta_xent_layout(r, v, int(backward))]


def _f32(t):
    """``t`` in fp32 if it is bf16 / fp16 (the kernels widen every value as
    they read it), else as it is."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def softmax_xent_fwd_ref(x, label, soft, ignore_index=-100):
    """The plain version: ``(loss [R, 1], lse [R, 1], sum_y [R, 1] or
    None)`` by the kernel's formulas (``_finalize_loss``): ``lse = m +
    log(max(l, 1e-30))``; soft ``loss = lse · Σy − Σ y·x``; hard ``loss =
    lse − x[label]`` (a label outside ``[0, V)`` picks 0; 0 where label ==
    ignore_index ≥ 0).  bf16 / fp16 logits and labels are widened to fp32
    first, as the kernels read them."""
    x = _f32(x)
    m = x.max(dim=-1, keepdim=True).values
    lse = m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)
                        .clamp_min(1e-30))
    if soft:
        label = _f32(label)
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
    """Per-row softmax cross entropy of logits ``x [R, V]`` (float32,
    bfloat16 or float16) against hard labels ``[R]`` (int) or soft labels
    ``[R, V]``.  Returns fp32 ``(loss [R, 1], lse [R, 1], sum_y [R, 1] or
    None)``."""
    global xent_fwd_launches
    _check_xent(x, label, soft)
    if _on_cpu(x, label):
        return softmax_xent_fwd_ref(x, label, soft, ignore_index)
    entry = _xent_entry("fwd", x, label, soft)
    lib = _lib("softmax_xent")
    if not soft:
        label = label.to(torch.int64).contiguous()
    r, v = x.shape
    loss = torch.empty(r, 1, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    sum_y = torch.empty_like(loss) if soft else None
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), label.data_ptr() if soft else None,
            None if soft else label.data_ptr(), int(soft), loss.data_ptr(),
            lse.data_ptr(), sum_y.data_ptr() if soft else None, r, v,
            int(ignore_index), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_xent_error_string, rc, "softmax_xent forward")
    xent_fwd_launches += 1
    xent_fwd_launches_by_dtype[str(x.dtype)[6:]] += 1
    xent_fwd_launches_by_layout[_xent_layout(lib, x, False)] += 1
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
    """The plain version: ``g1 · exp(x − lse) − g2 · target``, computed in
    fp32 from bf16 / fp16 inputs and returned in the logits' dtype."""
    xf = _f32(x)
    if soft:
        tgt = _f32(label)
    else:
        cols = torch.arange(x.shape[-1], device=x.device)
        tgt = (cols[None, :] == label.reshape(-1, 1)).to(xf.dtype)
    return (g1 * torch.exp(xf - lse) - g2 * tgt).to(x.dtype)


def softmax_xent_bwd(x, label, lse, g1, g2, soft):
    """``dx [R, V] = g1 · exp(x − lse) − g2 · target`` with per-row fp32
    ``lse``, ``g1``, ``g2`` ``[R, 1]``; target is the one-hot of a hard
    label or the soft label row; ``dx`` in the logits' dtype."""
    global xent_bwd_launches
    _check_xent(x, label, soft)
    if _on_cpu(x, label, lse, g1, g2):
        return softmax_xent_bwd_ref(x, label, lse, g1, g2, soft)
    r, v = x.shape
    for name, t in (("lse", lse), ("g1", g1), ("g2", g2)):
        _check(name, t)
        if t.numel() != r:
            raise ValueError(f"{name} must hold one value per row")
    entry = _xent_entry("bwd", x, label, soft)
    lib = _lib("softmax_xent")
    if not soft:
        label = label.to(torch.int64).contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), label.data_ptr() if soft else None,
            None if soft else label.data_ptr(), int(soft), lse.data_ptr(),
            g1.data_ptr(), g2.data_ptr(), dx.data_ptr(), r, v,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_xent_error_string, rc, "softmax_xent backward")
    xent_bwd_launches += 1
    xent_bwd_launches_by_dtype[str(x.dtype)[6:]] += 1
    xent_bwd_launches_by_layout[_xent_layout(lib, x, True)] += 1
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


def softmax_xent_partial_ref(x, label, soft):
    """The plain version of the partials: fp32 ``(m, l, a, b)`` ``[R, 1]``
    columns, ``b`` None for hard labels: ``m = max x``, ``l = Σ e^(x −
    m)``, ``a = Σ y·x`` (soft) or the label's logit (hard; 0 for a label
    outside ``[0, V)``), ``b = Σ y``.  bf16 / fp16 values are widened to
    fp32 first, as the kernel reads them."""
    x = _f32(x)
    m = x.max(dim=-1, keepdim=True).values
    l = torch.exp(x - m).sum(-1, keepdim=True)
    if soft:
        label = _f32(label)
        return m, l, (label * x).sum(-1, keepdim=True), \
            label.sum(-1, keepdim=True)
    lab = label.reshape(-1, 1).long()
    v = x.shape[-1]
    valid = (lab >= 0) & (lab < v)
    return m, l, torch.where(valid, x.gather(-1, lab.clamp(0, v - 1)),
                             0.0), None


def softmax_xent_partial(x, label, soft):
    """The per-row partials of logits ``x [R, V]`` (float32, bfloat16 or
    float16) against hard labels ``[R]`` (int) or soft labels ``[R, V]``
    (:func:`softmax_xent_partial_ref`'s ``(m, l, a, b)``, fp32 ``[R, 1]``,
    ``b`` None for hard labels).  On the card one launch of
    ``pta_xent_partial_*``; there is no fallback."""
    global xent_partial_launches
    _check_xent(x, label, soft)
    if _on_cpu(x, label):
        return softmax_xent_partial_ref(x, label, soft)
    entry = _xent_entry("partial", x, label, soft)
    lib = _lib("softmax_xent")
    if not soft:
        label = label.to(torch.int64).contiguous()
    r, v = x.shape
    m, l, a = (torch.empty(r, 1, dtype=torch.float32, device=x.device)
               for _ in range(3))
    b = torch.empty_like(m) if soft else None
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), label.data_ptr() if soft else None,
            None if soft else label.data_ptr(), int(soft), m.data_ptr(),
            l.data_ptr(), a.data_ptr(), b.data_ptr() if soft else None, r, v,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        _raise(lib.pta_xent_error_string, rc, "softmax_xent partials")
    xent_partial_launches += 1
    xent_partial_launches_by_dtype[str(x.dtype)[6:]] += 1
    xent_partial_launches_by_layout[_xent_layout(lib, x, False)] += 1
    return m, l, a, b


def finalize_xent(m, l, a, b, label, soft, ignore_index=-100):
    """The reference's ``_finalize_loss``: ``(loss, lse)`` from the
    (combined) partials; the ignore mask reads the original hard label."""
    lse = m + torch.log(l.clamp_min(1e-30))
    if soft:
        return lse * b - a, lse
    loss = lse - a
    if ignore_index >= 0:
        loss = torch.where(label.reshape(-1, 1) == ignore_index, 0.0, loss)
    return loss, lse


class SoftmaxXentSharded(torch.autograd.Function):
    """``SoftmaxXentSharded.apply(x, label, soft, ignore_index, group)``
    -> ``(loss [R, 1], lse [R, 1])`` of the whole rows, on one rank of the
    tp group ``group`` (``ops/collectives.py``) that holds the vocabulary
    slice ``x [R, V / tp]`` (in rank order) and the whole labels (hard
    ``[R]``, or soft ``[R, V / tp]``: its slice).  The partials of the
    slice (:func:`softmax_xent_partial`, hard labels shifted by ``rank ·
    V / tp``, so that a label on another slice picks nothing), ``m_g`` by
    one MAX all-reduce, ``l · e^(m − m_g)``, ``a`` and ``b`` summed by one
    SUM all-reduce, then :func:`finalize_xent`.  The backward runs the
    backward kernel on the slice with the whole rows' lse: no exchange."""

    @staticmethod
    def forward(ctx, x, label, soft, ignore_index, group):
        v_loc = x.shape[1]
        lab_k = label if soft else \
            label.to(torch.int64) - group.rank * v_loc
        m, l, a, b = softmax_xent_partial(x, lab_k, soft)
        m_g = group.all_reduce_(m.clone(), torch.distributed.ReduceOp.MAX)
        parts = [l * torch.exp(m - m_g), a] + ([b] if soft else [])
        summed = group.all_reduce_(torch.cat(parts, dim=1))
        l, a = summed[:, :1], summed[:, 1:2]
        b = summed[:, 2:3] if soft else None
        loss, lse = finalize_xent(m_g, l, a, b, label, soft, ignore_index)
        ctx.save_for_backward(x, lab_k, label, lse, b)
        ctx.soft, ctx.ignore_index = soft, ignore_index
        return loss, lse

    @staticmethod
    def backward(ctx, dloss, dlse):
        x, lab_k, label, lse, sum_y = ctx.saved_tensors
        if dloss is None:
            dloss = torch.zeros_like(lse)
        g1, g2 = xent_bwd_coeffs(label, sum_y, dloss, dlse, ctx.soft,
                                 ctx.ignore_index)
        return (softmax_xent_bwd(x, lab_k, lse.contiguous(), g1, g2,
                                 ctx.soft), None, None, None, None)


# ---------------------------------------------------------------------------
# Adam and momentum over a group of parameters, one launch
# ---------------------------------------------------------------------------

_F32 = torch.float32
# groups whose params, states and one-value tensors (but the rates) passed
# the checks, by kernel, newest last: (weak references, addresses, sizes);
# grads and rates are checked on every call
_checked = {"momentum": [], "adam": []}
_CHECKED_KEEP = 4
# the Adam kernel's per-entry counters of finished blocks, zeroed, by device
_adam_done = {}


def _check_entries(ps, gs, like_p, scalars):
    """Raise unless every entry's grad and ``like_p`` states (by name)
    share its param's shape, every ``scalars`` tensor (by name) holds one
    value, and no tensor the group writes (params, states, the one-value
    tensors other than ``lr``) appears twice."""
    names = ["param", "grad", *like_p]
    cols = (ps, gs, *like_p.values())
    for i, p in enumerate(ps):
        if not all(col[i].shape == p.shape for col in cols):
            raise ValueError(
                f"{', '.join(names[:-1])} and {names[-1]} must share a "
                f"shape; got {[tuple(col[i].shape) for col in cols]}")
    for name, col in scalars.items():
        if any(t.numel() != 1 for t in col):
            raise ValueError(f"{name} must hold one value")
    written = [t for col in (ps, *like_p.values()) for t in col]
    written += [t for name, col in scalars.items() if name != "lr"
                for t in col]
    written = [t for t in written if t.numel()]  # an empty one has no address
    if len({(t.device, t.data_ptr()) for t in written}) != len(written):
        raise ValueError("a tensor the group updates appears in it twice")


def _group_cols(kind, ps, gs, like_p, scalars):
    """The kernel's table for a group on the card, as ``int64`` columns:
    the addresses of the params, the grads, each ``like_p`` state and each
    ``scalars`` column (both by name), then the sizes.  Raises unless every
    tensor suits the kernel.  Params, states and the one-value tensors but
    ``lr`` persist across steps: they are checked once per set of objects,
    addresses and sizes.  The grads and the ``lr`` tensors are checked on
    every call: LARS computes each parameter's rate anew every step, which
    would otherwise re-check the whole persistent set every step."""
    named = [("param", ps), *like_p.items(),
             *((k, col) for k, col in scalars.items() if k != "lr")]
    stable = [t for _, col in named for t in col]
    ptrs = [t.data_ptr() for t in stable]
    sizes = [p.numel() for p in ps]
    seen = _checked[kind]
    if not any(c_ptrs == ptrs and c_sizes == sizes
               and all(r() is t for r, t in zip(refs, stable))
               for refs, c_ptrs, c_sizes in seen):
        _on_cpu(*stable)  # raises unless all lie on one CUDA device
        for name, col in named:
            for t in col:
                _check(name, t)
        _check_entries(ps, gs, like_p, scalars)
        seen.append(([weakref.ref(t) for t in stable], ptrs, sizes))
        del seen[:-_CHECKED_KEEP]
    idx = ps[0].get_device()
    lrs = scalars["lr"]
    if not (all([g.dtype is _F32 and g.is_contiguous()
                 and g.get_device() == idx and g.shape == p.shape
                 for p, g in zip(ps, gs)])
            and all([t.dtype is _F32 and t.numel() == 1
                     and t.get_device() == idx for t in lrs])):
        _on_cpu(ps[0], *gs, *lrs)
        for g in gs:
            _check("grad", g)
        for t in lrs:
            _check("lr", t)
        _check_entries(ps, gs, like_p, scalars)
    cols = ptrs[:len(ps)] + [g.data_ptr() for g in gs]
    k = len(ps)
    for name, col in (*like_p.items(), *scalars.items()):
        if name == "lr":
            cols += [t.data_ptr() for t in col]
        else:
            cols += ptrs[k:k + len(col)]
            k += len(col)
    return np.array(cols + sizes, dtype=np.int64)


def adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps):
    """The plain version of one entry: new ``(p, m1, m2)`` in the kernel's
    order of operations."""
    m1o = b1 * m1 + (1.0 - b1) * g
    m2o = b2 * m2 + (1.0 - b2) * g * g
    return p - lr_eff * m1o / (torch.sqrt(m2o) + eps), m1o, m2o


def adam_group_ref(ps, gs, m1s, m2s, lrs, b1ps, b2ps, b1, b2, eps):
    """The plain version, in the adam op's torch arithmetic: for each entry
    ``lr_eff = lr · √(1 − b2p) / (1 − b1p)``, :func:`adam_ref`, and the new
    pows ``b1p · b1``, ``b2p · b2``.  Returns a list of new ``(p, m1, m2,
    b1p, b2p)``."""
    out = []
    for p, g, m1, m2, lr, b1p, b2p in zip(ps, gs, m1s, m2s, lrs, b1ps, b2ps):
        lr_eff = lr * (1.0 - b2p).sqrt() / (1.0 - b1p)
        out.append((*adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps), b1p * b1,
                    b2p * b2))
    return out


def adam_group(ps, gs, m1s, m2s, lrs, b1ps, b2ps, b1, b2, eps):
    """One Adam update of every entry IN PLACE: ``p``, ``m1``, ``m2`` from
    grad ``g``, the entry's learning rate ``lr`` and beta pows ``b1p``,
    ``b2p`` (``[1]`` tensors on the same device), which become ``b1p ·
    b1`` and ``b2p · b2``.  On the card one launch covers the group (more
    only past the kernel's table capacity).  Returns the new beta pows
    ``(b1ps, b2ps)``: the tensors given, updated."""
    global adam_launches, adam_tensors
    cols = (ps, gs, m1s, m2s, lrs, b1ps, b2ps)
    if len({len(c) for c in cols}) != 1:
        raise ValueError("adam_group takes one of each tensor per entry")
    if not ps:
        return b1ps, b2ps
    if ps[0].device.type != "cuda" and _on_cpu(*(t for c in cols for t in c)):
        _check_entries(ps, gs, {"moment1": m1s, "moment2": m2s},
                       {"lr": lrs, "beta1_pow": b1ps, "beta2_pow": b2ps})
        new = adam_group_ref(ps, gs, m1s, m2s, lrs, b1ps, b2ps, b1, b2, eps)
        for old, upd in zip(zip(ps, m1s, m2s, b1ps, b2ps), new):
            for t, u in zip(old, upd):
                t.copy_(u)
        return b1ps, b2ps
    table = _group_cols("adam", ps, gs, {"moment1": m1s, "moment2": m2s},
                        {"lr": lrs, "beta1_pow": b1ps, "beta2_pow": b2ps})
    lib = _lib("adam")
    dev = ps[0].device
    done = _adam_done.get(dev)
    if done is None:
        done = _adam_done[dev] = torch.zeros(
            lib.pta_adam_group_capacity(), dtype=torch.int32, device=dev)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.pta_adam_group_f32(
            table.ctypes.data, len(ps), done.data_ptr(), float(b1),
            float(1.0 - b1), float(b2), float(1.0 - b2), float(eps),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(launches))
    adam_launches += launches.value
    if rc != 0:
        _raise(lib.pta_adam_error_string, rc, "adam")
    adam_tensors += len(ps)
    return b1ps, b2ps


def adam(p, g, m1, m2, lr_eff, b1, b2, eps):
    """One Adam update of ``p``, ``m1``, ``m2`` IN PLACE from grad ``g``
    and the bias-corrected ``lr_eff`` (a ``[1]`` tensor on the same
    device): a one-entry :func:`adam_group` whose beta pows are 0, so its
    ``lr · √(1 − 0) / (1 − 0)`` is ``lr_eff`` exactly.  Returns ``(p, m1,
    m2)``."""
    zeros = [torch.zeros(1, device=p.device) for _ in range(2)]
    adam_group([p], [g], [m1], [m2], [lr_eff], zeros[:1], zeros[1:], b1, b2,
               eps)
    return p, m1, m2


def momentum_ref(p, g, v, lr, mu, nesterov):
    """The plain version of one entry: new ``(p, v)`` in the kernel's (and
    the reference's) order of operations."""
    vo = mu * v + g
    if nesterov:
        return p - (g + mu * vo) * lr, vo
    return p - lr * vo, vo


def momentum_group_ref(ps, gs, vs, lrs, mu, nesterov):
    """The plain version: :func:`momentum_ref` of each entry, a list of new
    ``(p, v)``."""
    return [momentum_ref(p, g, v, lr, mu, nesterov)
            for p, g, v, lr in zip(ps, gs, vs, lrs)]


def momentum_group(ps, gs, vs, lrs, mu, nesterov):
    """One momentum update of every entry's ``p`` and ``v`` IN PLACE from
    grad ``g`` and the entry's ``lr`` (a ``[1]`` tensor on the same
    device): ``v = mu·v + g``, then ``p -= lr·v``, or ``p -= (g + mu·v)·lr``
    with ``nesterov``.  On the card one launch covers the group (more only
    past the kernel's table capacity)."""
    global momentum_launches, momentum_tensors
    cols = (ps, gs, vs, lrs)
    if len({len(c) for c in cols}) != 1:
        raise ValueError("momentum_group takes one of each tensor per entry")
    if not ps:
        return
    if ps[0].device.type != "cuda" and _on_cpu(*(t for c in cols for t in c)):
        _check_entries(ps, gs, {"velocity": vs}, {"lr": lrs})
        for (p, v), (po, vo) in zip(zip(ps, vs), momentum_group_ref(
                ps, gs, vs, lrs, mu, nesterov)):
            p.copy_(po)
            v.copy_(vo)
        return
    table = _group_cols("momentum", ps, gs, {"velocity": vs}, {"lr": lrs})
    lib = _lib("momentum")
    dev = ps[0].device
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.pta_momentum_group_f32(
            table.ctypes.data, len(ps), float(mu), int(bool(nesterov)),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(launches))
    momentum_launches += launches.value
    if rc != 0:
        _raise(lib.pta_momentum_error_string, rc, "momentum")
    momentum_tensors += len(ps)


def momentum(p, g, v, lr, mu, nesterov):
    """One momentum update of ``p`` and ``v`` IN PLACE: a one-entry
    :func:`momentum_group`.  Returns ``(p, v)``."""
    momentum_group([p], [g], [v], [lr], mu, nesterov)
    return p, v
