"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions (counterpart of ``paddle_tpu/ops/pallas_flash.py``).

 - :func:`flash_forward` replaces ``_flash_kernel``: ``(out, lse)`` of
   ``softmax(scale · q kᵀ + bias [+ causal]) v`` by the online softmax,
   the ``[Tq, Tk]`` scores never in device memory; ``lse = m + log(max(l,
   1e-30))`` per query row.
 - :func:`flash_dq` replaces ``_dq_kernel``: ``P = exp(S − lse)``, ``dS =
   P ∘ (dO Vᵀ − delta)``, ``dQ = scale · dS K``.
 - :func:`flash_dkv` replaces ``_dkv_kernel``: ``dV = Pᵀ dO``, ``dK =
   scale · dSᵀ Q``.
 - :class:`FlashAttention` ties them into a ``torch.autograd.Function``;
   ``delta = rowsum(dO ∘ O)`` is computed in torch between them, as the
   reference leaves it to XLA, and the bias gets a zero gradient.
 - :func:`flash_attention_sharded` is the reference's tp-sharded wrapper
   (``pallas_fused.py:666``) on one rank: the kernels on the rank's heads,
   no exchange.

q, k, v are ``[B, H, T, D]``; the bias is the additive key-padding bias
``[B|1, 1, 1, Tk]`` or ``[B|1, Tk]`` (:func:`bias_supported`); the causal
mask is top-left aligned (query i sees keys j ≤ i) and fills −1e30.

Every wrapper uses its plain version (``*_ref``) only for tensors on the
CPU; for CUDA tensors it launches the kernel (``csrc/flash_attention.cu``;
contiguous, D ∈ {16, 32, 64, 128}) or raises.  q, k, v and dO are all one
dtype of float32, bfloat16 and float16 (the reference's three), the bias
float32 or that dtype, lse and delta float32 (:func:`kernel_dtype`); out,
dq, dk and dv come back in q's dtype.  The plain versions widen every
value to float32 and round each output once, as the kernels do.
``flash_fwd_launches``, ``flash_dq_launches`` and ``flash_dkv_launches``
count kernel launches, so a run can show the main path went through them;
``flash_{fwd,dq,dkv}_launches_by_dtype`` split them by q's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.ring_attention import full_attention
from .fused import _on_cpu

__all__ = ["bias_supported", "kernel_dtype", "flash_forward",
           "flash_forward_ref", "flash_dq", "flash_dq_ref", "flash_dkv",
           "flash_dkv_ref", "flash_backward_ref", "FlashAttention",
           "flash_attention_sharded"]

NEG_INF = -1e30
#: head widths the kernels are built for
HEAD_DIMS = (16, 32, 64, 128)

#: the input dtypes the kernels take, by the suffix of their C entries
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}

#: kernel launches since the last reset (each wrapper adds one per launch),
#: in all and by q's dtype
flash_fwd_launches = 0
flash_dq_launches = 0
flash_dkv_launches = 0
flash_fwd_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
flash_dq_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}
flash_dkv_launches_by_dtype = {"float32": 0, "bfloat16": 0, "float16": 0}

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from . import _build

        lib = _build.load("flash_attention")
        common = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p]
        for sfx in DTYPES.values():
            # the bf16 / f16 entries also take whether the bias is in
            # their dtype
            tail = common if sfx == "f32" else common + [ctypes.c_int]
            for kind, n_ptrs in (("fwd", 6), ("dq", 8), ("dkv", 9)):
                fn = getattr(lib, f"pta_flash_{kind}_{sfx}")
                fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
                fn.restype = ctypes.c_int
        lib.pta_flash_error_string.argtypes = [ctypes.c_int]
        lib.pta_flash_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def bias_supported(bias, b, t_kv) -> bool:
    """Whether the kernels can take this additive bias: key-padding shaped
    ``[B|1, 1, 1, Tk]`` or ``[B|1, Tk]``.  The same predicate gates the
    op's routing (ops/attention_ops.py), so another bias takes the plain
    full attention instead of raising here."""
    if bias is None:
        return True
    if bias.dim() == 4:
        return (bias.shape[1] == 1 and bias.shape[2] == 1
                and bias.shape[0] in (1, b) and bias.shape[3] == t_kv)
    return bias.dim() == 2 and bias.shape[0] in (1, b) \
        and bias.shape[1] == t_kv


def _bias_2d(bias, b, h, t_kv):
    """Normalize a supported bias (see :func:`bias_supported`) to
    ``[B, Tk]``."""
    if bias is None:
        return None
    if not bias_supported(bias, b, t_kv):
        raise ValueError(
            f"flash_attention bias must be key-padding shaped "
            f"[B|1, 1, 1, Tk] or [B|1, Tk]; got {tuple(bias.shape)}")
    if bias.dim() == 4:
        bias = bias.reshape(bias.shape[0], bias.shape[3])
    if bias.shape[0] == 1 and b > 1:
        bias = bias.expand(b, t_kv)
    return bias


def _scale(q, scale):
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def _masked(s, bias2, causal):
    """Add the key bias ``[B, Tk]`` to scores ``[B, H, Tq, Tk]`` and fill
    −1e30 above the causal diagonal."""
    if bias2 is not None:
        s = s + bias2[:, None, None, :].to(torch.float32)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        live = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(live, s, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_forward_ref(q, k, v, bias=None, scale=None, causal=False):
    """The plain version: ``(out [B, H, Tq, D] in q's dtype, lse [B, H, Tq,
    1] float32)`` by the forward kernel's formulas over the whole row: ``S
    = (scale · q) kᵀ + bias``, −1e30 above the causal diagonal, ``m =
    max S``, ``l = max(Σ exp(S − m), 1e-30)``, ``out = exp(S − m) v / l``,
    ``lse = m + log l``."""
    scale = _scale(q, scale)
    bias2 = _bias_2d(bias, q.shape[0], q.shape[1], k.shape[2])
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = _masked(torch.matmul(qf * scale, kf.transpose(-1, -2)), bias2,
                causal)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vf) / l
    return out.to(q.dtype), m + torch.log(l)


def _probs(q, k, bias2, lse, scale, causal):
    """``P = exp(scale · q kᵀ + bias − lse)`` in float32, as the backward
    kernels recompute it."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    return torch.exp(_masked(s, bias2, causal) - lse)


def flash_dq_ref(q, k, v, bias, do, lse, delta, scale=None, causal=False):
    """The plain version of the dQ kernel: ``scale · (P ∘ (dO vᵀ − delta))
    k`` with ``P`` recomputed from ``lse``."""
    scale = _scale(q, scale)
    bias2 = _bias_2d(bias, q.shape[0], q.shape[1], k.shape[2])
    p = _probs(q, k, bias2, lse, scale, causal)
    dp = torch.matmul(do.to(torch.float32),
                      v.to(torch.float32).transpose(-1, -2))
    ds = p * (dp - delta)
    return (scale * torch.matmul(ds, k.to(torch.float32))).to(q.dtype)


def flash_dkv_ref(q, k, v, bias, do, lse, delta, scale=None, causal=False):
    """The plain version of the dK/dV kernel: ``(scale · dSᵀ q, Pᵀ dO)``."""
    scale = _scale(q, scale)
    bias2 = _bias_2d(bias, q.shape[0], q.shape[1], k.shape[2])
    p = _probs(q, k, bias2, lse, scale, causal)
    dof = do.to(torch.float32)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, v.to(torch.float32).transpose(-1, -2))
              - delta)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do):
    """``rowsum(dO ∘ O)`` in float32, ``[B, H, Tq, 1]`` (the reference's
    ``_flash_backward`` :307)."""
    return (do.to(torch.float32) * out.to(torch.float32)).sum(
        dim=-1, keepdim=True)


def flash_backward_ref(q, k, v, bias, out, lse, do, scale=None,
                       causal=False):
    """The plain version of the backward: ``(dq, dk, dv)`` by the dQ and
    dK/dV kernels' formulas from the forward's ``out`` and ``lse``, with
    ``delta = rowsum(dO ∘ O)``."""
    delta = _delta(out, do)
    dq = flash_dq_ref(q, k, v, bias, do, lse, delta, scale, causal)
    dk, dv = flash_dkv_ref(q, k, v, bias, do, lse, delta, scale, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention takes q [B, H, Tq, D] and k, v "
                         f"[B, H, Tk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def kernel_dtype(q, k, v, bias=None, do=None, lse=None, delta=None):
    """The dtype of the kernels' entry for these inputs: q, k, v and dO one
    dtype of :data:`DTYPES`, the bias float32 or that dtype, lse and delta
    float32.  Raises ``TypeError`` for anything else (a mix included)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"the flash kernels take q, k, v in "
                        f"{list(DTYPES)}; got {q.dtype}")
    for name, t, allowed in (("k", k, (q.dtype,)), ("v", v, (q.dtype,)),
                             ("dO", do, (q.dtype,)),
                             ("bias", bias, (torch.float32, q.dtype)),
                             ("lse", lse, (torch.float32,)),
                             ("delta", delta, (torch.float32,))):
        if t is not None and t.dtype not in allowed:
            raise TypeError(f"{name} must be one of {list(allowed)} for the "
                            f"flash kernels with q in {q.dtype}; got "
                            f"{t.dtype}")
    return q.dtype


def _check_kernel(named, d):
    """What the kernels take besides the dtypes: contiguous, 16-byte
    aligned, D one of :data:`HEAD_DIMS`."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head widths "
                         f"{HEAD_DIMS}; got D = {d}")
    for name, t in named:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _rows(t, b, h, t_q, name):
    if t.numel() != b * h * t_q:
        raise ValueError(f"{name} must hold one value per query row "
                         f"[B, H, Tq, 1]; got {tuple(t.shape)}")


def _launch(kind, what, q, bias2, *pointers_and_dims):
    """Launch the ``kind`` entry for q's dtype; the bf16 / f16 entries also
    take whether the bias is in that dtype."""
    lib = _lib()
    sfx = DTYPES[q.dtype]
    args = list(pointers_and_dims)
    if sfx != "f32":
        args.append(int(bias2 is not None and bias2.dtype == q.dtype))
    rc = getattr(lib, f"pta_flash_{kind}_{sfx}")(*args)
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"{lib.pta_flash_error_string(rc).decode()} "
                           f"(error {rc})")


def _dims(q, k, scale, causal):
    b, h, t_q, d = q.shape
    return [b, h, t_q, k.shape[2], d, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream]


def _count(by_dtype, q):
    by_dtype[str(q.dtype)[6:]] += 1


def flash_forward(q, k, v, bias=None, scale=None, causal=False):
    """``(out [B, H, Tq, D], lse [B, H, Tq, 1] float32)`` of
    ``softmax(scale · q kᵀ + bias [+ causal]) v``; ``scale`` defaults to
    ``1/√D``."""
    global flash_fwd_launches
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v, bias):
        return flash_forward_ref(q, k, v, bias, scale, causal)
    b, h, t_q, d = q.shape
    bias2 = _bias_2d(bias, b, h, k.shape[2])
    bias2 = None if bias2 is None else bias2.contiguous()
    kernel_dtype(q, k, v, bias2)
    _check_kernel((("q", q), ("k", k), ("v", v), ("bias", bias2)), d)
    scale = _scale(q, scale)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t_q, 1, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("fwd", "forward", q, bias2, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if bias2 is None else bias2.data_ptr(),
                out.data_ptr(), lse.data_ptr(), *_dims(q, k, scale, causal))
    flash_fwd_launches += 1
    _count(flash_fwd_launches_by_dtype, q)
    return out, lse


def _bwd_inputs(q, k, v, bias, do, lse, delta):
    b, h, t_q, d = q.shape
    bias2 = _bias_2d(bias, b, h, k.shape[2])
    bias2 = None if bias2 is None else bias2.contiguous()
    if do.shape != q.shape:
        raise ValueError(f"dO must be shaped like q {tuple(q.shape)}; got "
                         f"{tuple(do.shape)}")
    _rows(lse, b, h, t_q, "lse")
    _rows(delta, b, h, t_q, "delta")
    kernel_dtype(q, k, v, bias2, do, lse, delta)
    _check_kernel((("q", q), ("k", k), ("v", v), ("bias", bias2),
                   ("dO", do), ("lse", lse), ("delta", delta)), d)
    return bias2


def flash_dq(q, k, v, bias, do, lse, delta, scale=None, causal=False):
    """``dq [B, H, Tq, D]`` from the forward's ``lse`` and ``delta =
    rowsum(dO ∘ O)`` (both ``[B, H, Tq, 1]`` float32)."""
    global flash_dq_launches
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v, bias, do, lse, delta):
        return flash_dq_ref(q, k, v, bias, do, lse, delta, scale, causal)
    scale = _scale(q, scale)
    bias2 = _bwd_inputs(q, k, v, bias, do, lse, delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("dq", "dQ", q, bias2, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if bias2 is None else bias2.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), *_dims(q, k, scale, causal))
    flash_dq_launches += 1
    _count(flash_dq_launches_by_dtype, q)
    return dq


def flash_dkv(q, k, v, bias, do, lse, delta, scale=None, causal=False):
    """``(dk, dv)``, each ``[B, H, Tk, D]``, from the forward's ``lse`` and
    ``delta = rowsum(dO ∘ O)``."""
    global flash_dkv_launches
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v, bias, do, lse, delta):
        return flash_dkv_ref(q, k, v, bias, do, lse, delta, scale, causal)
    scale = _scale(q, scale)
    bias2 = _bwd_inputs(q, k, v, bias, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("dkv", "dK/dV", q, bias2, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if bias2 is None else bias2.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), *_dims(q, k, scale, causal))
    flash_dkv_launches += 1
    _count(flash_dkv_launches_by_dtype, q)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, bias, scale, causal)`` -> ``out`` of
    :func:`flash_forward`, differentiable in q, k, v through
    :func:`flash_dq` and :func:`flash_dkv`; the bias gets a zero gradient
    (it is derived from input padding, never trained), as in the
    reference's ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        delta = _delta(out, do)
        dq = flash_dq(q, k, v, bias, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, bias, do, lse, delta, ctx.scale,
                           ctx.causal)
        dbias = None if bias is None else torch.zeros_like(bias)
        return dq, dk, dv, dbias, None, None


def flash_attention_sharded(q, k, v, bias=None, scale=None, causal=False,
                            flash=True):
    """Attention on one rank of a tp group that holds the heads ``q, k, v
    [B, H / tp, T, D]`` (its contiguous slice, in rank order) and the
    whole key-padding bias of its rows (``[B|1, 1, 1, Tk]``, sharded with
    the batch over dp as the rows are): the reference's
    ``flash_attention_sharded`` (``pallas_fused.py:666``).  Attention is
    head-independent, so each rank runs :class:`FlashAttention` on its
    heads and nothing is exchanged.  With ``flash`` off, or a bias the
    kernels do not take, the plain full attention on the same heads, as
    the single-device op does."""
    if flash and bias_supported(bias, q.shape[0], k.shape[2]):
        return FlashAttention.apply(q, k, v, bias, scale, causal)
    return full_attention(q, k, v, causal, scale, bias=bias)
