"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``paddle_tpu/ops/pallas_paged.py:_paged_kernel``
(reached through ``paged_attention`` there).  The kernel,
``csrc/paged_attention.cu``, computes one decode row per slot,
``softmax(scale · q Kᵀ + bias) V`` with K/V gathered page by page through
the slot's page-table row, with the exact full-row softmax the reference
runs (max, exp, divide), not the online recurrence.

What bounds it on the card: bytes.  Each live key position reads one K and
one V row of ``d`` floats for 4·d flops, 0.5 flop per byte against the
H100's ~20 fp32 flops per byte, so the least time is the K/V pages the
slots reference over the memory rate.  The design keeps the whole score
row in shared memory and streams V in a second pass (the TPU kernel's
gathered fp32 V scratch, 1 MiB at L = D = 512, does not fit in a block's
227 KB); one block per slot, reductions in a fixed order and no atomics, so
a slot's output repeats bitwise whatever the other slots hold.  At 8 slots
only 8 SMs work: splitting a slot over several blocks is later work.

:func:`paged_attention` launches the kernel for CUDA tensors and uses
:func:`paged_attention_ref` only for tensors on the CPU.  ``launches``
counts kernel launches, so a run can show the main path went through it.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["paged_attention", "paged_attention_ref", "launches"]

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_fn = None


def paged_attention_ref(q, cache_k, cache_v, page_table, bias, scale=1.0):
    """The plain PyTorch version: gather the pages, matmul, softmax, matmul
    (the reference's unfused lowering, ``paddle_tpu/ops/decode_ops.py``)."""
    qs = q if scale == 1.0 else q * scale
    pt = page_table.long()
    s_n, n_pages = pt.shape
    ps, d = cache_k.shape[1], cache_k.shape[2]
    gk = cache_k[pt].reshape(s_n, n_pages * ps, d)
    gv = cache_v[pt].reshape(s_n, n_pages * ps, cache_v.shape[2])
    scores = torch.matmul(qs, gk.transpose(-1, -2)) + bias
    return torch.matmul(torch.softmax(scores, dim=-1), gv)


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        lib = _build.load("paged_attention")
        fn = lib.pta_paged_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pta_paged_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.pta_paged_attention_smem.restype = ctypes.c_longlong
        lib.pta_error_string.argtypes = [ctypes.c_int]
        lib.pta_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.pta_paged_attention_smem, lib.pta_error_string)
    return _fn


def _check(q, cache_k, cache_v, page_table, bias):
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError(f"paged_attention kernel takes one query row per "
                         f"slot, q [S, 1, D]; got {tuple(q.shape)}")
    s_n, _, d = q.shape
    if cache_k.dim() != 3 or cache_k.shape != cache_v.shape \
            or cache_k.shape[2] != d:
        raise ValueError(f"caches must both be [P + 1, ps, {d}]; got "
                         f"{tuple(cache_k.shape)} and {tuple(cache_v.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != s_n:
        raise ValueError(f"page_table must be [{s_n}, n_pages]; got "
                         f"{tuple(page_table.shape)}")
    ell = page_table.shape[1] * cache_k.shape[1]
    if tuple(bias.shape) != (s_n, 1, ell):
        raise ValueError(f"bias must be [S, 1, n_pages * page_size] = "
                         f"[{s_n}, 1, {ell}]; got {tuple(bias.shape)}")
    if d % 4:
        raise ValueError(f"the kernel loads float4s: d_model ({d}) must be "
                         f"a multiple of 4")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"paged_attention kernel is float32 only; "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if page_table.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"page_table must be int32 or int64; got "
                        f"{page_table.dtype}")


def paged_attention(q, cache_k, cache_v, page_table, bias, scale=1.0):
    """``softmax(scale · q Kᵀ + bias) V`` with K/V gathered through
    ``page_table`` from a paged cache.

    q: ``[S, 1, D]``; cache_k/cache_v: ``[P + 1, ps, D]`` (row P is the trash
    page); page_table: ``[S, n_pages]`` int; bias: ``[S, 1, n_pages · ps]``
    with exact ``-inf`` beyond each slot's live length.  Returns ``[S, 1, D]``
    in q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (float32, contiguous) or raise."""
    global launches
    tensors = (q, cache_k, cache_v, page_table, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, cache_k, cache_v, page_table, bias,
                                   scale)
    if not all(t.device == q.device for t in tensors) \
            or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must lie on one CUDA "
                         "device (or all on the CPU); got "
                         f"{[str(t.device) for t in tensors]}")
    _check(q, cache_k, cache_v, page_table, bias)
    fn, smem_bytes, err_str = _kernel()
    s_n, _, d = q.shape
    n_pages, ps = page_table.shape[1], cache_k.shape[1]
    pt32 = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                pt32.data_ptr(), bias.data_ptr(), out.data_ptr(), s_n, d,
                n_pages, ps, cache_k.shape[0], float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: {err_str(rc).decode()} "
            f"(cudaError {rc}; the launch keeps the score row in "
            f"{smem_bytes(d, n_pages, ps)} bytes of shared memory)")
    launches += 1
    return out
