"""Misc ops (counterpart of ``paddle_tpu/ops/misc_ops.py``), in the
reference's order:

 - the dense stragglers ``minus``, ``cos_sim`` (with ``XNorm`` /
   ``YNorm``; a ``[1, D]`` ``Y`` broadcasts), ``l1_norm``, ``norm``,
   ``bilinear_tensor_product``, ``conv_shift`` (circular correlation),
   ``modified_huber_loss``, ``label_smooth`` and ``fill``, differentiated
   by the generic grad;
 - ``random_crop``: a window of the trailing dims per instance, its
   offsets drawn from the scope's generator (uniform over the valid
   starts);
 - ``flatten2`` / ``squeeze2`` / ``unsqueeze2`` with their ``XShape``;
 - the SelectedRows utilities ``extract_rows``, ``split_ids``,
   ``merge_ids`` and ``split_selected_rows``, on fixed shapes as the
   reference's (a shard's ids packed first, the rest -1);
 - the in-graph checkpoint ops ``save`` / ``load`` / ``save_combine`` /
   ``load_combine`` / ``delete_var``: host ops (``registry.EAGER_OPS``)
   writing the reference's formats (one ``.npy`` a variable, an ``.npz``
   of ``arr_0``, ``arr_1``, ... for a combined file), so either package
   reads what the other wrote; a loaded array lands on the op's device;
 - ``get_places``: the count of the place's devices;
 - ``depthwise_conv2d_transpose``: the transposed convolution whose
   ``groups`` default to the input's channel count, with an explicit
   grad.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .nn_ops import _convolution, _convolution_grad
from .registry import register_grad, register_op
from .shape_ops import _xshape

# ---------------------------------------------------------------------------
# dense stragglers
# ---------------------------------------------------------------------------


@register_op("minus")
def minus(ctx):
    return {"Out": ctx.input("X") - ctx.input("Y")}


@register_op("cos_sim")
def cos_sim(ctx):
    """Cosine of each row of ``X [N, D]`` with ``Y [N or 1, D]``; the
    norms' product is floored at 1e-12."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    out = (x * y).sum(-1, keepdim=True) / torch.clamp_min(xn * yn, 1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("l1_norm")
def l1_norm(ctx):
    return {"Out": ctx.input("X").abs().sum().reshape(1)}


@register_op("norm")
def norm(ctx):
    """``X`` over its L2 norm along ``axis`` (``Norm``, with ``epsilon``
    under the root)."""
    x = ctx.input("X")
    n = torch.sqrt((x * x).sum(ctx.attr("axis", 1), keepdim=True)
                   + ctx.attr("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx):
    """``Out[n, o] = X[n] · Weight[o] · Y[n] (+ Bias[0, o])``."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("nm,omp,np->no", x, w, y)
    bias = ctx.input("Bias")
    return {"Out": out + bias if bias is not None else out}


@register_op("conv_shift")
def conv_shift(ctx):
    """Circular correlation: ``Out[i, j] = sum_k X[i, (j + k − M//2) mod N]
    · Y[i, k]`` for ``X [B, N]``, ``Y [B, M]``."""
    x, y = ctx.input("X"), ctx.input("Y")
    n, m = x.shape[1], y.shape[1]
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(m, device=x.device)[None, :] - m // 2) % n
    return {"Out": torch.einsum("bnm,bm->bn", x[:, idx], y)}


@register_op("modified_huber_loss", no_grad_inputs=("Y",))
def modified_huber_loss(ctx):
    """For a score ``X`` and a 0/1 label ``Y`` (as ±1, z = X·(2Y − 1)):
    −4z below −1, (1 − z)² below 1, else 0; ``IntermediateVal`` is z."""
    x, y = ctx.input("X"), ctx.input("Y")
    z = x * (2.0 * y.to(x.dtype) - 1.0)
    zero = torch.zeros_like(z)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z) ** 2, zero))
    return {"Out": loss, "IntermediateVal": z}


@register_op("label_smooth", no_grad_inputs=("PriorDist",))
def label_smooth(ctx):
    """``(1 − ε) · X + ε · PriorDist``, or ``+ ε / D`` without a prior."""
    x, prior = ctx.input("X"), ctx.input("PriorDist")
    eps = ctx.attr("epsilon", 0.0)
    if prior is not None:
        return {"Out": (1.0 - eps) * x + eps * prior}
    return {"Out": (1.0 - eps) * x + eps / x.shape[-1]}


@register_op("fill")
def fill(ctx):
    """A tensor of ``shape`` and ``dtype`` from the flat list ``value``."""
    from ..fluid import core

    vals = np.array(ctx.attr("value"), core.np_dtype(ctx.attr("dtype", 5)))
    return {"Out": torch.from_numpy(vals.reshape(ctx.attr("shape"))).to(
        ctx.device)}


@register_op("random_crop", stateful=True, no_grad_inputs=("X", "Seed"))
def random_crop(ctx):
    """A window of ``shape`` over the trailing dims of ``X``, its start
    drawn uniformly per instance (dim 0) when ``X`` has a leading dim;
    the leading dims are kept whole.  ``SeedOut`` is int64 zeros ``[1]``
    as in the reference: the stream is the scope's generator."""
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    lead = x.dim() - len(shape)
    gen = ctx.generator
    n = x.shape[0] if lead >= 1 else 1
    out = x if lead >= 1 else x.unsqueeze(0)
    for i, size in enumerate(shape):
        dim = max(lead, 1) + i
        starts = torch.randint(0, out.shape[dim] - size + 1, (n,),
                               device=x.device, generator=gen)
        idx = starts[:, None] + torch.arange(size, device=x.device)
        view = [n] + [1] * (out.dim() - 1)
        view[dim] = size
        sizes = list(out.shape)
        sizes[dim] = size
        out = torch.gather(out, dim, idx.reshape(view).expand(sizes))
    if lead == 0:
        out = out.squeeze(0)
    return {"Out": out,
            "SeedOut": torch.zeros(1, dtype=torch.int64, device=x.device)}


# ---------------------------------------------------------------------------
# shape variants with XShape (the pre-op shape for the grad op)
# ---------------------------------------------------------------------------


@register_op("flatten2")
def flatten2(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return {"Out": x.reshape(lead, -1), "XShape": _xshape(x)}


@register_op("squeeze2")
def squeeze2(ctx):
    x = ctx.input("X")
    axes = [a % x.dim() for a in (ctx.attr("axes", []) or [])]
    shape = [s for i, s in enumerate(x.shape)
             if not (s == 1 and (i in axes or not axes))]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("unsqueeze2")
def unsqueeze2(ctx):
    x = ctx.input("X")
    shape = list(x.shape)
    for a in sorted(ctx.attr("axes", [])):
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


# ---------------------------------------------------------------------------
# SelectedRows utilities (the reference's pserver sharding helpers)
# ---------------------------------------------------------------------------


def _selected_rows(ctx, op):
    from ..fluid.selected_rows import SelectedRows

    x = ctx.input("X")
    if not isinstance(x, SelectedRows):
        raise TypeError(f"{op} expects a SelectedRows input")
    return x


@register_op("extract_rows", no_grad_inputs=("X",))
def extract_rows(ctx):
    """The row ids of a SelectedRows, int64 ``[N, 1]``."""
    x = _selected_rows(ctx, "extract_rows")
    return {"Out": x.rows.reshape(-1, 1).to(torch.int64)}


@register_op("split_ids", no_grad_inputs=("Ids",))
def split_ids(ctx):
    """Round-robin id shards (shard = id % n): each output holds its
    shard's ids first, in order, then -1 for the other ids (fixed
    shapes)."""
    ids = ctx.input("Ids").reshape(-1)
    n = ctx.n_outputs("Out")
    outs = []
    for shard in range(n):
        mask = (ids % n) == shard
        order = torch.argsort((~mask).to(torch.int8), stable=True)
        outs.append(torch.where(mask, ids, torch.full_like(ids, -1))[
            order].reshape(-1, 1))
    return {"Out": outs}


@register_op("merge_ids", no_grad_inputs=("Ids", "Rows", "X"))
def merge_ids(ctx):
    """Per-shard rows ``X`` (of ids ``Rows``) back in the order of
    ``Ids``: each id takes the row of its first occurrence across the
    shards; an id no shard holds gets NaNs (the reference's contract
    violated)."""
    ids = ctx.input("Ids").reshape(-1)
    xs, rows = ctx.inputs_list("X"), ctx.inputs_list("Rows")
    d = xs[0].shape[-1]
    all_rows = torch.cat([r.reshape(-1) for r in rows])
    all_vals = torch.cat([x.reshape(-1, d) for x in xs])
    eq = ids[:, None] == all_rows[None, :]
    out = all_vals[eq.to(torch.int8).argmax(1)]
    nan = torch.full_like(out, float("nan"))
    return {"Out": torch.where(eq.any(1)[:, None], out, nan)}


@register_op("split_selected_rows", no_grad_inputs=("X",))
def split_selected_rows(ctx):
    """A SelectedRows cut by row ranges ``height_sections``: each output
    keeps every entry, rows outside its range as row 0 with zero values,
    rows inside shifted to the range's start."""
    from ..fluid.selected_rows import SelectedRows

    x = _selected_rows(ctx, "split_selected_rows")
    sections = [int(s) for s in ctx.attr("height_sections")]
    bounds = np.cumsum([0] + sections)
    outs = []
    for i, height in enumerate(sections):
        inside = (x.rows >= int(bounds[i])) & (x.rows < int(bounds[i + 1]))
        rows = torch.where(inside, x.rows - int(bounds[i]),
                           torch.zeros_like(x.rows))
        mask = inside.reshape((-1,) + (1,) * (x.values.dim() - 1))
        vals = torch.where(mask, x.values, torch.zeros_like(x.values))
        outs.append(SelectedRows(rows, vals, height))
    return {"Out": outs}


# ---------------------------------------------------------------------------
# in-graph checkpoint ops (host ops: registry.EAGER_OPS)
# ---------------------------------------------------------------------------


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@register_op("save", no_grad_inputs=("X",))
def save_op(ctx):
    """``X`` to ``file_path`` (``.npy`` appended when missing); refuses
    an existing file under ``overwrite=False``."""
    path = ctx.attr("file_path")
    if not path.endswith(".npy"):
        path = path + ".npy"
    if os.path.exists(path) and not ctx.attr("overwrite", True):
        raise IOError(f"save: {path} exists and overwrite=False")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, _host(ctx.input("X")), allow_pickle=False)
    return {}


@register_op("load")
def load_op(ctx):
    """The array at ``file_path`` (or ``file_path.npy``) on the op's
    device."""
    path = ctx.attr("file_path")
    if not path.endswith(".npy") and os.path.exists(path + ".npy"):
        path = path + ".npy"
    return {"Out": torch.from_numpy(np.load(path)).to(ctx.device)}


@register_op("save_combine", no_grad_inputs=("X",))
def save_combine(ctx):
    """Every ``X`` into one ``.npz`` (``arr_0``, ``arr_1``, ... in
    order)."""
    path = ctx.attr("file_path")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, *[_host(v) for v in ctx.inputs_list("X")])
    return {}


@register_op("load_combine")
def load_combine(ctx):
    path = ctx.attr("file_path")
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        return {"Out": [torch.from_numpy(z[k]).to(ctx.device)
                        for k in z.files]}


@register_op("delete_var")
def delete_var(ctx):
    return {}


@register_op("get_places")
def get_places(ctx):
    """``0 .. n − 1`` (int64) for the ``n`` devices of the op's place
    (``device_count`` when set): the cards torch sees on a card, one on
    the CPU."""
    n = ctx.attr("device_count", 0) or (
        torch.cuda.device_count() if ctx.device.type == "cuda" else 1)
    return {"Out": torch.arange(n, dtype=torch.int64, device=ctx.device)}


# ---------------------------------------------------------------------------
# the depthwise transposed convolution
# ---------------------------------------------------------------------------


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ctx):
    return _convolution(ctx, 2, True, depthwise=True)


@register_grad("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose_grad(ctx):
    return _convolution_grad(ctx, 2, True, depthwise=True)
