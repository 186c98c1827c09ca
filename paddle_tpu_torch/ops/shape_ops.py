"""Shape ops (counterpart of ``paddle_tpu/ops/shape_ops.py``): reshape,
transpose (and their ``2`` forms with the ``XShape`` output, a
zero-size tensor of shape ``(0,) + X.shape``), concat, split, slice,
gather, one_hot, flatten, squeeze, unsqueeze, stack, unstack, expand,
expand_as, tile, scatter, the pads, crop, reverse, shape, multiplex,
where (a three-way select) and the two image resizes.

The resizes follow ``jax.image.resize``: half-pixel centres, and a
bilinear shrink averages over the wider triangle (``antialias=True``);
nearest picks ``floor((i + 0.5) * in / out)`` (``"nearest-exact"``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


def _infer_reshape(shape_attr, x):
    """Fluid reshape: 0 keeps the input dim, one -1 is inferred."""
    shape = list(shape_attr)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = x.numel() // known
    return shape


@register_op("reshape")
def reshape(ctx):
    x = ctx.input("X")
    return {"Out": x.reshape(_infer_reshape(ctx.attr("shape"), x))}


def _xshape(x):
    """The ``XShape`` output: no values, the input's shape behind a 0."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2")
def reshape2(ctx):
    x = ctx.input("X")
    return {"Out": x.reshape(_infer_reshape(ctx.attr("shape"), x)),
            "XShape": _xshape(x)}


@register_op("flatten")
def flatten(ctx):
    """To 2-D: the dims before ``axis`` make the rows (1 row at axis 0)."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    lead = 1
    for d in x.shape[:axis]:
        lead *= int(d)
    return {"Out": x.reshape(lead, -1)}


@register_op("transpose")
def transpose(ctx):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("transpose2")
def transpose2(ctx):
    x = ctx.input("X")
    return {"Out": x.permute(*ctx.attr("axis")), "XShape": _xshape(x)}


@register_op("concat")
def concat(ctx):
    return {"Out": torch.cat(ctx.inputs_list("X"), dim=ctx.attr("axis", 0))}


@register_op("one_hot", no_grad_inputs=("X",))
def one_hot(ctx):
    """float32 one-hot over ``depth`` classes; an id outside ``[0, depth)``
    gives a zero row, as ``jax.nn.one_hot`` does (and no host sync to
    check the ids)."""
    x = ctx.input("X").long()
    depth = int(ctx.attr("depth"))
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    valid = ((x >= 0) & (x < depth)).to(torch.float32)[..., None]
    out = torch.zeros(tuple(x.shape) + (depth,), dtype=torch.float32,
                      device=x.device)
    return {"Out": out.scatter_(-1, x.clamp(0, depth - 1)[..., None], valid)}


@register_op("split")
def split(ctx):
    """Into ``sections`` along ``axis``, or ``num`` equal parts."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", None)
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    return {"Out": list(torch.chunk(x, ctx.attr("num"), dim=axis))}


def _clamp_bound(v, dim):
    """A slice bound as the reference takes it: a negative one counts from
    the end (and stops at 0), a positive one stops at the dim."""
    return max(v + dim, 0) if v < 0 else min(v, dim)


@register_op("slice")
def slice_op(ctx):
    """``Input[starts:ends]`` along ``axes``; a start past its end gives an
    empty dim."""
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        dim = x.shape[a]
        idx[a] = slice(_clamp_bound(s, dim), _clamp_bound(e, dim))
    return {"Out": x[tuple(idx)]}


@register_op("gather", no_grad_inputs=("Index",))
def gather(ctx):
    """Rows ``Index`` (flattened) of ``X`` along dim 0, in X's dtype.  Its
    grad (the generic one) scatter-adds into those rows: on CUDA with
    atomics, so a repeated index sums in no fixed order."""
    x = ctx.input("X")
    return {"Out": x.index_select(0, ctx.input("Index").reshape(-1).long())}


@register_op("squeeze")
def squeeze(ctx):
    """Drops the size-1 dims among ``axes`` (a listed dim of another size
    stays), or every size-1 dim when ``axes`` is empty."""
    x = ctx.input("X")
    axes = ctx.attr("axes", None)
    if not axes:
        return {"Out": torch.squeeze(x)}
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return {"Out": torch.squeeze(x, axes) if axes else x}


@register_op("unsqueeze")
def unsqueeze(ctx):
    x = ctx.input("X")
    for a in sorted(ctx.attr("axes")):
        x = x.unsqueeze(a)
    return {"Out": x}


@register_op("stack")
def stack(ctx):
    return {"Y": torch.stack(ctx.inputs_list("X"), dim=ctx.attr("axis", 0))}


@register_op("unstack")
def unstack(ctx):
    return {"Y": list(torch.unbind(ctx.input("X"),
                                   dim=ctx.attr("axis", 0)))}


@register_op("expand")
def expand(ctx):
    """``X`` tiled ``expand_times`` along each dim (``jnp.tile``)."""
    return {"Out": torch.tile(ctx.input("X"), tuple(ctx.attr("expand_times")))}


@register_op("expand_as")
def expand_as(ctx):
    """``X`` tiled to the shape of ``target_tensor`` (or ``Y``)."""
    x = ctx.input("X")
    y = ctx.input("target_tensor")
    if y is None:
        y = ctx.input("Y")
    return {"Out": torch.tile(x, tuple(t // s for t, s in zip(y.shape,
                                                                x.shape)))}


@register_op("tile")
def tile(ctx):
    return {"Out": torch.tile(ctx.input("X"),
                              tuple(ctx.attr("repeat_times")))}


@register_op("scatter", no_grad_inputs=("Ids",))
def scatter(ctx):
    """``X`` with rows ``Ids`` set to (``overwrite``) or added with the rows
    of ``Updates``.  Which of two equal ids wins an overwrite is not
    fixed, in the reference either."""
    x, upd = ctx.input("X"), ctx.input("Updates")
    ids = ctx.input("Ids").reshape(-1).long()
    if ctx.attr("overwrite", True):
        return {"Out": x.index_copy(0, ids, upd.to(x.dtype))}
    return {"Out": x.index_add(0, ids, upd.to(x.dtype))}


def _pad_arg(pairs):
    """``F.pad``'s argument from (before, after) pairs in dim order."""
    out = []
    for before, after in reversed(pairs):
        out += [int(before), int(after)]
    return out


@register_op("pad")
def pad(ctx):
    """Constant ``pad_value`` around every dim, ``paddings`` holding a
    (before, after) pair a dim."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return {"Out": F.pad(x, _pad_arg(pairs),
                         value=float(ctx.attr("pad_value", 0.0)))}


_PAD2D_MODES = {"reflect": "reflect", "edge": "replicate"}


@register_op("pad2d")
def pad2d(ctx):
    """``paddings`` [top, bottom, left, right] around the image dims of an
    NCHW or NHWC input: ``constant`` (``pad_value``), ``reflect`` (the
    edge not repeated) or ``edge`` (the edge repeated)."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    mode = ctx.attr("mode", "constant")
    fmt = ctx.attr("data_format", "NCHW")
    if fmt not in ("NCHW", "NHWC"):
        raise ValueError(f"pad2d: data_format {fmt!r} is not NCHW or NHWC")
    nhwc = fmt == "NHWC"
    arg = _pad_arg([(p[0], p[1]), (p[2], p[3])])
    if mode == "constant":
        arg = [0, 0] * nhwc + arg
        return {"Out": F.pad(x, arg, value=float(ctx.attr("pad_value", 0.0)))}
    if mode not in _PAD2D_MODES:
        raise ValueError(f"pad2d: mode {mode!r} is not constant, reflect or "
                         f"edge")
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    out = F.pad(x, arg, mode=_PAD2D_MODES[mode])
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


@register_op("pad_constant_like")
def pad_constant_like(ctx):
    """``Y`` padded at the end of each dim with ``pad_value`` to ``X``'s
    shape."""
    x, y = ctx.input("X"), ctx.input("Y")
    pairs = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    return {"Out": F.pad(y, _pad_arg(pairs),
                         value=float(ctx.attr("pad_value", 0.0)))}


@register_op("crop")
def crop(ctx):
    """The block of ``shape`` at ``offsets``."""
    x = ctx.input("X")
    return {"Out": x[tuple(slice(o, o + s) for o, s in
                           zip(ctx.attr("offsets"), ctx.attr("shape")))]}


@register_op("reverse")
def reverse(ctx):
    return {"Out": torch.flip(ctx.input("X"), tuple(ctx.attr("axis")))}


@register_op("shape", no_grad_inputs=("Input",))
def shape_op(ctx):
    """The input's shape, int32, on its device: written by fills, so a
    CUDA graph can capture it (no host copy)."""
    x = ctx.input("Input")
    out = torch.empty(x.dim(), dtype=torch.int32, device=x.device)
    for i, d in enumerate(x.shape):
        out[i] = d
    return {"Out": out}


@register_op("multiplex", no_grad_inputs=("Ids",))
def multiplex(ctx):
    """Row i from candidate ``Ids[i]`` of the ``X`` list."""
    ids = ctx.input("Ids").reshape(-1).long()
    xs = torch.stack(ctx.inputs_list("X"), dim=0)
    return {"Out": xs[ids, torch.arange(xs.shape[1], device=xs.device)]}


@register_op("where", no_grad_inputs=("Condition",))
def where(ctx):
    """``X`` where ``Condition``, else ``Y``."""
    cond = ctx.input("Condition")
    return {"Out": torch.where(cond.bool(), ctx.input("X"), ctx.input("Y"))}


@register_op("bilinear_interp")
def bilinear_interp(ctx):
    """NCHW to ``out_h`` x ``out_w``: half-pixel bilinear, antialiased when
    it shrinks (``jax.image.resize(..., "bilinear")``)."""
    return {"Out": F.interpolate(
        ctx.input("X"), size=(ctx.attr("out_h"), ctx.attr("out_w")),
        mode="bilinear", align_corners=False, antialias=True)}


@register_op("nearest_interp")
def nearest_interp(ctx):
    """NCHW to ``out_h`` x ``out_w``: the half-pixel nearest source."""
    return {"Out": F.interpolate(
        ctx.input("X"), size=(ctx.attr("out_h"), ctx.attr("out_w")),
        mode="nearest-exact")}
