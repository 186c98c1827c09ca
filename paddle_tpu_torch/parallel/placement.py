"""Placements of a tensor-parallel step: where each value of the Executor's
op loop lives over the tp (or legacy mp) axis, and what each op does to
its inputs first.

The reference annotates the parameters' specs on one traced program and
leaves every activation to GSPMD; the port runs the ops one by one on each
rank, so it decides the placements itself, once, when the step's plan is
built (never from run-time values: every rank must issue the same
collectives in the same order, or gloo waits until its timeout).

Every var of a step has one placement: replicated (``None``: the same
whole value on every tp rank) or sharded on dim *d* (``d``: each rank
holds its contiguous ``1/tp`` slice of that dim, in rank order).  A state
var starts where the spec table (``spmd.infer_param_specs``) puts its tp
axis; a fed var and every other starting value is replicated.  A grad
``X@GRAD`` (and each partial ``X@GRAD@RENAME@...``) has ``X``'s placement.

Each forward op gets a :class:`Rule`: the conversion of each input
(``ops/collectives.py``: ``gather`` along a dim, ``slice`` to a dim,
``copy`` to the axis), the placement of each output, and the conversions
after it (``reduce`` of a row-parallel product's partial sums).  The
rules:

 - ``mul``: a weight sharded on its output dim (column-parallel) takes a
   replicated input, through ``copy`` (the input's cotangent is the sum
   of the ranks' parts), and gives an output sharded on its last dim; a
   weight sharded on its input dim (row-parallel) takes the input sharded
   on that dim (a replicated one is sliced), and the partial products are
   ``reduce``-d to a replicated output.  ``matmul`` keeps a head (batch)
   dim both operands are sharded on;
 - ``lookup_table`` with the table sharded on d_model gives the rows
   sharded on their last dim;
 - the elementwise ops (``elementwise_*``, ``sum``, the activations,
   ``scale``, ``cast``, ...) keep the sharded dim: a replicated operand
   that covers it is sliced, one that broadcasts over it is ``copy``-ed;
 - ``reshape`` / ``transpose`` move the sharded dim: ``[B, T, D]`` sharded
   on D becomes ``[B, T, H, Dh]`` sharded on H (the local shape written
   into the op's ``shape``), and back;
 - ``softmax`` off the sharded dim keeps it;
 - ``ring_attention`` runs on the rank's heads (``flash_attention_
   sharded``), the key-padding bias ``copy``-ed;
 - ``softmax_with_cross_entropy`` on logits sharded over the vocabulary
   runs ``SoftmaxXentSharded`` (one max / sum exchange); a soft label is
   sliced to the rank's vocabulary;
 - the optimizer ops run on the local shards: every operand shaped as
   the parameter takes its placement;
 - **any other op**, and any op that draws random numbers (its draw is
   made on the gathered tensor, so that every tp rank draws the same), has
   its sharded inputs gathered first: its outputs are replicated.

A grad op runs its forward op's rule.  The generic grad re-runs the
forward under autograd, so its conversions' backwards (slice for gather,
gather for slice, all-reduce for copy) put each input's grad in that
input's placement; an op with an explicit grad impl has them applied by
hand (:meth:`Placement.run`).  An op with a sub-block, and a sparse
(``is_sparse``) table sharded over tp, raise when the plan is built.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..ops import collectives
from ..ops import registry as _reg

GRAD = _reg.GRAD_SUFFIX

# shape-preserving ops of one input ``X`` whose every output has its shape
_UNARY = frozenset([
    "relu", "scale", "cast", "sigmoid", "tanh", "gelu", "exp", "log",
    "sqrt", "rsqrt", "square", "abs", "leaky_relu", "elu", "relu6",
    "softplus", "softsign", "swish", "hard_sigmoid", "hard_swish", "brelu",
    "pow", "clip", "assign", "logsigmoid", "silu", "sin", "cos", "floor",
    "ceil", "round", "reciprocal", "stanh", "thresholded_relu",
    "soft_relu", "tanh_shrink", "hard_shrink", "softshrink", "sign",
    "negative"])
_ELEMENTWISE = frozenset([
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"])
_RESHAPE = frozenset(["reshape", "reshape2"])
_TRANSPOSE = frozenset(["transpose", "transpose2"])

SPARSE_LATER = ("a sparse (is_sparse) table's grad under a tp or fsdp "
                "layout comes with ROADMAP.md queue 1 item 12b, step 2 "
                "(the sparse-grad all-reduce)")


class Rule:
    """What a tensor-parallel step does around one op: ``ins``
    ``{(slot, i): (kind, dim)}`` with kind ``gather`` / ``slice`` /
    ``copy``; ``outs`` ``{(slot, i): placement}``; ``post`` ``{(slot,
    i): [(kind, dim), ...]}`` after it (``reduce``, ``gather``,
    ``slice``); ``attrs``: attrs to replace (a reshape's local shape);
    ``native``: the op's impl takes its shards as they are (it reads the
    group from ``collectives.shard_group``)."""

    __slots__ = ("ins", "outs", "post", "attrs", "native")

    def __init__(self):
        self.ins: Dict[Tuple[str, int], Tuple[str, int]] = {}
        self.outs: Dict[Tuple[str, int], Optional[int]] = {}
        self.post: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
        self.attrs: Dict[str, object] = {}
        self.native = False

    @property
    def trivial(self) -> bool:
        """Nothing to do around the op: it runs as it is."""
        return not (self.ins or self.post or self.attrs or self.native)


def _convert(t, kind, dim, group):
    if not isinstance(t, torch.Tensor):
        return t
    if kind == "gather":
        return collectives.gather_along_dim(t, dim, group)
    if kind == "slice":
        return collectives.slice_along_dim(t, dim, group)
    if kind == "copy":
        return collectives.copy_to_axis(t, group)
    if kind == "reduce":
        return collectives.reduce_from_axis(t, group)
    raise ValueError(kind)


def _adjoint(t, kind, dim, group):
    """The backward of ``kind`` applied to a cotangent ``t`` (an explicit
    grad impl's output)."""
    if not isinstance(t, torch.Tensor):
        return t
    if kind == "gather":
        return collectives.slice_dim(t, dim, group)
    if kind == "slice":
        return collectives.gather_dim(t.contiguous(), dim, group)
    if kind == "copy":
        return group.all_reduce_(t.contiguous().clone())
    raise ValueError(kind)


def _plain(t, kind, dim, group):
    """``kind`` with no autograd (an explicit grad impl's inputs)."""
    if not isinstance(t, torch.Tensor):
        return t
    if kind == "gather":
        return collectives.gather_dim(t, dim, group)
    if kind == "slice":
        return collectives.slice_dim(t, dim, group)
    return t


class Placement:
    """The placements and rules of one step's plan over the tp group
    ``group`` (``tp`` ranks), from the spec table ``specs`` and the axis
    name ``tp_axis``.  ``place``: the placement of each name after the
    op that writes it last; ``rules[k]``: op ``k``'s rule (None: it runs
    as it is)."""

    def __init__(self, program, plan, specs, tp_axis: str, group):
        self.group = group
        self.tp = group.world
        self.tp_axis = tp_axis
        self.block = program.global_block()
        self.storage: Dict[str, int] = {}
        for name, spec in specs.items():
            for d, ax in enumerate(spec or ()):
                if ax == tp_axis:
                    self.storage[name] = d
        self.place: Dict[str, Optional[int]] = dict(self.storage)
        self.rules: List[Optional[Rule]] = []
        self._fwd: Dict[int, Rule] = {}
        self._planned: list = []
        for op in plan.ops:
            self.rules.append(self._plan_op(op))
        self._wrapped: Dict[int, object] = {}

    # -- shapes --
    def _shape(self, name):
        if not name or not self.block._has_var_recursive(name):
            return None
        shape = self.block._var_recursive(name).shape
        return None if shape is None else tuple(shape)

    def _ndim(self, name):
        shape = self._shape(name)
        return None if shape is None else len(shape)

    def _p(self, name):
        return self.place.get(name) if name else None

    # -- planning --
    def _plan_op(self, op) -> Optional[Rule]:
        base, is_grad = (op.type[:-5], True) if op.type.endswith("_grad") \
            else (op.type, False)
        if is_grad:
            return self._plan_grad(op)
        ins = [(slot, i, n) for slot, names in op.inputs.items()
               for i, n in enumerate(names) if n]
        sharded = [(slot, i, n) for slot, i, n in ins
                   if self._p(n) is not None]
        if op.attr("sub_block") is not None and sharded:
            raise NotImplementedError(
                f"op {op.type!r} runs a sub-block over the tp-sharded "
                f"{sharded[0][2]!r}; control flow under a tp mesh comes "
                f"with a later part of ROADMAP.md queue 1 item 12b")
        if base == "lookup_table" and op.attr("is_sparse") and any(
                self._p(n) is not None for n in op.inputs.get("W", [])):
            raise NotImplementedError(
                f"lookup_table {op.inputs['W'][0]!r} (is_sparse=True): "
                f"{SPARSE_LATER}")
        rule = Rule()
        if not sharded and not self._optimizer(op):
            self._set_outputs(op, rule, None)
        else:
            from ..fluid.executor import _draws_random

            done = False
            if not _draws_random(op):
                fn = _RULES.get(base)
                if self._optimizer(op):
                    fn = Placement._rule_optimizer
                done = fn is not None and fn(self, op, rule) is not False
            if not done:
                rule = Rule()
                self._rule_gather_all(op, rule)
        self._fit_storage(op, rule)
        self._fwd[id(op)] = rule
        self._planned.append(op)
        return None if rule.trivial else rule

    def _optimizer(self, op) -> bool:
        from ..fluid.framework import OpRole

        return "Param" in op.inputs and \
            op.attr(OpRole.KEY) == OpRole.Optimize

    def _set_outputs(self, op, rule, placement):
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    rule.outs[(slot, i)] = placement
                    self.place[n] = placement

    def _fit_storage(self, op, rule):
        """An output that is a state var stored sharded (or replicated)
        gets converted to its stored placement after the op."""
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if not n or not self._stored(n):
                    continue
                want = self.storage.get(n)
                have = rule.outs.get((slot, i))
                if have == want:
                    continue
                steps = []
                if have is not None:
                    steps.append(("gather", have))
                if want is not None:
                    steps.append(("slice", want))
                rule.post.setdefault((slot, i), []).extend(steps)
                rule.outs[(slot, i)] = want
                self.place[n] = want

    def _stored(self, name) -> bool:
        return self.block._has_var_recursive(name) and \
            self.block._var_recursive(name).persistable

    def _forward_of(self, op):
        """The planned forward op of grad op ``op``: the one its
        ``__fwd_op_idx__`` names, else (a pruned program's ops moved) the
        latest planned op of its type whose every input the grad op reads
        under the same slot."""
        idx = op.attr("__fwd_op_idx__")
        ops = op.block.ops
        fop = ops[idx] if idx is not None and idx < len(ops) else None
        if fop is not None and fop.type + "_grad" == op.type \
                and id(fop) in self._fwd:
            return fop
        base = op.type[:-5]
        for cand in reversed(self._planned):
            if cand.type == base and all(
                    op.inputs.get(slot) == names
                    for slot, names in cand.inputs.items()):
                return cand
        return None

    def _plan_grad(self, op) -> Optional[Rule]:
        fop = self._forward_of(op)
        if fop is None:
            if any(self._p(n) is not None for n in op.input_arg_names):
                raise NotImplementedError(
                    f"grad op {op.type!r} reads a tp-sharded value and its "
                    f"forward op is not in the step")
            fop, rule = None, Rule()
        else:
            rule = self._fwd[id(fop)]
        for slot, names in op.outputs.items():
            if not slot.endswith(GRAD):
                continue
            fwd_names = fop.inputs.get(slot[:-len(GRAD)], []) if fop else []
            for i, n in enumerate(names):
                if n:
                    self.place[n] = self._p(fwd_names[i]) \
                        if i < len(fwd_names) else None
        return None if rule.trivial else rule

    # -- the rules (each returns False to fall back to gathering) --
    def _rule_gather_all(self, op, rule):
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                d = self._p(n)
                if d is not None:
                    rule.ins[(slot, i)] = ("gather", d)
        self._set_outputs(op, rule, None)

    def _rule_unary(self, op, rule):
        xs = op.inputs.get("X", [])
        if set(op.inputs) != {"X"} or len(xs) != 1:
            return False
        d = self._p(xs[0])
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    keep = self._ndim(n) == self._ndim(xs[0])
                    rule.outs[(slot, i)] = d if keep else None
                    self.place[n] = d if keep else None
        return True

    def _rule_sum(self, op, rule):
        xs = op.inputs.get("X", [])
        ds = {self._p(n) for n in xs if n} - {None}
        nds = {self._ndim(n) for n in xs if n}
        if len(nds) != 1 or len(ds) != 1:
            return False
        d = next(iter(ds))
        for i, n in enumerate(xs):
            if n and self._p(n) is None:
                rule.ins[("X", i)] = ("slice", d)
        self._set_outputs(op, rule, d)
        return True

    def _rule_elementwise(self, op, rule):
        x = op.inputs.get("X", [None])[0]
        y = op.inputs.get("Y", [None])[0]
        xs, ys = self._shape(x), self._shape(y)
        if xs is None or ys is None or len(xs) < len(ys):
            return False
        axis = op.attr("axis")
        axis = len(xs) - len(ys) if axis is None or axis == -1 else axis
        px, py = self._p(x), self._p(y)
        d = px if px is not None else py + axis
        if not 0 <= d < len(xs):
            return False
        if px is None:
            if xs[d] == 1:
                return False
            rule.ins[("X", 0)] = ("slice", d)
        j = d - axis
        covers = 0 <= j < len(ys) and ys[j] != 1
        if covers:
            if py is None:
                rule.ins[("Y", 0)] = ("slice", j)
            elif py != j:
                return False
        elif py is None:
            rule.ins[("Y", 0)] = ("copy", 0)
        else:
            return False
        self._set_outputs(op, rule, d)
        return True

    def _rule_mul(self, op, rule):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        xs, ys = self._shape(x), self._shape(y)
        xnc = op.attr("x_num_col_dims") or 1
        ync = op.attr("y_num_col_dims") or 1
        if xs is None or ys is None or len(ys) != 2 or ync != 1:
            return False
        px, py = self._p(x), self._p(y)
        if py == 1:                          # column-parallel
            # a sharded input is gathered first: whole on every rank, its
            # grad is the slice of the ranks' summed parts
            rule.ins[("X", 0)] = ("copy", 0) if px is None \
                else ("gather_copy", px)
            self._set_outputs(op, rule, xnc)
            return True
        if py == 0:                          # row-parallel
            if len(xs) != xnc + 1:
                return False
            if px is None:
                rule.ins[("X", 0)] = ("slice", xnc)
            elif px != xnc:
                return False
            rule.post[("Out", 0)] = [("reduce", 0)]
            self._set_outputs(op, rule, None)
            return True
        # a replicated weight
        if px is not None and px < xnc:
            rule.ins[("Y", 0)] = ("copy", 0)
            self._set_outputs(op, rule, px)
            return True
        if px is not None and len(xs) == xnc + 1 and px == xnc:
            rule.ins[("Y", 0)] = ("slice", 0)
            rule.post[("Out", 0)] = [("reduce", 0)]
            self._set_outputs(op, rule, None)
            return True
        return False

    def _rule_matmul(self, op, rule):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        xs, ys = self._shape(x), self._shape(y)
        if xs is None or ys is None or len(xs) != len(ys) or len(xs) < 3:
            return False
        px, py = self._p(x), self._p(y)
        d = px if px is not None else py
        if d >= len(xs) - 2 or (px is not None and py is not None
                                and px != py):
            return False
        for slot, p, shape in (("X", px, xs), ("Y", py, ys)):
            if p is None:
                # an operand broadcast over the head dim meets every shard
                rule.ins[(slot, 0)] = ("copy", 0) if shape[d] == 1 \
                    else ("slice", d)
        self._set_outputs(op, rule, d)
        return True

    def _rule_lookup(self, op, rule):
        w = op.inputs["W"][0]
        ids = op.inputs["Ids"][0]
        if self._p(w) != 1 or self._p(ids) is not None:
            return False
        out = op.outputs["Out"][0]
        self._set_outputs(op, rule, self._ndim(out) - 1)
        return True

    def _rule_transpose(self, op, rule):
        x = op.inputs["X"][0]
        perm = list(op.attr("axis") or [])
        d = self._p(x)
        if d not in perm:
            return False
        e = perm.index(d)
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    rule.outs[(slot, i)] = e if slot == "Out" else None
                    self.place[n] = e if slot == "Out" else None
        return True

    def _rule_reshape(self, op, rule):
        if set(op.inputs) - {"X"}:
            return False
        x = op.inputs["X"][0]
        xs = self._shape(x)
        target = list(op.attr("shape") or [])
        d = self._p(x)
        if xs is None or not target:
            return False
        mapped = _reshape_map(list(xs), target, d, self.tp)
        if mapped is None:
            return False
        e, local = mapped
        rule.attrs["shape"] = local
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    rule.outs[(slot, i)] = e if slot == "Out" else None
                    self.place[n] = e if slot == "Out" else None
        return True

    def _rule_softmax(self, op, rule):
        x = op.inputs["X"][0]
        nd = self._ndim(x)
        axis = op.attr("axis")
        axis = -1 if axis is None else axis
        d = self._p(x)
        if nd is None or axis % nd == d:
            return False
        self._set_outputs(op, rule, d)
        return True

    def _rule_attention(self, op, rule):
        q = op.inputs["Q"][0]
        qs = self._shape(q)
        if qs is None or len(qs) != 4 or qs[1] % self.tp:
            return False
        for slot in ("Q", "K", "V"):
            d = self._p(op.inputs[slot][0])
            if d is None:
                rule.ins[(slot, 0)] = ("slice", 1)
            elif d != 1:
                return False
        bias = (op.inputs.get("Bias") or [None])[0]
        if bias:
            bs, bd = self._shape(bias), self._p(bias)
            if bs is None or len(bs) != 4 or bd is not None:
                return False
            rule.ins[("Bias", 0)] = ("copy", 0) if bs[1] == 1 \
                else ("slice", 1)
        rule.native = True
        self._set_outputs(op, rule, 1)
        return True

    def _rule_xent(self, op, rule):
        logits = op.inputs["Logits"][0]
        label = op.inputs["Label"][0]
        nd = self._ndim(logits)
        if nd is None or self._p(logits) != nd - 1:
            return False
        if op.attr("soft_label"):
            pl = self._p(label)
            if pl is None:
                rule.ins[("Label", 0)] = ("slice", nd - 1)
            elif pl != nd - 1:
                return False
        elif self._p(label) is not None:
            return False
        rule.native = True
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    p = nd - 1 if slot == "Softmax" else None
                    rule.outs[(slot, i)] = p
                    self.place[n] = p
        return True

    def _rule_optimizer(self, op, rule):
        pname = op.inputs["Param"][0]
        pshape = self._shape(pname)
        want = self._p(pname)
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                if not n or self._shape(n) != pshape or slot == "Param":
                    continue
                have = self._p(n)
                if have == want:
                    continue
                if have is not None and want is not None:
                    return False
                rule.ins[(slot, i)] = ("gather", have) if have is not None \
                    else ("slice", want)
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                if n:
                    p = want if self._shape(n) == pshape else None
                    rule.outs[(slot, i)] = p
                    self.place[n] = p
        return True

    # -- running --
    def wrap(self, opdef, rule: Rule):
        """``opdef`` with its forward impl run under ``rule``."""
        group = self.group
        fn = opdef.fn

        def placed(ctx):
            inputs = dict(ctx.inputs)
            for (slot, i), (kind, dim) in rule.ins.items():
                vals = list(inputs.get(slot) or [])
                if i < len(vals) and vals[i] is not None:
                    if kind == "gather_copy":
                        vals[i] = collectives.copy_to_axis(
                            collectives.gather_along_dim(vals[i], dim,
                                                         group), group)
                    else:
                        vals[i] = _convert(vals[i], kind, dim, group)
                inputs[slot] = vals
            attrs = dict(ctx.attrs, **rule.attrs) if rule.attrs else \
                ctx.attrs
            c2 = _reg.ExecContext(ctx.op_type, inputs, ctx.outputs_spec,
                                  attrs, ctx.device, ctx.generator, ctx.host)
            with collectives.sharded_over(group if rule.native else None):
                raw = fn(c2)
            return _post(raw, rule, group)

        out = _reg.OpDef(opdef.type, placed,
                         no_grad_inputs=opdef.no_grad_inputs,
                         stateful=opdef.stateful)
        out.grad_fn = opdef.grad_fn
        return out

    def run(self, k, op, env, device, generator, outputs_spec):
        """Run plan op ``k`` under its rule (the Executor's ``run_op``
        with the placed forward impl)."""
        from ..fluid import executor as _exe

        rule = self.rules[k]
        opdef, is_grad = _exe._resolve(op.type)
        ctx = _exe._context(op, env, device, generator, outputs_spec)
        placed = self._wrapped.get(k)
        if placed is None:
            placed = self._wrapped[k] = self.wrap(opdef, rule)
        if not is_grad:
            raw = placed.fn(ctx)
        elif opdef.grad_fn is None:
            raw = _reg.run_grad_generic(placed, ctx)
        else:
            raw = self._explicit_grad(opdef, rule, ctx)
        _exe._store(op, env, raw, ctx.inputs)

    def _explicit_grad(self, opdef, rule, ctx):
        """An explicit grad impl under its forward's rule: the forward
        inputs converted as the forward's were (no autograd), the impl,
        then each input grad taken back through the conversion's
        backward."""
        group = self.group
        if rule.post and any(kind != "reduce" for steps in rule.post.values()
                             for kind, _ in steps):
            raise NotImplementedError(
                f"{ctx.op_type}: an explicit grad under a conversion of its "
                f"forward's outputs")
        inputs = dict(ctx.inputs)
        for (slot, i), (kind, dim) in rule.ins.items():
            vals = list(inputs.get(slot) or [])
            if i < len(vals):
                vals[i] = _plain(vals[i], "gather" if kind == "gather_copy"
                                 else kind, dim, group)
            inputs[slot] = vals
        attrs = dict(ctx.attrs, **rule.attrs) if rule.attrs else ctx.attrs
        c2 = _reg.ExecContext(ctx.op_type, inputs, ctx.outputs_spec, attrs,
                              ctx.device, ctx.generator, ctx.host)
        with collectives.sharded_over(group if rule.native else None):
            raw = _reg.normalize_outputs(opdef.grad_fn(c2))
        for (slot, i), (kind, dim) in rule.ins.items():
            vals = raw.get(slot + GRAD)
            if vals and i < len(vals) and vals[i] is not None:
                if kind == "gather_copy":
                    vals[i] = _adjoint(_adjoint(vals[i], "copy", 0, group),
                                       "gather", dim, group)
                else:
                    vals[i] = _adjoint(vals[i], kind, dim, group)
        return raw

    def fetch(self, name, value):
        """A fetched value in full: a sharded one gathered."""
        d = self.place.get(name)
        if d is None or not isinstance(value, torch.Tensor):
            return value
        return collectives.gather_dim(value, d, self.group)


def _post(raw, rule, group):
    if not rule.post:
        return raw
    out = _reg.normalize_outputs(raw)
    for (slot, i), steps in rule.post.items():
        vals = out.get(slot)
        if vals and i < len(vals) and vals[i] is not None:
            for kind, dim in steps:
                vals[i] = _convert(vals[i], kind, dim, group)
    return out


def _reshape_map(xs, target, d, tp):
    """``(e, local)``: the dim of ``target`` that input dim ``d`` (sharded
    over ``tp`` ranks) maps to, and the target shape with that dim's size
    divided by ``tp``; None when the shard does not map onto one dim whole
    (``xs``: the input's declared shape, -1 for the batch)."""
    out = list(target)
    for i, s in enumerate(out):
        if s == 0:
            out[i] = xs[i]
    if d is None or xs[d] is None or xs[d] < 0 or xs[d] % tp:
        return None
    # the dims before d and their product; the batch (-1) stays first
    nd_in, nd_out = len(xs), len(out)
    if (xs[0] is not None and xs[0] < 0) != (out[0] < 0):
        return None
    lead_in = 1
    for s in xs[1 if xs[0] < 0 else 0:d]:
        lead_in *= s
    # walk the target's dims to the one whose span starts at lead_in
    acc, e = 1, 1 if out[0] < 0 else 0
    while e < nd_out and acc < lead_in:
        acc *= out[e]
        e += 1
    if acc != lead_in or e >= nd_out or any(s < 0 for s in out[1:]):
        return None
    if out[e] >= xs[d]:
        # dims of x merge into target dim e: d must be its outermost
        tail, f = 1, d
        while tail < out[e] and f < nd_in:
            tail *= xs[f]
            f += 1
        if tail != out[e]:
            return None
    elif xs[d] % out[e] or out[e] % tp:
        return None
    local = list(target)
    local[e] = out[e] // tp
    return e, local


_RULES = {
    "mul": Placement._rule_mul,
    "matmul": Placement._rule_matmul,
    "lookup_table": Placement._rule_lookup,
    "sum": Placement._rule_sum,
    "softmax": Placement._rule_softmax,
    "ring_attention": Placement._rule_attention,
    "softmax_with_cross_entropy": Placement._rule_xent,
}
_RULES.update({t: Placement._rule_unary for t in _UNARY})
_RULES.update({t: Placement._rule_elementwise for t in _ELEMENTWISE})
_RULES.update({t: Placement._rule_reshape for t in _RESHAPE})
_RULES.update({t: Placement._rule_transpose for t in _TRANSPOSE})
