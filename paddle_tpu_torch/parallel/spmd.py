"""Data parallelism over a process group (counterpart of the dp and ZeRO-1
half of ``paddle_tpu/parallel/spmd.py``).

The reference jits one traced program over a mesh and lets GSPMD insert
the collectives.  The port runs one process per rank: each feeds its own
shard of the global batch (global batch = ranks × local batch) and runs
the Executor's eager step, into which :class:`ShardedTrainStep` puts the
collectives GSPMD would have inserted, so that a step over N ranks equals
the single-device step at the same global batch:

 - **the batch analysis**: a fed var whose declared leading dim is the
   batch (-1) is batch-sharded, and so is every output of an op that
   reads one, unless the op reduces across the batch.  Those ops
   (``mean``, training ``batch_norm``, the ``reduce_*`` ops over dim 0,
   ``accuracy``) run with the group set (``ops/collectives.py``
   ``crossing``) and give the global value; any other op that crosses
   the batch of a batch-sharded input (a softmax or concat over dim 0, a
   transpose that moves it, a matmul contracting over it, a metric with
   state, ...) raises when the plan is built, and so does an op that
   would write a persistable from a batch-sharded input;
 - **one gradient sum**: right after the last op that writes a
   parameter's grad, the grads are summed over the ranks in one flat
   bucket a dtype (one all-reduce a step); each grad then reads as its
   slice of the bucket.  Clipping, regularization, the loss scaler's
   check and the update all see the global grads;
 - **ZeRO-1** (``BuildStrategy.ReduceStrategy.Reduce``): the bucket is
   reduce-scattered instead; rank r owns the r-th chunk of the flattened
   parameters, runs the optimizer ops (momentum, adam, sgd: the group
   kernel of ``ops/fused.py`` for the first two, the counterpart of the
   reference's ``pallas_fused.py:605`` ``_run_opt``) on its chunk of each
   parameter, grad and state, and the parameters are all-gathered after
   the last of them.  The optimizer states stay correct only on their
   owner's chunk (the reference keeps them sharded too).  When an op
   other than those reads a grad after the sum (a global-norm clip, a
   regularizer) or a grad is fetched, the bucket is all-reduced whole
   (:attr:`ShardedTrainStep.whole_grads_for` names that op), so that op
   sees every element summed; the update still runs on the chunks;
 - **random draws**: over more than one rank each rank draws from its
   own stream (``rank_seed``: the program's seed with the rank folded
   in), so the dropout masks of the ranks' rows are independent draws, as
   one device's mask over the global batch is: the step equals the
   single-device step in distribution, not draw for draw.  A draw that no
   batch-sharded input shapes (every rank would need the same value), or
   one with a fixed ``seed`` attr (every rank would draw the same mask),
   raises when the plan is built;
 - **equal start**: the persistables a plan reads are broadcast from rank
   0 at their first run (upstream ``BCastParamsToDevices``,
   ``parallel_executor.cc:234``).

Unequal local batches raise a named error when the plan is built (one
exchange of the batch sizes; never guessed).  A mesh with a tp, fsdp, sp,
pp or ep axis of extent > 1 raises: ``SpecLayout``'s Megatron roles and
the sharded kernel wrappers come with the later part of ``ROADMAP.md``
queue 1 item 12b.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fluid.framework import Parameter, RNG_STATE_VAR
from ..ops import collectives
from .mesh import Mesh, axes_label, axes_of, mesh_label

LATER = ("the later part of ROADMAP.md queue 1 item 12b (tp / fsdp / sp / "
         "pp / ep meshes)")

# ops whose data-parallel form reduces over every rank's rows (their
# forward impls ask ``collectives.batch_group()``)
_GLOBAL = frozenset(["mean", "batch_norm", "reduce_sum", "reduce_mean",
                     "reduce_max", "reduce_min", "accuracy"])
# ops that always mix rows of the batch, or keep state across it
_ALWAYS_CROSS = frozenset([
    "shape", "gather", "scatter", "scatter_nd_add", "auc", "mean_iou",
    "precision_recall", "positive_negative_pair", "chunk_eval",
    "edit_distance", "detection_map", "while", "conditional_block",
    "moe_ffn", "mean", "accuracy", "roll", "crop", "linspace"])
# ops that reduce or move along their ``axis`` / ``dim`` attr
_AXIS_OPS = {"softmax": ("axis", -1), "log_softmax": ("axis", -1),
             "concat": ("axis", 0), "split": ("axis", 0),
             "stack": ("axis", 0), "unstack": ("axis", 0),
             "cumsum": ("axis", -1), "arg_max": ("axis", 0),
             "arg_min": ("axis", 0), "argsort": ("axis", -1),
             "flatten": ("axis", 1), "flatten2": ("axis", 1)}
_AXES_OPS = {"squeeze": "axes", "squeeze2": "axes", "unsqueeze": "axes",
             "unsqueeze2": "axes", "slice": "axes", "strided_slice": "axes",
             "reverse": "axis"}
# optimizer ops ZeRO-1 runs on a rank's chunk (elementwise in their param)
ZERO1_OPS = frozenset(["momentum", "adam", "sgd"])


def batch_spec(mesh: Mesh) -> Tuple[str]:
    """The axis fed tensors' batch dim shards over (the reference's
    ``P("dp")``)."""
    return ("dp",) if "dp" in mesh.axis_names else (mesh.axis_names[0],)


def check_dp_only(mesh) -> None:
    """Raise unless every axis of ``mesh`` (a :class:`Mesh` or a spec,
    as ``axes_of`` takes it) but ``dp`` has extent 1."""
    axes = axes_of(mesh)
    bad = {a: e for a, e in axes.items() if a != "dp" and e > 1}
    if bad:
        raise NotImplementedError(
            f"mesh {axes_label(axes)}: axes {sorted(bad)} are not ported; "
            f"the port runs data parallelism only, until {LATER}")


_ACTIVE_MESH: List[Mesh] = []


def active_mesh() -> Optional[Mesh]:
    """The mesh of the data-parallel step running now, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def rank_seed(seed, rank: int) -> int:
    """The seed of rank ``rank``'s random stream in a group of more than
    one: ``seed`` and the rank mixed by numpy's ``SeedSequence``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def infer_param_specs(program, plan, mesh: Mesh, zero1: bool = False,
                      dp_axis: str = "dp") -> Dict[str, tuple]:
    """A per-dim axis tuple per state var (``()`` = replicated), the
    reference's table for a dp mesh: parameters replicated; under
    ``zero1`` each accumulator sharded on its first dim the dp extent
    divides (``zero1_spec``), a one-value state (a beta pow) replicated.
    Ownership of an accumulator comes from ``Program._accumulator_owner``,
    else from its name containing its parameter's.  The runtime does not
    use this table: its ZeRO-1 shards the flattened parameters in chunks
    (:class:`ShardedTrainStep`).  It is the layout the reference gives the
    same program, kept for the later tp / fsdp layouts."""
    check_dp_only(mesh)
    gb = program.global_block()
    names = set(plan.state_in) | set(plan.state_out)
    has_dp = zero1 and dp_axis in mesh.shape and mesh.shape[dp_axis] > 1
    if not has_dp:
        return {n: () for n in names}
    dp_size = mesh.shape[dp_axis]
    specs: Dict[str, Optional[tuple]] = {}
    param_shapes = {}
    for name in names:
        if name != RNG_STATE_VAR and gb._has_var_recursive(name):
            v = gb._var_recursive(name)
            if isinstance(v, Parameter):
                specs[name] = ()
                param_shapes[name] = tuple(v.shape) if v.shape else None
                continue
        specs[name] = None

    def zero1_spec(shape):
        for d, n in enumerate(shape):
            if n is not None and n > 0 and n % dp_size == 0 \
                    and n >= dp_size:
                return tuple([None] * d + [dp_axis]
                             + [None] * (len(shape) - d - 1))
        return ()

    acc_owner = getattr(program, "_accumulator_owner", {})
    for name, spec in list(specs.items()):
        if spec is not None:
            continue
        v = gb._var_recursive(name) if gb._has_var_recursive(name) else None
        shape = tuple(v.shape) if v is not None and v.shape else None
        matched = ()
        owner = acc_owner.get(name)
        if owner is not None:
            if shape is not None and shape == param_shapes.get(owner):
                matched = zero1_spec(shape)
        else:
            for pname, pshape in param_shapes.items():
                if pname in name and shape == pshape and shape is not None:
                    matched = zero1_spec(shape)
                    break
        specs[name] = matched
    return specs


class UnequalBatchError(ValueError):
    """The ranks' local batches differ: a data-parallel step needs the
    same local batch on every rank (global batch = ranks × local)."""


def _ndim(block, name) -> Optional[int]:
    if not block._has_var_recursive(name):
        return None
    shape = block._var_recursive(name).shape
    return None if shape is None else len(shape)


def _is_batch_axis(axis, ndim) -> bool:
    if axis is None:
        return False
    return axis == 0 or (ndim is not None and axis == -ndim)


def _crosses(op, base, sharded, block) -> bool:
    """Whether ``op`` (of forward type ``base``) reduces or moves along the
    batch dim of one of its batch-sharded inputs."""
    attr = op.attr
    x = next(iter(op.inputs.get("X", [])), None)
    nd = _ndim(block, x) if x else None
    if base in _ALWAYS_CROSS:
        return True
    if base == "batch_norm":
        return not attr("is_test")
    if base.startswith("reduce_"):
        dim = attr("dim")
        if attr("reduce_all") or dim is None:
            return True
        dims = [dim] if isinstance(dim, int) else list(dim)
        return any(_is_batch_axis(d, nd) for d in dims)
    if base in ("transpose", "transpose2"):
        perm = attr("axis") or attr("perm")
        return bool(perm) and perm[0] != 0
    if base in _AXIS_OPS:
        key, default = _AXIS_OPS[base]
        a = attr(key)
        a = default if a is None else a
        if base in ("flatten", "flatten2"):
            return a == 0
        return _is_batch_axis(a, nd)
    if base in _AXES_OPS:
        axes = attr(_AXES_OPS[base]) or []
        axes = [axes] if isinstance(axes, int) else axes
        return any(_is_batch_axis(a, nd) for a in axes)
    if base == "layer_norm":
        return attr("begin_norm_axis") == 0
    if base in ("reshape", "reshape2"):
        shape = attr("shape") or []
        return bool(shape) and shape[0] > 0
    if base == "expand":
        times = attr("expand_times") or []
        return bool(times) and times[0] != 1
    if base == "pad":
        pads = attr("paddings") or []
        return any(pads[:2])
    if base in ("matmul", "matmul_v2"):
        xs = [n for n in op.inputs.get("X", []) if n in sharded]
        ys = [n for n in op.inputs.get("Y", []) if n in sharded]
        tx = attr("transpose_X") or attr("trans_x")
        if xs and _ndim(block, xs[0]) == 2 and tx:
            return True
        return bool(ys) and (_ndim(block, ys[0]) or 0) <= 2
    if base == "mul":
        return any(n in sharded for n in op.inputs.get("Y", []))
    return False


def _base_type(op_type: str) -> Tuple[str, bool]:
    if op_type.endswith("_grad"):
        return op_type[:-5], True
    return op_type, False


def _grad_base(name: str) -> Optional[str]:
    return name.split("@GRAD", 1)[0] if "@GRAD" in name else None


class ShardedTrainStep:
    """The data-parallel form of one Executor plan (a ``BlockPlan``) at one
    set of feed shapes, over ``group`` (a
    :class:`~..ops.collectives.DPGroup`): the batch analysis, the point
    where the grads are summed, ZeRO-1's chunks, and the hooks the
    Executor's ``_execute`` calls (:meth:`op_scope`, :meth:`sliced`,
    :meth:`run_sliced`, :meth:`after`).  Building it exchanges the ranks'
    local batch sizes once (:meth:`check_feed`)."""

    def __init__(self, program, plan, feed_shapes: Dict[str, tuple],
                 mesh: Mesh, group, zero1: bool = False):
        check_dp_only(mesh)
        self.program, self.plan, self.mesh = program, plan, mesh
        self.label = mesh_label(mesh)
        self.group = group
        self.zero1 = bool(zero1)
        self.bspec = batch_spec(mesh)
        block = program.global_block()
        self.batch_feeds = sorted(
            n for n, shape in feed_shapes.items()
            if len(shape) > 0 and self._declared_batch(block, n))
        self._analyse(block)
        self._place_grads(block)
        self.check_feed(feed_shapes)
        self._layout = None
        self._views: Dict[tuple, tuple] = {}

    @staticmethod
    def _declared_batch(block, name) -> bool:
        """A fed var is batch-sharded when its declared leading dim is the
        batch (-1 / None); a var the program does not declare, when fed
        with a leading dim."""
        if not block._has_var_recursive(name):
            return True
        shape = block._var_recursive(name).shape
        return bool(shape) and (shape[0] is None or shape[0] < 0)

    def _analyse(self, block):
        plan = self.plan

        def persistable(n):
            return block._has_var_recursive(n) and \
                block._var_recursive(n).persistable

        from ..fluid.executor import _draws_random

        sharded = set(self.batch_feeds)
        self.crossing = set()
        for k, op in enumerate(plan.ops):
            ins = [n for n in op.input_arg_names if n in sharded]
            if self.group.world > 1 and _draws_random(op):
                if not ins:
                    raise NotImplementedError(
                        f"op {op.type!r} draws a value that no batch-sharded "
                        f"input shapes: every rank draws from its own "
                        f"stream, so the ranks would disagree on it; run it "
                        f"with Executor")
                if op.attr("seed"):
                    raise NotImplementedError(
                        f"op {op.type!r} has the fixed seed "
                        f"{op.attr('seed')}: every rank would draw the same "
                        f"numbers for its own rows; drop the seed, or run "
                        f"it with Executor")
            if not ins:
                continue
            base, is_grad = _base_type(op.type)
            flagged = _crosses(op, base, sharded, block)
            if flagged and base not in _GLOBAL:
                raise NotImplementedError(
                    f"op {op.type!r} crosses the batch of the batch-sharded "
                    f"input {ins[0]!r}, and has no data-parallel form in "
                    f"the port; run it with Executor, or give it one")
            if flagged:
                self.crossing.add(k)
            for slot, names in op.outputs.items():
                for n in names:
                    if not n:
                        continue
                    g = _grad_base(n)
                    if is_grad and g is not None:
                        if g in sharded:
                            sharded.add(n)
                        continue
                    if persistable(n):
                        if not flagged:
                            raise NotImplementedError(
                                f"op {op.type!r} writes the persistable "
                                f"{n!r} from the batch-sharded input "
                                f"{ins[0]!r}: every rank would keep its "
                                f"own value")
                        continue
                    if not flagged or (base == "batch_norm"
                                       and slot == "Y"):
                        sharded.add(n)
        self.sharded = sharded

    def _place_grads(self, block):
        """The grads summed once a step and where: after the last op that
        writes one; no op before that reads one but the ops that write
        them (the grad accumulation).  Under ZeRO-1, whether the sum is
        reduce-scattered (only the optimizer ops read the grads, each its
        chunk) or all-reduced (:attr:`whole_grads_for`: the first other op
        that reads a grad, or ``"fetch"``)."""
        plan = self.plan
        self.whole_grads_for = None
        pg = getattr(self.program, "_params_grads", None) or []
        self.params_grads = [(p.name, g.name) for p, g in pg
                             if g is not None and p.name in set(
                                 plan.state_in)]
        names = {g for _, g in self.params_grads}
        self.grad_names = [g for _, g in self.params_grads]
        self.sync_at = max((k for k, op in enumerate(plan.ops)
                            if names & set(op.output_arg_names)),
                           default=None)
        if self.sync_at is None:
            self.grad_names, self.params_grads = [], []
            self.sliced_ops, self.gather_at = set(), None
            return
        # a grad no later op (or fetch) reads is never asked of its op
        read = set(plan.fetch_names).union(
            *(op.input_arg_names for op in plan.ops[self.sync_at + 1:]))
        self.params_grads = [(p, g) for p, g in self.params_grads
                             if g in read]
        self.grad_names = [g for _, g in self.params_grads]
        for k in range(self.sync_at + 1):
            op = plan.ops[k]
            read = names & set(op.input_arg_names)
            if read and not names & set(op.output_arg_names):
                raise NotImplementedError(
                    f"op {op.type!r} reads the grad {sorted(read)[0]!r} "
                    f"before the last op that writes a grad; the ranks' "
                    f"parts are summed only after it")
        if plan.first_optimize <= self.sync_at:
            raise NotImplementedError(
                "an optimizer op runs before the last op that writes a "
                "parameter's grad")
        self.sliced_ops, self.gather_at = set(), None
        if not self.zero1:
            return
        params = {p for p, _ in self.params_grads}
        for k, op in enumerate(plan.ops):
            p = op.inputs.get("Param", [None])[0]
            if not plan.optimize[k] or p not in params:
                continue
            if op.type not in ZERO1_OPS:
                raise NotImplementedError(
                    f"ZeRO-1 (ReduceStrategy.Reduce) runs {sorted(ZERO1_OPS)}"
                    f" on a rank's chunk; {op.type!r} is not one of them")
            self.sliced_ops.add(k)
        self.gather_at = max(self.sliced_ops, default=None)
        grads = set(self.grad_names)
        for k in range(self.sync_at + 1, len(plan.ops)):
            op = plan.ops[k]
            if k in self.sliced_ops:
                continue
            if params & set(op.output_arg_names):
                raise NotImplementedError(
                    f"ZeRO-1: op {op.type!r} writes a parameter outside the "
                    f"optimizer ops a rank runs on its chunk")
            if self.whole_grads_for is None and grads & set(
                    op.input_arg_names):
                self.whole_grads_for = op.type
        if self.whole_grads_for is None and grads & set(plan.fetch_names):
            self.whole_grads_for = "fetch"

    # -- placement --
    def check_feed(self, feed_shapes: Dict[str, tuple]) -> None:
        """Exchange every rank's local batch sizes; raise
        :class:`UnequalBatchError` on every rank unless they agree."""
        mine = tuple((n, int(feed_shapes[n][0])) for n in self.batch_feeds)
        if self.group.world == 1:
            return
        every = [None] * self.group.world
        dist.all_gather_object(every, mine)
        if any(e != mine for e in every):
            raise UnequalBatchError(
                f"the ranks' local batches differ (mesh {self.label}, axis "
                f"{'x'.join(self.bspec)}): "
                + "; ".join(f"rank {r}: " + ", ".join(
                    f"'{n}' batch {b}" for n, b in e)
                    for r, e in enumerate(every))
                + "; a data-parallel step needs one local batch on every "
                  "rank (global batch = ranks x local batch)")

    def place_state(self, scope, names) -> None:
        """Broadcast the state ``names`` from rank 0 (:func:`broadcast_state`)."""
        broadcast_state(self.group, scope, names)

    # -- the Executor's hooks --
    def op_scope(self, k: int):
        return collectives.crossing(self.group if k in self.crossing
                                    else None)

    def sliced(self, k: int) -> bool:
        return k in self.sliced_ops

    def after(self, k: int, env) -> None:
        if k == self.sync_at:
            self._sum_grads(env)
        if k == self.gather_at:
            self._gather_params(env)

    def _buckets(self, env):
        """``[(dtype, [(grad, param, numel, shape, offset)], padded)]`` in
        params-grads order; the chunk size of a bucket is ``padded //
        world``."""
        if self._layout is None:
            from ..fluid.selected_rows import SelectedRows

            by_dtype: Dict[torch.dtype, list] = {}
            for p, g in self.params_grads:
                t = env[g]
                if isinstance(t, SelectedRows) or not isinstance(
                        t, torch.Tensor):
                    raise NotImplementedError(
                        f"the grad {g!r} is sparse (SelectedRows); its "
                        f"all-reduce comes with a later part of ROADMAP.md "
                        f"queue 1 item 12b")
                by_dtype.setdefault(t.dtype, []).append(
                    (g, p, t.numel(), tuple(t.shape)))
            layout = []
            for dtype, items in by_dtype.items():
                off, rows = 0, []
                for g, p, n, shape in items:
                    rows.append((g, p, n, shape, off))
                    off += n
                w = self.group.world
                padded = -(-off // w) * w if self.zero1 else off
                layout.append((dtype, rows, padded))
            self._layout = layout
        return self._layout

    def _sum_grads(self, env) -> None:
        w, r = self.group.world, self.group.rank
        for dtype, rows, padded in self._buckets(env):
            parts = [env[g].reshape(-1) for g, *_ in rows]
            total = rows[-1][4] + rows[-1][2]
            if padded > total:
                parts.append(torch.zeros(padded - total, dtype=dtype,
                                         device=parts[0].device))
            flat = torch.cat(parts)
            if self.zero1 and self.whole_grads_for is None:
                c = padded // w
                chunk = torch.empty(c, dtype=dtype, device=flat.device)
                self.group.reduce_scatter(chunk, flat)
                flat[r * c:(r + 1) * c].copy_(chunk)
            else:
                self.group.all_reduce_(flat)
            for g, _, n, shape, off in rows:
                env[g] = flat[off:off + n].view(shape)

    def _chunk_of(self, param, env):
        """``(a, b)``: the elements of ``param`` (flattened) in this rank's
        chunk, or None when it has none."""
        w, r = self.group.world, self.group.rank
        for _, rows, padded in self._buckets(env):
            c = padded // w
            for _, p, n, _, off in rows:
                if p == param:
                    a, b = max(off, r * c), min(off + n, (r + 1) * c)
                    return (a - off, b - off) if a < b else None
        raise KeyError(param)

    def _view(self, name, t, a, b):
        key = (name, a, b)
        hit = self._views.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        v = t.view(-1)[a:b]
        self._views[key] = (t, v)
        return v

    def run_sliced(self, ops, env, device, generator, outputs_specs,
                   run_op, run_group) -> None:
        """ZeRO-1: run the optimizer ops ``ops`` (one group) on this rank's
        chunk of each parameter.  Every input of a member shaped as its
        parameter is handed as that chunk (a view: the update lands in the
        full tensor); a member whose parameter has no element in the chunk
        is left out, its adam beta pows advanced as its update would."""
        tmp = dict(env)
        kept, specs, dropped = [], [], []
        for op, spec in zip(ops, outputs_specs):
            pname = op.inputs["Param"][0]
            param = env[pname]
            span = self._chunk_of(pname, env)
            if span is None:
                dropped.append(op)
                continue
            for n in op.input_arg_names:
                t = env.get(n)
                if isinstance(t, torch.Tensor) and t.shape == param.shape:
                    tmp[n] = self._view(n, t, *span)
            kept.append(op)
            specs.append(spec)
        if len(kept) > 1:
            run_group(kept, tmp, device, generator, specs)
        elif kept:
            run_op(kept[0], tmp, device, generator, specs[0])
        adam = [op for op in dropped if op.type == "adam"]
        if adam:
            for slot, attr, dflt in (("Beta1Pow", "beta1", 0.9),
                                     ("Beta2Pow", "beta2", 0.999)):
                torch._foreach_mul_([env[op.inputs[slot][0]] for op in adam],
                                    float(adam[0].attr(attr) if adam[0].attr(
                                        attr) is not None else dflt))

    def _gather_params(self, env) -> None:
        w, r = self.group.world, self.group.rank
        for dtype, rows, padded in self._buckets(env):
            c = padded // w
            parts = []
            for _, p, n, _, off in rows:
                a, b = max(off, r * c), min(off + n, (r + 1) * c)
                if a < b:
                    parts.append(env[p].reshape(-1)[a - off:b - off])
            have = sum(t.numel() for t in parts)
            if have < c:
                parts.append(torch.zeros(c - have, dtype=dtype,
                                         device=env[rows[0][1]].device))
            chunk = torch.cat(parts)
            full = torch.empty(padded, dtype=dtype, device=chunk.device)
            self.group.all_gather(full, chunk)
            ps = [env[p] for _, p, *_ in rows]
            torch._foreach_copy_(ps, [full[off:off + n].view(shape)
                                      for _, _, n, shape, off in rows])


def broadcast_state(group, scope, names) -> None:
    """Broadcast the tensors ``names`` hold in ``scope`` from rank 0, in
    place, one flat bucket a dtype (a tensor with no element, or a value
    that is no tensor, such as a host counter, is left as it is)."""
    if group.world == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for n in names:
        v = scope.get(n)
        if isinstance(v, torch.Tensor) and v.numel():
            by_dtype.setdefault(v.dtype, []).append(v)
    for dtype, ts in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        group.broadcast_(flat.view(torch.uint8) if dtype == torch.bool
                         else flat, 0)
        torch._foreach_copy_(
            ts, [part.view(t.shape) for part, t in zip(
                torch.split(flat, [t.numel() for t in ts]), ts)])


class ShardedWindowRunner:
    """``run_steps`` over a process group: the Executor's graphed window
    (``fluid/executor.py`` ``_Window``) with a :class:`ShardedTrainStep`
    in its step.  On the card the window captures its step, collectives
    included, as one CUDA graph: only a group whose collectives a graph
    can capture (NCCL) runs one; under another (gloo) it raises rather
    than run the steps eagerly.  On the CPU nothing is captured."""

    def __init__(self, executor, device):
        self.executor = executor
        self.device = device

    def check(self, group) -> None:
        if self.device.type == "cuda" and not group.capturable:
            raise RuntimeError(
                f"run_steps captures each step as a CUDA graph, and a "
                f"{group.backend} group's collectives cannot be captured; "
                f"use ParallelExecutor.run per step, or an NCCL group")

    def run(self, program, feed, fetch_list, n_steps, scope,
            feed_per_step=False, return_numpy=True):
        """The window's last step's fetches: numpy arrays, or with
        ``return_numpy=False`` tensors on the device."""
        out = self.executor.run_steps(program, feed, fetch_list, n_steps,
                                      scope=scope,
                                      feed_per_step=feed_per_step)
        if return_numpy:
            return out
        return [torch.from_numpy(np.asarray(v)).to(self.device)
                for v in out]
