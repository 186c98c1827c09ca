"""Data, tensor and fsdp parallelism over a process group (counterpart of
``paddle_tpu/parallel/spmd.py``).

The reference jits one traced program over a mesh and lets GSPMD insert
the collectives.  The port runs one process per rank: each feeds its dp
coordinate's shard of the global batch (global batch = dp ranks × local
batch) and runs the Executor's eager step, into which
:class:`ShardedTrainStep` puts the collectives GSPMD would have inserted,
so that a step over the mesh equals the single-device step at the same
global batch:

 - **the batch analysis**: a fed var whose declared leading dim is the
   batch (-1) is batch-sharded, and so is every output of an op that
   reads one, unless the op reduces across the batch.  Those ops
   (``mean``, training ``batch_norm``, the ``reduce_*`` ops over dim 0,
   ``accuracy``) run with the dp group set (``ops/collectives.py``
   ``crossing``) and give the global value; any other op that crosses
   the batch of a batch-sharded input (a softmax or concat over dim 0, a
   transpose that moves it, a matmul contracting over it, a metric with
   state, ...) raises when the plan is built, and so does an op that
   would write a persistable from a batch-sharded input;
 - **the spec table** (a ``tp`` / ``mp`` or ``fsdp`` axis of extent > 1):
   the reference's :func:`infer_param_specs` over :class:`SpecLayout`,
   verbatim.  A state var is stored as the rank's shard over the tp and
   fsdp axes of its spec; each op runs under its tp placement rule
   (``parallel/placement.py``), and an fsdp-stored parameter is gathered
   before its first reader and its grad cut back to the rank's shard
   before the sum (every fsdp rank computed the whole grad: the batch is
   split over dp only);
 - **one gradient sum**: right after the last op that writes a
   parameter's grad, the grads (the rank's shards) are summed over the
   dp group in one flat bucket a dtype (one all-reduce a step); each
   grad then reads as its slice of the bucket.  Clipping,
   regularization, the loss scaler's check and the update all see the
   global grads;
 - **ZeRO-1** (``BuildStrategy.ReduceStrategy.Reduce``): the bucket is
   reduce-scattered over dp instead; dp rank r owns the r-th chunk of the
   flattened (local) parameters, runs the optimizer ops (momentum, adam,
   sgd: the group kernel of ``ops/fused.py`` for the first two, the
   counterpart of the reference's ``pallas_fused.py:605`` ``_run_opt``)
   on its chunk of each parameter, grad and state, and the parameters are
   all-gathered after the last of them.  The optimizer states stay
   correct only on their owner's chunk (the reference keeps them sharded
   too).  When an op other than those reads a grad after the sum (a
   global-norm clip, a regularizer) or a grad is fetched, the bucket is
   all-reduced whole (:attr:`ShardedTrainStep.whole_grads_for` names that
   op), so that op sees every element summed; the update still runs on
   the chunks;
 - **random draws**: over more than one dp rank each dp coordinate draws
   from its own stream (``rank_seed``: the program's seed with the
   coordinate folded in), so the dropout masks of the ranks' rows are
   independent draws, as one device's mask over the global batch is: the
   step equals the single-device step in distribution, not draw for
   draw.  Its tp and fsdp peers draw the same.  A draw that no
   batch-sharded input shapes (every dp rank would need the same value),
   or one with a fixed ``seed`` attr (every dp rank would draw the same
   mask), raises when the plan is built;
 - **equal start**: the persistables a plan reads are broadcast from rank
   0 at their first run (upstream ``BCastParamsToDevices``,
   ``parallel_executor.cc:234``), then cut to the rank's shards.

Unequal local batches raise a named error when the plan is built (one
exchange of the batch sizes; never guessed).  A mesh with an sp, pp or ep
axis of extent > 1 raises (:func:`check_axes`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fluid.framework import Parameter, RNG_STATE_VAR
from ..ops import collectives
from .mesh import Mesh, axes_label, axes_of, mesh_label, resolve_tp_axis

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
    """The axis fed tensors' batch dim shards over: ``dp``.  The reference
    takes a mesh's first axis when it has no ``dp`` (``P(mesh.axis_names
    [0])``); the port shards the batch over dp only, so on a mesh with no
    dp axis (``tp2``, ``fsdp2``) every rank feeds the whole batch."""
    return ("dp",)


# axes a step runs; the others (sp, pp, ep) come with a later step
RUN_AXES = ("dp", "tp", "mp", "fsdp")
LATER_AXES = ("the sp ring, the pipeline schedules and expert parallelism: "
              "ROADMAP.md queue 1 item 12b, step 4")


def check_axes(mesh) -> None:
    """Raise unless every axis of ``mesh`` (a :class:`Mesh` or a spec, as
    ``axes_of`` takes it) with extent > 1 is one a step runs: ``dp``,
    ``tp`` (or ``mp``), ``fsdp``; and at most one of ``tp`` / ``mp``."""
    axes = axes_of(mesh)
    bad = {a: e for a, e in axes.items() if a not in RUN_AXES and e > 1}
    if bad:
        raise NotImplementedError(
            f"mesh {axes_label(axes)}: axes {sorted(bad)} are not ported; "
            f"the port runs dp, tp (mp) and fsdp meshes, until {LATER_AXES}")
    if axes.get("tp", 1) > 1 and axes.get("mp", 1) > 1:
        raise NotImplementedError(
            f"mesh {axes_label(axes)}: both tp and mp have extent > 1; a "
            f"step shards over one tensor-parallel axis")


# ---------------------------------------------------------------------------
# SpecLayout: the canonical table of per-dim axes (the reference's
# ``paddle_tpu/parallel/spmd.py:64-370``, specs as tuples)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpecLayout:
    """Canonical specs per mesh axis role (the reference's): the Megatron
    column / row alternation for linear chains, embedding tables sharded
    on d_model, batch-sharded activations.  Axes absent from the mesh (or
    dims that do not divide) degrade to replicated per dim when applied
    (:func:`infer_param_specs`), so one layout serves every mesh shape."""

    data_axis: str = "dp"
    tp_axis: str = "tp"
    fsdp_axis: str = "fsdp"

    def batch(self) -> tuple:
        return (self.data_axis,)

    def embeddings(self) -> tuple:
        """[vocab, d_model]: d_model over tp, vocab over fsdp."""
        return (self.fsdp_axis, self.tp_axis)

    def qkv_projection(self) -> tuple:
        """Column-parallel [d_in, d_out]: outputs over tp, input rows over
        fsdp."""
        return (self.fsdp_axis, self.tp_axis)

    def attn_output(self) -> tuple:
        """Row-parallel: the contraction dim over tp, so the partial sums
        all-reduce once a product."""
        return (self.tp_axis, self.fsdp_axis)

    def ffn_up(self) -> tuple:
        return self.qkv_projection()

    def ffn_down(self) -> tuple:
        return self.attn_output()


def _param_roles(program) -> Dict[str, Tuple[str, int]]:
    """``name -> (role, order)``: ``"embedding"`` for a ``lookup_table``
    weight, ``"linear"`` for every ``Y`` input of ``mul`` / ``matmul`` (a
    parameter or not: the unfused attention's two products count too, as
    in the reference) numbered in program order; even orders are
    column-parallel, odd ones row-parallel."""
    roles: Dict[str, Tuple[str, int]] = {}
    order = 0
    for block in program.blocks:
        for op in block.ops:
            if op.type == "lookup_table":
                for n in op.inputs.get("W", []):
                    if n and n not in roles:
                        roles[n] = ("embedding", 0)
            elif op.type in ("mul", "matmul"):
                for n in op.inputs.get("Y", []):
                    if n and n not in roles:
                        roles[n] = ("linear", order)
                        order += 1
    return roles


def _fit_spec(spec: tuple, shape, mesh: Mesh) -> tuple:
    """Degrade a layout spec to the mesh and shape: an axis absent from
    the mesh, of extent 1, used by an earlier dim, or whose dim it does not
    divide becomes None."""
    if shape is None:
        return ()
    dims, used = [], set()
    for d in range(len(shape)):
        ax = spec[d] if d < len(spec) else None
        ok = (ax is not None and ax in mesh.axis_names and ax not in used
              and mesh.shape[ax] > 1 and shape[d] is not None
              and shape[d] % mesh.shape[ax] == 0)
        if ok:
            used.add(ax)
        dims.append(ax if ok else None)
    return tuple(dims)


def table_signature(specs: Dict[str, Optional[tuple]]) -> List[list]:
    """The spec table as a jsonable ``[[var_name, [axis|None per dim]]]``
    list, sorted by name."""
    out = []
    for name in sorted(specs):
        spec = specs[name]
        axes = [(list(ax) if isinstance(ax, tuple) else ax)
                for ax in tuple(spec)] if spec is not None else None
        out.append([name, axes])
    return out


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


def infer_param_specs(program, plan, mesh: Mesh, tp_axis: str = "mp",
                      zero1: bool = False, dp_axis: str = "dp",
                      layout: Optional[SpecLayout] = None
                      ) -> Dict[str, tuple]:
    """A per-dim axis tuple per state var (``()`` = replicated): the
    reference's table, verbatim.

    With a :class:`SpecLayout` (named ``tp`` / ``fsdp`` meshes) the
    parameters go through the canonical table: ``lookup_table`` weights
    get the embedding spec, ``mul`` / ``matmul`` weights alternate column
    and row along :func:`_param_roles`' order, fsdp shards the other dim.
    Without one (legacy ``mp`` meshes), a 2-D parameter is sharded on its
    last dim when the tp extent divides it, else on its first.  Hints win
    over both: a per-dim ``dist_spec``, or ``dist_hint`` (one axis on dim
    0).  An accumulator takes its parameter's spec (ownership from
    ``Program._accumulator_owner``, else its name containing the
    parameter's and the same shape); under ``zero1`` it is also sharded
    on its first dp-divisible free dim.  A one-value state (a beta pow)
    is replicated.

    The step stores each state var sharded over the tp and fsdp axes of
    its spec (``parallel/placement.py``); ZeRO-1's dp part is run as
    chunks of the flattened local shards (:class:`ShardedTrainStep`)."""
    gb = program.global_block()
    names = set(plan.state_in) | set(plan.state_out)
    has_tp = tp_axis in mesh.axis_names
    has_dp = zero1 and dp_axis in mesh.axis_names and mesh.shape[dp_axis] > 1
    has_fsdp = (layout is not None and layout.fsdp_axis in mesh.axis_names
                and mesh.shape[layout.fsdp_axis] > 1)

    def hint_spec(v) -> Optional[tuple]:
        ds = getattr(v, "dist_spec", None)
        if ds is not None:
            shape = v.shape or ()
            dims = []
            for d, ax in enumerate(ds[: len(shape)]):
                ok = (ax is not None and ax in mesh.axis_names
                      and mesh.shape[ax] > 1 and shape[d] is not None
                      and shape[d] % mesh.shape[ax] == 0)
                dims.append(ax if ok else None)
            return tuple(dims)
        axis = getattr(v, "dist_hint", None)
        if axis is None or axis not in mesh.axis_names \
                or mesh.shape[axis] <= 1:
            return None
        shape = v.shape
        if not shape or shape[0] is None or shape[0] % mesh.shape[axis] != 0:
            return None
        return tuple([axis] + [None] * (len(shape) - 1))

    has_hints = any(
        getattr(v, "dist_hint", None) in mesh.axis_names
        or any(ax in mesh.axis_names
               for ax in (getattr(v, "dist_spec", None) or ()) if ax)
        for v in gb.vars.values() if isinstance(v, Parameter))
    if not has_tp and not has_dp and not has_hints and not has_fsdp:
        return {n: () for n in names}
    tp_size = mesh.shape[tp_axis] if has_tp else 1
    dp_size = mesh.shape[dp_axis] if has_dp else 1
    roles = _param_roles(program) if layout is not None else {}

    def layout_spec(name, shape) -> Optional[tuple]:
        role = roles.get(name)
        if role is None or shape is None or len(shape) != 2:
            return None
        kind, order = role
        if kind == "embedding":
            base = layout.embeddings()
        elif order % 2 == 0:
            base = layout.qkv_projection()
        else:
            base = layout.attn_output()
        return _fit_spec(base, shape, mesh)

    def spec_for_shape(shape) -> tuple:
        if not has_tp or shape is None or len(shape) < 2:
            return ()
        if shape[-1] is not None and shape[-1] % tp_size == 0 \
                and shape[-1] >= tp_size:
            return tuple([None] * (len(shape) - 1) + [tp_axis])
        if shape[0] is not None and shape[0] % tp_size == 0 \
                and shape[0] >= tp_size:
            return tuple([tp_axis] + [None] * (len(shape) - 1))
        return ()

    def zero1_spec(shape, base: tuple) -> tuple:
        if not has_dp or shape is None:
            return base
        used = list(base) + [None] * (len(shape) - len(base))
        for d, n in enumerate(shape):
            if used[d] is None and n is not None and n % dp_size == 0 \
                    and n >= dp_size:
                used[d] = dp_axis
                return tuple(used)
        return base

    specs: Dict[str, Optional[tuple]] = {}
    param_shapes = {}
    for name in names:
        if name == RNG_STATE_VAR:
            specs[name] = ()
            continue
        if gb._has_var_recursive(name):
            v = gb._var_recursive(name)
            hs = hint_spec(v) if isinstance(v, Parameter) else None
            if hs is not None:
                specs[name] = hs
                param_shapes[name] = tuple(v.shape)
                continue
            if isinstance(v, Parameter) and v.shape is not None \
                    and len(v.shape) == 2:
                ls = layout_spec(name, tuple(v.shape))
                specs[name] = ls if ls is not None \
                    else spec_for_shape(v.shape)
                param_shapes[name] = tuple(v.shape)
                continue
            if isinstance(v, Parameter):
                specs[name] = ()
                param_shapes[name] = tuple(v.shape) if v.shape else None
                continue
        specs[name] = None  # decided below (maybe an accumulator)
    acc_owner = getattr(program, "_accumulator_owner", {})
    for name, spec in list(specs.items()):
        if spec is not None:
            continue
        v = gb._var_recursive(name) if gb._has_var_recursive(name) else None
        shape = tuple(v.shape) if v is not None and v.shape else None
        matched = ()
        pname = acc_owner.get(name)
        if pname is not None:
            if pname in param_shapes and shape == param_shapes[pname] \
                    and shape is not None:
                matched = zero1_spec(shape, specs[pname])
        else:
            for pname, pshape in param_shapes.items():
                if pname in name and shape == pshape and shape is not None:
                    matched = zero1_spec(shape, specs[pname])
                    break
        specs[name] = matched
    return specs


def layout_for(mesh: Mesh, tp_axis: Optional[str] = None
               ) -> Optional[SpecLayout]:
    """The reference's choice (``ShardedTrainStep.__init__``): the
    canonical table on a mesh that names ``tp`` or ``fsdp``, the legacy
    heuristic (None) on an ``mp`` mesh."""
    if "tp" in mesh.axis_names or "fsdp" in mesh.axis_names:
        return SpecLayout(tp_axis=resolve_tp_axis(mesh, tp_axis))
    return None


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
                 mesh: Mesh, group, zero1: bool = False, groups=None,
                 world=None):
        check_axes(mesh)
        self.program, self.plan, self.mesh = program, plan, mesh
        self.label = mesh_label(mesh)
        self.group = group
        self.world = world if world is not None else group
        self.groups = dict(groups or {})
        # ZeRO-1 shards over the dp ranks; a mesh with one dp rank (a
        # one-rank axis group) has nothing to shard or sum
        self.zero1 = bool(zero1) and not group.trivial
        self.bspec = batch_spec(mesh)
        block = program.global_block()
        self.batch_feeds = sorted(
            n for n, shape in feed_shapes.items()
            if len(shape) > 0 and self._declared_batch(block, n))
        self._analyse(block)
        self._place_grads(block)
        self._layout_tp_fsdp(program, plan, block, zero1)
        self.check_feed(feed_shapes)
        self._layout = None
        self._views: Dict[tuple, tuple] = {}
        self._fsdp_local: Dict[str, torch.Tensor] = {}

    def _layout_tp_fsdp(self, program, plan, block, zero1):
        """The spec table, the tp placements (``parallel/placement.py``)
        and the fsdp-stored names, on a mesh whose tp or fsdp axis has
        extent > 1 (else none of them)."""
        from .placement import SPARSE_LATER, Placement

        mesh = self.mesh
        self.tp_axis = resolve_tp_axis(mesh)
        tp = self.groups.get(self.tp_axis)
        fsdp = self.groups.get("fsdp")
        self.tp_group = tp if tp is not None and tp.world > 1 else None
        self.fsdp_group = fsdp if fsdp is not None and fsdp.world > 1 \
            else None
        self.specs: Dict[str, tuple] = {}
        self.placement = None
        self.fsdp: Dict[str, int] = {}
        self.fsdp_gather: Dict[int, List[str]] = {}
        self.fsdp_grads: Dict[str, int] = {}
        if self.tp_group is None and self.fsdp_group is None:
            return
        self.specs = infer_param_specs(program, plan, mesh, self.tp_axis,
                                       zero1=zero1, layout=layout_for(mesh))
        if self.fsdp_group is not None:
            self.fsdp = {n: spec.index("fsdp")
                         for n, spec in self.specs.items() if "fsdp" in spec}
        for op in plan.ops:
            if op.type in ("lookup_table", "lookup_table_grad") and \
                    op.attr("is_sparse") and \
                    set(op.inputs.get("W", [])) & set(self.fsdp):
                raise NotImplementedError(
                    f"lookup_table {op.inputs['W'][0]!r} (is_sparse=True): "
                    f"{SPARSE_LATER}")
        if self.tp_group is not None:
            self.placement = Placement(program, plan, self.specs,
                                       self.tp_axis, self.tp_group)
            odd = [plan.ops[k].type for k in self.sliced_ops
                   if self.placement.rules[k] is not None]
            if odd:
                raise NotImplementedError(
                    f"ZeRO-1 under tp: the optimizer op {odd[0]!r} would "
                    f"take operands placed unlike its parameter")
        # an fsdp-stored name read before the grads are summed (a
        # parameter, not an accumulator) is gathered before its first
        # reader and its local shard put back at the sum
        end = self.sync_at if self.sync_at is not None \
            else len(plan.ops) - 1
        seen = set()
        for k, op in enumerate(plan.ops[:end + 1]):
            for n in op.input_arg_names:
                if n in self.fsdp and n not in seen:
                    seen.add(n)
                    self.fsdp_gather.setdefault(k, []).append(n)
        self._fsdp_end = end
        self.fsdp_grads = {g: self.fsdp[p] for p, g in self.params_grads
                           if p in self.fsdp}

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
        if self.world.world == 1:
            return
        every = [None] * self.world.world
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
        """Broadcast the state ``names`` from rank 0 over every rank
        (:func:`broadcast_state`), then keep in ``scope`` the rank's shard
        of each one the layout stores sharded; ``scope._shards`` names
        them (``fluid.io`` refuses to save such a scope)."""
        broadcast_state(self.world, scope, names)
        cut = [n for n in names if any(
            ax in (self.tp_axis, "fsdp") for ax in self.specs.get(n) or ())
            and (self.tp_group is not None or self.fsdp_group is not None)]
        if not cut:
            return
        shards = getattr(scope, "_shards", None)
        if shards is None:
            shards = scope._shards = {}
        for n in cut:
            v = scope.get(n)
            if isinstance(v, torch.Tensor):
                scope.set(n, self.shard(n, v))
                shards[n] = (self.label, self.specs[n])

    # -- the Executor's hooks --
    def op_scope(self, k: int):
        return collectives.crossing(self.group if k in self.crossing
                                    else None)

    def sliced(self, k: int) -> bool:
        return k in self.sliced_ops

    def groupable(self, k: int) -> bool:
        """Whether the group of ops that starts at plan op ``k`` runs as
        one group (no member has a tp rule to run)."""
        if self.placement is None:
            return True
        return all(self.placement.rules[j] is None
                   for j in self.plan.groups.get(k, [k]))

    def before(self, k: int, env) -> None:
        """Gather the fsdp-stored parameters plan op ``k`` is the first to
        read (once: a group's members are handed before their leader
        runs)."""
        if k == 0:
            self._fsdp_local = {}  # what a step cut by an error left
        for n in self.fsdp_gather.get(k, ()):
            if n in self._fsdp_local:
                continue
            self._fsdp_local[n] = env[n]
            env[n] = collectives.gather_dim(env[n], self.fsdp[n],
                                            self.fsdp_group)

    def run_op(self, k: int, op, env, device, generator, outputs_spec,
               run_op) -> None:
        """Run plan op ``k``: under its tp rule, else as it is; with the
        dp group set around an op that crosses the batch."""
        rule = self.placement.rules[k] if self.placement is not None \
            else None
        with self.op_scope(k):
            if rule is None:
                run_op(op, env, device, generator, outputs_spec)
            else:
                self.placement.run(k, op, env, device, generator,
                                   outputs_spec)

    def after(self, k: int, env) -> None:
        if self.fsdp and k == self._fsdp_end:
            self._fsdp_release(env)
        if k == self.sync_at and not self.group.trivial:
            self._sum_grads(env)
        if k == self.gather_at:
            self._gather_params(env)

    def _fsdp_release(self, env) -> None:
        """Put back the fsdp-stored parameters' local shards and cut their
        grads to them (every fsdp rank computed the same whole grad: the
        batch is not split over fsdp)."""
        for n, t in self._fsdp_local.items():
            env[n] = t
        self._fsdp_local = {}
        for g, d in self.fsdp_grads.items():
            if isinstance(env.get(g), torch.Tensor):
                env[g] = collectives.slice_dim(env[g], d, self.fsdp_group)

    def fetch(self, name, value):
        """A fetch in full (Fluid's fetch semantics): a value sharded over
        tp or stored sharded over fsdp is gathered."""
        if self.placement is not None:
            value = self.placement.fetch(name, value)
        d = self.fsdp.get(name, self.fsdp_grads.get(name))
        if d is not None and isinstance(value, torch.Tensor):
            value = collectives.gather_dim(value, d, self.fsdp_group)
        return value

    def shard(self, name, value):
        """The rank's shard of the whole state value ``value`` of
        ``name`` (as the scope holds it under this layout)."""
        spec = self.specs.get(name) or ()
        for d, ax in enumerate(spec):
            g = self.tp_group if ax == self.tp_axis else \
                self.fsdp_group if ax == "fsdp" else None
            if g is not None and isinstance(value, torch.Tensor):
                value = collectives.slice_dim(value, d, g)
        return value

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
                        f"queue 1 item 12b, step 2")
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
