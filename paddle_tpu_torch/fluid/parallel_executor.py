"""ParallelExecutor: data-, tensor- and fsdp-parallel training over a
``torch.distributed`` group (counterpart of
``paddle_tpu/fluid/parallel_executor.py``).

The reference jits the block over a mesh of local devices and lets GSPMD
partition it; upstream replicates the program per GPU and inserts NCCL
all-reduce op handles.  The port runs one process per rank, each on one
device, and keeps the reference's multi-process contract
(``paddle_tpu/parallel/multihost.py:197,205``): every process feeds its
own shard of the global batch along the mesh's dp axis (global batch = dp
ranks × local batch; the ranks of one dp coordinate, tp or fsdp peers,
feed the same rows); a fetch is the full value (a sharded one is
gathered), the same on every rank but a batch-sharded one, which is the
rank's own rows.  A step over the mesh equals the single-device
``Executor`` step at the same global batch, batch statistics included:
the Executor's own eager step runs with the collectives of
``parallel/spmd.py`` ``ShardedTrainStep`` in it (the ops that cross the
batch reduce over every dp rank's rows, the grads are summed once a step
in one flat bucket over the dp group, ZeRO-1 under
``BuildStrategy.ReduceStrategy.Reduce``), each op under its tp placement
rule on a mesh with a ``tp`` (or ``mp``) axis (``parallel/
placement.py``), fsdp-stored parameters gathered before their first
reader; and the persistables are broadcast from rank 0 at their first run
(upstream ``BCastParamsToDevices``), then cut to the rank's shards.  The
rank's scope then holds shards: ``fluid.io``'s savers refuse it.

The mesh: ``mesh=`` (a :class:`~..parallel.mesh.Mesh` or a spec string
like ``dp2,tp2``), else the program's ``DistributeTranspiler``
annotation, else ``PADDLE_TPU_MESH``, else dp over every rank.  Its
``dp``, ``tp`` / ``mp`` and ``fsdp`` axes run; an ``sp``, ``pp`` or ``ep``
axis of extent > 1 raises (``spmd.check_axes``).

The group: one the caller initialized is adopted (a gloo group over CUDA
tensors is how two ranks share one card); else one is joined from the
program's ``DistributeTranspiler`` annotation or the ``PADDLE_*`` env
(``parallel/multihost.py``): NCCL for a CUDA place, gloo for the CPU; a
world of one gets a group of one.  Each axis of the mesh gets its
sub-group (``mesh.axis_groups``).  Over more than one dp rank each dp
coordinate draws its random numbers (dropout masks) from its own stream,
the coordinate folded into the program's seed: the masks of the dp ranks'
rows are independent, as one device's over the global batch are, but not
the same draws; the ranks of one dp coordinate draw the same.
``run_steps`` captures each step, collectives included, as one CUDA graph
on the card: under a group whose collectives cannot be captured (gloo) it
raises. Plans are cached per program version, fetches and feed names (the
Executor's cache) and per feed shapes (the parallel step's).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import core
from .executor import Executor, global_scope
from .framework import default_main_program
from ..ops.collectives import DPGroup
from ..parallel import multihost as _mh
from ..parallel import spmd as _spmd
from ..parallel.mesh import (Mesh, axis_groups, env_mesh_spec,
                             mesh_from_spec, mesh_label)

__all__ = ["ExecutionStrategy", "BuildStrategy", "ParallelExecutor"]


class ExecutionStrategy:
    """Upstream ``pybind.cc:605-620``: kept for API parity (the port's
    step is the Executor's; none of these knobs changes it)."""

    class ExecutorType:
        Default = 0
        Experimental = 1

    def __init__(self):
        self.num_threads = 0
        self.use_cuda = False
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.type = ExecutionStrategy.ExecutorType.Default


class BuildStrategy:
    """Upstream ``pybind.cc:621-643``.  ``reduce_strategy``: ``AllReduce``
    (every rank keeps the whole update) or ``Reduce`` (ZeRO-1: each rank
    updates its chunk of the parameters and their states, then the
    parameters are all-gathered)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""


class _DPExecutor(Executor):
    """The Executor a ParallelExecutor runs through: its steps carry the
    data-parallel hooks."""

    def __init__(self, place, pe):
        super().__init__(place)
        self._pe = pe

    def _dp_step(self, program, plan, feed_vals, feed_lods, scope):
        return self._pe._step_for(program, plan, feed_vals, feed_lods,
                                  scope)

    def _rng_stream(self, program):
        """Over more than one dp rank, the dp coordinate's own stream: its
        dropout masks are drawn independently of the other dp ranks', and
        the same as its tp and fsdp peers'."""
        key, seed = super()._rng_stream(program)
        mesh = self._pe._mesh
        n = mesh.shape.get("dp", 1)
        if n == 1:
            return key, seed
        c = mesh.coords["dp"]
        return f"{key}/rank{c}of{n}", _spmd.rank_seed(seed, c)


def _default_place():
    if _mh.is_initialized() and torch.cuda.is_available():
        return core.CUDAPlace(_mh.process_index()
                              % max(1, torch.cuda.device_count()))
    return core.CUDAPlace(0)


class ParallelExecutor:
    """Upstream ``python/paddle/fluid/parallel_executor.py:32``; runs on
    ``place`` (default the card: ``CUDAPlace(rank % device count)``).
    ``mesh``: a :class:`~..parallel.mesh.Mesh` or spec string (else the
    annotation's, else ``PADDLE_TPU_MESH``, else dp over every rank); its
    dp, tp (mp) and fsdp axes may have extent > 1."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, use_tpu=None, devices=None, mesh=None,
                 place=None, **kwargs):
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._scope = scope or global_scope()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        dist_info = dict(getattr(self._program, "_dist_info", None) or {})
        if num_trainers > 1 and not dist_info:
            dist_info = {"trainers": num_trainers, "trainer_id": trainer_id}
        if dist_info.get("mode") == "async_local_sgd":
            raise NotImplementedError(
                "DistributeTranspiler(sync_mode=False): local SGD "
                "(parallel/local_sgd.py) comes with the later part of "
                "ROADMAP.md queue 1 item 12b, step 3")
        self._place = place if place is not None else _default_place()
        self._device = core.torch_device(self._place)
        _mh.ensure_init(dist_info, self._place)
        self._world = DPGroup()
        if isinstance(mesh, Mesh):
            self._mesh = mesh
        else:
            spec = mesh if isinstance(mesh, str) else (
                dist_info.get("mesh") or env_mesh_spec())
            if spec:
                _spmd.check_axes(spec)
            self._mesh = mesh_from_spec(spec, self._world.world,
                                        self._world.rank)
        _spmd.check_axes(self._mesh)
        if self._mesh.size != self._world.world:
            raise ValueError(
                f"mesh {mesh_label(self._mesh)} has {self._mesh.size} ranks; "
                f"the process group has {self._world.world}")
        self._groups = axis_groups(self._mesh)
        # the group the grads are summed over and ZeRO-1 shards over (a
        # mesh with no dp axis has one dp rank)
        self._group = self._groups.get("dp") or DPGroup(
            [self._world.rank], axis="dp")
        self._zero1 = (self._build_strategy.reduce_strategy
                       == BuildStrategy.ReduceStrategy.Reduce)
        self._exe = _DPExecutor(self._place, self)
        self._windows = _spmd.ShardedWindowRunner(self._exe, self._device)
        self._steps: Dict[tuple, _spmd.ShardedTrainStep] = {}
        self._broadcast = set()
        self._stager = None

    @property
    def _sharded(self) -> bool:
        """Whether the scope holds shards: a mesh axis other than dp has
        extent > 1."""
        return any(e > 1 for a, e in self._mesh.shape.items() if a != "dp")

    @property
    def device_count(self):
        """The ranks of the group (one device each)."""
        return self._world.world

    @property
    def mesh(self):
        return self._mesh

    @property
    def mesh_label(self):
        return mesh_label(self._mesh)

    def _step_for(self, program, plan, feed_vals, feed_lods, scope):
        from . import guardian as _guardian

        if feed_lods:
            raise NotImplementedError(
                "ParallelExecutor: LoD feeds are not sharded by the port's "
                "data-parallel step; run them with Executor")
        shapes = {k: tuple(v.shape) for k, v in feed_vals.items()}
        key = (plan, tuple(sorted(shapes.items())))
        step = self._steps.get(key)
        if step is None:
            if self._zero1 and _guardian.for_program(program) is not None:
                raise NotImplementedError(
                    "ZeRO-1 (ReduceStrategy.Reduce) with a guarded step (a "
                    "guardian armed, or fp16 loss scaling): the check reads "
                    "every grad, and a rank holds the sum of its chunk only")
            if self._sharded and \
                    _guardian.for_program(program) is not None:
                raise NotImplementedError(
                    f"a guarded step (a guardian armed, or fp16 loss "
                    f"scaling) on the mesh {self.mesh_label}: the check "
                    f"reads every grad, and a rank holds its shards only; "
                    f"it comes with a later part of ROADMAP.md queue 1 item "
                    f"12b")
            step = _spmd.ShardedTrainStep(program, plan, shapes, self._mesh,
                                          self._group, zero1=self._zero1,
                                          groups=self._groups,
                                          world=self._world)
            self._steps[key] = step
        new = [n for n in plan.state_in
               if n not in self._broadcast and n not in feed_vals]
        if new:
            step.place_state(scope, new)
            self._broadcast.update(new)
        return step

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        """One data-parallel step on this rank's feed (a dict, or a list of
        per-device dicts concatenated along the batch); returns the fetches
        as ``Executor.run`` does."""
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, list):
            merged: Dict[str, list] = {}
            for d in feed:
                for k, v in d.items():
                    merged.setdefault(k, []).append(v)
            feed = {k: (torch.cat(v) if isinstance(v[0], torch.Tensor)
                        else np.concatenate([np.asarray(a) for a in v]))
                    for k, v in merged.items()}
        with _spmd.mesh_scope(self._mesh):
            return self._exe.run(self._program, feed=feed or {},
                                 fetch_list=fetch_list, scope=self._scope,
                                 return_numpy=return_numpy)

    def run_steps(self, fetch_list, feed=None, n_steps=1,
                  feed_per_step=False, return_numpy=True):
        """``n_steps`` data-parallel steps as one window (the Executor's
        ``run_steps``: on the card one CUDA graph a step, its collectives
        captured in it).  Raises under a group whose collectives cannot be
        captured (gloo) on the card.  Returns the last step's fetches."""
        self._windows.check(self._group)
        with _spmd.mesh_scope(self._mesh):
            return self._windows.run(self._program, feed, fetch_list,
                                     n_steps, self._scope, feed_per_step,
                                     return_numpy)

    def stage_window(self, window):
        """``DevicePrefetcher``'s ``stage_fn``: one stacked ``(n_steps,
        batch, ...)`` window of this rank's feeds onto its device (pinned
        memory and a side stream on the card; the copy is complete when
        this returns, on the staging thread)."""
        from .prefetch import _Stager

        if self._stager is None:
            self._stager = _Stager(self._device)
        staged, event = self._stager.stage(
            {k: np.asarray(v) for k, v in window.items()})
        if event is not None:
            event.synchronize()
        return staged

    def bcast_params(self):
        """Broadcast every persistable of the program the scope holds from
        rank 0, in place (upstream ``BCastParamsToDevices``); the first
        run of each plan does this for the state it reads (and, on a tp or
        fsdp mesh, cuts it to the rank's shards)."""
        gb = self._program.global_block()
        names = [n for n, v in gb.vars.items() if v.persistable
                 and n not in self._broadcast]
        _spmd.broadcast_state(self._world, self._scope, names)
        if not self._sharded:
            self._broadcast.update(names)

    def close(self):
        self._exe.close()
        self._steps.clear()
