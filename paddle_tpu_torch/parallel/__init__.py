"""Parallelism (counterpart of ``paddle_tpu/parallel``): meshes over the
ranks of a process group (``mesh.py``), joining the group
(``multihost.py``), data parallelism and ZeRO-1 (``spmd.py``, run by
``fluid.ParallelExecutor``), and the single-device layers:
data, tensor and fsdp parallelism and ZeRO-1 (``spmd.py``, with the tp
placements of ``placement.py``, run by ``fluid.ParallelExecutor``), and
the single-device layers: ``full_attention`` (``ring_attention.py``), the
fc stack of the ``gpipe_mlp_stack`` op (``pipeline.py``), the MoE
feed-forward (``moe.py``) and the transformer layer stacks
(``transformer_stack.py``).  The sp ring, the pipeline schedules and
expert parallelism come with ``ROADMAP.md`` queue 1 item 12b, step 4."""

import torch


def refuse_process_group(what: str) -> None:
    """Raise inside a ``torch.distributed`` group of more than one process,
    unless a parallel step runs now (``spmd.active_mesh``) over a mesh
    whose axes other than dp, tp (mp) and fsdp have extent 1 (that step
    hands the op whole values, or its shards through its tp rule): the
    op's schedule over other axes is not ported, and outside a
    ``ParallelExecutor`` it cannot tell whether its inputs are sharded.
    An op that mixes the rows of a batch-sharded input (``moe_ffn``'s
    capacity counts the global batch's tokens) is refused when the
    data-parallel plan is built (``spmd._ALWAYS_CROSS``)."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        return
    from .spmd import active_mesh

    mesh = active_mesh()
    if mesh is not None and all(
            e == 1 for a, e in mesh.shape.items()
            if a not in ("dp", "tp", "mp", "fsdp")):
        return
    raise NotImplementedError(
        f"{what} over a process group comes with a later part of the "
        f"multi-GPU slice (ROADMAP.md queue 1 item 12b, step 4)")
