"""Parallel layers (counterpart of ``paddle_tpu/parallel``), the
single-device half: ``full_attention`` (``ring_attention.py``), the fc
stack of the ``gpipe_mlp_stack`` op (``pipeline.py``), the MoE
feed-forward (``moe.py``) and the transformer layer stacks
(``transformer_stack.py``).  Meshes, the sp ring, the pipeline schedules,
expert parallelism and the sharded executors come with the multi-GPU
slice (``ROADMAP.md`` queue 1 item 12b)."""

import torch


def refuse_process_group(what: str) -> None:
    """Raise inside a ``torch.distributed`` group of more than one process:
    the op's schedule over a group is not ported, and it does not guess
    whether its inputs are sharded."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} over a process group comes with the multi-GPU slice "
            f"(ROADMAP.md queue 1 item 12b)")
