"""Parallel attention (counterpart of ``paddle_tpu/parallel``): the
single-device ``full_attention`` for now; meshes, the sp ring and the
sharded executors come with the multi-GPU slice."""
