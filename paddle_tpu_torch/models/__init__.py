"""Model builders (counterpart of ``paddle_tpu/models``)."""
