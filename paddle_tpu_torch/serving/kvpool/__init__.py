"""Paged KV cache: the host-side page pool (counterpart of
``paddle_tpu/serving/kvpool``)."""

from .pool import PageGrant, PagePool

__all__ = ["PageGrant", "PagePool"]
