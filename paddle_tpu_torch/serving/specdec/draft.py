"""The draft side of speculative decoding (counterpart of
``paddle_tpu/serving/specdec/draft.py``): a cheap DecodeModel that proposes
k tokens per tick for the target to verify.

The self-draft is a truncated clone of the target: its first
``draft_layers`` decoder layers, 0 meaning full depth (the draft IS the
target: acceptance 1.0, the throughput ceiling probe).  Its parameter
names (``dlm_emb``, ``dlm_out_w``, ``dlm{i}_*`` for ``i < depth``) are a
prefix of the target's, so :meth:`DraftSource.sync` is a name-for-name
copy from the target scope.  The copy writes into the draft scope's
existing tensors (``copy_``): the draft's CUDA graphs hold their
addresses.

The draft always runs a DENSE slot cache, whatever the target's mode: its
K/V is private scratch, never shared and never read by the target;
rollback is free, since the validity bias masks everything past the
committed frontier and the next tick overwrites rejected positions.

A draft loaded from a registry serial (``DecodeConfig.spec_draft_serial``)
needs ``serving/registry.py``, which is not ported yet: the engine refuses
it.
"""

from __future__ import annotations

from ...fluid.executor import Scope
from ...models.transformer import Config, DecodeModel

__all__ = ["DraftSource"]


class DraftSource:
    """The draft model and its private scope.  ``exe`` is the engine's
    executor (it runs the draft's startup on the engine's device); the
    engine dispatches the draft's programs against :attr:`scope`."""

    def __init__(self, target: DecodeModel, exe, draft_layers: int):
        depth = int(draft_layers)
        if depth < 0 or depth > target.cfg.n_layer:
            raise ValueError(
                f"draft_layers ({depth}) must be in [0, "
                f"{target.cfg.n_layer}] (0 = full-depth self-draft)")
        if depth == 0:
            depth = target.cfg.n_layer
        c = target.cfg
        dcfg = Config(f"{c.name}_draft{depth}",
                      src_vocab_size=c.src_vocab_size,
                      tgt_vocab_size=c.tgt_vocab_size, d_model=c.d_model,
                      d_inner=c.d_inner, n_head=c.n_head, n_layer=depth,
                      dropout=0.0, label_smooth=0.0)
        self.depth = depth
        self.model = DecodeModel(
            cfg=dcfg, max_slots=target.max_slots, max_len=target.max_len,
            prefill_buckets=target.prefill_buckets, end_id=target.end_id,
            seed=target.seed, paged=False)
        self.scope = Scope()
        exe.run(self.model.startup, scope=self.scope)

    def sync(self, target_scope) -> None:
        """Copy the shared-by-name weight set target -> draft, into the
        draft's own tensors."""
        for name in self.model.weight_names():
            val = target_scope.get(name)
            if val is not None:
                self.scope.get(name).copy_(val)
