"""Inference transpiler (counterpart of
``paddle_tpu/fluid/transpiler/inference_transpiler.py``): flips train-mode
ops to ``is_test`` and folds each test-mode batch_norm whose sole input is
a conv2d into the conv's filter and a bias add (``fluid.ir.ConvBNFuse``)."""

from __future__ import annotations


class InferenceTranspiler:
    def transpile(self, program, place, scope=None):
        """Returns the fused program: callers install the RETURN VALUE,
        as the pass pipeline's ``to_program()`` owns the write-back."""
        from ..executor import global_scope
        from ..ir import ConvBNFuse, Graph

        scope = scope or global_scope()
        for block in program.blocks:
            for op in block.ops:
                if op.type in ("batch_norm", "dropout"):
                    op.attrs["is_test"] = True
        return ConvBNFuse(scope).apply(Graph(program, 0)).to_program()
