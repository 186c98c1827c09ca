"""Weight-only int8 inference transpiler (counterpart of
``paddle_tpu/fluid/transpiler/int8_transpiler.py``).

The weights of ``mul`` (``Y``, per output column), ``conv2d``
(``Filter``, per output channel) and ``lookup_table`` (``W``, per row)
are stored as int8 with a float32 abs-max scale per channel, and a
``dequantize_weight`` op before each weight's first consumer in a block
rebuilds the float32 weight there (``ops/quant_ops.py``): activations and
sums stay float, the standard recipe that needs no calibration data.

The scope keeps the int8 tensor and the scale on the weight's device and
drops the float original: a quarter of the weight bytes.  Eager PyTorch
writes the dequantized float32 copy every run (the reference's XLA fuses
it into the consumer's read), so the saving is in what the scope holds,
not in the traffic of a run.
"""

from __future__ import annotations

import numpy as np
import torch

# op type -> (weight input slot, the weight's per-channel axis)
_QUANT_TARGETS = {
    "mul": ("Y", 1),            # [in, out]
    "conv2d": ("Filter", 0),    # [out_c, in_c, kh, kw]
    "lookup_table": ("W", 0),   # embeddings: a scale per row
}
_FLOATS = (torch.float16, torch.float32, torch.float64)


class Int8WeightTranspiler:
    """Rewrite an inference program and its scope for weight-only int8;
    weights of fewer than ``min_elements`` values stay float."""

    def __init__(self, min_elements: int = 64):
        self.min_elements = min_elements

    def transpile(self, program, place=None, scope=None):
        """Quantize in place; returns the names of the quantized weights.
        Run it after the startup program: it quantizes what the scope
        holds."""
        from ..executor import global_scope
        from ..framework import Parameter

        scope = scope or global_scope()
        gb = program.global_block()
        # pass 1: every consuming site in every block, before the scope
        # changes (a weight shared across blocks loses its float copy in
        # pass 2)
        sites = []  # (block, op index, op, slot, weight name)
        axes, weights = {}, {}
        for block in program.blocks:
            for i, op in enumerate(block.ops):
                target = _QUANT_TARGETS.get(op.type)
                if target is None:
                    continue
                slot, axis = target
                names = op.inputs.get(slot) or []
                if len(names) != 1:
                    continue
                wname = names[0]
                if wname not in weights:
                    if not gb._has_var_recursive(wname) or not isinstance(
                            gb._var_recursive(wname), Parameter):
                        continue
                    w = scope.get(wname, None)
                    if w is None or w.dtype not in _FLOATS or \
                            w.numel() < self.min_elements:
                        continue
                    weights[wname] = w
                    axes[wname] = axis
                elif axes[wname] != axis:
                    continue  # the same weight read along another axis
                sites.append((block, i, op, slot, wname))

        # pass 2: quantize each weight once, rewrite every consumer
        for wname, w in weights.items():
            self._quantize(gb, scope, wname, w, axes[wname])
        for _, _, op, slot, wname in sites:
            op.inputs[slot] = [wname + "@DEQ"]
        # one dequantize_weight per (block, weight) before its first
        # consumer there; inserted back to front so the indices hold
        for block in program.blocks:
            firsts = {}
            for b, i, _, _, wname in sites:
                if b is block:
                    firsts[wname] = min(firsts.get(wname, i), i)
            for wname, i in sorted(firsts.items(), key=lambda t: -t[1]):
                block._insert_op(
                    i, type="dequantize_weight",
                    inputs={"X": [wname + "@INT8"],
                            "Scale": [wname + "@SCALE"]},
                    outputs={"Out": [wname + "@DEQ"]},
                    attrs={"quant_axis": axes[wname]})
            if firsts:
                self._patch_owner_ops(program, block, list(firsts))
        return list(weights)

    def _patch_owner_ops(self, program, block, wnames):
        """A sub-block's weights reach its scope through the owning op's
        ``X`` list (a ``jit_beam_search`` step block, a ``While`` body):
        swap each quantized weight there for its int8 tensor and scale."""
        owner = None
        for b in program.blocks:
            for op in b.ops:
                if op.attr("sub_block") == block.idx:
                    owner = op
                    break
        if owner is None or "X" not in owner.inputs:
            return
        x = [n for n in owner.inputs["X"] if n not in wnames]
        for w in wnames:
            x.extend([w + "@INT8", w + "@SCALE"])
        owner.inputs["X"] = x

    def _quantize(self, block, scope, wname, w, axis):
        """The int8 weight and its per-channel scale into the block and the
        scope, on the weight's device; the float original leaves the scope.
        The values are computed on the host in numpy, as the reference
        does, so the int8 tensor is the reference's bit for bit."""
        gb = block.program.global_block()
        host = w.detach().cpu().numpy()
        reduce_axes = tuple(d for d in range(host.ndim) if d != axis)
        scale = np.abs(host).max(axis=reduce_axes).astype(np.float32)
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        shape = [1] * host.ndim
        shape[axis] = -1
        q = np.clip(np.round(host / scale.reshape(shape) * 127.0),
                    -127, 127).astype(np.int8)

        wq_name, sc_name = wname + "@INT8", wname + "@SCALE"
        gb.create_var(name=wq_name, shape=tuple(q.shape), dtype="int8",
                      persistable=True)
        gb.create_var(name=sc_name, shape=tuple(scale.shape),
                      dtype="float32", persistable=True)
        dq_name = wname + "@DEQ"
        gb.create_var(name=dq_name, shape=tuple(host.shape),
                      dtype="float32", persistable=False)
        scope.set(wq_name, torch.from_numpy(q).to(w.device))
        scope.set(sc_name, torch.from_numpy(scale).to(w.device))
        scope._values.pop(wname, None)  # the float copy is the saving
        return dq_name
