"""append_backward: IR-level reverse-mode autodiff (counterpart of
``paddle_tpu/fluid/backward.py``, copied so both packages emit the same
backward ops).

The backward graph is materialized as ``<type>_grad`` ops inside the
Program.  The grad op's *descriptor* is generated uniformly (forward inputs
+ forward outputs + output-grads in; input-grads out) and its *kernel* is
``torch.autograd.grad`` over the forward impl (``ops/registry.py``), with
explicit overrides where needed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from .framework import GRAD_VAR_SUFFIX, OpRole, Program, Variable, grad_var_name


def _find_relevant_ops(block, loss_name: str):
    """Ops (by index) whose outputs transitively feed the loss."""
    needed: Set[str] = {loss_name}
    relevant = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if any(n in needed for n in op.output_arg_names):
            relevant.append(idx)
            needed.update(n for n in op.input_arg_names if n)
    return list(reversed(relevant))


def _creates_grad(block, name: str, no_grad_set: Set[str]) -> bool:
    if not name or name in no_grad_set:
        return False
    if not block._has_var_recursive(name):
        return False
    return not block._var_recursive(name).stop_gradient


def _ensure_grad_var(block, fwd_name: str, grad_name: str):
    if block.has_var(grad_name):
        return block.var(grad_name)
    if block._has_var_recursive(fwd_name):
        fv = block._var_recursive(fwd_name)
        return block.create_var(name=grad_name, shape=fv.shape, dtype=fv.dtype,
                                persistable=False)
    return block.create_var(name=grad_name, persistable=False)


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None) -> List:
    """Returns [(param, grad_var)] pairs; mutates loss's program in place."""
    program: Program = loss.block.program
    block = program.global_block()
    no_grad = set(no_grad_set or ())
    relevant = _find_relevant_ops(block, loss.name)

    # grad bookkeeping: fwd var name -> list of produced grad var names
    produced: Dict[str, List[str]] = {}

    # seed: d loss / d loss = 1.  The __loss_seed__ tag is where the
    # reference folds a dynamic loss scale into the seed; the port runs
    # the op plainly until AMP is ported.
    loss_grad = grad_var_name(loss.name)
    _ensure_grad_var(block, loss.name, loss_grad)
    block.append_op(
        type="fill_any_like", inputs={"X": [loss.name]},
        outputs={"Out": [loss_grad]},
        attrs={"value": 1.0, "__loss_seed__": True,
               OpRole.KEY: OpRole.Backward | OpRole.Loss})
    produced[loss.name] = [loss_grad]

    def finalize_grad(name: str) -> Optional[str]:
        """Collapse accumulated partial grads for `name` into one var."""
        glist = produced.get(name)
        if not glist:
            return None
        if len(glist) == 1:
            return glist[0]
        out = grad_var_name(name)
        _ensure_grad_var(block, name, out)
        block.append_op(type="sum", inputs={"X": list(glist)},
                        outputs={"Out": [out]},
                        attrs={OpRole.KEY: OpRole.Backward})
        produced[name] = [out]
        return out

    fwd_ops = [(i, block.ops[i]) for i in relevant]
    for i, fop in reversed(fwd_ops):
        # incoming grads for this op's outputs
        out_grad_slots = {}
        has_any = False
        for slot, names in fop.outputs.items():
            gnames = []
            for n in names:
                g = finalize_grad(n) if n else None
                gnames.append(g if g is not None else "")
                if g is not None:
                    has_any = True
            out_grad_slots[slot + GRAD_VAR_SUFFIX] = gnames
        if not has_any:
            continue

        # requested input grads
        in_grad_slots = {}
        role_vars = []
        for slot, names in fop.inputs.items():
            gnames = []
            want = False
            for n in names:
                if _creates_grad(block, n, no_grad):
                    prev = produced.setdefault(n, [])
                    gname = grad_var_name(n) if not prev else \
                        f"{grad_var_name(n)}@RENAME@{len(prev)}"
                    prev.append(gname)
                    _ensure_grad_var(block, n, gname)
                    gnames.append(gname)
                    want = True
                else:
                    gnames.append("")
            if want:
                in_grad_slots[slot + GRAD_VAR_SUFFIX] = gnames
        if not in_grad_slots:
            continue

        gtype = fop.type + "_grad"
        inputs = {slot: list(names) for slot, names in fop.inputs.items()}
        for slot, names in fop.outputs.items():
            inputs[slot] = list(names)
        inputs.update(out_grad_slots)
        # __fwd_op_idx__ links the grad op to its forward op (the port's
        # executor reads it to know which forward outputs a generic grad
        # op does not need)
        gop = block.append_op(type=gtype, inputs=inputs, outputs=in_grad_slots,
                              attrs=dict(fop.attrs,
                                         **{OpRole.KEY: OpRole.Backward,
                                            "__fwd_op_idx__": i}))
        if callbacks:
            for cb in callbacks:
                cb(block=block, context={"__current_op_desc__": gop})

    # finalize param grads
    if parameter_list is not None:
        params = [block._var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = block.all_parameters()

    params_grads = []
    for p in params:
        if not getattr(p, "trainable", True):
            continue
        g = finalize_grad(p.name)
        if g is None:
            continue
        gvar = block.var(g)
        params_grads.append((p, gvar))

    # tag (param, grad) pairs on backward ops for the parallel pass/transpiler
    pg_names = {g.name: p.name for p, g in params_grads}
    for op in block.ops:
        if op.attr(OpRole.KEY, 0) & OpRole.Backward:
            rv = []
            for n in op.output_arg_names:
                if n in pg_names:
                    rv += [pg_names[n], n]
            if rv:
                op.attrs[OpRole.VAR_KEY] = rv

    program._params_grads = params_grads
    program._loss_name = loss.name
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. inputs (ref: backward.py:685)."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise NotImplementedError("calc_gradient supports a single target for now")
    t = targets[0]
    block = t.block
    saved = {v.name: v.stop_gradient for v in inputs}
    for v in inputs:
        v.stop_gradient = False
    try:
        append_backward(t, parameter_list=None, no_grad_set=no_grad_set)
    finally:
        for v in inputs:
            v.stop_gradient = saved[v.name]
    outs = []
    for v in inputs:
        gname = grad_var_name(v.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
