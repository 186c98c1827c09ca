"""The control-flow ops of the IR, run by the Executor (counterpart of
``paddle_tpu/fluid/control_flow_exec.py``): ``while``, ``while_grad``,
``conditional_block``, ``conditional_block_grad`` and ``jit_beam_search``.

They are not registered ops: ``executor.run_op`` hands them to
:data:`HANDLERS`, which run their sub-block's ops through ``run_op``
against the run's env and write what they produce into it directly (no
ShareLoD: a parameter's grad never takes a batch's LoD).

 - ``while`` runs its body as an eager Python loop for as long as its
   condition holds (at most :data:`MAX_WHILE_ITERS` times).  The
   condition is a host value when its chain roots in host values
   (:func:`host_names`), so reading it costs no device sync.  The values
   of its ``X`` inputs before the loop are stashed for ``while_grad``;
 - ``while_grad`` replays the loop from that stash with the differentiable
   ``X`` (float tensors, and the float entries of tensor arrays) as
   leaves that require grad, and takes ``torch.autograd.grad`` of the
   ``Out`` values that have a grad (the reference's ``jax.vjp`` over the
   same replay).  It adds into an ``X@GRAD`` that already holds a value,
   and refuses a body that draws random numbers;
 - ``conditional_block`` runs its body when its condition holds, and its
   grad replays the body the same way.

Host values (numpy, see ``ops/registry.py``): :func:`host_names` finds the
``fill_constant`` outputs of a program whose every reader takes a host
value (a comparison, a logical op, ``increment``, an array index, a
control-flow op that passes it to its body); the Executor lets those
``fill_constant`` ops make numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import registry as _reg
from ..ops.array_ops import TensorArray
from ..ops.beam_search_jit import run_jit_beam_search

WHILE_STASH = "@WHILE_STASH@"
MAX_WHILE_ITERS = 100_000

# reader slots that take a host value as it is (None: every slot)
_COMPARE = ("less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal", "logical_and", "logical_or",
            "logical_xor", "logical_not")
HOST_SLOTS = {
    **{t: ("X", "Y") for t in _COMPARE},
    "increment": ("X",),
    "write_to_array": ("I",), "write_to_array_grad": ("I",),
    "read_from_array": ("I",), "read_from_array_grad": ("I",),
    "shrink_rnn_memory": ("I",), "shrink_rnn_memory_grad": ("I",),
    "while": None, "while_grad": None, "conditional_block": None,
    "conditional_block_grad": None,
}

# what the handlers counted since the last reset: loop iterations, and
# host reads of device values (a condition or index that was not a host
# value)
stats = {"while_iterations": 0, "host_reads": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def host_names(program) -> frozenset:
    """The outputs of ``program``'s ``fill_constant`` ops (in any block)
    that are not persistable and whose every reader, in any block, reads
    them in a slot of :data:`HOST_SLOTS`.  Cached per program version."""
    cached = getattr(program, "_host_names_cache", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    readers: Dict[str, list] = {}
    consts = set()
    for block in program.blocks:
        for op in block.ops:
            for slot, names in op.inputs.items():
                for n in names:
                    if n:
                        readers.setdefault(n, []).append((op.type, slot))
            if op.type == "fill_constant":
                for n in op.output_arg_names:
                    if n and not (block._has_var_recursive(n) and
                                  block._var_recursive(n).persistable):
                        consts.add(n)

    def _takes_host(op_type, slot):
        slots = HOST_SLOTS.get(op_type, ())
        return slots is None or slot in slots

    out = frozenset(n for n in consts if readers.get(n) and all(
        _takes_host(t, s) for t, s in readers[n]))
    program._host_names_cache = (program._version, out)
    return out


def _truth(v, what) -> bool:
    if v is None:
        raise RuntimeError(f"{what}: condition variable is undefined")
    if isinstance(v, torch.Tensor):
        stats["host_reads"] += 1
        return bool(v.reshape(-1)[0].item())
    return bool(np.asarray(v).reshape(-1)[0])


def _snap(v):
    """A value as it stands: tensor arrays are copied (later writes make
    new lists, but a stash must not see them)."""
    return v.clone() if isinstance(v, TensorArray) else v


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _is_float_array(v) -> bool:
    return isinstance(v, TensorArray) and bool(v.vals) and all(
        _is_float(x) for x in v.vals if x is not None)


def _check_replayable(body, what):
    for bop in body.ops:
        d = _reg.REGISTRY.get(bop.type)
        if d is not None and d.stateful:
            raise NotImplementedError(
                f"{what}: stateful op '{bop.type}' inside the body cannot "
                f"be replayed for gradients (its random numbers would "
                f"differ); move it outside")


def _leaf(v):
    """``v`` with every float tensor (or array entry) detached into a leaf
    that requires grad, and the list of those leaves."""
    if isinstance(v, TensorArray):
        vals = [x.detach().requires_grad_() if _is_float(x) else x
                for x in v.vals]
        return TensorArray(vals, list(v.lods)), [x for x in vals
                                                 if _is_float(x)]
    leaf = v.detach().requires_grad_()
    return leaf, [leaf]


def _out_grads(op, env):
    """{Out name: its grad} for the ``Out`` values whose grad the run
    holds."""
    og_names = op.inputs.get("Out@GRAD", [])
    grads = {}
    for i, n in enumerate(op.inputs.get("Out", [])):
        if n and i < len(og_names) and og_names[i]:
            g = env.get(og_names[i])
            if g is not None:
                grads[n] = g
    return grads


def _grads_of(env2, out_grads, leaves_of, pre):
    """``torch.autograd.grad`` of the ``Out`` values in ``env2`` (with
    their grads as cotangents) with respect to ``leaves_of``: {name:
    grad}, zeros where a leaf is unused."""
    primals, cots = [], []
    for n, g in out_grads.items():
        v = env2.get(n)
        if _is_float(v) and v.requires_grad:
            primals.append(v)
            cots.append(g.to(v.dtype))
        elif isinstance(v, TensorArray):
            gvals = g.vals if isinstance(g, TensorArray) else []
            for i, p in enumerate(v.vals):
                if _is_float(p) and p.requires_grad:
                    gi = gvals[i] if i < len(gvals) else None
                    primals.append(p)
                    cots.append(torch.zeros_like(p) if gi is None
                                else gi.to(p.dtype))
    flat = [leaf for _, (_, ls) in leaves_of.items() for leaf in ls]
    got = list(torch.autograd.grad(primals, flat, cots, allow_unused=True)) \
        if primals and flat else [None] * len(flat)
    grads, k = {}, 0
    for n, (val, ls) in leaves_of.items():
        gs = [torch.zeros_like(leaf) if g is None else g
              for leaf, g in zip(ls, got[k:k + len(ls)])]
        k += len(ls)
        if isinstance(val, TensorArray):
            it = iter(gs)
            grads[n] = TensorArray(
                [next(it) if _is_float(x) else None for x in val.vals],
                list(pre[n].lods))
        else:
            grads[n] = gs[0]
    return grads


def run_while(op, env, device, generator, run_op):
    body = op.block.program.block(op.attr("sub_block"))
    cond_name = op.inputs["Condition"][0]
    env.setdefault(WHILE_STASH, {})[op.attr("sub_block")] = {
        n: _snap(env.get(n)) for n in op.inputs.get("X", []) if n}
    it = 0
    while _truth(env.get(cond_name), "while"):
        for bop in body.ops:
            run_op(bop, env, device, generator)
        it += 1
        if it > MAX_WHILE_ITERS:
            raise RuntimeError(f"while: exceeded max iterations "
                               f"({MAX_WHILE_ITERS}); non-terminating loop?")
    stats["while_iterations"] += it


def run_while_grad(op, env, device, generator, run_op):
    """The loop replayed from its stashed inputs under autograd; grads of
    tensors and of tensor arrays' entries (an array's grad is an
    array)."""
    sub_idx = op.attr("sub_block")
    body = op.block.program.block(sub_idx)
    pre = env.get(WHILE_STASH, {}).get(sub_idx)
    if pre is None:
        raise RuntimeError("while_grad: forward while was never executed")
    _check_replayable(body, "while_grad")
    x_names = [n for n in op.inputs.get("X", []) if n]
    want = {x: g for x, g in zip(x_names, op.outputs.get("X@GRAD", []))
            if g}
    out_grads = _out_grads(op, env)
    diff = [n for n in want if _is_float(pre.get(n))
            or _is_float_array(pre.get(n))]
    if not diff:
        return
    cond_name = op.inputs["Condition"][0]
    env2 = {k: _snap(v) for k, v in env.items() if k != WHILE_STASH}
    env2.update({k: _snap(v) for k, v in pre.items()})  # rewind
    leaves_of = {}
    for n in diff:
        env2[n], ls = _leaf(pre[n])
        leaves_of[n] = (pre[n], ls)
    with torch.enable_grad():
        it = 0
        while _truth(env2.get(cond_name), "while_grad replay"):
            for bop in body.ops:
                run_op(bop, env2, device, None)
            it += 1
            if it > MAX_WHILE_ITERS:
                raise RuntimeError("while_grad: runaway replay")
        grads = _grads_of(env2, out_grads, leaves_of, pre)
    for x, gname in want.items():
        g = grads.get(x)
        if g is None:
            continue
        prev = env.get(gname)
        env[gname] = g if prev is None or isinstance(g, TensorArray) \
            else prev + g


def cond_all(cond_vals, op) -> bool:
    """Whether a ``conditional_block``'s conditions hold: the first one's
    first element for a scalar condition, else every element of each."""
    if not cond_vals:
        raise RuntimeError("conditional_block: missing Cond input")
    if bool(op.attr("is_scalar_condition", False)):
        return _truth(cond_vals[0], "conditional_block")
    ok = True
    for v in cond_vals:
        if isinstance(v, torch.Tensor):
            stats["host_reads"] += 1
            ok = ok and bool(v.all().item())
        else:
            ok = ok and bool(np.asarray(v).all())
    return ok


def run_conditional_block(op, env, device, generator, run_op):
    sub_idx = op.attr("sub_block")
    stash = env.setdefault(WHILE_STASH, {})
    cond_vals = [env.get(n) for n in op.inputs.get("Cond", []) if n]
    taken = cond_all(cond_vals, op)
    stash[("taken", sub_idx)] = taken
    if not taken:
        return
    stash[sub_idx] = {n: env.get(n) for n in op.inputs.get("Input", [])
                      if n}
    for bop in op.block.program.block(sub_idx).ops:
        run_op(bop, env, device, generator)


def run_conditional_block_grad(op, env, device, generator, run_op):
    sub_idx = op.attr("sub_block")
    stash = env.get(WHILE_STASH, {})
    in_names = [n for n in op.inputs.get("Input", []) if n]
    want = {x: g for x, g in zip(in_names, op.outputs.get("Input@GRAD", []))
            if g}
    if not stash.get(("taken", sub_idx)):
        for x, gname in want.items():
            if _is_float(env.get(x)):
                env[gname] = torch.zeros_like(env[x])
        return
    body = op.block.program.block(sub_idx)
    _check_replayable(body, "conditional_block_grad")
    pre = stash.get(sub_idx, {})
    diff = [n for n in want if _is_float(pre.get(n))]
    if not diff:
        return
    env2 = {k: v for k, v in env.items() if k != WHILE_STASH}
    env2.update(pre)
    leaves_of = {}
    for n in diff:
        env2[n], ls = _leaf(pre[n])
        leaves_of[n] = (pre[n], ls)
    with torch.enable_grad():
        for bop in body.ops:
            run_op(bop, env2, device, None)
        grads = _grads_of(env2, _out_grads(op, env), leaves_of, pre)
    for x, gname in want.items():
        if x in grads:
            env[gname] = grads[x]


HANDLERS = {
    "while": run_while,
    "while_grad": run_while_grad,
    "conditional_block": run_conditional_block,
    "conditional_block_grad": run_conditional_block_grad,
    "jit_beam_search": run_jit_beam_search,
}
