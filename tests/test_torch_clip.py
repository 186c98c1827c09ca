"""Gradient and error clipping and L1 decay (``paddle_tpu_torch/fluid/
clip.py``, ``regularizer.py``) against the JAX package, on the CPU:

 - the same calls build the same Programs (ops, attrs, variable names,
   shapes and dtypes), with the clip ops between the backward and the
   update ops, so a run of ``adam`` ops stays one group;
 - ``chip_smoke.clip_mlp_programs``' MLP under each kind (global norm,
   norm, value, error clip, ``SGD(regularization=L1Decay)``) and
   ``chip_smoke.bert_clip_programs``' tiny BERT under global-norm clipping
   at 1.0 (Google BERT's recipe) follow the reference's trajectory for 5
   steps from the reference's initial scope: losses (and the group norm
   and scale) at rtol 1e-5 at step 0 and 1e-4 after.  Each run asserts
   that its clip acted on some step (``chip_smoke.clip_active``: the group
   scale below 1, a grad at its bound), so none can pass on the unclipped
   branch.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import bert as ref_bert
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models.params import load_reference_params

STEPS = 5
RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))
BATCH, SEQ, N_MASK = 2, 32, 4


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _program(prog):
    block = prog.global_block()
    ops = [(op.type, {s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if k != "op_callstack"})
           for op in block.ops]
    var_list = sorted((v.name, None if v.shape is None else tuple(v.shape),
                       str(v.dtype)) for v in block.vars.values())
    return ops, var_list


def _steps(pkg, progs, feed, fetch, init=None, steps=STEPS):
    """``steps`` runs of main on the CPU from ``init`` (else from the
    startup's own state, returned): the fetches of each step by name."""
    main, startup = progs[:2]
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    out = []
    for _ in range(steps):
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        out.append({n: np.asarray(v) for n, v in zip(fetch, vals)})
    return out, init


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


@pytest.mark.parametrize("kind", sorted(chip_smoke.CLIP_BOUNDS))
def test_mlp_clip_matches_reference(kind):
    rprogs = chip_smoke.clip_mlp_programs(rf, kind)
    pprogs = chip_smoke.clip_mlp_programs(tf, kind)
    for r, p in zip(rprogs[:2], pprogs[:2]):
        assert _program(p) == _program(r)
    names = pprogs[2]
    assert names == rprogs[2]
    types = [op.type for op in pprogs[0].global_block().ops]
    first_update = types.index("sgd")
    assert set(types[first_update:]) == {"sgd"}
    want = {"global_norm": "sqrt", "norm": "clip_by_norm", "value": "clip",
            "error": "clip", "l1_decay": "sign"}[kind]
    assert want in types[:first_update]
    fetch = [names["loss"], names["hidden_grad"]] + names["grads"] + [
        names[k] for k in ("norm", "scale") if k in names]
    feed = chip_smoke.clip_mlp_feed()
    ref, init = _steps(rf, rprogs, feed, fetch)
    port, _ = _steps(tf, pprogs, feed, fetch, init)
    for step, (r, p) in enumerate(zip(ref, port)):
        for n in [names["loss"]] + [names[k] for k in ("norm", "scale")
                                    if k in names]:
            np.testing.assert_allclose(p[n], r[n], rtol=RTOL[step],
                                       err_msg=f"{n} step {step}")
    assert any(chip_smoke.clip_active(kind, names, p) for p in port)
    assert any(chip_smoke.clip_active(kind, names, r) for r in ref)


def _bert(pkg, model, flash=False):
    cfg = model.tiny_config()
    cfg.flash_attention = flash
    return chip_smoke.bert_clip_programs(pkg, model, cfg, SEQ, N_MASK, 1e-3,
                                         seed=3)


def test_bert_clip_program_matches_reference():
    """The same Programs, the clip's ops between the backward and one
    consecutive run of the adam ops (one group launch on the card)."""
    rmain, rstart, rnames = _bert(rf, ref_bert)
    pmain, pstart, pnames = _bert(tf, port_bert)
    assert pnames == rnames
    for r, p in ((rstart, pstart), (rmain, pmain)):
        assert _program(p) == _program(r)
    types = [op.type for op in pmain.global_block().ops]
    adam = [i for i, t in enumerate(types) if t == "adam"]
    assert adam == list(range(adam[0], adam[0] + len(adam)))
    assert len(adam) == len(pnames["grads"]) == 39
    # 39 squares and sums, their sum and sqrt, the fill, max and div, and
    # 39 products: between the last grad op and the first adam
    clip_ops = types[adam[0] - 3 * 39 - 5:adam[0]]
    assert clip_ops.count("elementwise_mul") == 2 * 39
    assert clip_ops.count("reduce_sum") == 39
    assert {"sum", "sqrt", "fill_constant", "elementwise_max",
            "elementwise_div"} <= set(clip_ops)


def test_bert_clip_trajectory_matches_reference():
    feed = ref_bert.synthetic_batch(ref_bert.tiny_config(), BATCH, SEQ,
                                    N_MASK, np.random.RandomState(0))
    feed["src_ids"][1, -5:] = 0
    rprogs, pprogs = _bert(rf, ref_bert), _bert(tf, port_bert)
    names = pprogs[2]
    fetch = [names[k] for k in ("loss", "mlm", "nsp", "norm", "scale")]
    ref, init = _steps(rf, rprogs, feed, fetch)
    port, _ = _steps(tf, pprogs, feed, fetch, init)
    for step, (r, p) in enumerate(zip(ref, port)):
        for n in fetch:
            np.testing.assert_allclose(p[n], r[n], rtol=RTOL[step],
                                       err_msg=f"{n} step {step}")
    scales = [_first(p[names["scale"]]) for p in port]
    assert min(scales) < 1.0, scales
    for p in port:
        np.testing.assert_allclose(
            _first(p[names["scale"]]),
            1.0 / max(1.0, _first(p[names["norm"]])), rtol=1e-6)
