"""Test and inference programs of the port against the JAX package, on the
CPU:

 - ``Program.clone()`` and ``clone(for_test=True)``, ``_prune`` (plain and
   without Backward / Optimize ops), ``inference_optimize`` and
   ``io.get_inference_program`` give the same op lists (type, slots,
   attrs) and variables in both packages, for the tiny Transformer
   (unfused, flash, and with the noam schedule), the cifar ResNet and the
   MNIST mlp (exact: the IR is data);
 - ``serialize_to_string`` / ``parse_from_string`` round-trips a program,
   and refuses a blob the JAX package wrote;
 - one run of the test clone changes the same persistables in both
   packages and leaves the same ones bitwise unchanged (the noam
   schedule's step counter moves: its ``increment`` carries the Forward
   role), with the same fetched loss (rtol 1e-5).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import resnet as ref_rn
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import mnist as port_mnist
from paddle_tpu_torch.models import resnet as port_rn
from paddle_tpu_torch.models import transformer as port_tm

B, L = 2, 8
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(prog):
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for b in prog.blocks for op in b.ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _transformer(pkg, tm, flash=False, warmup=None, dropout=0.1):
    cfg = tm.tiny_config()
    cfg.flash_attention = flash
    cfg.dropout = dropout
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L,
                                 warmup_steps=warmup)
    xent = next(op for op in main.global_block().ops
                if op.type == "softmax_with_cross_entropy")
    logits = main.global_block().var(xent.input("Logits")[0])
    return main, startup, [logits, cost], cost


def _resnet(pkg, rn):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, prediction, loss, _ = rn.build(
            class_dim=10, image_shape=(3, 32, 32), lr=0.1)
    return main, startup, [prediction], loss


def _mlp(pkg, mnist):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, prediction, loss, _ = mnist.mlp()
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [prediction], loss


CASES = {
    "transformer": lambda pkg, m: _transformer(pkg, m["tm"]),
    "transformer_flash": lambda pkg, m: _transformer(pkg, m["tm"],
                                                      flash=True),
    "transformer_noam": lambda pkg, m: _transformer(pkg, m["tm"],
                                                     warmup=4),
    "resnet_cifar": lambda pkg, m: _resnet(pkg, m["rn"]),
    "mnist_mlp": lambda pkg, m: _mlp(pkg, m["mnist"]),
}
REF = {"pkg": rf, "mods": {"tm": ref_tm, "rn": ref_rn, "mnist": ref_mnist}}
PORT = {"pkg": tf, "mods": {"tm": port_tm, "rn": port_rn,
                            "mnist": port_mnist}}


def _both(case):
    ref_framework.fresh_session()
    ref = CASES[case](REF["pkg"], REF["mods"])
    port = CASES[case](PORT["pkg"], PORT["mods"])
    return ref, port


def _same(ref_prog, port_prog):
    assert _ops(port_prog) == _ops(ref_prog)
    assert _vars(port_prog, port_core) == _vars(ref_prog, ref_core)


DERIVED = {
    "clone": lambda p, t, pkg: p.clone(),
    "clone_for_test": lambda p, t, pkg: p.clone(for_test=True),
    "prune": lambda p, t, pkg: p._prune(t),
    "prune_drop_roles": lambda p, t, pkg: p._prune(
        t, drop_roles=(pkg.framework.OpRole.Backward,
                       pkg.framework.OpRole.Optimize)),
    "inference_optimize": lambda p, t, pkg: p.inference_optimize(),
    "get_inference_program": lambda p, t, pkg:
        pkg.io.get_inference_program(t[:1], main_program=p),
}


@pytest.mark.parametrize("how", sorted(DERIVED))
@pytest.mark.parametrize("case", sorted(CASES))
def test_derived_program_matches_reference(case, how):
    (rmain, _, rt, _), (pmain, _, pt, _) = _both(case)
    _same(rmain, pmain)
    rd = DERIVED[how](rmain, rt, rf)
    pd = DERIVED[how](pmain, pt, tf)
    _same(rd, pd)
    assert pd is not pmain and pd._cache_token != pmain._cache_token
    assert pd.random_seed == pmain.random_seed
    if how == "clone_for_test":
        roles = {op.attr("op_role") for op in pd.global_block().ops}
        assert not any(r & 1 or r == 2 for r in roles)
        for op in pd.global_block().ops:
            if op.type in ("dropout", "batch_norm"):
                assert op.attr("is_test") is True


@pytest.mark.parametrize("case", sorted(CASES))
def test_serialize_round_trip(case):
    _, (pmain, _, _, _) = _both(case)
    back = tf.Program.parse_from_string(pmain.serialize_to_string())
    assert isinstance(back, tf.Program) and back is not pmain
    assert _ops(back) == _ops(pmain)
    assert _vars(back, port_core) == _vars(pmain, port_core)
    _same(pmain.clone(for_test=True), back.clone(for_test=True))


def test_parse_refuses_a_reference_blob():
    (rmain, _, _, _), _ = _both("mnist_mlp")
    with pytest.raises(ValueError, match="rebuild it with paddle_tpu_torch"):
        tf.Program.parse_from_string(rmain.serialize_to_string())
    blob = rf.Program().serialize_to_string()
    with pytest.raises(ValueError, match="paddle_tpu.fluid.framework"):
        tf.Program.parse_from_string(blob)


def test_parse_refuses_other_callables():
    import pickle

    with pytest.raises(ValueError, match="may not name"):
        tf.Program.parse_from_string(pickle.dumps(
            {"version": 1, "program": print}))


def _feed(case):
    rng = np.random.RandomState(0)
    if case.startswith("transformer"):
        return {"src_word": rng.randint(1, 1000, (B, L)).astype(np.int64),
                "tgt_word": rng.randint(1, 1000, (B, L)).astype(np.int64),
                "lbl_word": rng.randint(1, 1000, (B, L, 1)).astype(np.int64)}
    return {"img": rng.normal(size=(B, 3, 32, 32)).astype(np.float32),
            "label": rng.randint(0, 10, (B, 1)).astype(np.int64)}


@pytest.mark.parametrize("case", ["transformer_noam", "resnet_cifar"])
def test_eval_clone_changes_the_same_persistables(case):
    """The JAX package's initial state carried to the port; one run of
    each package's test clone fetching the loss: the same persistables
    change (by name), every other one stays bitwise, and the losses agree."""
    ref, port = _both(case)
    results, init = [], None
    for pkg, (main, startup, _, loss) in ((rf, ref), (tf, port)):
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable
                       and scope.get(v.name) is not None)
        if init is None:
            init = {n: np.array(scope.get(n)) for n in names}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        test = main.clone(for_test=True)
        (val,) = exe.run(test, feed=_feed(case), fetch_list=[loss],
                         scope=scope)
        after = {n: np.array(scope.get(n)) for n in names}
        changed = sorted(n for n in names
                         if not np.array_equal(after[n], init[n]))
        results.append((changed, float(np.asarray(val).reshape(-1)[0])))
    (rchanged, rloss), (pchanged, ploss) = results
    assert pchanged == rchanged
    if case == "transformer_noam":
        assert pchanged == ["@STEP_COUNTER@"]
    else:
        assert pchanged == []
    np.testing.assert_allclose(ploss, rloss, rtol=LOSS_RTOL)
