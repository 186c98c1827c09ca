"""The optimizer groups of the port, on the CPU: a run of consecutive
momentum or adam ops that the Executor hands to one
``fused.momentum_group`` / ``fused.adam_group`` call (one kernel launch on
the card, ``paddle_tpu_torch/csrc/{momentum,adam}.cu``; the plain versions
here):

 - a Program of momentum or adam ops over a mixed list of shapes
   (lane-aligned, ragged, 1-element), each with its own learning rate and,
   for adam, beta pows of its own step count, runs as one group through
   the Executor and agrees with the JAX package's Pallas sweeps
   ``pf.fused_momentum`` / ``pf.fused_adam`` in interpret mode, Nesterov
   off and on (rtol 1e-6 / atol 1e-6, as ``tests/test_pallas_fused.py``
   holds the Pallas updates; the beta pows ``b1p·b1`` / ``b2p·b2``
   bitwise);
 - the group plain versions equal the per-op arithmetic bitwise;
 - ``BlockPlan`` finds one group of 161 momentum ops in ResNet-50 and one
   of 64 adam ops in Transformer-tiny; it splits a run whose attrs differ
   or whose ops share a written name, and groups nothing across another
   op;
 - 3 training steps through the grouped Executor equal the same Program
   run op by op (``run_op``), bitwise;
 - the group wrappers check what they are given and launch nothing for
   CPU tensors; the card path's table (addresses and sizes) is checked
   here on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as tf
from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu_torch.fluid import executor as port_executor
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import resnet as port_rn
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.ops import fused

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(256, 128), (33, 7), (1,), (512,), (3, 5, 7), (10,)]
B1, B2, EPS = 0.9, 0.98, 1e-9


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _var(block, name, shape):
    block.create_var(name=name, shape=list(shape), dtype="float32",
                     persistable=True)
    return name


def _momentum_op(block, i, shape, mu=0.9, nesterov=False, lr=None):
    p, g, v = (_var(block, f"{k}{i}", shape) for k in ("p", "g", "v"))
    lr = lr or _var(block, f"lr{i}", (1,))
    block.append_op(type="momentum",
                    inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                            "LearningRate": [lr]},
                    outputs={"ParamOut": [p], "VelocityOut": [v]},
                    attrs={"mu": mu, "use_nesterov": nesterov,
                           "op_role": 2, "op_role_var": [p, g]})


def _adam_op(block, i, shape):
    names = {k: _var(block, f"{k}{i}", shape)
             for k in ("p", "g", "m1", "m2")}
    names.update({k: _var(block, f"{k}{i}", (1,))
                  for k in ("lr", "b1p", "b2p")})
    block.append_op(type="adam",
                    inputs={"Param": [names["p"]], "Grad": [names["g"]],
                            "LearningRate": [names["lr"]],
                            "Moment1": [names["m1"]],
                            "Moment2": [names["m2"]],
                            "Beta1Pow": [names["b1p"]],
                            "Beta2Pow": [names["b2p"]]},
                    outputs={"ParamOut": [names["p"]],
                             "Moment1Out": [names["m1"]],
                             "Moment2Out": [names["m2"]],
                             "Beta1PowOut": [names["b1p"]],
                             "Beta2PowOut": [names["b2p"]]},
                    attrs={"beta1": B1, "beta2": B2, "epsilon": EPS,
                           "op_role": 2, "op_role_var": [names["p"],
                                                         names["g"]]})


def _state(kind, shapes):
    """Seeded numpy state for ops 0..n-1: params, grads, moments or
    velocities, own learning rates and (adam) beta pows of own step
    counts."""
    st = {}
    for i, shape in enumerate(shapes):
        st[f"p{i}"] = _rand(shape, 10 * i)
        st[f"g{i}"] = _rand(shape, 10 * i + 1, 1e-2)
        st[f"lr{i}"] = np.array([0.1 / (1 + i)], np.float32)
        if kind == "momentum":
            st[f"v{i}"] = _rand(shape, 10 * i + 2, 1e-2)
        else:
            st[f"m1{i}"] = _rand(shape, 10 * i + 2, 1e-3)
            st[f"m2{i}"] = np.abs(_rand(shape, 10 * i + 3, 1e-4))
            st[f"b1p{i}"] = np.array([B1 ** (1 + 3 * i)], np.float32)
            st[f"b2p{i}"] = np.array([B2 ** (1 + 3 * i)], np.float32)
    return st


def _scope(state):
    scope = tf.Scope()
    for name, arr in state.items():
        scope.set(name, torch.from_numpy(arr.copy()))
    return scope


def _plan_groups(prog):
    plan = port_executor.BlockPlan(prog, [], [])
    return [[plan.ops[k].type for k in run] for run in plan.groups.values()]


# -- through the Executor against the Pallas sweeps -----------------------

@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_momentum_group_matches_pallas(nesterov, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED", "1")
    prog = tf.Program()
    for i, shape in enumerate(SHAPES):
        _momentum_op(prog.global_block(), i, shape, nesterov=nesterov)
    assert _plan_groups(prog) == [["momentum"] * len(SHAPES)]
    state = _state("momentum", SHAPES)
    scope = _scope(state)
    before = (fused.momentum_launches, fused.momentum_tensors)
    tf.Executor(tf.CPUPlace()).run(prog, scope=scope)
    assert (fused.momentum_launches, fused.momentum_tensors) == before
    for i in range(len(SHAPES)):
        ref = pf.fused_momentum(*(jnp.asarray(state[f"{k}{i}"])
                                  for k in ("p", "g", "v")),
                                jnp.float32(state[f"lr{i}"][0]), 0.9,
                                nesterov)
        for name, want in zip(("p", "v"), ref):
            np.testing.assert_allclose(scope.get(f"{name}{i}").numpy(),
                                       np.asarray(want), err_msg=name,
                                       **TOL)


def test_adam_group_matches_pallas(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED", "1")
    prog = tf.Program()
    for i, shape in enumerate(SHAPES):
        _adam_op(prog.global_block(), i, shape)
    assert _plan_groups(prog) == [["adam"] * len(SHAPES)]
    state = _state("adam", SHAPES)
    scope = _scope(state)
    before = (fused.adam_launches, fused.adam_tensors)
    tf.Executor(tf.CPUPlace()).run(prog, scope=scope)
    assert (fused.adam_launches, fused.adam_tensors) == before
    one = np.float32(1.0)
    for i in range(len(SHAPES)):
        b1p, b2p = state[f"b1p{i}"][0], state[f"b2p{i}"][0]
        lr_eff = state[f"lr{i}"][0] * np.sqrt(one - b2p) / (one - b1p)
        ref = pf.fused_adam(*(jnp.asarray(state[f"{k}{i}"])
                              for k in ("p", "g", "m1", "m2")),
                            jnp.float32(lr_eff), B1, B2, EPS)
        for name, want in zip(("p", "m1", "m2"), ref):
            np.testing.assert_allclose(scope.get(f"{name}{i}").numpy(),
                                       np.asarray(want), err_msg=name,
                                       **TOL)
        np.testing.assert_array_equal(scope.get(f"b1p{i}").numpy(),
                                      [b1p * np.float32(B1)])
        np.testing.assert_array_equal(scope.get(f"b2p{i}").numpy(),
                                      [b2p * np.float32(B2)])


# -- the plain versions ---------------------------------------------------

def _tensors(state, keys, n):
    return [[torch.from_numpy(state[f"{k}{i}"]) for i in range(n)]
            for k in keys]


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_momentum_group_ref_is_the_per_op_arithmetic(nesterov):
    n = len(SHAPES)
    ps, gs, vs, lrs = _tensors(_state("momentum", SHAPES),
                               ("p", "g", "v", "lr"), n)
    got = fused.momentum_group_ref(ps, gs, vs, lrs, 0.9, nesterov)
    for (p, v), p0, g, v0, lr in zip(got, ps, gs, vs, lrs):
        want_v = 0.9 * v0 + g
        want_p = (p0 - (g + 0.9 * want_v) * lr if nesterov
                  else p0 - lr * want_v)
        torch.testing.assert_close(v, want_v, rtol=0, atol=0)
        torch.testing.assert_close(p, want_p, rtol=0, atol=0)


def test_adam_group_ref_is_the_per_op_arithmetic():
    """The adam op's arithmetic before groups: ``lr_eff`` from the [1]
    tensors, ``adam_ref``, and the pows as new tensors."""
    n = len(SHAPES)
    cols = _tensors(_state("adam", SHAPES),
                    ("p", "g", "m1", "m2", "lr", "b1p", "b2p"), n)
    got = fused.adam_group_ref(*cols, B1, B2, EPS)
    for out, (p, g, m1, m2, lr, b1p, b2p) in zip(got, zip(*cols)):
        lr_eff = lr.reshape(1) * (1.0 - b2p.reshape(1)).sqrt() / (
            1.0 - b1p.reshape(1))
        want = (*fused.adam_ref(p, g, m1, m2, lr_eff, B1, B2, EPS),
                (b1p * B1).reshape(1), (b2p * B2).reshape(1))
        for a, w in zip(out, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_group_wrappers_update_in_place_like_their_plain_versions():
    n = len(SHAPES)
    state = _state("adam", SHAPES)
    cols = _tensors(state, ("p", "g", "m1", "m2", "lr", "b1p", "b2p"), n)
    want = fused.adam_group_ref(*cols, B1, B2, EPS)
    got = [[t.clone() for t in col] for col in cols]
    b1ps, b2ps = fused.adam_group(*got, B1, B2, EPS)
    assert b1ps is got[5] and b2ps is got[6]
    for k, col in enumerate((0, 2, 3, 5, 6)):
        for a, w in zip(got[col], want):
            torch.testing.assert_close(a, w[k], rtol=0, atol=0)
    state = _state("momentum", SHAPES)
    cols = _tensors(state, ("p", "g", "v", "lr"), n)
    want = fused.momentum_group_ref(*cols, 0.9, True)
    got = [[t.clone() for t in col] for col in cols]
    fused.momentum_group(*got, 0.9, True)
    for (p, v), (wp, wv) in zip(zip(got[0], got[2]), want):
        torch.testing.assert_close(p, wp, rtol=0, atol=0)
        torch.testing.assert_close(v, wv, rtol=0, atol=0)


# -- where the plan groups ---------------------------------------------------

def test_plan_groups_resnet50_momentum():
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        _, _, _, loss, _ = port_rn.build(class_dim=10, depth=50,
                                         image_shape=(3, 64, 64), lr=0.01)
    plan = port_executor.BlockPlan(main, ["img", "label"], [loss.name])
    assert [len(run) for run in plan.groups.values()] == [161]
    assert {plan.ops[k].type for run in plan.groups.values()
            for k in run} == {"momentum"}
    # one call for the 161 updates: 536 ops run as 376 dispatches
    assert len(main.global_block().ops) - len(plan.grouped) == 376


def test_plan_groups_transformer_tiny_adam():
    cfg = port_tm.tiny_config()
    cfg.flash_attention = False
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tf.unique_name.guard():
        _, _, _, cost = port_tm.build(cfg, src_len=8, tgt_len=8)
    plan = port_executor.BlockPlan(main, ["src_word", "tgt_word",
                                          "lbl_word"], [cost.name])
    runs = list(plan.groups.values())
    assert [len(run) for run in runs] == [64]
    assert {plan.ops[k].type for k in runs[0]} == {"adam"}
    assert sum(op.type == "adam" for op in main.global_block().ops) == 64


def test_plan_splits_a_run_whose_attrs_differ():
    prog = tf.Program()
    block = prog.global_block()
    lr = _var(block, "lr", (1,))
    for i, mu in enumerate((0.9, 0.9, 0.9, 0.5, 0.5)):
        _momentum_op(block, i, (4,), mu=mu, lr=lr)
    plan = port_executor.BlockPlan(prog, [], [])
    assert list(plan.groups.values()) == [[0, 1, 2], [3, 4]]
    prog = tf.Program()
    for i, nesterov in enumerate((False, True, True)):
        _momentum_op(prog.global_block(), i, (4,), nesterov=nesterov)
    assert list(port_executor.BlockPlan(prog, [], []).groups.values()) \
        == [[1, 2]]


def test_plan_groups_nothing_across_another_op():
    """Two momentum ops, a ``scale`` making the next ops' learning rate
    (as a parameter with its own ``learning_rate`` gets one), two more."""
    prog = tf.Program()
    block = prog.global_block()
    lr = _var(block, "lr", (1,))
    lr2 = block.create_var(name="lr2", shape=[1], dtype="float32")
    _momentum_op(block, 0, (4,), lr=lr)
    _momentum_op(block, 1, (5,), lr=lr)
    block.append_op(type="scale", inputs={"X": [lr]},
                    outputs={"Out": [lr2.name]}, attrs={"scale": 2.0})
    _momentum_op(block, 2, (6,), lr="lr2")
    _momentum_op(block, 3, (7,), lr="lr2")
    plan = port_executor.BlockPlan(prog, [], [])
    assert [op.type for op in plan.ops] == ["momentum"] * 2 + ["scale"] \
        + ["momentum"] * 2
    assert list(plan.groups.values()) == [[0, 1], [3, 4]]


def test_plan_splits_ops_that_share_a_written_name():
    """The same parameter updated twice in a row: the second update reads
    what the first writes, so each runs on its own, in order."""
    prog = tf.Program()
    block = prog.global_block()
    _momentum_op(block, 0, (4,))
    _momentum_op(block, 1, (4,))
    block.ops.append(block.ops[0])  # p0 again, after p1
    block.ops.append(block.ops[0])
    plan = port_executor.BlockPlan(prog, [], [])
    assert list(plan.groups.values()) == [[0, 1]]
    state = _state("momentum", [(4,), (4,)])
    scope = _scope(state)
    tf.Executor(tf.CPUPlace()).run(prog, scope=scope)
    p, v = torch.from_numpy(state["p0"]), torch.from_numpy(state["v0"])
    lr, g = torch.from_numpy(state["lr0"]), torch.from_numpy(state["g0"])
    for _ in range(3):
        p, v = fused.momentum_ref(p, g, v, lr, 0.9, False)
    torch.testing.assert_close(scope.get("p0"), p, rtol=0, atol=0)
    torch.testing.assert_close(scope.get("v0"), v, rtol=0, atol=0)


# -- grouped against op by op ---------------------------------------------

def _run_op_by_op(program, feed, fetch, scope, seed):
    """The Program's ops one at a time through ``run_op``, no groups: the
    scope's state in, every persistable written back."""
    block = program.global_block()
    env = {}
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in env and scope.get(n) is not None:
                env[n] = scope.get(n)
    env.update({k: torch.as_tensor(np.asarray(v)) for k, v in feed.items()})
    gen = torch.Generator().manual_seed(seed)
    for op in block.ops:
        port_executor.run_op(op, env, torch.device("cpu"), gen)
    for name, var in block.vars.items():
        if var.persistable and name in env:
            scope.set(name, env[name])
    return env[fetch].numpy()


def _resnet_case():
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 1
    with tf.program_guard(main, startup), tf.unique_name.guard():
        _, _, _, loss, _ = port_rn.build(class_dim=10, depth=50,
                                         image_shape=(3, 32, 32), lr=0.01)
    rng = np.random.default_rng(3)
    feed = {"img": rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (2, 1)).astype(np.int64)}
    return main, startup, loss, feed


def _transformer_case():
    cfg = port_tm.tiny_config()
    cfg.flash_attention = False
    cfg.dropout = 0.0
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 1
    with tf.program_guard(main, startup), tf.unique_name.guard():
        _, _, _, cost = port_tm.build(cfg, src_len=8, tgt_len=8)
    rng = np.random.default_rng(4)
    v = cfg.src_vocab_size
    feed = {"src_word": rng.integers(1, v, (2, 8)),
            "tgt_word": rng.integers(1, v, (2, 8)),
            "lbl_word": rng.integers(1, v, (2, 8, 1))}
    return main, startup, cost, feed


@pytest.mark.parametrize("case", ["resnet50_momentum", "transformer_adam"])
def test_grouped_run_equals_op_by_op(case):
    main, startup, loss, feed = (_resnet_case() if case.startswith("resnet")
                                 else _transformer_case())
    exe = tf.Executor(tf.CPUPlace())
    grouped, by_op = tf.Scope(), tf.Scope()
    exe.run(startup, scope=grouped)
    for name in (v.name for v in startup.list_vars() if v.persistable):
        by_op.set(name, grouped.get(name).clone())
    kind = "momentum" if case.startswith("resnet") else "adam"
    before = getattr(fused, f"{kind}_launches")
    for _ in range(3):
        a = exe.run(main, feed=feed, fetch_list=[loss], scope=grouped)[0]
        b = _run_op_by_op(main, feed, loss.name, by_op, main.random_seed)
        np.testing.assert_array_equal(a, b)
    assert getattr(fused, f"{kind}_launches") == before
    for name in (v.name for v in startup.list_vars() if v.persistable):
        torch.testing.assert_close(grouped.get(name), by_op.get(name),
                                   rtol=0, atol=0, msg=name)


# -- the wrappers' checks ---------------------------------------------------

def test_group_wrappers_check_their_entries():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="one of each"):
        fused.momentum_group([p], [p.clone()], [], [torch.ones(1)], 0.9,
                             False)
    with pytest.raises(ValueError, match="share a shape"):
        fused.adam_group([p], [torch.zeros(5)], [p.clone()], [p.clone()],
                         [torch.ones(1)], [torch.ones(1)], [torch.ones(1)],
                         B1, B2, EPS)
    with pytest.raises(ValueError, match="beta1_pow must hold one value"):
        fused.adam_group([p], [p.clone()], [p.clone()], [p.clone()],
                         [torch.ones(1)], [torch.ones(2)], [torch.ones(1)],
                         B1, B2, EPS)
    with pytest.raises(ValueError, match="appears in it twice"):
        fused.momentum_group([p, p], [p.clone(), p.clone()],
                             [torch.zeros(4), torch.zeros(4)],
                             [torch.ones(1)] * 2, 0.9, False)
    fused.momentum_group([], [], [], [], 0.9, False)  # nothing to do


def test_group_wrappers_have_no_fallback_off_the_cpu():
    p = torch.empty(8, device="meta")
    one = torch.empty(1, device="meta")
    before = (fused.momentum_launches, fused.adam_launches,
              fused.momentum_tensors, fused.adam_tensors)
    with pytest.raises(ValueError, match="CUDA"):
        fused.momentum_group([p], [p], [p], [one], 0.9, False)
    with pytest.raises(ValueError, match="CUDA"):
        fused.adam_group([p], [p], [p], [p], [one], [one], [one], B1, B2,
                         EPS)
    with pytest.raises(ValueError, match="CUDA"):
        fused.adam_group([torch.zeros(8)], [p], [p], [p], [one], [one],
                         [one], B1, B2, EPS)
    assert (fused.momentum_launches, fused.adam_launches,
            fused.momentum_tensors, fused.adam_tensors) == before


def test_card_table_holds_addresses_and_sizes():
    """The table the card path hands the kernel (built here from CPU
    tensors): param, grad, state and one-value addresses, then sizes;
    grads are read afresh each call, the rest checked once per set of
    objects."""
    ps = [torch.zeros(3, 4), torch.zeros(5)]
    vs = [torch.zeros(3, 4), torch.zeros(5)]
    lrs = [torch.ones(1)] * 2
    for _ in range(2):
        gs = [torch.ones(3, 4), torch.ones(5)]
        cols = fused._group_cols("momentum", ps, gs, {"velocity": vs},
                                 {"lr": lrs})
        assert cols.tolist() == [t.data_ptr() for t in ps + gs + vs + lrs] \
            + [12, 5]
    with pytest.raises(ValueError, match="share a shape"):
        fused._group_cols("momentum", ps, [torch.ones(12), torch.ones(5)],
                          {"velocity": vs}, {"lr": lrs})
    with pytest.raises(TypeError, match="grad must be"):
        fused._group_cols("momentum", ps, [gs[0].double(), gs[1]],
                          {"velocity": vs}, {"lr": lrs})
    with pytest.raises(ValueError, match="contiguous"):
        fused._group_cols("momentum", ps, [torch.ones(4, 3).t(), gs[1]],
                          {"velocity": vs}, {"lr": lrs})
    # a state replaced by another object is checked again
    with pytest.raises(TypeError, match="velocity must be"):
        fused._group_cols("momentum", ps, gs,
                          {"velocity": [vs[0].double(), vs[1]]}, {"lr": lrs})


def test_card_table_reads_rates_afresh():
    """LARS hands the group a new rate tensor each step: its address
    comes from each call (between the states and the beta pows for
    Adam), and a rate that does not suit the kernel raises though the
    persistent set is cached."""
    ps = [torch.zeros(3, 4), torch.zeros(5)]
    m1s, m2s = [torch.zeros(3, 4), torch.zeros(5)], \
        [torch.zeros(3, 4), torch.zeros(5)]
    b1ps, b2ps = [torch.ones(1), torch.ones(1)], [torch.ones(1),
                                                  torch.ones(1)]
    gs = [torch.ones(3, 4), torch.ones(5)]
    for _ in range(3):
        lrs = [torch.full((1,), 0.1), torch.full((1,), 0.2)]
        cols = fused._group_cols(
            "adam", ps, gs, {"moment1": m1s, "moment2": m2s},
            {"lr": lrs, "beta1_pow": b1ps, "beta2_pow": b2ps})
        assert cols.tolist() == [t.data_ptr() for t in
                                 ps + gs + m1s + m2s + lrs + b1ps + b2ps] \
            + [12, 5]
    with pytest.raises(TypeError, match="lr must be"):
        fused._group_cols("adam", ps, gs, {"moment1": m1s, "moment2": m2s},
                          {"lr": [lrs[0].double(), lrs[1]],
                           "beta1_pow": b1ps, "beta2_pow": b2ps})
    with pytest.raises(ValueError, match="lr must hold one value"):
        fused._group_cols("adam", ps, gs, {"moment1": m1s, "moment2": m2s},
                          {"lr": [torch.ones(2), lrs[1]],
                           "beta1_pow": b1ps, "beta2_pow": b2ps})
