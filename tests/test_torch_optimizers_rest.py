"""The seven remaining optimizers of the port (``ops/optimizer_ops.py``:
adagrad, adamax, decayed_adagrad, adadelta, ftrl, proximal_gd,
proximal_adagrad) against the JAX package, on the CPU:

 - each optimizer (``chip_smoke.OPTIMIZER_ARGS``; FTRL at both
   ``lr_power`` branches, the proximal ops with l1 and l2 > 0) on a small
   tanh MLP builds the reference's Programs from the same builder calls
   (op types, slots, attrs, variables) and follows its trajectory for 5
   steps from the reference's initial scope: losses at rtol 1e-5 at step 0
   and 1e-4 after, and at the end every parameter and accumulator;
 - the five ops that fold a SelectedRows grad also through an
   ``is_sparse`` embedding (the state within 1e-5 of its largest
   magnitude: duplicate ids add in another order);
 - the proximal ops refuse a SelectedRows grad in both packages (the
   port's error names the op);
 - one op a shape over a few shapes (``chip_smoke.optim_op_program``)
   follows the reference op for op, and the Executor's group call for
   the run equals the same ops run one by one, bitwise.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

STEPS = 5
RTOL = np.array([1e-5] + [1e-4] * (STEPS - 1))
STATE_TOL = (1e-4, 1e-6)  # rtol, atol as a share of the largest magnitude
# a SelectedRows grad's duplicate ids add in another order in each package,
# and FTRL's weights, made from the sums, carry that rounding up to ~4e-6
# of the largest weight in 5 steps
SPARSE_STATE_TOL = (1e-4, 1e-5)
KINDS = sorted(chip_smoke.OPTIMIZER_ARGS)
SHAPES = [(6, 5), (5,), (3, 4, 2), (1,)]


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
                       str(v.dtype), v.persistable)
                      for v in block.vars.values())
    return ops, var_list


def _mlp(pkg, kind, sparse=False):
    """A small tanh MLP (or, ``sparse``, an ``is_sparse`` embedding of 4
    ids into a 40 x 6 table in front of it) under ``kind``."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if sparse:
            ids = pkg.layers.data("ids", shape=[4], dtype="int64")
            emb = pkg.layers.embedding(ids, size=[40, 6], is_sparse=True,
                                       param_attr=pkg.ParamAttr(name="tab"))
            x = pkg.layers.reshape(emb, shape=[-1, 24])
        else:
            x = pkg.layers.data("x", shape=[12], dtype="float32")
        y = pkg.layers.data("y", shape=[3], dtype="float32")
        h = pkg.layers.fc(x, 16, act="tanh")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 3), y))
        chip_smoke.make_optimizer(pkg, kind).minimize(loss)
    return main, startup, loss


def _feeds(sparse):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        fd = {"y": rng.standard_normal((8, 3)).astype(np.float32)}
        if sparse:
            fd["ids"] = rng.randint(0, 40, (8, 4)).astype(np.int64)
        else:
            fd["x"] = rng.standard_normal((8, 12)).astype(np.float32)
        out.append(fd)
    return out


def _trajectory(pkg, progs, feeds, init=None):
    main, startup, loss = progs
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    if init is None:
        init = {n: np.array(scope.get(n)) for n in names}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=fd, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for fd in feeds]
    return np.array(losses), {n: np.array(scope.get(n)) for n in names}, \
        init


def _close_state(got, want, tol=STATE_TOL):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        big = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[n], w, rtol=tol[0], atol=tol[1] * big,
                                   err_msg=n)


def _check_kind(kind, sparse):
    rprogs, pprogs = _mlp(rf, kind, sparse), _mlp(tf, kind, sparse)
    for r, p in zip(rprogs[:2], pprogs[:2]):
        assert _program(p) == _program(r)
    op_type = chip_smoke.optimizer_op_type(kind)
    assert op_type in [op.type for op in pprogs[0].global_block().ops]
    feeds = _feeds(sparse)
    rloss, rstate, init = _trajectory(rf, rprogs, feeds)
    ploss, pstate, _ = _trajectory(tf, pprogs, feeds, init)
    assert np.all(np.abs(ploss - rloss) <= RTOL * np.abs(rloss)), \
        (ploss.tolist(), rloss.tolist())
    _close_state(pstate, rstate, SPARSE_STATE_TOL if sparse else STATE_TOL)
    assert not np.allclose(pstate["fc_0.w_0"], init["fc_0.w_0"])


@pytest.mark.parametrize("kind", KINDS)
def test_optimizer_matches_reference(kind):
    _check_kind(kind, sparse=False)


@pytest.mark.parametrize("kind", sorted(chip_smoke.FOLDING_KINDS))
def test_optimizer_folds_sparse_grad_like_reference(kind):
    _check_kind(kind, sparse=True)


@pytest.mark.parametrize("kind", ["proximal_gd", "proximal_adagrad"])
def test_proximal_refuses_selected_rows_in_both_packages(kind):
    feed = _feeds(True)[0]
    for pkg in (rf, tf):
        main, startup, loss = _mlp(pkg, kind, sparse=True)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(Exception) as err:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        if pkg is tf:
            assert err.type is TypeError and kind in str(err.value)


def _op_state(pkg, kind):
    main, startup, gnames = chip_smoke.optim_op_program(pkg, kind, SHAPES)
    return main, startup, gnames, chip_smoke.optim_op_state(
        startup, SHAPES, np.random.default_rng(5))


def _op_grads():
    rng = np.random.default_rng(6)
    return [[0.1 * rng.standard_normal(s, dtype=np.float32) for s in SHAPES]
            for _ in range(3)]


def _run_ops(pkg, main, startup, gnames, state, grads, load):
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if load:
        load_reference_params(scope, state, tf.CPUPlace())
    else:
        for n, v in state.items():
            scope.set(n, v)
    for g in grads:
        exe.run(main, feed=dict(zip(gnames, g)), scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    return exe, {n: np.array(scope.get(n)) for n in names}


@pytest.mark.parametrize("kind", KINDS + ["average_accumulates"])
def test_op_run_matches_reference_and_group_equals_members(kind):
    rmain, rstart, rg, state = _op_state(rf, kind)
    pmain, pstart, pg, _ = _op_state(tf, kind)
    assert _program(pmain) == _program(rmain)
    grads = _op_grads()
    import jax.numpy as jnp

    rstate = {n: jnp.asarray(v) for n, v in state.items()}
    _, want = _run_ops(rf, rmain, rstart, rg, rstate, grads, load=False)
    exe, got = _run_ops(tf, pmain, pstart, pg, state, grads, load=True)
    _close_state(got, want)
    plan = next(p for key, p in exe._plans.items()
                if key[0] == pmain._cache_token)
    assert [len(r) for r in plan.groups.values()] == [len(SHAPES)]
    with chip_smoke.ungrouped():
        exe, one = _run_ops(tf, pmain, pstart, pg, state, grads, load=True)
        plan = next(p for key, p in exe._plans.items()
                    if key[0] == pmain._cache_token)
        assert not plan.groups
    for n in got:
        assert np.array_equal(got[n], one[n]), n
        assert got[n].tobytes() == one[n].tobytes(), n


def test_optimizer_ops_update_in_place():
    """The scope keeps its tensor objects: each op writes its state in
    place, so a window or a runner holding them sees the update."""
    main, startup, gnames, state = _op_state(tf, "adamax")
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    load_reference_params(scope, state, tf.CPUPlace())
    held = {n: scope.get(n) for n in state}
    before = {n: t.clone() for n, t in held.items()}
    exe.run(main, feed=dict(zip(gnames, _op_grads()[0])), scope=scope)
    for n, t in held.items():
        assert scope.get(n) is t, n
    assert not torch.equal(held["p0"], before["p0"])
