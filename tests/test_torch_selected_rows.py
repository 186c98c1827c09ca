"""SelectedRows sparse grads in the port against the JAX package, on the CPU.

The same numpy-seeded ids (duplicates and ``padding_idx`` among them) and
the JAX package's initial tables, carried into the port, go through the
same Programs in both packages; held at rtol 1e-6 / atol 1e-6 (float32 on
both sides, the scatter-adds in the same order on the CPU):

 - ``lookup_table(is_sparse=True)``'s grad: a SelectedRows of one row a
   looked-up id (padding rows zero), fetched as the reference returns it
   (a 0-d object array); its rows and values, and its ``to_dense``;
 - sparse ``sgd``: the table after a step, every row not looked up
   bitwise unchanged;
 - ``sum`` over all-sparse inputs (one table looked up twice: the grads
   concatenate) and mixed inputs (a sparse and a dense lookup of one
   table, and L2 decay's dense term: the SelectedRows is scatter-added
   into the dense accumulator);
 - ``adam`` and ``momentum`` fed a SelectedRows grad (folded dense first,
   as in the reference): the tables and their moments after two steps;
 - ``Executor.run_steps`` over a sparse program: against the reference's
   window, and bitwise against ``Executor.run`` step by step in the port.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid.selected_rows import SelectedRows
from paddle_tpu_torch.models.params import load_reference_params

TOL = dict(rtol=1e-6, atol=1e-6)
VOCAB, DIM, BATCH, FIELDS, PAD = 40, 6, 5, 4, 3


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _ids(seed=0):
    """[BATCH, FIELDS] ids with repeats within and across rows, and the
    padding id."""
    ids = np.random.RandomState(seed).randint(0, VOCAB // 2,
                                              (BATCH, FIELDS))
    ids[:, 0] = 7           # one id in every row
    ids[1, 1] = ids[1, 2]   # a repeat within a row
    ids[2, 3] = PAD
    return ids.astype(np.int64)


def _weight(shape, seed=9):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _program(pkg, body, opt=None, reg=None):
    """``loss = reduce_sum(body(ids) · w)`` with a fixed random ``w``;
    ``opt(pkg)`` minimizes it (else only the backward is appended).
    Returns (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        ids = L.data("ids", shape=[FIELDS], dtype="int64")
        out = body(pkg, ids)
        w = L.assign(_weight((BATCH,) + tuple(out.shape[1:])))
        loss = L.reduce_sum(L.elementwise_mul(out, w))
        if opt is not None:
            opt(pkg, reg).minimize(loss)
        else:
            pkg.backward.append_backward(loss)
    return main, startup, loss


def _emb(pkg, ids, sparse=True, padding_idx=None, name="tbl"):
    return pkg.layers.embedding(
        ids, size=[VOCAB, DIM], is_sparse=sparse, padding_idx=padding_idx,
        param_attr=pkg.ParamAttr(name=name))


def _run_both(body, fetch, steps=1, opt=None, reg=None, feed=None):
    """The program in both packages from the reference's initial scope:
    the fetches of each step, and both scopes."""
    feed = feed or {"ids": _ids()}
    out, scopes = [], []
    init = None
    for pkg in (rf, tf):
        main, startup, loss = _program(pkg, body, opt, reg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        names = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:
            init = {n: np.array(scope.get(n)) for n in names}
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        out.append([exe.run(main, feed=feed, fetch_list=[loss] + fetch,
                            scope=scope) for _ in range(steps)])
        scopes.append(scope)
    return out, scopes, init


def _dense(sr, height=VOCAB):
    """A fetched SelectedRows (either package's) as a dense numpy table."""
    return np.asarray(sr.to_dense(height))


@pytest.mark.parametrize("padding_idx", [None, PAD], ids=["no_pad", "pad"])
def test_lookup_table_sparse_grad(padding_idx):
    (ref, port), _, _ = _run_both(
        lambda pkg, ids: _emb(pkg, ids, padding_idx=padding_idx),
        ["tbl@GRAD"])
    rg, pg = ref[0][1], port[0][1]
    assert pg.shape == () and pg.dtype == object  # as the reference's
    rg, pg = rg.item(), pg.item()
    assert isinstance(pg, SelectedRows)
    assert pg.height == rg.height == VOCAB
    assert tuple(pg.rows.shape) == (BATCH * FIELDS,)
    assert tuple(pg.values.shape) == (BATCH * FIELDS, DIM)
    assert pg.values.dtype == torch.float32
    np.testing.assert_array_equal(pg.rows.numpy(), np.asarray(rg.rows))
    np.testing.assert_allclose(pg.values.numpy(), np.asarray(rg.values),
                               **TOL)
    if padding_idx is not None:
        pad = pg.rows.numpy() == PAD
        assert pad.any() and not pg.values.numpy()[pad].any()
    np.testing.assert_allclose(_dense(pg), _dense(rg), **TOL)
    np.testing.assert_allclose(ref[0][0], port[0][0], **TOL)


def _sgd(pkg, reg=None):
    return pkg.optimizer.SGD(learning_rate=0.5, regularization=reg)


def test_sparse_sgd_touches_only_looked_up_rows():
    (ref, port), (rscope, pscope), init = _run_both(
        lambda pkg, ids: _emb(pkg, ids, padding_idx=PAD), [], steps=2,
        opt=_sgd)
    got, want = pscope.get("tbl").numpy(), np.asarray(rscope.get("tbl"))
    np.testing.assert_allclose(got, want, **TOL)
    untouched = np.setdiff1d(np.arange(VOCAB), _ids())
    np.testing.assert_array_equal(got[untouched], init["tbl"][untouched])
    assert not np.array_equal(got[7], init["tbl"][7])
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p[0], r[0], **TOL)


def _twice_sparse(pkg, ids):
    """One table looked up twice, both sparse: the backward sums two
    SelectedRows."""
    a = _emb(pkg, ids)
    b = _emb(pkg, pkg.layers.scale(ids, scale=1.0, bias=1.0))
    return pkg.layers.elementwise_add(a, b)


def _sparse_and_dense(pkg, ids):
    """One table looked up sparse and dense: the backward sums a
    SelectedRows and a dense grad."""
    return pkg.layers.elementwise_add(_emb(pkg, ids),
                                      _emb(pkg, ids, sparse=False))


@pytest.mark.parametrize("case", ["all_sparse", "mixed", "l2_decay"])
def test_sum_of_sparse_grads(case):
    body = _sparse_and_dense if case == "mixed" else (
        _twice_sparse if case == "all_sparse" else _emb)
    reg = (lambda pkg: pkg.regularizer.L2Decay(0.1)) if case == "l2_decay" \
        else (lambda pkg: None)

    def opt(pkg, _):
        return _sgd(pkg, reg(pkg))

    (ref, port), (rscope, pscope), _ = _run_both(body, [], opt=opt)
    np.testing.assert_allclose(pscope.get("tbl").numpy(),
                               np.asarray(rscope.get("tbl")), **TOL)
    ref_f, port_f = _run_both(body, ["tbl@GRAD"])[0]
    rg, pg = ref_f[0][1], port_f[0][1]
    if case == "all_sparse":
        rg, pg = rg.item(), pg.item()
        assert isinstance(pg, SelectedRows)
        assert tuple(pg.rows.shape) == (2 * BATCH * FIELDS,)  # concatenated
        np.testing.assert_array_equal(pg.rows.numpy(), np.asarray(rg.rows))
        np.testing.assert_allclose(_dense(pg), _dense(rg), **TOL)
    elif case == "mixed":
        assert isinstance(pg, np.ndarray) and pg.shape == (VOCAB, DIM)
        np.testing.assert_allclose(pg, np.asarray(rg), **TOL)


@pytest.mark.parametrize("opt_name", ["adam", "momentum"])
def test_dense_optimizers_take_a_sparse_grad(opt_name):
    def opt(pkg, _):
        if opt_name == "adam":
            return pkg.optimizer.Adam(learning_rate=0.1)
        return pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9)

    (ref, port), (rscope, pscope), init = _run_both(
        lambda pkg, ids: _emb(pkg, ids, padding_idx=PAD), [], steps=2,
        opt=opt)
    assert len(init) > 2  # the table, its moments (and lr, beta pows)
    for name in init:
        np.testing.assert_allclose(
            pscope.get(name).numpy(), np.asarray(rscope.get(name)), **TOL,
            err_msg=name)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p[0], r[0], **TOL)


def test_run_steps_window_over_a_sparse_program():
    """3 steps of SGD on a sparse table with a per-step feed: the
    reference's window, the port's window and the port's ``run`` steps."""
    steps = 3
    feed = {"ids": np.stack([_ids(seed) for seed in range(steps)])}
    results, init = [], None
    for pkg, how in ((rf, "window"), (tf, "window"), (tf, "run")):
        port_framework.fresh_session()
        main, startup, loss = _program(
            pkg, lambda p, ids: _emb(p, ids, padding_idx=PAD), _sgd)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        if how == "window":
            last = exe.run_steps(main, feed=feed, fetch_list=[loss],
                                 n_steps=steps, scope=scope,
                                 feed_per_step=True)
        else:
            for i in range(steps):
                last = exe.run(main, feed={"ids": feed["ids"][i]},
                               fetch_list=[loss], scope=scope)
        results.append((np.asarray(last[0]), np.array(scope.get("tbl"))))
    (rl, rt), (wl, wt), (sl, st) = results
    np.testing.assert_allclose(wl, rl, **TOL)
    np.testing.assert_allclose(wt, rt, **TOL)
    np.testing.assert_array_equal(wl, sl)
    np.testing.assert_array_equal(wt, st)
    untouched = np.setdiff1d(np.arange(VOCAB), feed["ids"])
    np.testing.assert_array_equal(wt[untouched], init["tbl"][untouched])


def test_sparse_grad_methods():
    """The port's SelectedRows alone: duplicates fold in ``to_dense``,
    ``scatter_sub_into`` moves only its rows in place, ``merge_with``
    concatenates, and an elementwise op refuses one."""
    rows = torch.tensor([2, 0, 2])
    vals = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    sr = SelectedRows(rows, vals, height=4)
    assert sr.shape == (4, 2) and sr.dtype == torch.float32
    dense = sr.to_dense()
    torch.testing.assert_close(dense, torch.tensor(
        [[2.0, 3.0], [0.0, 0.0], [4.0, 6.0], [0.0, 0.0]]))
    table = torch.ones(4, 2)
    before = table.clone()
    assert sr.scatter_sub_into(table, 0.5) is table
    torch.testing.assert_close(table, before - 0.5 * dense)
    assert torch.equal(table[[1, 3]], before[[1, 3]])
    merged = sr.merge_with(sr)
    assert tuple(merged.rows.shape) == (6,) and merged.height == 4
    torch.testing.assert_close(merged.to_dense(), 2 * dense)
    with pytest.raises(TypeError):
        sr.merge_with(dense)
    from paddle_tpu_torch.ops.math_ops import _refuse_sparse
    with pytest.raises(TypeError, match="SelectedRows"):
        _refuse_sparse("elementwise_div", sr, dense)
