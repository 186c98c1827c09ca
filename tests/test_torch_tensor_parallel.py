"""Tensor and fsdp parallelism in the port's ``ParallelExecutor``, held
against the JAX package on the CPU.

Build-only (one process):

 - the spec tables: the port's ``infer_param_specs`` equals the
   reference's for the MLP and the tiny Transformer, flash and unfused
   (every ``Y`` of ``mul`` / ``matmul`` is numbered, so the unfused
   build's orders run 2 further an attention; the parity, and with it
   the column / row choice, stays), on ``dp4,tp2``, ``dp2,tp2``,
   ``fsdp2,dp4`` and ``make_mesh(8, tp=2)``'s ``mp``, with and without
   ZeRO-1;
 - the partials of the streaming xent (``softmax_xent_partial_ref``)
   against the Pallas ``_xent_partial`` in interpret mode;
 - ``_reshape_map``, and the mesh axes that are still refused.

One module-scoped spawn of four gloo ranks (a ``FileStore`` under the
test's temporary directory, one thread a rank, a 60 s collective timeout;
the spawn as a whole is cut at ``SPAWN_TIMEOUT_S``) runs every scenario in
order, each rank feeding its dp coordinate's rows; ranks 0 and 1 then join
a second group of two for the meshes the card runs (``tp2``, ``fsdp2``).
The parent computes the reference's numbers and the port's single-process
``Executor``'s, from the reference's initial scope (dropout 0):

 - the MLP on ``dp2 x mp2`` under AllReduce and ZeRO-1: against the port's
   Executor (rtol 1e-5 at step 0, 1e-4 after) and the reference's
   ``dp4 x mp2`` ``ShardedTrainStep`` (its own 5e-4,
   ``tests/test_tensor_parallel.py:82-86``);
 - the tiny Transformer on ``dp2,tp2``, flash on (the plain versions):
   against the reference's Executor and the port's (1e-5 / 1e-4), under
   ZeRO-1 too; unfused against the port's Executor and the reference's
   ``dp4 x mp2`` step (2e-3, ``tests/test_tensor_parallel.py:89-119``); a
   ``run_steps`` window of the unfused build on the named ``dp2,tp2``
   mesh against the reference's ``dp4,tp2`` window (5e-4,
   ``tests/test_spmd_window.py:138``).  The reference's sharded flash
   wraps its kernel in ``shard_map(check_rep=...)``, which this JAX no
   longer takes (``ROADMAP.md`` queue 3), so its sharded runs take the
   unfused build;
 - ``SoftmaxXentSharded`` alone on a tp pair, against the reference's
   ``softmax_xent`` (interpret mode) on the gathered logits: hard labels on
   the shard edges and ignored rows, soft labels; loss, lse and dx;
 - ``flash_attention_sharded`` alone on a tp pair against the reference's
   ``flash_attention`` (interpret mode): out and dq, dk, dv;
 - dropout 0.1 under ``dp2,tp2``: the activations are bitwise the same on
   the two ranks of each tp pair;
 - the tiny Transformer on ``fsdp2,dp2`` under AllReduce and ZeRO-1
   against the port's Executor (1e-5 / 1e-4);
 - ``tp2`` against the port's Executor (1e-5 / 1e-4), its parameters
   the same on both ranks bitwise, and ``fsdp2`` bitwise against the
   port's Executor (losses and the gathered parameters);
 - the refusals: a sparse table under tp, saving a sharded scope,
   ``Trainer(parallel=True)`` over a tp mesh, a guarded step on ``tp2``
   and ``fsdp2``.

Run as a script (``python this_file --worker RANK ...``) it is one rank.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

WORLD = 4
PAIR = 2
SPAWN_TIMEOUT_S = 300
GLOO_TIMEOUT_S = 60
MLP_STEPS, MLP_BATCH = 5, 16
TF_STEPS, TF_BATCH, TF_LEN = 4, 8, 8
WIN_STEPS = 2
PAIR_STEPS = 2
XENT_R, XENT_V, XENT_IGNORE = 12, 16, 3
FL_B, FL_H, FL_T, FL_D = 2, 4, 8, 16

STEP0_RTOL, LOSS_RTOL = 1e-5, 1e-4
REF_MLP_TOL = 5e-4
REF_TF_TOL = 2e-3
REF_WIN_TOL = 5e-4
XENT_TOL = dict(rtol=1e-5, atol=1e-6)
FLASH_TOL = dict(rtol=1e-4, atol=1e-5)


# -- programs, in either package's fluid ------------------------------------

def mlp(fluid, seed=11):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[64], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def transformer(fluid, tm, flash=True, seed=5, lr=3e-3, dropout=0.0):
    cfg = tm.tiny_config()
    cfg.dropout, cfg.flash_attention = dropout, flash
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cost = tm.build(cfg, src_len=TF_LEN, tgt_len=TF_LEN, lr=lr)[3]
    return main, startup, cost


def sparse_net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name="ids", shape=[4], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[32, 8], is_sparse=True)
        loss = fluid.layers.mean(fluid.layers.fc(emb, 8,
                                                 num_flatten_dims=2))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def data():
    rng = np.random.RandomState(0)
    mlp_feeds = [{"img": rng.normal(size=(MLP_BATCH, 64)).astype(np.float32),
                  "label": rng.randint(0, 10, (MLP_BATCH, 1)).astype(
                      np.int64)} for _ in range(MLP_STEPS)]
    rng = np.random.RandomState(3)

    def tf_feed():
        return {"src_word": rng.randint(1, 1000, (TF_BATCH, TF_LEN)),
                "tgt_word": rng.randint(1, 1000, (TF_BATCH, TF_LEN)),
                "lbl_word": rng.randint(1, 1000, (TF_BATCH, TF_LEN, 1))}
    tf_feeds = [{k: v.astype(np.int64) for k, v in tf_feed().items()}
                for _ in range(TF_STEPS)]
    win = {k: np.stack([f[k] for f in tf_feeds[:WIN_STEPS]])
           for k in tf_feeds[0]}
    return mlp_feeds, tf_feeds, win


def xent_inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((XENT_R, XENT_V)) * 3).astype(np.float32)
    half = XENT_V // PAIR
    # both edges of each shard, the ignored label, and the rest random
    lab = np.array([0, half - 1, half, XENT_V - 1, XENT_IGNORE, 5, 11,
                    XENT_IGNORE, 9, 2, 14, 7], np.int64)
    y = rng.random((XENT_R, XENT_V)).astype(np.float32)
    y /= y.sum(-1, keepdims=True)
    dloss = rng.standard_normal((XENT_R, 1)).astype(np.float32)
    dlse = rng.standard_normal((XENT_R, 1)).astype(np.float32)
    return x, lab, y, dloss, dlse


def flash_inputs(seed=9):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((FL_B, FL_H, FL_T, FL_D)).astype(
        np.float32) for _ in range(4))
    bias = np.zeros((FL_B, 1, 1, FL_T), np.float32)
    bias[0, ..., -3:] = -1e9
    return q, k, v, bias, do


def shard(feed, mesh):
    dp, c = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    n = len(next(iter(feed.values()))) // dp
    return {k: v[c * n:(c + 1) * n] for k, v in feed.items()}


# -- one rank ---------------------------------------------------------------

def _rank_main(rank, tmp, job_path, out_path):
    import datetime

    import torch
    import torch.distributed as dist

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import io as port_io
    from paddle_tpu_torch.models import transformer as tm
    from paddle_tpu_torch.models.params import load_reference_params
    from paddle_tpu_torch.ops import collectives, flash_attention, fused
    from paddle_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cpu = fluid.CPUPlace()
    mlp_feeds, tf_feeds, win = data()
    out = {}

    def join(world, name):
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, name), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))

    def fresh(build, init, *args, **kw):
        main, startup, loss = build(fluid, *args, **kw)
        scope = fluid.Scope()
        fluid.Executor(cpu).run(startup, scope=scope)
        if init is not None:
            load_reference_params(scope, init, cpu)
        return main, loss, scope

    def pe(main, loss, scope, mesh, reduce=False):
        bs = fluid.BuildStrategy()
        if reduce:
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        return fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                      build_strategy=bs, scope=scope,
                                      place=cpu, mesh=mesh)

    def losses(exe, loss, feeds, mesh, extra=()):
        return [float(exe.run([loss, *extra], feed=shard(f, mesh))[0]
                      .reshape(-1)[0]) for f in feeds]

    join(WORLD, "store4")
    mp_mesh = pm.make_mesh(tp=2)
    named = pm.mesh_from_spec("dp2,tp2")
    for reduce in (False, True):
        main, loss, scope = fresh(mlp, job["mlp"])
        exe = pe(main, loss, scope, mp_mesh, reduce)
        out[f"mlp_{int(reduce)}"] = losses(exe, loss, mlp_feeds, mp_mesh)
        step = next(iter(exe._steps.values()))
        out[f"mlp_{int(reduce)}_sharded"] = sorted(step.placement.storage)

    for name, flash, reduce in (("tf", True, False), ("tf_z1", True, True),
                                ("tf_unfused", False, False)):
        main, loss, scope = fresh(transformer, job["tf"], tm, flash=flash)
        exe = pe(main, loss, scope, named, reduce)
        out[name] = losses(exe, loss, tf_feeds, named)
        if name == "tf":
            step = next(iter(exe._steps.values()))
            out["tf_tp_rules"] = sum(r is not None
                                     for r in step.placement.rules)
            out["tf_local_shape"] = tuple(scope.get("enc0_self_q_w").shape)
            # the rank's scope holds shards: saving it is refused
            try:
                with fluid.scope_guard(scope):
                    fluid.io.save_persistables(
                        fluid.Executor(cpu), os.path.join(tmp, f"s{rank}"),
                        main)
                out["save_refused"] = None
            except port_io.ShardedScopeError as exc:
                out["save_refused"] = str(exc)

    fsdp = pm.mesh_from_spec("fsdp2,dp2")
    for reduce in (False, True):
        main, loss, scope = fresh(transformer, job["tf"], tm)
        exe = pe(main, loss, scope, fsdp, reduce)
        out[f"fsdp_{int(reduce)}"] = losses(exe, loss, tf_feeds, fsdp)
        out[f"fsdp_{int(reduce)}_local"] = tuple(
            scope.get("enc0_self_q_w").shape)

    main, loss, scope = fresh(transformer, job["win"], tm, flash=False,
                              seed=7, lr=1e-3)
    exe = pe(main, loss, scope, named)
    n = TF_BATCH // named.shape["dp"]
    c = named.coords["dp"]
    last = exe.run_steps([loss], feed={k: v[:, c * n:(c + 1) * n]
                                       for k, v in win.items()},
                         n_steps=WIN_STEPS, feed_per_step=True)
    out["win"] = float(np.asarray(last[0]).reshape(-1)[0])

    # dropout under tp: the draws are made on gathered tensors, from the
    # dp coordinate's stream, so both ranks of a tp pair hold the same
    main, loss, scope = fresh(transformer, None, tm, dropout=0.1)
    drops = [op.output("Out")[0] for op in main.global_block().ops
             if op.type == "dropout"]
    exe = pe(main, loss, scope, named)
    out["dropout"] = [[np.asarray(v) for v in exe.run(
        [loss, drops[0], drops[-1]], feed=shard(f, named))]
        for f in tf_feeds[:2]]

    main, loss, scope = fresh(sparse_net, None)
    try:
        pe(main, loss, scope, named).run(
            [loss], feed={"ids": np.zeros((2, 4), np.int64)})
        out["sparse_refused"] = None
    except NotImplementedError as exc:
        out["sparse_refused"] = str(exc)

    os.environ["PADDLE_TPU_MESH"] = "dp2,tp2"
    try:
        with fluid.scope_guard(fluid.Scope()):
            fluid.Trainer(lambda: mlp_train(fluid),
                          lambda: fluid.optimizer.SGD(learning_rate=0.1),
                          place=cpu, parallel=True)
        out["trainer_refused"] = None
    except port_io.ShardedScopeError as exc:
        out["trainer_refused"] = str(exc)
    finally:
        os.environ.pop("PADDLE_TPU_MESH")

    # the kernels' wrappers alone on a tp pair
    tp = pm.axis_groups(named)["tp"]
    x, lab, y, dloss, dlse = xent_inputs()
    half = XENT_V // PAIR
    cols = slice(tp.rank * half, (tp.rank + 1) * half)
    for soft in (False, True):
        xl = torch.from_numpy(x[:, cols].copy()).requires_grad_()
        label = torch.from_numpy(y[:, cols].copy() if soft else lab)
        lv, lse = fused.SoftmaxXentSharded.apply(xl, label, soft,
                                                  XENT_IGNORE, tp)
        torch.autograd.backward([lv, lse], [torch.from_numpy(dloss),
                                            torch.from_numpy(dlse)])
        out[f"xent_{int(soft)}"] = (lv.detach().numpy(), lse.detach().numpy(),
                                    xl.grad.numpy())
    q, k, v, bias, do = flash_inputs()
    heads = slice(tp.rank * FL_H // PAIR, (tp.rank + 1) * FL_H // PAIR)
    for causal in (False, True):
        leaves = [torch.from_numpy(a[:, heads].copy()).requires_grad_()
                  for a in (q, k, v)]
        o = flash_attention.flash_attention_sharded(
            *leaves, None if causal else torch.from_numpy(bias), None, causal)
        o.backward(torch.from_numpy(do[:, heads].copy()))
        out[f"flash_{int(causal)}"] = [o.detach().numpy()] + [
            t.grad.numpy() for t in leaves]
    out["all_reduce_by_axis"] = dict(collectives.all_reduce_launches_by_axis)
    dist.destroy_process_group()

    if rank < PAIR:
        join(PAIR, "store2")
        for spec in ("tp2", "fsdp2"):
            mesh = pm.mesh_from_spec(spec)
            main, loss, scope = fresh(transformer, job["tf"], tm)
            params = sorted(p.name for p in main.global_block()
                            .all_parameters())
            exe = pe(main, loss, scope, mesh)
            got = [exe.run([loss] + params, feed=f)
                   for f in tf_feeds[:PAIR_STEPS]]
            out[spec] = ([float(g[0].reshape(-1)[0]) for g in got],
                         dict(zip(params, got[-1][1:])),
                         tuple(scope.get("enc0_self_q_w").shape))
            # a guarded step reads every grad; a rank holds its shards
            main, loss, scope = fresh(transformer, job["tf"], tm)
            fluid.guardian.enable("skip")
            try:
                pe(main, loss, scope, mesh).run([loss], feed=tf_feeds[0])
                out[f"{spec}_guarded_refused"] = None
            except NotImplementedError as exc:
                out[f"{spec}_guarded_refused"] = str(exc)
            finally:
                fluid.guardian.disable()
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def mlp_train(fluid):
    img = fluid.layers.data(name="img", shape=[64], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    pred = fluid.layers.fc(input=img, size=10, act="softmax")
    return [fluid.layers.mean(
        fluid.layers.cross_entropy(input=pred, label=label))]


# -- the references, and the spawn ------------------------------------------

def _init_of(rf, main, startup):
    scope = rf.Scope()
    rf.Executor(rf.CPUPlace()).run(startup, scope=scope)
    return scope, {v.name: np.array(scope.get(v.name))
                   for v in startup.list_vars()
                   if v.persistable and scope.get(v.name) is not None}


def _ref_sharded(rf, main, loss, scope, init, feeds, zero1=False):
    from paddle_tpu.parallel.mesh import make_mesh
    from paddle_tpu.parallel.spmd import ShardedTrainStep

    for n, v in init.items():
        scope.set(n, v)
    names = sorted(feeds[0])
    with rf.scope_guard(scope):
        step = ShardedTrainStep(main, names, [loss.name], make_mesh(8, tp=2),
                                zero1=zero1)
        assert any("mp" in tuple(s) for s in step.specs.values()
                   if s is not None)
        state = step.place_state()
        out = []
        for f in feeds:
            fetches, new = step(step.place_feed(f), state)
            state = {**state, **new}
            out.append(float(np.asarray(fetches[0]).reshape(-1)[0]))
    return out


def _references(tmp):
    import paddle_tpu.fluid as rf
    from paddle_tpu.fluid import framework as rfw
    from paddle_tpu.models import transformer as rtm
    from paddle_tpu.parallel import ShardedWindowRunner, mesh_from_spec

    mlp_feeds, tf_feeds, win = data()
    job, ref = {"tmp": tmp}, {}

    def exe_losses(main, loss, scope, feeds):
        exe = rf.Executor(rf.CPUPlace())
        return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).reshape(-1)[0])
                for f in feeds]

    rfw.fresh_session()
    main, startup, loss = mlp(rf)
    scope, job["mlp"] = _init_of(rf, main, startup)
    for z in (False, True):
        ref[f"mlp_{int(z)}"] = _ref_sharded(rf, main, loss, scope,
                                            job["mlp"], mlp_feeds, z)

    rfw.fresh_session()
    main, startup, loss = transformer(rf, rtm)
    scope, job["tf"] = _init_of(rf, main, startup)
    ref["tf_exe"] = exe_losses(main, loss, scope, tf_feeds)
    # the reference's sharded flash wraps its kernel in shard_map's
    # check_rep, which this JAX no longer takes (ROADMAP.md queue 3, "not
    # port faults"): its sharded step and window run the unfused build
    rfw.fresh_session()
    main, startup, loss = transformer(rf, rtm, flash=False)
    scope, init = _init_of(rf, main, startup)
    assert init.keys() == job["tf"].keys()
    ref["tf_unfused_sharded"] = _ref_sharded(rf, main, loss, scope,
                                             job["tf"], tf_feeds)

    rfw.fresh_session()
    main, startup, loss = transformer(rf, rtm, flash=False, seed=7, lr=1e-3)
    scope, job["win"] = _init_of(rf, main, startup)
    with rf.scope_guard(scope):
        runner = ShardedWindowRunner(main, sorted(win), [loss.name],
                                     mesh_from_spec("dp4,tp2"),
                                     n_steps=WIN_STEPS, feed_per_step=True)
        assert any("tp" in tuple(s) for s in runner.specs.values()
                   if s is not None)
        ref["win"] = float(np.asarray(runner.run(win)[0]).reshape(-1)[0])
    return job, ref


def _port_executor(job):
    """The port's single-process Executor from the reference's initial
    scope: the MLP's losses, the Transformer's (flash and unfused), and
    the parameters after ``PAIR_STEPS`` steps."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer as tm
    from paddle_tpu_torch.models.params import load_reference_params

    cpu = fluid.CPUPlace()
    mlp_feeds, tf_feeds, _ = data()
    port = {}

    def run(build, init, feeds, *args, params_after=None, **kw):
        main, startup, loss = build(fluid, *args, **kw)
        scope = fluid.Scope()
        exe = fluid.Executor(cpu)
        exe.run(startup, scope=scope)
        load_reference_params(scope, init, cpu)
        names = sorted(p.name for p in main.global_block().all_parameters())
        out, params = [], None
        for i, f in enumerate(feeds):
            got = exe.run(main, feed=f, fetch_list=[loss] + names,
                          scope=scope)
            out.append(float(got[0].reshape(-1)[0]))
            if params_after == i + 1:
                params = dict(zip(names, got[1:]))
        return out, params

    # one thread, as each rank runs: the CPU's matmuls sum in an order
    # that depends on the thread count, and fsdp2 is held bitwise
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port["mlp"] = run(mlp, job["mlp"], mlp_feeds)[0]
        port["tf"], port["tf_params"] = run(
            transformer, job["tf"], tf_feeds, tm, params_after=PAIR_STEPS)
        port["tf_unfused"] = run(transformer, job["tf"], tf_feeds, tm,
                                 flash=False)[0]
    finally:
        torch.set_num_threads(threads)
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    job, ref = _references(tmp)
    port = _port_executor(job)
    job_path = os.path.join(tmp, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_MESH", None)
    outs = [os.path.join(tmp, f"out_{r}.pkl") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r), tmp,
         job_path, outs[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = []
    for path in outs:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    return ref, port, ranks


def _losses_close(got, want, rtol0=STEP0_RTOL, rtol=LOSS_RTOL):
    np.testing.assert_allclose(got[:1], want[:1], rtol=rtol0)
    np.testing.assert_allclose(got, want, rtol=rtol)


# -- the spawn's checks -----------------------------------------------------

@pytest.mark.parametrize("reduce", [0, 1])
def test_mlp_dp2_mp2_matches_executor_and_reference_step(runs, reduce):
    ref, port, ranks = runs
    for rec in ranks:
        got = rec[f"mlp_{reduce}"]
        _losses_close(got, port["mlp"])
        np.testing.assert_allclose(got, ref[f"mlp_{reduce}"],
                                   rtol=REF_MLP_TOL, atol=REF_MLP_TOL)
        # the legacy heuristic: both 2-D weights (and their velocities)
        # on their last dim
        assert rec[f"mlp_{reduce}_sharded"] == [
            "fc_0.w_0", "fc_1.w_0", "velocity_fc_0.w_0_0",
            "velocity_fc_1.w_0_0"]
    assert ranks[0][f"mlp_{reduce}"] == ranks[3][f"mlp_{reduce}"]


@pytest.mark.parametrize("name", ["tf", "tf_z1"])
def test_transformer_dp2_tp2_flash_matches_reference(runs, name):
    ref, port, ranks = runs
    for rec in ranks:
        _losses_close(rec[name], ref["tf_exe"])
        _losses_close(rec[name], port["tf"])
    # q is column-parallel: the rank holds half its output columns
    assert ranks[0]["tf_local_shape"] == (64, 32)
    assert ranks[0]["tf_tp_rules"] > 0


def test_transformer_unfused_dp2_tp2_matches_reference_step(runs):
    ref, port, ranks = runs
    for rec in ranks:
        _losses_close(rec["tf_unfused"], port["tf_unfused"])
        np.testing.assert_allclose(rec["tf_unfused"],
                                   ref["tf_unfused_sharded"],
                                   rtol=REF_TF_TOL, atol=REF_TF_TOL)


@pytest.mark.parametrize("reduce", [0, 1])
def test_transformer_fsdp2_dp2_matches_executor(runs, reduce):
    _, port, ranks = runs
    for rec in ranks:
        _losses_close(rec[f"fsdp_{reduce}"], port["tf"])
        # the rank stores half of each weight's input rows
        assert rec[f"fsdp_{reduce}_local"] == (32, 64)


def test_window_on_named_dp2_tp2_matches_reference_window(runs):
    ref, _, ranks = runs
    for rec in ranks:
        np.testing.assert_allclose(rec["win"], ref["win"], rtol=REF_WIN_TOL,
                                   atol=REF_WIN_TOL)


def test_sharded_xent_matches_reference_on_gathered_logits(runs):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_fused as pf

    _, _, ranks = runs
    x, lab, y, dloss, dlse = xent_inputs()
    for soft in (0, 1):
        label = jnp.asarray(y) if soft else \
            jnp.asarray(lab.astype(np.int32).reshape(-1, 1))
        (loss, lse), vjp = jax.vjp(
            lambda a: pf.softmax_xent(a, label, bool(soft), XENT_IGNORE,
                                      interpret=True), jnp.asarray(x))
        (dx,) = vjp((jnp.asarray(dloss), jnp.asarray(dlse)))
        for pair in ((0, 1), (2, 3)):
            parts = [ranks[r][f"xent_{soft}"] for r in pair]
            for lv, ls, _ in parts:
                np.testing.assert_allclose(lv, np.asarray(loss), **XENT_TOL)
                np.testing.assert_allclose(ls, np.asarray(lse), **XENT_TOL)
            np.testing.assert_allclose(
                np.concatenate([p[2] for p in parts], axis=1),
                np.asarray(dx), **XENT_TOL)
        if not soft:
            assert (ranks[0]["xent_0"][0][lab == XENT_IGNORE] == 0).all()


def test_flash_attention_sharded_matches_reference(runs):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_flash as pfl

    _, _, ranks = runs
    q, k, v, bias, do = flash_inputs()
    for causal in (0, 1):
        b = None if causal else jnp.asarray(bias)
        out, vjp = jax.vjp(
            lambda a, bb, c: pfl.flash_attention(
                a, bb, c, b, causal=bool(causal), block_q=8, block_k=8,
                interpret=True), *map(jnp.asarray, (q, k, v)))
        want = [out, *vjp(jnp.asarray(do))]
        for pair in ((0, 1), (2, 3)):
            got = [np.concatenate([ranks[r][f"flash_{causal}"][i]
                                   for r in pair], axis=1)
                   for i in range(4)]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), **FLASH_TOL)


def test_dropout_under_tp_is_bitwise_across_tp_peers(runs):
    _, _, ranks = runs
    for a, b in ((0, 1), (2, 3)):
        for sa, sb in zip(ranks[a]["dropout"], ranks[b]["dropout"]):
            for va, vb in zip(sa, sb):
                np.testing.assert_array_equal(va, vb)
    # the dp ranks' rows differ, and each drops about a tenth
    act = ranks[0]["dropout"][0][1]
    assert not np.array_equal(act, ranks[2]["dropout"][0][1])
    assert 0.02 < float((act == 0).mean()) < 0.2
    assert all(np.isfinite(s[0]).all() for r in ranks for s in r["dropout"])


def test_tp2_and_fsdp2_match_the_single_process_executor(runs):
    _, port, ranks = runs
    for r, rec in enumerate(ranks[:PAIR]):
        losses, params, local = rec["tp2"]
        _losses_close(losses, port["tf"][:PAIR_STEPS])
        assert local == (64, 32)
        # the fetched parameters are the same on both ranks, bit for bit
        # (the replicated ones each rank updated itself)
        other = ranks[1 - r]["tp2"][1]
        for n, v in params.items():
            np.testing.assert_array_equal(v, other[n], n)
        losses, params, local = rec["fsdp2"]
        # gathers are copies and the update is elementwise: bitwise
        assert losses == port["tf"][:PAIR_STEPS]
        assert local == (32, 64)
        assert params.keys() == port["tf_params"].keys()
        for n, v in params.items():
            np.testing.assert_array_equal(v, port["tf_params"][n], n)
    assert "tp2" not in ranks[PAIR]


@pytest.mark.parametrize("spec", ["tp2", "fsdp2"])
def test_guarded_step_on_a_sharded_mesh_is_refused(runs, spec):
    _, _, ranks = runs
    for rec in ranks[:PAIR]:
        msg = rec[f"{spec}_guarded_refused"]
        assert msg is not None and "guarded step" in msg and spec in msg


def test_refusals_sparse_table_sharded_scope_and_trainer(runs):
    _, _, ranks = runs
    for rec in ranks:
        assert "step 2" in rec["sparse_refused"]
        assert "step 3" in rec["save_refused"]
        assert "step 3" in rec["trainer_refused"]
        assert rec["all_reduce_by_axis"].get("tp", 0) > 0


# -- build-only -------------------------------------------------------------

def _build_pair(model, flash):
    import paddle_tpu.fluid as rf
    import paddle_tpu_torch.fluid as tf
    from paddle_tpu.fluid import framework as rfw
    from paddle_tpu.models import transformer as rtm
    from paddle_tpu_torch.models import transformer as ptm

    rfw.fresh_session()
    if model == "mlp":
        return mlp(rf), mlp(tf), ["img", "label"]
    return (transformer(rf, rtm, flash=flash),
            transformer(tf, ptm, flash=flash),
            ["lbl_word", "src_word", "tgt_word"])


MESHES = ["dp4,tp2", "dp2,tp2", "fsdp2,dp4", "mp"]


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("model", ["mlp", "tf_flash", "tf_unfused"])
def test_spec_table_matches_reference(model, mesh, zero1):
    from paddle_tpu.fluid.executor import BlockPlan as RefPlan
    from paddle_tpu.parallel import mesh as rmesh
    from paddle_tpu.parallel import spmd as rspmd
    from paddle_tpu_torch.fluid.executor import BlockPlan
    from paddle_tpu_torch.parallel import mesh as pmesh
    from paddle_tpu_torch.parallel import spmd as pspmd

    (rmain, _, rloss), (pmain, _, ploss), feeds = _build_pair(
        model, model == "tf_flash")
    if mesh == "mp":
        rm, pm_ = rmesh.make_mesh(8, tp=2), pmesh.Mesh({"dp": 4, "mp": 2})
    else:
        rm = rmesh.mesh_from_spec(mesh)
        pm_ = pmesh.mesh_from_spec(mesh, world=rm.size, rank=0)
    tp = rspmd.resolve_tp_axis(rm)
    layout = rspmd.SpecLayout(tp_axis=tp) if (
        "tp" in rm.axis_names or "fsdp" in rm.axis_names) else None
    want = rspmd.infer_param_specs(
        rmain, RefPlan(rmain, 0, feeds, [rloss.name]), rm, tp, zero1=zero1,
        layout=layout)
    got = pspmd.infer_param_specs(
        pmain, BlockPlan(pmain, feeds, [ploss.name]), pm_,
        pmesh.resolve_tp_axis(pm_), zero1=zero1,
        layout=pspmd.layout_for(pm_))
    assert got == {n: tuple(s) for n, s in want.items()}
    assert pspmd.table_signature(got) == rspmd.table_signature(want)
    if model != "mlp" and mesh == "dp4,tp2":
        # every Y of mul / matmul is numbered, the unfused attention's two
        # products too: the output projection is order 3 in the flash build
        # and 5 in the unfused one, odd in both, so row-parallel in both
        roles = pspmd._param_roles(pmain)
        assert roles["enc0_self_o_w"] == (
            "linear", 3 if model == "tf_flash" else 5)
        assert roles["out_proj_w"] == (
            "linear", 32 if model == "tf_flash" else 44)
        assert got["enc0_self_o_w"] == ("tp", None)
        assert got["enc0_self_q_w"] == (None, "tp")
        assert got["enc0_self_k_w"] == ("tp", None)
        assert got["enc0_self_v_w"] == (None, "tp")
        assert got["out_proj_w"] == (None, "tp")


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("r,v", [(16, 40), (37, 21), (8, 300)])
def test_xent_partials_match_pallas(r, v, soft):
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import pallas_fused as pf
    from paddle_tpu_torch.ops import fused

    rng = np.random.default_rng(r + v)
    x = (rng.standard_normal((r, v)) * 3).astype(np.float32)
    if soft:
        lab = rng.random((r, v)).astype(np.float32)
        plab = jnp.asarray(lab)
    else:
        # labels shifted as on a shard: some fall outside [0, v)
        lab = rng.integers(-v, 2 * v, r).astype(np.int64)
        plab = jnp.asarray(lab.astype(np.int32).reshape(-1, 1))
    want = pf._xent_partial(jnp.asarray(x), plab, soft, 8, 8, True)
    got = fused.softmax_xent_partial(torch.from_numpy(x),
                                     torch.from_numpy(lab), soft)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **XENT_TOL)


def test_reshape_map_moves_the_sharded_dim():
    from paddle_tpu_torch.parallel.placement import _reshape_map

    # [B, T, D] sharded on D -> [B, T, H, Dh] on H, and back
    assert _reshape_map([-1, 8, 64], [-1, 8, 4, 16], 2, 2) == \
        (2, [-1, 8, 2, 16])
    assert _reshape_map([-1, 8, 4, 16], [-1, 8, 64], 2, 2) == \
        (2, [-1, 8, 32])
    assert _reshape_map([-1, 8, 4, 16], [0, 0, 64], 2, 2) == \
        (2, [0, 0, 32])
    # 3 heads do not split over 2 ranks; the batch dim is never sharded
    assert _reshape_map([-1, 8, 48], [-1, 8, 3, 16], 2, 2) is None
    assert _reshape_map([-1, 8, 64], [-1, 64], 0, 2) is None


@pytest.mark.parametrize("axis", ["sp", "pp", "ep"])
def test_axes_still_refused_name_step_4(axis):
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.parallel.mesh import Mesh

    for mesh in (f"dp2,{axis}2", Mesh({"dp": 2, "tp": 2, axis: 2})):
        with pytest.raises(NotImplementedError, match="item 12b, step 4"):
            spmd.check_axes(mesh)
    spmd.check_axes(f"dp2,{axis}1,tp2")
    spmd.check_axes("fsdp2,dp2,tp2")
    with pytest.raises(NotImplementedError, match="one tensor-parallel"):
        spmd.check_axes("tp2,mp2")


if __name__ == "__main__" and "--worker" in sys.argv:
    i = sys.argv.index("--worker")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _rank_main(int(sys.argv[i + 1]), *sys.argv[i + 2:i + 5])
