"""``fluid.ParallelExecutor`` over two ranks, held against the JAX
package's ``ParallelExecutor`` (one process, its 8-device CPU mesh) and
its ``Executor`` at the same global batch.

One module-scoped spawn starts two processes that join one gloo group (a
``FileStore`` under the test's temporary directory, a 60 s collective
timeout; the spawn as a whole is cut at ``SPAWN_TIMEOUT_S``) and run every
scenario in order, each rank feeding its half of every global batch; the
ranks hand their results back through pickles.  The parent computes the
reference's numbers and starts from the reference's initial scope (copied
before step 0, dropout 0):

 - the MLP under AllReduce and Reduce (ZeRO-1), 5 Momentum steps: losses
   at the reference's own rtol 2e-4 (``tests/test_parallel_executor.py``);
 - the MLP with its grads clipped by their global norm, under Reduce:
   the norm over every rank's summed grads;
 - dropout: each rank draws its own masks; a draw no batch-sharded input
   shapes, or one with a fixed seed, raises;
 - the ``reduce_*`` ops over the batch and ``accuracy``, 3 SGD steps;
 - a conv + batch_norm net, 3 SGD steps: losses at rtol 5e-4 and the
   running statistics at rtol 1e-5 (global batch statistics);
 - a tiny Transformer through ``ring_attention`` with Adam under Reduce;
 - a ``run_steps`` window bitwise the same steps run one by one;
 - unequal local batches raise the named error on both ranks;
 - ranks started from different parameters agree after the first run;
 - ``Trainer(parallel=True)``, the per-step and the windowed loop, against
   the reference Trainer's losses, rank 0 alone writing the serial.

Run as a script (``python this_file --worker RANK ...``) it is one rank.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

WORLD = 2
SPAWN_TIMEOUT_S = 240
GLOO_TIMEOUT_S = 60
MLP_STEPS, MLP_BATCH = 5, 16
CONV_STEPS, CONV_BATCH = 3, 16
TF_STEPS, TF_BATCH, TF_LEN = 3, 4, 8
TR_STEPS, TR_BATCH = 4, 8
RED_STEPS = 3
CLIP_NORM = 0.2
DROP_STEPS, DROP_BATCH, DROP_WIDTH = 2, 16, 32


# -- programs, in either package's fluid ------------------------------------

def mlp(fluid, clip_norm=None):
    """With ``clip_norm``, the grads clipped by their global norm."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 42
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[64], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        if clip_norm is not None:
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(clip_norm))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def dropout_net(fluid, draw=None):
    """fc -> dropout -> fc, SGD; ``draw``: "seeded" gives the dropout a
    fixed seed, "replicated" adds a ``uniform_random`` draw to the loss."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[DROP_WIDTH], dtype="float32")
        h = fluid.layers.fc(input=x, size=DROP_WIDTH)
        h = fluid.layers.dropout(h, 0.5,
                                 seed=7 if draw == "seeded" else None)
        loss = fluid.layers.mean(fluid.layers.fc(input=h, size=1))
        if draw == "replicated":
            loss = loss + fluid.layers.reduce_sum(
                fluid.layers.uniform_random([2]))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    mask = next(op.output("Mask")[0] for op in main.global_block().ops
                if op.type == "dropout")
    return main, startup, loss, mask


def conv_bn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(input=img, num_filters=8, filter_size=3,
                                padding=1, act=None, bias_attr=False)
        c = fluid.layers.batch_norm(input=c, act="relu")
        p = fluid.layers.pool2d(input=c, pool_size=2, pool_stride=2,
                                pool_type="max")
        pred = fluid.layers.fc(input=p, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def transformer(fluid, tm):
    cfg = tm.tiny_config()
    cfg.ring_attention, cfg.dropout, cfg.n_layer = True, 0.0, 1
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cost = tm.build(cfg, src_len=TF_LEN, tgt_len=TF_LEN)[3]
    return main, startup, cost


def reductions(fluid):
    """Losses through ``reduce_max`` / ``reduce_min`` / ``reduce_sum`` over
    the batch, a ``reduce_mean`` over everything and ``accuracy``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=4)
        loss = fluid.layers.sums([
            fluid.layers.mean(fluid.layers.reduce_max(h, dim=0)),
            fluid.layers.mean(fluid.layers.reduce_min(h, dim=0,
                                                      keep_dim=True)),
            fluid.layers.mean(fluid.layers.reduce_sum(h, dim=[0]))])
        avg = fluid.layers.reduce_mean(h)
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(h),
                                    label=label, k=2)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [loss, avg, acc]


def trainer_funcs(fluid):
    def train_func():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
    return train_func, lambda: fluid.optimizer.Adam(learning_rate=0.05)


def trainer_samples():
    rng = np.random.RandomState(3)
    for _ in range(TR_STEPS * TR_BATCH):
        yield (rng.normal(size=4).astype(np.float32),
               rng.normal(size=1).astype(np.float32))


def trainer_reader(rank=None):
    """``TR_STEPS`` global batches of ``TR_BATCH``; with ``rank``, that
    rank's half of each."""
    def reader():
        samples = list(trainer_samples())
        for s in range(TR_STEPS):
            batch = samples[s * TR_BATCH:(s + 1) * TR_BATCH]
            if rank is not None:
                half = TR_BATCH // WORLD
                batch = batch[rank * half:(rank + 1) * half]
            yield batch
    return reader


def data():
    rng = np.random.RandomState(0)
    mlp_feed = {"img": rng.normal(size=(MLP_BATCH, 64)).astype(np.float32),
                "label": rng.randint(0, 10, (MLP_BATCH, 1)).astype(np.int64)}
    rng = np.random.RandomState(1)
    conv_feeds = [
        {"img": rng.normal(size=(CONV_BATCH, 3, 16, 16)).astype(np.float32),
         "label": rng.randint(0, 10, (CONV_BATCH, 1)).astype(np.int64)}
        for _ in range(CONV_STEPS)]
    red_feed = {"x": rng.normal(size=(MLP_BATCH, 6)).astype(np.float32),
                "label": rng.randint(0, 4, (MLP_BATCH, 1)).astype(np.int64)}
    rng = np.random.default_rng(0)
    tf_feed = {"src_word": rng.integers(1, 1000, (TF_BATCH, TF_LEN)),
               "tgt_word": rng.integers(1, 1000, (TF_BATCH, TF_LEN)),
               "lbl_word": rng.integers(1, 1000, (TF_BATCH, TF_LEN, 1))}
    tf_feed["src_word"][0, -2:] = 0
    tf_feed["lbl_word"][3, -3:] = 0
    tf_feed = {k: v.astype(np.int64) for k, v in tf_feed.items()}
    return mlp_feed, conv_feeds, tf_feed, red_feed


def shard(feed, rank):
    n = len(next(iter(feed.values()))) // WORLD
    return {k: v[rank * n:(rank + 1) * n] for k, v in feed.items()}


# -- one rank ---------------------------------------------------------------

def _rank_main(rank, store, job_path, out_path):
    import datetime

    import torch.distributed as dist

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer as tm
    from paddle_tpu_torch.models.params import load_reference_params
    from paddle_tpu_torch.parallel import spmd

    dist.init_process_group(
        "gloo", store=dist.FileStore(store, WORLD), rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    cpu = fluid.CPUPlace()
    mlp_feed, conv_feeds, tf_feed, red_feed = data()
    out = {}

    def fresh(build, init, *args):
        main, startup, loss = build(fluid, *args)
        scope = fluid.Scope()
        fluid.Executor(cpu).run(startup, scope=scope)
        load_reference_params(scope, init, cpu)
        return main, loss, scope

    def pe(main, loss, scope, reduce=False):
        bs = fluid.BuildStrategy()
        if reduce:
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        return fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                      build_strategy=bs, scope=scope,
                                      place=cpu)

    def params(main, scope):
        return {p.name: np.array(scope.get(p.name))
                for p in main.global_block().all_parameters()}

    for reduce in (False, True):
        main, loss, scope = fresh(mlp, job["mlp"])
        exe = pe(main, loss, scope, reduce)
        out[f"mlp_{int(reduce)}"] = [
            float(exe.run([loss], feed=shard(mlp_feed, rank))[0][0])
            for _ in range(MLP_STEPS)]

    main, loss, scope = fresh(mlp, job["mlp"], CLIP_NORM)
    exe = pe(main, loss, scope, reduce=True)
    out["mlp_clip"] = [
        float(exe.run([loss], feed=shard(mlp_feed, rank))[0][0])
        for _ in range(MLP_STEPS)]
    out["mlp_clip_whole_for"] = [st.whole_grads_for
                                 for st in exe._steps.values()]

    # every rank feeds the same rows: only the draws tell the ranks apart
    main, startup, loss, mask = dropout_net(fluid)
    scope = fluid.Scope()
    fluid.Executor(cpu).run(startup, scope=scope)
    exe = pe(main, loss, scope)
    xs = np.random.RandomState(4).normal(
        size=(DROP_BATCH, DROP_WIDTH)).astype(np.float32)
    out["dropout_masks"] = [np.asarray(exe.run([mask], feed={"x": xs})[0])
                            for _ in range(DROP_STEPS)]
    out["dropout_params"] = params(main, scope)
    out["dropout_refused"] = {}
    for draw in ("seeded", "replicated"):
        main, startup, loss, _ = dropout_net(fluid, draw)
        scope = fluid.Scope()
        fluid.Executor(cpu).run(startup, scope=scope)
        try:
            pe(main, loss, scope).run([loss], feed={"x": xs})
            out["dropout_refused"][draw] = None
        except NotImplementedError as exc:
            out["dropout_refused"][draw] = str(exc)

    main, loss, scope = fresh(conv_bn, job["conv"])
    exe = pe(main, loss, scope)
    out["conv"] = [float(exe.run([loss], feed=shard(f, rank))[0][0])
                   for f in conv_feeds]
    out["conv_stats"] = {n: np.array(scope.get(n)) for n in job["bn_stats"]}

    main, fetches, scope = fresh(reductions, job["red"])
    exe = pe(main, fetches[0], scope)
    out["red"] = [[float(np.asarray(v).reshape(-1)[0]) for v in exe.run(
        fetches, feed=shard(red_feed, rank))] for _ in range(RED_STEPS)]

    main, loss, scope = fresh(transformer, job["tf"], tm)
    exe = pe(main, loss, scope, reduce=True)
    out["tf"] = [float(exe.run([loss], feed=shard(tf_feed, rank))[0][0])
                 for _ in range(TF_STEPS)]

    runs = []
    for window in (False, True):
        main, loss, scope = fresh(mlp, job["mlp"])
        exe = pe(main, loss, scope)
        local = shard(mlp_feed, rank)
        if window:
            last = exe.run_steps([loss], feed={k: np.stack([v] * 3) for k, v
                                               in local.items()},
                                 n_steps=3, feed_per_step=True)
        else:
            last = [exe.run([loss], feed=local) for _ in range(3)][-1]
        runs.append((np.asarray(last[0]), params(main, scope)))
    out["window"] = runs

    main, loss, scope = fresh(mlp, job["mlp"])
    exe = pe(main, loss, scope)
    try:
        exe.run([loss], feed=shard(mlp_feed, rank) if rank == 0 else
                {k: v[:3] for k, v in shard(mlp_feed, rank).items()})
        out["unequal"] = None
    except spmd.UnequalBatchError as exc:
        out["unequal"] = str(exc)

    main, loss, scope = fresh(mlp, job["mlp"])
    if rank == 1:
        for p in main.global_block().all_parameters():
            scope.get(p.name).add_(1.0)
    exe = pe(main, loss, scope)
    out["bcast_loss"] = float(exe.run([loss],
                                      feed=shard(mlp_feed, rank))[0][0])
    out["bcast_params"] = params(main, scope)

    from paddle_tpu_torch import data as port_data

    for spd in ("0", "2"):
        os.environ["PADDLE_TPU_SPD"] = spd
        # the windowed run reads a checkpointable pipeline, every rank its
        # shard of each global batch (the same samples, interleaved), so
        # each serial carries both ranks' data states
        reader = trainer_reader(rank) if spd == "0" else (
            port_data.from_reader(trainer_samples).shard(WORLD, rank)
            .batch(TR_BATCH // WORLD))
        ckpt = os.path.join(job["tmp"], f"ckpt_{spd}")
        losses = []
        with fluid.scope_guard(fluid.Scope()):
            train_func, opt = trainer_funcs(fluid)
            tr = fluid.Trainer(train_func, opt, place=cpu, parallel=True,
                               checkpoint_config=fluid.CheckpointConfig(
                                   ckpt, step_interval=2))
            load_reference_params(fluid.global_scope(), job["trainer"], cpu)

            def handler(ev):
                if isinstance(ev, fluid.EndStepEvent):
                    losses.append(float(np.asarray(
                        ev.metrics[0]).reshape(-1)[0]))
            tr.train(1, handler, reader=reader, feed_order=["x", "y"])
        out[f"trainer_{spd}"] = losses
    os.environ.pop("PADDLE_TPU_SPD", None)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# -- the reference, and the spawn ---------------------------------------------

def _reference(tmp):
    import paddle_tpu.fluid as rf
    from paddle_tpu.fluid import framework as ref_framework
    from paddle_tpu.models import transformer as ref_tm

    mlp_feed, conv_feeds, tf_feed, red_feed = data()
    job, ref = {"tmp": tmp}, {}

    def init_of(main, startup, scope):
        rf.Executor(rf.CPUPlace()).run(startup, scope=scope)
        return {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars()
                if v.persistable and scope.get(v.name) is not None}

    def losses(run, feeds):
        return [float(np.asarray(run(f)[0]).reshape(-1)[0]) for f in feeds]

    for name, build, feeds in (("mlp", mlp, [mlp_feed] * MLP_STEPS),
                               ("conv", conv_bn, conv_feeds)):
        variants = [None] if name == "conv" else [0, 1]
        for reduce in ["exe"] + variants:
            ref_framework.fresh_session()
            main, startup, loss = build(rf)
            scope = rf.Scope()
            init = init_of(main, startup, scope)
            job.setdefault(name, init)
            with rf.scope_guard(scope):
                if reduce == "exe":
                    exe = rf.Executor(rf.CPUPlace())
                    ref[f"{name}_exe"] = losses(lambda f: exe.run(
                        main, feed=f, fetch_list=[loss]), feeds)
                    stats = [n for n in init if "batch_norm" in n
                             and ("mean" in n or "variance" in n)]
                    if stats:
                        job["bn_stats"] = stats
                        ref["bn_stats"] = {n: np.array(scope.get(n))
                                           for n in stats}
                    continue
                bs = rf.parallel_executor.BuildStrategy()
                if reduce:
                    bs.reduce_strategy = bs.ReduceStrategy.Reduce
                pe = rf.ParallelExecutor(loss_name=loss.name,
                                         main_program=main,
                                         build_strategy=bs)
                assert pe.device_count == 8
                ref[f"{name}_pe{'' if reduce is None else reduce}"] = losses(
                    lambda f: pe.run([loss], feed=f), feeds)
    ref_framework.fresh_session()
    main, startup, loss = mlp(rf, CLIP_NORM)
    scope = rf.Scope()
    assert init_of(main, startup, scope).keys() == job["mlp"].keys()
    for n, v in job["mlp"].items():
        scope.set(n, v)
    exe = rf.Executor(rf.CPUPlace())
    ref["mlp_clip_exe"] = losses(lambda f: exe.run(
        main, feed=f, fetch_list=[loss], scope=scope), [mlp_feed] * MLP_STEPS)
    ref_framework.fresh_session()
    main, startup, fetches = reductions(rf)
    scope = rf.Scope()
    job["red"] = init_of(main, startup, scope)
    exe = rf.Executor(rf.CPUPlace())
    ref["red"] = [[float(np.asarray(v).reshape(-1)[0]) for v in exe.run(
        main, feed=red_feed, fetch_list=fetches, scope=scope)]
        for _ in range(RED_STEPS)]
    ref_framework.fresh_session()
    main, startup, cost = transformer(rf, ref_tm)
    scope = rf.Scope()
    job["tf"] = init_of(main, startup, scope)
    exe = rf.Executor(rf.CPUPlace())
    ref["tf"] = losses(lambda f: exe.run(main, feed=f, fetch_list=[cost],
                                         scope=scope), [tf_feed] * TF_STEPS)
    ref_framework.fresh_session()
    with rf.scope_guard(rf.Scope()):
        train_func, opt = trainer_funcs(rf)
        tr = rf.Trainer(train_func, opt, place=rf.CPUPlace())
        scope = rf.global_scope()
        job["trainer"] = {v.name: np.array(scope.get(v.name))
                          for v in tr.train_program.list_vars()
                          if v.persistable and scope.get(v.name) is not None}
        trl = []
        tr.train(1, lambda ev: isinstance(ev, rf.EndStepEvent) and trl.append(
            float(np.asarray(ev.metrics[0]).reshape(-1)[0])),
            reader=trainer_reader(), feed_order=["x", "y"])
        ref["trainer"] = trl
    return job, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    job, ref = _reference(tmp)
    job_path = os.path.join(tmp, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("PADDLE_TPU_SPD", None)
    outs = [os.path.join(tmp, f"out_{r}.pkl") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         os.path.join(tmp, "store"), job_path, outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
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
    return ref, ranks, tmp


@pytest.mark.parametrize("reduce", [0, 1])
def test_mlp_matches_reference_pe_and_executor(runs, reduce):
    ref, ranks, _ = runs
    for out in ranks:
        got = out[f"mlp_{reduce}"]
        np.testing.assert_allclose(got, ref["mlp_exe"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, ref[f"mlp_pe{reduce}"], rtol=2e-4,
                                   atol=2e-4)
    assert ranks[0][f"mlp_{reduce}"] == ranks[1][f"mlp_{reduce}"]
    assert ref["mlp_exe"][-1] < ref["mlp_exe"][0]


def test_global_norm_clip_under_zero1_sees_the_summed_grads(runs):
    """The clip's norm reads every grad whole, so ZeRO-1 all-reduces the
    bucket (the update still runs on the chunks); the losses follow the
    reference's clipped run, which the clip moved."""
    ref, ranks, _ = runs
    clipped = np.abs(np.array(ref["mlp_clip_exe"]) - ref["mlp_exe"])
    assert clipped[1:].min() > 1e-3
    for out in ranks:
        np.testing.assert_allclose(out["mlp_clip"], ref["mlp_clip_exe"],
                                   rtol=2e-4, atol=2e-4)
        assert out["mlp_clip_whole_for"] == ["elementwise_mul"]
    assert ranks[0]["mlp_clip"] == ranks[1]["mlp_clip"]


def test_dropout_draws_each_ranks_own_masks(runs):
    """The ranks feed the same rows; their masks differ, each keeps about
    half, and the parameters stay equal across the ranks."""
    _, ranks, _ = runs
    n = DROP_BATCH * DROP_WIDTH
    for step in range(DROP_STEPS):
        a, b = (out["dropout_masks"][step] for out in ranks)
        assert a.shape == b.shape == (DROP_BATCH, DROP_WIDTH)
        assert np.mean(a != b) > 0.3
        for m in (a, b):
            assert set(np.unique(m)) <= {0.0, 1.0}
            assert abs(m.mean() - 0.5) < 5 * np.sqrt(0.25 / n)
    assert not np.array_equal(ranks[0]["dropout_masks"][0],
                              ranks[0]["dropout_masks"][1])
    for name, v in ranks[0]["dropout_params"].items():
        np.testing.assert_array_equal(ranks[1]["dropout_params"][name], v,
                                      name)
    for out in ranks:
        refused = out["dropout_refused"]
        assert refused["seeded"] is not None and "fixed seed 7" in \
            refused["seeded"]
        assert refused["replicated"] is not None and "'uniform_random' " \
            "draws a value" in refused["replicated"]


def test_conv_batch_norm_uses_global_statistics(runs):
    ref, ranks, _ = runs
    for out in ranks:
        np.testing.assert_allclose(out["conv"], ref["conv_exe"], rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(out["conv"], ref["conv_pe"], rtol=5e-4,
                                   atol=5e-4)
        assert sorted(out["conv_stats"]) == sorted(ref["bn_stats"])
        for n, v in ref["bn_stats"].items():
            np.testing.assert_allclose(out["conv_stats"][n], v, rtol=1e-5,
                                       atol=1e-6, err_msg=n)


def test_batch_reductions_and_accuracy_span_every_rank(runs):
    """Loss, the mean over everything and accuracy each step; the SGD
    steps go through the extremes' and sums' grads."""
    ref, ranks, _ = runs
    want = np.array(ref["red"])
    for out in ranks:
        got = np.array(out["red"])
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert ranks[0]["red"] == ranks[1]["red"]


def test_transformer_ring_attention_adam_zero1(runs):
    ref, ranks, _ = runs
    for out in ranks:
        np.testing.assert_allclose(out["tf"], ref["tf"], rtol=2e-4)
    assert ranks[0]["tf"] == ranks[1]["tf"]


def test_window_is_bitwise_the_per_step_runs(runs):
    _, ranks, _ = runs
    for out in ranks:
        (step_loss, step_params), (win_loss, win_params) = out["window"]
        np.testing.assert_array_equal(win_loss, step_loss)
        for n in step_params:
            np.testing.assert_array_equal(win_params[n], step_params[n], n)


def test_unequal_local_batches_raise_by_name(runs):
    _, ranks, _ = runs
    for out in ranks:
        msg = out["unequal"]
        assert msg is not None and "local batches differ" in msg
        assert "'img' batch 8" in msg and "'img' batch 3" in msg


def test_ranks_from_different_params_agree_after_first_run(runs):
    _, ranks, _ = runs
    assert ranks[0]["bcast_loss"] == ranks[1]["bcast_loss"]
    assert ranks[0]["bcast_loss"] == ranks[0]["mlp_0"][0]
    for n, v in ranks[0]["bcast_params"].items():
        np.testing.assert_array_equal(ranks[1]["bcast_params"][n], v, n)


@pytest.mark.parametrize("spd", ["0", "2"])
def test_trainer_parallel_matches_reference_trainer(runs, spd):
    ref, ranks, tmp = runs
    for out in ranks:
        np.testing.assert_allclose(out[f"trainer_{spd}"],
                                   ref["trainer"][:len(out[f"trainer_{spd}"])]
                                   if spd == "0" else ref["trainer"][1::2],
                                   rtol=1e-5)
    assert ranks[0][f"trainer_{spd}"] == ranks[1][f"trainer_{spd}"]
    root = os.path.join(tmp, f"ckpt_{spd}")
    serials = sorted(os.listdir(root))
    want = {"_SUCCESS"} | ({f"data_state_{r}.json" for r in range(WORLD)}
                           if spd == "2" else set())
    assert serials and all(want <= set(os.listdir(os.path.join(root, s)))
                           for s in serials)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _rank_main(int(sys.argv[2]), *sys.argv[3:6])
