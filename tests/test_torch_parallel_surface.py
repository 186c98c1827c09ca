"""The data-parallel surface of the port against the JAX package's, in one
process (no spawn): mesh specs and labels, ``DistributeTranspiler``'s
``_dist_info``, the PS dispatchers, the strategies' fields; a world-1
gloo group in which ``ParallelExecutor`` is bitwise ``Executor`` (per
step, as a window, under AllReduce and Reduce); and the refusals: an sp,
pp or ep mesh, ``moe_ffn`` under dp, ``sync_mode=False``, a CUDA place with no
NCCL, a world of more than one with no group, a window under gloo on the
card, a batch-crossing op with no data-parallel form.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid.transpiler import ps_dispatcher as ref_ps
from paddle_tpu.parallel import mesh as ref_mesh
from paddle_tpu_torch.fluid.transpiler import ps_dispatcher as port_ps
from paddle_tpu_torch.ops.collectives import DPGroup
from paddle_tpu_torch.ops.registry import REGISTRY, ExecContext
from paddle_tpu_torch.parallel import mesh as port_mesh
from paddle_tpu_torch.parallel import multihost, spmd

SPECS = ["dp8", "dp4,tp2", "dp2,tp2,pp2", "dp2,mp4", "fsdp2,dp4", "sp8"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_spec_axes_and_labels_match_reference(spec):
    assert port_mesh.parse_mesh_spec(spec) == ref_mesh.parse_mesh_spec(spec)
    ref = ref_mesh.mesh_from_spec(spec)
    port = port_mesh.mesh_from_spec(spec, world=8, rank=5)
    assert port_mesh.mesh_label(port) == ref_mesh.mesh_label(ref)
    assert port_mesh.axes_of(port) == ref_mesh.axes_of(ref)
    assert port_mesh.axes_label(port_mesh.axes_of(spec)) == \
        ref_mesh.axes_label(ref_mesh.axes_of(spec))
    # rank 5's coordinates: its place in the reference's device grid
    where = np.argwhere(np.vectorize(lambda d: d.id)(ref.devices) == 5)[0]
    assert tuple(port.coords.values()) == tuple(int(c) for c in where)


def test_mesh_spec_errors_match_reference():
    for bad in ("dp,4", "dp2,dp2", "", "dp0"):
        with pytest.raises(ValueError) as r:
            ref_mesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as p:
            port_mesh.parse_mesh_spec(bad)
        assert str(p.value) == str(r.value)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        port_mesh.mesh_from_spec("dp4", world=2)
    nd = port_mesh.make_mesh_nd(dp=2, tp=2)
    assert port_mesh.mesh_label(nd) == "dp2xtp2" and nd.size == 4


@pytest.mark.parametrize("sync_mode", [True, False])
def test_distribute_transpiler_dist_info_matches_reference(sync_mode):
    infos = []
    for fluid in (rf, tf):
        prog = fluid.Program()
        t = fluid.DistributeTranspiler()
        t.transpile(1, program=prog, pservers="10.0.0.1:6174,10.0.0.2:6174",
                    trainers=1, sync_mode=sync_mode, mesh="dp4")
        assert t.get_trainer_program() is prog
        with pytest.raises(NotImplementedError):
            t.get_pserver_program("10.0.0.1:6174")
        with pytest.raises(NotImplementedError):
            t.get_startup_program("10.0.0.1:6174")
        infos.append(prog._dist_info)
    assert infos[1] == infos[0]
    with pytest.raises(ValueError, match="bad mesh axis"):
        tf.DistributeTranspiler().transpile(0, program=tf.Program(),
                                            mesh="dp,4")


def test_ps_dispatchers_match_reference():
    names = [f"fc_{i}.w_0" for i in range(11)] + ["emb", "b@GRAD"]
    eps = ["a:1", "b:2", "c:3"]
    for cls in ("HashName", "RoundRobin"):
        r, p = getattr(ref_ps, cls)(eps), getattr(port_ps, cls)(eps)
        assert p.dispatch(names) == r.dispatch(names)
        assert p.dispatch(names[:5]) == r.dispatch(names[:5])
    for kind in ("round_robin", "hash"):
        for n in (1, 3, 4):
            assert port_ps.assign_writer(names, n, kind) == \
                ref_ps.assign_writer(names, n, kind)


def test_strategy_fields_match_reference():
    for cls in ("BuildStrategy", "ExecutionStrategy"):
        r, p = getattr(rf.parallel_executor, cls)(), getattr(tf, cls)()
        assert vars(p) == vars(r)
    for inner in ("ReduceStrategy", "GradientScaleStrategy"):
        assert vars(getattr(tf.BuildStrategy, inner)).keys() >= {
            k for k in vars(getattr(rf.parallel_executor.BuildStrategy,
                                    inner)) if not k.startswith("_")}


def _mlp(fluid=tf, opt="adam"):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 42
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[12], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=16, act="relu")
        h = fluid.layers.batch_norm(input=h)
        pred = fluid.layers.fc(input=h, size=5, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                            label=label))
        (fluid.optimizer.Adam(learning_rate=0.05) if opt == "adam" else
         fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
         ).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["adam", "momentum"])
@pytest.mark.parametrize("zero1", [False, True])
def test_param_spec_table_matches_reference(opt, zero1):
    """The per-state layout of a dp8 mesh (ZeRO-1: each accumulator on its
    first dim 8 divides) against the reference's ``infer_param_specs``."""
    from paddle_tpu.fluid.executor import BlockPlan as RefPlan
    from paddle_tpu.parallel import spmd as ref_spmd
    from paddle_tpu_torch.fluid.executor import BlockPlan

    rmain, _, rloss = _mlp(rf, opt)
    want = ref_spmd.infer_param_specs(
        rmain, RefPlan(rmain, 0, ["img", "label"], [rloss.name]),
        ref_mesh.mesh_from_spec("dp8"), "mp", zero1=zero1)
    pmain, _, ploss = _mlp(tf, opt)
    got = spmd.infer_param_specs(
        pmain, BlockPlan(pmain, ["img", "label"], [ploss.name]),
        port_mesh.Mesh({"dp": 8}), zero1=zero1)
    assert got == {n: tuple(spec) for n, spec in want.items()}
    assert zero1 == any("dp" in spec for spec in got.values())


@pytest.fixture
def world1():
    """A world-1 gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=30))
    yield
    dist.destroy_process_group()


def _feed(step):
    rng = np.random.RandomState(step)
    return {"img": rng.normal(size=(8, 12)).astype(np.float32),
            "label": rng.randint(0, 5, (8, 1)).astype(np.int64)}


def _state(main, scope):
    return {v.name: np.array(scope.get(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and isinstance(scope.get(v.name), torch.Tensor)}


@pytest.mark.parametrize("reduce", [False, True])
def test_world1_gloo_pe_is_bitwise_executor(world1, reduce):
    cpu = tf.CPUPlace()
    runs = []
    for kind in ("exe", "pe", "window"):
        main, startup, loss = _mlp()
        scope = tf.Scope()
        exe = tf.Executor(cpu)
        exe.run(startup, scope=scope)
        if kind == "exe":
            losses = [exe.run(main, feed=_feed(s), fetch_list=[loss],
                              scope=scope)[0] for s in range(3)]
        else:
            bs = tf.BuildStrategy()
            if reduce:
                bs.reduce_strategy = tf.BuildStrategy.ReduceStrategy.Reduce
            pe = tf.ParallelExecutor(loss_name=loss.name, main_program=main,
                                     build_strategy=bs, scope=scope,
                                     place=cpu)
            assert pe.device_count == 1 and pe.mesh_label == "dp1"
            if kind == "pe":
                losses = [pe.run([loss], feed=_feed(s))[0] for s in range(3)]
            else:
                win = {k: np.stack([_feed(s)[k] for s in range(3)])
                       for k in ("img", "label")}
                losses = pe.run_steps([loss], feed=win, n_steps=3,
                                      feed_per_step=True)
        runs.append((losses[-1], _state(main, scope)))
    (l0, s0), *others = runs
    for loss_, state in others:
        np.testing.assert_array_equal(loss_, l0)
        assert state.keys() == s0.keys()
        for n in s0:
            np.testing.assert_array_equal(state[n], s0[n], n)


def test_refusals_tp_mesh_sync_mode_and_crossing_op(world1):
    cpu = tf.CPUPlace()
    main, startup, loss = _mlp()
    # a tp or fsdp mesh runs (tests/test_torch_tensor_parallel.py); the sp,
    # pp and ep axes are still refused, by spec and by Mesh
    for axis in ("sp", "pp", "ep"):
        for mesh in (f"dp1,{axis}2", port_mesh.Mesh({"dp": 1, axis: 2})):
            with pytest.raises(NotImplementedError, match="item 12b, step 4"):
                tf.ParallelExecutor(loss_name=loss.name, main_program=main,
                                    mesh=mesh, place=cpu)
    prog = main.clone()
    tf.DistributeTranspiler().transpile(0, program=prog, trainers=1,
                                        sync_mode=False)
    with pytest.raises(NotImplementedError, match="local SGD"):
        tf.ParallelExecutor(loss_name=loss.name, main_program=prog,
                            place=cpu)
    # a transpose that moves the batch dim has no data-parallel form
    cm, cs = tf.Program(), tf.Program()
    with tf.program_guard(cm, cs), tf.unique_name.guard():
        x = tf.layers.data(name="x", shape=[4], dtype="float32")
        out = tf.layers.reduce_sum(tf.layers.transpose(x, perm=[1, 0]))
    scope = tf.Scope()
    tf.Executor(cpu).run(cs, scope=scope)
    pe = tf.ParallelExecutor(main_program=cm, scope=scope, place=cpu)
    with pytest.raises(NotImplementedError, match="'transpose' crosses"):
        pe.run([out], feed={"x": np.ones((4, 4), np.float32)})


def test_refusals_of_the_group(monkeypatch):
    assert not dist.is_initialized()
    # a CUDA place where torch has no NCCL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.backend_for(tf.CUDAPlace(0))
    monkeypatch.undo()
    # a world of more than one with no group and no rendezvous
    monkeypatch.setenv("PADDLE_TRAINERS", "2")
    monkeypatch.delenv("PADDLE_COORDINATOR_ADDR", raising=False)
    monkeypatch.delenv("PADDLE_PSERVER_EPS", raising=False)
    with pytest.raises(ValueError, match="no coordinator"):
        multihost.init(backend="gloo")
    assert not dist.is_initialized()
    # a window on the card under a group whose collectives a graph cannot
    # capture
    runner = spmd.ShardedWindowRunner(None, torch.device("cuda", 0))
    gloo = DPGroup.__new__(DPGroup)
    gloo.backend, gloo.capturable = "gloo", False
    with pytest.raises(RuntimeError, match="cannot be captured"):
        runner.check(gloo)


def test_moe_refuses_under_dp_and_ring_attention_runs(world1, monkeypatch):
    # moe_ffn on a batch-sharded input: refused when the plan is built
    mm, ms = tf.Program(), tf.Program()
    with tf.program_guard(mm, ms), tf.unique_name.guard():
        x = tf.layers.data(name="x", shape=[8], dtype="float32")
        out, aux = tf.layers.moe_ffn(x, num_experts=2, hidden_size=4,
                                     top_k=1)
        loss = tf.layers.mean(out)
    scope = tf.Scope()
    tf.Executor(tf.CPUPlace()).run(ms, scope=scope)
    pe = tf.ParallelExecutor(loss_name=loss.name, main_program=mm,
                             scope=scope, place=tf.CPUPlace())
    with pytest.raises(NotImplementedError, match="'moe_ffn' crosses"):
        pe.run([loss], feed={"x": np.ones((4, 8), np.float32)})
    # ring_attention over a dp-only group runs; over an sp axis it raises
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    q = torch.zeros(2, 2, 4, 8)
    with spmd.mesh_scope(port_mesh.Mesh({"dp": 2})):
        out = REGISTRY["ring_attention"].fn(ExecContext(
            "ring_attention", {"Q": [q], "K": [q], "V": [q]}, {"Out": ["o"]},
            {}, torch.device("cpu")))
        assert out["Out"].shape == q.shape
    with spmd.mesh_scope(port_mesh.Mesh({"dp": 1, "sp": 2})):
        with pytest.raises(NotImplementedError, match="item 12b"):
            REGISTRY["ring_attention"].fn(ExecContext(
                "ring_attention", {"Q": [q], "K": [q], "V": [q]},
                {"Out": ["o"]}, {}, torch.device("cpu")))
