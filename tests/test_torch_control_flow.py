"""Control flow in the port against the JAX package, on the CPU: the seven
programs of the reference's ``tests/test_control_flow.py`` (a While over
tensor arrays, a While's grad, StaticRNN trained with Adam, DynamicRNN's
running sums on a ragged batch, DynamicRNN trained with Adam, IfElse,
Switch), each built by the same calls in both packages:

 - the Programs are the same: every block's parent, its ops' types,
   input and output names and sub-block indices;
 - the port starts from the reference's initialized scope and runs the
   same feeds: every fetched output (LoD included) within rtol 1e-5, the
   losses of a training run within rtol 1e-5 at step 0 and 1e-4 after,
   and the grads ``while_grad`` gives (the input's, and each parameter's
   at step 0) within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def program_signature(program):
    """Every block's (index, parent, ops), each op as (type, inputs,
    outputs, sub-block index)."""
    return [(b.idx, b.parent_idx,
             [(op.type, {k: list(v) for k, v in op.inputs.items()},
               {k: list(v) for k, v in op.outputs.items()},
               op.attr("sub_block")) for op in b.ops])
            for b in program.blocks]


def as_numpy(v):
    """(values, LoD) of a fetched value of either package."""
    if hasattr(v, "lod") and callable(v.lod):
        return np.asarray(v), tuple(tuple(int(o) for o in lvl)
                                    for lvl in v.lod())
    if isinstance(v, torch.Tensor):
        return v.detach().numpy(), ()
    return np.asarray(v), ()


# -- the seven programs, built with either package's fluid ------------------


def build_while_sum(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        d = [layers.data(f"d{k}", shape=[10], dtype="float32",
                         append_batch_size=False) for k in range(3)]
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        i.stop_gradient = True
        init = layers.zeros(shape=[10], dtype="float32")
        mem_array = layers.array_write(x=init, i=i)
        data_array = layers.array_write(x=d[0], i=i)
        i = layers.increment(i)
        layers.array_write(d[1], i, array=data_array)
        i = layers.increment(i)
        layers.array_write(d[2], i, array=data_array)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        i.stop_gradient = True
        array_len = layers.fill_constant(shape=[1], dtype="int64", value=3)
        array_len.stop_gradient = True
        cond = layers.less_than(x=i, y=array_len)
        while_op = layers.While(cond=cond)
        with while_op.block():
            di = layers.array_read(array=data_array, i=i)
            prev = layers.array_read(array=mem_array, i=i)
            result = layers.sums(input=[di, prev])
            i = layers.increment(x=i, in_place=True)
            layers.array_write(result, i=i, array=mem_array)
            layers.less_than(x=i, y=array_len, cond=cond)
        sum_result = layers.array_read(array=mem_array, i=i)
        layers.mean(sum_result)
    rng = np.random.RandomState(0)
    feed = {f"d{k}": rng.rand(10).astype(np.float32) for k in range(3)}
    return main, startup, [sum_result.name], [feed]


def build_while_grad(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[4], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        i.stop_gradient = True
        n = layers.fill_constant(shape=[1], dtype="int64", value=3)
        n.stop_gradient = True
        acc_arr = layers.array_write(x=x, i=i)
        cond = layers.less_than(x=i, y=n)
        w = layers.While(cond=cond)
        with w.block():
            prev = layers.array_read(array=acc_arr, i=i)
            doubled = layers.tanh(layers.scale(prev, scale=2.0))
            i = layers.increment(x=i, in_place=True)
            layers.array_write(doubled, i=i, array=acc_arr)
            layers.less_than(x=i, y=n, cond=cond)
        final = layers.array_read(array=acc_arr, i=i)
        loss = layers.reduce_sum(final)
        g = fluid.calc_gradient(loss, x)[0]
    feed = {"x": np.array([0.1, -0.2, 0.3, 0.05], np.float32)}
    return main, startup, [loss.name, g.name], [feed]


def build_static_rnn(fluid):
    layers = fluid.layers
    t_len, batch, dim = 4, 5, 8
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[t_len, batch, dim], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        label = layers.data("label", shape=[batch, 1], dtype="float32",
                            append_batch_size=False)
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, dim], batch_ref=xt,
                             ref_batch_dim_idx=0)
            hidden = layers.fc([xt, mem], size=dim, act="tanh")
            rnn.update_memory(mem, hidden)
            rnn.step_output(hidden)
        outs = rnn()
        last = layers.slice(outs, axes=[0], starts=[t_len - 1],
                            ends=[t_len])
        last = layers.reshape(last, shape=[batch, dim])
        pred = layers.fc(last, size=1)
        loss = layers.reduce_mean(layers.square_error_cost(pred, label))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    rng = np.random.RandomState(1)
    xv = rng.randn(t_len, batch, dim).astype(np.float32)
    feed = {"x": xv, "label": xv[0, :, :1].copy()}
    return main, startup, [loss.name], [feed] * 30


def build_dynamic_rnn_sums(fluid):
    layers = fluid.layers
    dim, lens = 4, [3, 1, 2]
    xv = np.random.RandomState(2).randn(sum(lens), dim).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[dim], dtype="float32", lod_level=1)
        x.stop_gradient = False
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            mem = drnn.memory(shape=[dim], value=0.0)
            new_mem = layers.elementwise_add(xt, mem)
            drnn.update_memory(mem, new_mem)
            drnn.output(new_mem)
        outs = drnn()
        last = layers.sequence_last_step(outs)
        layers.reduce_sum(last)
    feed = {"x": fluid.create_lod_tensor(xv, [lens])}
    return main, startup, [outs.name, last.name], [feed]


def build_dynamic_rnn_fc(fluid):
    layers = fluid.layers
    dim, hid = 6, 8
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[dim], dtype="float32", lod_level=1)
        x.stop_gradient = False
        label = layers.data("label", shape=[1], dtype="float32")
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            mem = drnn.memory(shape=[hid], value=0.0)
            hidden = layers.fc([xt, mem], size=hid, act="tanh")
            drnn.update_memory(mem, hidden)
            drnn.output(hidden)
        outs = drnn()
        last = layers.sequence_last_step(outs)
        pred = layers.fc(last, size=1)
        loss = layers.reduce_mean(layers.square_error_cost(pred, label))
        fluid.optimizer.Adam(learning_rate=0.03).minimize(loss)
    rng = np.random.RandomState(3)
    feeds = []
    for step in range(24):
        lens = [[3, 2, 4, 2], [2, 5, 3, 1]][step % 2]
        xv = rng.randn(sum(lens), dim).astype(np.float32)
        starts = np.cumsum([0] + lens[:-1])
        feeds.append({"x": fluid.create_lod_tensor(xv, [lens]),
                      "label": xv[starts, :1].astype(np.float32)})
    return main, startup, [loss.name], feeds


def build_ifelse(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[1], dtype="float32",
                        append_batch_size=False)
        zero = layers.fill_constant(shape=[5, 1], dtype="float32", value=0.0)
        cond = layers.less_than(zero, x)
        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(layers.scale(ie.input(x), scale=10.0))
        with ie.false_block():
            ie.output(layers.scale(ie.input(x), scale=-1.0))
        out = ie()
    feed = {"x": np.array([[1.0], [-2.0], [3.0], [-4.0], [5.0]], np.float32)}
    return main, startup, [out.name], [feed]


def build_switch(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="lr")
        one = layers.fill_constant(shape=[1], dtype="float32", value=1.0,
                                   force_cpu=True)
        two = layers.fill_constant(shape=[1], dtype="float32", value=2.0,
                                   force_cpu=True)
        with layers.Switch() as switch:
            with switch.case(layers.less_than(one, two)):
                layers.assign(input=one, output=lr)
            with switch.default():
                layers.assign(input=two, output=lr)
    return main, startup, ["lr"], [{}]


CASES = {"while_sum": build_while_sum, "while_grad": build_while_grad,
         "static_rnn": build_static_rnn,
         "dynamic_rnn_sums": build_dynamic_rnn_sums,
         "dynamic_rnn_fc": build_dynamic_rnn_fc, "ifelse": build_ifelse,
         "switch": build_switch}
TRAINED = ("static_rnn", "dynamic_rnn_fc")


def run_both(build):
    """The reference's and the port's fetches of every step, the port from
    the reference's initialized scope; at step 0 each parameter's grad
    too."""
    rmain, rstart, fetches, rfeeds = build(rf)
    pmain, pstart, pfetches, pfeeds = build(tf)
    assert program_signature(pmain) == program_signature(rmain)
    assert program_signature(pstart) == program_signature(rstart)
    assert pfetches == fetches
    params = [p.name + "@GRAD" for p in rmain.global_block().all_parameters()]
    rexe, rscope = rf.Executor(rf.CPUPlace()), rf.executor.Scope()
    rexe.run(rstart, scope=rscope)
    pexe, pscope = tf.Executor(tf.CPUPlace()), tf.Scope()
    pexe.run(pstart, scope=pscope)
    init = {v.name: np.asarray(rscope.get(v.name))
            for v in rstart.list_vars() if v.persistable}
    load_reference_params(pscope, init, tf.CPUPlace())
    got, want = [], []
    for step, (rfeed, pfeed) in enumerate(zip(rfeeds, pfeeds)):
        names = fetches + (params if step == 0 else [])
        want.append([as_numpy(v) for v in rexe.run(
            rmain, feed=rfeed, fetch_list=names, scope=rscope,
            return_numpy=False)])
        got.append([as_numpy(v) for v in pexe.run(
            pmain, feed=pfeed, fetch_list=names, scope=pscope,
            return_numpy=False)])
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_matches_reference(case):
    got, want = run_both(CASES[case])
    for step, (g_step, w_step) in enumerate(zip(got, want)):
        rtol = RTOL if step == 0 or case not in TRAINED else 1e-4
        for (g, g_lod), (w, w_lod) in zip(g_step, w_step):
            assert g_lod == w_lod
            assert g.shape == w.shape or g.size == w.size
            np.testing.assert_allclose(g.reshape(w.shape), w, rtol=rtol,
                                       atol=1e-7)


def test_while_grad_values():
    """The loop's grad by the chain rule: d sum(tanh(2 tanh(2 tanh(2x)))),
    and the port's equal to it and to the reference's."""
    got, want = run_both(build_while_grad)
    x = np.array([0.1, -0.2, 0.3, 0.05], np.float64)
    h, d = x, np.ones_like(x)
    for _ in range(3):
        h = np.tanh(2 * h)
        d = d * 2 * (1 - h ** 2)
    np.testing.assert_allclose(got[0][0][0], [h.sum()], rtol=RTOL)
    np.testing.assert_allclose(got[0][1][0], d, rtol=RTOL)
    np.testing.assert_allclose(got[0][1][0], want[0][1][0], rtol=RTOL)


def test_dynamic_rnn_trains_in_port():
    """DynamicRNN with parameters and a memory learns in the port, as the
    reference test holds it."""
    got, _ = run_both(build_dynamic_rnn_fc)
    losses = [float(s[0][0].reshape(-1)[0]) for s in got]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])


def test_counters_stay_on_host():
    """The While's counter, bound and condition are host values: the loop
    reads no device value."""
    from paddle_tpu_torch.fluid import control_flow_exec as cfe

    main, startup, fetches, feeds = build_while_sum(tf)
    hosts = cfe.host_names(main)
    consts = [op.output_arg_names[0] for op in main.global_block().ops
              if op.type == "fill_constant"]
    # the counters and the bound; the array's init value (consts[1]) is
    # read as an array entry: a device tensor
    assert hosts == set(consts) - {consts[1]}
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup)
    cfe.reset_stats()
    exe.run(main, feed=feeds[0], fetch_list=fetches)
    assert cfe.stats == {"while_iterations": 3, "host_reads": 0}
