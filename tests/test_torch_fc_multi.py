"""``layers.fc`` over several inputs, in the port against the JAX package,
on the CPU.

The reference emits one ``mul`` per input, a ``sum`` over their results,
then the bias and the activation (``paddle_tpu/fluid/layers/nn.py`` fc).
The same builder calls in both packages must give the same Program (op
types, order and the ``sum``'s inputs), and, from the reference's initial
parameters copied into the port, the same output, parameter grads and
SGD step.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import params as port_params

RNG = np.random.default_rng(11)
FEED = {"a": RNG.standard_normal((5, 3)).astype(np.float32),
        "b": RNG.standard_normal((5, 2, 2)).astype(np.float32)}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _build(fluid, act):
    """(main, startup, out, loss): fc over a [N, 3] and a [N, 2, 2] input
    to 4 units, a mean loss and one SGD update."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        a = fluid.layers.data("a", shape=[3])
        b = fluid.layers.data("b", shape=[2, 2])
        out = fluid.layers.fc([a, b], size=4, act=act)
        loss = fluid.layers.mean(out)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, out, loss


def _forward_ops(main):
    return [op for op in main.global_block().ops
            if op.type in ("mul", "sum", "elementwise_add", "relu",
                           "softmax")]


@pytest.mark.parametrize("act", [None, "relu", "softmax"])
def test_program_matches_reference(act):
    ref_main = _build(rf, act)[0]
    port_main = _build(tf, act)[0]
    ref_types = [op.type for op in ref_main.global_block().ops]
    assert [op.type for op in port_main.global_block().ops] == ref_types
    fwd = _forward_ops(port_main)
    assert [op.type for op in fwd[:4]] == ["mul", "mul", "sum",
                                           "elementwise_add"]
    muls, total = fwd[:2], fwd[2]
    assert total.input("X") == [m.output("Out")[0] for m in muls]
    assert fwd[3].input("X") == total.output("Out")
    for ref_op, port_op in zip(_forward_ops(ref_main), fwd):
        assert (port_op.type, port_op.inputs, port_op.outputs) == (
            ref_op.type, ref_op.inputs, ref_op.outputs)


@pytest.mark.parametrize("act", [None, "relu", "softmax"])
def test_output_grads_and_step_match_reference(act):
    results, init = [], None
    for pkg in (rf, tf):
        main, startup, out, loss = _build(pkg, act)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        params = sorted(p.name for p in main.global_block().all_parameters())
        if init is None:  # the reference's initial parameters
            init = {n: np.array(scope.get(n)) for n in params}
        else:
            port_params.load_reference_params(scope, init, tf.CPUPlace())
        fetched = exe.run(main, feed=FEED, scope=scope,
                          fetch_list=[out, loss]
                          + [p + "@GRAD" for p in params])
        stepped = [np.asarray(scope.get(p)) for p in params]
        results.append(([np.asarray(v) for v in fetched], stepped))
    (ref, ref_step), (port, port_step) = results
    assert len(port) == len(ref) == 2 + 3  # two weights and the bias
    assert port[0].shape == (5, 4)
    for got, want in zip(port + port_step, ref + ref_step):
        np.testing.assert_allclose(got, want, **TOL)
