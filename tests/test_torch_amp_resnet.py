"""ResNet-50 under ``fluid.amp`` in the port against the JAX package, op by
op, on the CPU: ``resnet.build(class_dim=10, depth=50, image_shape=(3, 32,
32))`` at batch 4, bf16 keep_activations and bf16 restore.

In bf16 this model is chaotic: a relative change of 2^-20 in the image
moves the reference's own step-0 loss by 1.7e-3 and its step-2 loss by up
to 5.7 %, and a change of rounding alone (the reference jitted against
itself eager) leaves its step-0 grads at a cosine of 0.73 to themselves
(measured on the reference alone).  One bf16 rounding landing on the other
side of a boundary, which happens to ~1e-4 of a convolution's outputs when
two correct implementations sum in different orders, is such a change.  So
two whole-model runs cannot be compared element by element
(``tests/test_torch_amp_resnet_train.py`` holds their trajectories within
the model's own spread), and the step is held to the reference op by op
here: the reference runs the training step op by op (eager); before each
op the port is handed the reference's values of that op's inputs, runs the
op (forward, grad or momentum), and each floating output must have the
reference's dtype and lie within ``LOCKSTEP_ULPS`` = 1 bf16 ulp of the
reference's value at the tensor's largest magnitude (measured 0.5), or
1e-5 of it for a value computed in fp32 (statistics, the loss, the
update).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import executor as ref_exec
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import resnet as ref_rn
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import executor as port_exec
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import resnet as port_rn

LOCKSTEP_ULPS = 1
BATCH, HW = 4, 32


@pytest.fixture(autouse=True)
def amp_off_after():
    port_framework.fresh_session()
    saved = dict(ref_amp._state), dict(port_amp._state)
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite shares the host's cores
    yield
    torch.set_num_threads(n)
    # off, with the scaler's settings as they were (the state is global)
    for amp, state in zip((ref_amp, port_amp), saved):
        amp._state.update(state)
        amp.disable()


def _feed():
    rng = np.random.default_rng(0)
    return {"img": rng.standard_normal((BATCH, 3, HW, HW)).astype(
        np.float32),
        "label": rng.integers(0, 10, (BATCH, 1)).astype(np.int64)}


def _build(pkg, rn):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss, _ = rn.build(class_dim=10, depth=50,
                                    image_shape=(3, HW, HW), lr=0.01)
    return main, startup, loss


def _to_torch(v):
    a = jnp.asarray(v)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("keep", [True, False], ids=["keep", "restore"])
def test_resnet_step_lockstep_matches_reference(keep):
    ref_framework.fresh_session()
    ref_amp.enable("bfloat16", keep_activations=keep)
    port_amp.enable("bfloat16", keep_activations=keep)
    rmain, rstart, _ = _build(rf, ref_rn)
    pmain, _, _ = _build(tf, port_rn)
    scope = rf.Scope()
    rf.Executor(rf.CPUPlace()).run(rstart, scope=scope)
    env = {v.name: scope.get(v.name) for v in rstart.list_vars()
           if v.persistable}
    env.update({k: jnp.asarray(v) for k, v in _feed().items()})
    checked = set()
    for rop, pop in zip(rmain.global_block().ops, pmain.global_block().ops):
        assert rop.type == pop.type
        penv = {n: _to_torch(env[n]) for n in pop.input_arg_names
                if n and n in env}
        ref_exec.run_op(rop, env)
        port_exec.run_op(pop, penv, torch.device("cpu"))
        for n in pop.output_arg_names:
            p = penv.get(n)
            if n not in env or not isinstance(p, torch.Tensor) \
                    or not p.is_floating_point():
                continue
            r = jnp.asarray(env[n])
            dtype = str(r.dtype)
            assert str(p.dtype)[6:] == dtype, (pop.type, n, p.dtype, dtype)
            rv = np.asarray(r.astype(jnp.float32)).astype(np.float64)
            pv = p.detach().double().numpy()
            mag = float(np.abs(rv).max()) if rv.size else 0.0
            # a value rounded to bf16 somewhere on its way (every product
            # and grad under AMP) within an ulp of bf16, else fp32's 1e-5
            tol = LOCKSTEP_ULPS * 2.0 ** (np.floor(np.log2(max(
                mag, 1e-30))) - 7)
            if pop.type in ("batch_norm", "mean", "cross_entropy",
                            "softmax", "top_k", "accuracy", "momentum") \
                    and dtype == "float32":
                tol = 1e-5 * mag
            err = float(np.abs(pv - rv).max()) if rv.size else 0.0
            assert err <= tol, (pop.type, n, err, tol)
            checked.add(pop.type)
    # every kind of op the step runs, forward, backward and update
    assert {"conv2d", "batch_norm", "relu", "pool2d", "elementwise_add",
            "mul", "softmax", "cross_entropy", "mean", "conv2d_grad",
            "batch_norm_grad", "relu_grad", "pool2d_grad",
            "elementwise_add_grad", "mul_grad", "softmax_grad",
            "cross_entropy_grad", "momentum"} <= checked
