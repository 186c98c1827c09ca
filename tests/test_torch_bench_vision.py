"""The rest of ``fluid_benchmark.py``'s image models and the CNN of
``benchmark/fluid/mnist.py`` in the port against the JAX package, on the
CPU: SE-ResNeXt-50 (``models/se_resnext.py``, grouped
convolutions and the sigmoid SE gate, Momentum), VGG-16
(``models/vgg.py``, ``fluid.nets.img_conv_group``, Adam) and the MNIST CNN
(``models/mnist.py`` ``cnn``, ``fluid.nets.simple_img_conv_pool``, Adam
attached by the test).  One parametrised test a check:

 - the builders give the same startup and main Programs in both packages
   (exact: the IR is data), SE-ResNeXt-50 also at 224 px / 1000 classes;
 - from the JAX package's initial scope carried across with
   ``load_reference_params``, dropout 0 (every dropout op's probability
   set to 0 in both Programs), batch 4 of numpy-seeded normal images at
   32 px / 10 classes (MNIST 28 px), step losses at rtol 1e-5 at step 0
   (SE-ResNeXt-50: ``SE_LOSS0_RTOL``, below) and 1e-4 after.  The MNIST
   CNN runs 4 steps freely.  SE-ResNeXt-50 and
   VGG-16 with batch norm at batch 4 are chaotic in float32, as ResNet-50
   is (``tests/test_torch_resnet.py``): two float32 runs whose sums differ
   in order part by 5e-2 (SE-ResNeXt) and 4e-4 (VGG) at step 1 whatever
   their code, so the port is given the JAX package's state again before
   each of their 3 steps: each step then compares one step from one state;
 - VGG-16's and SE-ResNeXt-50's layer calls with a float64 image run 2
   steps freely in both packages: losses at rtol 1e-8 (measured within
   1e-11), which shows the float32 gap above is rounding, not the port.

SE-ResNeXt-50's float32 step-0 loss is itself ill-conditioned at batch 4:
changing each pixel of the image by one float32 ulp (a relative 2^-23,
random signs, 24 draws) moves the reference's own step-0 loss by up to
6.69e-5 relative (measured on the reference alone), and the float64
twin's loss lies 2.6e-5 from the reference's float32 one and 2.5e-5 from
the port's, on opposite sides.  So its step-0 gate is that spread,
``SE_LOSS0_RTOL``, and each op of its forward is held on its own
(``test_se_resnext_forward_ops_match_float64``): run from the reference's
values of its inputs, the port's output and the reference's lie within
``OP_F64_TOL`` = 2^-18 of the tensor's largest magnitude from the same op
computed in float64 (measured: port ≤ 1.1e-6, reference ≤ 1.0e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import executor as ref_exec
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import se_resnext as ref_se
from paddle_tpu.models import vgg as ref_vgg
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import executor as port_exec
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import mnist as port_mnist
from paddle_tpu_torch.models import se_resnext as port_se
from paddle_tpu_torch.models import vgg as port_vgg
from paddle_tpu_torch.models.params import load_reference_params

BATCH = 4
F64_LOSS_RTOL = 1e-8
SE_LOSS0_RTOL = 6.7e-5
OP_F64_TOL = 2.0 ** -18


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for this file's convolutions: the suite runs
    in several worker processes on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _se(pkg, model, hw=32, classes=10, dtype="float32"):
    if dtype == "float32":
        return model.build(class_dim=classes, depth=50,
                           image_shape=(3, hw, hw), lr=0.01)
    img = pkg.layers.data("img", shape=[3, hw, hw], dtype=dtype)
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    pred = model.se_resnext_imagenet(img, classes, depth=50)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return img, label, pred, loss, None


def _vgg(pkg, model, dtype="float32"):
    if dtype == "float32":
        return model.build(class_dim=10, image_shape=(3, 32, 32), lr=1e-3)
    img = pkg.layers.data("img", shape=[3, 32, 32], dtype=dtype)
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    pred = model.vgg_bn_drop(img, 10, depth=16)
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return img, label, pred, loss, None


def _cnn(pkg, model):
    outs = model.cnn()
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(outs[3])
    return outs


MODELS = {"se_resnext": (ref_se, port_se, _se, 32, 3, True),
          "vgg": (ref_vgg, port_vgg, _vgg, 32, 3, True),
          "mnist_cnn": (ref_mnist, port_mnist, _cnn, 28, 4, False)}


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
            for op in prog.global_block().ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _build(pkg, model, builder, **kw):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        outs = builder(pkg, model, **kw)
    return main, startup, outs[3]


@pytest.mark.parametrize("name", ["se_resnext", "se_resnext_224", "vgg",
                                  "mnist_cnn"])
def test_same_program(name):
    ref, port, builder = MODELS[name.replace("_224", "")][:3]
    kw = dict(hw=224, classes=1000) if name.endswith("_224") else {}
    rmain, rstart, rloss = _build(rf, ref, builder, **kw)
    pmain, pstart, ploss = _build(tf, port, builder, **kw)
    assert ploss.name == rloss.name
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    types = {op.type for op in pmain.global_block().ops}
    if name.startswith("se_resnext"):
        groups = {op.attr("groups") for op in pmain.global_block().ops
                  if op.type == "conv2d"}
        assert 32 in groups and {"sigmoid", "sigmoid_grad"} <= types


def _no_dropout(main):
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0


def _train_both(name, dtype="float32", resync=None, steps=None):
    """The model in both packages from the JAX package's initial state,
    on one batch; with ``resync`` the port takes the JAX package's state
    again before every step.  Returns the losses ``[2, steps]``."""
    ref, port, builder, hw, n_steps, chaotic = MODELS[name]
    resync = chaotic if resync is None else resync
    steps = steps or n_steps
    rng = np.random.RandomState(0)
    channels = 1 if name == "mnist_cnn" else 3
    feed = {"img": rng.normal(size=(BATCH, channels, hw, hw)).astype(dtype),
            "label": rng.randint(0, 10, size=(BATCH, 1)).astype(np.int64)}
    kw = {} if dtype == "float32" else {"dtype": dtype}
    sides, names = [], None
    for pkg, model in ((rf, ref), (tf, port)):
        main, startup, loss = _build(pkg, model, builder, **kw)
        _no_dropout(main)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in startup.list_vars() if v.persistable)
        sides.append((exe, scope, main, loss))

    def state(scope):
        return {n: np.array(scope.get(n)) for n in names}

    losses = [[], []]
    for step in range(steps):
        if step == 0 or resync:
            load_reference_params(sides[1][1], state(sides[0][1]),
                                  tf.CPUPlace())
        for side, (exe, scope, main, loss) in enumerate(sides):
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses[side].append(float(np.asarray(out[0]).reshape(-1)[0]))
    return np.array(losses)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_matches_reference(name):
    ref, port = _train_both(name)
    step0 = SE_LOSS0_RTOL if name == "se_resnext" else 1e-5
    rtol = np.array([step0] + [1e-4] * (len(ref) - 1))
    rel = np.abs(port - ref) / np.abs(ref)
    assert np.isfinite(port).all() and (rel <= rtol).all(), (port, ref, rel)
    assert port[-1] < port[0]


def _float64_trajectory_is_free(name):
    ref, port = _train_both(name, dtype="float64", resync=False, steps=2)
    print(f"{name} float64: loss rel err {np.abs(port / ref - 1)}")
    np.testing.assert_allclose(port, ref, rtol=F64_LOSS_RTOL)


def test_vgg_float64_trajectory_is_free():
    _float64_trajectory_is_free("vgg")


def test_se_resnext_float64_trajectory_is_free():
    _float64_trajectory_is_free("se_resnext")


def _f64(v):
    a = np.array(v)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def test_se_resnext_forward_ops_match_float64():
    """SE-ResNeXt-50's forward op by op: each op run from the reference's
    values of its inputs in the reference, in the port, and in the port in
    float64; both float32 outputs within ``OP_F64_TOL`` of the float64
    one, at the tensor's largest magnitude."""
    rmain, rstart, rloss = _build(rf, ref_se, _se)
    pmain, _, _ = _build(tf, port_se, _se)
    _no_dropout(rmain)
    _no_dropout(pmain)
    scope = rf.Scope()
    rf.Executor(rf.CPUPlace()).run(rstart, scope=scope)
    rng = np.random.RandomState(0)
    env = {v.name: jnp.asarray(scope.get(v.name))
           for v in rstart.list_vars() if v.persistable}
    env["img"] = jnp.asarray(rng.normal(size=(BATCH, 3, 32, 32)).astype(
        np.float32))
    env["label"] = jnp.asarray(rng.randint(0, 10, size=(BATCH, 1)))
    worst, types = {"ref": 0.0, "port": 0.0}, set()
    for rop, pop in zip(rmain.global_block().ops, pmain.global_block().ops):
        assert rop.type == pop.type
        if rop.type.endswith("_grad") or (rop.attr("op_role") or 0) & 1:
            break  # the forward ends where the loss's backward begins
        names = [n for n in pop.input_arg_names if n in env]
        p32 = {n: torch.from_numpy(np.array(env[n])) for n in names}
        p64 = {n: torch.from_numpy(_f64(env[n])) for n in names}
        ref_exec.run_op(rop, env, [jax.random.PRNGKey(0)])
        for penv in (p32, p64):
            port_exec.run_op(pop, penv, torch.device("cpu"),
                             torch.Generator().manual_seed(0))
        for n in pop.output_arg_names:
            if n not in p64 or not p64[n].is_floating_point():
                continue
            want = p64[n].numpy()
            mag = max(float(np.abs(want).max()), 1e-30)
            for side, got in (("ref", np.asarray(env[n])),
                              ("port", p32[n].numpy())):
                assert got.dtype == np.float32, (pop.type, n, side)
                err = float(np.abs(got - want).max()) / mag
                worst[side] = max(worst[side], err)
                assert err <= OP_F64_TOL, (pop.type, n, side, err)
            types.add(pop.type)
    print(f"largest error against float64 at the tensor's magnitude: "
          f"{worst}")
    assert rloss.name in env
    assert {"conv2d", "batch_norm", "relu", "pool2d", "mul", "sigmoid",
            "elementwise_mul", "elementwise_add", "softmax",
            "cross_entropy", "mean"} <= types
