"""The ResNet slice of the port against the JAX package, on the CPU:

 - the momentum kernel's plain version and its wrapper on CPU tensors
   (``paddle_tpu_torch/ops/fused.py``) against the Pallas sweep
   ``pf.fused_momentum`` in interpret mode: ragged and lane-aligned
   shapes, Nesterov off and on, the update in place and no launch counted
   (rtol 1e-6 / atol 1e-6, as ``tests/test_pallas_fused.py`` holds the
   Pallas momentum);
 - the slice's ops, built alone, against the JAX ops: outputs and input
   gradients of conv2d, pool2d, batch_norm (training with its running
   stats and saved outputs, and is_test), cross_entropy, mean, top_k /
   accuracy; the momentum and sgd ops through the Executor (rtol 1e-5 /
   atol 1e-6 of a tensor's largest magnitude: float32 on both sides, the
   sums in another order);
 - ``resnet.build`` gives the same startup and main Programs in both
   packages: ResNet-50 at 224 px and the cifar ResNet at 32 px, with
   Momentum and with SGD (exact: the IR is data);
 - ResNet-50 at 64 px, batch 4, 10 classes, lr 0.01, from the JAX
   package's initial scope carried across: 3 steps.

The training comparisons respect how this model behaves in float32: its
gradients at initialization move by more than 5 % of a tensor's largest
value when the input changes by one part in 5·10⁶, and the step-1 loss by
more than 1e-3 (``test_float32_trajectory_is_chaotic``, on the port
alone), so two float32 runs that sum in different orders part after the
first step whatever their code.  Hence:

 - in float64 (the same layer calls with a float64 image) the two packages
   run 3 steps freely: losses rtol 1e-8, and after step 1 the batch-norm
   running stats and the velocities rtol 1e-7 / atol 1e-9 (measured:
   losses within 3e-10, state within 1e-12 of each tensor's largest value);
 - in float32 (``resnet.build`` itself) the port is re-synced to the JAX
   package's state before each of 3 steps: each step's loss within rtol
   1e-4 (measured ≤ 2.8e-5), the running stats after it within rtol 1e-3 /
   atol 1e-4 (measured ≤ 6e-5 apart), and all 161 velocities, as one
   vector, at cosine ≥ 0.999 (measured ≥ 0.99988).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import resnet as ref_rn
from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import resnet as port_rn
from paddle_tpu_torch.ops import fused

MOMENTUM_TOL = dict(rtol=1e-6, atol=1e-6)
OP_RTOL, OP_ATOL = 1e-5, 1e-6  # atol of the largest magnitude, at least 1
F64_LOSS_RTOL = 1e-8
F64_STATE_TOL = dict(rtol=1e-7, atol=1e-9)
F32_LOSS_RTOL = 1e-4
F32_STATS_TOL = dict(rtol=1e-3, atol=1e-4)
F32_VELOCITY_COSINE = 0.999


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for this file's convolutions: the suite runs
    in several worker processes on one host, and torch's default of one
    thread per core makes them contend (two are as fast here alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(got, want, name):
    """float32 on both sides, the sums in another order: rtol 1e-5, atol
    1e-6 of the tensor's largest magnitude (a filter gradient sums a few
    hundred products of order 10)."""
    atol = OP_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=OP_RTOL, atol=atol,
                               err_msg=name)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the momentum kernel's plain version ------------------------------------

@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
@pytest.mark.parametrize("shape", [(33, 7), (256, 128), (10,), (64, 3, 7, 7)])
def test_momentum_matches_pallas(shape, nesterov, monkeypatch):
    """Ragged shapes (the reference runs them as one ``[1, n]`` row, conv1's
    9,408 values among them) and lane-aligned ones; the Pallas sweep forced
    on (``PADDLE_TPU_FUSED=1``) and run in interpret mode."""
    monkeypatch.setenv("PADDLE_TPU_FUSED", "1")
    rng = np.random.default_rng(7)
    p, g, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lr, mu = np.float32(0.1), 0.9
    ref = pf.fused_momentum(jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
                            jnp.float32(lr), mu, nesterov)

    tp, tv = torch.from_numpy(p.copy()), torch.from_numpy(v.copy())
    before = fused.momentum_launches
    out = fused.momentum(tp, torch.from_numpy(g), tv, torch.tensor([lr]), mu,
                         nesterov)
    assert fused.momentum_launches == before  # the plain version on the CPU
    assert out[0] is tp and out[1] is tv  # in place
    for got, want, name in zip((tp, tv), ref, ("p", "v")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **MOMENTUM_TOL)
    plain = fused.momentum_ref(*(torch.from_numpy(a) for a in (p, g, v)),
                               torch.tensor([lr]), mu, nesterov)
    for got, want in zip((tp, tv), plain):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_momentum_checks_shapes():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="share a shape"):
        fused.momentum(p, torch.zeros(5), torch.zeros(4), torch.ones(1), 0.9,
                       False)
    with pytest.raises(ValueError, match="one value"):
        fused.momentum(p, p.clone(), p.clone(), torch.ones(2), 0.9, False)


# -- the slice's ops ---------------------------------------------------------

def _relu_ties(*shape, seed=0):
    """Values on a grid of 0.5 (exact ties inside windows) around 0, so a
    ReLU leaves windows of all zeros too."""
    return np.round(_rand(*shape, seed=seed) * 2) / 2


def _bn_case(is_test, layout="NCHW"):
    def build(L, v, P):
        return L.batch_norm(v["x"], is_test=is_test, data_layout=layout,
                            param_attr=P(name="bn_s"),
                            bias_attr=P(name="bn_b"),
                            moving_mean_name="bn_m",
                            moving_variance_name="bn_v")
    shape = (3, 4, 5, 6) if layout == "NCHW" else (3, 5, 6, 4)
    return ({"x": _rand(*shape) * 2 + 1}, ["x", "bn_s", "bn_b"], build,
            ["bn_m", "bn_v", "@SavedMean", "@SavedVariance"])


def _conv_case(k, stride, pad, c_in=3, c_out=8, hw=13):
    def build(L, v, P):
        return L.conv2d(v["x"], num_filters=c_out, filter_size=k,
                        stride=stride, padding=pad, bias_attr=False,
                        param_attr=P(name="w"))
    return ({"x": _rand(2, c_in, hw, hw)}, ["x", "w"], build, [])


# case -> (fed inputs, differentiable names (fed or parameters), build,
#          extra names to fetch: persistables, or "@Slot" for that output
#          of the case's op)
OP_CASES = {
    "conv2d-7x7-s2-p3": _conv_case(7, 2, 3, hw=16),
    "conv2d-3x3-s1-p1": _conv_case(3, 1, 1, c_in=6),
    "conv2d-1x1-s2": _conv_case(1, 2, 0, c_in=6),
    "pool2d-max-ties": (
        {"x": _relu_ties(2, 3, 9, 9)}, ["x"],
        lambda L, v, P: L.pool2d(L.relu(v["x"]), pool_size=3,
                                 pool_type="max", pool_stride=2,
                                 pool_padding=1), []),
    "pool2d-avg-global": (
        {"x": _rand(2, 5, 7, 7)}, ["x"],
        lambda L, v, P: L.pool2d(v["x"], pool_size=7, pool_type="avg",
                                 global_pooling=True), []),
    "pool2d-avg-exclusive": (
        {"x": _rand(2, 3, 8, 8)}, ["x"],
        lambda L, v, P: L.pool2d(v["x"], pool_size=3, pool_type="avg",
                                 pool_stride=2, pool_padding=1), []),
    "pool2d-avg-inclusive": (
        {"x": _rand(2, 3, 8, 8)}, ["x"],
        lambda L, v, P: L.pool2d(v["x"], pool_size=3, pool_type="avg",
                                 pool_stride=2, pool_padding=1,
                                 exclusive=False), []),
    "batch_norm-train": _bn_case(False),
    "batch_norm-train-nhwc": _bn_case(False, "NHWC"),
    "batch_norm-is_test": _bn_case(True),
    "cross_entropy-ignore": (
        {"x": _rand(6, 7), "label": np.array([[1], [3], [1], [0], [6], [2]])},
        ["x"],
        lambda L, v, P: L.cross_entropy(L.softmax(v["x"]), v["label"],
                                        ignore_index=1), []),
    "cross_entropy-mean": (
        {"x": _rand(6, 7), "label": np.array([[1], [3], [5], [0], [6], [2]])},
        ["x"],
        lambda L, v, P: L.mean(L.cross_entropy(L.softmax(v["x"]),
                                               v["label"])), []),
}

# values for the parameters a case creates, set after its startup run
PARAMS = {"w": lambda shape: _rand(*shape, seed=5) * 0.3,
          "bn_s": lambda shape: _rand(*shape, seed=6) + 1.0,
          "bn_b": lambda shape: _rand(*shape, seed=7),
          "bn_m": lambda shape: _rand(*shape, seed=8),
          "bn_v": lambda shape: np.abs(_rand(*shape, seed=9)) + 0.5}


def _set(pkg, scope, name, arr):
    if pkg is rf:
        scope.set(name, arr)
    else:
        port_rn.load_reference_params(scope, {name: arr}, tf.CPUPlace())


def _op_case(pkg, inputs, diff, build, extra):
    """Build ``loss = reduce_sum(op(inputs) · w)`` (w a fixed random
    weight, so no grad vanishes by symmetry), append the backward and fetch
    the op's output, the extra names and ``d loss / d name`` for each
    differentiable name."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        v = {name: L.data(name, shape=list(arr.shape), dtype=str(arr.dtype),
                          append_batch_size=False,
                          stop_gradient=name not in diff)
             for name, arr in inputs.items()}
        out = build(L, v, pkg.ParamAttr)
        weight = L.assign(_rand(*out.shape, seed=9).astype(str(out.dtype)))
        loss = L.reduce_sum(L.elementwise_mul(out, weight))
        pkg.backward.append_backward(loss)
    own = next(op for op in prog.global_block().ops
               if out.name in op.output_arg_names)  # the case's own op
    fetch = [out.name] + [own.output(n[1:])[0] if n.startswith("@") else n
                          for n in extra] + [n + "@GRAD" for n in diff]
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    for name, make in PARAMS.items():
        if prog.global_block()._has_var_recursive(name):
            shape = tuple(prog.global_block()._var_recursive(name).shape)
            _set(pkg, scope, name, make(shape))
    return [np.asarray(x) for x in exe.run(prog, feed=dict(inputs),
                                           fetch_list=fetch, scope=scope)]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    inputs, diff, build, extra = OP_CASES[case]
    ref_framework.fresh_session()
    ref = _op_case(rf, inputs, diff, build, extra)
    port = _op_case(tf, inputs, diff, build, extra)
    names = ["out"] + extra + [n + "@GRAD" for n in diff]
    for r, p, name in zip(ref, port, names):
        assert p.shape == r.shape, (name, p.shape, r.shape)
        assert p.dtype == r.dtype, (name, p.dtype, r.dtype)
        _assert_close(p, r, name)


def test_batch_norm_stats_update_once_a_step():
    """The running stats move once per step, by the biased batch variance
    (``momentum · old + (1 − momentum) · batch``), though the generic grad
    re-runs the op's forward; ``SavedVariance`` is ``rsqrt(var + eps)``."""
    inputs, diff, build, extra = _bn_case(False)
    _, mean_out, var_out, saved_mean, saved_inv = _op_case(
        tf, inputs, diff, build, extra)[:5]
    x = inputs["x"].astype(np.float64)
    bm, bv = x.mean((0, 2, 3)), x.var((0, 2, 3))
    m0, v0 = PARAMS["bn_m"]((4,)), PARAMS["bn_v"]((4,))
    np.testing.assert_allclose(saved_mean, bm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(saved_inv, 1 / np.sqrt(bv + 1e-5), rtol=1e-5)
    np.testing.assert_allclose(mean_out, 0.9 * m0 + 0.1 * bm, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var_out, 0.9 * v0 + 0.1 * bv, rtol=1e-5)


def _topk_program(pkg, x, label, k):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        xv = pkg.layers.data("x", shape=list(x.shape), dtype="float32",
                             append_batch_size=False)
        lv = pkg.layers.data("label", shape=list(label.shape), dtype="int64",
                             append_batch_size=False)
        vals, idx = pkg.layers.topk(xv, k=k)
        acc = pkg.layers.accuracy(xv, lv, k=k)
    acc_op = [op for op in prog.global_block().ops if op.type == "accuracy"]
    fetch = [vals, idx, acc, acc_op[0].output("Correct")[0],
             acc_op[0].output("Total")[0]]
    return [np.asarray(a) for a in pkg.Executor(pkg.CPUPlace()).run(
        prog, feed={"x": x, "label": label}, fetch_list=fetch,
        scope=pkg.Scope())]


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_and_accuracy_match_reference(k):
    x = _rand(9, 10)
    label = np.random.default_rng(4).integers(0, 10, (9, 1)).astype(np.int64)
    label[:3, 0] = np.argsort(-x[:3], -1)[:, k - 1]  # some hits at rank k
    ref_framework.fresh_session()
    ref = _topk_program(rf, x, label, k)
    port = _topk_program(tf, x, label, k)
    for r, p, name in zip(ref, port, ("values", "indices", "accuracy",
                                      "correct", "total")):
        assert p.shape == r.shape, name
        np.testing.assert_array_equal(p, r, err_msg=name)
    # the Program's dtypes (the reference's Correct comes out int64: its
    # int32 sum widens under jax's x64 mode)
    assert [a.dtype for a in port] == [np.float32, np.int64, np.float32,
                                       np.int32, np.int32]
    assert port[3][0] >= 3


def _optimizer_program(pkg, make_opt, steps):
    """A small fc regression trained ``steps`` steps from fixed weights;
    returns the losses and the final persistables."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[6, 5], dtype="float32",
                            append_batch_size=False)
        h = pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(name="fw"),
                          bias_attr=pkg.ParamAttr(name="fb"))
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(h, h))
        make_opt(pkg).minimize(loss)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    _set(pkg, scope, "fw", _rand(5, 4, seed=1))
    _set(pkg, scope, "fb", _rand(4, seed=2))
    losses = [float(np.asarray(exe.run(prog, feed={"x": _rand(6, 5)},
                                       fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    return losses, {n: np.array(scope.get(n)) for n in names}


OPTIMIZERS = {
    "momentum": lambda pkg: pkg.optimizer.Momentum(0.1, momentum=0.9),
    "momentum-nesterov": lambda pkg: pkg.optimizer.Momentum(
        0.1, momentum=0.9, use_nesterov=True),
    "sgd": lambda pkg: pkg.optimizer.SGD(0.1),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_op_matches_reference(opt):
    """The momentum (in place, through the plain version) and sgd ops
    through the Executor: 3 steps, then every persistable (weights,
    velocities, the learning rate)."""
    ref_framework.fresh_session()
    rl, rs = _optimizer_program(rf, OPTIMIZERS[opt], 3)
    before = fused.momentum_launches
    pl, ps = _optimizer_program(tf, OPTIMIZERS[opt], 3)
    assert fused.momentum_launches == before
    _assert_close(np.array(pl), np.array(rl), "losses")
    assert sorted(ps) == sorted(rs)
    if opt.startswith("momentum"):
        assert sum("velocity" in n for n in ps) == 2
    for n in rs:
        _assert_close(ps[n], rs[n], n)


# -- the Programs -------------------------------------------------------------

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


def _build(pkg, rn, **kw):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss, acc = rn.build(**kw)
    return main, startup, loss, acc


BUILDS = {
    "resnet50-224": dict(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                         lr=0.1),
    "cifar-32": dict(class_dim=10, image_shape=(3, 32, 32), lr=0.1),
    "cifar-32-sgd": dict(class_dim=10, image_shape=(3, 32, 32), lr=0.1,
                         with_momentum=False),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_same_resnet_program(name):
    ref_framework.fresh_session()
    rmain, rstart, rloss, racc = _build(rf, ref_rn, **BUILDS[name])
    pmain, pstart, ploss, pacc = _build(tf, port_rn, **BUILDS[name])
    assert (ploss.name, pacc.name) == (rloss.name, racc.name)
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    if name == "resnet50-224":
        momentum = [op for op in pmain.global_block().ops
                    if op.type == "momentum"]
        assert len(momentum) == 161  # 53 filters, 53 x 2 BN, fc w and b
        n = sum(int(np.prod(pmain.global_block().var(op.input("Param")[0])
                            .shape)) for op in momentum)
        assert n == 25_557_032


def test_slice_op_types_are_registered():
    from paddle_tpu_torch.fluid.executor import _resolve

    types = set()
    for kw in BUILDS.values():
        main, startup, _, _ = _build(tf, port_rn, **kw)
        types |= {op.type for p in (main, startup)
                  for op in p.global_block().ops}
    assert {"conv2d_grad", "batch_norm_grad", "pool2d_grad", "momentum",
            "sgd", "top_k", "accuracy", "cross_entropy_grad"} <= types
    for t in types:
        _resolve(t)  # raises NotImplementedError for an unported op


# -- training against the reference -----------------------------------------

def _build_64(pkg, rn, dtype):
    """``resnet.build(class_dim=10, depth=50, image_shape=(3, 64, 64),
    lr=0.01)``, or its layer calls with an image of another dtype: (main,
    startup, loss)."""
    if dtype == "float32":
        return _build(pkg, rn, class_dim=10, depth=50,
                      image_shape=(3, 64, 64), lr=0.01)[:3]
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("img", shape=[3, 64, 64], dtype=dtype)
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        pred = rn.resnet_imagenet(img, 10, depth=50)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
    return main, startup, loss


def _train_both(dtype, resync, steps=3):
    """The 64 px model in both packages from the JAX package's initial
    state, ``steps`` steps on one batch (``bench.py``'s feed: normal images,
    uniform labels); with ``resync`` the port takes the JAX package's state
    again before every step.  Returns both sides' losses ``[2, steps]``,
    both sides' persistables after step 1, and the cosine of the two
    sides' velocities (as one vector) after each step."""
    ref_framework.fresh_session()
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(size=(4, 3, 64, 64)).astype(dtype),
            "label": rng.randint(0, 10, size=(4, 1)).astype(np.int64)}
    sides = []
    for pkg, rn in ((rf, ref_rn), (tf, port_rn)):
        main, startup, loss = _build_64(pkg, rn, dtype)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in startup.list_vars() if v.persistable)
        sides.append((exe, scope, main, loss))

    def state(scope):
        return {n: np.array(scope.get(n)) for n in names}

    vel = [n for n in names if "velocity" in n]
    assert len(vel) == 161
    losses, after1, cosines = [[], []], None, []
    for step in range(steps):
        if step == 0 or resync:
            port_rn.load_reference_params(sides[1][1], state(sides[0][1]),
                                          tf.CPUPlace())
        for side, (exe, scope, main, loss) in enumerate(sides):
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses[side].append(float(np.asarray(out[0]).reshape(-1)[0]))
        ref_state, port_state = state(sides[0][1]), state(sides[1][1])
        a = np.concatenate([ref_state[n].ravel() for n in vel])
        b = np.concatenate([port_state[n].ravel() for n in vel])
        cosines.append(float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)))
        if step == 0:
            after1 = (ref_state, port_state)
    return np.array(losses), after1, cosines


def _stats_and_velocities(state):
    return [n for n in state
            if ".w_mean" in n or ".w_variance" in n or "velocity" in n]


def _rel_to_max(got, want, names):
    return max(float(np.abs(got[n] - want[n]).max() / np.abs(want[n]).max())
               for n in names)


def test_training_matches_reference_float64():
    """3 free steps in float64: the same losses, running stats and
    velocities as the reference to float64 rounding."""
    losses, (ref, port), _ = _train_both("float64", resync=False)
    names = _stats_and_velocities(ref)
    print(f"float64: loss rel err {np.abs(losses[1] / losses[0] - 1)}, "
          f"state after step 1 {_rel_to_max(port, ref, names)} of the "
          f"largest value")
    np.testing.assert_allclose(losses[1], losses[0], rtol=F64_LOSS_RTOL)
    assert len(names) == 53 * 2 + 161
    for n in names:
        assert port[n].dtype == np.float64, n
        np.testing.assert_allclose(port[n], ref[n], err_msg=n,
                                   **F64_STATE_TOL)


def test_training_matches_reference_float32():
    """``resnet.build`` in float32, the port re-synced to the reference
    before each of 3 steps: each step's loss, the running stats after
    step 1, and the velocities after each step as one vector."""
    losses, (ref, port), cosines = _train_both("float32", resync=True)
    stats = [n for n in _stats_and_velocities(ref) if "velocity" not in n]
    print(f"float32 re-synced: loss rel err "
          f"{np.abs(losses[1] / losses[0] - 1)}, stats max abs err "
          f"{max(float(np.abs(port[n] - ref[n]).max()) for n in stats)}, "
          f"velocity cosines {cosines}")
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=F32_LOSS_RTOL)
    assert len(stats) == 53 * 2
    for n in stats:
        np.testing.assert_allclose(port[n], ref[n], err_msg=n,
                                   **F32_STATS_TOL)
    assert min(cosines) >= F32_VELOCITY_COSINE, cosines


def test_float32_trajectory_is_chaotic():
    """Why the float32 runs are re-synced: on the port alone, scaling the
    images by (1 + 2e-7) moves some step-0 gradient by more than 5 % of
    its tensor's largest value and the step-1 loss by more than 1e-3
    relative, so two float32 implementations that round differently
    cannot share a free-running trajectory past step 0."""
    main, startup, loss = _build_64(tf, port_rn, "float32")
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(size=(4, 3, 64, 64)).astype(np.float32),
            "label": rng.randint(0, 10, size=(4, 1)).astype(np.int64)}
    vel = [v.name for v in startup.list_vars() if "velocity" in v.name]
    runs = []
    for scale in (1.0, 1.0 + 2e-7):
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        f = dict(feed, img=(feed["img"] * np.float32(scale)))
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0][0])]
        grads = {n: scope.get(n).numpy().copy() for n in vel}  # = step-0 g
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0][0]))
        runs.append((np.array(losses), grads))
    (l0, g0), (l1, g1) = runs
    moved = np.array([np.abs(g1[n] - g0[n]).max() / np.abs(g0[n]).max()
                      for n in vel])
    loss_moved = np.abs(l1 / l0 - 1)
    print(f"a 2e-7 input change moves step-0 gradients by up to "
          f"{moved.max()} (median {np.median(moved)}) of a tensor's largest "
          f"value, and the losses by {loss_moved}")
    assert loss_moved[0] < 1e-4  # the forward itself is well within reach
    assert moved.max() > 0.05 and loss_moved[1] > 1e-3
