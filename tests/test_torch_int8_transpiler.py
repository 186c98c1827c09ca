"""The port's weight-only int8 transpiler
(``paddle_tpu_torch/fluid/transpiler/int8_transpiler.py``) and the
predictor's ``AnalysisConfig(enable_int8=True)`` against the JAX
package's, on the CPU:

 - a test program with a convolution, an fc, an embedding, a weight two
   ``mul`` ops share, a weight under 64 values and a ``While`` body that
   reads a weight: after the transpile both packages hold the same ops
   (a ``dequantize_weight`` before each weight's first consumer in each
   block, the ``While``'s ``X`` naming the int8 tensor and its scale),
   the same variables, and scopes with the same int8 tensors and scales
   bit for bit and no float original; run, the same outputs at fp32
   rtol 1e-5 / atol 1e-6;
 - predictors with ``enable_int8`` over ResNet-20 (CIFAR, 16 px) and the
   2-layer Transformer, saved by each package from the reference's
   persistables: the same ops, outputs at the folded predictor's rtol
   1e-4 / atol 1e-5 (``tests/test_torch_inference.py``), the quantized
   weights (int8 and scales) under 0.3 of their fp32 bytes; against the port's fp32
   predictor the logits stay within ``INT8_LOGIT_TOL`` of the largest
   (per-channel int8 rounding: at most half a step, 1/254 of a channel's
   largest weight).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu import inference as ref_inf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import resnet as ref_rn
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch import inference as port_inf
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import resnet as port_rn
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.models.params import load_reference_params

TOL = dict(rtol=1e-5, atol=1e-6)
FOLD_TOL = dict(rtol=1e-4, atol=1e-5)
INT8_LOGIT_TOL = 0.05


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def _ops(prog):
    return [[(op.type, {k: list(v) for k, v in op.inputs.items()},
              {k: list(v) for k, v in op.outputs.items()},
              {k: _norm(v) for k, v in op.attrs.items()})
             for op in block.ops] for block in prog.blocks]


def _vars(prog):
    return sorted((v.name, tuple(v.shape) if v.shape is not None else None,
                   str(v.dtype).split(".")[-1].lower(), bool(v.persistable))
                  for v in prog.global_block().vars.values())


def _small_net(pkg):
    """A conv, an fc, an embedding, a shared weight, a tiny weight and a
    While body reading a weight: (feed names, fetch vars)."""
    layers = pkg.layers
    img = layers.data("img", shape=[2, 6, 6], dtype="float32")
    ids = layers.data("ids", shape=[1], dtype="int64")
    conv = layers.conv2d(img, num_filters=8, filter_size=3, act="relu")
    emb = layers.embedding(ids, size=[40, 16])
    feat = layers.concat([layers.fc(conv, size=16), emb], axis=1)
    shared = pkg.ParamAttr(name="shared_w")
    a = layers.fc(feat, size=32, param_attr=shared, bias_attr=False)
    b = layers.fc(feat, size=32, param_attr=shared, bias_attr=False)
    tiny = layers.fc(layers.elementwise_add(a, b), size=1)  # 32 values
    # a While body that applies a weight of the global block
    i = layers.fill_constant(shape=[1], dtype="int64", value=0)
    n = layers.fill_constant(shape=[1], dtype="int64", value=2)
    h = layers.assign(a)
    cond = layers.less_than(i, n)
    loop = layers.While(cond)
    with loop.block():
        layers.assign(layers.fc(h, size=32, param_attr=pkg.ParamAttr(
            name="loop_w"), bias_attr=False, act="tanh"), output=h)
        layers.increment(i, in_place=True)
        layers.less_than(i, n, cond=cond)
    return ["img", "ids"], [tiny, h]


def _transpiled(pkg, init=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feeds, fetches = _small_net(pkg)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in startup.list_vars() if v.persistable}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    test = main.clone(for_test=True)
    names = pkg.transpiler.Int8WeightTranspiler().transpile(
        test, pkg.CPUPlace(), scope=scope)
    rng = np.random.RandomState(3)
    feed = {"img": rng.normal(size=(4, 2, 6, 6)).astype(np.float32),
            "ids": rng.randint(0, 40, (4, 1)).astype(np.int64)}
    outs = exe.run(test, feed=feed, fetch_list=fetches, scope=scope)
    return test, scope, names, [np.asarray(o) for o in outs], init


def test_transpile_matches_reference():
    rprog, rscope, rnames, rout, init = _transpiled(rf)
    pprog, pscope, pnames, pout, _ = _transpiled(tf, init)
    assert pnames == rnames
    assert set(pnames) == {"conv2d_0.w_0", "fc_0.w_0", "embedding_0.w_0",
                           "shared_w", "loop_w"}  # not fc_3 (32 values)
    assert _ops(pprog) == _ops(rprog)
    assert _vars(pprog) == _vars(rprog)
    # one dequantize a weight in the global block; loop_w's in the body
    types = [[op.type for op in b.ops] for b in pprog.blocks]
    assert types[0].count("dequantize_weight") == 4
    assert types[1].count("dequantize_weight") == 1
    owner = next(op for op in pprog.global_block().ops if op.type == "while")
    assert {"loop_w@INT8", "loop_w@SCALE"} <= set(owner.inputs["X"])
    assert "loop_w" not in owner.inputs["X"]
    for name in pnames:
        assert pscope.get(name) is None and rscope.get(name) is None
        q, s = pscope.get(name + "@INT8"), pscope.get(name + "@SCALE")
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(rscope.get(name + "@INT8")))
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(rscope.get(name + "@SCALE")))
    for r, p in zip(rout, pout):
        np.testing.assert_allclose(p, r, **TOL)


# -- the predictor ------------------------------------------------------------

def _resnet20(pkg):
    rn = ref_rn if pkg is rf else port_rn
    img = pkg.layers.data("img", shape=[3, 16, 16], dtype="float32")
    return ["img"], [rn.resnet_cifar10(img, 10, depth=20)]


def _transformer(pkg):
    tm = ref_tm if pkg is rf else port_tm
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    tm.build(cfg, src_len=8, tgt_len=8)
    gb = pkg.default_main_program().global_block()
    xent = next(op for op in gb.ops
                if op.type == "softmax_with_cross_entropy")
    return ["src_word", "tgt_word"], [gb.var(xent.input("Logits")[0])]


def _feed(model):
    rng = np.random.default_rng(0)
    if model is _resnet20:
        return {"img": rng.standard_normal((4, 3, 16, 16)).astype(
            np.float32)}
    return {k: rng.integers(1, 1000, (2, 8)).astype(np.int64)
            for k in ("src_word", "tgt_word")}


def _saved(tmp_path, model):
    """The reference builds and saves ``model``; the port builds it, loads
    the reference's persistables and saves its own.  Returns the dirs."""
    dirs = {}
    for pkg, fw in ((rf, ref_framework), (tf, port_framework)):
        fw.fresh_session()
        pkg.default_main_program().random_seed = 21
        pkg.default_startup_program().random_seed = 21
        feeds, targets = model(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(pkg.default_startup_program())
        if pkg is tf:
            infer = tf.default_main_program().clone(
                for_test=True)._prune(targets)
            tf.io.load_persistables(exe, dirs["ref"], infer)
        d = str(tmp_path / ("ref" if pkg is rf else "port"))
        pkg.io.save_inference_model(d, feeds, targets, exe)
        dirs["ref" if pkg is rf else "port"] = d
    return dirs


def _predict(inf, fw, model_dir, feed, **kw):
    fw.fresh_session()
    pred = inf.create_paddle_predictor(inf.AnalysisConfig(
        model_dir=model_dir, use_tpu=False, **kw))
    (out,) = pred.run([inf.PaddleTensor(name=k, data=v)
                       for k, v in feed.items()])
    return pred, out.data


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("model", [_resnet20, _transformer],
                         ids=["resnet20", "transformer"])
def test_int8_predictor_matches_reference(tmp_path, model):
    dirs, feed = _saved(tmp_path, model), _feed(model)
    ref, rout = _predict(ref_inf, ref_framework, dirs["ref"], feed,
                         enable_int8=True)
    port, pout = _predict(port_inf, port_framework, dirs["port"], feed,
                          enable_int8=True)
    fp32, fout = _predict(port_inf, port_framework, dirs["port"], feed)
    ops = [op.type for op in port._program.global_block().ops]
    assert ops == [op.type for op in ref._program.global_block().ops]
    deq = ops.count("dequantize_weight")
    big = sum(1 for op in fp32._program.global_block().ops
              if op.type in ("conv2d", "mul", "lookup_table")
              and int(np.prod(fp32._scope.get(op.input(
                  {"conv2d": "Filter", "mul": "Y",
                   "lookup_table": "W"}[op.type])[0]).shape)) >= 64)
    assert deq == big > 0
    np.testing.assert_allclose(pout, rout, **FOLD_TOL)
    names = [op.input("X")[0][:-len("@INT8")]
             for op in port._program.global_block().ops
             if op.type == "dequantize_weight"]
    assert all(port._scope.get(n) is None for n in names)
    int8 = sum(_nbytes(port._scope.get(n + sfx)) for n in names
               for sfx in ("@INT8", "@SCALE"))
    assert int8 < 0.3 * sum(_nbytes(fp32._scope.get(n)) for n in names)
    err = float(np.abs(pout - fout).max() / np.abs(fout).max())
    print(f"{model.__name__}: int8 against fp32 {err} of the largest")
    assert 0 < err <= INT8_LOGIT_TOL
