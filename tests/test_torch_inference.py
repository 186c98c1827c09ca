"""Inference models, the predictor and the IR passes of the port against
the JAX package, on the CPU:

 - ``save_inference_model`` / ``load_inference_model`` give the same
   pruned program, feed names, fetch names and files as the reference's,
   for the MNIST mlp, a conv + batch_norm net and the tiny Transformer
   (its logits); a ``__model__`` the reference wrote makes the port raise
   ``ValueError``, and a fresh interpreter that tries it imports nothing of
   ``paddle_tpu``;
 - the cases of ``tests/test_inference_api.py`` (native predictor, the
   batch_norm fold, clone, LoD, positional and partial feeds, the
   transpiler's return value) on the port, with the reference's
   persistables carried across, held against the reference's predictor at
   that file's tolerances (native rtol 1e-5 / atol 1e-6, folded rtol 1e-4
   / atol 1e-5); ``enable_serving`` raises (``enable_int8`` quantizes the
   weights), and so does ``use_tpu=True`` with no card;
 - the cases of ``tests/test_ir_passes.py`` on the port, each against the
   reference's result.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu import inference as ref_inf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import ir as ref_ir
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch import inference as port_inf
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import ir as port_ir
from paddle_tpu_torch.models import mnist as port_mnist
from paddle_tpu_torch.models import transformer as port_tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_TOL = dict(rtol=1e-5, atol=1e-6)
FOLD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


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


# -- models, built by the same calls in both packages -------------------------

def _conv_bn(fluid):
    """``tests/test_inference_api.py``'s model."""
    img = fluid.layers.data(name="img", shape=[1, 8, 8], dtype="float32")
    conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                               padding=1, bias_attr=False)
    bn = fluid.layers.batch_norm(input=conv)
    pool = fluid.layers.pool2d(input=bn, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(input=pool, size=3, act="softmax")
    return ["img"], [pred]


def _mlp(fluid):
    mnist = ref_mnist if fluid is rf else port_mnist
    _, _, prediction, loss, _ = mnist.mlp()
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return ["img"], [prediction]


def _transformer(fluid):
    tm = ref_tm if fluid is rf else port_tm
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    tm.build(cfg, src_len=8, tgt_len=8)
    gb = fluid.default_main_program().global_block()
    xent = next(op for op in gb.ops
                if op.type == "softmax_with_cross_entropy")
    return ["src_word", "tgt_word"], [gb.var(xent.input("Logits")[0])]


def _lod_model(fluid):
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    emb = fluid.layers.embedding(input=words, size=[20, 6])
    return ["words"], [fluid.layers.fc(emb, size=3)]


def _two_feeds(fluid):
    a = fluid.layers.data(name="a", shape=[4], dtype="float32")
    b = fluid.layers.data(name="b", shape=[4], dtype="float32")
    out_a = fluid.layers.fc(a, size=2, act=None)
    fluid.layers.fc(b, size=2, act=None)  # a second branch off feed 'b'
    return ["a", "b"], [out_a]


def _ref_saved(tmp_path, model, train_feed=None):
    """The reference builds ``model`` in fresh default programs, runs its
    startup (and one training-mode run on ``train_feed``: batch_norm moves
    its stats) and saves the inference model; returns (dir, feeds,
    targets)."""
    ref_framework.fresh_session()
    rf.default_main_program().random_seed = 21
    rf.default_startup_program().random_seed = 21
    feeds, targets = model(rf)
    exe = rf.Executor(rf.CPUPlace())
    exe.run(rf.default_startup_program())
    if train_feed is not None:
        exe.run(rf.default_main_program(), feed=train_feed,
                fetch_list=targets)
    d = str(tmp_path / "ref")
    rf.io.save_inference_model(d, feeds, targets, exe)
    return d, feeds, targets


def _port_saved(tmp_path, model, ref_dir):
    """The port builds the same model, runs its startup, loads the
    reference's saved persistables into it, and saves its own inference
    model; returns (dir, feeds, targets, executor)."""
    port_framework.fresh_session()
    feeds, targets = model(tf)
    exe = tf.Executor(tf.CPUPlace())
    exe.run(tf.default_startup_program())
    infer = tf.default_main_program().clone(for_test=True)._prune(targets)
    tf.io.load_persistables(exe, ref_dir, infer)
    d = str(tmp_path / "port")
    tf.io.save_inference_model(d, feeds, targets, exe)
    return d, feeds, targets, exe


def _img(seed=0, n=2):
    return np.random.RandomState(seed).normal(size=(n, 1, 8, 8)).astype(
        np.float32)


# -- the inference model ------------------------------------------------------

@pytest.mark.parametrize("model", [_mlp, _conv_bn, _transformer],
                         ids=["mnist_mlp", "conv_bn", "transformer"])
def test_inference_model_round_trip_matches_reference(tmp_path, model):
    ref_dir, _, _ = _ref_saved(tmp_path, model)
    port_dir, _, _, exe = _port_saved(tmp_path, model, ref_dir)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    rprog, rfeeds, rfetch = rf.io.load_inference_model(
        ref_dir, rf.Executor(rf.CPUPlace()), scope=rf.Scope())
    scope = tf.Scope()
    pprog, pfeeds, pfetch = tf.io.load_inference_model(port_dir, exe,
                                                       scope=scope)
    assert isinstance(pprog, tf.Program)
    assert _ops(pprog) == _ops(rprog)
    assert _vars(pprog, port_core) == _vars(rprog, ref_core)
    assert pfeeds == rfeeds
    assert [v.name for v in pfetch] == [v.name for v in rfetch]
    for n in os.listdir(ref_dir):
        if n != "__model__":
            np.testing.assert_array_equal(
                scope.get(n).numpy(), np.load(os.path.join(ref_dir, n)))


def test_reference_model_file_raises(tmp_path):
    ref_dir, _, _ = _ref_saved(tmp_path, _conv_bn)
    exe = tf.Executor(tf.CPUPlace())
    with pytest.raises(ValueError, match="rebuild it with paddle_tpu_torch"):
        tf.io.load_inference_model(ref_dir, exe)
    with pytest.raises(ValueError, match="per-variable files load"):
        port_inf.create_paddle_predictor(
            port_inf.NativeConfig(model_dir=ref_dir, use_tpu=False))


def test_reference_model_file_imports_nothing_of_the_reference(tmp_path):
    ref_dir, _, _ = _ref_saved(tmp_path, _conv_bn)
    code = (
        "import sys\n"
        "import paddle_tpu_torch.fluid as fluid\n"
        "try:\n"
        f"    fluid.io.load_inference_model({ref_dir!r},"
        " fluid.Executor(fluid.CPUPlace()))\n"
        "except ValueError:\n"
        "    print('refused')\n"
        "print(sorted(m for m in sys.modules if m == 'paddle_tpu'"
        " or m.startswith('paddle_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["refused", "[]"]


# -- the predictor (tests/test_inference_api.py) -------------------------------

def _saved_pair(tmp_path, model=_conv_bn, train_feed="img"):
    feed = {"img": _img()} if train_feed == "img" else None
    ref_dir, _, targets = _ref_saved(tmp_path, model, feed)
    port_dir, _, ptargets, exe = _port_saved(tmp_path, model, ref_dir)
    return ref_dir, port_dir, exe


def _predictors(ref_dir, port_dir, cfg_cls, **kw):
    ref_framework.fresh_session()
    ref = ref_inf.create_paddle_predictor(
        getattr(ref_inf, cfg_cls)(model_dir=ref_dir, use_tpu=False, **kw))
    port_framework.fresh_session()
    port = port_inf.create_paddle_predictor(
        getattr(port_inf, cfg_cls)(model_dir=port_dir, use_tpu=False, **kw))
    return ref, port


def test_native_predictor_matches_reference_and_executor(tmp_path):
    ref_dir, port_dir, exe = _saved_pair(tmp_path)
    test = tf.default_main_program().clone(for_test=True)
    pred_var = test.global_block().ops[-1].output("Out")[0]
    (want,) = exe.run(test, feed={"img": _img()}, fetch_list=[pred_var])
    ref, port = _predictors(ref_dir, port_dir, "NativeConfig")
    assert port.get_input_names() == ref.get_input_names() == ["img"]
    assert port.get_output_names() == ref.get_output_names()
    (out,) = port.run([port_inf.PaddleTensor(name="img", data=_img())])
    (rout,) = ref.run([ref_inf.PaddleTensor(name="img", data=_img())])
    assert out.name == rout.name and isinstance(out.data, np.ndarray)
    np.testing.assert_allclose(out.data, want, **NATIVE_TOL)
    np.testing.assert_allclose(out.data, rout.data, **NATIVE_TOL)


def test_analysis_predictor_folds_batch_norm(tmp_path):
    ref_dir, port_dir, _ = _saved_pair(tmp_path)
    ref, port = _predictors(ref_dir, port_dir, "AnalysisConfig")
    (out,) = port.run([port_inf.PaddleTensor(name="img", data=_img())])
    (rout,) = ref.run([ref_inf.PaddleTensor(name="img", data=_img())])
    np.testing.assert_allclose(out.data, rout.data, **FOLD_TOL)
    assert [op.type for op in port._program.global_block().ops] == \
        [op.type for op in ref._program.global_block().ops]
    assert not any(op.type == "batch_norm"
                   for op in port._program.global_block().ops)
    _, native = _predictors(ref_dir, port_dir, "NativeConfig")
    (nat,) = native.run([port_inf.PaddleTensor(name="img", data=_img())])
    np.testing.assert_allclose(out.data, nat.data, **FOLD_TOL)


def test_predictor_clone_shares_weights(tmp_path):
    ref_dir, port_dir, _ = _saved_pair(tmp_path)
    _, pred = _predictors(ref_dir, port_dir, "NativeConfig")
    c = pred.clone()
    assert c._scope is pred._scope
    (o1,) = pred.run([port_inf.PaddleTensor(name="img", data=_img())])
    (o2,) = c.run([port_inf.PaddleTensor(name="img", data=_img())])
    (o3,) = c.run([port_inf.PaddleTensor(data=_img())])
    np.testing.assert_array_equal(o1.data, o2.data)
    np.testing.assert_array_equal(o3.data, o1.data)


def test_predictor_feeds_lod(tmp_path):
    """A LoD feed reaches the executor as a LoDTensor (offsets form is
    checked in both packages); the output matches the reference's data
    and carries the reference's LoD."""
    ref_dir, port_dir, _ = _saved_pair(tmp_path, _lod_model, None)
    ref, port = _predictors(ref_dir, port_dir, "NativeConfig")
    ids = np.array([[1], [2], [3], [4], [5]], np.int64)
    (out,) = port.run([port_inf.PaddleTensor(name="words", data=ids,
                                             lod=[[0, 2, 5]])])
    (rout,) = ref.run([ref_inf.PaddleTensor(name="words", data=ids,
                                            lod=[[0, 2, 5]])])
    np.testing.assert_allclose(out.data, rout.data, **NATIVE_TOL)
    assert out.lod == rout.lod == ((0, 2, 5),)
    for pred, inf in ((ref, ref_inf), (port, port_inf)):
        with pytest.raises(ValueError, match="offsets"):
            pred.run([inf.PaddleTensor(name="words", data=ids,
                                       lod=[[2, 3]])])


def test_positional_partial_feed(tmp_path):
    ref_dir, port_dir, _ = _saved_pair(tmp_path, _two_feeds, None)
    ref, port = _predictors(ref_dir, port_dir, "NativeConfig")
    assert port.get_input_names() == ["a", "b"]
    xa = np.ones((1, 4), np.float32)
    with pytest.raises(ValueError, match="unnamed"):
        port.run([port_inf.PaddleTensor(data=xa)])
    (named_a,) = port.run([port_inf.PaddleTensor(name="a", data=xa)])
    (full_a,) = port.run([port_inf.PaddleTensor(data=xa),
                          port_inf.PaddleTensor(data=xa)])
    (rnamed,) = ref.run([ref_inf.PaddleTensor(name="a", data=xa)])
    np.testing.assert_array_equal(named_a.data, full_a.data)
    np.testing.assert_allclose(named_a.data, rnamed.data, **NATIVE_TOL)


def test_inference_transpiler_returns_fused_program(tmp_path):
    ref_dir, port_dir, _ = _saved_pair(tmp_path)
    _, pred = _predictors(ref_dir, port_dir, "AnalysisConfig",
                          enable_ir_optim=False)
    raw = pred._program
    assert any(op.type == "batch_norm" for op in raw.global_block().ops)
    fused = tf.InferenceTranspiler().transpile(raw, tf.CPUPlace(),
                                               scope=pred._scope)
    assert fused is not None
    assert not any(op.type == "batch_norm"
                   for op in fused.global_block().ops)


@pytest.mark.parametrize("field", ["enable_int8", "enable_serving"])
def test_unported_analysis_modes_raise(tmp_path, field):
    """``enable_serving`` raises; ``enable_int8``, ported since, builds a
    predictor whose weights are int8 (``tests/test_torch_int8_transpiler.py``
    holds it against the reference)."""
    ref_dir, port_dir, _ = _saved_pair(tmp_path)
    cfg = port_inf.AnalysisConfig(model_dir=port_dir, use_tpu=False,
                                  **{field: True})
    if field == "enable_int8":
        pred = port_inf.create_paddle_predictor(cfg)
        assert "dequantize_weight" in [
            op.type for op in pred._program.global_block().ops]
        return
    with pytest.raises(NotImplementedError, match="not port yet"):
        port_inf.create_paddle_predictor(cfg)


def test_accelerator_predictor_without_a_card_raises(tmp_path, monkeypatch):
    ref_dir, port_dir, _ = _saved_pair(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        port_inf.create_paddle_predictor(
            port_inf.NativeConfig(model_dir=port_dir))


# -- the IR passes (tests/test_ir_passes.py) -----------------------------------

def _in_both(build):
    """``build(fluid)`` in fresh default programs of each package; returns
    [(fluid, ir, result), ...] for the reference, then the port."""
    out = []
    for fluid, ir, fresh in ((rf, ref_ir, ref_framework.fresh_session),
                             (tf, port_ir, port_framework.fresh_session)):
        fresh()
        out.append((fluid, ir, build(fluid, ir)))
    return out


def test_graph_structure_and_round_trip():
    def build(fluid, ir):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=3, act="relu")
        fluid.layers.mean(h)
        prog = fluid.default_main_program()
        g = ir.Graph(prog)
        muls = g.ops("mul")
        n_ops = len(prog.global_block().ops)
        g.to_program()
        return (len(muls), sorted(vn.name for vn in muls[0].inputs),
                sorted(vn.name for vn in muls[0].outputs),
                n_ops, len(prog.global_block().ops))

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port == ref and port[0] == 1 and port[3] == port[4]


def test_dead_op_elimination():
    def build(fluid, ir):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        live = fluid.layers.fc(input=x, size=2)
        fluid.layers.fc(input=x, size=7)  # never consumed, not fetched
        loss = fluid.layers.mean(live)
        prog = fluid.default_main_program()
        n_before = len(prog.global_block().ops)
        ir.apply_pass(prog, "dead_op_elimination", targets=[loss])
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        (val,) = exe.run(prog, feed={"x": np.ones((2, 4), np.float32)},
                         fetch_list=[loss])
        return n_before, _ops(prog), np.asarray(val)

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port[1] == ref[1] and len(port[1]) < port[0] == ref[0]
    assert {"mul", "mean"} <= {t for t, *_ in port[1]}
    assert np.isfinite(port[2]).all()


def _bn_stats(fluid, prog, seed=0):
    scope = fluid.global_scope()
    rng = np.random.RandomState(seed)
    for op in prog.global_block().ops:
        if op.type != "batch_norm":
            continue
        for slot, arr in (
                ("Mean", rng.normal(0, 0.5, size=(4,))),
                ("Variance", rng.uniform(0.5, 2.0, size=(4,))),
                ("Scale", rng.uniform(0.5, 1.5, size=(4,))),
                ("Bias", rng.normal(0, 0.2, size=(4,)))):
            arr = arr.astype(np.float32)
            scope.set(op.inputs[slot][0], arr if fluid is rf
                      else torch.from_numpy(arr))
    return rng


def test_conv_bn_fuse_preserves_outputs():
    """The same start state in both (the reference's filter carried to the
    port): the folded program's ops and outputs match the reference's, and
    the unfolded outputs within the reference's bound."""
    filters = {}

    def build(fluid, ir):
        fluid.default_startup_program().random_seed = 5
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        c = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                padding=1, bias_attr=False)
        out = fluid.layers.batch_norm(input=c, act=None)
        prog = fluid.default_main_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        scope = fluid.global_scope()
        w = prog.global_block().ops[0].input("Filter")[0]
        if fluid is rf:
            filters[w] = np.array(scope.get(w))
        else:
            scope.set(w, torch.from_numpy(filters[w]))
        rng = _bn_stats(fluid, prog)
        infer = prog.clone(for_test=True)
        x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
        (before,) = exe.run(infer, feed={"img": x}, fetch_list=[out])
        fused = fluid.InferenceTranspiler().transpile(infer, fluid.CPUPlace(),
                                                      scope)
        (after,) = exe.run(fused, feed={"img": x}, fetch_list=[out])
        return ([op.type for op in fused.global_block().ops],
                np.asarray(before), np.asarray(after))

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port[0] == ref[0]
    assert "batch_norm" not in port[0] and "elementwise_add" in port[0]
    np.testing.assert_allclose(port[2], port[1], **FOLD_TOL)
    np.testing.assert_allclose(port[1], ref[1], **NATIVE_TOL)
    np.testing.assert_allclose(port[2], ref[2], **NATIVE_TOL)


def test_program_serialize_prune_round_trip():
    def build(fluid, ir):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=3, act="relu")
        fluid.layers.mean(h)
        prog = fluid.default_main_program()
        back = fluid.Program.parse_from_string(prog.serialize_to_string())
        pruned = prog._prune([h])
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        (a,) = exe.run(prog, feed={"x": np.ones((2, 4), np.float32)},
                       fetch_list=[h])
        (b,) = exe.run(back, feed={"x": np.ones((2, 4), np.float32)},
                       fetch_list=[h])
        return (_ops(back) == _ops(prog), _ops(pruned), np.asarray(a),
                np.asarray(b))

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port[0] and port[1] == ref[1]
    assert "mean" not in [t for t, *_ in port[1]]
    np.testing.assert_allclose(port[3], port[2], rtol=1e-6)


def test_pass_registry_refusals():
    with pytest.raises(KeyError, match="no pass named"):
        port_ir.get_pass("nonexistent_pass")
    with pytest.raises(ValueError, match="requires explicit targets"):
        port_ir.get_pass("dead_op_elimination")


def test_conv_bn_fuse_skips_shared_filter():
    def build(fluid, ir):
        fluid.default_startup_program().random_seed = 8
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        w = fluid.ParamAttr(name="shared_w")
        c1 = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                 padding=1, bias_attr=False, param_attr=w)
        c2 = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                 padding=1, bias_attr=False, param_attr=w)
        fluid.layers.batch_norm(input=c1)
        fluid.layers.batch_norm(input=c2)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        infer = fluid.default_main_program().clone(for_test=True)
        fused = fluid.InferenceTranspiler().transpile(infer, fluid.CPUPlace())
        return [op.type for op in fused.global_block().ops]

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port == ref and port.count("batch_norm") == 2


def test_dead_op_elimination_keeps_subblock_side_effects():
    def build(fluid, ir):
        prog = fluid.Program()
        with fluid.program_guard(prog):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            h = fluid.layers.fc(input=x, size=4)
            gb = prog.global_block()
            gb.create_var(name="gstep", shape=(1,), dtype="int64",
                          persistable=True)
            gb.append_op(type="increment", inputs={"X": ["gstep"]},
                         outputs={"Out": ["gstep"]})
            gb.create_var(name="deadv", shape=(4,), dtype="float32")
            gb.append_op(type="scale", inputs={"X": [h.name]},
                         outputs={"Out": ["deadv"]}, attrs={"scale": 2.0})
            sub = prog._create_block()
            sub.append_op(type="save", inputs={"X": [h.name]}, outputs={},
                          attrs={"file_path": "ckpt"})
            prog._rollback()
            gb.create_var(name="while_out", shape=(1,), dtype="float32")
            gb.append_op(type="while", inputs={"X": [h.name]},
                         outputs={"Out": ["while_out"]},
                         attrs={"sub_block": sub.idx})
        out = ir.apply_pass(prog, "dead_op_elimination", targets=[h])
        return [op.type for op in out.global_block().ops]

    (_, _, ref), (_, _, port) = _in_both(build)
    assert port == ref
    assert "increment" in port and "while" in port and "scale" not in port
