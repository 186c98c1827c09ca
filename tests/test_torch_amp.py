"""``fluid.amp`` in the port against the JAX package, op by op, on the CPU.

Three AMP regimes and fp16: bf16 restore (contraction results cast back to
fp32), bf16 keep (``keep_activations``: activations stay bf16), fp16
restore and fp16 keep.  The same seeded numpy inputs go through each
package's op impl (``ExecContext`` of its registry) and its grad (the
generic grad, or the port's explicit conv2d grad); activations enter in the
regime's dtype (fp32 in restore, the compute dtype in keep), parameters in
fp32.  Checked:

 - ``cast_operands`` / ``restore_astype`` in both regimes, and
   ``is_low_float`` (the cases of ``tests/test_amp_keep.py``);
 - the output dtypes of every op and grad equal the reference's exactly;
 - values within ``OP_ULPS`` = 1 ulp, at the tensor's largest magnitude,
   of the dtype the value was last rounded in: the output's dtype, or the
   compute dtype for an fp32 product restored from it (mul, matmul, conv2d
   in the restore regime) and for every grad (an fp32 parameter's grad is
   the compute-dtype grad through the cast's transpose); both packages
   widen to fp32, compute, and round once, so only a result within an fp32
   rounding of a rounding boundary may land on the neighbouring value
   (measured: equal, or one ulp of fp16 in a convolution's grad).  Values
   last rounded in fp32 (norm statistics, losses) within 1e-5 of the
   largest magnitude, as the fp32 op tests;
 - one exception: the grad of an fp32 parameter broadcast-added to a low
   activation (a bias under keep).  The reference transposes the broadcast
   as a reduction on bf16 operands, rounding every partial sum to bf16; the
   port sums in fp32 and rounds once.  A sum of n partials rounded each
   time is off by at most n/2 ulps of the largest partial: ``BIAS_ULPS`` =
   16 for the 32 rows here (measured 2.1);
 - the generic grad of an op whose runtime output is bf16 given an fp32
   cotangent (a bf16 activation read by two ops), and a program where it
   happens;
 - the xent plain versions with bf16 and fp16 logits against
   ``pallas_fused.softmax_xent(..., interpret=True)`` and its vjp: loss and
   lse fp32 within rtol / atol 1e-5 (as ``tests/test_torch_fused.py``), dx
   in the logits' dtype within 1 ulp;
 - the Program ``minimize`` builds under fp16 dynamic loss scaling equals
   the reference's, op for op (the scale vars, the ``elementwise_div``
   unscale ops with the Backward role); ResNet-50 and Transformer-base
   build the same Programs under bf16 keep;
 - a bf16 fetch comes back as float32 with the reference's values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu.ops import registry as ref_reg
from paddle_tpu.parallel import ring_attention as ref_ra
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops import registry as port_reg
from paddle_tpu_torch.parallel import ring_attention as port_ra

OP_ULPS = 1
BIAS_ULPS = 16
XENT_TOL = dict(rtol=1e-5, atol=1e-5)
# (amp dtype, keep_activations)
REGIMES = [("bfloat16", False), ("bfloat16", True), ("float16", False),
           ("float16", True)]
REGIME_IDS = ["bf16-restore", "bf16-keep", "fp16-restore", "fp16-keep"]
_JNP = {"bfloat16": jnp.bfloat16, "float16": jnp.float16,
        "float32": jnp.float32}
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
_MANTISSA = {"bfloat16": 7, "float16": 10, "float32": 23}


@pytest.fixture(autouse=True)
def amp_off_after():
    port_framework.fresh_session()
    saved = dict(ref_amp._state), dict(port_amp._state)
    yield
    # off, with the scaler's settings as they were (the state is global)
    for amp, state in zip((ref_amp, port_amp), saved):
        amp._state.update(state)
        amp.disable()


def _enable(dtype, keep):
    ref_amp.enable(dtype, keep_activations=keep)
    port_amp.enable(dtype, keep_activations=keep)


def _dtype_name(v):
    return str(v.dtype).replace("torch.", "")


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32)).astype(np.float64)


def _ulp_at(dtype, mag):
    """One ulp of ``dtype`` at magnitude ``mag``."""
    return 2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - _MANTISSA[dtype])


def _assert_close(what, ref, port, ulps=OP_ULPS, grid=None):
    """Same dtype, and within ``ulps`` of the dtype the value was last
    rounded in (``grid``, default its own dtype) at the tensor's largest
    magnitude; a value last rounded in fp32 within 1e-5 of it (the sums'
    order)."""
    assert _dtype_name(port) == _dtype_name(ref), (what, port.dtype,
                                                   ref.dtype)
    r, p = _f64(ref), _f64(port)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    mag = float(np.abs(r).max()) if r.size else 0.0
    grid = grid or _dtype_name(ref)
    tol = 1e-5 * mag if grid == "float32" else ulps * _ulp_at(grid, mag)
    err = float(np.abs(p - r).max()) if r.size else 0.0
    assert err <= tol, (what, err, tol)


def _inputs(spec, act):
    """Each package's inputs: ``spec`` maps slot -> (array, kind); kind
    "act" enters in ``act`` (the regime's activation dtype), "f32" and
    "int" as they are."""
    ref_in, port_in = {}, {}
    for slot, (arr, kind) in spec.items():
        if kind == "act" and act != "float32":
            ref_in[slot] = [jnp.asarray(arr).astype(_JNP[act])]
            port_in[slot] = [torch.from_numpy(arr).to(_TORCH[act])]
        else:
            ref_in[slot] = [jnp.asarray(arr)]
            port_in[slot] = [torch.from_numpy(arr)]
    return ref_in, port_in


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(*shape, scale=1.0, seed=0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _soft(r, v, seed=2):
    y = _rng(seed).random((r, v)).astype(np.float32)
    return y / y.sum(-1, keepdims=True)


def _probs(r, v, seed=3):
    return _soft(r, v, seed)


_CONV = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1}
_BN = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
       "data_layout": "NCHW"}
# op case -> (op type, {slot: (array, kind)}, attrs, forward outputs,
#             differentiable input slots); kind "act" is an activation
OP_CASES = {
    "mul": ("mul", {"X": (_normal(4, 8, 16), "act"),
                    "Y": (_normal(16, 12, seed=1), "f32")},
            {"x_num_col_dims": 2}, ["Out"], ["X", "Y"]),
    "matmul": ("matmul", {"X": (_normal(2, 3, 8, 16), "act"),
                          "Y": (_normal(2, 3, 8, 16, seed=1), "act")},
               {"transpose_Y": True, "alpha": 0.3}, ["Out"], ["X", "Y"]),
    "conv2d": ("conv2d", {"Input": (_normal(4, 8, 9, 9), "act"),
                          "Filter": (_normal(16, 8, 3, 3, scale=0.1,
                                             seed=1), "f32")},
               _CONV, ["Output"], ["Input", "Filter"]),
    "conv2d-image": ("conv2d", {"Input": (_normal(4, 3, 9, 9), "f32"),
                                "Filter": (_normal(8, 3, 3, 3, scale=0.2,
                                                   seed=1), "f32")},
                     dict(_CONV, strides=[2, 2]), ["Output"],
                     ["Input", "Filter"]),
    "batch_norm": ("batch_norm",
                   {"X": (_normal(4, 8, 9, 9), "act"),
                    "Scale": (_rng(1).random(8).astype(np.float32) + 0.5,
                              "f32"),
                    "Bias": (_normal(8, seed=2), "f32"),
                    "Mean": (np.zeros(8, np.float32), "f32"),
                    "Variance": (np.ones(8, np.float32), "f32")},
                   _BN, ["Y", "MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance"], ["X", "Scale", "Bias"]),
    "layer_norm": ("layer_norm",
                   {"X": (_normal(4, 8, 32), "act"),
                    "Scale": (_rng(1).random(32).astype(np.float32), "f32"),
                    "Bias": (_normal(32, seed=2), "f32")},
                   {"begin_norm_axis": 2, "epsilon": 1e-5},
                   ["Y", "Mean", "Variance"], ["X", "Scale", "Bias"]),
    "softmax": ("softmax", {"X": (_normal(4, 8, 32, scale=3), "act")}, {},
                ["Out"], ["X"]),
    "cross_entropy": ("cross_entropy",
                      {"X": (_probs(12, 10), "act"),
                       "Label": (_rng(4).integers(0, 10, (12, 1)), "int")},
                      {}, ["Y"], ["X"]),
    "xent-soft": ("softmax_with_cross_entropy",
                  {"Logits": (_normal(12, 40, scale=3), "act"),
                   "Label": (_soft(12, 40), "f32")},
                  {"soft_label": True}, ["Loss", "Softmax"], ["Logits"]),
    "xent-hard": ("softmax_with_cross_entropy",
                  {"Logits": (_normal(12, 40, scale=3), "act"),
                   "Label": (_rng(5).integers(0, 40, (12, 1)), "int")},
                  {"ignore_index": 3}, ["Loss", "Softmax"], ["Logits"]),
    "add-bias": ("elementwise_add", {"X": (_normal(4, 8, 32), "act"),
                                     "Y": (_normal(32, seed=1), "f32")},
                 {"axis": -1}, ["Out"], ["X", "Y"]),
    "add-residual": ("elementwise_add",
                     {"X": (_normal(4, 8, 32), "f32"),
                      "Y": (_normal(4, 8, 32, seed=1), "act")},
                     {"axis": -1}, ["Out"], ["X", "Y"]),
    "mul-weight": ("elementwise_mul", {"X": (_normal(4, 8, 32), "act"),
                                       "Y": (_normal(4, 8, 32, seed=1),
                                             "f32")},
                   {"axis": -1}, ["Out"], ["X", "Y"]),
    "scale": ("scale", {"X": (_normal(4, 8, 32), "act")},
              {"scale": 0.3, "bias": 0.1}, ["Out"], ["X"]),
}
for _case in OP_CASES.values():  # int64 labels, as the programs feed them
    for _slot, (_arr, _kind) in list(_case[1].items()):
        if _kind == "int":
            _case[1][_slot] = (_arr.astype(np.int64), _kind)


def _run_op(case, act):
    """(ref outputs, port outputs) of the op's forward, by slot."""
    op, spec, attrs, outs, _ = OP_CASES[case]
    ref_in, port_in = _inputs(spec, act)
    want = {o: [o] for o in outs}
    ref = ref_reg.get_op_def(op).fn(ref_reg.ExecContext(op, ref_in, want,
                                                        attrs))
    port = port_reg.get_op_def(op).fn(port_reg.ExecContext(
        op, port_in, want, attrs, torch.device("cpu")))
    return ref, port


def _run_grad(case, act):
    """(ref grads, port grads) of the op's differentiable inputs, given the
    same seeded cotangent for its first output, in that output's runtime
    dtype."""
    op, spec, attrs, outs, diff = OP_CASES[case]
    ref_in, port_in = _inputs(spec, act)
    _, port_out = _run_op(case, act)
    out = port_out[outs[0]]
    g = _normal(*out.shape, seed=7)
    dt = _dtype_name(out)
    ref_in[outs[0] + "@GRAD"] = [jnp.asarray(g).astype(_JNP[dt])]
    port_in[outs[0] + "@GRAD"] = [torch.from_numpy(g).to(_TORCH[dt])]
    want = {s + "@GRAD": [s + "@GRAD"] for s in diff}
    ref = ref_reg.run_grad_generic(ref_reg.get_op_def(op),
                                   ref_reg.ExecContext(op, ref_in, want,
                                                       attrs))
    pdef = port_reg.get_op_def(op)
    pctx = port_reg.ExecContext(op, port_in, want, attrs,
                                torch.device("cpu"))
    port = port_reg.normalize_outputs(
        pdef.grad_fn(pctx) if pdef.grad_fn else
        port_reg.run_grad_generic(pdef, pctx))
    return ref, port


def _act(dtype, keep):
    return dtype if keep else "float32"


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_forward_matches_reference(case, regime):
    dtype, keep = regime
    _enable(dtype, keep)
    ref, port = _run_op(case, _act(dtype, keep))
    product = OP_CASES[case][0] in ("mul", "matmul", "conv2d")
    for slot in OP_CASES[case][3]:
        _assert_close(f"{case}.{slot}", ref[slot], port[slot],
                      grid=dtype if product else None)


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_grad_matches_reference(case, regime):
    dtype, keep = regime
    _enable(dtype, keep)
    ref, port = _run_grad(case, _act(dtype, keep))
    for slot in OP_CASES[case][4]:
        name = slot + "@GRAD"
        broadcast_bias = case == "add-bias" and slot == "Y" and keep
        _assert_close(f"{case}.{name}", ref[name][0], port[name][0],
                      BIAS_ULPS if broadcast_bias else OP_ULPS, grid=dtype)


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
@pytest.mark.parametrize("causal,bias", [(False, False), (True, False),
                                         (False, True)],
                         ids=["plain", "causal", "bias"])
def test_full_attention_matches_reference(regime, causal, bias):
    dtype, keep = regime
    _enable(dtype, keep)
    act = _act(dtype, keep)
    q, k, v = (_normal(2, 2, 8, 16, seed=s) for s in range(3))
    b = np.where(np.arange(8)[None, None, None, :] < 6, 0.0,
                 -1e9).astype(np.float32) * np.ones((2, 1, 1, 1), np.float32)
    rq, rk, rv = (jnp.asarray(a).astype(_JNP[act]) for a in (q, k, v))
    pq, pk, pv = (torch.from_numpy(a).to(_TORCH[act]) for a in (q, k, v))
    ref = ref_ra.full_attention(rq, rk, rv, causal=causal,
                                bias=jnp.asarray(b) if bias else None)
    port = port_ra.full_attention(pq, pk, pv, causal=causal,
                                  bias=torch.from_numpy(b) if bias else None)
    _assert_close("full_attention", ref, port)


# -- the casts ----------------------------------------------------------------

def test_cast_operands_keep_regime():
    port_amp.enable("bfloat16", keep_activations=True)
    a = torch.ones(4, 4)
    b = torch.ones(4, 4, dtype=torch.bfloat16)
    a2, b2, back = port_amp.cast_operands(a, b)
    assert a2.dtype == b2.dtype == torch.bfloat16 and back is None
    # a non-fp32/bf16 operand passes the whole contraction through
    c = torch.ones(4, 4, dtype=torch.int32)
    a3, c3, back = port_amp.cast_operands(a, c)
    assert a3.dtype == torch.float32 and c3.dtype == torch.int32
    assert back is None
    # the restore regime casts fp32 down and back
    port_amp.enable("bfloat16", keep_activations=False)
    a4, b4, back = port_amp.cast_operands(a, torch.ones(4, 4))
    assert a4.dtype == b4.dtype == torch.bfloat16 and back == torch.float32
    assert port_amp.restore_astype(a4, back).dtype == torch.float32
    # restore regime: any operand not fp32 passes everything through
    a5, b5, back = port_amp.cast_operands(a, b)
    assert (a5.dtype, b5.dtype, back) == (torch.float32, torch.bfloat16,
                                          None)
    port_amp.disable()
    assert port_amp.cast_operands(a, a)[2] is None


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "low"), ("low", "low"),
                                    ("float32", "int32")])
def test_cast_operands_match_reference(regime, dtypes):
    dtype, keep = regime
    _enable(dtype, keep)
    names = [dtype if d == "low" else d for d in dtypes]
    ref = ref_amp.cast_operands(*(jnp.ones((2, 2), n) for n in names))
    port = port_amp.cast_operands(*(torch.ones(2, 2, dtype=getattr(torch, n))
                                    for n in names))
    assert [_dtype_name(t) for t in port[:-1]] == \
        [_dtype_name(t) for t in ref[:-1]]
    assert (port[-1] is None) == (ref[-1] is None)
    assert port_amp.keep_low_activations() == ref_amp.keep_low_activations()
    assert port_amp.compute_dtype() == ref_amp.compute_dtype()


def test_is_low_float_and_state():
    assert port_amp.is_low_float(torch.bfloat16)
    assert port_amp.is_low_float(torch.float16)
    assert not port_amp.is_low_float(torch.float32)
    assert not port_amp.is_low_float(torch.float64)
    assert not port_amp.is_low_float(torch.int32)
    assert not port_amp.is_enabled()
    with port_amp.amp_guard("float16", keep_activations=True):
        assert port_amp.compute_dtype() == "float16"
        assert port_amp.keep_low_activations()
        assert port_amp.dynamic_scaling_active()
    assert not port_amp.is_enabled()
    port_amp.enable("bfloat16")
    assert not port_amp.dynamic_scaling_active()
    port_amp.enable("bfloat16", dynamic_loss_scaling=True,
                    init_loss_scale=8.0, growth_interval=3)
    assert port_amp.dynamic_scaling_active()
    assert port_amp.scaling_config() == (8.0, 3)
    with pytest.raises(ValueError):
        port_amp.enable("float64")
    assert tf.amp is port_amp


def test_amp_knobs_are_declared():
    from paddle_tpu.fluid import envcontract as ref_env
    from paddle_tpu_torch.fluid import envcontract as port_env

    for name in ("PADDLE_TPU_AMP", "PADDLE_TPU_AMP_KEEP",
                 "PADDLE_TPU_AMP_INIT_SCALE",
                 "PADDLE_TPU_AMP_SCALE_INTERVAL"):
        r, p = ref_env.REGISTRY[name], port_env.REGISTRY[name]
        assert (p.type, p.default, p.choices) == (r.type, r.default,
                                                  r.choices)


def test_env_keep_default(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_AMP_KEEP", "1")
    port_amp.enable("bfloat16")
    assert port_amp.keep_low_activations()


# -- the generic grad's cotangent dtype ---------------------------------------

def test_generic_grad_casts_a_cotangent_to_the_runtime_dtype():
    """A bf16 activation read by two ops may be handed a grad of another
    dtype than its runtime output (the program declares fp32); the
    generic grad casts it, as the reference's ``jnp.asarray(g, p.dtype)``."""
    _enable("bfloat16", True)
    x = _normal(4, 8)
    g = _normal(4, 8, seed=3)
    ref = ref_reg.run_grad_generic(
        ref_reg.get_op_def("relu"), ref_reg.ExecContext(
            "relu", {"X": [jnp.asarray(x).astype(jnp.bfloat16)],
                     "Out@GRAD": [jnp.asarray(g)]}, {"X@GRAD": ["d"]}, {}))
    port = port_reg.run_grad_generic(
        port_reg.get_op_def("relu"), port_reg.ExecContext(
            "relu", {"X": [torch.from_numpy(x).bfloat16()],
                     "Out@GRAD": [torch.from_numpy(g)]}, {"X@GRAD": ["d"]},
            {}, torch.device("cpu")))
    _assert_close("relu X@GRAD", ref["X@GRAD"][0], port["X@GRAD"][0])


def _twice_read_program(pkg):
    """fc -> h (bf16 under keep), read by relu and by an elementwise_mul
    with an fp32 weight; their sum's mean is the loss."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[6, 8], dtype="float32",
                   append_batch_size=False)
        w = L.data("w", shape=[6, 5], dtype="float32",
                   append_batch_size=False)
        h = L.fc(x, 5, param_attr=pkg.ParamAttr(name="fw"),
                 bias_attr=pkg.ParamAttr(name="fb"))
        a = L.relu(h)
        b = L.elementwise_mul(h, w)
        loss = L.mean(L.elementwise_add(a, b))
        pkg.backward.append_backward(loss)
    return prog, startup, h


def test_activation_read_twice_gets_one_grad_dtype():
    _enable("bfloat16", True)
    ref_framework.fresh_session()
    feed = {"x": _normal(6, 8), "w": _normal(6, 5, seed=1)}
    init = {"fw": _normal(8, 5, seed=2), "fb": _normal(5, seed=3)}
    outs = []
    for pkg in (rf, tf):
        prog, startup, h = _twice_read_program(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        for n, a in init.items():
            if pkg is rf:
                scope.set(n, jnp.asarray(a))
            else:
                from paddle_tpu_torch.models.params import \
                    load_reference_params
                load_reference_params(scope, {n: a}, tf.CPUPlace())
        outs.append(exe.run(prog, feed=feed, fetch_list=[
            h.name + "@GRAD", "fw@GRAD", "fb@GRAD"], scope=scope,
            return_numpy=pkg is rf))
    for name, r, p in zip(("h@GRAD", "fw@GRAD", "fb@GRAD"), *outs):
        _assert_close(name, r, p, BIAS_ULPS if name == "fb@GRAD"
                      else OP_ULPS, grid="bfloat16")


# -- the xent plain versions --------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_xent_plain_versions_match_pallas(dtype, soft):
    r, v = 24, 600
    x = _normal(r, v, scale=3)
    if soft:
        lab = _soft(r, v)
        plab = jnp.asarray(lab)
        tlab = torch.from_numpy(lab)
        ignore = -100
    else:
        lab = _rng(6).integers(0, v, r).astype(np.int64)
        lab[::5] = 3
        plab = jnp.asarray(lab.astype(np.int32).reshape(-1, 1))
        tlab = torch.from_numpy(lab)
        ignore = 3
    xj = jnp.asarray(x).astype(_JNP[dtype])
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    (ref_loss, ref_lse), vjp = jax.vjp(
        lambda a: pf.softmax_xent(a, plab, soft, ignore, interpret=True), xj)
    loss, lse, _ = fused.softmax_xent_fwd(xt, tlab, soft, ignore)
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               **XENT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **XENT_TOL)
    dloss = _normal(r, 1, seed=8)
    dlse = _normal(r, 1, seed=9)
    (ref_dx,) = vjp((jnp.asarray(dloss), jnp.asarray(dlse)))
    xg = xt.clone().requires_grad_()
    l2, s2 = fused.SoftmaxXent.apply(xg, tlab, soft, ignore)
    (dx,) = torch.autograd.grad([l2, s2], [xg], [torch.from_numpy(dloss),
                                                  torch.from_numpy(dlse)])
    _assert_close("dx", ref_dx, dx)


def test_xent_wrappers_refuse_other_dtypes():
    x = torch.empty(4, 8, dtype=torch.float64, device="meta")
    lab = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused.softmax_xent_fwd(x, lab, False)
    with pytest.raises(TypeError, match="logits"):
        fused._xent_entry("fwd", x, lab, False)
    xb = torch.empty(4, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="soft labels"):
        fused._xent_entry("fwd", xb, torch.empty(4, 8, dtype=torch.float16),
                          True)
    assert fused._xent_entry("bwd", xb, torch.empty(4, 8), True) == \
        "pta_xent_bwd_bf16_f32"
    assert fused._xent_entry("fwd", xb.half(), lab, False) == \
        "pta_xent_fwd_f16_i64"


# -- Programs -----------------------------------------------------------------

def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(prog):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: _norm(v) for k, v in op.attrs.items()})
            for op in prog.global_block().ops]


def _vars(prog, core):
    return {v.name: (None if v.shape is None else tuple(v.shape),
                     core.convert_dtype(v.dtype), bool(v.persistable))
            for v in prog.global_block().vars.values()}


def _scaled_program(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", shape=[8], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        h = L.fc(L.fc(x, 16, act="relu"), 1)
        loss = L.mean(L.elementwise_mul(L.elementwise_add(h, y), h))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return prog, startup


def test_fp16_scaled_minimize_builds_the_reference_program():
    ref_framework.fresh_session()
    progs = []
    for pkg, amp in ((rf, ref_amp), (tf, port_amp)):
        amp.enable("float16", init_loss_scale=64.0, growth_interval=5)
        progs.append(_scaled_program(pkg))
    (rmain, rstart), (pmain, pstart) = progs
    for r, p in ((rstart, pstart), (rmain, pmain)):
        assert _ops(p) == _ops(r)
        assert _vars(p, port_core) == _vars(r, ref_core)
    assert pmain._loss_scale_vars == rmain._loss_scale_vars == (
        "@LOSS_SCALE@", "@LOSS_SCALE_GOOD@")
    assert pmain._loss_scale_growth == rmain._loss_scale_growth == 5
    unscale = [op for op in pmain.global_block().ops
               if op.type == "elementwise_div"]
    assert len(unscale) == 4  # two fc weights and biases
    assert all(op.input("Y") == ["@LOSS_SCALE@"] and op.attr("op_role") == 1
               for op in unscale)


@pytest.mark.parametrize("model", ["resnet50", "transformer_base"])
def test_models_build_the_reference_programs_under_keep(model):
    from paddle_tpu.models import resnet as ref_rn
    from paddle_tpu.models import transformer as ref_tm
    from paddle_tpu_torch.models import resnet as port_rn
    from paddle_tpu_torch.models import transformer as port_tm

    ref_framework.fresh_session()
    progs = []
    for pkg, amp, rn, tm in ((rf, ref_amp, ref_rn, ref_tm),
                             (tf, port_amp, port_rn, port_tm)):
        amp.enable("bfloat16", keep_activations=True)
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            if model == "resnet50":
                rn.build(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                         lr=0.1)
            else:
                cfg = tm.base_config()
                cfg.flash_attention = False
                tm.build(cfg, src_len=256, tgt_len=256, lr=1e-3)
        progs.append((main, startup))
    (rmain, rstart), (pmain, pstart) = progs
    for r, p in ((rstart, pstart), (rmain, pmain)):
        assert _ops(p) == _ops(r)
        assert _vars(p, port_core) == _vars(r, ref_core)
    assert getattr(pmain, "_loss_scale_vars", None) is None


# -- fetches ------------------------------------------------------------------

def test_bf16_fetch_comes_back_as_float32():
    _enable("bfloat16", True)
    ref_framework.fresh_session()
    feed = {"x": _normal(6, 8)}
    outs = []
    for pkg in (rf, tf):
        prog, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[6, 8], dtype="float32",
                                append_batch_size=False)
            h = pkg.layers.fc(x, 5, param_attr=pkg.ParamAttr(name="fw"),
                              bias_attr=False)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        w = _normal(8, 5, seed=2)
        if pkg is rf:
            scope.set("fw", jnp.asarray(w))
        else:
            from paddle_tpu_torch.models.params import load_reference_params
            load_reference_params(scope, {"fw": w}, tf.CPUPlace())
        outs.append(exe.run(prog, feed=feed, fetch_list=[h], scope=scope)[0])
    ref, port = outs
    assert str(ref.dtype) == "bfloat16"
    assert isinstance(port, np.ndarray) and port.dtype == np.float32
    np.testing.assert_array_equal(port, np.asarray(ref).astype(np.float32))
