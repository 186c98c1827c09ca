"""The flash kernels' bf16 / fp16 path (AMP with kept activations) against
the JAX package, on the CPU:

 - the plain versions of the flash kernels (``paddle_tpu_torch/ops/
   flash_attention.py``) on bf16 and fp16 q, k, v against
   ``pallas_flash.flash_attention`` in interpret mode (16-row blocks) at
   ``test_torch_flash.py``'s shapes (causal x bias, Tq != Tk, lengths that
   are not multiples of 16): out and lse of the forward, and dq, dk, dv of
   the ``FlashAttention`` autograd function and of ``flash_backward_ref``
   against ``jax.vjp`` of the Pallas kernel;
 - the tiny Transformer with ``flash_attention=True`` under bf16, with kept
   activations and restored, from the JAX package's initial scope: the
   first step's loss and every parameter grad, then a 3-step Adam
   trajectory; and, kept, its losses against the unfused build's;
 - the same model in fp16 with kept activations under the dynamic loss
   scaler, against the reference's guarded run;
 - :func:`kernel_dtype`: the dtype combinations the kernels take and the
   mixes they refuse; the ``ring_attention`` op hands its bf16 q, k, v and
   its fp32 padding bias to ``FlashAttention`` as they are.

Tolerances:

 - out, dq, dk, dv: ``chip_smoke.FLASH_LOW_TOL``, the bound the card holds
   the kernels to (one ulp of the dtype plus 2^-14 of the tensor's largest
   magnitude).  Both packages widen to fp32, sum in fp32 in another order
   (the Pallas kernel's online softmax over 16-column tiles against the
   plain whole row) and round each output once (measured: every element
   inside it, at most 4 fp16 ulps on small dq elements).  lse rtol / atol
   2e-5, as ``test_torch_flash.py`` (measured 0);
 - the training slice, in bf16 ulps at a tensor's largest magnitude, as
   ``test_torch_amp_train.py`` holds the unfused build: kept within
   ``KEEP_ULPS`` = 8 (measured 4.0: the bf16 activations carry fp32-ulp
   differences upstream into roundings here and there); restored within
   ``FLASH_RESTORE_ULPS`` = 2, not that file's 1 (measured 1.33 on
   ``dec0_cross_k_w``: the flash sums are fp32 sums taken in another order
   than the reference's, and the next bf16 rounding flips here and
   there); losses step 0 rtol 1e-5, then 1e-3;
 - kept, flash against unfused (both the port's): the unfused attention
   rounds P to bf16, flash keeps it fp32, and their losses part by 1.4e-4
   over these 3 steps (up to 4.0e-4 over other feeds and a 2 x 32 batch),
   held to ``chip_smoke.FLASH_AMP_UNFUSED_RTOL``, the bound the card's
   ``train_flash_amp_parity`` uses;
 - the fp16 scaler (from 2^24, growth every 2 good steps, 10 steps): the
   same scale sequence and the same overflow steps as the reference,
   losses within rtol 1e-3 (measured 7.2e-5).

The reference runs jitted with XLA's ``xla_allow_excess_precision`` off
(see ``test_torch_amp_train.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu.ops import pallas_flash as pf
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.models.params import load_reference_params
from paddle_tpu_torch.ops import flash_attention as fa

LSE_TOL = dict(rtol=2e-5, atol=2e-5)
KEEP_ULPS = 8
FLASH_RESTORE_ULPS = 2
LOSS0_RTOL = 1e-5
LOSS_RTOL = 1e-3
SCALER_LOSS_RTOL = 1e-3
B, H, D = 2, 2, 16
BLOCK = 16
L = 8
LOW = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.fixture(autouse=True)
def amp_off_after():
    port_framework.fresh_session()
    saved = dict(ref_amp._state), dict(port_amp._state)
    yield
    for amp, state in zip((ref_amp, port_amp), saved):
        amp._state.update(state)
        amp.disable()


@pytest.fixture
def reference_rounds_as_written(monkeypatch):
    """``jax.jit`` without XLA's excess precision (see the docstring)."""
    jit = jax.jit

    def strict_jit(fun=None, **kw):
        kw.setdefault("compiler_options",
                      {"xla_allow_excess_precision": False})
        if fun is None:
            return functools.partial(strict_jit, **kw)
        return jit(fun, **kw)

    monkeypatch.setattr(jax, "jit", strict_jit)


# -- the plain versions against the Pallas kernels --------------------------

def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bias(kind, t_k):
    """None, a [B, 1, 1, Tk] padding bias with a ragged pad per row, or a
    [1, Tk] bias shared by the batch (float32, as the model makes it)."""
    if kind is None:
        return None
    if kind == "padding":
        bias = np.zeros((B, 1, 1, t_k), np.float32)
        bias[0, ..., -3:] = -1e9
        bias[1, ..., -1:] = -1e9
        return bias
    return _rand(1, t_k, seed=5)


# (Tq, Tk, causal, bias), as test_torch_flash.py
KERNEL_CASES = [(20, 13, False, None), (20, 13, True, None),
                (12, 21, False, "padding"), (12, 21, True, "padding"),
                (21, 21, False, "shared"), (17, 23, True, "shared")]
CASES = [(dt, *c) for dt in LOW for c in KERNEL_CASES]
IDS = [f"{str(dt)[6:]}-tq{a}-tk{b}-{'causal' if c else 'full'}-{k or 'nobias'}"
       for dt, a, b, c, k in CASES]


def _inputs(dtype, t_q, t_k, kind):
    """q, k, v, dO in ``dtype`` (torch) and the same values in jnp, and the
    fp32 bias in both."""
    ts = [torch.from_numpy(_rand(B, H, t, D, seed=s)).to(dtype)
          for t, s in ((t_q, 1), (t_k, 2), (t_k, 3), (t_q, 4))]
    js = [jnp.asarray(t.float().numpy()).astype(LOW[dtype]) for t in ts]
    bias = _bias(kind, t_k)
    return (ts, js, None if bias is None else torch.from_numpy(bias),
            None if bias is None else jnp.asarray(bias))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _assert_low_close(got, want, name):
    assert got.dtype == want.dtype, name
    excess = chip_smoke.low_excess(got, want)
    assert excess <= 0, (name, chip_smoke.ulp_err(got, want), excess)


@pytest.mark.parametrize("dtype,t_q,t_k,causal,kind", CASES, ids=IDS)
def test_forward_matches_pallas(dtype, t_q, t_k, causal, kind):
    (q, k, v, _), (jq, jk, jv, _), bias, jbias = _inputs(dtype, t_q, t_k,
                                                         kind)
    ref_out, ref_lse = pf._flash_fwd_impl(jq, jk, jv, jbias, None, causal,
                                          BLOCK, BLOCK, True)
    out, lse = fa.flash_forward_ref(q, k, v, bias, causal=causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert ref_out.dtype == LOW[dtype]
    _assert_low_close(out, _torch(ref_out, dtype), "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **LSE_TOL)


@pytest.mark.parametrize("dtype,t_q,t_k,causal,kind", CASES, ids=IDS)
def test_backward_matches_pallas_vjp(dtype, t_q, t_k, causal, kind):
    (q, k, v, do), (jq, jk, jv, jdo), bias, jbias = _inputs(dtype, t_q, t_k,
                                                            kind)
    args = [jq, jk, jv] + ([] if jbias is None else [jbias])
    _, vjp = jax.vjp(
        lambda *a: pf.flash_attention(
            a[0], a[1], a[2], a[3] if len(a) > 3 else None, causal=causal,
            block_q=BLOCK, block_k=BLOCK, interpret=True), *args)
    ref = vjp(jdo)
    out, lse = fa.flash_forward_ref(q, k, v, bias, causal=causal)
    plain = fa.flash_backward_ref(q, k, v, bias, out, lse, do,
                                  causal=causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(
        fa.FlashAttention.apply(*leaves, bias, None, causal), leaves, do)
    for i, name in enumerate(("dq", "dk", "dv")):
        want = _torch(ref[i], dtype)
        for mine in (plain[i], grads[i]):
            _assert_low_close(mine, want, name)


# -- the wrappers' dtype rules ------------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("qkv,bias", [
    (F32, F32), (BF16, F32), (BF16, BF16), (F16, F32), (F16, F16),
    (BF16, None)])
def test_kernel_dtype_accepts(qkv, bias):
    t = torch.zeros(1, 1, 4, 16, dtype=qkv)
    rows = torch.zeros(1, 1, 4, 1)
    b = None if bias is None else torch.zeros(1, 4, dtype=bias)
    assert fa.kernel_dtype(t, t, t, b) == qkv
    assert fa.kernel_dtype(t, t, t, b, t.clone(), rows, rows) == qkv


@pytest.mark.parametrize("field,dtype", [
    ("q", torch.float64), ("k", F32), ("v", F16), ("do", F32),
    ("bias", F16), ("bias", torch.float64), ("lse", BF16), ("delta", F16)],
    ids=lambda x: x if isinstance(x, str) else str(x)[6:])
def test_kernel_dtype_refuses_mixes(field, dtype):
    """q, k, v, dO in bf16: any other dtype among them, a bias neither fp32
    nor bf16, or lse / delta not fp32, raises."""
    args = {"q": torch.zeros(1, 1, 4, 16, dtype=BF16),
            "k": torch.zeros(1, 1, 4, 16, dtype=BF16),
            "v": torch.zeros(1, 1, 4, 16, dtype=BF16),
            "bias": torch.zeros(1, 4), "do": torch.zeros(1, 1, 4, 16,
                                                          dtype=BF16),
            "lse": torch.zeros(1, 1, 4, 1), "delta": torch.zeros(1, 1, 4, 1)}
    args[field] = args[field].to(dtype)
    with pytest.raises(TypeError, match=field if field != "do" else "dO"):
        fa.kernel_dtype(**args)


def test_cpu_wrappers_run_the_plain_versions_in_bf16():
    """bf16 CPU tensors: the wrappers return the plain versions' outputs,
    in bf16, and count no launch of any dtype."""
    (q, k, v, do), _, bias, _ = _inputs(BF16, 12, 21, "padding")
    counts = (dict(fa.flash_fwd_launches_by_dtype),
              dict(fa.flash_dq_launches_by_dtype),
              dict(fa.flash_dkv_launches_by_dtype), fa.flash_fwd_launches)
    out, lse = fa.flash_forward(q, k, v, bias, None, True)
    r_out, r_lse = fa.flash_forward_ref(q, k, v, bias, None, True)
    assert out.dtype == BF16 and torch.equal(out, r_out)
    assert torch.equal(lse, r_lse)
    delta = fa._delta(out, do)
    dq = fa.flash_dq(q, k, v, bias, do, lse, delta, None, True)
    dk, dv = fa.flash_dkv(q, k, v, bias, do, lse, delta, None, True)
    for got, want in zip((dq, dk, dv), fa.flash_backward_ref(
            q, k, v, bias, out, lse, do, None, True)):
        assert got.dtype == BF16 and torch.equal(got, want)
    assert (dict(fa.flash_fwd_launches_by_dtype),
            dict(fa.flash_dq_launches_by_dtype),
            dict(fa.flash_dkv_launches_by_dtype),
            fa.flash_fwd_launches) == counts


def test_ring_attention_op_hands_low_inputs_to_flash(monkeypatch):
    """Under bf16 with kept activations the ``ring_attention`` op passes
    its bf16 q, k, v to ``FlashAttention`` as they are, with the padding
    bias in fp32 (or none): dtypes the kernels take."""
    from paddle_tpu_torch.ops import attention_ops

    seen, apply = [], fa.FlashAttention.apply

    def spy(q, k, v, bias, *rest):
        seen.append((q.dtype, k.dtype, v.dtype,
                     None if bias is None else bias.dtype,
                     fa.kernel_dtype(q, k, v, bias)))
        return apply(q, k, v, bias, *rest)

    monkeypatch.setattr(fa.FlashAttention, "apply", spy)
    port_amp.enable("bfloat16", keep_activations=True)
    main, startup, cost = _build(tf, port_tm)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    # 6 ops, each run in the forward and again in its generic grad
    assert len(seen) == 12
    assert {s[:3] + (s[4],) for s in seen} == {(BF16,) * 4}
    assert {s[3] for s in seen} <= {None, F32} and F32 in {s[3] for s in seen}


# -- the tiny Transformer with flash attention --------------------------------

def _bf16_ulp(mag):
    return 2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - 7)


def _build(pkg, tm, flash=True):
    cfg = tm.tiny_config()
    cfg.flash_attention = flash
    cfg.label_smooth, cfg.dropout = 0.1, 0.0
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


def _feed(batch=4):
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (batch, L)),
            "tgt_word": rng.integers(1, 1000, (batch, L)),
            "lbl_word": rng.integers(1, 1000, (batch, L, 1))}
    feed["src_word"][0, -2:] = 0  # padding: the kernels' bias path
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


def _snapshot(scope, startup):
    return {v.name: np.array(scope.get(v.name)) for v in startup.list_vars()
            if v.persistable}


def _train_port(init, keep, flash, steps=3):
    """The port's run from ``init``: ``[step fetches]``, step 0 the loss
    and every parameter grad, later steps the loss."""
    port_amp.enable("bfloat16", keep_activations=keep)
    main, startup, cost = _build(tf, port_tm, flash)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    load_reference_params(scope, init, tf.CPUPlace())
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.trainable)
    out = []
    for step in range(steps):
        fetch = [cost] + ([p + "@GRAD" for p in params] if step == 0
                          else [])
        out.append([np.asarray(v, np.float64) for v in exe.run(
            main, feed=_feed(), fetch_list=fetch, scope=scope)])
    port_amp.disable()
    return params, out


def _train_reference(keep, steps=3):
    ref_framework.fresh_session()
    ref_amp.enable("bfloat16", keep_activations=keep)
    main, startup, cost = _build(rf, ref_tm)
    exe, scope = rf.Executor(rf.CPUPlace()), rf.Scope()
    exe.run(startup, scope=scope)
    init = _snapshot(scope, startup)
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.trainable)
    out = []
    for step in range(steps):
        fetch = [cost] + ([p + "@GRAD" for p in params] if step == 0
                          else [])
        out.append([np.asarray(v, np.float64) for v in exe.run(
            main, feed=_feed(), fetch_list=fetch, scope=scope)])
    ref_amp.disable()
    return init, params, out


def _losses(run):
    return np.array([s[0].reshape(-1)[0] for s in run])


@pytest.mark.parametrize("keep", [True, False], ids=["keep", "restore"])
def test_flash_transformer_amp_matches_reference(
        keep, reference_rounds_as_written):
    init, rparams, ref = _train_reference(keep)
    pparams, port = _train_port(init, keep, flash=True)
    assert pparams == rparams and len(rparams) == 64
    ulps = KEEP_ULPS if keep else FLASH_RESTORE_ULPS
    for name, r, p in zip(rparams, ref[0][1:], port[0][1:]):
        assert p.shape == r.shape, name
        mag = float(np.abs(r).max())
        err = float(np.abs(p - r).max())
        assert err <= ulps * _bf16_ulp(mag), (name, err / _bf16_ulp(mag))
    rl, pl = _losses(ref), _losses(port)
    np.testing.assert_allclose(pl[0], rl[0], rtol=LOSS0_RTOL)
    np.testing.assert_allclose(pl[1:], rl[1:], rtol=LOSS_RTOL)
    assert pl[-1] < pl[0]
    if keep:  # the same start through the unfused attention
        _, unfused = _train_port(init, keep, flash=False)
        np.testing.assert_allclose(
            pl, _losses(unfused), rtol=chip_smoke.FLASH_AMP_UNFUSED_RTOL)


# -- the fp16 dynamic loss scaler with flash attention ------------------------

SCALER_STEPS = 10
INIT_SCALE = 2.0 ** 24
GROWTH = 2


def _read_write_state(main):
    """The persistables a step both reads and writes."""
    block = main.global_block()
    reads = {n for op in block.ops for n in op.input_arg_names if n}
    writes = {n for op in block.ops for n in op.output_arg_names if n}
    return sorted(n for n in reads & writes
                  if block._var_recursive(n).persistable)


def _scaler_run(pkg, tm, amp, init):
    """``(initial state, per-step loss, scale, good-step count and whether
    every read-write persistable kept its value bitwise)``; the reference
    (``init`` None) starts from its own initial state, the port from the
    reference's."""
    amp.enable("float16", keep_activations=True, init_loss_scale=INIT_SCALE,
               growth_interval=GROWTH)
    main, startup, cost = _build(pkg, tm)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is None:
        init = {n: a for n, a in _snapshot(scope, startup).items()
                if not n.startswith("@LOSS")}
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    state = _read_write_state(main)

    def snap():
        return {n: np.array(scope.get(n)) for n in state}

    steps = []
    for _ in range(SCALER_STEPS):
        before = snap()
        (lv,) = exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
        after = snap()
        steps.append({
            "loss": float(np.asarray(lv).reshape(-1)[0]),
            "scale": float(np.asarray(scope.get("@LOSS_SCALE@")
                                      ).reshape(-1)[0]),
            "good": int(np.asarray(scope.get("@LOSS_SCALE_GOOD@")
                                   ).reshape(-1)[0]),
            "unchanged": all(np.array_equal(before[n], after[n])
                             for n in state)})
    amp.disable()
    return init, steps


def test_flash_fp16_scaler_matches_reference(reference_rounds_as_written):
    """From a scale that overflows: both packages skip the same steps and
    walk the same scale sequence; the losses agree."""
    ref_framework.fresh_session()
    init, ref = _scaler_run(rf, ref_tm, ref_amp, None)
    _, port = _scaler_run(tf, port_tm, port_amp, init)
    assert [(s["scale"], s["good"], s["unchanged"]) for s in port] == \
        [(s["scale"], s["good"], s["unchanged"]) for s in ref]
    skipped = [s["unchanged"] for s in ref]
    assert skipped[0] and not all(skipped)
    assert any(b["scale"] > a["scale"] for a, b in zip(ref, ref[1:]))
    np.testing.assert_allclose([s["loss"] for s in port],
                               [s["loss"] for s in ref],
                               rtol=SCALER_LOSS_RTOL)
