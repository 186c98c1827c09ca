"""``fluid.amp`` training in the port against the JAX package, on the CPU.

The tiny Transformer (unfused attention, dropout 0, label smoothing 0.1)
under bf16 keep_activations and bf16 restore, from the JAX package's
initial scope carried across: the first step's loss and every parameter
grad, then a 3-step Adam trajectory.

The reference runs jitted with XLA's ``xla_allow_excess_precision`` off
(``jax.jit`` wrapped in this file only).  With it on, XLA's CPU compiler
removes the f32 -> bf16 -> f32 conversion pairs of a restored product, so
the jitted reference skips the bf16 roundings its source writes (a
bf16-restore grad moved by up to 11 % of a tensor's largest value); off,
it rounds where the source says, as eager JAX and the port do.

Tolerances, in bf16 ulps at a tensor's largest magnitude:

 - restore: every grad within ``RESTORE_ULPS`` = 1.  Each product is
   rounded to bf16 once in both packages and all else is fp32; an fp32-ulp
   difference upstream (torch's fused layer_norm against the reference's
   composed formula) flips an occasional rounding (measured 0.07);
 - keep: within ``KEEP_ULPS`` = 8.  The activations are bf16, so those
   fp32-ulp differences of the layer-0 residual stream flip the bf16
   rounding of the next product's operand here and there, and the flips
   travel through every later grad; the biases' grads are also summed over
   the batch in bf16 by the reference (a reduction on bf16 operands) and
   in fp32 by the port (measured 4.03);
 - losses: step 0 within rtol 1e-5 (an fp32 mean of the same bf16
   logits; measured 3e-7), steps 1-2 within rtol 1e-3, a quarter of bf16's
   relative step 2^-8 (measured 6.4e-5).

The fp16 dynamic loss scaler against the reference's guarded
``Executor.run``: fc -> batch_norm -> fc -> squared error with Adam at
batch 8, an ``init_loss_scale`` of 2^20 (the seed over 8 rows, 2^17,
rounds to inf as it enters the fp16 product, and the products of the next
five halvings overflow too), ``growth_interval`` 2, 12 steps.  Both
packages follow the same scale sequence (six halvings, then growth after
two good steps, an overflow at the grown scale, and growth again); on an
overflow step every read-write persistable (parameters, Adam moments and
beta pows, batch-norm running stats) keeps its value bitwise; the losses
agree within rtol 1e-3, an fp16 relative step 2^-10 (measured 9.3e-8),
the final state within rtol 1e-3 / atol 1e-6 (measured 2.2e-7).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.models.params import load_reference_params

RESTORE_ULPS = 1
KEEP_ULPS = 8
LOSS0_RTOL = 1e-5
LOSS_RTOL = 1e-3
SCALER_LOSS_RTOL = 1e-3
B, L = 4, 8


@pytest.fixture(autouse=True)
def amp_off_after():
    port_framework.fresh_session()
    saved = dict(ref_amp._state), dict(port_amp._state)
    yield
    # off, with the scaler's settings as they were (the state is global)
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


def _bf16_ulp(mag):
    return 2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - 7)


def _build(pkg, tm):
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    cfg.label_smooth, cfg.dropout = 0.1, 0.0
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


def _feed():
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (B, L)),
            "tgt_word": rng.integers(1, 1000, (B, L)),
            "lbl_word": rng.integers(1, 1000, (B, L, 1))}
    feed["src_word"][0, -2:] = 0  # padding: the bias and the loss mask
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


def _train_both(keep, steps=3):
    """Per package: ``(params, [step fetches])``; step 0 fetches the loss
    and every parameter grad, later steps the loss."""
    ref_framework.fresh_session()
    results, init = [], None
    for pkg, tm, amp in ((rf, ref_tm, ref_amp), (tf, port_tm, port_amp)):
        amp.enable("bfloat16", keep_activations=keep)
        main, startup, cost = _build(pkg, tm)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        persist = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:  # the JAX package's initial state
            init = {n: np.array(scope.get(n)) for n in persist}
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        params = sorted(p.name for p in main.global_block().all_parameters()
                        if p.trainable)
        out = []
        for step in range(steps):
            fetch = [cost] + ([p + "@GRAD" for p in params] if step == 0
                              else [])
            out.append([np.asarray(v, np.float64) for v in exe.run(
                main, feed=_feed(), fetch_list=fetch, scope=scope)])
        amp.disable()
        results.append((params, out))
    return results


@pytest.mark.parametrize("keep", [True, False], ids=["keep", "restore"])
def test_transformer_amp_matches_reference(keep, reference_rounds_as_written):
    (rparams, ref), (pparams, port) = _train_both(keep)
    assert pparams == rparams and len(rparams) == 64
    ulps = KEEP_ULPS if keep else RESTORE_ULPS
    for name, r, p in zip(rparams, ref[0][1:], port[0][1:]):
        assert p.shape == r.shape, name
        mag = float(np.abs(r).max())
        err = float(np.abs(p - r).max())
        assert err <= ulps * _bf16_ulp(mag), (name, err / _bf16_ulp(mag))
    rl = np.array([s[0].reshape(-1)[0] for s in ref])
    pl = np.array([s[0].reshape(-1)[0] for s in port])
    np.testing.assert_allclose(pl[0], rl[0], rtol=LOSS0_RTOL)
    np.testing.assert_allclose(pl[1:], rl[1:], rtol=LOSS_RTOL)
    assert pl[-1] < pl[0]


# -- the fp16 dynamic loss scaler ---------------------------------------------

SCALER_STEPS = 12
SCALER_BATCH = 8
INIT_SCALE = 2.0 ** 20
GROWTH = 2


def _scaler_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L_ = pkg.layers
        x = L_.data("x", shape=[SCALER_BATCH, 6], dtype="float32",
                    append_batch_size=False)
        t = L_.data("t", shape=[SCALER_BATCH, 1], dtype="float32",
                    append_batch_size=False)
        h = L_.fc(x, 8, param_attr=pkg.ParamAttr(name="w1"), bias_attr=False)
        h = L_.batch_norm(h, param_attr=pkg.ParamAttr(name="bn_s"),
                          bias_attr=pkg.ParamAttr(name="bn_b"),
                          moving_mean_name="bn_m",
                          moving_variance_name="bn_v")
        y = L_.fc(h, 1, param_attr=pkg.ParamAttr(name="w2"),
                  bias_attr=pkg.ParamAttr(name="b2"))
        d = L_.elementwise_add(y, L_.scale(t, scale=-1.0))
        loss = L_.mean(L_.elementwise_mul(d, d))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _read_write_state(main):
    """The persistables a step both reads and writes."""
    block = main.global_block()
    reads = {n for op in block.ops for n in op.input_arg_names if n}
    writes = {n for op in block.ops for n in op.output_arg_names if n}
    return sorted(n for n in reads & writes
                  if block._var_recursive(n).persistable)


def _scaler_run(pkg, amp, init):
    amp.enable("float16", init_loss_scale=INIT_SCALE, growth_interval=GROWTH)
    main, startup, loss = _scaler_program(pkg)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if pkg is rf:
        for n, a in init.items():
            scope.set(n, jax.numpy.asarray(a))
    else:
        load_reference_params(scope, init, tf.CPUPlace())
    state_names = _read_write_state(main)
    rng = np.random.default_rng(1)
    feed = {"x": rng.standard_normal((SCALER_BATCH, 6)).astype(np.float32),
            "t": rng.standard_normal((SCALER_BATCH, 1)).astype(np.float32)}

    def snap():
        return {n: np.array(scope.get(n)) for n in state_names}

    steps = []
    for _ in range(SCALER_STEPS):
        before = snap()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        after = snap()
        steps.append({"loss": float(np.asarray(lv).reshape(-1)[0]),
                      "scale": float(np.asarray(
                          scope.get("@LOSS_SCALE@")).reshape(-1)[0]),
                      "good": int(np.asarray(
                          scope.get("@LOSS_SCALE_GOOD@")).reshape(-1)[0]),
                      "unchanged": all(np.array_equal(before[n], after[n])
                                       for n in state_names)})
    amp.disable()
    return steps, state_names, snap()


def test_fp16_loss_scaler_matches_reference():
    ref_framework.fresh_session()
    with ref_amp.amp_guard("float16"):
        main, startup, _ = _scaler_program(rf)
        scope = rf.Scope()
        rf.Executor(rf.CPUPlace()).run(startup, scope=scope)
        # the parameters and optimizer state; each run's startup sets the
        # scale vars from its own init_loss_scale
        amp_init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars()
                    if v.persistable and not v.name.startswith("@LOSS")}
    ref_framework.fresh_session()
    ref, names, ref_state = _scaler_run(rf, ref_amp, amp_init)
    port, pnames, port_state = _scaler_run(tf, port_amp, amp_init)
    assert pnames == names
    # the state reverted covers parameters, Adam moments and beta pows, and
    # the batch-norm running stats
    assert {"w1", "bn_m", "bn_v"} <= set(names)
    assert any("beta1_pow" in n for n in names)
    want_scales, scale, good = [], INIT_SCALE, 0
    for step in ref:  # the rule, applied to the reference's own overflows
        if step["unchanged"]:
            scale, good = max(scale / 2, 1.0), 0
        else:
            good += 1
            if good >= GROWTH:
                scale, good = scale * 2, 0
        want_scales.append((scale, good))
    assert [(s["scale"], s["good"]) for s in ref] == want_scales
    assert [(s["scale"], s["good"]) for s in port] == want_scales
    assert [s["unchanged"] for s in port] == [s["unchanged"] for s in ref]
    overflowed = [s["unchanged"] for s in ref]
    assert overflowed[0] and not all(overflowed)
    assert any(s[1] == 0 and not o for s, o in zip(want_scales, overflowed))
    np.testing.assert_allclose([s["loss"] for s in port],
                               [s["loss"] for s in ref],
                               rtol=SCALER_LOSS_RTOL)
    for n in names:
        np.testing.assert_allclose(port_state[n], ref_state[n], rtol=1e-3,
                                   atol=1e-6, err_msg=n)


def test_guardian_policies_are_not_ported():
    from paddle_tpu_torch.fluid import guardian

    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        guardian.enable("skip")


def test_unscaled_program_runs_unguarded():
    """bf16 builds no scaler: the program carries no scale vars and the
    Executor runs it as before."""
    from paddle_tpu_torch.fluid import guardian

    port_amp.enable("bfloat16")
    main, startup, loss = _scaler_program(tf)
    assert guardian.for_program(main) is None
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    (lv,) = exe.run(main, feed={
        "x": np.ones((SCALER_BATCH, 6), np.float32),
        "t": np.zeros((SCALER_BATCH, 1), np.float32)},
        fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()
    assert scope.get("@LOSS_SCALE@") is None


def test_scaler_step_reverts_bitwise_on_injected_overflow():
    """An Inf in the feed makes every grad non-finite: nothing read-write
    moves, bitwise, and the scale halves; the next finite step trains."""
    port_amp.enable("float16", init_loss_scale=8.0, growth_interval=100)
    main, startup, loss = _scaler_program(tf)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    names = _read_write_state(main)
    rng = np.random.default_rng(2)
    feed = {"x": rng.standard_normal((SCALER_BATCH, 6)).astype(np.float32),
            "t": np.zeros((SCALER_BATCH, 1), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = {n: scope.get(n).clone() for n in names}
    bad = dict(feed, x=feed["x"].copy())
    bad["x"][0, 0] = np.inf
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    for n in names:
        assert torch.equal(scope.get(n), before[n]), n
    assert float(scope.get("@LOSS_SCALE@")) == 4.0
    assert int(scope.get("@LOSS_SCALE_GOOD@")) == 0
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert not torch.equal(scope.get("w1"), before["w1"])
    assert int(scope.get("@LOSS_SCALE_GOOD@")) == 1
