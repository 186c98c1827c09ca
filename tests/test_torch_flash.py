"""The flash slice of the port against the JAX package, on the CPU:

 - the plain versions of the flash kernels (``paddle_tpu_torch/ops/
   flash_attention.py``) against the Pallas kernels of
   ``paddle_tpu/ops/pallas_flash.py`` in interpret mode (16-row blocks),
   for out and lse, over causal x bias, with Tq != Tk and lengths that
   are not multiples of 16;
 - ``flash_backward_ref`` and the ``FlashAttention`` autograd function's
   gradients against ``jax.vjp`` of the Pallas kernel and against
   ``flash_bwd_reference``; the bias gradient is exactly zero;
 - the ``ring_attention`` op against the reference op, for ``flash`` 1 and
   0 and for a bias shape the kernels do not take;
 - ``_flash_decision``'s precedence, with no env switch;
 - the tiny Transformer with ``flash_attention=True`` (and with
   ``ring_attention=True``) builds the same Program as the JAX package and
   trains the same 5-step Adam trajectory from the JAX package's initial
   scope (dropout 0).

Tolerances, float32 on both sides, the sums in another order (the Pallas
kernel's online softmax over 16-column tiles against the plain version's
whole row): out and lse rtol 2e-5 / atol 2e-5, as the reference's own
``tests/test_pallas_flash.py`` holds its kernel to full attention;
gradients rtol 1e-4 / atol 1e-5 (dS = P(dP - delta) cancels); the
training slice as ``tests/test_torch_train.py`` holds it: first-step
grads rtol 1e-4 / atol 1e-5, losses rtol 1e-4.  The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import core as ref_core
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu.ops import pallas_flash as pf
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.ops import flash_attention as fa

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP0_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
B, H, D = 2, 2, 16
BLOCK = 16
L = 8


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bias(kind, t_k, seed=5):
    """None, a [B, 1, 1, Tk] padding bias with a ragged pad per row, or a
    [1, Tk] bias shared by the batch."""
    if kind is None:
        return None
    if kind == "padding":
        bias = np.zeros((B, 1, 1, t_k), np.float32)
        bias[0, ..., -3:] = -1e9
        bias[1, ..., -1:] = -1e9
        return bias
    return (np.random.default_rng(seed).standard_normal((1, t_k))
            .astype(np.float32))


def _bias4(bias, t_k):
    return None if bias is None else bias.reshape(-1, 1, 1, t_k)


# (Tq, Tk, causal, bias): Tq != Tk, neither a multiple of 16
KERNEL_CASES = [(20, 13, False, None), (20, 13, True, None),
                (12, 21, False, "padding"), (12, 21, True, "padding"),
                (21, 21, False, "shared"), (17, 23, True, "shared")]
KERNEL_IDS = [f"tq{a}-tk{b}-{'causal' if c else 'full'}-{k or 'nobias'}"
              for a, b, c, k in KERNEL_CASES]


def _inputs(t_q, t_k, kind):
    q = _rand(B, H, t_q, D, seed=1)
    k = _rand(B, H, t_k, D, seed=2)
    v = _rand(B, H, t_k, D, seed=3)
    return q, k, v, _bias(kind, t_k)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("t_q,t_k,causal,kind", KERNEL_CASES, ids=KERNEL_IDS)
def test_forward_matches_pallas(t_q, t_k, causal, kind):
    q, k, v, bias = _inputs(t_q, t_k, kind)
    ref_out, ref_lse = pf._flash_fwd_impl(
        _jnp(q), _jnp(k), _jnp(v), _jnp(bias), None, causal, BLOCK, BLOCK,
        True)
    out, lse = fa.flash_forward_ref(_t(q), _t(k), _t(v), _t(bias),
                                    causal=causal)
    assert out.shape == (B, H, t_q, D) and lse.shape == (B, H, t_q, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **FWD_TOL)
    # the public reference entry point gives the same out
    np.testing.assert_allclose(
        out.numpy(), np.asarray(pf.flash_attention(
            _jnp(q), _jnp(k), _jnp(v), _jnp(bias), causal=causal,
            block_q=BLOCK, block_k=BLOCK, interpret=True)), **FWD_TOL)


@pytest.mark.parametrize("t_q,t_k,causal,kind", KERNEL_CASES, ids=KERNEL_IDS)
def test_backward_matches_pallas_vjp(t_q, t_k, causal, kind):
    q, k, v, bias = _inputs(t_q, t_k, kind)
    do = _rand(B, H, t_q, D, seed=4)
    args = [_jnp(q), _jnp(k), _jnp(v)] + ([] if bias is None
                                          else [_jnp(bias)])
    _, vjp = jax.vjp(
        lambda *a: pf.flash_attention(
            a[0], a[1], a[2], a[3] if len(a) > 3 else None, causal=causal,
            block_q=BLOCK, block_k=BLOCK, interpret=True), *args)
    ref = vjp(jnp.asarray(do))
    oracle = pf.flash_bwd_reference(_jnp(q), _jnp(k), _jnp(v), _jnp(do),
                                    _jnp(_bias4(bias, t_k)), causal=causal)

    # the plain backward from the plain forward's out and lse
    tq_, tk_, tv_, tb_, tdo = map(_t, (q, k, v, bias, do))
    out, lse = fa.flash_forward_ref(tq_, tk_, tv_, tb_, causal=causal)
    plain = fa.flash_backward_ref(tq_, tk_, tv_, tb_, out, lse, tdo,
                                  causal=causal)
    # the autograd function, bias a leaf too
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (q, k, v) + (() if bias is None else (bias,))]
    got = fa.FlashAttention.apply(*leaves[:3], leaves[3] if bias is not None
                                  else None, None, causal)
    grads = torch.autograd.grad(got, leaves, tdo)

    for i, name in enumerate(("dq", "dk", "dv")):
        for mine in (plain[i], grads[i]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref[i]),
                                       err_msg=name, **GRAD_TOL)
            np.testing.assert_allclose(mine.numpy(), np.asarray(oracle[i]),
                                       err_msg=name, **GRAD_TOL)
    if bias is not None:
        assert np.asarray(ref[3]).max() == 0 == np.asarray(ref[3]).min()
        assert grads[3].shape == leaves[3].shape
        assert torch.count_nonzero(grads[3]) == 0


def test_kernel_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, and launch
    nothing."""
    q, k, v, bias = _inputs(12, 21, "padding")
    tq_, tk_, tv_, tb_ = map(_t, (q, k, v, bias))
    do = _t(_rand(B, H, 12, D, seed=4))
    before = (fa.flash_fwd_launches, fa.flash_dq_launches,
              fa.flash_dkv_launches)
    out, lse = fa.flash_forward(tq_, tk_, tv_, tb_, None, True)
    ref_out, ref_lse = fa.flash_forward_ref(tq_, tk_, tv_, tb_, None, True)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    delta = (do * out).sum(-1, keepdim=True)
    dq = fa.flash_dq(tq_, tk_, tv_, tb_, do, lse, delta, None, True)
    dk, dv = fa.flash_dkv(tq_, tk_, tv_, tb_, do, lse, delta, None, True)
    for got, want in zip((dq, dk, dv), fa.flash_backward_ref(
            tq_, tk_, tv_, tb_, out, lse, do, None, True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (fa.flash_fwd_launches, fa.flash_dq_launches,
            fa.flash_dkv_launches) == before


@pytest.mark.parametrize("bias,b,t_k,ok", [
    (None, 2, 8, True), ((2, 1, 1, 8), 2, 8, True), ((1, 1, 1, 8), 2, 8, True),
    ((2, 8), 2, 8, True), ((1, 8), 2, 8, True), ((2, 1, 4, 8), 2, 8, False),
    ((2, 1, 1, 7), 2, 8, False), ((3, 8), 2, 8, False), ((8,), 2, 8, False)])
def test_bias_supported_matches_reference(bias, b, t_k, ok):
    arr = None if bias is None else np.zeros(bias, np.float32)
    assert pf.bias_supported(_jnp(arr), b, t_k) is ok
    assert fa.bias_supported(_t(arr), b, t_k) is ok


# -- the ring_attention op ----------------------------------------------------

T_OP = 10


def _op_run(pkg, feeds, flash, causal, bias_shape):
    """Build ``loss = reduce_sum(ring_attention(q, k, v) · w)`` with q, k, v
    differentiable; return Out and d loss / d q, k, v."""
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup), pkg.unique_name.guard():
        layers = pkg.layers
        v = {n: layers.data(n, shape=list(a.shape), dtype="float32",
                            append_batch_size=False,
                            stop_gradient=n == "bias")
             for n, a in feeds.items()}
        out = layers.ring_attention(v["q"], v["k"], v["v"], causal=causal,
                                    scale=0.3, bias=v.get("bias"),
                                    flash=flash)
        weight = layers.assign(_rand(*out.shape, seed=9))
        loss = layers.reduce_sum(layers.elementwise_mul(out, weight))
        pkg.backward.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(t) for t in exe.run(
        prog, feed=dict(feeds),
        fetch_list=[out, "q@GRAD", "k@GRAD", "v@GRAD"], scope=pkg.Scope())]


@pytest.mark.parametrize("flash,causal,bias_shape", [
    (True, False, (B, 1, 1, T_OP)), (True, True, None),
    (False, False, (B, 1, 1, T_OP)), (False, True, None),
    (True, False, (B, 1, T_OP, T_OP))],
    ids=["flash-padding", "flash-causal", "full-padding", "full-causal",
         "flash-unsupported-bias"])
def test_ring_attention_op_matches_reference(flash, causal, bias_shape):
    feeds = {"q": _rand(B, H, T_OP, D, seed=1),
             "k": _rand(B, H, T_OP, D, seed=2),
             "v": _rand(B, H, T_OP, D, seed=3)}
    if bias_shape is not None:
        bias = np.zeros(bias_shape, np.float32)
        bias[..., -2:] = -1e9
        if len(bias_shape) == 4 and bias_shape[2] > 1:
            bias += _rand(*bias_shape, seed=6)  # not a key-padding bias
        feeds["bias"] = bias
    ref_framework.fresh_session()
    ref = _op_run(rf, feeds, flash, causal, bias_shape)
    port = _op_run(tf, feeds, flash, causal, bias_shape)
    for name, r, p in zip(("Out", "dq", "dk", "dv"), ref, port):
        assert p.shape == r.shape, name
        np.testing.assert_allclose(p, r, err_msg=name, **GRAD_TOL)


def test_ring_attention_op_routes_by_attr_and_bias(monkeypatch):
    """flash 1 with a key-padding bias takes the FlashAttention function;
    flash 0, or a bias the kernels do not take, the full attention."""
    calls = []
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: calls.append("flash") or a[0])
    monkeypatch.setattr(fa, "full_attention",
                        lambda *a, **kw: calls.append("full") or a[0])
    from paddle_tpu_torch.ops.registry import ExecContext

    q = torch.zeros(B, H, 4, D)
    pad = torch.zeros(B, 1, 1, 4)
    full_bias = torch.zeros(B, 1, 4, 4)
    for flash, bias in ((1, pad), (1, None), (0, pad), (1, full_bias),
                        (-1, pad)):
        inputs = {"Q": [q], "K": [q], "V": [q]}
        if bias is not None:
            inputs["Bias"] = [bias]
        attention_ops.ring_attention_op(ExecContext(
            "ring_attention", inputs, {"Out": ["o"]},
            {"flash": flash, "causal": False, "scale": 0.0,
             "sp_axis": "sp"}, torch.device("cpu")))
    # auto (-1) on CPU tensors is the full attention
    assert calls == ["flash", "flash", "full", "full", "full"]


def test_ring_attention_op_refuses_a_process_group(monkeypatch):
    from paddle_tpu_torch.ops.registry import ExecContext

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    q = torch.zeros(1, 1, 4, D)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        attention_ops.ring_attention_op(ExecContext(
            "ring_attention", {"Q": [q], "K": [q], "V": [q]},
            {"Out": ["o"]}, {"flash": 1, "sp_axis": "sp"},
            torch.device("cpu")))


def test_flash_decision_precedence(monkeypatch):
    """The attr wins; auto follows the tensors' device at run time and
    torch's CUDA availability at build time; PADDLE_TPU_FLASH is not
    read."""
    decide = attention_ops._flash_decision
    monkeypatch.setenv("PADDLE_TPU_FLASH", "1")
    assert decide(0) is False and decide(0, "cuda") is False
    monkeypatch.setenv("PADDLE_TPU_FLASH", "0")
    assert decide(1) is True and decide(1, "cpu") is True
    monkeypatch.delenv("PADDLE_TPU_FLASH")
    assert decide(-1, "cpu") is False
    assert decide(-1, torch.device("cuda", 0)) is True
    for avail in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda a=avail: a)
        assert decide(-1) is avail
        assert decide() is avail


# -- the whole slice ----------------------------------------------------------

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


PATHS = {"flash": dict(flash_attention=True),
         "ring": dict(ring_attention=True)}


def _build(pkg, tm, path, dropout=0.1):
    cfg = tm.tiny_config()
    for field, value in PATHS[path].items():
        setattr(cfg, field, value)
    cfg.dropout = dropout
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


@pytest.mark.parametrize("path", sorted(PATHS))
def test_same_flash_training_program(path):
    ref_framework.fresh_session()
    rmain, rstart, rcost = _build(rf, ref_tm, path)
    pmain, pstart, pcost = _build(tf, port_tm, path)
    assert pcost.name == rcost.name
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    ring = [op for op in pmain.global_block().ops
            if op.type == "ring_attention"]
    assert len(ring) == 6  # 2 encoder self, 2 decoder self, 2 cross
    assert sum(op.attr("causal") for op in ring) == 2
    assert {op.attr("flash") for op in ring} == (
        {1} if path == "flash" else {-1})
    # no unfused attention left: no softmax op outside the loss
    assert "softmax" not in {op.type for op in pmain.global_block().ops}


def _feed():
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (4, L)),
            "tgt_word": rng.integers(1, 1000, (4, L)),
            "lbl_word": rng.integers(1, 1000, (4, L, 1))}
    feed["src_word"][0, -2:] = 0  # padding: the kernels' bias path
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_flash_training_matches_reference(path):
    """5 Adam steps from the JAX package's initial scope (dropout 0): the
    JAX package runs the Pallas kernels in interpret mode (flash) or its
    full attention (ring, single-device); the port the plain versions or
    its full attention.  Step-0 grads of every parameter and the losses
    agree."""
    ref_framework.fresh_session()
    runs, init = [], None
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        main, startup, cost = _build(pkg, tm, path, dropout=0.0)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        persist = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:
            init = {n: np.array(scope.get(n)) for n in persist}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        params = sorted(p.name for p in main.global_block().all_parameters()
                        if p.trainable)
        out = [[np.asarray(v) for v in exe.run(
            main, feed=_feed(),
            fetch_list=[cost] + ([p + "@GRAD" for p in params]
                                 if step == 0 else []), scope=scope)]
            for step in range(5)]
        runs.append((params, out))
    (rparams, ref), (pparams, port) = runs
    assert pparams == rparams
    for name, r, p in zip(rparams, ref[0][1:], port[0][1:]):
        np.testing.assert_allclose(p, r, err_msg=name, **STEP0_TOL)
    ref_losses = np.array([s[0] for s in ref]).reshape(-1)
    port_losses = np.array([s[0] for s in port]).reshape(-1)
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
    assert port_losses[-1] < port_losses[0]
