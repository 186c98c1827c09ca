"""The transformer layer stacks of the port (``parallel/transformer_stack.py``,
``ops/transformer_ops.py``, ``layers.transformer_{encoder,decoder}_stack``)
against the JAX package, on the CPU, from numpy-seeded inputs:

 - ``stack_apply`` of a 2-layer encoder and decoder (d 16, 2 heads, batch
   2, lengths 6 and 5), dropout 0: out, and the grads of x, the encoder
   output and every stacked parameter against ``jax.vjp`` of the
   reference's (no mesh), with the bias None and a padding bias; flash
   off (the full attention) and on (the reference's Pallas flash kernels
   in interpret mode, as ``tests/test_torch_flash.py`` runs them; the
   port's plain versions).  Out rtol 2e-5 / atol 2e-5, grads rtol 1e-4 /
   atol 1e-5, the flash tests' tolerances: fp32 sums in another order;
 - ``recompute=True`` bitwise ``recompute=False``, out and grads, with
   dropout on;
 - dropout > 0 through the Executor: the op emits its keep masks under
   ``RngKey`` (kept share within 5 standard errors of 1 - p), Out is the
   stack over those masks bitwise, and the grad op's grads are bitwise
   autograd's over the same masks (the grad sees the forward's masks),
   with and without recompute; a ``run_steps`` window is bitwise the
   per-step path; ``is_test`` scales by 1 - p and draws nothing;
 - the layer functions' Programs, ``dist_spec`` included, and the tiny
   stacked Transformer's Program and 5-step Adam trajectory from the JAX
   package's initial scope (dropout 0; rtol 1e-5 at step 0, 1e-4 after);
 - ``clone(for_test=True)`` flips ``is_test`` on ``dropout`` only: the
   stack ops keep ``is_test=False`` in both packages, so dropout stays on
   in a stacked model's eval (``ROADMAP.md`` queue 3, "Not port faults");
 - both ops refuse a process group of more than one.
The tiny stacked BERT is held in ``tests/test_torch_bert.py``.
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
from paddle_tpu.parallel import transformer_stack as ref_ts
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.ops.registry import REGISTRY, ExecContext
from paddle_tpu_torch.parallel import transformer_stack as ts

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = np.array([1e-5] + [1e-4] * 4)
B, T, TS, D, DI, H, NL = 2, 6, 5, 16, 32, 2, 2
L = 8


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _params(decoder, seed=10):
    table = ts.DECODER_SLOTS if decoder else ts.ENCODER_SLOTS
    shapes = {"FFN1W": (NL, D, DI), "FFN1B": (NL, DI), "FFN2W": (NL, DI, D)}
    out = {}
    for i, slot in enumerate(sorted(table)):
        shape = shapes.get(slot, (NL, D) if slot.startswith("LN")
                           or slot.endswith("B") else (NL, D, D))
        p = _rand(*shape, seed=seed + i, scale=0.3)
        if slot.startswith("LN") and slot.endswith("S"):
            p += 1.0
        out[slot] = p
    return out


def _inputs(kind, padded):
    decoder = kind == "dec"
    x = _rand(B, T, D, seed=1)
    enc = _rand(B, TS, D, seed=2) if decoder else None
    t_k = TS if decoder else T
    bias = None
    if padded:
        bias = np.zeros((B, 1, 1, t_k), np.float32)
        bias[0, ..., -2:] = -1e9
    return x, enc, bias, _params(decoder)


CASES = [(kind, padded, flash) for flash in (False, True)
         for kind in ("enc", "dec") for padded in (False, True)
         if not flash or padded]


@pytest.mark.parametrize("kind,padded,flash", CASES,
                         ids=[f"{k}-{'padded' if p else 'nobias'}-"
                              f"{'flash' if f else 'full'}"
                              for k, p, f in CASES])
def test_stack_apply_matches_reference_vjp(kind, padded, flash):
    x, enc, bias, params = _inputs(kind, padded)
    dy = _rand(B, T, D, seed=3)
    names = sorted(params)
    decoder = kind == "dec"

    def ref_fn(xx, ee, *ps):
        return ref_ts.stack_apply(
            kind, xx, ee, None if bias is None else jnp.asarray(bias),
            dict(zip(names, ps)), jnp.zeros((2,), jnp.uint32), n_head=H,
            dropout=0.0, is_test=False, n_micro=4, mesh=None, flash=flash)

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(x),
                       jnp.asarray(enc) if decoder else None,
                       *[jnp.asarray(params[n]) for n in names])
    ref_grads = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in [x] + ([enc] if decoder else [])
              + [params[n] for n in names]]
    xl, el = leaves[0], (leaves[1] if decoder else None)
    pl = dict(zip(names, leaves[1 + decoder:]))
    out = ts.stack_apply(kind, xl, el,
                         None if bias is None else torch.from_numpy(bias),
                         pl, None, n_head=H, dropout=0.0, is_test=False,
                         flash=flash)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **OUT_TOL)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    want = [ref_grads[0]] + ([ref_grads[1]] if decoder else []) \
        + list(ref_grads[2:])
    for name, g, rg in zip(["x"] + ["enc"] * decoder + names, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), err_msg=name,
                                   **GRAD_TOL)


def test_flash_takes_the_flash_function_only_for_a_key_bias(monkeypatch):
    calls = []
    real = ts.FlashAttention.apply
    monkeypatch.setattr(ts.FlashAttention, "apply",
                        lambda *a: calls.append(a[3] is None) or real(*a))
    x, enc, bias, params = _inputs("dec", True)
    ts.stack_apply("dec", torch.from_numpy(x), torch.from_numpy(enc),
                   torch.from_numpy(bias),
                   {k: torch.from_numpy(v) for k, v in params.items()},
                   None, n_head=H, dropout=0.0, is_test=False, flash=True)
    # a causal self-attention (no bias) and a padded cross-attention a layer
    assert calls == [True, False] * NL
    calls.clear()
    ts.stack_apply("enc", torch.from_numpy(x), None,
                   torch.zeros(B, 1, T, T),  # not a key-padding bias
                   {k: torch.from_numpy(v) for k, v in
                    _params(False).items()},
                   None, n_head=H, dropout=0.0, is_test=False, flash=True)
    assert calls == []


def _masks(decoder, seed=0, rate=0.3):
    gen = torch.Generator().manual_seed(seed)
    return ts.draw_masks(gen, NL, ts.DECODER_SITES if decoder
                         else ts.ENCODER_SITES, (B, T, D), rate,
                         torch.device("cpu"))


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_recompute_is_bitwise(kind):
    x, enc, bias, params = _inputs(kind, True)
    masks = _masks(kind == "dec")
    runs = []
    for recompute in (False, True):
        leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
                  for k, v in params.items()}
        xl = torch.from_numpy(x.copy()).requires_grad_()
        out = ts.stack_apply(kind, xl, None if enc is None
                             else torch.from_numpy(enc),
                             torch.from_numpy(bias), leaves, masks,
                             n_head=H, dropout=0.3, is_test=False,
                             recompute=recompute)
        grads = torch.autograd.grad(out.square().sum(),
                                    [xl] + list(leaves.values()))
        runs.append([out] + list(grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _stack_program(pkg, kind, dropout=0.3, recompute=False, is_test=False,
                   flash=False, bias=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        layers = pkg.layers
        x = layers.data("x", shape=[B, T, D], dtype="float32",
                        append_batch_size=False, stop_gradient=False)
        b = layers.data("bias", shape=[B, 1, 1, TS if kind == "dec" else T],
                        dtype="float32", append_batch_size=False)
        kw = dict(n_layer=NL, n_head=H, d_inner=DI, dropout=dropout,
                  is_test=is_test, recompute=recompute, flash=flash)
        if kind == "dec":
            e = layers.data("enc", shape=[B, TS, D], dtype="float32",
                            append_batch_size=False, stop_gradient=False)
            out = layers.transformer_decoder_stack(
                x, e, src_bias=b if bias else None, **kw)
        else:
            out = layers.transformer_encoder_stack(
                x, bias=b if bias else None, **kw)
        loss = layers.reduce_sum(layers.elementwise_mul(
            out, layers.assign(_rand(B, T, D, seed=4))))
        pkg.backward.append_backward(loss)
    op = next(o for o in main.global_block().ops if o.type.endswith("stack"))
    return main, startup, out, op


def _feed(kind):
    x, enc, bias, _ = _inputs(kind, True)
    feed = {"x": x, "bias": bias}
    if kind == "dec":
        feed["enc"] = enc
    return feed


@pytest.mark.parametrize("kind,recompute", [("enc", False), ("dec", False),
                                            ("dec", True)])
def test_grad_sees_the_forward_masks(kind, recompute):
    """One Executor step at dropout 0.3: the RngKey output holds the keep
    masks; Out and every grad are bitwise the stack's over them."""
    main, startup, out, op = _stack_program(tf, kind, recompute=recompute)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    params = {slot: op.input(slot)[0] for slot in (
        ts.DECODER_SLOTS if kind == "dec" else ts.ENCODER_SLOTS)}
    fetch = [out.name, op.output("RngKey")[0], "x@GRAD"] + \
        [params[s] + "@GRAD" for s in sorted(params)]
    if kind == "dec":
        fetch.append("enc@GRAD")
    feed = _feed(kind)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    masks = got[1]
    sites = ts.DECODER_SITES if kind == "dec" else ts.ENCODER_SITES
    assert masks.dtype == torch.bool and masks.shape == (NL, sites, B, T, D)
    kept, n = float(masks.float().mean()), masks.numel()
    assert abs(kept - 0.7) <= 5 * (0.21 / n) ** 0.5
    leaves = {s: scope.get(params[s]).detach().clone().requires_grad_()
              for s in sorted(params)}
    xl = torch.from_numpy(feed["x"]).requires_grad_()
    el = torch.from_numpy(feed["enc"]).requires_grad_() \
        if kind == "dec" else None
    want = ts.stack_apply(kind, xl, el, torch.from_numpy(feed["bias"]),
                          leaves, masks, n_head=H, dropout=0.3,
                          is_test=False, recompute=recompute)
    assert torch.equal(got[0], want)
    grads = torch.autograd.grad(
        want, [xl] + list(leaves.values()) + ([el] if el is not None
                                              else []),
        torch.from_numpy(_rand(B, T, D, seed=4)))
    for name, a, b in zip(fetch[2:], got[2:], grads):
        assert torch.equal(a, b), name
    # a second step draws new masks
    again = exe.run(main, feed=feed, fetch_list=[fetch[1]], scope=scope,
                    return_numpy=False)[0]
    assert not torch.equal(again, masks)


def test_window_is_bitwise_the_per_step_path():
    """Three steps as one ``run_steps`` window and three ``run`` calls from
    the same seed: the fetched grads bitwise (the same draws, the grads
    over the same masks)."""
    main, startup, out, op = _stack_program(tf, "enc")
    fetch = ["x@GRAD", op.input("WQ")[0] + "@GRAD"]
    runs = []
    for window in (False, True):
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(startup, scope=scope)
        if window:
            runs.append(exe.run_steps(main, feed=_feed("enc"),
                                      fetch_list=fetch, n_steps=3,
                                      scope=scope))
        else:
            for _ in range(3):
                last = exe.run(main, feed=_feed("enc"), fetch_list=fetch,
                               scope=scope)
            runs.append(last)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_is_test_scales_and_draws_nothing():
    main, startup, out, op = _stack_program(tf, "enc", is_test=True)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    got, key = exe.run(main, feed=_feed("enc"), scope=scope,
                       fetch_list=[out.name, op.output("RngKey")[0]])
    np.testing.assert_array_equal(key, np.zeros(2, np.int32))
    params = {s: scope.get(op.input(s)[0]) for s in ts.ENCODER_SLOTS}
    want = ts.stack_apply("enc", torch.from_numpy(_feed("enc")["x"]), None,
                          torch.from_numpy(_feed("enc")["bias"]), params,
                          None, n_head=H, dropout=0.3, is_test=True)
    np.testing.assert_array_equal(got, want.numpy())


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
                     core.convert_dtype(v.dtype), bool(v.persistable),
                     getattr(v, "dist_spec", None))
            for v in prog.global_block().vars.values()}


@pytest.mark.parametrize("kind,flash,recompute,bias", [
    ("enc", False, False, True), ("enc", None, True, False),
    ("dec", True, False, True), ("dec", None, False, False)])
def test_layers_give_the_reference_program(kind, flash, recompute, bias):
    (rmain, rstart, _, _), (pmain, pstart, _, pop) = [
        _stack_program(pkg, kind, recompute=recompute, flash=flash,
                       bias=bias) for pkg in (rf, tf)]
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    specs = {slot: pmain.global_block().var(pop.input(slot)[0]).dist_spec
             for slot in (ts.DECODER_SLOTS if kind == "dec"
                          else ts.ENCODER_SLOTS)}
    assert specs["WQ"] == ("pp", None, "mp") and specs["WO"] == \
        ("pp", "mp", None) and specs["LN1S"] == ("pp", None)
    for slot, spec in specs.items():
        assert spec == ref_ts.dist_spec_for(slot, len(spec), kind == "dec")


def _build_tm(pkg, tm, dropout, **fields):
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    cfg.dropout = dropout
    cfg.stacked = True
    for k, v in fields.items():
        setattr(cfg, k, v)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


@pytest.mark.parametrize("fields", [{}, {"flash_attention": True,
                                         "recompute": True}])
def test_stacked_transformer_program_matches_reference(fields):
    rmain, rstart, rcost = _build_tm(rf, ref_tm, 0.1, **fields)
    pmain, pstart, pcost = _build_tm(tf, port_tm, 0.1, **fields)
    assert pcost.name == rcost.name
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    types = [op.type for op in pmain.global_block().ops]
    for t in ("transformer_encoder_stack", "transformer_decoder_stack"):
        assert types.count(t) == types.count(t + "_grad") == 1
    assert "ring_attention" not in types and "softmax" not in types


def _tm_feed():
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (4, L)),
            "tgt_word": rng.integers(1, 1000, (4, L)),
            "lbl_word": rng.integers(1, 1000, (4, L, 1))}
    feed["src_word"][0, -2:] = 0
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


def test_stacked_transformer_training_matches_reference():
    """5 Adam steps of the tiny stacked Transformer from the JAX package's
    initial scope, dropout 0."""
    runs, init = [], None
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        main, startup, cost = _build_tm(pkg, tm, 0.0)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        runs.append(np.array([float(np.asarray(exe.run(
            main, feed=_tm_feed(), fetch_list=[cost], scope=scope)[0])
            .reshape(-1)[0]) for _ in range(5)]))
    ref, port = runs
    rel = np.abs(port - ref) / np.abs(ref)
    assert (rel <= LOSS_RTOL).all(), (port, ref, rel)
    assert port[-1] < port[0]


def test_test_clone_keeps_stack_dropout_in_both_packages():
    """``clone(for_test=True)`` sets ``is_test`` on ``dropout`` and
    ``batch_norm`` only, in the reference and in the port: a stacked
    model's stack ops keep ``is_test=False`` (its residual dropout stays
    on in eval), the embeddings' dropout ops turn to ``is_test``."""
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        main, _, _ = _build_tm(pkg, tm, 0.1)
        test = main.clone(for_test=True)
        by_type = {}
        for op in test.global_block().ops:
            by_type.setdefault(op.type, []).append(op.attr("is_test"))
        assert by_type["transformer_encoder_stack"] == [False]
        assert by_type["transformer_decoder_stack"] == [False]
        assert by_type["dropout"] == [True, True]


@pytest.mark.parametrize("op_type", ["transformer_encoder_stack",
                                     "transformer_decoder_stack"])
def test_stack_ops_refuse_a_process_group(monkeypatch, op_type):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    x = torch.zeros(B, T, D)
    with pytest.raises(NotImplementedError, match="item 12b"):
        REGISTRY[op_type].fn(ExecContext(
            op_type, {"X": [x], "EncOut": [x]}, {"Out": ["o"]},
            {"n_head": H}, torch.device("cpu")))
