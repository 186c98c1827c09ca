"""The MoE feed-forward and the fc stack of the port (``parallel/moe.py``,
``parallel/pipeline.py``, ``ops/moe_ops.py``, ``ops/pipeline_ops.py``)
against the JAX package, on the CPU, from numpy-seeded inputs:

 - the routing by indices against ``top_k_gating``'s dense combine and
   dispatch tensors, at several (N, E, k, capacity factor): with overflow
   drops, top_k = 1, and an exact tie of gate probabilities (the lower
   expert index first, as ``lax.top_k``); combine rtol 1e-6 (both take
   the same fp32 softmax), dispatch and the slot counts exact;
 - ``moe_ffn`` itself: out and aux loss, and the grads of every input
   against ``jax.vjp`` with cotangents on both outputs (rtol 1e-5 / atol
   1e-6 on out, 1e-4 / 1e-5 on grads: fp32 products summed in another
   order), relu and gelu, with and without drops;
 - the ``moe_ffn`` and ``gpipe_mlp_stack`` ops through each package's
   Executor from one scope: outputs and input grads; the op's generic
   grad re-runs the forward with no outputs requested, so ``moe_ffn``
   returns no ``AuxLoss`` there and the aux loss's gradient is dropped in
   both packages (``ROADMAP.md`` queue 3, "Not port faults");
 - ``gpipe_mlp_stack`` against ``sequential_stack`` (relu, tanh, gelu:
   ``jax.nn.gelu``'s tanh approximation);
 - the layer functions' Programs (``dist_hint`` included), and
   ``moe_config()``'s Program and 5-step Adam trajectory from the JAX
   package's initial scope (dropout 0; rtol 1e-5 at step 0, 1e-4 after);
   ``fluid_benchmark.py``'s ``moe_transformer`` at Transformer-base widths
   builds the reference's Program;
 - both ops refuse a process group of more than one.
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
from paddle_tpu.parallel import moe as ref_moe
from paddle_tpu.parallel import pipeline as ref_pipeline
from paddle_tpu_torch.fluid import core as port_core
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models import transformer as port_tm
from paddle_tpu_torch.ops.registry import ExecContext
from paddle_tpu_torch.parallel import moe, pipeline

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = np.array([1e-5] + [1e-4] * 4)
L = 8


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _dense(r: moe.Routing, n, e):
    """The port's routing as the reference's [N, E, C] combine tensor."""
    combine = np.zeros((n, e * r.capacity + 1), np.float32)
    rows = np.repeat(np.arange(n), r.slot.shape[1])
    combine[rows, r.slot.numpy().reshape(-1)] = r.gate_vals.numpy().reshape(-1)
    return combine[:, :-1].reshape(n, e, r.capacity)


def _tie_inputs(n, d, e):
    """Experts 1 and 2 share a gate column: every token's probabilities of
    the two are exactly equal."""
    x = _rand(n, d, seed=1)
    gate_w = _rand(d, e, seed=2)
    gate_w[:, 1] += 0.5 * np.abs(gate_w[:, 0]).max()  # pick them often
    gate_w[:, 2] = gate_w[:, 1]
    return x, gate_w


# (N, E, k, capacity factor, inputs)
GATING_CASES = [(32, 4, 2, 4.0, "rand"), (48, 4, 2, 0.5, "rand"),
                (40, 8, 1, 1.0, "rand"), (30, 5, 3, 0.75, "rand"),
                (24, 4, 2, 1.0, "tie"), (24, 4, 1, 2.0, "tie")]


@pytest.mark.parametrize("n,e,k,cf,kind", GATING_CASES,
                         ids=[f"n{c[0]}-e{c[1]}-k{c[2]}-cf{c[3]}-{c[4]}"
                              for c in GATING_CASES])
def test_top_k_gating_matches_reference(n, e, k, cf, kind):
    d = 6
    if kind == "tie":
        x, gate_w = _tie_inputs(n, d, e)
    else:
        x, gate_w = _rand(n, d, seed=1), _rand(d, e, seed=2, scale=2.0)
    combine, dispatch, aux = ref_moe.top_k_gating(
        jnp.asarray(x), jnp.asarray(gate_w), k, cf)
    r = moe.route(torch.from_numpy(x), torch.from_numpy(gate_w), k, cf)
    cap = ref_moe.moe_capacity(n, e, k, cf)
    assert r.capacity == moe.moe_capacity(n, e, k, cf) == cap
    got = _dense(r, n, e)
    np.testing.assert_array_equal(got > 0, np.asarray(dispatch) > 0)
    np.testing.assert_allclose(got, np.asarray(combine), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(r.aux_loss), float(aux), rtol=1e-6)
    np.testing.assert_array_equal(r.kept.numpy(),
                                  np.asarray(dispatch).sum(axis=(0, 2)))
    if cf < 1.0:  # overflow: some choice was dropped
        assert int(r.kept.sum()) < n * k
    # the chosen experts in ``lax.top_k``'s order
    ref_probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(gate_w), -1)
    np.testing.assert_array_equal(
        r.gate_idx.numpy(), np.asarray(jax.lax.top_k(ref_probs, k)[1]))
    if kind == "tie":
        probs, idx = r.probs.numpy(), r.gate_idx.numpy()
        assert (probs[:, 1] == probs[:, 2]).all()
        # the tie decides: expert 1 is chosen, or ranks before 2
        assert (idx[:, 0] == 1).sum() > 0 and (idx[:, 0] != 2).all()


def _moe_inputs(n, d, e, h, seed=0):
    return [_rand(n, d, seed=seed + 1), _rand(d, e, seed=seed + 2),
            _rand(e, d, h, seed=seed + 3, scale=0.3),
            _rand(e, h, seed=seed + 4, scale=0.1),
            _rand(e, h, d, seed=seed + 5, scale=0.3),
            _rand(e, d, seed=seed + 6, scale=0.1)]


@pytest.mark.parametrize("act,cf", [("relu", 1.25), ("gelu", 0.5),
                                    ("relu", 4.0)])
def test_moe_ffn_matches_reference_vjp(act, cf):
    n, d, e, h, k = 40, 8, 4, 16, 2
    args = _moe_inputs(n, d, e, h)
    dy, daux = _rand(2, n // 2, d, seed=9), np.float32(0.7)
    x3 = args[0].reshape(2, n // 2, d)  # [..., D]: leading dims flatten

    def ref_fn(*a):
        return ref_moe.moe_ffn(*a, top_k=k, capacity_factor=cf,
                               activation=act)

    (ref_y, ref_aux), vjp = jax.vjp(
        ref_fn, jnp.asarray(x3), *map(jnp.asarray, args[1:]))
    ref_grads = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in [x3] + args[1:]]
    y, aux = moe.moe_ffn(*leaves, top_k=k, capacity_factor=cf,
                         activation=act)
    assert y.shape == (2, n // 2, d) and aux.shape == ()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux),
                               rtol=1e-6)
    grads = torch.autograd.grad((y, aux), leaves,
                                (torch.from_numpy(dy), torch.tensor(daux)))
    for name, g, rg in zip(("x", "gate_w", "w1", "b1", "w2", "b2"), grads,
                           ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), err_msg=name,
                                   **GRAD_TOL)
    # the gate takes a gradient through the aux loss alone too
    g_gate = torch.autograd.grad(moe.moe_ffn(*leaves, top_k=k,
                                             capacity_factor=cf)[1],
                                 leaves[1])[0]
    assert torch.count_nonzero(g_gate) > 0


def test_dropped_tokens_output_zero():
    """All 16 tokens pick expert 0; capacity 8 keeps the first 8 in order,
    the other 8 output exactly 0."""
    x = np.ones((16, 4), np.float32)
    gate_w = np.zeros((4, 2), np.float32)
    gate_w[:, 0] = 10.0
    w = _moe_inputs(16, 4, 2, 8)[2:]
    r = moe.route(torch.from_numpy(x), torch.from_numpy(gate_w), 1, 1.0)
    assert r.kept.tolist() == [8, 0]
    np.testing.assert_array_equal(r.slot[:, 0].numpy(),
                                  list(range(8)) + [16] * 8)
    y, _ = moe.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate_w),
                       *map(torch.from_numpy, w), top_k=1,
                       capacity_factor=1.0)
    assert torch.count_nonzero(y[8:]) == 0 and torch.count_nonzero(y[:8]) > 0


def _op_program(pkg, op, d):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[d], dtype="float32",
                            stop_gradient=False)
        if op == "moe":
            out, aux = pkg.layers.moe_ffn(x, num_experts=4, hidden_size=12,
                                          capacity_factor=0.75)
            loss = pkg.layers.elementwise_add(
                pkg.layers.reduce_sum(pkg.layers.elementwise_mul(
                    out, pkg.layers.assign(_rand(16, d, seed=8)))),
                pkg.layers.scale(aux, scale=0.5))
            fetch = [out, aux]
        else:
            out = pkg.layers.gpipe_mlp_stack(x, n_layers=3, act=op)
            loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(
                out, pkg.layers.assign(_rand(16, d, seed=8))))
            fetch = [out]
        params = pkg.backward.append_backward(loss)
    return main, startup, fetch, sorted(p.name for p, _ in params)


@pytest.mark.parametrize("op", ["moe", "relu", "tanh", "gelu"])
def test_op_matches_reference(op):
    """Each package's Executor from the JAX package's initial scope: the
    op's outputs and the grads of x and every parameter."""
    d = 8
    feed = {"x": _rand(16, d, seed=3)}
    runs, init = [], None
    for pkg in (rf, tf):
        main, startup, fetch, params = _op_program(pkg, op, d)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: np.array(scope.get(n)) for n in params}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        runs.append([np.asarray(v) for v in exe.run(
            main, feed=feed, scope=scope,
            fetch_list=fetch + ["x@GRAD"] + [p + "@GRAD" for p in params])])
    for i, (r, p) in enumerate(zip(*runs)):
        assert p.shape == r.shape, i
        np.testing.assert_allclose(p, r, err_msg=str(i), **GRAD_TOL)


def test_op_aux_loss_takes_no_gradient_in_either_package():
    """The generic grad re-runs ``moe_ffn`` with no outputs requested, so
    the op skips ``AuxLoss`` and its cotangent is dropped: a loss that adds
    the aux loss gives the gate the same gradient as one without it, in
    the reference and, by the same IR, in the port."""
    for pkg in (rf, tf):
        grads = []
        for with_aux in (False, True):
            main, startup = pkg.Program(), pkg.Program()
            main.random_seed = startup.random_seed = 5
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                x = pkg.layers.data("x", shape=[8], dtype="float32")
                out, aux = pkg.layers.moe_ffn(x, num_experts=4,
                                              hidden_size=16)
                loss = pkg.layers.mean(out)
                if with_aux:
                    loss = pkg.layers.elementwise_add(
                        loss, pkg.layers.scale(aux, scale=10.0))
                pkg.backward.append_backward(loss)
            exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
            exe.run(startup, scope=scope)
            grads.append(np.asarray(exe.run(
                main, feed={"x": _rand(16, 8, seed=0)}, scope=scope,
                fetch_list=["moe_ffn_0.w_0@GRAD"])[0]))
        assert np.abs(grads[0]).sum() > 0
        np.testing.assert_array_equal(grads[0], grads[1])


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
def test_gpipe_stack_matches_sequential_stack(act):
    w, b, x = (_rand(3, 8, 8, seed=1, scale=0.4), _rand(3, 8, seed=2),
               _rand(10, 8, seed=3))
    dy = _rand(10, 8, seed=4)
    ref, vjp = jax.vjp(lambda *a: ref_pipeline.sequential_stack(*a, act),
                       jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (w, b, x)]
    got = pipeline.sequential_stack(*leaves, act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **OUT_TOL)
    stage = pipeline.mlp_stage_fn(act)((leaves[0], leaves[1]), leaves[2])
    assert torch.equal(stage, got)
    for g, rg in zip(torch.autograd.grad(got, leaves, torch.from_numpy(dy)),
                     vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GRAD_TOL)
    with pytest.raises(ValueError, match="unsupported"):
        pipeline._apply_act(got, "swish")


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
                     getattr(v, "dist_hint", None),
                     getattr(v, "dist_spec", None))
            for v in prog.global_block().vars.values()}


@pytest.mark.parametrize("op", ["moe", "relu"])
def test_layers_give_the_reference_program(op):
    built = [_op_program(pkg, op, 8) for pkg in (rf, tf)]
    (rmain, rstart, _, rparams), (pmain, pstart, _, pparams) = built
    assert pparams == rparams
    for rp, pp in ((rstart, pstart), (rmain, pmain)):
        assert _ops(pp) == _ops(rp)
        assert _vars(pp, port_core) == _vars(rp, ref_core)
    hints = {v.name: getattr(v, "dist_hint", None)
             for v in pmain.global_block().all_parameters()}
    if op == "moe":  # the expert weights, not the gate
        assert sorted(h for h in hints.values() if h) == ["ep"] * 4
        with tf.program_guard(tf.Program(), tf.Program()):
            x = tf.layers.data("x", shape=[8], dtype="float32")
            with pytest.raises(ValueError, match="top_k"):
                tf.layers.moe_ffn(x, num_experts=2, hidden_size=4, top_k=3)
    else:
        assert sorted(hints.values()) == ["pp", "pp"]


def _build_tm(pkg, tm, cfg_fn, dropout, seq=L, **fields):
    cfg = cfg_fn()
    cfg.flash_attention = False
    cfg.dropout = dropout
    for k, v in fields.items():
        setattr(cfg, k, v)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=seq, tgt_len=seq)
    return main, startup, cost


def test_moe_transformer_programs_match_reference():
    """``moe_config()`` and ``fluid_benchmark.py``'s ``moe_transformer``
    (Transformer-base, 8 experts, length 256): the same Programs; 12 MoE
    layers whose aux losses join the cost."""
    def bench_cfg(tm):
        def make():
            cfg = tm.base_config()
            cfg.name, cfg.moe_experts = "moe_base", 8
            return cfg
        return make

    for cfgs, seq in (((ref_tm.moe_config, port_tm.moe_config), L),
                      ((bench_cfg(ref_tm), bench_cfg(port_tm)), 256)):
        ref_framework.fresh_session()
        port_framework.fresh_session()
        rmain, rstart, rcost = _build_tm(rf, ref_tm, cfgs[0], 0.1, seq)
        pmain, pstart, pcost = _build_tm(tf, port_tm, cfgs[1], 0.1, seq)
        assert pcost.name == rcost.name
        for rp, pp in ((rstart, pstart), (rmain, pmain)):
            assert _ops(pp) == _ops(rp)
            assert _vars(pp, port_core) == _vars(rp, ref_core)
        types = [op.type for op in pmain.global_block().ops]
        n_layer = port_tm.moe_config().n_layer if seq == L else 6
        assert types.count("moe_ffn") == 2 * n_layer
        assert types.count("moe_ffn_grad") == 2 * n_layer


def _feed():
    rng = np.random.default_rng(0)
    feed = {"src_word": rng.integers(1, 1000, (4, L)),
            "tgt_word": rng.integers(1, 1000, (4, L)),
            "lbl_word": rng.integers(1, 1000, (4, L, 1))}
    feed["src_word"][0, -2:] = 0
    feed["lbl_word"][1, -3:] = 0
    return {k: v.astype(np.int64) for k, v in feed.items()}


def test_moe_config_training_matches_reference():
    """5 Adam steps of ``moe_config()`` from the JAX package's initial
    scope, dropout 0: the losses (the aux losses inside) within rtol 1e-5
    at step 0 and 1e-4 after."""
    runs, init = [], None
    for pkg, tm in ((rf, ref_tm), (tf, port_tm)):
        main, startup, cost = _build_tm(pkg, tm, tm.moe_config, 0.0)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: np.array(scope.get(v.name))
                    for v in startup.list_vars() if v.persistable}
        else:
            port_tm.load_reference_params(scope, init, tf.CPUPlace())
        runs.append(np.array([float(np.asarray(exe.run(
            main, feed=_feed(), fetch_list=[cost], scope=scope)[0])
            .reshape(-1)[0]) for _ in range(5)]))
    ref, port = runs
    rel = np.abs(port - ref) / np.abs(ref)
    assert (rel <= LOSS_RTOL).all(), (port, ref, rel)
    assert port[-1] < port[0]


@pytest.mark.parametrize("op_type", ["moe_ffn", "gpipe_mlp_stack"])
def test_ops_refuse_a_process_group(monkeypatch, op_type):
    from paddle_tpu_torch.ops.registry import REGISTRY

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    x = torch.zeros(4, 8)
    inputs = {"X": [x], "W": [torch.zeros(2, 8, 8)], "B": [torch.zeros(2, 8)],
              "GateW": [torch.zeros(8, 2)], "W1": [torch.zeros(2, 8, 4)],
              "B1": [torch.zeros(2, 4)], "W2": [torch.zeros(2, 4, 8)],
              "B2": [torch.zeros(2, 8)]}
    with pytest.raises(NotImplementedError, match="item 12b"):
        REGISTRY[op_type].fn(ExecContext(op_type, inputs, {"Out": ["o"]},
                                         {}, torch.device("cpu")))
