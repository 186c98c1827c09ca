"""``fluid.guardian`` of the port against the JAX package's, on the CPU.

One MLP (fc 8 relu, fc 1, squared error, Adam) in both packages, started
from the reference's initialized scope copied into the port, fed the same
numpy-seeded batches, with the same guardian (skip, spike factor 5 over a
window of 8) and the same faults: grad-Inf at step 2 (the backward seed
times inf, through the real grad ops) and a x1e4 loss spike at step 5 (the
first step with the 4 clean losses the spike cap needs):

 - the same ``HealthRecord`` for every step: step, ``finite``, ``ok`` and
   ``spike`` exact, loss and grad norm at rtol 1e-5 (NaN where the
   reference's is NaN); the same counters; the parameters at rtol 1e-5
   after every step;
 - within the port, a tripped step leaves every state tensor bitwise as
   it was;
 - a ``run_steps`` window's aggregate (``trip_idx``, ``bad_steps``, the
   worst loss and grad norm, the finite flags) equals the reference's;
 - the fp16 loss scaler under the guardian: the same finite flags and
   scales step by step, the same counters, losses at rtol 1e-3 (fp16
   products summed in another order);
 - ``halt`` raises ``NumericsTripped`` at the next boundary in both;
   ``dump_and_halt`` writes a bundle whose ``replay`` reproduces the loss
   bitwise on the CPU and names the first non-finite variable, for a
   step and for a window; the replay CLI exits 0; a trip appends one
   incident line; ``GuardianConfig.from_env`` reads the same contract.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import amp as ref_amp
from paddle_tpu.fluid import fault as ref_fault
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import guardian as ref_guardian
from paddle_tpu_torch.fluid import amp as port_amp
from paddle_tpu_torch.fluid import fault as port_fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import guardian as port_guardian
from paddle_tpu_torch.models.params import load_reference_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
FP16_LOSS_RTOL = 1e-3
PKGS = {"ref": (rf, ref_fault, ref_guardian, ref_amp),
        "port": (tf, port_fault, port_guardian, port_amp)}
GUARD = dict(spike_factor=5.0, spike_window=8)
PLAN = dict(grad_inf_step=2, loss_spike_step=5, mode="raise")
STEPS = 8


def _clear_all():
    for _, fault, guardian, amp in PKGS.values():
        fault.clear()
        guardian.disable()
        amp.disable()


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PADDLE_FAULT_", "PADDLE_TPU_GUARDIAN",
                         "PADDLE_ELASTIC_INCIDENTS")):
            monkeypatch.delenv(k)
    port_framework.fresh_session()
    ref_framework.fresh_session()
    _clear_all()
    yield
    _clear_all()


def _mlp(fluid, seed=7, fp16=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(size=(8, 4)).astype(np.float32),
            "y": rng.normal(size=(8, 1)).astype(np.float32)}


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable
                  and not v.name.startswith("@"))


def _setup(name, init=None, fp16=False):
    """(exe, main, loss, scope) of ``name``'s package, startup run, and
    the port's scope loaded with ``init`` (the reference's start)."""
    fluid = PKGS[name][0]
    main, startup, loss = _mlp(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    if init is not None and name == "port":
        load_reference_params(scope, init, tf.CPUPlace())
    return exe, main, loss, scope


def _reference_start():
    exe, main, _, scope = _setup("ref")
    return {n: np.array(scope.get(n)) for n in _persistables(main)}


def _state(scope, names):
    return {n: np.array(scope.find_var(n).get_tensor()) for n in names}


def _drive(name, init, steps=STEPS, window=None, policy="skip", **plan):
    fluid, fault, guardian, _ = PKGS[name]
    exe, main, loss, scope = _setup(name, init)
    g = guardian.enable(policy, **GUARD)
    fault.install(fault.FaultPlan(**dict(PLAN, **plan)))
    names = _persistables(main)
    states = []
    if window is None:
        for i in range(steps):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
            states.append(_state(scope, names))
    else:
        for i in range(steps // window):
            exe.run_steps(main, _feed(i), [loss], n_steps=window,
                          scope=scope)
            states.append(_state(scope, names))
    guardian.flush()
    return g, states


def _records(g):
    return [r.to_dict() for r in g.recorder.records()]


def _same_records(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for k in ("step", "finite", "ok", "spike"):
            assert p[k] == r[k], (k, p, r)
        np.testing.assert_allclose([p["loss"], p["grad_norm"], p["scale"]],
                                   [r["loss"], r["grad_norm"], r["scale"]],
                                   rtol=RTOL, equal_nan=True)


def test_records_counters_and_params_match_reference():
    init = _reference_start()
    ref_g, ref_states = _drive("ref", init)
    port_g, port_states = _drive("port", init)
    _same_records(_records(port_g), _records(ref_g))
    assert port_g.metrics() == ref_g.metrics()
    m = port_g.metrics()
    assert (m["trips"], m["skips"], m["nonfinite"], m["spikes"]) == \
        (2, 2, 1, 1)
    assert [r["step"] for r in _records(port_g) if not r["ok"]] == [2, 5]
    for p, r in zip(port_states, ref_states):
        for n in r:
            np.testing.assert_allclose(p[n], r[n], rtol=RTOL, atol=1e-7,
                                       err_msg=n)


def test_tripped_step_leaves_the_state_bitwise():
    exe, main, loss, scope = _setup("port")
    port_guardian.enable("skip", **GUARD)
    port_fault.install(port_fault.FaultPlan(**PLAN))
    for i in range(STEPS):
        before = {k: v.clone() for k, v in scope._values.items()
                  if isinstance(v, torch.Tensor)}
        exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        moved = [k for k, v in before.items()
                 if not torch.equal(v, scope.get(k))]
        if i in (2, 5):
            assert moved == [], (i, moved)
        else:
            assert any(".w_" in k for k in moved)


def _pending_aggregate(g, name):
    _, _, health, ctx = g._pending
    if name == "ref":
        return {k: float(np.asarray(v)) for k, v in health.items()}, ctx
    return health.read()[0], ctx


@pytest.mark.parametrize("inf_step", [1, 5])
def test_window_aggregate_matches_reference(inf_step):
    """Two windows of 4; grad-Inf inside the first or the second, a
    spike at step 6 (no cap yet: a window gives one record): each
    window's aggregate, then the records and counters."""
    init = _reference_start()
    aggs = {}
    for name in ("ref", "port"):
        fluid, fault, guardian, _ = PKGS[name]
        exe, main, loss, scope = _setup(name, init)
        g = guardian.enable("skip", **GUARD)
        fault.install(fault.FaultPlan(grad_inf_step=inf_step,
                                      loss_spike_step=6, mode="raise"))
        aggs[name] = []
        for i in range(2):
            exe.run_steps(main, _feed(i), [loss], n_steps=4, scope=scope)
            aggs[name].append(_pending_aggregate(g, name)[0])
        guardian.flush()
        aggs[name + "_records"] = _records(g)
        aggs[name + "_metrics"] = g.metrics()
    for p, r in zip(aggs["port"], aggs["ref"]):
        assert set(p) == set(r)
        for k in ("trip_idx", "bad_steps", "trip_finite", "all_finite"):
            assert p[k] == r[k], (k, p, r)
        np.testing.assert_allclose(
            [p[k] for k in ("trip_loss", "trip_grad_norm", "worst_loss",
                            "worst_grad_norm", "scale")],
            [r[k] for k in ("trip_loss", "trip_grad_norm", "worst_loss",
                            "worst_grad_norm", "scale")],
            rtol=RTOL, equal_nan=True)
    _same_records(aggs["port_records"], aggs["ref_records"])
    assert aggs["port_metrics"] == aggs["ref_metrics"]


def test_window_trip_is_bitwise_the_per_step_path():
    """Within the port: a guarded window that trips (grad-Inf at step 2)
    ends bitwise where the per-step path on the same batches ends."""
    _, windows = _drive("port", None, window=4, loss_spike_step=None)
    _clear_all()
    port_framework.fresh_session()
    exe, main, loss, scope = _setup("port")
    port_guardian.enable("skip", **GUARD)
    port_fault.install(port_fault.FaultPlan(**dict(PLAN,
                                                   loss_spike_step=None)))
    for i in range(2):  # a window feeds its one batch to its 4 steps
        for _ in range(4):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        for n, v in _state(scope, _persistables(main)).items():
            np.testing.assert_array_equal(v, windows[i][n], err_msg=n)
    port_guardian.flush()
    assert port_guardian.metrics()["trips"] == 1


def _fp16_setup(name, init):
    fluid, fault, guardian, amp = PKGS[name]
    amp.enable("float16", init_loss_scale=2.0 ** 20, growth_interval=2)
    main, startup, loss = _mlp(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    if init is not None and name == "port":
        load_reference_params(scope, init, tf.CPUPlace())
    return exe, main, loss, scope


def test_fp16_scaler_under_the_guardian_matches_reference():
    _, main, _, scope = _fp16_setup("ref", None)
    init = {n: np.array(scope.get(n)) for n in _persistables(main)}
    ref_amp.disable()
    ref_framework.fresh_session()
    out = {}
    for name in ("ref", "port"):
        fluid, fault, guardian, amp = PKGS[name]
        exe, main, loss, scope = _fp16_setup(name, init)
        g = guardian.enable("skip")
        fault.install(fault.FaultPlan(grad_inf_step=3, mode="raise"))
        losses = []
        for i in range(STEPS):
            (lv,) = exe.run(main, feed=_feed(i), fetch_list=[loss],
                            scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        guardian.flush()
        amp.disable()
        out[name] = (losses, _records(g), g.metrics())
    (pl, pr, pm), (rl, rr, rm) = out["port"], out["ref"]
    assert [(r["finite"], r["ok"], r["scale"]) for r in pr] == \
        [(r["finite"], r["ok"], r["scale"]) for r in rr]
    oks = [r["ok"] for r in pr]
    assert any(oks) and not all(oks)
    assert pm == rm
    np.testing.assert_allclose(pl, rl, rtol=FP16_LOSS_RTOL)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_halt_raises_at_the_next_boundary(name):
    fluid, fault, guardian, _ = PKGS[name]
    exe, main, loss, scope = _setup(name)
    guardian.enable("halt")
    fault.install(fault.FaultPlan(grad_inf_step=1, mode="raise"))
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    with pytest.raises(guardian.NumericsTripped) as ei:
        exe.run(main, feed=_feed(2), fetch_list=[loss], scope=scope)
    assert ei.value.record.step == 1 and not ei.value.record.finite
    assert guardian.metrics()["halts"] == 1


@pytest.mark.parametrize("window", [None, 2])
def test_dump_and_halt_replays_bitwise_on_the_cpu(tmp_path, window):
    exe, main, loss, scope = _setup("port")
    port_guardian.enable("dump_and_halt", bundle_dir=str(tmp_path))
    port_fault.install(port_fault.FaultPlan(grad_inf_step=3, mode="raise"))
    with pytest.raises(port_guardian.NumericsTripped) as ei:
        for i in range(6):
            if window is None:
                exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
            else:
                exe.run_steps(main, _feed(i), [loss], n_steps=window,
                              scope=scope)
    assert ei.value.record.step == 3 and ei.value.bundle
    report = port_guardian.replay(ei.value.bundle)
    assert report["bitwise_match"], report
    bad = report["first_nonfinite"]
    assert bad is not None and bad["kind"] in ("inf", "nan", "nan+inf")
    assert report["device"] == "cpu"
    if window is not None:
        assert report["window"]["trip_offset"] == 1
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fluid.guardian", "replay",
         ei.value.bundle], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["bitwise_match"]


def test_trip_appends_one_incident_line(tmp_path, monkeypatch):
    path = tmp_path / "incidents.jsonl"
    monkeypatch.setenv("PADDLE_ELASTIC_INCIDENTS", str(path))
    _drive("port", None, steps=4)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [(ln["event"], ln["step"], ln["policy"]) for ln in lines] == \
        [("guardian_trip", 2, "skip")]


def test_config_from_env_matches_reference():
    env = {"PADDLE_TPU_GUARDIAN": "dump_and_halt",
           "PADDLE_TPU_GUARDIAN_SPIKE": "7.5",
           "PADDLE_TPU_GUARDIAN_WINDOW": "16",
           "PADDLE_TPU_GUARDIAN_RING": "64",
           "PADDLE_TPU_GUARDIAN_DIR": "/x/y"}
    ref, port = (g.GuardianConfig.from_env(env)
                 for g in (ref_guardian, port_guardian))
    assert vars(port) == vars(ref)
    for off in ({}, {"PADDLE_TPU_GUARDIAN": "0"}):
        assert port_guardian.GuardianConfig.from_env(off) is None
    one = port_guardian.GuardianConfig.from_env({"PADDLE_TPU_GUARDIAN": "1"})
    assert one.policy == "skip"


def test_unguarded_program_keeps_the_plain_path():
    """No guardian and no loss scaler: no guard spec, nothing deferred."""
    exe, main, loss, scope = _setup("port")
    assert port_guardian.for_program(main) is None
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    assert port_guardian.metrics() == {}
    port_guardian.enable("skip")
    assert port_guardian.for_program(main) is not None
