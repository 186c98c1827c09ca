"""``fluid.fault`` of the port against the JAX package's, on the CPU.

The same plan, armed the same way, must fire at the same point of the same
program in both packages:

 - every ``PADDLE_FAULT_*`` knob the reference declares gives the same
   ``FaultPlan`` fields in both (one case a knob), and the windowed
   sentinel injection arrays are equal;
 - kill-at-step fires at the same training step in ``Executor.run`` and
   before the same ``run_steps`` window (raise mode), the rank filter
   holds, and a resumed worker that passes its step index past the kill
   does not fire again;
 - an injected NaN var lands in the scope and trips ``check_nan_inf``
   naming the var, at the same step;
 - the checkpoint crash fires before and after the ``_SUCCESS`` mark, and
   leaves the same serials behind;
 - the page-leak oracle makes the port's page pool skip the same number
   of frees as the reference's (``pages_leaked``), and the decode stall
   sleeps once a tick;
 - a subprocess armed with ``PADDLE_FAULT_KILL_STEP`` exits 137 at that
   step (exit mode: no atexit, no flush).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import envcontract as ref_ec
from paddle_tpu.fluid import fault as ref_fault
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import guardian as ref_guardian
from paddle_tpu.fluid import trainer as ref_trainer
from paddle_tpu_torch.fluid import fault as port_fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import guardian as port_guardian
from paddle_tpu_torch.fluid import trainer as port_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": (rf, ref_fault), "port": (tf, port_fault)}

# a value for each PADDLE_FAULT_* knob, by its declared type
_SAMPLES = {"int": "3", "float": "2.5", "bool": "1"}
_STR_SAMPLES = {"PADDLE_FAULT_CKPT_CRASH": "before",
                "PADDLE_FAULT_MODE": "raise",
                "PADDLE_FAULT_NAN_VAR": "fc_0.w_0"}
FAULT_KNOBS = sorted(k.name for k in ref_ec.REGISTRY.values()
                     if k.subsystem == "fault" and k.type != "prefix")


def _clear_all():
    for mod in (ref_fault, port_fault):
        mod.clear()
    for mod in (ref_guardian, port_guardian):
        mod.disable()
    tf.core.GLOBAL_FLAGS["check_nan_inf"] = False
    rf.core.GLOBAL_FLAGS["check_nan_inf"] = False


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PADDLE_FAULT_") or k == "PADDLE_TRAINER_ID":
            monkeypatch.delenv(k)
    port_framework.fresh_session()
    ref_framework.fresh_session()
    _clear_all()
    yield
    _clear_all()


def _mlp(fluid, seed=7):
    """fc(8, relu) -> fc(1) -> squared error, SGD: (executor, main, loss,
    startup), the startup run, on the CPU."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, loss, scope


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(size=(8, 4)).astype(np.float32),
            "y": rng.normal(size=(8, 1)).astype(np.float32)}


def _fields(plan):
    return {k: v for k, v in vars(plan).items() if not k.startswith("_")}


@pytest.mark.parametrize("knob", FAULT_KNOBS)
def test_fault_plan_from_env_matches_reference(knob):
    kind = ref_ec.REGISTRY[knob].type
    env = {knob: _STR_SAMPLES.get(knob, _SAMPLES.get(kind, "1"))}
    ref, port = (mod.FaultPlan.from_env(env)
                 for mod in (ref_fault, port_fault))
    assert ref is not None and port is not None
    assert _fields(port) == _fields(ref)
    assert port_fault.FaultPlan.from_env({}) is None


def test_every_reference_fault_knob_is_declared_in_the_port():
    from paddle_tpu_torch.fluid import envcontract as port_ec

    for name in FAULT_KNOBS:
        ref_k, port_k = ref_ec.REGISTRY[name], port_ec.REGISTRY[name]
        assert (port_k.type, port_k.default) == (ref_k.type, ref_k.default)
    assert _fields(port_fault.FaultPlan()).keys() == \
        _fields(ref_fault.FaultPlan()).keys()


def test_sentinel_injection_matches_reference():
    for mod in (ref_fault, port_fault):
        mod.install(mod.FaultPlan(grad_inf_step=5, grad_inf_value=1e30,
                                  loss_spike_step=6, loss_spike_factor=50.0))
    for start, n in ((0, 4), (4, 4), (5, 2), (7, 3)):
        ref, port = (mod.sentinel_injection_window(start, n)
                     for mod in (ref_fault, port_fault))
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(a, b)
    for step in range(8):
        assert port_fault.sentinel_injection(step) == \
            ref_fault.sentinel_injection(step)


def _steps_until_kill(name, n_steps=5, **plan):
    fluid, mod = PKGS[name]
    exe, main, loss, scope = _mlp(fluid)
    mod.install(mod.FaultPlan(mode="raise", **plan))
    done = []
    with pytest.raises(mod.InjectedFault):
        for i in range(n_steps):
            exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
            done.append(i)
    return done, mod.current_step()


def test_kill_at_step_fires_in_run():
    ref = _steps_until_kill("ref", kill_step=2)
    port = _steps_until_kill("port", kill_step=2)
    assert port == ref == ([0, 1], 2)


def test_kill_fires_before_the_run_steps_window_holding_it():
    out = {}
    for name, (fluid, mod) in PKGS.items():
        exe, main, loss, scope = _mlp(fluid)
        mod.install(mod.FaultPlan(kill_step=5, mode="raise"))
        exe.run_steps(main, _feed(0), [loss], n_steps=4, scope=scope)
        w = np.array(scope.find_var("fc_0.w_0").get_tensor())
        with pytest.raises(mod.InjectedFault, match=r"\[4, 8\)"):
            exe.run_steps(main, _feed(1), [loss], n_steps=4, scope=scope)
        # the window that holds the kill never ran
        np.testing.assert_array_equal(
            np.array(scope.find_var("fc_0.w_0").get_tensor()), w)
        out[name] = mod.current_step()
    assert out["port"] == out["ref"] == 4


@pytest.mark.parametrize("rank", ["0", "3"])
def test_rank_filter_holds(monkeypatch, rank):
    monkeypatch.setenv("PADDLE_TRAINER_ID", rank)
    fired = {}
    for name, (fluid, mod) in PKGS.items():
        exe, main, loss, scope = _mlp(fluid)
        mod.install(mod.FaultPlan(kill_step=0, rank=3, mode="raise"))
        try:
            exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
            fired[name] = False
        except mod.InjectedFault:
            fired[name] = True
    assert fired["port"] == fired["ref"] == (rank == "3")


def test_resumed_worker_does_not_fire_again():
    seen = {}
    for name, (_, mod) in PKGS.items():
        mod.install(mod.FaultPlan(kill_step=3, mode="raise"))
        seen[name] = [mod.on_step(4), mod.on_step(5), mod.current_step()]
        with pytest.raises(mod.InjectedFault):
            mod.on_step(3)  # an earlier explicit index still fires
    assert seen["port"] == seen["ref"] == [4, 5, 6]


def test_nan_var_lands_in_scope_and_trips_the_nan_check():
    out = {}
    for name, (fluid, mod) in PKGS.items():
        exe, main, loss, scope = _mlp(fluid)
        mod.install(mod.FaultPlan(nan_var="fc_0.w_0", nan_step=1,
                                  mode="raise"))
        fluid.core.GLOBAL_FLAGS["check_nan_inf"] = True
        steps = []
        with pytest.raises(FloatingPointError, match="fc_0.w_0"):
            for i in range(4):
                exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
                steps.append(i)
        fluid.core.GLOBAL_FLAGS["check_nan_inf"] = False
        w = np.array(scope.find_var("fc_0.w_0").get_tensor())
        assert np.isnan(w).all()
        out[name] = steps
    assert out["port"] == out["ref"] == [0]


@pytest.mark.parametrize("where", ["before", "after"])
def test_checkpoint_crash_around_the_mark(tmp_path, where):
    """The crash fires inside ``save_checkpoint`` on either side of the
    _SUCCESS write; before it the serial stays incomplete and a load
    skips it, after it the serial is committed."""
    out = {}
    for name, (fluid, mod) in PKGS.items():
        trainer = {"ref": ref_trainer, "port": port_trainer}[name]
        exe, main, loss, scope = _mlp(fluid)
        d = str(tmp_path / name)
        with fluid.scope_guard(scope):
            trainer.save_checkpoint(exe, d, main,
                                    trainer_args={"step_id": 0})
            mod.install(mod.FaultPlan(ckpt_crash=where, mode="raise"))
            with pytest.raises(mod.InjectedFault, match=where):
                trainer.save_checkpoint(exe, d, main,
                                        trainer_args={"step_id": 1})
            mod.clear()
            args = trainer.load_checkpoint(exe, d, main)
        marks = {n: os.path.exists(os.path.join(d, n, "_SUCCESS"))
                 for n in sorted(os.listdir(d))}
        out[name] = (marks, args)
    assert out["port"] == out["ref"]
    want = {"checkpoint_0": True, "checkpoint_1": where == "after"}
    assert out["port"][0] == want
    assert out["port"][1]["step_id"] == (1 if where == "after" else 0)


def test_ckpt_poison_rewrites_a_committed_serial(tmp_path):
    for name, (fluid, mod) in PKGS.items():
        trainer = {"ref": ref_trainer, "port": port_trainer}[name]
        exe, main, loss, scope = _mlp(fluid)
        d = str(tmp_path / name)
        mod.install(mod.FaultPlan(ckpt_poison_serial=0))
        with fluid.scope_guard(scope):
            trainer.save_checkpoint(exe, d, main, trainer_args={})
        w = np.load(os.path.join(d, "checkpoint_0", "fc_0.w_0"))
        assert np.isnan(w).all()
        assert os.path.exists(os.path.join(d, "checkpoint_0", "_SUCCESS"))


def _tiny_engine(pkg):
    if pkg == "ref":
        from paddle_tpu.models import transformer as tm
        from paddle_tpu.serving import DecodeEngine
        kw = {}
    else:
        from paddle_tpu_torch.models import transformer as tm
        from paddle_tpu_torch.serving import DecodeEngine
        kw = {"place": tf.CPUPlace()}
    model = tm.DecodeModel(tm.decode_lm_config(), max_slots=2, max_len=16,
                           prefill_buckets=[4, 8], paged=True, page_size=4)
    return DecodeEngine(model, **kw)


def test_kv_page_leak_and_decode_stall_on_a_tiny_engine(monkeypatch):
    """The page pool skips exactly the armed number of frees in both
    packages (``pages_leaked``); the decode stall sleeps its ms once a
    tick."""
    leaked = {}
    for name, (_, mod) in PKGS.items():
        mod.install(mod.FaultPlan(kv_page_leak=2))
        eng = _tiny_engine(name)
        try:
            for prompt in ([3, 4, 5], [6, 7, 8, 9, 10]):
                eng.generate(prompt, 4)
            eng.drain(timeout_s=30)
            leaked[name] = eng._pool.pages_leaked
        finally:
            eng.shutdown(timeout_s=30)
    assert leaked["port"] == leaked["ref"] == 2

    sleeps = []
    monkeypatch.setattr(port_fault.time, "sleep", sleeps.append)
    port_fault.install(port_fault.FaultPlan(decode_stall_ms=7.0))
    eng = _tiny_engine("port")
    try:
        eng.generate([3, 4, 5], 3)
    finally:
        eng.shutdown(timeout_s=30)
    assert sleeps and all(s == pytest.approx(0.007) for s in sleeps)


def test_kill_subprocess_exits_137():
    script = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import numpy as np
        import paddle_tpu_torch.fluid as fluid
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(input=x, size=1))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for i in range(5):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss])
            print(i, flush=True)
        print("done", flush=True)
    """ % REPO)
    env = {**os.environ, "PADDLE_FAULT_KILL_STEP": "2",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == port_fault.KILL_EXIT_CODE == 137, proc.stderr
    assert proc.stdout.split() == ["0", "1"]
