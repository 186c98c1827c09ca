"""``fluid.Trainer`` and its serial checkpoints, the port against the JAX
package's, on the CPU.

An MLP (fc 8 relu, fc 1, squared error, Adam) trained for an epoch of 8
batches of a seeded reader through ``data.from_reader(...).shuffle(16,
seed=7).batch(8)``, with a checkpoint every 2 steps:

 - the port resumes from a checkpoint directory the REFERENCE's Trainer
   wrote (parameters, Adam moments, trainer args, the data state) and its
   losses match the reference's uninterrupted run at rtol 1e-5;
 - the events arrive in the reference's order; the windowed loop
   (``PADDLE_TPU_SPD``) saves at the reference's steps;
 - within the port: kill (raise mode) and resume is bitwise, for the MLP
   and for a 2-layer Transformer (d_model 32); an incomplete serial is
   ignored; a truncated file falls back to the previous serial; when
   every serial is corrupt, loading raises; an async save's files equal a
   sync save's bitwise;
 - ``test``, ``save_params`` + ``Inferencer`` and
   ``save_inference_model`` give the reference's numbers (rtol 1e-5);
 - with no card and no place, ``Trainer`` and ``Inferencer`` raise (the
   port's entry points default to the card; the reference's to the CPU).
   ``parallel=True`` is held to the reference in
   ``tests/test_torch_parallel_executor.py``.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu import data as ref_data
from paddle_tpu.fluid import fault as ref_fault
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import guardian as ref_guardian
from paddle_tpu.fluid import trainer as ref_trainer
from paddle_tpu_torch import data as port_data
from paddle_tpu_torch.fluid import fault as port_fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import guardian as port_guardian
from paddle_tpu_torch.fluid import trainer as port_trainer

RTOL = 1e-5
STEPS, BATCH = 8, 8
PKGS = {"ref": (rf, ref_trainer, ref_data, ref_fault),
        "port": (tf, port_trainer, port_data, port_fault)}
FEEDS = ["x", "y"]


def _clear_all():
    for mod in (ref_fault, port_fault):
        mod.clear()
    for mod in (ref_guardian, port_guardian):
        mod.disable()


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PADDLE_FAULT_", "PADDLE_TPU_GUARDIAN",
                         "PADDLE_TPU_SPD", "PADDLE_DATA_")):
            monkeypatch.delenv(k)
    port_framework.fresh_session()
    ref_framework.fresh_session()
    _clear_all()
    yield
    _clear_all()


def _train_func(fluid):
    def train_func():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
    return train_func


def _infer_func(fluid):
    def infer_func():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        return fluid.layers.fc(input=h, size=1)
    return infer_func


def _opt(fluid):
    return lambda: fluid.optimizer.Adam(learning_rate=0.05)


def _source(n=STEPS * BATCH, seed=3):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield (rng.normal(size=4).astype(np.float32),
                   rng.normal(size=1).astype(np.float32))
    return reader


def _pipe(data, hashes=None):
    pipe = data.from_reader(_source()).shuffle(16, seed=7).batch(BATCH)
    if hashes is not None:
        pipe = pipe.map(lambda b: hashes.append(
            b"".join(a.tobytes() for s in b for a in s)) or b)
    return pipe


def _reference_init():
    """The reference Trainer's initialized persistables (the two packages'
    initializers draw from different generators)."""
    with rf.scope_guard(rf.Scope()):
        tr = rf.Trainer(_train_func(rf), _opt(rf), place=rf.CPUPlace())
        scope = rf.global_scope()
        return {v.name: np.array(scope.get(v.name))
                for v in tr.train_program.list_vars()
                if v.persistable and scope.get(v.name) is not None}


def _run(name, ckpt_dir=None, kill=None, interval=2, place=None,
         train_func=None, pipe=None, num_epochs=1, saves=None, init=None):
    """One Trainer run in ``name``'s package in a fresh scope, from
    ``init`` (persistables) when given: (losses by step, events, the
    Trainer)."""
    fluid, trainer_mod, data, fault = PKGS[name]
    if kill is not None:
        fault.install(fault.FaultPlan(kill_step=kill, mode="raise"))
    cfg = (fluid.CheckpointConfig(ckpt_dir, max_num_checkpoints=2,
                                  step_interval=interval)
           if ckpt_dir else None)
    losses, events = {}, []

    def handler(ev):
        events.append((type(ev).__name__, getattr(ev, "epoch", None),
                       getattr(ev, "step", None)))
        if isinstance(ev, fluid.EndStepEvent) and ev.metrics:
            losses[ev.step] = np.asarray(ev.metrics[0]).reshape(-1)[0]

    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        tr = fluid.Trainer(train_func or _train_func(fluid), _opt(fluid),
                           place=place or fluid.CPUPlace(),
                           checkpoint_config=cfg)
        for n, a in (init or {}).items():
            if name == "ref":
                scope.set(n, a)
            else:
                scope.get(n).copy_(torch.from_numpy(a))
        real_save = trainer_mod.save_checkpoint
        if saves is not None:
            def logged(*a, **k):
                saves.append(k.get("trainer_args"))
                return real_save(*a, **k)
            trainer_mod.save_checkpoint = logged
        try:
            tr.train(num_epochs, handler, reader=pipe or _pipe(data),
                     feed_order=FEEDS)
        except fault.InjectedFault:
            pass
        finally:
            trainer_mod.save_checkpoint = real_save
            fault.clear()
    tr.test_scope = scope  # the scope it trained in
    return losses, events, tr


def test_port_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference trains 8 steps uninterrupted, and again killed at
    step 5 (serials after steps 1 and 3, with their data states); the
    port resumes from the reference's directory, trains steps 4-7 and
    matches the uninterrupted reference at rtol 1e-5."""
    full, _, _ = _run("ref", str(tmp_path / "full"))
    d = str(tmp_path / "killed")
    _run("ref", d, kill=5)
    assert sorted(os.listdir(d)) == ["checkpoint_0", "checkpoint_1"]
    assert os.path.exists(os.path.join(d, "checkpoint_1",
                                       "data_state_0.json"))
    port, events, tr = _run("port", d)
    assert tr.checkpoint_cfg.step_id == 4
    assert sorted(port) == [4, 5, 6, 7]
    np.testing.assert_allclose([port[s] for s in range(4, 8)],
                               [full[s] for s in range(4, 8)], rtol=RTOL)
    assert events[1] == ("BeginStepEvent", 0, 4)


def test_events_match_reference(tmp_path):
    _, ref_ev, _ = _run("ref", str(tmp_path / "r"), num_epochs=2)
    _, port_ev, _ = _run("port", str(tmp_path / "p"), num_epochs=2)
    assert port_ev == ref_ev
    assert port_ev[0] == ("BeginEpochEvent", 0, None)
    assert port_ev[-1] == ("EndEpochEvent", 1, None)


def test_kill_and_resume_is_bitwise_within_the_port(tmp_path):
    full_hashes, resumed_hashes = [], []
    full, _, _ = _run("port", str(tmp_path / "full"),
                      pipe=_pipe(port_data, full_hashes))
    d = str(tmp_path / "killed")
    _run("port", d, kill=5, pipe=_pipe(port_data, []))
    resumed, _, _ = _run("port", d, pipe=_pipe(port_data, resumed_hashes))
    assert sorted(resumed) == [4, 5, 6, 7]
    for s in resumed:
        assert resumed[s].tobytes() == full[s].tobytes()
    assert resumed_hashes == full_hashes[4:]


def _tiny_transformer():
    from paddle_tpu_torch.models import transformer

    cfg = transformer.Config("t", 64, 64, d_model=32, d_inner=64, n_head=4,
                             n_layer=2, dropout=0.0,
                             flash_attention=False)
    return lambda: transformer.forward(cfg, 8, 8)[3]


def _seq_source(n=STEPS * 4, seed=5):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield (rng.randint(1, 64, size=8), rng.randint(1, 64, size=8),
                   rng.randint(1, 64, size=(8, 1)))
    return reader


def test_transformer_kill_and_resume_is_bitwise(tmp_path, monkeypatch):
    monkeypatch.setitem(globals(), "FEEDS",
                        ["src_word", "tgt_word", "lbl_word"])

    def pipe():
        return port_data.from_reader(_seq_source()).shuffle(
            8, seed=7).batch(4)

    full, _, _ = _run("port", str(tmp_path / "full"),
                      train_func=_tiny_transformer(), pipe=pipe())
    d = str(tmp_path / "killed")
    _run("port", d, kill=5, train_func=_tiny_transformer(), pipe=pipe())
    resumed, _, _ = _run("port", d, train_func=_tiny_transformer(),
                         pipe=pipe())
    assert sorted(resumed) == [4, 5, 6, 7]
    for s in resumed:
        assert resumed[s].tobytes() == full[s].tobytes(), s


def test_incomplete_serial_is_ignored(tmp_path):
    d = str(tmp_path / "c")
    _run("port", d, kill=5)
    os.makedirs(os.path.join(d, "checkpoint_2"))
    with open(os.path.join(d, "checkpoint_2", "fc_0.w_0"), "wb") as f:
        f.write(b"\x93NUMPY")  # cut mid-write, never marked
    _, _, tr = _run("port", d)
    assert tr.checkpoint_cfg.step_id == 4


def _save_state(name, d, steps=4):
    """Train ``steps`` steps with a serial every 2; return the Trainer."""
    fluid, trainer_mod, data, _ = PKGS[name]
    pipe = data.from_reader(_source(steps * BATCH)).batch(BATCH)
    _, _, tr = _run(name, d, pipe=pipe)
    return tr


def test_truncated_file_falls_back_to_the_previous_serial(tmp_path):
    d = str(tmp_path / "c")
    _save_state("port", d)
    newest = sorted(os.listdir(d))[-1]
    path = os.path.join(d, newest, "fc_0.w_0")
    with open(path, "rb") as f:
        payload = f.read()
    with open(path, "wb") as f:
        f.write(payload[:len(payload) // 2])
    args = {}
    for name in ("ref", "port"):
        fluid, trainer_mod, _, _ = PKGS[name]
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), \
                    fluid.unique_name.guard():
                _train_func(fluid)()
            exe.run(startup)
            args[name] = trainer_mod.load_checkpoint(exe, d, main)
    assert args["port"] == args["ref"]
    assert args["port"]["step_id"] == 3  # the serial before the newest


def test_all_serials_corrupt_raises(tmp_path):
    d = str(tmp_path / "c")
    _save_state("port", d)
    for name in os.listdir(d):
        with open(os.path.join(d, name, "fc_0.w_0"), "wb") as f:
            f.write(b"garbage")
    with pytest.raises(IOError, match="no loadable checkpoint"):
        _run("port", d)


def test_async_save_files_equal_sync_save_files(tmp_path):
    tr = _save_state("port", str(tmp_path / "c"))
    exe, prog = tr.exe, tr.train_program
    dirs = {}
    for background in (False, True):
        d = str(tmp_path / f"s{int(background)}")
        with tf.scope_guard(tr.test_scope):
            serial = port_trainer.save_checkpoint(
                exe, d, prog, trainer_args={"step_id": 3},
                background=background)
        port_trainer.wait_for_checkpoints(d)
        dirs[background] = os.path.join(d, f"checkpoint_{serial}")
    names = sorted(os.listdir(dirs[False]))
    assert names == sorted(os.listdir(dirs[True])) and "_SUCCESS" in names
    for n in names:
        with open(os.path.join(dirs[False], n), "rb") as f, \
                open(os.path.join(dirs[True], n), "rb") as g:
            assert f.read() == g.read(), n


@pytest.mark.parametrize("spd", [2, 3])
def test_windowed_loop_checkpoints_at_the_reference_steps(tmp_path,
                                                          monkeypatch, spd):
    monkeypatch.setenv("PADDLE_TPU_SPD", str(spd))
    init = _reference_init()
    saves, losses = {}, {}
    for name in ("ref", "port"):
        saves[name] = []
        losses[name], _, _ = _run(name, str(tmp_path / name), interval=3,
                                  saves=saves[name], init=init)
    assert saves["port"] == saves["ref"]
    assert sorted(losses["port"]) == sorted(losses["ref"])
    np.testing.assert_allclose([losses["port"][s] for s in losses["ref"]],
                               [losses["ref"][s] for s in losses["ref"]],
                               rtol=RTOL)


def test_windowed_losses_are_bitwise_the_per_step_losses(tmp_path,
                                                         monkeypatch):
    steps, _, _ = _run("port", None)
    monkeypatch.setenv("PADDLE_TPU_SPD", "4")
    windows, _, _ = _run("port", None)
    assert sorted(windows) == [3, 7]
    for s in windows:
        assert windows[s].tobytes() == steps[s].tobytes()


def test_test_save_params_and_inferencer_match_reference(tmp_path):
    x = np.random.RandomState(11).normal(size=(5, 4)).astype(np.float32)
    init = _reference_init()
    out = {}
    for name in ("ref", "port"):
        fluid, _, data, _ = PKGS[name]
        _, _, tr = _run(name, None, init=init)
        params = str(tmp_path / f"params_{name}")
        with fluid.scope_guard(tr.test_scope):
            test_loss = tr.test(_pipe(data), FEEDS)
            tr.save_params(params)
            tr.save_inference_model(str(tmp_path / f"model_{name}"), ["x"],
                                    [0])
        inf = fluid.Inferencer(_infer_func(fluid), params,
                               place=fluid.CPUPlace())
        (pred,) = inf.infer({"x": x})
        out[name] = (test_loss, np.asarray(pred))
    np.testing.assert_allclose(out["port"][0], out["ref"][0], rtol=RTOL)
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=RTOL,
                               atol=1e-6)
    assert os.path.exists(str(tmp_path / "model_port" / "__model__"))


def test_no_card_and_no_place_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tf.Trainer(_train_func(tf), _opt(tf))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tf.Inferencer(_infer_func(tf), "/nonexistent")
