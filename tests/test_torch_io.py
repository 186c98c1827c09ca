"""Checkpoints of the port against the JAX package, on the CPU:

 - a checkpoint either package writes (``save_persistables``: one
   ``np.save`` file a variable, or one ``np.savez`` file with
   ``filename=``) loads in the other: the same file names, and the other
   package's save right after the load writes ``np.array_equal`` arrays;
 - the tiny Transformer (dropout 0, Adam) trained 2 steps and saved in
   one package continues in the other within the ``train_parity`` bounds
   of the uninterrupted run's steps 3-4 (rtol 1e-5 on the first step, 1e-4
   after), both ways; the MNIST mlp (SGD) the same;
 - ``load_vars`` writes in place over the scope's tensors, puts a name the
   scope lacks on the executor's device, raises ``IOError`` for a missing
   file and ``ValueError`` / ``TypeError`` for a shape / dtype mismatch
   before writing anything; ``save_vars`` refuses a bfloat16 persistable;
 - an injected transient I/O error (``fault.io_error``) fails the same
   files in both packages and is retried in both.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import fault as ref_fault
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.models import mnist as ref_mnist
from paddle_tpu.models import transformer as ref_tm
from paddle_tpu_torch.fluid import fault as port_fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import retry as port_retry
from paddle_tpu_torch.models import mnist as port_mnist
from paddle_tpu_torch.models import transformer as port_tm

B, L = 2, 8
STEP_RTOL = (1e-5, 1e-4)  # train_parity: the first step, the later ones


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield
    port_fault.clear()
    ref_fault.clear()


def _transformer(pkg, tm):
    cfg = tm.tiny_config()
    cfg.flash_attention = False
    cfg.dropout = 0.0
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, cost = tm.build(cfg, src_len=L, tgt_len=L)
    return main, startup, cost


def _mlp(pkg, mnist):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss, _ = mnist.mlp()
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


MODELS = {"transformer": (_transformer, ref_tm, port_tm),
          "mnist_mlp": (_mlp, ref_mnist, port_mnist)}


def _feed(model, step):
    rng = np.random.RandomState(step)
    if model == "transformer":
        return {"src_word": rng.randint(1, 1000, (B, L)).astype(np.int64),
                "tgt_word": rng.randint(1, 1000, (B, L)).astype(np.int64),
                "lbl_word": rng.randint(1, 1000, (B, L, 1)).astype(np.int64)}
    return {"img": rng.normal(size=(8, 784)).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}


class _Run:
    """One package's model, executor and scope."""

    def __init__(self, pkg, model):
        build, ref_mod, port_mod = MODELS[model]
        if pkg is rf:
            ref_framework.fresh_session()
        self.pkg, self.model = pkg, model
        self.main, self.startup, self.loss = build(
            pkg, ref_mod if pkg is rf else port_mod)
        self.exe = pkg.Executor(pkg.CPUPlace())
        self.scope = pkg.Scope()
        self.exe.run(self.startup, scope=self.scope)

    def steps(self, first, n):
        return [float(np.asarray(self.exe.run(
            self.main, feed=_feed(self.model, first + k),
            fetch_list=[self.loss], scope=self.scope)[0]).reshape(-1)[0])
            for k in range(n)]

    def save(self, dirname, filename=None):
        with self.pkg.scope_guard(self.scope):
            self.pkg.io.save_persistables(self.exe, dirname, self.main,
                                          filename=filename)

    def load(self, dirname, filename=None):
        self.pkg.io.load_persistables(self.exe, dirname, self.main,
                                      filename=filename, scope=self.scope)


def _read_dir(dirname, filename=None):
    if filename is not None:
        with np.load(os.path.join(dirname, filename)) as data:
            return {k: data[k] for k in data.files}
    return {n: np.load(os.path.join(dirname, n), allow_pickle=False)
            for n in os.listdir(dirname)}


def _assert_same_files(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert a[n].dtype == b[n].dtype, n
        assert np.array_equal(a[n], b[n]), n


@pytest.mark.parametrize("model,filename", [
    ("transformer", None), ("mnist_mlp", None), ("mnist_mlp", "params.npz")],
    ids=["transformer-per_var", "mnist_mlp-per_var", "mnist_mlp-npz"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_crosses_packages(tmp_path, direction, model, filename):
    """The writer trains 2 steps, saves, and trains 2 more; the reader
    starts from its own startup, loads, saves again (the same files and
    arrays) and trains 2 steps: its losses are the writer's steps 3-4."""
    first, second = (rf, tf) if direction == "ref_to_port" else (tf, rf)
    writer = _Run(first, model)
    writer.steps(0, 2)
    writer.save(str(tmp_path / "a"), filename)
    want = writer.steps(2, 2)
    reader = _Run(second, model)
    reader.load(str(tmp_path / "a"), filename)
    reader.save(str(tmp_path / "b"), filename)
    _assert_same_files(_read_dir(str(tmp_path / "a"), filename),
                       _read_dir(str(tmp_path / "b"), filename))
    got = reader.steps(2, 2)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL[min(k, 1)])


def test_load_writes_in_place_and_places_new_names(tmp_path):
    run = _Run(tf, "mnist_mlp")
    run.steps(0, 1)
    run.save(str(tmp_path))
    held = {n: run.scope.get(n) for n in os.listdir(tmp_path)}
    saved = {n: t.clone() for n, t in held.items()}
    for t in held.values():
        t.zero_()
    fresh = tf.Scope()
    tf.io.load_persistables(run.exe, str(tmp_path), run.main, scope=fresh)
    run.load(str(tmp_path))
    for n, t in held.items():
        assert run.scope.get(n) is t  # the same tensor, written in place
        assert torch.equal(t, saved[n])
        assert fresh.get(n).device == run.exe.device
        assert torch.equal(fresh.get(n), saved[n])


def test_missing_file_raises_ioerror(tmp_path):
    run = _Run(tf, "mnist_mlp")
    run.save(str(tmp_path))
    os.remove(tmp_path / "fc_1.w_0")
    with pytest.raises(IOError, match="fc_1.w_0"):
        run.load(str(tmp_path))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_mismatch_raises_before_writing(tmp_path, bad):
    run = _Run(tf, "mnist_mlp")
    run.save(str(tmp_path))
    # the last var in load order gets the wrong shape or dtype
    names = [v.name for v in run.main.list_vars() if v.persistable]
    arr = np.load(tmp_path / names[-1])
    arr = np.append(arr, arr) if bad == "shape" else arr.astype(np.float64)
    with open(tmp_path / names[-1], "wb") as f:
        np.save(f, arr)
    before = {n: run.scope.get(n).clone() for n in names}
    for n in names[:-1]:
        run.scope.get(n).add_(1.0)
    moved = {n: run.scope.get(n).clone() for n in names}
    with pytest.raises(ValueError if bad == "shape" else TypeError,
                       match=names[-1]):
        run.load(str(tmp_path))
    for n in names:
        assert torch.equal(run.scope.get(n), moved[n])
    assert not torch.equal(moved[names[0]], before[names[0]])


def test_bfloat16_persistable_is_refused(tmp_path):
    run = _Run(tf, "mnist_mlp")
    name = "fc_0.w_0"
    run.scope.set(name, run.scope.get(name).to(torch.bfloat16))
    with pytest.raises(TypeError, match=name):
        run.save(str(tmp_path / "ckpt"))
    assert not (tmp_path / "ckpt").exists()


def test_injected_io_error_is_retried_in_both(tmp_path, monkeypatch):
    """Half the (file, op) keys fail their first attempt, chosen by the
    same seeded hash in both packages: saves and loads succeed through
    one retry each, and both packages failed the same keys."""
    monkeypatch.setenv("PADDLE_IO_RETRY_BASE_S", "0")
    attempts, counts = [], []
    for pkg, fault in ((rf, ref_fault), (tf, port_fault)):
        plan = fault.FaultPlan(io_error_rate=0.5, io_error_seed=3)
        fault.install(plan)
        run = _Run(pkg, "mnist_mlp")
        run.steps(0, 1)
        ckpt = tmp_path / ("ref" if pkg is rf else "port") / "ckpt"
        run.save(str(ckpt))
        run.load(str(ckpt))
        fault.clear()
        attempts.append(dict(plan._io_error_attempts))
        counts.append((len(os.listdir(ckpt)), sum(
            1 for v in run.main.list_vars() if v.persistable)))
    assert attempts[0] == attempts[1]
    assert attempts[1] and set(attempts[1].values()) == {2}
    assert {op for _, op in attempts[1]} == {"read", "write"}
    assert counts[0] == counts[1] and counts[1][0] == counts[1][1]


def test_retry_gives_up_after_its_attempts():
    calls = []

    def failing():
        calls.append(1)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        port_retry.retry_io(failing, what="t", attempts=3, base_s=0.0,
                            sleep=lambda s: None)
    assert len(calls) == 3

    def corrupt():
        calls.append(1)
        raise ValueError("torn header")

    calls.clear()
    with pytest.raises(ValueError):
        port_retry.retry_io(corrupt, what="t", attempts=3, base_s=0.0,
                            sleep=lambda s: None)
    assert len(calls) == 1


def test_io_fault_knobs_read_as_the_reference_reads_them():
    env = {"PADDLE_FAULT_IO_ERROR_RATE": "0.25",
           "PADDLE_FAULT_IO_ERROR_SEED": "7",
           "PADDLE_FAULT_IO_DELAY_MS": "1.5"}
    port, ref = port_fault.FaultPlan.from_env(env), \
        ref_fault.FaultPlan.from_env(env)
    for field in ("io_error_rate", "io_error_seed", "io_delay_ms"):
        assert getattr(port, field) == getattr(ref, field)
    assert port.spec_draft_poison is None
    assert port_fault.FaultPlan.from_env({}) is None
