"""``paddle_tpu_torch.data`` against the JAX package's ``paddle_tpu.data``,
on the CPU.

The same reader factory (samples ``(features, id)`` from a seeded
RandomState) through the same stages in both packages:

 - each stage's sample sequence over two epochs equals the reference's
   (the source, ``shard``, ``shuffle``, ``batch`` with and without
   ``drop_last``, ``map``, and their chain);
 - a state taken at several stop points (parametrised) is the reference's
   state, JSON for JSON, and a pipeline restored from it (the reference's
   state restored into the port's pipeline) yields the exact remaining
   sequence;
 - ``CheckpointablePrefetcher``'s state tracks the windows consumed, not
   the ones staged ahead;
 - the ``data_state`` blob lies under ``_SUCCESS`` in a trainer serial, in
   the reference's format; a corrupt one (``PADDLE_FAULT_SHARD_CORRUPT``)
   falls back to the previous serial in both; the data stall fault sleeps
   at the same cursor; the wait counters count;
 - ``shard_spec`` / ``shard_layout`` over mesh spec strings and the cursor
   remaps (``merge_cursor_states``, ``remap_data_state``) match the
   reference's.
"""

import json
import os

import numpy as np
import pytest

import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu import data as ref_data
from paddle_tpu.data import checkpoint as ref_ckpt
from paddle_tpu.data import sharding as ref_sharding
from paddle_tpu.fluid import fault as ref_fault
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import trainer as ref_trainer
from paddle_tpu_torch import data as port_data
from paddle_tpu_torch.data import checkpoint as port_ckpt
from paddle_tpu_torch.data import sharding as port_sharding
from paddle_tpu_torch.fluid import fault as port_fault
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import trainer as port_trainer

PKGS = {"ref": ref_data, "port": port_data}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("PADDLE_FAULT_", "PADDLE_DATA_", "PADDLE_TPU_MESH")):
            monkeypatch.delenv(k)
    port_framework.fresh_session()
    ref_framework.fresh_session()
    for mod in (ref_fault, port_fault):
        mod.clear()
    port_data.reset_counters()
    yield
    for mod in (ref_fault, port_fault):
        mod.clear()


def _reader(n=40, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield (rng.normal(size=3).astype(np.float32), i)
    return reader


STAGES = {
    "source": lambda p: p,
    "shard": lambda p: p.shard(3, 1),
    "shuffle": lambda p: p.shuffle(7, seed=11),
    "batch": lambda p: p.batch(6),
    "batch_drop_last": lambda p: p.batch(6, drop_last=True),
    "map": lambda p: p.map(lambda s: (s[0] * 2, s[1] + 100)),
    "chain": lambda p: p.shuffle(8, seed=3).shard(2, 0).batch(4),
}


def _flat(items):
    """A comparable form of samples or batches."""
    out = []
    for it in items:
        if isinstance(it, list):
            out.append([(s[0].tobytes(), s[1]) for s in it])
        else:
            out.append((it[0].tobytes(), it[1]))
    return out


def _build(name, stage):
    return STAGES[stage](PKGS[name].from_reader(_reader()))


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_sequence_matches_reference(stage):
    seqs = {}
    for name in PKGS:
        pipe = _build(name, stage)
        seqs[name] = [_flat(list(pipe())) for _ in range(2)]  # two epochs
    assert seqs["port"] == seqs["ref"]
    assert seqs["port"][0] and seqs["port"][0] != seqs["port"][1] \
        or stage in ("source", "shard", "batch", "batch_drop_last", "map")


@pytest.mark.parametrize("stop", [0, 1, 2, 4, 5])
def test_state_restore_resumes_the_exact_sequence(stop):
    states, rests = {}, {}
    for name in PKGS:
        pipe = _build(name, "chain")
        list(pipe())  # epoch 0; the stop lands in epoch 1
        it = pipe()
        for _ in range(stop):
            next(it)
        states[name] = pipe.state()
        rests[name] = _flat(list(it))
    assert json.dumps(states["port"], sort_keys=True) == \
        json.dumps(states["ref"], sort_keys=True)
    # the reference's state restored into a fresh port pipeline
    resumed = _build("port", "chain")
    resumed.restore(json.loads(json.dumps(states["ref"])))
    assert _flat(list(resumed())) == rests["ref"] == rests["port"]


def test_unseeded_shuffle_is_not_checkpointable():
    pipe = port_data.from_reader(_reader()).shuffle(4)
    with pytest.raises(ValueError, match="not checkpointable"):
        pipe.state()
    assert port_data.is_checkpointable(pipe)
    assert not port_data.is_checkpointable(_reader())


def test_prefetcher_state_tracks_consumed_not_staged():
    def feeds(pipe):
        return ({"x": np.stack([s[0] for s in b])} for b in pipe())

    pipe = port_data.from_reader(_reader()).batch(4)
    pf = port_data.CheckpointablePrefetcher(feeds(pipe), pipe, n_steps=2,
                                            place=tf.CPUPlace(), depth=2)
    it = iter(pf)
    first, count = next(it)
    assert count == 2
    import time
    deadline = time.monotonic() + 10.0
    while pipe.state()["stage"]["up"]["cursor"] <= 8 \
            and time.monotonic() < deadline:
        time.sleep(0.01)  # the staging thread runs ahead
    committed = pf.last_state
    head = pipe.state()
    pf.close()
    # the commit points past window 0 (8 samples), the head further on
    assert committed["stage"]["up"]["cursor"] == 8
    assert head["stage"]["up"]["cursor"] > 8
    # resuming there replays the staged lookahead, losing nothing
    resumed = port_data.from_reader(_reader()).batch(4)
    resumed.restore(committed)
    nxt = next(iter(resumed()))
    want = list(port_data.from_reader(_reader()).batch(4)())[2]
    assert _flat([nxt]) == _flat([want])


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=1))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, scope


def test_data_state_lies_under_success_in_the_reference_format(tmp_path):
    pipe = port_data.from_reader(_reader()).shuffle(8, seed=1).batch(4)
    it = pipe()
    next(it)
    state = pipe.state()
    files = {}
    for name, (fluid, trainer) in {"ref": (rf, ref_trainer),
                                   "port": (tf, port_trainer)}.items():
        exe, main, scope = _mlp(fluid)
        d = str(tmp_path / name)
        with fluid.scope_guard(scope):
            trainer.save_checkpoint(exe, d, main, trainer_args={},
                                    data_state=state)
        serial = os.path.join(d, "checkpoint_0")
        assert os.path.exists(os.path.join(serial, "_SUCCESS"))
        with open(os.path.join(serial, "data_state_0.json")) as f:
            files[name] = f.read()
        with fluid.scope_guard(scope):
            args = trainer.load_checkpoint(exe, d, main)
        assert args["data_state"] == state
    assert files["port"] == files["ref"]


def test_corrupt_data_state_falls_back_to_the_previous_serial(tmp_path):
    out = {}
    for name, (fluid, trainer, fault) in {
            "ref": (rf, ref_trainer, ref_fault),
            "port": (tf, port_trainer, port_fault)}.items():
        exe, main, scope = _mlp(fluid)
        d = str(tmp_path / name)
        with fluid.scope_guard(scope):
            trainer.save_checkpoint(exe, d, main, trainer_args={"step_id": 1},
                                    data_state={"v": 1})
            fault.install(fault.FaultPlan(shard_corrupt=True))
            trainer.save_checkpoint(exe, d, main, trainer_args={"step_id": 3},
                                    data_state={"v": 2})
            trainer.save_checkpoint(exe, d, main, trainer_args={"step_id": 5},
                                    data_state={"v": 3})  # one-shot
            fault.clear()
            # the newest serial is intact: drop it to reach the corrupt one
            import shutil
            shutil.rmtree(os.path.join(d, "checkpoint_2"))
            out[name] = trainer.load_checkpoint(exe, d, main)
    assert out["port"] == out["ref"] == {"step_id": 1,
                                         "data_state": {"v": 1}}


def test_data_stall_fault_sleeps_at_the_same_cursor(monkeypatch):
    slept = {}
    for name, fault in (("ref", ref_fault), ("port", port_fault)):
        calls = []
        monkeypatch.setattr(fault.time, "sleep",
                            lambda s, calls=calls: calls.append(s))
        fault.install(fault.FaultPlan(data_stall_ms=30.0, data_stall_at=5))
        pipe = PKGS[name].from_reader(_reader()).batch(4)
        batches = list(pipe())
        slept[name] = (calls, len(batches))
        fault.clear()
    assert slept["port"] == slept["ref"] == ([0.03], 10)


def test_wait_counters_count(monkeypatch):
    monkeypatch.setenv("PADDLE_DATA_STALL_EVENT_MS", "5")
    port_data.note_data_wait(0.001)
    port_data.note_data_wait(0.010)
    items = list(port_data.timed(iter([1, 2])))
    assert items == [1, 2]
    c = port_data.COUNTERS
    assert c["data.stall_events"] == 1
    assert c["data.wait_ms"] >= 11.0
    list(port_data.from_reader(_reader()).batch(8)())
    assert c["data.samples"] == 40 and c["data.bytes"] > 0


@pytest.mark.parametrize("spec,hosts", [("dp4", 4), ("dp2,tp2", 4),
                                        ("tp4", 2), ("dp8", 2),
                                        ("dp2", 1)])
def test_shard_spec_and_layout_match_reference(spec, hosts):
    for rank in range(hosts):
        assert port_sharding.shard_spec(spec, rank, hosts) == \
            ref_sharding.shard_spec(spec, rank, hosts)
    assert port_sharding.shard_layout(spec, hosts) == \
        ref_sharding.shard_layout(spec, hosts)
    assert port_sharding.data_axis_extent(spec) == \
        ref_sharding.data_axis_extent(spec)


def test_mesh_spec_errors_and_objects():
    with pytest.raises(ValueError, match="do not tile"):
        port_sharding.shard_spec("dp3", 0, 2)
    with pytest.raises(ValueError, match="bad mesh axis"):
        port_sharding.parse_mesh_spec("dp,4")
    with pytest.raises(TypeError, match="item 12"):
        port_sharding.axes_of(object())


def _elastic_pipe(data, n, num_shards, shard_index, batch):
    return (data.from_reader(_reader(n)).shuffle(16, seed=5)
            .shard(num_shards, shard_index).batch(batch))


def _committed(data, n, num_shards, batch, batches_each):
    states = {}
    for i in range(num_shards):
        p = _elastic_pipe(data, n, num_shards, i, batch)
        it = iter(p)
        for _ in range(batches_each):
            next(it)
        states[i] = p.state()
    return states


@pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4), (4, 1), (1, 4),
                                         (4, 4)])
def test_cursor_remap_matches_reference(old_n, new_n):
    states = _committed(port_data, 96, old_n, 12 // old_n, 2)
    assert states == _committed(ref_data, 96, old_n, 12 // old_n, 2)
    for j in range(new_n):
        port = port_sharding.merge_cursor_states(states, new_n, j)
        ref = ref_sharding.merge_cursor_states(states, new_n, j)
        assert port == ref
        p = _elastic_pipe(port_data, 96, new_n, j, 12 // new_n)
        p.restore(port)
        tail = [s[1] for b in p() for s in b]
        full = [s[1] for b in _elastic_pipe(port_data, 96, new_n, j,
                                            12 // new_n)() for s in b]
        assert tail == full[24 // new_n:]


def test_remap_data_state_matches_reference(tmp_path):
    states = _committed(port_data, 96, 2, 6, 2)
    layout = {0: (2, 0), 1: (2, 0), 2: (2, 1), 3: (2, 1)}
    for name, ckpt in (("ref", ref_ckpt), ("port", port_ckpt)):
        d = str(tmp_path / name)
        os.makedirs(d)
        for rank, (_, i) in layout.items():
            ckpt.save_data_state(d, states[i], rank=rank)
    for j in range(4):
        assert port_ckpt.remap_data_state(str(tmp_path / "port"), layout, 4,
                                          j) == \
            ref_ckpt.remap_data_state(str(tmp_path / "ref"), layout, 4, j)
    assert port_ckpt.load_all_data_states(str(tmp_path / "port")) == \
        ref_ckpt.load_all_data_states(str(tmp_path / "ref"))
