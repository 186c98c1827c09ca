"""The port's in-graph readers (``fluid.layers`` ``py_reader``,
``open_recordio_file``, ``open_files``, ``batch``, ``shuffle``,
``double_buffer``, ``Preprocessor``, ...) and the Executor's ``read`` op
held against the JAX package on the CPU: the same programs from both
packages' layer functions, the same seeded numpy data, the reference's
initialized scope copied into the port.

Tolerances: batches (fetched ``read_file`` outputs) and LoD offsets
bitwise; losses rtol 1e-5 (the two packages sum in other orders).
Within the port, a reader-fed program is bitwise its dict-fed twin.
"""

import random

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu.fluid import recordio_writer as ref_recordio_writer
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.fluid import recordio_writer
from paddle_tpu_torch.models.params import load_reference_params

LOSS_RTOL = 1e-5
PKGS = [rf, tf]
PKG_IDS = ["reference", "port"]


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _init(startup, scope):
    return {v.name: np.array(scope.get(v.name))
            for v in startup.list_vars() if v.persistable}


def _value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _until_eof(fluid, exe, main, fetches, scope=None):
    """Run ``main`` until the reader is exhausted: the fetched arrays of
    every step."""
    out = []
    while True:
        try:
            out.append([_value(v) for v in exe.run(
                main, fetch_list=fetches, scope=scope)])
        except fluid.core.EOFException:
            return out


def _mnist_style(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.py_reader(capacity=8,
                                        shapes=[[-1, 16], [-1, 1]],
                                        dtypes=["float32", "int64"])
        img, label = fluid.layers.read_file(reader)
        pred = fluid.layers.fc(img, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, reader, loss


def _mnist_batches():
    rng = np.random.RandomState(0)
    return [[rng.randn(8, 16).astype(np.float32),
             rng.randint(0, 4, size=(8, 1)).astype(np.int64)]
            for _ in range(12)]


def test_py_reader_trains_mnist_style_as_reference():
    """12 steps an epoch, 2 epochs of start / EOFException / reset."""
    batches = _mnist_batches()
    losses = {}
    for fluid in PKGS:
        main, startup, reader, loss = _mnist_style(fluid)
        reader.decorate_tensor_provider(lambda: iter(batches))
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        if fluid is rf:
            init = _init(startup, scope)
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        got = []
        for _ in range(2):
            reader.start()
            steps = _until_eof(fluid, exe, main, [loss], scope)
            reader.reset()
            assert len(steps) == 12
            got += [float(s[0].reshape(-1)[0]) for s in steps]
        losses[fluid] = got
    np.testing.assert_allclose(losses[tf], losses[rf], rtol=LOSS_RTOL)


@pytest.mark.parametrize("fluid", PKGS, ids=PKG_IDS)
def test_py_reader_paddle_reader_contract(fluid):
    """``decorate_paddle_reader`` takes minibatches (``paddle.batch``'s
    output) and keeps the declared batch dims; EOF after the last."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(capacity=4,
                                        shapes=[[-1, 3], [-1, 1]],
                                        dtypes=["float32", "int64"])
        x, y = fluid.layers.read_file(reader)
    rng = np.random.RandomState(0)
    samples = [(rng.randn(3).astype(np.float32).tolist(), [i % 2])
               for i in range(10)]
    reader.decorate_paddle_reader(lambda: iter([samples[:5], samples[5:]]))
    exe = fluid.Executor(fluid.CPUPlace())
    reader.start()
    out = [_value(v) for v in exe.run(main, fetch_list=[x, y])]
    assert out[0].shape == (5, 3) and out[1].shape == (5, 1)
    np.testing.assert_array_equal(
        out[0], np.array([s[0] for s in samples[:5]], np.float32))
    np.testing.assert_array_equal(out[1].reshape(-1), [0, 1, 0, 1, 0])
    exe.run(main, fetch_list=[x])
    with pytest.raises(fluid.core.EOFException):
        exe.run(main, fetch_list=[x])
    reader.reset()


@pytest.mark.parametrize("fluid", PKGS, ids=PKG_IDS)
def test_py_reader_producer_error_propagates(fluid):
    """A failing data source raises RuntimeError, not a silent EOF."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(capacity=4, shapes=[[-1, 2]],
                                        dtypes=["float32"])
        x = fluid.layers.read_file(reader)

    def provider():
        yield [np.zeros((2, 2), np.float32)]
        raise ValueError("bad record")

    reader.decorate_tensor_provider(provider)
    exe = fluid.Executor(fluid.CPUPlace())
    reader.start()
    exe.run(main, fetch_list=[x])
    with pytest.raises(RuntimeError, match="producer thread failed"):
        while True:
            exe.run(main, fetch_list=[x])
    reader.reset()


def _feeder_samples(fluid, n=20):
    rng = np.random.RandomState(1)
    samples = [(rng.randn(6).astype(np.float32),
                np.array([i % 3], np.int64)) for i in range(n)]
    prep, prep_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prep, prep_startup):
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="int64")
        feeder = fluid.DataFeeder(feed_list=[x, y], place=fluid.CPUPlace())
    return samples, feeder


def test_open_recordio_file_batches_as_reference(tmp_path):
    """``convert_reader_to_recordio_file`` -> ``open_recordio_file`` ->
    ``batch(5)``: the same file bytes, the same batches bitwise, EOF after
    20 samples."""
    got = {}
    files = {}
    for fluid, writer in ((rf, ref_recordio_writer), (tf, recordio_writer)):
        samples, feeder = _feeder_samples(fluid)
        path = str(tmp_path / f"{fluid.__name__}.recordio")
        assert writer.convert_reader_to_recordio_file(
            path, lambda: iter(samples), feeder) == 20
        files[fluid] = open(path, "rb").read()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            reader = fluid.layers.open_recordio_file(
                path, shapes=[[-1, 6], [-1, 1]], dtypes=["float32", "int64"])
            reader = fluid.layers.batch(reader, batch_size=5)
            xv, yv = fluid.layers.read_file(reader)
        exe = fluid.Executor(fluid.CPUPlace())
        reader.start()
        got[fluid] = _until_eof(fluid, exe, main, [xv, yv])
        reader.reset()
    assert files[tf] == files[rf]
    assert len(got[tf]) == len(got[rf]) == 4
    for a, b in zip(got[tf], got[rf]):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("threads", [1, 2])
def test_open_files_batches_as_reference(tmp_path, threads):
    """``convert_reader_to_recordio_files`` (3 shards of up to 7 samples)
    -> ``open_files`` -> ``batch(4)``: one thread keeps the file order,
    bitwise the reference's batches; two threads deliver the same samples
    (rows bitwise, as a multiset)."""
    got = {}
    for fluid, writer in ((rf, ref_recordio_writer), (tf, recordio_writer)):
        samples, feeder = _feeder_samples(fluid)
        paths = writer.convert_reader_to_recordio_files(
            str(tmp_path / f"{fluid.__name__}.recordio"), 7,
            lambda: iter(samples), feeder)
        assert len(paths) == 3
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            reader = fluid.layers.open_files(
                paths, shapes=[[-1, 6], [-1, 1]],
                dtypes=["float32", "int64"], thread_num=threads)
            reader = fluid.layers.batch(reader, 4)
            xv, yv = fluid.layers.read_file(reader)
        exe = fluid.Executor(fluid.CPUPlace())
        reader.start()
        got[fluid] = _until_eof(fluid, exe, main, [xv, yv])
        reader.reset()
    assert len(got[tf]) == len(got[rf]) == 5
    if threads == 1:
        for a, b in zip(got[tf], got[rf]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    else:
        rows = {fluid: sorted(
            tuple(x.tobytes()) + tuple(y.tobytes())
            for step in out for x, y in zip(step[0], step[1]))
            for fluid, out in got.items()}
        assert rows[tf] == rows[rf]


def test_random_data_generator_bitwise():
    got = {}
    for fluid in PKGS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            rd = fluid.layers.random_data_generator(-2.0, 2.0,
                                                    shapes=[[8, 4], [-1, 3]])
            xr, zr = fluid.layers.read_file(rd)
        exe = fluid.Executor(fluid.CPUPlace())
        rd.start()
        got[fluid] = [[_value(v) for v in exe.run(main,
                                                  fetch_list=[xr, zr])]
                      for _ in range(3)]
        rd.reset()
    for a, b in zip(got[tf], got[rf]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert got[tf][0][0].shape == (8, 4) and got[tf][0][1].shape == (1, 3)
    assert np.abs(got[tf][0][0]).max() <= 2.0


SMALL_LOD = dict(vocab=50, emb=8, batch=4, shuffle_buf=8)


def _lod_samples():
    return chip_smoke.lod_samples(n=40, vocab=50, max_len=6)


def test_batch_lod_merge_and_shuffle_train_as_reference():
    """``py_reader`` with a LoD slot through a seeded ``shuffle`` and
    ``batch`` into embedding -> sequence_pool -> fc -> xent under SGD, 2
    epochs: the merged LoD offsets equal, losses rtol 1e-5, 10 steps an
    epoch."""
    samples = _lod_samples()
    runs = {}
    for fluid in PKGS:
        progs = chip_smoke.reader_lod_programs(fluid, **SMALL_LOD)
        runs[fluid] = chip_smoke.lod_reader_epochs(
            fluid, progs, samples, fluid.CPUPlace(),
            init=runs[rf][3] if fluid is tf else None)
    (losses, lods, steps, _), (ref_losses, ref_lods, ref_steps, _) = \
        runs[tf], runs[rf]
    assert steps == ref_steps == [10, 10]
    assert lods == ref_lods
    # 4 sequences a batch, merged from one-sample records
    assert all(len(lod) == 1 and len(lod[0]) == 5 for lod in lods)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)


def test_shuffle_follows_the_seeded_random_module():
    """The shuffle draws from ``random``: a seed fixes the order, which
    equals the reference's under that seed."""
    samples = [([i, i + 1], [i % 3]) for i in range(12)]
    order = {}
    for fluid in PKGS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            rd = fluid.layers.py_reader(capacity=4, shapes=[[-1, 1], [-1, 1]],
                                        dtypes=["int64", "int64"],
                                        lod_levels=[1, 0])
            rd = fluid.layers.batch(fluid.layers.shuffle(rd, 5), 3)
            words, label = fluid.layers.read_file(rd)
        rd.decorate_paddle_reader(lambda: ([s] for s in samples))
        exe = fluid.Executor(fluid.CPUPlace())
        random.seed(4)
        rd.start()
        order[fluid] = [_value(v).reshape(-1).tolist() for step in
                        _until_eof(fluid, exe, main, [label]) for v in step]
        rd.reset()
    assert order[tf] == order[rf]
    assert sorted(sum(order[tf], [])) == sorted(s[1][0] for s in samples)


def test_create_py_reader_by_data_builds_the_same_program():
    samples = _lod_samples()
    plain = chip_smoke.reader_lod_programs(tf, **SMALL_LOD)
    got = chip_smoke.lod_reader_epochs(tf, plain, samples, tf.CPUPlace())
    port_framework.fresh_session()
    by_data = chip_smoke.reader_lod_programs(tf, by_data=True, **SMALL_LOD)
    assert [op.type for op in by_data["main"].global_block().ops] == \
        [op.type for op in plain["main"].global_block().ops]
    assert by_data["words"].lod_level == 1
    again = chip_smoke.lod_reader_epochs(tf, by_data, samples, tf.CPUPlace(),
                                         init=got[3])
    assert again[0] == got[0] and again[1] == got[1]


@pytest.mark.parametrize("fluid", PKGS, ids=PKG_IDS)
def test_preprocessor_transforms_reader_batches(fluid):
    """The reference's ``test_layers_tensor.py`` Preprocessor case: a
    ``scale`` sub-program applied to every batch before the read op."""
    rd = fluid.layers.py_reader(capacity=8, shapes=[[-1, 4], [-1, 1]],
                                dtypes=["float32", "int64"])
    pre = fluid.layers.Preprocessor(rd)
    with pre.block():
        img, lbl = pre.inputs()
        img2 = fluid.layers.scale(img, scale=0.01)
        pre.outputs(img2, lbl)
    x, y = fluid.layers.read_file(pre())
    m = fluid.layers.reduce_mean(x)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    st = rd._reader_state
    st._source = lambda: iter(
        [[(np.full((2, 4), 100.0, np.float32), None),
          (np.array([[1], [0]], np.int64), None)]] * 3)
    rd.start()
    v, yv = exe.run(fluid.default_main_program(), fetch_list=[m, y])
    assert abs(float(np.asarray(v).reshape(-1)[0]) - 1.0) < 1e-5
    np.testing.assert_array_equal(_value(yv), [[1], [0]])
    rd.reset()


def _provider_batches():
    rng = np.random.RandomState(7)
    return [[rng.randn(3, 5).astype(np.float32),
             (rng.randint(0, 9, size=(6, 1)).astype(np.int64), [[2, 4]])]
            for _ in range(4)]


@pytest.mark.parametrize("double", [False, True], ids=["plain", "double"])
def test_double_buffer_is_the_identity_on_the_cpu(double):
    """With ``double_buffer`` on ``CPUPlace()`` the read op hands out CPU
    tensors (staged a batch ahead), bitwise the batches without it, LoD
    included."""
    batches = _provider_batches()
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        rd = tf.layers.py_reader(capacity=2, shapes=[[-1, 5], [-1, 1]],
                                 dtypes=["float32", "int64"],
                                 lod_levels=[0, 1], use_double_buffer=False)
        if double:
            rd = tf.layers.double_buffer(rd, place=tf.CPUPlace())
        x, ids = tf.layers.read_file(rd)
    rd.decorate_tensor_provider(lambda: iter(batches))
    exe = tf.Executor(tf.CPUPlace())
    rd.start()
    got = []
    while True:
        try:
            got.append(exe.run(main, fetch_list=[x, ids],
                               return_numpy=False))
        except tf.core.EOFException:
            break
    rd.reset()
    assert len(got) == 4
    for (gx, gids), (bx, (bids, lens)) in zip(got, batches):
        np.testing.assert_array_equal(_value(gx), bx)
        np.testing.assert_array_equal(_value(gids), bids)
        assert gids.lod() == ((0, 2, 6),)
    state = rd._reader_state
    assert (state.double_buffer is not None) == double
    if double:
        rd.start()
        batch = state.next_batch(torch.device("cpu"))
        rd.reset()
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v, _ in batch)
        np.testing.assert_array_equal(batch[0][0].numpy(), batches[0][0])


def test_double_buffer_stops_its_thread_on_reset():
    import threading

    rd = tf.layers.py_reader(capacity=2, shapes=[[-1, 5], [-1, 1]],
                             dtypes=["float32", "int64"],
                             lod_levels=[0, 1])
    x, ids = tf.layers.read_file(rd)
    rd.decorate_tensor_provider(lambda: iter(_provider_batches() * 50))
    exe = tf.Executor(tf.CPUPlace())
    before = threading.active_count()
    for _ in range(3):
        rd.start()
        exe.run(tf.default_main_program(), fetch_list=[x])
        rd.reset()
    assert threading.active_count() == before


def test_read_op_added_after_a_run_is_popped():
    """A program run once without a reader, then given a ``read`` op, pops
    its reader on the next run (the Executor's list of read ops follows
    the program's version)."""
    batches = _provider_batches()
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup):
        a = tf.layers.data("a", shape=[5], dtype="float32")
        a2 = tf.layers.scale(a, scale=2.0)
    exe = tf.Executor(tf.CPUPlace())
    feed_a = np.ones((2, 5), np.float32)
    out, = exe.run(main, feed={"a": feed_a}, fetch_list=[a2])
    np.testing.assert_array_equal(_value(out), 2 * feed_a)
    with tf.program_guard(main, startup):
        rd = tf.layers.py_reader(capacity=2, shapes=[[-1, 5], [-1, 1]],
                                 dtypes=["float32", "int64"],
                                 lod_levels=[0, 1], use_double_buffer=False)
        x, _ = tf.layers.read_file(rd)
        x2 = tf.layers.scale(x, scale=2.0)
    rd.decorate_tensor_provider(lambda: iter(batches))
    rd.start()
    got = _until_eof(tf, exe, main, [x2])
    rd.reset()
    assert len(got) == len(batches)
    for (gx,), (bx, _) in zip(got, batches):
        np.testing.assert_array_equal(gx, 2 * bx)


def test_read_op_under_clone_for_test_and_run_steps_as_reference():
    """As in the reference: the test clone keeps the reader ops and pops a
    batch a run; ``run_steps`` pops nothing, raises when the read op's
    outputs are not fed, and runs on them when they are."""
    batches = [[np.random.RandomState(k).randn(8, 16).astype(np.float32),
                np.full((8, 1), k % 4, np.int64)] for k in range(6)]
    rs_x = np.random.RandomState(9).randn(2, 8, 16).astype(np.float32)
    rs_y = np.zeros((2, 8, 1), np.int64)
    out = {}
    for fluid in PKGS:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            reader = fluid.layers.py_reader(capacity=8,
                                            shapes=[[-1, 16], [-1, 1]],
                                            dtypes=["float32", "int64"])
            img, label = fluid.layers.read_file(reader)
            pred = fluid.layers.fc(img, size=4, act="softmax")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
            test = main.clone(for_test=True)
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        assert [op.type for op in test.global_block().ops][:2] == \
            ["create_py_reader", "read"]
        assert main.global_block().var(reader.name).type == \
            fluid.core.VarType.READER == 28
        reader.decorate_tensor_provider(lambda: iter(batches))
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        if fluid is rf:
            init = _init(startup, scope)
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        reader.start()
        got = [exe.run(test, fetch_list=[loss], scope=scope)[0]]
        got.append(exe.run(main, fetch_list=[loss], scope=scope)[0])
        with pytest.raises(RuntimeError):
            exe.run_steps(main, feed={}, fetch_list=[loss], n_steps=2,
                          scope=scope)
        got.append(exe.run_steps(
            main, feed={img.name: rs_x, label.name: rs_y},
            fetch_list=[loss], n_steps=2, scope=scope,
            feed_per_step=True)[0])
        # the window popped nothing: the next run takes batch 3
        got.append(exe.run(main, fetch_list=[loss], scope=scope)[0])
        got.append(exe.run(test, fetch_list=[img], scope=scope)[0])
        reader.reset()
        out[fluid] = got
    for a, b in zip(out[tf][:4], out[rf][:4]):
        np.testing.assert_allclose(_value(a), _value(b), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(_value(out[tf][4]), batches[3][0])
    np.testing.assert_array_equal(_value(out[rf][4]), batches[3][0])


def test_reader_var_is_neither_fed_nor_state():
    """The plan of a reader-fed program, and a ``ProgramGraph`` over it,
    read no reader var from the scope and run no reader op."""
    from paddle_tpu_torch.fluid.executor import BlockPlan
    from paddle_tpu_torch.fluid.program_graph import ProgramGraph

    main, startup, reader, loss = _mnist_style(tf)
    read = next(op for op in main.global_block().ops if op.type == "read")
    plan = BlockPlan(main, read.outputs["Out"], [loss.name])
    assert reader.name not in plan.state_in
    assert not {op.type for op in plan.ops} & {"read", "create_py_reader"}
    assert all(not n.startswith(reader.name) for n in plan.state_out)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    x, y = _mnist_batches()[0]
    graph = ProgramGraph(main.clone(for_test=True),
                         dict(zip(read.outputs["Out"], (x, y))),
                         [loss.name], scope, "cpu")
    assert reader.name not in graph.state
    assert set(graph.state) <= {v.name for v in startup.list_vars()}


@pytest.mark.parametrize("fluid", PKGS, ids=PKG_IDS)
def test_parallel_do_raises(fluid):
    with pytest.raises(NotImplementedError, match="ParallelExecutor"):
        fluid.layers.ParallelDo(None)


def test_resnet_reader_program_equals_its_dict_fed_twin(tmp_path):
    """``chip_smoke``'s reader-fed ResNet-50 (``open_files`` -> ``batch``
    -> ``double_buffer`` -> ``read_file``, shards from
    ``convert_reader_to_recordio_files``, one zlib and one not) at 64 px
    on the CPU: batches bitwise the numpy batches, losses bitwise the
    dict-fed ``build_resnet`` twin's from the same initial scope, EOF after
    the last batch."""
    from paddle_tpu_torch.models import resnet

    imgs, labels = chip_smoke.reader_image_samples(n=6, hw=64, classes=10)
    paths = chip_smoke.write_image_shards(tf, str(tmp_path), imgs, labels)
    assert len(paths) == 2
    progs = chip_smoke.resnet_reader_programs(tf, resnet, paths, batch=2,
                                              hw=64, classes=10)
    twin_main, twin_startup, twin_loss, _ = chip_smoke.build_resnet(
        image_hw=64, class_dim=10)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(progs["startup"], scope=scope)
    twin_scope = chip_smoke.clone_scope(scope)
    progs["reader"].start()
    fed = _until_eof(tf, exe, progs["main"],
                     [progs["loss"], progs["img"], progs["label"]], scope)
    progs["reader"].reset()
    assert len(fed) == 3
    twin = []
    for k, step in enumerate(fed):
        x, y = imgs[2 * k:2 * k + 2], labels[2 * k:2 * k + 2]
        np.testing.assert_array_equal(step[1], x)
        np.testing.assert_array_equal(step[2], y)
        twin.append(exe.run(twin_main, feed={"img": x, "label": y},
                            fetch_list=[twin_loss], scope=twin_scope)[0])
    assert [s[0].tolist() for s in fed] == [t.tolist() for t in twin]
