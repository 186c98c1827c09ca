"""``chip_smoke.py``'s CTC recognizer (``im2sequence`` -> ``lod_reset`` ->
fc -> a GRU each way -> fc -> ``warpctc``, Adam; decoded by
``ctc_greedy_decoder`` and scored by ``edit_distance`` through
``fluid.evaluator.EditDistance``) in the port against the JAX package,
on the CPU, with ``chip_smoke.ctc_programs`` building it in both:

 - at the chip's widths the port builds the reference's programs (train,
   test and the evaluator's startup): the same op types in order and the
   same parameters;
 - at a small width (2 images of 1 x 8 x 32, kernel [8, 4]: 8 frames a
   sequence, hidden 8, 6 classes + the blank, labels of 1-3 ids), from the
   reference's initial scope, 3 Adam steps: the losses within rtol 1e-5
   at step 0 and 1e-4 after; then, from the reference's trained state,
   the greedy decode (ids and LoD) and the edit distances equal the
   reference's exactly, and the evaluator's average distance and error
   share over the decoded batches equal the reference's (rtol 1e-6).
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

SMALL = dict(batch=2, image=(1, 8, 32), kernel=(8, 4), hidden=8, classes=6)
STEPS = 3


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def _params(prog):
    return [(p.name, tuple(p.shape))
            for p in prog.global_block().all_parameters()]


def test_same_programs_at_chip_width():
    ref, port = chip_smoke.ctc_programs(rf), chip_smoke.ctc_programs(tf)
    for key in ("main", "startup", "test", "eval_startup"):
        assert _types(port[key]) == _types(ref[key]), key
    assert _params(port["main"]) == _params(ref["main"])
    assert len(_params(port["main"])) == chip_smoke.CTC_ADAM_TENSORS
    types = _types(port["main"])
    assert types[:2] == ["im2sequence", "lod_reset"]
    assert types.count("adam") == chip_smoke.CTC_ADAM_TENSORS
    assert "ctc_align" in _types(port["test"])
    assert "edit_distance" in _types(port["test"])


def _feeds(n, seed):
    rng = np.random.RandomState(seed)
    return [chip_smoke.ctc_feed(rng, batch=SMALL["batch"],
                                image=SMALL["image"],
                                classes=SMALL["classes"], label_lens=(1, 3))
            for _ in range(n)]


def _snapshot(scope, programs):
    return {v.name: np.array(scope.get(v.name)).copy()
            for prog in programs for v in prog.list_vars() if v.persistable}


def test_small_ctc_trains_and_decodes_as_reference():
    feeds, decode_feeds = _feeds(STEPS, 0), _feeds(2, 1)
    losses, decoded, evals = {}, {}, {}
    init = trained = None
    for pkg in (rf, tf):
        p = chip_smoke.ctc_programs(pkg, **SMALL)
        starts = (p["startup"], p["eval_startup"])
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        for prog in starts:
            exe.run(prog, scope=scope)
        if init is None:
            init = _snapshot(scope, starts)
        else:
            load_reference_params(scope, init, tf.CPUPlace())
        losses[pkg] = np.array([float(np.asarray(exe.run(
            p["main"], feed=f, fetch_list=[p["cost"]],
            scope=scope)[0]).reshape(-1)[0]) for f in feeds])
        if trained is None:
            trained = _snapshot(scope, starts)
        else:
            load_reference_params(scope, trained, tf.CPUPlace())
        ev = p["evaluator"]
        with pkg.scope_guard(scope):
            ev.reset(exe)
            decoded[pkg] = [exe.run(p["test"], feed=f, fetch_list=[
                p["decoded"], *ev.metrics], return_numpy=False)
                for f in decode_feeds]
            evals[pkg] = ev.eval(exe)
    tol = np.array([1e-5] + [1e-4] * (STEPS - 1))
    np.testing.assert_array_less(
        np.abs(losses[tf] - losses[rf]) / np.abs(losses[rf]), tol)
    for r_batch, t_batch in zip(decoded[rf], decoded[tf]):
        for r, t in zip(r_batch, t_batch):
            np.testing.assert_array_equal(np.asarray(t), np.asarray(r))
            assert np.asarray(t).dtype == np.asarray(r).dtype
        assert t_batch[0].lod() == \
            tuple(tuple(level) for level in r_batch[0].lod())
    for r, t in zip(evals[rf], evals[tf]):
        np.testing.assert_allclose(np.asarray(t), np.asarray(r), rtol=1e-6)
