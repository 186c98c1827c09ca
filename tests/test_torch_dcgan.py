"""DCGAN (``chip_smoke.dcgan_programs``) in the port against the JAX
package, on the CPU, at 16 x 16 images, base width 16, batch 8:

 - the D and G training Programs and their shared startup: the same op
   types in order with the same attrs, slots and variable names, and the
   same parameters, in both packages; the noise op and the Adam ops
   (one per parameter of each side) are where they should be;
 - 3 iterations of one D step and one G step from the reference's initial
   scope (``load_reference_params``) with the noise fed from numpy, in
   float64: each step's loss and every persistable (parameters,
   batch-norm statistics, Adam moments) within rtol 1e-5 at the first
   iteration and 1e-4 after (the atol of a tensor is rtol times its
   largest magnitude); in float32, each step from the reference's state:
   the loss, and each persistable in the 2-norm, within the same rtol;
 - ``chip_smoke.adam_step_check``, the card's parity check of a step,
   passes the same step in float64 against float32 at the first
   iteration's rtol, and fails when an update is skipped (a batch norm's
   bias, D's fc bias, a moment) or a batch-norm statistic, a moment or a
   gradient parts;
 - with the noise drawn in the Program, each step's noise lies in
   [-1, 1] with the batch's rows, and differs between the two Programs
   and from step to step.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu.fluid as rf
import paddle_tpu_torch.fluid as tf
from paddle_tpu.fluid import framework as ref_framework
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.models.params import load_reference_params

ITERS = chip_smoke.DCGAN_PARITY_ITERS
IMAGE = chip_smoke.DCGAN_SMALL["image"]
RTOL = [1e-5] + [1e-4] * (ITERS - 1)


@pytest.fixture(autouse=True)
def fresh_sessions():
    port_framework.fresh_session()
    ref_framework.fresh_session()
    yield


def _desc(program):
    block = program.global_block()
    ops = [(op.type, {s: list(v) for s, v in op.inputs.items()},
            {s: list(v) for s, v in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if not k.startswith("op_")})
           for op in block.ops]
    var_list = sorted((v.name, tuple(v.shape) if v.shape is not None
                       else None, str(v.dtype)) for v in block.vars.values())
    params = [(p.name, tuple(p.shape), p.trainable)
              for p in block.all_parameters()]
    return ops, var_list, params


def _small(pkg, **kw):
    return chip_smoke.dcgan_programs(pkg, **{**chip_smoke.DCGAN_SMALL, **kw})


def test_dcgan_programs_match_reference():
    ref, port = _small(rf), _small(tf)
    for key in ("d", "g", "startup"):
        assert _desc(port[key]) == _desc(ref[key]), key
    for key in ("d_params", "g_params", "d_loss", "g_loss"):
        assert port[key] == ref[key], key
    assert len(port["d_params"]) == chip_smoke.DCGAN_D_TENSORS
    assert len(port["g_params"]) == chip_smoke.DCGAN_G_TENSORS
    for side in ("d", "g"):
        types = [op.type for op in port[side].global_block().ops]
        assert types.count("adam") == len(port[f"{side}_params"])
        assert types.count("conv2d_transpose") == 4
        assert "conv2d_transpose_grad" in types if side == "g" else \
            "conv2d_transpose_grad" not in types
    drawn = _small(tf, feed_noise=False)
    for side in ("d", "g"):
        types = [op.type for op in drawn[side].global_block().ops]
        assert types.count("uniform_random_batch_size_like") == 1


def _snapshot(scope, startup):
    return {v.name: np.array(scope.get(v.name)).copy()
            for v in startup.list_vars() if v.persistable}


def _start(pkg, progs, init):
    """An executor and scope after the startup; the port's scope then
    holds ``init`` (the reference's state)."""
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(progs["startup"], scope=scope)
    if init is not None:
        load_reference_params(scope, init, tf.CPUPlace())
    return exe, scope


def _step(exe, scope, progs, side, img, z):
    loss = exe.run(progs[side], feed={"img": img, "noise": z},
                   fetch_list=[progs[f"{side}_loss"]], scope=scope)[0]
    return float(np.asarray(loss).reshape(-1)[0])


def _data(dtype):
    rng = np.random.RandomState(5)
    batch = chip_smoke.DCGAN_SMALL_BATCH
    batches = [chip_smoke.dcgan_batch(rng, batch, IMAGE).astype(dtype)
               for _ in range(ITERS)]
    noises = [[rng.uniform(-1, 1, (batch, chip_smoke.DCGAN_NZ)).astype(dtype)
               for _ in range(2)] for _ in range(ITERS)]
    return batches, noises


def test_dcgan_alternating_adam_matches_reference_float64():
    """Free-running in float64: the port's arithmetic is the reference's
    (float32 is held step by step below)."""
    batches, noises = _data(np.float64)
    progs = {pkg: _small(pkg, dtype="float64") for pkg in (rf, tf)}
    runs = {rf: _start(rf, progs[rf], None)}
    init = _snapshot(runs[rf][1], progs[rf]["startup"])
    runs[tf] = _start(tf, progs[tf], init)
    assert any(n.startswith("g_deconv") for n in init)
    assert any("moment" in n for n in init)
    assert all(init[n].dtype == np.float64
               for n in progs[tf]["d_params"] + progs[tf]["g_params"])
    for k in range(ITERS):
        for side, z in zip(("d", "g"), noises[k]):
            losses = [_step(*runs[pkg], progs[pkg], side, batches[k], z)
                      for pkg in (rf, tf)]
            np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL[k],
                                       err_msg=f"{side} loss, iteration {k}")
            want = _snapshot(runs[rf][1], progs[rf]["startup"])
            got = _snapshot(runs[tf][1], progs[tf]["startup"])
            for n in sorted(want):
                np.testing.assert_allclose(
                    got[n], want[n], rtol=RTOL[k],
                    atol=RTOL[k] * float(np.abs(want[n]).max(initial=0.0)),
                    err_msg=f"{n} after the {side} step, iteration {k}")


def test_dcgan_float32_steps_match_reference():
    """float32, each step from the reference's state (as the card's parity
    phase does): the loss within rtol, and each persistable within rtol
    in the 2-norm (``chip_smoke.norm_rel_err``; the card's phase holds the
    parameters as one vector).  Adam moves an element whose grad is at
    float32 rounding level (about 1e-7 of the tensor's largest) by about
    the learning rate in either package, so single elements part by
    more, and free-running states part further each step."""
    batches, noises = _data(np.float32)
    progs = {pkg: _small(pkg) for pkg in (rf, tf)}
    runs = {rf: _start(rf, progs[rf], None)}
    runs[tf] = _start(tf, progs[tf], _snapshot(runs[rf][1],
                                                progs[rf]["startup"]))
    for k in range(ITERS):
        for side, z in zip(("d", "g"), noises[k]):
            load_reference_params(
                runs[tf][1], _snapshot(runs[rf][1], progs[rf]["startup"]),
                tf.CPUPlace())
            losses = [_step(*runs[pkg], progs[pkg], side, batches[k], z)
                      for pkg in (rf, tf)]
            np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL[k],
                                       err_msg=f"{side} loss, iteration {k}")
            want = _snapshot(runs[rf][1], progs[rf]["startup"])
            got = _snapshot(runs[tf][1], progs[tf]["startup"])
            errs = {n: chip_smoke.norm_rel_err(got[n], want[n])
                    for n in want}
            assert max(errs.values()) <= RTOL[k], (side, k, errs)


def test_dcgan_draws_its_noise_in_the_program():
    progs = _small(tf, feed_noise=False)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(progs["startup"], scope=scope)
    img = chip_smoke.dcgan_batch(np.random.RandomState(1), 8, IMAGE)
    draws = []
    for _ in range(2):
        for side in ("d", "g"):
            loss, z = exe.run(progs[side], feed={"img": img},
                              fetch_list=[progs[f"{side}_loss"],
                                          progs[f"{side}_noise"]],
                              scope=scope)
            assert np.isfinite(loss).all()
            assert z.shape == (8, chip_smoke.DCGAN_NZ)
            assert z.dtype == np.float32
            assert -1.0 <= z.min() and z.max() <= 1.0
            draws.append(z)
    for i in range(len(draws)):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j])


@pytest.fixture(scope="module")
def float64_steps():
    """Iteration 0's D and G steps of the small DCGAN in the port, each
    from the float32 run's state: the float32 run's state and gradients
    (``want``) and the same step in float64 cast back (``got``: rounding
    apart, the same arithmetic)."""
    port_framework.fresh_session()
    progs = _small(tf)
    port_framework.fresh_session()
    exact = _small(tf, dtype="float64")
    batches, noises = _data(np.float32)
    runs = []
    for p in (progs, exact):
        exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
        exe.run(p["startup"], scope=scope)
        runs.append((exe, scope))
    wide = {n: v.dtype for n, v in _snapshot(runs[1][1],
                                             exact["startup"]).items()}
    slots = chip_smoke.adam_slots(progs["d"])
    slots.update(chip_smoke.adam_slots(progs["g"]))
    steps = {}
    for side, z in zip(("d", "g"), noises[0]):
        before = _snapshot(runs[0][1], progs["startup"])
        load_reference_params(runs[1][1], {n: v.astype(wide[n])
                                           for n, v in before.items()},
                              tf.CPUPlace())
        params = progs[f"{side}_params"]
        out = []
        for (exe, scope), p, dtype in zip(runs, (progs, exact),
                                          (np.float32, np.float64)):
            grads = exe.run(p[side], feed={"img": batches[0].astype(dtype),
                                           "noise": z.astype(dtype)},
                            fetch_list=[g + "@GRAD" for g in params],
                            scope=scope)
            after = _snapshot(scope, p["startup"])
            out.append(({n: v.astype(before[n].dtype)
                         for n, v in after.items()},
                        {n: np.asarray(g).astype(np.float32)
                         for n, g in zip(params, grads)}))
        steps[side] = (before, *out)
    port_framework.fresh_session()
    return slots, steps


def _check(slots, step, got=None, got_grads=None):
    before, (want, want_grads), (got_, grads_) = step
    return chip_smoke.adam_step_check(
        slots, before, want, got_ if got is None else got, want_grads,
        grads_ if got_grads is None else got_grads, RTOL[0])


def test_adam_step_check_admits_float32_rounding(float64_steps):
    """float64 arithmetic passes the card's per-tensor check against the
    float32 run at the first iteration's rtol; the elements it leaves out
    of the state's check are elements of updated parameters, under 0.1 %
    of them."""
    slots, steps = float64_steps
    for side, step in steps.items():
        held = _check(slots, step)
        assert held["worst"]["state"][1] <= RTOL[0]
        grads = step[1][1]
        assert set(held["left_out"]) <= set(grads)
        size = sum(g.size for g in grads.values())
        assert sum(held["left_out"].values()) < 1e-3 * size, held["left_out"]


def _skip_update(step, name):
    before, _, (got, grads) = step
    return {**got, name: before[name].copy()}, grads


def _nudge(step, name, scale):
    _, _, (got, grads) = step
    return {**got, name: got[name] * np.float32(scale)}, grads


def _bump_grad(step, name, frac):
    """One element of ``name``'s gradient moved by ``frac`` of the
    tensor's largest |grad|."""
    _, _, (got, grads) = step
    g = grads[name].copy()
    g.flat[7] += np.float32(frac) * np.abs(g).max()
    return got, {**grads, name: g}


@pytest.mark.parametrize("side, fault", [
    ("g", lambda s: _skip_update(s, "g_bn1.bias")),
    ("d", lambda s: _skip_update(s, "d_fc.b")),
    ("g", lambda s: _nudge(s, "g_bn1.mean", 1.001)),
    ("d", lambda s: _skip_update(s, "moment1_d_conv0.w_0")),
    ("g", lambda s: _nudge(s, "moment2_g_deconv0.w_0", 1.001)),
    ("d", lambda s: _bump_grad(s, "d_conv0.w", 0.01)),
], ids=["skipped_g_bn1_bias", "skipped_d_fc_b", "bn_mean_off",
        "skipped_first_moment", "second_moment_off", "grad_element_off"])
def test_adam_step_check_catches_a_fault(float64_steps, side, fault):
    slots, steps = float64_steps
    with pytest.raises(AssertionError):
        _check(slots, steps[side], *fault(steps[side]))
