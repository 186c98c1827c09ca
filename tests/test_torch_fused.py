"""The plain versions of the port's softmax-cross-entropy and Adam kernels
(``paddle_tpu_torch/ops/fused.py``) against the Pallas kernels they stand
beside (``paddle_tpu/ops/pallas_fused.py``), run in interpret mode on the
CPU as the JAX package's own tests run them.  Same seeded numpy inputs on
both sides.

Shapes include a vocab (600) that is not a multiple of the TPU kernel's
512-column block, soft labels, and hard labels with ``ignore_index``; and
the narrow rows the CUDA kernels tile whole (V = 2, 21, 81 and the even
128, at R = 333 and 1,000 rows: no whole number of tiles), hard labels
with ``ignore_index`` and one label outside ``[0, V)``, or soft labels.

Tolerances: loss and lse rtol 1e-5 / atol 1e-5 (both float32; the Pallas
kernel carries an online max/sum across vocab tiles, the plain version
takes max then sum); dx rtol 1e-5 / atol 1e-6; Adam rtol 1e-6 / atol 1e-6,
as ``tests/test_pallas_fused.py`` holds the Pallas Adam to its formula.
The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu_torch.fluid import framework as port_framework
from paddle_tpu_torch.ops import fused

XENT_TOL = dict(rtol=1e-5, atol=1e-5)
DX_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_port_session():
    port_framework.fresh_session()
    yield


def _xent_inputs(r, v, soft, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, v)) * 3).astype(np.float32)
    if soft:
        y = rng.random((r, v)).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
        return x, y
    lab = rng.integers(0, v, r).astype(np.int64)
    lab[::5] = 3  # rows with the ignored label
    return x, lab


CASES = [(24, 600, True, -100), (24, 600, False, 3), (16, 1024, False, -100),
         (8, 512, True, -100)]
IDS = ["soft-v600", "hard-ignore-v600", "hard-v1024", "soft-v512"]
# narrow rows: SSD's 21 classes, the R-CNN head's 81, a binary head and an
# even width
NARROW_CASES = [(333, 2, False, 1), (1000, 2, True, -100),
                (1000, 21, False, 0), (333, 21, True, -100),
                (333, 81, False, 0), (1000, 81, True, -100),
                (1000, 128, False, 7), (333, 128, True, -100)]
NARROW_IDS = [f"{'soft' if soft else 'hard-ignore'}-v{v}-r{r}"
              for r, v, soft, _ in NARROW_CASES]


def _narrow_inputs(r, v, soft, ignore, seed=2):
    """Logits and labels: hard labels with every 5th row at ``ignore`` and
    one label outside ``[0, V)`` (it picks nothing), or soft rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, v)) * 3).astype(np.float32)
    if soft:
        y = rng.random((r, v)).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
        return x, y
    lab = rng.integers(0, v, r).astype(np.int64)
    lab[::5] = ignore
    lab[3] = v + 2
    return x, lab


def _pallas_label(lab, soft):
    return jnp.asarray(lab) if soft else \
        jnp.asarray(lab.astype(np.int32).reshape(-1, 1))


def _check_forward(x, lab, soft, ignore):
    ref_loss, ref_lse = pf.softmax_xent(jnp.asarray(x), _pallas_label(lab, soft),
                                        soft, ignore, interpret=True)
    loss, lse, sum_y = fused.softmax_xent_fwd(
        torch.from_numpy(x), torch.from_numpy(lab), soft, ignore)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), **XENT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **XENT_TOL)
    if soft:
        np.testing.assert_allclose(sum_y.numpy()[:, 0], lab.sum(-1),
                                   rtol=1e-6)
    else:
        assert sum_y is None
        if ignore >= 0:
            assert (loss.numpy()[lab == ignore] == 0).all()


@pytest.mark.parametrize("r,v,soft,ignore", CASES, ids=IDS)
def test_xent_forward_matches_pallas(r, v, soft, ignore):
    _check_forward(*_xent_inputs(r, v, soft), soft, ignore)


@pytest.mark.parametrize("r,v,soft,ignore", NARROW_CASES, ids=NARROW_IDS)
def test_xent_narrow_forward_matches_pallas(r, v, soft, ignore):
    _check_forward(*_narrow_inputs(r, v, soft, ignore), soft, ignore)


def _check_backward(x, lab, soft, ignore):
    """dx from :class:`fused.SoftmaxXent` against ``jax.vjp`` of the Pallas
    op, with cotangents on both the loss and the lse (so ``g1`` folds a
    nonzero ``dlse``)."""
    r = x.shape[0]
    rng = np.random.default_rng(1)
    dloss = rng.standard_normal((r, 1)).astype(np.float32)
    dlse = rng.standard_normal((r, 1)).astype(np.float32)
    pl_lab = _pallas_label(lab, soft)
    _, vjp = jax.vjp(lambda a: pf.softmax_xent(a, pl_lab, soft, ignore,
                                               interpret=True),
                     jnp.asarray(x))
    (ref_dx,) = vjp((jnp.asarray(dloss), jnp.asarray(dlse)))

    xt = torch.from_numpy(x).requires_grad_()
    loss, lse = fused.SoftmaxXent.apply(xt, torch.from_numpy(lab), soft,
                                         ignore)
    (dx,) = torch.autograd.grad([loss, lse], [xt], [torch.from_numpy(dloss),
                                                    torch.from_numpy(dlse)])
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **DX_TOL)


@pytest.mark.parametrize("r,v,soft,ignore", CASES, ids=IDS)
def test_xent_backward_matches_pallas_vjp(r, v, soft, ignore):
    _check_backward(*_xent_inputs(r, v, soft), soft, ignore)


@pytest.mark.parametrize("r,v,soft,ignore", NARROW_CASES, ids=NARROW_IDS)
def test_xent_narrow_backward_matches_pallas_vjp(r, v, soft, ignore):
    _check_backward(*_narrow_inputs(r, v, soft, ignore), soft, ignore)


def test_xent_wrappers_count_no_cpu_launch():
    x, lab = _xent_inputs(4, 40, True)
    before = (fused.xent_fwd_launches, fused.xent_bwd_launches)
    xt = torch.from_numpy(x).requires_grad_()
    loss, _ = fused.SoftmaxXent.apply(xt, torch.from_numpy(lab), True, -100)
    loss.sum().backward()
    assert (fused.xent_fwd_launches, fused.xent_bwd_launches) == before


def test_xent_layout_counters_advance_with_the_graph_table():
    """The xent launches by layout are counters a graph runner advances per
    replay (``launch_counts``), and a CPU call counts none."""
    from paddle_tpu_torch.ops import launch_counts

    snap = launch_counts.snapshot()
    for d in ("fwd", "bwd"):
        for layout in ("narrow", "wide"):
            assert ("fused", f"xent_{d}_launches_by_layout", layout) in snap
    x, lab = _narrow_inputs(12, 21, False, 0)
    before = (dict(fused.xent_fwd_launches_by_layout),
              dict(fused.xent_bwd_launches_by_layout))
    xt = torch.from_numpy(x).requires_grad_()
    loss, _ = fused.SoftmaxXent.apply(xt, torch.from_numpy(lab), False, 0)
    loss.sum().backward()
    assert (fused.xent_fwd_launches_by_layout,
            fused.xent_bwd_launches_by_layout) == before


def test_wrappers_refuse_tensors_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    wrappers never quietly run the plain version for it."""
    x = torch.empty(4, 8, device="meta")
    lab = torch.empty(4, dtype=torch.int64, device="meta")
    p = torch.empty(8, device="meta")
    before = (fused.xent_fwd_launches, fused.adam_launches)
    with pytest.raises(ValueError, match="CUDA"):
        fused.softmax_xent_fwd(x, lab, False)
    with pytest.raises(ValueError, match="CUDA"):
        fused.adam(p, p, p, p, torch.empty(1, device="meta"), 0.9, 0.98, 1e-9)
    assert (fused.xent_fwd_launches, fused.adam_launches) == before


@pytest.mark.parametrize("shape", [(33, 7), (256, 128), (10,), (512,)])
def test_adam_matches_pallas(shape, monkeypatch):
    """Ragged and lane-aligned shapes; the Pallas sweep forced on
    (``PADDLE_TPU_FUSED=1``) and run in interpret mode."""
    monkeypatch.setenv("PADDLE_TPU_FUSED", "1")
    rng = np.random.default_rng(6)
    p, g, m1, m2 = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    m2 = np.abs(m2)
    lr_eff = np.float32(0.01)
    b1, b2, eps = 0.9, 0.98, 1e-9
    ref = pf.fused_adam(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m1),
                        jnp.asarray(m2), jnp.float32(lr_eff), b1, b2, eps)

    tp, tm1, tm2 = (torch.from_numpy(a.copy()) for a in (p, m1, m2))
    before = fused.adam_launches
    out = fused.adam(tp, torch.from_numpy(g), tm1, tm2,
                     torch.tensor([lr_eff]), b1, b2, eps)
    assert fused.adam_launches == before  # the plain version on the CPU
    assert out[0] is tp and out[1] is tm1 and out[2] is tm2  # in place
    for got, want, name in zip((tp, tm1, tm2), ref, ("p", "m1", "m2")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **ADAM_TOL)
    plain = fused.adam_ref(*(torch.from_numpy(a) for a in (p, g, m1, m2)),
                           torch.tensor([lr_eff]), b1, b2, eps)
    for got, want in zip((tp, tm1, tm2), plain):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
