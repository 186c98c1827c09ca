"""The numerical scheme of the flash forward, dQ and dK/dV kernels, on the
CPU.

On the card the three kernels multiply on the tensor cores in TF32 (10
mantissa bits) and keep fp32 accuracy by a 3xTF32 split: each fp32
operand ``x`` becomes ``big = tf32(x)`` (round to nearest, ties away from
zero, as ``cvt.rna.tf32.f32``) and ``small = x - big``, of which the
tensor core reads the top 19 bits (TF32 by truncation).  A product ``a b``
is ``small_a big_b + big_a small_b + big_a big_b``, three
``mma.sync.m16n8k8`` products of one k step (8 products each) into a fresh
accumulator, whose sums the tensor core rounds toward zero; each step's
partial is then added to the running fp32 sum rounded to nearest.  The
kernels cannot run here, so this file holds the scheme itself before card
time is spent on it:

 - a plain emulation of it (TF32 rounding by int32 bit operations on
   float32; each step's three products summed exactly in float64 and
   truncated to float32, as the tensor core's sums are) replaces every
   matrix product of the plain versions ``flash_forward_ref``,
   ``flash_dq_ref`` and ``flash_dkv_ref``;
 - at each head width the kernels take, with the key-padding bias of
   -1e9 past ragged lengths and with the causal mask (as
   ``chip_smoke.flash_case_inputs`` makes them), the split's out, lse, dq,
   dk and dv stay within ``chip_smoke.FLASH_TOL`` of the fp32 plain
   versions,
   the tolerance the card holds the kernels to;
 - a single TF32 product exceeds that tolerance, which is why the split
   is needed.

These tests guard the scheme, not the kernels: the emulation lives here,
and a change to the kernels' fragment code or rounding cannot make them
fail.  The emulation sums the products of a step in float64 where the
tensor core aligns them in its own way; ``chip_smoke.py``'s
``kernel_flash`` phase holds the kernels themselves to the same tolerance
on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa

B, H = 2, 2
T_Q, T_K = 80, 72
_MATMUL = torch.matmul


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``): add half of the 13 dropped bits'
    range to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def to_float32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero (the tensor core's sums)."""
    r = x.to(torch.float32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


STEP = 8  # products a k step of m16n8k8 sums


def matmul_3xtf32(a, b):
    """``a @ b`` as the kernels compute it: per k step, small_a big_b,
    big_a small_b, then big_a big_b into a fresh accumulator (each sum
    truncated to float32), the step's partial added to the fp32 result
    rounded to nearest."""
    a_big, b_big = tf32(a), tf32(b)
    a_small = tf32_truncated(a - a_big)
    b_small = tf32_truncated(b - b_big)
    out = None
    for k0 in range(0, a.shape[-1], STEP):
        ka, kb = (slice(None),) * (a.dim() - 1) + (slice(k0, k0 + STEP),), \
            (slice(None),) * (b.dim() - 2) + (slice(k0, k0 + STEP),)

        def prod(x, y):
            return _MATMUL(x[ka].double(), y[kb].double())

        part = to_float32_toward_zero(prod(a_small, b_big))
        part = to_float32_toward_zero(part.double() + prod(a_big, b_small))
        part = to_float32_toward_zero(part.double() + prod(a_big, b_big))
        out = part if out is None else out + part
    return out


def matmul_1xtf32(a, b):
    return _MATMUL(tf32(a), tf32(b))


def _inputs(d, causal, seed):
    """q, k, v, dO ``[B, H, T, D]`` from a seed, and for the non-causal
    case the model's key-padding bias: -1e9 past a ragged length per batch
    row (the first row unpadded)."""
    rng = np.random.default_rng(seed)

    def rnd(t):
        return torch.from_numpy(
            rng.standard_normal((B, H, t, d)).astype(np.float32))

    q, k, v, do = rnd(T_Q), rnd(T_K), rnd(T_K), rnd(T_Q)
    bias = None
    if not causal:
        lens = rng.integers(T_K // 2, T_K + 1, size=B)
        lens[0] = T_K
        keys = np.arange(T_K)[None, :]
        bias = torch.from_numpy(np.where(keys < lens[:, None], 0.0, -1e9)
                                .astype(np.float32).reshape(B, 1, 1, T_K))
    return q, k, v, do, bias


def _run(q, k, v, do, bias, causal, matmul, monkeypatch):
    """out, lse of the forward, dq of dQ and dk, dv of dK/dV with every
    product of the plain versions done by ``matmul``, and the same in fp32.
    The backward takes the fp32 forward's lse and delta, as the kernels are
    handed them."""
    scale = q.shape[-1] ** -0.5
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, bias, scale, causal)
    delta = (do * ref_out).sum(-1, keepdim=True)
    ref_dq = fa.flash_dq_ref(q, k, v, bias, do, ref_lse, delta, scale,
                             causal)
    ref_dk, ref_dv = fa.flash_dkv_ref(q, k, v, bias, do, ref_lse, delta,
                                      scale, causal)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", matmul)
        out, lse = fa.flash_forward_ref(q, k, v, bias, scale, causal)
        dq = fa.flash_dq_ref(q, k, v, bias, do, ref_lse, delta, scale,
                             causal)
        dk, dv = fa.flash_dkv_ref(q, k, v, bias, do, ref_lse, delta, scale,
                                  causal)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    want = {"out": ref_out, "lse": ref_lse, "dq": ref_dq, "dk": ref_dk,
            "dv": ref_dv}
    return got, want


def _excess(got, want, name):
    """max over elements of |got - want| - (atol + rtol |want|): <= 0
    within ``FLASH_TOL[name]``."""
    atol, rtol = chip_smoke.FLASH_TOL[name]
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


CASES = [(d, causal) for d in fa.HEAD_DIMS for causal in (False, True)]
IDS = [f"D{d}-{'causal' if c else 'padding'}" for d, c in CASES]


@pytest.mark.parametrize("d,causal", CASES, ids=IDS)
def test_split_holds_flash_tolerance(d, causal, monkeypatch):
    got, want = _run(*_inputs(d, causal, seed=d), causal, matmul_3xtf32,
                     monkeypatch)
    for name in got:
        assert bool(got[name].isfinite().all()), name
        assert _excess(got[name], want[name], name) <= 0, (
            f"{name}: 3xTF32 max abs err "
            f"{float((got[name] - want[name]).abs().max())}")


def test_single_tf32_exceeds_flash_tolerance(monkeypatch):
    d, causal = 64, False
    got, want = _run(*_inputs(d, causal, seed=d), causal, matmul_1xtf32,
                     monkeypatch)
    assert max(_excess(got[n], want[n], n) for n in got) > 0


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2.0 ** -11,
                               -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                               1.0 + 2.0 ** -12 - 2.0 ** -23, 3.0e-30])
def test_tf32_rounds_to_nearest_ties_away(x):
    """``tf32`` against the same rounding done in float64: the nearest
    multiple of 2^(e-10), a tie away from zero."""
    t = torch.tensor([x], dtype=torch.float32)
    v = float(t)
    e = np.floor(np.log2(abs(v)))
    step = 2.0 ** (e - 10)
    want = np.sign(v) * np.floor(abs(v) / step + 0.5) * step
    assert float(tf32(t)) == np.float32(want)
    # big + the tensor core's view of small recover x to 2^-21 of it
    big = tf32(t)
    small = tf32_truncated(t - big)
    assert abs(float(big + small) - v) <= abs(v) * 2.0 ** -21
