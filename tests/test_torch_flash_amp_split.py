"""The numerical schemes of the flash forward, dQ and dK/dV kernels on bf16
and fp16 inputs, on the CPU.

On the card (``csrc/flash_attention.cu``) the kernels widen every value to
fp32 and:

 - multiply two input tensors (q kᵀ, dO vᵀ; k qᵀ, v dOᵀ in dK/dV) in the
   input type on the tensor cores (``wgmma``): each product exact in fp32,
   a 16-wide k step's products summed into the running fp32 accumulator,
   the sum rounded toward zero; ``scale`` multiplies the fp32 scores after;
 - multiply P or dS (P v, dS k, Pᵀ dO, dSᵀ q) split into ``hi = T(P)``
   and ``lo = T(P - hi)`` in the input type T: per 16-wide k step ``lo ·
   x`` then ``hi · x``, each summed into the running accumulator toward
   zero (two ``wgmma``).  In fp16, dS (dQ) and dSᵀ (dK) first take a
   power-of-two exponent per row (a query row of dS, a key row of dSᵀ)
   that keeps the row's largest |dS| under 2^15 (it only grows over the
   64-wide tiles; the accumulator's row is rescaled exactly when it does,
   and takes the power back at the end): under the loss scaler dS can
   pass fp16's 65504 where the reference's fp32 does not;
 - round out, dq, dk and dv once to the input type.

Before the hi + lo scheme the kernels multiplied P and dS by the TF32
route: ``big = tf32(dS)`` rounded to nearest, ``small = dS - big`` of
which the tensor core reads the top 19 bits, the other operand exact in
TF32; per 8-wide k step ``small · x`` then ``big · x`` into a fresh
accumulator (sums rounded toward zero), the step's partial added to the
running sum rounded to nearest.  The fp32 kernels still use it with three
products (``tests/test_torch_flash_tf32.py``).

The kernels cannot run here, so this file holds the schemes themselves:

 - a plain emulation of each (exact products and sums in float64, rounded
   toward zero to float32 where the tensor core's sums are) at each head
   width the kernels take, with the key-padding bias of -1e9 past ragged
   lengths and with the causal mask, in bf16 and fp16, stays within
   ``chip_smoke.FLASH_LOW_TOL`` of the plain versions on the same inputs
   (the tolerance the card holds the kernels to): the TF32 route
   everywhere, and the kernels' hi + lo scheme (with the fp16 exponent in
   dQ and dK);
 - rounding P and dS to bf16 once before their products
   (FlashAttention-2's usual move) does not: the tolerance tells the two
   apart;
 - in fp16 with max |dS| past 65504, the per-row exponent keeps dq and dk
   finite and within the tolerance where the plain versions' are finite,
   and the same split without it does not.

These tests guard the scheme, not the kernels: a change to the kernels'
fragment code cannot make them fail.  ``chip_smoke.py``'s
``kernel_flash_amp`` phase holds the kernels to the same tolerance on the
card.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa

B, H = 2, 2
T_Q, T_K = 80, 72


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as the kernels' split does in integer ops."""
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


def _steps(a, b, width):
    """``a [.., M, K]`` and ``b [.., K, N]`` cut into k steps of ``width``."""
    for k0 in range(0, a.shape[-1], width):
        yield a[..., k0:k0 + width], b[..., k0:k0 + width, :]


def mm_inputs(a, b):
    """``a @ b`` of two input tensors widened to fp32 (m16n8k16): exact
    products, each step's sum added to the accumulator toward zero."""
    acc = None
    for a_s, b_s in _steps(a, b, 16):
        part = torch.matmul(a_s.double(), b_s.double())
        acc = to_float32_toward_zero(part if acc is None
                                     else acc.double() + part)
    return acc


def mm_split(p, x):
    """``p @ x`` for fp32 P or dS and an input tensor ``x`` (TF32 route):
    per 8-wide step ``small · x`` then ``big · x`` into a fresh accumulator
    toward zero, the partial added to the running sum to nearest."""
    big = tf32(p)
    small = tf32_truncated(p - big)
    out = None
    for (s_s, x_s), (b_s, _) in zip(_steps(small, x, 8), _steps(big, x, 8)):
        part = to_float32_toward_zero(torch.matmul(s_s.double(),
                                                   x_s.double()))
        part = to_float32_toward_zero(part.double() + torch.matmul(
            b_s.double(), x_s.double()))
        out = part if out is None else out + part
    return out


def mm_hi_lo(p, x, dtype, acc=None):
    """``acc + p @ x`` for fp32 P or dS and an input tensor ``x`` (the hi +
    lo route): ``hi = T(p)``, ``lo = T(p - hi)`` rounded to nearest in the
    input type T; per 16-wide step ``lo · x`` then ``hi · x``, each summed
    into the running accumulator toward zero."""
    hi = p.to(dtype).float()
    lo = (p - hi).to(dtype).float()
    for (lo_s, x_s), (hi_s, _) in zip(_steps(lo, x, 16), _steps(hi, x, 16)):
        for part in (lo_s, hi_s):
            prod = torch.matmul(part.double(), x_s.double())
            acc = to_float32_toward_zero(prod if acc is None
                                         else acc.double() + prod)
    return acc


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e in float32 for integer e, built from its bits as the kernel does
    (0 below the normal range)."""
    return ((e + 127).clamp_min(0) << 23).to(torch.int32).view(torch.float32)


def mm_ds_rows(ds, x, scale, dtype, tile=64):
    """``scale · dS x`` as the dQ and dK/dV kernels form it (dS k in dQ,
    its rows queries; dSᵀ q in dK/dV, its rows keys): by ``mm_hi_lo``'s
    route, 64-wide tile by tile; in fp16 each row of ``ds`` first times
    ``2^-ex``, ex = max(ex, E - 141) over the tiles so far (E the biased
    exponent of the row's largest |dS| in the tile: the scaled row stays
    under 2^15; ex starts at -64), the accumulator's row rescaled by the
    change, and ``scale · 2^ex`` applied at the end."""
    if dtype != torch.float16:
        return scale * mm_hi_lo(ds, x, dtype)
    ex = torch.full(ds.shape[:-1] + (1,), -64, dtype=torch.int32)
    acc = torch.zeros(ds.shape[:-1] + (x.shape[-1],))
    for k0 in range(0, ds.shape[-1], tile):
        part = ds[..., k0:k0 + tile]
        mx = part.abs().amax(dim=-1, keepdim=True)
        need = ((mx.view(torch.int32) >> 23) & 0xFF) - 141
        grown = torch.maximum(ex, need)
        acc = acc * pow2(ex - grown)
        ex = grown
        acc = mm_hi_lo(part * pow2(-ex), x[..., k0:k0 + tile, :], dtype, acc)
    return acc * (scale * pow2(ex))


def mm_round_bf16(p, x):
    """``p @ x`` with P or dS rounded to bf16 once (the usual FlashAttention
    move), summed in fp32."""
    return torch.matmul(p.to(torch.bfloat16).float(), x)


def emulated(q, k, v, do, bias, causal, mm_p, mm_dq=None, mm_dk=None):
    """out, lse, dq, dk, dv by the kernels' formulas: scores by
    ``mm_inputs`` and scaled after, products with P or dS by ``mm_p``, or
    ``scale · dS k`` by ``mm_dq(ds, k, scale)`` and ``scale · dSᵀ q`` by
    ``mm_dk(dsᵀ, q, scale)`` where given.  The backward takes the plain forward's lse and delta, as
    the kernels are handed them."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    bias2 = fa._bias_2d(bias, q.shape[0], q.shape[1], k.shape[2])
    s = fa._masked(mm_inputs(qf, kf.transpose(-1, -2)) * scale, bias2,
                   causal)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (mm_p(p, vf) / l).to(q.dtype)
    lse = m + torch.log(l)
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, bias, scale, causal)
    delta = fa._delta(ref_out, do)
    p = torch.exp(s - ref_lse)
    ds = p * (mm_inputs(dof, vf.transpose(-1, -2)) - delta)
    dq = (mm_dq(ds, kf, scale) if mm_dq else scale * mm_p(ds, kf)).to(
        q.dtype)
    ds_t = ds.transpose(-1, -2)
    dk = (mm_dk(ds_t, qf, scale) if mm_dk else scale * mm_p(ds_t, qf)).to(
        q.dtype)
    dv = mm_p(p.transpose(-1, -2), dof).to(q.dtype)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def plain(q, k, v, do, bias, causal):
    """The plain versions' outputs on the same inputs."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward_ref(q, k, v, bias, scale, causal)
    delta = fa._delta(out, do)
    dq = fa.flash_dq_ref(q, k, v, bias, do, lse, delta, scale, causal)
    dk, dv = fa.flash_dkv_ref(q, k, v, bias, do, lse, delta, scale, causal)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _inputs(dtype, d, causal, seed):
    """q, k, v, dO ``[B, H, T, D]`` in ``dtype`` from a seed, and for the
    non-causal case the model's fp32 key-padding bias: -1e9 past a ragged
    length per batch row (the first row unpadded)."""
    rng = np.random.default_rng(seed)

    def rnd(t):
        return torch.from_numpy(rng.standard_normal((B, H, t, d)).astype(
            np.float32)).to(dtype)

    q, k, v, do = rnd(T_Q), rnd(T_K), rnd(T_K), rnd(T_Q)
    bias = None
    if not causal:
        lens = rng.integers(T_K // 2, T_K + 1, size=B)
        lens[0] = T_K
        keys = np.arange(T_K)[None, :]
        bias = torch.from_numpy(np.where(keys < lens[:, None], 0.0, -1e9)
                                .astype(np.float32).reshape(B, 1, 1, T_K))
    return q, k, v, do, bias


def _excess(got, want, name):
    """<= 0 within ``FLASH_LOW_TOL``: lse by its (atol, rtol), the others by
    ``chip_smoke.low_excess``."""
    if name == "lse":
        atol, rtol = chip_smoke.FLASH_LOW_TOL["lse"]
        return float(((got - want).abs() - (atol + rtol * want.abs())).max())
    return chip_smoke.low_excess(got, want)


CASES = [(dt, d, causal) for dt in (torch.bfloat16, torch.float16)
         for d in fa.HEAD_DIMS for causal in (False, True)]
IDS = [f"{str(dt)[6:]}-D{d}-{'causal' if c else 'padding'}"
       for dt, d, c in CASES]


@pytest.mark.parametrize("dtype,d,causal", CASES, ids=IDS)
def test_split_holds_low_tolerance(dtype, d, causal):
    inputs = _inputs(dtype, d, causal, seed=d)
    got = emulated(*inputs, causal, mm_split)
    want = plain(*inputs, causal)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert bool(got[name].isfinite().all()), name
        assert _excess(got[name], want[name], name) <= 0, (
            name, float((got[name].float() - want[name].float()).abs()
                        .max()))


def test_bf16_rounded_p_exceeds_low_tolerance():
    inputs = _inputs(torch.bfloat16, 64, False, seed=64)
    got = emulated(*inputs, False, mm_round_bf16)
    want = plain(*inputs, False)
    assert max(_excess(got[n], want[n], n) for n in got) > 0


def kernel_scheme(dtype):
    """``emulated``'s products as the kernels form them: hi + lo in all
    three, dQ and dK with the fp16 per-row exponent over 64-wide tiles."""
    rows = functools.partial(mm_ds_rows, dtype=dtype)
    return {"mm_p": functools.partial(mm_hi_lo, dtype=dtype),
            "mm_dq": rows, "mm_dk": rows}


@pytest.mark.parametrize("dtype,d,causal", CASES, ids=IDS)
def test_hi_lo_holds_low_tolerance(dtype, d, causal):
    inputs = _inputs(dtype, d, causal, seed=d)
    got = emulated(*inputs, causal, **kernel_scheme(dtype))
    want = plain(*inputs, causal)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert bool(got[name].isfinite().all()), name
        assert _excess(got[name], want[name], name) <= 0, (
            name, float((got[name].float() - want[name].float()).abs()
                        .max()))


def _fp16_large_ds():
    """fp16 inputs under a loss-scaler-like dO (4000 x normal) with v at 8 x
    normal, at D = 64 and no mask: the fp32 dS passes fp16's 65504 while
    the plain version's dk stays finite.  Returns the inputs and max
    |dS|."""
    rng = np.random.default_rng(7)

    def rnd(t, scale):
        return torch.from_numpy((scale * rng.standard_normal((B, H, t, 64)))
                                .astype(np.float32)).to(torch.float16)

    q, k, v, do = rnd(T_Q, 1.0), rnd(T_K, 1.0), rnd(T_K, 8.0), rnd(T_Q, 4000.0)
    scale = 64 ** -0.5
    out, lse = fa.flash_forward_ref(q, k, v, None, scale, False)
    p = torch.exp(mm_inputs(q.float(), k.float().transpose(-1, -2)) * scale
                  - lse)
    ds = p * (mm_inputs(do.float(), v.float().transpose(-1, -2))
              - fa._delta(out, do))
    return (q, k, v, do, None), float(ds.abs().max())


def test_fp16_exponent_keeps_dk_past_fp16_range():
    inputs, ds_max = _fp16_large_ds()
    assert ds_max > float(torch.finfo(torch.float16).max)
    got = emulated(*inputs, False, **kernel_scheme(torch.float16))["dk"]
    want = plain(*inputs, False)["dk"]
    finite = want.isfinite()
    assert bool(finite.any())
    assert torch.equal(got.isfinite(), finite)
    assert _excess(got[finite], want[finite], "dk") <= 0


def test_fp16_split_without_exponent_overflows():
    inputs, _ = _fp16_large_ds()
    scheme = kernel_scheme(torch.float16)
    del scheme["mm_dk"]  # dSᵀ q by the bare hi + lo split
    assert bool(plain(*inputs, False)["dk"].isfinite().all())
    assert not bool(emulated(*inputs, False, **scheme)["dk"].isfinite().all())


def test_fp16_exponent_keeps_dq_past_fp16_range():
    inputs, ds_max = _fp16_large_ds()
    assert ds_max > float(torch.finfo(torch.float16).max)
    got = emulated(*inputs, False, **kernel_scheme(torch.float16))["dq"]
    want = plain(*inputs, False)["dq"]
    finite = want.isfinite()
    assert bool(finite.any())
    assert torch.equal(got.isfinite(), finite)
    assert _excess(got[finite], want[finite], "dq") <= 0


def test_fp16_dq_split_without_exponent_overflows():
    inputs, _ = _fp16_large_ds()
    scheme = kernel_scheme(torch.float16)
    del scheme["mm_dq"]  # dS k by the bare hi + lo split
    assert bool(plain(*inputs, False)["dq"].isfinite().all())
    assert not bool(emulated(*inputs, False, **scheme)["dq"].isfinite().all())
