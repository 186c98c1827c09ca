"""The split paged-attention kernel's geometry, scratch, refusals and
reduction order, on the CPU.

On the card ``paged_attention`` splits each slot's row over many blocks in
two launches (``csrc/paged_attention.cu``): scores of fixed chunks of
``CHUNK`` key positions into a scratch row, then per block of ``COLS``
output columns the exact softmax over the slot's whole score row and
``p · V``.  The kernel cannot run here, so this file holds what surrounds
it and the scheme it relies on:

 - ``split_geometry``: the grids at the decode path's shape fill the card
   (128 blocks a launch at 8 slots), the chunks are fixed in key positions
   (a longer page table only appends chunks), and the scratch is one float
   a (slot, position);
 - the wrapper's refusals (d % 4, dtype, shapes, devices) raise before any
   launch, where the plain path, which the CPU takes, computes the same
   inputs;
 - an emulation of the kernel's order of sums in float32 (per-thread
   strided partials of the row's exp sum reduced by warp shuffles, p · V
   by 32 key groups summed in group order) is within 1e-5 of the plain
   version, gives each slot alone the bits of its row of the batch, and
   gives a page table cut to the pages a slot uses the bits of the full
   table: the extra positions add exact zeros at the ends of the sums.

These tests guard the scheme, not the kernel: ``chip_smoke.py``'s
``kernel`` phase holds the kernel itself to the same invariants on the
card.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa

ATOL = RTOL = 1e-5
THREADS, GROUPS = 256, 32   # a block's threads; p . V's key groups


def _case(seed=0, s_n=3, n_pages=6, ps=4, d=8):
    """A pool of s_n * n_pages pages plus the trash page, a shuffled page
    table whose pages past each slot's live length are the trash page,
    ragged live lengths (one slot at 1, one full), -inf past them."""
    rng = np.random.default_rng(seed)
    pool = s_n * n_pages
    ell = n_pages * ps
    q = rng.standard_normal((s_n, 1, d)).astype(np.float32) * d ** -0.5
    ck = rng.standard_normal((pool + 1, ps, d)).astype(np.float32)
    cv = rng.standard_normal((pool + 1, ps, d)).astype(np.float32)
    lens = rng.integers(1, ell + 1, s_n)
    lens[0], lens[-1] = 1, ell
    pt = rng.permutation(pool).reshape(s_n, n_pages)
    used = (lens + ps - 1) // ps
    pt = np.where(np.arange(n_pages)[None] < used[:, None], pt, pool)
    bias = np.where(np.arange(ell)[None] < lens[:, None], 0.0, -np.inf)
    return (torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            torch.from_numpy(pt.astype(np.int64)),
            torch.from_numpy(bias.astype(np.float32).reshape(s_n, 1, ell)),
            lens)


# --------------------------------------------------------------------------
# geometry and scratch
# --------------------------------------------------------------------------


def test_geometry_at_the_decode_shape_fills_the_card():
    """8 slots x 512 positions (32 pages of 16), d_model 512: 16 chunks and
    16 column blocks a slot, 128 blocks in each launch (132 SMs)."""
    g = pa.split_geometry(8, 512, 32, 16)
    assert g["score_grid"] == (16, 8)
    assert g["pv_grid"] == (16, 8)
    assert g["scratch_numel"] == 8 * 512
    assert pa.CUDA_LAUNCHES == 2
    assert g["chunk_starts"] == list(range(0, 512, pa.CHUNK))


@pytest.mark.parametrize("n_pages,ps", [(32, 16), (5, 16), (7, 4), (1, 3),
                                        (9, 5)])
def test_chunks_are_fixed_in_key_positions(n_pages, ps):
    """Cutting the table to fewer pages drops chunks from the end and never
    moves one: every chunk starts at a multiple of CHUNK, whatever the
    number of pages or slots."""
    full = pa.split_geometry(8, 512, n_pages, ps)
    for used in range(1, n_pages + 1):
        for s_n in (1, 3, 8):
            cut = pa.split_geometry(s_n, 512, used, ps)
            starts = cut["chunk_starts"]
            assert starts == full["chunk_starts"][:len(starts)]
            assert cut["score_grid"] == (len(starts), s_n)
            assert len(starts) * pa.CHUNK >= used * ps > starts[-1]


@pytest.mark.parametrize("s_n,d,n_pages,ps", [(8, 512, 32, 16),
                                              (1, 4, 1, 1), (3, 36, 7, 5),
                                              (16, 1024, 64, 16)])
def test_scratch_is_one_float_a_position(s_n, d, n_pages, ps):
    g = pa.split_geometry(s_n, d, n_pages, ps)
    assert g["scratch_numel"] == s_n * n_pages * ps
    assert g["pv_grid"] == (-(-d // pa.COLS), s_n)
    assert g["pv_grid"][0] * pa.COLS >= d > (g["pv_grid"][0] - 1) * pa.COLS


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def _refused(case):
    """Inputs the kernel does not take, the error it raises, and whether
    the plain path computes them."""
    q, ck, cv, pt, bias, _ = _case()
    if case == "d_not_multiple_of_4":
        q6, ck6, cv6 = q[..., :6].contiguous(), ck[..., :6].contiguous(), \
            cv[..., :6].contiguous()
        return (q6, ck6, cv6, pt, bias), ValueError, "multiple of 4", True
    if case == "float64_query":
        return (q.double(), ck, cv, pt, bias), TypeError, "float32", False
    if case == "float16_cache":
        return (q, ck.half(), cv, pt, bias), TypeError, "float32", False
    if case == "float_page_table":
        return (q, ck, cv, pt.float(), bias), TypeError, "int32 or int64", \
            False
    if case == "bias_too_short":
        return (q, ck, cv, pt, bias[..., :-1].contiguous()), ValueError, \
            "bias", False
    if case == "two_query_rows":
        return (q.expand(3, 2, 8).contiguous(), ck, cv, pt, bias), \
            ValueError, "one query row", True
    if case == "page_table_rows":
        return (q, ck, cv, pt[:2], bias), ValueError, "page_table", False
    raise AssertionError(case)


REFUSALS = ["d_not_multiple_of_4", "float64_query", "float16_cache",
            "float_page_table", "bias_too_short", "two_query_rows",
            "page_table_rows"]


@pytest.mark.parametrize("case", REFUSALS)
def test_kernel_refuses_before_launch(case):
    args, err, match, plain_takes_it = _refused(case)
    with pytest.raises(err, match=match):
        pa._check(*args)
    if plain_takes_it:
        before = pa.launches
        out = pa.paged_attention(*args, 1.0)
        assert pa.launches == before
        assert torch.equal(out, pa.paged_attention_ref(*args, 1.0))


def test_mixed_devices_are_refused():
    q, ck, cv, pt, bias, _ = _case()
    before = pa.launches
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q.to("meta"), ck, cv, pt, bias)
    assert pa.launches == before


# --------------------------------------------------------------------------
# the kernel's order of sums, emulated
# --------------------------------------------------------------------------


def _butterfly_sum(v):
    """Lane 0's value after ``v += shfl_xor(v, o)`` for o = 16 .. 1 over
    warps of 32 lanes (``v`` [warps, 32] float32)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, lanes ^ o]).astype(np.float32)
    return v[:, 0]


def _block_sum(per_thread):
    """``block_sum``: each warp's shuffles, then warp 0's over the warps'
    partials (zeros past them)."""
    warps = _butterfly_sum(per_thread.reshape(-1, 32))
    padded = np.zeros(32, np.float32)
    padded[:len(warps)] = warps
    return _butterfly_sum(padded[None])[0]


def _split_emulated(q, ck, cv, pt, bias):
    """The kernel's two launches in float32, in its order of sums."""
    q, ck, cv, pt, bias = (t.numpy() for t in (q, ck, cv, pt, bias))
    s_n, _, d = q.shape
    ps = ck.shape[1]
    ell = pt.shape[1] * ps
    out = np.zeros((s_n, d), np.float32)
    for s in range(s_n):
        rows = [(pt[s, l // ps], l % ps) for l in range(ell)]
        b = bias[s, 0]
        # A: one score a position; -inf bias without reading K
        sc = np.array([b[l] if np.isneginf(b[l]) else
                       np.float32(np.dot(q[s, 0], ck[rows[l]]) + b[l])
                       for l in range(ell)], np.float32)
        # B: max, then exp sums strided over the block's threads
        m = sc.max()
        e = np.exp(sc - m).astype(np.float32)
        per_thread = np.zeros(THREADS, np.float32)
        for l in range(ell):
            per_thread[l % THREADS] += e[l]
        p = (e / _block_sum(per_thread)).astype(np.float32)
        # p . V: group j takes positions j, j + 32, ... in order, skipping
        # p = 0; the groups' partials in group order
        part = np.zeros((GROUPS, d), np.float32)
        for l in range(ell):
            if p[l] != 0:
                part[l % GROUPS] += p[l] * cv[rows[l]]
        acc = np.zeros(d, np.float32)
        for j in range(GROUPS):
            acc += part[j]
        out[s] = acc
    return torch.from_numpy(out[:, None, :])


@pytest.mark.parametrize("seed,n_pages,ps", [(0, 6, 4), (1, 20, 16),
                                             (2, 3, 5)])
def test_emulated_split_matches_plain_and_its_invariants(seed, n_pages, ps):
    q, ck, cv, pt, bias, lens = _case(seed, n_pages=n_pages, ps=ps)
    batch = _split_emulated(q, ck, cv, pt, bias)
    want = pa.paged_attention_ref(q, ck, cv, pt, bias)
    assert torch.allclose(batch, want, atol=ATOL, rtol=RTOL)
    for s in range(q.shape[0]):
        alone = _split_emulated(q[s:s + 1], ck, cv, pt[s:s + 1],
                                bias[s:s + 1])
        assert torch.equal(alone, batch[s:s + 1])
        used = (int(lens[s]) + ps - 1) // ps
        cut = _split_emulated(q[s:s + 1], ck, cv, pt[s:s + 1, :used],
                              bias[s:s + 1, :, :used * ps])
        assert torch.equal(cut, batch[s:s + 1])
