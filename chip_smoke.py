#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: builds every CUDA kernel from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the port's paths give
it, then serves a Transformer-base-width paged decode LM through the
continuous-batching ``DecodeEngine`` and trains Transformer-base through
``fluid.Executor``, and checks both.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

 1. device       - a CUDA device is present; fp32 matmuls stay full fp32
 2. build        - nvcc builds ``paddle_tpu_torch/csrc/*.cu`` (one process
                   per source, all started together)
 3. kernel       - paged attention vs ``paged_attention_ref`` at S=8,
                   D=512, page_size=16, 32 pages per slot, a pool of
                   8*32+1 pages, a shuffled page table with trash entries
                   and ragged -inf bias; bitwise repeatability; kernel,
                   plain and library times and the memory-bound time
 4. kernel_xent  - the softmax-cross-entropy forward and backward kernels
                   vs their plain versions at the training path's shape
                   (R = 64 x 256 rows, V = 30000): soft labels from
                   one_hot + label_smooth, and hard labels with
                   ignore_index rows; bitwise repeatability; kernel, plain,
                   library and bound times
 5. kernel_adam  - the Adam kernel vs its plain version over tensors of
                   the training slice's 184 parameter shapes; the step's
                   kernel, plain, library (torch.optim.Adam fused) and
                   bound times
 6. serving      - 16 requests (two sharing a 32-token prefix) through a
                   6-layer d_model 512 / d_inner 2048 / vocab 30000 paged
                   decode model with random weights from a seed: every
                   stream equals ``decode_static`` of it alone bitwise, the
                   kernel ran n_layer times per decode tick, prefix pages
                   were shared and every page came back
 7. train        - Transformer-base (6+6 layers, d_model 512, vocab 30000,
                   dropout and label smoothing 0.1, Adam, fp32, unfused
                   attention) through ``fluid.Executor()`` on the card, 5
                   steps at batch 64 x length 256 on one batch: finite,
                   falling loss, and exactly 184 Adam, 2 xent-forward and 1
                   xent-backward launches a step; step time, target
                   tokens/s and peak memory; then two more steps fetch the
                   first dropout's tensors: Out = X * Mask, X@GRAD =
                   Out@GRAD * Mask, a kept share of 1 - p and fresh masks
                   each step, each within 5 standard errors
 8. train_parity - the same model at batch 2 x length 32, dropout 0, from
                   one initial state on the card and on the CPU (plain
                   versions): 3 steps' losses agree (rtol 1e-5 at step 0,
                   1e-4 after)

``--profile`` adds a phase after serving (8 requests that keep every slot
busy) and one after training (one more step), each under
``torch.profiler``; each prints the device's busy share of the wall time
and the kernels that take the most device time.

The last three lines are the kernels table, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# serving shape of the smoke model (Transformer-base widths, paged decode)
SLOTS, MAX_LEN, PAGE_SIZE, BUCKETS = 8, 512, 16, [32, 64, 128]
ATOL = RTOL = 1e-5
# training shape (bench.py's Transformer-base feed on an accelerator)
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, VOCAB = 64, 256, 5, 30000
XENT_IGNORE = 0            # the hard-label case's ignore_index (the pad id)
DX_ATOL = 1e-6
ADAM_TOL = 1e-6
# launches a training step makes of each kernel: one Adam per trainable
# parameter; the xent forward once in the op and once more when its
# generic grad re-runs it, the backward once
ADAM_PER_STEP, XENT_FWD_PER_STEP, XENT_BWD_PER_STEP = 184, 2, 1


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, iters, warmup=3):
    """Mean device time of one ``fn()`` call over ``iters`` back-to-back
    calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    # a float32 reference stays float32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build

    names = _build.all_kernels()
    t0 = time.perf_counter()
    _build.build(names)
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_logs.get(n, "")
                 .splitlines() if "registers" in ln or "smem" in ln]
             for n in names}
    emit("build", kernels=names, seconds=secs, ptxas=ptxas)


def paged_inputs(gen, device, s_n=SLOTS, n_pages=MAX_LEN // PAGE_SIZE,
                 ps=PAGE_SIZE, d=512):
    """The decode path's paged-attention inputs: a pool of s_n * n_pages
    pages plus the trash page, a shuffled page table whose pages past each
    slot's live length point at the trash page, ragged live lengths (one
    slot at 1, one full) with exact -inf past them."""
    import torch

    pool = s_n * n_pages
    ell = n_pages * ps
    q = torch.randn(s_n, 1, d, generator=gen, device=device) * d ** -0.5
    ck = torch.randn(pool + 1, ps, d, generator=gen, device=device)
    cv = torch.randn(pool + 1, ps, d, generator=gen, device=device)
    lens = torch.randint(1, ell + 1, (s_n,), generator=gen, device=device)
    lens[0], lens[-1] = 1, ell
    perm = torch.randperm(pool, generator=gen, device=device)
    pt = perm.reshape(s_n, n_pages).to(torch.int64)
    used = (lens + ps - 1) // ps
    cols = torch.arange(n_pages, device=device)[None, :]
    pt = torch.where(cols < used[:, None], pt, torch.full_like(pt, pool))
    idx = torch.arange(ell, device=device)[None, :]
    bias = torch.where(idx < lens[:, None], 0.0, float("-inf")).to(
        torch.float32).reshape(s_n, 1, ell)
    return q, ck, cv, pt, bias, lens


def bound_ms(nbytes, flops):
    """The least time on the card: bytes over the memory rate or fp32
    operations over the fp32 rate, whichever is larger, and which."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def paged_bound_ms(q, ck, pt, bias, lens):
    """The least time for this call on the card: the bytes it must move
    (q, bias, page table and output once, and the K and V rows the finite
    bias keeps, each distinct row once) over the memory rate, or its fp32
    operations over the fp32 rate, whichever is larger."""
    s_n, _, d = q.shape
    ps = ck.shape[1]
    live_rows = set()
    for s in range(s_n):
        for l in range(int(lens[s])):
            live_rows.add((int(pt[s, l // ps]), l % ps))
    n_live = int(lens.sum())
    nbytes = (2 * q.numel() * 4 + bias.numel() * 4 + pt.numel() * 8
              + 2 * len(live_rows) * d * 4)
    flops = n_live * (4 * d + 4)  # q.k and p.v FMAs, exp/max/sum/divide
    return bound_ms(nbytes, flops)


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    q, ck, cv, pt, bias, lens = paged_inputs(gen, device)
    out = pa.paged_attention(q, ck, cv, pt, bias, 1.0)
    again = pa.paged_attention(q, ck, cv, pt, bias, 1.0)
    torch.cuda.synchronize()
    ref = pa.paged_attention_ref(q, ck, cv, pt, bias, 1.0)
    diff = (out - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(1e-6)).max())
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("paged_attention kernel output is not finite")
    if not bool((diff <= ATOL + RTOL * ref.abs()).all()):
        raise AssertionError(
            f"paged_attention kernel disagrees with paged_attention_ref: "
            f"max abs err {max_abs}, max rel err {max_rel} "
            f"(atol {ATOL}, rtol {RTOL})")
    if not torch.equal(out, again):
        raise AssertionError("paged_attention kernel is not bitwise "
                             "repeatable")

    # time over one cache pool per decoder layer (6 x 16.8 MB > the 50 MB
    # L2), cycled, so each launch finds its K/V cold as a decode tick does
    n_sets = 6
    sets = [(ck.clone(), cv.clone()) for _ in range(n_sets)]
    it = [0]

    def rotating(fn):
        def call():
            k, v = sets[it[0] % n_sets]
            it[0] += 1
            return fn(q, k, v, pt, bias, 1.0)
        return call

    gk = ck[pt].reshape(q.shape[0], -1, q.shape[2])
    gv = cv[pt].reshape(q.shape[0], -1, q.shape[2])

    def library():
        return F.scaled_dot_product_attention(
            q[:, None], gk[:, None], gv[:, None],
            attn_mask=bias[:, None], scale=1.0)

    lib_out = library()[:, 0]
    ms = cuda_time_ms(rotating(pa.paged_attention), 300)
    plain_ms = cuda_time_ms(rotating(pa.paged_attention_ref), 100)
    library_ms = cuda_time_ms(library, 300)
    bound_ms, bound_by = paged_bound_ms(q, ck, pt.cpu(), bias, lens.cpu())
    emit("kernel", name="paged_attention", shape={
        "slots": q.shape[0], "d": q.shape[2], "page_size": ck.shape[1],
        "pages_per_slot": pt.shape[1], "pool_pages": ck.shape[0]},
        live_lengths=[int(x) for x in lens.cpu()], max_abs_err=max_abs,
        max_rel_err=max_rel, atol=ATOL, rtol=RTOL, bitwise_repeat=True,
        library_max_abs_err=float((lib_out - ref).abs().max()),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged.py:40",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def smoke_jobs(rng, vocab):
    """16 requests, twice the slots: prompt lengths 5-120, 32-64 new
    tokens, and two prompts in one bucket sharing a 32-token prefix (the
    second is 33 tokens long, so both of its full pages hit and its
    prefill dispatch is skipped)."""
    prefix = rng.integers(2, vocab, 32).tolist()
    jobs = [(prefix + rng.integers(2, vocab, 10).tolist(), 48),
            (prefix + rng.integers(2, vocab, 1).tolist(), 40)]
    for _ in range(14):
        plen = int(rng.integers(5, 121))
        jobs.append((rng.integers(2, vocab, plen).tolist(),
                     int(rng.integers(32, 65))))
    return jobs


def device_spans(prof):
    """(start us, end us, name) of every kernel, copy and memset a
    ``torch.profiler`` trace recorded on the device, in time order."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in (
                      "kernel", "gpu_memcpy", "gpu_memset"))


def trace_summary(prof):
    """Device busy time, event count and the kernels that take the most
    device time, read from a ``torch.profiler`` trace."""
    spans = device_spans(prof)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    by_name = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (b - a))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return busy / 1e6, len(spans), [
        {"name": k[:90], "count": n, "ms": us / 1e3, "share_of_busy": us / busy}
        for k, (n, us) in top]


def phase_profile(eng, jobs):
    """Where a decode tick's time goes: serve ``jobs`` (all slots busy)
    under ``torch.profiler`` — device busy share of the wall time, and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ticks0 = eng.metrics.counter("decode_ticks")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [eng.submit(p, n) for p, n in jobs]:
            f.result(timeout=600)
        eng.wait_idle(timeout_s=60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = eng.metrics.counter("decode_ticks") - ticks0
    busy_s, n_events, top = trace_summary(prof)
    emit("profile", requests=len(jobs), decode_ticks=ticks, wall_s=wall,
         device_busy_s=busy_s, device_busy_share=busy_s / wall,
         device_events=n_events, ms_per_tick=wall / ticks * 1e3,
         device_ms_per_tick=busy_s * 1e3 / ticks, top_kernels=top)


def phase_serving(profile_run=False):
    import numpy as np
    import torch

    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models.transformer import Config, DecodeModel
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import DecodeEngine

    framework.fresh_session()
    # Transformer-base widths (paddle_tpu_torch.models.transformer
    # .base_config) as the deterministic single-head decode LM
    cfg = Config("base_decode_lm", src_vocab_size=30000,
                 tgt_vocab_size=30000, d_model=512, d_inner=2048, n_head=8,
                 n_layer=6, dropout=0.0, label_smooth=0.0)
    model = DecodeModel(cfg, max_slots=SLOTS, max_len=MAX_LEN,
                        prefill_buckets=BUCKETS, paged=True,
                        page_size=PAGE_SIZE, seed=7)
    t0 = time.perf_counter()
    eng = DecodeEngine(model)  # the default place: the card
    try:
        eng.warmup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        pages_free0 = eng.metrics.gauge("kvpool_pages_free")
        jobs = smoke_jobs(np.random.default_rng(0), model.vocab_size)
        ticks0 = eng.metrics.counter("decode_ticks")

        pa.launches = 0
        t0 = time.perf_counter()
        futs = [eng.submit(p, n) for p, n in jobs]
        outs = [f.result(timeout=600) for f in futs]
        if not eng.wait_idle(timeout_s=60):
            raise AssertionError("engine did not go idle")
        wall = time.perf_counter() - t0
        launches = pa.launches

        snap = eng.metrics.snapshot()
        ticks = snap["decode_ticks"] - ticks0
        tokens = sum(len(o) for o in outs)
        expect = cfg.n_layer * ticks
        if launches != expect or launches == 0:
            raise AssertionError(
                f"paged_attention launched {launches} times in the serving "
                f"run; expected n_layer x decode_ticks = {expect}")
        if snap["prefix_hits"] <= 0:
            raise AssertionError("no prefix page was shared")
        if snap["kvpool_pages_free"] != pages_free0:
            raise AssertionError(
                f"pages leaked: {pages_free0} free before, "
                f"{snap['kvpool_pages_free']} after")
        for (prompt, max_new), got in zip(jobs, outs):
            if not 1 <= len(got) <= max_new or any(
                    not 0 <= t < model.vocab_size for t in got):
                raise AssertionError(f"malformed stream {got}")
        mismatched = [j for j, ((prompt, max_new), got)
                      in enumerate(zip(jobs, outs))
                      if eng.decode_static([(prompt, max_new)])[0][0] != got]
        if mismatched:
            raise AssertionError(
                f"continuous decode differs from decode_static for "
                f"requests {mismatched}")
        if eng.metrics.gauge("kvpool_pages_free") != pages_free0:
            raise AssertionError("decode_static leaked pages")
        if profile_run:
            phase_profile(eng, [(p, 64) for p, _ in jobs[2:2 + SLOTS]])
        emit("serving", requests=len(jobs), tokens_generated=tokens,
             decode_ticks=ticks, paged_attention_launches=launches,
             n_layer=cfg.n_layer, prefills=snap["prefills"],
             prefill_skips=snap["prefill_skips"],
             prefix_hits=snap["prefix_hits"],
             page_requeues=snap["page_requeues"],
             pages_free=snap["kvpool_pages_free"],
             continuous_equals_static=True, setup_s=setup_s, wall_s=wall,
             tokens_per_s=tokens / wall,
             ttft_p50_ms=snap["ttft_p50_ms"],
             intertoken_p50_ms=snap["intertoken_p50_ms"],
             max_memory_allocated=torch.cuda.max_memory_allocated())
    finally:
        eng.shutdown()
    return launches


def xent_bound_ms(r, v, soft, backward):
    """Each input read once, each output written once: logits, soft labels
    (or one int64 label a row), and per row loss, lse (and sum y) forward;
    lse, g1, g2 in and dx out backward.  Operations a logit: max, subtract,
    exp, add (+ multiply and two adds for soft labels) forward; subtract,
    exp, two multiplies and a subtract backward."""
    elems = r * v
    nbytes = elems * 4 + (elems * 4 if soft else r * 8)
    if backward:
        nbytes += elems * 4 + 3 * r * 4
        flops = elems * 5
    else:
        nbytes += (3 if soft else 2) * r * 4
        flops = elems * (7 if soft else 4)
    return bound_ms(nbytes, flops)


def _max_errs(got, want):
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff / want.abs().clamp_min(1e-6)).max()))


def phase_kernel_xent():
    """The training path's xent kernels at its shape, both label kinds;
    times for the soft-label case the path runs."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    r, v = TRAIN_BATCH * TRAIN_LEN, VOCAB
    x = torch.randn(r, v, generator=gen, device=device) * 2
    ids = torch.randint(1, v, (r,), generator=gen, device=device)
    # one_hot + label_smooth(0.1), as the training program builds them
    soft_y = torch.zeros(r, v, device=device).scatter_(
        1, ids[:, None], 1.0) * 0.9 + 0.1 / v
    hard_y = ids.clone()
    hard_y[::7] = XENT_IGNORE
    out = {}
    for soft, lab in ((True, soft_y), (False, hard_y)):
        kind = "soft" if soft else "hard"
        ignore = -100 if soft else XENT_IGNORE
        loss, lse, sum_y = fused.softmax_xent_fwd(x, lab, soft, ignore)
        loss2, lse2, _ = fused.softmax_xent_fwd(x, lab, soft, ignore)
        torch.cuda.synchronize()
        rloss, rlse, rsum = fused.softmax_xent_fwd_ref(x, lab, soft, ignore)
        if not (torch.equal(loss, loss2) and torch.equal(lse, lse2)):
            raise AssertionError(f"xent forward ({kind}) is not bitwise "
                                 f"repeatable")
        for name, got, want in (("loss", loss, rloss), ("lse", lse, rlse)):
            if not bool((got - want).abs().le(ATOL + RTOL * want.abs())
                        .all()):
                raise AssertionError(
                    f"xent forward ({kind}) {name} disagrees with the plain "
                    f"version: max abs/rel err {_max_errs(got, want)}")
        if not soft and not bool((loss[hard_y == XENT_IGNORE] == 0).all()):
            raise AssertionError("ignored rows have a nonzero loss")
        # backward from the same lse, every row's loss cotangent 1
        g1, g2 = fused.xent_bwd_coeffs(lab, rsum, torch.ones_like(rlse),
                                       None, soft, ignore)
        dx = fused.softmax_xent_bwd(x, lab, rlse, g1, g2, soft)
        dx2 = fused.softmax_xent_bwd(x, lab, rlse, g1, g2, soft)
        torch.cuda.synchronize()
        rdx = fused.softmax_xent_bwd_ref(x, lab, rlse, g1, g2, soft)
        if not torch.equal(dx, dx2):
            raise AssertionError(f"xent backward ({kind}) is not bitwise "
                                 f"repeatable")
        dx_err = float((dx - rdx).abs().max())
        if not dx_err <= DX_ATOL:
            raise AssertionError(f"xent backward ({kind}) disagrees with "
                                 f"the plain version: max abs err {dx_err}")
        out[kind] = {"loss_err": _max_errs(loss, rloss),
                     "lse_err": _max_errs(lse, rlse), "dx_max_abs_err": dx_err}
        del dx, dx2, rdx, rloss, rlse
    # times: the soft-label case the training path runs
    y = soft_y
    _, lse, sum_y = fused.softmax_xent_fwd(x, y, True)
    g1, g2 = fused.xent_bwd_coeffs(y, sum_y, torch.ones_like(lse), None, True)
    lib_err = float((F.cross_entropy(x, y, reduction="none")[:, None]
                     - fused.softmax_xent_fwd_ref(x, y, True)[0]).abs().max())
    fwd_ms = cuda_time_ms(lambda: fused.softmax_xent_fwd(x, y, True), 20)
    fwd_plain = cuda_time_ms(lambda: fused.softmax_xent_fwd_ref(x, y, True),
                             5)
    fwd_lib = cuda_time_ms(
        lambda: F.cross_entropy(x, y, reduction="none"), 20)
    bwd_ms = cuda_time_ms(
        lambda: fused.softmax_xent_bwd(x, y, lse, g1, g2, True), 20)
    bwd_plain = cuda_time_ms(
        lambda: fused.softmax_xent_bwd_ref(x, y, lse, g1, g2, True), 5)
    xr = x.detach().requires_grad_()
    ones = torch.ones(r, device=device)

    def kernel_pair():
        loss, _ = fused.SoftmaxXent.apply(xr, y, True, -100)
        return torch.autograd.grad(loss[:, 0], xr, ones)

    def library_pair():
        loss = F.cross_entropy(xr, y, reduction="none")
        return torch.autograd.grad(loss, xr, ones)

    pair_ms = cuda_time_ms(kernel_pair, 10)
    pair_lib = cuda_time_ms(library_pair, 10)
    fwd_bound, fwd_by = xent_bound_ms(r, v, True, backward=False)
    bwd_bound, bwd_by = xent_bound_ms(r, v, True, backward=True)
    emit("kernel_xent", rows=r, vocab=v, soft=out["soft"], hard=out["hard"],
         ignore_index=XENT_IGNORE, atol=ATOL, rtol=RTOL, dx_atol=DX_ATOL,
         bitwise_repeat=True, library_fwd_max_abs_err=lib_err,
         fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain, fwd_library_ms=fwd_lib,
         fwd_bound_ms=fwd_bound, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain,
         bwd_bound_ms=bwd_bound, fwd_bwd_pair_ms=pair_ms,
         library_fwd_bwd_pair_ms=pair_lib)
    src = "paddle_tpu_torch/csrc/softmax_xent.cu"
    return (
        {"name": "softmax_xent_fwd", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas_fused.py:130",
         "max_abs_err": max(out["soft"]["loss_err"][0],
                            out["soft"]["lse_err"][0],
                            out["hard"]["loss_err"][0],
                            out["hard"]["lse_err"][0]),
         "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": fwd_lib},
        {"name": "softmax_xent_bwd", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas_fused.py:185",
         "max_abs_err": max(out["soft"]["dx_max_abs_err"],
                            out["hard"]["dx_max_abs_err"]),
         "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "library_ms": None})


def phase_kernel_adam(shapes):
    """The Adam kernel over one tensor set per parameter shape of the
    training slice: one step against the plain version, then the step's
    kernel, plain, library and bound times."""
    import torch

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(2)
    b1, b2, eps = 0.9, 0.98, 1e-9
    lr_eff = torch.full((1,), 1e-3 * (1 - b2) ** 0.5 / (1 - b1),
                        device=device)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    sets = [(rnd(s), rnd(s, 1e-2), rnd(s, 1e-3), rnd(s, 1e-4).abs())
            for s in shapes]
    max_abs = max_rel = 0.0
    for p, g, m1, m2 in sets:
        want = fused.adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps)
        got = [t.clone() for t in (p, g, m1, m2)]
        fused.adam(got[0], got[1], got[2], got[3], lr_eff, b1, b2, eps)
        for a, w in zip((got[0], got[2], got[3]), want):
            if not bool((a - w).abs().le(ADAM_TOL + ADAM_TOL * w.abs())
                        .all()):
                raise AssertionError(f"adam kernel disagrees with the "
                                     f"plain version at {tuple(p.shape)}: "
                                     f"{_max_errs(a, w)}")
            e_abs, e_rel = _max_errs(a, w)
            max_abs, max_rel = max(max_abs, e_abs), max(max_rel, e_rel)
    n = sum(p.numel() for p, _, _, _ in sets)

    def kernel_step():
        for p, g, m1, m2 in sets:
            fused.adam(p, g, m1, m2, lr_eff, b1, b2, eps)

    def plain_step():
        for p, g, m1, m2 in sets:
            fused.adam_ref(p, g, m1, m2, lr_eff, b1, b2, eps)

    params = [torch.nn.Parameter(p.detach().clone()) for p, _, _, _ in sets]
    for p, (_, g, _, _) in zip(params, sets):
        p.grad = g
    opt = torch.optim.Adam(params, lr=1e-3, betas=(b1, b2), eps=eps,
                           fused=True)
    ms = cuda_time_ms(kernel_step, 10)
    plain_ms = cuda_time_ms(plain_step, 5)
    library_ms = cuda_time_ms(opt.step, 10)
    # the same step under the profiler: the kernels' own device time,
    # without the host's gaps between the 184 launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kernel_step()
        torch.cuda.synchronize()
    spans = [(a, b) for a, b, name in device_spans(prof) if "adam" in name]
    bound, bound_by = bound_ms(28 * n, 12 * n)
    emit("kernel_adam", tensors=len(sets), values=n, atol=ADAM_TOL,
         rtol=ADAM_TOL, max_abs_err=max_abs, max_rel_err=max_rel,
         step_ms=ms, step_kernels_device_ms=sum(b - a for a, b in spans)
         / 1e3, step_kernels_profiled=len(spans), plain_step_ms=plain_ms,
         library_step_ms=library_ms, bound_ms=bound,
         smallest=min(p.numel() for p in params),
         largest=max(p.numel() for p in params))
    return {"name": "adam", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/adam.cu",
            "replaces": "paddle_tpu/ops/pallas_fused.py:496",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}


def build_training(batch_len, dropout=None):
    """Transformer-base as the training slice builds it (unfused attention;
    the config's dropout unless given): (main, startup, avg_cost)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import transformer

    framework.fresh_session()
    cfg = transformer.base_config()
    cfg.flash_attention = False
    if dropout is not None:
        cfg.dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, cost = transformer.build(cfg, src_len=batch_len,
                                          tgt_len=batch_len, lr=1e-3)
    return main, startup, cost


def train_feed(batch, seq_len, seed=0):
    """bench.py's Transformer feed: uniform ids in [1, vocab)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"src_word": rng.randint(1, VOCAB, size=(batch, seq_len)),
            "tgt_word": rng.randint(1, VOCAB, size=(batch, seq_len)),
            "lbl_word": rng.randint(1, VOCAB, size=(batch, seq_len, 1))}


def check_dropout(exe, main, feed, scope, n_se=5.0):
    """Two more training steps fetching the first dropout op's X, Out and
    Mask and the grads of X and Out: Out = X * Mask and X@GRAD = Out@GRAD *
    Mask exactly, the mask holds only 0 and its keep value, its kept share
    is within ``n_se`` standard errors of 1 - p, and the two steps' masks
    differ in a share within ``n_se`` standard errors of 2p(1 - p), as
    independent draws do."""
    import numpy as np

    op = next(o for o in main.global_block().ops if o.type == "dropout")
    p = float(op.attr("dropout_prob"))
    keep = (1.0 / (1.0 - p) if op.attr("dropout_implementation")
            == "upscale_in_train" else 1.0)
    x_name, out_name = op.input("X")[0], op.output("Out")[0]
    names = [x_name, out_name, op.output("Mask")[0], x_name + "@GRAD",
             out_name + "@GRAD"]
    kept, masks = [], []
    for _ in range(2):
        x, out, mask, dx, dout = exe.run(main, feed=feed, fetch_list=names,
                                         scope=scope)
        if not np.array_equal(out, x * mask):
            raise AssertionError("dropout Out is not X * Mask")
        if not np.array_equal(dx, dout * mask):
            raise AssertionError("dropout_grad is not Out@GRAD * Mask")
        if not np.isin(mask, (0.0, keep)).all():
            raise AssertionError(f"dropout Mask holds values other than 0 "
                                 f"and {keep}")
        kept.append(float((mask != 0).mean()))
        masks.append(mask != 0)
    n = masks[0].size
    kept_se = (p * (1 - p) / n) ** 0.5
    q = 2 * p * (1 - p)
    differ = float((masks[0] != masks[1]).mean())
    differ_se = (q * (1 - q) / n) ** 0.5
    if not all(abs(k - (1 - p)) <= n_se * kept_se for k in kept):
        raise AssertionError(f"dropout kept shares {kept}, expected {1 - p} "
                             f"within {n_se} x {kept_se}")
    if not abs(differ - q) <= n_se * differ_se:
        raise AssertionError(f"successive dropout masks differ in {differ} "
                             f"of places, expected {q} within {n_se} x "
                             f"{differ_se}")
    return {"op_input": x_name, "values": n, "dropout_prob": p,
            "kept_shares": kept, "kept_se": kept_se,
            "masks_differ_share": differ, "differ_se": differ_se,
            "out_is_x_times_mask": True, "grad_is_dout_times_mask": True}


def phase_train(progs, profile_run=False):
    """The training main path on the card; returns the kernels' launch
    counts over its steps."""
    import math

    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import fused

    main, startup, cost = progs
    exe = fluid.Executor()  # the default place: the card
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = train_feed(TRAIN_BATCH, TRAIN_LEN)
    torch.cuda.reset_peak_memory_stats()
    fused.xent_fwd_launches = fused.xent_bwd_launches = 0
    fused.adam_launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.reshape(-1)[0]))
    counts = {"softmax_xent_fwd": fused.xent_fwd_launches,
              "softmax_xent_bwd": fused.xent_bwd_launches,
              "adam": fused.adam_launches}
    want = {"softmax_xent_fwd": XENT_FWD_PER_STEP * TRAIN_STEPS,
            "softmax_xent_bwd": XENT_BWD_PER_STEP * TRAIN_STEPS,
            "adam": ADAM_PER_STEP * TRAIN_STEPS}
    if counts != want:
        raise AssertionError(f"kernel launches over {TRAIN_STEPS} training "
                             f"steps: {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    steady = step_ms[1:]
    tokens = TRAIN_BATCH * TRAIN_LEN
    peak = torch.cuda.max_memory_allocated()
    emit("train", model="transformer_base", batch=TRAIN_BATCH,
         seq_len=TRAIN_LEN, steps=TRAIN_STEPS, losses=losses,
         launches=counts, startup_s=startup_s, step_ms=step_ms,
         steady_step_ms=sum(steady) / len(steady),
         target_tokens_per_s=tokens * len(steady) / (sum(steady) / 1e3),
         max_memory_allocated=peak,
         dropout=check_dropout(exe, main, feed, scope))
    if profile_run:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_s, n_events, top = trace_summary(prof)
        emit("train_profile", wall_s=wall, device_busy_s=busy_s,
             device_busy_share=busy_s / wall, device_events=n_events,
             top_kernels=top)
    return counts


def phase_train_parity():
    """One initial state, 3 steps on the card and on the CPU (the plain
    versions): the losses agree."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.transformer import load_reference_params

    batch, seq_len = 2, 32
    main, startup, cost = build_training(seq_len, dropout=0.0)
    feed = train_feed(batch, seq_len, seed=1)
    runs = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope))
    init = {v.name: runs[0][1].get(v.name).numpy()
            for v in startup.list_vars() if v.persistable}
    load_reference_params(runs[1][1], init, fluid.CUDAPlace(0))
    losses = [[float(exe.run(main, feed=feed, fetch_list=[cost],
                             scope=scope)[0].reshape(-1)[0])
               for _ in range(3)] for exe, scope in runs]
    cpu, gpu = np.array(losses[0]), np.array(losses[1])
    param_diff = max(float((runs[1][1].get(p.name).cpu()
                            - runs[0][1].get(p.name)).abs().max())
                     for p in main.global_block().all_parameters())
    rel = np.abs(gpu - cpu) / np.abs(cpu)
    tol = np.array([1e-5, 1e-4, 1e-4])
    if not (np.isfinite(gpu).all() and (rel <= tol).all()):
        raise AssertionError(f"card and CPU training losses disagree: card "
                             f"{gpu.tolist()}, CPU {cpu.tolist()} (rel "
                             f"{rel.tolist()}, tolerance {tol.tolist()})")
    emit("train_parity", batch=batch, seq_len=seq_len, card_losses=gpu.tolist(),
         cpu_losses=cpu.tolist(), rel_err=rel.tolist(), rtol=tol.tolist(),
         params_max_abs_diff_after=param_diff, values_carried=len(init),
         torch_threads=torch.get_num_threads())


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the serving and training checks, profile a "
                         "full-slot decode run and a training step and "
                         "print where their time goes")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repo "
                         "(paddle_tpu_torch/ not found beside this script)")
    sys.path.insert(0, here)
    smi = phase_device()
    phase_build()
    import torch

    paged = phase_kernel()
    xent_fwd, xent_bwd = phase_kernel_xent()
    torch.cuda.empty_cache()
    progs = build_training(TRAIN_LEN)
    adam = phase_kernel_adam(
        [tuple(p.shape) for p in progs[0].global_block().all_parameters()
         if p.trainable])
    torch.cuda.empty_cache()
    paged["launches"] = phase_serving(args.profile)
    counts = phase_train(progs, args.profile)
    for k in (xent_fwd, xent_bwd, adam):
        k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    phase_train_parity()
    print(json.dumps({"kernels": [paged, xent_fwd, xent_bwd, adam]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
