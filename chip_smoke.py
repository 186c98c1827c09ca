#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: builds every CUDA kernel from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the serving path
gives it, then serves a Transformer-base-width paged decode LM through the
continuous-batching ``DecodeEngine`` and checks its output.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

 1. device   - a CUDA device is present; fp32 matmuls stay full fp32
 2. build    - nvcc builds ``paddle_tpu_torch/csrc/*.cu`` (one process per
               source, all started together)
 3. kernel   - paged attention vs ``paged_attention_ref`` at S=8, D=512,
               page_size=16, 32 pages per slot, a pool of 8*32+1 pages,
               a shuffled page table with trash entries and ragged -inf
               bias; bitwise repeatability; kernel, plain and library
               times and the memory-bound time
 4. serving  - 16 requests (two sharing a 32-token prefix) through a
               6-layer d_model 512 / d_inner 2048 / vocab 30000 paged
               decode model with random weights from a seed: every stream
               equals ``decode_static`` of it alone bitwise, the kernel ran
               n_layer times per decode tick, prefix pages were shared and
               every page came back

``--profile`` adds a phase after serving: 8 requests that keep every slot
busy, run under ``torch.profiler``; it prints the device's busy share of
the wall time and the kernels that take the most device time.

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


def paged_bound_ms(q, ck, pt, bias, lens):
    """The least time for this call on the card: the bytes it must move
    (q, bias, page table and output once, and the K and V rows the finite
    bias keeps, each distinct row once) over the memory rate, or its fp32
    operations over the fp32 rate, whichever is larger."""
    import torch

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
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def phase_profile(eng, jobs):
    """Where a decode tick's time goes: serve ``jobs`` (all slots busy)
    under ``torch.profiler`` and read the device's kernel intervals from
    its trace — device busy share of the wall time, and the kernels that
    take the most device time."""
    import tempfile

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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
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
    emit("profile", requests=len(jobs), decode_ticks=ticks, wall_s=wall,
         device_busy_s=busy / 1e6, device_busy_share=busy / 1e6 / wall,
         device_events=len(spans), ms_per_tick=wall / ticks * 1e3,
         device_ms_per_tick=busy / 1e3 / ticks,
         top_kernels=[{"name": k[:90], "count": n, "ms": us / 1e3,
                       "share_of_busy": us / busy}
                      for k, (n, us) in top])


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


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the serving checks, profile a full-slot "
                         "decode run and print where its time goes")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repo "
                         "(paddle_tpu_torch/ not found beside this script)")
    sys.path.insert(0, here)
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    kernel["launches"] = phase_serving(args.profile)
    import torch

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
