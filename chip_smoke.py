#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card: builds every CUDA kernel from the sources in this checkout, holds
each against its plain PyTorch version at the shapes the port's paths give
it, then serves a Transformer-base-width paged decode LM through the
continuous-batching ``DecodeEngine``, trains Transformer-base through
``fluid.Executor`` with unfused attention and through the flash kernels,
and trains ResNet-50 with momentum, in fp32 and then under bf16 / fp16
mixed precision (``fluid.amp``; Transformer-base also through the bf16
flash kernels), then trains Transformer-base and ResNet-50 under AMP as
``Executor.run_steps`` windows (one CUDA graph a step) and the fp16 loss
scaler's window, then evaluates, saves, resumes and deploys Transformer-base
and ResNet-50 (``Program.clone(for_test=True)``, ``fluid.io``, the
inference predictor), then trains BERT-base through the bf16 flash kernels,
DeepFM with SelectedRows sparse SGD (per step and as a graphed window),
SE-ResNeXt-50, VGG-16 and the MNIST CNN of ``benchmark/fluid/mnist.py``,
and checks them all.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

 1. device       - a CUDA device is present; fp32 matmuls stay full fp32
 2. build        - nvcc builds ``paddle_tpu_torch/csrc/*.cu`` (one process
                   per source, all started together)
 3. kernel       - paged attention vs ``paged_attention_ref`` at S=8,
                   D=512, page_size=16, 32 pages per slot, a pool of
                   8*32+1 pages, a shuffled page table with trash entries
                   and ragged -inf bias; bitwise repeatability; each slot
                   alone, and with its page table cut to the pages it
                   uses, bitwise equal to its row of the batch; the dead
                   chunks and the CUDA launches of a call; a call's time
                   replayed from a CUDA graph, its kernels' device time,
                   eager and host times, plain and library times and the
                   memory-bound time
 4. kernel_xent  - the softmax-cross-entropy forward and backward kernels
                   vs their plain versions at the training path's shape
                   (R = 64 x 256 rows, V = 30000): soft labels from
                   one_hot + label_smooth, and hard labels with
                   ignore_index rows; bitwise repeatability; kernel, plain,
                   library and bound times
 5. kernel_xent_amp - the same with bf16 and fp16 logits (soft labels
                   fp32): loss and lse at the fp32 tolerance, dx within 1
                   ulp of its dtype, bitwise repeatability; kernel, plain,
                   F.cross_entropy (on the same low logits) and bound
                   times, soft and hard labels
 6. kernel_adam  - the Adam group kernel vs its plain version in one call
                   over tensors of the training slice's 184 parameter
                   shapes, and over a ragged group (odd sizes, empty and
                   1-element tensors, a view off 16-byte alignment), each
                   tensor with beta pows of its own step count: exactly
                   one launch a call; the call's time between CUDA events,
                   its kernel's device time, plain, library
                   (torch.optim.Adam fused), host and bound times
 7. kernel_flash - the flash forward, dQ and dK/dV kernels vs their plain
                   versions at the training path's shape (B = 64, H = 8,
                   T = 256, D = 64): non-causal with a ragged padding bias,
                   causal, and Tq = 100 / Tk = 77 causal with a bias, then
                   the ragged case at D = 16, 32 and 128; bitwise
                   repeatability; kernel, plain and SDPA times (forward,
                   and forward + backward under autograd); each kernel's
                   bound on both routes (the tensor cores' TF32 rate, three
                   products per fp32 product, and the CUDA cores' fp32
                   rate; ``bound_ms`` the lesser, the CUDA cores' beside
                   it as ``*_fp32_core_bound_ms``); registers, spills and
                   blocks per SM of each kernel at each head width
 8. serving      - 16 requests (two sharing a 32-token prefix) through a
                   6-layer d_model 512 / d_inner 2048 / vocab 30000 paged
                   decode model with random weights from a seed: every
                   stream equals ``decode_static`` of it alone bitwise, the
                   kernel ran n_layer times per decode tick, prefix pages
                   were shared and every page came back; every dispatch
                   one CUDA-graph replay (``warmup()`` captured the step
                   and the 3 prefill buckets, no capture and no eager run
                   after it), the graph pools' bytes, and an all-idle
                   tick's host-clocked ms graphed against ``Executor.run``
                   of the same step (eager) in turns
 8b. serving_spec - the same model and requests through speculative
                   engines, k = 4, with a 1-layer and a full-depth
                   self-draft (9 graphs each), then the 1-layer engine
                   under the draft-poison drill: every stream bitwise the
                   plain engine's (and the spec engine's own
                   ``decode_static``), paged attention launched n_layer x
                   (plain + tail + 5 x verify ticks) times, one replay a
                   dispatch, no page leaked, the full-depth draft accepts
                   everything, the drill trips the controller;
                   acceptance, tokens a spec tick, draft and verify ms a
                   spec tick, tokens/s
 9. train        - Transformer-base (6+6 layers, d_model 512, vocab 30000,
                   dropout and label smoothing 0.1, Adam, fp32, unfused
                   attention) through ``fluid.Executor()`` on the card, 5
                   steps at batch 64 x length 256 on one batch: finite,
                   falling loss, and exactly 1 Adam launch for 184 tensors,
                   2 xent-forward and 1 xent-backward launches a step; op
                   dispatches a step; step time, target
                   tokens/s and peak memory; then two more steps fetch the
                   first dropout's tensors: Out = X * Mask, X@GRAD =
                   Out@GRAD * Mask, a kept share of 1 - p and fresh masks
                   each step, each within 5 standard errors
10. train_parity - the same model at batch 2 x length 32, dropout 0, from
                   one initial state on the card and on the CPU (plain
                   versions): 3 steps' losses agree (rtol 1e-5 at step 0,
                   1e-4 after)
11. train_flash  - the model of phase 9 with ``flash_attention=True``: its
                   18 attention ops run the flash kernels; 5 steps, finite
                   falling loss, exactly 36 forward, 18 dQ and 18 dK/dV
                   flash launches a step besides 1 / 2 / 1; step time,
                   target tokens/s and peak memory beside phase 9's
12. train_flash_parity - batch 2 x length 32, dropout 0, one initial
                   state: the flash build on the card against the same on
                   the CPU (rtol 1e-5 at step 0, 1e-4 after) and against
                   the unfused build on the card (rtol 2e-4)
13. kernel_momentum - the momentum group kernel vs its plain version in
                   one call over tensors of ResNet-50's 161 parameter
                   shapes and over phase 6's ragged group, Nesterov off
                   and on: exactly one launch a call; the call's time
                   between CUDA events, its kernel's device time, plain,
                   library (torch.optim.SGD fused), host and bound times
14. train_resnet - ResNet-50 (bench.py's accelerator run: 224 px, 1000
                   classes, Momentum(0.1, 0.9), fp32, batch 256 of normal
                   images) through ``fluid.Executor()`` on the card, 5
                   steps on one batch: finite losses, exactly 1 momentum
                   launch a step for 161 tensors and no other kernel's; op
                   dispatches a step; step time, images/s and peak
                   memory
15. conv_fp32    - the conv2d op and its grad on the card with cuDNN's TF32
                   switched on by the caller: within 1e-5 of the largest
                   magnitude of a float64 convolution (a plain TF32 call's
                   error is printed beside it)
16. train_resnet_parity - ResNet-50 at 64 px, 10 classes, lr 0.01, batch
                   4, one initial state on the card and on the CPU, the
                   card re-synced to the CPU's state before each of 3
                   steps: each step's loss (rtol 1e-4), the running stats
                   after it (rtol 1e-3, atol 1e-4) and the velocities as
                   one vector (cosine >= 0.999); 1 momentum launch a step
17. train_amp    - phase 9's model and feed under fluid.amp bf16 with kept
                   activations (bench.py's accelerator run): finite,
                   falling loss, exactly 2 bf16 xent-forward, 1 bf16
                   xent-backward and 1 Adam launch a step and no fp32
                   xent launch; op dispatches, step time, target tokens/s
                   and peak memory beside phase 9's
18. train_amp_parity - phase 10's run in bf16 with kept activations, card
                   against CPU: losses within 2^-8
19. train_resnet_amp - phase 14's model and feed in bf16 with kept
                   activations: finite losses, exactly 1 momentum launch a
                   step for 161 tensors; images/s and peak memory
20. train_amp_fp16_scaler - the tiny Transformer in fp16 with kept
                   activations and the dynamic loss scaler from a scale
                   (2^24) that overflows step 1: an overflow step leaves
                   every read-write persistable bitwise as it was and
                   halves the scale, good steps train and grow it after 3
                   in a row; fp16 xent launches every step, Adam on good
                   steps only
21. kernel_flash_amp - phase 7's cases with bf16 and fp16 q, k, v, dO (the
                   padded cases with the bias in fp32 and in the inputs'
                   dtype), then the other head widths: out, dq, dk, dv
                   within ``FLASH_LOW_TOL`` (1 ulp of the dtype plus 2^-14
                   of the largest magnitude), lse within (1e-5, 1e-5),
                   bitwise repeatability; in fp16 a case whose dS passes
                   65504 (dO at 4000 x normal): dq, dk and dv finite
                   exactly where the plain versions' are, within the
                   tolerance there, two launches bitwise equal; kernel,
                   plain and SDPA times (SDPA
                   on the same low inputs: forward, forward + backward, and
                   its backward alone beside dQ + dK/dV), each kernel's
                   bound (bytes at 2 bytes a value; products once at the
                   bf16 tensor-core rate), each kernel's name, registers,
                   spills and blocks per SM, and the HGMMA (wgmma)
                   instructions in its SASS: the forward, dQ and dK/dV
                   must be the wgmma kernels, with HGMMA and no spill, at
                   every head width; dQ's kernels-line entry carries
                   SDPA's backward alone as its library time
22. train_flash_amp - phase 11's model under bf16 with kept activations:
                   finite, falling loss, exactly 36 / 18 / 18 bf16 flash
                   launches a step and no fp32 one, 2 / 1 bf16 xent and 1
                   Adam launch; op dispatches, step time, target tokens/s
                   and peak memory beside train_amp's and train_flash's
23. train_flash_amp_parity - phase 12 in bf16 with kept activations: card
                   against CPU within 2^-8, flash against unfused on the
                   card within ``FLASH_AMP_UNFUSED_RTOL``
24. train_flash_amp_fp16_scaler - phase 20 with the tiny model's attention
                   through the fp16 flash kernels (D = 16): the same scaler
                   contract, 12 / 6 / 6 fp16 flash launches every step
25. train_window_flash_amp - phase 22's model and feed through
                   ``Executor.run_steps``: two windows of 5 steps on one
                   executor (the first runs a step eagerly, captures the
                   next as a CUDA graph, and replays it; the second
                   replays 5 times) against 10 ``Executor.run`` steps from
                   a copy of the same state (generator included): every
                   state tensor and the fetched loss bitwise, or else the
                   loss within ``FLASH_AMP_UNFUSED_RTOL``, the worst
                   difference printed; the windows' launches equal the
                   per-step constants x 10 (the wrappers count a replay's
                   share); the graphed and eager step's device ms (CUDA
                   events around 5 steps), the capture's time and the
                   graph pool's bytes; with ``--profile`` a third window
                   under the profiler: busy share, graph launches and
                   host kernel launches a step
26. train_window_resnet_amp - phase 19's model and feed the same way (1
                   momentum launch a step, loss within 2^-8); then
                   train_window_resnet_prefetch: ``feed_per_step`` windows
                   fed by ``DevicePrefetcher`` (pinned memory, a side
                   stream) at depth 2, and staged in the loop at depth 0:
                   each loop's host-clocked ms a step
27. train_window_fp16_scaler - the tiny Transformer in fp16 (flash, dynamic
                   scale from twice the largest a probe run found to fit,
                   noam with ``warmup_steps=8``): an 8-step window bitwise
                   equal to 8 guarded ``Executor.run`` steps from a copy of
                   the same state (parameters, moments, scale, good-step
                   counter, ``@STEP_COUNTER@``, generator, last loss and
                   learning rate), the first step skipped on the card's
                   flag, Adam launched every step (the window runs the
                   update and commits it only where the flag says)
28. persist_flash_amp - Transformer-base (batch 64 x 256, dropout 0) in
                   bf16 with kept activations through the flash kernels:
                   2 steps, then ``main.clone(for_test=True)`` on the next
                   batch: exactly 18 bf16 flash forwards and 1 bf16 xent
                   forward, no backward or Adam launch, every persistable
                   bitwise unchanged, the loss within 2^-8 of the next
                   training step's; ``save_persistables`` (bytes, seconds),
                   2 more steps (run A), a fresh scope's startup and
                   ``load_persistables`` (bitwise the saved state), the
                   same 2 steps (run B) within 2^-8 of A; then
                   ``save_inference_model`` of the logits and a predictor
                   on the card in a fresh scope: its logits the eval
                   clone's (bitwise, or within 2^-8 of the largest), 18
                   bf16 flash forwards and no xent a batch, its ms a batch
                   (CUDA events, 10 runs) and its op count
29. persist_resnet_amp - ResNet-50 (batch 256, 224 px) in bf16: 2 steps,
                   ``save_persistables``, 2 more ``Executor.run`` steps
                   (run A); a fresh scope, ``load_persistables``, one
                   ``run_steps`` window of 2 (run B): loss and every state
                   tensor bitwise A's; 6 momentum launches in all
30. infer_resnet - phase 29's trained scope as an fp32 inference model:
                   a native predictor and an ``AnalysisConfig`` one (the
                   conv + batch_norm fold) on the card at batch 256: no
                   ``batch_norm`` op after the fold, outputs within rtol
                   1e-4 / atol 1e-5 (the reference's bound), images/s of
                   each (CUDA events)

31. kernel_flash_bert - the bf16 flash forward, dQ and dK/dV kernels at
                   BERT-base's shape (B = 32, H = 12, T = 128, D = 64: one
                   key tile, 384 items), with a ragged fp32 key-padding
                   bias and without: within ``FLASH_LOW_TOL``, bitwise
                   repeatability; kernel (graph replays), plain, bound and
                   SDPA times
32. kernel_adam_bert_base, kernel_adam_vgg16, kernel_adam_mnist_cnn,
    kernel_momentum_se_resnext50 - phases 6 and 13 over tensors of
                   BERT-base's 159, VGG-16's 60, the MNIST CNN's 6 and
                   SE-ResNeXt-50's 225 parameter shapes (the kernels
                   line's adam and momentum entries carry them,
                   ``by_model``)
33. train_bert_amp - BERT-base pretraining (``bert.build(base_config(),
                   seq_len=128, n_mask=16, lr=1e-4)``, ``fluid_benchmark.py``'s
                   bert) in bf16 with kept activations through the flash
                   kernels, batch 32 of ``synthetic_batch`` from
                   ``RandomState(0)``, 5 steps: finite losses, exactly 24 /
                   12 / 12 bf16 flash launches and 1 Adam launch for 159
                   tensors a step; step ms (host and CUDA events),
                   tokens/s, peak allocated; the same 5 steps from the same
                   state with the plain Adam on the card: losses within
                   2^-8
34. train_bert_parity - ``tiny_config`` through the flash kernels at batch 2
                   x 32 (padded keys), 3 steps from one state, card against
                   CPU: fp32 rtol 1e-5 at step 0 and 1e-4 after, bf16 2^-8
35. train_deepfm - DeepFM (26 fields, 100,000 ids, k = 16, sparse tables,
                   SGD 1e-3, batch 32): 5 ``Executor.run`` steps, each
                   table grad a SelectedRows of 832 rows, every row no id
                   looked up bitwise unchanged, the looked-up rows the dense
                   update within 1e-6 of the table; then
                   train_window_deepfm: two ``run_steps`` windows of 5
                   fed per step on 10 fresh batches against 10
                   ``Executor.run`` steps on the same batches from one
                   state (losses within 1e-5, 1 eager step and then one
                   graph replay a step; train_window_deepfm_rows: the rows
                   no batch looked up bitwise the startup's); examples/s of
                   both paths
36. train_deepfm_parity - the same model, 3 steps from one state, card
                   against CPU: rtol 1e-5 at step 0 and 1e-4 after
37. train_bench_vision - SE-ResNeXt-50 (224 px, 1000 classes, Momentum
                   0.9), VGG-16 (32 px, 10 classes, Adam) and the MNIST CNN
                   (Adam), batch 32, lr 1e-3, bf16 with kept activations, 3
                   steps each: finite losses, 1 momentum launch (225
                   tensors) or 1 Adam launch (60, 6) a step; step ms,
                   images/s, peak allocated
38. train_se_resnext_parity - SE-ResNeXt-50 at 64 px, 10 classes, batch
                   4, fp32, one step card against CPU as
                   train_resnet_parity compares

``--profile`` adds a phase after serving (8 requests that keep every slot
busy; with the graph launches a dispatch and the host's kernel launches a
tick) and one after each full-size training phase (one more step, or
one more window), each under ``torch.profiler``; each prints the device's busy share of the
wall time and the kernels that take the most device time.

Before the last three lines, ``total`` prints the run's seconds.  The last
three lines are the kernels table (the bf16 flash entries also carry
their times at BERT-base's shape, ``bert_shape``), the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32
# FLOP/s outside the tensor cores, and TF32 and bf16 FLOP/s on the tensor
# cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989.4e12

# serving shape of the smoke model (Transformer-base widths, paged decode)
SLOTS, MAX_LEN, PAGE_SIZE, BUCKETS = 8, 512, 16, [32, 64, 128]
# the serving_spec phase: speculation depth, and the self-draft depths it
# runs (1: the reference's default; 0: full depth, acceptance 1.0)
SPEC_K, SPEC_DRAFT_LAYERS = 4, (1, 0)
ATOL = RTOL = 1e-5
# training shape (bench.py's Transformer-base feed on an accelerator)
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, VOCAB = 64, 256, 5, 30000
XENT_IGNORE = 0            # the hard-label case's ignore_index (the pad id)
DX_ATOL = 1e-6
# bf16 / fp16 logits: dx is one fp32 value rounded to its dtype in the
# kernel and in the plain version; the two fp32 values differ by an ulp or
# two of fp32 (expf against torch.exp), so the rounded ones by at most one
# ulp of the low dtype
XENT_DX_ULPS = 1
ADAM_TOL = 1e-6
# launches a training step makes of each kernel: one Adam launch for the
# Executor's group of the 184 adam ops (one a trainable parameter); the
# xent forward once in the op and once more when its generic grad re-runs
# it, the backward once
ADAM_PER_STEP, XENT_FWD_PER_STEP, XENT_BWD_PER_STEP = 1, 2, 1
ADAM_TENSORS_PER_STEP = 184
# flash attention on the training path: 8 heads of width 64; 18
# ring_attention ops a step (6 encoder self, 6 decoder self with causal, 6
# cross), each launching the forward in the op and again in its generic
# grad, and dQ and dK/dV once
FLASH_HEADS, FLASH_D, FLASH_OPS = 8, 64, 18
FLASH_FWD_PER_STEP = 2 * FLASH_OPS
FLASH_DQ_PER_STEP = FLASH_DKV_PER_STEP = FLASH_OPS
# kernel vs plain version, (atol, rtol): float32 on both sides.  All three
# kernels multiply on the tensor cores by 3xTF32 (three TF32 products per
# fp32 product, ~2^-21 relative each; see tests/test_torch_flash_tf32.py);
# the sums' order differs too (the forward's online softmax over key tiles
# against the plain whole-row softmax; dQ's and dK/dV's sums tile by tile).
# Worth a few ulps of values of order 1-10 (out ~0.1, lse ~6, gradients up
# to ~10)
FLASH_TOL = {name: (1e-5, 1e-5) for name in ("out", "lse", "dq", "dk", "dv")}
# the same kernels on bf16 / fp16 q, k, v and dO (AMP with kept
# activations).  out, dq, dk and dv are each one fp32 value rounded once to
# the input dtype, in the kernel and in the plain version alike, so where
# the two fp32 values lie within an ulp of that dtype the outputs part by
# at most one ulp of it; plus a floor of 2^-14 of the tensor's largest
# magnitude for what the fp32 values do differ by where a sum cancels
# (dS sums to ~0 over a row, so a dk or dq element can be small beside its
# terms): the split P and dS (hi + lo in the input type, ~16 bits of each
# term) and the tensor core's truncated sums over up to 256 keys.  A single bf16
# rounding of P or dS (2^-9 of each term) does not fit it
# (tests/test_torch_flash_amp_split.py).  lse is fp32 on both sides, as in
# FLASH_TOL
FLASH_LOW_TOL = {"ulps": 1, "floor": 2.0 ** -14, "lse": FLASH_TOL["lse"]}
# ResNet-50 training (bench.py's accelerator run): one momentum launch for
# the Executor's group of the 161 momentum ops, one a trainable parameter
# (53 conv filters, 53 BN scales and biases, fc w, b)
RESNET_BATCH, RESNET_STEPS, MOMENTUM_PER_STEP = 256, 5, 1
MOMENTUM_TENSORS_PER_STEP = 161
MOMENTUM_TOL = 1e-6
# ResNet-50 at 64 px in float32 is ill-conditioned: a change of one part in
# 5e6 in the input moves its step-0 gradients by more than 5 % of a
# tensor's largest value and the step-1 loss by more than 1e-3
# (tests/test_torch_resnet.py::test_float32_trajectory_is_chaotic), so the
# card and the CPU are compared step by step from one state
# AMP: bf16 with kept activations, as bench.py runs on an accelerator.
# The card and the CPU sum each bf16 product in another order, so an
# occasional bf16 rounding lands on the other neighbour and the losses,
# fp32 means of bf16 logits, part by a few parts in 1e4 over 3 steps: held
# within one bf16 relative step, 2^-8
AMP_PARITY_RTOL = 2.0 ** -8
# the flash build against the unfused build, both in bf16 with kept
# activations: the unfused attention rounds P to bf16 (2^-9 of each
# weight, amp.einsum) and takes its softmax in bf16, the flash kernels keep
# P in fp32; on the CPU at tiny width their losses part by up to 4.0e-4
# over 3 steps (tests/test_torch_flash_amp.py holds them to this bound):
# held, as above, within one bf16 relative step
FLASH_AMP_UNFUSED_RTOL = 2.0 ** -8
# the fp16 dynamic loss scaler on the tiny Transformer: the seed 2^24 over
# 4 x 16 target tokens is 2^18 as it enters the fp16 products, past fp16's
# 65504, so step 1 overflows and the scale halves until the products fit
FP16_BATCH, FP16_LEN, FP16_STEPS = 4, 16, 24
FP16_INIT_SCALE, FP16_GROWTH = 2.0 ** 24, 3
# Executor.run_steps windows: two windows of WINDOW_STEPS steps against
# 2 x WINDOW_STEPS Executor.run steps; the ResNet prefetch loops run
# PREFETCH_WINDOWS windows; the fp16 scaler's window is FP16_WINDOW steps
WINDOW_STEPS, PREFETCH_WINDOWS, FP16_WINDOW = 5, 3, 8
RESNET_PARITY_LOSS_RTOL = 1e-4
RESNET_PARITY_STATS_TOL = (1e-3, 1e-4)  # (rtol, atol)
RESNET_PARITY_VELOCITY_COSINE = 0.999
# BERT-base pretraining (fluid_benchmark.py's bert on an accelerator: batch
# 32 x 128, n_mask = 128 // 8): 12 heads of width 64 in 12 layers; each
# ring_attention op launches the forward in the op and again in its
# generic grad, and dQ and dK/dV once; one Adam launch for the group of
# the 159 adam ops (3 tables, 2 x 2 embedding / MLM layer-norm tensors,
# 12 a layer, 6 head weights and biases)
BERT_BATCH, BERT_LEN, BERT_MASK, BERT_STEPS = 32, 128, 16, 5
BERT_HEADS, BERT_D, BERT_LAYERS = 12, 64, 12
BERT_FLASH_FWD_PER_STEP = 2 * BERT_LAYERS
BERT_FLASH_BWD_PER_STEP = BERT_LAYERS
BERT_ADAM_TENSORS = 159
# DeepFM (fluid_benchmark.py's deepfm on an accelerator: 26 fields, a
# 100,000-id hashed vocabulary, k = 16, the (64, 32) deep tower, SGD,
# batch 32): no kernel of the port on its path (the sparse SGD is
# index_add_, as the reference's .at[].add); the looked-up rows against
# the dense update within 1e-6 of the table's largest magnitude (the
# duplicate ids' updates add in another order), the graphed window
# against the per-step path within 1e-5 relative (index_add_ adds
# repeated rows with atomics in no fixed order)
DEEPFM_FIELDS, DEEPFM_VOCAB, DEEPFM_DIM, DEEPFM_BATCH = 26, 100000, 16, 32
DEEPFM_LR, DEEPFM_STEPS = 1e-3, 5
DEEPFM_DENSE_RTOL, DEEPFM_WINDOW_RTOL = 1e-6, 1e-5
# fluid_benchmark.py's se_resnext and vgg and benchmark/fluid/mnist.py's
# CNN at fluid_benchmark.py's default batch and learning rate: the momentum
# tensors of SE-ResNeXt-50 (53 conv filters, 53 BN
# scales and 53 biases, the 16 SE gates' two fc weights and biases, the
# classifier's weight and bias: 225), the Adam tensors of VGG-16 (60) and
# of the MNIST CNN (6)
VISION_BATCH, VISION_STEPS, VISION_LR = 32, 3, 1e-3
SE_MOMENTUM_TENSORS, VGG_ADAM_TENSORS, CNN_ADAM_TENSORS = 225, 60, 6


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
    # per kernel: its (mangled) entry name, registers and spills
    ptxas = {n: [ln.strip().replace("ptxas info    : ", "")
                 for ln in _build.build_logs.get(n, "").splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
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
    check_paged_invariance(pa, q, ck, cv, pt, bias, lens, out)
    if not torch.equal(pa.paged_attention(q, ck, cv, pt.int(), bias, 1.0),
                       out):
        raise AssertionError("paged_attention: an int32 page table gives "
                             "other bits than the int64 one")
    geometry = pa.split_geometry(q.shape[0], q.shape[2], pt.shape[1],
                                 ck.shape[1])
    ell = pt.shape[1] * ck.shape[1]
    dead = bias.reshape(q.shape[0], -1, pa.CHUNK).isinf().all(-1)

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
    times = paged_times([lambda k=k, v=v: pa.paged_attention(
        q, k, v, pt, bias, 1.0) for k, v in sets])
    cuda_launches = times.pop("device_launches_captured") / n_sets
    if cuda_launches != pa.CUDA_LAUNCHES:
        raise AssertionError(f"a paged_attention call made {cuda_launches} "
                             f"CUDA launches; expected {pa.CUDA_LAUNCHES}")
    plain_ms = cuda_time_ms(rotating(pa.paged_attention_ref), 100)
    library_ms = cuda_time_ms(library, 300)
    bound_ms, bound_by = paged_bound_ms(q, ck, pt.cpu(), bias, lens.cpu())
    emit("kernel", name="paged_attention", shape={
        "slots": q.shape[0], "d": q.shape[2], "page_size": ck.shape[1],
        "pages_per_slot": pt.shape[1], "pool_pages": ck.shape[0]},
        live_lengths=[int(x) for x in lens.cpu()], max_abs_err=max_abs,
        max_rel_err=max_rel, atol=ATOL, rtol=RTOL, bitwise_repeat=True,
        alone_equals_batched=True, cut_table_equals_full=True,
        int32_table_equals_int64=True,
        chunk_keys=pa.CHUNK, score_grid=geometry["score_grid"],
        pv_grid=geometry["pv_grid"], chunks=int(dead.numel()),
        dead_chunks=int(dead.sum()), cuda_launches_per_call=cuda_launches,
        row_positions=ell,
        library_max_abs_err=float((lib_out - ref).abs().max()),
        **times, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_paged.py:40",
            "max_abs_err": max_abs, "ms": times["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def paged_times(calls):
    """Times of one paged-attention call, each of ``calls`` reading its own
    cache pool (as a decode tick's layers do): ``ms``, the device time a
    call takes when the calls are captured as one CUDA graph and replayed
    (no host work between launches, as a tick captured whole would run);
    ``device_ms``, its kernels' device spans under the profiler (without
    the gap between them); ``eager_ms``, back-to-back eager calls between
    CUDA events (the host's issue time where that is longer); ``host_ms``,
    the host time to issue one call (the card idle before it; median of
    20); ``device_launches_captured``, the kernels the profiled calls
    launched."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    out = {"ms": cuda_time_ms(graph.replay, 50) / len(calls)}
    it = [0]

    def rotating():
        calls[it[0] % len(calls)]()
        it[0] += 1

    out["eager_ms"] = cuda_time_ms(rotating, 300)
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rotating()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["host_ms"] = statistics.median(host)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_trace()
        for fn in calls:
            fn()
        pad_trace()
    spans = [b - a for a, b, name in device_spans(prof) if "paged_" in name]
    out["device_ms"] = sum(spans) / len(calls) / 1e3
    out["device_launches_captured"] = len(spans)
    return out


def check_paged_invariance(pa, q, ck, cv, pt, bias, lens, out):
    """Each slot's output computed alone (its q row, table row and bias
    row), and computed with its page table cut to the pages it uses (the
    bias cut to match), is bitwise equal to its row of ``out``, the batch
    of all slots at the full table."""
    import torch

    ps = ck.shape[1]
    for s in range(q.shape[0]):
        alone = pa.paged_attention(q[s:s + 1], ck, cv, pt[s:s + 1],
                                   bias[s:s + 1], 1.0)
        used = (int(lens[s]) + ps - 1) // ps
        cut = pa.paged_attention(q[s:s + 1], ck, cv,
                                 pt[s:s + 1, :used].contiguous(),
                                 bias[s:s + 1, :, :used * ps].contiguous(),
                                 1.0)
        torch.cuda.synchronize()
        if not torch.equal(alone, out[s:s + 1]):
            raise AssertionError(f"paged_attention: slot {s} alone differs "
                                 f"from its row of the batch")
        if not torch.equal(cut, out[s:s + 1]):
            raise AssertionError(
                f"paged_attention: slot {s} with its page table cut to "
                f"{used} pages differs from the full table's output")


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


def spec_tail_jobs(rng, vocab):
    """Two requests that run into max_len, admitted together: prompts of
    125 and 116 tokens (the 128 bucket), nine positions apart.  The first
    comes too close to max_len to score SPEC_K + 1 positions (past
    MAX_LEN - 1 - SPEC_K = 507) while the second still speculates, both
    at one token a tick and at SPEC_K + 1 (124 + 5 x 77 = 509, 115 + 5 x
    77 = 500): the spec ticks then carry a tail step."""
    return [(rng.integers(2, vocab, n).tolist(), MAX_LEN - n)
            for n in (125, 116)]


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
                      "kernel", "gpu_memcpy", "gpu_memset")
                  and "spin_kernel" not in e["name"])


PAD_SPINS = 8


def pad_trace():
    """Spin kernels and a sync around the profiled work, inside the
    profiler: it may miss a few device events at either end of a trace
    (up to 4 of 161 per-parameter launches, or a group call's one
    launch), and these stand there instead of the work's.
    ``device_spans`` leaves them out."""
    import torch

    torch.cuda.synchronize()
    for _ in range(PAD_SPINS):
        torch.cuda._sleep(100_000)
    torch.cuda.synchronize()


def optimizer_kernels(spans):
    """Launches and device ms of the port's optimizer kernels (Adam and
    momentum, per parameter or per group) among a trace's device spans."""
    spans = [(a, b) for a, b, name in spans
             if "adam_" in name or "momentum_" in name]
    return {"launches": len(spans),
            "device_ms": sum(b - a for a, b in spans) / 1e3}


# kernel-name fragments of the products' kernels: cuBLAS / CUTLASS GEMMs
# (``gemm``, ``nvjet``, ``xmma``) and cuDNN convolutions (``conv``,
# ``fprop``, ``dgrad``, ``wgrad``, ``implicit``)
GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")
CONV_KEYS = ("conv", "fprop", "dgrad", "wgrad", "implicit")


def kernel_family(spans, keys, busy_s):
    """Device ms and share of the busy time of the kernels whose name holds
    one of ``keys`` (lower case), and the ten largest by name."""
    by_name = {}
    for a, b, name in spans:
        if any(k in name.lower() for k in keys):
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + (b - a))
    total = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ms": total / 1e3, "share_of_busy": total / 1e6 / busy_s,
            "kernels": [{"name": k[:110], "count": n, "ms": us / 1e3}
                        for k, (n, us) in top]}


def host_profile(run, top=15):
    """The Python functions that take the most host time in ``run()`` (one
    training step, synchronized at its end) under ``cProfile``: calls and
    own (tottime) and cumulative ms.  cProfile slows every Python call, so
    the shares, not the times, carry over to a run without it."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"total_ms": total * 1e3, "functions": [
        {"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", "calls": v[1],
         "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3} for k, v in rows]}


def trace_summary(spans):
    """Device busy time, event count and the kernels that take the most
    device time, from a trace's device spans."""
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


def profile_step(phase, run, families):
    """One more step ``run()`` under ``torch.profiler``: the device's busy
    share of the wall time, the optimizer kernels, the kernel families
    ``families`` (name -> name fragments) and the kernels that take the
    most device time; then the host's Python profile of another step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_trace()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad_trace()
    spans = device_spans(prof)
    busy_s, n_events, top = trace_summary(spans)
    emit(f"{phase}_profile", wall_s=wall, device_busy_s=busy_s,
         device_busy_share=busy_s / wall, device_events=n_events,
         optimizer_kernels=optimizer_kernels(spans),
         **{f"{name}_kernels": kernel_family(spans, keys, busy_s)
            for name, keys in families.items()},
         top_kernels=top, host=host_profile(run))


def phase_profile(eng, jobs):
    """Where a decode tick's time goes: serve ``jobs`` (all slots busy)
    under ``torch.profiler`` — device busy share of the wall time, and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ticks0 = eng.metrics.counter("decode_ticks")
    dispatches0 = eng.metrics.counter("dispatches")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_trace()
        t0 = time.perf_counter()
        for f in [eng.submit(p, n) for p, n in jobs]:
            f.result(timeout=600)
        eng.wait_idle(timeout_s=60)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad_trace()
    ticks = eng.metrics.counter("decode_ticks") - ticks0
    dispatches = eng.metrics.counter("dispatches") - dispatches0
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaGraphLaunch", "cudaLaunchKernel",
                          "cuLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernelEx")}
    launched = sum(v for k, v in calls.items() if k != "cudaGraphLaunch")
    spans = device_spans(prof)
    busy_s, n_events, top = trace_summary(spans)
    paged = [b - a for a, b, name in spans if "paged_" in name]
    emit("profile", requests=len(jobs), decode_ticks=ticks, wall_s=wall,
         dispatches=dispatches,
         graph_launches_per_dispatch=calls.get("cudaGraphLaunch", 0)
         / dispatches,
         # pad_trace's spin kernels left out
         host_kernel_launches_per_tick=(launched - 2 * PAD_SPINS) / ticks,
         device_busy_s=busy_s, device_busy_share=busy_s / wall,
         device_events=n_events, ms_per_tick=wall / ticks * 1e3,
         device_ms_per_tick=busy_s * 1e3 / ticks,
         paged_kernels_per_tick=len(paged) / ticks,
         paged_device_ms_per_tick=sum(paged) / 1e3 / ticks, top_kernels=top)


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
        executables = eng.warmup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check_closed_set(eng, 1 + len(BUCKETS))
        pages_free0 = eng.metrics.gauge("kvpool_pages_free")
        jobs = smoke_jobs(np.random.default_rng(0), model.vocab_size)
        before = graph_counts(eng)

        pa.launches = 0
        t0 = time.perf_counter()
        futs = [eng.submit(p, n) for p, n in jobs]
        outs = [f.result(timeout=600) for f in futs]
        if not eng.wait_idle(timeout_s=60):
            raise AssertionError("engine did not go idle")
        wall = time.perf_counter() - t0
        launches = pa.launches

        snap = eng.metrics.snapshot()
        graphed = check_graphed(eng, before)
        ticks = graphed["decode_ticks"]
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
        tail_jobs = spec_tail_jobs(np.random.default_rng(1),
                                   model.vocab_size)
        tail_outs = [eng.decode_static([j])[0][0] for j in tail_jobs]
        if [len(o) for o in tail_outs] != [n for _, n in tail_jobs]:
            raise AssertionError("a max_len request ended before max_len")
        if eng.metrics.gauge("kvpool_pages_free") != pages_free0:
            raise AssertionError("decode_static leaked pages")
        ticks_ms = tick_times(eng)
        if profile_run:
            phase_profile(eng, [(p, 64) for p, _ in jobs[2:2 + SLOTS]])
        emit("serving", requests=len(jobs),
             paged_attention_launches=launches, executables=executables,
             **graphed,
             graph_pool_bytes=eng.graph_pool_bytes(), **ticks_ms,
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
    return {"launches": launches, "model": model, "jobs": jobs,
            "outs": outs, "tail_jobs": tail_jobs, "tail_outs": tail_outs,
            "tokens_per_s": tokens / wall}


def graph_counts(eng):
    """The engine's counters and its graphs' replays and eager runs."""
    runners = list(eng._runners.values())
    out = {name: eng.metrics.counter(name) for name in (
        "decode_ticks", "dispatches", "bucket_compiles", "spec_ticks",
        "spec_draft_tokens", "spec_accepted_tokens", "spec_fallbacks",
        "tokens_generated")}
    out["replays"] = sum(r.graph.replays for r in runners)
    out["eager_runs"] = sum(r.graph.eager_steps for r in runners)
    out["executables"] = eng.executables()
    return out


def check_closed_set(eng, want):
    """After ``warmup()``: ``want`` graphs, each captured once."""
    if eng.executables() != want:
        raise AssertionError(f"{eng.executables()} graph runners after "
                             f"warmup; expected {want}")
    if eng.metrics.counter("bucket_compiles") != want or not all(
            r.graph.graph is not None for r in eng._runners.values()):
        raise AssertionError("warmup did not capture every program")


def check_graphed(eng, before):
    """Since ``before`` (a ``graph_counts``): no capture and no new graph,
    no eager run, one graph replay a dispatch.  Returns the counters'
    changes."""
    after = graph_counts(eng)
    d = {k: after[k] - before[k] for k in after}
    if d["bucket_compiles"] or d["executables"] or d["eager_runs"]:
        raise AssertionError(f"the closed graph set moved under traffic: {d}")
    if d["replays"] != d["dispatches"] or d["dispatches"] <= 0:
        raise AssertionError(f"{d['dispatches']} dispatches made "
                             f"{d['replays']} graph replays")
    return {"decode_ticks": d["decode_ticks"], "dispatches": d["dispatches"],
            "graph_launches_per_dispatch": d["replays"] / d["dispatches"],
            "bucket_compiles_after_warmup": d["bucket_compiles"],
            **{k: d[k] for k in ("spec_ticks", "spec_draft_tokens",
                                 "spec_accepted_tokens", "spec_fallbacks",
                                 "tokens_generated")}}


def tick_times(eng, rounds=20):
    """Host-clocked ms of one all-idle decode tick (feeds built, dispatched,
    fetches on the host), medians over ``rounds`` turns of graphed (the
    engine's dispatch: one replay), eager, eager, graphed.  Eager is
    ``Executor.run`` of the same step program over the engine's own scope
    (it writes the trash page only)."""
    import statistics

    import torch

    from paddle_tpu_torch import fluid

    exe = fluid.Executor()
    model = eng.model
    idle = [None] * model.max_slots

    def graphed():
        eng._step_dispatch(idle, count_tick=False)

    def eager():
        feeds, _ = eng._tick_feeds(idle)
        exe.run(model.step_program, feed=feeds,
                fetch_list=[model.step_fetch, model.logits_fetch],
                scope=eng.scope)

    times = {graphed: [], eager: []}
    with eng._dispatch_lock:
        eager()
        for _ in range(rounds):
            for fn in (graphed, eager, eager, graphed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[fn].append((time.perf_counter() - t0) * 1e3)
    return {"idle_tick_graphed_ms": statistics.median(times[graphed]),
            "idle_tick_eager_ms": statistics.median(times[eager])}


def drive_spec(eng, jobs, want, what):
    """Serve ``jobs`` on a warmed spec engine: every stream bitwise
    ``want`` (the plain engine's), paged attention launched n_layer x
    (plain ticks + tail ticks + (k + 1) x verify ticks) times, one graph
    replay a dispatch and no capture, no page leaked.  Returns the run's
    numbers."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    spec, pool = eng._spec, eng._pool
    free0, tail0, tok0 = pool.pages_free, spec.tail_ticks, spec.tokens
    draft0, verify0 = spec.draft_s, spec.verify_s
    before = graph_counts(eng)
    pa.launches = 0
    t0 = time.perf_counter()
    with eng._dispatch_lock:  # the first admission pass takes them all
        futs = [eng.submit(p, n) for p, n in jobs]
    outs = [f.result(timeout=600) for f in futs]
    if not eng.wait_idle(timeout_s=60):
        raise AssertionError(f"{what}: engine did not go idle")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    d = check_graphed(eng, before)
    verify = d["spec_ticks"]
    plain = d["decode_ticks"] - verify
    tail = spec.tail_ticks - tail0
    expect = eng.model.cfg.n_layer * (plain + tail + (spec.k + 1) * verify)
    if launches != expect or not verify:
        raise AssertionError(
            f"{what}: paged_attention launched {launches} times over "
            f"{plain} plain, {tail} tail and {verify} verify ticks; "
            f"expected {expect}")
    bad = [j for j, (g, w) in enumerate(zip(outs, want)) if g != w]
    if bad:
        raise AssertionError(f"{what}: streams {bad} differ from the plain "
                             f"engine's")
    if pool.pages_free != free0 or pool.pages_leaked:
        raise AssertionError(f"{what}: pages leaked ({free0} free before, "
                             f"{pool.pages_free} after, "
                             f"{pool.pages_leaked} leaked)")
    tokens = sum(len(o) for o in outs)
    return {"streams_equal_plain": True, "paged_attention_launches": launches,
            "plain_ticks": plain, "tail_ticks": tail, "verify_ticks": verify,
            **d, "acceptance": d["spec_accepted_tokens"]
            / max(1, d["spec_draft_tokens"]),
            "tokens_per_spec_tick": (spec.tokens - tok0) / verify,
            "draft_ms_per_spec_tick": (spec.draft_s - draft0) / verify * 1e3,
            "verify_ms_per_spec_tick": (spec.verify_s - verify0) / verify
            * 1e3, "wall_s": wall, "tokens_per_s": tokens / wall}


def phase_serving_spec(serving):
    """The serving phase's model and requests through speculative engines
    (k = SPEC_K) with a 1-layer and a full-depth self-draft, then the two
    requests that run into max_len, then (1-layer) the requests again
    under the draft-poison drill.  Returns the paged attention launches of
    these runs."""
    import torch

    from paddle_tpu_torch.fluid import fault
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    model, jobs, want = serving["model"], serving["jobs"], serving["outs"]
    tail_jobs, tail_want = serving["tail_jobs"], serving["tail_outs"]
    launches = tail_ticks = 0
    for draft_layers in SPEC_DRAFT_LAYERS:
        t0 = time.perf_counter()
        eng = DecodeEngine(model, DecodeConfig(
            spec=SPEC_K, spec_draft_layers=draft_layers))
        try:
            executables = eng.warmup()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            check_closed_set(eng, 2 * (1 + len(BUCKETS)) + 1)
            run = drive_spec(eng, jobs, want, f"draft {draft_layers}")
            snap = eng.metrics.snapshot()
            tail = drive_spec(eng, tail_jobs, tail_want,
                              f"draft {draft_layers}, max_len requests")
            launches += (run["paged_attention_launches"]
                         + tail["paged_attention_launches"])
            tail_ticks += tail["tail_ticks"]
            for r in (run, tail):
                if draft_layers == 0 and r["acceptance"] != 1.0:
                    raise AssertionError(f"the full-depth draft accepted "
                                         f"{r['acceptance']} of its tokens")
            static = [eng.decode_static([j])[0][0]
                      for j in jobs + tail_jobs]
            if static != want + tail_want:
                raise AssertionError("the spec engine's decode_static "
                                     "differs from the plain engine's")
            drill = None
            if draft_layers:
                fault.install(fault.FaultPlan(spec_draft_poison=0))
                try:
                    drill = drive_spec(eng, jobs, want, "poison drill")
                finally:
                    fault.clear()
                launches += drill["paged_attention_launches"]
                if drill["spec_fallbacks"] < 1:
                    raise AssertionError("the poisoned draft did not trip "
                                         "the spec controller")
            emit("serving_spec", k=SPEC_K,
                 draft_layers=eng._spec.draft.depth,
                 executables=executables, setup_s=setup_s, **run,
                 ttft_p50_ms=snap["ttft_p50_ms"],
                 plain_engine_tokens_per_s=serving["tokens_per_s"],
                 static_equals_plain=True,
                 graph_pool_bytes=eng.graph_pool_bytes(),
                 max_len_requests={k: tail[k] for k in (
                     "plain_ticks", "tail_ticks", "verify_ticks",
                     "paged_attention_launches", "acceptance",
                     "tokens_per_spec_tick", "tokens_per_s")},
                 poison_drill=drill)
        finally:
            eng.shutdown()
    if not tail_ticks:
        raise AssertionError("no spec tick carried a tail step: the max_len "
                             "requests never reached max_len - k beside a "
                             "speculating one")
    return launches


def xent_bound_ms(r, v, soft, backward, x_bytes=4, y_bytes=4):
    """Each input read once, each output written once: logits (``x_bytes``
    a value), soft labels (``y_bytes``) or one int64 label a row, and per
    row fp32 loss, lse (and sum y) forward; lse, g1, g2 in and dx (in the
    logits' dtype) out backward.  Operations a logit: max, subtract, exp,
    add (+ multiply and two adds for soft labels) forward; subtract, exp,
    two multiplies and a subtract backward."""
    elems = r * v
    nbytes = elems * x_bytes + (elems * y_bytes if soft else r * 8)
    if backward:
        nbytes += elems * x_bytes + 3 * r * 4
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


def _ulp(got, want):
    """Per element, the ulp of two low-precision tensors' dtype at the
    larger magnitude of the pair (subnormals: the smallest normal's ulp)."""
    import torch

    mant = {torch.bfloat16: 7, torch.float16: 10}[got.dtype]
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(
        torch.finfo(got.dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def ulp_err(got, want):
    """The largest |got - want| of two low-precision tensors in ulps of
    their dtype (``_ulp``)."""
    return float(((got.float() - want.float()).abs() / _ulp(got, want))
                 .max())


def low_excess(got, want, tol=FLASH_LOW_TOL):
    """max over elements of |got - want| - (ulps · ulp + floor · max|want|)
    of two bf16 / fp16 tensors: <= 0 within ``tol``."""
    diff = (got.float() - want.float()).abs()
    allowed = (tol["ulps"] * _ulp(got, want)
               + tol["floor"] * float(want.float().abs().max()))
    return float((diff - allowed).max())


def phase_kernel_xent_amp():
    """The xent kernels with bf16 and fp16 logits (AMP keep_activations:
    the Transformer's logits stay in the compute dtype) at the training
    path's shape, soft labels in fp32 (one_hot + label_smooth, as the
    program builds them) and hard labels with ignore_index rows, against
    their plain versions on the same low-precision inputs: loss and lse
    within the fp32 tolerance (only the order of sums differs), dx within
    ``XENT_DX_ULPS`` ulp of its dtype (both round one fp32 value to it),
    two launches bitwise equal; kernel, plain, ``F.cross_entropy`` (on the
    same low logits) and bound times.  Returns the kernels-line entries,
    one a dtype and direction."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    r, v = TRAIN_BATCH * TRAIN_LEN, VOCAB
    ids = torch.randint(1, v, (r,), generator=gen, device=device)
    soft_y = torch.zeros(r, v, device=device).scatter_(
        1, ids[:, None], 1.0) * 0.9 + 0.1 / v
    hard_y = ids.clone()
    hard_y[::7] = XENT_IGNORE
    entries, report = [], {}
    src = "paddle_tpu_torch/csrc/softmax_xent.cu"
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        x = (torch.randn(r, v, generator=gen, device=device) * 2).to(dtype)
        out, errs = {}, {"fwd": 0.0, "bwd": 0.0}
        for soft, lab in ((True, soft_y), (False, hard_y)):
            kind = "soft" if soft else "hard"
            ignore = -100 if soft else XENT_IGNORE
            loss, lse, _ = fused.softmax_xent_fwd(x, lab, soft, ignore)
            loss2, lse2, _ = fused.softmax_xent_fwd(x, lab, soft, ignore)
            torch.cuda.synchronize()
            rloss, rlse, rsum = fused.softmax_xent_fwd_ref(x, lab, soft,
                                                           ignore)
            if not (torch.equal(loss, loss2) and torch.equal(lse, lse2)):
                raise AssertionError(f"xent forward ({tag}, {kind}) is not "
                                     f"bitwise repeatable")
            if loss.dtype != torch.float32 or lse.dtype != torch.float32:
                raise AssertionError(f"xent forward ({tag}) returned "
                                     f"{loss.dtype} / {lse.dtype}")
            for name, got, want in (("loss", loss, rloss), ("lse", lse, rlse)):
                if not bool((got - want).abs().le(ATOL + RTOL * want.abs())
                            .all()):
                    raise AssertionError(
                        f"xent forward ({tag}, {kind}) {name} disagrees "
                        f"with the plain version: max abs/rel err "
                        f"{_max_errs(got, want)}")
            if not soft and not bool((loss[hard_y == XENT_IGNORE] == 0)
                                     .all()):
                raise AssertionError("ignored rows have a nonzero loss")
            g1, g2 = fused.xent_bwd_coeffs(lab, rsum, torch.ones_like(rlse),
                                           None, soft, ignore)
            dx = fused.softmax_xent_bwd(x, lab, rlse, g1, g2, soft)
            dx2 = fused.softmax_xent_bwd(x, lab, rlse, g1, g2, soft)
            torch.cuda.synchronize()
            rdx = fused.softmax_xent_bwd_ref(x, lab, rlse, g1, g2, soft)
            if dx.dtype != dtype or not torch.equal(dx, dx2):
                raise AssertionError(f"xent backward ({tag}, {kind}): dtype "
                                     f"{dx.dtype}, or not bitwise "
                                     f"repeatable")
            dx_ulps = ulp_err(dx, rdx)
            if not dx_ulps <= XENT_DX_ULPS:
                raise AssertionError(
                    f"xent backward ({tag}, {kind}) disagrees with the "
                    f"plain version by {dx_ulps} ulp of {dtype}")
            out[kind] = {"loss_err": _max_errs(loss, rloss),
                         "lse_err": _max_errs(lse, rlse),
                         "dx_max_ulps": dx_ulps,
                         "dx_max_abs_err": float((dx.float() - rdx.float())
                                                 .abs().max())}
            errs["fwd"] = max(errs["fwd"], out[kind]["loss_err"][0],
                              out[kind]["lse_err"][0])
            errs["bwd"] = max(errs["bwd"], out[kind]["dx_max_abs_err"])
            del dx, dx2, rdx, rloss, rlse
        times = {}
        for soft, lab in ((True, soft_y), (False, hard_y)):
            kind = "soft" if soft else "hard"
            ignore = -100 if soft else XENT_IGNORE
            _, lse, sum_y = fused.softmax_xent_fwd(x, lab, soft, ignore)
            g1, g2 = fused.xent_bwd_coeffs(lab, sum_y, torch.ones_like(lse),
                                           None, soft, ignore)
            # the library call on the same low logits (a soft target in
            # their dtype: F.cross_entropy takes no other)
            target = lab.to(dtype) if soft else lab
            lib_kw = {} if soft else {"ignore_index": XENT_IGNORE}
            times[kind] = {
                "fwd_ms": cuda_time_ms(lambda: fused.softmax_xent_fwd(
                    x, lab, soft, ignore), 20),
                "fwd_plain_ms": cuda_time_ms(
                    lambda: fused.softmax_xent_fwd_ref(x, lab, soft, ignore),
                    5),
                "fwd_library_ms": cuda_time_ms(lambda: F.cross_entropy(
                    x, target, reduction="none", **lib_kw), 20),
                "bwd_ms": cuda_time_ms(lambda: fused.softmax_xent_bwd(
                    x, lab, lse, g1, g2, soft), 20),
                "bwd_plain_ms": cuda_time_ms(
                    lambda: fused.softmax_xent_bwd_ref(x, lab, lse, g1, g2,
                                                       soft), 5)}
            for d in ("fwd", "bwd"):
                times[kind][f"{d}_bound_ms"], times[kind][f"{d}_bound_by"] = \
                    xent_bound_ms(r, v, soft, d == "bwd", x.element_size())
            del target
        report[tag] = {"checks": out, "times": times}
        soft_t = times["soft"]
        entries += [
            {"name": f"softmax_xent_fwd_{tag}", "route": "cuda",
             "source": src, "replaces": "paddle_tpu/ops/pallas_fused.py:130",
             "max_abs_err": errs["fwd"], "ms": soft_t["fwd_ms"],
             "plain_ms": soft_t["fwd_plain_ms"],
             "bound_ms": soft_t["fwd_bound_ms"],
             "bound_by": soft_t["fwd_bound_by"],
             "library_ms": soft_t["fwd_library_ms"]},
            {"name": f"softmax_xent_bwd_{tag}", "route": "cuda",
             "source": src, "replaces": "paddle_tpu/ops/pallas_fused.py:185",
             "max_abs_err": errs["bwd"], "ms": soft_t["bwd_ms"],
             "plain_ms": soft_t["bwd_plain_ms"],
             "bound_ms": soft_t["bwd_bound_ms"],
             "bound_by": soft_t["bwd_bound_by"], "library_ms": None}]
        del x
        torch.cuda.empty_cache()
    emit("kernel_xent_amp", rows=r, vocab=v, soft_label_dtype="float32",
         ignore_index=XENT_IGNORE, atol=ATOL, rtol=RTOL,
         dx_ulps=XENT_DX_ULPS, bitwise_repeat=True, **report)
    return entries


def _compare_group(what, got, want, tol):
    """Hold every tensor of ``got`` to ``want`` within ``tol`` (atol and
    rtol); returns the largest absolute and relative errors and whether
    all agree to the bit."""
    import torch

    max_abs = max_rel = 0.0
    bitwise = True
    for a, w in zip(got, want):
        if a.numel() == 0:
            continue
        if not bool((a - w).abs().le(tol + tol * w.abs()).all()):
            raise AssertionError(f"{what} disagrees with the plain version "
                                 f"at {tuple(a.shape)}: {_max_errs(a, w)}")
        e_abs, e_rel = _max_errs(a, w)
        max_abs, max_rel = max(max_abs, e_abs), max(max_rel, e_rel)
        bitwise = bitwise and torch.equal(a, w)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "bitwise_equal": bitwise}


def ragged_sizes():
    """A ragged group beside the main path's shapes: odd sizes, an empty
    and a 1-element tensor, sizes just past one and three 16 K chunks (one
    a multiple of 4, so its float4 path ends in a part chunk)."""
    return [0, 1, 3, 7, 127, 1025, 16385, 3 * 16384 + 4, 100003, 262147]


def offset_view(gen, device, n, scale=1.0):
    """``n`` values at a 4-byte offset into their storage: n % 4 == 0 but
    not 16-byte aligned, so the kernel takes its scalar path."""
    import torch

    return (torch.randn(n + 1, generator=gen, device=device) * scale)[1:]


def time_group(call, plain, library, kernel_name, launches, iters=20,
               graph_library=None):
    """The group call's and the library call's device ms from CUDA-graph
    replays (``graph_library``: the library call in a form a graph can
    capture, else ``library``); the group call's ms between CUDA events,
    its kernel's device ms under the profiler (the mean captured launch
    times ``launches()``'s count a call), the plain version's and the
    library call's ms, the host ms to issue one group call (the card idle
    before it; median of 20) and the library's device ms under the
    profiler (its captured kernels over the calls); with the launches each
    trace captured."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"ms": cuda_time_ms(call, iters),
           "plain_ms": cuda_time_ms(plain, 3),
           "library_ms": cuda_time_ms(library, iters)}
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["host_ms"] = statistics.median(host)
    calls = 5
    for key, fn in (("kernel", call), ("library", library)):
        before = launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace()
            for _ in range(calls):
                fn()
            pad_trace()
        spans = [b - a for a, b, name in device_spans(prof)
                 if key == "library" or kernel_name in name]
        out[f"{key}_device_launches_captured"] = len(spans)
        if key == "kernel":
            out["launches_per_call"] = (launches() - before) / calls
            out["kernel_device_ms"] = (sum(spans) / len(spans) / 1e3
                                       * out["launches_per_call"]
                                       if spans else None)
        else:
            out["library_device_ms"] = sum(spans) / calls / 1e3
    out["graph_ms"] = graph_time_ms(call)
    out["library_graph_ms"] = graph_time_ms(graph_library or library)
    return out


def phase_kernel_adam(shapes, phase="kernel_adam"):
    """The Adam group kernel over one tensor set per parameter shape of a
    model's path (one shared learning rate, as the path has it) and over
    a ragged set (own learning rates, a view off 16-byte alignment), each
    entry with beta pows of its own step count: one call against the plain
    version, then the call's kernel, device, plain, library, host and
    bound times."""
    import torch

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(2)
    b1, b2, eps = 0.9, 0.98, 1e-9
    steps = torch.randint(1, 60, (len(shapes) + len(ragged_sizes()) + 1,),
                          generator=gen, device=device).tolist()

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def group(shape_list, lrs):
        ps = [rnd(s) for s in shape_list]
        gs = [rnd(s, 1e-2) for s in shape_list]
        m1s = [rnd(s, 1e-3) for s in shape_list]
        m2s = [rnd(s, 1e-4).abs() for s in shape_list]
        t = [steps.pop() for _ in shape_list]
        b1ps = [torch.full((1,), b1 ** k, device=device) for k in t]
        b2ps = [torch.full((1,), b2 ** k, device=device) for k in t]
        return [ps, gs, m1s, m2s, lrs, b1ps, b2ps]

    lr = torch.full((1,), 1e-3, device=device)
    main = group(shapes, [lr] * len(shapes))
    sizes = ragged_sizes()
    ragged = group([(n,) for n in sizes],
                   [torch.full((1,), 1e-3 * (1 + k), device=device)
                    for k in range(len(sizes))])
    for col, scale in ((0, 1.0), (1, 1e-2), (2, 1e-3)):
        ragged[col].append(offset_view(gen, device, 4096, scale))
    ragged[3].append(rnd(4096, 1e-4).abs())
    ragged[4].append(torch.full((1,), 2e-3, device=device))
    t = steps.pop()
    ragged[5].append(torch.full((1,), b1 ** t, device=device))
    ragged[6].append(torch.full((1,), b2 ** t, device=device))
    report = {}
    for name, cols in (("main", main), ("ragged", ragged)):
        want = fused.adam_group_ref(*cols, b1, b2, eps)
        got = [[t.clone() for t in col] for col in cols]
        before = (fused.adam_launches, fused.adam_tensors)
        fused.adam_group(*got, b1, b2, eps)
        torch.cuda.synchronize()
        launches = fused.adam_launches - before[0]
        if (launches, fused.adam_tensors - before[1]) != (1, len(cols[0])):
            raise AssertionError(f"the {name} Adam group launched {launches} "
                                 f"times for {len(cols[0])} tensors")
        report[name] = _compare_group(
            f"the adam kernel ({name} set)",
            [t for k in (0, 2, 3, 5, 6) for t in got[k]],
            [w[i] for i in range(5) for w in want], ADAM_TOL)
    n = sum(p.numel() for p in main[0])
    params = [torch.nn.Parameter(p.detach().clone()) for p in main[0]]
    for p, g in zip(params, main[1]):
        p.grad = g
    opt = torch.optim.Adam(params, lr=1e-3, betas=(b1, b2), eps=eps,
                           fused=True)
    # a graph captures Adam's step count only on the device
    cap_params = [torch.nn.Parameter(p.detach().clone()) for p in main[0]]
    for p, g in zip(cap_params, main[1]):
        p.grad = g
    cap = torch.optim.Adam(cap_params, lr=1e-3, betas=(b1, b2), eps=eps,
                           fused=True, capturable=True)
    times = time_group(lambda: fused.adam_group(*main, b1, b2, eps),
                       lambda: fused.adam_group_ref(*main, b1, b2, eps),
                       opt.step, "adam_group", lambda: fused.adam_launches,
                       graph_library=cap.step)
    # p, g, m1, m2 read and p, m1, m2 written; the shared lr read and each
    # entry's two beta pows read and written once
    n_t = len(main[0])
    bound, bound_by = bound_ms(28 * n + 4 + 16 * n_t, 12 * n + 7 * n_t)
    emit(phase, tensors=n_t, values=n, ragged_tensors=len(ragged[0]),
         ragged_sizes=[p.numel() for p in ragged[0]], atol=ADAM_TOL,
         rtol=ADAM_TOL, **report, **times, bound_ms=bound, bound_by=bound_by,
         library="torch.optim.Adam(fused=True)",
         smallest=min(p.numel() for p in params),
         largest=max(p.numel() for p in params))
    return {"name": "adam", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/adam.cu",
            "replaces": "paddle_tpu/ops/pallas_fused.py:496",
            "max_abs_err": max(r["max_abs_err"] for r in report.values()),
            "ms": times["graph_ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": times["library_graph_ms"]}


def trainable_shapes(main, want):
    """The shapes of ``main``'s trainable parameters: one optimizer tensor
    each; raises unless there are ``want``."""
    shapes = [tuple(p.shape) for p in main.global_block().all_parameters()
              if p.trainable]
    if len(shapes) != want:
        raise AssertionError(f"{len(shapes)} trainable parameters, the path "
                             f"updates {want}")
    return shapes


def optimizer_at_model_shapes(kernel_phase, kernel, models):
    """``kernel_phase`` (:func:`phase_kernel_adam` or
    :func:`phase_kernel_momentum`) at each of ``models``' parameter shapes
    ``(name, main program, tensors its path updates)``, a line each
    (``kernel_<kernel>_<name>``): the kernels-line numbers by model."""
    import torch

    out = {}
    for name, main, want in models:
        entry = kernel_phase(trainable_shapes(main, want),
                             f"kernel_{kernel}_{name}")
        out[name] = {"tensors": want, **{
            k: entry[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}
        torch.cuda.empty_cache()
    return out


def flash_case_inputs(gen, device, t_q, t_k, padded, b=TRAIN_BATCH,
                      h=FLASH_HEADS, d=FLASH_D):
    """q, k, v, dO ``[B, H, T, D]`` (the training path's 64, 8, T, 64 by
    default) and, if ``padded``, the model's key-padding bias ``[B, 1, 1,
    Tk]``: -1e9 past a ragged length per batch row (the first row
    unpadded, the others Tk/2..Tk keys).  Returns the tensors and the key
    lengths."""
    import torch

    def rnd(t):
        return torch.randn(b, h, t, d, generator=gen, device=device)

    q, k, v, do = rnd(t_q), rnd(t_k), rnd(t_k), rnd(t_q)
    lens = torch.full((b,), t_k, dtype=torch.int64, device=device)
    bias = None
    if padded:
        lens = torch.randint(t_k // 2, t_k + 1, (b,), generator=gen,
                             device=device)
        lens[0] = t_k
        keys = torch.arange(t_k, device=device)[None, :]
        bias = torch.where(keys < lens[:, None], 0.0, -1e9).to(
            torch.float32).reshape(b, 1, 1, t_k)
    return q, k, v, do, bias, lens


def flash_live_pairs(t_q, lens, causal):
    """(query, key) pairs of one head whose weight can be nonzero: keys
    before each batch row's length, and at or before the query if causal."""
    total = 0
    for n in lens.tolist():
        if causal:
            total += sum(min(i + 1, n) for i in range(t_q))
        else:
            total += t_q * n
    return total


def flash_bound_ms(t_q, t_k, lens, causal, kind, elem=4, b=TRAIN_BATCH,
                   h=FLASH_HEADS, d=FLASH_D):
    """The least time of one flash kernel call: each input read once and
    each output written once over the memory rate, or the operations over
    their rate, whichever is larger; on the better of two routes.  ``elem``
    is the bytes of a q, k, v, dO, out, dq, dk or dv value (4 in fp32, 2 in
    bf16 / fp16; lse, delta and the bias are fp32).  The products are 2
    flops a multiply-add, D of them per product per live pair (2 products
    forward, 3 in dQ, 4 in dK/dV), plus 4 flops of softmax arithmetic a
    live pair on the CUDA cores: on the CUDA cores all at the fp32 rate; on
    the tensor cores, in fp32 the products three times over (3xTF32) at the
    TF32 rate, in bf16 / fp16 each of the reference's products once at the
    bf16 rate (the kernels' split of P and dS is their own cost).  Returns
    ``{"bound_ms", "bound_by", "fp32_core_bound_ms",
    "tensor_core_bound_ms"}``; ``b``, ``h``, ``d`` are the batch, heads and
    head width (the training path's by default)."""
    pairs = h * flash_live_pairs(t_q, lens, causal)
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    product_flops, softmax_flops = pairs * 2 * products * d, pairs * 4
    q_bytes, kv_bytes, rows = b * h * t_q * d * elem, \
        b * h * t_k * d * elem, b * h * t_q * 4
    bias_bytes = b * t_k * 4
    nbytes = {"fwd": 2 * q_bytes + 2 * kv_bytes + rows + bias_bytes,
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * rows + bias_bytes,
              "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * rows + bias_bytes}[kind]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fp32 = (product_flops + softmax_flops) / PEAK_FP32_FLOPS * 1e3
    tc_flops = (3 * product_flops / PEAK_TF32_FLOPS if elem == 4
                else product_flops / PEAK_BF16_FLOPS)
    t_tc = (tc_flops + softmax_flops / PEAK_FP32_FLOPS) * 1e3
    t_ops = min(t_fp32, t_tc)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_core_bound_ms": max(t_bytes, t_fp32),
            "tensor_core_bound_ms": max(t_bytes, t_tc)}


def _check_close(what, name, got, want):
    """Max abs and rel error of a flash kernel's output against its plain
    version; raises beyond ``FLASH_TOL[name]`` or on a non-finite value."""
    atol, rtol = FLASH_TOL[name]
    if not bool(got.isfinite().all()):
        raise AssertionError(f"flash {what}: {name} is not finite")
    if not bool((got - want).abs().le(atol + rtol * want.abs()).all()):
        raise AssertionError(
            f"flash {what}: {name} disagrees with the plain version: max "
            f"abs/rel err {_max_errs(got, want)} (atol {atol}, rtol {rtol})")
    return _max_errs(got, want)


def flash_blocks_per_sm(kind, d, sfx="f32"):
    """How many blocks of the flash forward (``"fwd"``), dQ (``"dq"``) or
    dK/dV (``"dkv"``) kernel at head width ``d`` on inputs of dtype ``sfx``
    (``"f32"``, ``"bf16"``, ``"f16"``) fit one SM of the card at once, from
    their threads, registers and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` behind the kernels'
    C interface)."""
    import ctypes

    from paddle_tpu_torch.ops import flash_attention as fa

    lib = fa._lib()
    query = lib.pta_flash_blocks_per_sm
    query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
    query.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    rc = query({"fwd": 0, "dq": 1, "dkv": 2}[kind],
               {"f32": 0, "bf16": 1, "f16": 2}[sfx], d, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"flash {kind} occupancy query failed: "
                           f"{lib.pta_flash_error_string(rc).decode()} "
                           f"(error {rc})")
    return blocks.value


def _flash_entry(mangled_name, sfx):
    """``(kind, D, kernel name)`` of a flash kernel's mangled name on inputs
    of dtype ``sfx``, or None: on bf16 / fp16 the three kernels are the
    ``flash_{fwd,dq,dkv}_wgmma_kernel``s (an older source's, held against
    this one by ``tools/flash_ab.py``, may name ``flash_*_kernel``s there),
    on fp32 the ``flash_*_kernel``s."""
    import re

    # (the fp32 forward and dK/dV carry no element type)
    mangled = {"f32": "f?", "bf16": "13__nv_bfloat16", "f16": "6__half"}[sfx]
    k = re.search(r"(flash_(fwd|dq|dkv)(?:_wgmma)?_kernel)I" + mangled
                  + r"Li(\d+)E", mangled_name)
    return (k.group(2), int(k.group(3)), k.group(1)) if k else None


def flash_registers(sfx="f32", log=None):
    """Name, registers and spill-store bytes of each flash kernel
    (``"fwd"``, ``"dq"``, ``"dkv"``) on inputs of dtype ``sfx`` at each head
    width, from ptxas's report ``log``: by default this process's build of
    the library (empty where the library was built before)."""
    import re

    from paddle_tpu_torch.ops import _build

    if log is None:
        log = _build.build_logs.get("flash_attention", "")
    found, cur = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            k = _flash_entry(entry.group(1), sfx)
            cur = found.setdefault(k[0], {}).setdefault(k[1], {
                "kernel": k[2]}) if k else None
            continue
        if cur is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    return found


def flash_hgmma(sfx):
    """The ``HGMMA`` (wgmma) instructions of each flash kernel (``"fwd"``,
    ``"dq"``, ``"dkv"``) on inputs of dtype ``sfx`` at each head width, in
    the SASS of the built library (``cuobjdump --dump-sass``)."""
    import re

    from paddle_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           _build._target("flash_attention")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found, cur = {}, None
    for ln in sass.splitlines():
        fn = re.search(r"Function : (\S+)", ln)
        if fn:
            k = _flash_entry(fn.group(1), sfx)
            cur = None
            if k:
                found.setdefault(k[0], {})[k[1]] = 0
                cur = (k[0], k[1])
        elif cur and "HGMMA" in ln:
            found[cur[0]][cur[1]] += 1
    return found


def phase_kernel_flash():
    """The flash forward, dQ and dK/dV kernels against their plain versions
    at the training path's shapes (B = 64, H = 8, D = 64, float32) in three
    cases: non-causal with a ragged padding bias, causal with none, and a
    ragged causal case with a bias (Tq = 100, Tk = 77); two launches
    bitwise equal; kernel, plain, bound and SDPA times for the first two.
    Then the ragged case at the other head widths the kernels take."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(3)
    scale = FLASH_D ** -0.5
    cases = (("padding", TRAIN_LEN, TRAIN_LEN, False, True),
             ("causal", TRAIN_LEN, TRAIN_LEN, True, False),
             ("ragged", 100, 77, True, True))
    report, worst = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, t_q, t_k, causal, padded in cases:
        q, k, v, do, bias, lens = flash_case_inputs(gen, device, t_q, t_k,
                                                    padded)
        errs, ref_max, lse, delta = _check_flash_case(
            q, k, v, do, bias, scale, causal, f"{name} case")
        worst["fwd"] = max(worst["fwd"], errs["out"][0], errs["lse"][0])
        worst["dq"] = max(worst["dq"], errs["dq"][0])
        worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        entry = {"t_q": t_q, "t_k": t_k, "causal": causal,
                 "padded_keys": int(t_k * TRAIN_BATCH - lens.sum()),
                 "max_abs_rel_err": errs, "plain_max_abs": ref_max,
                 "bitwise_repeat": True}
        if name != "ragged":
            entry.update(_time_flash(q, k, v, do, bias, lse, delta, scale,
                                     causal, lens))
        report[name] = entry
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    # the other head widths the kernels are built for, on a small ragged
    # causal case with a padding bias
    widths = {}
    for d in fa.HEAD_DIMS:
        if d != FLASH_D:
            q, k, v, do, bias, _ = flash_case_inputs(gen, device, 100, 77,
                                                     True, b=4, h=2, d=d)
            widths[d] = _check_flash_case(q, k, v, do, bias, d ** -0.5,
                                          True, f"D = {d} case")[0]
    blocks = {kind: {d: flash_blocks_per_sm(kind, d) for d in fa.HEAD_DIMS}
              for kind in ("fwd", "dq", "dkv")}
    emit("kernel_flash", batch=TRAIN_BATCH, heads=FLASH_HEADS, d=FLASH_D,
         tolerance={n: {"atol": a, "rtol": r} for n, (a, r)
                    in FLASH_TOL.items()}, **report,
         other_widths={"batch": 4, "heads": 2, "t_q": 100, "t_k": 77,
                       "max_abs_rel_err": widths},
         registers=flash_registers(), blocks_per_sm=blocks)
    # the kernels line: the padding case, as 12 of the step's 18 ops run it
    main = report["padding"]
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    rows = []
    for kind, line in (("fwd", 280), ("dq", 328), ("dkv", 349)):
        rows.append({"name": f"flash_{kind}", "route": "cuda", "source": src,
                     "replaces": f"paddle_tpu/ops/pallas_flash.py:{line}",
                     "max_abs_err": worst[kind], "ms": main[f"{kind}_ms"],
                     "plain_ms": main[f"{kind}_plain_ms"],
                     "bound_ms": main[f"{kind}_bound_ms"],
                     "bound_by": main[f"{kind}_bound_by"],
                     "library_ms": main["fwd_library_ms"] if kind == "fwd"
                     else None})
    return rows


def _check_low(what, name, got, want):
    """Max abs error and max ulps of a bf16 / fp16 flash output against its
    plain version; raises beyond ``FLASH_LOW_TOL`` or on a non-finite
    value."""
    if got.dtype != want.dtype:
        raise AssertionError(f"flash {what}: {name} is {got.dtype}, the "
                             f"plain version's {want.dtype}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"flash {what}: {name} is not finite")
    err = ((got.float() - want.float()).abs().max().item(),
           ulp_err(got, want))
    if low_excess(got, want) > 0:
        raise AssertionError(
            f"flash {what}: {name} disagrees with the plain version: max "
            f"abs err / ulps {err} (tolerance {FLASH_LOW_TOL})")
    return err


def _check_flash_case(q, k, v, do, bias, scale, causal, what):
    """Launch each flash kernel twice on one case: the two launches must be
    bitwise equal and within ``FLASH_TOL`` (fp32) or ``FLASH_LOW_TOL``
    (bf16 / fp16) of the plain versions on the same inputs.  Returns the
    errors (max abs and max rel; in bf16 / fp16 max abs and max ulps but
    for lse), the plain outputs' max magnitudes, and the forward's lse and
    delta."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, bias, scale, causal)
    out2, lse2 = fa.flash_forward(q, k, v, bias, scale, causal)
    delta = fa._delta(out, do)
    dq = fa.flash_dq(q, k, v, bias, do, lse, delta, scale, causal)
    dq2 = fa.flash_dq(q, k, v, bias, do, lse, delta, scale, causal)
    dk, dv = fa.flash_dkv(q, k, v, bias, do, lse, delta, scale, causal)
    dk2, dv2 = fa.flash_dkv(q, k, v, bias, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    for a, b, n in ((out, out2, "out"), (lse, lse2, "lse"), (dq, dq2, "dq"),
                    (dk, dk2, "dk"), (dv, dv2, "dv")):
        if not torch.equal(a, b):
            raise AssertionError(f"flash {what}: two launches give "
                                 f"different {n}")
    r_out, r_lse = fa.flash_forward_ref(q, k, v, bias, scale, causal)
    r_dq = fa.flash_dq_ref(q, k, v, bias, do, lse, delta, scale, causal)
    r_dk, r_dv = fa.flash_dkv_ref(q, k, v, bias, do, lse, delta, scale,
                                  causal)
    pairs = (("out", out, r_out), ("lse", lse, r_lse), ("dq", dq, r_dq),
             ("dk", dk, r_dk), ("dv", dv, r_dv))
    low = q.dtype != torch.float32
    errs = {n: (_check_low if low and n != "lse" else _check_close)(
        what, n, g, w) for n, g, w in pairs}
    return errs, {n: float(w.abs().max()) for n, _, w in pairs}, lse, delta


def graph_time_ms(fn, calls=20):
    """Device time of one ``fn()`` call: ``calls`` calls captured as one
    CUDA graph and replayed, so that no host work sits between launches
    (a wrapper's host time can pass a short kernel's device time, and
    back-to-back eager calls then time the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_ms(graph.replay, 10) / calls


def _time_flash(q, k, v, do, bias, lse, delta, scale, causal, lens):
    """Kernel, plain, bound and library times of the three kernels on one
    case, and of a forward + backward pair under autograd; the library
    call (SDPA) on the same inputs, its mask the bias in q's dtype, and
    SDPA's backward alone beside the dQ and dK/dV kernels' sum.  A
    kernel's ``*_ms``, SDPA's ``fwd_library_ms`` and its backward's
    ``library_bwd_ms`` are device times from CUDA graph replays
    (``graph_time_ms``, ``backward_graph_time_ms``); ``*_eager_ms`` and
    ``fwd_library_eager_ms`` back-to-back eager calls between CUDA events,
    through the Python wrapper and SDPA's own call; the plain versions and
    the two pairs (each well past its host time) eager."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    t_q, t_k = q.shape[2], k.shape[2]
    times = {}
    for kind, kern, plain, iters in (
            ("fwd", lambda: fa.flash_forward(q, k, v, bias, scale, causal),
             lambda: fa.flash_forward_ref(q, k, v, bias, scale, causal), 50),
            ("dq", lambda: fa.flash_dq(q, k, v, bias, do, lse, delta, scale,
                                       causal),
             lambda: fa.flash_dq_ref(q, k, v, bias, do, lse, delta, scale,
                                     causal), 50),
            ("dkv", lambda: fa.flash_dkv(q, k, v, bias, do, lse, delta,
                                         scale, causal),
             lambda: fa.flash_dkv_ref(q, k, v, bias, do, lse, delta, scale,
                                      causal), 50)):
        times[f"{kind}_ms"] = graph_time_ms(kern)
        times[f"{kind}_eager_ms"] = cuda_time_ms(kern, iters)
        times[f"{kind}_plain_ms"] = cuda_time_ms(plain, 10)
        for key, val in flash_bound_ms(t_q, t_k, lens, causal, kind,
                                       q.element_size(), b=q.shape[0],
                                       h=q.shape[1], d=q.shape[3]).items():
            times[f"{kind}_{key}"] = val

    # the library yardstick, timed only: SDPA on the same inputs
    mask = None if bias is None else bias.to(q.dtype)

    def sdpa(a, b_, c):
        if causal:
            return F.scaled_dot_product_attention(a, b_, c, is_causal=True,
                                                  scale=scale)
        return F.scaled_dot_product_attention(a, b_, c, attn_mask=mask,
                                              scale=scale)

    times["fwd_library_ms"] = graph_time_ms(lambda: sdpa(q, k, v))
    times["fwd_library_eager_ms"] = cuda_time_ms(lambda: sdpa(q, k, v), 50)
    times["library_max_abs_err"] = float(
        (sdpa(q, k, v).float()
         - fa.flash_forward(q, k, v, bias, scale, causal)[0].float())
        .abs().max())
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def kernel_pair():
        out = fa.FlashAttention.apply(*leaves, bias, scale, causal)
        return torch.autograd.grad(out, leaves, do)

    def library_pair():
        return torch.autograd.grad(sdpa(*leaves), leaves, do)

    times["fwd_bwd_pair_ms"] = cuda_time_ms(kernel_pair, 20)
    times["library_fwd_bwd_pair_ms"] = cuda_time_ms(library_pair, 20)
    # SDPA's backward alone (dq, dk and dv in one call) beside the dQ and
    # dK/dV kernels' sum, both from graph replays: the yardstick of the two
    # backward kernels
    times["library_bwd_ms"] = backward_graph_time_ms(sdpa, leaves, do)
    times["dq_plus_dkv_ms"] = times["dq_ms"] + times["dkv_ms"]
    return times


def backward_graph_time_ms(fwd, leaves, grad_out, calls=20):
    """Device time of ``fwd(*leaves)``'s backward alone: the forward run
    once on a side stream, then ``calls`` ``torch.autograd.grad`` passes
    over its retained graph captured on that stream (autograd runs each
    backward op on its forward op's stream) as one CUDA graph, replayed as
    in ``graph_time_ms``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fwd(*leaves)
        for _ in range(2):
            torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    return cuda_time_ms(graph.replay, 10) / calls


def _check_fp16_large_ds():
    """The fp16 dQ and dK/dV kernels where dS passes fp16's range, built as
    ``tests/test_torch_flash_amp_split.py`` builds its case (numpy seed 7;
    B 2, H 2, Tq 80, Tk 72, D 64, no mask; dO at 4000 x normal, as under
    the loss scaler, and v at 8 x): the fp32 max |dS| must pass 65504, and
    the kernels' dq, dk and dv must be finite exactly where the plain
    versions' are (on the kernel forward's lse and delta), within
    ``FLASH_LOW_TOL`` there, and two launches bitwise equal.  Without the
    per-row exponent (query rows of dS in dQ, key rows of dSᵀ in dK) dq and
    dk would overflow (the CPU tests' negative controls)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(7)

    def rnd(t, mag):
        return torch.from_numpy((mag * rng.standard_normal((2, 2, t, 64)))
                                .astype(np.float32)).to(device,
                                                        torch.float16)

    q, k, v, do = rnd(80, 1.0), rnd(72, 1.0), rnd(72, 8.0), rnd(80, 4000.0)
    scale = 64 ** -0.5
    out, lse = fa.flash_forward(q, k, v, None, scale, False)
    delta = fa._delta(out, do)
    dq = fa.flash_dq(q, k, v, None, do, lse, delta, scale, False)
    dq2 = fa.flash_dq(q, k, v, None, do, lse, delta, scale, False)
    r_dq = fa.flash_dq_ref(q, k, v, None, do, lse, delta, scale, False)
    dk, dv = fa.flash_dkv(q, k, v, None, do, lse, delta, scale, False)
    dk2, dv2 = fa.flash_dkv(q, k, v, None, do, lse, delta, scale, False)
    r_dk, r_dv = fa.flash_dkv_ref(q, k, v, None, do, lse, delta, scale,
                                  False)
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2))
                  * scale - lse)
    ds_max = float((p * (torch.matmul(do.float(), v.float().transpose(-1, -2))
                         - delta)).abs().max())
    if ds_max <= float(torch.finfo(torch.float16).max):
        raise AssertionError(f"flash f16 large-dS case: max |dS| {ds_max} "
                             f"stays within fp16's range")
    result = {"max_abs_ds": ds_max, "bitwise_repeat": True}
    for name, got, again, want in (("dq", dq, dq2, r_dq),
                                   ("dk", dk, dk2, r_dk),
                                   ("dv", dv, dv2, r_dv)):
        if not torch.equal(got, again):
            raise AssertionError(f"flash f16 large-dS case: two launches "
                                 f"give different {name}")
        finite = want.isfinite()
        if not bool(finite.any()) \
                or not torch.equal(got.isfinite(), finite):
            raise AssertionError(
                f"flash f16 large-dS case: {name} finite at "
                f"{int(got.isfinite().sum())} places, the plain version's "
                f"at {int(finite.sum())} of {finite.numel()}")
        excess = low_excess(got[finite], want[finite])
        if excess > 0:
            raise AssertionError(
                f"flash f16 large-dS case: {name} exceeds FLASH_LOW_TOL by "
                f"{excess}")
        result[name] = {"finite": int(finite.sum()), "of": finite.numel(),
                        "excess": excess,
                        "max_abs_err": float((got[finite].float()
                                              - want[finite].float())
                                             .abs().max())}
    return result


def check_wgmma_kernels(sfx, registers, hgmma):
    """The bf16 / fp16 forward, dQ and dK/dV are the wgmma kernels at every
    head width: HGMMA instructions in their SASS and, where this process
    built the library (``registers`` from its ptxas report), no spill
    stores."""
    from paddle_tpu_torch.ops import flash_attention as fa

    for kind in ("fwd", "dq", "dkv"):
        for d in fa.HEAD_DIMS:
            if not hgmma.get(kind, {}).get(d):
                raise AssertionError(f"flash {kind} ({sfx}, D = {d}): no "
                                     f"HGMMA instruction in its SASS")
            reg = registers.get(kind, {}).get(d)
            if reg is None:
                continue
            if reg["kernel"] != f"flash_{kind}_wgmma_kernel" \
                    or reg.get("spill_stores", 0):
                raise AssertionError(f"flash {kind} ({sfx}, D = {d}): "
                                     f"{reg} (want the wgmma kernel, no "
                                     f"spill stores)")


def phase_kernel_flash_amp():
    """The flash forward, dQ and dK/dV kernels on bf16 and fp16 q, k, v and
    dO (AMP with kept activations) against their plain versions on the same
    inputs: ``phase_kernel_flash``'s three cases at the training path's
    shape, each padded case with its bias in fp32 and in the inputs' dtype,
    then the ragged case at the other head widths, and in fp16 a case
    past fp16's range in dS (``_check_fp16_large_ds``); within
    ``FLASH_LOW_TOL``, two launches bitwise equal; kernel, plain, bound and
    SDPA times (SDPA on the same low inputs, forward, forward + backward
    under autograd, and its backward alone) for the padding and causal
    cases; each kernel's name, registers, spills, blocks per SM and HGMMA
    count (``check_wgmma_kernels``).  Returns the kernels-line entries, one
    a dtype and kernel."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(4)
    scale = FLASH_D ** -0.5
    cases = (("padding", TRAIN_LEN, TRAIN_LEN, False, True),
             ("causal", TRAIN_LEN, TRAIN_LEN, True, False),
             ("ragged", 100, 77, True, True))
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    entries, report = [], {}
    for dtype in (torch.bfloat16, torch.float16):
        sfx = fa.DTYPES[dtype]
        out, worst = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        for name, t_q, t_k, causal, padded in cases:
            q, k, v, do, bias, lens = flash_case_inputs(gen, device, t_q,
                                                        t_k, padded)
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            entry = {"t_q": t_q, "t_k": t_k, "causal": causal,
                     "padded_keys": int(t_k * TRAIN_BATCH - lens.sum()),
                     "bitwise_repeat": True}
            biases = {"f32": bias} if bias is None else {
                "f32": bias, sfx: bias.to(dtype)}
            for bias_sfx, b_ in biases.items():
                errs, ref_max, lse_b, delta_b = _check_flash_case(
                    q, k, v, do, b_, scale, causal,
                    f"{sfx} {name} case, {bias_sfx} bias")
                if bias_sfx == "f32":
                    lse, delta = lse_b, delta_b
                worst["fwd"] = max(worst["fwd"], errs["out"][0],
                                   errs["lse"][0])
                worst["dq"] = max(worst["dq"], errs["dq"][0])
                worst["dkv"] = max(worst["dkv"], errs["dk"][0],
                                   errs["dv"][0])
                entry[f"{bias_sfx}_bias"] = {"max_abs_err_ulps": errs,
                                             "plain_max_abs": ref_max}
            if name != "ragged":
                entry.update(_time_flash(q, k, v, do, bias, lse, delta,
                                         scale, causal, lens))
            out[name] = entry
            del q, k, v, do, lse, delta
            torch.cuda.empty_cache()
        widths = {}
        for d in fa.HEAD_DIMS:
            if d != FLASH_D:
                q, k, v, do, bias, _ = flash_case_inputs(
                    gen, device, 100, 77, True, b=4, h=2, d=d)
                q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
                widths[d] = _check_flash_case(q, k, v, do, bias, d ** -0.5,
                                              True, f"{sfx} D = {d} case")[0]
        out["other_widths"] = {"batch": 4, "heads": 2, "t_q": 100, "t_k": 77,
                               "max_abs_err_ulps": widths}
        out["registers"] = flash_registers(sfx)
        out["blocks_per_sm"] = {kind: {d: flash_blocks_per_sm(kind, d, sfx)
                                       for d in fa.HEAD_DIMS}
                                for kind in ("fwd", "dq", "dkv")}
        if dtype == torch.float16:
            out["large_ds"] = _check_fp16_large_ds()
        out["hgmma"] = flash_hgmma(sfx)
        check_wgmma_kernels(sfx, out["registers"], out["hgmma"])
        report[sfx] = out
        main = out["padding"]
        for kind, line in (("fwd", 280), ("dq", 328), ("dkv", 349)):
            entries.append({
                "name": f"flash_{kind}_{sfx}", "route": "cuda",
                "source": src,
                "replaces": f"paddle_tpu/ops/pallas_flash.py:{line}",
                "max_abs_err": worst[kind], "ms": main[f"{kind}_ms"],
                "plain_ms": main[f"{kind}_plain_ms"],
                "bound_ms": main[f"{kind}_bound_ms"],
                "bound_by": main[f"{kind}_bound_by"],
                **_flash_library(main, kind)})
    emit("kernel_flash_amp", batch=TRAIN_BATCH, heads=FLASH_HEADS, d=FLASH_D,
         tolerance=FLASH_LOW_TOL, **report)
    return entries


def _flash_library(times, kind):
    """The kernels-line library time of a bf16 / fp16 flash kernel: SDPA's
    forward for the forward; for dQ SDPA's backward alone
    (``library_bwd_ms``: no one PyTorch call computes dq by itself; its
    backward computes dq, dk and dv), beside ``dq_plus_dkv_ms``, the sum it
    is to be held against; none for dK/dV (the same backward, held against
    the same sum on dQ's entry)."""
    if kind == "fwd":
        return {"library_ms": times["fwd_library_ms"]}
    if kind == "dq":
        return {"library_ms": times["library_bwd_ms"],
                "dq_plus_dkv_ms": times["dq_plus_dkv_ms"]}
    return {"library_ms": None}


def build_training(batch_len, dropout=None, flash=False):
    """Transformer-base as the training slice builds it (unfused attention,
    or every attention through the flash kernels with ``flash``; the
    config's dropout unless given): (main, startup, avg_cost)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import transformer

    framework.fresh_session()
    cfg = transformer.base_config()
    cfg.flash_attention = flash
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


def launch_counts():
    """Every kernel's launch count on the training path, by name."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused

    by_fwd, by_bwd = (fused.xent_fwd_launches_by_dtype,
                      fused.xent_bwd_launches_by_dtype)
    return {"softmax_xent_fwd": fused.xent_fwd_launches,
            "softmax_xent_bwd": fused.xent_bwd_launches,
            "softmax_xent_fwd_bf16": by_fwd["bfloat16"],
            "softmax_xent_bwd_bf16": by_bwd["bfloat16"],
            "softmax_xent_fwd_f16": by_fwd["float16"],
            "softmax_xent_bwd_f16": by_bwd["float16"],
            "adam": fused.adam_launches,
            "adam_tensors": fused.adam_tensors,
            "flash_fwd": fa.flash_fwd_launches,
            "flash_dq": fa.flash_dq_launches,
            "flash_dkv": fa.flash_dkv_launches,
            **{f"flash_{kind}_{sfx}": by[dtype]
               for kind, by in (("fwd", fa.flash_fwd_launches_by_dtype),
                                ("dq", fa.flash_dq_launches_by_dtype),
                                ("dkv", fa.flash_dkv_launches_by_dtype))
               for dtype, sfx in (("bfloat16", "bf16"), ("float16", "f16"))},
            "momentum": fused.momentum_launches,
            "momentum_tensors": fused.momentum_tensors}


def op_dispatches(exe, program, *fetches):
    """The calls a run of ``program`` fetching ``fetches`` makes after its
    first: one per op, one per group of ops the Executor runs at once, none
    for the constant ops it ran the first time."""
    names = tuple(getattr(f, "name", f) for f in fetches)
    plan = next(p for key, p in exe._plans.items()
                if key[0] == program._cache_token and key[3] == names)
    return sum(1 for k, op in enumerate(plan.ops)
               if k not in plan.grouped and id(op) not in plan.const_ops)


def reset_launch_counts():
    from paddle_tpu_torch.ops import launch_counts as lc

    lc.add(lc.snapshot(), -1)


def phase_train(progs, profile_run=False, flash=False, beside=None,
                amp=False):
    """The training main path on the card (unfused attention, or the flash
    kernels with ``flash``; under bf16 AMP with kept activations with
    ``amp``, the caller having enabled it); returns the kernels' launch
    counts over its steps and the step's numbers.  ``beside``: other
    training phases' numbers by name, printed beside this run's (without
    it, the run checks dropout)."""
    import math

    import torch

    from paddle_tpu_torch import fluid

    phase = "train" + "_flash" * flash + "_amp" * amp
    main, startup, cost = progs
    exe = fluid.Executor()  # the default place: the card
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = train_feed(TRAIN_BATCH, TRAIN_LEN)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.reshape(-1)[0]))
    counts = launch_counts()
    per_step = {"softmax_xent_fwd": XENT_FWD_PER_STEP,
                "softmax_xent_bwd": XENT_BWD_PER_STEP, "adam": ADAM_PER_STEP,
                "adam_tensors": ADAM_TENSORS_PER_STEP}
    if amp:  # the logits are bf16: every xent launch is the bf16 kernels'
        per_step.update(softmax_xent_fwd_bf16=XENT_FWD_PER_STEP,
                        softmax_xent_bwd_bf16=XENT_BWD_PER_STEP)
    if flash:
        per_step.update(flash_fwd=FLASH_FWD_PER_STEP,
                        flash_dq=FLASH_DQ_PER_STEP,
                        flash_dkv=FLASH_DKV_PER_STEP)
    if flash and amp:  # every flash launch the bf16 kernels', none fp32
        per_step.update(flash_fwd_bf16=FLASH_FWD_PER_STEP,
                        flash_dq_bf16=FLASH_DQ_PER_STEP,
                        flash_dkv_bf16=FLASH_DKV_PER_STEP)
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in counts}
    if counts != want:
        raise AssertionError(f"kernel launches over {TRAIN_STEPS} training "
                             f"steps: {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    steady = step_ms[1:]
    tokens = TRAIN_BATCH * TRAIN_LEN
    stats = {"steady_step_ms": sum(steady) / len(steady),
             "target_tokens_per_s": tokens * len(steady) / (sum(steady)
                                                            / 1e3),
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    extra = ({"beside": beside} if beside
             else {"dropout": check_dropout(exe, main, feed, scope)})
    if amp:
        extra["amp"] = {"dtype": "bfloat16", "keep_activations": True}
    emit(phase, model="transformer_base", batch=TRAIN_BATCH,
         seq_len=TRAIN_LEN, steps=TRAIN_STEPS, losses=losses,
         launches=counts, ops_per_step=len(main.global_block().ops),
         op_dispatches_per_step=op_dispatches(exe, main, cost),
         startup_s=startup_s, step_ms=step_ms, **stats, **extra)
    if profile_run:
        profile_step(phase, lambda: exe.run(main, feed=feed,
                                            fetch_list=[cost], scope=scope),
                     {"gemm": GEMM_KEYS, "flash": ("flash_",)})
    return counts, stats


def phase_train_parity():
    """One initial state, 3 steps on the card and on the CPU (the plain
    versions): the losses agree."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    batch, seq_len = 2, 32
    main, startup, cost = build_training(seq_len, dropout=0.0)
    (cpu, gpu), _, (cpu_scope, card_scope) = parity_runs(
        (main, startup, cost), train_feed(batch, seq_len, seed=1), 3,
        (fluid.CPUPlace(), fluid.CUDAPlace(0)))
    param_diff = max(float((card_scope.get(p.name).cpu()
                            - cpu_scope.get(p.name)).abs().max())
                     for p in main.global_block().all_parameters())
    tol = np.array([1e-5, 1e-4, 1e-4])
    rel = check_parity("train_parity", cpu, gpu, tol)
    emit("train_parity", batch=batch, seq_len=seq_len, card_losses=gpu.tolist(),
         cpu_losses=cpu.tolist(), rel_err=rel, rtol=tol.tolist(),
         params_max_abs_diff_after=param_diff,
         values_carried=sum(v.persistable for v in startup.list_vars()),
         torch_threads=torch.get_num_threads())


def phase_train_flash_parity(amp=False):
    """One initial state, 3 steps of the flash build on the card, the
    flash build on the CPU (the plain versions) and the unfused build on
    the card: flash on the card agrees with the CPU (rtol 1e-5 at step 0,
    1e-4 after) and with the unfused build (rtol 2e-4, the reference's
    own flash-vs-softmax tolerance, ``tests/test_pallas_flash.py``).  At
    length 32 every tile is ragged.  With ``amp``, all three in bf16 with
    kept activations: the card against the CPU within
    ``AMP_PARITY_RTOL``, flash against unfused within
    ``FLASH_AMP_UNFUSED_RTOL``, every flash launch a bf16 one."""
    import contextlib

    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.transformer import load_reference_params

    batch, seq_len = 2, 32
    flash = build_training(seq_len, dropout=0.0, flash=True)
    unfused = build_training(seq_len, dropout=0.0)
    feed = train_feed(batch, seq_len, seed=2)
    feed["src_word"][1, -5:] = 0  # padded source keys: the bias path
    runs = []
    for (main, startup, cost), place in ((flash, fluid.CPUPlace()),
                                         (flash, fluid.CUDAPlace(0)),
                                         (unfused, fluid.CUDAPlace(0))):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope, main, cost, place))
    init = {v.name: runs[0][1].get(v.name).numpy()
            for v in flash[1].list_vars() if v.persistable}
    names = {v.name for v in unfused[1].list_vars() if v.persistable}
    if names != set(init):
        raise AssertionError(f"flash and unfused builds hold different "
                             f"state: {sorted(names ^ set(init))}")
    for _, scope, _, _, place in runs[1:]:
        load_reference_params(scope, init, place)
    reset_launch_counts()
    with (fluid.amp.amp_guard("bfloat16", keep_activations=True) if amp
          else contextlib.nullcontext()):
        losses = np.array([[float(exe.run(main, feed=feed, fetch_list=[cost],
                                          scope=scope)[0].reshape(-1)[0])
                            for _ in range(3)]
                           for exe, scope, main, cost, _ in runs])
    cpu, card, card_unfused = losses
    counts = launch_counts()
    launched = counts["flash_fwd_bf16" if amp else "flash_fwd"]
    if counts["flash_fwd"] != 3 * FLASH_FWD_PER_STEP \
            or launched != counts["flash_fwd"]:
        raise AssertionError(f"the card's flash run launched {counts}")
    rel_cpu = np.abs(card - cpu) / np.abs(cpu)
    rel_unfused = np.abs(card - card_unfused) / np.abs(card_unfused)
    if amp:
        tol_cpu = np.full(3, AMP_PARITY_RTOL)
        tol_unfused = FLASH_AMP_UNFUSED_RTOL
    else:
        tol_cpu, tol_unfused = np.array([1e-5, 1e-4, 1e-4]), 2e-4
    if not (np.isfinite(card).all() and (rel_cpu <= tol_cpu).all()
            and (rel_unfused <= tol_unfused).all()):
        raise AssertionError(
            f"flash training losses disagree: card {card.tolist()}, CPU "
            f"{cpu.tolist()} (rel {rel_cpu.tolist()}, tolerance "
            f"{tol_cpu.tolist()}), unfused card {card_unfused.tolist()} "
            f"(rel {rel_unfused.tolist()}, tolerance {tol_unfused})")
    emit("train_flash_amp_parity" if amp else "train_flash_parity",
         batch=batch, seq_len=seq_len, amp=amp,
         card_losses=card.tolist(), cpu_losses=cpu.tolist(),
         unfused_card_losses=card_unfused.tolist(),
         rel_err_cpu=rel_cpu.tolist(), rtol_cpu=tol_cpu.tolist(),
         rel_err_unfused=rel_unfused.tolist(), rtol_unfused=tol_unfused,
         launches=counts)


def phase_train_amp_parity():
    """bf16 with kept activations, one initial state, 3 steps on the card
    and on the CPU (the plain versions): the losses agree within
    ``AMP_PARITY_RTOL``."""
    import numpy as np

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
    reset_launch_counts()
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        losses = [[float(exe.run(main, feed=feed, fetch_list=[cost],
                                 scope=scope)[0].reshape(-1)[0])
                   for _ in range(3)] for exe, scope in runs]
    counts = launch_counts()
    cpu, card = np.array(losses[0]), np.array(losses[1])
    rel = np.abs(card - cpu) / np.abs(cpu)
    if not (np.isfinite(card).all() and (rel <= AMP_PARITY_RTOL).all()
            and counts["softmax_xent_fwd_bf16"] == 3 * XENT_FWD_PER_STEP):
        raise AssertionError(
            f"bf16 training on the card and the CPU disagree: card "
            f"{card.tolist()}, CPU {cpu.tolist()} (rel {rel.tolist()}, "
            f"tolerance {AMP_PARITY_RTOL}); launches {counts}")
    emit("train_amp_parity", batch=batch, seq_len=seq_len,
         amp={"dtype": "bfloat16", "keep_activations": True},
         card_losses=card.tolist(), cpu_losses=cpu.tolist(),
         rel_err=rel.tolist(), rtol=AMP_PARITY_RTOL, launches=counts)


def phase_train_amp_fp16_scaler(flash=False):
    """The tiny Transformer in fp16 with kept activations and the dynamic
    loss scaler on the card, from an ``init_loss_scale`` that overflows
    step 1: that step leaves every read-write persistable bitwise as it
    was and halves the scale; the scale halves on each overflow, and
    after ``FP16_GROWTH`` good steps in a row it doubles; the good steps
    train (finite loss that falls) and launch Adam once each, every step
    the fp16 xent kernels and, with ``flash``, the fp16 flash kernels
    (its attention through them).  Returns the launch counts."""
    import math

    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import transformer

    framework.fresh_session()
    batch, seq_len = FP16_BATCH, FP16_LEN
    with fluid.amp.amp_guard("float16", keep_activations=True):
        fluid.amp.enable("float16", keep_activations=True,
                         init_loss_scale=FP16_INIT_SCALE,
                         growth_interval=FP16_GROWTH)
        cfg = transformer.tiny_config()
        cfg.flash_attention = flash
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, cost = transformer.build(cfg, src_len=seq_len,
                                              tgt_len=seq_len, lr=1e-3)
        block = main.global_block()
        n_ring = sum(op.type == "ring_attention" for op in block.ops)
        reads = {n for op in block.ops for n in op.input_arg_names if n}
        writes = {n for op in block.ops for n in op.output_arg_names if n}
        state = sorted(n for n in reads & writes
                       if block._var_recursive(n).persistable)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        rng_feed = train_feed(batch, seq_len, seed=3)
        feed = {k: v % cfg.src_vocab_size for k, v in rng_feed.items()}
        reset_launch_counts()
        steps = []
        for _ in range(FP16_STEPS):
            before = {n: scope.get(n).clone() for n in state}
            fwd0 = launch_counts()["flash_fwd_f16"]
            loss = float(exe.run(main, feed=feed, fetch_list=[cost],
                                 scope=scope)[0].reshape(-1)[0])
            torch.cuda.synchronize()
            steps.append({
                **({"flash_fwd_f16": launch_counts()["flash_fwd_f16"] - fwd0}
                   if flash else {}),
                "loss": loss,
                "skipped": all(torch.equal(scope.get(n), before[n])
                               for n in state),
                "scale": float(scope.get("@LOSS_SCALE@").reshape(-1)[0]),
                "good": int(scope.get("@LOSS_SCALE_GOOD@").reshape(-1)[0])})
        counts = launch_counts()
    scale, good, grew = FP16_INIT_SCALE, 0, 0
    for k, st in enumerate(steps):  # the scaler's rule, step by step
        if st["skipped"]:
            scale, good = max(scale / 2, 1.0), 0
        else:
            good += 1
            if good >= FP16_GROWTH:
                scale, good, grew = scale * 2, 0, grew + 1
        if (st["scale"], st["good"]) != (scale, good):
            raise AssertionError(f"loss scale after step {k + 1}: "
                                 f"{st['scale']} / {st['good']} good steps, "
                                 f"expected {scale} / {good}: {steps}")
    good_losses = [st["loss"] for st in steps if not st["skipped"]]
    n_good = len(good_losses)
    if not (steps[0]["skipped"] and steps[0]["scale"] == FP16_INIT_SCALE / 2
            and grew >= 1 and n_good >= 2 * FP16_GROWTH
            and all(math.isfinite(v) for v in good_losses)
            and good_losses[-1] < good_losses[0]):
        raise AssertionError(f"fp16 loss scaler run: {steps}")
    want = {k: 0 for k in counts}
    want.update(softmax_xent_fwd=XENT_FWD_PER_STEP * FP16_STEPS,
                softmax_xent_bwd=XENT_BWD_PER_STEP * FP16_STEPS,
                softmax_xent_fwd_f16=XENT_FWD_PER_STEP * FP16_STEPS,
                softmax_xent_bwd_f16=XENT_BWD_PER_STEP * FP16_STEPS,
                adam=n_good, adam_tensors=n_good * len(
                    [p for p in block.all_parameters() if p.trainable]))
    if flash:  # the forward in each op and its grad, dQ and dK/dV once
        for kind, per_op in (("fwd", 2), ("dq", 1), ("dkv", 1)):
            want[f"flash_{kind}"] = want[f"flash_{kind}_f16"] = \
                per_op * n_ring * FP16_STEPS
        if any(st["flash_fwd_f16"] != 2 * n_ring for st in steps):
            raise AssertionError(f"fp16 flash launches a step: {steps}")
    if counts != want:
        raise AssertionError(f"fp16 scaler launches {counts}, expected "
                             f"{want}")
    emit("train_flash_amp_fp16_scaler" if flash else "train_amp_fp16_scaler",
         model="transformer_tiny", batch=batch,
         seq_len=seq_len, amp={"dtype": "float16", "keep_activations": True,
                               "init_loss_scale": FP16_INIT_SCALE,
                               "growth_interval": FP16_GROWTH},
         steps=steps, skipped=[k + 1 for k, st in enumerate(steps)
                               if st["skipped"]],
         growths=grew, state_vars=len(state), launches=counts,
         **({"flash_attention_ops": n_ring} if flash else {}),
         first_step_bitwise_unchanged=True)
    return counts


def build_resnet(image_hw=224, class_dim=1000, lr=0.1):
    """ResNet-50 as ``resnet.build`` makes it (Momentum(lr, 0.9), fp32):
    (main, startup, loss, acc)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import resnet

    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss, acc = resnet.build(
            class_dim=class_dim, depth=50,
            image_shape=(3, image_hw, image_hw), lr=lr)
    return main, startup, loss, acc


def resnet_feed(batch, image_hw, class_dim):
    """bench.py's ResNet feed: normal images and uniform labels from
    ``RandomState(0)``."""
    import numpy as np

    rng = np.random.RandomState(0)
    return {"img": rng.normal(size=(batch, 3, image_hw, image_hw)).astype(
        np.float32),
        "label": rng.randint(0, class_dim, size=(batch, 1)).astype(np.int64)}


def phase_kernel_momentum(shapes, phase="kernel_momentum"):
    """The momentum group kernel over one tensor set per parameter shape of
    a model's path (one shared learning rate, as the path has it) and over a
    ragged set (own learning rates, a view off 16-byte alignment),
    Nesterov off and on, against the plain version; then the call's
    kernel, device, plain, library, host and bound times (Nesterov off, as
    the training path runs it)."""
    import inspect

    import torch

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(4)
    mu = 0.9

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def group(shape_list, lrs):
        return [[rnd(sh, 0.1) for sh in shape_list],
                [rnd(sh, 1e-2) for sh in shape_list],
                [rnd(sh, 1e-2) for sh in shape_list], lrs]

    lr = torch.full((1,), 0.1, device=device)
    main = group(shapes, [lr] * len(shapes))
    sizes = ragged_sizes()
    ragged = group([(n,) for n in sizes],
                   [torch.full((1,), 0.1 / (1 + k), device=device)
                    for k in range(len(sizes))])
    for col, scale in ((0, 0.1), (1, 1e-2), (2, 1e-2)):
        ragged[col].append(offset_view(gen, device, 4096, scale))
    ragged[3].append(torch.full((1,), 0.05, device=device))
    report = {}
    for name, cols in (("main", main), ("ragged", ragged)):
        for nesterov in (False, True):
            want = fused.momentum_group_ref(*cols, mu, nesterov)
            got = [[t.clone() for t in col] for col in cols]
            before = (fused.momentum_launches, fused.momentum_tensors)
            fused.momentum_group(*got, mu, nesterov)
            torch.cuda.synchronize()
            launches = fused.momentum_launches - before[0]
            if (launches, fused.momentum_tensors - before[1]) != (
                    1, len(cols[0])):
                raise AssertionError(
                    f"the {name} momentum group launched {launches} times "
                    f"for {len(cols[0])} tensors")
            report[f"{name}_{'nesterov' if nesterov else 'plain'}"] = \
                _compare_group(
                    f"the momentum kernel ({name} set, nesterov={nesterov})",
                    got[0] + got[2], [w[i] for i in range(2) for w in want],
                    MOMENTUM_TOL)
    n = sum(p.numel() for p in main[0])
    params = [torch.nn.Parameter(p.detach().clone()) for p in main[0]]
    for q, g in zip(params, main[1]):
        q.grad = g
    how = ("fused" if "fused" in inspect.signature(torch.optim.SGD).parameters
           else "foreach")
    opt = torch.optim.SGD(params, lr=0.1, momentum=mu, **{how: True})
    times = time_group(lambda: fused.momentum_group(*main, mu, False),
                       lambda: fused.momentum_group_ref(*main, mu, False),
                       opt.step, "momentum_group",
                       lambda: fused.momentum_launches)
    # p, g, v read and p, v written; the shared lr read once
    bound, bound_by = bound_ms(20 * n + 4, 4 * n)
    emit(phase, tensors=len(main[0]), values=n, mu=mu, lr=0.1,
         ragged_tensors=len(ragged[0]),
         ragged_sizes=[p.numel() for p in ragged[0]], atol=MOMENTUM_TOL,
         rtol=MOMENTUM_TOL, **report, **times, bound_ms=bound,
         bound_by=bound_by,
         library=f"torch.optim.SGD(momentum={mu}, {how}=True)",
         smallest=min(p.numel() for p in main[0]),
         largest=max(p.numel() for p in main[0]))
    return {"name": "momentum", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/momentum.cu",
            "replaces": "paddle_tpu/ops/pallas_fused.py:481",
            "max_abs_err": max(r["max_abs_err"] for r in report.values()),
            "ms": times["graph_ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": times["library_graph_ms"]}


def conv_tflop_per_step(main, batch):
    """The convolutions' fp32 operations in one training step of ``main``
    at ``batch``: 2 per multiply-add, forward, input grad and filter grad
    (the first conv's input grad, which nothing reads, counted too)."""
    import numpy as np

    block = main.global_block()
    flops = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            flops += 2 * int(np.prod(out[1:])) * int(np.prod(w[1:]))
    return 3 * flops * batch / 1e12


def phase_train_resnet(progs, profile_run=False, amp=False):
    """ResNet-50 training on the card (under bf16 AMP with kept activations
    with ``amp``, the caller having enabled it): returns the kernels'
    launch counts over its steps."""
    import math

    import torch

    from paddle_tpu_torch import fluid

    main, startup, loss, acc = progs
    exe = fluid.Executor()  # the default place: the card
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = resnet_feed(RESNET_BATCH, 224, 1000)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, accs, step_ms = [], [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                         scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv.reshape(-1)[0]))
        accs.append(float(av.reshape(-1)[0]))
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want["momentum"] = MOMENTUM_PER_STEP * RESNET_STEPS
    want["momentum_tensors"] = MOMENTUM_TENSORS_PER_STEP * RESNET_STEPS
    if counts != want:
        raise AssertionError(f"kernel launches over {RESNET_STEPS} ResNet "
                             f"steps: {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet training loss: {losses}")
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"peak allocated {peak} bytes")
    steady = step_ms[1:]
    steady_ms = sum(steady) / len(steady)
    conv_tflop = conv_tflop_per_step(main, RESNET_BATCH)
    phase = "train_resnet_amp" if amp else "train_resnet"
    # the convolutions' least time at the dtype's peak (bf16 dense tensor
    # cores under AMP, fp32 CUDA cores otherwise)
    conv_peak = PEAK_BF16_FLOPS if amp else PEAK_FP32_FLOPS
    emit(phase, model="resnet50", batch=RESNET_BATCH,
         image_hw=224, classes=1000, steps=RESNET_STEPS, losses=losses,
         loss_fell=losses[-1] < losses[0], accuracies=accs,
         launches=counts, startup_s=startup_s, step_ms=step_ms,
         steady_step_ms=steady_ms,
         images_per_s=RESNET_BATCH * 1e3 / steady_ms,
         ops_per_step=len(main.global_block().ops),
         op_dispatches_per_step=op_dispatches(exe, main, loss, acc),
         conv_tflop_per_step=conv_tflop,
         conv_bound_ms=conv_tflop / conv_peak * 1e15,
         max_memory_allocated=peak,
         **({"amp": {"dtype": "bfloat16", "keep_activations": True}}
            if amp else {}))
    if profile_run:
        profile_step(phase, lambda: exe.run(main, feed=feed,
                                            fetch_list=[loss], scope=scope),
                     {"conv": CONV_KEYS})
    return counts


def phase_conv_fp32():
    """The conv2d op and its explicit grad through the Executor on the
    card while the caller has cuDNN's TF32 on: output, input and filter
    gradients within float32 rounding of a float64 convolution (max error
    at most 1e-5 of the largest magnitude); a plain ``F.conv2d`` under the
    same setting is held against the same reference for contrast."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models.params import load_reference_params

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 64, 56, 56)).astype(np.float32)
    w = (rng.standard_normal((128, 64, 3, 3)) * 0.05).astype(np.float32)
    wt = rng.standard_normal((32, 128, 28, 28)).astype(np.float32)
    framework.fresh_session()
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        xv = fluid.layers.data("x", shape=list(x.shape), dtype="float32",
                               append_batch_size=False, stop_gradient=False)
        out = fluid.layers.conv2d(xv, 128, 3, stride=2, padding=1,
                                  bias_attr=False,
                                  param_attr=fluid.ParamAttr(name="w"))
        wv = fluid.layers.data("wt", shape=list(wt.shape), dtype="float32",
                               append_batch_size=False)
        fluid.backward.append_backward(
            fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, wv)))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    load_reference_params(scope, {"w": w}, fluid.CUDAPlace(0))
    x64, w64 = (torch.from_numpy(a).to(device, torch.float64).requires_grad_()
                for a in (x, w))
    ref = F.conv2d(x64, w64, None, 2, 1)
    rdx, rdw = torch.autograd.grad(ref, [x64, w64],
                                   torch.from_numpy(wt).to(device,
                                                           torch.float64))
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        got = exe.run(prog, feed={"x": x, "wt": wt},
                      fetch_list=[out, "x@GRAD", "w@GRAD"], scope=scope)
        plain = F.conv2d(torch.from_numpy(x).to(device),
                         torch.from_numpy(w).to(device), None, 2, 1)
        torch.cuda.synchronize()
    finally:
        conv.fp32_precision = prev

    def rel_err(a, want):
        want = want.detach().cpu().numpy()
        return float(np.abs(np.asarray(a, np.float64) - want).max()
                     / np.abs(want).max())

    errs = {n: rel_err(a, r) for n, a, r in (("out", got[0], ref),
                                              ("dx", got[1], rdx),
                                              ("dw", got[2], rdw))}
    plain_err = rel_err(plain.cpu().numpy(), ref)
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"conv2d op under a caller's TF32 setting is "
                             f"not float32: errors {errs} of the largest "
                             f"magnitude (plain TF32 conv {plain_err})")
    emit("conv_fp32", shape={"x": list(x.shape), "w": list(w.shape),
                             "stride": 2, "padding": 1},
         caller_conv_fp32_precision="tf32", op_rel_err=errs, tol=1e-5,
         plain_conv_under_tf32_rel_err=plain_err)


def phase_train_resnet_parity(phase, progs, feed, steps, tensors, **facts):
    """A conv net (``progs``: main, startup, loss; momentum over
    ``tensors`` tensors a step) from one initial state on the CPU (the
    plain versions) and on the card, the card given the CPU's state again
    before each of ``steps`` steps: each step's loss, the running stats
    after it, and the velocities after it as one vector agree; one
    momentum launch a step.  ``facts`` go into the line."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.params import load_reference_params

    main, startup, loss = progs
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    stats = [n for n in names if ".w_mean" in n or ".w_variance" in n]
    vel = [n for n in names if "velocity" in n]
    runs = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope, place))

    def state(scope):
        return {n: scope.get(n).detach().cpu().numpy().copy() for n in names}

    reset_launch_counts()
    rtol_s, atol_s = RESNET_PARITY_STATS_TOL
    per_step = []
    for step in range(steps):
        load_reference_params(runs[1][1], state(runs[0][1]), runs[1][2])
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].reshape(-1)[0])
                  for exe, scope, _ in runs]
        cpu, card = state(runs[0][1]), state(runs[1][1])
        a = np.concatenate([cpu[n].ravel() for n in vel])
        b = np.concatenate([card[n].ravel() for n in vel])
        cosine = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        stats_err = max(float((np.abs(card[n] - cpu[n])
                               - rtol_s * np.abs(cpu[n])).max())
                        for n in stats)
        rel = abs(losses[1] - losses[0]) / abs(losses[0])
        per_step.append({"cpu_loss": losses[0], "card_loss": losses[1],
                         "loss_rel_err": rel, "velocity_cosine": cosine,
                         "stats_excess_over_rtol": stats_err})
        if not (np.isfinite(losses).all()
                and rel <= RESNET_PARITY_LOSS_RTOL
                and stats_err <= atol_s
                and cosine >= RESNET_PARITY_VELOCITY_COSINE):
            raise AssertionError(f"{phase}: card and CPU steps disagree at "
                                 f"step {step}: {per_step[-1]}")
    counts = launch_counts()
    if (counts["momentum"], counts["momentum_tensors"]) != (
            steps * MOMENTUM_PER_STEP, steps * tensors):
        raise AssertionError(f"{phase}: the card's steps launched {counts}")
    emit(phase, **facts, steps=per_step, loss_rtol=RESNET_PARITY_LOSS_RTOL,
         stats_rtol=rtol_s, stats_atol=atol_s,
         velocity_cosine_min=RESNET_PARITY_VELOCITY_COSINE,
         values_carried=len(names), launches=counts)


def clone_scope(scope):
    """A scope holding copies of ``scope``'s tensors and of its generators
    (each in the state it has now): the same training state, apart."""
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.framework import RNG_STATE_VAR

    out = fluid.Scope()
    for k, v in scope._values.items():
        if isinstance(v, torch.Tensor):
            out.set(k, v.clone())
        elif k == RNG_STATE_VAR:
            gens = {}
            for d, g in v.items():
                gens[d] = torch.Generator(device=g.device)
                gens[d].set_state(g.get_state())
            out.set(k, gens)
    return out


def state_diff(a, b):
    """Whether two scopes hold bitwise the same tensors and generator
    states, and the tensor that differs most (largest difference relative
    to its largest magnitude)."""
    import torch

    from paddle_tpu_torch.fluid.framework import RNG_STATE_VAR

    names = sorted(k for k, v in a._values.items()
                   if isinstance(v, torch.Tensor))
    if names != sorted(k for k, v in b._values.items()
                       if isinstance(v, torch.Tensor)):
        raise AssertionError("the two runs hold different state names")
    worst, equal = {"name": None, "max_abs": 0.0, "rel": 0.0}, True
    for k in names:
        x, y = a.get(k), b.get(k)
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: {x.dtype} {tuple(x.shape)} against "
                                 f"{y.dtype} {tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        equal = False
        d = float((x.double() - y.double()).abs().max())
        rel = d / max(float(y.double().abs().max()), 1e-30)
        if rel > worst["rel"]:
            worst = {"name": k, "max_abs": d, "rel": rel}
    ga, gb = a.get(RNG_STATE_VAR) or {}, b.get(RNG_STATE_VAR) or {}
    rng_equal = sorted(ga) == sorted(gb) and all(
        torch.equal(ga[d].get_state(), gb[d].get_state()) for d in ga)
    return {"bitwise": equal, "generators_equal": rng_equal,
            "tensors": len(names), "worst": worst}


def window_profile(exe, main, feed, fetches, scope, steps,
                   feed_per_step=False):
    """One more window of ``steps`` replays under ``torch.profiler``: the
    device's busy share of the wall time, the CUDA graph launches and the
    kernel launches the host made a step, and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_trace()
        t0 = time.perf_counter()
        exe.run_steps(main, feed=feed, fetch_list=fetches, n_steps=steps,
                      scope=scope, feed_per_step=feed_per_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad_trace()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaGraphLaunch", "cudaLaunchKernel",
                          "cuLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernelEx")}
    launched = sum(v for k, v in calls.items() if k != "cudaGraphLaunch")
    spans = device_spans(prof)
    busy_s, n_events, top = trace_summary(spans)
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall, "device_events": n_events,
            "graph_launches_per_step": calls.get("cudaGraphLaunch", 0)
            / steps,
            # pad_trace's spin kernels left out; what remains is the
            # graph's registered generators: each replay fills their seed
            # and offset
            "host_kernel_launches_per_step": (launched - 2 * PAD_SPINS)
            / steps,
            "top_kernels": top[:6]}


def window_against_steps(phase, progs, fetches, feed, per_step, items,
                         profile_run, loss_rtol):
    """``WINDOW_STEPS`` x 2 Executor.run steps on the card against two
    ``run_steps(n_steps=WINDOW_STEPS)`` windows of one executor from the
    same state (a copy of the scope, generators included; the first
    window runs a step, captures the next and replays).  ``feed`` is one
    feed for every step, or a list of one a step (the windows take theirs
    stacked, with ``feed_per_step``).  The last step's
    fetches and every state tensor bitwise, or else the fetched loss
    (``fetches[0]``) within ``loss_rtol`` relative at each window's end,
    the worst difference printed; the other fetches (dropout masks, drawn
    from the generators alone) bitwise.  The windows' launches must be ``per_step`` x
    steps.  Prints the graphed and the eager step's device ms (CUDA
    events around 5 steps), the capture's time and the graph pool's
    bytes; with ``profile_run`` a profiled third window.  Returns
    (executor, window scope, numbers)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    main, startup = progs
    n = WINDOW_STEPS
    per_step_feed = isinstance(feed, list)
    steps = feed if per_step_feed else [feed] * (2 * n)
    window_feeds = ([{k: np.stack([f[k] for f in steps[w * n:(w + 1) * n]])
                      for k in steps[0]} for w in range(2)]
                    if per_step_feed else [feed] * 2)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    win_scope = clone_scope(scope)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    eager = []
    for k in range(2 * n):
        if k == n:
            start.record()
        eager.append(exe.run(main, feed=steps[k], fetch_list=fetches,
                             scope=scope))
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / n
    reset_launch_counts()
    windows, window_ms, host_ms = [], [], []
    for fd in window_feeds:
        t0 = time.perf_counter()
        start.record()
        windows.append(exe.run_steps(main, feed=fd, fetch_list=fetches,
                                     n_steps=n, scope=win_scope,
                                     feed_per_step=per_step_feed))
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / n)
        window_ms.append(start.elapsed_time(end) / n)
    counts = launch_counts()
    want = {k: per_step.get(k, 0) * 2 * n for k in counts}
    if counts != want:
        raise AssertionError(f"{phase}: kernel launches over {2 * n} "
                             f"windowed steps: {counts}, expected {want}")
    graph = next(w.graph for w in exe._windows.values())
    if (graph.eager_steps, graph.replays) != (1, 2 * n - 1):
        raise AssertionError(f"{phase}: {graph.eager_steps} eager steps "
                             f"and {graph.replays} replays, expected 1 and "
                             f"{2 * n - 1}")
    diff = state_diff(win_scope, scope)
    equal = [[np.array_equal(w, e) for w, e in zip(win, step)]
             for win, step in ((windows[0], eager[n - 1]),
                               (windows[1], eager[-1]))]
    fetched_equal = all(all(e) for e in equal)
    if not all(e[1:] == [True] * (len(fetches) - 1) for e in equal):
        raise AssertionError(f"{phase}: the windows' last {fetches[1:]} "
                             f"differ from the per-step path's: {equal}")
    losses = np.array([[float(w[0].reshape(-1)[0]) for w in windows],
                       [float(eager[n - 1][0].reshape(-1)[0]),
                        float(eager[-1][0].reshape(-1)[0])]])
    rel = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    bitwise = diff["bitwise"] and fetched_equal
    if not (np.isfinite(losses).all()
            and (bitwise or (rel <= loss_rtol).all())):
        raise AssertionError(f"{phase}: windowed losses {losses[0]} against "
                             f"per-step {losses[1]} (rel {rel}, tolerance "
                             f"{loss_rtol}); state {diff}")
    stats = {"graph_step_ms": window_ms[1], "first_window_step_ms":
             window_ms[0], "eager_step_ms": eager_ms,
             "window_host_step_ms": host_ms,
             "items_per_s_graphed": items * 1e3 / window_ms[1],
             "items_per_s_eager": items * 1e3 / eager_ms,
             "capture_s": graph.capture_s, "graph_pool_bytes":
             graph.pool_bytes, "replays": graph.replays}
    extra = {}
    if profile_run:
        extra["profile"] = window_profile(exe, main, window_feeds[-1],
                                          fetches, win_scope, n,
                                          per_step_feed)
    emit(phase, steps=2 * n, window_steps=n, windows=2,
         feed_per_step=per_step_feed,
         window_losses=losses[0].tolist(), per_step_losses=losses[1].tolist(),
         loss_rel_err=rel.tolist(), loss_rtol=loss_rtol, bitwise=bitwise,
         fetches_bitwise=equal, state=diff, launches=counts,
         op_dispatches_per_step_eager=op_dispatches(exe, main, *fetches),
         **stats, **extra)
    return exe, win_scope, stats


def phase_train_window_flash_amp(profile_run=False):
    """Transformer-base in bf16 with kept activations through the flash
    kernels, ``bench.py``'s feed at 64 x 256, constant learning rate:
    windows against per-step runs (``window_against_steps``), every flash
    and xent launch the bf16 kernels'."""
    from paddle_tpu_torch import fluid

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, cost = build_training(TRAIN_LEN, flash=True)
        # the first dropout's mask: the window's must be the per-step
        # path's, drawn from a generator the graph replays
        mask = next(op.output("Mask")[0] for op in main.global_block().ops
                    if op.type == "dropout")
        per_step = {"softmax_xent_fwd": XENT_FWD_PER_STEP,
                    "softmax_xent_bwd": XENT_BWD_PER_STEP,
                    "softmax_xent_fwd_bf16": XENT_FWD_PER_STEP,
                    "softmax_xent_bwd_bf16": XENT_BWD_PER_STEP,
                    "adam": ADAM_PER_STEP,
                    "adam_tensors": ADAM_TENSORS_PER_STEP,
                    "flash_fwd": FLASH_FWD_PER_STEP,
                    "flash_dq": FLASH_DQ_PER_STEP,
                    "flash_dkv": FLASH_DKV_PER_STEP,
                    "flash_fwd_bf16": FLASH_FWD_PER_STEP,
                    "flash_dq_bf16": FLASH_DQ_PER_STEP,
                    "flash_dkv_bf16": FLASH_DKV_PER_STEP}
        exe, _, stats = window_against_steps(
            "train_window_flash_amp", (main, startup), [cost, mask],
            train_feed(TRAIN_BATCH, TRAIN_LEN), per_step,
            TRAIN_BATCH * TRAIN_LEN, profile_run, FLASH_AMP_UNFUSED_RTOL)
    exe.close()
    return stats


def phase_train_window_resnet_amp(profile_run=False):
    """ResNet-50 in bf16 with kept activations at batch 256: windows
    against per-step runs with one momentum launch a step; then
    ``feed_per_step`` windows fed by ``DevicePrefetcher`` (pinned memory,
    a side stream) at depth 2 and, for comparison, staged in the loop
    (depth 0): each loop's host-clocked ms a step."""
    import math

    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.prefetch import DevicePrefetcher

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, loss, _ = build_resnet()
        feed = resnet_feed(RESNET_BATCH, 224, 1000)
        per_step = {"momentum": MOMENTUM_PER_STEP,
                    "momentum_tensors": MOMENTUM_TENSORS_PER_STEP}
        exe, scope, stats = window_against_steps(
            "train_window_resnet_amp", (main, startup), [loss], feed,
            per_step, RESNET_BATCH, profile_run, AMP_PARITY_RTOL)
        loops = {}
        for depth in (2, 0, 2):
            def source(n):
                for _ in range(n):
                    yield feed  # bench.py's synthetic feed: one batch
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with DevicePrefetcher(source(PREFETCH_WINDOWS * WINDOW_STEPS),
                                  n_steps=WINDOW_STEPS,
                                  place=fluid.CUDAPlace(0),
                                  depth=depth) as pf:
                for fd, count in pf:
                    losses.append(float(exe.run_steps(
                        main, feed=fd, fetch_list=[loss], n_steps=count,
                        scope=scope, feed_per_step=True)[0].reshape(-1)[0]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (
                PREFETCH_WINDOWS * WINDOW_STEPS)
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"prefetched ResNet losses {losses}")
            loops.setdefault(f"depth_{depth}_step_ms", []).append(ms)
        if len(exe._windows) != 1:
            raise AssertionError("the prefetched windows built another step")
    emit("train_window_resnet_prefetch", windows=PREFETCH_WINDOWS,
         window_steps=WINDOW_STEPS, pinned=True,
         graph_step_ms=stats["graph_step_ms"], **loops)
    exe.close()
    return stats


def phase_train_window_fp16_scaler():
    """The tiny Transformer in fp16 with kept activations, the dynamic loss
    scaler (growth every ``FP16_GROWTH`` good steps) and the noam schedule
    (``warmup_steps=8``): one window of ``FP16_WINDOW`` steps against as
    many guarded ``Executor.run`` steps from the same state, bitwise —
    parameters, moments, beta pows, scale, good-step counter,
    ``@STEP_COUNTER@``, the generator and the last step's loss and
    learning rate.  The initial scale is twice the largest a probe run
    found to fit, so the first step overflows (the gate then runs on the
    card: Adam runs, its result is not committed)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import transformer

    def build(init_scale):
        framework.fresh_session()
        fluid.amp.enable("float16", keep_activations=True,
                         init_loss_scale=init_scale,
                         growth_interval=FP16_GROWTH)
        cfg = transformer.tiny_config()
        cfg.flash_attention = True  # its attention through the fp16 kernels
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, cost = transformer.build(cfg, src_len=FP16_LEN,
                                              tgt_len=FP16_LEN,
                                              warmup_steps=8)
        lr = next(op.input("LearningRate")[0]
                  for op in main.global_block().ops if op.type == "adam")
        return main, startup, cost, lr, cfg

    feed = {k: v % 1000 for k, v in train_feed(FP16_BATCH, FP16_LEN,
                                               seed=3).items()}
    with fluid.amp.amp_guard("float16", keep_activations=True):
        main, startup, cost, lr, _ = build(FP16_INIT_SCALE)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        for _ in range(FP16_STEPS):  # the probe: halve until a step fits
            before = float(scope.get("@LOSS_SCALE@")[0])
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
            if int(scope.get("@LOSS_SCALE_GOOD@")[0]) == 1:
                break
        else:
            raise AssertionError("fp16 scaler probe: no step fit")
        init_scale = 2.0 * before
        main, startup, cost, lr, _ = build(init_scale)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        win_scope = clone_scope(scope)
        steps = []
        for _ in range(FP16_WINDOW):
            out = exe.run(main, feed=feed, fetch_list=[cost, lr],
                          scope=scope)
            steps.append({"loss": float(out[0].reshape(-1)[0]),
                          "lr": float(out[1].reshape(-1)[0]),
                          "scale": float(scope.get("@LOSS_SCALE@")[0]),
                          "good": int(scope.get("@LOSS_SCALE_GOOD@")[0])})
        reset_launch_counts()
        win = exe.run_steps(main, feed=feed, fetch_list=[cost, lr],
                            n_steps=FP16_WINDOW, scope=win_scope)
        counts = launch_counts()
    skipped = [k + 1 for k, st in enumerate(steps)
               if k == 0 and st["scale"] < init_scale
               or k > 0 and st["scale"] < steps[k - 1]["scale"]]
    diff = state_diff(win_scope, scope)
    fetched = all(np.array_equal(w, e) for w, e in zip(win, out))
    n_adam = len([p for p in main.global_block().all_parameters()
                  if p.trainable])
    want = {k: 0 for k in counts}
    want.update(softmax_xent_fwd=XENT_FWD_PER_STEP * FP16_WINDOW,
                softmax_xent_bwd=XENT_BWD_PER_STEP * FP16_WINDOW,
                softmax_xent_fwd_f16=XENT_FWD_PER_STEP * FP16_WINDOW,
                softmax_xent_bwd_f16=XENT_BWD_PER_STEP * FP16_WINDOW,
                adam=FP16_WINDOW, adam_tensors=n_adam * FP16_WINDOW)
    n_ring = sum(op.type == "ring_attention"
                 for op in main.global_block().ops)
    for kind, per_op in (("fwd", 2), ("dq", 1), ("dkv", 1)):
        want[f"flash_{kind}"] = want[f"flash_{kind}_f16"] = \
            per_op * n_ring * FP16_WINDOW
    if not (diff["bitwise"] and diff["generators_equal"] and fetched
            and skipped and skipped[0] == 1 and counts == want
            and int(scope.get("@STEP_COUNTER@")[0]) ==
            FP16_WINDOW - len(skipped)):
        raise AssertionError(f"fp16 scaler window against per-step: state "
                             f"{diff}, fetches equal {fetched}, skipped "
                             f"steps {skipped}, steps {steps}, launches "
                             f"{counts} (expected {want})")
    emit("train_window_fp16_scaler", model="transformer_tiny",
         batch=FP16_BATCH, seq_len=FP16_LEN, window_steps=FP16_WINDOW,
         init_loss_scale=init_scale, growth_interval=FP16_GROWTH,
         warmup_steps=8, skipped=skipped, steps=steps, state=diff,
         fetches_bitwise=fetched, launches=counts,
         step_counter=int(scope.get("@STEP_COUNTER@")[0]),
         window_loss=float(win[0].reshape(-1)[0]),
         window_lr=float(win[1].reshape(-1)[0]))
    exe.close()


def add_counts(total, counts):
    """``total`` += ``counts``, key by key."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def persist_state(scope, program):
    """Copies of the persistables of ``program`` that ``scope`` holds."""
    return {v.name: scope.get(v.name).clone() for v in program.list_vars()
            if v.persistable and scope.get(v.name) is not None}


def state_equal(scope, snapshot):
    """The names of ``snapshot`` whose tensor in ``scope`` is not bitwise
    the snapshot's."""
    import torch

    return sorted(n for n, t in snapshot.items()
                  if not torch.equal(scope.get(n), t))


def save_timed(exe, scope, dirname, program):
    """``fluid.io.save_persistables`` of ``scope``: (bytes, seconds)."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, dirname, program)
    secs = time.perf_counter() - t0
    return sum(os.path.getsize(os.path.join(dirname, n))
               for n in os.listdir(dirname)), secs


def load_timed(exe, scope, dirname, program):
    import torch

    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    fluid.io.load_persistables(exe, dirname, program, scope=scope)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def first_loss(fetched):
    return float(fetched[0].reshape(-1)[0])


def phase_persist_flash_amp(tmp, card):
    """Transformer-base at full width through the bf16 flash kernels,
    dropout 0: evaluate, save, resume and deploy.  Two training steps;
    ``main.clone(for_test=True)`` on the next batch launches exactly
    ``FLASH_OPS`` bf16 flash forwards and one bf16 xent forward and nothing
    else, leaves every persistable bitwise, and its loss is the next
    training step's (from the same parameters) within 2^-8 (its ms a batch
    fetching the loss, CUDA events over 5 runs); then
    ``save_persistables``, 2 more steps (run A), a fresh scope's startup
    and ``load_persistables`` (every persistable bitwise the saved one),
    the same 2 steps (run B, within 2^-8 of A: the embedding grad's
    atomics); then ``save_inference_model`` of the logits and a predictor
    on the card in a fresh scope: its logits the eval clone's (bitwise, or
    within 2^-8), ``FLASH_OPS`` bf16 flash forwards and no xent a batch.
    Returns the phase's launch counts."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import (NativeConfig, PaddleTensor,
                                            create_paddle_predictor)

    tol = AMP_PARITY_RTOL
    total = {}
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, cost = build_training(TRAIN_LEN, dropout=0.0,
                                             flash=True)
        xent = next(op for op in main.global_block().ops
                    if op.type == "softmax_with_cross_entropy")
        logits = xent.input("Logits")[0]
        feeds = [train_feed(TRAIN_BATCH, TRAIN_LEN, seed=k)
                 for k in range(5)]
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        reset_launch_counts()
        for k in range(2):
            exe.run(main, feed=feeds[k], fetch_list=[cost], scope=scope)
        add_counts(total, launch_counts())

        # evaluate
        test = main.clone(for_test=True)
        before = persist_state(scope, main)
        reset_launch_counts()
        eval_loss = first_loss(exe.run(test, feed=feeds[2],
                                       fetch_list=[cost], scope=scope))
        eval_counts = launch_counts()
        add_counts(total, eval_counts)
        want = {k: 0 for k in eval_counts}
        want.update(flash_fwd=FLASH_OPS, flash_fwd_bf16=FLASH_OPS,
                    softmax_xent_fwd=1, softmax_xent_fwd_bf16=1)
        if eval_counts != want:
            raise AssertionError(f"persist_flash_amp: eval launches "
                                 f"{eval_counts}, expected {want}")
        moved = state_equal(scope, before)
        if moved:
            raise AssertionError(f"persist_flash_amp: eval moved {moved}")
        reset_launch_counts()
        eval_ms = cuda_time_ms(lambda: exe.run(test, feed=feeds[2],
                                               fetch_list=[cost],
                                               scope=scope), 5, warmup=0)
        add_counts(total, launch_counts())
        reset_launch_counts()
        train_loss = first_loss(exe.run(main, feed=feeds[2],
                                        fetch_list=[cost], scope=scope))
        eval_rel = abs(eval_loss - train_loss) / abs(train_loss)
        if not eval_rel <= tol:
            raise AssertionError(f"persist_flash_amp: eval loss "
                                 f"{eval_loss} against the training step's "
                                 f"{train_loss}")

        # save, then resume in a fresh scope
        ckpt = os.path.join(tmp, "transformer_ckpt")
        saved_bytes, save_s = save_timed(exe, scope, ckpt, main)
        saved = persist_state(scope, main)
        run_a = [first_loss(exe.run(main, feed=feeds[k], fetch_list=[cost],
                                    scope=scope)) for k in (3, 4)]
        fresh = fluid.Scope()
        exe.run(startup, scope=fresh)
        load_s = load_timed(exe, fresh, ckpt, main)
        differ = state_equal(fresh, saved)
        if differ:
            raise AssertionError(f"persist_flash_amp: loaded {differ} "
                                 f"differ from the saved state")
        run_b = [first_loss(exe.run(main, feed=feeds[k], fetch_list=[cost],
                                    scope=fresh)) for k in (3, 4)]
        gaps = [abs(b - a) / abs(a) for a, b in zip(run_a, run_b)]
        if not (all(np.isfinite(run_a + run_b)) and max(gaps) <= tol):
            raise AssertionError(f"persist_flash_amp: resumed losses "
                                 f"{run_b} against {run_a}")
        add_counts(total, launch_counts())
        del fresh, saved, before

        # deploy: the eval clone's logits from the state now in the scope
        reset_launch_counts()
        (want_logits,) = exe.run(test, feed=feeds[2], fetch_list=[logits],
                                 scope=scope)
        add_counts(total, launch_counts())
        infer_dir = os.path.join(tmp, "transformer_infer")
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(
                infer_dir, ["src_word", "tgt_word"],
                [main.global_block().var(logits)], exe, main_program=main)
        del scope
        exe.close()
        torch.cuda.empty_cache()
        pred = create_paddle_predictor(NativeConfig(model_dir=infer_dir))
        inputs = [PaddleTensor(name=n, data=feeds[2][n])
                  for n in ("src_word", "tgt_word")]
        reset_launch_counts()
        (out,) = pred.run(inputs)
        pred_counts = launch_counts()
        add_counts(total, pred_counts)
        want = {k: 0 for k in pred_counts}
        want.update(flash_fwd=FLASH_OPS, flash_fwd_bf16=FLASH_OPS)
        if pred_counts != want:
            raise AssertionError(f"persist_flash_amp: predictor launches "
                                 f"{pred_counts}, expected {want}")
        got = out.data
        pred_bitwise = bool(np.array_equal(got, want_logits))
        scale = float(np.abs(want_logits).max())
        pred_err = float(np.abs(got - want_logits).max()) / scale
        if not (got.shape == want_logits.shape and np.isfinite(got).all()
                and (pred_bitwise or pred_err <= tol)):
            raise AssertionError(f"persist_flash_amp: predictor logits "
                                 f"{got.shape} differ from the eval clone's "
                                 f"by {pred_err} of the largest")
        del got, out, want_logits
        reset_launch_counts()
        pred_ms = cuda_time_ms(lambda: pred.run(inputs), 10, warmup=1)
        add_counts(total, launch_counts())
        pred_ops = len(pred._program.global_block().ops)
        pred.close()
        del pred
    emit("persist_flash_amp", card=card, model="transformer_base",
         batch=TRAIN_BATCH, seq_len=TRAIN_LEN, dropout=0.0,
         amp={"dtype": "bfloat16", "keep_activations": True},
         eval_launches=eval_counts, eval_loss=eval_loss,
         next_step_loss=train_loss, eval_loss_bitwise=eval_loss == train_loss,
         eval_loss_rel=eval_rel, eval_state_bitwise=True,
         eval_ms_per_batch=eval_ms,
         saved_bytes=saved_bytes, save_s=save_s, load_s=load_s,
         loaded_state_bitwise=True, run_a_losses=run_a, run_b_losses=run_b,
         resume_bitwise=run_a == run_b, resume_max_rel=max(gaps),
         rtol=tol, predictor_launches=pred_counts,
         predictor_logits_bitwise=pred_bitwise,
         predictor_logits_max_rel=pred_err, predictor_ms_per_batch=pred_ms,
         predictor_ops=pred_ops, training_ops=len(main.global_block().ops),
         phase_launches=total)
    return total


def phase_persist_resnet_amp(tmp, card):
    """ResNet-50 (batch 256, 224 px) in bf16 with kept activations: 2
    steps, ``save_persistables``, 2 more ``Executor.run`` steps (run A);
    a fresh scope's startup and ``load_persistables`` (bitwise the saved
    state), then one ``run_steps`` window of 2 (run B): B bitwise A, loss
    and every state tensor.  Returns (scope after A, the prediction's
    name, the phase's launch counts)."""
    import torch

    from paddle_tpu_torch import fluid

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, loss, _ = build_resnet()
        prediction = next(op for op in main.global_block().ops
                          if op.type == "cross_entropy").input("X")[0]
        feed = resnet_feed(RESNET_BATCH, 224, 1000)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        reset_launch_counts()
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ckpt = os.path.join(tmp, "resnet_ckpt")
        saved_bytes, save_s = save_timed(exe, scope, ckpt, main)
        saved = persist_state(scope, main)
        run_a = [first_loss(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)) for _ in range(2)]
        fresh = fluid.Scope()
        exe.run(startup, scope=fresh)
        load_s = load_timed(exe, fresh, ckpt, main)
        differ = state_equal(fresh, saved)
        if differ:
            raise AssertionError(f"persist_resnet_amp: loaded {differ} "
                                 f"differ from the saved state")
        del saved
        run_b = first_loss(exe.run_steps(main, feed=feed, fetch_list=[loss],
                                         n_steps=2, scope=fresh))
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want.update(momentum=6 * MOMENTUM_PER_STEP,
                    momentum_tensors=6 * MOMENTUM_TENSORS_PER_STEP)
        if counts != want:
            raise AssertionError(f"persist_resnet_amp: launches {counts}, "
                                 f"expected {want}")
        diff = state_diff(fresh, scope)
        if not (diff["bitwise"] and run_b == run_a[-1]):
            raise AssertionError(f"persist_resnet_amp: the resumed window "
                                 f"(loss {run_b}) against the uninterrupted "
                                 f"steps ({run_a[-1]}): {diff}")
        exe.close()
        del fresh
        torch.cuda.empty_cache()
    emit("persist_resnet_amp", card=card, model="resnet50",
         batch=RESNET_BATCH, image_hw=224,
         amp={"dtype": "bfloat16", "keep_activations": True},
         saved_bytes=saved_bytes, save_s=save_s, load_s=load_s,
         loaded_state_bitwise=True, run_a_losses=run_a, run_b_loss=run_b,
         window_state=diff, resume_bitwise=True, launches=counts)
    return scope, main, prediction, counts


def phase_infer_resnet(tmp, card, scope, main, prediction):
    """ResNet-50 in fp32 (IEEE convs) from ``persist_resnet_amp``'s trained
    scope: ``save_inference_model`` of the prediction, then a native and an
    ``AnalysisConfig`` (``enable_ir_optim``) predictor on the card at
    batch 256: the folded program keeps no ``batch_norm``, the outputs
    agree within rtol 1e-4 / atol 1e-5; images/s of each (CUDA events)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            PaddleTensor,
                                            create_paddle_predictor)

    infer_dir = os.path.join(tmp, "resnet_infer")
    exe = fluid.Executor()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            infer_dir, ["img"], [main.global_block().var(prediction)], exe,
            main_program=main)
    del scope
    torch.cuda.empty_cache()
    img = resnet_feed(RESNET_BATCH, 224, 1000)["img"]
    inputs = [PaddleTensor(name="img", data=img)]
    outs, stats = {}, {}
    for kind, cfg in (("native", NativeConfig(model_dir=infer_dir)),
                      ("analysis", AnalysisConfig(model_dir=infer_dir,
                                                  enable_ir_optim=True))):
        pred = create_paddle_predictor(cfg)
        ops = [op.type for op in pred._program.global_block().ops]
        (out,) = pred.run(inputs)
        outs[kind] = out.data
        ms = cuda_time_ms(lambda: pred.run(inputs), 5, warmup=1)
        stats[kind] = {"ops": len(ops), "batch_norm_ops": ops.count(
            "batch_norm"), "ms_per_batch": ms,
            "images_per_s": RESNET_BATCH * 1e3 / ms}
        pred.close()
        del pred
        torch.cuda.empty_cache()
    folded = stats["native"]["batch_norm_ops"]
    if stats["analysis"]["batch_norm_ops"] != 0 or folded == 0:
        raise AssertionError(f"infer_resnet: batch_norm ops {stats}")
    nat, ana = outs["native"], outs["analysis"]
    if not (nat.shape == (RESNET_BATCH, 1000) and np.isfinite(nat).all()):
        raise AssertionError(f"infer_resnet: output {nat.shape}")
    np.testing.assert_allclose(ana, nat, rtol=1e-4, atol=1e-5)
    emit("infer_resnet", card=card, model="resnet50", batch=RESNET_BATCH,
         dtype="float32", folded_batch_norms=folded,
         max_abs_diff=float(np.abs(ana - nat).max()), rtol=1e-4, atol=1e-5,
         **stats)


# -- BERT-base, DeepFM and fluid_benchmark.py's image models ---------------

def timed_steps(exe, main, feed, fetches, scope, steps):
    """``steps`` ``Executor.run`` steps with the launch counters zeroed
    first: each step's fetches, its host-clocked ms (to a synchronize) and
    its device ms (CUDA events around it), and the launches over them."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    reset_launch_counts()
    out, host_ms, device_ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        start.record()
        out.append(exe.run(main, feed=feed, fetch_list=fetches, scope=scope))
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    return out, host_ms, device_ms, launch_counts()


def check_launches(phase, counts, per_step, steps):
    """Every kernel's launches over ``steps`` steps are ``per_step`` x
    steps (0 for a kernel ``per_step`` does not name)."""
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        raise AssertionError(f"{phase}: kernel launches over {steps} steps: "
                             f"{counts}, expected {want}")


def phase_kernel_flash_bert():
    """The bf16 flash forward, dQ and dK/dV kernels at BERT-base's shape
    ([32, 12, 128, 64]: one 128-key tile, 384 (batch, head) items) with a
    ragged key-padding bias in fp32 (the model's ``_padding_bias``), and
    the same unpadded: within ``FLASH_LOW_TOL`` of their plain versions,
    two launches bitwise equal; kernel (CUDA-graph replays), plain, bound
    and SDPA times of the padded case.  Returns the times by kernel."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(15)
    scale = BERT_D ** -0.5
    out, worst = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, padded in (("padding", True), ("unpadded", False)):
        q, k, v, do, bias, lens = flash_case_inputs(
            gen, device, BERT_LEN, BERT_LEN, padded, b=BERT_BATCH,
            h=BERT_HEADS, d=BERT_D)
        q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
        errs, ref_max, lse, delta = _check_flash_case(
            q, k, v, do, bias, scale, False, f"bf16 BERT {name} case")
        worst["fwd"] = max(worst["fwd"], errs["out"][0], errs["lse"][0])
        worst["dq"] = max(worst["dq"], errs["dq"][0])
        worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        entry = {"max_abs_err_ulps": errs, "plain_max_abs": ref_max,
                 "padded_keys": int(BERT_LEN * BERT_BATCH - lens.sum()),
                 "bitwise_repeat": True}
        if padded:
            entry.update(_time_flash(q, k, v, do, bias, lse, delta, scale,
                                     False, lens))
        out[name] = entry
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    emit("kernel_flash_bert", batch=BERT_BATCH, heads=BERT_HEADS, d=BERT_D,
         t=BERT_LEN, dtype="bfloat16", bias="float32",
         tolerance=FLASH_LOW_TOL, **out)
    main = out["padding"]
    return {kind: {"ms": main[f"{kind}_ms"],
                   "plain_ms": main[f"{kind}_plain_ms"],
                   "bound_ms": main[f"{kind}_bound_ms"],
                   "bound_by": main[f"{kind}_bound_by"],
                   "max_abs_err": worst[kind], **_flash_library(main, kind)}
            for kind in ("fwd", "dq", "dkv")}


def build_bert(cfg, seq_len, n_mask, lr):
    """``bert.build`` with the flash kernels: (main, startup, total loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import bert

    framework.fresh_session()
    cfg.flash_attention = True
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        outs = bert.build(cfg, seq_len=seq_len, n_mask=n_mask, lr=lr)
    return main, startup, outs[5]


def phase_train_bert_amp(profile_run=False):
    """BERT-base pretraining (``fluid_benchmark.py``'s ``bert``: batch 32 x
    128, 16 masked positions a row, Adam 1e-4) in bf16 with kept
    activations through the flash kernels: ``BERT_STEPS`` ``Executor.run``
    steps on ``synthetic_batch`` from ``RandomState(0)``: finite losses,
    exactly ``BERT_FLASH_FWD_PER_STEP`` / ``BERT_FLASH_BWD_PER_STEP`` /
    ``BERT_FLASH_BWD_PER_STEP`` bf16 flash launches and one Adam launch
    for ``BERT_ADAM_TENSORS`` tensors a step, no other kernel's; step ms
    (host clock and CUDA events), tokens/s, peak allocated.  Then the same
    steps from the same state with the adam ops' group call on the plain
    version (:func:`plain_adam_steps`): each loss within
    ``AMP_PARITY_RTOL``.  Returns the launch counts."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.base_config()
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, loss = build_bert(cfg, BERT_LEN, BERT_MASK, 1e-4)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        init = clone_scope(scope)
        feed = bert.synthetic_batch(cfg, BERT_BATCH, BERT_LEN, BERT_MASK,
                                    np.random.RandomState(0))
        torch.cuda.reset_peak_memory_stats()
        # the total's two terms: the MLM and the NSP loss
        add = next(op for op in main.global_block().ops
                   if loss.name in op.output_arg_names)
        heads = [add.input("X")[0], add.input("Y")[0]]
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feed, [loss] + heads, scope, BERT_STEPS)
        losses, mlm, nsp = ([float(o[i].reshape(-1)[0]) for o in out]
                            for i in range(3))
        check_launches("train_bert_amp", counts, {
            "flash_fwd": BERT_FLASH_FWD_PER_STEP,
            "flash_fwd_bf16": BERT_FLASH_FWD_PER_STEP,
            "flash_dq": BERT_FLASH_BWD_PER_STEP,
            "flash_dq_bf16": BERT_FLASH_BWD_PER_STEP,
            "flash_dkv": BERT_FLASH_BWD_PER_STEP,
            "flash_dkv_bf16": BERT_FLASH_BWD_PER_STEP,
            "adam": ADAM_PER_STEP, "adam_tensors": BERT_ADAM_TENSORS},
            BERT_STEPS)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite BERT loss: {losses}")
        # the same steps from the same state with the plain Adam: the
        # trajectory (the NSP head's jump at step 1 included) is the
        # update's, not the kernel's
        plain = plain_adam_steps(main, feed, [loss] + heads, init,
                                 BERT_STEPS)
        plain_losses = [float(o[0].reshape(-1)[0]) for o in plain]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        if not max(rel) <= AMP_PARITY_RTOL:
            raise AssertionError(f"BERT-base losses with the Adam kernel "
                                 f"{losses} against the plain Adam "
                                 f"{plain_losses} (rel {rel})")
        del init
        steady = device_ms[1:]
        step_ms = sum(steady) / len(steady)
        emit("train_bert_amp", model="bert_base", batch=BERT_BATCH,
             seq_len=BERT_LEN, n_mask=BERT_MASK, steps=BERT_STEPS,
             amp={"dtype": "bfloat16", "keep_activations": True},
             losses=losses, mlm_losses=mlm, nsp_losses=nsp,
             loss_fell=losses[-1] < losses[0],
             plain_adam={"losses": plain_losses,
                         "nsp_losses": [float(o[2].reshape(-1)[0])
                                        for o in plain],
                         "loss_rel_err": rel, "rtol": AMP_PARITY_RTOL},
             launches=counts, ops_per_step=len(main.global_block().ops),
             op_dispatches_per_step=op_dispatches(exe, main, loss, *heads),
             host_step_ms=host_ms, device_step_ms=device_ms,
             steady_step_ms=step_ms,
             tokens_per_s=BERT_BATCH * BERT_LEN * 1e3 / step_ms,
             masked_tokens_per_s=BERT_BATCH * BERT_MASK * 1e3 / step_ms,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        if profile_run:
            profile_step("train_bert_amp", lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope),
                {"gemm": GEMM_KEYS, "flash": ("flash_",)})
    return counts


def plain_adam_steps(main, feed, fetches, scope, steps):
    """``steps`` ``Executor.run`` steps of ``main`` on the card with the
    adam ops' group call swapped for the plain version (``adam_group_ref``
    written back in place, as the CPU path does): each step's fetches."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import fused

    kernel = fused.adam_group

    def plain(ps, gs, m1s, m2s, lrs, b1ps, b2ps, b1, b2, eps):
        new = fused.adam_group_ref(ps, gs, m1s, m2s, lrs, b1ps, b2ps, b1, b2,
                                   eps)
        for old, upd in zip(zip(ps, m1s, m2s, b1ps, b2ps), new):
            for t, u in zip(old, upd):
                t.copy_(u)
        return b1ps, b2ps

    fused.adam_group = plain
    try:
        exe = fluid.Executor()
        return [exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
                for _ in range(steps)]
    finally:
        fused.adam_group = kernel


def parity_runs(progs, feed, steps, places):
    """``steps`` steps of ``progs`` (main, startup, loss) on each place from
    the first place's initial state: the losses ``[places, steps]``, the
    launches of the last place's steps, and each place's scope."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.params import load_reference_params

    main, startup, loss = progs
    runs = []
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope, place))
    init = {v.name: runs[0][1].get(v.name).detach().cpu().numpy()
            for v in startup.list_vars() if v.persistable}
    for _, scope, place in runs[1:]:
        load_reference_params(scope, init, place)
    losses = []
    for i, (exe, scope, _) in enumerate(runs):
        if i == len(runs) - 1:
            reset_launch_counts()
        losses.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0].reshape(-1)[0])
                       for _ in range(steps)])
    return np.array(losses), launch_counts(), [r[1] for r in runs]


def check_parity(phase, cpu, card, tol):
    """Relative errors of the card's losses against the CPU's; raises
    beyond ``tol`` (one value, or one a step)."""
    import numpy as np

    rel = np.abs(card - cpu) / np.abs(cpu)
    if not (np.isfinite(card).all() and (rel <= tol).all()):
        raise AssertionError(f"{phase}: card {card.tolist()} against CPU "
                             f"{cpu.tolist()} (rel {rel.tolist()}, "
                             f"tolerance {np.asarray(tol).tolist()})")
    return rel.tolist()


def phase_train_bert_parity():
    """``tiny_config`` BERT through the flash kernels at batch 2 x 32
    (padded keys in one row), dropout 0, 3 steps from one state on the
    CPU (the plain versions) and on the card: fp32 within rtol 1e-5 at
    step 0 and 1e-4 after, then bf16 with kept activations within
    ``AMP_PARITY_RTOL``; every attention launches the flash kernels on the
    card."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.tiny_config()
    feed = bert.synthetic_batch(cfg, 2, 32, 4, np.random.RandomState(3))
    feed["src_ids"][1, -5:] = 0
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    result = {}
    for amp in (False, True):
        progs = build_bert(bert.tiny_config(), 32, 4, 1e-3)
        if amp:
            with fluid.amp.amp_guard("bfloat16", keep_activations=True):
                (cpu, card), counts, _ = parity_runs(progs, feed, 3, places)
            tol = np.full(3, AMP_PARITY_RTOL)
        else:
            (cpu, card), counts, _ = parity_runs(progs, feed, 3, places)
            tol = np.array([1e-5, 1e-4, 1e-4])
        key = "flash_fwd_bf16" if amp else "flash_fwd"
        if counts[key] != 3 * 2 * cfg.n_layer or counts["flash_dq"] != \
                3 * cfg.n_layer:
            raise AssertionError(f"train_bert_parity: the card's run "
                                 f"launched {counts}")
        result["bf16" if amp else "fp32"] = {
            "cpu_losses": cpu.tolist(), "card_losses": card.tolist(),
            "rel_err": check_parity("train_bert_parity", cpu, card, tol),
            "rtol": tol.tolist(), "launches": counts}
    emit("train_bert_parity", batch=2, seq_len=32, n_mask=4,
         config="tiny", **result)


def deepfm_feed(batch, vocab, seed):
    """``fluid_benchmark.py``'s DeepFM feed: uniform hashed ids, labels 1
    with probability 0.3."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"feats": rng.randint(0, vocab, size=(batch, DEEPFM_FIELDS))
            .astype(np.int64),
            "label": (rng.uniform(size=(batch, 1)) < 0.3).astype(
                np.float32)}


def build_deepfm(vocab=DEEPFM_VOCAB, embed_dim=DEEPFM_DIM):
    """``deepfm.build`` at ``fluid_benchmark.py``'s accelerator widths with
    SGD: (main, startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import deepfm

    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss = deepfm.build(num_fields=DEEPFM_FIELDS,
                                     vocab_size=vocab, embed_dim=embed_dim,
                                     lr=DEEPFM_LR)
    return main, startup, loss


def phase_train_deepfm(profile_run=False):
    """DeepFM CTR (26 fields, 100,000 ids, k = 16, sparse tables, SGD 1e-3)
    at batch 32 through ``Executor.run`` on the card, ``DEEPFM_STEPS``
    steps on fresh batches: each step's ``fm_v@GRAD`` and ``fm_w1@GRAD``
    are SelectedRows of 832 rows; every table row the step did not look
    up keeps its bits; the looked-up rows equal the dense update ``old −
    lr · to_dense(grad)`` within 1e-6 of the table's largest magnitude
    (duplicate ids fold in another order).  Then ``window_against_steps``
    on 10 fresh batches: two ``run_steps`` windows of 5 fed per step (one
    CUDA graph replay a step after the first) against 10 ``Executor.run``
    steps on the same batches from one state, losses within
    ``DEEPFM_WINDOW_RTOL``, and every table row none of the 10 batches
    looked up bitwise the startup's; examples/s of both paths."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.selected_rows import SelectedRows

    main, startup, loss = build_deepfm()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    tables = ("fm_v", "fm_w1")
    grads = [t + "@GRAD" for t in tables]
    worst, losses, step_ms = 0.0, [], []
    reset_launch_counts()
    for step in range(DEEPFM_STEPS):
        feed = deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, step)
        before = {t: scope.get(t).clone() for t in tables}
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        ids = torch.from_numpy(feed["feats"]).reshape(-1).to(
            out[0].device)
        for t, g in zip(tables, out[1:]):
            if not isinstance(g, SelectedRows) or tuple(g.rows.shape) != (
                    DEEPFM_BATCH * DEEPFM_FIELDS,):
                raise AssertionError(f"{t}@GRAD is {g!r}, not a "
                                     f"SelectedRows of "
                                     f"{DEEPFM_BATCH * DEEPFM_FIELDS} rows")
            old, new = before[t], scope.get(t)
            hit = torch.zeros(DEEPFM_VOCAB, dtype=torch.bool,
                              device=new.device)
            hit[ids] = True
            if not torch.equal(new[~hit], old[~hit]):
                raise AssertionError(f"step {step}: the sparse update moved "
                                     f"rows of {t} no id looked up")
            want = old - DEEPFM_LR * g.to_dense(DEEPFM_VOCAB)
            err = float((new[hit] - want[hit]).abs().max()
                        / want.abs().max())
            worst = max(worst, err)
            if err > DEEPFM_DENSE_RTOL:
                raise AssertionError(f"step {step}: {t}'s looked-up rows "
                                     f"are {err} from the dense update")
    counts = launch_counts()
    check_launches("train_deepfm", counts, {}, DEEPFM_STEPS)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite DeepFM loss: {losses}")
    emit("train_deepfm", model="deepfm", batch=DEEPFM_BATCH,
         fields=DEEPFM_FIELDS, vocab=DEEPFM_VOCAB, embed_dim=DEEPFM_DIM,
         lr=DEEPFM_LR, steps=DEEPFM_STEPS, losses=losses,
         grad="SelectedRows", grad_rows=DEEPFM_BATCH * DEEPFM_FIELDS,
         untouched_rows_bitwise=True, dense_update_max_rel_err=worst,
         dense_update_rtol=DEEPFM_DENSE_RTOL, host_step_ms=step_ms,
         examples_per_s_eager_host=DEEPFM_BATCH * 1e3
         / (sum(step_ms[1:]) / len(step_ms[1:])), launches=counts)
    # the windows on fresh batches, as CTR traffic brings new ids a step
    feeds = [deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, 100 + k)
             for k in range(2 * WINDOW_STEPS)]
    exe, win_scope, stats = window_against_steps(
        "train_window_deepfm", (main, startup), [loss], feeds, {},
        DEEPFM_BATCH, profile_run, DEEPFM_WINDOW_RTOL)
    exe.close()
    # the rows no window step looked up hold the startup's bits
    init = fluid.Scope()
    fluid.Executor().run(startup, scope=init)
    ids = torch.from_numpy(np.concatenate([f["feats"].ravel()
                                           for f in feeds]))
    hit = torch.zeros(DEEPFM_VOCAB, dtype=torch.bool)
    hit[ids] = True
    hit = hit.to(win_scope.get(tables[0]).device)
    for t in tables:
        if not torch.equal(win_scope.get(t)[~hit], init.get(t)[~hit]):
            raise AssertionError(f"train_window_deepfm: the windows moved "
                                 f"rows of {t} no id looked up")
    emit("train_window_deepfm_rows", tables=list(tables),
         rows_looked_up=int(hit.sum()), untouched_rows_bitwise=True)
    return stats


def phase_train_deepfm_parity():
    """DeepFM at the same widths, fp32, 3 steps from one state on the CPU
    and on the card, on one batch: losses within rtol 1e-5 at step 0 and
    1e-4 after."""
    import numpy as np

    from paddle_tpu_torch import fluid

    progs = build_deepfm()
    feed = deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, 7)
    (cpu, card), counts, _ = parity_runs(progs, feed, 3,
                                      (fluid.CPUPlace(), fluid.CUDAPlace(0)))
    check_launches("train_deepfm_parity", counts, {}, 3)
    tol = np.array([1e-5, 1e-4, 1e-4])
    emit("train_deepfm_parity", batch=DEEPFM_BATCH, cpu_losses=cpu.tolist(),
         card_losses=card.tolist(),
         rel_err=check_parity("train_deepfm_parity", cpu, card, tol),
         rtol=tol.tolist())


def build_vision(name, hw=None, classes=None):
    """An image model, lr 1e-3: SE-ResNeXt-50 (224 px, 1000 classes,
    Momentum 0.9) or VGG-16 (32 px, 10 classes, Adam) as
    ``fluid_benchmark.py``'s accelerator run builds them, or the MNIST CNN
    of ``benchmark/fluid/mnist.py`` (Adam): (main, startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import mnist, se_resnext, vgg

    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if name == "se_resnext50":
            loss = se_resnext.build(
                class_dim=classes or 1000, depth=50,
                image_shape=(3, hw or 224, hw or 224), lr=VISION_LR)[3]
        elif name == "vgg16":
            loss = vgg.build(class_dim=10, image_shape=(3, 32, 32),
                             lr=VISION_LR)[3]
        else:
            loss = mnist.cnn()[3]
            fluid.optimizer.Adam(learning_rate=VISION_LR).minimize(loss)
    return main, startup, loss


def vision_feed(name, batch, hw=None, classes=None):
    import numpy as np

    rng = np.random.RandomState(0)
    shape, classes = {"se_resnext50": ((3, hw or 224, hw or 224),
                                       classes or 1000),
                      "vgg16": ((3, 32, 32), 10),
                      "mnist_cnn": ((1, 28, 28), 10)}[name]
    return {"img": rng.normal(size=(batch,) + shape).astype(np.float32),
            "label": rng.randint(0, classes, size=(batch, 1)).astype(
                np.int64)}


def phase_train_bench_vision(profile_run=False):
    """SE-ResNeXt-50, VGG-16 and the MNIST CNN, each ``VISION_STEPS``
    ``Executor.run`` steps at batch 32 under bf16 with kept activations on
    one batch of normal images: finite losses, one momentum launch a step
    (SE-ResNeXt, ``SE_MOMENTUM_TENSORS`` tensors) or one Adam launch a
    step (VGG-16 ``VGG_ADAM_TENSORS``, CNN ``CNN_ADAM_TENSORS``), no other
    kernel's; step ms, images/s and peak allocated.  Returns the launches
    by kernel."""
    import math

    import torch

    from paddle_tpu_torch import fluid

    total, report = {}, {}
    for name, per_step in (
            ("se_resnext50", {"momentum": MOMENTUM_PER_STEP,
                              "momentum_tensors": SE_MOMENTUM_TENSORS}),
            ("vgg16", {"adam": ADAM_PER_STEP,
                       "adam_tensors": VGG_ADAM_TENSORS}),
            ("mnist_cnn", {"adam": ADAM_PER_STEP,
                           "adam_tensors": CNN_ADAM_TENSORS})):
        with fluid.amp.amp_guard("bfloat16", keep_activations=True):
            main, startup, loss = build_vision(name)
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            feed = vision_feed(name, VISION_BATCH)
            torch.cuda.reset_peak_memory_stats()
            out, host_ms, device_ms, counts = timed_steps(
                exe, main, feed, [loss], scope, VISION_STEPS)
            check_launches(f"train_bench_vision {name}", counts, per_step,
                           VISION_STEPS)
            losses = [float(o[0].reshape(-1)[0]) for o in out]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name}: non-finite losses {losses}")
            steady = sum(device_ms[1:]) / len(device_ms[1:])
            report[name] = {
                "losses": losses, "launches": counts,
                "host_step_ms": host_ms, "device_step_ms": device_ms,
                "steady_step_ms": steady,
                "images_per_s": VISION_BATCH * 1e3 / steady,
                "ops_per_step": len(main.global_block().ops),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            add_counts(total, counts)
            if profile_run and name == "se_resnext50":
                profile_step("train_se_resnext_amp", lambda: exe.run(
                    main, feed=feed, fetch_list=[loss], scope=scope),
                    {"conv": CONV_KEYS})
            del exe, scope
            torch.cuda.empty_cache()

    emit("train_bench_vision", batch=VISION_BATCH, steps=VISION_STEPS,
         lr=VISION_LR, amp={"dtype": "bfloat16", "keep_activations": True},
         **report)
    return total


def phase_train_se_resnext_parity():
    """SE-ResNeXt-50 at 64 px, 10 classes, batch 4, fp32, dropout off (the
    two devices draw other masks): one step from one state on the CPU and
    on the card, as ``train_resnet_parity`` compares."""
    main, startup, loss = build_vision("se_resnext50", hw=64, classes=10)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    phase_train_resnet_parity(
        "train_se_resnext_parity", (main, startup, loss),
        vision_feed("se_resnext50", 4, hw=64, classes=10), 1,
        SE_MOMENTUM_TENSORS, batch=4, image_hw=64, classes=10, lr=VISION_LR)


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
    started = time.perf_counter()
    smi = phase_device()
    phase_build()
    import torch

    paged = phase_kernel()
    xent_fwd, xent_bwd = phase_kernel_xent()
    torch.cuda.empty_cache()
    xent_amp = phase_kernel_xent_amp()
    torch.cuda.empty_cache()
    progs = build_training(TRAIN_LEN)
    adam = phase_kernel_adam(trainable_shapes(progs[0],
                                              ADAM_TENSORS_PER_STEP))
    torch.cuda.empty_cache()
    flash = phase_kernel_flash()
    torch.cuda.empty_cache()
    serving = phase_serving(args.profile)
    # row 8 runs on two paths: the plain step and the verify
    paged["launches"] = serving["launches"] + phase_serving_spec(serving)
    del serving
    torch.cuda.empty_cache()
    counts, unfused = phase_train(progs, args.profile)
    for k in (xent_fwd, xent_bwd, adam):
        k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    phase_train_parity()
    torch.cuda.empty_cache()
    counts, flash_stats = phase_train(build_training(TRAIN_LEN, flash=True),
                                      args.profile, flash=True,
                                      beside={"train": unfused})
    for k in flash:
        k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    phase_train_flash_parity()
    torch.cuda.empty_cache()
    resnet_progs = build_resnet()
    momentum = phase_kernel_momentum(
        trainable_shapes(resnet_progs[0], MOMENTUM_TENSORS_PER_STEP))
    torch.cuda.empty_cache()
    momentum["launches"] = phase_train_resnet(
        resnet_progs, args.profile)["momentum"]
    torch.cuda.empty_cache()
    phase_conv_fp32()
    phase_train_resnet_parity(
        "train_resnet_parity",
        build_resnet(image_hw=64, class_dim=10, lr=0.01)[:3],
        resnet_feed(4, 64, 10), 3, MOMENTUM_TENSORS_PER_STEP, batch=4,
        image_hw=64, classes=10, lr=0.01)
    torch.cuda.empty_cache()
    from paddle_tpu_torch import fluid

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        counts, amp_stats = phase_train(build_training(TRAIN_LEN),
                                        args.profile,
                                        beside={"train": unfused}, amp=True)
    for k in xent_amp:
        k["launches"] = counts.get(k["name"], 0)
    torch.cuda.empty_cache()
    phase_train_amp_parity()
    torch.cuda.empty_cache()
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        phase_train_resnet(build_resnet(), args.profile, amp=True)
    torch.cuda.empty_cache()
    counts = phase_train_amp_fp16_scaler()
    for k in xent_amp:
        if k["name"].endswith("_f16"):
            k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    flash_amp = phase_kernel_flash_amp()
    torch.cuda.empty_cache()
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        counts, _ = phase_train(
            build_training(TRAIN_LEN, flash=True), args.profile, flash=True,
            beside={"train_amp": amp_stats, "train_flash": flash_stats},
            amp=True)
    for k in flash_amp:
        k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    phase_train_flash_parity(amp=True)
    torch.cuda.empty_cache()
    counts = phase_train_amp_fp16_scaler(flash=True)
    for k in flash_amp:
        if k["name"].endswith("_f16"):
            k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    phase_train_window_flash_amp(args.profile)
    torch.cuda.empty_cache()
    phase_train_window_resnet_amp(args.profile)
    torch.cuda.empty_cache()
    with fluid.amp.amp_guard("float16", keep_activations=True):
        phase_train_window_fp16_scaler()
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        total = phase_persist_flash_amp(tmp, smi)
        torch.cuda.empty_cache()
        scope, resnet_main, prediction, counts = phase_persist_resnet_amp(
            tmp, smi)
        add_counts(total, counts)
        torch.cuda.empty_cache()
        phase_infer_resnet(tmp, smi, scope, resnet_main, prediction)
        del scope
        torch.cuda.empty_cache()
    bert_shape = phase_kernel_flash_bert()
    torch.cuda.empty_cache()
    from paddle_tpu_torch.models import bert

    # the optimizer kernels at the new paths' parameter shapes
    adam["by_model"] = optimizer_at_model_shapes(phase_kernel_adam, "adam", [
        ("bert_base", build_bert(bert.base_config(), BERT_LEN, BERT_MASK,
                                 1e-4)[0], BERT_ADAM_TENSORS),
        ("vgg16", build_vision("vgg16")[0], VGG_ADAM_TENSORS),
        ("mnist_cnn", build_vision("mnist_cnn")[0], CNN_ADAM_TENSORS)])
    momentum["by_model"] = optimizer_at_model_shapes(
        phase_kernel_momentum, "momentum",
        [("se_resnext50", build_vision("se_resnext50")[0],
          SE_MOMENTUM_TENSORS)])
    add_counts(total, phase_train_bert_amp(args.profile))
    torch.cuda.empty_cache()
    phase_train_bert_parity()
    torch.cuda.empty_cache()
    phase_train_deepfm(args.profile)
    torch.cuda.empty_cache()
    phase_train_deepfm_parity()
    torch.cuda.empty_cache()
    add_counts(total, phase_train_bench_vision(args.profile))
    torch.cuda.empty_cache()
    phase_train_se_resnext_parity()
    torch.cuda.empty_cache()
    for k in (*flash_amp, *xent_amp, adam, momentum):
        k["launches"] += total.get(k["name"], 0)
    for k in flash_amp:  # the bf16 kernels at BERT-base's shape
        _, kind, sfx = k["name"].split("_")
        if sfx == "bf16":
            k["bert_shape"] = bert_shape[kind]
    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": [paged, xent_fwd, xent_bwd, adam, *flash,
                                  momentum, *xent_amp, *flash_amp]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
