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
then ``fluid_benchmark.py``'s stacked dynamic LSTM on LoD batches, then
trains ``bench.py``'s decode cell under ``TrainingDecoder`` (control flow
and tensor arrays) and generates with it through both beam-search
engines (the ``While`` loop and the CUDA-graphed ``JitBeamSearchDecoder``),
then trains the book's label-semantic-roles tagger through the linear-chain
CRF and a CTC recognizer through ``warpctc``, decodes and scores them,
then trains MobileNet-SSD through ``ssd_loss`` and decodes it by
``detection_output`` and ``detection_map``, and trains a Faster R-CNN RPN
and RoI head through the proposal, sampling and RoI-pooling ops, trains
BERT-base under global-norm gradient clipping and holds the clip kinds
and the one-line activation, math, reduce and shape ops against the CPU,
trains DCGAN through the transposed convolutions and holds the
convolution, norm, indexed-pool and random ops against the CPU, runs
ResNet-50 and Transformer-base inference on int8 weights and DeepFM under
the streaming AUC, holds the misc, quant and metric ops against the CPU,
trains ResNet-50 under LARS momentum with a model average, the book's
MNIST MLP under Adam with LARS and DeepFM under each remaining optimizer,
holds their update ops against the CPU, then trains Transformer-base
through ``fluid.Trainer`` with serial checkpoints and the checkpointable
``data`` pipeline, kills it and resumes it in subprocesses, runs it as
windows and under the numerics guardian's drill, then builds the native
input library and trains ResNet-50 from recordio shards through the
in-graph readers (``open_files``, ``batch``, ``double_buffer``,
``read_file``) and a sequence model through ``py_reader`` with a LoD slot,
then trains ``fluid_benchmark.py``'s ``moe_transformer`` (MoE
feed-forward layers) and the stacked Transformer-base (the layer-stack
ops, with and without recompute) and holds the routing, the stacks and
``gpipe_mlp_stack`` against the CPU, then trains data-parallel through
``fluid.ParallelExecutor``: ResNet-50 and Transformer-base (ZeRO-1) in a
world-1 NCCL group, bitwise the single-device steps, and ResNet-50 over
two processes sharing the card through a gloo group, against one
process at the global batch, then Transformer-base tensor-parallel (tp2,
fp32 and bf16) and fsdp-sharded (fsdp2, bf16) over two such processes,
against one process, and checks them all.

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
                   library and bound times.  Then ``kernel_xent_ssd`` and
                   ``kernel_xent_rcnn_heads`` at the detection paths'
                   shapes (122,688 x 21 and 1,024 x 81, the narrow
                   layout): every kernel entry (fp32 / bf16 / fp16 logits;
                   hard labels with ignored and out-of-range rows; soft
                   labels) against its plain version, bitwise repeatable;
                   kernel, plain, F.cross_entropy and fwd + bwd pair times
                   as CUDA-graph replays over cold input sets (the kernels
                   line's xent entries carry them, ``by_model``, and the
                   main path's launches by layout)
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
                   2 xent-forward and 1 xent-backward launches a step,
                   all on the wide layout; op
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
    kernel_adam_stacked_lstm, kernel_adam_decoder, kernel_adam_ctc,
    kernel_momentum_se_resnext50, kernel_momentum_rcnn_heads - phases 6
                   and 13 over tensors of BERT-base's 159, VGG-16's 60, the
                   MNIST CNN's 6, the stacked LSTM's 18, the decode cell's
                   9 (phase 41), the CTC recognizer's 13 (phase 47),
                   SE-ResNeXt-50's 225 and the R-CNN head's 14 (phase 51)
                   parameter shapes
                   (the kernels line's adam and momentum entries carry
                   them, ``by_model``)
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
34b. train_bert_clip_amp - phase 33's steps with every gradient clipped to
                   a global norm of 1.0 (Google BERT's recipe, in Fluid
                   ``set_gradient_clip(GradientClipByGlobalNorm(1.0))``):
                   finite losses, 24 / 12 / 12 bf16 flash launches and 1
                   Adam launch for 159 tensors a step (the clip ops keep
                   the adam ops one run), the group norm and scale a step
                   and whether it clipped; one more step's group norm
                   against ``torch.linalg.vector_norm`` of the 159 raw
                   grads (rtol 1e-5), the clipped grads' norm against norm
                   x scale; ops, dispatches, step ms, tokens/s and peak
                   beside phase 33's
34c. train_bert_clip_parity - card against CPU, fp32: ``tiny_config`` under
                   global-norm clipping, 3 steps (losses, norms, scales:
                   rtol 1e-5 at step 0, 1e-4 after; the clip acting), and a
                   small MLP under each clip kind (global norm, norm,
                   value, error clip) and ``SGD(regularization=L1Decay)``, 5
                   steps (losses at the same tolerances; each clip acting
                   on the card)
34d. ops_tranche5_parity - the 63 one-line activation, math, reduce and
                   shape op types at full-width shapes (BERT-base's [32,
                   128, 3072] FFN activation and [32, 128, 768] hidden
                   states, its [512, 30522] MLM logits, a [32, 30522]
                   argsort, SSD's [64, 512, 19, 19] map resized to 38 x 38
                   and 10 x 10, 4,096 unique ids scattered into [30522,
                   768]), forward and grad, card against CPU: elementwise
                   rtol 1e-5 / atol 1e-6, sums ``SEQ_PARITY_TOL``,
                   integers, bools and argsort equal; exact bounds and ties
                   among the inputs
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
39. train_stacked_lstm - ``fluid_benchmark.py``'s stacked_dynamic_lstm
                   (``stacked_lstm.build``: 5147 words, emb = hid = 512, 3
                   LSTMs; 70 ops, 18 parameters, 3,754,882 values; Adam
                   1e-3, fp32) through ``fluid.Executor()`` on LoDTensor
                   feeds: 5 steps on fresh fixed-bucket batches (32 x 64
                   words), then 5 on fresh ragged ones (32 sequences of
                   16-64 words): finite losses, exactly 1 Adam launch for
                   18 tensors a step and no other kernel's; words/s and step
                   ms by CUDA events and by the host clock, op dispatches a
                   step, peak allocated
40. train_stacked_lstm_parity - the reference test's small config
                   (dict 80, emb = hid = 24, 2 LSTMs, Adam 1e-2) on LoD
                   [[6, 7]], 6 steps card against CPU (rtol 1e-5 at step 0,
                   1e-4 after, 1 Adam launch a step); then a ragged batch
                   (13 sequences, one of length 1) through every pool
                   type, softmax, expand, concat, reverse, pad / unpad,
                   conv, row_conv, enumerate, LSTMs and a GRU, card against
                   CPU: every output, its LoD and the input's grad within
                   ``SEQ_PARITY_TOL``
41. train_decoder - ``bench.py``'s ``bench_decode`` cell (vocab 1000, d
                   64, h' = tanh(fc([x, h])), h0 = fc(embedding(src)))
                   trained under ``contrib.decoder.TrainingDecoder`` (a
                   ``DynamicRNN``: ``while`` and ``while_grad``) with a
                   softmax projection, Adam 8e-3, fp32, 8 sources a batch:
                   5 fresh fixed batches of 8 x 16 target words, then 5
                   fresh ragged ones of 8 x 4-16 (permutation chains ended
                   by end_id 1, from ``--seed``): finite losses, exactly 1
                   Adam launch for the decoder's 9 tensors a step and no
                   other kernel's (``kernel_adam_decoder`` holds the kernel
                   at those shapes); step ms (CUDA events and host clock),
                   words/s, op dispatches and ``while`` iterations a step,
                   peak allocated
42. decode_beam  - phase 41's weights through ``fluid.io.save_persistables``
                   / ``load_persistables`` into a ``BeamSearchDecoder``
                   program (names realigned by ``unique_name.guard``),
                   ``bench_decode``'s feed and widths (batch 8, beam 4,
                   max_len 16, topk 50, ``RandomState(0)`` sources): 1
                   cold decode, then 3 warm; tokens/s as ``bench.py``
                   counts them, ms a decode, op dispatches and host syncs
                   a decode, the steps taken, the hypotheses' lengths
43. decode_jit   - the same weights and feed through
                   ``JitBeamSearchDecoder``: ids and both LoD levels equal
                   phase 42's (a difference only at an exact fp32 tie,
                   whose two scores are printed), scores within 1e-4; no
                   graph capture after the first decode; graph replays and
                   host flag reads a decode, ms a decode, tokens/s; then
                   ``bench_decode``'s own seed-5 random weights, where no
                   beam ends early, held to one ``BeamSearchDecoder``
                   decode of them and timed the same way
44. control_flow_parity - card against CPU: the decoder-DSL test of
                   ``tests/test_beam_search_decoder_dsl.py`` (V 14, D 24, 80
                   Adam steps: losses rtol 1e-5 at step 0, 1e-4 after; both
                   engines' ids equal the CPU's, the top hypotheses follow
                   the learned chain) and its early exit (a projection that
                   ends every beam at step 1: 3 steps, hypotheses ending at
                   end_id, both engines); the book's RNN encoder-decoder
                   (``tests/test_book.py:445``: a bi-LSTM and a
                   ``DynamicRNN`` with ``static_input`` and a
                   ``need_reorder`` memory, 8 x 10 words, 5 Adam steps on
                   a fixed and on a ragged batch); the While, IfElse,
                   Switch and StaticRNN programs of
                   ``tests/test_control_flow.py``: outputs and grads within
                   rtol 1e-5
45. train_srl    - the book's label-semantic-roles ``db_lstm`` (upstream
                   ``test_label_semantic_roles.py``: 8 inputs, word_dim
                   32, hidden 512, depth 8, ``linear_chain_crf``, SGD on an
                   exponential decay) on the synthetic conll05, its
                   embedding file loaded through ``scope.find_var('emb')
                   .get_tensor().set(...)``: 10 steps of 10 sentences
                   (finite losses, no optimizer kernel launched, ``emb``
                   bitwise unchanged, the ``vemb`` rows no id hit bitwise
                   unchanged), then 4 batches through ``crf_decoding`` and
                   ``chunk_eval`` into ``fluid.metrics.ChunkEvaluator``;
                   words/s and step ms (CUDA events and host clock), op
                   dispatches and host syncs a step and a decode batch,
                   precision / recall / F1, peak allocated
46. train_srl_parity - card against CPU: the db_lstm at hidden 32, depth
                   3, 5 SGD steps (rtol 1e-5 at step 0, 1e-4 after), then
                   its Viterbi paths and chunk counts from one state
                   (equal); then one program through every op of the
                   slice (CRF, Viterbi, CTC, the greedy decoder, edit
                   distance, chunk_eval, NCE, the hierarchical sigmoid,
                   im2sequence and ten other losses) on a ragged LoD batch
                   with a length-1 sequence: outputs, LoDs and grads
                   within ``SEQ_PARITY_TOL``, integer outputs equal
47. train_ctc    - a CTC recognizer: ``im2sequence`` over 8 images of 1 x
                   32 x 256 (kernel [32, 4], stride [1, 4]: 64 frames of
                   128), ``lod_reset``, fc, a GRU of 128 each way, fc to
                   96 classes + blank, ``warpctc``, Adam 1e-3: 10 steps
                   (finite losses, exactly 1 Adam launch for 13 tensors a
                   step and no other kernel's); then 4 batches through
                   ``ctc_greedy_decoder`` and ``fluid.evaluator.
                   EditDistance`` (held to ``fluid.metrics.EditDistance``);
                   examples/s, step ms, op dispatches and host syncs a step
                   and a decode batch, peak allocated
48. train_ssd    - MobileNet-SSD (upstream object_detection's
                   ``mobilenet_ssd.py`` and ``train.py``: 3 x 300 x 300, 21
                   classes, batch 64, 1,917 priors, ``ssd_loss`` summed,
                   RMSProp on ``piecewise_decay`` with L2 decay, fp32) on
                   synthetic VOC-shaped batches, 5 fresh steps: finite
                   losses, no host sync, exactly 3 xent-forward and 1
                   xent-backward launches a step, all on the narrow
                   layout, and no other kernel's;
                   images/s, step ms (CUDA events and host clock), op
                   dispatches and ``bipartite_match`` steps a step, peak
                   allocated
49. detect_ssd   - the trained weights through the test clone (softmax,
                   transpose, ``detection_output`` NMS 0.45,
                   ``detection_map`` 11-point), 2 fresh batches: ms, op
                   dispatches and host syncs a batch, detections kept, mAP;
                   the same decode on a CPU scope with the same weights
                   (boxes and scores within 1e-5; the rows per image as
                   tolerance-matched multisets, each unpaired row a
                   near-tie, counted by cause) and the CPU's NMS and mAP
                   over the card's boxes and scores (rows, LoD and mAP
                   equal), each timed
50. train_ssd_parity - the small SSD of ``tests/test_ssd.py``'s shape under
                   the same loss and optimizer, 5 steps card against CPU
                   (rtol 1e-5 at step 0, 1e-4 after); then every detection
                   op on fed inputs over a ragged ground-truth batch:
                   outputs, LoDs and grads within ``SEQ_PARITY_TOL``,
                   integer outputs equal
51. train_rcnn   - an RPN and RoI head with Faster R-CNN's settings on a
                   fed 1024 x 50 x 84 C4 map of 2 images (63,000 anchors an
                   image, 12,000 / 2,000 proposals, 512 RoIs an image, 81
                   classes), Momentum 0.9, 3 seeded steps: finite losses,
                   exactly 1 momentum launch for 14 tensors and 2 / 1 xent
                   launches a step (narrow layout); RoIs and foreground
                   RoIs, step ms, op dispatches and host syncs a step (the
                   host ops' reads),
                   peak allocated; ``kernel_momentum_rcnn_heads`` holds row
                   6 at its 14 shapes
52. rcnn_parity  - the head at 8 channels on a 12 x 16 map, the RPN's score
                   and delta convs held at zero, ``use_random`` False, card
                   against CPU: 3 steps' losses (rtol 1e-5 at step 0, 1e-4
                   after), then every op's outputs and the map's grad within
                   ``SEQ_PARITY_TOL``, integers and LoDs equal; then the
                   RPN alone with its convs drawn and trained: 3 steps'
                   RPN losses, ``rpn_target_assign``'s outputs and every
                   grad (``check_rpn_step``), 1 momentum launch a step
53. train_dcgan  - DCGAN at the paper's widths (Radford et al. 2016, the
                   LSUN 64 x 64 model; 4 x 4 kernels, stride 2, padding 1
                   as in dcgan.torch): G an fc to 4 x 4 x 1024 and four
                   ``conv2d_transpose`` to 3 channels, D four stride-2
                   convs from 128 to 1024 channels and an fc, batch norm,
                   N(0, 0.02) weights, batch 128, fp32, two Programs
                   sharing their parameters by name, Adam(2e-4, beta1 0.5)
                   on each side; 5 iterations of a D and a G step on
                   synthetic LSUN-shaped batches, the 100-d noise drawn on
                   the card by ``uniform_random_batch_size_like``: finite
                   losses, the noise within [-1, 1], exactly 1 Adam launch
                   for D's 12 tensors a D step and for G's 13 a G step and
                   no other kernel's, no host sync; images/s, D and G step
                   ms (CUDA events and host clock), op dispatches a step,
                   peak allocated; ``--profile`` adds the busy share and
                   the transposed convolutions' share of it; then
                   ``kernel_adam_dcgan_d`` / ``_g`` hold row 7 at D's and
                   G's shapes
54. train_dcgan_parity - 16 x 16 images, base width 16, batch 8, noise
                   fed, 3 iterations card against CPU, each step from the
                   CPU's state: the step's loss within rtol 1e-5 in the
                   first iteration and 1e-4 after, and tensor by tensor
                   in the 2-norm within the same rtol each gradient,
                   the card's Adam update of its own gradients and
                   every persistable (``adam_step_check``: the elements
                   whose Adam step follows gradient rounding are left
                   out of the last and listed); the same step in
                   float64 on the CPU shows both places' gradient
                   rounding; 1 Adam launch a step
55. ops_tranche6_parity - the 22 op types of the conv-transpose, 3-D, norm,
                   pooling-with-index and random tranche at the per-sample
                   shapes of the public models that use them (AlexNet's
                   LRN, group norm on ResNet-50's conv2, SPP-net's
                   pyramid, SegNet's indexed pool and unpool, C3D's conv
                   and pools, MobileNet v1's depthwise layers, ShuffleNet,
                   maxout, DCGAN, 3D U-Net, FCN's bilinear upsampling,
                   BERT-base's embedding draw; the batches cut for the
                   CPU side), forward and input grads card against CPU
                   (``Mask`` equal on tie-free inputs), ``print``'s text
                   equal, and the draws held to their distributions
                   (Kolmogorov-Smirnov, exact truncation bounds,
                   chi-square, a seed repeating its draw)
56. infer_resnet_int8 - ``bench.py``'s ``bench_resnet_infer`` with
                   ``BENCH_INT8=1``: ResNet-50 (224 px, 1,000 classes,
                   batch 16, random weights from a seed), the test clone
                   in fp32, then ``Int8WeightTranspiler`` after startup:
                   the 53 conv filters and the fc weight each read through
                   one ``dequantize_weight``, no float original left, the
                   int8 weights ~1/4 of fp32's bytes; top-1 of the logits
                   of 64 images against fp32's (images whose fp32 margin
                   is under twice their int8 gap apart), the largest gap;
                   int8 card against int8 CPU; images/s of both and the dequantize
                   ops' time and bytes a batch; then the same through
                   ``AnalysisConfig(enable_int8=True)`` against the fp32
                   analysis predictor
57. infer_transformer_int8 - phase 28's Transformer-base inference model
                   (batch 64 x 256, flash, fp32, random weights) through a
                   native predictor and ``AnalysisConfig(enable_int8=
                   True)``: every mul and lookup_table weight int8 (a
                   scale a row for the embeddings), exactly 18 fp32 flash
                   forwards a batch and nothing else, the logits within
                   ``INT8_LOGIT_TOL`` of fp32's largest; ms a batch
58. train_deepfm_auc - phase 35's DeepFM with ``fluid.layers.auc`` at
                   4,095 thresholds, 5 steps: the stats count the 160
                   examples, each AUC the numpy trapezoid over the same
                   buckets, the auc op on the CPU over the card's
                   predictions gives the same stats bitwise
59. ops_tranche7_parity - the 31 misc, quant and metric op types at public
                   models' shapes (DSSM's cos_sim, SSD's L2 norm, NTN,
                   NTM's shift, ResNet-50's weights through the
                   quantizers, VOC's mean IoU, MQ2007's pairs, ImageNet's
                   precision and recall, DeepFM's sparse grad through the
                   SelectedRows utilities), forward and input grads card
                   against CPU; the checkpoint ops' files read on both
                   places, ``run_steps`` refusing a save; ``get_places``;
                   ``random_crop`` windows and uniform starts on the card
60. train_resnet_lars_amp - ResNet-50 in bf16 (kept activations) at batch
                   256 x 224 px under Momentum with LARS (weight decay
                   1e-4) and ``ModelAverage(0.15, 2, 4)``: 5 steps on
                   batches drawn on the card; 1 momentum launch for 161
                   tensors and no host read a step (and no warning of
                   torch's sync debug mode); the step-0 LARS rates
                   against float64; the window closes the rule gives;
                   ``apply()`` bitwise numpy's average of the scope's
                   sums, an eval batch through the test clone,
                   ``restore()`` bitwise; beside ``train_resnet_amp``'s
                   images/s and dispatches, and the momentum wrapper's
                   host us a call with the same and with new rate tensors
61. train_window_resnet_lars_amp - the same program as two ``run_steps``
                   windows of 10 on fresh batches against the per-step
                   path: the state (sums and counters included) bitwise,
                   else the loss within 2^-8; 1 momentum launch a step
62. train_mnist_lars - the book's recognize_digits MLP (200, 200 tanh, 10
                   softmax) under Adam(1e-3, LARS 0.3) at batch 64, 10
                   steps card against CPU: losses and the 6 LARS rates
                   within rtol 1e-5 at step 0, 1e-4 after; 1 Adam launch
                   for 6 tensors a step
63. train_deepfm_optims - DeepFM (phase 35's widths, sparse tables) under
                   SGD and each optimizer that folds a SelectedRows grad
                   (Adagrad, Adamax, DecayedAdagrad, Adadelta, Ftrl), 5
                   steps card against CPU: losses, both tables; no kernel
                   launch, no host read; examples/s and dispatches
64. optim_ops_parity - the 8 new op types over ResNet-50's 161 parameter
                   shapes (FTRL at lr_power -0.5 and -0.25, the proximal
                   ops with l1 and l2, ``average_accumulates`` from
                   seeded counters through a window close and the
                   16,384-update fold), 3 steps card against CPU, each
                   group bitwise its ops one by one on the card; the
                   folding ops through DeepFM's sparse table; the
                   proximal ops refusing a SelectedRows
65. trainer_transformer_amp - Transformer-base (bf16, kept activations,
                   flash, label smoothing 0.1, dropout 0, Adam) through
                   ``fluid.Trainer`` for 8 steps on
                   ``data.from_reader(src).shuffle(512, seed=7).batch(64)``
                   (``bench.py``'s feed shapes from a seeded RandomState),
                   a checkpoint every 2 steps (max 2) with the data state
                   under _SUCCESS: the reference's event order, exactly
                   ``train_flash_amp``'s launches a step, the serials on
                   disk, each save's ms, an async save's foreground and
                   total ms beside a sync one's and its files bitwise
66. trainer_kill_resume - phase 65's run in a subprocess with
                   ``PADDLE_FAULT_KILL_STEP=5`` exits 137; beside its
                   serials (steps 1 and 3) an incomplete one is left; a
                   second subprocess resumes at step 4 from the kernels
                   the parent built and trains steps 4-7: losses and fed
                   batches bitwise phase 65's, no step replayed
67. trainer_windowed_amp - the same under ``PADDLE_TPU_SPD=4`` through
                   ``CheckpointablePrefetcher``: one eager step, then one
                   graph replay a step; each window's last loss bitwise
                   phase 65's steps 3 and 7; checkpoints stamped with the
                   windows' last steps; a resume from the first window's
                   serial trains the second window bitwise again
68. guardian_transformer_amp - the skip guardian (spike factor 10, window
                   4) with grad-Inf at step 2 and a x1e4 loss spike at
                   step 5, per step: trips at 2 and 5 and every state
                   tensor bitwise across each; as 6 windows of 4 (spike
                   at step 21: a window gives the recorder one record)
                   against the same per-step run: the same trips, the
                   state bitwise; the boundary's wait, sync-debug
                   warnings and host ms of guarded and unguarded steps;
                   ``dump_and_halt``: NumericsTripped at the step-3
                   boundary, the bundle replayed on the card bitwise,
                   naming the first non-finite variable
69. reader_native - the native input library (``paddle_tpu_torch/native``:
                   recordio, the byte queue, the shard prefetcher) built
                   by g++ here, its seconds; a zlib and an uncompressed
                   shard round trip through it and the plain versions
                   (the same bytes written); a corrupt chunk raises; the
                   prefetcher over 4 shards with 2 threads yields every
                   record once, its MB/s beside the plain version's
70. train_resnet_reader_amp - upstream's ``--use_reader_op`` path: 384
                   seeded 224 px samples into 2 recordio shards (zlib,
                   none) by ``convert_reader_to_recordio_files``, then
                   ``open_files`` -> ``batch(64)`` -> ``double_buffer``
                   -> ``read_file`` into ResNet-50 (bf16, kept
                   activations, Momentum): 6 steps, EOFException on the
                   7th run, pass 2's first batch bitwise pass 1's; the
                   popped batches bitwise their numpy batches, the losses
                   bitwise the dict-fed ``build_resnet`` twin's from the
                   same initial scope (else 2^-8 with the twin's spread),
                   1 momentum launch for 161 tensors a step, no
                   sync-debug warning in a reader-fed step; host and
                   CUDA-event ms a step each way, the read op's wait,
                   images/s, peak memory
71. reader_py_lod - ``py_reader`` with a LoD slot, a seeded ``shuffle`` and
                   ``batch`` (staged by ``double_buffer``) into
                   embedding -> sequence_pool -> fc -> xent (SGD), 2
                   epochs card against CPU: losses rtol 1e-5, LoDs
                   equal, the same steps each epoch;
                   ``create_py_reader_by_data`` the same ops and losses;
                   a ``Preprocessor`` on the card; a producer error
                   raises ``RuntimeError``
72. train_moe_amp - (after ``kernel_adam_moe_transformer`` and
                   ``kernel_adam_transformer_stacked``: the Adam kernel at
                   the two models' 196 and 34 parameter shapes)
                   ``fluid_benchmark.py``'s ``moe_transformer``:
                   Transformer-base widths, every FFN an 8-expert
                   ``moe_ffn`` (top 2, capacity factor 1.25, aux weight
                   1e-2, dropout 0.1), batch 32 x 256, bf16 with kept
                   activations, flash: 5 steps, finite losses, exactly 36
                   / 18 / 18 bf16 flash, 2 / 1 bf16 xent and 1 Adam launch
                   (196 tensors) a step; per step each expert's kept
                   tokens, the dropped share and the aux losses; tokens/s
                   and step ms (events, host), peak, dispatches; under
                   ``--profile`` the MoE ops' share of device busy
73. moe_parity   - ``moe_config()`` 5 steps card against CPU (rtol 1e-5
                   step 0, 1e-4 after); one full-width moe_ffn op (8,192
                   x 512, 8 experts, hidden 2048) and its grad, the CPU
                   choosing from the card's fp32 gate probabilities: the
                   routing equal, Out, AuxLoss and every input grad within
                   ``SEQ_PARITY_TOL``
74. train_stacked_amp - the stacked Transformer-base (two layer-stack
                   ops) at 64 x 256, bf16 kept, flash, dropout 0.1: 5
                   steps, the same launches a step as ``train_flash_amp``
                   (Adam over 34 tensors), step ms beside its, peak; then
                   one step and one ``recompute=True`` step from one state
                   and generator: loss, grads and masks bitwise, both
                   peaks
75. stack_parity - card against CPU: the tiny stacked Transformer and the
                   tiny stacked BERT (3 steps, rtol 1e-5 step 0, 1e-4
                   after), ``gpipe_mlp_stack`` relu / tanh / gelu (out and
                   grads within ``SEQ_PARITY_TOL``)
76. pe_world1    - ``ParallelExecutor`` in a world-1 NCCL group: ResNet-50
                   (bf16 kept, 224 px, batch 64) 3 steps bitwise
                   ``Executor.run`` (losses and every state tensor), one
                   momentum launch and one all-reduce of the grads a step;
                   a 4-step ``run_steps`` window (its all-reduce captured
                   in the graph) bitwise 4 per-step runs; Transformer-base
                   (bf16 kept, flash) at 64 x 256 under ``Reduce``
                   (ZeRO-1: one reduce-scatter, one Adam launch over all
                   184 tensors, one all-gather a step) 3 steps bitwise the
                   unsharded Executor; 0 sync-debug warnings in a
                   fetch-free step of each; step ms beside the Executor's
                   and the grad bucket's all-reduce ms
77. pe_dp2_resnet - two processes on the one card over a gloo group with
                   CUDA tensors, each ResNet-50 fp32 at 224 px and 64
                   images (global batch 128), given the state of a
                   one-process ``Executor`` run at batch 128 before each
                   of 3 steps: each step's loss within
                   ``RESNET_PARITY_LOSS_RTOL``, the running statistics
                   after it within ``RESNET_PARITY_STATS_TOL`` and the
                   velocities' cosine at least
                   ``RESNET_PARITY_VELOCITY_COSINE`` against that run's
                   step; the parameters bitwise across the ranks after
                   every step; one momentum launch a step a rank; step ms
                   and the grad bucket's all-reduce ms (gloo's, staged
                   through the host), by host clock and CUDA events
78. kernel_xent_partial - the xent kernels' partials entry (row 4 as the
                   tp-sharded loss runs it) against its plain version at
                   a tp2 rank's vocabulary slice of Transformer-base
                   (4,096 x 15,000 bf16, fp32 soft and shifted hard
                   labels: the wide layout) and at SSD's 122,688 x 21
                   (fp32, the narrow layout); bitwise repeatability;
                   kernel and plain times (CUDA-graph replays over cold
                   inputs) and bounds
79. pe_tp2_transformer - two processes on the one card over gloo, through
                   ``ParallelExecutor``: Transformer-base (flash, 16 x
                   256) on the mesh tp2 in fp32 (2 steps) and bf16 AMP (3
                   steps), and on fsdp2 in bf16 AMP (2 steps), against
                   one process's trajectory from the same seeded start:
                   fp32 losses within ``TP2_LOSS_RTOL0`` / ``TP2_LOSS_
                   RTOL``, bf16 within 2^-8, the replicated parameters
                   bitwise across the ranks, fsdp2's losses and parameter
                   shards bitwise one process's; a rank's launches a step
                   (flash 36 / 18 / 18 on 4 heads, the xent partials twice
                   and its backward once on [4096, 15000], one Adam
                   launch), its tp all-reduces and fsdp all-gathers a
                   step, step ms by host clock and CUDA events, peak
                   allocated beside one process's

Every phase's line carries ``seconds``: the wall time since the previous
line.

``--profile`` adds a phase after serving (8 requests that keep every slot
busy; with the graph launches a dispatch and the host's kernel launches a
tick) and one after each full-size training phase (one more step, or
one more window) and after ``detect_ssd`` (one more decode batch), each
under ``torch.profiler``; each prints the device's busy share of the
wall time and the kernels that take the most device time (the eager
steps also the host's Python profile of a step).

Before the last three lines, ``total`` prints the run's seconds.  The last
three lines are the kernels table (the bf16 flash entries also carry
their times at BERT-base's shape, ``bert_shape``), the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
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
# BERT-base under global-norm clipping: Google BERT's optimization.py
# (tf.clip_by_global_norm(grads, clip_norm=1.0)), in Fluid
# set_gradient_clip(GradientClipByGlobalNorm(1.0)); the clip ops come
# between the backward and the 159 adam ops, which stay one group launch.
# The group norm is held against torch.linalg.vector_norm over the
# fetched grads within BERT_CLIP_NORM_RTOL
BERT_CLIP_NORM, BERT_CLIP_NORM_RTOL = 1.0, 1e-5
# the small clipped programs (clip_mlp_programs): each kind's bound, set
# so that it clips on the first steps
CLIP_BOUNDS = {"global_norm": 0.1, "norm": 0.05, "value": 0.02,
               "error": 1e-3, "l1_decay": 1e-2}
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
# fluid_benchmark.py's stacked_dynamic_lstm on an accelerator
# (benchmark/fluid_benchmark.py:114-128, Adam at its default lr 1e-3):
# 5147 words, emb = hid = 512 (LSTM hidden 128, gates 512 wide), 3
# stacked LSTMs, batch 32 of 64 words a sequence (the fixed bucket), a
# fresh batch a step; then ragged batches of 32 sequences of 16-64 words.
# 70 ops, 18 parameters (3,754,882 values): one Adam launch a step for the
# 18.  The parity run takes the reference test's small config
# (tests/test_benchmark_models.py:31) on its LoD [[6, 7]], and a ragged
# batch through the sequence and recurrent ops
LSTM_DICT, LSTM_HID, LSTM_STACKED, LSTM_LR = 5147, 512, 3, 1e-3
LSTM_BATCH, LSTM_LEN, LSTM_RAGGED, LSTM_STEPS = 32, 64, (16, 64), 5
LSTM_OPS, LSTM_ADAM_TENSORS, LSTM_VALUES = 70, 18, 3754882
LSTM_SMALL = dict(dict_dim=80, emb_dim=24, hid_dim=24, stacked_num=2)
LSTM_SMALL_TENSORS, LSTM_SMALL_LR, LSTM_PARITY_STEPS = 13, 1e-2, 6
# card against CPU through the sequence and recurrent ops on a ragged
# batch (fp32; index_add's atomics and cuBLAS add in other orders)
SEQ_PARITY_TOL = (1e-4, 1e-5)  # (rtol, atol)
# bench.py's bench_decode (bench.py:571-655): vocab 1000, d 64, batch 8,
# beam 4, max_len 16, topk 50, end_id 1, seed-5 initial weights; its cell
# trained under TrainingDecoder with a softmax projection
# (tests/test_beam_search_decoder_dsl.py:67-92), Adam 8e-3, fp32: 9
# parameters (two embeddings, the h0 fc's weight and bias, the cell fc's
# two weights and bias, the projection's weight and bias), one Adam launch
# a step.  Targets: permutation chains of 16 words, GO first, end_id last
# (fixed), then ragged batches of 4-16.  Decode: 1 cold, 3 warm (bench.py
# 629-646); the jit engine's scores within 1e-4 of the eager engine's (the
# reference test's rounding to 4 decimals), ids only at a tie within 1e-6
DEC_VOCAB, DEC_D, DEC_BATCH, DEC_BEAM = 1000, 64, 8, 4
DEC_MAX_LEN, DEC_TOPK, DEC_END, DEC_GO = 16, 50, 1, 2
DEC_LR, DEC_SEED, DEC_LEN, DEC_RAGGED, DEC_STEPS = 8e-3, 5, 16, (4, 16), 5
DEC_ADAM_TENSORS, DEC_WARM = 9, 3
DEC_SCORE_ATOL, DEC_TIE_RTOL = 1e-4, 1e-6
# the decoder-DSL test (tests/test_beam_search_decoder_dsl.py) and the
# book's encoder-decoder (tests/test_book.py:445) at their widths
DSL_V, DSL_D, DSL_CHAIN, DSL_STEPS = 14, 24, 5, 80
BOOK_DICT, BOOK_EMB, BOOK_HID = 33, 16, 32
BOOK_LEN, BOOK_BATCH, BOOK_STEPS = 10, 8, 5
# the book's label-semantic-roles tagger (upstream book test
# test_label_semantic_roles.py: db_lstm with word_dim 32, mark_dim 5,
# hidden_dim 512, depth 8; the CRF's transition at mix_hidden_lr 1e-3; SGD
# on exponential_decay(0.01, 100000, 0.5, staircase); BATCH_SIZE 10) on
# the synthetic conll05 (300 words, 30 verbs, 5 IOB labels, sentences of
# 5-11 words): 10 steps, then 4 batches decoded by crf_decoding and scored
# by chunk_eval (IOB, 2 chunk types).  The parity run: hidden 32, depth 3,
# 5 steps card against CPU
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_MIX_LR, SRL_BATCH, SRL_STEPS, SRL_DECODE = 1e-3, 10, 10, 4
SRL_FEEDS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
             "target")
SRL_SMALL, SRL_PARITY_STEPS = dict(hidden_dim=32, depth=3), 5
# a CTC recognizer: 8 images of 1 x 32 x 256 cut by im2sequence (kernel
# [32, 4], stride [1, 4]) into 64 frames of 128, one sequence an image;
# fc 128 relu, a GRU of 128 each way, fc to 96 classes + the blank (96);
# warpctc on labels of 5-20 ids, Adam 1e-3, 10 steps (13 Adam tensors);
# then 4 batches through ctc_greedy_decoder and edit_distance
CTC_BATCH, CTC_IMAGE, CTC_KERNEL, CTC_HIDDEN = 8, (1, 32, 256), (32, 4), 128
CTC_CLASSES, CTC_LABEL_LENS, CTC_LR, CTC_STEPS = 96, (5, 20), 1e-3, 10
CTC_ADAM_TENSORS, CTC_DECODE = 13, 4

# MobileNet-SSD (upstream models/fluid/object_detection: mobilenet_ssd.py
# and train.py on PASCAL VOC): 3 x 300 x 300, 21 classes, batch 64, 1,917
# priors over six maps (19, 10, 5, 3, 2, 1); ssd_loss summed, RMSProp
# (rho 0.95) on piecewise_decay (lr 0.001; 4 boundaries for the 5 values)
# with L2Decay(5e-5), fp32.  Cut: synthetic VOC-shaped batches (1-6 boxes
# an image, 10 % difficult), 5 steps.  Decode: 2 batches through
# detection_output (NMS 0.45, its defaults otherwise) and detection_map
# (11-point).  ssd_loss runs two softmax cross-entropies: the mining one
# forward only, the loss one forward, again in its generic grad, and
# backward
SSD_CLASSES, SSD_IMAGE, SSD_BATCH, SSD_STEPS = 21, (3, 300, 300), 64, 5
SSD_LR, SSD_L2, SSD_NMS, SSD_PRIORS, SSD_DECODE = 1e-3, 5e-5, 0.45, 1917, 2
SSD_BOUNDARIES = [40000, 60000, 80000, 100000]
SSD_DECAY = [1.0, 0.5, 0.25, 0.1, 0.01]
SSD_BOXES, SSD_DIFFICULT = (1, 6), 0.1
SSD_XENT_PER_STEP = {"softmax_xent_fwd": 3, "softmax_xent_bwd": 1}
# the card's decoded boxes and softmax scores against the CPU's
SSD_DECODE_ATOL = 1e-5
# the small SSD of tests/test_ssd.py (3 x 16 x 16, 3 classes, 32 priors)
# under the same loss and optimizer, its lr stepping down after steps 2, 4
SSD_SMALL_CLASSES, SSD_SMALL_IMAGE, SSD_SMALL_BATCH = 3, (3, 16, 16), 4
SSD_SMALL_LR, SSD_PARITY_STEPS = 5e-3, 5
# Faster R-CNN's RPN and RoI head (upstream models/fluid/faster_rcnn's RPN
# and RoI settings) on a fed C4 map standing in for the ResNet-50 trunk:
# 2 images of 800 x 1344 (a 1024 x 50 x 84 map, 63,000 anchors an image),
# 1-10 boxes an image, 81 classes, 12,000 / 2,000 proposals, 512 RoIs an
# image, two fc of 1024; Momentum 0.9 at 0.01 (one launch a step for its
# 14 tensors); the head's softmax cross-entropy runs the xent forward twice
# (the op and its generic grad) and the backward once.  3 steps
RCNN_FEAT, RCNN_IMAGES, RCNN_IM = (1024, 50, 84), 2, (800, 1344)
RCNN_CLASSES, RCNN_FC = 81, 1024
RCNN_ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
RCNN_RPN_BATCH, RCNN_PRE_NMS, RCNN_POST_NMS, RCNN_ROIS = 256, 12000, 2000, 512
RCNN_BOXES, RCNN_SEED, RCNN_STEPS, RCNN_MOMENTUM_TENSORS = (1, 10), 7, 3, 14
RCNN_XENT_PER_STEP = {"softmax_xent_fwd": 2, "softmax_xent_bwd": 1}
# the parity run's heads: 8 channels on a 12 x 16 map (192 x 256 images),
# the RPN's score and delta convs held at zero (not trainable: 10 momentum
# tensors), use_random False
RCNN_SMALL = dict(feat=(8, 12, 16), im_hw=(192, 256), num_classes=5,
                  fc_dim=16, anchor_sizes=(32.0, 64.0), rpn_batch=64,
                  pre_nms=300, post_nms=60, rois_per_im=32, use_random=False,
                  rpn_std=0.0, rpn_trainable=False)
RCNN_SMALL_FEED = dict(feat=(8, 12, 16), im_hw=(192, 256), num_classes=5,
                       boxes=(1, 4))
RCNN_PARITY_STEPS, RCNN_SMALL_MOMENTUM_TENSORS = 3, 10
# the RPN alone at the same size with its convs drawn (Normal(0, 0.01)) and
# trained: its losses, rpn_target_assign's outputs and every parameter's
# and the feature map's grad, compared step by step (rtol 1e-5 at step 0,
# 1e-4 after, of each value plus, for a tensor, of its largest magnitude)
RPN_SMALL = dict(RCNN_SMALL, rpn_std=0.01, rpn_trainable=True, rpn_only=True)
RPN_SMALL_MOMENTUM_TENSORS = 6
# the detection ops' parity program: classes of its fed scores
DETECTION_CLASSES = 4
# DCGAN (Radford, Metz and Chintala 2016, the LSUN 64 x 64 model of its
# Figure 1; 4 x 4 kernels, stride 2, padding 1 as in the authors' Torch
# release dcgan.torch): 100-d noise uniform in [-1, 1], generator fc to
# 4 x 4 x 1024 then transposed convs 1024 -> 512 -> 256 -> 128 -> 3,
# discriminator convs 3 -> 128 -> 256 -> 512 -> 1024 then fc to a logit;
# N(0, 0.02) weights, batch 128, fp32, Adam(2e-4, beta1 0.5) on each side
# (one launch a step for D's 12 tensors, one for G's 13); 5 iterations of
# one D step and one G step on synthetic LSUN-shaped images
DCGAN_IMAGE, DCGAN_BASE, DCGAN_NZ, DCGAN_BATCH = 64, 128, 100, 128
DCGAN_LR, DCGAN_BETA1, DCGAN_STD, DCGAN_ITERS = 2e-4, 0.5, 0.02, 5
DCGAN_D_TENSORS, DCGAN_G_TENSORS = 12, 13
# the parity run: 16 x 16 images, base width 16, batch 8, noise fed from
# numpy, 3 iterations (rtol 1e-5 at the first step, 1e-4 after)
DCGAN_SMALL = dict(image=16, base=16, feed_noise=True)
DCGAN_SMALL_BATCH, DCGAN_PARITY_ITERS = 8, 3


_LAST_LINE = [time.perf_counter()]


def emit(phase, **fields):
    """One phase's JSON line; ``seconds`` (unless the phase gives its own)
    is the wall time since the previous line, the phase's own time as the
    phases run one after another."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
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


def trace_events(prof):
    """The complete events (``ph`` X) of a ``torch.profiler`` trace (which
    can be exported once)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]


def device_spans(prof, events=None):
    """(start us, end us, name) of every kernel, copy and memset a
    ``torch.profiler`` trace (or its ``events``) recorded on the device,
    in time order."""
    events = trace_events(prof) if events is None else events
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
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


# the narrow shapes' timing graphs cycle through input sets of at least
# twice the 50 MB L2 in all, so every call finds its inputs cold
XENT_COLD_BYTES = 100e6


def xent_layout_counts():
    """The xent launches by the layout the kernel entry took, by name."""
    from paddle_tpu_torch.ops import fused

    return {f"softmax_xent_{d}_{layout}":
            getattr(fused, f"xent_{d}_launches_by_layout")[layout]
            for d in ("fwd", "bwd") for layout in ("narrow", "wide")}


def check_xent_layout(phase, layout):
    """Every xent launch since the counters were last zeroed took
    ``layout`` (``narrow`` or ``wide``); returns the counts by layout."""
    from paddle_tpu_torch.ops import fused

    counts = xent_layout_counts()
    for d, total in (("fwd", fused.xent_fwd_launches),
                     ("bwd", fused.xent_bwd_launches)):
        if counts[f"softmax_xent_{d}_{layout}"] != total:
            raise AssertionError(f"{phase}: {total} xent {d} launches, "
                                 f"by layout {counts}; expected all "
                                 f"{layout}")
    return counts


def rotating_graph_ms(fn, sets):
    """``graph_time_ms`` of ``fn(*set)`` with each captured call reading
    the next of ``sets`` in turn (all of them at least once)."""
    import itertools

    turn = itertools.count()
    return graph_time_ms(lambda: fn(*sets[next(turn) % len(sets)]),
                         calls=max(20, len(sets)))


def _check_narrow_entry(what, x, lab, soft, ignore):
    """One kernel entry at a narrow shape against its plain version: loss,
    lse (and sum y) within ``ATOL`` / ``RTOL``, dx within ``DX_ATOL`` (fp32
    logits) or ``XENT_DX_ULPS`` ulp of its dtype, each output of two
    launches bitwise equal, ignored rows' loss 0.  Returns the errors."""
    import torch

    from paddle_tpu_torch.ops import fused

    loss, lse, sum_y = fused.softmax_xent_fwd(x, lab, soft, ignore)
    again = fused.softmax_xent_fwd(x, lab, soft, ignore)
    torch.cuda.synchronize()
    want = fused.softmax_xent_fwd_ref(x, lab, soft, ignore)
    errs = {}
    for name, got, second, ref in zip(("loss", "lse", "sum_y"),
                                      (loss, lse, sum_y), again, want):
        if got is None:
            continue
        if not torch.equal(got, second):
            raise AssertionError(f"{what}: {name} is not bitwise repeatable")
        if not bool((got - ref).abs().le(ATOL + RTOL * ref.abs()).all()):
            raise AssertionError(f"{what}: {name} disagrees with the plain "
                                 f"version: max abs/rel err "
                                 f"{_max_errs(got, ref)}")
        errs[f"{name}_err"] = _max_errs(got, ref)
    if not soft and not bool((loss[lab == ignore] == 0).all()):
        raise AssertionError(f"{what}: ignored rows have a nonzero loss")
    g1, g2 = fused.xent_bwd_coeffs(lab, want[2], torch.ones_like(want[1]),
                                   None, soft, ignore)
    dx = fused.softmax_xent_bwd(x, lab, want[1], g1, g2, soft)
    dx2 = fused.softmax_xent_bwd(x, lab, want[1], g1, g2, soft)
    torch.cuda.synchronize()
    rdx = fused.softmax_xent_bwd_ref(x, lab, want[1], g1, g2, soft)
    if dx.dtype != x.dtype or not torch.equal(dx, dx2):
        raise AssertionError(f"{what}: dx has dtype {dx.dtype}, or is not "
                             f"bitwise repeatable")
    errs["dx_max_abs_err"] = float((dx.float() - rdx.float()).abs().max())
    if x.dtype == torch.float32:
        if not errs["dx_max_abs_err"] <= DX_ATOL:
            raise AssertionError(f"{what}: dx disagrees with the plain "
                                 f"version: max abs err "
                                 f"{errs['dx_max_abs_err']}")
    else:
        errs["dx_max_ulps"] = ulp_err(dx, rdx)
        if not errs["dx_max_ulps"] <= XENT_DX_ULPS:
            raise AssertionError(f"{what}: dx disagrees with the plain "
                                 f"version by {errs['dx_max_ulps']} ulp")
    return errs


def phase_kernel_xent_by_model():
    """The xent kernels at the detection paths' shapes (``ssd_loss`` on 64
    x 1,917 priors x 21 classes, the R-CNN head on 2 x 512 RoIs x 81
    classes), which take the narrow layout.  Every kernel entry (fp32,
    bf16 and fp16 logits; hard labels with ignored rows and two rows
    outside ``[0, V)``, also from logits that are not 16-byte aligned;
    soft labels in fp32 and in the logits' dtype) against its plain
    version (``_check_narrow_entry``), two launches bitwise equal.  Then, fp32 with hard labels as the paths run them,
    the times of kernel, plain version and ``F.cross_entropy``, and of the
    forward + backward pair under autograd beside ``F.cross_entropy``'s:
    CUDA-graph replays (a wrapper's host time passes these kernels'
    device time) over input sets of ``XENT_COLD_BYTES`` in all, so every
    call reads cold inputs as the bound assumes.  A line each
    (``kernel_xent_<model>``).  Returns the forward's and the backward's
    numbers by model."""
    import math

    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(19)
    fwd_out, bwd_out = {}, {}
    for name, r, v in (("ssd", SSD_BATCH * SSD_PRIORS, SSD_CLASSES),
                       ("rcnn_heads", RCNN_IMAGES * RCNN_ROIS,
                        RCNN_CLASSES)):
        wide_before = (fused.xent_fwd_launches_by_layout["wide"],
                       fused.xent_bwd_launches_by_layout["wide"])
        checks, worst = {}, {"fwd": 0.0, "bwd": 0.0}
        ids = torch.randint(1, v, (r,), generator=gen, device=device)
        ids[::7] = XENT_IGNORE
        ids[1], ids[2] = -5, v + 3  # outside [0, V): they pick nothing
        y = torch.rand(r, v, generator=gen, device=device)
        y /= y.sum(-1, keepdim=True)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                           (torch.float16, "f16")):
            x = (torch.randn(r, v, generator=gen, device=device) * 2).to(
                dtype)
            # a view one row into its buffer: x not 16-byte aligned, so
            # the tiles come by plain loads
            shifted = torch.cat([x[:1], x])[1:]
            cases = [("hard", x, ids, False, XENT_IGNORE),
                     ("soft_f32", x, y, True, -100),
                     ("hard_unaligned", shifted, ids, False, XENT_IGNORE)]
            if dtype != torch.float32:
                cases.append((f"soft_{tag}", x, y.to(dtype), True, -100))
            for kind, xs, lab, soft, ignore in cases:
                errs = _check_narrow_entry(
                    f"xent at {name}'s shape ({tag}, {kind})", xs, lab, soft,
                    ignore)
                checks[f"{tag}_{kind}"] = errs
                worst["fwd"] = max(worst["fwd"], *(
                    errs[k][0] for k in ("loss_err", "lse_err")))
                worst["bwd"] = max(worst["bwd"], errs["dx_max_abs_err"])
        if wide_before != (fused.xent_fwd_launches_by_layout["wide"],
                           fused.xent_bwd_launches_by_layout["wide"]):
            raise AssertionError(f"xent at {name}'s shape took the wide "
                                 f"layout")
        # times: fp32 hard labels, all in [0, V) (F.cross_entropy asserts
        # on others), every 7th row ignored
        per_set = r * v * 4 + r * 8
        n_sets = max(1, math.ceil(XENT_COLD_BYTES / per_set))
        sets = []
        for _ in range(n_sets):
            x = torch.randn(r, v, generator=gen, device=device) * 2
            lab = torch.randint(0, v, (r,), generator=gen, device=device)
            lab[::7] = XENT_IGNORE
            _, lse, _ = fused.softmax_xent_fwd(x, lab, False, XENT_IGNORE)
            g1, g2 = fused.xent_bwd_coeffs(lab, None, torch.ones_like(lse),
                                           None, False, XENT_IGNORE)
            sets.append((x, lab, lse, g1, g2, x.detach().requires_grad_()))
        ones = torch.ones(r, device=device)

        def kernel_pair(x, lab, lse, g1, g2, xr):
            loss, _ = fused.SoftmaxXent.apply(xr, lab, False, XENT_IGNORE)
            return torch.autograd.grad(loss[:, 0], xr, ones)

        def library_pair(x, lab, lse, g1, g2, xr):
            loss = F.cross_entropy(xr, lab, reduction="none",
                                   ignore_index=XENT_IGNORE)
            return torch.autograd.grad(loss, xr, ones)

        t = {"fwd_ms": lambda x, lab, *_: fused.softmax_xent_fwd(
                 x, lab, False, XENT_IGNORE),
             "fwd_plain_ms": lambda x, lab, *_: fused.softmax_xent_fwd_ref(
                 x, lab, False, XENT_IGNORE),
             "fwd_library_ms": lambda x, lab, *_: F.cross_entropy(
                 x, lab, reduction="none", ignore_index=XENT_IGNORE),
             "bwd_ms": lambda x, lab, lse, g1, g2, _: fused.softmax_xent_bwd(
                 x, lab, lse, g1, g2, False),
             "bwd_plain_ms": lambda x, lab, lse, g1, g2, _:
                 fused.softmax_xent_bwd_ref(x, lab, lse, g1, g2, False),
             "fwd_bwd_pair_ms": kernel_pair,
             "library_fwd_bwd_pair_ms": library_pair}
        times = {k: rotating_graph_ms(fn, sets) for k, fn in t.items()}
        fwd_bound, fwd_by = xent_bound_ms(r, v, False, backward=False)
        bwd_bound, bwd_by = xent_bound_ms(r, v, False, backward=True)
        emit(f"kernel_xent_{name}", rows=r, classes=v, layout="narrow",
             atol=ATOL, rtol=RTOL, dx_atol=DX_ATOL, dx_ulps=XENT_DX_ULPS,
             bitwise_repeat=True, checks=checks, timing={
                 "method": "CUDA-graph replays", "input_sets": n_sets,
                 "bytes_per_set": per_set, "labels": "hard, fp32 logits"},
             **times, fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound)
        fwd_out[name] = {"shape": [r, v], "layout": "narrow",
                         "max_abs_err": worst["fwd"], "ms": times["fwd_ms"],
                         "plain_ms": times["fwd_plain_ms"],
                         "bound_ms": fwd_bound, "bound_by": fwd_by,
                         "library_ms": times["fwd_library_ms"]}
        bwd_out[name] = {"shape": [r, v], "layout": "narrow",
                         "max_abs_err": worst["bwd"], "ms": times["bwd_ms"],
                         "plain_ms": times["bwd_plain_ms"],
                         "bound_ms": bwd_bound, "bound_by": bwd_by,
                         "library_ms": None,
                         "fwd_bwd_pair_ms": times["fwd_bwd_pair_ms"],
                         "library_fwd_bwd_pair_ms":
                             times["library_fwd_bwd_pair_ms"]}
        del sets, x, ids, y
        torch.cuda.empty_cache()
    return fwd_out, bwd_out


XENT_PARTIAL_SHAPES = (("tp2_transformer", TRAIN_BATCH // 4 * TRAIN_LEN,
                        VOCAB // 2),
                       ("ssd", 64 * 1917, 21))


def xent_partial_bound_ms(r, v, soft, x_bytes, y_bytes=4):
    """The partials entry's bound: logits (and soft labels, or one int64
    label a row) read once, m, l, a (and b) written once a row; the
    forward's operations a logit (``xent_bound_ms``)."""
    elems = r * v
    nbytes = elems * x_bytes + (elems * y_bytes if soft else r * 8) \
        + (4 if soft else 3) * r * 4
    return bound_ms(nbytes, elems * (7 if soft else 4))


def phase_kernel_xent_partial():
    """The partials entry (``pta_xent_partial_*``, row 4 as the tp-sharded
    loss runs it) against its plain version: at the tp2 Transformer-base
    phase's shape, a rank's vocabulary slice of bf16 logits (4,096 x
    15,000: the wide layout) with fp32 soft labels and with hard labels
    shifted as a shard's are (some outside ``[0, V)``), and at SSD's
    122,688 x 21 fp32 (the narrow layout), hard and soft.  m, l, a, b
    within ``ATOL`` / ``RTOL``, two launches bitwise equal, the layout
    each took.  Times (kernel and plain, CUDA-graph replays over input sets
    of ``XENT_COLD_BYTES`` in all) and bounds for the labels the path runs
    (soft at the Transformer's shape, hard at SSD's).  Returns the kernels
    line's entry."""
    import math

    import torch

    from paddle_tpu_torch.ops import fused

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(29)
    worst, cases, timing = 0.0, {}, {}
    for name, r, v in XENT_PARTIAL_SHAPES:
        dtype = torch.bfloat16 if name == "tp2_transformer" \
            else torch.float32
        x = (torch.randn(r, v, generator=gen, device=device) * 2).to(dtype)
        y = torch.rand(r, v, generator=gen, device=device)
        y /= y.sum(-1, keepdim=True)
        # a shard's shifted labels: in [-v, 2v), a third of them its own
        lab = torch.randint(-v, 2 * v, (r,), generator=gen, device=device)
        for soft, labels in ((True, y), (False, lab)):
            kind = "soft" if soft else "hard"
            before = dict(fused.xent_partial_launches_by_layout)
            got = fused.softmax_xent_partial(x, labels, soft)
            again = fused.softmax_xent_partial(x, labels, soft)
            torch.cuda.synchronize()
            layout = next(k for k, c in fused.xent_partial_launches_by_layout
                          .items() if c != before[k])
            want = fused.softmax_xent_partial_ref(x, labels, soft)
            errs = {}
            for col, g, g2, w in zip("mlab", got, again, want):
                if w is None:
                    continue
                if not torch.equal(g, g2):
                    raise AssertionError(f"xent partials ({name}, {kind}): "
                                         f"{col} is not bitwise repeatable")
                if not bool((g - w).abs().le(ATOL + RTOL * w.abs()).all()):
                    raise AssertionError(
                        f"xent partials ({name}, {kind}): {col} disagrees "
                        f"with the plain version: max abs/rel err "
                        f"{_max_errs(g, w)}")
                errs[col] = _max_errs(g, w)
                worst = max(worst, errs[col][0])
            cases[f"{name}_{kind}"] = {"shape": [r, v],
                                       "dtype": str(dtype)[6:],
                                       "layout": layout, "errs": errs}
        soft = name == "tp2_transformer"
        per_set = r * v * (x.element_size() + (4 if soft else 0)) \
            + (0 if soft else r * 8)
        n_sets = max(1, math.ceil(XENT_COLD_BYTES / per_set))
        sets = [((torch.randn(r, v, generator=gen, device=device) * 2).to(
            dtype), y if soft else lab) for _ in range(n_sets)]
        timing[name] = {
            "labels": "soft fp32" if soft else "hard", "input_sets": n_sets,
            "ms": rotating_graph_ms(
                lambda a, b: fused.softmax_xent_partial(a, b, soft), sets),
            "plain_ms": rotating_graph_ms(
                lambda a, b: fused.softmax_xent_partial_ref(a, b, soft),
                sets),
            "bound_ms": xent_partial_bound_ms(r, v, soft,
                                              x.element_size())[0]}
        del x, y, lab, sets
        torch.cuda.empty_cache()
    emit("kernel_xent_partial", cases=cases, atol=ATOL, rtol=RTOL,
         bitwise_repeat=True, timing=timing,
         timing_method="CUDA-graph replays over cold input sets")
    main = timing["tp2_transformer"]
    r, v = XENT_PARTIAL_SHAPES[0][1:]
    return {"name": "softmax_xent_partial", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/softmax_xent.cu",
            "replaces": "paddle_tpu/ops/pallas_fused.py:221",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": xent_partial_bound_ms(r, v, True, 2)[1],
            "library_ms": None, "shape": [r, v], "dtype": "bfloat16",
            "by_model": {"ssd": timing["ssd"]}}


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


def trainable_shapes(main, want, names=None):
    """The shapes of ``main``'s trainable parameters (of those ``names``
    only, if given): one optimizer tensor each; raises unless there are
    ``want``."""
    shapes = [tuple(p.shape) for p in main.global_block().all_parameters()
              if p.trainable and (names is None or p.name in names)]
    if len(shapes) != want:
        raise AssertionError(f"{len(shapes)} trainable parameters, the path "
                             f"updates {want}")
    return shapes


def optimizer_at_model_shapes(kernel_phase, kernel, models):
    """``kernel_phase`` (:func:`phase_kernel_adam` or
    :func:`phase_kernel_momentum`) at each of ``models``' parameter shapes
    ``(name, main program, tensors its path updates[, their parameter
    names])``, a line each (``kernel_<kernel>_<name>``): the kernels-line
    numbers by model."""
    import torch

    out = {}
    for name, main, want, *names in models:
        entry = kernel_phase(trainable_shapes(main, want, *names),
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


def build_training(batch_len, dropout=None, flash=False, moe=0,
                   stacked=False, recompute=False, config=None):
    """Transformer-base (or ``config()``) as the training slice builds it
    (unfused attention, or every attention through the flash kernels with
    ``flash``; the config's dropout unless given), with ``moe`` experts in
    every FFN, or as the layer-stack ops with ``stacked`` (``recompute``
    its layers in the backward): (main, startup, avg_cost)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import transformer

    framework.fresh_session()
    cfg = (config or transformer.base_config)()
    cfg.flash_attention = flash
    if moe:
        cfg.name, cfg.moe_experts = f"moe_{cfg.name}", moe
    cfg.stacked, cfg.recompute = stacked, recompute
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
            "softmax_xent_partial": fused.xent_partial_launches,
            "softmax_xent_partial_bf16":
                fused.xent_partial_launches_by_dtype["bfloat16"],
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
    # the Transformer's 30,000-wide rows take the block-a-row layout
    counts.update(check_xent_layout(phase, "wide"))
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
    launch counts over its steps and the step's numbers."""
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
    stats = {"steady_step_ms": steady_ms,
             "images_per_s": RESNET_BATCH * 1e3 / steady_ms,
             "op_dispatches_per_step": op_dispatches(exe, main, loss, acc),
             "max_memory_allocated": peak}
    emit(phase, model="resnet50", batch=RESNET_BATCH,
         image_hw=224, classes=1000, steps=RESNET_STEPS, losses=losses,
         loss_fell=losses[-1] < losses[0], accuracies=accs,
         launches=counts, startup_s=startup_s, step_ms=step_ms,
         steady_step_ms=steady_ms, images_per_s=stats["images_per_s"],
         ops_per_step=len(main.global_block().ops),
         op_dispatches_per_step=stats["op_dispatches_per_step"],
         conv_tflop_per_step=conv_tflop,
         conv_bound_ms=conv_tflop / conv_peak * 1e15,
         max_memory_allocated=peak,
         **({"amp": {"dtype": "bfloat16", "keep_activations": True}}
            if amp else {}))
    if profile_run:
        profile_step(phase, lambda: exe.run(main, feed=feed,
                                            fetch_list=[loss], scope=scope),
                     {"conv": CONV_KEYS})
    return counts, stats


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
                         profile_run, loss_rtol, steps=WINDOW_STEPS):
    """``steps`` x 2 Executor.run steps on the card against two
    ``run_steps(n_steps=steps)`` windows of one executor from the
    same state (a copy of the scope, generators included; the first
    window runs a step, captures the next and replays).  ``feed`` is one
    feed for every step, or a list of one a step (the windows take theirs
    stacked, with ``feed_per_step``).  The last step's
    fetches and every state tensor bitwise, or else the fetched loss
    (``fetches[0]``) within ``loss_rtol`` relative at each window's end,
    the worst difference printed; the other fetches (dropout masks, drawn
    from the generators alone) bitwise.  The windows' launches must be ``per_step`` x
    steps.  Prints the graphed and the eager step's device ms (CUDA
    events around ``steps`` steps), the capture's time and the graph pool's
    bytes; with ``profile_run`` a profiled third window.  Returns
    (executor, window scope, numbers)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    main, startup = progs
    n = steps
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
    first (``feed`` one feed for every step, or a list of one a step):
    each step's fetches, its host-clocked ms (to a synchronize) and its
    device ms (CUDA events around it), and the launches over them."""
    import torch

    feeds = feed if isinstance(feed, list) else [feed] * steps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    reset_launch_counts()
    out, host_ms, device_ms = [], [], []
    for step in range(steps):
        t0 = time.perf_counter()
        start.record()
        out.append(exe.run(main, feed=feeds[step], fetch_list=fetches,
                           scope=scope))
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


def bert_clip_programs(fluid, bert, cfg, seq_len, n_mask, lr,
                       clip_norm=BERT_CLIP_NORM, seed=1):
    """``bert.forward`` in ``fluid`` (either package) with every gradient
    clipped to a global norm of ``clip_norm`` and Adam(``lr``): (main,
    startup, names) with ``names`` the total / MLM / NSP losses, the group
    norm (the ``sqrt`` op's output), the group scale, the raw grads
    (``grads``) and the clipped ones the adam ops read (``clipped``)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        outs = bert.forward(cfg, seq_len, n_mask)
        clip = fluid.clip.GradientClipByGlobalNorm(clip_norm=clip_norm)
        fluid.clip.set_gradient_clip(clip)
        fluid.optimizer.Adam(learning_rate=lr).minimize(outs[5])
    ops = main.global_block().ops
    names = {"loss": outs[5].name, "mlm": outs[6].name, "nsp": outs[7].name,
             "norm": next(op for op in ops
                          if op.type == "sqrt").output("Out")[0],
             "scale": clip.context["default_group_scale"].name,
             "grads": [op.input("Param")[0] + "@GRAD" for op in ops
                       if op.type == "adam"],
             "clipped": [op.input("Grad")[0] for op in ops
                         if op.type == "adam"]}
    return main, startup, names


def clip_mlp_programs(fluid, kind, lr=0.1):
    """A small MLP (16 -> fc 32 relu -> fc 4, mean squared error, SGD) in
    ``fluid`` (either package) under one kind of clipping
    (``CLIP_BOUNDS``): ``global_norm``, ``norm`` or ``value`` clip every
    grad, ``error`` the hidden layer's grad (``ErrorClipByValue``),
    ``l1_decay`` is ``SGD(regularization=L1Decay)``.  Returns (main,
    startup, names): the loss, the grads the updates read, the hidden
    grad, and for ``global_norm`` the group norm and scale."""
    bound = CLIP_BOUNDS[kind]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        y = fluid.layers.data("y", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(h, 4), y))
        clip = {"global_norm": fluid.clip.GradientClipByGlobalNorm,
                "norm": fluid.clip.GradientClipByNorm,
                "value": fluid.clip.GradientClipByValue}.get(kind)
        if clip is not None:
            clip = clip(bound)
            fluid.clip.set_gradient_clip(clip)
        if kind == "error":
            h.error_clip = fluid.clip.ErrorClipByValue(bound)
        reg = fluid.regularizer.L1Decay(bound) if kind == "l1_decay" else None
        _, params_grads = fluid.optimizer.SGD(
            learning_rate=lr, regularization=reg).minimize(loss)
    names = {"loss": loss.name, "grads": [g.name for _, g in params_grads],
             "hidden_grad": h.name + "@GRAD"}
    if kind == "global_norm":
        names["norm"] = next(op for op in main.global_block().ops
                             if op.type == "sqrt").output("Out")[0]
        names["scale"] = clip.context["default_group_scale"].name
    return main, startup, names


def clip_mlp_feed(seed=6, batch=8):
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"x": rng.standard_normal((batch, 16)).astype(np.float32),
            "y": 3 * rng.standard_normal((batch, 4)).astype(np.float32)}


def clip_active(kind, names, fetched):
    """Whether the step's clip changed anything, from its fetches (a dict
    by name): the group scale below 1; a grad at the norm bound; a grad
    element at the value bound; the hidden grad at the error bound; L1
    decay always acts."""
    import numpy as np

    bound = CLIP_BOUNDS[kind]
    if kind == "global_norm":
        return float(np.asarray(fetched[names["scale"]]).reshape(-1)[0]) < 1
    if kind == "norm":
        return any(abs(float(np.linalg.norm(fetched[g])) - bound)
                   <= 1e-5 * bound for g in names["grads"])
    if kind == "value":
        return any(bool((np.abs(fetched[g]) == np.float32(bound)).any())
                   for g in names["grads"])
    if kind == "error":
        return bool((np.abs(fetched[names["hidden_grad"]])
                     == np.float32(bound)).any())
    return True


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
    ``AMP_PARITY_RTOL``.  Returns the launch counts and the step's
    numbers (for ``train_bert_clip_amp`` to print beside its own)."""
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
        # the copy lives on the card through the steps (for the plain
        # Adam's run below): its bytes are part of this phase's peak
        init_bytes = sum(t.numel() * t.element_size()
                         for t in init._values.values()
                         if isinstance(t, torch.Tensor))
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
        peak = torch.cuda.max_memory_allocated()
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
        stats = {"steady_step_ms": step_ms,
                 "host_steady_step_ms": sum(host_ms[1:]) / len(host_ms[1:]),
                 "tokens_per_s": BERT_BATCH * BERT_LEN * 1e3 / step_ms,
                 "ops_per_step": len(main.global_block().ops),
                 "op_dispatches_per_step": op_dispatches(exe, main, loss,
                                                         *heads),
                 "max_memory_allocated": peak,
                 "init_copy_bytes": init_bytes}
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
             max_memory_allocated=peak)
        if profile_run:
            profile_step("train_bert_amp", lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope),
                {"gemm": GEMM_KEYS, "flash": ("flash_",)})
    return counts, stats


def phase_train_bert_clip_amp(beside, profile_run=False):
    """BERT-base pretraining as ``train_bert_amp`` (bf16 with kept
    activations, the flash kernels, batch 32 x 128, Adam 1e-4,
    ``synthetic_batch`` from ``RandomState(0)``) with every gradient
    clipped to a global norm of ``BERT_CLIP_NORM`` (Google BERT's
    recipe): ``BERT_STEPS`` ``Executor.run`` steps fetching the losses,
    the group norm and the group scale: finite losses, the same flash
    launches as ``train_bert_amp`` and exactly one Adam launch for
    ``BERT_ADAM_TENSORS`` tensors a step (the clip ops must not split the
    run of adam ops), the scale ``clip / max(clip, norm)`` each step and
    whether it clipped; then one more step fetching the 159 raw fp32
    grads and the clipped ones: the group norm within
    ``BERT_CLIP_NORM_RTOL`` of ``torch.linalg.vector_norm`` over the raw
    grads, and the clipped grads' norm that times the scale.  Op
    dispatches, step ms (events and host clock), tokens/s and peak
    allocated, beside ``train_bert_amp``'s (``beside``); with
    ``profile_run`` a profile of one more step.  Returns the launch
    counts."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import bert

    cfg = bert.base_config()
    cfg.flash_attention = True
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        framework.fresh_session()
        main, startup, names = bert_clip_programs(
            fluid, bert, cfg, BERT_LEN, BERT_MASK, 1e-4)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = bert.synthetic_batch(cfg, BERT_BATCH, BERT_LEN, BERT_MASK,
                                    np.random.RandomState(0))
        torch.cuda.reset_peak_memory_stats()
        fetches = [names[k] for k in ("loss", "mlm", "nsp", "norm", "scale")]
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feed, fetches, scope, BERT_STEPS)
        losses, mlm, nsp, norms, scales = (
            [float(o[i].reshape(-1)[0]) for o in out] for i in range(5))
        check_launches("train_bert_clip_amp", counts, {
            "flash_fwd": BERT_FLASH_FWD_PER_STEP,
            "flash_fwd_bf16": BERT_FLASH_FWD_PER_STEP,
            "flash_dq": BERT_FLASH_BWD_PER_STEP,
            "flash_dq_bf16": BERT_FLASH_BWD_PER_STEP,
            "flash_dkv": BERT_FLASH_BWD_PER_STEP,
            "flash_dkv_bf16": BERT_FLASH_BWD_PER_STEP,
            "adam": ADAM_PER_STEP, "adam_tensors": BERT_ADAM_TENSORS},
            BERT_STEPS)
        if len(names["grads"]) != BERT_ADAM_TENSORS:
            raise AssertionError(f"train_bert_clip_amp: "
                                 f"{len(names['grads'])} adam ops")
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"non-finite clipped BERT loss or norm: "
                                 f"{losses}, {norms}")
        want = [BERT_CLIP_NORM / max(BERT_CLIP_NORM, n) for n in norms]
        if not np.allclose(scales, want, rtol=1e-6, atol=0):
            raise AssertionError(f"train_bert_clip_amp: group scales "
                                 f"{scales}, expected {want} from the "
                                 f"norms {norms}")
        steady = device_ms[1:]
        step_ms = sum(steady) / len(steady)
        stats = {"steady_step_ms": step_ms,
                 "host_steady_step_ms": sum(host_ms[1:]) / len(host_ms[1:]),
                 "tokens_per_s": BERT_BATCH * BERT_LEN * 1e3 / step_ms,
                 "ops_per_step": len(main.global_block().ops),
                 "op_dispatches_per_step": op_dispatches(exe, main,
                                                         *fetches),
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}
        # one more step with the raw and the clipped grads fetched: the
        # group norm is the norm of the raw ones, the clipped ones' norm
        # that times the scale
        n = len(names["grads"])
        grads = exe.run(main, feed=feed, fetch_list=fetches[3:]
                        + names["grads"] + names["clipped"], scope=scope,
                        return_numpy=False)
        norm, scale = (float(v.reshape(-1)[0]) for v in grads[:2])
        raw, clipped = grads[2:2 + n], grads[2 + n:]
        if any(g.dtype != torch.float32 for g in raw + clipped):
            raise AssertionError("train_bert_clip_amp: a grad is not fp32")
        want_norm, clipped_norm = (float(torch.linalg.vector_norm(torch.cat(
            [g.reshape(-1) for g in gs]))) for gs in (raw, clipped))
        norm_rel = abs(norm - want_norm) / want_norm
        clipped_rel = abs(clipped_norm - norm * scale) / (norm * scale)
        if not max(norm_rel, clipped_rel) <= BERT_CLIP_NORM_RTOL:
            raise AssertionError(
                f"train_bert_clip_amp: group norm {norm} against "
                f"torch.linalg.vector_norm's {want_norm} (rel {norm_rel}); "
                f"clipped grads' norm {clipped_norm} against norm x scale "
                f"{norm * scale} (rel {clipped_rel})")
        del grads, raw, clipped
    diff = {k: stats[k] - beside[k] for k in
            ("steady_step_ms", "host_steady_step_ms", "ops_per_step",
             "op_dispatches_per_step")}
    # train_bert_amp's peak holds a copy of its initial state; this one's
    # does not
    diff["max_memory_allocated"] = stats["max_memory_allocated"] - (
        beside["max_memory_allocated"] - beside["init_copy_bytes"])
    emit("train_bert_clip_amp", model="bert_base", batch=BERT_BATCH,
         seq_len=BERT_LEN, n_mask=BERT_MASK, steps=BERT_STEPS,
         amp={"dtype": "bfloat16", "keep_activations": True},
         clip={"kind": "GradientClipByGlobalNorm", "clip_norm":
               BERT_CLIP_NORM}, losses=losses, mlm_losses=mlm,
         nsp_losses=nsp, group_norms=norms, group_scales=scales,
         clipped=[s < 1.0 for s in scales],
         norm_check={"group_norm": norm, "vector_norm": want_norm,
                     "rel_err": norm_rel, "group_scale": scale,
                     "clipped_vector_norm": clipped_norm,
                     "clipped_rel_err": clipped_rel,
                     "rtol": BERT_CLIP_NORM_RTOL, "grads": n},
         launches=counts, host_step_ms=host_ms, device_step_ms=device_ms,
         **stats, masked_tokens_per_s=BERT_BATCH * BERT_MASK * 1e3 / step_ms,
         train_bert_amp=beside, minus_train_bert_amp=diff)
    if profile_run:
        with fluid.amp.amp_guard("bfloat16", keep_activations=True):
            profile_step("train_bert_clip_amp", lambda: exe.run(
                main, feed=feed, fetch_list=[names["loss"]], scope=scope),
                {"gemm": GEMM_KEYS, "flash": ("flash_",)})
    return counts


# ops_tranche5_parity: the one-line ops at full-width shapes (BERT-base's
# FFN activation and hidden states, its MLM logits and vocabulary, SSD's
# 19 x 19 map of 512 channels at batch 64), card against CPU.  fp32
# elementwise within (rtol, atol) (1e-5, 1e-6); sums (reductions, cumsum,
# dot, clip_by_norm, log_softmax, the resizes) within SEQ_PARITY_TOL, its
# atol of the tensor's largest magnitude (a dot over 3,072 terms of ~4
# that cancels to near 0 keeps their rounding: 1.2e-4 apart on one element
# of ~700 at most); integer and bool outputs and argsort equal
OPS_FFN, OPS_HIDDEN, OPS_LOGITS = (32, 128, 3072), (32, 128, 768), (512, 30522)
OPS_VOCAB, OPS_SCATTER_IDS, OPS_MAP = 30522, 4096, (64, 512, 19, 19)
ELEMENTWISE_TOL = (1e-5, 1e-6)  # (rtol, atol)
# ops of the tranche with no grad (their inputs are no-grad in both
# packages, or their outputs integer or bool)
NO_GRAD_OPS = ("argsort", "arg_max", "arg_min", "shape", "isfinite",
               "has_inf", "has_nan")


def tranche5_inputs(rng):
    """The full-width inputs of ``tranche5_groups`` from ``rng`` (a numpy
    ``Generator``), by key: (array, whether its grad is checked).  Normal inputs carry exact bounds,
    zeros and ties at their first elements."""
    import numpy as np

    def normal(shape, scale=2.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    ffn = normal(OPS_FFN)
    # 0, a relu6 / brelu bound, clip's and the shrinks' bounds, hard
    # sigmoid's exact bounds at slope 0.25, thresholded_relu's threshold,
    # halves for round
    ffn.reshape(-1)[:12] = [0.0, -0.0, 6.0, 4.0, 0.5, -0.5, 2.0, -2.0,
                            1.0, 1.5, 2.5, -1.5]
    tied = ffn.copy()
    tied.reshape(-1)[1::2] = np.round(tied.reshape(-1)[1::2])
    other = np.round(normal(OPS_FFN))  # ties with ``tied`` half the time
    other.reshape(-1)[:12] = ffn.reshape(-1)[:12]
    positive = np.abs(normal(OPS_FFN)) + 0.1
    divisor = np.where(np.abs(other) < 1, 3.0, other).astype(np.float32)
    with_inf, with_nan = ffn.copy(), ffn.copy()
    with_inf.reshape(-1)[17] = np.inf
    with_nan.reshape(-1)[17] = np.nan
    hidden = normal(OPS_HIDDEN)
    hidden.reshape(-1)[:4] = hidden.reshape(-1)[4:8]  # ties for max / min
    near_one = 1 + normal(OPS_HIDDEN, 0.02)
    logits = normal(OPS_LOGITS)
    # ties for the stable sort: values to 2 decimals
    sort_keys = np.round(normal((max(1, OPS_LOGITS[0] // 16), OPS_VOCAB)),
                         2)
    image = normal(OPS_MAP)
    ids = rng.permutation(OPS_VOCAB)[:OPS_SCATTER_IDS].astype(np.int64)
    b, t, d = OPS_HIDDEN
    return {
        "ffn": (ffn, True), "tied": (tied, True), "other": (other, True),
        "positive": (positive, True), "divisor": (divisor, True),
        "with_inf": (with_inf, False), "with_nan": (with_nan, False),
        "alpha": (rng.uniform(0.05, 0.5, (OPS_FFN[1],)).astype(np.float32),
                  True),
        "hidden": (hidden, True), "near_one": (near_one, True),
        "hidden_b": (normal(OPS_HIDDEN), True),
        "hidden_c": (normal(OPS_HIDDEN), True),
        "hidden_1": (normal(OPS_HIDDEN[:2] + (1,)), True),
        "hidden_u": (normal(OPS_HIDDEN[:2] + (1, OPS_HIDDEN[2])), True),
        "hidden_cut": (normal((b, t - 1, d - 8)), True),
        "cond": (rng.random(OPS_HIDDEN) > 0.5, False),
        "rows": (normal((OPS_SCATTER_IDS, d)), True),
        "rows_b": (normal((OPS_SCATTER_IDS, d)), True),
        "rows_c": (normal((OPS_SCATTER_IDS, d)), True),
        "row_ids": (rng.integers(0, 3, (OPS_SCATTER_IDS, 1), dtype=np.int32),
                    False),
        "logits": (logits, True), "sort_keys": (sort_keys, False),
        "image": (image, True), "table": (normal((OPS_VOCAB, d)), True),
        "ids": (ids, False), "updates": (normal((OPS_SCATTER_IDS, d)), True),
        "stackable": (normal((3, t, d)), True),
    }


def tranche5_groups():
    """The ops of ``ops_tranche5_parity``: groups of (op type, {slot: [input
    key, ...]}, attrs, {output slot: count}), a Program each, with the
    group's tolerance (rtol, atol) and whether its atol is of each
    tensor's largest magnitude (``compare_on_card``' ``of_largest``)."""
    def u(op, key="ffn", **attrs):
        return (op, {"X": [key]}, attrs, {"Out": 1})

    unary = [u(op) for op in (
        "abs", "round", "sin", "softplus", "softsign", "softshrink", "gelu",
        "logsigmoid", "tanh_shrink", "sign", "swish", "elu", "leaky_relu",
        "stanh")] + [
        u("relu6", threshold=6.0), u("brelu", t_min=0.0, t_max=4.0),
        u("hard_sigmoid", slope=0.25, offset=0.5),
        u("hard_shrink", threshold=0.5), u("thresholded_relu", threshold=1.0),
        u("soft_relu", threshold=2.0), u("clip", min=-0.5, max=0.5),
        u("pow", factor=2.0), u("sqrt", "positive"), u("rsqrt", "positive"),
        u("reciprocal", "positive"), u("pow", "positive", factor=2.5),
        ("prelu", {"X": ["ffn"], "Alpha": ["alpha"]}, {"mode": "channel"},
         {"Out": 1})]
    binary = [
        (op, {"X": ["tied"], "Y": [y]}, {}, {"Out": 1})
        for op, y in (("maximum", "other"), ("minimum", "other"),
                      ("elementwise_mod", "divisor"),
                      ("elementwise_floordiv", "divisor"))] + [
        (op, {"X": [x]}, {}, {"Out": 1})
        for op in ("isfinite", "has_inf", "has_nan")
        for x in ("ffn", "with_inf", "with_nan")]
    sums = [
        ("dot", {"X": ["ffn"], "Y": ["other"]}, {}, {"Out": 1}),
        ("clip_by_norm", {"X": ["ffn"]}, {"max_norm": 1000.0}, {"Out": 1}),
        ("log_softmax", {"X": ["logits"]}, {"axis": -1}, {"Out": 1}),
        ("reduce_max", {"X": ["hidden"]}, {"dim": [-1]}, {"Out": 1}),
        ("reduce_min", {"X": ["hidden"]}, {"reduce_all": True}, {"Out": 1}),
        ("reduce_prod", {"X": ["near_one"]}, {"dim": [1]}, {"Out": 1}),
        ("cumsum", {"X": ["hidden"]}, {"axis": -1}, {"Out": 1}),
        ("cumsum", {"X": ["hidden_b"]}, {"axis": 1, "exclusive": True,
                                          "reverse": True}, {"Out": 1}),
        ("arg_max", {"X": ["hidden"]}, {"axis": -1}, {"Out": 1}),
        ("arg_min", {"X": ["hidden"]}, {"axis": 1}, {"Out": 1}),
        ("argsort", {"X": ["sort_keys"]}, {"axis": -1},
         {"Out": 1, "Indices": 1})]
    n, c, h, w = OPS_MAP
    image = [
        ("bilinear_interp", {"X": ["image"]}, {"out_h": 38, "out_w": 38},
         {"Out": 1}),
        ("bilinear_interp", {"X": ["image"]}, {"out_h": 10, "out_w": 10},
         {"Out": 1}),
        ("nearest_interp", {"X": ["image"]}, {"out_h": 38, "out_w": 38},
         {"Out": 1}),
        ("nearest_interp", {"X": ["image"]}, {"out_h": 10, "out_w": 10},
         {"Out": 1})]
    layout = [
        ("pad2d", {"X": ["image"]}, {"paddings": [1, 2, 2, 1], "mode": mode,
                                     "pad_value": 0.5}, {"Out": 1})
        for mode in ("constant", "reflect", "edge")] + [
        ("crop", {"X": ["image"]}, {"offsets": [0, 0, 1, 2],
                                    "shape": [n, c, h - 2, w - 3]},
         {"Out": 1}),
        ("scatter", {"X": ["table"], "Ids": ["ids"], "Updates": ["updates"]},
         {"overwrite": True}, {"Out": 1}),
        ("scatter", {"X": ["table"], "Ids": ["ids"], "Updates": ["updates"]},
         {"overwrite": False}, {"Out": 1}),
        ("reshape2", {"X": ["hidden"]}, {"shape": [0, 0, 12, -1]},
         {"Out": 1, "XShape": 1}),
        ("transpose2", {"X": ["hidden"]}, {"axis": [0, 2, 1]},
         {"Out": 1, "XShape": 1}),
        ("squeeze", {"X": ["hidden_u"]}, {"axes": [2]}, {"Out": 1}),
        ("unsqueeze", {"X": ["hidden"]}, {"axes": [2]}, {"Out": 1}),
        ("stack", {"X": ["hidden", "hidden_b", "hidden_c"]}, {"axis": 1},
         {"Y": 1}),
        ("unstack", {"X": ["stackable"]}, {"axis": 0}, {"Y": 3}),
        ("expand", {"X": ["hidden"]}, {"expand_times": [2, 1, 1]},
         {"Out": 1}),
        ("expand_as", {"X": ["hidden_1"], "Y": ["hidden_b"]}, {}, {"Out": 1}),
        ("tile", {"X": ["hidden_1"]}, {"repeat_times": [1, 1,
                                                        OPS_HIDDEN[2]]},
         {"Out": 1}),
        ("pad", {"X": ["hidden"]}, {"paddings": [0, 0, 1, 2, 3, 0],
                                    "pad_value": -1.0}, {"Out": 1}),
        ("pad_constant_like", {"X": ["hidden"], "Y": ["hidden_cut"]},
         {"pad_value": 0.5}, {"Out": 1}),
        ("reverse", {"X": ["hidden"]}, {"axis": [1, 2]}, {"Out": 1}),
        ("shape", {"Input": ["hidden"]}, {}, {"Out": 1}),
        ("multiplex", {"X": ["rows", "rows_b", "rows_c"], "Ids": ["row_ids"]},
         {}, {"Out": 1}),
        ("where", {"Condition": ["cond"], "X": ["hidden"],
                   "Y": ["hidden_b"]}, {}, {"Out": 1})]
    return [("unary", unary, ELEMENTWISE_TOL, False),
            ("binary", binary, ELEMENTWISE_TOL, False),
            ("sums", sums, SEQ_PARITY_TOL, True),
            ("image", image, SEQ_PARITY_TOL, True),
            ("layout", layout, ELEMENTWISE_TOL, False)]


def op_group_program(fluid, specs, inputs):
    """One Program running each op of ``specs`` on its own copies of its
    inputs (fed as ``<op index>_<key>``), then ``append_backward`` of the
    sum over every float output (not ``XShape``, nor the integer ``Mask``)
    of ``reduce_sum(out * out)``: (main,
    startup, feed keys by name, the outputs' names, the checked grads'
    names)."""
    main, startup = fluid.Program(), fluid.Program()
    feeds, outs, grads, total = {}, [], [], None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()
        for i, (op_type, slots, attrs, out_slots) in enumerate(specs):
            names, diff = {}, False
            for slot, keys in slots.items():
                names[slot] = []
                for key in keys:
                    arr, wants = inputs[key]
                    wants = wants and op_type not in NO_GRAD_OPS
                    name = f"{i}_{key}"
                    if name not in feeds:
                        block.create_var(name=name, shape=arr.shape,
                                         dtype=str(arr.dtype), is_data=True,
                                         stop_gradient=not wants)
                        feeds[name] = key
                        if wants:
                            grads.append(name + "@GRAD")
                    names[slot].append(name)
                    diff = diff or wants
            onames = {slot: [f"{i}_{op_type}_{slot}_{j}" for j in range(n)]
                      for slot, n in out_slots.items()}
            for slot, ns in onames.items():
                for n in ns:
                    block.create_var(name=n, dtype="float32")
            block.append_op(type=op_type, inputs=names, outputs=onames,
                            attrs=dict(attrs))
            for slot, ns in onames.items():
                outs += ns
                if not diff or slot in ("XShape", "Mask"):
                    continue
                for n in ns:
                    v = block.var(n)
                    part = fluid.layers.reduce_sum(
                        fluid.layers.elementwise_mul(v, v))
                    total = part if total is None else \
                        fluid.layers.elementwise_add(total, part)
        if total is not None:
            fluid.append_backward(total)
    return main, startup, feeds, outs, grads


def compare_on_card(phase, names, cpu, card, tol, of_largest):
    """The CPU's fetches against the card's, compared on the card in
    float64: dtypes and shapes equal, floats within ``tol`` (rtol, atol;
    with ``of_largest`` the atol of each tensor's largest magnitude, at
    least 1), integers and bools exactly.  Returns the largest
    difference."""
    import torch

    rtol, atol = tol
    worst = 0.0
    for name, c, g in zip(names, cpu, card):
        c = c.to(g.device)
        if c.dtype != g.dtype or c.shape != g.shape:
            raise AssertionError(f"{phase}: {name} on the card is {g.dtype} "
                                 f"{tuple(g.shape)}, on the CPU {c.dtype} "
                                 f"{tuple(c.shape)}")
        if not c.is_floating_point():
            if not torch.equal(c, g):
                raise AssertionError(f"{phase}: {name} differs on the card")
            continue
        if not c.numel():
            continue
        c, g = c.double(), g.double()
        err = (g - c).abs()
        scale = max(1.0, float(c.abs().max())) if of_largest else 1.0
        if not bool((err <= atol * scale + rtol * c.abs()).all()):
            raise AssertionError(f"{phase}: {name} on the card is "
                                 f"{float(err.max())} from the CPU's")
        worst = max(worst, float(err.max()))
    return worst


def phase_ops_tranche5_parity():
    """Every one of the 63 one-line activation, math, reduce and shape op
    types at full-width shapes (``tranche5_groups``), forward and grad
    (where it has one), on the card against the port's CPU path, one
    Program a group run once on each place: every output and input grad
    within the group's tolerance, integer and bool outputs equal
    (``compare_on_card``).  The inputs hold exact bounds and ties, so the
    tie rules (half the grad at a clip bound, a tied maximum's grad
    split, abs' grad 1 at 0, stable argsort) hold on the card too."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework

    t0 = time.perf_counter()
    inputs = tranche5_inputs(np.random.default_rng(21))
    inputs_s = time.perf_counter() - t0
    covered, result = set(), {}
    for group, specs, tol, of_largest in tranche5_groups():
        framework.fresh_session()
        main, startup, feeds, outs, grads = op_group_program(fluid, specs,
                                                             inputs)
        feed = {n: inputs[k][0] for n, k in feeds.items()}
        runs, secs = [], {}
        for tag, place in (("cpu", fluid.CPUPlace()),
                           ("card", fluid.CUDAPlace(0))):
            t1 = time.perf_counter()
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            runs.append(exe.run(main, feed=feed, fetch_list=outs + grads,
                                scope=scope, return_numpy=False))
            torch.cuda.synchronize()
            secs[f"{tag}_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        worst = compare_on_card(f"ops_tranche5_parity {group}", outs + grads,
                                *runs, tol, of_largest)
        secs["compare_s"] = time.perf_counter() - t1
        covered |= {spec[0] for spec in specs}
        result[group] = {"ops": len(specs), "fetches": len(outs + grads),
                         "tol": list(tol), "atol_of_largest": of_largest,
                         "max_abs_err": worst, **secs}
        del feed, runs
    emit("ops_tranche5_parity", op_types=len(covered), groups=result,
         torch_threads=torch.get_num_threads(), inputs_s=inputs_s,
         seconds=time.perf_counter() - t0)
    return covered


def place_steps(progs, feed, fetches, steps, places):
    """``steps`` steps of ``progs`` (main, startup) on each place from the
    first place's initial state (``feed`` one feed for every step, or a
    list of one a step): each place's fetches ``[places][steps]
    [fetches]`` as float64 arrays, the launches of the last place's steps,
    and each place's scope."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.params import load_reference_params

    main, startup = progs[:2]
    runs = []
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append((exe, scope, place))
    init = {v.name: runs[0][1].get(v.name).detach().cpu().numpy()
            for v in startup.list_vars() if v.persistable}
    for _, scope, place in runs[1:]:
        load_reference_params(scope, init, place)
    feeds = feed if isinstance(feed, list) else [feed] * steps
    out = []
    for i, (exe, scope, _) in enumerate(runs):
        if i == len(runs) - 1:
            reset_launch_counts()
        out.append([[np.asarray(v, np.float64) for v in exe.run(
            main, feed=feeds[k], fetch_list=fetches, scope=scope)]
            for k in range(steps)])
    return out, launch_counts(), [r[1] for r in runs]


def phase_train_bert_clip_parity():
    """Card against CPU (the plain versions) under clipping, fp32, from one
    initial state: ``tiny_config`` BERT through the flash kernels at batch
    2 x 32 (padded keys in one row) under global-norm clipping at
    ``BERT_CLIP_NORM``, 3 steps: losses, group norms and scales within
    rtol 1e-5 at step 0 and 1e-4 after, the scale below 1 (clipping) on
    some step, one Adam launch a step; then ``clip_mlp_programs``' MLP
    under each kind (global norm, norm, value, error clip, L1 decay), 5
    SGD steps: losses (and the group norm and scale) at the same
    tolerances, and the clip acting on the card on some step
    (``clip_active``)."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import bert

    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    cfg = bert.tiny_config()
    cfg.flash_attention = True
    framework.fresh_session()
    progs = bert_clip_programs(fluid, bert, cfg, 32, 4, 1e-3)
    names = progs[2]
    feed = bert.synthetic_batch(cfg, 2, 32, 4, np.random.RandomState(3))
    feed["src_ids"][1, -5:] = 0
    keys = ("loss", "norm", "scale")
    (cpu, card), counts, _ = place_steps(progs, feed,
                                         [names[k] for k in keys], 3, places)
    cpu, card = (np.array([[v.reshape(-1)[0] for v in step] for step in run])
                 for run in (cpu, card))
    tol = np.array([1e-5, 1e-4, 1e-4])[:, None]
    rel = check_parity("train_bert_clip_parity", cpu, card, tol)
    if not (card[:, 2] < 1).any():
        raise AssertionError(f"train_bert_clip_parity: the clip never "
                             f"acted (scales {card[:, 2].tolist()})")
    if counts["adam"] != 3 or counts["flash_fwd"] != 3 * 2 * cfg.n_layer:
        raise AssertionError(f"train_bert_clip_parity: the card's run "
                             f"launched {counts}")
    result = {"bert_tiny": {
        **{f"cpu_{k}es" if k == "loss" else f"cpu_{k}s": cpu[:, i].tolist()
           for i, k in enumerate(keys)},
        **{f"card_{k}es" if k == "loss" else f"card_{k}s":
           card[:, i].tolist() for i, k in enumerate(keys)},
        "rel_err": rel, "launches": counts}}
    tol = np.array([1e-5] + [1e-4] * 4)[:, None]
    for kind in sorted(CLIP_BOUNDS):
        framework.fresh_session()
        progs = clip_mlp_programs(fluid, kind)
        names = progs[2]
        keys = ["loss"] + [k for k in ("norm", "scale") if k in names]
        fetches = [names[k] for k in keys] + [names["hidden_grad"]] + \
            names["grads"]
        (cpu, card), _, _ = place_steps(progs, clip_mlp_feed(), fetches, 5,
                                        places)
        active = [clip_active(kind, names, dict(zip(fetches, step)))
                  for step in card]
        if not any(active):
            raise AssertionError(f"train_bert_clip_parity: {kind} clip "
                                 f"never acted on the card")
        cpu_l = np.array([[float(v.reshape(-1)[0]) for v in step[:len(keys)]]
                          for step in cpu])
        card_l = np.array([[float(v.reshape(-1)[0])
                            for v in step[:len(keys)]] for step in card])
        result[kind] = {"cpu_losses": cpu_l[:, 0].tolist(),
                        "card_losses": card_l[:, 0].tolist(),
                        "rel_err": check_parity(
                            f"train_bert_clip_parity {kind}", cpu_l, card_l,
                            tol),
                        "clip_active": active, "bound": CLIP_BOUNDS[kind]}
    emit("train_bert_clip_parity", rtol=[1e-5, 1e-4], **result)


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

    runs, counts, scopes = place_steps(progs, feed, [progs[2]], steps, places)
    return (np.array([[step[0].reshape(-1)[0] for step in run]
                      for run in runs]), counts, scopes)


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


def build_stacked_lstm(cfg=None, lr=LSTM_LR):
    """``stacked_lstm.build`` (``fluid_benchmark.py``'s
    stacked_dynamic_lstm) with Adam: (main, startup, loss), at the
    accelerator widths unless ``cfg`` names others."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import stacked_lstm

    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    cfg = cfg or dict(dict_dim=LSTM_DICT, emb_dim=LSTM_HID,
                      hid_dim=LSTM_HID, stacked_num=LSTM_STACKED)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = stacked_lstm.build(lr=lr, **cfg)[3]
    return main, startup, loss


def lstm_feed(rng, lens, dict_dim=None):
    """``fluid_benchmark.py``'s stacked-LSTM feed: word ids (below
    ``dict_dim``, default ``LSTM_DICT``) as a LoDTensor of ``lens``,
    labels in {0, 1}."""
    import numpy as np

    from paddle_tpu_torch import fluid

    words = rng.randint(0, dict_dim or LSTM_DICT,
                        size=(sum(lens), 1)).astype(np.int64)
    return {"words": fluid.create_lod_tensor(words, [list(lens)]),
            "label": rng.randint(0, 2, size=(len(lens), 1)).astype(
                np.int64)}


def phase_train_stacked_lstm(profile_run=False):
    """The stacked dynamic LSTM at ``fluid_benchmark.py``'s accelerator
    widths (70 ops, 18 parameters) through ``Executor.run`` on the card:
    ``LSTM_STEPS`` steps on fresh fixed-bucket batches (32 x 64 words),
    then as many on fresh ragged batches (32 sequences of 16-64 words):
    finite losses, exactly one Adam launch for 18 tensors a step and no
    other kernel's; words/s and step ms by CUDA events and by the host
    clock, op dispatches a step, peak allocated; with ``--profile`` one
    more step under the profiler (busy share, device events, GEMMs) and
    the host's Python profile of a step.  Returns the launches."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    main, startup, loss = build_stacked_lstm()
    params = trainable_shapes(main, LSTM_ADAM_TENSORS)
    ops = len(main.global_block().ops)
    values = sum(int(np.prod(s)) for s in params)
    if (ops, values) != (LSTM_OPS, LSTM_VALUES):
        raise AssertionError(f"train_stacked_lstm: {ops} ops and {values} "
                             f"parameter values, the reference builds "
                             f"{LSTM_OPS} and {LSTM_VALUES}")
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    lo, hi = LSTM_RAGGED
    runs = {"fixed": [lstm_feed(rng, [LSTM_LEN] * LSTM_BATCH)
                      for _ in range(LSTM_STEPS)],
            "ragged": [lstm_feed(rng, rng.randint(lo, hi + 1, LSTM_BATCH))
                       for _ in range(LSTM_STEPS)]}
    per_step = {"adam": ADAM_PER_STEP, "adam_tensors": LSTM_ADAM_TENSORS}
    total, report = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, feeds in runs.items():
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feeds, [loss], scope, LSTM_STEPS)
        check_launches(f"train_stacked_lstm {name}", counts, per_step,
                       LSTM_STEPS)
        losses = [float(o[0].reshape(-1)[0]) for o in out]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train_stacked_lstm {name}: non-finite "
                                 f"losses {losses}")
        words = [int(f["words"].shape[0]) for f in feeds]
        report[name] = {
            "losses": losses, "launches": counts, "words": words,
            "host_step_ms": host_ms, "device_step_ms": device_ms,
            "words_per_s_events": sum(words[1:]) * 1e3 / sum(device_ms[1:]),
            "words_per_s_host": sum(words[1:]) * 1e3 / sum(host_ms[1:])}
        add_counts(total, counts)
    emit("train_stacked_lstm", model="stacked_dynamic_lstm",
         dict_dim=LSTM_DICT, emb_dim=LSTM_HID, hid_dim=LSTM_HID,
         lstm_hidden=LSTM_HID // 4, stacked_num=LSTM_STACKED,
         batch=LSTM_BATCH, seq_len=LSTM_LEN, ragged_lengths=list(LSTM_RAGGED),
         lr=LSTM_LR, steps=LSTM_STEPS, ops=ops, parameters=len(params),
         parameter_values=values,
         op_dispatches_per_step=op_dispatches(exe, main, loss),
         max_memory_allocated=torch.cuda.max_memory_allocated(), **report)
    if profile_run:
        feed = lstm_feed(rng, [LSTM_LEN] * LSTM_BATCH)
        profile_step("train_stacked_lstm", lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope),
            {"gemm": GEMM_KEYS})
    return total


def _seq_program(fluid, x_dim):
    """One Program over a LoD feed ``x`` through the sequence and
    recurrent ops (every pool type, softmax, expand, concat, reverse, pad
    and unpad, conv, row_conv, enumerate, a peephole LSTM forward and
    reversed, a GRU), ``sum(out * 0.5)`` of each float output summed into
    a loss, and its backward: (main, startup, outputs, loss)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[x_dim], dtype="float32",
                        lod_level=1, stop_gradient=False)
        ids = layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        outs = [layers.sequence_pool(x, t) for t in
                ("sum", "average", "sqrt", "max", "last", "first")]
        outs.append(layers.sequence_softmax(layers.reduce_sum(
            x, dim=1, keep_dim=True)))
        outs.append(layers.sequence_expand(x, x))
        outs.append(layers.sequence_concat([x, layers.scale(x, 2.0)]))
        outs.append(layers.sequence_reverse(x))
        padded, length = layers.sequence_pad(
            x, layers.fill_constant([1], "float32", 0.0))
        outs += [padded, layers.sequence_unpad(padded, length)]
        outs.append(layers.sequence_conv(x, num_filters=8, filter_size=3))
        outs.append(layers.row_conv(x, future_context_size=2))
        proj = layers.fc(x, size=4 * 16)
        outs.append(layers.dynamic_lstm(proj, size=4 * 16)[0])
        outs.append(layers.dynamic_lstm(proj, size=4 * 16,
                                        is_reverse=True)[1])
        outs.append(layers.dynamic_gru(layers.fc(x, size=3 * 16), size=16))
        terms = [layers.reduce_sum(layers.scale(o, 0.5)) for o in outs]
        loss = terms[0]
        for t in terms[1:]:
            loss = layers.elementwise_add(loss, t)
        fluid.append_backward(loss)
        outs.append(layers.sequence_enumerate(ids, win_size=3))
    return main, startup, outs, loss


def compare_places(phase, main, startup, feed, fetches, places, init=None,
                   tol=SEQ_PARITY_TOL):
    """``main`` run once on each place from one initial state (the first
    place's startup, or ``init``): every fetch, its LoD and dtype equal
    across places, floats within ``tol`` (rtol, atol), integers exactly.
    Returns each float fetch's largest difference, by name."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lod_tensor import LoDTensor
    from paddle_tpu_torch.models.params import load_reference_params

    results = []
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: scope.get(v.name).detach().cpu().numpy().copy()
                    for v in startup.list_vars() if v.persistable}
        else:
            load_reference_params(scope, init, place)
        results.append(exe.run(main, feed=feed, fetch_list=fetches,
                               scope=scope, return_numpy=False))
    rtol, atol = tol
    worst = {}
    for name, c, g in zip(fetches, *results):
        lods = [v.lod() if isinstance(v, LoDTensor) else () for v in (c, g)]
        c, g = (np.asarray(v) if isinstance(v, LoDTensor)
                else v.detach().cpu().numpy() for v in (c, g))
        if lods[0] != lods[1] or c.shape != g.shape or c.dtype != g.dtype:
            raise AssertionError(f"{phase}: {name} on the card is {g.dtype} "
                                 f"{g.shape} {lods[1]}, on the CPU {c.dtype} "
                                 f"{c.shape} {lods[0]}")
        if not np.issubdtype(c.dtype, np.floating):
            if not np.array_equal(c, g):
                raise AssertionError(f"{phase}: {name} differs: card "
                                     f"{g.ravel().tolist()}, CPU "
                                     f"{c.ravel().tolist()}")
            continue
        err = np.abs(g.astype(np.float64) - c)
        if not (err <= atol + rtol * np.abs(c)).all():
            raise AssertionError(f"{phase}: {name} on the card is "
                                 f"{float(err.max())} from the CPU's")
        worst[name] = float(err.max()) if err.size else 0.0
    return worst


def phase_train_stacked_lstm_parity():
    """Card against CPU: the small stacked LSTM (the reference test's
    config, LoD [[6, 7]], Adam 1e-2) over ``LSTM_PARITY_STEPS`` steps from
    one state, fp32 rtol 1e-5 at step 0 and 1e-4 after, one Adam launch a
    step on the card; then a ragged batch (lengths from a seed, one of
    length 1) through the sequence and recurrent ops: every output, its
    LoD and the input's grad within ``SEQ_PARITY_TOL``."""
    import numpy as np

    from paddle_tpu_torch import fluid

    progs = build_stacked_lstm(LSTM_SMALL, lr=LSTM_SMALL_LR)
    feed = lstm_feed(np.random.RandomState(0), [6, 7], LSTM_SMALL["dict_dim"])
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    (cpu, card), counts, _ = parity_runs(progs, feed, LSTM_PARITY_STEPS,
                                         places)
    check_launches("train_stacked_lstm_parity", counts,
                   {"adam": ADAM_PER_STEP, "adam_tensors": LSTM_SMALL_TENSORS},
                   LSTM_PARITY_STEPS)
    tol = np.array([1e-5] + [1e-4] * (LSTM_PARITY_STEPS - 1))
    rel = check_parity("train_stacked_lstm_parity", cpu, card, tol)

    rng = np.random.RandomState(5)
    lens = [int(v) for v in rng.randint(1, 40, 12)] + [1]
    x = rng.standard_normal((sum(lens), 24)).astype(np.float32)
    ids = rng.randint(0, 50, (sum(lens), 1)).astype(np.int64)
    main, startup, outs, _ = _seq_program(fluid, 24)
    fetches = [o.name for o in outs] + ["x@GRAD"]
    worst = compare_places(
        "train_stacked_lstm_parity", main, startup,
        {"x": fluid.create_lod_tensor(x, [lens]),
         "ids": fluid.create_lod_tensor(ids, [lens])}, fetches, places)
    rtol, atol = SEQ_PARITY_TOL
    emit("train_stacked_lstm_parity", config=LSTM_SMALL, lod=[[6, 7]],
         lr=LSTM_SMALL_LR, cpu_losses=cpu.tolist(),
         card_losses=card.tolist(), rel_err=rel, rtol=tol.tolist(),
         launches=counts, ragged_lengths=lens, ragged_outputs=len(fetches),
         ragged_max_abs_err=max(worst.values()),
         ragged_worst=max(worst, key=worst.get),
         ragged_tol={"rtol": rtol, "atol": atol})


def decoder_cell(fluid, h0, d):
    """``bench.py``'s decode cell: h' = tanh(fc([x, h])), h0 reordered with
    the rank table in training."""
    from paddle_tpu_torch.fluid.contrib.decoder import InitState, StateCell

    cell = StateCell(inputs={"x": None},
                     states={"h": InitState(init=h0, need_reorder=True)},
                     out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", fluid.layers.fc(
            input=[c.get_input("x"), c.get_state("h")], size=d, act="tanh"))

    return cell


def build_train_decoder(vocab=DEC_VOCAB, d=DEC_D, lr=DEC_LR, seed=DEC_SEED):
    """The decode cell under ``TrainingDecoder`` with a softmax projection
    and Adam (``tests/test_beam_search_decoder_dsl.py:67-92``): (main,
    startup, loss).  Its layers come in the decode programs' order, so
    ``unique_name.guard`` gives both the same parameter names."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.decoder import TrainingDecoder

    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src", shape=[1], dtype="int64")
        h0 = layers.fc(input=layers.embedding(src, size=[vocab, d]), size=d,
                       act="tanh")
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        cell = decoder_cell(fluid, h0, d)
        trg_emb = layers.embedding(trg, size=[vocab, d])
        dec = TrainingDecoder(cell)
        with dec.block():
            x = dec.step_input(trg_emb)
            cell.compute_state(inputs={"x": x})
            score = layers.fc(input=cell.out_state(), size=vocab,
                              act="softmax")
            cell.update_states()
            dec.output(score)
        loss = layers.mean(layers.cross_entropy(input=dec(), label=lbl))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_decoder(cls_name, vocab=DEC_VOCAB, d=DEC_D, max_len=DEC_MAX_LEN,
                  beam=DEC_BEAM, topk=DEC_TOPK, seed=DEC_SEED):
    """``bench_decode``'s program (``bench.py:592-625``) with
    ``BeamSearchDecoder`` or ``JitBeamSearchDecoder``: (main, startup,
    ids, scores)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib import decoder

    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src", shape=[1], dtype="int64")
        h0 = layers.fc(input=layers.embedding(src, size=[vocab, d]), size=d,
                       act="tanh")
        cell = decoder_cell(fluid, h0, d)
        init_ids = layers.data(name="init_ids", shape=[1], dtype="int64",
                               lod_level=2)
        init_scores = layers.data(name="init_scores", shape=[1],
                                  dtype="float32", lod_level=2)
        dec = getattr(decoder, cls_name)(
            cell, init_ids, init_scores, target_dict_dim=vocab, word_dim=d,
            topk_size=topk, sparse_emb=False, max_len=max_len,
            beam_size=beam, end_id=DEC_END)
        dec.decode()
        ids, scores = dec()
    return main, startup, ids, scores


def chain_feed(rng, perm, lens, srcs=None, go=DEC_GO):
    """A ``TrainingDecoder`` batch: for each source s (from ``rng`` unless
    given) a target of ``len`` words, GO then the chain s -> perm[s] -> ...,
    labelled with the chain ended by end_id."""
    import numpy as np

    from paddle_tpu_torch import fluid

    if srcs is None:
        srcs = rng.choice(sorted(perm), size=len(lens))
    trg, lbl = [], []
    for s, n in zip(srcs, lens):
        w, chain = int(s), []
        for _ in range(n - 1):
            w = perm[w]
            chain.append(w)
        trg += [go] + chain
        lbl += chain + [DEC_END]
    lod = [[int(n) for n in lens]]
    return {"src": np.asarray(srcs, np.int64).reshape(-1, 1),
            "trg": fluid.create_lod_tensor(
                np.asarray(trg, np.int64).reshape(-1, 1), lod),
            "lbl": fluid.create_lod_tensor(
                np.asarray(lbl, np.int64).reshape(-1, 1), lod)}


def chain_perm(rng, vocab):
    """A permutation of the words 3..vocab-1 (0 pad, 1 end, 2 GO)."""
    words = list(range(3, vocab))
    return dict(zip(words, (int(w) for w in rng.permutation(words))))


def decode_feed(srcs, init_id=0):
    """``bench_decode``'s feed: one init hypothesis a source, score 0."""
    import numpy as np

    from paddle_tpu_torch import fluid

    b = len(srcs)
    lod2 = [[1] * b, [1] * b]
    return {"src": np.asarray(srcs, np.int64).reshape(b, 1),
            "init_ids": fluid.create_lod_tensor(
                np.full((b, 1), init_id, np.int64), lod2),
            "init_scores": fluid.create_lod_tensor(
                np.zeros((b, 1), np.float32), lod2)}


def bench_decode_srcs(batch=DEC_BATCH, vocab=DEC_VOCAB):
    """``bench_decode``'s sources: ``RandomState(0).randint(2, vocab)``."""
    import numpy as np

    return np.random.RandomState(0).randint(2, vocab, size=batch)


@contextlib.contextmanager
def counting_dispatches():
    """Counts the Executor's op dispatches (``run_op`` calls, the ops of
    control-flow sub-blocks included, and group calls) inside the block."""
    from paddle_tpu_torch.fluid import executor

    box = [0]
    run_op, run_group = executor.run_op, executor.run_group

    def counted_op(*args, **kwargs):
        box[0] += 1
        return run_op(*args, **kwargs)

    def counted_group(*args, **kwargs):
        box[0] += 1
        return run_group(*args, **kwargs)

    executor.run_op, executor.run_group = counted_op, counted_group
    try:
        yield box
    finally:
        executor.run_op, executor.run_group = run_op, run_group


def control_stats():
    """The control-flow counters: ``while`` iterations, host syncs (a
    condition or index read off the card, a beam op's copies, the jit
    engine's flag reads) and the jit engine's graph counts and steps."""
    from paddle_tpu_torch.fluid import control_flow_exec as cfe
    from paddle_tpu_torch.ops import array_ops
    from paddle_tpu_torch.ops import beam_search_jit as bsj

    return {"while_iterations": cfe.stats["while_iterations"],
            "host_syncs": (cfe.stats["host_reads"]
                           + array_ops.stats["host_copies"]
                           + bsj.stats["flag_reads"]),
            "captures": bsj.stats["captures"],
            "replays": bsj.stats["replays"],
            "flag_reads": bsj.stats["flag_reads"],
            "jit_steps": bsj.stats["steps"]}


def reset_control_stats():
    from paddle_tpu_torch.fluid import control_flow_exec as cfe
    from paddle_tpu_torch.ops import array_ops
    from paddle_tpu_torch.ops import beam_search_jit as bsj

    cfe.reset_stats()
    array_ops.reset_stats()
    bsj.reset_stats()


def phase_train_decoder(seed, profile_run=False):
    """``bench.py``'s decode cell trained under ``TrainingDecoder`` on the
    card: ``DEC_STEPS`` steps on fresh fixed batches (8 x 16 target
    words), then as many on fresh ragged ones (8 x 4-16): finite losses,
    exactly one Adam launch for the 9 tensors a step and no other
    kernel's; step ms (CUDA events and host clock), words/s, op dispatches
    and ``while`` iterations a step, peak allocated; with ``--profile``
    one more step under the profiler.  Returns (launches, exe, main,
    scope)."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    main, startup, loss = build_train_decoder()
    params = trainable_shapes(main, DEC_ADAM_TENSORS)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    perm = chain_perm(rng, DEC_VOCAB)
    lo, hi = DEC_RAGGED
    runs = {"fixed": [chain_feed(rng, perm, [DEC_LEN] * DEC_BATCH)
                      for _ in range(DEC_STEPS)],
            "ragged": [chain_feed(rng, perm,
                                  rng.randint(lo, hi + 1, DEC_BATCH))
                       for _ in range(DEC_STEPS)]}
    per_step = {"adam": ADAM_PER_STEP, "adam_tensors": DEC_ADAM_TENSORS}
    total, report = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, feeds in runs.items():
        reset_control_stats()
        with counting_dispatches() as box:
            out, host_ms, device_ms, counts = timed_steps(
                exe, main, feeds, [loss], scope, DEC_STEPS)
        check_launches(f"train_decoder {name}", counts, per_step, DEC_STEPS)
        losses = [float(o[0].reshape(-1)[0]) for o in out]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train_decoder {name}: non-finite losses "
                                 f"{losses}")
        words = [int(np.asarray(f["trg"]).shape[0]) for f in feeds]
        stats = control_stats()
        report[name] = {
            "losses": losses, "launches": counts, "words": words,
            "host_step_ms": host_ms, "device_step_ms": device_ms,
            "words_per_s_events": sum(words[1:]) * 1e3 / sum(device_ms[1:]),
            "words_per_s_host": sum(words[1:]) * 1e3 / sum(host_ms[1:]),
            "op_dispatches_per_step": box[0] / DEC_STEPS,
            "while_iterations_per_step":
                stats["while_iterations"] / DEC_STEPS,
            "host_syncs_per_step": stats["host_syncs"] / DEC_STEPS}
        add_counts(total, counts)
    emit("train_decoder", model="bench_decode cell + TrainingDecoder",
         vocab=DEC_VOCAB, d=DEC_D, batch=DEC_BATCH, seq_len=DEC_LEN,
         ragged_lengths=list(DEC_RAGGED), lr=DEC_LR, steps=DEC_STEPS,
         seed=seed, ops=len(main.global_block().ops),
         sub_block_ops=sum(len(b.ops) for b in main.blocks[1:]),
         parameters=len(params),
         parameter_values=sum(int(np.prod(s)) for s in params),
         max_memory_allocated=torch.cuda.max_memory_allocated(), **report)
    if profile_run:
        feed = runs["fixed"][0]
        profile_step("train_decoder", lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope),
            {"gemm": GEMM_KEYS})
    return total, exe, main, scope


def timed_decodes(exe, main, feed, fetches, scope, n):
    """``n`` decodes: each one's (ids LoDTensor, scores LoDTensor, host ms
    to the ids on the host, device ms by CUDA events), with the dispatch
    and control counters over them."""
    import numpy as np
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = []
    torch.cuda.synchronize()
    reset_control_stats()
    with counting_dispatches() as box:
        for _ in range(n):
            t0 = time.perf_counter()
            start.record()
            ids, scores = exe.run(main, feed=feed, fetch_list=fetches,
                                  scope=scope, return_numpy=False)
            end.record()
            ids_np = np.asarray(ids)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            out.append((ids, scores, ids_np, host_ms,
                        start.elapsed_time(end)))
    return out, box[0], control_stats()


def load_decoder(cls_name, ckpt, **build):
    """A decode program on the card with the checkpoint ``ckpt``'s
    weights, or its startup's (seed ``DEC_SEED``) where ``ckpt`` is None:
    (exe, main, scope, ids, scores)."""
    from paddle_tpu_torch import fluid

    main, startup, ids, scores = build_decoder(cls_name, **build)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    if ckpt is not None:
        fluid.io.load_persistables(exe, ckpt, main, scope=scope)
    return exe, main, scope, ids, scores


def decode_report(runs, dispatches, stats):
    """The numbers of warm decodes ``runs`` (``timed_decodes``)."""
    tokens = sum(int(r[2].size) for r in runs)
    host_s = sum(r[3] for r in runs) / 1e3
    n = len(runs)
    return {"tokens": tokens, "tokens_per_s": tokens / host_s,
            "host_ms": [r[3] for r in runs],
            "device_ms": [r[4] for r in runs],
            "ms_per_decode": host_s * 1e3 / n,
            "op_dispatches_per_decode": dispatches / n,
            "host_syncs_per_decode": stats["host_syncs"] / n,
            # the While loop's iterations, or the jit engine's graph steps
            "steps_per_decode": (stats["while_iterations"]
                                 + stats["jit_steps"]) / n}


def phase_decode_beam(tmp, exe, main, scope):
    """Phase 41's weights, saved and loaded, through ``BeamSearchDecoder``
    at ``bench_decode``'s widths and feed: a cold decode, then
    ``DEC_WARM`` warm ones.  Returns (ids, lod, scores) of the last."""
    import numpy as np

    from paddle_tpu_torch import fluid

    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, tmp, main)
    exe2, main2, scope2, ids, scores = load_decoder("BeamSearchDecoder", tmp)
    feed = decode_feed(bench_decode_srcs())
    cold, _, cold_stats = timed_decodes(exe2, main2, feed, [ids, scores],
                                        scope2, 1)
    warm, dispatches, stats = timed_decodes(exe2, main2, feed,
                                            [ids, scores], scope2, DEC_WARM)
    last_ids, last_scores, ids_np = warm[-1][:3]
    lod = last_ids.lod()
    for r in warm:
        if r[0].lod() != lod or not np.array_equal(r[2], ids_np):
            raise AssertionError("decode_beam: warm decodes differ")
    emit("decode_beam", engine="BeamSearchDecoder (While loop)",
         batch=DEC_BATCH, beam=DEC_BEAM, max_len=DEC_MAX_LEN,
         topk=DEC_TOPK, vocab=DEC_VOCAB, d=DEC_D,
         ops=len(main2.global_block().ops),
         sub_block_ops=sum(len(b.ops) for b in main2.blocks[1:]),
         cold_ms=cold[0][3], cold_host_syncs=cold_stats["host_syncs"],
         hypotheses=len(lod[1]) - 1,
         hypothesis_lengths=[int(b - a) for a, b in zip(lod[1], lod[1][1:])],
         ended_at_end_id=int(sum(
             1 for a, b in zip(lod[1], lod[1][1:])
             if ids_np.reshape(-1)[b - 1] == DEC_END)),
         **decode_report(warm, dispatches, stats))
    return ids_np.reshape(-1), lod, np.asarray(last_scores).reshape(-1)


def first_difference(got, want):
    """The first hypothesis (by index) whose ids or length differ, or
    None."""
    (g_ids, g_lod, _), (w_ids, w_lod, _) = got, want
    n = min(len(g_lod[1]), len(w_lod[1])) - 1
    for j in range(n):
        g = g_ids[g_lod[1][j]:g_lod[1][j + 1]]
        w = w_ids[w_lod[1][j]:w_lod[1][j + 1]]
        if g.shape != w.shape or (g != w).any():
            return j
    return None if g_lod == w_lod else n


def check_same_hypotheses(phase, got, want, atol=DEC_SCORE_ATOL):
    """Ids and both LoD levels equal and scores within ``atol``; ids may
    differ only from a hypothesis whose final scores tie in fp32 (within
    ``DEC_TIE_RTOL``): then the two scores are returned."""
    import numpy as np

    (g_ids, g_lod, g_sc), (w_ids, w_lod, w_sc) = got, want
    j = first_difference(got, want)
    if j is None:
        err = float(np.abs(g_sc - w_sc).max())
        if err > atol:
            raise AssertionError(f"{phase}: scores {err} from the eager "
                                 f"engine's (atol {atol})")
        return {"equal": True, "max_abs_score_err": err}
    a = float(g_sc[g_lod[1][j + 1] - 1])
    b = float(w_sc[w_lod[1][j + 1] - 1])
    if abs(a - b) > DEC_TIE_RTOL * abs(b):
        raise AssertionError(f"{phase}: hypothesis {j} differs and its "
                             f"scores {a} / {b} do not tie")
    return {"equal": False, "tie_at": j, "tie_scores": [a, b]}


def time_jit_decodes(exe, main, scope, ids, scores, feed, want, tag):
    """A cold decode and ``DEC_WARM`` warm ones through a
    ``JitBeamSearchDecoder`` program: one capture in the first decode and
    none after, the last decode's hypotheses held to ``want``."""
    import numpy as np

    cold, _, cold_stats = timed_decodes(exe, main, feed, [ids, scores],
                                        scope, 1)
    warm, dispatches, stats = timed_decodes(exe, main, feed, [ids, scores],
                                            scope, DEC_WARM)
    if cold_stats["captures"] != 1 or stats["captures"] != 0:
        raise AssertionError(
            f"{tag}: {cold_stats['captures']} captures in the first "
            f"decode, {stats['captures']} after it")
    last_ids, last_scores, ids_np = warm[-1][:3]
    got = (ids_np.reshape(-1), last_ids.lod(),
           np.asarray(last_scores).reshape(-1))
    return {"cold_ms": cold[0][3],
            "graph_replays_per_decode": stats["replays"] / DEC_WARM,
            "flag_reads_per_decode": stats["flag_reads"] / DEC_WARM,
            **decode_report(warm, dispatches, stats),
            **check_same_hypotheses(tag, got, want)}


def phase_decode_jit(tmp, want):
    """The same weights and feed through ``JitBeamSearchDecoder``: the
    same hypotheses as phase 42 and no capture after the first decode,
    timed over ``DEC_WARM`` warm decodes.  Then ``bench_decode``'s own
    traffic: its seed-5 initial weights, whose beams do not end early,
    held to one decode of ``BeamSearchDecoder`` on the same weights and
    timed the same way."""
    import numpy as np

    from paddle_tpu_torch import fluid

    feed = decode_feed(bench_decode_srcs())
    # bench_decode's random weights: the jit program's startup, saved and
    # loaded into the While program
    exe, main, scope, ids, scores = load_decoder("JitBeamSearchDecoder", None)
    rand = tmp + "_random"
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, rand, main)
    exe2, main2, scope2, ids2, scores2 = load_decoder("BeamSearchDecoder",
                                                      rand)
    (ids_t, sc_t, ids_np) = timed_decodes(exe2, main2, feed, [ids2, scores2],
                                          scope2, 1)[0][0][:3]
    want_r = (ids_np.reshape(-1), ids_t.lod(), np.asarray(sc_t).reshape(-1))
    report = {}
    for name, ckpt, w in (("trained", tmp, want), ("random", rand, want_r)):
        exe, main, scope, ids, scores = load_decoder("JitBeamSearchDecoder",
                                                     ckpt)
        report[name] = time_jit_decodes(exe, main, scope, ids, scores, feed,
                                        w, f"decode_jit {name}")
    lod = want_r[1]
    report["random"]["hypothesis_lengths"] = [
        int(b - a) for a, b in zip(lod[1], lod[1][1:])]
    emit("decode_jit", engine="JitBeamSearchDecoder (CUDA graph)",
         batch=DEC_BATCH, beam=DEC_BEAM, max_len=DEC_MAX_LEN,
         vocab=DEC_VOCAB, d=DEC_D, **report)


def small_control_programs():
    """While, IfElse, Switch and StaticRNN programs after
    ``tests/test_control_flow.py``: a While over a tensor array (a tanh in
    the body) with its input's grad, IfElse with its input's grad, the
    Switch, and one Adam step of the StaticRNN with each parameter's grad:
    name -> (main, startup, fetch names, feeds)."""
    import numpy as np

    from paddle_tpu_torch import fluid

    layers = fluid.layers
    progs = {}

    def new():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        return main, startup

    main, startup = new()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[10], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = layers.fill_constant(shape=[1], dtype="int64", value=3)
        arr = layers.array_write(x=x, i=i)
        cond = layers.less_than(x=i, y=n)
        loop = layers.While(cond=cond)
        with loop.block():
            prev = layers.array_read(array=arr, i=i)
            nxt = layers.sums(input=[layers.tanh(layers.scale(prev, 2.0)),
                                     prev])
            layers.increment(x=i, in_place=True)
            layers.array_write(nxt, i=i, array=arr)
            layers.less_than(x=i, y=n, cond=cond)
        final = layers.array_read(array=arr, i=i)
        loss = layers.reduce_sum(final)
        grad = fluid.calc_gradient(loss, x)[0]
    progs["while"] = (main, startup, [final.name, loss.name, grad.name],
                      [{"x": np.random.RandomState(0).randn(10).astype(
                          np.float32) * 0.5}])

    main, startup = new()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[5, 2], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        zero = layers.fill_constant(shape=[5, 1], dtype="float32", value=0.0)
        ie = layers.IfElse(layers.less_than(zero, layers.slice(
            x, axes=[1], starts=[0], ends=[1])))
        with ie.true_block():
            ie.output(layers.tanh(ie.input(x)))
        with ie.false_block():
            ie.output(layers.scale(ie.input(x), scale=-1.0))
        out = ie()
        loss = layers.reduce_sum(layers.elementwise_mul(out, out))
        grad = fluid.calc_gradient(loss, x)[0]
    progs["ifelse"] = (main, startup, [out.name, grad.name],
                       [{"x": np.random.RandomState(1).randn(5, 2).astype(
                           np.float32)}])

    main, startup = new()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="lr")
        one = layers.fill_constant(shape=[1], dtype="float32", value=1.0,
                                   force_cpu=True)
        two = layers.fill_constant(shape=[1], dtype="float32", value=2.0,
                                   force_cpu=True)
        with layers.Switch() as switch:
            with switch.case(layers.less_than(one, two)):
                layers.assign(input=one, output=lr)
            with switch.default():
                layers.assign(input=two, output=lr)
    progs["switch"] = (main, startup, ["lr"], [{}])

    t_len, batch, dim = 4, 5, 8
    main, startup = new()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", shape=[t_len, batch, dim], dtype="float32",
                        append_batch_size=False)
        label = layers.data("label", shape=[batch, 1], dtype="float32",
                            append_batch_size=False)
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[-1, dim], batch_ref=xt,
                             ref_batch_dim_idx=0)
            hidden = layers.fc([xt, mem], size=dim, act="tanh")
            rnn.update_memory(mem, hidden)
            rnn.step_output(hidden)
        last = layers.reshape(layers.slice(rnn(), axes=[0],
                                           starts=[t_len - 1], ends=[t_len]),
                              shape=[batch, dim])
        loss = layers.reduce_mean(layers.square_error_cost(
            layers.fc(last, size=1), label))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    xv = np.random.RandomState(1).randn(t_len, batch, dim).astype(np.float32)
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    progs["static_rnn"] = (main, startup, [loss.name] + grads,
                           [{"x": xv, "label": xv[0, :, :1].copy()}])
    return progs


def build_book_seq2seq(dict_size=BOOK_DICT, emb=BOOK_EMB, hid=BOOK_HID):
    """``tests/test_book.py:445``'s encoder-decoder: a bi-LSTM encoder and
    a ``DynamicRNN`` LSTM-step decoder with a ``static_input`` context and
    a ``need_reorder`` memory, Adam 8e-3: (main, startup, loss)."""
    from paddle_tpu_torch import fluid

    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 8
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = layers.data(name="src_word", shape=[1], dtype="int64",
                          lod_level=1)
        src_emb = layers.embedding(input=src, size=[dict_size, emb])
        fwd, _ = layers.dynamic_lstm(input=layers.fc(
            input=src_emb, size=hid * 4, bias_attr=False), size=hid * 4)
        bwd, _ = layers.dynamic_lstm(input=layers.fc(
            input=src_emb, size=hid * 4, bias_attr=False), size=hid * 4,
            is_reverse=True)
        context = layers.concat([layers.sequence_last_step(fwd),
                                 layers.sequence_first_step(bwd)], axis=1)
        boot = layers.fc(input=context, size=hid, act="tanh")
        trg = layers.data(name="trg_word", shape=[1], dtype="int64",
                          lod_level=1)
        trg_emb = layers.embedding(input=trg, size=[dict_size, emb])
        rnn = layers.DynamicRNN()
        with rnn.block():
            x = rnn.step_input(trg_emb)
            ctx = rnn.static_input(context)
            h_mem = rnn.memory(init=boot, need_reorder=True)
            c_mem = rnn.memory(shape=[hid], value=0.0)
            gates = layers.fc(input=[x, ctx, h_mem], size=hid * 4)
            i, f, o, ch = layers.split(gates, num_or_sections=4, dim=1)
            c_new = layers.elementwise_add(
                layers.elementwise_mul(layers.sigmoid(f), c_mem),
                layers.elementwise_mul(layers.sigmoid(i), layers.tanh(ch)))
            h_new = layers.elementwise_mul(layers.sigmoid(o),
                                           layers.tanh(c_new))
            rnn.update_memory(h_mem, h_new)
            rnn.update_memory(c_mem, c_new)
            rnn.output(layers.fc(input=h_new, size=dict_size,
                                 act="softmax"))
        lbl = layers.data(name="lbl_word", shape=[1], dtype="int64",
                          lod_level=1)
        loss = layers.mean(layers.cross_entropy(input=rnn(), label=lbl))
        fluid.optimizer.Adam(learning_rate=8e-3).minimize(loss)
    return main, startup, loss


def book_feed(rng, src_lens, trg_lens, dict_size=BOOK_DICT):
    """Word ids in [2, dict_size) as LoD batches; the label is the target
    shifted by one."""
    import numpy as np

    from paddle_tpu_torch import fluid

    def lod(lens, words):
        return fluid.create_lod_tensor(
            np.asarray(words, np.int64).reshape(-1, 1), [list(lens)])

    src = rng.randint(2, dict_size, sum(src_lens))
    trg = rng.randint(2, dict_size, sum(trg_lens))
    lbl = np.concatenate([np.append(trg[a + 1:b], 1) for a, b in zip(
        np.cumsum([0] + list(trg_lens[:-1])), np.cumsum(trg_lens))])
    return {"src_word": lod(src_lens, src), "trg_word": lod(trg_lens, trg),
            "lbl_word": lod(trg_lens, lbl)}


def parity_fetches(progs, places):
    """Each place's fetches of every step of ``progs`` (main, startup,
    fetch names, feeds) from the first place's initial state."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lod_tensor import LoDTensor
    from paddle_tpu_torch.models.params import load_reference_params

    main, startup, names, feeds = progs
    out, init = [], None
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            # copies: the first place's steps update its tensors in place
            init = {v.name: scope.get(v.name).detach().cpu().numpy().copy()
                    for v in startup.list_vars() if v.persistable}
        else:
            load_reference_params(scope, init, place)
        steps = []
        for feed in feeds:
            vals = exe.run(main, feed=feed, fetch_list=names, scope=scope,
                           return_numpy=False)
            steps.append([(np.asarray(v), v.lod()) if isinstance(
                v, LoDTensor) else (v.detach().cpu().numpy(), ())
                for v in vals])
        out.append(steps)
    return out


def dsl_decode(place, ckpt, cls_name, srcs, **build):
    """A decode of the DSL model on ``place`` from the checkpoint
    ``ckpt``: (ids, lod, scores, steps of its loop)."""
    import numpy as np

    from paddle_tpu_torch import fluid

    main, startup, ids, scores = build_decoder(cls_name, **build)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.load_persistables(exe, ckpt, main, scope=scope)
    reset_control_stats()
    fetches = [ids, scores] + [n for n in main.global_block().vars
                               if n.startswith("jbs_nsteps")]
    got = exe.run(main, feed=decode_feed(srcs, DEC_GO), fetch_list=fetches,
                  scope=scope, return_numpy=False)
    nsteps = (int(got[2].reshape(-1)[0]) if len(got) > 2
              else control_stats()["while_iterations"])
    return (np.asarray(got[0]).reshape(-1), got[0].lod(),
            np.asarray(got[1]).reshape(-1), nsteps)


def phase_control_flow_parity(tmp):
    """Card against CPU through control flow: the decoder-DSL test (80
    Adam steps, both engines from the trained checkpoint), its early exit,
    the book's encoder-decoder on a fixed and a ragged batch, and the
    small While / IfElse / Switch / StaticRNN programs.  Returns the Adam
    launches on the card."""
    import numpy as np

    from paddle_tpu_torch import fluid

    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    total, report = {}, {}
    tol = np.array([1e-5] + [1e-4] * (DSL_STEPS - 1))

    # (a) the decoder-DSL test at its widths
    progs = build_train_decoder(vocab=DSL_V, d=DSL_D, seed=9)
    rng = np.random.RandomState(77)
    perm = dict(zip(range(3, DSL_V), (int(w) for w in rng.permutation(
        np.arange(3, DSL_V)))))
    # the test's feed: GO and the chain's first 4 words, labelled with
    # its 5 (no end_id)
    trg, lbl = [], []
    for start in (3, 4, 5, 6):
        chain, w = [], start
        for _ in range(DSL_CHAIN):
            w = perm[w]
            chain.append(w)
        trg += [DEC_GO] + chain[:-1]
        lbl += chain
    lens = [[DSL_CHAIN] * 4]
    feed = {"src": np.array([[3], [4], [5], [6]], np.int64),
            "trg": fluid.create_lod_tensor(
                np.array(trg, np.int64).reshape(-1, 1), lens),
            "lbl": fluid.create_lod_tensor(
                np.array(lbl, np.int64).reshape(-1, 1), lens)}
    (cpu, card), counts, scopes = parity_runs(progs, feed, DSL_STEPS, places)
    add_counts(total, counts)
    rel = check_parity("control_flow_parity dsl", cpu, card, tol)
    ckpt = os.path.join(tmp, "dsl")
    with fluid.scope_guard(scopes[0]):
        fluid.io.save_persistables(fluid.Executor(fluid.CPUPlace()), ckpt,
                                   progs[0])
    build = dict(vocab=DSL_V, d=DSL_D, max_len=DSL_CHAIN + 2, beam=2,
                 topk=DSL_V)
    decodes = {(p, c): dsl_decode(place, ckpt, c, [3, 5], **build)
               for p, place in (("cpu", places[0]), ("card", places[1]))
               for c in ("BeamSearchDecoder", "JitBeamSearchDecoder")}
    want = decodes[("cpu", "BeamSearchDecoder")]
    for key, got in decodes.items():
        check_same_hypotheses(f"control_flow_parity dsl {key}", got[:3],
                              want[:3])
    ids, lod, _, _ = decodes[("card", "JitBeamSearchDecoder")]
    for k, start in enumerate((3, 5)):
        top = ids[lod[1][lod[0][k]]:lod[1][lod[0][k] + 1]].tolist()
        chain, w = [], start
        for _ in range(3):
            w = perm[w]
            chain.append(w)
        got = [t for t in top if t not in (DEC_GO, DEC_END)]
        if got[:3] != chain:
            raise AssertionError(f"control_flow_parity: source {start}'s top "
                                 f"hypothesis {top} does not follow the "
                                 f"chain {chain}")
    report["dsl"] = {"steps": DSL_STEPS, "cpu_losses_first_last":
                     [cpu[0], cpu[-1]], "card_losses_first_last":
                     [card[0], card[-1]], "max_rel_err": max(rel),
                     "top_hypotheses_follow_chain": True,
                     "hypothesis_lengths": [int(b - a) for a, b in zip(
                         lod[1], lod[1][1:])]}

    # (a') the early exit: a projection that puts all mass on end_id
    build = dict(vocab=DSL_V, d=DSL_D, max_len=6, beam=4, topk=DSL_V,
                 seed=3)
    with fluid.scope_guard(fluid.Scope()):
        main, startup, _, _ = build_decoder("BeamSearchDecoder", **build)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        params = main.global_block().all_parameters()
        scope = fluid.global_scope()
        scope.get(params[-2].name).zero_()
        bias = scope.get(params[-1].name)
        bias.fill_(-30.0)
        bias[DEC_END] = 30.0
        ckpt = os.path.join(tmp, "early_exit")
        fluid.io.save_persistables(exe, ckpt, main)
    early = {(p, c): dsl_decode(place, ckpt, c, [2, 3, 4], **build)
             for p, place in (("cpu", places[0]), ("card", places[1]))
             for c in ("BeamSearchDecoder", "JitBeamSearchDecoder")}
    want = early[("cpu", "BeamSearchDecoder")]
    for key, got in early.items():
        check_same_hypotheses(f"control_flow_parity early exit {key}",
                              got[:3], want[:3])
    ids, lod = want[0], want[1]
    ends = [int(ids[b - 1]) for b in lod[1][1:]]
    jit_steps = [v[3] for (p, c), v in early.items()
                 if c == "JitBeamSearchDecoder"]
    if set(ends) != {DEC_END} or max(int(b - a) for a, b in zip(
            lod[1], lod[1][1:])) > 3 or set(jit_steps) != {3}:
        raise AssertionError(f"control_flow_parity: the early-exit "
                             f"hypotheses {ids.tolist()} {lod}, jit steps "
                             f"{jit_steps}")
    report["early_exit"] = {
        "steps": {f"{p}_{c}": v[3] for (p, c), v in early.items()},
        "hypotheses": len(lod[1]) - 1, "all_end_at_end_id": True}

    # (b) the book's encoder-decoder, a fixed and a ragged batch
    rng = np.random.RandomState(8)
    batches = {"fixed": book_feed(rng, [BOOK_LEN] * BOOK_BATCH,
                                  [BOOK_LEN] * BOOK_BATCH),
               "ragged": book_feed(rng, rng.randint(1, BOOK_LEN + 1,
                                                    BOOK_BATCH),
                                   rng.randint(1, BOOK_LEN + 1, BOOK_BATCH))}
    tol = np.array([1e-5] + [1e-4] * (BOOK_STEPS - 1))
    for name, feed in batches.items():
        (cpu, card), counts, _ = parity_runs(build_book_seq2seq(), feed,
                                             BOOK_STEPS, places)
        add_counts(total, counts)
        report[f"book_{name}"] = {
            "cpu_losses": cpu.tolist(), "card_losses": card.tolist(),
            "rel_err": check_parity(f"control_flow_parity book {name}",
                                    cpu, card, tol)}

    # (c) the small While / IfElse / Switch / StaticRNN programs
    for name, progs in small_control_programs().items():
        reset_launch_counts()
        cpu, card = parity_fetches(progs, places)
        add_counts(total, launch_counts())
        worst = 0.0
        for step, (c_step, g_step) in enumerate(zip(cpu, card)):
            for (c, c_lod), (g, g_lod) in zip(c_step, g_step):
                err = np.abs(g.astype(np.float64) - c)
                if c_lod != g_lod or not (err <= 1e-5 * np.abs(c)
                                          + 1e-7).all():
                    raise AssertionError(f"control_flow_parity {name}: card "
                                         f"{g} against CPU {c}")
                worst = max(worst, float(err.max()) if err.size else 0.0)
        report[name] = {"fetches": len(progs[2]), "steps": len(progs[3]),
                        "max_abs_err": worst}
    emit("control_flow_parity", rtol={"step_0": 1e-5, "after": 1e-4,
                                      "outputs": 1e-5}, **report)
    return total


def db_lstm(fluid, word_dict_len, pred_dict_len, label_dict_len,
            hidden_dim=SRL_HIDDEN, depth=SRL_DEPTH):
    """The book's label-semantic-roles program (upstream
    ``test_label_semantic_roles.py``: ``db_lstm``, the CRF's loss, SGD on
    an exponential decay, then ``crf_decoding`` and ``chunk_eval``) built
    with ``fluid`` (either package's).  Returns a dict: ``main``,
    ``startup``, ``test`` (``main`` cloned for test), ``cost``,
    ``decode`` (the Viterbi path) and ``chunk`` (the six ``chunk_eval``
    outputs)."""
    import math

    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        def data(name):
            return layers.data(name=name, shape=[1], dtype="int64",
                               lod_level=1)

        word, predicate = data("word_data"), data("verb_data")
        ctx = [data(f"ctx_{n}_data") for n in ("n2", "n1", "0", "p1", "p2")]
        mark = data("mark_data")
        pred_emb = layers.embedding(
            input=predicate, size=[pred_dict_len, SRL_WORD_DIM],
            dtype="float32", is_sparse=True, param_attr="vemb")
        mark_emb = layers.embedding(input=mark, size=[2, SRL_MARK_DIM],
                                    dtype="float32", is_sparse=True)
        embs = [layers.embedding(
            size=[word_dict_len, SRL_WORD_DIM], input=x,
            param_attr=fluid.ParamAttr(name="emb", trainable=False))
            for x in [word] + ctx] + [pred_emb, mark_emb]
        lstm_args = dict(candidate_activation="relu",
                         gate_activation="sigmoid",
                         cell_activation="sigmoid")
        mix = layers.sums(input=[layers.fc(input=e, size=hidden_dim,
                                           act="tanh") for e in embs])
        lstm = layers.dynamic_lstm(input=mix, size=hidden_dim, **lstm_args)
        for i in range(1, depth):
            mix = layers.sums(input=[
                layers.fc(input=mix, size=hidden_dim, act="tanh"),
                layers.fc(input=lstm, size=hidden_dim, act="tanh")])
            lstm = layers.dynamic_lstm(input=mix, size=hidden_dim,
                                       is_reverse=(i % 2) == 1, **lstm_args)
        feature_out = layers.sums(input=[
            layers.fc(input=mix, size=label_dict_len, act="tanh"),
            layers.fc(input=lstm, size=label_dict_len, act="tanh")])
        target = data("target")
        crf_cost = layers.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=fluid.ParamAttr(name="crfw",
                                       learning_rate=SRL_MIX_LR))
        cost = layers.mean(crf_cost)
        fluid.optimizer.SGD(learning_rate=layers.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(cost)
        decode = layers.crf_decoding(
            input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
        chunk = layers.chunk_eval(
            input=decode, label=target, chunk_scheme="IOB",
            num_chunk_types=int(math.ceil((label_dict_len - 1) / 2.0)))
    return {"main": main, "startup": startup,
            "test": main.clone(for_test=True), "cost": cost,
            "decode": decode, "chunk": chunk}


def srl_batches(n, batch=SRL_BATCH):
    """The first ``n`` batches of ``batch`` sentences of the synthetic
    conll05's ``test()`` reader."""
    from paddle_tpu_torch.dataset import conll05

    out, cur = [], []
    for sample in conll05.test()():
        cur.append(sample)
        if len(cur) == batch:
            out.append(cur)
            cur = []
            if len(out) == n:
                break
    return out


def srl_feed(samples):
    """A batch of conll05 samples as the db_lstm's nine LoD feeds
    (``(ids, [lengths])``, one per sample slot)."""
    import numpy as np

    lens = [len(s[0]) for s in samples]
    return {name: (np.concatenate([np.asarray(s[i], np.int64)
                                   for s in samples]).reshape(-1, 1), [lens])
            for i, name in enumerate(SRL_FEEDS)}


def load_parameter(file_name, h, w):
    """The book's ``load_parameter``: skip the file's 16-byte header, then
    ``h`` x ``w`` float32 rows."""
    import numpy as np

    with open(file_name, "rb") as f:
        f.read(16)
        return np.fromfile(f, dtype=np.float32).reshape(h, w)


def host_syncs():
    """The host reads of device data the structured-loss and detection
    host ops, the print ops and the control flow made."""
    from paddle_tpu_torch.ops import detection_ops, nn_ops
    from paddle_tpu_torch.ops import struct_loss_ops as sl

    return (sl.stats["host_reads"] + detection_ops.stats["host_reads"]
            + nn_ops.stats["host_reads"] + control_stats()["host_syncs"])


def reset_host_syncs():
    from paddle_tpu_torch.ops import detection_ops, nn_ops
    from paddle_tpu_torch.ops import struct_loss_ops as sl

    sl.reset_stats()
    detection_ops.reset_stats()
    nn_ops.stats["host_reads"] = 0
    reset_control_stats()


def phase_train_srl(profile_run=False):
    """The book's db_lstm tagger at its widths on the card: the synthetic
    embedding file loaded through ``scope.find_var('emb').get_tensor()
    .set(...)``, ``SRL_STEPS`` SGD steps on batches of 10 sentences
    (finite losses, no optimizer kernel launched: the book trains with
    SGD, plain PyTorch), ``emb`` bitwise unchanged (not trainable), the
    rows of ``vemb`` that no verb id hit bitwise unchanged (the sparse
    update); then ``SRL_DECODE`` batches through the test program's
    ``crf_decoding`` and ``chunk_eval`` into ``fluid.metrics.
    ChunkEvaluator``.  Words/s and step ms (CUDA events and host clock),
    op dispatches and host syncs a step, peak allocated; with
    ``--profile`` one more step under the profiler.  Returns the
    launches."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import conll05

    word_dict, verb_dict, label_dict = conll05.get_dict()
    progs = db_lstm(fluid, len(word_dict), len(verb_dict), len(label_dict))
    main, test, cost = progs["main"], progs["test"], progs["cost"]
    params = main.global_block().all_parameters()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    emb = load_parameter(conll05.get_embedding(), len(word_dict),
                         SRL_WORD_DIM)
    emb_tensor = scope.get("emb")
    scope.find_var("emb").get_tensor().set(emb, fluid.CUDAPlace(0))
    if scope.get("emb") is not emb_tensor:
        raise AssertionError("train_srl: set() replaced emb's tensor")
    vemb_before = scope.get("vemb").clone()
    batches = srl_batches(SRL_STEPS + SRL_DECODE)
    feeds = [srl_feed(b) for b in batches[:SRL_STEPS]]
    torch.cuda.reset_peak_memory_stats()
    reset_host_syncs()
    with counting_dispatches() as box:
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feeds, [cost], scope, SRL_STEPS)
    syncs = host_syncs()
    check_launches("train_srl", counts, {}, SRL_STEPS)
    losses = [float(o[0].reshape(-1)[0]) for o in out]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_srl: non-finite losses {losses}")
    if not torch.equal(scope.get("emb").cpu(), torch.from_numpy(emb)):
        raise AssertionError("train_srl: emb (trainable=False) moved")
    hit = sorted({int(v) for f in feeds for v in f["verb_data"][0].ravel()})
    missed = [r for r in range(len(verb_dict)) if r not in hit]
    vemb = scope.get("vemb")
    if not torch.equal(vemb[missed], vemb_before[missed]) or \
            torch.equal(vemb[hit], vemb_before[hit]):
        raise AssertionError("train_srl: the sparse update of vemb moved "
                             "rows no id hit, or none it hit")
    words = [int(f["word_data"][0].shape[0]) for f in feeds]

    metric = fluid.metrics.ChunkEvaluator()
    decode_feeds = [srl_feed(b) for b in batches[SRL_STEPS:]]
    chunk = progs["chunk"]
    reset_host_syncs()
    with counting_dispatches() as dbox:
        dec, dec_host_ms, dec_device_ms, dec_counts = timed_steps(
            exe, test, decode_feeds, [progs["decode"], *chunk[3:]], scope,
            SRL_DECODE)
    dec_syncs = host_syncs()
    check_launches("train_srl decode", dec_counts, {}, SRL_DECODE)
    for path, *chunk_counts in dec:
        if not ((path >= 0) & (path < len(label_dict))).all():
            raise AssertionError(f"train_srl: Viterbi tags out of range "
                                 f"{path.ravel().tolist()}")
        metric.update(*chunk_counts)
    precision, recall, f1 = metric.eval()
    emit("train_srl", model="db_lstm (book chapter 7)",
         data="synthetic conll05", word_dict=len(word_dict),
         verb_dict=len(verb_dict), labels=len(label_dict),
         word_dim=SRL_WORD_DIM, mark_dim=SRL_MARK_DIM,
         hidden_dim=SRL_HIDDEN, depth=SRL_DEPTH, batch=SRL_BATCH,
         steps=SRL_STEPS, ops=len(main.global_block().ops),
         parameters=len(params),
         parameter_values=sum(int(np.prod(p.shape)) for p in params),
         losses=losses, launches=counts, words=words,
         host_step_ms=host_ms, device_step_ms=device_ms,
         words_per_s_events=sum(words[1:]) * 1e3 / sum(device_ms[1:]),
         words_per_s_host=sum(words[1:]) * 1e3 / sum(host_ms[1:]),
         op_dispatches_per_step=box[0] / SRL_STEPS,
         host_syncs_per_step=syncs / SRL_STEPS,
         verb_rows_hit=len(hit), verb_rows_unchanged=len(missed),
         decode_batches=SRL_DECODE, decode_host_ms=dec_host_ms,
         decode_device_ms=dec_device_ms,
         decode_op_dispatches_per_batch=dbox[0] / SRL_DECODE,
         decode_host_syncs_per_batch=dec_syncs / SRL_DECODE,
         chunks={"infer": metric.num_infer_chunks,
                 "label": metric.num_label_chunks,
                 "correct": metric.num_correct_chunks},
         precision=precision, recall=recall, f1=f1,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if profile_run:
        profile_step("train_srl", lambda: exe.run(
            main, feed=feeds[0], fetch_list=[cost], scope=scope),
            {"gemm": GEMM_KEYS})
    return counts


def _struct_program(fluid, k=5):
    """One Program through every op this slice ports (the CRF and its
    decoding with and without a label, the CTC loss, the greedy decoder
    and edit distance, chunk_eval, NCE with a fixed seeded draw, the
    hierarchical sigmoid, im2sequence and the ten other losses) on LoD
    inputs ``x`` (``[N, k]``), ``tags`` and ``ctc_label`` and dense ones
    (``y`` ``[S, k]``, ``cls``, ``lab01``, ``img``), ``sum(out * 0.5)`` of
    each differentiable output summed into a loss, and its backward:
    (main, startup, outputs, the grads to fetch)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()

        def data(name, shape, dtype="float32", lod=0, grad=False):
            return layers.data(name=name, shape=shape, dtype=dtype,
                               lod_level=lod, stop_gradient=not grad)

        def op(op_type, inputs, out, attrs=None):
            v = block.create_var(
                name=fluid.unique_name.generate(op_type + ".out"),
                dtype="float32")
            block.append_op(type=op_type,
                            inputs={s: [t] for s, t in inputs.items()},
                            outputs={out: [v]}, attrs=attrs or {})
            return v

        x = data("x", [k], lod=1, grad=True)
        tags = data("tags", [1], "int64", 1)
        ctc_label = data("ctc_label", [1], "int64", 1)
        y = data("y", [k], grad=True)
        cls = data("cls", [1], "int64")
        lab01 = data("lab01", [1])
        img = data("img", [2, 6, 8], grad=True)
        pooled = layers.sequence_pool(x, "sum")
        left = layers.slice(pooled, axes=[1], starts=[0], ends=[1])
        right = layers.slice(pooled, axes=[1], starts=[1], ends=[2])
        crfw = fluid.ParamAttr(name="crfw")
        floats = [layers.linear_chain_crf(x, tags, crfw)]
        path = layers.crf_decoding(x, crfw)
        greedy = layers.ctc_greedy_decoder(x, blank=k - 1)
        dist, seq_num = layers.edit_distance(greedy, ctc_label)
        chunk = layers.chunk_eval(path, tags, "IOB",
                                  num_chunk_types=(k - 1) // 2)
        others = [path, layers.crf_decoding(x, crfw, label=tags), greedy,
                  dist, seq_num, *chunk]
        floats += [
            layers.warpctc(x, ctc_label, blank=k - 1),
            layers.nce(pooled, cls, num_total_classes=2 * k,
                       num_neg_samples=3, seed=7),
            layers.hsigmoid(pooled, cls, num_classes=6),
            layers.im2sequence(img, filter_size=[3, 2], stride=[2, 2],
                               padding=[1, 0]),
            layers.huber_loss(pooled, y, 0.5),
            layers.smooth_l1(pooled, y, sigma=1.5),
            layers.log_loss(layers.sigmoid(left), lab01),
            op("hinge_loss", {"Logits": left, "Labels": lab01}, "Loss"),
            layers.rank_loss(lab01, left, right),
            op("margin_rank_loss", {"Label": layers.scale(lab01, 2.0, -1.0),
                                    "X1": left, "X2": right}, "Out",
               {"margin": 0.1}),
            op("squared_l2_norm", {"X": y}, "Out"),
            op("squared_l2_distance", {"X": pooled, "Y": y}, "Out"),
            op("bpr_loss", {"X": pooled, "Label": cls}, "Y"),
            op("kldiv_loss", {"X": layers.log(layers.softmax(pooled)),
                              "Target": layers.softmax(y)}, "Loss",
               {"reduction": "batchmean"})]
        terms = [layers.reduce_sum(layers.scale(o, 0.5)) for o in floats]
        loss = terms[0]
        for t in terms[1:]:
            loss = layers.elementwise_add(loss, t)
        fluid.append_backward(loss)
    grads = ["x@GRAD", "y@GRAD", "img@GRAD"] + [
        p.name + "@GRAD" for p in main.global_block().all_parameters()]
    return main, startup, floats + others, grads


def struct_feed(rng, lens, k=5):
    """The ragged feed of :func:`_struct_program`: ``x`` and ``tags`` of
    ``lens``, CTC labels of at most a third of each length (ids below
    ``k - 1``, the blank), a dense row per sequence and two images."""
    import numpy as np

    n, s = sum(lens), len(lens)
    ctc_lens = [int(rng.randint(0, t // 3 + 1)) for t in lens]
    return {"x": (rng.standard_normal((n, k)).astype(np.float32), [lens]),
            "tags": (rng.randint(0, k, (n, 1)).astype(np.int64), [lens]),
            "ctc_label": (rng.randint(0, k - 1, (sum(ctc_lens), 1)).astype(
                np.int64), [ctc_lens]),
            "y": rng.standard_normal((s, k)).astype(np.float32),
            "cls": rng.randint(0, k, (s, 1)).astype(np.int64),
            "lab01": (rng.rand(s, 1) > 0.5).astype(np.float32),
            "img": rng.standard_normal((2, 2, 6, 8)).astype(np.float32)}


def phase_train_srl_parity():
    """Card against CPU: the db_lstm at hidden 32, depth 3 from one
    initial state, ``SRL_PARITY_STEPS`` SGD steps on one batch (losses
    rtol 1e-5 at step 0, 1e-4 after, no optimizer kernel launched); the
    test program's Viterbi paths and chunk counts equal from one state;
    then every op this slice ports on a ragged LoD batch (lengths with a
    1): outputs, LoDs and input and parameter grads within
    ``SEQ_PARITY_TOL``, integer outputs equal."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import conll05

    word_dict, verb_dict, label_dict = conll05.get_dict()
    progs = db_lstm(fluid, len(word_dict), len(verb_dict), len(label_dict),
                    **SRL_SMALL)
    batches = srl_batches(2)
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    (cpu, card), counts, scopes = parity_runs(
        (progs["main"], progs["startup"], progs["cost"]),
        srl_feed(batches[0]), SRL_PARITY_STEPS, places)
    check_launches("train_srl_parity", counts, {}, SRL_PARITY_STEPS)
    tol = np.array([1e-5] + [1e-4] * (SRL_PARITY_STEPS - 1))
    rel = check_parity("train_srl_parity", cpu, card, tol)
    state = {v.name: scopes[0].get(v.name).detach().cpu().numpy().copy()
             for v in progs["startup"].list_vars() if v.persistable}
    decode = [progs["decode"].name] + [v.name for v in progs["chunk"][3:]]
    compare_places("train_srl_parity decode", progs["test"],
                   progs["startup"], srl_feed(batches[1]), decode, places,
                   init=state, tol=(0.0, 0.0))

    rng = np.random.RandomState(5)
    lens = [int(v) for v in rng.randint(1, 30, 9)] + [1]
    main, startup, outs, grads = _struct_program(fluid)
    fetches = [o.name for o in outs] + grads
    worst = compare_places("train_srl_parity ops", main, startup,
                           struct_feed(rng, lens), fetches, places)
    rtol, atol = SEQ_PARITY_TOL
    emit("train_srl_parity", config=SRL_SMALL, steps=SRL_PARITY_STEPS,
         cpu_losses=cpu.tolist(), card_losses=card.tolist(), rel_err=rel,
         rtol=tol.tolist(), launches=counts, decode_equal=decode,
         ragged_lengths=lens, op_types=sorted(
             {op.type for op in main.global_block().ops}),
         ragged_fetches=len(fetches),
         ragged_max_abs_err=max(worst.values()),
         ragged_worst=max(worst, key=worst.get),
         ragged_tol={"rtol": rtol, "atol": atol})


def ctc_programs(fluid, batch=CTC_BATCH, image=CTC_IMAGE, kernel=CTC_KERNEL,
                 hidden=CTC_HIDDEN, classes=CTC_CLASSES, lr=CTC_LR):
    """The CTC recognizer built with ``fluid`` (either package's):
    ``im2sequence`` over ``batch`` images, ``lod_reset`` to one sequence
    an image, fc + relu, a GRU each way, fc to ``classes`` + the blank,
    ``warpctc``, ``mean``, Adam.  The test program (``main`` cloned for
    test) adds ``ctc_greedy_decoder`` and ``fluid.evaluator.
    EditDistance``, whose states ``eval_startup`` makes.  Returns a dict:
    main, startup, test, eval_startup, cost, decoded, evaluator."""
    layers = fluid.layers
    main, startup, eval_startup = (fluid.Program() for _ in range(3))
    main.random_seed = startup.random_seed = 1
    frames = (image[2] - kernel[1]) // kernel[1] + 1
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            pixel = layers.data(name="pixel", shape=list(image),
                                dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64",
                                lod_level=1)
            seq = layers.im2sequence(pixel, filter_size=list(kernel),
                                     stride=[1, kernel[1]])
            # neither package's builder gives the patches a static shape,
            # which fc needs (ROADMAP queue 3)
            seq.shape = (-1, image[0] * kernel[0] * kernel[1])
            seq = layers.lod_reset(seq, target_lod=list(
                range(0, batch * frames + 1, frames)))
            fc1 = layers.fc(input=seq, size=hidden, act="relu")
            fwd = layers.dynamic_gru(layers.fc(input=fc1, size=3 * hidden),
                                     size=hidden)
            bwd = layers.dynamic_gru(layers.fc(input=fc1, size=3 * hidden),
                                     size=hidden, is_reverse=True)
            logits = layers.fc(input=[fwd, bwd], size=classes + 1)
            cost = layers.mean(layers.warpctc(logits, label, blank=classes))
            fluid.optimizer.Adam(learning_rate=lr).minimize(cost)
        test = main.clone(for_test=True)
        with fluid.program_guard(test, eval_startup):
            block = test.global_block()
            decoded = layers.ctc_greedy_decoder(block.var(logits.name),
                                                blank=classes)
            evaluator = fluid.evaluator.EditDistance(
                input=decoded, label=block.var(label.name))
    return {"main": main, "startup": startup, "test": test,
            "eval_startup": eval_startup, "cost": cost, "decoded": decoded,
            "evaluator": evaluator}


def ctc_feed(rng, batch=CTC_BATCH, image=CTC_IMAGE, classes=CTC_CLASSES,
             label_lens=CTC_LABEL_LENS):
    """Images from a normal draw and label sequences of ``label_lens``
    ids below ``classes``."""
    import numpy as np

    lens = [int(v) for v in rng.randint(label_lens[0], label_lens[1] + 1,
                                        batch)]
    return {"pixel": rng.standard_normal((batch,) + tuple(image)).astype(
                np.float32),
            "label": (rng.randint(0, classes, (sum(lens), 1)).astype(
                np.int64), [lens])}


def phase_train_ctc(profile_run=False):
    """The CTC recognizer on the card: ``CTC_STEPS`` Adam steps on fresh
    batches (finite losses, exactly one Adam launch for its 13 tensors a
    step and no other kernel's); examples/s and step ms (CUDA events and
    host clock), op dispatches and host syncs a step, peak allocated;
    then ``CTC_DECODE`` fresh batches through the test program's greedy
    decoder and ``fluid.evaluator.EditDistance`` (reset, then eval), held
    to ``fluid.metrics.EditDistance`` over the fetched distances.  With
    ``--profile`` one more step under the profiler.  Returns the
    launches."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    progs = ctc_programs(fluid)
    main, test, cost = progs["main"], progs["test"], progs["cost"]
    params = trainable_shapes(main, CTC_ADAM_TENSORS)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    exe.run(progs["eval_startup"], scope=scope)
    rng = np.random.RandomState(0)
    feeds = [ctc_feed(rng) for _ in range(CTC_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_host_syncs()
    with counting_dispatches() as box:
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feeds, [cost], scope, CTC_STEPS)
    syncs = host_syncs()
    check_launches("train_ctc", counts,
                   {"adam": ADAM_PER_STEP, "adam_tensors": CTC_ADAM_TENSORS},
                   CTC_STEPS)
    losses = [float(o[0].reshape(-1)[0]) for o in out]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_ctc: non-finite losses {losses}")

    evaluator, metric = progs["evaluator"], fluid.metrics.EditDistance()
    distances = evaluator.metrics[0]
    decode_feeds = [ctc_feed(rng) for _ in range(CTC_DECODE)]
    with fluid.scope_guard(scope):
        evaluator.reset(exe)
        reset_host_syncs()
        with counting_dispatches() as dbox:
            dec, dec_host_ms, dec_device_ms, dec_counts = timed_steps(
                exe, test, decode_feeds, [distances], scope, CTC_DECODE)
        dec_syncs = host_syncs()
        avg, err = evaluator.eval(exe)
    check_launches("train_ctc decode", dec_counts, {}, CTC_DECODE)
    for (d,) in dec:
        metric.update(d, d.shape[0])
    want = metric.eval()
    if not np.allclose([float(avg[0]), float(err[0])], want, rtol=1e-5):
        raise AssertionError(f"train_ctc: the evaluator's ({avg}, {err}) "
                             f"against fluid.metrics' {want}")
    emit("train_ctc", model="im2sequence + bi-GRU + warpctc",
         batch=CTC_BATCH, image=list(CTC_IMAGE), kernel=list(CTC_KERNEL),
         frames=(CTC_IMAGE[2] - CTC_KERNEL[1]) // CTC_KERNEL[1] + 1,
         hidden=CTC_HIDDEN, classes=CTC_CLASSES,
         label_lengths=list(CTC_LABEL_LENS), lr=CTC_LR, steps=CTC_STEPS,
         ops=len(main.global_block().ops), parameters=len(params),
         parameter_values=sum(int(np.prod(s)) for s in params),
         losses=losses, launches=counts, host_step_ms=host_ms,
         device_step_ms=device_ms,
         examples_per_s_events=CTC_BATCH * (CTC_STEPS - 1) * 1e3
         / sum(device_ms[1:]),
         examples_per_s_host=CTC_BATCH * (CTC_STEPS - 1) * 1e3
         / sum(host_ms[1:]),
         op_dispatches_per_step=box[0] / CTC_STEPS,
         host_syncs_per_step=syncs / CTC_STEPS, decode_batches=CTC_DECODE,
         decode_host_ms=dec_host_ms, decode_device_ms=dec_device_ms,
         decode_op_dispatches_per_batch=dbox[0] / CTC_DECODE,
         decode_host_syncs_per_batch=dec_syncs / CTC_DECODE,
         avg_edit_distance=float(avg[0]), instance_error=float(err[0]),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if profile_run:
        profile_step("train_ctc", lambda: exe.run(
            main, feed=feeds[0], fetch_list=[cost], scope=scope),
            {"gemm": GEMM_KEYS})
    return counts


def _conv_bn(fluid, x, filter_size, num_filters, stride, padding, groups=1,
             act="relu"):
    """``mobilenet_ssd.py``'s ``conv_bn``: a bias-free convolution (MSRA
    init, learning-rate multiplier 0.1), then batch norm with ``act``."""
    conv = fluid.layers.conv2d(
        input=x, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=groups, act=None,
        param_attr=fluid.ParamAttr(learning_rate=0.1,
                                   initializer=fluid.initializer.MSRA()),
        bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act)


def _depthwise_separable(fluid, x, filters1, filters2, groups, stride, scale):
    depthwise = _conv_bn(fluid, x, 3, int(filters1 * scale), stride, 1,
                         groups=int(groups * scale))
    return _conv_bn(fluid, depthwise, 1, int(filters2 * scale), 1, 0)


def _extra_block(fluid, x, filters1, filters2, groups, stride, scale):
    pointwise = _conv_bn(fluid, x, 1, int(filters1 * scale), 1, 0,
                         groups=int(groups * scale))
    return _conv_bn(fluid, pointwise, 3, int(filters2 * scale), stride, 1,
                    groups=int(groups * scale))


def _mobile_net(fluid, num_classes, image, image_shape, scale):
    """``mobilenet_ssd.py``'s ``mobile_net``: MobileNet v1 at ``scale``
    (300 -> 19 x 19 at module 11, 10 x 10 at 13), four extra blocks (5, 3,
    2, 1) and ``multi_box_head`` over the six maps."""
    sep = functools.partial(_depthwise_separable, fluid, scale=scale)
    tmp = _conv_bn(fluid, image, 3, int(32 * scale), 2, 1)
    for args in ((32, 64, 32, 1), (64, 128, 64, 2), (128, 128, 128, 1),
                 (128, 256, 128, 2), (256, 256, 256, 1), (256, 512, 256, 2)):
        tmp = sep(tmp, *args)
    for _ in range(5):
        tmp = sep(tmp, 512, 512, 512, 1)
    module11 = tmp
    module13 = sep(sep(tmp, 512, 1024, 512, 2), 1024, 1024, 1024, 1)
    extra = functools.partial(_extra_block, fluid, scale=scale)
    module14 = extra(module13, 256, 512, 1, 2)
    module15 = extra(module14, 128, 256, 1, 2)
    module16 = extra(module15, 128, 256, 1, 2)
    module17 = extra(module16, 64, 128, 1, 2)
    return fluid.layers.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=image, num_classes=num_classes, min_ratio=20, max_ratio=90,
        min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
        max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                       [2.0, 3.0]],
        base_size=image_shape[2], offset=0.5, flip=True, clip=True)


def _small_net(fluid, num_classes, image, image_shape, scale):
    """``tests/test_ssd.py``'s SSD: one 3 x 3 conv of stride 4 (a 4 x 4
    map) and ``multi_box_head`` with 2 priors a cell."""
    feat = fluid.layers.conv2d(image, num_filters=4, filter_size=3,
                               padding=1, stride=4)
    return fluid.layers.multi_box_head(
        inputs=[feat], image=image, base_size=image_shape[2],
        num_classes=num_classes, aspect_ratios=[[1.0]], min_sizes=[[6.0]],
        max_sizes=[[10.0]], flip=False)


def _ssd_program(fluid, net, num_classes, image_shape, scale, lr, boundaries,
                 decay):
    """An SSD trainer as upstream's ``object_detection/train.py`` builds it
    (``ssd_loss`` summed by ``reduce_sum``; RMSProp on ``piecewise_decay``
    with L2 decay) and its decode: the test clone's confidences through
    ``softmax`` and a transpose to ``[N, C, M]``, ``detection_output``
    (NMS 0.45), and ``detection_map`` (11-point, overlap 0.5, difficult
    boxes not evaluated) against the labels ``[label, difficult, box]``.
    Returns a dict of the programs and vars."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            image = layers.data(name="image", shape=list(image_shape),
                                dtype="float32")
            gt_box = layers.data(name="gt_box", shape=[4], dtype="float32",
                                 lod_level=1)
            gt_label = layers.data(name="gt_label", shape=[1], dtype="int32",
                                   lod_level=1)
            difficult = layers.data(name="gt_difficult", shape=[1],
                                    dtype="int32", lod_level=1)
            locs, confs, box, box_var = net(fluid, num_classes, image,
                                            image_shape, scale)
            loss = layers.reduce_sum(layers.ssd_loss(
                locs, confs, gt_box, gt_label, box, box_var))
            fluid.optimizer.RMSProp(
                learning_rate=layers.piecewise_decay(
                    boundaries, [lr * d for d in decay]),
                regularization=fluid.regularizer.L2Decay(SSD_L2)
            ).minimize(loss)
        test = main.clone(for_test=True)
        with fluid.program_guard(test, fluid.Program()):
            block = test.global_block()
            scores = layers.transpose(layers.softmax(block.var(confs.name)),
                                      perm=[0, 2, 1])
            nmsed = layers.detection_output(
                block.var(locs.name), scores, block.var(box.name),
                block.var(box_var.name), nms_threshold=SSD_NMS)
            labels = layers.concat([
                layers.cast(block.var(gt_label.name), "float32"),
                layers.cast(block.var(difficult.name), "float32"),
                block.var(gt_box.name)], axis=1)
            m_ap = layers.detection_map(
                nmsed, labels, num_classes, background_label=0,
                overlap_threshold=0.5, evaluate_difficult=False,
                ap_version="11point")
    decoded = next(op.output("OutputBox")[0] for op in block.ops
                   if op.type == "box_coder"
                   and op.attr("code_type") == "decode_center_size")
    return {"main": main, "startup": startup, "test": test, "loss": loss,
            "priors": int(locs.shape[1]), "nmsed": nmsed, "map": m_ap,
            "decoded": decoded, "scores": scores.name}


def mobilenet_ssd(fluid, num_classes=SSD_CLASSES, image_shape=SSD_IMAGE,
                  scale=1.0):
    """Upstream ``models/fluid/object_detection``'s MobileNet-SSD
    (``mobilenet_ssd.py``) with ``train.py``'s loss and optimizer, built
    with ``fluid`` (either package's): see :func:`_ssd_program`."""
    return _ssd_program(fluid, _mobile_net, num_classes, image_shape, scale,
                        SSD_LR, SSD_BOUNDARIES, SSD_DECAY)


def small_ssd(fluid):
    """``tests/test_ssd.py``'s small SSD (3 x 16 x 16, 3 classes, 32
    priors) with the MobileNet-SSD's loss, optimizer and decode, its
    learning rate stepping down after steps 2 and 4."""
    return _ssd_program(fluid, _small_net, SSD_SMALL_CLASSES,
                        SSD_SMALL_IMAGE, 1.0, SSD_SMALL_LR, [2, 4],
                        SSD_DECAY[:3])


def ssd_batch(rng, batch=SSD_BATCH, image_shape=SSD_IMAGE,
              num_classes=SSD_CLASSES, boxes=SSD_BOXES):
    """A synthetic VOC-shaped batch: ``boxes`` (low, high) ground-truth
    boxes an image (normalized corners, sides 0.1-0.6), classes 1 to
    ``num_classes - 1``, 10 % marked difficult; images of uniform noise
    with each box filled by its class's colour (fixed across batches), so
    the loss can fall.  The feed dict of :func:`_ssd_program`."""
    import numpy as np

    c, h, w = image_shape
    img = (rng.random_sample((batch, c, h, w)) - 0.5).astype(np.float32)
    colors = np.random.RandomState(1234).uniform(-1.5, 1.5,
                                                 (num_classes, c))
    lens = rng.randint(boxes[0], boxes[1] + 1, batch)
    n = int(lens.sum())
    side = rng.uniform(0.1, 0.6, (n, 2))
    lo = rng.uniform(0.0, 1.0, (n, 2)) * (1.0 - side)
    box = np.concatenate([lo, lo + side], 1).astype(np.float32)
    label = rng.randint(1, num_classes, n)
    difficult = rng.uniform(size=n) < SSD_DIFFICULT
    pix = (box * [w - 1, h - 1, w - 1, h - 1]).astype(int)
    for k, i in enumerate(np.repeat(np.arange(batch), lens)):
        x0, y0, x1, y1 = pix[k]
        img[i, :, y0:y1 + 1, x0:x1 + 1] += colors[label[k]][:, None, None]
    lod = [lens.tolist()]
    return {"image": img, "gt_box": (box, lod),
            "gt_label": (label.reshape(-1, 1).astype(np.int32), lod),
            "gt_difficult": (difficult.reshape(-1, 1).astype(np.int32), lod)}


def rcnn_heads(fluid, feat=RCNN_FEAT, im_hw=RCNN_IM, num_classes=RCNN_CLASSES,
                fc_dim=RCNN_FC,
               anchor_sizes=RCNN_ANCHOR_SIZES, rpn_batch=RCNN_RPN_BATCH,
               pre_nms=RCNN_PRE_NMS, post_nms=RCNN_POST_NMS,
               rois_per_im=RCNN_ROIS, use_random=True, rpn_std=0.01,
               rpn_trainable=True, rpn_only=False):
    """An RPN and an RoI head on a fed C4-shaped feature map (the
    stride-16 map of ``RCNN_IMAGES`` images of ``im_hw``), with upstream
    Faster R-CNN's RPN and RoI settings (``models/fluid/faster_rcnn``):
    ``anchor_generator`` (ratios 0.5, 1, 2, variances 1, stride 16), a 3 x
    3 conv with relu and 1 x 1 convs to the anchors' scores and deltas
    (``Normal(0, rpn_std)``), ``rpn_target_assign`` (fg 0.5, overlaps 0.7
    and 0.3) with sigmoid cross-entropy and ``smooth_l1`` (sigma 3),
    ``generate_proposals`` (NMS 0.7, min size 0),
    ``generate_proposal_labels`` (fg 0.25 at 0.5, bg [0, 0.5), weights
    0.1, 0.1, 0.2, 0.2), ``roi_pool`` 7 x 7 at 1/16, two fc of ``fc_dim``
    with relu, fc to the classes with softmax cross-entropy and to 4 x the
    classes with ``smooth_l1`` under the inside and outside weights;
    Momentum 0.9 at lr 0.01.  The samplers draw from ``RCNN_SEED``.  The
    feature map takes a grad (a trunk would sit below it).  ``rpn_std`` 0
    with ``rpn_trainable`` False holds the RPN's score and delta convs at
    zero (equal scores, proposals on the anchors): the parity runs'
    setting, where the proposals must not hang on an fp32 rounding.
    ``rpn_only`` leaves out ``generate_proposals`` and the RoI head: the
    RPN and its two losses alone, whose targets hang on the anchors and the
    ground truth only, so they compare exactly at any ``rpn_std``.  Built
    with ``fluid`` (either package's); returns a dict."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    c = feat[0]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feature = layers.data(name="feature", shape=list(feat),
                              dtype="float32", stop_gradient=False)
        im_info = layers.data(name="im_info", shape=[3], dtype="float32")
        gt_box = layers.data(name="gt_box", shape=[4], dtype="float32",
                             lod_level=1)
        gt_label = layers.data(name="gt_label", shape=[1], dtype="int32",
                               lod_level=1)
        is_crowd = layers.data(name="is_crowd", shape=[1], dtype="int32",
                               lod_level=1)

        def normal(std, trainable=True):
            return fluid.ParamAttr(trainable=trainable,
                                   initializer=fluid.initializer.Normal(
                                       0.0, std))

        def zero(trainable=True):
            return fluid.ParamAttr(trainable=trainable,
                                   initializer=fluid.initializer.Constant(0.0))

        rpn_conv = layers.conv2d(feature, num_filters=c, filter_size=3,
                                 padding=1, act="relu", param_attr=normal(
                                     0.01), bias_attr=zero())
        anchor, var = layers.anchor_generator(
            rpn_conv, anchor_sizes=list(anchor_sizes),
            aspect_ratios=[0.5, 1.0, 2.0], variance=[1.0, 1.0, 1.0, 1.0],
            stride=[16.0, 16.0])
        n_anchor = 3 * len(anchor_sizes)
        rpn_cls = layers.conv2d(rpn_conv, num_filters=n_anchor,
                                filter_size=1,
                                param_attr=normal(rpn_std, rpn_trainable),
                                bias_attr=zero(rpn_trainable))
        rpn_bbox = layers.conv2d(rpn_conv, num_filters=4 * n_anchor,
                                 filter_size=1,
                                 param_attr=normal(rpn_std, rpn_trainable),
                                 bias_attr=zero(rpn_trainable))
        sampled = labels = None
        head_losses = []
        if not rpn_only:
            rois, _ = layers.generate_proposals(
                layers.sigmoid(rpn_cls), rpn_bbox, im_info, anchor, var,
                pre_nms_top_n=pre_nms, post_nms_top_n=post_nms,
                nms_thresh=0.7, min_size=0.0, eta=1.0)
            (sampled, labels, targets, inside,
             outside) = layers.generate_proposal_labels(
                rois, gt_label, is_crowd, gt_box, im_info,
                batch_size_per_im=rois_per_im, fg_fraction=0.25,
                fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                class_nums=num_classes, use_random=use_random)
            pool = layers.roi_pool(feature, sampled, 7, 7, 1.0 / 16.0)
            # neither package's builder gives the pooled RoIs a static
            # shape, which fc needs
            pool.shape = (-1, c, 7, 7)
            head = layers.fc(layers.fc(pool, fc_dim, act="relu"), fc_dim,
                             act="relu")
            cls_score = layers.fc(head, num_classes)
            bbox_pred = layers.fc(head, 4 * num_classes)
            labels64 = layers.cast(labels, "int64")
            labels64.stop_gradient = True
            loss_cls = layers.reduce_mean(layers.softmax_with_cross_entropy(
                cls_score, labels64))
            loss_bbox = layers.reduce_mean(layers.smooth_l1(
                bbox_pred, targets, inside, outside, sigma=1.0))
            head_losses = [loss_cls, loss_bbox]
        score_pred, loc_pred, score_tgt, loc_tgt = layers.rpn_target_assign(
            layers.reshape(layers.transpose(rpn_bbox, [0, 2, 3, 1]),
                           [0, -1, 4]),
            layers.reshape(layers.transpose(rpn_cls, [0, 2, 3, 1]),
                           [0, -1, 1]),
            layers.reshape(anchor, [-1, 4]), layers.reshape(var, [-1, 4]),
            gt_box, is_crowd, im_info, rpn_batch_size_per_im=rpn_batch,
            rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
            rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
            use_random=use_random)
        score_tgt = layers.cast(score_tgt, "float32")
        score_tgt.stop_gradient = True
        loss_rpn_cls = layers.reduce_mean(
            layers.sigmoid_cross_entropy_with_logits(score_pred, score_tgt))
        # upstream divides by the sampled count, images x rpn_batch here
        loss_rpn_bbox = layers.scale(layers.reduce_sum(layers.smooth_l1(
            loc_pred, loc_tgt, sigma=3.0)), 1.0 / (RCNN_IMAGES * rpn_batch))
        losses = head_losses + [loss_rpn_cls, loss_rpn_bbox]
        loss = layers.sums(losses)
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    for op in main.global_block().ops:
        if op.type in ("rpn_target_assign", "generate_proposal_labels"):
            op.attrs["seed"] = RCNN_SEED
    return {"main": main, "startup": startup, "loss": loss,
            "losses": losses, "rois": sampled, "labels": labels,
            "params": [p.name for p in main.global_block().all_parameters()]}


def rpn_fetches(progs):
    """What the RPN parity compares, by name: the two RPN losses,
    ``rpn_target_assign``'s outputs, each parameter's grad and the feature
    map's grad."""
    ops = progs["main"].global_block().ops
    return ([v.name for v in progs["losses"]]
            + [n for op in ops if op.type == "rpn_target_assign"
               for n in op.output_arg_names]
            + [p + "@GRAD" for p in progs["params"]] + ["feature@GRAD"])


def check_rpn_step(phase, names, want, got, rtol):
    """One step's :func:`rpn_fetches` against the reference's: shapes and
    dtypes equal, integers exactly, floats within ``rtol`` of each value
    plus, for a tensor, ``rtol`` of its largest magnitude (a grad's
    near-zero entries are sums that cancel).  Returns each float's largest
    error over that scale, by name."""
    import numpy as np

    worst = {}
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), np.asarray(g)
        if w.shape != g.shape or w.dtype != g.dtype:
            raise AssertionError(f"{phase}: {name} is {g.dtype} {g.shape}, "
                                 f"the reference's {w.dtype} {w.shape}")
        if not np.issubdtype(w.dtype, np.floating):
            if not np.array_equal(w, g):
                raise AssertionError(f"{phase}: {name} differs")
            continue
        scale = np.abs(w) + (np.abs(w).max() if w.size > 1 else 0.0)
        err = np.abs(g.astype(np.float64) - w)
        if not (err <= rtol * scale).all():
            raise AssertionError(
                f"{phase}: {name} is {float(err.max())} from the "
                f"reference's (largest magnitude {float(np.abs(w).max())}, "
                f"rtol {rtol})")
        worst[name] = float((err / np.maximum(scale, 1e-30)).max())
    return worst


def rcnn_feed(rng, feat=RCNN_FEAT, im_hw=RCNN_IM, num_classes=RCNN_CLASSES,
              boxes=RCNN_BOXES):
    """For ``RCNN_IMAGES`` images: a feature map of uniform noise,
    ``im_info`` and ``boxes`` (low, high) ground-truth boxes an image (sides 32-400 pixels within the
    image), classes 1 to ``num_classes - 1``, every fifth box crowd."""
    import numpy as np

    h, w = im_hw
    lens = rng.randint(boxes[0], boxes[1] + 1, RCNN_IMAGES)
    n = int(lens.sum())
    side = rng.uniform(32.0, min(400.0, h / 2), (n, 2))
    lo = rng.uniform(0.0, 1.0, (n, 2)) * ([w - 1, h - 1] - side)
    box = np.concatenate([lo, lo + side], 1).astype(np.float32)
    lod = [lens.tolist()]
    return {"feature": (rng.random_sample((RCNN_IMAGES,) + tuple(feat))
                        - 0.5)
            .astype(np.float32),
            "im_info": np.tile(np.array([[h, w, 1.0]], np.float32),
                               (RCNN_IMAGES, 1)),
            "gt_box": (box, lod),
            "gt_label": (rng.randint(1, num_classes, (n, 1)).astype(
                np.int32), lod),
            "is_crowd": ((np.arange(n) % 5 == 4).reshape(-1, 1).astype(
                np.int32), lod)}


def _detection_program(fluid):
    """One Program through every detection op on fed inputs (the
    detection ops' parity check): ``prior_box`` (flip, clip) and
    ``anchor_generator`` over a fed map, ``iou_similarity`` of a ragged
    ground-truth batch against the priors, ``bipartite_match`` (both
    kinds), ``box_coder`` both ways, ``target_assign`` (boxes; labels with
    mined negatives), ``mine_hard_examples`` (``sample_size``),
    ``multiclass_nms`` (defaults; ``nms_eta`` < 1 in pixels;
    ``keep_top_k``), ``detection_map`` over the NMS rows, ``roi_pool`` and
    its grad, ``polygon_box_transform`` and ``flatten``.  Returns (main,
    startup, fetch names)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()

        def data(name, shape, dtype="float32", lod=0, grad=False):
            return layers.data(name=name, shape=shape, dtype=dtype,
                               lod_level=lod, stop_gradient=not grad)

        img = data("img", [3, 32, 48])
        fmap = data("fmap", [4, 4, 6], grad=True)
        gt_box = data("gt_box", [4], lod=1)
        gt_label = data("gt_label", [1], "int32", 1)
        boxes, var = layers.prior_box(fmap, img, [8.0, 16.0], [16.0, 24.0],
                                      [2.0, 3.0], flip=True, clip=True)
        n_prior = 4 * 6 * 12          # 2 sizes x (5 ratios + max) a cell
        boxes, var = (layers.reshape(t, [-1, 4]) for t in (boxes, var))
        anchors, _ = layers.anchor_generator(fmap, [16.0, 32.0],
                                             [0.5, 1.0, 2.0])
        iou = layers.iou_similarity(gt_box, boxes)
        match, dist = layers.bipartite_match(iou, "per_prediction", 0.3)
        strict, _ = layers.bipartite_match(iou)
        encoded = layers.box_coder(boxes, var, gt_box)
        tgt_box, tgt_w = layers.target_assign(encoded, match)
        cls_loss = data("cls_loss", [n_prior])
        loc_loss = data("loc_loss", [n_prior])
        neg = block.create_var(name="neg", dtype="int32")
        updated = block.create_var(name="updated", dtype="int32")
        block.append_op(
            type="mine_hard_examples",
            inputs={"ClsLoss": [cls_loss], "LocLoss": [loc_loss],
                    "MatchIndices": [match], "MatchDist": [dist]},
            outputs={"NegIndices": [neg], "UpdatedMatchIndices": [updated]},
            attrs={"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                   "mining_type": "max_negative", "sample_size": 8})
        tgt_label, label_w = layers.target_assign(
            layers.reshape(gt_label, [-1, 1, 1]), updated,
            negative_indices=neg)
        loc = data("loc", [n_prior, 4])
        scores = data("scores", [DETECTION_CLASSES, n_prior])
        decoded = layers.box_coder(boxes, var, loc, "decode_center_size")
        nmsed = layers.multiclass_nms(decoded, scores, 0.05, 40, 30, 0.45)
        pixels = layers.scale(decoded, 48.0)
        nmsed_eta = layers.multiclass_nms(pixels, scores, 0.05, -1, 12, 0.7,
                                          normalized=False, nms_eta=0.8)
        labels = layers.concat([layers.cast(gt_label, "float32"),
                                layers.cast(gt_label, "float32"), gt_box],
                               axis=1)
        m_ap = layers.detection_map(nmsed, labels, DETECTION_CLASSES,
                                    overlap_threshold=0.5,
                                    ap_version="11point")
        rois = data("rois", [4], lod=1)
        pooled = layers.roi_pool(fmap, rois, 2, 3, 0.25)
        poly = layers.polygon_box_transform(data("quad", [8, 3, 4]))
        flat = layers.flatten(fmap, axis=2)
        fluid.append_backward(layers.reduce_sum(layers.elementwise_mul(
            pooled, data("pool_w", [4, 2, 3]))))
    outs = [boxes, var, anchors, iou, match, dist, strict, encoded, tgt_box,
            tgt_w, neg, updated, tgt_label, label_w, decoded, nmsed,
            nmsed_eta, m_ap, pooled, poly, flat]
    return main, startup, [o.name for o in outs] + ["fmap@GRAD"]


def detection_feed(rng):
    """The ragged feed of :func:`_detection_program`: 3, 1 and 4
    ground-truth boxes in three images, tie-free scores and losses, RoIs
    past the map."""
    import numpy as np

    lens, n_rois, classes = (3, 1, 4), (2, 3, 1), DETECTION_CLASSES
    n, b = sum(lens), len(lens)
    side = rng.uniform(0.15, 0.5, (n, 2))
    lo = rng.uniform(0, 1, (n, 2)) * (1 - side)
    n_prior = 4 * 6 * 12
    order = rng.permutation(b * classes * n_prior).astype(np.float32)
    rois = rng.uniform(0, 40, (sum(n_rois), 4)).astype(np.float32)
    rois[:, 2:] = rois[:, :2] + rng.uniform(2, 30, (len(rois), 2))
    return {"img": rng.standard_normal((b, 3, 32, 48)).astype(np.float32),
            "fmap": rng.standard_normal((b, 4, 4, 6)).astype(np.float32),
            "gt_box": (np.concatenate([lo, lo + side], 1).astype(np.float32),
                       [list(lens)]),
            "gt_label": (rng.randint(1, classes, (n, 1)).astype(np.int32),
                         [list(lens)]),
            "cls_loss": rng.permutation(b * n_prior).reshape(b, n_prior)
            .astype(np.float32) / 50.0,
            "loc_loss": rng.uniform(0, 1, (b, n_prior)).astype(np.float32),
            "loc": (rng.standard_normal((b, n_prior, 4)) * 0.5).astype(
                np.float32),
            "scores": ((order + 1) / (len(order) + 1)).reshape(
                b, classes, n_prior),
            "rois": (rois, [list(n_rois)]),
            "quad": rng.standard_normal((b, 8, 3, 4)).astype(np.float32),
            "pool_w": rng.standard_normal((sum(n_rois), 4, 2, 3)).astype(
                np.float32)}


def detection_host_ops(program):
    """The detection host ops of ``program``, by type."""
    from paddle_tpu_torch.ops import registry

    return sorted({op.type for op in program.global_block().ops
                   if op.type in registry.EAGER_OPS})


def dcgan_programs(fluid, image=DCGAN_IMAGE, base=DCGAN_BASE, feed_noise=False,
                   dtype="float32"):
    """DCGAN's two training Programs built with ``fluid`` (either
    package's), sharing one startup and their parameters by ``ParamAttr``
    name: ``d`` runs G (under ``stop_gradient``: no grad reaches G) and D
    on the real batch and on G's images, its loss the two sigmoid
    cross-entropies against ``fill_constant_batch_size_like`` labels 1 and
    0, Adam over D's parameters; ``g`` runs G and D, its loss G's images
    against label 1, Adam over G's parameters.  The noise is drawn in each
    Program by ``uniform_random_batch_size_like`` from the real batch, or
    fed (``feed_noise``).  ``dtype``: of the images, the noise, the labels
    and so of every parameter.  Generator: fc to ``(image / 16)²·8·base``,
    batch_norm and relu, three ``conv2d_transpose`` halving the width with
    batch_norm and relu, one to 3 channels and tanh; discriminator: four
    stride-2 convs doubling it from ``base`` (batch_norm on all but the
    first) with leaky_relu 0.2, fc to one logit.  The convs and G's fc
    carry no bias (a batch_norm follows, which would take out its grad;
    as in dcgan.torch).  Returns a dict of the
    programs and vars."""
    layers = fluid.layers
    s0 = image // 16
    init = fluid.initializer.Normal(0.0, DCGAN_STD)

    def attr(name):
        return fluid.ParamAttr(name=name, initializer=init)

    def bn(x, name, act):
        return layers.batch_norm(
            x, act=act, param_attr=fluid.ParamAttr(name=name + ".scale"),
            bias_attr=fluid.ParamAttr(name=name + ".bias"),
            moving_mean_name=name + ".mean",
            moving_variance_name=name + ".var")

    def generator(z):
        h = layers.fc(z, s0 * s0 * 8 * base, param_attr=attr("g_fc.w"),
                      bias_attr=False)
        h = bn(layers.reshape(h, [-1, 8 * base, s0, s0]), "g_bn0", "relu")
        for i, width in enumerate((4 * base, 2 * base, base, 3)):
            h = layers.conv2d_transpose(h, width, filter_size=4, stride=2,
                                        padding=1,
                                        param_attr=attr(f"g_deconv{i}.w"),
                                        bias_attr=False)
            h = bn(h, f"g_bn{i + 1}", "relu") if width != 3 else \
                layers.tanh(h)
        return h

    def discriminator(x):
        h = x
        for i, width in enumerate((base, 2 * base, 4 * base, 8 * base)):
            h = layers.conv2d(h, width, 4, stride=2, padding=1,
                              param_attr=attr(f"d_conv{i}.w"),
                              bias_attr=False)
            if i:
                h = bn(h, f"d_bn{i}", None)
            h = layers.leaky_relu(h, alpha=0.2)
        return layers.fc(h, 1, param_attr=attr("d_fc.w"),
                         bias_attr=fluid.ParamAttr(name="d_fc.b"))

    def bce(logit, label):
        target = layers.fill_constant_batch_size_like(logit, [-1, 1],
                                                      dtype, label)
        return layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, target))

    def noise_of(img):
        if feed_noise:
            return layers.data(name="noise", shape=[DCGAN_NZ], dtype=dtype)
        helper = fluid.layer_helper.LayerHelper("noise")
        z = helper.create_variable_for_type_inference(dtype)
        z.shape = (-1, DCGAN_NZ)
        helper.append_op(
            type="uniform_random_batch_size_like", inputs={"Input": [img]},
            outputs={"Out": [z]},
            attrs={"shape": [-1, DCGAN_NZ], "input_dim_idx": 0,
                   "output_dim_idx": 0, "min": -1.0, "max": 1.0,
                   "dtype": dtype, "seed": 0})
        return z

    d_main, g_main, startup = fluid.Program(), fluid.Program(), \
        fluid.Program()
    out = {"startup": startup, "d": d_main, "g": g_main}
    with fluid.unique_name.guard():
        with fluid.program_guard(d_main, startup):
            img = layers.data(name="img", shape=[3, image, image],
                              dtype=dtype)
            z = noise_of(img)
            fake = generator(z)
            fake.stop_gradient = True
            d_loss = layers.elementwise_add(bce(discriminator(img), 1.0),
                                            bce(discriminator(fake), 0.0))
            d_params = [p.name for p in d_main.global_block().all_parameters()
                        if p.name.startswith("d_")]
            fluid.optimizer.Adam(DCGAN_LR, beta1=DCGAN_BETA1).minimize(
                d_loss, parameter_list=d_params)
            out.update(d_loss=d_loss.name, d_noise=z.name, d_fake=fake.name,
                       d_params=d_params)
        with fluid.program_guard(g_main, startup):
            img = layers.data(name="img", shape=[3, image, image],
                              dtype=dtype)
            z = noise_of(img)
            fake = generator(z)
            g_loss = bce(discriminator(fake), 1.0)
            g_params = [p.name for p in g_main.global_block().all_parameters()
                        if p.name.startswith("g_")]
            fluid.optimizer.Adam(DCGAN_LR, beta1=DCGAN_BETA1).minimize(
                g_loss, parameter_list=g_params)
            out.update(g_loss=g_loss.name, g_noise=z.name, g_fake=fake.name,
                       g_params=g_params)
    return out


def norm_rel_err(got, want):
    """``‖got − want‖ / ‖want‖`` over a whole tensor (0 for two zero
    tensors), in float64."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(got - want))
    return num / den if den else num


ADAM_SLOTS = ("Param", "Moment1", "Moment2", "LearningRate", "Beta1Pow",
              "Beta2Pow")
ADAM_OUT = ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow")


def adam_slots(program):
    """Each adam op of ``program`` by its parameter's name: ``(vars, beta1,
    beta2, epsilon)``, ``vars`` the op's input names by slot."""
    out = {}
    for op in program.global_block().ops:
        if op.type == "adam":
            names = {slot: op.inputs[slot][0] for slot in ADAM_SLOTS}
            out[names["Param"]] = (names, op.attrs.get("beta1", 0.9),
                                   op.attrs.get("beta2", 0.999),
                                   op.attrs.get("epsilon", 1e-8))
    return out


def adam_step_check(slots, before, want, got, want_grads, got_grads, rtol):
    """Hold one training step's state ``got`` against ``want``, both run
    from the state ``before`` (``{name: ndarray}``, every persistable),
    where an adam op (``slots``: :func:`adam_slots`) updated each
    parameter of ``want_grads`` / ``got_grads`` (``{param: grad}``).  Each
    check holds one tensor in the 2-norm (:func:`norm_rel_err`) within
    ``rtol``:

    - ``grad``: each updated parameter's gradient;
    - ``adam``: ``got``'s parameter, moments and beta pows against the
      plain Adam (``fused.adam_group_ref``, float32 on the CPU) run from
      ``before`` on ``got``'s own gradient;
    - ``state``: every persistable of ``want`` (parameters, moments, beta
      pows, batch-norm statistics).  A second moment is held by its square
      root, in the gradient's units: it is the gradient squared, which
      doubles the gradient's relative error.  Of an updated parameter the
      elements are left out whose grad in ``want`` is not exactly 0 and
      where moving that grad by ``rtol`` of the tensor's largest |grad|
      would move the element's Adam update ``lr_t·m/(√v + ε)`` by more
      than the whole tensor's tolerance, ``rtol·‖p‖``.  Where √v is near
      ε the update follows the gradient's own rounding (a grad of 3e-8
      against ε/√(1 − β2) = 3.2e-7 at the first step), and a tensor that
      starts at 0, a batch norm's bias, has only about lr·√n of norm to
      absorb it.  These elements are still held by ``adam`` and
      ``grad``.

    Returns each check's worst tensor, the count of left-out elements by
    tensor, and those of them that parted by more than an even share of
    the tolerance, ``rtol·‖p‖/√n`` (``parted``), with both gradients and
    parameters; raises AssertionError naming every failure (a NaN
    fails)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import fused

    fails, errs, masks, left_out, parted = [], {}, {}, {}, []

    def held(check, name, err):
        errs.setdefault(check, {})[name] = err
        if not err <= rtol:
            fails.append(f"{check} {name}: {err} (rtol {rtol})")

    for p, g_want in want_grads.items():
        names, b1, b2, eps = slots[p]
        held("grad", p, norm_rel_err(got_grads[p], g_want))
        t = [torch.from_numpy(np.array(before[names[s]])) for s in ADAM_SLOTS]
        new = fused.adam_group_ref(
            [t[0]], [torch.from_numpy(np.array(got_grads[p]))], *(
                [x] for x in t[1:]), b1, b2, eps)[0]
        for slot, v in zip(ADAM_OUT, new):
            held("adam", names[slot], norm_rel_err(got[names[slot]],
                                                   v.numpy()))
        m1, m2, lr, b1p, b2p = (np.asarray(before[names[s]], np.float64)
                                for s in ADAM_SLOTS[1:])
        lr_t = lr * np.sqrt(1.0 - b2p) / (1.0 - b1p)

        def update(g):
            return lr_t * (b1 * m1 + (1.0 - b1) * g) / (
                np.sqrt(b2 * m2 + (1.0 - b2) * g * g) + eps)

        g = np.asarray(g_want, np.float64)
        a = rtol * float(np.abs(g).max(initial=0.0))
        u = update(g)
        moved = np.maximum(np.abs(update(g + a) - u),
                           np.abs(update(g - a) - u))
        w = np.asarray(want[p], np.float64)
        limit = rtol * np.linalg.norm(w)
        masks[p] = (moved > limit) & (g != 0)
        if masks[p].any():
            left_out[p] = int(masks[p].sum())
        far = masks[p] & (np.abs(np.asarray(got[p], np.float64) - w) >
                          limit / np.sqrt(w.size))
        parted += [{"name": p, "index": int(i),
                    "grad_want": float(g.flat[i]),
                    "grad_got": float(got_grads[p].flat[i]),
                    "grad_largest": a / rtol,
                    "before": float(before[p].flat[i]),
                    "want": float(w.flat[i]), "got": float(got[p].flat[i]),
                    "tensor_limit": limit}
                   for i in np.flatnonzero(far)]
    second = {slots[p][0]["Moment2"] for p in want_grads}
    for n in want:
        w, g = np.asarray(want[n], np.float64), np.asarray(got[n], np.float64)
        if n in masks:
            w, g = w[~masks[n]], g[~masks[n]]
        elif n in second:
            w, g = np.sqrt(w), np.sqrt(g)
        held("state", n, norm_rel_err(g, w))
    if fails:
        raise AssertionError("; ".join(fails))
    return {"worst": {check: max(e.items(), key=lambda kv: kv[1])
                      for check, e in errs.items()},
            "left_out": left_out, "parted": parted}


def dcgan_batch(rng, batch=DCGAN_BATCH, image=DCGAN_IMAGE):
    """A synthetic LSUN-shaped batch: ``[batch, 3, image, image]`` images
    in [-1, 1], each a 4 x 4 field of colour blocks with noise over it."""
    import numpy as np

    coarse = np.repeat(np.repeat(
        rng.uniform(-1, 1, (batch, 3, 4, 4)).astype(np.float32),
        image // 4, 2), image // 4, 3)
    img = 0.8 * coarse + 0.2 * rng.uniform(-1, 1, coarse.shape)
    return np.clip(img, -1, 1).astype(np.float32)


def phase_train_ssd(profile_run=False):
    """MobileNet-SSD at upstream's widths on the card (3 x 300 x 300, 21
    classes, batch 64, ``ssd_loss`` summed, RMSProp on ``piecewise_decay``
    with L2 decay, fp32, eager): ``SSD_STEPS`` steps, each on a fresh
    synthetic batch: the prior count (1,917), finite losses, no host sync,
    exactly ``SSD_XENT_PER_STEP`` xent launches a step (``ssd_loss``'s two
    softmax cross-entropies: the mining one forward only, the loss one
    forward, again in its generic grad, and backward) and no other
    kernel's (RMSProp is plain PyTorch); images/s and step ms (CUDA events
    and host clock), op dispatches and ``bipartite_match`` loop iterations
    a step, peak allocated; with ``--profile`` one more step under the
    profiler.  Returns (launches, programs, executor, scope)."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import detection_ops

    progs = mobilenet_ssd(fluid)
    if progs["priors"] != SSD_PRIORS:
        raise AssertionError(f"train_ssd: {progs['priors']} priors, "
                             f"expected {SSD_PRIORS}")
    main, loss = progs["main"], progs["loss"]
    params = main.global_block().all_parameters()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    rng = np.random.RandomState(0)
    feeds = [ssd_batch(rng) for _ in range(SSD_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_host_syncs()
    with counting_dispatches() as box:
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feeds, [loss], scope, SSD_STEPS)
    syncs = host_syncs()
    iterations = detection_ops.stats["match_iterations"]
    check_launches("train_ssd", counts, SSD_XENT_PER_STEP, SSD_STEPS)
    counts.update(check_xent_layout("train_ssd", "narrow"))
    losses = [float(o[0].reshape(-1)[0]) for o in out]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_ssd: non-finite losses {losses}")
    if syncs:
        raise AssertionError(f"train_ssd: {syncs} host syncs in "
                             f"{SSD_STEPS} training steps")
    emit("train_ssd", model="MobileNet-SSD (object_detection/"
         "mobilenet_ssd.py, train.py)", data="synthetic VOC-shaped",
         image=list(SSD_IMAGE), classes=SSD_CLASSES, batch=SSD_BATCH,
         steps=SSD_STEPS, priors=progs["priors"],
         ops=len(main.global_block().ops), parameters=len(params),
         parameter_values=sum(int(np.prod(p.shape)) for p in params),
         gt_boxes=[int(f["gt_box"][0].shape[0]) for f in feeds],
         losses=losses, launches=counts, host_step_ms=host_ms,
         device_step_ms=device_ms,
         images_per_s_events=SSD_BATCH * (SSD_STEPS - 1) * 1e3
         / sum(device_ms[1:]),
         images_per_s_host=SSD_BATCH * (SSD_STEPS - 1) * 1e3
         / sum(host_ms[1:]),
         op_dispatches_per_step=box[0] / SSD_STEPS,
         host_syncs_per_step=syncs / SSD_STEPS,
         match_iterations_per_step=iterations / SSD_STEPS,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if profile_run:
        profile_step("train_ssd", lambda: exe.run(
            main, feed=feeds[0], fetch_list=[loss], scope=scope),
            {"conv": CONV_KEYS, "gemm": GEMM_KEYS, "xent": ("xent_",)})
    return counts, progs, exe, scope


def nms_program(fluid, test):
    """The ``multiclass_nms`` and ``detection_map`` ops of ``test`` (their
    attrs) over fed boxes ``[N, M, 4]``, scores ``[N, C, M]`` and labels:
    (program, output names)."""
    layers = fluid.layers
    ops = {op.type: op for op in test.global_block().ops}
    nms, dmap = ops["multiclass_nms"], ops["detection_map"]
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        block = main.global_block()
        names = {}
        for slot, var in (("BBoxes", "nms_boxes"), ("Scores", "nms_scores"),
                          ("Label", "map_labels")):
            names[slot] = layers.data(name=var, shape=[1], dtype="float32",
                                      lod_level=int(slot == "Label"))
        out = block.create_var(name="nms_out", dtype="float32")
        block.append_op(type="multiclass_nms",
                        inputs={"BBoxes": [names["BBoxes"]],
                                "Scores": [names["Scores"]]},
                        outputs={"Out": [out]}, attrs=dict(nms.attrs))
        m_ap = block.create_var(name="nms_map", dtype="float32")
        block.append_op(
            type="detection_map",
            inputs={"DetectRes": [out], "Label": [names["Label"]]},
            outputs={"MAP": [m_ap], **{
                s: [block.create_var(name=f"nms_{s}", dtype="float32")]
                for s in ("AccumPosCount", "AccumTruePos",
                          "AccumFalsePos")}},
            attrs=dict(dmap.attrs))
    return main, [out.name, m_ap.name]


def first_row_difference(got, want):
    """The first row where two ``[rows, 6]`` NMS outputs differ (or their
    counts), for the failure message."""
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        if not np.allclose(g, w, rtol=0.0, atol=SSD_DECODE_ATOL):
            return {"row": i, "card": g.tolist(), "cpu": w.tolist()}
    return {"rows": [len(got), len(want)]}


def _iou_slack(a, b, delta):
    """``IoU(a, b)`` of two normalized ``[x1, y1, x2, y2]`` boxes, and how
    far it can move when each coordinate of ``a`` moves by up to
    ``delta`` (first order, doubled)."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    union = area_a + max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1]) - inter
    if union <= 0.0:
        return 0.0, 0.0
    iou = inter / union
    d_inter = 2 * delta * (iw + ih) + 4 * delta ** 2
    d_union = 2 * delta * (a[2] - a[0] + a[3] - a[1]) + 4 * delta ** 2 \
        + d_inter
    return iou, 2 * (d_inter + iou * d_union) / max(union - d_union, 1e-12)


def compare_decodes(card, cpu, scores, attrs, atol):
    """Two ``multiclass_nms`` outputs of one batch (``(rows [R, 6], LoD
    offsets)`` each) whose inputs agree within ``atol``, held as
    tolerance-matched multisets per image: rows of one label whose score
    and box are within ``atol`` pair up.  A row left unpaired on one side
    must be a near-tie on the other, from that side's rows and scores
    (``scores``: ``[N, C, M]`` each, card then CPU): its score within
    ``2·atol`` of that side's lowest kept score when ``keep_top_k`` rows
    are kept, within ``atol`` of ``score_threshold``, or within ``atol`` of
    its class's ``nms_top_k``-th score; or a kept row of its label there
    overlaps it past the NMS threshold (allowing for the box error) with a
    score within ``2·atol`` of its own, or with an IoU within the box
    error of the threshold, or is itself unpaired with a higher score (a
    chain that ends at one of the other causes).  Paired rows may come in
    another order only where their scores are within ``2·atol``.  Raises
    on anything else; returns the counts by cause."""
    import numpy as np

    thr, keep_k = attrs["nms_threshold"], attrs["keep_top_k"]
    top_k, s_thr = attrs["nms_top_k"], attrs["score_threshold"]
    sides = []
    for rows, lod in (card, cpu):
        rows = np.asarray(rows, np.float64)
        if rows.shape[1] != 6:         # the [[-1]] row: nothing kept
            rows = np.zeros((0, 6))
            lod = (0,) * len(lod)
        sides.append((rows, lod))
    report = {"rows": [len(sides[0][0]), len(sides[1][0])], "paired": 0,
              "reordered_pairs": 0, "unpaired": [0, 0],
              "keep_top_k": 0, "score_threshold": 0, "nms_top_k": 0,
              "nms_near_tie": 0, "nms_iou_near_threshold": 0,
              "nms_chain": 0}
    n = len(sides[0][1]) - 1
    for i in range(n):
        img = [rows[lod[i]:lod[i + 1]] for rows, lod in sides]
        a, b = img
        cost = np.full((len(a), len(b)), np.inf)
        if len(a) and len(b):
            same = a[:, None, 0] == b[None, :, 0]
            diff = np.abs(a[:, None, 1:] - b[None, :, 1:]).max(-1)
            cost = np.where(same, diff, np.inf)
        pair_b = np.full(len(a), -1)
        taken = np.zeros(len(b), bool)
        for j in np.argsort(cost.min(1) if len(b) else np.zeros(len(a)),
                            kind="stable"):
            if not len(b):
                break
            k = int(np.argmin(np.where(taken, np.inf, cost[j])))
            if cost[j, k] <= atol and not taken[k]:
                pair_b[j], taken[k] = k, True
        paired = np.flatnonzero(pair_b >= 0)
        report["paired"] += len(paired)
        # pairs that come in the other order must be near-ties
        pb, sa = pair_b[paired], a[paired, 1]
        inv = (pb[:, None] > pb[None, :]) & np.triu(
            np.ones((len(pb), len(pb)), bool), 1)
        far = inv & (np.abs(sa[:, None] - sa[None, :]) > 2 * atol)
        if far.any():
            j, k = np.argwhere(far)[0]
            raise AssertionError(
                f"decodes: image {i}: rows {a[paired[j]].tolist()} and "
                f"{a[paired[k]].tolist()} come in the other order on the "
                f"CPU, and their scores are more than {2 * atol} apart")
        report["reordered_pairs"] += int(inv.sum())
        unpaired = [np.flatnonzero(pair_b < 0), np.flatnonzero(~taken)]
        for side in (0, 1):
            mine, other = img[side], img[1 - side]
            other_unpaired = set(unpaired[1 - side].tolist())
            other_scores = np.asarray(scores[1 - side][i], np.float64)
            report["unpaired"][side] += len(unpaired[side])
            for j in unpaired[side]:
                u = mine[j]
                c, s = int(u[0]), u[1]
                cause = None
                if keep_k > -1 and len(other) >= keep_k and \
                        s <= other[:, 1].min() + 2 * atol:
                    cause = "keep_top_k"
                elif s <= s_thr + atol:
                    cause = "score_threshold"
                elif -1 < top_k < other_scores.shape[1] and \
                        s <= np.sort(other_scores[c])[-top_k] + atol:
                    cause = "nms_top_k"
                else:
                    for k, v in enumerate(other):
                        if v[0] != c or v[1] < s - 2 * atol:
                            continue
                        iou, slack = _iou_slack(u[2:], v[2:], atol)
                        if iou + slack <= thr:
                            continue
                        if abs(v[1] - s) <= 2 * atol:
                            cause = "nms_near_tie"
                        elif iou - slack <= thr:
                            cause = "nms_iou_near_threshold"
                        elif k in other_unpaired:
                            cause = "nms_chain"
                        if cause:
                            break
                if cause is None:
                    raise AssertionError(
                        f"decodes: image {i}: row {u.tolist()} is kept on "
                        f"the {('card', 'CPU')[side]} only, and no near-tie "
                        f"on the {('CPU', 'card')[side]} explains it")
                report[cause] += 1
    return report


def phase_detect_ssd(progs, exe, scope, profile_run=False):
    """Decode ``SSD_DECODE`` fresh batches of 64 with phase 48's trained
    weights through the test clone (softmax, transpose, ``detection_output``
    with NMS 0.45, ``detection_map`` 11-point): ms a batch (CUDA events and
    host clock), op dispatches and host syncs a batch (the host ops' reads:
    ``multiclass_nms``' kept counts and ``detection_map``'s labels),
    detections kept and mAP.  Then the same decode on a CPU scope holding
    the same weights: its decoded boxes and softmax scores within
    ``SSD_DECODE_ATOL`` of the card's; and the CPU's ``multiclass_nms`` and
    ``detection_map`` over the card's boxes and scores: rows and LoD equal
    to the card's, boxes and scores within ``SSD_DECODE_ATOL``, the same
    mAP (the first differing row printed on a failure); that NMS and mAP
    timed on each device (host clock, the feed's copy included).  The
    whole CPU decode is held to the card's by :func:`compare_decodes`: fp32
    convolutions and softmax on two devices part by ulps, which reorders
    near-equal scores among the 1,917 x 20 candidates, so the rows are
    held per image as multisets, every unpaired row shown to be a near-tie
    and its cause counted; the rows equal in place and the CPU decode's
    mAP are printed.  With ``--profile`` one more decode batch under the
    profiler."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lod_tensor import LoDTensor
    from paddle_tpu_torch.models.params import load_reference_params

    test = progs["test"]
    labels = next(op.input("Label")[0] for op in test.global_block().ops
                  if op.type == "detection_map")
    fetches = [progs["decoded"], progs["scores"], progs["nmsed"].name,
               progs["map"].name, labels]
    rng = np.random.RandomState(1)
    feeds = [ssd_batch(rng) for _ in range(SSD_DECODE)]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    card, host_ms, device_ms = [], [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_host_syncs()
    with counting_dispatches() as box:
        for feed in feeds:
            t0 = time.perf_counter()
            start.record()
            card.append(exe.run(test, feed=feed, fetch_list=fetches,
                                scope=scope, return_numpy=False))
            end.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
    syncs = host_syncs()
    counts = launch_counts()
    check_launches("detect_ssd", counts, {}, SSD_DECODE)

    def host(v):
        return np.asarray(v) if isinstance(v, LoDTensor) \
            else v.detach().cpu().numpy()

    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu_exe.run(progs["startup"], scope=cpu_scope)
    load_reference_params(cpu_scope, {
        v.name: scope.get(v.name).detach().cpu().numpy()
        for v in progs["startup"].list_vars() if v.persistable},
        fluid.CPUPlace())
    nms_main, nms_fetch = nms_program(fluid, test)
    nms_attrs = {k: v for k, v in next(
        op for op in test.global_block().ops
        if op.type == "multiclass_nms").attrs.items()
        if not k.startswith("op_")}
    report = {"input_max_abs_err": 0.0, "cpu_decode_rows_equal": [],
              "cpu_decode": [], "cpu_decode_map": []}
    kept, maps, nms_ms = [], [], {"cpu": [], "card": []}
    for feed, got in zip(feeds, card):
        mine = cpu_exe.run(test, feed=feed, fetch_list=fetches,
                           scope=cpu_scope, return_numpy=False)
        for name, g, c in zip(fetches[:2], got, mine):
            err = float(np.abs(host(g) - host(c)).max())
            if err > SSD_DECODE_ATOL:
                raise AssertionError(f"detect_ssd: {name} on the card is "
                                     f"{err} from the CPU's")
            report["input_max_abs_err"] = max(report["input_max_abs_err"],
                                              err)
        rows, lod = host(got[2]), got[2].lod()
        both = rows.shape == host(mine[2]).shape and lod == mine[2].lod()
        same = int(((np.abs(rows - host(mine[2])) <= SSD_DECODE_ATOL)
                    .all(1)).sum()) if both else 0
        report["cpu_decode_rows_equal"].append([same, len(rows)])
        # the whole CPU decode: the same rows per image up to near-ties
        report["cpu_decode"].append(compare_decodes(
            (rows, lod[0]), (host(mine[2]), mine[2].lod()[0]),
            (host(got[1]), host(mine[1])), nms_attrs, SSD_DECODE_ATOL))
        report["cpu_decode_map"].append(float(host(mine[3])[0]))
        # the CPU's NMS and mAP over the card's own boxes and scores, then
        # the same two ops on the card, each timed
        label = got[4]
        nms_feed = {"nms_boxes": host(got[0]), "nms_scores": host(got[1]),
                    "map_labels": LoDTensor(host(label), label.lod())}
        t0 = time.perf_counter()
        nms_rows, nms_map = cpu_exe.run(
            nms_main, feed=nms_feed, fetch_list=nms_fetch,
            scope=fluid.Scope(), return_numpy=False)
        nms_ms["cpu"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(nms_main, feed=nms_feed, fetch_list=nms_fetch,
                scope=fluid.Scope(), return_numpy=False)
        torch.cuda.synchronize()
        nms_ms["card"].append((time.perf_counter() - t0) * 1e3)
        if nms_rows.lod() != lod or host(nms_rows).shape != rows.shape or \
                not np.array_equal(host(nms_rows)[:, 0], rows[:, 0]) or \
                not np.allclose(host(nms_rows), rows, rtol=0.0,
                                atol=SSD_DECODE_ATOL):
            raise AssertionError(
                f"detect_ssd: the CPU's NMS over the card's inputs differs: "
                f"{first_row_difference(rows, host(nms_rows))}, LoD "
                f"{nms_rows.lod()} against {lod}")
        if host(nms_map)[0] != host(got[3])[0]:
            raise AssertionError(f"detect_ssd: mAP {host(got[3])} on the "
                                 f"card, {host(nms_map)} on the CPU")
        kept.append(int(rows.shape[0]) if rows.shape[1] == 6 else 0)
        maps.append(float(host(got[3])[0]))
    emit("detect_ssd", batches=SSD_DECODE, batch=SSD_BATCH, nms=nms_attrs,
         host_ops=detection_host_ops(test), host_ms=host_ms,
         device_ms=device_ms, op_dispatches_per_batch=box[0] / SSD_DECODE,
         host_syncs_per_batch=syncs / SSD_DECODE, launches=counts,
         detections_kept=kept, map_11point=maps,
         cpu_nms_on_card_inputs="rows, LoD and mAP equal",
         cpu_decode_held=("per image, the same rows as tolerance-matched "
                          "multisets; each unpaired row a near-tie, "
                          "counted by cause"),
         nms_and_map_host_ms=nms_ms, atol=SSD_DECODE_ATOL, **report)
    if profile_run:
        profile_step("detect_ssd", lambda: exe.run(
            test, feed=feeds[0], fetch_list=fetches[2:4], scope=scope),
            {"conv": CONV_KEYS})


def phase_train_ssd_parity():
    """Card against CPU: the small SSD (``small_ssd``: ``tests/test_ssd.py``'s
    shape under MobileNet-SSD's loss and optimizer) from one state,
    ``SSD_PARITY_STEPS`` steps on a ragged batch (losses rtol 1e-5 at step
    0, 1e-4 after; ``SSD_XENT_PER_STEP`` xent launches a step); then every
    detection op on fed inputs over a ragged ground-truth batch
    (:func:`_detection_program`): outputs, LoDs and the map's grad within
    ``SEQ_PARITY_TOL``, integer outputs equal."""
    import numpy as np

    from paddle_tpu_torch import fluid

    progs = small_ssd(fluid)
    feed = ssd_batch(np.random.RandomState(3), batch=SSD_SMALL_BATCH,
                     image_shape=SSD_SMALL_IMAGE,
                     num_classes=SSD_SMALL_CLASSES, boxes=(1, 3))
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    (cpu, card), counts, _ = parity_runs(
        (progs["main"], progs["startup"], progs["loss"]), feed,
        SSD_PARITY_STEPS, places)
    check_launches("train_ssd_parity", counts, SSD_XENT_PER_STEP,
                   SSD_PARITY_STEPS)
    counts.update(check_xent_layout("train_ssd_parity", "narrow"))
    tol = np.array([1e-5] + [1e-4] * (SSD_PARITY_STEPS - 1))
    rel = check_parity("train_ssd_parity", cpu, card, tol)
    main, startup, fetches = _detection_program(fluid)
    worst = compare_places("train_ssd_parity ops", main, startup,
                           detection_feed(np.random.RandomState(5)), fetches,
                           places)
    rtol, atol = SEQ_PARITY_TOL
    emit("train_ssd_parity", priors=progs["priors"], steps=SSD_PARITY_STEPS,
         gt_lengths=feed["gt_box"][1][0], cpu_losses=cpu.tolist(),
         card_losses=card.tolist(), rel_err=rel, rtol=tol.tolist(),
         launches=counts, op_types=sorted(
             {op.type for op in main.global_block().ops}),
         op_fetches=len(fetches), op_max_abs_err=max(worst.values()),
         op_worst=max(worst, key=worst.get),
         op_tol={"rtol": rtol, "atol": atol})


def phase_train_rcnn(profile_run=False):
    """The RPN and RoI head of :func:`rcnn_heads` at Faster R-CNN's
    widths on the card (2 images of 800 x 1344: a 1024 x 50 x 84 C4 map,
    63,000 anchors an image, 12,000 / 2,000 proposals, 512 RoIs an image,
    81 classes): ``RCNN_STEPS`` steps on fresh batches, samplers seeded:
    finite losses, exactly 1 momentum launch for its 14 tensors and
    ``RCNN_XENT_PER_STEP`` xent launches a step and no other kernel's;
    RoIs and foreground RoIs a step, step ms (CUDA events and host clock),
    op dispatches and host syncs a step (the host ops' reads of their
    inputs), peak allocated; with ``--profile`` one more step under the
    profiler.  Returns the launches."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    progs = rcnn_heads(fluid)
    main, loss = progs["main"], progs["loss"]
    trainable_shapes(main, RCNN_MOMENTUM_TENSORS)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    rng = np.random.RandomState(0)
    feeds = [rcnn_feed(rng) for _ in range(RCNN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_host_syncs()
    with counting_dispatches() as box:
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feeds, [loss, progs["labels"]], scope, RCNN_STEPS)
    syncs = host_syncs()
    check_launches("train_rcnn", counts,
                   {"momentum": MOMENTUM_PER_STEP,
                    "momentum_tensors": RCNN_MOMENTUM_TENSORS,
                    **RCNN_XENT_PER_STEP}, RCNN_STEPS)
    counts.update(check_xent_layout("train_rcnn", "narrow"))
    losses = [float(o[0].reshape(-1)[0]) for o in out]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_rcnn: non-finite losses {losses}")
    emit("train_rcnn", feature=[RCNN_IMAGES, *RCNN_FEAT],
         image=list(RCNN_IM), classes=RCNN_CLASSES,
         anchors_per_image=3 * len(RCNN_ANCHOR_SIZES) * RCNN_FEAT[1]
         * RCNN_FEAT[2], pre_nms=RCNN_PRE_NMS, post_nms=RCNN_POST_NMS,
         rois_per_image=RCNN_ROIS, steps=RCNN_STEPS,
         gt_boxes=[int(f["gt_box"][0].shape[0]) for f in feeds],
         losses=losses, launches=counts,
         rois_per_step=[int(o[1].shape[0]) for o in out],
         fg_rois_per_step=[int((o[1] > 0).sum()) for o in out],
         host_step_ms=host_ms, device_step_ms=device_ms,
         op_dispatches_per_step=box[0] / RCNN_STEPS,
         host_syncs_per_step=syncs / RCNN_STEPS,
         host_syncs_are=("one read each of generate_proposals', "
                         "rpn_target_assign's, generate_proposal_labels' "
                         "and roi_pool's inputs"),
         host_ops=detection_host_ops(main),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if profile_run:
        profile_step("train_rcnn", lambda: exe.run(
            main, feed=feeds[0], fetch_list=[loss], scope=scope),
            {"conv": CONV_KEYS, "gemm": GEMM_KEYS, "xent": ("xent_",)})
    return counts


def phase_rcnn_parity():
    """Card against CPU: :func:`rcnn_heads` at ``RCNN_SMALL`` (8 channels,
    a 12 x 16 map, the RPN's score and delta convs held at zero,
    ``use_random`` False) from one state: ``RCNN_PARITY_STEPS`` steps'
    losses (rtol 1e-5 at step 0, 1e-4 after; 1 momentum launch a step for
    its 10 trainable tensors);
    then one step's outputs of every op of the slice on it (anchors,
    proposals, the RPN targets, the sampled RoIs and their targets, the
    pooled features, the four losses and the feature map's grad) within
    ``SEQ_PARITY_TOL``, integer outputs and LoDs equal; then the RPN alone
    with its convs drawn and trained (:func:`phase_rpn_parity`)."""
    import numpy as np

    from paddle_tpu_torch import fluid

    progs = rcnn_heads(fluid, **RCNN_SMALL)
    feed = rcnn_feed(np.random.RandomState(7), **RCNN_SMALL_FEED)
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    (cpu, card), counts, _ = parity_runs(
        (progs["main"], progs["startup"], progs["loss"]), feed,
        RCNN_PARITY_STEPS, places)
    check_launches("rcnn_parity", counts,
                   {"momentum": MOMENTUM_PER_STEP,
                    "momentum_tensors": RCNN_SMALL_MOMENTUM_TENSORS,
                    **RCNN_XENT_PER_STEP}, RCNN_PARITY_STEPS)
    counts.update(check_xent_layout("rcnn_parity", "narrow"))
    tol = np.array([1e-5] + [1e-4] * (RCNN_PARITY_STEPS - 1))
    rel = check_parity("rcnn_parity", cpu, card, tol)
    main = progs["main"]
    kinds = ("anchor_generator", "generate_proposals", "rpn_target_assign",
             "generate_proposal_labels", "roi_pool")
    fetches = [n for op in main.global_block().ops if op.type in kinds
               for n in op.output_arg_names] + \
        [v.name for v in progs["losses"]] + ["feature@GRAD"]
    worst = compare_places("rcnn_parity ops", main, progs["startup"], feed,
                           fetches, places)
    rpn = phase_rpn_parity(feed, places)
    rtol, atol = SEQ_PARITY_TOL
    emit("rcnn_parity", config={k: v for k, v in RCNN_SMALL.items()},
         steps=RCNN_PARITY_STEPS, cpu_losses=cpu.tolist(),
         card_losses=card.tolist(), rel_err=rel, rtol=tol.tolist(),
         launches=counts, op_fetches=len(fetches),
         op_max_abs_err=max(worst.values()),
         op_worst=max(worst, key=worst.get),
         op_tol={"rtol": rtol, "atol": atol}, rpn=rpn)


def phase_rpn_parity(feed, places):
    """Card against CPU: the RPN alone (``RPN_SMALL``: its convs drawn and
    trained) for ``RCNN_PARITY_STEPS`` steps from one state, every step's
    :func:`rpn_fetches` held by :func:`check_rpn_step`; 1 momentum launch
    a step for its 6 tensors.  Returns the numbers for ``rcnn_parity``'s
    line."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.params import load_reference_params

    progs = rcnn_heads(fluid, **RPN_SMALL)
    names = rpn_fetches(progs)
    runs, init = [], None
    for place in places:
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(progs["startup"], scope=scope)
        if init is None:
            init = {v.name: scope.get(v.name).detach().cpu().numpy().copy()
                    for v in progs["startup"].list_vars() if v.persistable}
        else:
            load_reference_params(scope, init, place)
        reset_launch_counts()
        runs.append([exe.run(progs["main"], feed=feed, fetch_list=names,
                             scope=scope)
                     for _ in range(RCNN_PARITY_STEPS)])
    counts = launch_counts()
    check_launches("rcnn_parity rpn", counts,
                   {"momentum": MOMENTUM_PER_STEP,
                    "momentum_tensors": RPN_SMALL_MOMENTUM_TENSORS},
                   RCNN_PARITY_STEPS)
    worst = {}
    for step, (want, got) in enumerate(zip(*runs)):
        rtol = 1e-5 if step == 0 else 1e-4
        for k, v in check_rpn_step(f"rcnn_parity rpn step {step}", names,
                                   want, got, rtol).items():
            worst[k] = max(worst.get(k, 0.0), v)
    grads = [n for n in names if n.endswith("@GRAD")]
    return {"config": {k: v for k, v in RPN_SMALL.items()},
            "cpu_losses": [float(np.asarray(r[0]).reshape(-1)[0]
                                 + np.asarray(r[1]).reshape(-1)[0])
                           for r in runs[0]],
            "card_losses": [float(np.asarray(r[0]).reshape(-1)[0]
                                  + np.asarray(r[1]).reshape(-1)[0])
                            for r in runs[1]],
            "fetches": len(names), "grads": grads,
            "grad_max_abs": [float(np.abs(np.asarray(v)).max())
                             for n, v in zip(names, runs[1][0])
                             if n.endswith("@GRAD")],
            "worst_scaled_err": max(worst.values()),
            "worst": max(worst, key=worst.get), "launches": counts}


def dcgan_step(exe, progs, side, scope, img, noise=None, fetch_noise=False):
    """One D or G step: its loss (and noise), as device tensors."""
    feed = {"img": img} if noise is None else {"img": img, "noise": noise}
    fetches = [progs[f"{side}_loss"]]
    if fetch_noise:
        fetches.append(progs[f"{side}_noise"])
    return exe.run(progs[side], feed=feed, fetch_list=fetches, scope=scope,
                   return_numpy=False)


DECONV_OPS = ("conv2d_transpose", "conv2d_transpose_grad")


def dcgan_profile(exe, progs, scope, img):
    """One more iteration (a D and a G step) under ``torch.profiler`` with
    each op dispatch annotated by its type: the device's busy share of the
    wall time, and the device time and busy share of the kernels that the
    ``conv2d_transpose`` ops and their grads launched (kernels matched to
    their launch calls by correlation id, launch calls to the op whose
    annotation holds them).  Fails unless every such op of the two
    Programs was annotated and some kernel was matched to them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.fluid import executor

    run_op = executor.run_op

    def annotated(op, *args, **kwargs):
        with record_function(f"op:{op.type}"):
            return run_op(op, *args, **kwargs)

    executor.run_op = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace()
            t0 = time.perf_counter()
            for side in ("d", "g"):
                dcgan_step(exe, progs, side, scope, img)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pad_trace()
    finally:
        executor.run_op = run_op
    events = trace_events(prof)
    spans = device_spans(prof, events)
    busy_s, n_events, top = trace_summary(spans)
    marks = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e["name"] in [f"op:{t}" for t in DECONV_OPS]]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})
                and any(tid == e["tid"] and a <= e["ts"] <= b
                        for tid, a, b in marks)}
    deconv = [e for e in events if e.get("cat") == "kernel"
              and e.get("args", {}).get("correlation") in launched]
    want = sum(op.type in DECONV_OPS for side in "dg"
               for op in progs[side].global_block().ops)
    if len(marks) != want or not deconv:
        raise AssertionError(
            f"train_dcgan_profile: {len(marks)} of the {want} transposed "
            f"convolution ops annotated, {len(deconv)} kernels matched")
    deconv_s = sum(e["dur"] for e in deconv) / 1e6
    emit("train_dcgan_profile", wall_s=wall, device_busy_s=busy_s,
         device_busy_share=busy_s / wall, device_events=n_events,
         conv2d_transpose_ops=len(marks),
         conv2d_transpose_kernels=len(deconv),
         conv2d_transpose_device_s=deconv_s,
         conv2d_transpose_share_of_busy=deconv_s / busy_s,
         optimizer_kernels=optimizer_kernels(spans),
         conv_kernels=kernel_family(spans, CONV_KEYS, busy_s), top_kernels=top)


def phase_train_dcgan(profile_run=False):
    """DCGAN at the paper's widths on the card (``dcgan_programs``: 64 x 64
    images, batch 128, fp32): ``DCGAN_ITERS`` iterations of one D step and
    one G step on fresh synthetic LSUN-shaped batches, the noise drawn on
    the card by ``uniform_random_batch_size_like``.  Checks: finite
    losses; each step's noise on the card, ``[128, 100]``, within [-1, 1];
    exactly one Adam launch for D's 12 tensors a D step and one for G's 13
    a G step, and no other kernel's; no host sync.  Reports images/s, D
    and G step ms (CUDA events and host clock), op dispatches a step and
    peak allocated; with ``--profile`` one more iteration under the
    profiler (``dcgan_profile``).  Returns the launches."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    progs = dcgan_programs(fluid)
    for side, want in (("d", DCGAN_D_TENSORS), ("g", DCGAN_G_TENSORS)):
        if len(progs[f"{side}_params"]) != want:
            raise AssertionError(f"train_dcgan: {side} trains "
                                 f"{len(progs[side + '_params'])} tensors")
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    rng = np.random.RandomState(0)
    batches = [dcgan_batch(rng) for _ in range(DCGAN_ITERS)]
    torch.cuda.reset_peak_memory_stats()
    reset_host_syncs()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms = {f"{side}_{clock}": [] for side in "dg"
          for clock in ("host", "device")}
    counts, dispatches, losses, noise = {}, {"d": 0, "g": 0}, [], []
    for img in batches:
        step = []
        for side in ("d", "g"):
            torch.cuda.synchronize()
            reset_launch_counts()
            with counting_dispatches() as box:
                t0 = time.perf_counter()
                start.record()
                loss, z = dcgan_step(exe, progs, side, scope, img,
                                     fetch_noise=True)
                end.record()
                torch.cuda.synchronize()
            ms[f"{side}_host"].append((time.perf_counter() - t0) * 1e3)
            ms[f"{side}_device"].append(start.elapsed_time(end))
            dispatches[side] += box[0]
            got = launch_counts()
            check_launches(f"train_dcgan {side} step", got, {
                "adam": 1, "adam_tensors": DCGAN_D_TENSORS if side == "d"
                else DCGAN_G_TENSORS}, 1)
            add_counts(counts, got)
            step.append(float(loss.reshape(-1)[0]))
            noise.append((z.device.type, tuple(z.shape), float(z.min()),
                          float(z.max())))
        losses.append(step)
    syncs = host_syncs()
    if not all(math.isfinite(v) for step in losses for v in step):
        raise AssertionError(f"train_dcgan: non-finite losses {losses}")
    want_z = ("cuda", (DCGAN_BATCH, DCGAN_NZ))
    if any(z[:2] != want_z or z[2] < -1.0 or z[3] > 1.0 for z in noise):
        raise AssertionError(f"train_dcgan: noise {noise}")
    if syncs:
        raise AssertionError(f"train_dcgan: {syncs} host syncs in "
                             f"{DCGAN_ITERS} iterations")
    n = DCGAN_ITERS - 1  # the first iteration warms up (first launches)
    iter_dev = [a + b for a, b in zip(ms["d_device"], ms["g_device"])][1:]
    iter_host = [a + b for a, b in zip(ms["d_host"], ms["g_host"])][1:]
    params = {side: [scope.get(p) for p in progs[f"{side}_params"]]
              for side in "dg"}
    emit("train_dcgan", model="DCGAN (Radford et al. 2016, LSUN 64 x 64; "
         "dcgan.torch kernels)", data="synthetic LSUN-shaped",
         image=[3, DCGAN_IMAGE, DCGAN_IMAGE], batch=DCGAN_BATCH,
         noise_dim=DCGAN_NZ, base_width=DCGAN_BASE, lr=DCGAN_LR,
         beta1=DCGAN_BETA1, iterations=DCGAN_ITERS,
         ops={side: len(progs[side].global_block().ops) for side in "dg"},
         parameter_values={side: sum(t.numel() for t in ts)
                           for side, ts in params.items()},
         losses={"d": [s[0] for s in losses], "g": [s[1] for s in losses]},
         noise_min=min(z[2] for z in noise),
         noise_max=max(z[3] for z in noise),
         launches=counts, **{f"{k}_step_ms": v for k, v in ms.items()},
         images_per_s_events=DCGAN_BATCH * n * 1e3 / sum(iter_dev),
         images_per_s_host=DCGAN_BATCH * n * 1e3 / sum(iter_host),
         op_dispatches_per_step={side: v / DCGAN_ITERS
                                 for side, v in dispatches.items()},
         host_syncs_per_step=syncs / (2 * DCGAN_ITERS),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if profile_run:
        dcgan_profile(exe, progs, scope, batches[0])
    return counts, progs


def phase_train_dcgan_parity():
    """Card against CPU: ``DCGAN_SMALL`` (16 x 16 images, base width 16) at
    batch 8 with the noise fed from numpy, ``DCGAN_PARITY_ITERS``
    iterations of a D and a G step, fp32, each step from the CPU's state
    (copied to the card before it): the step's loss within rtol 1e-5 in
    the first iteration and 1e-4 after, and every persistable, each
    parameter's gradient and the card's Adam update of its own gradients
    tensor by tensor within the same rtol (:func:`adam_step_check`, which
    also lists the elements left out of the state's check: those where
    Adam turns gradient rounding into a visible step).  Beside them, the
    same step in float64 on the CPU from the same state: each side's
    gradients' distance from it, D's fc bias gradient (the real batch's
    mean sigmoid less 1 plus the fake batch's: a difference of near-equal
    sums) in the three runs, and each left-out element's float64
    gradient.  One Adam launch a step on the card."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models.params import load_reference_params

    framework.fresh_session()
    progs = dcgan_programs(fluid, **DCGAN_SMALL)
    framework.fresh_session()
    exact = dcgan_programs(fluid, **DCGAN_SMALL, dtype="float64")
    image = DCGAN_SMALL["image"]
    rng = np.random.RandomState(5)
    data = [(dcgan_batch(rng, DCGAN_SMALL_BATCH, image),
             [rng.uniform(-1, 1, (DCGAN_SMALL_BATCH, DCGAN_NZ)).astype(
                 np.float32) for _ in range(2)])
            for _ in range(DCGAN_PARITY_ITERS)]
    places = (fluid.CPUPlace(), fluid.CUDAPlace(0), fluid.CPUPlace())
    runs = []
    for place, p in zip(places, (progs, progs, exact)):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(p["startup"], scope=scope)
        runs.append((exe, scope))
    names = [v.name for v in progs["startup"].list_vars() if v.persistable]
    slots = adam_slots(progs["d"])
    slots.update(adam_slots(progs["g"]))

    def state(scope):
        return {n: scope.get(n).detach().cpu().numpy().copy() for n in names}

    wide = {n: v.dtype for n, v in state(runs[2][1]).items()}

    rtol = [1e-5] + [1e-4] * (DCGAN_PARITY_ITERS - 1)
    result = {"loss_rel_err": [], "worst": [], "left_out": [], "parted": [],
              "grad_err_vs_float64": [], "d_fc_b_grad": []}
    reset_launch_counts()
    for k, (img, noises) in enumerate(data):
        for side, z in zip(("d", "g"), noises):
            before = state(runs[0][1])
            load_reference_params(runs[1][1], before, places[1])
            load_reference_params(runs[2][1], {
                n: v.astype(wide[n]) for n, v in before.items()}, places[2])
            params = progs[f"{side}_params"]
            fetch = [progs[f"{side}_loss"]] + [p + "@GRAD" for p in params]
            outs = []
            for (exe, scope), p, dtype in zip(
                    runs, (progs, progs, exact),
                    (np.float32, np.float32, np.float64)):
                got = exe.run(p[side], feed={"img": img.astype(dtype),
                                             "noise": z.astype(dtype)},
                              fetch_list=fetch, scope=scope,
                              return_numpy=False)
                outs.append([np.asarray(t.detach().cpu().numpy(), dtype)
                             for t in got])
            losses = [float(o[0].reshape(-1)[0]) for o in outs]
            grads = [dict(zip(params, o[1:])) for o in outs]
            rel = abs(losses[1] - losses[0]) / abs(losses[0])
            where = f"train_dcgan_parity: iteration {k} {side} step"
            if not (np.isfinite(losses).all() and rel <= rtol[k]):
                raise AssertionError(f"{where}: losses {losses} (rel {rel}, "
                                     f"rtol {rtol[k]})")
            try:
                held = adam_step_check(slots, before, state(runs[0][1]),
                                       state(runs[1][1]), grads[0],
                                       grads[1], rtol[k])
            except AssertionError as err:
                raise AssertionError(f"{where}: {err}") from None
            for e in held["parted"]:
                e.update(iteration=k, side=side, grad_float64=float(
                    grads[2][e["name"]].flat[e["index"]]))
            result["loss_rel_err"].append(rel)
            result["worst"].append(held["worst"])
            result["left_out"].append(held["left_out"])
            result["parted"] += held["parted"]
            result["grad_err_vs_float64"].append({
                run: max((norm_rel_err(g[p], grads[2][p]), p)
                         for p in params)
                for run, g in (("cpu", grads[0]), ("card", grads[1]))})
            if side == "d":
                result["d_fc_b_grad"].append(
                    {run: float(g["d_fc.b"].reshape(-1)[0]) for run, g
                     in zip(("cpu", "card", "float64"), grads)})
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(adam=2 * DCGAN_PARITY_ITERS, adam_tensors=DCGAN_PARITY_ITERS
                * (DCGAN_D_TENSORS + DCGAN_G_TENSORS))
    if counts != want:
        raise AssertionError(f"train_dcgan_parity: the card's steps "
                             f"launched {counts}, expected {want}")
    emit("train_dcgan_parity", image=image, base_width=DCGAN_SMALL["base"],
         batch=DCGAN_SMALL_BATCH, iterations=DCGAN_PARITY_ITERS,
         noise="fed", rtol=rtol, persistables=len(names), launches=counts,
         **result)


# ops_tranche6_parity: the per-sample shapes of the public models that use
# each op, their batch cut to what the CPU side's time allows
T6_BATCH = {"lrn": 8, "group_norm": 4, "spp": 8, "segnet": 2, "c3d": 1,
            "mobilenet": 4, "shufflenet": 8, "maxout": 8, "dcgan": 8,
            "unet3d": 1, "fcn": 8, "bert": 32}
T6_SOURCES = {
    "lrn": "AlexNet conv1 96 x 55 x 55, n 5, k 2, alpha 1e-4, beta 0.75 "
           "(Krizhevsky et al. 2012 s3.3)",
    "group_norm": "32 groups on ResNet-50 conv2 256 x 56 x 56 (Wu & He 2018)",
    "spp": "pyramid height 3 on 256 x 13 x 13 (SPP-net, He et al. 2014)",
    "max_pool2d_with_index+unpool": "2 x 2 / 2 on 64 x 360 x 480 (SegNet "
                                    "on CamVid, Badrinarayanan et al. 2017)",
    "conv3d+pool3d+max_pool3d_with_index": "3 x 16 x 112 x 112 clips, 64 "
        "3x3x3 filters, 1x2x2 pool1; pool5 2x2x2 with padding on 512 x 2 x 7 "
        "x 7 (C3D, Tran et al. 2015)",
    "depthwise_conv2d": "MobileNet v1's 3 x 3 depthwise layers 1, 2 and 13 "
                        "(Howard et al. 2017)",
    "shuffle_channel": "g = 3, 240 x 28 x 28 (ShuffleNet, Zhang et al. 2018)",
    "maxout": "2 pieces on 192 x 32 x 32 (maxout networks on CIFAR-10, "
              "Goodfellow et al. 2013)",
    "conv2d_transpose": "DCGAN generator layer 3, 256 x 16 x 16 -> 128 x 32 x"
                        " 32 (Radford et al. 2016)",
    "conv3d_transpose": "2 x 2 x 2 / 2 up-convolution, 256 channels from 8 x"
                        " 8 x 8 (3D U-Net, Cicek et al. 2016)",
    "depthwise_conv2d_transpose": "2x bilinear upsampling (Bilinear "
        "initializer) of 21 x 56 x 56 class scores (FCN, Long et al. 2015)",
    "truncated_gaussian_random": "BERT-base word embedding 30,522 x 768, std"
                                 " 0.02 (Devlin et al. 2019)",
    "uniform/gaussian_random_batch_size_like": "DCGAN's 100-d noise for a "
                                               "batch of 128",
    "sampling_id": "100-way rows, unnormalized p, 100,000 rows (a shape "
                   "chosen for the chi-square's power)",
    "print/fill_zeros_like/range": "a BERT-base activation 32 x 128 x 768 "
                                   "and its 512 positions",
    "scale_sub_region": "boxes on AlexNet conv1 maps",
}
# a 0.1 % test: the Kolmogorov-Smirnov bound is KS_C / sqrt(n), the
# chi-square bound that of 98 degrees of freedom
KS_C, CHI2_98 = 1.9495, 147.01


def tie_free(rng, shape, window):
    """Normal values on a grid of 1/8, each position of every
    ``window``-shaped tile of the trailing dims plus its own multiple of
    1/(8·|window|): no tile holds two equal values, so a max pool over
    those tiles has one maximum a window."""
    import numpy as np

    base = np.round(rng.standard_normal(shape) * 8) / 8
    k = int(np.prod(window))
    offs = (np.arange(k) / (8.0 * k)).reshape(window)
    reps = [s // w for s, w in zip(shape[-len(window):], window)]
    return (base + np.tile(offs, reps)).astype(np.float32)


def tranche6_inputs(rng):
    """The inputs of ``tranche6_groups`` by key: (array, whether its grad
    is checked)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import fluid

    def normal(shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    b = T6_BATCH
    segnet = tie_free(rng, (b["segnet"], 64, 360, 480), (2, 2))
    pooled, mask = F.max_pool2d(torch.from_numpy(segnet), 2, 2,
                                return_indices=True)
    boxes = np.stack([rng.integers(1, 40, b["lrn"]),
                      rng.integers(50, 97, b["lrn"]),
                      rng.integers(1, 20, b["lrn"]),
                      rng.integers(30, 56, b["lrn"]),
                      rng.integers(1, 20, b["lrn"]),
                      rng.integers(30, 56, b["lrn"])], 1).astype(np.int32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        w = startup.global_block().create_var(
            name="bilinear", shape=[21, 1, 4, 4], dtype="float32",
            persistable=True)
        fluid.initializer.Bilinear()(w, startup.global_block())
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {
        "alexnet": (normal((b["lrn"], 96, 55, 55), 2.0), True),
        "boxes": (boxes, False),
        "resnet": (normal((b["group_norm"], 256, 56, 56), 2.0), True),
        "gn_scale": (normal((256,)), True), "gn_bias": (normal((256,)), True),
        "spp": (normal((b["spp"], 256, 13, 13)), True),
        "segnet": (segnet, True), "segnet_pooled": (pooled.numpy(), True),
        "segnet_mask": (mask.numpy(), False),
        "c3d_clip": (normal((b["c3d"], 3, 16, 112, 112)), True),
        "c3d_filter": (normal((64, 3, 3, 3, 3), 1 / 9), True),
        "c3d_act": (tie_free(rng, (b["c3d"], 64, 16, 112, 112), (1, 2, 2)),
                    True),
        "c3d_pool5": (normal((b["c3d"], 512, 2, 7, 7)), True),
        "dw1": (normal((b["mobilenet"], 32, 112, 112)), True),
        "dw1_w": (normal((32, 1, 3, 3), 1 / 3), True),
        "dw2": (normal((b["mobilenet"], 64, 112, 112)), True),
        "dw2_w": (normal((64, 1, 3, 3), 1 / 3), True),
        "dw13": (normal((b["mobilenet"], 1024, 7, 7)), True),
        "dw13_w": (normal((1024, 1, 3, 3), 1 / 3), True),
        "shufflenet": (normal((b["shufflenet"], 240, 28, 28)), True),
        "maxout": (normal((b["maxout"], 192, 32, 32)), True),
        "dcgan": (normal((b["dcgan"], 256, 16, 16)), True),
        "dcgan_w": (normal((256, 128, 4, 4), 1 / 32), True),
        "unet3d": (normal((b["unet3d"], 256, 8, 8, 8)), True),
        "unet3d_w": (normal((256, 256, 2, 2, 2), 1 / 16), True),
        "fcn": (normal((b["fcn"], 21, 56, 56)), True),
        "bilinear": (np.array(scope.get("bilinear")), False),
        "bert": (normal((b["bert"], 128, 768)), True),
    }


def tranche6_groups():
    """The 15 nn / misc op types and ``fill_zeros_like`` / ``shuffle_
    channel`` in groups for ``op_group_program``, as
    :func:`tranche5_groups`."""
    def conv(op, x, w, **attrs):
        return (op, {"Input": [x], "Filter": [w]}, attrs, {"Output": 1})

    convs = [
        conv("conv3d", "c3d_clip", "c3d_filter", strides=[1, 1, 1],
             paddings=[1, 1, 1], dilations=[1, 1, 1], groups=1),
        conv("depthwise_conv2d", "dw1", "dw1_w", strides=[1, 1],
             paddings=[1, 1], groups=0),
        conv("depthwise_conv2d", "dw2", "dw2_w", strides=[2, 2],
             paddings=[1, 1], groups=0),
        conv("depthwise_conv2d", "dw13", "dw13_w", strides=[1, 1],
             paddings=[1, 1], groups=0),
        conv("conv2d_transpose", "dcgan", "dcgan_w", strides=[2, 2],
             paddings=[1, 1], groups=1),
        conv("conv3d_transpose", "unet3d", "unet3d_w", strides=[2, 2, 2],
             paddings=[0, 0, 0], groups=1),
        ("depthwise_conv2d_transpose", {"Input": ["fcn"],
                                        "Filter": ["bilinear"]},
         {"strides": [2, 2], "paddings": [1, 1], "groups": 0},
         {"Output": 1})]
    norms = [
        ("lrn", {"X": ["alexnet"]}, {"n": 5, "k": 2.0, "alpha": 1e-4,
                                     "beta": 0.75},
         {"Out": 1, "MidOut": 1}),
        ("group_norm", {"X": ["resnet"], "Scale": ["gn_scale"],
                        "Bias": ["gn_bias"]}, {"groups": 32, "epsilon": 1e-5},
         {"Y": 1, "Mean": 1, "Variance": 1}),
        ("maxout", {"X": ["maxout"]}, {"groups": 2}, {"Out": 1}),
        ("scale_sub_region", {"X": ["alexnet"], "Indices": ["boxes"]},
         {"scale": 0.5}, {"Out": 1}),
        ("shuffle_channel", {"X": ["shufflenet"]}, {"group": 3}, {"Out": 1}),
        ("fill_zeros_like", {"X": ["bert"]}, {}, {"Out": 1})]
    pools = [
        ("spp", {"X": ["spp"]}, {"pyramid_height": 3, "pooling_type": "max"},
         {"Out": 1}),
        ("spp", {"X": ["spp"]}, {"pyramid_height": 3, "pooling_type": "avg"},
         {"Out": 1}),
        ("max_pool2d_with_index", {"X": ["segnet"]},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
         {"Out": 1, "Mask": 1}),
        ("unpool", {"X": ["segnet_pooled"], "Indices": ["segnet_mask"]},
         {"ksize": [2, 2], "strides": [2, 2], "unpooled_height": 360,
          "unpooled_width": 480}, {"Out": 1}),
        ("pool3d", {"X": ["c3d_act"]}, {"pooling_type": "max",
                                        "ksize": [1, 2, 2],
                                        "strides": [1, 2, 2],
                                        "paddings": [0, 0, 0]}, {"Out": 1}),
        ("max_pool3d_with_index", {"X": ["c3d_act"]},
         {"ksize": [1, 2, 2], "strides": [1, 2, 2], "paddings": [0, 0, 0]},
         {"Out": 1, "Mask": 1}),
        ("pool3d", {"X": ["c3d_pool5"]}, {"pooling_type": "avg",
                                          "ksize": [2, 2, 2],
                                          "strides": [2, 2, 2],
                                          "paddings": [0, 1, 1],
                                          "exclusive": True}, {"Out": 1})]
    return [("conv", convs, SEQ_PARITY_TOL, True),
            ("norm", norms, SEQ_PARITY_TOL, True),
            ("pool", pools, ELEMENTWISE_TOL, False)]


def ks_stat(x, cdf):
    """The Kolmogorov-Smirnov statistic of the samples ``x`` (a tensor)
    against ``cdf`` (of a float64 tensor), computed where ``x`` lies."""
    import torch

    xs = torch.sort(x.reshape(-1).double()).values
    n = xs.numel()
    f = cdf(xs)
    i = torch.arange(1, n + 1, dtype=torch.float64, device=xs.device)
    return float(torch.maximum(i / n - f, f - (i - 1) / n).max()), n


def random_draws(fluid, place, seed=0):
    """The draw ops of the tranche in one Program on ``place`` (``seed``
    their attr): the outputs by name."""
    import numpy as np

    main, startup = fluid.Program(), fluid.Program()
    names = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()
        img = fluid.layers.data(name="img", shape=[3, 64, 64],
                                dtype="float32")
        probs = fluid.layers.data(name="probs", shape=[100],
                                  dtype="float32")

        def op(op_type, inputs, **attrs):
            out = block.create_var(name=f"out_{op_type}", dtype="float32")
            block.append_op(type=op_type, inputs=inputs,
                            outputs={"Out": [out]},
                            attrs=dict(attrs, seed=seed))
            names[op_type] = out.name

        op("uniform_random_batch_size_like", {"Input": [img]},
           shape=[-1, DCGAN_NZ], min=-1.0, max=1.0)
        op("gaussian_random_batch_size_like", {"Input": [img]},
           shape=[-1, DCGAN_NZ], mean=0.0, std=1.0)
        op("truncated_gaussian_random", {}, shape=[30522, 768], mean=0.0,
           std=0.02)
        op("sampling_id", {"X": [probs]})
    exe, scope = fluid.Executor(place), fluid.Scope()
    feed = {"img": np.zeros((128, 3, 64, 64), np.float32),
            "probs": np.repeat(sampling_p()[None], 100000, 0)}
    outs = exe.run(main, feed=feed, fetch_list=list(names.values()),
                   scope=scope, return_numpy=False)
    return dict(zip(names, outs))


def sampling_p():
    """``sampling_id``'s rows: 100 classes with odds 1-7 in turn (not
    summing to 1), class 0 at odds 0 (never drawn)."""
    import numpy as np

    p = ((np.arange(100) % 7 + 1) * 0.01).astype(np.float32)
    p[0] = 0.0
    return p


def check_random_draws(phase, draws):
    """Each draw against its distribution (``KS_C / sqrt(n)``; the
    truncation bounds exactly; ``sampling_id``'s counts by chi-square, its
    zero-odds class never drawn): the statistics."""
    import torch

    ndtr = torch.special.ndtr
    lo, hi = ndtr(torch.tensor(-2.0, dtype=torch.float64)), ndtr(
        torch.tensor(2.0, dtype=torch.float64))
    cdfs = {
        "uniform_random_batch_size_like": lambda x: (x + 1.0) / 2.0,
        "gaussian_random_batch_size_like": ndtr,
        "truncated_gaussian_random":
            lambda x: (ndtr(x / 0.02) - lo.to(x.device)) / (hi - lo).to(
                x.device)}
    shapes = {"uniform_random_batch_size_like": (128, DCGAN_NZ),
              "gaussian_random_batch_size_like": (128, DCGAN_NZ),
              "truncated_gaussian_random": (30522, 768)}
    out = {}
    for name, cdf in cdfs.items():
        x = draws[name]
        if tuple(x.shape) != shapes[name] or x.dtype != torch.float32:
            raise AssertionError(f"{phase}: {name} drew {x.dtype} "
                                 f"{tuple(x.shape)}")
        d, n = ks_stat(x, cdf)
        bound = KS_C / n ** 0.5
        if d > bound:
            raise AssertionError(f"{phase}: {name}'s KS statistic {d} > "
                                 f"{bound}")
        out[name] = {"ks": d, "ks_bound": bound, "n": n,
                     "min": float(x.min()), "max": float(x.max())}
    t = out["truncated_gaussian_random"]
    if t["min"] < -0.04 or t["max"] > 0.04:
        raise AssertionError(f"{phase}: truncated draw outside [-0.04, "
                             f"0.04]: {t}")
    u = out["uniform_random_batch_size_like"]
    if u["min"] < -1.0 or u["max"] > 1.0:
        raise AssertionError(f"{phase}: uniform draw outside [-1, 1]: {u}")
    ids = draws["sampling_id"]
    if ids.dtype != torch.int64 or tuple(ids.shape) != (100000,):
        raise AssertionError(f"{phase}: sampling_id drew {ids.dtype} "
                             f"{tuple(ids.shape)}")
    counts = torch.bincount(ids, minlength=100).double()
    p = torch.from_numpy(sampling_p()).double().to(counts.device)
    expected = p / p.sum() * ids.numel()
    keep = p > 0
    chi2 = float(((counts[keep] - expected[keep]) ** 2
                  / expected[keep]).sum())
    if chi2 > CHI2_98 or float(counts[~keep].sum()):
        raise AssertionError(f"{phase}: sampling_id's chi-square {chi2} > "
                             f"{CHI2_98}, or class 0 drawn")
    out["sampling_id"] = {"chi2": chi2, "chi2_bound": CHI2_98,
                          "rows": ids.numel()}
    return out


def print_run(fluid, place, x, runs=3):
    """``layers.Print`` (first 2 runs, 20 values) of ``x`` in a Program run
    ``runs`` times on ``place``: the printed text, the output of the last
    run and the host reads the prints made."""
    import io
    from contextlib import redirect_stdout

    from paddle_tpu_torch.ops import nn_ops

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        v = fluid.layers.data(name="x", shape=list(x.shape[1:]),
                              dtype="float32")
        out = fluid.layers.Print(v, first_n=2, message="bert_encoder_out",
                                 summarize=20)
    exe, scope = fluid.Executor(place), fluid.Scope()
    before = nn_ops.stats["host_reads"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        for _ in range(runs):
            got = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope,
                          return_numpy=False)[0]
    return buf.getvalue(), got, nn_ops.stats["host_reads"] - before


def range_run(fluid, place):
    """``range`` in float32 and int64 (512 positions) from ``assign``
    constants on ``place``."""
    import numpy as np

    main, startup = fluid.Program(), fluid.Program()
    outs = []
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()
        for dtype, start, step in (("float32", 0.5, 0.25), ("int64", 0, 1)):
            ins = {slot: [fluid.layers.assign(np.array([v], dtype))]
                   for slot, v in (("Start", start), ("End", 512),
                                   ("Step", step))}
            out = block.create_var(name=f"range_{dtype}", dtype=dtype)
            block.append_op(type="range", inputs=ins, outputs={"Out": [out]},
                            attrs={"_static_len": 512})
            outs.append(out.name)
    exe, scope = fluid.Executor(place), fluid.Scope()
    return exe.run(main, fetch_list=outs, scope=scope, return_numpy=False)


def phase_ops_tranche6_parity():
    """The tranche's 22 op types at the per-sample shapes of the public
    models that use them (``T6_SOURCES``; the batches ``T6_BATCH``): the
    15 nn / misc ops with ``shuffle_channel`` and ``fill_zeros_like``,
    forward and input grads, one Program a group on each place, the
    card's within the group's tolerance of the CPU's, integer outputs
    (``Mask``) equal, on tie-free inputs (``tie_free``); ``range`` equal;
    ``print``'s text on the card equal to the CPU's, one host read a
    print; the draws on the card held to their distributions
    (``check_random_draws``), their shapes and dtypes the CPU's, and a
    nonzero ``seed`` drawing the same numbers twice.  Returns the op
    types it ran."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework

    t0 = time.perf_counter()
    inputs = tranche6_inputs(np.random.default_rng(22))
    inputs_s = time.perf_counter() - t0
    places = (("cpu", fluid.CPUPlace()), ("card", fluid.CUDAPlace(0)))
    covered, result = set(), {}
    for group, specs, tol, of_largest in tranche6_groups():
        framework.fresh_session()
        main, startup, feeds, outs, grads = op_group_program(fluid, specs,
                                                             inputs)
        feed = {n: inputs[k][0] for n, k in feeds.items()}
        runs, secs = [], {}
        for tag, place in places:
            t1 = time.perf_counter()
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            runs.append(exe.run(main, feed=feed, fetch_list=outs + grads,
                                scope=scope, return_numpy=False))
            torch.cuda.synchronize()
            secs[f"{tag}_s"] = time.perf_counter() - t1
        worst = compare_on_card(f"ops_tranche6_parity {group}", outs + grads,
                                *runs, tol, of_largest)
        covered |= {spec[0] for spec in specs}
        result[group] = {"ops": len(specs), "fetches": len(outs + grads),
                         "tol": list(tol), "atol_of_largest": of_largest,
                         "max_abs_err": worst, **secs}
        del feed, runs
    framework.fresh_session()
    cpu, card = (range_run(fluid, place) for _, place in places)
    compare_on_card("ops_tranche6_parity range", ["f32", "i64"], cpu, card,
                    (0.0, 0.0), False)
    x = inputs["bert"][0]
    (cpu_text, cpu_out, _), (card_text, card_out, reads) = (
        print_run(fluid, place, x) for _, place in places)
    if card_text != cpu_text or cpu_text.count("bert_encoder_out") != 2 \
            or reads != 2:
        raise AssertionError(f"ops_tranche6_parity: print wrote "
                             f"{card_text!r} on the card ({reads} host "
                             f"reads), {cpu_text!r} on the CPU")
    compare_on_card("ops_tranche6_parity print", ["out"], [cpu_out],
                    [card_out], (0.0, 0.0), False)
    covered |= {"range", "print"}
    t1 = time.perf_counter()
    draws = random_draws(fluid, fluid.CUDAPlace(0))
    cpu_draws = random_draws(fluid, fluid.CPUPlace())
    for name, t in draws.items():
        c = cpu_draws[name]
        if t.device.type != "cuda" or t.dtype != c.dtype or \
                t.shape != c.shape:
            raise AssertionError(f"ops_tranche6_parity: {name} drew "
                                 f"{t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}, {c.dtype} {tuple(c.shape)} "
                                 f"on the CPU")
    stats_ = check_random_draws("ops_tranche6_parity", draws)
    seeded = [random_draws(fluid, fluid.CUDAPlace(0), seed=7)
              for _ in range(2)]
    for name in draws:
        if not torch.equal(seeded[0][name], seeded[1][name]):
            raise AssertionError(f"ops_tranche6_parity: {name} with seed 7 "
                                 f"drew different numbers twice")
        if torch.equal(seeded[0][name], draws[name]):
            raise AssertionError(f"ops_tranche6_parity: {name} drew the "
                                 f"same with seed 7 as with the scope's")
    covered |= set(draws)
    result["random"] = {**stats_, "seconds": time.perf_counter() - t1}
    if len(covered) != 22:
        raise AssertionError(f"ops_tranche6_parity: ran {sorted(covered)}")
    emit("ops_tranche6_parity", op_types=len(covered), groups=result,
         batch_cuts=T6_BATCH, sources=T6_SOURCES, print_text=card_text,
         print_host_reads=reads, torch_threads=torch.get_num_threads(),
         inputs_s=inputs_s, seconds=time.perf_counter() - t0)
    return covered



# -- the misc, quant and metric tranche: int8 inference, DeepFM under auc --

# bench.py's bench_resnet_infer on an accelerator (bench.py:503-568,
# BENCH_INT8=1): ResNet-50, 224 px, 1,000 classes, batch 16, the
# for_test clone, the int8 transpiler after startup; 4 batches for top-1
INT8_BATCH, INT8_HW, INT8_CLASSES, INT8_BATCHES = 16, 224, 1000, 4
# the weights the transpiler takes: conv2d Filter and mul Y of >= 64 values
INT8_MIN_ELEMENTS = 64
# top-1 may drop 0.01 under int8 (tests/test_inference_api.py:218-271);
# an image whose fp32 top-1 leads its runner-up by less than twice the
# image's largest int8 gap may flip by rounding alone and is counted
# apart
INT8_TOP1_DROP = 0.01
# int8 on the card against int8 on the CPU from the same int8 weights:
# cuDNN and oneDNN add the convolutions in other orders (as SEQ_PARITY_TOL,
# the atol of the largest logit)
INT8_PARITY_TOL = SEQ_PARITY_TOL
# the int8 logits against fp32's, of the largest logit: per-channel int8
# rounds each weight by at most 1/254 of its channel's largest; measured
# 1.0e-2 on the CPU's 2-layer Transformer, 1.6e-2 on ResNet-20
# (tests/test_torch_int8_transpiler.py)
INT8_LOGIT_TOL = 0.05
# DeepFM under fluid.layers.auc at upstream's CTR setting (4,095
# thresholds: models/PaddleRec ctr's num_thresholds=2**12 - 1)
AUC_THRESHOLDS, AUC_RTOL = 4095, 1e-6
# ops_tranche7_parity: public models' per-sample shapes, batches cut for
# the CPU side
T7_BATCH = {"dssm": 1024, "ssd": 4, "ntn": 512, "ntm": 256, "huber": 4096,
            "xent": 1024, "bert": 8, "resnet": 8, "voc": 2, "mq2007": 40,
            "imagenet": 256, "crop": 16, "crop_draws": 33000}
T7_SOURCES = {
    "cos_sim": "DSSM's 128-d query and document vectors, a [1, 128] "
               "document broadcast (Huang et al. 2013)",
    "norm": "SSD's L2 normalization of conv4_3, 512 x 38 x 38 (Liu et al. "
            "2016)",
    "l1_norm/fake_quantize_*/dequantize_weight": "ResNet-50 conv5 3 x 3 "
        "weight 512 x 512 x 3 x 3, its res3 activation 256 x 56 x 56 and "
        "its fc 2048 x 1000",
    "bilinear_tensor_product": "NTN, d = 100, k = 4 slices (Socher et al. "
                               "2013)",
    "conv_shift": "NTM's shift over 128 memory locations, 3 shifts (Graves "
                  "et al. 2014)",
    "modified_huber_loss": "a binary classifier's scores",
    "label_smooth": "Transformer-base's 30,000-way one-hot targets, eps 0.1",
    "minus": "BERT-base activations 128 x 768",
    "flatten2/squeeze2/unsqueeze2": "ResNet-50's pool5 2048 x 1 x 1",
    "mean_iou": "21 VOC classes over a 513 x 513 map (DeepLab)",
    "auc": "DeepFM's 160 predictions at 4,095 thresholds",
    "positive_negative_pair": "MQ2007 (LETOR 4.0): 41 documents a query, "
                              "3 relevance levels",
    "precision_recall": "1,000 ImageNet classes",
    "random_crop": "224 x 224 crops of 256 x 256 images; 8 of 40 for the "
                   "draws' chi-square",
    "selected_rows": "DeepFM's 832 looked-up ids of 100,000, k = 16, two "
                     "shards",
}
# chi-square at 0.1 % with 32 degrees of freedom (33 crop starts)
CHI2_32 = 62.487


def _top1_check(phase, fp32, int8):
    """Top-1 of int8 logits against fp32's over ``[N, C]`` arrays: (share
    that agrees, images whose fp32 margin over the runner-up exceeds twice
    the image's largest int8 gap, share of those that agree, largest gap
    of the largest logit).  Raises if the clear images' share falls below
    1 − ``INT8_TOP1_DROP``."""
    import numpy as np

    gap = np.abs(int8 - fp32).max(1)
    top2 = np.sort(fp32, 1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * gap
    agree = fp32.argmax(1) == int8.argmax(1)
    share = float(agree[clear].mean()) if clear.any() else 1.0
    if share < 1 - INT8_TOP1_DROP:
        raise AssertionError(f"{phase}: int8 top-1 agrees with fp32's on "
                             f"{share} of the clear images")
    return (float(agree.mean()), int(clear.sum()), share,
            float(gap.max() / np.abs(fp32).max()))


def _quant_targets(program, scope):
    """The names and per-channel axes of the weights the int8 transpiler
    takes in ``program``: conv2d Filter and mul Y of at least
    ``INT8_MIN_ELEMENTS`` values, and lookup_table W."""
    slots = {"conv2d": ("Filter", 0), "mul": ("Y", 1),
             "lookup_table": ("W", 0)}
    out = {}
    for op in program.global_block().ops:
        if op.type in slots:
            slot, axis = slots[op.type]
            name = op.input(slot)[0]
            w = scope.get(name)
            if w is not None and w.numel() >= INT8_MIN_ELEMENTS:
                out[name] = axis
    return out


def _dequantize_axes(program):
    """The weights ``program``'s dequantize_weight ops rebuild, with their
    per-channel axes."""
    return {op.input("X")[0][:-len("@INT8")]: op.attr("quant_axis")
            for op in program.global_block().ops
            if op.type == "dequantize_weight"}


def _int8_scope_check(phase, scope, names, fp32_bytes):
    """Every quantized weight int8 on the card with a float32 scale, its
    float original gone: the int8 bytes (weights and scales) and their
    share of ``fp32_bytes``."""
    int8_bytes = 0
    for name in names:
        q, s = scope.get(name + "@INT8"), scope.get(name + "@SCALE")
        if scope.get(name) is not None or q is None or \
                str(q.dtype) != "torch.int8" or q.device.type != "cuda" or \
                str(s.dtype) != "torch.float32":
            raise AssertionError(f"{phase}: {name} is not int8 on the card "
                                 f"with its float original dropped")
        int8_bytes += q.numel() + 4 * s.numel()
    share = int8_bytes / fp32_bytes
    # the int8 values are a quarter of the fp32 bytes; the scales add
    # 4 bytes a channel (under 2 % of fp32's above 50 values a channel)
    if not 0.25 < share < 0.27:
        raise AssertionError(f"{phase}: int8 weights {int8_bytes} bytes, "
                             f"{share} of fp32's {fp32_bytes}")
    return int8_bytes, share


def _dequantize_ms(scope, axes, device):
    """Device time of the dequantize_weight ops of one batch, alone (CUDA
    events around the ops, their own outputs discarded)."""
    from paddle_tpu_torch.ops import quant_ops
    from paddle_tpu_torch.ops.registry import ExecContext

    ctxs = [ExecContext("dequantize_weight",
                        {"X": [scope.get(n + "@INT8")],
                         "Scale": [scope.get(n + "@SCALE")]},
                        {"Out": [n + "@DEQ"]}, {"quant_axis": axis}, device)
            for n, axis in axes.items()]
    return cuda_time_ms(
        lambda: [quant_ops.dequantize_weight(c) for c in ctxs], 10)


def phase_infer_resnet_int8(tmp, card):
    """``bench.py``'s ``bench_resnet_infer`` with ``BENCH_INT8=1`` at its
    accelerator configuration: ResNet-50 (224 px, 1,000 classes, random
    weights from seed 1), the ``clone(for_test=True)`` program, fp32 on
    the card, then ``Int8WeightTranspiler().transpile`` after startup
    (the global scope): every conv2d Filter and mul Y of >= 64 values (53
    + 1) read through one ``dequantize_weight``, no float original left in
    the scope, the int8 weights ~1/4 of fp32's bytes; the logits' top-1
    over 4 batches of 16 against fp32's (``_top1_check``), the largest
    gap printed; int8
    on the card against int8 on the CPU (same int8 weights) within
    ``INT8_PARITY_TOL``; images/s of both (CUDA events, the feed staged
    on the card as ``bench.py`` stages it) and the dequantize ops' time
    and bytes a batch.  Then the same model through
    ``save_inference_model`` and ``AnalysisConfig(enable_int8=True)``
    (batch norm folded first) against the fp32 ``AnalysisConfig``
    predictor: the same counts, top-1 check and images/s."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.fluid.transpiler import Int8WeightTranspiler
    from paddle_tpu_torch.inference import (AnalysisConfig, PaddleTensor,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import resnet

    phase = "infer_resnet_int8"
    framework.fresh_session()
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    main.random_seed = startup.random_seed = 1
    _, _, prediction, _, _ = resnet.build(
        class_dim=INT8_CLASSES, depth=50,
        image_shape=(3, INT8_HW, INT8_HW), lr=0.1)
    # the classifier's logits (the softmax's input): at random weights the
    # softmax saturates, and equal probabilities would hide the int8 gap
    logits = main.global_block().var(next(
        op.input("X")[0] for op in main.global_block().ops
        if op.type == "softmax" and op.output("Out")[0] == prediction.name))
    infer = main.clone(for_test=True)
    fp32_prog = main.clone(for_test=True)
    exe = fluid.Executor()
    exe.run(startup)
    scope = fluid.global_scope()
    imgs = [np.random.RandomState(k).normal(
        size=(INT8_BATCH, 3, INT8_HW, INT8_HW)).astype(np.float32)
        for k in range(INT8_BATCHES)]
    dev = [{"img": torch.from_numpy(x).cuda()} for x in imgs]

    def run(prog, feed):
        return exe.run(prog, feed=feed, fetch_list=[logits],
                       return_numpy=False)[0]

    fp32 = np.concatenate([run(fp32_prog, f).cpu().numpy() for f in dev])
    fp32_ms = cuda_time_ms(lambda: run(fp32_prog, dev[0]), 10, warmup=2)
    axes = _quant_targets(fp32_prog, scope)
    fp32_bytes = sum(scope.get(n).numel() * 4 for n in axes)
    infer_dir = os.path.join(tmp, "resnet50_int8")
    fluid.io.save_inference_model(infer_dir, ["img"], [logits], exe,
                                  main_program=main)

    quantized = Int8WeightTranspiler().transpile(infer)
    ops = infer.global_block().ops
    deq = [op for op in ops if op.type == "dequantize_weight"]
    slot_of = {"conv2d": "Filter", "mul": "Y"}
    reads = [op.input(slot_of[op.type])[0] for op in ops
             if op.type in slot_of]
    float_reads = [r for r in reads if r in axes]
    if sorted(quantized) != sorted(axes) or len(axes) != 54 or \
            len(deq) != 54 or float_reads or \
            sum(r.endswith("@DEQ") for r in reads) != 54:
        raise AssertionError(f"{phase}: {len(quantized)} weights quantized, "
                             f"{len(deq)} dequantize ops for {len(axes)} "
                             f"weights")
    int8_bytes, share = _int8_scope_check(phase, scope, axes, fp32_bytes)
    int8 = np.concatenate([run(infer, f).cpu().numpy() for f in dev])
    int8_ms = cuda_time_ms(lambda: run(infer, dev[0]), 10, warmup=2)
    agree, clear, clear_share, gap = _top1_check(phase, fp32, int8)
    deq_ms = _dequantize_ms(scope, axes, torch.device("cuda", 0))
    deq_values = sum(scope.get(n + "@INT8").numel() for n in axes)

    # the same int8 program on the CPU from the card's int8 weights
    cpu_scope = fluid.Scope()
    for v in infer.list_vars():
        t = scope.get(v.name) if v.persistable else None
        if isinstance(t, torch.Tensor):
            cpu_scope.set(v.name, t.cpu())
    t0 = time.perf_counter()
    (cpu,) = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed={"img": imgs[0]}, fetch_list=[logits], scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    card_err = compare_on_card(
        phase, ["logits"], [torch.from_numpy(np.asarray(cpu))],
        [torch.from_numpy(int8[:INT8_BATCH]).cuda()], INT8_PARITY_TOL, True)
    del cpu_scope, dev
    framework.fresh_session()
    torch.cuda.empty_cache()

    inputs = [PaddleTensor(name="img", data=imgs[0])]
    preds = {}
    for kind, int8_mode in (("fp32", False), ("int8", True)):
        pred = create_paddle_predictor(AnalysisConfig(
            model_dir=infer_dir, enable_int8=int8_mode))
        outs = np.concatenate([pred.run([PaddleTensor(name="img", data=x)])[
            0].data for x in imgs])
        ms = cuda_time_ms(lambda: pred.run(inputs), 5, warmup=1)
        n_deq = sum(op.type == "dequantize_weight"
                    for op in pred._program.global_block().ops)
        preds[kind] = {"outs": outs, "ms_per_batch": ms,
                       "images_per_s": INT8_BATCH * 1e3 / ms,
                       "dequantize_ops": n_deq}
        if int8_mode:
            names = list(_dequantize_axes(pred._program))
            preds[kind]["int8_bytes"] = _int8_scope_check(
                phase, pred._scope, names, preds["fp32"]["fp32_bytes"])[0]
        else:
            preds[kind]["fp32_bytes"] = sum(
                pred._scope.get(n).numel() * 4
                for n in _quant_targets(pred._program, pred._scope))
        pred.close()
        del pred
        torch.cuda.empty_cache()
    if preds["int8"]["dequantize_ops"] != 54:
        raise AssertionError(f"{phase}: the int8 predictor holds "
                             f"{preds['int8']['dequantize_ops']} dequantize "
                             f"ops")
    p_agree, p_clear, p_share, p_gap = _top1_check(
        phase, preds["fp32"].pop("outs"), preds["int8"].pop("outs"))
    emit(phase, card=card, model="resnet50", image_hw=INT8_HW,
         classes=INT8_CLASSES, batch=INT8_BATCH, batches=INT8_BATCHES,
         quantized_weights=len(quantized), dequantize_ops=len(deq),
         fp32_weight_bytes=fp32_bytes, int8_weight_bytes=int8_bytes,
         int8_share_of_fp32=share,
         top1_agreement=agree, clear_images=clear,
         clear_top1_agreement=clear_share, logits_max_rel_gap=gap,
         fp32_ms_per_batch=fp32_ms, fp32_images_per_s=INT8_BATCH * 1e3
         / fp32_ms, int8_ms_per_batch=int8_ms,
         int8_images_per_s=INT8_BATCH * 1e3 / int8_ms,
         dequantize_ms_per_batch=deq_ms,
         dequantize_bytes_per_batch=5 * deq_values,
         card_vs_cpu_max_abs_err=card_err, parity_tol=list(INT8_PARITY_TOL),
         cpu_int8_s=cpu_s,
         predictor={"top1_agreement": p_agree, "clear_images": p_clear,
                    "clear_top1_agreement": p_share,
                    "logits_max_rel_gap": p_gap, **preds})


def phase_infer_transformer_int8(tmp, card):
    """Transformer-base (batch 64 x 256, flash, dropout 0, fp32, random
    weights from seed 1) saved by ``save_inference_model`` and run by a
    native fp32 predictor and by ``AnalysisConfig(enable_int8=True)``:
    every mul Y and lookup_table W quantized (per row for the
    embeddings), no float original left, the int8 bytes ~1/4; exactly
    ``FLASH_OPS`` fp32 flash forwards a batch and no other kernel; the
    int8 logits within ``INT8_LOGIT_TOL`` of fp32's largest, the top-1
    token agreement printed; ms a batch of each.  Returns the phase's
    launch counts."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            PaddleTensor,
                                            create_paddle_predictor)

    phase = "infer_transformer_int8"
    main, startup, _ = build_training(TRAIN_LEN, dropout=0.0, flash=True)
    xent = next(op for op in main.global_block().ops
                if op.type == "softmax_with_cross_entropy")
    logits = main.global_block().var(xent.input("Logits")[0])
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    infer_dir = os.path.join(tmp, "transformer_int8")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(infer_dir, ["src_word", "tgt_word"],
                                      [logits], exe, main_program=main)
    del scope
    exe.close()
    torch.cuda.empty_cache()
    feed = train_feed(TRAIN_BATCH, TRAIN_LEN, seed=2)
    inputs = [PaddleTensor(name=n, data=feed[n])
              for n in ("src_word", "tgt_word")]
    total, res, outs = {}, {}, {}
    for kind, cfg in (("fp32", NativeConfig(model_dir=infer_dir)),
                      ("int8", AnalysisConfig(model_dir=infer_dir,
                                              enable_int8=True))):
        pred = create_paddle_predictor(cfg)
        reset_launch_counts()
        (out,) = pred.run(inputs)
        counts = launch_counts()
        add_counts(total, counts)
        want = {k: 0 for k in counts}
        want.update(flash_fwd=FLASH_OPS)
        if counts != want:
            raise AssertionError(f"{phase}: {kind} predictor launches "
                                 f"{counts}, expected {want}")
        outs[kind] = out.data
        reset_launch_counts()
        ms = cuda_time_ms(lambda: pred.run(inputs), 3, warmup=1)
        add_counts(total, launch_counts())
        res[kind] = {"ms_per_batch": ms, "launches_a_batch": counts[
            "flash_fwd"]}
        axes = _quant_targets(pred._program, pred._scope)
        if kind == "fp32":
            fp32_bytes = sum(pred._scope.get(n).numel() * 4 for n in axes)
            res[kind]["weights"] = len(axes)
        else:
            names = list(_dequantize_axes(pred._program))
            tables = [op.input("W")[0] for op in pred._program.global_block(
                ).ops if op.type == "lookup_table"]
            if len(names) != res["fp32"]["weights"] or not tables or \
                    not all(t.endswith("@DEQ") for t in tables):
                raise AssertionError(f"{phase}: {len(names)} weights "
                                     f"quantized of {res['fp32']['weights']}"
                                     f"; tables read {tables}")
            res[kind]["dequantize_ops"] = len(names)
            res[kind]["int8_weight_bytes"], res[kind]["int8_share"] = \
                _int8_scope_check(phase, pred._scope, names, fp32_bytes)
            res[kind]["dequantize_ms_per_batch"] = _dequantize_ms(
                pred._scope, _dequantize_axes(pred._program),
                torch.device("cuda", 0))
        pred.close()
        del pred, out
        torch.cuda.empty_cache()
    fp32, int8 = outs["fp32"], outs["int8"]
    if int8.shape != fp32.shape or not np.isfinite(int8).all():
        raise AssertionError(f"{phase}: int8 logits {int8.shape}")
    err = float(np.abs(int8 - fp32).max() / np.abs(fp32).max())
    if not 0 < err <= INT8_LOGIT_TOL:
        raise AssertionError(f"{phase}: int8 logits {err} of the largest "
                             f"from fp32's")
    agree = float((int8.argmax(-1) == fp32.argmax(-1)).mean())
    emit(phase, card=card, model="transformer_base", batch=TRAIN_BATCH,
         seq_len=TRAIN_LEN, flash=True, fp32_weight_bytes=fp32_bytes,
         logits_max_rel_err=err, logits_tol=INT8_LOGIT_TOL,
         top1_token_agreement=agree, phase_launches=total, **res)
    return total


def phase_train_deepfm_auc():
    """``train_deepfm``'s DeepFM (26 fields, 100,000 ids, k = 16, sparse
    SGD, batch 32) with ``fluid.layers.auc(predict, label)`` at
    ``AUC_THRESHOLDS`` on the card, 5 steps on fresh batches: the stats
    float32 ``[4096]`` on the card, StatPos + StatNeg summing to the 160
    examples seen; each step's AUC the numpy float64 trapezoid over the
    same buckets within ``AUC_RTOL``; the auc op run on the CPU over the
    card's predictions and labels gives the card's stats bitwise and its
    AUC within ``AUC_RTOL``; no kernel launched."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import deepfm

    phase = "train_deepfm_auc"
    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, label, predict, loss = deepfm.build(
            num_fields=DEEPFM_FIELDS, vocab_size=DEEPFM_VOCAB,
            embed_dim=DEEPFM_DIM, lr=DEEPFM_LR)
        auc, stats = fluid.layers.auc(predict, label,
                                      num_thresholds=AUC_THRESHOLDS)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    # the same auc op alone on the CPU, fed the card's predictions
    cpu_main, cpu_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(cpu_main, cpu_start), fluid.unique_name.guard():
        p_in = fluid.layers.data("p", shape=[1], dtype="float32")
        l_in = fluid.layers.data("l", shape=[1], dtype="float32")
        cpu_auc, cpu_stats = fluid.layers.auc(
            p_in, l_in, num_thresholds=AUC_THRESHOLDS)
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu_exe.run(cpu_start, scope=cpu_scope)
    reset_launch_counts()
    aucs, step_ms = [], []
    for step in range(DEEPFM_STEPS):
        feed = deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, 200 + step)
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, auc, predict],
                      scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        value = float(out[1].reshape(-1)[0])
        pos, neg = (scope.get(s.name) for s in stats)
        if pos.device.type != "cuda" or pos.dtype != torch.float32 or \
                tuple(pos.shape) != (AUC_THRESHOLDS + 1,):
            raise AssertionError(f"{phase}: StatPos {pos.dtype} "
                                 f"{tuple(pos.shape)} on {pos.device}")
        seen = float((pos + neg).sum())
        if seen != DEEPFM_BATCH * (step + 1):
            raise AssertionError(f"{phase}: the stats count {seen} examples "
                                 f"after {step + 1} steps")
        p64, n64 = pos.double().cpu().numpy(), neg.double().cpu().numpy()
        pc, nc = np.cumsum(p64[::-1]), np.cumsum(n64[::-1])
        want = float(np.sum((nc - np.concatenate([[0.0], nc[:-1]]))
                            * (pc + np.concatenate([[0.0], pc[:-1]])) / 2)
                     / (pc[-1] * nc[-1]))
        if abs(value - want) > AUC_RTOL * abs(want):
            raise AssertionError(f"{phase}: step {step} AUC {value}, the "
                                 f"numpy trapezoid {want}")
        (cpu_value,) = cpu_exe.run(
            cpu_main, feed={"p": out[2].cpu().numpy(), "l": feed["label"]},
            fetch_list=[cpu_auc], scope=cpu_scope)
        for card_t, cpu_v in zip((pos, neg), cpu_stats):
            if not torch.equal(card_t.cpu(), cpu_scope.get(cpu_v.name)):
                raise AssertionError(f"{phase}: step {step}'s stats differ "
                                     f"card against CPU")
        if abs(float(np.asarray(cpu_value).reshape(-1)[0]) - value) > \
                AUC_RTOL * abs(value):
            raise AssertionError(f"{phase}: AUC {value} on the card, "
                                 f"{cpu_value} on the CPU")
        aucs.append(value)
    counts = launch_counts()
    check_launches(phase, counts, {}, DEEPFM_STEPS)
    emit(phase, model="deepfm", batch=DEEPFM_BATCH, steps=DEEPFM_STEPS,
         num_thresholds=AUC_THRESHOLDS, aucs=aucs, examples_seen=seen,
         stats_bitwise_cpu=True, auc_rtol=AUC_RTOL, host_step_ms=step_ms,
         launches=counts)


def tranche7_inputs(rng):
    """The inputs of ``tranche7_groups`` by key: (array, whether its grad
    is checked)."""
    import numpy as np

    def normal(shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    b = T7_BATCH
    n_docs = b["mq2007"] * 41
    imagenet = rng.integers(0, 1000, (b["imagenet"], 1))
    hits = rng.random((b["imagenet"], 1)) < 0.7
    voc_label = rng.integers(0, 21, (b["voc"] * 513 * 513,)).astype(np.int32)
    voc_pred = np.where(rng.random(voc_label.shape) < 0.6, voc_label,
                        rng.integers(0, 21, voc_label.shape)).astype(np.int32)
    prob = rng.random(160).astype(np.float32)
    conv_w = normal((512, 512, 3, 3), 0.02)
    fc_w = normal((2048, 1000), 0.02)
    res3 = np.maximum(normal((b["resnet"], 256, 56, 56)), 0)
    ids = rng.integers(0, DEEPFM_VOCAB, (DEEPFM_BATCH * DEEPFM_FIELDS, 1))
    return {
        "dssm_q": (normal((b["dssm"], 128)), True),
        "dssm_d": (normal((b["dssm"], 128)), True),
        "dssm_doc": (normal((1, 128)), True),
        "ssd": (normal((b["ssd"], 512, 38, 38), 20.0), True),
        "conv_w": (conv_w, True),
        "res3": (res3, True), "res3_state": (res3, False),
        "in_scale": (np.array([3.0], np.float32), False),
        "iter": (np.array([10007], np.int64), False),
        "quantized": (np.round(normal((b["resnet"], 256, 56, 56), 40.0)),
                      True),
        "q_scale": (np.array([2.75], np.float32), False),
        "fc_int8": (rng.integers(-127, 128, (2048, 1000)).astype(np.int8),
                    False),
        "fc_scale": (np.abs(fc_w).max(0) + np.float32(0.01), False),
        "conv_int8": (rng.integers(-127, 128, (512, 512, 3, 3)).astype(
            np.int8), False),
        "conv_scale": (np.abs(conv_w).reshape(512, -1).max(1), False),
        "ntn_x": (normal((b["ntn"], 100)), True),
        "ntn_y": (normal((b["ntn"], 100)), True),
        "ntn_w": (normal((4, 100, 100), 0.1), True),
        "ntn_b": (normal((1, 4)), True),
        "ntm_mem": (normal((b["ntm"], 128)), True),
        "ntm_shift": (np.abs(normal((b["ntm"], 3))), True),
        "huber_x": (normal((b["huber"], 1), 1.5), True),
        "huber_y": (rng.integers(0, 2, (b["huber"], 1)).astype(np.float32),
                    False),
        "onehot": (np.eye(30000, dtype=np.float32)[rng.integers(
            0, 30000, b["xent"])], True),
        "bert_a": (normal((b["bert"], 128, 768)), True),
        "bert_b": (normal((b["bert"], 128, 768)), True),
        "pool5": (normal((b["resnet"], 2048, 1, 1)), True),
        "pool5_flat": (normal((b["resnet"], 2048)), True),
        "voc_pred": (voc_pred, False), "voc_label": (voc_label, False),
        "auc_pred": (np.stack([1 - prob, prob], 1), False),
        "auc_label": (rng.integers(0, 2, (160, 1)), False),
        "auc_pos": (np.zeros(AUC_THRESHOLDS + 1, np.float32), False),
        "auc_neg": (np.zeros(AUC_THRESHOLDS + 1, np.float32), False),
        "mq_score": (normal((n_docs, 1)), False),
        "mq_label": (rng.integers(0, 3, (n_docs, 1)).astype(np.float32),
                     False),
        "mq_query": (np.repeat(np.arange(b["mq2007"]), 41).reshape(-1, 1),
                     False),
        "pr_probs": (rng.random((b["imagenet"], 1)).astype(np.float32),
                     False),
        "pr_idx": (np.where(hits, imagenet, rng.integers(
            0, 1000, imagenet.shape)), False),
        "pr_label": (imagenet, False),
        "pr_states": (rng.integers(0, 50, (1000, 4)).astype(np.float32),
                      False),
        "ids": (ids, False),
        "shard_rows0": (ids[ids % 2 == 0].reshape(-1, 1), False),
        "shard_rows1": (ids[ids % 2 == 1].reshape(-1, 1), False),
        "shard_vals0": (normal((int((ids % 2 == 0).sum()), 16)), False),
        "shard_vals1": (normal((int((ids % 2 == 1).sum()), 16)), False),
    }


def tranche7_groups():
    """The tranche's op types in groups for ``op_group_program``, with
    each group's tolerance: (name, specs, (rtol, atol), atol of the
    largest)."""
    elementwise = [
        ("minus", {"X": ["bert_a"], "Y": ["bert_b"]}, {}, {"Out": 1}),
        ("modified_huber_loss", {"X": ["huber_x"], "Y": ["huber_y"]}, {},
         {"Out": 1, "IntermediateVal": 1}),
        ("label_smooth", {"X": ["onehot"]}, {"epsilon": 0.1}, {"Out": 1}),
        ("fill", {}, {"value": [float(v) for v in range(-50, 50)],
                      "shape": [10, 10], "dtype": 5}, {"Out": 1}),
        ("flatten2", {"X": ["pool5"]}, {"axis": 1},
         {"Out": 1, "XShape": 1}),
        ("squeeze2", {"X": ["pool5"]}, {"axes": [2, 3]},
         {"Out": 1, "XShape": 1}),
        ("unsqueeze2", {"X": ["pool5_flat"]}, {"axes": [2, 3]},
         {"Out": 1, "XShape": 1}),
        ("fake_quantize_abs_max", {"X": ["conv_w"]}, {"bit_length": 8},
         {"Out": 1, "OutScale": 1}),
        ("fake_quantize_range_abs_max",
         {"X": ["res3"], "InScale": ["in_scale"], "Iter": ["iter"]},
         {"window_size": 10000, "bit_length": 8, "is_test": False},
         {"Out": 1, "OutScale": 1}),
        # the window and the counter (outputs no grad goes through)
        ("fake_quantize_range_abs_max",
         {"X": ["res3_state"], "InScale": ["in_scale"], "Iter": ["iter"]},
         {"window_size": 10000, "bit_length": 8, "is_test": False},
         {"Out": 1, "OutScale": 1, "OutScales": 1, "IterOut": 1}),
        ("fake_dequantize_max_abs", {"X": ["quantized"],
                                     "Scale": ["q_scale"]},
         {"max_range": 127.0}, {"Out": 1}),
        ("dequantize_weight", {"X": ["fc_int8"], "Scale": ["fc_scale"]},
         {"quant_axis": 1}, {"Out": 1}),
        ("dequantize_weight", {"X": ["conv_int8"], "Scale": ["conv_scale"]},
         {"quant_axis": 0}, {"Out": 1}),
        ("split_ids", {"Ids": ["ids"]}, {}, {"Out": 2}),
        ("merge_ids", {"Ids": ["ids"], "Rows": ["shard_rows0",
                                                "shard_rows1"],
                       "X": ["shard_vals0", "shard_vals1"]}, {}, {"Out": 1})]
    sums = [
        ("cos_sim", {"X": ["dssm_q"], "Y": ["dssm_d"]}, {},
         {"Out": 1, "XNorm": 1, "YNorm": 1}),
        ("cos_sim", {"X": ["dssm_q"], "Y": ["dssm_doc"]}, {},
         {"Out": 1, "XNorm": 1, "YNorm": 1}),
        ("norm", {"X": ["ssd"]}, {"axis": 1, "epsilon": 1e-10},
         {"Out": 1, "Norm": 1}),
        ("l1_norm", {"X": ["conv_w"]}, {}, {"Out": 1}),
        ("bilinear_tensor_product", {"X": ["ntn_x"], "Y": ["ntn_y"],
                                     "Weight": ["ntn_w"], "Bias": ["ntn_b"]},
         {}, {"Out": 1}),
        ("conv_shift", {"X": ["ntm_mem"], "Y": ["ntm_shift"]}, {},
         {"Out": 1})]
    metrics = [
        ("mean_iou", {"Predictions": ["voc_pred"], "Labels": ["voc_label"]},
         {"num_classes": 21},
         {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}),
        ("auc", {"Predict": ["auc_pred"], "Label": ["auc_label"],
                 "StatPos": ["auc_pos"], "StatNeg": ["auc_neg"]},
         {"num_thresholds": AUC_THRESHOLDS},
         {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}),
        ("positive_negative_pair", {"Score": ["mq_score"],
                                    "Label": ["mq_label"],
                                    "QueryID": ["mq_query"]}, {"column": 0},
         {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1}),
        ("precision_recall", {"MaxProbs": ["pr_probs"],
                              "Indices": ["pr_idx"], "Labels": ["pr_label"],
                              "StatesInfo": ["pr_states"]},
         {"class_number": 1000},
         {"BatchMetrics": 1, "AccumMetrics": 1, "AccumStatesInfo": 1})]
    return [("elementwise", elementwise, (1e-5, 1e-6), False),
            ("sums", sums, SEQ_PARITY_TOL, True),
            ("metrics", metrics, (1e-6, 0.0), False)]


def selected_rows_run(fluid, place, ids, table):
    """DeepFM's sparse table grad (``lookup_table(is_sparse=True)`` of
    ``ids`` into ``table``) through ``extract_rows`` and
    ``split_selected_rows`` (two shards of the 100,000 rows) on
    ``place``: the fetched rows tensor and the two shards
    (SelectedRows)."""
    import torch

    from paddle_tpu_torch.fluid import framework

    framework.fresh_session()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(x, size=[DEEPFM_VOCAB, DEEPFM_DIM],
                                     is_sparse=True, param_attr="sr_table")
        fluid.append_backward(fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(emb, emb)))
        block = main.global_block()
        rows = block.create_var(name="sr_rows", dtype="int64")
        parts = [block.create_var(name=f"sr_part{i}", dtype="float32")
                 for i in range(2)]
        block.append_op(type="extract_rows",
                        inputs={"X": ["sr_table@GRAD"]},
                        outputs={"Out": [rows]})
        half = DEEPFM_VOCAB // 2
        block.append_op(type="split_selected_rows",
                        inputs={"X": ["sr_table@GRAD"]},
                        outputs={"Out": parts},
                        attrs={"height_sections": [half,
                                                   DEEPFM_VOCAB - half]})
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.get("sr_table").copy_(torch.from_numpy(table))
    return exe.run(main, feed={"ids": ids}, fetch_list=[rows] + parts,
                   scope=scope, return_numpy=False)


def checkpoint_save(fluid, place, dirname, arrays):
    """``save`` of the first of ``arrays`` (name -> array, fed) and
    ``save_combine`` of all, then ``delete_var``, on ``place``, fetching
    nothing."""
    from paddle_tpu_torch.fluid import framework

    framework.fresh_session()
    names = sorted(arrays)
    save = fluid.Program()
    with fluid.program_guard(save, fluid.Program()):
        block = save.global_block()
        xs = [fluid.layers.data(n, shape=list(arrays[n].shape[1:]),
                                dtype=str(arrays[n].dtype)) for n in names]
        block.append_op(type="save", inputs={"X": [xs[0]]}, outputs={},
                        attrs={"file_path": os.path.join(dirname, "one")})
        block.append_op(type="save_combine", inputs={"X": xs}, outputs={},
                        attrs={"file_path": os.path.join(dirname,
                                                         "all.npz")})
        block.append_op(type="delete_var", inputs={"X": xs}, outputs={})
    fluid.Executor(place).run(save, feed=arrays, fetch_list=[],
                              scope=fluid.Scope())


def checkpoint_load(fluid, place, dirname, arrays):
    """``load`` and ``load_combine`` of ``checkpoint_save``'s files on
    ``place``: the loaded tensors, the first array's then all."""
    from paddle_tpu_torch.fluid import framework

    framework.fresh_session()
    names = sorted(arrays)
    load = fluid.Program()
    with fluid.program_guard(load, fluid.Program()):
        block = load.global_block()
        one = block.create_var(name="one", dtype=str(arrays[names[0]].dtype))
        fluid.layers.load(one, os.path.join(dirname, "one"))
        outs = [block.create_var(name=f"all_{n}", dtype=str(arrays[n].dtype))
                for n in names]
        block.append_op(type="load_combine", inputs={},
                        outputs={"Out": outs},
                        attrs={"file_path": os.path.join(dirname,
                                                         "all.npz")})
    return fluid.Executor(place).run(load, fetch_list=[one] + outs,
                                     scope=fluid.Scope(), return_numpy=False)


def phase_ops_tranche7_parity(tmp):
    """The 31 op types of the misc, quant and metric tranche at the
    per-sample shapes of the public models that use them
    (``T7_SOURCES``; batches ``T7_BATCH``), card against CPU: the dense,
    quant, shape and id ops and the sums (forward and input grads, one
    Program a group, ``tranche7_groups``' tolerances), the metric ops
    (counts equal, metrics within 1e-6); DeepFM's sparse grad through
    ``extract_rows`` / ``split_selected_rows`` (rows and heights equal,
    values within ``SEQ_PARITY_TOL``); the checkpoint ops writing on the
    card and loading on both places (bitwise, on the loading place;
    ``run_steps`` refuses a program that saves); ``get_places``;
    ``random_crop`` on the card: every crop a window of its image, 33
    starts each drawn ~1,000 times within chi-square ``CHI2_32``."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework

    phase = "ops_tranche7_parity"
    t0 = time.perf_counter()
    inputs = tranche7_inputs(np.random.default_rng(23))
    places = (("cpu", fluid.CPUPlace()), ("card", fluid.CUDAPlace(0)))
    covered, result = set(), {}
    for group, specs, tol, of_largest in tranche7_groups():
        framework.fresh_session()
        main, startup, feeds, outs, grads = op_group_program(fluid, specs,
                                                             inputs)
        feed = {n: inputs[k][0] for n, k in feeds.items()}
        runs, secs = [], {}
        for tag, place in places:
            t1 = time.perf_counter()
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            runs.append(exe.run(main, feed=feed, fetch_list=outs + grads,
                                scope=scope, return_numpy=False))
            torch.cuda.synchronize()
            secs[f"{tag}_s"] = time.perf_counter() - t1
        worst = compare_on_card(f"{phase} {group}", outs + grads, *runs, tol,
                                of_largest)
        covered |= {spec[0] for spec in specs}
        result[group] = {"ops": len(specs), "fetches": len(outs + grads),
                         "tol": list(tol), "atol_of_largest": of_largest,
                         "max_abs_err": worst, **secs}
        del feed, runs

    # SelectedRows utilities on DeepFM's sparse grad
    ids = inputs["ids"][0]
    table = np.random.default_rng(5).standard_normal(
        (DEEPFM_VOCAB, DEEPFM_DIM), dtype=np.float32)
    cpu, card = (selected_rows_run(fluid, place, ids, table)
                 for _, place in places)
    compare_on_card(f"{phase} extract_rows", ["rows"], cpu[:1], card[:1],
                    (0.0, 0.0), False)
    for i, (c, g) in enumerate(zip(cpu[1:], card[1:])):
        if c.height != g.height or g.values.device.type != "cuda":
            raise AssertionError(f"{phase}: shard {i} height {g.height} on "
                                 f"{g.values.device}, {c.height} on the CPU")
        compare_on_card(f"{phase} split_selected_rows {i}",
                        ["rows", "values"], [c.rows, c.values],
                        [g.rows, g.values], SEQ_PARITY_TOL, True)
    covered |= {"extract_rows", "split_selected_rows"}

    # checkpoint ops: each place's files read on both places
    arrays = {"conv_w": np.ascontiguousarray(inputs["conv_w"][0][:8]),
              "ids": inputs["ids"][0]}
    names = sorted(arrays)
    want = [arrays[names[0]]] + [arrays[n] for n in names]
    for writer, wplace in places:
        dirname = os.path.join(tmp, f"t7_{writer}")
        os.makedirs(dirname)
        checkpoint_save(fluid, wplace, dirname, arrays)
        for reader, rplace in places:
            got = checkpoint_load(fluid, rplace, dirname, arrays)
            for g, w in zip(got, want):
                if g.device.type != ("cuda" if reader == "card" else "cpu") \
                        or not torch.equal(g.cpu(), torch.from_numpy(w)):
                    raise AssertionError(
                        f"{phase}: {writer}'s file loaded on the {reader} "
                        f"as {g.dtype} {tuple(g.shape)} on {g.device}")
    framework.fresh_session()
    save = fluid.Program()
    with fluid.program_guard(save, fluid.Program()):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        save.global_block().append_op(
            type="save", inputs={"X": [x]}, outputs={},
            attrs={"file_path": os.path.join(tmp, "t7_window")})
    try:
        fluid.Executor().run_steps(save, {"x": np.ones((2, 4), np.float32)},
                                   [], 2, scope=fluid.Scope())
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{phase}: run_steps captured a save")
    if os.path.exists(os.path.join(tmp, "t7_window.npy")):
        raise AssertionError(f"{phase}: run_steps wrote the save's file")
    covered |= {"save", "load", "save_combine", "load_combine",
                "delete_var"}

    # get_places
    framework.fresh_session()
    gp, gp_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(gp, gp_start):
        counted = fluid.layers.get_places()
        four = fluid.layers.get_places(device_count=4)
    places_out = {tag: fluid.Executor(place).run(
        gp, fetch_list=[counted, four], scope=fluid.Scope(),
        return_numpy=False) for tag, place in places}
    card_places = places_out["card"][0]
    if card_places.device.type != "cuda" or card_places.tolist() != list(
            range(torch.cuda.device_count())) or \
            places_out["card"][1].tolist() != [0, 1, 2, 3] or \
            places_out["cpu"][1].tolist() != [0, 1, 2, 3]:
        raise AssertionError(f"{phase}: get_places gave {places_out}")
    covered.add("get_places")

    # random_crop on the card: windows and uniform starts
    framework.fresh_session()
    crops = {}
    b = T7_BATCH
    images = np.arange(b["crop"] * 3 * 256 * 256, dtype=np.float32).reshape(
        b["crop"], 3, 256, 256)
    lines = np.arange(b["crop_draws"] * 40, dtype=np.float32).reshape(
        b["crop_draws"], 40)
    for key, x, shape in (("imagenet", images, [224, 224]),
                          ("draws", lines, [8])):
        prog, prog_start = fluid.Program(), fluid.Program()
        prog.random_seed = 23
        with fluid.program_guard(prog, prog_start):
            xv = fluid.layers.data("x", shape=list(x.shape[1:]),
                                   dtype="float32")
            out = fluid.layers.random_crop(xv, shape)
        exe = fluid.Executor()
        crops[key] = exe.run(prog, feed={"x": x}, fetch_list=[out],
                             scope=fluid.Scope(), return_numpy=False)[0]
        cpu_out = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"x": x}, fetch_list=[out], scope=fluid.Scope(),
            return_numpy=False)[0]
        if crops[key].device.type != "cuda" or \
                crops[key].shape != cpu_out.shape or \
                crops[key].dtype != cpu_out.dtype:
            raise AssertionError(f"{phase}: random_crop {key} "
                                 f"{tuple(crops[key].shape)} on the card, "
                                 f"{tuple(cpu_out.shape)} on the CPU")
    got = crops["imagenet"].cpu().numpy()
    first = got[:, :, 0, 0] - images[:, :, 0, 0]
    row, col = np.divmod(first.astype(np.int64), 256)
    for i in range(b["crop"]):
        if len(set(row[i])) != 1 or len(set(col[i])) != 1 or not \
                np.array_equal(got[i], images[i, :, row[i, 0]:row[i, 0]
                                               + 224, col[i, 0]:col[i, 0]
                                               + 224]):
            raise AssertionError(f"{phase}: crop {i} is no window of its "
                                 f"image")
    starts = (crops["draws"][:, 0].cpu().numpy()
              - lines[:, 0]).astype(np.int64)
    counts = np.bincount(starts, minlength=33)
    expect = b["crop_draws"] / 33
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    windows = lines[np.arange(b["crop_draws"])[:, None],
                    starts[:, None] + np.arange(8)]
    if counts.size != 33 or chi2 > CHI2_32 or not np.array_equal(
            crops["draws"].cpu().numpy(), windows):
        raise AssertionError(f"{phase}: random_crop starts {counts}, "
                             f"chi-square {chi2}")
    covered.add("random_crop")
    if len(covered) != 31:
        raise AssertionError(f"{phase}: ran {sorted(covered)}")
    emit(phase, op_types=len(covered), groups=result, batch_cuts=T7_BATCH,
         sources=T7_SOURCES, run_steps_refused=refused,
         crop_start_counts=counts.tolist(), crop_chi2=chi2,
         crop_chi2_bound=CHI2_32, get_places=card_places.tolist(),
         seconds=time.perf_counter() - t0)
    return covered


# ---------------------------------------------------------------------------
# The remaining optimizers, LARS and ModelAverage (phases 60-64)
# ---------------------------------------------------------------------------

# ResNet-50 under LARS momentum: Momentum(lr, 0.9) with LARS at ResNet-50's
# weight decay in He et al. 2016 (1e-4), and a model average whose window
# closes within the run (the reference's own test takes min 2, max 10).
# This LARS has no trust coefficient (You et al. 2017's eta): a step moves
# each parameter by about lr x its norm, so He et al.'s lr 0.1 diverged to
# NaN at the second step on the CPU (64 px, batch 8, fresh batches), 0.01
# doubled the loss in 20 steps, 1e-3 held it at ln(1000) (random labels)
LARS_LR, LARS_WEIGHT_DECAY = 1e-3, 1e-4
MA_RATE, MA_MIN, MA_MAX = 0.15, 2, 4
LARS_STEPS, LARS_WINDOW_STEPS = 5, 10
# the step-0 LARS rates against the same arithmetic in float64: fp32 sums
# of up to 2.4 M squares
LARS_LR_RTOL = 1e-5
# the book's recognize_digits MLP (two fc of 200 with tanh, a 10-way
# softmax) under Adam(1e-3, LARS_weight_decay=0.3): 3 weights, 3 biases
MNIST_BATCH, MNIST_STEPS, MNIST_LARS_DECAY, MNIST_ADAM_TENSORS = \
    64, 10, 0.3, 6
# card against CPU: losses at step 0 and after it; the sparse one-op
# tables (rtol, atol as a share of the table's largest magnitude: a
# SelectedRows grad's duplicate ids add in another order on each place,
# and FTRL's weights, made from those sums, carried that to ~4e-6 of the
# largest in 5 steps of tests/test_torch_optimizers_rest.py); DeepFM's
# trained tables in the 2-norm (an adaptive step divides a grad by its own
# size, so an element whose grad is rounding noise, as the FM term's
# cancelling sums give, moves by up to lr on one place and not the other:
# 2.3e-4 of fm_v's largest under Adagrad on an H100); one-op
# parity (rtol, atol)
OPTIM_LOSS_RTOL = (1e-5, 1e-4)
OPTIM_TABLE_TOL = (1e-4, 1e-5)
OPTIM_TABLE_NORM_RTOL = 1e-4
OPTIM_DEEPFM_STEPS, OPTIM_PARITY_STEPS = 5, 3
OPTIM_PARITY_TOL = (1e-5, 1e-6)
# each optimizer kind: (class in fluid.optimizer, arguments); ftrl_quarter
# is FTRL's other branch (lr_power -0.25)
OPTIMIZER_ARGS = {
    "adagrad": ("Adagrad", dict(learning_rate=0.05)),
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.01)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "ftrl": ("Ftrl", dict(learning_rate=0.05, l1=1e-3, l2=1e-3)),
    "ftrl_quarter": ("Ftrl", dict(learning_rate=0.05, l1=1e-3, l2=1e-3,
                                  lr_power=-0.25)),
    "proximal_gd": ("ProximalGD", dict(learning_rate=0.05, l1=1e-3,
                                       l2=1e-3)),
    "proximal_adagrad": ("ProximalAdagrad", dict(learning_rate=0.05,
                                                 l1=1e-3, l2=1e-3)),
}
# the kinds whose op folds a SelectedRows grad to dense
FOLDING_KINDS = ("adagrad", "adamax", "decayed_adagrad", "adadelta", "ftrl")
# average_accumulates' seeded counters: num_updates 16,382 and
# num_accumulates 3, so that step 1 closes a window (4 >= min(4, 0.15 x
# 16,383)) and step 2 folds sum_1 into sum_2 (16,384 updates)
MA_SEED_COUNTS = {"num_accumulates": 3, "old_num_accumulates": 5,
                  "num_updates": 16382}


def optimizer_op_type(kind):
    return "ftrl" if kind == "ftrl_quarter" else kind


def make_optimizer(fluid, kind, **kwargs):
    """The optimizer of ``kind`` (``OPTIMIZER_ARGS``) in ``fluid`` (either
    package)."""
    cls, args = OPTIMIZER_ARGS[kind]
    return getattr(fluid.optimizer, cls)(**{**args, **kwargs})


def mnist_lars_programs(fluid, hidden=200, decay=MNIST_LARS_DECAY):
    """The book's recognize_digits MLP in ``fluid`` (either package):
    ``[1, 28, 28]`` images, two fc layers of ``hidden`` with tanh, a
    10-way softmax, cross entropy, ``Adam(1e-3, LARS_weight_decay=
    decay)``.  Returns (main, startup, loss, acc, the LARS rates' names in
    the update ops' order)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(img, hidden, act="tanh")
        h = fluid.layers.fc(h, hidden, act="tanh")
        pred = fluid.layers.fc(h, 10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=1e-3, LARS_weight_decay=decay).minimize(loss)
    lrs = [p.optimize_attr["learning_rate"].name for p, _ in params_grads]
    return main, startup, loss, acc, lrs


def mnist_feed(rng, batch=MNIST_BATCH):
    import numpy as np

    return {"img": rng.uniform(-1, 1, (batch, 1, 28, 28)).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def resnet_lars_programs(fluid, resnet, image_hw=224, class_dim=1000):
    """ResNet-50 (``resnet.resnet_imagenet``, either package) with the
    mean cross entropy under ``Momentum(LARS_LR, 0.9, LARS_weight_decay=
    LARS_WEIGHT_DECAY)``, then ``ModelAverage(MA_RATE, MA_MIN, MA_MAX)``
    and the test clone.  Returns a dict: main, startup, test, loss, acc,
    ma, the parameter and grad names, the LARS rates' names (in the update
    ops' order), the global rate's and the first parameter's counters'."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, image_hw, image_hw],
                                dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        pred = resnet.resnet_imagenet(img, class_dim, depth=50)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        opt = fluid.optimizer.Momentum(
            learning_rate=LARS_LR, momentum=0.9,
            LARS_weight_decay=LARS_WEIGHT_DECAY)
        _, params_grads = opt.minimize(loss)
        ma = fluid.optimizer.ModelAverage(MA_RATE,
                                          min_average_window=MA_MIN,
                                          max_average_window=MA_MAX)
    p0 = ma.params_grads[0][0]
    return {"main": main, "startup": startup,
            "test": main.clone(for_test=True), "loss": loss, "acc": acc,
            "ma": ma, "params": [p.name for p, _ in params_grads],
            "grads": [g.name for _, g in params_grads],
            "lrs": [p.optimize_attr["learning_rate"].name
                    for p, _ in params_grads],
            "global_lr": opt._global_learning_rate(main).name,
            "counters": [ma._get_accumulator(n, p0).name
                         for n in ("num_accumulates",
                                   "old_num_accumulates")]}


def expected_windows(steps, rate=MA_RATE, min_w=MA_MIN, max_w=MA_MAX,
                     na=0, ona=0, nu=0):
    """The (num_accumulates, old_num_accumulates) after each of ``steps``
    updates, by average_accumulates' rule in float64, and the steps (from
    1) that close a window."""
    out, closes = [], []
    for k in range(1, steps + 1):
        na, nu = na + 1, nu + 1
        if na >= min_w and na >= min(float(max_w), rate * nu):
            ona, na = na, 0
            closes.append(k)
        out.append((na, ona))
    return out, closes


def resnet_feeds(n, batch, image_hw, class_dim, seed):
    """``n`` fresh ResNet batches from ``default_rng(seed)``: normal
    images, uniform labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((batch, 3, image_hw, image_hw),
                                        dtype=np.float32),
             "label": rng.integers(0, class_dim, (batch, 1))}
            for _ in range(n)]


def resnet_device_feed(gen, batch, image_hw, class_dim):
    """A fresh ResNet batch drawn on the card from ``gen``: normal images,
    uniform labels (no host copy in the step)."""
    import torch

    return {"img": torch.randn(batch, 3, image_hw, image_hw, generator=gen,
                               device=gen.device),
            "label": torch.randint(0, class_dim, (batch, 1), generator=gen,
                                   device=gen.device)}


@contextlib.contextmanager
def ungrouped():
    """Inside the block a new Executor plan runs every op on its own (no
    group impl), as the members of a group one by one."""
    from paddle_tpu_torch.fluid import executor

    find = executor._find_groups
    executor._find_groups = lambda ops, const_ops: []
    try:
        yield
    finally:
        executor._find_groups = find


@contextlib.contextmanager
def timed_calls(module, name, box):
    """Wrap ``module.name``: each call's host seconds appended to
    ``box``."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            box.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield box
    finally:
        setattr(module, name, fn)


def check_lars_rates(phase, before, grads, rates, lr, decay, rtol):
    """Each LARS rate against ``lr·‖p‖ / (‖g‖ + decay·‖p‖)`` in float64
    from the parameters before the step and its grads; the largest
    relative error."""
    import torch

    worst = 0.0
    for p, g, got in zip(before, grads, rates):
        pn = torch.linalg.vector_norm(p.double())
        gn = torch.linalg.vector_norm(g.double())
        want = float(lr * pn / (gn + decay * pn))
        got = float(got.reshape(-1)[0])
        err = abs(got - want) / abs(want) if want else abs(got)
        if not err <= rtol:
            raise AssertionError(f"{phase}: a LARS rate {got} against "
                                 f"{want} in float64 (rel {err})")
        worst = max(worst, err)
    return worst


def momentum_host_us(scope, params, calls=20):
    """The momentum group wrapper's host µs a call over ResNet-50's 161
    tensors (copies: the training state stays), with the same ``lr``
    tensors each call (the persistent-tensor check cached) and with new
    ones each call, as LARS hands it; also its table's (``_group_cols``)
    share."""
    import torch

    from paddle_tpu_torch.ops import fused

    ps = [scope.get(n).clone() for n in params]
    vs = [torch.zeros_like(p) for p in ps]
    gs = [torch.full_like(p, 1e-3) for p in ps]
    base = [torch.full((1,), 1e-4, device=ps[0].device) for _ in ps]
    out = {}
    for case in ("same_lr", "new_lr"):
        call_s, cols_s = [], []
        with timed_calls(fused, "_group_cols", cols_s):
            for k in range(calls + 2):
                lrs_k = base if case == "same_lr" else \
                    [t.clone() for t in base]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused.momentum_group(ps, gs, vs, lrs_k, 0.9, False)
                call_s.append(time.perf_counter() - t0)
        out[case] = {"call_us": sum(call_s[2:]) / calls * 1e6,
                     "table_us": sum(cols_s[2:]) / calls * 1e6}
    torch.cuda.synchronize()
    return out


def phase_train_resnet_lars_amp(beside, profile_run=False):
    """ResNet-50 in bf16 with kept activations at batch 256 under LARS
    momentum with a model average (``resnet_lars_programs``):
    ``LARS_STEPS`` steps on fresh batches drawn on the card, then
    ``apply()``, one eval batch through the test clone and ``restore()``.
    Holds one momentum launch for 161 tensors a step, no host sync in a
    step (the ops' read counters, and torch's sync debug mode around each
    step's ``Executor.run``), the step-0 LARS rates within
    ``LARS_LR_RTOL`` of float64, the window closes the rule predicts, the
    averaged parameters bitwise numpy's ``(s1 + s2 + s3) / total`` over
    the scope's sums, and after ``restore()`` every parameter the trained
    tensor; prints the eval's loss and accuracy beside the trained
    parameters' on the same batch.  Prints images/s, step ms, dispatches and peak beside
    ``train_resnet_amp``'s, and the momentum wrapper's host µs a call.
    Returns the launch counts."""
    import math
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import fused

    phase = "train_resnet_lars_amp"
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        framework.fresh_session()
        progs = resnet_lars_programs(fluid, resnet)
        main, test, loss, acc = (progs[k] for k in ("main", "test", "loss",
                                                    "acc"))
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(progs["startup"], scope=scope)
        gen = torch.Generator(device="cuda").manual_seed(24)
        feeds = [resnet_device_feed(gen, RESNET_BATCH, 224, 1000)
                 for _ in range(LARS_STEPS + 1)]
        params = progs["params"]
        fetches = [loss, acc] + progs["counters"]
        lr0 = float(scope.get(progs["global_lr"]).reshape(-1)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_host_syncs()
        # step 0: the LARS rates and grads fetched beside the loss
        before = [scope.get(n).clone() for n in params]
        out = exe.run(main, feed=feeds[0], fetch_list=fetches + progs["lrs"]
                      + progs["grads"], scope=scope, return_numpy=False)
        lars_err = check_lars_rates(
            phase, before, out[len(fetches) + len(params):],
            out[len(fetches):len(fetches) + len(params)], lr0,
            LARS_WEIGHT_DECAY, LARS_LR_RTOL)
        del before
        fetched = [out[:len(fetches)]]
        del out
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        host_ms, device_ms, sync_warnings, group_s = [], [], [], []
        with timed_calls(fused, "momentum_group", group_s):
            for step in range(1, LARS_STEPS):
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    t0 = time.perf_counter()
                    start.record()
                    try:
                        fetched.append(exe.run(
                            main, feed=feeds[step], fetch_list=fetches,
                            scope=scope, return_numpy=False))
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    end.record()
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                device_ms.append(start.elapsed_time(end))
                # the mode's own notice ("... is a prototype feature")
                # is no sync
                sync_warnings += [str(w.message).split("\n")[0]
                                  for w in caught if "called a synchronizing"
                                  in str(w.message)]
        counts = launch_counts()
        syncs = host_syncs()
        peak = torch.cuda.max_memory_allocated()
        check_launches(phase, counts,
                       {"momentum": MOMENTUM_PER_STEP,
                        "momentum_tensors": MOMENTUM_TENSORS_PER_STEP},
                       LARS_STEPS)
        if syncs:
            raise AssertionError(f"{phase}: {syncs} host reads in "
                                 f"{LARS_STEPS} steps")
        losses = [float(f[0].reshape(-1)[0]) for f in fetched]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: losses {losses}")
        counters = [(int(f[2].reshape(-1)[0]), int(f[3].reshape(-1)[0]))
                    for f in fetched]
        want, closes = expected_windows(LARS_STEPS)
        if counters != want:
            raise AssertionError(f"{phase}: (num_accumulates, old_num_"
                                 f"accumulates) a step {counters}, the "
                                 f"rule gives {want}")
        dispatches = op_dispatches(exe, main, *fetches)
        # ModelAverage: the averages against numpy's over the scope's sums
        ma = progs["ma"]
        trained = {n: scope.get(n) for n in params}
        copies = {n: t.clone() for n, t in trained.items()}
        if sorted(p.name for p, _ in ma.params_grads) != sorted(params):
            raise AssertionError(f"{phase}: the model average holds other "
                                 f"parameters than the optimizer")
        sums = {p.name: [scope.get(ma._get_accumulator(s, p).name).cpu()
                         .numpy().copy() for s in ma._SUMS]
                for p, _ in ma.params_grads}
        counts_now = {p.name: [int(scope.get(ma._get_accumulator(c, p).name)
                                   .reshape(-1)[0]) for c in ma._COUNTS]
                      for p, _ in ma.params_grads}
        if len({tuple(c) for c in counts_now.values()}) != 1:
            raise AssertionError(f"{phase}: the parameters' counters part")
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            with ma.apply(exe):
                apply_s = time.perf_counter() - t0
                for n in params:
                    s1, s2, s3 = sums[n]
                    na, ona, _ = counts_now[n]
                    want_avg = (s1 + s2 + s3) / float(na + ona)
                    got = scope.get(n)
                    if got is trained[n] or not np.array_equal(
                            got.cpu().numpy(), want_avg):
                        raise AssertionError(f"{phase}: {n}'s average is "
                                             f"not numpy's bitwise")
                ev = exe.run(test, feed=feeds[-1], fetch_list=[loss, acc],
                             scope=scope)
        for n in params:
            if scope.get(n) is not trained[n] or not torch.equal(
                    trained[n], copies[n]):
                raise AssertionError(f"{phase}: restore() left {n} other "
                                     f"than trained")
        eval_loss, eval_acc = (float(v.reshape(-1)[0]) for v in ev)
        if not 0.0 <= eval_acc <= 1.0:
            raise AssertionError(f"{phase}: eval accuracy {eval_acc}")
        # the same batch on the trained parameters, for comparison
        trained_eval = [float(v.reshape(-1)[0]) for v in exe.run(
            test, feed=feeds[-1], fetch_list=[loss, acc], scope=scope)]
        del copies, sums
        host_us = momentum_host_us(scope, params)
        # the first timed step builds the plan of its fetch list
        steady_ms = sum(device_ms[1:]) / len(device_ms[1:])
        emit(phase, model="resnet50", batch=RESNET_BATCH, image_hw=224,
             classes=1000, steps=LARS_STEPS, lars_weight_decay=
             LARS_WEIGHT_DECAY, lr=LARS_LR, model_average=dict(
                 rate=MA_RATE, min_window=MA_MIN, max_window=MA_MAX),
             losses=losses, launches=counts, host_syncs=syncs,
             sync_debug_warnings=len(sync_warnings),
             sync_debug_first=sync_warnings[:3],
             lars_rates=len(progs["lrs"]), lars_rate_max_rel_err=lars_err,
             lars_rate_rtol=LARS_LR_RTOL, counters=counters,
             window_closes_at_step=closes, host_step_ms=host_ms,
             device_step_ms=device_ms, steady_device_step_ms=steady_ms,
             images_per_s=RESNET_BATCH * 1e3 / steady_ms,
             images_per_s_host=RESNET_BATCH * 1e3
             / (sum(host_ms[1:]) / len(host_ms[1:])),
             ops_per_step=len(main.global_block().ops),
             op_dispatches_per_step=dispatches,
             momentum_group_host_us=sum(group_s) / len(group_s) * 1e6,
             momentum_wrapper_host_us=host_us,
             max_memory_allocated=peak, apply_s=apply_s,
             averaged_bitwise_numpy=True, restored_bitwise=True,
             eval_loss=eval_loss, eval_acc=eval_acc,
             eval_loss_finite=math.isfinite(eval_loss),
             trained_eval_loss_acc=trained_eval,
             beside={"train_resnet_amp": beside},
             amp={"dtype": "bfloat16", "keep_activations": True})
        if profile_run:
            profile_step(phase, lambda: exe.run(
                main, feed=feeds[0], fetch_list=fetches, scope=scope),
                {"conv": CONV_KEYS})
    return counts


def phase_train_window_resnet_lars_amp(profile_run=False):
    """The same program as two ``run_steps`` windows of
    ``LARS_WINDOW_STEPS`` against as many ``Executor.run`` steps on the
    same fresh batches (``window_against_steps``): every state tensor, the model average's
    sums and counters included, bitwise, else the loss within 2^-8; one
    graph replay a step after the first; one momentum launch for 161
    tensors a step."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import resnet

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        framework.fresh_session()
        progs = resnet_lars_programs(fluid, resnet)
        per_step = {"momentum": MOMENTUM_PER_STEP,
                    "momentum_tensors": MOMENTUM_TENSORS_PER_STEP}
        # fresh batches: on one batch repeated the net fits it, the grads
        # vanish and the LARS rates grow to lr / weight decay
        feeds = resnet_feeds(2 * LARS_WINDOW_STEPS, RESNET_BATCH, 224, 1000,
                             seed=24)
        exe, _, stats = window_against_steps(
            "train_window_resnet_lars_amp", (progs["main"], progs["startup"]),
            [progs["loss"]], feeds, per_step, RESNET_BATCH, profile_run,
            AMP_PARITY_RTOL, steps=LARS_WINDOW_STEPS)
    exe.close()
    return stats


def phase_train_mnist_lars():
    """The book's recognize_digits MLP (``mnist_lars_programs``) at batch
    ``MNIST_BATCH``, ``MNIST_STEPS`` steps on fresh batches on the CPU and
    on the card from one state: one Adam launch for 6 tensors a step, the
    losses and the six LARS rates within ``OPTIM_LOSS_RTOL``."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework

    phase = "train_mnist_lars"
    framework.fresh_session()
    main, startup, loss, acc, lrs = mnist_lars_programs(fluid)
    rng = np.random.RandomState(24)
    feeds = [mnist_feed(rng) for _ in range(MNIST_STEPS)]
    t0 = time.perf_counter()
    (cpu, card), counts, _ = place_steps(
        (main, startup), feeds, [loss, acc] + lrs, MNIST_STEPS,
        (fluid.CPUPlace(), fluid.CUDAPlace(0)))
    check_launches(phase, counts, {"adam": ADAM_PER_STEP,
                                   "adam_tensors": MNIST_ADAM_TENSORS},
                   MNIST_STEPS)
    rtol = np.array([OPTIM_LOSS_RTOL[0]]
                    + [OPTIM_LOSS_RTOL[1]] * (MNIST_STEPS - 1))
    losses = [np.array([step[0].reshape(-1)[0] for step in run])
              for run in (cpu, card)]
    rel = check_parity(phase, *losses, rtol)
    rates = [np.array([[float(v.reshape(-1)[0]) for v in step[2:]]
                       for step in run]) for run in (cpu, card)]
    if not np.all(np.abs(rates[1] - rates[0])
                  <= rtol[:, None] * np.abs(rates[0])):
        raise AssertionError(f"{phase}: LARS rates card {rates[1]} against "
                             f"CPU {rates[0]}")
    emit(phase, model="book_recognize_digits_mlp", batch=MNIST_BATCH,
         hidden=[200, 200], lars_weight_decay=MNIST_LARS_DECAY,
         steps=MNIST_STEPS, cpu_losses=losses[0].tolist(),
         card_losses=losses[1].tolist(), loss_rel_err=rel,
         rates_step0=rates[1][0].tolist(), launches=counts,
         rtol=rtol.tolist(), seconds_both=time.perf_counter() - t0)
    return counts


def deepfm_optim_programs(fluid, deepfm, kind):
    """``deepfm.build`` (either package) at ``fluid_benchmark.py``'s
    accelerator widths, sparse tables, under ``kind`` (``sgd``: the
    model's own SGD at ``DEEPFM_LR``): (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss = deepfm.build(
            num_fields=DEEPFM_FIELDS, vocab_size=DEEPFM_VOCAB,
            embed_dim=DEEPFM_DIM,
            lr=DEEPFM_LR if kind == "sgd" else None)
        if kind != "sgd":
            make_optimizer(fluid, kind).minimize(loss)
    return main, startup, loss


def close_of_largest(got, want, tol):
    """Whether ``got`` is within ``rtol`` of ``want`` plus ``atol`` of
    ``want``'s largest magnitude, and the largest error over that
    largest."""
    import numpy as np

    rtol, atol = tol
    big = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got.astype(np.float64) - want)
    return bool(np.all(err <= rtol * np.abs(want) + atol * big)), \
        float(err.max() / big)


def phase_train_deepfm_optims():
    """DeepFM (26 fields, 100,000 ids, k = 16, sparse tables, batch 32)
    under SGD and each folding optimizer (``FOLDING_KINDS``),
    ``OPTIM_DEEPFM_STEPS`` steps on fresh batches on the card, then the
    same steps on the CPU from the card's initial state: the losses within
    ``OPTIM_LOSS_RTOL`` and both tables within ``OPTIM_TABLE_NORM_RTOL``
    in the 2-norm (the largest element's error printed); no
    kernel of the port launched and no host read; examples/s, step ms and
    dispatches a step of each."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.models.params import load_reference_params

    phase = "train_deepfm_optims"
    feeds = [deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, 200 + k)
             for k in range(OPTIM_DEEPFM_STEPS)]
    rtol = np.array([OPTIM_LOSS_RTOL[0]]
                    + [OPTIM_LOSS_RTOL[1]] * (OPTIM_DEEPFM_STEPS - 1))
    result = {}
    for kind in ("sgd",) + FOLDING_KINDS:
        framework.fresh_session()
        main, startup, loss = deepfm_optim_programs(fluid, deepfm, kind)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        init = {v.name: scope.get(v.name).cpu().numpy().copy()
                for v in startup.list_vars() if v.persistable}
        reset_launch_counts()
        reset_host_syncs()
        card, host_ms = [], []
        for fd in feeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.append(float(exe.run(main, feed=fd, fetch_list=[loss],
                                      scope=scope)[0].reshape(-1)[0]))
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        counts, syncs = launch_counts(), host_syncs()
        check_launches(f"{phase} {kind}", counts, {}, OPTIM_DEEPFM_STEPS)
        if syncs:
            raise AssertionError(f"{phase} {kind}: {syncs} host reads")
        cexe, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        cexe.run(startup, scope=cscope)
        load_reference_params(cscope, init, fluid.CPUPlace())
        cpu = [float(cexe.run(main, feed=fd, fetch_list=[loss],
                              scope=cscope)[0].reshape(-1)[0])
               for fd in feeds]
        rel = check_parity(f"{phase} {kind}", np.array(cpu), np.array(card),
                           rtol)
        tables = {}
        for t in ("fm_v", "fm_w1"):
            got, want = scope.get(t).cpu().numpy(), cscope.get(t).numpy()
            err = norm_rel_err(got, want)
            if not err <= OPTIM_TABLE_NORM_RTOL:
                raise AssertionError(f"{phase} {kind}: {t} on the card is "
                                     f"{err} from the CPU's in the 2-norm")
            tables[t] = {"norm_rel_err": err, "max_err_of_largest":
                         close_of_largest(got, want, OPTIM_TABLE_TOL)[1]}
        steady = sum(host_ms[1:]) / len(host_ms[1:])
        result[kind] = {"op_type": optimizer_op_type(kind) if kind != "sgd"
                        else "sgd", "card_losses": card,
                        "loss_rel_err": rel, "tables": tables,
                        "host_step_ms": host_ms, "steady_host_step_ms":
                        steady, "examples_per_s": DEEPFM_BATCH * 1e3
                        / steady, "op_dispatches_per_step":
                        op_dispatches(exe, main, loss), "host_syncs": syncs}
        del exe, scope, cexe, cscope, init
    emit(phase, model="deepfm", batch=DEEPFM_BATCH, fields=DEEPFM_FIELDS,
         vocab=DEEPFM_VOCAB, embed_dim=DEEPFM_DIM, steps=OPTIM_DEEPFM_STEPS,
         grad="SelectedRows, folded to dense by each optimizer but sgd",
         loss_rtol=rtol.tolist(), table_norm_rtol=OPTIM_TABLE_NORM_RTOL,
         optimizers=result)


def optim_op_program(fluid, kind, shapes):
    """One update op of ``kind`` (``OPTIMIZER_ARGS``, or
    ``average_accumulates`` through ``ModelAverage``) per shape, in
    ``fluid`` (either package): parameters ``p<i>``, grads fed as
    ``g<i>``.  Returns (main, startup, the grads' names)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        params = [fluid.layers.create_parameter(list(s), "float32",
                                                name=f"p{i}")
                  for i, s in enumerate(shapes)]
        if kind == "average_accumulates":
            fluid.optimizer.ModelAverage(MA_RATE,
                                         min_average_window=MA_MIN,
                                         max_average_window=MA_MAX)
            return main, startup, []
        grads = [fluid.layers.data(f"g{i}", shape=list(s), dtype="float32",
                                   append_batch_size=False)
                 for i, s in enumerate(shapes)]
        make_optimizer(fluid, kind)._create_optimization_pass(
            list(zip(params, grads)), params[0], startup)
    return main, startup, [g.name for g in grads]


def optim_op_state(startup, shapes, rng):
    """A start for ``optim_op_program``'s state: the parameters (and for
    ``ModelAverage`` the sums) normal, the counters ``MA_SEED_COUNTS``,
    every other accumulator as its startup op makes it (absent)."""
    import numpy as np

    state = {}
    for v in startup.list_vars():
        if not v.persistable:
            continue
        name = v.name
        if name.startswith("p") and name[1:].isdigit():
            state[name] = 0.1 * rng.standard_normal(
                shapes[int(name[1:])], dtype=np.float32)
        elif "sum_" in name:
            state[name] = 0.1 * rng.standard_normal(tuple(v.shape),
                                                    dtype=np.float32)
        else:
            for count, value in MA_SEED_COUNTS.items():
                if name.startswith(count + "_"):
                    state[name] = np.full(tuple(v.shape), value, np.int64)
    return state


def sparse_optim_programs(fluid, kind):
    """DeepFM's table (``DEEPFM_VOCAB`` x ``DEEPFM_DIM``) looked up by
    ``DEEPFM_FIELDS`` ids, ``is_sparse=True``, loss the summed square of
    each looked-up value less 1 (grads of order 1: FTRL's l1 keeps its
    weights off 0), under ``kind``: (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("feats", shape=[DEEPFM_FIELDS],
                                dtype="int64")
        emb = fluid.layers.embedding(
            ids, size=[DEEPFM_VOCAB, DEEPFM_DIM], is_sparse=True,
            param_attr=fluid.ParamAttr(name="table"))
        loss = fluid.layers.reduce_sum(fluid.layers.square(
            fluid.layers.scale(emb, bias=-1.0)))
        make_optimizer(fluid, kind).minimize(loss)
    return main, startup, loss


def phase_optim_ops_parity():
    """The 8 new op types, card against CPU: each optimizer kind
    (``OPTIMIZER_ARGS``: FTRL at both ``lr_power`` branches, the proximal
    ops with l1 and l2 > 0) over ResNet-50's 161 parameter shapes, 3 steps
    of fed grads from one state, and ``average_accumulates`` (through
    ``ModelAverage``) from seeded sums and counters (``MA_SEED_COUNTS``:
    step 1 closes a window, step 2 folds); every state tensor within
    ``OPTIM_PARITY_TOL``, counters equal, and the group run (one call
    for the 161) bitwise the same ops run one by one on the card.  Then
    the folding kinds through DeepFM's sparse table (SelectedRows grads),
    and both proximal ops refusing one."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models.params import load_reference_params

    phase = "optim_ops_parity"
    t0 = time.perf_counter()
    shapes = trainable_shapes(build_resnet()[0], MOMENTUM_TENSORS_PER_STEP)
    rng = np.random.default_rng(24)
    grads = [[0.01 * rng.standard_normal(s, dtype=np.float32)
              for s in shapes] for _ in range(OPTIM_PARITY_STEPS)]
    runs = (("cpu", fluid.CPUPlace(), True),
            ("card", fluid.CUDAPlace(0), True),
            ("card_one_by_one", fluid.CUDAPlace(0), False))
    result, covered = {}, set()
    for kind in list(OPTIMIZER_ARGS) + ["average_accumulates"]:
        framework.fresh_session()
        main, startup, gnames = optim_op_program(fluid, kind, shapes)
        state = optim_op_state(startup, shapes, np.random.default_rng(7))
        names = sorted(v.name for v in startup.list_vars() if v.persistable)
        got, secs = {}, {}
        for tag, place, grouped in runs:
            t1 = time.perf_counter()
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            load_reference_params(scope, state, place)
            with contextlib.nullcontext() if grouped else ungrouped():
                for k in range(OPTIM_PARITY_STEPS):
                    exe.run(main, feed=dict(zip(gnames, grads[k])),
                            scope=scope)
                plan = next(p for key, p in exe._plans.items()
                            if key[0] == main._cache_token)
            sizes = sorted(len(r) for r in plan.groups.values())
            if sizes != ([MOMENTUM_TENSORS_PER_STEP] if grouped else []):
                raise AssertionError(f"{phase} {kind}: {tag} ran groups "
                                     f"of {sizes}")
            got[tag] = {n: scope.get(n) for n in names}
            if tag != "cpu":
                torch.cuda.synchronize()
            secs[f"{tag}_s"] = time.perf_counter() - t1
            del exe, scope
        worst = 0.0
        for n in names:
            cpu, card, one = (got[tag][n] for tag, _, _ in runs)
            if not torch.equal(card, one):
                raise AssertionError(f"{phase} {kind}: {n} of the group "
                                     f"is not its ops' one by one")
            if card.dtype == torch.int64:
                if not torch.equal(card.cpu(), cpu):
                    raise AssertionError(f"{phase} {kind}: {n} {card} on "
                                         f"the card, {cpu} on the CPU")
                continue
            err = (card.cpu().double() - cpu.double()).abs()
            bound = OPTIM_PARITY_TOL[0] * cpu.double().abs() \
                + OPTIM_PARITY_TOL[1]
            if not bool((err <= bound).all()):
                raise AssertionError(f"{phase} {kind}: {n} card against "
                                     f"CPU by up to {float(err.max())}")
            worst = max(worst, float(err.max()))
        if kind == "average_accumulates":
            counts = {c: int(got["card"][n].reshape(-1)[0])
                      for n in names for c in MA_SEED_COUNTS
                      if n.startswith(c + "_p0_")}
            (na, ona), = expected_windows(
                OPTIM_PARITY_STEPS, na=MA_SEED_COUNTS["num_accumulates"],
                ona=MA_SEED_COUNTS["old_num_accumulates"],
                nu=MA_SEED_COUNTS["num_updates"])[0][-1:]
            want = {"num_accumulates": na, "old_num_accumulates": ona,
                    "num_updates": MA_SEED_COUNTS["num_updates"]
                    + OPTIM_PARITY_STEPS}
            if counts != want:
                raise AssertionError(f"{phase}: counters {counts}, the "
                                     f"window and fold give {want}")
        covered.add(optimizer_op_type(kind))
        result[kind] = {"tensors": len(names), "max_abs_err": worst, **secs}
        del got
    # SelectedRows grads through DeepFM's table
    ids = [deepfm_feed(DEEPFM_BATCH, DEEPFM_VOCAB, 300 + k)
           for k in range(OPTIM_PARITY_STEPS)]
    loss_rtol = np.array([OPTIM_LOSS_RTOL[0]]
                         + [OPTIM_LOSS_RTOL[1]] * (OPTIM_PARITY_STEPS - 1))
    sparse = {}
    for kind in FOLDING_KINDS:
        framework.fresh_session()
        main, startup, loss = sparse_optim_programs(fluid, kind)
        tables, losses = [], []
        init = None
        for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
            exe, scope = fluid.Executor(place), fluid.Scope()
            exe.run(startup, scope=scope)
            if init is None:
                init = {v.name: scope.get(v.name).cpu().numpy().copy()
                        for v in startup.list_vars() if v.persistable}
            else:
                load_reference_params(scope, init, place)
            losses.append(np.array([float(exe.run(
                main, feed={"feats": fd["feats"]}, fetch_list=[loss],
                scope=scope)[0].reshape(-1)[0]) for fd in ids]))
            tables.append(scope.get("table").cpu().numpy())
        ok, err = close_of_largest(tables[0], tables[1], OPTIM_TABLE_TOL)
        rel = check_parity(f"{phase} sparse {kind}", losses[1], losses[0],
                           loss_rtol)
        if not ok:
            raise AssertionError(f"{phase} sparse {kind}: the table on the "
                                 f"card is {err} of its largest off")
        sparse[kind] = {"loss_rel_err": rel, "table_err_of_largest": err}
    refused = {}
    for kind in ("proximal_gd", "proximal_adagrad"):
        framework.fresh_session()
        main, startup, loss = sparse_optim_programs(fluid, kind)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        try:
            exe.run(main, feed={"feats": ids[0]["feats"]}, scope=scope)
        except TypeError as e:
            if kind not in str(e):
                raise
            refused[kind] = str(e)
        else:
            raise AssertionError(f"{phase}: {kind} ran a SelectedRows grad")
    if len(covered) != 8:
        raise AssertionError(f"{phase}: ran {sorted(covered)}")
    emit(phase, op_types=sorted(covered), tensors=len(shapes),
         elements=int(sum(np.prod(s) for s in shapes)),
         steps=OPTIM_PARITY_STEPS, tol=list(OPTIM_PARITY_TOL),
         kinds=result, sparse=sparse, sparse_refused=refused,
         seconds=time.perf_counter() - t0)


# Transformer-base through fluid.Trainer (the training machinery's slice):
# TRAINER_STEPS steps on one epoch of TRAINER_STEPS batches, a checkpoint
# every TRAINER_INTERVAL steps, the worker killed at TRAINER_KILL_STEP,
# windows of TRAINER_SPD steps
TRAINER_STEPS, TRAINER_INTERVAL, TRAINER_KILL_STEP, TRAINER_SPD = 8, 2, 5, 4
TRAINER_FEEDS = ("src_word", "tgt_word", "lbl_word")
TRAINER_WORKER_TIMEOUT_S = 300
# the guardian drill: grad-Inf at step 2 and a x1e4 loss spike at step 5
# against a cap of 10 x the median of the last 4 clean losses.  A window
# gives the recorder one record (its first trip, else its worst values),
# and the cap needs 4 clean records, so the windowed drill runs 6 windows
# of TRAINER_SPD and spikes step 21, in the sixth
GUARD_INF_STEP, GUARD_SPIKE_STEP, GUARD_SPIKE_FACTOR = 2, 5, 10.0
GUARD_SPIKE_WINDOW, GUARD_WINDOW_STEPS, GUARD_WINDOW_SPIKE_STEP = 4, 24, 21


def trainer_source(n_batches, seed=0):
    """A reader factory of ``n_batches`` x TRAIN_BATCH samples of
    ``bench.py``'s Transformer feed (ids uniform in [1, vocab)), each a
    (src, tgt, lbl) tuple, from a seeded RandomState."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches * TRAIN_BATCH):
            yield (rng.randint(1, VOCAB, size=TRAIN_LEN),
                   rng.randint(1, VOCAB, size=TRAIN_LEN),
                   rng.randint(1, VOCAB, size=(TRAIN_LEN, 1)))
    return reader


def batch_hash(batch):
    import hashlib

    h = hashlib.sha256()
    for sample in batch:
        for a in sample:
            h.update(a.tobytes())
    return h.hexdigest()[:16]


def f32_bits(v):
    import numpy as np

    return np.float32(v).tobytes().hex()


@contextlib.contextmanager
def env_set(**kv):
    """Set (value) or unset (None) environment variables inside the
    block."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def trainer_run(ckpt_dir, n_batches=TRAINER_STEPS, spd=0, interval=None,
                on_event=None, save_log=None, place=None):
    """Transformer-base (6 + 6 layers, d_model 512, vocab 30000, bf16 with
    kept activations, flash attention, label smoothing 0.1, dropout 0,
    Adam 1e-3) through ``fluid.Trainer`` for one epoch of ``n_batches``
    batches of ``data.from_reader(src).shuffle(512, seed=7).batch(64)``,
    in a fresh scope; ``spd`` > 1 runs ``PADDLE_TPU_SPD`` windows;
    ``ckpt_dir``: checkpoints there (max 2) every ``interval`` steps
    (None: no CheckpointConfig).  Returns the run's record: losses by step
    (value and float32 bits), each fed batch's hash, the events, the step
    the run resumed at, every save (its trainer args and ms) and the
    launches."""
    from paddle_tpu_torch import data, fluid
    from paddle_tpu_torch.fluid import trainer as trainer_mod
    from paddle_tpu_torch.models import transformer

    hashes, events, losses, step_ms, saves = [], [], {}, {}, []
    pipe = (data.from_reader(trainer_source(n_batches)).shuffle(512, seed=7)
            .batch(TRAIN_BATCH)
            .map(lambda b: hashes.append(batch_hash(b)) or b))
    cfg = transformer.base_config()
    cfg.flash_attention, cfg.dropout = True, 0.0

    def train_func():
        return transformer.forward(cfg, TRAIN_LEN, TRAIN_LEN)[3]

    def optimizer_func():
        return fluid.optimizer.Adam(learning_rate=1e-3, beta1=0.9,
                                    beta2=0.98, epsilon=1e-9)

    save = trainer_mod.save_checkpoint

    def timed_save(*args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = save(*args, **kwargs)
        saves.append({"serial": serial, "args": kwargs.get("trainer_args"),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "background": bool(kwargs.get("background"))})
        if save_log is not None:
            save_log(args[1], serial)
        return serial

    t_begin = {}

    def handler(ev):
        events.append([type(ev).__name__, getattr(ev, "epoch", None),
                       getattr(ev, "step", None)])
        if isinstance(ev, fluid.BeginStepEvent):
            t_begin[ev.step] = time.perf_counter()
        if isinstance(ev, fluid.EndStepEvent):
            first = min(k for k in t_begin if k <= ev.step)
            step_ms[ev.step] = (time.perf_counter() - t_begin.pop(first)) \
                * 1e3
            if ev.metrics:
                v = float(ev.metrics[0].reshape(-1)[0])
                losses[ev.step] = {"loss": v, "bits": f32_bits(v)}
        if on_event is not None:
            on_event(ev)

    ckpt = (fluid.CheckpointConfig(ckpt_dir, max_num_checkpoints=2,
                                   step_interval=interval)
            if interval else None)
    trainer_mod.save_checkpoint = timed_save
    scope = fluid.Scope()
    try:
        with env_set(PADDLE_TPU_SPD=spd or None, PADDLE_DATA_CKPT=1), \
                fluid.amp.amp_guard("bfloat16", keep_activations=True), \
                fluid.scope_guard(scope):
            t0 = time.perf_counter()
            tr = fluid.Trainer(train_func, optimizer_func, place=place,
                               checkpoint_config=ckpt)
            build_s = time.perf_counter() - t0
            resumed = (ckpt.epoch_id, ckpt.step_id) if ckpt else (0, 0)
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                tr.train(1, handler, reader=pipe, feed_order=TRAINER_FEEDS)
            finally:
                train_s = time.perf_counter() - t0
                counts = launch_counts()
                windows = [{"eager_steps": w.graph.eager_steps,
                            "replays": w.graph.replays,
                            "capture_s": w.graph.capture_s,
                            "graph_pool_bytes": w.graph.pool_bytes}
                           for w in tr.exe._windows.values()]
                tr.exe.close()
    finally:
        trainer_mod.save_checkpoint = save
    return {"losses": losses, "hashes": hashes, "events": events,
            "resumed_at": list(resumed), "saves": saves,
            "step_ms": step_ms, "build_s": build_s, "train_s": train_s,
            "launches": counts, "windows": windows, "trainer": tr,
            "scope": scope}


def trainer_per_step_counts(steps):
    """Every kernel's launches over ``steps`` Transformer-base AMP flash
    steps (bf16 flash and xent, one Adam group)."""
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
    return {k: per_step.get(k, 0) * steps for k in launch_counts()}


def check_trainer_launches(phase, counts, steps):
    want = trainer_per_step_counts(steps)
    if counts != want:
        raise AssertionError(f"{phase}: kernel launches over {steps} "
                             f"Trainer steps: {counts}, expected {want}")


def expected_events(steps, first=0, window=1):
    """The reference Trainer's event sequence for one epoch (epoch 0) of
    steps ``first`` .. ``steps - 1``, a step event pair per window."""
    out = [["BeginEpochEvent", 0, None]]
    for s in range(first, steps, window):
        out += [["BeginStepEvent", 0, s],
                ["EndStepEvent", 0, min(s + window, steps) - 1]]
    return out + [["EndEpochEvent", 0, None]]


def serials(ckpt_dir):
    """``{serial dir: its trainer args, or "incomplete"}`` on disk."""
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if not name.startswith("checkpoint_"):
            continue
        if not os.path.exists(os.path.join(path, "_SUCCESS")):
            out[name] = "incomplete"
            continue
        with open(os.path.join(path, "trainer_args.json")) as f:
            out[name] = json.load(f)
    return out


def public(run):
    return {k: v for k, v in run.items() if k not in ("trainer", "scope")}


def phase_trainer_transformer_amp(tmp):
    """Phase 65: Transformer-base through ``fluid.Trainer``, 8 steps per
    step with a checkpoint every 2 and the data state under _SUCCESS;
    the reference's event order; exactly the kernels of
    ``train_flash_amp`` a step; then an async save beside the sync ones.
    Returns the run (the uninterrupted run the resumes are held to)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.fluid import trainer as trainer_mod

    ckpt = os.path.join(tmp, "trainer_full")
    run = trainer_run(ckpt, interval=TRAINER_INTERVAL)
    check_trainer_launches("trainer_transformer_amp", run["launches"],
                           TRAINER_STEPS)
    if run["events"] != expected_events(TRAINER_STEPS):
        raise AssertionError(f"trainer_transformer_amp: events "
                             f"{run['events']} are not the reference's "
                             f"order")
    losses = [run["losses"][s]["loss"] for s in range(TRAINER_STEPS)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"trainer_transformer_amp: losses {losses}")
    if len(set(run["hashes"])) != TRAINER_STEPS:
        raise AssertionError(f"trainer_transformer_amp: batches "
                             f"{run['hashes']} are not 8 distinct ones")
    on_disk = serials(ckpt)
    want_saves = [{"epoch_id": 0, "step_id": s}
                  for s in range(TRAINER_INTERVAL - 1, TRAINER_STEPS,
                                 TRAINER_INTERVAL)] + \
        [{"epoch_id": 1, "step_id": -1}]
    if [s["args"] for s in run["saves"]] != want_saves or \
            len(on_disk) != 2:
        raise AssertionError(f"trainer_transformer_amp: saves "
                             f"{run['saves']}, on disk {on_disk}")
    # an async save of the same state beside a sync one
    import shutil

    from paddle_tpu_torch import fluid

    tr = run["trainer"]
    timed, dirs = {}, {}
    for background, kind in ((False, "sync"), (True, "async")):
        d = os.path.join(tmp, f"trainer_save_{kind}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fluid.scope_guard(run["scope"]):
            serial = trainer_mod.save_checkpoint(
                tr.exe, d, tr.train_program, trainer_args={"step_id": 7},
                background=background)
        fore_ms = (time.perf_counter() - t0) * 1e3
        trainer_mod.wait_for_checkpoints(d)
        timed[kind] = {"foreground_ms": fore_ms,
                       "total_ms": (time.perf_counter() - t0) * 1e3}
        dirs[kind] = os.path.join(d, f"checkpoint_{serial}")
    same = _dirs_equal(dirs["sync"], dirs["async"])
    if not same:
        raise AssertionError("trainer_transformer_amp: the async save's "
                             "files differ from the sync save's")
    nbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(ckpt) for f in fs) / len(on_disk)
    for d in (ckpt, *dirs.values()):
        shutil.rmtree(d, ignore_errors=True)
    emit("trainer_transformer_amp", model="transformer_base",
         batch=TRAIN_BATCH, seq_len=TRAIN_LEN, steps=TRAINER_STEPS,
         amp={"dtype": "bfloat16", "keep_activations": True},
         losses=losses, loss_bits=[run["losses"][s]["bits"]
                                   for s in range(TRAINER_STEPS)],
         batch_hashes=run["hashes"], events_in_reference_order=True,
         serials_on_disk=on_disk, serial_bytes=nbytes,
         saves=run["saves"], sync_vs_async=timed,
         async_files_bitwise_sync=same,
         launches=run["launches"],
         launches_per_step={k: v / TRAINER_STEPS
                            for k, v in run["launches"].items()},
         host_step_ms=[run["step_ms"][s] for s in range(TRAINER_STEPS)],
         build_s=run["build_s"], train_s=run["train_s"])
    del tr
    run = public(run)
    torch.cuda.empty_cache()
    return run


def _dirs_equal(a, b):
    names = sorted(n for n in os.listdir(a) if n != "trainer_args.json")
    if names != sorted(n for n in os.listdir(b)
                       if n != "trainer_args.json"):
        return False
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            if f.read() != g.read():
                return False
    return True


def trainer_worker(ckpt_dir, out):
    """``chip_smoke.py --trainer-worker DIR --worker-out FILE``: one
    ``trainer_run`` in a process of its own (the kill and the resume of
    phase 66), its record written to FILE.  A kill armed by
    ``PADDLE_FAULT_KILL_STEP`` ends the process with exit code 137 before
    anything is written.  Builds nothing: the kernels come from the
    parent's build under ``build/paddle_tpu_torch/``."""
    import torch

    from paddle_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    # the parent's numerics (phase_device): no TF32 in fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = public(trainer_run(ckpt_dir, interval=TRAINER_INTERVAL))
    run["nvcc_runs"] = sorted(_build.build_logs)
    with open(out, "w") as f:
        json.dump(run, f)


def run_worker(ckpt_dir, out, **env):
    """A ``trainer_worker`` subprocess with ``env`` added; (exit code,
    seconds, its stderr's tail)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--trainer-worker",
         ckpt_dir, "--worker-out", out],
        env={**os.environ, **{k: str(v) for k, v in env.items()}},
        capture_output=True, text=True, timeout=TRAINER_WORKER_TIMEOUT_S)
    return proc.returncode, time.perf_counter() - t0, proc.stderr[-2000:]


def phase_trainer_kill_resume(tmp, full):
    """Phase 66: the Trainer run of phase 65 in a subprocess killed at the
    step-5 boundary (exit 137, checkpoints after steps 1 and 3 on disk);
    an incomplete serial (no _SUCCESS) is left beside them; a second
    subprocess resumes from the newest complete serial and trains steps
    4-7: its losses and fed batches bitwise phase 65's steps 4-7, no step
    replayed, the incomplete serial ignored, nothing rebuilt.  Returns
    the resumed worker's launches."""
    import shutil

    ckpt = os.path.join(tmp, "trainer_kill")
    out1, out2 = (os.path.join(tmp, f"worker{i}.json") for i in (1, 2))
    rc1, s1, err1 = run_worker(ckpt, out1,
                               PADDLE_FAULT_KILL_STEP=TRAINER_KILL_STEP)
    if rc1 != 137 or os.path.exists(out1):
        raise AssertionError(f"trainer_kill_resume: the killed worker "
                             f"exited {rc1} (expected 137): {err1}")
    after_kill = serials(ckpt)
    newest = f"checkpoint_{len(after_kill) - 1}"
    want = {f"checkpoint_{i}": {"epoch_id": 0, "step_id": s}
            for i, s in enumerate(range(TRAINER_INTERVAL - 1,
                                        TRAINER_KILL_STEP, TRAINER_INTERVAL))}
    if after_kill != want:
        raise AssertionError(f"trainer_kill_resume: serials after the kill "
                             f"{after_kill}, expected {want}")
    # a serial cut mid-write: some files, no _SUCCESS, a higher number
    cut = os.path.join(ckpt, f"checkpoint_{len(after_kill)}")
    src = os.path.join(ckpt, newest)
    os.makedirs(cut)
    for n in sorted(os.listdir(src))[:3]:
        if n not in ("_SUCCESS", "trainer_args.json"):
            with open(os.path.join(src, n), "rb") as f:
                payload = f.read()
            with open(os.path.join(cut, n), "wb") as f:
                f.write(payload[:len(payload) // 2])
    rc2, s2, err2 = run_worker(ckpt, out2)
    if rc2 != 0:
        raise AssertionError(f"trainer_kill_resume: the resumed worker "
                             f"exited {rc2}: {err2}")
    with open(out2) as f:
        res = json.load(f)
    first = TRAINER_KILL_STEP - 1
    steps = list(range(first, TRAINER_STEPS))
    got = [res["losses"][str(s)]["bits"] for s in steps]
    want_bits = [full["losses"][s]["bits"] for s in steps]
    checks = {
        "resumed_at": res["resumed_at"] == [0, first],
        "losses_bitwise": got == want_bits,
        "batches_bitwise": res["hashes"] == full["hashes"][first:],
        "no_step_replayed": res["events"] == expected_events(
            TRAINER_STEPS, first),
        "incomplete_serial_ignored": os.path.isdir(cut) and not
        os.path.exists(os.path.join(cut, "_SUCCESS")),
        "nothing_rebuilt": res["nvcc_runs"] == []}
    if not all(checks.values()):
        raise AssertionError(f"trainer_kill_resume: {checks}; resumed "
                             f"losses {got} against {want_bits}")
    check_trainer_launches("trainer_kill_resume", res["launches"],
                           len(steps))
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("trainer_kill_resume", kill_step=TRAINER_KILL_STEP,
         killed_exit_code=rc1, killed_s=s1, serials_after_kill=after_kill,
         incomplete_serial=os.path.basename(cut), resumed_s=s2,
         resumed_at=res["resumed_at"],
         resumed_losses=[res["losses"][str(s)]["loss"] for s in steps],
         uninterrupted_losses=[full["losses"][s]["loss"] for s in steps],
         resumed_batch_hashes=res["hashes"], checks=checks,
         resumed_saves=res["saves"], resumed_build_s=res["build_s"],
         resumed_launches=res["launches"])
    return res["launches"]


def phase_trainer_windowed_amp(tmp, full):
    """Phase 67: the same Trainer under ``PADDLE_TPU_SPD=4`` (two windows,
    the step captured once as a CUDA graph and replayed) through
    ``CheckpointablePrefetcher``: each window's last loss bitwise phase
    65's steps 3 and 7, its batches phase 65's; a checkpoint at each
    window that crosses a step_interval boundary stamped with the
    window's last step; then a resume from the first window's serial
    (its data state the window's, not the prefetch head's) trains the
    second window bitwise again."""
    import shutil

    import torch

    ckpt = os.path.join(tmp, "trainer_window")
    first_serial = os.path.join(tmp, "trainer_window_resume")

    def keep_first(dirname, serial):
        if not os.path.exists(first_serial):
            shutil.copytree(os.path.join(dirname, f"checkpoint_{serial}"),
                            os.path.join(first_serial,
                                         f"checkpoint_{serial}"))

    run = trainer_run(ckpt, spd=TRAINER_SPD, interval=TRAINER_INTERVAL,
                      save_log=keep_first)
    check_trainer_launches("trainer_windowed_amp", run["launches"],
                           TRAINER_STEPS)
    last = [TRAINER_SPD - 1, TRAINER_STEPS - 1]
    got = [run["losses"][s]["bits"] for s in last]
    want = [full["losses"][s]["bits"] for s in last]
    saves = [s["args"] for s in run["saves"]]
    want_saves = [{"epoch_id": 0, "step_id": s} for s in last] + \
        [{"epoch_id": 1, "step_id": -1}]
    checks = {"events": run["events"] == expected_events(
                  TRAINER_STEPS, window=TRAINER_SPD),
              "one_graph_replay_a_step": [
                  (w["eager_steps"], w["replays"]) for w in run["windows"]]
              == [(1, TRAINER_STEPS - 1)],
              "window_losses_bitwise": got == want,
              "staged_batches": run["hashes"] == full["hashes"],
              "checkpoints_at_window_ends": saves == want_saves}
    del run["trainer"], run["scope"]
    torch.cuda.empty_cache()
    resumed = trainer_run(first_serial, spd=TRAINER_SPD,
                          interval=TRAINER_INTERVAL)
    checks["resume_from_first_window"] = (
        resumed["resumed_at"] == [0, TRAINER_SPD]
        and resumed["losses"][TRAINER_STEPS - 1]["bits"] == want[1]
        and resumed["hashes"] == full["hashes"][TRAINER_SPD:])
    if not all(checks.values()):
        raise AssertionError(f"trainer_windowed_amp: {checks}; window "
                             f"losses {got} against {want}; saves {saves}; "
                             f"resumed {public(resumed)['losses']}")
    check_trainer_launches("trainer_windowed_amp (resumed)",
                           resumed["launches"], TRAINER_STEPS - TRAINER_SPD)
    counts = dict(run["launches"])
    add_counts(counts, resumed["launches"])
    emit("trainer_windowed_amp", window_steps=TRAINER_SPD,
         steps=TRAINER_STEPS, window_losses=[run["losses"][s]["loss"]
                                             for s in last],
         per_step_losses=[full["losses"][s]["loss"] for s in last],
         checks=checks, saves=run["saves"], windows=run["windows"],
         host_window_ms=[run["step_ms"][s] for s in last],
         resumed_at=resumed["resumed_at"], launches=counts)
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(first_serial, ignore_errors=True)
    del resumed
    torch.cuda.empty_cache()
    return counts


def scope_tensors(scope):
    """Copies of every tensor of ``scope`` (on the card)."""
    import torch

    return {k: v.clone() for k, v in scope._values.items()
            if isinstance(v, torch.Tensor)}


def guardian_drill(n_batches, spd, spike_step, trips_at, tmp,
                   snapshot=False):
    """Arm the skip guardian (spike factor 10, window 4) and a plan of
    grad-Inf at GUARD_INF_STEP and a x1e4 spike at ``spike_step``, and
    train ``n_batches`` steps through the Trainer (windows of ``spd``
    with spd > 1).  With ``snapshot``: every tensor of the scope before
    each step in ``trips_at``, compared bitwise after it.  Returns (the
    run, the guardian's metrics, its records, the per-trip comparisons,
    the final scope's tensors)."""
    import torch

    from paddle_tpu_torch.fluid import fault, guardian

    fault.install(fault.FaultPlan(grad_inf_step=GUARD_INF_STEP,
                                  loss_spike_step=spike_step, mode="raise"))
    g = guardian.enable("skip", spike_factor=GUARD_SPIKE_FACTOR,
                        spike_window=GUARD_SPIKE_WINDOW,
                        bundle_dir=os.path.join(tmp, "guardian_dumps"))
    before, kept = {}, {}
    holder = {}

    def on_event(ev):
        from paddle_tpu_torch import fluid

        if not snapshot:
            return
        if isinstance(ev, fluid.BeginStepEvent) and ev.step in trips_at:
            before[ev.step] = scope_tensors(fluid.global_scope())
        if isinstance(ev, fluid.EndStepEvent) and ev.step in before:
            after = fluid.global_scope()
            names = sorted(before[ev.step])
            moved = [n for n in names
                     if not torch.equal(before[ev.step][n], after.get(n))]
            kept[ev.step] = {"tensors": len(names), "moved": moved}
            del before[ev.step]

    try:
        run = trainer_run(None, n_batches=n_batches, spd=spd,
                          on_event=on_event)
        final = scope_tensors(run["scope"])
    finally:
        fault.clear()
        guardian.disable()
    holder["records"] = [r.to_dict() for r in g.recorder.records()
                         if not r.ok]
    holder["waits_ms"] = [w * 1e3 for w in g.boundary_waits_s]
    return run, g.metrics(), holder, kept, final


def phase_guardian_transformer_amp(tmp):
    """Phase 68: the guardian on Transformer-base through the Trainer,
    policy skip, grad-Inf at step 2 and a x1e4 loss spike at step 5
    (spike factor 10, window 4), per step: the trips land at steps 2
    and 5 (trips 2, skips 2, nonfinite 1, spikes 1) and after each every
    parameter and Adam moment is bitwise what it was before it; then as
    6 windows of 4 with the spike at step 21 against the same per-step
    run: the same trips and the final state bitwise; the host's wait at
    the boundary a step, sync-debug warnings of a guarded and an
    unguarded step, host step ms guarded beside unguarded; then
    ``dump_and_halt``: NumericsTripped at the step-3 boundary, and the
    bundle's replay on the card reproduces the recorded loss bitwise and
    names the first non-finite variable."""
    import warnings

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import fault, guardian

    counts = {}
    want_metrics = {"trips": 2, "skips": 2, "halts": 0, "spikes": 1,
                    "nonfinite": 1}
    trips = (GUARD_INF_STEP, GUARD_SPIKE_STEP)
    run, metrics, held, kept, _ = guardian_drill(
        TRAINER_STEPS, 0, GUARD_SPIKE_STEP, trips, tmp, snapshot=True)
    add_counts(counts, run["launches"])
    check_trainer_launches("guardian_transformer_amp", run["launches"],
                           TRAINER_STEPS)
    moved = {s: k["moved"] for s, k in kept.items()}
    ok = ({k: metrics[k] for k in want_metrics} == want_metrics
          and [r["step"] for r in held["records"]] == list(trips)
          and sorted(kept) == list(trips)
          and not any(moved.values()))
    if not ok:
        raise AssertionError(f"guardian_transformer_amp: metrics {metrics}, "
                             f"trips {held['records']}, state moved by a "
                             f"tripped step: {moved}")
    per_step = {"metrics": metrics, "trips": held["records"],
                "tensors_compared": {s: k["tensors"]
                                     for s, k in kept.items()},
                "boundary_wait_ms": held["waits_ms"],
                "host_step_ms": [run["step_ms"][s]
                                 for s in range(TRAINER_STEPS)]}
    del run
    torch.cuda.empty_cache()

    # windows against the per-step path, the same faults
    wtrips = (GUARD_INF_STEP, GUARD_WINDOW_SPIKE_STEP)
    steps_run, steps_m, steps_held, _, steps_state = guardian_drill(
        GUARD_WINDOW_STEPS, 0, GUARD_WINDOW_SPIKE_STEP, (), tmp)
    add_counts(counts, steps_run["launches"])
    del steps_run
    torch.cuda.empty_cache()
    win_run, win_m, win_held, _, win_state = guardian_drill(
        GUARD_WINDOW_STEPS, TRAINER_SPD, GUARD_WINDOW_SPIKE_STEP, (), tmp)
    add_counts(counts, win_run["launches"])
    check_trainer_launches("guardian_transformer_amp (windows)",
                           win_run["launches"], GUARD_WINDOW_STEPS)
    differ = sorted(n for n in steps_state
                    if not torch.equal(steps_state[n], win_state.get(n)))
    windows = {"metrics": win_m, "trips": win_held["records"],
               "per_step_metrics": steps_m,
               "per_step_trips": steps_held["records"],
               "state_bitwise_per_step": not differ,
               "tensors_compared": len(steps_state),
               "windows": win_run["windows"],
               "boundary_wait_ms": win_held["waits_ms"]}
    ok = ({k: win_m[k] for k in want_metrics} == want_metrics
          and {k: steps_m[k] for k in want_metrics} == want_metrics
          and [r["step"] for r in win_held["records"]] == list(wtrips)
          and [r["step"] for r in steps_held["records"]] == list(wtrips)
          and not differ)
    if not ok:
        raise AssertionError(f"guardian_transformer_amp (windows): {windows}"
                             f"; differing tensors {differ[:8]}")
    del win_run, steps_state, win_state
    torch.cuda.empty_cache()

    # sync-debug warnings and host ms of one more step, guarded and not
    syncs = {}
    step_host_ms = {}
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, cost = build_training(TRAIN_LEN, dropout=0.0,
                                             flash=True)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        # fed from the card: the step's own host syncs alone are counted
        feed = {k: torch.from_numpy(v).cuda()
                for k, v in train_feed(TRAIN_BATCH, TRAIN_LEN).items()}
        for guarded in (False, True, True, False):
            if guarded:
                guardian.enable("skip")
            exe.run(main, feed=feed, scope=scope)  # a fetch-free step
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                exe.run(main, feed=feed, scope=scope)
                host = (time.perf_counter() - t0) * 1e3
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            kind = "guarded" if guarded else "unguarded"
            syncs.setdefault(kind, []).append(sum(
                "synchroniz" in str(w.message) for w in caught))
            step_host_ms.setdefault(kind, []).append(host)
            guardian.disable()
        exe.close()
        del scope
    torch.cuda.empty_cache()

    # dump_and_halt: the halt at the next boundary, the bundle replayed
    fault.install(fault.FaultPlan(grad_inf_step=GUARD_INF_STEP,
                                  mode="raise"))
    g = guardian.enable("dump_and_halt",
                        bundle_dir=os.path.join(tmp, "guardian_dumps"))
    tripped = None
    try:
        trainer_run(None, n_batches=GUARD_INF_STEP + 2)
    except guardian.NumericsTripped as e:
        tripped = e
    finally:
        fault.clear()
        guardian.disable()
    if tripped is None or tripped.record.step != GUARD_INF_STEP \
            or tripped.bundle is None:
        raise AssertionError(f"guardian_transformer_amp: dump_and_halt "
                             f"raised {tripped!r}")
    t0 = time.perf_counter()
    report = guardian.replay(tripped.bundle, place=fluid.CUDAPlace(0))
    replay_s = time.perf_counter() - t0
    if not (report["bitwise_match"] and report["first_nonfinite"]):
        raise AssertionError(f"guardian_transformer_amp: replay {report}")
    bundle_bytes = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(tripped.bundle) for f in fs)
    emit("guardian_transformer_amp", policy="skip",
         grad_inf_step=GUARD_INF_STEP, loss_spike_step=GUARD_SPIKE_STEP,
         spike_factor=GUARD_SPIKE_FACTOR, spike_window=GUARD_SPIKE_WINDOW,
         per_step=per_step, windows=windows,
         boundary_wait_ms_per_step=float(np.mean(per_step[
             "boundary_wait_ms"])),
         sync_debug_warnings_per_step=syncs,
         host_step_ms_guarded_vs_unguarded=step_host_ms,
         dump_and_halt={"raised_at_step_boundary": tripped.record.step + 1,
                        "record": tripped.record.to_dict(),
                        "bundle_bytes": bundle_bytes,
                        "replay": {k: report[k] for k in (
                            "bitwise_match", "recorded_loss_bits",
                            "replayed_loss_bits", "first_nonfinite",
                            "device", "n_ops")},
                        "replay_s": replay_s},
         launches=counts)
    import shutil

    shutil.rmtree(os.path.join(tmp, "guardian_dumps"), ignore_errors=True)
    del g
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the in-graph readers (phases 69-71)
# ---------------------------------------------------------------------------

# reader_native: shards of packed float32 arrays (64 KiB of values a
# record), two zlib and two uncompressed, read by 2 prefetcher threads
READER_NATIVE_SHARDS, READER_NATIVE_RECORDS = 4, 256
READER_NATIVE_SHAPE, READER_NATIVE_THREADS = (128, 128), 2
# train_resnet_reader_amp: upstream's --use_reader_op path for ResNet-50,
# 384 seeded samples in 2 shards (zlib, uncompressed), batch 64: 6 steps
READER_SAMPLES, READER_BATCH, READER_HW, READER_CLASSES = 384, 64, 224, 1000
READER_STEPS = READER_SAMPLES // READER_BATCH
READER_SEED = 26
# the reader-fed losses against the dict-fed twin's: bitwise when the twin
# repeats itself bitwise; only when two twin runs differ, within this and
# within READER_SPREAD_FACTOR times the twin's own spread, both printed
READER_LOSS_RTOL = 2.0 ** -8
READER_SPREAD_FACTOR = 4.0
# reader_py_lod: a LoD slot through py_reader, shuffle and batch into a
# small sequence model, card against CPU
LOD_VOCAB, LOD_EMB, LOD_CLASSES = 5000, 64, 10
LOD_SAMPLES, LOD_BATCH, LOD_SHUFFLE, LOD_MAX_LEN = 160, 16, 32, 40
LOD_SEED, LOD_EPOCHS = 11, 2
LOD_LOSS_RTOL = 1e-5


def reader_image_samples(n=READER_SAMPLES, hw=READER_HW,
                         classes=READER_CLASSES, seed=READER_SEED):
    """``n`` seeded samples: normal 3 x hw x hw float32 images, int64
    labels in [0, classes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    imgs = rng.normal(size=(n, 3, hw, hw)).astype(np.float32)
    labels = rng.randint(0, classes, size=(n, 1)).astype(np.int64)
    return imgs, labels


def write_image_shards(fluid, tmp, imgs, labels, compressors=(1, 0)):
    """``fluid.recordio_writer.convert_reader_to_recordio_files`` over
    equal consecutive parts of the samples, part i into a shard of its own
    with ``compressors[i]`` (1 zlib, 0 none); either package's ``fluid``.
    Returns the shards' paths in sample order."""
    import importlib

    writer = importlib.import_module(fluid.__name__ + ".recordio_writer")
    hw = imgs.shape[-1]
    prep, prep_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prep, prep_startup):
        img = fluid.layers.data("img", shape=[3, hw, hw], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        feeder = fluid.DataFeeder(feed_list=[img, label],
                                  place=fluid.CPUPlace())
    per = len(imgs) // len(compressors)
    paths = []
    for i, comp in enumerate(compressors):
        part = range(i * per, (i + 1) * per)
        paths += writer.convert_reader_to_recordio_files(
            os.path.join(tmp, f"images_{i}.recordio"), per,
            lambda part=part: ((imgs[k], labels[k]) for k in part), feeder,
            compressor=comp)
    return paths


def resnet_reader_programs(fluid, resnet, paths, batch=READER_BATCH,
                           hw=READER_HW, classes=READER_CLASSES, lr=0.1):
    """Upstream's ``resnet.py --use_reader_op`` input: ``open_files``
    (one thread, one pass) -> ``batch`` -> ``double_buffer`` ->
    ``read_file``, into ``resnet_imagenet`` at depth 50 with
    ``build_resnet``'s loss, accuracy and ``Momentum(lr, 0.9)``; built
    under ``unique_name.guard()``, so its parameters are named as
    ``build_resnet``'s."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.open_files(
            paths, shapes=[[-1, 3, hw, hw], [-1, 1]],
            dtypes=["float32", "int64"], thread_num=1, pass_num=1)
        reader = fluid.layers.double_buffer(fluid.layers.batch(reader,
                                                               batch))
        img, label = fluid.layers.read_file(reader)
        prediction = resnet.resnet_imagenet(img, classes, depth=50)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=prediction, label=label))
        acc = fluid.layers.accuracy(input=prediction, label=label)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(
            loss)
    return {"main": main, "startup": startup, "loss": loss, "acc": acc,
            "reader": reader, "img": img, "label": label}


def reader_lod_programs(fluid, by_data=False, double=True, vocab=LOD_VOCAB,
                        emb=LOD_EMB, classes=LOD_CLASSES, batch=LOD_BATCH,
                        shuffle_buf=LOD_SHUFFLE):
    """A LoD slot (word ids) and a label through ``py_reader`` (or
    ``create_py_reader_by_data`` over two data vars), ``shuffle`` and
    ``batch``, into ``embedding`` -> ``sequence_pool`` (sum) -> ``fc`` ->
    softmax cross entropy, ``SGD(0.1)``; either package's ``fluid``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if by_data:
            words = fluid.layers.data("words", shape=[1], dtype="int64",
                                      lod_level=1)
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            reader = fluid.layers.create_py_reader_by_data(
                capacity=8, feed_list=[words, label],
                use_double_buffer=double)
        else:
            reader = fluid.layers.py_reader(
                capacity=8, shapes=[[-1, 1], [-1, 1]],
                dtypes=["int64", "int64"], lod_levels=[1, 0],
                use_double_buffer=double)
        reader = fluid.layers.batch(fluid.layers.shuffle(reader, shuffle_buf),
                                    batch)
        words, label = fluid.layers.read_file(reader)
        vec = fluid.layers.embedding(words, size=[vocab, emb])
        pooled = fluid.layers.sequence_pool(vec, "sum")
        logits = fluid.layers.fc(pooled, size=classes)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"main": main, "startup": startup, "loss": loss,
            "reader": reader, "words": words, "label": label}


def lod_samples(n=LOD_SAMPLES, vocab=LOD_VOCAB, classes=LOD_CLASSES,
                max_len=LOD_MAX_LEN, seed=LOD_SEED):
    """``n`` seeded (word ids, [label]) samples of 1 to ``max_len``
    words."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=int(rng.randint(1, max_len + 1)))
             .tolist(), [int(rng.randint(0, classes))]) for _ in range(n)]


def host_array(v):
    """A fetched value of either package as a host numpy array."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def lod_reader_epochs(fluid, progs, samples, place, init=None,
                      epochs=LOD_EPOCHS, seed=LOD_SEED):
    """Train ``progs`` on ``place`` from ``init`` (the startup's values
    when None) for ``epochs`` passes of ``start`` / run until
    ``EOFException`` / ``reset``, the shuffle seeded per epoch: (losses,
    the word slot's LoD, steps, by epoch, and the initial values)."""
    import random

    import numpy as np

    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(progs["startup"], scope=scope)
    if init is None:
        init = {v.name: np.array(scope.get(v.name))
                for v in progs["startup"].list_vars() if v.persistable}
    else:
        from paddle_tpu_torch.models.params import load_reference_params

        load_reference_params(scope, init, place)
    reader = progs["reader"]
    reader.decorate_paddle_reader(lambda: ([s] for s in samples))
    losses, lods, steps = [], [], []
    for epoch in range(epochs):
        random.seed(seed + epoch)
        reader.start()
        n = 0
        while True:
            try:
                loss, words = exe.run(
                    progs["main"], fetch_list=[progs["loss"],
                                               progs["words"]],
                    scope=scope, return_numpy=False)
            except fluid.core.EOFException:
                reader.reset()
                break
            losses.append(float(host_array(loss).reshape(-1)[0]))
            lods.append(tuple(tuple(level) for level in words.lod()))
            n += 1
        steps.append(n)
    return losses, lods, steps, init


def phase_reader_native(tmp):
    """The port's native library built by g++ here; a zlib and an
    uncompressed shard round trip through it and through the plain
    versions; a corrupt chunk raises; ``PrefetchReader`` over 4 shards
    with 2 threads yields every record once, native and plain, with their
    MB/s (the shards just written: a warm page cache)."""
    import numpy as np

    from paddle_tpu_torch import native
    from paddle_tpu_torch.native.tensor_pack import pack_batch

    phase = "reader_native"
    t0 = time.perf_counter()
    native.get_lib()
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(READER_SEED)
    recs = [rng.bytes(n) for n in (1, 10, 1000, 100000)] + [bytes(4096),
                                                            b""]
    roundtrip = {}
    for comp in (1, 0):
        files = []
        for plain in (False, True):
            path = os.path.join(tmp, f"rt_{comp}_{int(plain)}.recordio")
            with native.RecordIOWriter(path, compressor=comp,
                                       max_chunk_bytes=8192,
                                       plain=plain) as w:
                for r in recs:
                    w.write(r)
            files.append(path)
            for read_plain in (False, True):
                got = list(native.RecordIOScanner(path, plain=read_plain))
                if got != recs:
                    raise AssertionError(f"{phase}: compressor {comp} "
                                         f"written plain={plain}, read "
                                         f"plain={read_plain}: records "
                                         f"differ")
        same = open(files[0], "rb").read() == open(files[1], "rb").read()
        if not same:
            raise AssertionError(f"{phase}: the library and the plain "
                                 f"writer wrote other bytes (compressor "
                                 f"{comp})")
        roundtrip["zlib" if comp else "none"] = os.path.getsize(files[0])
    bad = os.path.join(tmp, "corrupt.recordio")
    data = bytearray(open(os.path.join(tmp, "rt_1_0.recordio"),
                          "rb").read())
    data[-3] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    for plain in (False, True):
        try:
            list(native.RecordIOScanner(bad, plain=plain))
        except IOError:
            continue
        raise AssertionError(f"{phase}: a corrupt chunk read without error "
                             f"(plain={plain})")
    # the prefetcher: every record once, native and plain
    paths, expected = [], []
    for s in range(READER_NATIVE_SHARDS):
        path = os.path.join(tmp, f"prefetch_{s}.recordio")
        with native.RecordIOWriter(path, compressor=int(s < 2)) as w:
            for i in range(READER_NATIVE_RECORDS):
                rec = pack_batch([(np.array([s, i], np.int64), ()),
                                  (rng.normal(size=READER_NATIVE_SHAPE)
                                   .astype(np.float32), ())])
                w.write(rec)
                expected.append(rec)
        paths.append(path)
    total = sum(len(r) for r in expected)
    rates, got = {}, {}
    for kind, plain in (("native", False), ("plain", True),
                        ("native_again", False)):
        t0 = time.perf_counter()
        got[kind] = list(native.PrefetchReader(
            paths, n_threads=READER_NATIVE_THREADS, plain=plain))
        rates[kind] = total / (time.perf_counter() - t0) / 1e6
    want = sorted(expected)
    for kind, recs_got in got.items():
        if sorted(recs_got) != want:
            raise AssertionError(f"{phase}: {kind} prefetcher yielded "
                                 f"{len(recs_got)} records, not each of "
                                 f"the {len(want)} once")
    emit(phase, build_s=native.build_seconds, load_s=load_s,
         library=os.path.relpath(native.library_path()),
         roundtrip_bytes=roundtrip, library_equals_plain_bytes=True,
         corrupt_chunk_raises=True, shards=READER_NATIVE_SHARDS,
         threads=READER_NATIVE_THREADS, records=len(expected),
         megabytes=total / 1e6, mb_per_s=rates,
         native_over_plain=rates["native"] / rates["plain"],
         page_cache="warm")


def timed_runs(exe, program, fetches, scope, feeds, state=None):
    """Run ``program`` once per feed (None: the readers feed it): (the
    fetched values, each step's host ms and CUDA-event ms, the sync-debug
    warnings of the steps, and with a reader's ``state`` the ms each
    step's read op waited)."""
    import warnings

    import torch

    fetched, host_ms, device_ms, syncs, waits = [], [], [], [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for feed in feeds:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            start.record()
            try:
                fetched.append(exe.run(program, feed=feed,
                                       fetch_list=fetches, scope=scope,
                                       return_numpy=False))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        syncs += [str(w.message).split("\n")[0] for w in caught
                  if "called a synchronizing" in str(w.message)]
        if state is not None:
            waits.append(state.stats["wait_s"] * 1e3 - sum(waits))
    return fetched, host_ms, device_ms, syncs, waits


def phase_train_resnet_reader_amp(tmp):
    """Upstream's ``--use_reader_op`` path at ResNet-50's full width:
    ``READER_SAMPLES`` seeded samples written into 2 recordio shards
    (zlib, uncompressed) by ``convert_reader_to_recordio_files``, read by
    ``open_files`` -> ``batch`` -> ``double_buffer`` -> ``read_file`` in
    bf16 AMP with kept activations: ``READER_STEPS`` steps, then
    ``EOFException``; after ``reset()`` / ``start()`` pass 2's first
    batch bitwise pass 1's.  The twin, ``build_resnet``'s program on data
    vars from a clone of the same initial scope, is fed the same batches
    from numpy: every popped batch bitwise its numpy batch, the losses
    bitwise the twin's (only where two twin runs differ, within
    ``READER_LOSS_RTOL`` and ``READER_SPREAD_FACTOR`` times the twin's own
    spread), 1 momentum launch for 161 tensors a step and no other,
    no sync-debug warning in a reader-fed step.  Prints host and
    CUDA-event ms a step each way, the read op's mean wait, images/s and
    peak memory.  Returns the launch counts."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework
    from paddle_tpu_torch.models import resnet

    phase = "train_resnet_reader_amp"
    t0 = time.perf_counter()
    imgs, labels = reader_image_samples()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = write_image_shards(fluid, tmp, imgs, labels)
    write_s = time.perf_counter() - t0
    shard_bytes = [os.path.getsize(p) for p in paths]
    batches = [(imgs[k:k + READER_BATCH], labels[k:k + READER_BATCH])
               for k in range(0, READER_SAMPLES, READER_BATCH)]
    total = {}
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        framework.fresh_session()
        progs = resnet_reader_programs(fluid, resnet, paths)
        twin_main, twin_startup, twin_loss, twin_acc = build_resnet()
        main, reader = progs["main"], progs["reader"]
        test = main.clone(for_test=True)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(progs["startup"], scope=scope)
        init = clone_scope(scope)
        state = reader._reader_state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reader.start()
        fetches = [progs["loss"], progs["acc"], progs["img"], progs["label"]]
        fetched, host_ms, device_ms, syncs, waits = timed_runs(
            exe, main, fetches, scope, [None] * READER_STEPS, state)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        pops = state.stats["pops"]
        wait_ms = state.stats["wait_s"] / pops * 1e3
        try:
            exe.run(main, fetch_list=[progs["loss"]], scope=scope)
        except fluid.core.EOFException:
            eof = True
        else:
            eof = False
        if not eof:
            raise AssertionError(f"{phase}: run {READER_STEPS + 1} popped "
                                 f"a batch after {READER_SAMPLES} samples")
        check_launches(phase, counts,
                       {"momentum": MOMENTUM_PER_STEP,
                        "momentum_tensors": MOMENTUM_TENSORS_PER_STEP},
                       READER_STEPS)
        add_counts(total, counts)
        if syncs:
            raise AssertionError(f"{phase}: sync-debug warnings in the "
                                 f"reader-fed steps: {syncs[:3]}")
        for k, (f, (x, y)) in enumerate(zip(fetched, batches)):
            if not (np.array_equal(f[2].cpu().numpy(), x)
                    and np.array_equal(f[3].cpu().numpy(), y)):
                raise AssertionError(f"{phase}: popped batch {k} is not "
                                     f"its numpy batch bitwise")
        # pass 2: the first batch again, through the test clone (no step)
        reader.reset()
        reader.start()
        again = exe.run(test, fetch_list=[progs["img"], progs["label"]],
                        scope=scope)
        reader.reset()
        if not (np.array_equal(again[0], batches[0][0])
                and np.array_equal(again[1], batches[0][1])):
            raise AssertionError(f"{phase}: pass 2's first batch differs "
                                 f"from pass 1's")
        losses = [float(f[0].reshape(-1)[0]) for f in fetched]
        del fetched
        # the dict-fed twin from the same initial state
        twin = []
        for run in range(2):
            reset_launch_counts()
            twin_scope = clone_scope(init)
            out, twin_host, twin_device, twin_syncs, _ = timed_runs(
                exe, twin_main, [twin_loss, twin_acc], twin_scope,
                [{"img": x, "label": y} for x, y in batches])
            add_counts(total, launch_counts())
            twin.append([float(f[0].reshape(-1)[0]) for f in out])
            del twin_scope, out
            if run == 0 and twin[0] == losses:
                break
        bitwise = losses in twin
        spread = (max(abs(a - b) / abs(b) for a, b in zip(*twin))
                  if len(twin) == 2 else 0.0)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, twin[0]))
        # a twin that repeats itself bitwise leaves no room for a
        # difference: only cuDNN's own spread may be tolerated
        if not bitwise and (spread == 0.0 or rel > READER_LOSS_RTOL
                            or rel > READER_SPREAD_FACTOR * spread):
            raise AssertionError(f"{phase}: reader-fed losses {losses} "
                                 f"against the dict-fed {twin} (rel {rel}, "
                                 f"the twin's own spread {spread})")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: losses {losses}")
        steady = device_ms[1:]
        emit(phase, model="resnet50", batch=READER_BATCH,
             image_hw=READER_HW, classes=READER_CLASSES,
             samples=READER_SAMPLES, steps=READER_STEPS, shards=len(paths),
             shard_bytes=shard_bytes, compressors=[1, 0], sample_gen_s=gen_s,
             write_s=write_s, losses=losses, twin_losses=twin[0],
             losses_bitwise_twin=bitwise, loss_max_rel_err=rel,
             twin_runs=len(twin), twin_self_rel_spread=spread,
             loss_rel_limit=(0.0 if spread == 0.0 else
                             min(READER_LOSS_RTOL,
                                 READER_SPREAD_FACTOR * spread)),
             batches_bitwise=True, eof_after=READER_STEPS,
             pass2_first_batch_bitwise=True, launches=counts,
             sync_debug_warnings=len(syncs),
             twin_sync_debug_warnings=len(twin_syncs),
             host_step_ms=host_ms, device_step_ms=device_ms,
             twin_host_step_ms=twin_host, twin_device_step_ms=twin_device,
             read_wait_ms_mean=wait_ms, read_pops=pops, read_wait_ms=waits,
             steady_device_step_ms=sum(steady) / len(steady),
             twin_steady_device_step_ms=sum(twin_device[1:])
             / len(twin_device[1:]),
             images_per_s=READER_BATCH * 1e3 / (sum(steady) / len(steady)),
             images_per_s_host=READER_BATCH * 1e3
             / (sum(host_ms[1:]) / len(host_ms[1:])),
             twin_images_per_s_host=READER_BATCH * 1e3
             / (sum(twin_host[1:]) / len(twin_host[1:])),
             max_memory_allocated=peak,
             amp={"dtype": "bfloat16", "keep_activations": True})
    return total


def phase_reader_py_lod():
    """``py_reader`` with a LoD slot (``decorate_paddle_reader``, a seeded
    ``shuffle`` and ``batch``) into a small sequence model, 2 epochs of
    ``start`` / ``EOFException`` / ``reset`` on the card and on the CPU:
    losses within ``LOD_LOSS_RTOL``, LoD offsets equal, the same step
    counts each epoch; ``create_py_reader_by_data`` builds the same ops
    and gives the same losses; a ``Preprocessor`` (``scale``) on the card
    hands out the transformed batches; a producer error raises
    ``RuntimeError`` (not EOF)."""
    import numpy as np

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework

    phase = "reader_py_lod"
    samples = lod_samples()
    card = fluid.CUDAPlace(0)
    framework.fresh_session()
    progs = reader_lod_programs(fluid)
    ops = [op.type for op in progs["main"].global_block().ops]
    cpu_losses, cpu_lods, cpu_steps, init = lod_reader_epochs(
        fluid, progs, samples, fluid.CPUPlace())
    losses, lods, steps, _ = lod_reader_epochs(fluid, progs, samples, card,
                                               init=init)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    want_steps = [LOD_SAMPLES // LOD_BATCH] * LOD_EPOCHS
    if steps != want_steps or cpu_steps != want_steps:
        raise AssertionError(f"{phase}: steps by epoch {steps} (card), "
                             f"{cpu_steps} (CPU); expected {want_steps}")
    if lods != cpu_lods or rel > LOD_LOSS_RTOL:
        raise AssertionError(f"{phase}: card against CPU: LoDs equal "
                             f"{lods == cpu_lods}, losses rel {rel}")
    framework.fresh_session()
    by_data = reader_lod_programs(fluid, by_data=True)
    by_data_ops = [op.type for op in by_data["main"].global_block().ops]
    data_losses, data_lods, _, _ = lod_reader_epochs(
        fluid, by_data, samples, card, init=init)
    data_rel = max(abs(a - b) / abs(b) for a, b in zip(data_losses, losses))
    if by_data_ops != ops or data_lods != lods or data_rel > LOD_LOSS_RTOL:
        raise AssertionError(f"{phase}: create_py_reader_by_data: same ops "
                             f"{by_data_ops == ops}, LoDs "
                             f"{data_lods == lods}, losses rel {data_rel}")
    # a Preprocessor on the card: scale by 0.5 (exact) before the step
    framework.fresh_session()
    rd = fluid.layers.py_reader(capacity=4, shapes=[[-1, 8], [-1, 1]],
                                dtypes=["float32", "int64"])
    pre = fluid.layers.Preprocessor(rd)
    with pre.block():
        x_in, y_in = pre.inputs()
        pre.outputs(fluid.layers.scale(x_in, scale=0.5), y_in)
    x, y = fluid.layers.read_file(pre())
    rng = np.random.RandomState(LOD_SEED)
    raw = [(rng.normal(size=(4, 8)).astype(np.float32),
            rng.randint(0, 5, size=(4, 1)).astype(np.int64))
           for _ in range(3)]
    rd.decorate_tensor_provider(lambda: (list(b) for b in raw))
    exe = fluid.Executor(card)
    rd.start()
    got = [exe.run(fluid.default_main_program(), fetch_list=[x, y])
           for _ in raw]
    rd.reset()
    if not all(np.array_equal(g[0], b[0] * 0.5) and np.array_equal(g[1], b[1])
               for g, b in zip(got, raw)):
        raise AssertionError(f"{phase}: the Preprocessor's batches are not "
                             f"the scaled inputs")
    # a producer error is an error, not the end of the data
    framework.fresh_session()
    rd = fluid.layers.py_reader(capacity=4, shapes=[[-1, 2]],
                                dtypes=["float32"])
    xv = fluid.layers.read_file(rd)

    def failing():
        yield [np.zeros((2, 2), np.float32)]
        raise ValueError("bad record")

    rd.decorate_tensor_provider(failing)
    rd.start()
    exe.run(fluid.default_main_program(), fetch_list=[xv])
    try:
        exe.run(fluid.default_main_program(), fetch_list=[xv])
    except RuntimeError as exc:
        error = str(exc)
    else:
        error = None
    rd.reset()
    if error is None or "producer thread failed" not in error:
        raise AssertionError(f"{phase}: a producer error gave {error!r}")
    emit(phase, samples=LOD_SAMPLES, batch=LOD_BATCH, shuffle=LOD_SHUFFLE,
         vocab=LOD_VOCAB, emb=LOD_EMB, epochs=LOD_EPOCHS, steps=steps,
         losses=losses, cpu_losses=cpu_losses, loss_max_rel_err=rel,
         loss_rtol=LOD_LOSS_RTOL, lods_equal=True,
         losses_bitwise_cpu=losses == cpu_losses,
         by_data_same_ops=True, by_data_loss_max_rel_err=data_rel,
         preprocessor_batches_exact=True, producer_error=error)


# fluid_benchmark.py's moe_transformer on an accelerator: Transformer-base
# widths with every FFN an 8-expert MoE layer (top 2, capacity factor
# 1.25, aux weight 1e-2; dropout 0.1), batch 32 x 256 (its defaults); 12
# moe_ffn ops, each a generic grad; the 18 attentions and the loss as
# Transformer-base's.  One Adam launch for the group of 196 adam ops (184
# with 5 MoE tensors in place of each FFN's 4)
MOE_BATCH, MOE_LEN, MOE_STEPS, MOE_EXPERTS, MOE_LAYERS = 32, 256, 5, 8, 12
MOE_ADAM_TENSORS = 196
# the one full-width moe_ffn op of moe_parity: 32 x 256 tokens of width
# 512, hidden 2048
MOE_OP_TOKENS, MOE_OP_D, MOE_OP_H = MOE_BATCH * MOE_LEN, 512, 2048
# the stacked Transformer-base (Config.stacked) at bench.py's 64 x 256:
# one encoder and one decoder stack op, the 18 attentions inside them,
# each launching the flash forward in the op and again in the op's grad's
# re-run; 34 adam ops (12 + 18 stacked slots, 2 tables, the output
# projection's weight and bias)
STACK_STEPS, STACK_DROPOUT = 5, 0.1
STACK_ADAM_TENSORS = 34


def flash_amp_per_step():
    """One bf16 Transformer-base step's launches through the flash kernels:
    every attention's flash forward twice, dQ and dK/dV once, the bf16
    xent forward twice and backward once, one Adam launch."""
    return {"flash_fwd": FLASH_FWD_PER_STEP,
            "flash_fwd_bf16": FLASH_FWD_PER_STEP,
            "flash_dq": FLASH_DQ_PER_STEP, "flash_dq_bf16": FLASH_DQ_PER_STEP,
            "flash_dkv": FLASH_DKV_PER_STEP,
            "flash_dkv_bf16": FLASH_DKV_PER_STEP,
            "softmax_xent_fwd": XENT_FWD_PER_STEP,
            "softmax_xent_fwd_bf16": XENT_FWD_PER_STEP,
            "softmax_xent_bwd": XENT_BWD_PER_STEP,
            "softmax_xent_bwd_bf16": XENT_BWD_PER_STEP,
            "adam": ADAM_PER_STEP}


@contextlib.contextmanager
def routed():
    """Record each MoE forward's routing (the op's own run, not its
    generic grad's re-run, whose x and gate are autograd leaves): per call
    the tokens each expert kept, on the device."""
    from paddle_tpu_torch.parallel import moe

    route, kept = moe.route, []

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        if not any(t.requires_grad for t in args[:2]):
            kept.append(r.kept)
        return r

    moe.route = recording
    try:
        yield kept
    finally:
        moe.route = route


@contextlib.contextmanager
def annotated_ops(op_types, label):
    """Each executor run of an op of ``op_types`` inside a profiler range
    named ``label``."""
    import torch

    from paddle_tpu_torch.fluid import executor

    run_op = executor.run_op

    def wrapped(op, *args, **kwargs):
        if op.type in op_types:
            with torch.profiler.record_function(label):
                return run_op(op, *args, **kwargs)
        return run_op(op, *args, **kwargs)

    executor.run_op = wrapped
    try:
        yield
    finally:
        executor.run_op = run_op


@contextlib.contextmanager
def op_peaks(op_types):
    """Each executor run of an op of ``op_types``: the most memory it
    allocated above what was allocated as it began (bytes), in order."""
    import torch

    from paddle_tpu_torch.fluid import executor

    run_op, peaks = executor.run_op, []

    def wrapped(op, *args, **kwargs):
        if op.type not in op_types:
            return run_op(op, *args, **kwargs)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run_op(op, *args, **kwargs)
        peaks.append(torch.cuda.max_memory_allocated() - before)
        return out

    executor.run_op = wrapped
    try:
        yield peaks
    finally:
        executor.run_op = run_op


def op_device_share(run, op_types, label="ops_of_interest"):
    """One more step ``run()`` under ``torch.profiler`` with the ops of
    ``op_types`` annotated: the device time of the kernels they launched
    (matched to their launch calls by correlation id) and its share of the
    step's device busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with annotated_ops(set(op_types), label), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_trace()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pad_trace()
    events = trace_events(prof)
    spans = device_spans(prof, events)
    busy_s, n_events, _ = trace_summary(spans)
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == label
                    and e.get("cat") == "user_annotation")
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}

    def inside(ts):
        return any(a <= ts <= b for a, b in ranges)

    ours = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and inside(launches.get(e.get("args", {}).get("correlation"),
                                    -1.0))]
    us = sum(e["dur"] for e in ours)
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall, "device_events": n_events,
            "ops": len(ranges), "their_device_events": len(ours),
            "their_device_ms": us / 1e3,
            "their_share_of_busy": us / 1e6 / busy_s}


def phase_train_moe_amp(profile_run=False):
    """``fluid_benchmark.py``'s ``moe_transformer`` on the card: the
    Transformer-base widths with every FFN an ``MOE_EXPERTS``-expert
    ``moe_ffn`` (top 2, capacity factor 1.25, aux weight 1e-2, dropout
    0.1), batch ``MOE_BATCH`` x ``MOE_LEN`` (``train_feed``), bf16 AMP with
    kept activations, through the flash kernels: ``MOE_STEPS`` steps,
    finite losses; exactly ``flash_amp_per_step``'s launches a step with
    one Adam launch for ``MOE_ADAM_TENSORS`` tensors; per step each
    expert's kept tokens over the 12 layers, the share of choices dropped
    and the aux losses; tokens/s and step ms by CUDA events and the host
    clock, peak allocated, dispatches a step; under ``--profile`` the MoE
    ops' (forward and generic grad) share of the device's busy time.
    Returns the launch counts and the step's numbers."""
    import math

    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        main, startup, cost = build_training(MOE_LEN, flash=True,
                                             moe=MOE_EXPERTS)
        auxes = [op.output("AuxLoss")[0] for op in main.global_block().ops
                 if op.type == "moe_ffn"]
        if len(auxes) != MOE_LAYERS:
            raise AssertionError(f"train_moe_amp: {len(auxes)} moe_ffn ops")
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = train_feed(MOE_BATCH, MOE_LEN)
        torch.cuda.reset_peak_memory_stats()
        with routed() as kept:
            out, host_ms, device_ms, counts = timed_steps(
                exe, main, feed, [cost] + auxes, scope, MOE_STEPS)
        peak = torch.cuda.max_memory_allocated()
        per_step = dict(flash_amp_per_step(), adam_tensors=MOE_ADAM_TENSORS)
        check_launches("train_moe_amp", counts, per_step, MOE_STEPS)
        losses = [float(o[0].reshape(-1)[0]) for o in out]
        aux = [[float(a.reshape(-1)[0]) for a in o[1:]] for o in out]
        if not all(math.isfinite(v) for v in losses + sum(aux, [])):
            raise AssertionError(f"train_moe_amp: non-finite losses "
                                 f"{losses} / aux {aux}")
        if len(kept) != MOE_LAYERS * MOE_STEPS:
            raise AssertionError(f"train_moe_amp: {len(kept)} routings")
        kept = torch.stack(kept).view(MOE_STEPS, MOE_LAYERS,
                                      MOE_EXPERTS).cpu().numpy()
        choices = MOE_BATCH * MOE_LEN * 2
        cap = math.ceil(MOE_BATCH * MOE_LEN * 2 / MOE_EXPERTS * 1.25)
        if kept.max() > cap:
            raise AssertionError(f"train_moe_amp: an expert kept "
                                 f"{kept.max()} tokens, capacity {cap}")
        routing = [{"kept_by_expert": kept[s].sum(0).tolist(),
                    "dropped_share": 1.0 - kept[s].sum() / (MOE_LAYERS
                                                            * choices),
                    "layer_dropped_share_max": float(
                        (1.0 - kept[s].sum(1) / choices).max()),
                    "aux_mean": float(np.mean(aux[s]))}
                   for s in range(MOE_STEPS)]
        steady = device_ms[1:]
        step_ms = sum(steady) / len(steady)
        host_steady = sum(host_ms[1:]) / len(host_ms[1:])
        tokens = MOE_BATCH * MOE_LEN
        stats = {"steady_step_ms": step_ms, "host_steady_step_ms": host_steady,
                 "tokens_per_s": tokens * 1e3 / step_ms,
                 "host_tokens_per_s": tokens * 1e3 / host_steady,
                 "max_memory_allocated": peak,
                 "op_dispatches_per_step": op_dispatches(exe, main, cost,
                                                         *auxes)}
        emit("train_moe_amp", model="moe_transformer_base",
             batch=MOE_BATCH, seq_len=MOE_LEN, steps=MOE_STEPS,
             experts=MOE_EXPERTS, top_k=2, capacity=cap,
             amp={"dtype": "bfloat16", "keep_activations": True},
             losses=losses, loss_fell=losses[-1] < losses[0],
             routing=routing, launches=counts,
             ops_per_step=len(main.global_block().ops),
             host_step_ms=host_ms, device_step_ms=device_ms, **stats)
        if profile_run:
            emit("train_moe_amp_profile", **op_device_share(
                lambda: exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope),
                ("moe_ffn", "moe_ffn_grad"), "moe_layer"))
    return counts, stats


def moe_op_inputs(gen, device):
    """One full-width moe_ffn op's inputs, drawn on the card from ``gen``
    (the Xavier scales ``layers.moe_ffn`` gives its experts)."""
    import torch

    n, d, h, e = MOE_OP_TOKENS, MOE_OP_D, MOE_OP_H, MOE_EXPERTS

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    return {"X": randn(n, d), "GateW": randn(d, e, scale=d ** -0.5),
            "W1": randn(e, d, h, scale=(2.0 / (d + h)) ** 0.5),
            "B1": randn(e, h, scale=0.02),
            "W2": randn(e, h, d, scale=(2.0 / (d + h)) ** 0.5),
            "B2": randn(e, d, scale=0.02)}


def moe_op_run(inputs, d_out, d_aux):
    """The moe_ffn op's impl and its generic grad on ``inputs``' device, as
    the Executor runs them: Out, AuxLoss and the grad of every input."""
    from paddle_tpu_torch.ops import registry

    attrs = {"top_k": 2, "capacity_factor": 1.25, "activation": "relu"}
    device = inputs["X"].device
    slots = {k: [v] for k, v in inputs.items()}
    outs = registry.REGISTRY["moe_ffn"].fn(registry.ExecContext(
        "moe_ffn", slots, {"Out": ["o"], "AuxLoss": ["a"]}, attrs, device))
    grads = registry.run_grad_generic(
        registry.REGISTRY["moe_ffn"], registry.ExecContext(
            "moe_ffn_grad", dict(slots, Out=[outs["Out"]],
                                 AuxLoss=[outs["AuxLoss"]],
                                 **{"Out@GRAD": [d_out],
                                    "AuxLoss@GRAD": [d_aux]}),
            {k + "@GRAD": [k + "@GRAD"] for k in inputs}, attrs, device))
    return [outs["Out"], outs["AuxLoss"]] + [grads[k + "@GRAD"][0]
                                             for k in inputs]


def phase_moe_parity():
    """Card against CPU: ``moe_config()`` (tiny, 4 experts, flash, dropout
    0) at batch 4 x 8 from one initial state over 5 steps, losses within
    rtol 1e-5 at step 0 and 1e-4 after; then one full-width moe_ffn op
    (``MOE_OP_TOKENS`` x 512, 8 experts, hidden 2048, top 2, capacity
    factor 1.25) and its generic grad on inputs drawn on the card: the CPU
    takes each token's experts from the card's own fp32 gate
    probabilities (``moe.top_k`` on them, on the CPU, gives the card's
    choices: a near-tie decided by a rounding is not the comparison's
    subject), so the routing (choices, slots, kept counts) must come out
    equal; Out, AuxLoss and the grad of every input within
    ``SEQ_PARITY_TOL``, the parameters' grads (sums over the tokens) with
    its atol of each tensor's largest magnitude."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel import moe

    progs = build_training(8, dropout=0.0, flash=True,
                           config=transformer.moe_config)
    rng = np.random.RandomState(2)
    feed = {"src_word": rng.randint(1, 1000, size=(4, 8)),
            "tgt_word": rng.randint(1, 1000, size=(4, 8)),
            "lbl_word": rng.randint(1, 1000, size=(4, 8, 1))}
    feed["src_word"][0, -2:] = 0
    (cpu, card), counts, _ = parity_runs(
        progs, feed, 5, (fluid.CPUPlace(), fluid.CUDAPlace(0)))
    tol = np.array([1e-5] + [1e-4] * 4)
    rel = check_parity("moe_parity", cpu, card, tol)
    if counts["flash_fwd"] != 5 * 2 * 6 or counts["adam"] != 5:
        raise AssertionError(f"moe_parity: the card's run launched {counts}")

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(12)
    inputs = moe_op_inputs(gen, device)
    d_out = torch.randn(MOE_OP_TOKENS, MOE_OP_D, generator=gen,
                        device=device)
    d_aux = torch.tensor(0.5, device=device)
    with routed() as card_kept:
        r_card = moe.route(inputs["X"], inputs["GateW"], 2, 1.25)
        t0 = time.perf_counter()
        card_out = moe_op_run(inputs, d_out, d_aux)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}
    # the card's choices from its probabilities, chosen again on the CPU
    cpu_choice = moe.top_k(r_card.probs.cpu(), 2)[1]
    if not torch.equal(cpu_choice, r_card.gate_idx.cpu()):
        raise AssertionError("moe_parity: top_k of the card's probabilities "
                             "on the CPU chose other experts")
    top_k = moe.top_k

    def card_choices(probs, k):
        return probs.gather(-1, cpu_choice), cpu_choice

    moe.top_k = card_choices
    try:
        r_cpu = moe.route(cpu_inputs["X"], cpu_inputs["GateW"], 2, 1.25)
        with routed() as cpu_kept:
            t0 = time.perf_counter()
            cpu_out = moe_op_run(cpu_inputs, d_out.cpu(), d_aux.cpu())
            cpu_s = time.perf_counter() - t0
    finally:
        moe.top_k = top_k
    for what, a, b in (("slots", r_cpu.slot, r_card.slot),
                       ("kept", r_cpu.kept, r_card.kept),
                       ("op kept", cpu_kept[0], card_kept[-1])):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"moe_parity: the routing's {what} differ "
                                 f"between the card and the CPU")
    names = ["Out", "AuxLoss"] + [k + "@GRAD" for k in inputs]
    # the parameters' grads are sums over the tokens: atol of each one's
    # largest magnitude, as the tranche phases hold sums
    worst = {n: {"max_abs_err": compare_on_card(
        "moe_parity", [n], [c], [g], SEQ_PARITY_TOL,
        n not in ("Out", "AuxLoss", "X@GRAD")),
        "largest": float(c.abs().max()),
        "norm_rel_err": norm_rel_err(g.cpu().numpy(), c.numpy())}
        for n, c, g in zip(names, cpu_out, card_out)}
    kept = r_card.kept.cpu().tolist()
    emit("moe_parity", config="moe_tiny", batch=4, seq_len=8, steps=5,
         cpu_losses=cpu.tolist(), card_losses=card.tolist(), rel_err=rel,
         rtol=tol.tolist(), launches=counts,
         op={"tokens": MOE_OP_TOKENS, "d_model": MOE_OP_D,
             "hidden": MOE_OP_H, "experts": MOE_EXPERTS, "top_k": 2,
             "capacity": r_card.capacity, "kept_by_expert": kept,
             "dropped_share": 1.0 - sum(kept) / (2 * MOE_OP_TOKENS),
             "routing_equal": True, "errors": worst,
             "tol": list(SEQ_PARITY_TOL), "card_s": card_s, "cpu_s": cpu_s})


def phase_train_stacked_amp(beside, profile_run=False):
    """The stacked Transformer-base (``Config.stacked``: one encoder and
    one decoder stack op) at ``TRAIN_BATCH`` x ``TRAIN_LEN`` in bf16 with
    kept activations through the flash kernels, dropout
    ``STACK_DROPOUT``: ``STACK_STEPS`` steps, finite losses, exactly
    ``flash_amp_per_step``'s launches a step with one Adam launch for
    ``STACK_ADAM_TENSORS`` tensors; step ms (events, host) beside
    ``beside``'s (``train_flash_amp``), peak allocated.  Then from one
    state and generator (``clone_scope``) one step of the same program
    and one of its ``recompute=True`` twin: the loss, every grad and the
    stack ops' masks bitwise equal, both peaks printed; then two more
    steps each way: their device ms and the memory each stack grad op
    allocates above its start.  Returns the launch counts of the plain
    steps."""
    import math

    import torch

    from paddle_tpu_torch import fluid

    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        plain = build_training(TRAIN_LEN, dropout=STACK_DROPOUT, flash=True,
                               stacked=True)
        main, startup, cost = plain
        ops = main.global_block().ops
        stacks = [op for op in ops if op.type.startswith("transformer_")
                  and not op.type.endswith("_grad")]
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = train_feed(TRAIN_BATCH, TRAIN_LEN)
        torch.cuda.reset_peak_memory_stats()
        out, host_ms, device_ms, counts = timed_steps(
            exe, main, feed, [cost], scope, STACK_STEPS)
        peak = torch.cuda.max_memory_allocated()
        check_launches("train_stacked_amp", counts,
                       dict(flash_amp_per_step(),
                            adam_tensors=STACK_ADAM_TENSORS), STACK_STEPS)
        losses = [float(o[0].reshape(-1)[0]) for o in out]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train_stacked_amp: losses {losses}")
        # one more step each way from one state and generator
        grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
                 if p.trainable]
        masks = [op.output("RngKey")[0] for op in stacks]
        fetches = [cost] + grads + masks
        twin = clone_scope(scope)
        recompute = build_training(TRAIN_LEN, dropout=STACK_DROPOUT,
                                   flash=True, stacked=True, recompute=True)
        runs = {}
        for name, progs, sc in (("plain", plain, scope),
                                ("recompute", recompute, twin)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got, host, dev, launched = timed_steps(
                exe, progs[0], feed, [progs[2]] + fetches[1:], sc, 1)
            runs[name] = {"fetched": got[0], "host_ms": host[0],
                          "device_ms": dev[0], "launches": launched,
                          "peak": torch.cuda.max_memory_allocated()}
        differ = [n for n, a, b in zip(
            ["loss"] + fetches[1:], runs["plain"]["fetched"],
            runs["recompute"]["fetched"]) if not torch.equal(
                torch.as_tensor(a), torch.as_tensor(b))]
        if differ:
            raise AssertionError(f"train_stacked_amp: the recompute step "
                                 f"differs from the plain step in {differ}")
        # two more steps each way: device ms, and what the stack ops'
        # grads allocate above their start (their re-run's activations)
        for name, progs, sc in (("plain", plain, scope),
                                ("recompute", recompute, twin)):
            with op_peaks({"transformer_encoder_stack_grad",
                           "transformer_decoder_stack_grad"}) as peaks:
                _, _, dev, _ = timed_steps(exe, progs[0], feed, [progs[2]],
                                           sc, 2)
            runs[name].update(steady_device_ms=dev,
                              stack_grad_peaks=peaks)
        del twin
        steady = device_ms[1:]
        step_ms = sum(steady) / len(steady)
        stats = {"steady_step_ms": step_ms,
                 "host_steady_step_ms": sum(host_ms[1:]) / len(host_ms[1:]),
                 "target_tokens_per_s": TRAIN_BATCH * TRAIN_LEN * 1e3
                 / step_ms, "max_memory_allocated": peak}
        emit("train_stacked_amp", model="transformer_base_stacked",
             batch=TRAIN_BATCH, seq_len=TRAIN_LEN, steps=STACK_STEPS,
             dropout=STACK_DROPOUT,
             amp={"dtype": "bfloat16", "keep_activations": True},
             losses=losses, loss_fell=losses[-1] < losses[0],
             launches=counts, ops_per_step=len(ops),
             op_dispatches_per_step=op_dispatches(exe, main, cost),
             host_step_ms=host_ms, device_step_ms=device_ms, **stats,
             beside=beside,
             recompute={"bitwise": True, "fetches_compared": len(fetches),
                        **{f"{k}_{f}": v[f] for k, v in runs.items()
                           for f in ("host_ms", "device_ms", "launches",
                                     "peak", "steady_device_ms",
                                     "stack_grad_peaks")}})
        if profile_run:
            profile_step("train_stacked_amp", lambda: exe.run(
                main, feed=feed, fetch_list=[cost], scope=scope),
                {"gemm": GEMM_KEYS, "flash": ("flash_",)})
    return counts


def phase_stack_parity():
    """Card against CPU (the plain versions), fp32, from one initial state:
    the tiny stacked Transformer (flash, dropout 0, batch 4 x 8, padded
    keys) and the tiny stacked BERT (flash, batch 2 x 32, padded keys), 3
    steps each, losses within rtol 1e-5 at step 0 and 1e-4 after, every
    attention through the flash kernels on the card; then
    ``gpipe_mlp_stack`` (3 layers of width 256, relu / tanh / gelu) at 512
    rows: out and the grads of x and the stacked weights within
    ``SEQ_PARITY_TOL``, the weights' grads (sums over the rows) with its
    atol of each tensor's largest magnitude."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert, transformer

    places = (fluid.CPUPlace(), fluid.CUDAPlace(0))
    tol = np.array([1e-5, 1e-4, 1e-4])
    result = {}
    rng = np.random.RandomState(4)
    tm_feed = {"src_word": rng.randint(1, 1000, size=(4, 8)),
               "tgt_word": rng.randint(1, 1000, size=(4, 8)),
               "lbl_word": rng.randint(1, 1000, size=(4, 8, 1))}
    tm_feed["src_word"][0, -2:] = 0
    (cpu, card), counts, _ = parity_runs(
        build_training(8, dropout=0.0, flash=True, stacked=True,
                       config=transformer.tiny_config), tm_feed, 3, places)
    if counts["flash_fwd"] != 3 * 2 * 6 or counts["flash_dq"] != 3 * 6:
        raise AssertionError(f"stack_parity: the stacked Transformer's card "
                             f"run launched {counts}")
    result["transformer_tiny"] = {
        "cpu_losses": cpu.tolist(), "card_losses": card.tolist(),
        "rel_err": check_parity("stack_parity", cpu, card, tol)}
    cfg = bert.tiny_config()
    cfg.stacked = True
    bert_feed = bert.synthetic_batch(cfg, 2, 32, 4, np.random.RandomState(3))
    bert_feed["src_ids"][1, -5:] = 0
    (cpu, card), counts, _ = parity_runs(build_bert(cfg, 32, 4, 1e-3),
                                         bert_feed, 3, places)
    if counts["flash_fwd"] != 3 * 2 * cfg.n_layer:
        raise AssertionError(f"stack_parity: the stacked BERT's card run "
                             f"launched {counts}")
    result["bert_tiny"] = {
        "cpu_losses": cpu.tolist(), "card_losses": card.tolist(),
        "rel_err": check_parity("stack_parity", cpu, card, tol)}
    x = np.random.RandomState(5).standard_normal((512, 256)).astype(
        np.float32)
    for act in ("relu", "tanh", "gelu"):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 6
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            xv = fluid.layers.data("x", shape=[256], dtype="float32",
                                   stop_gradient=False)
            out = fluid.layers.gpipe_mlp_stack(xv, n_layers=3, act=act)
            loss = fluid.layers.reduce_sum(fluid.layers.square(out))
            params = fluid.backward.append_backward(loss)
        fetches = [out.name, "x@GRAD"] + [g.name for _, g in params]
        (cpu, card), _, _ = place_steps((main, startup), {"x": x}, fetches,
                                        1, places)
        # the stacked weights' grads are sums over the rows: atol of each
        # one's largest magnitude, as the tranche phases hold sums
        result[f"gpipe_{act}"] = {
            name: compare_on_card(
                "stack_parity", [name], [torch.from_numpy(c)],
                [torch.from_numpy(g)], SEQ_PARITY_TOL, k >= 2)
            for k, (name, c, g) in enumerate(zip(fetches, cpu[0], card[0]))}
    emit("stack_parity", tol_losses=tol.tolist(),
         tol_ops=list(SEQ_PARITY_TOL), **result)


# -- data parallelism (phases 76-77) -----------------------------------------

PE_BATCH, PE_STEPS, PE_WINDOW = 64, 3, 4
DP2_RANKS, DP2_BATCH, DP2_STEPS = 2, 64, 3
DP2_WORKER_TIMEOUT_S = 420
DP2_GLOO_TIMEOUT_S = 300
# the velocities' norm ratio |v_ranks| / |v_one| and the parameters' update
# against the one-process step's (relative L2), held beside the velocities'
# cosine, which ignores scale: a grad sum counted twice doubles the update.
# Between the sound runs' largest readings and those of a tree whose grads
# are summed twice (PERF.md section 2)
DP2_VELOCITY_NORM_TOL = 0.01
DP2_UPDATE_RTOL = 0.1
BUCKET_TIMING_REPS = 5


def collective_counts():
    from paddle_tpu_torch.ops import collectives as coll

    return {k: getattr(coll, k) for k in (
        "all_reduce_launches", "reduce_scatter_launches",
        "all_gather_launches", "broadcast_launches")}


def count_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def grad_bucket_numel(main):
    """The elements of the flat grad bucket a step all-reduces: the
    parameters' (every one trainable in these programs)."""
    import numpy as np

    return int(sum(np.prod(p.shape)
                   for p in main.global_block().all_parameters()
                   if p.trainable))


def bucket_all_reduce_ms(group, numel, device):
    """The grad bucket's all-reduce alone, ``BUCKET_TIMING_REPS`` calls
    after one warm-up: host-clocked ms (to the call's end on the card) and
    CUDA-event ms, the mean of each."""
    import torch

    flat = torch.ones(numel, dtype=torch.float32, device=device)
    group.all_reduce_(flat)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    host, dev = [], []
    for _ in range(BUCKET_TIMING_REPS):
        t0 = time.perf_counter()
        start.record()
        group.all_reduce_(flat)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return {"host_ms": sum(host) / len(host),
            "cuda_event_ms": sum(dev) / len(dev), "numel": numel}


def fetch_free_syncs(run):
    """Sync-debug warnings in one call of ``run`` (a fetch-free step fed
    from the card), after one unwatched call: their count and where the
    first three came from."""
    import warnings

    import torch

    run()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # (the mode's one notice a process, "a prototype feature", is none)
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype feature" not in str(w.message)]
    return len(syncs), [f"{w.filename}:{w.lineno}: {str(w.message)[:160]}"
                        for w in syncs[:3]]


def timed_pe_steps(run, steps):
    """``steps`` calls of ``run``: (results, host-clocked ms a step)."""
    import torch

    out, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        out.append(run())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def phase_pe_world1(smi):
    """Phase 76: ``ParallelExecutor`` in a world-1 NCCL group, bitwise the
    single-device paths.  Returns the kernels' launches of its
    ParallelExecutor steps."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import core
    from paddle_tpu_torch.ops.collectives import DPGroup

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DP2_GLOO_TIMEOUT_S))
    total, out = {}, {}
    # cuDNN's deterministic algorithms: both paths then run the same ones
    # (its default may pick an atomics-based one per call)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with fluid.amp.amp_guard("bfloat16", keep_activations=True):
            main, startup, loss, _ = build_resnet()
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            pe_scope = clone_scope(scope)
            feed = resnet_feed(PE_BATCH, 224, 1000)
            exe_out, exe_ms = timed_pe_steps(lambda: exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope), PE_STEPS)
            pe = fluid.ParallelExecutor(loss_name=loss.name,
                                        main_program=main, scope=pe_scope)
            reset_launch_counts()
            c0 = collective_counts()
            pe_out, pe_ms = timed_pe_steps(
                lambda: pe.run([loss], feed=feed), PE_STEPS)
            counts, coll = launch_counts(), count_delta(
                c0, collective_counts())
            add_counts(total, counts)
            diff = state_diff(pe_scope, scope)
            same = all(np.array_equal(a[0], b[0])
                       for a, b in zip(pe_out, exe_out))
            if not (same and diff["bitwise"]):
                raise AssertionError(f"pe_world1: ParallelExecutor.run is not "
                                     f"bitwise Executor.run: losses "
                                     f"{pe_out} / {exe_out}, state {diff}")
            want = {"momentum": PE_STEPS, "momentum_tensors":
                    MOMENTUM_TENSORS_PER_STEP * PE_STEPS}
            if {k: counts[k] for k in want} != want or \
                    coll["all_reduce_launches"] != PE_STEPS:
                raise AssertionError(f"pe_world1: {PE_STEPS} ResNet steps "
                                     f"launched {counts}, collectives {coll}")
            # a captured window against the same steps one by one
            win_scope, step_scope = clone_scope(pe_scope), \
                clone_scope(pe_scope)
            pe_win = fluid.ParallelExecutor(loss_name=loss.name,
                                            main_program=main,
                                            scope=win_scope)
            pe_step = fluid.ParallelExecutor(loss_name=loss.name,
                                             main_program=main,
                                             scope=step_scope)
            steps = [pe_step.run([loss], feed=feed)
                     for _ in range(PE_WINDOW)]
            reset_launch_counts()
            c0 = collective_counts()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            win = pe_win.run_steps([loss], feed=feed, n_steps=PE_WINDOW)
            end.record()
            torch.cuda.synchronize()
            first_ms = start.elapsed_time(end) / PE_WINDOW
            w_counts, w_coll = launch_counts(), count_delta(
                c0, collective_counts())
            add_counts(total, w_counts)
            graph = next(w.graph for w in pe_win._exe._windows.values())
            w_diff = state_diff(win_scope, step_scope)
            if not (w_diff["bitwise"]
                    and np.array_equal(win[0], steps[-1][0])):
                raise AssertionError(f"pe_world1: the window is not bitwise "
                                     f"its steps: {win} / {steps[-1]}, "
                                     f"state {w_diff}")
            if (graph.eager_steps, graph.replays) != (1, PE_WINDOW - 1) or \
                    w_counts["momentum"] != PE_WINDOW or \
                    w_coll["all_reduce_launches"] != PE_WINDOW:
                raise AssertionError(
                    f"pe_world1: window of {PE_WINDOW}: {graph.eager_steps} "
                    f"eager, {graph.replays} replays, {w_counts}, {w_coll}")
            # a second window: replays alone
            start.record()
            pe_win.run_steps([loss], feed=feed, n_steps=PE_WINDOW)
            end.record()
            torch.cuda.synchronize()
            replay_ms = start.elapsed_time(end) / PE_WINDOW
            dev_feed = {k: torch.from_numpy(v).cuda()
                        for k, v in feed.items()}
            resnet_syncs, resnet_where = fetch_free_syncs(
                lambda: pe.run([], feed=dev_feed))
            group = DPGroup()
            bucket = bucket_all_reduce_ms(
                group, grad_bucket_numel(main),
                core.torch_device(fluid.CUDAPlace(0)))
            out["resnet"] = {
                "losses": [float(v[0].reshape(-1)[0]) for v in pe_out],
                "state": diff, "launches": counts, "collectives": coll,
                "pe_step_ms": pe_ms, "executor_step_ms": exe_ms,
                "window": {"steps": PE_WINDOW, "state": w_diff,
                           "first_window_step_ms": first_ms,
                           "graph_step_ms": replay_ms,
                           "collectives": w_coll,
                           "capture_s": graph.capture_s},
                "sync_debug_warnings_per_step": resnet_syncs,
                "grad_bucket_all_reduce": bucket}
            for e in (exe, pe, pe_win, pe_step):
                e.close()
            del scope, pe_scope, win_scope, step_scope
        torch.cuda.empty_cache()
        with fluid.amp.amp_guard("bfloat16", keep_activations=True):
            main, startup, cost = build_training(TRAIN_LEN, flash=True)
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            pe_scope = clone_scope(scope)
            feed = train_feed(TRAIN_BATCH, TRAIN_LEN)
            exe_out, exe_ms = timed_pe_steps(lambda: exe.run(
                main, feed=feed, fetch_list=[cost], scope=scope), PE_STEPS)
            bs = fluid.BuildStrategy()
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
            pe = fluid.ParallelExecutor(loss_name=cost.name,
                                        main_program=main, scope=pe_scope,
                                        build_strategy=bs)
            reset_launch_counts()
            c0 = collective_counts()
            pe_out, pe_ms = timed_pe_steps(
                lambda: pe.run([cost], feed=feed), PE_STEPS)
            counts, coll = launch_counts(), count_delta(
                c0, collective_counts())
            add_counts(total, counts)
            diff = state_diff(pe_scope, scope)
            same = all(np.array_equal(a[0], b[0])
                       for a, b in zip(pe_out, exe_out))
            if not (same and diff["bitwise"]):
                raise AssertionError(f"pe_world1: ZeRO-1 is not bitwise the "
                                     f"unsharded step: {pe_out} / {exe_out}, "
                                     f"state {diff}")
            if (counts["adam"], counts["adam_tensors"]) != (
                    PE_STEPS, ADAM_TENSORS_PER_STEP * PE_STEPS) or \
                    coll["reduce_scatter_launches"] != PE_STEPS or \
                    coll["all_gather_launches"] != PE_STEPS or \
                    coll["all_reduce_launches"] != 0:
                raise AssertionError(f"pe_world1: {PE_STEPS} ZeRO-1 steps "
                                     f"launched {counts}, collectives {coll}")
            dev_feed = {k: torch.from_numpy(v).cuda()
                        for k, v in feed.items()}
            zero1_syncs, zero1_where = fetch_free_syncs(
                lambda: pe.run([], feed=dev_feed))
            out["transformer_zero1"] = {
                "losses": [float(v[0].reshape(-1)[0]) for v in pe_out],
                "state": diff, "launches": counts, "collectives": coll,
                "pe_step_ms": pe_ms, "executor_step_ms": exe_ms,
                "sync_debug_warnings_per_step": zero1_syncs}
            exe.close()
            pe.close()
            del scope, pe_scope
        if resnet_syncs or zero1_syncs:
            raise AssertionError(f"pe_world1: host syncs in a fetch-free "
                                 f"step: ResNet {resnet_syncs} "
                                 f"{resnet_where}, ZeRO-1 {zero1_syncs} "
                                 f"{zero1_where}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("pe_world1", backend="nccl", world=1, nvidia_smi=smi,
         cudnn_deterministic=True,
         resnet_batch=PE_BATCH, transformer_batch=TRAIN_BATCH,
         transformer_len=TRAIN_LEN, steps=PE_STEPS, **out)
    return total


def dp2_state_path(dirname, step):
    return os.path.join(dirname, f"state_{step}.npz")


def dp2_worker(rank, dirname):
    """``chip_smoke.py --dp-worker RANK --dp-dir DIR``: one rank of phase
    77.  Joins the gloo group (a FileStore in DIR), builds ResNet-50 fp32
    and before each step loads the one-process run's state from DIR, runs
    one ParallelExecutor step on its half of the global batch, and
    records the loss, the running statistics, the velocities' cosine and
    norm ratio and the parameters' update against the one-process step's,
    a digest of the parameters, the step's ms and launches; then times
    the grad bucket's all-reduce.  Its record goes to DIR/rank<RANK>.json.
    Builds nothing."""
    import datetime
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import core
    from paddle_tpu_torch.models.params import load_reference_params
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.collectives import DPGroup

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(dirname, "store"),
                                     DP2_RANKS),
        rank=rank, world_size=DP2_RANKS,
        timeout=datetime.timedelta(seconds=DP2_GLOO_TIMEOUT_S))
    main, startup, loss, _ = build_resnet()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    stats = [n for n in names if ".w_mean" in n or ".w_variance" in n]
    vel = [n for n in names if "velocity" in n]
    params = sorted(p.name for p in main.global_block().all_parameters())
    full = resnet_feed(DP2_BATCH * DP2_RANKS, 224, 1000)
    feed = {k: v[rank * DP2_BATCH:(rank + 1) * DP2_BATCH]
            for k, v in full.items()}
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                scope=scope, place=fluid.CUDAPlace(0))
    rtol_s, _ = RESNET_PARITY_STATS_TOL
    reset_launch_counts()
    steps = []
    for step in range(DP2_STEPS):
        with np.load(dp2_state_path(dirname, step)) as z:
            load_reference_params(scope, {n: z[n] for n in z.files
                                          if n != "__loss__"},
                                  fluid.CUDAPlace(0))
            before = np.concatenate([z[n].ravel() for n in params])
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        lv = pe.run([loss], feed=feed)[0]
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        with np.load(dp2_state_path(dirname, step + 1)) as z:
            want = {n: z[n] for n in stats + vel + params}
            want_loss = float(z["__loss__"])
        got = {n: scope.get(n).detach().cpu().numpy()
               for n in stats + vel + params}
        a = np.concatenate([want[n].ravel() for n in vel])
        b = np.concatenate([got[n].ravel() for n in vel])
        # the step's update of the parameters, against one process's (in
        # float64: the update is ~1e-4 of a parameter)
        ref_upd = np.concatenate([want[n].ravel() for n in params]
                                 ).astype(np.float64) - before
        upd = np.concatenate([got[n].ravel() for n in params]
                             ).astype(np.float64) - before
        digest = hashlib.sha256()
        for n in params:
            digest.update(scope.get(n).detach().cpu().numpy().tobytes())
        steps.append({
            "loss": float(lv.reshape(-1)[0]), "one_process_loss": want_loss,
            "loss_rel_err": abs(float(lv.reshape(-1)[0]) - want_loss)
            / abs(want_loss),
            "stats_excess_over_rtol": max(float(
                (np.abs(got[n] - want[n]) - rtol_s * np.abs(want[n])).max())
                for n in stats),
            "velocity_cosine": float(a @ b / np.linalg.norm(a)
                                     / np.linalg.norm(b)),
            "velocity_norm_ratio": float(np.linalg.norm(b)
                                         / np.linalg.norm(a)),
            "update_rel_err": float(np.linalg.norm(upd - ref_upd)
                                    / np.linalg.norm(ref_upd)),
            "params_sha256": digest.hexdigest(), "host_ms": host_ms,
            "cuda_event_ms": start.elapsed_time(end)})
    counts = launch_counts()
    bucket = bucket_all_reduce_ms(DPGroup(), grad_bucket_numel(main),
                                  core.torch_device(fluid.CUDAPlace(0)))
    dist.destroy_process_group()
    with open(os.path.join(dirname, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": steps, "launches": counts,
                   "grad_bucket_all_reduce": bucket,
                   "nvcc_runs": sorted(_build.build_logs)}, f)


def phase_pe_dp2_resnet(tmp, smi):
    """Phase 77: two ranks on the one card over gloo against one process
    at the global batch, re-synced before each step.  Returns the ranks'
    launches."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid

    main, startup, loss, _ = build_resnet()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in startup.list_vars() if v.persistable)
    feed = resnet_feed(DP2_BATCH * DP2_RANKS, 224, 1000)
    dirname = os.path.join(tmp, "dp2")
    os.makedirs(dirname)
    one_ms = []
    for step in range(DP2_STEPS + 1):
        state = {n: scope.get(n).detach().cpu().numpy() for n in names}
        if step:
            state["__loss__"] = np.float32(lv.reshape(-1)[0])
        np.savez(dp2_state_path(dirname, step), **state)
        if step == DP2_STEPS:
            break
        t0 = time.perf_counter()
        lv = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    exe.close()
    del scope
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         "--dp-dir", dirname], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DP2_RANKS)]
    # a rank that fails ends the phase at once: the other would wait on
    # the group's timeout
    deadline = time.perf_counter() + DP2_WORKER_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    spawn_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"pe_dp2_resnet: rank {r} exited "
                                 f"{p.returncode}: {log[-3000:]}")
    ranks = []
    for r in range(DP2_RANKS):
        with open(os.path.join(dirname, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    _, atol_s = RESNET_PARITY_STATS_TOL
    for r, rec in enumerate(ranks):
        if rec["nvcc_runs"]:
            raise AssertionError(f"pe_dp2_resnet: rank {r} ran nvcc for "
                                 f"{rec['nvcc_runs']}")
        if (rec["launches"]["momentum"], rec["launches"]["momentum_tensors"]
                ) != (DP2_STEPS, DP2_STEPS * MOMENTUM_TENSORS_PER_STEP):
            raise AssertionError(f"pe_dp2_resnet: rank {r} launched "
                                 f"{rec['launches']}")
        for s, st in enumerate(rec["steps"]):
            if not (np.isfinite(st["loss"])
                    and st["loss_rel_err"] <= RESNET_PARITY_LOSS_RTOL
                    and st["stats_excess_over_rtol"] <= atol_s
                    and st["velocity_cosine"]
                    >= RESNET_PARITY_VELOCITY_COSINE
                    and abs(st["velocity_norm_ratio"] - 1.0)
                    <= DP2_VELOCITY_NORM_TOL
                    and st["update_rel_err"] <= DP2_UPDATE_RTOL):
                raise AssertionError(f"pe_dp2_resnet: rank {r} step {s} "
                                     f"against one process: {st}")
    digests = [[st["params_sha256"] for st in rec["steps"]] for rec in ranks]
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"pe_dp2_resnet: parameters differ across the "
                             f"ranks: {digests}")
    total = {}
    for rec in ranks:
        add_counts(total, rec["launches"])
    emit("pe_dp2_resnet", backend="gloo (CUDA tensors staged through the "
         "host: gloo's numbers, not NCCL's)", ranks=DP2_RANKS,
         nvidia_smi=smi, local_batch=DP2_BATCH,
         global_batch=DP2_BATCH * DP2_RANKS, steps=DP2_STEPS,
         loss_rtol=RESNET_PARITY_LOSS_RTOL,
         stats_tol=list(RESNET_PARITY_STATS_TOL),
         velocity_cosine_min=RESNET_PARITY_VELOCITY_COSINE,
         velocity_norm_ratio_tol=DP2_VELOCITY_NORM_TOL,
         update_rtol=DP2_UPDATE_RTOL,
         per_rank=[{"steps": rec["steps"], "launches": rec["launches"],
                    "grad_bucket_all_reduce": rec["grad_bucket_all_reduce"]}
                   for rec in ranks],
         one_process_step_ms=one_ms, params_bitwise_across_ranks=True,
         spawn_s=spawn_s)
    return total


# tensor and fsdp parallelism: two ranks share the one card over gloo
# (NCCL refuses two ranks on one GPU), Transformer-base at full width with
# flash at a batch of 16 x 256 (gloo stages every activation all-reduce
# through the host: the batch is cut, not the width)
TP2_RANKS, TP2_BATCH, TP2_LEN = 2, 16, 256
TP2_MODES = (("tp2_fp32", "tp2", False, 2), ("tp2_bf16", "tp2", True, 3),
             ("fsdp2_bf16", "fsdp2", True, 2))
TP2_WORKER_TIMEOUT_S = 400
TP2_GLOO_TIMEOUT_S = 300
TP2_LOSS_RTOL0, TP2_LOSS_RTOL = 1e-6, 1e-6
TP2_BF16_LOSS_RTOL = 2.0 ** -8
# the update since the start of the parameters (gathered from the tp
# ranks) against the one process's, relative L2: in fp32 of each
# parameter, under bf16 of all together (bf16 rounding alone moves the
# last decoder layers' q / k updates by ~0.9: the one process's bf16
# against its fp32).  An update zeroed or doubled reads 1.0 on its
# parameter; out_proj_w's alone reads ~0.55 together under bf16.
TP2_UPDATE_RTOL, TP2_BF16_UPDATE_RTOL = 0.2, 0.35
# the parameter the sharded xent's backward feeds directly
TP2_LOGITS_W = "out_proj_w"
# launches a rank a step: 18 attentions on H / 2 = 4 heads (forward twice),
# the xent partials twice and its backward once on the rank's [4096,
# 15000] vocabulary slice, one Adam launch over the rank's shards; fsdp
# runs the whole heads and the whole vocabulary
TP2_PER_STEP = {"flash_fwd": 2 * FLASH_OPS, "flash_dq": FLASH_OPS,
                "flash_dkv": FLASH_OPS, "softmax_xent_partial": 2,
                "softmax_xent_fwd": 0, "softmax_xent_bwd": 1, "adam": 1}
FSDP2_PER_STEP = dict(TP2_PER_STEP, softmax_xent_partial=0,
                      softmax_xent_fwd=2)


def tp2_feeds():
    return [train_feed(TP2_BATCH, TP2_LEN, seed=s)
            for s in range(max(m[3] for m in TP2_MODES))]


def param_digests(scope, names, halves=False):
    """sha256 of each parameter's bytes as the scope holds it; with
    ``halves``, also of each half along each dim it splits evenly (the
    slices two fsdp ranks hold)."""
    import hashlib

    out = {}
    for n in names:
        a = scope.get(n).detach().cpu().numpy()
        d = {"full": hashlib.sha256(a.tobytes()).hexdigest()}
        if halves:
            for dim, size in enumerate(a.shape):
                if size % 2 == 0:
                    d[str(dim)] = [hashlib.sha256(
                        np_half(a, dim, r).tobytes()).hexdigest()
                        for r in range(2)]
        out[n] = d
    return out


def update_rel_l2(step, scope, names, initial, path):
    """``{name: [||u - u_one||, ||u_one||]}``: ``u`` the update since the
    start of each parameter as the ranks hold it (gathered; ``initial``
    the host copy of the values before the first step), ``u_one`` the one
    process's, saved at ``path``.  Every rank calls it (the gathers are
    collective); a rank with no ``initial`` gathers only and returns
    None."""
    import torch

    one = torch.load(path) if initial is not None else None
    out = {}
    for n in names:
        full = step.fetch(n, scope.get(n))
        if initial is None:
            continue
        want = one[n]
        diff = (full.detach().float().cpu() - initial[n] - want).norm()
        out[n] = [float(diff), float(want.norm())]
    return out if initial is not None else None


def update_summary(mode, step, norms, amp):
    """Check and summarize ``update_rel_l2``'s ``norms`` of one tp2 step:
    each parameter's relative L2 within ``TP2_UPDATE_RTOL`` in fp32, all
    parameters' together within ``TP2_BF16_UPDATE_RTOL`` under bf16; with
    what the together reading would be were ``TP2_LOGITS_W``'s update
    zero (the gap to a fault)."""
    import math

    rel = {n: d / r if r > 0 else d for n, (d, r) in norms.items()}
    worst = max(rel, key=rel.get)
    diff2 = sum(d * d for d, _ in norms.values())
    ref2 = sum(r * r for _, r in norms.values())
    together = math.sqrt(diff2 / ref2)
    d_w, r_w = norms[TP2_LOGITS_W]
    out = {"max": rel[worst], "max_param": worst,
           "median": sorted(rel.values())[len(rel) // 2],
           "together": together, TP2_LOGITS_W: rel[TP2_LOGITS_W],
           "together_were_" + TP2_LOGITS_W + "_zeroed": math.sqrt(
               (diff2 - d_w * d_w + r_w * r_w) / ref2),
           "params": len(rel)}
    got, tol, what = (together, TP2_BF16_UPDATE_RTOL, "all parameters'") \
        if amp else (rel[worst], TP2_UPDATE_RTOL, f"{worst}'s")
    if not got <= tol:
        raise AssertionError(
            f"pe_tp2_transformer {mode}: step {step}: {what} update is "
            f"{got} (relative L2) off one process's (tol {tol})")
    return out


def np_half(a, dim, r):
    import numpy as np

    return np.ascontiguousarray(np.split(a, 2, axis=dim)[r])


def tp2_worker(rank, dirname):
    """``chip_smoke.py --tp-worker RANK --tp-dir DIR``: one rank of the
    pe_tp2_transformer phase.  Joins the gloo group (a FileStore in DIR)
    and runs each of ``TP2_MODES``: Transformer-base with flash through
    ``ParallelExecutor`` on its mesh, from the seeded startup (rank 0's
    state, broadcast), recording per step the loss, host and CUDA-event
    ms, the tp all-reduces and fsdp all-gathers, and digests of the
    parameters it holds (its shards); per mode its launches, the head
    counts the flash forward saw and the logits shapes the xent partials
    saw, and its peak allocated bytes.  Its record goes to
    DIR/rank<RANK>.json.  Builds nothing."""
    import datetime

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import _build, collectives
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(dirname, "store"),
                                     TP2_RANKS),
        rank=rank, world_size=TP2_RANKS,
        timeout=datetime.timedelta(seconds=TP2_GLOO_TIMEOUT_S))
    feeds = tp2_feeds()
    # what the kernels were handed (the wrappers' callers look them up
    # here at every call)
    seen = {"heads": set(), "xent": set()}
    flash_forward, partial = fa.flash_forward, fused.softmax_xent_partial

    def watch_flash(q, *a, **kw):
        seen["heads"].add(int(q.shape[1]))
        return flash_forward(q, *a, **kw)

    def watch_partial(x, *a, **kw):
        seen["xent"].add(tuple(x.shape))
        return partial(x, *a, **kw)

    fa.flash_forward, fused.softmax_xent_partial = watch_flash, watch_partial
    records = {}
    for mode, spec, amp, steps in TP2_MODES:
        main, startup, loss = build_training(TP2_LEN, dropout=0.0,
                                             flash=True)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        params = sorted(p.name for p in main.global_block().all_parameters())
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                    scope=scope, place=fluid.CUDAPlace(0),
                                    mesh=spec)
        for v in seen.values():
            v.clear()
        initial = {n: scope.get(n).detach().to("cpu", torch.float32,
                                                copy=True)
                   for n in params} if spec == "tp2" and rank == 0 else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out = []
        guard = fluid.amp.amp_guard("bfloat16", keep_activations=True) \
            if amp else contextlib.nullcontext()
        with guard:
            for s in range(steps):
                ar = dict(collectives.all_reduce_launches_by_axis)
                ag = dict(collectives.all_gather_launches_by_axis)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                lv = pe.run([loss], feed=feeds[s])[0]
                end.record()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
                out.append({
                    "loss": float(lv.reshape(-1)[0]), "host_ms": host_ms,
                    "cuda_event_ms": start.elapsed_time(end),
                    "all_reduces": {a: c - ar.get(a, 0) for a, c in
                                    collectives.all_reduce_launches_by_axis
                                    .items()},
                    "all_gathers": {a: c - ag.get(a, 0) for a, c in
                                    collectives.all_gather_launches_by_axis
                                    .items()},
                    "digests": {n: d["full"] for n, d in param_digests(
                        scope, params).items()}})
                if spec == "tp2":
                    out[-1]["update_rel_l2"] = update_rel_l2(
                        next(iter(pe._steps.values())), scope, params,
                        initial, os.path.join(dirname, "one_{}_{}.pt".format(
                            "bf16" if amp else "fp32", s)))
        step = next(iter(pe._steps.values()))
        records[mode] = {
            "steps": out, "launches": {**launch_counts(),
                                       **xent_layout_counts()},
            "flash_heads": sorted(seen["heads"]),
            "xent_partial_shapes": sorted(seen["xent"]),
            "tp_sharded": sorted(step.placement.storage)
            if step.placement is not None else [],
            "fsdp": step.fsdp,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        pe.close()
        del scope, pe, step
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(os.path.join(dirname, f"rank{rank}.json"), "w") as f:
        json.dump({"records": records,
                   "nvcc_runs": sorted(_build.build_logs)}, f)


def phase_pe_tp2_transformer(tmp, smi):
    """Two ranks on the one card over gloo through ``ParallelExecutor``:
    Transformer-base tp2 fp32 and bf16 AMP and fsdp2 bf16 AMP (flash),
    against one process's trajectory from the same seeded start at the
    same batch: tp2 fp32 losses within ``TP2_LOSS_RTOL0`` at step 0 and
    ``TP2_LOSS_RTOL`` after, tp2 bf16 within ``TP2_BF16_LOSS_RTOL`` and
    its replicated parameters bitwise across the ranks after each step,
    the update since the start (gathered) against the one process's after
    each tp2 step (``update_summary``), fsdp2 bf16 losses and parameter shards bitwise the one process's; the
    launches a rank a step (``TP2_PER_STEP``, ``FSDP2_PER_STEP``), flash
    on 4 heads and the xent partials on [4096, 15000] under tp.  Returns
    the ranks' launches."""
    import torch

    from paddle_tpu_torch import fluid

    feeds = tp2_feeds()
    dirname = os.path.join(tmp, "tp2")
    os.makedirs(dirname)
    ref = {}
    for prec, amp, steps in (("fp32", False, 2), ("bf16", True, 3)):
        main, startup, loss = build_training(TP2_LEN, dropout=0.0,
                                             flash=True)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        params = sorted(p.name for p in main.global_block().all_parameters())
        initial = {n: scope.get(n).detach().to("cpu", torch.float32,
                                                copy=True) for n in params}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        guard = fluid.amp.amp_guard("bfloat16", keep_activations=True) \
            if amp else contextlib.nullcontext()
        losses, ms, digests = [], [], []
        with guard:
            for s in range(steps):
                t0 = time.perf_counter()
                lv = exe.run(main, feed=feeds[s], fetch_list=[loss],
                             scope=scope)[0]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(lv.reshape(-1)[0]))
                digests.append(param_digests(scope, params, halves=amp))
                # the update since the start, for the tp ranks' check
                torch.save({n: scope.get(n).detach().float().cpu()
                            - initial[n] for n in params},
                           os.path.join(dirname, f"one_{prec}_{s}.pt"))
        ref[prec] = {"losses": losses, "host_ms": ms, "digests": digests,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        exe.close()
        del scope
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         "--tp-dir", dirname], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(TP2_RANKS)]
    deadline = time.perf_counter() + TP2_WORKER_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    spawn_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"pe_tp2_transformer: rank {r} exited "
                                 f"{p.returncode}: {log[-3000:]}")
    ranks = []
    for r in range(TP2_RANKS):
        with open(os.path.join(dirname, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    total, per_mode = {}, {}
    for r, rec in enumerate(ranks):
        if rec["nvcc_runs"]:
            raise AssertionError(f"pe_tp2_transformer: rank {r} ran nvcc "
                                 f"for {rec['nvcc_runs']}")
        # rows of 15,000 and 30,000 logits: every xent launch is wide
        narrow = {m: {k: v for k, v in r_["launches"].items()
                      if k.endswith("_narrow") and v}
                  for m, r_ in rec["records"].items()}
        if any(narrow.values()):
            raise AssertionError(f"pe_tp2_transformer: rank {r} launched "
                                 f"the narrow xent layout: {narrow}")
    for mode, spec, amp, steps in TP2_MODES:
        one = ref["bf16" if amp else "fp32"]
        recs = [rec["records"][mode] for rec in ranks]
        per_step = TP2_PER_STEP if spec == "tp2" else FSDP2_PER_STEP
        for r, rec in enumerate(recs):
            got = {k: rec["launches"][k + ("_bf16" if amp and k != "adam"
                                           else "")]
                   for k in per_step}
            want = {k: n * steps for k, n in per_step.items()}
            if got != want:
                raise AssertionError(f"pe_tp2_transformer {mode}: rank {r} "
                                     f"launched {got}, want {want}")
            heads = [FLASH_HEADS // TP2_RANKS if spec == "tp2"
                     else FLASH_HEADS]
            shapes = [[TP2_BATCH * TP2_LEN, VOCAB // TP2_RANKS]] \
                if spec == "tp2" else []
            if rec["flash_heads"] != heads or \
                    rec["xent_partial_shapes"] != shapes:
                raise AssertionError(
                    f"pe_tp2_transformer {mode}: rank {r} ran flash on "
                    f"{rec['flash_heads']} heads and the xent partials on "
                    f"{rec['xent_partial_shapes']}")
            for s, st in enumerate(rec["steps"]):
                err = abs(st["loss"] - one["losses"][s]) / abs(
                    one["losses"][s])
                st["loss_rel_err"] = err
                tol = (TP2_BF16_LOSS_RTOL if amp else
                       TP2_LOSS_RTOL0 if s == 0 else TP2_LOSS_RTOL)
                if spec == "fsdp2":
                    tol = 0.0
                if not err <= tol:
                    raise AssertionError(
                        f"pe_tp2_transformer {mode}: rank {r} step {s} loss "
                        f"{st['loss']} against one process's "
                        f"{one['losses'][s]} (rel err {err}, tol {tol})")
                if spec == "tp2" and r == 0:
                    st["update_rel_l2"] = update_summary(
                        mode, s, st.pop("update_rel_l2"), amp)
                if spec == "fsdp2":
                    for n, dg in st["digests"].items():
                        d = rec["fsdp"].get(n)
                        want_dg = one["digests"][s][n]["full"] if d is None \
                            else one["digests"][s][n][str(d)][r]
                        if dg != want_dg:
                            raise AssertionError(
                                f"pe_tp2_transformer {mode}: rank {r} step "
                                f"{s}: {n} is not bitwise one process's")
        # the replicated parameters each rank updated itself: bitwise the
        # same on both ranks
        sharded = set(recs[0]["tp_sharded"]) | set(recs[0]["fsdp"])
        for s in range(steps):
            a, b = (rec["steps"][s]["digests"] for rec in recs)
            diff = [n for n in a if n not in sharded and a[n] != b[n]]
            if diff:
                raise AssertionError(f"pe_tp2_transformer {mode}: step {s}: "
                                     f"replicated {diff[:3]} differ across "
                                     f"the ranks")
            if recs[0]["steps"][s]["loss"] != recs[1]["steps"][s]["loss"]:
                raise AssertionError(f"pe_tp2_transformer {mode}: step {s}: "
                                     f"the ranks' losses differ")
        replicated = len([n for n in recs[0]["steps"][0]["digests"]
                          if n not in sharded])
        for rec in recs:
            add_counts(total, rec["launches"])
            for st in rec["steps"]:
                del st["digests"]
        per_mode[mode] = {
            "mesh": spec, "amp": "bf16" if amp else None, "steps": steps,
            "one_process_losses": one["losses"],
            "one_process_host_ms": one["host_ms"],
            "one_process_peak_allocated_bytes": one["peak_allocated_bytes"],
            "replicated_params_bitwise_across_ranks": replicated,
            "per_rank": [{k: rec[k] for k in (
                "steps", "launches", "flash_heads", "xent_partial_shapes",
                "peak_allocated_bytes")} for rec in recs],
            "tp_sharded_state": len(recs[0]["tp_sharded"]),
            "fsdp_sharded_state": len(recs[0]["fsdp"])}
    emit("pe_tp2_transformer", backend="gloo (CUDA tensors staged through "
         "the host: gloo's numbers, not NCCL's)", ranks=TP2_RANKS,
         nvidia_smi=smi, batch=TP2_BATCH, seq_len=TP2_LEN,
         loss_rtol=[TP2_LOSS_RTOL0, TP2_LOSS_RTOL],
         bf16_loss_rtol=TP2_BF16_LOSS_RTOL,
         update_rtol=[TP2_UPDATE_RTOL, TP2_BF16_UPDATE_RTOL],
         fsdp_bitwise=True,
         tp2_per_step=TP2_PER_STEP, fsdp2_per_step=FSDP2_PER_STEP,
         modes=per_mode, spawn_s=spawn_s)
    return total


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the serving and training checks, profile a "
                         "full-slot decode run and a training step and "
                         "print where their time goes")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the decoder's training data (phase 41)")
    ap.add_argument("--trainer-worker", metavar="DIR",
                    help="run phase 66's Trainer worker over the checkpoint "
                         "directory DIR (used by the script itself)")
    ap.add_argument("--worker-out", metavar="FILE",
                    help="where the Trainer worker writes its record")
    ap.add_argument("--dp-worker", metavar="RANK", type=int,
                    help="run rank RANK of phase 77 (used by the script "
                         "itself)")
    ap.add_argument("--dp-dir", metavar="DIR",
                    help="phase 77's directory: the group's store, the "
                         "states, the ranks' records")
    ap.add_argument("--tp-worker", metavar="RANK", type=int,
                    help="run rank RANK of the pe_tp2_transformer phase "
                         "(used by the script itself)")
    ap.add_argument("--tp-dir", metavar="DIR",
                    help="pe_tp2_transformer's directory: the group's "
                         "store, the ranks' records")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repo "
                         "(paddle_tpu_torch/ not found beside this script)")
    sys.path.insert(0, here)
    if args.trainer_worker:
        trainer_worker(args.trainer_worker, args.worker_out)
        return
    if args.dp_worker is not None:
        dp2_worker(args.dp_worker, args.dp_dir)
        return
    if args.tp_worker is not None:
        tp2_worker(args.tp_worker, args.tp_dir)
        return
    started = time.perf_counter()
    smi = phase_device()
    phase_build()
    import torch

    paged = phase_kernel()
    xent_fwd, xent_bwd = phase_kernel_xent()
    # the detection paths' shapes (their launches join the kernels line)
    xent_fwd["by_model"], xent_bwd["by_model"] = phase_kernel_xent_by_model()
    torch.cuda.empty_cache()
    xent_amp = phase_kernel_xent_amp()
    torch.cuda.empty_cache()
    xent_partial = phase_kernel_xent_partial()
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
    for k in (xent_fwd, xent_bwd):
        k["launches_by_layout"] = {
            layout: counts[f"{k['name']}_{layout}"]
            for layout in ("narrow", "wide")}
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
        resnet_progs, args.profile)[0]["momentum"]
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
        _, resnet_amp = phase_train_resnet(build_resnet(), args.profile,
                                           amp=True)
    torch.cuda.empty_cache()
    counts = phase_train_amp_fp16_scaler()
    for k in xent_amp:
        if k["name"].endswith("_f16"):
            k["launches"] = counts[k["name"]]
    torch.cuda.empty_cache()
    flash_amp = phase_kernel_flash_amp()
    torch.cuda.empty_cache()
    with fluid.amp.amp_guard("bfloat16", keep_activations=True):
        counts, flash_amp_stats = phase_train(
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
        ("mnist_cnn", build_vision("mnist_cnn")[0], CNN_ADAM_TENSORS),
        ("stacked_lstm", build_stacked_lstm()[0], LSTM_ADAM_TENSORS),
        ("decoder", build_train_decoder()[0], DEC_ADAM_TENSORS),
        ("ctc", ctc_programs(fluid)["main"], CTC_ADAM_TENSORS)])
    momentum["by_model"] = optimizer_at_model_shapes(
        phase_kernel_momentum, "momentum",
        [("se_resnext50", build_vision("se_resnext50")[0],
          SE_MOMENTUM_TENSORS),
         ("rcnn_heads", rcnn_heads(fluid)["main"], RCNN_MOMENTUM_TENSORS)])
    counts, bert_stats = phase_train_bert_amp(args.profile)
    add_counts(total, counts)
    torch.cuda.empty_cache()
    phase_train_bert_parity()
    torch.cuda.empty_cache()
    # BERT-base under global-norm clipping, the clip kinds card against
    # CPU, and the one-line ops at full width
    add_counts(total, phase_train_bert_clip_amp(bert_stats, args.profile))
    torch.cuda.empty_cache()
    phase_train_bert_clip_parity()
    torch.cuda.empty_cache()
    phase_ops_tranche5_parity()
    torch.cuda.empty_cache()
    phase_train_deepfm(args.profile)
    torch.cuda.empty_cache()
    phase_train_deepfm_parity()
    torch.cuda.empty_cache()
    add_counts(total, phase_train_bench_vision(args.profile))
    torch.cuda.empty_cache()
    phase_train_se_resnext_parity()
    torch.cuda.empty_cache()
    add_counts(total, phase_train_stacked_lstm(args.profile))
    torch.cuda.empty_cache()
    phase_train_stacked_lstm_parity()
    torch.cuda.empty_cache()
    counts, dec_exe, dec_main, dec_scope = phase_train_decoder(
        args.seed, args.profile)
    add_counts(total, counts)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "decoder")
        want = phase_decode_beam(ckpt, dec_exe, dec_main, dec_scope)
        del dec_scope
        phase_decode_jit(ckpt, want)
        add_counts(total, phase_control_flow_parity(tmp))
    torch.cuda.empty_cache()
    add_counts(total, phase_train_srl(args.profile))
    torch.cuda.empty_cache()
    phase_train_srl_parity()
    torch.cuda.empty_cache()
    add_counts(total, phase_train_ctc(args.profile))
    torch.cuda.empty_cache()
    # the detection paths: rows 4-5 (ssd_loss, the R-CNN head's loss) and 6
    detection = {}
    counts, ssd, ssd_exe, ssd_scope = phase_train_ssd(args.profile)
    add_counts(detection, counts)
    phase_detect_ssd(ssd, ssd_exe, ssd_scope, args.profile)
    del ssd, ssd_exe, ssd_scope
    torch.cuda.empty_cache()
    phase_train_ssd_parity()
    add_counts(detection, phase_train_rcnn(args.profile))
    torch.cuda.empty_cache()
    phase_rcnn_parity()
    add_counts(total, {"momentum": detection["momentum"]})
    torch.cuda.empty_cache()
    # DCGAN through the transposed convolutions: row 7 at D's and G's
    # shapes, then card against CPU, and the tranche's 22 op types
    counts, dcgan = phase_train_dcgan(args.profile)
    add_counts(total, counts)
    adam["by_model"].update(optimizer_at_model_shapes(
        phase_kernel_adam, "adam",
        [(f"dcgan_{side}", dcgan[side], want, dcgan[f"{side}_params"])
         for side, want in (("d", DCGAN_D_TENSORS),
                            ("g", DCGAN_G_TENSORS))]))
    del dcgan
    torch.cuda.empty_cache()
    phase_train_dcgan_parity()
    torch.cuda.empty_cache()
    phase_ops_tranche6_parity()
    torch.cuda.empty_cache()
    # the misc, quant and metric tranche: int8 inference (row 1 on the
    # int8 Transformer), DeepFM under auc, the 31 op types card against CPU
    with tempfile.TemporaryDirectory() as tmp:
        phase_infer_resnet_int8(tmp, smi)
        torch.cuda.empty_cache()
        int8_counts = phase_infer_transformer_int8(tmp, smi)
        torch.cuda.empty_cache()
        phase_train_deepfm_auc()
        phase_ops_tranche7_parity(tmp)
    torch.cuda.empty_cache()
    # the remaining optimizers, LARS and ModelAverage: rows 6 and 7 fed
    # per-parameter rates computed each step, the eight new op types
    add_counts(total, phase_train_resnet_lars_amp(resnet_amp, args.profile))
    torch.cuda.empty_cache()
    phase_train_window_resnet_lars_amp(args.profile)
    torch.cuda.empty_cache()
    add_counts(total, phase_train_mnist_lars())
    phase_train_deepfm_optims()
    torch.cuda.empty_cache()
    phase_optim_ops_parity()
    torch.cuda.empty_cache()
    # the training machinery: Transformer-base through fluid.Trainer per
    # step with serial checkpoints, killed and resumed in subprocesses, as
    # windows, and under the guardian's drill (rows 1-5 and 7)
    with tempfile.TemporaryDirectory() as tmp:
        full = phase_trainer_transformer_amp(tmp)
        add_counts(total, full["launches"])
        add_counts(total, phase_trainer_kill_resume(tmp, full))
        add_counts(total, phase_trainer_windowed_amp(tmp, full))
        add_counts(total, phase_guardian_transformer_amp(tmp))
    torch.cuda.empty_cache()
    # the in-graph readers: the native library, ResNet-50 from recordio
    # shards through open_files + double_buffer (row 6), py_reader's LoD
    with tempfile.TemporaryDirectory() as tmp:
        phase_reader_native(tmp)
        add_counts(total, phase_train_resnet_reader_amp(tmp))
    torch.cuda.empty_cache()
    phase_reader_py_lod()
    torch.cuda.empty_cache()
    # the layer stacks and the MoE feed-forward: fluid_benchmark.py's
    # moe_transformer and the stacked Transformer-base (rows 1-5 and 7),
    # the routing and the stacks card against CPU
    adam["by_model"].update(optimizer_at_model_shapes(
        phase_kernel_adam, "adam",
        [("moe_transformer", build_training(MOE_LEN, flash=True,
                                            moe=MOE_EXPERTS)[0],
          MOE_ADAM_TENSORS),
         ("transformer_stacked", build_training(TRAIN_LEN, flash=True,
                                                stacked=True)[0],
          STACK_ADAM_TENSORS)]))
    counts, _ = phase_train_moe_amp(args.profile)
    add_counts(total, counts)
    torch.cuda.empty_cache()
    phase_moe_parity()
    torch.cuda.empty_cache()
    add_counts(total, phase_train_stacked_amp(
        {"train_flash_amp": flash_amp_stats}, args.profile))
    torch.cuda.empty_cache()
    phase_stack_parity()
    torch.cuda.empty_cache()
    # data parallelism: a world-1 NCCL group bitwise the single-device
    # steps (rows 1-7 through ParallelExecutor), two ranks over gloo
    # against one process at the global batch (row 6 on each rank)
    add_counts(total, phase_pe_world1(smi))
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(total, phase_pe_dp2_resnet(tmp, smi))
    # tensor and fsdp parallelism: Transformer-base tp2 (fp32, bf16) and
    # fsdp2 (bf16) over two ranks sharing the card (rows 1-3, 4's
    # partials, 5 and 7 on each rank's shards)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tp2 = phase_pe_tp2_transformer(tmp, smi)
    add_counts(total, tp2)
    xent_partial["launches"] = tp2["softmax_xent_partial"]
    for k in flash:
        k["launches"] += tp2.get(k["name"], 0) - tp2.get(
            k["name"] + "_bf16", 0)
    for k in (xent_fwd, xent_bwd):  # all wide (the phase checks)
        fp32 = tp2[k["name"]] - tp2[k["name"] + "_bf16"]
        k["launches"] += fp32
        k["launches_by_layout"]["wide"] += fp32
    for k in flash:
        k["launches"] += int8_counts.get(k["name"], 0)
    for k in (xent_fwd, xent_bwd):
        k["launches"] += detection[k["name"]]
        for layout in ("narrow", "wide"):
            k["launches_by_layout"][layout] += detection[
                f"{k['name']}_{layout}"]
    for k in (*flash_amp, *xent_amp, adam, momentum):
        k["launches"] += total.get(k["name"], 0)
    for k in flash_amp:  # the bf16 kernels at BERT-base's shape
        _, kind, sfx = k["name"].split("_")
        if sfx == "bf16":
            k["bert_shape"] = bert_shape[kind]
    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": [paged, xent_fwd, xent_bwd, adam, *flash,
                                  momentum, *xent_amp, *flash_amp,
                                  xent_partial]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
