#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``glimpseprune_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. find the card and print its name and power limit;
  2. build the CUDA kernels from glimpseprune_torch/csrc/, one nvcc per
     source, all at once (timed);
  3. K1, the fused window attention, and K8, window attention on roped
     q, k, v, each against its plain version at the 7B ViT's windowed shape,
     also relative to the output's size (K1 with the plain version's P in
     4 bits, K8 with K1 run on the same q, k, v, which ropes them a second
     time, as controls that must fail the check), then both on edge cases:
     a window with one valid key, trailing pad windows, the tiny config's
     head dim;
  4. K2, flash attention, against its plain version at each serving call
     site: ViT dense and segmented, LLM causal GQA, fuser Dqk != Dv, also
     relative to the output's size (controls that must fail: the plain
     version with P in 4 bits, and without key tile 0); then
     K2, K2-lse and K3 on edge cases: Sq and Skv that are no multiple of a
     tile, the tiny config's head dims (8, 16, 8/4), GQA group 7 with
     left-padded rows and a q tile that is all padding, and rows with no
     allowed key (output exactly 0, LSE exactly -1e30, dq exactly 0; dk and
     dv exactly 0 for keys no query sees);
  5. K2-lse (flash attention with the per-row LSE) and K3 (its backward)
     against their plain versions at the training batch's LLM causal GQA
     and fuser Dqk != Dv shapes, and at a small dense case: K3's dq, dk,
     dv each within GRAD_RTOL and relative to their size (2^-7 max, 2^-8
     RMS), with controls that must fail (the plain backward with dS in 4
     bits, and without key tile 0), and bit-identical over two calls;
  6. the serving path: Qwen2.5-VL-7B with the GlimpsePrune config and
     random bf16 weights, pruned and unpruned ``generate`` on a two-row
     batch and a one-row batch, with the kernels' launch counts; every
     decode step a replay of a captured CUDA graph, each chunk's replays
     under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside
     a chunk); then the decode checks on batch (a), pruned and unpruned:
     DECODE_CHECK_TOKENS steps replayed one at a time against the same step
     run eagerly on the card (tokens equal, or where they first differ the
     logits within DECODE_LOGIT_RTOL and a top-2 margin below it), the
     runner's decode of the same prefill giving the same tokens, its ms per
     token beside the eager steps'; on the pruned prefill, sampled decodes
     through the captured step (a seed fixes the tokens, another seed
     changes them, a temperature of SAMPLE_TINY_T gives the greedy tokens
     up to a tie and every token within SAMPLE_TIE_GAP of its step's top
     logit); and a serving-shaped decode as bench.py:563-628 runs it (two
     B=1 pruned prefills of (a)'s rows filled by ``cache_fill_rows`` into
     one preallocated B=2 cache, then SERVE_NEW_TOKENS greedy tokens with
     ``prealloc_t``, equal to the runner's own cache's tokens): capture ms,
     ms per token, peak memory and the card's idle share from
     torch.profiler, in (q4) K4's kernel records in a trace of one decode
     equal to its counted launches; then the cache is dropped (the runner
     must keep no reference to it) and a second decode into a newly
     allocated cache, as the bench allocates one per run, gives the same
     tokens (its capture ms, or none where the new cache took the old one's
     address and the kept graph served it, and its peak); then the tiny config
     on the card against the same weights on the CPU in fp32 (prefill
     logits, mask logits, and 8 captured decode steps against the CPU fed
     the card's tokens);
  7. the training path: ``GPTrainer.train(max_steps=4)`` at batch 2 on the
     same 7B model over a synthetic jsonl dataset, with the kernels' launch
     counts, finite losses, changed trainable and bit-identical frozen
     weights; then one tiny-config train step on the card against the CPU;
  8. K4 (int4 decode product) at the 7B decode shapes (M = 2 and 1; at
     k/v and gate/up also every class of M up to 128), within INT4_RTOL of
     its plain version, two calls bit-identical, a control that must fail
     (the plain version without the last K split's groups), one kernel a
     call, event and device ms warm and cold (weight copies rotated past the
     L2) and host ms a call; K5 and K6 (int4
     prefill products, W4A16 and W4A8) at the 7B decoder shapes with
     M = 1664 (K6 also bit-equal to its plain version in bf16, each output
     of its prep pass equal to its plain version's, at M = 1664 and, for
     gate/up and k/v, at M = 1662 and 256, with q8 truncated instead of
     rounded as the control that must fail; its prep and GEMM timed apart
     on the card), and K7 (int8 flash attention) dense, segmented and causal,
     with and without the int8 PV product, each against its plain version
     (K7 also against the other PV flavour and bf16 attention, which it
     must not pass: the check tells the int8 tiers apart), each output of
     its prep kernel equal to its plain version's, two calls bit-identical,
     one prep and one attention kernel a call, their device ms apart beside
     K2's at the same shape;
  9. the quantized serving path: a fresh random 7B (``init_random``, seed
     0), quantized on the card with ``quantize_model``, in two tiers: (q8)
     int8 weights with W8A8 prefill and an int8 KV cache, pruned and
     unpruned ``generate`` on batch (a); (q4) int4 weights with W4A8
     prefill, int8 ViT attention and an int8 KV cache, pruned and unpruned
     on batches (a) and (b). Each run prints its times, peak memory, weight
     and KV-cache bytes and the first logits' distance from the bf16
     model's; each tier then runs phase 6's decode checks (in (q4) also
     K4's launches per decode token, counted through the replays: 7 per
     layer and the head, nothing else) and ends with its tiny config on
     the card against the CPU;
 10. the compressed serving path (run after phase 6, before training
     changes the model): ``generate_compressed`` with each baseline
     compressor (visionzip, divprune, cdpruner, vscan, pdrop) on batches
     (a) and (b), with keep counts, prune ratios, times and launch counts
     (K8 must not launch: no config in configs/ has a windowed block that
     emits importance); then K8 on the importance path of the same 7B bound
     to a vision config that is not in configs/, whose last block is
     windowed (full attention at blocks 7, 15, 23): one launch per ViT
     call; a two-block tower of that kind on the card against the CPU; and
     the tiny config's compressed prefill (visionzip, pdrop) on the card
     against the CPU;
 11. sequence parallelism: K9 (the flash kernel's q_positions flavours:
     forward, LSE, backward, int8) on batch (a)'s causal shape with the q
     rows cut into 2 and 4 shards and one unaligned shard, against its plain
     versions and the monolithic K2 / K2-lse / K3 / K7 (with a control that
     must fail; the backward held as in phase 5; K9-int8's prep outputs
     equal to their plain versions and two calls bit-identical, its prep
     and attention device ms apart beside K9's); then SP_WORLD ranks on
     this one card over gloo, started by the port's launcher, each
     building the 7B from seed 0 (checked by a checksum all-gather): SP
     generate pruned and unpruned on batches (a)
     and (b) against rank 0's single-process run (first-logit and mask-logit
     distance, keep counts, tokens, K9 launches per prefill by the
     per-call-site rule), the training batch's gradients under SP against
     one process and two SP train steps, one SP (q8) generate with the text
     attention in int8 (K9-int8), and the tiny config under SP on the card
     against the CPU; times from CUDA events and peaks per rank.
     (m) the (data, model) mesh, inside the same ranks after their SP work
     (no extra 7B is built): rank 0's unsharded run of batch (a) first
     (prefill ms, captured and eager decode ms/token), then
     ``shard_params`` over a 1 x 2 mesh (tensor parallelism, TP) and TP
     prefill and decode (eager: gloo collectives cannot be captured in a
     CUDA graph), pruned and unpruned, on the trained bf16 7B and on the
     (q8) 7B (int8 weights, W8A8 prefill, int8 KV, text attention int8),
     held against the unsharded run (first logits and mask logits within
     phase 11's bound, the first logits within CROSS_LOGIT_RTOL in bf16,
     the keep sets equal; in (q8) layer 0's row-parallel W8A8 product
     bit-equal to the unsharded one and the decoded tokens equal; in bf16
     every decode step's logits within TP_DECODE_LOGIT_RTOL of the
     unsharded model fed the mesh's tokens), the same on both ranks; the
     training batch's loss and gradients on the TP bf16 7B against the
     unsharded ones (K2-lse and K3 at 14 q / 2 kv heads; the global L2 and
     every tensor, beside a one-process witness of the mesh's order of
     summation and a control without the input gradients' all-reduce);
     the gloo all-reduce and all-gather ms of one layer's tensors, each
     rank's peak and kernel launches (``launches_tp`` on every
     kernels-line row, per rank; the SP rows count the SP runs alone);
     then the tiny config on the card against the CPU: a train step over
     a 2 x 1 data mesh, and the continuous batcher over the 1 x 2 TP mesh.
 12. continuous serving (``serving.ContinuousBatcher``, run after phase 6's
     decode checks on its bf16 7B, before training changes it, and in phase
     9's (q4) tier after its decode checks): (s-p) batch (a)'s rows 0, 1
     and 0 again as B=1 pruned prefills at R = out_len through 2 slots, 8
     steps a chunk, 64 tokens each, eos never met, so the third request
     waits for a freed slot; (s-u) the same rows unpruned, padded to (a)'s
     length, admitted through ``vanilla_prefill_chunked_steps`` in chunks of
     256 (4 each), running rows decoding between them. Each side: one
     capture (``warm``), a timed serve with every chunk's replays under
     sync_checked, whose launches (counts set to 0 just before it) are the
     side's and must include its kernels (K1, K2 or K7 in (q4) in every
     admission's ViT; K2 causal and fuser and, in (q4), K6 in the pruned
     admissions; K4 in (q4)'s replays), a second serve that captures
     nothing and gives the same tokens (replayed one step at a time for
     its logits), each request's tokens against the runner's own
     step-wise decode of the same B=1 prefill (every step's logits up to
     the first token that differs within CROSS_LOGIT_RTOL, and phase 6's
     tie rule at that bound: the batcher decodes two rows, the reference
     one), the same comparison read on serves with a fault planted
     (a request admitted one position behind, a stale kv_valid lane, and
     for (s-u) the chunks' pads attended), each of which must read past
     the bound, ms per step, idle share over a chunk, peak memory, ttft
     and completion per request, tok/s; in (q4) K4's records in a trace
     of one chunk equal to its counted launches (197 a step) and no K5 or
     K6 launch inside a prefill chunk.
     Also: ``vanilla_prefill_chunked`` then ``_decode_loop(prealloc_t=T)``
     against ``generate(do_selection=False)`` on each row (first logits,
     and every step's up to the first token that differs, within
     CROSS_LOGIT_RTOL: the chunks attend in fp32, the monolithic prefill
     through K2; a control of two ViT attention flavours on the same row
     must stay under it), a sampled capacity-1 batcher against the
     runner's sampled ``generate`` at the same seed (another seed changes
     its tokens), the pruned B=1 prefill's ms beside a prefill chunk's;
     the kernels line carries each side's launches as
     ``launches_continuous``.
 13. GlimpsePrune+ and the main path's knobs (run on phase 6's bf16 7B
     after phase 12, before phase 10; and (vi) in phase 9's (q4) tier after
     its phase 12): (i) ``glimpse_delayed`` + ``apply_selection`` keep the
     set and give the 32 greedy tokens of ``glimpse`` / ``generate`` on
     batch (a); (ii) overridden logits (+inf on OVERRIDE_KEEP image tokens
     of each row, capped at the row's ratio cap, -inf elsewhere) keep
     exactly that set; (iii) ``generate(use_ref_masks=True)`` with a box
     on each row keeps the keep policy's set on the boxes' +-inf logits,
     computed beside it, and ``gp.use_zero_masks`` keeps min_remain_num a
     row; (iv) ``harvest_rows`` at selected_layers gives finite log-probs
     [B, N, Hq], and with q_start = S - HARVEST_QUERIES probabilities in
     [0, 1]; (v) ``GRPOTrainer`` (LoRA rank GRPO_RANK, G = GRPO_G samples
     of one prompt over row 0's image, GRPO_NEW_TOKENS tokens at
     temperature 1.0, GRPO_STEPS steps): finite losses, kd_loss below 1e-3
     at step 1, some lora_b non-zero after it, one decode capture over both
     steps, the steps' peak under half a weight copy over the model, and
     every base weight bit-identical after (the adapters are then
     removed); each step's CUDA-event ms, peak, and K2-lse / K3 causal
     launches; (vi) (q4) zero-B adapters on every decoder projection
     against the same model under ``lora_disabled`` on (a)'s row 0: the
     adapted prefill bit-equal to the disabled one with the text's
     act_quant "none" (mask logits, and first logits under one keep set);
     one pruned prefill decoded both ways gives bit-identical logits and
     tokens (K4 in every step); the disabled prefill under the tier's
     act_quant launches K6, the adapted one none (A8 is off on adapted
     layers), and their distance is printed. The kernels line carries the phase's launches as
     ``launches_glimpse_plus``.
 14. LLaVA-1.5-7B (``configs/model_llava1_5_7b_gp``, CLIP ViT-L/336 with
     CDPruner's text tower, run after phase 11 once the earlier models are
     gone): K2 at the decoder's MHA causal shape (32 q over 32 kv heads)
     and the fuser's Dqk != Dv over 576 tokens in one segment, held as in
     phase 4 (controls included, times beside SDPA's); the tiny LLaVA
     config on the card against the CPU (first logits, mask logits, 8
     decode steps within 10%, keep sets and greedy tokens equal); the 7B's
     weights made as random HF-layout dicts on the card (merged LLaVA-1.5
     with a CLIPVisionModelWithProjection tower, and a
     CLIPTextModelWithProjection), converted by the port's converters and
     taken by ``init_random(base=)``, which draws the GlimpsePrune modules
     alone (every HF tensor used, every base parameter loaded without a
     copy, the fp32 LayerNorms holding the dicts' values); pruned and
     unpruned ``generate`` at B = 2 (two 336x336 images, prompts of 30 and
     22 ids, 32 greedy tokens) under LLAVA_REMAIN_RATIO (random weights
     keep every token without a cap: fewer than 576 must be kept a row, so
     that the prefill compacts and layers 22-31 and the decode run over the
     kept rows), with one decode capture a mode and the replays counted,
     phase 6's captured-decode check on the pruned prefill; the all-kept equivalence
     (reduce_threshold -1: 576 kept a row, the pruned run's tokens against
     the unpruned run's by phase 12's cross_check, two arithmetics of one
     function); ``generate_compressed``
     CDPruner with ``clip_text_ids`` keeping 64 a row; two base train steps
     (finite losses, the glimpse embeddings moved, base weights
     bit-identical, K2-lse and K3 launched); the (q8) tier quantized in
     place (CLIP unquantized), 16 tokens pruned with phase 9's checks and
     the decode check. The kernels line carries the K2 rows at the two
     shapes, each with ``launches_llava`` (main path, train, q8) and no
     count of phases 12-13; a row of an earlier phase carries
     ``launches_llava`` only where no LLaVA row has its name (K2-lse, K3),
     so that each of phase 14's counts stands on one row.
 15. the evaluation path through the port's command lines (run last, when
     the card holds no model), Qwen2.5-VL-7B at full width with random
     weights (``--model-config configs/model_qwen2_5_7b_gp --seed 0``):
     ``tools.train_gp`` trains EVAL_TRAIN_STEPS steps at batch 2 on phase
     7's synthetic corpus and saves the new modules; ``tools.infer_viscot``
     loads them and runs a VisCoT-format benchmark of 4 .npy images (2 at
     896x672, 2 at 672x504; boxes on 3 rows) at batch 2 as ``generate``
     (EVAL_NEW_TOKENS tokens), ``glimpse`` and ``--compressor visionzip``:
     4 records each with the JAX harness's fields, mask ratios in (0, 1],
     the box metrics on the boxed rows, info.json's logger_stats with one
     timed call per batch; a second call without --overwrite leaves its
     output as it is; the generate records equal an in-process
     ``run_inference`` on a model built the same way; each call's model is
     freed when it returns. ``tools.score_results`` (precise_match) and
     ``flops_report_from_results`` (GP FLOPs below vanilla) read them.
     Then the (q4) 7B round trip through ``save_full_params`` /
     ``load_full_params``: greedy tokens, keep sets, mask logits and first
     logits bit-identical, the file's bytes and both sides' seconds, and the
     load's peak no more than the weights it holds. The kernels line carries
     the phase's launches as ``launches_eval`` (the CLIs; the round trip).
 16. the tools (run after phase 15, when the card holds no model, on its
     outputs), 7B width, random weights: (a) the native image prep
     (``preprocessing/native.py``, built with the kernels) on a 4086x4086
     and a 1000x750 image against the numpy path where no resize is needed
     (within 1e-6, grids equal), its ms on the 16k image, and, with PIL
     hidden, the numpy path's ImportError naming ``use_native_preproc`` and
     ``prepare_inputs(use_native_preproc=True)`` running without PIL;
     ``device_random_params`` (q8): its seconds, the dequantized std of 8
     sampled columns of every int8 linear within 5% of fan_in ** -0.5, and
     the draw's peak within 5% of the weights it leaves (no bf16 copy);
     (b) ``tools.profile_prefill`` (q8) on the 4086x4086 image with the
     native prep (S = 16448, 65,536 patches, 16,384 image tokens) and its
     ViT split, then bf16 at the default 1036x1036 cap: stages, prep ms,
     kept tokens (at least min_remain_num), peak, finite first logits; (c)
     ``tools.profile_decode`` (q8) + int8 KV and bf16 at T = 2048, 8192,
     16896, (q4) at 2048: ms/step, the slope per 1k tokens of context and
     the bytes a step it implies; (d) ``tools.profile_train_step`` (q8) at
     side 3584 with fallback sides 3584, 2688, 1792, 2 steps: the side that
     ran, step ms, peak, finite losses; (e) ``tools.profile_grpo_step``
     (q8, rows 16, prompt 2048, completion 256, rank 8): chunked and
     full-logits step and reference logprobs, ms and peak or "oom", the
     losses within 1e-3 relative where both ran; (f) ``tools.demo_server``
     in a thread on 127.0.0.1, port 0 (bf16), two requests with the
     1000x750 image as ``image_npy``, GP on (streamed) and off: their
     tokens equal an in-process ``stream_generate`` / ``generate`` on the
     same model and inputs, the overlay PNG read back with zlib equals
     ``apply_mask_on_image`` of the kept mask, no ``error`` event; each
     request's time to its first event, total ms and capture ms; (g)
     ``tools.save_attn_maps`` (--per-head, 4 query maps): the expected PNG
     count, finite heatmaps, harvest rows summing to at most 1 over the
     image keys; (h) ``tools.compare_results`` and ``tools.compare_server``
     on phase 15's generate and visionzip results: 4 joined rows, every
     page 200 with 4 rows, one ``.npy`` overlay rendered. The kernels line
     carries the phase's launches as ``launches_tools``.
 (c) the synthetic-boxes training tools (run last, when the card holds no
     model; ``tools.convergence_run``, ``sweep_reduce_quality``, ``demo``
     through ``main(argv)``): the base stage on the bench's 7B config
     (``bench_config("7b")``, not configs/) in the (q8) weight-only tier,
     100 steps at B = 1 over 64 synthetic 560x560 images (S = 448-512, 400
     image tokens): every loss finite, the mean loss of the last 20 steps
     below the first 5's, the mean mask IoU above, the frozen base's
     checksum unchanged; s/step, the host's share (``prepare_inputs`` and
     the collate), IoU / precision / recall at steps 1, 50, 100, peak; the
     saved modules loaded onto a fresh 7B of the same seed in the bench's
     (q8) serving tier (its frozen bytes equal to the training base's), the
     modules changed from the seed's draw, pruned ``generate`` (16 tokens,
     B = 2) on 8 held-out images of another seed: keep count against the
     cap, precision and recall against the boxes' tokens, prune ratio, and
     the same with the seed's untrained modules, whose mean precision the
     trained ones must exceed (the "convergence:" line); the resume from
     step 100 to 105 (steps continue at 101, the first 100 rows carried)
     and 100 -> 103 -> 105 equal to it (rtol 1e-6); the GRPO stage at
     tiny, 30 steps (rewards and losses finite, the adapters moved, the
     base unchanged, 30 logged rows), then 3 steps under a reward that
     varies, in which the update must move the adapters' B (a random
     policy earns precision_match's reward too rarely for that);
     ``sweep_reduce_quality --layers
     2,18 --steps 10`` (two rows); ``demo --int8`` at 7B width (20 layers):
     int8 linears in both towers, ids in the vocabulary, finite mask
     logits. The kernels line carries the phase's launches as
     ``launches_conv`` (base, serve, resume, grpo, sweep, demo_int8).
 (k) the ViT kernel sweeps (last, after phase (p); ``tools.
     sweep_vision_attention`` sections 1 and 1b, ``sweep_vit_fullatt``,
     ``i8attn_microbench --s-vit 65536``, each through ``run``) at the
     16k-token image's 65,536 patches, SWEEP_ITERS timed calls a row: K1
     at every heads-per-block count bit-equal to the shipped plan's output
     and within phase 3's limits of its plain version; the (q8) windowed
     block taken apart (the W8A8 products with their GEMMs and passes
     apart, K1, the SwiGLU, the halves, the whole block in (q8) and
     weight-only int8), K1's output inside the (q8) and the weight-only
     block within phase 3's limits of its plain version on the qkv the
     block gave it (each whole block's distance from the block with K1's
     plain version printed, not held: every rounding after K1, W8A8's
     int8 and bf16's, falls differently); dense, segmented and causal K2
     and K7 in both PV flavours against their plain versions on
     SWEEP_CHECK_ROWS q rows, beside SDPA's backends; one launch a call on
     each wrapper's counter. Its K1, dense and segmented K2 and K7 rows at
     65,536 join the kernels line (``"phase": "k"``; their plain ms over
     the checked rows, ``plain_rows``); every row carries the phase's
     launches as ``launches_sweeps``. The script's seconds print last,
     beside its seconds before phase (k).
Every kernel row carries its time (CUDA events over 10 calls) and
``device_ms``, the card's own time from torch.profiler, without the
host's launch cost, its plain version's time, one PyTorch
call's time where one computes the same function (``library_ms``: SDPA
with the same boolean mask, or its autograd backward; a yardstick the port
never calls; for the int4 products, where no PyTorch call computes the
function, null with ``bf16_matmul_ms`` beside it: the bf16 matmul of the
same shape that the unquantized path pays) and ``bound_ms``: the larger of
its bytes over the card's memory rate and its operations over the tensor
peak of their type (bf16, or int8 for the int8 products), counted from this
run's inputs. Before the summary, one "speed" line per kernel row gives its
time beside the time PERF.md records for it before the redesign of K1,
K8, K2, K3, K4 and K6 (``RECORDED_MS``), the rate it reached and its
share of the bound. The line before the last is a JSON object with one
entry per kernel flavour; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import shutil
import subprocess
import sys
import time
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from glimpseprune_torch.tools.kernel_ab import (
    K7_MAX_RTOL,
    K7_RMS_RTOL,
    KERNEL_ATOL,
    PEAK_BF16_FLOPS,
    PEAK_HBM_BYTES,
    PEAK_INT8_OPS,
    bound,
    cuda_ms,
    device_ms,
    device_ms_by_kernel,
    nbytes,
    rel_errors,
    rel_within,
)

ROOT = Path(__file__).resolve().parent
K1_SRC = "glimpseprune_torch/csrc/window_attention.cu"
K1_REPLACES = "glimpseprune_tpu/ops/pallas/window_attention.py:133"
K8_REPLACES = "glimpseprune_tpu/ops/pallas/window_attention.py:198"
K2_SRC = "glimpseprune_torch/csrc/flash_attention.cu"
K2_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:400"
K2_LSE_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:208"
K3_SRC = "glimpseprune_torch/csrc/flash_attention_bwd.cu"
K3_REPLACES = "glimpseprune_tpu/ops/pallas/flash_attention.py:808"
INT4_SRC = "glimpseprune_torch/csrc/int4_matmul.cu"
K4_REPLACES = "glimpseprune_tpu/ops/pallas/int4_matmul.py:103"
K56_REPLACES = "glimpseprune_tpu/ops/pallas/int4_matmul.py:283"
K7_REPLACES = {"dense": "glimpseprune_tpu/ops/pallas/flash_attention.py:200",
               "segmented": "glimpseprune_tpu/ops/pallas/flash_attention.py:175",
               "causal": "glimpseprune_tpu/ops/pallas/flash_attention.py:175"}
K9_REPLACES = {"flash_attention": "glimpseprune_tpu/ops/pallas/flash_attention.py:183",
               "flash_attention_lse": "glimpseprune_tpu/ops/pallas/flash_attention.py:216",
               "flash_attention_backward": "glimpseprune_tpu/ops/pallas/flash_attention.py:341",
               "flash_attention_int8": "glimpseprune_tpu/ops/pallas/flash_attention.py:191"}
KERNEL_LIBS = ("window_attention", "flash_attention", "flash_attention_bwd", "int4_matmul")
# K3's dq, dk and dv are bf16 (rounding 2**-9 of the largest entry) from
# fp32 sums taken in another order than the plain version's, over up to a
# GQA group of 7 q heads times ~900 rows: 1e-2 of max |ref| bounds both.
# The LSE is fp32 from the same fp32 scores: 1e-4 of max |ref| bounds the
# summation order of its row sums.
GRAD_RTOL = 1e-2
LSE_RTOL = 1e-4
# K4-K6 write bf16 from fp32 (K4, K5) or exact int32 (K6) sums: the output
# rounding is at most 2**-8 (bf16's unit roundoff, 3.9e-3) of the largest
# |ref|, the fp32 summation order adds ~1e-6 of it; K6's rescale is the
# plain version's, operation for operation. 4e-3 of max |ref| bounds both,
# with ~2% over the worst-case rounding (measured 2.1e-3 to 3.4e-3).
INT4_RTOL = 4e-3
# K4 is checked at M = 1 and the decode batch at every shape, and at these
# M (every class of its tiles, ragged and full) for k/v and gate/up; its
# cold times rotate through weight copies of at least this many bytes, three
# times the H100's 50 MB L2, as decode reads each layer's weights once.
K4_CHECK_M = (8, 9, 16, 17, 33, 64, 100, 128)
K4_COLD_BYTES = 150 * 10**6
# K1, K2 and K7 are held to kernel_ab's KERNEL_ATOL and its relative
# limits (K7_MAX_RTOL, K7_RMS_RTOL, rel_within). Controls that must fail:
# the plain version with P rounded to 4 significant bits (~2.7e-2 RMS off)
# and, for K2, without key tile 0 (control_attention).
# Each kernel's time as PERF.md's kernel table records it for the kernels
# that the tensor-core K1, K8, K2 and K3 flavours, the two-pass K6 and the
# one-launch K4 replace (K3's, K9 backward's and K4's from the last run
# before their redesign, K6's from its first, unpipelined version) and for
# the kernels kept as they are, mean ms of 10 calls on an NVIDIA H100 80GB
# HBM3 at 700 W at the same shapes: printed beside this run's time.
RECORDED_MS = {
    "window_attention_fused": 0.2946, "window_attention": 0.3016,
    "flash_attention[dense]": 3.7256, "flash_attention[segmented]": 5.4423,
    "flash_attention[causal]": 0.6203, "flash_attention[dqk_ne_dv]": 0.3383,
    "flash_attention_lse[causal]": 0.9003, "flash_attention_lse[dqk_ne_dv]": 0.3417,
    "flash_attention_backward[causal]": 4.4222, "flash_attention_backward[dqk_ne_dv]": 0.8967,
    "matmul_int4[3584x3584]": 0.0659, "matmul_int4[3584x512]": 0.0612,
    "matmul_int4[3584x18944]": 0.0779, "matmul_int4[18944x3584]": 0.0834,
    "matmul_int4[3584x152064]": 0.9810,
    "matmul_int4_prefill[a16,3584x3584]": 2.1540, "matmul_int4_prefill[a16,3584x512]": 0.5300,
    "matmul_int4_prefill[a16,3584x18944]": 10.4312,
    "matmul_int4_prefill[a16,18944x3584]": 12.0072,
    "matmul_int4_prefill[a8,3584x3584]": 0.8007, "matmul_int4_prefill[a8,3584x512]": 0.4945,
    "matmul_int4_prefill[a8,3584x18944]": 3.2937, "matmul_int4_prefill[a8,18944x3584]": 4.6463,
    "flash_attention_int8[dense]": 3.1134, "flash_attention_int8[dense+pv8]": 4.3081,
    "flash_attention_int8[segmented]": 4.5792, "flash_attention_int8[segmented+pv8]": 6.2714,
    "flash_attention_int8[causal]": 0.6453, "flash_attention_int8[causal+pv8]": 0.8228,
    "flash_attention[causal+qpos]": 0.5879, "flash_attention_lse[causal+qpos]": 0.5886,
    "flash_attention_backward[causal+qpos]": 2.5345, "flash_attention_int8[causal+qpos]": 0.5461,
}
# sequence parallelism on the one card: two ranks over gloo (NCCL refuses
# two ranks on one device)
SP_WORLD = 2
MAX_NEW_TOKENS = 32
# decode checks (phases 6, 9): captured steps against the step run eagerly
# on the card, DECODE_CHECK_TOKENS greedy tokens. The two runs launch the
# same kernels on the same inputs; where a token differs, the step before
# must show why: logits within DECODE_LOGIT_RTOL of max |logit| of each
# other (bf16 logits round at 2**-8 of their size, and a library may pick
# another algorithm inside a capture) and the top two closer than that.
DECODE_CHECK_TOKENS = 16
DECODE_LOGIT_RTOL = 1e-2
# the serving-shaped decode (bench.py:563-628): two B=1 prefills filled
# into one preallocated cache, then this many greedy tokens in one chunk;
# the card's idle share is traced over IDLE_TRACE_TOKENS of them
SERVE_NEW_TOKENS = 128
IDLE_TRACE_TOKENS = 32
# sampled decode checks: at SAMPLE_TINY_T a Gumbel-max sample (noise
# g = -log(-log u), u an fp32 uniform draw, spans under 20) lies within
# 20 * SAMPLE_TINY_T = 2e-5 of its step's top logit, plus the fp32
# rounding of logits / T; SAMPLE_TIE_GAP holds it to that
SAMPLE_SEED = 1234
SAMPLE_TINY_T = 1e-6
SAMPLE_TIE_GAP = 1e-4
# the continuous-serving phase (serving.ContinuousBatcher): batch (a)'s rows
# 0, 1, 0 as B=1 requests through CONT_CAPACITY slots, so the third waits
# for a freed one; CONT_INTER decode steps between host reads; unpruned
# requests admitted in prefill chunks of CONT_CHUNK tokens
CONT_REQUESTS = (0, 1, 0)
CONT_CAPACITY = 2
CONT_INTER = 8
CONT_NEW_TOKENS = 64
CONT_CHUNK = 256
# phase 12 compares two arithmetics of one function: the batcher decodes 2
# rows over its own cache length where the runner's reference decodes 1
# (other GEMM shapes), and the chunked prefill attends in fp32
# (decode_attention) where generate's monolithic prefill runs K2 (P
# rounded to bf16). Any such change moves the random bf16 7B's logits
# further than the same kernels' DECODE_LOGIT_RTOL, so phase 12 holds the
# logits of every step up to the first token that differs, and phase 6's
# tie rule, at this bound. It lies between two readings on an H100 (bf16
# and (q4)): those arithmetics, 2.03e-2 at most, and a request admitted
# one position behind over R = 831 slots, the faintest planted fault, 3.75e-2
# at least; a control of two arithmetics (row 0 of batch (a), whose ViT
# attention is segmented, against the same row alone, where it is dense)
# and every planted fault (CONT_FAULTS) are read on each run
CROSS_LOGIT_RTOL = 2.75e-2
TRAIN_STEPS = 4
# phase 13: delayed selection, the oracle masks, harvest_rows, GlimpsePrune+
OVERRIDE_KEEP = 64  # image tokens forced kept per row (at most the ratio cap)
HARVEST_QUERIES = 16  # harvest_rows(q_start = S - 16)
REF_BOXES = [[[0.1, 0.1, 0.5, 0.6]], [[0.3, 0.2, 0.9, 0.7]]]  # one box per row of (a)
GRPO_G = 4
GRPO_NEW_TOKENS = 32
GRPO_RANK = 8
GRPO_STEPS = 2
GRPO_LR = 1e-5
COMPRESSORS = ("visionzip", "divprune", "cdpruner", "vscan", "pdrop")
COMPRESSED_NEW_TOKENS = 8
# the image-token budget of divprune, cdpruner and vscan (the papers' 128
# setting): under every row's image-token count, so each row really prunes
VISUAL_TOKEN_NUM = 128
# full attention at three of the 7B's four blocks: the last one is windowed,
# so its importance goes through K8 (a config that is not in configs/)
WINDOWED_LAST_FULLATT = (7, 15, 23)


def cut_config_dir() -> str:
    """The directory of the 7B's config cut to TOOLS_TEXT_LAYERS layers,
    which phase 16's tools load (written once, under build/)."""
    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.tools.common import depth_cut

    out = ROOT / "build" / "chip_smoke_cut_7b"
    if not (out / "config.json").exists():
        depth_cut(ModelConfig.load(str(ROOT / QWEN_DIR)), TOOLS_TEXT_LAYERS).save(str(out))
    return str(out)


def find_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def build_kernels():
    """Every kernel library at once: one nvcc process per source."""
    from glimpseprune_torch.ops.cuda.build import library_path, load_library

    t0 = time.perf_counter()
    from glimpseprune_torch.preprocessing import native

    with ThreadPoolExecutor(len(KERNEL_LIBS) + 1) as pool:
        built = [pool.submit(load_library, name) for name in KERNEL_LIBS]
        built.append(pool.submit(native.build))  # the image prep's host library (g++)
        for b in built:
            b.result()
    print(f"built {Path(native.library_path()).name} (g++, host image prep)")
    for name in KERNEL_LIBS:
        print(f"built {name}: {library_path(name).with_suffix('.log').read_text().strip()}")
    secs = time.perf_counter() - t0
    print(f"kernel build: {secs:.1f} s")
    return secs


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def speed(row) -> str:
    """The line that prints a kernel row's time beside its recorded time,
    the achieved rate and the share of the bound; the row is left as it
    is. The rate is the bound's work over this run's time: GB/s for a bytes
    bound, TFLOP/s (TOP/s for the int8 products) for an operations bound."""
    share = row["bound_ms"] / row["ms"]
    int8 = row["name"].startswith(("flash_attention_int8", "matmul_int4_prefill[a8"))
    if row["bound_by"] == "bytes":
        rate = f"{share * PEAK_HBM_BYTES / 1e9:.0f} GB/s"
    elif int8:
        rate = f"{share * PEAK_INT8_OPS / 1e12:.1f} TOP/s"
    else:
        rate = f"{share * PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s"
    recorded = None if "phase" in row else RECORDED_MS.get(row["name"])
    before = ("" if recorded is None
              else f", recorded {recorded:.4f} ms ({recorded / row['ms']:.1f}x)")
    device = ""
    if "device_ms" in row:  # the card's own time, and the library call's
        device = f"; on the card {fmt_ms(row['device_ms'])}"
        if "library_device_ms" in row:
            device += f" (library {fmt_ms(row['library_device_ms'])})"
    return (f"speed {row['name']} {row.get('shape', '')}: {row['ms']:.4f} ms{before}, {rate}, "
            f"{share:.1%} of the bound ({row['bound_by']}){device}")


def check_window_attention(cfg, prep, gen):
    """K1 at the ViT shape the batch gives it (H=16, D=80, wp=64), within
    KERNEL_ATOL and relative to its outputs' size (K7_MAX_RTOL, K7_RMS_RTOL),
    with the plain version's P rounded to 4 significant bits as the control
    that must fail."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention_fused,
        window_attention_fused_reference,
    )
    from glimpseprune_torch.ops.rope import rotate_half, vision_rope_cos_sin

    v = cfg.vision
    wp = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit
    p = prep.patches.shape[0]
    qkv = torch.randn((p, 3, v.num_heads, v.head_dim), generator=gen, device="cuda").bfloat16()
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    cos, sin = cos.bfloat16(), sin.bfloat16()
    valid = torch.as_tensor(prep.vis_valid, device="cuda")
    got = window_attention_fused(qkv, cos, sin, valid, wp)
    torch.cuda.synchronize()
    ref = window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
    err = (got.float() - ref).abs().max().item()
    errs = rel_errors(got, ref)
    x, c, s = qkv.float(), cos.float()[:, None], sin.float()[:, None]
    nw = p // wp

    def windows(t):
        return t.reshape(nw, wp, v.num_heads, v.head_dim).transpose(1, 2)

    allowed = valid.reshape(nw, 1, 1, wp) | torch.eye(wp, dtype=torch.bool, device="cuda")
    control = control_attention(windows(x[:, 0] * c + rotate_half(x[:, 0]) * s),
                                windows(x[:, 1] * c + rotate_half(x[:, 1]) * s),
                                windows(x[:, 2]), allowed, round_p=True)
    control_errs = rel_errors(got, control.transpose(1, 2).reshape(got.shape))
    ms = cuda_ms(lambda: window_attention_fused(qkv, cos, sin, valid, wp))
    dev_ms = device_ms(lambda: window_attention_fused(qkv, cos, sin, valid, wp))
    plain_ms = cuda_ms(lambda: window_attention_fused_reference(qkv, cos, sin, valid, wp))
    # valid queries x valid keys of each window, QK^T and PV, every head
    per_window = valid.reshape(-1, wp).sum(1).double()
    flops = 4.0 * float((per_window ** 2).sum()) * v.num_heads * v.head_dim
    bound_ms, bound_by = bound(flops, nbytes(qkv, cos, sin, valid, got))
    shape = f"qkv[{p},3,{v.num_heads},{v.head_dim}] wp={wp} valid={int(valid.sum())}"
    print(f"K1 window_attention_fused {shape}: max_abs_err={err:.3e} rel_err={errs[0]:.3e} "
          f"rms_rel_err={errs[1]:.3e}; control p_4_bits (max/rms rel) "
          f"{control_errs[0]:.3e}/{control_errs[1]:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not (err <= KERNEL_ATOL and rel_within(errs)):
        raise AssertionError(f"K1 disagrees with its plain version: {err}, {errs}")
    if rel_within(control_errs):
        raise AssertionError("K1: the check cannot tell the kernel from P in 4 bits")
    # no single PyTorch call applies rope and attends within windows
    return {"name": "window_attention_fused", "route": "cuda", "source": K1_SRC,
            "replaces": K1_REPLACES, "max_abs_err": err, "rel_err": errs[0],
            "rms_rel_err": errs[1], "control_rms_rel_err": control_errs[1], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape}


def check_window_attention_tp_heads(cfg, prep, gen):
    """K1 at the heads one rank holds on a model axis of 2 and of 4 (8 and
    4 of the ViT's 16; ``plan_window`` takes the head count) against its
    plain version, within phase 3's limits; -> {heads: (max abs, rel, rms
    rel)}."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention_fused,
        window_attention_fused_reference,
    )
    from glimpseprune_torch.ops.rope import vision_rope_cos_sin

    v = cfg.vision
    wp = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    cos, sin = cos.bfloat16(), sin.bfloat16()
    valid = torch.as_tensor(prep.vis_valid, device="cuda")
    out = {}
    for heads in (v.num_heads // 2, v.num_heads // 4):
        qkv = torch.randn((prep.patches.shape[0], 3, heads, v.head_dim), generator=gen,
                          device="cuda").bfloat16()
        got = window_attention_fused(qkv, cos, sin, valid, wp)
        ref = window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
        err = (got.float() - ref).abs().max().item()
        out[heads] = (err,) + tuple(rel_errors(got, ref))
        if not (err <= KERNEL_ATOL and rel_within(out[heads][1:])):
            raise AssertionError(f"K1 at {heads} heads disagrees with its plain version: "
                                 f"{out[heads]}")
    print("K1 at a rank's heads on a model axis of 2 and 4 (max abs, rel, rms rel): "
          + json.dumps(out))
    return out


def check_window_attention_unfused(cfg, prep, gen):
    """K8 at the 7B ViT's windowed shape (q, k, v [P, 16, 80], wp=64) with
    the batch's padded windows, held relative to its outputs' size as K7 is
    (bf16 output rounding; K7_MAX_RTOL, K7_RMS_RTOL). Control: K1 on the
    same q, k, v stacked as its qkv input ropes q and k a second time, and
    must fail the same check."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
        window_attention_reference,
    )
    from glimpseprune_torch.ops.rope import vision_rope_cos_sin

    v = cfg.vision
    wp = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 * v.spatial_merge_unit
    p = prep.patches.shape[0]
    q, k, vv = (torch.randn((p, v.num_heads, v.head_dim), generator=gen, device="cuda")
                .bfloat16() for _ in range(3))
    valid = torch.as_tensor(prep.vis_valid, device="cuda")
    got = window_attention(q, k, vv, valid, wp)
    torch.cuda.synchronize()
    ref = window_attention_reference(q.float(), k.float(), vv.float(), valid, wp)
    errs = rel_errors(got, ref)
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    control = window_attention_fused(torch.stack([q, k, vv], 1).contiguous(), cos.bfloat16(),
                                     sin.bfloat16(), valid, wp)
    control_errs = rel_errors(control, ref)
    ms = cuda_ms(lambda: window_attention(q, k, vv, valid, wp))
    plain_ms = cuda_ms(lambda: window_attention_reference(q, k, vv, valid, wp))
    nw = p // wp

    def windows(t):
        return t.reshape(nw, wp, v.num_heads, v.head_dim).transpose(1, 2)

    # one SDPA call over the windows with the same mask computes K8's function
    mask = valid.reshape(nw, 1, 1, wp) | torch.eye(wp, dtype=torch.bool, device="cuda")
    qw, kw, vw = windows(q), windows(k), windows(vv)
    lib_ms = cuda_ms(lambda: sdpa(qw, kw, vw, mask))
    dev_ms = device_ms(lambda: window_attention(q, k, vv, valid, wp))
    lib_dev_ms = device_ms(lambda: sdpa(qw, kw, vw, mask))
    per_window = valid.reshape(-1, wp).sum(1).double()
    flops = 4.0 * float((per_window ** 2).sum()) * v.num_heads * v.head_dim
    bound_ms, bound_by = bound(flops, nbytes(q, k, vv, valid, got))
    shape = f"q/k/v[{p},{v.num_heads},{v.head_dim}] wp={wp} valid={int(valid.sum())}"
    err = (got.float() - ref).abs().max().item()
    print(f"K8 window_attention {shape}: max_abs_err={err:.3e} rel_err={errs[0]:.3e} "
          f"rms_rel_err={errs[1]:.3e}; K1 control (roped twice, max/rms rel) "
          f"{control_errs[0]:.3e}/{control_errs[1]:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not rel_within(errs):
        raise AssertionError(f"K8 disagrees with its plain version: {errs}")
    if rel_within(control_errs):
        raise AssertionError("K8: the check cannot tell roped from twice-roped q and k")
    return {"name": "window_attention", "route": "cuda", "source": K1_SRC,
            "replaces": K8_REPLACES, "max_abs_err": err, "rel_err": errs[0],
            "rms_rel_err": errs[1], "control_rms_rel_err": control_errs[1], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "shape": shape}


def check_window_edges(gen):
    """K1 and K8 against their plain versions, within KERNEL_ATOL, on windows
    the ViT batch does not hold: a fully valid window, a window with one
    valid key, a random half, and trailing pad windows (no valid key: each
    row attends to itself), at the 7B's head dim (80, wp=64) and at the
    tiny config's (8, wp=16, 4 heads)."""
    import torch

    from glimpseprune_torch.ops.cuda.window_attention import (
        plan_window,
        window_attention,
        window_attention_fused,
        window_attention_fused_reference,
        window_attention_reference,
    )

    report = {}
    for name, heads, dim, wp in (("7b", 16, 80, 64), ("tiny", 4, 8, 16)):
        n_win = 6
        valid = torch.zeros((n_win, wp), dtype=torch.bool, device="cuda")
        valid[0] = True
        valid[1, 5 % wp] = True
        valid[2] = torch.rand((wp,), generator=gen, device="cuda") < 0.5
        valid = valid.reshape(-1)  # windows 3-5: trailing pads
        p = n_win * wp
        qkv = torch.randn((p, 3, heads, dim), generator=gen, device="cuda").bfloat16()
        theta = torch.rand((p, dim), generator=gen, device="cuda") * 6.3
        cos, sin = theta.cos().bfloat16(), theta.sin().bfloat16()
        q, k, v = (torch.randn((p, heads, dim), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        got1 = window_attention_fused(qkv, cos, sin, valid, wp)
        got8 = window_attention(q, k, v, valid, wp)
        torch.cuda.synchronize()
        ref1 = window_attention_fused_reference(qkv.float(), cos.float(), sin.float(), valid, wp)
        ref8 = window_attention_reference(q.float(), k.float(), v.float(), valid, wp)
        errs = {"K1": (got1.float() - ref1).abs().max().item(),
                "K8": (got8.float() - ref8).abs().max().item()}
        # a pad window's row attends to itself only: its output is its v row
        pad_rows = slice(3 * wp, p)
        errs["K8_pad_rows_equal_v"] = torch.equal(got8[pad_rows], v[pad_rows])
        report[name] = {"shape": f"P={p} H={heads} D={dim} wp={wp}",
                        "plan": plan_window(dim, wp, heads, True).__dict__, **errs}
        if not (errs["K1"] <= KERNEL_ATOL and errs["K8"] <= KERNEL_ATOL
                and errs["K8_pad_rows_equal_v"]):
            raise AssertionError(f"K1/K8 edge cases ({name}) disagree with their plain "
                                 f"versions: {report[name]}")
    print("K1/K8 edge cases (one-key window, trailing pad windows, tiny dims), max abs err: "
          + json.dumps(report))
    return report


def attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal):
    """Random bf16 q, k, v as [B, H, S, D] views of [B, S, H, D] buffers
    (as the model passes them), the allowed-pair count and SDPA's mask."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import allowed_mask

    def rand(h, d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)

    q, k, v = rand(hq, d_qk), rand(hkv, d_qk), rand(hkv, d_v)
    dense = segs is None
    allowed = allowed_mask(segs, segs, b, s, s, causal, dense, "cuda")
    mask = None if dense else allowed[:, None]
    return q, k, v, int(allowed.sum()), mask


def sdpa(q, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=q.shape[1] != k.shape[1])


def control_attention(q, k, v, allowed, round_p: bool = False, drop_keys: int = 0):
    """A wrong plain version that the relative check must refuse: fp32
    softmax attention with each probability rounded to 4 significant bits
    (round_p: fp8 e4m3's mantissa, without its range), or without keys
    [0, drop_keys) (a dropped k tile). q [B, Hq, Sq, D]; k, v [B, Hkv, Skv,
    D]; allowed [B, 1, Sq, Skv] bool, or None for every key; a row with no
    allowed key gives 0."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import NEG_INF

    g = q.shape[1] // k.shape[1]
    kf, vf = k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    scores = q.float() @ kf.transpose(-1, -2) * q.shape[-1] ** -0.5
    if allowed is None:
        allowed = torch.ones((1, 1) + scores.shape[2:], dtype=torch.bool, device=q.device)
    if drop_keys:
        allowed = allowed.clone()
        allowed[..., :drop_keys] = False
    p = torch.softmax(scores.masked_fill(~allowed, NEG_INF), -1)
    del scores
    if round_p:
        mant, exp = torch.frexp(p)
        p = torch.ldexp(torch.round(mant * 16) / 16, exp)
    return (p @ vf).masked_fill(~allowed.any(-1, keepdim=True), 0.0)


def seg_ids(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")


def llm_fuser_cases(cfg, prep, tag=""):
    """K2's LLM causal and fuser call sites on a prepared batch:
    flash_cases entries."""
    t, gp = cfg.text, cfg.gp
    n_fuse = len(gp.selected_visual_layers)
    dqk = (gp.attn_fuse_size + (gp.visual_cond_size if n_fuse else 0)) // gp.attn_fuse_num_heads
    dv = gp.attn_fuse_size // gp.attn_fuse_num_heads
    return [
        (tag + "llm_causal", prep.valid.shape[0], t.num_attention_heads,
         t.num_key_value_heads, prep.valid.shape[1], t.head_dim, t.head_dim,
         seg_ids(np.where(prep.valid, 0, -1)), True),
        (tag + "fuser", prep.fuser.segment_ids.shape[0], gp.attn_fuse_num_heads,
         gp.attn_fuse_num_heads, prep.fuser.segment_ids.shape[1], dqk, dv,
         seg_ids(prep.fuser.segment_ids), False),
    ]


def check_flash_attention(cfg, prep_a, prep_b, gen):
    """K2 at its four serving call sites."""
    v = cfg.vision
    return flash_cases([
        # (name, B, Hq, Hkv, S, Dqk, Dv, segment ids or None, causal)
        ("vit_dense", 1, v.num_heads, v.num_heads, prep_b.patches.shape[0], v.head_dim,
         v.head_dim, None, False),
        ("vit_segmented", 1, v.num_heads, v.num_heads, prep_a.patches.shape[0], v.head_dim,
         v.head_dim, seg_ids(prep_a.full_seg[None]), False),
    ] + llm_fuser_cases(cfg, prep_a), gen)


def flash_cases(cases, gen):
    """K2 on each case against its plain version, within KERNEL_ATOL and
    relative to the output's size, with the two controls that must fail;
    its event and device ms beside the plain version's and SDPA's -> kernel
    rows."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_reference,
        flavour,
    )

    rows = []
    for name, b, hq, hkv, s, d_qk, d_v, segs, causal in cases:
        q, k, vv, pairs, mask = attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal)
        dense = segs is None
        got = flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q.float(), k.float(), vv.float(), segs, segs,
                                        causal=causal, dense=dense)
        err = (got.float() - ref).abs().max().item()
        errs = rel_errors(got, ref)
        control_errs = {
            "p_4_bits": rel_errors(got, control_attention(q, k, vv, mask, round_p=True)),
            "k_tile_0_dropped": rel_errors(got, control_attention(q, k, vv, mask, drop_keys=64))}
        ms = cuda_ms(lambda: flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, vv, segs, segs,
                                                             causal=causal, dense=dense))
        lib_ms = cuda_ms(lambda: sdpa(q, k, vv, mask))
        dev_ms = device_ms(lambda: flash_attention(q, k, vv, segs, segs, causal=causal,
                                                   dense=dense))
        lib_dev_ms = device_ms(lambda: sdpa(q, k, vv, mask))
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, vv, got) + (0 if dense else 2 * segs.nbytes))
        fl = flavour(causal, dense, d_qk, d_v)
        shape = f"{name} q[{b},{hq},{s},{d_qk}] kv[{b},{hkv},{s},{d_qk}/{d_v}]"
        print(f"K2 flash_attention[{fl}] {shape}: max_abs_err={err:.3e} "
              f"rel_err={errs[0]:.3e} rms_rel_err={errs[1]:.3e}; controls (max/rms rel) "
              + ", ".join(f"{c} {e[0]:.3e}/{e[1]:.3e}" for c, e in control_errs.items())
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        if not (err <= KERNEL_ATOL and rel_within(errs)):
            raise AssertionError(f"K2 {name} disagrees with its plain version: {err}, {errs}")
        passed = [c for c, e in control_errs.items() if rel_within(e)]
        if passed:
            raise AssertionError(f"K2 {name}: the check cannot tell the kernel from {passed}")
        rows.append({"name": f"flash_attention[{fl}]", "route": "cuda", "source": K2_SRC,
                     "replaces": K2_REPLACES, "max_abs_err": err, "rel_err": errs[0],
                     "rms_rel_err": errs[1],
                     "control_rms_rel_err": min(e[1] for e in control_errs.values()), "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms, "shape": shape})
    return rows


def check_flash_edges(gen):
    """K2, K2-lse and K3 against their plain versions on shapes the main
    path does not reach: Sq and Skv that are no multiple of a tile, the tiny
    config's head dims (8, 16, 8/4), GQA group 7 with left-padded rows and
    a q tile that is all padding, and rows with no allowed key (output
    exactly 0, LSE exactly -1e30). K2 and K2-lse must agree bit for bit.
    K3 runs on K2-lse's output and LSE (check_backward's limits, no
    controls); its dq is exactly 0 on rows with no allowed key (pad rows
    among them), its dk and dv exactly 0 for keys that no query sees."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        NEG_INF,
        allowed_mask,
        flash_attention,
        flash_attention_lse,
        flash_attention_lse_reference,
        plan_flash,
    )

    def seg(rows):
        return torch.as_tensor(np.asarray(rows), dtype=torch.int32, device="cuda")

    def left_padded(pads, s):
        return seg([[-1] * n + [0] * (s - n) for n in pads])

    two = seg([[0] * 150 + [1] * 120 + [-1] * 63])
    cases = [
        # (name, B, Hq, Hkv, Sq, Skv, Dqk, Dv, q segment ids, kv segment ids, causal)
        ("ragged_dense", 2, 4, 2, 130, 197, 80, 80, None, None, False),
        ("ragged_segmented_trailing_pad", 1, 4, 4, 333, 333, 80, 80, two, two, False),
        ("tiny_vit", 1, 4, 4, 100, 100, 8, 8, seg([[0] * 60 + [1] * 40]),
         seg([[0] * 60 + [1] * 40]), False),
        ("tiny_llm", 2, 4, 2, 23, 23, 16, 16, left_padded((5, 0), 23),
         left_padded((5, 0), 23), True),
        ("tiny_fuser", 2, 4, 4, 37, 37, 8, 4, seg([[0] * 20 + [1] * 10 + [-1] * 7, [0] * 37]),
         seg([[0] * 20 + [1] * 10 + [-1] * 7, [0] * 37]), False),
        ("gqa7_left_padded", 2, 28, 4, 300, 300, 128, 128, left_padded((150, 37), 300),
         left_padded((150, 37), 300), True),
        ("no_allowed_key", 1, 4, 4, 96, 160, 64, 64, seg([[0] * 40 + [7] * 30 + [1] * 26]),
         seg([[0] * 100 + [1] * 60]), False),
        ("dqk_ne_dv_ragged", 1, 2, 2, 77, 77, 192, 64, seg([[0] * 50 + [1] * 27]),
         seg([[0] * 50 + [1] * 27]), False),
    ]
    report = {}
    for name, b, hq, hkv, sq, skv, d_qk, d_v, qseg, kseg, causal in cases:
        dense = qseg is None

        def rand(s, h, d):
            x = torch.randn((b, s, h, d), generator=gen, device="cuda")
            return x.bfloat16().transpose(1, 2)

        q, k, v = rand(sq, hq, d_qk), rand(skv, hkv, d_qk), rand(skv, hkv, d_v)
        out = flash_attention(q, k, v, qseg, kseg, causal=causal, dense=dense)
        out_l, lse = flash_attention_lse(q, k, v, qseg, kseg, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(), qseg, kseg,
                                                     causal=causal, dense=dense)
        seen = ref_lse > -1e29
        r = {"err": (out.float() - ref).abs().max().item(),
             "lse_rel_err": rel_err(lse, ref_lse, seen) if seen.any() else 0.0,
             "rows_without_key": int((~seen).sum()),
             "their_output_zero": bool((out_l[~seen] == 0).all()),
             "their_lse_-1e30": bool((lse[~seen] == NEG_INF).all()),
             "k2_equals_k2_lse": torch.equal(out, out_l),
             "plan": plan_flash(d_qk, d_v, skv).__dict__}
        report[name] = r
        if not (r["err"] <= KERNEL_ATOL and r["lse_rel_err"] <= LSE_RTOL
                and r["their_output_zero"] and r["their_lse_-1e30"] and r["k2_equals_k2_lse"]
                and torch.equal(lse <= -1e29, ~seen)):
            raise AssertionError(f"K2 edge case {name} fails: {r}")
        dout = rand(sq, hq, d_v)
        bwd = check_backward(f"K3 edge case {name}", q, k, v, qseg, kseg, out_l, lse, dout,
                             causal, dense, with_controls=False)
        dq, dk, dv = bwd.pop("grads")
        unseen_keys = ~allowed_mask(qseg, kseg, b, sq, skv, causal, dense, "cuda").any(1)
        bwd["dq_zero_on_rows_without_key"] = bool((dq[~seen] == 0).all())
        bwd["keys_no_query_sees"] = int(unseen_keys.sum())
        bwd["dk_dv_zero_there"] = bool((dk.transpose(1, 2)[unseen_keys] == 0).all()
                                       and (dv.transpose(1, 2)[unseen_keys] == 0).all())
        r["backward"] = bwd
        if not (bwd["dq_zero_on_rows_without_key"] and bwd["dk_dv_zero_there"]):
            raise AssertionError(f"K3 edge case {name}: no exact zeros where due: {bwd}")
    print("K2/K2-lse/K3 edge cases against the plain version: " + json.dumps(report))
    return report


def rel_err(got, ref, rows=None) -> float:
    """max |got - ref| / max |ref|, over the selected rows."""
    g, r = got.float(), ref.float()
    if rows is not None:
        g, r = g[rows], r[rows]
    return ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()


def control_backward(q, k, v, qseg, kseg, out, lse, dout, causal, dense, q_positions=None,
                     round_ds: bool = False, drop_keys: int = 0):
    """A wrong plain backward that the relative check must refuse: the fp32
    backward with dS rounded to 4 significant bits (round_ds), or without
    keys [0, drop_keys) (a dropped k tile, the LSE kept). Same arguments and
    result as flash_attention_backward_reference."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import LOG2E, NEG_INF, allowed_mask

    b, hq, sq, dqk = q.shape
    hkv, skv, dv = v.shape[1], v.shape[2], v.shape[3]
    g = hq // hkv
    qf, kf, vf = q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    allowed = allowed_mask(qseg, kseg, b, sq, skv, causal, dense, q.device, q_positions)[:, None]
    allowed = allowed & (lse > NEG_INF / 2)[..., None]
    if drop_keys:
        allowed[..., :drop_keys] = False
    p = torch.exp2(qf @ kf.transpose(-1, -2) * (LOG2E / dqk ** 0.5) - lse[..., None])
    p = p.masked_fill(~allowed, 0.0)
    del allowed
    dof = dout.float()
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * out.float()).sum(-1)[..., None])
    if round_ds:
        mant, exp = torch.frexp(ds)
        ds = torch.ldexp(torch.round(mant * 16) / 16, exp)
    dq = ds @ kf / dqk ** 0.5
    dk = (ds.transpose(-1, -2) @ qf / dqk ** 0.5).reshape(b, hkv, g, skv, dqk).sum(2)
    dvv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, g, skv, dv).sum(2)
    return dq, dk, dvv


def check_backward(name, q, k, v, qseg, kseg, out, lse, dout, causal, dense, q_positions=None,
                   with_controls: bool = True):
    """K3 (K9's backward with q_positions) against its plain version on one
    input: each of dq, dk, dv within GRAD_RTOL of max |ref| and within the
    relative limits K7_MAX_RTOL / K7_RMS_RTOL (rel_errors); with_controls,
    two controls (dS in 4 bits, key tile 0 dropped) must miss both limits
    on the gradients they change; a second call gives bit-identical dq, dk,
    dv.
    -> the errors (and, under "grads", the kernel's gradients); raises on a
    failure."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
    )

    def call():
        return flash_attention_backward(q, k, v, qseg, kseg, out, lse, dout, causal=causal,
                                        dense=dense, q_positions=q_positions)

    grads, again = call(), call()
    torch.cuda.synchronize()
    args = (q.float(), k.float(), v.float(), qseg, kseg, out.float(), lse, dout.float(),
            causal, dense, q_positions)
    refs = flash_attention_backward_reference(*args)
    rel = [rel_err(g, r) for g, r in zip(grads, refs)]
    errs = [rel_errors(g, r) for g, r in zip(grads, refs)]
    abs_err = max((g.float() - r).abs().max().item() for g, r in zip(grads, refs))
    del refs
    controls = {}
    for control, kw in ((("ds_4_bits", dict(round_ds=True)),
                         ("k_tile_0_dropped", dict(drop_keys=64))) if with_controls else ()):
        ctrl = control_backward(*args, **kw)
        e = [rel_errors(g, c) for g, c in zip(grads, ctrl)]
        del ctrl
        controls[control] = (max(x[0] for x in e), max(x[1] for x in e))
    r = {"max_abs_err": abs_err, "rel_err": max(rel), "rel_err_dq_dk_dv": rel,
         "k7_errs_dq_dk_dv": errs, "controls": controls,
         "deterministic": all(torch.equal(a, b) for a, b in zip(grads, again))}
    if not (max(rel) <= GRAD_RTOL and all(rel_within(e) for e in errs)):
        raise AssertionError(f"{name} disagrees with its plain version: {r}")
    passed = [c for c, e in controls.items() if e[0] <= K7_MAX_RTOL or e[1] <= K7_RMS_RTOL]
    if passed:
        raise AssertionError(f"{name}: the check cannot tell the kernel from {passed}: {r}")
    if not r["deterministic"]:
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    r["grads"] = grads
    return r


def bwd_summary(r) -> str:
    """One line of check_backward's errors."""
    return ("rel_err dq/dk/dv " + "/".join(f"{e:.2e}" for e in r["rel_err_dq_dk_dv"])
            + ", max/rms rel " + ", ".join(f"{e[0]:.2e}/{e[1]:.2e}" for e in r["k7_errs_dq_dk_dv"])
            + "; controls (max/rms rel) "
            + ", ".join(f"{c} {e[0]:.2e}/{e[1]:.2e}" for c, e in r["controls"].items())
            + f"; deterministic {r['deterministic']}")


def sdpa_backward_ms(q, k, v, mask, dout):
    """(event ms, device ms) of SDPA's autograd backward with the same
    boolean mask: the yardstick of K3 and K9's backward."""
    import torch

    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qr, kr, vr, mask)

    def call():
        return torch.autograd.grad(lib_out, (qr, kr, vr), dout, retain_graph=True)

    return cuda_ms(call), device_ms(call)


def check_flash_training(cfg, batch, gen):
    """K2-lse and K3 at the training batch's LLM causal GQA and fuser
    shapes (the flavours the training path launches), and a small dense
    case; -> (rows for the kernels line, the dense case's errors)."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flavour,
    )

    t, gp = cfg.text, cfg.gp
    dqk = (gp.attn_fuse_size + gp.visual_cond_size) // gp.attn_fuse_num_heads
    dv = gp.attn_fuse_size // gp.attn_fuse_num_heads
    valid, fseg = batch["valid"], batch["fuser_segment_ids"].int()
    b, s = valid.shape
    cases = [
        ("llm_causal", b, t.num_attention_heads, t.num_key_value_heads, s, t.head_dim,
         t.head_dim, torch.where(valid, 0, -1).int(), True),
        ("fuser", b, gp.attn_fuse_num_heads, gp.attn_fuse_num_heads, fseg.shape[1], dqk, dv,
         fseg, False),
        ("small_dense", 1, 4, 2, 256, 64, 64, None, False),
    ]
    rows, dense_check = [], {}
    for name, b, hq, hkv, s, d_qk, d_v, segs, causal in cases:
        dense = segs is None
        q, k, v, pairs, mask = attention_case(gen, b, hq, hkv, s, d_qk, d_v, segs, causal)
        fl = flavour(causal, dense, d_qk, d_v)
        shape = f"{name} q[{b},{hq},{s},{d_qk}] kv[{b},{hkv},{s},{d_qk}/{d_v}]"
        seg_bytes = 0 if dense else 2 * segs.nbytes
        # K2-lse: output and LSE against the plain fp32 version
        out, lse = flash_attention_lse(q, k, v, segs, segs, causal=causal, dense=dense)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(), segs,
                                                         segs, causal=causal, dense=dense)
        seen = ref_lse > -1e29
        out_err = (out.float() - ref_out).abs().max().item()
        lse_err = rel_err(lse, ref_lse, seen)
        if not (out_err <= KERNEL_ATOL and lse_err <= LSE_RTOL
                and torch.equal(lse <= -1e29, ~seen)):
            raise AssertionError(f"K2-lse {name} disagrees with its plain version: "
                                 f"out {out_err}, lse {lse_err}")
        ms = cuda_ms(lambda: flash_attention_lse(q, k, v, segs, segs, causal=causal,
                                                 dense=dense))
        plain_ms = cuda_ms(lambda: flash_attention_lse_reference(q, k, v, segs, segs,
                                                                 causal=causal, dense=dense))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, mask))
        dev_ms = device_ms(lambda: flash_attention_lse(q, k, v, segs, segs, causal=causal,
                                                       dense=dense))
        lib_dev_ms = device_ms(lambda: sdpa(q, k, v, mask))
        bound_ms, bound_by = bound(2.0 * pairs * hq * (d_qk + d_v),
                                   nbytes(q, k, v, out, lse) + seg_bytes)
        print(f"K2-lse flash_attention_lse[{fl}] {shape}: max_abs_err={out_err:.3e} "
              f"lse_rel_err={lse_err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by})")
        lse_row = {"name": f"flash_attention_lse[{fl}]", "route": "cuda", "source": K2_SRC,
                   "replaces": K2_LSE_REPLACES, "max_abs_err": out_err, "lse_rel_err": lse_err,
                   "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms,
                   "library_device_ms": lib_dev_ms, "shape": shape}

        # K3: dq, dk, dv against the plain fp32 backward on the same
        # inputs (the kernel's own forward output and LSE), per gradient
        # within GRAD_RTOL and relative to its size, with controls that
        # must fail, and bit-identical from call to call
        dout = torch.randn(out.transpose(1, 2).shape, generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)
        bwd = check_backward(f"K3 {name}", q, k, v, segs, segs, out, lse, dout, causal, dense)
        grads = bwd.pop("grads")

        def call():
            return flash_attention_backward(q, k, v, segs, segs, out, lse, dout, causal=causal,
                                            dense=dense)

        ms = cuda_ms(call)
        # the dkv chunks and fp32 workspace of the launches just timed
        split = dict(flash_attention_backward.last_split)
        dev_ms = device_ms(call)
        plain_ms = cuda_ms(lambda: flash_attention_backward_reference(
            q, k, v, segs, segs, out, lse, dout, causal=causal, dense=dense))
        lib_ms, lib_dev_ms = sdpa_backward_ms(q, k, v, mask, dout)
        bound_ms, bound_by = bound(2.0 * pairs * hq * (3 * d_qk + 2 * d_v),
                                   nbytes(q, k, v, out, lse, dout, *grads) + seg_bytes)
        print(f"K3 flash_attention_backward[{fl}] {shape}: {bwd_summary(bwd)}; kernel {ms:.4f} ms "
              f"(card {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms "
              f"(card {fmt_ms(lib_dev_ms)}), bound {bound_ms:.4f} ms ({bound_by}); dkv split "
              f"{split['splits']}x ({split['workspace_bytes']} bytes of workspace)")
        bwd_row = {"name": f"flash_attention_backward[{fl}]", "route": "cuda",
                   "source": K3_SRC, "replaces": K3_REPLACES, **bwd, **split, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms,
                   "library_device_ms": lib_dev_ms, "shape": shape}
        if dense:  # not on the training path: checked, not listed
            dense_check = {"lse_rel_err": lse_err, **bwd, "lse_ms": lse_row["ms"],
                           "lse_device_ms": lse_row["device_ms"], "bwd_ms": ms,
                           "bwd_device_ms": dev_ms}
        else:
            rows += [lse_row, bwd_row]
    return rows, dense_check


def make_prompts(cfg, rng, n_rows, lo, hi, text_len=(20, 9)):
    """Random prompt ids in [lo, hi) with one image marker per row."""
    prompts = []
    for b in range(n_rows):
        prompts.append(
            [int(x) for x in rng.integers(lo, hi, 12)]
            + [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
            + [int(x) for x in rng.integers(lo, hi, text_len[b % len(text_len)])])
    return prompts


def timed_ms(fn):
    """(CUDA-event milliseconds of one call, its result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_outputs(cfg, prep, pre, res, do_selection, n_new=None):
    """Shapes, finiteness and the keep policy's bounds on one generate of
    n_new tokens (MAX_NEW_TOKENS by default)."""
    import torch

    n_new = MAX_NEW_TOKENS if n_new is None else n_new
    b = prep.input_ids.shape[0]
    assert pre.logits.shape == (b, 1, cfg.text.vocab_size), pre.logits.shape
    assert torch.isfinite(pre.logits.float()).all(), "non-finite prefill logits"
    assert res.sequences.shape == (b, n_new), res.sequences.shape
    assert ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all()
    assert ((res.num_generated >= 0) & (res.num_generated <= n_new)).all()
    if not do_selection:
        assert res.keep_img is None
        return
    gp = cfg.gp
    keep, img_valid = res.keep_img, prep.img_valid
    assert not (keep & ~img_valid).any(), "kept a padding slot"
    n_valid = img_valid.sum(1)
    cap = (n_valid if gp.max_remain_ratio is None else
           np.floor(np.float32(gp.max_remain_ratio) * n_valid.astype(np.float32)))
    kept = keep.sum(1)
    assert (kept >= np.minimum(gp.min_remain_num, n_valid)).all(), kept
    assert (kept <= np.maximum(cap, gp.min_remain_num)).all(), (kept, cap)
    mask = pre.mask_logits.float()[:, torch.as_tensor(img_valid, device=pre.mask_logits.device)]
    assert torch.isfinite(mask).all(), "non-finite mask logits"
    le = gp.le_length if gp.has_le else 0
    n_text = prep.valid.sum(1) - prep.n_img_tokens - le
    assert (pre.valid.sum(1).cpu().numpy() == n_text + kept).all(), "compaction lost tokens"


def reset_launches():

    from glimpseprune_torch.ops.cuda.flash_attention import (
        FLAVOURS,
        INT8_FLAVOURS,
        flash_attention,
        flash_attention_backward,
        flash_attention_int8,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4, matmul_int4_prefill
    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
    )

    window_attention_fused.launches = 0
    window_attention.launches = 0
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward):
        fn.launches = dict.fromkeys(FLAVOURS, 0)
    flash_attention_int8.launches = dict.fromkeys(INT8_FLAVOURS, 0)
    matmul_int4.launches = Counter()
    matmul_int4_prefill.launches = Counter()


def read_launches(required):
    """{row name: launches} since reset_launches(); raises if a kernel that
    the path must run was never launched. An entry of ``required`` that
    ends in "*]" asks for any launch of the rows it starts."""
    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_int8,
        flash_attention_lse,
    )
    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4, matmul_int4_prefill
    from glimpseprune_torch.ops.cuda.window_attention import (
        window_attention,
        window_attention_fused,
    )

    launches = {"window_attention_fused": window_attention_fused.launches,
                "window_attention": window_attention.launches}
    for fn in (flash_attention, flash_attention_lse, flash_attention_backward,
               flash_attention_int8, matmul_int4, matmul_int4_prefill):
        launches.update({f"{fn.__name__}[{k}]": v for k, v in fn.launches.items()})

    def count(name):
        if name.endswith("*]"):
            return sum(v for k, v in launches.items() if k.startswith(name[:-2]))
        return launches.get(name, 0)

    missing = [k for k in required if count(k) == 0]
    if missing:
        raise AssertionError(f"the path never launched {missing}")
    return launches


QWEN_SERVE_KERNELS = ["window_attention_fused"] + [
    f"flash_attention[{k}]" for k in ("causal", "dense", "dqk_ne_dv", "segmented")]


def run_main_path(cfg, model, cases, required=QWEN_SERVE_KERNELS, tag="main path"):
    """Pruned and unpruned generate on each prepared batch, every decode
    chunk's replays under sync_checked; returns per-run timings and the
    kernels' launch counts, which must include ``required``."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    runner = GlimpsePruneRunner(cfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for do_sel in (True, False):
            mode = "pruned" if do_sel else "unpruned"
            # warm-up, which captures the decode step that the timed runs replay
            runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
            torch.cuda.reset_peak_memory_stats()
            prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
            decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                MAX_NEW_TOKENS, cfg.eos_token_id))
            generate_ms, res = timed_ms(lambda: runner.generate(
                prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel))
            peak = torch.cuda.max_memory_allocated()
            check_outputs(cfg, prep, pre, res, do_sel)
            run = {"batch": name, "mode": mode, "B": int(prep.input_ids.shape[0]),
                   "S": int(prep.input_ids.shape[1]), "patches": int(prep.patches.shape[0]),
                   "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS,
                   "generate_ms": generate_ms, "peak_mem_gib": peak / 2**30,
                   "kv_len": int(pre.valid.shape[1])}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
                run["prune_ratio"] = [float(x) for x in res.prune_ratio]
            print(f"{tag} " + json.dumps(run))
            runs.append(run)
    torch.cuda.synchronize()
    launches = read_launches(required)
    print(f"{tag} launches " + json.dumps(launches))
    return runs, launches


def check_small_reference(sp_group=None):
    """The tiny config on the card (bf16, the kernels) against the same
    weights on the CPU (fp32, the plain versions, which the CPU tests hold
    equal to the JAX package): first logits of the unpruned prefill and mask
    logits of the pruned one, relative to their largest magnitude. The bound
    catches a wrong path; bf16 rounding through the tiny model stays far
    below it. With ``sp_group`` the card runs under sequence parallelism
    over it (the patches padded to 64 so that the ViT's windows divide over
    2 ranks), the CPU unsharded."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import sequence_parallel

    cfg = tiny_test_config()
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16 if sp_group is None else 64)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    def sharded():
        return contextlib.nullcontext() if sp_group is None else sequence_parallel(sp_group)

    errs = {}
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        with sharded():
            got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        if do_sel:
            img_valid = torch.as_tensor(prep.img_valid)
            ref, got = ref[:, img_valid], got[:, img_valid]
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    with sharded():
        errs["decode_logits"] = small_decode_err(ref_run, got_run, prep)
    tag = "" if sp_group is None else f" under SP over {SP_WORLD} ranks"
    print(f"tiny config{tag}, card bf16 vs CPU fp32, max error / max |ref|: "
          + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card disagrees with the CPU reference: {bad}")
    return errs


def small_decode_err(ref_run, got_run, prep, n: int = 8) -> float:
    """The tiny config's decode after the unpruned prefill: n steps on the
    card, each a replay of the runner's captured step, against the CPU's
    model fed the card's tokens (``decode_step`` with all n at once, causal
    among themselves): every step's logits, max error over max |ref|."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import StepGraph

    got_pre, ref_pre = got_run.prefill(prep, False), ref_run.prefill(prep, False)
    b, r = got_pre.valid.shape
    t = r + n
    steps = got_run.decode_steps(got_pre.logits, got_pre.valid, got_pre.position_ids,
                                 got_pre.kv_k, got_pre.kv_v, t, -1)
    if not isinstance(steps, StepGraph):
        raise AssertionError("the card's decode did not run a captured step")
    got = []
    for _ in range(n):
        steps.run(1)
        got.append(steps.logits.float().cpu())
    toks = steps.state.toks[:, :n].cpu()
    with torch.inference_mode():
        kv_valid = torch.cat([ref_pre.valid, torch.ones((b, n), dtype=torch.bool)], 1)
        pos = ref_pre.position_ids[:, :, -1:] + 1 + torch.arange(n)
        ref = ref_run.model.decode_step(toks, pos, ref_run.decode_cache(ref_pre.kv_k, t),
                                        ref_run.decode_cache(ref_pre.kv_v, t), kv_valid, r)[0]
    return ((torch.stack(got, 1) - ref).abs().max() / ref.abs().max()).item()


@contextlib.contextmanager
def sync_checked():
    """Every ``StepGraph.run`` (a chunk's replays with their noise draws)
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside a
    chunk raises; the chunk-end reads stay outside."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl import decode_graph

    run = decode_graph.StepGraph.run

    def checked(self, n, rng=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, n, rng)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    decode_graph.StepGraph.run = checked
    try:
        yield
    finally:
        decode_graph.StepGraph.run = run


@contextlib.contextmanager
def captures():
    """A list that receives the ``capture_s`` of every StepGraph captured
    while open."""
    from glimpseprune_torch.models.qwen2_5_vl import decode_graph

    init = decode_graph.StepGraph.__init__
    caught = []

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        caught.append(self.capture_s)

    decode_graph.StepGraph.__init__ = recording
    try:
        yield caught
    finally:
        decode_graph.StepGraph.__init__ = init


def idle_share(fn):
    """(the card's idle share while ``fn`` runs, kernels traced) from
    torch.profiler: 1 - the union of the device's kernel and copy intervals
    over the span from the first one's start to the last one's end; None
    where the trace holds no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.elapsed_us() > 0)
    if not spans:
        return None, 0
    busy, end = 0, spans[0][0]
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return 1.0 - busy / max(end - spans[0][0], 1), len(spans)


def eager_steps(cfg, runner, pre, t: int, n: int):
    """The decode step run eagerly on the card from a prefill, over a fresh
    cache of t slots, eos never met (for the comparison with the captured
    step only: no path of the port runs it so on the card)."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import EagerSteps
    from glimpseprune_torch.models.qwen2_5_vl.gp_model import DecodeState

    b, r = pre.valid.shape
    kv_valid = torch.cat([pre.valid, torch.zeros((b, t - r), dtype=torch.bool,
                                                 device=pre.valid.device)], 1)
    st = DecodeState.alloc(runner.decode_cache(pre.kv_k, t), runner.decode_cache(pre.kv_v, t),
                           n, cfg.text.vocab_size, False, kv_valid)
    st.begin(pre.logits[:, -1].argmax(-1), pre.position_ids[:, :, -1], r, -1)
    return EagerSteps(runner.model, st)


def check_captured_decode(cfg, runner, prep, do_sel, tier):
    """(a), (b), (c) and (e) on one prefill: DECODE_CHECK_TOKENS greedy steps
    (eos never met) replayed one at a time against the same step run
    eagerly on the card
    (equal tokens, or at the first difference logits within
    DECODE_LOGIT_RTOL of max |logit| and a top-2 margin below it); then the
    runner's decode of the prefill (warm graph, eos never met), timed, with
    every chunk's replays under sync_checked, its launches (in (q4) K4's
    7 per layer + the head per token, and nothing else), against the eager
    steps timed; on the pruned prefill, the sampled decode checks
    (check_sampled_decode). -> record."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import StepGraph

    n = DECODE_CHECK_TOKENS
    pre = runner.prefill(prep, do_sel)
    args = (pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v)
    t = pre.valid.shape[1] + n
    graph = runner.decode_steps(*args, t, -1)
    if not isinstance(graph, StepGraph):
        raise AssertionError("the card's decode did not run a captured step")
    eager = eager_steps(cfg, runner, pre, t, n)
    logits = {"captured": [], "eager": []}
    for _ in range(n):
        with sync_checked():
            graph.run(1)
        eager.run(1)
        logits["captured"].append(graph.logits.float().clone())
        logits["eager"].append(eager.logits.float().clone())

    def tokens(steps):
        return torch.cat([steps.state.toks[:, :n], steps.state.tok[:, None]], 1).cpu().numpy()

    got, want = tokens(graph), tokens(eager)
    differ = np.nonzero((got != want).any(0))[0]
    rec = {"tier": tier, "batch": "a", "mode": "pruned" if do_sel else "unpruned",
           "tokens_equal": not len(differ), "capture_ms": graph.capture_s * 1e3}
    if len(differ):  # token j comes from step j - 1's logits
        j = int(differ[0])
        g, e = logits["captured"][j - 1], logits["eager"][j - 1]
        scale = e.abs().max()
        rows = torch.as_tensor(got[:, j] != want[:, j], device=e.device)
        margin = max(((x[rows].topk(2, -1).values @ torch.tensor([1.0, -1.0], device=e.device))
                      .max() / scale).item() for x in (g, e))
        rec.update(first_difference=j, logits_rel_err=((g - e).abs().max() / scale).item(),
                   top2_margin_rel=margin)
        if not (rec["logits_rel_err"] <= DECODE_LOGIT_RTOL and margin < DECODE_LOGIT_RTOL):
            raise AssertionError(f"captured decode {tier} {rec['mode']} differs from the eager "
                                 f"steps without a near tie: {rec}")
    before = launch_counts()
    with sync_checked():
        ms, (seqs, _) = timed_ms(lambda: runner._decode_loop(*args, n, -1, chunk_size=n))
    launched = launches_since(before)
    if not (seqs == got[:, :n]).all():
        raise AssertionError(f"the runner's decode {tier} {rec['mode']} gave other tokens than "
                             "its step-wise replays")
    k4 = sum(v for k, v in launched.items() if k.startswith("matmul_int4["))
    if tier == "q4":
        want_k4 = n * (7 * cfg.text.num_hidden_layers + 1)
        if k4 != want_k4 or k4 != sum(launched.values()):
            raise AssertionError(f"(q4) decode of {n} tokens launched {launched}, not "
                                 f"{want_k4} K4 launches alone")
    elif launched:
        raise AssertionError(f"{tier} decode launched kernels {launched}")
    if do_sel:
        rec["sampled"] = check_sampled_decode(runner, pre, got, tier)
    eager = eager_steps(cfg, runner, pre, t, n)
    eager_ms, _ = timed_ms(lambda: eager.run(n))
    rec.update(captured_ms_per_token=ms / n, eager_ms_per_token=eager_ms / n,
               k4_launches_per_token=k4 / n)
    print("captured decode " + json.dumps(rec))
    return rec


def check_sampled_decode(runner, pre, greedy, tier):
    """Sampling through the captured step on one prefill, whose greedy
    tokens (the first and DECODE_CHECK_TOKENS more) are ``greedy`` [B, n+1]:
    the runner's decode at temperature 1, each chunk's replays under
    sync_checked, gives the same tokens for the same seed and other tokens
    for another seed; at SAMPLE_TINY_T, replayed one step at a time, every
    token's logit lies within SAMPLE_TIE_GAP of its step's top logit, and
    the tokens are the greedy ones up to the first difference, where both
    are such a tie. -> record."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import StepGraph

    n = DECODE_CHECK_TOKENS
    args = (pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v)

    def rng(seed):
        return torch.Generator(runner.device).manual_seed(seed)

    def sampled(seed):
        with sync_checked():
            return runner._decode_loop(*args, n, -1, temperature=1.0, rng=rng(seed),
                                       chunk_size=n)[0]

    first, again, other = sampled(SAMPLE_SEED), sampled(SAMPLE_SEED), sampled(SAMPLE_SEED + 1)
    if not (first == again).all() or (first == other).all():
        raise AssertionError(f"{tier} sampled decode: seed {SAMPLE_SEED} gave {first} then "
                             f"{again}, seed {SAMPLE_SEED + 1} {other}")
    gen = rng(SAMPLE_SEED)
    steps = runner.decode_steps(*args, pre.valid.shape[1] + n, -1, SAMPLE_TINY_T, gen)
    if not isinstance(steps, StepGraph):
        raise AssertionError("the card's sampled decode did not run a captured step")
    logits = [pre.logits[:, -1].float()]  # token j comes from logits[j]
    for _ in range(n):
        steps.run(1, gen)
        logits.append(steps.logits.float().clone())
    tiny = torch.cat([steps.state.toks[:, :n], steps.state.tok[:, None]], 1)
    lg = torch.stack(logits, 1)  # [B, n+1, V]
    gap = lg.max(-1).values - lg.gather(-1, tiny[..., None])[..., 0]
    differ = np.nonzero((tiny.cpu().numpy() != greedy).any(0))[0]
    rec = {"tier": tier, "seeded_equal": True, "other_seed_differs": True,
           "tiny_t_max_gap": gap.max().item(),
           "tiny_t_first_difference": int(differ[0]) if len(differ) else None}
    if rec["tiny_t_max_gap"] > SAMPLE_TIE_GAP:
        raise AssertionError(f"{tier} sampled decode at T={SAMPLE_TINY_T} drew a token "
                             f"{rec['tiny_t_max_gap']} under its step's top logit")
    if len(differ):
        j = int(differ[0])
        want = torch.as_tensor(greedy[:, j], device=lg.device)
        tie = (lg[:, j].max(-1).values - lg[:, j].gather(-1, want[:, None])[:, 0]).max().item()
        rec["tiny_t_greedy_gap"] = tie
        if tie > SAMPLE_TIE_GAP:
            raise AssertionError(f"{tier} sampled decode at T={SAMPLE_TINY_T} left the greedy "
                                 f"tokens at {j} without a tie: {rec}")
    print("sampled decode " + json.dumps(rec))
    return rec


def serving_decode(cfg, runner, rows, tier):
    """(d) as bench.py:563-628 serves: the B=1 pruned prefills of ``rows``
    (one out_len) filled by cache_fill_rows into one preallocated B=2 cache
    of R + SERVE_NEW_TOKENS slots, then ``_decode_loop(..., eos=-1,
    chunk_size=SERVE_NEW_TOKENS, prealloc_t=T)``: the capture's ms, ms per
    token (warm), peak memory, the card's idle share over
    IDLE_TRACE_TOKENS steps of the same graph, in (q4) K4's kernel records
    over IDLE_TRACE_TOKENS replays in a padded trace (device_ms_by_kernel)
    against the launches counted over as many (equal, and
    IDLE_TRACE_TOKENS * (7 * layers + 1)), and the tokens against
    the runner's own cache over the same prefill (equal). Then the cache
    is dropped, which nothing may keep alive, and a second decode into a
    newly allocated one (the bench allocates one a run), timed from cold:
    its tokens equal the first's; its capture ms (None where the new cache
    took the old one's address and layout, and the kept graph served it)
    and peak memory. -> record."""
    import dataclasses
    import gc
    import weakref

    import torch

    from glimpseprune_torch.ops.kv_cache import alloc_cache, cache_fill_rows, is_quantized

    n = SERVE_NEW_TOKENS
    r = max(p.out_len for p in rows)
    pres = [runner.prefill(dataclasses.replace(p, out_len=r)) for p in rows]
    logits, valid = (torch.cat([getattr(p, f) for p in pres]) for f in ("logits", "valid"))
    pos = torch.cat([p.position_ids for p in pres], 1)
    t = r + n
    shape = pres[0].kv_k.shape[:1] + (len(rows), t) + pres[0].kv_k.shape[3:]

    def new_caches():
        caches = [alloc_cache(shape, pres[0].kv_k.dtype, runner.device,
                              cfg.text.kv_cache_quant) for _ in range(2)]
        for i, p in enumerate(pres):
            cache_fill_rows(caches[0], p.kv_k, i)
            cache_fill_rows(caches[1], p.kv_v, i)
        return caches

    def decode(caches, new=n):
        return runner._decode_loop(logits, valid, pos, *caches, new, -1, chunk_size=new,
                                   prealloc_t=t)

    torch.cuda.reset_peak_memory_stats()
    caches = new_caches()
    capture_s = runner.decode_steps(logits, valid, pos, *caches, t, -1,
                                    prealloc=True).capture_s
    with sync_checked():
        ms, (seqs, _) = timed_ms(lambda: decode(caches))
    peak = torch.cuda.max_memory_allocated()
    idle, traced = idle_share(lambda: decode(caches, IDLE_TRACE_TOKENS))
    k4 = None
    if tier == "q4":  # IDLE_TRACE_TOKENS replays, as decodes of 2 tokens
        calls, per_call = IDLE_TRACE_TOKENS // 2, {}
        device_ms_by_kernel(lambda: decode(caches, 2), iters=calls, per_call=per_call)
        before = launch_counts()
        for _ in range(calls):
            decode(caches, 2)
        counted = sum(v for k, v in launches_since(before).items()
                      if k.startswith("matmul_int4["))
        k4 = {"replays": IDLE_TRACE_TOKENS, "counted": counted,
              "traced": calls * sum(c for name, c in per_call.items() if "decode_kernel" in name),
              "expected": IDLE_TRACE_TOKENS * (7 * cfg.text.num_hidden_layers + 1)}
        if not k4["traced"] == k4["counted"] == k4["expected"]:
            raise AssertionError(f"(q4) serving decode of {IDLE_TRACE_TOKENS} tokens: K4's "
                                 f"records in the trace, its counted launches and 7L + 1 a "
                                 f"token disagree: {k4}")
    kv = [torch.cat([getattr(p, f) for p in pres], 1) for f in ("kv_k", "kv_v")]
    own, _ = runner._decode_loop(logits, valid, pos, *kv, n, -1, chunk_size=n)
    if not (own == seqs).all():
        raise AssertionError(f"{tier} serving decode: the preallocated cache gave other "
                             "tokens than the runner's own")
    del kv, own
    refs = [weakref.ref(x) for c in caches for x in (c.values() if is_quantized(c) else [c])]
    del caches
    gc.collect()
    if any(ref() is not None for ref in refs):
        raise AssertionError(f"{tier} serving decode: the caller's cache outlived the decode")
    torch.cuda.reset_peak_memory_stats()
    with captures() as caught:
        caches = new_caches()
        with sync_checked():
            ms2, (seqs2, _) = timed_ms(lambda: decode(caches))
    peak2 = torch.cuda.max_memory_allocated()
    del caches
    if not (seqs2 == seqs).all():
        raise AssertionError(f"{tier} serving decode: a new cache gave other tokens")
    rec = {"tier": tier, "B": len(rows), "R": r, "T": t, "new_tokens": n,
           "capture_ms": capture_s * 1e3, "ms_per_token": ms / n, "peak_mem_gib": peak / 2**30,
           "idle_share": idle, "idle_trace_tokens": IDLE_TRACE_TOKENS,
           "device_records_traced": traced, "k4_records": k4,
           "second": {"capture_ms": caught[0] * 1e3 if caught else None,
                      "ms_per_token_with_capture": ms2 / n, "peak_mem_gib": peak2 / 2**30}}
    print("serving decode " + json.dumps(rec))
    return rec


def run_decode_checks(cfg, runner, prep_a, rows_a, tier):
    """Phases 6 and 9's decode: (a)-(c), (e) on batch (a) pruned and
    unpruned, and (d) on its rows."""
    import torch

    with torch.inference_mode():
        out = {"captured": [check_captured_decode(cfg, runner, prep_a, sel, tier)
                            for sel in (True, False)],
               "serving": serving_decode(cfg, runner, rows_a, tier)}

    torch.cuda.synchronize()
    return out


def one_row(pre):
    """(logits, valid, position_ids, kv_k, kv_v) of a B=1 prefill."""
    return tuple(pre[:5])


def stepwise_decode(runner, pre, n: int, t=None, prealloc: bool = False):
    """n greedy tokens (eos never met) of the runner's captured step over a
    B=1 prefill, replayed one step at a time: (tokens [n], logits), token j
    coming from logits[j] (the prefill's last logits, then each step's)."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import StepGraph

    logits, valid, pos, kv_k, kv_v = pre
    t = valid.shape[1] + n if t is None else t
    steps = runner.decode_steps(logits, valid, pos, kv_k, kv_v, t, -1, prealloc=prealloc)
    if not isinstance(steps, StepGraph):
        raise AssertionError("the card's decode did not run a captured step")
    lg = [logits[0, -1]]
    for _ in range(n - 1):
        steps.run(1)
        lg.append(steps.logits[0].clone())
    toks = torch.cat([steps.state.toks[0, :n - 1], steps.state.tok[:1]])
    return toks.cpu().numpy(), lg


def first_difference(name, got, want, got_logits, want_logits, rtol=DECODE_LOGIT_RTOL):
    """None where the token lists got and want [n] agree; else phase 6's
    tie rule at the first token j that differs (token j comes from
    logits[j]): the two runs' logits within rtol of max |logit| of each
    other and their top two closer than that, or raise. -> record."""
    differ = np.nonzero(got != want)[0]
    if not len(differ):
        return None
    j = int(differ[0])
    g, e = got_logits[j].float(), want_logits[j].float()
    scale = e.abs().max()
    margin = max(((x.topk(2).values[0] - x.topk(2).values[1]) / scale).item() for x in (g, e))
    rec = {"first_difference": j, "logits_rel_err": ((g - e).abs().max() / scale).item(),
           "top2_margin_rel": margin}
    if not (rec["logits_rel_err"] <= rtol and margin < rtol):
        raise AssertionError(f"{name}: the tokens differ without a near tie: {rec}")
    return rec


def steps_distance(got, want, got_logits, want_logits) -> float:
    """The largest rel_err of two greedy decodes' logits over the steps up
    to the first token that differs (every step where none does)."""
    differ = np.nonzero(got != want)[0]
    upto = int(differ[0]) if len(differ) else len(want) - 1
    return max(rel_err(got_logits[j], want_logits[j]) for j in range(upto + 1))


def cross_check(name, got, want, got_logits, want_logits):
    """Phase 12's comparison of two arithmetics of one greedy decode: the
    logits of every step up to the first token that differs within
    CROSS_LOGIT_RTOL of max |logit| of each other (steps_distance), and
    phase 6's tie rule at that bound where a token differs, or raise.
    -> record."""
    rec = {"logits_rel_dist": steps_distance(got, want, got_logits, want_logits),
           "tie": first_difference(name, got, want, got_logits, want_logits, CROSS_LOGIT_RTOL)}
    if rec["logits_rel_dist"] > CROSS_LOGIT_RTOL:
        raise AssertionError(f"{name}: logits past CROSS_LOGIT_RTOL: {rec}")
    return rec


@contextlib.contextmanager
def recorded(batcher):
    """While open, the batcher's admissions in order, each (slot, global
    step, its prefill's last logits), and every replay's logits [capacity,
    V], its decode chunks replayed one step at a time (each replay under
    sync_checked where that is open)."""
    from unittest import mock

    st, steps = batcher.state, batcher._steps
    admits, logits = [], []
    admit, run = st.admit, type(steps).run

    def admitting(slot, kv_k, kv_v, r_valid, r_logits, r_pos, gstep, *args):
        admits.append((slot, gstep, r_logits[0, -1]))
        return admit(slot, kv_k, kv_v, r_valid, r_logits, r_pos, gstep, *args)

    def stepping(n, rng=None):
        for _ in range(n):
            run(steps, 1, rng)
            logits.append(steps.logits.clone())

    with mock.patch.object(st, "admit", admitting), mock.patch.object(steps, "run", stepping):
        yield admits, logits


def request_logits(admits, logits, n: int):
    """Each recorded request's n logits (its prefill's last, then those of
    its row in the replays that followed its admission)."""
    return [[first] + [logits[g0 + j][slot] for j in range(n - 1)]
            for slot, g0, first in admits]


# phase 12's fault controls: each plants one admission fault that the
# batcher's comparison (steps_distance against the runner's own decode)
# must see past CROSS_LOGIT_RTOL
CONT_FAULTS = {
    "s-p": ("position", "stale_lane"),
    "s-u": ("position", "stale_lane", "pads_as_keys"),
}


@contextlib.contextmanager
def planted(batcher, fault: str):
    """One fault in the batcher's admissions while open: "position" admits
    each request as if one global step later (every decode position one
    behind), "stale_lane" leaves the kv_valid bits past R that other rows'
    steps set in the slot's lane, "pads_as_keys" runs the prefill chunks
    without new_valid (a left-padded row's pads attended as keys)."""
    from unittest import mock

    st, model = batcher.state, batcher.runner.model
    admit, chunk = st.admit, model.prefill_chunk

    def late(slot, kv_k, kv_v, r_valid, logits, r_pos, gstep, *rest):
        admit(slot, kv_k, kv_v, r_valid, logits, r_pos, gstep + 1, *rest)

    def stale(slot, kv_k, kv_v, r_valid, *rest):
        r = r_valid.shape[1]
        lane = st.kv_valid[slot, r:].clone()
        admit(slot, kv_k, kv_v, r_valid, *rest)
        st.kv_valid[slot, r:] |= lane

    def unmasked(*args):
        return chunk(*args[:6], None, *args[7:])

    target = {"position": (st, "admit", late), "stale_lane": (st, "admit", stale),
              "pads_as_keys": (model, "prefill_chunk", unmasked)}[fault]
    with mock.patch.object(*target):
        yield


@contextlib.contextmanager
def chunk_probe(model):
    """While open, every ``prefill_chunk`` call's CUDA-event ms and the
    launches it made, in a list of (ms, launches)."""
    import torch

    chunk = model.prefill_chunk
    calls = []

    def probed(*args, **kwargs):
        before = launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = chunk(*args, **kwargs)
        end.record()
        calls.append((start, end, {k: v - before.get(k, 0)
                                   for k, v in launch_counts().items() if v != before.get(k, 0)}))
        return out

    model.prefill_chunk = probed
    out = []
    try:
        yield out
    finally:
        del model.prefill_chunk
        torch.cuda.synchronize()
        out += [(s.elapsed_time(e), launched) for s, e, launched in calls]


def continuous_side(cfg, runner, name, thunks, refs, r, tier, required):
    """One side of the continuous-serving phase: a ContinuousBatcher
    (capacity CONT_CAPACITY, CONT_INTER steps a chunk, CONT_NEW_TOKENS
    tokens, eos never met, sized for len(thunks) requests) warmed on the
    first request's prefill (its one capture), a timed serve of the queue,
    every chunk's replays under sync_checked, whose launches are the
    side's (``required`` among them); then a second serve, one step at a
    time, that captures nothing and gives the same tokens; each request's
    tokens against ``refs[i]`` = (tokens, logits) of the runner's own decode
    over the same B=1 prefill (cross_check: the batcher decodes 2 rows);
    a serve with each of the side's CONT_FAULTS planted, its steps_distance
    from the references recorded (the largest over the requests); ms per
    step over one chunk (CUDA events), the card's idle share over one
    chunk; in (q4) K4's records in a trace of one chunk equal to its
    counted launches, CONT_INTER * (7 * layers + 1). -> record."""
    import torch

    from glimpseprune_torch.serving import ContinuousBatcher

    n, inter = CONT_NEW_TOKENS, CONT_INTER
    b = ContinuousBatcher(runner, capacity=CONT_CAPACITY, prefix_len=r, max_new_tokens=n,
                          inter_steps=inter, eos=-1, max_requests=len(thunks))
    first = thunks[0]()
    if not isinstance(first, tuple):  # a chunked admission's generator
        while True:
            try:
                next(first)
            except StopIteration as stop:
                first = stop.value
                break
    with captures() as caught:
        b.warm(first)
        del first
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with sync_checked():
            t0 = time.perf_counter()
            seqs, n_gen, ttft, completion = b.serve(thunks)
            serve_s = time.perf_counter() - t0
        launches = read_launches(required)
        peak = torch.cuda.max_memory_allocated()
        with sync_checked(), recorded(b) as (admits, logits):
            again = b.serve(thunks)
        got = request_logits(admits, logits, n)
        del logits
        controls = {}
        for fault in CONT_FAULTS[name]:
            with sync_checked(), planted(b, fault), recorded(b) as (f_admits, f_logits):
                f_seqs = b.serve(thunks)[0]
            controls[fault] = max(
                steps_distance(f_seqs[i], refs[i][0], lg, refs[i][1])
                for i, lg in enumerate(request_logits(f_admits, f_logits, n)))
            del f_logits
    if len(caught) != 1:
        raise AssertionError(f"continuous {tier} {name}: {len(caught)} captures, not one")
    if not (again[0] == seqs).all():
        raise AssertionError(f"continuous {tier} {name}: a second serve gave other tokens")
    checks = [cross_check(f"continuous {tier} {name} request {i}", seqs[i], refs[i][0], lg,
                          refs[i][1]) for i, lg in enumerate(got)]
    del got
    steps = b._steps
    with torch.inference_mode():
        chunk_ms = []
        for _ in range(3):
            b._begin()
            chunk_ms.append(timed_ms(lambda: steps.run(inter))[0])
        b._begin()
        idle, traced = idle_share(lambda: steps.run(inter))
        k4 = None
        if tier == "q4":
            def chunk():
                b._begin()
                steps.run(inter)

            per_call = {}  # a chunk launches ~18,000 kernels: 2 of them pad the trace
            device_ms_by_kernel(chunk, iters=2, per_call=per_call, pad_calls=2)
            before = launch_counts()
            chunk()
            torch.cuda.synchronize()
            counted = sum(v for k, v in launches_since(before).items()
                          if k.startswith("matmul_int4["))
            k4 = {"replays": inter, "counted": counted,
                  "traced": sum(c for k, c in per_call.items() if "decode_kernel" in k),
                  "expected": inter * (7 * cfg.text.num_hidden_layers + 1)}
            if not k4["traced"] == k4["counted"] == k4["expected"]:
                raise AssertionError(f"(q4) continuous {name}: K4's records in a chunk's "
                                     f"trace, its counted launches and 7L + 1 a step "
                                     f"disagree: {k4}")
    rec = {"tier": tier, "side": name, "capacity": CONT_CAPACITY, "R": r, "T": b.T,
           "inter_steps": inter, "new_tokens": n, "requests": len(thunks),
           "capture_ms": caught[0] * 1e3, "serve_s": serve_s,
           "tok_per_s": float(n_gen.sum()) / serve_s,
           "ms_per_step": sum(chunk_ms) / len(chunk_ms) / inter,
           "peak_mem_gib": peak / 2**30, "idle_share": idle,
           "idle_trace_records": traced, "ttft_s": ttft.tolist(),
           "completion_s": completion.tolist(), "checks": checks,
           "fault_controls": controls, "k4_records": k4,
           "launches": {k: v for k, v in launches.items() if v}}
    del b
    return rec


def check_chunked_prefill(cfg, runner, prep_a, rows_u, n: int):
    """``vanilla_prefill_chunked`` (chunks of CONT_CHUNK) then
    ``_decode_loop(prealloc_t=T)`` on each unpruned row: the first logits
    within CROSS_LOGIT_RTOL of the monolithic prefill's, and the tokens of
    ``generate(do_selection=False)`` on the same row (cross_check); each
    decode's tokens the same as its
    step-wise replays. The control: the monolithic prefill's first logits
    of each row alone against the same row of batch (a) (another ViT
    attention flavour for row 0), under CROSS_LOGIT_RTOL. Under act_quant
    "prefill" the prefill layers run W8A8 / W4A8 and the chunks, decode
    layers, do not (JAX int4_matmul.py:268-279): the monolithic side then
    runs the tier with the text's act_quant "none", the function the
    chunks compute, and the first logits' distance from the tier's own
    prefill is recorded beside it. -> (records, each row's (tokens,
    logits) of the chunked prefill's decode)."""
    import dataclasses

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.kv_cache import cache_t

    recs, refs = [], []
    for i, prep in enumerate(rows_u):
        s = int(prep.input_ids.shape[1]) - (cfg.gp.le_length if cfg.gp.has_le else 0)
        pre = runner.vanilla_prefill_chunked(prep, CONT_CHUNK, prealloc_t=s + n)
        t = cache_t(pre[3])
        seqs, _ = runner._decode_loop(*pre, n, -1, chunk_size=n, prealloc_t=t)
        toks, lg = stepwise_decode(runner, pre, n, t, prealloc=True)
        if not (seqs[0] == toks).all():
            raise AssertionError(f"row {i}: the chunked prefill's decode gave other tokens "
                                 "than its step-wise replays")
        recs.append({"row": i, "S": s, "T": t, "chunks": -(-s // CONT_CHUNK),
                     "first_logits": pre[0]})
        refs.append((toks, lg))
        if cfg.text.act_quant == "prefill":
            own = runner.prefill(prep, do_selection=False).logits
            recs[-1]["first_logits_rel_dist_act_quant"] = rel_err(pre[0], own)
        del pre
    mono_cfg, mono_runner = cfg, runner
    if cfg.text.act_quant == "prefill":
        mono_cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                     act_quant="none"))
        mono_runner = GlimpsePruneRunner(mono_cfg, runner.model.set_config(mono_cfg))
    try:
        batch_logits = mono_runner.prefill(prep_a, do_selection=False).logits
        for i, (prep, rec, (toks, lg)) in enumerate(zip(rows_u, recs, refs)):
            gen = mono_runner.generate(prep, max_new_tokens=n, do_selection=False,
                                       eos_token_id=-1)
            mono = mono_runner.prefill(prep, do_selection=False)
            want, want_lg = stepwise_decode(mono_runner, one_row(mono), n)
            if not (gen.sequences[0] == want).all():
                raise AssertionError(f"row {i}: generate gave other tokens than its step-wise "
                                     "replays")
            rec.update(mono_act_quant=mono_cfg.text.act_quant,
                       first_logits_rel_dist=rel_err(rec.pop("first_logits"), mono.logits),
                       control_rel_dist=rel_err(mono.logits[0], batch_logits[i]),
                       check=cross_check(f"chunked prefill row {i}", toks, want, lg, want_lg))
            if not max(rec["first_logits_rel_dist"], rec["control_rel_dist"]) <= CROSS_LOGIT_RTOL:
                raise AssertionError(f"chunked prefill row {i}: first logits or the control "
                                     f"past CROSS_LOGIT_RTOL: {rec}")
            del mono, gen
    finally:
        runner.model.set_config(cfg)
    return recs, refs


def check_sampled_batcher(runner, prep, r: int):
    """A sampled capacity-1 batcher (temperature 1, CONT_INTER steps a
    chunk, CONT_NEW_TOKENS tokens) on one pruned request: its tokens equal
    the runner's sampled ``generate`` at the same seed with
    check_eos_every = CONT_INTER, and another seed changes them. The
    generate decodes CONT_INTER * (need + 2) tokens, so that its cache has
    the batcher's T slots and both runs do the same arithmetic; its first
    CONT_NEW_TOKENS are compared. -> record."""
    import torch

    from glimpseprune_torch.serving import ContinuousBatcher

    n, inter = CONT_NEW_TOKENS, CONT_INTER

    def rng(seed):
        return torch.Generator(runner.device).manual_seed(seed)

    b = ContinuousBatcher(runner, capacity=1, prefix_len=r, max_new_tokens=n,
                          inter_steps=inter, eos=-1, temperature=1.0, max_requests=1)
    if b.T != r + inter * (b.need + 2):
        raise AssertionError(f"the sampled batcher's T {b.T} is not R + inter (need + 2)")

    def thunk():
        return one_row(runner.prefill(prep))

    with sync_checked():
        seqs = b.serve([thunk], rng=rng(SAMPLE_SEED))[0][0]
        other = b.serve([thunk], rng=rng(SAMPLE_SEED + 1))[0][0]
        want = runner.generate(prep, max_new_tokens=b.T - r, eos_token_id=-1, temperature=1.0,
                               rng=rng(SAMPLE_SEED), check_eos_every=inter).sequences[0, :n]
    if not (seqs == want).all() or (seqs == other).all():
        raise AssertionError(f"sampled batcher: seed {SAMPLE_SEED} gave {seqs}, generate "
                             f"{want}, seed {SAMPLE_SEED + 1} {other}")
    return {"seeded_equal_generate": True, "other_seed_differs": True,
            "generate_new_tokens": b.T - r}


def run_continuous_serving(cfg, runner, prep_a, rows_p, rows_u, tier, smi):
    """The continuous-serving phase on one model (bf16, then (q4)): (s-p)
    CONT_REQUESTS as B=1 pruned prefills at R = out_len, and (s-u) the same
    rows' unpruned prefills admitted in chunks of CONT_CHUNK
    (``vanilla_prefill_chunked_steps``), each through a ContinuousBatcher
    (continuous_side); the chunked prefill against generate
    (check_chunked_prefill); a sampled capacity-1 batcher against generate
    (check_sampled_batcher); the admission prefills' ms (pruned B=1 against
    each chunk of the rows' chunked prefills); in (q4) no K5 or K6 launch
    inside a chunk. The kernels' launches are each side's timed serve's;
    the fault controls, printed with the rest, must each read past
    CROSS_LOGIT_RTOL. -> record."""
    import dataclasses

    import torch

    n = CONT_NEW_TOKENS
    # the kernels each side's serve must launch: the ViT's (K1, and K2
    # dense or, in (q4), K7), and the pruned prefill's causal and fuser K2
    # and, in (q4), K6; K4 in (q4)'s replays
    vit = ["window_attention_fused",
           "flash_attention_int8[dense+pv8]" if tier == "q4" else "flash_attention[dense]"]
    required = {"s-p": vit + ["flash_attention[causal]", "flash_attention[dqk_ne_dv]"],
                "s-u": list(vit)}
    if tier == "q4":
        required["s-p"] += ["matmul_int4_prefill[a8,*]", "matmul_int4[*]"]
        required["s-u"] += ["matmul_int4[*]"]
    clock = [time.perf_counter()]
    secs = {}

    def lap(name):  # where the phase's seconds go
        now = time.perf_counter()
        secs[name], clock[0] = round(now - clock[0], 1), now

    with torch.inference_mode():
        r_p = max(p.out_len for p in rows_p)
        rows_p = [dataclasses.replace(p, out_len=r_p) for p in rows_p]
        refs_p = {i: stepwise_decode(runner, one_row(runner.prefill(rows_p[i])), n)
                  for i in set(CONT_REQUESTS)}
        for i, (toks, _) in refs_p.items():
            loop, _ = runner._decode_loop(*one_row(runner.prefill(rows_p[i])), n, -1,
                                          chunk_size=n)
            if not (loop[0] == toks).all():
                raise AssertionError(f"row {i}: _decode_loop gave other tokens than its "
                                     "step-wise replays")
        lap("references")
        chunked_recs, refs_u = check_chunked_prefill(cfg, runner, prep_a, rows_u, n)
    lap("chunked prefill")
    pruned = continuous_side(cfg, runner, "s-p", [
        (lambda p=rows_p[i]: one_row(runner.prefill(p))) for i in CONT_REQUESTS],
        [refs_p[i] for i in CONT_REQUESTS], r_p, tier, required["s-p"])

    def chunked(prep):
        def thunk():
            gen = runner.vanilla_prefill_chunked_steps(prep, CONT_CHUNK)
            while True:
                try:
                    yield next(gen)
                except StopIteration as stop:
                    return one_row(stop.value)
        return thunk

    r_u = chunked_recs[0]["S"]
    if any(c["S"] != r_u for c in chunked_recs):
        raise AssertionError(f"the unpruned rows' lengths differ: {chunked_recs}")
    lap("s-p")
    unpruned = continuous_side(cfg, runner, "s-u", [chunked(rows_u[i]) for i in CONT_REQUESTS],
                               [refs_u[i] for i in CONT_REQUESTS], r_u, tier, required["s-u"])
    lap("s-u")
    with torch.inference_mode(), chunk_probe(runner.model) as chunk_calls:
        for prep in rows_u:  # an admission's chunks, timed apart
            runner.vanilla_prefill_chunked(prep, CONT_CHUNK)
    in_chunks = Counter()
    for _, launched in chunk_calls:
        in_chunks.update(launched)
    if tier == "q4" and any(k.startswith("matmul_int4_prefill") for k in in_chunks):
        raise AssertionError(f"(q4) prefill chunks launched K5 / K6: {dict(in_chunks)}")
    with torch.inference_mode():
        sampled = check_sampled_batcher(runner, rows_p[0], r_p)
        prefill_ms = timed_ms(lambda: runner.prefill(rows_p[0]))[0]
    torch.cuda.synchronize()
    lap("chunks, sampled")
    rec = {"tier": tier, "seconds": secs, "sides": [pruned, unpruned],
           "chunked_prefill": chunked_recs,
           "sampled": sampled, "pruned_prefill_ms": prefill_ms,
           "chunk_ms": [ms for ms, _ in chunk_calls],
           "chunk_launches": dict(in_chunks)}
    print(f"continuous serving {tier} " + json.dumps(rec))
    print(f"continuous serving {tier} seconds: " + json.dumps(secs))
    for side in rec["sides"]:
        for i, (a, c) in enumerate(zip(side["ttft_s"], side["completion_s"])):
            print(f"continuous {tier} {side['side']} request {i} on {smi}: ttft {a * 1e3:.1f} ms, "
                  f"completion {c * 1e3:.1f} ms")
        print(f"continuous {tier} {side['side']} on {smi}: {side['tok_per_s']:.1f} tok/s, "
              f"capture {side['capture_ms']:.1f} ms, {side['ms_per_step']:.2f} ms/step, peak "
              f"{side['peak_mem_gib']:.2f} GiB, idle {side['idle_share']}")
        print(f"continuous {tier} {side['side']} serve launches " + json.dumps(side["launches"]))
        print(f"continuous {tier} {side['side']} fault controls (CROSS_LOGIT_RTOL "
              f"{CROSS_LOGIT_RTOL}): " + json.dumps(side["fault_controls"]))
    chunk_ms = rec["chunk_ms"]
    print(f"continuous {tier} admission prefill on {smi}: pruned B=1 {prefill_ms:.1f} ms; "
          f"one chunk of {CONT_CHUNK} {sum(chunk_ms) / len(chunk_ms):.1f} ms (mean of "
          f"{len(chunk_ms)}, {max(chunk_ms):.1f} max)")
    unseen = {f"{side['side']} {fault}": v for side in rec["sides"]
              for fault, v in side["fault_controls"].items() if not v > CROSS_LOGIT_RTOL}
    if unseen:
        raise AssertionError(f"continuous {tier}: planted faults within CROSS_LOGIT_RTOL: "
                             f"{unseen}")
    return rec


def check_delayed_and_oracle(cfg, model, prep_a, prompts_a, images):
    """Phase 13 (i)-(iv) on the bf16 7B and batch (a) -> record."""
    import dataclasses

    import torch

    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.keep_policy import keep_scores_with_policy

    gp = cfg.gp
    runner = GlimpsePruneRunner(cfg, model)
    rec = {}
    with torch.inference_mode():
        # (i) the two-phase API against the one-shot prefill and generate
        ml, st = runner.glimpse_delayed(prep_a)
        out = runner.apply_selection(st, ml, prep_a.out_len)
        one = runner.glimpse(prep_a)
        if not torch.equal(out.keep_img, one.keep_img):
            raise AssertionError("(i) delayed selection kept another set than glimpse")
        seqs, _ = runner._decode_loop(out.logits, out.valid, out.position_ids, out.kv_k,
                                      out.kv_v, MAX_NEW_TOKENS, cfg.eos_token_id)
        res = runner.generate(prep_a, max_new_tokens=MAX_NEW_TOKENS)
        if not np.array_equal(seqs, res.sequences):
            raise AssertionError(f"(i) delayed selection's tokens {seqs} differ from "
                                 f"generate's {res.sequences}")
        rec["delayed_equal_one_shot"] = True
        rec["delayed_first_logits_rel_err"] = rel_err(out.logits, one.logits)
        # (ii) overridden logits: +inf on a chosen set, -inf elsewhere
        iv = torch.as_tensor(prep_a.img_valid, device=ml.device)
        n_valid = iv.sum(1)
        cap = torch.floor(gp.max_remain_ratio * n_valid.float()).long()
        k = torch.clamp(cap, max=OVERRIDE_KEEP)
        chosen = torch.zeros_like(iv)
        for b in range(iv.shape[0]):
            slots = torch.nonzero(iv[b])[:, 0]
            pick = torch.linspace(0, len(slots) - 1, int(k[b]), device=ml.device).round().long()
            chosen[b, slots[pick]] = True
        inf = torch.tensor(float("inf"), device=ml.device)
        over = torch.where(chosen, inf, -inf)[None]
        out2 = runner.apply_selection(st, over, prep_a.out_len)
        if not torch.equal(out2.keep_img, chosen):
            raise AssertionError("(ii) the override's keep set is not the chosen set")
        rec["override_kept"] = out2.keep_img.sum(1).tolist()
        # (iii) the oracle masks: the bboxes' +-inf logits through the keep policy
        prep_r = prepare_inputs(cfg, prompts_a, images, normed_bboxes=REF_BOXES)
        ref = torch.as_tensor(prep_r.ref_token_masks, device=ml.device)
        want = keep_scores_with_policy(torch.sigmoid(torch.where(ref, inf, -inf)),
                                       torch.as_tensor(prep_r.img_valid, device=ml.device),
                                       gp.reduce_threshold, gp.max_remain_ratio,
                                       gp.min_remain_num)
        res_r = runner.generate(prep_r, max_new_tokens=MAX_NEW_TOKENS, use_ref_masks=True)
        if not np.array_equal(res_r.keep_img, want.cpu().numpy()):
            raise AssertionError("(iii) use_ref_masks kept another set than the policy on "
                                 "the bboxes' logits")
        first = runner.prefill(prep_r, use_ref_masks=True).logits
        if not torch.isfinite(first.float()).all() or \
                res_r.sequences.shape != (2, MAX_NEW_TOKENS):
            raise AssertionError("(iii) use_ref_masks: non-finite logits or a short decode")
        rec["ref_masks_kept"] = res_r.keep_img.sum(1).tolist()
        rec["ref_masks_boxed"] = prep_r.ref_token_masks.sum(1).tolist()
        zcfg = dataclasses.replace(cfg, gp=dataclasses.replace(gp, use_zero_masks=True))
        try:
            zero = GlimpsePruneRunner(zcfg, model.set_config(zcfg)).glimpse(prep_a)
        finally:
            model.set_config(cfg)
        kept = zero.keep_img.sum(1).cpu().numpy()
        if not (kept == np.minimum(gp.min_remain_num, prep_a.img_valid.sum(1))).all():
            raise AssertionError(f"(iii) use_zero_masks kept {kept}, not min_remain_num")
        rec["zero_masks_kept"] = kept.tolist()
        # (iv) the visualization harvest
        rows = runner.harvest_rows(prep_a)
        for l, r in rows.items():
            if r.shape != (2, prep_a.img_valid.shape[1], cfg.text.num_attention_heads) or \
                    not torch.isfinite(r).all():
                raise AssertionError(f"(iv) harvest_rows layer {l}: {tuple(r.shape)}")
        q_start = prep_a.input_ids.shape[1] - HARVEST_QUERIES
        rows_q = runner.harvest_rows(prep_a, q_start=q_start)
        for l, r in rows_q.items():
            if r.shape[1] != HARVEST_QUERIES or not ((r >= 0) & (r <= 1)).all():
                raise AssertionError(f"(iv) harvest_rows(q_start) layer {l}: not probabilities")
        rec["harvest_layers"] = sorted(rows)
        rec["harvest_img_mass_max"] = max(float(r.sum(2).max()) for r in rows_q.values())
    print("phase 13 (i)-(iv) " + json.dumps(rec))
    return rec


def run_grpo(cfg, model, image):
    """Phase 13 (v): GRPOTrainer on the bf16 7B, LoRA rank GRPO_RANK, G =
    GRPO_G samples of one prompt (row 0's image), GRPO_NEW_TOKENS sampled
    tokens, GRPO_STEPS steps -> record. The adapters are removed after, and
    the model bound to cfg again."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.data import TrainSample
    from glimpseprune_torch.training.grpo import GRPOTrainer
    from glimpseprune_torch.training.lora import remove_lora

    base = {n: p.detach().cpu() for n, p in model.named_parameters()}
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    alloc0 = torch.cuda.memory_allocated()
    trainer = GRPOTrainer(cfg, GlimpsePruneRunner(cfg, model), None, hash_tokenize,
                          lambda ids: " ".join(map(str, ids)), num_generations=GRPO_G,
                          max_new_tokens=GRPO_NEW_TOKENS, temperature=1.0, score_fn="dummy",
                          lora_rank=GRPO_RANK, learning_rate=GRPO_LR, seed=0)
    samples = [TrainSample("What is the object in the middle of the picture?", "a thing",
                           "row0")]
    gen = torch.Generator(device=model.text.embed_tokens.weight.device).manual_seed(SAMPLE_SEED)
    steps = []
    with captures() as caught:
        for i in range(GRPO_STEPS):
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            graphs = list(trainer.policy_runner.decode_graphs._graphs.values())
            ms, m = timed_ms(lambda: trainer.step_on_batch(samples, lambda _: image, gen))
            launches = read_launches(["window_attention_fused", "flash_attention[causal]",
                                      "flash_attention_lse[causal]",
                                      "flash_attention_backward[causal]"])
            st = dict(m, step=i + 1, ms=ms,
                      peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                      k2_lse_causal=launches["flash_attention_lse[causal]"],
                      k3_causal=launches["flash_attention_backward[causal]"],
                      k2_causal=launches["flash_attention[causal]"],
                      launches={k: v for k, v in launches.items() if v}, captured=len(caught))
            if i == 0:
                st["lora_b_nonzero"] = sum(int(bool(p.detach().abs().max() > 0))
                                           for n, p in trainer.lora.items()
                                           if n.endswith("lora_b"))
            else:
                now = list(trainer.policy_runner.decode_graphs._graphs.values())
                st["graph_reused"] = len(now) == len(graphs) and all(
                    a is b for a, b in zip(now, graphs))
            print("phase 13 grpo step " + json.dumps(st))
            steps.append(st)
    bad = [k for st in steps for k in ("reward_loss", "kd_loss", "grpo_total")
           if not np.isfinite(st[k])]
    if bad:
        raise AssertionError(f"(v) non-finite GRPO losses {bad}")
    if not abs(steps[0]["kd_loss"]) < 1e-3:
        raise AssertionError(f"(v) kd_loss {steps[0]['kd_loss']} at step 1 (B starts at 0)")
    if not steps[0]["lora_b_nonzero"]:
        raise AssertionError("(v) no lora_b moved at step 1")
    if len(caught) != 1 or not steps[1]["graph_reused"]:
        raise AssertionError(f"(v) the policy runner captured {len(caught)} decode graphs "
                             "over two steps (one expected, at step 1)")
    extra_gib = max(st["peak_mem_gib"] for st in steps) - alloc0 / 2**30
    if extra_gib > 0.5 * weight_bytes / 2**30:
        raise AssertionError(f"(v) the steps' peak is {extra_gib:.2f} GiB over the model: "
                             "a second copy of the weights?")
    remove_lora(model).set_config(cfg)
    del trainer
    moved = [n for n, p in model.named_parameters() if not torch.equal(p.cpu(), base[n])]
    if moved or set(base) != {n for n, _ in model.named_parameters()}:
        raise AssertionError(f"(v) base weights changed: {moved[:5]}")
    torch.cuda.empty_cache()
    rec = {"steps": steps, "peak_over_model_gib": extra_gib,
           "weights_gib": weight_bytes / 2**30, "base_weights_bit_identical": True}
    print("phase 13 (v) " + json.dumps({k: v for k, v in rec.items() if k != "steps"}))
    return rec


def run_glimpse_plus(cfg, model, prep_a, prompts_a, images):
    """Phase 13 on the bf16 7B: (i)-(iv), then (v); the launches of the
    whole phase (counts set to 0 just before it) -> (record, launches)."""
    import torch

    t0 = time.perf_counter()
    reset_launches()
    checks = check_delayed_and_oracle(cfg, model, prep_a, prompts_a, images)
    torch.cuda.synchronize()
    before = launch_counts()
    grpo = run_grpo(cfg, model, images[0])
    torch.cuda.synchronize()
    launches = {k: before.get(k, 0) + sum(st["launches"].get(k, 0) for st in grpo["steps"])
                for k in set(before) | {k for st in grpo["steps"] for k in st["launches"]}}
    return {"checks": checks, "grpo": grpo, "phase_s": time.perf_counter() - t0}, launches


def check_lora_q4(qcfg, model, row):
    """Phase 13 (vi) on the (q4) 7B: zero-B adapters on every decoder
    projection against the same model under lora_disabled, on a B=1 pruned
    prefill. An adapted layer runs without A8, so the adapted prefill is
    held against the disabled one with the text's act_quant "none": both
    then take the int4 weight-only route and the adapter adds an exact
    zero, so the mask logits must be bit-equal, and the first logits too
    once both sides prune with the adapted side's logits (one keep set).
    The decode's products are the same with and without the adapters (A8
    is off in decode either way), so one prefill decoded both ways must
    give bit-identical logits and tokens (K4 in every step). The disabled
    prefill under the tier's own act_quant runs W4A8 (K6; every K6 launch
    of a (q4) prefill is in the decoder) and the adapted one launches no
    K6; their distance is a reading, held to no bound. The adapters are
    removed after."""
    import dataclasses

    import torch

    from glimpseprune_torch.models.layers import lora_disabled
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training.lora import (
        DEFAULT_TARGETS,
        insert_lora,
        make_lora_params,
        remove_lora,
    )

    lcfg = dataclasses.replace(qcfg, text=dataclasses.replace(qcfg.text, lora_rank=GRPO_RANK))
    ncfg = dataclasses.replace(lcfg, text=dataclasses.replace(lcfg.text, act_quant="none"))
    q4_targets = DEFAULT_TARGETS.replace("kernel(_q)?", "kernel(_q4?)?")
    insert_lora(model, make_lora_params(model, GRPO_RANK, q4_targets, seed=0), cfg=lcfg)
    runner = GlimpsePruneRunner(lcfg, model)

    def prefill(cfg, keep_logits=None):
        r = GlimpsePruneRunner(cfg, model.set_config(cfg))
        reset_launches()
        ml, st = r.glimpse_delayed(row)
        out = r.apply_selection(st, ml if keep_logits is None else keep_logits, row.out_len)
        launches = read_launches(["flash_attention_int8[*]"])  # K6: the A8 run's
        model.set_config(lcfg)
        return ml, out, launches

    def decode(out):
        reset_launches()
        pre = (out.logits, out.valid, out.position_ids, out.kv_k, out.kv_v)
        toks, lg = stepwise_decode(runner, pre, MAX_NEW_TOKENS)
        return toks, torch.stack(lg), read_launches(["matmul_int4[*]"])

    with torch.inference_mode():
        ml_on, out_on, pre_on = prefill(lcfg)
        got, got_lg, dec_on = decode(out_on)
        with lora_disabled(model):
            ml_off, out_off, _ = prefill(ncfg, ml_on)
            ml_a8, out_a8, pre_a8 = prefill(lcfg)
            want, want_lg, _ = decode(out_on)
    remove_lora(model).set_config(qcfg)

    def k6(launches):
        return sum(v for k, v in launches.items() if k.startswith("matmul_int4_prefill[a8"))

    rec = {"decode_tokens_equal": bool(np.array_equal(got, want)),
           "decode_logits_bit_equal": bool(torch.equal(got_lg, want_lg)),
           "prefill_mask_logits_bit_equal": bool(torch.equal(ml_on, ml_off)),
           "prefill_first_logits_bit_equal": bool(torch.equal(out_on.logits, out_off.logits)),
           "a8_mask_logits_rel_dist": rel_err(ml_on[-1], ml_a8[-1]),
           "a8_first_logits_rel_dist": rel_err(out_on.logits, out_a8.logits),
           "a8_keep_equal": bool(torch.equal(out_on.keep_img, out_a8.keep_img)),
           "k6_prefill_launches_adapted": k6(pre_on), "k6_prefill_launches_a8": k6(pre_a8),
           "k4_decode_launches": sum(v for k, v in dec_on.items() if k.startswith("matmul_int4[")),
           "launches": {k: pre_on[k] + dec_on[k] for k in pre_on if pre_on[k] + dec_on[k]}}
    print("phase 13 (vi) " + json.dumps(rec))
    if not (rec["decode_tokens_equal"] and rec["decode_logits_bit_equal"]):
        raise AssertionError(f"(vi) zero-B adapters changed the decode: {rec}")
    if not (rec["prefill_mask_logits_bit_equal"] and rec["prefill_first_logits_bit_equal"]):
        raise AssertionError(f"(vi) zero-B adapters changed the A16 prefill: {rec}")
    if rec["k6_prefill_launches_adapted"] or not rec["k6_prefill_launches_a8"]:
        raise AssertionError(f"(vi) the adapted layers still ran W4A8 (K6): {rec}")
    if not rec["k4_decode_launches"]:
        raise AssertionError("(vi) the adapted decode launched no K4")
    return rec


def compressor_kwargs(method):
    if method in ("divprune", "cdpruner", "vscan"):
        return {"visual_token_num": VISUAL_TOKEN_NUM}
    return {}


def expected_kept(method, n_img):
    """Image tokens each row keeps, from the selectors' static budgets (the
    ratios multiply in fp32, as in the port and the JAX package)."""
    f32 = np.float32
    n = n_img.astype(np.int64)
    if method == "visionzip":  # dominant top-k plus min(contextual k, the rest)
        dom = np.maximum((f32(0.65) * n.astype(f32)).astype(np.int64), 1)
        ctx = np.maximum((f32(0.05) * n.astype(f32)).astype(np.int64), 1)
        return dom + np.minimum(ctx, n - dom)
    if method == "pdrop":  # the last stage's ratio
        return np.maximum((f32(0.125) * n.astype(f32)).astype(np.int64), 1)
    return np.minimum(VISUAL_TOKEN_NUM, n)


def check_compressed(cfg, prep, method, pre, res):
    """Shapes, finiteness, keep counts, prune ratios and the compaction of
    one compressed generate."""
    import torch

    b = prep.input_ids.shape[0]
    assert pre.logits.shape == (b, 1, cfg.text.vocab_size), pre.logits.shape
    assert torch.isfinite(pre.logits.float()).all(), f"{method}: non-finite prefill logits"
    assert res.sequences.shape == (b, COMPRESSED_NEW_TOKENS), res.sequences.shape
    assert ((res.sequences >= 0) & (res.sequences < cfg.text.vocab_size)).all()
    kept = pre.kept.cpu().numpy()
    want = expected_kept(method, prep.n_img_tokens)
    assert (kept == want).all(), f"{method}: kept {kept.tolist()}, expected {want.tolist()}"
    if res.keep_img is not None:
        assert not (res.keep_img & ~prep.img_valid).any(), f"{method}: kept a padding slot"
        assert (res.keep_img.sum(1) == want).all()
    assert ((res.prune_ratio > 0) & (res.prune_ratio < 1)).all(), res.prune_ratio
    le = cfg.gp.le_length if cfg.gp.has_le else 0
    n_text = prep.valid.sum(1) - prep.n_img_tokens - le
    assert (pre.valid.sum(1).cpu().numpy() == n_text + kept).all(), \
        f"{method}: compaction lost tokens"


def run_compressed_path(cfg, model, cases, main_runs):
    """generate_compressed with each compressor on each batch: prefill and
    decode times, printed beside the same run's pruned and unpruned
    ``generate`` (main_runs), keep counts, launch counts. K8 must not
    launch: both of the 7B's importance blocks are full-attention blocks."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    runner = GlimpsePruneRunner(cfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for method in COMPRESSORS:
            kw = compressor_kwargs(method)
            # warm-up, which captures the decode step that the timed runs replay
            runner.generate_compressed(prep, method, max_new_tokens=COMPRESSED_NEW_TOKENS, **kw)
            torch.cuda.reset_peak_memory_stats()
            prefill_ms, pre = timed_ms(lambda: runner.prefill_compressed(prep, method, **kw))
            decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                COMPRESSED_NEW_TOKENS, cfg.eos_token_id))
            res = runner.generate_compressed(prep, method,
                                             max_new_tokens=COMPRESSED_NEW_TOKENS, **kw)
            peak = torch.cuda.max_memory_allocated()
            check_compressed(cfg, prep, method, pre, res)
            run = {"batch": name, "method": method, "B": int(prep.input_ids.shape[0]),
                   "prefill_ms": prefill_ms,
                   "decode_ms_per_token": decode_ms / COMPRESSED_NEW_TOKENS,
                   "peak_mem_gib": peak / 2**30, "kv_len": int(pre.valid.shape[1]),
                   "kept_img_tokens": pre.kept.tolist(),
                   "prune_ratio": [float(x) for x in res.prune_ratio]}
            print("compressed path " + json.dumps(run))
            runs.append(run)
    for name, _ in cases:
        side = {r["mode"]: r for r in main_runs if r["batch"] == name}
        side.update({r["method"]: r for r in runs if r["batch"] == name})
        print(f"batch ({name}) prefill ms / decode ms per token: " + ", ".join(
            f"{k} {r['prefill_ms']:.1f} / {r['decode_ms_per_token']:.1f}"
            for k, r in side.items()))
    torch.cuda.synchronize()
    launches = read_launches(["window_attention_fused"] + [
        f"flash_attention[{k}]" for k in ("causal", "dense", "segmented")])
    print("compressed-path launches " + json.dumps(launches))
    if launches["window_attention"]:
        raise AssertionError("K8 launched on the published config, whose importance blocks "
                             "are full-attention blocks")
    return runs, launches


def windowed_last(cfg, **vision):
    """cfg with a vision tower whose last block is windowed (not in configs/)."""
    import dataclasses

    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, fullatt_block_indexes=WINDOWED_LAST_FULLATT, **vision))


def run_importance_variant(cfg, model, prep):
    """K8 on the importance path: the 7B's weights bound to a vision config
    whose last block is windowed. One ViT call with emit_importance, then
    generate_compressed with visionzip and vscan: K8 launches once per ViT
    call. The model is bound back to cfg afterwards."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    vcfg = windowed_last(cfg)
    runner = GlimpsePruneRunner(vcfg, model.set_config(vcfg))
    inputs = runner._device_inputs(prep)
    reset_launches()
    with torch.inference_mode():
        vit_ms, (merged, _, imp) = timed_ms(lambda: runner._vision(inputs, prep, True))
    launches = read_launches(["window_attention"])
    if launches["window_attention"] != 1:
        raise AssertionError(f"K8 launched {launches['window_attention']} times in one ViT call")
    n_units = prep.patches.shape[0] // cfg.vision.spatial_merge_unit
    assert [tuple(t.shape) for t in imp] == [(n_units,), (n_units, cfg.vision.head_dim),
                                             (n_units,)]
    assert all(torch.isfinite(t).all() for t in (merged.float(), *imp))
    record = {"config": f"vision fullatt_block_indexes={WINDOWED_LAST_FULLATT} "
                        "(not in configs/)", "vit_importance_ms": vit_ms}
    reset_launches()
    for method in ("visionzip", "vscan"):
        kw = compressor_kwargs(method)
        ms, pre = timed_ms(lambda: runner.prefill_compressed(prep, method, **kw))
        res = runner.generate_compressed(prep, method, max_new_tokens=COMPRESSED_NEW_TOKENS,
                                         **kw)
        check_compressed(vcfg, prep, method, pre, res)
        record[f"{method}_prefill_ms"] = ms
    launches = read_launches(["window_attention", "window_attention_fused"])
    record["launches"] = launches
    print("importance path, windowed last block " + json.dumps(record))
    if launches["window_attention"] != 4:  # two prefills, two generates: 4 ViT calls
        raise AssertionError(f"K8 launched {launches['window_attention']} times in 4 ViT calls")
    model.set_config(cfg)
    return record


def check_small_importance(cfg, model, prep):
    """A two-block tower of the 7B's width whose last block is windowed
    (full attention at block 0; not in configs/), with the 7B's first two
    blocks' weights, on batch (a) with emit_importance: on the card (bf16,
    K2 and K8) against the CPU (fp32, the plain versions), relative to the
    largest magnitude of each output, within the same 10% as the other
    card-against-CPU checks."""
    import dataclasses

    import torch

    from glimpseprune_torch.models.qwen2_5_vl.vision import VisionTransformer
    from glimpseprune_torch.ops.cuda.window_attention import window_attention

    vcfg = dataclasses.replace(cfg.vision, depth=2, fullatt_block_indexes=(0,))
    tower = VisionTransformer(vcfg)
    tower.load_state_dict({k: v for k, v in model.visual.state_dict().items()
                           if not k.startswith("blocks.") or int(k.split(".")[1]) < 2})
    tower.eval()
    gpu = copy.deepcopy(tower).to(device="cuda", dtype=torch.bfloat16)
    args = [torch.as_tensor(a) for a in (prep.patches, prep.vis_pos_ids, prep.full_seg,
                                         prep.vis_valid)]
    window_attention.launches = 0
    with torch.inference_mode():
        got = gpu(*[a.cuda() for a in args], emit_importance=True)
        torch.cuda.synchronize()
        k8 = window_attention.launches
        t0 = time.perf_counter()
        ref = tower(*args, emit_importance=True)
        cpu_s = time.perf_counter() - t0
    if k8 != 1:
        raise AssertionError(f"the two-block tower launched K8 {k8} times")
    unit_valid = torch.as_tensor(prep.vis_valid.reshape(-1, vcfg.spatial_merge_unit)[:, 0])
    names = ("merged", "received", "keys_mean", "received_local")
    errs = {}
    for name, g, r in zip(names, (got[0], *got[2]), (ref[0], *ref[2])):
        g, r = g.float().cpu()[unit_valid], r.float()[unit_valid]
        errs[name] = ((g - r).abs().max() / r.abs().max()).item()
    print(f"two-block tower, last block windowed (not in configs/), card bf16 vs CPU fp32 "
          f"({cpu_s:.1f} s on the CPU), max error / max |ref|: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card's importance path disagrees with the CPU: {bad}")
    return errs


def check_small_compressed():
    """The tiny config's compressed prefill on the card (bf16, the kernels)
    against the same weights on the CPU (fp32, the plain versions, which the
    CPU tests hold equal to the JAX runner): visionzip's keep mask and
    pdrop's compacted ids, positions and valid mask equal, first logits
    within 10% of their largest magnitude."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = tiny_test_config()
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    errs = {}
    for method, kw in (("visionzip", {}), ("pdrop", {"stages": ((1, 0.5), (2, 0.25))})):
        ref = ref_run.prefill_compressed(prep, method, **kw)
        got = got_run.prefill_compressed(prep, method, **kw)
        if method == "visionzip":
            same = torch.equal(got.keep_img.cpu(), ref.keep_img)
        else:
            same = all(torch.equal(getattr(got, f).cpu(), getattr(ref, f))
                       for f in ("input_ids", "position_ids", "valid"))
        if not same:
            raise AssertionError(f"tiny {method}: the card kept other image tokens than the CPU")
        errs[method] = ((got.logits.float().cpu() - ref.logits).abs().max()
                        / ref.logits.abs().max()).item()
    print("tiny config compressed prefill, card bf16 vs CPU fp32, equal keep sets, first "
          "logits max error / max |ref|: " + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card's compressed prefill disagrees with the CPU: {bad}")
    return errs


def hash_tokenize(text: str):
    """A deterministic stand-in tokenizer: one ordinary text id per word."""
    return [1000 + zlib.crc32(w.encode()) % 149000 for w in text.split()]


def write_train_corpus(directory: Path, n_rows: int = 8):
    """n rows of VisCoT-style jsonl over random images (.npy) of the two
    smoke sizes, with random pixel boxes -> the GPDataset config dict."""
    rng = np.random.default_rng(2)
    shutil.rmtree(directory, ignore_errors=True)
    img_dir = directory / "imgs" / "cot" / "synthetic"
    img_dir.mkdir(parents=True)
    rows = []
    for i in range(n_rows):
        h, w = (896, 672) if i % 2 == 0 else (672, 504)
        np.save(img_dir / f"{i}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        x0, y0 = rng.integers(0, w // 2), rng.integers(0, h // 2)
        x1, y1 = x0 + rng.integers(w // 8, w // 2), y0 + rng.integers(h // 8, h // 2)
        rows.append({"question": f"What is the object in region {i} of the picture?",
                     "answer": f"It is object number {i}.", "image": f"{i}.npy",
                     "width": w, "height": h, "bboxs": [[float(x0), float(y0), float(x1),
                                                         float(y1)]],
                     "dataset": "synthetic", "split": "train"})
    jsonl = directory / "train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"datasets": [{"json_path": str(jsonl), "mapper": "cot_train",
                          "bbox_type": "xyxy", "additional_mappers": ["norm_bboxes"]}]}


def make_trainer(cfg, model, work: Path):
    from glimpseprune_torch.training.data import GPDataset
    from glimpseprune_torch.training.trainer import GPTrainer, TrainerConfig

    dataset = GPDataset(write_train_corpus(work), img_dir=str(work / "imgs"))
    tcfg = TrainerConfig(batch_size=2, num_epochs=1, log_every=1, save_every=0,
                         output_dir=str(work / "ckpt"), seed=0)
    return GPTrainer(cfg, model, dataset, hash_tokenize, load_image=np.load, tcfg=tcfg)


def run_training_path(trainer):
    """GPTrainer.train(max_steps=4) at batch 2 on the 7B model, each step
    timed; -> (per-step records, launch counts)."""
    import torch

    from glimpseprune_torch.training.train_step import split_params

    trainable, frozen = split_params(trainer.model)
    # the frozen copy waits in host memory, so the steps' device peak is
    # the training's own
    frozen_before = {k: p.detach().cpu() for k, p in frozen.items()}
    trainable_before = {k: p.detach().clone() for k, p in trainable.items()}
    inner, steps = trainer.step_fn, []

    def timed_step(batch, generator):
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = timed_ms(lambda: inner(batch, generator))
        steps.append({"ms": ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "S": int(batch["input_ids"].shape[1]),
                      "patches": int(batch["patches"].shape[0])})
        return metrics

    trainer.step_fn = timed_step
    reset_launches()
    history = trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches(["window_attention_fused", "flash_attention[segmented]"] + [
        f"{fn}[{k}]" for fn in ("flash_attention_lse", "flash_attention_backward")
        for k in ("causal", "dqk_ne_dv")])
    print("training-path launches " + json.dumps(launches))
    assert len(history) == len(steps) == TRAIN_STEPS, (len(history), len(steps))
    for h, st in zip(history, steps):
        st.update({k: h[k] for k in ("step", "loss", "loc_loss", "le_loss", "mask_iou")})
        print("train step " + json.dumps(st))
        bad = [k for k in ("loss", "loc_loss", "le_loss", "mask_iou") if not np.isfinite(st[k])]
        if bad:
            raise AssertionError(f"non-finite {bad} at step {st['step']}")
    changed = [k for k, p in trainable.items() if not torch.equal(p, trainable_before[k])]
    moved = [k for k, p in frozen.items() if not torch.equal(p.cpu(), frozen_before[k])]
    print(f"trainable tensors changed: {len(changed)} of {len(trainable)}; "
          f"frozen tensors changed: {len(moved)} of {len(frozen)}")
    if len(changed) != len(trainable) or moved:
        raise AssertionError(f"unchanged trainable {sorted(set(trainable) - set(changed))}, "
                             f"changed frozen {moved}")
    return steps, launches


def check_small_train_step():
    """One tiny-config train step on the card (frozen base bf16, trainable
    fp32, the kernels) against the same weights on the CPU in fp32 with the
    plain versions, which the CPU tests hold equal to the JAX train step:
    every trainable gradient's max error / max |ref|, and the loss. The
    bound (10%) catches a wrong path or a wrong backward; bf16 rounding
    through the tiny model stays far below it."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.training.train_step import (
        compute_loss,
        init_trainable,
        new_module_filter,
    )
    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg = tiny_test_config()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    answers = [[int(x) for x in rng.integers(5, 400, 4)] for _ in range(2)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          normed_bboxes=[[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]],
                          answer_ids=answers, seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    for name, p in gpu_model.named_parameters():
        if not new_module_filter(name):
            p.data = p.data.bfloat16()
    out = {}
    for tag, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, "cuda")):
        trainable = init_trainable(model)
        total, _ = compute_loss(cfg, model, batch_from_prep(prep, device))
        total.backward()
        out[tag] = (total.item(), {k: p.grad.float().cpu() for k, p in trainable.items()})
    errs = {k: ((g - out["cpu"][1][k]).abs().max() / out["cpu"][1][k].abs().max()).item()
            for k, g in out["gpu"][1].items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(out["gpu"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    print(f"tiny train step, card bf16 vs CPU fp32: loss {out['gpu'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f}, worst gradient max error / max |ref| {errs[worst]:.4f} "
          f"({worst}) over {len(errs)} tensors")
    if not (errs[worst] <= 0.1 and loss_err <= 0.1):
        raise AssertionError(f"the card's train step disagrees with the CPU: "
                             f"{worst} {errs[worst]}, loss {loss_err}")
    return {"loss_rel_err": loss_err, "grad_rel_err": errs[worst]}

def int4_weight(k, n, gen):
    """A random [k, n] weight at the init's scale, int4-quantized on the card."""
    import torch

    from glimpseprune_torch.quantization import quantize_int4

    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    q = quantize_int4(w)
    return q["kernel_q4"], q["kernel_scale4"]


def decoder_shapes(cfg):
    """{name: (K, N)} of the 7B decoder's linears and the head."""
    t = cfg.text
    kv = t.num_key_value_heads * t.head_dim
    return {"q_o": (t.hidden_size, t.hidden_size), "k_v": (t.hidden_size, kv),
            "gate_up": (t.hidden_size, t.intermediate_size),
            "down": (t.intermediate_size, t.hidden_size), "head": (t.hidden_size, t.vocab_size)}


def int4_row(name, key, replaces, x, packed, scales, got, ref, ms, plain_ms, out_bytes,
             flops=0.0, int8_ops=0.0, extra=()):
    """One K4-K6 row: error against the plain version, bound, and the bf16
    matmul of the same shape."""
    import torch

    from glimpseprune_torch.quantization import dequant_int4

    err = rel_err(got, ref)
    if not err <= INT4_RTOL:
        raise AssertionError(f"{name}[{key}] disagrees with its plain version: {err}")
    wb = dequant_int4(packed, scales, torch.bfloat16)
    bf16_ms = cuda_ms(lambda: x @ wb)
    del wb
    bound_ms, bound_by = bound(flops, nbytes(packed, scales, *extra) + out_bytes, int8_ops)
    m, k = x.shape
    shape = f"x[{m},{k}] w4[{k // 2},{packed.shape[1]}] g={k // scales.shape[0]}"
    print(f"{name}[{key}] {shape}: rel_err={err:.3e} kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bf16 matmul {bf16_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    # no single PyTorch call multiplies by int4 weights: library_ms is null
    return {"name": f"{name}[{key}]", "route": "cuda", "source": INT4_SRC,
            "replaces": replaces, "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "rel_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bf16_matmul_ms": bf16_ms,
            "shape": shape}


def k6_plain(x, packed, scales, trunc: bool = False):
    """K6's plain version on the card from the same bf16 x, in bf16: x
    quantized by quantize_kv, the weights requantized by requant_ratios,
    the exact integer product and the rescale. ``trunc`` truncates q4 * r
    instead of rounding it: the control that must fail."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        int4_prefill_a8_reference,
        requant_ratios,
        unpack_int4,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    xq, xs = quantize_kv(x)
    s8, r = requant_ratios(scales)
    if not trunc:
        return int4_prefill_a8_reference(xq, xs[:, None], packed, r, s8, torch.bfloat16)
    g = x.shape[1] // scales.shape[0]
    q8 = torch.trunc(unpack_int4(packed).float() * r.repeat_interleave(g, dim=0))
    return ((xq.double() @ q8.double()).float() * xs[:, None] * s8).to(torch.bfloat16)


def k5_plain(x, packed, scales, swap: bool = False):
    """K5's plain version on the card from the same bf16 x, in fp32.
    ``swap`` swaps the lo and the hi groups' scales: the control that must
    fail."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import int4_prefill_a16_reference

    if swap:
        half = scales.shape[0] // 2
        scales = torch.cat([scales[half:], scales[:half]])
    return int4_prefill_a16_reference(x, packed, scales, torch.float32)


def check_k5_bits(name, x, packed, scales):
    """K5 (prep and GEMM, one call) on x against its plain versions on the
    same inputs: W16^T equal to int4_a16_prep_reference's (the weights of
    int4_prefill_a16_reference) bit for bit, two calls bit-identical, the
    output within INT4_RTOL of k5_plain's; raises otherwise. -> (output,
    plain output, relative error)"""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import int4_a16_kernels, int4_a16_prep_reference

    got, w16t = int4_a16_kernels(x, packed, scales)
    again, _ = int4_a16_kernels(x, packed, scales)
    torch.cuda.synchronize()
    m = x.shape[0]
    if not torch.equal(w16t, int4_a16_prep_reference(packed, scales)):
        raise AssertionError(f"K5[{name}] at M={m}: W16^T differs from its plain version")
    if not torch.equal(got, again):
        raise AssertionError(f"K5[{name}] at M={m}: two calls differ")
    ref = k5_plain(x, packed, scales)
    err = rel_err(got, ref)
    if not err <= INT4_RTOL:
        raise AssertionError(f"K5[{name}] at M={m} disagrees with its plain version: {err}")
    return got, ref, err


def check_k6_bits(x, packed, scales):
    """K6 (prep and GEMM, one call) on x against its plain versions on the
    same inputs: the output equal to k6_plain's bit for bit, and each prep
    output (xq, xs, W8^T, s8) equal to int4_a8_prep_reference's; raises
    otherwise. Returns the output."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import int4_a8_kernels, int4_a8_prep_reference

    got, prep = int4_a8_kernels(x, packed, scales)
    torch.cuda.synchronize()
    want_prep = int4_a8_prep_reference(x, packed, scales)
    bad = [n for n, a, b in zip(("xq", "xs", "w8t", "s8"), prep, want_prep)
           if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"K6's prep differs from its plain version in {bad}")
    want = k6_plain(x, packed, scales)
    if not torch.equal(got, want):
        raise AssertionError(f"K6 at M={x.shape[0]} differs from its plain version in "
                             f"{(got != want).sum().item()} of {got.numel()} outputs")
    return got


def host_ms(fn, iters: int = 20) -> float:
    """Mean host ms to issue one call of ``fn`` (the card's work is not
    waited for): the launch cost inside a kernel's event time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issued = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return issued


def prep_gemm_ms(call, per_call=None):
    """(prep, GEMM) device ms of one K5 or K6 call, each None if not
    measured; ``per_call``, a dict, receives each kernel's launches per
    call (device_ms_by_kernel)."""
    by = device_ms_by_kernel(call, per_call=per_call) or {}

    def stage(tag):
        ms = [v for key, v in by.items() if tag in key]
        return sum(ms) if ms else None

    return stage("prep_kernel"), stage("gemm_kernel")


def k4_times(x, packed, scales, copies):
    """K4's times at x: event and device ms warm (the same weights every
    call) and cold (``copies`` rotated, more bytes than the L2 holds, as
    decode reads each layer's weights once), event ms and host ms to issue
    a call through ``matmul_int4`` and through ``matmul_int4_auto`` (the
    decode path's lean launch), and the kernels one call launches (from the
    cold trace)."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import matmul_int4
    from glimpseprune_torch.quantization import matmul_int4_auto

    turn = [0]

    def cold():
        turn[0] += 1
        return matmul_int4(x, *copies[turn[0] % len(copies)])

    def warm():
        return matmul_int4(x, packed, scales)

    def auto():
        return matmul_int4_auto(x, packed, scales, torch.bfloat16)

    per_call = {}
    by = device_ms_by_kernel(cold, per_call=per_call)
    return {"ms": cuda_ms(warm), "cold_ms": cuda_ms(cold), "auto_ms": cuda_ms(auto),
            "device_ms": device_ms(warm),
            "cold_device_ms": None if by is None else sum(by.values()),
            "host_ms": host_ms(warm), "auto_host_ms": host_ms(auto),
            "kernels_per_call": per_call if by is not None else None}


def check_k4(name, packed, scales, decode_m: int, gen):
    """K4 at one weight shape: within INT4_RTOL of its plain version and
    bit-identical over two calls at M = decode_m and 1 (and K4_CHECK_M for
    k/v and gate/up); a control, the plain version without the last K
    split's groups, must fail INT4_RTOL (every split is summed); one K4
    kernel per call wherever the trace measured it; times at M = decode_m
    and 1 (k4_times). -> (the kernels line's row, report)"""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        K4_GROUP_ROWS,
        launch_key,
        matmul_int4,
        matmul_int4_reference,
        plan_int4_decode,
    )

    k, n = 2 * packed.shape[0], packed.shape[1]
    report, cases = {"rel_err": {}}, {}
    for m in (decode_m, 1) + (K4_CHECK_M if name in ("k_v", "gate_up") else ()):
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        got, again = matmul_int4(x, packed, scales), matmul_int4(x, packed, scales)
        torch.cuda.synchronize()
        ref = matmul_int4_reference(x, packed, scales, torch.float32)
        err = rel_err(got, ref)
        if not err <= INT4_RTOL:
            raise AssertionError(f"K4[{name}] at M={m} disagrees with its plain version: {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"K4[{name}] at M={m}: two calls differ")
        report["rel_err"][m] = err
        cases[m] = (x, got, ref)
    x, got, ref = cases[decode_m]
    plan = plan_int4_decode(decode_m, k, n)
    groups = k // 2 // K4_GROUP_ROWS
    dropped = scales.clone()  # the last split's lo and hi groups
    first = (plan.ksplit - 1) * plan.groups_per_split
    dropped[first:groups] = 0
    dropped[groups + first:] = 0
    control = rel_err(got, matmul_int4_reference(x, packed, dropped, torch.float32))
    if not control > INT4_RTOL:
        raise AssertionError(f"K4[{name}]'s control (last split dropped) passes: {control}")
    count = max(2, -(-K4_COLD_BYTES // nbytes(packed, scales)))
    copies = [(packed, scales)] + [(packed.clone(), scales.clone()) for _ in range(count - 1)]
    times = {m: k4_times(cases[m][0], packed, scales, copies) for m in (decode_m, 1)}
    del copies
    for m, t in times.items():
        launched = t.pop("kernels_per_call")
        if launched is not None and not (len(launched) == 1 and "decode_kernel" in
                                         next(iter(launched)) and set(launched.values()) == {1}):
            raise AssertionError(f"K4[{name}] at M={m} is not one kernel a call: {launched}")
        t["one_kernel_per_call"] = None if launched is None else True
    plain_ms = cuda_ms(lambda: matmul_int4_reference(x, packed, scales, torch.bfloat16))
    main = times[decode_m]
    row = int4_row("matmul_int4", launch_key(k, n), K4_REPLACES, x, packed, scales, got, ref,
                   main.pop("ms"), plain_ms, 2 * decode_m * n, flops=2.0 * decode_m * k * n,
                   extra=(x,))
    row.update(main, M=decode_m, m1=times[1], bit_identical=True, control_rel_err=control,
               checked_rel_err=report["rel_err"], cold_copies=count,
               plan={"tile": plan.tile, "bn": plan.bn, "ksplit": plan.ksplit,
                     "groups_per_split": plan.groups_per_split, "grid": plan.grid,
                     "smem_bytes": plan.smem_bytes})
    cold = row["cold_device_ms"]
    print(f"K4[{name}] {row['shape']}: rel_err {report['rel_err']} within {INT4_RTOL}, two calls "
          f"bit-identical; control (last of {plan.ksplit} splits dropped) {control:.3e}; "
          f"tile {plan.bn} columns x {plan.ksplit} splits, {plan.grid} blocks; M={decode_m}: "
          f"event {row['ms']:.4f} ms warm / {row['cold_ms']:.4f} cold / {row['auto_ms']:.4f} "
          f"through matmul_int4_auto, device "
          f"{fmt_ms(row['device_ms'])} / {fmt_ms(cold)} cold"
          + ("" if cold is None else f" ({row['bound_ms'] / cold:.1%} of the bound)")
          + f", host {row['host_ms']:.4f} ms a call ({row['auto_host_ms']:.4f} through "
          f"matmul_int4_auto); M=1: event {times[1]['ms']:.4f} / {times[1]['cold_ms']:.4f}, "
          f"device {fmt_ms(times[1]['device_ms'])} / {fmt_ms(times[1]['cold_device_ms'])}")
    report.update(control_rel_err=control, plan=row["plan"])
    return row, report


def check_k5(name, x, packed, scales, gen):
    """K5 at one weight shape: check_k5_bits at M = x's rows and (k/v,
    gate/up) at the unpruned prefill's ragged M and the smallest prefill M
    (129); a control, the plain version with the lo and hi groups' scales
    swapped, must fail INT4_RTOL; one prep and one GEMM kernel per call
    wherever the trace measured it; the row's times, the prep's and the
    GEMM's device ms apart. -> (the kernels line's row, report)"""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        int4_a16_kernels,
        int4_prefill_a16_reference,
        launch_key,
        matmul_int4_prefill,
        plan_int4_a16,
    )

    m, k = x.shape
    n = packed.shape[1]
    got, ref, err = check_k5_bits(name, x, packed, scales)
    report = {"rel_err": {m: err}}
    control = rel_err(got, k5_plain(x, packed, scales, swap=True))
    if not control > INT4_RTOL:
        raise AssertionError(f"K5[{name}]'s control (lo and hi scales swapped) passes: {control}")
    if name in ("k_v", "gate_up"):
        for mm in (m - 2, 129):
            xm = torch.randn((mm, k), generator=gen, device="cuda").bfloat16()
            report["rel_err"][mm] = check_k5_bits(name, xm, packed, scales)[2]
        del xm
    ms = cuda_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=False))
    plain_ms = cuda_ms(lambda: int4_prefill_a16_reference(x, packed, scales, torch.bfloat16))
    row = int4_row("matmul_int4_prefill", launch_key(k, n, False), K56_REPLACES, x, packed,
                   scales, got, ref, ms, plain_ms, 2 * m * n, flops=2.0 * m * k * n, extra=(x,))
    launched = {}
    prep_ms, gemm_ms = prep_gemm_ms(lambda: int4_a16_kernels(x, packed, scales), launched)
    if launched and not (len(launched) == 2 and set(launched.values()) == {1}
                         and prep_ms is not None and gemm_ms is not None):
        raise AssertionError(f"K5[{name}] is not one prep and one GEMM kernel a call: {launched}")
    plan = plan_int4_a16(m, k, n)
    row.update(bit_identical=True, w16t_bit_equal=True, control_rel_err=control,
               checked_rel_err=report["rel_err"],
               device_ms=None if None in (prep_ms, gemm_ms) else prep_ms + gemm_ms,
               prep_device_ms=prep_ms, gemm_device_ms=gemm_ms,
               one_prep_one_gemm_per_call=True if launched else None,
               host_ms=host_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=False)),
               tile=f"{plan.bm}x{plan.bn}")
    device = row["device_ms"]
    print(f"K5[{name}] {row['shape']}: rel_err {report['rel_err']} within {INT4_RTOL}, W16^T "
          f"bit-equal, two calls bit-identical; control (lo and hi scales swapped) "
          f"{control:.3e}; device prep {fmt_ms(prep_ms)} + GEMM {fmt_ms(gemm_ms)} (tile "
          f"{row['tile']})" + ("" if device is None else
                               f", {row['bound_ms'] / device:.1%} of the bound, "
                               f"{device / row['bf16_matmul_ms']:.2f}x the bf16 matmul")
          + f"; host {row['host_ms']:.4f} ms to issue a call")
    report.update(control_rel_err=control, tile=row["tile"])
    return row, report


def check_int4_kernels(cfg, gen, decode_m: int, prefill_m: int, vit_m: int):
    """K4 at the decode shapes (check_k4), K5 (check_k5) and K6 at the
    decoder shapes with M = prefill_m, each against its plain version, and
    K5 at the ViT's qkv shape with M = vit_m (K = 1280: a shape the prefill
    gate admits). K6 is also held bit for bit to its plain version in bf16,
    its prep outputs to theirs, at M = prefill_m, and (gate/up, k/v) at the
    unpruned prefill's ragged M and the resume layers' M = 256; a plain
    version that truncates the requantized weights must fail INT4_RTOL.
    -> (rows, K4 report, K5 report, K6 report)"""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        int4_a8_kernels,
        int4_prefill_a8_reference,
        launch_key,
        matmul_int4_prefill,
        plan_int4_a8,
        requant_ratios,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    rows, k4_report, k5_report, k6_report = [], {}, {}, {}
    for name, (k, n) in decoder_shapes(cfg).items():
        packed, scales = int4_weight(k, n, gen)
        row, k4_report[name] = check_k4(name, packed, scales, decode_m, gen)
        rows.append(row)
        if name == "head":
            del packed, scales
            continue
        x = torch.randn((prefill_m, k), generator=gen, device="cuda").bfloat16()
        # K5 (W4A16): a prep to bf16 W16^T, then a bf16 tensor-core GEMM
        row, k5_report[name] = check_k5(name, x, packed, scales, gen)
        rows.append(row)
        # K6 (W4A8): the same int8 operands as the plain version, exact sums
        got = check_k6_bits(x, packed, scales)
        xq, xs = quantize_kv(x)
        xs = xs[:, None]
        s8, r = requant_ratios(scales)
        ref = int4_prefill_a8_reference(xq, xs, packed, r, s8, torch.float32)
        control = rel_err(got, k6_plain(x, packed, scales, trunc=True))
        if not control > INT4_RTOL:
            raise AssertionError(f"K6's control (q8 truncated) passes INT4_RTOL: {control}")
        ms = cuda_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=True))
        plain_ms = cuda_ms(lambda: k6_plain(x, packed, scales))
        row = int4_row("matmul_int4_prefill", launch_key(k, n, True), K56_REPLACES, x,
                       packed, r, got, ref, ms, plain_ms, 2 * prefill_m * n,
                       int8_ops=2.0 * prefill_m * k * n, extra=(xq, xs, s8))
        plan = plan_int4_a8(prefill_m, k, n)
        prep_ms, gemm_ms = prep_gemm_ms(lambda: int4_a8_kernels(x, packed, scales))
        row.update(bit_equal=True, control_rel_err=control,
                   device_ms=None if None in (prep_ms, gemm_ms) else prep_ms + gemm_ms,
                   prep_device_ms=prep_ms, gemm_device_ms=gemm_ms,
                   host_ms=host_ms(lambda: matmul_int4_prefill(x, packed, scales, a8=True)),
                   tile=f"{plan.bm}x{plan.bn}")
        print(f"K6[{name}] M={prefill_m}: bit-equal to its plain version, prep outputs equal; "
              f"control (q8 truncated) rel_err={control:.3e} > {INT4_RTOL}; device prep "
              f"{fmt_ms(prep_ms)} + GEMM {fmt_ms(gemm_ms)} (tile {row['tile']}); host "
              f"{row['host_ms']:.4f} ms to issue a call")
        rows.append(row)
        k6_report[name] = {"M": [prefill_m], "control_rel_err": control}
        if name in ("gate_up", "k_v"):
            # the unpruned prefill's rows (831 slots a row of batch (a)), the
            # resume layers' (out_len 128 a row)
            for m in (prefill_m - 2, 256):
                check_k6_bits(torch.randn((m, k), generator=gen, device="cuda").bfloat16(),
                              packed, scales)
                k6_report[name]["M"].append(m)
                print(f"K6[{name}] M={m}: bit-equal to its plain version, prep outputs equal")
        del packed, scales, x, xq, ref, got
    # the ViT's qkv product: JAX tiles its K = 1280 with bkp = 128
    k, n = cfg.vision.hidden_size, 3 * cfg.vision.hidden_size
    packed, scales = int4_weight(k, n, gen)
    x = torch.randn((vit_m, k), generator=gen, device="cuda").bfloat16()
    err = check_k5_bits("vit_qkv", x, packed, scales)[2]
    k5_report["vit_qkv"] = {"rel_err": {vit_m: err}, "K": k, "N": n}
    print(f"K5[vit_qkv] x[{vit_m},{k}] w4[{k // 2},{n}]: rel_err {err:.3e} within {INT4_RTOL}, "
          "W16^T bit-equal, two calls bit-identical")
    del packed, scales, x
    torch.cuda.empty_cache()
    return rows, k4_report, k5_report, k6_report


# phase (m)'s int4 shapes: each decoder linear as the mesh cuts it, by
# columns (the whole layer's route and, for K4, its tile and K split) or by
# repacked contraction rows
TP_INT4_SHAPES = {"q": ("q_o", "column"), "o": ("q_o", "row"), "k_v": ("k_v", "column"),
                  "gate_up": ("gate_up", "column"), "down": ("down", "row"),
                  "head": ("head", "column")}


def check_int4_tp_shards(cfg, gen, decode_m: int, prefill_m: int, world: int = SP_WORLD):
    """K4 and K6 at phase (m)'s shapes, every rank's shard of each decoder
    linear in this one process (TP_INT4_SHAPES; rows repacked by
    ``parallel.mesh._int4_rows``):

    - K4 at M = decode_m: a column shard, planned for the whole layer's N,
      bit-equal to the unsharded K4's columns; a row shard's fp32 sums (its
      f32 mode) within INT4_RTOL of its plain version, the unsharded K4's
      fp32 sums rounded to bf16 bit-equal to its bf16 output, and the
      ranks' fp32 sums added and rounded once against it (outputs that
      differ counted);
    - K6 at M = prefill_m: a column shard (routed on the whole layer's
      shape) bit-equal to the unsharded K6's columns; a row shard given the
      whole contraction's row scales and s8: its prep outputs and int32
      sums bit-equal to its plain version's, and the ranks' sums rescaled
      bit-equal to the unsharded K6.

    -> (kernel rows of rank 0's shards, timed by events and on the device,
    report)."""
    import torch

    from glimpseprune_torch.ops.cuda.int4_matmul import (
        a8_rescale,
        int4_a8_kernels,
        int4_a8_prep_reference,
        int4_decode,
        int8_gemm_tn_reference,
        launch_key,
        matmul_int4,
        matmul_int4_a8_sums,
        matmul_int4_prefill,
        matmul_int4_reference,
    )
    from glimpseprune_torch.parallel.mesh import _int4_rows, _narrow
    from glimpseprune_torch.parallel.sequence import SeqShard

    shapes = decoder_shapes(cfg)
    tps = [SeqShard(None, r, world) for r in range(world)]
    rows, report = [], {}
    for name, (key, mode) in TP_INT4_SHAPES.items():
        k, n = shapes[key]
        packed, scales = int4_weight(k, n, gen)
        if mode == "column":
            parts = [(_narrow(packed, 1, tp), _narrow(scales, 1, tp)) for tp in tps]
        else:
            parts = [_int4_rows(packed, scales, tp) for tp in tps]
        p0, s0 = parts[0]
        kl, nl = 2 * p0.shape[0], p0.shape[1]
        rec = {"shard": f"{kl}x{nl}", "mode": mode}
        # K4
        x = torch.randn((decode_m, k), generator=gen, device="cuda").bfloat16()
        whole = matmul_int4(x, packed, scales)
        if mode == "column":
            got = [int4_decode(x, p, s, n) for p, s in parts]
            if not torch.equal(torch.cat(got, -1), whole):
                raise AssertionError(f"K4[{name}]: the column shards differ from the "
                                     "unsharded K4's columns")
            x0 = x

            def call():
                return int4_decode(x0, p0, s0, n)
            rec["k4_columns_bit_equal"] = True
        else:
            xr = [x[:, tp.slice(k)].contiguous() for tp in tps]
            got = [int4_decode(xi, p, s, None, True) for xi, (p, s) in zip(xr, parts)]
            if not torch.equal(int4_decode(x, packed, scales, None, True).bfloat16(), whole):
                raise AssertionError(f"K4[{name}]: the fp32 sums rounded differ from K4's bf16")
            summed = got[0]
            for g in got[1:]:
                summed = summed + g
            x0 = xr[0]

            def call():
                return int4_decode(x0, p0, s0, None, True)
            rec["k4_rows_rounded_once_differ"] = int((summed.bfloat16() != whole).sum())
        ms, dev_ms = cuda_ms(call), device_ms(call)
        ref = matmul_int4_reference(x0, p0, s0, torch.float32)
        plain_ms = cuda_ms(lambda: matmul_int4_reference(x0, p0, s0, torch.float32))
        out_bytes = (4 if mode == "row" else 2) * decode_m * nl
        row = int4_row("matmul_int4", launch_key(kl, nl), K4_REPLACES, x0, p0, s0,
                       got[0].float(), ref, ms, plain_ms, out_bytes,
                       flops=2.0 * decode_m * kl * nl, extra=(x0,))
        row.update(tp_mode=mode, device_ms=dev_ms,
                   note=f"phase (m): rank 0's {mode} shard of {key}")
        rows.append(row)
        if name == "head":
            report[name] = rec
            continue
        # K6
        x = torch.randn((prefill_m, k), generator=gen, device="cuda").bfloat16()
        whole = check_k6_bits(x, packed, scales)
        if mode == "column":
            got = [matmul_int4_prefill(x, p, s, a8=True, whole=(k, n)) for p, s in parts]
            if not torch.equal(torch.cat(got, -1), whole):
                raise AssertionError(f"K6[{name}]: the column shards differ from the "
                                     "unsharded K6's columns")
            if not torch.equal(got[0], k6_plain(x, p0, s0)):
                raise AssertionError(f"K6[{name}]: a column shard differs from its plain version")
            x0 = x

            def call():
                return matmul_int4_prefill(x0, p0, s0, a8=True, whole=(k, n))
            plain_ms = cuda_ms(lambda: k6_plain(x0, p0, s0))
            got0, ref, out_bytes = got[0], k6_plain(x0, p0, s0), 2 * prefill_m * nl
            rec["k6_columns_bit_equal"] = True
        else:
            xs = x.abs().amax(-1).float().clamp(min=1e-8) / 127.0
            s8 = scales.float().amax(0).clamp(min=1e-12) * (7.0 / 127.0)
            xr = [x[:, tp.slice(k)].contiguous() for tp in tps]
            total = None
            for xi, (p, s) in zip(xr, parts):
                acc, prep = int4_a8_kernels(xi, p, s, xs, s8)
                torch.cuda.synchronize()
                want = int4_a8_prep_reference(xi, p, s, xs, s8)
                bad = [nm for nm, a, b in zip(("xq", "xs", "w8t", "s8"), prep, want)
                       if not torch.equal(a, b)]
                if bad:
                    raise AssertionError(f"K6[{name}] row shard: prep differs in {bad}")
                if not torch.equal(acc, int8_gemm_tn_reference(*want, torch.int32)):
                    raise AssertionError(f"K6[{name}] row shard: int32 sums differ from the "
                                         "plain version's")
                total = acc if total is None else total + acc
            if not torch.equal(a8_rescale(total, xs, s8, torch.bfloat16), whole):
                raise AssertionError(f"K6[{name}]: the row shards' sums rescaled differ from "
                                     "the unsharded K6")
            x0 = xr[0]

            def call():
                return matmul_int4_a8_sums(x0, p0, s0, xs, s8)
            plain_ms = cuda_ms(lambda: int8_gemm_tn_reference(
                *int4_a8_prep_reference(x0, p0, s0, xs, s8), torch.int32))
            got0 = a8_rescale(matmul_int4_a8_sums(x0, p0, s0, xs, s8), xs, s8, torch.float32)
            ref = a8_rescale(int8_gemm_tn_reference(*int4_a8_prep_reference(
                x0, p0, s0, xs, s8), torch.int32), xs, s8, torch.float32)
            out_bytes = 4 * prefill_m * nl
            rec["k6_rows_bit_equal"] = True
        ms = cuda_ms(call)
        prep_ms, gemm_ms = prep_gemm_ms(call)
        row = int4_row("matmul_int4_prefill", launch_key(kl, nl, True), K56_REPLACES, x0, p0,
                       s0, got0, ref, ms, plain_ms, out_bytes,
                       int8_ops=2.0 * prefill_m * kl * nl, extra=(x0,))
        row.update(tp_mode=mode, bit_equal=True,
                   device_ms=None if None in (prep_ms, gemm_ms) else prep_ms + gemm_ms,
                   prep_device_ms=prep_ms, gemm_device_ms=gemm_ms,
                   note=f"phase (m): rank 0's {mode} shard of {key}"
                   + (" (given row scales and s8, int32 sums)" if mode == "row" else ""))
        rows.append(row)
        report[name] = rec
        print(f"TP int4 shards [{name}] {json.dumps(rec)}", flush=True)
        del packed, scales, parts, x, whole, got
    torch.cuda.empty_cache()
    return rows, report


def k7_split_ms(call, k2_call):
    """K7's device ms of one call, its prep kernel and its attention kernel
    apart, beside K2's (or K9's) device ms at the same shape: {"prep",
    "attention", "k2"} (None where not measured). Raises unless each K7
    call launched one prep and one attention kernel."""
    per_call = {}
    by = device_ms_by_kernel(call, per_call=per_call)
    k2 = device_ms(k2_call)
    if by is None:
        return {"prep": None, "attention": None, "k2": k2}
    parts = {}
    for part, tag in (("prep", "i8::prep_kernel"), ("attention", "i8::attn_kernel")):
        names = [n for n in by if tag in n]
        if len(names) != 1 or per_call[names[0]] != 1:
            raise AssertionError(f"K7: {part} kernel launches per call {per_call}")
        parts[part] = by[names[0]]
    return {**parts, "k2": k2}


def check_k7_prep(q, k, v, qseg, kseg, causal, dense, pv, q_positions=None):
    """K7's prep kernel against its plain version: each output (q8, q_scale,
    k8, k_scale and, with pv_int8, V8^T and v_scale) torch.equal; and two
    calls of the whole kernel bit-identical. Raises otherwise."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        flash_attention_int8_kernels,
        flash_int8_prep_reference,
    )

    got, prep = flash_attention_int8_kernels(q, k, v, qseg, kseg, causal, dense, pv, q_positions)
    again, _ = flash_attention_int8_kernels(q, k, v, qseg, kseg, causal, dense, pv, q_positions)
    torch.cuda.synchronize()
    want = flash_int8_prep_reference(q, k, v, pv)
    names = ("q8", "q_scale", "k8", "k_scale", "v8t", "v_scale")
    bad = [n for n, a, b in zip(names, prep, want)
           if (a is None) != (b is None) or (a is not None and not torch.equal(a, b))]
    if bad:
        raise AssertionError(f"K7's prep differs from its plain version in {bad}")
    if not torch.equal(got, again):
        raise AssertionError("K7: two calls on the same inputs differ")


def check_flash_int8(cfg, prep_a, prep_b, gen):
    """K7 dense, segmented (the ViT's full attention on batches (b) and (a))
    and causal (the LLM's prefill on batch (a)), each with and without the
    int8 PV product, against the plain version at the kernel's kv tile.
    Controls: each output must fail the same check against the plain
    version of the other PV flavour and against bf16 attention (K2's plain
    version), or the check could not tell the int8 tiers apart. Each prep
    output equals its plain version, two calls are bit-identical, and the
    device ms of the prep and the attention kernel are printed apart beside
    K2's at the same shape -> (rows, {flavour: checks and split times})."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        KERNEL_BLOCK_K,
        flash_attention,
        flash_attention_int8,
        flash_attention_int8_reference,
        flash_attention_reference,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    v, t = cfg.vision, cfg.text

    def seg(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")

    cases = [
        ("vit_dense", "dense", 1, v.num_heads, v.num_heads, prep_b.patches.shape[0],
         v.head_dim, None, False),
        ("vit_segmented", "segmented", 1, v.num_heads, v.num_heads, prep_a.patches.shape[0],
         v.head_dim, seg(prep_a.full_seg[None]), False),
        ("llm_causal", "causal", prep_a.valid.shape[0], t.num_attention_heads,
         t.num_key_value_heads, prep_a.valid.shape[1], t.head_dim,
         seg(np.where(prep_a.valid, 0, -1)), True),
    ]
    rows, report = [], {}
    for name, fl, b, hq, hkv, s, d, segs, causal in cases:
        q, k, vv, pairs, mask = attention_case(gen, b, hq, hkv, s, d, d, segs, causal)
        dense = segs is None
        q8, qsc = quantize_kv(q)
        k8, ksc = quantize_kv(k)
        lib_ms = cuda_ms(lambda: sdpa(q, k, vv, mask))
        refs = {pv: flash_attention_int8_reference(q8, k8, vv, qsc, ksc, segs, segs, causal,
                                                   dense, pv, KERNEL_BLOCK_K, torch.float32)
                for pv in (False, True)}
        refs["bf16"] = flash_attention_reference(q.float(), k.float(), vv.float(), segs, segs,
                                                 causal=causal, dense=dense)
        for pv in (False, True):
            check_k7_prep(q, k, vv, segs, segs, causal, dense, pv)
            got = flash_attention_int8(q, k, vv, segs, segs, causal=causal, dense=dense,
                                       pv_int8=pv)
            torch.cuda.synchronize()
            ref = refs[pv]
            err = (got.float() - ref).abs().max().item()
            errs = rel_errors(got, ref)
            controls = {other: rel_errors(got, refs[other]) for other in (not pv, "bf16")}
            ms = cuda_ms(lambda: flash_attention_int8(q, k, vv, segs, segs, causal=causal,
                                                      dense=dense, pv_int8=pv))
            plain_ms = cuda_ms(lambda: flash_attention_int8_reference(
                q8, k8, vv, qsc, ksc, segs, segs, causal, dense, pv, KERNEL_BLOCK_K,
                torch.bfloat16))
            qk_ops, pv_ops = 2.0 * pairs * hq * d, 2.0 * pairs * hq * d
            bound_ms, bound_by = bound(0.0 if pv else pv_ops,
                                       nbytes(q8, k8, vv, qsc, ksc, got)
                                       + (0 if dense else 2 * segs.nbytes),
                                       qk_ops + (pv_ops if pv else 0.0))
            key = fl + ("+pv8" if pv else "")
            shape = f"{name} q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}]"
            names = {False: "int8 QK^T", True: "int8 QK^T + int8 PV", "bf16": "bf16"}
            print(f"K7 flash_attention_int8[{key}] {shape}: max_abs_err={err:.3e} "
                  f"rel_err={errs[0]:.3e} rms_rel_err={errs[1]:.3e}; against "
                  + ", ".join(f"{names[o]} (max/rms rel) {e[0]:.3e}/{e[1]:.3e}"
                              for o, e in controls.items())
                  + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if not rel_within(errs):
                raise AssertionError(f"K7 {key} disagrees with its plain version: {errs}")
            passed = [names[o] for o, e in controls.items() if rel_within(e)]
            if passed:
                raise AssertionError(f"K7 {key}: the check cannot tell the kernel from "
                                     f"{passed} attention")
            split = k7_split_ms(lambda: flash_attention_int8(
                q, k, vv, segs, segs, causal=causal, dense=dense, pv_int8=pv),
                lambda: flash_attention(q, k, vv, segs, segs, causal=causal, dense=dense))
            dev_ms = (None if split["prep"] is None
                      else split["prep"] + split["attention"])
            report[key] = {"prep_equal": True, "bit_identical": True, "device_ms": split}
            print(f"K7 flash_attention_int8[{key}] {shape}: on the card prep "
                  f"{fmt_ms(split['prep'])} + attention {fmt_ms(split['attention'])}, K2 "
                  f"{fmt_ms(split['k2'])}; prep outputs equal to the plain version's, two "
                  "calls bit-identical")
            rows.append({"name": f"flash_attention_int8[{key}]", "route": "cuda",
                         "source": K2_SRC, "replaces": K7_REPLACES[fl], "max_abs_err": err,
                         "rel_err": errs[0], "rms_rel_err": errs[1],
                         "control_rms_rel_err": min(e[1] for e in controls.values()),
                         "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                         "shape": shape})
        del q, k, vv, q8, k8, got, ref, refs
    torch.cuda.empty_cache()
    return rows, report


def qpos_shards(s: int):
    """(name, lo, hi) of the q shards K9 is checked on: 2 and 4 equal shards
    and one that no tile boundary aligns (tests/test_sp.py:70-78)."""
    return [(f"{n}x{i}", i * s // n, (i + 1) * s // n) for n in (2, 4) for i in range(n)] + [
        ("unaligned", 100, 160)]


def check_flash_qpos(cfg, prep_a, gen):
    """K9 (the q_positions flavours: forward, LSE, backward, int8) at batch
    (a)'s causal shape, q [2, 28, 832, 128] against kv of 4 heads with
    left-padded rows, its q rows cut into 2 and 4 shards and one unaligned
    shard. Each shard against the kernel's plain version, and against the
    monolithic K2 / K2-lse / K3 / K7 call over the whole sequence: the
    forward, the LSE, dq and the int8 output equal it bit for bit (each row
    visits the same k tiles in the same order); dk and dv, each shard's part
    rounded to bf16 and summed over the shards, within GRAD_RTOL. Control:
    K2 causal on a later shard alone (rows at their local index, keys of the
    shard only) must fail. Times at the upper half shard (world 2, rank 1);
    -> the kernels line's K9 rows."""
    import torch

    from glimpseprune_torch.ops.cuda.flash_attention import (
        KERNEL_BLOCK_K,
        allowed_mask,
        flash_attention,
        flash_attention_backward,
        flash_attention_backward_reference,
        flash_attention_int8,
        flash_attention_int8_reference,
        flash_attention_lse,
        flash_attention_lse_reference,
        flash_attention_reference,
    )
    from glimpseprune_torch.ops.kv_cache import quantize_kv

    t = cfg.text
    b, s = prep_a.valid.shape
    hq, hkv, d = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    seg = torch.as_tensor(np.where(prep_a.valid, 0, -1), dtype=torch.int32, device="cuda")
    q, k, v, _, _ = attention_case(gen, b, hq, hkv, s, d, d, seg, True)
    dout = torch.randn((b, s, hq, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
    mono = flash_attention(q, k, v, seg, seg, causal=True)
    mono_o, mono_lse = flash_attention_lse(q, k, v, seg, seg, causal=True)
    mono_grads = flash_attention_backward(q, k, v, seg, seg, mono_o, mono_lse, dout, causal=True)
    mono_i8 = {pv: flash_attention_int8(q, k, v, seg, seg, causal=True, pv_int8=pv)
               for pv in (False, True)}
    k8, ksc = quantize_kv(k)
    torch.cuda.synchronize()

    def shard(lo, hi):
        return (q[:, :, lo:hi], seg[:, lo:hi],
                torch.arange(lo, hi, dtype=torch.int32, device="cuda").expand(b, hi - lo)
                .contiguous())  # int32 and contiguous, as the SP path passes them

    report, dkv_sums = {}, {n: [0.0, 0.0] for n in (2, 4)}
    for name, lo, hi in qpos_shards(s):
        qs, qseg, qpos = shard(lo, hi)
        got = flash_attention(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
        out, lse = flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
        grads = flash_attention_backward(qs, k, v, qseg, seg, out, lse, dout[:, :, lo:hi],
                                         causal=True, q_positions=qpos)
        i8 = {pv: flash_attention_int8(qs, k, v, qseg, seg, causal=True, pv_int8=pv,
                                       q_positions=qpos) for pv in (False, True)}
        for pv in (False, True):  # the prep's outputs, and two calls bit-identical
            check_k7_prep(qs, k, v, qseg, seg, True, False, pv, qpos)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_attention_lse_reference(qs.float(), k.float(), v.float(), qseg,
                                                       seg, causal=True, q_positions=qpos)
        seen = ref_lse > -1e29
        ref_grads = flash_attention_backward_reference(
            qs.float(), k.float(), v.float(), qseg, seg, out.float(), lse,
            dout[:, :, lo:hi].float(), causal=True, q_positions=qpos)
        q8, qsc = quantize_kv(qs)
        i8_refs = {pv: flash_attention_int8_reference(q8, k8, v, qsc, ksc, qseg, seg, True,
                                                      False, pv, KERNEL_BLOCK_K, torch.float32,
                                                      qpos) for pv in (False, True)}
        r = {"fwd_err": (got.float() - ref_o).abs().max().item(),
             "lse_rel_err": rel_err(lse, ref_lse, seen),
             "bwd_rel_err": [rel_err(g, rr) for g, rr in zip(grads, ref_grads)],
             "bwd_k7_errs": [rel_errors(g, rr) for g, rr in zip(grads, ref_grads)],
             "bwd_abs_err": max((g.float() - rr).abs().max().item()
                                for g, rr in zip(grads, ref_grads)),
             "int8_errs": {pv: rel_errors(i8[pv], i8_refs[pv]) for pv in (False, True)},
             "int8_abs_err": (i8[False].float() - i8_refs[False]).abs().max().item(),
             "equal_to_monolithic": {
                 "forward": torch.equal(got, mono[:, :, lo:hi]),
                 "lse": torch.equal(lse, mono_lse[:, :, lo:hi]),
                 "dq": torch.equal(grads[0], mono_grads[0][:, :, lo:hi]),
                 "int8": torch.equal(i8[False], mono_i8[False][:, :, lo:hi]),
                 "int8+pv8": torch.equal(i8[True], mono_i8[True][:, :, lo:hi])}}
        report[name] = r
        if name != "unaligned":
            n = int(name.split("x")[0])
            dkv_sums[n] = [dkv_sums[n][0] + grads[1].float(), dkv_sums[n][1] + grads[2].float()]
        bad = [key for key, ok in r["equal_to_monolithic"].items() if not ok]
        if not (r["fwd_err"] <= KERNEL_ATOL and r["lse_rel_err"] <= LSE_RTOL
                and torch.equal(lse <= -1e29, ~seen) and max(r["bwd_rel_err"]) <= GRAD_RTOL
                and all(rel_within(e) for e in r["bwd_k7_errs"])
                and all(rel_within(e) for e in r["int8_errs"].values()) and not bad):
            raise AssertionError(f"K9 shard {name} [{lo}:{hi}] fails: {r}")
    for n, (dk, dv) in dkv_sums.items():
        errs = (rel_err(dk, mono_grads[1]), rel_err(dv, mono_grads[2]))
        report[f"dk_dv_sum_over_{n}_shards_rel_err"] = errs
        if not max(errs) <= GRAD_RTOL:
            raise AssertionError(f"K9: dk, dv summed over {n} shards differ from K3's: {errs}")
    # control: K2 causal on the last quarter alone
    lo, hi = 3 * s // 4, s
    control = flash_attention(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi], seg[:, lo:hi],
                              seg[:, lo:hi], causal=True)
    control_err = (control.float() - mono[:, :, lo:hi].float()).abs().max().item()
    report["control_k2_on_shard_err"] = control_err
    if control_err <= KERNEL_ATOL:
        raise AssertionError("K9: the check cannot tell a shard's global causal mask from K2's")
    print("K9 shards against the plain versions and the monolithic K2/K2-lse/K3/K7 "
          + json.dumps(report, default=str))

    # times at the upper half of the sequence (rank 1 of 2)
    lo, hi = s // 2, s
    qs, qseg, qpos = shard(lo, hi)
    ds = dout[:, :, lo:hi]
    allowed = allowed_mask(qseg, seg, b, hi - lo, s, True, False, "cuda", qpos)
    pairs, mask = int(allowed.sum()), allowed[:, None]
    seg_bytes = nbytes(qseg, seg, qpos)
    shape = f"q[{b},{hq},{hi - lo},{d}] rows {lo}:{hi} kv[{b},{hkv},{s},{d}]"
    out, lse = flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
    sdpa_ms = cuda_ms(lambda: sdpa(qs, k, v, mask))
    sdpa_dev_ms = device_ms(lambda: sdpa(qs, k, v, mask))
    rows = []

    def row(fn_name, ms, plain_ms, lib_ms, flops, nbytes_, int8_ops=0.0, **extra):
        bound_ms, bound_by = bound(flops, nbytes_ + seg_bytes, int8_ops)
        print(f"K9 {fn_name}[causal+qpos] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append({"name": f"{fn_name}[causal+qpos]", "route": "cuda",
                     "source": K3_SRC if fn_name == "flash_attention_backward" else K2_SRC,
                     "replaces": K9_REPLACES[fn_name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                     "shape": shape, **extra})

    half = report["2x1"]
    row("flash_attention",
        cuda_ms(lambda: flash_attention(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_reference(qs, k, v, qseg, seg, causal=True,
                                                  q_positions=qpos)),
        sdpa_ms, 4.0 * pairs * hq * d, nbytes(qs, k, v, out), max_abs_err=half["fwd_err"],
        equal_to_monolithic=half["equal_to_monolithic"]["forward"],
        device_ms=device_ms(lambda: flash_attention(qs, k, v, qseg, seg, causal=True,
                                                    q_positions=qpos)),
        library_device_ms=sdpa_dev_ms)
    row("flash_attention_lse",
        cuda_ms(lambda: flash_attention_lse(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_lse_reference(qs, k, v, qseg, seg, causal=True,
                                                      q_positions=qpos)),
        sdpa_ms, 4.0 * pairs * hq * d, nbytes(qs, k, v, out, lse), max_abs_err=half["fwd_err"],
        lse_rel_err=half["lse_rel_err"], equal_to_monolithic=half["equal_to_monolithic"]["lse"],
        device_ms=device_ms(lambda: flash_attention_lse(qs, k, v, qseg, seg, causal=True,
                                                        q_positions=qpos)),
        library_device_ms=sdpa_dev_ms)
    # the backward's controls and determinism at this shard
    bwd = check_backward("K9 backward", qs, k, v, qseg, seg, out, lse, ds, True, False, qpos)
    grads = bwd.pop("grads")
    print(f"K9 backward rows {lo}:{hi}: {bwd_summary(bwd)}")

    def bwd_call():
        return flash_attention_backward(qs, k, v, qseg, seg, out, lse, ds, causal=True,
                                        q_positions=qpos)

    lib_ms, lib_dev_ms = sdpa_backward_ms(qs, k, v, mask, ds)
    row("flash_attention_backward", cuda_ms(bwd_call),
        cuda_ms(lambda: flash_attention_backward_reference(qs, k, v, qseg, seg, out, lse, ds,
                                                           causal=True, q_positions=qpos)),
        lib_ms, 2.0 * pairs * hq * 5 * d, nbytes(qs, k, v, out, lse, ds, *grads),
        max_abs_err=half["bwd_abs_err"], rel_err=max(half["bwd_rel_err"]),
        k7_errs_dq_dk_dv=bwd["k7_errs_dq_dk_dv"], controls=bwd["controls"],
        deterministic=bwd["deterministic"],
        dk_dv_sum_rel_err=report["dk_dv_sum_over_2_shards_rel_err"],
        equal_to_monolithic=half["equal_to_monolithic"]["dq"],
        device_ms=device_ms(bwd_call), library_device_ms=lib_dev_ms)
    q8, qsc = quantize_kv(qs)
    got = flash_attention_int8(qs, k, v, qseg, seg, causal=True, q_positions=qpos)
    split = k7_split_ms(
        lambda: flash_attention_int8(qs, k, v, qseg, seg, causal=True, q_positions=qpos),
        lambda: flash_attention(qs, k, v, qseg, seg, causal=True, q_positions=qpos))
    report["int8_device_ms"] = split
    print(f"K9-int8 {shape}: on the card prep {fmt_ms(split['prep'])} + attention "
          f"{fmt_ms(split['attention'])}, K9 {fmt_ms(split['k2'])}; prep outputs equal to the "
          "plain version's and two calls bit-identical at every shard, int8 and int8+pv8")
    row("flash_attention_int8",
        cuda_ms(lambda: flash_attention_int8(qs, k, v, qseg, seg, causal=True, q_positions=qpos)),
        cuda_ms(lambda: flash_attention_int8_reference(q8, k8, v, qsc, ksc, qseg, seg, True,
                                                       False, False, KERNEL_BLOCK_K,
                                                       torch.bfloat16, qpos)),
        sdpa_ms, 2.0 * pairs * hq * d, nbytes(q8, k8, v, qsc, ksc, got),
        int8_ops=2.0 * pairs * hq * d, max_abs_err=half["int8_abs_err"],
        rel_err=half["int8_errs"][False][0], rms_rel_err=half["int8_errs"][False][1],
        equal_to_monolithic=half["equal_to_monolithic"]["int8"],
        device_ms=None if split["prep"] is None else split["prep"] + split["attention"])
    del q, k, v, dout, mono_grads, grads
    torch.cuda.empty_cache()
    return rows, report


QUANT_TIERS = {
    # name: (weight mode, quantized_config keywords, batches)
    "q8": ("int8", dict(act_quant="prefill"), ("a",)),
    "q4": ("int4", dict(act_quant="prefill", attn_qk_int8="vision", attn_pv_int8="vision"),
           ("a", "b")),
}


def quant_config(cfg, tier: str):
    import dataclasses

    from glimpseprune_torch.quantization import quantized_config

    mode, kw, _ = QUANT_TIERS[tier]
    q = quantized_config(cfg, mode, **kw)
    return dataclasses.replace(q, text=dataclasses.replace(q.text, kv_cache_quant="int8"))


def run_quant_tier(cfg, tier: str, cases, rows_a, rows_u, smi):
    """One quantized tier on a fresh random 7B: bf16 first logits, then
    quantize_model on the card and pruned + unpruned generate on each
    batch (every decode chunk's replays under sync_checked), then the
    decode checks on batch (a) and its rows, and in (q4) the
    continuous-serving phase on (a)'s rows (``rows_a`` pruned, ``rows_u``
    unpruned) -> (per-run records, launch counts, decode checks, the
    continuous-serving record or None)."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.kv_cache import cache_nbytes
    from glimpseprune_torch.quantization import quantize_model, quantized_bytes

    mode, _, batches = QUANT_TIERS[tier]
    qcfg = quant_config(cfg, tier)
    cases = [(n, p) for n, p in cases if n in batches]
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    bf16_bytes = quantized_bytes(model)
    runner = GlimpsePruneRunner(cfg, model)
    ref_logits = {(n, sel): runner.prefill(p, sel).logits.float().cpu()
                  for n, p in cases for sel in (True, False)}
    t0 = time.perf_counter()
    quantize_model(model, mode, cfg=qcfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    weight_bytes = quantized_bytes(model)
    print(f"{tier}: quantize_model({mode!r}) on the card in {quant_s:.1f} s: weights "
          f"{bf16_bytes / 1e9:.3f} GB bf16 -> {weight_bytes / 1e9:.3f} GB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    runner = GlimpsePruneRunner(qcfg, model)
    reset_launches()
    runs = []
    for name, prep in cases:
        for do_sel in (True, False):
            with sync_checked():  # the warm-up captures the decode step
                runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                torch.cuda.reset_peak_memory_stats()
                prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
                decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                    pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                    MAX_NEW_TOKENS, cfg.eos_token_id))
                generate_ms, res = timed_ms(lambda: runner.generate(
                    prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel))
                peak = torch.cuda.max_memory_allocated()
            check_outputs(qcfg, prep, pre, res, do_sel)
            t_cache = pre.valid.shape[1] + MAX_NEW_TOKENS
            kv_bytes = sum(cache_nbytes(runner.decode_cache(kv, t_cache))
                           for kv in (pre.kv_k, pre.kv_v))
            run = {"tier": tier, "batch": name, "mode": "pruned" if do_sel else "unpruned",
                   "B": int(prep.input_ids.shape[0]), "S": int(prep.input_ids.shape[1]),
                   "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS,
                   "generate_ms": generate_ms, "peak_mem_gib": peak / 2**30,
                   "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
                   "kv_len": int(pre.valid.shape[1]),
                   "first_logits_rel_dist_from_bf16": rel_err(
                       pre.logits.float().cpu(), ref_logits[(name, do_sel)])}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
            print("quantized path " + json.dumps(run))
            runs.append(run)
    torch.cuda.synchronize()
    required = ["window_attention_fused", "flash_attention[causal]",
                "flash_attention[dqk_ne_dv]"]
    if tier == "q4":
        required += ["matmul_int4[*]", "matmul_int4_prefill[a8,*]"] + [
            f"flash_attention_int8[{fl}+pv8]" for fl in ("dense", "segmented")]
    else:
        required += ["flash_attention[segmented]"]
    launches = read_launches(required)
    print(f"{tier} quantized-path launches " + json.dumps(launches))
    t1 = time.perf_counter()
    decode = run_decode_checks(qcfg, runner, dict(cases)["a"], rows_a, tier)
    t2 = time.perf_counter()
    continuous = (run_continuous_serving(qcfg, runner, dict(cases)["a"], rows_a, rows_u, tier,
                                         smi)
                  if tier == "q4" else None)
    t3 = time.perf_counter()
    lora = check_lora_q4(qcfg, model, rows_a[0]) if tier == "q4" else None
    print(f"{tier} tier seconds: main path {t1 - t0:.1f}, decode checks {t2 - t1:.1f}, "
          f"continuous serving {t3 - t2:.1f}, LoRA {time.perf_counter() - t3:.1f}", flush=True)
    del runner, model
    torch.cuda.empty_cache()
    return runs, launches, decode, continuous, lora


def check_small_quant(cfg_tier: str):
    """The tiny config in one quantized tier on the card (bf16 activations,
    the kernels, _int_mm) against the same quantized weights on the CPU
    (fp32, the plain versions), as check_small_reference does for bf16."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg = quant_config(tiny_test_config(), cfg_tier)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = prepare_inputs(cfg, make_prompts(cfg, rng, 2, 5, 400, (3, 6)), images,
                          seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    errs = {}
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        if do_sel:
            img_valid = torch.as_tensor(prep.img_valid)
            ref, got = ref[:, img_valid], got[:, img_valid]
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    errs["decode_logits"] = small_decode_err(ref_run, got_run, prep)
    print(f"tiny config {cfg_tier}, card bf16 vs CPU fp32, max error / max |ref|: "
          + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad:
        raise AssertionError(f"the card disagrees with the CPU reference in {cfg_tier}: {bad}")
    return errs


def same_weights(model, world: int) -> bool:
    """Every rank's per-tensor parameter sums (float64), all-gathered and
    compared: the ranks built the same weights."""
    import torch
    import torch.distributed as dist

    sums = torch.stack([p.detach().double().sum() for p in model.parameters()])
    parts = [torch.empty_like(sums) for _ in range(world)]
    dist.all_gather(parts, sums)
    return all(torch.equal(parts[0], p) for p in parts)


def launch_counts():
    """{row name: launches} so far (no kernel required)."""
    return read_launches([])


def launches_since(before, required=()):
    """Launches since the ``before`` snapshot; raises if a kernel of
    ``required`` did not launch in between (an entry that ends in "*]"
    asks for any launch of the rows it starts, as in read_launches)."""
    delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}

    def count(name):
        if name.endswith("*]"):
            return sum(v for k, v in delta.items() if k.startswith(name[:-2]))
        return delta.get(name, 0)

    missing = [k for k in required if not count(k)]
    if missing:
        raise AssertionError(f"the path never launched {missing}")
    return {k: v for k, v in delta.items() if v}


class CollectiveClock:
    """While open, counts the calls of ``dist.all_gather`` and
    ``dist.all_reduce`` (the only collectives of parallel/sequence.py) and
    their host time, the card synchronized at both ends of each call: the
    share of an SP prefill or train step that the ranks spend exchanging
    data. The synchronization serializes the card's queue, so the run it
    clocks is not the timed one."""

    NAMES = ("all_gather", "all_reduce")

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.calls, self.ms = 0, 0.0
        self.originals = {n: getattr(dist, n) for n in self.NAMES}

        def clocked(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
                return out
            return call

        for n, fn in self.originals.items():
            setattr(dist, n, clocked(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.originals.items():
            setattr(dist, n, fn)

    def record(self, total_ms: float) -> dict:
        return {"collectives": self.calls, "collective_ms": self.ms, "clocked_run_ms": total_ms}


def sp_expected_k9(cfg, prep, do_selection: bool, world: int) -> int:
    """K9 launches of one SP prefill by JAX's per-call-site rule: the layers
    before the keep policy over S slots and the resume layers over out_len
    (pruned), or every layer over S minus the glimpse slots (unpruned), each
    where the length divides over the ranks."""
    gp, n_layers = cfg.gp, cfg.text.num_hidden_layers
    s = prep.input_ids.shape[1]
    if not do_selection:
        s -= gp.le_length if gp.has_le else 0
        return n_layers if s % world == 0 else 0
    first = gp.reduce_layer + 1
    return ((first if s % world == 0 else 0)
            + (n_layers - first if prep.out_len % world == 0 else 0))


def sp_serve(cfg, runner, cases, rank, world, tier="bf16", modes=(True, False)):
    """Per batch and mode: rank 0 runs the single-process prefill and
    generate (the reference), then every rank runs them under SP, timed with
    CUDA events, with the kernels' launches of the SP prefill; -> records."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import sequence_parallel

    runs = []
    for name, prep in cases:
        for do_sel in modes:
            ref = None
            if rank == 0:  # the other ranks wait: this card's time is rank 0's alone
                runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                single_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
                res = runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                ref = (pre.logits.float().cpu(), pre.mask_logits, res, single_ms)
            dist.barrier()
            with sequence_parallel(dist.group.WORLD):
                runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                torch.cuda.reset_peak_memory_stats()
                before = launch_counts()
                prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
                prefill_launches = launches_since(before)
                decode_ms, _ = timed_ms(lambda: runner._decode_loop(
                    pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                    MAX_NEW_TOKENS, cfg.eos_token_id))
                res = runner.generate(prep, max_new_tokens=MAX_NEW_TOKENS, do_selection=do_sel)
                peak = torch.cuda.max_memory_allocated()
                with CollectiveClock() as clock:
                    clocked_ms, _ = timed_ms(lambda: runner.prefill(prep, do_sel))
            check_outputs(cfg, prep, pre, res, do_sel)
            k9 = prefill_launches.get("flash_attention[causal+qpos]", 0)
            k9 += prefill_launches.get("flash_attention_int8[causal+qpos]", 0)
            want = sp_expected_k9(cfg, prep, do_sel, world)
            if k9 != want:
                raise AssertionError(f"SP {tier} ({name}) launched K9 {k9} times in one "
                                     f"prefill, not {want}")
            run = {"rank": rank, "tier": tier, "batch": name,
                   "mode": "pruned" if do_sel else "unpruned", "S": int(prep.input_ids.shape[1]),
                   "out_len": int(prep.out_len), "prefill_ms": prefill_ms,
                   "decode_ms_per_token": decode_ms / MAX_NEW_TOKENS, "peak_mem_gib": peak / 2**30,
                   "k9_launches_per_prefill": k9, "prefill_launches": prefill_launches,
                   "prefill_collectives": clock.record(clocked_ms)}
            if do_sel:
                run["kept_img_tokens"] = res.keep_img.sum(1).tolist()
            if ref is not None:
                logits, mask, single, run["single_prefill_ms"] = ref
                run["first_logits_rel_diff"] = rel_err(pre.logits.float().cpu(), logits)
                run["tokens_equal_share"] = float((res.sequences == single.sequences).mean())
                if do_sel:
                    img_valid = torch.as_tensor(prep.img_valid, device=mask.device)
                    run["mask_logits_rel_diff"] = rel_err(pre.mask_logits[:, img_valid],
                                                          mask[:, img_valid])
                    run["single_kept_img_tokens"] = single.keep_img.sum(1).tolist()
                bad = {k: run[k] for k in ("first_logits_rel_diff", "mask_logits_rel_diff")
                       if not run.get(k, 0.0) <= 0.1}
                if bad:
                    raise AssertionError(f"SP {tier} ({name}) disagrees with one process: {bad}")
            print("sp path " + json.dumps(run), flush=True)
            runs.append(run)
    return runs


def sp_train(cfg, model, rank, work: Path, steps: int = 2):
    """The smoke's training batch 2 on a GPTrainer over the 7B: rank 0's
    single-process loss and gradients (the other ranks wait) against the
    same under SP, the SP gradients equal on every rank (each holds the
    whole gradient), then ``steps`` SP train steps, timed; -> (record, the
    loss-and-gradients call on that batch, for phase (m))."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import sequence_parallel
    from glimpseprune_torch.training.train_step import compute_loss

    trainer = make_trainer(cfg, model, work)
    batch = trainer.collate(trainer.cfg, next(trainer.dataset.batches(2, seed=0)),
                            trainer.tokenize, trainer.load_image, trainer.tcfg, device="cuda")
    params = trainer.optimizer.params

    def loss_and_grads():
        for p in params.values():
            p.grad = None
        total, _ = compute_loss(trainer.cfg, model, batch,
                                torch.Generator(device="cuda").manual_seed(0))
        total.backward()
        return total.item(), {k: p.grad.clone() for k, p in params.items()}

    single_ms, loss1, grads1 = None, None, None
    if rank == 0:  # the other ranks wait: this card's time is rank 0's alone
        loss_and_grads()  # warm-up
        single_ms, (loss1, grads1) = timed_ms(loss_and_grads)
    dist.barrier()
    with sequence_parallel(dist.group.WORLD):
        before = launch_counts()
        grad_ms, (loss2, grads2) = timed_ms(loss_and_grads)
        launches = launches_since(before, ["flash_attention_lse[causal+qpos]",
                                           "flash_attention_backward[causal+qpos]"])
        sums = torch.stack([g.double().sum() for g in grads2.values()])
        parts = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, sums)
        if not all(torch.equal(parts[0], p) for p in parts):
            raise AssertionError("the ranks' SP gradients differ")
        # rank 0 holds the single-process gradients; the others equal its SP ones
        errs = {k: rel_err(grads2[k], grads1[k]) for k in grads1} if rank == 0 else {}
        worst = max(errs, key=errs.get) if errs else None
        with CollectiveClock() as clock:
            clocked_ms, _ = timed_ms(loss_and_grads)
        step_records = []
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats()
            ms, metrics = timed_ms(lambda: trainer.step_fn(
                batch, torch.Generator(device="cuda").manual_seed(i)))
            step_records.append({"ms": ms, "loss": float(metrics["loss"]),
                                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    record = {"rank": rank, "S": int(batch["input_ids"].shape[1]),
              "patches": int(batch["patches"].shape[0]), "loss_single": loss1, "loss_sp": loss2,
              "loss_rel_diff": 0.0 if loss1 is None else abs(loss2 - loss1) / abs(loss1),
              "single_loss_and_grad_ms": single_ms, "sp_loss_and_grad_ms": grad_ms,
              "worst_grad_rel_diff": errs.get(worst, 0.0), "worst_grad": worst,
              "grad_rel_diff": errs, "steps": step_records, "launches": launches,
              "loss_and_grad_collectives": clock.record(clocked_ms)}
    print("sp train " + json.dumps({k: v for k, v in record.items() if k != "grad_rel_diff"}),
          flush=True)
    bad = [st for st in step_records if not np.isfinite(st["loss"])]
    if bad or not (record["worst_grad_rel_diff"] <= 0.1 and record["loss_rel_diff"] <= 0.1):
        raise AssertionError(f"SP training disagrees with one process: {worst} "
                             f"{record['worst_grad_rel_diff']}, loss {loss2} vs {loss1}, "
                             f"steps {step_records}")
    shutil.rmtree(work, ignore_errors=True)
    return record, loss_and_grads


def sp_rank(rank: int, world: int, cases):
    """Phase 11 on one rank: the 7B with the same random weights as every
    other rank (checked by checksum), SP generate in bf16 and q8, SP
    training, the tiny config under SP against the CPU; -> records."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.quantization import quantize_model
    from glimpseprune_torch.tools.common import depth_cut

    from glimpseprune_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    full = ModelConfig.load(str(ROOT / "configs" / "model_qwen2_5_7b_gp"))
    cfg = depth_cut(full, SP_TEXT_LAYERS)  # the bf16 7B's depth
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    if not same_weights(model, world):
        raise AssertionError(f"rank {rank} built other weights than rank 0")
    reset_launches()
    out = {"rank": rank, "gloo_gather_ms": gloo_gather_ms(cfg, cases[0][1], world),
           "serve": sp_serve(cfg, GlimpsePruneRunner(cfg, model), cases, rank,
                                           world)}
    t0 = time.perf_counter()
    out["sp_compressed"] = sp_compressed(cfg, model, cases[0][1], rank)
    sp_compressed_s = time.perf_counter() - t0
    out["train"], probe = sp_train(cfg, model, rank,
                                   ROOT / "build" / f"chip_smoke_sp_train{rank}")
    sp_launches = Counter(launch_counts())  # the SP rows: the SP runs alone
    # phase (m) on the trained bf16 7B: the mesh's groups, made once by every rank
    tp_mesh, dp_mesh = make_mesh(world, model_axis=world), make_mesh(world, model_axis=1)
    tp_launches = Counter()
    t0 = time.perf_counter()
    probes = (grpo_probe(cfg, model, cases[0][1]), compressed_probe(cfg, model, cases[0][1]))
    out["tp"] = {"bf16": tp_phase(cfg, model, cases[0][1], rank, tp_mesh, "bf16", probe,
                                  probes)}
    tp_launches.update(out["tp"]["bf16"]["launches"])
    tp_s = {"bf16": time.perf_counter() - t0}
    del model, probe, probes
    torch.cuda.empty_cache()
    qcfg = sp_q8_config(full)
    model = init_random(full, seed=0, device="cuda", dtype=torch.bfloat16)
    quantize_model(model, "int8", cfg=qcfg)
    before = launch_counts()
    out["q8"] = sp_serve(qcfg, GlimpsePruneRunner(qcfg, model), cases[:1], rank, world,
                         tier="q8", modes=(True,))
    sp_launches.update(launches_since(before))
    t0 = time.perf_counter()
    out["tp"]["q8"] = tp_phase(qcfg, model, cases[0][1], rank, tp_mesh, "q8")
    tp_launches.update(out["tp"]["q8"]["launches"])
    del model
    torch.cuda.empty_cache()
    tp_s["q8"] = time.perf_counter() - t0
    # (q4): int4 columns and repacked rows, K4 and K6 on the ranks' shards
    t0 = time.perf_counter()
    cut = depth_cut(full, QUANT_TEXT_LAYERS)  # phase 9's depth
    qcfg = quant_config(cut, "q4")
    model = init_random(cut, seed=0, device="cuda", dtype=torch.bfloat16)
    quantize_model(model, "int4", cfg=qcfg)
    out["tp"]["q4"] = tp_phase(qcfg, model, cases[0][1], rank, tp_mesh, "q4")
    tp_launches.update(out["tp"]["q4"]["launches"])
    del model
    torch.cuda.empty_cache()
    tp_s["q4"] = time.perf_counter() - t0
    # LLaVA-1.5-7B: its decoder sharded, CLIP and the projector whole
    t0 = time.perf_counter()
    lcfg, cc, _, _, lprep, _ = llava_inputs()
    model, _ = build_llava(lcfg, cc)
    out["tp"]["llava"] = tp_phase(lcfg, model, lprep, rank, tp_mesh, "llava")
    tp_launches.update(out["tp"]["llava"]["launches"])
    del model
    torch.cuda.empty_cache()
    tp_s["llava"] = time.perf_counter() - t0
    out["tiny"] = check_small_reference(dist.group.WORLD)
    t0 = time.perf_counter()
    before = launch_counts()
    out["tp"]["tiny"] = check_small_mesh(tp_mesh, dp_mesh)
    tp_launches.update(launches_since(before))
    tp_s["tiny"] = time.perf_counter() - t0
    out["tp"]["phase_s"] = sum(tp_s.values())
    out["tp"]["tier_s"] = tp_s
    out["sp_compressed_s"] = sp_compressed_s
    out["tp_launches"] = dict(tp_launches)
    out["launches"] = dict(sp_launches)
    print(f"phase (m) on rank {rank}: {out['tp']['phase_s']:.1f} s " + json.dumps(
        {k: round(v, 1) for k, v in tp_s.items()}) + f"; SP compressors {sp_compressed_s:.1f} s",
        flush=True)
    return out


def gloo_gather_ms(cfg, prep, world: int, iters: int = 10):
    """Host-clock ms of one gather_kv of this rank's K and V shard (bf16 on
    the card, through gloo) at the LLM's and the ViT's full-attention shape
    of ``prep``: what each sharded attention layer adds to the prefill."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import gather_kv, get_sequence_parallel, sequence_parallel

    t, v = cfg.text, cfg.vision
    b, s = prep.input_ids.shape
    # (shape of the stacked k and v shard, its sequence dim)
    shapes = {"llm": ((2, b, s // world, t.num_key_value_heads, t.head_dim), 2),
              "vit": ((2, prep.patches.shape[0] // world, v.num_heads, v.head_dim), 1)}
    out = {}
    with sequence_parallel(dist.group.WORLD):
        sp = get_sequence_parallel()
        for name, (shape, dim) in shapes.items():
            x = torch.randn(shape, device="cuda").bfloat16()
            gather_kv(x, dim, sp)  # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                gather_kv(x, dim, sp)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def sp_q8_config(cfg):
    """(q8) with the text tower's attention in int8 too (K9-int8 under SP)."""
    import dataclasses

    from glimpseprune_torch.quantization import quantized_config

    q = quantized_config(cfg, "int8", act_quant="prefill", attn_qk_int8="text")
    return dataclasses.replace(q, text=dataclasses.replace(q.text, kv_cache_quant="int8"))


def run_sp_path(cases):
    """Phase 11: SP_WORLD ranks on the one card over gloo, started by the
    port's launcher; -> (every rank's records, summed launches)."""
    from glimpseprune_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(sp_rank, SP_WORLD, cases, backend="gloo", timeout_s=900)
    secs = time.perf_counter() - t0
    required = ["flash_attention[causal+qpos]", "flash_attention_lse[causal+qpos]",
                "flash_attention_backward[causal+qpos]", "flash_attention_int8[causal+qpos]",
                "window_attention_fused", "flash_attention[segmented]"]
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                for k in set().union(*(r["launches"] for r in ranks))}
    missing = [k for k in required if not launches.get(k)]
    if missing:
        raise AssertionError(f"the SP path never launched {missing}")
    print(f"SP path over {SP_WORLD} ranks on one card (gloo) in {secs:.1f} s; launches, summed "
          "over the ranks: " + json.dumps(launches))
    return ranks, launches, secs


# ---- phase (m): the (data, model) mesh, inside phase 11's ranks

# the kernels a TP prefill must launch, per tier (the (q8) tier of phase
# 11 runs the text attention in int8: K7)
TP_KERNELS = {"bf16": ["window_attention_fused", "flash_attention[segmented]",
                       "flash_attention[causal]"],
              "q8": ["window_attention_fused", "flash_attention[segmented]",
                     "flash_attention_int8[causal]"],
              "q4": ["window_attention_fused", "flash_attention_int8[segmented+pv8]",
                     "flash_attention[causal]", "matmul_int4[*]", "matmul_int4_prefill[a8,*]"],
              "llava": ["flash_attention[causal]"]}
# the tiers whose mesh must give one process's row-parallel products bit
# for bit ((q8)'s W8A8, (q4)'s K6) and its tokens: (q8)'s all equal; (q4)'s
# decode products round once from fp32 partial sums (K4), so a token that
# differs must show phase 6's near tie against one process fed the mesh's
# tokens (token_ties). bf16 and LLaVA sum bf16 partial products: their
# decode is held to TP_DECODE_LOGIT_RTOL
TP_EXACT_TIERS = ("q8", "q4")
# phase (m)'s GRPO step: completion tokens of its fixed batch, and the
# compressors' greedy tokens a method on the mesh
TP_GRPO_TOKENS = 16
TP_COMPRESSED_TOKENS = 4
TP_TRAIN_KERNELS = ["flash_attention_lse[causal]", "flash_attention_backward[causal]"]
# tokens of each timed decode on the mesh: an eager TP step over gloo on
# one card takes ~0.2 s
TP_DECODE_TOKENS = 8
# bf16 decode on the mesh against the unsharded model fed its tokens: every
# step's logits, max error over max |ref| (phase 11's bound on SP's logits)
TP_DECODE_LOGIT_RTOL = 0.1
# a bf16 TP gradient tensor against one process's, max error over max |ref|:
# above the sound readings (the mesh and the split-sum witness) and below
# the control's, whose glimpse-embedding path lacks the input gradients'
# all-reduce (PERF.md section 6, PR 19)
TP_GRAD_TENSOR_RTOL = 0.4


def keep_ties(keep, ref_keep, mask, ref_mask, img_valid, threshold: float):
    """Where the mesh's keep set differs from one process's (bf16 partial
    sums: the keep policy's mask logits ``mask`` [B, N], the last of the
    prefill's, lie within delta of ``ref_mask``, delta their largest
    distance in the row), each token in one set and not the
    other must lie, by one process's own mask logit, within 2 delta of a
    boundary of the keep policy: the row's k-th largest logit (k the kept
    count: the cap's top-k) or the threshold's logit. A swap across a
    boundary needs that; a token further away shows a fault, not a tie.
    -> {"ties": bool, per row: differing tokens, delta, largest gap}."""
    import math

    out, ties = {}, True
    thr = math.log(threshold / (1.0 - threshold))
    for b in range(keep.shape[0]):
        valid = img_valid[b]
        diff = (keep[b] != ref_keep[b]) & valid
        if not diff.any():
            continue
        delta = (mask[b] - ref_mask[b]).abs()[valid].max().item()
        k = int(ref_keep[b].sum())
        kth = ref_mask[b][valid].topk(k).values[-1].item()
        gaps = [min(abs(v - kth), abs(v - thr)) for v in ref_mask[b][diff].tolist()]
        out[b] = {"differ": len(gaps), "delta": delta, "largest_gap": max(gaps)}
        ties = ties and max(gaps) <= 2 * delta
    out["ties"] = ties
    return out


def same_on_ranks(*tensors) -> bool:
    """Every rank holds the same values (float64 sums of each tensor,
    all-gathered)."""
    import torch
    import torch.distributed as dist

    sums = torch.stack([torch.as_tensor(t).double().sum().cpu() for t in tensors])
    parts = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, sums)
    return all(torch.equal(parts[0], p) for p in parts)


def tp_gloo_ms(cfg, prep, mesh, iters: int = 10):
    """Host-clock ms of the TP collectives of one layer, bf16 on the card
    through gloo: the row-parallel all-reduce of a prefill layer [B, S, H]
    and of a decode step [B, 1, H], and the all-gather of a decode step's
    vocab-parallel logits [B, 1, V / tp]."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.parallel import gather_seq
    from glimpseprune_torch.parallel.sequence import all_reduce_sum

    b, s = prep.input_ids.shape
    t, tp = cfg.text, mesh.model
    cases = {"all_reduce_prefill": (lambda x: all_reduce_sum(x, tp.group), (b, s, t.hidden_size)),
             "all_reduce_decode": (lambda x: all_reduce_sum(x, tp.group), (b, 1, t.hidden_size)),
             "all_gather_logits": (lambda x: gather_seq(x, -1, tp),
                                   (b, 1, t.vocab_size // tp.world))}
    out = {}
    for name, (fn, shape) in cases.items():
        x = torch.randn(shape, device="cuda").bfloat16()
        fn(x)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def tp_decode(cfg, runner, pre, n: int):
    """(ms per token, tokens fed at steps 0..n-1 [B, n], every step's
    logits [B, n, V] fp32) of n greedy steps of the runner's decode
    (``decode_steps``, eager under a gloo model group), eos never met."""
    import torch

    steps = runner.decode_steps(pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                                pre.valid.shape[1] + n, -1)
    logits = []

    def run():
        for _ in range(n):
            steps.run(1)
            logits.append(steps.logits.float().clone())

    ms, _ = timed_ms(run)
    return ms / n, steps.state.toks[:, :n].cpu(), torch.stack(logits, 1)


def forced_decode_err(model, cfg, pre, toks, logits) -> float:
    """The unsharded ``model`` fed ``toks`` [B, n] after its own prefill
    ``pre`` (``forced_decode_logits``) against the mesh's step logits [B,
    n, V]: max error over max |ref|."""
    return rel_err(logits, forced_decode_logits(model, cfg, pre, toks))


def token_ties(model, cfg, pre, toks, logits, want, tier):
    """Where the mesh's greedy tokens ``toks`` [B, n] (token 0 from the
    prefill, token j from step j - 1's ``logits`` [B, n, V]) differ from
    one process's ``want`` [B, n], phase 6's tie rule at each row's first
    token that differs (``first_difference``): the unsharded ``model``'s
    logits fed the mesh's tokens up to that step (the same history as both
    runs had) against the mesh's, within the bound of each other and both
    top twos closer than it, or raise. The bound is CROSS_LOGIT_RTOL, phase
    12's for two arithmetics of one decode: the unsharded model takes the
    n tokens at once (K4 at M = B n, not B; on an H100 the two read 1.5e-2
    apart at a flipped token, past DECODE_LOGIT_RTOL, its top two 1.4e-2
    apart). -> records."""
    ref = forced_decode_logits(model, cfg, pre, toks).float().cpu()
    got, toks, want = logits.float().cpu(), toks.cpu(), want.cpu()
    out = []
    for b in range(got.shape[0]):
        if toks[b, 0] != want[b, 0]:
            raise AssertionError(f"TP {tier} row {b}: the prefill's token differs")
        out.append(first_difference(f"TP {tier} row {b}", toks[b, 1:].numpy(),
                                    want[b, 1:].numpy(), got[b, :-1], ref[b, :-1],
                                    CROSS_LOGIT_RTOL))
    return out


def forced_decode_logits(model, cfg, pre, toks):
    """The unsharded ``model`` fed ``toks`` [B, n] after its own prefill
    ``pre`` (``decode_step`` with all n at once, causal among themselves,
    as ``small_decode_err``) -> each step's logits [B, n, V]."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    run = GlimpsePruneRunner(cfg, model)
    b, r = pre.valid.shape
    n = toks.shape[1]
    dev = pre.valid.device
    with torch.inference_mode():
        kv_valid = torch.cat([pre.valid, torch.ones((b, n), dtype=torch.bool, device=dev)], 1)
        pos = pre.position_ids[:, :, -1:] + 1 + torch.arange(n, device=dev)
        return model.decode_step(toks.to(dev), pos, run.decode_cache(pre.kv_k, r + n),
                                 run.decode_cache(pre.kv_v, r + n), kv_valid, r)[0]


@contextlib.contextmanager
def split_row_products(model, world: int):
    """One process's model computing each product that the mesh makes
    row-parallel (``parallel.mesh._TP_LAYERS``' "row" layers) as a mesh of
    ``world`` ranks does: ``world`` partial products over contiguous slices
    of the contraction, each rounded to the model's dtype, summed in fp32
    (``all_reduce_sum``) and rounded again, then the bias. The same
    function as the unsplit product in another order of summation: the
    witness of what that order alone moves."""
    import torch.nn.functional as F

    from glimpseprune_torch.models.layers import Linear
    from glimpseprune_torch.parallel.mesh import _TP_LAYERS
    from glimpseprune_torch.quantization import _jax_path

    rows = [m for name, m in model.named_modules() if isinstance(m, Linear)
            and _TP_LAYERS.get(_jax_path(name).removesuffix("/kernel"), ("", ""))[1] == "row"]

    def forward(self, x, a8=False):
        w = self.weight.to(x.dtype)
        y = sum(F.linear(xs, ws).float()
                for xs, ws in zip(x.chunk(world, -1), w.chunk(world, 1))).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)

    for m in rows:
        m.forward = forward.__get__(m)
    try:
        yield len(rows)
    finally:
        for m in rows:
            del m.forward


def tp_phase(cfg, model, prep, rank, mesh, tier, train=None, probes=()):
    """Phase (m) over one tier on this rank: rank 0's unsharded run first
    (the other ranks wait), then ``shard_params`` over the 1 x world mesh and
    TP prefill and eager decode, pruned and unpruned, each held against
    rank 0's unsharded run: first logits and mask logits within phase 11's
    bound (in bf16 the first logits within CROSS_LOGIT_RTOL) and the keep
    sets equal (in LLaVA, or flips at near ties: ``keep_ties``); in (q8)
    and (q4) a row-parallel product bit-equal and the decoded tokens equal
    (in (q4), or phase 6's near tie: ``token_ties``), in bf16 every
    decode step's logits within TP_DECODE_LOGIT_RTOL of the unsharded
    model's fed the mesh's tokens (rank 0 holds an unsharded copy for
    these, left out of its peak); the same on every rank. With ``train``
    (a loss-and-gradients call): its TP gradients against the unsharded ones, the global relative L2 within
    0.1 and every tensor within TP_GRAD_TENSOR_RTOL, where the witness
    (one process, the row-parallel products split as the mesh splits them:
    ``split_row_products``) must stay too and the control (the TP backward
    without the input gradients' all-reduce) must not. Each of ``probes``
    (name, run, compare) runs on rank 0 before ``shard_params`` and on
    every rank after it, and ``compare(mesh's, one process's)`` -> its
    record, or raises. Tiers: bf16, q8, q4 (TP_EXACT_TIERS), llava (as
    bf16, the decoder alone sharded); -> record. The model stays sharded. Launches of rank
    0's unsharded runs are not counted in the record's."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import sequence as seq_mod
    from glimpseprune_torch.parallel import shard_params

    down = model.text.layers[0].mlp.down_proj
    x = torch.randn((int(prep.valid.size), down.in_features), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)).bfloat16()
    with torch.inference_mode():
        y_whole = down(x, True)
    refs, train_ref, witness, whole, whole_bytes = {}, None, None, None, 0
    probe_refs = {}
    bf16_like = tier in ("bf16", "llava")
    n = TP_DECODE_TOKENS
    if rank == 0:  # the other ranks wait: this card's time is rank 0's alone
        runner = GlimpsePruneRunner(cfg, model)
        for do_sel in (True, False):
            ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
            runner._decode_loop(pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v,
                                n, -1)  # captures the step
            captured_ms, (seqs, _) = timed_ms(lambda: runner._decode_loop(
                pre.logits, pre.valid, pre.position_ids, pre.kv_k, pre.kv_v, n, -1))
            eager = eager_steps(cfg, runner, pre, pre.valid.shape[1] + n, n)
            eager_ms = timed_ms(lambda: eager.run(n))[0] / n
            refs[do_sel] = {"prefill_ms": ms, "captured_ms_per_token": captured_ms / n,
                            "eager_ms_per_token": eager_ms, "seqs": torch.as_tensor(seqs),
                            "pre": pre,
                            "logits": pre.logits.float().cpu(),
                            "mask": None if pre.mask_logits is None
                            else pre.mask_logits.float().cpu(),
                            "keep": None if pre.keep_img is None else pre.keep_img.cpu()}
        del runner, pre, eager
        if train is not None:
            ms, (loss, grads) = timed_ms(train)
            train_ref = (ms, loss, {k: g.cpu() for k, g in grads.items()})
            with split_row_products(model, mesh.shape["model"]) as n_split:
                if not n_split:
                    raise AssertionError("the witness split no product")
                _, (_, grads_w) = timed_ms(train)
            witness = {k: g.cpu() for k, g in grads_w.items()}
            del grads, grads_w
            for p in model.parameters():
                p.grad = None
        for name, run_probe, _ in probes:
            probe_refs[name] = run_probe()
        # the unsharded model for the decode check
        whole = copy.deepcopy(model)
        whole_bytes = sum(t.numel() * t.element_size()
                          for t in [*whole.parameters(), *whole.buffers()])
    dist.barrier()
    before_all = launch_counts()
    not_tp = Counter()  # rank 0's unsharded checks after this point
    shard_params(model, mesh)
    torch.cuda.empty_cache()
    tp = mesh.model
    runner = GlimpsePruneRunner(cfg, model)
    if runner.decode_mode != "eager":
        raise AssertionError(f"the decode under a gloo model group is {runner.decode_mode}")
    rows = slice(tp.rank * x.shape[1] // tp.world, (tp.rank + 1) * x.shape[1] // tp.world)
    with torch.inference_mode():
        y_tp = down(x[:, rows].contiguous(), True)
    heads = {"text_q": model.text.layers[0].self_attn.q_proj.out_features
             // cfg.text.head_dim, "text_kv": model.text.kv_heads}
    if hasattr(model.visual, "blocks"):  # Qwen's ViT (LLaVA's CLIP stays whole)
        heads["vit"] = model.visual.blocks[0].attn.qkv.out_features // (3 * cfg.vision.head_dim)
    rec = {"rank": rank, "tier": tier, "mesh": mesh.shape, "decode": runner.decode_mode,
           "local_heads": heads,
           "row_product_bit_equal": bool(torch.equal(y_tp, y_whole)),
           "row_product_rel_diff": rel_err(y_tp, y_whole),
           "gloo_ms": tp_gloo_ms(cfg, prep, mesh), "runs": []}
    if tier in TP_EXACT_TIERS and not rec["row_product_bit_equal"]:
        raise AssertionError(f"the row-parallel {tier} product differs from the unsharded one "
                             f"(rel {rec['row_product_rel_diff']})")
    for do_sel in (True, False):
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, do_sel))
        launches = launches_since(before, TP_KERNELS[tier]
                                  + (["flash_attention[dqk_ne_dv]"] if do_sel else []))
        decode_ms, seqs, step_logits = tp_decode(cfg, runner, pre, n)
        run = {"mode": "pruned" if do_sel else "unpruned", "prefill_ms": prefill_ms,
               "eager_decode_ms_per_token": decode_ms,
               "peak_mem_gib": (torch.cuda.max_memory_allocated() - whole_bytes) / 2**30,
               "prefill_launches": launches}
        if not same_on_ranks(pre.logits, seqs):
            raise AssertionError(f"TP {tier} ranks disagree ({run['mode']})")
        if rank == 0:
            ref = refs[do_sel]
            run.update({
                "single_prefill_ms": ref["prefill_ms"],
                "single_captured_ms_per_token": ref["captured_ms_per_token"],
                "single_eager_ms_per_token": ref["eager_ms_per_token"],
                "first_logits_rel_diff": rel_err(pre.logits.float().cpu(), ref["logits"]),
                "tokens_equal_share": float((seqs == ref["seqs"]).float().mean())})
            if do_sel:
                img_valid = torch.as_tensor(prep.img_valid)
                run["mask_logits_rel_diff"] = rel_err(pre.mask_logits.float().cpu()[:, img_valid],
                                                      ref["mask"][:, img_valid])
                run["keep_equal"] = bool(torch.equal(pre.keep_img.cpu(), ref["keep"]))
                run["kept"] = pre.keep_img.sum(1).tolist()
                if not run["keep_equal"] and tier == "llava":
                    run["keep_ties"] = keep_ties(pre.keep_img.cpu(), ref["keep"],
                                                 pre.mask_logits[-1].float().cpu(),
                                                 ref["mask"][-1],
                                                 torch.as_tensor(prep.img_valid),
                                                 cfg.gp.reduce_threshold)
            bad = {k: run[k] for k in ("first_logits_rel_diff", "mask_logits_rel_diff")
                   if not run.get(k, 0.0) <= 0.1}
            if bf16_like and not run["first_logits_rel_diff"] <= CROSS_LOGIT_RTOL:
                bad["first_logits_rel_diff"] = run["first_logits_rel_diff"]
            if do_sel and not run["keep_equal"] and not run.get("keep_ties", {}).get("ties"):
                bad["keep_equal"] = False
            if tier == "q8" and run["tokens_equal_share"] != 1.0:
                bad["tokens_equal_share"] = run["tokens_equal_share"]
            if tier == "q4" and run["tokens_equal_share"] != 1.0 and not bad:
                b = launch_counts()
                run["token_ties"] = token_ties(whole, cfg, ref["pre"], seqs, step_logits,
                                               ref["seqs"], tier)
                not_tp.update(launches_since(b))
            if bf16_like and not bad:  # one context on both sides
                b = launch_counts()
                run["decode_logits_rel_diff"] = forced_decode_err(whole, cfg, ref["pre"], seqs,
                                                                  step_logits)
                not_tp.update(launches_since(b))
                if not run["decode_logits_rel_diff"] <= TP_DECODE_LOGIT_RTOL:
                    bad["decode_logits_rel_diff"] = run["decode_logits_rel_diff"]
            if bad:
                print("tp path " + json.dumps(rec | {"runs": rec["runs"] + [run]}, default=str),
                      flush=True)
                raise AssertionError(f"TP {tier} ({run['mode']}) disagrees with one process: "
                                     f"{bad}")
        rec["runs"].append(run)
    del pre, refs, whole, step_logits
    torch.cuda.empty_cache()
    for name, run_probe, compare in probes:
        got = run_probe()
        rec[name] = compare(got, probe_refs.pop(name)) if rank == 0 else {
            k: v for k, v in got.items() if k in ("ms", "launches")}
    bad = None
    if train is not None:
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        ms, (loss, grads) = timed_ms(train)
        launches = launches_since(before, TP_TRAIN_KERNELS)
        if not same_on_ranks(*grads.values()):
            raise AssertionError("the ranks' TP gradients differ")
        rec["train"] = {"loss_and_grad_ms": ms, "loss": loss, "launches": launches,
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        # the control: the TP backward without the model axis' all-reduce of
        # the input gradients (each rank keeps its heads' share)
        whole_bwd = seq_mod._CopyToModel.backward
        seq_mod._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
        try:
            _, (_, grads_ctl) = timed_ms(train)
        finally:
            seq_mod._CopyToModel.backward = whole_bwd
        if rank == 0:
            single_ms, loss1, grads1 = train_ref
            rec["train"].update(single_loss_and_grad_ms=single_ms, single_loss=loss1,
                                loss_rel_diff=abs(loss - loss1) / abs(loss1),
                                **grad_distances(grads, grads1, "tp"),
                                **grad_distances(witness, grads1, "witness"),
                                **grad_distances(grads_ctl, grads1, "control"))
            t = rec["train"]
            worst = {tag: max(t[f"{tag}_worst_grads"].values())
                     for tag in ("tp", "witness", "control")}
            if not (t["tp_global_rel_l2"] <= 0.1 and t["loss_rel_diff"] <= 0.1
                    and worst["tp"] <= TP_GRAD_TENSOR_RTOL
                    and worst["witness"] <= TP_GRAD_TENSOR_RTOL
                    and t["control_global_rel_l2"] > 0.1
                    and worst["control"] > TP_GRAD_TENSOR_RTOL):
                bad = f"TP training disagrees with one process: {t}"
    launched = launches_since(before_all)
    rec["launches"] = {k: v - not_tp[k] for k, v in launched.items() if v > not_tp[k]}
    print("tp path " + json.dumps(rec, default=str), flush=True)
    if bad:
        raise AssertionError(bad)
    return rec


def broadcast_batch(batch):
    """Rank 0's tensors of a GRPOBatch on every rank (gloo broadcasts CUDA
    tensors through the host)."""
    import torch.distributed as dist

    for t in batch:
        dist.broadcast(t, 0)
    return batch


def grpo_probe(cfg, model, prep):
    """Phase (m)'s GRPO probe for tp_phase: a fixed GRPOBatch (the unsharded
    model's pruned glimpse of ``prep``, rank 0's on every rank, random
    completions of TP_GRPO_TOKENS and TP_GRPO_TOKENS - 5 tokens, non-zero
    advantages) and one ``make_grpo_loss_step`` over rank-GRPO_RANK
    adapters (``make_lora_params`` seed 0, B drawn small and non-zero) put
    into the model as it stands, reference logprobs first; the adapters are
    taken out after. Compared: the reference logprobs (max error over max
    |ref|), the total loss and every adapter's whole gradient (relative
    L2) within 0.1 of one process's; each tensor's max error and the KL
    term (small beside the surrogate, so its relative distance is large)
    are recorded."""
    import dataclasses

    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.training import grpo
    from glimpseprune_torch.training.lora import (
        _whole,
        insert_lora,
        lora_parameters,
        lora_tree,
        make_lora_params,
        remove_lora,
    )
    from glimpseprune_torch.training.train_step import AdamW

    out = GlimpsePruneRunner(cfg, model).glimpse(prep)
    rng = np.random.default_rng(GRPO_G)
    hi = min(150000, cfg.text.vocab_size)  # ordinary text ids, clear of the special tokens
    b, tc = out.valid.shape[0], TP_GRPO_TOKENS
    dev = out.valid.device
    steps = torch.arange(tc, device=dev)
    last = out.position_ids[:, :, -1].clone()  # the prefill's tensors are inference tensors
    batch = broadcast_batch(grpo.GRPOBatch(
        prompt_embeds=out.embeds.clone(), prompt_valid=out.valid.clone(),
        prompt_pos=out.position_ids.clone(),
        completion_ids=torch.as_tensor(rng.integers(min(1000, hi // 2), hi, (b, tc)), device=dev),
        completion_valid=steps[None] < torch.tensor([tc, tc - 5], device=dev)[:, None],
        completion_pos=last[:, :, None] + 1 + steps,
        advantages=torch.tensor([0.8, -1.1], device=dev),
        ref_logps=torch.zeros((b, tc), device=dev)))
    del out
    pcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_rank=GRPO_RANK,
                                                             remat=True))

    def run():
        lora = make_lora_params(model, rank=GRPO_RANK, seed=0)
        draw = np.random.default_rng(1)
        for ab in lora.values():
            ab["b"] = torch.as_tensor(draw.normal(0.0, 1e-3, tuple(ab["b"].shape)),
                                      dtype=torch.float32)
        insert_lora(model, lora, cfg=pcfg)
        params = lora_parameters(model)
        ref = grpo.compute_ref_logps(model, batch)
        step = grpo.make_grpo_loss_step(model, AdamW(params, GRPO_LR), 1.0, 0.04)
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        ms, metrics = timed_ms(lambda: step(batch._replace(ref_logps=ref)))
        launches = launches_since(before, ["flash_attention_lse[causal]",
                                           "flash_attention_backward[causal]"])
        grads = {n: _whole(model.get_submodule(n.rsplit(".", 1)[0]), n[-1], p.grad).float().cpu()
                 for n, p in params.items()}
        tree = lora_tree(model)
        moved = max(float((tree[p][k] - lora[p][k]).abs().max()) for p in lora for k in "ab")
        remove_lora(model)
        model.set_config(cfg)
        return {"ms": ms, "launches": launches, "metrics": {k: float(v) for k, v in
                                                            metrics.items()},
                "ref": ref.float().cpu(), "grads": grads, "max_update": moved,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    def compare(got, ref):
        valid = batch.completion_valid.cpu()
        rec = {"ms": got["ms"], "single_ms": ref["ms"], "launches": got["launches"],
               "peak_mem_gib": got["peak_mem_gib"], "metrics": got["metrics"],
               "single_metrics": ref["metrics"], "max_update": got["max_update"],
               "ref_logps_rel_diff": rel_err(got["ref"], ref["ref"], valid),
               "loss_rel_diff": abs(got["metrics"]["grpo_total"] - ref["metrics"]["grpo_total"])
               / max(abs(ref["metrics"]["grpo_total"]), 1e-30),
               **grad_distances(got["grads"], ref["grads"], "grpo")}
        print("tp grpo " + json.dumps(rec, default=str), flush=True)
        if not (rec["ref_logps_rel_diff"] <= 0.1 and rec["loss_rel_diff"] <= 0.1
                and rec["grpo_global_rel_l2"] <= 0.1 and got["max_update"] > 0):
            raise AssertionError(f"the GRPO step on the mesh disagrees with one process: {rec}")
        return rec

    return "grpo", run, compare


def vision_outputs(runner, prep):
    """(merged, taps, (received, keys_mean, received_local)): the ViT with
    the importance scores, as ``prefill_compressed`` runs it."""
    import torch

    with torch.inference_mode():
        return runner._vision(runner._device_inputs(prep), prep, emit_importance=True)


@contextlib.contextmanager
def fixed_vision(runner, vis):
    """``runner``'s compressors on the given ViT outputs ``vision_outputs``:
    what the selection and the LLM do with the same inputs, apart from how
    the ViT rounds them."""
    runner._vision = lambda inputs, prep, emit_importance=False: (
        vis if emit_importance else vis[:2])
    try:
        yield runner
    finally:
        del runner._vision


def vision_distances(got, ref):
    """Max error over max |ref| of the merged embeddings and each
    importance score."""
    return {"merged": rel_err(got[0], ref[0]),
            **{k: rel_err(g, r) for k, g, r in zip(("received", "keys_mean", "received_local"),
                                                   got[2], ref[2])}}


def compressed_runs(runner, prep, n_new: int):
    """{method: prefill ms, first logits, kept counts, keep set, tokens}
    of each compressor's ``prefill_compressed`` and n_new greedy tokens."""
    import torch

    out = {}
    for m in COMPRESSORS:
        kw = compressor_kwargs(m)
        ms, pre = timed_ms(lambda: runner.prefill_compressed(prep, m, **kw))
        seqs, _ = runner._decode_loop(pre.logits, pre.valid, pre.position_ids, pre.kv_k,
                                      pre.kv_v, n_new, -1)
        out[m] = {"prefill_ms": ms, "logits": pre.logits.float().cpu(),
                  "kept": pre.kept.tolist(), "seqs": torch.as_tensor(np.asarray(seqs)),
                  "keep": None if pre.keep_img is None else pre.keep_img.cpu()}
    return out


def compressed_distances(got, ref, bound: float, tag: str):
    """Per method: the distances of ``compressed_runs`` records; raises
    where the kept counts differ, the first logits are past ``bound`` or,
    for the four selections before the LLM, the keep sets differ."""
    import torch

    rec, bad = {}, {}
    for m in COMPRESSORS:
        g, r = got[m], ref[m]
        rec[m] = {"prefill_ms": g["prefill_ms"], "single_prefill_ms": r["prefill_ms"],
                  "first_logits_rel_diff": rel_err(g["logits"], r["logits"]),
                  "kept": g["kept"],
                  "tokens_equal_share": float((g["seqs"] == r["seqs"]).float().mean()),
                  "keep_equal": None if r["keep"] is None
                  else bool(torch.equal(g["keep"], r["keep"]))}
        if not (rec[m]["first_logits_rel_diff"] <= bound and g["kept"] == r["kept"]
                and rec[m]["keep_equal"] is not False):
            bad[m] = rec[m]
    if bad:
        raise AssertionError(f"{tag}: the compressors disagree with one process: {bad}")
    return rec


def end_to_end(got, ref):
    """What the compressors' end-to-end runs share with one process's,
    recorded: the ViT's rounding moves the selections at near-ties."""
    import torch

    return {m: {"keep_equal": None if ref[m]["keep"] is None
                else bool(torch.equal(got[m]["keep"], ref[m]["keep"])),
                "tokens_equal_share": float((got[m]["seqs"] == ref[m]["seqs"]).float().mean()),
                "first_logits_rel_diff": rel_err(got[m]["logits"], ref[m]["logits"])}
            for m in COMPRESSORS}


def compressed_probe(cfg, model, prep):
    """Phase (m)'s compressors probe for tp_phase. Rank 0 before sharding:
    the ViT's outputs and each compressor's run (``compressed_runs``,
    TP_COMPRESSED_TOKENS tokens). On the mesh, every rank: the ViT's
    outputs, held within TP_DECODE_LOGIT_RTOL of one process's; the
    compressors on one process's ViT outputs (rank 0's, broadcast), held
    to one process (``compressed_distances``: keep sets and kept counts
    equal, first logits within CROSS_LOGIT_RTOL). End to end, on the
    mesh's own ViT outputs, the compressors differ from one process by the
    ViT's distance alone (phase 11 records that under SP)."""
    import torch
    import torch.distributed as dist

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    one = {}

    def run():
        runner = GlimpsePruneRunner(cfg, model)
        if getattr(model, "mesh", None) is None:  # rank 0, one process
            one["vis"] = vision_outputs(runner, prep)
            return {"runs": compressed_runs(runner, prep, TP_COMPRESSED_TOKENS), "ms": 0.0}
        before = launch_counts()
        vis = vision_outputs(runner, prep)
        ref_vis = one.pop("vis", None)
        flat = [vis[0], *vis[2]]
        shared = ([t.contiguous() for t in [ref_vis[0], *ref_vis[2]]] if ref_vis is not None
                  else [torch.empty_like(t) for t in flat])
        with torch.inference_mode():
            for t in shared:
                dist.broadcast(t, 0)
        shared_vis = (shared[0], vis[1], tuple(shared[1:]))
        with fixed_vision(runner, shared_vis):
            fixed = compressed_runs(runner, prep, TP_COMPRESSED_TOKENS)
        return {"vis": vis, "ref_vis": shared_vis, "fixed": fixed,
                "launches": launches_since(before),
                "ms": sum(r["prefill_ms"] for r in fixed.values())}

    def compare(got, ref):
        rec = {"launches": got["launches"], "ms": got["ms"],
               "vision": vision_distances(got["vis"], got["ref_vis"])}
        bad = {k: v for k, v in rec["vision"].items() if not v <= TP_DECODE_LOGIT_RTOL}
        if bad:
            raise AssertionError(f"the ViT on the mesh disagrees with one process: {bad}")
        rec["fixed_vision"] = compressed_distances(got["fixed"], ref["runs"], CROSS_LOGIT_RTOL,
                                                   "TP")
        print("tp compressors " + json.dumps(rec, default=str), flush=True)
        return rec

    return "compressed", run, compare


def sp_compressed(cfg, model, prep, rank):
    """The five compressors under SP on every rank beside the same ranks'
    unsharded runs. The ViT's outputs under SP (its blocks on this rank's
    windows, the importance scores summed over the ranks' queries) held
    within phase 11's bound (0.1 of max |ref|) of the unsharded ones; the
    compressors on the unsharded ViT outputs under SP (their LLM prefill
    sharded where the compressed length divides, by JAX's per-call-site
    rule: K9 must launch in one method at least) held to the unsharded
    runs (``compressed_distances``: keep sets and kept counts equal, first
    logits within 0.1); then end to end under SP, recorded; -> record."""
    import torch.distributed as dist

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import sequence_parallel, sp_split

    runner = GlimpsePruneRunner(cfg, model)
    ref_vis = vision_outputs(runner, prep)
    ref = compressed_runs(runner, prep, COMPRESSED_NEW_TOKENS)
    dist.barrier()
    with sequence_parallel(dist.group.WORLD):
        if sp_split(prep.patches.shape[0], model.visual.window_patches) is None:
            raise AssertionError("the ViT of the compressors' batch does not shard under SP")
        before = launch_counts()
        vis = vision_outputs(runner, prep)
        with fixed_vision(runner, ref_vis):
            fixed = compressed_runs(runner, prep, COMPRESSED_NEW_TOKENS)
        k9 = launches_since(before).get("flash_attention[causal+qpos]", 0)
        runs = compressed_runs(runner, prep, COMPRESSED_NEW_TOKENS)
    rec = {"rank": rank, "vision": vision_distances(vis, ref_vis), "k9_launches": k9,
           "same_on_ranks": same_on_ranks(*[r["logits"] for r in runs.values()])}
    bad = {k: v for k, v in rec["vision"].items() if not v <= 0.1}
    if bad or not k9 or not rec["same_on_ranks"]:
        raise AssertionError(f"SP's ViT or compressors disagree with one process: {rec}")
    rec["fixed_vision"] = compressed_distances(fixed, ref, 0.1, "SP")
    rec["end_to_end"] = end_to_end(runs, ref)
    print("sp compressed " + json.dumps(rec, default=str), flush=True)
    return rec


def llava_inputs():
    """LLaVA-1.5-7B's config (capped at LLAVA_REMAIN_RATIO, its decoder cut
    to LLAVA_TEXT_LAYERS layers), CLIP config and phase 14's batch: (cfg,
    cc, images, prompts, prep, the random stream that drew them, for the
    phase's later draws)."""
    from glimpseprune_torch.models.llava.gp_model import load_llava_config
    from glimpseprune_torch.tools.common import depth_cut

    cfg, cc = load_llava_config(str(ROOT / LLAVA_DIR), with_text_tower=True)
    cfg = depth_cut(cfg.replace_gp(max_remain_ratio=LLAVA_REMAIN_RATIO), LLAVA_TEXT_LAYERS)
    rng = np.random.default_rng(LLAVA_SEED)
    images = [rng.integers(0, 256, (cc.image_size, cc.image_size, 3), dtype=np.uint8)
              for _ in LLAVA_PROMPT_TEXT]
    prompts = llava_prompts(cfg, rng)
    return cfg, cc, images, prompts, llava_prep(cfg, cc, images, prompts), rng


def grad_distances(got, ref, tag):
    """Distances of a gradient set from its reference: each tensor's max
    error over its max |ref| (the five largest), and the relative L2
    distance of them all, and of the glimpse embeddings' path alone."""
    import torch

    errs = {k: rel_err(got[k].cpu(), g) for k, g in ref.items()}
    top = dict(sorted(errs.items(), key=lambda kv: -kv[1])[:5])

    def l2(keys):
        num = sum(float((got[k].cpu().float() - ref[k].float()).square().sum()) for k in keys)
        den = sum(float(ref[k].float().square().sum()) for k in keys)
        return (num / max(den, 1e-30)) ** 0.5

    le = [k for k in ref if not k.startswith("attn_fuser")]
    return {f"{tag}_worst_grads": top, f"{tag}_global_rel_l2": l2(list(ref)),
            f"{tag}_glimpse_embedding_rel_l2": l2(le)}


def check_small_mesh(tp_mesh, dp_mesh):
    """The tiny config on the card against the same weights on the CPU, as
    ``check_small_reference``: one train step over the world x 1 data mesh
    (each rank its row of the batch, the gradients summed) against the CPU
    step on the whole batch (loss, every trainable gradient within 10%),
    and the continuous batcher over the 1 x world TP mesh, one row's pruned
    prefill admitted twice, 8 tokens: the prefill's first logits and mask
    logits within 10% of the CPU's, both requests' tokens equal, and each
    token within 10% of max |logit| of the top of the CPU's logits fed the
    card's tokens."""
    import torch

    from glimpseprune_torch.config import tiny_test_config
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.parallel import shard_params
    from glimpseprune_torch.serving import ContinuousBatcher
    from glimpseprune_torch.training.train_step import (
        AdamW,
        compute_loss,
        init_trainable,
        make_train_step,
        new_module_filter,
    )
    from glimpseprune_torch.training.trainer import batch_from_prep

    cfg = tiny_test_config()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (64, 96, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    answers = [[int(x) for x in rng.integers(5, 400, 4)] for _ in range(2)]
    prompts = make_prompts(cfg, rng, 2, 5, 400, (3, 6))
    prep = prepare_inputs(cfg, prompts, images,
                          normed_bboxes=[[[0.0, 0.0, 0.5, 1.0]], [[0.5, 0.5, 1.0, 1.0]]],
                          answer_ids=answers, seq_multiple=8, patch_multiple=16)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    for name, p in gpu_model.named_parameters():
        if not new_module_filter(name):
            p.data = p.data.bfloat16()
    serve_cpu = copy.deepcopy(cpu_model)
    serve_gpu = copy.deepcopy(gpu_model).bfloat16()
    trainable = init_trainable(cpu_model)
    total, _ = compute_loss(cfg, cpu_model, batch_from_prep(prep, "cpu"))
    total.backward()
    adamw = AdamW(init_trainable(gpu_model), 1e-3)
    metrics = make_train_step(cfg, gpu_model, adamw, mesh=dp_mesh)(batch_from_prep(prep, "cuda"))
    errs = {k: rel_err(adamw.params[k].grad.float().cpu(), p.grad) for k, p in trainable.items()}
    worst = max(errs, key=errs.get)
    out = {"dp_loss": float(metrics["loss"]), "cpu_loss": total.item(),
           "dp_worst_grad": worst, "dp_worst_grad_rel_diff": errs[worst]}
    out["dp_loss_rel_diff"] = abs(out["dp_loss"] - out["cpu_loss"]) / abs(out["cpu_loss"])

    row = prepare_inputs(cfg, prompts[:1], images[:1], seq_multiple=8, patch_multiple=16)
    n = 8
    ref_run = GlimpsePruneRunner(cfg, serve_cpu)
    runner = GlimpsePruneRunner(cfg, shard_params(serve_gpu, tp_mesh))
    got_pre, ref_pre = runner.prefill(row), ref_run.prefill(row)
    img_valid = torch.as_tensor(row.img_valid)
    out["tp_first_logits_rel_diff"] = rel_err(got_pre.logits.float().cpu(), ref_pre.logits)
    out["tp_mask_logits_rel_diff"] = rel_err(got_pre.mask_logits.float().cpu()[:, img_valid],
                                             ref_pre.mask_logits[:, img_valid])
    prefill = lambda: runner.prefill(row)[:5]
    b = ContinuousBatcher(runner, capacity=2, prefix_len=int(got_pre.valid.shape[1]),
                          max_new_tokens=n, inter_steps=4, eos=-1, max_requests=2)
    seqs, _, _, _ = b.serve([prefill] * 2)
    seqs = torch.as_tensor(np.asarray(seqs))
    out["tp_requests_equal"] = bool(torch.equal(seqs[0], seqs[1]))
    r = int(ref_pre.valid.shape[1])
    with torch.inference_mode():  # the CPU fed the card's tokens
        toks = seqs[:1, : n - 1]
        kv_valid = torch.cat([ref_pre.valid, torch.ones((1, n - 1), dtype=torch.bool)], 1)
        pos = ref_pre.position_ids[:, :, -1:] + 1 + torch.arange(n - 1)
        t = r + n - 1
        ref = ref_run.model.decode_step(toks, pos, ref_run.decode_cache(ref_pre.kv_k, t),
                                        ref_run.decode_cache(ref_pre.kv_v, t), kv_valid,
                                        r)[0][0]
    ref = torch.cat([ref_pre.logits[0, -1:].float(), ref.float()])  # [n, V]: token i's
    picked = ref.gather(-1, seqs[0, :, None]).squeeze(-1)
    out["tp_token_gap_rel"] = ((ref.max(-1).values - picked).max() / ref.abs().max()).item()
    print("tiny config on the mesh, card bf16 vs CPU fp32: " + json.dumps(out), flush=True)
    bad = {k: v for k, v in out.items() if k.endswith(("rel_diff", "gap_rel")) and not v <= 0.1}
    if bad or not out["tp_requests_equal"]:
        raise AssertionError(f"the mesh on the card disagrees with the CPU reference: {out}")
    return out


# ---- phase 14: LLaVA-1.5-7B

LLAVA_DIR = "configs/model_llava1_5_7b_gp"
LLAVA_SEED = 0
LLAVA_PROMPT_TEXT = ((12, 17), (12, 9))  # text ids before and after the image marker a row
LLAVA_CDP_KEEP = 64  # CDPruner's budget with the CLIP-text relevance
LLAVA_Q8_TOKENS = 16
LLAVA_TRAIN_STEPS = 2
LLAVA_TRAIN_LR = 1e-4
LLAVA_KERNELS = ["flash_attention[causal]", "flash_attention[dqk_ne_dv]"]
# Qwen2.5-VL-7B's cap (configs/model_qwen2_5_7b_gp): the random fuser's
# mask logits pass the 0.5 threshold everywhere, and the published LLaVA
# config has no cap, so without one the pruned run would keep all 576
LLAVA_REMAIN_RATIO = 0.111


def llava_prompts(cfg, rng):
    """One row per LLAVA_PROMPT_TEXT entry: random text ids (clear of the
    special ids at the vocabulary's top), the image marker, more text."""
    return [[int(x) for x in rng.integers(3, 31000, a)] + [cfg.image_token_id]
            + [int(x) for x in rng.integers(3, 31000, b)] for a, b in LLAVA_PROMPT_TEXT]


def hf_llava_shapes(cfg, cc):
    """(name, shape) of every tensor of an HF LLaVA-1.5 checkpoint in the
    merged layout, the CLIP tower being a CLIPVisionModelWithProjection
    (``visual_projection`` and ``post_layernorm`` for CDPruner); and of a
    CLIPTextModelWithProjection. Written out from HF's module names, not
    derived from the port's."""
    t, d = cfg.text, cc.hidden_size
    clip = "model.vision_tower.vision_tower.vision_model."

    def block(prefix, h, inter):
        out = []
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{prefix}.self_attn.{p}.weight", (h, h)), (f"{prefix}.self_attn.{p}.bias", (h,))]
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{prefix}.{ln}.weight", (h,)), (f"{prefix}.{ln}.bias", (h,))]
        return out + [(f"{prefix}.mlp.fc1.weight", (inter, h)), (f"{prefix}.mlp.fc1.bias", (inter,)),
                      (f"{prefix}.mlp.fc2.weight", (h, inter)), (f"{prefix}.mlp.fc2.bias", (h,))]

    llava = [(clip + "embeddings.patch_embedding.weight", (d, 3, cc.patch_size, cc.patch_size)),
             (clip + "embeddings.class_embedding", (d,)),
             (clip + "embeddings.position_embedding.weight", (cc.grid ** 2 + 1, d)),
             (clip + "pre_layrnorm.weight", (d,)), (clip + "pre_layrnorm.bias", (d,)),
             (clip + "post_layernorm.weight", (d,)), (clip + "post_layernorm.bias", (d,)),
             ("visual_projection.weight", (cc.projection_dim, d))]
    for i in range(cc.depth):
        llava += block(f"{clip}encoder.layers.{i}", d, cc.intermediate_size)
    h = t.hidden_size
    llava += [("model.mm_projector.0.weight", (h, d)), ("model.mm_projector.0.bias", (h,)),
              ("model.mm_projector.2.weight", (h, h)), ("model.mm_projector.2.bias", (h,)),
              ("model.embed_tokens.weight", (t.vocab_size, h)), ("model.norm.weight", (h,)),
              ("lm_head.weight", (t.vocab_size, h))]
    dkv = t.num_key_value_heads * t.head_dim
    for i in range(t.num_hidden_layers):
        p = f"model.layers.{i}"
        llava += [(f"{p}.self_attn.q_proj.weight", (h, h)), (f"{p}.self_attn.k_proj.weight", (dkv, h)),
                  (f"{p}.self_attn.v_proj.weight", (dkv, h)), (f"{p}.self_attn.o_proj.weight", (h, h)),
                  (f"{p}.mlp.gate_proj.weight", (t.intermediate_size, h)),
                  (f"{p}.mlp.up_proj.weight", (t.intermediate_size, h)),
                  (f"{p}.mlp.down_proj.weight", (h, t.intermediate_size)),
                  (f"{p}.input_layernorm.weight", (h,)),
                  (f"{p}.post_attention_layernorm.weight", (h,))]
    th = cc.text_hidden_size
    text = [("text_model.embeddings.token_embedding.weight", (cc.text_vocab_size, th)),
            ("text_model.embeddings.position_embedding.weight", (cc.text_max_positions, th)),
            ("text_model.final_layer_norm.weight", (th,)),
            ("text_model.final_layer_norm.bias", (th,)),
            ("text_projection.weight", (cc.projection_dim, th))]
    for i in range(cc.text_depth):
        text += block(f"text_model.encoder.layers.{i}", th, cc.text_intermediate_size)
    return llava, text


def hf_random_state(shapes, gen):
    """Random bf16 tensors on the card at init_random's scales: matrices
    normal / sqrt(fan_in), token embeddings normal / sqrt(hidden), CLIP's
    class and position embeddings normal(0.02), biases 0, norm scales 1."""
    import torch

    out = {}
    for name, shape in shapes:
        t = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        if name.endswith(("class_embedding", "position_embedding.weight")):
            t.normal_(0.0, 0.02, generator=gen)
        elif name.endswith(("embed_tokens.weight", "token_embedding.weight")):
            t.normal_(0.0, shape[1] ** -0.5, generator=gen)
        elif name.endswith(".bias"):
            t.zero_()
        elif len(shape) == 1:
            t.fill_(1.0)
        else:
            t.normal_(0.0, float(np.prod(shape[1:])) ** -0.5, generator=gen)
        out[name] = t
    return out


def build_llava(cfg, cc):
    """The 7B through the HF converters: random HF-layout dicts on the card
    -> convert_llava_state_dict + convert_clip_text -> init_random(base=),
    which draws the glimpse modules. Every HF tensor must be taken, every
    base parameter loaded (without a copy but for the fp32 LayerNorms),
    the GlimpsePrune modules alone drawn. -> (model, record)."""
    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.llava.convert import convert_clip_text, convert_llava_state_dict
    from glimpseprune_torch.quantization import quantized_bytes
    from glimpseprune_torch.training.train_step import new_module_filter

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(LLAVA_SEED)
    llava_shapes, text_shapes = hf_llava_shapes(cfg, cc)
    hf = {**hf_random_state(llava_shapes, gen), **hf_random_state(text_shapes, gen)}
    hf_bytes = nbytes(*hf.values())
    state = {**convert_llava_state_dict(hf, cfg, cc), **convert_clip_text(hf, cc)}
    unused = sorted(set(v.data_ptr() for v in hf.values())
                    - set(v.data_ptr() for v in state.values()))
    model = init_random(cfg, LLAVA_SEED, "cuda", torch.bfloat16, clip_cfg=cc, base=state)
    torch.cuda.synchronize()
    slots = model.state_dict()
    drawn = sorted(set(slots) - set(state))
    copied = sorted(k for k, v in state.items() if slots[k].data_ptr() != v.data_ptr()
                    and slots[k].dtype == v.dtype)
    # the fp32 LayerNorms: a copy up to fp32, which must hold the dicts' values
    changed = sorted(k for k, v in state.items() if slots[k].dtype != v.dtype
                     and not torch.equal(slots[k], v.to(slots[k].dtype)))
    rec = {"hf_tensors": len(hf), "hf_bytes": hf_bytes, "converted": len(state),
           "drawn": len(drawn), "weight_bytes": quantized_bytes(model),
           "build_s": time.perf_counter() - t0,
           "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    print("phase 14 weights " + json.dumps(rec))
    del hf, state
    if unused:
        raise AssertionError(f"the converters left {len(unused)} HF tensors unused")
    if not drawn or not all(new_module_filter(k) for k in drawn):
        raise AssertionError(f"parameters not loaded from the HF dicts: "
                             f"{[k for k in drawn if not new_module_filter(k)][:5]}")
    if copied:
        raise AssertionError(f"base weights copied, not taken: {copied[:5]}")
    if changed:
        raise AssertionError(f"base weights changed on loading: {changed[:5]}")
    return model, rec


def llava_prep(cfg, cc, images, prompts, **kw):
    from glimpseprune_torch.models.llava.runner import prepare_llava_inputs

    return prepare_llava_inputs(cfg, cc, prompts, images, **kw)


@contextlib.contextmanager
def replays():
    """A one-element list that counts the steps every StepGraph.run
    replays while open."""
    from glimpseprune_torch.models.qwen2_5_vl import decode_graph

    run, count = decode_graph.StepGraph.run, [0]

    def counting(self, n, rng=None):
        count[0] += n
        return run(self, n, rng)

    decode_graph.StepGraph.run = counting
    try:
        yield count
    finally:
        decode_graph.StepGraph.run = run


def greedy_with_logits(runner, pre, n: int):
    """n greedy tokens of the runner's captured step over a B-row prefill,
    replayed one step at a time: (tokens [B, n], logits [n][B, V]), token
    j from logits[j] (the prefill's last logits, then each step's)."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.decode_graph import StepGraph

    logits, valid, pos, kv_k, kv_v = tuple(pre[:5])
    steps = runner.decode_steps(logits, valid, pos, kv_k, kv_v, valid.shape[1] + n, -1)
    if not isinstance(steps, StepGraph):
        raise AssertionError("the card's decode did not run a captured step")
    lg = [logits[:, -1].float()]
    for _ in range(n - 1):
        steps.run(1)
        lg.append(steps.logits.float().clone())
    toks = torch.cat([steps.state.toks[:, :n - 1], steps.state.tok[:, None]], 1)
    return toks.cpu().numpy(), lg


def check_llava_all_kept(cfg, model, images, prompts):
    """JAX test_llava_gp_generate at full width: reduce_threshold -1 and no
    ratio cap keep all 576 tokens a row, and each row's greedy tokens of
    the pruned run against the unpruned run's pass phase 12's
    ``cross_check``: two arithmetics of one function (the pruned prefill
    runs S = 640 rows and the glimpse slot through layers 0-21, then a
    compacted cache; the unpruned one 639 rows: other GEMM shapes, other
    key counts), so every step's logits up to the first token that differs
    within CROSS_LOGIT_RTOL, and the tie rule at that bound. -> record."""
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cfg_all = cfg.replace_gp(reduce_threshold=-1.0, max_remain_ratio=None)
    prep = llava_prep(cfg_all, model.clip_cfg, images, prompts)
    runner = GlimpsePruneRunner(cfg_all, model.set_config(cfg_all))
    try:
        pruned, unpruned = runner.prefill(prep, True), runner.prefill(prep, False)
        kept = pruned.keep_img.sum(1).tolist()
        if kept != [int(n) for n in prep.n_img_tokens]:
            raise AssertionError(f"all-kept prefill kept {kept}")
        (got, got_lg), (want, want_lg) = (greedy_with_logits(runner, p, MAX_NEW_TOKENS)
                                          for p in (pruned, unpruned))
    finally:
        model.set_config(cfg)
    rec = {"kept": kept, "tokens_equal": bool((got == want).all()),
           "first_logits_rel_dist": rel_err(pruned.logits, unpruned.logits),
           "rows": [cross_check(f"all-kept row {b}", got[b], want[b],
                                [x[b] for x in got_lg], [x[b] for x in want_lg])
                    for b in range(got.shape[0])]}
    print("phase 14 all-kept equivalence " + json.dumps(rec))
    return rec


def check_small_llava():
    """The tiny LLaVA config (tests/test_llava.py's shapes; 56-pixel
    images, one padded to a square, so no resize) on the card, bf16 with
    the kernels, against the same weights on the CPU in fp32 with the
    plain versions: the unpruned first logits, the mask logits and 8
    captured decode steps within phase 6's 10% of max |ref|, the same keep
    sets and the same greedy tokens, pruned and unpruned."""
    import dataclasses

    import torch

    from glimpseprune_torch.config import GPConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.llava.gp_model import (CLIPTowerConfig, llama_text_config,
                                                          llava_config)
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    cc = CLIPTowerConfig(depth=3, hidden_size=32, num_heads=4, intermediate_size=64,
                         patch_size=14, image_size=56)
    text = llama_text_config(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                             num_attention_heads=4, num_key_value_heads=4, vocab_size=512,
                             rms_norm_eps=1e-6)
    gp = GPConfig(selected_layers=(1,), reduce_layer=1, selected_visual_layers=(1, 0),
                  attn_fuse_size=16, visual_cond_size=16, attn_fuse_num_heads=4,
                  attn_fuse_global=True, le_layers=(0, 1, 2), le_length=1, max_remain_ratio=0.5)
    cfg = dataclasses.replace(llava_config(clip=cc, text=text, gp=gp), image_token_id=500,
                              eos_token_id=502, pad_token_id=0)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (40, 56, 3), dtype=np.uint8),
              rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)]
    prep = llava_prep(cfg, cc, images, [[7, 8, 500, 9, 10], [11, 500, 12, 13, 14, 15]],
                      seq_multiple=8)
    cpu_model = init_random(cfg, seed=1, device="cpu", dtype=torch.float32, clip_cfg=cc)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", dtype=torch.bfloat16)
    ref_run, got_run = GlimpsePruneRunner(cfg, cpu_model), GlimpsePruneRunner(cfg, gpu_model)
    errs = {}
    for do_sel, field in ((False, "logits"), (True, "mask_logits")):
        ref = getattr(ref_run.prefill(prep, do_sel), field).float()
        got = getattr(got_run.prefill(prep, do_sel), field).float().cpu()
        errs[field] = ((got - ref).abs().max() / ref.abs().max()).item()
    errs["decode_logits"] = small_decode_err(ref_run, got_run, prep)
    same = {}
    for do_sel in (True, False):
        ref, got = (r.generate(prep, max_new_tokens=8, do_selection=do_sel)
                    for r in (ref_run, got_run))
        same["pruned" if do_sel else "unpruned"] = bool((ref.sequences == got.sequences).all())
        if do_sel:
            same["keep_sets"] = bool((ref.keep_img == got.keep_img).all())
    print("phase 14 tiny LLaVA, card bf16 vs CPU fp32, max error / max |ref|: "
          + json.dumps(errs) + ", equal: " + json.dumps(same))
    bad = {k: v for k, v in errs.items() if not v <= 0.1}
    if bad or not all(same.values()):
        raise AssertionError(f"the card's tiny LLaVA disagrees with the CPU: {bad}, {same}")
    return {**errs, **same}


def llava_train_steps(cfg, model, images, prompts):
    """LLAVA_TRAIN_STEPS base train steps (make_train_step, AdamW, the
    GlimpsePrune modules alone trainable) at B = 2 with answers and one box
    a row: finite losses, the glimpse embeddings moved, every base weight
    bit-identical (against a host copy); K2-lse and K3 launched. ->
    (record, launches)."""
    import torch

    from glimpseprune_torch.training.train_step import (AdamW, init_trainable,
                                                        make_train_step, split_params)
    from glimpseprune_torch.training.trainer import batch_from_prep

    rng = np.random.default_rng(14)
    answers = [[int(x) for x in rng.integers(3, 31000, 12)] for _ in prompts]
    prep = llava_prep(cfg, model.clip_cfg, images, prompts, answer_ids=answers,
                      normed_bboxes=[[[0.1, 0.1, 0.5, 0.6]], [[0.3, 0.2, 0.9, 0.7]]])
    batch = batch_from_prep(prep, "cuda")
    _, frozen = split_params(model)
    frozen_before = {k: p.detach().cpu() for k, p in frozen.items()}
    adamw = AdamW(init_trainable(model), LLAVA_TRAIN_LR, max_grad_norm=1.0)
    le0 = model.learnable_embeddings.detach().clone()
    step = make_train_step(cfg, model, adamw)
    reset_launches()
    steps = []
    for i in range(LLAVA_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = timed_ms(lambda: step(batch))
        steps.append({"step": i + 1, "ms": ms, "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2**30, **{k: float(v) for k, v in metrics.items()}})
        print("phase 14 train step " + json.dumps(steps[-1]))
    torch.cuda.synchronize()
    launches = read_launches([f"{fn}[{k}]" for fn in ("flash_attention_lse",
                                                      "flash_attention_backward")
                              for k in ("causal", "dqk_ne_dv")])
    model.requires_grad_(False)
    moved = [k for k, p in frozen.items() if not torch.equal(p.cpu(), frozen_before[k])]
    le_moved = (model.learnable_embeddings.detach() - le0).abs().max().item()
    rec = {"S": int(prep.input_ids.shape[1]), "steps": steps,
           "learnable_embeddings_max_change": le_moved, "frozen_changed": len(moved),
           "frozen_tensors": len(frozen)}
    if not all(np.isfinite(st["loss"]) for st in steps) or not le_moved > 0 or moved:
        raise AssertionError(f"phase 14 training: {rec}, changed frozen {moved[:5]}")
    return rec, launches


def llava_q8(cfg, model, prep, smi):
    """The (q8) tier on the trained 7B, quantized in place: int8 decoder
    and head, W8A8 prefill, int8 KV, CLIP unquantized; LLAVA_Q8_TOKENS
    greedy tokens pruned, with phase 9's checks (outputs, the first
    logits' distance from bf16, the weight and KV bytes) and phase 6's
    decode checks. -> (record, launches)."""
    import torch

    from glimpseprune_torch.models.layers import QuantLinear
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.ops.kv_cache import cache_nbytes
    from glimpseprune_torch.quantization import quantize_model, quantized_bytes

    ref = GlimpsePruneRunner(cfg, model).prefill(prep, True).logits.float().cpu()
    qcfg = quant_config(cfg, "q8")
    t0 = time.perf_counter()
    quantize_model(model, "int8", cfg=qcfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    if any(isinstance(m, QuantLinear) for m in model.visual.modules()):
        raise AssertionError("(q8) quantized the CLIP tower")
    runner = GlimpsePruneRunner(qcfg, model)
    reset_launches()
    with sync_checked():
        runner.generate(prep, max_new_tokens=LLAVA_Q8_TOKENS)
        torch.cuda.reset_peak_memory_stats()
        prefill_ms, pre = timed_ms(lambda: runner.prefill(prep, True))
        generate_ms, res = timed_ms(lambda: runner.generate(prep, max_new_tokens=LLAVA_Q8_TOKENS))
        peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    launches = read_launches(LLAVA_KERNELS)
    check_outputs(qcfg, prep, pre, res, True, LLAVA_Q8_TOKENS)
    t_cache = pre.valid.shape[1] + LLAVA_Q8_TOKENS
    rec = {"quantize_s": quant_s, "weight_bytes": quantized_bytes(model),
           "kv_cache_bytes": sum(cache_nbytes(runner.decode_cache(kv, t_cache))
                                 for kv in (pre.kv_k, pre.kv_v)),
           "prefill_ms": prefill_ms, "generate_ms": generate_ms, "peak_mem_gib": peak / 2**30,
           "kept_img_tokens": res.keep_img.sum(1).tolist(),
           "first_logits_rel_dist_from_bf16": rel_err(pre.logits.float().cpu(), ref)}
    print(f"phase 14 (q8) on {smi}: " + json.dumps(rec))
    with torch.inference_mode():
        rec["decode"] = check_captured_decode(qcfg, runner, prep, True, "llava-q8")
    return rec, launches


def run_llava_phase(gen, smi):
    """Phase 14: LLaVA-1.5-7B at full width -> (kernel rows, record,
    {"serve", "train", "q8": launches})."""
    import torch

    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    t0 = time.perf_counter()
    cfg, cc, images, prompts, prep, rng = llava_inputs()
    # K2 at LLaVA's two new shapes: the decoder's MHA causal prefill (32 q
    # over 32 kv heads) and the fuser's Dqk != Dv over 576 tokens, one segment
    rows = flash_cases(llm_fuser_cases(cfg, prep, "llava_"), gen)
    small = check_small_llava()
    model, weights = build_llava(cfg, cc)
    with captures() as caught, replays() as replayed:
        runs, serve_launches = run_main_path(cfg, model, [("l", prep)], LLAVA_KERNELS,
                                             "phase 14 main path")
    if len(caught) != 2:  # one captured step a mode, replayed by the timed runs
        raise AssertionError(f"phase 14 captured {len(caught)} decode steps, not 2")
    kept = runs[0]["kept_img_tokens"]
    if not all(0 < k < n for k, n in zip(kept, prep.n_img_tokens)):
        raise AssertionError(f"phase 14's pruned run kept {kept} of {prep.n_img_tokens}: "
                             "the keep policy cut nothing")
    for k in rows:
        k.update(phase=14, launches=serve_launches[k["name"]])
    runner = GlimpsePruneRunner(cfg, model)
    with torch.inference_mode():
        decode = check_captured_decode(cfg, runner, prep, True, "llava-bf16")
    all_kept = check_llava_all_kept(cfg, model, images, prompts)
    segments = np.zeros((2, cc.text_max_positions), dtype=np.int64)
    for m, n in enumerate((14, 9)):  # BOS, words, EOT (the largest id), zero padding
        segments[m, 0], segments[m, n + 1] = 49406, 49407
        segments[m, 1:n + 1] = rng.integers(300, 49000, n)
    cdp_ms, cdp = timed_ms(lambda: runner.generate_compressed(
        prep, "cdpruner", max_new_tokens=COMPRESSED_NEW_TOKENS, visual_token_num=LLAVA_CDP_KEEP,
        clip_text_ids=segments))
    if cdp.keep_img.sum(1).tolist() != [LLAVA_CDP_KEEP] * len(prompts):
        raise AssertionError(f"CDPruner kept {cdp.keep_img.sum(1).tolist()}")
    train, train_launches = llava_train_steps(cfg, model, images, prompts)
    q8, q8_launches = llava_q8(cfg, model, prep, smi)
    del runner, model
    torch.cuda.empty_cache()
    rec = {"weights": weights, "runs": runs, "captures": len(caught),
           "capture_ms": [c * 1e3 for c in caught], "replayed_steps": replayed[0],
           "decode": decode, "all_kept": all_kept, "tiny": small,
           "cdpruner": {"kept": cdp.keep_img.sum(1).tolist(), "ms": cdp_ms,
                        "tokens": COMPRESSED_NEW_TOKENS},
           "train": train, "q8": q8, "phase_s": time.perf_counter() - t0}
    print("phase 14 " + json.dumps({k: v for k, v in rec.items() if k in (
        "captures", "replayed_steps", "cdpruner", "phase_s")}))
    return rows, rec, {"serve": serve_launches, "train": train_launches, "q8": q8_launches}


# phase 15: the evaluation path through the port's command lines
QWEN_DIR = "configs/model_qwen2_5_7b_gp"
# decoder layers of the 7B in phase 9's tiers and phase 16's tools (of 28;
# the reduce layer is 18): the depth cut that holds the script to its
# budget of seconds
QUANT_TEXT_LAYERS = 20
TOOLS_TEXT_LAYERS = 20
SP_TEXT_LAYERS = 20  # phase 11's bf16 7B, also (m)'s; its (q8) 7B keeps 28
# LLaVA-1.5-7B's decoder layers in phases 14 and (m) (of 32; its reduce
# layer is 21)
LLAVA_TEXT_LAYERS = 24
EVAL_DIR = "build/chip_smoke_eval"
EVAL_SIZES = ((896, 672), (672, 504), (896, 672), (672, 504))  # (h, w) of the 4 images
EVAL_NEW_TOKENS = 16
EVAL_TRAIN_STEPS = 2
# a CLI's model is freed when its main() returns: the card's allocation must
# come back within this of what it was before the call
EVAL_LEAK_BYTES = 2**30
EVAL_RECORD_KEYS = {"question_id", "dataset", "query", "answer", "response", "num_gen_tokens",
                    "img_path", "mask_ratio", "keep_mask", "token_grid"}
EVAL_BOX_KEYS = {"tp", "fp", "fn", "tn", "iou", "precision", "recall"}


def write_eval_benchmark(work: Path):
    """4 synthetic .npy images (2 at 896x672, 2 at 672x504) and a
    VisCoT-format benchmark over them: rows 0-2 carry a pixel box as
    ``path###[x1, y1, x2, y2]``, row 3 none -> (json path, image dir)."""
    rng = np.random.default_rng(15)
    img_dir = work / "bench_imgs"
    (img_dir / "cot").mkdir(parents=True)
    rows = []
    for i, (h, w) in enumerate(EVAL_SIZES):
        name = f"cot/{i}.npy"
        np.save(img_dir / name, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        box = [w // 10 * (i + 1), h // 8, w // 2 + w // 10 * i, h // 2 + h // 8 * i]
        rows.append({"question_id": i, "image": [name, f"{name}###{box}"] if i < 3 else [name],
                     "conversations": [
                         {"from": "human", "value": f"<image>\nWhat is the object in region "
                          f"{i}? Please provide the bounding box coordinate of the region "
                          "that can help you answer the question better."},
                         {"from": "gpt", "value": str(box)},
                         {"from": "human", "value": "<image>"},
                         {"from": "gpt", "value": f"object {i}"}]})
    path = work / "bench.json"
    path.write_text(json.dumps(rows))
    return path, img_dir


def freed_call(fn, base: int, what: str):
    """(seconds, peak device bytes, result) of one CLI call, whose model
    must be freed once it returns."""
    import gc

    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    if left > EVAL_LEAK_BYTES:
        raise AssertionError(f"{what} left {left / 2**30:.2f} GiB allocated on the card")
    return secs, peak, out


def check_eval_records(path: str, info_key: str):
    """4 records with the JAX harness's fields, mask ratios in (0, 1], the
    box metrics on the boxed rows only, one timed call per batch of 2."""
    with open(path) as f:
        recs = [json.loads(x) for x in f]
    if len(recs) != len(EVAL_SIZES):
        raise AssertionError(f"{path}: {len(recs)} records, not {len(EVAL_SIZES)}")
    for i, r in enumerate(recs):
        want = EVAL_RECORD_KEYS | (EVAL_BOX_KEYS if i < 3 else set())
        if set(r) != want:
            raise AssertionError(f"{path} row {i}: fields {sorted(r)}, not {sorted(want)}")
        if not 0 < r["mask_ratio"] <= 1:
            raise AssertionError(f"{path} row {i}: mask_ratio {r['mask_ratio']}")
    with open(path.replace(".jsonl", "_info.json")) as f:
        info = json.load(f)
    timed = info["logger_stats"]["time_ms"]
    if {k: v["count"] for k, v in timed.items()} != {info_key: 2}:
        raise AssertionError(f"{path}: logger_stats {timed}, not 2 calls of {info_key}")
    return recs, timed[info_key]["avg"]


def in_process_records(cfg, ckpt: Path, bench: Path, img_dir: Path, work: Path):
    """run_inference (generate) on a model built as the CLI builds it:
    init_random at seed 0, the saved modules loaded, the stand-in
    tokenizer."""
    import dataclasses

    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.evalsuite import InferenceConfig, load_benchmark, run_inference
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.persistence import load_new_modules
    from glimpseprune_torch.tools.common import StandInTokenizer, text_codec

    model, saved = load_new_modules(init_random(cfg, 0, "cuda", torch.bfloat16), str(ckpt))
    cfg = dataclasses.replace(cfg, gp=saved.gp)
    tokenize, detokenize = text_codec(StandInTokenizer(cfg))
    out = run_inference(GlimpsePruneRunner(cfg, model.set_config(cfg)),
                        load_benchmark(str(bench), str(img_dir)), str(work / "in_process"),
                        "bench", InferenceConfig(task="generate", batch_size=2,
                                                 max_new_tokens=EVAL_NEW_TOKENS,
                                                 save_masks=True),
                        tokenize=tokenize, detokenize=detokenize)
    with open(out) as f:
        return [json.loads(x) for x in f]


def check_full_params_q4(cfg, prep, work: Path):
    """The (q4) 7B quantized on the card, saved by save_full_params and
    loaded by load_full_params onto the meta device: greedy tokens, keep
    sets, mask logits and first logits bit-identical to the model before
    saving -> (record, launches of both sides' runs)."""
    import gc

    import torch

    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.persistence import (
        FULL_PARAMS_FILE,
        load_full_params,
        save_full_params,
    )
    from glimpseprune_torch.quantization import quantize_model

    qcfg = quant_config(cfg, "q4")
    model = quantize_model(init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16),
                           "int4", cfg=qcfg)
    reset_launches()

    def outputs(runner):
        res = runner.generate(prep, max_new_tokens=EVAL_NEW_TOKENS)
        pre = runner.prefill(prep, True)
        return res, pre.logits.float().cpu(), pre.mask_logits.float().cpu()

    want = outputs(GlimpsePruneRunner(qcfg, model))
    d = work / "full_params_q4"
    t0 = time.perf_counter()
    save_full_params(model, qcfg, str(d))
    save_s = time.perf_counter() - t0
    nbytes = (d / FULL_PARAMS_FILE).stat().st_size
    del model
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded, lcfg = load_full_params(str(d), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() - before
    held = torch.cuda.memory_allocated() - before
    got = outputs(GlimpsePruneRunner(lcfg, loaded))
    launches = read_launches(["matmul_int4[*]", "matmul_int4_prefill[a8,*]",
                              "flash_attention_int8[*]", "window_attention_fused"])
    (w, wl, wm), (g, gl, gm) = want, got
    same = {"tokens": np.array_equal(g.sequences, w.sequences)
            and np.array_equal(g.num_generated, w.num_generated),
            "keep": np.array_equal(g.keep_img, w.keep_img),
            "generate_mask_logits": np.array_equal(g.mask_logits, w.mask_logits),
            "prefill_mask_logits": torch.equal(gm, wm), "first_logits": torch.equal(gl, wl)}
    rec = {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
           "load_peak_bytes": load_peak, "loaded_bytes": held, "config_equal": lcfg == qcfg,
           "bit_identical": same, "kept_img_tokens": g.keep_img.sum(1).tolist()}
    print("phase 15 (q4) full params " + json.dumps(rec))
    if not all(same.values()) or lcfg != qcfg:
        raise AssertionError(f"the reloaded (q4) model differs: {same}")
    # the loaded weights take the card once: no second copy at the peak
    if load_peak > 1.1 * held:
        raise AssertionError(f"load_full_params peaked at {load_peak} bytes for {held} held")
    del loaded
    shutil.rmtree(d)
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def run_eval_phase(cfg, prep, smi):
    """Phase 15: train -> new modules -> inference -> scores through the
    port's command lines at 7B width, then the (q4) full-params round trip
    -> (record, {"cli", "q4_full_params": launches})."""
    import torch

    from glimpseprune_torch.analysis import flops_report_from_results
    from glimpseprune_torch.tools import infer_viscot, score_results, train_gp

    t_phase = time.perf_counter()
    work = ROOT / EVAL_DIR
    shutil.rmtree(work, ignore_errors=True)
    data_cfg = write_train_corpus(work / "train")
    (work / "data.json").write_text(json.dumps(data_cfg))
    (work / "trainer.json").write_text(json.dumps(
        {"batch_size": 2, "num_epochs": 1, "log_every": 1, "save_every": 0, "seed": 0}))
    bench, img_dir = write_eval_benchmark(work)
    model = ["--model-config", str(ROOT / QWEN_DIR), "--seed", "0"]
    ckpt = work / "ckpt"
    base = torch.cuda.memory_allocated()
    reset_launches()
    train_s, train_peak, _ = freed_call(lambda: train_gp.main(
        ["--config", str(work / "trainer.json"), "--data-config", str(work / "data.json"),
         "--img-dir", str(work / "train" / "imgs"), "--output-dir", str(ckpt),
         "--max-steps", str(EVAL_TRAIN_STEPS)] + model), base, "train_gp")
    for name in ("new_modules_gp.pt", "config.json", "trainer_state.pt"):
        if not (ckpt / name).exists():
            raise AssertionError(f"train_gp saved no {name}")
    history = json.loads((ckpt / "train_log.json").read_text())
    if [h["step"] for h in history] != list(range(1, EVAL_TRAIN_STEPS + 1)) or not all(
            np.isfinite(h[k]) for h in history for k in ("loss", "loc_loss", "le_loss")):
        raise AssertionError(f"train_gp history {history}")
    elapsed = [h["elapsed_s"] for h in history]
    rec = {"train": {"s": train_s, "peak_gib": train_peak / 2**30,
                     "step_ms": [1e3 * (b - a) for a, b in zip([0.0] + elapsed, elapsed)],
                     "loss": [h["loss"] for h in history]}}

    def infer_argv(task, *extra):
        return (["--benchmark", str(bench), "--img-dir", str(img_dir), "--task", task,
                 "--batch-size", "2", "--max-new-tokens", str(EVAL_NEW_TOKENS),
                 "--out-dir", str(work / "results"), "--new-modules", str(ckpt),
                 "--save-masks"] + list(extra) + model)

    paths = {}
    for tag, task, key, extra in (
            ("generate", "generate", "generate", ()),
            ("glimpse", "glimpse", "glimpse", ()),
            ("visionzip", "generate", "generate_compressed",
             ("--compressor", "visionzip", "--dataset-name", "bench_visionzip"))):
        secs, peak, path = freed_call(lambda: infer_viscot.main(infer_argv(task, *extra)),
                                      base, f"infer_viscot {tag}")
        recs, ms = check_eval_records(path, f"GlimpsePruneRunner.{key}")
        paths[tag] = path
        rec[tag] = {"s": secs, "peak_gib": peak / 2**30, "ms_per_call": ms,
                    "gen_tokens": [r["num_gen_tokens"] for r in recs],
                    "mask_ratio": [r["mask_ratio"] for r in recs],
                    "iou": [r.get("iou") for r in recs]}
        print(f"phase 15 infer_viscot {tag} on {smi}: " + json.dumps(rec[tag]))
    torch.cuda.synchronize()
    cli_launches = read_launches(["window_attention_fused", "flash_attention[causal]",
                                  "flash_attention[segmented]", "flash_attention[dqk_ne_dv]",
                                  "flash_attention_lse[causal]",
                                  "flash_attention_backward[causal]"])
    print("phase 15 CLI launches " + json.dumps(cli_launches))

    gen_path = paths["generate"]
    mtime = Path(gen_path).stat().st_mtime_ns
    again_s, _, again = freed_call(lambda: infer_viscot.main(infer_argv("generate")), base,
                                   "infer_viscot resume")
    if again != gen_path or Path(gen_path).stat().st_mtime_ns != mtime:
        raise AssertionError("a second infer_viscot call without --overwrite rewrote its output")
    rec["resume_s"] = again_s
    with open(gen_path) as f:
        cli_recs = [json.loads(x) for x in f]
    _, _, ref = freed_call(lambda: in_process_records(cfg, ckpt, bench, img_dir, work), base,
                           "in-process run_inference")
    if cli_recs != ref:
        raise AssertionError("infer_viscot's records differ from an in-process run_inference")
    rec["records_equal_in_process"] = True

    [summary] = score_results.main([gen_path, "--scorer", "precise_match"])
    if summary["num_scored"] != len(EVAL_SIZES):
        raise AssertionError(f"score_results: {summary}")
    flops = flops_report_from_results(gen_path, cfg)
    if not flops["avg_gp_tflops"] < flops["avg_vanilla_tflops"]:
        raise AssertionError(f"GP FLOPs not below vanilla: {flops}")
    rec.update(score=summary["mean_score"], flops=flops)

    rec["full_params_q4"], fp_launches = check_full_params_q4(cfg, prep, work)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 15 on {smi}: " + json.dumps(
        {k: rec[k] for k in ("train", "resume_s", "score", "flops", "phase_s")}))
    # phase 16 reads the results and their images; it removes the folder
    rec["outputs"] = {"generate": paths["generate"], "visionzip": paths["visionzip"],
                      "img_dir": str(img_dir), "work": str(work)}
    return rec, {"cli": cli_launches, "q4_full_params": fp_launches}


TOOLS_SIDES = "3584,2688,1792"  # profile_train_step --fallback-sides
TOOLS_DECODE_T = ("2048", "8192", "16896")
TOOLS_NEW_TOKENS = 16  # each demo request
TOOLS_HARVEST_QUERIES = 4  # save_attn_maps --q-start S - 4
BENCH_MAX_PIXELS = 12845056  # bench.py's default image cap: 4086 px -> ~16k image tokens
FASTINIT_STD_TOL = 0.05
FASTINIT_PEAK_SLACK = 0.05
TOOLS_KERNELS = ["window_attention_fused", "flash_attention[causal]",
                 "flash_attention[dense]", "flash_attention[segmented]",
                 "flash_attention[dqk_ne_dv]", "flash_attention_lse[causal]",
                 "flash_attention_backward[causal]", "matmul_int4[*]"]


def check_native_prep(cfg, img16k, img_small):
    """(a) The native prep against the numpy path where no resize is needed
    (no PIL there): the native resize, then both paths' normalize +
    patchify on its output, within 1e-6 with equal grids, and the fused
    native call equal to the two steps; the 16k image's native ms; with PIL
    hidden, the PIL path's named ImportError and ``prepare_inputs`` through
    the native path -> record."""
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.preprocessing import native
    from glimpseprune_torch.preprocessing.image import preprocess_image, smart_resize

    rec = {}
    for name, img, max_px in (("16k", img16k, BENCH_MAX_PIXELS), ("1000x750", img_small, None)):
        kw = {} if max_px is None else {"max_pixels": max_px}
        hw = smart_resize(img.shape[0], img.shape[1], 28, **({"max_pixels": max_px}
                                                              if max_px else {}))
        t0 = time.perf_counter()
        fused, grid = native.preprocess_image_native(img, **kw)
        ms = 1e3 * (time.perf_counter() - t0)
        resized = native.resize_bicubic_native(img, *hw)
        two_step, grid2 = native.preprocess_image_native(resized, resized_hw=hw)
        ref, grid_ref = preprocess_image(resized, resized_hw=hw)
        err = float(np.abs(two_step - ref).max())
        if tuple(grid) != tuple(grid_ref) or tuple(grid2) != tuple(grid_ref) or err > 1e-6:
            raise AssertionError(f"native prep {name}: grids {grid} / {grid2} / {grid_ref}, "
                                 f"max |native - numpy| {err}")
        if not np.array_equal(fused, two_step):
            raise AssertionError(f"native prep {name}: the fused call differs from resize + "
                                 "patchify")
        rec[name] = {"input_hw": list(img.shape[:2]), "resized_hw": list(hw),
                     "grid": [int(g) for g in grid], "patches": int(fused.shape[0]),
                     "native_ms": ms, "max_abs_err_no_resize": err}
    try:
        import PIL  # noqa: F401

        rec["pil"] = "installed on this machine: hidden for the check"
    except ImportError:
        rec["pil"] = "not installed"
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # an import of PIL now raises ImportError
    try:
        try:
            preprocess_image(img_small)
        except ImportError as e:
            if "use_native_preproc" not in str(e) or "GP_NATIVE_PREPROC" not in str(e):
                raise AssertionError(f"the PIL path's ImportError names no native path: {e}")
            rec["pil_path_error"] = str(e)
        else:
            raise AssertionError("without PIL the numpy path resized an image")
        prompt = [cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id, 1000]
        prep = prepare_inputs(cfg, [prompt], [img_small], use_native_preproc=True)
        rec["prepare_inputs_without_pil"] = {"n_img_tokens": int(prep.n_img_tokens[0])}
    finally:
        if saved is None:
            sys.modules.pop("PIL", None)
        else:
            sys.modules["PIL"] = saved
    print("phase 16 (a) native prep " + json.dumps(rec))
    return rec


def check_fastinit(cfg):
    """device_random_params in (q8) at 7B: its time, the dequantized std
    of 8 sampled columns of every quantized linear within FASTINIT_STD_TOL
    of fan_in ** -0.5, and the draw's peak within FASTINIT_PEAK_SLACK of
    the finished weights (no bf16 copy) -> record."""
    import gc

    import torch

    from glimpseprune_torch.models.layers import QuantLinear
    from glimpseprune_torch.tools.common import tier_config
    from glimpseprune_torch.utils.fastinit import device_random_params

    qcfg = tier_config(cfg, "int8")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = device_random_params(qcfg, 0, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, n_lin = 0.0, 0
    for mod in model.modules():
        if isinstance(mod, QuantLinear) and mod.mode == "int8":
            cols = torch.randint(0, mod.kernel_q.shape[1], (8,), generator=gen, device="cuda")
            w = mod.kernel_q[:, cols].float() * mod.kernel_scale[0, cols]
            worst = max(worst, abs(float(w.std()) * mod.kernel_q.shape[0] ** 0.5 - 1.0))
            n_lin += 1
    rec = {"s": secs, "weight_bytes": held, "peak_bytes": peak, "quantized_linears": n_lin,
           "worst_std_rel_err": worst}
    print("phase 16 device_random_params (q8) " + json.dumps(rec))
    if n_lin == 0 or worst > FASTINIT_STD_TOL:
        raise AssertionError(f"device_random_params' law: {rec}")
    if peak > (1 + FASTINIT_PEAK_SLACK) * held:
        raise AssertionError(f"device_random_params peaked at {peak} bytes for {held} held")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sse_request(base: str, payload: dict):
    """(events, ms to the first event, total ms) of one POST /generate."""
    import urllib.request

    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first, events, buf = None, [], b""
    with urllib.request.urlopen(req, timeout=600) as resp:
        while True:
            chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read()
            if not chunk:
                break
            if first is None:
                first = 1e3 * (time.perf_counter() - t0)
            buf += chunk
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                if block.startswith(b"data: "):
                    events.append(json.loads(block[6:]))
    return events, first, 1e3 * (time.perf_counter() - t0)


def check_demo_server(image):
    """(f) The demo server in a thread (bf16 7B, seed 0), two requests with
    image as image_npy, GP on (streamed) and off: the tokens equal an
    in-process run on the same model and inputs, the overlay PNG decodes
    (zlib) to apply_mask_on_image of the kept mask -> (record, the server's
    state)."""
    import base64
    import io
    import threading

    import torch

    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.tools import demo_server
    from glimpseprune_torch.utils.viz import apply_mask_on_image, decode_png

    args = demo_server.parse_args(["--model-config", cut_config_dir(), "--seed", "0",
                                   "--native-preproc", "--port", "0"])
    state = demo_server.DemoState(args)
    srv = demo_server.make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    buf = io.BytesIO()
    np.save(buf, image)
    question = "what is in the picture"
    rec = {}
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        for mode, sel in (("gp_on", True), ("gp_off", False)):
            events, first_ms, total_ms = sse_request(base, {
                "image_npy": base64.b64encode(buf.getvalue()).decode(), "question": question,
                "do_selection": sel, "max_remain_ratio": 0.111, "reduce_threshold": 0.5,
                "max_new_tokens": TOOLS_NEW_TOKENS})
            kinds = [e["type"] for e in events]
            if "error" in kinds or kinds[-1:] != ["done"]:
                raise AssertionError(f"demo {mode}: events {events[-1:]}")
            rec[mode] = {"first_event_ms": first_ms, "total_ms": total_ms,
                         "events": len(events), "done": {k: v for k, v in events[-1].items()
                                                         if k != "overlay"},
                         "tokens": [int(t) for e in events if e["type"] == "token"
                                    for t in e["text"].split()],
                         "overlay": events[-1].get("overlay")}
        rec["captures_ms"] = [r["capture_ms"] for r in state.requests]
        rec["request_ms"] = [r["ms"] for r in state.requests]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    # the same model and inputs in process
    runner = state.runner(0.111, 0.5)
    cfg = runner.cfg
    state.model.set_config(cfg)
    ids = state.tok(question)
    prep = prepare_inputs(cfg, [[cfg.vision_start_token_id, cfg.image_token_id,
                                 cfg.vision_end_token_id] + ids], [image], seq_multiple=8,
                          patch_multiple=16, use_native_preproc=True)
    gen = runner.stream_generate(prep, max_new_tokens=TOOLS_NEW_TOKENS, chunk_size=4)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            res_on = stop.value
            break
    res_off = runner.generate(prep, max_new_tokens=TOOLS_NEW_TOKENS, do_selection=False)
    for mode, res in (("gp_on", res_on), ("gp_off", res_off)):
        want = [int(t) for t in res.sequences[0, : res.num_generated[0]]
                if int(t) != cfg.eos_token_id]
        if rec[mode]["tokens"] != want:
            raise AssertionError(f"demo {mode}: the server's tokens {rec[mode]['tokens']} are "
                                 f"not the in-process run's {want}")
    gh = int(prep.grids[0][1] // cfg.vision.spatial_merge_size)
    gw = int(prep.grids[0][2] // cfg.vision.spatial_merge_size)
    mask = res_on.keep_img[0, : gh * gw].reshape(gh, gw)
    overlay = decode_png(base64.b64decode(rec["gp_on"].pop("overlay")))
    rec["gp_off"].pop("overlay")
    if not np.array_equal(overlay, apply_mask_on_image(image, mask)):
        raise AssertionError("demo: the overlay PNG is not apply_mask_on_image of the kept mask")
    if abs(rec["gp_on"]["done"]["prune_ratio"] - float(res_on.prune_ratio[0])) > 1e-6:
        raise AssertionError(f"demo: prune_ratio {rec['gp_on']['done']}")
    rec["overlay_hw"] = list(overlay.shape[:2])
    del state, runner, srv
    torch.cuda.empty_cache()
    return rec


def check_attn_maps(image_path: str, work: Path):
    """(g) save_attn_maps on the 7B (seed 0): the expected PNG count, finite
    heatmaps, harvest rows summing to at most 1 over the image keys."""
    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.tools import save_attn_maps

    cfg = ModelConfig.load(cut_config_dir())
    out_dir = work / "attn_maps"
    t0 = time.perf_counter()
    out = save_attn_maps.main(["--image", image_path, "--question", "what is in the picture",
                               "--per-head", "--native-preproc", "--q-start",
                               str(-TOOLS_HARVEST_QUERIES), "--out-dir", str(out_dir),
                               "--model-config", cut_config_dir(), "--seed", "0"])
    secs = time.perf_counter() - t0
    layers = len(cfg.gp.selected_layers)
    n_fused = sum(f.startswith("fused_map_") for f in out["files"])
    pngs = sorted(p.name for p in out_dir.glob("*.png"))
    want = n_fused + layers * (1 + cfg.text.num_attention_heads) + layers * \
        TOOLS_HARVEST_QUERIES
    finite = all(np.isfinite(a).all() for a in out["heatmaps"].values())
    sums = list(out["harvest_sums"].values()) + list(out["seq_harvest_sums"].values())
    rec = {"s": secs, "pngs": len(pngs), "expected": want, "fused": n_fused,
           "grid": out["grid"], "harvest_sums": out["harvest_sums"],
           "seq_harvest_sums": out["seq_harvest_sums"], "finite": finite}
    print("phase 16 (g) save_attn_maps " + json.dumps(rec))
    if n_fused == 0 or len(pngs) != want or sorted(f for f in out["files"]
                                                   if f.endswith(".png")) != pngs:
        raise AssertionError(f"save_attn_maps wrote {len(pngs)} PNGs, not {want}")
    if not finite or not sums or max(sums) > 1 + 1e-3:
        raise AssertionError(f"save_attn_maps: heatmaps or harvest sums {rec}")
    return rec


def check_compare_tools(outputs):
    """(h) compare_results and compare_server on phase 15's generate and
    visionzip results: 4 joined rows, every page 200 with 4 rows, one .npy
    overlay rendered."""
    import threading
    import urllib.request

    from glimpseprune_torch.tools import compare_results, compare_server
    from glimpseprune_torch.utils.viz import decode_png

    a, b = outputs["generate"], outputs["visionzip"]
    report = compare_results.main([a, b, "--show", "1"])
    n = len(EVAL_SIZES)
    if report["common_samples"] != n:
        raise AssertionError(f"compare_results joined {report['common_samples']} rows, not {n}")
    args = compare_server.parse_args([a, b, "--img-dir", outputs["img_dir"], "--port", "0"])
    srv = compare_server.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    try:
        code, _, index = get("/")
        pages = [code] + [get(f"/sample/{i}")[0] for i in range(n)]
        rows = index.count(b'<li><a href="/sample/')
        code, ctype, png = get("/img/0/a")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    img = decode_png(png)
    rec = {"joined": report["common_samples"], "metrics": report["metrics"],
           "pages": pages, "index_rows": rows, "overlay_hw": list(img.shape[:2])}
    print("phase 16 (h) compare tools " + json.dumps(rec))
    if pages != [200] * (n + 1) or rows != n or code != 200 or ctype != "image/png":
        raise AssertionError(f"compare_server: {rec}")
    if list(img.shape[:2]) != list(EVAL_SIZES[0]):
        raise AssertionError(f"compare_server's overlay is {img.shape}, not {EVAL_SIZES[0]}")
    return rec


def run_tools_phase(cfg, outputs, smi):
    """Phase 16: the native image prep, the four stage profilers, the demo
    server, the attention maps and the compare tools at 7B width (run after
    phase 15, when the card holds no model) -> (record, launches)."""
    import torch

    from glimpseprune_torch.tools import (
        profile_decode,
        profile_grpo_step,
        profile_prefill,
        profile_train_step,
    )

    t_phase = time.perf_counter()
    work = Path(outputs["work"])
    rng = np.random.default_rng(16)
    img16k = rng.integers(0, 256, (4086, 4086, 3), dtype=np.uint8)
    img_small = rng.integers(0, 256, (1000, 750, 3), dtype=np.uint8)
    small_path = work / "tools_1000x750.npy"
    np.save(small_path, img_small)
    rec = {"native_prep": check_native_prep(cfg, img16k, img_small)}
    del img16k
    rec["fastinit"] = check_fastinit(cfg)
    model = ["--model-config", cut_config_dir(), "--seed", "0"]
    reset_launches()

    def tool(name, fn, argv):
        t0 = time.perf_counter()
        out = fn(argv + model)
        torch.cuda.synchronize()
        out["tool_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"phase 16 {name} on {smi}: " + json.dumps(
            {k: v for k, v in out.items() if k not in ("vision_split",)}))
        return out

    pre = rec["prefill"] = {
        "q8_16k": tool("(b) profile_prefill (q8) 16k", profile_prefill.main,
                       ["--quant", "int8", "--max-pixels", str(BENCH_MAX_PIXELS),
                        "--native-preproc", "--vision", "--iters", "2"]),
        "bf16_1036": tool("(b) profile_prefill bf16 1036^2", profile_prefill.main,
                          ["--native-preproc", "--iters", "2"])}
    for name, r in pre.items():
        if not r["first_logits_finite"] or min(r["kept_img_tokens"]) < r["min_remain_num"]:
            raise AssertionError(f"profile_prefill {name}: {r}")
    rec["decode"] = {
        "q8_kv8": tool("(c) profile_decode (q8) + int8 KV", profile_decode.main,
                       ["--quant", "int8", "--kv-quant", "int8", "--iters", "2",
                        "--contexts", *TOOLS_DECODE_T]),
        "bf16": tool("(c) profile_decode bf16", profile_decode.main,
                     ["--iters", "2", "--contexts", *TOOLS_DECODE_T]),
        "q4": tool("(c) profile_decode (q4)", profile_decode.main,
                   ["--quant", "int4", "--iters", "2", "--contexts", "2048"])}
    train = rec["train_step"] = tool(
        "(d) profile_train_step (q8)", profile_train_step.main,
        ["--quant", "int8", "--img-side", TOOLS_SIDES.split(",")[0], "--fallback-sides",
         TOOLS_SIDES, "--steps", "2", "--native-preproc"])
    if not train["losses_finite"]:
        raise AssertionError(f"profile_train_step: non-finite losses {train['losses']}")
    grpo = rec["grpo_step"] = tool("(e) profile_grpo_step (q8)", profile_grpo_step.main,
                                   ["--quant", "int8", "--iters", "1"])
    if isinstance(grpo["step_chunked"], str) or isinstance(grpo["ref_fwd_chunked"], str):
        raise AssertionError(f"profile_grpo_step: the chunked path ran out of memory {grpo}")
    if "loss_rel_diff" in grpo and grpo["loss_rel_diff"] > 1e-3:
        raise AssertionError(f"profile_grpo_step: losses {grpo['losses']} disagree")
    rec["demo"] = check_demo_server(img_small)
    print(f"phase 16 (f) demo_server on {smi}: " + json.dumps(rec["demo"]))
    rec["attn_maps"] = check_attn_maps(str(small_path), work)
    torch.cuda.synchronize()
    launches = read_launches(TOOLS_KERNELS)
    rec["compare"] = check_compare_tools(outputs)
    shutil.rmtree(work)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16 on {smi}: {rec['phase_s']:.1f} s")
    return rec, launches


CONV_SCALE, CONV_SIDE = "7b", 560
CONV_ARGS = ["--scale", CONV_SCALE, "--quant", "int8", "--n-samples", "64", "--img-side",
             str(CONV_SIDE), "--batch-size", "1", "--save-every", "0", "--log-every", "1"]
CONV_STEPS = 100
CONV_RESUME_STEPS = 105
CONV_SPLIT_STEP = 103  # an interrupted resume: 100 -> 103, then -> 105
CONV_HELD_OUT = 8  # held-out synthetic images, drawn with CONV_HELD_SEED
CONV_HELD_SEED = 1
CONV_NEW_TOKENS = 16
CONV_GRPO_STEPS = 30
CONV_GRPO = ["--grpo", "--scale", "tiny", "--steps", str(CONV_GRPO_STEPS), "--grpo-probe-every",
             "15"]
CONV_GRPO_VARYING = ["--grpo", "--scale", "tiny", "--steps", "3", "--grpo-probe-every", "3",
                     "--grpo-score", "conv_char_parity"]
CONV_SWEEP = ["--layers", "2,18", "--steps", "10"]
CONV_TRAIN_KERNELS = ["window_attention_fused", "flash_attention[*]"] + [
    f"{fn}[{k}]" for fn in ("flash_attention_lse", "flash_attention_backward")
    for k in ("causal", "dqk_ne_dv")]
CONV_SERVE_KERNELS = ["window_attention_fused", "flash_attention[causal]",
                      "flash_attention[dqk_ne_dv]"]
CONV_GRPO_KERNELS = ["window_attention_fused", "flash_attention[causal]",
                     "flash_attention_lse[causal]", "flash_attention_backward[causal]"]


def conv_keep_sets(runner, preps, cap_ratio: float):
    """Pruned ``generate`` (CONV_NEW_TOKENS tokens) on each held-out batch
    -> per image: kept tokens, the cap, precision and recall against the
    box's tokens (``ref_token_masks``), the prune ratio; and the tokens."""
    rows, toks = [], []
    for prep in preps:
        res = runner.generate(prep, max_new_tokens=CONV_NEW_TOKENS)
        if res.keep_img is None or not np.isfinite(res.mask_logits).all():
            raise AssertionError("the held-out generate kept no set or gave non-finite logits")
        toks.append(res.sequences)
        for b in range(res.keep_img.shape[0]):
            n = int(prep.n_img_tokens[b])
            keep, box = res.keep_img[b, :n].astype(bool), prep.ref_token_masks[b, :n].astype(bool)
            hit = int((keep & box).sum())
            rows.append({"kept": int(keep.sum()), "cap": cap_ratio * n,
                         "box_tokens": int(box.sum()),
                         "precision": hit / max(int(keep.sum()), 1),
                         "recall": hit / max(int(box.sum()), 1),
                         "prune_ratio": float(res.prune_ratio[b])})
    return rows, toks


def conv_served(base_run, out_dir: Path, work: Path):
    """Phase (c) 3: the trained modules on a fresh 7B in the bench's (q8)
    serving tier, its base byte-equal to the training base, against the
    same base with the seed's untrained modules, on held-out images."""
    import dataclasses

    import torch

    from glimpseprune_torch.evalsuite.data import load_image
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.persistence import load_new_modules
    from glimpseprune_torch.tools.common import base_checksum, bench_config, tier_config
    from glimpseprune_torch.tools.convergence_run import make_synth_corpus, scale_inputs
    from glimpseprune_torch.training.train_step import new_module_filter
    from glimpseprune_torch.utils.fastinit import device_random_params

    cfg = tier_config(bench_config(CONV_SCALE), "int8")  # W8A8 prefill, int8 KV
    model = device_random_params(cfg, 0, "cuda", torch.bfloat16).set_config(cfg)
    checksum = base_checksum(model)
    if checksum != base_run.summary["base_checksum_after"]:
        raise AssertionError("the serving 7B's base differs from the training base: "
                             f"{checksum} vs {base_run.summary['base_checksum_after']}")
    untrained = {k: v.clone() for k, v in model.state_dict().items() if new_module_filter(k)}
    trained = {k: v for k, v in base_run.model.state_dict().items() if new_module_filter(k)}
    moved = sorted(k for k in untrained if not torch.equal(untrained[k].float(),
                                                           trained[k].float()))
    if not moved:
        raise AssertionError("training left every GlimpsePrune module as the seed drew it")
    data_cfg, img_dir = make_synth_corpus(str(work / "heldout"), CONV_HELD_OUT, CONV_SIDE,
                                          seed=CONV_HELD_SEED)
    (seq_mult, patch_mult), tokenize = scale_inputs(CONV_SCALE)
    with open(data_cfg["datasets"][0]["json_path"]) as f:
        rows = [json.loads(x) for x in f]
    prompt = ([cfg.vision_start_token_id, cfg.image_token_id, cfg.vision_end_token_id]
              + tokenize(rows[0]["question"]))
    preps = []
    for i in range(0, len(rows), 2):
        pair = rows[i:i + 2]
        preps.append(prepare_inputs(
            cfg, [prompt] * len(pair),
            [load_image(str(Path(img_dir) / "cot" / "synth" / r["image"])) for r in pair],
            normed_bboxes=[[[c / r["width"] if j % 2 == 0 else c / r["height"]
                             for j, c in enumerate(r["bboxs"][0])]] for r in pair],
            seq_multiple=seq_mult, patch_multiple=patch_mult))
    arms = {}
    reset_launches()
    for arm in ("trained", "untrained"):
        if arm == "trained":
            _, saved = load_new_modules(model, str(out_dir))
            model.set_config(dataclasses.replace(cfg, gp=saved.gp))
        else:
            params = dict(model.named_parameters())
            with torch.no_grad():
                for k, v in untrained.items():
                    params[k].copy_(v)
            model.set_config(cfg)
        runner = GlimpsePruneRunner(model.cfg, model)
        t0 = time.perf_counter()
        keep, toks = conv_keep_sets(runner, preps, cfg.gp.max_remain_ratio)
        torch.cuda.synchronize()
        arms[arm] = {"images": keep, "s": time.perf_counter() - t0,
                     "mean_precision": float(np.mean([r["precision"] for r in keep])),
                     "mean_recall": float(np.mean([r["recall"] for r in keep])),
                     "mean_kept": float(np.mean([r["kept"] for r in keep])),
                     "tokens_in_vocab": bool(all(((t >= 0) & (t < cfg.text.vocab_size)).all()
                                                 for t in toks))}
        del runner
    launches = read_launches(CONV_SERVE_KERNELS)
    del model
    torch.cuda.empty_cache()
    return {"checksum_equal": True, "modules_moved": len(moved), "modules": len(untrained),
            **arms}, launches


def conv_resume(argv, out: Path, data: Path, base_rows):
    """Phase (c) 2: resume the step-100 checkpoint to CONV_RESUME_STEPS
    (steps continue at 101, the first 100 rows carried over), and the same
    interrupted at CONV_SPLIT_STEP: its last steps equal the uninterrupted
    resume's (test_trainer_resume_equals_uninterrupted's bound)."""
    import torch

    from glimpseprune_torch.tools import convergence_run

    def run(steps, src, dst):
        r = convergence_run.main(argv + ["--steps", str(steps), "--resume-from", str(src),
                                         "--out", str(dst), "--data-root", str(data)])
        hist, model = r.history, r.model
        del r, model
        torch.cuda.empty_cache()
        return hist

    keys = ("loss", "loc_loss", "le_loss", "mask_iou")
    whole = run(CONV_RESUME_STEPS, out / "base", out / "resume")
    if [h["step"] for h in whole] != list(range(1, CONV_RESUME_STEPS + 1)):
        raise AssertionError(f"the resumed history's steps: {[h['step'] for h in whole]}")
    if whole[:CONV_STEPS] != json.loads(json.dumps(base_rows)):
        raise AssertionError("the resumed history does not carry the first run's rows")
    run(CONV_SPLIT_STEP, out / "base", out / "split")
    split = run(CONV_RESUME_STEPS, out / "split", out / "split2")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(split[CONV_SPLIT_STEP:], whole[CONV_SPLIT_STEP:]) for k in keys)
    if not worst <= 1e-6:
        raise AssertionError(f"an interrupted resume differs from the uninterrupted one: {worst}")
    return {"steps": [h["step"] for h in whole[CONV_STEPS:]], "split_rel_diff": worst,
            "loss": [h["loss"] for h in whole[CONV_STEPS:]]}


def conv_char_parity(queries, answers, completions, **kw):
    """A reward that varies across a random policy's samples (the first
    char's code point mod 2), so that the advantages are not all zero."""
    return [float(ord(c[0]) % 2) if c else 0.0 for c in completions]


def conv_grpo_run(argv, out: Path, steps: int):
    """One GRPO-stage run through ``main(argv)``: rewards and losses finite,
    the frozen base unchanged, ``steps`` rows logged -> (history, summary,
    {"a", "b": adapter leaves that moved}, adapter leaves)."""
    import torch

    from glimpseprune_torch.tools import convergence_run
    from glimpseprune_torch.training.lora import lora_tree, make_lora_params

    run = convergence_run.main(argv + ["--out", str(out)])
    hist, s = run.history, run.summary
    keys = ("mean_score", "reward_loss", "kd_loss", "grpo_total", "loss", "loc_loss",
            "le_loss")
    bad = [(h["step"], k) for h in hist for k in keys if not np.isfinite(h[k])]
    if bad:
        raise AssertionError(f"GRPO stage: non-finite {bad[:4]}")
    if s["base_checksum_before"] != s["base_checksum_after"]:
        raise AssertionError("GRPO stage: the frozen base changed")
    logged = json.loads((out / "grpo_log.json").read_text())
    if len(logged) != len(hist) or len(hist) != steps:
        raise AssertionError(f"GRPO stage: grpo_log.json holds {len(logged)} rows")
    start = make_lora_params(run.model, rank=4, seed=0)
    now = lora_tree(run.model)
    moved = {part: sum(not torch.equal(now[k][part], start[k][part]) for k in start)
             for part in ("a", "b")}
    del run
    torch.cuda.empty_cache()
    return hist, s, moved, len(start)


def conv_grpo(work: Path):
    """Phase (c) 4: the GRPO stage at tiny on the card, as asked (its reward
    is JAX's precision_match), then 3 steps under a reward that varies, in
    which the policy gradient must move the adapters' B."""
    from glimpseprune_torch.training.grpo import SCORE_FUNCS

    hist, s, moved, n = conv_grpo_run(CONV_GRPO, work / "grpo", CONV_GRPO_STEPS)
    if not moved["a"] + moved["b"]:
        raise AssertionError("GRPO stage: the adapters did not move")
    if "conv_char_parity" not in SCORE_FUNCS:
        SCORE_FUNCS.register("conv_char_parity")(conv_char_parity)
    _, ps, pmoved, _ = conv_grpo_run(CONV_GRPO_VARYING, work / "grpo_varying", 3)
    if not pmoved["b"]:
        raise AssertionError(f"GRPO stage: a varying reward left B as drawn ({pmoved})")
    probes = [h for h in hist if "probe_acc_policy" in h]
    return {"s_per_step": s["s_per_step"], "reward_first": s["first_reward"],
            "reward_last": s["last_reward"],
            "rewarded_steps": sum(h["mean_score"] > 0 for h in hist),
            "adapters_moved": moved, "adapters": n,
            "probe": [(h["step"], h["probe_acc_policy"], h["probe_acc_frozen"]) for h in probes],
            "kd_loss_last": hist[-1]["kd_loss"], "varying_reward_moved": pmoved,
            "varying_reward": [ps["first_reward"], ps["last_reward"]]}


def conv_demo_int8(image_path: str):
    """Phase (c) 6: ``demo --int8`` at 7B width (20 layers): the model's
    linears hold int8 weights (the model that ``quantize_model`` saw), the
    answer's ids lie in the vocabulary and the mask logits are finite."""
    import torch

    from glimpseprune_torch import quantization
    from glimpseprune_torch.models.qwen2_5_vl.runner import _weight_tier
    from glimpseprune_torch.tools import demo

    seen = []
    real = quantization.quantize_model

    def spy(model, mode, *a, **kw):
        seen.append(model)
        return real(model, mode, *a, **kw)

    quantization.quantize_model = spy
    try:
        t0 = time.perf_counter()
        res = demo.main(["--image", image_path, "--question", "Where is the bright rectangle?",
                         "--max-new-tokens", str(CONV_NEW_TOKENS), "--int8", "--model-config",
                         cut_config_dir(), "--seed", "0"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        quantization.quantize_model = real
    [model] = seen
    tiers = {"text": _weight_tier(model.text), "vision": _weight_tier(model.visual)}
    vocab = model.cfg.text.vocab_size
    ok = (tiers == {"text": "int8", "vision": "int8"}
          and bool(((res.sequences >= 0) & (res.sequences < vocab)).all())
          and bool(np.isfinite(res.mask_logits).all()))
    if not ok:
        raise AssertionError(f"demo --int8: tiers {tiers}, tokens {res.sequences}")
    del seen, model
    torch.cuda.empty_cache()
    return {"s": secs, "tiers": tiers, "tokens": res.sequences[0].tolist(),
            "kept": int(res.keep_img.sum()), "prune_ratio": float(res.prune_ratio[0])}


def run_convergence_phase(smi):
    """Phase (c): the synthetic-boxes training tools at full width on the
    card (after phase 16, when the card holds no model) -> (record,
    {part: launches})."""
    import tempfile

    import torch

    from glimpseprune_torch.tools import convergence_run, sweep_reduce_quality

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_conv_", dir=ROOT / "build"))
    data = work / "data"
    rec, launches, part_s = {}, {}, {}
    mark = [time.perf_counter()]

    def lap(part):  # the part's seconds, model builds and checks included
        now = time.perf_counter()
        part_s[part], mark[0] = now - mark[0], now

    # 1. the base stage: 7B (q8) weights-only, 100 steps
    reset_launches()
    base = convergence_run.main(CONV_ARGS + ["--steps", str(CONV_STEPS), "--out",
                                             str(work / "base"), "--data-root", str(data)])
    torch.cuda.synchronize()
    launches["base"] = read_launches(CONV_TRAIN_KERNELS)
    hist, s = base.history, base.summary
    if [h["step"] for h in hist] != list(range(1, CONV_STEPS + 1)):
        raise AssertionError(f"base stage history steps {[h['step'] for h in hist][:8]}...")
    bad = [(h["step"], k) for h in hist for k in ("loss", "loc_loss", "le_loss")
           if not np.isfinite(h[k])]
    if bad:
        raise AssertionError(f"base stage: non-finite {bad[:4]}")
    mean = lambda rows, k: float(np.mean([h[k] for h in rows]))  # noqa: E731
    curve = {"loss_first5": mean(hist[:5], "loss"), "loss_last20": mean(hist[-20:], "loss"),
             "iou_first5": mean(hist[:5], "mask_iou"), "iou_last20": mean(hist[-20:], "mask_iou")}
    if not (curve["loss_last20"] < curve["loss_first5"]
            and curve["iou_last20"] > curve["iou_first5"]):
        raise AssertionError(f"the base stage did not converge: {curve}")
    if s["base_checksum_before"] != s["base_checksum_after"]:
        raise AssertionError("the base stage changed the frozen int8 base")
    rec["base"] = {**curve, **{k: s[k] for k in ("s_per_step", "host_s", "host_share",
                                                  "peak_gib", "wall_s")},
                   "s_per_step_after_first": (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"])
                   / (len(hist) - 1),
                   "at": {h["step"]: {k: h[k] for k in ("loss", "mask_iou", "mask_precision",
                                                        "mask_recall")}
                          for h in hist if h["step"] in (1, 50, 100)},
                   "checksum": s["base_checksum_after"]}
    print(f"phase (c) base stage on {smi}: " + json.dumps(rec["base"]), flush=True)
    lap("base")

    # 3. the trained modules served (before the resume runs replace the model)
    base_rows = hist
    served, launches["serve"] = conv_served(base, work / "base", work)
    rec["served"] = served
    base.model = None
    del base
    torch.cuda.empty_cache()
    tr, un = served["trained"], served["untrained"]
    print(f"convergence: trained modules mean precision {tr['mean_precision']:.4f} recall "
          f"{tr['mean_recall']:.4f} kept {tr['mean_kept']:.1f}; untrained "
          f"{un['mean_precision']:.4f} / {un['mean_recall']:.4f} / {un['mean_kept']:.1f} "
          f"(cap {tr['images'][0]['cap']:.0f}) on {smi}", flush=True)
    for arm in ("trained", "untrained"):
        print(f"phase (c) {arm} keep sets: " + json.dumps(served[arm]["images"]))
    if not tr["mean_precision"] > un["mean_precision"]:
        raise AssertionError("the trained modules' keep sets are no more precise than the "
                             f"untrained ones': {tr['mean_precision']} vs {un['mean_precision']}")
    lap("serve")

    # 2. resume
    reset_launches()
    rec["resume"] = conv_resume(CONV_ARGS, work, data, base_rows)
    launches["resume"] = read_launches(CONV_TRAIN_KERNELS)
    print(f"phase (c) resume on {smi}: " + json.dumps(rec["resume"]), flush=True)
    lap("resume")

    # 4. the GRPO stage at tiny
    reset_launches()
    rec["grpo"] = conv_grpo(work)
    launches["grpo"] = read_launches(CONV_GRPO_KERNELS)
    print(f"phase (c) GRPO stage on {smi}: " + json.dumps(rec["grpo"]), flush=True)
    lap("grpo")

    # 5. the sweep
    reset_launches()
    sweep = sweep_reduce_quality.main(CONV_SWEEP + ["--data-root", str(work / "sweep")])
    launches["sweep"] = read_launches(["flash_attention_backward[causal]"])
    written = json.loads((work / "sweep" / "sweep_reduce_layer.json").read_text())
    if written != sweep or len(written["rows"]) != 2 or not all(
            np.isfinite(r["iou_tiny8_proxy"]) for r in written["rows"]):
        raise AssertionError(f"sweep_reduce_quality wrote {written}")
    rec["sweep"] = written["rows"]
    lap("sweep")

    # 6. demo --int8
    img = work / "heldout_0.npy"
    np.save(img, np.random.default_rng(CONV_HELD_SEED).integers(
        0, 256, (CONV_SIDE, CONV_SIDE, 3), dtype=np.uint8))
    reset_launches()
    rec["demo_int8"] = conv_demo_int8(str(img))
    launches["demo_int8"] = read_launches(["window_attention_fused", "flash_attention[causal]"])
    print(f"phase (c) demo --int8 on {smi}: " + json.dumps(rec["demo_int8"]), flush=True)
    lap("demo_int8")
    shutil.rmtree(work)
    rec["phase_s"], rec["part_s"] = time.perf_counter() - t_phase, part_s
    print(f"phase (c) on {smi}: {rec['phase_s']:.1f} s " + json.dumps(
        {k: round(v, 1) for k, v in part_s.items()}))
    return rec, launches


BENCH_TEXT_LAYERS = 20  # the depth floor: reduce layer 18 + 2
BENCH_ROWS = 2  # each side's rows in the aggregated protocol
BENCH_NEW_TOKENS = 32
# the continuous ladder's first pruned rung: its batcher's cache, and its
# second rung's (B // 2), exceed the card's memory, so both fail at
# allocation and the side is served at JAX's last rung, 4
BENCH_LADDER_ROWS_P = 4096
BENCH_CONT_ROWS_U = 2
BENCH_KERNELS = ["window_attention_fused", "flash_attention[causal]",
                 "flash_attention[dqk_ne_dv]"]
BENCH_FLAGS = ["--scale", "7b", "--quant", "int8", "--act-quant", "prefill", "--qk-int8", "0",
               "--pv-int8", "0", "--kv-quant", "int8", "--max-pixels", str(BENCH_MAX_PIXELS),
               "--serve-chunk", "1", "--serve-inter-steps", "8", "--decode",
               str(BENCH_NEW_TOKENS), "--text-layers", str(BENCH_TEXT_LAYERS), "--seed", "0"]
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


def token_tie(name, got, want, want_logits):
    """None where the token lists got and want [n] agree; else, at the first
    token j that differs (token j comes from want_logits[j]), got's token
    must lie within CROSS_LOGIT_RTOL of max |logit| of the reference's top
    logit (a near tie the reference's arithmetic could have taken either
    way), or raise. -> record."""
    differ = np.nonzero(got != want)[0]
    if not len(differ):
        return None
    j = int(differ[0])
    lg = want_logits[j].float()
    gap = ((lg.max() - lg[int(got[j])]) / lg.abs().max()).item()
    rec = {"first_difference": j, "gap_rel": gap}
    if not gap <= CROSS_LOGIT_RTOL:
        raise AssertionError(f"{name}: token {j} differs from the reference's without a near "
                             f"tie: {rec}")
    return rec


def bench_cache_bytes(cfg, b: int, r: int, n_dec: int, inter: int) -> int:
    """The bytes of a ContinuousBatcher's int8 caches at capacity b (k and
    v, int8 with fp32 scales per slot and head; serving.py's T)."""
    need = -(-n_dec // inter)
    t = r + (b + need + 1) * inter
    per_slot = cfg.text.num_key_value_heads * (cfg.text.head_dim + 4)
    return 2 * cfg.text.num_hidden_layers * b * t * per_slot


def run_bench_phase(smi):
    """Phase (p): bench.py's three serving protocols through
    ``tools.bench_protocols`` on the 7B (q8) at full width, cut to
    BENCH_TEXT_LAYERS layers, on the 16k-token image (after phase (c), when
    the card holds no model): the aggregated protocol at BENCH_ROWS rows a
    side, e2e with one iteration at the ~1.3k-token point, each side's tokens against the runner's
    own decode over one row; then ``main`` in continuous mode from a pruned
    rung whose cache cannot fit on the card, its requests' tokens against
    the same references. -> (record, {part: launches})."""
    import gc
    import tempfile

    import torch

    from glimpseprune_torch.tools import bench_protocols as bp

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_bench_", dir=ROOT / "build"))
    rows = ["--serve-rows-p", str(BENCH_ROWS), "--serve-rows-u", str(BENCH_ROWS)]
    args = bp.parse_args(["--mode", "serving"] + BENCH_FLAGS + rows)
    rec, launches, part_s = {}, {}, {}
    mark = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        part_s[part], mark[0] = now - mark[0], now

    def line(name, result):
        if set(result) != BENCH_LINE_KEYS or not np.isfinite(result["value"]):
            raise AssertionError(f"bench_protocols {name}: the line {result}")
        print(f"phase (p) bench_protocols {name} on {smi}: " + json.dumps(result), flush=True)
        return result

    s = bp.setup(args)
    cfg, runner = s.cfg, s.runner
    lap("setup")
    # 1. the aggregated protocol
    reset_launches()
    serving = bp.run_serving(args, s=s)
    torch.cuda.synchronize()
    launches["serving"] = read_launches(BENCH_KERNELS)
    rec["serving"] = {"line": line("serving", serving.result), "sides": serving.sides}
    lap("serving")
    # 2. e2e, one iteration of each timing
    # at the ~1.3k-token point (BENCH_MAX_PIXELS=0): the phase's budget
    e2e_args = bp.parse_args(["--mode", "e2e"] + BENCH_FLAGS + [
        "--max-pixels", "0", "--iters", "1", "--decode-iters", "1"])
    reset_launches()
    e2e = bp.run_e2e(e2e_args, model=s.model)
    torch.cuda.synchronize()
    launches["e2e"] = read_launches(BENCH_KERNELS)
    rec["e2e"] = {"line": line("e2e", e2e.result), "sides": e2e.sides}
    for side, toks in e2e.tokens.items():
        if toks.shape != (1, BENCH_NEW_TOKENS) or not ((toks >= 0) & (
                toks < cfg.text.vocab_size)).all():
            raise AssertionError(f"e2e {side} decode gave {toks}")
    lap("e2e")
    # the references: the runner's prefill of one row and its captured
    # decode step replayed one step at a time
    refs, checks = {}, {}
    with torch.inference_mode():
        for side in ("pruned", "unpruned"):
            pre = runner.prefill(s.prep, do_selection=side == "pruned")
            toks, lg = stepwise_decode(runner, one_row(pre), BENCH_NEW_TOKENS)
            refs[side] = (toks, [x.float().cpu() for x in lg])
            del pre, lg
    for side, seqs in serving.tokens.items():
        checks[f"serving {side}"] = {
            "rows_identical": bool((seqs == seqs[0]).all()),
            "ties": [token_tie(f"serving {side} row {i}", row, *refs[side])
                     for i, row in enumerate(seqs)]}
        print(f"phase (p) serving {side} tokens against the runner's decode: "
              + json.dumps(checks[f"serving {side}"]), flush=True)
    lap("references")
    del s, runner, e2e
    gc.collect()
    torch.cuda.empty_cache()
    # 3. continuous, each side in its own processes down JAX's ladder
    r_p = serving.sides["pruned"]["T"] - BENCH_NEW_TOKENS
    total = torch.cuda.get_device_properties(0).total_memory
    over = [bench_cache_bytes(cfg, b, r_p, BENCH_NEW_TOKENS, 8)
            for b in (BENCH_LADDER_ROWS_P, BENCH_LADDER_ROWS_P // 2)]
    if not min(over) > total:
        raise AssertionError(f"the failing rungs' caches {over} fit in the card's {total} bytes")
    cont = bp.main(["--mode", "continuous"] + BENCH_FLAGS + [
        "--serve-rows-p", str(BENCH_LADDER_ROWS_P), "--serve-rows-u", str(BENCH_CONT_ROWS_U),
        "--save-tokens", str(work)])
    line("continuous", cont.result)
    rungs = {side: cont.sides[side]["rungs"] for side in ("pruned", "unpruned")}
    want_rungs = {"pruned": [{"B": BENCH_LADDER_ROWS_P, "outcome": "oom"},
                             {"B": BENCH_LADDER_ROWS_P // 2, "outcome": "oom"},
                             {"B": 4, "outcome": "served"}],
                  "unpruned": [{"B": BENCH_CONT_ROWS_U, "outcome": "served"}]}
    if rungs != want_rungs:
        raise AssertionError(f"continuous ladder: {rungs}, not {want_rungs}")
    det = cont.result["detail"]
    if (det["pruned_batch"], det["unpruned_batch"]) != (4, BENCH_CONT_ROWS_U):
        raise AssertionError(f"continuous detail names B = {det['pruned_batch']} / "
                             f"{det['unpruned_batch']}")
    for side, seqs in cont.tokens.items():
        checks[f"continuous {side}"] = {
            "requests": len(seqs),
            "equal_to_aggregated": int((seqs == serving.tokens[side][0]).all(1).sum()),
            "ties": [token_tie(f"continuous {side} request {i}", row, *refs[side])
                     for i, row in enumerate(seqs)]}
        print(f"phase (p) continuous {side} tokens against the runner's decode: "
              + json.dumps(checks[f"continuous {side}"]), flush=True)
    if set(cont.tokens) != {"pruned", "unpruned"}:
        raise AssertionError(f"continuous tokens for {sorted(cont.tokens)} only")
    rec["continuous"] = {"line": cont.result, "rungs": rungs, "sides": cont.sides,
                         "failing_rung_bytes": over, "card_bytes": total}
    lap("continuous")
    rec["checks"] = checks
    shutil.rmtree(work)
    rec["phase_s"], rec["part_s"] = time.perf_counter() - t_phase, part_s
    print(f"phase (p) on {smi}: {rec['phase_s']:.1f} s " + json.dumps(
        {k: round(v, 1) for k, v in part_s.items()}))
    return rec, launches


SWEEP_ITERS = 2  # timed calls a row in phase (k)
SWEEP_CHECK_ROWS = 128  # q rows on which phase (k) holds K2 and K7 to their plain versions
SWEEP_PATCHES = 65536  # the 16k-token image's ViT (4086 x 4086 capped at 12845056 pixels)
SWEEP_KERNELS = ["window_attention_fused", "flash_attention[dense]",
                 "flash_attention[segmented]", "flash_attention[causal]",
                 "flash_attention_int8[dense]", "flash_attention_int8[dense+pv8]",
                 "flash_attention_int8[causal]", "flash_attention_int8[causal+pv8]"]
# the whole script's seconds on an H100 80GB HBM3 at 700 W before phase (k)
# was added (PERF.md §5), printed beside this run's
SCRIPT_S_BEFORE_K = 891.1


def run_sweeps_phase(smi):
    """Phase (k): the three ViT kernel sweeps of glimpseprune_torch/tools/
    in process at the 16k-token image's 65,536 patches, SWEEP_ITERS timed
    calls a row, after phase (p), when the card holds no model:
    sweep_vision_attention's sections 1 and 1b, sweep_vit_fullatt (which
    times dense K2 and SDPA at section 2's shape too) and i8attn_microbench
    with the ViT at SWEEP_PATCHES. Every check the tools make must hold: K1
    at each heads-per-block count bit-equal to the shipped plan's output
    and within phase 3's limits of its plain version; K1's output inside
    the (q8) and the weight-only windowed block against its plain version
    on the qkv the block gave it; K2 (dense, segmented, causal) and K7
    (each PV flavour) against their plain versions on SWEEP_CHECK_ROWS q
    rows; one launch a call on each wrapper's counter. -> (record,
    launches, kernel rows at the 65,536 shape: K1, dense and segmented K2,
    K7 and K7 +pv8)."""
    import torch

    from glimpseprune_torch.tools import i8attn_microbench, sweep_vision_attention
    from glimpseprune_torch.tools import sweep_vit_fullatt
    from glimpseprune_torch.tools.kernel_ab import write_report

    t_phase = time.perf_counter()
    common = ["--iters", str(SWEEP_ITERS), "--check-rows", str(SWEEP_CHECK_ROWS)]
    runs = (("sweep_vision_attention", sweep_vision_attention,
             ["1", "1b", "--patches", str(SWEEP_PATCHES)]),
            ("sweep_vit_fullatt", sweep_vit_fullatt, ["--seq", str(SWEEP_PATCHES)]),
            ("i8attn_microbench", i8attn_microbench, ["--s-vit", str(SWEEP_PATCHES)]))
    reset_launches()
    rec, part_s = {}, {}
    for name, tool, argv in runs:
        t0 = time.perf_counter()
        rec[name] = tool.run(tool.parse_args(argv + common))
        torch.cuda.synchronize()
        part_s[name] = time.perf_counter() - t0
        write_report(name, rec[name], str(ROOT / "build" / "chip_smoke_sweeps" / f"{name}.json"))
        if rec[name]["failures"]:
            raise AssertionError(f"phase (k) {name}: {rec[name]['failures']}")
        torch.cuda.empty_cache()
    launches = read_launches(SWEEP_KERNELS)
    vis, full, i8 = (rec[n] for n, _, _ in runs)
    k1 = next(r for r in vis["sections"]["1"]["rows"] if r["shipped"])
    full_rows = {r["name"]: r for r in full["rows"]}
    library = full_rows[full["best_sdpa"]] if full["best_sdpa"] else None
    vit = {r["name"]: r for r in i8["shapes"]["vit"]}

    def kernel_row(name, r, replaces, plain_ms, library_ms):
        return {"name": name, "route": "cuda", "source": K1_SRC if name.startswith("window")
                else K2_SRC, "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "rel_err": r["rel_err"],
                "rms_rel_err": r["rms_rel_err"], "ms": r["ms"], "device_ms": r["device_ms"],
                "plain_ms": plain_ms, "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library_ms, "shape": r["shape"], "phase": "k"}

    rows = [kernel_row("window_attention_fused", k1, K1_REPLACES, vis["sections"]["1"]["plain_ms"],
                       None)]
    for fl in ("dense", "segmented"):
        r = full_rows[f"flash_attention[{fl}]"]
        rows.append(kernel_row(f"flash_attention[{fl}]", r, K2_REPLACES, r["plain_ms"],
                               None if library is None else library["ms"]))
        rows[-1]["library"] = None if library is None else library["name"]
    for variant, key in (("qk8", "dense"), ("all8", "dense+pv8")):
        r = vit[variant]
        rows.append(kernel_row(f"flash_attention_int8[{key}]", r, K7_REPLACES["dense"],
                               r["plain_ms"], vit["sdpa"]["ms"]))
        rows[-1].update(prep_device_ms=r["prep_device_ms"],
                        attention_device_ms=r["attention_device_ms"],
                        library="bf16 SDPA, not K7's function")
    for r in rows:
        r["plain_rows"] = None if r["name"].startswith("window") else SWEEP_CHECK_ROWS
    b1 = vis["sections"]["1b"]
    rec["phase_s"], rec["part_s"] = time.perf_counter() - t_phase, part_s
    print(f"phase (k) on {smi}: {rec['phase_s']:.1f} s " + json.dumps(
        {k: round(v, 1) for k, v in part_s.items()}) + "; K1 by heads a block " + json.dumps(
        {r["heads_per_block"]: r["device_ms"] for r in vis["sections"]["1"]["rows"]})
        + "; the windowed block (w8a8 / weight-only) " + json.dumps(b1["sums"], default=str)
        + "; K1 in the block against its plain version " + json.dumps(b1["block_checks"]),
        flush=True)
    return rec, launches, rows


def main() -> int:
    smi = find_card()
    import torch

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner
    from glimpseprune_torch.tools.common import depth_cut

    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name):  # the seconds since the previous lap, per phase
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now
        print(f"phase time: {name} {laps[name]:.1f} s (script {now - t_start:.1f} s)",
              flush=True)

    build_s = build_kernels()
    lap("2 build")
    cfg = ModelConfig.load(str(ROOT / "configs" / "model_qwen2_5_7b_gp"))
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (896, 672, 3), dtype=np.uint8),
              rng.integers(0, 256, (672, 504, 3), dtype=np.uint8)]
    lo, hi = 1000, 150000  # ordinary text ids, clear of the special tokens
    # (a) two rows, two image sizes: segmented ViT attention, padded windows,
    # left-padded LLM rows; (b) one 896x672 image: 3072 patches, one unpadded
    # segment, so the ViT's full attention takes the dense flavour
    prompts_a = make_prompts(cfg, rng, 2, lo, hi)
    prep_a = prepare_inputs(cfg, prompts_a, images)
    prep_b = prepare_inputs(cfg, make_prompts(cfg, rng, 1, lo, hi), images[:1])
    # (a)'s rows as B=1 requests, for the serving-shaped decode and the
    # continuous-serving phase; padded to (a)'s length for its unpruned
    # requests, which then take (a)'s S - le_length slots
    rows_a = [prepare_inputs(cfg, [prompts_a[i]], [images[i]]) for i in range(2)]
    rows_u = [prepare_inputs(cfg, [prompts_a[i]], [images[i]],
                             seq_multiple=prep_a.input_ids.shape[1]) for i in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_window_attention(cfg, prep_a, gen)]
    k8_row = check_window_attention_unfused(cfg, prep_a, gen)
    window_edges = check_window_edges(gen)
    kernels += check_flash_attention(cfg, prep_a, prep_b, gen)
    flash_edges = check_flash_edges(gen)
    lap("3-4 K1, K8, K2")

    t0 = time.perf_counter()
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init_random: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    with sync_checked():
        runs, serve_launches = run_main_path(cfg, model, [("a", prep_a), ("b", prep_b)])
    lap("6 main path")
    decode_checks = {"bf16": run_decode_checks(cfg, GlimpsePruneRunner(cfg, model), prep_a,
                                               rows_a, "bf16")}
    lap("6 decode checks")
    # phase 12: continuous serving, before training changes the model
    t_cont = time.perf_counter()
    continuous = {"bf16": run_continuous_serving(cfg, GlimpsePruneRunner(cfg, model), prep_a,
                                                 rows_a, rows_u, "bf16", smi)}
    continuous_s = time.perf_counter() - t_cont
    lap("12 continuous serving")
    # phase 13: delayed selection, the oracle masks, harvest_rows and a
    # GlimpsePrune+ (GRPO) run, which leaves the model as it found it
    glimpse_plus, glimpse_plus_launches = run_glimpse_plus(cfg, model, prep_a, prompts_a,
                                                           images)
    small = check_small_reference()
    lap("13 GlimpsePrune+, 6 tiny")

    # phase 10: the compressed serving path, before training changes the model
    t_comp = time.perf_counter()
    compressed_runs, compressed_launches = run_compressed_path(
        cfg, model, [("a", prep_a), ("b", prep_b)], runs)
    importance_variant = run_importance_variant(cfg, model, prep_a)
    k8_row["launches"] = importance_variant["launches"]["window_attention"]
    k8_row["launches_7b_compressed"] = compressed_launches["window_attention"]
    k8_row["note"] = (f"launches: the importance path of a vision config with full attention "
                      f"at {WINDOWED_LAST_FULLATT} (not in configs/), 4 ViT calls; 0 on the "
                      "published 7B's compressed path")
    small_importance = check_small_importance(cfg, model, prep_a)
    small_compressed = check_small_compressed()
    compressed_s = time.perf_counter() - t_comp
    lap("10 compressed")

    work = ROOT / "build" / "chip_smoke_train"
    trainer = make_trainer(cfg, model, work)
    first = trainer.collate(trainer.cfg, next(trainer.dataset.batches(2, seed=0)),
                            trainer.tokenize, trainer.load_image, trainer.tcfg, device="cuda")
    train_kernels, dense_check = check_flash_training(cfg, first, gen)
    print("K2-lse and K3 small dense case (checked, not on the training path): "
          + json.dumps(dense_check))
    kernels += train_kernels
    t_train = time.perf_counter()
    steps, train_launches = run_training_path(trainer)
    train_s = time.perf_counter() - t_train
    small_train = check_small_train_step()
    shutil.rmtree(work, ignore_errors=True)
    del trainer, model, first
    torch.cuda.empty_cache()
    lap("5, 7 training")

    # phase 8: the quantized tiers' kernels at the main path's shapes
    quant_kernels, k4_report, k5_report, k6_report = check_int4_kernels(
        cfg, gen, decode_m=prep_a.input_ids.shape[0], prefill_m=int(prep_a.valid.size),
        vit_m=prep_a.patches.shape[0])
    k7_rows, k7_report = check_flash_int8(cfg, prep_a, prep_b, gen)
    quant_kernels += k7_rows
    # K4 and K6 on phase (m)'s shards: column shards and repacked row shards
    tp_int4_rows, tp_int4_report = check_int4_tp_shards(
        cfg, gen, decode_m=prep_a.input_ids.shape[0], prefill_m=int(prep_a.valid.size))
    lap("8 K4-K7, (m) K4/K6 shards")
    # phase 9: the quantized serving path
    t_quant = time.perf_counter()
    quant_runs, quant_launches, small_quant = [], {}, {}
    for tier in QUANT_TIERS:
        tier_runs, quant_launches[tier], decode_checks[tier], cont, lora = run_quant_tier(
            depth_cut(cfg, QUANT_TEXT_LAYERS), tier, [("a", prep_a), ("b", prep_b)], rows_a,
            rows_u, smi)
        if cont is not None:
            continuous[tier] = cont
        if lora is not None:
            glimpse_plus["q4_lora"] = lora
        quant_runs += tier_runs
        small_quant[tier] = check_small_quant(tier)
    quant_s = time.perf_counter() - t_quant
    lap("9 quantized tiers")

    # phase 11: K9 against its plain versions and the monolithic kernels,
    # then the SP path over SP_WORLD ranks on this card (the parent holds no
    # model: each rank builds its own 7B)
    torch.cuda.empty_cache()
    k9_rows, k9_report = check_flash_qpos(cfg, prep_a, gen)
    k1_tp_heads = check_window_attention_tp_heads(cfg, prep_a, gen)
    torch.cuda.empty_cache()
    lap("11 K9, (m) K1 heads")
    sp_ranks, sp_launches, sp_s = run_sp_path([("a", prep_a), ("b", prep_b)])
    lap("11 SP ranks, (m)")
    for k in k9_rows:
        k["launches"] = sp_launches[k["name"]]
        k["launches_per_rank"] = [r["launches"].get(k["name"], 0) for r in sp_ranks]
    # phase 14: LLaVA-1.5-7B (the parent's earlier models are gone)
    torch.cuda.empty_cache()
    llava_rows, llava, llava_launches = run_llava_phase(gen, smi)
    lap("14 LLaVA")
    # phase 15: the evaluation path through the command lines (no model held)
    torch.cuda.empty_cache()
    evaluation, eval_launches = run_eval_phase(cfg, prep_a, smi)
    lap("15 evaluation")
    # phase 16: the native prep, the profilers and the interactive tools (no model held)
    torch.cuda.empty_cache()
    tools, tools_launches = run_tools_phase(cfg, evaluation.pop("outputs"), smi)
    lap("16 tools")
    # phase (c): the synthetic-boxes training tools (no model held)
    torch.cuda.empty_cache()
    convergence, conv_launches = run_convergence_phase(smi)
    lap("(c) convergence")
    # phase (p): bench.py's serving protocols through tools.bench_protocols (no model held)
    torch.cuda.empty_cache()
    bench_protocols, bench_launches = run_bench_phase(smi)
    lap("(p) bench protocols")
    # phase (k): the ViT kernel sweeps at the 16k image's 65,536 patches (no model held)
    torch.cuda.empty_cache()
    sweeps, sweep_launches, sweep_rows = run_sweeps_phase(smi)
    lap("(k) kernel sweeps")

    for k in kernels:
        path = train_launches if k["name"].startswith(("flash_attention_lse",
                                                       "flash_attention_backward")) else \
            serve_launches
        k["launches"] = path[k["name"]]
    kernels.insert(1, k8_row)
    off_path = {  # why a checked flavour has no launch on the (q4) path
        "matmul_int4_prefill[a16": "no shape routes W4A16 (JAX int4_matmul.py:268)",
        "flash_attention_int8[causal": "q4 runs int8 attention in the ViT only",
        "flash_attention_int8[": "q4 runs the ViT's int8 attention with int8 PV"}
    for k in quant_kernels:  # launches on the (q4) quantized serving path
        k["launches"] = quant_launches["q4"].get(k["name"], 0)
        if not k["launches"]:
            k["note"] = next(v for p, v in off_path.items() if k["name"].startswith(p))
    kernels += quant_kernels
    for k in tp_int4_rows:  # launches on phase (m)'s (q4) mesh, summed over the ranks
        k["launches"] = sum(r["tp_launches"].get(k["name"], 0) for r in sp_ranks)
        if not k["launches"]:
            raise AssertionError(f"the (q4) mesh never launched {k['name']}")
    kernels += tp_int4_rows
    kernels += k9_rows
    llava_names = {k["name"] for k in llava_rows}
    for k in kernels:  # phase 12's timed serves' launches, bf16 and (q4)
        if k["name"] not in llava_names:
            k["launches_llava"] = {part: counts.get(k["name"], 0)
                                   for part, counts in llava_launches.items()}
        k["launches_continuous"] = {tier: {side["side"]: side["launches"].get(k["name"], 0)
                                           for side in c["sides"]}
                                    for tier, c in continuous.items()}
        # phase 13: the whole bf16 phase, and the GRPO steps' own counts
        k["launches_glimpse_plus"] = {
            "bf16": glimpse_plus_launches.get(k["name"], 0),
            "q4_lora": glimpse_plus["q4_lora"]["launches"].get(k["name"], 0),
            "grpo_per_step": [st["launches"].get(k["name"], 0)
                              for st in glimpse_plus["grpo"]["steps"]]}
    for k in llava_rows:  # phase 14: LLaVA's main path, its two train steps, its (q8) tier
        k["launches_llava"] = {part: counts.get(k["name"], 0)
                               for part, counts in llava_launches.items()}
    kernels += llava_rows
    for k in kernels:  # phase 15: the CLIs' calls, and the (q4) full-params round trip
        k["launches_eval"] = {part: counts.get(k["name"], 0)
                              for part, counts in eval_launches.items()}
    for k in kernels:  # phase 16: the profilers, the demo server and the attention maps
        k["launches_tools"] = tools_launches.get(k["name"], 0)
    for k in kernels:  # phase (c): the training tools' parts
        k["launches_conv"] = {part: counts.get(k["name"], 0)
                              for part, counts in conv_launches.items()}
    for k in kernels:  # phase (p): the aggregated protocol's and e2e's launches in process
        k["launches_bench"] = {part: counts.get(k["name"], 0)
                               for part, counts in bench_launches.items()}
    for k in kernels:  # phase (k): the three kernel sweeps at 65,536 patches
        k["launches_sweeps"] = sweep_launches.get(k["name"], 0)
    for k in sweep_rows:
        k["launches_sweeps"] = k["launches"]
    kernels += sweep_rows
    for k in kernels:  # phase (m): each rank's launches on the mesh
        k["launches_tp"] = [r["tp_launches"].get(k["name"], 0) for r in sp_ranks]
    for k in kernels:
        print(speed(k))
    for r in sp_ranks:
        tp = r["tp"]
        print(f"mesh (TP over {SP_WORLD} ranks, gloo) on {smi}, rank {r['rank']}: " + "; ".join(
            f"{tier} " + ", ".join(
                f"{run['mode']} prefill {run['prefill_ms']:.1f} ms (one process "
                f"{run.get('single_prefill_ms', float('nan')):.1f}), eager decode "
                f"{run['eager_decode_ms_per_token']:.2f} ms/token (one process eager "
                f"{run.get('single_eager_ms_per_token', float('nan')):.2f}, captured "
                f"{run.get('single_captured_ms_per_token', float('nan')):.2f}), peak "
                f"{run['peak_mem_gib']:.2f} GiB" for run in tp[tier]["runs"])
            + ", gloo " + json.dumps({k: round(v, 3) for k, v in tp[tier]["gloo_ms"].items()})
            for tier in ("bf16", "q8", "q4", "llava"))
            + f"; TP loss+grad {tp['bf16']['train']['loss_and_grad_ms']:.1f} ms; TP GRPO step "
            f"{tp['bf16']['grpo']['ms']:.1f} ms; TP compressors' prefills "
            f"{tp['bf16']['compressed'].get('ms', float('nan')):.1f} ms; phase "
            f"{tp['phase_s']:.1f} s " + json.dumps({k: round(v, 1)
                                                     for k, v in tp['tier_s'].items()}))
    g = glimpse_plus["grpo"]
    print(f"GlimpsePrune+ on {smi}: " + ", ".join(
        f"step {st['step']} {st['ms']:.1f} ms, peak {st['peak_mem_gib']:.2f} GiB, K2-lse causal "
        f"{st['k2_lse_causal']}, K3 causal {st['k3_causal']}" for st in g["steps"])
        + f"; peak over the model {g['peak_over_model_gib']:.2f} GiB; phase "
        f"{glimpse_plus['phase_s']:.1f} s")
    ll = llava["runs"]
    print(f"LLaVA-1.5-7B on {smi}: " + ", ".join(
        f"{r['mode']} prefill {r['prefill_ms']:.1f} ms, decode {r['decode_ms_per_token']:.2f} "
        f"ms/token, peak {r['peak_mem_gib']:.2f} GiB" for r in ll)
        + f"; kept {ll[0]['kept_img_tokens']} of 576; train steps "
        + ", ".join(f"{st['ms']:.1f} ms" for st in llava["train"]["steps"])
        + f"; (q8) prefill {llava['q8']['prefill_ms']:.1f} ms; phase {llava['phase_s']:.1f} s")
    ev, fp = evaluation, evaluation["full_params_q4"]
    print(f"evaluation path on {smi}: train_gp {ev['train']['s']:.1f} s (steps "
          + ", ".join(f"{ms:.1f}" for ms in ev["train"]["step_ms"])
          + f" ms, peak {ev['train']['peak_gib']:.2f} GiB); infer_viscot "
          + ", ".join(f"{t} {ev[t]['ms_per_call']:.1f} ms a call ({ev[t]['s']:.1f} s)"
                      for t in ("generate", "glimpse", "visionzip"))
          + f"; (q4) full params {fp['file_bytes']} bytes, save {fp['save_s']:.1f} s, load "
          f"{fp['load_s']:.1f} s; phase {ev['phase_s']:.1f} s")
    pf, dc, ts, gr = (tools["prefill"]["q8_16k"], tools["decode"], tools["train_step"],
                      tools["grpo_step"])
    print(f"tools on {smi}: (q8) 16k prefill S={pf['S']} vision {pf['vision_encode_ms']:.1f} | "
          f"glimpse {pf['glimpse_ms']:.1f} | reduce+resume {pf['reduce_resume_ms']:.1f} | total "
          f"{pf['pruned_prefill_ms']:.1f} ms, prep {pf['prepare_inputs_ms']:.1f} ms, peak "
          f"{pf['peak_gib']:.2f} GiB; decode slope " + ", ".join(
              f"{t} {d.get('slope_ms_per_1k_ctx', float('nan')):.4f} ms/1k" for t, d in dc.items())
          + f"; train step side {ts['img_side']} {ts['train_step_s'] * 1e3:.1f} ms, peak "
          f"{ts['peak_gib']:.2f} GiB; GRPO chunked {gr['step_chunked']}, full logits "
          f"{gr['step_full_logits']}; phase {tools['phase_s']:.1f} s")
    cb, cs, cg = convergence["base"], convergence["served"], convergence["grpo"]
    print(f"convergence tools on {smi}: 7B (q8) base stage {cb['s_per_step']:.3f} s/step "
          f"({cb['s_per_step_after_first']:.3f} after the first), host share "
          f"{cb['host_share']:.3f}, peak {cb['peak_gib']:.2f} GiB, loss {cb['loss_first5']:.3f} -> "
          f"{cb['loss_last20']:.3f}, IoU {cb['iou_first5']:.3f} -> {cb['iou_last20']:.3f}; "
          f"held-out keep-set precision trained {cs['trained']['mean_precision']:.3f} / "
          f"untrained {cs['untrained']['mean_precision']:.3f}; GRPO {cg['s_per_step']:.3f} "
          f"s/step, reward {cg['reward_first']:.3f} -> {cg['reward_last']:.3f}; phase "
          f"{convergence['phase_s']:.1f} s")
    bs, be = bench_protocols["serving"], bench_protocols["e2e"]["line"]["detail"]
    print(f"bench protocols on {smi}: serving " + ", ".join(
        f"{side} B={d['B']} {d['wall_s']:.2f} s ({d['prefill_share']:.3f} prefill), "
        f"{d['tok_s']:.1f} tok/s, decode {d['decode_ms_per_step']:.2f} ms/step, peak "
        f"{d['peak_gib']:.2f} GiB" for side, d in bs["sides"].items())
        + f"; e2e prefill {be['prefill_pruned_ms']:.1f} / {be['prefill_unpruned_ms']:.1f} ms, "
        f"decode ratio {be['decode_ratio']}; continuous "
        + json.dumps(bench_protocols["continuous"]["rungs"]) + f"; phase "
        f"{bench_protocols['phase_s']:.1f} s")
    for tier, d in decode_checks.items():
        sv = d["serving"]
        print(f"decode {tier} on {smi}: " + ", ".join(
            f"(a) {c['mode']} captured {c['captured_ms_per_token']:.2f} / eager "
            f"{c['eager_ms_per_token']:.2f} ms/token" for c in d["captured"])
            + f"; serving B={sv['B']} {sv['ms_per_token']:.2f} ms/token, capture "
            f"{sv['capture_ms']:.1f} ms, idle {sv['idle_share']}, peak {sv['peak_mem_gib']:.2f} GiB"
            f"; a new cache: capture {sv['second']['capture_ms']} ms, "
            f"{sv['second']['ms_per_token_with_capture']:.2f} ms/token with it, peak "
            f"{sv['second']['peak_mem_gib']:.2f} GiB")
    print(json.dumps({"card": smi, "build_s": build_s, "runs": runs,
                      "window_edge_cases": window_edges, "flash_edge_cases": flash_edges,
                      "tiny_reference_err": small, "train_steps": steps,
                      "train_path_s": train_s, "tiny_train_err": small_train,
                      "training_launches": train_launches, "quantized_runs": quant_runs,
                      "quantized_launches": quant_launches, "quantized_path_s": quant_s,
                      "tiny_quantized_err": small_quant, "decode_checks": decode_checks,
                      "k4_checks": k4_report,
                      "k5_checks": k5_report,
                      "k6_bit_equal": k6_report, "k7_checks": k7_report,
                      "compressed_runs": compressed_runs,
                      "compressed_launches": compressed_launches,
                      "importance_variant": importance_variant,
                      "importance_tower_err": small_importance,
                      "tiny_compressed_err": small_compressed,
                      "compressed_path_s": compressed_s,
                      "k9_shards": k9_report, "sp_path_s": sp_s, "sp_launches": sp_launches,
                      "tp_int4_shards": tp_int4_report,
                      "sp_ranks": sp_ranks, "k1_tp_heads": k1_tp_heads,
                      "continuous_serving": continuous,
                      "continuous_bf16_s": continuous_s, "glimpse_plus": glimpse_plus,
                      "llava": llava,
                      "evaluation": evaluation, "tools": tools, "convergence": convergence,
                      "bench_protocols": bench_protocols, "kernel_sweeps": sweeps,
                      "phase_s": laps,
                      "total_s": time.perf_counter() - t_start}, default=str))
    total_s = time.perf_counter() - t_start
    print(f"script time: {total_s:.1f} s ({SCRIPT_S_BEFORE_K} s before phase (k))")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
