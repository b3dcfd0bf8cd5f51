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
# Kernels run in bf16 and their plain versions in fp32 from the same bf16
# inputs, so the two differ by the kernel's bf16 output rounding (half an
# ulp: |x| * 2**-9, under 0.016 for the |x| < 8 these attention outputs
# stay within) plus fp32 summation order (~1e-6). 2e-2 bounds both.
KERNEL_ATOL = 2e-2
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
# K7 and its plain version run the same int8 arithmetic (exact integer
# QK^T and, with pv_int8, PV sums) and differ by the kernel's bf16 output
# rounding and the order of fp32 operations (exp2, the softmax sums, a
# rint(p * 127) that falls on the other side of a half step). Its outputs
# are small (~0.03 at the ViT shapes), so it is held relative to their
# size in two measures: the largest error over max |ref| (bf16 rounding up
# to 2**-8 of it, plus the fp32 order: 2**-7 bounds both) and the RMS error
# over the RMS of ref (bf16 rounding ~2**-7 / sqrt(12) = 2.3e-3 at most:
# 2**-8 bounds it with the fp32 order). The int8 tiers move the output by
# more (int8 QK^T against bf16 ~8e-3 RMS, the int8 PV product 1.3e-2 to
# 3e-2), so a kernel that dropped either fails; check_flash_int8 shows it
# on every run by holding each kernel output against the other references.
K7_MAX_RTOL = 2 ** -7
K7_RMS_RTOL = 2 ** -8
# K1 and K2 at the main path's shapes are held to the same two limits
# beside KERNEL_ATOL, since their outputs are as small: like Pallas they
# round P to bf16 before PV (unit roundoff 2**-8 of each probability, ~2.3e-3
# RMS of the output) and round the output to bf16. Controls that must fail:
# the plain version with P rounded to 4 significant bits (~2.7e-2 RMS off)
# and, for K2, without key tile 0 (control_attention).
# H100 SXM published peaks (NVIDIA data sheet, dense): the bf16 and int8
# tensor rates and HBM bandwidth; bound_ms is stated against them.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
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
DECODE_CHECK_TOKENS = 32
DECODE_LOGIT_RTOL = 1e-2
# the serving-shaped decode (bench.py:563-628): two B=1 prefills filled
# into one preallocated cache, then this many greedy tokens in one chunk;
# the card's idle share is traced over IDLE_TRACE_TOKENS of them
SERVE_NEW_TOKENS = 256
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
# device_ms_by_kernel: calls inside a trace before and after the timed ones
TRACE_PAD_CALLS = 10
# the kernel that torch.cuda._sleep launches, and its length (~10 us)
TRACE_MARK, TRACE_MARK_CYCLES = "spin_kernel", 20000
# full attention at three of the 7B's four blocks: the last one is windowed,
# so its importance goes through K8 (a config that is not in configs/)
WINDOWED_LAST_FULLATT = (7, 15, 23)


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
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        list(pool.map(load_library, KERNEL_LIBS))
    for name in KERNEL_LIBS:
        print(f"built {name}: {library_path(name).with_suffix('.log').read_text().strip()}")
    secs = time.perf_counter() - t0
    print(f"kernel build: {secs:.1f} s")
    return secs


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters: int = 10, tries: int = 5, per_call=None):
    """{kernel name: mean device ms per call} of the CUDA kernels that one
    call of ``fn`` launches, from torch.profiler: the card's own time,
    without the host's launch cost, which cuda_ms includes when the host is
    slower than the card. A trace in a long-lived process can lose the
    records of its first and its last kernels, up to several calls' worth,
    and can hold records left over from an earlier trace, so
    TRACE_PAD_CALLS calls run before and after the ``iters`` that count,
    and a marker kernel (``torch.cuda._sleep``, which no path launches)
    ends each of the first two groups: the kernels that count are those
    between the trace's last two markers. Each kernel's count there must be
    a whole number per call (``fn`` launches the same kernels every call),
    and its total is divided by ``iters``; ``per_call``, a dict, receives
    each kernel's launches per call. A trace that falls short of that, or
    recorded no device time, is taken again, up to ``tries`` times; then
    the result is None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for group, calls in enumerate((TRACE_PAD_CALLS, iters, TRACE_PAD_CALLS)):
                for _ in range(calls):
                    fn()
                if group < 2:
                    torch.cuda._sleep(TRACE_MARK_CYCLES)
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                          and e.time_range.elapsed_us() > 0), key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels) if TRACE_MARK in e.name][-2:]
        total, count = Counter(), Counter()
        for e in kernels[marks[0] + 1:marks[1]] if len(marks) == 2 else ():
            total[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        short = [(k[:60], c) for k, c in count.items() if c % iters]
        if short:
            print(f"device_ms: the trace of {iters} calls counted {short} launches; again")
        elif total:
            if per_call is not None:
                per_call.update({k: c // iters for k, c in count.items()})
            return {k: t / iters / 1e3 for k, t in total.items()}
        else:
            print(f"device_ms: {len(marks)} of the 2 markers in a trace of {len(kernels)} "
                  "kernels; again")
    return None


def device_ms(fn, iters: int = 10, tries: int = 3):
    """Mean device ms of one call of ``fn`` (device_ms_by_kernel summed), or
    None where not measured, never 0."""
    by = device_ms_by_kernel(fn, iters, tries)
    return None if by is None else sum(by.values())


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(least ms, what bounds it) from bf16 operations, int8 operations and
    bytes."""
    ops_ms = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    errs = k7_errors(got, ref)
    x, c, s = qkv.float(), cos.float()[:, None], sin.float()[:, None]
    nw = p // wp

    def windows(t):
        return t.reshape(nw, wp, v.num_heads, v.head_dim).transpose(1, 2)

    allowed = valid.reshape(nw, 1, 1, wp) | torch.eye(wp, dtype=torch.bool, device="cuda")
    control = control_attention(windows(x[:, 0] * c + rotate_half(x[:, 0]) * s),
                                windows(x[:, 1] * c + rotate_half(x[:, 1]) * s),
                                windows(x[:, 2]), allowed, round_p=True)
    control_errs = k7_errors(got, control.transpose(1, 2).reshape(got.shape))
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
    if not (err <= KERNEL_ATOL and k7_within(errs)):
        raise AssertionError(f"K1 disagrees with its plain version: {err}, {errs}")
    if k7_within(control_errs):
        raise AssertionError("K1: the check cannot tell the kernel from P in 4 bits")
    # no single PyTorch call applies rope and attends within windows
    return {"name": "window_attention_fused", "route": "cuda", "source": K1_SRC,
            "replaces": K1_REPLACES, "max_abs_err": err, "rel_err": errs[0],
            "rms_rel_err": errs[1], "control_rms_rel_err": control_errs[1], "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape}


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
    errs = k7_errors(got, ref)
    cos, sin = vision_rope_cos_sin(torch.as_tensor(prep.vis_pos_ids, device="cuda"), v.head_dim)
    control = window_attention_fused(torch.stack([q, k, vv], 1).contiguous(), cos.bfloat16(),
                                     sin.bfloat16(), valid, wp)
    control_errs = k7_errors(control, ref)
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
    if not k7_within(errs):
        raise AssertionError(f"K8 disagrees with its plain version: {errs}")
    if k7_within(control_errs):
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
        errs = k7_errors(got, ref)
        control_errs = {
            "p_4_bits": k7_errors(got, control_attention(q, k, vv, mask, round_p=True)),
            "k_tile_0_dropped": k7_errors(got, control_attention(q, k, vv, mask, drop_keys=64))}
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
        if not (err <= KERNEL_ATOL and k7_within(errs)):
            raise AssertionError(f"K2 {name} disagrees with its plain version: {err}, {errs}")
        passed = [c for c, e in control_errs.items() if k7_within(e)]
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
    relative limits K7_MAX_RTOL / K7_RMS_RTOL (k7_errors); with_controls,
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
    errs = [k7_errors(g, r) for g, r in zip(grads, refs)]
    abs_err = max((g.float() - r).abs().max().item() for g, r in zip(grads, refs))
    del refs
    controls = {}
    for control, kw in ((("ds_4_bits", dict(round_ds=True)),
                         ("k_tile_0_dropped", dict(drop_keys=64))) if with_controls else ()):
        ctrl = control_backward(*args, **kw)
        e = [k7_errors(g, c) for g, c in zip(grads, ctrl)]
        del ctrl
        controls[control] = (max(x[0] for x in e), max(x[1] for x in e))
    r = {"max_abs_err": abs_err, "rel_err": max(rel), "rel_err_dq_dk_dv": rel,
         "k7_errs_dq_dk_dv": errs, "controls": controls,
         "deterministic": all(torch.equal(a, b) for a, b in zip(grads, again))}
    if not (max(rel) <= GRAD_RTOL and all(k7_within(e) for e in errs)):
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

            per_call = {}
            device_ms_by_kernel(chunk, iters=2, per_call=per_call)
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
        chunked_recs, refs_u = check_chunked_prefill(cfg, runner, prep_a, rows_u, n)
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
    unpruned = continuous_side(cfg, runner, "s-u", [chunked(rows_u[i]) for i in CONT_REQUESTS],
                               [refs_u[i] for i in CONT_REQUESTS], r_u, tier, required["s-u"])
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
    rec = {"tier": tier, "sides": [pruned, unpruned], "chunked_prefill": chunked_recs,
           "sampled": sampled, "pruned_prefill_ms": prefill_ms,
           "chunk_ms": [ms for ms, _ in chunk_calls],
           "chunk_launches": dict(in_chunks)}
    print(f"continuous serving {tier} " + json.dumps(rec))
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


def k7_errors(got, ref):
    """(max error / max |ref|, RMS error / RMS of ref)."""
    d = got.float() - ref.float()
    return ((d.abs().max() / ref.float().abs().max().clamp(min=1e-30)).item(),
            (d.norm() / ref.float().norm().clamp(min=1e-30)).item())


def k7_within(errs) -> bool:
    return errs[0] <= K7_MAX_RTOL and errs[1] <= K7_RMS_RTOL


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
            errs = k7_errors(got, ref)
            controls = {other: k7_errors(got, refs[other]) for other in (not pv, "bf16")}
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
            if not k7_within(errs):
                raise AssertionError(f"K7 {key} disagrees with its plain version: {errs}")
            passed = [names[o] for o, e in controls.items() if k7_within(e)]
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
             "bwd_k7_errs": [k7_errors(g, rr) for g, rr in zip(grads, ref_grads)],
             "bwd_abs_err": max((g.float() - rr).abs().max().item()
                                for g, rr in zip(grads, ref_grads)),
             "int8_errs": {pv: k7_errors(i8[pv], i8_refs[pv]) for pv in (False, True)},
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
                and all(k7_within(e) for e in r["bwd_k7_errs"])
                and all(k7_within(e) for e in r["int8_errs"].values()) and not bad):
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
    decode = run_decode_checks(qcfg, runner, dict(cases)["a"], rows_a, tier)
    continuous = (run_continuous_serving(qcfg, runner, dict(cases)["a"], rows_a, rows_u, tier,
                                         smi)
                  if tier == "q4" else None)
    lora = check_lora_q4(qcfg, model, rows_a[0]) if tier == "q4" else None
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
    ``required`` did not launch in between."""
    delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    missing = [k for k in required if not delta.get(k)]
    if missing:
        raise AssertionError(f"the SP path never launched {missing}")
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
    whole gradient), then ``steps`` SP train steps, timed; -> record."""
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
    return record


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

    torch.cuda.set_device(0)
    cfg = ModelConfig.load(str(ROOT / "configs" / "model_qwen2_5_7b_gp"))
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    if not same_weights(model, world):
        raise AssertionError(f"rank {rank} built other weights than rank 0")
    reset_launches()
    out = {"rank": rank, "gloo_gather_ms": gloo_gather_ms(cfg, cases[0][1], world),
           "serve": sp_serve(cfg, GlimpsePruneRunner(cfg, model), cases, rank,
                                           world)}
    out["train"] = sp_train(cfg, model, rank, ROOT / "build" / f"chip_smoke_sp_train{rank}")
    del model
    torch.cuda.empty_cache()
    qcfg = sp_q8_config(cfg)
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    quantize_model(model, "int8", cfg=qcfg)
    out["q8"] = sp_serve(qcfg, GlimpsePruneRunner(qcfg, model), cases[:1], rank, world,
                         tier="q8", modes=(True,))
    del model
    torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    out["tiny"] = check_small_reference(dist.group.WORLD)
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

    from glimpseprune_torch.models.llava.gp_model import load_llava_config
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    t0 = time.perf_counter()
    cfg, cc = load_llava_config(str(ROOT / LLAVA_DIR), with_text_tower=True)
    cfg = cfg.replace_gp(max_remain_ratio=LLAVA_REMAIN_RATIO)
    rng = np.random.default_rng(LLAVA_SEED)
    images = [rng.integers(0, 256, (cc.image_size, cc.image_size, 3), dtype=np.uint8)
              for _ in LLAVA_PROMPT_TEXT]
    prompts = llava_prompts(cfg, rng)
    prep = llava_prep(cfg, cc, images, prompts)
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


def main() -> int:
    smi = find_card()
    import torch

    from glimpseprune_torch.config import ModelConfig
    from glimpseprune_torch.convert import init_random
    from glimpseprune_torch.models.qwen2_5_vl.inputs import prepare_inputs
    from glimpseprune_torch.models.qwen2_5_vl.runner import GlimpsePruneRunner

    t_start = time.perf_counter()
    build_s = build_kernels()
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

    t0 = time.perf_counter()
    model = init_random(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init_random: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    with sync_checked():
        runs, serve_launches = run_main_path(cfg, model, [("a", prep_a), ("b", prep_b)])
    decode_checks = {"bf16": run_decode_checks(cfg, GlimpsePruneRunner(cfg, model), prep_a,
                                               rows_a, "bf16")}
    # phase 12: continuous serving, before training changes the model
    t_cont = time.perf_counter()
    continuous = {"bf16": run_continuous_serving(cfg, GlimpsePruneRunner(cfg, model), prep_a,
                                                 rows_a, rows_u, "bf16", smi)}
    continuous_s = time.perf_counter() - t_cont
    # phase 13: delayed selection, the oracle masks, harvest_rows and a
    # GlimpsePrune+ (GRPO) run, which leaves the model as it found it
    glimpse_plus, glimpse_plus_launches = run_glimpse_plus(cfg, model, prep_a, prompts_a,
                                                           images)
    small = check_small_reference()

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

    # phase 8: the quantized tiers' kernels at the main path's shapes
    quant_kernels, k4_report, k5_report, k6_report = check_int4_kernels(
        cfg, gen, decode_m=prep_a.input_ids.shape[0], prefill_m=int(prep_a.valid.size),
        vit_m=prep_a.patches.shape[0])
    k7_rows, k7_report = check_flash_int8(cfg, prep_a, prep_b, gen)
    quant_kernels += k7_rows
    # phase 9: the quantized serving path
    t_quant = time.perf_counter()
    quant_runs, quant_launches, small_quant = [], {}, {}
    for tier in QUANT_TIERS:
        tier_runs, quant_launches[tier], decode_checks[tier], cont, lora = run_quant_tier(
            cfg, tier, [("a", prep_a), ("b", prep_b)], rows_a, rows_u, smi)
        if cont is not None:
            continuous[tier] = cont
        if lora is not None:
            glimpse_plus["q4_lora"] = lora
        quant_runs += tier_runs
        small_quant[tier] = check_small_quant(tier)
    quant_s = time.perf_counter() - t_quant

    # phase 11: K9 against its plain versions and the monolithic kernels,
    # then the SP path over SP_WORLD ranks on this card (the parent holds no
    # model: each rank builds its own 7B)
    torch.cuda.empty_cache()
    k9_rows, k9_report = check_flash_qpos(cfg, prep_a, gen)
    torch.cuda.empty_cache()
    sp_ranks, sp_launches, sp_s = run_sp_path([("a", prep_a), ("b", prep_b)])
    for k in k9_rows:
        k["launches"] = sp_launches[k["name"]]
        k["launches_per_rank"] = [r["launches"].get(k["name"], 0) for r in sp_ranks]
    # phase 14: LLaVA-1.5-7B (the parent's earlier models are gone)
    torch.cuda.empty_cache()
    llava_rows, llava, llava_launches = run_llava_phase(gen, smi)

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
    for k in kernels:
        print(speed(k))
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
                      "sp_ranks": sp_ranks, "continuous_serving": continuous,
                      "continuous_bf16_s": continuous_s, "glimpse_plus": glimpse_plus,
                      "llava": llava,
                      "total_s": time.perf_counter() - t_start}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
