#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (particle_fm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the three
   kernel libraries from csrc/ with nvcc, one compiler per source, all
   started together (build time on its own line).
2. Kernel phases, each of the four kernels against its plain PyTorch version
   on the card at the shapes the serving paths give it, atol 1e-4 / rtol
   1e-4, and both timed with CUDA events in turns (plain, kernel, kernel,
   plain; each 20 calls back to back between two events, the median of 5 such
   runs, after 5 calls of warm-up):
   - the fused EPiC layer (csrc/epic_layer.cu, its two local matmuls on the
     tensor cores through csrc/mma_tf32.cuh) at the JetNet-150 flagship shapes
     (B=640, N=150, H=128, L=10, t=32, cond 2 on both MLP paths, float32,
     multiplicities 30-150), at lhco/bigPC's (B=128, N=558, H=256, L=256,
     cond 10 on both) and at jetclass/jetclass_cond's (B=512, N=128, H=300,
     L=16, cond 12 on the global path only), and at the generation batches of
     the dataset phases (lhco/bigPC B=2048, N=558; lhco/whole_event B=2048,
     N=560, cond 1; lhco/x_jet B=256, N=279, cond 4; jetclass_cond B=1000);
     checked only at N of 1, 15, 16, 17 and 558, at H of 3, 48, 136, 140, 256
     and 300, and with x times 4;
   - packed short-set attention (csrc/short_attention.cu, on the tensor
     cores through csrc/attention_mma.cuh) at the PC-Droid transformer's
     shape (B=640, L=150, 16 heads of 16, ragged key mask, q/k/v as the three
     slices of one QKV projection), and once with a (B, H, L, L) bias at B=64;
     checked only at the edges of its tiles (L of 1, 15, 16, 17 and 256 at
     head dims 8, 12, 32 and 64), with q/k/v offset by one float (no 16-byte
     loads) and with q and k times 4 (scores of some tens);
   - fused short-set attention (same source) at the cross-attention model's
     two shapes (B=640, 16 heads of 8: 4 queries on 150 masked keys, 150
     queries on 4 keys; the times are those of one such pair), and once
     masked with a bias at Lq=37, Lk=150; checked only at Lq and Lk of 1, 5,
     17 and 512 (alike, and against 4) at head dims 8, 12, 32 and 64 with 3
     heads, and with q/k/v offset by one float;
   - blockwise flash attention (csrc/flash_attention.cu) at MDMA's shape
     (B=32, one class-token query on 6000 keys with 1000-6000 real ones, 2
     heads of 128) and at the transformer's shape on 279-particle sets
     (B=256, Lq=Lk=279, 16 heads of 16, slices of one QKV projection; this
     shape runs on the tensor cores), and checked only at B=4, Lq=Lk=1500, 4
     heads of 128, masked and unmasked, at Lq=Lk of 5, 17 and 558 at head dims
     8, 12, 32 and 64, with q/k/v offset by one float and with q and k times 4.
   Beside each: the least time the card could take and, for attention, one
   `scaled_dot_product_attention` call on the same tensors as a yardstick
   (the port never calls it). The bound is the larger of the bytes over
   3.35 TB/s and the float32 operations over 67 TFLOP/s; for a kernel that
   does its two products on the tensor cores in split-precision TF32, the
   products' operations times the TF32 products issued per float32 product
   over 495 TFLOP/s, plus the other operations over 67 TFLOP/s. The
   `kernel_phase` lines of those kernels also give what the built library
   says of its launch at the served shape: the instruction, the products per
   float32 product, a block's warps and shared memory and the registers per
   thread; the run fails if the wrappers' mirror of that geometry differs, or
   if the products the bound counts are not those the library issues (the
   EPiC kernel: at each of its three shapes).
   Then the four bfloat16 variants, each against its plain version on
   bfloat16 inputs (the mask and the bias float32) within 2 bfloat16 ulps of
   the largest |out|, timed in turns the same way: `epic_layer_bf16` at the
   flagship and at path E's shape (jetclass_cond, batch 512) and at the edges
   of its 64-row tiles and padded widths (N of 1, 17, 65, 558; H of 3, 48,
   300, 512); `packed_short_attention_bf16` at path A's shape and with a bias;
   `fused_short_attention_bf16` at path B's pair and with a bias;
   `flash_masked_attention_bf16` at paths C and D and at 1500 keys of head dim
   128, and its class-token variant at 1 to 4 query rows, key counts off
   every step and split, a fully masked set, twice in a row; each attention
   kernel at the edges of its tiles at head dims 8, 12, 32 and 64 and offset
   by one element. The kernels redesigned for this card (`epic_layer_bf16`,
   the flash class token, flash with more than 4 query rows at path D and
   the fused pair, each half apart) are timed in TURN_ROUNDS rounds of
   in-turn readings (plain, kernel, library, library, kernel, plain),
   medians reported, the attention ones beside bf16
   `scaled_dot_product_attention` in the same turns. Flash at path D and the
   fused halves stop at each set's last real key: beside their bound over
   every key they report the bound over the keys the data needs and their
   device time (torch.profiler, or CUDA events where its recordings hold no
   launch), the run fails if either median reads below
   that bound, and they are checked on masks of every kind (a prefix, holes,
   only the last key real, every key masked, fractional values only), with
   their launch reports against the wrappers' mirrors
   (`mma_bf16_geometry`, `fused_bf16_geometry`) and two launches alike. Beside each: one bf16 `scaled_dot_product_attention`
   call (the port never calls it; it must agree within 4 ulps) and the bound,
   bytes at 2 per value and each bfloat16 product once at 989 TFLOP/s (the
   flash kernel's P . V twice in TF32; the EPiC layer's per-set products,
   float32 inputs in three bfloat16 pieces, three times). The run fails
   unless the attention libraries name mma.sync.m16n8k16 bf16 (and flash
   mma.sync.m16n8k8 TF32, twice, for P . V) and the EPiC library
   wgmma.mma_async m64nNk16 bf16 as the instruction of their bfloat16
   products, and unless the EPiC and class-token launch reports
   agree with the wrappers' mirrors (`bf16_geometry`, `token_geometry`).
3. Serving phases through `make_serve_fn`/`serve_batches`, midpoint,
   ode_steps=51 (100 network evaluations), float32, seeded random weights
   (the repo has no trained checkpoint), ragged masks and a random cond:
   - fm_tops150_cond (EPiC), batch 640, requests of 640 and 7 jets;
   - path A, fm_droid_transformer at full width (model_dim 256, 3 layers,
     16 heads, attn_impl=packed, scores_dtype=null), batch 640, requests of
     640 and 7 jets;
   - path B, fm_droid_crossattention at full width (model_dim 128, 8 layers,
     16 heads, 4 global tokens, attn_impl=fused), batch 640, 640 and 7 jets;
   - path C, calo/mdma_calo on flow_matching_mdma (4 features, 6000 hits,
     1-wide cond, hidden 256, latent 16, 8 layers) with net_config.num_heads=2,
     so that the head dim is 128 and attention(impl="auto") takes the flash
     kernel; batch 32, requests of 32 and 5 showers of 1000-6000 hits;
   - path D, lhco/jets_transformer on fm_droid_transformer (279 particles,
     5-wide cond) with attn_impl=flash, scores_dtype=null; batch 256,
     requests of 256 and 7 events of 30-279 particles;
   - path E, jetclass/jetclass_cond on flow_matching (EPiC, 13 features, 128
     particles, hidden 300, latent 16, 20 layers, cond 12 on the global MLPs
     only); batch 512, requests of 512 and 7 jets.
   The transformer configurations zero-initialise their attention and
   output projections, so every parameter is re-drawn from a seed first, and
   the vector field must not be identically zero. Each phase sets the launch
   counts to 0, serves, and checks finite outputs, zero padded rows, the
   exact number of launches of its kernel and none of another path's; then
   the same requests run with the kernel's wrapper replaced by its plain
   version and must agree within atol 1e-3, and a small batch must agree
   with the CPU within atol 1e-4. Prints jets/s of both paths, each the mean
   of two runs taken in turns (kernel, plain, plain, kernel).
   Then the same six models, weights and requests with model.dtype=bfloat16
   (`serving_bf16` lines): the exact launches of the bfloat16 kernel and of
   no other (no float32 kernel takes a cast tensor), sets/s of the kernel
   and the plain path beside the float32 kernel path's, the per-feature
   mean and std of the real particles at NFE 100 within 5% of the float32
   samples' std (the same noise), and after 4 midpoint steps on a full batch
   the kernel path closer to the plain path than the plain bfloat16 path is
   to float32 (Frobenius norms); a field not identically zero.
4. Training phases at full width, float32 without TF32, each model composed
   from configs/ by the port's compose/instantiate (AdamW, clip 0.5, batch
   1024, synthetic JetNet-150, the step of particle_fm_tpu_torch/training/
   step.py over the Trainer's epoch batches):
   - train EPiC (fm_tops150_cond): one step's loss and gradients on the card
     against the CPU from the same weights and pinned draws of t and the
     noise (64 jets; loss rtol 1e-5, gradients within 1e-4 of the largest),
     then 30 steps at constant lr 1e-3 that must lower the loss (the last 5
     against the first 5) and launch no kernel: the EPiC kernel is
     forward-only, training runs the module path. Prints the median step
     after 5 of warm-up as steps/s and jets/s, and the peak memory;
   - train path A (fm_droid_transformer, attn_impl=packed, scores_dtype=null,
     every parameter re-drawn): one step's loss and gradients with the packed
     kernel in the forward pass (its backward recomputes `packed_ref_math`,
     as the JAX custom_vjp recomputes `_ref_math`) against the kernel
     replaced by its plain version, on a full batch with pinned draws, same
     tolerances; then 4 steps a turn, in turns (kernel, plain, plain,
     kernel): exactly 3 packed launches a kernel step, jets/s and peak
     memory of each path;
   - train CLI: particle_fm_tpu_torch.train.main with
     experiment=jetnet/fm_tops150_cond data.synthetic=true
     data.synthetic_num_jets=4096 trainer=smoke callbacks=none: a finite
     val_loss, the `last` and best checkpoints, a resume from `last` that
     continues at its step, the checkpoints' parameters, EMA weights and
     AdamW moments float32, then the EMA weights serve 7 jets at NFE 100
     with exactly 6 x 100 EPiC launches, within atol 1e-3 of the plain path.
   Then the same three in bfloat16 (model.dtype=bfloat16: float32 master
   weights, bfloat16 compute, float32 gradients, AdamW and EMA), each held
   by the bf16 gate |x - plain bf16| < |plain bf16 - plain float32| on the
   loss and on all gradients as one vector (Frobenius norm):
   - train EPiC bf16: one step on the card against the CPU in bfloat16 (64
     jets, pinned draws), 30 steps that lower the loss with no kernel
     launched, the median step, jets/s and peak memory beside float32's;
     then jets/s at bench.py's train batch 320, float32 and bfloat16 in
     turns;
   - train path A bf16: the packed bf16 kernel's forward against the kernel
     replaced by its plain version, then 4 steps a turn in turns, exactly 3
     packed_short_attention_bf16 launches a kernel step and none of a
     float32 kernel; jets/s and peak memory beside float32's;
   - train CLI bf16: as train CLI (float32 checkpoints too); the EMA weights
     serve in bfloat16 with exactly 6 x 100 epic_layer_bf16 launches and no
     epic_layer launch, and after 4 midpoint steps the kernel path closer to
     the plain bf16 path than that is to float32.
5. Eval phases at full width (`eval_cli_phase`, `eval_timing_phase`):
   - eval CLI: particle_fm_tpu_torch.train.main with
     experiment=jetnet/fm_tops150_cond data.synthetic=true
     data.synthetic_num_jets=4096 trainer=smoke and the shipped
     `callbacks: jetnet` (batch 1000, midpoint, ode_steps 200, EMA weights,
     40 bootstrap batches), evaluated every epoch from epoch 0 on 2,000
     jets, and `test: true`: finite W1M/W1P every epoch, the test pass on
     the restored best checkpoint, exactly 6 x 2 x 199 x 2 EPiC launches per
     pass; then the same evaluation with the plain EPiC layer: jets within
     1e-3, W1M and W1P within 1e-3 absolute;
   - eval timing: 5,000 jets generated against 5,000 synthetic test jets
     (N = 150), each stage timed: generation (exact EPiC launches), EFPs and
     energy correlators on the card, the native clustering (tau1-3, d12/d23),
     W1M, W1P, W1EFP and W1(tau21); then the EFPs and correlators on the card
     against the CPU on 256 jets (rtol 1e-4).
6. Family phases (the other loss families and solvers), each composed from
   configs/ and on the card, one `family` line each and their total:
   - diffusion CLI, the full-width path of PC-JeDi: train.main with
     experiment=jetnet/diffusion_tops150_cond data.synthetic=true (4096
     jets, trainer=smoke, 2 epochs) and the experiment's `callbacks:
     jetnet` (em, 200 steps, batch 1000, EMA weights) every epoch from
     epoch 0 on 2,000 jets and the test pass: exactly 6 x 200 x 2 x 3 EPiC
     launches; then 1,000 jets by em (200 steps) and by ddim (100 steps),
     kernel path against plain path with the same generator (atol 1e-3), and
     one train step's loss and gradients, card against CPU;
   - droid: jetnet/droid_tops30 (droid_t_max 25) on path A's network
     (attn_impl=packed, scores_dtype=null, every parameter re-drawn): 8
     train steps, 3 packed launches each; 1,000 jets by midpoint, 100 steps,
     kernel against plain within 1e-3 of the largest |x|;
   - self-cond: jetnet/fm_selfcond_tops30: 8 train steps (no launch), 1,000
     jets through odeint_fixed_sc, midpoint, 200 steps (6 x 398 launches),
     kernel against plain within 1e-3;
   - OT-CFM: jetnet/ot_cfm_tops30: 8 train steps at batch 1024; the pairing
     of one batch equal, card against CPU; the Sinkhorn plan and the
     hardening timed;
   - DOPRI5: the flagship network with the sincos time embedding at batch
     640, dopri5 and dopri5_per_sample: steps, network passes, exact
     launches, sets/s; dopri5 kernel against plain within 1e-3; on the
     per-set solver, whose step sizes read each set's rounding, every kernel
     launch against the plain layer on its inputs (1e-4), the solver in
     float64 card against CPU on 64 sets (the same decisions, within 1e-3),
     and the two paths' results shown beside the spread that a start moved
     by one ulp gives; the flagship's cosine embedding shown beside,
     unchecked;
   - log_prob: the flagship, Hutchinson, B=32, 20 steps, card against CPU
     within 1e-3 relative.
7. Dataset phases: the shipped LHCO, JetClass and CaloChallenge experiments
   at full width through the training entry point on synthetic data, each
   with its `dataset` line, the overrides it makes against the shipped
   config among them, and their total:
   - lhco/bigPC (EPiC, hidden and latent 256, 8 layers, cond 10, both jets
     in one 558-particle cloud; `data.num_particles=279` per jet), 4000
     events, batch 128, 2 epochs; lhco_eval and lhco_eval_sr (batch 2048,
     midpoint, ode_steps 50, W1 over 10 bootstrap batches in place of 40)
     once each in the test pass on 2,048 sets: exactly 2 x 8 x 98 EPiC
     launches; then one batch of 2,048 with the EMA weights, 10 steps,
     kernel against plain within 1e-4 of the largest |x|;
   - lhco/whole_event (560-particle events, cond mjj), 12000 events, batch
     1024, 1 epoch; the whole-event callback (batch 2048, ode_steps 50) in
     the test pass on 2,048 events (10 bootstrap batches): anti-kt clustering
     of 2,048 generated and 2,048 real events, exactly 6 x 98 launches;
   - jetclass/jetclass_cond (13 features, 128 particles, hidden 300, 20
     layers, cond 12 on the global path), 4,096 synthetic train jets of all
     10 types handed to the datamodule in memory (no h5 file), batch 1024, 2
     epochs with the per-jet-type validation losses; jetnet_eval with
     per_type_w1 (batch 1000, ode_steps 200, 10 bootstrap batches) in the
     test pass on 1,000 jets: exactly 20 x 398 launches; then one batch of
     1,000 kernel against plain within 1e-4 of the largest |x|;
   - calo/mdma_calo at its shipped width and lengths (8 heads of 32:
     attention(impl="auto") takes the einsum path, so no kernel runs): 2,000
     synthetic showers of 190 to 6,000 hits (1,700 on average) written from
     the seed as the ragged npz the datamodule reads, bucketed host batches
     (multiples of 64) under the shipped 400,000-hit budget, which binds,
     with the alpha rotation and the fitted scaler, streamed through the
     Trainer's prefetch worker, 2 epochs; calo_eval (ode_steps 100) in the
     test pass on 64 test showers in one batch of 64; then one streamed
     epoch timed and one profiled for the device's busy share, and the
     peak device memory of training.
8. Classifier phases (the gen-vs-real classifier test), each with its
   `classifier` line, and their total:
   - classifier EPiC (kernel): 4,096 synthetic lhco/x_jet sets (279
     particles) against 4,096 generated by a seeded-weight lhco/x_jet
     generator on the EPiC kernel (midpoint, 20 steps), in an in-memory
     GenVsRealDataModule; configs/model/epic_classifier.yaml at its widths
     (hidden 128, latent 10, 3 layers), 2 epochs at batch 256 (the module
     path: no launch); the test split predicted on a folded copy (the fused
     EPiC layer with a 0-wide per-set feature: exactly 3 `epic_layer`
     launches a batch) and on the unfolded network, every probability and
     the AUROC within 1e-4 and every logit within 1e-4 of the largest
     |logit| (at least 1), predict ms a batch of both, the medians of 3
     rounds in turns; then in bfloat16 on the same weights: exactly 3
     `epic_layer_bf16` launches a batch and none of `epic_layer`, the
     kernel's logits closer to the plain bf16 path than that is to float32
     and within 2 bf16 ulps of the largest |logit|; on classifiers trained
     from three more seeds the 2-ulp limit again, the Frobenius ratio read
     ungated;
   - ParT (`jetclass_classifier`, 8 layers, 8 heads of 16, embed
     128-512-128, pair MLP 64 x 3) and ParticleNet
     (`jetclass_classifier_particlenet`, EdgeConv 64/128/256 with k 16,
     grad_clip 0.02) through train.main on 6,000 synthetic gen/sim jets of
     128 particles (`data.used_flavor=QCD`), batch 256, `trainer=smoke`, 2
     epochs: median step, jets/s, peak memory, accuracy and AUROC; one
     step's loss and gradients on the card against the CPU on 32 jets
     (rel 1e-4, 1e-4 of the largest gradient; ParticleNet on the CPU's kNN
     indices, the card's own disagreements counted and printed); no kernel
     on these paths (ParT's attention takes its pair bias on the einsum
     path, as in the JAX package);
   - the HL-MLP (`jetclass_classifier_hl`): a finite AUROC.
   The kernel phases also time the EPiC layer at the classifier's shape
   (B=256, N=279, no time, no cond) in both types and check it at the edges
   with a 0-wide per-set feature (EPiCDiscriminator3's jet trunk: 2 sets a
   row, no mask).
9. The phases of the flat models, the LHCO chain, the MoE transformer and
   the gaussian time with normaliser training (`slice16` lines, then their
   total), each composed from configs/:
   - lhco/jet_features CLI: train.main on 20,000 synthetic events,
     trainer=smoke (2 epochs, batch 1024), the shipped FlatEvalCallback
     (ode_steps 100, batch 1024, EMA weights) in the test pass: the median
     step, the generation time, finite W1s; 4 steps card against the CPU
     (pinned draws, each loss within 1e-4 relative). Its run is stage 1
     below;
   - gen_challenge CLI: 2 epochs on the synthetic folds, both shipped
     callbacks (sideband and `sr_`, ode_steps 200) with their plots off:
     finite W1s; whether matplotlib imports on the machine;
   - LHCO two-stage chain (particle_fm_tpu_torch/lhco_chain.py): stage 1
     loaded from that run, stage 2 lhco/x_jet and lhco/y_jet at full width
     (EPiC, 279 particles, 6 layers, cond 4) with seeded weights; 2,048
     events at batch 1024, midpoint, 100 steps, reclustered: exactly 6 x 198
     x 2 x 2 EPiC launches, then the plain layer: constituents within 1e-3;
   - fm_moe_transformer at full width (2 heads of 64, 4 experts), every
     parameter re-drawn: 4 steps card against the CPU in float32 (1e-4), one
     step's loss and gradients in bfloat16 closer to the CPU's bf16 than that
     is to float32 (the 4 bf16 steps read beside), the card on the CPU's
     expert choices (its own counted where they differ), 8 timed
     steps at batch 1024 in each type, then its EMA weights served with
     attn_impl=packed, scores_dtype=null, batch 1024, NFE 100, float32 and
     bfloat16, as the serving phases serve (3 packed launches an
     evaluation);
   - flagship with model.t_emb=gaussian model.use_normaliser=true (max_n
     1,000,000: fitted, updated, then frozen): 20 steps at batch 1024, both
     normalisers' statistics against the CPU's updates
     from the same batches (1e-5 of each statistic's largest magnitude),
     then 1,024 jets at NFE 100 on the EPiC kernel against the plain layer
     (1e-3), exactly 6 x 100 launches.
10. The phases of the kernels as custom ops, the served artifact, its HTTP
   server and distillation (`slice17` lines, then their total):
   - ten artifacts exported first, each in a process of its own, all
     together (particle_fm_tpu_torch/serving.py::export_sampler; tracing is
     host work): the flagship (fm_tops150_cond, B=640, midpoint NFE 100) and
     paths A, B, C (the class token) and D at their serving shapes (euler,
     one evaluation), each in float32 and bf16, with the serving phases'
     weights;
   - meanwhile `torch.library.opcheck` of the eight custom ops and the bf16
     class-token route, at small shapes, each in its type;
   - distillation on the flagship teacher: 4,096 reflow pairs at NFE 100,
     batch 1024 (exactly 2,400 EPiC launches); a student trained 2 epochs
     through train.py (`data=reflow_pairs`, from the teacher's weights, no
     launch); straightness, teacher then student; distill_direct 20 steps
     at B=256 (the folded teacher's solves: exactly 1,920 launches);
     consistency_sample at 1 and 2 steps on 1,024 sets against its plain
     path (1e-3; exactly 6 and 12 launches); the student exported at euler
     4 evaluations and served over HTTP (1,000 sets; 120 launches);
   - each artifact loaded and held against make_serve_fn on the same
     weights and request, bit for bit, with the exact launches of its
     kernel and none of another; the flagship's also in a process that
     imports no model code (bit for bit, 600 launches counted there), and
     its sets/s against make_serve_fn in turns (8 batches a reading behind
     one sync);
   - make_server on the flagship artifact at 127.0.0.1:0: /healthz, /meta,
     one /sample of 1,000 sets with cond and a num_points list, equal to
     serve_batches on the same artifact; the request's seconds, and the
     sampling's alone.
11. Prints the `kernels` JSON line (the launches of the training, eval,
   family, dataset, classifier and slice phases under `launches_by_path`
   too), the card line again, and as the last line {"ok": true, "device": {...}}.

Every failure exits non-zero before the last line. The script needs the
repository beside it and a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

# flagship kernel shapes and the H100 SXM's published peaks
B, N, H, L, T, C = 640, 150, 128, 10, 32, 2
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-4
PATH_TOL = 1e-3
CPU_TOL = 1e-4
ODE_STEPS = 51
EPIC_TF32_PRODUCTS = 3  # TF32 products per float32 product of the EPiC kernel's local matmuls
# the bfloat16 kernels' tensor-core instruction (csrc/mma_bf16.cuh), one product per product
BF16_INSTRUCTION = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
# the bfloat16 EPiC kernel's local products (csrc/wgmma_bf16.cuh): one wgmma a product, N the
# column block of the launch report; its per-set products take a float32 input in three
# bfloat16 pieces: three bfloat16 products per product
EPIC_BF16_INSTRUCTION = "wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16"
EPIC_BF16_SET_PRODUCTS = 3
FLASH_BF16_PV_TF32_PRODUCTS = 2  # the flash bf16 kernel's P . V: P's head and remainder in TF32
TF32_INSTRUCTION = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"  # csrc/mma_tf32.cuh
DEVICE_READINGS = 3  # device-time readings (torch.profiler) of a redesigned kernel: the median
BF16_KERNEL_ULPS = 2  # a bf16 kernel against its plain version: bfloat16 ulps of the largest |out|
BF16_LIBRARY_ULPS = 4  # the bf16 yardstick (scaled_dot_product_attention) rounds elsewhere
# NFE 100 bf16 vs f32: per-feature mean and std, over the f32 std. Set after the first
# reading: 0.026 at path C, whose hits share each shower's class token, so that the mean
# over 37 showers moves with each shower's deviation; the other paths read 0.003 or less
BF16_STATS_LIMIT = 0.05
BF16_CHECK_STEPS = 5  # ode_steps of the bf16 kernel-against-plain check: 4 midpoint steps
# operations per attention score beside the two products: scale, mask add,
# subtract the maximum, exponential, sum
SCORE_OPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def reset(counted) -> None:
    """Set the launch count of every counted wrapper to 0."""
    for w in counted:
        w.launches = 0


def launched(counted) -> dict:
    """The launch counts by wrapper name."""
    return {w.__name__: w.launches for w in counted}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ragged_mask(rs: np.random.RandomState, b: int, n: int, lo: int = 30) -> np.ndarray:
    counts = rs.randint(lo, n + 1, size=(b, 1))
    return (np.arange(n)[None, :] < counts).astype(np.float32)


def check_kernel(torch, name: str, got, want) -> float:
    """Max abs error of a kernel's result against its plain version's."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name} kernel gave non-finite values")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
        fail(f"{name} kernel disagrees with its plain version: max abs err {err}")
    return err


def timed_in_turns(kernel_fn, plain_fn) -> dict:
    """plain, kernel, kernel, plain, so clock ramps hit both alike."""
    from particle_fm_tpu_torch.utils.timing import cuda_ms

    turns = [cuda_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn)]
    return {"ms": (turns[1] + turns[2]) / 2, "plain_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": {"plain": [turns[0], turns[3]], "kernel": [turns[1], turns[2]]}}


TURN_ROUNDS = 3  # rounds of in-turn readings of a redesigned kernel: medians of 6 readings


def median_in_turns(kernel_fn, plain_fn, library_fn=None, rounds: int = TURN_ROUNDS) -> dict:
    """`rounds` rounds of plain, kernel, library, library, kernel, plain
    (the library call left out where there is none), each reading
    `cuda_ms`: the medians of the kernel's, the plain version's and the
    library call's readings, and every reading."""
    import statistics

    from particle_fm_tpu_torch.utils.timing import cuda_ms

    fns = {"plain": plain_fn, "kernel": kernel_fn, "library": library_fn}
    order = [k for k in ("plain", "kernel", "library") if fns[k] is not None]
    turns = {k: [] for k in order}
    for _ in range(rounds):
        for key in order + order[::-1]:
            turns[key].append(cuda_ms(fns[key]))
    out = {"ms": statistics.median(turns["kernel"]), "plain_ms": statistics.median(turns["plain"]),
           "turns_ms": turns}
    if library_fn is not None:
        out["library_ms"] = statistics.median(turns["library"])
    return out


def bound(n_bytes: float, flops: float, tensor_flops: float = 0.0, tf32_products: int = 1,
          bf16_flops: float = 0.0, bf16_issued: float | None = None) -> dict:
    """Least time for the work: each input read once and each output written
    once, against the float32 operations at the CUDA cores' rate. Of the
    `flops`, `tensor_flops` are matrix products that the kernel issues
    `tf32_products` times each on the tensor cores in TF32, and `bf16_flops`
    products it issues on the tensor cores in bfloat16 as `bf16_issued`
    operations (default: once each) at the bfloat16 rate."""
    issued = bf16_flops if bf16_issued is None else bf16_issued
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ((flops - tensor_flops - bf16_flops) / PEAK_F32_FLOPS
             + tensor_flops * tf32_products / PEAK_TF32_FLOPS
             + issued / PEAK_BF16_FLOPS) * 1e3
    by = ("bytes" if t_bytes >= t_ops else
          "tensor operations" if tensor_flops or bf16_flops else "operations")
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by, "bytes": n_bytes, "flops": flops,
            "tensor_flops_issued": tensor_flops * tf32_products + issued}


def epic_case(torch, dev, seed, b, n, h, lat, c, local=True, x_scale=1.0, lo=30, t=T):
    """Inputs of one EPiC layer on the card, time embedding `t` wide on both
    paths (t=0, c=0: a 0-wide per-set feature, as the EPiC discriminators
    run it), cond C wide on the global MLPs and, when `local`, on the local
    biases too; weights of scale 1/sqrt(fan_in), sets with `lo`..N real
    particles."""
    gen = torch.Generator().manual_seed(seed)
    cl = c if local else 0

    def lin(fan_in, *shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * max(fan_in, 1) ** -0.5

    k1, k2, k3, k4 = t + 2 * h + lat + c, t + h + c, t + lat + cl, t + cl
    mask = torch.from_numpy(ragged_mask(np.random.RandomState(seed), b, n, lo=min(lo, n)))
    inputs = [
        torch.randn(b, n, h, generator=gen) * x_scale, torch.randn(b, lat, generator=gen), mask,
        torch.randn(b, t + c, generator=gen),
        lin(k1, k1, h), lin(k1, h), lin(k2, k2, lat), lin(k2, lat),
        lin(k3, h, h), lin(k3, k3, h), lin(k3, h),
        lin(k4, h, h), lin(k4, k4, h), lin(k4, h),
    ]
    return ([a.to(dev).contiguous() for a in inputs],
            dict(sum_scale=1e-2, tg_dim=t, tl_dim=t, cg_dim=c, cl_dim=cl))


def epic_measure(torch, ops, args, dims) -> dict:
    """The EPiC kernel at one shape: check, time in turns with its plain
    version, count the bound (the two local matmuls on the tensor cores as
    three TF32 products per float32 product)."""
    b, n, h = args[0].shape
    lat = args[1].shape[-1]
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    err = max(check_kernel(torch, "epic_layer", xo, rx), check_kernel(torch, "epic_layer", go, rg))
    k1, k2, k3, k4 = (w.shape[0] for w in (args[4], args[6], args[9], args[12]))
    # the multiply-adds of the pool, the per-set MLPs and the two H x H local
    # matmuls plus their five elementwise operations
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 4 * (b * n * h + b * lat)
    flops = (2 * b * n * h + 2 * b * (k1 * h + k2 * lat + k3 * h + k4 * h)
             + 2 * 2 * b * n * h * h + 5 * b * n * h)
    return {"max_abs_err": err,
            **timed_in_turns(lambda: ops.epic_layer(*args, **dims),
                             lambda: ops.epic_layer_reference(*args, **dims)),
            **bound(n_bytes, flops, 4 * b * n * h * h, EPIC_TF32_PRODUCTS),
            "shape": {"B": b, "N": n, "H": h, "L": lat, "t": dims["tg_dim"], "cg": dims["cg_dim"],
                      "cl": dims["cl_dim"], "dtype": "float32"}}


def kernel_phase(torch, ops, dev) -> dict:
    shapes = {
        "flagship": epic_measure(torch, ops, *epic_case(torch, dev, 0, B, N, H, L, C)),
        # configs/experiment/lhco/bigPC.yaml: 558 particles, hidden and latent 256, cond 10
        "lhco/bigPC": epic_measure(torch, ops, *epic_case(torch, dev, 1, 128, 558, 256, 256, 10)),
        # configs/experiment/jetclass/jetclass_cond.yaml: hidden 300, latent 16, cond 12 global
        "jetclass/jetclass_cond": epic_measure(
            torch, ops, *epic_case(torch, dev, 2, 512, 128, 300, 16, 12, local=False)),
        # the generation shapes the dataset phases serve: the callbacks' batches of
        # lhco/bigPC (2048), lhco/whole_event (2048 events of 560, cond 1), lhco/x_jet
        # (256 of 279, cond 4) and jetclass_cond (1000)
        "lhco/bigPC generation": epic_measure(
            torch, ops, *epic_case(torch, dev, 3, 2048, 558, 256, 256, 10)),
        "lhco/whole_event generation": epic_measure(
            torch, ops, *epic_case(torch, dev, 4, 2048, 560, 128, 10, 1)),
        "lhco/x_jet generation": epic_measure(
            torch, ops, *epic_case(torch, dev, 5, 256, 279, 128, 10, 4)),
        "jetclass/jetclass_cond generation": epic_measure(
            torch, ops, *epic_case(torch, dev, 6, 1000, 128, 300, 16, 12, local=False)),
        # configs/experiment/lhco/epic_classifier.yaml predicting a batch of 256: hidden 128,
        # latent 10, no time and no cond (a 0-wide per-set feature)
        CLASSIFIER_SHAPE: epic_measure(torch, ops, *epic_case(torch, dev, 7, 256, 279, 128, 10, 0,
                                                              t=0)),
    }
    # the edges of the row tiles, the widths around the padding and the
    # weights' two homes, and x times 4 (split-precision TF32's error grows
    # with the operands); not timed
    edges = {}
    for n in (1, 15, 16, 17, 558):
        edges[f"N={n}"] = (4, n, 128, 10, 2, True)
    for h in (3, 48, 136, 140, 256, 300):
        edges[f"H={h}"] = (4, 70, h, 16, 12, h != 300)
    errs = {}
    for i, (key, (b, n, h, lat, c, local)) in enumerate(edges.items()):
        args, dims = epic_case(torch, dev, 10 + i, b, n, h, lat, c, local, lo=1)
        xo, go = ops.epic_layer(*args, **dims)
        rx, rg = ops.epic_layer_reference(*args, **dims)
        errs[key] = max(check_kernel(torch, f"epic_layer ({key})", xo, rx),
                        check_kernel(torch, f"epic_layer ({key})", go, rg))
    for key, (args, dims) in no_set_feature_edges(torch, dev).items():
        xo, go = ops.epic_layer(*args, **dims)
        rx, rg = ops.epic_layer_reference(*args, **dims)
        errs[key] = max(check_kernel(torch, f"epic_layer ({key})", xo, rx),
                        check_kernel(torch, f"epic_layer ({key})", go, rg))
    scaled = {}
    for key, (b, n, h, lat, c, local) in (("flagship", (64, N, H, L, C, True)),
                                          ("H=300", (64, 128, 300, 16, 12, False))):
        args, dims = epic_case(torch, dev, 30, b, n, h, lat, c, local, x_scale=4.0)
        xo, _ = ops.epic_layer(*args, **dims)
        scaled[key] = check_kernel(torch, f"epic_layer (x times 4, {key})", xo,
                                   ops.epic_layer_reference(*args, **dims)[0])
    main = shapes["flagship"]
    return {
        "name": "epic_layer",
        "route": "cuda",
        "source": "particle_fm_tpu_torch/csrc/epic_layer.cu",
        "replaces": "particle_fm_tpu/ops/pallas/epic_layer.py:113",
        "launches": None,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "per": "one launch at the flagship's shape; the other configs' shapes under `shapes`",
        **{key: main[key] for key in ("ms", "plain_ms", "turns_ms", "bound_ms", "bound_by", "bytes",
                                      "flops", "tensor_flops_issued", "shape")},
        "library_ms": None,  # no single PyTorch call computes an EPiC layer
        "shapes": shapes, "max_abs_err_edges": max(errs.values()), "edge_cases": len(errs),
        "max_abs_err_x_times_4": scaled,
    }


CLASSIFIER_SHAPE = "lhco/epic_classifier predict (S=0)"


def no_set_feature_edges(torch, dev) -> dict:
    """Edge cases of the EPiC layer with a 0-wide per-set feature (the
    discriminators' layers): EPiCDiscriminator3's jet trunk (2 sets a row,
    no mask: all real), one particle, and a width off 16."""
    cases = {"S=0, N=2 (jet trunk, no mask)": (8, 2, 128, 10, 2),
             "S=0, N=1": (4, 1, 128, 10, 1), "S=0, N=17, H=48": (5, 17, 48, 4, 1)}
    return {key: epic_case(torch, dev, 60 + i, b, n, h, lat, 0, lo=lo, t=0)
            for i, (key, (b, n, h, lat, lo)) in enumerate(cases.items())}


def epic_design(ops) -> dict:
    """What the built library says its launcher gives the EPiC kernel at the
    three configs' shapes; fails unless the products that the bound counts
    are the products the kernel issues."""
    reports = {
        "flagship": ops.launch_report(B, N, H, L, T + C, T, T, C, C),
        "lhco/bigPC": ops.launch_report(128, 558, 256, 256, T + 10, T, T, 10, 10),
        "jetclass/jetclass_cond": ops.launch_report(512, 128, 300, 16, T + 12, T, T, 12, 0),
    }
    for key, report in reports.items():
        if report["tf32_products_per_float32_product"] != EPIC_TF32_PRODUCTS:
            fail(f"the EPiC bound counts {EPIC_TF32_PRODUCTS} TF32 products per float32 "
                 f"product, the library does {report['tf32_products_per_float32_product']} ({key})")
    return reports


def attention_case(torch, dev, seed, b, lq, lk, h, d, masked, bias=False, fused_qkv=False,
                   lo=30):
    """q, k, v (B, L, H, D), mask (B, Lk) with `lo`..Lk real keys and bias
    (B, H, Lq, Lk) on the card."""
    gen = torch.Generator().manual_seed(seed)
    if fused_qkv:  # the three slices of one (B, L, 3*H*D) projection output
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(dev)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn(b, lq, h, d, generator=gen).to(dev)
        k = torch.randn(b, lk, h, d, generator=gen).to(dev)
        v = torch.randn(b, lk, h, d, generator=gen).to(dev)
    mask = torch.from_numpy(ragged_mask(np.random.RandomState(seed), b, lk, lo=min(lo, lk))).to(dev) if masked else None
    ab = torch.randn(b, h, lq, lk, generator=gen).to(dev) if bias else None
    return q, k, v, mask, ab


def attention_measure(torch, name, fn, ref, case, tf32_products: int = 0) -> dict:
    """One attention kernel at one shape: check, time in turns with its plain
    version, time the library call, count the bound. `tf32_products`: how
    many TF32 products the kernel issues on the tensor cores per float32
    product of q . k and p . v (0: it runs them on the CUDA cores)."""
    import torch.nn.functional as F

    from particle_fm_tpu_torch.utils.timing import cuda_ms

    q, k, v, mask, ab = case
    b, lq, h, d = q.shape
    lk = k.shape[1]
    err = check_kernel(torch, name, fn(q, k, v, mask, ab), ref(q, k, v, mask, ab))
    add = None if mask is None else ((mask - 1.0) * 1e9)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add).transpose(1, 2)
    lib_err = (library() - ref(q, k, v, mask, ab)).abs().max().item()
    if not lib_err <= KERNEL_TOL:
        fail(f"{name}: the library yardstick computes another function (max abs err {lib_err})")
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + (0 if mask is None else mask.numel()))
    flops = (4 * d + SCORE_OPS) * b * h * lq * lk
    products = 4 * d * b * h * lq * lk if tf32_products else 0.0
    return {"max_abs_err": err,
            **timed_in_turns(lambda: fn(q, k, v, mask, ab), lambda: ref(q, k, v, mask, ab)),
            **bound(n_bytes, flops, products, tf32_products), "library_ms": cuda_ms(library),
            "shape": {"B": b, "Lq": lq, "Lk": lk, "H": h, "D": d, "masked": mask is not None,
                      "dtype": "float32"}}


def offset_by_one_float(torch, t):
    """The same values at an address that is no multiple of 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def edge_checks(torch, dev, name, fn, ref, lengths, served, bias_dims=()) -> dict:
    """A tensor-core kernel against its plain version where its tiles of 16
    query rows and 8 keys end (`lengths`, at head dims 8, 12, 32 and 64, with
    1 to L real keys; with a bias too at `bias_dims`), with operands that
    allow no 16-byte loads, and at the `served` case with q and k times 4:
    split-precision TF32's error grows with the operands, and inputs at unit
    scale do not show it. Not timed."""
    errs = {}
    for l in lengths:
        for d in (8, 12, 32, 64):
            case = attention_case(torch, dev, l + d, 3, l, l, 3, d, masked=True, bias=d in bias_dims,
                                  lo=1)
            errs[f"L={l} D={d}"] = check_kernel(torch, f"{name} (L={l}, D={d})", fn(*case), ref(*case))
    q, k, v, mask, ab = attention_case(torch, dev, 12, 3, 37, 37, 3, 16, masked=True, lo=1)
    q, k, v = (offset_by_one_float(torch, t) for t in (q, k, v))
    unaligned = check_kernel(torch, f"{name} (offset by one float)", fn(q, k, v, mask, ab),
                             ref(q, k, v, mask, ab))
    q, k, v, mask, ab = served
    q, k = q * 4.0, k * 4.0
    scores = torch.einsum("qhd,khd->hqk", q[0], k[0]).abs().max().item() / q.shape[-1] ** 0.5
    scaled = check_kernel(torch, f"{name} (q and k times 4)", fn(q, k, v, mask, ab),
                          ref(q, k, v, mask, ab))
    return {"max_abs_err_edges": max(errs.values()), "edge_cases": len(errs),
            "max_abs_err_offset_by_one_float": unaligned, "max_abs_err_q_k_times_4": scaled,
            "largest_score_q_k_times_4": scores}


def tensor_core_design(products: int, report_fn, mirror_fn, l: int, d: int) -> dict:
    """What the built library says its launcher gives a block of a tensor-core
    kernel for `l` query rows at head dim `d` (instruction, TF32 products per
    float32 product, warps, keys staged, bytes of shared memory, registers per
    thread from cudaFuncGetAttributes), and the registers at the other head
    dims. Fails unless the wrapper's mirror of the geometry and the
    `products` that the bound counts agree with it."""
    report, mirror = report_fn(l, d), mirror_fn(l, d)
    if {key: report[key] for key in mirror} != mirror:
        fail(f"{mirror_fn.__name__}({l}, {d}) = {mirror}, but the library launches {report}")
    if report["tf32_products_per_float32_product"] != products:
        fail(f"the bound counts {products} TF32 products per float32 product, the library "
             f"does {report['tf32_products_per_float32_product']}")
    report["registers_per_thread_by_head_dim"] = {
        dp: report_fn(l, dp)["registers_per_thread"] for dp in (8, 16, 32, 64)}
    return report


def packed_phase(torch, sa, dev) -> dict:
    fn, ref = sa.packed_short_attention, sa.packed_short_attention_reference
    main = attention_case(torch, dev, 3, 640, 150, 150, 16, 16, masked=True, fused_qkv=True)
    entry = attention_measure(torch, "packed_short_attention", fn, ref, main, sa.MMA_PRODUCTS)
    q, k, v, mask, ab = attention_case(torch, dev, 4, 64, 150, 150, 16, 16, masked=True, bias=True)
    bias_err = check_kernel(torch, "packed_short_attention (bias)", fn(q, k, v, mask, ab),
                            ref(q, k, v, mask, ab))
    edges = edge_checks(torch, dev, "packed_short_attention", fn, ref, (1, 15, 16, 17, 256), main,
                        bias_dims=(12, 64))
    return {"name": "packed_short_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:308",
            "launches": None, **entry, "max_abs_err_with_bias": bias_err, **edges}


def fused_phase(torch, sa, dev) -> dict:
    fn, ref = sa.fused_short_attention, sa.fused_short_attention_reference
    shapes = {
        "from": attention_measure(torch, "fused_short_attention (from)", fn, ref,
                                  attention_case(torch, dev, 5, 640, 4, 150, 16, 8, masked=True)),
        "to": attention_measure(torch, "fused_short_attention (to)", fn, ref,
                                attention_case(torch, dev, 6, 640, 150, 4, 16, 8, masked=False)),
    }
    q, k, v, mask, ab = attention_case(torch, dev, 7, 64, 37, 150, 16, 8, masked=True, bias=True)
    bias_err = check_kernel(torch, "fused_short_attention (bias)", fn(q, k, v, mask, ab),
                            ref(q, k, v, mask, ab))
    # keys in registers (at most 8) or streamed; 3 heads, so H*D is no multiple
    # of 128; a bias at head dims 12 and 64; then operands offset by one float
    errs = {}
    for lq, lk in [(l, l) for l in (1, 5, 17, 512)] + [(4, l) for l in (1, 5, 17, 512)] + [
            (l, 4) for l in (5, 17, 512)]:
        for d in (8, 12, 32, 64):
            case = attention_case(torch, dev, lq + lk + d, 3, lq, lk, 3, d, masked=True,
                                  bias=d in (12, 64), lo=1)
            errs[f"Lq={lq} Lk={lk} D={d}"] = check_kernel(
                torch, f"fused_short_attention (Lq={lq}, Lk={lk}, D={d})", fn(*case), ref(*case))
    unaligned = {}
    for lq, lk in ((4, 150), (150, 4)):
        q, k, v, mask, ab = attention_case(torch, dev, 13, 3, lq, lk, 16, 8, masked=True, bias=True)
        q, k, v = (offset_by_one_float(torch, t) for t in (q, k, v))
        unaligned[f"Lq={lq} Lk={lk}"] = check_kernel(
            torch, "fused_short_attention (offset by one float)", fn(q, k, v, mask, ab),
            ref(q, k, v, mask, ab))
    pair = lambda key: sum(s[key] for s in shapes.values())
    return {"name": "fused_short_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:74",
            "launches": None,
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            # one layer of the cross-attention encoder launches one of each shape
            "per": "one 'from' launch plus one 'to' launch",
            "ms": pair("ms"), "plain_ms": pair("plain_ms"),
            **bound(pair("bytes"), pair("flops")), "library_ms": pair("library_ms"),
            "shapes": shapes, "max_abs_err_with_bias": bias_err,
            "max_abs_err_edges": max(errs.values()), "edge_cases": len(errs),
            "max_abs_err_offset_by_one_float": max(unaligned.values())}


def flash_phase(torch, fa, sa, dev) -> dict:
    fn = lambda q, k, v, mask, ab: fa.flash_masked_attention(q, k, v, mask)
    ref = lambda q, k, v, mask, ab: fa.flash_masked_attention_reference(q, k, v, mask)
    path_d = attention_case(torch, dev, 9, 256, 279, 279, 16, 16, masked=True, fused_qkv=True)
    shapes = {
        "path C": attention_measure(torch, "flash_masked_attention (class token)", fn, ref,
                                    attention_case(torch, dev, 8, 32, 1, 6000, 2, 128, masked=True,
                                                   lo=1000)),
        "path D": attention_measure(torch, "flash_masked_attention (279 particles)", fn, ref,
                                    path_d, sa.MMA_PRODUCTS),
    }
    # more than 4 query rows at head dims up to 64 run on the tensor cores
    shapes["path D"].update(
        edge_checks(torch, dev, "flash_masked_attention", fn, ref, (5, 17, 558), path_d))
    long_errs = {}
    for key, masked in (("max_abs_err_long_masked", True), ("max_abs_err_long_unmasked", False)):
        case = attention_case(torch, dev, 10, 4, 1500, 1500, 4, 128, masked=masked)
        long_errs[key] = check_kernel(torch, f"flash_masked_attention ({key})", fn(*case), ref(*case))
    main = shapes["path C"]  # the shape `impl="auto"` sends to this kernel
    return {"name": "flash_masked_attention", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/flash_attention.py:58",
            "launches": None,
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "per": "one launch at path C's shape; path D's shape under `shapes`",
            **{key: main[key] for key in ("ms", "plain_ms", "turns_ms", "bound_ms", "bound_by",
                                          "bytes", "flops", "library_ms", "shape")},
            "shapes": shapes, **long_errs}


# ---------------------------------------------------------------- bfloat16 kernels


def bf16_tol(ref, ulps: int) -> float:
    """`ulps` bfloat16 ulps of the largest |ref| (8 bits of mantissa)."""
    import math

    top = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def check_bf16_kernel(torch, name: str, got, want) -> float:
    """Max abs error of a bfloat16 kernel's result against its plain
    version's; fails beyond BF16_KERNEL_ULPS ulps of the largest |want|."""
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16:
        fail(f"{name} returned {got.dtype}, not bfloat16")
    if not torch.isfinite(got.float()).all():
        fail(f"{name} kernel gave non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    if not err <= bf16_tol(want, BF16_KERNEL_ULPS):
        fail(f"{name} kernel disagrees with its plain version: max abs err {err} beyond "
             f"{BF16_KERNEL_ULPS} bf16 ulps of the largest |out| ({bf16_tol(want, BF16_KERNEL_ULPS)})")
    return err


def bf16_instruction_checked(name: str, instruction_fn, want: str = BF16_INSTRUCTION) -> str:
    """The instruction the built library names for its bfloat16 products;
    fails unless it is the one bfloat16 product the bound counts."""
    got = instruction_fn()
    if got != want:
        fail(f"{name}: the bound counts one {want} per product, the library issues {got}")
    return got


def to_bf16(torch, args, keep=(2,)):
    """The inputs in bfloat16, but for the positions in `keep` (the mask)."""
    return [a if i in keep or a is None else a.to(torch.bfloat16) for i, a in enumerate(args)]


def epic_bf16_measure(torch, ops, args, dims) -> dict:
    """The bf16 EPiC kernel at one shape: check, time in turns with its plain
    version (the medians of TURN_ROUNDS rounds), count the bound: the two
    local matmuls as bfloat16 products, one each, and the per-set products
    (float32 inputs on bfloat16 weights) as three bfloat16 products each, as
    the kernel issues them. The weights are laid out once for the kernels,
    as `EPiCLayer.fold` does, before the timing."""
    b, n, h = args[0].shape
    lat = args[1].shape[-1]
    image = ops.bf16_weight_image(*(args[i] for i in (4, 6, 9, 12, 8, 11)))
    xo, go = ops.epic_layer(*args, **dims, weight_image=image)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    err = max(check_bf16_kernel(torch, "epic_layer_bf16", xo, rx),
              check_bf16_kernel(torch, "epic_layer_bf16", go, rg))
    k1, k2, k3, k4 = (w.shape[0] for w in (args[4], args[6], args[9], args[12]))
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 2 * (b * n * h + b * lat)
    flops = (2 * b * n * h + 2 * b * (k1 * h + k2 * lat + k3 * h + k4 * h)
             + 2 * 2 * b * n * h * h + 5 * b * n * h)
    per_set = 2 * b * (k1 * h + k2 * lat + k3 * h + k4 * h)
    return {"max_abs_err": err,
            **median_in_turns(lambda: ops.epic_layer(*args, **dims, weight_image=image),
                              lambda: ops.epic_layer_reference(*args, **dims)),
            **bound(n_bytes, flops, bf16_flops=4 * b * n * h * h + per_set,
                    bf16_issued=4 * b * n * h * h + EPIC_BF16_SET_PRODUCTS * per_set),
            "shape": {"B": b, "N": n, "H": h, "L": lat, "t": dims["tg_dim"], "cg": dims["cg_dim"],
                      "cl": dims["cl_dim"], "dtype": "bfloat16"}}


def epic_bf16_phase(torch, ops, dev) -> dict:
    """`epic_layer_bf16` at the two served EPiC shapes (the flagship and path
    E, jetclass_cond at batch 512) and at the edges of its 64-row tiles (which
    span sets) and of its widths (padded to 16; 3 and 300 off 8), with ragged
    masks; against its plain version within BF16_KERNEL_ULPS."""
    bf = lambda case: (to_bf16(torch, case[0]), case[1])
    shapes = {
        "flagship": epic_bf16_measure(torch, ops, *bf(epic_case(torch, dev, 40, B, N, H, L, C))),
        "path E (jetclass/jetclass_cond)": epic_bf16_measure(
            torch, ops, *bf(epic_case(torch, dev, 41, 512, 128, 300, 16, 12, local=False))),
        CLASSIFIER_SHAPE: epic_bf16_measure(
            torch, ops, *bf(epic_case(torch, dev, 42, 256, 279, 128, 10, 0, t=0))),
    }
    errs = {}
    for i, (key, (b, n, h, lat, c, local)) in enumerate({
            "N=1": (4, 1, 128, 10, 2, True), "N=17": (5, 17, 128, 10, 2, True),
            "N=65": (3, 65, 128, 10, 2, True), "N=558": (2, 558, 256, 256, 10, True),
            "H=3": (4, 70, 3, 16, 12, True), "H=48": (4, 70, 48, 16, 12, True),
            "H=300": (4, 70, 300, 16, 12, False), "H=512": (2, 70, 512, 512, 12, True)}.items()):
        args, dims = bf(epic_case(torch, dev, 50 + i, b, n, h, lat, c, local, lo=1))
        xo, go = ops.epic_layer(*args, **dims)
        rx, rg = ops.epic_layer_reference(*args, **dims)
        errs[key] = max(check_bf16_kernel(torch, f"epic_layer_bf16 ({key})", xo, rx),
                        check_bf16_kernel(torch, f"epic_layer_bf16 ({key})", go, rg))
    for key, case in no_set_feature_edges(torch, dev).items():
        args, dims = bf(case)
        xo, go = ops.epic_layer(*args, **dims)
        rx, rg = ops.epic_layer_reference(*args, **dims)
        errs[key] = max(check_bf16_kernel(torch, f"epic_layer_bf16 ({key})", xo, rx),
                        check_bf16_kernel(torch, f"epic_layer_bf16 ({key})", go, rg))
    main = shapes["flagship"]
    return {
        "name": "epic_layer_bf16", "route": "cuda",
        "source": "particle_fm_tpu_torch/csrc/epic_layer.cu",
        "replaces": "particle_fm_tpu/ops/pallas/epic_layer.py:113", "launches": None,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "per": "one launch at the flagship's shape; path E's and the classifier's under `shapes`",
        **{key: main[key] for key in ("ms", "plain_ms", "turns_ms", "bound_ms", "bound_by", "bytes",
                                      "flops", "tensor_flops_issued", "shape")},
        "library_ms": None,  # no single PyTorch call computes an EPiC layer
        "instruction": bf16_instruction_checked("epic_layer_bf16", ops.bf16_instruction,
                                                EPIC_BF16_INSTRUCTION),
        "tolerance": f"{BF16_KERNEL_ULPS} bf16 ulps of the largest |out|",
        "shapes": shapes, "max_abs_err_edges": max(errs.values()), "edge_cases": len(errs),
    }


def epic_bf16_design(torch, ops) -> dict:
    """What the built library says its launcher gives the two bfloat16 EPiC
    kernels at the two served shapes and at lhco/bigPC's; fails unless the
    wrapper's mirror (`bf16_geometry`) says the same and the instruction is
    the wgmma of the column block."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reports = {}
    for key, (b, n, h, lat, c, cl) in {"flagship": (B, N, H, L, C, C),
                                       "path E": (512, 128, 300, 16, 12, 0),
                                       "lhco/bigPC": (128, 558, 256, 256, 10, 10)}.items():
        report = ops.bf16_launch_report(b, n, h, lat, T + c, T, T, c, cl)
        mirror = ops.bf16_geometry(b, n, h, lat, sms, T, T, c, cl)
        if {k: report[k] for k in mirror} != mirror:
            fail(f"epic_layer_bf16 ({key}): the library's launch {report} is not the wrapper's "
                 f"mirror {mirror}")
        want = EPIC_BF16_INSTRUCTION.replace("m64nNk16", f"m64n{mirror['column_block']}k16")
        if report["instruction"] != want:
            fail(f"epic_layer_bf16 ({key}): the library issues {report['instruction']}, the bound "
                 f"counts {want}")
        reports[key] = report
    return reports


def attention_bf16_measure(torch, name, fn, ref, case, bf16_products: float = 0.0,
                           tf32_flops: float = 0.0, tf32_products: int = 1,
                           in_turns_with_library: bool = False, real_keys: bool = False) -> dict:
    """One bf16 attention kernel at one shape: check, time in turns with its
    plain version, time bf16 `scaled_dot_product_attention` on the same
    tensors (with `in_turns_with_library`, in the same turns, the medians of
    TURN_ROUNDS rounds), count the bound (`bf16_products`: the operations it
    runs as bfloat16 products; `tf32_flops` those it runs `tf32_products`
    times in TF32; the rest on the CUDA cores). With `real_keys` (a kernel
    that stops at each set's last real key): the bound over the keys the
    data needs too (`real_keys_bound_ms`: K and V rows, scores and products
    up to each set's extent, `short_attention.real_key_extents`), the
    kernel's device time (`device_ms`, the median of DEVICE_READINGS
    readings of `timing.device_reading`: torch.profiler, or CUDA events where
    its recordings hold no launch; `device_ms_read_by` says which), and the
    run fails if a median reads below that
    bound: an impossible reading."""
    import statistics

    import torch.nn.functional as F

    from particle_fm_tpu_torch.ops.short_attention import real_key_extents
    from particle_fm_tpu_torch.utils.timing import cuda_ms, device_reading

    q, k, v, mask, ab = case
    b, lq, h, d = q.shape
    lk = k.shape[1]
    want = ref(q, k, v, mask, ab)
    err = check_bf16_kernel(torch, name, fn(q, k, v, mask, ab), want)
    add = None if mask is None else ((mask - 1.0) * 1e9)[:, None, None, :].to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add).transpose(1, 2)
    lib_err = (library().float() - want.float()).abs().max().item()
    if not lib_err <= bf16_tol(want, BF16_LIBRARY_ULPS):
        fail(f"{name}: the bf16 library yardstick computes another function (max abs err "
             f"{lib_err})")
    n_bytes = (2 * (2 * q.numel() + k.numel() + v.numel())
               + (0 if mask is None else 4 * mask.numel()))
    flops = (4 * d + SCORE_OPS) * b * h * lq * lk
    if in_turns_with_library:  # a redesigned kernel: the library call in the turns too
        times = median_in_turns(lambda: fn(q, k, v, mask, ab), lambda: ref(q, k, v, mask, ab),
                                library)
    else:
        times = {**timed_in_turns(lambda: fn(q, k, v, mask, ab), lambda: ref(q, k, v, mask, ab)),
                 "library_ms": cuda_ms(library)}
    out = {"max_abs_err": err, "max_abs_err_library": lib_err, **times,
           **bound(n_bytes, flops, tf32_flops, tf32_products, bf16_flops=bf16_products),
           "shape": {"B": b, "Lq": lq, "Lk": lk, "H": h, "D": d, "masked": mask is not None,
                     "dtype": "bfloat16"}}
    if real_keys:
        keys = int(real_key_extents(mask, b, lk).sum())  # over the sets; every head alike
        share = keys / (b * lk)
        real = bound(n_bytes - 2 * (k.numel() + v.numel()) * (1 - share), flops * share,
                     tf32_flops * share, tf32_products, bf16_flops=bf16_products * share)
        readings = [device_reading(lambda: fn(q, k, v, mask, ab))
                    for _ in range(DEVICE_READINGS)]
        out.update(real_keys_share=share, real_keys_bound_ms=real["bound_ms"],
                   real_keys_bound_by=real["bound_by"], real_keys_bytes=real["bytes"],
                   real_keys_flops=real["flops"],
                   device_ms=statistics.median(ms for ms, _ in readings),
                   device_ms_read_by=sorted({by for _, by in readings}))
        for key in ("ms", "device_ms"):
            if out[key] < real["bound_ms"]:
                fail(f"{name}: {key} {out[key]} reads below the bound over the real keys "
                     f"({real['bound_ms']} ms): an impossible reading")
    return out


def bf16_case(torch, case):
    """An attention case in bfloat16 (the mask and the bias stay float32)."""
    q, k, v, mask, ab = case
    return (*(x.to(torch.bfloat16) for x in (q, k, v)), mask, ab)


def bf16_edges(torch, dev, name, fn, ref, lengths, pairs=(), bias_dims=()) -> dict:
    """A bf16 kernel against its plain version at `lengths` (Lq = Lk) and
    `pairs` (Lq, Lk) at head dims 8, 12, 32 and 64, 1 to Lk real keys, a bias
    at `bias_dims`, and with operands offset by one element (no wide loads)."""
    errs = {}
    for lq, lk in [(l, l) for l in lengths] + list(pairs):
        for d in (8, 12, 32, 64):
            case = bf16_case(torch, attention_case(torch, dev, lq + lk + d, 3, lq, lk, 3, d,
                                                   masked=True, bias=d in bias_dims, lo=1))
            errs[f"Lq={lq} Lk={lk} D={d}"] = check_bf16_kernel(
                torch, f"{name} (Lq={lq}, Lk={lk}, D={d})", fn(*case), ref(*case))
    q, k, v, mask, ab = bf16_case(torch, attention_case(torch, dev, 12, 3, 37, 37, 3, 16,
                                                        masked=True, lo=1))
    q, k, v = (offset_by_one_float(torch, x) for x in (q, k, v))
    unaligned = check_bf16_kernel(torch, f"{name} (offset by one element)", fn(q, k, v, mask, ab),
                                  ref(q, k, v, mask, ab))
    return {"max_abs_err_edges": max(errs.values()), "edge_cases": len(errs),
            "max_abs_err_offset_by_one_element": unaligned}


MASK_CASES = ("prefix", "holes", "only the last key", "all masked", "fractional only")


def mask_case(torch, kind: str, b: int, lk: int, dev):
    """A (B, Lk) key mask of one kind, the set's extent (the keys the bf16
    flash and fused kernels step over) then ends at: a prefix of real keys
    (of 1 to Lk), holes (every third key of a prefix), only the last key
    real, every key masked (all Lk keys count), fractional values only (all
    Lk count). Set 0 has every key masked in all but the last kind."""
    gen = torch.Generator().manual_seed(lk + len(kind))
    counts = torch.randint(1, lk + 1, (b, 1), generator=gen)
    keys = torch.arange(lk)[None, :]
    m = (keys < counts).float()
    if kind == "holes":
        m = m * (keys % 3 == 0).float()
    elif kind == "only the last key":
        m = (keys == lk - 1).float().expand(b, lk).clone()
    elif kind == "all masked":
        m = torch.zeros(b, lk)
    elif kind == "fractional only":
        m = 0.5 * m
    if kind not in ("all masked", "fractional only"):
        m[0] = 0.0
    return m.to(dev)


def mask_checks(torch, dev, name, fn, ref, shapes) -> dict:
    """A bf16 kernel against its plain version on every MASK_CASES mask at
    `shapes` (Lq, Lk, D), 3 sets of 3 heads."""
    errs = {}
    for lq, lk, d in shapes:
        q, k, v, _, _ = bf16_case(torch, attention_case(torch, dev, lq + lk + d, 3, lq, lk, 3, d,
                                                        masked=False))
        for kind in MASK_CASES:
            mask = mask_case(torch, kind, 3, lk, dev)
            errs[f"{kind}: Lq={lq} Lk={lk} D={d}"] = check_bf16_kernel(
                torch, f"{name} ({kind}, Lq={lq}, Lk={lk}, D={d})", fn(q, k, v, mask, None),
                ref(q, k, v, mask, None))
    return {"max_abs_err_mask_cases": max(errs.values()), "mask_cases": len(errs)}


def bf16_design(name, report, mirror, **want) -> dict:
    """A redesigned bf16 kernel's launch report against the wrapper's mirror
    and the instructions and products its bound counts; fails on any
    difference."""
    if {k: report[k] for k in mirror} != mirror:
        fail(f"{name}: the library's launch {report} is not the wrapper's mirror {mirror}")
    for key, value in want.items():
        if report[key] != value:
            fail(f"{name}: the library reports {key}={report[key]}, the bound counts {value}")
    return report


def packed_bf16_phase(torch, sa, dev) -> dict:
    """The bf16 packed kernel (redesigned: one pass over Q . K^T for a group
    of heads, stopping at each set's last real key) at path A, in
    TURN_ROUNDS rounds of in-turn readings with bf16 SDPA and read on the
    device, with its bound over all keys and over the real keys. Then the
    launch reports against the wrapper's mirror, a bias, the mask cases, the
    edges, and two launches alike."""
    fn, ref = sa.packed_short_attention, sa.packed_short_attention_reference
    main = bf16_case(torch, attention_case(torch, dev, 60, 640, 150, 150, 16, 16, masked=True,
                                           fused_qkv=True))
    b, l, h, d = main[0].shape
    entry = attention_bf16_measure(torch, "packed_short_attention_bf16", fn, ref, main,
                                   bf16_products=4 * d * b * h * l * l,
                                   in_turns_with_library=True, real_keys=True)
    case = bf16_case(torch, attention_case(torch, dev, 61, 64, 150, 150, 16, 16, masked=True,
                                           bias=True))
    bias_err = check_bf16_kernel(torch, "packed_short_attention_bf16 (bias)", fn(*case), ref(*case))
    design = {f"B={bb} L={ll} H={hh} D={dd}" + (" bias" if biased else ""): bf16_design(
        f"packed_short_attention_bf16 (B={bb}, L={ll}, H={hh}, D={dd}, bias={biased})",
        sa.packed_bf16_launch_report(bb, ll, hh, dd, biased),
        sa.packed_bf16_geometry(bb, ll, hh, dd, biased), instruction=BF16_INSTRUCTION)
        for bb, ll, hh, dd, biased in ((640, 150, 16, 16, False), (64, 150, 16, 16, True),
                                       (3, 256, 3, 64, False), (3, 17, 3, 12, True),
                                       (4, 37, 3, 33, False))}
    with torch.no_grad():
        out, again = fn(*main), fn(*main)
    if not torch.equal(out, again):
        fail("packed_short_attention_bf16: a second launch differs")
    return {"name": "packed_short_attention_bf16", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:308", "launches": None,
            **entry, "launch": design, "max_abs_err_with_bias": bias_err,
            "instruction": bf16_instruction_checked("packed_short_attention_bf16",
                                                    sa.bf16_instruction),
            "tolerance": f"{BF16_KERNEL_ULPS} bf16 ulps of the largest |out|",
            **mask_checks(torch, dev, "packed_short_attention_bf16", fn, ref,
                          [(150, 150, 16), (17, 17, 12), (256, 256, 64), (33, 33, 32)]),
            **bf16_edges(torch, dev, "packed_short_attention_bf16", fn, ref, (1, 15, 16, 17, 256),
                         bias_dims=(12, 64))}


def fused_bf16_phase(torch, sa, dev) -> dict:
    """The bf16 fused kernels (redesigned: "from" stops at each set's last
    real key) at path B's two halves, each timed in TURN_ROUNDS rounds of
    in-turn readings with bf16 SDPA and read on the device, with its bound
    over all keys and over the real keys; the pair is their sum. Then the
    launch reports against the wrapper's mirror, a bias, the edges, the mask
    cases, and two launches alike."""
    fn, ref = sa.fused_short_attention, sa.fused_short_attention_reference
    shapes = {
        "from": attention_bf16_measure(
            torch, "fused_short_attention_bf16 (from)", fn, ref,
            bf16_case(torch, attention_case(torch, dev, 62, 640, 4, 150, 16, 8, masked=True)),
            in_turns_with_library=True, real_keys=True),
        "to": attention_bf16_measure(
            torch, "fused_short_attention_bf16 (to)", fn, ref,
            bf16_case(torch, attention_case(torch, dev, 63, 640, 150, 4, 16, 8, masked=False)),
            in_turns_with_library=True, real_keys=True),
    }
    case = bf16_case(torch, attention_case(torch, dev, 64, 64, 37, 150, 16, 8, masked=True,
                                           bias=True))
    bias_err = check_bf16_kernel(torch, "fused_short_attention_bf16 (bias)", fn(*case), ref(*case))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    design = {f"Lq={lq} Lk={lk}": bf16_design(
        f"fused_short_attention_bf16 (Lq={lq}, Lk={lk})",
        sa.fused_bf16_launch_report(b, lq, lk, 16, 8, biased),
        sa.fused_bf16_geometry(b, lq, lk, 16, 8, sms))
        for b, lq, lk, biased in ((640, 4, 150, False), (640, 150, 4, False), (64, 37, 150, True))}
    with torch.no_grad():
        out, again = fn(*case), fn(*case)
    if not torch.equal(out, again):
        fail("fused_short_attention_bf16: a second launch differs")
    pair = lambda key: sum(x[key] for x in shapes.values())
    return {"name": "fused_short_attention_bf16", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/short_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/short_attention.py:74", "launches": None,
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "per": "one 'from' launch plus one 'to' launch (each half under `shapes`)",
            "ms": pair("ms"), "plain_ms": pair("plain_ms"), "device_ms": pair("device_ms"),
            **bound(pair("bytes"), pair("flops")), "library_ms": pair("library_ms"),
            "real_keys_bound_ms": pair("real_keys_bound_ms"),
            "tolerance": f"{BF16_KERNEL_ULPS} bf16 ulps of the largest |out|",
            "shapes": shapes, "launch": design, "max_abs_err_with_bias": bias_err,
            **mask_checks(torch, dev, "fused_short_attention_bf16", fn, ref,
                          [(4, 150, 8), (4, 17, 12), (3, 512, 64)]),
            **bf16_edges(torch, dev, "fused_short_attention_bf16", fn, ref, (1, 5, 17, 512),
                         pairs=[(4, 17), (4, 512), (17, 4), (512, 4)], bias_dims=(12, 64))}


def flash_bf16_phase(torch, fa, dev) -> dict:
    """The bf16 flash kernel at paths C (class token) and D (redesigned:
    K and V staged once per (set, head), stopping at each set's last real
    key), in turns with bf16 SDPA; path D read on the device too, with its
    bound over all keys and over the real keys. Then the launch reports
    against the wrappers' mirrors, the instructions of both products, the
    class-token checks, 1500 keys at head dim 128, the mask cases, the edges,
    and two launches alike."""
    fn = lambda q, k, v, mask, ab: fa.flash_masked_attention(q, k, v, mask)
    ref = lambda q, k, v, mask, ab: fa.flash_masked_attention_reference(q, k, v, mask)
    path_d = bf16_case(torch, attention_case(torch, dev, 65, 256, 279, 279, 16, 16, masked=True,
                                             fused_qkv=True))
    b, l, h, d = path_d[0].shape
    half = 2 * d * b * h * l * l  # each of Q . K^T and P . V
    shapes = {
        "path C": attention_bf16_measure(
            torch, "flash_masked_attention_bf16 (class token)", fn, ref,
            bf16_case(torch, attention_case(torch, dev, 66, 32, 1, 6000, 2, 128, masked=True,
                                            lo=1000)), in_turns_with_library=True),
        "path D": attention_bf16_measure(
            torch, "flash_masked_attention_bf16 (279 particles)", fn, ref, path_d,
            bf16_products=half, tf32_flops=half, tf32_products=FLASH_BF16_PV_TF32_PRODUCTS,
            in_turns_with_library=True, real_keys=True),
    }
    design = {f"B={bb} Lq={lq} Lk={lk} H={hh} D={dd}": bf16_design(
        f"flash_masked_attention_bf16 (B={bb}, Lq={lq}, Lk={lk}, D={dd})",
        fa.mma_bf16_launch_report(bb, lq, lk, hh, dd), fa.mma_bf16_geometry(bb, lq, lk, hh, dd),
        instruction=BF16_INSTRUCTION, pv_instruction=TF32_INSTRUCTION,
        pv_tf32_products=FLASH_BF16_PV_TF32_PRODUCTS)
        for bb, lq, lk, hh, dd in ((256, 279, 279, 16, 16), (3, 558, 558, 3, 64),
                                   (3, 17, 17, 3, 8), (4, 1500, 1500, 4, 32))}
    token = token_bf16_checks(torch, fa, dev)
    long_err = check_bf16_kernel(
        torch, "flash_masked_attention_bf16 (1500 keys, head dim 128)",
        *(f(*bf16_case(torch, attention_case(torch, dev, 67, 4, 1500, 1500, 4, 128, masked=True)))
          for f in (fn, ref)))
    case = bf16_case(torch, attention_case(torch, dev, 68, 3, 558, 558, 3, 32, masked=True, lo=1))
    with torch.no_grad():
        out, again = fn(*case), fn(*case)
    if not torch.equal(out, again):
        fail("flash_masked_attention_bf16 (558 keys, a ring of two stages): a second launch differs")
    main = shapes["path C"]
    return {"name": "flash_masked_attention_bf16", "route": "cuda",
            "source": "particle_fm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "particle_fm_tpu/ops/pallas/flash_attention.py:58", "launches": None,
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "per": "one launch at path C's shape; path D's shape under `shapes`",
            **{key: main[key] for key in ("ms", "plain_ms", "turns_ms", "bound_ms", "bound_by",
                                          "bytes", "flops", "library_ms", "shape")},
            "instruction": bf16_instruction_checked("flash_masked_attention_bf16",
                                                    fa.bf16_instruction),
            "tolerance": f"{BF16_KERNEL_ULPS} bf16 ulps of the largest |out|",
            "shapes": shapes, "launch_more_than_4_rows": design,
            "max_abs_err_long_head_dim_128": long_err,
            # a timing, so reported and not failed on: run-to-run spread is a few percent
            "path_c_kernel_over_library": main["ms"] / main["library_ms"],
            "class_token": token,
            **mask_checks(torch, dev, "flash_masked_attention_bf16", fn, ref,
                          [(279, 279, 16), (37, 600, 32), (5, 17, 64), (17, 300, 8),
                           (2, 900, 128)]),
            **bf16_edges(torch, dev, "flash_masked_attention_bf16", fn, ref, (5, 17, 558),
                         pairs=[(3, 900), (33, 1500), (300, 20)])}


def token_bf16_checks(torch, fa, dev) -> dict:
    """The class-token variant: its launch report at path C's shape against
    the wrapper's mirror (blocks, warps, and the resident blocks an SM that
    its split count assumes), and the variant against its plain version at
    1 to 4 query rows, on key counts off every step and split (one split:
    700 (set, head) pairs), with a fully masked set, twice in a row (the
    tickets are left at zero)."""
    report = fa.token_launch_report(32, 1, 6000, 2, 128)
    mirror = fa.token_geometry(32, 6000, 2, torch.cuda.get_device_properties(0).multi_processor_count)
    if any(report[k] != mirror[k] for k in ("blocks", "warps", "resident_blocks_per_sm")):
        fail(f"flash_masked_attention_bf16 class tokens: the library's launch {report} is not the "
             f"wrapper's mirror {mirror}")
    errs = {}
    for lq, lk, h, d, b in ((1, 6001, 2, 128, 32), (2, 997, 3, 64, 3), (3, 37, 2, 32, 5),
                            (4, 300, 3, 8, 4), (1, 150, 1, 128, 700)):
        q, k, v, mask, _ = bf16_case(torch, attention_case(torch, dev, lq + lk, b, lq, lk, h, d,
                                                           masked=True, lo=1))
        mask[0] = 0.0  # a fully masked set
        with torch.no_grad():
            out = fa.flash_masked_attention(q, k, v, mask)
            again = fa.flash_masked_attention(q, k, v, mask)
        if not torch.equal(out, again):
            fail(f"flash_masked_attention_bf16 (Lq={lq}, Lk={lk}): a second launch differs")
        errs[f"Lq={lq} Lk={lk} D={d} B={b}"] = check_bf16_kernel(
            torch, f"flash_masked_attention_bf16 (Lq={lq}, Lk={lk}, D={d})", out,
            fa.flash_masked_attention_reference(q, k, v, mask))
    return {"launch": report, "mirror": mirror, "max_abs_err_cases": max(errs.values()),
            "cases": len(errs)}


def redraw_parameters(torch, net, seed: int) -> None:
    """Seeded non-zero values for every parameter: matrices N(0, 1/fan_in),
    vectors their initial value (LayerNorm 1, bias 0 or small) + 0.1 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            draw = torch.randn(p.shape, generator=gen).to(p.device)
            if p.ndim >= 2:
                p.copy_(draw / p.shape[-1] ** 0.5)
            else:
                p.add_(0.1 * draw)


def serving_phase(torch, dev, name, config, model, net, wrapper_owner, wrapper_name,
                  launches_per_eval, requests, counted, batch=640, mask_lo=30,
                  cpu_batch=8) -> dict:
    """Serve `requests` in batches of `batch` through make_serve_fn/
    serve_batches on the kernel path and on the plain path, and hold a small
    batch of `cpu_batch` sets against the CPU. Sets have `mask_lo` to
    `model.num_particles` real particles."""
    from particle_fm_tpu_torch.serving import make_serve_fn, serve_batches

    wrapper = getattr(wrapper_owner, wrapper_name)
    plain = getattr(wrapper_owner, wrapper_name + "_reference")
    n, feats, cond_dim = model.num_particles, model.features, model.global_cond_dim
    proto = serving_proto(model, batch)
    fn = make_serve_fn(model, net, ode_steps=ODE_STEPS, **proto)
    warm = make_serve_fn(model, net, ode_steps=2, **proto)

    rs = np.random.RandomState(1)
    reqs = [(ragged_mask(rs, r, n, mask_lo)[..., None], rs.randn(r, cond_dim).astype(np.float32))
            for r in requests]
    n_batches = sum(-(-r // batch) for r in requests)
    want_launches = launches_per_eval * 2 * (ODE_STEPS - 1) * n_batches

    def answer(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [serve_batches(f, f.meta, len(m), cond=c, mask=m, seed=10 + i)
                for i, (m, c) in enumerate(reqs)]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    answer(warm)
    reset(counted)
    outs, secs = answer(fn)  # the main path
    launches = wrapper.launches

    for (m, _), out in zip(reqs, outs):
        if out.shape != (len(m), n, feats):
            fail(f"{name}: served shape {out.shape}, expected {(len(m), n, feats)}")
        if not np.isfinite(out).all():
            fail(f"{name}: served samples are not finite")
        if np.abs(out[m[..., 0] == 0]).max(initial=0.0) != 0.0:
            fail(f"{name}: padded rows of the served samples are not zero")
    if launches != want_launches:
        fail(f"{name}: {wrapper_name} launched {launches} times on the serving path, "
             f"expected {want_launches}")
    if sum(w.launches for w in counted) != launches:
        fail(f"{name}: a kernel of another path was launched on this one")

    # then in turns with the kernel's plain version: plain, plain, kernel
    with mock.patch.object(wrapper_owner, wrapper_name, plain):
        answer(warm)
        plain_outs, plain_secs = answer(fn)
        plain_secs2 = answer(fn)[1]
    secs2 = answer(fn)[1]
    path_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    if not path_err <= PATH_TOL:
        fail(f"{name}: kernel path and plain path disagree after 100 evaluations: {path_err}")

    # a small input against the CPU, with the same noise and weights
    gen = torch.Generator().manual_seed(2)
    mask = torch.from_numpy(ragged_mask(rs, cpu_batch, n, mask_lo)[..., None])
    cond = torch.randn(cpu_batch, cond_dim, generator=gen) if cond_dim else None
    z = torch.randn(cpu_batch, n, feats, generator=gen) * mask
    cond_dev = None if cond is None else cond.to(dev)
    with torch.no_grad():
        field = model.vector_field(net, torch.full((cpu_batch,), 0.5, device=dev), z.to(dev),
                                   cond_dev, mask.to(dev))
    field_max = float(field.abs().max())
    if not (np.isfinite(field_max) and field_max > 0.0):
        fail(f"{name}: the vector field is identically zero or not finite (max abs {field_max})")
    gpu = model.integrate(net, z.to(dev), cond_dev, mask.to(dev), "midpoint", 5).cpu()
    cpu_net = copy.deepcopy(net).cpu()
    cpu = model.integrate(cpu_net, z, cond, mask, "midpoint", 5)
    cpu_err = float((gpu - cpu).abs().max())
    if not cpu_err <= CPU_TOL:
        fail(f"{name}: small batch on the card disagrees with the CPU: {cpu_err}")

    jets = sum(requests)
    return {
        "config": config, "requests": list(requests), "batch": batch, "batches": n_batches,
        "ode_solver": "midpoint", "ode_steps": ODE_STEPS, "nfe": 2 * (ODE_STEPS - 1),
        "kernel_path_s": [secs, secs2], "plain_path_s": [plain_secs, plain_secs2],
        "kernel_path_jets_per_s": 2 * jets / (secs + secs2),
        "plain_path_jets_per_s": 2 * jets / (plain_secs + plain_secs2),
        "kernel_path_batch_jets_per_s": 2 * n_batches * batch / (secs + secs2),
        "plain_path_batch_jets_per_s": 2 * n_batches * batch / (plain_secs + plain_secs2),
        "kernel": wrapper_name, "launches": launches, "vector_field_max_abs": field_max,
        "max_abs_diff_kernel_vs_plain": path_err, "max_abs_diff_card_vs_cpu": cpu_err,
        "cpu_batch": cpu_batch,
        "_reqs": reqs, "_outs": outs,  # for the bfloat16 phase; not printed
    }


def serving_proto(model, batch: int) -> dict:
    """The serving protocol of the serving phases: midpoint, cond (where the
    model takes one) and mask, the datamodule's z-score undone with
    per-feature means and stds."""
    feats = model.features
    means = ([0.0, 0.0, 0.05, 0.0] + [0.0] * 9)[:feats]
    stds = ([0.1, 0.1, 0.06, 0.2] + [0.5] * 9)[:feats]
    return dict(batch_size=batch, ode_solver="midpoint", has_cond=bool(model.global_cond_dim),
                has_mask=True, means=means, stds=stds)


def frob(x) -> float:
    return float(np.sqrt(np.sum(np.square(np.asarray(x, np.float64)))))


def bf16_serving_phase(torch, dev, name, config, model, net, wrapper_owner, wrapper_name,
                       launches_per_eval, requests, counted, f32, batch=640, **_) -> dict:
    """The same configuration, weights and requests served with
    model.dtype=bfloat16 through make_serve_fn/serve_batches at NFE 100: the
    exact launches of the bfloat16 kernel and of no other (no float32 kernel
    takes a cast tensor), finite outputs, zero padded rows; sets/s of the
    kernel path and the plain path, in turns; per-feature mean and std of
    the real particles against the float32 kernel path's samples from the
    same noise (`f32`, its serving phase), within BF16_STATS_LIMIT of the
    float32 std; after 4 midpoint steps on a full batch, kernel path against
    plain path closer than plain bfloat16 is to float32 (Frobenius norms);
    a field not identically zero."""
    import dataclasses

    from particle_fm_tpu_torch.serving import make_serve_fn, serve_batches

    model16 = dataclasses.replace(model, dtype="bfloat16")
    net16 = model16.init(seed=0, device=dev)
    net16.load_state_dict(net.state_dict())
    counter = getattr(wrapper_owner, wrapper_name + "_bf16")
    plain = getattr(wrapper_owner, wrapper_name + "_reference")
    proto = serving_proto(model, batch)
    fn = make_serve_fn(model16, net16, ode_steps=ODE_STEPS, **proto)
    warm = make_serve_fn(model16, net16, ode_steps=2, **proto)
    reqs = f32["_reqs"]
    n_batches = sum(-(-r // batch) for r in requests)
    want_launches = launches_per_eval * 2 * (ODE_STEPS - 1) * n_batches

    def answer(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [serve_batches(f, f.meta, len(m), cond=c, mask=m, seed=10 + i)
                for i, (m, c) in enumerate(reqs)]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    answer(warm)
    reset(counted)
    outs, secs = answer(fn)  # the main path
    launches = counter.launches
    for (m, _), out in zip(reqs, outs):
        if out.dtype != np.float32 or not np.isfinite(out).all():
            fail(f"{name} bf16: served samples are not finite float32")
        if np.abs(out[m[..., 0] == 0]).max(initial=0.0) != 0.0:
            fail(f"{name} bf16: padded rows of the served samples are not zero")
    if launches != want_launches:
        fail(f"{name} bf16: {counter.__name__} launched {launches} times, expected {want_launches}")
    if sum(w.launches for w in counted) != launches:
        fail(f"{name} bf16: another kernel (a float32 one?) was launched on this path: "
             f"{launched(counted)}")

    with mock.patch.object(wrapper_owner, wrapper_name, plain):  # plain, plain, kernel
        answer(warm)
        plain_outs, plain_secs = answer(fn)
        plain_secs2 = answer(fn)[1]
    secs2 = answer(fn)[1]

    # 4 midpoint steps on a full batch: kernel against plain, and plain bf16 against float32
    m, c = (torch.from_numpy(a[:batch]).to(dev) for a in reqs[0])
    c = c if model.global_cond_dim else None
    z = torch.randn(m.shape[0], model.num_particles, model.features,
                    generator=torch.Generator().manual_seed(3)).to(dev) * m
    k16 = model16.integrate(net16, z, c, m, "midpoint", BF16_CHECK_STEPS)
    with mock.patch.object(wrapper_owner, wrapper_name, plain):
        p16 = model16.integrate(net16, z, c, m, "midpoint", BF16_CHECK_STEPS)
    x32 = model.integrate(net, z, c, m, "midpoint", BF16_CHECK_STEPS)
    ours, theirs = frob((k16 - p16).cpu()), frob((p16 - x32).cpu())
    if not ours < theirs:
        fail(f"{name} bf16: kernel path and plain path after 4 steps |{ours}| are not closer "
             f"than plain bf16 is to float32 |{theirs}|")

    # NFE 100: the bf16 samples against the float32 kernel path's, per feature
    path_err = max(float(np.abs(a - b).max()) for a, b in zip(outs, plain_outs))
    real16 = np.concatenate([o[m[..., 0] > 0] for (m, _), o in zip(reqs, outs)])
    real32 = np.concatenate([o[m[..., 0] > 0] for (m, _), o in zip(reqs, f32["_outs"])])
    std32 = real32.std(axis=0)
    d_mean = np.abs(real16.mean(axis=0) - real32.mean(axis=0)) / std32
    d_std = np.abs(real16.std(axis=0) - std32) / std32
    if not max(d_mean.max(), d_std.max()) <= BF16_STATS_LIMIT:
        fail(f"{name} bf16: per-feature mean/std off the float32 samples by {d_mean.max()} / "
             f"{d_std.max()} of the float32 std (limit {BF16_STATS_LIMIT})")

    with torch.no_grad():
        field = model16.vector_field(net16, torch.full((m.shape[0],), 0.5, device=dev), z, c, m)
    field_max = float(field.float().abs().max())
    if not (np.isfinite(field_max) and field_max > 0.0):
        fail(f"{name} bf16: the vector field is identically zero or not finite ({field_max})")

    jets = sum(requests)
    return {
        "config": config + ", model.dtype=bfloat16", "requests": list(requests), "batch": batch,
        "batches": n_batches, "nfe": 2 * (ODE_STEPS - 1), "kernel": counter.__name__,
        "launches": launches,
        "kernel_path_s": [secs, secs2], "plain_path_s": [plain_secs, plain_secs2],
        "kernel_path_jets_per_s": 2 * jets / (secs + secs2),
        "plain_path_jets_per_s": 2 * jets / (plain_secs + plain_secs2),
        "kernel_path_batch_jets_per_s": 2 * n_batches * batch / (secs + secs2),
        "plain_path_batch_jets_per_s": 2 * n_batches * batch / (plain_secs + plain_secs2),
        "f32_kernel_path_batch_jets_per_s": f32["kernel_path_batch_jets_per_s"],
        "nfe100_vs_f32": {"max_mean_diff_over_std": float(d_mean.max()),
                          "max_std_diff_over_std": float(d_std.max()),
                          "mean_diff_over_std": d_mean.tolist(),
                          "std_diff_over_std": d_std.tolist(), "limit": BF16_STATS_LIMIT,
                          "max_abs_diff": max(float(np.abs(a - b).max())
                                              for a, b in zip(outs, f32["_outs"]))},
        "nfe100_max_abs_diff_kernel_vs_plain": path_err,
        "four_steps": {"kernel_vs_plain_frobenius": ours, "plain_bf16_vs_f32_frobenius": theirs,
                       "kernel_vs_plain_max_abs": float((k16 - p16).abs().max()),
                       "plain_bf16_vs_f32_max_abs": float((p16 - x32).abs().max())},
        "vector_field_max_abs": field_max,
    }


def droid_net_config(core_key: str, model_dim: int, num_layers: int, attn_impl: str,
                     dense_hddn: int | None = None) -> dict:
    """net_config of configs/model/fm_droid_{transformer,crossattention}.yaml,
    with the attention kernel chosen and float32 scores."""
    embd = {"act_h": "lrlu", "nrm": "layer"}
    dense = dict(embd, output_init_zeros=True)
    if dense_hddn:
        dense["hddn_dim"] = dense_hddn
    mha = {"num_heads": 16, "init_zeros": True, "do_layer_norm": True,
           "scores_dtype": None, "attn_impl": attn_impl}
    return {"node_embd_config": embd, "ctxt_embd_config": dict(embd, outp_dim=64),
            "outp_embd_config": dict(embd, output_init_zeros=True),
            core_key: {"model_dim": model_dim, "num_layers": num_layers, "mha_config": mha,
                       "dense_config": dense}}


# training phases: the loss at the card against the CPU and the kernel
# against the plain path, from the same weights and pinned draws
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4  # max abs gradient error over the largest gradient
TRAIN_STEPS = 30


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compose_training(overrides: list[str]):
    """(model, datamodule, cfg) built from configs/ by the port's compose and
    instantiate, the model block's optimizer and scheduler popped."""
    from particle_fm_tpu_torch.config.core import compose, instantiate
    from particle_fm_tpu_torch.train import CONFIG_DIR

    cfg = compose(CONFIG_DIR, "train", overrides)
    model_cfg = {k: v for k, v in cfg["model"].items() if k not in ("optimizer", "scheduler")}
    return instantiate(model_cfg), instantiate(cfg["data"]), cfg


def pinned_loss_and_grads(torch, model, net, batch, seed: int):
    """The training loss and every parameter's gradient, with the loss's t
    and noise pinned to numpy draws from `seed` (one t and one z: FM-OT)."""
    from particle_fm_tpu_torch.losses import flow_matching as ploss

    x = batch[0]
    rs = np.random.RandomState(seed)
    t = torch.from_numpy(rs.rand(x.shape[0]).astype(np.float32)).to(x.device)
    z = torch.from_numpy(rs.randn(*x.shape).astype(np.float32)).to(x.device)
    with mock.patch.multiple(ploss, _sample_t=lambda g, b, d: t, _normal=lambda g, s, d: z):
        loss = model.loss(net, torch.Generator(x.device), *batch, train=True)
        grads = torch.autograd.grad(loss, list(net.parameters()))
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def held_against(name: str, got, want) -> dict:
    """Loss and gradients (from pinned_loss_and_grads) against a reference."""
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    scale = max(float(g.abs().max()) for g in want[1])
    grad_err = max(float((a - b).abs().max()) for a, b in zip(got[1], want[1])) / scale
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
        fail(f"{name}: loss rel err {loss_err} (limit {TRAIN_LOSS_RTOL}), gradient err {grad_err} "
             f"of the largest gradient (limit {TRAIN_GRAD_TOL})")
    return {"loss": got[0], "loss_rel_err": loss_err, "grad_err_over_largest": grad_err,
            "largest_grad": scale, "n_params": len(want[1])}


def run_steps(torch, trainer, state, data, n_steps: int):
    """`n_steps` train steps over the trainer's epoch batches of `data` (the
    train split on the device; the trainer's shuffle and per-step seeds); the
    losses and each step's wall seconds."""
    from particle_fm_tpu_torch.training.trainer import step_seed

    dev = trainer.device
    gen = torch.Generator(dev)
    losses, secs, epoch = [], [], 0
    while len(losses) < n_steps:
        for batch in trainer._epoch_batches(data, epoch):
            gen.manual_seed(step_seed(trainer.seed, state.step))
            sync(torch, dev)
            t0 = time.perf_counter()
            losses.append(trainer.train_step(state, gen, *batch))
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            if len(losses) == n_steps:
                break
        epoch += 1
    return [float(l) for l in losses], secs


def train_setup(torch, model, dm, cfg, dev, lr: float = 1e-3):
    """A Trainer at a constant lr and a fresh TrainState from seed 0."""
    from particle_fm_tpu_torch.training.step import create_train_state, make_optimizer
    from particle_fm_tpu_torch.training.trainer import Trainer

    opt = make_optimizer(lr=lr, weight_decay=cfg["model"]["optimizer"]["weight_decay"],
                         grad_clip=cfg["trainer"]["grad_clip"])
    trainer = Trainer(model, dm, opt, seed=cfg["seed"], device=dev, verbose=False,
                      ema_decay=cfg["trainer"]["ema"]["decay"])
    return trainer, create_train_state(model, opt, seed=0, device=dev)


# bfloat16 training phases: float32 master weights, bfloat16 compute
TRAIN_TURN_STEPS = 8  # steps a turn of the batch-320 reading
BENCH_TRAIN_BATCH = 320  # bench.py's train batch


def float32_twin(torch, model, net, device):
    """The float32 model (dtype None) and a network of it holding `net`'s weights."""
    model32 = dataclasses.replace(model, dtype=None)
    net32 = model32.init(seed=0, device=device)
    net32.load_state_dict(net.state_dict())
    return model32, net32


def frob_pairs(a, b) -> float:
    """Frobenius norm of the difference of two lists of tensors, in float64."""
    return float(np.sqrt(sum(float(((x.double() - y.double()) ** 2).sum())
                             for x, y in zip(a, b, strict=True))))


def bf16_gate(torch, name: str, got, want, f32) -> dict:
    """Loss and gradients (pinned_loss_and_grads) of a bfloat16 computation
    against a bfloat16 reference, closer than the reference is to float32:
    |got - want| < |want - f32| on the loss and on all gradients as one
    vector; every gradient float32."""
    if not all(g.dtype == torch.float32 for g in got[1] + want[1]):
        fail(f"{name}: a gradient of a float32 parameter is not float32")
    loss = (abs(got[0] - want[0]), abs(want[0] - f32[0]))
    grads = (frob_pairs(got[1], want[1]), frob_pairs(want[1], f32[1]))
    if not (np.isfinite(got[0]) and loss[0] < loss[1] and grads[0] < grads[1]):
        fail(f"{name}: |bf16 - plain bf16| against |plain bf16 - float32|: loss {loss}, "
             f"gradients {grads}")
    return {"loss": got[0], "loss_vs_plain_bf16": loss[0], "plain_bf16_loss_vs_f32": loss[1],
            "grads_vs_plain_bf16_frobenius": grads[0],
            "plain_bf16_grads_vs_f32_frobenius": grads[1], "n_params": len(got[1])}


def agreement(torch, name: str, model, got, want, want32) -> dict:
    """`held_against` in float32; in bfloat16 `bf16_gate`, with `want32()`
    the same reference computed in float32."""
    if model.compute_dtype is None:
        return held_against(name, got, want)
    return bf16_gate(torch, name, got, want, want32())


def float32_state(torch, state) -> None:
    if not all(p.dtype == torch.float32 for p in [*state.params(), *state.ema_params]):
        fail("training: a parameter or EMA weight is not float32")


def train_epic_phase(torch, ops, dev, counted, overrides=()) -> dict:
    """fm_tops150_cond (with `overrides`, such as model.dtype=bfloat16): one
    step's loss and gradients on the card against the CPU (64 jets, pinned
    draws; `agreement`), then TRAIN_STEPS steps at constant lr 1e-3 that
    must lower the loss and launch no EPiC kernel (training runs the module
    path: the kernel is forward-only)."""
    model, dm, cfg = compose_training(["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
                                       *overrides])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    split = dm.train
    batch = [torch.from_numpy(a[:64]) for a in (split.x, split.mask, split.cond)]
    cpu_net = copy.deepcopy(state.net).cpu()
    card = pinned_loss_and_grads(torch, model, state.net, [a.to(dev) for a in batch], 5)
    cpu = pinned_loss_and_grads(torch, model, cpu_net, batch, 5)
    agree = agreement(torch, "train EPiC, card against CPU", model, card, cpu,
                      lambda: pinned_loss_and_grads(
                          torch, *float32_twin(torch, model, cpu_net, "cpu"), batch, 5))

    reset(counted)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = run_steps(torch, trainer, state, trainer._place_train_split(), TRAIN_STEPS)
    got = launched(counted)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if any(got.values()):
        fail(f"train EPiC: the train steps launched kernels {got} (expected none)")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (np.isfinite(losses).all() and last < first):
        fail(f"train EPiC: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    float32_state(torch, state)
    median = float(np.median(secs[5:]))
    return {"config": "fm_tops150_cond (configs/), synthetic JetNet-150, AdamW lr 1e-3 constant, "
                      "clip 0.5, EMA 0.999", "overrides": list(overrides), "batch": dm.batch_size,
            "train_jets": len(split), "steps": TRAIN_STEPS, "card_vs_cpu_64_jets": agree,
            "loss_first_5": first, "loss_last_5": last, "median_step_ms": 1e3 * median,
            "steps_per_s": 1.0 / median, "jets_per_s": dm.batch_size / median,
            "peak_memory_bytes": peak, "kernel_launches": got}


def bench_batch_turns(torch, dev) -> dict:
    """jets/s of fm_tops150_cond's train step at bench.py's batch 320,
    float32 and bfloat16 in turns (f32, bf16, bf16, f32), TRAIN_TURN_STEPS
    steps a turn after 3 of warm-up: the median step of each."""
    runs = {}
    for name, extra in (("float32", []), ("bfloat16", ["model.dtype=bfloat16"])):
        model, dm, cfg = compose_training(["experiment=jetnet/fm_tops150_cond",
                                           "data.synthetic=true",
                                           f"data.batch_size={BENCH_TRAIN_BATCH}", *extra])
        dm.setup()
        trainer, state = train_setup(torch, model, dm, cfg, dev)
        data = trainer._place_train_split()
        run_steps(torch, trainer, state, data, 3)
        runs[name] = (trainer, state, data, [])
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        trainer, state, data, secs = runs[name]
        losses, turn = run_steps(torch, trainer, state, data, TRAIN_TURN_STEPS)
        if not np.isfinite(losses).all():
            fail(f"train EPiC at batch {BENCH_TRAIN_BATCH}, {name}: non-finite loss {losses}")
        secs += turn
    ms = {name: 1e3 * float(np.median(r[3])) for name, r in runs.items()}
    return {"batch": BENCH_TRAIN_BATCH, "steps_per_turn": TRAIN_TURN_STEPS, "median_step_ms": ms,
            "jets_per_s": {k: BENCH_TRAIN_BATCH / (v / 1e3) for k, v in ms.items()},
            "step_s": {name: r[3] for name, r in runs.items()}}


def train_path_a_phase(torch, sa, dev, counted, overrides=()) -> dict:
    """fm_droid_transformer (attn_impl=packed, scores_dtype=null; with
    `overrides`, such as model.dtype=bfloat16) on the JetNet-150 cond data,
    every parameter re-drawn: one step's loss and gradients with the packed
    kernel (float32 or bf16, by the model's type) in the forward pass
    against the kernel replaced by its plain version (`_packed_forward`: the
    backward recomputes `packed_ref_math` either way), pinned draws, a full
    batch (`agreement`), then steps in turns (kernel, plain, plain, kernel),
    the kernel turns launching 3 packed kernels a step and no other."""
    model, dm, cfg = compose_training([
        "experiment=jetnet/fm_tops150_cond", "model=fm_droid_transformer", "data.synthetic=true",
        "model.net_config.te_config.mha_config.attn_impl=packed",
        "model.net_config.te_config.mha_config.scores_dtype=null", *overrides])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    redraw_parameters(torch, state.net, seed=4)
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.params()):
            e.copy_(p)
    wrapper = "packed_short_attention" if model.compute_dtype is None else \
        "packed_short_attention_bf16"

    def plain():
        return mock.patch.object(sa, "_packed_forward", sa.packed_short_attention_reference)

    def plain32():
        with plain():
            return pinned_loss_and_grads(torch, *float32_twin(torch, model, state.net, dev),
                                         batch, 6)

    split = dm.train
    batch = [torch.from_numpy(a[:dm.batch_size]).to(dev) for a in (split.x, split.mask, split.cond)]
    reset(counted)
    kernel = pinned_loss_and_grads(torch, model, state.net, batch, 6)
    want = {w.__name__: 0 for w in counted}
    want[wrapper] = 3 if dev.type == "cuda" else 0
    if launched(counted) != want:
        fail(f"train path A: one loss and its gradients launched {launched(counted)}, "
             f"expected {want}")
    with plain():
        reference = pinned_loss_and_grads(torch, model, state.net, batch, 6)
    agree = agreement(torch, "train path A, kernel against plain", model, kernel, reference,
                      plain32)

    per_turn = 4
    data = trainer._place_train_split()
    turns = {"kernel": [], "plain": []}
    peak = {"kernel": 0, "plain": 0}
    reset(counted)
    for path in ("kernel", "plain", "plain", "kernel"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with plain() if path == "plain" else contextlib.nullcontext():
            losses, secs = run_steps(torch, trainer, state, data, per_turn)
        if not np.isfinite(losses).all():
            fail(f"train path A: non-finite loss {losses}")
        turns[path] += secs
        if dev.type == "cuda":
            peak[path] = max(peak[path], torch.cuda.max_memory_allocated(dev))
    got = launched(counted)
    want[wrapper] = 3 * 2 * per_turn if dev.type == "cuda" else 0
    if got != want:
        fail(f"train path A: launches {got}, expected {want}")
    float32_state(torch, state)
    ms = {k: 1e3 * float(np.median(v)) for k, v in turns.items()}
    return {"config": "fm_droid_transformer (configs/) on fm_tops150_cond's data, attn_impl=packed, "
                      "scores_dtype=null, every parameter re-drawn, AdamW lr 1e-3 constant",
            "overrides": list(overrides), "batch": dm.batch_size, "kernel_vs_plain": agree,
            "steps_per_turn": per_turn, "median_step_ms": ms,
            "jets_per_s": {k: dm.batch_size / (v / 1e3) for k, v in ms.items()},
            "step_s": turns, "peak_memory_bytes": peak, "kernel_launches": got,
            "launches": got[wrapper]}


def float32_checkpoint(torch, path: Path) -> None:
    """Fail unless the checkpoint's parameters, EMA weights and AdamW
    moments are all float32."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    tensors = [*sd["params"].values(), *sd["ema_params"]]
    tensors += [v for s in sd["opt_state"]["state"].values() for v in s.values() if v.ndim]
    if not tensors or any(a.dtype != torch.float32 for a in tensors):
        fail(f"train CLI: {path.name} holds a tensor that is not float32")


def train_cli_phase(torch, ops, dev, counted, overrides=()) -> dict:
    """The training entry point on fm_tops150_cond with 4096 synthetic jets
    and trainer=smoke (and `overrides`, such as model.dtype=bfloat16): a
    finite val_loss, the `last` and best checkpoints with float32
    parameters, EMA weights and AdamW moments, a resume from `last` that
    continues at its step, then the EMA weights serve 7 jets at NFE 100 in
    the model's type with 6 x 100 launches of its EPiC kernel and no other:
    in float32 within PATH_TOL of the plain path; in bfloat16, after 4
    midpoint steps, the kernel path closer to the plain path than that is
    to float32."""
    import shutil

    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.serving import make_serve_fn, serve_batches

    out_root = ROOT / "build" / ("train_smoke" + "".join(f"_{o.split('=')[-1]}" for o in overrides))
    shutil.rmtree(out_root, ignore_errors=True)
    args = ["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
            "data.synthetic_num_jets=4096", "trainer=smoke", "callbacks=none", *overrides]
    t0 = time.perf_counter()
    metrics, objs = ptrain.main(args + [f"output_dir={out_root / 'first'}"])
    first_s = time.perf_counter() - t0
    trainer, out = objs["trainer"], objs["out_dir"]
    if not np.isfinite(metrics.get("val_loss", np.nan)):
        fail(f"train CLI: val_loss is not finite: {metrics}")
    last = Path(out) / "checkpoints" / "last.pt"
    best = sorted((Path(out) / "checkpoints" / "val_loss").glob("step_*_metric_*.pt"))
    if not last.exists() or len(best) != 1:
        fail(f"train CLI: checkpoints missing: last {last.exists()}, best {best}")
    for path in (last, best[0]):
        float32_checkpoint(torch, path)
    saved_step = trainer.state.step
    epochs = len(trainer.metrics_history)
    metrics2, objs2 = ptrain.main(args + [f"output_dir={out_root / 'resumed'}",
                                          f"trainer.max_epochs={epochs + 1}", f"ckpt_path={last}"])
    resumed = objs2["trainer"]
    per_epoch = saved_step // epochs
    if (resumed.metrics_history[0]["epoch"] != epochs
            or resumed.state.step != saved_step + per_epoch):
        fail(f"train CLI: the resume did not continue at step {saved_step} "
             f"({resumed.metrics_history}, step {resumed.state.step})")

    dm, model = objs2["datamodule"], objs2["model"]
    wrapper = "epic_layer" if model.compute_dtype is None else "epic_layer_bf16"
    net = resumed.state.ema_network()
    fn = make_serve_fn(model, net, batch_size=7, ode_steps=ODE_STEPS, has_cond=True,
                       has_mask=True, means=dm.means, stds=dm.stds)
    mask, cond = dm.test.mask[:7], dm.test.cond[:7]
    reset(counted)
    served = serve_batches(fn, fn.meta, 7, cond=cond, mask=mask, seed=3)
    got = launched(counted)
    want = {w.__name__: 0 for w in counted}
    want[wrapper] = model.layers * 2 * (ODE_STEPS - 1) if dev.type == "cuda" else 0
    if got != want:
        fail(f"train CLI: serving the EMA weights launched {got}, expected {want}")
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        plain = serve_batches(fn, fn.meta, 7, cond=cond, mask=mask, seed=3)
    err = float(np.abs(served - plain).max())
    if not np.isfinite(served).all():
        fail("train CLI: the served samples are not finite")
    if np.abs(served[mask[..., 0] == 0]).max(initial=0.0) != 0.0:
        fail("train CLI: padded rows of the served samples are not zero")
    ema_served = {"jets": 7, "ode_steps": ODE_STEPS, "launches": got,
                  "max_abs_diff_kernel_vs_plain": err}
    if model.compute_dtype is None:
        if err > PATH_TOL:
            fail(f"train CLI: the EMA weights served on the kernel path disagree with the "
                 f"plain path: {err}")
    else:
        m, c = (torch.from_numpy(a).to(dev) for a in (mask, cond))
        z = torch.randn(m.shape[0], model.num_particles, model.features,
                        generator=torch.Generator().manual_seed(3)).to(dev) * m
        k16 = model.integrate(net, z, c, m, "midpoint", BF16_CHECK_STEPS)
        with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
            p16 = model.integrate(net, z, c, m, "midpoint", BF16_CHECK_STEPS)
        model32, net32 = float32_twin(torch, model, net, dev)
        x32 = model32.integrate(net32, z, c, m, "midpoint", BF16_CHECK_STEPS)
        ours, theirs = frob((k16 - p16).cpu()), frob((p16 - x32).cpu())
        if not ours < theirs:
            fail(f"train CLI: the EMA weights' kernel path and plain path after 4 steps "
                 f"|{ours}| are not closer than plain bf16 is to float32 |{theirs}|")
        ema_served["four_steps"] = {"kernel_vs_plain_frobenius": ours,
                                    "plain_bf16_vs_f32_frobenius": theirs}
    return {"args": args, "val_loss": metrics["val_loss"], "train_loss": metrics["train_loss"],
            "steps_per_epoch": per_epoch, "saved_step": saved_step,
            "resumed_at_epoch": resumed.metrics_history[0]["epoch"],
            "step_after_resume": resumed.state.step, "first_run_s": first_s,
            "checkpoints": [str(last.relative_to(ROOT)), str(best[0].relative_to(ROOT))],
            "ema_served": ema_served, "launches": got[wrapper]}


# eval phase: the shipped JetNet callbacks in the training entry point, then
# the evaluation stages timed at 5,000 jets: some 40 s shorter than at
# 10,000, time that the later phases need under the run's limit
EVAL_JETS = 2000  # the callback's num_jet_samples: 2 batches of 1000
EVAL_TIMING_JETS = 5_000
EVAL_W1_TOL = 1e-3  # W1M and W1P, kernel path against plain path
EVAL_CPU_JETS = 256
EVAL_CPU_RTOL = 1e-4
EVAL_RNG_SEED = 7  # the bootstrap generator (eval/metrics.py::_rng), pinned alike on both paths


def eval_cli_phase(torch, ops, dev, counted) -> dict:
    """The training entry point on fm_tops150_cond with 4096 synthetic jets,
    trainer=smoke and the shipped `callbacks: jetnet` (generation_batch_size
    1000, midpoint, ode_steps 200, EMA weights, W1 over 40 bootstrap
    batches), evaluated every epoch from epoch 0 on EVAL_JETS jets, and
    `test: true`. Checks: finite w1m_mean/w1p_mean in every epoch's metrics;
    the test pass runs the callback once more, with `testing` set, on the
    restored best checkpoint; exactly 6 x 2 x 199 x ceil(EVAL_JETS / 1000) EPiC
    launches per evaluation pass and no other kernel.

    Then the same evaluation on the restored weights with `epic_layer`
    replaced by its plain version, the same seeds and the bootstrap generator
    pinned alike: the generated jets within PATH_TOL (1e-3) and W1M and W1P
    within EVAL_W1_TOL (1e-3) absolute. The bound for W1P is the path
    tolerance itself: with the bootstrap indices alike, each per-feature W1
    moves by at most the largest change of a particle feature. W1M moves by
    at most the mean change of a jet's mass, which for jets of 30 to 150
    particles and these widths is expected far below 1e-3; the limit stays
    1e-3 for both."""
    import shutil

    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.eval import metrics as pmetrics
    from particle_fm_tpu_torch.eval.callbacks import JetNetEvalCallback

    out_root = ROOT / "build" / "eval_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    args = ["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
            "data.synthetic_num_jets=4096", "trainer=smoke",
            "callbacks.jetnet_eval.every_n_epochs=1", "callbacks.jetnet_eval.log_epoch_zero=true",
            f"callbacks.jetnet_eval.num_jet_samples={EVAL_JETS}", f"output_dir={out_root}"]
    calls = []
    through = JetNetEvalCallback.__call__

    def recorded(cb, trainer):
        calls.append({"epoch": trainer.epoch, "testing": trainer.testing,
                      "step": trainer.state.step})
        return through(cb, trainer)

    reset(counted)
    t0 = time.perf_counter()
    with mock.patch.object(JetNetEvalCallback, "__call__", recorded):
        metrics, objs = ptrain.main(args)  # the main path
    cli_s = time.perf_counter() - t0
    got = launched(counted)
    trainer, model = objs["trainer"], objs["model"]
    (cb,) = trainer.callbacks
    if (cb.generation_batch_size, cb.ode_steps, cb.ode_solver, cb.use_ema) != (
            1000, 200, "midpoint", True):
        fail(f"eval CLI: the callback is not the shipped one: {cb}")
    history = trainer.metrics_history
    for m in history:
        if not all(np.isfinite(m.get(k, np.nan)) for k in ("w1m_mean", "w1p_mean")):
            fail(f"eval CLI: epoch {m['epoch']} logged no finite w1m_mean/w1p_mean: {m}")
    best = sorted((Path(objs["out_dir"]) / "checkpoints" / "val_loss").glob("step_*_metric_*.pt"))
    best_step = int(best[0].name.split("_")[1]) if len(best) == 1 else None
    want_calls = [{"epoch": m["epoch"], "testing": False, "step": None} for m in history] + [
        {"epoch": history[-1]["epoch"], "testing": True, "step": best_step}]
    got_calls = [dict(c, step=None) if not c["testing"] else c for c in calls]
    if best_step is None or got_calls != want_calls:
        fail(f"eval CLI: callback calls {calls}, expected {want_calls} (best checkpoint {best})")
    if trainer.state.step != best_step or "w1m_mean" not in metrics:
        fail(f"eval CLI: the test pass did not restore the best checkpoint or give metrics "
             f"(step {trainer.state.step}, best {best_step}, {metrics})")
    per_pass = model.layers * 2 * (cb.ode_steps - 1) * -(-EVAL_JETS // cb.generation_batch_size)
    want = {w.__name__: 0 for w in counted}
    want["epic_layer"] = len(calls) * per_pass if dev.type == "cuda" else 0
    if got != want:
        fail(f"eval CLI: launches {got}, expected {want}")

    # kernel path against plain path on the restored weights
    def evaluate():
        pmetrics._rng = np.random.default_rng(EVAL_RNG_SEED)
        real, gen, _ = cb._generate(trainer, EVAL_JETS)
        pmetrics._rng = np.random.default_rng(EVAL_RNG_SEED)
        w1 = pmetrics.calculate_all_wasserstein_metrics(
            real[:EVAL_JETS], gen, calculate_efps=False, device=dev, **cb.w1_kwargs)
        return gen, w1

    gen_k, w1_k = evaluate()
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        gen_p, w1_p = evaluate()
    gen_err = float(np.abs(gen_k - gen_p).max())
    w1_err = {k: abs(w1_k[k] - w1_p[k]) for k in ("w1m_mean", "w1p_mean")}
    if not (np.isfinite(gen_k).all() and gen_err <= PATH_TOL):
        fail(f"eval CLI: generated jets, kernel path against plain path: {gen_err}")
    if not all(e <= EVAL_W1_TOL for e in w1_err.values()):
        fail(f"eval CLI: W1, kernel path against plain path: {w1_err} (limit {EVAL_W1_TOL})")
    test_metrics = {k: v for k, v in metrics.items() if k.startswith(("w1", "generation"))}
    return {"args": args, "cli_s": cli_s, "epochs": len(history),
            "callback_calls": calls, "per_epoch_w1": [
                {k: m[k] for k in ("epoch", "w1m_mean", "w1p_mean")} for m in history],
            "test_metrics": test_metrics, "best_step": best_step,
            "launches_per_pass": per_pass, "passes": len(calls),
            "kernel_vs_plain": {"max_abs_diff_jets": gen_err, "w1_abs_diff": w1_err,
                                "w1_kernel": w1_k, "w1_plain": w1_p},
            "launches": got["epic_layer"], "trainer": trainer, "model": model,
            "datamodule": objs["datamodule"], "callback": cb}


def eval_timing_phase(torch, ops, dev, counted, cli: dict) -> dict:
    """The evaluation stages at EVAL_TIMING_JETS generated jets (the trained EMA weights of
    the eval CLI run, its test split's cond and masks tiled, batch 1000,
    midpoint, 200 steps) against as many synthetic test jets at N = 150, each
    timed on the host clock around work that ends on the host: generation
    (exact EPiC launches counted), EFPs and energy correlators on the card,
    the native clustering (tau1-3, d12/d23), and the bootstrap W1s. Then the
    EFPs and correlators on the card against the port's CPU path on the
    first EVAL_CPU_JETS jets (rtol 1e-4; EFPs of each EFP's largest
    magnitude)."""
    from particle_fm_tpu_torch.eval import metrics as pmetrics
    from particle_fm_tpu_torch.eval.callbacks import _tile_to, eval_network
    from particle_fm_tpu_torch.eval.efp import efps
    from particle_fm_tpu_torch.eval.generation import generate_data
    from particle_fm_tpu_torch.eval.substructure import ecfs, nsubjettiness
    from particle_fm_tpu_torch.native.binding import kt_split_scales

    n = EVAL_TIMING_JETS
    trainer, model, dm, cb = cli["trainer"], cli["model"], cli["datamodule"], cli["callback"]
    # test split = int(0.15 * jets) + 1 jets (the reference's len-1 split offsets)
    _, big, _ = compose_training(["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
                                  f"data.synthetic_num_jets={int(np.ceil(n / 0.15))}"])
    big.setup()
    real = big.tensor_test[:n]
    if len(real) != n:
        fail(f"eval timing: {len(real)} synthetic test jets, expected {n}")
    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        stages[name] = time.perf_counter() - t0
        return out

    net = eval_network(trainer, True)
    reset(counted)
    gen, gen_time = timed("generation_s", lambda: generate_data(
        model, net, n, batch_size=cb.generation_batch_size,
        cond=_tile_to(dm.tensor_conditioning_test, n), variable_set_sizes=True,
        mask=_tile_to(dm.mask_test, n), normalized_data=True, means=dm.means, stds=dm.stds,
        ode_solver=cb.ode_solver, ode_steps=cb.ode_steps, seed=cb.seed,
        num_points=int(real.shape[1]), device=dev))
    got = launched(counted)
    want = {w.__name__: 0 for w in counted}
    want["epic_layer"] = (model.layers * 2 * (cb.ode_steps - 1) * -(-n // cb.generation_batch_size)
                          if dev.type == "cuda" else 0)
    if got != want or not np.isfinite(gen).all() or gen.shape != real.shape:
        fail(f"eval timing: generation launched {got} (expected {want}), shape "
             f"{gen.shape}, finite {np.isfinite(gen).all()}")
    stages["generation_time_s"] = gen_time  # without the first batch

    e_real = timed("efps_real_s", lambda: efps(real, device=dev))
    e_gen = timed("efps_gen_s", lambda: efps(gen, device=dev))

    def parts(x):
        pt = x[..., 2] * (x[..., 2] > 0)
        return pt, x[..., 0], x[..., 1], (x[..., 2] > 0).astype(np.float64)

    ecf = {key: timed(f"ecfs_{key}_s", lambda x=x: ecfs(*parts(np.asarray(x, np.float64)),
                                                        device=dev))
           for key, x in (("real", real), ("gen", gen))}

    def cluster(x):
        pt, eta, phi, mask = parts(np.asarray(x, np.float64))
        return nsubjettiness(pt, eta, phi, mask), kt_split_scales(pt, eta, phi, R=0.8)

    clustered = {key: timed(f"clustering_{key}_s", lambda x=x: cluster(x))
                 for key, x in (("real", real), ("gen", gen))}
    # the W1s of calculate_all_wasserstein_metrics one by one, then tau21's
    pmetrics._rng = np.random.default_rng(EVAL_RNG_SEED)
    boot = (cb.w1_kwargs["num_eval_samples"], cb.w1_kwargs["num_batches"])
    w1m = timed("w1m_s", lambda: pmetrics.w1m(real, gen, *boot))
    w1p = timed("w1p_s", lambda: pmetrics.w1p(real, gen, None, None, *boot))
    w1efp = timed("w1efp_s", lambda: pmetrics.w1efp(real, gen, *boot, device=dev))
    tau21 = {key: c[0][1] / np.maximum(c[0][0], 1e-30) for key, c in clustered.items()}
    w1_tau21 = timed("w1_tau21_s", lambda: pmetrics.wasserstein_distance_batched(
        tau21["real"], tau21["gen"], n, 40))
    for key, x in (("e_real", e_real), ("e_gen", e_gen)):
        if not np.isfinite(x).all():
            fail(f"eval timing: {key} not finite")

    # card against the port's CPU path
    first = real[:EVAL_CPU_JETS]
    e_card, e_cpu = efps(first, device=dev), efps(first, device="cpu")
    efp_err = float((np.abs(e_card - e_cpu).max(0) / np.abs(e_cpu).max(0)).max())
    c_card = ecfs(*parts(np.asarray(first, np.float64)), device=dev)
    c_cpu = ecfs(*parts(np.asarray(first, np.float64)), device="cpu")
    ecf_err = max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in zip(c_card, c_cpu))
    if not (efp_err <= EVAL_CPU_RTOL and ecf_err <= EVAL_CPU_RTOL):
        fail(f"eval timing: card against CPU on {EVAL_CPU_JETS} jets: EFPs {efp_err}, "
             f"e2/e3 {ecf_err} (limit {EVAL_CPU_RTOL})")
    return {"jets": n, "real": f"synthetic JetNet-150 test split, {n} jets", "stages_s": stages,
            "generation_jets_per_s": n / stages["generation_s"], "launches": got,
            "w1": {"w1m": list(w1m), "w1p": [float(np.mean(w1p[0])), float(np.mean(w1p[1]))],
                   "w1efp": [float(np.mean(w1efp[0])), float(np.mean(w1efp[1]))],
                   "w1_tau21": list(w1_tau21)},
            "ecf_means": {k: [float(np.mean(a)) for a in v] for k, v in ecf.items()},
            "card_vs_cpu": {"jets": EVAL_CPU_JETS, "efp_err_over_largest": efp_err,
                            "e2_e3_rel_err": ecf_err}}


# phases of the other loss families and solvers: the PC-JeDi diffusion CLI
# (the full-width path of EM generation), droid, self-conditioning, OT-CFM,
# DOPRI5 and log_prob
FAMILY_JETS = 1000
FAMILY_TRAIN_STEPS = 8
LOG_PROB_TOL = 1e-3  # relative, card against CPU


def expect(name: str, got: dict, **want_of) -> None:
    """Fail unless the launches are `want_of` (by wrapper name) and 0 elsewhere."""
    want = {k: want_of.get(k, 0) for k in got}
    if got != want:
        fail(f"{name}: launches {got}, expected {want}")


def test_inputs(torch, dm, n: int, dev, cond: bool = True):
    """The test split's masks (and cond) tiled to n sets, on the card."""
    from particle_fm_tpu_torch.eval.callbacks import _tile_to

    mask = torch.from_numpy(_tile_to(dm.mask_test, n)).to(dev)
    c = torch.from_numpy(_tile_to(dm.tensor_conditioning_test, n)).to(dev) if cond else None
    return mask, c


def kernel_against_plain(torch, dev, name, owner, wrapper, sample, relative=False,
                         tol=PATH_TOL):
    """(kernel-path result, seconds, plain-path result, seconds, error): the
    same call with `owner.wrapper` replaced by its plain version; the error
    is absolute, or over the plain path's largest |x|, and at most `tol`."""
    sync(torch, dev)
    t0 = time.perf_counter()
    got = sample()
    sync(torch, dev)
    k_s = time.perf_counter() - t0
    with mock.patch.object(owner, wrapper, getattr(owner, wrapper + "_reference")):
        t0 = time.perf_counter()
        want = sample()
        sync(torch, dev)
        p_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    if relative:
        err /= float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        fail(f"{name}: kernel path against plain path: {err} (limit {tol}"
             f"{' of the largest |x|' if relative else ''})")
    return got, k_s, want, p_s, err


def diffusion_cli_phase(torch, ops, dev, counted) -> dict:
    """The slice's full-width main path: experiment=jetnet/diffusion_tops150_cond
    (PC-JeDi VP-diffusion on EPiC, Huber loss with the MLE weight) through
    the training entry point with 4096 synthetic jets, trainer=smoke (2
    epochs) and the shipped `callbacks: jetnet` of the experiment (em, 200
    steps, batch 1000, EMA weights), evaluated every epoch from epoch 0 on
    EVAL_JETS jets, and `test: true`: exactly 6 x 200 x 2 x 3 EPiC launches.
    Then 1000 jets by em (200 steps) and by ddim (100 steps) on the EMA
    weights, kernel path against plain path with the same generator, and one
    training step's loss and gradients, card against CPU (64 jets, pinned
    draws)."""
    import shutil

    from particle_fm_tpu_torch import train as ptrain

    out_root = ROOT / "build" / "diffusion_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    args = ["experiment=jetnet/diffusion_tops150_cond", "data.synthetic=true",
            "data.synthetic_num_jets=4096", "trainer=smoke", "trainer.max_epochs=2",
            "callbacks.jetnet_eval.every_n_epochs=1", "callbacks.jetnet_eval.log_epoch_zero=true",
            f"callbacks.jetnet_eval.num_jet_samples={EVAL_JETS}", f"output_dir={out_root}"]
    reset(counted)
    t0 = time.perf_counter()
    metrics, objs = ptrain.main(args)  # the main path
    cli_s = time.perf_counter() - t0
    got = launched(counted)
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    (cb,) = trainer.callbacks
    if (model.loss_type, model.criterion, cb.generation_batch_size, cb.ode_steps,
            cb.ode_solver, cb.use_ema) != ("diffusion", "huber", 1000, 200, "em", True):
        fail(f"diffusion CLI: not the shipped experiment: {model.loss_type}, {cb}")
    history = trainer.metrics_history
    for m in history + [metrics]:
        if not all(np.isfinite(m.get(k, np.nan)) for k in ("w1m_mean", "w1p_mean", "val_loss")):
            fail(f"diffusion CLI: no finite w1m_mean/w1p_mean/val_loss in {m}")
    passes = len(history) + 1  # every epoch, then the test pass
    per_pass = model.layers * cb.ode_steps * -(-EVAL_JETS // cb.generation_batch_size)
    expect("diffusion CLI", got, epic_layer=passes * per_pass)

    net = trainer.state.ema_network()
    mask, cond = test_inputs(torch, dm, FAMILY_JETS, dev)
    solvers = {}
    for solver, steps in (("em", 200), ("ddim", 100)):
        def sample(solver=solver, steps=steps):
            gen = torch.Generator(dev).manual_seed(11)
            return model.sample(net, gen, cond=cond, mask=mask, ode_solver=solver,
                                ode_steps=steps) * mask
        reset(counted)
        x, k_s, _, p_s, err = kernel_against_plain(torch, dev, f"diffusion {solver}", ops,
                                                   "epic_layer", sample)
        solvers[solver] = {"ode_steps": steps, "nfe": steps, "kernel_s": k_s, "plain_s": p_s,
                           "largest_abs_x": float(x.abs().max()),
                           "kernel_jets_per_s": FAMILY_JETS / k_s,
                           "plain_jets_per_s": FAMILY_JETS / p_s,
                           "max_abs_diff_kernel_vs_plain": err}

    split = dm.train
    batch = [torch.from_numpy(a[:64]) for a in (split.x, split.mask, split.cond)]
    card = pinned_loss_and_grads(torch, model, trainer.state.net, [a.to(dev) for a in batch], 5)
    cpu = pinned_loss_and_grads(torch, model, copy.deepcopy(trainer.state.net).cpu(), batch, 5)
    agree = held_against("diffusion train step, card against CPU", card, cpu)
    return {"args": args, "cli_s": cli_s, "epochs": len(history), "passes": passes,
            "launches_per_pass": per_pass, "launches": got["epic_layer"],
            "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "w1m_mean",
                                             "w1p_mean")} for m in history],
            "test_metrics": {k: v for k, v in metrics.items() if k.startswith("w1")},
            "sampling_1000_jets": solvers, "train_step_card_vs_cpu_64_jets": agree}


def family_train(torch, name, overrides, dev, counted, redraw_seed=None, **want):
    """Compose an experiment, take FAMILY_TRAIN_STEPS steps of the Trainer's
    step over its epoch batches (constant lr 1e-3) and check the launches."""
    model, dm, cfg = compose_training([*overrides, "data.synthetic=true"])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    if redraw_seed is not None:
        redraw_parameters(torch, state.net, seed=redraw_seed)
    data = trainer._place_train_split()
    reset(counted)
    losses, secs = run_steps(torch, trainer, state, data, FAMILY_TRAIN_STEPS)
    got = launched(counted)
    if not np.isfinite(losses).all():
        fail(f"{name}: non-finite training loss {losses}")
    expect(f"{name} training", got, **want)
    return model, dm, state, {"batch": dm.batch_size, "steps": FAMILY_TRAIN_STEPS,
                              "losses": losses, "median_step_ms": 1e3 * float(np.median(secs[2:])),
                              "launches": got}


def droid_phase(torch, sa, dev, counted) -> dict:
    """jetnet/droid_tops30 (PC-Droid, droid_t_max 25) on path A's network
    (attn_impl=packed, scores_dtype=null), every parameter re-drawn:
    FAMILY_TRAIN_STEPS steps with 3 packed launches each, then 1000 jets,
    midpoint, 100 steps from the 25 x N(0, 1) prior, kernel path against
    plain path within PATH_TOL of the largest |x|."""
    over = ["experiment=jetnet/droid_tops30",
            "model.net_config.te_config.mha_config.attn_impl=packed",
            "model.net_config.te_config.mha_config.scores_dtype=null"]
    model, dm, state, train = family_train(
        torch, "droid", over, dev, counted, redraw_seed=8,
        packed_short_attention=3 * FAMILY_TRAIN_STEPS)
    if (model.loss_type, model.droid_t_max) != ("droid", 25.0):
        fail(f"droid: not the shipped experiment ({model.loss_type}, {model.droid_t_max})")
    mask, cond = test_inputs(torch, dm, FAMILY_JETS, dev)
    steps = 100

    def sample():
        return model.sample(state.net, torch.Generator(dev).manual_seed(12), cond=cond,
                            mask=mask, ode_solver="midpoint", ode_steps=steps)
    reset(counted)
    x, k_s, _, p_s, err = kernel_against_plain(torch, dev, "droid", sa, "packed_short_attention",
                                               sample, relative=True)
    n_eval = 2 * (steps - 1)
    expect("droid sampling", launched(counted), packed_short_attention=3 * n_eval)
    return {"config": "jetnet/droid_tops30 (fm_droid_transformer, droid_t_max 25), attn_impl="
                      "packed, scores_dtype=null, every parameter re-drawn", "train": train,
            "sampling": {"jets": FAMILY_JETS, "ode_solver": "midpoint", "ode_steps": steps,
                         "nfe": n_eval, "kernel_s": k_s, "plain_s": p_s,
                         "kernel_jets_per_s": FAMILY_JETS / k_s,
                         "plain_jets_per_s": FAMILY_JETS / p_s, "largest_abs_x":
                             float(x.abs().max()), "diff_over_largest_kernel_vs_plain": err,
                         "launches": 3 * n_eval},
            "launches": train["launches"]["packed_short_attention"] + 3 * n_eval}


def self_cond_phase(torch, ops, dev, counted) -> dict:
    """jetnet/fm_selfcond_tops30 (CFM, self_cond, unconditional):
    FAMILY_TRAIN_STEPS steps on the module path (no launch), then 1000 jets
    through odeint_fixed_sc, midpoint, 200 steps (6 x 398 EPiC launches),
    kernel path against plain path."""
    model, dm, state, train = family_train(
        torch, "self-cond", ["experiment=jetnet/fm_selfcond_tops30"], dev, counted)
    if not model.self_cond or model.conditioned:
        fail("self-cond: not the shipped experiment")
    mask, _ = test_inputs(torch, dm, FAMILY_JETS, dev, cond=False)
    steps = 200

    def sample():
        return model.sample(state.net, torch.Generator(dev).manual_seed(13), mask=mask,
                            ode_solver="midpoint", ode_steps=steps)
    reset(counted)
    x, k_s, _, p_s, err = kernel_against_plain(torch, dev, "self-cond", ops, "epic_layer", sample)
    got = launched(counted)
    n_eval = 2 * (steps - 1)
    expect("self-cond sampling", got, epic_layer=model.layers * n_eval)
    return {"config": "jetnet/fm_selfcond_tops30 (CFM, self_cond, EPiC, N=30)", "train": train,
            "sampling": {"jets": FAMILY_JETS, "ode_solver": "midpoint (odeint_fixed_sc)",
                         "ode_steps": steps, "nfe": n_eval, "kernel_s": k_s, "plain_s": p_s,
                         "kernel_jets_per_s": FAMILY_JETS / k_s,
                         "plain_jets_per_s": FAMILY_JETS / p_s,
                         "max_abs_diff_kernel_vs_plain": err},
            "launches": got["epic_layer"]}


def ot_phase(torch, dev, counted) -> dict:
    """jetnet/ot_cfm_tops30 (CFM-OT): FAMILY_TRAIN_STEPS steps at batch 1024
    on the module path; the Sinkhorn plan and its hardening timed on one
    batch (CUDA events, the median of 5 after 2 of warm-up), and the pairing
    of that batch equal, card against CPU."""
    from particle_fm_tpu_torch.losses import ot as pot

    model, dm, state, train = family_train(
        torch, "OT-CFM", ["experiment=jetnet/ot_cfm_tops30"], dev, counted)
    if model.loss_type != "CFM-OT":
        fail("OT-CFM: not the shipped experiment")
    x1 = torch.from_numpy(dm.train.x[:dm.batch_size])
    x0 = torch.from_numpy(np.random.RandomState(4).randn(*x1.shape).astype(np.float32))
    cpu = pot.ot_pair_indices(x0, x1)
    card = pot.ot_pair_indices(x0.to(dev), x1.to(dev)).cpu()
    differ = int((card != cpu).any(dim=1).sum())
    if differ:
        fail(f"OT-CFM: the pairing of {differ} of {len(x1)} sets differs, card against CPU")

    cost = pot.pairwise_sq_dists(x0.to(dev), x1.to(dev))
    cost = cost / cost.amax(dim=(1, 2), keepdim=True)

    def event_ms(fn):
        times = []
        for i in range(7):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(a.elapsed_time(b))
        return out, float(np.median(times))

    plan, sinkhorn_ms = event_ms(lambda: pot.sinkhorn_plan(cost))
    _, greedy_ms = event_ms(lambda: pot.greedy_perm_from_plan(plan))
    return {"config": "jetnet/ot_cfm_tops30 (CFM-OT, sinkhorn reg 0.01, 50 iterations, EPiC, "
                      "N=30)", "train": train, "pairing_sets": len(x1),
            "pairing_card_vs_cpu": "equal", "sinkhorn_ms": sinkhorn_ms,
            "greedy_ms": greedy_ms, "launches": 0}


def dopri5_runs(torch, ops, dev, counted, model, net, mask, cond, solver, held=None):
    """The same DOPRI5 sample on the kernel path and the plain path:
    {path: (x, seconds, stats, launches)}. With `held` (a list), the kernel
    path runs once more, untimed, each launch computed by the plain layer on
    the same inputs as well, and the largest difference of each is appended."""
    runs = {}
    for path in ("kernel", "plain") + (("held",) if held is not None else ()):
        stats = []
        kernel = ops.epic_layer

        def checked(*args, **kwargs):
            out = kernel(*args, **kwargs)
            want = ops.epic_layer_reference(*args, **kwargs)
            held.append(torch.stack([(a - b).abs().max() for a, b in zip(out, want)]).max())
            return out

        checked.launches = 0  # the wrapper counts on the module's name, patched here

        patch = {"kernel": kernel, "plain": ops.epic_layer_reference, "held": checked}[path]
        reset(counted)
        sync(torch, dev)
        t0 = time.perf_counter()
        with mock.patch.object(ops, "epic_layer", patch):
            x = model.sample(net, torch.Generator(dev).manual_seed(14), cond=cond, mask=mask,
                             ode_solver=solver, stats=stats) * mask
        sync(torch, dev)
        secs = time.perf_counter() - t0
        (st,) = stats
        if not bool(torch.as_tensor(st["reached"]).all()):
            fail(f"{solver} ({path} path): did not reach t=0: {st}")
        runs[path] = (x, secs, st, launched(counted))
    if held is not None:
        held[:] = torch.stack(held).tolist()
    return runs


WITNESS_SETS = 64  # sets of the float64 per-set run, card against CPU


def same_decisions(torch, st, st_p):
    """Per set: whether two dopri5_per_sample runs accepted the same attempts
    and took the same number of them."""
    a, b = st["accepted"].cpu(), st_p["accepted"].cpu()
    rows = max(len(a), len(b))
    pad = lambda h: torch.cat([h, h.new_zeros((rows - len(h), h.shape[1]))])
    return (pad(a) == pad(b)).all(dim=0) & (st["steps"].cpu() == st_p["steps"].cpu())


def spread(torch, x, st, y, st_p) -> dict:
    """How far two dopri5_per_sample results lie apart, per set: on every
    set and on the sets with the same decisions."""
    same = same_decisions(torch, st, st_p)
    d = (x.double().cpu() - y.double().cpu()).abs().amax(dim=(1, 2))
    return {"sets": len(d), "sets_with_other_decisions": int((~same).sum()),
            "max_abs_diff": float(d.max()),
            "max_abs_diff_same_decisions": float(d[same].max()) if bool(same.any()) else None,
            "median_abs_diff_same_decisions": float(d[same].median()) if bool(same.any())
            else None}


def per_set_witnesses(torch, ops, dev, model, net, mask, cond, plain) -> dict:
    """Two runs of dopri5_per_sample by the plain layer beside the kernel
    path's: (1) the start moved by one float32 ulp on the card, shown: the
    spread that float32 rounding alone gives; (2) the solver in float64 on
    the card against the same on the CPU, on the first WITNESS_SETS sets,
    checked: the same decisions on every set and results within PATH_TOL, so
    per-set t, dt and accept masks are right on the card."""
    from particle_fm_tpu_torch.models.flow_matching import draw_noise

    def flow(net, z, cond, mask):
        stats = []
        with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
            x = model.integrate(net, z, cond, mask, "dopri5_per_sample", stats=stats) * mask
        return x, stats[0]

    z = draw_noise(torch.Generator(dev).manual_seed(14), (B, N, model.features), dev) * mask
    base = flow(net, z, cond, mask)
    if not torch.equal(base[0], plain[0]):
        fail("dopri5_per_sample: integrate from the drawn start differs from sample")
    ulp = torch.nextafter(z, torch.full_like(z, np.inf)) * mask
    moved = spread(torch, *flow(net, ulp, cond, mask), *base)

    def f64(device):
        t0 = time.perf_counter()
        args = [a[:WITNESS_SETS].to(device=device, dtype=torch.float64) for a in (z, cond, mask)]
        out = flow(copy.deepcopy(net).to(device=device, dtype=torch.float64), *args)
        return out, time.perf_counter() - t0

    (card, card_s), (cpu, cpu_s) = f64(dev), f64(torch.device("cpu"))
    held = spread(torch, *card, *cpu)
    if held["sets_with_other_decisions"] or held["max_abs_diff"] > PATH_TOL:
        fail(f"dopri5_per_sample in float64, card against CPU: {held} (the same decisions on "
             f"every set and within {PATH_TOL} expected)")
    return {"plain_start_moved_by_one_ulp": moved,
            "float64_card_vs_cpu": {**held, "card_s": card_s, "cpu_s": cpu_s}}


def dopri5_phase(torch, ops, dev, counted, model) -> dict:
    """The flagship's network (fm_tops150_cond, seeded random weights) at
    batch 640 by dopri5 (one step size for the batch) and dopri5_per_sample
    (one per set, one batched loop): steps, NFE, reached, exact EPiC launches
    (7 network passes a step, 6 layers), kernel path against plain path
    within PATH_TOL, sets/s. The check runs with the sincos time embedding
    (frequencies 6): with the flagship's cosine embedding (frequencies up to
    e^31) the field is a chaotic function of t in float32, and the kernel's
    rounding, through the error norm, moves every later step; that run is
    shown beside it (steps of both paths and their difference), unchecked.
    dopri5_per_sample reads each set's error norm over its own 450 values,
    and float32 rounding alone moves a set's step sizes and decisions: on
    this network a start moved by one ulp, on the plain layer, moves results
    by up to 2e-2 on the sets with the same decisions (4e-2 on all), the
    size by which the kernel and plain paths differ (H100 80GB HBM3, 700 W;
    tests/test_torch_samplers_adaptive.py holds the port's loop against the
    JAX loop on the same field). So on that path every EPiC
    launch of the kernel run is held against the plain layer on the same
    inputs (KERNEL_TOL, the kernel phase's limit), the solver is held in
    float64 card against CPU (`per_set_witnesses`), and the kernel and plain
    paths' results are shown beside the one-ulp spread."""
    import dataclasses

    rs = np.random.RandomState(9)
    mask = torch.from_numpy(ragged_mask(rs, B, N)[..., None]).to(dev)
    cond = torch.from_numpy(rs.randn(B, C).astype(np.float32)).to(dev)
    sincos = dataclasses.replace(model, t_emb="sincos", frequencies=6)
    net = sincos.init(seed=0, device=dev)
    out = {}
    for solver in ("dopri5", "dopri5_per_sample"):
        held = [] if solver == "dopri5_per_sample" else None
        runs = dopri5_runs(torch, ops, dev, counted, sincos, net, mask, cond, solver, held)
        (x, k_s, st, got), (x_p, p_s, st_p, _) = runs["kernel"], runs["plain"]
        per_set = torch.as_tensor(st["steps"]).float().reshape(-1)
        per_set_p = torch.as_tensor(st_p["steps"]).float().reshape(-1)
        if solver == "dopri5" and st["steps"] != st_p["steps"]:
            fail(f"dopri5: the kernel path took {st['steps']} steps, the plain path "
                 f"{st_p['steps']}")
        err = float((x - x_p).abs().max())
        if not bool(torch.isfinite(x).all() and torch.isfinite(x_p).all()):
            fail(f"{solver}: non-finite samples")
        if held is None and err > PATH_TOL:
            fail(f"{solver}: kernel path against plain path: {err} (limit {PATH_TOL})")
        if held is not None and not (len(held) == got["epic_layer"]
                                     and max(held) <= KERNEL_TOL):
            fail(f"{solver}: the kernel's {len(held)} launches against the plain layer on their "
                 f"inputs: {max(held, default=None)} (limit {KERNEL_TOL})")
        passes = st["steps"] if solver == "dopri5" else st["loops"]
        expect(solver, got, epic_layer=7 * model.layers * passes)
        out[solver] = {
            "kernel_vs_plain": None if held is None else spread(torch, x, st, x_p, st_p),
            "launches_held_against_plain": None if held is None else {
                "launches": len(held), "max_abs_err": max(held)},
            "witnesses": None if held is None else per_set_witnesses(
                torch, ops, dev, sincos, net, mask, cond, runs["plain"]),
            "steps_kernel": {"min": int(per_set.min()), "mean": float(per_set.mean()),
                             "max": int(per_set.max())},
            "steps_plain": {"min": int(per_set_p.min()), "mean": float(per_set_p.mean()),
                            "max": int(per_set_p.max())},
            "network_passes": 7 * passes, "nfe_per_set_mean": 7 * float(per_set.mean()),
            "reached": True, "kernel_s": k_s, "plain_s": p_s, "kernel_sets_per_s": B / k_s,
            "plain_sets_per_s": B / p_s, "max_abs_diff_kernel_vs_plain": err,
            "launches": got["epic_layer"]}
    cosine = dopri5_runs(torch, ops, dev, counted, model, model.init(seed=0, device=dev), mask,
                         cond, "dopri5")
    (x, k_s, st, got), (x_p, p_s, st_p, _) = cosine["kernel"], cosine["plain"]
    out["dopri5_cosine_unchecked"] = {
        "steps_kernel": st["steps"], "steps_plain": st_p["steps"], "kernel_s": k_s,
        "plain_s": p_s, "max_abs_diff_kernel_vs_plain": float((x - x_p).abs().max()),
        "launches": got["epic_layer"]}
    return {"config": "fm_tops150_cond's network (seeded random weights) with t_emb=sincos, "
                      "frequencies 6; rtol = atol = 1e-4", "batch": B, **out,
            "launches": sum(out[s]["launches"] for s in out)}


def log_prob_phase(torch, dev, counted, model) -> dict:
    """log_prob of the flagship (seeded random weights, unfolded: no kernel),
    Hutchinson with e from numpy, B=32, 20 steps (19 midpoint steps, jvp
    under vmap), card against CPU within LOG_PROB_TOL relative."""
    net = model.init(seed=0, device=dev)
    rs = np.random.RandomState(10)
    b = 32
    mask = ragged_mask(rs, b, N)[..., None]
    x = (rs.randn(b, N, 3) * mask).astype(np.float32)
    cond = rs.randn(b, C).astype(np.float32)
    eps = rs.randn(b, N, 3).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, cond, mask)]
    reset(counted)
    sync(torch, dev)
    t0 = time.perf_counter()
    card = model.log_prob(net, *[a.to(dev) for a in args], ode_steps=20, exact=False,
                          eps=torch.from_numpy(eps).to(dev)).cpu()
    card_s = time.perf_counter() - t0
    expect("log_prob", launched(counted))
    t0 = time.perf_counter()
    cpu = model.log_prob(copy.deepcopy(net).cpu(), *args, ode_steps=20, exact=False,
                         eps=torch.from_numpy(eps))
    cpu_s = time.perf_counter() - t0
    err = float((card - cpu).abs().max() / cpu.abs().max())
    if not (bool(torch.isfinite(card).all()) and err <= LOG_PROB_TOL):
        fail(f"log_prob: card against CPU {err} (limit {LOG_PROB_TOL} relative)")
    return {"config": "fm_tops150_cond (seeded random weights), Hutchinson, 20 steps",
            "sets": b, "card_s": card_s, "cpu_s": cpu_s, "rel_err_card_vs_cpu": err,
            "log_prob_mean": float(cpu.mean()), "launches": 0}


# dataset phases: the shipped LHCO, JetClass and CaloChallenge experiments at
# full width through the training entry point on synthetic data
GEN_REL_TOL = 1e-4  # kernel path against plain path, of the largest |x|
GEN_CHECK_STEPS = 10  # midpoint steps of the kernel-against-plain batch (18 evaluations)


def dataset_cli(torch, name, experiment, overrides, counted):
    """train.main on `experiment` with `overrides` (against the shipped
    config), with generate_data and the clusterer timed on the host clock
    (each ends on the host); returns (metrics, objects, seconds, launches,
    timings)."""
    import shutil

    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.eval import callbacks as pcb
    from particle_fm_tpu_torch.eval import lhco_utils

    out_root = ROOT / "build" / f"{name}_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    timings = {"generate_data_s": [], "sets": [], "cluster_data_s": [], "clustered_events": []}

    def timed(fn, seconds, counts, size):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            timings[seconds].append(time.perf_counter() - t0)
            timings[counts].append(size(args, kwargs))
            return out
        return run

    gen = timed(pcb.generate_data, "generate_data_s", "sets",
                lambda a, kw: kw.get("num_jet_samples", a[2] if len(a) > 2 else None))
    clu = timed(lhco_utils.cluster_data, "cluster_data_s", "clustered_events",
                lambda a, kw: len(a[0]))
    reset(counted)
    t0 = time.perf_counter()
    with mock.patch.object(pcb, "generate_data", gen), \
            mock.patch.object(lhco_utils, "cluster_data", clu):
        metrics, objs = ptrain.main([f"experiment={experiment}", *overrides,
                                     f"output_dir={out_root}"])  # the main path
    cli_s = time.perf_counter() - t0
    return metrics, objs, cli_s, launched(counted), timings


def finite_history(name, history, keys) -> None:
    for m in history:
        if not all(np.isfinite(m.get(k, np.nan)) for k in keys):
            fail(f"{name}: epoch {m.get('epoch')} logged no finite {keys}: {m}")


def generation_check(torch, ops, dev, counted, name, model, net, dm, n) -> dict:
    """One generated batch of n sets with the trained EMA weights (the test
    split's masks and cond tiled), midpoint, GEN_CHECK_STEPS steps: kernel
    path against plain path within GEN_REL_TOL of the largest |x|, and the
    exact launches of the kernel path."""
    mask, cond = test_inputs(torch, dm, n, dev)

    def sample():
        gen = torch.Generator(dev).manual_seed(11)
        return model.sample(net, gen, cond=cond, mask=mask, ode_solver="midpoint",
                            ode_steps=GEN_CHECK_STEPS) * mask

    reset(counted)
    x, k_s, _, p_s, err = kernel_against_plain(torch, dev, name, ops, "epic_layer", sample,
                                               relative=True, tol=GEN_REL_TOL)
    evals = 2 * (GEN_CHECK_STEPS - 1)
    expect(f"{name} (kernel against plain)", launched(counted), epic_layer=model.layers * evals)
    return {"sets": n, "shape": list(x.shape), "evaluations": evals,
            "kernel_ms_per_evaluation": 1e3 * k_s / evals,
            "plain_ms_per_evaluation": 1e3 * p_s / evals, "largest_abs_x": float(x.abs().max()),
            "max_abs_diff_over_largest": err, "limit": GEN_REL_TOL}


def eval_launches(cb, model, n) -> int:
    """EPiC launches of one callback pass: layers x evaluations x batches."""
    return model.layers * 2 * (cb.ode_steps - 1) * -(-n // cb.generation_batch_size)


def lhco_bigpc_phase(torch, ops, dev, counted) -> dict:
    """lhco/bigPC at its shipped width (EPiC, hidden and latent 256, 8 layers,
    cond 10 on both paths, both jets in one 558-particle cloud), batch 128,
    2 epochs, and the shipped lhco_eval and lhco_eval_sr (batch 2048, midpoint,
    ode_steps 50, EMA weights), which run once each, in the test pass, on
    2,048 sets of the test split and of its signal-region twin: exactly
    2 x 8 x 98 EPiC launches. Then one batch of 2,048 kernel against plain."""
    overrides = ["data.synthetic=true", "data.synthetic_num_events=4000",
                 # per jet: the synthetic events' two jets make the 558-particle cloud
                 "data.num_particles=279", "trainer.max_epochs=2",
                 "callbacks.lhco_eval.num_jet_samples=2048",
                 "callbacks.lhco_eval_sr.num_jet_samples=2048",
                 "callbacks.lhco_eval.w1_kwargs.num_batches=10",
                 "callbacks.lhco_eval_sr.w1_kwargs.num_batches=10"]
    metrics, objs, cli_s, got, timings = dataset_cli(torch, "lhco_bigpc", "lhco/bigPC",
                                                     overrides, counted)
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    cbs = trainer.callbacks
    if ((model.hidden_dim, model.latent, model.layers, model.num_particles)
            != (256, 256, 8, 558) or dm.train.x.shape[1] != 558
            or [(cb.split, cb.generation_batch_size, cb.ode_steps) for cb in cbs]
            != [("test", 2048, 50), ("test_sr", 2048, 50)]):
        fail(f"lhco/bigPC: not the shipped experiment: {model}, {cbs}, {dm.train.x.shape}")
    finite_history("lhco/bigPC", trainer.metrics_history, ("train_loss", "val_loss"))
    if not all(np.isfinite(metrics.get(k, np.nan)) for k in ("w1m_mean", "w1p_mean")):
        fail(f"lhco/bigPC: the test pass gave no finite W1: {metrics}")
    per_pass = eval_launches(cbs[0], model, 2048)
    expect("lhco/bigPC CLI", got, epic_layer=len(cbs) * per_pass)
    check = generation_check(torch, ops, dev, counted, "lhco/bigPC generation", model,
                             trainer.state.ema_network(), dm, 2048)
    return {"overrides": overrides, "cli_s": cli_s, "epochs": len(trainer.metrics_history),
            "steps_per_epoch": dm.steps_per_epoch, "train_events": len(dm.train),
            "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "epoch_time")}
                          for m in trainer.metrics_history],
            "test_metrics": {k: v for k, v in metrics.items() if k.startswith("w1")},
            "timings": timings, "launches_per_pass": per_pass, "passes": len(cbs),
            "launches": got["epic_layer"], "kernel_vs_plain_2048": check}


def lhco_whole_event_phase(torch, ops, dev, counted) -> dict:
    """lhco/whole_event at its shipped width (EPiC on flow_matching.yaml,
    560-particle events, cond mjj), batch 1024, 1 epoch, and the shipped
    whole-event callback (batch 2048, midpoint, ode_steps 50, EMA weights) in
    the test pass on 2,048 events (W1 over 10 bootstrap batches in place of
    40): anti-kt (R=1) clustering of 2,048 generated and 2,048 real events
    into their two leading jets, per-jet W1s and W1(mjj); exactly 6 x 98 EPiC
    launches."""
    overrides = ["data.synthetic=true", "data.synthetic_num_events=12000", "trainer.max_epochs=1",
                 "callbacks.lhco_whole_event_eval.num_jet_samples=2048",
                 "callbacks.lhco_whole_event_eval.w1_kwargs.num_batches=10"]
    metrics, objs, cli_s, got, timings = dataset_cli(torch, "lhco_whole_event", "lhco/whole_event",
                                                     overrides, counted)
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    (cb,) = trainer.callbacks
    if (model.num_particles, dm.train.x.shape[1], cb.generation_batch_size, cb.ode_steps) != (
            560, 560, 2048, 50) or len(dm.tensor_test) < 2048:
        fail(f"lhco/whole_event: not the shipped experiment or too few test events: {cb}, "
             f"{dm.train.x.shape}, {len(dm.tensor_test)} test events")
    finite_history("lhco/whole_event", trainer.metrics_history, ("train_loss", "val_loss"))
    keys = ("w1m_mean_x", "w1p_mean_x", "w1m_mean_y", "w1mass_jet_mean_x", "w1_mjj_mean")
    if not all(np.isfinite(metrics.get(k, np.nan)) for k in keys):
        fail(f"lhco/whole_event: the test pass gave no finite {keys}: {metrics}")
    if timings["clustered_events"] != [2048, 2048]:
        fail(f"lhco/whole_event: clustered {timings['clustered_events']} events")
    per_pass = eval_launches(cb, model, 2048)
    expect("lhco/whole_event CLI", got, epic_layer=per_pass)
    return {"overrides": overrides, "cli_s": cli_s, "steps_per_epoch": dm.steps_per_epoch,
            "train_events": len(dm.train), "test_metrics": {
                k: v for k, v in metrics.items() if k.startswith(("w1", "generation"))},
            "timings": timings, "launches": got["epic_layer"]}


def jetclass_cond_phase(torch, ops, dev, counted) -> dict:
    """jetclass/jetclass_cond at its shipped width (EPiC, 13 features, 128
    particles, hidden 300, latent 16, 20 layers, cond 12 on the global path
    only), batch 1024, on 4,096 synthetic train jets of all 10 types handed
    to the datamodule in memory (no h5 file), 2 epochs with the per-jet-type
    validation losses, and the shipped jetnet_eval with per_type_w1 (batch
    1000, midpoint, ode_steps 200) in the test pass on 1,000 jets: exactly
    20 x 398 EPiC launches. Then one batch of 1,000 kernel against plain."""
    overrides = ["data.synthetic=true", "data.synthetic_num_jets=4096",
                 "data.synthetic_num_particles=128", "trainer.max_epochs=2",
                 "callbacks.jetnet_eval.num_jet_samples=1000",
                 "callbacks.jetnet_eval.w1_kwargs.num_batches=10"]
    metrics, objs, cli_s, got, timings = dataset_cli(torch, "jetclass_cond",
                                                     "jetclass/jetclass_cond", overrides, counted)
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    (cb,) = trainer.callbacks
    if ((model.features, model.hidden_dim, model.latent, model.layers, model.global_cond_dim,
         model.local_cond_dim) != (13, 300, 16, 20, 12, 0) or dm.train.x.shape != (4096, 128, 13)
            or dm.batch_size != 1024 or not trainer.loss_per_jettype or not cb.per_type_w1
            or (cb.generation_batch_size, cb.ode_steps) != (1000, 200)):
        fail(f"jetclass_cond: not the shipped experiment: {model}, {cb}, {dm.train.x.shape}")
    types = [f"val_loss_{t}" for t in ("QCD", "Hbb", "Hcc", "Hgg", "H4q", "Hqql", "Zqq", "Wqq",
                                        "Tbqq", "Tbl")]
    finite_history("jetclass_cond", trainer.metrics_history[:1], ("val_loss", *types))
    finite_history("jetclass_cond", trainer.metrics_history, ("train_loss", "val_loss"))
    per_type = sorted(k for k in metrics if k.startswith("w1m_mean_"))
    if not np.isfinite(metrics.get("w1m_mean", np.nan)) or len(per_type) != 10:
        fail(f"jetclass_cond: the test pass gave no finite W1 or no per-type W1: {metrics}")
    per_pass = eval_launches(cb, model, 1000)
    expect("jetclass_cond CLI", got, epic_layer=per_pass)
    check = generation_check(torch, ops, dev, counted, "jetclass_cond generation", model,
                             trainer.state.ema_network(), dm, 1000)
    return {"overrides": overrides, "cli_s": cli_s, "steps_per_epoch": dm.steps_per_epoch,
            "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "epoch_time")}
                          for m in trainer.metrics_history],
            "val_loss_per_type_epoch_0": {k: trainer.metrics_history[0][k] for k in types},
            "test_metrics": {k: v for k, v in metrics.items() if k.startswith("w1")},
            "timings": timings, "launches": got["epic_layer"], "kernel_vs_plain_1000": check}


def streamed_epoch(torch, trainer, epoch: int) -> tuple[int, int, float]:
    """One epoch of the Trainer's streamed batches through its train step,
    synchronised once at the end: (steps, hits incl. padding, seconds)."""
    from particle_fm_tpu_torch.training.trainer import step_seed

    dev = trainer.device
    gen = torch.Generator(dev)
    steps = tokens = 0
    sync(torch, dev)
    t0 = time.perf_counter()
    for batch in trainer._epoch_batches(None, epoch):
        gen.manual_seed(step_seed(trainer.seed, trainer.state.step))
        trainer.train_step(trainer.state, gen, *batch)
        steps += 1
        tokens += batch[0].shape[0] * batch[0].shape[1]
    sync(torch, dev)
    return steps, tokens, time.perf_counter() - t0


CALO_SHOWERS = 2000  # 1,600 train, 200 val, 200 test
CALO_EVAL_SHOWERS = 64


def write_calo_showers(path: Path, n: int, seed: int) -> None:
    """n synthetic showers at the shipped 6,000-hit width (synthetic_calo:
    6000 x sqrt(E_inc / 1 TeV) hits, E_inc log-uniform 1 GeV..1 TeV, so 190
    to 6,000 hits) as the npz of ragged showers and incident energies that
    CaloChallengeDataModule reads from `dataset_file`."""
    from particle_fm_tpu_torch.data.synthetic import synthetic_calo

    x, mask, e_inc = synthetic_calo(n, 6000, seed=seed)
    showers = np.empty(n, dtype=object)
    for i in range(n):
        showers[i] = x[i][mask[i, :, 0] > 0]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, showers=showers, energies=e_inc[:, 0])


def calo_phase(torch, dev, counted) -> dict:
    """calo/mdma_calo at its shipped width (MDMA, hidden 256, 8 layers, 8
    heads of 32) and lengths: 2,000 synthetic showers of up to 6,000 hits
    from a file, batch 256 under the 400,000-hit budget (which binds: the
    long showers come in batches of 66 and up), bucketed host batches
    (multiples of 64) with the alpha rotation and the fitted scaler,
    streamed through the Trainer's prefetch worker, 2 epochs, and the
    shipped calo_eval (midpoint, ode_steps 100) in the test pass on 64 test
    showers in one batch of 64 (the shipped 256 padded to the split's 6,000
    hits would take 4 x the time). No kernel runs: `attention(impl="auto")`
    takes the einsum path (JAX's rule: Lk >= 1024 and a head dim that is a
    multiple of 128). Then one streamed epoch timed (synchronised at its
    end) and one under the profiler for the device's busy share."""
    from scripts.profile_torch_port import kernel_rows

    showers = ROOT / "build" / "calo_smoke_showers.npz"
    write_calo_showers(showers, CALO_SHOWERS, seed=7)
    overrides = [f"data.dataset_file={showers}", "trainer.max_epochs=2",
                 f"callbacks.calo_eval.num_showers={CALO_EVAL_SHOWERS}",
                 f"callbacks.calo_eval.generation_batch_size={CALO_EVAL_SHOWERS}"]
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics, objs, cli_s, got, timings = dataset_cli(torch, "calo", "calo/mdma_calo", overrides,
                                                     counted)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    (cb,) = trainer.callbacks
    net_cfg = model.net_config
    if ((net_cfg["hidden_dim"], net_cfg["layers"], net_cfg["num_heads"]) != (256, 8, 8)
            or dm.device_cacheable or trainer._maybe_cache_train_data() is not None
            or not dm.rotate_alpha or dm.scaler is None or dm.synthetic
            or (dm.batch_size, dm.max_tokens_per_batch, dm.max_hits) != (256, 400_000, 6000)
            or (cb.ode_solver, cb.ode_steps) != ("midpoint", 100)):
        fail(f"calo: not the shipped experiment on the streaming path: {net_cfg}, {dm}, {cb}")
    finite_history("calo", trainer.metrics_history, ("train_loss", "val_loss"))
    keys = ("features_E", "features_z", "features_alpha", "features_R", "w1p_mean")
    if not all(np.isfinite(metrics.get(k, np.nan)) for k in keys):
        fail(f"calo: the test pass gave no finite {keys}: {metrics}")
    if timings["sets"] != [CALO_EVAL_SHOWERS]:
        fail(f"calo: calo_eval generated {timings['sets']} showers")
    expect("calo CLI", got)  # every count 0
    masks = [b[1] for b in dm.train_batches(seed=99)]
    shapes, hits = [m.shape[:2] for m in masks], sum(int(m.sum()) for m in masks)
    padded = [n * length for n, length in shapes]
    if (max(length for _, length in shapes) != 6000 or max(padded) > 400_000
            or min(n for n, _ in shapes) >= 256):
        fail(f"calo: the batches are not at the shipped lengths under a binding budget: {shapes}")

    streamed_epoch(torch, trainer, 5)  # warm-up: every bucket length once
    steps, tokens, wall = streamed_epoch(torch, trainer, 6)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, profiled = streamed_epoch(torch, trainer, 6)
    device_ms = sum(r["device_ms"] for r in kernel_rows(prof))
    busy = device_ms / (1e3 * wall) if device_ms > 0 else None
    return {"overrides": overrides, "cli_s": cli_s, "steps_per_epoch": dm.steps_per_epoch,
            "train_showers": len(dm.train), "train_hits": hits,
            "batches": [list(map(int, sh)) for sh in sorted(shapes)],
            "kernels": "none: attention(impl='auto') takes the einsum path at 8 heads of 32 "
                       "(JAX's rule: Lk >= 1024 and head dim % 128 == 0)",
            "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "epoch_time")}
                          for m in trainer.metrics_history],
            "test_metrics": {k: v for k, v in metrics.items()
                             if k.startswith(("features", "w1", "weighted", "generation"))},
            "timings": timings, "launches": got, "train_peak_memory_gib": peak_gib,
            "streamed_epoch": {"steps": steps, "hits_with_padding": tokens, "wall_s": wall,
                               "ms_per_step": 1e3 * wall / steps,
                               "showers_per_s": len(dm.train) / wall,
                               "hits_per_s": hits / wall,
                               "profiled_wall_s": profiled, "device_ms": device_ms,
                               "device_busy_share": busy if busy is not None else "not measured"}}


# ---------------------------------------------------------------- classifier phases

CLASSIFIER_SETS = 4096  # real and generated sets of the EPiC classifier phase
CLASSIFIER_GEN_STEPS = 20  # the generator's midpoint steps
CLASSIFIER_GEN_BATCH = 1024
CLASSIFIER_PROB_TOL = 1e-4  # kernel against plain: probabilities, AUROC, logits over the largest
CLASSIFIER_GATE_SEEDS = (1, 2, 3)  # more training seeds, read for the bf16 gate's margin
CLASSIFIER_CHECK_JETS = 32  # the ParT and ParticleNet step, card against CPU
CLASSIFIER_STEP_TOL = 1e-4  # its loss (relative) and gradients (over the largest)


def shipped_model(name: str, **extra):
    """A model of configs/model/<name>.yaml, built by the port's instantiate
    with `extra` fields replaced (the optimizer and scheduler dropped)."""
    from particle_fm_tpu_torch.config.core import instantiate, load_config

    cfg = load_config(str(ROOT / "configs" / "model" / f"{name}.yaml"))
    return instantiate({k: v for k, v in {**cfg, **extra}.items()
                        if k not in ("optimizer", "scheduler")})


def timed_steps(torch, dev, trainer_module):
    """A patch of the Trainer's step factory that times every train step
    (synchronised on both sides), and the list of their seconds."""
    secs = []
    make = trainer_module.make_train_step

    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a):
            sync(torch, dev)
            t0 = time.perf_counter()
            out = step(*a)
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            return out
        return timed

    return mock.patch.object(trainer_module, "make_train_step", factory), secs


def median_step(secs, batch: int) -> dict:
    import statistics

    warm = secs[2:] or secs
    ms = 1e3 * statistics.median(warm)
    return {"steps": len(secs), "median_step_ms": ms, "jets_per_s": batch / ms * 1e3}


def classifier_epic_phase(torch, ops, dev, counted) -> dict:
    """The classifier test at its own shape: CLASSIFIER_SETS synthetic
    lhco/x_jet sets (279 particles, normalised; the datamodule's splits in
    turn) as the real sample, as many
    generated by a seeded-weight lhco/x_jet generator on the EPiC kernel
    (midpoint, CLASSIFIER_GEN_STEPS steps) as the generated one, in an
    in-memory GenVsRealDataModule; configs/model/epic_classifier.yaml at its
    widths (hidden 128, latent 10, 3 layers) trained 2 epochs at batch 256
    on the card (the module path: no launch); then the test split predicted
    on a folded copy (the fused EPiC layer, exactly 3 launches a batch) and
    on the unfolded network (the module path): every probability and the
    AUROC within CLASSIFIER_PROB_TOL, every logit within CLASSIFIER_PROB_TOL
    of the largest |logit|, timed in TURN_ROUNDS rounds of turns; then in
    bfloat16 on the same weights: exactly 3 epic_layer_bf16 launches a batch
    and none of epic_layer, and the kernel's logits closer to the plain bf16
    path than that is to float32, and within 2 bf16 ulps of the largest
    |logit|. The same bf16 readings are taken on networks trained from
    CLASSIFIER_GATE_SEEDS: the 2-ulp limit gated, the Frobenius ratio read
    to show its margin."""
    from particle_fm_tpu_torch.data.classifier import GenVsRealDataModule
    from particle_fm_tpu_torch.models.classifiers import binary_metrics
    from particle_fm_tpu_torch.training import trainer as ptrainer
    from particle_fm_tpu_torch.training.step import make_optimizer

    gen_model, xdm, _ = compose_training(["experiment=lhco/x_jet", "data.synthetic=true",
                                          "data.synthetic_num_events=12000"])
    xdm.setup()
    n = CLASSIFIER_SETS
    splits = (xdm.train, xdm.val, xdm.test)
    real, real_mask, real_cond = (np.concatenate([getattr(sp, k) for sp in splits])[:n]
                                  for k in ("x", "mask", "cond"))
    if len(real) < n:
        fail(f"classifier EPiC: the x_jet splits hold {len(real)} sets, not {n}")
    gen_net = gen_model.init(seed=0, device=dev)
    mask = torch.from_numpy(real_mask).to(dev)
    cond = torch.from_numpy(real_cond).to(dev)
    g = torch.Generator(dev).manual_seed(5)
    reset(counted)
    t0 = time.perf_counter()
    with torch.no_grad():
        gen = torch.cat([gen_model.sample(gen_net, g, cond=cond[i:i + CLASSIFIER_GEN_BATCH],
                                          mask=mask[i:i + CLASSIFIER_GEN_BATCH],
                                          ode_solver="midpoint", ode_steps=CLASSIFIER_GEN_STEPS)
                         * mask[i:i + CLASSIFIER_GEN_BATCH]
                         for i in range(0, n, CLASSIFIER_GEN_BATCH)])
    sync(torch, dev)
    gen_s = time.perf_counter() - t0
    gen_launches = launched(counted)
    expect("classifier EPiC (generation)", gen_launches, epic_layer=gen_model.layers * 2 * (
        CLASSIFIER_GEN_STEPS - 1) * -(-n // CLASSIFIER_GEN_BATCH))
    if not bool(torch.isfinite(gen).all()):
        fail("classifier EPiC: the generator gave non-finite sets")

    dm = GenVsRealDataModule(real=real, real_mask=real_mask, gen=gen.cpu().numpy(),
                             gen_mask=real_mask.copy(), batch_size=256)
    dm.setup()
    model = shipped_model("epic_classifier")
    if ((model.num_particles, model.features, model.net_config["hid_dim"],
         model.net_config["latent_dim"], model.net_config["equiv_layers"])
            != (279, 3, 128, 10, 3)):
        fail(f"classifier EPiC: not configs/model/epic_classifier.yaml: {model}")
    def train(seed, patch=contextlib.nullcontext()):
        with patch:
            trainer = ptrainer.Trainer(model, dm, make_optimizer(lr=1e-3, weight_decay=5e-5),
                                       max_epochs=2, seed=seed, device=dev, verbose=False)
        reset(counted)
        trainer.fit()
        expect("classifier EPiC (training runs the module path)", launched(counted))
        finite_history("classifier EPiC", trainer.metrics_history, ("train_loss", "val_loss"))
        return trainer

    patch, secs = timed_steps(torch, dev, ptrainer)
    trainer = train(12345, patch)
    net = trainer.state.net
    folded = model.inference_network(copy.deepcopy(net))
    batches = [(torch.as_tensor(x, device=dev), torch.as_tensor(m, device=dev))
               for x, m, _ in dm.test_batches()]
    labels = dm.test.cond

    def predict_all(m, nett):
        return torch.cat([m.predict(nett, x, mm) for x, mm in batches])

    def logits_all(m, nett):
        with torch.no_grad():
            return torch.cat([m.logits(nett, x, mm).float() for x, mm in batches])

    reset(counted)
    probs = predict_all(model, folded)  # the main path: the fused layer
    sync(torch, dev)
    got = launched(counted)
    expect("classifier EPiC (predict)", got, epic_layer=3 * len(batches))
    plain = predict_all(model, net)
    diff = float((probs - plain).abs().max())
    kernel_m = binary_metrics(probs.cpu().numpy(), labels)
    plain_m = binary_metrics(plain.cpu().numpy(), labels)
    k32, p32 = logits_all(model, folded), logits_all(model, net)
    logit_diff = float((k32 - p32).abs().max())
    logit_limit = CLASSIFIER_PROB_TOL * max(1.0, float(p32.abs().max()))
    spread = {"min": float(p32.min()), "max": float(p32.max()), "std": float(p32.std())}
    if not (diff <= CLASSIFIER_PROB_TOL
            and abs(kernel_m["auroc"] - plain_m["auroc"]) <= CLASSIFIER_PROB_TOL
            and logit_diff <= logit_limit):
        fail(f"classifier EPiC: kernel against plain: probabilities {diff}, AUROC "
             f"{kernel_m['auroc']} against {plain_m['auroc']} (limit {CLASSIFIER_PROB_TOL}); "
             f"logits {logit_diff} (limit {logit_limit}, spread {spread})")
    turns = median_in_turns(lambda: predict_all(model, folded), lambda: predict_all(model, net))

    model16 = dataclasses.replace(model, dtype="bfloat16")

    def bf16_reading(nett):
        """The bf16 kernel's launches and logits on a folded bf16 copy of
        `nett`, and the Frobenius gaps |kernel - plain bf16|, |plain bf16 -
        float32| and |kernel - float32|, with the largest |kernel - plain
        bf16| in bf16 ulps of the largest |logit|."""
        net16 = model16.init(seed=0, device=dev)
        net16.load_state_dict(nett.state_dict())
        folded16 = model16.inference_network(copy.deepcopy(net16))
        reset(counted)
        k16 = logits_all(model16, folded16)
        sync(torch, dev)
        got16 = launched(counted)
        p16, f32 = logits_all(model16, net16), logits_all(model, nett)
        gaps = {"kernel_vs_plain_bf16": float((k16 - p16).norm()),
                "plain_bf16_vs_f32": float((p16 - f32).norm()),
                "kernel_vs_f32": float((k16 - f32).norm()),
                "max_abs_kernel_vs_plain_bf16_ulps": float(
                    (k16 - p16).abs().max() / (2.0 ** -7 * f32.abs().max()))}
        gaps["ratio"] = gaps["kernel_vs_plain_bf16"] / gaps["plain_bf16_vs_f32"]
        return got16, k16, gaps

    got16, k16, gaps = bf16_reading(net)
    expect("classifier EPiC (predict, bf16)", got16, epic_layer_bf16=3 * len(batches))
    if not (bool(torch.isfinite(k16).all()) and gaps["ratio"] < 1):
        fail(f"classifier EPiC bf16: |kernel - plain bf16| {gaps['kernel_vs_plain_bf16']} "
             f"against |plain bf16 - float32| {gaps['plain_bf16_vs_f32']} (logits, Frobenius)")
    sweep = {seed: bf16_reading(train(seed).state.net)[2] for seed in CLASSIFIER_GATE_SEEDS}
    ulps = {"trained": gaps, **sweep}
    if any(g["max_abs_kernel_vs_plain_bf16_ulps"] > 2 for g in ulps.values()):
        fail(f"classifier EPiC bf16: kernel against plain bf16 beyond 2 bf16 ulps of the "
             f"largest |logit|: {ulps}")
    return {"config": "configs/model/epic_classifier.yaml (hidden 128, latent 10, 3 layers, "
            "279 particles, 3 features; seeded init)",
            "data": f"{n} synthetic lhco/x_jet sets against {n} generated by a seeded-weight "
            f"lhco/x_jet generator (midpoint, {CLASSIFIER_GEN_STEPS} steps)",
            "generation_s": gen_s, "generation_launches": gen_launches["epic_layer"],
            "train_split": len(dm.train), "test_split": len(dm.test), "batch": dm.batch_size,
            "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "epoch_time")}
                          for m in trainer.metrics_history],
            **median_step(secs, dm.batch_size), "accuracy": kernel_m["accuracy"],
            "auroc": kernel_m["auroc"], "auroc_plain": plain_m["auroc"],
            "max_abs_prob_diff": diff, "limit": CLASSIFIER_PROB_TOL,
            "max_abs_logit_diff": logit_diff, "logit_limit": logit_limit, "logit_spread": spread,
            "predict_launches": got["epic_layer"], "predict_batches": len(batches),
            "predict_ms_per_batch": turns["ms"] / len(batches),
            "predict_plain_ms_per_batch": turns["plain_ms"] / len(batches),
            "predict_turns_ms": turns["turns_ms"],
            "predict_launches_bf16": got16["epic_layer_bf16"],
            "bf16_logits": gaps, "bf16_logits_by_training_seed": sweep}


def classifier_step_on_cpu(torch, model, net, batch) -> dict:
    """One training step's loss and gradients on the card against the CPU
    from the same weights: the dropout masks drawn from one numpy stream on
    both sides, the CPU's kNN indices handed to the card (ParticleNet), whose
    own indices are counted where they differ."""
    from particle_fm_tpu_torch.nets import common as pcommon
    from particle_fm_tpu_torch.nets import particlenet as ppn

    knn = ppn.knn_indices
    cpu_idx, disagree = [], []

    def on_cpu(points, mask, k):
        cpu_idx.append(knn(points, mask, k))
        return cpu_idx[-1]

    def on_card(points, mask, k):
        own = knn(points, mask, k)
        want = cpu_idx[len(disagree)].to(own.device)
        real = mask[..., 0] > 0 if mask is not None else torch.ones_like(own[..., 0], dtype=bool)
        disagree.append(int(((own != want) & real[..., None]).sum()))
        return want

    def loss_and_grads(nett, dev, knn_fn):
        rs = np.random.RandomState(3)
        keep = lambda g, p, shape, d: torch.from_numpy(rs.rand(*shape) < p).to(d)
        args = [a.to(dev) for a in batch]
        with mock.patch.object(pcommon, "dropout_keep", keep), \
                mock.patch.object(ppn, "knn_indices", knn_fn):
            loss = model.loss(nett, torch.Generator(dev), *args, train=True)
            grads = torch.autograd.grad(loss, list(nett.parameters()))
        return float(loss.detach()), [g.detach().cpu() for g in grads]

    cpu_net = copy.deepcopy(net).cpu()
    want = loss_and_grads(cpu_net, torch.device("cpu"), on_cpu)
    got = loss_and_grads(net, next(net.parameters()).device, on_card)
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    scale = max(float(g.abs().max()) for g in want[1])
    grad_err = max(float((a - b).abs().max()) for a, b in zip(got[1], want[1])) / scale
    if not (loss_err <= CLASSIFIER_STEP_TOL and grad_err <= CLASSIFIER_STEP_TOL):
        fail(f"classifier step card against CPU: loss rel err {loss_err}, gradient err "
             f"{grad_err} of the largest (limit {CLASSIFIER_STEP_TOL})")
    out = {"jets": len(batch[0]), "loss": got[0], "loss_rel_err": loss_err,
           "grad_err_over_largest": grad_err, "limit": CLASSIFIER_STEP_TOL}
    if disagree:
        real = int(batch[1].sum()) * cpu_idx[0].shape[-1]
        out["knn_index_disagreements_card_vs_cpu"] = {
            "per_block": disagree, "real_query_neighbour_slots_per_block": real}
    return out


def classifier_cli_phase(torch, dev, counted, name: str, experiment: str, overrides: list,
                         step_check: bool = True) -> dict:
    """train.main on a JetClass classifier experiment at its shipped width on
    the synthetic gen/sim pair (one flavour the pair has): the steps timed,
    the peak memory, accuracy and AUROC of every epoch and the test pass;
    then (`step_check`) one step's loss and gradients on the card against the
    CPU on CLASSIFIER_CHECK_JETS train jets."""
    import shutil

    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.training import trainer as ptrainer

    out_root = ROOT / "build" / f"{name}_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    patch, secs = timed_steps(torch, dev, ptrainer)
    reset(counted)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with patch:
        metrics, objs = ptrain.main([f"experiment={experiment}", *overrides,
                                     f"output_dir={out_root}"])  # the main path
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    expect(f"{name} CLI (no TPU kernel on this path)", launched(counted))
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    finite_history(name, trainer.metrics_history, ("train_loss", "val_loss", "accuracy", "auroc"))
    if not 0.0 <= metrics.get("auroc", np.nan) <= 1.0:
        fail(f"{name}: the test pass gave no AUROC: {metrics}")
    out = {"overrides": overrides, "cli_s": cli_s, "train_split": len(dm.train),
           "batch": dm.batch_size, **median_step(secs, dm.batch_size),
           "peak_memory_bytes": peak,
           "per_epoch": [{k: m[k] for k in ("epoch", "train_loss", "val_loss", "accuracy",
                                           "auroc")} for m in trainer.metrics_history],
           "test_metrics": {k: metrics[k] for k in ("accuracy", "auroc")}}
    if step_check:
        split = dm.train
        k = CLASSIFIER_CHECK_JETS
        batch = [torch.as_tensor(a[:k]) for a in (split.x, split.mask, split.cond)]
        out["one_step_card_vs_cpu"] = classifier_step_on_cpu(torch, model, trainer.state.net,
                                                              batch)
    return out


def classifier_phases(torch, dev, counted) -> dict:
    """ParT (jetclass_classifier), ParticleNet (jetclass_classifier_particlenet)
    and the HL-MLP (jetclass_classifier_hl) through train.main at their
    shipped widths; none reaches a TPU kernel's counterpart."""
    synthetic = ["data.synthetic=true", "data.synthetic_num_particles=128", "data.used_flavor=QCD",
                 "trainer=smoke", "trainer.max_epochs=2"]
    no_kernel = ("no kernel: the classifier's attention takes its pair bias on the einsum "
                 "path (impl=auto), as in the JAX package; no TPU kernel on this path")
    part = classifier_cli_phase(torch, dev, counted, "jetclass_classifier",
                                "jetclass_classifier",
                                synthetic + ["data.synthetic_num_jets=6000"])
    pnet = classifier_cli_phase(torch, dev, counted, "jetclass_classifier_particlenet",
                                "jetclass_classifier_particlenet",
                                synthetic + ["data.synthetic_num_jets=6000"])
    hl = classifier_cli_phase(torch, dev, counted, "jetclass_classifier_hl",
                              "jetclass_classifier_hl", synthetic, step_check=False)
    return {"classifier ParT (jetclass_classifier)": {"kernel": None, "note": no_kernel, **part},
            "classifier ParticleNet (jetclass_classifier_particlenet)": {
                "kernel": None, "note": "no kernel: kNN EdgeConv in PyTorch; no TPU kernel on "
                "this path", **pnet},
            "classifier HL (jetclass_classifier_hl)": {"kernel": None, **hl}}


# slice 16: the flat models, the LHCO chain, the MoE transformer, gaussian time and normaliser
SLICE_CHECK_STEPS = 4  # train steps of the card-against-CPU checks
SLICE_CPU_BATCH = 256  # sets a step there
SLICE_TRAIN_STEPS = 8  # timed train steps of the MoE transformer, each type
STEP_LOSS_RTOL = 1e-4
CHAIN_EVENTS = 2048
CHAIN_BATCH = 1024
CHAIN_ODE_STEPS = 100  # 198 evaluations
NORM_STEPS = 20
NORM_MAX_N = 1_000_000  # real particles before the normalisers freeze: some 8 batches
NORM_STATS_TOL = 1e-5  # of each statistic's largest magnitude, card against CPU


def pinned_steps(torch, model, net, batches, where, seed, lr=1e-3):
    """`len(batches)` steps of the port's train step from a copy of `net` on
    `where` with a fresh AdamW at constant lr, t and the noise pinned to
    numpy draws from `seed`; (losses, the network after them)."""
    from particle_fm_tpu_torch.losses import flow_matching as ploss
    from particle_fm_tpu_torch.training.step import (TrainState, _build_step_fn,
                                                     make_optimizer)

    rs = np.random.RandomState(seed)
    net = copy.deepcopy(net).to(where)
    opt = make_optimizer(lr=lr)
    params = list(net.parameters())
    state = TrainState(net=net, ema_params=[p.detach().clone() for p in params],
                       opt_state=opt.init(params))
    step = _build_step_fn(model, opt)
    losses = []
    for batch in batches:
        x = batch[0]
        t = torch.from_numpy(rs.rand(x.shape[0]).astype(np.float32)).to(where)
        z = torch.from_numpy(rs.randn(*x.shape).astype(np.float32)).to(where)
        with mock.patch.multiple(ploss, _sample_t=lambda g, b, d: t, _normal=lambda g, s, d: z):
            losses.append(float(step(state, torch.Generator(where),
                                     *[None if a is None else a.to(where) for a in batch])))
    return losses, net


def params_gap(torch, a, b) -> float:
    """Largest |difference| of two networks' parameters and buffers over the largest |value|."""
    sa, sb = a.state_dict(), b.state_dict()
    scale = max(float(v.float().abs().max()) for v in sb.values() if v.numel())
    return max(float((sa[k].float().cpu() - sb[k].float().cpu()).abs().max())
               for k in sb if sb[k].numel()) / scale


def cpu_expert_choice(torch):
    """Patches of nets/moe.py::expert_choice: (record, replay, moved). Under
    `record` the CPU's choices are kept; under `replay` the card takes them
    in the same order, and `moved` gets, call by call, the number of tokens
    the card's own choice would have routed otherwise (a choice is discrete:
    scores that nearly tie at the C-th place fall either way on the last
    bits)."""
    from particle_fm_tpu_torch.nets import moe as pmoe

    choice, kept, moved = pmoe.expert_choice, [], []

    def on_cpu(scores, c):
        kept.append(choice(scores, c))
        return kept[-1]

    def on_card(scores, c):
        own, want = choice(scores, c), kept[len(moved)].to(scores.device)
        picked = [torch.nn.functional.one_hot(i, scores.shape[-1]).sum(-2) for i in (own, want)]
        moved.append(int((picked[0] != picked[1]).sum()) // 2)
        return want

    return (mock.patch.object(pmoe, "expert_choice", on_cpu),
            mock.patch.object(pmoe, "expert_choice", on_card), moved)


def card_against_cpu_steps(torch, name, model, net, batches, dev, seed) -> dict:
    """SLICE_CHECK_STEPS pinned steps on the CPU and on the card from the
    same weights, the card on the CPU's expert choices where the network
    routes (the MoE): every step's loss within STEP_LOSS_RTOL relative."""
    record, replay, moved = cpu_expert_choice(torch)
    with record:
        cpu, cpu_net = pinned_steps(torch, model, net, batches, torch.device("cpu"), seed)
    with replay:
        card, card_net = pinned_steps(torch, model, net, batches, dev, seed)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if not (np.isfinite(card).all() and rel <= STEP_LOSS_RTOL):
        fail(f"{name}: {len(batches)} steps, card against CPU, losses {card} vs {cpu} "
             f"(rel {rel}, limit {STEP_LOSS_RTOL})")
    return {"steps": len(batches), "sets_a_step": int(batches[0][0].shape[0]),
            "losses_card": card, "losses_cpu": cpu, "max_loss_rel_err": rel,
            "params_gap_over_largest": params_gap(torch, card_net, cpu_net),
            **({"tokens_the_card_would_route_otherwise": moved} if moved else {}),
            "_cpu_net": cpu_net, "_card_net": card_net}


def split_batches(torch, split, n: int, b: int):
    """The first n batches of b sets of a split, as CPU tensors (x, mask, cond)."""
    return [tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a[i * b:(i + 1) * b]))
                  for a in (split.x, split.mask, split.cond)) for i in range(n)]


def flat_cli(torch, dev, counted, name, experiment, overrides):
    """train.main on a flat experiment with every train step timed; the
    run's objects, seconds, launches (none: the flat MLP has no kernel) and
    the median step."""
    from particle_fm_tpu_torch.training import trainer as ptrainer

    patch, secs = timed_steps(torch, dev, ptrainer)
    with patch:
        metrics, objs, cli_s, got, _ = dataset_cli(torch, name, experiment, overrides, counted)
    expect(f"{experiment} CLI", got)
    trainer = objs["trainer"]
    finite_history(experiment, trainer.metrics_history, ("train_loss", "val_loss"))
    return metrics, objs, cli_s, got, median_step(secs, trainer.datamodule.batch_size)


def jet_features_phase(torch, dev, counted) -> dict:
    """lhco/jet_features (LHCO stage 1: the flat model on 10 dijet features,
    cond mjj) through train.main, trainer=smoke (2 epochs at batch 1024) on
    20,000 synthetic events, and the shipped FlatEvalCallback in the test
    pass (EMA weights, ode_steps 100, batch 1024) on the whole test split;
    finite W1s; then SLICE_CHECK_STEPS steps card against CPU. The run
    directory is stage 1 of the chain phase."""
    from particle_fm_tpu_torch.eval.callbacks import FlatEvalCallback
    from particle_fm_tpu_torch.models.flow_matching_flat import FlatFlowMatchingModel

    overrides = ["data.synthetic=true", "data.synthetic_num_events=20000", "trainer=smoke"]
    metrics, objs, cli_s, got, step = flat_cli(torch, dev, counted, "lhco_jet_features",
                                               "lhco/jet_features", overrides)
    trainer, model, dm = objs["trainer"], objs["model"], objs["datamodule"]
    (cb,) = trainer.callbacks
    if (not isinstance(model, FlatFlowMatchingModel) or type(cb) is not FlatEvalCallback
            or (model.features, model.cond_dim, cb.ode_steps, cb.generation_batch_size)
            != (10, 1, 100, 1024) or dm.batch_size != 1024):
        fail(f"lhco/jet_features: not the shipped experiment: {model}, {cb}")
    keys = [f"w1_feature_{f}_mean" for f in range(10)] + ["w1_features_mean"]
    if not (all(np.isfinite(metrics.get(k, np.nan)) for k in keys)
            and metrics.get("generation_time", 0) > 0):
        fail(f"lhco/jet_features: the test pass gave no finite W1s or no time: {metrics}")
    check = card_against_cpu_steps(torch, "lhco/jet_features", model, model.init(device=dev),
                                   split_batches(torch, dm.train, SLICE_CHECK_STEPS, 1024), dev, 21)
    return {"overrides": overrides, "cli_s": cli_s, "train_events": len(dm.train),
            "test_vectors": len(dm.tensor_test), "train_step": step,
            "generation_time_s": metrics["generation_time"],
            "generated": min(cb.num_samples, len(dm.tensor_test)),
            "test_metrics": {k: metrics[k] for k in keys},
            "card_vs_cpu": {k: v for k, v in check.items() if not k.startswith("_")},
            "launches": 0, "_run_dir": objs["out_dir"]}


def gen_challenge_phase(torch, dev, counted) -> dict:
    """gen_challenge/gen_challenge through train.main on the synthetic folds
    (4,000 events), trainer=smoke and 2 epochs (the experiment's 500 cut),
    both shipped callbacks (sideband `val` and signal-region `val_sr`, ode
    steps 200, EMA weights) at epoch 0 and in the test pass with their plots
    off; finite W1s of both, whether matplotlib imports here."""
    import importlib.util

    overrides = ["data.synthetic=true", "trainer=smoke", "trainer.max_epochs=2",
                 "callbacks.gen_challenge_eval.make_plots=false",
                 "callbacks.gen_challenge_eval_sr.make_plots=false"]
    metrics, objs, cli_s, got, step = flat_cli(torch, dev, counted, "gen_challenge",
                                               "gen_challenge/gen_challenge", overrides)
    trainer, dm = objs["trainer"], objs["datamodule"]
    cbs = trainer.callbacks
    if [(cb.split, cb.metric_prefix, cb.ode_steps, cb.make_plots) for cb in cbs] != [
            ("val", "", 200, False), ("val_sr", "sr_", 200, False)]:
        fail(f"gen_challenge: not the shipped callbacks: {cbs}")
    keys = [f"{p}w1_{f}_mean" for p in ("", "sr_")
            for f in ("mj1", "delta_mj", "tau41_j1", "tau41_j2", "features")]
    if not all(np.isfinite(metrics.get(k, np.nan)) for k in keys):
        fail(f"gen_challenge: the test pass gave no finite W1s: {metrics}")
    return {"overrides": overrides, "cli_s": cli_s, "train_events": len(dm.train),
            "train_step": step, "matplotlib_imports": importlib.util.find_spec("matplotlib")
            is not None, "test_metrics": {k: metrics[k] for k in keys},
            "generation_time_s": {p: metrics[f"{p}generation_time"] for p in ("", "sr_")},
            "launches": 0}


def lhco_chain_phase(torch, ops, dev, counted, stage1_dir: str) -> dict:
    """The LHCO two-stage chain (particle_fm_tpu_torch/lhco_chain.py) in
    memory: stage 1 the jet_features run loaded from its directory (best
    checkpoint, EMA weights), stage 2 lhco/x_jet and lhco/y_jet at their
    shipped width (EPiC, 279 particles, hidden 128, 6 layers, cond 4 on both
    paths) with seeded weights on their synthetic datamodules; CHAIN_EVENTS
    events at batch CHAIN_BATCH, midpoint, CHAIN_ODE_STEPS steps, anti-kt
    reclustered: exactly 6 x 198 x 2 x 2 EPiC launches; then the same chain
    with the plain EPiC layer: the constituents of both jets within PATH_TOL."""
    from particle_fm_tpu_torch import lhco_chain

    stage1 = lhco_chain.load_stage(stage1_dir, device=dev)
    stages = []
    for seed, experiment in ((0, "lhco/x_jet"), (1, "lhco/y_jet")):
        model, dm, _ = compose_training([f"experiment={experiment}", "data.synthetic=true"])
        dm.setup()
        if (model.num_particles, model.hidden_dim, model.layers, model.global_cond_dim,
                model.local_cond_dim) != (279, 128, 6, 4, 4):
            fail(f"LHCO chain: {experiment} is not at its shipped width: {model}")
        stages.append(lhco_chain.Stage(model, model.init(seed=seed, device=dev), dm))

    def run():
        sync(torch, dev)
        t0 = time.perf_counter()
        out = lhco_chain.generate_lhco_events(stage1, *stages, n_samples=CHAIN_EVENTS,
                                              ode_steps=CHAIN_ODE_STEPS, batch_size=CHAIN_BATCH,
                                              recluster=True)
        return out, time.perf_counter() - t0

    reset(counted)
    (payload, timings), secs = run()  # the main path
    got = launched(counted)
    evals = 2 * (CHAIN_ODE_STEPS - 1)
    n_batches = -(-CHAIN_EVENTS // CHAIN_BATCH)
    expect("LHCO chain", got, epic_layer=stages[0].model.layers * evals * n_batches * 2)
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        (plain, plain_timings), plain_secs = run()
    for k in ("mask", "mask_y", "jet_features", "mjj_cond"):
        if not np.array_equal(payload[k], plain[k]):
            fail(f"LHCO chain: {k} differs between the kernel and the plain run")
    errs = {k: float(np.abs(payload[k] - plain[k]).max()) for k in ("constituents",
                                                                    "constituents_y")}
    for k in ("constituents", "constituents_y"):
        m = payload["mask" if k == "constituents" else "mask_y"]
        if not (np.isfinite(payload[k]).all() and errs[k] <= PATH_TOL
                and np.abs(payload[k][m[..., 0] == 0]).max(initial=0.0) == 0.0):
            fail(f"LHCO chain: {k} not finite, padding not zero, or kernel against plain "
                 f"{errs[k]} (limit {PATH_TOL})")
    if payload["clustered_jets"].shape != (CHAIN_EVENTS, 2, 4):
        fail(f"LHCO chain: clustered jets of shape {payload['clustered_jets'].shape}")
    return {"config": "stage 1: the lhco/jet_features run above; stage 2: lhco/x_jet and "
                      "lhco/y_jet (seeded weights), recluster", "events": CHAIN_EVENTS,
            "batch": CHAIN_BATCH, "ode_steps": CHAIN_ODE_STEPS, "evaluations": evals,
            "kernel_s": secs, "plain_s": plain_secs, "kernel_timings": timings,
            "plain_timings": plain_timings, "max_abs_diff_kernel_vs_plain": errs,
            "limit": PATH_TOL, "mean_multiplicity": {
                "x": float(payload["mask"].sum(axis=(1, 2)).mean()),
                "y": float(payload["mask_y"].sum(axis=(1, 2)).mean())},
            "launches": got["epic_layer"]}


def moe_transformer_phase(torch, sa, dev, counted) -> dict:
    """jetnet/fm_moe_transformer at its shipped width (model_dim 128, 3
    layers, 2 heads of 64, 4 experts of 256, capacity 15 of 30 tokens; the
    einsum attention with bf16 scores, as shipped) on 8,192 synthetic
    JetNet-30 jets, every parameter re-drawn: SLICE_CHECK_STEPS steps card
    against CPU (SLICE_CPU_BATCH sets) in float32 and, in bfloat16, one
    step's loss and gradients on the card closer to the CPU's bfloat16 than
    that is to float32 (`bf16_gate`; the 4 bf16 steps read beside, ungated);
    in both the card takes the CPU's expert choices and counts where its own
    differ; SLICE_TRAIN_STEPS steps at
    batch 1024 in each type (no kernel launch); then the float32 EMA weights
    served with attn_impl=packed, scores_dtype=null (path A's setting) at
    batch 1024, NFE 100, float32 and bfloat16 (serving_phase,
    bf16_serving_phase): 3 packed launches an evaluation, 300 a batch."""
    base = ["experiment=jetnet/fm_moe_transformer", "data.synthetic=true",
            "data.synthetic_num_jets=8192"]
    model, dm, cfg = compose_training(base)
    dm.setup()
    te = model.net_config["te_config"]
    if (te["model_dim"], te["num_layers"], te["mha_config"]["num_heads"], te["moe_config"],
            model.num_particles, dm.batch_size) != (128, 3, 2, dict(
                num_experts=4, hddn_dim=256, capacity_factor=2.0), 30, 1024):
        fail(f"MoE transformer: not the shipped experiment: {model.net_config}")
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    redraw_parameters(torch, state.net, seed=13)
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.params()):
            e.copy_(p)
    start = copy.deepcopy(state.net)
    batches = split_batches(torch, dm.train, SLICE_CHECK_STEPS, SLICE_CPU_BATCH)
    f32 = card_against_cpu_steps(torch, "MoE transformer", model, start, batches, dev, 31)
    model16 = dataclasses.replace(model, dtype="bfloat16")
    net16 = model16.init(device=dev)
    net16.load_state_dict(start.state_dict())
    # bf16: one step's loss and gradients gated (bf16_gate), the card on the CPU's
    # expert choice (its own counted where it differs: a choice is discrete, and
    # bf16 rounding moves near-tied scores across the C-th place); over 4 AdamW
    # steps the entries with gradients near 0 move by +-lr on the sign of their
    # rounding, so the 4-step readings are printed, not gated
    cpu = torch.device("cpu")
    first = list(batches[0])
    record, replay, moved = cpu_expert_choice(torch)
    with record:
        cpu16 = pinned_loss_and_grads(torch, model16, copy.deepcopy(net16).to(cpu), first, 31)
    with replay:
        card16 = pinned_loss_and_grads(torch, model16, net16,
                                       [None if a is None else a.to(dev) for a in first], 31)
    gate16 = bf16_gate(torch, "MoE transformer bf16, card against CPU", card16, cpu16,
                       pinned_loss_and_grads(torch, model, copy.deepcopy(start).to(cpu), first,
                                             31))
    gate16["tokens_the_card_would_route_otherwise"] = {
        "per_layer": moved, "slots_per_layer": SLICE_CPU_BATCH * 4 * 15}
    card16, card16_net = pinned_steps(torch, model16, net16, batches, dev, 31)
    cpu16, cpu16_net = pinned_steps(torch, model16, net16, batches, cpu, 31)
    if not np.isfinite(card16).all():
        fail(f"MoE transformer bf16: non-finite losses {card16}")
    gap = (frob(np.subtract(card16, cpu16)), frob(np.subtract(cpu16, f32["losses_cpu"])))
    pgap = (params_gap(torch, card16_net, cpu16_net), params_gap(torch, cpu16_net,
                                                                 f32["_cpu_net"]))

    data = trainer._place_train_split()
    timed = {}
    for name, tr, st in (("float32", trainer, state),
                         ("bfloat16", *train_setup(torch, model16, dm, cfg, dev))):
        if name == "bfloat16":
            st.net.load_state_dict(start.state_dict())
        reset(counted)
        losses, secs = run_steps(torch, tr, st, data, SLICE_TRAIN_STEPS)
        expect(f"MoE transformer training ({name})", launched(counted))
        if not np.isfinite(losses).all():
            fail(f"MoE transformer ({name}): non-finite loss {losses}")
        timed[name] = {"losses": losses, "median_step_ms": 1e3 * float(np.median(secs[2:])),
                       "jets_per_s": dm.batch_size / float(np.median(secs[2:]))}

    served, _, _ = compose_training(base + [
        "model.net_config.te_config.mha_config.attn_impl=packed",
        "model.net_config.te_config.mha_config.scores_dtype=null"])
    net = served.init(device=dev)
    net.load_state_dict(state.ema_network().state_dict())
    run = dict(name="MoE transformer", config="jetnet/fm_moe_transformer, attn_impl=packed, "
               "scores_dtype=null, the EMA weights of the float32 run (every parameter "
               "re-drawn before it)", model=served, net=net, wrapper_owner=sa,
               wrapper_name="packed_short_attention", launches_per_eval=3,
               requests=(1024, 7), batch=1024, mask_lo=10)
    serving = serving_phase(torch, dev, counted=counted, **run)
    serving16 = bf16_serving_phase(torch, dev, counted=counted, f32=serving, **run)
    return {"card_vs_cpu_f32": {k: v for k, v in f32.items() if not k.startswith("_")},
            "card_vs_cpu_bf16_one_step": gate16,
            "card_vs_cpu_bf16_4_steps_read": {"losses_card": card16, "losses_cpu": cpu16,
                                              "loss_gap_vs_cpu_bf16_to_f32": gap,
                                              "params_gap_vs_cpu_bf16_to_f32": pgap},
            "train_batch_1024": timed,
            "serving": {k: v for k, v in serving.items() if not k.startswith("_")},
            "serving_bf16": serving16, "launches": serving["launches"],
            "launches_bf16": serving16["launches"]}


def gaussian_normaliser_phase(torch, ops, dev, counted) -> dict:
    """fm_tops150_cond with model.t_emb=gaussian model.use_normaliser=true
    (max_n NORM_MAX_N) on synthetic JetNet-150: NORM_STEPS train steps at
    batch 1024 (no kernel launch), the feature statistics fitted, updated and
    frozen within them; the statistics of both normalisers against the CPU's updates
    from the same batches within NORM_STATS_TOL of each statistic's largest
    magnitude; then 1,024 jets from the EMA weights (the folded route takes
    the gaussian embedding), NFE 100, on the EPiC kernel against the plain
    layer within PATH_TOL, with exactly 6 x 100 launches."""
    # max_n 1,000,000 in place of the config's 2,000, which the first batch of 1024
    # jets (some 128,000 particles) passes: the fit, then Welford updates, then frozen
    model, dm, cfg = compose_training(["experiment=jetnet/fm_tops150_cond", "data.synthetic=true",
                                       "model.t_emb=gaussian", "model.use_normaliser=true",
                                       f"model.normaliser_config.max_n={NORM_MAX_N}"])
    dm.setup()
    trainer, state = train_setup(torch, model, dm, cfg, dev)
    cpu_net = copy.deepcopy(state.net).cpu()
    w0 = state.net.flows[0].gfp.W.detach().clone()
    data = trainer._place_train_split()
    from particle_fm_tpu_torch.training.trainer import step_seed

    gen, seen, losses, secs, epoch = torch.Generator(dev), [], [], [], 0
    reset(counted)
    while len(losses) < NORM_STEPS:
        for batch in trainer._epoch_batches(data, epoch):
            gen.manual_seed(step_seed(trainer.seed, state.step))
            seen.append([a.cpu() for a in batch])
            sync(torch, dev)
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(state, gen, *batch)))
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            if len(losses) == NORM_STEPS:
                break
        epoch += 1
    expect("gaussian + normaliser training", launched(counted))
    if not np.isfinite(losses).all():
        fail(f"gaussian + normaliser: non-finite loss {losses}")
    for x, m, c in seen:
        cpu_net.normalise(x, m, update_stats=True)
        cpu_net.normalise_cond(c, update_stats=True)
    stats = {}
    for name in ("normaliser", "ctxt_normaliser"):
        for leaf in ("means", "m2", "vars", "n"):
            card = getattr(getattr(state.net, name), leaf).cpu()
            cpu = getattr(getattr(cpu_net, name), leaf)
            stats[f"{name}.{leaf}"] = float((card - cpu).abs().max() / cpu.abs().max())
    want_n = 0.0
    for _, m, _ in seen:  # the counts of the batches before the statistics froze
        want_n += float(m.sum()) if want_n < NORM_MAX_N else 0.0
    updates = sum(1 for i in range(len(seen)) if sum(float(m.sum()) for _, m, _ in seen[:i])
                  < NORM_MAX_N)
    if max(stats.values()) > NORM_STATS_TOL or float(state.net.normaliser.n) != want_n or not (
            1 < updates < NORM_STEPS):
        fail(f"gaussian + normaliser: statistics card against CPU {stats} (limit "
             f"{NORM_STATS_TOL}), n {float(state.net.normaliser.n)} (expected {want_n}), "
             f"{updates} updates")
    w_shrink = float((1 - state.net.flows[0].gfp.W.detach() / w0).abs().max())

    mask, cond = test_inputs(torch, dm, 1024, dev)
    ema = state.ema_network()

    def sample():
        return model.sample(ema, torch.Generator(dev).manual_seed(17), cond=cond, mask=mask,
                            ode_solver="midpoint", ode_steps=ODE_STEPS)

    reset(counted)
    x, k_s, _, p_s, err = kernel_against_plain(torch, dev, "gaussian + normaliser", ops,
                                               "epic_layer", sample)
    n_eval = 2 * (ODE_STEPS - 1)
    expect("gaussian + normaliser sampling", launched(counted), epic_layer=model.layers * n_eval)
    return {"config": "fm_tops150_cond, model.t_emb=gaussian, model.use_normaliser=true, "
                      f"model.normaliser_config.max_n={NORM_MAX_N}", "steps": NORM_STEPS, "losses": losses,
            "median_step_ms": 1e3 * float(np.median(secs[2:])),
            "stats_card_vs_cpu_over_largest": stats, "limit": NORM_STATS_TOL,
            "normaliser_n": float(state.net.normaliser.n), "max_n": NORM_MAX_N,
            "updates_before_frozen": updates,
            "gaussian_W_largest_relative_change": w_shrink,
            "sampling": {"jets": 1024, "nfe": n_eval, "kernel_s": k_s, "plain_s": p_s,
                         "max_abs_diff_kernel_vs_plain": err, "largest_abs_x":
                             float(x.abs().max())},
            "launches": model.layers * n_eval}


def slice16_phases(torch, ops, sa, dev, counted) -> dict:
    """The five phases of the flat models, the LHCO chain, the MoE
    transformer and the gaussian time with normaliser training, in order;
    {path: result}, each printed as it ends."""
    out = {}

    def run(path, fn):
        t1 = time.perf_counter()
        res = fn()
        print(json.dumps({"slice16": path, "phase_s": time.perf_counter() - t1,
                          **{k: v for k, v in res.items() if not k.startswith("_")}}),
              flush=True)
        out[path] = res
        return res

    flat = run("lhco/jet_features CLI", lambda: jet_features_phase(torch, dev, counted))
    run("gen_challenge CLI", lambda: gen_challenge_phase(torch, dev, counted))
    run("LHCO two-stage chain", lambda: lhco_chain_phase(torch, ops, dev, counted,
                                                          flat["_run_dir"]))
    run("fm_moe_transformer", lambda: moe_transformer_phase(torch, sa, dev, counted))
    run("flagship, gaussian time + normaliser",
        lambda: gaussian_normaliser_phase(torch, ops, dev, counted))
    return out


# slice 17: the kernels as custom ops, the served artifact, its HTTP server,
# ReFlow and consistency distillation
SLICE17_DIR = ROOT / "build" / "slice17"
ARTIFACT_BATCHES = 8  # batches of a sets/s reading, behind one sync
ARTIFACT_TURNS = 2  # rounds of artifact, live, live, artifact readings
ATTENTION_STEPS = 2  # euler ode_steps of the attention artifacts: one evaluation
REFLOW_PAIRS = 4096
REFLOW_BATCH = 1024
DIRECT_STEPS = 20
DIRECT_BATCH = 256
CONSISTENCY_BATCH = 1024
STUDENT_STEPS = 5  # euler ode_steps of the served reflow student: 4 evaluations
HTTP_JETS = 1000
# what a loader process runs: the artifact loaded with no model code, one batch,
# the launches counted there
LOADER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from particle_fm_tpu_torch import serving
from particle_fm_tpu_torch.ops import epic_layer as ops
t0 = time.perf_counter()
fn, meta = serving.load_exported(sys.argv[2])
load_s = time.perf_counter() - t0
req = np.load(sys.argv[3])
ops.epic_layer.launches = ops.epic_layer_bf16.launches = 0
x = fn(int(req["seed"]), req["cond"], req["mask"])
torch.cuda.synchronize()
np.save(sys.argv[4], x.cpu().numpy())
model_code = sorted(m for m in sys.modules if m.startswith(tuple(
    "particle_fm_tpu_torch." + p for p in ("models", "nets", "config", "training"))))
print(json.dumps({"load_s": load_s, "model_modules": model_code,
                  "launches": {"epic_layer": ops.epic_layer.launches,
                               "epic_layer_bf16": ops.epic_layer_bf16.launches}}))
"""


def op_nodes(exported) -> dict:
    """The custom-op nodes of an exported program, its loop's graphs included,
    by op, and the program's nodes in all."""
    ops_, total = {}, 0
    for gm in exported.graph_module.modules():
        if hasattr(gm, "graph"):
            for node in gm.graph.nodes:
                total += 1
                name = str(node.target)
                if node.op == "call_function" and name.startswith("particle_fm."):
                    key = name.split(".")[1]
                    ops_[key] = ops_.get(key, 0) + 1
    return {"op_nodes": ops_, "graph_nodes": total}


def export_worker(job_path: str) -> None:
    """Export one artifact (a job `start_exports` wrote): the model from its
    fields and weights, `export_sampler` timed; prints one JSON line."""
    import torch

    sys.path.insert(0, str(ROOT))
    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
    from particle_fm_tpu_torch.serving import ARTIFACT_NAME, export_sampler

    job = torch.load(job_path, weights_only=False)
    model = FlowMatchingModel(**job["fields"])
    net = model.init(seed=0, device=job["device"])
    net.load_state_dict(job["state"])
    t0 = time.perf_counter()
    exported, _ = export_sampler(model, net, **job["kwargs"], out_dir=job["out_dir"])
    secs = time.perf_counter() - t0
    print(json.dumps({"export_s": secs, "bytes": (Path(job["out_dir"]) / ARTIFACT_NAME).stat()
                      .st_size, **op_nodes(exported)}), flush=True)


def start_exports(torch, jobs: dict) -> dict:
    """Write each job (the model's fields, its weights, export_sampler's
    arguments) and start one exporting process for each, all together:
    tracing is host work, and the card's machine has cores to spare."""
    procs = {}
    for name, (model, net, kwargs) in jobs.items():
        out = SLICE17_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
        torch.save({"fields": fields, "state": net.state_dict(), "kwargs": kwargs,
                    "out_dir": str(out / "exported"),
                    "device": str(next(net.parameters()).device)},
                   out / "job.pt")
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                f"chip_smoke.export_worker({str(out / 'job.pt')!r})")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    return procs


def finish_exports(procs: dict) -> dict:
    """Wait for every exporting process; {name: its JSON line}."""
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"exporting {name} failed ({proc.returncode}):\n{stderr[-4000:]}")
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def opcheck_phase(torch, ops, dev) -> dict:
    """torch.library.opcheck of the eight custom ops (and the bfloat16 flash
    op's class-token route) at small shapes on the card, each in its type:
    schema, fake implementation, autograd registration, AOT dispatch."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    b, n, h, lat, t, c = 4, 16, 32, 8, 4, 2
    mask = torch.ones(b, n, device=dev)
    mask[0, 10:] = 0
    epic = [r(b, n, h), r(b, lat), mask, r(b, t + c), r(t + 2 * h + lat + c, h, scale=0.1), r(h),
            r(t + h + c, lat, scale=0.1), r(lat), r(h, h, scale=0.1), r(t + lat + c, h, scale=0.1),
            r(h), r(h, h, scale=0.1), r(t + c, h, scale=0.1), r(h)]
    dims = (0.01, t, t, c, c)
    e16 = [a if i == 2 else a.to(torch.bfloat16) for i, a in enumerate(epic)]
    image = ops.bf16_weight_image(e16[4], e16[6], e16[9], e16[12], e16[8], e16[11])
    q, k, v = r(b, n, 2, 16), r(b, n, 2, 16), r(b, n, 2, 16)
    bias = r(b, 2, n, n)
    b16 = [x.to(torch.bfloat16) for x in (q, k, v)]
    tq, tk, tv = r(b, 1, 2, 128), r(b, 600, 2, 128), r(b, 600, 2, 128)
    pf = torch.ops.particle_fm
    cases = {
        "epic_layer": (pf.epic_layer, (*epic, *dims)),
        "epic_layer_bf16": (pf.epic_layer_bf16, (*e16, *dims, image)),
        "packed_short_attention": (pf.packed_short_attention, (q, k, v, mask, bias)),
        "packed_short_attention_bf16": (pf.packed_short_attention_bf16, (*b16, mask, None)),
        "fused_short_attention": (pf.fused_short_attention, (q, k, v, mask, bias)),
        "fused_short_attention_bf16": (pf.fused_short_attention_bf16, (*b16, mask, None)),
        "flash_masked_attention": (pf.flash_masked_attention, (q, k, v, mask)),
        "flash_masked_attention_bf16": (pf.flash_masked_attention_bf16, (*b16, mask)),
        "flash_masked_attention_bf16 (class token)": (
            pf.flash_masked_attention_bf16,
            (*(x.to(torch.bfloat16) for x in (tq, tk, tv)), torch.ones(b, 600, device=dev))),
    }
    out = {}
    for name, (op, args) in cases.items():
        t0 = time.perf_counter()
        try:
            torch.library.opcheck(op, args)
        except Exception as e:  # noqa: BLE001 (report which op, then fail)
            fail(f"opcheck of {name}: {type(e).__name__}: {e}")
        out[name] = {"passed": True, "s": time.perf_counter() - t0}
    return out


def artifact_inputs(model, batch: int, seed: int):
    """(seed, cond, mask) numpy request of one batch: ragged masks, cond
    where the model takes one."""
    rs = np.random.RandomState(seed)
    mask = ragged_mask(rs, batch, model.num_particles, min(30, model.num_particles))[..., None]
    cond = rs.randn(batch, model.global_cond_dim).astype(np.float32)
    return 1000 + seed, cond, mask


def twin(model, net, dtype, dev):
    """The model and a network with the same weights in `dtype` (None: the
    float32 ones themselves)."""
    if dtype is None:
        return model, net
    model16 = dataclasses.replace(model, dtype=dtype)
    net16 = model16.init(seed=0, device=dev)
    net16.load_state_dict(net.state_dict())
    return model16, net16


def check_artifact(torch, dev, name, model, net, art, counted, counter, per_batch, proto,
                   steps, solver, seed) -> dict:
    """The artifact loaded in this process against make_serve_fn on the same
    weights and request: bit for bit, exactly `per_batch` launches of
    `counter` and none of another kernel."""
    from particle_fm_tpu_torch.serving import load_exported, make_serve_fn

    t0 = time.perf_counter()
    fn, meta = load_exported(str(art))
    load_s = time.perf_counter() - t0
    live = make_serve_fn(model, net, **{**proto, "ode_solver": solver}, ode_steps=steps)
    s, cond, mask = artifact_inputs(model, proto["batch_size"], seed)
    reset(counted)
    got = fn(s, cond, mask)
    sync(torch, dev)
    launches = launched(counted)
    expect(f"{name} artifact", launches, **{counter.__name__: per_batch})
    want = live(s, cond, mask)
    if not torch.equal(got, want):
        fail(f"{name}: the artifact differs from make_serve_fn: "
             f"{float((got - want).abs().max())}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: the artifact's samples are not finite")
    return {"load_s": load_s, "equal_to_make_serve_fn": True, "launches": per_batch,
            "kernel": counter.__name__, "_fn": fn, "_live": live, "_meta": meta,
            "_request": (s, cond, mask)}


def sets_in_turns(torch, dev, fn, live, request, batch: int) -> dict:
    """sets/s through the artifact and through make_serve_fn, in turns
    (artifact, live, live, artifact, ARTIFACT_TURNS times), each reading
    ARTIFACT_BATCHES batches behind one sync."""
    _, cond, mask = request
    turns = {"artifact": [], "make_serve_fn": []}
    for _ in range(ARTIFACT_TURNS):
        for key in ("artifact", "make_serve_fn", "make_serve_fn", "artifact"):
            f = fn if key == "artifact" else live
            sync(torch, dev)
            t0 = time.perf_counter()
            for i in range(ARTIFACT_BATCHES):
                f(i, cond, mask)
            sync(torch, dev)
            turns[key].append(ARTIFACT_BATCHES * batch / (time.perf_counter() - t0))
    return {"sets_per_s": {k: float(np.median(v)) for k, v in turns.items()},
            "sets_per_s_turns": turns}


def start_loader(model, art):
    """Start a process that loads the flagship artifact with no model code and
    samples one batch of `artifact_inputs(model, B, 0)`: (process, request,
    the path of its samples, its start time)."""
    s, cond, mask = artifact_inputs(model, B, 0)
    req, got_path = art.parent / "request.npz", art.parent / "loader_x.npy"
    np.savez(req, seed=s, cond=cond, mask=mask)
    proc = subprocess.Popen([sys.executable, "-c", LOADER, str(ROOT), str(art), str(req),
                             str(got_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, (s, cond, mask), got_path, time.perf_counter()


def flagship_artifact(torch, dev, name, model, net, art, counted, counter, exported,
                      loader) -> dict:
    """The flagship artifact: in this process against make_serve_fn, then
    the loader's process (`start_loader`; no model code there): bit for bit,
    600 launches counted there; then sets/s in turns."""
    proto = serving_proto(model, B)
    res = check_artifact(torch, dev, name, model, net, art, counted, counter,
                         model.layers * 2 * (ODE_STEPS - 1), proto, ODE_STEPS, "midpoint", 0)
    proc, (s, cond, mask), got_path, t0 = loader
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"{name}: the loader process failed:\n{stderr[-4000:]}")
    sub = json.loads(stdout.strip().splitlines()[-1])
    sub["process_s"] = time.perf_counter() - t0
    want = res["_live"](s, cond, mask).cpu().numpy()
    if sub["model_modules"]:
        fail(f"{name}: the loader imported model code: {sub['model_modules']}")
    if sub["launches"][counter.__name__] != res["launches"] or sum(sub["launches"].values()) != \
            res["launches"]:
        fail(f"{name}: the loader counted {sub['launches']}, expected {res['launches']} "
             f"{counter.__name__}")
    if not np.array_equal(np.load(got_path), want):
        fail(f"{name}: the loader's samples differ from make_serve_fn")
    return {**{k: v for k, v in res.items() if not k.startswith("_")}, "loader": sub,
            "export": exported, **sets_in_turns(torch, dev, res["_fn"], res["_live"],
                                                res["_request"], B)}


def http_request(url: str, body=None):
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def http_phase(torch, dev, art, n: int, seed: int) -> dict:
    """make_server on an artifact at 127.0.0.1:0: /healthz, /meta, one
    /sample of `n` sets with cond and a num_points list; the samples against
    serve_batches on the same artifact, bit for bit; the request's seconds,
    and the sampling's alone (serve_batches on the same request)."""
    import threading

    from particle_fm_tpu_torch.serving import serve_batches
    from particle_fm_tpu_torch.server import make_server

    t0 = time.perf_counter()
    srv = make_server(str(art), port=0)
    start_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        url = f"http://{host}:{port}"
        meta = srv.service.meta
        if http_request(f"{url}/healthz")[1]["status"] != "ok" or \
                http_request(f"{url}/meta")[1] != meta:
            fail("http: /healthz or /meta answered wrong")
        rs = np.random.RandomState(seed)
        npts = meta["num_points"]
        mult = rs.randint(min(30, npts), npts + 1, size=n)
        cond = rs.randn(n, meta["cond_dim"]).astype(np.float32)
        body = {"n_samples": n, "seed": seed, "num_points": mult.tolist()}
        if meta["cond_dim"]:
            body["cond"] = cond.tolist()
        t0 = time.perf_counter()
        status, out = http_request(f"{url}/sample", body)
        request_s = time.perf_counter() - t0
        mask = (np.arange(npts)[None, :] < mult[:, None]).astype(np.float32)[..., None]
        sync(torch, dev)
        t0 = time.perf_counter()
        want = serve_batches(srv.service.fn, meta, n, cond=cond if meta["cond_dim"] else None,
                             mask=mask, seed=seed)
        sampling_s = time.perf_counter() - t0
        got = np.asarray(out["samples"], np.float32)
        if status != 200 or out["shape"] != [n, npts, meta["features"]] or \
                not np.array_equal(got, want):
            fail(f"http: /sample answered {status}, shape {out.get('shape')}, equal "
                 f"{np.array_equal(got, want)}")
    finally:
        srv.shutdown()
        thread.join(timeout=30)
        srv.server_close()
    return {"sets": n, "server_start_s": start_s, "request_s": request_s,
            "sampling_s": sampling_s, "json_and_http_s": request_s - sampling_s,
            "equal_to_serve_batches": True}


def distillation_phase(torch, ops, dev, counted, model, net) -> dict:
    """The flagship teacher (seeded weights): REFLOW_PAIRS reflow pairs at
    NFE 100 on the EPiC kernel (exact launches); a student trained 2 epochs
    through train.py (data=reflow_pairs) from the teacher's weights;
    straightness, teacher then student, on the pairs' validation split;
    distill_direct DIRECT_STEPS steps at DIRECT_BATCH (the folded teacher's
    solves on the kernel, exact launches); consistency_sample at 1 and 2
    steps (6 and 12 launches a batch) against its plain path within
    PATH_TOL; the reflow student exported at euler 4 evaluations and served
    once over HTTP (`student_http_phase`, later)."""
    from particle_fm_tpu_torch import train as ptrain
    from particle_fm_tpu_torch.config.core import compose
    from particle_fm_tpu_torch.training import consistency, reflow
    from particle_fm_tpu_torch.training.step import create_train_state

    out = {}
    rs = np.random.RandomState(17)
    mask_pool = ragged_mask(rs, REFLOW_PAIRS, N)[..., None]
    cond_pool = rs.randn(REFLOW_PAIRS, C).astype(np.float32)
    reset(counted)
    sync(torch, dev)
    t0 = time.perf_counter()
    x1, x0, m, c = reflow.generate_pairs(model, net, REFLOW_PAIRS, mask=mask_pool, cond=cond_pool,
                                         batch_size=REFLOW_BATCH, ode_steps=ODE_STEPS)
    sync(torch, dev)
    pairs_launches = model.layers * 2 * (ODE_STEPS - 1) * (REFLOW_PAIRS // REFLOW_BATCH)
    expect("reflow pairs", launched(counted), epic_layer=pairs_launches)
    if not (np.isfinite(x1).all() and np.abs(x1[m[..., 0] == 0]).max(initial=0.0) == 0.0):
        fail("reflow pairs: non-finite samples or padded rows not zero")
    out["pairs"] = {"pairs": REFLOW_PAIRS, "batch": REFLOW_BATCH, "nfe": 2 * (ODE_STEPS - 1),
                    "s": time.perf_counter() - t0, "launches": pairs_launches}
    SLICE17_DIR.mkdir(parents=True, exist_ok=True)
    pairs = SLICE17_DIR / "pairs.npz"
    np.savez(pairs, x1=x1, x0=x0, mask=m, cond=c)

    cfg = compose(ptrain.CONFIG_DIR, "train", [
        "data=reflow_pairs", f"data.pairs_path={pairs}", f"data.batch_size={REFLOW_BATCH}",
        "model.loss_type=reflow", f"model.num_particles={N}", f"model.global_cond_dim={C}",
        f"model.local_cond_dim={C}", "model.scheduler.name=constant", "trainer=smoke",
        "callbacks=none", "test=false", f"device={dev.type}"])
    trainer = ptrain.build_trainer(cfg)
    trainer.verbose = False
    student = trainer.model
    state = create_train_state(student, trainer.optimizer, device=dev)
    state.net.load_state_dict(net.state_dict())
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.net.parameters()):
            e.copy_(p)
    reset(counted)
    t0 = time.perf_counter()
    state = trainer.fit(initial_state=state)
    sync(torch, dev)
    expect("reflow student training", launched(counted))
    history = [float(h["val_loss"]) for h in trainer.metrics_history]
    if not np.isfinite(history).all():
        fail(f"reflow student: non-finite validation losses {history}")
    pdm = trainer.datamodule
    val = (pdm.tensor_val, pdm.val.x[..., model.features:], pdm.mask_val,
           pdm.tensor_conditioning_val)
    s_teacher = reflow.straightness(model, net, *val)
    s_student = reflow.straightness(student, state.net, *val)
    out["student"] = {"epochs": len(history), "steps": state.step, "val_loss": history,
                      "train_s": time.perf_counter() - t0,
                      "straightness_teacher": s_teacher, "straightness_student": s_student}

    reset(counted)
    t0 = time.perf_counter()
    direct = consistency.distill_direct(model, net, x1, m, c, steps=DIRECT_STEPS,
                                        batch_size=DIRECT_BATCH, lr=1e-4, warmup=5)
    sync(torch, dev)
    direct_launches = DIRECT_STEPS * 2 * 8 * model.layers  # 8 midpoint steps a target
    expect("distill_direct", launched(counted), epic_layer=direct_launches)
    if not np.isfinite(direct.losses).all():
        fail(f"distill_direct: non-finite losses {direct.losses}")
    out["distill_direct"] = {"steps": DIRECT_STEPS, "batch": DIRECT_BATCH,
                             "s": time.perf_counter() - t0, "losses": direct.losses.tolist(),
                             "launches": direct_launches}

    mask_t = torch.from_numpy(mask_pool[:CONSISTENCY_BATCH]).to(dev)
    cond_t = torch.from_numpy(cond_pool[:CONSISTENCY_BATCH]).to(dev)
    sample_launches = 0
    for steps in (1, 2):
        def sample():
            return consistency.consistency_sample(model, direct.net, torch.Generator(dev)
                                                  .manual_seed(5), cond=cond_t, mask=mask_t,
                                                  steps=steps)

        reset(counted)
        got, k_s, _, p_s, err = kernel_against_plain(torch, dev, f"consistency_sample {steps}",
                                                     ops, "epic_layer", sample)
        expect(f"consistency_sample {steps}", launched(counted), epic_layer=model.layers * steps)
        sample_launches += model.layers * steps
        out[f"consistency_sample_{steps}"] = {"sets": CONSISTENCY_BATCH, "kernel_s": k_s,
                                              "plain_s": p_s, "max_abs_diff_kernel_vs_plain": err,
                                              "launches": model.layers * steps}

    # the student's artifact (euler, 4 evaluations), exported in a process of its own
    out["_student_export"] = start_exports(torch, {"reflow_student": (student, state.net, dict(
        batch_size=B, num_points=N, features=model.features, cond_dim=C, ode_solver="euler",
        ode_steps=STUDENT_STEPS, **{k: v for k, v in serving_proto(model, B).items()
                                     if k in ("means", "stds")}))})
    out["launches"] = pairs_launches + direct_launches + sample_launches
    return out


def student_http_phase(torch, dev, counted, model, procs) -> dict:
    """The reflow student's artifact (exported during the distillation
    phase) served over HTTP once: 1,000 sets, the warm-up's batch, the
    request's 2 batches and serve_batches' 2 (6 launches an evaluation)."""
    export = finish_exports(procs)["reflow_student"]
    reset(counted)
    http = http_phase(torch, dev, SLICE17_DIR / "reflow_student" / "exported", HTTP_JETS, seed=3)
    want = model.layers * (STUDENT_STEPS - 1) * 5
    expect("reflow student served over HTTP", launched(counted), epic_layer=want)
    return {"ode_solver": "euler", "ode_steps": STUDENT_STEPS, "export": export, **http,
            "launches": want}


def slice17_phases(torch, ops, sa, fa, dev, counted, runs) -> dict:
    """The custom ops' opchecks; the artifacts of the flagship (float32 and
    bf16, NFE 100) and of paths A, B, C and D (float32 and bf16, euler, one
    evaluation), exported in processes of their own started first; the
    distillation phase meanwhile; then each artifact against make_serve_fn
    (the flagship's also in a process without model code, started before
    the attention checks, and its sets/s in turns once that process is
    done), the HTTP server on the flagship artifact and on the reflow
    student's. {path: result}, each printed as it ends."""
    import shutil

    from particle_fm_tpu_torch.serving import ARTIFACT_NAME

    shutil.rmtree(SLICE17_DIR, ignore_errors=True)
    by_name = {r["name"]: r for r in runs}
    jobs, checks = {}, {}
    for dtype in (None, "bfloat16"):
        suffix = "" if dtype is None else " bf16"
        run = by_name["epic"]
        model, net = twin(run["model"], run["net"], dtype, dev)
        jobs["flagship" + suffix.replace(" ", "_")] = (model, net, dict(
            num_points=N, features=3, cond_dim=C, ode_steps=ODE_STEPS,
            **{k: v for k, v in serving_proto(model, B).items()
               if k not in ("has_cond", "has_mask")}))
        for path in ("path A", "path B", "path C", "path D"):
            run = by_name[path]
            model, net = twin(run["model"], run["net"], dtype, dev)
            batch = run.get("batch", 640)
            proto = serving_proto(model, batch)
            name = (path + suffix).replace(" ", "_")
            kwargs = {k: v for k, v in proto.items() if k not in ("has_cond", "has_mask")}
            kwargs.update(num_points=model.num_particles, features=model.features,
                          cond_dim=model.global_cond_dim, ode_solver="euler",
                          ode_steps=ATTENTION_STEPS)
            jobs[name] = (model, net, kwargs)
            checks[name] = (path + suffix, model, net, run, proto)
    t0 = time.perf_counter()
    procs = start_exports(torch, jobs)
    out = {}

    def emit(path, res, t1):
        print(json.dumps({"slice17": path, "phase_s": time.perf_counter() - t1,
                          **{k: v for k, v in res.items() if not k.startswith("_")}}),
              flush=True)
        out[path] = res

    t1 = time.perf_counter()
    emit("opcheck", opcheck_phase(torch, ops, dev), t1)
    t1 = time.perf_counter()
    epic = by_name["epic"]
    emit("distillation", distillation_phase(torch, ops, dev, counted, epic["model"], epic["net"]),
         t1)
    exports = finish_exports(procs)
    exports_s = time.perf_counter() - t0
    # the loaders' processes start first and run beside the attention checks
    flagships = {}
    for dtype, counter in ((None, ops.epic_layer), ("bfloat16", ops.epic_layer_bf16)):
        suffix = "" if dtype is None else "_bf16"
        model, net = twin(epic["model"], epic["net"], dtype, dev)
        art = SLICE17_DIR / ("flagship" + suffix) / "exported"
        flagships[suffix] = (model, net, art, counter, start_loader(model, art))
    for name, (label, model, net, run, proto) in checks.items():
        owner, wrapper = run["wrapper_owner"], run["wrapper_name"]
        counter = getattr(owner, wrapper + ("_bf16" if name.endswith("bf16") else ""))
        t1 = time.perf_counter()
        res = check_artifact(torch, dev, label, model, net, SLICE17_DIR / name / "exported",
                             counted, counter, run["launches_per_eval"] * (ATTENTION_STEPS - 1),
                             proto, ATTENTION_STEPS, "euler", 1)
        emit(label + " artifact", {**res, "export": exports[name]}, t1)
    for suffix, (model, net, art, counter, loader) in flagships.items():
        t1 = time.perf_counter()
        emit("flagship artifact" + suffix.replace("_", " "),
             flagship_artifact(torch, dev, "flagship artifact" + suffix, model, net, art,
                               counted, counter, exports["flagship" + suffix], loader), t1)
    t1 = time.perf_counter()
    reset(counted)
    http = http_phase(torch, dev, SLICE17_DIR / "flagship" / "exported", HTTP_JETS, seed=4)
    # the warm-up's batch, then two batches for the request and two for serve_batches
    http["launches"] = launched(counted)["epic_layer"]
    expect("HTTP", launched(counted), epic_layer=5 * epic["model"].layers * 2 * (ODE_STEPS - 1))
    emit("HTTP (flagship artifact)", http, t1)
    t1 = time.perf_counter()
    emit("reflow student artifact over HTTP",
         student_http_phase(torch, dev, counted, epic["model"],
                            out["distillation"]["_student_export"]), t1)
    out["exports_s"] = exports_s
    out["bytes"] = {k: (SLICE17_DIR / k / "exported" / ARTIFACT_NAME).stat().st_size
                    for k in [*jobs, "reflow_student"]}
    return out


def serving_runs(torch, dev, FlowMatchingModel, ops, sa, fa) -> list[dict]:
    """The six served models at full width with their seeded weights, as the
    serving phases serve them (one dict a path: name, config, model, net,
    the wrapper that counts and its launches an evaluation, requests)."""
    jets = dict(features=3, frequencies=16, t_emb="cosine", loss_type="FM-OT")
    jetnet = dict(jets, num_particles=150, global_cond_dim=2)
    # configs/experiment/jetnet/fm_tops150_cond.yaml on configs/model/flow_matching.yaml
    epic = FlowMatchingModel(
        model="epic", hidden_dim=128, layers=6, latent=10, t_global_cat=True, t_local_cat=True,
        add_time_to_input=False, local_cond_dim=2, **jetnet,
    )
    droid = FlowMatchingModel(
        model="droid_fulltransformer", add_time_to_input=True,
        net_config=droid_net_config("te_config", 256, 3, "packed"), **jetnet,
    )
    cross = FlowMatchingModel(
        model="droid_fullcrossattention", add_time_to_input=True,
        net_config=droid_net_config("cae_config", 128, 8, "fused", dense_hddn=256), **jetnet,
    )
    # configs/experiment/calo/mdma_calo.yaml on configs/model/flow_matching_mdma.yaml, with 2
    # heads of 128 in place of 8 of 32 (the parameters have the same shapes)
    mdma = FlowMatchingModel(
        model="mdma", features=4, num_particles=6000, global_cond_dim=1, frequencies=16,
        t_emb="cosine", add_time_to_input=False, loss_type="CFM",
        net_config=dict(latent=16, hidden_dim=256, layers=8, num_heads=2, t_local_cat=True,
                        t_global_cat=True, global_cond_dim=1),
    )
    # configs/experiment/jetclass/jetclass_cond.yaml on configs/model/flow_matching.yaml: cond
    # on the global MLPs only
    jetclass = FlowMatchingModel(
        model="epic", features=13, num_particles=128, global_cond_dim=12, local_cond_dim=0,
        hidden_dim=300, layers=20, latent=16, t_global_cat=True, t_local_cat=True,
        add_time_to_input=False, frequencies=16, t_emb="cosine", loss_type="FM-OT",
    )
    # configs/experiment/lhco/jets_transformer.yaml on configs/model/fm_droid_transformer.yaml
    lhco = FlowMatchingModel(
        model="droid_fulltransformer", add_time_to_input=True, num_particles=279,
        global_cond_dim=5, net_config=droid_net_config("te_config", 256, 3, "flash"), **jets,
    )
    nets = {}
    for seed, (key, model) in enumerate([("droid", droid), ("cross", cross), ("lhco", lhco)], 1):
        nets[key] = model.init(seed=0, device=dev)
        redraw_parameters(torch, nets[key], seed=seed)
    redrawn = "(every parameter re-drawn from a seed)"
    runs = [
        dict(name="epic", config="fm_tops150_cond (seeded random weights)", model=epic,
             net=epic.init(seed=0, device=dev), wrapper_owner=ops, wrapper_name="epic_layer",
             launches_per_eval=epic.layers, requests=(640, 7)),
        dict(name="path A", config="fm_droid_transformer, attn_impl=packed, scores_dtype=null "
             + redrawn, model=droid, net=nets["droid"], wrapper_owner=sa,
             wrapper_name="packed_short_attention", launches_per_eval=3, requests=(640, 7)),
        dict(name="path B", config="fm_droid_crossattention, attn_impl=fused, scores_dtype=null, "
             "4 global tokens " + redrawn, model=cross, net=nets["cross"], wrapper_owner=sa,
             wrapper_name="fused_short_attention", launches_per_eval=2 * 8, requests=(640, 7)),
        dict(name="path C", config="calo/mdma_calo on flow_matching_mdma, net_config.num_heads=2 "
             "(head dim 128: impl=auto takes the flash kernel), 6000 hits, CFM (seeded random "
             "weights)", model=mdma, net=mdma.init(seed=0, device=dev), wrapper_owner=fa,
             wrapper_name="flash_masked_attention", launches_per_eval=8, requests=(32, 5),
             batch=32, mask_lo=1000, cpu_batch=2),
        dict(name="path D", config="lhco/jets_transformer on fm_droid_transformer, "
             "attn_impl=flash, scores_dtype=null, 279 particles, cond 5 " + redrawn, model=lhco,
             net=nets["lhco"], wrapper_owner=fa, wrapper_name="flash_masked_attention",
             launches_per_eval=3, requests=(256, 7), batch=256),
        dict(name="path E", config="jetclass/jetclass_cond on flow_matching (13 features, 128 "
             "particles, hidden 300, latent 16, 20 layers, cond 12 on the global path only; "
             "seeded random weights)", model=jetclass, net=jetclass.init(seed=0, device=dev),
             wrapper_owner=ops, wrapper_name="epic_layer", launches_per_eval=jetclass.layers,
             requests=(512, 7), batch=512, cpu_batch=4),
    ]
    return runs

def main() -> None:
    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import particle_fm_tpu_torch
        from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
        from particle_fm_tpu_torch.ops import _build
        from particle_fm_tpu_torch.ops import epic_layer as ops
        from particle_fm_tpu_torch.ops import flash_attention as fa
        from particle_fm_tpu_torch.ops import short_attention as sa
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if Path(particle_fm_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {particle_fm_tpu_torch.__file__}, not from {ROOT}")

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = _build.build_libraries([ops.SOURCE, sa.SOURCE, fa.SOURCE])
    for module in (ops, sa, fa):
        module.load_library()
    print(json.dumps({"build_s": time.perf_counter() - t0, "libraries": [p.name for p in libs]}),
          flush=True)
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"ptxas ({lib.name}):", line.strip())

    kernels = {k["name"]: k for k in (kernel_phase(torch, ops, dev),
                                      packed_phase(torch, sa, dev),
                                      fused_phase(torch, sa, dev),
                                      flash_phase(torch, fa, sa, dev),
                                      epic_bf16_phase(torch, ops, dev),
                                      packed_bf16_phase(torch, sa, dev),
                                      fused_bf16_phase(torch, sa, dev),
                                      flash_bf16_phase(torch, fa, dev))}
    # on these lines only: the `kernels` line below holds what this run timed and counted
    designs = {
        "packed_short_attention": tensor_core_design(
            sa.MMA_PRODUCTS, sa.packed_launch_report, sa.packed_geometry, 150, 16),
        "flash_masked_attention": tensor_core_design(
            sa.MMA_PRODUCTS, fa.mma_launch_report, fa.mma_geometry, 279, 16),
        "epic_layer": epic_design(ops),
        "epic_layer_bf16": epic_bf16_design(torch, ops),
    }
    for k in kernels.values():
        line = {"kernel_phase": k}
        if k["name"] in designs:
            line["tensor_core_design_at_the_served_shape"] = designs[k["name"]]
        print(json.dumps(line), flush=True)

    runs = serving_runs(torch, dev, FlowMatchingModel, ops, sa, fa)
    epic = runs[0]["model"]
    counted = [ops.epic_layer, sa.packed_short_attention, sa.fused_short_attention,
               fa.flash_masked_attention, ops.epic_layer_bf16, sa.packed_short_attention_bf16,
               sa.fused_short_attention_bf16, fa.flash_masked_attention_bf16]
    served = {}
    for run in runs:
        serving = serving_phase(torch, dev, counted=counted, **run)
        print(json.dumps({"serving": run["name"],
                          **{k: v for k, v in serving.items() if not k.startswith("_")}}),
              flush=True)
        served[run["name"]] = serving
        kernel = kernels[run["wrapper_name"]]
        kernel["launches"] = (kernel["launches"] or 0) + serving["launches"]
        kernel.setdefault("launches_by_path", {})[run["name"]] = serving["launches"]
    t0 = time.perf_counter()
    for run in runs:  # the same models, weights and requests in bfloat16
        serving = bf16_serving_phase(torch, dev, counted=counted, f32=served.pop(run["name"]),
                                     **run)
        print(json.dumps({"serving_bf16": run["name"], **serving}), flush=True)
        kernel = kernels[run["wrapper_name"] + "_bf16"]
        kernel["launches"] = (kernel["launches"] or 0) + serving["launches"]
        kernel.setdefault("launches_by_path", {})[run["name"] + " (bf16)"] = serving["launches"]
    print(json.dumps({"bf16_serving_phases_s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    bf16 = ("model.dtype=bfloat16",)
    epic_train = train_epic_phase(torch, ops, dev, counted)
    print(json.dumps({"training": "train EPiC", **epic_train}), flush=True)
    path_a = train_path_a_phase(torch, sa, dev, counted)
    print(json.dumps({"training": "train path A", **path_a}), flush=True)
    cli = train_cli_phase(torch, ops, dev, counted)
    print(json.dumps({"training": "train CLI", **cli}), flush=True)
    print(json.dumps({"training_phases_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    epic16 = train_epic_phase(torch, ops, dev, counted, bf16)
    epic16[f"batch_{BENCH_TRAIN_BATCH}_in_turns"] = bench_batch_turns(torch, dev)
    print(json.dumps({"training": "train EPiC bf16", **epic16, "f32": {
        k: epic_train[k] for k in ("median_step_ms", "jets_per_s", "peak_memory_bytes")}}),
          flush=True)
    path_a16 = train_path_a_phase(torch, sa, dev, counted, bf16)
    print(json.dumps({"training": "train path A bf16", **path_a16, "f32": {
        k: path_a[k] for k in ("median_step_ms", "jets_per_s", "peak_memory_bytes")}}),
          flush=True)
    cli16 = train_cli_phase(torch, ops, dev, counted, bf16)
    print(json.dumps({"training": "train CLI bf16", **cli16}), flush=True)
    print(json.dumps({"training_bf16_phases_s": time.perf_counter() - t0}), flush=True)
    for kernel_name, path, run in (
            ("packed_short_attention", "train path A", path_a),
            ("epic_layer", "train CLI (EMA weights served)", cli),
            ("packed_short_attention_bf16", "train path A (bf16)", path_a16),
            ("epic_layer_bf16", "train CLI bf16 (EMA weights served)", cli16)):
        kernels[kernel_name]["launches"] += run["launches"]
        kernels[kernel_name]["launches_by_path"][path] = run["launches"]

    t0 = time.perf_counter()
    ev = eval_cli_phase(torch, ops, dev, counted)
    print(json.dumps({"eval": "eval CLI", **{k: v for k, v in ev.items() if k not in (
        "trainer", "model", "datamodule", "callback")}}), flush=True)
    timing = eval_timing_phase(torch, ops, dev, counted, ev)
    print(json.dumps({"eval": "eval timing", **timing}), flush=True)
    print(json.dumps({"eval_phases_s": time.perf_counter() - t0}), flush=True)
    for path, launches in ((f"eval CLI (shipped callbacks, {ev['passes']} passes)",
                            ev["launches"]),
                           (f"eval timing ({timing['jets']:,} jets)",
                            timing["launches"]["epic_layer"])):
        kernels["epic_layer"]["launches"] += launches
        kernels["epic_layer"]["launches_by_path"][path] = launches

    t0 = time.perf_counter()
    fam = [("diffusion CLI (em, 200 steps, 3 passes)", "epic_layer",
            lambda: diffusion_cli_phase(torch, ops, dev, counted)),
           ("droid train + sample", "packed_short_attention",
            lambda: droid_phase(torch, sa, dev, counted)),
           ("self-cond sample", "epic_layer",
            lambda: self_cond_phase(torch, ops, dev, counted)),
           ("OT-CFM train", None, lambda: ot_phase(torch, dev, counted)),
           ("DOPRI5 (dopri5, dopri5_per_sample)", "epic_layer",
            lambda: dopri5_phase(torch, ops, dev, counted, epic)),
           ("log_prob", None, lambda: log_prob_phase(torch, dev, counted, epic))]
    for path, kernel_name, phase in fam:
        t1 = time.perf_counter()
        res = phase()
        print(json.dumps({"family": path, "phase_s": time.perf_counter() - t1, **res}),
              flush=True)
        if kernel_name is not None:
            kernels[kernel_name]["launches"] += res["launches"]
            kernels[kernel_name]["launches_by_path"][path] = res["launches"]
    print(json.dumps({"family_phases_s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    datasets = [("lhco/bigPC CLI (lhco_eval, lhco_eval_sr)", "epic_layer",
                 lambda: lhco_bigpc_phase(torch, ops, dev, counted)),
                ("lhco/whole_event CLI (whole-event callback)", "epic_layer",
                 lambda: lhco_whole_event_phase(torch, ops, dev, counted)),
                ("jetclass/jetclass_cond CLI (jetnet_eval, per-type)", "epic_layer",
                 lambda: jetclass_cond_phase(torch, ops, dev, counted)),
                ("calo/mdma_calo CLI (calo_eval, streamed)", None,
                 lambda: calo_phase(torch, dev, counted))]
    for path, kernel_name, phase in datasets:
        t1 = time.perf_counter()
        res = phase()
        print(json.dumps({"dataset": path, "phase_s": time.perf_counter() - t1, **res}),
              flush=True)
        if kernel_name is not None:
            kernels[kernel_name]["launches"] += res["launches"]
            kernels[kernel_name]["launches_by_path"][path] = res["launches"]
    print(json.dumps({"dataset_phases_s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    clf = classifier_epic_phase(torch, ops, dev, counted)
    print(json.dumps({"classifier": "classifier EPiC (kernel)", **clf}), flush=True)
    for kernel_name, path, key in (
            ("epic_layer", "classifier EPiC (generating the generated sample)",
             "generation_launches"),
            ("epic_layer", "classifier EPiC (predict)", "predict_launches"),
            ("epic_layer_bf16", "classifier EPiC (predict, bf16)", "predict_launches_bf16")):
        kernels[kernel_name]["launches"] += clf[key]
        kernels[kernel_name]["launches_by_path"][path] = clf[key]
    for path, res in classifier_phases(torch, dev, counted).items():
        print(json.dumps({"classifier": path, **res}), flush=True)
    print(json.dumps({"classifier_phases_s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    res = slice16_phases(torch, ops, sa, dev, counted)
    for kernel_name, path, launches in (
            ("epic_layer", "LHCO two-stage chain (stage 2, x and y jets)",
             res["LHCO two-stage chain"]["launches"]),
            ("packed_short_attention", "fm_moe_transformer (MoE transformer)",
             res["fm_moe_transformer"]["launches"]),
            ("packed_short_attention_bf16", "fm_moe_transformer (MoE transformer, bf16)",
             res["fm_moe_transformer"]["launches_bf16"]),
            ("epic_layer", "flagship, gaussian time + normaliser (sampling)",
             res["flagship, gaussian time + normaliser"]["launches"])):
        kernels[kernel_name]["launches"] += launches
        kernels[kernel_name]["launches_by_path"][path] = launches
    print(json.dumps({"slice16_phases_s": time.perf_counter() - t0}), flush=True)

    t0 = time.perf_counter()
    res = slice17_phases(torch, ops, sa, fa, dev, counted, runs)
    distilled = res["distillation"]
    for kernel_name, path, launches in (
            ("epic_layer", "slice17 reflow pairs (4,096 at NFE 100)",
             distilled["pairs"]["launches"]),
            ("epic_layer", "slice17 distill_direct (the teacher's solves)",
             distilled["distill_direct"]["launches"]),
            ("epic_layer", "slice17 consistency_sample (1 and 2 steps)",
             distilled["consistency_sample_1"]["launches"]
             + distilled["consistency_sample_2"]["launches"]),
            ("epic_layer", "slice17 reflow student artifact over HTTP",
             res["reflow student artifact over HTTP"]["launches"]),
            ("epic_layer", "slice17 flagship artifact (here and in the loader)",
             res["flagship artifact"]["launches"] + res["flagship artifact"]["loader"]
             ["launches"]["epic_layer"]),
            ("epic_layer_bf16", "slice17 flagship artifact bf16 (here and in the loader)",
             res["flagship artifact bf16"]["launches"] + res["flagship artifact bf16"]["loader"]
             ["launches"]["epic_layer_bf16"]),
            ("epic_layer", "slice17 HTTP on the flagship artifact",
             res["HTTP (flagship artifact)"]["launches"]),
            *((res[f"{path}{suffix} artifact"]["kernel"], f"slice17 {path}{suffix} artifact",
               res[f"{path}{suffix} artifact"]["launches"])
              for path in ("path A", "path B", "path C", "path D") for suffix in ("", " bf16"))):
        kernels[kernel_name]["launches"] += launches
        kernels[kernel_name]["launches_by_path"][path] = launches
    print(json.dumps({"slice17_phases_s": time.perf_counter() - t0}), flush=True)

    kernels = list(kernels.values())
    print(json.dumps({"smoke_s": time.perf_counter() - started}), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
