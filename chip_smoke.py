"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which must pass:

1. the card: name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``diff_unet_tpu_torch/csrc`` with ``nvcc``
   (one process per source, in parallel), print each kernel's ptxas
   registers and spills, and fail if a conv (every instance of the wgmma
   kernel: bf16, s8 and 3xTF32), weight-gradient (bf16 wgmma, 3xTF32
   mma.sync) or bf16 attention kernel spills, or if ptxas warns that it
   serialised a kernel's wgmma instructions;
3. every kernel against its plain PyTorch version on the card at the
   shapes its slice gives it, with CUDA-event times of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed only as a yardstick; the port never calls it):
   a. window attention at the four Swin stage geometries of a 96^3 ROI
      with sw_batch_size 2, shifted and unshifted, bf16 and fp32
      (library: ``scaled_dot_product_attention`` with the bias and region
      mask as ``attn_mask``), beside its bound and its softmax floor (one
      exponential per score at 16 per clock per SM at the card's maximum
      SM clock); the window shift forward and inverse at the
      7^3 / 4^3 / 2^3 window grids, bit-exact (library: ``index_select``
      with the same table);
   b. the 3x3x3 conv at every distinct conv of DiffUNet at a 96^3 ROI with
      sw_batch_size 4 (stems, prologue and statistics, two-part UpCat
      inputs, 96^3 down to 6^3 and up to 512 -> 512), plus the switches of
      the other TPU conv kernels (bias and LeakyReLU; no bias), bf16 and
      fp32 (library: ``F.conv3d`` on the channels_last_3d view in the same
      dtype, with ``var_mean`` of the output where statistics are on;
      TF32 off); every kernel run twice for the same bits; fp32 runs as
      3xTF32 on the tensor cores, and its rows give two bounds, at the
      3xTF32 rate (three tf32 products a float32 product at 495 TFLOP/s)
      and at the 67 TFLOP/s FFMA rate;
   c. the window partition (zero padding fused) and its reverse (crop
      fused) at the four Swin stage geometries, B = 1 and 2, bf16 and fp32,
      bit-exact (library: ``index_select`` of the pre-padded token rows by
      the partition table);
   d. the backwards: the shift's backward kernel and the partition's
      adjoint pair against autograd through the plain versions, bit-exact;
      the attention's backward kernel (qkv and bias gradients) at the four
      stage geometries of a training batch, fp32 and bf16, against
      ``window_attention_backward_plain`` and against autograd through the
      plain version, within 1e-4 (fp32) and 3e-2 (bf16) of each gradient's
      max |g|, with the times of the kernel, of ``torch.autograd.grad``
      through the port and through the plain version, of the library's
      backward (``torch.autograd.grad`` through
      ``scaled_dot_product_attention`` with the f32 bias as a float
      ``attn_mask``), the bound and the softmax floor;
   e. the conv's backward at every distinct DiffUNet conv of an AMOS
      training batch (N 10), bf16 and fp32: dgrad (the forward kernel with
      the flipped weights; not at the stems, whose inputs need no
      gradient) against ``conv3x3_dgrad_plain`` and the weight-gradient
      kernel against ``conv3x3_wgrad_plain`` (1e-4 / 1e-3 of max |plain|
      in fp32 / bf16), each run twice for the same bits, with kernel,
      plain and cuDNN times
      (``aten.convolution_backward`` with an input-only or weight-only
      output mask), the bound and the kernel's share of it; then the
      weight gradient's kernel, cuDNN and bound times summed over one AMOS
      train step (each conv times its launches a step, 28 in all); and the
      conv's autograd Function against autograd through the plain version
      at two small shapes;
   f. the MSD recipe's convs at N 4 in bf16 (the denoiser stem [image, 2
      classes] -> 64, whose 2-channel part takes the gathered halo, and
      the last level's convs): forward, dgrad and weight gradient against
      their plain versions, with kernel and plain times;
   g. AttentionDiffUNet's Cout-32 convs at 96^3 in bf16 (the denoiser
      head [image, 15 classes], a ConvBNReLU2's conv_1 with its
      per-channel ReLU prologue, a gated stage's two-part conv_0): the
      forward at N 4 and 10, the dgrad and weight gradient at N 10,
      against their plain versions, with kernel, cuDNN and bound times;
   h. HybridMIM pretraining's float32 convs at N 2 (the stem 1 -> 64 at
      64^3 down to 512 -> 512 at 4^3, and the decoder's two-part convs
      at 32^3 down to 4^3): forward with statistics, dgrad and weight
      gradient (the 3xTF32 instances) against their plain versions, each
      run twice for the same bits, with kernel, plain, cuDNN and both
      bounds' times, then each summed over one pretraining step (28 / 17 /
      18 launches);
4. small models on the card against the same weights on the CPU's plain
   path, fp32 with TF32 off: a DiffSwinUNETR denoiser step (feature 12,
   32^3), a DiffUNet denoiser step (features (8, 8, 16, 32, 64, 8), 32^3),
   and two train steps of each (the same t and noise): loss, grad norm,
   every gradient, and the parameters after them within 2 lr per step;
   DiffUNet's card step, run twice from the same start, gives the same
   bits; one DiffUNet train step with all 14 loss names (the boundary
   loss's distance maps from the host EDT); the plain Swin-UNETR's forward
   and two train steps; SmoothDiffUNet (features (8, 8, 16, 32, 64, 8),
   16x32x32 windows) embed and denoise in fp32 and bf16, and two train
   steps as DiffUNet's, its card step run twice for the same bits;
   AttentionDiffUNet (features (8, 16, 32, 64, 128), 32^3, a batch of 2
   different samples) the same, its train-step gradients within
   ATT_GRAD_TOL of the model's largest; a small HybridMIM (features
   (8, 8, 16, 32, 64, 8), 32^3, mask patch 8, a batch of 2, the masks
   pinned): the forward's outputs, then two pretraining steps as
   DiffUNet's, the card step run twice for the same bits;
5. each slice at full width from the repository's config with seeded
   random weights:
   a. ``cfg/btcv/test.yaml`` (diff_swin_unetr, feature 48, 13 classes,
      96^3 ROI, sw_batch_size 2, overlap 0.25, DDIM-10, bf16): a
      ``Predictor`` serves synthetic CT volumes; each Swin kernel must have
      run its exact count per window batch;
   b. ``cfg/amos/test.yaml`` (diff_unet, features (64, 64, 128, 256, 512,
      64), 15 classes, 96^3 ROI, sw_batch_size 4, overlap 0.25, DDIM-10,
      bf16): the conv kernel must have run exactly 10 + 18 * 10 times per
      window batch;
   c. ``cfg/btcv/train.yaml`` (diff_swin_unetr, feature 48, 13 classes +
      background, 96^3 patches, batch 1, bf16 over fp32 parameters,
      mse+bce+dice, label smoothing, AdamW with warmup-cosine): a
      ``Trainer`` takes ``TRAIN_STEPS`` steps on synthetic batches
      (``max_epochs`` 1: the warmup does not depend on it); losses and
      grad norms finite, parameters moved, and each Swin kernel's exact
      count per step, forward and backward; then the median s/step of
      the trainer's step over the same batches with the card synchronised
      around each step, and the peak device memory of ``train()``;
   d. ``cfg/amos/train.yaml`` (diff_unet at full width, 15 classes, 96^3
      patches, batch 10, bf16 over fp32 parameters, mse+bce+dice, AdamW
      with warmup-cosine): a ``Trainer`` takes ``AMOS_TRAIN_STEPS`` steps
      on synthetic batches of 16 label values, with exactly 28 forward,
      26 dgrad and 28 wgrad conv launches a step; losses, grad norms,
      moved parameters, median s/step and peak memory as in c;
   e. ``cfg/msd/train.yaml`` (diff_unet, 2 classes, mse+bce+dice+focal,
      batch 4, lr 2e-4): ``MSD_TRAIN_STEPS`` steps with 28 / 26 / 28 conv
      launches a step, median s/step and peak memory;
   f. ``cfg/amos/train.yaml`` with ``AMOS_KEYS`` (EMA 0.9999, an update
      every 2 calls, the loss-aware sampler), batch 10: ``train()`` over
      ``AMOS_KEYS_CALLS`` calls, then call by call the EMA tree against
      e * rate + p * (1 - rate) recomputed on the card (bit for bit), the
      parameters moving on update calls only and the sampler's counts
      against the t's drawn; s per call against d; then a ``.pt`` whose
      EMA tree a ``Tester(use_ema=True)`` loads bit for bit and scores
      phase 7's first case with;
   g. the plain ``swin_unetr`` baseline at BTCV widths: a ``Trainer``
      (``cfg/btcv/train.yaml``, batch 1) for ``SWIN_UNETR_STEPS`` steps
      with one Swin pass a step (8 / 6 / 4 / 4 attention, shift,
      partition, reverse launches forward and as many backward), then a
      ``Predictor`` (``cfg/btcv/test.yaml``) on the 96x192x192 CT, one
      forward per window batch and no DDIM loop;
   h. ``cfg/amos/test.yaml`` with ``model_name=smooth_diff_unet`` (the
      smoothing encoder and the layer-norm denoiser at the AMOS widths):
      a ``Predictor`` serves the 96x192x192 CT, exactly 190 conv launches
      per window batch (570 in all) and no dgrad or wgrad;
   i. ``cfg/amos/train.yaml`` with ``model_name=smooth_diff_unet``, batch
      10, as d: 28 / 26 / 28 conv launches a step, every smoothing weight
      moved, median s/step and peak memory beside d's; then one 64 -> 64
      TwoConv at 10 x 96^3, forward and forward + backward, with the
      instance-norm chain and with the layer-norm chain;
   j. ``cfg/amos/test.yaml`` with ``model_name=attention_diff_unet``
      (features (32, 64, 128, 256, 512)): a ``Predictor`` serves the
      96x192x192 CT, exactly 310 conv launches per window batch (930 in
      all) and no dgrad or wgrad;
   k. ``cfg/amos/train.yaml`` with ``model_name=attention_diff_unet``,
      batch 10, as d: 40 / 38 / 40 conv launches a step, every parameter
      tensor moved, median s/step and peak memory beside d's; then one
      32 -> 32 ConvBNReLU2 at 10 x 96^3 (the kernel chain against the
      plain chain, its batch norm against a float64 two-pass one, times
      against cuDNN's conv, batch norm and ReLU);
   l. HybridMIM pretraining at ``examples/pretrain_mim.py``'s defaults
      (features (64, 64, 128, 256, 512, 64), batch 2 of 64^3, mask patch
      16, AdamW lr 1e-3 wd 1e-4, float32) through
      ``diff_unet_tpu_torch.pretrain_mim``: MIM_STEPS steps with every
      loss term finite, every parameter tensor moved and exactly 28 / 17
      / 18 conv launches a step, the median s/step of a synchronised pass
      and the peak memory; then the encoder ``.npz``, grafted by
      ``Trainer.from_config("cfg/amos/train.yaml", pretrained_path=...)``
      into ``embed_model`` bit for bit, and one AMOS step of batch 10;
   m. (run after phase 7, on its NIfTI set and weights) continuous window
      batching across volumes (``Engine.serve_volumes``), against the
      serial path on the same inputs with the engine seed for every
      volume: a volume whose every window runs at the same batch size on
      both paths gives the same bits, any other is within CONT_TOL of max
      |y| with binaries on all but CONT_FLIPS of the voxels (another
      batch size rounds the bf16 sums in another order). AMOS DiffUNet
      over CONT_SHAPES (7 batches of the unit against 9 serial ones) in
      turns serial, continuous, continuous, serial: volumes/min, DDIM
      window-steps/s, the card's busy share (the window batches' CUDA-event
      times over the wall time) and peak memory of each, the two
      continuous runs bit for bit, 190 conv launches per planned batch;
      AMOS AttentionDiffUNet over two 96x192x192 volumes (batches 4, 4, 4,
      4, 2; 310 launches each; its difference from serial printed, since
      its batch statistics depend on the batch); BTCV DiffSwinUNETR over
      96x192x192 and 80x160x176 at unit 2 (each Swin kernel's count per
      batch); ``Tester(continuous=2)`` over phase 7's cases (outputs and
      metrics against phase 7's, s/case); ``python -m
      diff_unet_tpu_torch.predict`` in process over phase 7's two CTs each
      listed twice, every labelmap against ``predict_volume``'s,
      volumes/min and busy share against the serial loop;
6. the exact distance transform under HD95 (``ops/edt.py``, host C++ built
   with g++) against ``scipy.ndimage.distance_transform_edt`` on one
   96x192x192 organ-surface mask, within 1e-6 of the largest distance,
   with the ms of each; then the seconds of the boundary loss's signed
   distance maps for one MSD and one AMOS batch of 96^3 labels;
7. the evaluation path (the reference's ``test.py``): a synthetic NIfTI
   validation set of 2 AMOS CTs (int16, 15 organ ids, spacing
   (1.5, 1.5, 2.0), preprocessing to 96x192x192 and 88x192x192, thinner
   than the ROI: 9 windows each), seeded
   full-width weights saved with ``save_jax_npz`` and loaded through
   ``model_path`` (equal bit for bit), ``Tester.from_config(
   "cfg/amos/test.yaml").test()``: every dice and IoU finite and in
   [0, 1], ``results.pkl`` with fp16 images and bool masks, 190 conv
   launches per window batch, each case's seconds split into inference,
   dice on the device, HD95 + IoU on the host and recording; then the
   device metrics on the card against the CPU on the same masks (1e-6);
8. ``cfg/amos/train.yaml`` at full width with ``data_path``: 4 training and
   2 validation synthetic CTs, batch 2 (a cut), 2 epochs with validation
   and ``epoch_{n}.pt`` every epoch, 28 / 26 / 28 conv launches a step and
   190 per validation window batch; a second trainer resumed from
   ``epoch_1.pt`` must end with the same parameters bit for bit; the
   median s/step with the host pipeline against the same step on a
   resident batch and against phase 5d, and the peak memory;
9. W8A8 int8 serving of DiffUNet (run among the phases above, in this
   order: a right after 3b, b-d after the AMOS serving of 5):
   a. the s8 instance of the wgmma conv kernel: first its quantize on
      load value by value (an identity conv over every finite bf16 value,
      TMA-staged and gathered, and random float32, at S8_QUANT_SCALES,
      with and without a prologue, against ``quantize_input``); then
      against its plain version at every DiffUNet conv of CONV_CASES (N
      4, int8 weights over the whole int8 range) with int8 parts, float
      parts quantized on load (bf16; the stems also float32) and bf16 y
      through a random norm prologue: the int32 sums and the rescaled bf16
      output bit for bit, the statistics within STATS_TOL; times of each
      mode, the plain version (``quantize_input``, then a float64
      convolution of the int8 values), the bf16 kernel at the same shape
      and ``torch._int_mm`` on the im2col GEMM's shape (the product
      alone), and each mode's bound at the int8 peak;
   b. one AMOS window batch (4 x 96^3, seeded full-width weights) served
      bf16, int8 with dynamic scales and int8 with static scales
      calibrated on the CT's first window: s per batch, DDIM
      window-steps/s, exactly 190 s8 launches, no bf16 conv launch and no
      weight packed again per timed int8 batch, each int8 answer's
      distance from bf16 as a fraction of max |y| and its share of
      differing binary voxels;
   c. ``Predictor(quantize=True)`` serving the 96x192x192 CT (path
      ``amos_int8_serve``, 190 s8 launches per window batch);
   d. the learning check, ``python -m diff_unet_tpu_torch.overfit`` at its
      defaults (48^3, full width, 401 steps): its trajectory and a final
      mean dice of at least OVERFIT_DICE_FLOOR; then its ``.npz`` served
      in bf16, int8 weights-only and int8 calibrated (``quant_calibrate:
      1``), each int8 mean dice within INT8_DICE_TOL of bf16's, with the
      share of differing binary voxels;
10. W8A8 int8 serving of DiffSwinUNETR at ``cfg/btcv/test.yaml`` (run
   among the phases above: a right after 9a, b after phase 4's small
   DiffSwinUNETR, c-d after 9d):
   a. the s8 kernel at every distinct 3x3x3 conv shape of the UNETR
      blocks at N 2 (S8_SWIN_CASES: the stems [1] and [1, 14] -> 48 and
      the 48-channel convs at 96^3 on the gathered halo, 48 -> 48 at 48^3,
      96 at 24^3, 192 at 12^3, 768 at 3^3, and the decoders' two-part
      conv1s [384, 384] at 6^3 down to [48, 48] at 96^3) as in 9a (int8
      parts and their concat, float32 stems or bf16 parts on load, bf16 y
      through the prologue at slope 0.01 with a film and without), with
      the bf16 kernel's and cuDNN's bf16 times beside and, printed as an
      estimate, their sums over a window batch's 208 launches; then
      ``conv1x1_int8`` (one
      ``torch._int_mm``) at its 7 shapes against its plain version, bit
      for bit, with ``torch._int_mm`` alone timed;
   b. a small DiffSwinUNETR(quantize=True) (feature 12, 32^3, fp32, int8
      state recorded on the CPU) on the card against the CPU, within
      INT8_SMALL_TOL of max |y|, with the share of int8 inputs that differ;
   c. one BTCV window batch (2 x 96^3, seeded full-width weights) served
      bf16, int8 dynamic and int8 static as 9b: exactly 208 s8 launches,
      61 int8 GEMMs and no float 3x3x3 UNETR conv (cuDNN) or bf16 conv
      kernel launch a batch, no weight packed again, the distance from
      bf16, its binary flips and its correlation (above INT8_SWIN_CORR);
      then one more batch of each under ``torch.profiler``: the device
      time of its s8 convs and int8 GEMMs, or of bf16's UNETR convs on
      cuDNN, which the kernels line's s8 entry reports;
   d. ``Predictor(quantize=True)`` serving the 96x192x192 CT (path
      ``btcv_int8_serve``: 208 s8 launches and 61 int8 GEMMs per window
      batch, 1040 and 305 in all, and the Swin kernels' counts); then,
      calibrated on it, ``serve_volumes`` over CONT_BTCV_SHAPES against
      serial: bit for bit where the batch sizes match, elsewhere the
      binaries within CONT_FLIPS and the logits within INT8_CONT_FACTOR
      times the bf16 model's distance on the same volume, read here;
11. the rest of the diffusion core (run right after 9d):
   a. a small DiffUNet (CORE_SMALL, fp32, TF32 off) on the card against
      the CPU with the same weights, x_T and step noise: ``ddpm_sample``,
      ``ddim_sample(eta=1)``, the DDIM reverse loop, ``training_losses``
      of the four loss types and ``calc_bpd_loop`` over a respaced
      CORE_BPD_STEPS-step schedule, within MODEL_TOL of max |y|; a
      parametric toy emitting 2C channels, its LEARNED_RANGE
      ``training_losses`` and their gradients within ATT_GRAD_TOL;
   b. the AMOS DiffUNet at full width (bf16, seeded random weights), one
      window batch of 4 x 96^3: ``ddim_sample`` at eta 0 equal bit for
      bit to the old loop (``parent_ddim_sample``); ``ddpm_sample``
      (path ``amos_ddpm``), ``ddim_sample(eta=1)`` (``amos_ddim_eta``)
      and the reverse loop from the eta-0 answer (``amos_ddim_reverse``),
      each timed once with CUDA events and the wall clock, finite, 190
      conv launches; ``training_losses`` at 2 x 96^3 forward and backward
      for ``mse`` and ``rescaled_kl`` (``amos_vb_train``: 28 / 26 / 28
      conv, dgrad and wgrad launches each, finite loss and gradient norm,
      peak memory); ``calc_bpd_loop`` at batch 1 over the whole 1000-step
      train schedule, the embedding hoisted (``amos_bpd``: 10 + 18 x 1000
      launches, every array finite, its seconds);
   c. phase 9d's trained model served on its 4 volumes by DDIM-10 at eta
      0, DDIM-10 at eta 1 and DDPM over the respaced 10 steps, each from
      the x_T that ``infer`` draws: each mean dice (finite, in [0, 1]) and
      the share of binary voxels that differ from eta 0.

Serving outputs are checked for shape, finiteness and a binary mask. Each
path is driven with its kernels' launch counters set to 0 just before it
and read just after; the kernels line reports each kernel's launches on
the first path of ``LAUNCH_ORDER`` it ran on (the diffusion core first)
and all of them under ``launches_by_path``; its float32 entries (the
3xTF32 conv, forward and dgrad, and weight gradient) report HybridMIM
pretraining's launches and phase 3h's L0 conv_1. Phases 2-8
run in a temporary directory under ``build/``, where the trainers' logs and phases
7-8's data, weights and logs are written. It prints one
JSON line with the kernels (times, error, launches, and the least time the
card could take, from this run's shapes and the H100 SXM peaks), then,
last, one JSON line with ``"ok": true`` and the device. Any failed phase
exits non-zero before that.

    python3 chip_smoke.py --phases conv,conv_backward,conv_s8

runs phases 1 and 2 and then only the named phases (the ``phase_*``
functions of this file that take the device alone), and prints no JSON:
a way to time two checkouts in turns with the same script. Alone,
``diffusion_core`` runs 11a and 11b and reports 11c as not run: its model
comes from phase 9d.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 1e-3
# a small bf16 model on the card against the CPU's bf16 plain path, as a
# fraction of max |y|: both round at the same points, but a sum taken in
# another order can round a bf16 value the other way (2^-9 relative), and
# such flips pass through ~30 convs and norms; the worst is the deepest
# encoder level, an instance norm over 1x2x2 voxels (3.6e-2 on an H100)
SMOOTH_BF16_TOL = 5e-2
# the small UNet families of phase 4: (D, H, W) of the window, widths
SMALL_UNETS = {"smooth_diff_unet": ((16, 32, 32), (8, 8, 16, 32, 64, 8)),
               "attention_diff_unet": ((32, 32, 32), (8, 16, 32, 64, 128))}
# AttentionDiffUNet's train steps, card against CPU: every gradient within
# this fraction of the model's largest. A conv's weight gradient before a
# batch norm sums g times inputs of large mean (ReLU outputs, the image)
# where g sums to 0 over the batch, so float32 rounding of g moves it by
# 6.1e-4 of the model's largest gradient between float32 and float64 on
# the CPU at SMALL_UNETS' shapes, and card and CPU by 4.1e-3 on an H100
# (the kernels' float32 sums in tile order, the one-pass statistics'
# adjoint g + dsum + 2 y dsumsq)
ATT_GRAD_TOL = 1e-2
# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, and the operation
# rate of each type on the unit that the kernels use
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                   torch.int8: 1979e12}
# float32 work on the tensor cores as 3xTF32: three tf32 products (495
# TFLOP/s dense) for each float32 product
TF32X3_FLOP_PER_S = 495e12 / 3
HOLD_CYCLES = 100_000_000     # about 50 ms of the SM clock
# (tag, part channels, Cout, side, prologue, stats, bias, LeakyReLU) for
# every distinct 3x3x3 conv of DiffUNet at a 96^3 ROI with sw_batch_size 4
# (N = 4); then the switches of the other TPU conv kernels at the L0 shape
CONV_N = 4
CONV_CASES = [
    ("encoder stem", [1], 64, 96, False, True, True, False),
    ("denoiser stem", [1, 15], 64, 96, False, True, True, False),
    ("L0 conv_1", [64], 64, 96, True, True, True, False),
    ("L0 upcat", [64, 64], 64, 96, False, True, True, False),
    ("L1 conv_0", [64], 64, 48, False, True, True, False),
    ("L1 conv_1", [64], 64, 48, True, True, True, False),
    ("L1 upcat", [64, 64], 64, 48, False, True, True, False),
    ("L2 conv_0", [64], 128, 24, False, True, True, False),
    ("L2 conv_1", [128], 128, 24, True, True, True, False),
    ("L2 upcat", [128, 128], 128, 24, False, True, True, False),
    ("L3 conv_0", [128], 256, 12, False, True, True, False),
    ("L3 conv_1", [256], 256, 12, True, True, True, False),
    ("L3 upcat", [256, 256], 256, 12, False, True, True, False),
    ("L4 conv_0", [256], 512, 6, False, True, True, False),
    ("L4 conv_1", [512], 512, 6, True, True, True, False),
    ("bias+lrelu (pallas_packed_conv / pallas_aug_conv)", [64], 64, 96,
     False, False, True, True),
    ("no bias (pallas_conv)", [64], 64, 96, False, False, False, False),
]
CONV_REPORT = ("L0 conv_1", torch.bfloat16)   # the kernels line's conv entry
# phase 9, W8A8 int8 serving: the s8 conv at every DiffUNet conv of
# CONV_CASES (int8 parts and weights, bf16 out, bias and statistics); the
# kernels line's s8 entry; s8 conv launches per AMOS window batch (every
# 3x3x3 conv: 10 in the encoder, 18 in each of the 10 denoiser passes)
S8_CASES = [c[:4] for c in CONV_CASES[:15]]
S8_REPORT = "L0 conv_1"
INT8_PER_BATCH = 10 + 18 * 10
# W8A8 int8 serving of DiffSwinUNETR at the BTCV config (sw_batch_size 2
# of 96^3 windows): every distinct 3x3x3 conv shape of its UNETR blocks,
# (tag, part channels, Cout, side, {input mode: launches a window batch})
# with static scales (conv2 takes its norm prologue; a dynamic scale
# quantizes the materialised bf16 input instead); the blocks with a 1x1
# projection (the encoder1s and the decoders) quantize their input once
# to one int8 tensor for conv1 and conv3. 8 s8 launches in the encoder and
# 20 in each of the 10 denoiser passes; 1 + 6 * 10 int8 GEMMs (the 1x1
# projections: (tag, Cin, Cout, side))
BTCV_N = 2
UNETR_SLOPE = 0.01
_PRO, _PRO0, _BF = ("bf16 y + prologue", "bf16 y + prologue, no film",
                    "bfloat16 parts")
S8_SWIN_CASES = [
    ("encoder1 conv1 (encoder)", [1], 48, 96, {"int8 parts": 1}),
    ("encoder1 conv1 (denoiser)", [1, 14], 48, 96, {"int8 concat": 10}),
    ("encoder1 conv2, decoder1 conv2", [48], 48, 96, {_PRO0: 1, _PRO: 20}),
    ("encoder2, decoder2 conv2", [48], 48, 48,
     {_BF: 11, _PRO0: 1, _PRO: 20}),
    ("encoder3, decoder3 conv2", [96], 96, 24,
     {_BF: 11, _PRO0: 1, _PRO: 20}),
    ("encoder4, decoder4 conv2", [192], 192, 12,
     {_BF: 11, _PRO0: 1, _PRO: 20}),
    ("encoder10", [768], 768, 3, {_BF: 10, _PRO: 10}),
    ("decoder5 conv1", [384, 384], 384, 6, {"int8 concat": 10}),
    ("decoder5 conv2", [384], 384, 6, {_PRO: 10}),
    ("decoder4 conv1", [192, 192], 192, 12, {"int8 concat": 10}),
    ("decoder3 conv1", [96, 96], 96, 24, {"int8 concat": 10}),
    ("decoder2 conv1", [48, 48], 48, 48, {"int8 concat": 10}),
    ("decoder1 conv1", [48, 48], 48, 96, {"int8 concat": 10}),
]
S8_SWIN_1X1 = [("encoder1 (encoder)", 1, 48, 96),
               ("encoder1 (denoiser)", 15, 48, 96),
               ("decoder5", 768, 384, 6), ("decoder4", 384, 192, 12),
               ("decoder3", 192, 96, 24), ("decoder2", 96, 48, 48),
               ("decoder1", 96, 48, 96)]
BTCV_INT8_PER_BATCH = 8 + 20 * 10
BTCV_GEMM_PER_BATCH = 1 + 6 * 10
# the int8 DDIM logits of a BTCV window batch must correlate with the bf16
# model's above this, the bar of the JAX package's own test of the
# quantized DiffSwinUNETR against the float one
# (tests/test_torch_parity_swin.py)
INT8_SWIN_CORR = 0.98
# a small quantized DiffSwinUNETR on the card against the CPU, as a
# fraction of max |y|: an activation within float32 rounding of a .5
# quotient lands one int8 step apart, and such flips pass through the
# blocks: a relative perturbation of 1e-7 of the inputs moves the CPU's
# own denoise by 1.6e-2 of max |y| (4378 of 5.2e6 int8 inputs differ)
INT8_SMALL_TOL = 5e-2
# continuous against serial BTCV int8 serving (static scales), where a
# window ran at another batch size: its logits' distance as a multiple of
# the bf16 model's on the same volume, read in the same phase. The bf16
# model's differs by the Swin's rounding at another batch size, and the
# int8 steps magnify a perturbation (INT8_SMALL_TOL): 1.487e-1 of max |y|
# against bf16's 1.854e-2 on the 80x160x176 volume (8.0x; H100, random
# weights). Twice that; a window served with another's data or scale
# moves its logits by the order of max |y| and flips about half its voxels
INT8_CONT_FACTOR = 16.0
# the activation scales of the quantizer's exhaustive check: quotients from
# far beyond the clamp to a few units, over several binades of the scale
S8_QUANT_SCALES = (3.0e-3, 0.0173, 0.25, 3.7, 97.0)
INT8_REPS = 3
# the learning check (python -m diff_unet_tpu_torch.overfit at its
# defaults): the final mean dice must reach OVERFIT_DICE_FLOOR (the JAX
# example's README records 0.86 at iteration 100 and 1.00 from 300 on a
# TPU); int8 serving of the trained model, weights-only and calibrated,
# must keep the mean dice within INT8_DICE_TOL of bf16's, the bound the
# JAX package's own test holds int8 to (tests/test_end_to_end.py)
OVERFIT_DICE_FLOOR = 0.8
INT8_DICE_TOL = 0.02
# (stage, BW, heads, N, window grid of the padded stage or None when the
# window is clamped and never shifted) for a 96^3 ROI at sw_batch_size 2
ATTN_CASES = [
    ("stage1", 686, 3, 343, (7, 7, 7)),
    ("stage2", 128, 6, 343, (4, 4, 4)),
    ("stage3", 16, 12, 343, (2, 2, 2)),
    ("stage4", 2, 24, 216, None),
]
SHIFT_CASES = [((7, 7, 7), 48), ((4, 4, 4), 96), ((2, 2, 2), 192)]
# (stage, side of the stage's input, C, window) for a 96^3 ROI: 48^3 pads
# to 49^3, 24^3 to 28^3, 12^3 to 14^3; at 6^3 the window clamps to 6
PARTITION_CASES = [("stage1", 48, 48, 7), ("stage2", 24, 96, 7),
                   ("stage3", 12, 192, 7), ("stage4", 6, 384, 6)]
# (stage, BW, heads, N, shifted) of a training batch of one 96^3 patch
ATTN_GRAD_CASES = [("stage1", 343, 3, 343, True), ("stage2", 64, 6, 343, True),
                   ("stage3", 8, 12, 343, True), ("stage4", 1, 24, 216, False)]
TRAIN_STEPS = 8
# the kernels that must not spill (substrings of their mangled names;
# "conv3d_wgmma" covers every instance of the conv, conv3d_wgmma_kernel<
# Bf16Op / S8Op / Tf32x3Op, ...>, which share its register budget) and the
# ptxas warnings that a kernel's wgmma instructions were serialised
NO_SPILL_KERNELS = ("conv3d_wgmma", "attn_fwd_bf16", "attn_bwd_bf16",
                    "conv3d_wgrad_wgmma", "conv3d_wgrad_tf32")
WGMMA_WARNING = re.compile(r"C75\d\d|wgmma\S* .*serializ", re.I)
# per window batch of BTCV serving (1 embed + 10 denoiser Swin passes of 4
# stages) and per BTCV train step (the encoder's and the denoiser's Swin
# pass): forward launches, and launches inside the backward
SERVE_PER_BATCH = {"window_attention": 88, "shift_windows": 66,
                   "window_partition": 44, "window_reverse": 44}
TRAIN_PER_STEP = {"window_attention": (16, 16), "shift_windows": (12, 12),
                  "window_partition": (8, 8), "window_reverse": (8, 8)}
# the conv's backward at every distinct DiffUNet conv of an AMOS training
# batch (CONV_CASES' first 15 rows at N = 10); the stems' inputs need no
# gradient, so they have no dgrad
CONV_GRAD_N = 10
CONV_GRAD_REPORT = ("L0 conv_1", torch.bfloat16)
STEMS = ("encoder stem", "denoiser stem")
# weight-gradient launches of each of those convs in one AMOS train step
# (28 in all; the dgrad's are the same less the stems')
WGRAD_PER_STEP = {"encoder stem": 1, "denoiser stem": 1, "L0 conv_1": 3,
                  "L0 upcat": 1, "L1 conv_0": 2, "L1 conv_1": 3,
                  "L1 upcat": 1, "L2 conv_0": 2, "L2 conv_1": 3,
                  "L2 upcat": 1, "L3 conv_0": 2, "L3 conv_1": 3,
                  "L3 upcat": 1, "L4 conv_0": 2, "L4 conv_1": 2}
# (N, D, H, W), part channels, Cout, prologue of the Function's whole
# backward against autograd through the plain version
CONV_FUNCTION_CASES = [((2, 12, 12, 12), [64], 64, True),
                       ((1, 16, 16, 16), [64, 64], 64, False)]
# per AMOS train step: 10 convs in the encoder and 18 in the denoiser pass,
# the dgrad of all but the two stems, the wgrad of all
AMOS_TRAIN_STEPS = 4
AMOS_TRAIN_PER_STEP = {"conv3x3": 28, "conv3x3_dgrad": 26,
                       "conv3x3_wgrad": 28}
# the synthetic AMOS CTs of phases 7-8: a body of 96x192x192 voxels at the
# AMOS target spacing (9 windows of 96^3, 3 window batches at sw 4) in an
# int16 volume 4 voxels wider on each axis with air around the body, which
# the foreground crop removes; one ellipsoid organ for each of the 15 AMOS
# class ids. The second evaluation case is 88 voxels deep, thinner than
# the 96^3 ROI, which the Predictor pads up and crops back
AMOS_BODY = (96, 192, 192)
AMOS_EVAL_BODIES = [(96, 192, 192), (88, 192, 192)]
AMOS_SPACING = (1.5, 1.5, 2.0)
AMOS_CONV_PER_BATCH = 10 + 18 * 10      # embed + 10 denoiser passes
# the data_path trainer: 4 training and 2 validation cases, batch 2 (cut
# from the recipe's 10 so that 4 cases fill whole batches), 2 epochs, then
# a resume from epoch_1
AMOS_DATA_CASES = (4, 2)
AMOS_DATA_BATCH = 2
AMOS_DATA_EPOCHS = 2
# the MSD recipe (cfg/msd/train.yaml): batch 4, 2 classes without
# background; the conv checks at N 4 (bf16): the denoiser stem [image, 2
# classes] and the last level's convs; the same 28 / 26 / 28 conv launches
# a step as AMOS
MSD_TRAIN_STEPS = 4
MSD_CONV_CASES = [
    ("MSD denoiser stem", [1, 2], 64, 96, False),
    ("L0 conv_1", [64], 64, 96, True),
    ("L0 upcat", [64, 64], 64, 96, False),
]
# AttentionDiffUNet (features (32, 64, 128, 256, 512)) at the AMOS recipe:
# 10 convs in the encoder and 30 in the denoiser (10 ConvBNReLU2 convs,
# and in each of the 4 gated stages an UpConv, a ConvBNReLU2 and a
# TwoConv); per train step the dgrad of all but the two stems
ATT_CONV_PER_BATCH = 10 + 30 * 10      # embed + 10 denoiser passes
ATT_TRAIN_PER_STEP = {"conv3x3": 40, "conv3x3_dgrad": 38,
                      "conv3x3_wgrad": 40}
# its Cout-32 convs at 96^3 (7 of the denoiser's 30, 53% of its conv
# operations): (tag, part channels, broadcast ReLU prologue); forward at
# the serving and training batches, the backward at the training batch
ATT_COUT32_CASES = [("denoiser head", [1, 15], False),
                    ("ConvBNReLU2 conv_1", [32], True),
                    ("gated stage conv_0", [32, 32], False)]
ATT_COUT32_N = (4, 10)
# one 32 -> 32 ConvBNReLU2 at the training batch, kernel chain against the
# plain chain, as a fraction of max |plain|: two convs, each within
# KERNEL_TOL (2^-6) of the other's, with a batch norm between
BN_CHAIN_TOL = 2.0 ** -5
# the AMOS recipe with the JAX Trainer's keys: 4 calls of batch 10, an
# update every second one
AMOS_KEYS = dict(ema_rate=0.9999, accum_steps=2, t_sampler="loss_aware")
AMOS_KEYS_CALLS = 4
# the plain Swin-UNETR baseline at BTCV widths: one Swin pass per train
# step (forward, backward launches) and per serving window batch
SWIN_UNETR_STEPS = 8
SWIN_UNETR_PER_STEP = {"window_attention": (8, 8), "shift_windows": (6, 6),
                       "window_partition": (4, 4), "window_reverse": (4, 4)}
SWIN_UNETR_PER_BATCH = {"window_attention": 8, "shift_windows": 6,
                        "window_partition": 4, "window_reverse": 4}
# HybridMIM pretraining at examples/pretrain_mim.py's defaults: features
# (64, 64, 128, 256, 512, 64), batch 2 of 64^3, mask_patch 16, float32. A
# step runs 28 forward convs (10 in view 1's encoder, 8 in the decoder, 10
# in view 2's encoder under no_grad), the dgrad of the 18 with a gradient
# but view 1's stem (its input needs none) and the wgrad of those 18
MIM_STEPS = 6
MIM_BATCH, MIM_SIZE = 2, 64
MIM_PER_STEP = {"conv3x3": 28, "conv3x3_dgrad": 17, "conv3x3_wgrad": 18}
# its distinct convs: (tag, part channels, Cout, side, prologue, launches a
# step forward, dgrad, wgrad); the decoder's crops are 32^3 down to 4^3
MIM_CONV_CASES = [
    ("stem", [1], 64, 64, False, 2, 0, 1),
    ("L0 conv_1", [64], 64, 64, True, 2, 1, 1),
    ("L1 conv_0", [64], 64, 32, False, 2, 1, 1),
    ("L1 conv_1, up_3 conv_1", [64], 64, 32, True, 3, 2, 2),
    ("up_3 conv_0", [64, 64], 64, 32, False, 1, 1, 1),
    ("L2 conv_0", [64], 128, 16, False, 2, 1, 1),
    ("L2 conv_1", [128], 128, 16, True, 2, 1, 1),
    ("up_2 conv_0", [64, 64], 64, 16, False, 1, 1, 1),
    ("up_2 conv_1", [64], 64, 16, True, 1, 1, 1),
    ("L3 conv_0", [128], 256, 8, False, 2, 1, 1),
    ("L3 conv_1", [256], 256, 8, True, 2, 1, 1),
    ("up_1 conv_0", [128, 128], 128, 8, False, 1, 1, 1),
    ("up_1 conv_1", [128], 128, 8, True, 1, 1, 1),
    ("L4 conv_0", [256], 512, 4, False, 2, 1, 1),
    ("L4 conv_1", [512], 512, 4, True, 2, 1, 1),
    ("up_0 conv_0", [256, 256], 256, 4, False, 1, 1, 1),
    ("up_0 conv_1", [256], 256, 4, True, 1, 1, 1),
]
# the conv of MIM_CONV_CASES whose float32 kernels the kernels line
# reports (the one that holds 60% of a step's forward operations)
MIM_REPORT = "L0 conv_1"
# the small HybridMIM of phase 4: widths, side, mask patch, batch, lr
SMALL_MIM = ((8, 8, 16, 32, 64, 8), 32, 8, 2, 1e-3)
# the paths whose launches the kernels line reports, in order of choice:
# this slice's path first
LAUNCH_ORDER = ("amos_ddpm", "amos_ddim_eta", "amos_ddim_reverse",
                "amos_vb_train", "amos_bpd", "btcv_int8_serve", "amos_int8_serve", "overfit_int8",
                "amos_continuous", "amos_attention_continuous",
                "btcv_continuous", "amos_test_continuous",
                "mim_pretrain", "amos_attention_train",
                "amos_attention_serve", "amos_smooth_train",
                "amos_smooth_serve", "msd_train",
                "amos_train_ema", "swin_unetr_train",
                "swin_unetr_serve", "amos_test", "amos_train_data",
                "amos_train", "btcv_train", "btcv_serve", "amos_serve")
# phase 5m, continuous serving: the AMOS stream (phase 5b's three shapes and
# a second 96x192x192: 25 windows, 7 batches of unit 4 against 9 serial
# ones), AttentionDiffUNet's two 96x192x192 volumes (18 windows: 4, 4, 4,
# 4, 2), BTCV's 96x192x192 and 80x160x176 (unit 2)
CONT_SHAPES = ((96, 192, 192), (80, 160, 176), (96, 96, 96), (96, 192, 192))
CONT_ATT_SHAPES = ((96, 192, 192), (96, 192, 192))
CONT_BTCV_SHAPES = ((96, 192, 192), (80, 160, 176))
# continuous against serial: a volume whose every window runs at the same
# batch size on both paths must give the same bits (the samples of a batch
# are computed apart); a window in a batch of another size rounds its bf16
# sums in another order (``conv_plan`` splits a small grid's channel
# chunks by the batch), and such flips pass through the model as in phase
# 4: logits within CONT_TOL of max |y|. Each binary is sigmoid(logit) >
# 0.5, so the binaries differ only where the logits straddle 0: 0.11% of
# the voxels of a 96^3 volume whose one window ran at batch 1 against 4
# (H100, random weights); CONT_FLIPS bounds that share, where a misplaced
# window would flip about half of its voxels
CONT_TOL = SMOOTH_BF16_TOL
CONT_FLIPS = 1e-2
EDT_SHAPE = (96, 192, 192)
EDT_TOL = 1e-6                          # of the largest distance
METRIC_TOL = 1e-6
# phase 11, the diffusion core: the small model's widths, side and classes
# (card against CPU within MODEL_TOL of max |y|; the toy's gradients
# within ATT_GRAD_TOL of the largest), the bits-per-dim loop's respaced
# steps there, the full-width training_losses batch and loss types, and
# the full-width bits-per-dim loop's batch (over the whole 1000-step
# train schedule)
CORE_SMALL = ((8, 8, 16, 32, 64, 8), 32, 3)
CORE_BPD_STEPS = 20
CORE_TRAIN_N = 2
CORE_LOSSES = ("mse", "rescaled_kl")
CORE_BPD_N = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def conv_bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """``bound`` for the conv kernels: float32 runs on the tensor cores as
    3xTF32, so its operations count three tf32 products each
    (TF32X3_FLOP_PER_S), with the bound at the FFMA rate beside it
    (``ffma_bound_ms``)."""
    if dtype != torch.float32:
        return bound(nbytes, flops, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32X3_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ffma_bound_ms=bound(nbytes, flops, dtype)["bound_ms"])


def bound_text(bnd: dict) -> str:
    """``bound X ms (by)``, float32 convs with their FFMA bound beside."""
    ffma = bnd.get("ffma_bound_ms")
    return (f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
            + ("" if ffma is None else f", 3xTF32; FFMA {ffma:.4f} ms")
            + ")")


def repeat_equal(fn, first) -> bool:
    """Whether a second run of ``fn`` gives ``first``'s bits (a tensor or
    a tuple of tensors)."""
    again = fn()
    torch.cuda.synchronize()
    pairs = (zip(first, again) if isinstance(first, tuple)
             else [(first, again)])
    return all(torch.equal(a, b) for a, b in pairs)


def softmax_floor_ms(exps: float, clock_hz: float) -> float:
    """The least time the SFUs take for ``exps`` exponentials: 16 per clock
    per SM at the SM clock ``clock_hz``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (16 * sms * clock_hz) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call: the stream is held by a spinning kernel while the
    host queues every call, so the events time the device and not the
    host's issue rate (a small kernel's wrapper takes longer on the host
    than the kernel on the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card() -> tuple:
    """The nvidia-smi name and power limit line, and the maximum SM clock
    in Hz."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if clk.returncode != 0:
        fail(f"nvidia-smi failed: {clk.stderr.strip()}")
    log(f"max SM clock {clk.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    return card, float(clk.stdout.split()[0]) * 1e6


def short_name(mangled: str) -> str:
    """A kernel's name and the start of its template arguments, out of its
    mangled name."""
    i, names = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return (names[-1] + mangled[i:i + 12]) if names else mangled[:60]


def phase_build() -> set:
    """Build the kernels; fail on spills or serialised wgmma. Returns the
    instances checked."""
    from diff_unet_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.load()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_native.build_info['seconds']:.2f} s) "
        f"-> {_native.build_info['path']}")
    # ptxas -v: each entry function's properties (stack and spills), then
    # its registers; the conv, weight-gradient and bf16 attention kernels
    # must not spill, and no kernel may have its wgmma serialised
    name, spills, checked = "", [], set()
    warnings = [line.strip() for line in _native.build_info["log"]
                .splitlines() if WGMMA_WARNING.search(line)]
    for line in _native.build_info["log"].splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill" in line or "registers" in line:
            log(f"  ptxas: {short_name(name)}: {line.strip()}")
            if any(k in name for k in NO_SPILL_KERNELS) and "spill" in line:
                checked.add(short_name(name))
                if (" 0 bytes spill stores, 0 bytes spill loads"
                        not in line):
                    spills.append(f"{short_name(name)}: {line.strip()}")
    log(f"  no spills and no serialised wgmma checked in {len(checked)} "
        f"instances: {', '.join(sorted(checked))}")
    if spills:
        fail("kernels spill: " + "; ".join(spills))
    if warnings:
        fail("ptxas serialised wgmma: " + "; ".join(warnings))
    return checked


def attention_library_ms(qkv: torch.Tensor, bias: torch.Tensor,
                         ids) -> float:
    """``scaled_dot_product_attention`` over the same q, k, v views with the
    bias and the shifted-window region mask as its ``attn_mask``."""
    bw, n, _, h, _ = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mask = bias[None]
    if ids is not None:
        region = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        mask = (mask + region[:, None]).repeat(bw // ids.shape[0], 1, 1, 1)
    mask = mask.to(qkv.dtype)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))


def attention_backward_library_ms(qkv: torch.Tensor, bias: torch.Tensor,
                                  ids, cot: torch.Tensor) -> float:
    """``torch.autograd.grad`` of qkv and the f32 bias through
    ``scaled_dot_product_attention``, the bias (plus the region mask) as a
    float ``attn_mask`` in the compute dtype: the backward alone, on a
    graph built once."""
    bw, n, _, h, _ = qkv.shape
    q_in = qkv.detach().clone().requires_grad_()
    b_in = bias.detach().clone().requires_grad_()
    q, k, v = (q_in[:, :, i].transpose(1, 2) for i in range(3))
    mask = b_in[None]
    if ids is not None:
        region = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        mask = (mask + region[:, None]).repeat(bw // ids.shape[0], 1, 1, 1)
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask.to(qkv.dtype)).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(
        out, (q_in, b_in), cot, retain_graph=True), reps=5, warmup=1)


def phase_attention(dev: torch.device, clock_hz: float) -> dict:
    """The attention's forward kernel against its plain version at every
    ATTN_CASES geometry, shifted and unshifted, fp32 and bf16."""
    from diff_unet_tpu_torch.ops.swin import window_region_ids
    from diff_unet_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)

    g = torch.Generator(device=dev).manual_seed(SEED)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, bw, h, n, grid in ATTN_CASES:
            for shifted in ((False, True) if grid else (False,)):
                qkv = torch.randn((bw, n, 3, h, 16), generator=g, device=dev
                                  ).to(dtype)
                bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
                ids = None
                if shifted:
                    dims = tuple(7 * k for k in grid)
                    ids = torch.from_numpy(window_region_ids(
                        dims, (7, 7, 7), (3, 3, 3))).to(dev)
                got = window_attention(qkv, bias, ids)
                want = window_attention_plain(qkv, bias, ids)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ms = cuda_ms(lambda: window_attention(qkv, bias, ids))
                plain_ms = cuda_ms(
                    lambda: window_attention_plain(qkv, bias, ids))
                library_ms = attention_library_ms(qkv, bias, ids)
                bnd = bound(nbytes(qkv, bias, ids, got),
                            4.0 * bw * h * n * n * 16, dtype)
                floor = softmax_floor_ms(bw * h * n * n, clock_hz)
                tag = (f"window_attention {name} {'shift' if shifted else 'noshift'}"
                       f" {str(dtype)[6:]} BW={bw} H={h} N={n}")
                log(f"{tag}: max_abs_err {err:.3e} (tol "
                    f"{ATTN_TOL[dtype]:.0e}) kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) softmax "
                    f"floor {floor:.4f} ms")
                if not err <= ATTN_TOL[dtype]:
                    fail(f"{tag} disagrees with its plain version")
                if name == "stage1" and shifted and dtype == torch.bfloat16:
                    report["window_attention"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bnd,
                        softmax_floor_ms=floor)
                del qkv, bias, ids, got, want
    return report


def phase_shift(dev: torch.device) -> dict:
    """The window shift forward and inverse, bit-exact."""
    from diff_unet_tpu_torch.ops.window_shift import (
        shift_table, shift_windows, shift_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED)
    report = {}
    for grid, c in SHIFT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((2 * int(np.prod(grid)), 343, c), generator=g,
                            device=dev).to(dtype)
            for ss in ((3, 3, 3), (-3, -3, -3)):
                got = shift_windows(x, (7, 7, 7), ss, grid)
                want = shift_windows_plain(x, (7, 7, 7), ss, grid)
                exact = torch.equal(got, want)
                ms = cuda_ms(lambda: shift_windows(x, (7, 7, 7), ss, grid))
                plain_ms = cuda_ms(
                    lambda: shift_windows_plain(x, (7, 7, 7), ss, grid))
                table = torch.from_numpy(shift_table(
                    (7, 7, 7), ss, grid)).to(dev)
                rows = x.view(2, -1, c)
                idx = table.long()
                library_ms = cuda_ms(lambda: rows.index_select(1, idx))
                bnd = bound(nbytes(x, got, table), 0.0, dtype)
                tag = (f"shift_windows grid={grid} C={c} ss={ss} "
                       f"{str(dtype)[6:]}")
                log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                if not exact:
                    fail(f"{tag} is not bit-exact")
                if grid == (7, 7, 7) and ss[0] > 0 and dtype == torch.bfloat16:
                    report["shift_windows"] = dict(
                        max_abs_err=(got.float() - want.float()).abs().max()
                        .item(), ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bnd)
    return report


def phase_conv(dev: torch.device) -> dict:
    """The 3x3x3 conv kernel against its plain version at every CONV_CASES
    shape, bf16 and fp32, with kernel / plain / library times."""
    from diff_unet_tpu_torch.ops.conv3d import (
        KERNEL_TOL, STATS_TOL, conv3x3, conv3x3_plain)

    torch.backends.cudnn.allow_tf32 = False      # the library's fp32 is fp32
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    report = {}
    for tag, chans, cout, side, pro_on, stats, has_bias, act in CONV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (CONV_N, side, side, side)
            cin = sum(chans)
            parts = [torch.randn((*shape, c), generator=g, device=dev)
                     .to(dtype) for c in chans]
            w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
                / (27 * cin) ** 0.5
            b = (0.1 * torch.randn((cout,), generator=g, device=dev)
                 if has_bias else None)
            pro = None
            if pro_on:
                pro = tuple(torch.randn((CONV_N, cin), generator=g,
                                        device=dev) * sd + mu
                            for mu, sd in ((1.0, 0.3), (0.0, 0.3),
                                           (0.0, 0.2))) + (0.1,)
            kw = dict(prologue=pro, negative_slope=0.1 if act else None,
                      with_stats=stats)
            got = conv3x3(parts, w, b, **kw)
            want = conv3x3_plain(parts, w, b, **kw)
            torch.cuda.synchronize()
            same = repeat_equal(lambda: conv3x3(parts, w, b, **kw), got)
            st_err = st_tol = 0.0
            gst = None
            if stats:
                (got, gst), (want, wst) = got, want
                st_err = (gst - wst).abs().max().item()
                st_tol = STATS_TOL * wst.abs().max().item()
                del wst
            ref = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype] * ref
            del want
            reps = 3 if side == 96 else 10
            ms = cuda_ms(lambda: conv3x3(parts, w, b, **kw), reps, 1)
            plain_ms = cuda_ms(lambda: conv3x3_plain(parts, w, b, **kw),
                               reps, 1)
            x_cl = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cl = w.to(dtype).contiguous(
                memory_format=torch.channels_last_3d)
            b_l = None if b is None else b.to(dtype)

            def library():
                y = torch.nn.functional.conv3d(x_cl, w_cl, b_l, padding=1)
                if stats:
                    torch.var_mean(y, dim=(2, 3, 4))

            library_ms = cuda_ms(library, reps, 1)
            del x_cl
            flops = 2.0 * got.numel() * 27 * cin
            bnd = conv_bound(nbytes(*parts, got, gst, b, *(pro or ())[:3])
                             + w.numel() * got.element_size(), flops, dtype)
            name = (f"conv3x3 {tag} {str(dtype)[6:]} {chans}->{cout} at "
                    f"{CONV_N}x{side}^3")
            log(f"{name}: max_abs_err {err:.3e} (tol {tol:.3e})"
                + (f" stats err {st_err:.3e} (tol {st_tol:.3e})"
                   if stats else "")
                + f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                f"{library_ms:.4f} ms {bound_text(bnd)}, kernel "
                f"{flops / ms / 1e9:.1f} TFLOP/s, "
                f"{ms / library_ms:.2f}x the library, repeat "
                f"{'same bits' if same else 'DIFFERS'}")
            if not (err <= tol and st_err <= st_tol and same
                    and torch.isfinite(got).all()):
                fail(f"{name} disagrees with its plain version or with "
                     "itself")
            if (tag, dtype) == CONV_REPORT:
                report["conv3x3"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms,
                                         library_ms=library_ms, **bnd)
            del parts, got, gst
    return report


def conv_backward_library_ms(x_cl, w_cl, g_cl, mask, reps) -> float:
    """One ``aten.convolution_backward`` (cuDNN) on the channels-last views,
    the output mask picking the input gradient or the weight gradient."""
    return cuda_ms(lambda: torch.ops.aten.convolution_backward(
        g_cl, x_cl, w_cl, None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3,
        1, mask), reps, 1)


def phase_conv_backward(dev: torch.device) -> dict:
    """The conv's backward at every distinct DiffUNet conv of an AMOS
    training batch (N = CONV_GRAD_N), bf16 and fp32: dgrad (the forward
    kernel with the flipped weights) against ``conv3x3_dgrad_plain`` at
    KERNEL_TOL, the weight-gradient kernel against ``conv3x3_wgrad_plain``
    at WGRAD_TOL of max |plain|, each with kernel / plain / cuDNN times and
    the bound; then the Function's whole backward against autograd
    through the plain version at CONV_FUNCTION_CASES, within GRAD_TOL."""
    from diff_unet_tpu_torch.ops.conv3d import (
        GRAD_TOL, KERNEL_TOL, WGRAD_TOL, conv3x3, conv3x3_dgrad,
        conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad,
        conv3x3_wgrad_plain)

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    report = {}
    n = CONV_GRAD_N
    # launch-weighted sums over one AMOS step: kernel, cuDNN, bound ms
    step = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.bfloat16)}
    for tag, chans, cout, side, pro_on, *_ in CONV_CASES[:15]:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (n, side, side, side)
            cin = sum(chans)
            parts = [torch.randn((*shape, c), generator=g, device=dev)
                     .to(dtype) for c in chans]
            w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
                / (27 * cin) ** 0.5
            gy = torch.randn((*shape, cout), generator=g, device=dev
                             ).to(dtype)
            pro = None
            if pro_on:
                pro = tuple(torch.randn((n, cin), generator=g, device=dev)
                            * sd + mu for mu, sd in ((1.0, 0.3), (0.0, 0.3),
                                                     (0.0, 0.2))) + (0.1,)
            reps = 3 if side == 96 else 10
            x_cl = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cl = w.to(dtype).contiguous(
                memory_format=torch.channels_last_3d)
            g_cl = gy.permute(0, 4, 1, 2, 3)
            flops = 2.0 * gy.numel() * 27 * cin
            name = (f"{tag} {str(dtype)[6:]} {chans}->{cout} at "
                    f"{n}x{side}^3")
            if tag not in STEMS:
                got = conv3x3_dgrad(gy, w)
                want = conv3x3_dgrad_plain(gy, w)
                torch.cuda.synchronize()
                same = repeat_equal(lambda: conv3x3_dgrad(gy, w), got)
                tol = KERNEL_TOL[dtype] * max(
                    1.0, want.float().abs().max().item())
                err = (got.float() - want.float()).abs().max().item()
                del want
                ms = cuda_ms(lambda: conv3x3_dgrad(gy, w), reps, 1)
                plain_ms = cuda_ms(lambda: conv3x3_dgrad_plain(gy, w),
                                   reps, 1)
                library_ms = conv_backward_library_ms(
                    x_cl, w_cl, g_cl, [True, False, False], reps)
                bnd = conv_bound(nbytes(gy, got)
                                 + w.numel() * got.element_size(), flops,
                                 dtype)
                log(f"conv3x3_dgrad {name}: max_abs_err {err:.3e} (tol "
                    f"{tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                    f"library {library_ms:.4f} ms {bound_text(bnd)}, kernel "
                    f"{flops / ms / 1e9:.1f} TFLOP/s, "
                    f"{ms / library_ms:.2f}x the library, repeat "
                    f"{'same bits' if same else 'DIFFERS'}")
                if not (err <= tol and same and torch.isfinite(got).all()):
                    fail(f"conv3x3_dgrad {name} disagrees with its plain "
                         "version or with itself")
                if (tag, dtype) == CONV_GRAD_REPORT:
                    report["conv3x3_dgrad"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bnd)
                del got
            got = conv3x3_wgrad(gy, parts, pro)
            want = conv3x3_wgrad_plain(gy, parts, pro)
            torch.cuda.synchronize()
            same = repeat_equal(lambda: conv3x3_wgrad(gy, parts, pro), got)
            ref = want.abs().max().item()
            err = (got - want).abs().max().item()
            del want
            ms = cuda_ms(lambda: conv3x3_wgrad(gy, parts, pro), reps, 1)
            plain_ms = cuda_ms(lambda: conv3x3_wgrad_plain(gy, parts, pro),
                               reps, 1)
            library_ms = conv_backward_library_ms(
                x_cl, w_cl, g_cl, [False, True, False], reps)
            bnd = conv_bound(nbytes(gy, *parts, got, *(pro or ())[:3]),
                             flops, dtype)
            log(f"conv3x3_wgrad {name}: max_abs_err {err:.3e} of max|plain| "
                f"{ref:.3e} (tol {WGRAD_TOL[dtype]:.0e} of it) kernel "
                f"{ms:.4f} ms plain {plain_ms:.4f} ms library "
                f"{library_ms:.4f} ms {bound_text(bnd)} "
                f"({bnd['bound_ms'] / ms:.1%} of it), "
                f"kernel {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{ms / library_ms:.2f}x the library, repeat "
                f"{'same bits' if same else 'DIFFERS'}")
            for i, v in enumerate((ms, library_ms, bnd["bound_ms"])):
                step[dtype][i] += WGRAD_PER_STEP[tag] * v
            if not (err <= WGRAD_TOL[dtype] * ref and same
                    and torch.isfinite(got).all()):
                fail(f"conv3x3_wgrad {name} disagrees with its plain version "
                     "or with itself")
            if (tag, dtype) == CONV_GRAD_REPORT:
                report["conv3x3_wgrad"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, **bnd)
            del parts, gy, got, x_cl, g_cl
    for dtype, (ms, library_ms, bound_ms) in step.items():
        log(f"conv3x3_wgrad over one AMOS train step "
            f"({sum(WGRAD_PER_STEP.values())} launches, {str(dtype)[6:]}): "
            f"kernel {ms:.3f} ms library {library_ms:.3f} ms "
            f"({ms / library_ms:.2f}x) bound {bound_ms:.3f} ms "
            f"({bound_ms / ms:.1%} of it)")
    for shape, chans, cout, pro_on in CONV_FUNCTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            cin = sum(chans)
            leaves = [torch.randn((cout, cin, 3, 3, 3), generator=g,
                                  device=dev) / (27 * cin) ** 0.5,
                      0.1 * torch.randn((cout,), generator=g, device=dev)]
            if pro_on:
                leaves += [torch.randn((shape[0], cin), generator=g,
                                       device=dev) * sd + mu
                           for mu, sd in ((1.0, 0.3), (0.0, 0.3), (0.0, 0.2))]
            leaves += [torch.randn((*shape, c), generator=g, device=dev)
                       .to(dtype) for c in chans]
            cy = torch.randn((*shape, cout), generator=g, device=dev)
            cs = torch.randn((shape[0], 2, cout), generator=g, device=dev)
            grads = []
            for fn in (conv3x3, conv3x3_plain):
                inputs = [v.clone().requires_grad_() for v in leaves]
                pro = (*inputs[2:5], 0.1) if pro_on else None
                y, st = fn(inputs[5 if pro_on else 2:], inputs[0],
                           inputs[1], prologue=pro, with_stats=True)
                grads.append(torch.autograd.grad(
                    (y.float() * cy).sum() + (st * cs).sum(), inputs))
            errs = [((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
                    for a, b in zip(*grads)]
            log(f"conv3x3 Function backward {chans}->{cout} at {shape} "
                f"{str(dtype)[6:]}{' prologue' if pro_on else ''}: worst "
                f"gradient error {max(errs):.3e} of its max|g| against "
                f"autograd through the plain version (tol "
                f"{GRAD_TOL[dtype]:.0e})")
            if not max(errs) <= GRAD_TOL[dtype]:
                fail("the conv's Function backward disagrees with autograd "
                     "through the plain version")
    return report


def reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        for attr in ("backward_launches", "dgrad_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def partition_tables(padded, ws, valid):
    """int64 (nW*N,) padded-voxel index of every window row, and (valid
    voxels,) window row of every voxel of the cropped volume."""
    from diff_unet_tpu_torch.ops.window_shift import partition_np

    size = int(np.prod(padded))
    table = partition_np(np.arange(size).reshape(padded), ws).reshape(-1)
    row = np.empty(size, np.int64)
    row[table] = np.arange(size)
    inv = row.reshape(padded)[:valid[0], :valid[1], :valid[2]].reshape(-1)
    return table.astype(np.int64), inv


def phase_partition(dev: torch.device) -> dict:
    """Kernel 7 (partition with the pad fused, reverse with the crop fused)
    against the plain versions at the four Swin stage geometries."""
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, partition_windows_plain, reverse_windows,
        reverse_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    report = {}
    for name, side, c, w in PARTITION_CASES:
        ws, dims = (w,) * 3, (side,) * 3
        pad = tuple((w - side % w) % w for _ in range(3))
        padded = tuple(side + p for p in pad)
        table, inv = (torch.from_numpy(a).to(dev)
                      for a in partition_tables(padded, ws, dims))
        for b in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((b, *dims, c), generator=g, device=dev
                                ).to(dtype)
                with torch.no_grad():
                    wt = partition_windows(x, ws, pad)
                    back = reverse_windows(wt, ws, padded, dims)
                exact = (torch.equal(wt, partition_windows_plain(x, ws, pad))
                         and torch.equal(back, reverse_windows_plain(
                             wt, ws, padded, dims))
                         and torch.equal(back, x))
                rows = torch.nn.functional.pad(
                    x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0])).view(b, -1, c)
                wrows = wt.view(b, -1, c)
                with torch.no_grad():
                    times = {
                        "window_partition": (
                            cuda_ms(lambda: partition_windows(x, ws, pad)),
                            cuda_ms(lambda: partition_windows_plain(x, ws,
                                                                    pad)),
                            cuda_ms(lambda: rows.index_select(1, table)),
                            bound(nbytes(x, wt), 0.0, dtype)),
                        "window_reverse": (
                            cuda_ms(lambda: reverse_windows(wt, ws, padded,
                                                            dims)),
                            cuda_ms(lambda: reverse_windows_plain(
                                wt, ws, padded, dims)),
                            cuda_ms(lambda: wrows.index_select(1, inv)),
                            # the valid rows read, the volume written
                            bound(2 * nbytes(x), 0.0, dtype)),
                    }
                for kernel, (ms, plain_ms, library_ms, bnd) in times.items():
                    tag = (f"{kernel} {name} {dims}->{padded} C={c} B={b} "
                           f"{str(dtype)[6:]}")
                    log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                        f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                    # the training batch's largest call is the one reported
                    if (name, b, dtype) == ("stage1", 1, torch.bfloat16):
                        report[kernel] = dict(
                            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, **bnd)
                if not exact:
                    fail(f"window partition {name} B={b} {dtype} is not "
                         "bit-exact")
                del x, wt, back, rows, wrows
    return report


def phase_backward(dev: torch.device) -> dict:
    """The shift's backward kernel and the partition pair's adjoints
    against autograd through the plain versions (bit-exact)."""
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, partition_windows_plain)
    from diff_unet_tpu_torch.ops.window_shift import (
        shift_table, shift_windows, shift_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    report = {}
    for grid, c in SHIFT_CASES:
        ws, ss = (7, 7, 7), (3, 3, 3)
        inv = tuple(-s for s in ss)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((int(np.prod(grid)), 343, c), generator=g,
                            device=dev).to(dtype)
            cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
            grads = []
            for fn in (shift_windows, shift_windows_plain):
                xg = x.clone().requires_grad_()
                fn(xg, ws, ss, grid).backward(cot)
                grads.append(xg.grad)
            exact = torch.equal(*grads)
            with torch.no_grad():
                ms = cuda_ms(lambda: shift_windows(cot, ws, inv, grid))
                plain_ms = cuda_ms(
                    lambda: shift_windows_plain(cot, ws, inv, grid))
                table = torch.from_numpy(shift_table(ws, inv, grid)).to(
                    dev).long()
                library_ms = cuda_ms(
                    lambda: cot.view(1, -1, c).index_select(1, table))
            # the cotangent read, the gradient written, the int32 table
            bnd = bound(2 * nbytes(cot) + 4 * table.numel(), 0.0, dtype)
            tag = f"shift_windows backward grid={grid} C={c} {str(dtype)[6:]}"
            log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            if not exact:
                fail(f"{tag} is not bit-exact")
            if grid == (7, 7, 7) and dtype == torch.bfloat16:
                report["shift_windows_backward"] = dict(
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, **bnd)
    for name, side, c, w in PARTITION_CASES:
        ws, dims = (w,) * 3, (side,) * 3
        pad = tuple((w - side % w) % w for _ in range(3))
        x = torch.randn((1, *dims, c), generator=g, device=dev
                        ).to(torch.bfloat16)
        xg, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        wt = partition_windows(xg, ws, pad)
        cot = torch.randn(wt.shape, generator=g, device=dev).to(x.dtype)
        wt.backward(cot)
        partition_windows_plain(xp, ws, pad).backward(cot)
        log(f"window_partition backward (window_reverse) {name}: bit-exact "
            f"{torch.equal(xg.grad, xp.grad)}")
        if not torch.equal(xg.grad, xp.grad):
            fail(f"window partition backward {name} is not bit-exact")
    return report


def attention_grad_bound(qkv, bias, ids, lse, cot, dtype) -> dict:
    """qkv, bias, region ids, lse and dout read once, dqkv and the f32
    dbias written once; the products S, dP, dV, dK and dQ (2 Dh operations
    a score each)."""
    bw, n, _, h, dh = qkv.shape
    return bound(2 * nbytes(qkv) + 2 * nbytes(bias) + nbytes(ids, lse, cot),
                 10.0 * bw * h * n * n * dh, dtype)


def phase_attention_backward(dev: torch.device, clock_hz: float) -> dict:
    """The attention's backward kernel at the training batch's stage
    geometries, fp32 and bf16: against ``window_attention_backward_plain``
    and against autograd through the plain version, with the times of the
    kernel, of autograd through the port, through the plain version and
    through ``scaled_dot_product_attention``."""
    from diff_unet_tpu_torch.ops import window_attention as wa
    from diff_unet_tpu_torch.ops.swin import window_region_ids

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, bw, h, n, shifted in ATTN_GRAD_CASES:
            qkv = torch.randn((bw, n, 3, h, 16), generator=g, device=dev
                              ).to(dtype)
            bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
            ids = None
            if shifted:
                grid = round(bw ** (1 / 3)) * 7
                ids = torch.from_numpy(window_region_ids(
                    (grid,) * 3, (7, 7, 7), (3, 3, 3))).to(dev)
            cot = torch.randn((bw, n, h, 16), generator=g, device=dev
                              ).to(dtype)
            grads, times = [], []
            before = (wa.window_attention.launches,
                      wa.window_attention.backward_launches)
            for fn in (wa.window_attention, wa.window_attention_plain):
                q = qkv.clone().requires_grad_()
                b = bias.clone().requires_grad_()
                out = fn(q, b, ids)
                grads.append(torch.autograd.grad(out, (q, b), cot,
                                                 retain_graph=True))
                times.append(cuda_ms(lambda: torch.autograd.grad(
                    out, (q, b), cot, retain_graph=True), reps=5, warmup=1))
                del out
            if (wa.window_attention.launches - before[0],
                    wa.window_attention.backward_launches - before[1]) != (
                        1, 7):
                fail("the attention's autograd did not run the forward "
                     "kernel once and the backward kernel for each grad")
            direct = wa.window_attention_backward_plain(qkv, bias, ids, cot)
            errs = [((a.float() - w.float()).abs().max()
                     / w.float().abs().max()).item()
                    for want in (grads[1], direct)
                    for a, w in zip(grads[0], want)]
            _, lse = wa._forward(qkv, bias, ids, with_stats=True)
            ms = cuda_ms(lambda: wa._backward(qkv, bias, ids, lse, cot),
                         reps=5, warmup=1)
            library_ms = attention_backward_library_ms(qkv, bias, ids, cot)
            bnd = attention_grad_bound(qkv, bias, ids, lse, cot, dtype)
            floor = softmax_floor_ms(bw * h * n * n, clock_hz)
            tag = (f"window_attention backward {name} BW={bw} H={h} N={n} "
                   f"{str(dtype)[6:]}")
            log(f"{tag}: qkv / bias grad err {errs[0]:.3e} / {errs[1]:.3e} "
                f"of max|g| against autograd through the plain version, "
                f"{errs[2]:.3e} / {errs[3]:.3e} against "
                f"window_attention_backward_plain (tol "
                f"{ATTN_TOL[dtype]:.0e}); kernel {ms:.4f} ms, autograd "
                f"through the port {times[0]:.4f} ms, plain backward "
                f"{times[1]:.4f} ms, library {library_ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), softmax "
                f"floor {floor:.4f} ms")
            if not max(errs) <= ATTN_TOL[dtype]:
                fail(f"{tag} disagrees with the plain backward")
            if name == "stage1" and dtype == torch.bfloat16:
                report["window_attention_backward"] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=times[1],
                    library_ms=library_ms, **bnd, softmax_floor_ms=floor,
                    autograd_ms=times[0])
            del qkv, bias, cot, grads, direct, lse
    return report


def phase_small_model(dev: torch.device) -> None:
    from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, classes = 32, 3
    cpu = init_random(DiffSwinUNETR(classes, image_size=(s,) * 3,
                                    feature_size=12), SEED).eval()
    gpu = DiffSwinUNETR(classes, image_size=(s,) * 3, feature_size=12)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.standard_normal((2, s, s, s, 1),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((2, s, s, s, classes),
                                             np.float32))
    t = torch.tensor([5, 250])
    with torch.inference_mode():
        want = cpu.denoise(image, x, t)
        got = gpu.denoise(image.to(dev), x.to(dev), t.to(dev)).cpu()
    err = (got - want).abs().max().item()
    log(f"small model denoise (feature 12, {s}^3, fp32, TF32 off) cuda vs "
        f"cpu: max_abs_err {err:.3e} (tol {MODEL_TOL:.0e}, max|y| "
        f"{want.abs().max().item():.3f})")
    if not (torch.isfinite(got).all() and err <= MODEL_TOL):
        fail("small DiffSwinUNETR on the card disagrees with the CPU")


def phase_small_diff_unet(dev: torch.device) -> None:
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    s, classes, fea = 32, 3, (8, 8, 16, 32, 64, 8)
    cpu = init_random(DiffUNet(classes, features=fea), SEED).eval()
    gpu = DiffUNet(classes, features=fea)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.standard_normal((2, s, s, s, 1),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((2, s, s, s, classes),
                                             np.float32))
    t = torch.tensor([5, 250])
    with torch.inference_mode():
        want = cpu.denoise(image, x, t)
        got = gpu.denoise(image.to(dev), x.to(dev), t.to(dev)).cpu()
    err = (got - want).abs().max().item()
    log(f"small DiffUNet denoise (features {fea}, {s}^3, fp32, TF32 off) "
        f"cuda vs cpu: max_abs_err {err:.3e} (tol {MODEL_TOL:.0e}, max|y| "
        f"{want.abs().max().item():.3f})")
    if not (torch.isfinite(got).all() and err <= MODEL_TOL):
        fail("small DiffUNet on the card disagrees with the CPU")


def phase_small_unet(dev: torch.device, model_name: str) -> None:
    """A small SmoothDiffUNet or AttentionDiffUNet (``SMALL_UNETS``: widths
    and window) on the card against the same weights on the CPU's plain
    path, a batch of 2 different samples: embed and denoise in fp32 (TF32
    off, within MODEL_TOL) and in bf16 (the plain versions round where the
    kernels do and sum in another order: within SMOOTH_BF16_TOL of max
    |y|)."""
    from diff_unet_tpu_torch.models.model_hub import create_model
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (d, hw, _), fea = SMALL_UNETS[model_name]
    classes = 3
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.standard_normal((2, d, hw, hw, 1),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((2, d, hw, hw, classes),
                                             np.float32))
    t = torch.tensor([5, 250])

    def build(dtype):
        return create_model(model_name, out_channels=classes, image_size=hw,
                            spatial_size=d, features=fea, dtype=dtype)

    for dtype, tol in ((None, MODEL_TOL),
                       (torch.bfloat16, SMOOTH_BF16_TOL)):
        cpu = init_random(build(dtype), SEED).eval()
        gpu = build(dtype)
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.to(dev).eval()
        with torch.inference_mode():
            want = [*cpu.embed(image), cpu.denoise(image, x, t)]
            got = [*gpu.embed(image.to(dev)),
                   gpu.denoise(image.to(dev), x.to(dev), t.to(dev))]
        errs = [(g.cpu().float() - w.float()).abs().max().item()
                / w.float().abs().max().item() for g, w in zip(got, want)]
        name = "fp32, TF32 off" if dtype is None else "bf16"
        log(f"small {model_name} (features {fea}, {d}x{hw}x{hw}, {name}) "
            f"cuda vs cpu, error / max|y| of the {len(got) - 1} encoder "
            f"levels and the logits: {[f'{e:.2e}' for e in errs]} (tol "
            f"{tol:.0e})")
        if not (all(torch.isfinite(g).all() for g in got)
                and max(errs) <= tol):
            fail(f"small {model_name} ({name}) on the card disagrees with "
                 "the CPU")


def phase_small_train(dev: torch.device, model_name: str) -> None:
    """Two train steps of a small model on the card and on the CPU from the
    same weights, t and noise (fp32, TF32 off): DiffSwinUNETR (feature 12),
    DiffUNet, SmoothDiffUNet or AttentionDiffUNet (every conv forward and
    backward on the conv kernels; DiffUNet at features (8, 8, 16, 32, 64,
    8), the other two at SMALL_UNETS': SmoothDiffUNet's layer-norm
    denoiser's bias-only convs and its smoothing weights' gradients;
    AttentionDiffUNet on a batch of 2, its batch-norm chains, judged on
    the model's largest gradient within ATT_GRAD_TOL). The conv models'
    second step starts from the
    CPU's parameters on both sides: Adam's first update is lr * sign(g)
    even where g is rounding noise (conv biases before an instance norm,
    other near-zero gradients), and its 2^3 instance norms amplify such
    sign flips into gradient differences of up to ~1e-2 at the next step,
    which would measure the flips, not the backward. Their card step
    is also run a second time from the same start and must give the same
    bits: no float atomics on its path (the conv statistics and split
    sums are added in a fixed order), so a LeakyReLU input within rounding
    of 0 takes the same side on every run."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.losses import CompositeLoss
    from diff_unet_tpu_torch.models.model_hub import create_model
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, classes, lr = 32, 3, 2e-4
    conv = model_name in ("diff_unet", *SMALL_UNETS)
    kw = (dict(features=(8, 8, 16, 32, 64, 8)) if conv
          else dict(feature_size=12))
    shape = (s,) * 3
    if model_name in SMALL_UNETS:
        # SmoothDiffUNet's smoothing weights take D from spatial_size, H
        # and W from image_size
        shape, kw["features"] = SMALL_UNETS[model_name]
    # batch statistics need 2 different samples
    n = 2 if model_name == "attention_diff_unet" else 1
    rng = np.random.default_rng(SEED)
    steps = [(rng.random((n, *shape, 1), np.float32),
              np.eye(classes, dtype=np.float32)[
                  rng.integers(0, classes, (n, *shape))],
              np.array([int(rng.integers(0, 1000)) for _ in range(n)]),
              rng.standard_normal((n, *shape, classes), np.float32))
             for _ in range(2)]
    resync = conv

    def trainer(where):
        model = init_random(create_model(
            model_name, out_channels=classes, image_size=shape[1],
            spatial_size=shape[0], **kw), SEED).to(where)
        opt, schedule = make_optimizer(model.parameters(), lr=lr,
                                       weight_decay=1e-4)
        return model, TrainStep(DiffusionSegmenter(model, classes),
                                CompositeLoss("mse,bce,dice", classes),
                                opt, schedule)

    def run(model, step, where, image, labels, t, noise):
        m = step(torch.from_numpy(image).to(where),
                 torch.from_numpy(labels).to(where),
                 t=torch.from_numpy(t).to(where),
                 noise=torch.from_numpy(noise).to(where))
        return (m["loss"].item(), m["grad_norm"].item(),
                [p.grad.detach().cpu().clone() for p in model.parameters()])

    models, trainers, records = [], [], ([], [])
    for where in (torch.device("cpu"), dev):
        model, step = trainer(where)
        models.append(model)
        trainers.append(step)
    for k, batch in enumerate(steps):
        if resync and k:
            with torch.no_grad():
                for a, b in zip(models[0].parameters(),
                                models[1].parameters()):
                    b.copy_(a)
        for where, model, step, record in zip((torch.device("cpu"), dev),
                                              models, trainers, records):
            record.append(run(model, step, where, *batch))
    cpu, card = records
    reproducible = True
    if conv:
        again = run(*trainer(dev), dev, *steps[0])
        reproducible = again[0] == card[0][0] and all(
            torch.equal(a, b) for a, b in zip(again[2], card[0][2]))
        log(f"small {model_name} train step on the card run twice from the "
            f"same start: {'the same' if reproducible else 'different'} "
            "loss and gradients, bit for bit")
    cpu_params, card_params = ([p.detach().cpu() for p in m.parameters()]
                               for m in models)
    # AttentionDiffUNet's gradients on the model's largest (ATT_GRAD_TOL)
    batch_norm = model_name == "attention_diff_unet"
    grad_tol = ATT_GRAD_TOL if batch_norm else MODEL_TOL
    worst = [0.0, 0.0, 0.0]            # loss / grad norm rel, grad vs tol
    names = [n for n, _ in models[0].named_parameters()]
    worst_grad = ""
    for (lc, nc, gc), (lg, ng, gg) in zip(cpu, card):
        worst[0] = max(worst[0], abs(lg - lc) / abs(lc))
        worst[1] = max(worst[1], abs(ng - nc) / abs(nc))
        gmax = max(a.abs().max().item() for a in gc)
        for name, a, b in zip(names, gc, gg):
            # a tensor whose exact gradient is ~0 (a conv bias before an
            # instance norm) is judged on the model's gradient scale
            scale = (gmax if batch_norm
                     else max(a.abs().max().item(), 0.1 * gmax))
            err = (b - a).abs().max().item() / scale
            if err > worst[2]:
                worst[2], worst_grad = err, name
    # Adam moves a weight by about lr wherever |g| >> eps, whatever |g|, so
    # a gradient at rounding noise (a conv bias before an instance norm)
    # may take the other sign on the card: 2 lr per step apart at most
    ptol = 2 * lr * (1 if resync else len(steps))
    perrs = [(a - b).abs().max().item()
             for a, b in zip(cpu_params, card_params)]
    i = int(np.argmax(perrs))
    gmax = max(a.abs().max().item() for a in cpu[-1][2])
    log(f"small {model_name} train steps ({kw}, {shape}, fp32, TF32 off) "
        f"cuda vs cpu: loss rel {worst[0]:.3e}, grad norm rel "
        f"{worst[1]:.3e} (tol "
        f"{MODEL_TOL:.0e}); worst gradient error {worst[2]:.3e} of "
        f"{'the model max' if batch_norm else 'max(|g| max, 0.1 model max)'}"
        f" (tol {grad_tol:.0e}), {worst_grad}; parameters after "
        f"{len(steps)} steps"
        f"{' (the second from the same ones)' if resync else ''} "
        f"{perrs[i]:.3e} (tol {ptol:.0e}), worst "
        f"{names[i]} whose last |g| max is "
        f"{cpu[-1][2][i].abs().max().item() / gmax:.1e} of the model's; "
        f"losses {[round(r[0], 6) for r in cpu]}")
    if not (max(worst[:2]) <= MODEL_TOL and worst[2] <= grad_tol
            and perrs[i] <= ptol and reproducible
            and all(np.isfinite(r[0]) for r in card)):
        fail(f"small {model_name} train steps on the card disagree with "
             "the CPU")


def phase_serve(dev: torch.device, data: str, counters: dict,
                per_batch: dict, path: str = None,
                shapes=((96, 192, 192), (80, 160, 176), (96, 96, 96)),
                **overrides) -> dict:
    """Serve the synthetic volumes of ``shapes`` (after a warm-up on a 96^3
    one) with a Predictor built from ``cfg/<data>/test.yaml`` and
    ``overrides``; ``counters`` maps kernel names to their wrappers, whose
    counts are set to 0 just before and read just after; each must equal
    ``per_batch[name]`` times the window batches. The launches are
    returned under ``path`` (default ``<data>_serve``)."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / f"cfg/{data}/test.yaml", model_path=None,
        classes=str(ROOT / f"cfg/{data}/classes.yaml"), device=dev,
        seed=SEED, **overrides)
    log(f"predictor: {pred.model_name}, {pred.num_classes} classes, roi "
        f"{pred._inferer.roi}, sw_batch_size {pred.sw_batch_size}, overlap "
        f"{pred.overlap}, dtype {pred.dtype}, "
        f"{sum(p.numel() for p in pred.module.parameters())} parameters")
    volumes = [synthetic_ct(s, SEED + i, dev) for i, s in enumerate(shapes)]
    pred.infer(synthetic_ct((96, 96, 96), SEED + 9, dev))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset(counters)
    results, seconds = [], []
    for v in volumes:
        t0 = time.perf_counter()
        results.append(pred.serve([v])[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = {k: fn.launches for k, fn in counters.items()}
    backward = {k: getattr(fn, "backward_launches", 0)
                + getattr(fn, "dgrad_launches", 0)
                for k, fn in counters.items()}

    steps = pred.seg.sample_steps
    batches = 0
    for shape, (logits, binary), sec in zip(shapes, results, seconds):
        roi_padded = tuple(max(r, s) for r, s in zip(pred._inferer.roi, shape))
        n_win = len(pred._inferer._starts(roi_padded))
        n_batch = sum(len(starts) for starts, _ in
                      pred._inferer._geometry(roi_padded))
        batches += n_batch
        log(f"volume {shape}: {n_win} windows in {n_batch} batches, "
            f"{sec:.3f} s, {n_win * steps / sec:.3f} DDIM window-steps/s")
        want = (*shape, pred.num_classes)
        if tuple(logits.shape) != want or tuple(binary.shape) != want:
            fail(f"output shape {tuple(logits.shape)} != {want}")
        if not torch.isfinite(logits).all():
            fail(f"non-finite logits for volume {shape}")
        if not ((binary == 0) | (binary == 1)).all():
            fail("binary output is not {0, 1}")
    log(f"peak device memory while serving: "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    path = path or f"{data}_serve"
    log(f"launches during {path} ({batches} window batches): {counts}")
    for k, c in counts.items():
        if c != per_batch[k] * batches or backward[k]:
            fail(f"kernel {k}: {c} launches ({backward[k]} in a backward), "
                 f"predicted {per_batch[k]} x {batches} = "
                 f"{per_batch[k] * batches}")
    return {k: {path: c} for k, c in counts.items()}


def phase_train(dev: torch.device, counters: dict) -> dict:
    """``Trainer.from_config("cfg/btcv/train.yaml")`` at full width on
    synthetic batches for ``TRAIN_STEPS`` steps; returns each counter's
    (forward, backward) launches."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer

    t0 = time.perf_counter()
    data = SyntheticSegmentation((96, 96, 96), num_labels=14, batch_size=1,
                                 batches=TRAIN_STEPS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/btcv/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/btcv/classes.yaml"), seed=SEED,
        max_epochs=1)
    torch.cuda.synchronize()
    log(f"trainer: {trainer.model_name}, {trainer.num_classes} classes, "
        f"patch {trainer._inferer.roi}, batch {trainer.batch_size}, dtype "
        f"{trainer.dtype}, label smoothing {trainer.label_smoothing}, "
        f"{sum(p.numel() for p in trainer.module.parameters())} parameters; "
        f"set-up (data, smoothing, model) {time.perf_counter() - t0:.1f} s")
    before = [p.detach().clone() for p in trainer.module.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    reset(counters)
    trainer.train()
    torch.cuda.synchronize()
    counts = {k: (fn.launches, getattr(fn, "backward_launches", 0))
              for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = trainer.history
    moved = sum(int(not torch.equal(a, p))
                for a, p in zip(before, trainer.module.parameters()))
    log("train steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f} lr "
        f"{h['lr']:.3e}" for h in hist))
    log(f"launches during BTCV training ({len(hist)} steps), (forward, "
        f"backward): {counts}")
    # s/step: the trainer's step over its batches once more, the card
    # synchronised before and after each step (after the counts are read)
    step_s = []
    for image, labels in trainer.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(image, labels, generator=trainer.generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"train: median {np.median(step_s[1:]):.4f} s/step over steps "
        f"2..{len(step_s)} of a synchronised pass, {step_s}; peak device "
        f"memory {peak:.2f} GiB over the {len(hist)} steps of train(); "
        f"{moved} of {len(before)} parameter tensors moved")
    if len(hist) != TRAIN_STEPS:
        fail(f"the trainer took {len(hist)} steps, not {TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in hist):
        fail("a train step has a non-finite loss or a zero grad norm")
    if hist[0]["lr"] != 0.0 or not moved:
        fail("the parameters did not move once the lr was above 0")
    for k, (fwd, bwd) in counts.items():
        want = tuple(n * len(hist) for n in TRAIN_PER_STEP[k])
        if (fwd, bwd) != want:
            fail(f"kernel {k}: {(fwd, bwd)} launches (forward, backward) in "
                 f"{len(hist)} steps, predicted {want}")
    return counts


def phase_train_amos(dev: torch.device, model_name: str = "diff_unet",
                     per_step: dict = AMOS_TRAIN_PER_STEP) -> dict:
    """``Trainer.from_config("cfg/amos/train.yaml")`` at full width
    (DiffUNet, or with ``model_name`` SmoothDiffUNet, features (64, 64,
    128, 256, 512, 64), or AttentionDiffUNet, features (32, 64, 128, 256,
    512); 15 classes) on synthetic batches of 10 patches of 96^3 with 16
    label values, for ``AMOS_TRAIN_STEPS`` steps: finite losses, grad
    norms above 0, moved parameters (every smoothing weight among them;
    every AttentionDiffUNet parameter), and exactly ``per_step`` conv
    launches a step (forward, dgrad, wgrad); then the median synchronised
    s/step and the peak device memory. Returns the launches of
    ``train()``, the median s/step and the peak memory in GiB."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad, \
        packed_weight

    t0 = time.perf_counter()
    data = SyntheticSegmentation((96, 96, 96), num_labels=16, batch_size=10,
                                 batches=AMOS_TRAIN_STEPS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/amos/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/amos/classes.yaml"), seed=SEED,
        max_epochs=1, model_name=model_name)
    torch.cuda.synchronize()
    names = [n for n, _ in trainer.module.named_parameters()]
    smooth = sum(p.numel() for n, p in trainer.module.named_parameters()
                 if ".smooth_" in n)
    log(f"trainer: {trainer.model_name}, {trainer.num_classes} classes, "
        f"patch {trainer._inferer.roi}, batch {trainer.batch_size}, dtype "
        f"{trainer.dtype}, label smoothing {trainer.label_smoothing}, "
        f"{sum(p.numel() for p in trainer.module.parameters())} parameters"
        f"{f' ({smooth} smoothing weights)' if smooth else ''}; "
        f"set-up (data, model) {time.perf_counter() - t0:.1f} s")
    before = [p.detach().clone() for p in trainer.module.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    conv3x3.launches = conv3x3.dgrad_launches = conv3x3_wgrad.launches = 0
    packs = packed_weight.packs
    trainer.train()
    torch.cuda.synchronize()
    counts = {"conv3x3": conv3x3.launches,
              "conv3x3_dgrad": conv3x3.dgrad_launches,
              "conv3x3_wgrad": conv3x3_wgrad.launches}
    packs = packed_weight.packs - packs
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = trainer.history
    still = [n for n, a, p in zip(names, before, trainer.module.parameters())
             if torch.equal(a, p)]
    moved = len(names) - len(still)
    log(f"AMOS {model_name} train steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f} lr "
        f"{h['lr']:.3e}" for h in hist))
    log(f"launches during AMOS {model_name} training ({len(hist)} steps): "
        f"{counts}; weight packs {packs}")
    step_s = []
    for image, labels in trainer.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(image, labels, generator=trainer.generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"AMOS {model_name} train: median {np.median(step_s[1:]):.4f} "
        f"s/step over steps 2..{len(step_s)} of a synchronised pass, "
        f"{step_s}; peak device memory {peak:.2f} GiB over the {len(hist)} "
        f"steps of train() (no activation checkpointing); {moved} of "
        f"{len(before)} parameter tensors moved")
    if any(".smooth_" in n for n in still):
        fail(f"smoothing weights did not move: {still}")
    if model_name == "attention_diff_unet" and still:
        fail(f"AttentionDiffUNet parameters did not move: {still}")
    if len(hist) != AMOS_TRAIN_STEPS:
        fail(f"the AMOS trainer took {len(hist)} steps, not "
             f"{AMOS_TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in hist):
        fail("an AMOS train step has a non-finite loss or a zero grad norm")
    if hist[0]["lr"] != 0.0 or not moved:
        fail("the AMOS parameters did not move once the lr was above 0")
    for k, c in counts.items():
        if c != per_step[k] * len(hist):
            fail(f"{k}: {c} launches in {len(hist)} AMOS train steps, "
                 f"predicted {per_step[k]} x {len(hist)}")
    return counts, float(np.median(step_s[1:])), peak


def phase_twoconv_norms(dev: torch.device) -> None:
    """One 64 -> 64 TwoConv (with the timestep FiLM) at 10 x 96^3 in bf16
    over fp32 parameters, forward and forward + backward (the input's and
    every parameter's gradient), CUDA-event ms: the instance-norm chain
    (statistics in the conv kernel, the first norm as the second conv's
    prologue) against the layer-norm chain (bias-only convs, the per-voxel
    norm, LeakyReLU and FiLM add in tensor code)."""
    from diff_unet_tpu_torch.ops.blocks import TEMB_FEATURES, TwoConv
    from diff_unet_tpu_torch.utils.weights import init_random

    n, side, c = 10, 96, 64
    g = torch.Generator(dev).manual_seed(SEED)
    x = torch.randn((n, side, side, side, c), generator=g, device=dev
                    ).to(torch.bfloat16).requires_grad_()
    temb = torch.randn((n, TEMB_FEATURES), generator=g, device=dev)
    dy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    times = {}
    for norm in ("instance", "layer"):
        block = init_random(TwoConv(c, c, norm=norm, dtype=torch.bfloat16),
                            SEED).to(dev)
        leaves = [x, *block.parameters()]

        def forward():
            with torch.no_grad():
                return block([x], temb)

        def both():
            return torch.autograd.grad(block([x], temb), leaves, dy)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times[norm] = (cuda_ms(forward, reps=5, warmup=2),
                       cuda_ms(both, reps=5, warmup=2),
                       torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del block, leaves
    (fi, bi, mi), (fl, bl, ml) = times["instance"], times["layer"]
    log(f"TwoConv 64->64 at {n}x{side}^3, bf16: forward instance {fi:.3f} "
        f"ms / layer {fl:.3f} ms ({fl / fi:.2f}x); forward + backward "
        f"instance {bi:.3f} ms / layer {bl:.3f} ms ({bl / bi:.2f}x); peak "
        f"memory {mi:.2f} / {ml:.2f} GiB")


def phase_cout32(dev: torch.device) -> None:
    """AttentionDiffUNet's Cout-32 convs at 96^3 (ATT_COUT32_CASES), bf16:
    the forward kernel against its plain version at N 4 and 10 (with the
    statistics), and at N 10 the dgrad (not at the stem) and the weight
    gradient against theirs, each with the kernel, cuDNN and bound times
    as phases 3b and 3e give them."""
    from diff_unet_tpu_torch.ops.conv3d import (
        KERNEL_TOL, STATS_TOL, WGRAD_TOL, conv3x3, conv3x3_dgrad,
        conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad,
        conv3x3_wgrad_plain)

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    dt, cout, side = torch.bfloat16, 32, 96
    for tag, chans, pro_on in ATT_COUT32_CASES:
        for n in ATT_COUT32_N:
            shape = (n, side, side, side)
            cin = sum(chans)
            parts = [torch.randn((*shape, c), generator=g, device=dev)
                     .to(dt) for c in chans]
            w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
                / (27 * cin) ** 0.5
            b = 0.1 * torch.randn((cout,), generator=g, device=dev)
            pro = None
            if pro_on:
                pro = (1.0 + 0.3 * torch.randn((1, cin), generator=g,
                                               device=dev).expand(n, -1),
                       0.3 * torch.randn((1, cin), generator=g,
                                         device=dev).expand(n, -1),
                       None, 0.0)
            kw = dict(prologue=pro, with_stats=True)
            (got, gst), (want, wst) = (conv3x3(parts, w, b, **kw),
                                       conv3x3_plain(parts, w, b, **kw))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dt] * max(1.0, want.float().abs().max().item())
            st_err = (gst - wst).abs().max().item()
            st_tol = STATS_TOL * wst.abs().max().item()
            del want, wst
            ms = cuda_ms(lambda: conv3x3(parts, w, b, **kw), 3, 1)
            x_cl = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cl = w.to(dt).contiguous(memory_format=torch.channels_last_3d)
            b_l = b.to(dt)

            def library():
                torch.var_mean(torch.nn.functional.conv3d(
                    x_cl, w_cl, b_l, padding=1), dim=(2, 3, 4))

            library_ms = cuda_ms(library, 3, 1)
            flops = 2.0 * got.numel() * 27 * cin
            bnd = bound(nbytes(*parts, got, gst, b)
                        + w.numel() * got.element_size(), flops, dt)
            name = f"Cout-32 {tag} bf16 {chans}->{cout} at {n}x{side}^3"
            log(f"conv3x3 {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
                f"stats err {st_err:.3e} (tol {st_tol:.3e}) kernel "
                f"{ms:.4f} ms library {library_ms:.4f} ms bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                f"{bnd['bound_ms'] / ms:.1%} of it), kernel "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            if not (err <= tol and st_err <= st_tol
                    and torch.isfinite(got).all()):
                fail(f"conv3x3 {name} disagrees with its plain version")
            if n != max(ATT_COUT32_N):
                del parts, got, gst, x_cl
                continue
            gy = torch.randn(got.shape, generator=g, device=dev).to(dt)
            g_cl = gy.permute(0, 4, 1, 2, 3)
            del got, gst
            if tag != "denoiser head":
                got = conv3x3_dgrad(gy, w)
                want = conv3x3_dgrad_plain(gy, w)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dt] * max(
                    1.0, want.float().abs().max().item())
                del want
                ms = cuda_ms(lambda: conv3x3_dgrad(gy, w), 3, 1)
                library_ms = conv_backward_library_ms(
                    x_cl, w_cl, g_cl, [True, False, False], 3)
                bnd = bound(nbytes(gy, got)
                            + w.numel() * got.element_size(), flops, dt)
                log(f"conv3x3_dgrad {name}: max_abs_err {err:.3e} (tol "
                    f"{tol:.3e}) kernel {ms:.4f} ms library "
                    f"{library_ms:.4f} ms bound {bnd['bound_ms']:.4f} ms "
                    f"({bnd['bound_by']}, {bnd['bound_ms'] / ms:.1%} of "
                    f"it), kernel {flops / ms / 1e9:.1f} TFLOP/s")
                if not (err <= tol and torch.isfinite(got).all()):
                    fail(f"conv3x3_dgrad {name} disagrees with its plain "
                         "version")
                del got
            got = conv3x3_wgrad(gy, parts, pro)
            want = conv3x3_wgrad_plain(gy, parts, pro)
            torch.cuda.synchronize()
            same = repeat_equal(lambda: conv3x3_wgrad(gy, parts, pro), got)
            ref = want.abs().max().item()
            err = (got - want).abs().max().item()
            del want
            ms = cuda_ms(lambda: conv3x3_wgrad(gy, parts, pro), 3, 1)
            library_ms = conv_backward_library_ms(
                x_cl, w_cl, g_cl, [False, True, False], 3)
            bnd = bound(nbytes(gy, *parts, got), flops, dt)
            log(f"conv3x3_wgrad {name}: max_abs_err {err:.3e} of "
                f"max|plain| {ref:.3e} (tol {WGRAD_TOL[dt]:.0e} of it) "
                f"kernel {ms:.4f} ms library {library_ms:.4f} ms bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
                f"{bnd['bound_ms'] / ms:.1%} of it), kernel "
                f"{flops / ms / 1e9:.1f} TFLOP/s, "
                f"{ms / library_ms:.2f}x the library")
            if not (err <= WGRAD_TOL[dt] * ref and torch.isfinite(got).all()):
                fail(f"conv3x3_wgrad {name} disagrees with its plain version")
            del parts, gy, got, x_cl, g_cl



def phase_conv_mim(dev: torch.device) -> dict:
    """HybridMIM pretraining's float32 convs at the example's batch
    (MIM_CONV_CASES, N = MIM_BATCH), on the 3xTF32 instances: the forward
    kernel with statistics (and the prologue where the conv has one), the
    dgrad and the weight gradient against their plain versions, each run
    twice for the same bits, with kernel, plain and cuDNN times (TF32 off)
    and the bounds at the 3xTF32 and FFMA rates; then each of the three
    summed over one pretraining step (every conv times its launches a
    step). Returns the kernels line's float32 entries (MIM_REPORT)."""
    from diff_unet_tpu_torch.ops.conv3d import (
        KERNEL_TOL, STATS_TOL, WGRAD_TOL, conv3x3, conv3x3_dgrad,
        conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad,
        conv3x3_wgrad_plain)

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    dt, n = torch.float32, MIM_BATCH
    counts = [sum(c[5 + i] for c in MIM_CONV_CASES) for i in range(3)]
    if counts != list(MIM_PER_STEP.values()):
        fail(f"MIM_CONV_CASES count {counts} launches a step, "
             f"MIM_PER_STEP {list(MIM_PER_STEP.values())}")
    # one step's kernel, plain, cuDNN, 3xTF32 and FFMA bound ms of each
    step = {k: [0.0] * 5 for k in MIM_PER_STEP}
    report = {}

    def measure(kind, name, got, want, tol, reps, fns, flops, moved, per):
        err = (got - want).abs().max().item()
        same = repeat_equal(fns[0], got)
        ms, plain_ms, library_ms = (cuda_ms(f, reps, 1) for f in fns)
        bnd = conv_bound(moved, flops, dt)
        for i, v in enumerate((ms, plain_ms, library_ms, bnd["bound_ms"],
                               bnd["ffma_bound_ms"])):
            step[kind][i] += per * v
        log(f"{kind} {name}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} "
            f"ms {bound_text(bnd)} ({bnd['bound_ms'] / ms:.1%} of it), "
            f"kernel {flops / ms / 1e9:.1f} TFLOP/s, {ms / library_ms:.2f}x "
            f"the library, repeat {'same bits' if same else 'DIFFERS'}")
        if not (err <= tol and same and torch.isfinite(got).all()):
            fail(f"{kind} {name} disagrees with its plain version or with "
                 "itself")
        if name.split(" fp32")[0] == f"MIM {MIM_REPORT}":
            report[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms, **bnd)

    for tag, chans, cout, side, pro_on, fwd, dgrad, wgrad in MIM_CONV_CASES:
        shape = (n, side, side, side)
        cin = sum(chans)
        parts = [torch.randn((*shape, c), generator=g, device=dev)
                 for c in chans]
        w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
            / (27 * cin) ** 0.5
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        gy = torch.randn((*shape, cout), generator=g, device=dev)
        pro = None
        if pro_on:
            pro = tuple(torch.randn((n, cin), generator=g, device=dev)
                        * sd + mu for mu, sd in ((1.0, 0.3), (0.0, 0.3),
                                                 (0.0, 0.2))) + (0.1,)
        reps = 3 if side == 64 else 10
        x_cl = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)
        g_cl = gy.permute(0, 4, 1, 2, 3)
        flops = 2.0 * gy.numel() * 27 * cin
        name = f"MIM {tag} fp32 {chans}->{cout} at {n}x{side}^3"
        kw = dict(prologue=pro, with_stats=True)
        (got, gst), (want, wst) = (conv3x3(parts, w, b, **kw),
                                   conv3x3_plain(parts, w, b, **kw))
        torch.cuda.synchronize()
        st_err = (gst - wst).abs().max().item()
        if not st_err <= STATS_TOL * wst.abs().max().item():
            fail(f"conv3x3 {name}: statistics err {st_err:.3e}")
        if not repeat_equal(lambda: conv3x3(parts, w, b, **kw), (got, gst)):
            fail(f"conv3x3 {name}: a repeat gives other bits")

        def library():
            torch.var_mean(torch.nn.functional.conv3d(x_cl, w_cl, b,
                                                      padding=1),
                           dim=(2, 3, 4))

        measure("conv3x3", name, got, want, KERNEL_TOL[dt] * max(
            1.0, want.abs().max().item()), reps,
            (lambda: conv3x3(parts, w, b, **kw)[0],
             lambda: conv3x3_plain(parts, w, b, **kw), library), flops,
            nbytes(*parts, got, gst, b, w, *(pro or ())[:3]), fwd)
        del got, gst, want, wst
        if dgrad:
            got, want = conv3x3_dgrad(gy, w), conv3x3_dgrad_plain(gy, w)
            measure("conv3x3_dgrad", name, got, want, KERNEL_TOL[dt] * max(
                1.0, want.abs().max().item()), reps,
                (lambda: conv3x3_dgrad(gy, w),
                 lambda: conv3x3_dgrad_plain(gy, w),
                 lambda: torch.ops.aten.convolution_backward(
                     g_cl, x_cl, w_cl, None, [1] * 3, [1] * 3, [1] * 3,
                     False, [0] * 3, 1, [True, False, False])),
                flops, nbytes(gy, got, w), dgrad)
            del got, want
        got, want = (conv3x3_wgrad(gy, parts, pro),
                     conv3x3_wgrad_plain(gy, parts, pro))
        measure("conv3x3_wgrad", name, got, want,
                WGRAD_TOL[dt] * want.abs().max().item(), reps,
                (lambda: conv3x3_wgrad(gy, parts, pro),
                 lambda: conv3x3_wgrad_plain(gy, parts, pro),
                 lambda: torch.ops.aten.convolution_backward(
                     g_cl, x_cl, w_cl, None, [1] * 3, [1] * 3, [1] * 3,
                     False, [0] * 3, 1, [False, True, False])),
                flops, nbytes(gy, *parts, got, *(pro or ())[:3]), wgrad)
        del parts, gy, got, want, x_cl, g_cl
    for kind, (ms, plain_ms, library_ms, bound_ms, ffma_ms) in step.items():
        log(f"{kind} over one HybridMIM pretraining step "
            f"({MIM_PER_STEP[kind]} launches, fp32): kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms "
            f"({ms / library_ms:.2f}x) bound {bound_ms:.3f} ms at the "
            f"3xTF32 rate ({bound_ms / ms:.1%} of it), {ffma_ms:.3f} ms at "
            "the FFMA rate")
    return {"conv3x3_f32": report["conv3x3"],
            "conv3x3_dgrad_f32": report["conv3x3_dgrad"],
            "conv3x3_wgrad_f32": report["conv3x3_wgrad"]}


def phase_bn_chain(dev: torch.device) -> None:
    """One 32 -> 32 ``ConvBNReLU2`` at 10 x 96^3 in bf16 over fp32
    parameters, its conv_0 bias set to 10 so that the conv output's mean
    is ~10x its spread (where a one-pass variance loses digits): the
    block's output equals its chain run by hand on the conv kernel (bit
    for bit) and that chain on the plain version within BN_CHAIN_TOL of
    max |plain|; the first norm from the kernel's statistics (one pass,
    the samples added in float64, of the unrounded output) against a
    float64 two-pass norm of the rounded output; CUDA-event ms of the
    forward (kernel, plain and library chains: cuDNN conv, batch norm
    and ReLU, twice) and of forward + backward (block and library); peak
    memory."""
    import torch.nn.functional as F

    from diff_unet_tpu_torch.models.attention_diff_unet import ConvBNReLU2
    from diff_unet_tpu_torch.ops.blocks import scale_shift_relu
    from diff_unet_tpu_torch.ops.conv3d import (
        batch_affine_from_stats, conv3x3, conv3x3_plain)
    from diff_unet_tpu_torch.utils.weights import init_random

    n, side, c = 10, 96, 32
    count = side ** 3
    block = init_random(ConvBNReLU2(c, c, dtype=torch.bfloat16), SEED)
    with torch.no_grad():
        block.conv_0.bias.fill_(10.0)
    block = block.to(dev)
    g = torch.Generator(dev).manual_seed(SEED + 8)
    x = torch.randn((n, side, side, side, c), generator=g, device=dev
                    ).to(torch.bfloat16)
    c0, n0, c1, n1 = block.conv_0, block.norm_0, block.conv_1, block.norm_1

    def chain(conv):
        y0, st0 = conv([x], c0.weight, c0.bias, with_stats=True)
        a0, b0 = batch_affine_from_stats(st0, n0.weight, n0.bias, count)
        y1, st1 = conv([y0], c1.weight, c1.bias, prologue=(
            a0.expand(n, -1), b0.expand(n, -1), None, 0.0), with_stats=True)
        a1, b1 = batch_affine_from_stats(st1, n1.weight, n1.bias, count)
        return scale_shift_relu(y1, a1, b1), y0, a0, b0

    with torch.no_grad():
        out = block([x])
        got, y0, a0, b0 = chain(conv3x3)
        want = chain(conv3x3_plain)[0]
        torch.cuda.synchronize()
        same = torch.equal(out, got)
        ref = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        del out, want
        # the first norm: float64 two-pass statistics of the rounded y0
        yd = y0.double()
        mean = yd.mean(dim=(0, 1, 2, 3))
        var = torch.square(yd - mean).mean(dim=(0, 1, 2, 3))
        a_ref = torch.rsqrt(var + 1e-5) * n0.weight.double()
        b_ref = n0.bias.double() - mean * a_ref
        z_ref = yd * a_ref + b_ref
        norm_err = ((yd * a0.double() + b0.double() - z_ref).abs().max()
                    / z_ref.abs().max()).item()
        spread = (mean.abs() / var.sqrt()).min().item()
        del yd, z_ref, y0, got
    w0 = c0.weight.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    w1 = c1.weight.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)

    def library(h):
        """cuDNN's conv, batch norm and ReLU on the channels-last view."""
        for w, conv, norm in ((w0, c0, n0), (w1, c1, n1)):
            h = F.conv3d(h, w, conv.bias.to(torch.bfloat16), padding=1)
            h = F.relu(F.batch_norm(h, None, None, norm.weight, norm.bias,
                                    training=True))
        return h

    def forward(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    leaves = list(block.parameters())
    xg = x.clone().requires_grad_()
    dy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)

    def block_both():
        torch.autograd.grad(block([xg]), [xg, *leaves], dy)

    def library_both():
        torch.autograd.grad(library(xg.permute(0, 4, 1, 2, 3)),
                            [xg, *leaves], dy.permute(0, 4, 1, 2, 3))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = [cuda_ms(forward(lambda: block([x])), 5, 2),
             cuda_ms(forward(lambda: chain(conv3x3_plain)), 3, 1),
             cuda_ms(forward(lambda: library(x.permute(0, 4, 1, 2, 3))), 5,
                     2),
             cuda_ms(block_both, 5, 2), cuda_ms(library_both, 5, 2)]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"ConvBNReLU2 32->32 at {n}x{side}^3, bf16, conv_0 output mean / "
        f"spread >= {spread:.1f}: block = its kernel chain bit for bit "
        f"{same}; kernel chain vs plain chain max_abs_err {err:.3e} (tol "
        f"{BN_CHAIN_TOL * ref:.3e}); first norm from the kernel's one-pass "
        f"sums vs a float64 two-pass of the rounded output: "
        f"{norm_err:.3e} of max |z|; forward kernel {times[0]:.3f} ms "
        f"plain {times[1]:.3f} ms library {times[2]:.3f} ms; forward + "
        f"backward block {times[3]:.3f} ms library {times[4]:.3f} ms; peak "
        f"memory {peak:.2f} GiB")
    if not (same and err <= BN_CHAIN_TOL * ref):
        fail("the batch-norm ConvBNReLU2 on the kernel disagrees with its "
             "plain chain")


def phase_edt() -> None:
    """The built distance transform (``ops/edt.py``, host C++) against
    ``scipy.ndimage.distance_transform_edt`` on the complement of an organ
    surface in one 96x192x192 volume, as HD95 calls it."""
    from scipy import ndimage

    from diff_unet_tpu_torch.ops import edt

    grid = np.ogrid[tuple(slice(0, s) for s in EDT_SHAPE)]
    organ = sum(((g - c * n) / (r * n)) ** 2 for g, c, r, n in
                zip(grid, (0.45, 0.4, 0.55), (0.2, 0.2, 0.15),
                    EDT_SHAPE)) <= 1.0
    surface = organ ^ ndimage.binary_erosion(organ)
    mask = ~surface
    t0 = time.perf_counter()
    got = edt.distance_transform_edt(mask)          # builds on first use
    build_s = time.perf_counter() - t0
    ms = {}
    for name, fn in (("edt", lambda: edt.distance_transform_edt(mask)),
                     ("scipy", lambda: ndimage.distance_transform_edt(mask))):
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    err = float(np.abs(got - out).max())
    log(f"EDT {EDT_SHAPE} (host): built and first call {build_s:.2f} s; "
        f"{ms['edt']:.1f} ms against scipy's {ms['scipy']:.1f} ms; max abs "
        f"error {err:.3e} over distances up to {float(out.max()):.2f}")
    if not err <= EDT_TOL * float(out.max()):
        fail(f"EDT error {err:.3e} above {EDT_TOL} of the largest distance")
    # the boundary loss's host cost: the signed distance maps of one batch
    # of 96^3 one-hot labels, MSD's (4 x 2 classes) and AMOS's (10 x 15)
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.losses.edt import batch_dist_maps

    for name, labels, batch in (("MSD", 3, 4), ("AMOS", 16, 10)):
        lab = next(iter(SyntheticSegmentation((96, 96, 96), labels, batch,
                                              1, SEED)))["label"]
        onehot = np.eye(labels, dtype=np.float32)[lab][..., 1:]
        t0 = time.perf_counter()
        dist = batch_dist_maps(onehot)
        sec = time.perf_counter() - t0
        log(f"boundary loss distance maps of one {name} batch "
            f"{onehot.shape} (host, {batch * (labels - 1)} signed maps, two "
            f"EDTs each): {sec:.3f} s")
        if dist.shape != onehot.shape or not np.isfinite(dist).all():
            fail(f"{name} distance maps {dist.shape} are not finite maps of "
                 f"the labels' shape")


def amos_case(seed: int, body_shape):
    """An int16 CT in HU and its label map: soft tissue in a body of
    ``body_shape`` with 2 voxels of air on each side, one ellipsoid organ
    per class id 1..15 with its own HU level."""
    rng = np.random.default_rng(seed)
    shape = tuple(b + 4 for b in body_shape)
    img = np.full(shape, -1000, np.int16)
    lab = np.zeros(shape, np.int16)
    lo = (2, 2, 2)
    body = tuple(slice(a, a + b) for a, b in zip(lo, body_shape))
    img[body] = np.clip(rng.normal(40, 20, body_shape), -150, 300)
    for c in range(1, 16):
        radii = rng.uniform(0.05, 0.15, 3) * body_shape
        centre = [rng.uniform(a + r, a + b - r)
                  for a, b, r in zip(lo, body_shape, radii)]
        box = tuple(slice(int(m - r), int(m + r) + 1)
                    for m, r in zip(centre, radii))
        grid = np.ogrid[box]
        inside = sum(((g - m) / r) ** 2 for g, m, r in
                     zip(grid, centre, radii)) <= 1.0
        lab[box][inside] = c
        img[box][inside] = int(rng.uniform(-100, 200)) + rng.integers(
            -15, 15, int(inside.sum()))
    return img, lab


def write_amos_set(root: Path, train: list, val: list, seed: int) -> Path:
    """A Decathlon set of synthetic AMOS cases, one for each body shape of
    ``train`` and of ``val``."""
    from diff_unet_tpu_torch.data.nifti import write_nifti

    root.mkdir(parents=True, exist_ok=True)
    items = []
    for i, body_shape in enumerate(train + val):
        img, lab = amos_case(seed + i, body_shape)
        affine = np.diag([*AMOS_SPACING, 1.0])
        write_nifti(root / f"ct_{i}.nii.gz", img, affine)
        write_nifti(root / f"label_{i}.nii.gz", lab, affine)
        items.append({"image": f"ct_{i}.nii.gz",
                      "label": f"label_{i}.nii.gz"})
    (root / "dataset.json").write_text(json.dumps(
        {"training": items[:len(train)], "validation": items[len(train):]}))
    return root


def window_batches(inferer, shape) -> int:
    roi_padded = tuple(max(r, s) for r, s in zip(inferer.roi, shape))
    return sum(len(starts) for starts, _ in inferer._geometry(roi_padded))


def trees_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    return all(trees_equal(a[k], b[k]) if isinstance(a[k], dict)
               else np.array_equal(a[k], b[k]) for k in a)


def phase_eval_amos(dev: torch.device, work: Path) -> tuple:
    """``Tester.from_config("cfg/amos/test.yaml")`` at full width on a
    synthetic NIfTI validation set of AMOS_EVAL_BODIES cases, from seeded
    weights saved with ``save_jax_npz`` and loaded through ``model_path``:
    the loaded parameters equal the saved ones bit for bit; every dice and
    IoU finite and in [0, 1]; ``results.pkl`` with fp16 images and bool
    masks; exactly AMOS_CONV_PER_BATCH conv launches per window batch.
    Returns the launches, the results and the per-case seconds."""
    from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz
    from diff_unet_tpu_torch.engine.engine import Tester
    from diff_unet_tpu_torch.models.model_hub import create_model
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8
    from diff_unet_tpu_torch.utils.weights import export_jax_params, \
        init_random

    t0 = time.perf_counter()
    data = write_amos_set(work / "amos_eval", [], AMOS_EVAL_BODIES,
                          SEED + 100)
    tree = export_jax_params(init_random(
        create_model("diff_unet", out_channels=15), SEED + 1))
    weights = work / "amos_eval_weights"
    weights.mkdir()
    save_jax_npz(weights / "epoch_3000.npz", tree, meta={"epoch": 3000})
    tester = Tester.from_config(
        ROOT / "cfg/amos/test.yaml", data_path=str(data),
        model_path=str(weights / "epoch_3000"),
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED,
        log_dir=str(work / "amos_eval_logs"))
    log(f"tester: {tester.model_name}, {tester.num_classes} classes, roi "
        f"{tester._inferer.roi}, sw_batch_size {tester.sw_batch_size}, "
        f"dtype {tester.dtype}, epoch {tester.epoch}; set-up (write "
        f"{len(AMOS_EVAL_BODIES)} NIfTI cases, weights, load, preprocess) "
        f"{time.perf_counter() - t0:.1f} s")
    if not trees_equal(export_jax_params(tester.module), tree):
        fail("the parameters loaded through model_path differ from the "
             "saved ones")
    tester.infer(torch.from_numpy(
        tester.dataloader["val"].dataset[0]["image"][..., None]))  # warm-up
    torch.cuda.synchronize()
    conv3x3.launches = conv3x3.dgrad_launches = conv3x3_wgrad.launches = 0
    t0 = time.perf_counter()
    results = tester.test()
    seconds = time.perf_counter() - t0
    counts = {"conv3x3": conv3x3.launches,
              "conv3x3_dgrad": conv3x3.dgrad_launches,
              "conv3x3_wgrad": conv3x3_wgrad.launches}
    batches = [window_batches(tester._inferer, img.shape)
               for img in results["images"]]
    log(f"AMOS evaluation: {len(batches)} cases of "
        f"{[tuple(i.shape) for i in results['images']]} in {seconds:.3f} s; "
        f"window batches {batches}; conv launches {counts} "
        f"({counts['conv3x3'] / len(batches):.0f} per case)")
    for i, split in enumerate(tester.case_seconds):
        log(f"AMOS case {i} seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items())
            + f"; total {sum(split.values()):.4f}")
    d = np.asarray(results["dices"])
    iou = np.asarray(results["ious"])
    shapes = [tuple(x.shape) for x in results["images"]]
    if shapes != AMOS_EVAL_BODIES:
        fail(f"evaluated volumes {shapes}, preprocessed from bodies "
             f"{AMOS_EVAL_BODIES}")
    if d.shape != (len(AMOS_EVAL_BODIES), 15) or iou.shape != d.shape:
        fail(f"dices {d.shape}, ious {iou.shape}")
    for name, a in (("dice", d), ("IoU", iou)):
        if not (np.isfinite(a).all() and (a >= 0).all() and (a <= 1).all()):
            fail(f"a {name} is not finite or outside [0, 1]: {a}")
    pkl = tester.log_dir / "results.pkl"
    if not pkl.exists():
        fail(f"{pkl} was not written")
    if not (all(x.dtype == np.float16 for x in results["images"])
            and all(x.dtype == np.bool_ for x in results["outputs"]
                    + results["labels"])):
        fail("results.pkl's images are not fp16 or its masks not bool")
    if counts != {"conv3x3": AMOS_CONV_PER_BATCH * sum(batches),
                  "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}:
        fail(f"conv launches {counts}, predicted {AMOS_CONV_PER_BATCH} x "
             f"{sum(batches)} forward and no backward")
    return ({k: {"amos_test": c} for k, c in counts.items()}, results,
            tester.case_seconds)


def phase_metrics(dev: torch.device, results: dict) -> None:
    """The device metrics on the evaluation's outputs and labels, as card
    tensors and as their CPU copies."""
    from diff_unet_tpu_torch.metrics import metrics

    worst = 0.0
    for out, lab in zip(results["outputs"], results["labels"]):
        cpu = (torch.from_numpy(out), torch.from_numpy(lab))
        card = tuple(t.to(dev) for t in cpu)
        for name in ("validation_dice", "dice_per_class"):
            a = getattr(metrics, name)(*card).cpu()
            b = getattr(metrics, name)(*cpu)
            worst = max(worst, float((a - b).abs().max()))
        for c in range(out.shape[-1]):
            for name in ("iou", "dice_coeff"):
                a = getattr(metrics, name)(card[0][..., c], card[1][..., c])
                b = getattr(metrics, name)(cpu[0][..., c], cpu[1][..., c])
                worst = max(worst, abs(float(a) - float(b)))
    log(f"device metrics, card against CPU on the evaluation's masks: max "
        f"abs difference {worst:.3e} (tol {METRIC_TOL})")
    if not worst <= METRIC_TOL:
        fail(f"device metrics differ between card and CPU by {worst:.3e}")


def phase_train_amos_data(dev: torch.device, work: Path,
                          synthetic_s: float) -> dict:
    """``Trainer.from_config("cfg/amos/train.yaml", data_path=...)`` at
    full width on a synthetic NIfTI set (AMOS_DATA_CASES training and
    validation cases, batch AMOS_DATA_BATCH), AMOS_DATA_EPOCHS epochs with
    validation and ``epoch_{n}.pt`` every epoch; then a second trainer
    resumed from ``epoch_1.pt`` must end with the same parameters, bit for
    bit. Prints the median s/step with the host pipeline (crop and augment,
    copy, step) against the same step on a batch already on the card and
    against phase 5d's synthetic batch-10 step, and the peak memory.
    Returns the straight run's launches."""
    from diff_unet_tpu_torch.engine.engine import Trainer
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8

    t0 = time.perf_counter()
    data = write_amos_set(work / "amos_train",
                          [AMOS_BODY] * AMOS_DATA_CASES[0],
                          [AMOS_BODY] * AMOS_DATA_CASES[1], SEED + 200)
    kw = dict(data_path=str(data), classes=str(ROOT / "cfg/amos/classes.yaml"),
              device=dev, seed=SEED, batch_size=AMOS_DATA_BATCH,
              max_epochs=AMOS_DATA_EPOCHS, val_freq=1, save_freq=1)
    cfg = ROOT / "cfg/amos/train.yaml"
    trainer = Trainer.from_config(cfg, log_dir=str(work / "straight"), **kw)
    torch.cuda.synchronize()
    log(f"data_path trainer: batch {trainer.batch_size} (the recipe's 10 "
        f"cut to {AMOS_DATA_BATCH}), {len(trainer.dataloader['train'])} "
        f"steps an epoch, {len(trainer.dataloader['val'])} validation "
        f"volumes, {AMOS_DATA_EPOCHS} epochs; set-up (write, load, "
        f"preprocess, model) {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    conv3x3.launches = conv3x3.dgrad_launches = conv3x3_wgrad.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"conv3x3": conv3x3.launches,
              "conv3x3_dgrad": conv3x3.dgrad_launches,
              "conv3x3_wgrad": conv3x3_wgrad.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = len(trainer.history)
    val_batches = AMOS_DATA_EPOCHS * sum(
        window_batches(trainer._inferer, item["image"].shape)
        for item in trainer.dataloader["val"].dataset._cache)
    log("data_path train steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f} lr "
        f"{h['lr']:.3e}" for h in trainer.history)
        + f"; best mean dice {trainer.best_mean_dice:.4f}")
    log(f"launches during data_path training ({steps} steps, "
        f"{val_batches} validation window batches) in {seconds:.2f} s: "
        f"{counts}; peak device memory {peak:.2f} GiB")
    want = {k: n * steps for k, n in AMOS_TRAIN_PER_STEP.items()}
    want["conv3x3"] += AMOS_CONV_PER_BATCH * val_batches
    if counts != want:
        fail(f"data_path training launches {counts}, predicted {want}")
    if not all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history):
        fail("a data_path train step has a non-finite loss or zero grad")
    weights = work / "straight" / "weights"
    for n in range(1, AMOS_DATA_EPOCHS + 1):
        if not (weights / f"epoch_{n}.pt").exists():
            fail(f"epoch_{n}.pt was not saved")
    resumed = Trainer.from_config(cfg, log_dir=str(work / "resumed"),
                                  model_path=str(weights / "epoch_1"), **kw)
    start = resumed.start_epoch
    resumed.train()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        trainer.module.state_dict().values(),
        resumed.module.state_dict().values()))
    log(f"resume from epoch_1.pt: start epoch {start}, "
        f"{len(resumed.history)} steps; parameters after epoch "
        f"{AMOS_DATA_EPOCHS} {'equal' if same else 'DIFFER'} bit for bit")
    if not same:
        fail("the resumed run's parameters differ from the straight run's")
    # s/step: host pipeline (next crop batch) + copy + step, synchronised,
    # over more epochs of the loader; then the same step on one batch that
    # is already on the card
    loader = trainer.dataloader["train"]
    host_s, step_s, resident_s = [], [], []
    for epoch in range(AMOS_DATA_EPOCHS, AMOS_DATA_EPOCHS + 3):
        loader.set_epoch(epoch)
        it = iter(loader)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            image, labels = trainer._to_device(batch["image"],
                                               batch["label"])
            trainer.train_step(image, labels, generator=trainer.generator)
            torch.cuda.synchronize()
            host_s.append(t1 - t0)
            step_s.append(time.perf_counter() - t0)
    for _ in range(len(step_s)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(image, labels, generator=trainer.generator)
        torch.cuda.synchronize()
        resident_s.append(time.perf_counter() - t0)
    log(f"data_path step (batch {AMOS_DATA_BATCH}): median "
        f"{np.median(step_s):.4f} s/step with the host pipeline (crop and "
        f"augment median {np.median(host_s):.4f} s) against "
        f"{np.median(resident_s):.4f} s on a batch resident on the card; "
        f"phase 5d's synthetic batch-10 step {synthetic_s:.4f} s")
    return {k: {"amos_train_data": c} for k, c in counts.items()}


def phase_conv_msd(dev: torch.device) -> None:
    """The conv forward, dgrad and weight gradient of the MSD recipe at N 4
    in bf16 (MSD_CONV_CASES: the denoiser stem [image, 2 classes] -> 64,
    whose 2-channel part takes the gathered halo, and the last level's
    convs) against their plain versions, with kernel and plain times."""
    from diff_unet_tpu_torch.ops.conv3d import (
        KERNEL_TOL, STATS_TOL, WGRAD_TOL, conv3x3, conv3x3_dgrad,
        conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad,
        conv3x3_wgrad_plain, conv_plan, wgrad_plan)

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    dtype = torch.bfloat16
    for tag, chans, cout, side, pro_on in MSD_CONV_CASES:
        shape = (CONV_N, side, side, side)
        cin = sum(chans)
        parts = [torch.randn((*shape, c), generator=g, device=dev).to(dtype)
                 for c in chans]
        w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
            / (27 * cin) ** 0.5
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        gy = torch.randn((*shape, cout), generator=g, device=dev).to(dtype)
        pro = None
        if pro_on:
            pro = tuple(torch.randn((CONV_N, cin), generator=g, device=dev)
                        * sd + mu for mu, sd in ((1.0, 0.3), (0.0, 0.3),
                                                 (0.0, 0.2))) + (0.1,)
        checks = []
        (got, gst), (want, wst) = (
            fn(parts, w, b, prologue=pro, with_stats=True)
            for fn in (conv3x3, conv3x3_plain))
        checks.append(("forward", (got.float() - want.float()).abs().max()
                       .item(), KERNEL_TOL[dtype] * max(
                           1.0, want.float().abs().max().item())))
        checks.append(("statistics", (gst - wst).abs().max().item(),
                       STATS_TOL * wst.abs().max().item()))
        got, want = conv3x3_dgrad(gy, w), conv3x3_dgrad_plain(gy, w)
        checks.append(("dgrad", (got.float() - want.float()).abs().max()
                       .item(), KERNEL_TOL[dtype] * max(
                           1.0, want.float().abs().max().item())))
        got = conv3x3_wgrad(gy, parts, pro)
        want = conv3x3_wgrad_plain(gy, parts, pro)
        checks.append(("wgrad", (got - want).abs().max().item(),
                       WGRAD_TOL[dtype] * want.abs().max().item()))
        torch.cuda.synchronize()
        del got, want, gst, wst
        times = {
            "forward": (cuda_ms(lambda: conv3x3(parts, w, b, prologue=pro,
                                                with_stats=True), 3, 1),
                        cuda_ms(lambda: conv3x3_plain(
                            parts, w, b, prologue=pro, with_stats=True), 3,
                            1)),
            "dgrad": (cuda_ms(lambda: conv3x3_dgrad(gy, w), 3, 1),
                      cuda_ms(lambda: conv3x3_dgrad_plain(gy, w), 3, 1)),
            "wgrad": (cuda_ms(lambda: conv3x3_wgrad(gy, parts, pro), 3, 1),
                      cuda_ms(lambda: conv3x3_wgrad_plain(gy, parts, pro),
                              3, 1)),
        }
        plan = conv_plan(CONV_N, shape[1:], chans, cout)
        wplan = wgrad_plan(CONV_N, shape[1:], cin, cout)
        log(f"MSD conv {tag} bf16 {chans}->{cout} at {CONV_N}x{side}^3 "
            f"(forward halo {'TMA' if plan.tma else 'gathered'}, wgrad Cin "
            f"tile {wplan.ci_tile}): " + "; ".join(
                f"{name} max_abs_err {err:.3e} (tol {tol:.3e})"
                for name, err, tol in checks) + "; " + "; ".join(
                f"{name} kernel {k:.4f} ms plain {p:.4f} ms"
                for name, (k, p) in times.items()))
        for name, err, tol in checks:
            if not err <= tol:
                fail(f"MSD conv {tag}: {name} disagrees with its plain "
                     "version")
        del parts, gy


def small_step_inputs(s: int, classes: int, n: int = 2):
    """``n`` train-step inputs of one sample at s^3: image, one-hot labels,
    t and noise, from the seed."""
    rng = np.random.default_rng(SEED)
    return [(rng.random((1, s, s, s, 1), np.float32),
             np.eye(classes, dtype=np.float32)[
                 rng.integers(0, classes, (1, s, s, s))],
             np.array([int(rng.integers(0, 1000))]),
             rng.standard_normal((1, s, s, s, classes), np.float32))
            for _ in range(n)]


def compare_steps(name: str, cpu: list, card: list) -> None:
    """Loss, grad norm (relative) and every gradient (of max(its |g| max,
    0.1 of the model's)) of train steps on the CPU and on the card, within
    MODEL_TOL."""
    worst = [0.0, 0.0, 0.0]
    for (lc, nc, gc), (lg, ng, gg) in zip(cpu, card):
        worst[0] = max(worst[0], abs(lg - lc) / abs(lc))
        worst[1] = max(worst[1], abs(ng - nc) / abs(nc))
        gmax = max(a.abs().max().item() for a in gc)
        for a, b in zip(gc, gg):
            scale = max(a.abs().max().item(), 0.1 * gmax)
            worst[2] = max(worst[2], (b - a).abs().max().item() / scale)
    log(f"{name} cuda vs cpu: loss rel {worst[0]:.3e}, grad norm rel "
        f"{worst[1]:.3e}, worst gradient error {worst[2]:.3e} (tol "
        f"{MODEL_TOL:.0e}); losses {[round(r[0], 6) for r in cpu]}")
    if not (max(worst) <= MODEL_TOL
            and all(np.isfinite(r[0]) for r in card)):
        fail(f"{name} on the card disagrees with the CPU")


def phase_small_all_losses(dev: torch.device) -> None:
    """One small DiffUNet train step (features (8, 8, 16, 32, 64, 8), 32^3,
    fp32, TF32 off) with all 14 loss names, the boundary loss's distance
    maps from the host EDT, on the card against the CPU from the same
    weights, t, noise and maps."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.edt import batch_dist_maps
    from diff_unet_tpu_torch.losses.losses import LOSS_NAMES, CompositeLoss
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    s, classes = 32, 3
    image, labels, t, noise = small_step_inputs(s, classes, 1)[0]
    labels[..., 2] = 0.0                        # an empty class too
    dist = batch_dist_maps(labels)
    names = ",".join(LOSS_NAMES)
    records = []
    for where in (torch.device("cpu"), dev):
        model = init_random(DiffUNet(classes, features=(8, 8, 16, 32, 64,
                                                        8)), SEED).to(where)
        opt, schedule = make_optimizer(model.parameters(), lr=2e-4)
        step = TrainStep(DiffusionSegmenter(model, classes),
                         CompositeLoss(names, classes), opt, schedule)
        m = step(*(torch.from_numpy(a).to(where)
                   for a in (image, labels)),
                 t=torch.from_numpy(t).to(where),
                 noise=torch.from_numpy(noise).to(where),
                 dist_maps=torch.from_numpy(dist).to(where))
        records.append([(m["loss"].item(), m["grad_norm"].item(),
                         [p.grad.detach().cpu().clone()
                          for p in model.parameters()])])
    compare_steps(f"small DiffUNet train step with all {len(LOSS_NAMES)} "
                  "losses", *records)


def phase_small_swin_unetr(dev: torch.device) -> None:
    """A small plain Swin-UNETR (feature 12, 32^3, fp32, TF32 off) on the
    card against the CPU from the same weights: the forward of two
    images, then two train steps (the second from the CPU's parameters on
    both sides, as for DiffUNet: Adam's first update is lr * sign(g))."""
    from diff_unet_tpu_torch.api import PlainSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.losses import CompositeLoss
    from diff_unet_tpu_torch.models.swin_unetr import SwinUNETR
    from diff_unet_tpu_torch.utils.weights import init_random

    s, classes = 32, 3
    cpu = init_random(SwinUNETR(classes, image_size=(s,) * 3,
                                feature_size=12), SEED)
    gpu = SwinUNETR(classes, image_size=(s,) * 3, feature_size=12)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((2, s, s, s, 1), np.float32))
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(dev)).cpu()
    err = (got - want).abs().max().item()
    log(f"small swin_unetr forward (feature 12, {s}^3, fp32, TF32 off) "
        f"cuda vs cpu: max_abs_err {err:.3e} (tol {MODEL_TOL:.0e}, max|y| "
        f"{want.abs().max().item():.3f})")
    if not (torch.isfinite(got).all() and err <= MODEL_TOL):
        fail("small swin_unetr on the card disagrees with the CPU")
    models = (cpu, gpu)
    steps = [TrainStep(PlainSegmenter(m, classes),
                       CompositeLoss("mse,bce,dice", classes),
                       *make_optimizer(m.parameters(), lr=2e-4))
             for m in models]
    records = ([], [])
    for k, (image, labels, _, _) in enumerate(small_step_inputs(s, classes)):
        if k:
            with torch.no_grad():
                for a, b in zip(cpu.parameters(), gpu.parameters()):
                    b.copy_(a)
        for where, model, step, record in zip((torch.device("cpu"), dev),
                                              models, steps, records):
            m = step(torch.from_numpy(image).to(where),
                     torch.from_numpy(labels).to(where))
            record.append((m["loss"].item(), m["grad_norm"].item(),
                           [p.grad.detach().cpu().clone()
                            for p in model.parameters()]))
    compare_steps("small swin_unetr train steps", *records)



def phase_small_mim(dev: torch.device) -> None:
    """A small HybridMIM (SMALL_MIM: widths, 32^3, mask patch 8, a batch
    of 2) on the card against the same weights on the CPU's plain path,
    fp32 with TF32 off, with pinned masks: the forward's outputs within
    MODEL_TOL of each one's max |y| (the labels and masks exactly); two
    ``MimPretrainStep``s: loss and grad norm within MODEL_TOL relative,
    every gradient within MODEL_TOL of max(its |g| max, 0.1 x the
    model's), the parameters after them within 2 lr (the second step from
    the CPU's parameters on both sides, as phase_small_train's); the card
    step, run twice from the same start, gives the same bits."""
    from diff_unet_tpu_torch.models.hybrid_mim import HybridMIMBasicUNet, \
        MimPretrainStep
    from diff_unet_tpu_torch.ops.mim import block_mask
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fea, s, p, n, lr = SMALL_MIM
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)

    def batch():
        x = torch.from_numpy(rng.standard_normal((n, s, s, s, 1),
                                                 np.float32))
        return x, tuple(block_mask((s,) * 3, patch=p, mask_ratio=0.4,
                                   noise=torch.from_numpy(rng.random(
                                       (n, (s // p) ** 3), np.float32)))
                        for _ in range(2))

    steps = [batch() for _ in range(2)]

    def build(where):
        model = init_random(HybridMIMBasicUNet(features=fea, mask_patch=p),
                            SEED).to(where)
        return model, MimPretrainStep(model, lr=lr)

    def run(model, step, where, x, masks):
        m = step(x.to(where), masks=tuple(k.to(where) for k in masks))
        return (m["loss"].item(), m["grad_norm"].item(),
                [q.grad.detach().cpu().clone() for q in model.parameters()])

    (cm, cs), (gm, gs) = build(cpu), build(dev)
    x, masks = steps[0]
    with torch.no_grad():
        want = cm(x, masks=masks)
        got = gm(x.to(dev), masks=tuple(k.to(dev) for k in masks))
    errs, exact = {}, True
    for k, w in want.items():
        v = got[k].cpu()
        if k in ("mask_labels", "mask_position_labels", "mask"):
            exact &= torch.equal(v, w)
        else:
            errs[k] = ((v - w).abs().max() / w.abs().max()).item()
    log(f"small HybridMIM (features {fea}, {s}^3, mask patch {p}, fp32, "
        f"TF32 off) cuda vs cpu, error / max|y|: "
        f"{ {k: f'{e:.2e}' for k, e in errs.items()} } (tol "
        f"{MODEL_TOL:.0e}); labels and masks "
        f"{'equal' if exact else 'DIFFERENT'}")
    if not (exact and max(errs.values()) <= MODEL_TOL
            and all(torch.isfinite(v).all() for v in got.values())):
        fail("small HybridMIM on the card disagrees with the CPU")
    records = ([], [])
    for k, (x, masks) in enumerate(steps):
        if k:
            with torch.no_grad():
                for a, b in zip(cm.parameters(), gm.parameters()):
                    b.copy_(a)
        records[0].append(run(cm, cs, cpu, x, masks))
        records[1].append(run(gm, gs, dev, x, masks))
    again = run(*build(dev), dev, *steps[0])
    reproducible = again[0] == records[1][0][0] and all(
        torch.equal(a, b) for a, b in zip(again[2], records[1][0][2]))
    worst, worst_name = [0.0, 0.0, 0.0], ""
    names = [k for k, _ in cm.named_parameters()]
    for (lc, nc, gc), (lg, ng, gg) in zip(*records):
        worst[0] = max(worst[0], abs(lg - lc) / abs(lc))
        worst[1] = max(worst[1], abs(ng - nc) / abs(nc))
        gmax = max(a.abs().max().item() for a in gc)
        for name, a, b in zip(names, gc, gg):
            err = (b - a).abs().max().item() / max(a.abs().max().item(),
                                                   0.1 * gmax)
            if err > worst[2]:
                worst[2], worst_name = err, name
    perr = max((a.detach().cpu() - b).abs().max().item()
               for a, b in zip(gm.parameters(), cm.parameters()))
    log(f"small HybridMIM pretraining steps cuda vs cpu: loss rel "
        f"{worst[0]:.3e}, grad norm rel {worst[1]:.3e} (tol "
        f"{MODEL_TOL:.0e}); worst gradient error {worst[2]:.3e} of "
        f"max(|g| max, 0.1 model max) (tol {MODEL_TOL:.0e}), {worst_name}; "
        f"parameters after 2 steps (the second from the same ones) "
        f"{perr:.3e} (tol {2 * lr:.0e}); losses "
        f"{[round(r[0], 6) for r in records[0]]}; the card step run twice: "
        f"{'the same' if reproducible else 'different'} loss and "
        "gradients, bit for bit")
    if not (max(worst) <= MODEL_TOL and perr <= 2 * lr and reproducible
            and all(np.isfinite(r[0]) for r in records[1])):
        fail("small HybridMIM pretraining steps on the card disagree with "
             "the CPU")


def phase_mim_pretrain(dev: torch.device, work: Path) -> dict:
    """HybridMIM pretraining at examples/pretrain_mim.py's defaults through
    ``diff_unet_tpu_torch.pretrain_mim``'s own functions (``build``,
    ``pretrain``, ``save_encoder``): MIM_STEPS steps on synthetic batches
    with every loss term finite, every parameter tensor moved and exactly
    MIM_PER_STEP conv launches a step; the median s/step of MIM_STEPS more
    with the card synchronised around each, and the peak memory of
    ``pretrain``. Then the encoder ``.npz``, which
    ``Trainer.from_config("cfg/amos/train.yaml", pretrained_path=...)``
    grafts into ``embed_model`` bit for bit, and one AMOS step of batch 10
    with a finite loss. Returns the launches of ``pretrain``."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer
    from diff_unet_tpu_torch.engine.sliding_window import window_seed
    from diff_unet_tpu_torch.pretrain_mim import build, pretrain, \
        save_encoder, synthetic_batch

    t0 = time.perf_counter()
    model, step = build(device=dev)
    torch.cuda.synchronize()
    names = [k for k, _ in model.named_parameters()]
    before = [q.detach().clone() for q in model.parameters()]
    log(f"HybridMIM pretrainer: {sum(q.numel() for q in before)} "
        f"parameters, batch {MIM_BATCH} of {MIM_SIZE}^3, mask patch "
        f"{model.mask_patch}, fp32; set-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_conv()
    hist = pretrain(step, MIM_STEPS, MIM_BATCH, MIM_SIZE, log=log)
    torch.cuda.synchronize()
    counts = conv_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = [{k: v.item() for k, v in h.items()} for h in hist]
    still = [k for k, a, q in zip(names, before, model.parameters())
             if torch.equal(a, q)]
    log("HybridMIM steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f}"
        for h in hist))
    log(f"launches during HybridMIM pretraining ({MIM_STEPS} steps): "
        f"{counts}")
    batches = [synthetic_batch(torch.Generator(device=dev).manual_seed(
        window_seed(SEED, (MIM_STEPS + i,))), MIM_BATCH, MIM_SIZE)
        for i in range(MIM_STEPS)]
    step_s = []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"HybridMIM pretraining: median {np.median(step_s[1:]):.4f} s/step "
        f"over steps 2..{len(step_s)} of a synchronised pass, {step_s}; "
        f"peak device memory {peak:.2f} GiB over the {MIM_STEPS} steps of "
        f"pretrain(); {len(names) - len(still)} of {len(names)} parameter "
        "tensors moved")
    if not all(np.isfinite(v) for h in hist for v in h.values()) or not all(
            h["grad_norm"] > 0 for h in hist):
        fail("a HybridMIM step has a non-finite loss term or a zero grad "
             "norm")
    if still:
        fail(f"HybridMIM parameters did not move: {still}")
    for k, c in counts.items():
        if c != MIM_PER_STEP[k] * MIM_STEPS:
            fail(f"{k}: {c} launches in {MIM_STEPS} HybridMIM steps, "
                 f"predicted {MIM_PER_STEP[k]} x {MIM_STEPS}")
    path = work / "mim_encoder.npz"
    save_encoder(model, path)
    data = SyntheticSegmentation((96, 96, 96), num_labels=16, batch_size=10,
                                 batches=1, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/amos/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/amos/classes.yaml"), seed=SEED,
        max_epochs=1, pretrained_path=str(path))
    enc = trainer.module.embed_model
    grafted = [k for k, _ in enc.named_parameters()]
    differ = [k for k in grafted
              if not torch.equal(enc.get_parameter(k), model.get_parameter(k))]
    del model, step, before, batches
    trainer.train()
    loss = trainer.history[0]["loss"]
    log(f"encoder .npz ({path.stat().st_size / 2 ** 20:.1f} MiB) grafted "
        f"into the AMOS Trainer's embed_model: {len(grafted) - len(differ)} "
        f"of {len(grafted)} tensors equal bit for bit; one AMOS step of "
        f"batch {trainer.batch_size}: loss {loss:.5f}")
    if differ or len(grafted) != 40:
        fail(f"the grafted encoder differs from the pretrained one: {differ}")
    if not np.isfinite(loss):
        fail("the AMOS step after the graft has a non-finite loss")
    del trainer
    return counts

def step_seconds(trainer, calls: int = None) -> list:
    """Seconds of each train call over the trainer's batches once more,
    the card synchronised before and after each."""
    out = []
    for i, (image, labels) in enumerate(trainer.batches[:calls]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(image, labels, generator=trainer.generator,
                           dist_maps=trainer.dist_maps_of(i, labels))
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def conv_counts() -> dict:
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8
    return {"conv3x3": conv3x3.launches,
            "conv3x3_dgrad": conv3x3.dgrad_launches,
            "conv3x3_wgrad": conv3x3_wgrad.launches}


def reset_conv() -> None:
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8
    conv3x3.launches = conv3x3.dgrad_launches = conv3x3_wgrad.launches = 0


def check_history(name: str, hist: list, steps: int) -> None:
    log(f"{name} steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f} lr "
        f"{h['lr']:.3e}" for h in hist))
    if len(hist) != steps:
        fail(f"{name}: {len(hist)} steps, not {steps}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in hist):
        fail(f"{name}: a step has a non-finite loss or a zero grad norm")


def phase_train_msd(dev: torch.device) -> dict:
    """``Trainer.from_config("cfg/msd/train.yaml")`` at full width
    (DiffUNet, 2 classes, mse + bce + dice + focal, batch 4 of 96^3, bf16
    over fp32) on synthetic batches of 3 label values for MSD_TRAIN_STEPS
    steps: finite losses, moved parameters, exactly AMOS_TRAIN_PER_STEP
    conv launches a step; then the median synchronised s/step and the
    peak memory. Returns the launches of ``train()``."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer

    t0 = time.perf_counter()
    data = SyntheticSegmentation((96, 96, 96), num_labels=3, batch_size=4,
                                 batches=MSD_TRAIN_STEPS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/msd/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/msd/classes.yaml"), seed=SEED,
        max_epochs=1)
    torch.cuda.synchronize()
    log(f"MSD trainer: {trainer.model_name}, {trainer.num_classes} classes, "
        f"losses {','.join(trainer.criterion.names)}, batch "
        f"{trainer.batch_size}, dtype {trainer.dtype}, "
        f"{sum(p.numel() for p in trainer.module.parameters())} parameters; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    before = [p.detach().clone() for p in trainer.module.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_conv()
    trainer.train()
    torch.cuda.synchronize()
    counts = conv_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = trainer.history
    moved = sum(int(not torch.equal(a, p))
                for a, p in zip(before, trainer.module.parameters()))
    check_history("MSD train", hist, MSD_TRAIN_STEPS)
    step_s = step_seconds(trainer)
    log(f"MSD train: conv launches {counts} ({MSD_TRAIN_STEPS} steps); "
        f"median {np.median(step_s[1:]):.4f} s/step over steps "
        f"2..{len(step_s)} of a synchronised pass, {step_s}; peak device "
        f"memory {peak:.2f} GiB; {moved} of {len(before)} parameter "
        "tensors moved")
    if hist[0]["lr"] != 0.0 or not moved:
        fail("the MSD parameters did not move once the lr was above 0")
    for k, c in counts.items():
        if c != AMOS_TRAIN_PER_STEP[k] * len(hist):
            fail(f"{k}: {c} launches in {len(hist)} MSD steps, predicted "
                 f"{AMOS_TRAIN_PER_STEP[k]} x {len(hist)}")
    return {k: {"msd_train": c} for k, c in counts.items()}


def phase_train_amos_keys(dev: torch.device, work: Path,
                          plain_s: float) -> dict:
    """``cfg/amos/train.yaml`` at full width with AMOS_KEYS (EMA 0.9999,
    an update every 2 calls, the loss-aware sampler), batch 10, for
    AMOS_KEYS_CALLS calls of ``train()`` (conv launches as phase 5d a
    call); then call by call, synchronised: the EMA tree equals e * rate +
    p * (1 - rate) recomputed on the card, bit for bit; the parameters
    change on update calls only; the sampler's counts rise by one at each
    distinct t drawn (replayed from the generator's state). Then saves a
    ``.pt``, loads its EMA tree into a ``Tester`` (use_ema) bit for bit
    and scores phase 7's first synthetic case. Returns the launches of
    ``train()``."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.diffusion import resample
    from diff_unet_tpu_torch.engine.engine import Tester, Trainer

    data = SyntheticSegmentation((96, 96, 96), num_labels=16, batch_size=10,
                                 batches=AMOS_KEYS_CALLS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/amos/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/amos/classes.yaml"), seed=SEED,
        max_epochs=1, log_dir=str(work / "amos_keys"), **AMOS_KEYS)
    step = trainer.train_step
    torch.cuda.reset_peak_memory_stats(dev)
    reset_conv()
    trainer.train()
    torch.cuda.synchronize()
    counts = conv_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_history("AMOS train with the keys", trainer.history,
                  AMOS_KEYS_CALLS)
    if step.count != AMOS_KEYS_CALLS // 2:
        fail(f"{step.count} updates in {AMOS_KEYS_CALLS} calls")
    for k, c in counts.items():
        if c != AMOS_TRAIN_PER_STEP[k] * AMOS_KEYS_CALLS:
            fail(f"{k}: {c} launches in {AMOS_KEYS_CALLS} calls, predicted "
                 f"{AMOS_TRAIN_PER_STEP[k]} x {AMOS_KEYS_CALLS}")
    rate = AMOS_KEYS["ema_rate"]
    call_s, updated = [], []
    for image, labels in trainer.batches:
        ema = [e.clone() for e in step.ema]
        params = [p.detach().clone() for p in step.params]
        state = step.sampler_state
        replay = torch.Generator(dev)
        replay.set_state(trainer.generator.get_state())
        t, _ = resample.sample_loss_aware(state, replay, labels.shape[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(image, labels, generator=trainer.generator)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
        updated.append(m["updated"])
        params_now = [p.detach() for p in step.params]
        want = torch._foreach_mul(params_now, 1.0 - rate)
        torch._foreach_mul_(ema, rate)
        torch._foreach_add_(ema, want)
        ema_same = all(torch.equal(a, b) for a, b in zip(ema, step.ema))
        moved = any(not torch.equal(a, b) for a, b in zip(params, params_now))
        seen = torch.zeros_like(state.counts)
        seen[t] = 1
        want_counts = torch.clamp(state.counts + seen,
                                  max=state.losses.shape[1])
        counts_ok = torch.equal(step.sampler_state.counts, want_counts)
        log(f"AMOS keys call: t {t.tolist()}, updated {m['updated']}, "
            f"parameters moved {moved}, EMA = e*rate + p*(1-rate) "
            f"{'bit for bit' if ema_same else 'DIFFERS'}, sampler counts "
            f"{'as drawn' if counts_ok else 'DIFFER'}")
        if not (ema_same and counts_ok and moved == m["updated"]):
            fail("the EMA tree, the parameters or the sampler state do not "
                 "follow the train calls")
    log(f"AMOS train with {AMOS_KEYS}: median {np.median(call_s):.4f} s a "
        f"call over a synchronised pass, {call_s} (updates on calls "
        f"{[i for i, u in enumerate(updated) if u]}); phase 5d's plain "
        f"step {plain_s:.4f} s; peak device memory {peak:.2f} GiB")
    trainer.save_model(work / "amos_keys.pt")
    data_dir = write_amos_set(work / "amos_ema_eval", [],
                              AMOS_EVAL_BODIES[:1], SEED + 100)
    tester = Tester.from_config(
        ROOT / "cfg/amos/test.yaml", data_path=str(data_dir),
        model_path=str(work / "amos_keys.pt"), use_ema=True,
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED,
        log_dir=str(work / "amos_ema_logs"))
    same = all(torch.equal(p, e) for p, e in zip(tester.module.parameters(),
                                                 step.ema))
    results = tester.test()
    d = np.asarray(results["dices"])
    log(f"Tester(use_ema=True) on the .pt: EMA tree loaded "
        f"{'bit for bit' if same else 'DIFFERENTLY'}; case dices "
        f"{np.array2string(d, precision=4)}")
    if not same:
        fail("the Tester's EMA parameters differ from the trainer's")
    if d.shape != (1, 15) or not (np.isfinite(d).all() and (d >= 0).all()
                                  and (d <= 1).all()):
        fail(f"EMA evaluation dices {d}")
    return {k: {"amos_train_ema": c} for k, c in counts.items()}


def phase_swin_unetr(dev: torch.device, counters: dict) -> dict:
    """The plain Swin-UNETR baseline at BTCV widths (feature 48, 13
    classes): ``Trainer.from_config("cfg/btcv/train.yaml",
    model_name="swin_unetr")`` for SWIN_UNETR_STEPS steps of batch 1 with
    exactly SWIN_UNETR_PER_STEP Swin launches a step, median s/step and
    peak memory; then a ``Predictor`` from ``cfg/btcv/test.yaml`` on the
    96x192x192 synthetic CT with SWIN_UNETR_PER_BATCH launches per window
    batch and no DDIM loop. Returns the launches of both paths."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation, \
        synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor, Trainer

    data = SyntheticSegmentation((96, 96, 96), num_labels=14, batch_size=1,
                                 batches=SWIN_UNETR_STEPS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/btcv/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/btcv/classes.yaml"), seed=SEED,
        max_epochs=1, model_name="swin_unetr")
    log(f"swin_unetr trainer: {type(trainer.module).__name__}, "
        f"{trainer.num_classes} classes, label smoothing "
        f"{trainer.label_smoothing}, "
        f"{sum(p.numel() for p in trainer.module.parameters())} parameters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset(counters)
    trainer.train()
    torch.cuda.synchronize()
    counts = {k: (fn.launches, getattr(fn, "backward_launches", 0))
              for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_history("swin_unetr train", trainer.history, SWIN_UNETR_STEPS)
    step_s = step_seconds(trainer)
    log(f"swin_unetr train: launches (forward, backward) {counts}; median "
        f"{np.median(step_s[1:]):.4f} s/step over steps 2..{len(step_s)}, "
        f"{step_s}; peak device memory {peak:.2f} GiB")
    for k, (fwd, bwd) in counts.items():
        want = tuple(n * SWIN_UNETR_STEPS for n in SWIN_UNETR_PER_STEP[k])
        if (fwd, bwd) != want:
            fail(f"swin_unetr train {k}: {(fwd, bwd)} launches, predicted "
                 f"{want}")
    paths = {k: {"swin_unetr_train": sum(c) if k in (
        "window_partition", "window_reverse") else c[0]}
        for k, c in counts.items()}
    paths["window_attention_backward"] = {
        "swin_unetr_train": counts["window_attention"][1]}
    paths["shift_windows_backward"] = {
        "swin_unetr_train": counts["shift_windows"][1]}
    del trainer
    pred = Predictor.from_config(
        ROOT / "cfg/btcv/test.yaml", model_path=None, model_name="swin_unetr",
        classes=str(ROOT / "cfg/btcv/classes.yaml"), device=dev, seed=SEED)
    shape = (96, 192, 192)
    volume = synthetic_ct(shape, SEED, dev)
    pred.infer(volume)                        # warm-up
    torch.cuda.synchronize()
    reset(counters)
    t0 = time.perf_counter()
    logits, binary = pred.serve([volume])[0]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    batches = window_batches(pred._inferer, shape)
    serve = {k: fn.launches for k, fn in counters.items()}
    log(f"swin_unetr serving {shape}: {sec:.3f} s, {batches} window batches "
        f"(sw {pred.sw_batch_size}), launches {serve} "
        f"({ {k: c / batches for k, c in serve.items()} } per batch)")
    if tuple(logits.shape) != (*shape, 13) or not torch.isfinite(
            logits).all() or not ((binary == 0) | (binary == 1)).all():
        fail("swin_unetr serving output is not finite, binary, of the "
             "volume's shape")
    for k, c in serve.items():
        if c != SWIN_UNETR_PER_BATCH[k] * batches:
            fail(f"swin_unetr serving {k}: {c} launches, predicted "
                 f"{SWIN_UNETR_PER_BATCH[k]} x {batches}")
    for k, c in serve.items():
        paths[k]["swin_unetr_serve"] = c
    return paths


@contextlib.contextmanager
def ddim_spans():
    """Record CUDA events around every ``DiffusionSegmenter.ddim_sample``
    call (one window batch) while the context is open; yields the list of
    (start, end) event pairs."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter

    spans = []
    inner = DiffusionSegmenter.ddim_sample

    def ddim_sample(self, image, **kw):
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(self, image, **kw)
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        spans.append((a, b))
        return out

    DiffusionSegmenter.ddim_sample = ddim_sample
    try:
        yield spans
    finally:
        DiffusionSegmenter.ddim_sample = inner


def timed_run(fn, spans: list) -> tuple:
    """(fn's result, its wall seconds with the card synchronised before
    and after, the card's busy share: the window batches' event times
    over the wall time)."""
    torch.cuda.synchronize()
    spans.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3 / wall
    return out, wall, busy


def batch_sizes(pred, shapes) -> tuple:
    """Per volume, the size of the batch each window runs in: in
    ``infer`` (dummy windows counted) and in ``serve_volumes``'s schedule
    (the unit: the power-of-two floor of sw_batch_size)."""
    from diff_unet_tpu_torch.engine.serving import schedule

    inf = pred._inferer
    serial, starts = [], []
    for shape in shapes:
        padded = tuple(max(r, s) for r, s in zip(inf.roi, shape))
        serial.append([len(row) for _, valid in inf._geometry(padded)
                       for row in valid for _ in range(int(row.sum()))])
        starts.append(inf._starts(padded))
    cont = [[] for _ in shapes]
    for batch in schedule(starts, 2 ** int(np.log2(pred.sw_batch_size))):
        for i, _ in batch:
            cont[i].append(len(batch))
    return serial, cont


def compare_served(name: str, pred, shapes, serial: list, cont: list,
                   fail_on_mismatch: bool = True,
                   logit_tol=CONT_TOL) -> list:
    """Each volume's continuous answer against its serial one: bit for bit
    where every window ran at the same batch size on both paths, else
    logits within ``logit_tol`` of max |y| (one fraction, or one for each
    volume) and binaries on all but CONT_FLIPS of the voxels
    (``fail_on_mismatch``; else only printed). Returns each volume's
    largest logit difference as a fraction of its max |y|."""
    sizes_serial, sizes_cont = batch_sizes(pred, shapes)
    tols = (logit_tol if isinstance(logit_tol, (list, tuple))
            else [logit_tol] * len(shapes))
    dists = []
    for shape, (sl, sb), (cl, cb), ns, nc, tol in zip(
            shapes, serial, cont, sizes_serial, sizes_cont, tols):
        want = (*shape, pred.num_classes)
        if tuple(cl.shape) != want or tuple(cb.shape) != want:
            fail(f"{name}: output shape {tuple(cl.shape)} != {want}")
        if not torch.isfinite(cl).all() or not torch.equal(
                cb, (torch.sigmoid(cl) > 0.5).float()):
            fail(f"{name}: non-finite logits, or a binary output that is "
                 "not sigmoid(logits) > 0.5")
        diff = float((cl - sl).abs().max())
        scale = float(sl.abs().max())
        flips = float((cb != sb).float().mean())
        same = torch.equal(cl, sl) and torch.equal(cb, sb)
        dists.append(diff / scale)
        log(f"{name} {shape}: batch sizes serial {ns}, continuous {nc}; "
            f"logits {'bit for bit' if same else f'max diff {diff:.3e}'} "
            f"(max |y| {scale:.3f}, {diff / scale:.3e} of it), binaries "
            f"differ on {flips:.3e} of the voxels")
        if not fail_on_mismatch:
            continue
        if ns == nc and not same:
            fail(f"{name} {shape}: every window ran at the same batch size "
                 "on both paths, but the answers differ")
        if diff > tol * scale or flips > CONT_FLIPS:
            fail(f"{name} {shape}: continuous differs from serial by "
                 f"{diff / scale:.3e} of max |y| (tol {tol:.3e}) and on "
                 f"{flips:.3e} of the binaries (tol {CONT_FLIPS})")
    return dists


def phase_continuous_amos(dev: torch.device, spans: list) -> dict:
    """AMOS DiffUNet (``cfg/amos/test.yaml``): ``serve_volumes`` over the
    CONT_SHAPES stream with the engine seed for every volume, against
    ``infer`` of each volume, in turns (serial, continuous, continuous,
    serial): answers as ``compare_served`` holds them, the two continuous
    runs bit for bit, exactly 190 conv launches per planned batch and no
    backward; volumes/min, DDIM window-steps/s, busy share and peak memory
    of each. Returns the launches."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / "cfg/amos/test.yaml", model_path=None,
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED)
    vols = [synthetic_ct(s, SEED + i, dev) for i, s in enumerate(CONT_SHAPES)]
    pred.infer(vols[2])                            # warm-up, both paths
    pred.serve_volumes(vols[2:3])
    plan = [len(b) for b in pred._continuous.plan(CONT_SHAPES)]
    serial_batches = sum(window_batches(pred._inferer, s)
                         for s in CONT_SHAPES)
    windows = sum(plan)
    steps = pred.seg.sample_steps
    runs = {}
    for kind in ("serial", "continuous", "continuous", "serial"):
        fn = ((lambda: [pred.infer(v) for v in vols]) if kind == "serial"
              else (lambda: pred.serve_volumes(
                  vols, seeds=[pred.seed] * len(vols))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        reset_conv()
        out, wall, busy = timed_run(fn, spans)
        peak = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 30
        runs.setdefault(kind, []).append((out, wall, busy, conv_counts()))
        log(f"AMOS {kind}: {len(vols)} volumes ({windows} windows, "
            f"{len(plan) if kind == 'continuous' else serial_batches} "
            f"window batches) in {wall:.3f} s: "
            f"{len(vols) / wall * 60:.2f} volumes/min, "
            f"{windows * steps / wall:.3f} DDIM window-steps/s, busy "
            f"{busy:.3f}, peak memory {peak:.2f} GiB above the "
            f"{held / 2 ** 30:.2f} GiB held before")
    (c1, _, _, counts), (c2, *_) = runs["continuous"]
    walls = {k: [r[1] for r in v] for k, v in runs.items()}
    log(f"AMOS continuous against serial over the same stream: plan "
        f"{plan} against {serial_batches} serial batches; mean wall "
        f"{np.mean(walls['continuous']):.4f} / "
        f"{np.mean(walls['serial']):.4f} s "
        f"({np.mean(walls['serial']) / np.mean(walls['continuous']):.3f}x)")
    if not all(torch.equal(a, b) for x, y in zip(c1, c2)
               for a, b in zip(x, y)):
        fail("AMOS continuous: two runs over the same stream differ")
    compare_served("AMOS continuous", pred, CONT_SHAPES,
                   runs["serial"][0][0], c1)
    log(f"launches during amos_continuous ({len(plan)} window batches): "
        f"{counts}")
    if counts != {"conv3x3": AMOS_CONV_PER_BATCH * len(plan),
                  "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}:
        fail(f"AMOS continuous conv launches {counts}, predicted "
             f"{AMOS_CONV_PER_BATCH} x {len(plan)} forward, no backward")
    return {k: {"amos_continuous": c} for k, c in counts.items()}


def phase_continuous_attention(dev: torch.device, spans: list) -> dict:
    """AMOS AttentionDiffUNet: ``serve_volumes`` over CONT_ATT_SHAPES
    (batches 4, 4, 4, 4, 2 that mix the volumes): finite, binary, exactly
    ATT_CONV_PER_BATCH conv launches per batch; its batch statistics make
    the answer depend on the batches, so the largest difference from
    ``infer``'s is printed, not checked. Returns the launches."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / "cfg/amos/test.yaml", model_path=None,
        model_name="attention_diff_unet",
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED)
    vols = [synthetic_ct(s, SEED + 3 * i, dev)
            for i, s in enumerate(CONT_ATT_SHAPES)]
    serial, wall_s, busy_s = timed_run(
        lambda: [pred.infer(v) for v in vols], spans)
    reset_conv()
    cont, wall_c, busy_c = timed_run(lambda: pred.serve_volumes(
        vols, seeds=[pred.seed] * len(vols)), spans)
    counts = conv_counts()
    plan = [len(b) for b in pred._continuous.plan(CONT_ATT_SHAPES)]
    worst = max(compare_served("AMOS attention continuous", pred,
                               CONT_ATT_SHAPES, serial, cont,
                               fail_on_mismatch=False))
    log(f"AMOS attention_diff_unet continuous: plan {plan}, {wall_c:.3f} s "
        f"(busy {busy_c:.3f}) against serial {wall_s:.3f} s (busy "
        f"{busy_s:.3f}); largest logit difference from serial {worst:.4e} "
        f"of max |y| "
        f"(batch statistics: recorded, not checked); launches {counts}")
    if plan != [4, 4, 4, 4, 2]:
        fail(f"AMOS attention continuous plan {plan}, not [4, 4, 4, 4, 2]")
    if counts != {"conv3x3": ATT_CONV_PER_BATCH * len(plan),
                  "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}:
        fail(f"AMOS attention continuous conv launches {counts}, predicted "
             f"{ATT_CONV_PER_BATCH} x {len(plan)} forward, no backward")
    return {k: {"amos_attention_continuous": c} for k, c in counts.items()}


def phase_continuous_btcv(dev: torch.device, spans: list,
                          counters: dict) -> dict:
    """BTCV DiffSwinUNETR (``cfg/btcv/test.yaml``, unit 2):
    ``serve_volumes`` over CONT_BTCV_SHAPES against ``infer`` of each
    (``compare_served``); each Swin kernel exactly SERVE_PER_BATCH
    launches per planned batch. Returns the launches."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / "cfg/btcv/test.yaml", model_path=None,
        classes=str(ROOT / "cfg/btcv/classes.yaml"), device=dev, seed=SEED)
    vols = [synthetic_ct(s, SEED + i, dev)
            for i, s in enumerate(CONT_BTCV_SHAPES)]
    serial, wall_s, busy_s = timed_run(
        lambda: [pred.infer(v) for v in vols], spans)
    reset(counters)
    cont, wall_c, busy_c = timed_run(lambda: pred.serve_volumes(
        vols, seeds=[pred.seed] * len(vols)), spans)
    counts = {k: fn.launches for k, fn in counters.items()}
    backward = sum(getattr(fn, "backward_launches", 0)
                   for fn in counters.values())
    plan = [len(b) for b in pred._continuous.plan(CONT_BTCV_SHAPES)]
    log(f"BTCV continuous: plan {plan}, {wall_c:.3f} s (busy {busy_c:.3f}) "
        f"against serial {wall_s:.3f} s (busy {busy_s:.3f}) and "
        f"{sum(window_batches(pred._inferer, s) for s in CONT_BTCV_SHAPES)}"
        f" batches; launches {counts}")
    compare_served("BTCV continuous", pred, CONT_BTCV_SHAPES, serial, cont)
    for k, c in counts.items():
        if c != SERVE_PER_BATCH[k] * len(plan) or backward:
            fail(f"BTCV continuous {k}: {c} launches ({backward} backward),"
                 f" predicted {SERVE_PER_BATCH[k]} x {len(plan)}")
    return {k: {"btcv_continuous": c} for k, c in counts.items()}


def phase_continuous_tester(dev: torch.device, work: Path, serial: dict,
                            serial_seconds: list) -> dict:
    """``Tester.from_config("cfg/amos/test.yaml", continuous=2)`` over phase
    7's cases and weights: each case's outputs against phase 7's as
    ``compare_served`` holds logits' binaries, and where a case's outputs
    are the same, its dices, HD95s and IoUs bit for bit (else their
    differences printed); exactly 190 conv launches per planned batch;
    s/case against phase 7's. Returns the launches."""
    from diff_unet_tpu_torch.engine.engine import Tester

    tester = Tester.from_config(
        ROOT / "cfg/amos/test.yaml", data_path=str(work / "amos_eval"),
        model_path=str(work / "amos_eval_weights" / "epoch_3000"),
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED,
        continuous=2, log_dir=str(work / "amos_cont_logs"))
    reset_conv()
    t0 = time.perf_counter()
    results = tester.test()
    seconds = time.perf_counter() - t0
    counts = conv_counts()
    shapes = [tuple(x.shape) for x in results["images"]]
    plan = [len(b) for b in tester._continuous.plan(shapes)]
    for i, (a, b) in enumerate(zip(results["outputs"], serial["outputs"])):
        flips = float(np.mean(a != b))
        same = np.array_equal(a, b)
        deltas = {k: np.nanmax(np.abs(np.asarray(results[k][i], np.float64)
                                      - np.asarray(serial[k][i],
                                                   np.float64)))
                  for k in ("dices", "hd95s", "ious")}
        log(f"Tester(continuous=2) case {i} {shapes[i]}: outputs "
            f"{'equal' if same else f'differ on {flips:.3e} of the voxels'};"
            f" largest metric differences from phase 7 " + ", ".join(
                f"{k} {v:.3e}" for k, v in deltas.items()))
        if flips > CONT_FLIPS:
            fail(f"Tester(continuous=2) case {i}: outputs differ from the "
                 f"serial Tester's on {flips:.3e} of the voxels")
        if same and not all(np.array_equal(
                np.asarray(results[k][i]), np.asarray(serial[k][i]),
                equal_nan=True) for k in ("dices", "hd95s", "ious")):
            fail(f"Tester(continuous=2) case {i}: the same outputs, other "
                 "metrics")
    def per_case(split):
        return (np.mean([sum(s.values()) for s in split]),
                np.mean([s["inference"] for s in split]))

    log(f"Tester(continuous=2): {len(shapes)} cases in {seconds:.3f} s, plan "
        f"{plan}; s/case, inference s/case %.4f, %.4f against phase 7's "
        f"%.4f, %.4f; launches {counts}" % (*per_case(tester.case_seconds),
                                           *per_case(serial_seconds)))
    if counts != {"conv3x3": AMOS_CONV_PER_BATCH * len(plan),
                  "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}:
        fail(f"Tester(continuous=2) conv launches {counts}, predicted "
             f"{AMOS_CONV_PER_BATCH} x {len(plan)} forward, no backward")
    return {k: {"amos_test_continuous": c} for k, c in counts.items()}


def phase_continuous_predict(dev: torch.device, work: Path,
                             spans: list) -> None:
    """``python -m diff_unet_tpu_torch.predict`` in process over phase 7's
    two CTs, each listed twice (without the foreground crop each is
    100x196x196: 18 windows): every labelmap against ``predict_volume``'s
    on the same weights, bit for bit where each window ran at the same
    batch size on both paths (here: all), else on all but CONT_FLIPS of
    the voxels; volumes/min and busy share against the serial loop
    (load, infer and write each in turn)."""
    from diff_unet_tpu_torch import predict
    from diff_unet_tpu_torch.data.nifti import read_nifti
    from diff_unet_tpu_torch.engine.engine import Predictor

    cts = [str(work / "amos_eval" / f"ct_{i}.nii.gz") for i in range(2)]
    inputs = cts * 2
    weights = str(work / "amos_eval_weights" / "epoch_3000")
    classes = str(ROOT / "cfg/amos/classes.yaml")
    t0 = time.perf_counter()
    engine = Predictor.from_config(
        ROOT / "cfg/amos/test.yaml", model_path=weights, classes=classes,
        device=dev, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serial_dir = work / "predict_serial"
    serial_dir.mkdir()
    serial, wall_s, busy_s = timed_run(lambda: [
        predict.predict_volume(engine, p, serial_dir / f"{i}.nii.gz")
        for i, p in enumerate(inputs)], spans)
    out_dir = work / "predict_many"
    many, wall_c, busy_c = timed_run(lambda: predict.main([
        "--config", str(ROOT / "cfg/amos/test.yaml"),
        f"model_path={weights}", f"classes={classes}", f"seed={SEED}",
        "input=" + ",".join(inputs), f"output={out_dir}"]), spans)
    shapes = [tuple(x.shape) for x in serial]
    sizes_serial, sizes_cont = batch_sizes(engine, shapes)
    windows = sum(len(engine._inferer._starts(
        tuple(max(r, s) for r, s in zip(engine._inferer.roi, sh))))
        for sh in shapes)
    # an input listed twice writes one file: its last listing's labelmap
    names = [predict._output_name(p) for p in inputs]
    last = {name: i for i, name in enumerate(names)}
    for name, i in last.items():
        if not np.array_equal(read_nifti(out_dir / name).data, many[i]):
            fail(f"predict: {name} does not hold input {i}'s labelmap")
    for i, (a, b) in enumerate(zip(many, serial)):
        flips = float(np.mean(a != b))
        same = np.array_equal(a, b)
        log(f"predict input {i} {shapes[i]}: labelmap "
            + ("equal" if same else f"differs on {flips:.3e} of the voxels")
            + f" to predict_volume's; batch sizes serial {sizes_serial[i]},"
            f" continuous {sizes_cont[i]}")
        if (sizes_serial[i] == sizes_cont[i] and not same) \
                or flips > CONT_FLIPS:
            fail(f"predict input {i}: labelmap differs from "
                 "predict_volume's")
    log(f"predict, {len(inputs)} inputs ({windows} windows): main "
        f"(predict_many) {wall_c:.3f} s ({len(inputs) / wall_c * 60:.2f} "
        f"volumes/min, busy {busy_c:.3f}; its Predictor build included, "
        f"{build_s:.3f} s for the serial loop's) against the serial loop "
        f"{wall_s:.3f} s ({len(inputs) / wall_s * 60:.2f} volumes/min, "
        f"busy {busy_s:.3f})")


def phase_continuous(dev: torch.device, work: Path, swin: dict,
                     serial: dict, serial_seconds: list) -> dict:
    """Phase 5m: continuous serving on every path that reaches it."""
    t0 = time.perf_counter()
    paths = {}
    with ddim_spans() as spans:
        for part in (phase_continuous_amos(dev, spans),
                     phase_continuous_attention(dev, spans),
                     phase_continuous_btcv(dev, spans, swin),
                     phase_continuous_tester(dev, work, serial,
                                             serial_seconds)):
            for k, v in part.items():
                paths.setdefault(k, {}).update(v)
        phase_continuous_predict(dev, work, spans)
    log(f"phase 5m: {time.perf_counter() - t0:.1f} s")
    return paths


def check_s8_quantizer(dev: torch.device) -> None:
    """The s8 kernel's quantize on load, value by value: a conv whose
    kernel is the identity at the centre tap returns each quantized input
    value as its int32 sum. Every finite bf16 bit pattern (64 channels by
    TMA into the staging ring, and 16 channels gathered) and 2^20 random
    float32 values (gathered), at S8_QUANT_SCALES, with and without a
    random prologue, must give ``quantize_input``'s int8 values exactly."""
    from diff_unet_tpu_torch.ops import int8 as q

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=dev)
    allbf = bits.to(torch.int16).view(torch.bfloat16)
    allbf = torch.where(torch.isfinite(allbf), allbf, torch.zeros_like(allbf))
    f32 = torch.randn(2 ** 20, generator=g, device=dev) * 30.0
    inputs = [("all bf16 values, 64 channels",
               allbf.reshape(1, 4, 16, 16, 64)),
              ("all bf16 values, 16 channels",
               allbf.reshape(1, 16, 16, 16, 16)),
              ("random float32, 16 channels",
               f32.reshape(16, 16, 16, 16, 16))]
    checked = 0
    for name, x in inputs:
        n, c = x.shape[0], x.shape[-1]
        wq = torch.zeros((c, c, 3, 3, 3), dtype=torch.int8, device=dev)
        wq[torch.arange(c), torch.arange(c), 1, 1, 1] = 1
        for sa in S8_QUANT_SCALES:
            sa = torch.tensor(sa, device=dev)
            pro = tuple((torch.randn((n, c), generator=g, device=dev) * sd
                         + mu).to(x.dtype)
                        for mu, sd in ((1.0, 0.5), (0.0, 2.0), (0.0, 1.0))
                        ) + (0.1,)
            for pr in (None, pro):
                got = q.conv3x3_int8([x], wq, sa, None, None, torch.int32,
                                     prologue=pr)
                want = q.quantize_input([x], sa, pr)[0].to(torch.int32)
                if not torch.equal(got, want):
                    bad = (got != want).sum().item()
                    fail(f"s8 quantize on load, {name}, sa {sa.item():g}, "
                         f"prologue {pr is not None}: {bad} values differ "
                         "from quantize_input")
                checked += x.numel()
    log(f"s8 quantize on load: {checked} values (every finite bf16 value "
        f"in both paths, random float32) at scales {S8_QUANT_SCALES}, with "
        "and without a prologue, equal quantize_input bit for bit")


def check_int8_deconv(dev: torch.device) -> None:
    """The UpCat transposed conv at the AMOS L0 and L3 shapes (N 4):
    ``deconv2_int8`` on the card (one ``torch._int_mm``, the rescale on its
    compact output, then the scatter) against its plain version (a float64
    transposed conv of the int8 values, then the rescale), the raw int32
    sums and the rescaled bf16 output bit for bit."""
    from diff_unet_tpu_torch.ops import int8 as q

    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    for cin, cout, side in ((128, 64, 48), (512, 256, 6)):
        xq = torch.randint(-127, 128, (CONV_N, side, side, side, cin),
                           generator=g, device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cin, cout, 2, 2, 2), generator=g,
                           device=dev, dtype=torch.int8)
        sa = torch.tensor(0.02, device=dev)
        sw = 1e-4 + 1e-3 * torch.rand((cout,), generator=g, device=dev)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        want = q.deconv2_int8_plain(xq, wq)
        raw = torch.equal(q.deconv2_int8(xq, wq), want)
        y = torch.equal(q.deconv2_int8(xq, wq, sa, sw, b, torch.bfloat16),
                        q.rescale(want, sa, sw, b, torch.bfloat16))
        if not (raw and y):
            fail(f"deconv2_int8 {cin}->{cout} at {CONV_N}x{side}^3: int32 "
                 f"exact {raw}, rescaled bf16 exact {y}")
    log("deconv2_int8 at the L0 and L3 UpCat shapes: int32 and rescaled "
        "bf16 bit for bit")


def s8_modes(dev: torch.device, g: torch.Generator, name: str,
             chans: list, cout: int, shape: tuple, float_dtypes: tuple,
             slope: float, no_film: bool = False, concat: bool = False):
    """The s8 conv kernel against its plain version at one shape (random
    int8 weights over the whole int8 range, a bias, the (Cout,) weight
    scales) in its input modes: int8 parts over the whole int8 range (with
    ``concat`` and more than one part, also their concat as one part);
    float parts with ``sa``, quantized on load, in each of
    ``float_dtypes``; and bf16 y through a random norm prologue (a and b
    rounded to bf16, a film, ``slope``; with ``no_film`` also without the
    film) with a static ``sa``. In each mode the raw int32 sums and the rescaled bf16 output
    bit for bit against the plain version (``quantize_input``, then a
    float64 convolution of the int8 values), the statistics within
    STATS_TOL; fails otherwise. Returns ({mode: (kernel ms, bound, max
    abs err of the int32 sums, plain ms)}, the int8 parts, wq, bias)."""
    from diff_unet_tpu_torch.ops import int8 as q
    from diff_unet_tpu_torch.ops.conv3d import STATS_TOL

    n, side = shape[0], shape[1]
    cin = sum(chans)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3, 3), generator=g,
                       device=dev, dtype=torch.int8)
    sw = 1e-4 + 1e-3 * torch.rand((cout,), generator=g, device=dev)
    b = 0.1 * torch.randn((cout,), generator=g, device=dev)
    flops = 2.0 * math.prod(shape) * cout * 27 * cin
    reps = 3 if side == 96 else 10
    int8_parts = [torch.randint(-127, 128, (*shape, c), generator=g,
                                device=dev, dtype=torch.int8)
                  for c in chans]
    modes = [("int8 parts", int8_parts, None, None)]
    if concat and len(chans) > 1:
        modes.append(("int8 concat", [torch.cat(int8_parts, -1)], None,
                      None))
    for fdt in float_dtypes:
        x = [(2.0 * torch.randn((*shape, c), generator=g, device=dev))
             .to(fdt) for c in chans]
        modes.append((f"{str(fdt)[6:]} parts", x, q.act_scale(x), None))
    y = [torch.randn((*shape, c), generator=g, device=dev)
         .to(torch.bfloat16) for c in chans]
    pro = tuple((torch.randn((n, cin), generator=g, device=dev) * sd
                 + mu).to(torch.bfloat16)
                for mu, sd in ((1.0, 0.3), (0.0, 0.3), (0.0, 0.2))
                ) + (slope,)
    modes.append(("bf16 y + prologue", y,
                  torch.tensor(3.0 / 127, device=dev), pro))
    if no_film:
        modes.append(("bf16 y + prologue, no film", y,
                      torch.tensor(3.0 / 127, device=dev),
                      (*pro[:2], None, slope)))
    times = {}
    for mode, parts, sa, pr in modes:
        kw = dict(prologue=pr)
        if sa is None:
            acc = q.conv3x3_int8(parts, wq)
            sa = torch.tensor(0.02, device=dev)
        else:
            acc = q.conv3x3_int8(parts, wq, sa, None, None, torch.int32,
                                 **kw)
        want = q.conv3x3_int8_plain(parts, wq, sa, pr)
        raw_exact = torch.equal(acc, want)
        err = (acc.double() - want.double()).abs().max().item()
        yk = q.conv3x3_int8(parts, wq, sa, sw, b, torch.bfloat16, **kw)
        y_exact = torch.equal(yk, q.rescale(want, sa, sw, b,
                                            torch.bfloat16))
        ys, st = q.conv3x3_int8(parts, wq, sa, sw, b, torch.bfloat16,
                                with_stats=True, **kw)
        _, wst = q._finish(want, sa, sw, b, torch.bfloat16, True)
        st_err = (st - wst).abs().max().item()
        st_tol = STATS_TOL * wst.abs().max().item()
        if not (raw_exact and y_exact and torch.equal(ys, yk)
                and st_err <= st_tol):
            fail(f"{name} ({mode}) disagrees with its plain version: "
                 f"int32 exact {raw_exact} (max err {err:.3e}), "
                 f"rescaled exact {y_exact}, stats err {st_err:.3e} "
                 f"(tol {st_tol:.3e})")
        del acc, want, wst, yk
        ms = cuda_ms(lambda: q.conv3x3_int8(parts, wq, sa, sw, b,
                                            torch.bfloat16,
                                            with_stats=True, **kw),
                     reps, 1)
        bnd = bound(nbytes(*parts, wq, ys, st, sw, b,
                           *(pr or ())[:3]), flops, torch.int8)
        plain_ms = cuda_ms(lambda: q._finish(
            q.conv3x3_int8_plain(parts, wq, sa, pr), sa, sw, b,
            torch.bfloat16, True), 1, 1)
        times[mode] = (ms, bnd, err, plain_ms)
        log(f"{name} {mode}: int32 and rescaled bf16 bit for bit, "
            f"stats err {st_err:.3e} (tol {st_tol:.3e}); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
            f"{flops / ms / 1e9:.1f} TOP/s")
        del ys, st
    return times, int8_parts, wq, b


def int_mm_ms(m: int, k: int, n: int, dev: torch.device, reps: int) -> float:
    """ms of one ``torch._int_mm`` of an int8 (m, k) by (k, n) product,
    k and n padded to multiples of 8 as it requires."""
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    a_mat = torch.full((max(m, 32), k8), 3, dtype=torch.int8, device=dev)
    b_t = torch.full((n8, k8), 2, dtype=torch.int8, device=dev)
    return cuda_ms(lambda: torch._int_mm(a_mat, b_t.t()), reps, 1)


def phase_conv_s8(dev: torch.device) -> dict:
    """The s8 conv kernel against its plain version at every S8_CASES shape
    (N = CONV_N) in its three input modes (``s8_modes``: int8 parts; float
    parts quantized on load, bf16, the stems also float32, the main path's
    dtype there; bf16 y through a norm prologue with a film, slope 0.1),
    with the times of each mode and of its plain version (with its
    statistics), the bf16 kernel at the same shape and switches, and
    ``torch._int_mm`` on the im2col GEMM's shape (the product alone), and
    each mode's bound at the int8 peak (its own input bytes)."""
    from diff_unet_tpu_torch.ops.conv3d import conv3x3

    check_s8_quantizer(dev)
    check_int8_deconv(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    report = {}
    sums = dict(ms=0.0, float_ms=0.0, prologue_ms=0.0, bf16_ms=0.0,
                int_mm_ms=0.0, bound_ms=0.0, prologue_bound_ms=0.0)
    for tag, chans, cout, side in S8_CASES:
        shape = (CONV_N, side, side, side)
        cin = sum(chans)
        name = f"conv3x3_int8 {tag} {chans}->{cout} at {CONV_N}x{side}^3"
        reps = 3 if side == 96 else 10
        times, int8_parts, wq, b = s8_modes(
            dev, g, name, chans, cout, shape,
            (torch.float32, torch.bfloat16) if tag in STEMS
            else (torch.bfloat16,), 0.1)
        parts_bf = [p.to(torch.bfloat16) for p in int8_parts]
        w_bf = wq.float() * 1e-3
        bf16_ms = cuda_ms(lambda: conv3x3(parts_bf, w_bf, b,
                                          with_stats=True), reps, 1)
        del parts_bf
        mm_ms = int_mm_ms(CONV_N * side ** 3, 27 * cin, cout, dev, reps)
        fmode = f"{'float32' if tag in STEMS else 'bfloat16'} parts"
        log(f"{name}: bf16 kernel {bf16_ms:.4f} ms, torch._int_mm on the im2col GEMM (product alone) "
            f"{mm_ms:.4f} ms; s8 kernel / bf16 kernel: int8 parts "
            f"{times['int8 parts'][0] / bf16_ms:.3f}, {fmode} "
            f"{times[fmode][0] / bf16_ms:.3f}, prologue "
            f"{times['bf16 y + prologue'][0] / bf16_ms:.3f}")
        for key, v in (("ms", times["int8 parts"][0]),
                       ("float_ms", times[fmode][0]),
                       ("prologue_ms", times["bf16 y + prologue"][0]),
                       ("bf16_ms", bf16_ms), ("int_mm_ms", mm_ms),
                       ("bound_ms", times["int8 parts"][1]["bound_ms"]),
                       ("prologue_bound_ms",
                        times["bf16 y + prologue"][1]["bound_ms"])):
            sums[key] += v
        if tag == S8_REPORT:
            # the kernels line: the main path's mode at this conv (bf16
            # parts quantized on load, dynamic scales), the others beside
            ms, bnd, err, plain_ms = times[fmode]
            report["conv3x3_int8"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                int8_parts_ms=times["int8 parts"][0],
                prologue_ms=times["bf16 y + prologue"][0],
                prologue_bound_ms=times["bf16 y + prologue"][1]["bound_ms"],
                bf16_kernel_ms=bf16_ms, int_mm_product_ms=mm_ms, **bnd)
        del int8_parts, times
    log("conv3x3_int8 over the S8_CASES shapes (one each): kernel int8 "
        f"parts {sums['ms']:.3f} ms, float parts {sums['float_ms']:.3f} "
        f"ms, bf16 y + prologue {sums['prologue_ms']:.3f} ms; bf16 kernel "
        f"{sums['bf16_ms']:.3f} ms, torch._int_mm {sums['int_mm_ms']:.3f} "
        f"ms, bound {sums['bound_ms']:.3f} ms (prologue mode "
        f"{sums['prologue_bound_ms']:.3f})")
    return report


def check_conv1x1_int8(dev: torch.device) -> None:
    """``conv1x1_int8`` at each S8_SWIN_1X1 shape (N = BTCV_N): on the card
    (one ``torch._int_mm``, K and Cout padded to 8) against its plain
    version (a float64 product of the int8 values), the raw int32 sums and
    the rescaled bf16 output bit for bit; the times of the wrapper, of its
    plain version and of the library product alone (``torch._int_mm``
    over the same (voxels, Cin) x (Cin, Cout))."""
    from diff_unet_tpu_torch.ops import int8 as q

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    total = dict(ms=0.0, plain_ms=0.0, int_mm_ms=0.0, bound_ms=0.0)
    for tag, cin, cout, side in S8_SWIN_1X1:
        shape = (BTCV_N, side, side, side)
        xq = torch.randint(-127, 128, (*shape, cin), generator=g,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, 1, 1, 1), generator=g,
                           device=dev, dtype=torch.int8)
        sa = torch.tensor(0.02, device=dev)
        sw = 1e-4 + 1e-3 * torch.rand((cout,), generator=g, device=dev)
        b = 0.1 * torch.randn((cout,), generator=g, device=dev)
        want = q.conv1x1_int8_plain(xq, wq)
        raw = torch.equal(q.conv1x1_int8(xq, wq), want)
        y = q.conv1x1_int8(xq, wq, sa, sw, b, torch.bfloat16)
        y_exact = torch.equal(y, q.rescale(want, sa, sw, b, torch.bfloat16))
        name = f"conv1x1_int8 {tag} {cin}->{cout} at {BTCV_N}x{side}^3"
        if not (raw and y_exact):
            fail(f"{name}: int32 exact {raw}, rescaled bf16 exact {y_exact}")
        reps = 5 if side == 96 else 20
        ms = cuda_ms(lambda: q.conv1x1_int8(xq, wq, sa, sw, b,
                                            torch.bfloat16), reps, 1)
        plain_ms = cuda_ms(lambda: q.rescale(q.conv1x1_int8_plain(xq, wq),
                                             sa, sw, b, torch.bfloat16), 1, 1)
        mm_ms = int_mm_ms(xq.numel() // cin, cin, cout, dev, reps)
        bnd = bound(nbytes(xq, wq, y, sw, b), 2.0 * y.numel() * cin,
                    torch.int8)
        log(f"{name}: int32 and rescaled bf16 bit for bit; wrapper {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, torch._int_mm alone "
            f"{mm_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("int_mm_ms", mm_ms),
                     ("bound_ms", bnd["bound_ms"])):
            total[k] += v
        del xq, want, y
    log(f"conv1x1_int8 over the {len(S8_SWIN_1X1)} BTCV 1x1 shapes (one "
        f"each): wrapper {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} "
        f"ms, torch._int_mm {total['int_mm_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms")


def phase_conv_s8_swin(dev: torch.device) -> None:
    """The s8 conv kernel at every DiffSwinUNETR 3x3x3 conv shape of a BTCV
    window batch (S8_SWIN_CASES, N = BTCV_N) against its plain version in
    the input modes of ``s8_modes`` (int8 parts and their concat, which
    the blocks with a 1x1 projection take: one quantization for both
    convs; float parts quantized on load, float32 at the stems and bf16
    elsewhere; bf16 y through the norm prologue at slope 0.01, with a film
    and, where the encoder's un-timed blocks run the shape, without), with
    times beside the bf16 kernel and cuDNN's bf16 ``F.conv3d`` (on the
    channels_last_3d view, ``var_mean`` of its output for the statistics)
    at the same shape, and the bound at the int8 peak; an estimate of one
    window batch's s8 time (each mode's time times the launches S8_SWIN_CASES
    gives it a batch), printed beside what phase 10c measures in a real
    batch; then ``conv1x1_int8`` at its 7 shapes
    (``check_conv1x1_int8``)."""
    from diff_unet_tpu_torch.ops.conv3d import conv3x3

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    sums = {k: 0.0 for k in ("static", "dynamic", "static_bound",
                             "dynamic_bound", "bf16_ms", "cudnn_ms")}
    for tag, chans, cout, side, per_mode in S8_SWIN_CASES:
        shape = (BTCV_N, side, side, side)
        cin = sum(chans)
        name = (f"conv3x3_int8 BTCV {tag} {chans}->{cout} at "
                f"{BTCV_N}x{side}^3")
        reps = 3 if side == 96 else 10
        stem = cin < 32
        times, int8_parts, wq, b = s8_modes(
            dev, g, name, chans, cout, shape,
            (torch.float32,) if stem else (torch.bfloat16,), UNETR_SLOPE,
            no_film=any(m.endswith("no film") for m in per_mode),
            concat=True)
        parts_bf = [p.to(torch.bfloat16) for p in int8_parts]
        w_bf = wq.float() * 1e-3
        bf16_ms = cuda_ms(lambda: conv3x3(parts_bf, w_bf, b,
                                          with_stats=True), reps, 1)
        x_cl = torch.cat(parts_bf, -1).permute(0, 4, 1, 2, 3)
        w_cl = w_bf.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        b_l = b.to(torch.bfloat16)

        def cudnn():
            y = torch.nn.functional.conv3d(x_cl, w_cl, b_l, padding=1)
            torch.var_mean(y, dim=(2, 3, 4))

        cudnn_ms = cuda_ms(cudnn, reps, 1)
        del parts_bf, x_cl
        launches = sum(per_mode.values())
        for mode, c in per_mode.items():
            # a dynamic scale on conv2 materialises its bf16 input
            dyn = "bfloat16 parts" if mode.startswith("bf16 y") else mode
            for key, m in (("static", mode), ("dynamic", dyn)):
                sums[key] += c * times[m][0]
                sums[f"{key}_bound"] += c * times[m][1]["bound_ms"]
        sums["bf16_ms"] += launches * bf16_ms
        sums["cudnn_ms"] += launches * cudnn_ms
        path = ", ".join(f"{m} x{c} {times[m][0]:.4f} ms"
                         for m, c in per_mode.items())
        log(f"{name}: a window batch's launches {path}; bf16 kernel "
            f"{bf16_ms:.4f} ms, cuDNN bf16 {cudnn_ms:.4f} ms; s8 (path "
            f"modes, mean) / cuDNN "
            f"{sum(times[m][0] * c for m, c in per_mode.items()) / launches / cudnn_ms:.3f}")
        del int8_parts, times
    log("conv3x3_int8 at the BTCV shapes, an estimate of one window batch "
        "(this phase's times by the launches S8_SWIN_CASES gives each mode;"
        f" phase 10c measures a real batch): s8 static scales "
        f"{sums['static']:.3f} ms (bound {sums['static_bound']:.3f}), "
        f"dynamic {sums['dynamic']:.3f} ms (bound "
        f"{sums['dynamic_bound']:.3f}); bf16 kernel {sums['bf16_ms']:.3f} "
        f"ms, cuDNN bf16 {sums['cudnn_ms']:.3f} ms")
    check_conv1x1_int8(dev)


def phase_int8_window(dev: torch.device) -> None:
    """One AMOS window batch (sw_batch_size 4 of 96^3 windows of a
    synthetic 96x192x192 CT, seeded full-width weights, one x_T) through
    ``ddim_sample`` served bf16, int8 with dynamic scales and int8 with
    static scales calibrated on the CT's first window: seconds per batch
    over INT8_REPS (after a warm-up), DDIM window-steps/s, exactly
    INT8_PER_BATCH s8 launches and no bf16 conv launch per int8 batch, no
    weight packed again in the timed batches (``packed_weight.packs``),
    and each int8 answer's largest distance from bf16 as a fraction of max
    |y| and its share of differing binary voxels."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, packed_weight
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8

    kw = dict(model_path=None, classes=str(ROOT / "cfg/amos/classes.yaml"),
              device=dev, seed=SEED)
    bf = Predictor.from_config(ROOT / "cfg/amos/test.yaml", **kw)
    qp = Predictor.from_config(ROOT / "cfg/amos/test.yaml", quantize=True,
                               **kw)
    vol = synthetic_ct(AMOS_BODY, SEED + 5, dev)
    r = bf._inferer.roi[0]
    windows = torch.stack([vol[:, y:y + r, x:x + r] for y in (0, r)
                           for x in (0, r)])
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    noise = torch.randn((len(windows), r, r, r, bf.num_classes),
                        generator=g, device=dev)
    steps = bf.seg.sample_steps
    out = {}
    for name, pred in (("bf16", bf), ("int8 dynamic", qp),
                       ("int8 static", qp)):
        if name == "int8 static":
            pred.calibrate(vol)
        with torch.inference_mode():
            pred.seg.ddim_sample(windows, noise=noise)     # warm-up
            torch.cuda.synchronize()
            reset({"conv3x3": conv3x3, "conv3x3_int8": conv3x3_int8})
            packs = packed_weight.packs
            t0 = time.perf_counter()
            for _ in range(INT8_REPS):
                y = pred.seg.ddim_sample(windows, noise=noise)
            torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / INT8_REPS
        launches = (conv3x3.launches, conv3x3_int8.launches)
        packs = packed_weight.packs - packs
        want = ((INT8_PER_BATCH * INT8_REPS, 0) if name == "bf16"
                else (0, INT8_PER_BATCH * INT8_REPS))
        if launches != want or packs or not torch.isfinite(y).all():
            fail(f"AMOS window batch {name}: (bf16, s8) conv launches "
                 f"{launches}, predicted {want}; weight packs in the timed "
                 f"batches {packs} (0: packed once); finite "
                 f"{bool(torch.isfinite(y).all())}")
        out[name] = y
        msg = (f"AMOS window batch {name}: {sec:.4f} s, "
               f"{len(windows) * steps / sec:.2f} DDIM window-steps/s")
        if name != "bf16":
            ref = out["bf16"]
            dist = ((y - ref).abs().max() / ref.abs().max()).item()
            flips = ((y > 0) != (ref > 0)).float().mean().item()
            msg += (f", max |y - y_bf16| / max |y_bf16| {dist:.4e}, binary "
                    f"voxels differing {flips:.4e}")
        log(msg)
    del bf, qp, out


@contextlib.contextmanager
def unetr_conv_count():
    """Count the float 3x3x3 convs of the UNETR blocks while open: every
    forward of ``ops/blocks.py:Conv`` with a 3x3x3 kernel (cuDNN), which a
    quantized block never runs. Yields a one-element list."""
    from diff_unet_tpu_torch.ops import blocks

    count = [0]
    inner = blocks.Conv.forward

    def forward(self, x):
        count[0] += self.weight.shape[-1] == 3
        return inner(self, x)

    blocks.Conv.forward = forward
    try:
        yield count
    finally:
        blocks.Conv.forward = inner


def btcv_windows(dev: torch.device, pred):
    """The window batch of phases 9e-f: the first sw_batch_size 96^3 windows
    (along W) of a synthetic 96x192x192 CT, and one x_T for them."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct

    vol = synthetic_ct(AMOS_BODY, SEED + 7, dev)
    r = pred._inferer.roi[0]
    windows = torch.stack([vol[:, :r, x:x + r]
                           for x in (0, r)][:pred.sw_batch_size])
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    noise = torch.randn((len(windows), r, r, r, pred.num_classes),
                        generator=g, device=dev)
    return vol, windows, noise


def traced_btcv_batch(pred, windows, noise) -> dict:
    """One more window batch of ``pred`` under ``torch.profiler``, each
    ``conv3x3_int8``, ``conv1x1_int8`` and float 3x3x3 UNETR conv call
    (``ops/blocks.py``) in a ``record_function`` range of its name: the
    device ms of every kernel, of each range (every kernel that its calls
    launched through PyTorch), of ``torch._int_mm``, of the s8 calls (the
    kernels of the native library, ``conv3d_wgmma`` and its
    ``stats_reduce``, which the profiler does not place in the range and
    are taken by name, and the range's own), and the s8 launches' summed
    bound, each computed from that launch's own tensors at the int8
    peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from diff_unet_tpu_torch.ops import blocks
    from diff_unet_tpu_torch.profile_batch import _device_us

    s8, gemm, conv_fwd = (blocks.conv3x3_int8, blocks.conv1x1_int8,
                          blocks.Conv.forward)
    bound_ms = [0.0]

    def s8_call(parts, wq, sa=None, sw=None, bias=None, *a, **kw):
        with record_function("conv3x3_int8"):
            out = s8(parts, wq, sa, sw, bias, *a, **kw)
        y = out[0] if isinstance(out, tuple) else out
        pro = [t for t in (kw.get("prologue") or ())[:3]
               if isinstance(t, torch.Tensor)]
        flops = 2.0 * y.numel() * 27 * sum(p.shape[-1] for p in parts)
        bound_ms[0] += bound(nbytes(*parts, wq, y, sw, bias, *pro), flops,
                             torch.int8)["bound_ms"]
        return out

    def gemm_call(*a, **kw):
        with record_function("conv1x1_int8"):
            return gemm(*a, **kw)

    def conv_call(self, x):
        if self.weight.shape[-1] != 3:
            return conv_fwd(self, x)
        with record_function("unetr_conv3x3"):
            return conv_fwd(self, x)

    blocks.conv3x3_int8, blocks.conv1x1_int8 = s8_call, gemm_call
    blocks.Conv.forward = conv_call
    try:
        with torch.inference_mode(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred.seg.ddim_sample(windows, noise=noise)
            torch.cuda.synchronize()
    finally:
        blocks.conv3x3_int8, blocks.conv1x1_int8 = s8, gemm
        blocks.Conv.forward = conv_fwd
    avgs = prof.key_averages()
    host = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in host]

    def kernel_ms(*names):
        return sum(_device_us(e, True) for e in kernels
                   if any(n in e.key for n in names)) / 1e3

    def range_ms(name):
        return sum(_device_us(e, False) for e in avgs if e.key == name
                   and e.device_type == DeviceType.CPU) / 1e3

    s8_kernel_ms = kernel_ms("conv3d_wgmma", "stats_reduce")
    return {"device_ms": kernel_ms(""), "s8_kernel_ms": s8_kernel_ms,
            "s8_ms": s8_kernel_ms + range_ms("conv3x3_int8"),
            "gemm_ms": range_ms("conv1x1_int8"),
            "int_mm_ms": range_ms("aten::_int_mm"),
            "cudnn_ms": range_ms("unetr_conv3x3"),
            "s8_bound_ms": bound_ms[0]}


def phase_int8_window_btcv(dev: torch.device) -> dict:
    """One BTCV window batch (``cfg/btcv/test.yaml``: sw_batch_size 2 of
    96^3 windows of a synthetic 96x192x192 CT, seeded full-width weights,
    one x_T) through ``ddim_sample`` served bf16, int8 with dynamic scales
    and int8 with static scales calibrated on the CT's first window:
    seconds per batch over INT8_REPS (after a warm-up), DDIM
    window-steps/s, exactly BTCV_INT8_PER_BATCH s8 launches and
    BTCV_GEMM_PER_BATCH int8 GEMMs per int8 batch and no float 3x3x3 conv
    of a UNETR block (cuDNN, ``unetr_conv_count``) nor a bf16 conv kernel
    launch, no weight packed again in the timed batches, finite outputs;
    each int8 answer's largest distance from bf16 as a fraction of max
    |y|, its share of differing binary voxels and its correlation with
    bf16, which must exceed INT8_SWIN_CORR (the JAX package's own test of
    the quantized DiffSwinUNETR against the float one). Then one more batch
    of each, traced (``traced_btcv_batch``): the device time of the s8
    convs and the int8 GEMMs in the int8 batches and of the UNETR blocks'
    cuDNN 3x3x3 convs in the bf16 one. Returns those measurements for the
    kernels line's s8 entry."""
    from diff_unet_tpu_torch.engine.engine import Predictor
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, packed_weight
    from diff_unet_tpu_torch.ops.int8 import conv1x1_int8, conv3x3_int8

    kw = dict(model_path=None, classes=str(ROOT / "cfg/btcv/classes.yaml"),
              device=dev, seed=SEED)
    bf = Predictor.from_config(ROOT / "cfg/btcv/test.yaml", **kw)
    qp = Predictor.from_config(ROOT / "cfg/btcv/test.yaml", quantize=True,
                               **kw)
    vol, windows, noise = btcv_windows(dev, bf)
    steps = bf.seg.sample_steps
    out, traced = {}, {}
    for name, pred in (("bf16", bf), ("int8 dynamic", qp),
                       ("int8 static", qp)):
        if name == "int8 static":
            pred.calibrate(vol)
        with torch.inference_mode(), unetr_conv_count() as cudnn:
            pred.seg.ddim_sample(windows, noise=noise)     # warm-up
            torch.cuda.synchronize()
            reset({"conv3x3": conv3x3, "conv3x3_int8": conv3x3_int8,
                   "conv1x1_int8": conv1x1_int8})
            cudnn[0] = 0
            packs = packed_weight.packs
            t0 = time.perf_counter()
            for _ in range(INT8_REPS):
                y = pred.seg.ddim_sample(windows, noise=noise)
            torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / INT8_REPS
        launches = (cudnn[0], conv3x3.launches, conv3x3_int8.launches,
                    conv1x1_int8.launches)
        packs = packed_weight.packs - packs
        want = ((BTCV_INT8_PER_BATCH * INT8_REPS, 0, 0, 0) if name == "bf16"
                else (0, 0, BTCV_INT8_PER_BATCH * INT8_REPS,
                      BTCV_GEMM_PER_BATCH * INT8_REPS))
        if launches != want or packs or not torch.isfinite(y).all():
            fail(f"BTCV window batch {name}: (cuDNN 3x3x3, bf16 kernel, s8, "
                 f"int8 GEMM) launches {launches}, predicted {want}; weight "
                 f"packs in the timed batches {packs} (0: packed once); "
                 f"finite {bool(torch.isfinite(y).all())}")
        out[name] = y
        msg = (f"BTCV window batch {name}: {sec:.4f} s, "
               f"{len(windows) * steps / sec:.2f} DDIM window-steps/s, "
               f"launches {launches}")
        if name != "bf16":
            ref = out["bf16"]
            dist = ((y - ref).abs().max() / ref.abs().max()).item()
            flips = ((y > 0) != (ref > 0)).float().mean().item()
            corr = torch.corrcoef(torch.stack([y.flatten().double(),
                                               ref.flatten().double()])
                                  )[0, 1].item()
            msg += (f", max |y - y_bf16| / max |y_bf16| {dist:.4e}, binary "
                    f"voxels differing {flips:.4e}, correlation with bf16 "
                    f"{corr:.6f}")
            if not corr > INT8_SWIN_CORR:
                fail(f"{msg}: correlation at most {INT8_SWIN_CORR}")
        log(msg)
        tr = traced_btcv_batch(pred, windows, noise)
        traced[name] = tr
        log(f"BTCV window batch {name}, traced: device {tr['device_ms']:.3f}"
            f" ms; " + (f"UNETR 3x3x3 convs on cuDNN {tr['cudnn_ms']:.3f} ms"
                        if name == "bf16" else
                        f"conv3x3_int8 calls {tr['s8_ms']:.3f} ms (the s8 "
                        f"kernel and its stats reduce {tr['s8_kernel_ms']:.3f}"
                        f" ms; bound {tr['s8_bound_ms']:.3f} ms), "
                        f"conv1x1_int8 calls {tr['gemm_ms']:.3f} ms "
                        f"(torch._int_mm {tr['int_mm_ms']:.3f} ms)"))
        key = "cudnn_ms" if name == "bf16" else "s8_kernel_ms"
        if not tr[key] > 0 or not tr["device_ms"] > 0:
            fail(f"BTCV window batch {name}, traced: no device time "
                 f"in {key} ({tr})")
    del bf, qp, out
    dyn, sta = traced["int8 dynamic"], traced["int8 static"]
    return {"btcv_batch_s8_dynamic_ms": dyn["s8_ms"],
            "btcv_batch_s8_static_ms": sta["s8_ms"],
            "btcv_batch_s8_static_bound_ms": sta["s8_bound_ms"],
            "btcv_batch_s8_dynamic_bound_ms": dyn["s8_bound_ms"],
            "btcv_batch_int8_gemm_dynamic_ms": dyn["gemm_ms"],
            "btcv_batch_int8_gemm_static_ms": sta["gemm_ms"],
            "btcv_batch_cudnn_bf16_ms": traced["bf16"]["cudnn_ms"]}


def phase_serve_btcv_int8(dev: torch.device) -> dict:
    """``Predictor.from_config("cfg/btcv/test.yaml", quantize=True)`` on one
    96x192x192 CT (``phase_serve``: 5 window batches, each with exactly
    BTCV_INT8_PER_BATCH s8 launches, BTCV_GEMM_PER_BATCH int8 GEMMs, the
    Swin kernels' SERVE_PER_BATCH and no bf16 conv); then, calibrated on
    that CT, ``serve_volumes`` over CONT_BTCV_SHAPES against ``infer`` of
    each (``compare_served``: bit for bit where every window ran at the
    same batch size on both paths, since static scales make a window's int8
    inputs independent of its companions; elsewhere the binaries within
    CONT_FLIPS and the logits within INT8_CONT_FACTOR times the bf16
    model's own distance, read in this phase on the same volumes). Returns
    the launches under ``btcv_int8_serve``."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.engine.engine import Predictor
    from diff_unet_tpu_torch.ops.conv3d import conv3x3
    from diff_unet_tpu_torch.ops.int8 import conv1x1_int8, conv3x3_int8
    from diff_unet_tpu_torch.ops.window_attention import window_attention
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, reverse_windows)
    from diff_unet_tpu_torch.ops.window_shift import shift_windows

    counters = {"window_attention": window_attention,
                "shift_windows": shift_windows,
                "window_partition": partition_windows,
                "window_reverse": reverse_windows, "conv3x3": conv3x3,
                "conv3x3_int8": conv3x3_int8, "conv1x1_int8": conv1x1_int8}
    per_batch = dict(SERVE_PER_BATCH, conv3x3=0,
                     conv3x3_int8=BTCV_INT8_PER_BATCH,
                     conv1x1_int8=BTCV_GEMM_PER_BATCH)
    paths = phase_serve(dev, "btcv", counters, per_batch,
                        path="btcv_int8_serve", shapes=((96, 192, 192),),
                        quantize=True)
    kw = dict(model_path=None, classes=str(ROOT / "cfg/btcv/classes.yaml"),
              device=dev, seed=SEED)
    vols = [synthetic_ct(s, SEED + i, dev)
            for i, s in enumerate(CONT_BTCV_SHAPES)]
    dists = {}
    for name, quantize in (("bf16", False), ("int8 static", True)):
        pred = Predictor.from_config(ROOT / "cfg/btcv/test.yaml",
                                     quantize=quantize, **kw)
        if quantize:
            pred.calibrate(vols[0])
        with ddim_spans() as spans:
            serial, wall_s, _ = timed_run(
                lambda: [pred.infer(v) for v in vols], spans)
            cont, wall_c, busy_c = timed_run(lambda: pred.serve_volumes(
                vols, seeds=[pred.seed] * len(vols)), spans)
        plan = [len(b) for b in pred._continuous.plan(CONT_BTCV_SHAPES)]
        log(f"BTCV {name} continuous: plan {plan}, {wall_c:.3f} s (busy "
            f"{busy_c:.3f}) against serial {wall_s:.3f} s")
        # a window in a batch of another size rounds the bf16 Swin
        # otherwise; the int8 model's distance is held to INT8_CONT_FACTOR
        # times the bf16 model's on the same volume
        tol = (CONT_TOL if name == "bf16" else
               [INT8_CONT_FACTOR * d for d in dists["bf16"]])
        dists[name] = compare_served(f"BTCV {name} continuous", pred,
                                     CONT_BTCV_SHAPES, serial, cont,
                                     logit_tol=tol)
        del pred, serial, cont
    log("BTCV continuous against serial, logits' largest difference as a "
        "fraction of max |y| per volume: int8 static "
        f"{', '.join(f'{d:.4e}' for d in dists['int8 static'])}; bf16 "
        f"{', '.join(f'{d:.4e}' for d in dists['bf16'])} (int8 held to "
        f"{INT8_CONT_FACTOR} times bf16)")
    del vols
    return paths


def phase_small_int8_swin(dev: torch.device) -> None:
    """A small DiffSwinUNETR(quantize=True) (feature 12, 32^3, fp32, TF32
    off, phase 4's weights and inputs) on the card against the CPU, its
    int8 state recorded on the CPU (kernels and scales calibrated by one
    DDIM-2 window there) and copied: the denoise within INT8_SMALL_TOL of
    max |y|. The card's float32 Swin rounds otherwise than the CPU's, and
    an activation within that rounding of a .5 quotient quantizes one
    int8 step (1/127 of the tensor's range) apart; the share of the
    int8 inputs that differ is printed."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.quantize import \
        quantize_inference_params
    from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
    from diff_unet_tpu_torch.ops import blocks
    from diff_unet_tpu_torch.ops.int8 import quantize_input
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, classes = 32, 3
    cpu = init_random(DiffSwinUNETR(classes, image_size=(s,) * 3,
                                    feature_size=12, quantize=True),
                      SEED).eval()
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.standard_normal((2, s, s, s, 1),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((2, s, s, s, classes),
                                             np.float32))
    t = torch.tensor([5, 250])
    quantize_inference_params(DiffusionSegmenter(cpu, classes,
                                                 sample_steps=2),
                              [image[:1]])
    gpu = DiffSwinUNETR(classes, image_size=(s,) * 3, feature_size=12,
                        quantize=True)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    copies = {}             # by identity: a shared scale stays shared
    for (o, p, *_), (og, *_) in zip(blocks.quant_sites(cpu),
                                    blocks.quant_sites(gpu)):
        for k in ("wq", "sw", "sa"):
            v = getattr(o, p + k)
            if id(v) not in copies:
                copies[id(v)] = v.to(dev)
            setattr(og, p + k, copies[id(v)])
    seen = {"cpu": [], "cuda": []}
    inner = blocks.conv3x3_int8

    def record(parts, wq, sa, *a, **kw):
        xq = (parts if parts[0].dtype == torch.int8
              else quantize_input(parts, sa, kw.get("prologue")))
        seen[parts[0].device.type].append(torch.cat(xq, -1).cpu())
        return inner(parts, wq, sa, *a, **kw)

    blocks.conv3x3_int8 = record
    try:
        with torch.inference_mode():
            want = cpu.denoise(image, x, t)
            got = gpu.denoise(image.to(dev), x.to(dev), t.to(dev)).cpu()
    finally:
        blocks.conv3x3_int8 = inner
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    diff = sum(int((a != b).sum()) for a, b in zip(seen["cpu"],
                                                   seen["cuda"]))
    total = sum(a.numel() for a in seen["cpu"])
    log(f"small DiffSwinUNETR int8 denoise (feature 12, {s}^3, fp32, "
        f"static scales) cuda vs cpu: max_abs_err {err:.3e} = "
        f"{err / scale:.3e} of max |y| {scale:.3f} (tol {INT8_SMALL_TOL}); "
        f"the int8 inputs of its {len(seen['cuda'])} 3x3x3 convs: {diff} of "
        f"{total} values differ from the CPU's")
    if not (torch.isfinite(got).all() and err <= INT8_SMALL_TOL * scale):
        fail("small quantized DiffSwinUNETR on the card disagrees with the "
             "CPU")


def phase_overfit(dev: torch.device, work: Path) -> dict:
    """The learning check at full width (``diff_unet_tpu_torch.overfit``
    at its defaults): the trajectory, a final mean dice of at least
    OVERFIT_DICE_FLOOR; then the saved ``.npz`` served by
    ``Predictor``s in bf16, int8 weights-only and int8 with
    ``quant_calibrate: 1`` (calibrated on the first case): each int8 mean
    dice within INT8_DICE_TOL of bf16's, the share of binary voxels that
    differ, and INT8_PER_BATCH s8 launches per volume (one window each)."""
    from diff_unet_tpu_torch import overfit
    from diff_unet_tpu_torch.ops.conv3d import conv3x3
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8

    npz = work / "overfit.npz"
    res = overfit.run(device="cuda", out=str(npz))
    final = res["trajectory"][-1][2]
    log(f"overfit: {len(res['losses'])} steps and "
        f"{len(res['trajectory'])} evaluations in {res['seconds']:.1f} s, "
        f"trajectory (iter, loss, mean dice) {res['trajectory']}")
    if not (np.isfinite(res["losses"]).all() and final
            >= OVERFIT_DICE_FLOOR):
        fail(f"overfit: final mean dice {final} < {OVERFIT_DICE_FLOOR}")
    images, _, onehot = overfit.make_cases()
    base = None
    counts = {}
    for name, kw in (("bf16", {}), ("int8 weights-only", {"quantize": True}),
                     ("int8 calibrated", {"quantize": True,
                                          "quant_calibrate": 1})):
        pred = overfit.build_predictor(device=dev, model_path=str(npz), **kw)
        if kw.get("quant_calibrate"):
            pred.calibrate(images[0])
        reset({"conv3x3": conv3x3, "conv3x3_int8": conv3x3_int8})
        t0 = time.perf_counter()
        dices, binaries = overfit.evaluate(pred, images, onehot)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        mean = float(np.mean(dices))
        msg = f"overfit model served {name}: mean dice {mean:.4f} {dices}, " \
              f"{sec:.3f} s for {len(images)} volumes"
        if base is None:
            base = (mean, dices, binaries)
            if conv3x3.launches != INT8_PER_BATCH * len(images):
                fail(f"overfit bf16 serving: {conv3x3.launches} conv "
                     "launches")
        else:
            flips = float(np.mean([(a != b).float().mean().item()
                                   for a, b in zip(binaries, base[2])]))
            delta = abs(mean - base[0])
            msg += (f"; |mean dice - bf16| {delta:.4f} (tol "
                    f"{INT8_DICE_TOL}), max case delta "
                    f"{max(abs(a - b) for a, b in zip(dices, base[1])):.4f}"
                    f", binary voxels differing {flips:.4e}")
            want = (0, INT8_PER_BATCH * len(images))
            got = (conv3x3.launches, conv3x3_int8.launches)
            if got != want or delta > INT8_DICE_TOL:
                fail(f"overfit {name}: (bf16, s8) launches {got}, "
                     f"predicted {want}; mean dice {mean:.4f} against "
                     f"bf16 {base[0]:.4f}")
            counts[name] = conv3x3_int8.launches
        log(msg)
    return {"conv3x3_int8": {"overfit_int8": counts["int8 calibrated"]}}

def parent_ddim_sample(seg, image: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """DDIM-10 at eta 0 as ``DiffusionSegmenter.ddim_sample`` computed it
    before the stochastic samplers came (START_X, FIXED_LARGE): the
    reference that the main path must still equal bit for bit."""
    from diff_unet_tpu_torch.diffusion.schedule import extract

    sched = seg.sample_schedule
    embeddings = seg.module.embed(image)
    x = noise.float()
    accum = torch.zeros_like(x)
    for step in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), step, dtype=torch.int64,
                       device=x.device)
        nd = x.dim()
        pred = torch.clamp(seg.module.denoise_with_embeddings(
            x, sched.map_timesteps(t), embeddings, image), -1.0, 1.0)
        eps = ((extract(sched, "sqrt_recip_alphas_cumprod", t, nd) * x
                - pred) / extract(sched, "sqrt_recipm1_alphas_cumprod", t,
                                  nd))
        abp = extract(sched, "alphas_cumprod_prev", t, nd)
        x = pred * torch.sqrt(abp) + torch.sqrt(1.0 - abp) * eps
        accum = accum + pred
    return accum


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (got moved to want's device)."""
    got, want = got.detach().float(), want.detach().float()
    return ((got.to(want.device) - want).abs().max()
            / want.abs().max()).item()


def core_small(dev: torch.device) -> None:
    """Phase 11a: the diffusion core on a small DiffUNet (CORE_SMALL, fp32,
    TF32 off), card against CPU with the same weights, x_T and step noise
    (made with numpy): ``ddpm_sample``, ``ddim_sample(eta=1)``, the DDIM
    reverse loop, ``training_losses`` of every loss type and
    ``calc_bpd_loop`` over a respaced CORE_BPD_STEPS-step schedule, within
    MODEL_TOL of max |y|; then a parametric toy emitting 2C channels:
    LEARNED_RANGE ``training_losses`` of every loss type and its
    gradients, within ATT_GRAD_TOL of the largest."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.diffusion import gaussian, sampling
    from diff_unet_tpu_torch.diffusion.schedule import Schedule
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fea, s, classes = CORE_SMALL
    cpu = init_random(DiffUNet(classes, features=fea), SEED).eval()
    gpu = DiffUNet(classes, features=fea)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    rng = np.random.default_rng(SEED + 11)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    shape = (2, s, s, s, classes)
    image = normal(2, s, s, s, 1)
    x_t, draws = normal(*shape), [normal(*shape) for _ in range(20)]
    labels = torch.from_numpy(rng.random(shape, np.float32) < 0.2)
    x_start = labels.float() * 2.0 - 1.0
    t = torch.tensor([5, 250])
    bpd_sched = Schedule.create("linear", 1000, respace=[CORE_BPD_STEPS])

    def run(model, d):
        seg = DiffusionSegmenter(model, classes)
        im = image.to(d)
        step_noise = [n.to(d) for n in draws]

        def denoise(x, tt):
            return model.denoise(im, x, tt)

        out = {}
        ddpm = seg.ddpm_sample(im, noise=x_t.to(d), step_noise=step_noise)
        out["ddpm sample"], out["ddpm sum"] = ddpm.sample, \
            ddpm.pred_xstart_sum
        ddim = seg.ddim_sample(im, noise=x_t.to(d), eta=1.0,
                               step_noise=step_noise, return_all=True)
        out["ddim eta 1 sample"], out["ddim eta 1 sum"] = ddim.sample, \
            ddim.pred_xstart_sum
        x0 = seg.ddim_sample(im, noise=x_t.to(d), return_all=True).sample
        out["ddim reverse x_T"] = sampling.ddim_reverse_sample_loop(
            seg.embedded_denoiser(im), seg.sample_schedule, x0)
        for loss_type in gaussian.LOSS_TYPES:
            out[f"{loss_type} loss"] = gaussian.training_losses(
                denoise, seg.train_schedule, x_start.to(d), t.to(d),
                loss_type=loss_type, noise=x_t.to(d))["loss"]
        bpd = gaussian.calc_bpd_loop(seg.embedded_denoiser(im), bpd_sched,
                                     x_start.to(d), step_noise=step_noise)
        out.update({f"bpd {k}": v for k, v in bpd.items()})
        return out

    t0 = time.perf_counter()
    with torch.inference_mode():
        want = run(cpu, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run(gpu, dev)
        torch.cuda.synchronize()
    errs = {k: rel_err(got[k], want[k]) for k in want}
    log(f"11a small DiffUNet diffusion core (features {fea}, {s}^3, fp32, "
        f"TF32 off) cuda vs cpu, error / max|y| (tol {MODEL_TOL:.0e}): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f"; card {time.perf_counter() - t0:.2f} s, cpu {cpu_s:.2f} s")
    if not all(torch.isfinite(v).all() for v in got.values()) or \
            max(errs.values()) > MODEL_TOL:
        fail("11a: the diffusion core on the card disagrees with the CPU")

    # a parametric toy with a learned-range variance: 2C output channels
    w0, b0 = normal(classes, 2 * classes) * 0.7, normal(2 * classes) * 0.3

    def toy(d):
        w = w0.to(d).requires_grad_()
        b = b0.to(d).requires_grad_()

        def fn(x, tt):
            return torch.tanh(x @ w + b + 1e-3 * tt.reshape(-1, 1, 1, 1, 1))
        res = {}
        for loss_type in gaussian.LOSS_TYPES:
            terms = gaussian.training_losses(
                fn, Schedule.create("cosine", 100), x_start.to(d),
                t.to(d) % 100, var_type=gaussian.LEARNED_RANGE,
                loss_type=loss_type, noise=x_t.to(d))
            gw, gb = torch.autograd.grad(terms["loss"].sum(), (w, b))
            res.update({f"{loss_type} loss": terms["loss"],
                        f"{loss_type} dW": gw, f"{loss_type} db": gb})
        return res

    want, got = toy(torch.device("cpu")), toy(dev)
    errs = {k: rel_err(got[k], want[k]) for k in want}
    log("11a toy LEARNED_RANGE training_losses cuda vs cpu, error / max "
        f"(tol {ATT_GRAD_TOL:.0e}): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    if max(errs.values()) > ATT_GRAD_TOL:
        fail("11a: the toy's LEARNED_RANGE losses or gradients on the card "
             "disagree with the CPU")


def core_full_width(dev: torch.device) -> dict:
    """Phase 11b: the diffusion core at the AMOS DiffUNet widths
    (``cfg/amos/test.yaml``, bf16, seeded random weights) on one window
    batch of 4 x 96^3: ``ddim_sample`` at eta 0 equal bit for bit to
    ``parent_ddim_sample``; ``ddpm_sample``, ``ddim_sample(eta=1)`` and
    the DDIM reverse loop from the eta-0 answer's final sample, each timed
    once (CUDA events and wall clock), finite, AMOS_CONV_PER_BATCH conv
    launches; ``training_losses`` at CORE_TRAIN_N x 96^3 forward and
    backward for CORE_LOSSES (finite, AMOS_TRAIN_PER_STEP launches, peak
    memory); ``calc_bpd_loop`` at CORE_BPD_N x 96^3 over the whole train
    schedule, the embedding hoisted: finite, with its seconds. Returns
    the launches by kernel and path."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
    from diff_unet_tpu_torch.diffusion import gaussian, sampling
    from diff_unet_tpu_torch.engine.engine import Predictor
    from diff_unet_tpu_torch.models.model_hub import create_model
    from diff_unet_tpu_torch.utils.weights import init_random

    pred = Predictor.from_config(
        ROOT / "cfg/amos/test.yaml", model_path=None,
        classes=str(ROOT / "cfg/amos/classes.yaml"), device=dev, seed=SEED)
    seg = pred.seg
    vol = synthetic_ct(AMOS_BODY, SEED + 5, dev)
    r = pred._inferer.roi[0]
    windows = torch.stack([vol[:, y:y + r, x:x + r] for y in (0, r)
                           for x in (0, r)])
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    noise = torch.randn((len(windows), r, r, r, pred.num_classes),
                        generator=g, device=dev)
    paths = {"conv3x3": {}, "conv3x3_dgrad": {}, "conv3x3_wgrad": {}}

    def counted(path, fn):
        """fn() with the conv counts set to 0 before and read after, its
        CUDA-event ms and wall s."""
        torch.cuda.synchronize()
        reset_conv()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = conv_counts()
        if path:
            for k, c in counts.items():
                paths[k][path] = c
        return out, a.elapsed_time(b), wall, counts

    with torch.inference_mode():
        parent = parent_ddim_sample(seg, windows, noise)
        out0, ms, wall, counts = counted(None, lambda: seg.ddim_sample(
            windows, noise=noise, return_all=True))
        same = torch.equal(out0.pred_xstart_sum, parent)
        log(f"11b AMOS window batch (4 x 96^3, bf16) ddim_sample eta 0: "
            f"{ms:.1f} ms, {wall:.4f} s, {counts['conv3x3']} conv launches;"
            f" equal bit for bit to the parent's DDIM loop: {same}")
        if not same or counts["conv3x3"] != AMOS_CONV_PER_BATCH:
            fail("11b: ddim_sample at eta 0 moved from the parent's answer "
                 f"(max |diff| {rel_err(out0.pred_xstart_sum, parent):.3e}"
                 " of max |y|) or ran "
                 f"{counts['conv3x3']} conv launches")
        runs = {
            "amos_ddpm": lambda: seg.ddpm_sample(
                windows, generator=g).pred_xstart_sum,
            "amos_ddim_eta": lambda: seg.ddim_sample(
                windows, noise=noise, eta=1.0, generator=g),
            "amos_ddim_reverse": lambda: sampling.ddim_reverse_sample_loop(
                seg.embedded_denoiser(windows), seg.sample_schedule,
                out0.pred_xstart),
        }
        outs = {}
        for path, fn in runs.items():
            y, ms, wall, counts = counted(path, fn)
            outs[path] = y
            msg = (f"11b {path}: {ms:.1f} ms (CUDA events), {wall:.4f} s "
                   f"wall, {len(windows) * seg.sample_steps / wall:.2f} "
                   f"window-steps/s, {counts['conv3x3']} conv launches, "
                   f"max |y| {y.abs().max().item():.3f}")
            if path != "amos_ddim_reverse":
                flips = ((y > 0) != (out0.pred_xstart_sum > 0)).float()
                msg += (f", binary voxels differing from eta 0 "
                        f"{flips.mean().item():.4e}")
            log(msg)
            if not torch.isfinite(y).all() or \
                    counts["conv3x3"] != AMOS_CONV_PER_BATCH:
                fail(f"11b {path}: non-finite output or "
                     f"{counts['conv3x3']} conv launches, predicted "
                     f"{AMOS_CONV_PER_BATCH}")
    del outs, out0, parent

    model = init_random(create_model(
        "diff_unet", out_channels=15, features=(64, 64, 128, 256, 512, 64),
        dtype=torch.bfloat16), SEED).to(dev)
    tseg = DiffusionSegmenter(model, 15)
    n = CORE_TRAIN_N
    image = torch.rand((n, r, r, r, 1), generator=g, device=dev)
    x_start = (torch.rand((n, r, r, r, 15), generator=g, device=dev)
               < 0.1).float() * 2.0 - 1.0

    def denoise(x, tt):
        return model.denoise(image, x, tt).float()

    train = {}
    for loss_type in CORE_LOSSES:
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats(dev)

        def step():
            t = gaussian.uniform_timesteps(g, n, tseg.timesteps, dev)
            terms = gaussian.training_losses(
                denoise, tseg.train_schedule, x_start, t, g,
                loss_type=loss_type)
            terms["loss"].mean().backward()
            return terms

        terms, ms, wall, counts = counted(None, step)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(gr.float()) for gr in grads])).item()
        loss = terms["loss"].detach()
        train[loss_type] = counts
        log(f"11b training_losses {loss_type} at {n} x 96^3 (bf16 over "
            f"fp32), forward + backward: loss {loss.tolist()}, grad norm "
            f"{norm:.5f} over {len(grads)} tensors, {ms:.1f} ms, "
            f"{wall:.4f} s, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, "
            f"launches {counts}")
        if not (torch.isfinite(loss).all() and np.isfinite(norm)
                and norm > 0):
            fail(f"11b training_losses {loss_type}: non-finite loss or "
                 "gradient")
        if counts != AMOS_TRAIN_PER_STEP:
            fail(f"11b training_losses {loss_type}: launches {counts}, "
                 f"predicted {AMOS_TRAIN_PER_STEP}")
    for k in paths:
        paths[k]["amos_vb_train"] = sum(c[k] for c in train.values())
    del model, tseg, image, x_start

    sched = seg.train_schedule
    image = windows[:CORE_BPD_N]
    x_start = (torch.rand((CORE_BPD_N, r, r, r, 15), generator=g,
                          device=dev) < 0.1).float() * 2.0 - 1.0

    def bpd():
        inner = seg.embedded_denoiser(image)
        return gaussian.calc_bpd_loop(
            lambda x, tt: inner(x, tt).float(), sched, x_start, g)

    with torch.inference_mode():
        out, ms, wall, counts = counted("amos_bpd", bpd)
    steps = sched.num_timesteps
    log(f"11b calc_bpd_loop at {CORE_BPD_N} x 96^3 over "
        f"the whole {steps}-step train schedule: "
        f"total_bpd {out['total_bpd'].tolist()}, prior_bpd "
        f"{out['prior_bpd'].tolist()}, vb[t=0] {out['vb'][:, -1].tolist()},"
        f" vb[t=T-1] {out['vb'][:, 0].tolist()}, {wall:.2f} s wall "
        f"({ms / steps:.2f} ms a step), {counts['conv3x3']} conv launches")
    want = 10 + 18 * steps
    if not all(torch.isfinite(v).all() for v in out.values()) or \
            out["vb"].shape != (CORE_BPD_N, steps) or \
            counts["conv3x3"] != want:
        fail(f"11b calc_bpd_loop: non-finite, shape {tuple(out['vb'].shape)}"
             f" or {counts['conv3x3']} conv launches (predicted {want})")
    return paths


def core_learned(dev: torch.device, work: Path) -> None:
    """Phase 11c: phase 9d's trained ``overfit.npz`` (4 volumes of 48^3,
    one window each) served by DDIM-10 at eta 0, DDIM-10 at eta 1 and
    DDPM over the respaced 10 steps, each from the x_T that ``infer``
    draws: each mean dice, finite in [0, 1], and the share of binary
    voxels that differ from eta 0."""
    from diff_unet_tpu_torch import overfit
    from diff_unet_tpu_torch.engine.sliding_window import window_seed
    from diff_unet_tpu_torch.metrics.metrics import validation_dice

    npz = None if work is None else work / "overfit.npz"
    if npz is None or not npz.exists():
        log("11c not run: no phase-9d overfit.npz (it runs in the full "
            "script)")
        return
    pred = overfit.build_predictor(device=dev, model_path=str(npz))
    images, _, onehot = overfit.make_cases()
    samplers = {
        "DDIM-10 eta 0": lambda im, x_t, g: pred.seg.ddim_sample(
            im, noise=x_t),
        "DDIM-10 eta 1": lambda im, x_t, g: pred.seg.ddim_sample(
            im, noise=x_t, eta=1.0, generator=g),
        "DDPM respaced 10": lambda im, x_t, g: pred.seg.ddpm_sample(
            im, noise=x_t, generator=g).pred_xstart_sum,
    }
    binaries = {}
    for name, sample in samplers.items():
        dices, bins = [], []
        t0 = time.perf_counter()
        for i, (img, lab) in enumerate(zip(images, onehot)):
            im = torch.from_numpy(img)[None].to(dev)
            x0 = torch.Generator(device=dev).manual_seed(
                window_seed(pred.seed, (0, 0, 0)))
            x_t = torch.randn((1, *img.shape[:3], pred.num_classes),
                              generator=x0, device=dev)
            g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
            with torch.inference_mode():
                binary = (torch.sigmoid(sample(im, x_t, g)[0]) > 0.5).float()
            dices.append(float(validation_dice(
                binary, torch.from_numpy(lab).to(dev)).mean()))
            bins.append(binary)
        torch.cuda.synchronize()
        binaries[name] = bins
        mean = float(np.mean(dices))
        flips = float(np.mean([(a != b).float().mean().item() for a, b in
                               zip(bins, binaries["DDIM-10 eta 0"])]))
        log(f"11c overfit model served by {name}: mean dice {mean:.4f} "
            f"{[round(d, 4) for d in dices]}, binary voxels differing from "
            f"eta 0 {flips:.4e}, {time.perf_counter() - t0:.2f} s for "
            f"{len(images)} volumes")
        if not all(np.isfinite(d) and 0.0 <= d <= 1.0 for d in dices):
            fail(f"11c {name}: a dice outside [0, 1]: {dices}")


def phase_diffusion_core(dev: torch.device, work: Path = None) -> dict:
    """Phase 11: the rest of the diffusion core (11a small model card vs
    CPU, 11b full AMOS width, 11c the trained model of phase 9d, given
    ``work`` where it saved ``overfit.npz``). Returns 11b's launches by
    kernel and path."""
    t0 = time.perf_counter()
    core_small(dev)
    paths = core_full_width(dev)
    core_learned(dev, work)
    log(f"phase 11 (diffusion core): {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=None,
                        help="comma-separated phase_* names that take the "
                             "device alone: run only those (after the card "
                             "and the build), and print no JSON")
    args = parser.parse_args()
    names = args.phases.split(",") if args.phases else []
    for name in names:
        if not callable(globals().get(f"phase_{name}")):
            fail(f"no phase named {name}")
    t0 = time.perf_counter()
    card, clock_hz = phase_card()
    # every later phase runs in a temporary directory under build/
    # (git-ignored): the trainers' logs and phases 7-8's NIfTI sets,
    # weights and logs land there, and it is removed at the end
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        os.chdir(tmp)
        try:
            if names:
                phase_build()
                for name in names:
                    globals()[f"phase_{name}"](torch.device("cuda", 0))
                log(f"phases {args.phases}: "
                    f"{time.perf_counter() - t0:.1f} s")
                log(card)
            else:
                run_phases(card, clock_hz, Path(tmp), t0)
        finally:
            os.chdir(ROOT)


def run_phases(card: str, clock_hz: float, work: Path, t0: float) -> None:
    dev = torch.device("cuda", 0)
    checked = phase_build()
    if not any("Tf32x3" in k for k in checked) or not any(
            "conv3d_wgrad_tf32" in k for k in checked):
        fail("the float32 (3xTF32) conv instances are missing from the "
             "build")
    from diff_unet_tpu_torch.ops.conv3d import conv3x3, conv3x3_wgrad
    from diff_unet_tpu_torch.ops.int8 import conv3x3_int8
    from diff_unet_tpu_torch.ops.window_attention import window_attention
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, reverse_windows)
    from diff_unet_tpu_torch.ops.window_shift import shift_windows

    report = phase_attention(dev, clock_hz)
    report.update(phase_attention_backward(dev, clock_hz))
    report.update(phase_shift(dev))
    report.update(phase_conv(dev))
    report.update(phase_conv_s8(dev))
    phase_conv_s8_swin(dev)
    report.update(phase_conv_backward(dev))
    phase_conv_msd(dev)
    phase_cout32(dev)
    report.update(phase_conv_mim(dev))
    report.update(phase_partition(dev))
    report.update(phase_backward(dev))
    phase_small_model(dev)
    phase_small_int8_swin(dev)
    phase_small_diff_unet(dev)
    phase_small_unet(dev, "smooth_diff_unet")
    phase_small_unet(dev, "attention_diff_unet")
    phase_small_train(dev, "diff_swin_unetr")
    phase_small_train(dev, "diff_unet")
    phase_small_train(dev, "smooth_diff_unet")
    phase_small_train(dev, "attention_diff_unet")
    phase_small_all_losses(dev)
    phase_small_swin_unetr(dev)
    phase_small_mim(dev)
    swin = {"window_attention": window_attention,
            "shift_windows": shift_windows,
            "window_partition": partition_windows,
            "window_reverse": reverse_windows}
    paths = {k: {} for k in (*swin, "shift_windows_backward", "conv3x3",
                             "conv3x3_dgrad", "conv3x3_wgrad",
                             "conv3x3_int8")}
    for k, v in phase_serve(dev, "btcv", swin, SERVE_PER_BATCH).items():
        paths[k].update(v)
    # 10 TwoConv convs in the encoder, 18 in each of the 10 denoiser steps;
    # no dgrad (counted beside conv3x3's backward) and no wgrad
    for k, v in phase_serve(dev, "amos", {"conv3x3": conv3x3,
                                          "conv3x3_wgrad": conv3x3_wgrad},
                            {"conv3x3": 10 + 18 * 10,
                             "conv3x3_wgrad": 0}).items():
        paths[k].update(v)
    paths["conv3x3_dgrad"]["amos_serve"] = 0
    # W8A8 int8 serving: every 3x3x3 conv on the s8 kernel, none in bf16
    phase_int8_window(dev)
    for k, v in phase_serve(dev, "amos", {"conv3x3": conv3x3,
                                          "conv3x3_int8": conv3x3_int8},
                            {"conv3x3": 0, "conv3x3_int8": INT8_PER_BATCH},
                            path="amos_int8_serve",
                            shapes=((96, 192, 192),),
                            quantize=True).items():
        paths[k].update(v)
    for k, v in phase_overfit(dev, work).items():
        paths[k].update(v)
    # the diffusion core: DDPM, DDIM at eta 1, the reverse loop, the
    # training losses and the bits-per-dim loop at the AMOS widths
    for k, v in phase_diffusion_core(dev, work).items():
        paths[k].update(v)
    # W8A8 int8 serving of DiffSwinUNETR at the BTCV config: the UNETR
    # blocks' 3x3x3 convs on the s8 kernel, their 1x1 projections as int8
    # GEMMs, no float 3x3x3 conv
    report["conv3x3_int8"].update(phase_int8_window_btcv(dev))
    for k, v in phase_serve_btcv_int8(dev).items():
        if k in paths:
            paths[k].update(v)
    # SmoothDiffUNet: the same 190 convs per window batch (its layer-norm
    # denoiser's convs bias-only) on one 96x192x192 volume
    for k, v in phase_serve(dev, "amos", {"conv3x3": conv3x3,
                                          "conv3x3_wgrad": conv3x3_wgrad},
                            {"conv3x3": 10 + 18 * 10, "conv3x3_wgrad": 0},
                            path="amos_smooth_serve",
                            shapes=((96, 192, 192),),
                            model_name="smooth_diff_unet").items():
        paths[k].update(v)
    paths["conv3x3_dgrad"]["amos_smooth_serve"] = 0
    # AttentionDiffUNet: 10 + 30 * 10 convs per window batch
    for k, v in phase_serve(dev, "amos", {"conv3x3": conv3x3,
                                          "conv3x3_wgrad": conv3x3_wgrad},
                            {"conv3x3": ATT_CONV_PER_BATCH,
                             "conv3x3_wgrad": 0},
                            path="amos_attention_serve",
                            shapes=((96, 192, 192),),
                            model_name="attention_diff_unet").items():
        paths[k].update(v)
    paths["conv3x3_dgrad"]["amos_attention_serve"] = 0
    paths["shift_windows_backward"]["btcv_serve"] = 0
    counts = phase_train(dev, swin)
    # the partition kernel runs forward and in the reverse's backward, and
    # the other way round; the shift's backward launch is reported apart
    for k in ("window_partition", "window_reverse"):
        paths[k]["btcv_train"] = sum(counts[k])
    paths["window_attention"]["btcv_train"] = counts["window_attention"][0]
    paths["window_attention_backward"] = {
        "btcv_serve": 0, "btcv_train": counts["window_attention"][1]}
    (paths["shift_windows"]["btcv_train"],
     paths["shift_windows_backward"]["btcv_train"]) = counts["shift_windows"]
    counts, amos_step_s, amos_peak = phase_train_amos(dev)
    for k, c in counts.items():
        paths[k]["amos_train"] = c
    counts, smooth_step_s, smooth_peak = phase_train_amos(
        dev, "smooth_diff_unet")
    for k, c in counts.items():
        paths[k]["amos_smooth_train"] = c
    log(f"AMOS train step, smooth_diff_unet against diff_unet: "
        f"{smooth_step_s:.4f} / {amos_step_s:.4f} s "
        f"({smooth_step_s / amos_step_s:.2f}x), peak memory "
        f"{smooth_peak:.2f} / {amos_peak:.2f} GiB")
    phase_twoconv_norms(dev)
    counts, att_step_s, att_peak = phase_train_amos(
        dev, "attention_diff_unet", ATT_TRAIN_PER_STEP)
    for k, c in counts.items():
        paths[k]["amos_attention_train"] = c
    log(f"AMOS train step, attention_diff_unet against diff_unet: "
        f"{att_step_s:.4f} / {amos_step_s:.4f} s "
        f"({att_step_s / amos_step_s:.2f}x), peak memory "
        f"{att_peak:.2f} / {amos_peak:.2f} GiB")
    phase_bn_chain(dev)
    for k, c in phase_mim_pretrain(dev, work).items():
        paths[k]["mim_pretrain"] = c
        # the pretraining path is float32: the 3xTF32 instances
        paths[f"{k}_f32"] = {"mim_pretrain": c}
    for phase in (lambda: phase_train_msd(dev),
                  lambda: phase_train_amos_keys(dev, work, amos_step_s),
                  lambda: phase_swin_unetr(dev, swin)):
        for k, v in phase().items():
            paths[k].update(v)
    phase_edt()
    launches, results, case_seconds = phase_eval_amos(dev, work)
    for k, v in launches.items():
        paths[k].update(v)
    phase_metrics(dev, results)
    for k, v in phase_continuous(dev, work, swin, results,
                                 case_seconds).items():
        paths[k].update(v)
    del results
    for k, v in phase_train_amos_data(dev, work, amos_step_s).items():
        paths[k].update(v)
    replaces = {
        "window_attention": ("diff_unet_tpu_torch/csrc/window_attention.cu",
                             "diff_unet_tpu/ops/pallas_attention.py:115"),
        "window_attention_backward": (
            "diff_unet_tpu_torch/csrc/window_attention.cu",
            "diff_unet_tpu/ops/pallas_attention.py:115 (its custom_vjp, "
            ":196-222, :260-288)"),
        "shift_windows": ("diff_unet_tpu_torch/csrc/window_shift.cu",
                          "diff_unet_tpu/ops/pallas_shift.py:71"),
        "shift_windows_backward": (
            "diff_unet_tpu_torch/csrc/window_shift.cu",
            "diff_unet_tpu/ops/pallas_shift.py:71 (its custom_vjp, :141-152)"),
        "window_partition": ("diff_unet_tpu_torch/csrc/window_partition.cu",
                             "benchmarks/pallas_partition_probe.py:54"),
        "window_reverse": ("diff_unet_tpu_torch/csrc/window_partition.cu",
                           "benchmarks/pallas_partition_probe.py:54 (its "
                           "inverse, diff_unet_tpu/ops/swin.py:95)"),
        "conv3x3": ("diff_unet_tpu_torch/csrc/conv3d.cu",
                    "diff_unet_tpu/ops/pallas_packed_conv.py:132; "
                    "diff_unet_tpu/ops/pallas_packed_conv.py:241; "
                    "diff_unet_tpu/ops/pallas_aug_conv.py:65; "
                    "diff_unet_tpu/ops/pallas_conv.py:29"),
        "conv3x3_dgrad": (
            "diff_unet_tpu_torch/csrc/conv3d.cu",
            "the backward of the conv kernels above (the JAX package takes "
            "it through flax nn.Conv; the same kernel, flipped weights)"),
        "conv3x3_wgrad": (
            "diff_unet_tpu_torch/csrc/conv3d_wgrad.cu",
            "none: the conv's weight gradient, which the JAX package takes "
            "through flax nn.Conv (jax.value_and_grad)"),
        "conv3x3_f32": (
            "diff_unet_tpu_torch/csrc/conv3d.cu (conv3d_wgmma_kernel<"
            "Tf32x3Op>: 3xTF32 wgmma on the TMA halo)",
            "diff_unet_tpu/ops/pallas_packed_conv.py:132; "
            "diff_unet_tpu/ops/pallas_packed_conv.py:241; "
            "diff_unet_tpu/ops/pallas_aug_conv.py:65; "
            "diff_unet_tpu/ops/pallas_conv.py:29 (in float32)"),
        "conv3x3_dgrad_f32": (
            "diff_unet_tpu_torch/csrc/conv3d.cu (conv3d_wgmma_kernel<"
            "Tf32x3Op>, the flipped weights)",
            "the backward of the conv kernels above in float32 (the JAX "
            "package takes it through flax nn.Conv)"),
        "conv3x3_wgrad_f32": (
            "diff_unet_tpu_torch/csrc/conv3d_wgrad.cu "
            "(conv3d_wgrad_tf32_kernel: 3xTF32 mma.sync)",
            "none: the conv's weight gradient in float32, which the JAX "
            "package takes through flax nn.Conv (jax.value_and_grad)"),
        "conv3x3_int8": (
            "diff_unet_tpu_torch/csrc/conv3d.cu (conv3d_wgmma_kernel<S8Op>: "
            "wgmma s8 on the TMA halo, quantize on load)",
            "diff_unet_tpu/ops/int8.py:conv_int8 (XLA, no Pallas kernel; "
            "its quantize_act :43 fused as the prologue, its rescale :78 "
            "as the epilogue)"),
    }
    # launches: the first path of LAUNCH_ORDER on which the kernel ran,
    # this slice's path (continuous serving) first; the bf16 conv entries
    # skip float32 pretraining, which runs the 3xTF32 entries
    def launches(k):
        return next((paths[k][p] for p in LAUNCH_ORDER if paths[k].get(p)
                     and not (p == "mim_pretrain" and k in (
                         "conv3x3", "conv3x3_dgrad", "conv3x3_wgrad"))), 0)

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches(k), launches_by_path=paths[k],
                    **report[k])
               for k, (src, rep) in replaces.items()]
    log(f"all phases: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
