#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``neural_imaging_tpu_torch``) on one
NVIDIA GPU:

1. environment: the card, its power limit, TF32 off;
2. build every hand-written CUDA kernel from ``neural_imaging_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and the rANS coder from
   ``native/ans``;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and time both (CUDA events, L2 flushed; a
   kernel's time is the device's alone, see ``time_ms``), and each of its
   launches (``torch.profiler``): K1 (dJPEG core; also at the DCN flow's
   and the 8-class flow's channel shapes and at ragged edge shapes up to
   the D90's whole image, each beside ``copy_ms``, the card's time for a
   copy with K1's traffic), K2 (codebook quantizer), K3 and K4 (its
   backwards), K5 (the FAN's conv stage, its dgrad and wgrad, at the four
   stage shapes of 100 and 50 rows, each beside its float32 bound and the
   cuDNN composition's time, ``library_ms``);
4. manipulation classification: restore the shipped ``m_quality`` run (INet
   → 4 manipulations → pool → JPEG QF 50 → FAN, full width) and answer
   requests of raw 128-px patches with ``run_workflow_to_decisions``; check
   the probabilities, and against the same forward on the CPU;
5. main-path training: the joint INet + FAN step of the same run with the
   NIP trainable (λ_nip 0.1, lr 1e-4) on batches of raw 128-px patches and
   their 256-px RGB targets: the first step's loss parts and gradient norms
   against the port's own CPU step (``compare_steps``), then timed steps at
   fixed strengths and a few with ``augment=True``, K1 twice a step; check
   the losses and that the NIP and the FAN moved;
6. bench.py's configuration (every bfloat16 knob, the flat pool, the FAN
   at the m_quality widths in bfloat16, INet at 'exact' with the same run's
   weights, NIP trainable): the first step against the port's CPU step
   (``compare_steps`` at the bfloat16 bounds), timed steps in blocks taken
   in turns with the float32 step of step 5's flow, a few with
   ``augment=True``, a device profile of each; K1 never launched (the
   bfloat16 codecs are the plane form). Then the shipped runs trained at
   INet 'high' and 'default' precision (``m_prec_high``, ``m_prec_default``,
   ``m_manipjpeg_bf16`` with its bfloat16 'jpeg' manipulation) restored and
   asked for requests, K1 twice, twice and once a request, the
   probabilities against the port's CPU forward;
7. the trainer: ``train_manipulation_nip`` on 60 procedural 256x384 pairs
   (the port's ``fixtures.make_dataset``, split 40:20:2) with the same run's
   flow, its pre-trained SyntheticCam INet and the NIP trainable, raw patch
   128, batch 10, 6 epochs with validation every 2: host-fed, then from
   device-resident data; the host-fed first epoch against the port's CPU
   trainer, the written run directory restored and revalidated to its
   logged accuracy, K1 twice a step and twice a validation batch; epoch
   times (timed by the trainer's own validation log lines), steps/s, the
   validation share and the device's busy share;
8. DCN serving: restore the 32c codec and answer requests of one 512x768
   RGB image each, ``codec.compress`` → bytes → ``codec.decompress``; check
   the bitstream round trip, and the latent and decode against the CPU;
9. DCN training: steps of the 32c codec (fixed codebook, K2 + K3) and of a
   trainable-codebook copy (K2 + K4) at batch 16 of 128-px patches;
10. the other camera ISPs: ``[nip]`` each shipped NIP (UNet_5,
   DNet_3x3_15x64f, ClassicISP_gbrg_5x5_-3R, INet) restored with
   ``base.restore`` develops 20 raw 64-px patches, against the CPU;
   ``[unet classify]`` the ``m_quality_full`` UNet run (downsampling
   'none') answers requests of 10 raw 64-px patches, K1 twice a request,
   against the CPU; ``[unet train]`` and ``[dnet train]`` the joint step of
   the λ-sweep's ``ln-0.0050`` UNet and DNet runs (the NIP from its shipped
   snapshot and trainable, the FAN from its seed, pool:2, QF 50, batch 10
   raw 64-px patches): the first step against the CPU's, the UNet's peak
   memory with and without ``remat``, 10 + 3 augmented steps, K1 twice a
   step, the NIP's share of the device time; ``[nip trainer]``
   ``train_nip_model`` of UNet_5 from its snapshot on procedural pairs at
   the CLI's batch 20 and raw patch 64, host-fed and device-resident, its
   first epoch against the CPU trainer's, its ``progress.json`` and npz
   read back;
11. the DCN channel in the joint flow and the DCN trainer: ``[dcn flow]``
   the ``m_quality_dcn`` lc-0.1000 run's flow (ONet at raw 64, so 128-px
   RGB, four manipulations with jpeg:80, the 32c codec trainable with
   λ_dcn 0.1, the FAN at its widths from its seed, batch 10: 409,600
   latent values a step) answers requests (K1 and K2 once each) against
   the CPU, takes its first step against the CPU's (``fan_input_flips``
   counted), then 10 + 3 augmented timed steps (K1, K2, K3 once each) with
   the step's peak memory and device profile, and the run's fixed-codec
   sibling takes steps (K3 never); ``[dcn trainer]`` ``train_dcn`` of
   TwitterDCN 32c from its seed at train_dcn.py's patch 64 and batch 50 on
   procedural RGB images, host-fed then device-resident, its
   ``progress.json`` and snapshot read back to the logged validation SSIM,
   the first epoch against the CPU trainer's;
12. all seven manipulations through the joint flow: ``[manip7 classify]``
   and ``[manip7 train]`` run the m_quality run's shape (its INet snapshot,
   trainable, λ_nip 0.1; pool:2; JPEG QF 50; the FAN at its logged widths)
   with sharpen, resample, gaussian, jpeg, awgn, gamma and median and an
   8-class FAN from its seed, at batch 20 raw 128-px patches (160 expanded
   256-px images): requests (K1 twice each) and request 0 against the CPU
   with the same awgn noise; the first step against the CPU's
   (``fan_input_flips`` counted); ``median_switch`` equal to ``median`` on
   the card for every index a step draws; the fused pooled expansion
   (``_manipulate(pool=True)``) against ``avg_pool(_manipulate())``, both
   timed in turns; the peak memory of a step (and with median's 9x9 window);
   10 + 3 augmented timed steps, K1 twice a step, with the device profile of
   each kind of step;
13. RAW ingestion and development at the Nikon D90's 4288x2848 (GBRG, its
   colour matrix from ``config/cameras.json``): ``[raw]`` builds the
   lossless-JPEG scan codec from ``native/ljpeg``, writes one procedural
   14-bit capture as DNG (uncompressed and lossless JPEG), CR2, NEF (lossless
   and lossy), ARW and ARW cRAW and reads each back exactly (``unpack``
   timed); ``raw.process`` with the bilinear, Malvar and Menon demosaicers on
   the card in float64 (CUDA events, peak memory), each against the CPU on a
   1024x1024 crop; each shipped QualityRef NIP develops the whole 1424x2144
   RGGB stack in one forward (ms, peak memory), a crop against the CPU; the
   CLIs ``train_prepare_training_set --dev manual`` (its output read by the
   ``Dataset``) and ``develop_images --pipeline UNet`` (its PNG read back).
   No kernel of the port runs;
14. the codec-evaluation layer: ``[codec eval]`` builds the host baseline
   JPEG codec from ``csrc/baseline_jpeg.cpp`` and holds it against its plain
   version (bytes and pixels, 2 procedural images x 3 subsamplings x 2
   qualities) and the committed digests of PIL's files; K1 at test_jpeg's
   shape and K2 at the four DCN presets' 512x768 latents against their plain
   versions; the rate-distortion sweep of 4 Kodak-like 512x768 PNGs
   (``get_jpeg_df`` QF 10-95 step 5, 72 rows on the host; ``get_dcn_df`` over
   the shipped 8c/16c/32c/64c, 16 rows, K2 once a row), rows against a
   recomputation and the CPU's 32c, the cache, each codec's fits; the CLIs
   ``test_jpeg`` at its defaults (K1 once a quality, 18) and ``test_dcn`` in
   its four modes on 32c; ``validate_jpeg`` with the libjpeg codec;
15. the last rate-distortion legs and the image readers: ``[codec legs]``
   prints which codec libraries load (libopenjp2, libwebp, libavif, libx265,
   libde265, the bpgenc/bpgdec binaries) and runs each leg whose library
   loads at the reference's full quality range on [codec eval]'s images
   (JPEG 2000 PSNR 25-45 dB on 2 of them, BPG q 15-45, WebP and AVIF 10-95):
   the rows, one re-encoded to the same bytes, its MS-SSIM on the card
   against the CPU, the cache, the fits; HEVC intra at QP 28; a 12 MP PNG
   with rows of all five filters read by the compiled unfilter and the plain
   one; 8-, 24- and 32-bit BMPs read back exactly; ``test_dcn_rate_dist``
   with every leg and the shipped DCNs on the 2 images, K2 once a DCN row;
16. data parallelism and development in bands: ``[parallel]`` takes the
   four steps (the m_quality joint step at batch 20 raw 128; the
   m_quality_dcn lc-0.1000 flow at batch 10; the 32c DCN with a trainable
   codebook at 16 x 128²; UNet_5 at batch 20 raw 64) in one process at the
   global batch on the card; the joint step through ``DataParallel`` on one
   NCCL rank against it; then 2 ranks sharing the card over gloo, started by
   ``parallel.launch.run``, each with half of every batch: the first step
   against the one-process step (``compare_steps``, the FAN's input's dJPEG
   flips counted as ``fan_input_flips`` counts them), the DCN flow's entropy
   against the global batch's, 5 timed steps, K1-K4 launched as expected on
   each rank, the ranks' parameters bit-identical, gloo's all-reduce of the
   gradients' size timed; on a machine with two cards, the joint step over
   NCCL on both and ``train_nip --devices 2`` for an epoch (skipped, and
   said so, with one); each QualityRef NIP develops the D90's 1424x2144
   stack in 2 and 4 bands against the whole stack, with each band's peak
   memory;
17. the tooling and results layer: ``[tooling]`` counts the FLOPs and bytes
   of one m_quality float32 step and one bench.py bfloat16 step
   (``profiling.step_cost``: K1 by its registered operator's formula) and
   gives MFU and the HBM share at the training phases' median steps
   against ``profiling.chip_peaks``, ranks the float32 step's traffic
   (``op_traffic``), exports UNet_5, the m_quality FAN and 32c with
   ``deploy_model`` and runs the reloaded programs against the models (the
   exported 32c launches K2 through its operator), reads
   ``device_memory_stats``, and runs ``test_nip`` of the QualityRef UNet_5
   and INet on the card against the CPU;
18. the end-to-end framework harness: ``[framework]`` runs all seven
   scenarios of ``config/tests/framework.json`` at their full epochs on the
   harness's fixture data (``cli/test_framework.py``: the CLIs' ``main``
   called in this process on the harness's mapped argv), checks each
   scenario's artifacts and gates with the harness's functions, and reads
   the launch counts around each scenario: K2 and K3 in the two DCN
   scenarios, no kernel in the others. The two DCN scenarios' host
   augmentations draw from ``np.random.default_rng(--seed)`` (the command
   line and the harness's own runs stay unseeded). It prints the N of each
   launch and, after the scenarios, holds K2 and K3 (and K4) against their
   plain versions at each of those N;
19. K1 at every shape the paths above launched it at in this process
   (``jpeg_core_cuda.sizes``, tallied by ``read_counts``) against its plain
   version, timed;
20. print one JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Each path runs with every launch count set to 0 just before it and is read
just after; a kernel of the path that did not launch fails the run.

    python3 chip_smoke.py [--seed 0] [--requests 5] [--batch 20]

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before doing anything.
"""
import argparse
import collections
import functools
import hashlib
import importlib
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from neural_imaging_tpu_torch.cli import develop_images as develop_cli
from neural_imaging_tpu_torch.cli import test_dcn as test_dcn_cli
from neural_imaging_tpu_torch.cli import test_dcn_rate_dist as rate_dist_cli
from neural_imaging_tpu_torch.cli import test_framework as framework
from neural_imaging_tpu_torch.cli import test_jpeg as test_jpeg_cli
from neural_imaging_tpu_torch.cli import test_nip as test_nip_cli
from neural_imaging_tpu_torch.cli import train_prepare_training_set as prepare_cli
from neural_imaging_tpu_torch.compression import (avif, baseline_jpeg, bpg_helpers, codec, entropy,
                                                  hevc, jp2_helpers, jpeg_helpers, webp)
from neural_imaging_tpu_torch.compression import ratedistortion as rd
from neural_imaging_tpu_torch.data import (bayer, bmp, camera_raw, dng, fixtures, ljpeg, menon,
                                           nikon, png, raw, sony)
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher
from neural_imaging_tpu_torch.models import base, compression, pipelines
from neural_imaging_tpu_torch.models.jpeg import JPEG, qtables
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper import _build, codebook, fan_conv, jpeg8x8
from neural_imaging_tpu_torch.parallel import launch, multihost, spatial
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.parallel import train as ptrain
from neural_imaging_tpu_torch.training import compression as codec_training
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.training.manipulation import train_manipulation_nip
from neural_imaging_tpu_torch.training.pipeline import train_nip_model
from neural_imaging_tpu_torch.utils import debugging, metrics, native, profiling
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.utils import logger
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    BF16_GRADIENT_NORM_DIFF, BF16_STEP_LOSS_DIFF, MAX_STEP_LOSS_DIFF, N_STRENGTH_CANDIDATES,
    ManipulationClassification, compare_probabilities, compare_steps)

RUN_DIR = 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000'
RAW_PATCH = 128
DCN_PRESET = '32c'
DCN_IMAGE = (512, 768)          # one serving request: 64 x 96 x 32 latent, N = 196,608
DCN_BATCH, DCN_PATCH = 16, 128  # one training step: 16 x 16 x 16 x 32 latent, N = 131,072
DCN_LR = 1e-4
DCN_REQUESTS, DCN_STEPS, DCN_TRAIN_CODEBOOK_STEPS = 5, 5, 3
TRAIN_STEPS, TRAIN_AUGMENTED_STEPS = 10, 3   # main-path steps, after a warm-up
TRAIN_LAMBDA_NIP, TRAIN_LR = 0.1, 1e-4
# the trainer: the m_quality run's data shape (60 images of 256x384, split
# 40:20:2, 256-px validation patches) and its batch of 10, made procedurally
TRAINER_IMAGES, TRAINER_SIZE, TRAINER_SPLIT = 60, (256, 384), (40, 20, 2)
TRAINER_BATCH, TRAINER_EPOCHS, TRAINER_VALIDATION = 10, 6, 2
TRAINER_PROFILE_EPOCHS = 3
# bench.py's configuration, the one the JAX package was tuned and benchmarked
# on: the m_quality flow's manipulations, channel and FAN widths (5 classes,
# 1,145,382 parameters), INet at 'exact', NIP trainable, the flat pool and
# every bfloat16 knob (the FAN's weights drawn from its seed)
BENCH_ARGS = dict(manipulations=['sharpen', 'resample', 'gaussian', 'jpeg'],
                  distribution={'downsampling': 'pool:2', 'compression': 'jpeg',
                                'compression_params': {'quality': 50, 'codec': 'soft'}},
                  fan_args={'dtype': 'bfloat16'}, trainable={'nip'},
                  nip_args={'conv_precision': 'exact'}, channel_dtype='bfloat16',
                  channel_jpeg_dtype='bfloat16', manip_jpeg_dtype='bfloat16', pool_impl='flat')
BENCH_BLOCKS, BENCH_BLOCK_STEPS = 2, 5     # timed blocks of steps, bf16 and f32 in turns
# shipped runs trained at INet 'high' / 'default' precision → K1 launches a
# request (their channel is float32; m_manipjpeg_bf16's jpeg:80 is bfloat16)
BF16_CLASSIFY_RUNS = {'data/m_prec_high/QualityRef/INet/ln-0.0050/fixed-codec/000': 2,
                      'data/m_prec_default/QualityRef/INet/ln-0.0050/fixed-codec/000': 2,
                      'data/m_manipjpeg_bf16/QualityRef/INet/ln-0.0050/fixed-codec/000': 1}
# the other camera ISPs: their shipped snapshots (QualityRef, the published
# widths), the joint runs trained on them and their shapes (raw patch 64,
# batch 10, λ_nip 0.005), the NIP trainer at the CLI's defaults (batch 20)
NIP_SNAPSHOTS = {'UNet': 'data/models/nip/QualityRef/UNet_5',
                 'DNet': 'data/models/nip/QualityRef/DNet_3x3_15x64f',
                 'ClassicISP': 'data/models/nip/QualityRef/ClassicISP_gbrg_5x5_-3R',
                 'INet': 'data/models/nip/QualityRef/INet_gbrg_5x5'}
NIP_RAW_PATCH, NIP_DEVELOP_BATCH = 64, 20
UNET_CLASSIFY_RUN = 'data/m_quality_full/QualityRef/UNet/fixed-nip/fixed-codec/000'
NIP_FLOW_RUNS = {'UNet': 'data/m_quality_sweep/QualityRef/UNet/ln-0.0050/fixed-codec/000',
                 'DNet': 'data/m_quality_dnet/QualityRef/DNet/ln-0.0050/fixed-codec/000'}
NIP_FLOW_BATCH, NIP_FLOW_LAMBDA = 10, 0.005
# a NIP's output on the card against the CPU's (float32 in another summation
# order through up to 23 convolutions; RGB in [0, 1])
MAX_NIP_DIFF = 1e-4
# A dJPEG coefficient that rounds the other way on the card than on the CPU
# moves an 8x8 block of the FAN's input by about a q step (1e-3 and more;
# float32 noise stays below 1e-4 there). Where one did, the FAN's gradient
# leaves are held to the bound the trainer tests give a run with flipped
# coefficients (5e-2), the NIP's and the loss parts to compare_steps' own:
# on the DNet run's first batch one channel block flips (|dy| 1.1e-2 in row
# 12 of 50) and the FAN's constrained filter's gradient norm moves by
# 4.4e-3, above MAX_GRADIENT_NORM_DIFF.
FLIP_THRESHOLD, FLIPPED_FAN_GRADIENT_DIFF = 1e-3, 5e-2
# the DCN channel in the joint flow: the m_quality_dcn lc-0.1000 run's shape
# (ONet at raw 64, so 128-px RGB in; downsampling 'none'; the 32c codec,
# trainable, λ_dcn 0.1; sharpen, resample, gaussian, jpeg:80; the FAN at its
# widths from its seed, the run holding no npz; batch 10): one step
# quantizes 5 x 10 x 16 x 16 x 32 = 409,600 latent values
DCN_FLOW_RUN = 'data/m_quality_dcn/QualityRef/ONet/fixed-nip/lc-0.1000/000'
DCN_FLOW_RAW_PATCH, DCN_FLOW_BATCH, DCN_FLOW_LAMBDA = 64, 10, 0.1
DCN_FLOW_LATENT = 5 * DCN_FLOW_BATCH * (2 * DCN_FLOW_RAW_PATCH // 8) ** 2 * 32
DCN_FLOW_FROZEN_STEPS = 3
# the DCN trainer at train_dcn.py's defaults (TwitterDCN 32c from its seed,
# patch 64, batch 50: 102,400 latent values a step) on procedural RGB
# images: 100 training images (2 steps an epoch) and 50 validation patches
# (one batch), cut from 500 epochs to 5 with validation every 2, so that
# the last epoch is validated and the snapshot holds the validated weights
DCN_TRAINER_PATCH, DCN_TRAINER_BATCH = 64, 50
DCN_TRAINER_IMAGES, DCN_TRAINER_SIZE, DCN_TRAINER_SPLIT = 150, (128, 192), (100, 50, 1)
DCN_TRAINER_EPOCHS, DCN_TRAINER_VALIDATION = 5, 2
# the restored snapshot's validation SSIM against the logged one (the same
# weights and patches through the same kernels on one card)
MAX_DCN_SSIM_DIFF = 1e-5
NIP_TRAINER_BATCH, NIP_TRAINER_SPLIT = 20, (40, 20, 1)
NIP_TRAINER_EPOCHS, NIP_TRAINER_VALIDATION = 4, 2
# the NIP trainer's first epoch's mean loss, card against CPU (relative): the
# same batches, float32 in another summation order over one epoch's 2 steps
MAX_NIP_EPOCH_LOSS_DIFF = 1e-4
# all seven manipulations through the joint flow: the m_quality run's shape
# (its INet snapshot, trainable, λ_nip 0.1; pool:2; JPEG QF 50 soft; the FAN
# at its logged widths) with an 8-class FAN from its seed (no shipped run has
# 8 classes), batch 20 raw 128-px patches: 160 expanded 256-px images a step
MANIP7 = ['sharpen', 'resample', 'gaussian', 'jpeg', 'awgn', 'gamma', 'median']
# the fused manipulate-then-pool expansion against the two-op form (the JAX
# test's tolerance: the folded kernels sum in another order)
POOLED_ATOL, POOLED_RTOL = 2e-5, 1e-4

# RAW ingestion and development at the repository's default camera, the Nikon
# D90 (config/cameras.json: GBRG and its camera → sRGB matrix; the shipped
# QualityRef NIPs are GBRG), at its full 4288x2848: a 14-bit capture with the
# fixtures' black 512, white 16383 and multipliers, written in every
# container and coding; the lossy NEF codes its last rows after its tree
# split (closed loop, a Python loop a row) and passes a 17-point curve; the
# cRAW uses a Sony tone curve of 12-bit range (white 4301 ≥ the capture's
# 14-bit values / 4)
RAW_CAMERA, RAW_HEIGHT, RAW_WIDTH = 'D90', 2848, 4288
RAW_BITS, RAW_BLACK, RAW_WHITE, RAW_CAM_MUL = 14, 512, 16383, (2.0, 1.0, 1.5, 1.0)
NEF_LOSSY_TAIL = 16
SONY_CURVE_POSTS = (8000, 10400, 12900, 14100)
RAW_DEMOSAICERS, RAW_DEVELOP_REPS, RAW_NIP_REPS = ('bilinear', 'malvar', 'menon'), 5, 3
RAW_CROP, RAW_NIP_CROP = 1024, 256
RAW_CLI_CONTAINERS = ('DNG', 'CR2', 'NEF lossless')
# the card's development against the CPU's: float64 through the same
# operations, so the same sums; the last bit of pow (gamma) may differ, and
# a uint8 value where 255·x lies on a rounding boundary with it
MAX_DEVELOP_DIFF, MAX_DEVELOP_U8_SHARE = 1e-12, 1e-5

# the codec-evaluation layer: the R/D sweep on the Kodak stand-in (4 images of
# 512x768 written as PNG; the JPEG leg's QF 10-95 step 5, 72 rows; the DCN leg
# over the shipped 8c/16c/32c/64c, 16 rows, one K2 launch a row), then the
# evaluation CLIs at their defaults (test_jpeg: 4 images of 256x384, one K1
# launch a quality; test_dcn on 32c: 4 images of 256x256) and validate_jpeg
# with the libjpeg codec
RD_IMAGES, RD_SHAPE, RD_QUALITIES = 4, (512, 768), range(10, 96, 5)
RD_DCN_ROOT = 'data/models/dcn'
RD_PRESETS = ('8c', '16c', '32c', '64c')
RD_METRICS = ('ssim', 'psnr', 'msssim_db')
# the host codec against its plain version: small procedural images at every subsampling
CODEC_CHECK_SHAPES, CODEC_CHECK_QUALITIES = ((37, 53), (64, 96)), (25, 75)
JPEG_ROUND_TRIP_REPS = 10
# K2 launches of the test_dcn modes on 4 images: 'batch' codes the batch once
# and each image twice (its bitstream and its entropy), the others each image once
TEST_DCN_K2 = {'batch': 9, 'jpeg-match-ssim': 4, 'jpeg-match-bpp': 4, 'rate-dist': 4}
# test_jpeg's dJPEG PSNR on the card against the CPU's (K1 against its plain
# version: a few coefficients on rounding ties)
MAX_DJPEG_PSNR_DIFF = 1e-3

# the last rate-distortion legs, on the host codecs of the system's libraries:
# (leg, codec, sweep, the library it needs, the reference's qualities). Each runs
# on [codec eval]'s images at its full quality range, JPEG 2000 on the first 2
# of them (its PSNR bisection encodes a row ~8 times); the evaluation CLI then
# runs on those 2 with the shipped DCNs, K2 once a DCN row
CODEC_LEGS = (('JPEG 2000', 'jpeg2000', rd.get_jpeg2k_df, 'libopenjp2', tuple(range(25, 46))),
              ('BPG', 'bpg', rd.get_bpg_df, 'bpgenc/bpgdec', range(15, 48, 3)),
              ('WebP', 'webp', rd.get_webp_df, 'libwebp', range(10, 96, 5)),
              ('AVIF', 'avif', rd.get_avif_df, 'libavif', range(10, 96, 5)))
JP2_IMAGES = 2
HEVC_QP = 28
# the PNG reader: a 12 MP RGB image whose rows cycle through the five filters
UNFILTER_SHAPE = (3000, 4000)

# H100 SXM data sheet (dense, at the 700 W limit): the least time for a
# kernel's work is the larger of bytes / memory rate and operations / peak
# rate. The work of each launch comes from the kernel's own module
# (``jpeg8x8.jpeg_core_work``, ``codebook.codebook_*_work``), which
# ``profiling.step_cost`` counts too: K1's FLOPs, and K2-K4's issued
# instructions (most of them inside log1pf, the exp and the divisions; see
# ``ops/hopper/codebook.py``). Each SM issues 128 lanes of instructions a
# clock (4 schedulers x 32 lanes, whatever the pipe), so the card issues 132
# SMs x 128 x 1.98 GHz = 33.45 T instructions/s (the 67 TFLOP/s f32 rate, an
# FMA being 2 FLOP).
HBM_BYTES_PER_S = profiling.CHIP_PEAKS['h100 80gb hbm3'][1]
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
F32_INSTR_PER_S = 132 * 128 * 1.98e9


def synthetic_raw(seed, n, patch):
    """(n, patch, patch, 4) RGGB stacks in [0, 1]: a smooth random field
    (bilinear over 16-px cells), light noise, linearized with gamma 2.2 —
    camera-like enough that the FAN's probabilities are not saturated."""
    rng = np.random.default_rng(seed)
    cells = patch // 16 + 1
    coarse = torch.from_numpy(rng.random((n, 4, cells, cells)).astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(patch, patch), mode='bilinear',
                                             align_corners=True)
    noise = torch.from_numpy(rng.standard_normal((n, 4, patch, patch)).astype(np.float32))
    x = (smooth + 0.01 * noise).clamp(0, 1) ** 2.2
    return x.permute(0, 2, 3, 1).contiguous().numpy()


def synthetic_rgb(seed, n, height, width):
    """(n, height, width, 3) RGB in [0, 1]: a smooth random field (bilinear
    over 32-px cells) plus light noise, a photo-like input for the codec."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 3, height // 32 + 1, width // 32 + 1))
                              .astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(height, width), mode='bilinear',
                                             align_corners=True)
    noise = torch.from_numpy(rng.standard_normal((n, 3, height, width)).astype(np.float32))
    return (smooth + 0.02 * noise).clamp(0, 1).permute(0, 2, 3, 1).contiguous().numpy()


# the hand-written kernels' function names in a profile
HAND_KERNELS = ('jpeg8x8', 'codebook', 'sum_rows')
SPIN_CYCLES = 200_000            # ~0.1 ms at 1.98 GHz: more than a wrapper's host time
MAX_SPIN_CYCLES = 1024 * SPIN_CYCLES   # ~0.1 s: a busy host's hiccups


def time_ms(fn, reps, flush, device_only=True):
    """Median time of ``fn`` in ms over ``reps`` launches, each timed alone by
    CUDA events with the L2 cache flushed before it.

    ``device_only``: each launch is queued behind a device-side spin
    (``torch.cuda._sleep``), and a launch counts only if the device has not
    yet reached the start event when the host has queued the end event, so
    no host time (the wrapper's checks, allocations, the ctypes call) falls
    inside the window; a launch that misses is retried with a spin twice as
    long. Without it (for the plain versions, whose host loops and
    synchronizing copies no spin covers), the window holds the host's time
    too, as a caller sees it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SPIN_CYCLES
    while len(times) < reps:
        flush.zero_()
        if device_only:
            torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if not device_only or queued_ahead:
            times.append(start.elapsed_time(end))
        elif cycles < MAX_SPIN_CYCLES:
            cycles *= 2
        else:
            raise RuntimeError('the host did not queue the timed launch within the spin')
    return float(np.median(times))


def kernel_ms(fn, reps, flush, match=HAND_KERNELS):
    """Device ms per call of each kernel that ``fn`` launches whose name holds
    a string of ``match``, from ``torch.profiler`` over ``reps`` calls (L2
    flushed before each), by the kernel's function name: splits a function
    into its launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {re.search(r'(\w+(<[^()]*>)?)\(', e.key).group(1): e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and any(m in e.key for m in match)}


def device_profile(fn, reps, n_top=12, match=()):
    """Run ``fn`` ``reps`` times under torch.profiler; device ms per call,
    busy share of the window, device operations per call, the ``n_top``
    kernels that take the most time, and the ms per call of the kernels whose
    names hold a string of ``match``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only (host ops also carry the device time of the
    # kernels they launch), without user annotations such as Optimizer.step,
    # whose device-track spans cover kernels that are counted themselves
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    device_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{'kernel': e.key[:90], 'calls_per_call': e.count / reps,
            'ms_per_call': e.self_device_time_total / 1e3 / reps} for e in events[:n_top]]
    matched_ms = sum(e.self_device_time_total for e in events
                     if any(m in e.key for m in match)) / 1e3 / reps
    return {'profiled_wall_ms_per_call': 1e3 * window / reps,
            'device_ms_per_call': device_us / 1e3 / reps,
            'device_busy_share': device_us / 1e6 / window,
            'device_ops_per_call': sum(e.count for e in events) / reps,
            'matched_kernels_ms_per_call': matched_ms, 'top_kernels': top}


def print_profile(label, p):
    print(f'[{label}] device {p["device_ms_per_call"]:.3f} ms of '
          f'{p["profiled_wall_ms_per_call"]:.3f} ms wall per call, busy '
          f'{100 * p["device_busy_share"]:.1f}%, {p["device_ops_per_call"]:.0f} device ops, '
          f'matched kernels {p["matched_kernels_ms_per_call"]:.4f} ms', flush=True)
    for row in p['top_kernels']:
        print(f"[{label}]   {row['ms_per_call']:8.3f} ms x{row['calls_per_call']:5.1f} "
              f"{row['kernel']}", flush=True)


def format_launches(launch_ms):
    return ', '.join(f'{name} {ms:.4f} ms' for name, ms in launch_ms.items())


def copy_ms(planes, reps, flush):
    """Device ms of one copy with K1's traffic on ``planes``: float32 to
    float64, one kernel that reads 4 and writes 8 bytes a pixel, timed as
    ``time_ms`` times a kernel. The rate the card delivers for K1's bytes,
    not a library call computing K1's function."""
    out = torch.empty(planes.shape, dtype=torch.float64, device=planes.device)
    return time_ms(lambda: out.copy_(planes), reps, flush)


def k1_inputs(p, h, w, quality, gen, device):
    """Centered planes (P, H, W) from ``gen`` and their q-tables at
    ``quality``, luma then chroma twice, repeated."""
    planes = (torch.rand((p, h, w), generator=gen) * 255 - 127).to(device)
    q_luma, q_chroma = qtables(quality, device)
    q = torch.stack([q_luma, q_chroma, q_chroma]).repeat(-(-p // 3), 1, 1)[:p].contiguous()
    return planes, q


def k1_bound(shape):
    """(least ms, 'bytes' or 'operations') of a K1 launch on planes of
    ``shape``: its FLOPs at the f32 rate, its bytes at the memory rate."""
    flops, bytes_moved = jpeg8x8.jpeg_core_work(shape)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def check_k1(name, planes, q, reps, flush):
    """K1 against its plain version on the card at one shape; returns its record."""
    y_k, c_k = jpeg8x8.jpeg_core_cuda(planes, q)
    with torch.no_grad():
        y_p, c_p = jpeg8x8.jpeg_core_plain(planes, q)
    torch.cuda.synchronize()
    report = jpeg8x8.check_cores(y_k, c_k, y_p, c_p, q)
    with torch.no_grad():
        ms = time_ms(lambda: jpeg8x8.jpeg_core_cuda(planes, q), reps, flush)
        plain_ms = time_ms(lambda: jpeg8x8.jpeg_core_plain(planes, q), reps, flush,
                           device_only=False)
        launch_ms = kernel_ms(lambda: jpeg8x8.jpeg_core_cuda(planes, q), reps, flush)
        copy = copy_ms(planes, reps, flush)
    p, h, w = planes.shape
    bound_ms, bound_by = k1_bound(planes.shape)
    record = {'shape': name, 'P': p, 'H': h, 'W': w, 'ms': ms, 'plain_ms': plain_ms,
              'launch_ms': launch_ms, 'copy_ms': copy, 'bound_ms': bound_ms,
              'bound_by': bound_by, **report}
    print(f'[k1] {name}: P={p} {h}x{w} flipped={report["flipped"]}/{report["coefficients"]} '
          f'max|dy| clean blocks={report["max_abs_err"]:.3g} all={report["max_abs_err_all"]:.3g} '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, copy {copy:.4f} ms, bound '
          f'{record["bound_ms"]:.4f} ms ({record["bound_by"]}); launches '
          f'{format_launches(launch_ms)}', flush=True)
    return record


def bound(work):
    """(least ms, 'bytes' or 'operations') of a K2-K4 launch's (instructions, bytes)."""
    instructions, bytes_moved = work
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = instructions / F32_INSTR_PER_S * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def timed_record(shape, n, kernel, plain, work, reps, flush, **report):
    """A kernel's record at one shape: its time and its plain version's, its
    bound (from its ``work``), and the agreement ``report``."""
    bound_ms, bound_by = bound(work)
    return {'shape': shape, 'n': n, 'ms': time_ms(kernel, reps, flush),
            'plain_ms': time_ms(plain, reps, flush, device_only=False),
            'launch_ms': kernel_ms(kernel, reps, flush), 'bound_ms': bound_ms,
            'bound_by': bound_by, **report}


def check_codebook(name, n, reps, flush, gen, device, backward=False):
    """K2 at N values, and with ``backward`` K3 and K4, against their plain
    versions on the card; returns their records."""
    cb = torch.from_numpy(quant.default_codebook(5)).to(device)
    n_codes = cb.numel()
    z = (torch.randn(n, generator=gen) * 4).to(device)
    soft, hard = codebook.codebook_fwd_cuda(z, cb)
    k2 = codebook.check_forward(soft, hard, *codebook.codebook_fwd_plain(z, cb), cb)
    records = {'codebook_fwd': timed_record(
        name, n, lambda: codebook.codebook_fwd_cuda(z, cb),
        lambda: codebook.codebook_fwd_plain(z, cb), codebook.codebook_fwd_work(z.shape, cb.shape),
        reps, flush,
        max_abs_err=k2['max_abs_err'], index_flip_share=k2['index_flips'] / n)}
    if backward:
        g = torch.randn(n, generator=gen).to(device)
        pc = torch.randn(n_codes, generator=gen).to(device)
        dz_scale, _ = codebook.backward_error_scale(z, g, cb, pc)
        k3 = codebook.check_backward(codebook.codebook_bwd_cuda(z, g, cb, pc),
                                     codebook.codebook_bwd_plain(z, g, cb, pc), dz_scale)
        records['codebook_bwd'] = timed_record(
            name, n, lambda: codebook.codebook_bwd_cuda(z, g, cb, pc),
            lambda: codebook.codebook_bwd_plain(z, g, cb, pc),
            codebook.codebook_bwd_work(z.shape, g.shape, cb.shape), reps, flush, **k3)
        cb_off = cb + 0.05        # non-integer codewords: a nontrivial dcb
        dz, dcb = codebook.codebook_bwd_train_cuda(z, g, cb_off, pc)
        dz_ref, dcb_ref = codebook.codebook_bwd_train_plain(z, g, cb_off, pc)
        dz_scale, dcb_scale = codebook.backward_error_scale(z, g, cb_off, pc)
        k4 = [codebook.check_backward(dz, dz_ref, dz_scale),
              codebook.check_backward(dcb, dcb_ref, dcb_scale, 'dcb')]
        records['codebook_bwd_train'] = timed_record(
            name, n, lambda: codebook.codebook_bwd_train_cuda(z, g, cb_off, pc),
            lambda: codebook.codebook_bwd_train_plain(z, g, cb_off, pc),
            codebook.codebook_bwd_train_work(z.shape, g.shape, cb.shape), reps, flush,
            **{key: max(r[key] for r in k4) for key in k4[0]})
    for kernel, r in records.items():
        agreement = (f'index flips {r["index_flip_share"]:.3g}' if 'index_flip_share' in r
                     else f'{r["max_eps_of_scale"]:.3g} eps of the terms\' scale')
        print(f'[{kernel}] {name}: N={n} L={n_codes} max|err| {r["max_abs_err"]:.3g} '
              f'({agreement}); kernel {r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}); launches '
              f'{format_launches(r["launch_ms"])}', flush=True)
    return records


# K5's stages at the m_quality flows' 128-px patches, (Cin, Cout, side), at the
# FAN batches of the m_quality (5 classes x 20 patches) and m_quality_dcn (x 10) flows
FAN_STAGES = ((3, 32, 128), (32, 64, 64), (64, 128, 32), (128, 256, 16))
FAN_ROWS = (100, 50)


def f32_bound(work):
    """(least ms, 'bytes' or 'operations') of a K5 launch's (operations, bytes):
    the float32 rate of the CUDA cores, the HBM's bytes."""
    operations, bytes_moved = work
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


# K5's largest error by norm against a float64 evaluation of the same stage
# (it reads under 1e-6; cuDNN's float32 composition, whose wgrad takes an FFT
# at conv1 and conv2, reads up to 1e-2), and the largest share of windows
# whose code may differ from the float32 plain version's (near-ties of the
# float32 sums)
K5_MAX_NORM_ERR = 1e-5
K5_MAX_CODE_FLIPS = 1e-4


def norm_error(got, exact):
    return float((got.double() - exact).norm() / exact.norm())


def check_fan_conv(reps, flush, gen, device):
    """K5's forward, dgrad and wgrad at the FAN's stage shapes against a
    float64 evaluation of their plain versions on the card, by norm (the
    gradients through K5's code), and timed beside their bound and their
    float32 plain versions; ``library_ms`` the cuDNN composition (conv, leaky
    ReLU, max-pool) forward, and its autograd backward (dx, dW, db) for the
    dgrad and wgrad together. Fails where an error or the share of codes
    that differ passes its limit. Returns the records."""
    records = []
    for n in FAN_ROWS:
        for c_in, c_out, side in FAN_STAGES:
            x = torch.randn((n, c_in, side, side), generator=gen).to(device)
            w = (torch.randn((c_out, c_in, 5, 5), generator=gen) / (5 * c_in ** 0.5)).to(device)
            b = (0.1 * torch.randn(c_out, generator=gen)).to(device)
            y, code = fan_conv.fan_conv_fwd_cuda(x, w, b)
            code_p = fan_conv.fan_conv_fwd_plain(x, w, b)[1]
            dy = torch.randn(tuple(y.shape), generator=gen).to(device)
            got = {'fwd': (y,), 'dgrad': (fan_conv.fan_conv_dgrad_cuda(dy, code, w),),
                   'wgrad': fan_conv.fan_conv_wgrad_cuda(dy, code, x)}
            x64, w64, b64, dy64 = (t.double() for t in (x, w, b, dy))
            exact = {'fwd': (fan_conv.fan_conv_fwd_plain(x64, w64, b64)[0],),
                     'dgrad': (fan_conv.fan_conv_dgrad_plain(dy64, code, w64),),
                     'wgrad': fan_conv.fan_conv_wgrad_plain(dy64, code, x64)}
            del x64, w64, b64, dy64
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            y_lib = F.max_pool2d(F.leaky_relu(F.conv2d(*leaves, padding=2), 0.2), 2)
            library = {'fwd': time_ms(lambda: F.max_pool2d(
                           F.leaky_relu(F.conv2d(x, w, b, padding=2), 0.2), 2), reps, flush),
                       'bwd': time_ms(lambda: torch.autograd.grad(y_lib, leaves, dy,
                                                                  retain_graph=True),
                                      reps, flush)}
            launch = {'fwd': (lambda: fan_conv.fan_conv_fwd_cuda(x, w, b),
                              lambda: fan_conv.fan_conv_fwd_plain(x, w, b),
                              fan_conv.fan_conv_fwd_work(x.shape, w.shape)),
                      'dgrad': (lambda: fan_conv.fan_conv_dgrad_cuda(dy, code, w),
                                lambda: fan_conv.fan_conv_dgrad_plain(dy, code, w),
                                fan_conv.fan_conv_dgrad_work(dy.shape, code.shape, w.shape)),
                      'wgrad': (lambda: fan_conv.fan_conv_wgrad_cuda(dy, code, x),
                                lambda: fan_conv.fan_conv_wgrad_plain(dy, code, x),
                                fan_conv.fan_conv_wgrad_work(dy.shape, code.shape, x.shape))}
            record = {'n': n, 'c_in': c_in, 'c_out': c_out, 'side': side,
                      'code_flip_share': float((code != code_p).float().mean()),
                      'library_fwd_ms': library['fwd'], 'library_bwd_ms': library['bwd']}
            for kind, (kernel, plain, work) in launch.items():
                bound_ms, bound_by = f32_bound(work)
                ms = time_ms(kernel, reps, flush)
                record[kind] = {
                    'ms': ms, 'plain_ms': time_ms(plain, reps, flush, device_only=False),
                    'bound_ms': bound_ms, 'bound_by': bound_by, 'share': bound_ms / ms,
                    'norm_rel_err': max(norm_error(a, r) for a, r in zip(got[kind], exact[kind]))}
            records.append(record)
            del exact, got
            print(f'[k5] N={n} {c_in}->{c_out} at {side}x{side}: ' + '; '.join(
                f'{kind} {r["ms"]:.4f} ms (bound {r["bound_ms"]:.4f}, {r["bound_by"]}: '
                f'{100 * r["share"]:.0f}%), plain {r["plain_ms"]:.4f}, error by norm against '
                f'float64 {r["norm_rel_err"]:.2g}' for kind, r in ((k, record[k]) for k in launch))
                + f'; cuDNN composition forward {library["fwd"]:.4f} ms, backward '
                  f'{library["bwd"]:.4f} ms; code flips {record["code_flip_share"]:.2g}',
                flush=True)
            worst = max(record[kind]['norm_rel_err'] for kind in launch)
            if not worst <= K5_MAX_NORM_ERR:
                raise AssertionError(f'[k5] N={n} {c_in}->{c_out}: error by norm {worst:.3g} '
                                     f'against float64, above {K5_MAX_NORM_ERR}')
            if not record['code_flip_share'] <= K5_MAX_CODE_FLIPS:
                raise AssertionError(f'[k5] N={n} {c_in}->{c_out}: codes differ from the plain '
                                     f'version\'s at {record["code_flip_share"]:.3g} of the '
                                     f'windows, above {K5_MAX_CODE_FLIPS}')
    return records


COUNTERS = {'jpeg8x8': jpeg8x8.jpeg_core_cuda,
            'codebook_fwd': codebook.codebook_fwd_cuda,
            'codebook_bwd': codebook.codebook_bwd_cuda,
            'codebook_bwd_train': codebook.codebook_bwd_train_cuda,
            'fan_conv_fwd': fan_conv.fan_conv_fwd_cuda,
            'fan_conv_dgrad': fan_conv.fan_conv_dgrad_cuda,
            'fan_conv_wgrad': fan_conv.fan_conv_wgrad_cuda}
K5_COUNTERS = ('fan_conv_fwd', 'fan_conv_dgrad', 'fan_conv_wgrad')
NO_K5 = dict.fromkeys(K5_COUNTERS, 0)


def fan_passes(forward, backward=0):
    """K5's launches in ``forward`` passes of a 4-stage FAN, ``backward`` of
    them with their backward (a dgrad and a wgrad a stage)."""
    return {'fan_conv_fwd': 4 * forward, 'fan_conv_dgrad': 4 * backward,
            'fan_conv_wgrad': 4 * backward}


# K1's and K5's launches by shape on the paths of this process: what each
# window from zero_counts to read_counts launched, each launch once
PATH_SIZES = {name: collections.Counter() for name in ('jpeg8x8', *K5_COUNTERS)}
_TALLIED = {name: collections.Counter() for name in PATH_SIZES}
K1_PATH_SIZES = PATH_SIZES['jpeg8x8']


def zero_counts():
    for wrapper in COUNTERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, 'sizes'):
            wrapper.sizes.clear()
    for tallied in _TALLIED.values():
        tallied.clear()


def read_counts():
    for name, tallied in _TALLIED.items():
        sizes = COUNTERS[name].sizes
        PATH_SIZES[name].update(sizes - tallied)
        tallied.clear()
        tallied.update(sizes)
    return {name: wrapper.launches for name, wrapper in COUNTERS.items()}


def expect_counts(path, counts, expected):
    """Fail unless the path launched exactly ``expected`` of each kernel. K5's
    counts are held exactly where ``expected`` names them; elsewhere they have
    to be whole passes of a 4-stage FAN, no stage's backward more often than
    its forward."""
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if not any(name in expected for name in K5_COUNTERS):
        fan = {name: counts[name] for name in K5_COUNTERS}
        if (any(n % 4 for n in fan.values())
                or max(fan['fan_conv_dgrad'], fan['fan_conv_wgrad']) > fan['fan_conv_fwd']):
            raise AssertionError(f'{path}: K5 launches {fan} are not whole FAN passes')
        want.update(fan)
    if counts != want:
        raise AssertionError(f'{path}: launches {counts}, expected {expected}')


def training_batches(seed, n, batch, raw_patch=RAW_PATCH):
    """``n`` (raw, target) pairs on the device: raw ``raw_patch``-px RGGB
    patches and RGB targets twice as large, made on the host and copied
    once, as a trainer's device-resident batches are."""
    return [(torch.from_numpy(synthetic_raw(seed + i, batch, raw_patch)).cuda(),
             torch.from_numpy(synthetic_rgb(seed + 50 + i, batch, 2 * raw_patch,
                                            2 * raw_patch)).cuda()) for i in range(n)]


def main_path_training(args, device):
    """The joint INet + FAN training step at full width; returns (launch
    counts, results)."""
    flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                              rng_seed=args.seed, device=device)
    flow.nan_check = False        # checked once at the end (assert_finite)
    batches = training_batches(args.seed + 300, TRAIN_STEPS + 1, args.batch)

    # the first step's loss and gradients against the port's own CPU step
    cpu = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                             device='cpu')
    bx, by = batches[0]
    card = flow.loss_and_gradients(bx, by, TRAIN_LAMBDA_NIP)
    step_cpu = cpu.loss_and_gradients(bx.cpu(), by.cpu(), TRAIN_LAMBDA_NIP)
    agreement = compare_steps(card, step_cpu)
    print(f'[train] first step vs the CPU: loss parts within '
          f'{agreement["max_loss_rel_diff"]:.3g} (relative), gradient norms within '
          f'{agreement["max_grad_norm_rel_diff"]:.3g}; norms {agreement["grad_norms"]} vs '
          f'{agreement["grad_norms_ref"]}', flush=True)

    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in flow._collect_params().items()}
    flow.training_step(bx, by, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = {False: [], True: []}, []
    for i in range(TRAIN_STEPS + TRAIN_AUGMENTED_STEPS):
        augment = i >= TRAIN_STEPS
        bx, by = batches[1 + i % TRAIN_STEPS]
        launched = jpeg8x8.jpeg_core_cuda.launches
        t0 = time.perf_counter()
        loss, parts = flow.training_step(bx, by, TRAIN_LAMBDA_NIP, augment=augment,
                                         learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        times[augment].append(time.perf_counter() - t0)
        launched = jpeg8x8.jpeg_core_cuda.launches - launched
        losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
        print(f'[train] step {i}{" (augment)" if augment else ""}: '
              f'{1e3 * times[augment][-1]:.2f} ms, loss {losses[-1]["loss"]:.4f} '
              f'ce {losses[-1]["ce"]:.4f} nip {losses[-1]["nip"]:.3f}, K1 launches {launched}',
              flush=True)
        if launched != 2:
            raise AssertionError(f'training step {i} launched K1 {launched} times, expected 2')
    counts = read_counts()
    n_steps = TRAIN_STEPS + TRAIN_AUGMENTED_STEPS
    expect_counts('main-path training', counts,
                  {'jpeg8x8': 2 * n_steps, **fan_passes(n_steps, n_steps)})
    flow.assert_finite()
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f'non-finite training losses {losses}')
    moved = {part: max(float((p.detach() - before[part][k]).abs().max())
                       for k, p in leaves.items())
             for part, leaves in flow._collect_params().items()}
    if not (moved['nip'] > 0 and moved['fan'] > 0):
        raise AssertionError(f'parameters did not move: {moved}')
    median = float(np.median(times[False]))
    print(f'[train] median step {1e3 * median:.2f} ms: {1 / median:.2f} steps/s, '
          f'{args.batch / median:.1f} raw patches/s; augmented steps '
          f'{", ".join(f"{1e3 * t:.2f}" for t in times[True])} ms; K1 launches a step '
          f'{counts["jpeg8x8"] / n_steps:g}, K5 launches a step '
          f'{[counts[k] / n_steps for k in K5_COUNTERS]}; largest parameter change {moved}',
          flush=True)
    return counts, {'batch': args.batch, 'raw_patch': RAW_PATCH, 'lambda_nip': TRAIN_LAMBDA_NIP,
                    'lr': TRAIN_LR, 'step_ms': [1e3 * t for t in times[False]],
                    'augmented_step_ms': [1e3 * t for t in times[True]],
                    'median_ms': 1e3 * median, 'steps_per_s': 1 / median,
                    'raw_patches_per_s': args.batch / median,
                    'k1_launches_per_step': counts['jpeg8x8'] / n_steps,
                    'k5_launches_per_step': {k: counts[k] / n_steps for k in K5_COUNTERS},
                    'losses': losses, 'largest_change': moved,
                    'cpu_first_step': agreement}

def bench_flow(device, seed=0):
    """bench.py's flow (``BENCH_ARGS``) at full width on ``device``, with the
    m_quality run's INet and the deferred NaN check."""
    flow = ManipulationClassification('INet', raw_patch_size=RAW_PATCH, rng_seed=seed,
                                      device=device, **BENCH_ARGS)
    flow.nip.load_model(str(base.REPO_ROOT / RUN_DIR / 'models'))
    flow._snapshot()
    flow.reinitialize()
    flow.nan_check = False
    return flow


def bf16_training(args, device):
    """bench.py's configuration: the first step on the card against the
    port's CPU step, then timed steps in blocks taken in turns with the
    float32 step of the m_quality run (the main-path training phase's flow)
    on the same batches, augmented steps, and a device profile of each step;
    returns (launch counts, results)."""
    flow = bench_flow(device, args.seed)
    if flow.fan.count_parameters() != 1_145_382:
        raise AssertionError(f'bench FAN has {flow.fan.count_parameters()} parameters')
    f32 = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                             rng_seed=args.seed, device=device)
    f32.nan_check = False
    batches = training_batches(args.seed + 600, BENCH_BLOCK_STEPS + 1, args.batch)
    bx, by = batches[0]
    t0 = time.perf_counter()
    step_cpu = bench_flow('cpu', args.seed).loss_and_gradients(bx.cpu(), by.cpu(),
                                                               TRAIN_LAMBDA_NIP)
    cpu_s = time.perf_counter() - t0
    agreement = compare_steps(flow.loss_and_gradients(bx, by, TRAIN_LAMBDA_NIP), step_cpu,
                              BF16_STEP_LOSS_DIFF, BF16_GRADIENT_NORM_DIFF)
    print(f'[bf16 train] first step vs the CPU ({cpu_s:.1f} s there): loss parts within '
          f'{agreement["max_loss_rel_diff"]:.3g} (relative, bound {BF16_STEP_LOSS_DIFF:g}), '
          f'gradient norms within {agreement["max_grad_norm_rel_diff"]:.3g} (bound '
          f'{BF16_GRADIENT_NORM_DIFF:g}); norms {agreement["grad_norms"]} vs '
          f'{agreement["grad_norms_ref"]}', flush=True)

    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in flow._collect_params().items()}
    for f in (flow, f32):                       # warm-up (cuDNN autotuning, caches)
        f.training_step(bx, by, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    zero_counts()
    times, losses = {'bf16': [], 'f32': [], 'bf16 augment': []}, []

    def timed(f, label, bx, by, augment=False):
        t0 = time.perf_counter()
        loss, parts = f.training_step(bx, by, TRAIN_LAMBDA_NIP, augment=augment,
                                      learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        times[label].append(time.perf_counter() - t0)
        return loss, parts

    bf16_counts = {name: 0 for name in COUNTERS}
    for block in range(BENCH_BLOCKS):
        for i in range(BENCH_BLOCK_STEPS):
            before_k1 = read_counts()
            loss, parts = timed(flow, 'bf16', *batches[1 + i])
            bf16_counts = {k: bf16_counts[k] + v - before_k1[k] for k, v in read_counts().items()}
            losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
        for i in range(BENCH_BLOCK_STEPS):
            timed(f32, 'f32', *batches[1 + i])
    for i in range(TRAIN_AUGMENTED_STEPS):
        before_k1 = read_counts()
        loss, parts = timed(flow, 'bf16 augment', *batches[1 + i], augment=True)
        bf16_counts = {k: bf16_counts[k] + v - before_k1[k] for k, v in read_counts().items()}
        losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
    expect_counts('bf16 training (bench.py configuration)', bf16_counts, NO_K5)
    flow.assert_finite()
    f32.assert_finite()
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f'non-finite bf16 training losses {losses}')
    moved = {part: max(float((p.detach() - before[part][k]).abs().max())
                       for k, p in leaves.items())
             for part, leaves in flow._collect_params().items()}
    if not (moved['nip'] > 0 and moved['fan'] > 0):
        raise AssertionError(f'bf16 parameters did not move: {moved}')
    profiles = {label: device_profile(lambda: f.training_step(bx, by, TRAIN_LAMBDA_NIP,
                                                              learning_rate=TRAIN_LR), 5)
                for label, f in (('bf16', flow), ('f32', f32))}
    flow.assert_finite()
    f32.assert_finite()
    medians = {label: 1e3 * float(np.median(t)) for label, t in times.items()}
    for label in ('bf16', 'f32'):
        p = profiles[label]
        print(f'[bf16 train] {label} step: median {medians[label]:.2f} ms '
              f'({", ".join(f"{1e3 * t:.2f}" for t in times[label])}); device '
              f'{p["device_ms_per_call"]:.2f} ms a step, busy {100 * p["device_busy_share"]:.1f}%, '
              f'{p["device_ops_per_call"]:.0f} device ops', flush=True)
    print(f'[bf16 train] augmented bf16 steps '
          f'{", ".join(f"{1e3 * t:.2f}" for t in times["bf16 augment"])} ms; K1 launches '
          f'{bf16_counts["jpeg8x8"]}; bf16 / f32 step {medians["bf16"] / medians["f32"]:.3f}; '
          f'largest parameter change {moved}', flush=True)
    return bf16_counts, {
        'batch': args.batch, 'raw_patch': RAW_PATCH, 'lambda_nip': TRAIN_LAMBDA_NIP,
        'lr': TRAIN_LR, 'step_ms': {k: [1e3 * t for t in v] for k, v in times.items()},
        'median_ms': medians, 'steps_per_s': {k: 1e3 / v for k, v in medians.items()},
        'bf16_over_f32': medians['bf16'] / medians['f32'],
        'device_ms_per_step': {k: p['device_ms_per_call'] for k, p in profiles.items()},
        'device_busy_share': {k: p['device_busy_share'] for k, p in profiles.items()},
        'device_ops_per_step': {k: p['device_ops_per_call'] for k, p in profiles.items()},
        'k1_launches': bf16_counts['jpeg8x8'], 'losses': losses, 'largest_change': moved,
        'cpu_first_step': agreement, 'cpu_step_s': cpu_s}


def bf16_classification(args, device):
    """Restore the shipped runs trained at INet 'high' / 'default' precision
    (one with a bfloat16 'jpeg' manipulation) and answer requests; K1 as many
    times a request as each run's float32 codecs need; the probabilities
    against the port's CPU forward of the same run. Returns (launch counts,
    results)."""
    counts, results = {name: 0 for name in COUNTERS}, {}
    batches = [synthetic_raw(args.seed + 700 + i, args.batch, RAW_PATCH)
               for i in range(args.requests)]
    for run_dir, k1_per_request in BF16_CLASSIFY_RUNS.items():
        name = run_dir.split('/')[1]
        flow = ManipulationClassification.restore(run_dir, RAW_PATCH, device=device)
        flow.run_workflow_to_decisions(batches[0])      # warm-up
        torch.cuda.synchronize()
        zero_counts()
        latencies = []
        for batch in batches:
            t0 = time.perf_counter()
            flow.run_workflow_to_decisions(batch)
            latencies.append(time.perf_counter() - t0)
        run_counts = read_counts()
        expect_counts(f'bf16 classification ({name})', run_counts,
                      {'jpeg8x8': k1_per_request * args.requests})
        counts = {k: counts[k] + v for k, v in run_counts.items()}
        probs = flow.run_workflow(batches[0])[-1]
        if not bool(torch.isfinite(probs).all()):
            raise AssertionError(f'{name}: non-finite probabilities')
        report = compare_probabilities(
            probs.cpu(), ManipulationClassification.restore(run_dir, RAW_PATCH, device='cpu')
            .run_workflow(batches[0])[-1])
        results[name] = {'precision': flow.channel_precision,
                         'inet_conv_precision': flow.nip._h.conv_precision,
                         'latency_ms': [1e3 * t for t in latencies],
                         'median_ms': 1e3 * float(np.median(latencies)),
                         'k1_launches': run_counts['jpeg8x8'],
                         'cpu_max_abs_prob_diff': report['max_abs_diff']}
        print(f'[bf16 classify] {name}: INet {flow.nip._h.conv_precision}, '
              f'{flow.channel_precision}; median request '
              f'{results[name]["median_ms"]:.2f} ms, K1 launches {run_counts["jpeg8x8"]} '
              f'({k1_per_request} a request); vs the CPU max |dp| {report["max_abs_diff"]:.3g}, '
              f'{report["decided_rows"]}/{report["rows"]} decided rows agree', flush=True)
    return counts, results


def trainer_flow(device):
    """The m_quality run's flow (its manipulations, channel and FAN) with
    fresh weights and the NIP trainable, on ``device``."""
    with open(os.path.join(RUN_DIR, 'training.json')) as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    return ManipulationClassification(
        log['nip']['model'], manipulations=[m for m in log['manipulations'] if m != 'native'],
        distribution=log['distribution'], fan_args=fan_args, trainable={'nip'},
        raw_patch_size=RAW_PATCH, device=device)


class ValidationClock(logging.Handler):
    """The host times of a trainer's validation log lines: where each
    validation starts (logged once the epochs before it have run on the
    device) and where it ends (after its results and snapshots reached the
    host; the joint trainer's line with the accuracy, the NIP trainer's with
    the validation PSNR, the DCN trainer's with the validation SSIM)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.starts, self.ends = [], []

    def emit(self, record):
        message = record.getMessage()
        if message.endswith(': validating'):
            self.starts.append(record.created)
        elif ((record.funcName == 'validate' and 'accuracy' in message)
              or 'validation psnr' in message or 'validation ssim' in message):
            self.ends.append(record.created)


def trainer_run(flow, data_dir, root, n_epochs, device_data=False):
    """``train_manipulation_nip`` of ``flow`` on a fresh Dataset of
    ``data_dir``; returns (timings, training.json, run directory): the wall
    times of the call and of its validation log lines."""
    n_images, v_images, val_patches = TRAINER_SPLIT
    data = Dataset(data_dir, n_images=n_images, v_images=v_images,
                   val_rgb_patch_size=2 * RAW_PATCH, val_n_patches=val_patches)
    training = {'camera_name': 'SyntheticCam', 'use_pretrained_nip': True,
                'patch_size': RAW_PATCH, 'batch_size': TRAINER_BATCH, 'n_epochs': n_epochs,
                'validation_schedule': TRAINER_VALIDATION, 'learning_rate': TRAIN_LR,
                'lambda_nip': TRAIN_LAMBDA_NIP, 'lambda_dcn': 0.0, 'run_number': 0,
                'augment': False}
    clock, level = ValidationClock(), logger.level
    logger.addHandler(clock)
    logger.setLevel(logging.DEBUG)
    start = time.time()
    try:
        models = train_manipulation_nip(
            flow, training, data, device_data=device_data,
            directories={'root': root, 'nip_snapshots': str(base.REPO_ROOT / 'data/models/nip')})
    finally:
        logger.removeHandler(clock)
        logger.setLevel(level)
    timings = {'start': start, 'end': time.time(), 'validation_starts': clock.starts,
               'validation_ends': clock.ends}
    run_dir = os.path.dirname(models)
    with open(os.path.join(run_dir, 'training.json')) as f:
        return timings, json.load(f), run_dir


def trainer_results(label, timings, log, steps_per_epoch, busy):
    """Epoch times, rates and shares of one trainer run, from its validation
    log lines: the training between two validations over the epochs it ran
    (the first span, epoch 0, also holds the run's set-up and first calls)."""
    starts, ends = timings['validation_starts'], timings['validation_ends']
    marks = [e for e in range(TRAINER_EPOCHS) if e % TRAINER_VALIDATION == 0]
    marks.append(TRAINER_EPOCHS - 1)     # the final validation
    if not len(starts) == len(ends) == len(marks):
        raise AssertionError(f'{label}: {len(starts)} validation starts and {len(ends)} ends '
                             f'logged, {len(marks)} expected')
    spans = [starts[0] - timings['start']] + [s - e for s, e in zip(starts[1:], ends)]
    span_epochs = [1] + [b - a for a, b in zip(marks, marks[1:])]
    validations = [e - s for s, e in zip(starts, ends)]
    run_s = timings['end'] - timings['start']
    steady = sum(spans[1:])
    steps = steps_per_epoch * sum(span_epochs[1:])
    out = {'training_s': spans, 'epochs_per_span': span_epochs, 'validation_s': validations,
           'run_s': run_s, 'epoch_s_after_first': steady / sum(span_epochs[1:]),
           'steps_per_s': steps / steady, 'raw_patches_per_s': TRAINER_BATCH * steps / steady,
           'validation_share': sum(validations) / run_s,
           'validation_s_median': float(np.median(validations)),
           'epoch_losses': log['forensics']['performance']['loss']['training'],
           'nip_losses': log['nip']['performance']['loss']['training'],
           'accuracy': log['forensics']['performance']['accuracy']['validation'],
           'nip_psnr': log['nip']['performance']['psnr']['validation'],
           'device_busy_share': busy['device_busy_share'],
           'device_ms_per_epoch': busy['device_ms_per_call'],
           'profiled_wall_ms_per_epoch': busy['profiled_wall_ms_per_call']}
    print(f'[trainer] {label}: training between validations '
          f'{", ".join(f"{1e3 * t:.1f} ms / {n}" for t, n in zip(spans, span_epochs))} epochs '
          f'(the first holds the set-up); after the first {1e3 * out["epoch_s_after_first"]:.1f} '
          f'ms an epoch, {out["steps_per_s"]:.2f} steps/s, {out["raw_patches_per_s"]:.1f} raw '
          f'patches/s; validation {", ".join(f"{1e3 * t:.1f}" for t in validations)} ms, '
          f'{100 * out["validation_share"]:.1f}% of the {run_s:.2f} s run; device busy '
          f'{100 * busy["device_busy_share"]:.1f}% of an epoch\'s profiled window '
          f'({busy["device_ms_per_call"]:.2f} of {busy["profiled_wall_ms_per_call"]:.2f} ms); '
          f'losses {out["epoch_losses"]}; accuracy {out["accuracy"]}', flush=True)
    return out


def check_trainer_run(label, flow, log, run_dir, data_dir, nip_start, fan_start, device):
    """Losses finite, the FAN and the NIP moved, the run directory's files,
    and its restore reclassifying the validation set to the logged accuracy."""
    for part in ('forensics', 'nip'):
        losses = log[part]['performance']['loss']['training']
        if len(losses) != TRAINER_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f'{label}: bad {part} losses {losses}')
    for name in ('training.json', 'models/fan/fan.npz', 'models/inet/inet.npz'):
        if not os.path.isfile(os.path.join(run_dir, name)):
            raise AssertionError(f'{label}: {name} missing from {run_dir}')
    saved = {m: base.load_flax_npz(os.path.join(run_dir, 'models', m, f'{m}.npz'))
             for m in ('fan', 'inet')}
    moved = {m: max(float(np.abs(saved[m][k] - v).max()) for k, v in start.items())
             for m, start in (('fan', fan_start), ('inet', nip_start))}
    if not (moved['fan'] > 0 and moved['inet'] > 0):
        raise AssertionError(f'{label}: parameters did not move: {moved}')
    n_images, v_images, val_patches = TRAINER_SPLIT
    data = Dataset(data_dir, n_images=n_images, v_images=v_images,
                   val_rgb_patch_size=2 * RAW_PATCH, val_n_patches=val_patches)
    restored = ManipulationClassification.restore(run_dir, RAW_PATCH, device=device)
    accuracy, _ = validation.validate_fan(restored, data)
    logged = log['forensics']['performance']['accuracy']['validation'][-1]
    if accuracy != logged:
        raise AssertionError(f'{label}: the restored run classifies at {accuracy}, '
                             f'its log says {logged}')
    print(f'[trainer] {label}: largest change FAN {moved["fan"]:.3g}, INet '
          f'{moved["inet"]:.3g}; restored on the card: accuracy {accuracy} as logged',
          flush=True)
    return moved


def trainer(args, device):
    """The trainer on procedural data, host-fed and device-resident; returns
    (launch counts of each run, results)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_trainer_')
    try:
        return trainer_phase(args, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trainer_phase(args, device, tmp):
    t0 = time.perf_counter()
    height, width = TRAINER_SIZE
    data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=TRAINER_IMAGES,
                                     height=height, width=width, seed=args.seed + 1000)
    dataset_s = time.perf_counter() - t0
    print(f'[trainer] {TRAINER_IMAGES} procedural {height}x{width} pairs written in '
          f'{dataset_s:.2f} s', flush=True)
    n_images, v_images, val_patches = TRAINER_SPLIT
    steps_per_epoch = n_images // TRAINER_BATCH
    val_points = len(range(0, TRAINER_EPOCHS, TRAINER_VALIDATION)) + 1
    val_batches = v_images * val_patches // min(10, v_images * val_patches)
    expected = {'jpeg8x8': 2 * TRAINER_EPOCHS * steps_per_epoch + 2 * val_points * val_batches}
    nip_start = base.load_flax_npz(base.REPO_ROOT / 'data/models/nip/SyntheticCam'
                                   / 'INet_gbrg_5x5/inet/inet.npz')

    flow = trainer_flow(device)
    fan_start = base.flax_params(flow.fan.module.named_parameters())
    results, counts = {}, {}
    for label, device_data in (('host-fed', False), ('device-resident', True)):
        if device_data:
            flow.reinitialize()          # as the CLI's sweeps do
        torch.cuda.synchronize()
        zero_counts()
        timings, log, run_dir = trainer_run(flow, data_dir, os.path.join(tmp, label),
                                            TRAINER_EPOCHS, device_data)
        counts[label] = read_counts()
        expect_counts(f'trainer ({label})', counts[label], expected)
        moved = check_trainer_run(label, flow, log, run_dir, data_dir, nip_start, fan_start,
                                  device)
        data = Dataset(data_dir, n_images=n_images, v_images=v_images,
                       val_rgb_patch_size=2 * RAW_PATCH, val_n_patches=val_patches)
        if device_data:
            sampler = DeviceSampler(data, TRAINER_BATCH, 2 * RAW_PATCH, device=device)
            epoch = lambda: flow.training_scan(sampler, steps_per_epoch, TRAIN_LAMBDA_NIP,
                                               learning_rate=TRAIN_LR)
        else:
            prefetcher = EpochPrefetcher(data, TRAINER_BATCH, 2 * RAW_PATCH, device)
            epoch = lambda: [flow.training_step(bx, by, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)
                             for bx, by in prefetcher]
        busy = device_profile(epoch, TRAINER_PROFILE_EPOCHS)
        flow.assert_finite()
        results[label] = {**trainer_results(label, timings, log, steps_per_epoch, busy),
                          'largest_change': moved,
                          'k1_launches': counts[label]['jpeg8x8']}
        if label == 'host-fed':
            host_log = log

    # the first epoch against the port's CPU trainer on the same data and weights
    _, cpu_log, _ = trainer_run(trainer_flow('cpu'), data_dir, os.path.join(tmp, 'cpu'), 1)
    card, cpu = (log_['forensics']['performance']['loss']['training'][0]
                 for log_ in (host_log, cpu_log))
    rel = abs(card - cpu) / abs(cpu)
    if not rel <= MAX_STEP_LOSS_DIFF:
        raise AssertionError(f'trainer: first epoch loss {card} on the card, {cpu} on the CPU')
    print(f'[trainer] first epoch mean loss: card {card:.6f}, CPU {cpu:.6f}, relative '
          f'difference {rel:.3g} (bound {MAX_STEP_LOSS_DIFF:g}); K1 launches '
          f'{counts["host-fed"]["jpeg8x8"]} and {counts["device-resident"]["jpeg8x8"]} '
          f'(2 a step x {TRAINER_EPOCHS * steps_per_epoch} + 2 a validation batch x '
          f'{val_points * val_batches})', flush=True)
    return counts, {'images': TRAINER_IMAGES, 'size': list(TRAINER_SIZE),
                    'split': list(TRAINER_SPLIT), 'batch': TRAINER_BATCH, 'raw_patch': RAW_PATCH,
                    'epochs': TRAINER_EPOCHS, 'validation_schedule': TRAINER_VALIDATION,
                    'lambda_nip': TRAIN_LAMBDA_NIP, 'lr': TRAIN_LR, 'dataset_s': dataset_s,
                    'cpu_first_epoch_loss': cpu, 'card_first_epoch_loss': card,
                    'cpu_first_epoch_rel_diff': rel, **results}


def dcn_serving(args, device):
    """Answer requests of one 512x768 image each through the bitstream;
    returns (launch counts, results)."""
    dcn = codec.restore(DCN_PRESET, device=device)
    height, width = DCN_IMAGE
    images = [synthetic_rgb(args.seed + 100 + i, 1, height, width)
              for i in range(DCN_REQUESTS)]
    codec.decompress(codec.compress(images[0], dcn), dcn)     # warm-up (cuDNN autotuning)
    torch.cuda.synchronize()
    zero_counts()
    latencies, blobs, decoded = [], [], []
    for i, image in enumerate(images):
        before = read_counts()['codebook_fwd']
        t0 = time.perf_counter()
        blob = codec.compress(image, dcn)
        decoded.append(codec.decompress(blob, dcn))
        latencies.append(time.perf_counter() - t0)
        blobs.append(blob)
        launched = read_counts()['codebook_fwd'] - before
        print(f'[dcn serve] request {i}: {height}x{width} → {len(blob)} bytes '
              f'({8 * len(blob) / (height * width):.4f} bpp) → image in '
              f'{1e3 * latencies[-1]:.2f} ms, K2 launches {launched}', flush=True)
    counts = read_counts()
    expect_counts('DCN serving', counts, {'codebook_fwd': DCN_REQUESTS})
    for y in decoded:
        if y.shape != (1, height, width, 3) or not np.isfinite(y).all() \
                or y.min() < 0 or y.max() > 1:
            raise AssertionError(f'bad decoded image: shape {y.shape}')

    direct, coded = codec.compare(dcn, images[0])   # raises unless the indices round-trip
    bitstream_diff = float(np.abs(direct - coded).max())
    if not bitstream_diff <= compression.MAX_DECODE_DIFF:
        raise AssertionError(f'bitstream decode differs from the direct decode by '
                             f'{bitstream_diff}')
    cpu = codec.restore(DCN_PRESET, device='cpu')
    z_card = dcn.compress(images[0]).cpu()
    z_cpu = cpu.compress(images[0])
    latent = compression.compare_latents(z_card, z_cpu, dcn.get_codebook())
    same_latent = compression.compare_decodes(dcn.decompress(z_card).cpu(),
                                              cpu.decompress(z_card))
    # End to end: the card's bytes and decode against the CPU's own. The same
    # bytes decode on both within MAX_DECODE_DIFF, so the bitstream adds
    # nothing between them; with no latent index flipped, the two runs must
    # write the same bytes and decode within MAX_DECODE_DIFF too. A flipped
    # index moves its latent value by a codeword and the decodes near it
    # apart: then compare_latents' share is the bound.
    same_bytes = compression.compare_decodes(decoded[0], codec.decompress(blobs[0], cpu))
    cpu_blob = codec.compress(images[0], cpu)
    cpu_decoded = codec.decompress(cpu_blob, cpu)
    end_to_end = np.abs(decoded[0] - cpu_decoded)
    if latent['flipped'] == 0:
        if cpu_blob != blobs[0]:
            raise AssertionError('the card and the CPU wrote different bytes for one latent')
        compression.compare_decodes(decoded[0], cpu_decoded)
    median = float(np.median(latencies))
    results = {'requests': DCN_REQUESTS, 'image': list(DCN_IMAGE),
               'latency_ms': [1e3 * t for t in latencies], 'median_ms': 1e3 * median,
               'images_per_s': 1 / median, 'bytes': [len(b) for b in blobs],
               'bpp': [8 * len(b) / (height * width) for b in blobs],
               'bitstream_vs_direct_max_abs': bitstream_diff,
               'cpu_latent_flips': latent['flipped'], 'cpu_latent_n': latent['n'],
               'cpu_same_latent_decode_max_abs': same_latent,
               'cpu_same_bytes_decode_max_abs': same_bytes,
               'cpu_end_to_end_max_abs': float(end_to_end.max()),
               'cpu_end_to_end_mean_abs': float(end_to_end.mean())}
    print(f'[dcn serve] median request {1e3 * median:.2f} ms ({1 / median:.2f} images/s); '
          f'bitstream vs direct decode max |dy| {bitstream_diff:.3g}; against the CPU: '
          f'{latent["flipped"]}/{latent["n"]} latent indices differ, same latent decoded '
          f'max |dy| {same_latent:.3g}, same bytes decoded max |dy| {same_bytes:.3g}, '
          f'end to end max |dy| {end_to_end.max():.3g} '
          f'mean {end_to_end.mean():.3g}', flush=True)
    return counts, results


def trainable_dcn(preset, patch, device):
    """A TwitterDCN with a trainable codebook, started from ``preset``'s
    weights and the default 5-bpf codebook, its optimizer ready."""
    dcn = compression.TwitterDCN(patch_size=patch, train_codebook=True, device=device)
    state = base.convert_params(base.load_flax_npz(
        base.REPO_ROOT / 'data/models/dcn/baselines' / preset / 'twitterdcn/twitterdcn.npz'))
    state['codebook'] = torch.from_numpy(quant.default_codebook(5))
    dcn.module.load_state_dict(state, strict=True)
    dcn.init_optimizer()
    return dcn


def dcn_training(args, device):
    """Training steps of the 32c codec (fixed codebook), then of a
    trainable-codebook copy from the same weights; returns (counts of the
    fixed run, counts of the trainable run, results)."""
    batches = [synthetic_rgb(args.seed + 200 + i, DCN_BATCH, DCN_PATCH, DCN_PATCH)
               for i in range(DCN_STEPS + 1)]

    def run(dcn, label, steps, expected_backward):
        dcn.training_step(batches[0], DCN_LR)                 # warm-up (cuDNN autotuning)
        torch.cuda.synchronize()
        zero_counts()
        times, outs = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            out = dcn.training_step(batches[1 + i % DCN_STEPS], DCN_LR)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append({k: float(v) for k, v in out.items()})
            print(f'[dcn train] {label} step {i}: {1e3 * times[-1]:.2f} ms, '
                  f'loss {outs[-1]["loss"]:.4f} ssim {outs[-1]["ssim"]:.4f} '
                  f'entropy {outs[-1]["entropy"]:.4f}', flush=True)
        counts = read_counts()
        expect_counts(f'DCN training ({label})', counts,
                      {'codebook_fwd': steps, expected_backward: steps})
        if not all(np.isfinite(v) for o in outs for v in o.values()):
            raise AssertionError(f'{label}: non-finite training outputs {outs}')
        median = float(np.median(times))
        return counts, {'step_ms': [1e3 * t for t in times], 'median_ms': 1e3 * median,
                        'patches_per_s': DCN_BATCH / median, 'outputs': outs}

    fixed = codec.restore(DCN_PRESET, patch_size=DCN_PATCH, device=device)
    fixed_counts, fixed_results = run(fixed, 'fixed codebook', DCN_STEPS, 'codebook_bwd')

    trainable = trainable_dcn(DCN_PRESET, DCN_PATCH, device)
    before = trainable.get_codebook().copy()
    train_counts, train_results = run(trainable, 'trainable codebook',
                                      DCN_TRAIN_CODEBOOK_STEPS, 'codebook_bwd_train')
    moved = float(np.abs(trainable.get_codebook() - before).max())
    if not moved > 0:
        raise AssertionError('the trainable codebook did not move')
    print(f'[dcn train] fixed codebook: median step {fixed_results["median_ms"]:.2f} ms '
          f'({fixed_results["patches_per_s"]:.1f} patches/s); trainable codebook: median '
          f'{train_results["median_ms"]:.2f} ms, codebook moved by up to {moved:.3g}',
          flush=True)
    return fixed_counts, train_counts, {'batch': DCN_BATCH, 'patch': DCN_PATCH, 'lr': DCN_LR,
                                        'fixed': fixed_results, 'trainable': train_results,
                                        'codebook_moved_max_abs': moved}

# -- the other camera ISPs ---------------------------------------------------------------

def nip_development(args, device):
    """Each shipped NIP, restored with ``base.restore``, develops a batch of
    raw 64-px patches on the card: finite RGB in [0, 1], within
    ``MAX_NIP_DIFF`` of the CPU's. No kernel runs. Returns (launch counts,
    results)."""
    x = synthetic_raw(args.seed + 800, NIP_DEVELOP_BATCH, NIP_RAW_PATCH)
    results = {}
    torch.cuda.synchronize()
    zero_counts()
    for name, snapshot in NIP_SNAPSHOTS.items():
        path = str(base.REPO_ROOT / snapshot)
        model = base.restore(path, pipelines, patch_size=NIP_RAW_PATCH, device=device)
        model.process(x)                                  # warm-up (cuDNN autotuning)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            y = model.process(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        y = y.cpu().numpy()
        expected = (NIP_DEVELOP_BATCH, 2 * NIP_RAW_PATCH, 2 * NIP_RAW_PATCH, 3)
        if y.shape != expected or not np.isfinite(y).all() or y.min() < 0 or y.max() > 1:
            raise AssertionError(f'{name}: bad RGB of shape {y.shape}')
        cpu = base.restore(path, pipelines, patch_size=NIP_RAW_PATCH,
                           device='cpu').process(x).numpy()
        diff = float(np.abs(y - cpu).max())
        if not diff <= MAX_NIP_DIFF:
            raise AssertionError(f'{name}: card and CPU differ by {diff}')
        results[name] = {'model_code': model.model_code, 'parameters': model.count_parameters(),
                         'develop_ms': [1e3 * t for t in times],
                         'median_ms': 1e3 * float(np.median(times)), 'cpu_max_abs_diff': diff}
        print(f'[nip] {model.model_code} ({model.count_parameters():,} parameters): '
              f'{NIP_DEVELOP_BATCH} raw {NIP_RAW_PATCH}px patches developed in '
              f'{results[name]["median_ms"]:.2f} ms (median of 5); vs the CPU max |dy| '
              f'{diff:.3g} (bound {MAX_NIP_DIFF:g})', flush=True)
    counts = read_counts()
    expect_counts('NIP development', counts, {})
    return counts, results


def unet_classification(args, device):
    """The m_quality_full UNet run (downsampling 'none') answers requests of
    10 raw 64-px patches (50 classified images), K1 twice a request; the
    probabilities against the CPU's. Returns (launch counts, results)."""
    flow = ManipulationClassification.restore(UNET_CLASSIFY_RUN, NIP_RAW_PATCH, device=device)
    if flow.nip.class_name != 'UNet' or flow.downsampling_factor != 1:
        raise AssertionError(f'{UNET_CLASSIFY_RUN}: restored {flow.summary()}')
    batches = [synthetic_raw(args.seed + 900 + i, NIP_FLOW_BATCH, NIP_RAW_PATCH)
               for i in range(args.requests)]
    flow.run_workflow_to_decisions(batches[0])          # warm-up
    torch.cuda.synchronize()
    zero_counts()
    latencies = []
    for batch in batches:
        t0 = time.perf_counter()
        flow.run_workflow_to_decisions(batch)
        latencies.append(time.perf_counter() - t0)
    counts = read_counts()
    expect_counts('UNet classification', counts, {'jpeg8x8': 2 * args.requests})
    probs = flow.run_workflow(batches[0])[-1]
    n_rows = NIP_FLOW_BATCH * flow.n_classes
    if tuple(probs.shape) != (n_rows, flow.n_classes) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f'UNet classification: bad probabilities {tuple(probs.shape)}')
    report = compare_probabilities(
        probs.cpu(), ManipulationClassification.restore(UNET_CLASSIFY_RUN, NIP_RAW_PATCH,
                                                        device='cpu').run_workflow(batches[0])[-1])
    median = float(np.median(latencies))
    print(f'[unet classify] {flow.summary_compact()}: median request {1e3 * median:.2f} ms '
          f'({n_rows / median:.1f} classified images/s), K1 launches {counts["jpeg8x8"]} '
          f'(2 a request); vs the CPU max |dp| {report["max_abs_diff"]:.3g}, '
          f'{report["decided_rows"]}/{report["rows"]} decided rows agree', flush=True)
    return counts, {'requests': args.requests, 'batch': NIP_FLOW_BATCH,
                    'latency_ms': [1e3 * t for t in latencies], 'median_ms': 1e3 * median,
                    'images_per_s': n_rows / median, 'k1_launches': counts['jpeg8x8'],
                    'cpu_max_abs_prob_diff': report['max_abs_diff']}


def nip_flow(nip, device, remat=False, seed=0):
    """The λ-sweep run of ``nip`` ('UNet' or 'DNet', ``NIP_FLOW_RUNS``): its
    manipulations, channel and FAN widths from ``training.json``, the NIP
    from its shipped snapshot and trainable, the FAN's weights from its seed
    (the run directory holds no npz), raw patch 64."""
    with open(base.REPO_ROOT / NIP_FLOW_RUNS[nip] / 'training.json') as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    flow = ManipulationClassification(
        f'{nip}:{base.REPO_ROOT / NIP_SNAPSHOTS[nip]}',
        manipulations=[m for m in log['manipulations'] if m != 'native'],
        distribution=log['distribution'], fan_args=fan_args, trainable={'nip'},
        raw_patch_size=NIP_RAW_PATCH, nip_args=log['nip']['args'], rng_seed=seed, remat=remat,
        device=device)
    flow.nan_check = False
    return flow


def nip_share(flow, bx, reps=5):
    """Device ms a call of the NIP's forward and backward alone on the
    step's batch (``device_profile``)."""
    x = bx.permute(0, 3, 1, 2).contiguous()
    g = torch.randn(x.shape[0], 3, 2 * x.shape[2], 2 * x.shape[3], device=x.device)
    params = list(flow.nip.module.parameters())

    def fwd_bwd():
        torch.autograd.grad(flow.nip.module(x), params, g)
    fwd_bwd()
    return device_profile(fwd_bwd, reps, n_top=0)['device_ms_per_call']


def fan_input_flips(flow, cpu_flow, bx, noise=None):
    """Values of the FAN's input (the channel's output at the fixed
    strengths; awgn's NHWC ``noise`` given to both) that differ by more than
    ``FLIP_THRESHOLD`` between the card's forward and the CPU's of the same
    raw batch: flipped dJPEG coefficients."""
    fan_inputs = []
    for f in (flow, cpu_flow):
        x = f._batch(bx.to(f.device)).permute(0, 3, 1, 2)
        n = None if noise is None else noise.to(f.device).permute(0, 3, 1, 2)
        with torch.no_grad():
            fan_inputs.append(f._forward(x, *f._channel_qtables(), noise=n)[2].float().cpu())
    return int(((fan_inputs[0] - fan_inputs[1]).abs() > FLIP_THRESHOLD).sum())


def compare_flow_steps(step, step_cpu, flips, part='nip'):
    """``compare_steps`` of the card's first step against the CPU's; where
    ``flips`` values of the FAN's input differ, the FAN's leaves are held to
    ``FLIPPED_FAN_GRADIENT_DIFF`` and the other trainable ``part``'s ('nip'
    or 'dcn') and the loss parts to the float32 bounds."""
    if not flips:
        return compare_steps(step, step_cpu)
    (loss, parts, grads), (loss_cpu, parts_cpu, grads_cpu) = step, step_cpu
    report = compare_steps((loss, parts, {part: grads[part]}),
                           (loss_cpu, parts_cpu, {part: grads_cpu[part]}))
    fan = compare_steps((loss, parts, {'fan': grads['fan']}),
                        (loss_cpu, parts_cpu, {'fan': grads_cpu['fan']}),
                        max_grad_diff=FLIPPED_FAN_GRADIENT_DIFF)
    return {**report, 'fan_grad_norm_rel_diff': fan['max_grad_norm_rel_diff'],
            'fan_worst_gradient': fan['worst_gradient'],
            'grad_norms': {**report['grad_norms'], **fan['grad_norms']},
            'grad_norms_ref': {**report['grad_norms_ref'], **fan['grad_norms_ref']}}


def peak_memory_mb(fn):
    """``fn()`` and the peak device memory it allocated above what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 2 ** 20


def nip_flow_training(args, nip, device):
    """The joint step of ``nip``'s λ-sweep run at full width: the first step
    against the port's CPU step (``compare_steps``), for the UNet also its
    peak memory with and without ``remat`` (the same loss and gradients),
    then timed steps, K1 twice a step; the device time of a step and the
    share of it that the NIP's forward and backward take. Returns (launch
    counts, results)."""
    label = f'{nip.lower()} train'
    flow = nip_flow(nip, device, seed=args.seed)
    batches = training_batches(args.seed + 1100, TRAIN_STEPS + 1, NIP_FLOW_BATCH, NIP_RAW_PATCH)
    bx, by = batches[0]
    cpu_flow = nip_flow(nip, 'cpu', seed=args.seed)
    t0 = time.perf_counter()
    step_cpu = cpu_flow.loss_and_gradients(bx.cpu(), by.cpu(), NIP_FLOW_LAMBDA)
    cpu_s = time.perf_counter() - t0
    step_card, peak = peak_memory_mb(lambda: flow.loss_and_gradients(bx, by, NIP_FLOW_LAMBDA))
    flips = fan_input_flips(flow, cpu_flow, bx)
    agreement = compare_flow_steps(step_card, step_cpu, flips)
    print(f'[{label}] {flow.summary_compact()}; first step vs the CPU ({cpu_s:.1f} s there): '
          f'{flips} values of the FAN\'s input flipped; loss parts within '
          f'{agreement["max_loss_rel_diff"]:.3g} (relative), gradient norms within '
          f'{agreement["max_grad_norm_rel_diff"]:.3g} ({agreement["worst_gradient"]})'
          + (f', the FAN\'s within {agreement["fan_grad_norm_rel_diff"]:.3g} '
             f'({agreement["fan_worst_gradient"]}, bound {FLIPPED_FAN_GRADIENT_DIFF:g})'
             if flips else '') + f'; norms {agreement["grad_norms"]}', flush=True)
    results = {'batch': NIP_FLOW_BATCH, 'raw_patch': NIP_RAW_PATCH, 'lambda_nip': NIP_FLOW_LAMBDA,
               'lr': TRAIN_LR, 'nip_parameters': flow.nip.count_parameters(),
               'cpu_first_step': agreement, 'cpu_fan_input_flips': flips, 'cpu_step_s': cpu_s,
               'peak_mb': peak}
    del cpu_flow
    remat_counts = {name: 0 for name in COUNTERS}
    if nip == 'UNet':
        remat_flow = nip_flow(nip, device, remat=True, seed=args.seed)
        zero_counts()
        step_remat, peak_remat = peak_memory_mb(
            lambda: remat_flow.loss_and_gradients(bx, by, NIP_FLOW_LAMBDA))
        remat_counts = read_counts()
        expect_counts(f'{label} (remat)', remat_counts, {'jpeg8x8': 3})
        remat_agreement = compare_steps(step_remat, step_card)
        print(f'[{label}] remat: the step\'s peak memory {peak_remat:.1f} MiB against '
              f'{peak:.1f} MiB without ({100 * (1 - peak_remat / peak):.1f}% less); loss parts within '
              f'{remat_agreement["max_loss_rel_diff"]:.3g}, gradient norms within '
              f'{remat_agreement["max_grad_norm_rel_diff"]:.3g} of the step without; K1 '
              f'launches {remat_counts["jpeg8x8"]}', flush=True)
        results.update(peak_mb_remat=peak_remat, remat_vs_plain=remat_agreement,
                       remat_k1_launches=remat_counts['jpeg8x8'])
        del remat_flow

    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in flow._collect_params().items()}
    flow.training_step(bx, by, NIP_FLOW_LAMBDA, learning_rate=TRAIN_LR)    # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = {False: [], True: []}, []
    for i in range(TRAIN_STEPS + TRAIN_AUGMENTED_STEPS):
        augment = i >= TRAIN_STEPS
        t0 = time.perf_counter()
        loss, parts = flow.training_step(*batches[1 + i % TRAIN_STEPS], NIP_FLOW_LAMBDA,
                                         augment=augment, learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        times[augment].append(time.perf_counter() - t0)
        losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
    counts = read_counts()
    expect_counts(label, counts, {'jpeg8x8': 2 * (TRAIN_STEPS + TRAIN_AUGMENTED_STEPS)})
    flow.assert_finite()
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f'{label}: non-finite losses {losses}')
    moved = {part: max(float((p.detach() - before[part][k]).abs().max())
                       for k, p in leaves.items())
             for part, leaves in flow._collect_params().items()}
    if not (moved['nip'] > 0 and moved['fan'] > 0):
        raise AssertionError(f'{label}: parameters did not move: {moved}')
    profile_ = device_profile(lambda: flow.training_step(bx, by, NIP_FLOW_LAMBDA,
                                                         learning_rate=TRAIN_LR), 5)
    flow.assert_finite()
    nip_ms = nip_share(flow, bx)
    median = float(np.median(times[False]))
    device_ms = profile_['device_ms_per_call']
    print(f'[{label}] median step {1e3 * median:.2f} ms ({1 / median:.2f} steps/s); augmented '
          f'{", ".join(f"{1e3 * t:.2f}" for t in times[True])} ms; device {device_ms:.2f} ms a '
          f'step, busy {100 * profile_["device_busy_share"]:.1f}%, '
          f'{profile_["device_ops_per_call"]:.0f} device ops; the {nip} forward and backward '
          f'{nip_ms:.2f} ms ({100 * nip_ms / device_ms:.1f}% of the step\'s device time); K1 '
          f'launches {counts["jpeg8x8"]}', flush=True)
    results.update(step_ms=[1e3 * t for t in times[False]],
                   augmented_step_ms=[1e3 * t for t in times[True]], median_ms=1e3 * median,
                   steps_per_s=1 / median, device_ms_per_step=device_ms,
                   device_busy_share=profile_['device_busy_share'],
                   device_ops_per_step=profile_['device_ops_per_call'],
                   nip_fwd_bwd_device_ms=nip_ms, nip_device_share=nip_ms / device_ms,
                   k1_launches=counts['jpeg8x8'], losses=losses, largest_change=moved)
    total = {k: counts[k] + remat_counts[k] for k in counts}
    return total, results


def nip_trainer(args, device):
    """``train_nip_model`` of UNet_5 from its snapshot on procedural pairs
    at the CLI's batch 20 and raw patch 64, host-fed then device-resident:
    epoch and validation times from its log lines, its ``progress.json`` and
    npz read back, the first epoch's loss against the CPU trainer's. No
    kernel runs. Returns (launch counts, results)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_nip_trainer_')
    try:
        return nip_trainer_phase(args, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def nip_trainer_run(data_dir, root, device, n_epochs, device_data=False):
    n_images, v_images, val_patches = NIP_TRAINER_SPLIT
    data = Dataset(data_dir, n_images=n_images, v_images=v_images,
                   val_rgb_patch_size=2 * NIP_RAW_PATCH, val_n_patches=val_patches)
    model = base.restore(str(base.REPO_ROOT / NIP_SNAPSHOTS['UNet']), pipelines,
                         patch_size=NIP_RAW_PATCH, device=device)
    clock, level = ValidationClock(), logger.level
    logger.addHandler(clock)
    logger.setLevel(logging.DEBUG)
    start = time.time()
    try:
        out = train_nip_model(model, 'SyntheticCam', n_epochs=n_epochs,
                              validation_schedule=NIP_TRAINER_VALIDATION,
                              validation_loss_threshold=None, patch_size=NIP_RAW_PATCH,
                              batch_size=NIP_TRAINER_BATCH, data=data, out_directory_root=root,
                              device_data=device_data)
    finally:
        logger.removeHandler(clock)
        logger.setLevel(level)
    return out, {'start': start, 'end': time.time(), 'validation_starts': clock.starts,
                 'validation_ends': clock.ends}


def nip_trainer_phase(args, device, tmp):
    height, width = TRAINER_SIZE
    data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=TRAINER_IMAGES,
                                     height=height, width=width, seed=args.seed + 1200)
    steps_per_epoch = NIP_TRAINER_SPLIT[0] // NIP_TRAINER_BATCH
    results, counts = {}, {}
    for label, device_data in (('host-fed', False), ('device-resident', True)):
        torch.cuda.synchronize()
        zero_counts()
        out, timings = nip_trainer_run(data_dir, os.path.join(tmp, label), device,
                                       NIP_TRAINER_EPOCHS, device_data)
        counts[label] = read_counts()
        expect_counts(f'NIP trainer ({label})', counts[label], {})
        progress = json.load(open(os.path.join(out, 'progress.json')))
        losses = progress['performance']['loss']['training']
        if len(losses) != NIP_TRAINER_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f'NIP trainer ({label}): bad losses {losses}')
        if progress['model'] != 'UNet' or progress['summary']['Epoch'] != NIP_TRAINER_EPOCHS - 1:
            raise AssertionError(f'NIP trainer ({label}): progress.json {progress["summary"]}')
        written = base.load_flax_npz(os.path.join(out, 'unet.npz'))
        shipped = base.load_flax_npz(base.REPO_ROOT / NIP_SNAPSHOTS['UNet'] / 'unet' / 'unet.npz')
        moved = max(float(np.abs(written[k] - v).max()) for k, v in shipped.items())
        if sorted(written) != sorted(shipped) or not moved > 0:
            raise AssertionError(f'NIP trainer ({label}): unet.npz not written as trained')
        reread = base.restore(out, pipelines, patch_size=NIP_RAW_PATCH, device=device)
        starts, ends = timings['validation_starts'], timings['validation_ends']
        spans = [starts[0] - timings['start']] + [s - e for s, e in zip(starts[1:], ends)]
        validations = [e - s for s, e in zip(starts, ends)]
        marks = list(range(0, NIP_TRAINER_EPOCHS, NIP_TRAINER_VALIDATION))
        span_epochs = [1] + [b - a for a, b in zip(marks, marks[1:])]
        steady = sum(spans[1:]) / sum(span_epochs[1:])
        results[label] = {'epoch_losses': losses,
                          'psnr': progress['performance']['psnr']['validation'],
                          'training_s': spans, 'epochs_per_span': span_epochs,
                          'epoch_s_after_first': steady,
                          'steps_per_s': steps_per_epoch / steady,
                          'validation_s': validations, 'run_s': timings['end'] - timings['start'],
                          'largest_change': moved, 'reread': reread.model_code}
        print(f'[nip trainer] {label}: {steps_per_epoch} steps an epoch at batch '
              f'{NIP_TRAINER_BATCH}; training between validations '
              f'{", ".join(f"{1e3 * t:.1f} ms / {n}" for t, n in zip(spans, span_epochs))} epochs '
              f'(the first holds the set-up); after the first {1e3 * steady:.1f} ms an epoch '
              f'({steps_per_epoch / steady:.1f} steps/s); validation '
              f'{", ".join(f"{1e3 * t:.1f}" for t in validations)} ms; losses {losses}; PSNR '
              f'{results[label]["psnr"]}; progress.json and unet.npz read back', flush=True)
    cpu_out, _ = nip_trainer_run(data_dir, os.path.join(tmp, 'cpu'), 'cpu', 1)
    cpu = json.load(open(os.path.join(cpu_out, 'progress.json')))['performance']['loss'][
        'training'][0]
    card = results['host-fed']['epoch_losses'][0]
    rel = abs(card - cpu) / abs(cpu)
    if not rel <= MAX_NIP_EPOCH_LOSS_DIFF:
        raise AssertionError(f'NIP trainer: first epoch loss {card} on the card, {cpu} on the CPU')
    print(f'[nip trainer] first epoch mean loss: card {card:.6f}, CPU {cpu:.6f}, relative '
          f'difference {rel:.3g} (bound {MAX_NIP_EPOCH_LOSS_DIFF:g})', flush=True)
    return counts, {'split': list(NIP_TRAINER_SPLIT), 'batch': NIP_TRAINER_BATCH,
                    'raw_patch': NIP_RAW_PATCH, 'epochs': NIP_TRAINER_EPOCHS,
                    'cpu_first_epoch_loss': cpu, 'card_first_epoch_loss': card,
                    'cpu_first_epoch_rel_diff': rel, **results}


# -- the DCN channel in the joint flow, and the DCN trainer -----------------------------

def dcn_flow(device, trainable=True, seed=0):
    """The m_quality_dcn lc-0.1000 run's flow (``DCN_FLOW_RUN``): ONet, its
    manipulations, the 32c channel (trainable, or frozen as in the run's
    ``fixed-codec`` sibling) and its FAN's widths from the seed, at raw
    patch 64 on ``device``."""
    with open(base.REPO_ROOT / DCN_FLOW_RUN / 'training.json') as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    flow = ManipulationClassification(
        log['nip']['model'], manipulations=[m for m in log['manipulations'] if m != 'native'],
        distribution=log['distribution'], fan_args=fan_args,
        trainable={'dcn'} if trainable else set(), raw_patch_size=DCN_FLOW_RAW_PATCH,
        rng_seed=seed, device=device)
    flow.nan_check = False
    return flow


def dcn_flow_phase(args, device):
    """The DCN channel's joint flow at the lc-0.1000 run's shape: requests
    (K1 and K2 once each) against the CPU's probabilities, the first step
    against the port's CPU step, the step's peak memory, timed steps (K1, K2
    and K3 once each), the frozen-codec sibling's steps (K3 never), the
    codec's and the FAN's leaves moving. Returns (launch counts, results)."""
    flow, cpu_flow = dcn_flow(device, seed=args.seed), dcn_flow('cpu', seed=args.seed)
    if flow.codec.count_parameters() != 2_533_293 or flow.fan.count_parameters() != 1_145_382:
        raise AssertionError(f'{DCN_FLOW_RUN}: built {flow.summary()}')
    side = 2 * DCN_FLOW_RAW_PATCH
    batches = [torch.from_numpy(synthetic_rgb(args.seed + 1300 + i, DCN_FLOW_BATCH, side,
                                              side)).to(device)
               for i in range(TRAIN_STEPS + 1)]
    bx = batches[0]
    per_request = {'jpeg8x8': 1, 'codebook_fwd': 1, **fan_passes(1)}
    per_step = {'jpeg8x8': 1, 'codebook_fwd': 1, 'codebook_bwd': 1, **fan_passes(1, 1)}

    # requests, at the flow's initial weights, against the CPU's forward
    flow.run_workflow_to_decisions(bx)                    # warm-up (cuDNN autotuning)
    torch.cuda.synchronize()
    zero_counts()
    latencies = []
    for i in range(args.requests):
        t0 = time.perf_counter()
        flow.run_workflow_to_decisions(batches[1 + i])
        latencies.append(time.perf_counter() - t0)
    request_counts = read_counts()
    expect_counts('DCN flow requests', request_counts,
                  {k: v * args.requests for k, v in per_request.items()})
    out = flow.run_workflow(bx)
    n_rows = DCN_FLOW_BATCH * flow.n_classes
    if tuple(out[-1].shape) != (n_rows, flow.n_classes) or not all(
            bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError(f'DCN flow: bad outputs {[tuple(t.shape) for t in out]}')
    report = compare_probabilities(out[-1].cpu(), cpu_flow.run_workflow(bx.cpu())[-1])
    request_ms = 1e3 * float(np.median(latencies))
    print(f'[dcn flow] {flow.summary_compact()}: median request {request_ms:.2f} ms '
          f'({n_rows / request_ms * 1e3:.1f} classified images/s); launches '
          f'{request_counts}; vs the CPU max |dp| {report["max_abs_diff"]:.3g}, '
          f'{report["decided_rows"]}/{report["rows"]} decided rows agree', flush=True)

    # the first step against the port's CPU step; its peak memory
    t0 = time.perf_counter()
    step_cpu = cpu_flow.loss_and_gradients(bx.cpu(), None, 0.0, DCN_FLOW_LAMBDA)
    cpu_s = time.perf_counter() - t0
    step_card, peak = peak_memory_mb(
        lambda: flow.loss_and_gradients(bx, None, 0.0, DCN_FLOW_LAMBDA))
    flips = fan_input_flips(flow, cpu_flow, bx)
    agreement = compare_flow_steps(step_card, step_cpu, flips, part='dcn')
    z_card = flow.codec.compress(bx).cpu()
    latent = compression.compare_latents(z_card, cpu_flow.codec.compress(bx.cpu()),
                                         flow.codec.get_codebook())
    print(f'[dcn flow] first step vs the CPU ({cpu_s:.1f} s there): {flips} values of the '
          f'FAN\'s input flipped, {latent["flipped"]}/{latent["n"]} latent indices of the '
          f'native class differ; loss parts within {agreement["max_loss_rel_diff"]:.3g} '
          f'(relative), gradient norms within {agreement["max_grad_norm_rel_diff"]:.3g} '
          f'({agreement["worst_gradient"]})'
          + (f', the FAN\'s within {agreement["fan_grad_norm_rel_diff"]:.3g}' if flips else '')
          + f'; peak memory of the step {peak:.1f} MiB', flush=True)
    del cpu_flow

    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in flow._collect_params().items()}
    flow.training_step(bx, None, 0.0, DCN_FLOW_LAMBDA, learning_rate=TRAIN_LR)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = {False: [], True: []}, []
    for i in range(TRAIN_STEPS + TRAIN_AUGMENTED_STEPS):
        augment = i >= TRAIN_STEPS
        t0 = time.perf_counter()
        loss, parts = flow.training_step(batches[1 + i % TRAIN_STEPS], None, 0.0,
                                         DCN_FLOW_LAMBDA, augment=augment,
                                         learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        times[augment].append(time.perf_counter() - t0)
        losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
    counts = read_counts()
    n_steps = TRAIN_STEPS + TRAIN_AUGMENTED_STEPS
    expect_counts('DCN flow training', counts, {k: v * n_steps for k, v in per_step.items()})
    flow.assert_finite()
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f'DCN flow: non-finite losses {losses}')
    moved = {part: max(float((p.detach() - before[part][k]).abs().max())
                       for k, p in flow._collect_params()[part].items())
             for part in ('dcn', 'fan')}
    if not (moved['dcn'] > 0 and moved['fan'] > 0):
        raise AssertionError(f'DCN flow: parameters did not move: {moved}')
    profile_ = device_profile(lambda: flow.training_step(bx, None, 0.0, DCN_FLOW_LAMBDA,
                                                         learning_rate=TRAIN_LR), 5,
                              match=HAND_KERNELS)
    flow.assert_finite()
    median = float(np.median(times[False]))
    print(f'[dcn flow] median step {1e3 * median:.2f} ms ({1 / median:.2f} steps/s); augmented '
          f'{", ".join(f"{1e3 * t:.2f}" for t in times[True])} ms; device '
          f'{profile_["device_ms_per_call"]:.2f} ms a step, busy '
          f'{100 * profile_["device_busy_share"]:.1f}%, {profile_["device_ops_per_call"]:.0f} '
          f'device ops, hand kernels {profile_["matched_kernels_ms_per_call"]:.4f} ms; '
          f'launches {counts}; largest change {moved}', flush=True)
    print_profile('dcn flow', profile_)

    # the run's fixed-codec sibling: the codec frozen, no backward through it
    frozen = dcn_flow(device, trainable=False, seed=args.seed)
    frozen.training_step(bx, None, 0.0, DCN_FLOW_LAMBDA, learning_rate=TRAIN_LR)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    frozen_times = []
    for i in range(DCN_FLOW_FROZEN_STEPS):
        t0 = time.perf_counter()
        frozen.training_step(batches[1 + i % TRAIN_STEPS], None, 0.0, DCN_FLOW_LAMBDA,
                             learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        frozen_times.append(time.perf_counter() - t0)
    frozen_counts = read_counts()
    expect_counts('DCN flow, frozen codec', frozen_counts,
                  {'jpeg8x8': DCN_FLOW_FROZEN_STEPS, 'codebook_fwd': DCN_FLOW_FROZEN_STEPS,
                   **fan_passes(DCN_FLOW_FROZEN_STEPS, DCN_FLOW_FROZEN_STEPS)})
    frozen.assert_finite()
    print(f'[dcn flow] frozen codec: steps {", ".join(f"{1e3 * t:.2f}" for t in frozen_times)} '
          f'ms; launches {frozen_counts}', flush=True)
    total = {k: request_counts[k] + counts[k] + frozen_counts[k] for k in counts}
    return total, {
        'run': DCN_FLOW_RUN, 'batch': DCN_FLOW_BATCH, 'raw_patch': DCN_FLOW_RAW_PATCH,
        'lambda_dcn': DCN_FLOW_LAMBDA, 'lr': TRAIN_LR, 'latent_values': DCN_FLOW_LATENT,
        'request_ms': [1e3 * t for t in latencies], 'median_request_ms': request_ms,
        'cpu_max_abs_prob_diff': report['max_abs_diff'], 'request_launches': request_counts,
        'cpu_first_step': agreement, 'cpu_fan_input_flips': flips,
        'cpu_native_latent_flips': latent['flipped'], 'cpu_step_s': cpu_s,
        'peak_mb': peak, 'step_ms': [1e3 * t for t in times[False]],
        'augmented_step_ms': [1e3 * t for t in times[True]], 'median_ms': 1e3 * median,
        'steps_per_s': 1 / median, 'device_ms_per_step': profile_['device_ms_per_call'],
        'device_busy_share': profile_['device_busy_share'],
        'device_ops_per_step': profile_['device_ops_per_call'],
        'hand_kernels_ms_per_step': profile_['matched_kernels_ms_per_call'],
        'step_launches': counts, 'losses': losses, 'largest_change': moved,
        'frozen_step_ms': [1e3 * t for t in frozen_times], 'frozen_launches': frozen_counts}


def dcn_trainer(args, device):
    """``train_dcn`` at train_dcn.py's shape on procedural RGB images,
    host-fed then device-resident: epoch and validation times from its log
    lines, the run directory's ``progress.json`` schema, the snapshot
    restored to its logged validation SSIM, the first epoch's loss against
    the port's CPU trainer. Returns (launch counts, results)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_dcn_trainer_')
    try:
        return dcn_trainer_phase(args, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dcn_trainer_data(data_dir):
    n_images, v_images, val_patches = DCN_TRAINER_SPLIT
    return Dataset(data_dir, load='y', n_images=n_images, v_images=v_images,
                   val_rgb_patch_size=DCN_TRAINER_PATCH, val_n_patches=val_patches)


def dcn_trainer_run(data_dir, root, device, n_epochs, seed, device_data=False):
    """``train_dcn`` of a TwitterDCN 32c from its seed; returns (the output
    directory, the wall times of the call and of its validation log lines)."""
    dcn = compression.TwitterDCN(patch_size=DCN_TRAINER_PATCH, n_features=32, device=device)
    clock, level = ValidationClock(), logger.level
    logger.addHandler(clock)
    logger.setLevel(logging.DEBUG)
    start = time.time()
    try:
        out = codec_training.train_dcn(
            dcn, {'n_epochs': n_epochs, 'batch_size': DCN_TRAINER_BATCH,
                  'patch_size': DCN_TRAINER_PATCH, 'learning_rate': DCN_LR,
                  'validation_schedule': DCN_TRAINER_VALIDATION},
            dcn_trainer_data(data_dir), directory=root, rng=np.random.default_rng(seed),
            device_data=device_data)
    finally:
        logger.removeHandler(clock)
        logger.setLevel(level)
    return out, {'start': start, 'end': time.time(), 'validation_starts': clock.starts,
                 'validation_ends': clock.ends}


def dcn_validation_ssim(dcn, data):
    """The trainer's validation SSIM of ``dcn`` (compress → decompress of
    each validation batch, the mean of the batches' mean SSIM)."""
    ssims = []
    for batch_id in range(data.count_validation // DCN_TRAINER_BATCH):
        x = data.next_validation_batch(batch_id, DCN_TRAINER_BATCH)
        y = dcn.decompress(dcn.compress(x)).cpu().numpy()
        ssims.append(metrics.batch(x, y, metrics.ssim))
    return float(np.mean(ssims))


def dcn_trainer_phase(args, device, tmp):
    height, width = DCN_TRAINER_SIZE
    t0 = time.perf_counter()
    data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=DCN_TRAINER_IMAGES,
                                     height=height, width=width, seed=args.seed + 1400,
                                     rgb_only=True)
    dataset_s = time.perf_counter() - t0
    n_images, v_images, val_patches = DCN_TRAINER_SPLIT
    steps_per_epoch = n_images // DCN_TRAINER_BATCH
    val_batches = v_images * val_patches // DCN_TRAINER_BATCH
    val_points = len(range(0, DCN_TRAINER_EPOCHS, DCN_TRAINER_VALIDATION))
    steps = DCN_TRAINER_EPOCHS * steps_per_epoch
    expected = {'codebook_fwd': steps + val_points * val_batches, 'codebook_bwd': steps}
    results, counts = {}, {}
    for label, device_data in (('host-fed', False), ('device-resident', True)):
        torch.cuda.synchronize()
        zero_counts()
        out, timings = dcn_trainer_run(data_dir, os.path.join(tmp, label), device,
                                       DCN_TRAINER_EPOCHS, args.seed, device_data)
        counts[label] = read_counts()
        expect_counts(f'DCN trainer ({label})', counts[label], expected)
        with open(os.path.join(out, 'progress.json')) as f:
            progress = json.load(f)
        schema = {'training_spec', 'data', 'codec'}, {'model', 'init', 'args', 'codebook',
                                                      'performance'}
        if set(progress) != schema[0] or set(progress['codec']) != schema[1]:
            raise AssertionError(f'DCN trainer ({label}): progress.json keys {list(progress)}')
        perf = progress['codec']['performance']
        losses, ssims = perf['loss']['training'], perf['ssim']['validation']
        if len(losses) != DCN_TRAINER_EPOCHS or len(ssims) != val_points or not np.isfinite(
                losses + ssims + perf['entropy']['training']).all():
            raise AssertionError(f'DCN trainer ({label}): bad history {perf}')
        restored = codec.restore(out, patch_size=DCN_TRAINER_PATCH, device=device)
        ssim = dcn_validation_ssim(restored, dcn_trainer_data(data_dir))
        if not abs(ssim - ssims[-1]) <= MAX_DCN_SSIM_DIFF:
            raise AssertionError(f'DCN trainer ({label}): the restored codec validates at '
                                 f'SSIM {ssim}, its log says {ssims[-1]}')
        starts, ends = timings['validation_starts'], timings['validation_ends']
        if not len(starts) == len(ends) == val_points:
            raise AssertionError(f'DCN trainer ({label}): {len(starts)} validation starts, '
                                 f'{len(ends)} ends logged')
        spans = [starts[0] - timings['start']] + [s - e for s, e in zip(starts[1:], ends)]
        validations = [e - s for s, e in zip(starts, ends)]
        steady = sum(spans[1:]) / (DCN_TRAINER_VALIDATION * (val_points - 1))
        results[label] = {'epoch_losses': losses, 'validation_ssim': ssims,
                          'entropy': perf['entropy']['training'], 'training_s': spans,
                          'epoch_s_after_first': steady,
                          'steps_per_s': steps_per_epoch / steady,
                          'patches_per_s': steps_per_epoch * DCN_TRAINER_BATCH / steady,
                          'validation_s': validations,
                          'run_s': timings['end'] - timings['start'],
                          'restored_validation_ssim': ssim, 'launches': counts[label]}
        print(f'[dcn trainer] {label}: {steps_per_epoch} steps an epoch at batch '
              f'{DCN_TRAINER_BATCH}, patch {DCN_TRAINER_PATCH}; training between validations '
              f'{", ".join(f"{1e3 * t:.1f}" for t in spans)} ms (the first holds epoch 0 and '
              f'the set-up, the others {DCN_TRAINER_VALIDATION} epochs); after the first '
              f'{1e3 * steady:.1f} ms an epoch ({steps_per_epoch / steady:.2f} steps/s); '
              f'validation {", ".join(f"{1e3 * t:.1f}" for t in validations)} ms; losses '
              f'{losses}; validation SSIM {ssims}, restored {ssim:.6f}; launches '
              f'{counts[label]}', flush=True)
    cpu_out, _ = dcn_trainer_run(data_dir, os.path.join(tmp, 'cpu'), 'cpu', 1, args.seed)
    with open(os.path.join(cpu_out, 'progress.json')) as f:
        cpu = json.load(f)['codec']['performance']['loss']['training'][0]
    card = results['host-fed']['epoch_losses'][0]
    rel = abs(card - cpu) / abs(cpu)
    if not rel <= MAX_STEP_LOSS_DIFF:
        raise AssertionError(f'DCN trainer: first epoch loss {card} on the card, {cpu} on '
                             f'the CPU')
    print(f'[dcn trainer] {DCN_TRAINER_IMAGES} procedural {height}x{width} images written in '
          f'{dataset_s:.2f} s; first epoch mean loss: card {card:.6f}, CPU {cpu:.6f}, '
          f'relative difference {rel:.3g} (bound {MAX_STEP_LOSS_DIFF:g})', flush=True)
    total = {k: sum(c[k] for c in counts.values()) for k in COUNTERS}
    return total, {'split': list(DCN_TRAINER_SPLIT), 'size': list(DCN_TRAINER_SIZE),
                   'batch': DCN_TRAINER_BATCH, 'patch': DCN_TRAINER_PATCH,
                   'epochs': DCN_TRAINER_EPOCHS, 'validation_schedule': DCN_TRAINER_VALIDATION,
                   'dataset_s': dataset_s, 'cpu_first_epoch_loss': cpu,
                   'card_first_epoch_loss': card, 'cpu_first_epoch_rel_diff': rel, **results}


def manip7_flow(device, seed=0):
    """The m_quality run's flow with all seven manipulations (``MANIP7``):
    its INet from the run's snapshot, trainable; its distribution and FAN
    widths from its log; the 8-class FAN's weights from its seed."""
    with open(base.REPO_ROOT / RUN_DIR / 'training.json') as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    flow = ManipulationClassification(
        f'INet:{base.REPO_ROOT / RUN_DIR / "models" / "inet"}', manipulations=MANIP7,
        distribution=log['distribution'], fan_args=fan_args, trainable={'nip'},
        raw_patch_size=RAW_PATCH, nip_args=log['nip']['args'], rng_seed=seed, device=device)
    flow.nan_check = False
    return flow


def awgn_noise(seed, n, side):
    """awgn's standard normal noise for n developed side-px RGB patches
    (NHWC), made on the host: the same on the card and the CPU."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, side, side, 3), dtype=np.float32))


def median_switch_check(y, candidates):
    """``median_switch`` on the card against ``median(y, k)`` for every index
    a step draws, over the flow's ``candidates``: value and gradient equal
    bit for bit, and the device ms of each forward and backward."""
    g = torch.randn(y.shape, generator=torch.Generator(device=y.device).manual_seed(3),
                    device=y.device)

    def value_and_grad(fn):
        v = y.detach().clone().requires_grad_(True)
        out = fn(v)
        out.backward(g)
        return out.detach(), v.grad

    report = {}
    for index in range(N_STRENGTH_CANDIDATES):
        k = candidates[min(index, len(candidates) - 1)]
        i = torch.tensor(index, device=y.device)
        switched = value_and_grad(lambda v: manips.median_switch(v, i, candidates))
        direct = value_and_grad(lambda v: manips.median(v, k))
        diff = max(float((a - b).abs().max()) for a, b in zip(switched, direct))
        if not all(torch.equal(a, b) for a, b in zip(switched, direct)):
            raise AssertionError(f'median_switch index {index} (k={k}) differs from median: '
                                 f'max |d| {diff}')
        report[f'index {index} (k={k}) max_abs_diff'] = diff
    i = torch.tensor(len(candidates) - 1, device=y.device)
    for label, fn in ((f'median k={candidates[0]}', lambda v: manips.median(v, candidates[0])),
                      (f'median_switch k={candidates[-1]}',
                       lambda v: manips.median_switch(v, i, candidates))):
        report[f'{label} fwd+bwd device ms'] = device_profile(
            lambda: value_and_grad(fn), 3, n_top=0)['device_ms_per_call']
    return report


def pooled_check(flow, y, noise, reps, flush):
    """``_manipulate(pool=True)`` (per-branch pooling, the folded gaussian and
    resample kernels) against ``avg_pool(_manipulate(...))`` on the card: the
    same values within the JAX test's tolerance; both timed in turns (fused,
    two-op, two-op, fused): wall ms a call as a caller sees it (``time_ms``,
    host time included) and device ms a call (``device_profile``)."""
    def fused():
        return flow._manipulate(y, noise=noise, pool=True)

    def two_op():
        return ops.avg_pool(flow._manipulate(y, noise=noise), 2)

    with torch.no_grad():
        a, b = fused(), two_op()
        diff = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=POOLED_ATOL, rtol=POOLED_RTOL):
            raise AssertionError(f'the fused pooled expansion differs from the two-op form: '
                                 f'max |d| {diff}')
        times = {'fused': [], 'two_op': []}
        for label in ('fused', 'two_op', 'two_op', 'fused'):
            fn = fused if label == 'fused' else two_op
            times[label].append((time_ms(fn, reps, flush, device_only=False),
                                 device_profile(fn, reps, n_top=0)['device_ms_per_call']))
    return {'max_abs_diff': diff, **{f'{label}_wall_ms': [t[0] for t in v]
                                     for label, v in times.items()},
            **{f'{label}_device_ms': [t[1] for t in v] for label, v in times.items()}}


def manip7_phase(args, device, flush):
    """``[manip7 classify]``: requests of raw 128-px patches through the
    8-class flow (K1 twice a request), request 0 against the CPU with the
    same awgn noise; ``[manip7 train]``: its first step against the CPU's
    (``compare_flow_steps``, the FAN input's flips counted), ``median_switch``
    against ``median`` and the fused pooled expansion against the two-op form
    on the card, the peak memory of a step at the fixed strengths and with
    median's largest window, then 10 + 3 augmented timed steps (K1 twice a
    step) and the device profile of each kind of step. Returns ((classify
    counts, train counts), results)."""
    flow, cpu = manip7_flow(device, args.seed), manip7_flow('cpu', args.seed)
    side, n_rows = 2 * RAW_PATCH, args.batch * flow.n_classes
    requests = [synthetic_raw(args.seed + 1500 + i, args.batch, RAW_PATCH)
                for i in range(args.requests)]
    flow.run_workflow_to_decisions(requests[0])             # warm-up
    torch.cuda.synchronize()
    zero_counts()
    latencies = []
    for batch in requests:
        t0 = time.perf_counter()
        flow.run_workflow_to_decisions(batch)
        latencies.append(time.perf_counter() - t0)
    classify_counts = read_counts()
    expect_counts('[manip7 classify]', classify_counts, {'jpeg8x8': 2 * args.requests})
    noise = awgn_noise(args.seed + 1600, args.batch, side)
    x = torch.from_numpy(requests[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        probs = flow._forward(x.to(device), *flow._channel_qtables(),
                              noise=noise.to(device).permute(0, 3, 1, 2))[-1]
        probs_cpu = cpu._forward(x, *cpu._channel_qtables(), noise=noise.permute(0, 3, 1, 2))[-1]
    if tuple(probs.shape) != (n_rows, 8) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f'[manip7 classify] bad probabilities {tuple(probs.shape)}')
    report = compare_probabilities(probs.cpu(), probs_cpu)
    request_ms = 1e3 * float(np.median(latencies))
    print(f'[manip7 classify] {flow.summary_compact()}: median request {request_ms:.2f} ms '
          f'({n_rows / request_ms * 1e3:.1f} classified images/s); request 0 vs the CPU: max '
          f'|dp| {report["max_abs_diff"]:.3g}, {report["decided_rows"]}/{report["rows"]} decided '
          f'rows agree; K1 launches {classify_counts["jpeg8x8"]}', flush=True)
    results = {'classify': {'requests': args.requests, 'batch': args.batch,
                            'latency_ms': [1e3 * t for t in latencies],
                            'median_ms': request_ms, 'images_per_s': n_rows / request_ms * 1e3,
                            'cpu_max_abs_prob_diff': report['max_abs_diff'],
                            'k1_launches': classify_counts['jpeg8x8']}}

    batches = training_batches(args.seed + 1700, TRAIN_STEPS + 1, args.batch)
    bx, by = batches[0]
    t0 = time.perf_counter()
    step_cpu = cpu.loss_and_gradients(bx.cpu(), by.cpu(), TRAIN_LAMBDA_NIP, noise=noise)
    cpu_s = time.perf_counter() - t0
    step_card, peak = peak_memory_mb(
        lambda: flow.loss_and_gradients(bx, by, TRAIN_LAMBDA_NIP, noise=noise.to(device)))
    flips = fan_input_flips(flow, cpu, bx, noise)
    agreement = compare_flow_steps(step_card, step_cpu, flips)
    del cpu, step_cpu
    print(f'[manip7 train] first step vs the CPU ({cpu_s:.1f} s there): {flips} values of the '
          f'FAN\'s input flipped; loss parts within {agreement["max_loss_rel_diff"]:.3g} '
          f'(relative), gradient norms within {agreement["max_grad_norm_rel_diff"]:.3g} '
          f'({agreement["worst_gradient"]}); norms {agreement["grad_norms"]}', flush=True)

    with torch.no_grad():
        batch_Y = flow.nip.module(flow._batch(bx).permute(0, 3, 1, 2))
    switch = median_switch_check(batch_Y, flow._strength_candidates['median'])
    print(f'[manip7 train] median_switch equals median on the card for every index: {switch}',
          flush=True)
    pooled = pooled_check(flow, batch_Y, noise.to(device).permute(0, 3, 1, 2), args.reps, flush)
    print(f'[manip7 train] _manipulate(pool=True) vs avg_pool(_manipulate()): max |d| '
          f'{pooled["max_abs_diff"]:.3g}; wall ms fused {pooled["fused_wall_ms"]}, two-op '
          f'{pooled["two_op_wall_ms"]}; device ms fused {pooled["fused_device_ms"]}, two-op '
          f'{pooled["two_op_device_ms"]}', flush=True)
    # the largest median window: every strength at its range's middle, the
    # median's index at the last candidate
    n_ops = len(MANIP7)
    scalars = (flow._strength_lo + flow._strength_hi) / 2
    indices = torch.full((n_ops,), N_STRENGTH_CANDIDATES - 1, dtype=torch.int64, device=device)
    _, peak_median9 = peak_memory_mb(lambda: flow.loss_and_gradients(
        bx, by, TRAIN_LAMBDA_NIP, strength_scalars=scalars, strength_indices=indices))

    before = {part: {k: p.detach().clone() for k, p in leaves.items()}
              for part, leaves in flow._collect_params().items()}
    flow.training_step(bx, by, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)    # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = {False: [], True: []}, []
    for i in range(TRAIN_STEPS + TRAIN_AUGMENTED_STEPS):
        augment = i >= TRAIN_STEPS
        t0 = time.perf_counter()
        loss, parts = flow.training_step(*batches[1 + i % TRAIN_STEPS], TRAIN_LAMBDA_NIP,
                                         augment=augment, learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        times[augment].append(time.perf_counter() - t0)
        losses.append({'loss': float(loss), **{k: float(v) for k, v in parts.items()}})
    train_counts = read_counts()
    expect_counts('[manip7 train]', train_counts,
                  {'jpeg8x8': 2 * (TRAIN_STEPS + TRAIN_AUGMENTED_STEPS)})
    flow.assert_finite()
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f'[manip7 train] non-finite losses {losses}')
    moved = {part: max(float((p.detach() - before[part][k]).abs().max())
                       for k, p in leaves.items())
             for part, leaves in flow._collect_params().items()}
    if not (moved['nip'] > 0 and moved['fan'] > 0):
        raise AssertionError(f'[manip7 train] parameters did not move: {moved}')
    profiles = {}
    for label, augment in (('fixed', False), ('augmented', True)):
        profiles[label] = device_profile(lambda: flow.training_step(
            bx, by, TRAIN_LAMBDA_NIP, augment=augment, learning_rate=TRAIN_LR), 5)
        print_profile(f'manip7 train {label}', profiles[label])
    flow.assert_finite()
    median = float(np.median(times[False]))
    print(f'[manip7 train] median step {1e3 * median:.2f} ms ({1 / median:.2f} steps/s, '
          f'{args.batch / median:.1f} raw patches/s); augmented '
          f'{", ".join(f"{1e3 * t:.2f}" for t in times[True])} ms; device '
          f'{profiles["fixed"]["device_ms_per_call"]:.2f} ms a step, busy '
          f'{100 * profiles["fixed"]["device_busy_share"]:.1f}% (augmented '
          f'{profiles["augmented"]["device_ms_per_call"]:.2f} ms, busy '
          f'{100 * profiles["augmented"]["device_busy_share"]:.1f}%); peak memory {peak:.1f} MiB '
          f'a step, {peak_median9:.1f} MiB with median k=9; K1 launches '
          f'{train_counts["jpeg8x8"]}; largest change {moved}', flush=True)
    results['train'] = {
        'batch': args.batch, 'raw_patch': RAW_PATCH, 'lambda_nip': TRAIN_LAMBDA_NIP,
        'lr': TRAIN_LR, 'classes': flow.n_classes, 'cpu_first_step': agreement,
        'cpu_fan_input_flips': flips, 'cpu_step_s': cpu_s, 'peak_mb': peak,
        'peak_mb_median9': peak_median9, 'median_switch': switch, 'pooled': pooled,
        'step_ms': [1e3 * t for t in times[False]],
        'augmented_step_ms': [1e3 * t for t in times[True]], 'median_ms': 1e3 * median,
        'steps_per_s': 1 / median, 'raw_patches_per_s': args.batch / median,
        **{f'{label}_device_ms_per_step': p['device_ms_per_call']
           for label, p in profiles.items()},
        **{f'{label}_device_busy_share': p['device_busy_share'] for label, p in profiles.items()},
        'top_kernels': {label: p['top_kernels'] for label, p in profiles.items()},
        'k1_launches': train_counts['jpeg8x8'], 'losses': losses, 'largest_change': moved}
    return (classify_counts, train_counts), results


# -- RAW ingestion and full-resolution development ---------------------------------------

def raw_scene(seed):
    """The D90 capture (``RAW_HEIGHT`` x ``RAW_WIDTH``, GBRG, 14 bits) of one
    procedural scene, as a uint16 mosaic, and the camera's sRGB matrix."""
    camera = json.loads((base.REPO_ROOT / 'config' / 'cameras.json').read_text())[RAW_CAMERA]
    scene = fixtures.procedural_image(RAW_HEIGHT, RAW_WIDTH, seed)
    srgb = np.asarray(camera['srgb'])
    mosaic = fixtures.simulate_sensor_mosaic(scene, camera['cfa'], RAW_CAM_MUL, srgb,
                                             RAW_BLACK, RAW_WHITE)
    return mosaic, camera['cfa'], srgb


def write_containers(directory, mosaic, cfa, srgb):
    """The capture in every container and coding the port writes; returns
    {name: (path, the mosaic the container must give back, seconds to write)}.
    The lossy codings give back a mosaic other than the written one: the NEF
    rows from its tree split on hold the encoder's closed-loop reconstruction,
    and every NEF value passes the linearization curve; the cRAW payload is
    12-bit codes through Sony's tone curve, written from a mosaic that has
    been through the coding once (the coding is idempotent)."""
    h, w = mosaic.shape
    common = dict(cfa_pattern=cfa, black=RAW_BLACK, white=RAW_WHITE)
    split = h - NEF_LOSSY_TAIL
    samples = np.round(RAW_WHITE * (np.arange(17) / 16) ** 1.25).astype(np.uint16)
    curve = nikon.parse_meta(nikon.build_meta_lossy((0, 0, 0, 0), curve_samples=samples,
                                                    split=split), bits=RAW_BITS)['curve']
    recon = mosaic.astype(np.int32)
    recon[split:] = nikon.encode_lossy(mosaic[split - 2:], RAW_BITS, split=2)[1][2:]
    sony_curve = sony.build_curve(SONY_CURVE_POSTS)
    craw = sony.decode(sony.encode(mosaic >> 2, sony_curve), h, w, sony_curve)
    g = RAW_CAM_MUL[1]
    sr2 = {'curve_posts': SONY_CURVE_POSTS, 'black': RAW_BLACK >> 2, 'key': 0x5EED,
           'wb': (round(1024 * RAW_CAM_MUL[0] / g), 1024, 1024, round(1024 * RAW_CAM_MUL[2] / g))}
    writers = {
        'DNG': ('dng', mosaic, lambda p: dng.write_dng(
            p, mosaic, cam_mul=RAW_CAM_MUL, cam2srgb=srgb, camera=RAW_CAMERA, bits=RAW_BITS,
            **common)),
        'DNG lossless JPEG': ('dng', mosaic, lambda p: dng.write_dng(
            p, mosaic, cam_mul=RAW_CAM_MUL, cam2srgb=srgb, camera=RAW_CAMERA, bits=RAW_BITS,
            compression='ljpeg', **common)),
        'CR2': ('cr2', mosaic, lambda p: camera_raw.write_cr2(
            p, mosaic, precision=RAW_BITS, cam_mul=RAW_CAM_MUL, camera=RAW_CAMERA, **common)),
        'NEF lossless': ('nef', mosaic, lambda p: camera_raw.write_nef(
            p, mosaic, bits=RAW_BITS, camera=RAW_CAMERA, compression='nikon-lossless',
            **common)),
        'NEF lossy': ('nef', curve[np.clip(recon, 0, len(curve) - 1)], lambda p: camera_raw.write_nef(
            p, mosaic, bits=RAW_BITS, camera=RAW_CAMERA, compression='nikon-lossy',
            nikon_split=split, nikon_curve_samples=samples, **common)),
        'ARW': ('arw', mosaic, lambda p: camera_raw.write_arw(
            p, mosaic, bits=16, camera=RAW_CAMERA, **common)),
        'ARW cRAW': ('arw', craw, lambda p: camera_raw.write_arw_craw(
            p, craw, cfa_pattern=cfa, camera=RAW_CAMERA, sr2_meta=sr2)),
    }
    out = {}
    for i, (name, (ext, expected, write)) in enumerate(writers.items()):
        path = os.path.join(directory, f'capture_{i}.{ext}')
        t0 = time.perf_counter()
        write(path)
        out[name] = (path, expected, time.perf_counter() - t0)
    return out


def read_containers(containers):
    """Each container read back: its parsed mosaic equal to the expected one
    bit for bit, ``raw.unpack``'s RGGB stack of the right shape in [0, 1],
    and ``unpack``'s wall time (host only)."""
    results = {}
    for name, (path, expected, write_s) in containers.items():
        parse = dng.read_dng if path.endswith('.dng') else camera_raw.read_camera_raw
        parsed = parse(path)['mosaic']
        if parsed.shape != expected.shape or not np.array_equal(parsed, expected):
            raise AssertionError(f'[raw] {name}: the mosaic read back differs from the written '
                                 f'one in {int((parsed != expected).sum())} values')
        t0 = time.perf_counter()
        stack, cfa, _, _ = raw.unpack(path)
        unpack_s = time.perf_counter() - t0
        if stack.shape != (RAW_HEIGHT // 2, RAW_WIDTH // 2, 4) or cfa != 'GBRG' \
                or not np.isfinite(stack).all() or stack.min() < 0 or stack.max() > 1:
            raise AssertionError(f'[raw] {name}: bad stack {stack.shape} {cfa}')
        results[name] = {'bytes': os.path.getsize(path), 'write_s': write_s,
                         'unpack_ms': 1e3 * unpack_s}
        print(f'[raw] {name}: {os.path.getsize(path):,} bytes written in {write_s:.2f} s; '
              f'mosaic read back exactly; unpack {1e3 * unpack_s:.1f} ms', flush=True)
    return results


def event_ms(fn, reps):
    """``fn()`` ``reps`` times, each between two CUDA events (the host's work
    inside the call included); the times in ms and the last result."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def develop_check(crop, cfa, cam2srgb, demosaicing, device):
    """``raw.develop`` of a mosaic crop on the card against the CPU (float64,
    the same operations): Menon's direction decisions that differ (the
    pixels within 3 of one are left out of the comparison), the largest
    difference elsewhere, and the uint8 values that differ."""
    args = dict(cfa_pattern=cfa, cam2srgb=cam2srgb, brightness='percentile',
                demosaicing=demosaicing)
    card = raw.develop(crop, device=device, **args).cpu()
    cpu = raw.develop(crop, device='cpu', **args)
    keep = torch.ones(crop.shape, dtype=torch.bool)
    flips = 0
    if demosaicing == 'menon':
        m = torch.from_numpy(crop).to(torch.float64)
        flipped = menon.directions(m.to(device), cfa)[0].cpu() != menon.directions(m, cfa)[0]
        flips = int(flipped.sum())
        near = torch.nn.functional.max_pool2d(flipped[None, None].double(), 7, 1, 3)[0, 0] > 0
        keep = ~near
    diff = float((card - cpu).abs()[keep].max())
    u8 = int((raw.to_uint8(card) != raw.to_uint8(cpu)).sum())
    return flips, diff, u8


def raw_development(path, crop, device):
    """``raw.process`` of the DNG capture with each demosaicer at full size on
    the card (CUDA events around the call, its host reading included; median
    of ``RAW_DEVELOP_REPS``), ``raw.develop`` alone from the mosaic already on
    the card, the peak memory of each, and each against the CPU on a crop."""
    results = {}
    mosaic, cfa, cam2srgb, cam_mul = raw._load_raw_data(path)
    mosaic = torch.from_numpy(raw._apply_wb(mosaic, cfa, cam_mul)).to(device)
    for demosaicing in RAW_DEMOSAICERS:
        raw.process(path, demosaicing=demosaicing, device=device)            # warm-up
        process_ms, rgb = event_ms(lambda: raw.process(path, demosaicing=demosaicing,
                                                       device=device), RAW_DEVELOP_REPS)
        if tuple(rgb.shape) != (RAW_HEIGHT, RAW_WIDTH, 3) or rgb.dtype != torch.float64 \
                or not bool(torch.isfinite(rgb).all()) or float(rgb.min()) < 0 \
                or float(rgb.max()) > 1:
            raise AssertionError(f'[raw] process({demosaicing}): bad RGB {tuple(rgb.shape)}')
        del rgb
        develop_ms, _ = event_ms(lambda: raw.develop(
            mosaic, cfa, cam2srgb, brightness='percentile', demosaicing=demosaicing,
            device=device), RAW_DEVELOP_REPS)
        _, peak = peak_memory_mb(lambda: raw.develop(
            mosaic, cfa, cam2srgb, brightness='percentile', demosaicing=demosaicing,
            device=device))
        flips, diff, u8 = develop_check(crop, cfa, cam2srgb, demosaicing, device)
        if not diff <= MAX_DEVELOP_DIFF:
            raise AssertionError(f'[raw] {demosaicing}: card and CPU differ by {diff}')
        if u8 > MAX_DEVELOP_U8_SHARE * crop.size * 3:
            raise AssertionError(f'[raw] {demosaicing}: {u8} uint8 values differ from the CPU')
        results[demosaicing] = {
            'process_ms': process_ms, 'process_median_ms': float(np.median(process_ms)),
            'develop_ms': develop_ms, 'develop_median_ms': float(np.median(develop_ms)),
            'peak_mib': peak, 'cpu_direction_flips': flips, 'cpu_max_abs_diff': diff,
            'cpu_uint8_differ': u8}
        print(f'[raw] process {demosaicing}: {RAW_WIDTH}x{RAW_HEIGHT} in '
              f'{results[demosaicing]["process_median_ms"]:.1f} ms (CUDA events, median of '
              f'{RAW_DEVELOP_REPS}, host reading included), develop alone '
              f'{results[demosaicing]["develop_median_ms"]:.1f} ms, peak {peak:.0f} MiB; '
              f'{RAW_CROP}^2 crop vs the CPU: {flips} direction flips, max |d| {diff:.3g} '
              f'(bound {MAX_DEVELOP_DIFF:g}), {u8} uint8 values differ', flush=True)
    return results


def raw_nips(path, device):
    """Each shipped QualityRef NIP develops the capture's whole RGGB stack in
    one forward on the card (median of ``RAW_NIP_REPS``, peak memory), and a
    ``RAW_NIP_CROP``-px crop of it against the CPU within ``MAX_NIP_DIFF``."""
    stack = raw.unpack(path)[0]
    y0 = (stack.shape[0] - RAW_NIP_CROP) // 2
    x0 = (stack.shape[1] - RAW_NIP_CROP) // 2
    crop = stack[y0:y0 + RAW_NIP_CROP, x0:x0 + RAW_NIP_CROP][None]
    results = {}
    for name, snapshot in NIP_SNAPSHOTS.items():
        model = base.restore(str(base.REPO_ROOT / snapshot), pipelines, device=device)

        def develop():
            with torch.inference_mode():
                return model.process(stack[None])

        develop()                                                   # warm-up
        times, y = event_ms(develop, RAW_NIP_REPS)
        del y
        y, peak = peak_memory_mb(develop)
        if tuple(y.shape) != (1, RAW_HEIGHT, RAW_WIDTH, 3) or not bool(torch.isfinite(y).all()) \
                or float(y.min()) < 0 or float(y.max()) > 1:
            raise AssertionError(f'[raw] {name}: bad RGB of shape {tuple(y.shape)}')
        del y
        with torch.inference_mode():
            card = model.process(crop).cpu().numpy()
            cpu = base.restore(str(base.REPO_ROOT / snapshot), pipelines,
                               device='cpu').process(crop).numpy()
        diff = float(np.abs(card - cpu).max())
        if not diff <= MAX_NIP_DIFF:
            raise AssertionError(f'[raw] {name}: the crop on the card and the CPU differ by {diff}')
        results[name] = {'model_code': model.model_code, 'ms': times,
                         'median_ms': float(np.median(times)), 'peak_mib': peak,
                         'crop_cpu_max_abs_diff': diff}
        print(f'[raw] {model.model_code}: {stack.shape[0]}x{stack.shape[1]}x4 → '
              f'{RAW_HEIGHT}x{RAW_WIDTH} RGB in {results[name]["median_ms"]:.1f} ms (median of '
              f'{RAW_NIP_REPS}), peak {peak:.0f} MiB; {RAW_NIP_CROP}^2 crop vs the CPU max |dy| '
              f'{diff:.3g} (bound {MAX_NIP_DIFF:g})', flush=True)
        del model
        torch.cuda.empty_cache()
    return results


def raw_clis(containers, tmp):
    """The two CLIs end to end on the card: ``train_prepare_training_set
    --dev manual`` on a directory of captures, whose output the port's
    ``Dataset`` reads a training and a validation batch from, and
    ``develop_images --pipeline UNet --cam QualityRef`` on one capture, whose
    PNG ``read_png`` reads back. Seconds per image of each."""
    captures = os.path.join(tmp, 'captures')
    os.makedirs(captures)
    for name in RAW_CLI_CONTAINERS:
        path = containers[name][0]
        os.link(path, os.path.join(captures, os.path.basename(path)))
    prepared = os.path.join(tmp, 'prepared')
    t0 = time.perf_counter()
    stems = prepare_cli.main(['--dir', captures, '--out', prepared, '--dev', 'manual'])
    prepare_s = (time.perf_counter() - t0) / len(RAW_CLI_CONTAINERS)
    if len(stems) != len(RAW_CLI_CONTAINERS):
        raise AssertionError(f'[raw] train_prepare_training_set wrote {stems}')
    data = Dataset(prepared, n_images=len(stems) - 1, v_images=1, val_rgb_patch_size=256)
    bx, by = data.next_training_batch(0, len(stems) - 1, 256)
    vx, vy = data.next_validation_batch(0, 1)
    for label, b, shape in (('training raw', bx, (len(stems) - 1, 128, 128, 4)),
                            ('training rgb', by, (len(stems) - 1, 256, 256, 3)),
                            ('validation raw', vx, (1, 128, 128, 4)),
                            ('validation rgb', vy, (1, 256, 256, 3))):
        if b.shape != shape or not np.isfinite(b).all() or b.min() < 0 or b.max() > 1:
            raise AssertionError(f'[raw] Dataset {label} batch: {b.shape}')
    one = os.path.join(tmp, 'one')
    os.makedirs(one)
    os.link(containers['DNG'][0], os.path.join(one, 'capture.dng'))
    t0 = time.perf_counter()
    written = develop_cli.main(['--dir', one, '--out', os.path.join(tmp, 'developed'),
                                '--pipeline', 'UNet', '--cam', 'QualityRef'])
    develop_s = time.perf_counter() - t0
    rgb = png.read_png(written[0])
    if rgb.shape != (RAW_HEIGHT, RAW_WIDTH, 3) or rgb.dtype != np.uint8:
        raise AssertionError(f'[raw] develop_images wrote {rgb.shape} {rgb.dtype}')
    print(f'[raw] train_prepare_training_set --dev manual: {len(stems)} captures, '
          f'{prepare_s:.2f} s an image; Dataset batches {bx.shape} + {by.shape}, '
          f'{vx.shape} + {vy.shape}; develop_images --pipeline UNet --cam QualityRef: '
          f'{develop_s:.2f} s an image, {os.path.basename(written[0])} read back '
          f'{rgb.shape}', flush=True)
    return {'prepare_s_per_image': prepare_s, 'develop_images_s_per_image': develop_s}


def raw_phase(args, device):
    """``[raw]``: RAW ingestion and development at the Nikon D90's full
    resolution. No kernel of the port runs. Returns (launch counts, results)."""
    built_before = ljpeg.library_path().exists()
    t0 = time.perf_counter()
    library = ljpeg.build()
    build_s = time.perf_counter() - t0
    print(f'[raw] lossless-JPEG scan codec {library.name} (native/ljpeg/ljpeg.cpp, g++ '
          f'{" ".join(native.CXX_FLAGS)}): '
          + ('found, built earlier in this checkout' if built_before
             else f'built in {build_s:.2f} s'), flush=True)
    t0 = time.perf_counter()
    mosaic, cfa, srgb = raw_scene(args.seed + 1300)
    scene_s = time.perf_counter() - t0
    print(f'[raw] {RAW_CAMERA} capture {RAW_WIDTH}x{RAW_HEIGHT} {cfa}, {RAW_BITS}-bit, black '
          f'{RAW_BLACK}, white {RAW_WHITE}: made in {scene_s:.1f} s', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        containers = write_containers(tmp, mosaic, cfa, srgb)
        torch.cuda.synchronize()
        zero_counts()
        reads = read_containers(containers)
        # a crop at even offsets, so that it keeps the CFA's phase
        y0 = (RAW_HEIGHT - RAW_CROP) // 4 * 2
        x0 = (RAW_WIDTH - RAW_CROP) // 4 * 2
        unbalanced, cfa_, _, cam_mul = raw._load_raw_data(containers['DNG'][0])
        crop = np.ascontiguousarray(
            raw._apply_wb(unbalanced, cfa_, cam_mul)[y0:y0 + RAW_CROP, x0:x0 + RAW_CROP])
        develop = raw_development(containers['DNG'][0], crop, device)
        nips = raw_nips(containers['DNG'][0], device)
        clis = raw_clis(containers, tmp)
        counts = read_counts()
    expect_counts('RAW ingestion and development', counts, {})
    return counts, {'library': library.name, 'built_before': built_before, 'build_s': build_s,
                    'scene_s': scene_s,
                    'containers': reads, 'develop': develop, 'nips': nips, 'clis': clis}


def host_codec_check(seed):
    """The native baseline JPEG codec: built, held byte for byte and pixel for
    pixel against its plain version, and against the committed digests of
    PIL's files; a 512x768 round trip timed. Returns its record."""
    built_before = baseline_jpeg.library_path().exists()
    t0 = time.perf_counter()
    library = baseline_jpeg.build()
    build_s = time.perf_counter() - t0
    checked = 0
    for i, (h, w) in enumerate(CODEC_CHECK_SHAPES):
        image = (fixtures.procedural_image(h, w, seed + i) * 255).astype(np.uint8)
        for subsampling in baseline_jpeg.SUBSAMPLING:
            for quality in CODEC_CHECK_QUALITIES:
                data = baseline_jpeg.encode(image, quality, subsampling)
                if data != baseline_jpeg.encode_plain(image, quality, subsampling):
                    raise AssertionError(f'native and plain JPEG bytes differ: {h}x{w} '
                                         f'QF {quality} {subsampling}')
                if not np.array_equal(baseline_jpeg.decode(data),
                                      baseline_jpeg.decode_plain(data)):
                    raise AssertionError(f'native and plain JPEG decodes differ: {h}x{w} '
                                         f'QF {quality} {subsampling}')
                checked += 1
    wrong = baseline_jpeg.digest_mismatches()
    if wrong:
        raise AssertionError(f'the native JPEG codec misses PIL\'s digests: {wrong}')
    image = (fixtures.kodak_like_batch(1, *RD_SHAPE, seed=seed)[0] * 255).astype(np.uint8)
    times = []
    for _ in range(JPEG_ROUND_TRIP_REPS):
        t0 = time.perf_counter()
        baseline_jpeg.decode(baseline_jpeg.encode(image, 75))
        times.append(time.perf_counter() - t0)
    record = {'library': library.name, 'built_before': built_before, 'build_s': build_s,
              'plain_checks': checked, 'digests': len(baseline_jpeg.PIL_DIGESTS),
              'round_trip_ms': 1e3 * float(np.median(times))}
    print(f'[codec eval] host JPEG codec {library.name} (csrc/baseline_jpeg.cpp, g++ '
          f'{" ".join(native.CXX_FLAGS)}): '
          + ('found, built earlier in this checkout' if built_before
             else f'built in {build_s:.2f} s')
          + f'; {checked} files equal to the plain version\'s, bytes and pixels; all '
          f'{record["digests"]} PIL digests reproduced; {RD_SHAPE[0]}x{RD_SHAPE[1]} 4:4:4 '
          f'QF 75 round trip {record["round_trip_ms"]:.2f} ms (median of '
          f'{JPEG_ROUND_TRIP_REPS})', flush=True)
    return record


def check_rd_table(name, table, rows, codecs):
    """A sweep's table: its rows, codecs and finite metrics in range."""
    if len(table) != rows or set(table['codec']) != set(codecs):
        raise AssertionError(f'{name}: {len(table)} rows of {sorted(set(table["codec"]))}, '
                             f'expected {rows} of {sorted(codecs)}')
    for column in (*RD_METRICS, 'bpp'):
        values = table[column].astype(np.float64)
        if not np.isfinite(values).all():
            raise AssertionError(f'{name}: non-finite {column}')
    ssim = table['ssim'].astype(np.float64)
    if not ((ssim > 0) & (ssim <= 1)).all() or not (table['bpp'].astype(np.float64) > 0).all():
        raise AssertionError(f'{name}: SSIM or bpp out of range')


def rd_fits(table):
    """Each codec's fit of each metric: the per-image fit-then-average where a
    codec has several samples an image, else the pooled fit; a fit that does
    not converge on a DCN's four samples is recorded, not raised."""
    fits = {}
    for codec_name in table.unique('codec'):
        sel = table.where(table['codec'] == codec_name)
        per_image = len(sel) > len(sel.unique('image_id'))
        for metric in RD_METRICS:
            try:
                fit = rd.fit_rd_curve_per_image if per_image else rd.fit_rd_curve
                grid, fitted = fit(sel, metric)
            except (RuntimeError, ValueError, TypeError) as e:
                if per_image:
                    raise
                fits[f'{codec_name}/{metric}'] = f'no fit: {e}'
                continue
            if not np.isfinite(fitted).all():
                raise AssertionError(f'{codec_name}: non-finite {metric} fit')
            fits[f'{codec_name}/{metric}'] = {'bpp': [float(grid[0]), float(grid[-1])],
                                              metric: [float(fitted[0]), float(fitted[-1])]}
    return fits


def codec_eval_phase(args, device, flush):
    """``[codec eval]``: the host JPEG codec, the rate-distortion sweep's JPEG
    and DCN legs and their fits, the evaluation CLIs and ``validate_jpeg``
    with the libjpeg codec. Returns (K1 and K2 launch counts of the phase,
    results)."""
    t_phase = time.perf_counter()
    host = host_codec_check(args.seed + 1400)
    gen = torch.Generator().manual_seed(args.seed + 1401)
    # K1 at test_jpeg's shape, K2 at the DCN leg's, against their plain versions
    n_jpeg, (jh, jw) = 4, (256, 384)
    planes = (torch.rand((3 * n_jpeg, jh, jw), generator=gen) * 255 - 127).to(device)
    q_luma, q_chroma = qtables(50, device)
    k1 = check_k1('test_jpeg 4x256x384', planes, torch.stack(
        [q_luma, q_chroma, q_chroma]).repeat(n_jpeg, 1, 1).contiguous(), args.reps, flush)
    k2 = {preset: check_codebook(f'rd {preset} {RD_SHAPE[0]}x{RD_SHAPE[1]}',
                                 RD_SHAPE[0] * RD_SHAPE[1] // 64 * int(preset[:-1]), args.reps,
                                 flush, gen, device)['codebook_fwd']
          for preset in RD_PRESETS}
    counts = {}
    results = {'host_codec': host, 'k1_shape': k1, 'k2_shapes': k2}
    with tempfile.TemporaryDirectory() as tmp:
        images_dir = os.path.join(tmp, 'kodak_like')
        os.makedirs(images_dir)
        batch = fixtures.kodak_like_batch(RD_IMAGES, *RD_SHAPE)
        for i, image in enumerate(batch):
            png.write_png(os.path.join(images_dir, f'kodak_like_{i:02d}.png'),
                          (image * 255).round().astype(np.uint8))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        jpeg_table = rd.get_jpeg_df(images_dir, qualities=RD_QUALITIES, device=device)
        jpeg_s = time.perf_counter() - t0
        counts['jpeg leg'] = read_counts()
        expect_counts('[codec eval] JPEG leg', counts['jpeg leg'], {})
        check_rd_table('JPEG leg', jpeg_table, RD_IMAGES * len(RD_QUALITIES), ['jpeg'])
        zero_counts()
        t0 = time.perf_counter()
        dcn_table = rd.get_dcn_df(images_dir, str(base.REPO_ROOT / RD_DCN_ROOT), device=device)
        dcn_s = time.perf_counter() - t0
        counts['dcn leg'] = read_counts()
        expect_counts('[codec eval] DCN leg', counts['dcn leg'],
                      {'codebook_fwd': RD_IMAGES * len(RD_PRESETS)})
        codes = {p: codec.restore(p, device='cpu').model_code for p in RD_PRESETS}
        check_rd_table('DCN leg', dcn_table, RD_IMAGES * len(RD_PRESETS), codes.values())

        # rows against a recomputation: image 0's QF 50 row from the host codec
        # again, exactly; its 32c row against the CPU's codec (the same bytes and
        # SSIM within MAX_DCN_SSIM_DIFF unless a latent index flipped)
        row = next(r for r in jpeg_table.rows if r['image_id'] == 0 and r['quality'] == 50)
        image0 = png.read_png(os.path.join(images_dir, row['filename'])).astype(np.float32) / 255
        decoded, nbytes = jpeg_helpers.compress_batch(image0, 50, effective=True)
        if nbytes != row['bytes'] or metrics.ssim(image0, decoded) != row['ssim']:
            raise AssertionError(f'JPEG row differs from a fresh round trip: {row}')
        dcn_card, dcn_cpu = codec.restore('32c', device=device), codec.restore('32c', device='cpu')
        latent = compression.compare_latents(dcn_card.compress(image0).cpu(),
                                             dcn_cpu.compress(image0), dcn_card.get_codebook())
        card_row = next(r for r in dcn_table.rows
                        if r['codec'] == codes['32c'] and r['image_id'] == 0)
        decoded_cpu, bytes_cpu = codec.simulate_compression(image0[None], dcn_cpu)
        ssim_cpu = metrics.ssim(image0, decoded_cpu[0])
        if latent['flipped'] == 0 and (bytes_cpu != card_row['bytes'] or
                                       abs(ssim_cpu - card_row['ssim']) > MAX_DCN_SSIM_DIFF):
            raise AssertionError(f'32c row differs from the CPU: {bytes_cpu} bytes, ssim '
                                 f'{ssim_cpu} against {card_row}')
        # a second call reads the cache
        t0 = time.perf_counter()
        cached = rd.get_jpeg_df(images_dir, qualities=RD_QUALITIES, device=device)
        cache_s = time.perf_counter() - t0
        if cached.rows != jpeg_table.rows:
            raise AssertionError('the cached JPEG sweep differs from the sweep')
        t0 = time.perf_counter()
        fits = {**rd_fits(jpeg_table), **rd_fits(dcn_table)}
        fits_s = time.perf_counter() - t0
        results['sweep'] = {
            'images': RD_IMAGES, 'shape': list(RD_SHAPE),
            'jpeg_rows': len(jpeg_table), 'jpeg_s': jpeg_s,
            'jpeg_ms_per_row': 1e3 * jpeg_s / len(jpeg_table),
            'dcn_rows': len(dcn_table), 'dcn_s': dcn_s,
            'dcn_ms_per_row': 1e3 * dcn_s / len(dcn_table), 'cache_hit_s': cache_s,
            'fits_s': fits_s, 'fits': fits,
            'dcn_32c_cpu': {'latent_flips': latent['flipped'], 'n': latent['n'],
                            'bytes_card': card_row['bytes'], 'bytes_cpu': bytes_cpu,
                            'ssim_card': card_row['ssim'], 'ssim_cpu': ssim_cpu},
            'jpeg_bpp_range': [float(jpeg_table['bpp'].min()), float(jpeg_table['bpp'].max())],
            'dcn_bpp': {p: float(np.mean(dcn_table.where(dcn_table['codec'] == codes[p])['bpp']))
                        for p in RD_PRESETS}}
        print(f'[codec eval] sweep of {RD_IMAGES} {RD_SHAPE[0]}x{RD_SHAPE[1]} images: JPEG leg '
              f'{len(jpeg_table)} rows in {jpeg_s:.2f} s ({1e3 * jpeg_s / len(jpeg_table):.1f} '
              f'ms a row), DCN leg {len(dcn_table)} rows in {dcn_s:.2f} s '
              f'({1e3 * dcn_s / len(dcn_table):.1f} ms a row, K2 '
              f'{counts["dcn leg"]["codebook_fwd"]}), cache hit {1e3 * cache_s:.1f} ms, fits '
              f'{fits_s:.2f} s; 32c image 0 against the CPU: {latent["flipped"]} latent flips, '
              f'{card_row["bytes"]} / {bytes_cpu} bytes', flush=True)

        # a JPEG row's parts on image 0 at QF 50: the host codec (compress_batch,
        # effective bytes), the host's float64 SSIM and PSNR, MS-SSIM on the card
        parts = {'jpeg': lambda: jpeg_helpers.compress_batch(image0, 50, effective=True),
                 'ssim': lambda: metrics.ssim(image0, decoded),
                 'psnr': lambda: metrics.psnr(image0, decoded),
                 'msssim': lambda: rd._msssim_db(image0, decoded, device)}
        part_ms = {}
        for name, fn in parts.items():
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            part_ms[name] = 1e3 * float(np.median(times))
        results['jpeg_row_parts_ms'] = part_ms
        print('[codec eval] a JPEG row\'s parts (median of 3): '
              + ', '.join(f'{k} {v:.2f} ms' for k, v in part_ms.items()), flush=True)

        # per codec, one DCN row's round trip (a 512x768 image through the bitstream)
        row_ms = {}
        for preset in RD_PRESETS:
            dcn = codec.restore(preset, device=device)
            codec.simulate_compression(image0[None], dcn)           # warm-up
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                codec.simulate_compression(image0[None], dcn)
                times.append(time.perf_counter() - t0)
            row_ms[preset] = 1e3 * float(np.median(times))
        results['dcn_round_trip_ms'] = row_ms
        print(f'[codec eval] DCN round trip of a {RD_SHAPE[0]}x{RD_SHAPE[1]} image: '
              + ', '.join(f'{p} {ms:.2f} ms' for p, ms in row_ms.items()), flush=True)

        # the CLIs at their defaults
        zero_counts()
        t0 = time.perf_counter()
        rows = test_jpeg_cli.main(['--device', 'cuda'])
        test_jpeg_s = time.perf_counter() - t0
        counts['test_jpeg'] = read_counts()
        expect_counts('[codec eval] test_jpeg', counts['test_jpeg'],
                      {'jpeg8x8': len(RD_QUALITIES)})
        qf, psnr_card, _ = rows[len(rows) // 2]
        small = test_jpeg_cli.load_batch(None, 4)
        y_cpu = JPEG(50, 'soft', device='cpu').process(torch.from_numpy(small), qf).numpy()
        psnr_cpu = float(np.mean(metrics.psnr(small, y_cpu)))
        if abs(psnr_card - psnr_cpu) > MAX_DJPEG_PSNR_DIFF or len(rows) != len(RD_QUALITIES):
            raise AssertionError(f'test_jpeg: QF {qf} dJPEG {psnr_card} dB on the card, '
                                 f'{psnr_cpu} dB on the CPU')
        results['test_jpeg'] = {'s': test_jpeg_s, 'rows': len(rows),
                                'qf': qf, 'djpeg_psnr_card': psnr_card,
                                'djpeg_psnr_cpu': psnr_cpu,
                                'mean_delta_db': float(np.mean([r[1] - r[2] for r in rows]))}
        results['test_dcn'] = {}
        for mode, k2_expected in TEST_DCN_K2.items():
            zero_counts()
            t0 = time.perf_counter()
            out = test_dcn_cli.main([mode, '--device', 'cuda',
                                     '--out', os.path.join(tmp, 'rate_dist.csv')])
            mode_s = time.perf_counter() - t0
            counts[f'test_dcn {mode}'] = read_counts()
            expect_counts(f'[codec eval] test_dcn {mode}', counts[f'test_dcn {mode}'],
                          {'codebook_fwd': k2_expected})
            if mode == 'batch':
                summary = {k: float(np.mean(v)) for k, v in out.items()}
            elif mode == 'rate-dist':
                summary = {'ssim': float(np.mean(out['ssim'])), 'bpp': float(np.mean(out['bpp']))}
            else:
                summary = {'qf': [r[3] for r in out], 'dcn_ssim': [r[1] for r in out],
                           'jpeg_ssim': [r[4] for r in out]}
            if not all(np.isfinite(v).all() for v in summary.values()):
                raise AssertionError(f'test_dcn {mode}: {summary}')
            results['test_dcn'][mode] = {'s': mode_s, **summary}

        # validate_jpeg with the libjpeg codec on a small RGB set
        data_dir = fixtures.make_dataset(os.path.join(tmp, 'rgb'), n_images=4, height=128,
                                         width=192, seed=args.seed + 1402, rgb_only=True)
        data = Dataset(data_dir, load='y', n_images=2, v_images=2, val_rgb_patch_size=64)
        zero_counts()
        values = validation.validate_jpeg(JPEG(50, 'libjpeg', device=device), data)
        counts['validate_jpeg'] = read_counts()
        expect_counts('[codec eval] validate_jpeg', counts['validate_jpeg'], {})
        x = data.next_validation_batch(0, data.count_validation)
        x = x[-1] if isinstance(x, tuple) else x
        y, _ = jpeg_helpers.compress_batch(x, 50)
        want = metrics.batch(x, y, metrics.ssim)
        if not np.isnan(values['entropy']) or abs(values['ssim'] - want) > 1e-12:
            raise AssertionError(f'validate_jpeg: {values}, expected ssim {want}')
        results['validate_jpeg'] = values
    results['phase_s'] = time.perf_counter() - t_phase
    print(f'[codec eval] phase {results["phase_s"]:.1f} s', flush=True)
    totals = {name: sum(c[name] for c in counts.values()) for name in COUNTERS}
    return totals, results


# -- the last rate-distortion legs and the image readers ----------------------------------

def png_write_filtered(path, image, kinds):
    """Write an (h, w, c) uint8 image as an 8-bit PNG whose row y is filtered
    with ``kinds[y]`` (0-4: None, Sub, Up, Average, Paeth), the encoder's side
    of the filters in numpy."""
    h, _, bpp = image.shape
    x = image.reshape(h, -1).astype(np.int16)
    left, up, upleft = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:], up[1:], upleft[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kinds = np.asarray(kinds)
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])[kinds, np.arange(h)]
    data = np.concatenate([kinds[:, None], (x - pred) % 256], axis=1).astype(np.uint8)
    header = struct.pack('>IIBBBBB', image.shape[1], h, 8, {3: 2, 4: 6}[bpp], 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(png.SIGNATURE + png._chunk(b'IHDR', header)
                + png._chunk(b'IDAT', zlib.compress(data.tobytes(), 1)) + png._chunk(b'IEND', b''))


def unfilter_check(tmp, seed):
    """A 12 MP RGB PNG with rows of all five filters read by ``read_png`` (the
    compiled unfilter) and its IDAT undone by the plain Python version: the
    same pixels, and the image itself. Returns its times."""
    h, w = UNFILTER_SHAPE
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-4, 5, (h, w, 3)), axis=1) + np.arange(h)[:, None, None] // 12
    image = (smooth + rng.integers(0, 4, (h, w, 3))).astype(np.uint8)
    path = os.path.join(tmp, 'filters.png')
    t0 = time.perf_counter()
    png_write_filtered(path, image, np.arange(h) % 5)
    write_s = time.perf_counter() - t0
    built_before = png.library_path().exists()
    t0 = time.perf_counter()
    png.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pixels = png.read_png(path)
    read_s = time.perf_counter() - t0
    with open(path, 'rb') as f:
        chunks = dict(png._chunks(f.read()))
    raw = zlib.decompress(chunks[b'IDAT'])
    t0 = time.perf_counter()
    native_rows = png.unfilter(raw, h, 3 * w, 3)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_rows = png._unfilter(raw, h, 3 * w, 3)
    plain_s = time.perf_counter() - t0
    if not (np.array_equal(native_rows, plain_rows) and np.array_equal(pixels, image)):
        raise AssertionError('the compiled PNG unfilter differs from the plain version')
    record = {'shape': [h, w, 3], 'library': png.library_path().name,
              'built_before': built_before, 'build_s': build_s, 'write_s': write_s,
              'read_png_s': read_s, 'unfilter_native_s': native_s, 'unfilter_plain_s': plain_s}
    print(f'[codec legs] PNG {w}x{h} RGB, rows cycling None/Sub/Up/Average/Paeth: read_png '
          f'{read_s:.3f} s (zlib and the compiled unfilter {png.library_path().name}, '
          + ('built earlier' if built_before else f'built in {build_s:.2f} s')
          + f'); the unfilter alone {1e3 * native_s:.1f} ms compiled, {plain_s:.2f} s plain '
          f'Python, the same bytes', flush=True)
    return record


def bmp_check(tmp, image):
    """The image as BMP in 8-bit palette, 24-bit and 32-bit form (an odd width,
    so padded rows), written here and read back exactly by ``read_bmp``."""
    h, w = image.shape[0] - 1, image.shape[1] - 3
    rgb = np.ascontiguousarray(image[:h, :w])
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    index = rng.integers(0, 256, (h, w), dtype=np.uint8)
    forms = {8: (index, palette[index]), 24: (rgb[..., ::-1], rgb),
             32: (np.concatenate([rgb[..., ::-1], np.full((h, w, 1), 255, np.uint8)], -1),
                  rgb)}
    times = {}
    for bits, (pixels, want) in forms.items():
        stride = (w * bits + 31) // 32 * 4
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w * bits // 8] = pixels.reshape(h, -1)
        table = (np.concatenate([palette[:, ::-1], np.zeros((256, 1), np.uint8)], 1).tobytes()
                 if bits == 8 else b'')
        offset = 54 + len(table)
        info = struct.pack('<IiiHHIIiiII', 40, w, h, 1, bits, 0, rows.size, 2835, 2835,
                           256 if bits == 8 else 0, 0)
        path = os.path.join(tmp, f'image{bits}.bmp')
        with open(path, 'wb') as f:
            f.write(b'BM' + struct.pack('<IHHI', offset + rows.size, 0, 0, offset) + info
                    + table + rows[::-1].tobytes())
        t0 = time.perf_counter()
        got = bmp.read_bmp(path)
        times[bits] = time.perf_counter() - t0
        if got.dtype != np.uint8 or not np.array_equal(got, want):
            raise AssertionError(f'read_bmp of the {bits}-bit BMP differs from what was written')
    print(f'[codec legs] BMP {w}x{h} read back exactly: ' + ', '.join(
        f'{bits}-bit {1e3 * t:.1f} ms' for bits, t in times.items()), flush=True)
    return {'shape': [h, w], 'read_ms': {str(k): 1e3 * v for k, v in times.items()}}


def leg_round_trip(codec_name, image, quality):
    """One row's codec work on an (h, w, 3) float image, as its sweep does it:
    (decoded float image, the bytes the row counts)."""
    u8 = (image * 255).round().astype(np.uint8)
    if codec_name == 'jpeg2000':
        buf, decoded = jp2_helpers.encode_jp2(u8, psnr_target=float(quality))
        return decoded, jp2_helpers.jp2_payload_bytes(buf)
    if codec_name == 'bpg':
        decoded, bpp = bpg_helpers.roundtrip(image, quality)
        return decoded, int(bpp * image.shape[0] * image.shape[1] / 8)
    module, kw = {'webp': (webp, {}), 'avif': (avif, {'speed': 6})}[codec_name]
    buf = module.encode(u8, int(quality), **kw)
    return module.decode(buf).astype(np.float32) / 255.0, len(buf)


def msssim(db):
    return 1.0 - 10.0 ** (-db / 10.0)


def codec_leg(leg, codec_name, sweep, qualities, directory, n_images, device):
    """One leg's sweep at its full quality range, checked: the rows, a row
    re-encoded to the same bytes, its MS-SSIM on the card against the CPU, the
    cache, the fits. Returns its record."""
    zero_counts()
    t0 = time.perf_counter()
    table = sweep(directory, qualities=qualities, device=device)
    sweep_s = time.perf_counter() - t0
    expect_counts(f'[codec legs] {leg}', read_counts(), {})
    check_rd_table(leg, table, n_images * len(qualities), [codec_name])
    quality = qualities[len(qualities) // 2]
    row = next(r for r in table.rows if r['image_id'] == 0 and r['quality'] == quality)
    image0 = png.read_png(os.path.join(directory, row['filename'])).astype(np.float32) / 255
    t0 = time.perf_counter()
    decoded, nbytes = leg_round_trip(codec_name, image0, quality)
    codec_s = time.perf_counter() - t0
    if nbytes != row['bytes']:
        raise AssertionError(f'{leg}: a re-encoded row counts {nbytes} bytes, the sweep {row}')
    msssim_cpu = rd._msssim_db(image0, decoded, 'cpu')
    if abs(msssim(msssim_cpu) - msssim(row['msssim_db'])) > MAX_DCN_SSIM_DIFF:
        raise AssertionError(f'{leg}: MS-SSIM {row["msssim_db"]} dB on the card, {msssim_cpu} '
                             'dB on the CPU')
    t0 = time.perf_counter()
    rd._row(0, row['filename'], codec_name, quality, image0, decoded, nbytes, device)
    metrics_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = sweep(directory, qualities=qualities, device=device)
    cache_s = time.perf_counter() - t0
    if cached.rows != table.rows:
        raise AssertionError(f'{leg}: the cached sweep differs from the sweep')
    fits = rd_fits(table)
    bpp = table['bpp'].astype(np.float64)
    record = {'images': n_images, 'rows': len(table), 'qualities': [min(qualities),
                                                                     max(qualities)],
              'sweep_s': sweep_s, 'ms_per_row': 1e3 * sweep_s / len(table),
              'row_codec_ms': 1e3 * codec_s, 'row_metrics_ms': 1e3 * metrics_s,
              'cache_hit_s': cache_s, 'bpp_range': [float(bpp.min()), float(bpp.max())],
              'psnr_range': [float(table['psnr'].astype(np.float64).min()),
                             float(table['psnr'].astype(np.float64).max())],
              'row_checked': {'quality': quality, 'bytes': nbytes,
                              'msssim_db_card': row['msssim_db'], 'msssim_db_cpu': msssim_cpu},
              'fits': fits}
    print(f'[codec legs] {leg}: {len(table)} rows ({n_images} images x {len(qualities)} '
          f'qualities {min(qualities)}-{max(qualities)}) in {sweep_s:.2f} s '
          f'({record["ms_per_row"]:.1f} ms a row; image 0 at {quality}: codec '
          f'{1e3 * codec_s:.1f} ms, metrics {1e3 * metrics_s:.1f} ms, re-encoded to the same '
          f'{nbytes} bytes, MS-SSIM card/CPU {row["msssim_db"]:.4f}/{msssim_cpu:.4f} dB); '
          f'{bpp.min():.3f}-{bpp.max():.3f} bpp; cache hit {1e3 * cache_s:.1f} ms', flush=True)
    for key, fit in fits.items():
        print(f'[codec legs] {leg} fit {key}: {fit}', flush=True)
    return record


def hevc_check(image):
    """``hevc.encode_rgb`` / ``decode_rgb`` of an image at QP ``HEVC_QP``:
    the bytes again on a second encode, the decode's shape and PSNR."""
    u8 = (image * 255).round().astype(np.uint8)
    t0 = time.perf_counter()
    data = hevc.encode_rgb(u8, HEVC_QP)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = hevc.decode_rgb(data)
    decode_s = time.perf_counter() - t0
    psnr = float(metrics.psnr(image, decoded))
    if hevc.encode_rgb(u8, HEVC_QP) != data or decoded.shape != image.shape or \
            not np.isfinite(decoded).all() or psnr < 30:
        raise AssertionError(f'HEVC round trip at QP {HEVC_QP}: {len(data)} bytes, shape '
                             f'{decoded.shape}, PSNR {psnr} dB')
    print(f'[codec legs] HEVC intra {image.shape[1]}x{image.shape[0]} at QP {HEVC_QP}: '
          f'{len(data)} bytes ({8 * len(data) / (image.shape[0] * image.shape[1]):.3f} bpp), '
          f'{psnr:.2f} dB, encode {1e3 * encode_s:.1f} ms, decode {1e3 * decode_s:.1f} ms',
          flush=True)
    return {'qp': HEVC_QP, 'bytes': len(data), 'psnr': psnr, 'encode_ms': 1e3 * encode_s,
            'decode_ms': 1e3 * decode_s}


def codec_legs_phase(args, device):
    """``[codec legs]``: the codec libraries, each leg whose library loads at
    its full quality range on [codec eval]'s images, the HEVC round trip, the
    PNG unfilter and the BMP reader, and the evaluation CLI with every leg.
    Returns (K2 launches of the CLI's DCN leg, results)."""
    t_phase = time.perf_counter()
    libraries = rd.codec_libraries()
    for name, (ok, text) in libraries.items():
        print(f'[codec legs] {name}: ' + (f'loaded, {text}' if ok else f'absent: {text}'),
              flush=True)
    results = {'libraries': {name: {'loaded': ok, ('version' if ok else 'reason'): text}
                             for name, (ok, text) in libraries.items()}, 'legs': {}}
    with tempfile.TemporaryDirectory() as tmp:
        images_dir, jp2_dir = os.path.join(tmp, 'kodak_like'), os.path.join(tmp, 'kodak_like_2')
        os.makedirs(images_dir)
        os.makedirs(jp2_dir)
        batch = fixtures.kodak_like_batch(RD_IMAGES, *RD_SHAPE)
        for i, image in enumerate(batch):
            for directory in (images_dir, jp2_dir)[:1 + (i < JP2_IMAGES)]:
                png.write_png(os.path.join(directory, f'kodak_like_{i:02d}.png'),
                              (image * 255).round().astype(np.uint8))
        for leg, codec_name, sweep, library, qualities in CODEC_LEGS:
            ok, text = libraries[library]
            if not ok:
                print(f'[codec legs] {leg}: not run, {library} absent ({text})', flush=True)
                results['legs'][codec_name] = {'run': False, 'reason': text}
                continue
            jp2 = codec_name == 'jpeg2000'
            results['legs'][codec_name] = codec_leg(
                leg, codec_name, sweep, qualities, jp2_dir if jp2 else images_dir,
                JP2_IMAGES if jp2 else RD_IMAGES, device)
        image0 = png.read_png(os.path.join(images_dir, 'kodak_like_00.png'))
        if libraries['libx265'][0] and libraries['libde265'][0]:
            results['hevc'] = hevc_check(image0.astype(np.float32) / 255)
        else:
            print('[codec legs] HEVC: not run, libx265 or libde265 absent', flush=True)
        results['png'] = unfilter_check(tmp, args.seed + 1500)
        results['bmp'] = bmp_check(tmp, image0)

        # the evaluation CLI with every leg, on the JPEG 2000 leg's images (its
        # cache read, the other legs swept again, the DCN leg through K2)
        zero_counts()
        t0 = time.perf_counter()
        tables, curves = rate_dist_cli.main(['--data', jp2_dir, '--dcn-models',
                                             str(base.REPO_ROOT / RD_DCN_ROOT),
                                             '--device', str(device)])
        cli_s = time.perf_counter() - t0
        counts = read_counts()
        expect_counts('[codec legs] test_dcn_rate_dist', counts,
                      {'codebook_fwd': JP2_IMAGES * len(RD_PRESETS)})
        # a table a leg whose library loads, in the reference's order, then the DCN leg's
        want = ['jpeg'] + [c for _, c, _, library, _ in CODEC_LEGS if libraries[library][0]]
        codecs = [t['codec'][0] for t in tables[:-1]]
        if codecs != want or len(tables[-1].unique('codec')) != len(RD_PRESETS) or \
                any(t.empty for t in tables):
            raise AssertionError(f'test_dcn_rate_dist: tables of {codecs} and the DCN leg, '
                                 f'expected {want}')
        results['cli'] = {'s': cli_s, 'rows': {c: len(t) for c, t in zip(codecs + ['dcn'],
                                                                         tables)},
                          'curves': len(curves), 'k2': counts['codebook_fwd']}
        print(f'[codec legs] test_dcn_rate_dist on {JP2_IMAGES} images: {len(tables)} tables, '
              f'{len(curves)} curves in {cli_s:.1f} s, K2 {counts["codebook_fwd"]}', flush=True)
    results['phase_s'] = time.perf_counter() - t_phase
    print(f'[codec legs] phase {results["phase_s"]:.1f} s', flush=True)
    return counts, results


# -- data parallelism ---------------------------------------------------------------------

# the [parallel] phase: each of the four steps over 2 ranks sharing cuda:0 over
# gloo, each rank holding half of the global batch of its full-width shape
# (the joint step: batch 20 raw 128, 10 a rank; the DCN flow: batch 10, 5 a
# rank, N = 204,800 latent values a rank; the DCN step with a trainable
# codebook: 16 x 128², 8 a rank; the NIP step: UNet_5 at batch 20 raw 64, 10
# a rank), its first step against the one-process step at the global batch
# on the card, then PARALLEL_STEPS timed steps
PARALLEL_KINDS = ('joint', 'dcn flow', 'dcn', 'nip')
PARALLEL_JOINT_BATCH = 20
PARALLEL_STEPS = 5
PARALLEL_RANKS = 2
PARALLEL_DEADLINE_S = 400
# launches of K1-K4 a timed step, each rank
PARALLEL_PER_STEP = {'joint': {'jpeg8x8': 2},
                     'dcn flow': {'jpeg8x8': 1, 'codebook_fwd': 1, 'codebook_bwd': 1},
                     'dcn': {'codebook_fwd': 1, 'codebook_bwd_train': 1},
                     'nip': {}}
# the DCN flow's entropy over 2 ranks against the global batch's: the counts
# are exact, but the encoder's convolutions at batch 5 and 10 may pick other
# cuDNN algorithms, and a latent on a codeword midpoint may land on the other
# codeword (at most MAX_LATENT_FLIP_SHARE of them, ~1e-6 bits each)
MAX_PARALLEL_ENTROPY_DIFF = 1e-4
# development in bands against the whole stack on the card
PARALLEL_BANDS = (2, 4)
MAX_BAND_DIFF = 1e-5


def parallel_batches(kind, seed):
    """The global batches (numpy) of a kind's first step and its timed steps."""
    n = PARALLEL_STEPS + 1
    if kind == 'joint':
        return [(synthetic_raw(seed + i, PARALLEL_JOINT_BATCH, RAW_PATCH),
                 synthetic_rgb(seed + 50 + i, PARALLEL_JOINT_BATCH, 2 * RAW_PATCH,
                               2 * RAW_PATCH))
                for i in range(n)]
    if kind == 'dcn flow':
        side = 2 * DCN_FLOW_RAW_PATCH
        return [(synthetic_rgb(seed + 100 + i, DCN_FLOW_BATCH, side, side),) for i in range(n)]
    if kind == 'dcn':
        return [(synthetic_rgb(seed + 200 + i, DCN_BATCH, DCN_PATCH, DCN_PATCH),)
                for i in range(n)]
    return [(synthetic_raw(seed + 300 + i, NIP_TRAINER_BATCH, NIP_RAW_PATCH),
             synthetic_rgb(seed + 350 + i, NIP_TRAINER_BATCH, 2 * NIP_RAW_PATCH,
                           2 * NIP_RAW_PATCH)) for i in range(n)]


def parallel_model(kind, device, seed):
    """A kind's model at its full width, built alike in every process."""
    if kind == 'joint':
        model = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                                   rng_seed=seed, device=device)
        model.nan_check = False
        return model
    if kind == 'dcn flow':
        return dcn_flow(device, trainable=True, seed=seed)
    if kind == 'dcn':
        return trainable_dcn(DCN_PRESET, DCN_PATCH, device)
    return base.restore(str(base.REPO_ROOT / NIP_SNAPSHOTS['UNet']), pipelines,
                        patch_size=NIP_RAW_PATCH, device=device)


def parallel_train(kind, model, batch):
    """One training step of a kind on (this rank's rows of) a batch."""
    if kind == 'joint':
        return model.training_step(*batch, TRAIN_LAMBDA_NIP, learning_rate=TRAIN_LR)
    if kind == 'dcn flow':
        return model.training_step(batch[0], None, 0.0, DCN_FLOW_LAMBDA, learning_rate=TRAIN_LR)
    if kind == 'dcn':
        return model.training_step(batch[0], DCN_LR)
    return model.training_step(*batch, TRAIN_LR)


def parallel_first_step(kind, model, batch):
    """A kind's first step as ``compare_steps`` takes it, (loss, parts,
    {part: gradients}), and what its checks read besides: the FAN's input
    of a flow (class-major rows), the DCN flow's entropy."""
    extra = {}
    if kind in ('joint', 'dcn flow'):
        y, lam = (batch[1], TRAIN_LAMBDA_NIP) if kind == 'joint' else (None, 0.0)
        lam_dcn = 0.0 if kind == 'joint' else DCN_FLOW_LAMBDA
        step = model.loss_and_gradients(batch[0], y, lam, lam_dcn)
        mesh = None if model.parallel is None else model.parallel.mesh
        with torch.no_grad(), mesh_lib.batch_reductions(mesh):
            out = model._forward(model._batch(batch[0]).permute(0, 3, 1, 2),
                                 *model._channel_qtables())
        extra = {'fan_input': out[2].float().cpu(),
                 'entropy': None if out[3] is None else float(out[3])}
        return step, extra
    grads = {}
    step_fn = model.optimizer.step

    def keep_the_gradients():
        grads.update({k: p.grad.detach().clone() for k, p in model.module.named_parameters()})
        step_fn()
    model.optimizer.step = keep_the_gradients
    out = parallel_train(kind, model, batch)
    model.optimizer.step = step_fn
    if kind == 'dcn':
        return (float(out['loss']) ** 2 / 2, {'entropy': out['entropy']}, {'dcn': grads}), extra
    return (out, {}, {'nip': grads}), extra


def parameters_of(kind, model):
    if kind in ('joint', 'dcn flow'):
        return {f'{part}/{k}': p for part, leaves in model._collect_params().items()
                for k, p in leaves.items()}
    return dict(model.module.named_parameters())


def parallel_run(parallel, kind, seed):
    """A kind's first step and timed steps, on this rank's rows of the global
    batches (the whole batches without ``parallel``): the first step's
    results, the step times, each kernel's launches in the timed steps, the
    parameters' digest, and with ``parallel`` the all-reduce of a buffer the
    size of the gradients timed alone."""
    device = resolve_device(parallel.device if parallel is not None else 'cuda')
    model = parallel_model(kind, device, seed)
    if parallel is not None:
        parallel.distribute(model)
    batches = [tuple(torch.from_numpy(b).to(device) for b in
                     (parallel.shard(*batch) if parallel is not None else batch))
               for batch in parallel_batches(kind, seed)]
    first, extra = parallel_first_step(kind, model, batches[0])
    parallel_train(kind, model, batches[0])                       # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        parallel_train(kind, model, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    digest = {k: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
              for k, p in parameters_of(kind, model).items()}
    result = {'first': first, **extra, 'step_ms': [1e3 * t for t in times],
              'counts': counts, 'digest': digest}
    if parallel is not None:
        n = sum(p.numel() for p in parameters_of(kind, model).values() if p.requires_grad)
        buf = torch.zeros(n, device=device)
        reduce_ms = []
        for _ in range(PARALLEL_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh_lib.all_reduce_sum(buf, parallel.mesh)
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        result['all_reduce'] = {'floats': n, 'ms': reduce_ms[1:]}
    del model
    torch.cuda.empty_cache()
    return result


def parallel_rank(parallel, seed, kinds):
    """One rank of the [parallel] phase: every kind of ``kinds``."""
    return {kind: parallel_run(parallel, kind, seed) for kind in kinds}


def rank_rows(t, n_classes, world, rank):
    """A rank's class-major rows of a flow's expanded global batch."""
    per = t.shape[0] // n_classes // world
    blocks = t.reshape(n_classes, world, per, *t.shape[1:])
    return blocks[:, rank].reshape(n_classes * per, *t.shape[1:])


def check_parallel_kind(kind, ranks, single, n_classes=None):
    """Hold each rank's first step against the one-process step at the
    global batch; the ranks' parameters bit-identical; their launches."""
    report = {'ranks': []}
    for r, got in enumerate(ranks):
        flips = 0
        if 'fan_input' in got:
            ref_rows = rank_rows(single['fan_input'], n_classes, len(ranks), r)
            flips = int(((got['fan_input'] - ref_rows).abs() > FLIP_THRESHOLD).sum())
            agreement = compare_flow_steps(got['first'], single['first'], flips,
                                           part='nip' if kind == 'joint' else 'dcn')
        else:
            agreement = compare_steps(got['first'], single['first'])
        entry = {'flips': flips, 'max_loss_rel_diff': agreement['max_loss_rel_diff'],
                 'max_grad_norm_rel_diff': agreement['max_grad_norm_rel_diff'],
                 'worst_gradient': agreement['worst_gradient'],
                 'median_step_ms': float(np.median(got['step_ms'])), 'step_ms': got['step_ms'],
                 'all_reduce_floats': got['all_reduce']['floats'],
                 'all_reduce_median_ms': float(np.median(got['all_reduce']['ms'])),
                 'launches': got['counts']}
        if kind == 'dcn flow':
            entry['entropy'] = got['entropy']
            diff = abs(got['entropy'] - single['entropy'])
            if not diff <= MAX_PARALLEL_ENTROPY_DIFF:
                raise AssertionError(f'[parallel] {kind} rank {r}: entropy {got["entropy"]} '
                                     f'against the global batch\'s {single["entropy"]}')
        expect_counts(f'[parallel] {kind} rank {r}', got['counts'],
                      {k: v * PARALLEL_STEPS for k, v in PARALLEL_PER_STEP[kind].items()})
        report['ranks'].append(entry)
    if any(got['digest'] != ranks[0]['digest'] for got in ranks[1:]):
        raise AssertionError(f'[parallel] {kind}: the ranks\' parameters differ')
    report['identical_parameters'] = True
    report['one_process_median_step_ms'] = float(np.median(single['step_ms']))
    report['one_process_launches'] = single['counts']
    if kind == 'dcn flow':
        report['one_process_entropy'] = single['entropy']
    return report


def d90_stack(seed):
    """The D90 capture's 1424x2144 RGGB stack (normalized, unbalanced)."""
    mosaic, cfa, _ = raw_scene(seed)
    m = (mosaic.astype(np.float32) - RAW_BLACK) / (RAW_WHITE - RAW_BLACK)
    off = bayer._offsets(cfa)
    return np.stack([m[off[p][0]::2, off[p][1]::2] for p in bayer.STACK_PLANES],
                    axis=-1).clip(0, 1)


def parallel_bands(stack, device):
    """Each QualityRef NIP develops the stack in 2 and 4 bands on the card,
    against the whole stack in one forward there; peak memory of each."""
    results = {}
    for name, snapshot in NIP_SNAPSHOTS.items():
        model = base.restore(str(base.REPO_ROOT / snapshot), pipelines, device=device)

        def whole():
            with torch.inference_mode():
                return model.process(stack[None])[0]
        whole()                                                      # warm-up
        t0 = time.perf_counter()
        ref, peak = peak_memory_mb(whole)
        whole_ms = 1e3 * (time.perf_counter() - t0)
        ref = ref.cpu()
        entry = {'whole_ms': whole_ms, 'whole_peak_mib': peak,
                 'halo_rows': spatial.receptive_rows(model)[0]}
        for n in PARALLEL_BANDS:
            report = []
            t0 = time.perf_counter()
            got = spatial.develop_bands(model, stack, [device] * n, report)
            ms = 1e3 * (time.perf_counter() - t0)
            diff = float((got - ref).abs().max())
            if not diff <= MAX_BAND_DIFF:
                raise AssertionError(f'[parallel] {name}: {n} bands differ from the whole '
                                     f'stack by {diff}')
            peaks = [r.get('peak_bytes', 0) / 2 ** 20 for r in report]
            entry[f'{n} bands'] = {'ms': ms, 'max_abs_diff': diff, 'peak_mib': peaks,
                                   'windows': [r['window'] for r in report]}
            print(f'[parallel] {model.model_code} in {n} bands: max |dy| {diff:.3g} against '
                  f'the whole stack; peak per band {max(peaks):.0f} MiB against '
                  f'{peak:.0f} MiB whole ({max(peaks) / max(peak, 1e-9):.2f}); {ms:.1f} ms against '
                  f'{whole_ms:.1f} ms', flush=True)
        results[name] = entry
        del model, ref
        torch.cuda.empty_cache()
    return results


def parallel_two_cards(args, single, n_classes, rank_counts):
    """On a machine with two cards or more: the joint step over NCCL on
    cuda:0 and cuda:1 against the one-process step, and ``train_nip
    --devices 2`` for one epoch; None (and said so) on one card. Adds the
    ranks' launches to ``rank_counts``."""
    if torch.cuda.device_count() < 2:
        print(f'[parallel] two cards: skipped, this machine has {torch.cuda.device_count()} '
              f'card', flush=True)
        return None
    t0 = time.perf_counter()
    two = launch.run(parallel_rank, ['cuda:0', 'cuda:1'], args=(args.seed, ('joint',)),
                     timeout_s=PARALLEL_DEADLINE_S)
    results = check_parallel_kind('joint', [r['joint'] for r in two], single['joint'],
                                  n_classes['joint'])
    for r, got in enumerate(two):
        for name, n in got['joint']['counts'].items():
            rank_counts[r][name] += n
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=60, height=256,
                                         width=384, seed=args.seed)
        cmd = [sys.executable, '-m', 'neural_imaging_tpu_torch.cli.train_nip', '--nip', 'INet',
               '--cam', 'Cam', '--data', data_dir, '--split', '40:20:1', '--epochs', '1',
               '--patch', '64', '--batch', '20', '--val-schedule', '1', '--out',
               os.path.join(tmp, 'nips'), '--devices', '2']
        subprocess.run(cmd, check=True, cwd=base.REPO_ROOT, timeout=PARALLEL_DEADLINE_S)
        progress = json.loads((Path(tmp) / 'nips' / 'Cam' / 'INet_gbrg_5x5' / 'inet'
                               / 'progress.json').read_text())
    results['train_nip_devices_2'] = progress['performance']['loss']
    results['s'] = time.perf_counter() - t0
    print(f'[parallel] two cards: the joint step over NCCL on cuda:0 and cuda:1 (first step '
          f'against the one-process step: gradient norms within '
          f'{max(e["max_grad_norm_rel_diff"] for e in results["ranks"]):.3g}; '
          f'{results["ranks"][0]["median_step_ms"]:.2f} ms a step against '
          f'{results["one_process_median_step_ms"]:.2f} ms; NCCL all-reduce of '
          f'{results["ranks"][0]["all_reduce_floats"]} floats '
          f'{results["ranks"][0]["all_reduce_median_ms"]:.3f} ms), and train_nip --devices 2 '
          f'for one epoch: losses {progress["performance"]["loss"]}', flush=True)
    return results


def parallel_phase(args, device):
    """``[parallel]``: data parallelism and development in bands. Returns
    (this process's launch counts, the ranks' launch counts, results)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    zero_counts()
    # the one-process steps at the global batch, on the card
    single = {kind: parallel_run(None, kind, args.seed) for kind in PARALLEL_KINDS}
    print(f'[parallel] one-process steps at the global batch on {device}: median '
          + ', '.join(f'{kind} {np.median(r["step_ms"]):.2f} ms' for kind, r in single.items())
          + f' ({time.perf_counter() - t_phase:.1f} s)', flush=True)
    n_classes = {kind: parallel_model(kind, 'cpu', args.seed).n_classes
                 for kind in ('joint', 'dcn flow')}

    # NCCL at world size 1: the joint step through DataParallel equals the plain step
    multihost.initialize(f'127.0.0.1:{multihost.free_port()}', 1, 0, device=device)
    try:
        mesh = mesh_lib.make_mesh(device)
        one = parallel_run(ptrain.DataParallel(mesh), 'joint', args.seed)
    finally:
        multihost.shutdown()
    nccl = compare_steps(one['first'], single['joint']['first'])
    max_grad = max(float((g - single['joint']['first'][2][part][k]).abs().max())
                   for part, leaves in one['first'][2].items() for k, g in leaves.items())
    print(f'[parallel] {mesh.backend}, 1 rank on {device}: the joint step through DataParallel against '
          f'the plain step: loss parts within {nccl["max_loss_rel_diff"]:.3g}, gradients '
          f'within {max_grad:.3g} (max |d|); all-reduce of {one["all_reduce"]["floats"]} floats '
          f'{np.median(one["all_reduce"]["ms"]):.3f} ms', flush=True)
    main_counts = read_counts()
    torch.cuda.empty_cache()

    # two ranks sharing cuda:0 over gloo, started by the port's launcher
    t0 = time.perf_counter()
    ranks = launch.run(parallel_rank, [str(device)] * PARALLEL_RANKS, args=(args.seed,
                                                                          PARALLEL_KINDS),
                       backend='gloo', timeout_s=PARALLEL_DEADLINE_S)
    launch_s = time.perf_counter() - t0
    results = {'launch_s': launch_s, 'world_1': {'backend': mesh.backend,
        'max_loss_rel_diff': nccl['max_loss_rel_diff'], 'max_abs_grad_diff': max_grad,
        'all_reduce_ms': one['all_reduce']['ms']}}
    rank_counts = [{name: 0 for name in COUNTERS} for _ in ranks]
    for kind in PARALLEL_KINDS:
        report = check_parallel_kind(kind, [r[kind] for r in ranks], single[kind],
                                     n_classes.get(kind))
        for r, got in enumerate(ranks):
            for name, n in got[kind]['counts'].items():
                rank_counts[r][name] += n
        results[kind] = report
        worst = max(report['ranks'], key=lambda e: e['max_grad_norm_rel_diff'])
        print(f'[parallel] {kind}: 2 ranks on {device} over gloo; first step against the '
              f'one-process step at the global batch: loss parts within '
              f'{worst["max_loss_rel_diff"]:.3g}, gradient norms within '
              f'{worst["max_grad_norm_rel_diff"]:.3g} ({worst["worst_gradient"]}), '
              f'{sum(e["flips"] for e in report["ranks"])} FAN-input values flipped'
              + (f', entropy {report["ranks"][0]["entropy"]:.6f} against '
                 f'{report["one_process_entropy"]:.6f}' if kind == 'dcn flow' else '')
              + f'; median step {report["ranks"][0]["median_step_ms"]:.2f} / '
              f'{report["ranks"][1]["median_step_ms"]:.2f} ms a rank against '
              f'{report["one_process_median_step_ms"]:.2f} ms in one process; gloo all-reduce '
              f'of {report["ranks"][0]["all_reduce_floats"]} floats '
              f'{report["ranks"][0]["all_reduce_median_ms"]:.2f} ms; launches a rank '
              f'{[e["launches"] for e in report["ranks"]]}; parameters bit-identical',
              flush=True)

    # two cards, where the machine has them
    results['two_cards'] = parallel_two_cards(args, single, n_classes, rank_counts)

    # development in bands on cuda:0
    t0 = time.perf_counter()
    stack = d90_stack(args.seed + 1300)
    print(f'[parallel] the {RAW_CAMERA} stack {stack.shape[0]}x{stack.shape[1]}x4 made in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    zero_counts()
    results['bands'] = parallel_bands(stack, device)
    band_counts = read_counts()
    expect_counts('[parallel] bands', band_counts, {})
    counts = {name: main_counts[name] + band_counts[name] for name in COUNTERS}
    results['launches_per_rank'] = rank_counts
    results['phase_s'] = time.perf_counter() - t_phase
    print(f'[parallel] phase {results["phase_s"]:.1f} s (the ranks\' launch '
          f'{launch_s:.1f} s)', flush=True)
    return counts, rank_counts, single, results


# -- the tooling layer ----------------------------------------------------------------------

# the exports: UNet_5 on 20 raw 64-px patches, the m_quality FAN on 20 of
# its 128-px channel outputs, 32c on a 512x512 image (N = 131,072)
TOOLING_TEST_NIP = ('UNet', 'INet')   # test_nip of these QualityRef snapshots, card and CPU
TOOLING_IMAGES = 4
MAX_EXPORT_DIFF = 1e-5      # an exported program against the model's own forward on the card
MAX_TEST_NIP_PSNR_DIFF = 1e-3
DISPATCH_CALLS = 200


def dispatch_us(device, calls=DISPATCH_CALLS):
    """Host microseconds a call of K1's launcher and of its registered
    operator on one 8x8 block, median of ``calls`` calls each taken in turns
    (the device's work queued, not waited for)."""
    planes = torch.zeros((1, 8, 8), device=device)
    q = torch.ones((1, 8, 8), device=device)
    times = {'launcher': [], 'operator': []}
    for _ in range(calls):
        for name, fn in (('launcher', jpeg8x8.jpeg_core_cuda), ('operator', jpeg8x8.jpeg8x8_op)):
            t0 = time.perf_counter()
            fn(planes, q)
            times[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {name: 1e6 * float(np.median(t)) for name, t in times.items()}


def tooling_phase(args, device, medians_ms):
    """The tooling and results layer on the card: ``profiling.step_cost`` and
    ``utilization`` of the m_quality float32 step and bench.py's bfloat16
    step (one step each on flows made for it, at the median step times
    ``medians_ms`` of the training phases), ``op_traffic``'s top 5 of the
    float32 step, ``deploy_model`` → ``torch.export.load`` of UNet_5, the
    m_quality FAN and 32c against their own forward (the exported 32c
    launching K2 through its operator), ``device_memory_stats``, and
    ``test_nip`` of the QualityRef UNet_5 and INet on the card against the
    CPU. Returns (launch counts, results)."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    f32 = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, trainable={'nip'},
                                             rng_seed=args.seed, device=device)
    f32.nan_check = False
    bf16 = bench_flow(device, args.seed)
    (bx, by), = training_batches(args.seed + 900, 1, args.batch)
    results = {'card': smi, 'dispatch_us': dispatch_us(device)}
    print(f'[tooling] host time a K1 call on one 8x8 block: the launcher '
          f'{results["dispatch_us"]["launcher"]:.1f} us, its registered operator '
          f'{results["dispatch_us"]["operator"]:.1f} us', flush=True)
    torch.cuda.synchronize()
    zero_counts()
    for label, flow in (('f32', f32), ('bf16', bf16)):
        t0 = time.perf_counter()
        cost = profiling.step_cost(lambda: flow.training_step(bx, by, TRAIN_LAMBDA_NIP,
                                                              learning_rate=TRAIN_LR))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        util = profiling.utilization(cost['flops'], cost['bytes_accessed'],
                                     medians_ms[label] / 1e3, device)
        k1_share = cost['flops_by_kernel'].get('jpeg8x8', 0) / cost['flops']
        results[label] = {**cost, **util, 'median_ms': medians_ms[label], 'k1_flop_share': k1_share,
                          'counted_s': counted_s}
        print(f'[tooling] {label} step (batch {args.batch}, raw {RAW_PATCH}): '
              f'{cost["flops"]:.6g} FLOP, K1 {100 * k1_share:.3f}% of them; '
              f'{cost["bytes_accessed"]:.6g} bytes; at the median step {medians_ms[label]:.2f} ms: '
              f'MFU {100 * util["mfu"]:.3f}% of {profiling.chip_peaks(device)[0]:.4g} FLOP/s, '
              f'HBM {100 * util["hbm_util"]:.2f}% of {profiling.chip_peaks(device)[1]:.4g} B/s; '
              f'counted in {counted_s:.2f} s; {smi}', flush=True)
    f32.assert_finite()
    bf16.assert_finite()
    top = profiling.op_traffic(lambda: f32.training_step(bx, by, TRAIN_LAMBDA_NIP,
                                                         learning_rate=TRAIN_LR), top=5)
    torch.cuda.synchronize()
    results['f32_top_traffic'] = top
    print(f'[tooling] f32 step traffic: {top[0]["total_bytes"]:.6g} bytes in '
          f'{top[0]["n_instructions"]} calls; top 5:', flush=True)
    for r in top:
        print(f'[tooling]   {r["bytes"]:>12,d} B  {r["name"]:<28} {r["op_name"]}', flush=True)
    step_counts = read_counts()
    expect_counts('tooling: step cost and traffic', step_counts, {'jpeg8x8': 4})

    exports = {}
    unet = base.restore(str(base.REPO_ROOT / NIP_SNAPSHOTS['UNet']), pipelines, device=device)
    dcn = codec.restore(DCN_PRESET, device=device)
    gen = torch.Generator().manual_seed(args.seed + 901)
    with tempfile.TemporaryDirectory() as tmp:
        for name, model, shape in (
                ('UNet_5', unet, (NIP_DEVELOP_BATCH, NIP_RAW_PATCH, NIP_RAW_PATCH, 4)),
                ('fan', f32.fan, (args.batch, 2 * RAW_PATCH // f32.downsampling_factor,
                                  2 * RAW_PATCH // f32.downsampling_factor, 3)),
                (DCN_PRESET, dcn, (1, 512, 512, 3))):
            t0 = time.perf_counter()
            directory = model.deploy_model(os.path.join(tmp, name), batch_size=shape[0],
                                           patch_size=shape[1])
            export_s = time.perf_counter() - t0
            program = torch.export.load(os.path.join(directory, 'model.pt2'))
            kernel_ops = sorted({str(n.target) for n in program.graph.nodes
                                 if 'neural_imaging_tpu_torch' in str(n.target)})
            x = torch.rand(shape, generator=gen).to(device)
            torch.cuda.synchronize()
            before = read_counts()
            with torch.no_grad():
                got = program.module()(x)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
            with torch.no_grad():
                want = model.serve(x)
            got, want = ((t,) if torch.is_tensor(t) else tuple(t) for t in (got, want))
            diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if not diff <= MAX_EXPORT_DIFF or not all(bool(torch.isfinite(a).all()) for a in got):
                raise AssertionError(f'exported {name} differs from the model by {diff}')
            expected = {DCN_PRESET: {'codebook_fwd': 1}, 'fan': fan_passes(1)}.get(name, {})
            expected = {k: v for k, v in expected.items() if v}
            if launched != expected:
                raise AssertionError(f'exported {name} launched {launched}, expected {expected}')
            exports[name] = {'input_shape': list(shape), 'export_s': export_s,
                             'max_abs_diff': diff, 'kernel_ops': kernel_ops, 'launched': launched,
                             'manifest': json.loads(Path(directory, 'manifest.json').read_text())}
            print(f'[tooling] deploy {name} {list(shape)}: exported and saved in {export_s:.2f} s; '
                  f'the reloaded program against the model max |d| {diff:.3g}; kernel operators '
                  f'{kernel_ops}, launched {launched}', flush=True)
    results['exports'] = exports
    stats = debugging.device_memory_stats()
    card = stats[str(torch.device('cuda', 0))]
    live = debugging.live_device_arrays()
    results['memory'] = {'allocated_peak_bytes': card['allocated_bytes.all.peak'],
                         'reserved_current_bytes': card['reserved_bytes.all.current'],
                         'live_tensors': live}
    print(f'[tooling] device_memory_stats: {len(stats)} card(s); peak allocated '
          f'{card["allocated_bytes.all.peak"] / 2 ** 20:.1f} MiB, reserved '
          f'{card["reserved_bytes.all.current"] / 2 ** 20:.1f} MiB; live CUDA tensors {live}',
          flush=True)

    test_nip = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = fixtures.make_dataset(os.path.join(tmp, 'data'), n_images=TOOLING_IMAGES)
        for nip in TOOLING_TEST_NIP:
            scores = {dev: test_nip_cli.main(['--model-dir', str(base.REPO_ROOT / NIP_SNAPSHOTS[nip]),
                                              '--data', data_dir, '--images', str(TOOLING_IMAGES),
                                              '--device', dev])
                      for dev in ('cuda', 'cpu')}
            diff = max(abs(a[0] - b[0]) for a, b in zip(scores['cuda'], scores['cpu']))
            if len(scores['cuda']) != TOOLING_IMAGES or not diff <= MAX_TEST_NIP_PSNR_DIFF:
                raise AssertionError(f'test_nip {nip}: card and CPU PSNR differ by {diff} dB')
            test_nip[nip] = {'psnr_ssim': scores['cuda'], 'cpu_max_psnr_diff_db': diff}
            print(f'[tooling] test_nip {nip}: PSNR/SSIM {scores["cuda"]}; vs the CPU max |dPSNR| '
                  f'{diff:.3g} dB (bound {MAX_TEST_NIP_PSNR_DIFF:g})', flush=True)
    results['test_nip'] = test_nip
    counts = read_counts()
    expect_counts('tooling', counts, {'jpeg8x8': 4, 'codebook_fwd': 2})
    return counts, results


# K1's ragged shapes (P, H, W), checked after its paths' shapes
K1_EDGE_SHAPES = ((1, 8, 8), (3, 64, 136), (3, 48, 392), (3, 8, 4288), (3, 2848, 4288))


# the scenarios of config/tests/framework.json that train the DCN with a fixed
# codebook: K2 forward and K3 backward; the others run no kernel of the port
FRAMEWORK_DCN = ('train-dcn', 'train-manipulation-dcn')


def run_cli_in_process(module, argv, seed=None):
    """The harness's runner for this process: a port CLI's ``main(argv)``;
    whatever it raises propagates. With ``seed``, ``train_dcn``'s host
    augmentations draw from ``np.random.default_rng(seed)`` instead of fresh
    entropy (its patches, weights and the other scenarios' draws already
    come from fixed seeds: the datasets', the models', the flow's)."""
    main = importlib.import_module(module).main
    if seed is not None and module == 'neural_imaging_tpu_torch.cli.train_dcn':
        main(argv, rng=np.random.default_rng(seed))
    else:
        main(argv)
    return 0, ''


def framework_phase(args, device, flush, gen):
    """``[framework]``: every scenario of ``config/tests/framework.json`` at
    its full length through the port's CLIs on the card, checked by the
    harness's ``run_scenario`` at the spec's gates; then K2 and K3 (and K4)
    against their plain versions at each N that the DCN scenarios launched
    them at. Returns ({scenario: launch counts}, results, {N: the kernels'
    records})."""
    root = tempfile.mkdtemp(prefix='framework-')
    cam = framework.DEFAULT_CAM
    try:
        t0 = time.perf_counter()
        framework.prepare_data(root, cam)
        data_s = time.perf_counter() - t0
        counts, results = {}, {}
        for name, spec in framework.load_spec().items():
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            ok, message, gates = framework.run_scenario(
                name, spec, root, cam, device.type,
                run=functools.partial(run_cli_in_process, seed=args.seed))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts[name] = read_counts()
            sizes = {k: dict(sorted(COUNTERS[k].sizes.items()))
                     for k in ('codebook_fwd', 'codebook_bwd')}
            if not ok:
                raise AssertionError(f'[framework] {name}: {message}')
            expected_kernels = ({'codebook_fwd', 'codebook_bwd'} if name in FRAMEWORK_DCN
                                else set())
            launched = {k for k, n in counts[name].items() if n}
            if launched != expected_kernels:
                raise AssertionError(f'[framework] {name}: launches {counts[name]}, expected '
                                     f'{sorted(expected_kernels) or "none"}')
            results[name] = {'seconds': seconds, 'launches': counts[name],
                             'launches_by_n': sizes,
                             'gates': {k: {'value': v, 'threshold': t}
                                       for k, (v, t) in gates.items()}}
            gate_text = ', '.join(f'{k} {v:.4f} (gate {t})' for k, (v, t) in gates.items())
            print(f'[framework] {name}: PASS in {seconds:.1f} s; {gate_text}; launches '
                  f'K1 {counts[name]["jpeg8x8"]}, K2 {counts[name]["codebook_fwd"]}, '
                  f'K3 {counts[name]["codebook_bwd"]}, K4 {counts[name]["codebook_bwd_train"]}; '
                  f'at N (N: launches) K2 {sizes["codebook_fwd"]}, K3 {sizes["codebook_bwd"]}',
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the kernels at the path's own N, after the counted runs
    fwd_n = {n for r in results.values() for n in r['launches_by_n']['codebook_fwd']}
    bwd_n = {n for r in results.values() for n in r['launches_by_n']['codebook_bwd']}
    shapes = {n: check_codebook(f'framework N={n}', n, args.reps, flush, gen, device,
                                backward=n in bwd_n) for n in sorted(fwd_n | bwd_n)}
    return counts, {'data_s': data_s, 'augmentation_seed': args.seed, 'scenarios': results}, shapes


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--requests', type=int, default=5)
    parser.add_argument('--batch', type=int, default=20, help='raw patches per request')
    parser.add_argument('--reps', type=int, default=20, help='timed launches per kernel')
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1

    # 1. environment
    device = resolve_device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f'[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} '
          f'x{torch.cuda.device_count()}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}', flush=True)
    print(smi, flush=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('TF32 must be off on the float32 path')

    # 2. build
    t0 = time.perf_counter()
    libraries = _build.build([jpeg8x8.LIBRARY, codebook.LIBRARY, fan_conv.LIBRARY])
    ans = entropy.build()
    print(f'[build] {len(libraries)} kernel libraries and {ans.name} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    for path in libraries.values():
        log = path.with_suffix('.log')
        if log.exists():
            print('[build] ' + log.read_text().strip().replace('\n', '\n[build] '), flush=True)

    # 3. kernels against their plain versions at their paths' shapes
    flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, device=device)
    n_rows = args.batch * flow.n_classes
    side = 2 * RAW_PATCH
    gen = torch.Generator().manual_seed(args.seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)   # > the 50 MB L2
    k1 = []
    for name, p, h, quality in (('manipulation jpeg:80', 3 * args.batch, side, 80),
                                ('channel QF50', 3 * n_rows, side // flow.downsampling_factor,
                                 flow.codec.quality)):
        planes = (torch.rand((p, h, h), generator=gen) * 255 - 127).to(device)
        q_luma, q_chroma = qtables(int(quality), device)
        q = torch.stack([q_luma, q_chroma, q_chroma]).repeat(p // 3, 1, 1).contiguous()
        k1.append(check_k1(name, planes, q, args.reps, flush))
    k234 = {'serving': check_codebook('serving 512x768', DCN_IMAGE[0] * DCN_IMAGE[1] // 2,
                                      args.reps, flush, gen, device),
            'training': check_codebook('training 16x128^2', DCN_BATCH * DCN_PATCH ** 2 // 2,
                                       args.reps, flush, gen, device, backward=True),
            'dcn flow': check_codebook(
                'dcn flow 50x128^2', DCN_FLOW_LATENT, args.reps, flush, gen, device,
                backward=True)}
    planes = (torch.rand((3 * DCN_FLOW_BATCH, 2 * DCN_FLOW_RAW_PATCH, 2 * DCN_FLOW_RAW_PATCH),
                         generator=gen) * 255 - 127).to(device)
    q_luma, q_chroma = qtables(80, device)
    k1_dcn_flow = check_k1('dcn flow jpeg:80', planes, torch.stack(
        [q_luma, q_chroma, q_chroma]).repeat(DCN_FLOW_BATCH, 1, 1).contiguous(), args.reps, flush)
    # the 8-class flow's channel: 8 classes of each raw patch at QF 50
    n_manip7 = (len(MANIP7) + 1) * args.batch
    planes = (torch.rand((3 * n_manip7, side // flow.downsampling_factor,
                          side // flow.downsampling_factor), generator=gen) * 255 - 127).to(device)
    q_luma, q_chroma = qtables(int(flow.codec.quality), device)
    k1_manip7 = check_k1('manip7 channel QF50', planes, torch.stack(
        [q_luma, q_chroma, q_chroma]).repeat(n_manip7, 1, 1).contiguous(), args.reps, flush)
    # ragged shapes: a lone tile, widths of 17 and 49 tiles, one tile row
    # across the D90's width, the D90's whole image; each launch's grid walk
    # ends part-way through its last step
    k1_edges = [check_k1(f'edge P={p} {h}x{w}', *k1_inputs(p, h, w, 50, gen, device), args.reps,
                         flush) for p, h, w in K1_EDGE_SHAPES]
    k5 = check_fan_conv(args.reps, flush, gen, device)

    # 4. manipulation classification
    batches = [synthetic_raw(args.seed + i, args.batch, RAW_PATCH) for i in range(args.requests)]
    flow.run_workflow_to_decisions(batches[0])          # warm-up (cuDNN autotuning, caches)
    torch.cuda.synchronize()
    zero_counts()
    latencies, decisions = [], []
    for i, batch in enumerate(batches):
        before = jpeg8x8.jpeg_core_cuda.launches
        t0 = time.perf_counter()
        decisions.append(flow.run_workflow_to_decisions(batch))
        latencies.append(time.perf_counter() - t0)
        launched = jpeg8x8.jpeg_core_cuda.launches - before
        print(f'[slice] request {i}: {args.batch} raw {RAW_PATCH}px patches → '
              f'{len(decisions[-1])} decisions in {1e3 * latencies[-1]:.2f} ms, '
              f'K1 launches {launched}', flush=True)
        if launched != 2:
            raise AssertionError(f'request {i} launched K1 {launched} times, expected 2')
    slice_counts = read_counts()
    expect_counts('manipulation classification', slice_counts,
                  {'jpeg8x8': 2 * args.requests, **fan_passes(args.requests)})
    median = float(np.median(latencies))
    print(f'[slice] median request {1e3 * median:.2f} ms: {args.batch / median:.1f} raw patches/s, '
          f'{n_rows / median:.1f} classified images/s', flush=True)

    probs = flow.run_workflow(batches[0])[-1]
    torch.cuda.synchronize()
    if tuple(probs.shape) != (n_rows, flow.n_classes) or not bool(torch.isfinite(probs).all()):
        raise AssertionError(f'bad probabilities: shape {tuple(probs.shape)}')
    row_sums = probs.sum(dim=1)
    if not bool(torch.allclose(row_sums, torch.ones_like(row_sums), atol=1e-5)):
        raise AssertionError(f'probability rows do not sum to 1: {row_sums}')
    if not np.array_equal(probs.argmax(dim=1).cpu().numpy(), decisions[0]):
        raise AssertionError('run_workflow_to_decisions disagrees with run_workflow')
    cpu_flow = ManipulationClassification.restore(RUN_DIR, RAW_PATCH, device='cpu')
    report = compare_probabilities(probs.cpu(), cpu_flow.run_workflow(batches[0])[-1])
    print(f'[slice] request 0 vs the CPU: max |dp| {report["max_abs_diff"]:.3g}, '
          f'{report["decided_rows"]}/{report["rows"]} decided rows agree', flush=True)

    # 5. main-path training
    train_main_counts, train_main = main_path_training(args, device)
    print('[train] ' + json.dumps(train_main), flush=True)

    # 6. bench.py's bfloat16 configuration, and the shipped bf16-INet runs
    bf16_train_counts, bf16_train = bf16_training(args, device)
    print('[bf16 train] ' + json.dumps(bf16_train), flush=True)
    bf16_classify_counts, bf16_classify = bf16_classification(args, device)
    print('[bf16 classify] ' + json.dumps(bf16_classify), flush=True)

    # 7. the trainer
    trainer_counts, trainer_results_ = trainer(args, device)
    print('[trainer] ' + json.dumps(trainer_results_), flush=True)

    # 8.-9. the DCN paths
    serve_counts, serving = dcn_serving(args, device)
    fixed_counts, train_counts, training = dcn_training(args, device)
    print('[dcn] ' + json.dumps({'serving': serving, 'training': training,
                                 'kernel_shapes': k234}), flush=True)

    # 10. the other camera ISPs
    nip_counts, nip_results = nip_development(args, device)
    print('[nip] ' + json.dumps(nip_results), flush=True)
    unet_classify_counts, unet_classify = unet_classification(args, device)
    print('[unet classify] ' + json.dumps(unet_classify), flush=True)
    nip_train_counts, nip_train = {}, {}
    for nip in ('UNet', 'DNet'):
        nip_train_counts[nip], nip_train[nip] = nip_flow_training(args, nip, device)
        print(f'[{nip.lower()} train] ' + json.dumps(nip_train[nip]), flush=True)
    nip_trainer_counts, nip_trainer_results = nip_trainer(args, device)
    print('[nip trainer] ' + json.dumps(nip_trainer_results), flush=True)

    # 11. the DCN channel in the joint flow, and the DCN trainer
    dcn_flow_counts, dcn_flow_results = dcn_flow_phase(args, device)
    print('[dcn flow] ' + json.dumps({**dcn_flow_results, 'k1_shape': k1_dcn_flow}), flush=True)
    dcn_trainer_counts, dcn_trainer_results = dcn_trainer(args, device)
    print('[dcn trainer] ' + json.dumps(dcn_trainer_results), flush=True)

    # 12. all seven manipulations through the joint flow
    manip7_counts, manip7_results = manip7_phase(args, device, flush)
    print('[manip7] ' + json.dumps({**manip7_results, 'k1_shape': k1_manip7}), flush=True)

    # 13. RAW ingestion and full-resolution development
    _, raw_results = raw_phase(args, device)
    print('[raw] ' + json.dumps(raw_results), flush=True)

    # 14. the codec-evaluation layer
    codec_eval_counts, codec_eval = codec_eval_phase(args, device, flush)
    print('[codec eval] ' + json.dumps(codec_eval), flush=True)

    # 15. the last rate-distortion legs and the image readers
    codec_legs_counts, codec_legs = codec_legs_phase(args, device)
    print('[codec legs] ' + json.dumps(codec_legs), flush=True)

    # 16. data parallelism and development in bands
    parallel_counts, parallel_rank_counts, _, parallel_results = parallel_phase(args, device)
    print('[parallel] ' + json.dumps(parallel_results), flush=True)

    # 17. the tooling layer at the training phases' median steps
    tooling_counts, tooling = tooling_phase(args, device, {
        'f32': train_main['median_ms'], 'bf16': bf16_train['median_ms']['bf16']})
    print('[tooling] ' + json.dumps(tooling), flush=True)

    # 18. the end-to-end framework harness, every scenario at full length
    framework_counts, framework_results, framework_shapes = framework_phase(args, device, flush,
                                                                            gen)
    print('[framework] ' + json.dumps(framework_results), flush=True)

    # 19. K1 at every shape its paths launched it at in this process
    print('[k1] launches on the paths by (P, H, W): ' + ', '.join(
        f'{p}x{h}x{w}: {n}' for (p, h, w), n in sorted(K1_PATH_SIZES.items())), flush=True)
    if not K1_PATH_SIZES:
        raise AssertionError('[k1] the paths launched K1 at no shape')
    k1_paths = [dict(check_k1(f'path P={p} {h}x{w}', *k1_inputs(p, h, w, 50, gen, device),
                              args.reps, flush), path_launches=n)
                for (p, h, w), n in sorted(K1_PATH_SIZES.items())]
    print('[k1] ' + json.dumps({'edge_shapes': k1_edges, 'path_shapes': k1_paths}), flush=True)

    # 20. results: K1's numbers are its two launches of one m_quality request,
    # summed; K2's and K3's times are at the DCN flow's shape (N = 409,600),
    # K4's at the DCN training step's; each kernel's error is its largest over
    # every shape it was checked at
    print('[slice] ' + json.dumps({
        'requests': args.requests, 'batch': args.batch,
        'latency_ms': [1e3 * t for t in latencies], 'raw_patches_per_s': args.batch / median,
        'images_per_s': n_rows / median, 'cpu_max_abs_prob_diff': report['max_abs_diff'],
        'k1_shapes': k1}), flush=True)
    kernels = [{'name': 'jpeg8x8', 'route': 'cuda',
                'source': 'neural_imaging_tpu_torch/csrc/jpeg8x8.cu',
                'replaces': 'neural_imaging_tpu/ops/pallas/jpeg8x8.py:34',
                'launches': (slice_counts['jpeg8x8'] + train_main_counts['jpeg8x8']
                             + bf16_train_counts['jpeg8x8'] + bf16_classify_counts['jpeg8x8']
                             + sum(c['jpeg8x8'] for c in trainer_counts.values())
                             + nip_counts['jpeg8x8'] + unet_classify_counts['jpeg8x8']
                             + sum(c['jpeg8x8'] for c in nip_train_counts.values())
                             + sum(c['jpeg8x8'] for c in nip_trainer_counts.values())
                             + dcn_flow_counts['jpeg8x8']
                             + sum(c['jpeg8x8'] for c in manip7_counts)
                             + codec_eval_counts['jpeg8x8'] + parallel_counts['jpeg8x8']
                             + sum(c['jpeg8x8'] for c in parallel_rank_counts)
                             + tooling_counts['jpeg8x8']
                             + sum(c['jpeg8x8'] for c in framework_counts.values())),
                'parallel_launches_per_rank': [c['jpeg8x8'] for c in parallel_rank_counts],
                'max_abs_err': max(r['max_abs_err'] for r in (*k1, k1_dcn_flow, k1_manip7,
                                                               *k1_edges, *k1_paths)),
                'ms': sum(r['ms'] for r in k1),
                'plain_ms': sum(r['plain_ms'] for r in k1),
                'bound_ms': sum(r['bound_ms'] for r in k1),
                'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in k1)
                             else 'operations'),
                'library_ms': None}]
    launches = {name: sum(c[name] for c in (serve_counts, fixed_counts, train_counts,
                                            dcn_flow_counts, dcn_trainer_counts,
                                            codec_eval_counts, codec_legs_counts, parallel_counts,
                                            tooling_counts, *parallel_rank_counts,
                                            *framework_counts.values()))
                for name in ('codebook_fwd', 'codebook_bwd', 'codebook_bwd_train')}
    for name, replaces, shape in (('codebook_fwd', 51, 'dcn flow'),
                                  ('codebook_bwd', 137, 'dcn flow'),
                                  ('codebook_bwd_train', 231, 'training')):
        r = k234[shape][name]
        checked = [records[name] for records in (*k234.values(), *framework_shapes.values())
                   if name in records]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': 'neural_imaging_tpu_torch/csrc/codebook.cu',
                        'replaces': f'neural_imaging_tpu/ops/pallas/codebook.py:{replaces}',
                        'launches': launches[name],
                        'parallel_launches_per_rank': [c[name] for c in parallel_rank_counts],
                        'max_abs_err': max(c['max_abs_err'] for c in checked),
                        'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'], 'library_ms': None})
    for stage in ('fwd', 'dgrad', 'wgrad'):
        name = f'fan_conv_{stage}'
        main_shapes = [r for r in k5 if r['n'] == FAN_ROWS[0]]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': 'neural_imaging_tpu_torch/csrc/fan_conv.cu', 'replaces': None,
                        'launches': (sum(PATH_SIZES[name].values())
                                     + sum(c[name] for c in parallel_rank_counts)),
                        'parallel_launches_per_rank': [c[name] for c in parallel_rank_counts],
                        'sizes': {'x'.join(map(str, shape)): count
                                  for shape, count in sorted(PATH_SIZES[name].items())},
                        'norm_rel_err': max(r[stage]['norm_rel_err'] for r in k5),
                        'ms': sum(r[stage]['ms'] for r in main_shapes),
                        'plain_ms': sum(r[stage]['plain_ms'] for r in main_shapes),
                        'bound_ms': sum(r[stage]['bound_ms'] for r in main_shapes),
                        'bound_by': 'operations',
                        'library_ms': sum(r[f'library_{"fwd" if stage == "fwd" else "bwd"}_ms']
                                          for r in main_shapes)})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
