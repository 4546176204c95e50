"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check raises and the script
exits non-zero without the final ok line):

1. device: the card's name and power limit, the nvcc build of every CUDA
   kernel from ``freqfusion_tpu_torch/csrc`` (one nvcc per source, in
   parallel; seconds, ptxas report, which fails the run on a spill in
   window attention at DRCT-L's head boxes, the fused FFN's products at
   the path's widths, the CAB's convolutions, the 3xTF32 GEMM, GRL's
   mixed attention at GRL-B's head box, the 3x3 convs of the edge
   refinement or the LKABlock's kernels, fp32 and bf16, the bf16 GRL
   mixed attention's persistent kernel at every head box and the bf16
   hierarchical stage 3's six wgmma convs), TF32 off for matmuls and
   convolutions;
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (336x512 LR bucket, NAFNet's levels at
   the 1344x2048 HR size), max-abs error against the stated tolerance,
   the kernel's and the plain version's times and, where one PyTorch call
   computes the same function, that call's (CUDA events, median of 5
   after warm-up), beside the bound the card's peaks set for the work.
   Window attention (#1) runs at DRCT-L's ten shapes, each with its time
   beside a bound of both terms: its products as 3xTF32 on the tensor
   cores (three TF32 products for each fp32 one, at 495 TFLOP/s) and its
   bytes, the bound its entry of the kernels line takes (with the
   fp32-core figure beside it, as for every 3xTF32 kernel); its window-major
   form (#10, on no path) on the same windows partitioned, bit-equal to
   #1 and timed beside it. The fused FFN (#14, six shapes) and the CAB
   (#15, two), also 3xTF32, print the same two-term bound a shape, their
   share of a 336x512 request from the launches it makes at each shape
   (12 a DRCT-L width and 40 GRL-B FFNs; 40 GRL-B and 36 MambaIR CABs),
   and one call's launches by torch.profiler at one or two shapes; the
   NAFBlock (#16, 3xTF32 too) runs at NAFNet's five levels with the same
   two-term bound, the bytes a pixel its nine launches move beside the
   bound's, its share of a request (4, 4, 6, 10 and 12 blocks) and one
   call's launches at C 64 and C 1024. GRL's mixed attention (#2, 3xTF32
   too) runs at GRL-B's two shapes with the same two-term bound (bytes
   bind it) and its share of a request (20 launches a shape).
   The one-pass LayerNorm (#22, on no path) runs
   at 172,032 rows and the experts' six LN widths, beside F.layer_norm.
   The scan's seven contracts (TPU kernels #3-#9) run at L = 172,032,
   D 360, N 16: chain_proj and chain on both chain layouts and spatial on
   the NHWC tensor and its transpose, each direction; flat; four
   directions; bidir as SS2D calls it. Each scan's operations term counts
   its exponentials (one ex2 a state, position and channel) as shared
   between the special-function units (PEAK_SFU) and the fp32 lanes
   (EX2_FMA_FLOPS each), so that both finish together; it binds #3 and
   the bf16 scans, bytes the other fp32 scans.
   For one #3 call (rows, forward)
   and one #5 call it prints each launch's device time (torch.profiler,
   mean of 5 calls). No PyTorch call computes a scan, and the scan's
   plain versions (~1 s a direction) are timed over one run after one
   warm-up. For the in-kernel projection kernels (DRCT's
   qkv window attention at the five widths, shifted and not; GRL's 6-way
   qkv mixed attention, shifted and not; the token attention at both
   fusion-net geometries, P = 172032, with nn.MultiheadAttention as the
   library call) it also prints, beside DRCT's and GRL's, the time of the
   route the gate replaces (F.linear projections around kernels #1 and
   #2); DRCT's (#11, its projections and attention all 3xTF32) also its
   3xTF32 bound a shape, its share of a request (6 launches a shape) and
   one call's launches at C 244; GRL's (#12, likewise) its 3xTF32 bound a
   shape, its share of a request (20 launches a shape) and one shifted
   call's launches (weight split, rows passes, the two GEMMs, the
   attention); the token attention's (#13, its projections 3xTF32, handed
   the module's weight views) the route the gate replaces (the module's
   forward), its 3xTF32 bound a geometry (the attention's fp32-core work a
   third term), its plan, its share of a request (one launch a geometry)
   and one T 4 call's launches (weight layout, attention). For the
   fusion-eval kernels (the
   LKABlock at C 64 and C 128 on the 336x512 bucket; hierarchical stage
   3, the edge fuse and the three edge refine levels at the 1344x2048 HR
   size and below, in the NCHW views the modules hand them) it prints the
   gate-off route (the PyTorch module on cuDNN) beside each; all four run
   their products in 3xTF32, so they also print their two-term bound (the
   LKABlock's depthwise taps and the edge refine's squeeze, on the fp32
   cores, a third term), their share of a request (9 LKABlocks at C 64
   and 4 at C 128, one stage 3, one refine a level, one fuse) and one
   call's launches (the edge kernels at 1344x2048, the refine at 336x512
   too). Last, the three bf16 kernels of the bf16 expert mode at their
   path's shapes, each against its bf16 plain version (two bf16 ulps of
   the output's largest magnitude, max-abs), beside the fp32 kernel's
   time at the same shapes and the bound at the bf16 tensor-core rate
   (989 TFLOP/s; the scan's recurrence at the fp32 cores' and the SFU's
   rates): #1 at DRCT-L's
   ten shapes with SDPA in bf16 as its library call (its bound with the
   mask's bf16 bytes and the softmax's exponentials on the SFU beside the
   products, its share of a request, 6 launches a shape, and one shifted
   C 180 call's launches: one kernel), #2 at GRL-B's two (its bound with
   the mask's bf16 bytes, its share of a request, 20 launches a shape, and
   one shifted call's launches: one kernel),
   #3/#4 on both chain layouts, each direction, with one call's launches
   (the wgmma projection and the passes only); then the bf16 kernels of
   SS2D's other routes on the operands each hands them in bf16 (#5, y
   bf16, on both chain layouts and #9, y fp32, on the NHWC tensor and its
   transpose, each direction; #8, dt, B, C and y fp32, as SS2D calls it),
   #5 within two bf16 ulps and #9 and #8 within the scan tolerance of
   their bf16 plain versions, with one #5 call's launches by
   torch.profiler; then the byte-floor
   kernels' bf16 versions at phase 2's byte-floor shapes (the fused FFN
   #14 at its six and the CAB #15 at its two, each with its share of a
   request and one call's launches, the NAFBlock #16 at NAFNet's
   five levels, the depthwise conv #17 at SS2D's D 360 with cuDNN's bf16
   depthwise F.conv2d as its library call); then the fusion-eval kernels'
   bf16 versions (#18-#21) at their fp32 versions' shapes and layouts, the
   modules and inputs cast to bf16 as fusion_dtype casts them, each beside
   the gate-off route (the bf16 module on cuDNN), the fp32 kernel's time
   and the bound at the bf16 rate (the LKABlock's taps and the refine's
   squeeze on the fp32 cores a third term); then the projection kernels'
   bf16 versions (#11 at DRCT-L's ten shapes, #12 at GRL-B's two, #13 at
   the fusion net's two geometries with nn.MultiheadAttention in bf16 as
   its library call), each beside the bf16 route its gate replaces, the
   fp32 kernel's time and the bound at the bf16 rate (#13's attention on
   the fp32 cores a third term), and one call's launches of each (#12's:
   its wgmma projection and #2's body), #11 and #12 with their share of a
   request (6 and 20 launches a shape);
3. serving, default path: seeded full-width random checkpoints under the
   reference file names, three LR PNGs (128x128, 100x140, 336x512)
   through ``freqfusion_tpu_torch.interface.io.main(..., device="cuda")``,
   output checks, the kernels' launch counts and the seconds per request;
3i. serving other inputs, default path: an 8x12 PNG (shorter than the
   pad to 16), a BMP copy of the 128x128 input (its output equal to phase
   3's) and a JPEG (served where PIL imports, else named and counted as
   skipped) through ``io.main``, with the launch counts per served image;
3b. serving, byte-floor configuration: the same with FREQFUSION_MLP,
   _CAB, _NAFBLOCK and _DWCONV set to "1", its launch counts, and its
   336x512 output against phase 3's (PSNR >= 60 dB);
3d. serving, in-kernel projection configuration: the same with
   FREQFUSION_ATTN_QKV, _GRL_QKV and _TOKEN_ATTN set to "1", its launch
   counts (the qkv kernels replace #1 and #2, which launch 0 times), and
   its 336x512 output against phase 3's (PSNR >= 60 dB);
3e. serving, fusion-eval configuration: the same with FREQFUSION_LKA,
   _HIER and _EDGE set to "1", its launch counts (13 LKABlocks, one
   stage 3, three edge refine levels and one edge fuse per image, and the
   default path's kernels), and its 336x512 output against phase 3's
   (PSNR >= 60 dB);
3f, 3g. serving, SS2D's chainv5 and spatial routes: the same with
   FREQFUSION_SCAN=chainv5 (144 launches of #5 per image) and
   FREQFUSION_SCAN=spatial (144 of #9), #3 launching 0 times, each
   336x512 output against phase 3's (PSNR >= 60 dB);
3h. the bidir route: the full-width MambaIR alone on the 100x140 LR image,
   not padded (neither side a multiple of 8): 36 launches of #8 and no
   other kernel, then the card against the CPU's plain route on the same
   weights at 20x28 (PSNR >= 60 dB); then the same in bf16: 36 launches
   of the bf16 #8 and no other kernel, the output against the fp32 run's
   (PSNR >= 48 dB), the card against the CPU, both in bf16 (>= 48 dB);
3j. serving, bf16 configuration (FREQFUSION_EXPERT_DTYPE=bf16): the three
   LR PNGs through ``python -m freqfusion_tpu_torch.interface.ntire``'s
   main in a subprocess whose working directory holds
   model_zoo/team29_FreqFusionSR (the seeded checkpoints); results.json,
   the outputs, 60, 40 and 144 launches of the three bf16 kernels per
   image and none of an fp32 kernel, the 336x512 output against phase
   3's (PSNR >= 52 dB, the JAX package's composed floor), then each expert
   alone in bf16 against its fp32 output (PSNR >= 48 dB);
3k. serving, bf16 byte-floor configuration (the four byte-floor gates and
   FREQFUSION_EXPERT_DTYPE=bf16) through ``io.main``: 60, 40, 144, 100,
   76, 36 and 36 launches of the seven bf16 kernels per image and none of
   an fp32 kernel, the 336x512 output against phase 3b's fp32 byte-floor
   one (PSNR >= 52 dB);
3l. serving, the experts and the fusion net in bf16 (expert_dtype and
   fusion_dtype bf16, the JAX package's bench mode as bench.py:bench_full
   builds it; a pipeline of its own, since fusion_dtype casts the fusion
   net in place): the three LR PNGs read, served and written as io.main
   does, with the three fusion-eval gates (bf16-fusion-eval: 60, 40, 144,
   13, 1, 3 and 1 launches of the bf16 #1, #2, #3/#4 and #18-#21 per
   image, none of an fp32 kernel, the 336x512 output against phase 3e's
   fp32 fusion-eval one), with the three projection gates
   (bf16-projection: 60, 40, 2 and 144 launches of the bf16 #11, #12, #13
   and #3/#4 per image, none of an fp32 kernel, the 336x512 output
   against phase 3d's fp32 projection one), on SS2D's chainv5 and spatial
   routes (bf16-chainv5, bf16-spatial: 60 and 40 launches of the bf16 #1
   and #2 and 144 of the bf16 #5 or #9 per image, none of #3/#4's or of an
   fp32 kernel, the 336x512 output against phase 3f's or 3g's) and
   without (bf16-fusion: the experts' bf16 kernels only, against phase
   3's), PSNR >= 51 dB each (the JAX package's all-bf16 floor);
3c. the pipeline alone on the 336x512 image in the thirteen
   configurations in turns (default, byte-floor, projection, fusion-eval,
   chainv5, spatial, bf16, bf16-byte-floor, bf16-fusion,
   bf16-fusion-eval, bf16-projection, bf16-chainv5, bf16-spatial, then
   back, after a warm-up of each): seconds per request to the
   synchronised result, without the host's PNG work; then the default
   path's and the seven bf16 configurations' split by stage (each expert
   alone on the same image, CUDA events);
4. card against CPU: the same weights on one 32x48 LR image through the
   kernels on the card and the plain versions on the CPU, for each
   configuration but bf16-fusion and bf16-chainv5; PSNR >= 60 dB (bf16
   experts: both in bf16, >= 48 dB; bf16-fusion-eval, bf16-projection and
   bf16-spatial: the fusion net in bf16 too).

The last three lines are {"kernels": [...]} (each kernel with its launch
count from the run of its own configuration, the bf16 kernels' from 3j,
the byte-floor kernels' bf16 versions' from 3k, the fusion-eval and
projection kernels' and bf16 #5's and #9's from 3l, bf16 #8's from 3h;
#6, #7, #10 and #22 lie on no path),
the card's name and power limit (card: ...), and
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --fused-only
    python3 chip_smoke.py --qkv-only
    python3 chip_smoke.py --fusion-only
    python3 chip_smoke.py --scan-only
    python3 chip_smoke.py --nhwc-attention-only
    python3 chip_smoke.py --grl-only
    python3 chip_smoke.py --token-only
    python3 chip_smoke.py --grl-hier-bf16-only
    python3 chip_smoke.py --bf16-only

run phase 1 and phase 2's four byte-floor kernels, its three in-kernel
projection kernels (fp32, then bf16), its four fusion-eval kernels, the
scan's seven contracts and then its bf16 kernels (#3/#4, #5, #9, #8: the
whole scan body in one call), window attention #1 alone at its ten shapes,
GRL's mixed attention #2 and #12 at GRL-B's two shapes, the token
attention #13 at the fusion net's two geometries (fp32, then bf16), the
bf16 #2, #12 and #19 alone (each as in the bf16 phases below: #12 with
its gate-off route, #19 with its gate-off route and one call's launches),
or the seventeen bf16 kernels, only (to
compare two versions of them in one call; --fusion-only,
--nhwc-attention-only, --grl-only, --grl-hier-bf16-only and --bf16-only
also run beside an older checkout of the package), and print their
summary instead of the ok line.

    python3 chip_smoke.py --pipeline-only [CONFIG]

runs phase 1 and phase 3c's pipeline alone in one configuration (default
unless CONFIG names another, e.g. byte-floor; six runs after a warm-up)
and its split by stage, needing nothing of the port but the pipeline and
its loader: a copy of this script beside an older checkout of the package
times that checkout's pipeline the same way.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATTN_TOL = 1e-4        # fp32 attention, max-abs
SCAN_REL_TOL = 1e-3    # scan, max-abs relative to max |y_ref|
# fused FFN, CAB, NAFBlock, dwconv, the three in-kernel projection kernels
# and the four fusion-eval kernels: fp32 sums of up to 9 x 976 terms in
# another order, max-abs relative to max(1, max |out_ref|)
FUSED_REL_TOL = 1e-4
# one-pass LayerNorm: rsqrtf (2 ulp) and row sums in another order,
# max-abs relative to max(1, max |out_ref|)
LN_REL_TOL = 1e-5
PSNR_MIN = 60.0
PEAK_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_TF32 = 495e12     # H100 SXM TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
PEAK_BF16 = 989e12     # H100 SXM bf16 on the tensor cores, dense
# the special-function units (ex2, rcp, ...): 16 MUFU results a clock per
# SM, 132 SMs, at the H100 SXM's 1.98 GHz boost clock (nvidia-smi
# --query-gpu=clocks.max.sm); the scan's floor is one ex2 a state
PEAK_SFU = 16 * 132 * 1.98e9
# an ex2 on the fp32 lanes instead (csrc/selective_scan.cu:ex2_fma): 11
# instructions (a max, three adds, five FMAs, a shift and an integer add),
# each one issue slot of a lane, two of PEAK_FLOPS's operations
EX2_FMA_FLOPS = 2 * 11
# the bf16 window attention's softmax on the fp32 lanes, issue slots a
# logit: the bias and the mask added, the row max, the shifted exponent,
# the row sum, the normalisation (the exponential itself on the SFU)
SOFTMAX_LANE_OPS = 6
# bf16 kernels against their bf16 plain versions (the same rounding
# points, fp32 sums in another order): max-abs within two bf16 ulps of the
# output's largest magnitude
BF16_ULPS = 2
# bf16 experts (fusion net fp32) against the fp32 pipeline, and each expert
# alone against its fp32 output: the JAX package's floors
# (tests/test_full_geometry.py); the card against the CPU, both in bf16
PSNR_BF16_PIPELINE = 52.0
PSNR_BF16_EXPERT = 48.0
PSNR_BF16_CARD_CPU = 48.0
# the experts and the fusion net in bf16 against fp32: the JAX package's
# all-bf16 floor (tests/test_full_geometry.py:213)
PSNR_BF16_FUSION = 51.0
# ptxas must report no spill for these instantiations: window attention's
# head boxes at DRCT-L's five widths (head dims 30, 53, 122, 46, 77); the
# FFN's up products and its down product at the six path widths (C 180,
# 212, 244, 276, 308: 6, 8, 8, 9, 10 n-tiles a warp); the CAB's convs (4
# and 6 n-tiles a block); the NAFBlock's and #11's GEMM (64 and 128
# columns a block, each epilogue, #12's too); GRL mixed attention's body
# at GRL-B's head box; every instantiation of the 3x3 conv (#19-#21)
# and of #18's kernels, fp32 and bf16; the token attention's (#13) at the
# path's two geometries (T 9 with 8 warps, T 4 with 16) and its layout
# pass; the bf16 scan's passes (every mix, N 16 and any) and its wgmma
# projection
DRCT_HEAD_BOXES = (32, 56, 128, 48, 80)
# GRL mixed attention's head box at GRL-B (head dim 30), csrc/
# grl_attention.cuh, in both sources that build it (#2, #12)
GRL_HEAD_BOX = 32
# csrc/tf32_gemm.cuh's gemm_tf32_kernel<WC, EPI>: every instantiation
GEMM_EPILOGUES = ("bias", "residual", "gate")
# csrc/conv3x3_tf32.cuh's conv_kernel<NT, MT, EPI, MULTI, BF16>: every
# instantiation
CONV_EPILOGUES = ("store", "SpatialGate", "squeeze", "broadcast")
# csrc/hier.cu's bf16 wgmma convs' epilogues (HbEpi)
HIER_EPILOGUES = ("GELU", "SpatialGate", "residuals", "sigmoid out")
FFN_DOWN_TILES = (6, 8, 9, 10)
# csrc/bf16_gemm.cuh's bg_gemm_kernel<A, Epi>: every instantiation (the
# bf16 #13); the bf16 wgmma attention kernels (#1 at every head box, #12's
# projection at every chunk width) too
CAB_CONV_TILES = (4, 6)
# csrc/selective_scan.cu's scan_pass16_kernel<kFinal, kN, kMix>: the bf16
# operand mixes, by the contract each serves (every instantiation, and the
# wgmma projection, must not spill)
SCAN_MIXES = {25: "chain_proj (#3/#4)", 13: "chain (#5)", 5: "spatial (#9)",
              1: "bidir (#8)"}
LR_SIZES = {"a_128x128": (128, 128), "b_100x140": (100, 140),
            "c_336x512": (336, 512)}
# the variables each configuration sets (none: the default path); every
# other configuration's are cleared
CONFIGS = {"default": {},
           "byte-floor": dict.fromkeys(("FREQFUSION_MLP", "FREQFUSION_CAB",
                                        "FREQFUSION_NAFBLOCK",
                                        "FREQFUSION_DWCONV"), "1"),
           "projection": dict.fromkeys(("FREQFUSION_ATTN_QKV",
                                        "FREQFUSION_GRL_QKV",
                                        "FREQFUSION_TOKEN_ATTN"), "1"),
           "fusion-eval": dict.fromkeys(("FREQFUSION_LKA", "FREQFUSION_HIER",
                                         "FREQFUSION_EDGE"), "1"),
           "chainv5": {"FREQFUSION_SCAN": "chainv5"},
           "spatial": {"FREQFUSION_SCAN": "spatial"},
           "bf16": {"FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-byte-floor": {**dict.fromkeys((
               "FREQFUSION_MLP", "FREQFUSION_CAB", "FREQFUSION_NAFBLOCK",
               "FREQFUSION_DWCONV"), "1"), "FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-fusion": {"FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-fusion-eval": {**dict.fromkeys((
               "FREQFUSION_LKA", "FREQFUSION_HIER", "FREQFUSION_EDGE"), "1"),
               "FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-projection": {**dict.fromkeys((
               "FREQFUSION_ATTN_QKV", "FREQFUSION_GRL_QKV",
               "FREQFUSION_TOKEN_ATTN"), "1"),
               "FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-chainv5": {"FREQFUSION_SCAN": "chainv5",
                            "FREQFUSION_EXPERT_DTYPE": "bf16"},
           "bf16-spatial": {"FREQFUSION_SCAN": "spatial",
                            "FREQFUSION_EXPERT_DTYPE": "bf16"}}
# the configurations whose pipeline also runs the fusion net in bf16: the
# constructor's fusion_dtype (no variable sets it), as bench.py:bench_full
# builds the JAX pipeline
FUSION_BF16 = ("bf16-fusion", "bf16-fusion-eval", "bf16-projection",
               "bf16-chainv5", "bf16-spatial")
# phase 4 leaves out bf16-fusion (bf16-fusion-eval runs the same pipeline
# through the kernels) and bf16-chainv5 (bf16-spatial runs the same
# pipeline and projections; phase 2 holds bf16 #5 to its plain version)
NO_CARD_VS_CPU = ("bf16-fusion", "bf16-chainv5")
# launches per image: DRCT 12 RDGs x 5 blocks, GRL sum of depths, MambaIR
# 36 layers x 4 directions
PER_IMAGE = {"window_attention_nhwc": 60, "grl_mixed_attention_nhwc": 40,
             "selective_scan": 144}
# with the four gates: 60 DRCT + 40 GRL FFNs, 40 GRL + 36 MambaIR CABs,
# 36 NAFBlocks, 36 SS2D depthwise convs (NAFBLOCK takes NAFNet's)
PER_IMAGE_GATED = {**PER_IMAGE, "fused_mlp_block": 100, "cab_fused": 76,
                   "nafblock_fused": 36, "dwconv3x3": 36}
# with the three projection gates: the qkv kernels take #1's and #2's
# calls; the fusion net's phases 3 and 4 each run one token attention
PER_IMAGE_QKV = {"window_attention_qkv_nhwc": 60,
                 "grl_mixed_attention_qkv_nhwc": 40, "token_attention": 2,
                 "selective_scan": 144}
# with the three fusion-eval gates: 9 phase-3 + 4 phase-4 LKABlocks, one
# HR stage 3, three pyramid levels, one fuse
PER_IMAGE_FUSION = {**PER_IMAGE, "lka_block_fused": 13,
                    "hier_stage3_fused": 1, "edge_refine_fused": 3,
                    "edge_fuse_fused": 1}
# SS2D's other routes: four #5 or four #9 scans a layer in place of #3's;
# MambaIR alone on an image whose sides are not multiples of 8 takes the
# bidir route, one #8 launch a layer
PER_IMAGE_CHAINV5 = {"window_attention_nhwc": 60,
                     "grl_mixed_attention_nhwc": 40,
                     "selective_scan_chain": 144}
PER_IMAGE_SPATIAL = {"window_attention_nhwc": 60,
                     "grl_mixed_attention_nhwc": 40,
                     "selective_scan_spatial": 144}
PER_IMAGE_BIDIR = {"selective_scan_bidir": 36}
# the experts in bf16: the bf16 kernels take the default path's calls and
# no fp32 kernel launches
PER_IMAGE_BF16 = {"window_attention_nhwc.bf16": 60,
                  "grl_mixed_attention_nhwc.bf16": 40,
                  "selective_scan.bf16": 144}
# the experts in bf16 with the four byte-floor gates: the byte-floor
# kernels' bf16 versions take the gated calls
PER_IMAGE_BF16_GATED = {**PER_IMAGE_BF16, "fused_mlp_block.bf16": 100,
                        "cab_fused.bf16": 76, "nafblock_fused.bf16": 36,
                        "dwconv3x3.bf16": 36}
# the experts and the fusion net in bf16 with the three fusion-eval gates:
# the fusion-eval kernels' bf16 versions take the gated calls
PER_IMAGE_BF16_FUSION = {**PER_IMAGE_BF16, "lka_block_fused.bf16": 13,
                         "hier_stage3_fused.bf16": 1,
                         "edge_refine_fused.bf16": 3,
                         "edge_fuse_fused.bf16": 1}
# the experts and the fusion net in bf16 with the three projection gates:
# the qkv kernels' and the token attention's bf16 versions take the calls
# of #1, #2 and the fusion net's two token attentions
PER_IMAGE_BF16_QKV = {"window_attention_qkv_nhwc.bf16": 60,
                      "grl_mixed_attention_qkv_nhwc.bf16": 40,
                      "token_attention.bf16": 2, "selective_scan.bf16": 144}
# the experts and the fusion net in bf16 on SS2D's chainv5 and spatial
# routes: four bf16 #5 or #9 scans a layer in place of #3/#4's; MambaIR
# alone in bf16 on an image whose sides are not multiples of 8 takes the
# bidir route, one bf16 #8 launch a layer
PER_IMAGE_BF16_CHAINV5 = {"window_attention_nhwc.bf16": 60,
                          "grl_mixed_attention_nhwc.bf16": 40,
                          "selective_scan_chain.bf16": 144}
PER_IMAGE_BF16_SPATIAL = {"window_attention_nhwc.bf16": 60,
                          "grl_mixed_attention_nhwc.bf16": 40,
                          "selective_scan_spatial.bf16": 144}
PER_IMAGE_BF16_BIDIR = {"selective_scan_bidir.bf16": 36}
SOURCES = {
    "window_attention_nhwc": ("freqfusion_tpu_torch/csrc/window_attention.cu",
                              "freqfusion_tpu/ops/pallas_attention.py:238"),
    "window_attention_nhwc.bf16": (
        "freqfusion_tpu_torch/csrc/window_attention.cu",
        "freqfusion_tpu/ops/pallas_attention.py:238"),
    "window_attention": ("freqfusion_tpu_torch/csrc/window_attention.cu",
                         "freqfusion_tpu/ops/pallas_attention.py:95"),
    "grl_mixed_attention_nhwc": ("freqfusion_tpu_torch/csrc/grl_attention.cu",
                                 "freqfusion_tpu/ops/pallas_attention.py:548"),
    "grl_mixed_attention_nhwc.bf16": (
        "freqfusion_tpu_torch/csrc/grl_attention.cu",
        "freqfusion_tpu/ops/pallas_attention.py:548"),
    "selective_scan": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                       "freqfusion_tpu/ops/selective_scan.py:1310"),
    "selective_scan.bf16": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                            "freqfusion_tpu/ops/selective_scan.py:1031"),
    "selective_scan_chain": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                             "freqfusion_tpu/ops/selective_scan.py:771"),
    "selective_scan_flat": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                            "freqfusion_tpu/ops/selective_scan.py:202"),
    "selective_scan_dirs": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                            "freqfusion_tpu/ops/selective_scan.py:346"),
    "selective_scan_bidir": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                             "freqfusion_tpu/ops/selective_scan.py:439"),
    "selective_scan_spatial": ("freqfusion_tpu_torch/csrc/selective_scan.cu",
                               "freqfusion_tpu/ops/selective_scan.py:550"),
    "selective_scan_chain.bf16": (
        "freqfusion_tpu_torch/csrc/selective_scan.cu",
        "freqfusion_tpu/ops/selective_scan.py:771"),
    "selective_scan_spatial.bf16": (
        "freqfusion_tpu_torch/csrc/selective_scan.cu",
        "freqfusion_tpu/ops/selective_scan.py:550"),
    "selective_scan_bidir.bf16": (
        "freqfusion_tpu_torch/csrc/selective_scan.cu",
        "freqfusion_tpu/ops/selective_scan.py:439"),
    "fused_mlp_block": ("freqfusion_tpu_torch/csrc/fused_mlp.cu",
                        "freqfusion_tpu/ops/pallas_mlp.py:85"),
    "fused_mlp_block.bf16": ("freqfusion_tpu_torch/csrc/fused_mlp.cu",
                             "freqfusion_tpu/ops/pallas_mlp.py:85"),
    "cab_fused": ("freqfusion_tpu_torch/csrc/cab.cu",
                  "freqfusion_tpu/ops/pallas_cab.py:174"),
    "cab_fused.bf16": ("freqfusion_tpu_torch/csrc/cab.cu",
                       "freqfusion_tpu/ops/pallas_cab.py:174"),
    "nafblock_fused": ("freqfusion_tpu_torch/csrc/nafblock.cu",
                       "freqfusion_tpu/ops/pallas_nafblock.py:231"),
    "nafblock_fused.bf16": ("freqfusion_tpu_torch/csrc/nafblock.cu",
                            "freqfusion_tpu/ops/pallas_nafblock.py:231"),
    "dwconv3x3": ("freqfusion_tpu_torch/csrc/dwconv.cu",
                  "freqfusion_tpu/ops/pallas_dwconv.py:56"),
    "dwconv3x3.bf16": ("freqfusion_tpu_torch/csrc/dwconv.cu",
                       "freqfusion_tpu/ops/pallas_dwconv.py:56"),
    "window_attention_qkv_nhwc": (
        "freqfusion_tpu_torch/csrc/window_attention_qkv.cu",
        "freqfusion_tpu/ops/pallas_attention.py:709"),
    "grl_mixed_attention_qkv_nhwc": (
        "freqfusion_tpu_torch/csrc/grl_attention_qkv.cu",
        "freqfusion_tpu/ops/pallas_attention.py:795"),
    "token_attention": ("freqfusion_tpu_torch/csrc/token_attention.cu",
                        "freqfusion_tpu/ops/pallas_token_attention.py:78"),
    "window_attention_qkv_nhwc.bf16": (
        "freqfusion_tpu_torch/csrc/window_attention_qkv.cu",
        "freqfusion_tpu/ops/pallas_attention.py:709"),
    "grl_mixed_attention_qkv_nhwc.bf16": (
        "freqfusion_tpu_torch/csrc/grl_attention_qkv.cu",
        "freqfusion_tpu/ops/pallas_attention.py:795"),
    "token_attention.bf16": ("freqfusion_tpu_torch/csrc/token_attention.cu",
                             "freqfusion_tpu/ops/pallas_token_attention.py:78"),
    "lka_block_fused": ("freqfusion_tpu_torch/csrc/lka.cu",
                        "freqfusion_tpu/ops/pallas_lka.py:153"),
    "hier_stage3_fused": ("freqfusion_tpu_torch/csrc/hier.cu",
                          "freqfusion_tpu/ops/pallas_hier.py:147"),
    "edge_refine_fused": ("freqfusion_tpu_torch/csrc/edge.cu",
                          "freqfusion_tpu/ops/pallas_edge.py:143"),
    "edge_fuse_fused": ("freqfusion_tpu_torch/csrc/edge.cu",
                        "freqfusion_tpu/ops/pallas_edge.py:255"),
    "lka_block_fused.bf16": ("freqfusion_tpu_torch/csrc/lka.cu",
                             "freqfusion_tpu/ops/pallas_lka.py:153"),
    "hier_stage3_fused.bf16": ("freqfusion_tpu_torch/csrc/hier.cu",
                               "freqfusion_tpu/ops/pallas_hier.py:147"),
    "edge_refine_fused.bf16": ("freqfusion_tpu_torch/csrc/edge.cu",
                               "freqfusion_tpu/ops/pallas_edge.py:143"),
    "edge_fuse_fused.bf16": ("freqfusion_tpu_torch/csrc/edge.cu",
                             "freqfusion_tpu/ops/pallas_edge.py:255"),
    "fused_layernorm": ("freqfusion_tpu_torch/csrc/layernorm.cu",
                        "freqfusion_tpu/ops/layernorm.py:70"),
}


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operations_ms(flops: float, peak_flops: float = PEAK_FLOPS,
                  core_flops: float = 0.0, sfu_ops: float = 0.0):
    """The operations term of a bound in ms, and the SFU's time alone for
    `sfu_ops` exponentials. `flops` run at `peak_flops` and `core_flops`
    on the fp32 cores beside them. Where the exponentials take the SFU
    longer than that, part of them can move to the fp32 lanes (ex2_fma):
    with e the SFU's time for all of them, f the lanes' work and g the
    exponentials' time on the lanes, a share x = (f + g) / (e + g) on the
    SFU has both units finish at e x = e (f + g) / (e + g), below e and
    above f. Products on the tensor cores (`peak_flops` not the fp32
    cores') run beside both units: the term is then the larger of their
    time and that of the lanes and the SFU (the bf16 window attention's
    softmax, `core_flops` and `sfu_ops` beside its products)."""
    tensor = peak_flops != PEAK_FLOPS
    products = 1e3 * flops / peak_flops if tensor else 0.0
    ms = max(0.0 if tensor else 1e3 * flops / PEAK_FLOPS,
             1e3 * core_flops / PEAK_FLOPS)
    sfu_ms = 1e3 * sfu_ops / PEAK_SFU
    if sfu_ms > ms:
        emu_ms = 1e3 * sfu_ops * EX2_FMA_FLOPS / PEAK_FLOPS
        ms = sfu_ms * (ms + emu_ms) / (sfu_ms + emu_ms)
    return max(products, ms), sfu_ms


class KernelCheck:
    """Error, times and bound of one kernel against its plain version (and
    the one PyTorch call that computes the same function, where there is
    one), summed over the shapes it is checked at."""

    def __init__(self, name: str):
        self.name, self.err, self.ms, self.plain_ms = name, 0.0, 0.0, 0.0
        self.library_ms = self.route_off_ms = None
        self.flop_ms = self.byte_ms = self.bound_ms = 0.0
        self.fp32_core_bound_ms = None
        self.shapes = []

    def run(self, label: str, kernel, plain, tol_of, flops: float,
            nbytes: float, library=None, plain_reps: int = 5,
            peak_flops: float = PEAK_FLOPS, core_flops: float = 0.0,
            sfu_ops: float = 0.0) -> float:
        """`flops` and `nbytes` count the operations the function does on
        these inputs and the bytes it must move (each input read once,
        each output written once); `peak_flops` is the rate of the units
        its operations run on (the fp32 cores unless given); `core_flops`
        the work that stays on the fp32 cores beside tensor-core products,
        a third term, and `sfu_ops` the exponentials it needs (the scan's
        ex2, one a state; operations_ms shares them between the SFU and
        the fp32 lanes). The bound is the larger of operations and bytes.
        The plain
        version is timed over `plain_reps` runs after min(2, plain_reps)
        warm-ups, twice; with `plain_reps` 1 (the scan's plain versions,
        seconds a run) once, the comparison's run its warm-up. Returns the
        kernel's time in ms."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        refs = want if isinstance(want, tuple) else (want,)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(outs, refs))
        tol = tol_of(refs)
        del got, want, outs, refs
        warm = min(2, plain_reps) if plain_reps > 1 else 0
        plain_ms, ms = cuda_ms(plain, plain_reps, warm), cuda_ms(kernel)
        lib_ms = None
        if library is not None:
            lib_ms = (cuda_ms(library) + cuda_ms(library)) / 2
        ms2 = cuda_ms(kernel)
        plain_ms2 = (cuda_ms(plain, plain_reps, warm) if plain_reps > 1
                     else plain_ms)
        ms, plain_ms = (ms + ms2) / 2, (plain_ms + plain_ms2) / 2
        flop_ms, sfu_ms = operations_ms(flops, peak_flops, core_flops,
                                        sfu_ops)
        byte_ms = 1e3 * nbytes / PEAK_BYTES
        lib = "" if lib_ms is None else f"  library {lib_ms:.3f} ms"
        reps = "" if plain_reps == 5 else f" (median of {plain_reps})"
        print(f"  {self.name} {label}: max_abs_err {err:.3e} (tol {tol:.3e})"
              f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{reps}{lib}"
              f"  bound {max(flop_ms, byte_ms):.3f} ms "
              f"({'operations' if flop_ms >= byte_ms else 'bytes'}"
              + (f"; SFU and fp32 lanes {flop_ms:.3f} ms, SFU alone "
                 f"{sfu_ms:.3f}" if sfu_ops else "") + ")")
        if not err <= tol:
            raise AssertionError(f"{self.name} {label}: error {err} > {tol}")
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + lib_ms
        self.flop_ms += flop_ms
        self.byte_ms += byte_ms
        self.bound_ms += max(flop_ms, byte_ms)
        self.shapes.append(label)
        return ms

    def tensor_core_bound(self, ops_ms: float, bytes_ms: float,
                          bound_ms: float) -> None:
        """Take the two-term 3xTF32 bound (operations as three TF32
        products on the tensor cores, bytes), summed over the shapes, as
        the bound of a kernel whose products run there; the fp32-core
        figure stays beside it as `fp32_core_bound_ms`."""
        self.fp32_core_bound_ms = self.bound_ms
        self.flop_ms, self.byte_ms, self.bound_ms = ops_ms, bytes_ms, bound_ms

    def route(self, label: str, on, off, what_off: str) -> None:
        """Time the gated route (`on`, the kernel and what the module does
        around it) against the route the gate replaces (`off`), in turns."""
        on_ms, off_ms = cuda_ms(on), cuda_ms(off)
        off_ms = (off_ms + cuda_ms(off)) / 2
        on_ms = (on_ms + cuda_ms(on)) / 2
        print(f"  {self.name} {label}: gate on {on_ms:.3f} ms, gate off "
              f"({what_off}) {off_ms:.3f} ms")
        self.route_off_ms = (self.route_off_ms or 0.0) + off_ms

    def entry(self, launches: int) -> dict:
        return {"name": self.name, "route": "cuda",
                "source": SOURCES[self.name][0],
                "replaces": SOURCES[self.name][1], "launches": launches,
                "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": ("operations" if self.flop_ms >= self.byte_ms
                             else "bytes"),
                "library_ms": self.library_ms,
                "fp32_core_bound_ms": self.fp32_core_bound_ms,
                "ms_covers": self.shapes,
                "gate_off_route_ms": self.route_off_ms}


class TensorCoreBound:
    """A 3xTF32 kernel's time at each shape beside the bound of both terms
    (its products as three TF32 products on the tensor cores at 495
    TFLOP/s, and its bytes), and its share of a 336x512 request from the
    launches a request makes at each shape."""

    def __init__(self, name: str):
        self.name = name
        self.ops_ms = self.bytes_ms = self.bound_ms = 0.0
        self.request_ms = self.request_loss = 0.0
        self.launches = 0

    def shape(self, label: str, ms: float, flops: float, nbytes: float,
              per_request: int, core_flops: float = 0.0) -> None:
        """`flops` are the products' (on the tensor cores); `core_flops`
        the work that stays on the fp32 cores beside them (the LKABlock's
        depthwise taps), a third term of the bound: the units run side by
        side, so the bound is the largest term, not their sum."""
        ops_ms = 1e3 * 3 * flops / PEAK_TF32
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        core_ms = 1e3 * core_flops / PEAK_FLOPS
        bound = max(ops_ms, bytes_ms, core_ms)
        self.ops_ms += ops_ms
        self.bytes_ms += bytes_ms
        self.bound_ms += bound
        self.request_ms += per_request * ms
        self.request_loss += per_request * (ms - bound)
        self.launches += per_request
        print(f"  {self.name} {label}: {ms:.3f} ms against a 3xTF32 bound "
              f"of {bound:.3f} ms (operations {ops_ms:.3f} ms: 3 x "
              f"{flops / 1e9:.1f} GFLOP at 495 TFLOP/s; bytes "
              f"{bytes_ms:.3f} ms" + (
                  f"; fp32-core work {core_ms:.3f} ms" if core_flops else "")
              + f"); {per_request} a request: "
              f"{per_request * ms:.2f} ms, {per_request * (ms - bound):.2f} "
              "ms above the bound")

    def total(self, check: "KernelCheck") -> None:
        """Print the sums and make them `check`'s bound."""
        print(f"  {self.name}, the {len(check.shapes)} shapes: "
              f"{check.ms:.3f} ms against a 3xTF32 bound of "
              f"{self.bound_ms:.3f} ms (operations {self.ops_ms:.3f}, bytes "
              f"{self.bytes_ms:.3f}; fp32 cores {check.flop_ms:.3f}); a "
              f"336x512 request ({self.launches} launches): "
              f"{self.request_ms:.2f} ms, {self.request_loss:.2f} ms above "
              "the bound")
        check.tensor_core_bound(self.ops_ms, self.bytes_ms, self.bound_ms)


class RequestShare:
    """A kernel's time at each shape beside the bound KernelCheck.run
    computed for it, and its share of a 336x512 request from the launches
    a request makes at each shape (the bf16 kernels' counterpart of
    TensorCoreBound, whose bound is KernelCheck's own)."""

    def __init__(self, check: KernelCheck):
        self.check = check
        self.request_ms = self.request_bound = 0.0
        self.launches = 0

    def run(self, label: str, per_request: int, *args, **kwargs) -> float:
        """KernelCheck.run(label, *args, **kwargs), then the shape's share
        of a request."""
        before = self.check.bound_ms
        ms = self.check.run(label, *args, **kwargs)
        bound = self.check.bound_ms - before
        self.request_ms += per_request * ms
        self.request_bound += per_request * bound
        self.launches += per_request
        print(f"  {self.check.name} {label}: {per_request} a request: "
              f"{per_request * ms:.3f} ms against a bound of "
              f"{per_request * bound:.3f} ms")
        return ms

    def total(self) -> None:
        print(f"  {self.check.name}, a 336x512 request ({self.launches} "
              f"launches): {self.request_ms:.3f} ms against a bound of "
              f"{self.request_bound:.3f} ms, "
              f"{self.request_ms - self.request_bound:.3f} ms above it")


def fused_tol(refs) -> float:
    return FUSED_REL_TOL * max(1.0, refs[0].abs().max().item())


def ln_tol(refs) -> float:
    return LN_REL_TOL * max(1.0, refs[0].abs().max().item())


def phase_window_kernels(dev, randn, checks, window_major: bool = True
                         ) -> None:
    """Kernel #1 at DRCT-L's ten shapes (five widths, shifted and not) on
    the 336x512 bucket's NHWC tensors, and (`window_major`) #10 on the same
    windows partitioned ([672, 256, C]), its output held bit-equal to #1's
    and its time printed beside #1's. SDPA on the partitioned, head-split
    windows is both kernels' library yardstick."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        window_attention_nhwc, window_attention_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask, window_partition)

    def attn_tol(_):
        return ATTN_TOL

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    wa = checks["window_attention_nhwc"] = KernelCheck("window_attention_nhwc")
    tc_bound = {"operations": 0.0, "bytes": 0.0, "bound": 0.0}
    if window_major:
        from freqfusion_tpu_torch.ops.attention import (
            window_attention, window_attention_reference)
        wm = checks["window_attention"] = KernelCheck("window_attention")
    for c, heads in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        q, k, v = (randn(1, h, w, c) for _ in range(3))
        bias = randn(heads, 256, 256, scale=0.5)
        hd = c // heads
        # the library yardstick: SDPA on pre-partitioned windows with the
        # additive bias (+ mask) materialised per window
        qw, kw, vw = (window_partition(t, 16).contiguous() for t in (q, k, v))
        qh, kh, vh = (t.view(-1, 256, heads, hd).transpose(1, 2).contiguous()
                      for t in (qw, kw, vw))
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            add = bias[None] if mask is None else bias[None] + mask[:, None]
            args = (q, k, v, bias, mask, heads, 16)
            nbytes = 4 * (4 * p * c + bias.numel()
                          + (0 if mask is None else mask.numel()))
            label = f"C{c}/hd{hd}/{'mask' if shift else 'nomask'}"

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=add,
                                                      scale=hd ** -0.5)
            flops = 4.0 * p * 256 * c
            ms_nhwc = wa.run(label, lambda: window_attention_nhwc(*args),
                             lambda: window_attention_nhwc_reference(*args),
                             attn_tol, flops, nbytes, sdpa)
            ops_ms = 1e3 * 3 * flops / PEAK_TF32
            bytes_ms = 1e3 * nbytes / PEAK_BYTES
            tc_bound["operations"] += ops_ms
            tc_bound["bytes"] += bytes_ms
            tc_bound["bound"] += max(ops_ms, bytes_ms)
            print(f"  window_attention_nhwc {label}: {ms_nhwc:.3f} ms against "
                  f"a 3xTF32 bound of {max(ops_ms, bytes_ms):.3f} ms "
                  f"(operations {ops_ms:.3f} ms: 3 x {flops / 1e9:.1f} GFLOP "
                  f"at 495 TFLOP/s; bytes {bytes_ms:.3f} ms)")
            if window_major:
                wargs = (qw, kw, vw, bias, mask, heads)
                ms_wm = wm.run(label, lambda: window_attention(*wargs),
                               lambda: window_attention_reference(*wargs),
                               attn_tol, 4.0 * p * 256 * c, nbytes, sdpa)
                same = torch.equal(window_attention(*wargs), window_partition(
                    window_attention_nhwc(*args), 16))
                print(f"  window_attention {label}: {ms_wm:.3f} ms against "
                      f"#1's {ms_nhwc:.3f} ms on the same windows; outputs "
                      f"{'bit-equal' if same else 'DIFFER'}")
                if not same:
                    raise AssertionError(f"window_attention {label}: output "
                                         "differs from #1's")
            del add
        del q, k, v, qw, kw, vw, qh, kh, vh
    print(f"  window_attention_nhwc, the ten shapes: {wa.ms:.3f} ms against a "
          f"3xTF32 bound of {tc_bound['bound']:.3f} ms (operations "
          f"{tc_bound['operations']:.3f}, bytes {tc_bound['bytes']:.3f}; "
          f"fp32 cores {wa.flop_ms:.3f})")
    # #10 does #1's work on the same windows: the same bound
    for check in (wa, wm) if window_major else (wa,):
        check.tensor_core_bound(tc_bound["operations"], tc_bound["bytes"],
                                tc_bound["bound"])
    torch.cuda.empty_cache()


def _ptxas_entries(log: str):
    """(mangled name, registers, spill-store bytes) of each entry in a
    ptxas -v report."""
    import re

    entries, name, spill = [], None, 0
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name, spill = hit.group(1), 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            entries.append((name, regs, spill))
            name = None
    return entries


def check_spills(log: str, required: bool) -> None:
    """Print ptxas's registers and spills for the instantiations named
    above (window attention's at DRCT-L's head boxes, csrc/
    window_attention.cuh, in every source that builds them; the FFN's up
    and down products, csrc/fused_mlp.cu; the CAB's convs, csrc/cab.cu;
    the 3xTF32 GEMM of csrc/tf32_gemm.cuh in nafblock.cu and
    window_attention_qkv.cu; the bf16 wgmma GEMM of csrc/bf16_wgmma.cuh
    and the NAFBlock's two bf16 kernels built on it, in
    window_attention_qkv.cu and nafblock.cu; the 3x3 conv of csrc/conv3x3_tf32.cuh in
    hier.cu and edge.cu; the LKABlock's three kernels, csrc/lka.cu; the
    token attention's at the path's two geometries and its layout pass,
    csrc/token_attention.cu; the bf16 window attention's wgmma kernel at
    every head box, csrc/window_attention.cu, and #12's wgmma projection,
    csrc/grl_attention_qkv.cu) and
    raise if one spills, or (`required`) if one of the groups has no
    report."""
    import re

    groups = {
        "window attention": (r"window_attention_kernelILi(\d+)ELb([01])E",
                             lambda m: int(m.group(1)) in DRCT_HEAD_BOXES,
                             lambda m: f"head box {m.group(1)}"
                             + (" (window-major)" if m.group(2) == "1"
                                else "")),
        "fused FFN (#14)": (r"ffn_up_kernelILi(\d)E|ffn_down_kernelILi(\d+)E",
                            lambda m: m.group(1) or int(m.group(2))
                            in FFN_DOWN_TILES,
                            lambda m: f"up, {64 * int(m.group(1))} columns"
                            if m.group(1) else
                            f"down, {m.group(2)} n-tiles a warp"),
        "CAB conv (#15)": (r"cab_conv_kernelILi(\d+)E",
                           lambda m: int(m.group(1)) in CAB_CONV_TILES,
                           lambda m: f"{m.group(1)} n-tiles a block"),
        "3xTF32 GEMM (#16, #11, #12)": (
            r"(nafblock|window_attention_qkv|grl_attention_qkv)_cu.*"
            r"gemm_tf32_kernelILi(\d)ELi(\d)E",
            lambda m: True,
            lambda m: f"{m.group(1)}.cu, {64 * int(m.group(2))} columns, "
                      f"{GEMM_EPILOGUES[int(m.group(3))]} epilogue"),
        "GRL attention (#2, #12)": (
            r"(grl_attention(?:_qkv)?)_cu.*grl_attention_kernelILi(\d+)E",
            lambda m: int(m.group(2)) == GRL_HEAD_BOX,
            lambda m: f"{m.group(1)}.cu, head box {m.group(2)}"),
        "3x3 conv (#19, #20, #21; fp32 and bf16)": (
            r"conv3x3_tf3211conv_kernelILi(\d+)ELi(\d+)ELi(\d)ELb([01])E"
            r"Lb([01])E",
            lambda m: True,
            lambda m: ("bf16, " if m.group(5) == "1" else "")
                      + f"{m.group(1)} n-tiles x {m.group(2)} m-tiles a warp, "
                      + CONV_EPILOGUES[int(m.group(3))] + " epilogue"
                      + (", several sources" if m.group(4) == "1" else "")),
        "token attention (#13)": (
            r"token_attention_(?:kernelILi(\d)ELi(\d+)ELi(\d+)E|"
            r"(prep)_kernel)",
            lambda m: m.group(4) or m.group(3) != "0",
            lambda m: "layout pass" if m.group(4)
            else f"{4 * int(m.group(1))} warps, {m.group(2)} out n-tiles a "
                 f"warp, T {m.group(3)}"),
        "bf16 GEMM (#13)": (
            r"(token_attention)_cu.*bg_gemm_kernelIN\w*?"
            r"(TaRows)\w*?(\d+)(\w+?Epi)E",
            lambda m: True,
            lambda m: f"{m.group(1)}.cu, {m.group(2)} rows, "
                      f"{m.group(4)[:-3]} epilogue"),
        "bf16 wgmma attention (#1, #11, #12)": (
            r"window_attention_wgmma_kernelILi(\d+)ELi(\d)E|"
            r"grl_qkv_wgmma_kernelILi(\d+)E",
            lambda m: True,
            lambda m: (f"window attention, head box {m.group(1)}, "
                       f"{m.group(2)} warpgroup(s)") if m.group(1)
            else f"GRL qkv projection, {m.group(3)} columns a chunk"),
        "bf16 wgmma GEMM (#11, #16)": (
            r"(window_attention_qkv|nafblock)_cu\w*?(?:bw_gemm_kernelILi(\d)E"
            r"Li(\d+)ENS_\d+(\w+?)ENS_\d+(\w+?)Epi|"
            r"bw_tiled_kernelILi(\d+)ENS_\d+(\w+?)Epi|"
            r"naf_(gate|apply)_wgmma_kernel(?:ILi(\d+)E)?|"
            r"naf_tiled_rows_kernelILb([01])E(f|13__nv_bfloat16)E|"
            r"naf_(dwgate)_kernel)",
            lambda m: True,
            lambda m: (f"{m.group(1)}.cu, whole A, {m.group(3)} columns, "
                       f"{m.group(2)} warpgroup(s), {m.group(4)} rows, "
                       f"{m.group(5)} epilogue") if m.group(2)
            else (f"nafblock.cu, both streamed, {m.group(6)} columns, "
                  f"{m.group(7)} epilogue") if m.group(6)
            else "nafblock.cu, pass A (gate)" if m.group(8) == "gate"
            else f"nafblock.cu, pass B, {m.group(9)} columns" if m.group(8)
            else (f"nafblock.cu, tiled rows, "
                  f"{'LN' if m.group(10) == '1' else 'g s'} of "
                  f"{'fp32' if m.group(11) == 'f' else 'bf16'}")
            if m.group(10) else "nafblock.cu, depthwise gate"),
        "bf16 wgmma FFN and CAB (#14, #15)": (
            r"ffn_(up|down)_wgmma_kernelILi(\d+)E(?:Li(\d+)E)?|"
            r"cab_conv(1|2)_kernel(?:ILi(\d+)E)?",
            lambda m: True,
            lambda m: (f"FFN {m.group(1)}, {m.group(2)} columns"
                       + (f" x {m.group(3)} chunks" if m.group(3) else ""))
            if m.group(1) else (f"CAB conv{m.group(4)}, "
                                + (f"N {m.group(5)}" if m.group(5)
                                   else "96 columns a pass"))),
        "LKA (#18; fp32 and bf16)": (
            r"lka_(mix)(_bf16)?_kernelILi(\d+)ELi(\d+)ELi(\d+)E|"
            r"lka_(dw|prep)(_bf16)?_kernel(?:ILb([01])E)?",
            lambda m: True,
            lambda m: (f"{'bf16 ' if m.group(2) else ''}mix, Cp "
                       f"{m.group(3)}, {32 * int(m.group(4))} rows, "
                       f"{m.group(5)} stages") if m.group(1)
                      else (f"{'bf16 ' if m.group(7) or m.group(8) == '1' else ''}"
                            f"{m.group(6)} pass")),
        "bf16 GRL attention (#2, #12)": (
            r"grl_bf16_kernelILi(\d+)ELb([01])E",
            lambda m: True,
            lambda m: f"head box {m.group(1)}, "
                      + ("4-byte" if m.group(2) == "1" else "2-byte")
                      + " fragments"),
        "bf16 hierarchical stage 3 (#19)": (
            r"hier_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d)ELb([01])E",
            lambda m: True,
            lambda m: f"Cin {m.group(1)}, N {m.group(2)}, {m.group(3)} rows, "
                      + HIER_EPILOGUES[int(m.group(4))]
                      + (", s3_in gathered" if m.group(5) == "1" else "")),
        "bf16 scan (#3/#4, #5, #8, #9)": (
            r"scan_pass16_kernelILb([01])ELi(\d+)ELi(\d+)E|"
            r"(scan_project_wgmma)_kernel",
            lambda m: True,
            lambda m: "projection (wgmma)" if m.group(4)
            else f"pass {int(m.group(1)) + 1}, N "
                 f"{m.group(2) if m.group(2) != '0' else 'any'}, "
                 + SCAN_MIXES.get(int(m.group(3)), m.group(3))),
    }
    entries = _ptxas_entries(log)
    spilled = []
    for group, (pattern, on_path, label) in groups.items():
        found = 0
        for name, regs, spill in entries:
            m = re.search(pattern, name)
            if not m or not on_path(m):
                continue
            found += 1
            print(f"  {group}, {label(m)}: {regs} registers, {spill} bytes "
                  "spill stores")
            if spill:
                spilled.append(f"{group} {label(m)}")
        if required and not found:
            raise AssertionError(f"no ptxas report for {group}")
    # the bf16 kernels' instantiations: reported, a spill not held against
    # them (simple first versions)
    bf16 = (r"(window_attention_bf16|ta_bf16_attend)_kernelILi(\d+)E|"
            r"dwconv3x3_kernelI(N?S?_?6?Bf16x4|13__nv_bfloat16)E")
    for name, regs, spill in entries:
        m = re.search(bf16, name)
        if m:
            what = (f"{m.group(1)}, head "
                    f"{'dim' if m.group(1) == 'ta_bf16_attend' else 'box'} "
                    f"{m.group(2)}" if m.group(1)
                    else "dwconv, " + ("four channels" if "x4" in m.group(3)
                                       else "one channel") + " a thread")
            print(f"  bf16 {what}: {regs} registers, {spill} bytes spill "
                  "stores (reported)")
    if spilled:
        raise AssertionError(f"ptxas spills in {spilled}")


def phase_layernorm_kernel(dev, randn, checks) -> None:
    """Kernel #22 at 172,032 rows (the 336x512 bucket's tokens) and the
    experts' six LN widths, fp32, with F.layer_norm as the library call.
    Bound: bytes, x in and out once (about 8 operations an element)."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.layernorm import (fused_layernorm,
                                                    fused_layernorm_reference)

    rows = LR_SIZES["c_336x512"][0] * LR_SIZES["c_336x512"][1]
    ln = checks["fused_layernorm"] = KernelCheck("fused_layernorm")
    for c in (180, 212, 244, 276, 308, 360):
        x = randn(rows, c)
        wt, b = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
        ln.run(f"R{rows}/C{c}", lambda: fused_layernorm(x, wt, b),
               lambda: fused_layernorm_reference(x, wt, b), ln_tol,
               8.0 * rows * c, 4 * (2 * rows * c + 2 * c),
               lambda: F.layer_norm(x, (c,), wt, b, 1e-5))
        del x
    torch.cuda.empty_cache()


def phase_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    checks = {}
    phase_window_kernels(dev, randn, checks)
    phase_grl_kernel(dev, randn, checks)
    phase_scan_kernels(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_fused_kernels(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_qkv_kernels(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_fusion_kernels(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_layernorm_kernel(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_bf16_kernels(dev, randn, checks)
    return checks


def phase_grl_kernel(dev, randn, checks) -> None:
    """Kernel #2 at GRL-B's two shapes on the 336x512 bucket (C/2 90, 3 + 3
    heads of 30, 8x8 tiles, 4x4 anchors; shifted with the mask and not),
    each beside the two-term 3xTF32 bound (bytes bind it) and its share of
    a request (20 launches a shape)."""
    from freqfusion_tpu_torch.ops.attention import (
        grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    ga = checks["grl_mixed_attention_nhwc"] = KernelCheck(
        "grl_mixed_attention_nhwc")
    tc = TensorCoreBound("grl_mixed_attention_nhwc")
    halves = [randn(1, h, w, 90) for _ in range(6)]
    anchor = randn(1, h // 2, w // 2, 90)
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        args = (*halves, anchor, *scales, *biases, mask, 3, 3, 8)
        # window half 4 N C2 per pixel (N 64), stripe half 8 Na C2 (Na 16)
        flops = p * 90 * (4.0 * 64 + 8 * 16)
        nbytes = 4 * (8 * p * 90 + anchor.numel()
                      + sum(b.numel() for b in biases)
                      + (0 if mask is None else mask.numel()))
        label = "shift" if shift else "noshift"
        ms = ga.run(label, lambda: grl_mixed_attention_nhwc(*args),
                    lambda: grl_mixed_attention_nhwc_reference(*args),
                    lambda _: ATTN_TOL, flops, nbytes)
        tc.shape(label, ms, flops, nbytes, 20)
    tc.total(ga)
    del halves, anchor
    torch.cuda.empty_cache()


def scan_tol(refs) -> float:
    return SCAN_REL_TOL * max(r.abs().max().item() for r in refs)


def launch_breakdown(label: str, fn, reps: int = 5) -> None:
    """Device time of each kernel that one call of `fn` launches:
    torch.profiler's key_averages by kernel name over `reps` calls, per
    call (the mean launch times the launches a call makes: the profiler
    may miss a launch of the window), one line a kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            per_call = max(1, round(e.count / reps))
            split[e.key] = (us / e.count / 1e3 * per_call, per_call)
    total = sum(ms for ms, _ in split.values())
    print(f"  launches of one {label} call (torch.profiler, {reps} calls): "
          f"{total:.3f} ms of device time")
    if not split:
        print("    the profiler shows no device time")
    for name, (ms, count) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:8.3f} ms  x{count}  {name[:110]}")


def phase_scan_kernels(dev, randn, checks) -> None:
    """The scan's seven contracts (TPU kernels #3-#9) at the 336x512
    bucket's shapes: L = 172,032, D 360, N 16, dt_rank 12, the random
    S6 init's dt bias and A = -(1..16). #3/#4 and #5 on SS2D's two chain
    layouts, rows ([1, 512, 336, D]) and columns ([1, 336, 512, D]), each
    direction; #6 over [1, L, D]; #7 over four directions; #8 as SS2D's
    bidir route calls it; #9 on the NHWC tensor and its transpose, each
    direction. The plain versions take ~1 s per direction here, so they
    are timed over one run after one warm-up (twice). The device time of
    each launch of one #3 call (rows, forward) and one #5 call (T = W,
    forward) is printed beside them."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.selective_scan import (
        selective_scan_bidir, selective_scan_bidir_reference,
        selective_scan_chain, selective_scan_chain_proj,
        selective_scan_chain_proj_reference, selective_scan_chain_reference,
        selective_scan_dirs, selective_scan_dirs_reference,
        selective_scan_flat, selective_scan_flat_reference,
        selective_scan_spatial, selective_scan_spatial_reference)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    d, n, dtr = 360, 16, 12
    g = torch.Generator(device=dev).manual_seed(1)
    xc = randn(1, h, w, d)
    xpw = (torch.rand(44, d, generator=g, device=dev) * 2 - 1) / math.sqrt(d)
    dtw = (torch.rand(d, dtr, generator=g, device=dev) * 2 - 1) / math.sqrt(dtr)

    def s6_bias(*lead):
        dt = torch.exp(torch.rand(*lead, d, generator=g, device=dev)
                       * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    bias = s6_bias()
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(d, 1)
    D = torch.ones(d, device=dev)
    # operations per (position, channel) and direction: 8 per state (exp,
    # the decay and input products, the state update, C h), 8 for
    # softplus/silu/D u; chain_proj adds the 44-wide projection and the
    # rank-12 dt expansion. Bytes per direction of the explicit contracts:
    # u, dt and y [L, D], B and C [L, N], A, D and the bias
    scan_ops = p * d * (8.0 * n + 8)
    sfu = p * d * n  # one ex2 a state: the SFU's share, a direction
    dir_bytes = 4 * (3 * p * d + 2 * p * n + d * (n + 2))
    sc = checks["selective_scan"] = KernelCheck("selective_scan")
    rows = xc.transpose(1, 2).contiguous()
    for label, lay in (("rows", rows), ("cols", xc)):
        for rev in (False, True):
            args = (lay, xpw, dtw, A, D, bias, rev)
            sc.run(f"{label}/{'rev' if rev else 'fwd'}/T{lay.shape[1]}",
                   lambda: selective_scan_chain_proj(*args),
                   lambda: selective_scan_chain_proj_reference(*args),
                   scan_tol, scan_ops + p * d * 2.0 * (44 + dtr),
                   4 * (2 * p * d + d * (44 + dtr + n + 2)), plain_reps=1,
                   sfu_ops=sfu)
            if label == "rows" and not rev:
                launch_breakdown("#3 rows/fwd",
                                 lambda: selective_scan_chain_proj(*args))
    del rows
    torch.cuda.empty_cache()

    def operands(lead):
        """u, dt, B, C as SS2D's routes make them: silu of the conv output,
        dt around 0, B and C of unit scale."""
        return (F.silu(randn(*lead, d)), randn(*lead, d, scale=0.3),
                randn(*lead, n), randn(*lead, n))

    ch = checks["selective_scan_chain"] = KernelCheck("selective_scan_chain")
    sp = checks["selective_scan_spatial"] = KernelCheck(
        "selective_scan_spatial")
    for a, b in ((w, h), (h, w)):
        u, dt, Bm, Cm = operands((1, a, b))
        for rev in (False, True):
            args = (u, dt, A, Bm, Cm, D, bias, rev)
            # [1, a, b, D] is the rows' layout of the chain contract
            # (T = a = W) and the columns' of the spatial one (R = a = W),
            # and the other way round
            tag = f"{a}x{b}/{'rev' if rev else 'fwd'}"
            ch.run(tag, lambda: selective_scan_chain(*args),
                   lambda: selective_scan_chain_reference(*args), scan_tol,
                   scan_ops, dir_bytes, plain_reps=1, sfu_ops=sfu)
            if a == w and not rev:
                launch_breakdown(f"#5 {tag}",
                                 lambda: selective_scan_chain(*args))
            sp.run(tag, lambda: selective_scan_spatial(*args),
                   lambda: selective_scan_spatial_reference(*args), scan_tol,
                   scan_ops, dir_bytes, plain_reps=1, sfu_ops=sfu)
        del u, dt, Bm, Cm
    torch.cuda.empty_cache()

    fl = checks["selective_scan_flat"] = KernelCheck("selective_scan_flat")
    u, dt, Bm, Cm = operands((1, p))
    args = (u, dt, A, Bm, Cm, D, bias)
    fl.run(f"L{p}", lambda: selective_scan_flat(*args),
           lambda: selective_scan_flat_reference(*args), scan_tol, scan_ops,
           dir_bytes, plain_reps=1, sfu_ops=sfu)
    del u, dt, Bm, Cm, args
    torch.cuda.empty_cache()

    # four directions with the S6 init's per-direction dt biases
    A4, D4, bias4 = A.repeat(4, 1, 1), D.repeat(4, 1), s6_bias(4)
    di = checks["selective_scan_dirs"] = KernelCheck("selective_scan_dirs")
    u, dt, Bm, Cm = operands((4, 1, p))
    args = (u, dt, A4, Bm, Cm, D4, bias4)
    di.run(f"K4/L{p}", lambda: selective_scan_dirs(*args),
           lambda: selective_scan_dirs_reference(*args), scan_tol,
           4 * scan_ops, 4 * dir_bytes, plain_reps=1, sfu_ops=4 * sfu)
    # bidir: u [2, 1, L, D] (the row-major and column-major sequences)
    # read by four directions, the last two backward
    bi = checks["selective_scan_bidir"] = KernelCheck("selective_scan_bidir")
    args = (u[:2].contiguous(), dt, A4, Bm, Cm, D4, bias4)
    bi.run(f"4 dirs/L{p}", lambda: selective_scan_bidir(*args),
           lambda: selective_scan_bidir_reference(*args), scan_tol,
           4 * scan_ops, 4 * dir_bytes - 4 * 2 * p * d, plain_reps=1,
           sfu_ops=4 * sfu)
    del u, dt, Bm, Cm, args, xc


def bf16_tol(refs) -> float:
    top = max(r.float().abs().max().item() for r in refs)
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def _beside(checks, name: str, check: KernelCheck) -> None:
    """Print a bf16 kernel's totals beside the fp32 kernel `name`'s time
    at the same shapes, where this run measured it."""
    fp32 = checks.get(name)
    print(f"  {check.name}, the {len(check.shapes)} shapes: "
          f"{check.ms:.3f} ms against a bf16 bound of "
          f"{check.bound_ms:.3f} ms; plain {check.plain_ms:.3f} ms"
          + ("" if check.library_ms is None
             else f"; library {check.library_ms:.3f} ms")
          + ("" if check.route_off_ms is None
             else f"; gate-off route {check.route_off_ms:.3f} ms")
          + ("" if fp32 is None else
             f"; the fp32 kernel {fp32.ms:.3f} ms at the same shapes"))


def phase_bf16_kernels(dev, randn, checks) -> None:
    """The bf16 kernels (the bf16 expert mode) at their path's shapes on the
    336x512 bucket, each against its bf16 plain version (BF16_ULPS), timed
    beside the plain version, one library call where there is one (SDPA in
    bf16 for #1) and the bound at the bf16 tensor-core rate; each total is
    printed beside the fp32 kernel's at the same shapes where this run
    measured it. #1 at DRCT-L's ten shapes (bf16 q, k, v and bias; the
    fp32 mask table, which the wrapper casts to bf16 once, as the JAX
    wrapper casts it), with its share of a request (6 launches a shape),
    its bound counting the mask's bf16 bytes and the softmax's
    exponentials on the SFU beside the products, and one shifted C 180
    call's launches; #2 at GRL-B's two (bf16 halves and anchor, fp32
    scales, biases and mask), #3/#4 on both chain layouts, each direction
    (bf16 xc and weights, fp32 A, bf16 D and dt bias)."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        window_attention_nhwc, window_attention_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask, window_partition)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    beside = functools.partial(_beside, checks)

    wa = checks["window_attention_nhwc.bf16"] = KernelCheck(
        "window_attention_nhwc.bf16")
    share = RequestShare(wa)
    for c, heads in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        q, k, v = (randn(1, h, w, c).to(bf) for _ in range(3))
        bias = randn(heads, 256, 256, scale=0.5).to(bf)
        hd = c // heads
        qh, kh, vh = (window_partition(t, 16).contiguous().view(
            -1, 256, heads, hd).transpose(1, 2).contiguous()
            for t in (q, k, v))
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            add = (bias[None] if mask is None
                   else bias[None] + mask[:, None].to(bf))
            args = (q, k, v, bias, mask, heads, 16)
            # q, k, v, out, the bias table and the mask (bf16, as the JAX
            # wrapper casts it) once each
            nbytes = 2 * (4 * p * c + bias.numel()
                          + (0 if mask is None else mask.numel()))
            logits = p * 256 * heads
            label = f"C{c}/hd{hd}/{'mask' if shift else 'nomask'}"

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=add,
                                                      scale=hd ** -0.5)
            # DRCT-L's 60 blocks: 6 a shape; the softmax's exponentials on
            # the SFU and its other work on the fp32 lanes beside the
            # products (SOFTMAX_LANE_OPS a logit)
            share.run(label, 6, lambda: window_attention_nhwc(*args),
                      lambda: window_attention_nhwc_reference(*args),
                      bf16_tol, 4.0 * p * 256 * c, nbytes, sdpa,
                      peak_flops=PEAK_BF16,
                      core_flops=2.0 * SOFTMAX_LANE_OPS * logits,
                      sfu_ops=logits)
            if c == 180 and shift:
                launch_breakdown(f"#1 bf16 {label}",
                                 lambda: window_attention_nhwc(*args))
            del add
        del q, k, v, qh, kh, vh
    share.total()
    beside("window_attention_nhwc", wa)
    torch.cuda.empty_cache()

    phase_bf16_grl_kernel(dev, randn, checks)
    phase_bf16_chain_proj(dev, randn, checks, beside)
    phase_bf16_scan_kernels(dev, randn, checks, beside)
    phase_bf16_fused_kernels(dev, randn, checks, beside)
    phase_bf16_fusion_kernels(dev, randn, checks, beside)
    phase_bf16_qkv_kernels(dev, randn, checks)


def phase_bf16_chain_proj(dev, randn, checks, beside) -> None:
    """The bf16 #3/#4 (selective_scan_chain_proj on a bf16 xc) on both
    chain layouts, each direction, at phase_scan_kernels' shapes (bf16 xc
    and weights, fp32 A, bf16 D and dt bias), against its bf16 plain
    version (BF16_ULPS), with one call's launches (rows, forward)."""
    from freqfusion_tpu_torch.ops.selective_scan import (
        selective_scan_chain_proj, selective_scan_chain_proj_reference)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    d, n, dtr = 360, 16, 12
    g = torch.Generator(device=dev).manual_seed(1)
    xc = randn(1, h, w, d).to(bf)
    xpw = ((torch.rand(44, d, generator=g, device=dev) * 2 - 1)
           / math.sqrt(d)).to(bf)
    dtw = ((torch.rand(d, dtr, generator=g, device=dev) * 2 - 1)
           / math.sqrt(dtr)).to(bf)
    dt = torch.exp(torch.rand(d, generator=g, device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = (dt + torch.log(-torch.expm1(-dt))).to(bf)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(d, 1)
    D = torch.ones(d, device=dev, dtype=bf)
    sc = checks["selective_scan.bf16"] = KernelCheck("selective_scan.bf16")
    # operations: the recurrence's, which stays on the fp32 cores (the
    # projection with the composed [D + 2N, D] weight, 2 D (D + 2N) a
    # position on the bf16 tensor cores, is ~0.05 ms beside it); bytes: xc
    # and y in bf16, the weight, A, D and the bias
    scan_ops = p * d * (8.0 * n + 8)
    nbytes = 2 * (2 * p * d + d * (d + 2 * n)) + 4 * d * (n + 2)
    rows = xc.transpose(1, 2).contiguous()
    for label, lay in (("rows", rows), ("cols", xc)):
        for rev in (False, True):
            args = (lay, xpw, dtw, A, D, bias, rev)
            sc.run(f"{label}/{'rev' if rev else 'fwd'}/T{lay.shape[1]}",
                   lambda: selective_scan_chain_proj(*args),
                   lambda: selective_scan_chain_proj_reference(*args),
                   bf16_tol, scan_ops, nbytes, plain_reps=1,
                   sfu_ops=p * d * n)
            if label == "rows" and not rev:
                launch_breakdown("#3 bf16 rows/fwd",
                                 lambda: selective_scan_chain_proj(*args))
    beside("selective_scan", sc)
    del rows, xc
    torch.cuda.empty_cache()


def phase_scan_all(dev, randn, checks) -> None:
    """--scan-only: the scan's seven fp32 contracts, then its bf16 kernels
    (#3/#4, #5, #9, #8), so one call compares the whole scan body."""
    phase_scan_kernels(dev, randn, checks)
    beside = functools.partial(_beside, checks)
    phase_bf16_chain_proj(dev, randn, checks, beside)
    phase_bf16_scan_kernels(dev, randn, checks, beside)


def phase_bf16_scan_kernels(dev, randn, checks, beside) -> None:
    """The bf16 kernels of SS2D's other routes at phase_scan_kernels'
    shapes (L = 172,032, D 360, N 16, the S6 init's dt bias in bf16, A =
    -(1..16), D bf16), on the operands each route hands them in bf16: #5
    (chainv5: u, dt, B, C and y bf16) on both chain layouts and #9
    (spatial: u, dt, B, C bf16, y fp32) on the NHWC tensor and its
    transpose, each direction; #8 (bidir: u bf16, dt, B, C and y fp32) as
    SS2D calls it. #5 within BF16_ULPS of its bf16 plain version, #9 and
    #8 within the scan tolerance; each total beside the fp32 kernel's at
    the same shapes. Operations: the recurrence's, on the fp32 cores;
    bytes: each operand in its dtype, read once, y written once. The
    device time of each launch of one #5 call (T = W, forward) follows."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.selective_scan import (
        selective_scan_bidir, selective_scan_bidir_reference,
        selective_scan_chain, selective_scan_chain_reference,
        selective_scan_spatial, selective_scan_spatial_reference)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    d, n = 360, 16
    g = torch.Generator(device=dev).manual_seed(2)

    def s6_bias(*lead):
        dt = torch.exp(torch.rand(*lead, d, generator=g, device=dev)
                       * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(bf)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(d, 1)
    D, bias = torch.ones(d, device=dev, dtype=bf), s6_bias()
    scan_ops = p * d * (8.0 * n + 8)
    sfu = p * d * n
    params = 4 * d * n + 2 * 2 * d

    def operands(lead, dt_dtype):
        """u, dt, B, C as SS2D's routes make them in bf16: silu of the conv
        output, dt around 0, B and C of unit scale."""
        return (F.silu(randn(*lead, d)).to(bf),
                randn(*lead, d, scale=0.3).to(dt_dtype),
                randn(*lead, n).to(dt_dtype), randn(*lead, n).to(dt_dtype))

    ch = checks["selective_scan_chain.bf16"] = KernelCheck(
        "selective_scan_chain.bf16")
    sp = checks["selective_scan_spatial.bf16"] = KernelCheck(
        "selective_scan_spatial.bf16")
    for a, b in ((w, h), (h, w)):
        u, dt, Bm, Cm = operands((1, a, b), bf)
        for rev in (False, True):
            args = (u, dt, A, Bm, Cm, D, bias, rev)
            tag = f"{a}x{b}/{'rev' if rev else 'fwd'}"
            ch.run(tag, lambda: selective_scan_chain(*args, bf),
                   lambda: selective_scan_chain_reference(*args, bf),
                   bf16_tol, scan_ops, 2 * (3 * p * d + 2 * p * n) + params,
                   plain_reps=1, sfu_ops=sfu)
            if a == w and not rev:
                launch_breakdown(f"#5 bf16 {tag}",
                                 lambda: selective_scan_chain(*args, bf))
            sp.run(tag, lambda: selective_scan_spatial(*args),
                   lambda: selective_scan_spatial_reference(*args),
                   scan_tol, scan_ops,
                   2 * (2 * p * d + 2 * p * n) + 4 * p * d + params,
                   plain_reps=1, sfu_ops=sfu)
        del u, dt, Bm, Cm
    beside("selective_scan_chain", ch)
    beside("selective_scan_spatial", sp)
    torch.cuda.empty_cache()

    # bidir: u [2, 1, L, D] bf16 (the row-major and column-major
    # sequences) read by four directions, the last two backward; their dt,
    # B and C fp32
    bi = checks["selective_scan_bidir.bf16"] = KernelCheck(
        "selective_scan_bidir.bf16")
    u, dt, Bm, Cm = operands((4, 1, p), torch.float32)
    args = (u[:2].contiguous(), dt, A.repeat(4, 1, 1), Bm, Cm,
            D.repeat(4, 1), s6_bias(4))
    bi.run(f"4 dirs/L{p}", lambda: selective_scan_bidir(*args),
           lambda: selective_scan_bidir_reference(*args), scan_tol,
           4 * scan_ops,
           2 * 2 * p * d + 4 * (4 * 2 * p * d + 4 * 2 * p * n) + 4 * params,
           plain_reps=1, sfu_ops=4 * sfu)
    beside("selective_scan_bidir", bi)
    del u, dt, Bm, Cm, args
    torch.cuda.empty_cache()


def phase_bf16_fused_kernels(dev, randn, checks, beside) -> None:
    """The byte-floor kernels' bf16 versions at phase_fused_kernels' shapes
    (bf16 x, weights and vectors, as the cast experts hand them), each
    against its bf16 plain version (BF16_ULPS), beside the fp32 kernel's
    time where this run measured it. Bound: the products at the bf16
    tensor-core rate, the elementwise work beside them on the fp32 cores,
    and bf16 bytes (x in, out out, the weights once)."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.cab import cab_fused, cab_fused_reference
    from freqfusion_tpu_torch.ops.dwconv import dwconv3x3, dwconv3x3_reference
    from freqfusion_tpu_torch.ops.mlp import (fused_mlp_block,
                                              fused_mlp_block_reference)
    from freqfusion_tpu_torch.ops.nafblock import (nafblock_fused,
                                                   nafblock_fused_reference)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(bf))

    fm = checks["fused_mlp_block.bf16"] = KernelCheck("fused_mlp_block.bf16")
    share = RequestShare(fm)
    # a request: 12 FFNs at each of DRCT-L's five widths, GRL-B's 40
    for c, ch, pre in ((180, 720, True), (212, 848, True), (244, 976, True),
                       (276, 276, True), (308, 308, True), (180, 360, False)):
        args = (randn(1, h, w, c).to(bf),
                *(t.to(bf) for t in (
                    randn(c, ch, scale=c ** -0.5), randn(ch, scale=0.1),
                    randn(ch, c, scale=ch ** -0.5), randn(c, scale=0.1),
                    1 + randn(c, scale=0.1), randn(c, scale=0.1))), pre)
        share.run(f"C{c}/Ch{ch}/{'pre' if pre else 'post'}",
                  12 if pre else 40, lambda: fused_mlp_block(*args),
                  lambda: fused_mlp_block_reference(*args), bf16_tol,
                  4.0 * p * c * ch, 2 * (2 * p * c + 2 * c * ch + ch + 4 * c),
                  peak_flops=PEAK_BF16, core_flops=20.0 * p * ch)
        if c == 244 or not pre:
            launch_breakdown(f"#14 bf16 C{c}", lambda: fused_mlp_block(*args))
        del args
    share.total()
    beside("fused_mlp_block", fm)
    torch.cuda.empty_cache()

    cb = checks["cab_fused.bf16"] = KernelCheck("cab_fused.bf16")
    share = RequestShare(cb)
    x = randn(1, h, w, 180, scale=0.5).to(bf)
    # a request: GRL-B's 40 CABs, MambaIR's 36
    for form, cr, sq, per_request in (("grl", 45, 18, 40),
                                      ("mambair", 60, 30, 36)):
        wt = tree({"cab_0": _conv_tree(randn, 3, 180, cr),
                   "cab_2": _conv_tree(randn, 3, cr, 180),
                   "ca_1": _conv_tree(randn, 1, 180, 180 // sq),
                   "ca_3": _conv_tree(randn, 1, 180 // sq, 180)})
        ln = skip = None
        if form == "mambair":
            ln = tree(_norm_tree(randn, 180))
            skip = (1 + randn(180, scale=0.2)).to(bf)
        args = (x, wt, ln, skip)
        share.run(f"{form}/C180/Cr{cr}", per_request,
                  lambda: cab_fused(*args),
                  lambda: cab_fused_reference(*args), bf16_tol,
                  36.0 * p * 180 * cr, 2 * (2 * p * 180 + 18 * 180 * cr),
                  peak_flops=PEAK_BF16,
                  core_flops=p * (20.0 * cr + 12 * 180))
        launch_breakdown(f"#15 bf16 {form}", lambda: cab_fused(*args))
    share.total()
    beside("cab_fused", cb)
    del x
    torch.cuda.empty_cache()

    from freqfusion_tpu_torch.ops.wgmma import plan_nafblock_bf16

    nb = checks["nafblock_fused.bf16"] = KernelCheck("nafblock_fused.bf16")
    share = RequestShare(nb)
    for c, (hh, ww), per_request in ((64, (4 * h, 4 * w), 4),
                                     (128, (2 * h, 2 * w), 4),
                                     (256, (h, w), 6),
                                     (512, (h // 2, w // 2), 10),
                                     (1024, (h // 4, w // 4), 12)):
        wt = tree({"norm1": _norm_tree(randn, c),
                   "norm2": _norm_tree(randn, c),
                   "conv1": _conv_tree(randn, 1, c, 2 * c),
                   "conv2": _conv_tree(randn, 3, 2 * c, 2 * c, groups=2 * c),
                   "sca": _conv_tree(randn, 1, c, c),
                   "conv3": _conv_tree(randn, 1, c, c),
                   "conv4": _conv_tree(randn, 1, c, 2 * c),
                   "conv5": _conv_tree(randn, 1, c, c),
                   "beta": randn(c, scale=0.5), "gamma": randn(c, scale=0.5)})
        x = torch.rand(1, hh, ww, c, device=dev).to(bf)
        npx = hh * ww
        share.run(f"C{c}/{hh}x{ww}", per_request,
                  lambda: nafblock_fused(x, wt),
                  lambda: nafblock_fused_reference(x, wt), bf16_tol,
                  npx * 12.0 * c * c, 2 * (2 * npx * c + 7 * c * c + 40 * c),
                  peak_flops=PEAK_BF16, core_flops=npx * 60.0 * c)
        plan = plan_nafblock_bf16(hh, ww, c)
        print(f"  nafblock_fused.bf16 C{c}: {2 if plan.fused else 9} "
              f"launches, {plan.bytes_per_pixel} bytes a pixel by the "
              f"source's count ({1e3 * npx * plan.bytes_per_pixel / PEAK_BYTES:.3f}"
              f" ms at 3.35 TB/s) against the bound's {4 * c}; conv1 over "
              f"{plan.conv1_rows:.2f} rows an output pixel" + (
                  f" (the halo tile {plan.out_tile[0] + 2} x "
                  f"{plan.out_tile[1] + 2})" if plan.fused else ""))
        if c in (64, 1024):
            launch_breakdown(f"#16 bf16 C{c}", lambda: nafblock_fused(x, wt))
        del x, wt
        torch.cuda.empty_cache()
    share.total()
    beside("nafblock_fused", nb)

    dw = checks["dwconv3x3.bf16"] = KernelCheck("dwconv3x3.bf16")
    x = randn(1, h, w, 360).to(bf)
    k = randn(3, 3, 1, 360, scale=1 / 3).to(bf)
    b = randn(360, scale=0.1).to(bf)
    k_torch = k.permute(3, 2, 0, 1).contiguous()
    x_nchw = x.permute(0, 3, 1, 2)
    dw.run("SS2D/D360", lambda: dwconv3x3(x, k, b),
           lambda: dwconv3x3_reference(x, k, b), bf16_tol,
           18.0 * p * 360, 2 * (2 * p * 360 + 10 * 360),
           lambda: F.conv2d(x_nchw, k_torch, b, padding=1, groups=360))
    beside("dwconv3x3", dw)
    del x, x_nchw
    torch.cuda.empty_cache()


def phase_bf16_qkv_kernels(dev, randn, checks) -> None:
    """The projection configuration's kernels in bf16 at their path's
    shapes on the 336x512 bucket, as the cast modules hand them: #11 at
    DRCT-L's five widths, shifted and not (bf16 x, weights, biases and bias
    table, the fp32 mask table); #12 at GRL-B's two shapes (bf16 x,
    x_rolled, anchor, wqkv and bqkv, fp32 scales, biases and mask); then
    #13
    (phase_bf16_token_kernel). Each against its bf16 plain version
    (BF16_ULPS), beside the bf16 route its gate replaces (the bf16 module's
    F.linear projections around #1's or #2's bf16 kernel), the fp32
    kernel's time where this run measured it, and the bound at the bf16
    tensor-core rate (bf16 bytes: x in and out out once, the weights and
    tables once)."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        window_attention_nhwc, window_attention_qkv_nhwc,
        window_attention_qkv_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    wq = checks["window_attention_qkv_nhwc.bf16"] = KernelCheck(
        "window_attention_qkv_nhwc.bf16")
    share = RequestShare(wq)
    for c, heads in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        x = randn(1, h, w, c).to(bf)
        wqkv, wproj = (randn(c, 3 * c, scale=c ** -0.5).to(bf),
                       randn(c, c, scale=c ** -0.5).to(bf))
        bqkv, bproj = (randn(3 * c, scale=0.1).to(bf),
                       randn(c, scale=0.1).to(bf))
        bias = randn(heads, 256, 256, scale=0.5).to(bf)
        w_t, wp_t = wqkv.t().contiguous(), wproj.t().contiguous()
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads, 16)
            label = f"C{c}/hd{c // heads}/{'mask' if shift else 'nomask'}"
            nbytes = (2 * (2 * p * c + 4 * c * c + 4 * c + bias.numel())
                      + (0 if mask is None else 4 * mask.numel()))
            # DRCT-L's 60 blocks: 12 a width (6 unshifted, 6 shifted)
            share.run(label, 6, lambda: window_attention_qkv_nhwc(*args),
                      lambda: window_attention_qkv_nhwc_reference(*args),
                      bf16_tol, 8.0 * p * c * c + 4.0 * p * 256 * c, nbytes,
                      peak_flops=PEAK_BF16)
            if c == 180 and not shift:
                launch_breakdown(f"#11 bf16 {label}",
                                 lambda: window_attention_qkv_nhwc(*args))

            def gate_off():
                q, k, v = (F.linear(x, w_t[i * c:(i + 1) * c],
                                    bqkv[i * c:(i + 1) * c])
                           for i in range(3))
                return F.linear(window_attention_nhwc(q, k, v, bias, mask,
                                                      heads, 16),
                                wp_t, bproj)
            wq.route(label, lambda: window_attention_qkv_nhwc(*args),
                     gate_off, "3 F.linear + bf16 kernel #1 + F.linear")
        del x, args
    share.total()
    _beside(checks, "window_attention_qkv_nhwc", wq)
    torch.cuda.empty_cache()

    phase_bf16_grl_qkv_kernel(dev, randn, checks)
    phase_bf16_token_kernel(dev, randn, checks)


def phase_bf16_token_kernel(dev, randn, checks) -> None:
    """#13 in bf16 at the fusion net's two geometries over the 336x512
    bucket's pixels, the module cast to bf16 handing the kernel its weight
    views: against the bf16 plain version (BF16_ULPS), beside
    nn.MultiheadAttention in bf16 (the library call), the gate-off route
    (the bf16 module's forward), the fp32 kernel's time where this run
    measured it, and the bound: the projections at the bf16 tensor-core
    rate, the attention (4 T^2 E a pixel) on the fp32 cores a third term,
    bf16 bytes; one T 9 call's launches by torch.profiler."""
    from freqfusion_tpu_torch.models.fusion.lka import TokenMultiheadAttention
    from freqfusion_tpu_torch.ops.token_attention import (
        token_attention, token_attention_reference)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    set_gates("default")  # the module's forward below is the gate-off route
    ta = checks["token_attention.bf16"] = KernelCheck("token_attention.bf16")
    for t, e, nh in ((9, 64, 4), (4, 128, 8)):
        x = randn(p, t, e).to(bf)
        mod = TokenMultiheadAttention(e, nh).to(dev).eval().requires_grad_(
            False)
        mod.in_proj_weight.copy_(randn(3 * e, e, scale=e ** -0.5))
        mod.in_proj_bias.copy_(randn(3 * e, scale=0.1))
        mod.out_proj.weight.copy_(randn(e, e, scale=e ** -0.5))
        mod.out_proj.bias.copy_(randn(e, scale=0.1))
        mha = torch.nn.MultiheadAttention(e, nh, batch_first=True).to(
            dev).eval().requires_grad_(False)
        mha.load_state_dict({"in_proj_weight": mod.in_proj_weight,
                             "in_proj_bias": mod.in_proj_bias,
                             "out_proj.weight": mod.out_proj.weight,
                             "out_proj.bias": mod.out_proj.bias})
        mod.to(bf)
        mha.to(bf)
        args = (x, mod.in_proj_weight.t(), mod.in_proj_bias,
                mod.out_proj.weight.t(), mod.out_proj.bias, nh)
        label = f"T{t}/E{e}/h{nh}/P{p}"
        ta.run(label, lambda: token_attention(*args),
               lambda: token_attention_reference(*args), bf16_tol,
               p * (2.0 * t * e * 3 * e + 2.0 * t * e * e),
               2 * (2 * p * t * e + 4 * e * e + 4 * e),
               lambda: mha(x, x, x, need_weights=False)[0],
               peak_flops=PEAK_BF16, core_flops=p * 4.0 * t * t * e)
        if t == 9:
            launch_breakdown(f"#13 bf16 {label}",
                             lambda: token_attention(*args))
        ta.route(label, lambda: token_attention(*args), lambda: mod(x),
                 "the bf16 module's forward: F.linear, 2 einsums, softmax "
                 "op by op, out_proj")
        del x, args, mha, mod
        torch.cuda.empty_cache()
    _beside(checks, "token_attention", ta)


def phase_qkv_all(dev, randn, checks) -> None:
    """``--qkv-only``: the projection kernels in fp32, then in bf16."""
    phase_qkv_kernels(dev, randn, checks)
    torch.cuda.empty_cache()
    phase_bf16_qkv_kernels(dev, randn, checks)


def phase_token_all(dev, randn, checks) -> None:
    """``--token-only``: #13 in fp32, then in bf16."""
    phase_token_kernel(dev, randn, checks)
    phase_bf16_token_kernel(dev, randn, checks)


def _conv_tree(randn, k, cin, cout, groups=1):
    """Flax-layout conv params [k, k, cin/groups, cout], fan-in scaled."""
    fan = k * k * cin // groups
    return {"kernel": randn(k, k, cin // groups, cout, scale=fan ** -0.5),
            "bias": randn(cout, scale=0.1)}


def _norm_tree(randn, c):
    return {"scale": 1 + randn(c, scale=0.1), "bias": randn(c, scale=0.1)}


def phase_fused_kernels(dev, randn, checks) -> None:
    """The byte-floor configuration's four kernels at their path's shapes."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.cab import cab_fused, cab_fused_reference
    from freqfusion_tpu_torch.ops.dwconv import dwconv3x3, dwconv3x3_reference
    from freqfusion_tpu_torch.ops.mlp import (fused_mlp_block,
                                              fused_mlp_block_reference)
    from freqfusion_tpu_torch.ops.nafblock import (nafblock_fused,
                                                   nafblock_fused_reference)

    # operations: the products (plus, for NAFBlock, its depthwise conv
    # and elementwise work); bytes: x in, out out, the weights once
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    fm = checks["fused_mlp_block"] = KernelCheck("fused_mlp_block")
    tc = TensorCoreBound("fused_mlp_block")
    # DRCT-L's five widths (pre-norm, 12 blocks each), GRL-B's (post-norm,
    # res_scale 1, 40 blocks)
    for c, ch, pre, per_request in ((180, 720, True, 12), (212, 848, True, 12),
                                    (244, 976, True, 12), (276, 276, True, 12),
                                    (308, 308, True, 12),
                                    (180, 360, False, 40)):
        x = randn(1, h, w, c)
        args = (x, randn(c, ch, scale=c ** -0.5), randn(ch, scale=0.1),
                randn(ch, c, scale=ch ** -0.5), randn(c, scale=0.1),
                1 + randn(c, scale=0.1), randn(c, scale=0.1), pre)
        label = f"C{c}/Ch{ch}/{'pre' if pre else 'post'}"
        flops, nbytes = 4.0 * p * c * ch, 4 * (2 * p * c + 2 * c * ch + ch
                                              + 4 * c)
        ms = fm.run(label, lambda: fused_mlp_block(*args),
                    lambda: fused_mlp_block_reference(*args), fused_tol,
                    flops, nbytes)
        tc.shape(label, ms, flops, nbytes, per_request)
        if c == 244 or not pre:
            launch_breakdown(f"#14 {label}", lambda: fused_mlp_block(*args))
        del x, args
    tc.total(fm)

    cb = checks["cab_fused"] = KernelCheck("cab_fused")
    tc = TensorCoreBound("cab_fused")
    x = randn(1, h, w, 180, scale=0.5)
    # GRL-B's 40 CABs, MambaIR's 36
    for form, cr, sq, per_request in (("grl", 45, 18, 40),
                                      ("mambair", 60, 30, 36)):
        wt = {"cab_0": _conv_tree(randn, 3, 180, cr),
              "cab_2": _conv_tree(randn, 3, cr, 180),
              "ca_1": _conv_tree(randn, 1, 180, 180 // sq),
              "ca_3": _conv_tree(randn, 1, 180 // sq, 180)}
        ln = skip = None
        if form == "mambair":
            ln, skip = _norm_tree(randn, 180), 1 + randn(180, scale=0.2)
        args = (x, wt, ln, skip)
        label = f"{form}/C180/Cr{cr}"
        flops, nbytes = 36.0 * p * 180 * cr, 4 * (2 * p * 180 + 18 * 180 * cr)
        ms = cb.run(label, lambda: cab_fused(*args),
                    lambda: cab_fused_reference(*args), fused_tol, flops,
                    nbytes)
        tc.shape(label, ms, flops, nbytes, per_request)
        launch_breakdown(f"#15 {label}", lambda: cab_fused(*args))
    tc.total(cb)
    del x

    # NAFNet-SIDD-64's five levels at the 1344x2048 HR size, with its
    # blocks a level (encoders 2, 2, 4, 8 and decoders 2, 2, 2, 2 at C 64 ..
    # 512, 12 middle blocks at C 1024); the products in 3xTF32
    from freqfusion_tpu_torch.ops.nafblock import plan_nafblock

    nb = checks["nafblock_fused"] = KernelCheck("nafblock_fused")
    tc = TensorCoreBound("nafblock_fused")
    for c, (hh, ww), per_request in ((64, (4 * h, 4 * w), 4),
                                     (128, (2 * h, 2 * w), 4),
                                     (256, (h, w), 6),
                                     (512, (h // 2, w // 2), 10),
                                     (1024, (h // 4, w // 4), 12)):
        wt = {"norm1": _norm_tree(randn, c), "norm2": _norm_tree(randn, c),
              "conv1": _conv_tree(randn, 1, c, 2 * c),
              "conv2": _conv_tree(randn, 3, 2 * c, 2 * c, groups=2 * c),
              "sca": _conv_tree(randn, 1, c, c),
              "conv3": _conv_tree(randn, 1, c, c),
              "conv4": _conv_tree(randn, 1, c, 2 * c),
              "conv5": _conv_tree(randn, 1, c, c),
              "beta": randn(c, scale=0.5), "gamma": randn(c, scale=0.5)}
        x = torch.rand(1, hh, ww, c, device=dev)
        npx = hh * ww
        flops = npx * (12.0 * c * c + 60.0 * c)
        nbytes = 4 * (2 * npx * c + 7 * c * c + 40 * c)
        label = f"C{c}/{hh}x{ww}"
        ms = nb.run(label, lambda: nafblock_fused(x, wt),
                    lambda: nafblock_fused_reference(x, wt), fused_tol,
                    flops, nbytes)
        # the products (12 C^2 a pixel) on the tensor cores; the rest
        # (depthwise conv, gate, norms: 60 C) is negligible beside them
        tc.shape(label, ms, npx * 12.0 * c * c, nbytes, per_request)
        plan = plan_nafblock(npx, c)
        print(f"  nafblock_fused {label}: the nine launches move "
              f"{plan.bytes_per_pixel} bytes a pixel "
              f"({1e3 * npx * plan.bytes_per_pixel / PEAK_BYTES:.3f} ms at "
              f"3.35 TB/s) against the bound's {plan.bound_bytes_per_pixel}")
        if c in (64, 1024):
            launch_breakdown(f"#16 {label}", lambda: nafblock_fused(x, wt))
        del x, wt
        torch.cuda.empty_cache()
    tc.total(nb)

    dw = checks["dwconv3x3"] = KernelCheck("dwconv3x3")
    x = randn(1, h, w, 360)
    k, b = randn(3, 3, 1, 360, scale=1 / 3), randn(360, scale=0.1)
    k_torch = k.permute(3, 2, 0, 1).contiguous()
    dw.run("SS2D/D360", lambda: dwconv3x3(x, k, b),
           lambda: dwconv3x3_reference(x, k, b), fused_tol,
           18.0 * p * 360, 4 * (2 * p * 360 + 10 * 360),
           lambda: F.conv2d(x.permute(0, 3, 1, 2), k_torch, b, padding=1,
                            groups=360))


def phase_qkv_kernels(dev, randn, checks) -> None:
    """The in-kernel projection configuration's three kernels at their
    path's shapes, and DRCT's and GRL's gate-off routes beside them."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        window_attention_nhwc, window_attention_qkv_nhwc,
        window_attention_qkv_nhwc_reference)
    from freqfusion_tpu_torch.ops.token_attention import (
        token_attention, token_attention_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    wq = checks["window_attention_qkv_nhwc"] = KernelCheck(
        "window_attention_qkv_nhwc")
    tc = TensorCoreBound("window_attention_qkv_nhwc")
    for c, heads in ((180, 6), (212, 4), (244, 2), (276, 6), (308, 4)):
        x = randn(1, h, w, c)
        wqkv, wproj = randn(c, 3 * c, scale=c ** -0.5), randn(
            c, c, scale=c ** -0.5)
        bqkv, bproj = randn(3 * c, scale=0.1), randn(c, scale=0.1)
        bias = randn(heads, 256, 256, scale=0.5)
        # the module's torch-layout weights, for the gate-off route
        w_t, wp_t = wqkv.t().contiguous(), wproj.t().contiguous()
        for shift in (0, 8):
            mask = device_table(shifted_window_mask, h, w, 16, shift,
                                device=dev)
            args = (x, wqkv, bqkv, wproj, bproj, bias, mask, heads, 16)
            label = f"C{c}/hd{c // heads}/{'mask' if shift else 'nomask'}"
            # projections 8 p C^2, attention 4 p N C (N 256), all of it
            # 3xTF32 on the tensor cores
            flops = 8.0 * p * c * c + 4.0 * p * 256 * c
            nbytes = 4 * (2 * p * c + 4 * c * c + 4 * c + bias.numel()
                          + (0 if mask is None else mask.numel()))
            ms = wq.run(label, lambda: window_attention_qkv_nhwc(*args),
                        lambda: window_attention_qkv_nhwc_reference(*args),
                        fused_tol, flops, nbytes)
            tc.shape(label, ms, flops, nbytes, 6)
            if c == 244 and not shift:
                launch_breakdown(f"#11 {label}",
                                 lambda: window_attention_qkv_nhwc(*args))

            def gate_off():
                q, k, v = (F.linear(x, w_t[i * c:(i + 1) * c],
                                    bqkv[i * c:(i + 1) * c])
                           for i in range(3))
                return F.linear(window_attention_nhwc(q, k, v, bias, mask,
                                                      heads, 16),
                                wp_t, bproj)
            wq.route(label, lambda: window_attention_qkv_nhwc(*args),
                     gate_off, "3 F.linear + kernel #1 + F.linear")
        del x, args
    tc.total(wq)
    torch.cuda.empty_cache()

    phase_grl_qkv_kernel(dev, randn, checks)

    phase_token_kernel(dev, randn, checks)


def phase_token_kernel(dev, randn, checks) -> None:
    """Kernel #13 at the fusion net's two geometries over the 336x512
    bucket's pixels (also ``--token-only``), handed the weights as the
    gated module hands them (the transposed views of its torch-layout
    weights), beside nn.MultiheadAttention (the library call), its
    two-term 3xTF32 bound (the projections on the tensor cores; the
    attention, 4 T^2 E a pixel, on the fp32 cores, a third term), its plan
    (tiles, shared memory, L2 weight bytes), one launch a geometry a
    request, and the gate-off route (the module's forward: F.linear, two
    einsums, softmax, out_proj); one T 4 call's launches (the weight
    layout and the attention kernel) by torch.profiler."""
    from freqfusion_tpu_torch.models.fusion.lka import TokenMultiheadAttention
    from freqfusion_tpu_torch.ops.token_attention import (
        plan_token_attention, token_attention, token_attention_reference)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    set_gates("default")  # the module's forward below is the gate-off route
    ta = checks["token_attention"] = KernelCheck("token_attention")
    tc = TensorCoreBound("token_attention")
    for t, e, nh in ((9, 64, 4), (4, 128, 8)):
        x = randn(p, t, e)
        mod = TokenMultiheadAttention(e, nh).to(dev).eval().requires_grad_(
            False)
        mod.in_proj_weight.copy_(randn(3 * e, e, scale=e ** -0.5))
        mod.in_proj_bias.copy_(randn(3 * e, scale=0.1))
        mod.out_proj.weight.copy_(randn(e, e, scale=e ** -0.5))
        mod.out_proj.bias.copy_(randn(e, scale=0.1))
        args = (x, mod.in_proj_weight.t(), mod.in_proj_bias,
                mod.out_proj.weight.t(), mod.out_proj.bias, nh)
        mha = torch.nn.MultiheadAttention(e, nh, batch_first=True).to(
            dev).eval().requires_grad_(False)
        mha.in_proj_weight.copy_(mod.in_proj_weight)
        mha.in_proj_bias.copy_(mod.in_proj_bias)
        mha.out_proj.weight.copy_(mod.out_proj.weight)
        mha.out_proj.bias.copy_(mod.out_proj.bias)
        label = f"T{t}/E{e}/h{nh}/P{p}"
        products = p * (2.0 * t * e * 3 * e + 2.0 * t * e * e)
        core = p * 4.0 * t * t * e
        nbytes = 4 * (2 * p * t * e + 4 * e * e + 4 * e)
        ms = ta.run(label, lambda: token_attention(*args),
                    lambda: token_attention_reference(*args), fused_tol,
                    products + core, nbytes,
                    lambda: mha(x, x, x, need_weights=False)[0])
        tc.shape(label, ms, products, nbytes, 1, core_flops=core)
        plan = plan_token_attention(p, t, e, nh)
        print(f"  token_attention {label} plan: {4 * plan.wc} warps in "
              f"{plan.teams} teams of {plan.pixels} pixels ({plan.rows} of "
              f"{plan.rows_pad} rows) a tile, {plan.tiles} tiles, "
              f"{plan.smem} bytes of shared memory a block "
              f"({plan.blocks_per_sm} an SM by it), weight bytes from L2 "
              f"{plan.l2_weight_bytes / 1e9:.3f} GB a call")
        if t == 4:
            launch_breakdown(f"#13 {label}", lambda: token_attention(*args))
        ta.route(label, lambda: token_attention(*args), lambda: mod(x),
                 "the module's forward: F.linear, 2 einsums, softmax, "
                 "out_proj")
        del x, args, mha, mod
        torch.cuda.empty_cache()
    tc.total(ta)


def phase_grl_kernels(dev, randn, checks) -> None:
    """#2 and #12 alone (``--grl-only``)."""
    phase_grl_kernel(dev, randn, checks)
    phase_grl_qkv_kernel(dev, randn, checks)


def phase_grl_qkv_kernel(dev, randn, checks) -> None:
    """Kernel #12 at GRL-B's two shapes (x [1, 336, 512, 180], wqkv
    [180, 540]; shifted with x_rolled and the mask, and not), each beside
    its two-term 3xTF32 bound (the projection's 33.4 GFLOP bind it), its
    share of a request (20 launches a shape) and the route the gate
    replaces (6 F.linear + rolls + #2); one shifted call's launches
    (split, rows passes, the two GEMMs, the attention) by torch.profiler."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        grl_mixed_attention_nhwc, grl_mixed_attention_qkv_nhwc,
        grl_mixed_attention_qkv_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    gq = checks["grl_mixed_attention_qkv_nhwc"] = KernelCheck(
        "grl_mixed_attention_qkv_nhwc")
    tc = TensorCoreBound("grl_mixed_attention_qkv_nhwc")
    x = randn(1, h, w, 180)
    anchor = randn(1, h // 2, w // 2, 90)
    wqkv, bqkv = randn(180, 540, scale=180 ** -0.5), randn(540, scale=0.1)
    w_t = wqkv.t().contiguous()
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        x_rolled = (torch.roll(x, (-shift, -shift), (1, 2)) if shift
                    else None)
        args = (x, x_rolled, anchor, wqkv, bqkv, *scales, *biases, mask, 3,
                3, 8)
        label = "shift" if shift else "noshift"
        # projection 2 p 180 540; attention as grl_mixed_attention_nhwc
        flops = 2.0 * p * 180 * 540 + p * 90 * (4.0 * 64 + 8 * 16)
        nbytes = 4 * ((2 if shift else 1) * p * 180 + anchor.numel()
                      + 2 * p * 90 + 181 * 540
                      + sum(b.numel() for b in biases)
                      + (0 if mask is None else mask.numel()))
        ms = gq.run(label, lambda: grl_mixed_attention_qkv_nhwc(*args),
                    lambda: grl_mixed_attention_qkv_nhwc_reference(*args),
                    lambda _: ATTN_TOL, flops, nbytes)
        tc.shape(label, ms, flops, nbytes, 20)
        if shift:
            launch_breakdown(f"#12 {label}",
                             lambda: grl_mixed_attention_qkv_nhwc(*args))

        def gate_on():
            xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else None
            return grl_mixed_attention_qkv_nhwc(
                x, xr, anchor, wqkv, bqkv, *scales, *biases, mask, 3, 3, 8)

        def gate_off():
            qkv6 = [F.linear(x, w_t[i * 90:(i + 1) * 90],
                             bqkv[i * 90:(i + 1) * 90]) for i in range(6)]
            if shift:
                qkv6[:3] = [torch.roll(t, (-shift, -shift), (1, 2))
                            for t in qkv6[:3]]
            return grl_mixed_attention_nhwc(*qkv6, anchor, *scales, *biases,
                                            mask, 3, 3, 8)
        gq.route(label, gate_on, gate_off,
                 "6 F.linear + rolls + kernel #2; on: roll + kernel")
    tc.total(gq)
    del x, x_rolled, args, anchor
    torch.cuda.empty_cache()


def _numel(tree) -> int:
    """Elements of the tensors in a nested dict (a kernel's weights)."""
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values() if v is not None)
    return tree.numel()


def _fusion_module(m, dev, randn, dtype=torch.float32):
    """Seeded init, every parameter moved by 0.05 N(0, 1), BN running
    statistics away from 0 and 1; on the card, eval, cast to `dtype` (as
    the pipeline's fusion_dtype casts the fusion net)."""
    from freqfusion_tpu_torch.models.common import init_weights

    init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(dev).eval().requires_grad_(False)
    for name, t in m.named_buffers():
        if name.endswith("running_mean"):
            t.copy_(randn(*t.shape, scale=0.1))
        elif name.endswith("running_var"):
            t.copy_(1 + 0.5 * torch.tanh(randn(*t.shape)))
    for t in m.parameters():
        t.add_(randn(t.numel(), scale=0.05).view(t.shape))
    return m.to(dtype)


def phase_fusion_kernels(dev, randn, checks) -> None:
    """The fusion-eval configuration's four kernels at their path's shapes,
    in the layouts the gated modules hand them (NHWC slices for the
    LKABlock, NCHW views for the rest), and the gate-off routes (the
    modules on cuDNN) beside them."""
    from freqfusion_tpu_torch.models.fusion.edge import (
        EdgeRefineBlock, LaplacianPyramidRefinement)
    from freqfusion_tpu_torch.models.fusion.hierarchical import (
        HierarchicalMultiResolutionFusion)
    from freqfusion_tpu_torch.models.fusion.lka import LKABlock
    from freqfusion_tpu_torch.ops.edge import (
        edge_fuse_fused, edge_fuse_fused_reference, edge_refine_fused,
        edge_refine_fused_reference)
    from freqfusion_tpu_torch.ops.hier import (hier_stage3_fused,
                                               hier_stage3_fused_reference)
    from freqfusion_tpu_torch.ops.lka import (lka_block_fused,
                                              lka_block_fused_reference)

    set_gates("default")  # the modules below are the gate-off routes

    def module(m):
        return _fusion_module(m, dev, randn)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    lk = checks["lka_block_fused"] = KernelCheck("lka_block_fused")
    tc = TensorCoreBound("lka_block_fused")
    # phase 3's 9 per-band blocks at C 64, phase 4's 4 per-expert at C 128
    for c, per_request in ((64, 9), (128, 4)):
        mod = module(LKABlock(c))
        tree = mod.fused_params()
        x = randn(1, h, w, c)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        # 67 depthwise taps (fp32 cores), the pw product and the FFN
        # (hidden 2C): 10 C^2 a pixel on the tensor cores
        label = f"C{c}/{h}x{w}"
        nbytes = 4 * (2 * p * c + _numel(tree))
        ms = lk.run(label, lambda: lka_block_fused(x, tree),
                    lambda: lka_block_fused_reference(x, tree), fused_tol,
                    p * (134.0 * c + 10.0 * c * c), nbytes)
        tc.shape(label, ms, p * 10.0 * c * c, nbytes, per_request,
                 core_flops=p * 134.0 * c)
        launch_breakdown(f"#18 {label}", lambda: lka_block_fused(x, tree))
        lk.route(f"C{c}", lambda: lka_block_fused(x, mod.fused_params()),
                 lambda: mod(x_nchw), "LKABlock on cuDNN, NCHW")
        del x, x_nchw
    tc.total(lk)
    torch.cuda.empty_cache()

    hh, ww = 4 * h, 4 * w
    ph = hh * ww
    hi = checks["hier_stage3_fused"] = KernelCheck("hier_stage3_fused")
    hm = module(HierarchicalMultiResolutionFusion(4, 64))
    tree = hm.stage3_params()
    s3 = randn(1, 76, hh, ww, scale=0.5)
    s3v = s3.permute(0, 2, 3, 1)

    def hier_off():
        f3 = hm.stage3_res(hm.stage3_gate(hm.stage3_conv(s3)))
        return hm.to_rgb(f3 + hm.residual_weight_2_3 * s3[:, :hm.half])
    # six 3x3 convs: 9 x 2 x (76 x 64 + 64 x 32 + 2 x 32 x 32 + 32 x 16
    # + 16 x 3) per pixel, on the tensor cores
    tc = TensorCoreBound("hier_stage3_fused")
    label, flops = f"{hh}x{ww}/C76", ph * 18.0 * 9520
    nbytes = 4 * (ph * 79 + _numel(tree))
    ms = hi.run(label, lambda: hier_stage3_fused(s3v, tree),
                lambda: hier_stage3_fused_reference(s3v, tree), fused_tol,
                flops, nbytes)
    tc.shape(label, ms, flops, nbytes, 1)
    launch_breakdown(f"#19 {label}", lambda: hier_stage3_fused(s3v, tree))
    hi.route(f"{hh}x{ww}", lambda: hier_stage3_fused(s3v, hm.stage3_params()),
             hier_off, "stage-3 + to_rgb modules on cuDNN")
    tc.total(hi)
    del s3, s3v
    torch.cuda.empty_cache()

    er = checks["edge_refine_fused"] = KernelCheck("edge_refine_fused")
    tc = TensorCoreBound("edge_refine_fused")
    rm = module(EdgeRefineBlock(3, 32))
    tree = rm.fused_params()
    for s in (1, 2, 4):
        lap = randn(1, 3, hh // s, ww // s, scale=0.1)
        lapv = lap.permute(0, 2, 3, 1)
        npx = lap.numel() // 3
        label = f"{hh // s}x{ww // s}"
        # 9 x 2 x (3 x 32 + 2 x 32 x 32 + 8) + 2 x (3 + 8) x 32 per pixel:
        # the 3x3 convs and the projection on the tensor cores, the
        # squeeze (2 x 32 x 8) on the fp32 cores
        nbytes = 4 * (npx * 35 + _numel(tree))
        ms = er.run(label, lambda: edge_refine_fused(lapv, tree),
                    lambda: edge_refine_fused_reference(lapv, tree),
                    fused_tol, npx * 39440.0, nbytes)
        tc.shape(label, ms, npx * 38928.0, nbytes, 1,
                 core_flops=npx * 512.0)
        if s in (1, 4):
            launch_breakdown(f"#20 {label}",
                             lambda: edge_refine_fused(lapv, tree))
        er.route(label, lambda: edge_refine_fused(lapv, rm.fused_params()),
                 lambda: rm(lap), "EdgeRefineBlock on cuDNN")
        del lap, lapv
    tc.total(er)
    torch.cuda.empty_cache()

    ef = checks["edge_fuse_fused"] = KernelCheck("edge_fuse_fused")
    em = module(LaplacianPyramidRefinement(3, 32, 0.15))
    tree = em.fuse_params()
    sr = (0.5 + 0.2 * randn(1, 3, hh, ww)).clamp(0.0, 1.0)
    feats = [randn(1, 32, hh, ww, scale=0.3) for _ in range(3)]
    views = [t.permute(0, 2, 3, 1) for t in (sr, *feats)]
    lw = torch.softmax(em.level_weights, 0)
    args = (*views, lw, em.edge_strength, tree)

    def fuse_off():
        edge = em.fusion(torch.cat([f * lw[i] for i, f in enumerate(feats)],
                                   1))
        gate = em.edge_gate(torch.cat([sr, edge], 1))
        return (sr + gate * em.edge_strength * edge).clamp(0.0, 1.0)
    # 9 x 2 x (96 x 32 + 32 x 3 + 6 x 16 + 16) per pixel, on the tensor
    # cores
    tc = TensorCoreBound("edge_fuse_fused")
    label, flops = f"{hh}x{ww}", ph * 59040.0
    nbytes = 4 * (ph * 102 + _numel(tree) + 4)
    ms = ef.run(label, lambda: edge_fuse_fused(*args),
                lambda: edge_fuse_fused_reference(*args), fused_tol, flops,
                nbytes)
    tc.shape(label, ms, flops, nbytes, 1)
    launch_breakdown(f"#21 {label}", lambda: edge_fuse_fused(*args))
    ef.route(label, lambda: edge_fuse_fused(*args), fuse_off,
             "fusion + edge-gate modules on cuDNN")
    tc.total(ef)
    del sr, feats, views, args
    torch.cuda.empty_cache()


def phase_bf16_fusion_kernels(dev, randn, checks, beside) -> None:
    """The fusion-eval kernels' bf16 versions (#18-#21) at
    phase_fusion_kernels' shapes and layouts, their modules and inputs cast
    to bf16 as the pipeline's fusion_dtype casts them, each against its
    bf16 plain version (BF16_ULPS), beside the gate-off route (the bf16
    module on cuDNN) and the fp32 kernel's time where this run measured
    it. Bound: the products at the bf16 tensor-core rate, the LKABlock's
    depthwise taps and the refine's squeeze on the fp32 cores (a third
    term), and bf16 bytes (inputs and the output once, the weights once;
    the fuse's lw and strength too)."""
    from freqfusion_tpu_torch.models.fusion.edge import (
        EdgeRefineBlock, LaplacianPyramidRefinement)
    from freqfusion_tpu_torch.models.fusion.lka import LKABlock
    from freqfusion_tpu_torch.ops.edge import (
        edge_fuse_fused, edge_fuse_fused_reference, edge_refine_fused,
        edge_refine_fused_reference)
    from freqfusion_tpu_torch.ops.lka import (lka_block_fused,
                                              lka_block_fused_reference)

    set_gates("default")  # the modules below are the gate-off routes
    bf = torch.bfloat16

    def module(m):
        return _fusion_module(m, dev, randn, bf)

    h, w = LR_SIZES["c_336x512"]
    p = h * w
    lk = checks["lka_block_fused.bf16"] = KernelCheck("lka_block_fused.bf16")
    for c in (64, 128):
        mod = module(LKABlock(c))
        tree = mod.fused_params()
        x = randn(1, h, w, c).to(bf)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        lk.run(f"C{c}/{h}x{w}", lambda: lka_block_fused(x, tree),
               lambda: lka_block_fused_reference(x, tree), bf16_tol,
               p * 10.0 * c * c, 2 * (2 * p * c + _numel(tree)),
               peak_flops=PEAK_BF16, core_flops=p * 134.0 * c)
        launch_breakdown(f"#18 bf16 C{c}", lambda: lka_block_fused(x, tree))
        lk.route(f"C{c}", lambda: lka_block_fused(x, mod.fused_params()),
                 lambda: mod(x_nchw), "LKABlock on cuDNN, bf16")
        del x, x_nchw
    beside("lka_block_fused", lk)
    torch.cuda.empty_cache()

    phase_bf16_hier_kernel(dev, randn, checks)
    hh, ww = 4 * h, 4 * w
    ph = hh * ww

    er = checks["edge_refine_fused.bf16"] = KernelCheck(
        "edge_refine_fused.bf16")
    rm = module(EdgeRefineBlock(3, 32))
    tree = rm.fused_params()
    for s in (1, 2, 4):
        lap = randn(1, 3, hh // s, ww // s, scale=0.1).to(bf)
        lapv = lap.permute(0, 2, 3, 1)
        npx = lap.numel() // 3
        label = f"{hh // s}x{ww // s}"
        er.run(label, lambda: edge_refine_fused(lapv, tree),
               lambda: edge_refine_fused_reference(lapv, tree), bf16_tol,
               npx * 38928.0, 2 * (npx * 35 + _numel(tree)),
               peak_flops=PEAK_BF16, core_flops=npx * 512.0)
        if s == 1:
            launch_breakdown(f"#20 bf16 {label}",
                             lambda: edge_refine_fused(lapv, tree))
        er.route(label, lambda: edge_refine_fused(lapv, rm.fused_params()),
                 lambda: rm(lap), "EdgeRefineBlock on cuDNN, bf16")
        del lap, lapv
    beside("edge_refine_fused", er)
    torch.cuda.empty_cache()

    ef = checks["edge_fuse_fused.bf16"] = KernelCheck("edge_fuse_fused.bf16")
    em = module(LaplacianPyramidRefinement(3, 32, 0.15))
    tree = em.fuse_params()
    sr = (0.5 + 0.2 * randn(1, 3, hh, ww)).clamp(0.0, 1.0).to(bf)
    feats = [randn(1, 32, hh, ww, scale=0.3).to(bf) for _ in range(3)]
    views = [t.permute(0, 2, 3, 1) for t in (sr, *feats)]
    lw = torch.softmax(em.level_weights, 0)
    args = (*views, lw, em.edge_strength, tree)

    def fuse_off():
        edge = em.fusion(torch.cat([f * lw[i] for i, f in enumerate(feats)],
                                   1))
        gate = em.edge_gate(torch.cat([sr, edge], 1))
        return (sr + gate * em.edge_strength * edge).clamp(0.0, 1.0)
    label = f"{hh}x{ww}"
    ef.run(label, lambda: edge_fuse_fused(*args),
           lambda: edge_fuse_fused_reference(*args), bf16_tol, ph * 59040.0,
           2 * (ph * 102 + _numel(tree) + 4), peak_flops=PEAK_BF16)
    launch_breakdown(f"#21 bf16 {label}", lambda: edge_fuse_fused(*args))
    ef.route(label, lambda: edge_fuse_fused(*args), fuse_off,
             "fusion + edge-gate modules on cuDNN, bf16")
    beside("edge_fuse_fused", ef)
    del sr, feats, views, args
    torch.cuda.empty_cache()


def phase_bf16_grl_kernel(dev, randn, checks) -> None:
    """#2 bf16 at GRL-B's two shapes (bf16 halves and anchor; fp32 scales
    and biases; the fp32 mask table, which the wrapper casts to bf16 once,
    as the JAX wrapper casts it), with its share of a request (20 launches
    a shape) and one shifted call's launches."""
    from freqfusion_tpu_torch.ops.attention import (
        grl_mixed_attention_nhwc, grl_mixed_attention_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    ga = checks["grl_mixed_attention_nhwc.bf16"] = KernelCheck(
        "grl_mixed_attention_nhwc.bf16")
    share = RequestShare(ga)
    halves = [randn(1, h, w, 90).to(bf) for _ in range(6)]
    anchor = randn(1, h // 2, w // 2, 90).to(bf)
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        args = (*halves, anchor, *scales, *biases, mask, 3, 3, 8)
        # the halves, the anchor and both outputs bf16, the biases fp32,
        # the mask bf16 (as the JAX wrapper casts it), each once
        nbytes = (2 * (8 * p * 90 + anchor.numel())
                  + 4 * sum(b.numel() for b in biases)
                  + (0 if mask is None else 2 * mask.numel()))
        label = "shift" if shift else "noshift"
        # GRL-B's 40 blocks: 20 a shape
        share.run(label, 20, lambda: grl_mixed_attention_nhwc(*args),
                  lambda: grl_mixed_attention_nhwc_reference(*args),
                  bf16_tol, p * 90 * (4.0 * 64 + 8 * 16), nbytes,
                  peak_flops=PEAK_BF16)
        if shift:
            launch_breakdown(f"#2 bf16 {label}",
                             lambda: grl_mixed_attention_nhwc(*args))
    share.total()
    _beside(checks, "grl_mixed_attention_nhwc", ga)
    del halves, anchor
    torch.cuda.empty_cache()

def phase_bf16_grl_qkv_kernel(dev, randn, checks) -> None:
    """#12 bf16 at GRL-B's two shapes (bf16 x, anchor, wqkv and bqkv; fp32
    scales, biases and mask), beside the bf16 route its gate replaces,
    with its share of a request (20 launches a shape) and one shifted
    call's launches (its wgmma projection and #2's body)."""
    import torch.nn.functional as F

    from freqfusion_tpu_torch.ops.attention import (
        grl_mixed_attention_nhwc, grl_mixed_attention_qkv_nhwc,
        grl_mixed_attention_qkv_nhwc_reference)
    from freqfusion_tpu_torch.ops.window_attention import (
        device_table, shifted_window_mask)

    bf = torch.bfloat16
    h, w = LR_SIZES["c_336x512"]
    p = h * w
    gq = checks["grl_mixed_attention_qkv_nhwc.bf16"] = KernelCheck(
        "grl_mixed_attention_qkv_nhwc.bf16")
    gshare = RequestShare(gq)
    x = randn(1, h, w, 180).to(bf)
    anchor = randn(1, h // 2, w // 2, 90).to(bf)
    wqkv = randn(180, 540, scale=180 ** -0.5).to(bf)
    bqkv = randn(540, scale=0.1).to(bf)
    w_t = wqkv.t().contiguous()
    scales = [10.0 + randn(3, 1, 1).abs() for _ in range(3)]
    biases = [16 * torch.sigmoid(randn(*s)) for s in ((3, 64, 64),
                                                     (3, 16, 64), (3, 64, 16))]
    for shift in (0, 4):
        mask = device_table(shifted_window_mask, h, w, 8, shift, device=dev)
        x_rolled = (torch.roll(x, (-shift, -shift), (1, 2)) if shift
                    else None)
        args = (x, x_rolled, anchor, wqkv, bqkv, *scales, *biases, mask, 3,
                3, 8)
        label = "shift" if shift else "noshift"
        nbytes = (2 * ((2 if shift else 1) * p * 180 + anchor.numel()
                       + 2 * p * 90 + 181 * 540)
                  + 4 * sum(b.numel() for b in biases)
                  + (0 if mask is None else 2 * mask.numel()))
        # GRL-B's 40 blocks: 20 a shape
        gshare.run(label, 20, lambda: grl_mixed_attention_qkv_nhwc(*args),
                   lambda: grl_mixed_attention_qkv_nhwc_reference(*args),
                   bf16_tol,
                   2.0 * p * 180 * 540 + p * 90 * (4.0 * 64 + 8 * 16),
                   nbytes, peak_flops=PEAK_BF16)
        if shift:
            launch_breakdown(f"#12 bf16 {label}",
                             lambda: grl_mixed_attention_qkv_nhwc(*args))

        def gate_on():
            xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else None
            return grl_mixed_attention_qkv_nhwc(
                x, xr, anchor, wqkv, bqkv, *scales, *biases, mask, 3, 3, 8)

        def gate_off():
            qkv6 = [F.linear(x, w_t[i * 90:(i + 1) * 90],
                             bqkv[i * 90:(i + 1) * 90]) for i in range(6)]
            if shift:
                qkv6[:3] = [torch.roll(t, (-shift, -shift), (1, 2))
                            for t in qkv6[:3]]
            return grl_mixed_attention_nhwc(*qkv6, anchor, *scales, *biases,
                                            mask, 3, 3, 8)
        gq.route(label, gate_on, gate_off,
                 "6 F.linear + rolls + bf16 kernel #2; on: roll + kernel")
    gshare.total()
    _beside(checks, "grl_mixed_attention_qkv_nhwc", gq)
    del x, x_rolled, args, anchor
    torch.cuda.empty_cache()


def phase_bf16_hier_kernel(dev, randn, checks) -> None:
    """#19 bf16 at 1344x2048 (s3_in the NCHW view the module hands; the
    module cast to bf16 as fusion_dtype casts it, its parameters handed as
    stage3_params gives them), beside the gate-off route (the bf16 modules
    on cuDNN), with one call's launches."""
    from freqfusion_tpu_torch.models.fusion.hierarchical import (
        HierarchicalMultiResolutionFusion)
    from freqfusion_tpu_torch.ops.hier import (hier_stage3_fused,
                                               hier_stage3_fused_reference)

    h, w = LR_SIZES["c_336x512"]
    bf = torch.bfloat16

    def module(m):
        return _fusion_module(m, dev, randn, bf)

    hh, ww = 4 * h, 4 * w
    ph = hh * ww
    hi = checks["hier_stage3_fused.bf16"] = KernelCheck(
        "hier_stage3_fused.bf16")
    hm = module(HierarchicalMultiResolutionFusion(4, 64))
    tree = hm.stage3_params()
    s3 = randn(1, 76, hh, ww, scale=0.5).to(bf)
    s3v = s3.permute(0, 2, 3, 1)

    def hier_off():
        f3 = hm.stage3_res(hm.stage3_gate(hm.stage3_conv(s3)))
        return hm.to_rgb(f3 + hm.residual_weight_2_3 * s3[:, :hm.half])
    label = f"{hh}x{ww}/C76"
    hi.run(label, lambda: hier_stage3_fused(s3v, tree),
           lambda: hier_stage3_fused_reference(s3v, tree), bf16_tol,
           ph * 18.0 * 9520, 2 * (ph * 79 + _numel(tree)),
           peak_flops=PEAK_BF16)
    launch_breakdown(f"#19 bf16 {label}", lambda: hier_stage3_fused(s3v, tree))
    hi.route(f"{hh}x{ww}", lambda: hier_stage3_fused(s3v, hm.stage3_params()),
             hier_off, "stage-3 + to_rgb modules on cuDNN, bf16")
    _beside(checks, "hier_stage3_fused", hi)
    del s3, s3v
    torch.cuda.empty_cache()


def phase_grl_hier_bf16(dev, randn, checks) -> None:
    """``--grl-hier-bf16-only``: #2 bf16, #12 bf16 and #19 bf16 alone."""
    phase_bf16_grl_kernel(dev, randn, checks)
    phase_bf16_grl_qkv_kernel(dev, randn, checks)
    set_gates("default")  # the hier module below is the gate-off route
    phase_bf16_hier_kernel(dev, randn, checks)


def write_checkpoints(model_dir: Path, seed: int = 0) -> None:
    from freqfusion_tpu_torch.interface.io import _TORCH_FILES
    from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
        CompleteEnhancedFusionSR)
    from freqfusion_tpu_torch.models.pipeline import build_expert_models

    g = torch.Generator().manual_seed(seed)
    models = build_expert_models(4, generator=g)
    models["fusion"] = CompleteEnhancedFusionSR(upscale=4, generator=g)
    for name, model in models.items():
        torch.save({"params": model.state_dict()}, model_dir / _TORCH_FILES[name])
        print(f"  wrote {_TORCH_FILES[name]}: "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params")


def write_inputs(in_dir: Path, seed: int = 0) -> None:
    from freqfusion_tpu_torch.utils.image_io import write_image

    rng = np.random.default_rng(seed)
    for name, (h, w) in LR_SIZES.items():
        coarse = rng.uniform(0, 1, (1, 3, h // 8 + 2, w // 8 + 2))
        img = torch.nn.functional.interpolate(
            torch.from_numpy(coarse), size=(h, w), mode="bicubic",
            align_corners=False)[0].permute(1, 2, 0).numpy()
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
        write_image(str(in_dir / f"{name}.png"), img)


def set_gates(config: str) -> None:
    """Set the variables of `config` and clear every other configuration's
    (FREQFUSION_SCAN included)."""
    for name in {g for gates in CONFIGS.values() for g in gates}:
        os.environ.pop(name, None)
    os.environ.update(CONFIGS[config])


def psnr(a, b) -> float:
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def build_pipeline(model_dir: Path, device, config: str):
    """The pipeline of `config` as load_pipeline builds it under the
    configuration's variables (the experts' dtype read at load time), the
    fusion net then cast by the constructor's fusion_dtype where the
    configuration is one of FUSION_BF16."""
    from freqfusion_tpu_torch.interface.io import load_pipeline
    from freqfusion_tpu_torch.models.pipeline import FreqFusionPipeline

    set_gates(config)
    pipe = load_pipeline(str(model_dir), device, verbose=False)
    if config in FUSION_BF16:
        pipe = FreqFusionPipeline(dict(pipe.experts), pipe.fusion,
                                  pipe.scale, pipe.expert_dtype,
                                  torch.bfloat16).eval()
    return pipe


def phase_bf16_fusion(model_dir: Path, in_dir: Path, work: Path) -> dict:
    """The experts and the fusion net in bf16 (expert_dtype and
    fusion_dtype bf16, as bench.py:bench_full builds the JAX pipeline), in
    a pipeline of its own: the three LR PNGs read, served and written as
    io.main does, with the three fusion-eval gates (60, 40 and 144
    launches of the bf16 #1, #2 and #3/#4 per image, 13, 1, 3 and 1 of the
    bf16 #18-#21, none of an fp32 kernel; the 336x512 output against phase
    3e's fp32 fusion-eval one) and without them (the JAX package's bench
    mode: the experts' bf16 kernels only; against phase 3's fp32 output),
    and with the three projection gates (bf16-projection: 60, 40, 2 and
    144 launches of the bf16 #11, #12, #13 and #3/#4 per image, none of an
    fp32 kernel; against phase 3d's fp32 projection output), and on SS2D's
    chainv5 and spatial routes (bf16-chainv5, bf16-spatial: 60 and 40
    launches of the bf16 #1 and #2 and 144 of the bf16 #5 or #9 per image,
    none of #3/#4's or of an fp32 kernel; against phase 3f's or 3g's fp32
    output), PSNR >= 51 dB each. Returns each configuration's launch
    counts."""
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.utils.image_io import read_image, write_image

    name = "c_336x512.png"
    pipe = build_pipeline(model_dir, "cuda", "bf16-fusion-eval")
    if {p.dtype for p in pipe.parameters()} != {torch.bfloat16}:
        raise AssertionError("the bf16-fusion pipeline holds fp32 weights")
    counts = {}
    for config, per_image, ref, what in (
            ("bf16-fusion-eval", PER_IMAGE_BF16_FUSION, "out_fusion-eval",
             "phase 3e's fp32 fusion-eval output"),
            ("bf16-projection", PER_IMAGE_BF16_QKV, "out_projection",
             "phase 3d's fp32 projection output"),
            ("bf16-chainv5", PER_IMAGE_BF16_CHAINV5, "out_chainv5",
             "phase 3f's fp32 chainv5 output"),
            ("bf16-spatial", PER_IMAGE_BF16_SPATIAL, "out_spatial",
             "phase 3g's fp32 spatial output"),
            ("bf16-fusion", PER_IMAGE_BF16, "out", "phase 3's fp32 output")):
        set_gates(config)
        out = work / f"out_{config}"
        out.mkdir()
        cuda.reset_launch_counts()
        for stem, (h, w) in LR_SIZES.items():
            t0 = time.perf_counter()
            lr = torch.from_numpy(read_image(str(in_dir / f"{stem}.png")))
            with torch.inference_mode():
                sr = pipe(lr.permute(2, 0, 1)[None].cuda())
            if sr.dtype != torch.float32 or not bool(torch.isfinite(sr).all()):
                raise AssertionError(f"{config} {stem}: output {sr.dtype}, "
                                     "not finite fp32")
            sr = sr[0].permute(1, 2, 0).cpu().numpy()
            write_image(str(out / f"{stem}.png"), sr)
            sec = time.perf_counter() - t0
            if sr.shape != (4 * h, 4 * w, 3) or not sr.std() > 0.01:
                raise AssertionError(f"{config} {stem}: bad output {sr.shape}")
            print(f"  {config} {stem}: {h}x{w} -> {4 * h}x{4 * w}, "
                  f"{sec:.3f} s/request")
        counts[config] = dict(cuda.launch_counts)
        print(f"  {config} launch counts: "
              f"{json.dumps(counts[config], sort_keys=True)}")
        for k in set(per_image) | set(counts[config]):
            want = per_image.get(k, 0) * len(LR_SIZES)
            if counts[config].get(k, 0) != want:
                raise AssertionError(f"{config} {k}: "
                                     f"{counts[config].get(k, 0)} launches, "
                                     f"expected {want}")
        db = psnr(read_image(str(out / name)), read_image(str(work / ref / name)))
        print(f"  {config} {name}: against {what} PSNR {db:.2f} dB (min "
              f"{PSNR_BF16_FUSION})")
        if not db >= PSNR_BF16_FUSION:
            raise AssertionError(f"{config} PSNR {db:.2f} < {PSNR_BF16_FUSION}")
    set_gates("default")
    del pipe
    return counts


def phase_serving(model_dir: Path, in_dir: Path, out_dir: Path,
                  per_image: dict):
    """Serve the three LR PNGs once; check the outputs and that each
    kernel of `per_image` launched that many times per image and no other
    kernel launched. Returns the launch counts."""
    from freqfusion_tpu_torch.interface.io import main
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.utils.image_io import read_image

    cuda.reset_launch_counts()
    seconds = main(str(model_dir), str(in_dir), str(out_dir), device="cuda")
    counts = dict(cuda.launch_counts)
    print(f"  launch counts: {json.dumps(counts, sort_keys=True)}")
    for name in set(per_image) | set(counts):
        want = per_image.get(name, 0) * len(LR_SIZES)
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name}: {counts.get(name, 0)} launches, "
                                 f"expected {want}")
    for name, (h, w) in LR_SIZES.items():
        sr = read_image(str(out_dir / f"{name}.png"))
        if sr.shape != (4 * h, 4 * w, 3) or not np.isfinite(sr).all():
            raise AssertionError(f"{name}: bad output {sr.shape}")
        if not (0.0 <= sr.min() and sr.max() <= 1.0 and sr.std() > 0.01):
            raise AssertionError(f"{name}: output range {sr.min()}..{sr.max()}"
                                 f" std {sr.std()}")
        print(f"  {name}: {h}x{w} -> {4 * h}x{4 * w}, "
              f"{seconds[name + '.png']:.3f} s/request, "
              f"{4 * h * 4 * w / seconds[name + '.png'] / 1e6:.3f} MP/s")
    return counts


def write_bmp(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB as an uncompressed 24-bit bottom-up BMP (BGR
    rows padded to 4 bytes)."""
    h, w, _ = img.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    body = rows.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body),
                            2835, 2835, 0, 0))
        f.write(body)


def phase_formats(model_dir: Path, in_dir: Path, work: Path) -> dict:
    """Serve an 8x12 PNG (shorter than the pad to 16), a BMP copy of the
    128x128 input and a JPEG through io.main on the card. The JPEG is
    written with PIL where PIL imports and must be served; otherwise it is
    a file only a JPEG decoder could read, and the run must name it and
    count it as skipped. Checks the default path's launch counts per
    served image, the outputs, and the BMP's output against phase 3's
    output of the same image as a PNG (equal). Returns the launch
    counts."""
    from freqfusion_tpu_torch.interface.io import main
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.utils.image_io import read_image, write_image

    src, out = work / "in_formats", work / "out_formats"
    src.mkdir()
    write_image(str(src / "a_8x12.png"),
                np.random.default_rng(3).uniform(0, 1, (8, 12, 3)))
    img = np.round(read_image(str(in_dir / "a_128x128.png")) * 255).astype(
        np.uint8)
    write_bmp(src / "b_128x128.bmp", img)
    sizes = {"a_8x12.png": (8, 12), "b_128x128.bmp": img.shape[:2]}
    crop = np.ascontiguousarray(img[:40, :56])
    try:
        from PIL import Image
        Image.fromarray(crop).save(src / "c_40x56.jpg", quality=90)
        sizes["c_40x56.jpg"] = crop.shape[:2]
    except ImportError:
        (src / "c_40x56.jpg").write_bytes(b"\xff\xd8\xff\xd9")  # SOI, EOI
    cuda.reset_launch_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        seconds = main(str(model_dir), str(src), str(out), device="cuda")
    counts = dict(cuda.launch_counts)
    print(log.getvalue(), end="")
    print(f"  launch counts: {json.dumps(counts, sort_keys=True)}")
    if sorted(seconds) != sorted(sizes):
        raise AssertionError(f"served {sorted(seconds)}, expected "
                             f"{sorted(sizes)}")
    if "c_40x56.jpg" not in sizes and not (
            "c_40x56.jpg skipped: " in log.getvalue()
            and "skipped 1: c_40x56.jpg" in log.getvalue()):
        raise AssertionError("the undecodable JPEG was not named and counted")
    for name in set(PER_IMAGE) | set(counts):
        want = PER_IMAGE.get(name, 0) * len(sizes)
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name}: {counts.get(name, 0)} launches, "
                                 f"expected {want}")
    for name, (h, w) in sizes.items():
        sr = read_image(str(out / f"{Path(name).stem}.png"))
        if (sr.shape != (4 * h, 4 * w, 3) or not np.isfinite(sr).all()
                or sr.std() <= 0.01):
            raise AssertionError(f"{name}: bad output {sr.shape}")
        print(f"  {name}: {h}x{w} -> {4 * h}x{4 * w}, "
              f"{seconds[name]:.3f} s/request")
    same = np.array_equal(read_image(str(out / "b_128x128.png")),
                          read_image(str(work / "out" / "a_128x128.png")))
    print(f"  b_128x128.bmp against phase 3's a_128x128.png: "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the BMP's output differs from the PNG's")
    return counts


def phase_pipeline_ab(model_dir: Path, image: Path, configs=tuple(CONFIGS),
                      rounds: int = 1) -> None:
    """Seconds per request of the pipeline alone on `image` in each of
    `configs`: a warm-up of each, then `rounds` times all in order and
    back; then the split by stage of the first configuration and of the
    bf16 ones where they are among `configs`. The gates are read at
    forward time; the experts' dtype at load time and the fusion net's at
    construction (FUSION_BF16), so each pair of dtypes has a pipeline of
    its own, built under its configuration."""
    from freqfusion_tpu_torch.interface.io import expert_dtype
    from freqfusion_tpu_torch.utils.image_io import read_image

    pipes = {}

    def pipe_of(config: str):
        set_gates(config)
        key = (expert_dtype(), config in FUSION_BF16)
        if key not in pipes:
            pipes[key] = build_pipeline(model_dir, "cuda", config)
        return pipes[key]

    lr = torch.from_numpy(read_image(str(image))).permute(2, 0, 1)[None]
    lr = lr.cuda()

    def run(config: str) -> float:
        pipe = pipe_of(config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            pipe(lr)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    order = list(configs)
    for config in order:
        run(config)
    times = {config: [] for config in order}
    for config in (order + order[::-1]) * rounds:
        times[config].append(run(config))
    set_gates("default")
    for config, t in times.items():
        mean = sum(t) / len(t)
        print(f"  {config}: {' '.join(f'{v:.3f}' for v in t)} s, mean "
              f"{mean:.3f} s ("
              f"{4 * lr.shape[2] * 4 * lr.shape[3] / mean / 1e6:.3f} MP/s)")
    for config in dict.fromkeys((order[0], "bf16", "bf16-byte-floor",
                                 *FUSION_BF16)):
        if config in order:
            stage_split(pipe_of(config), lr, config)
    set_gates("default")
    del pipes


def stage_split(pipe, lr, config: str = "default") -> None:
    """Device time of each expert alone on `lr` (a multiple of 16: the
    pipeline's pad is empty) and of the whole pipeline, in `config`, CUDA
    events, median of 3 after a warm-up; the rest (fusion net, crops) is
    the difference."""
    if lr.shape[2] % 16 or lr.shape[3] % 16:
        raise ValueError("stage_split needs an LR image with sides that "
                         "are multiples of 16")
    set_gates(config)
    x = lr.to(pipe.expert_dtype or lr.dtype)
    with torch.inference_mode():
        whole = cuda_ms(lambda: pipe(lr), reps=3, warmup=1)
        split = {name: cuda_ms(lambda e=expert: e(x), reps=3, warmup=1)
                 for name, expert in pipe.experts.items()}
    set_gates("default")
    print(f"  {config} by stage (CUDA events, median of 3): pipeline "
          f"{whole:.1f} ms; " + ", ".join(
              f"{name} {ms:.1f}" for name, ms in split.items())
          + f"; fusion net and crops {whole - sum(split.values()):.1f} ms")


def load_mambair(model_dir: Path, device):
    """The full-width MambaIR expert alone, from its checkpoint."""
    from freqfusion_tpu_torch.interface.io import (_TORCH_FILES,
                                                   load_state_dict_file)
    from freqfusion_tpu_torch.models.pipeline import build_expert_models

    model = build_expert_models(4, generator=torch.Generator().manual_seed(0),
                                names=("mamba",))["mamba"]
    model.load_state_dict(load_state_dict_file(
        model_dir / _TORCH_FILES["mamba"]))
    return model.to(device).eval()


def phase_bidir(model_dir: Path, image: Path) -> dict:
    """MambaIR alone on `image` (100x140: neither side a multiple of 8,
    so SS2D takes the bidir route), not padded, in fp32 and then in bf16
    (the model cast as the bf16 expert mode casts it, the input in bf16):
    launch counts (36 of #8, or of the bf16 #8, and no other kernel),
    output checks and seconds; each time the card against the CPU's plain
    route on the same weights at 20x28 (fp32: PSNR >= 60 dB; both in bf16:
    >= 48); then the bf16 output against the fp32 one (PSNR >= 48 dB).
    Returns the launch counts of both runs ("bidir", "bidir-bf16")."""
    from freqfusion_tpu_torch.ops import cuda
    from freqfusion_tpu_torch.utils.image_io import read_image

    model = load_mambair(model_dir, "cuda")
    lr = torch.from_numpy(read_image(str(image))).permute(2, 0, 1)[None]
    lr = lr.cuda()
    h, w = lr.shape[2:]
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 3, 20, 28)).astype(np.float32))
    counts, srs = {}, {}
    for label, dtype, per_image, floor in (
            ("bidir", torch.float32, PER_IMAGE_BIDIR, PSNR_MIN),
            ("bidir-bf16", torch.bfloat16, PER_IMAGE_BF16_BIDIR,
             PSNR_BF16_CARD_CPU)):
        model.to(dtype)
        cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            sr, feat = model(lr.to(dtype))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = dict(cuda.launch_counts)
        print(f"  {label} launch counts: "
              f"{json.dumps(counts[label], sort_keys=True)}")
        if counts[label] != per_image:
            raise AssertionError(f"MambaIR ({label}) at {h}x{w}: launches "
                                 f"{counts[label]}, expected {per_image}")
        if (sr.shape != (1, 3, 4 * h, 4 * w) or feat.shape != (1, 180, h, w)
                or sr.dtype != dtype
                or not bool(torch.isfinite(sr).all())
                or not bool(torch.isfinite(feat).all())):
            raise AssertionError(f"MambaIR ({label}) at {h}x{w}: bad output "
                                 f"{sr.shape} {sr.dtype} {feat.shape}")
        srs[label] = sr.float().cpu()
        print(f"  MambaIR ({label}) {h}x{w} -> {4 * h}x{4 * w}: "
              f"{seconds:.3f} s (first call)")
        with torch.inference_mode():
            on_card = model(x.cuda().to(dtype))[0].float().cpu()
            on_cpu = load_mambair(model_dir, "cpu").to(dtype)(
                x.to(dtype))[0].float()
        db = psnr(on_card, on_cpu)
        print(f"  card vs CPU, MambaIR ({label}) on 20x28: max_abs "
              f"{(on_card - on_cpu).abs().max().item():.3e}, PSNR {db:.2f} "
              f"dB (min {floor})")
        if not db >= floor:
            raise AssertionError(f"{label} card vs CPU PSNR {db:.2f} < "
                                 f"{floor}")
    db = psnr(srs["bidir-bf16"], srs["bidir"])
    print(f"  MambaIR {h}x{w}, bf16 against fp32: PSNR {db:.2f} dB (min "
          f"{PSNR_BF16_EXPERT})")
    if not db >= PSNR_BF16_EXPERT:
        raise AssertionError(f"bidir bf16 against fp32 PSNR {db:.2f} < "
                             f"{PSNR_BF16_EXPERT}")
    return counts


# the bf16 configuration served through the CLI in a process of its own;
# TF32 off there too, as in this script, so that its output compares with
# phase 3's
NTIRE_DRIVER = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from freqfusion_tpu_torch.interface import ntire
from freqfusion_tpu_torch.ops import cuda
ntire.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(dict(cuda.launch_counts)))
"""


def phase_ntire_bf16(model_dir: Path, in_dir: Path, work: Path) -> dict:
    """The bf16 configuration (FREQFUSION_EXPERT_DTYPE=bf16) served by
    ``python -m freqfusion_tpu_torch.interface.ntire``'s main in a
    subprocess whose working directory holds
    model_zoo/team29_FreqFusionSR (the seeded checkpoints): results.json,
    the three outputs, the bf16 kernels' launches per image and no other
    kernel's, the 336x512 output against phase 3's fp32 one (PSNR >= 52
    dB); then each expert alone in bf16 against its fp32 output on the
    336x512 image (PSNR >= 48 dB). Returns the launch counts."""
    from freqfusion_tpu_torch.interface.io import load_pipeline
    from freqfusion_tpu_torch.utils.image_io import read_image

    cwd = work / "ntire"
    (cwd / "model_zoo").mkdir(parents=True)
    (cwd / "model_zoo" / "team29_FreqFusionSR").symlink_to(model_dir)
    env = dict(os.environ, FREQFUSION_EXPERT_DTYPE="bf16",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)).rstrip(os.pathsep))
    proc = subprocess.run(
        [sys.executable, "-c", NTIRE_DRIVER, "--test_dir", str(in_dir)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("LAUNCHES "):
            print("  | " + line)
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        raise AssertionError(f"the ntire CLI exited {proc.returncode}")
    counts = json.loads(next(line for line in lines
                             if line.startswith("LAUNCHES "))[9:])
    print(f"  launch counts: {json.dumps(counts, sort_keys=True)}")
    for name in set(PER_IMAGE_BF16) | set(counts):
        want = PER_IMAGE_BF16.get(name, 0) * len(LR_SIZES)
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name}: {counts.get(name, 0)} launches, "
                                 f"expected {want}")
    results = json.loads((cwd / "results.json").read_text())
    print(f"  results.json: {json.dumps(results)}")
    if list(results) != ["29_FreqFusionSR_test_ms"]:
        raise AssertionError(f"results.json keys {list(results)}")
    out = cwd / "results" / "29_FreqFusionSR" / "test"
    for name, (h, w) in LR_SIZES.items():
        sr = read_image(str(out / f"{name}.png"))
        if sr.shape != (4 * h, 4 * w, 3) or sr.std() <= 0.01:
            raise AssertionError(f"{name}: bad bf16 output {sr.shape}")
    name = "c_336x512.png"
    db = psnr(read_image(str(out / name)),
              read_image(str(work / "out" / name)))
    print(f"  {name}: bf16 experts against phase 3's fp32 output PSNR "
          f"{db:.2f} dB (min {PSNR_BF16_PIPELINE})")
    if not db >= PSNR_BF16_PIPELINE:
        raise AssertionError(f"bf16 against fp32 PSNR {db:.2f} < "
                             f"{PSNR_BF16_PIPELINE}")

    lr = torch.from_numpy(read_image(str(in_dir / name))).permute(
        2, 0, 1)[None].cuda()
    srs = {}
    for dtype in ("", "bf16"):
        os.environ["FREQFUSION_EXPERT_DTYPE"] = dtype
        pipe = load_pipeline(str(model_dir), "cuda", verbose=False)
        with torch.inference_mode():
            srs[dtype] = {n: e(lr.to(pipe.expert_dtype or lr.dtype))[0]
                          .float().cpu() for n, e in pipe.experts.items()}
        del pipe
        torch.cuda.empty_cache()
    os.environ.pop("FREQFUSION_EXPERT_DTYPE")
    for n in srs[""]:
        db = psnr(srs["bf16"][n], srs[""][n])
        print(f"  {n} alone, bf16 against fp32 on 336x512: PSNR {db:.2f} "
              f"dB (min {PSNR_BF16_EXPERT})")
        if not db >= PSNR_BF16_EXPERT:
            raise AssertionError(f"{n} bf16 against fp32 PSNR {db:.2f} < "
                                 f"{PSNR_BF16_EXPERT}")
    return counts


def phase_card_vs_cpu(model_dir: Path, config: str,
                      floor: float = PSNR_MIN) -> None:
    """The pipeline of `config` (build_pipeline) on the card and on the
    CPU, one 32x48 LR: PSNR >= floor."""
    lr = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 3, 32, 48)).astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = build_pipeline(model_dir, dev, config)
        t0 = time.perf_counter()
        with torch.inference_mode():
            outs[dev] = pipe(lr.to(dev)).cpu()
        print(f"  {dev}: {time.perf_counter() - t0:.2f} s")
        del pipe
    diff = (outs["cuda"] - outs["cpu"]).abs()
    db = psnr(outs["cuda"], outs["cpu"])
    print(f"  card vs CPU on 32x48: max_abs {diff.max().item():.3e}, "
          f"PSNR {db:.2f} dB (min {floor})")
    if not db >= floor:
        raise AssertionError(f"card vs CPU PSNR {db:.2f} < {floor}")


def main(argv) -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from freqfusion_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: the freqfusion_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 3

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[1] device: {kind}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmul and cuDNN: fp32 throughout")
    lib_path = cuda.build(ptxas_verbose=True)
    if cuda.build_seconds is None:
        print(f"  kernels already built: {lib_path}")
    else:
        print(f"  nvcc build: {cuda.build_seconds:.1f} s -> {lib_path}; ptxas:")
    for line in cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    if cuda.build_seconds is not None:
        check_spills(cuda.build_log, not any(
            a.endswith("-only") for a in argv))
    cuda.library()
    dev = torch.device("cuda")

    for flag, what, phase in (("--fused-only", "byte-floor",
                               phase_fused_kernels),
                              ("--qkv-only", "in-kernel projection",
                               phase_qkv_all),
                              ("--fusion-only", "fusion-eval",
                               phase_fusion_kernels),
                              ("--scan-only", "scan (fp32, then bf16)",
                               phase_scan_all),
                              ("--nhwc-attention-only", "window attention (#1)",
                               functools.partial(phase_window_kernels,
                                                 window_major=False)),
                              ("--grl-only", "GRL mixed attention (#2, #12)",
                               phase_grl_kernels),
                              ("--token-only", "token attention (#13)",
                               phase_token_all),
                              ("--grl-hier-bf16-only",
                               "bf16 GRL mixed attention and hierarchical "
                               "stage 3 (#2, #12, #19)", phase_grl_hier_bf16),
                              ("--bf16-only",
                               "bf16 (#1, #2, #3/#4, #5, #8, #9, "
                               "#11-#21)",
                               phase_bf16_kernels)):
        if flag in argv:
            print(f"[2] the {what} kernels against their plain versions")
            checks = {}
            g = torch.Generator(device=dev).manual_seed(0)
            phase(dev, lambda *shape, scale=1.0: torch.randn(
                *shape, generator=g, device=dev) * scale, checks)
            print(json.dumps({flag[2:-5] + "_kernels": [
                c.entry(0) for c in checks.values()]}))
            print(f"card: {smi}")
            return 0

    if "--pipeline-only" in argv:
        at = argv.index("--pipeline-only") + 1
        config = argv[at] if at < len(argv) else "default"
        if config not in CONFIGS:
            raise SystemExit(f"chip_smoke: unknown configuration {config!r}"
                             f" (one of {', '.join(CONFIGS)})")
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            model_dir, in_dir = work / "models", work / "in"
            model_dir.mkdir()
            in_dir.mkdir()
            write_checkpoints(model_dir)
            write_inputs(in_dir)
            print(f"[3c] pipeline alone, 336x512, {config} configuration, "
                  "6 runs")
            phase_pipeline_ab(model_dir, in_dir / "c_336x512.png",
                              (config,), rounds=3)
        print(f"card: {smi}")
        return 0

    print("[2] kernels against their plain versions (336x512 bucket)")
    checks = phase_kernels(dev)
    torch.cuda.empty_cache()
    print(f"  phases 1-2 took {time.perf_counter() - t0:.0f} s")

    from freqfusion_tpu_torch.utils.image_io import read_image

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        model_dir, in_dir = work / "models", work / "in"
        model_dir.mkdir()
        in_dir.mkdir()
        write_checkpoints(model_dir)
        write_inputs(in_dir)
        set_gates("default")
        print("[3] serving through freqfusion_tpu_torch.interface.io.main, "
              "default path")
        counts = {"default": phase_serving(model_dir, in_dir, work / "out",
                                           PER_IMAGE)}
        torch.cuda.empty_cache()
        print("[3i] serving an 8x12 PNG, a BMP copy of the 128x128 PNG and "
              "a JPEG, default path")
        counts["formats"] = phase_formats(model_dir, in_dir, work)
        torch.cuda.empty_cache()
        name = "c_336x512.png"
        for phase, config, per_image in (("3b", "byte-floor", PER_IMAGE_GATED),
                                         ("3d", "projection", PER_IMAGE_QKV),
                                         ("3e", "fusion-eval",
                                          PER_IMAGE_FUSION),
                                         ("3f", "chainv5", PER_IMAGE_CHAINV5),
                                         ("3g", "spatial", PER_IMAGE_SPATIAL)):
            print(f"[{phase}] serving, {config} configuration (" + ", ".join(
                f"{k}={v}" for k, v in CONFIGS[config].items()) + ")")
            set_gates(config)
            out = work / f"out_{config}"
            counts[config] = phase_serving(model_dir, in_dir, out, per_image)
            db = psnr(read_image(str(out / name)),
                      read_image(str(work / "out" / name)))
            print(f"  {name}: against the default path PSNR {db:.2f} dB "
                  f"(min {PSNR_MIN})")
            if not db >= PSNR_MIN:
                raise AssertionError(f"{config} against the default path "
                                     f"PSNR {db:.2f} < {PSNR_MIN}")
            set_gates("default")
            torch.cuda.empty_cache()
        print("[3h] MambaIR alone, bidir route, 100x140 not padded, fp32 "
              "and bf16")
        counts.update(phase_bidir(model_dir, in_dir / "b_100x140.png"))
        torch.cuda.empty_cache()
        print("[3j] serving, bf16 configuration (FREQFUSION_EXPERT_DTYPE="
              "bf16), through python -m freqfusion_tpu_torch.interface.ntire")
        counts["bf16"] = phase_ntire_bf16(model_dir, in_dir, work)
        torch.cuda.empty_cache()
        print("[3k] serving, bf16 byte-floor configuration (" + ", ".join(
            f"{k}={v}" for k, v in CONFIGS["bf16-byte-floor"].items())
            + ")")
        set_gates("bf16-byte-floor")
        out = work / "out_bf16-byte-floor"
        counts["bf16-byte-floor"] = phase_serving(model_dir, in_dir, out,
                                                  PER_IMAGE_BF16_GATED)
        db = psnr(read_image(str(out / name)),
                  read_image(str(work / "out_byte-floor" / name)))
        print(f"  {name}: against phase 3b's fp32 byte-floor output PSNR "
              f"{db:.2f} dB (min {PSNR_BF16_PIPELINE})")
        if not db >= PSNR_BF16_PIPELINE:
            raise AssertionError(f"bf16 byte-floor against byte-floor PSNR "
                                 f"{db:.2f} < {PSNR_BF16_PIPELINE}")
        set_gates("default")
        torch.cuda.empty_cache()
        print("[3l] serving, the experts and the fusion net in bf16 "
              "(expert_dtype and fusion_dtype bf16), with the fusion-eval "
              "gates, with the projection gates, on the chainv5 and "
              "spatial routes and without")
        counts.update(phase_bf16_fusion(model_dir, in_dir, work))
        torch.cuda.empty_cache()
        print(f"[3c] pipeline alone, 336x512, the {len(CONFIGS)} "
              "configurations in turns")
        phase_pipeline_ab(model_dir, in_dir / name)
        torch.cuda.empty_cache()
        for config in CONFIGS:
            if config in NO_CARD_VS_CPU:
                continue
            print(f"[4] card against CPU, {config} configuration")
            phase_card_vs_cpu(model_dir, config, PSNR_BF16_CARD_CPU
                              if "FREQFUSION_EXPERT_DTYPE" in CONFIGS[config]
                              else PSNR_MIN)
        set_gates("default")

    # launches: each kernel's count from the run of its own configuration
    # (#6 and #7 lie on no path: 0)
    launches = {k: counts[config].get(k, 0) for config, per_image in (
        ("byte-floor", PER_IMAGE_GATED), ("projection", PER_IMAGE_QKV),
        ("fusion-eval", PER_IMAGE_FUSION), ("chainv5", PER_IMAGE_CHAINV5),
        ("spatial", PER_IMAGE_SPATIAL), ("bidir", PER_IMAGE_BIDIR),
        ("bidir-bf16", PER_IMAGE_BF16_BIDIR),
        ("bf16-chainv5", PER_IMAGE_BF16_CHAINV5),
        ("bf16-spatial", PER_IMAGE_BF16_SPATIAL),
        ("bf16-fusion-eval", PER_IMAGE_BF16_FUSION),
        ("bf16-projection", PER_IMAGE_BF16_QKV),
        ("bf16-byte-floor", PER_IMAGE_BF16_GATED), ("bf16", PER_IMAGE_BF16),
        ("default", PER_IMAGE)) for k in per_image}
    print(f"all phases took {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": [c.entry(launches.get(c.name, 0))
                                  for c in checks.values()]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
