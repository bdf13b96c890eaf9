#!/usr/bin/env python3
"""Drives the hugs_tpu_torch serving render, scene training, the avatar
serving frame, the three micro-benchmarks, human training, joint
human + scene training through the port's CLI, the evaluation of its
output (validate, animate, the turntable, the inference fast path), its
scale-out (image bands, batched animate, the batched joint step
through torch.distributed), the Gaussian-sharded renderer and scene
step, the convergence recipes (cut) with the blend kernels' edge
scenes, the blend kernels' POWER_MXU mode, and the scaling harness and
fragment-packet sizing on one NVIDIA GPU (and on several, where the
machine has them, for one data x tile step and the scaling runs).

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It builds the CUDA kernels (K1, the forward blend; K2, its backward,
which also adds each instance's gradient onto its Gaussian, and S3, K2's
skeleton variants, in the same source; S2, the elementwise rate probe;
S1, the bf16 probe) from the sources in the checkout, one nvcc per
source, all together, then:

  1. setup: TF32 off, the card's name and power limit, the build time,
     each kernel's registers, static shared memory, spills and resident
     blocks per SM (ptxas's report from this run's build, or the one
     kept beside a library built earlier from the same source);
  2. K1 against its plain PyTorch version at full width (50k Gaussians,
     SH degree 3, 960x540), on the same bins, plus the whole tiled render
     against the dense oracle on two small scenes, one saturated so that
     K1's early exit fires;
  2b. K2 against its plain version (plain_blend_bwd) on the same bins and
     K1's outputs, with a random d(loss)/d(image) drawn from a seed;
     the share of the (warp, instance) pairs K1 and K2 cull that the
     warp cull drops;
  3. the serving path through the user's entry points: a PLY of that
     scene -> create_from_ply -> compact -> scene_forward ->
     render_human_scene(render_mode="scene") for 4 camera views;
  3b. the training path at full width: targets rendered from that scene
     (bg 0) for the 4 views, a trainee from create_from_pcd of its noisy
     means (capacity 65,536), 40 scene_train_step calls cycling the
     views, one_up_sh_degree every 10 steps, scene_densify_step at step
     20 and an opacity reset at step 35; then K1 and K2 against their
     plain versions again on the frame step 0 gave them (view 0 at the
     training budget), K2 with that step's d(loss)/d(raw colour);
     each path runs with the kernel launch counts set to 0 just before
     it and read just after;
  3c. the avatar serving path (scripts/fps_bench_tpu.py's frame, run
     after phase 4's times): synthetic_smpl(288) subdivided twice gives
     69,105 human Gaussians in capacity 131,072, decoded once
     (canon_forward), compacted to a 2048-row bucket; a 100,000-Gaussian
     scene at SH degree 3 in a radius-4 ball around the camera; 960x540
     from the orbit's first camera. A rehearsal sizes the slot budget
     from 20 frames' demand; then 20 frames, each a new body pose ->
     human_forward (LBS of the cached decode) -> render_human_scene
     (human_scene), one K1 launch per frame. Checks: (a) human_forward
     on the card against the CPU, (b) K1 against plain on frame 0, (c)
     the cached frame against the full forward (triplane and decoders
     per frame), (d) no overflow, (e) 20 K1 launches; then the frame's
     stage times, its device kernels and idle share, and K1's time and
     bound on it;
  3d. the micro-benchmarks (run after phase 4's times and 3c), each
     through its entry point's function at its script's full size, with
     the launch counts set to 0 just before and read just after: S2
     (hugs_tpu_torch.micro.vpu_peak: GRID 512, INNER 64, REPS 3) the
     fma, serial and blendmix rates and the FFMA count of fma's SASS
     (must be INNER x 4 per step); S1 (micro_bf16: r 8192 and 32768, K
     20) madd and exp in float32 and bfloat16, each r_scaling within
     3.5-4.5; S3 (micro_bwd: phase 2's scene, g = ones) K2's skeleton
     variants, K2 and K1 + K2 timed, each variant at K2's resident
     blocks per SM (checked); then each kernel against its plain
     version (S2 at grid 16, S1 at r 256 and K 2 from a linspace start,
     S3 on the whole frame), each variant's bound, S2's and S1's bounds
     per pipe (each mode's loop in the SASS counted by pipe, FP32 at 128
     lanes per SM per clock, MUFU at 16, the ALU at 64, issue at 128, at
     the SM clock nvidia-smi reads while the mode runs), and K1's and K2's
     operation counts over S2's blendmix rate (`ms_at_s2_blendmix_rate`:
     a second reading beside the bound, not a bound: the counts weigh a
     culled pair's 91 cheap operations as blendmix's mix, so a kernel
     can beat it);
  3e. the human training path (config[2], cfg_files/neuman/hugs_human.
     yaml; run after 3d): check (b) first, one human_train_step on the
     parity tests' small avatar on the card against the CPU; then the
     ground truth of scripts/human_avatar_tpu.py, 24 frames of striped
     splats on the posed synthetic_smpl(288) from the orbit at distance
     2.6, each rendered on black and white (mask: transmittance < 0.5);
     phase 3c's body (69,105 Gaussians) in the trainer's capacity
     524,288 with the frames' poses; distill_init (HUMAN_DISTILL steps);
     30 human_train_step calls cycling the frames (L1 0.8, SSIM 0.2,
     patch LPIPS 1.0 on 4 patches of 128, LBS 1000, white background,
     pose and translation optimised), one_up_sh_degree at step 10 (held
     at degree 0) and human_densify_step at step 15; the budget from a
     rehearsal of the whole run on a copy (its largest slot demand x
     1.15: the splats grow after Adam's first steps). Checks: (a) K1
     and K2 against their plain versions on step 0's whole frame, K2 fed
     that step's d(loss)/d(raw colour) (float64 fallback), (c) every
     loss, parameter, moment and gradient finite on the live rows, (d)
     no overflow, (e) one K1 and one K2 launch per step, (f) step 0's
     frame and draws give a lower L1 + SSIM + patch LPIPS after the run
     (the LBS term, which does not depend on the frame, printed beside
     it); then a step's stage times (the patch LPIPS alone beside them),
     a distillation step, the densify, the device kernels and idle share
     of a step, and K1's and K2's times and bounds on step 0's frame;
  3f. the joint training path (config[3], cfg_files/neuman/hugs_human_
     scene.yaml unchanged in width: human capacity 524,288, scene
     capacity 2,097,152, a 256^2 triplane, 2 subdivisions, L1 0.8, SSIM
     0.2, patch LPIPS 1.0, LBS 1000, humansep 1.0, pose and translation
     optimised, white background; run after 3e): check (b) first, one
     joint step on the small avatar and a 300-point scene on the card
     against the CPU; then a NeuMan-layout sequence `lab` written with
     the port's PNG writer (phase 3e's striped body posed by gt_poses
     amid phase 3c's 100,000-point scene, 960x540, 24 frames of the orbit
     at 2.6, masks from the body's alpha, COLMAP text cameras and points,
     the SMPL parameters) with an AMASS-layout clip of 80 frames (20
     anim frames at lab's step 4: gt_poses' swing, orientations and
     translations that lab's alignment carries back onto the trained
     body) and hugs_tpu_torch.main.main on it with the cuts JOINT_CUTS
     lists (30 steps, a 1,000-step distillation, both sets densified at
     steps 15 and 30, validate at 30, an 8-frame turntable), which
     after training validates, animates and renders the turntable.
     Checks: (a) K1 and K2 against their plain versions on step 0's
     merged frame (K2 fed that frame's d(loss)/d(raw colour), float64
     too), (c) step 0's frame and draws give lower L1 + SSIM + LPIPS
     terms (humansep's included) after the run, every parameter and
     moment finite on the live rows, (d) a new trainer resumes the final
     checkpoint bit for bit, (e) validate's metrics finite under
     hugs_tpu's keys, (f) two K2 launches per step and two K1 per render
     of a step, one K1 per frame of iteration 0's turntable, and after
     train() one K1 per validated, animated and turntable frame; then a
     step through the trainer and by stage, a distillation step, each
     densify, the device kernels and idle share of a step, and K1's and
     K2's times and bounds on the merged frame;
  3g. evaluation (run after 3f): hugs_tpu_torch.evaluate.evaluate, the
     entry function of `python -m hugs_tpu_torch.evaluate`, in-process
     on phase 3f's output directory (the port's checkpoint at step 30 at
     config[3]'s capacities): load, compact_for_eval, rehearse_budget
     (binning-only probes of the val and anim frames), validate, animate
     (20 frames) and the turntable. Checks: (a) K1 against plain on anim
     frame 0's merged frame, (b) anim frame 0 on the card against the
     same states on the CPU (human_forward at phase 3c's bar, the image
     at EVAL_CPU_WH: the CPU's plain blend pads each tile to the densest),
     (c) results_eval.json equals phase 3f's validate (1e-3 dB PSNR,
     1e-5 SSIM), (d) 20 anim PNGs, one K1 per anim frame, none in the
     rehearsal, no overflow, the human's share of every frame (its pass
     alone, against its background) nonzero, consecutive frames
     different, (e) the turntable's frames at 128^2, one K1 each, (f)
     the fast path (train/trainer.py's PoseRenderer, render_poses) on
     the 20 anim body poses from fps_bench_tpu.py's camera against
     render_frame per pose; its frame latency (median of 20, CUDA
     events), its split human_forward / project / bin / blend, its
     device kernels per frame and idle share; then evaluate's stage
     times and K1's time and bound on anim frame 0;
  3h. config[4]'s scale-out on phase 3f's run (after 3g): (a) anim
     frame 0's merged frame (3g's compacted states, the rehearsed
     budget) in 2 and 4 horizontal bands through
     parallel/shard.py::blend_band, stitched: the image held to the
     one-band frame (K1, image bar) and an L1 loss's gradient of the
     blend's inputs (mean2d, conic, colour, opacity) to the one-band
     gradient (K2's bars), n_bands K1 and K2 launches, each band's K1
     and K2 times; (b) animate in batches of 4 (train.anim_batch_size)
     against one frame at a time: every frame within the image bar, one
     K1 a frame, ms a frame of both; (c) a trainer at train.batch_size 2
     resuming 3f's final checkpoint inside a one-rank NCCL group (its
     (1, 1) mesh runs every collective): the first batch's loss equals
     the mean of its two frames' losses from joint_step's pieces on the
     same draws, its gradients the mean of theirs at K2's bars; 3 steps
     through train() (4 K1 and 4 K2 launches a step), a step's stages,
     its device kernels and idle share; (d) with 2 or more cards, one
     data x tile step of the same batch on min(4, cards) NCCL ranks
     (mesh factored as __graft_entry__.py's dryrun_multichip): the loss
     (c)'s and the states bit for bit equal across ranks; with one card
     a line says it did not run;
  3i. the Gaussian-sharded path (tpu.gauss_shard) on phase 3f's run
     (after 3h): (a) anim frame 0's merged set at 3f's capacities
     (2,621,440 rows) through render(gauss_mesh=<one rank>) against
     render(): the image (K1 on the fragment band), an L1 loss's
     gradient of xyz, scales, rotq, opacity and shs (K2, K2's bars), the
     fragments equal to the kept instances, one K1 and one K2; K1 and K2
     on the fragment band against the plain bins with their bounds, the
     pack and sort times, the peak memory; (b) on 3f's scene (2,097,152
     rows) GAUSS_STEPS[0] gauss steps, a densify fed the same noise and
     GAUSS_STEPS[1] more against scene_train_step on copies of the same
     state: the loss each step within GAUSS_LOSS_RTOL, n_alive equal, the
     step by stage; (c) hugs_tpu_torch.main in scene mode with
     tpu.gauss_shard 1 for GAUSS_MAIN_STEPS steps (K1 a step, a val and
     an anim frame), render_frame with gauss_shard 1 against 0; (d)
     graft_entry.entry()'s frame and dryrun_multichip(1); (e) the
     per-Gaussian avatar on 3c's body through K1 at W x H, and at
     EVAL_CPU_WH against the CPU;
  3j. the convergence recipes of hugs_tpu_torch/convergence, cut (after
     3i): (a) micro/kernel_parity.py's scenes (multichunk_empty,
     saturating, tile16, tight_budget, gather) through K1 and K2 against
     their plain versions, end to end at the script's bars (image 5e-5,
     gradients 5e-4 relative) and kernel by kernel at K1's and K2's bars;
     (b) human_avatar and joint_scene at full width (512x512, 24 frames)
     through their own functions, the distillation cut to
     RECIPE_DISTILL steps, RECIPE_STEPS training steps: the held-out PSNR
     finite and RECIPE_GAIN_DB above step 0's, one K2 launch per render
     of a step (the joint step renders the merged frame and the human
     alone), frame 0's ground truth (K1's render) against plain_blend;
     (c) surface_scene at 960x540 for SURFACE_STEPS steps through
     GaussianTrainer with the automatic budget: no overflow left after a
     retry, the losses and the PSNR finite, one K2 a step, view 0's
     ground truth against plain_blend; the phase's time and each recipe's
     steps/s;
  3k. the blend kernels' POWER_MXU mode (after 3j; K1 and K2 with the
     Gaussian exponent as the recentred-basis product on the tensor
     cores, pallas_blend.py's second mode): (a) K1 and K2 in the mode
     against the plain mode on phase 2's serving frame and phase 3b's
     step-0 training frame at K1's and K2's bars (K2 on the training
     frame also against the plain mode in float64), the pixels beyond
     the image bar with each pair at a cutoff (1/255, POW_EPS) and its
     power; (b) the mode against the exact kernels; (c) both modes'
     device ms in turns (exact, mode, mode, exact) and the mode's one
     call alone, the mode's bound (its
     float operations over the fp32 peak, the product's tensor-core flops
     per kept (warp, instance) pair over the bf16 peak, its bytes) and
     its float operations over S2's blendmix rate, beside the design's
     own groups, mma and column fill (micro.mxu_groups), registers,
     shared memory and blocks per SM, and the warp cull's drops that
     reach 1/255 in the mode (none allowed); (d) the
     user's path with the mode as render()'s default (cuda_blend.
     POWER_MXU, restored after): phase 3's 4 serving views and
     MXU_STEPS scene_train_step calls of phase 3b's recipe against the
     same steps in the exact mode, the losses within MXU_LOSS_RTOL, the
     launches counted per mode; (e) micro/kernel_parity.py's five
     scenes in both modes at the script's bars;
  3l. the scaling harness and the fragment-packet sizing (after 3k):
     (a) hugs_tpu_torch.scaling_bench's worker at world 1 in a one-rank
     NCCL group of its own process (parallel/launch.py::run_ranks) at
     full width (SCALING_FULL: 960x540, synthetic_smpl(288), human and
     scene capacity 524,288, a 256^2 triplane of 32 features, the band
     budget from a binning-only probe, 5 timed steps), its JSON line,
     one K1 and one K2 launch a step, no overflow, a finite loss; (b)
     its frame through K1 and K2 against their plain versions (K2 in
     float64 too); (c) hugs_tpu_torch.gauss_frag_sizing at D = 1 (the
     script's 65,536-point scene, 6 cameras at 480x272), its JSON line,
     6 K1 launches; (d) its camera 0's packet against the frame's kept
     instances, K1 against plain there;
  4. times on the card (CUDA events, median of 20 after warm-up): one
     request split into project / bin / blend, one training step split
     into forward / loss / backward / Adam + stats, one densify step,
     the device's idle share and the top device kernels from
     torch.profiler traces of 5 requests and of 3 training steps (which
     must list no index_add_ kernel); then, on both frames, K1's and
     K2's device time over back-to-back launches, one call's latency,
     the plain versions' times and each kernel's bound, the least time
     the card could take for the work this frame needs of it (and the
     bound at the first kernels' operation count, the yardstick that
     compares designs);
  5. one JSON line of the kernels (K1 and K2 in the POWER_MXU mode
     among them); 6. the device line, last.

Any failed phase raises and the script exits non-zero (1, the
exception's traceback on stderr). Without a CUDA device it exits 2;
copied alone into a directory without the repository's hugs_tpu_torch
beside it, its first import fails and it exits 1; neither prints a
result.

`python3 chip_smoke.py --scale-out` runs phase 3h's checks (c) and (d)
alone, on phase 3f's sequence trained for 2 steps, then with
GAUSS_SCALE_OUT cards tpu.gauss_shard=GAUSS_SCALE_OUT on as many NCCL
ranks (val frame 0 and the gauss steps with a densify against world 1)
and dryrun_multichip(GAUSS_SCALE_OUT), then scaling_bench's launcher
over 1, 2 and 4 cards at phase 3l's size (each run's state digests
equal across its ranks) and the sizing on SIZING_RANKS NCCL ranks
against as many gloo ranks of the CPU: the paths a machine with several
cards exists for (on one card each says it did not run).
"""
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from hugs_tpu_torch.micro import (  # noqa: E402
    card, device_kernels, device_ms, feat_rows_read, warp_cull_counts,
)

W, H = 960, 540
N_GAUSS = 50_000
SEED = 0
BG = (0.2, 0.3, 0.4)
REPS = 20
PROFILED = 5   # requests in the profiler's window
PROFILED_STEPS = 3   # training steps in the profiler's window
BACK_TO_BACK = 20   # kernel launches per timed span
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float operations per (pixel, instance) pair tested (pair_alpha: 22),
# the extra ones K1 spends per pair it blends (12), and the ones K2 spends
# per pair with alpha > 0 (pair_grad: 38, and 9 adds to sum its nine
# values into its instance's)
OPS_TESTED = 22
OPS_BLENDED = 12
OPS_BWD_BLENDED = 38 + 9
# the warp cull of one (warp, instance), cull_keep in blend_common.cuh:
# the clamp and disk test 11, the rectangle's offsets and inside test 8,
# the safe conic 2, four edges at 14 each, their minimum 4, the conic's
# definiteness 6 and the opacity test 4; and the sum of a kept (warp,
# instance)'s nine values over the block's warps in K2
OPS_CULL = 91
OPS_WARP_SUM = 9
# the yardstick: the bound at the first kernels' count, which charges every
# pair of the walk as tested (culled or not) and K2 57 per blended pair,
# so that times of every design read against one bound
OPS_BWD_BLENDED_FIRST = 57
# K1 holds to its plain version: the two sum log1p(-alpha) in another
# order, so a pixel at the T_EPS threshold may flip, which moves it by at
# most 0.99 * 1e-4 times its colour
PIXEL_ATOL = 2e-5
MIN_SHARE = 0.9999
MAX_ABS = 1e-3
# K2 holds to its plain version per feature column: the sums run in
# another order, K2's atomics add in an order that is not fixed, and a
# pair at the T_EPS threshold may flip
GRAD_ATOL, GRAD_RTOL, GRAD_SHARE, GRAD_REL_NORM = 1e-5, 1e-3, 0.999, 1e-4
BG_RTOL = 1e-4
# On the training frame the norm bar is taken against the plain version
# evaluated in float64, and K2 may be REF64_SLACK times as far from it as
# the float32 plain version is. There every splat is the same grey on a
# black background, so d_alpha = g T_i - S / (1 - alpha) cancels down to
# about g T_fin / (1 - alpha), and float32 rounding in either version is
# amplified up to T_i / T_fin (1e4); the position and conic-b gradients
# of its isotropic splats sum to near zero by symmetry
REF64_SLACK = 2.0
# the training path
CAPACITY = 65_536
STEPS = 40
SH_EVERY = 10
DENSIFY_AT = 20
RESET_AT = 35
PCD_NOISE = 0.02
# the avatar serving path: scripts/fps_bench_tpu.py's full-size frame
AVATAR_VPB = 288          # synthetic_smpl vertices per bone
AVATAR_SUBDIV = 2         # subdivisions of the template, with smoothing
AVATAR_CAPACITY = 131_072
AVATAR_N_HUMAN = 69_105   # Gaussians the template gives
AVATAR_N_SCENE = 100_000
AVATAR_FRAMES = 20
# the rehearsal's budget ceiling: 2^21 at the TPU's 32x32 tiles
# (fps_bench_tpu.py); at K1's 16x16 tiles this frame's demand is about
# 2.54M slots
AVATAR_SLOT_CAP = 1 << 22
# human_forward on the card against the CPU
AVATAR_ATOL = 1e-5
# the frame of the cached decode against the full forward
FULL_FORWARD_ATOL = 2e-5
# the human training path (phase 3e): config[2]'s recipe,
# cfg_files/neuman/hugs_human.yaml, on phase 3c's body at the trainer's
# capacity (max_n_gaussians), against scripts/human_avatar_tpu.py's
# ground truth: 24 frames of striped splats on the posed body, the orbit
# at distance 2.6
HUMAN_CAPACITY = 524_288
HUMAN_FRAMES = 24
HUMAN_DIST = 2.6
HUMAN_DISTILL = 1500      # cut from the recipe's 7,000 for the time limit
HUMAN_STEPS = 30
HUMAN_DENSIFY_AT = 15
HUMAN_SH_AT = 10          # one_up_sh_degree, held at sh_degree 0
HUMAN_SH_DEGREE = 0
HUMAN_EXTENT = 1.0        # densify_extent
HUMAN_SLOT_CAP = 1 << 23  # the rehearsal's budget
HUMAN_LOSS = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=1.0, l_lbs_w=1000.0)
# the joint training path (phase 3f): config[3]'s recipe,
# cfg_files/neuman/hugs_human_scene.yaml, unchanged in width, through
# hugs_tpu_torch.main on a NeuMan-layout sequence the phase writes: phase
# 3e's striped body posed by gt_poses and phase 3c's 100,000-point scene,
# 960x540, 24 frames from the orbit at distance 2.6. Each override is a
# cut of the recipe, printed with the phase
JOINT_RECIPE = "cfg_files/neuman/hugs_human_scene.yaml"
JOINT_FRAMES = 24
JOINT_STEPS = 30
JOINT_CUTS = {
    "train.num_steps": JOINT_STEPS,              # recipe 14,998
    "human.canon_nframes": 8,                    # recipe 60
    "human.init_steps": 1000,                    # recipe 7,000
    # densify at steps 15 and 30; from 0, so that the opacity reset a
    # white background makes at densify_from_iter falls outside the run
    "human.densify_from_iter": 0,                # recipe 3,000
    "human.densification_interval": 15,          # recipe 600
    "scene.densify_from_iter": 0,                # recipe 500
    "scene.densification_interval": 15,          # recipe 100
    "train.val_interval": JOINT_STEPS,           # recipe 1,000
}
JOINT_PCD_NOISE = 0.02
# the anim split of phase 3f's sequence: an AMASS-layout clip of
# ANIM_SOURCE_FRAMES frames, every 4th an anim frame (lab's 0:1000:4)
ANIM_SOURCE_FRAMES = 80
ANIM_FRAMES = ANIM_SOURCE_FRAMES // 4
# phase 3g, evaluation: check (b) renders anim frame 0's camera at this
# size on the card and on the CPU
EVAL_CPU_WH = (160, 90)
# phase 3h, config[4]'s scale-out on phase 3f's run: anim frame 0 in
# image bands, animate in batches, the batched joint step (train.batch_size
# DP_BATCH, DP_STEPS steps) through a one-rank NCCL group, and on a machine
# with several cards one data x tile step on up to 4 of them
BANDS = (2, 4)
ANIM_BATCH = 4
DP_BATCH = 2
DP_STEPS = 3
DP_RANKS_MAX = 4
DP_TIMEOUT = 600.0
# phase 3i, the Gaussian-sharded path (tpu.gauss_shard) on phase 3f's
# run: (b) GAUSS_STEPS[0] steps, a densify, GAUSS_STEPS[1] more; (c)
# hugs_tpu_torch.main in scene mode for GAUSS_MAIN_STEPS steps; (e) the
# per-Gaussian avatar held to the CPU at EVAL_CPU_WH
GAUSS_STEPS = (3, 2)
GAUSS_MAIN_STEPS = 4
GAUSS_LOSS_RTOL = 1e-3
GAUSS_SCALE_OUT = 4
# phase 3j: the convergence recipes (hugs_tpu_torch/convergence), cut: the
# human and joint recipes at full width (512x512, 24 frames) with their
# distillation cut to RECIPE_DISTILL steps and RECIPE_STEPS training
# steps; the surface recipe (960x540, 44 views, the automatic budget) for
# SURFACE_STEPS steps. The held-out PSNR must gain RECIPE_GAIN_DB over
# step 0's (the TPU gained 14.6 and 11.2 dB by step 250)
RECIPE_DISTILL = 300
RECIPE_STEPS = 250
RECIPE_GAIN_DB = 10.0
SURFACE_STEPS = 250
# `--scale-out`: checks (c) and (d) alone, on phase 3f's sequence and
# JOINT_CUTS trained for 2 steps after a 50-step distillation
SCALE_OUT_CUTS = dict(JOINT_CUTS, **{
    "train.num_steps": 2, "human.init_steps": 50,
    "train.val_interval": 1000, "human.canon_nframes": 2})
# phase 3d, the micro-benchmarks: S2 held to its plain version at a grid
# of 16 steps (INNER 64, REPS 3), every element within S2_RTOL of the
# block's largest value (the plain version's exp and log1p are torch's,
# the kernel's CUDA's; the fused multiply-adds round once on both sides);
# S1 at 256 passes and 2 calls from a linspace start, float32 to rtol
# 1e-6, bfloat16 to one bf16 ulp; S1's time at 32768 passes over its time
# at 8192 within R_SCALING; S3's per-pixel and per-tile outputs within
# S3_RTOL |plain| + S3_RTOL max |plain| (float32 sums in another order),
# its grad_feat outputs to K2's bars
S2_CHECK_GRID = 16
S2_RTOL = 1e-5
S1_CHECK_R, S1_CHECK_K = 256, 2
R_SCALING = (3.5, 4.5)
S3_RTOL = 1e-5
# a skeleton's operations per kept pair: 9 multiplies, 9 adds to sum them
OPS_SKEL = 18
# phase 3k, the POWER_MXU mode: pair_alpha_mxu's float operations per
# tested pair (OPS_TESTED without the exponent's 9: the offsets 2, the
# clamp, exp, opacity product and cap 4, the tests and the distance 7);
# mxu_record's per staged instance (the grid point and residual 18, the
# six coefficients 16, the three-way bf16 split 54, the index 2); the
# product's own tensor-core flops per kept (warp, instance) pair: 2 flops
# x 32 pixels x 6 basis terms x 3 passes, whatever groups, padding and k
# steps a design runs them in (micro.mxu_groups counts the design's own
# groups, mma and column fill beside the bound); the H100 SXM's dense
# bf16 tensor-core peak (NVIDIA data sheet), which mma.sync does not reach
OPS_TESTED_MXU = 13
OPS_RECORD = 90
MXU_PAIR_FLOPS = 2 * 32 * 6 * 3
MMA_FLOPS = 2 * 16 * 8 * 16   # one mma.sync m16n8k16
PEAK_BF16_TC = 989e12
MXU_STEPS = 10            # phase 3k (d): scene_train_step calls per mode
MXU_LOSS_RTOL = 1e-3
# phase 3l: hugs_tpu_torch.scaling_bench's worker at full width (960x540,
# synthetic_smpl(288), human and scene capacity 524,288, a 256^2 triplane
# of 32 features: HumanGSConfig's widths; the band budget from a
# binning-only probe; 5 timed steps) and the fragment-packet sizing;
# --scale-out's launcher over SCALING_PROCS cards and the sizing on
# SIZING_RANKS NCCL ranks against as many gloo ranks, each frag_counts
# entry within SIZING_RTOL
SCALING_FULL = dict(width=W, height=H, capacity=HUMAN_CAPACITY, budget=0,
                    n_tile=1, iters=5, verts_per_bone=AVATAR_VPB,
                    triplane_res=256, n_features=32, device="cuda")
SCALING_PROCS = (1, 2, 4)
SCALING_TIMEOUT = 900.0
SIZING_RANKS = 4
SIZING_RTOL = 1e-3


class SceneLR:
    """The scene learning rates of hugs_tpu/cfg/config.py:160-173
    (scene.lr), the values 3DGS trains with."""
    position_init = 0.00016
    position_final = 0.0000016
    position_delay_mult = 0.01
    position_max_steps = 30_000
    opacity = 0.05
    scaling = 0.005
    rotation = 0.001
    feature = 0.0025


def build_scene(n, seed):
    """bench.py's workload, drawn with numpy: raw (pre-activation)
    parameters."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 1.5 + 5.0
    log_scales = (rng.normal(size=(n, 3)) * 0.3 - 4.0).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    opacity_logit = rng.normal(size=(n, 1)).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return dict(xyz=means, scaling=log_scales, rotation=rotq,
                opacity=opacity_logit, shs=shs)


def saturating_scene(w, h, fovx, fovy, seed):
    """Two depth layers of near-opaque splats on a grid over the whole
    w x h image of a camera at the origin: every pixel saturates."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0.0, w - 1.0, 24),
                         np.linspace(0.0, h - 1.0, 16))
    px, py = np.tile(gx.ravel(), 2), np.tile(gy.ravel(), 2)
    n = px.shape[0]
    z = np.concatenate([4.0 + rng.uniform(size=n // 2) * 0.2,
                        6.0 + rng.uniform(size=n // 2) * 0.2])
    mx = z * math.tan(fovx / 2) * ((2.0 * px + 1.0) / w - 1.0)
    my = z * math.tan(fovy / 2) * ((2.0 * py + 1.0) / h - 1.0)
    f32 = np.float32
    return dict(xyz=np.stack([mx, my, z], axis=-1).astype(f32),
                scales=np.full((n, 3), 0.4, f32),
                rotq=np.tile(np.array([1.0, 0, 0, 0], f32), (n, 1)),
                opacity=np.full((n,), 0.97, f32),
                shs=(rng.normal(size=(n, 16, 3)) * 0.3).astype(f32))


def view(i):
    """Camera i of the serving and training runs: view 0 looks down +z
    from the origin, the others turn about y and step sideways."""
    a = 0.08 * i * (-1) ** i
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]], np.float32)
    t = np.array([0.1 * i, -0.05 * i, 0.0], np.float32)
    return R, t


def print_profile(what, reps, by_kernel, per_call, span_us, smi, top=8):
    """The profiler's numbers for one window."""
    busy_ms = sum(by_kernel.values()) / 1e3
    span_ms = span_us / 1e3
    if not by_kernel:
        print(f"# profiler, {what}: no device events; idle share not "
              f"measured")
        return
    print(f"# profiler, {reps} {what}s: {per_call:.1f} device kernels per "
          f"{what}, busy {busy_ms:.4f} ms of a {span_ms:.4f} ms span (first "
          f"kernel start to last kernel end): device idle share "
          f"{(1 - busy_ms / span_ms) * 100:.1f}%  [{smi}]")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"#   {us:9.2f} us  {name[:90]}")


def held(name, got, want, atol=PIXEL_ATOL):
    """Share of elements within atol and the max |difference|; raises
    unless the share reaches MIN_SHARE and the max stays under MAX_ABS."""
    d = (got - want).abs()
    share = float((d <= atol).float().mean())
    worst = float(d.max()) if d.numel() else 0.0
    print(f"# {name}: {share * 100:.4f}% within {atol}, max |d| {worst:.3e}")
    if share < MIN_SHARE or worst > MAX_ABS:
        raise AssertionError(f"{name} disagrees: {share:.6f} within {atol},"
                             f" max {worst:.3e}")
    return worst


def held_grad(name, got, want, ref64=None):
    """K2's bar per feature column: the share of entries within
    GRAD_ATOL + GRAD_RTOL |want| must reach GRAD_SHARE, and
    ||got - want|| / ||want|| must stay within GRAD_REL_NORM; with ref64
    (the plain version in float64), ||got - ref64|| / ||ref64|| must stay
    within GRAD_REL_NORM or REF64_SLACK times ||want - ref64|| / ||ref64||.
    Prints every column, then raises if one failed. Returns the max
    |got - want|."""
    worst, failed = 0.0, []
    for c in range(want.shape[1]):
        d = (got[:, c] - want[:, c]).abs()
        share = float((d <= GRAD_ATOL + GRAD_RTOL * want[:, c].abs())
                      .float().mean())
        norm = float(want[:, c].norm())
        rel = float(d.norm()) / norm if norm > 0 else float(d.norm())
        worst = max(worst, float(d.max()))
        line = (f"# {name} column {c}: {share * 100:.4f}% within "
                f"{GRAD_ATOL} + {GRAD_RTOL} |g|, ||d|| / ||g|| {rel:.3e}, "
                f"max |d| {float(d.max()):.3e}, max |g| "
                f"{float(want[:, c].abs().max()):.3e}")
        bar = GRAD_REL_NORM
        if ref64 is not None:
            r = ref64[:, c]
            nr = float(r.norm())
            rel = float((got[:, c].double() - r).norm()) / nr
            plain_rel = float((want[:, c].double() - r).norm()) / nr
            bar = max(GRAD_REL_NORM, REF64_SLACK * plain_rel)
            line += (f"; from float64: K2 {rel:.3e}, plain {plain_rel:.3e}"
                     f" (bar {bar:.3e})")
        print(line)
        if share < GRAD_SHARE or rel > bar:
            failed.append(c)
    if failed:
        raise AssertionError(f"{name}: columns {failed} disagree")
    return worst


def avatar_scene_points(n, seed):
    """fps_bench_tpu.py's scene: n points uniform in [-4, 4]^3 pulled
    into the radius-4 ball, and random colours."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True) / 4.0, 1.0)
    return pts, rng.rand(n, 3).astype(np.float32)


def avatar_serving(dev, smi, project, slot_budget, cull_counts,
                   tile_of_pixel, kernel_times):
    """Phase 3c, the avatar serving path at full width (see the module
    docstring), with main's helpers. Raises if a check fails; returns
    K1's numbers on the avatar frame for the kernels line."""
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models.scene_gs import create_from_pcd, scene_forward
    from hugs_tpu_torch.models.smpl import synthetic_smpl
    from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01
    from hugs_tpu_torch.render.renderer import render_human_scene
    from hugs_tpu_torch.render.tiles import bin_gaussians

    t0 = time.time()
    smpl = synthetic_smpl(AVATAR_VPB, device=dev)
    template = subdivide_smpl_model(smpl, smoothing=True,
                                    n_iter=AVATAR_SUBDIV)
    cfg = hgs.HumanGSConfig(use_deformer=True, disable_posedirs=True)
    # the nets are drawn on the CPU from the seed, then moved to the card
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params, state, fixed, _ = hgs.init_human_gs(
        gen, cfg, smpl, template, torch.zeros(10, device=dev), n_frames=1,
        capacity=AVATAR_CAPACITY)
    n_human = int(state.alive.sum())
    if n_human != AVATAR_N_HUMAN:
        raise AssertionError(f"the template gave {n_human} Gaussians, not "
                             f"{AVATAR_N_HUMAN}")
    with torch.no_grad():
        # decode once at the training capacity, then right-size
        canon = hgs.canon_forward(params, state, cfg)
        params, state, canon = hgs.compact_for_inference(
            params, state, canon, bucket=-(-n_human // 2048) * 2048)
        pts, cols = avatar_scene_points(AVATAR_N_SCENE, SEED)
        s_out = scene_forward(create_from_pcd(pts, cols, AVATAR_N_SCENE,
                                              max_sh_degree=3, device=dev))
    data = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                               nframes=2, device=dev)[0]
    cam = data["camera"]
    black = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"# avatar: {n_human} human Gaussians (capacity "
          f"{AVATAR_CAPACITY}, compacted to {state.alive.shape[0]}), "
          f"{AVATAR_N_SCENE} scene Gaussians (SH degree 3, rendered at the "
          f"human's degree {int(state.active_sh_degree)}), {W}x{H}; set-up "
          f"{setup_s:.1f} s (host clock: body, subdivision, decode, scene "
          f"kNN)")

    # each frame's pose: the previous one plus 0.01 sin(i + arange(69))
    poses = [torch.zeros(69, device=dev)]
    ar = torch.arange(69, dtype=torch.float32, device=dev)
    for i in range(AVATAR_FRAMES - 1):
        poses.append(poses[-1] + 0.01 * torch.sin(float(i) + ar))

    def body_args(device):
        """The frame's fixed SMPL arguments, as fps_bench_tpu.py passes."""
        return dict(global_orient=torch.zeros(3, device=device),
                    betas=torch.zeros(10, device=device),
                    transl=torch.zeros(3, device=device),
                    smpl_scale=torch.tensor(1.0, device=device))

    card_args = body_args(dev)

    def skin(pose, p=params, st=state, fx=fixed, c=canon, args=card_args):
        """human_forward of a new pose (c=None: the full forward)."""
        return hgs.human_forward(p, st, fx, cfg, body_pose=pose, canon_out=c,
                                 compute_gt_lbs=False, **args)

    def frame(pose, budget, c=canon):
        return render_human_scene(data, skin(pose, c=c), s_out, black,
                                  render_mode="human_scene",
                                  instance_budget=budget)

    def merged_pg(h_out):
        """render_human_scene's merge and projection, for the stages."""
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs")}
        return project(cam, a, torch.cat([h_out["alive"], s_out["alive"]]),
                       h_out["active_sh_degree"])

    with torch.no_grad():
        # rehearsal: each frame's slot demand, from projection and binning
        # (no blend launch)
        demands = [int(bin_gaussians(merged_pg(skin(p)), W, H,
                                     AVATAR_SLOT_CAP).n_slots)
                   for p in poses]
        budget = min(max(1 << 14, slot_budget(max(demands))),
                     AVATAR_SLOT_CAP)
        print(f"# avatar rehearsal: slot demand {min(demands)}-"
              f"{max(demands)} over {AVATAR_FRAMES} frames -> budget "
              f"{budget} (ceiling {AVATAR_SLOT_CAP})")

        # (a) human_forward on the card against the CPU, same tensors
        got = skin(poses[-1])
        want = skin(poses[-1].cpu(), *(hgs.to_device(x, "cpu") for x in
                                       (params, state, fixed, canon)),
                    args=body_args("cpu"))
        for k in ("xyz", "scales"):
            d = float((got[k].cpu() - want[k]).abs().max())
            print(f"# avatar human_forward {k}, card vs CPU: max |d| "
                  f"{d:.3e} (bar {AVATAR_ATOL})")
            if not d <= AVATAR_ATOL:
                raise AssertionError(f"human_forward {k} differs on the card")
        # q and -q are one rotation: compare each row at its closer sign
        q, qc = got["rotq"].cpu(), want["rotq"]
        flip = (q + qc).abs().amax(1) < (q - qc).abs().amax(1)
        d = float(torch.where(flip[:, None], q + qc, q - qc).abs().max())
        w_flip = float(qc[flip, 0].abs().max()) if bool(flip.any()) else 0.0
        print(f"# avatar human_forward rotq, card vs CPU: max |d| {d:.3e} "
              f"(bar {AVATAR_ATOL}), {int(flip.sum())} rows at the other "
              f"sign, there |w| <= {w_flip:.1e}")
        if not d <= AVATAR_ATOL or w_flip > 1e-4:
            raise AssertionError("human_forward rotq differs on the card")

        # (b) K1 against plain on frame 0's bins
        pg0 = merged_pg(skin(poses[0]))
        bins0 = bin_gaussians(pg0, W, H, budget)
        feat0 = gauss_features(pg0)
        img_k, logt_k, nwalk_k, walked = cuda_blend.blend_fwd(
            feat0, bins0.gauss_id, bins0.starts, bins0.ends, black, W, H)
        img_p, logt_p, pairs0 = plain_blend(feat0, bins0.gauss_id,
                                            bins0.starts, bins0.ends, black,
                                            W, H)
        torch.cuda.synchronize()
    counts = bins0.ends - bins0.starts
    print(f"# avatar frame 0: {int(pg0.mask.sum())} of "
          f"{pg0.mask.shape[0]} Gaussians visible; {int(counts.sum())} "
          f"instances (demand {int(bins0.n_instances)} before culling, max "
          f"{int(counts.max())} per tile), K1 walked {int(walked.sum())}")
    if bool(bins0.overflowed):
        raise AssertionError("avatar frame 0 overflowed its budget")
    err = held("K1 raw image vs plain, avatar frame 0", img_k, img_p)
    live = logt_p >= LOG_TEPS
    print(f"# unsaturated pixels of avatar frame 0: {int(live.sum())} of "
          f"{W * H}")
    if bool(live.any()):
        held("K1 log T vs plain, avatar frame 0 (unsaturated pixels)",
             logt_k[live], logt_p[live])
    if bool((nwalk_k > tile_of_pixel(walked)).any()):
        raise AssertionError("a pixel of the avatar frame walked past its "
                             "tile's walk")
    same = float((nwalk_k.long() == pairs0[0]).float().mean())
    print(f"# K1 n_walked equals the plain blend's tested count on "
          f"{same * 100:.4f}% of the avatar frame's pixels")
    if same < MIN_SHARE:
        raise AssertionError("K1's n_walked disagrees on the avatar frame")

    # the main path: 20 frames through the entry points
    n_inst = []
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    t0 = time.time()
    with torch.no_grad():
        images = []
        for i, pose in enumerate(poses):
            pkg = frame(pose, budget)
            if bool(pkg["overflowed"]):     # (d)
                raise AssertionError(f"avatar frame {i} overflowed")
            n_inst.append(int(pkg["n_instances"]))
            images.append(pkg["render"])
    torch.cuda.synchronize()
    frames_s = time.time() - t0
    k1_launches, k2_launches = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    print(f"# avatar: {AVATAR_FRAMES} frames in {frames_s:.3f} s (host "
          f"clock), K1 launches {k1_launches}, K2 launches {k2_launches}; "
          f"instances per frame before culling {n_inst}")
    if k1_launches != AVATAR_FRAMES or k2_launches != 0:     # (e)
        raise AssertionError(f"K1 launched {k1_launches} and K2 "
                             f"{k2_launches} times for {AVATAR_FRAMES} "
                             f"frames")
    for i, img in enumerate(images):
        if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()) \
                or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise AssertionError(f"avatar frame {i}: bad image")
    d0 = float((images[0] - clip01(img_k)).abs().max())
    moved = float((images[-1] - images[0]).abs().max())
    print(f"# avatar frame 0 vs the K1 image of check (b), clipped: max |d| "
          f"{d0:.3e}; frame {AVATAR_FRAMES - 1} vs frame 0: max |d| "
          f"{moved:.3e}")
    if d0 > 1e-6 or moved == 0.0:
        raise AssertionError("the avatar frames are not what K1 gave")

    # (c) the cached decode against the full forward, frame 0
    with torch.no_grad():
        full = frame(poses[0], budget, c=None)
    dfull = float((full["render"] - images[0]).abs().max())
    print(f"# avatar frame 0, full forward (triplane and decoders) vs "
          f"cached decode: max |d| {dfull:.3e} (bar {FULL_FORWARD_ATOL})")
    if bool(full["overflowed"]) or not dfull <= FULL_FORWARD_ATOL:
        raise AssertionError("the full-forward frame differs")

    # times: the frame by stage, the frame and the full-forward frame
    stages = {"human_forward": [], "project": [], "bin": [], "blend": [],
              "frame": []}
    with torch.no_grad():
        for rep in range(3 + REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            h_out = skin(poses[rep % AVATAR_FRAMES])
            ev[1].record()
            pgr = merged_pg(h_out)
            ev[2].record()
            b = bin_gaussians(pgr, W, H, budget)
            ev[3].record()
            cuda_blend.blend_tiles(pgr, b, W, H, black)
            ev[4].record()
            ev[4].synchronize()
            if rep >= 3:
                for k, (e0, e1) in (("human_forward", (0, 1)),
                                    ("project", (1, 2)), ("bin", (2, 3)),
                                    ("blend", (3, 4)), ("frame", (0, 4))):
                    stages[k].append(ev[e0].elapsed_time(ev[e1]))
        stage_ms = {k: statistics.median(v) for k, v in stages.items()}
        stage_ms["entry_frame"] = device_ms(lambda: frame(poses[0], budget))
        stage_ms["full_frame"] = device_ms(lambda: frame(poses[0], budget,
                                                         c=None))
        stage_ms["full_human_forward"] = device_ms(
            lambda: skin(poses[0], c=None))
        profiles = {
            "avatar frame": device_kernels(lambda: frame(poses[0], budget)),
            "human_forward": device_kernels(lambda: skin(poses[0])),
            "full-forward frame": device_kernels(
                lambda: frame(poses[0], budget, c=None)),
        }
    print(f"# avatar frame {stage_ms['frame']:.4f} ms = human_forward "
          f"{stage_ms['human_forward']:.4f} + project "
          f"{stage_ms['project']:.4f} + bin {stage_ms['bin']:.4f} + blend "
          f"{stage_ms['blend']:.4f} ms; through render_human_scene "
          f"{stage_ms['entry_frame']:.4f} ms; full forward frame "
          f"{stage_ms['full_frame']:.4f} ms (its human_forward "
          f"{stage_ms['full_human_forward']:.4f} ms)  [{smi}]")
    for what, (by_kernel, per_call, span_us) in profiles.items():
        print_profile(what, PROFILED, by_kernel, per_call, span_us, smi)
    k1_prof_ms = sum(us for name, us in profiles["avatar frame"][0].items()
                     if "blend_fwd_kernel" in name) / 1e3

    cull = cull_counts("avatar frame 0", feat0, bins0, nwalk_k)
    t = kernel_times("avatar frame 0", feat0, bins0, black, None, logt_k,
                     nwalk_k, pairs0, cull, kernels=("k1",), plain_reps=3)
    print(f"# K1 profiler {k1_prof_ms:.4f} ms per avatar frame  [{smi}]")
    return {
        "launches": k1_launches, "k2_launches": k2_launches,
        "max_abs_err": err, "ms": t["k1"],
        "call_ms": t["k1_call"], "plain_ms": t["plain"],
        "bound_ms": t["k1_bound"], "bound_by": t["k1_bound_by"],
        "yardstick_bound_ms": t["k1_yardstick"], "ops": t["k1_ops"],
        "cull_dropped_share": cull["K1_dropped"],
        "instances_frame0": int(counts.sum()), "budget": budget,
        "frame_ms": stage_ms, "device_kernels_per_frame":
            profiles["avatar frame"][1],
    }


def gt_poses(f, n):
    """scripts/human_avatar_tpu.py's ground-truth motion, frame f of n: a
    swing of the arms and legs and a slow twist of the torso (axis-angle
    body pose (69,) and global orient (3,))."""
    t = 2.0 * np.pi * f / n
    pose = np.zeros(69, np.float32)
    # SMPL body joints (0-indexed into the 23 body joints): 0/1 hips,
    # 3/4 knees, 15/16 shoulders, 17/18 elbows, 8 spine3
    pose[0 * 3 + 0] = 0.35 * np.sin(t)
    pose[1 * 3 + 0] = -0.35 * np.sin(t)
    pose[3 * 3 + 0] = 0.5 * max(0.0, np.sin(t))
    pose[4 * 3 + 0] = 0.5 * max(0.0, -np.sin(t))
    pose[15 * 3 + 2] = 0.6 * np.sin(t)
    pose[16 * 3 + 2] = -0.6 * np.sin(t)
    pose[17 * 3 + 1] = 0.4 * np.cos(t)
    pose[18 * 3 + 1] = -0.4 * np.cos(t)
    pose[8 * 3 + 1] = 0.2 * np.sin(2 * t)
    orient = np.array([0.0, 0.15 * np.sin(t), 0.0], np.float32)
    return pose, orient


def human_step_card_vs_cpu(dev):
    """Check (b) of phase 3e: one human_train_step's loss, terms and
    gradients on the card (K1, K2) against the same step on the CPU (the
    plain blend), on train/human_check.py's small avatar (the parity
    tests' size) at its bars."""
    from hugs_tpu_torch.train import human_check as hc

    worst = hc.compare_steps(hc.small_step(dev, SEED),
                             hc.small_step("cpu", SEED))
    print(f"# (b) one human_train_step at {hc.WIDTH}x{hc.HEIGHT}, card vs "
          f"CPU: every term within {hc.LOSS_ATOL} + {hc.LOSS_RTOL} |v| and "
          f"every gradient within {hc.GRAD_ATOL} + {hc.GRAD_RTOL} |g|; max "
          f"|d| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def human_training(dev, smi, project, slot_budget, cull_counts,
                   tile_of_pixel, kernel_times):
    """Phase 3e, the human training path at full width (see the module
    docstring), with main's helpers. Raises if a check fails; returns its
    numbers for the kernels line."""
    import copy

    from hugs_tpu_torch.data.cameras import get_rotating_camera
    from hugs_tpu_torch.losses.lpips import LPIPS
    from hugs_tpu_torch.losses.loss import HumanSceneLoss
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models.smpl import smpl_forward, synthetic_smpl
    from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
    from hugs_tpu_torch.ops.knn import mean_sq_dist_to_knn
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import (
        gauss_features, plain_blend, plain_blend_bwd,
    )
    from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01
    from hugs_tpu_torch.render.renderer import render
    from hugs_tpu_torch.render.tiles import bin_gaussians
    from hugs_tpu_torch.train import human_step as hst
    from hugs_tpu_torch.train.optim import group_adam_init, leaves

    worst_b = human_step_card_vs_cpu(dev)

    # ---- the ground truth: striped splats on the posed body
    t0 = time.time()
    smpl = synthetic_smpl(AVATAR_VPB, device=dev)
    vt = smpl.v_template
    col = torch.stack([0.5 + 0.45 * torch.sin(25.0 * vt[:, 1]),
                       0.5 + 0.45 * torch.sin(20.0 * vt[:, 0] + 2.0),
                       0.5 + 0.45 * torch.cos(18.0 * vt[:, 2] + 4.0)], 1)
    gt_shs = torch.zeros((vt.shape[0], 16, 3), device=dev)
    gt_shs[:, 0, :] = (torch.clamp(col, 0, 1) - 0.5) / 0.28209479177387814
    d2 = mean_sq_dist_to_knn(vt, k=3)
    gt_scales = (torch.sqrt(torch.clamp(d2, min=1e-8)) * 0.9)[:, None] \
        .repeat(1, 3)
    gt_rotq = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(vt.shape[0], 1)
    gt_op = torch.full((vt.shape[0],), 0.95, device=dev)
    cams = [c["camera"] for c in get_rotating_camera(
        img_size=(H, W), fov=0.95, dist=HUMAN_DIST, nframes=HUMAN_FRAMES + 1,
        angle_limit=2 * np.pi, device=dev)[:-1]]
    poses = [gt_poses(f, HUMAN_FRAMES) for f in range(HUMAN_FRAMES)]
    zeros3, betas = torch.zeros(3, device=dev), torch.zeros(10, device=dev)
    black, white = torch.zeros(3, device=dev), torch.ones(3, device=dev)
    frames = []
    with torch.no_grad():
        for f, (pose, orient) in enumerate(poses):
            verts = smpl_forward(smpl, betas, torch.as_tensor(pose, device=dev),
                                 torch.as_tensor(orient, device=dev),
                                 zeros3).vertices
            a = dict(xyz=verts, scales=gt_scales, rotq=gt_rotq,
                     opacity=gt_op, shs=gt_shs)
            budget = slot_budget(int(bin_gaussians(
                project(cams[f], a, None, 0), W, H, 1 << 22).n_slots))
            imgs = []
            for bg in (black, white):
                pkg = render(verts, gt_scales, gt_rotq, gt_op, gt_shs,
                             cams[f], W, H, bg=bg, active_sh_degree=0,
                             instance_budget=budget)
                if bool(pkg["overflowed"]):
                    raise AssertionError(f"ground truth {f} overflowed")
                imgs.append(pkg["render"])
            t_map = torch.clamp((imgs[1] - imgs[0]).mean(0), 0.0, 1.0)
            frames.append((imgs[0], (t_map < 0.5).float()))
    cover = [float(m.mean()) for _, m in frames]
    print(f"# human training: ground truth {HUMAN_FRAMES} frames of "
          f"{vt.shape[0]} striped splats on the posed synthetic_smpl("
          f"{AVATAR_VPB}), {W}x{H}, mask cover {min(cover):.3f}-"
          f"{max(cover):.3f}")

    # ---- the avatar: phase 3c's body at the trainer's capacity
    template = subdivide_smpl_model(smpl, smoothing=True,
                                    n_iter=AVATAR_SUBDIV)
    cfg = hgs.HumanGSConfig(use_deformer=True, disable_posedirs=True,
                            init_scale_multiplier=0.5)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params, state, fixed, init_values = hgs.init_human_gs(
        gen, cfg, smpl, template, betas, n_frames=HUMAN_FRAMES,
        capacity=HUMAN_CAPACITY,
        init_body_pose=np.stack([p for p, _ in poses]),
        init_global_orient=np.stack([o for _, o in poses]),
        init_transl=np.zeros((HUMAN_FRAMES, 3), np.float32))
    n_human = int(state.alive.sum())
    if n_human != AVATAR_N_HUMAN:
        raise AssertionError(f"the template gave {n_human} Gaussians")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    targets = {k: v for k, v in init_values.items() if k != "edges"}

    # ---- 1. the init distillation, then one distillation step's time on
    # a copy (the trained avatar keeps exactly HUMAN_DISTILL steps)
    t0 = time.time()
    hst.distill_init(params, state, init_values, cfg,
                     num_steps=HUMAN_DISTILL, log_every=HUMAN_DISTILL // 4)
    with torch.no_grad():
        distill_loss = float(hst.distill_loss(params, state, targets, cfg))
    torch.cuda.synchronize()
    distill_s = time.time() - t0
    spare = copy.deepcopy(params)
    spare_opt = group_adam_init({f: getattr(spare, f)
                                 for f in hgs.NET_FIELDS})
    lr = torch.tensor(1e-3, device=dev)
    distill_ms = device_ms(lambda: hst.distill_step(spare, state, spare_opt,
                                                    targets, lr, cfg))
    del spare, spare_opt
    print(f"# human training: {n_human} Gaussians in capacity "
          f"{HUMAN_CAPACITY}; set-up {setup_s:.1f} s (host clock); "
          f"distillation {HUMAN_DISTILL} steps in {distill_s:.1f} s (host "
          f"clock), loss after {distill_loss:.6f}; one distillation step "
          f"{distill_ms:.4f} ms  [{smi}]")

    # ---- 2. the training run
    tstate = hst.init_human_train_state(params, state)
    static_lrs, xyz_sched = hst.make_human_lrs(optim_pose=True,
                                               optim_trans=True)
    lpips = LPIPS.create(device=dev)
    loss_fn = HumanSceneLoss(**HUMAN_LOSS, num_patches=4, patch_size=128)
    gen = torch.Generator(device=dev)      # the timed steps' draws
    gen.manual_seed(SEED + 1)
    one = torch.tensor(1.0, device=dev)

    def forward(f):
        """human_forward of frame f at the current state, no gradient, with
        the skinning targets."""
        with torch.no_grad():
            return hgs.human_forward(tstate.params, tstate.state, fixed, cfg,
                                     smpl_scale=one, dataset_idx=f)

    def lbs_parts(out):
        """The LBS term's parts on the live rows and on the dead ones:
        l_lbs_w times each part's sum of squared skinning-weight
        differences over every element of the capacity, as hugs_tpu
        averages it (losses/loss.py:130)."""
        sq = (out["lbs_weights"] - out["gt_lbs_weights"]) ** 2
        part = sq.sum(1) * (HUMAN_LOSS["l_lbs_w"] / sq.numel())
        alive = out["alive"]
        return float(part[alive].sum()), float(part[~alive].sum())

    def step_args(step):
        f = step % HUMAN_FRAMES
        rgb, mask = frames[f]
        return (fixed, cams[f], rgb, mask, white, one, f)

    def run(ts, budget, slots):
        """The training run on ts: HUMAN_STEPS steps cycling the frames,
        the SH step and the densify, the draws and the split noise from a
        generator seeded anew; each step's slot demand goes to `slots`.
        Returns the losses, step 0's terms and draws, and the densify's
        counts."""
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        losses, terms, info, first = [], [], None, None
        for step in range(HUMAN_STEPS):
            if step == HUMAN_SH_AT:
                hgs.one_up_sh_degree(ts.state, HUMAN_SH_DEGREE)
            if step == HUMAN_DENSIFY_AT:
                n0 = int(ts.state.alive.sum())
                noise = torch.randn((2, HUMAN_CAPACITY, 3), generator=g,
                                    device=dev)
                _, info = hst.human_densify_step(
                    ts, {k: aux[k] for k in ("opacity", "scales_canon",
                                             "rotmat_canon")}, noise,
                    HUMAN_EXTENT, grad_threshold=0.0002, min_opacity=0.005,
                    max_screen_size=20.0, percent_dense=0.01,
                    max_n_gaussians=HUMAN_CAPACITY)
                info = dict({k: int(v) for k, v in info.items()},
                            alive_before=n0)
            draws = loss_fn.draws(g, H, W, "human", device=dev)
            ts, aux = hst.human_train_step(
                ts, *step_args(step), draws, xyz_sched(step), static_lrs,
                lpips, cfg=cfg, loss_fn=loss_fn, width=W, height=H,
                instance_budget=budget)
            slots.append(int(aux["n_slots"]))
            if bool(aux["overflowed"]):             # (d)
                raise AssertionError(f"human step {step} overflowed budget "
                                     f"{budget}; slot demand by step {slots}")
            losses.append(float(aux["loss"]))
            terms.append({k: float(v) for k, v in aux["loss_dict"].items()})
            if step == 0:
                first = draws
        return losses, terms, first, info

    # rehearsal: the whole run on a copy at a generous budget gives every
    # step's slot demand (the splats grow after Adam's first steps, and
    # the densify adds rows); the run itself takes that x 1.15
    rehearsed = []
    run(copy.deepcopy(tstate), HUMAN_SLOT_CAP, rehearsed)
    budget = slot_budget(max(rehearsed))
    # step 0's frame, kept to hold K1 and K2 on it after the run
    o0 = forward(0)
    lbs0 = lbs_parts(o0)
    pg0 = project(cams[0], o0, o0["alive"], o0["active_sh_degree"])
    bins0 = bin_gaussians(pg0, W, H, budget)
    feat0 = gauss_features(pg0)
    del o0
    print(f"# human training: slot demand by step in the rehearsal "
          f"{rehearsed} -> budget {budget} (ceiling {HUMAN_SLOT_CAP}); loss "
          f"ssim {HUMAN_LOSS['l_ssim_w']}, l1 {HUMAN_LOSS['l_l1_w']}, lpips "
          f"{HUMAN_LOSS['l_lpips_w']} on 4 patches of 128 (He-initialised "
          f"VGG16), lbs {HUMAN_LOSS['l_lbs_w']}; white background")

    slots = []
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    t0 = time.time()
    losses, terms, draws0, info = run(tstate, budget, slots)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    k1_n, k2_n = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    print(f"# human training: {HUMAN_STEPS} steps in {train_s:.3f} s (host "
          f"clock, the densify included), K1 launches {k1_n}, K2 launches "
          f"{k2_n}; densify at step {HUMAN_DENSIFY_AT}: {info}")
    print("# human loss by step: " + " ".join(f"{v:.5f}" for v in losses))
    for k in terms[0]:
        print(f"#   {k} by step: " + " ".join(f"{t[k]:.5f}" for t in terms))
    print(f"# human slot demand by step: {slots}")
    if k1_n != HUMAN_STEPS or k2_n != HUMAN_STEPS:       # (e)
        raise AssertionError(f"K1 launched {k1_n} and K2 {k2_n} times for "
                             f"{HUMAN_STEPS} human training steps")
    # (c) every loss finite, and every gradient: a non-finite gradient
    # would stay in its Adam moments
    live = tstate.state.alive
    bad = [] if np.isfinite(losses).all() else ["loss"]
    for group, p in hgs.params_of(tstate.params).items():
        for name, x in (("param", p), ("mu", tstate.opt.mu[group]),
                        ("nu", tstate.opt.nu[group])):
            for t in leaves(x):
                if t.shape[:1] == live.shape:
                    t = t[live]
                if not bool(torch.isfinite(t).all()):
                    bad.append(f"{group} {name}")
    if bad:
        raise AssertionError(f"non-finite on live rows: {bad}")
    print(f"# human training: every loss, parameter and Adam moment finite "
          f"on the live rows; n_alive {int(live.sum())}, SH degree "
          f"{int(tstate.state.active_sh_degree)}")

    # (f) the loss of step 0's frame and draws, after the run. The check
    # holds the terms the frame defines (L1, SSIM, patch LPIPS); the LBS
    # term does not depend on the frame and rises in hugs_tpu's own first
    # steps after the distillation, with or without dead rows, in step
    # with the port (tests/test_torch_human_train.py::
    # test_lbs_term_after_distillation_matches_jax); it is printed beside,
    # split into its live and dead rows' parts
    hook = torch.zeros((HUMAN_CAPACITY, 2), device=dev)
    with torch.no_grad():
        pkg, h_out = hst.human_render(tstate, fixed, cams[0], white, hook,
                                      one, 0, cfg=cfg, width=W, height=H,
                                      instance_budget=budget)
        after, after_terms = hst.human_loss(loss_fn, draws0, *frames[0],
                                            white, pkg, h_out, lpips)
    lbs1 = lbs_parts(h_out)
    after_terms = {k: float(v) for k, v in after_terms.items()}
    photo0, photo = (sum(v for k, v in t.items() if k != "lbs")
                     for t in (terms[0], after_terms))
    print(f"# human training, step 0's frame and draws: L1 + SSIM + patch "
          f"LPIPS {photo0:.6f} at step 0, {photo:.6f} after the run; LBS "
          f"{terms[0]['lbs']:.6f}, {after_terms['lbs']:.6f} (live rows "
          f"{lbs0[0]:.6f} + dead rows {lbs0[1]:.6f} before the run, "
          f"{lbs1[0]:.6f} + {lbs1[1]:.6f} after); the whole loss "
          f"{losses[0]:.6f}, {float(after):.6f}")
    if not photo < photo0:
        raise AssertionError("the loss of step 0's frame did not fall")

    # (a) K1 and K2 against plain on step 0's frame, K2 fed that step's
    # d(loss)/d(raw colour) (the clip's 0.5 at the bounds included)
    raw0, logt0, nwalk0, walked0 = cuda_blend.blend_fwd(
        feat0, bins0.gauss_id, bins0.starts, bins0.ends, white, W, H)
    raw0p, logt0p, pairs0 = plain_blend(feat0, bins0.gauss_id, bins0.starts,
                                        bins0.ends, white, W, H)
    counts0 = bins0.ends - bins0.starts
    print(f"# human step 0's frame: {int(pg0.mask.sum())} Gaussians visible, "
          f"{int(counts0.sum())} instances (max {int(counts0.max())} per "
          f"tile), K1 walked {int(walked0.sum())}")
    k1_err = held("K1 raw image vs plain, human step 0's frame", raw0, raw0p)
    lv = logt0p >= LOG_TEPS
    held("K1 log T vs plain, human step 0's frame (unsaturated pixels)",
         logt0[lv], logt0p[lv])
    if bool((nwalk0 > tile_of_pixel(walked0)).any()):
        raise AssertionError("a pixel of the human frame walked past its "
                             "tile's walk")
    raw_req = raw0.clone().requires_grad_()
    loss0, _ = hst.human_loss(loss_fn, draws0, *frames[0], white,
                              {"render": clip01(raw_req)}, None, lpips)
    (g0,) = torch.autograd.grad(loss0, raw_req)
    args0 = (feat0, bins0.gauss_id, bins0.starts, bins0.ends, white, W, H)
    gf_k, gb_k = cuda_blend.blend_bwd(*args0, g0, logt0, nwalk0)
    t0 = time.time()
    gf_p, gb_p = plain_blend_bwd(*args0, g0)
    torch.cuda.synchronize()
    plain_bwd_s = time.time() - t0
    gf_64, _ = plain_blend_bwd(feat0.double(), *args0[1:4], white.double(),
                               W, H, g0.double())
    print(f"# K2 on the whole human frame (plain_blend_bwd {plain_bwd_s:.1f}"
          f" s, host clock)")
    k2_err = held_grad("K2 grad_feat vs plain, human step 0's frame",
                       gf_k[:, :9], gf_p[:, :9], gf_64[:, :9])
    bg_rel = float(((gb_k - gb_p).abs() / gb_p.abs()).max())
    print(f"# K2 grad_bg, human step 0's frame {gb_k.tolist()} vs plain "
          f"{gb_p.tolist()}: max relative {bg_rel:.3e} (bar {BG_RTOL})")
    if bg_rel > BG_RTOL:
        raise AssertionError("K2 grad_bg disagrees on the human frame")
    del gf_64

    # ---- times: a step by stage, a densify, the profile, the kernels
    stages = {k: [] for k in ("human_forward", "render", "loss", "backward",
                              "update", "step")}
    for rep in range(3 + REPS):
        fx, cam, rgb, mask, bg, sc, f = step_args(rep)
        draws = loss_fn.draws(gen, H, W, "human", device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        hook = torch.zeros((HUMAN_CAPACITY, 2), device=dev,
                           requires_grad=True)
        pkg, h_out = hst.human_render(tstate, fx, cam, bg, hook, sc, f,
                                      cfg=cfg, width=W, height=H,
                                      instance_budget=budget,
                                      between=ev[1].record)
        ev[2].record()
        loss, _ = hst.human_loss(loss_fn, draws, rgb, mask, bg, pkg, h_out,
                                 lpips)
        ev[3].record()
        grads, hook_grad = hst.human_grads(loss, tstate.params, hook)
        ev[4].record()
        hst.human_update(tstate, grads, hook_grad, pkg,
                         xyz_sched(HUMAN_STEPS + rep), static_lrs, width=W,
                         height=H)
        ev[5].record()
        ev[5].synchronize()
        if rep == 3:
            bad = [k for k, g in grads.items()
                   if not all(bool(torch.isfinite(x[live] if x.shape[:1]
                                                  == live.shape else x)
                                   .all()) for x in leaves(g))]
            if bad:
                raise AssertionError(f"non-finite gradients: {bad}")
        if rep >= 3:
            for k, (e0, e1) in (("human_forward", (0, 1)), ("render", (1, 2)),
                                ("loss", (2, 3)), ("backward", (3, 4)),
                                ("update", (4, 5)), ("step", (0, 5))):
                stages[k].append(ev[e0].elapsed_time(ev[e1]))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    # the patch LPIPS alone, forward and forward + backward
    rgb, mask = frames[0]
    img0 = pkg["render"].detach()
    d0 = draws0

    def lpips_term(x):
        comp = x * mask + d0.lpips_bg * (1.0 - mask)
        gtc = (rgb * mask + white[:, None, None] * (1.0 - mask)) * mask \
            + d0.lpips_bg * (1.0 - mask)
        return loss_fn._replace(lpips=lpips)._patch_lpips(d0.patches, mask,
                                                          comp, gtc)

    with torch.no_grad():
        stage_ms["lpips_fwd"] = device_ms(lambda: lpips_term(img0))

    def lpips_fwd_bwd():
        x = img0.clone().requires_grad_()
        torch.autograd.grad(lpips_term(x), x)

    stage_ms["lpips_fwd_bwd"] = device_ms(lpips_fwd_bwd)
    stage_ms["distill_step"] = distill_ms

    def train_step():
        hst.human_train_step(
            tstate, *step_args(0), draws0, xyz_sched(HUMAN_STEPS), static_lrs,
            lpips, cfg=cfg, loss_fn=loss_fn, width=W, height=H,
            instance_budget=budget)

    profile = device_kernels(train_step, reps=PROFILED_STEPS)
    k2_prof_ms = sum(us for name, us in profile[0].items()
                     if "blend_bwd_kernel" in name) / 1e3
    # the first call consumes the statistics the timed steps gathered;
    # later calls find nothing hot and time the step's fixed work
    dens_out = {k: v.detach() for k, v in (
        ("opacity", h_out["opacity"]), ("scales_canon", h_out["scales_canon"]),
        ("rotmat_canon", h_out["rotmat_canon"]))}
    stage_ms["densify"] = device_ms(lambda: hst.human_densify_step(
        tstate, dens_out, torch.randn((2, HUMAN_CAPACITY, 3), generator=gen,
                                      device=dev), HUMAN_EXTENT,
        max_n_gaussians=HUMAN_CAPACITY))
    print(f"# human training step {stage_ms['step']:.4f} ms = human_forward "
          f"{stage_ms['human_forward']:.4f} + render {stage_ms['render']:.4f}"
          f" + loss {stage_ms['loss']:.4f} + backward "
          f"{stage_ms['backward']:.4f} + Adam and stats "
          f"{stage_ms['update']:.4f} ms; the patch LPIPS alone: forward "
          f"{stage_ms['lpips_fwd']:.4f} ms, forward + backward "
          f"{stage_ms['lpips_fwd_bwd']:.4f} ms; distillation step "
          f"{distill_ms:.4f} ms; densify step {stage_ms['densify']:.4f} ms"
          f"  [{smi}]")
    print_profile("human training step", PROFILED_STEPS, *profile, smi)
    print(f"# K2 profiler {k2_prof_ms:.4f} ms per human training step  "
          f"[{smi}]")

    cull = cull_counts("human step 0's frame", feat0, bins0, nwalk0)
    t = kernel_times("human step 0's frame", feat0, bins0, white, g0, logt0,
                     nwalk0, pairs0, cull, plain_reps=1)
    return {
        "k1_launches": k1_n, "k2_launches": k2_n, "k1_err": k1_err,
        "k2_err": k2_err, "times": t, "cull": cull, "stage_ms": stage_ms,
        "instances_frame0": int(counts0.sum()),
        "pairs_frame0": [int(x) for x in pairs0.sum(dim=(1, 2))],
        "budget": budget, "losses": losses,
        "frame0_photometric": [photo0, photo],
        "frame0_lbs": [terms[0]["lbs"], after_terms["lbs"]],
        "frame0_lbs_live_dead": [lbs0, lbs1],
        "device_kernels_per_step": profile[1],
        "device_idle_share": 1.0 - sum(profile[0].values()) / profile[2]
        if profile[2] else None,
        "card_vs_cpu_max_abs": worst_b,
    }


def write_neuman_sequence(root, dev, smi):
    """Phase 3f's sequence in the NeuMan layout as sequence `lab` under
    root/neuman, with the port's PNG writer: each frame phase 3e's striped
    body, posed by gt_poses, amid phase 3c's 100,000-point scene
    (create_from_pcd's splats at opacity 0.5), rendered on white from the
    orbit at distance 2.6; the mask where the body alone leaves less than
    half the light; COLMAP cameras.txt / images.txt of the orbit
    (row-vector world-to-view, as data/neuman.py reads them),
    points3D.txt the scene's points plus N(0, 0.02^2) and the SMPL
    parameters. Also lab's AMASS clip at root/SFU (write_anim_clip).
    Returns the human mask's cover by frame."""
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    from hugs_tpu_torch.data.colmap import _rot_to_quat
    from hugs_tpu_torch.models.scene_gs import create_from_pcd, scene_forward
    from hugs_tpu_torch.models.smpl import smpl_forward, synthetic_smpl
    from hugs_tpu_torch.ops.graphics import fov2focal
    from hugs_tpu_torch.ops.knn import mean_sq_dist_to_knn
    from hugs_tpu_torch.render.renderer import render
    from hugs_tpu_torch.utils.png import write_png

    path = os.path.join(root, "neuman", "lab")
    for sub in ("images", "segmentations", "sparse", "4d_humans"):
        os.makedirs(os.path.join(path, sub))
    smpl = synthetic_smpl(AVATAR_VPB, device=dev)
    vt = smpl.v_template
    col = torch.stack([0.5 + 0.45 * torch.sin(25.0 * vt[:, 1]),
                       0.5 + 0.45 * torch.sin(20.0 * vt[:, 0] + 2.0),
                       0.5 + 0.45 * torch.cos(18.0 * vt[:, 2] + 4.0)], 1)
    h_shs = torch.zeros((vt.shape[0], 16, 3), device=dev)
    h_shs[:, 0, :] = (torch.clamp(col, 0, 1) - 0.5) / 0.28209479177387814
    h_scales = (torch.sqrt(torch.clamp(mean_sq_dist_to_knn(vt, k=3),
                                       min=1e-8)) * 0.9)[:, None].repeat(1, 3)
    h_rotq = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(vt.shape[0], 1)
    h_op = torch.full((vt.shape[0],), 0.95, device=dev)
    pts, cols = avatar_scene_points(AVATAR_N_SCENE, SEED)
    with torch.no_grad():
        s_out = scene_forward(create_from_pcd(pts, cols, AVATAR_N_SCENE,
                                              device=dev))
    # the trainee starts from create_from_pcd's opacity 0.1
    s_out["opacity"] = torch.full_like(s_out["opacity"], 0.5)
    fov = 0.95
    cams = get_rotating_camera(img_size=(H, W), fov=fov, dist=HUMAN_DIST,
                               nframes=JOINT_FRAMES + 1,
                               angle_limit=2 * np.pi, device=dev)[:-1]
    zeros3, betas = torch.zeros(3, device=dev), torch.zeros(10, device=dev)
    poses = [gt_poses(f, JOINT_FRAMES) for f in range(JOINT_FRAMES)]
    cover, lines = [], []
    with torch.no_grad():
        for f, (pose, orient) in enumerate(poses):
            cam = cams[f]["camera"]
            verts = smpl_forward(smpl, betas, torch.as_tensor(pose, device=dev),
                                 torch.as_tensor(orient, device=dev),
                                 zeros3).vertices
            budget = 1 << 23

            def draw(xyz, scales, rotq, op, shs, bg):
                pkg = render(xyz, scales, rotq, op, shs, cam, W, H, bg=bg,
                             active_sh_degree=0, instance_budget=budget)
                if bool(pkg["overflowed"]):
                    raise AssertionError(f"sequence frame {f} overflowed")
                return pkg["render"]

            human = (verts, h_scales, h_rotq, h_op, h_shs)
            t_map = torch.clamp((draw(*human, torch.ones(3, device=dev))
                                 - draw(*human, zeros3)).mean(0), 0, 1)
            mask = (t_map < 0.5)
            merged = [torch.cat([a, s_out[k]]) for a, k in zip(
                human, ("xyz", "scales", "rotq", "opacity", "shs"))]
            img = draw(*merged, torch.ones(3, device=dev))
            cover.append(float(mask.float().mean()))
            write_png(f"{path}/images/{f:05d}.png",
                      (img.permute(1, 2, 0).clamp(0, 1) * 255).round()
                      .to(torch.uint8).cpu().numpy())
            write_png(f"{path}/segmentations/{f:05d}.png",
                      (mask.to(torch.uint8) * 255).cpu().numpy())
            wv = cam.world_view.cpu().numpy().astype(np.float64)
            q = _rot_to_quat(wv[:3, :3])
            t = wv[3, :3]
            lines.append(f"{f + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} "
                         f"{t[2]} 1 {f:05d}.png\n\n")
    fx = fov2focal(fov, W)
    fy = fov2focal(fov, H)
    with open(f"{path}/sparse/cameras.txt", "w") as fh:
        fh.write(f"1 PINHOLE {W} {H} {fx} {fy} {W / 2} {H / 2}\n")
    with open(f"{path}/sparse/images.txt", "w") as fh:
        fh.write("".join(lines))
    noisy = pts + np.random.default_rng(SEED + 5).normal(
        scale=JOINT_PCD_NOISE, size=pts.shape).astype(np.float32)
    rgb = np.round(cols * 255).astype(int)
    with open(f"{path}/sparse/points3D.txt", "w") as fh:
        fh.write("".join(f"{i} {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0\n"
                         for i, (p, c) in enumerate(zip(noisy, rgb))))
    np.savez(f"{path}/4d_humans/smpl_optimized_aligned_scale.npz",
             betas=np.zeros((JOINT_FRAMES, 10), np.float32),
             global_orient=np.stack([o for _, o in poses]),
             body_pose=np.stack([p for p, _ in poses]),
             transl=np.zeros((JOINT_FRAMES, 3), np.float32),
             scale=np.ones(JOINT_FRAMES, np.float32))
    write_anim_clip(root, smpl)
    return cover


def write_anim_clip(root, smpl):
    """Lab's AMASS clip at root/SFU/0008 (data/neuman.py's MOCAP_PATHS):
    ANIM_SOURCE_FRAMES frames of SMPL-H poses (156 angles, the hands at
    rest) whose body swings as gt_poses over the clip, and translations.
    Lab's alignment maps a body x to tr + s R x; each frame's orientation
    is R^T times gt_poses' and its translation R^T (j0 - tr) / s - j0,
    with j0 the rest pelvis, so that the aligned body stands where phase
    3f trained it, s = 3 times its size."""
    from hugs_tpu_torch.data.neuman import (
        ALIGNMENTS, AMASS_SMPLH_TO_SMPL_JOINTS, MOCAP_PATHS, euler_matrix,
    )
    from hugs_tpu_torch.models.smpl import smpl_forward
    from hugs_tpu_torch.ops.rotations import (
        axis_angle_to_matrix, matrix_to_axis_angle,
    )
    tr, deg, sc = ALIGNMENTS["lab"]
    rot = euler_matrix(*np.radians(deg)).astype(np.float64)
    dev = smpl.v_template.device
    z3 = torch.zeros(3, device=dev)
    with torch.no_grad():
        j0 = smpl_forward(smpl, torch.zeros(10, device=dev),
                          torch.zeros(69, device=dev), z3, z3).joints[0]
    j0 = j0.cpu().numpy().astype(np.float64)
    transl = rot.T @ (j0 - np.asarray(tr)) / sc - j0
    poses = np.zeros((ANIM_SOURCE_FRAMES, 156), np.float32)
    for i in range(ANIM_SOURCE_FRAMES):
        pose, orient = gt_poses(i, ANIM_SOURCE_FRAMES)
        go = rot.T @ axis_angle_to_matrix(torch.as_tensor(
            orient, dtype=torch.float64)).numpy()
        smpl24 = np.concatenate([matrix_to_axis_angle(torch.as_tensor(
            go)).numpy(), pose])
        poses[i, AMASS_SMPLH_TO_SMPL_JOINTS] = smpl24
    path = os.path.join(root, os.path.dirname(MOCAP_PATHS["lab"][0]))
    os.makedirs(path)
    np.savez(os.path.join(root, MOCAP_PATHS["lab"][0]), poses=poses,
             trans=np.tile(transl.astype(np.float32),
                           (ANIM_SOURCE_FRAMES, 1)))


def joint_config(root, exp_name, cuts):
    """config[3]'s recipe on write_neuman_sequence's sequence under root,
    with the overrides `cuts`."""
    from hugs_tpu_torch.cfg import load_config
    return load_config(JOINT_RECIPE, [
        f"dataset_path={root}/neuman", "dataset.seq=lab",
        f"output_path={root}/out", f"exp_name={exp_name}",
        f"tpu.smpl_vpb={AVATAR_VPB}"]
        + [f"{k}={v}" for k, v in cuts.items()])


def joint_step_card_vs_cpu(dev):
    """Check (b) of phase 3f: one joint step's loss, terms and gradients
    (the merged frame and the human alone) on the card against the CPU,
    on train/human_check.py's small avatar and a 300-point scene."""
    from hugs_tpu_torch.train import human_check as hc

    worst = hc.compare_steps(hc.small_joint_step(dev, SEED),
                             hc.small_joint_step("cpu", SEED))
    print(f"# (b) one joint step at {hc.WIDTH}x{hc.HEIGHT}, card vs CPU: "
          f"every term within {hc.LOSS_ATOL} + {hc.LOSS_RTOL} |v| and every "
          f"gradient within {hc.GRAD_ATOL} + {hc.GRAD_RTOL} |g|; max |d| "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return worst


def joint_training(dev, smi, project, slot_budget, cull_counts,
                   tile_of_pixel, kernel_times, root):
    """Phase 3f, joint human + scene training (config[3]) through the
    port's CLI function hugs_tpu_torch.main.main on the sequence of
    write_neuman_sequence under root, with main's helpers. Checks (a)-(f)
    of the module docstring; raises if one fails; returns its numbers,
    the run's logdir among them."""
    import copy

    from hugs_tpu_torch import main as cli
    from hugs_tpu_torch.cfg import load_config
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models import scene_gs as sgs
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import (
        gauss_features, plain_blend, plain_blend_bwd,
    )
    from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01
    from hugs_tpu_torch.render.tiles import bin_gaussians
    from hugs_tpu_torch.train import checkpoint as ckpt_io
    from hugs_tpu_torch.train import human_step as hst
    from hugs_tpu_torch.train import joint_step as jst
    from hugs_tpu_torch.train.optim import group_adam_init, leaves
    from hugs_tpu_torch.train.trainer import GaussianTrainer

    t_phase = time.time()
    worst_b = joint_step_card_vs_cpu(dev)
    probe = {}
    white = torch.ones(3, device=dev)

    def frame_loss(tr, data, idx, draws, human_bg):
        """The joint loss's terms of one frame at tr's states (no update),
        the LBS term split into live and dead rows, and the render."""
        js = jst.JointTrainState(human=tr.human, scene=tr.scene)
        hook = torch.zeros((tr._h_cap + tr._s_cap, 2), device=dev)
        with torch.no_grad():
            pkg, out = jst.joint_render(
                js, tr.fixed, data["camera"], white, human_bg, hook,
                torch.tensor(1.0, device=dev), idx, cfg=tr.human_cfg,
                width=W, height=H, instance_budget=tr._ibudget,
                render_human_separate=True)
            _, terms = jst.joint_loss(tr.loss_fn, draws, data["rgb"],
                                      data["mask"], white, human_bg, pkg,
                                      out, tr.lpips)
            sq = (out["lbs_weights"] - out["gt_lbs_weights"]) ** 2
            part = sq.sum(1) * (tr.loss_fn.l_lbs_w / sq.numel())
            lbs = (float(part[out["alive"]].sum()),
                   float(part[~out["alive"]].sum()))
        return {k: float(v) for k, v in terms.items()}, lbs, pkg, out

    class ProbedTrainer(GaussianTrainer):
        """The CLI's trainer, which records itself and, before training,
        the loss of step 0's frame and that frame's K1 / K2 inputs."""

        def train(self):
            probe["trainer"] = self
            n = len(self.train_dataset)
            idx = int(np.random.RandomState(self.cfg.seed).permutation(n)[0])
            data = self.train_dataset[idx]
            g = torch.Generator(device=dev).manual_seed(SEED + 7)
            draws = self.loss_fn.draws(g, H, W, "human_scene", device=dev)
            human_bg = torch.rand(3, generator=g, device=dev)
            terms, lbs, pkg, out = frame_loss(self, data, idx, draws,
                                              human_bg)
            with torch.no_grad():
                s_out = sgs.scene_forward(self.scene.gs)
                a = {k: torch.cat([out[k], s_out[k]]) for k in
                     ("xyz", "scales", "rotq", "opacity", "shs")}
                pg = project(data["camera"], a,
                             torch.cat([out["alive"], s_out["alive"]]),
                             out["active_sh_degree"])
                bins = bin_gaussians(pg, W, H, self._ibudget)
            probe.update(idx=idx, data=data, draws=draws, human_bg=human_bg,
                         before=terms, lbs_before=lbs, pg0=pg, bins0=bins,
                         feat0=gauss_features(pg),
                         human_img0=pkg["human_img"].detach(),
                         budget0=self._ibudget,
                         alive0=(int(out["alive"].sum()),
                                 int(s_out["alive"].sum())))
            del pkg, out, s_out, a
            cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
            t0 = time.time()
            log = super().train()
            torch.cuda.synchronize()
            probe.update(train_s=time.time() - t0, k1=cuda_blend.LAUNCHES,
                         k2=cuda_blend.K2_LAUNCHES, retries=self.retries)
            return log

    t0 = time.time()
    cover = write_neuman_sequence(root, dev, smi)
    seq_s = time.time() - t0
    cfg = joint_config(root, "phase3f", JOINT_CUTS)
    print(f"# joint training: sequence of {JOINT_FRAMES} frames at "
          f"{W}x{H} written in {seq_s:.1f} s (host clock), human mask "
          f"cover {min(cover):.3f}-{max(cover):.3f}; recipe "
          f"{JOINT_RECIPE}: human capacity {cfg.human.max_n_gaussians}, "
          f"scene capacity {cfg.scene.max_n_gaussians}, triplane "
          f"{cfg.human.triplane_res}^2, {cfg.human.n_subdivision} "
          f"subdivisions, loss {dict(cfg.human.loss)}; cuts "
          f"{JOINT_CUTS}")
    main_trainer = cli.GaussianTrainer
    cli.GaussianTrainer = ProbedTrainer
    try:
        t0 = time.time()
        rc = cli.main(cfg, device=dev)
        torch.cuda.synchronize()
        main_s = time.time() - t0
    finally:
        cli.GaussianTrainer = main_trainer
    if rc != 0:
        raise AssertionError(f"hugs_tpu_torch.main.main returned {rc}")
    tr = probe["trainer"]
    k1_after = cuda_blend.LAUNCHES - probe["k1"]
    n_vals = len(tr.val_dataset)
    n_anim = len(tr.anim_dataset) if tr.anim_dataset is not None else 0
    n_canon = int(cfg.human.canon_nframes)
    k1_n, k2_n, retries = probe["k1"], probe["k2"], probe["retries"]
    steps = JOINT_STEPS + 1
    print(f"# joint training: main() {main_s:.1f} s (host clock; train "
          f"{probe['train_s']:.1f} s for {steps} steps, distillation "
          f"{cfg.human.init_steps} steps and validate included); alive "
          f"before {probe['alive0']}, after "
          f"({int(tr.human.state.alive.sum())}, "
          f"{int(tr.scene.gs.alive.sum())}); budget {probe['budget0']} "
          f"-> {tr._ibudget}, {retries} steps rendered again; K1 "
          f"launches {k1_n}, K2 launches {k2_n} in train()")
    # (f) two K2 per step (merged, human alone); two K1 per render of
    # a step, one per validated frame at val_interval and one per
    # frame of iteration 0's turntable; after train(), one per frame
    # main() validates, animates and turns
    want_k1 = 2 * (steps + retries) + n_vals * (steps // JOINT_STEPS) \
        + n_canon
    if k2_n != 2 * steps or k1_n != want_k1:
        raise AssertionError(f"K1 launched {k1_n} (expected {want_k1}) "
                             f"and K2 {k2_n} (expected {2 * steps}) "
                             f"times in {steps} joint steps")
    if n_anim != ANIM_FRAMES or k1_after != n_vals + n_anim + n_canon:
        raise AssertionError(
            f"after train() main() launched K1 {k1_after} times for "
            f"{n_vals} val, {n_anim} anim (expected {ANIM_FRAMES}) and "
            f"{n_canon} turntable frames")
    anim_pngs = sorted(os.listdir(os.path.join(cfg.logdir, "anim",
                                               "final")))
    canon_pngs = {it: len(os.listdir(os.path.join(cfg.logdir, "canon",
                                                   it)))
                  for it in ("000000", "final")}
    if len(anim_pngs) != n_anim or set(canon_pngs.values()) != {n_canon}:
        raise AssertionError(f"main() wrote {len(anim_pngs)} anim and "
                             f"{canon_pngs} turntable frames")
    print(f"# (f) per joint step: {k2_n / steps:.0f} K2 launches, "
          f"{(k1_n - n_vals - n_canon) / (steps + retries):.0f} K1 "
          f"launches per render of a step, {n_vals} K1 for the {n_vals}"
          f" val frames, {n_canon} for iteration 0's turntable; after "
          f"train(), {k1_after} K1 for {n_vals} val, {n_anim} anim and "
          f"{n_canon} turntable frames, {len(anim_pngs)} anim PNGs, "
          f"turntable PNGs {canon_pngs}")

    # (e) validate's metrics, hugs_tpu's keys
    with open(os.path.join(cfg.logdir, "results_eval.json")) as fh:
        metrics = json.load(fh)
    keys = {"hugs_psnr", "hugs_ssim", "hugs_lpips_uncalibrated",
            "hugs_human_psnr", "hugs_human_ssim",
            "hugs_human_lpips_uncalibrated"}
    if set(metrics) != keys or not all(np.isfinite(list(
            metrics.values()))):
        raise AssertionError(f"validate gave {metrics}")
    print(f"# (e) validate on {n_vals} val frames: {metrics}")
    with open(os.path.join(cfg.logdir, "results_train.json")) as fh:
        train_log = json.load(fh)
    print(f"# joint loss by 10 steps (results_train.json): "
          f"{[round(r['loss'], 6) for r in train_log]}")

    # (c) step 0's frame and draws: L1 + SSIM + LPIPS and the humansep
    # terms fall; the LBS term printed beside, live and dead rows
    after, lbs_after, _, _ = frame_loss(tr, probe["data"], probe["idx"],
                                        probe["draws"],
                                        probe["human_bg"])
    before = probe["before"]
    photo0, photo = (sum(v for k, v in t.items() if k != "lbs")
                     for t in (before, after))
    print(f"# (c) step 0's frame and draws: the photometric terms "
          f"{photo0:.6f} -> {photo:.6f} ({before} -> {after}); LBS live "
          f"{probe['lbs_before'][0]:.6f} + dead "
          f"{probe['lbs_before'][1]:.6f} -> {lbs_after[0]:.6f} + "
          f"{lbs_after[1]:.6f}")
    if not photo < photo0:
        raise AssertionError("the joint loss of step 0's frame did not "
                             "fall")
    live = tr.human.state.alive
    bad = []
    for group, p in hgs.params_of(tr.human.params).items():
        for name, x in (("param", p), ("mu", tr.human.opt.mu[group]),
                        ("nu", tr.human.opt.nu[group])):
            for t in leaves(x):
                if t.shape[:1] == live.shape:
                    t = t[live]
                if not bool(torch.isfinite(t).all()):
                    bad.append(f"human {group} {name}")
    s_live = tr.scene.gs.alive
    for f, p in sgs.params_of(tr.scene.gs).items():
        for name, x in (("param", p), ("mu", tr.scene.opt.mu[f]),
                        ("nu", tr.scene.opt.nu[f])):
            if not bool(torch.isfinite(x[s_live]).all()):
                bad.append(f"scene {f} {name}")
    if bad:
        raise AssertionError(f"non-finite on live rows: {bad}")

    # (d) the checkpoint round trip: a new trainer resumes from the
    # final checkpoint; every tensor equal bit for bit
    cfg2 = copy.deepcopy(cfg)
    cfg2.human.run_init = False
    t0 = time.time()
    tr2 = GaussianTrainer(cfg2, tr.train_dataset, tr.val_dataset,
                          device=dev)
    resume_s = time.time() - t0
    n_t = 0
    for what in ("human", "scene"):
        a = ckpt_io.flatten(getattr(tr, what))
        b = ckpt_io.flatten(getattr(tr2, what))
        if set(a) != set(b):
            raise AssertionError(f"resumed {what} has other tensors")
        for k in a:
            n_t += 1
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"resumed {what} {k} differs")
    ckpts = sorted(os.listdir(cfg.logdir_ckpt))
    print(f"# (d) a new trainer resumed {ckpts} in {resume_s:.1f} s "
          f"(host clock): {n_t} tensors, parameters, moments, "
          f"statistics and step counts, equal bit for bit")
    del tr2

    # (a) K1 and K2 against plain on step 0's merged frame, K2 fed that
    # frame's d(loss)/d(raw colour) with the human pass held fixed
    feat0, bins0 = probe["feat0"], probe["bins0"]
    data0 = probe["data"]
    raw0, logt0, nwalk0, walked0 = cuda_blend.blend_fwd(
        feat0, bins0.gauss_id, bins0.starts, bins0.ends, white, W, H)
    raw0p, logt0p, pairs0 = plain_blend(feat0, bins0.gauss_id, bins0.starts,
                                        bins0.ends, white, W, H)
    counts0 = bins0.ends - bins0.starts
    print(f"# joint step 0's merged frame: {int(probe['pg0'].mask.sum())} "
          f"Gaussians visible, {int(counts0.sum())} instances (max "
          f"{int(counts0.max())} per tile), K1 walked {int(walked0.sum())}")
    k1_err = held("K1 raw image vs plain, joint step 0's frame", raw0, raw0p)
    lv = logt0p >= LOG_TEPS
    if bool(lv.any()):
        held("K1 log T vs plain, joint step 0's frame (unsaturated pixels)",
             logt0[lv], logt0p[lv])
    else:
        print("# joint step 0's frame: every pixel saturates, so K1's log T "
              "stops at the threshold and the background gets no weight")
    if bool((nwalk0 > tile_of_pixel(walked0)).any()):
        raise AssertionError("a pixel of the joint frame walked past its "
                             "tile's walk")
    raw_req = raw0.clone().requires_grad_()
    loss0, _ = jst.joint_loss(
        tr.loss_fn, probe["draws"], data0["rgb"], data0["mask"], white,
        probe["human_bg"], {"render": clip01(raw_req),
                            "human_img": probe["human_img0"]}, None, tr.lpips)
    (g0,) = torch.autograd.grad(loss0, raw_req)
    args0 = (feat0, bins0.gauss_id, bins0.starts, bins0.ends, white, W, H)
    gf_k, gb_k = cuda_blend.blend_bwd(*args0, g0, logt0, nwalk0)
    t0 = time.time()
    gf_p, gb_p = plain_blend_bwd(*args0, g0)
    torch.cuda.synchronize()
    plain_bwd_s = time.time() - t0
    gf_64, _ = plain_blend_bwd(feat0.double(), *args0[1:4], white.double(),
                               W, H, g0.double())
    print(f"# K2 on the whole joint frame (plain_blend_bwd {plain_bwd_s:.1f}"
          f" s, host clock)")
    k2_err = held_grad("K2 grad_feat vs plain, joint step 0's frame",
                       gf_k[:, :9], gf_p[:, :9], gf_64[:, :9])
    # a saturated frame gives the background no weight: grad_bg 0 in both
    bg_rel = float(((gb_k - gb_p).abs() / gb_p.abs().clamp(min=1e-30))
                   .max())
    print(f"# K2 grad_bg, joint step 0's frame {gb_k.tolist()} vs plain "
          f"{gb_p.tolist()}: max relative {bg_rel:.3e} (bar {BG_RTOL})")
    if not bg_rel <= BG_RTOL:
        raise AssertionError("K2 grad_bg disagrees on the joint frame")
    del gf_64, gf_p, gf_k

    # ---- times: a step through the trainer, by stage, a distillation
    # step, each densify, the profile, the kernels
    tr.cfg.human.densify_until_iter = -1      # no densify in the timed steps
    tr.cfg.scene.densify_until_iter = -1
    n = len(tr.train_dataset)

    def trainer_step(rep):
        tr._train_step(JOINT_STEPS + 1 + rep, rep % n,
                       tr.train_dataset[rep % n], False)

    whole = []
    for rep in range(3 + REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        trainer_step(rep)
        b.record()
        b.synchronize()
        if rep >= 3:
            whole.append(a.elapsed_time(b))
    stages = {k: [] for k in ("human_forward", "render", "loss", "backward",
                              "update", "step")}
    js = jst.JointTrainState(human=tr.human, scene=tr.scene)
    one = torch.tensor(1.0, device=dev)
    for rep in range(3 + REPS):
        data = tr.train_dataset[rep % n]
        bg, hbg, draws = tr._step_draws("human_scene", H, W)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        hook = torch.zeros((tr._h_cap + tr._s_cap, 2), device=dev,
                           requires_grad=True)
        pkg, out = jst.joint_render(
            js, tr.fixed, data["camera"], bg, hbg, hook, one, rep % n,
            cfg=tr.human_cfg, width=W, height=H, instance_budget=tr._ibudget,
            render_human_separate=True, between=ev[1].record)
        ev[2].record()
        loss, _ = jst.joint_loss(tr.loss_fn, draws, data["rgb"], data["mask"],
                                 bg, hbg, pkg, out, tr.lpips)
        ev[3].record()
        hg, sg, hk = jst.joint_grads(loss, js, hook)
        ev[4].record()
        jst.joint_update(js, hg, sg, hk, pkg, tr.h_xyz_sched(60 + rep),
                         tr.h_static_lrs, tr.s_xyz_sched(60 + rep),
                         tr.s_static_lrs, width=W, height=H)
        ev[5].record()
        ev[5].synchronize()
        if rep >= 3:
            for k, (e0, e1) in (("human_forward", (0, 1)), ("render", (1, 2)),
                                ("loss", (2, 3)), ("backward", (3, 4)),
                                ("update", (4, 5)), ("step", (0, 5))):
                stages[k].append(ev[e0].elapsed_time(ev[e1]))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    stage_ms["trainer_step"] = statistics.median(whole)
    dens_out = {k: out[k].detach() for k in ("opacity", "scales_canon",
                                             "rotmat_canon")}
    # the first call consumes the statistics the timed steps gathered
    stage_ms["human_densify"] = device_ms(lambda: hst.human_densify_step(
        tr.human, dens_out, tr._split_noise(tr._h_cap), 1.0,
        max_n_gaussians=tr._h_cap))
    stage_ms["scene_densify"] = device_ms(lambda: sgs.densify_and_prune(
        tr.scene.gs, [tr.scene.opt.mu, tr.scene.opt.nu],
        tr._split_noise(tr._s_cap), 0.0002, 0.005, float(tr.scene_extent),
        None, max_n_gaussians=tr._s_cap))
    nets = {f: getattr(tr.human.params, f) for f in hgs.NET_FIELDS}
    d_opt = group_adam_init(nets)
    targets = {k: v for k, v in tr.init_values.items() if k != "edges"}
    lr = torch.tensor(1e-3, device=dev)
    stage_ms["distill_step"] = device_ms(lambda: hst.distill_step(
        tr.human.params, tr.human.state, d_opt, targets, lr, tr.human_cfg))
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    profile = device_kernels(lambda: trainer_step(0), reps=PROFILED_STEPS)
    per_step = (cuda_blend.LAUNCHES / PROFILED_STEPS,
                cuda_blend.K2_LAUNCHES / PROFILED_STEPS)
    print(f"# joint training step through the trainer "
          f"{stage_ms['trainer_step']:.4f} ms; by stage {stage_ms['step']:.4f}"
          f" ms = human_forward {stage_ms['human_forward']:.4f} + render "
          f"{stage_ms['render']:.4f} + loss {stage_ms['loss']:.4f} + backward "
          f"{stage_ms['backward']:.4f} + Adam and stats "
          f"{stage_ms['update']:.4f} ms; distillation step "
          f"{stage_ms['distill_step']:.4f} ms; human densify "
          f"{stage_ms['human_densify']:.4f} ms, scene densify "
          f"{stage_ms['scene_densify']:.4f} ms  [{smi}]")
    print_profile("joint training step", PROFILED_STEPS, *profile, smi)
    print(f"# profiled joint steps: {per_step[0]:.0f} K1 and {per_step[1]:.0f}"
          f" K2 launches per step")
    cull = cull_counts("joint step 0's frame", feat0, bins0, nwalk0)
    t = kernel_times("joint step 0's frame", feat0, bins0, white, g0, logt0,
                     nwalk0, pairs0, cull, plain_reps=1)
    phase_s = time.time() - t_phase
    print(f"# phase 3f: {phase_s:.1f} s (host clock)  [{smi}]")
    return {
        "k1_launches": k1_n, "k2_launches": k2_n, "k1_err": k1_err,
        "k2_err": k2_err, "times": t, "cull": cull, "stage_ms": stage_ms,
        "instances_frame0": int(counts0.sum()),
        "pairs_frame0": [int(x) for x in pairs0.sum(dim=(1, 2))],
        "budget": tr._ibudget, "retries": retries, "metrics": metrics,
        "frame0_photometric": [photo0, photo],
        "frame0_lbs_live_dead": [probe["lbs_before"], lbs_after],
        "launches_per_step": per_step,
        "device_kernels_per_step": profile[1],
        "device_idle_share": 1.0 - sum(profile[0].values()) / profile[2]
        if profile[2] else None,
        "card_vs_cpu_max_abs": worst_b, "phase_s": phase_s,
        "logdir": cfg.logdir, "k1_after_train": k1_after, "cfg": cfg,
        "train_dataset": tr.train_dataset, "trainer": tr,
    }


def evaluation(dev, smi, project, cull_counts, tile_of_pixel, kernel_times,
               joint):
    """Phase 3g, evaluation of phase 3f's output directory through
    hugs_tpu_torch.evaluate.evaluate (the entry function of `python -m
    hugs_tpu_torch.evaluate`), with main's helpers. Checks (a)-(f) of the
    module docstring; raises if one fails; returns its numbers."""
    import copy

    from hugs_tpu_torch import evaluate as ev
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01
    from hugs_tpu_torch.render.tiles import bin_gaussians
    from hugs_tpu_torch.train.trainer import (
        GaussianTrainer, PoseRenderer, render_poses,
    )

    t_phase = time.time()
    logdir = joint["logdir"]
    rec = {}

    class Probed(GaussianTrainer):
        """evaluate's trainer, which records itself, the rows and the
        budget around compaction and rehearsal, K1's launches in each
        stage, the animated frames and whether each overflowed."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["trainer"] = self
            self.anim_overflow = None

        def _stage(self, name, fn):
            n0 = cuda_blend.LAUNCHES
            out = fn()
            torch.cuda.synchronize()
            rec[name + "_k1"] = cuda_blend.LAUNCHES - n0
            return out

        def compact_for_eval(self):
            rec["rows_before"] = (self._h_cap, self._s_cap)
            rec["alive"] = (int(self.human.state.alive.sum()),
                            int(self.scene.gs.alive.sum()))
            self._stage("compact", super().compact_for_eval)
            rec["rows_after"] = (self._h_cap, self._s_cap)

        def rehearse_budget(self, *a, **k):
            rec["budget_before"] = self._ibudget
            rec["budget"] = self._stage("rehearse", lambda: super(
                Probed, self).rehearse_budget(*a, **k))
            return rec["budget"]

        def validate(self, t_iter=None):
            return self._stage("validate", lambda: super(
                Probed, self).validate(t_iter))

        def render_frame(self, data, **kw):
            out = super().render_frame(data, **kw)
            if self.anim_overflow is not None:
                self.anim_overflow.append(bool(out["overflowed"]))
            return out

        def animate(self, t_iter=None, **kw):
            self.anim_overflow = []
            rec["frames"] = self._stage("animate", lambda: super(
                Probed, self).animate(t_iter, **kw))
            rec["anim_overflow"], self.anim_overflow = self.anim_overflow, None
            return rec["frames"]

        def render_canonical(self, *a, **k):
            rec["canon"] = self._stage("canonical", lambda: super(
                Probed, self).render_canonical(*a, **k))
            return rec["canon"]

    # the main path: evaluate, with the counts set to 0 just before
    times = {}
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    t0 = time.time()
    rc = ev.evaluate(logdir, dev, trainer_cls=Probed, times=times)
    torch.cuda.synchronize()
    eval_s = time.time() - t0
    k1_n, k2_n = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    if rc != 0:
        raise AssertionError(f"hugs_tpu_torch.evaluate returned {rc}")
    tr = rec["trainer"]
    n_vals, n_anim = len(tr.val_dataset), len(tr.anim_dataset)
    n_canon = int(tr.cfg.human.canon_nframes)
    print(f"# evaluation: evaluate() {eval_s:.1f} s (host clock); rows "
          f"(human, scene) {rec['rows_before']} -> {rec['rows_after']} by "
          f"compact_for_eval, alive {rec['alive']}; rehearsed budget "
          f"{rec['budget_before']} -> {rec['budget']} slots (training "
          f"budget {joint['budget']}) over {n_vals} val and {n_anim} anim "
          f"frames; K1 launches {k1_n} (rehearsal {rec['rehearse_k1']}, "
          f"validate {rec['validate_k1']}, animate {rec['animate_k1']}, "
          f"turntable {rec['canonical_k1']}), K2 {k2_n}")
    stage_line = ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
    print(f"# evaluation stages (host clock): {stage_line}; animate "
          f"{times['animate'] / n_anim * 1e3:.1f} ms per frame, turntable "
          f"{times['canonical'] / n_canon * 1e3:.1f} ms per frame  [{smi}]")
    if n_anim != ANIM_FRAMES or k2_n != 0 \
            or k1_n != n_vals + n_anim + n_canon:
        raise AssertionError(f"evaluate launched K1 {k1_n} and K2 {k2_n} "
                             f"times for {n_vals} val, {n_anim} anim "
                             f"(expected {ANIM_FRAMES}) and {n_canon} "
                             f"turntable frames")

    # (c) compaction and rehearsal keep phase 3f's metrics
    with open(os.path.join(logdir, "results_eval.json")) as fh:
        metrics = json.load(fh)
    want = joint["metrics"]
    d_metric = {k: abs(metrics[k] - v) for k, v in want.items()}
    print(f"# (c) results_eval.json {metrics} vs phase 3f's validate: "
          f"|d| {d_metric}")
    for k, d in d_metric.items():
        bar = 1e-3 if "psnr" in k else 1e-5
        if ("psnr" in k or "ssim" in k) and not d <= bar:
            raise AssertionError(f"evaluation moved {k} by {d} (bar {bar})")

    # (d) animate
    frames = rec["frames"]
    anim_dir = os.path.join(logdir, "anim", "final")
    pngs = sorted(f for f in os.listdir(anim_dir) if f.endswith(".png"))
    if len(pngs) != n_anim or len(frames) != n_anim:
        raise AssertionError(f"animate wrote {len(pngs)} PNGs for "
                             f"{n_anim} frames")
    if rec["rehearse_k1"] != 0 or rec["animate_k1"] != n_anim:
        raise AssertionError(f"K1 launched {rec['rehearse_k1']} times in "
                             f"the rehearsal and {rec['animate_k1']} for "
                             f"{n_anim} anim frames")
    if any(rec["anim_overflow"]):
        raise AssertionError(f"anim frames overflowed: "
                             f"{rec['anim_overflow']}")
    shares, moved = [], []
    white, black = (torch.ones(3, device=dev), torch.zeros(3, device=dev))
    for i in range(n_anim):
        d = tr.anim_dataset[i]
        ext = tr.ext_tfs_of(d)
        on = [tr.render_frame(d, render_mode="human", ext_tfs=ext,
                              bg=b)["render"] for b in (white, black)]
        t_map = (on[0] - on[1]).mean(0)
        shares.append(float((t_map < 0.5).float().mean()))
        if i:
            moved.append(float((frames[i] - frames[i - 1]).abs().max()))
        img = frames[i]
        if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"anim frame {i}: bad image")
    print(f"# (d) {len(pngs)} anim PNGs, one K1 per frame, none in the "
          f"rehearsal, no overflow; the human's share of each frame "
          f"{[round(x, 4) for x in shares]}; max |d| between consecutive "
          f"frames {min(moved):.3e}-{max(moved):.3e}")
    if min(shares) <= 0.0 or min(moved) <= 0.0:
        raise AssertionError("an anim frame shows no human or repeats the "
                             "one before")

    # (e) the turntable
    canon = rec["canon"]
    canon_dir = os.path.join(logdir, "canon", "final")
    n_png = len([f for f in os.listdir(canon_dir) if f.endswith(".png")])
    if rec["canonical_k1"] != n_canon or len(canon) != n_canon \
            or n_png != n_canon \
            or any(c.shape != (3, 128, 128) for c in canon):
        raise AssertionError(f"the turntable: {len(canon)} frames, {n_png} "
                             f"PNGs, {rec['canonical_k1']} K1 launches for "
                             f"{n_canon}")
    print(f"# (e) the turntable: {n_canon} frames at 128^2, {n_png} PNGs, "
          f"one K1 each")

    # (a) K1 against plain on anim frame 0's merged frame
    d0 = tr.anim_dataset[0]
    with torch.no_grad():
        h_out, s_out = tr.forward_models(d0, ext_tfs=tr.ext_tfs_of(d0))
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs")}
        pg0 = project(d0["camera"], a,
                      torch.cat([h_out["alive"], s_out["alive"]]),
                      h_out["active_sh_degree"])
        bins0 = bin_gaussians(pg0, W, H, tr._ibudget)
        feat0 = gauss_features(pg0)
        bg = tr.bg_color
        img_k, logt_k, nwalk_k, walked = cuda_blend.blend_fwd(
            feat0, bins0.gauss_id, bins0.starts, bins0.ends, bg, W, H)
        img_p, logt_p, pairs0 = plain_blend(feat0, bins0.gauss_id,
                                            bins0.starts, bins0.ends, bg,
                                            W, H)
    counts = bins0.ends - bins0.starts
    print(f"# anim frame 0: {int(pg0.mask.sum())} of {pg0.mask.shape[0]} "
          f"Gaussians visible; {int(counts.sum())} instances (demand "
          f"{int(bins0.n_instances)} before culling, max "
          f"{int(counts.max())} per tile), K1 walked {int(walked.sum())}")
    if bool(bins0.overflowed):
        raise AssertionError("anim frame 0 overflowed the rehearsed budget")
    k1_err = held("K1 raw image vs plain, anim frame 0", img_k, img_p)
    live = logt_p >= LOG_TEPS
    if bool(live.any()):
        held("K1 log T vs plain, anim frame 0 (unsaturated pixels)",
             logt_k[live], logt_p[live])
    if bool((nwalk_k > tile_of_pixel(walked)).any()):
        raise AssertionError("a pixel of anim frame 0 walked past its "
                             "tile's walk")
    d_entry = float((frames[0] - clip01(img_k)).abs().max())
    print(f"# animate's frame 0 vs the K1 image of check (a), clipped: max "
          f"|d| {d_entry:.3e}")
    if d_entry > 1e-6:
        raise AssertionError("animate's frame 0 is not what K1 gave")

    # (b) anim frame 0 on the card against the same states on the CPU
    cpu = torch.device("cpu")
    twin = copy.copy(tr)
    twin.device = cpu
    twin.human = tr.human._replace(
        params=hgs.to_device(tr.human.params, cpu),
        state=hgs.to_device(tr.human.state, cpu), opt=None)
    twin.scene = tr.scene._replace(gs=copy.deepcopy(tr.scene.gs).to(cpu),
                                   opt=None)
    twin.fixed = hgs.to_device(tr.fixed, cpu)
    twin.bg_color = tr.bg_color.cpu()
    twin._budget_rehearsed = False
    ew, eh = EVAL_CPU_WH
    d_card = dict(d0, width=ew, height=eh)
    d_cpu = dict(d_card, camera=hgs.to_device(d0["camera"], cpu))
    got_h, _ = tr.forward_models(d_card, ext_tfs=tr.ext_tfs_of(d_card))
    want_h, _ = twin.forward_models(d_cpu, ext_tfs=twin.ext_tfs_of(d_cpu))
    worst_b = {}
    for k in ("xyz", "scales"):
        worst_b[k] = float((got_h[k].cpu() - want_h[k]).abs().max())
    got = tr.render_frame(d_card)
    t0 = time.time()
    want_img = twin.render_frame(d_cpu)
    cpu_s = time.time() - t0
    print(f"# (b) anim frame 0, card vs CPU: human_forward max |d| "
          f"{worst_b} (bar {AVATAR_ATOL}); the merged frame at {ew}x{eh} "
          f"({cpu_s:.1f} s on the CPU, host clock)")
    if max(worst_b.values()) > AVATAR_ATOL or bool(got["overflowed"]) \
            or bool(want_img["overflowed"]):
        raise AssertionError("anim frame 0's human_forward differs on the "
                             "card, or a render overflowed")
    worst_b["image"] = held(f"anim frame 0 at {ew}x{eh}, card (K1) vs CPU "
                            f"(plain)", got["render"],
                            want_img["render"].to(dev))
    del twin

    # (f) the fast path on the 20 anim body poses from fps_bench_tpu.py's
    # camera, against render_frame per pose
    cam = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                              nframes=2, device=dev)[0]
    body = {"global_orient": np.zeros(3, np.float32),
            "transl": np.zeros(3, np.float32),
            "smpl_scale": np.float32(1.0)}
    poses = [dict(cam, body_pose=tr.anim_dataset[i]["body_pose"],
                  betas=tr.anim_dataset[i]["betas"]) for i in range(n_anim)]
    cuda_blend.LAUNCHES = 0
    fast = render_poses(tr, poses, body)
    torch.cuda.synchronize()
    fast_k1 = cuda_blend.LAUNCHES
    pr = PoseRenderer(tr, body)
    fast_budget = pr.rehearse(poses)
    ref = []
    for p in poses:
        pkg = tr.render_frame(dict(body, **p), render_mode="human",
                              bg=white, budget=max(tr._ibudget,
                                                   fast_budget))
        if bool(pkg["overflowed"]):
            raise AssertionError("a render_frame of the fast path's poses "
                                 "overflowed")
        ref.append(pkg["render"])
    print(f"# (f) render_poses: {n_anim} poses, budget {fast_budget}, K1 "
          f"launches {fast_k1}")
    if fast_k1 != n_anim:
        raise AssertionError(f"render_poses launched K1 {fast_k1} times "
                             f"for {n_anim} poses")
    fast_err = held(f"render_poses vs render_frame, {n_anim} poses",
                    torch.stack(fast), torch.stack(ref))
    moved_f = float((fast[-1] - fast[0]).abs().max())
    if moved_f == 0.0:
        raise AssertionError("the fast path's poses render alike")
    latency, stages = [], {"human_forward": [], "project": [], "bin": [],
                           "blend": [], "frame": []}
    with torch.no_grad():
        for rep in range(3 + n_anim):
            p = poses[rep % n_anim]
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            pr.render(p)
            b.record()
            b.synchronize()
            if rep >= 3:
                latency.append(a.elapsed_time(b))
        for rep in range(3 + REPS):
            p = poses[rep % n_anim]
            ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev_[0].record()
            ho = pr.human_forward(p)
            ev_[1].record()
            pgr = project(cam["camera"], ho, ho["alive"],
                          ho["active_sh_degree"])
            ev_[2].record()
            br = bin_gaussians(pgr, W, H, pr.budget)
            ev_[3].record()
            cuda_blend.blend_tiles(pgr, br, W, H, pr.bg)
            ev_[4].record()
            ev_[4].synchronize()
            if rep >= 3:
                for k, (e0, e1) in (("human_forward", (0, 1)),
                                    ("project", (1, 2)), ("bin", (2, 3)),
                                    ("blend", (3, 4)), ("frame", (0, 4))):
                    stages[k].append(ev_[e0].elapsed_time(ev_[e1]))
        profile = device_kernels(lambda: pr.render(poses[0]))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    frame_ms = statistics.median(latency)
    print(f"# (f) fast-path frame latency {frame_ms:.4f} ms (median of "
          f"{n_anim}, CUDA events; {min(latency):.4f}-{max(latency):.4f}) "
          f"= human_forward {stage_ms['human_forward']:.4f} + project "
          f"{stage_ms['project']:.4f} + bin {stage_ms['bin']:.4f} + blend "
          f"{stage_ms['blend']:.4f} ms (by stage {stage_ms['frame']:.4f} "
          f"ms)  [{smi}]")
    print_profile("fast-path frame", PROFILED, *profile, smi)

    cull = cull_counts("anim frame 0", feat0, bins0, nwalk_k)
    t = kernel_times("anim frame 0 (evaluation)", feat0, bins0, bg, None,
                     logt_k, nwalk_k, pairs0, cull, kernels=("k1",),
                     plain_reps=1)
    phase_s = time.time() - t_phase
    print(f"# phase 3g: {phase_s:.1f} s (host clock)  [{smi}]")
    return {
        "k1_launches": k1_n, "fast_launches": fast_k1, "k1_err": k1_err,
        "fast_err": fast_err, "card_vs_cpu": worst_b, "times": t,
        "cull": cull, "stage_s": times, "metrics": metrics,
        "rows": [rec["rows_before"], rec["rows_after"]],
        "budget": rec["budget"], "human_share": shares,
        "instances_frame0": int(counts.sum()),
        "fast_frame_ms": frame_ms, "fast_stage_ms": stage_ms,
        "fast_budget": fast_budget,
        "fast_device_kernels_per_frame": profile[1],
        "fast_device_idle_share": 1.0 - sum(profile[0].values()) / profile[2]
        if profile[2] else None,
        "phase_s": phase_s, "trainer": tr,
    }


def blend_work(feat, b, width, height, pairs, cull):
    """What K1 and K2 must do for one frame (or band) of width x height
    over bins b: {"k1" / "k2": (operations, operations at the first
    kernels' count, bytes)} and the rows of feat the lists reference. The
    operations: the pairs the cull keeps, the culls and the blended
    pairs (K2's per-instance gradient, 11 per (tile, instance), left
    out); the bytes: each input read once, each output written once."""
    tested, blended = (int(x) for x in pairs.sum(dim=(1, 2)))
    n_inst = int((b.ends - b.starts).sum())
    n_tiles = b.starts.shape[0]
    kept = cull["tested"]
    # both kernels read a row of feat only through the lists
    n_rows = feat_rows_read(b)
    row_bytes = feat.shape[1] * 4
    pix = width * height
    return {
        # the referenced rows of feat, the list, starts + ends, bg;
        # image + log T + n_walked; walked
        "k1": (OPS_TESTED * kept + OPS_CULL * cull["K1"]
               + OPS_BLENDED * blended,
               OPS_TESTED * tested + OPS_BLENDED * blended,
               n_rows * row_bytes + n_inst * 4 + 2 * n_tiles * 4 + 3 * 4
               + 5 * pix * 4 + n_tiles * 4),
        # the referenced rows of feat, the list, starts, bg; g + log T +
        # n_walked; K2's outputs, grad_feat (N, 10) written whole (zeroed,
        # then summed into) and grad_bg
        "k2": (OPS_TESTED * kept + OPS_CULL * cull["K2"]
               + OPS_WARP_SUM * cull["K2_kept"]
               + OPS_BWD_BLENDED * blended,
               OPS_TESTED * tested + OPS_BWD_BLENDED_FIRST * blended,
               n_rows * row_bytes + n_inst * 4 + n_tiles * 4 + 3 * 4
               + 5 * pix * 4 + feat.numel() * 4 + 3 * 4)}, n_rows


def blend_bounds(feat, b, width, height, bg, n_walked):
    """K1's and K2's bounds (ms) on one frame or band, and what bounds
    each: the larger of blend_work's operations over the card's float32
    peak and its bytes over its memory rate; the pairs from the plain
    blend, the culls from the kernels' own warp cull."""
    from hugs_tpu_torch.render.blend import plain_blend
    pairs = plain_blend(feat, b.gauss_id, b.starts, b.ends, bg, width,
                        height)[2]
    cull = warp_cull_counts(feat, b, n_walked, width, height)
    work, n_rows = blend_work(feat, b, width, height, pairs, cull)
    out = {"feat_rows_read": n_rows,
           "instances": int((b.ends - b.starts).sum())}
    for k, (ops, _, nbytes) in work.items():
        ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        out[k + "_bound"] = max(ops_ms, bytes_ms)
        out[k + "_bound_by"] = "operations" if ops_ms >= bytes_ms \
            else "bytes"
    return out


def held_tensors(name, got: list, want: list):
    """K2's bars (held_grad's share and norm) on each pair of gradient
    tensors, flattened; raises naming the first pair outside them.
    Returns the largest |difference| and ||difference|| / ||want||."""
    worst, worst_rel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = a.reshape(-1), b.reshape(-1)
        d = (a - b).abs()
        share = float((d <= GRAD_ATOL + GRAD_RTOL * b.abs()).float().mean())
        nb = float(b.norm())
        rel = float(d.norm()) / nb if nb > 0 else float(d.norm())
        if share < GRAD_SHARE or rel > GRAD_REL_NORM:
            raise AssertionError(f"{name}: tensor {i} of {len(want)} "
                                 f"disagrees: {share:.6f} within "
                                 f"{GRAD_ATOL} + {GRAD_RTOL} |g|, ||d|| / "
                                 f"||g|| {rel:.3e}")
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        worst_rel = max(worst_rel, rel)
    print(f"# {name}: {len(want)} tensors within K2's bars, max |d| "
          f"{worst:.3e}, max ||d|| / ||g|| {worst_rel:.3e}")
    return worst, worst_rel


def dp_config(cfg):
    """Phase 3h's configuration of a batched run resuming phase 3f's
    final checkpoint: train.batch_size DP_BATCH, DP_STEPS steps, no
    distillation, no logdir (nothing written, nothing validated)."""
    import copy
    cfg = copy.deepcopy(cfg)
    cfg.train.batch_size = DP_BATCH
    cfg.train.num_steps = DP_STEPS - 1
    cfg.human.run_init = False
    cfg.logdir = ""
    return cfg


def dp_rank_step(rank, world, cfg, device_type="cuda"):
    """Check (d) of phase 3h on rank `rank` of `world` NCCL ranks (card
    `rank`; the CPU, over gloo, for a rehearsal), the mesh factored as __graft_entry__.py's dryrun_multichip
    does: the trainer of dp_config resumed from phase 3f's checkpoint,
    its first batch through the data x tile step. Returns the step's
    loss, the mesh and a digest of every tensor of both states after."""
    import hashlib

    from hugs_tpu_torch import main as cli
    from hugs_tpu_torch.parallel.mesh import factor_devices, make_mesh
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.train import checkpoint as ckpt_io
    from hugs_tpu_torch.train.trainer import GaussianTrainer

    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = factor_devices(world)
    mesh = make_mesh(*shape)
    train_ds, _, _ = cli.build_datasets(cfg, dev)
    tr = GaussianTrainer(cfg, train_ds, device=dev, mesh=mesh)
    tr._check_batch_layout(DP_BATCH)
    tr._broadcast_states()
    idxs = [int(i) for i in np.random.RandomState(cfg.seed).permutation(
        len(train_ds))[:DP_BATCH]]
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    _, vals = tr._batched_step(0, idxs, True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    digest = hashlib.sha256()
    for st in (tr.human, tr.scene):
        for k, v in sorted(ckpt_io.flatten(st).items()):
            digest.update(k.encode())
            digest.update(v.detach().cpu().numpy().tobytes())
    return {"loss": vals[0], "overflowed": vals[2], "mesh": shape,
            "retries": tr.retries, "k1": cuda_blend.LAUNCHES,
            "k2": cuda_blend.K2_LAUNCHES, "digest": digest.hexdigest()}


def bands_check(dev, smi, project, tr):
    """Check (a) of phase 3h on trainer tr's anim frame 0: the merged
    frame in 2 and 4 bands against one band, the stitched image (K1) and
    an L1 loss's gradient of the blend's inputs (K2), n_bands launches of
    each, each band's kernel times. Returns them by n_bands."""
    from hugs_tpu_torch.parallel.shard import band_height, blend_band
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features
    from hugs_tpu_torch.render.project import update_mean2d
    from hugs_tpu_torch.render.tiles import bin_gaussians

    d0 = tr.anim_dataset[0]
    with torch.no_grad():
        h_out, s_out = tr.forward_models(d0, ext_tfs=tr.ext_tfs_of(d0))
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs")}
        pg = project(d0["camera"], a,
                     torch.cat([h_out["alive"], s_out["alive"]]),
                     h_out["active_sh_degree"])
    fields = ("mean2d", "conic", "rgb", "opacity")
    leaf = {f: getattr(pg, f).detach().clone().requires_grad_() for f in
            fields}
    pg_l = pg._replace(**leaf)
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    target = torch.rand((3, H, W), generator=g, device=dev)
    bg, budget = tr.bg_color, tr._ibudget

    def stitched(n):
        imgs = [blend_band(pg_l, W, H, b, n, budget, bg)[0]
                for b in range(n)]
        img = torch.cat(imgs, dim=1)[:, :H]
        grads = torch.autograd.grad((img - target).abs().mean(),
                                    [leaf[f] for f in fields])
        return img.detach(), torch.cat(
            [x.reshape(x.shape[0], -1) for x in grads], dim=1)

    def band_times(n):
        """Each band's K1 and K2 alone (ms, single launches), its
        instances, and each kernel's bound on the band."""
        k1_ms, k2_ms, inst, bounds = [], [], [], []
        band_h = band_height(H, n)
        for b in range(n):
            with torch.no_grad():
                pg_b = update_mean2d(pg, pg.mean2d.new_tensor(
                    [0.0, -float(b * band_h)]))
                bins = bin_gaussians(pg_b, W, band_h, budget)
                feat = gauss_features(pg_b)
                args = (feat, bins.gauss_id, bins.starts, bins.ends, bg, W,
                        band_h)
                _, logt, nwalk, _ = cuda_blend.blend_fwd(*args)
                gr = torch.rand((3, band_h, W), generator=g, device=dev)
                k1_ms.append(device_ms(lambda: cuda_blend.blend_fwd(*args)))
                k2_ms.append(device_ms(lambda: cuda_blend.blend_bwd(
                    *args, gr, logt, nwalk)))
                bounds.append(blend_bounds(feat, bins, W, band_h, bg, nwalk))
            inst.append(int((bins.ends - bins.starts).sum()))
        per = {k: [b[k] for b in bounds] for k in (
            "k1_bound", "k2_bound", "k1_bound_by", "k2_bound_by",
            "feat_rows_read")}
        print(f"# (a) {n} band(s): instances {inst} over rows of feat "
              f"{per['feat_rows_read']}; K1 ms per band "
              f"{[round(x, 4) for x in k1_ms]} (sum {sum(k1_ms):.4f}), bound "
              f"{[round(x, 5) for x in per['k1_bound']]} by "
              f"{per['k1_bound_by']}; K2 {[round(x, 4) for x in k2_ms]} (sum "
              f"{sum(k2_ms):.4f}), bound "
              f"{[round(x, 5) for x in per['k2_bound']]} by "
              f"{per['k2_bound_by']}  [{smi}]")
        return {"band_rows": band_h, "instances": inst, "k1_ms": k1_ms,
                "k2_ms": k2_ms, **per}

    one_img, one_grad = stitched(1)
    bands = {1: band_times(1)}
    for n in BANDS:
        cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
        img, grad = stitched(n)
        torch.cuda.synchronize()
        k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
        print(f"# (a) anim frame 0 in {n} bands of {band_height(H, n)} rows:"
              f" {k1} K1 and {k2} K2 launches")
        if k1 != n or k2 != n:
            raise AssertionError(f"{n} bands launched K1 {k1} and K2 {k2} "
                                 f"times")
        err = held(f"K1 {n} bands stitched vs one band, anim frame 0", img,
                   one_img)
        gerr = held_grad(f"K2 {n} bands vs one band, anim frame 0 "
                         f"(columns mx my ca cb cc r g b op)", grad,
                         one_grad)
        bands[n] = dict(band_times(n), k1_launches=k1, k2_launches=k2,
                        image_max_abs=err, grad_max_abs=gerr)
    return bands



def batched_animate_check(smi, tr):
    """Check (b) of phase 3h: trainer tr's animate in batches of
    ANIM_BATCH against one frame at a time. Returns the launches, the
    difference and ms a frame of both."""
    from hugs_tpu_torch.render import cuda_blend

    # the images only (no PNGs written), in turns: alone, batched,
    # batched, alone; the launches counted over the first batched run
    logdir, tr.cfg.logdir = tr.cfg.logdir, ""
    anim_s = {1: [], ANIM_BATCH: []}
    try:
        for i, bsz in enumerate((1, ANIM_BATCH, ANIM_BATCH, 1)):
            torch.cuda.synchronize()
            cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
            t0 = time.time()
            frames_b = tr.animate(batch_size=bsz)
            torch.cuda.synchronize()
            anim_s[bsz].append(time.time() - t0)
            if i == 0:
                alone = frames_b
            elif i == 1:
                batched, k1_anim = frames_b, cuda_blend.LAUNCHES
        del frames_b
    finally:
        tr.cfg.logdir = logdir
    n_anim = len(alone)
    batched_s, alone_s = (statistics.median(anim_s[b])
                          for b in (ANIM_BATCH, 1))
    print(f"# (b) animate of {n_anim} frames: batches of {ANIM_BATCH} "
          f"{[round(x / n_anim * 1e3, 3) for x in anim_s[ANIM_BATCH]]} ms a "
          f"frame, one at a time "
          f"{[round(x / n_anim * 1e3, 3) for x in anim_s[1]]} (host clock, "
          f"in turns 1, {ANIM_BATCH}, {ANIM_BATCH}, 1); {k1_anim} K1 "
          f"launches in a batched run  [{smi}]")
    if len(batched) != n_anim or k1_anim != n_anim or n_anim != ANIM_FRAMES:
        raise AssertionError(f"animate in batches gave {len(batched)} "
                             f"frames with {k1_anim} K1 launches for "
                             f"{n_anim}")
    anim_err = held(f"animate in batches of {ANIM_BATCH} vs one at a time, "
                    f"{n_anim} frames", torch.stack(batched),
                    torch.stack(alone))
    return {"anim_k1": k1_anim, "anim_err": anim_err,
            "anim_ms": {"batched": batched_s / n_anim * 1e3,
                        "alone": alone_s / n_anim * 1e3}}



def batched_step_check(dev, smi, cfg, train_dataset):
    """Check (c) of phase 3h: a trainer of dp_config `cfg` over
    train_dataset inside a one-rank NCCL group, its first batch's loss
    and gradients against the mean of its frames' (joint_step's pieces,
    the same draws); DP_STEPS steps through train(), a step's stages,
    its profile. Returns its numbers, the batch's loss among them."""
    import torch.distributed as dist

    from hugs_tpu_torch.parallel.launch import free_port
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.train import joint_step as jst
    from hugs_tpu_torch.train.optim import leaves
    from hugs_tpu_torch.train.trainer import GaussianTrainer

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        t0 = time.time()
        dp = GaussianTrainer(cfg, train_dataset, device=dev)
        build_s = time.time() - t0
        if not dp.mesh.distributed or dp.mesh.size != 1:
            raise AssertionError(f"the trainer's mesh is {dp.mesh}")
        n = len(dp.train_dataset)
        idxs = [int(i) for i in np.random.RandomState(cfg.seed).permutation(
            n)[:DP_BATCH]]
        gen_state = dp.gen.get_state()
        frames = dp._batch_frames(0, idxs)
        dp.gen.set_state(gen_state)     # train() draws them again
        mode = dp._mode(0)
        step = dp._get_dp_step(W, H, mode)
        js = jst.JointTrainState(human=dp.human, scene=dp.scene)
        got = step.grads(js, frames, dp._ibudget)
        lpips = dp.lpips if dp.loss_fn.l_lpips_w > 0 else None
        losses, refs = [], None
        for fr in frames:
            hook = torch.zeros((dp._h_cap + dp._s_cap, 2), device=dev,
                               requires_grad=True)
            pkg, o = jst.joint_render(
                js, dp.fixed, fr["camera"], fr["bg"], fr["human_bg"], hook,
                fr["smpl_scale"], fr["dataset_idx"], cfg=dp.human_cfg,
                width=W, height=H, instance_budget=dp._ibudget,
                render_human_separate=dp.loss_fn.l_humansep_w > 0)
            loss, _ = jst.joint_loss(dp.loss_fn, fr["draws"], fr["rgb"],
                                     fr["mask"], fr["bg"], fr["human_bg"],
                                     pkg, o, lpips)
            hg, sg, hk = jst.joint_grads(loss, js, hook, True)
            flat = [x / DP_BATCH for x in
                    leaves(hg) + list(sg.values()) + [hk]]
            refs = flat if refs is None else [r + x for r, x in
                                              zip(refs, flat)]
            losses.append(float(loss.detach()))
            del pkg, o, loss, hg, sg, hk, flat
        mean_loss = sum(losses) / DP_BATCH
        d_loss = abs(float(got.loss) - mean_loss)
        print(f"# (c) batch of {DP_BATCH} (frames {idxs}) through the data x"
              f" tile step on a one-rank NCCL group: loss "
              f"{float(got.loss):.7f} against the mean {mean_loss:.7f} of "
              f"its frames' {[round(x, 7) for x in losses]}: |d| "
              f"{d_loss:.3e}")
        if not d_loss <= 2e-5 + 2e-6 * abs(mean_loss):
            raise AssertionError("the batch's loss is not the mean of its "
                                 "frames'")
        grad_err = held_tensors(
            "(c) the batch's gradients vs the mean of its frames'",
            leaves(got.h_grads) + list(got.s_grads.values())
            + [got.hook_grad], refs)
        del got, refs
        # DP_STEPS steps through train(), the launches counted
        cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        log = dp.train()
        torch.cuda.synchronize()
        train_s = time.time() - t0
        k1_dp, k2_dp = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
        print(f"# (c) train() at train.batch_size {DP_BATCH}: {DP_STEPS} "
              f"steps in {train_s:.2f} s (host clock), log {log}, "
              f"{dp.retries} steps rendered again; K1 {k1_dp}, K2 {k2_dp} "
              f"launches (trainer built in {build_s:.1f} s)")
        if abs(log[0]["loss"] - float(mean_loss)) > 2e-5 + 2e-6 * abs(
                mean_loss):
            raise AssertionError(f"train()'s first step gave loss "
                                 f"{log[0]['loss']}, not {mean_loss}")
        per_step = 2 * DP_BATCH      # the merged frame and the human alone
        if k1_dp != per_step * (DP_STEPS + dp.retries) \
                or k2_dp != per_step * (DP_STEPS + dp.retries):
            raise AssertionError(f"{DP_STEPS} batched steps launched K1 "
                                 f"{k1_dp} and K2 {k2_dp} times")
        # stages of a step, CUDA events; then the profile
        stages = {k: [] for k in ("draws", "grads", "update", "step")}
        for rep in range(REPS // 4 + 1):
            t_iter = DP_STEPS + rep
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            frames = dp._batch_frames(t_iter, idxs)
            ev[1].record()
            got = step.grads(js, frames, dp._ibudget)
            ev[2].record()
            step.update(js, got, dp.h_xyz_sched(t_iter), dp.h_static_lrs,
                        dp.s_xyz_sched(t_iter), dp.s_static_lrs)
            ev[3].record()
            ev[3].synchronize()
            if rep:
                for k, (e0, e1) in (("draws", (0, 1)), ("grads", (1, 2)),
                                    ("update", (2, 3)), ("step", (0, 3))):
                    stages[k].append(ev[e0].elapsed_time(ev[e1]))
            del got
        stage_ms = {k: statistics.median(v) for k, v in stages.items()}
        cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
        profile = device_kernels(lambda: dp._batched_step(
            DP_STEPS, idxs, False), reps=PROFILED_STEPS)
        launches = (cuda_blend.LAUNCHES / PROFILED_STEPS,
                    cuda_blend.K2_LAUNCHES / PROFILED_STEPS)
    finally:
        dist.destroy_process_group()
    print(f"# (c) a batched step of {DP_BATCH} frames {stage_ms['step']:.4f} "
          f"ms = draws {stage_ms['draws']:.4f} + forward and backward of "
          f"the frames with the all-reduces {stage_ms['grads']:.4f} + Adam "
          f"and stats {stage_ms['update']:.4f} ms (median of "
          f"{len(stages['step'])}, CUDA events)  [{smi}]")
    print_profile("batched joint step", PROFILED_STEPS, *profile, smi)
    print(f"# profiled batched steps: {launches[0]:.0f} K1 and "
          f"{launches[1]:.0f} K2 launches per step")
    return dict(dp_loss=mean_loss, dp_frame_losses=losses,
                dp_loss_abs_err=d_loss, dp_grad_err=grad_err,
                dp_k1=k1_dp, dp_k2=k2_dp, dp_stage_ms=stage_ms,
                dp_launches_per_step=launches,
                dp_device_kernels_per_step=profile[1],
                dp_device_idle_share=1.0 - sum(profile[0].values())
                / profile[2] if profile[2] else None, dp_train_s=train_s)



def multi_card_check(smi, cfg, mean_loss):
    """Check (d) of phase 3h: with 2 or more cards, the batch of check
    (c) through one data x tile step on min(DP_RANKS_MAX, cards) NCCL
    ranks: the loss (c)'s, the ranks' states bit for bit equal. Returns
    its numbers, or None (and says so) with one card."""
    from hugs_tpu_torch.parallel.launch import run_ranks

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"# (d) several cards: not run, torch.cuda.device_count() = "
              f"{n_cards}")
        return None
    world = min(DP_RANKS_MAX, n_cards)
    t0 = time.time()
    ranks = run_ranks(dp_rank_step, world, (cfg,), backend="nccl",
                      timeout=DP_TIMEOUT)
    mr_s = time.time() - t0
    r0 = ranks[0]
    print(f"# (d) {world} NCCL ranks, mesh (data, tile) {r0['mesh']}: "
          f"loss {[r['loss'] for r in ranks]} against (c)'s "
          f"{mean_loss:.7f}; K1 {[r['k1'] for r in ranks]}, K2 "
          f"{[r['k2'] for r in ranks]} launches; digests "
          f"{sorted({r['digest'][:16] for r in ranks})}; {mr_s:.1f} s "
          f"(host clock)")
    if any(abs(r["loss"] - mean_loss) > 2e-5 + 2e-6 * abs(mean_loss)
           for r in ranks):
        raise AssertionError("the multi-card step's loss is not (c)'s")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' states differ after the step")
    return {"ranks": world, "mesh": r0["mesh"],
            "losses": [r["loss"] for r in ranks],
            "k1": [r["k1"] for r in ranks],
            "k2": [r["k2"] for r in ranks], "s": mr_s}


def scale_out(dev, smi, project, joint, evaln):
    """Phase 3h, config[4]'s scale-out on phase 3f's run (joint) and
    phase 3g's evaluation trainer (evaln). Checks (a)-(d) of the module
    docstring; raises if one fails; returns its numbers."""
    t_phase = time.time()
    tr = evaln["trainer"]
    out = {"bands": bands_check(dev, smi, project, tr)}
    out.update(batched_animate_check(smi, tr))
    cfg = dp_config(joint["cfg"])
    out.update(batched_step_check(dev, smi, cfg, joint["train_dataset"]))
    torch.cuda.empty_cache()    # rank 0 of check (d) shares this card
    out["multi_rank"] = multi_card_check(smi, cfg, out["dp_loss"])
    out["phase_s"] = time.time() - t_phase
    print(f"# phase 3h: {out['phase_s']:.1f} s (host clock)  [{smi}]")
    return out


def gauss_frame_check(dev, smi, project, slot_budget, tr, d0):
    """Check (a) of phase 3i: anim frame 0's merged set at phase 3f's
    capacities through render(gauss_mesh=<one rank>) against render():
    the image (K1), an L1 loss's gradient of the inputs (K2's bars), the
    fragments against the kept instances, the launches; then K1 and K2
    on the fragment band against the plain bins, the pack and sort, and
    the peak memory. Returns its numbers."""
    from hugs_tpu_torch.parallel.gauss_shard import (
        pack_fragments, sort_fragments,
    )
    from hugs_tpu_torch.parallel.mesh import make_gauss_mesh
    from hugs_tpu_torch.parallel.shard import band_height
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features
    from hugs_tpu_torch.render.renderer import render
    from hugs_tpu_torch.render.tiles import TileBins, bin_gaussians, tile_grid

    mesh = make_gauss_mesh(1)
    with torch.no_grad():
        h_out, s_out = tr.forward_models(d0, ext_tfs=tr.ext_tfs_of(d0))
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs", "alive")}
        pg = project(d0["camera"], a, a["alive"], h_out["active_sh_degree"])
        probe = bin_gaussians(pg, W, H, 4 * a["xyz"].shape[0])
        budget = slot_budget(int(probe.n_slots))
        bins = bin_gaussians(pg, W, H, budget)
        kept = int((bins.ends - bins.starts).sum())
        if bool(bins.overflowed):
            raise AssertionError(f"anim frame 0 overflowed {budget} slots")
    n_rows = a["xyz"].shape[0]
    deg = h_out["active_sh_degree"]
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    target = torch.rand((3, H, W), generator=g, device=dev)
    keys = ("xyz", "scales", "rotq", "opacity", "shs")

    def run(**kw):
        leaf = {k: a[k].detach().clone().requires_grad_() for k in keys}
        out = render(*(leaf[k] for k in keys), d0["camera"], W, H,
                     bg=tr.bg_color, active_sh_degree=deg, alive=a["alive"],
                     instance_budget=budget, **kw)
        grads = torch.autograd.grad((out["render"] - target).abs().mean(),
                                    [leaf[k] for k in keys])
        torch.cuda.synchronize()
        alive = a["alive"]
        return out, [x[alive] for x in grads]

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ref, ref_grads = run()
    peak_ref = torch.cuda.max_memory_allocated() - base
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, got_grads = run(gauss_mesh=mesh)
    peak = torch.cuda.max_memory_allocated() - base
    k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    frags = int(got["frag_counts"].sum())
    print(f"# (a) anim frame 0 through render(gauss_mesh=<1 rank>): "
          f"{n_rows} rows ({int(a['alive'].sum())} alive), {kept} kept "
          f"instances, {frags} fragments, budget {budget}; {k1} K1 and {k2} "
          f"K2 launches; peak memory above the inputs {peak / 2**30:.3f} GiB"
          f" (render(): {peak_ref / 2**30:.3f} GiB)  [{smi}]")
    if k1 != 1 or k2 != 1:
        raise AssertionError(f"the fragment path launched K1 {k1} and K2 "
                             f"{k2} times")
    if frags != kept or bool(got["overflowed"]):
        raise AssertionError(f"{frags} fragments for {kept} kept instances"
                             f" (overflowed {bool(got['overflowed'])})")
    img_err = held("(a) K1 on the fragment band vs render(), anim frame 0",
                   got["render"].detach(), ref["render"].detach())
    grad_err, grad_rel = held_tensors(
        "(a) K2 through the fragments vs render(): the gradients of xyz, "
        "scales, rotq, opacity, shs (alive rows)", got_grads, ref_grads)
    del ref, got, ref_grads, got_grads

    # the stages on one rank, and K1 / K2 on the band against the bins
    band_h = band_height(H, 1)
    nx, ny = tile_grid(W, band_h)
    with torch.no_grad():
        pb = bin_gaussians(pg, W, band_h, budget)
        pack_ms = device_ms(lambda: pack_fragments(pg, pb, 1, nx * ny,
                                                   budget, 0))
        fr = pack_fragments(pg, pb, 1, nx * ny, budget, 0)
        sort_ms = device_ms(lambda: sort_fragments(fr.feat, fr.meta,
                                                   nx * ny))
        f_feat, f_starts, f_ends = sort_fragments(fr.feat, fr.meta, nx * ny)
        f_gid = torch.arange(f_feat.shape[0], dtype=torch.int32, device=dev)
        fb = TileBins(gauss_id=f_gid, starts=f_starts, ends=f_ends,
                      n_instances=None, aligned_total=None, overflowed=None,
                      n_slots=None)
        bg = tr.bg_color
        feat = gauss_features(pg)
        out = {"rows": n_rows, "kept": kept, "fragments": frags,
               "budget": budget, "k1_launches": k1, "k2_launches": k2,
               "image_max_abs": img_err, "grad_max_abs": grad_err,
               "grad_rel_norm": grad_rel,
               "peak_gib": peak / 2**30, "render_peak_gib": peak_ref / 2**30,
               "pack_ms": pack_ms, "sort_ms": sort_ms}
        for name, (f, b, h) in (("fragments", (f_feat, fb, band_h)),
                                ("bins", (feat, bins, H))):
            args = (f, b.gauss_id, b.starts, b.ends, bg, W, h)
            _, logt, nwalk, _ = cuda_blend.blend_fwd(*args)
            gr = torch.rand((3, h, W), generator=g, device=dev)
            t = {"k1_ms": device_ms(lambda: cuda_blend.blend_fwd(*args),
                                    inner=BACK_TO_BACK),
                 "k2_ms": device_ms(lambda: cuda_blend.blend_bwd(
                     *args, gr, logt, nwalk), inner=BACK_TO_BACK)}
            t.update(blend_bounds(f, b, W, h, bg, nwalk))
            out[name] = t
            print(f"# (a) K1 / K2 on the {name} (W x {h}): {t['k1_ms']:.4f} /"
                  f" {t['k2_ms']:.4f} ms ({BACK_TO_BACK} back-to-back), "
                  f"bounds {t['k1_bound']:.5f} by {t['k1_bound_by']} / "
                  f"{t['k2_bound']:.5f} by {t['k2_bound_by']} ms; "
                  f"{t['instances']} instances over {t['feat_rows_read']} of"
                  f" {f.shape[0]} rows of feat  [{smi}]")
    print(f"# (a) one rank's fragment work: pack {pack_ms:.4f} ms, sort "
          f"{sort_ms:.4f} ms (median of 20, CUDA events), no exchange on "
          f"one rank; {budget} rows a packet  [{smi}]")
    return out


def gauss_step_check(dev, smi, tr):
    """Check (b) of phase 3i on phase 3f's scene (its final state, at
    its capacity): GAUSS_STEPS[0] Gaussian-sharded steps on one rank, a
    densify fed the same noise, GAUSS_STEPS[1] more, against
    scene_train_step on copies of the same state and frames: the loss
    each step, n_alive after the densify; the gauss step by stage."""
    from hugs_tpu_torch.parallel.gauss_train import (
        gauss_densify_step, make_gauss_scene_train_step, shard_scene_state,
    )
    from hugs_tpu_torch.parallel.mesh import make_gauss_mesh
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.train import scene_step as sst

    mesh = make_gauss_mesh(1)
    cfg = tr.cfg
    budget = tr._ibudget
    ref = shard_scene_state(tr.scene, mesh)      # a whole copy on one rank
    mine = shard_scene_state(tr.scene, mesh)
    cap = ref.gs.capacity
    step = make_gauss_scene_train_step(
        mesh, width=W, height=H, l1_w=cfg.scene.loss.l1_w,
        ssim_w=cfg.scene.loss.ssim_w, local_budget=budget)
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    noise = torch.randn((2, cap, 3), generator=g, device=dev)
    black = torch.zeros(3, device=dev)
    n = len(tr.train_dataset)
    losses, stages = [], {k: [] for k in ("render", "loss", "grads",
                                          "update", "step")}
    k1_gauss = k2_gauss = 0
    for i in range(sum(GAUSS_STEPS)):
        if i == GAUSS_STEPS[0]:
            kw = dict(grad_threshold=cfg.scene.densify_grad_threshold,
                      min_opacity=cfg.scene.prune_min_opacity,
                      percent_dense=cfg.scene.percent_dense,
                      max_n_gaussians=int(cfg.scene.max_n_gaussians))
            extent = float(tr.scene_extent)
            _, info_g = gauss_densify_step(mine, mesh, noise, extent, **kw)
            _, info_r = sst.scene_densify_step(ref, noise, extent, **kw)
            na = (int(info_g["n_alive"]), int(info_r["n_alive"]))
            print(f"# (b) densify after {i} steps, the same noise: n_alive "
                  f"{na[0]} (gauss) and {na[1]} (scene_train_step's), cloned"
                  f" {int(info_g['n_cloned'])}, split "
                  f"{int(info_g['n_split'])}")
            if na[0] != na[1]:
                raise AssertionError("the densify's n_alive differs")
        d = tr.train_dataset[i % n]
        lr = tr.s_xyz_sched(i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        n0 = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES)
        ev[0].record()
        pkg, hook = step.render(mine, d["camera"], black)
        ev[1].record()
        loss = step.loss(pkg["render"], d["rgb"])
        ev[2].record()
        grads, hook_grad = step.grads(loss, mine, hook)
        ev[3].record()
        step.update(mine, grads, hook_grad, pkg, lr, tr.s_static_lrs)
        ev[4].record()
        ev[4].synchronize()
        k1_gauss += cuda_blend.LAUNCHES - n0[0]
        k2_gauss += cuda_blend.K2_LAUNCHES - n0[1]
        for k, (e0, e1) in (("render", (0, 1)), ("loss", (1, 2)),
                            ("grads", (2, 3)), ("update", (3, 4)),
                            ("step", (0, 4))):
            stages[k].append(ev[e0].elapsed_time(ev[e1]))
        if bool(pkg["overflowed"]):
            raise AssertionError(f"gauss step {i} overflowed")
        _, aux = sst.scene_train_step(
            ref, d["camera"], d["rgb"], black, lr, tr.s_static_lrs, width=W,
            height=H, l1_w=cfg.scene.loss.l1_w, ssim_w=cfg.scene.loss.ssim_w,
            instance_budget=budget)
        losses.append((float(loss.detach()), float(aux["loss"])))
        del pkg, hook, grads, hook_grad, loss
    torch.cuda.synchronize()
    stage_ms = {k: statistics.median(v[1:]) for k, v in stages.items()}
    print(f"# (b) {sum(GAUSS_STEPS)} steps on phase 3f's scene (capacity "
          f"{cap}): losses (gauss, scene_train_step) {losses}; gauss step "
          f"{stage_ms['step']:.4f} ms = render {stage_ms['render']:.4f} + "
          f"loss {stage_ms['loss']:.4f} + backward {stage_ms['grads']:.4f} "
          f"+ Adam and stats {stage_ms['update']:.4f} (median of "
          f"{len(stages['step']) - 1}, CUDA events); {k1_gauss} K1 and "
          f"{k2_gauss} K2 in the gauss steps  [{smi}]")
    for i, (lg, lr_) in enumerate(losses):
        if not abs(lg - lr_) <= GAUSS_LOSS_RTOL * abs(lr_):
            raise AssertionError(f"step {i}: gauss loss {lg} against {lr_}")
    if k1_gauss != sum(GAUSS_STEPS) or k2_gauss != sum(GAUSS_STEPS):
        raise AssertionError(f"{k1_gauss} K1 and {k2_gauss} K2 launches in "
                             f"the gauss steps")
    return {"losses": losses, "n_alive": na, "stage_ms": stage_ms,
            "k1_launches": k1_gauss, "k2_launches": k2_gauss}


def gauss_main_check(dev, smi, root):
    """Check (c) of phase 3i: hugs_tpu_torch.main in scene mode with
    tpu.gauss_shard 1 on phase 3f's sequence for GAUSS_MAIN_STEPS steps
    (validate and animate after), then render_frame of a val frame with
    gauss_shard 1 against 0. Returns its numbers."""
    from hugs_tpu_torch import main as cli
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.train.trainer import GaussianTrainer

    rec = {}

    class Recorded(GaussianTrainer):
        def train(self):
            rec["trainer"] = self
            return super().train()

    cfg = joint_config(root, "phase3i", {
        "mode": "scene", "tpu.gauss_shard": 1,
        "train.num_steps": GAUSS_MAIN_STEPS,
        "train.val_interval": 1000})
    main_trainer = cli.GaussianTrainer
    cli.GaussianTrainer = Recorded
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    try:
        t0 = time.time()
        rc = cli.main(cfg, device=dev)
        torch.cuda.synchronize()
        main_s = time.time() - t0
    finally:
        cli.GaussianTrainer = main_trainer
    if rc != 0:
        raise AssertionError(f"hugs_tpu_torch.main.main returned {rc}")
    k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    tr = rec.pop("trainer")
    with open(os.path.join(cfg.logdir, "results_train.json")) as f:
        log = json.load(f)
    n_val = len(tr.val_dataset)
    n_anim = len(tr.anim_dataset) if tr.anim_dataset is not None else 0
    steps = GAUSS_MAIN_STEPS + 1
    print(f"# (c) main() in scene mode, tpu.gauss_shard 1: {main_s:.1f} s "
          f"(host clock), {steps} steps, log {log}, {tr.retries} retried; "
          f"K1 {k1} (steps {steps} + val {n_val} + anim {n_anim}), K2 {k2}")
    if k2 != steps or k1 != steps + n_val + n_anim:
        raise AssertionError(f"main() launched K1 {k1} and K2 {k2} times")
    if not np.isfinite([e["loss"] for e in log]).all():
        raise AssertionError("main()'s losses are not finite")
    d = tr.val_dataset[0]
    one = tr.render_frame(d)
    tr.cfg.tpu.gauss_shard = 0
    zero = tr.render_frame(d)
    if "frag_counts" not in one or "frag_counts" in zero:
        raise AssertionError("render_frame did not take the gauss path")
    err = held("(c) render_frame with gauss_shard 1 vs 0, val frame 0",
               one["render"], zero["render"])
    return {"main_s": main_s, "log": log, "k1": k1, "k2": k2,
            "render_frame_max_abs": err}


def graft_entry_check(dev, smi):
    """Check (d) of phase 3i: graft_entry.entry()'s frame on the card and
    dryrun_multichip(1) (one NCCL rank on card 0). Returns its numbers."""
    from hugs_tpu_torch import graft_entry
    from hugs_tpu_torch.render import cuda_blend

    t0 = time.time()
    fn, args = graft_entry.entry(dev)
    cuda_blend.LAUNCHES = 0
    img = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.time() - t0
    k1 = cuda_blend.LAUNCHES
    frame_ms = device_ms(lambda: fn(*args), reps=5)
    if tuple(img.shape) != (3, 270, 480) or not bool(
            torch.isfinite(img).all()) or k1 != 1:
        raise AssertionError(f"entry() gave {tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")
    del fn, args, img
    torch.cuda.empty_cache()    # the dryrun's rank shares this card
    t0 = time.time()
    r = graft_entry.dryrun_multichip(1, "cuda")[0]
    dry_s = time.time() - t0
    print(f"# (d) entry(): (3, 270, 480) finite in {entry_s:.1f} s (host "
          f"clock, built and run), a frame {frame_ms:.3f} ms; "
          f"dryrun_multichip(1) {dry_s:.1f} s: loss {r['loss']:.5f}, gauss "
          f"loss {r['gauss_loss']:.5f}  [{smi}]")
    return {"entry_s": entry_s, "entry_frame_ms": frame_ms, "k1_launches": k1,
            "dryrun_s": dry_s,
            "dryrun": {k: r[k] for k in ("mesh", "loss", "delta",
                                         "gauss_loss", "gauss_delta")}}


def pergs_check(dev, smi, project, slot_budget):
    """Check (e) of phase 3i: the per-Gaussian avatar on phase 3c's body
    (synthetic_smpl(288) subdivided twice), human_pergs_forward at a
    pose, rendered through K1 at W x H; then the same avatar on the CPU
    at EVAL_CPU_WH: the forward at human_forward's bar, the image (K1
    against the plain blend) at the image bar. Returns its numbers."""
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models import human_gs_pergs as pergs
    from hugs_tpu_torch.models.smpl import synthetic_smpl
    from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.renderer import render
    from hugs_tpu_torch.render.tiles import bin_gaussians

    smpl = synthetic_smpl(AVATAR_VPB, device=dev)
    template = subdivide_smpl_model(smpl, smoothing=True,
                                    n_iter=AVATAR_SUBDIV)
    params, fixed = pergs.init_human_pergs(smpl, template,
                                           torch.zeros(10, device=dev), 1)
    n = int(params.gs.n_alive)
    pose = 0.01 * torch.sin(torch.arange(69, dtype=torch.float32,
                                         device=dev))

    def forward(p, fx, device):
        return pergs.human_pergs_forward(
            p, fx, global_orient=torch.zeros(3, device=device),
            body_pose=pose.to(device), betas=torch.zeros(10, device=device),
            transl=torch.zeros(3, device=device))

    data = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                               nframes=2, device=dev)[0]
    black = torch.zeros(3, device=dev)
    with torch.no_grad():
        out = forward(params, fixed, dev)
        pg = project(data["camera"], out, out["alive"], 0)
        budget = slot_budget(int(bin_gaussians(pg, W, H, 4 * n).n_slots))
        cuda_blend.LAUNCHES = 0
        img = render(out["xyz"], out["scales"], out["rotq"], out["opacity"],
                     out["shs"], data["camera"], W, H, bg=black,
                     alive=out["alive"], instance_budget=budget)["render"]
        torch.cuda.synchronize()
        k1 = cuda_blend.LAUNCHES
        frame_ms = device_ms(lambda: render(
            *(forward(params, fixed, dev)[k] for k in (
                "xyz", "scales", "rotq", "opacity", "shs")),
            data["camera"], W, H, bg=black, alive=out["alive"],
            instance_budget=budget), reps=5)
        if k1 != 1 or not bool(torch.isfinite(img).all()) \
                or float(img.max()) <= 0:
            raise AssertionError(f"the pergs frame: {k1} K1 launches, finite"
                                 f" {bool(torch.isfinite(img).all())}")
        # the same avatar on the CPU, at a small size
        cpu = torch.device("cpu")
        cw, ch = EVAL_CPU_WH
        cp, cf = hgs.to_device(params, cpu), hgs.to_device(fixed, cpu)
        out_c = forward(cp, cf, cpu)
        worst = 0.0
        for k in ("xyz", "scales", "rotq", "opacity", "shs"):
            d = float((out[k].cpu() - out_c[k]).abs().max())
            worst = max(worst, d)
            if d > AVATAR_ATOL:
                raise AssertionError(f"pergs forward {k}: card vs CPU {d}")
        small = get_rotating_camera(img_size=(ch, cw), fov=0.95, dist=3.0,
                                    nframes=2, device=dev)[0]["camera"]
        small_c = get_rotating_camera(img_size=(ch, cw), fov=0.95, dist=3.0,
                                      nframes=2, device=cpu)[0]["camera"]
        args = ("xyz", "scales", "rotq", "opacity", "shs")
        img_k = render(*(out[k] for k in args), small, cw, ch, bg=black,
                       alive=out["alive"], instance_budget=4 * n)["render"]
        img_c = render(*(out_c[k] for k in args), small_c, cw, ch,
                       bg=black.cpu(), alive=out_c["alive"],
                       instance_budget=4 * n)["render"]
        err = held(f"(e) pergs frame at {cw}x{ch}: K1 on the card vs the "
                   f"plain blend on the CPU", img_k.cpu(), img_c)
    print(f"# (e) per-Gaussian avatar: {n} Gaussians (synthetic_smpl("
          f"{AVATAR_VPB}), {AVATAR_SUBDIV} subdivisions) at {W}x{H}: {k1} "
          f"K1 launch, a frame (forward and render) {frame_ms:.3f} ms; "
          f"card vs CPU forward max |d| {worst:.3e}  [{smi}]")
    return {"gaussians": n, "k1_launches": k1, "frame_ms": frame_ms,
            "forward_max_abs": worst, "image_max_abs": err}


def gauss_shard(dev, smi, project, slot_budget, joint, evaln, root):
    """Phase 3i, the Gaussian-sharded path on phase 3f's run (joint) and
    phase 3g's anim split (evaln): checks (a)-(e) of the module
    docstring; raises if one fails; returns its numbers."""
    t_phase = time.time()
    tr = joint["trainer"]
    out = {"frame": gauss_frame_check(dev, smi, project, slot_budget, tr,
                                      evaln["trainer"].anim_dataset[0])}
    out["steps"] = gauss_step_check(dev, smi, tr)
    del joint["trainer"], tr
    torch.cuda.empty_cache()
    out["main"] = gauss_main_check(dev, smi, root)
    out["graft_entry"] = graft_entry_check(dev, smi)
    out["pergs"] = pergs_check(dev, smi, project, slot_budget)
    out["phase_s"] = time.time() - t_phase
    print(f"# phase 3i: {out['phase_s']:.1f} s (host clock)  [{smi}]")
    return out


def gt_frame_check(name, attrs, camera, width, height, bg):
    """One ground-truth frame of a recipe through K1 against plain_blend
    on the same bins, at the frame's own slot demand: the recipes' ground
    truth is K1's render, so a fault in K1 fails here instead of becoming
    a target the model trains to. Returns the max |d|."""
    from hugs_tpu_torch.convergence import common
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import bin_gaussians
    with torch.no_grad():
        demand = common.probe_demand(*attrs, camera, width, height,
                                     active_sh_degree=0)
        pg = project_gaussians(*attrs, camera, width, height, 0)
        bins = bin_gaussians(pg, width, height, common.pages(demand))
        args = (gauss_features(pg), bins.gauss_id, bins.starts, bins.ends,
                bg, width, height)
        img = cuda_blend.blend_fwd(*args)[0]
        ref = plain_blend(*args)[0]
        torch.cuda.synchronize()
    return held(f"phase 3j {name}: ground-truth frame 0, K1 vs plain "
                f"({int(bins.n_instances):,} instances)", img, ref)


def recipe_cut(dev, smi, mod):
    """The human or joint recipe (mod: convergence.human_avatar or
    joint_scene) at full width through its own functions, its
    distillation cut to RECIPE_DISTILL steps, RECIPE_STEPS steps, the
    held-out PSNR before and after. Checks: the PSNR finite and gaining
    RECIPE_GAIN_DB, K2 launched once per render of a step (1 human, 2
    joint: the merged frame and the human alone), K1 once per render of
    a step plus the renders again at a grown budget, frame 0's ground
    truth K1 = plain. Raises if one fails; returns its numbers."""
    from hugs_tpu_torch.render import cuda_blend
    name = mod.NAME
    t0 = time.time()
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    run, demands = mod.setup(mod.SIZES, dev, distill=RECIPE_DISTILL)
    gt_k1 = cuda_blend.LAUNCHES
    p0 = mod.eval_held(run)
    gen = torch.Generator(device=dev).manual_seed(mod.SEED + 1)
    grown = run.budget_grown
    torch.cuda.synchronize()
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    t1 = time.time()
    for step in range(1, RECIPE_STEPS + 1):
        aux = mod.train_iteration(run, step,
                                  torch.rand(3, generator=gen, device=dev))
    torch.cuda.synchronize()
    train_s = time.time() - t1
    k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    retried = run.budget_grown - grown
    p1 = mod.eval_held(run)
    renders = 2 if name == "joint_scene" else 1
    print(f"# phase 3j {name}: {run.W}x{run.H}, {len(run.frames)} frames, "
          f"distillation {RECIPE_DISTILL}, {RECIPE_STEPS} steps in "
          f"{train_s:.2f} s = {RECIPE_STEPS / train_s:.2f} steps/s; held-out "
          f"PSNR {p0:.2f} -> {p1:.2f} dB; loss {float(aux['loss']):.4f}; "
          f"K1 {k1}, K2 {k2} launches; ground-truth demand "
          f"{min(demands):,}-{max(demands):,}, budget {run.budget:,} "
          f"(grown {run.budget_grown} times)  [{smi}]")
    if not (math.isfinite(p0) and math.isfinite(p1)
            and p1 - p0 >= RECIPE_GAIN_DB):
        raise AssertionError(f"phase 3j {name}: held-out PSNR {p0:.2f} -> "
                             f"{p1:.2f} dB, not a gain of {RECIPE_GAIN_DB}")
    if k2 != renders * RECIPE_STEPS or \
            k1 != renders * (RECIPE_STEPS + retried):
        raise AssertionError(f"phase 3j {name}: K1 {k1}, K2 {k2} launches "
                             f"in {RECIPE_STEPS} steps of {renders} "
                             f"render(s), {retried} rendered again")
    # frame 0's ground truth again, K1 against plain
    from hugs_tpu_torch.convergence.human_avatar import gt_splats
    from hugs_tpu_torch.models.smpl import synthetic_smpl
    smpl = synthetic_smpl(verts_per_bone=mod.VPB, device=dev)
    pose, orient = mod.gt_poses(0, len(run.frames))
    if name == "joint_scene":
        room = mod.room_splats(*mod.scene_points(
            np.random.RandomState(0), mod.SIZES["N_SPHERE"],
            mod.SIZES["N_FLOOR"]), dev)
        attrs = mod.gt_attrs(smpl, gt_splats(smpl), room, pose, orient)[0]
    else:
        attrs = mod.gt_attrs(smpl, gt_splats(smpl), pose, orient)
    fr = run.frames[0]
    bg = torch.full((3,), mod.BG if name == "joint_scene" else 0.0,
                    device=dev)
    err = gt_frame_check(name, attrs, fr["camera"], run.W, run.H, bg)
    return {"steps_per_s": RECIPE_STEPS / train_s, "train_s": train_s,
            "psnr": [p0, p1], "k1_launches": gt_k1 + k1, "k2_launches": k2,
            "gt_k1_launches": gt_k1, "k1_err": err,
            "phase_s": time.time() - t0}


def surface_cut(dev, smi):
    """The surface recipe (convergence.surface_scene) at full width for
    SURFACE_STEPS steps through GaussianTrainer, the budget automatic,
    validated at the end. Checks: no overflow persisted past a retry,
    every logged loss and the held-out PSNR finite, K2 once per step
    (steps 0 .. SURFACE_STEPS), view 0's ground truth K1 = plain. Raises
    if one fails; returns its numbers."""
    from hugs_tpu_torch.convergence import surface_scene as ss
    from hugs_tpu_torch.render import cuda_blend
    t0 = time.time()
    sz = dict(ss.SIZES, VAL_EVERY=SURFACE_STEPS)
    gt = ss.gt_surface_scene()
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    frames, demands = ss.build_gt(gt, sz["W"], sz["H"], sz["VIEWS"], dev)
    gt_k1 = cuda_blend.LAUNCHES
    with tempfile.TemporaryDirectory(prefix="surface_") as logdir:
        tr = ss.build_trainer(frames, gt[0], sz, SURFACE_STEPS, logdir, dev)
        budget0 = tr._ibudget
        torch.cuda.synchronize()
        cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
        t1 = time.time()
        log = tr.train()
        torch.cuda.synchronize()
        train_s = time.time() - t1
        k1, k2 = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    curve = ss.curve_of(tr, tr.eval_metrics[f"{SURFACE_STEPS:06d}"],
                        SURFACE_STEPS)
    psnr = curve[-1]["psnr_held"]
    losses = [r["loss"] for r in log]
    print(f"# phase 3j surface_scene: {sz['W']}x{sz['H']}, "
          f"{len(frames)} views, {SURFACE_STEPS} steps (with a validation) "
          f"in {train_s:.2f} s = {SURFACE_STEPS / train_s:.2f} steps/s; "
          f"held-out PSNR {psnr} dB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; budget {budget0:,} -> {tr._ibudget:,}, "
          f"{tr.retries} steps rendered again, {tr.overflow_persisted} "
          f"overflowed at every attempt; {int(tr.scene.gs.n_alive):,} "
          f"alive; K1 {k1}, K2 {k2} launches; ground-truth demand "
          f"{min(demands):,}-{max(demands):,}  [{smi}]")
    if tr.overflow_persisted or not all(map(math.isfinite, losses)) \
            or not math.isfinite(psnr):
        raise AssertionError(f"phase 3j surface_scene: overflow persisted "
                             f"{tr.overflow_persisted} times, losses "
                             f"{losses}, PSNR {psnr}")
    if k2 != SURFACE_STEPS + 1:
        raise AssertionError(f"phase 3j surface_scene: {k2} K2 launches in "
                             f"{SURFACE_STEPS + 1} steps")
    g = tuple(torch.as_tensor(a, device=dev) for a in gt)
    err = gt_frame_check("surface_scene", g, frames[0]["camera"], sz["W"],
                         sz["H"], torch.zeros(3, device=dev))
    return {"steps_per_s": SURFACE_STEPS / train_s, "train_s": train_s,
            "psnr": psnr, "losses": [losses[0], losses[-1]],
            "budget": [budget0, tr._ibudget], "retries": tr.retries,
            "overflow_persisted": tr.overflow_persisted,
            "alive": int(tr.scene.gs.n_alive), "k1_launches": gt_k1 + k1,
            "k2_launches": k2, "gt_k1_launches": gt_k1, "k1_err": err,
            "phase_s": time.time() - t0}


def convergence_recipes(dev, smi):
    """Phase 3j: (a) micro/kernel_parity.py's five scenes through K1 and
    K2 against plain (comparison launches, not counted for a path); (b)
    the human and joint recipes cut (recipe_cut); (c) the surface recipe
    cut (surface_cut). Raises if a check fails; returns the numbers."""
    from hugs_tpu_torch.convergence import human_avatar, joint_scene
    from hugs_tpu_torch.micro import kernel_parity
    t0 = time.time()
    cases, ok = kernel_parity.run_all(dev)
    for c in cases:
        print(f"# phase 3j kernel parity {c['case']}: {c['W']}x{c['H']}, "
              f"{c['n']} Gaussians, {c['n_instances']:,} instances (budget "
              f"{c['budget']:,}, demand {c['n_slots']:,}), densest tile "
              f"{c['max_instances_per_tile']} = {c['max_chunks_per_tile']} "
              f"batches, {c['empty_tiles']} empty tiles; image max |d| "
              f"{c['max_abs_dimg']:.3e}, gradients max rel "
              f"{max(c['rel_dgrad'].values()):.3e}; K1 {c.get('k1')}; K2 "
              f"{c.get('k2')}")
    if not ok:
        raise AssertionError("phase 3j: the kernel-parity scenes disagree")
    out = {"kernel_parity": cases,
           human_avatar.NAME: recipe_cut(dev, smi, human_avatar),
           joint_scene.NAME: recipe_cut(dev, smi, joint_scene),
           "surface_scene": surface_cut(dev, smi)}
    out["phase_s"] = time.time() - t0
    print(f"# phase 3j: {out['phase_s']:.1f} s (host clock); steps/s: "
          + ", ".join(f"{k} {out[k]['steps_per_s']:.2f}" for k in (
              "human_avatar", "joint_scene", "surface_scene"))
          + f"  [{smi}]")
    return out


def cutoff_report(name, feat, b, width, height, pix, mxu_raw, plain_raw,
                  top=10):
    """Phase 3k (a): the pixels where the mode's K1 and its plain version
    differ beyond PIXEL_ATOL, and in each the pairs that sit at one of the
    mode's cutoffs in the plain version (alpha within 1e-5 of 1/255, or
    the power within 1e-6 of POW_EPS): a flip there follows from the
    order of the product's float32 sums. Prints up to `top` pixels with
    each such pair's power (the plain product's and the exact quadratic);
    returns the count of pixels beyond PIXEL_ATOL and of those with such
    a pair."""
    from hugs_tpu_torch.render.blend import (
        POW_EPS, alpha_mxu, grid_basis, power_mxu,
    )
    from hugs_tpu_torch.render.oracle import MIN_ALPHA
    from hugs_tpu_torch.render.tiles import TILE, tile_grid
    bad = torch.nonzero((mxu_raw - plain_raw).abs().amax(0) > PIXEL_ATOL)
    nx = tile_grid(width, height, TILE)[0]
    at_cutoff = 0
    basis = grid_basis(TILE, feat.device)
    for n, (y, x) in enumerate(bad.tolist()):
        t = (y // TILE) * nx + x // TILE
        s0, s1 = int(b.starts[t]), int(b.ends[t])
        f = feat[b.gauss_id[s0:s1].long()]
        tx0, ty0 = float(x // TILE * TILE), float(y // TILE * TILE)
        p = (y % TILE) * TILE + x % TILE
        power = power_mxu(f, tx0, ty0, basis)[:, p:p + 1]
        px = torch.full((1, 1), float(x), device=feat.device)
        py = torch.full((1, 1), float(y), device=feat.device)
        a = alpha_mxu(f, f[:, 3], px, py, power)[:, 0]
        dx, dy = f[:, 4] - x, f[:, 5] - y
        exact = -0.5 * (f[:, 6] * dx * dx + f[:, 8] * dy * dy) \
            - f[:, 7] * dx * dy
        full = torch.clamp(f[:, 3] * torch.exp(torch.clamp(
            power[:, 0], max=0.0)), max=0.99)
        near = ((full - MIN_ALPHA).abs() <= 1e-5) \
            | ((power[:, 0] - POW_EPS).abs() <= 1e-6)
        idx = torch.nonzero(near)[:, 0]
        at_cutoff += int(idx.numel() > 0)
        if n < top:
            print(f"#   {name} pixel ({x}, {y}): |d| "
                  f"{float((mxu_raw - plain_raw)[:, y, x].abs().max()):.3e};"
                  f" pairs at a cutoff: " + (", ".join(
                      f"slot {int(i)} power {float(power[i, 0]):.9g} (exact"
                      f" {float(exact[i]):.9g}) alpha {float(a[i]):.9g}"
                      for i in idx[:4]) or "none"))
    print(f"# phase 3k (a) {name}: {bad.shape[0]} of {pix} pixels beyond "
          f"{PIXEL_ATOL}, {at_cutoff} of them with a pair at a cutoff")
    return bad.shape[0], at_cutoff


def mxu_work(feat, b, width, height, pairs, n_walked, cull, work):
    """What K1 and K2 in the POWER_MXU mode must do for one frame: the
    float operations left (OPS_TESTED_MXU per kept pair, the cull, the
    blended pairs as blend_work counts them, OPS_RECORD per staged
    instance), the product's tensor-core flops (MXU_PAIR_FLOPS per kept
    (warp, instance) pair within the warp's walk, both kernels), and the
    exact kernels' bytes (blend_work's). Beside the bound, not in it, the
    design's own products (micro.mxu_groups): its groups, the mma they
    issue, the share of their columns filled and of groups that one k step
    would cover. Returns {"k1" / "k2": {"ops", "tc_flops", "bytes", "ops_ms",
    "tc_ms", "bytes_ms", "bound_ms", "bound_by", "groups", "mma",
    "fill", "one_step"}}."""
    from hugs_tpu_torch.micro import mxu_groups
    tested, blended = (int(x) for x in pairs.sum(dim=(1, 2)))
    groups = mxu_groups(feat, b, n_walked, width, height)
    kept = cull["tested"]
    out = {}
    for k, ops in (
            ("k1", OPS_TESTED_MXU * kept + OPS_CULL * cull["K1"]
             + OPS_BLENDED * blended + OPS_RECORD * groups["K1_staged"]),
            ("k2", OPS_TESTED_MXU * kept + OPS_CULL * cull["K2"]
             + OPS_WARP_SUM * cull["K2_kept"] + OPS_BWD_BLENDED * blended
             + OPS_RECORD * groups["K2_staged"])):
        tc = MXU_PAIR_FLOPS * cull["K2_kept"]
        nbytes = work[k][2]
        ms = {"ops_ms": ops / PEAK_FP32 * 1e3, "tc_ms": tc / PEAK_BF16_TC
              * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3}
        by = max(ms, key=ms.get)
        K = k.upper()
        out[k] = {"ops": ops, "tc_flops": tc, "bytes": nbytes,
                  "kept": cull["K2_kept"], **ms, "bound_ms": ms[by],
                  "bound_by": "bytes" if by == "bytes_ms" else "operations",
                  "bound_term": by, "groups": groups[K],
                  "mma": groups[K + "_mma"], "fill": groups[K + "_fill"],
                  "one_step": groups[K + "_one_step"]}
    return out


def power_mxu_phase(dev, smi, ctx, blendmix_rate):
    """Phase 3k, the POWER_MXU mode (K1 and K2 with the exponent on the
    tensor cores): (a) each kernel against the plain mode on phase 2's
    serving frame and phase 3b's step-0 training frame, with the pixels
    beyond the image bar and the pairs at a cutoff printed; (b) the mode
    against the exact kernels; (c) both modes' device ms in turns, each
    mode's bound and its share, the float operations left over S2's
    blendmix rate, registers, shared memory and blocks per SM, and the
    warp cull's misses in the mode (micro.mxu_cull_misses); (d) the
    user's path with the mode as render()'s default (cuda_blend.
    POWER_MXU, restored after): phase 3's 4 serving views through
    render_human_scene and MXU_STEPS scene_train_step calls of phase 3b's
    recipe against the same steps in the exact mode, the launches counted
    per mode; (e) micro/kernel_parity.py's five scenes in both modes.
    Raises if a check fails; returns the numbers."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch.micro import kernel_parity, mxu_cull_misses
    from hugs_tpu_torch.models.scene_gs import create_from_pcd, scene_forward
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import plain_blend, plain_blend_bwd
    from hugs_tpu_torch.render.renderer import render_human_scene
    from hugs_tpu_torch.train.scene_step import (
        init_scene_train_state, scene_train_step,
    )
    t_phase = time.time()
    out = {"frames": {}}
    print(f"# phase 3k: the POWER_MXU mode  [{smi}]")
    for frame, (feat, b, bg, g, pairs, cull) in ctx["frames"].items():
        args = (feat, b.gauss_id, b.starts, b.ends, bg, W, H)
        # (a) each kernel against the plain mode
        img_m, logt_m, nw_m, _ = cuda_blend.blend_fwd(*args, True)
        ref_m, _, pairs_m = plain_blend(*args, power_mxu=True)
        torch.cuda.synchronize()
        # the image bar is K1's share; a pixel where a pair at the 1/255
        # cutoff flips moves by up to 1/255 of its colour, so no bar on
        # the largest difference (cutoff_report prints each)
        d = (img_m - ref_m).abs().amax(0)
        share = float((d <= PIXEL_ATOL).float().mean())
        rec = {"k1_max_abs": float(d.max()), "k1_share": share}
        print(f"# phase 3k (a) K1 mode vs plain mode, {frame}: "
              f"{share * 100:.4f}% of pixels within {PIXEL_ATOL} (bar "
              f"{MIN_SHARE * 100:.2f}%), max |d| {rec['k1_max_abs']:.3e}")
        if share < MIN_SHARE:
            raise AssertionError(f"phase 3k (a) {frame}: K1 in the mode "
                                 f"disagrees with the plain mode")
        rec["pixels_beyond"], rec["pixels_at_cutoff"] = cutoff_report(
            frame, feat, b, W, H, W * H, img_m, ref_m)
        rec["n_walked_share"] = float((nw_m.long() == pairs_m[0]).float()
                                      .mean())
        gf_m, gb_m = cuda_blend.blend_bwd(*args, g, logt_m, nw_m, True)
        gf_p, gb_p = plain_blend_bwd(*args, g, True)
        ref64 = None
        if frame == "training":
            ref64 = plain_blend_bwd(feat.double(), *args[1:4], bg.double(),
                                    W, H, g.double(), True)[0][:, :9]
        rec["k2_max_abs"] = held_grad(f"phase 3k (a) K2 mode vs plain mode,"
                                      f" {frame}", gf_m[:, :9], gf_p[:, :9],
                                      ref64)
        # grad_bg sums g T_fin over the pixels, and a flip at a cutoff
        # moves a pixel's T_fin by 1/255 of it: held at the mode's own
        # relative gradient bar (kernel_parity_tpu.py:133), not BG_RTOL
        bg_rel = float(((gb_m - gb_p).abs() / gb_p.abs().clamp(
            min=1e-30)).max())
        rec["bg_rel"] = bg_rel
        print(f"# phase 3k (a) K2 mode grad_bg, {frame}: {gb_m.tolist()} vs "
              f"plain mode {gb_p.tolist()}, max relative {bg_rel:.3e} (bar "
              f"{kernel_parity.GRAD_BAR})")
        if float(gf_m[:, 9].abs().max()) != 0.0 \
                or bg_rel > kernel_parity.GRAD_BAR:
            raise AssertionError(f"phase 3k (a) {frame}: K2's radius "
                                 f"column or grad_bg ({bg_rel:.3e}) is off")
        # (b) the mode against the exact kernels
        img_e, logt_e, nw_e, _ = cuda_blend.blend_fwd(*args)
        d = (img_m - img_e).abs().amax(0)
        rec["vs_exact_max_abs"] = float(d.max())
        rec["vs_exact_share"] = float((d <= PIXEL_ATOL).float().mean())
        print(f"# phase 3k (b) {frame}: K1 mode vs K1 exact, raw image max "
              f"|d| {rec['vs_exact_max_abs']:.3e}, "
              f"{rec['vs_exact_share'] * 100:.4f}% of pixels within "
              f"{PIXEL_ATOL}")
        # (c) device ms, the modes in turns (exact, mode, mode, exact)
        fns = {"k1": (lambda: cuda_blend.blend_fwd(*args),
                      lambda: cuda_blend.blend_fwd(*args, True)),
               "k2": (lambda: cuda_blend.blend_bwd(*args, g, logt_e, nw_e),
                      lambda: cuda_blend.blend_bwd(*args, g, logt_m, nw_m,
                                                   True))}
        for k, (exact_fn, mode_fn) in fns.items():
            ms = [device_ms(f, inner=BACK_TO_BACK)
                  for f in (exact_fn, mode_fn, mode_fn, exact_fn)]
            rec[k + "_exact_ms"] = [ms[0], ms[3]]
            rec[k + "_mxu_ms"] = [ms[1], ms[2]]
            # one call alone, the wrapper's host cost included
            rec[k + "_mxu_call_ms"] = device_ms(mode_fn)
        rec["plain_mxu_ms"] = device_ms(
            lambda: plain_blend(*args, power_mxu=True), reps=5, warmup=1)
        rec["plain_bwd_mxu_ms"] = device_ms(
            lambda: plain_blend_bwd(*args, g, True), reps=5, warmup=1)
        work = blend_work(feat, b, W, H, pairs, cull)[0]
        cull_m = warp_cull_counts(feat, b, nw_m, W, H)
        bound = mxu_work(feat, b, W, H, pairs_m, nw_m, cull_m, work)
        for k in ("k1", "k2"):
            bd = bound[k]
            mode_ms = statistics.median(rec[k + "_mxu_ms"])
            exact_ms = statistics.median(rec[k + "_exact_ms"])
            bd["at_s2_ms"] = bd["ops"] / blendmix_rate * 1e3
            rec[k + "_bound"] = bd
            print(f"# phase 3k (c) {frame} {k.upper()}: exact "
                  f"{rec[k + '_exact_ms'][0]:.4f} / "
                  f"{rec[k + '_exact_ms'][1]:.4f} ms, mode "
                  f"{rec[k + '_mxu_ms'][0]:.4f} / {rec[k + '_mxu_ms'][1]:.4f}"
                  f" ms ({(mode_ms / exact_ms - 1) * 100:+.1f}%), one call "
                  f"{rec[k + '_mxu_call_ms']:.4f} ms; the mode's "
                  f"bound: {bd['ops']:.4e} float ops / 67 TFLOP/s = "
                  f"{bd['ops_ms']:.5f} ms, {bd['kept']} kept (warp, "
                  f"instance) x {MXU_PAIR_FLOPS} = {bd['tc_flops']:.4e} "
                  f"tensor-core flops / 989 TFLOP/s = {bd['tc_ms']:.5f} ms, "
                  f"{bd['bytes']} bytes = "
                  f"{bd['bytes_ms']:.5f} ms, so {bd['bound_ms']:.5f} ms by "
                  f"{bd['bound_term']} ({bd['bound_ms'] / mode_ms * 100:.1f}% "
                  f"of its time); float ops at S2's blendmix rate "
                  f"{bd['at_s2_ms']:.5f} ms "
                  f"({bd['at_s2_ms'] / mode_ms * 100:.1f}% of its time); the"
                  f" design's products: {bd['groups']} groups, {bd['mma']} "
                  f"mma ({bd['mma'] * MMA_FLOPS / bd['tc_flops']:.2f}x the "
                  f"product's flops), {bd['fill'] * 100:.1f}% of columns "
                  f"filled, {bd['one_step'] * 100:.1f}% of groups within one"
                  f" row of grid points  [{smi}]")
        print(f"# phase 3k (c) {frame}: plain mode {rec['plain_mxu_ms']:.4f}"
              f" ms, its backward {rec['plain_bwd_mxu_ms']:.4f} ms")
        rec["cull"] = mxu_cull_misses(feat, b, nw_m, W, H)
        print(f"# phase 3k (c) {frame}: the warp cull drops "
              f"{rec['cull']['dropped']} (warp, instance) pairs of the "
              f"mode's K1 walk; {rec['cull']['missed']} of them reach alpha"
              f" 1/255 in the plain mode at a pixel of the warp (largest "
              f"alpha among the dropped {rec['cull']['max_alpha']:.3e})")
        if rec["cull"]["missed"]:
            raise AssertionError(f"phase 3k {frame}: the warp cull drops "
                                 f"pairs the mode keeps")
        out["frames"][frame] = rec
    res = cuda_blend.mxu_blocks_per_sm()
    for k, entry in (("K1", "blend_fwd_mxu_kernel"),
                     ("K2", "blend_bwd_mxu_kernel")):
        source = cuda_blend.SOURCE if k == "K1" else cuda_blend.BWD_SOURCE
        res[k].update(build.kernel_resources(build.build_logs[source], entry))
        r = res[k]
        print(f"# phase 3k (c) {k} {entry}: {r['registers']} registers, "
              f"{r['smem_bytes']} B static + {r['dynamic_smem_bytes']} B "
              f"dynamic shared memory, {r['spill_bytes']} B spill stores, "
              f"{r['blocks_per_sm']} resident blocks per SM")
    out["resources"] = res

    # (d) the user's path with the mode as the default
    serve, tr = ctx["serve"], ctx["train"]
    saved = cuda_blend.POWER_MXU
    losses = {}
    try:
        for mode in (False, True):
            cuda_blend.POWER_MXU = mode
            cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
            cuda_blend.MXU_LAUNCHES = cuda_blend.K2_MXU_LAUNCHES = 0
            if mode:
                with torch.no_grad():
                    a = scene_forward(serve["gs"])
                    for i, cam in enumerate(serve["cams"]):
                        pkg = render_human_scene(
                            {"camera": cam, "width": W, "height": H}, None, a,
                            serve["bg"], render_mode="scene",
                            instance_budget=serve["budget"])
                        img = pkg["render"]
                        if bool(pkg["overflowed"]) or not bool(
                                torch.isfinite(img).all()):
                            raise AssertionError(f"phase 3k (d): request {i}"
                                                 f" overflowed or not finite")
                        if i == 0:
                            out["serve_vs_exact"] = float(
                                (img - serve["image0"]).abs().max())
                serve_k1 = cuda_blend.MXU_LAUNCHES
            state = init_scene_train_state(create_from_pcd(
                tr["noisy"], np.full((N_GAUSS, 3), 0.5, np.float32),
                CAPACITY, device=dev))
            losses[mode] = []
            for step in range(MXU_STEPS):
                i = step % len(tr["cams"])
                state, aux = scene_train_step(
                    state, tr["cams"][i], tr["targets"][i], tr["bg"],
                    tr["xyz_sched"](step), tr["lrs"], width=W, height=H,
                    instance_budget=tr["budget"])
                if bool(aux["overflowed"]):
                    raise AssertionError(f"phase 3k (d) step {step} "
                                         f"overflowed")
                losses[mode].append(float(aux["loss"]))
            torch.cuda.synchronize()
            counts = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES,
                      cuda_blend.MXU_LAUNCHES, cuda_blend.K2_MXU_LAUNCHES)
            want = ((0, 0, len(serve["cams"]) + MXU_STEPS, MXU_STEPS) if mode
                    else (MXU_STEPS, MXU_STEPS, 0, 0))
            print(f"# phase 3k (d) mode {mode}: K1, K2, K1 mode, K2 mode "
                  f"launches {counts} (want {want})")
            if counts != want:
                raise AssertionError("phase 3k (d): launches off")
    finally:
        cuda_blend.POWER_MXU = saved
    rel = [abs(m - e) / abs(e) for e, m in zip(losses[False], losses[True])]
    print("# phase 3k (d): loss by step, exact / mode: " + " ".join(
        f"{e:.6f}/{m:.6f}" for e, m in zip(losses[False], losses[True]))
        + f"; max relative difference {max(rel):.3e} (bar "
        f"{MXU_LOSS_RTOL}); serving request 0 vs phase 3's exact image max "
        f"|d| {out['serve_vs_exact']:.3e}")
    if not (np.isfinite(losses[True]).all() and max(rel) <= MXU_LOSS_RTOL):
        raise AssertionError("phase 3k (d): the mode's losses are off")
    out.update(losses=losses, loss_rel=max(rel), k1_launches=serve_k1
               + MXU_STEPS, serve_k1=serve_k1, k2_launches=MXU_STEPS)

    # (e) the kernel-parity scenes in both modes
    cases, ok = kernel_parity.run_all(dev, modes=(False, True))
    for c in cases:
        print(f"# phase 3k (e) kernel parity {c['case']} power_mxu "
              f"{c['power_mxu']}: image max |d| {c['max_abs_dimg']:.3e} "
              f"(bar {kernel_parity.IMG_BAR}), gradients max rel "
              f"{max(c['rel_dgrad'].values()):.3e} (bar "
              f"{kernel_parity.GRAD_BAR}); K1 {c.get('k1')}; K2 "
              f"{c.get('k2')}")
    if not ok:
        raise AssertionError("phase 3k (e): a kernel-parity case failed")
    out["kernel_parity"] = cases
    out["phase_s"] = time.time() - t_phase
    print(f"# phase 3k: {out['phase_s']:.1f} s (host clock)")
    return out


def micro_benchmarks(dev, smi, cull_counts):
    """Phase 3d, the three micro-benchmarks through their entry points'
    functions at the scripts' full sizes (see the module docstring), each
    kernel then held to its plain version. Raises if a check fails;
    returns their entries for the kernels line, the launches of S3's
    run (K1's and K2's among them) and S2's blendmix rate (op/s)."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch.micro import micro_bf16, micro_bwd, vpu_peak
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import _disassemble, plain_blend

    # ---- S2: the rates, then each mode against plain at S2_CHECK_GRID
    vpu_peak.LAUNCHES = 0
    s2 = vpu_peak.measure(dev, vpu_peak.GRID, vpu_peak.INNER,
                          vpu_peak.REPS)
    s2_launches = vpu_peak.LAUNCHES
    ffma = s2["ffma_per_step"]
    print(f"# S2 vpu_peak: ({vpu_peak.P}, {vpu_peak.CHUNK}) f32, grid "
          f"{s2['grid']}, inner {s2['inner']}, reps {s2['reps']}; "
          f"{s2_launches} launches; FFMA in fma's SASS per grid step "
          f"{ffma['fma']} (INNER x 4 = {ffma['expected']})  [{smi}]")
    for mode in vpu_peak.MODES:
        r = s2[mode]
        print(f"#   S2 {mode}: {r['s_per_rep'] * 1e3:.4f} ms per call, "
              f"{r['tera_ops_per_s']:.3f} T op/s "
              f"({vpu_peak.ops_per_elem(mode, s2['inner'])} ops per "
              f"element-step), "
              f"{r['share_of_peak_fp32'] * 100:.1f}% of 67 TFLOP/s")
    if ffma["fma"] != ffma["expected"]:
        raise AssertionError("S2's fma chains were not compiled as "
                             "INNER x 4 FFMA per step")
    if s2_launches < len(vpu_peak.MODES) * vpu_peak.REPS:
        raise AssertionError(f"S2 launched {s2_launches} times")
    x = vpu_peak.start_block(dev)
    s2_modes, s2_err = {}, 0.0
    for mode in vpu_peak.MODES:
        args = (mode, S2_CHECK_GRID, vpu_peak.INNER, vpu_peak.REPS)
        got = vpu_peak.run(x, *args)
        want = x
        for _ in range(vpu_peak.REPS):
            want = vpu_peak.plain_call(want, *args[:3])
        d = float((got - want).abs().max())
        bar = S2_RTOL * float(want.abs().max())
        print(f"#   S2 {mode} kernel vs plain, grid {S2_CHECK_GRID}, inner "
              f"{vpu_peak.INNER}, reps {vpu_peak.REPS}: max |d| {d:.3e} "
              f"(bar {bar:.3e}, {S2_RTOL} of max |plain|)")
        if not d <= bar:
            raise AssertionError(f"S2 {mode} disagrees with its plain version")
        s2_err = max(s2_err, d)
        ops = vpu_peak.ops_per_elem(mode, s2["inner"]) * x.numel() \
            * s2["grid"]
        s2_modes[mode] = dict(
            s2[mode], ms=s2[mode]["s_per_rep"] * 1e3,
            bound_ms=ops / PEAK_FP32 * 1e3, max_abs_err=d,
            check_ms=device_ms(lambda a=args: vpu_peak.run(x, *a), reps=5,
                               warmup=1) / vpu_peak.REPS,
            plain_ms=device_ms(lambda a=args: vpu_peak.plain_call(
                x, *a[:3]), reps=3, warmup=1))
    blendmix_rate = s2["blendmix"]["tera_ops_per_s"] * 1e12

    # ---- S1: the rates and r_scaling, then each against plain at
    # S1_CHECK_R passes, S1_CHECK_K calls, from a start that moves
    micro_bf16.LAUNCHES = 0
    s1 = micro_bf16.measure(dev, micro_bf16.RS, micro_bf16.K)
    s1_launches = micro_bf16.LAUNCHES
    print(f"# S1 micro_bf16: ({micro_bf16.P}, {micro_bf16.C}), K "
          f"{s1['K']}, r {s1['rs']}; {s1_launches} launches  [{smi}]")
    c = torch.tensor([[micro_bf16.C_VALUE]], device=dev)
    x1 = torch.linspace(-2.0, 3.0, micro_bf16.P * micro_bf16.C,
                        device=dev).reshape(micro_bf16.P, micro_bf16.C)
    s1_modes, s1_err = {}, 0.0
    for op in micro_bf16.OPS:
        for name, dtype in micro_bf16.DTYPES.items():
            key = f"{op}_{name}"
            r = s1[key]
            print(f"#   S1 {key}: " + ", ".join(
                f"r {rr}: {v['ms_per_call']:.4f} ms per call, "
                f"{v['gop_s']:.1f} Gop/s" for rr, v in r["per_r"].items())
                + f"; r_scaling {r['r_scaling']:.3f}")
            if not R_SCALING[0] <= r["r_scaling"] <= R_SCALING[1]:
                raise AssertionError(f"S1 {key}: r_scaling {r['r_scaling']}"
                                     f" outside {R_SCALING}")
            xs = x1.to(dtype)
            got = micro_bf16.block(c, xs, op, S1_CHECK_R, S1_CHECK_K)
            want = xs
            for _ in range(S1_CHECK_K):
                want = micro_bf16.plain_passes(c, want, op, S1_CHECK_R)
            got, want = got.float(), want.float()
            d = (got - want).abs()
            if name == "float32":
                bar = "rtol 1e-6"
                ok = bool((d <= 1e-6 * want.abs()).all())
            else:   # one bf16 ulp: 8 significant bits
                bar = "one bf16 ulp"
                ulp = torch.exp2(torch.floor(torch.log2(
                    want.abs().clamp(min=2.0 ** -126))) - 7)
                ok = bool((d <= ulp).all())
            moved = float((want - xs.float()).abs().max())
            print(f"#   S1 {key} kernel vs plain, r {S1_CHECK_R}, K "
                  f"{S1_CHECK_K}, linspace start: max |d| {float(d.max()):.3e}"
                  f" ({bar}); the block moved by up to {moved:.3e}")
            if not ok or moved == 0.0:
                raise AssertionError(f"S1 {key} disagrees with its plain "
                                     f"version, or did not move")
            s1_err = max(s1_err, float(d.max()))
            # one pass is one FMA (2 ops) for float32 madd, a multiply and
            # an add for bf16 madd, an exp (as one) and an add for exp; bf16
            # at twice the fp32 rate (two lanes per bf16x2 instruction)
            peak = PEAK_FP32 * (2 if name == "bfloat16" else 1)
            ops = 2 * xs.numel() * micro_bf16.RS[-1]
            s1_modes[key] = dict(
                {k: v for k, v in r.items() if k != "per_r"},
                per_r={str(k): v for k, v in r["per_r"].items()},
                ms=r["ms_per_call"], bound_ms=ops / peak * 1e3,
                max_abs_err=float(d.max()),
                check_ms=device_ms(lambda a=(xs, op): micro_bf16.passes(
                    c, *a, S1_CHECK_R), reps=5, warmup=1),
                plain_ms=device_ms(lambda a=(xs, op): micro_bf16.plain_passes(
                    c, *a, S1_CHECK_R), reps=3, warmup=1))
    for op in micro_bf16.OPS:
        print(f"#   S1 {op}: bf16 / f32 = {s1[f'{op}_bf16_speedup']:.3f}")
    # the bounds per pipe, at the SM clock each mode runs at
    pipe_bounds(dev, smi, s2_modes, s1_modes)

    # ---- S3: K2's skeleton variants on bench.py's frame
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    for mode in cuda_blend.SKELETON_MODES:
        cuda_blend.SKELETON_LAUNCHES[mode] = 0
    fr = micro_bwd.frame(dev, N_GAUSS, W, H, SEED)
    s3 = micro_bwd.measure(fr)
    s3_launches = dict(cuda_blend.SKELETON_LAUNCHES, K1=cuda_blend.LAUNCHES,
                       K2=cuda_blend.K2_LAUNCHES)
    b = fr["bins"]
    print(f"# S3 micro_bwd: {s3['gaussians']} Gaussians, {W}x{H}, "
          f"{s3['instances']} instances in {s3['slots']} slots, "
          f"{s3['pairs_walked']} pairs walked, g = ones; launches "
          f"{s3_launches}  [{smi}]")
    if min(s3_launches.values()) == 0:
        raise AssertionError("an S3 variant was not launched")
    k2_blocks = s3["variants"]["full"]["blocks_per_sm"]
    for mode in micro_bwd.TIMED:
        v = s3["variants"][mode]
        pad = (f", {v['pad_bytes']} B of unused shared memory"
               if "pad_bytes" in v else "")
        print(f"#   S3 {mode}: {v['ms']:.4f} ms, "
              f"{v['share_of_full'] * 100:.1f}% of full (K2), "
              f"{v['blocks_per_sm']} blocks per SM{pad}")
        if v["blocks_per_sm"] != k2_blocks:
            raise AssertionError(f"S3 {mode} ran {v['blocks_per_sm']} blocks"
                                 f" per SM, K2 {k2_blocks}")
    args = (fr["feat"], b.gauss_id, b.starts, b.ends, fr["bg"], W, H,
            fr["grad"], fr["log_t"], fr["n_walked"])
    s3_err = 0.0
    for mode in micro_bwd.VARIANTS:
        got, got_bg = micro_bwd.variant(mode, fr)
        want, want_bg = micro_bwd.plain_variant(mode, *args)
        torch.cuda.synchronize()
        if got.dim() == 2 and got.shape[1] == 10:
            err = held_grad(f"S3 {mode} grad_feat vs plain", got[:, :9],
                            want[:, :9])
            if float(got[:, 9].abs().max()) != 0.0:
                raise AssertionError(f"S3 {mode} wrote column 9")
        else:   # a fixed-order sum per pixel, atomics of 8 warps per tile
            d = (got - want).abs()
            err = float(d.max())
            bar = S3_RTOL * want.abs() + S3_RTOL * float(want.abs().max())
            print(f"# S3 {mode} {tuple(got.shape)} vs plain: max |d| "
                  f"{err:.3e}, max |plain| {float(want.abs().max()):.3e} "
                  f"(bar {S3_RTOL} |plain| + {S3_RTOL} max |plain|)")
            if not bool((d <= bar).all()):
                raise AssertionError(f"S3 {mode} disagrees with plain")
        bg_rel = float(((got_bg - want_bg).abs()
                        / want_bg.abs().clamp(min=1e-30)).max())
        if bg_rel > BG_RTOL:
            raise AssertionError(f"S3 {mode} grad_bg disagrees ({bg_rel})")
        s3_err = max(s3_err, err)
        s3["variants"][mode]["max_abs_err"] = err
        s3["variants"][mode]["plain_ms"] = device_ms(
            lambda m=mode: micro_bwd.plain_variant(m, *args), reps=3,
            warmup=1)
    # bounds from the counts this frame needs: the cull's (tested kept
    # pairs, culled and kept (warp, instance)s), the walk, the blend
    cull = cull_counts("S3's frame", fr["feat"], b, fr["n_walked"])
    _, _, pairs = plain_blend(fr["feat"], b.gauss_id, b.starts, b.ends,
                              fr["bg"], W, H)
    walked, blended = (int(v) for v in pairs.sum(dim=(1, 2)))
    n_inst, n_tiles = s3["instances"], b.starts.shape[0]
    staged = int(_disassemble(fr["n_walked"][None], 16)[:, 0].amax(1).sum())
    # each pair of a skeleton: 9 multiplies and 9 adds to sum them
    ops = {"skeleton": OPS_SKEL * cull["tested"] + OPS_CULL * cull["K2"]
           + OPS_WARP_SUM * cull["K2_kept"],
           "skeleton_no_cull": OPS_SKEL * walked + OPS_WARP_SUM * cull["K2"],
           "skeleton_no_shuffle": OPS_SKEL * cull["tested"]
           + OPS_CULL * cull["K2"],
           "staging_only": 10 * staged,
           "full": OPS_TESTED * cull["tested"] + OPS_CULL * cull["K2"]
           + OPS_WARP_SUM * cull["K2_kept"] + OPS_BWD_BLENDED * blended}
    n_feat = fr["feat"].numel() * 4
    inputs = n_feat + n_inst * 4 + n_tiles * 4 + 12 + 5 * W * H * 4
    outs = {"skeleton_no_shuffle": W * H * 4, "staging_only": n_tiles * 4}
    for mode, n_ops in ops.items():
        v = s3["variants"][mode]
        ops_ms = n_ops / PEAK_FP32 * 1e3
        bytes_ms = (inputs + outs.get(mode, n_feat) + 12) / PEAK_BYTES * 1e3
        v.update(ops=n_ops, bound_ms=max(ops_ms, bytes_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        print(f"#   S3 {mode}: bound {v['bound_ms']:.5f} ms by "
              f"{v['bound_by']} ({v['bound_ms'] / v['ms'] * 100:.1f}% of "
              f"its time), plain {v['plain_ms']:.4f} ms")
    log = build.build_logs[cuda_blend.BWD_SOURCE]
    for i, mode in enumerate(cuda_blend.SKELETON_MODES, 1):
        s3["variants"][mode].update(build.kernel_resources(
            log, f"blend_bwd_skeleton_kernelILi{i}E"))
    entries = [{
        "name": "S2 vpu_peak", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/vpu_peak.cu",
        "replaces": "scripts/vpu_peak.py:50",
        "launches": s2_launches, "max_abs_err": s2_err,
        "mode": "blendmix", "ms": s2_modes["blendmix"]["ms"],
        "plain_ms": s2_modes["blendmix"]["plain_ms"],
        "plain_size": f"grid {S2_CHECK_GRID} (the kernel there: check_ms)",
        "bound_ms": s2_modes["blendmix"]["bound_ms"],
        "bound_by": "operations",
        "bound_pipe": s2_modes["blendmix"]["bound_pipe"], "library_ms": None,
        "modes": s2_modes, "ffma_per_step": ffma,
        "held_to": "vpu_peak.plain_call", "ok": True,
    }, {
        "name": "S1 micro_bf16", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/micro_bf16.cu",
        "replaces": "scripts/micro_bf16.py:35",
        "launches": s1_launches, "max_abs_err": s1_err,
        "mode": "madd_bfloat16", "ms": s1_modes["madd_bfloat16"]["ms"],
        "plain_ms": s1_modes["madd_bfloat16"]["plain_ms"],
        "plain_size": f"r {S1_CHECK_R} (the kernel there: check_ms)",
        "bound_ms": s1_modes["madd_bfloat16"]["bound_ms"],
        "bound_by": "operations",
        "bound_pipe": s1_modes["madd_bfloat16"]["bound_pipe"],
        "library_ms": None,
        "modes": s1_modes,
        "bf16_speedup": {op: s1[f"{op}_bf16_speedup"]
                         for op in micro_bf16.OPS},
        "held_to": "micro_bf16.plain_passes", "ok": True,
    }, {
        "name": "S3 blend_bwd_skeleton", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "scripts/micro_bwd.py:42",
        "launches": sum(s3_launches[m] for m in cuda_blend.SKELETON_MODES),
        "launches_by_variant": s3_launches, "max_abs_err": s3_err,
        "mode": "skeleton", "ms": s3["variants"]["skeleton"]["ms"],
        "plain_ms": s3["variants"]["skeleton"]["plain_ms"],
        "bound_ms": s3["variants"]["skeleton"]["bound_ms"],
        "bound_by": s3["variants"]["skeleton"]["bound_by"],
        "library_ms": None, "variants": s3["variants"],
        "frame": {k: s3[k] for k in ("width", "height", "gaussians",
                                     "instances", "slots", "pairs_walked")},
        "held_to": "micro_bwd.plain_variant", "ok": True,
    }]
    return entries, s3_launches, blendmix_rate


def pipe_bounds(dev, smi, s2_modes, s1_modes):
    """Phase 3d's bounds of S2 and S1 per pipe: each mode's loop in the
    kernel's SASS (cuobjdump) counted by pipe (micro.pipe_counts: FP32 at
    128 lanes per SM per clock, MUFU at 16, the ALU at 64, issue at 128),
    per pass of a thread, times the passes of a call over every SM's
    lanes at the SM clock nvidia-smi reads while the mode runs back to
    back; the fullest pipe bounds the call. S2's loop is one grid step
    (INNER steps or pairs, the grid loop not unrolled); S1's an unrolled
    run of passes, counted by its one FFMA (float32 madd), HMUL2 (bf16
    madd) or MUFU.EX2 per element (exp). Adds the bound and its pipe, the
    counts, the clock and the share of the measured time to each mode's
    entry; the count at 67 T stays as bound_ms_67t."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch.micro import (
        loop_opcodes, micro_bf16, pipe_bound_ms, pipe_counts, sass_listing,
        sm_clock_mhz, vpu_peak,
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build.build([vpu_peak.SOURCE, micro_bf16.SOURCE])
    index = dev.index or 0

    def record(entry, name, loop, passes, threads, clock):
        per = {p: n / passes for p, n in pipe_counts(loop).items()}
        ms, pipe = pipe_bound_ms(per, threads, clock, sms)
        entry.update(bound_ms_67t=entry["bound_ms"], bound_ms=ms,
                     bound_pipe=pipe, pipes_per_pass=per,
                     loop_passes=passes, sm_clock_mhz=clock,
                     share_of_bound=ms / entry["ms"])
        print(f"#   {name}: SASS per pass of a thread " + ", ".join(
            f"{p} {n:g}" for p, n in per.items())
            + f" ({len(loop)} instructions in the loop, {passes:g} passes);"
            f" SM clock {clock:.0f} MHz x {sms} SMs: bound {ms:.5f} ms by "
            f"{pipe}, {ms / entry['ms'] * 100:.1f}% of its {entry['ms']:.4f}"
            f" ms (at 67 T: {entry['bound_ms_67t']:.5f})  [{smi}]")

    x = vpu_peak.start_block(dev)
    for i, mode in enumerate(vpu_peak.MODES):
        loop = loop_opcodes(sass_listing(
            libs[vpu_peak.SOURCE], f"vpu_peak_kernelILi{i}ELi{vpu_peak.INNER}E"))
        clock = sm_clock_mhz(lambda m=mode: vpu_peak.run(x, m), index=index)
        # one pass is a grid step: INNER steps of the four chains, 4 INNER
        # of the serial one, or INNER blend pairs
        record(s2_modes[mode], f"S2 {mode}", loop, 1,
               x.numel() * vpu_peak.GRID, clock)
    c = torch.tensor([[micro_bf16.C_VALUE]], device=dev)
    r = micro_bf16.RS[-1]
    for j, op in enumerate(micro_bf16.OPS):
        for name, dtype in micro_bf16.DTYPES.items():
            bf16 = name == "bfloat16"
            loop = loop_opcodes(sass_listing(
                libs[micro_bf16.SOURCE],
                f"passes_{'bf16' if bf16 else 'f32'}ILi{j}E"))
            bases = [o.split(".")[0] for o in loop]
            if op == "exp":
                passes = loop.count("MUFU.EX2") / (2 if bf16 else 1)
            elif bf16:
                passes = bases.count("HMUL2") + bases.count("HFMA2")
            else:
                passes = bases.count("FFMA")
            if not passes:
                raise AssertionError(f"S1 {op}_{name}: no pass in its loop's "
                                     f"SASS {loop}")
            xs = torch.full((micro_bf16.P, micro_bf16.C), micro_bf16.START,
                            dtype=dtype, device=dev)
            clock = sm_clock_mhz(lambda: micro_bf16.passes(c, xs, op, r),
                                 index=index)
            record(s1_modes[f"{op}_{name}"], f"S1 {op}_{name}", loop, passes,
                   xs.numel() // (2 if bf16 else 1) * r, clock)


def check_scaling(rec, procs):
    """Raises unless a scaling_bench record of `procs` ranks stepped
    without overflow to a finite loss, launched K1 and K2 once a frame of
    each step on its rank, and left every rank in the same state."""
    if rec["procs"] != procs or rec["overflowed"]:
        raise AssertionError(f"scaling_bench on {procs} ranks: procs "
                             f"{rec['procs']}, overflowed {rec['overflowed']}")
    if not math.isfinite(rec["loss"]):
        raise AssertionError(f"scaling_bench loss {rec['loss']}")
    if rec["k1_per_step"] != 1 or rec["k2_per_step"] != 1:
        raise AssertionError(f"scaling_bench launched K1 {rec['k1_launches']}"
                             f" and K2 {rec['k2_launches']} in "
                             f"{rec['iters']} steps")
    if len(set(rec["state_digests"])) != 1:
        raise AssertionError(f"the ranks' states differ after the steps: "
                             f"{rec['state_digests']}")


def scaling_line(rec, smi):
    prof = rec["device_profile"] or {}
    idle = prof.get("idle_share")
    ev = rec["step_ms_events_median"]
    print(f"# scaling_bench, {rec['procs']} rank(s), mesh {rec['mesh']}: "
          f"step {rec['step_ms']:.4f} ms (host clock, mean of "
          f"{rec['iters']}; CUDA events median "
          + (f"{ev:.4f}" if ev is not None else "not measured")
          + f"), {rec['px_per_s']:.1f} px/s,"
          f" grad all-reduce {rec['grad_allreduce_ms']:.4f} ms of "
          f"{rec['grad_payload_mb']} MB, comm_fraction "
          f"{rec['comm_fraction']:.5f}; device idle "
          + (f"{idle * 100:.1f}%, NCCL {prof['nccl_share'] * 100:.1f}% of "
             f"the traced step" if idle is not None else "not measured")
          + f"; loss {rec['loss']:.7f}; budget {rec['budget']}; K1 / K2 "
          f"{rec['k1_launches']} / {rec['k2_launches']} in {rec['iters']} "
          f"steps on rank 0  [{rec['card'] or smi}]")


def scaling_frame_check(dev, smi, budget):
    """Phase 3l (b): scaling_bench's world-1 frame at full width (its
    models from the same seed, the step's initial state) through K1 and K2
    against their plain versions (K2 in float64 too) at the step's band
    budget. Returns the largest differences."""
    from hugs_tpu_torch import scaling_bench as sb
    from hugs_tpu_torch.models import human_gs as hgs
    from hugs_tpu_torch.models import scene_gs as sgs
    from hugs_tpu_torch.parallel.shard import band_height
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import (
        gauss_features, plain_blend, plain_blend_bwd,
    )
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import bin_gaussians

    cfg, fixed, js, _ = sb.build_models(SCALING_FULL, 1, dev)
    fr = sb.whole_batch(1, W, H, dev)[0]
    band_h = band_height(H, 1)
    with torch.no_grad():
        h_out = hgs.human_forward(js.human.params, js.human.state, fixed,
                                  cfg, smpl_scale=fr["smpl_scale"],
                                  dataset_idx=0, compute_gt_lbs=False)
        s_out = sgs.scene_forward(js.scene.gs)
        a = {k: torch.cat([h_out[k], s_out[k]]) for k in
             ("xyz", "scales", "rotq", "opacity", "shs", "alive")}
        pg = project_gaussians(a["xyz"], a["scales"], a["rotq"],
                               a["opacity"], a["shs"], fr["camera"], W, H,
                               h_out["active_sh_degree"], alive=a["alive"])
        bins = bin_gaussians(pg, W, band_h, budget)
        if bool(bins.overflowed):
            raise AssertionError(f"scaling_bench's frame overflowed {budget}")
        feat = gauss_features(pg)
        args = (feat, bins.gauss_id, bins.starts, bins.ends, fr["bg"], W,
                band_h)
        raw, logt, nwalk, _ = cuda_blend.blend_fwd(*args)
        raw_p, _, _ = plain_blend(*args)
        k1_err = held(f"(b) K1 raw image vs plain, scaling_bench's frame "
                      f"({a['xyz'].shape[0]} rows, {int(bins.n_instances)} "
                      f"instances)", raw, raw_p)
        g = torch.Generator(device=dev).manual_seed(SEED + 53)
        gr = torch.rand((3, band_h, W), generator=g, device=dev)
        gf_k, _ = cuda_blend.blend_bwd(*args, gr, logt, nwalk)
        gf_p, _ = plain_blend_bwd(*args, gr)
        gf_64, _ = plain_blend_bwd(feat.double(), *args[1:4],
                                   fr["bg"].double(), W, band_h,
                                   gr.double())
        k2_err = held_grad("(b) K2 grad_feat vs plain, scaling_bench's "
                           "frame", gf_k[:, :9], gf_p[:, :9], gf_64[:, :9])
    print(f"# (b) scaling_bench's frame at budget {budget}: K1 max |d| "
          f"{k1_err:.3e}, K2 max |d| {k2_err:.3e}  [{smi}]")
    return {"k1_err": k1_err, "k2_err": k2_err,
            "instances": int(bins.n_instances)}


def sizing_frame_check(dev, smi, sizing):
    """Phase 3l (d): the sizing's camera 0 at D = 1 on the card: its one
    packet holds every instance the whole frame's binning keeps at the
    same budget, and K1 on those bins equals its plain version."""
    from hugs_tpu_torch import gauss_frag_sizing as gfs
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import bin_gaussians

    s = {k: torch.tensor(v, device=dev) for k, v in
         sizing["scene"].items()}
    cam = gfs.camera_frames(device=dev)[0]["camera"]
    with torch.no_grad():
        pg = project_gaussians(s["means"], s["scales"], s["rotq"],
                               s["opacity"], s["shs"], cam, gfs.W, gfs.H, 3)
        bins = bin_gaussians(pg, gfs.W, gfs.H, sizing["local_budget_default"])
        kept = int((bins.ends - bins.starts).sum())
        got = sizing["frag_counts_per_camera"][0][0][0]
        print(f"# (d) the sizing's camera 0 at D = 1: {got} fragments, the "
              f"frame's bins keep {kept}  [{smi}]")
        if got != kept or bool(bins.overflowed):
            raise AssertionError("the sizing's packet is not the frame's "
                                 "kept instances")
        black = torch.zeros(3, device=dev)
        args = (gauss_features(pg), bins.gauss_id, bins.starts, bins.ends,
                black, gfs.W, gfs.H)
        raw = cuda_blend.blend_fwd(*args)[0]
        return held("(d) K1 raw image vs plain, the sizing's camera 0", raw,
                    plain_blend(*args)[0])


def scaling_phase(dev, smi):
    """Phase 3l, the scaling harness and the fragment-packet sizing on one
    card (see the module docstring). Raises if a check fails; returns its
    numbers."""
    from hugs_tpu_torch import gauss_frag_sizing as gfs
    from hugs_tpu_torch import scaling_bench as sb
    from hugs_tpu_torch.parallel.launch import run_ranks
    from hugs_tpu_torch.render import cuda_blend

    t_phase = time.time()
    torch.cuda.empty_cache()
    # (a) the worker at world 1 in a one-rank NCCL group, a process of
    # its own on this card
    t0 = time.time()
    rec = run_ranks(sb.worker_rank, 1, (SCALING_FULL, "cuda"),
                    backend="nccl", timeout=SCALING_TIMEOUT)[0]
    worker_s = time.time() - t0
    print(json.dumps({"scaling_bench": rec}))
    scaling_line(rec, smi)
    print(f"# (a) the worker took {worker_s:.1f} s (host clock), spawn and "
          f"models included")
    check_scaling(rec, 1)
    frame = scaling_frame_check(dev, smi, rec["budget"])
    torch.cuda.empty_cache()
    # (c) the sizing at D = 1, in this process
    scene = gfs.sizing_scene(gfs.N, dev)
    cuda_blend.LAUNCHES = 0
    t0 = time.time()
    sizing = gfs.measure("cuda", 1, scene=scene)
    sizing_s = time.time() - t0
    k1 = cuda_blend.LAUNCHES
    sizing["card"] = smi
    print(json.dumps({"gauss_frag_sizing": sizing}))
    print(f"# (c) the sizing at D = 1: per-pair max "
          f"{sizing['measured_per_pair_max']}, per-band max "
          f"{sizing['measured_per_band_max']}, frag_cap recommended "
          f"{sizing['frag_cap_recommended']} of {sizing['frag_cap_default']};"
          f" {k1} K1 launches for {gfs.N_CAMS} cameras; {sizing_s:.1f} s "
          f"(host clock)  [{smi}]")
    if k1 != gfs.N_CAMS:
        raise AssertionError(f"the sizing launched K1 {k1} times")
    sizing_err = sizing_frame_check(dev, smi, dict(sizing, scene=scene))
    out = {"scaling": rec, "frame": frame, "sizing": sizing,
           "sizing_k1": k1, "sizing_err": sizing_err, "worker_s": worker_s,
           "phase_s": time.time() - t_phase}
    print(f"# phase 3l: {out['phase_s']:.1f} s (host clock)  [{smi}]")
    return out


def scaling_cards(smi, out_dir):
    """--scale-out's scaling runs: hugs_tpu_torch.scaling_bench's launcher
    over SCALING_PROCS (those the cards allow) at phase 3l's size, each
    checked as there; then the sizing on SIZING_RANKS NCCL ranks held to
    the same scene on as many gloo ranks of the CPU, each entry within
    SIZING_RTOL. Returns its numbers, or None (and says so) with fewer
    cards than two."""
    from hugs_tpu_torch import gauss_frag_sizing as gfs
    from hugs_tpu_torch import scaling_bench as sb

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"# scaling over cards: not run, torch.cuda.device_count() = "
              f"{n_cards}")
        return None
    procs = [p for p in SCALING_PROCS if p <= n_cards]
    t0 = time.time()
    recs = sb.launch(dict(SCALING_FULL, procs=procs, out=out_dir))
    launch_s = time.time() - t0
    for p, rec in zip(procs, recs):
        scaling_line(rec, smi)
        check_scaling(rec, p)
    out = {"scaling": recs, "launch_s": launch_s}
    print(f"# scaling_bench launcher, procs {procs}: {launch_s:.1f} s (host "
          f"clock)")
    if n_cards < SIZING_RANKS:
        print(f"# the sizing at D = {SIZING_RANKS}: not run, "
              f"{n_cards} cards")
        return out
    scene = gfs.sizing_scene(gfs.N, "cuda")
    t0 = time.time()
    card_rec = gfs.measure("cuda", SIZING_RANKS, scene=scene)
    card_s = time.time() - t0
    t0 = time.time()
    cpu_rec = gfs.measure("cpu", SIZING_RANKS, scene=scene)
    cpu_s = time.time() - t0
    a = np.asarray(card_rec["frag_counts_per_camera"])
    b = np.asarray(cpu_rec["frag_counts_per_camera"])
    d = np.abs(a - b)
    print(json.dumps({"gauss_frag_sizing": dict(card_rec, card=smi)}))
    print(f"# the sizing at D = {SIZING_RANKS}: cards (NCCL, {card_s:.1f} s)"
          f" vs CPU (gloo, {cpu_s:.1f} s): {int((d > 0).sum())} of {d.size}"
          f" entries differ, by up to {int(d.max())} "
          f"({float((d / np.maximum(b, 1)).max()) * 100:.4f}%); per-pair max"
          f" {card_rec['measured_per_pair_max']} / "
          f"{cpu_rec['measured_per_pair_max']}, per-band max "
          f"{card_rec['measured_per_band_max']} / "
          f"{cpu_rec['measured_per_band_max']}, frag_cap "
          f"{card_rec['frag_cap_recommended']} / "
          f"{cpu_rec['frag_cap_recommended']}; K1 per rank "
          f"{card_rec['k1_launches']}  [{smi}]")
    if not bool((d <= SIZING_RTOL * b).all()):
        raise AssertionError("the cards' frag_counts are not the CPU's")
    out.update(sizing=card_rec, sizing_cpu=cpu_rec, sizing_s=card_s,
               sizing_cpu_s=cpu_s, sizing_entries_differ=int((d > 0).sum()))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hugs_tpu_torch import build
    from hugs_tpu_torch.models.scene_gs import (
        PARAM_FIELDS, compact, create_from_pcd, create_from_ply,
        one_up_sh_degree, scene_forward,
    )
    from hugs_tpu_torch.render import cuda_blend, make_camera
    from hugs_tpu_torch.render.blend import (
        gauss_features, plain_blend, plain_blend_bwd,
    )
    from hugs_tpu_torch.render.oracle import LOG_TEPS, clip01
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.renderer import render, render_human_scene
    from hugs_tpu_torch.render.tiles import TILE, bin_gaussians, tile_grid
    from hugs_tpu_torch.train.scene_step import (
        init_scene_train_state, make_scene_lrs, scene_densify_step,
        scene_grads, scene_loss, scene_render, scene_train_step,
        scene_update,
    )
    from hugs_tpu_torch.utils.ply import save_gaussian_ply

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.time()

    # ---- 1. setup
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    card_info = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(smi)
    t0 = time.time()
    from hugs_tpu_torch.micro import micro_bf16, vpu_peak
    # every kernel's source, one nvcc each, all started together
    build.build([cuda_blend.SOURCE, cuda_blend.BWD_SOURCE, vpu_peak.SOURCE,
                 micro_bf16.SOURCE])
    build_s = time.time() - t0
    print(f"# build: {build_s:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"# nvcc {name}: {line.strip()}")
    occupancy = cuda_blend.blocks_per_sm()
    resources = {}
    for k, source, entry in (("K1", cuda_blend.SOURCE, "blend_fwd_kernel"),
                             ("K2", cuda_blend.BWD_SOURCE,
                              "blend_bwd_kernel")):
        # ptxas's report is this run's, or the one kept beside a library
        # built earlier from the same source and flags
        ptxas = ("this run's nvcc" if source in build.compiled else
                 build.library_path(source).with_suffix(".log").name)
        resources[k] = dict(
            build.kernel_resources(build.build_logs[source], entry),
            blocks_per_sm=occupancy[k], ptxas_report=ptxas)
        r = resources[k]
        print(f"# {k} {entry}: {r['registers']} registers, "
              f"{r['smem_bytes']} B static shared memory, {r['spill_bytes']}"
              f" B spill stores (ptxas report: {ptxas}), "
              f"{r['blocks_per_sm']} resident blocks per SM "
              f"({r['blocks_per_sm'] * 8} of 64 warps)")

    # ---- 2. K1 against plain at full width
    raw = build_scene(N_GAUSS, SEED)
    xyz = torch.as_tensor(raw["xyz"], device=dev)
    q = torch.as_tensor(raw["rotation"], device=dev)
    # the activations of scene_forward, so phase 3 sees the same values
    attrs = dict(
        xyz=xyz, scales=torch.exp(torch.as_tensor(raw["scaling"], device=dev)),
        rotq=q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                             min=1e-8),
        opacity=torch.sigmoid(torch.as_tensor(raw["opacity"], device=dev)[:, 0]),
        shs=torch.as_tensor(raw["shs"], device=dev))
    bg = torch.tensor(BG, device=dev)
    cams = [make_camera(*view(i), 0.9, 0.55, device=dev) for i in range(4)]

    def project(cam, a=attrs, alive=None, degree=3):
        return project_gaussians(a["xyz"], a["scales"], a["rotq"],
                                 a["opacity"], a["shs"], cam, W, H, degree,
                                 alive=alive)

    def slot_budget(demand):
        """A budget 15 % over a slot demand, in whole 8192-slot pages."""
        return -(-(demand * 23 // 20) // 8192) * 8192

    # rehearsal: size the budget from every view's slot demand
    demand = max(int(bin_gaussians(project(c), W, H, 4 * N_GAUSS).n_slots)
                 for c in cams)
    budget = slot_budget(demand)
    pg = project(cams[0])
    bins = bin_gaussians(pg, W, H, budget)
    if bool(bins.overflowed):
        raise AssertionError(f"budget {budget} overflowed")
    feat = gauss_features(pg)
    img_k, logt_k, nwalk_k, walked = cuda_blend.blend_fwd(
        feat, bins.gauss_id, bins.starts, bins.ends, bg, W, H)
    img_p, logt_p, pairs = plain_blend(feat, bins.gauss_id, bins.starts,
                                       bins.ends, bg, W, H)
    torch.cuda.synchronize()
    nx, ny = tile_grid(W, H, TILE)
    counts = bins.ends - bins.starts
    print(f"# scene: {N_GAUSS} Gaussians, {int(pg.mask.sum())} visible; "
          f"{nx * ny} tiles; {int(counts.sum())} instances "
          f"(demand {int(bins.n_instances)} before culling, max "
          f"{int(counts.max())} per tile); budget {budget} slots; "
          f"K1 walked {int(walked.sum())}")
    max_err = held("K1 raw image vs plain", img_k, img_p)
    live = logt_p >= LOG_TEPS
    held("K1 log T vs plain (unsaturated pixels)", logt_k[live],
         logt_p[live])
    print(f"# unsaturated pixels: {int(live.sum())} of {W * H}")
    if not bool(torch.isfinite(img_k).all()):
        raise AssertionError("K1 image is not finite")

    def tile_of_pixel(per_tile):
        """(T,) per-tile values -> (H, W) per pixel."""
        img = per_tile.reshape(ny, nx).repeat_interleave(TILE, 0) \
            .repeat_interleave(TILE, 1)
        return img[:H, :W]

    def cull_counts(frame, feat, b, n_walked):
        """micro.warp_cull_counts on one frame, printed."""
        out = warp_cull_counts(feat, b, n_walked, W, H)
        for k in ("K1", "K2"):
            print(f"# warp cull, {frame}: {k}'s warps cull {out[k]} (warp, "
                  f"instance) pairs and drop {out[k + '_dropped'] * 100:.2f}%"
                  f" of them")
        return out

    # K1's per-pixel walk: within its tile's walk, and the instances the
    # plain blend tests before saturation, up to pairs at the threshold
    if bool((nwalk_k > tile_of_pixel(walked)).any()):
        raise AssertionError("a pixel walked past its tile's walk")
    same = float((nwalk_k.long() == pairs[0]).float().mean())
    print(f"# K1 n_walked equals the plain blend's tested count on "
          f"{same * 100:.4f}% of pixels")
    if same < MIN_SHARE:
        raise AssertionError("K1's n_walked disagrees with the plain blend")

    # the whole tiled render against the dense oracle on small scenes: a
    # slice of this one, and one in which every pixel saturates, so K1's
    # early exit decides the walk
    small_cam = make_camera(np.eye(3), [0.0, 0.0, -2.0], 0.9, 0.7,
                            device=dev)
    sat = {k: torch.as_tensor(v, device=dev)
           for k, v in saturating_scene(64, 48, 0.9, 0.7, SEED).items()}
    for name, a, cam in (
            ("slice", {k: v[:300] for k, v in attrs.items()}, small_cam),
            ("saturated", sat, make_camera(np.eye(3), 0.0, 0.9, 0.7,
                                           device=dev))):
        args = (a["xyz"], a["scales"], a["rotq"], a["opacity"], a["shs"],
                cam, 64, 48)
        tiled = render(*args, bg=bg, active_sh_degree=3)["render"]
        oracle = render(*args, bg=bg, active_sh_degree=3,
                        backend="oracle")["render"]
        held(f"render(tiled) vs render(oracle), 64x48 {name}", tiled, oracle)
    pgs = project_gaussians(*args[:6], 64, 48, 3)
    bs = bin_gaussians(pgs, 64, 48, 1 << 16)
    feat_s = gauss_features(pgs)
    _, logt_s, nwalk_s, walked_s = cuda_blend.blend_fwd(
        feat_s, bs.gauss_id, bs.starts, bs.ends, bg, 64, 48)
    listed = int((bs.ends - bs.starts).sum())
    print(f"# saturated scene: K1 walked {int(walked_s.sum())} of {listed} "
          f"instances")
    if not (bool((logt_s < LOG_TEPS).all()) and int(walked_s.sum()) < listed):
        raise AssertionError("K1's early exit did not fire")

    # ---- 2b. K2 against plain at full width, and on the saturated scene
    rng = np.random.default_rng(SEED + 2)
    g_raw = torch.as_tensor(rng.normal(size=(3, H, W)).astype(np.float32),
                            device=dev)
    gf_k, gb_k = cuda_blend.blend_bwd(feat, bins.gauss_id, bins.starts,
                                      bins.ends, bg, W, H, g_raw, logt_k,
                                      nwalk_k)
    gf_p, gb_p = plain_blend_bwd(feat, bins.gauss_id, bins.starts, bins.ends,
                                 bg, W, H, g_raw)
    torch.cuda.synchronize()
    print("# K2 bar: the sums run in another order, K2's atomics add in an "
          "order that is not fixed, and a pair at the T_EPS threshold may "
          "flip")
    k2_err = held_grad("K2 grad_feat vs plain", gf_k[:, :9], gf_p[:, :9])
    if float(gf_k[:, 9].abs().max()) != 0.0:
        raise AssertionError("K2 wrote a radius gradient")
    bg_rel = float(((gb_k - gb_p).abs() / gb_p.abs()).max())
    print(f"# K2 grad_bg {gb_k.tolist()} vs plain {gb_p.tolist()}: max "
          f"relative {bg_rel:.3e} (bar {BG_RTOL})")
    if bg_rel > BG_RTOL:
        raise AssertionError("K2 grad_bg disagrees")
    g_s = torch.as_tensor(rng.normal(size=(3, 48, 64)).astype(np.float32),
                          device=dev)
    gs_k, _ = cuda_blend.blend_bwd(feat_s, bs.gauss_id, bs.starts, bs.ends,
                                   bg, 64, 48, g_s, logt_s, nwalk_s)
    gs_p, _ = plain_blend_bwd(feat_s, bs.gauss_id, bs.starts, bs.ends, bg,
                              64, 48, g_s)
    held_grad("K2 grad_feat vs plain, 64x48 saturated", gs_k[:, :9],
              gs_p[:, :9])
    cull_serve = cull_counts("phase 2's frame (serving)", feat, bins,
                             nwalk_k)

    # ---- 3. serving path through the user's entry points
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.ply")
        save_gaussian_ply(path, raw["xyz"], raw["shs"][:, :1],
                          raw["shs"][:, 1:], raw["opacity"], raw["scaling"],
                          raw["rotation"])
        cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
        t0 = time.time()
        gs = compact(create_from_ply(path, device=dev))
        with torch.no_grad():
            out = scene_forward(gs)
            images = []
            for cam in cams:
                pkg = render_human_scene(
                    {"camera": cam, "width": W, "height": H}, None, out, bg,
                    render_mode="scene", instance_budget=budget)
                if bool(pkg["overflowed"]):
                    raise AssertionError("a request overflowed its budget")
                images.append(pkg["render"])
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        launches = cuda_blend.LAUNCHES
        k2_serve = cuda_blend.K2_LAUNCHES
    print(f"# serving: {len(cams)} requests in {serve_s:.3f} s (load "
          f"included), K1 launches {launches}, K2 launches {k2_serve}, "
          f"capacity {gs.capacity}")
    if launches != len(cams) or k2_serve != 0:
        raise AssertionError(f"K1 launched {launches} and K2 {k2_serve} "
                             f"times for {len(cams)} requests")
    for i, img in enumerate(images):
        if img.shape != (3, H, W) or not bool(torch.isfinite(img).all()) \
                or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise AssertionError(f"request {i}: bad image")
    d0 = float((images[0] - clip01(img_k)).abs().max())
    print(f"# request 0 vs phase-2 K1 image, clipped: max |d| {d0:.3e}")
    if d0 > 1e-6:
        raise AssertionError("request 0 differs from the phase-2 image")

    # ---- 3b. training path at full width
    black = torch.zeros(3, device=dev)
    with torch.no_grad():
        targets = [render(attrs["xyz"], attrs["scales"], attrs["rotq"],
                          attrs["opacity"], attrs["shs"], cam, W, H,
                          bg=black, active_sh_degree=3,
                          instance_budget=budget)["render"] for cam in cams]
    noisy = raw["xyz"] + np.random.default_rng(SEED + 3).normal(
        scale=PCD_NOISE, size=raw["xyz"].shape).astype(np.float32)
    centers = np.stack([c.center.cpu().numpy() for c in cams])
    extent = float(1.1 * np.linalg.norm(centers - centers.mean(0),
                                        axis=1).max())
    static_lrs, xyz_sched = make_scene_lrs(SceneLR, extent)
    state = init_scene_train_state(create_from_pcd(
        noisy, np.full((N_GAUSS, 3), 0.5, np.float32), CAPACITY,
        device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def split_noise():
        """The densify's split noise, (2, capacity, 3) standard normal."""
        return torch.randn((2, CAPACITY, 3), generator=gen, device=dev)

    def trainee_demand(st):
        """The trainee's largest slot demand over the views, from
        projection and binning alone (no blend launch)."""
        with torch.no_grad():
            a = scene_forward(st.gs)
            return max(int(bin_gaussians(project(c, a, a["alive"], 3), W, H,
                                         4 * CAPACITY).n_slots)
                       for c in cams)

    train_budget = train_budget0 = slot_budget(trainee_demand(state))
    print(f"# training: trainee {N_GAUSS} Gaussians in capacity "
          f"{CAPACITY}, budget {train_budget} slots, extent {extent:.4f}, "
          f"learning rates of hugs_tpu's config (scene.lr), unboosted")
    # the frame step 0 renders (view 0, the largest of the run: training
    # shrinks the trainee's splats), kept to hold K1 and K2 on it after
    # the run; projection and binning only, no kernel launch
    with torch.no_grad():
        a = scene_forward(state.gs)
        pg_t = project(cams[0], a, a["alive"], a["active_sh_degree"])
        bins_t = bin_gaussians(pg_t, W, H, train_budget)
        feat_t = gauss_features(pg_t)
    if bool(bins_t.overflowed):
        raise AssertionError("step 0's frame overflowed its budget")
    losses, infos = [], {}
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    t0 = time.time()
    for step in range(STEPS):
        if step and step % SH_EVERY == 0:
            one_up_sh_degree(state.gs)
        if step in (DENSIFY_AT, RESET_AT):
            n0 = int(state.gs.n_alive)
            kw = (dict(grad_threshold=0.0002, min_opacity=0.005,
                       percent_dense=0.01) if step == DENSIFY_AT else
                  dict(grad_threshold=math.inf, min_opacity=0.0,
                       do_reset_opacity=True))
            state, info = scene_densify_step(state, split_noise(), extent,
                                             **kw)
            infos[step] = {k: int(v) for k, v in info.items()}
            what = "densify" if step == DENSIFY_AT else "opacity reset"
            print(f"# step {step}: {what} {infos[step]} (alive before {n0})")
            if step == DENSIFY_AT:
                if not n0 < info["n_alive"] <= CAPACITY:
                    raise AssertionError("the densify did not grow the set")
                train_budget = max(train_budget,
                                   slot_budget(trainee_demand(state)))
                print(f"# budget after the densify: {train_budget} slots")
        i = step % len(cams)
        state, aux = scene_train_step(
            state, cams[i], targets[i], black, xyz_sched(step),
            static_lrs, width=W, height=H, instance_budget=train_budget)
        if bool(aux["overflowed"]):
            raise AssertionError(f"step {step} overflowed its budget")
        losses.append(float(aux["loss"]))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    k1_train, k2_train = cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES
    print(f"# training: {STEPS} steps in {train_s:.3f} s (host clock, "
          f"densify and budget passes included), K1 launches {k1_train}, "
          f"K2 launches {k2_train}; n_alive {int(state.gs.n_alive)}")
    print("# loss by step: " + " ".join(f"{v:.5f}" for v in losses))
    if k1_train != STEPS or k2_train != STEPS:
        raise AssertionError("each training step must launch K1 and K2 once")
    # whole cycles of the 4 views, before the densify: each view's loss
    # differs, so windows that hold one view twice do not compare
    cyc = len(cams)
    first, mid = losses[:cyc], losses[DENSIFY_AT - cyc:DENSIFY_AT]
    print(f"# mean loss, steps 0-{cyc - 1}: {np.mean(first):.6f}; steps "
          f"{DENSIFY_AT - cyc}-{DENSIFY_AT - 1}: {np.mean(mid):.6f}")
    if not (np.isfinite(losses).all() and np.mean(mid) < np.mean(first)
            and all(b < a for a, b in zip(first, mid))):
        raise AssertionError("the loss did not fall on every view")
    alive = state.gs.alive
    for f in PARAM_FIELDS:
        p = getattr(state.gs, f)
        if not bool(torch.isfinite(p[alive]).all()):
            raise AssertionError(f"{f} is not finite on a live Gaussian")
    # rows never alive sit at the origin, view 0's centre, where the view
    # direction's norm has no gradient: NaN, as in hugs_tpu, and harmless
    # (dead rows render nothing; densify overwrites them)
    dead_nan = int((~torch.isfinite(state.gs.xyz[~alive])).any(-1).sum())
    print(f"# parameters finite on every live Gaussian; dead rows with a "
          f"non-finite xyz: {dead_nan} of {int((~alive).sum())}")

    # K1 and K2 on the frame step 0 gave them, with the true
    # d(loss)/d(raw colour) of that step's loss (the clip's 0.5 at the
    # bounds included)
    raw_t, logt_t, nwalk_t, walked_t = cuda_blend.blend_fwd(
        feat_t, bins_t.gauss_id, bins_t.starts, bins_t.ends, black, W, H)
    raw_tp, logt_tp, pairs_t = plain_blend(
        feat_t, bins_t.gauss_id, bins_t.starts, bins_t.ends, black, W, H)
    counts_t = bins_t.ends - bins_t.starts
    print(f"# step 0's frame: {int(counts_t.sum())} instances (max "
          f"{int(counts_t.max())} per tile), K1 walked {int(walked_t.sum())}")
    max_err = max(max_err, held("K1 raw image vs plain, step 0's frame",
                                raw_t, raw_tp))
    live_t = logt_tp >= LOG_TEPS
    held("K1 log T vs plain, step 0's frame (unsaturated pixels)",
         logt_t[live_t], logt_tp[live_t])
    if bool((nwalk_t > tile_of_pixel(walked_t)).any()):
        raise AssertionError("a pixel of step 0's frame walked past its "
                             "tile's walk")
    same_t = float((nwalk_t.long() == pairs_t[0]).float().mean())
    print(f"# K1 n_walked equals the plain blend's tested count on "
          f"{same_t * 100:.4f}% of the pixels of step 0's frame")
    if same_t < MIN_SHARE:
        raise AssertionError("K1's n_walked disagrees on step 0's frame")
    raw_req = raw_t.clone().requires_grad_()
    (g_t,) = torch.autograd.grad(scene_loss(clip01(raw_req), targets[0]),
                                 raw_req)
    gf_t, gb_t = cuda_blend.blend_bwd(
        feat_t, bins_t.gauss_id, bins_t.starts, bins_t.ends, black, W, H,
        g_t, logt_t, nwalk_t)
    gf_tp, gb_tp = plain_blend_bwd(
        feat_t, bins_t.gauss_id, bins_t.starts, bins_t.ends, black, W, H,
        g_t)
    gf_64, _ = plain_blend_bwd(
        feat_t.double(), bins_t.gauss_id, bins_t.starts, bins_t.ends,
        black.double(), W, H, g_t.double())
    k2_err = max(k2_err, held_grad("K2 grad_feat vs plain, step 0's frame",
                                   gf_t[:, :9], gf_tp[:, :9], gf_64[:, :9]))
    bg_rel_t = float(((gb_t - gb_tp).abs() / gb_tp.abs()).max())
    print(f"# K2 grad_bg, step 0's frame {gb_t.tolist()} vs plain "
          f"{gb_tp.tolist()}: max relative {bg_rel_t:.3e} (bar {BG_RTOL})")
    if bg_rel_t > BG_RTOL:
        raise AssertionError("K2 grad_bg disagrees on step 0's frame")
    cull_train = cull_counts("step 0's frame (training)", feat_t, bins_t,
                             nwalk_t)

    # ---- 4. times on the card
    # one request by stage: scene_forward + projection, binning, K1
    stages = {"project": [], "bin": [], "blend": [], "request": []}
    with torch.no_grad():
        for rep in range(3 + REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            a = scene_forward(gs)
            pgr = project(cams[0], a, a["alive"])
            ev[1].record()
            b = bin_gaussians(pgr, W, H, budget)
            ev[2].record()
            cuda_blend.blend_tiles(pgr, b, W, H, bg)
            ev[3].record()
            ev[3].synchronize()
            if rep >= 3:
                stages["project"].append(ev[0].elapsed_time(ev[1]))
                stages["bin"].append(ev[1].elapsed_time(ev[2]))
                stages["blend"].append(ev[2].elapsed_time(ev[3]))
                stages["request"].append(ev[0].elapsed_time(ev[3]))
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}

    # one training step by stage, the stages of scene_train_step
    tstages = {"forward": [], "loss": [], "backward": [], "update": [],
               "step": []}
    for rep in range(3 + REPS):
        i = rep % len(cams)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        hook = torch.zeros((CAPACITY, 2), device=dev, requires_grad=True)
        pkg = scene_render(state.gs, cams[i], black, hook, width=W,
                           height=H, instance_budget=train_budget)
        ev[1].record()
        loss = scene_loss(pkg["render"], targets[i])
        ev[2].record()
        grads, hook_grad = scene_grads(loss, state.gs, hook)
        ev[3].record()
        scene_update(state, grads, hook_grad, pkg, xyz_sched(STEPS + rep),
                     static_lrs, width=W, height=H)
        ev[4].record()
        ev[4].synchronize()
        if rep >= 3:
            for k, (e0, e1) in (("forward", (0, 1)), ("loss", (1, 2)),
                                ("backward", (2, 3)), ("update", (3, 4)),
                                ("step", (0, 4))):
                tstages[k].append(ev[e0].elapsed_time(ev[e1]))
    tstage_ms = {k: statistics.median(v) for k, v in tstages.items()}
    # the first call consumes the statistics the timed steps gathered;
    # later calls find nothing hot and time the step's fixed work
    densify_ms = device_ms(lambda: scene_densify_step(
        state, split_noise(), extent, grad_threshold=0.0002,
        min_opacity=0.005))
    train_budget = max(train_budget, slot_budget(trainee_demand(state)))

    # the device's busy share: kernels' time against the span from the
    # first kernel's start to the last one's end, in the same window
    def request():
        a = scene_forward(gs)
        pgr = project(cams[0], a, a["alive"])
        cuda_blend.blend_tiles(pgr, bin_gaussians(pgr, W, H, budget), W, H,
                               bg)

    with torch.no_grad():
        by_kernel, kernels_per_request, span_us = device_kernels(request)
    print_profile("request", PROFILED, by_kernel, kernels_per_request,
                  span_us, smi)
    k1_prof_ms = sum(us for name, us in by_kernel.items()
                     if "blend_fwd_kernel" in name) / 1e3

    def train_step():
        scene_train_step(state, cams[0], targets[0], black,
                         xyz_sched(STEPS), static_lrs, width=W, height=H,
                         instance_budget=train_budget)

    by_kernel_t, kernels_per_step, span_t_us = device_kernels(
        train_step, reps=PROFILED_STEPS)
    print_profile("training step", PROFILED_STEPS, by_kernel_t,
                  kernels_per_step, span_t_us, smi)
    scatter = [name for name in by_kernel_t if "indexFunc" in name]
    if scatter:
        raise AssertionError(f"a training step still runs {scatter}")
    k2_prof_ms = sum(us for name, us in by_kernel_t.items()
                     if "blend_bwd_kernel" in name) / 1e3

    def kernel_times(frame, feat, b, bg, g, log_t, n_walked, pairs, cull,
                     kernels=("k1", "k2"), plain_reps=REPS):
        """K1's and K2's (or only the `kernels` named) times on one frame
        (device time from back-to-back calls of blend_fwd and blend_bwd, for K2 its whole function: the
        zeroed outputs and the kernel with its atomics; one call alone
        adds the wrapper's host cost), their plain versions', and each
        kernel's bound, the larger of its operations and bytes over the
        card's peaks: the operations this frame needs of the kernel (the
        pairs the cull keeps, the culls, the blended pairs; K2's
        per-instance gradient, 11 per (tile, instance), is left out), and
        beside it the yardstick at the first kernels' count. The plain
        versions are timed over plain_reps calls (seconds each on a
        saturated frame). Prints them and returns them in a dict."""
        args = (feat, b.gauss_id, b.starts, b.ends, bg, W, H)
        plain_kw = dict(reps=plain_reps, warmup=min(3, plain_reps - 1))
        t = {}
        if "k1" in kernels:
            t.update(k1=device_ms(lambda: cuda_blend.blend_fwd(*args),
                                  inner=BACK_TO_BACK),
                     k1_call=device_ms(lambda: cuda_blend.blend_fwd(*args)),
                     plain=device_ms(lambda: plain_blend(*args), **plain_kw))
        if "k2" in kernels:
            bwd = args + (g, log_t, n_walked)
            t.update(k2=device_ms(lambda: cuda_blend.blend_bwd(*bwd),
                                  inner=BACK_TO_BACK),
                     k2_call=device_ms(lambda: cuda_blend.blend_bwd(*bwd)),
                     plain_bwd=device_ms(lambda: plain_blend_bwd(*args, g),
                                         **plain_kw))
        work, n_rows = blend_work(feat, b, W, H, pairs, cull)
        tested, blended = (int(x) for x in pairs.sum(dim=(1, 2)))
        n_inst = int((b.ends - b.starts).sum())
        kept = cull["tested"]
        print(f"# {frame}: {tested} pairs in the walk, {kept} of them kept "
              f"by the cull and tested, {blended} blended, {n_inst} "
              f"instances over {n_rows} of the {feat.shape[0]} rows of feat"
              f"  [{smi}]")
        t["feat_rows_read"] = n_rows
        for k, (ops, ops_first, nbytes) in work.items():
            if k not in kernels:
                continue
            ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
            t[k + "_bound"] = max(ops_ms, bytes_ms)
            t[k + "_ops"] = ops
            t[k + "_bound_by"] = "operations" if ops_ms >= bytes_ms \
                else "bytes"
            t[k + "_yardstick"] = max(ops_first / PEAK_FP32 * 1e3, bytes_ms)
            plain = t["plain" if k == "k1" else "plain_bwd"]
            print(f"#   {k.upper()} {t[k]:.4f} ms ({BACK_TO_BACK} "
                  f"back-to-back launches), one call {t[k + '_call']:.4f} ms,"
                  f" plain {plain:.4f} ms; bound: {ops:.4e} ops / 67 TFLOP/s"
                  f" = {ops_ms:.5f} ms, {nbytes} bytes / 3.35 TB/s = "
                  f"{bytes_ms:.5f} ms, so {t[k + '_bound']:.5f} ms by "
                  f"{t[k + '_bound_by']} ({t[k + '_bound'] / t[k] * 100:.1f}%"
                  f" of its time); yardstick at the first kernels' count "
                  f"{ops_first:.4e} ops = {t[k + '_yardstick']:.5f} ms "
                  f"({t[k + '_yardstick'] / t[k] * 100:.1f}%)")
        return t

    print(f"# card: {card_info}")
    # phase 2's frame is the serving path's; step 0's frame is the
    # largest the training path gives K1 and K2
    serve_t = kernel_times("phase 2's frame (serving)", feat, bins, bg,
                           g_raw, logt_k, nwalk_k, pairs, cull_serve)
    train_t = kernel_times("step 0's frame (training, view 0)", feat_t,
                           bins_t, black, g_t, logt_t, nwalk_t, pairs_t,
                           cull_train)
    print(f"# K1 profiler {k1_prof_ms:.4f} ms per request; request "
          f"{stage_ms['request']:.4f} ms = project {stage_ms['project']:.4f}"
          f" + bin {stage_ms['bin']:.4f} + blend {stage_ms['blend']:.4f} ms"
          f"  [{smi}]")
    print(f"# K2 profiler {k2_prof_ms:.4f} ms per training step  [{smi}]")
    print(f"# training step {tstage_ms['step']:.4f} ms = forward "
          f"{tstage_ms['forward']:.4f} + loss {tstage_ms['loss']:.4f} + "
          f"backward {tstage_ms['backward']:.4f} + Adam and stats "
          f"{tstage_ms['update']:.4f} ms; densify step {densify_ms:.4f} ms"
          f"  [{smi}]")

    # ---- 3c. the avatar serving path, after phase 4's times
    print(f"# phase 3c starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    avatar = avatar_serving(dev, smi, project, slot_budget, cull_counts,
                            tile_of_pixel, kernel_times)

    # ---- 3d. the micro-benchmarks, after phase 4's times
    print(f"# phase 3d starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    micro, s3_launches, blendmix_rate = micro_benchmarks(dev, smi,
                                                         cull_counts)
    # ---- 3e. the human training path, after 3d
    print(f"# phase 3e starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    human = human_training(dev, smi, project, slot_budget, cull_counts,
                           tile_of_pixel, kernel_times)
    ht = human["times"]
    with tempfile.TemporaryDirectory() as root:
        # ---- 3f. the joint training path through the CLI's main, after 3e
        print(f"# phase 3f starts at {time.time() - t_start:.1f} s (host "
              f"clock)")
        joint = joint_training(dev, smi, project, slot_budget, cull_counts,
                               tile_of_pixel, kernel_times, root)
        # ---- 3g. evaluation of 3f's output directory, after 3f
        print(f"# phase 3g starts at {time.time() - t_start:.1f} s (host "
              f"clock)")
        evaln = evaluation(dev, smi, project, cull_counts, tile_of_pixel,
                           kernel_times, joint)
        # ---- 3h. config[4]'s scale-out on 3f's run, after 3g
        print(f"# phase 3h starts at {time.time() - t_start:.1f} s (host "
              f"clock)")
        scale = scale_out(dev, smi, project, joint, evaln)
        # ---- 3i. the Gaussian-sharded path on 3f's run, after 3h
        print(f"# phase 3i starts at {time.time() - t_start:.1f} s (host "
              f"clock)")
        gauss = gauss_shard(dev, smi, project, slot_budget, joint, evaln,
                            root)
        del evaln["trainer"], joint["train_dataset"]
    jt, et = joint["times"], evaln["times"]
    torch.cuda.empty_cache()
    # ---- 3j. the convergence recipes, cut, after 3i
    print(f"# phase 3j starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    recipes = convergence_recipes(dev, smi)
    recipe_by_path = {k: {f"{n}_recipe": recipes[n][f"{k.lower()}_launches"]
                          for n in ("human_avatar", "joint_scene",
                                    "surface_scene")} for k in ("K1", "K2")}
    # ---- 3k. the blend kernels' POWER_MXU mode, after 3j
    print(f"# phase 3k starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    mxu = power_mxu_phase(dev, smi, {
        "frames": {"serving": (feat, bins, bg, g_raw, pairs, cull_serve),
                   "training": (feat_t, bins_t, black, g_t, pairs_t,
                                cull_train)},
        "serve": {"gs": gs, "cams": cams, "bg": bg, "budget": budget,
                  "image0": images[0]},
        "train": {"noisy": noisy, "cams": cams, "targets": targets,
                  "bg": black, "xyz_sched": xyz_sched, "lrs": static_lrs,
                  "budget": train_budget0}}, blendmix_rate)
    mxf = mxu["frames"]
    mxu_parity = [c for c in mxu["kernel_parity"] if c["power_mxu"]]
    # ---- 3l. the scaling harness and the fragment-packet sizing, after 3k
    print(f"# phase 3l starts at {time.time() - t_start:.1f} s (host "
          f"clock)")
    scaling = scaling_phase(dev, smi)
    sc = scaling["scaling"]

    # K1 and K2 against the rate S2 measured on the blend's mix
    at_s2 = {
        "K1": {"serving": serve_t["k1_ops"], "training": train_t["k1_ops"],
               "avatar": avatar["ops"], "human_training": ht["k1_ops"],
               "joint_training": jt["k1_ops"], "evaluation": et["k1_ops"]},
        "K2": {"training": train_t["k2_ops"], "serving": serve_t["k2_ops"],
               "human_training": ht["k2_ops"],
               "joint_training": jt["k2_ops"]}}
    times = {"K1": {"serving": serve_t["k1"], "training": train_t["k1"],
                    "avatar": avatar["ms"], "human_training": ht["k1"],
                    "joint_training": jt["k1"], "evaluation": et["k1"]},
             "K2": {"training": train_t["k2"], "serving": serve_t["k2"],
                    "human_training": ht["k2"], "joint_training": jt["k2"]}}
    for k, by_frame in at_s2.items():
        for frame, ops in by_frame.items():
            by_frame[frame] = ops / blendmix_rate * 1e3
            print(f"# {k} on the {frame} frame: {ops:.4e} ops at S2's "
                  f"blendmix rate {blendmix_rate / 1e12:.3f} T op/s = "
                  f"{by_frame[frame]:.5f} ms "
                  f"({by_frame[frame] / times[k][frame] * 100:.1f}% of its "
                  f"{times[k][frame]:.4f} ms)  [{smi}]")

    gauss_by_path = {
        "K1": {"gauss_frame": gauss["frame"]["k1_launches"],
               "gauss_steps": gauss["steps"]["k1_launches"],
               "gauss_main": gauss["main"]["k1"],
               "graft_entry": gauss["graft_entry"]["k1_launches"],
               "pergs": gauss["pergs"]["k1_launches"]},
        "K2": {"gauss_frame": gauss["frame"]["k2_launches"],
               "gauss_steps": gauss["steps"]["k2_launches"],
               "gauss_main": gauss["main"]["k2"]}}
    gauss_k1 = sum(gauss_by_path["K1"].values())
    gauss_k2 = sum(gauss_by_path["K2"].values())
    print(f"# all phases done at {time.time() - t_start:.1f} s (host clock)")
    # ---- 5. kernels line, 6. device line
    print(json.dumps({"kernels": [{
        "name": "K1 blend_fwd", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "hugs_tpu/render/pallas_blend.py:354",
        "launches": launches + k1_train + avatar["launches"]
        + human["k1_launches"] + joint["k1_launches"]
        + joint["k1_after_train"] + evaln["k1_launches"]
        + evaln["fast_launches"] + sum(BANDS) + scale["anim_k1"]
        + scale["dp_k1"] + gauss_k1 + sum(recipe_by_path["K1"].values())
        + sc["k1_launches"] + scaling["sizing_k1"],
        "launches_by_path": {"serving": launches, "training": k1_train,
                             "avatar": avatar["launches"],
                             "human_training": human["k1_launches"],
                             "joint_training": joint["k1_launches"],
                             "joint_main_after_train":
                                 joint["k1_after_train"],
                             "evaluation": evaln["k1_launches"],
                             "fast_path": evaln["fast_launches"],
                             **{f"bands_{n}": scale["bands"][n]["k1_launches"]
                                for n in BANDS},
                             "batched_animate": scale["anim_k1"],
                             "batched_joint_step": scale["dp_k1"],
                             **gauss_by_path["K1"],
                             **recipe_by_path["K1"],
                             "scaling_bench_steps": sc["k1_launches"],
                             "gauss_frag_sizing": scaling["sizing_k1"],
                             "micro_bwd": s3_launches["K1"]},
        "max_abs_err": max(max_err, avatar["max_abs_err"], human["k1_err"],
                           joint["k1_err"], evaln["k1_err"],
                           *(scale["bands"][n]["image_max_abs"]
                             for n in BANDS),
                           gauss["frame"]["image_max_abs"],
                           *(recipes[n]["k1_err"] for n in (
                               "human_avatar", "joint_scene",
                               "surface_scene")),
                           *(c["k1"]["max_abs"]
                             for c in recipes["kernel_parity"]),
                           scaling["frame"]["k1_err"], scaling["sizing_err"]),
        "frame": "serving (phase 2)",
        "ms": serve_t["k1"], "call_ms": serve_t["k1_call"],
        "plain_ms": serve_t["plain"], "bound_ms": serve_t["k1_bound"],
        "bound_by": serve_t["k1_bound_by"], "library_ms": None,
        "yardstick_bound_ms": serve_t["k1_yardstick"],
        "training_frame": {k: train_t[k] for k in (
            "k1", "k1_call", "plain", "k1_bound", "k1_yardstick")},
        "avatar_frame": {k: avatar[k] for k in (
            "launches", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "yardstick_bound_ms", "instances_frame0",
            "budget", "frame_ms", "device_kernels_per_frame")},
        "human_training_frame": {
            "ms": ht["k1"], "call_ms": ht["k1_call"], "plain_ms": ht["plain"],
            "bound_ms": ht["k1_bound"], "bound_by": ht["k1_bound_by"],
            "yardstick_bound_ms": ht["k1_yardstick"],
            "instances": human["instances_frame0"],
            "feat_rows_read": ht["feat_rows_read"]},
        "joint_training_frame": {
            "ms": jt["k1"], "call_ms": jt["k1_call"], "plain_ms": jt["plain"],
            "bound_ms": jt["k1_bound"], "bound_by": jt["k1_bound_by"],
            "yardstick_bound_ms": jt["k1_yardstick"],
            "instances": joint["instances_frame0"],
            "feat_rows_read": jt["feat_rows_read"],
            "launches_per_step": joint["launches_per_step"][0]},
        "evaluation_frame": {
            "ms": et["k1"], "call_ms": et["k1_call"], "plain_ms": et["plain"],
            "bound_ms": et["k1_bound"], "bound_by": et["k1_bound_by"],
            "yardstick_bound_ms": et["k1_yardstick"],
            "instances": evaln["instances_frame0"],
            "feat_rows_read": et["feat_rows_read"],
            "budget": evaln["budget"], "stage_s": evaln["stage_s"],
            "fast_frame_ms": evaln["fast_frame_ms"],
            "fast_stage_ms": evaln["fast_stage_ms"],
            "fast_device_kernels_per_frame":
                evaln["fast_device_kernels_per_frame"],
            "fast_device_idle_share": evaln["fast_device_idle_share"]},
        "bands_frame": {n: {k: b[k] for k in (
            "band_rows", "instances", "feat_rows_read", "k1_ms",
            "k1_bound", "k1_bound_by", "k1_launches",
            "image_max_abs") if k in b} for n, b in scale["bands"].items()},
        "gauss_frame": {
            **{k: gauss["frame"][k] for k in (
                "rows", "kept", "fragments", "budget", "k1_launches",
                "image_max_abs", "peak_gib", "render_peak_gib", "pack_ms",
                "sort_ms")},
            **{where: {k: gauss["frame"][where][k] for k in (
                "k1_ms", "k1_bound", "k1_bound_by", "instances",
                "feat_rows_read")} for where in ("fragments", "bins")}},
        "gauss_main": {k: gauss["main"][k] for k in (
            "main_s", "k1", "render_frame_max_abs")},
        "graft_entry": gauss["graft_entry"],
        "scaling_bench": {k: sc[k] for k in (
            "procs", "mesh", "step_ms", "step_ms_events_median", "px_per_s",
            "grad_allreduce_ms", "grad_payload_mb", "comm_fraction",
            "budget", "device_profile", "k1_launches", "k2_launches")},
        "gauss_frag_sizing": {k: scaling["sizing"][k] for k in (
            "ranks", "measured_per_pair_max", "measured_per_band_max",
            "frag_cap_recommended", "k1_launches")},
        "pergs_frame": gauss["pergs"],
        "batched_animate_ms_per_frame": scale["anim_ms"],
        "ms_at_s2_blendmix_rate": at_s2["K1"],
        "cull_dropped_share": {"serving": cull_serve["K1_dropped"],
                               "training": cull_train["K1_dropped"],
                               "avatar": avatar["cull_dropped_share"],
                               "human_training": human["cull"]["K1_dropped"],
                               "joint_training": joint["cull"]["K1_dropped"],
                               "evaluation": evaln["cull"]["K1_dropped"]},
        "convergence_recipes": {
            "phase_s": recipes["phase_s"],
            **{n: {k: recipes[n][k] for k in (
                "steps_per_s", "psnr", "k1_launches", "k2_launches",
                "gt_k1_launches", "k1_err")} for n in (
                "human_avatar", "joint_scene", "surface_scene")},
            "kernel_parity": {c["case"]: {
                "n_instances": c["n_instances"], "budget": c["budget"],
                "max_chunks_per_tile": c["max_chunks_per_tile"],
                "max_abs_dimg": c["max_abs_dimg"],
                "rel_dgrad": max(c["rel_dgrad"].values()),
                "k1_max_abs": c["k1"]["max_abs"],
                "k2_max_abs": c["k2"]["max_abs"],
                "k2_rel_norm": c["k2"]["worst_column_rel_norm"]}
                for c in recipes["kernel_parity"]}},
        **resources["K1"],
        "held_to": "plain_blend", "ok": True,
    }, {
        "name": "K2 blend_bwd", "route": "cuda",
        "source": "hugs_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "hugs_tpu/render/pallas_blend.py:486",
        "launches": k2_train + human["k2_launches"] + joint["k2_launches"]
        + sum(BANDS) + scale["dp_k2"] + gauss_k2
        + sum(recipe_by_path["K2"].values()) + sc["k2_launches"],
        "launches_by_path": {"serving": k2_serve, "training": k2_train,
                             "avatar": avatar["k2_launches"],
                             "human_training": human["k2_launches"],
                             "joint_training": joint["k2_launches"],
                             **{f"bands_{n}": scale["bands"][n]["k2_launches"]
                                for n in BANDS},
                             "batched_joint_step": scale["dp_k2"],
                             **gauss_by_path["K2"],
                             **recipe_by_path["K2"],
                             "scaling_bench_steps": sc["k2_launches"],
                             "micro_bwd": s3_launches["K2"]},
        "max_abs_err": max(k2_err, human["k2_err"], joint["k2_err"],
                           scaling["frame"]["k2_err"],
                           *(scale["bands"][n]["grad_max_abs"]
                             for n in BANDS),
                           gauss["frame"]["grad_max_abs"],
                           *(c["k2"]["max_abs"]
                             for c in recipes["kernel_parity"])),
        "frame": "training step 0 (view 0)",
        "ms": train_t["k2"], "call_ms": train_t["k2_call"],
        "plain_ms": train_t["plain_bwd"], "bound_ms": train_t["k2_bound"],
        "bound_by": train_t["k2_bound_by"], "library_ms": None,
        "yardstick_bound_ms": train_t["k2_yardstick"],
        "serving_frame": {k: serve_t[k] for k in (
            "k2", "k2_call", "plain_bwd", "k2_bound", "k2_yardstick")},
        "human_training_frame": {
            "ms": ht["k2"], "call_ms": ht["k2_call"],
            "plain_ms": ht["plain_bwd"], "bound_ms": ht["k2_bound"],
            "bound_by": ht["k2_bound_by"],
            "yardstick_bound_ms": ht["k2_yardstick"],
            "instances": human["instances_frame0"],
            "feat_rows_read": ht["feat_rows_read"],
            "pairs_walked_blended": human["pairs_frame0"],
            "step_ms": human["stage_ms"],
            "device_kernels_per_step": human["device_kernels_per_step"],
            "device_idle_share": human["device_idle_share"]},
        "joint_training_frame": {
            "ms": jt["k2"], "call_ms": jt["k2_call"],
            "plain_ms": jt["plain_bwd"], "bound_ms": jt["k2_bound"],
            "bound_by": jt["k2_bound_by"],
            "yardstick_bound_ms": jt["k2_yardstick"],
            "instances": joint["instances_frame0"],
            "feat_rows_read": jt["feat_rows_read"],
            "pairs_walked_blended": joint["pairs_frame0"],
            "launches_per_step": joint["launches_per_step"][1],
            "step_ms": joint["stage_ms"],
            "device_kernels_per_step": joint["device_kernels_per_step"],
            "device_idle_share": joint["device_idle_share"]},
        "bands_frame": {n: {k: b[k] for k in (
            "band_rows", "instances", "feat_rows_read", "k2_ms",
            "k2_bound", "k2_bound_by", "k2_launches",
            "grad_max_abs") if k in b} for n, b in scale["bands"].items()},
        "gauss_frame": {
            **{k: gauss["frame"][k] for k in (
                "k2_launches", "grad_max_abs", "grad_rel_norm")},
            **{where: {k: gauss["frame"][where][k] for k in (
                "k2_ms", "k2_bound", "k2_bound_by")}
               for where in ("fragments", "bins")}},
        "gauss_step": {k: gauss["steps"][k] for k in (
            "losses", "n_alive", "stage_ms", "k2_launches")},
        "batched_joint_step": {
            "batch": DP_BATCH, "steps": DP_STEPS, "step_ms": scale[
                "dp_stage_ms"], "launches_per_step":
                scale["dp_launches_per_step"],
            "device_kernels_per_step": scale["dp_device_kernels_per_step"],
            "device_idle_share": scale["dp_device_idle_share"],
            "loss_abs_err": scale["dp_loss_abs_err"],
            "multi_rank": scale["multi_rank"]},
        "ms_at_s2_blendmix_rate": at_s2["K2"],
        "cull_dropped_share": {"serving": cull_serve["K2_dropped"],
                               "training": cull_train["K2_dropped"],
                               "human_training": human["cull"]["K2_dropped"],
                               "joint_training": joint["cull"]["K2_dropped"]},
        **resources["K2"],
        "held_to": "plain_blend_bwd", "ok": True,
    }, *({
        "name": f"{k} {fn}, POWER_MXU mode", "route": "cuda",
        "source": f"hugs_tpu_torch/csrc/{fn}.cu",
        "replaces": f"hugs_tpu/render/pallas_blend.py:{line}",
        "mode": "power_mxu: the exponent as the recentred-basis product "
                f"(_grid_basis :116, _power_mxu :149, _chunk_alpha :279, "
                f"called at {calls}), on the tensor cores (mma.sync)",
        "launches": mxu[k.lower() + "_launches"],
        "launches_by_path": {
            "serving, render() default": mxu["serve_k1"] if k == "K1" else 0,
            "training, render() default": MXU_STEPS},
        "max_abs_err": max(
            *(mxf[f][k.lower() + "_max_abs"] for f in mxf),
            *(c[k.lower()]["max_abs"] for c in mxu_parity)),
        "frame": f"{frame} (phases 2, 3b)",
        "ms": statistics.median(mxf[frame][k.lower() + "_mxu_ms"]),
        "call_ms": mxf[frame][k.lower() + "_mxu_call_ms"],
        "exact_ms_same_call": statistics.median(
            mxf[frame][k.lower() + "_exact_ms"]),
        "plain_ms": mxf[frame]["plain_mxu_ms" if k == "K1"
                              else "plain_bwd_mxu_ms"],
        "bound_ms": mxf[frame][k.lower() + "_bound"]["bound_ms"],
        "bound_by": mxf[frame][k.lower() + "_bound"]["bound_by"],
        "library_ms": None,
        "frames": {f: {key: r[key] for key in (
            k.lower() + "_mxu_ms", k.lower() + "_mxu_call_ms",
            k.lower() + "_exact_ms",
            k.lower() + "_bound", k.lower() + "_max_abs", "pixels_beyond",
            "pixels_at_cutoff", "vs_exact_max_abs", "vs_exact_share",
            "cull")} for f, r in mxf.items()},
        "loss_rel_vs_exact": mxu["loss_rel"],
        "phase_s": mxu["phase_s"],
        **mxu["resources"][k],
        "held_to": "plain_blend(power_mxu=True)" if k == "K1"
                   else "plain_blend_bwd(power_mxu=True)", "ok": True,
    } for k, fn, line, calls, frame in (
        ("K1", "blend_fwd", 354, ":365, :428", "serving"),
        ("K2", "blend_bwd", 486, ":499, :589", "training"))), *micro]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def gauss_rank_check(rank, world, cfg, device_type="cuda"):
    """--scale-out's Gaussian-sharded check on rank `rank` of `world`
    NCCL ranks (card `rank`; gloo on the CPU for a rehearsal): a
    scene-mode trainer of cfg (tpu.gauss_shard = world) on phase 3f's
    sequence, rank 0's scene on every rank; val frame 0 through
    render_frame on the world's mesh and alone; then the Gaussian-
    sharded step on the world's mesh for GAUSS_STEPS[0] steps, a densify
    fed the same noise on every rank, GAUSS_STEPS[1] more, and on rank 0
    the same on a mesh of one rank. Returns the images' difference, the
    losses, n_alive and the launches."""
    from hugs_tpu_torch import main as cli
    from hugs_tpu_torch.parallel.collectives import broadcast_
    from hugs_tpu_torch.parallel.gauss_train import (
        gauss_densify_step, make_gauss_scene_train_step, shard_scene_state,
    )
    from hugs_tpu_torch.parallel.mesh import GAUSS, Mesh, make_gauss_mesh
    from hugs_tpu_torch.render import cuda_blend
    from hugs_tpu_torch.train import checkpoint as ckpt_io
    from hugs_tpu_torch.train.trainer import GaussianTrainer

    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_ds, val_ds, _ = cli.build_datasets(cfg, dev)
    tr = GaussianTrainer(cfg, train_ds, val_ds, device=dev)
    mesh = make_gauss_mesh(world)
    broadcast_([t.data for t in ckpt_io.flatten(tr.scene).values()], mesh)
    d = val_ds[0]
    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    shared = tr.render_frame(d)["render"]
    k1_frame = cuda_blend.LAUNCHES
    tr.cfg.tpu.gauss_shard = 0
    alone = tr.render_frame(d)["render"]
    tr.cfg.tpu.gauss_shard = world
    diff = (shared - alone).abs()
    black = torch.zeros(3, device=dev)
    n = len(train_ds)

    def steps(m):
        n_ranks = m.axis_size(GAUSS)
        st = shard_scene_state(tr.scene, m)
        step = make_gauss_scene_train_step(
            m, width=d["width"], height=d["height"], l1_w=cfg.scene.loss.l1_w,
            ssim_w=cfg.scene.loss.ssim_w,
            local_budget=max(tr._ibudget // n_ranks, 1 << 12))
        g = torch.Generator(device=dev).manual_seed(SEED + 47)
        noise = torch.randn((2, tr.scene.gs.capacity, 3), generator=g,
                            device=dev)
        losses, n_alive = [], None
        for i in range(sum(GAUSS_STEPS)):
            if i == GAUSS_STEPS[0]:
                _, info = gauss_densify_step(
                    st, m, noise, float(tr.scene_extent),
                    grad_threshold=cfg.scene.densify_grad_threshold,
                    min_opacity=cfg.scene.prune_min_opacity,
                    percent_dense=cfg.scene.percent_dense)
                n_alive = int(info["n_alive"])
            fr = train_ds[i % n]
            st, aux = step(st, fr["camera"], fr["rgb"], black,
                           tr.s_xyz_sched(i), tr.s_static_lrs)
            losses.append(float(aux["loss"]))
            if bool(aux["overflowed"]):
                raise AssertionError(f"gauss step {i} overflowed on "
                                     f"{n_ranks} ranks")
        return {"losses": losses, "n_alive": n_alive,
                "frag_counts": aux["frag_counts"].cpu().numpy().tolist()}

    cuda_blend.LAUNCHES = cuda_blend.K2_LAUNCHES = 0
    shard = steps(mesh)
    k12 = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES)
    return {"image_share": float((diff <= PIXEL_ATOL).float().mean()),
            "image_max_abs": float(diff.max()), "k1_frame": k1_frame,
            "sharded": shard, "k1_k2_steps": k12,
            "world1": steps(Mesh.line(GAUSS)) if rank == 0 else None}


def gauss_cards_check(smi, root, device_type="cuda"):
    """--scale-out's gauss_shard=GAUSS_SCALE_OUT check: gauss_rank_check
    on that many NCCL ranks, held to the world-1 run (the image at the
    image bar, the loss each step at GAUSS_LOSS_RTOL, n_alive equal);
    then dryrun_multichip on as many. Returns its numbers, or None (and
    says so) with fewer cards."""
    from hugs_tpu_torch import graft_entry
    from hugs_tpu_torch.parallel.launch import run_ranks

    n_cards = (torch.cuda.device_count() if device_type == "cuda"
               else GAUSS_SCALE_OUT)
    if n_cards < GAUSS_SCALE_OUT:
        print(f"# gauss_shard={GAUSS_SCALE_OUT}: not run, "
              f"torch.cuda.device_count() = {n_cards}")
        return None
    cfg = joint_config(root, "scale_out_gauss", {
        "mode": "scene", "tpu.gauss_shard": GAUSS_SCALE_OUT})
    t0 = time.time()
    ranks = run_ranks(gauss_rank_check, GAUSS_SCALE_OUT, (cfg, device_type),
                      backend="nccl" if device_type == "cuda" else "gloo",
                      timeout=DP_TIMEOUT)
    gauss_s = time.time() - t0
    ref = ranks[0]["world1"]
    print(f"# gauss_shard={GAUSS_SCALE_OUT}: val frame 0 on the "
          f"{GAUSS_SCALE_OUT} ranks vs alone: "
          f"{[round(r['image_share'] * 100, 4) for r in ranks]}% within "
          f"{PIXEL_ATOL}, max |d| {[r['image_max_abs'] for r in ranks]}; "
          f"losses {[r['sharded']['losses'] for r in ranks]} against "
          f"world 1's {ref['losses']}; n_alive "
          f"{[r['sharded']['n_alive'] for r in ranks]} against "
          f"{ref['n_alive']}; K1 / K2 in the steps "
          f"{[r['k1_k2_steps'] for r in ranks]}; frag_counts "
          f"{ranks[0]['sharded']['frag_counts']}; {gauss_s:.1f} s (host "
          f"clock)  [{smi}]")
    for r in ranks:
        if r["image_share"] < MIN_SHARE or r["image_max_abs"] > MAX_ABS:
            raise AssertionError("the sharded image differs from world 1's")
        if r["sharded"]["n_alive"] != ref["n_alive"]:
            raise AssertionError("the sharded densify's n_alive differs")
        for a, b in zip(r["sharded"]["losses"], ref["losses"]):
            if not abs(a - b) <= GAUSS_LOSS_RTOL * abs(b):
                raise AssertionError(f"sharded loss {a} against {b}")
        steps = sum(GAUSS_STEPS)
        if r["k1_k2_steps"] != (steps, steps):
            raise AssertionError(f"K1 / K2 {r['k1_k2_steps']} in {steps} "
                                 f"steps")
    t0 = time.time()
    dry = graft_entry.dryrun_multichip(GAUSS_SCALE_OUT, device_type,
                                       timeout=DP_TIMEOUT)
    dry_s = time.time() - t0
    print(f"# dryrun_multichip({GAUSS_SCALE_OUT}): mesh {dry[0]['mesh']}, "
          f"losses {[r['loss'] for r in dry]}, gauss losses "
          f"{[r['gauss_loss'] for r in dry]}; {dry_s:.1f} s (host clock)")
    return {"ranks": GAUSS_SCALE_OUT, "s": gauss_s,
            "image_max_abs": [r["image_max_abs"] for r in ranks],
            "losses": [r["sharded"]["losses"] for r in ranks],
            "world1_losses": ref["losses"], "n_alive": ref["n_alive"],
            "frag_counts": ranks[0]["sharded"]["frag_counts"],
            "dryrun": {"mesh": dry[0]["mesh"],
                       "losses": [r["loss"] for r in dry],
                       "gauss_losses": [r["gauss_loss"] for r in dry],
                       "s": dry_s}}


def scale_out_cards():
    """`python3 chip_smoke.py --scale-out`: phase 3h's checks (c) and (d)
    alone, for a machine with several cards (the data x tile step on up
    to DP_RANKS_MAX of them against the batched step at world size 1),
    on phase 3f's sequence trained with SCALE_OUT_CUTS; the
    Gaussian-sharded check; then scaling_cards (the scaling harness at 1,
    2 and 4 cards, the sizing on 4). Prints one JSON line of its numbers
    last; raises if a check fails."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from hugs_tpu_torch import build
    from hugs_tpu_torch import main as cli
    from hugs_tpu_torch.render import cuda_blend

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    print(smi)
    t0 = time.time()
    build.build([cuda_blend.SOURCE, cuda_blend.BWD_SOURCE])
    with tempfile.TemporaryDirectory() as root:
        write_neuman_sequence(root, dev, smi)
        cfg = joint_config(root, "scale_out", SCALE_OUT_CUTS)
        if cli.main(cfg, device=dev) != 0:
            raise AssertionError("hugs_tpu_torch.main.main failed")
        train_ds, _, _ = cli.build_datasets(cfg, dev)
        dcfg = dp_config(cfg)
        step = batched_step_check(dev, smi, dcfg, train_ds)
        del train_ds
        torch.cuda.empty_cache()    # rank 0 of check (d) shares this card
        multi = multi_card_check(smi, dcfg, step["dp_loss"])
        torch.cuda.empty_cache()
        gauss = gauss_cards_check(smi, root)
        torch.cuda.empty_cache()
        scaling = scaling_cards(smi, os.path.join(root, "scaling_bench"))
    print(f"# --scale-out: {time.time() - t0:.1f} s (host clock)  [{smi}]")
    print(json.dumps({"scale_out": {
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "card": smi,
        "batched_step": step, "multi_rank": multi, "gauss_shard": gauss,
        "scaling": scaling}}))
    return 0


if __name__ == "__main__":
    sys.exit(scale_out_cards() if sys.argv[1:] == ["--scale-out"]
             else main())
