#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Identifies the card (nvidia-smi name and power limit, torch and CUDA
   versions); exits non-zero without a card.
2. Builds the CUDA kernels from ``eve_tpu_torch/csrc`` with nvcc.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at N=0, 1, 17, 30, 80, 240, 3840 (render for sigma 10, 3, 5 one at
   a time, sigmas 10 and 3 in one launch as ``create_images`` draws them,
   and all three with a validity mask in one launch; soft-argmax of 72x128
   maps in float32 and bfloat16, and of 144x256 maps at N=1, 17, 80; one
   backward through each custom op). Times both at the serving
   path's N=80 and the Codalab path's N=3840 (render also at S=3) beside an
   empty kernel of the same launch shape, the launch floor, and checks the
   soft-argmax's cluster choice at N=3840.
4. Serve phase: the full-width ``configs/refine_net.json`` model (128x128
   eyes, CLSTM RefineNet, screen content) on seeded random weights, behind
   ``ServingEngine(device='cuda', max_batch=8)``: 8 sessions x 3 consecutive
   T=10 chunks plus 2 session-less requests, uint8 frames as a client sends
   them, one request over HTTP. Checks finite outputs of the right shapes,
   that each kernel launched once a dispatch, that each session's chunks
   equal one T=30 forward, and that one clip on the card matches the port's
   CPU forward; then profiles one serving-shaped forward (torch.profiler)
   and runs one forward with ground-truth labels (B=8, T=10), which must
   launch the render twice and derive the CPU's labels.
5. Training phase: the full-width ``configs/refine_net.json`` model
   (frozen GRU-128 EyeNet, CLSTM-64 RefineNet with screen content and
   skips), ``batch_size`` 8, T = 30, ``eye_net_load_pretrained`` overridden
   to false (seeded ``init_weights`` instead), trained through
   ``harness.Experiment``, ``init_datasets`` and ``main_loop_iterator`` on
   an in-memory dataset of synthetic clips (a class with the EVE reader's
   constructor, so the harness's spec tuples build it): 8 optimizer steps with a
   checkpoint and a live validation at step 4, then a fresh ``Experiment``
   resumed from that checkpoint runs steps 5-8 again. Checks finite
   losses, a bitwise unchanged EyeNet and a changed RefineNet, the
   checkpoint files, the resumed losses against the uninterrupted run's,
   the launches of each kernel per training step and per eval batch, one
   step on the card against the same step on the CPU (B = 2, T = 10), and
   prints step time, frames/s, peak memory, a profile of one step (the
   heatmap kernels' share included) and its forward, backward and update
   times.
6. Train-CLI phase: (a) ``eve_tpu_torch.cli.train.run`` (the CLI after its
   dataset specs) in child processes, on in-memory clips:
   ``configs/refine_net.json`` at full width, ``eye_net_load_pretrained``
   false, ``fully_reproducible``, ``--auto-resume yes``, checkpoints, live
   validation and images every 4 steps, the profiler on, a 1/100 learning
   rate (see CLI_BASE_LR), 96 clips (12 steps) and the final full test.
   An uninterrupted run; then a run that gets SIGTERM once its log shows
   step 6, which must exit 143 within a minute with a checkpoint at the
   step its log names, and a restart with the same argv, which must log
   ``auto_resume: continuing <dir>``, take the remaining steps, run the
   final test and exit 0. Checks the losses of the preempted and resumed
   run against the uninterrupted run's within ``RESUME_LOSS_TOL`` (and that
   they leave it shifted by a step), eve_tpu's image tags, finite and in
   [0, 1], at steps 4, 8 and 12, a non-empty profiler trace, and the
   kernel launches of the whole run. (b) ``train_batch_echoing`` 2 with
   two training sources for 4 steps in process: half as many batches
   loaded as steps, render 6 and soft-argmax 2 launches a step (twice one
   source's), ``full_loss`` the sum of the sources'. (c)
   ``configs/eye_net.json`` at its own width (B = 16, T = 30, EyeNet
   trainable) for 6 steps: step time, frames/s, peak memory, a profiled
   step, no heatmap kernel launched, and one B = 2, T = 10 step against the
   CPU (with cuDNN and without it) with the CPU's own spread under a 1e-7
   weight perturbation printed beside it.
7. Eval phase: the full-width ``configs/refine_net.json`` model on seeded
   random weights, written as a checkpoint in eve_tpu's layout with the
   port's ``train/checkpoint`` writer and read back bitwise through
   ``infer.model_setup(resume_from=...)``. (b) One synthetic labelled video
   of 3 x 30 frames streams at batch 1 through
   ``infer.iterator(streaming=True, create_images=True)``: every image
   output finite, the PoGs equal to one T=90 forward, the first chunk's
   outputs equal to the port's CPU forward, render 2 and soft-argmax 1
   launches a chunk. (c) 136 synthetic clips of T=30 without gaze labels,
   in 4 (participant, subfolder, camera) sequences, go through the port's
   ``DataLoader`` at ``codalab_eval_batch_size`` 128 (a full batch and a
   ragged one), ``infer.iterator(create_images=False,
   materialize_inputs=False)``, ``eval_codalab.collect`` and
   ``write_submission``: the nesting, lengths and int64 stamps of the
   pkl.gz, the zip, the ragged batch's clips against the same clips inside
   a full batch, render 1 and soft-argmax 1 launches a batch. Prints eval
   clips/s and frames/s, batch wall times, the device-busy share of one
   profiled batch and the peak memory. The EVE dataset reader and the
   overlay video (``h5py``, ``cv2``, ``ffmpeg``, which the card's machine
   lacks) are held against eve_tpu by the CPU tests instead; here the clips
   are in memory.
8. bfloat16 phase (``tpu_compute_dtype='bfloat16'``, full width): (a) the
   serve phase's weights and sessions behind ``ServingEngine`` (each
   session's chunks against one T=30 forward, 4 clips against the port's
   CPU bfloat16 forward, both within the card's own bfloat16-vs-float32
   drift on the same clips; forward hooks: every ResNet and RefineNet
   convolution receives bfloat16 and the GRU float32; a profiled B=8,
   T=10 forward whose convolution kernels must include bfloat16 ones); (b)
   6 ``configs/refine_net.json`` steps at B = 8, T = 30 and (c) 6
   ``configs/eye_net.json`` steps at B = 16, T = 30 through the harness,
   parameters and Adam's moments float32, each with a profiled step, and
   one B = 2, T = 10 bfloat16 step against the CPU (RefineNet gradients
   within their bfloat16-vs-float32 drift); (d)
   one Codalab batch of 128 x 30 through ``infer.iterator``. Step times,
   frames/s, batch walls and peak memory are printed beside the float32
   figures of the same run, and both kernels' launches are counted on
   every path.
9. Serving-modes phase (slice F, after the serve phase): the serve
   phase's model, weights and sessions at float32 and bfloat16, through
   ``ServingEngine`` in each of its three ways: the default engine (host
   stacking, float32 host states), ``device_resident=True`` (states and
   batch assembly on the card) and device-resident with the inputs already
   on the card (loopback). Each dispatch runs the same batch (a round of
   the 8 sessions' chunk c, then 2 session-less requests); the resident
   outputs and session states must equal the default engine's (bitwise,
   or within the chunked-vs-whole tolerances with the difference printed),
   each kernel launches once a dispatch, and each mode prints a dispatch's
   wall time, device-busy time (profiler), host time (their difference)
   and the bytes copied each way (the profiler trace's memcpy events).
10. Native phase (slice G, last): ``configs/refine_net.json`` with
   ``tpu_native_arch`` (the patchify EyeNet stem, RefineNetTPU, the
   'heatmap' readout) at full width, at float32 and bfloat16: (a) served
   in the three ways as in 9, chunks vs one T=30 forward and 4 clips card
   vs CPU, a profiled B=8, T=10 forward, peak memory; (b) 4 training steps
   at B = 8, T = 30 through the harness (render 3 and soft-argmax 1 a
   step), the last checkpoint read back bitwise through
   ``infer.model_setup``, a profiled step and (float32) one B = 2, T = 10
   step card vs CPU; (d) one Codalab batch of 128 x 30; then (c)
   ``configs/eye_net.json`` with the patchify stem (6 steps at B = 16 and
   card vs CPU gradients) and one labelled forward each of the 'gated'
   readout and the 'patchify8' stem. Every figure is printed beside the
   reference topology's of the same run.
11. Export phase (slice H, and remat): (a) the serve phase's weights,
   written as a checkpoint, exported through ``cli.export_model`` in two
   child processes at once (``--export-child``), a streaming and a
   non-streaming artifact at B = 8, T = 10 with uint8 frames: the export's
   wall time and file size, no kernel launched by tracing; (b) in a child
   process that imports nothing of ``eve_tpu_torch.models``
   (``--artifact-serve-child``), ``ServingEngine(artifact=)`` serves the
   serve phase's rounds, counted (render 1 and soft-argmax 1 a dispatch)
   and timed as the serving-modes phase times them; outputs and session
   states held against the live default engine's of phase 9 (bitwise, or
   within the chunked-vs-whole tolerances with the difference printed); a
   foreign signature raises; the non-streaming artifact refuses a session
   and serves the session-less round; one request over HTTP through
   ``python -m eve_tpu_torch.cli.serve --serve-artifact``; (c) a bfloat16
   and a native forward exported in process, one dispatch of each held to
   the live forward (bfloat16 within its drift, native within the float32
   tolerance); (d) ``tpu_remat`` 'refine' and 'all' on
   ``configs/refine_net.json`` (B = 8, T = 30) and 'eye' on
   ``configs/eye_net.json`` (B = 16): step ms and peak memory beside the
   same model without remat, gradients within the card's float32 limits
   of those without.
12. Data-parallel phase (slice I, on the one card, last): (a) the
   serving-modes phase's float32 sessions through ``ServingEngine(mesh=)``
   of ``make_mesh(1)``, and of two replicas sharing cuda:0 with
   ``device_resident`` off and on: outputs and session states held against
   the default engine's at the serving tolerance, each kernel launched once
   a dispatch and replica, a dispatch's wall, device and host ms; (b) the
   Codalab clips through ``infer.iterator(mesh=)`` of two replicas against
   the same batches on one device (the ragged batch padded and cut),
   frames/s and peak memory beside one device's; (c) ``cli.train.run`` in
   child processes (``--dp-child``, torchrun-style environments) for
   DP_STEPS steps and the final test: one process, a one-rank world over
   NCCL, and two ranks over gloo that share cuda:0 (B = 4 each; only rank 0
   writes), each rank's losses within rtol 1e-4 of the one process's and
   its parameters within the CPU tests' Adam-update limits, step ms beside
   the one process's; then SIGTERM to rank 1 of two: both exit 143 at the
   agreement step, and both restarted continue there. No multi-GPU figure:
   the card is one.
13. Prints the kernel table as one JSON line, the card, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the run exits non-zero without the last line.
Imports nothing of JAX or eve_tpu.
"""

import http.client
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'refine_net.json')
# Run directories of the training and eval phases (git-ignored).
TRAIN_OUT = os.path.join(ROOT, 'build', 'chip_smoke_train')
EVAL_OUT = os.path.join(ROOT, 'build', 'chip_smoke_eval')
CLI_OUT = os.path.join(ROOT, 'build', 'chip_smoke_cli')
SERVE_OUT = os.path.join(ROOT, 'build', 'chip_smoke_serve')
EXPORT_OUT = os.path.join(ROOT, 'build', 'chip_smoke_export')

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and float32
# (non-tensor-core) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Tolerances on the card.
RENDER_TOL = dict(rtol=1e-6, atol=1e-7)    # same float32 expression, expf
SOFTARGMAX_TOL = dict(rtol=1e-5, atol=1e-3)  # other summation order, px
# Chunked serving vs one T=30 forward: the same operations at other batch
# sizes, so cuDNN may pick other algorithms; the soft-argmax scales
# heatmap differences by up to beta * 1920 px. Held, as the CPU parity
# tests hold PoG px, to rtol 1e-4 plus atol 1e-2 px.
CHUNK_PX_ATOL = 1e-2
# Card vs CPU: cuDNN vs oneDNN float32 convolutions (TF32 off), summed in
# other orders through ~45 layers.
CPU_PX_ATOL = 5e-2
OTHER_ATOL = 1e-3

SESSIONS, CHUNKS, T, MAX_BATCH = 8, 3, 10, 8
# Map counts the kernel phase holds the kernels at (30 = a streamed chunk,
# 80 = the serving shape, 240 = the training shape, 3840 = a Codalab
# batch).
KERNEL_NS = (0, 1, 17, 30, 80, 240, 3840)

# Training phase: configs/refine_net.json's batch and clip length, 8
# optimizer steps (one epoch of TRAIN_STEPS batches), a checkpoint and a
# live validation every SAVE_EVERY steps, the resume from step SAVE_EVERY.
TRAIN_B, TRAIN_T, TRAIN_STEPS, SAVE_EVERY = 8, 30, 8, 4
VAL_CLIPS = 16
# Card vs CPU training step.
CMP_B, CMP_T = 2, 10
# The resumed steps' full_loss against the uninterrupted run's: the card's
# cuDNN backward algorithms and upsample_bilinear2d's backward (atomics)
# are not bitwise deterministic, and Adam carries those last-bit
# differences through 4 updates; deterministic algorithms are not an
# option (that upsample backward raises under them).
RESUME_LOSS_TOL = dict(rtol=1e-3, atol=1e-5)
# Card vs CPU, one training step from the same seeded weights (not the
# trained ones, which differ from run to run on the card), batch and
# kappas: cuDNN (FFT and implicit-GEMM float32 convolutions, TF32 off) vs
# oneDNN, summed in other orders through ~50 layers forward and back.
# RefineNet's float32 gradient is ill-conditioned: a max-pool window whose
# two largest inputs lie within rounding routes its gradient to either, so
# at these weights the CPU's own gradient moves by up to ~1% of a layer's
# largest element when every weight is scaled by (1 + 1e-7 N(0, 1)) (the
# script prints that spread beside each error). So each RefineNet gradient
# is held as the CPU parity tests hold RefineNet against eve_tpu: its L2
# error within CMP_GRAD_L2 of its layer's gradient norm, and every element
# within CMP_GRAD_ELEM of its layer's largest element (a layer is a
# module's weight and bias together: a bias that an instance norm follows
# has a true gradient of 0, and either device computes float32 noise for
# it).
CMP_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
CMP_GRAD_L2, CMP_GRAD_ELEM, CMP_PERTURB = 3e-2, 0.1, 1e-7
CMP_CARD_STEPS = 4

# Train-CLI phase: configs/refine_net.json at B = TRAIN_B, T = TRAIN_T on
# CLI_CLIPS clips (one epoch of CLI_STEPS steps), a checkpoint, a live
# validation and images every CLI_EVERY steps; SIGTERM once the log shows
# step CLI_PREEMPT_AFTER, and the exit 143 within CLI_EXIT_TIMEOUT seconds.
CLI_STEPS, CLI_EVERY, CLI_PREEMPT_AFTER, CLI_EXIT_TIMEOUT = 12, 4, 6, 60
CLI_CLIPS = CLI_STEPS * TRAIN_B
# The CLI runs' base_learning_rate, 1/100 of the config's: two
# uninterrupted runs on the card are not bitwise equal (cuDNN's backward
# and the upsample backward's atomics), and at the config's rate Adam
# carries those last bits to 4e-4 of full_loss by step 4 and 1.2e-2 by
# step 12 (measured), beyond RESUME_LOSS_TOL whatever the resume does.
# At this rate a batch or kappa draw out of place still moves full_loss by
# far more than the tolerance (checked in the run against the
# uninterrupted losses shifted by a step).
CLI_BASE_LR = 1e-5
# Echoing and two sources: train_batch_echoing ECHO, ECHO_STEPS steps.
ECHO, ECHO_STEPS = 2, 4
# configs/eye_net.json: its batch of 16, EYE_STEPS steps; card vs CPU at
# B = EYE_CMP_B, T = EYE_CMP_T. The CPU parity tests hold the EyeNet's
# gradients against eve_tpu (tests/test_torch_train_step.py; 48x48 eyes,
# T = 3) with each element within 2e-3 of its tensor's largest element and
# each tensor's L2 error within 1e-3 of its norm. At full width those do
# not hold, on the card nor between two CPU runs a rounding apart: the
# CPU's own gradient moves by up to 1.8e-3 (element) and 3.2e-4 (L2) when
# every weight is scaled by (1 + 1e-7 N(0, 1)), and the card's, whose
# forward differs from the CPU's by ~1e-6 relative, by up to 2.0e-2 and
# 2.1e-3, with cuDNN or without it (measured): ReLU gates and max-pool
# windows that rounding tips one way or the other route the gradient of
# 40 eyes of 128x128 otherwise, as in RefineNet. So the EyeNet is held as
# the RefineNet is, each tensor within CMP_GRAD_L2 (L2) and CMP_GRAD_ELEM
# (element), plus EYE_GRAD_TOP of the model's largest gradient (biases an
# instance norm cancels have a true gradient of 0), with cuDNN and without
# it (ATen's direct convolutions).
EYE_B, EYE_STEPS = 16, 6
EYE_CMP_B, EYE_CMP_T = 2, 10
EYE_GRAD_TOP = 1e-5
EYE_GRAD_LIMITS = {'card': (CMP_GRAD_ELEM, CMP_GRAD_L2),
                   'card without cuDNN': (CMP_GRAD_ELEM, CMP_GRAD_L2)}

# Eval phase: clips of EVAL_T frames; a video of STREAM_CHUNKS clips
# streamed at batch 1; CODALAB_CLIPS clips in CODALAB_SEQUENCES sequences
# at configs/refine_net.json's codalab_eval_batch_size (128: one full
# batch and a ragged one of 8).
EVAL_T, STREAM_CHUNKS = 30, 3
CODALAB_BATCH, CODALAB_CLIPS, CODALAB_SEQUENCES = 128, 136, 4
CODALAB_N = CODALAB_BATCH * EVAL_T   # maps a Codalab batch renders
# bfloat16 phase: BF16_STEPS training steps. Two faithful bfloat16 runs of
# this model do not agree to bfloat16 precision: a convolution output one
# ulp apart (other summation orders) moves its channel's instance-norm
# statistics and flips other roundings, and that grows through the layers
# (tests/test_torch_bf16.py). So the bfloat16 outputs are held against
# their own bfloat16-vs-float32 drift on the card on the same clips, as
# the CPU tests hold the port against eve_tpu: the chunked sessions against
# one T=30 forward (cuDNN may pick other algorithms at other batch sizes)
# within BF16_CHUNK_RATIO of it, and BF16_CPU_CLIPS clips on the card
# against the port's CPU bfloat16 forward (cuDNN vs oneDNN) within
# BF16_CPU_RATIO of it, for the BF16_KEYS outputs (the pupil head is held
# by the CPU tests: on these weights its ReLU passes too few frames for a
# drift to measure).
BF16_STEPS = 6
BF16_CHUNK_RATIO, BF16_CPU_RATIO, BF16_CPU_CLIPS = 1.0, 1.0, 4
# One bfloat16 training step, card vs CPU (B = CMP_B, T = CMP_T): the
# RefineNet gradients against their bfloat16-vs-float32 drift on the card,
# all layers together within BF16_GRAD_RATIO and each within
# BF16_LAYER_RATIO (the CPU tests' limits against eve_tpu, where the worst
# layer reached 1.07); full_loss within BF16_LOSS_RTOL (bfloat16 keeps ~3
# significant digits; the CPU's own full_loss moves by ~2e-3 of itself
# when the weights are scaled by 1 + CMP_PERTURB N(0, 1), more than its
# bfloat16-vs-float32 drift, so the loss is not held by the drift; the
# script prints that spread).
BF16_GRAD_RATIO, BF16_LAYER_RATIO, BF16_LOSS_RTOL = 1.0, 1.25, 1e-2
BF16_KEYS = ('PoG_px_initial', 'g_initial', 'PoG_px_final', 'g_final')
# Device-resident serving (slice F): the serve phase's sessions in
# ServingEngine's three ways, default (host stacking, float32 host states),
# device_resident with numpy inputs, and device_resident with inputs
# already on the card (loopback); LOOSE session-less requests after them.
SERVING_MODES = ('default', 'resident', 'loopback')
LOOSE = 2
# The opt-in topology (slice G): NATIVE_STEPS training steps a run (the
# last one checkpointed).
NATIVE_STEPS = 4
# Card vs CPU, the create_images maps of one streamed chunk: a heatmap lies
# in [0, 1] and moves with the PoG it is drawn at (CPU_PX_ATOL of PoG, 3e-3
# grid cells, moves a sigma-3 map by up to 7e-4) or with RefineNet's
# float32 output; a history sums at most EVAL_T decayed maps.
MAP_ATOL = 1e-3
HISTORY_ATOL = EVAL_T * MAP_ATOL
# Remat (slice H's share of slice I): timed train_steps a configuration,
# after one warm-up step.
REMAT_STEPS = 3
# Data parallelism (slice I) on one card: mesh serving in three ways (name,
# replicas on cuda:0, device_resident); the data-parallel CLI runs take
# DP_STEPS steps, and the preempted two-rank run DP_PREEMPT_STEPS, stopping
# at the agreement after loop step 8 (the harness agrees every 8 steps).
MESH_SERVE_MODES = (('mesh 1', 1, False), ('mesh 2', 2, False),
                    ('mesh 2 resident', 2, True))
DP_STEPS, DP_PREEMPT_STEPS, DP_PREEMPT_STOP = 3, 10, 9
DP_OUT = os.path.join(ROOT, 'build', 'chip_smoke_dp')


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def time_gpu(fn, iters=50):
    """Device ms per call: a chain of launches timed with CUDA events.

    A long device sleep is queued first, so the host enqueues the whole
    chain before the start event fires and host launch gaps stay out. The
    chain stays short (a plain version is ~8 launches a call) so the
    device's launch queue never fills, which would pace it to the host.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def assert_close(a, b, what, **tol):
    torch.testing.assert_close(a, b, msg=lambda m: '%s: %s' % (what, m),
                               **tol)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def _centres(gen, n, dev):
    return torch.from_numpy(np.stack([
        gen.uniform(-50, 1970, n), gen.uniform(-50, 1130, n)],
        -1).astype(np.float32)).to(dev)


def _masked_centres(gen, n, dev):
    """Centres and a 0/1 mask; the first centre is NaN under a 0."""
    c = _centres(gen, n, dev)
    mask = torch.from_numpy((gen.uniform(size=n) > 0.3).astype(
        np.float32)).to(dev)
    if n:
        c[0] = float('nan')
        mask[0] = 0.0
    return c, mask


def _peaked_maps(gen, n, h, w, dev):
    """Uniform noise plus a bump per map, as a refined heatmap has."""
    x = torch.from_numpy(gen.uniform(0, 1, (n, h, w)).astype(
        np.float32)).to(dev)
    yy, xx = torch.meshgrid(torch.arange(float(h), device=dev),
                            torch.arange(float(w), device=dev),
                            indexing='ij')
    cy = torch.from_numpy(gen.uniform(0, h, (n, 1, 1))).float().to(dev)
    cx = torch.from_numpy(gen.uniform(0, w, (n, 1, 1))).float().to(dev)
    scale = 50.0 * (h * w) / (72 * 128)
    return x + 0.5 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / scale)


def kernel_phase(hk):
    gen = np.random.RandomState(0)
    dev = 'cuda'
    errs = {'render_heatmaps': 0.0, 'soft_argmax': 0.0}
    sigmas = (10.0, 3.0, 5.0)
    for n in KERNEL_NS:
        c = _centres(gen, n, dev)
        for sigma in sigmas:
            ours = hk.render_heatmaps(c, (sigma,))
            ref = hk.make_heatmaps_plain(c, sigma)
            torch.cuda.synchronize()
            assert ours.shape == (1, n, 72, 128)
            assert_close(ours[0], ref, 'render N=%d sigma=%g' % (n, sigma),
                         **RENDER_TOL)
            errs['render_heatmaps'] = max(errs['render_heatmaps'],
                                          max_err(ours[0], ref))
        # create_images' form: the initial and the history sigma, one launch.
        ours = hk.render_heatmaps(c, sigmas[:2])
        ref = hk.make_heatmaps_multi_plain(c, sigmas[:2])
        torch.cuda.synchronize()
        assert ours.shape == (2, n, 72, 128)
        assert_close(ours, ref, 'render S=2 N=%d' % n, **RENDER_TOL)
        errs['render_heatmaps'] = max(errs['render_heatmaps'],
                                      max_err(ours, ref))
        # The label path's form: three sigmas and a validity mask, one
        # launch; the NaN centre under mask 0 stays NaN, as hm * mask does.
        cm, mask = _masked_centres(gen, n, dev)
        ours = hk.render_heatmaps(cm, sigmas, mask)
        ref = hk.make_heatmaps_multi_plain(cm, sigmas, mask)
        torch.cuda.synchronize()
        assert ours.shape == (3, n, 72, 128)
        assert_close(ours, ref, 'render S=3 masked N=%d' % n,
                     equal_nan=True, **RENDER_TOL)
        if n:
            assert bool(torch.isnan(ours[:, 0]).all())
            errs['render_heatmaps'] = max(errs['render_heatmaps'],
                                          max_err(ours[:, 1:], ref[:, 1:]))
    for n, (h, w) in [(n, (72, 128)) for n in KERNEL_NS] + [
            (n, (144, 256)) for n in (1, 17, 80)]:
        x = _peaked_maps(gen, n, h, w, dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype).contiguous()
            ours = hk.soft_argmax(xd, heatmap_size=(w, h))
            ref = hk.soft_argmax_plain(xd, heatmap_size=(w, h))
            torch.cuda.synchronize()
            assert ours.shape == (n, 2) and ours.dtype == torch.float32
            assert_close(ours, ref, 'soft_argmax N=%d %dx%d %s'
                         % (n, h, w, dtype), **SOFTARGMAX_TOL)
            errs['soft_argmax'] = max(errs['soft_argmax'], max_err(ours, ref))

    # The backward of each custom op (the plain formula's, as eve_tpu's
    # custom_vjp), against autograd of the plain version on the same
    # inputs, at the serving and the training map counts.
    for n in (80, TRAIN_B * TRAIN_T):
        c = torch.from_numpy(gen.uniform(0, 1900, (n, 2)).astype(
            np.float32)).to(dev)
        mask = (torch.arange(n, device=dev) % 3 != 0).float()
        for sig, msk in (((10.0,), None), (sigmas, mask)):
            g = torch.randn((len(sig), n, 72, 128), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
            ci = c.clone().requires_grad_(True)
            torch.ops.eve_tpu_torch.render_heatmaps(
                ci, list(sig), msk, [128, 72], [1920.0, 1080.0]).backward(g)
            cr = c.clone().requires_grad_(True)
            hk.make_heatmaps_multi_plain(cr, sig, msk).backward(g)
            assert_close(ci.grad, cr.grad, 'render backward N=%d S=%d'
                         % (n, len(sig)), rtol=1e-4, atol=1e-6)
        x = _peaked_maps(gen, n, 72, 128, dev)
        xi = x.clone().requires_grad_(True)
        gp = torch.randn((n, 2), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
        torch.ops.eve_tpu_torch.soft_argmax(
            xi, [128, 72], [1920.0, 1080.0], 100.0).backward(gp)
        xr = x.clone().requires_grad_(True)
        hk.soft_argmax_plain(xr).backward(gp)
        assert_close(xi.grad, xr.grad, 'soft_argmax backward N=%d' % n,
                     rtol=1e-4, atol=1e-4 * float(xr.grad.abs().max()))
    log('kernel phase: kernels match their plain versions at N=%s (render '
        'S=1, S=2 and S=3 masked; soft-argmax 72x128 and 144x256), backward '
        'at N=80 and %d; max abs err render %.3g, soft-argmax %.3g px'
        % (list(KERNEL_NS), TRAIN_B * TRAIN_T, errs['render_heatmaps'],
           errs['soft_argmax']))
    return errs


def _bound(nbytes, ops):
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations')


def kernel_timings(hk, n):
    """Kernel, plain, bound and launch-floor times at the serving N maps.

    The launch floor is an empty kernel at the same grid (and cluster)
    shape, timed in the same 50-launch chain: the least any kernel of that
    shape takes here. The chains re-read inputs that sit in the 50 MB L2,
    as the real caller finds them, so a time under the HBM-byte bound is
    L2's doing.
    """
    gen = np.random.RandomState(1)
    dev = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = torch.from_numpy(gen.uniform(0, 1900, (n, 2)).astype(
        np.float32)).cuda()
    mask = torch.from_numpy((gen.uniform(size=n) > 0.1).astype(
        np.float32)).cuda()
    x = torch.from_numpy(gen.uniform(0, 1, (n, 72, 128)).astype(
        np.float32)).cuda()
    pixels = n * 72 * 128
    sigmas = (10.0, 3.0, 5.0)
    render_ctas = n * -(-72 // hk.render_rows(1, n, 72, sms))
    render3_ctas = 3 * n * -(-72 // hk.render_rows(3, n, 72, sms))
    cluster = hk.soft_argmax_cluster_size(n, 72 * 128 // 4, sms)
    rows = {}
    # Render: reads the centres (and the mask), writes the maps; ~6 float32
    # operations a pixel (subtract, square, add, scale, exp, add), one more
    # with the mask.
    # Soft-argmax: reads the maps, writes (N, 2); ~9 operations a pixel
    # (max, subtract, scale, exp, three multiply-adds).
    for name, fn, plain, nbytes, ops, floor in (
            ('render_heatmaps', lambda: hk.render_heatmaps(c, (10.0,)),
             lambda: hk.make_heatmaps_plain(c, 10.0),
             n * 2 * 4 + pixels * 4, 6 * pixels,
             lambda: hk.launch_empty_kernel(render_ctas, 1, dev)),
            ('render_heatmaps_s3',
             lambda: hk.render_heatmaps(c, sigmas, mask),
             lambda: hk.make_heatmaps_multi_plain(c, sigmas, mask),
             n * 3 * 4 + 3 * pixels * 4, 3 * 7 * pixels,
             lambda: hk.launch_empty_kernel(render3_ctas, 1, dev)),
            ('soft_argmax', lambda: hk.soft_argmax(x),
             lambda: hk.soft_argmax_plain(x), pixels * 4 + n * 2 * 4,
             9 * pixels,
             lambda: hk.launch_empty_kernel(n * cluster, cluster, dev))):
        bound_ms, bound_by = _bound(nbytes, ops)
        rows[name] = {
            'ms': time_gpu(fn), 'plain_ms': time_gpu(plain),
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
            'launch_floor_ms': time_gpu(floor),
        }
        log('%s N=%d: kernel %.5f ms, plain %.5f ms, bound %.5f ms (%s), '
            'launch floor %.5f ms' % (
                name, n, rows[name]['ms'], rows[name]['plain_ms'],
                rows[name]['bound_ms'], rows[name]['bound_by'],
                rows[name]['launch_floor_ms']))
    log('launch shapes at N=%d: render %d CTAs (S=1), %d CTAs (S=3); '
        'soft-argmax %d CTAs in clusters of %d; %d SMs'
        % (n, render_ctas, render3_ctas, n * cluster, cluster, sms))
    # The cluster choice: the smallest cluster that fills the SMs, so a
    # large N runs one CTA a map.
    if cluster not in hk.SOFT_ARGMAX_CLUSTERS or (
            n * cluster < sms and cluster != hk.SOFT_ARGMAX_CLUSTERS[-1]) or (
            cluster > 1 and n * (cluster // 2) >= sms):
        raise AssertionError('soft-argmax cluster %d at N=%d on %d SMs'
                             % (cluster, n, sms))
    return rows


def labelled_forward_phase(hk, model, spec):
    """A forward with ground-truth PoG on the card: the render launches
    twice (the initial estimate, S=1; the three label sigmas with their
    validity mask, S=3), and the labels equal the port's CPU labels."""
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    from eve_tpu_torch.models import eve as eve_lib
    batch = make_synthetic_batch(np.random.RandomState(3),
                                 batch_size=SESSIONS, sequence_len=T,
                                 eyes_size=128, frame_dtype=np.uint8)
    batch['left_PoG_tobii_validity'][0, 1] = 0
    batch['right_PoG_tobii_validity'][2, 5] = 0
    gpu_batch = eve_lib.batch_to_tensors(batch, 'cuda')
    with torch.inference_mode():
        model(gpu_batch, output_predictions=True)  # warm-up
        torch.cuda.synchronize()
        hk.reset_launch_counts()
        out = model(gpu_batch, output_predictions=True)
        torch.cuda.synchronize()
        launches = dict(hk.LAUNCHES)
        gpu_labels = eve_lib.calculate_additional_labels(spec, gpu_batch)
        cpu_labels = eve_lib.calculate_additional_labels(
            spec, eve_lib.batch_to_tensors(batch, 'cpu'))
    log('labelled forward B=%d T=%d: kernel launches %s'
        % (SESSIONS, T, launches))
    if launches != {'render_heatmaps': 2, 'soft_argmax': 1}:
        raise AssertionError('labelled forward launched %s, want 2 renders '
                             'and 1 soft-argmax' % launches)
    for k in ('full_loss', 'loss_ce_heatmap_final', 'PoG_px_final'):
        if k in out and not bool(torch.isfinite(out[k]).all()):
            raise AssertionError('labelled forward: %s is not finite' % k)
    errs = {}
    for k, v in cpu_labels.items():
        got = gpu_labels[k].cpu()
        if k.startswith('heatmap') and not k.endswith('validity'):
            assert_close(got, v, 'label %s card vs CPU' % k, **RENDER_TOL)
        else:
            assert_close(got, v, 'label %s card vs CPU' % k, rtol=1e-5,
                         atol=1e-5)
        errs[k] = max_err(got, v)
    log('labelled forward: %d labels match the CPU labels, max abs err '
        'heatmaps %.3g' % (len(errs), max(v for k, v in errs.items()
                                         if k.startswith('heatmap'))))


# ---------------------------------------------------------------------------
# Serve phase
# ---------------------------------------------------------------------------

def random_state_dict(model, seed=0):
    """Every parameter drawn from a numpy seed, so no head is zero."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith('weight') and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            std = 1.0 / np.sqrt(fan_in)
            if name == 'eye_net.fc_to_gaze.2.weight':
                # Gazes of ~10 degrees, so the PoG lands on the screen
                # instead of clamping to its edges.
                std *= 0.1
            v = rng.normal(0.0, std, shape)
        elif name.endswith('weight'):  # instance-norm scale
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.05 * rng.normal(size=shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


def client_clips(seed, n, t):
    """n session streams of t frames, uint8 frames, no labels."""
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=n,
                                 sequence_len=t, eyes_size=128,
                                 frame_dtype=np.uint8)
    inputs = {k: v for k, v in batch.items()
              if not k.endswith(('_tobii', '_tobii_validity', '_p',
                                 '_p_validity'))}
    return [{k: v[i] for k, v in inputs.items()} for i in range(n)]


def http_infer(address, clip):
    buf = io.BytesIO()
    np.savez(buf, **clip)
    conn = http.client.HTTPConnection(*address, timeout=300)
    try:
        conn.request('POST', '/v1/infer', body=buf.getvalue(),
                     headers={'Content-Type': 'application/octet-stream'})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError('HTTP infer: %d %s' % (resp.status, body[:200]))
        with np.load(io.BytesIO(body)) as z:
            return {k: z[k] for k in z.files}
    finally:
        conn.close()


def check_outputs(out, t, what):
    shapes = {'PoG_px_initial': (t, 2), 'PoG_px_final': (t, 2),
              'PoG_cm_final': (t, 2), 'g_initial': (t, 2), 'g_final': (t, 2),
              'left_pupil_size': (t,), 'right_pupil_size': (t,)}
    for k, shape in shapes.items():
        v = np.asarray(out[k])
        if v.shape != shape or not np.all(np.isfinite(v)):
            raise AssertionError('%s: %s has shape %s, finite=%s'
                                 % (what, k, v.shape, np.isfinite(v).all()))


def compare(got, want, what, px_atol):
    errs = {}
    for k in ('PoG_px_initial', 'PoG_px_final', 'g_final', 'left_pupil_size'):
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        errs[k] = float(np.abs(a - b).max())
        atol = px_atol if 'PoG_px' in k else OTHER_ATOL
        if not np.allclose(a, b, rtol=1e-4, atol=atol):
            raise AssertionError('%s: %s differs by %g (atol %g)'
                                 % (what, k, errs[k], atol))
    return errs


def forward_clips(model, clips, device):
    from eve_tpu_torch.models import eve as eve_lib
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    with torch.inference_mode():
        out = model(eve_lib.batch_to_tensors(batch, device),
                    output_predictions=True)
    return [{k: v[i].cpu().numpy() for k, v in out.items() if v.ndim >= 1}
            for i in range(len(clips))]


def profile_forward(model, clips, steps=3, what='profile'):
    """Where one dispatch's time goes: wall ms, device-busy ms, top kernels
    (see ``profile_batch``)."""
    from eve_tpu_torch.models import eve as eve_lib
    batch = eve_lib.batch_to_tensors(
        {k: np.stack([c[k] for c in clips]) for k in clips[0]}, 'cuda')
    return profile_batch(model, batch, '%s: forward B=%d T=%d'
                         % (what, len(clips), T), steps)


def profile_batch(model, batch, what, steps=3, warmup=2):
    """Wall ms, device-busy ms and top kernels of a forward of ``batch``
    (device tensors); returns ``{'wall_ms', 'busy_ms', 'busy',
    'launches', 'kernels': {name: device ms a forward}}``."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(warmup):
            model(batch, output_predictions=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model(batch, output_predictions=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model(batch, output_predictions=True)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, 'self_device_time_total', 0) > 0
               and e.self_cpu_time_total == 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    log('%s: %.2f ms wall, %.2f ms device busy (%.0f%%), %.0f kernel '
        'launches' % (what, wall_ms, busy_ms, 100 * busy_ms / wall_ms,
                      launches))
    prefix = what.split(':')[0]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log('%s:   %8.3f ms %5.0fx  %s'
            % (prefix, e.self_device_time_total / 1e3 / steps,
               e.count / steps, e.key[:90]))
    return {'wall_ms': wall_ms, 'busy_ms': busy_ms, 'busy': busy_ms / wall_ms,
            'launches': launches,
            'kernels': {e.key: e.self_device_time_total / 1e3 / steps
                        for e in kernels}}


def serve_phase(hk):
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.serve import ServingEngine, make_http_server

    config = Config()
    config.import_json(CONFIG)
    spec = eve_lib.EveSpec.from_config(config)
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec)
    state_dict = random_state_dict(skeleton)
    engine = ServingEngine(spec, state_dict, device='cuda',
                           max_batch=MAX_BATCH, max_delay_ms=20.0)
    server = make_http_server(engine, host='127.0.0.1', port=0)
    http_thread = threading.Thread(target=server.serve_forever, daemon=True)
    http_thread.start()
    try:
        streams = client_clips(1, SESSIONS, CHUNKS * T)
        loose = client_clips(2, 3, T)
        engine.infer(loose[2], timeout=600)  # warm-up: cuDNN, library load
        torch.cuda.synchronize()

        # --- the main path, counted ---
        hk.reset_launch_counts()
        batches_before = engine.get_stats()['batches']
        results, submitted, done = {}, {}, {}

        def submit(key, clip, sid=None):
            submitted[key] = time.perf_counter()
            fut = engine.submit(clip, session_id=sid)
            fut.add_done_callback(
                lambda f: done.__setitem__(key, time.perf_counter()))
            return key, fut

        start = time.perf_counter()
        sids = [engine.open_session() for _ in range(SESSIONS)]
        pending = []
        for c in range(CHUNKS):
            for s, sid in enumerate(sids):
                pending.append(submit((s, c), {
                    k: v[c * T:(c + 1) * T] for k, v in streams[s].items()},
                    sid))
        pending.append(submit(('loose', 0), loose[0]))
        submitted[('loose', 1)] = time.perf_counter()
        results[('loose', 1)] = http_infer(server.server_address, loose[1])
        done[('loose', 1)] = time.perf_counter()
        for key, fut in pending:
            results[key] = fut.result(timeout=600)
        wall = time.perf_counter() - start
        launches = dict(hk.LAUNCHES)
        dispatches = engine.get_stats()['batches'] - batches_before
        # --- end of the counted run ---

        # A future's callbacks run just after its waiters wake.
        deadline = time.perf_counter() + 10.0
        while len(done) < len(results) and time.perf_counter() < deadline:
            time.sleep(0.001)
        latencies = [done[k] - submitted[k] for k in results]
        n_req = len(results)
        log('serve: %d requests (%d frames) in %d dispatches, %.3f s'
            % (n_req, n_req * T, dispatches, wall))
        log('serve: %.2f requests/s, %.1f frames/s, latency p50 %.1f ms, '
            'p99 %.1f ms (host clock, includes queueing behind the '
            'batcher)' % (n_req / wall, n_req * T / wall,
                          1e3 * np.percentile(latencies, 50),
                          1e3 * np.percentile(latencies, 99)))
        log('serve: kernel launches %s over %d dispatches'
            % (launches, dispatches))
        for name in ('render_heatmaps', 'soft_argmax'):
            if launches[name] != dispatches or dispatches == 0:
                raise AssertionError(
                    '%s launched %d times over %d dispatches, want one '
                    'launch a dispatch' % (name, launches[name], dispatches))
        for key, out in results.items():
            check_outputs(out, T, 'request %s' % (key,))
        for k in ('PoG_px_initial', 'PoG_px_final'):
            v = np.concatenate([out[k] for out in results.values()])
            log('serve: %s x in [%.1f, %.1f], y in [%.1f, %.1f] px'
                % (k, v[:, 0].min(), v[:, 0].max(), v[:, 1].min(),
                   v[:, 1].max()))

        # Each session's chunks equal one T=30 forward of its stream.
        model = engine.model
        whole = forward_clips(model, streams, 'cuda')
        chunk_errs = {}
        for s in range(SESSIONS):
            got = {k: np.concatenate([results[(s, c)][k]
                                      for c in range(CHUNKS)])
                   for k in results[(s, 0)]}
            for k, v in compare(got, whole[s], 'session %d chunks vs '
                                'T=30' % s, CHUNK_PX_ATOL).items():
                chunk_errs[k] = max(chunk_errs.get(k, 0.0), v)
        log('serve: chunked sessions vs one T=30 forward, max abs err %s'
            % json.dumps(chunk_errs))

        # One clip on the card vs the port's CPU forward, same weights.
        cpu_model = eve_lib.build_model(spec, state_dict, 'cpu')
        cpu_out = forward_clips(cpu_model, [loose[0]], 'cpu')[0]
        gpu_out = forward_clips(model, [loose[0]], 'cuda')[0]
        cpu_errs = compare(gpu_out, cpu_out, 'card vs CPU', CPU_PX_ATOL)
        log('serve: card vs CPU forward, max abs err %s'
            % json.dumps(cpu_errs))
        profile = profile_forward(model, [{k: v[:T] for k, v in st.items()}
                                          for st in streams])
        labelled_forward_phase(hk, model, spec)
        return launches, profile
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        http_thread.join(timeout=30)


# ---------------------------------------------------------------------------
# Training phase
# ---------------------------------------------------------------------------

def synthetic_clips(seed, n, t, eyes=128):
    """``n`` synthetic clips ('disc' eyes, uint8 frames) in one draw."""
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    batch = make_synthetic_batch(np.random.RandomState(seed), batch_size=n,
                                 sequence_len=t, eyes_size=eyes,
                                 frame_dtype=np.uint8)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


class SyntheticClips:
    """An in-memory dataset with the EVE reader's constructor, so the
    harness's spec tuples and the final full test build it as they build
    ``EVESequences_*``: ``path`` is ``(seed, number of clips)``, and the
    clips have the config's ``max_sequence_len`` and ``eyes_size``."""

    def __init__(self, path, config, cameras_to_use=None,
                 types_of_stimuli=None, live_validation=False,
                 is_final_test=False):
        seed, n = path
        self.clips = synthetic_clips(seed, n, config.max_sequence_len,
                                     config.eyes_size[0])

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def spec(tag, seed, n):
    """A harness spec tuple of ``n`` synthetic clips."""
    return (tag, SyntheticClips, (seed, n), ['image'], ['webcam_c'])


def train_config(**overrides):
    from eve_tpu_torch.config import Config
    config = Config()
    config.import_json(CONFIG)
    config.import_dict(dict({
        # No released EyeNet weights in the checkout: a seeded init.
        'eye_net_load_pretrained': False, 'batch_size': TRAIN_B,
        'num_epochs': 1.0, 'fully_reproducible': True,
        'checkpoints_save_every_n_steps': SAVE_EVERY,
        'test_every_n_steps': SAVE_EVERY, 'test_num_samples': VAL_CLIPS,
        'test_batch_size': TRAIN_B, 'train_data_workers': 4,
        'checkpoints_keep_n': 3}, **overrides))
    return config


def sub_state(model, prefix):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.startswith(prefix)}


def run_training(config, train_sets, test_sets, device, resume_from=''):
    """One harness run; ``(experiment, {step: full_loss}, [step wall s])``.

    Each step is timed from the end of the previous one (the device
    synchronised), so a step's wall time holds its data wait too, and the
    step after a checkpoint and validation holds those.
    """
    from eve_tpu_torch.train import harness
    config.override('resume_from', resume_from)
    train_data, test_data = harness.init_datasets(config, train_sets,
                                                  test_sets)
    exp = harness.Experiment(config, output_dir_base=TRAIN_OUT,
                             device=device)
    losses, walls = {}, []
    t0 = time.perf_counter()
    for step, metrics, _ in harness.main_loop_iterator(exp, train_data,
                                                       test_data):
        losses[step] = float(metrics['full_loss'])
        if device.type == 'cuda':
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        t0 = t1
        if not np.isfinite(losses[step]):
            raise AssertionError('step %d: full_loss %s' % (step,
                                                            losses[step]))
    exp.close()
    return exp, losses, walls


def profile_train_step(state, batch, device, steps=2, what='train profile'):
    """Wall ms, device-busy ms and top kernels of one training step."""
    from torch.profiler import ProfilerActivity, profile

    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step_lib.train_step(state, batch, harness.kappa_generator(0, i))
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if getattr(e, 'self_device_time_total', 0) > 0
               and e.self_cpu_time_total == 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    b, t = batch['left_eye_patch'].shape[:2]
    log('%s: step B=%d T=%d: %.2f ms wall (profiled), %.2f ms device busy '
        '(%.0f%%), %.0f kernel launches' % (
            what, b, t, wall_ms, busy_ms, 100 * busy_ms / wall_ms, launches))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log('%s:   %8.3f ms %5.0fx  %s'
            % (what, e.self_device_time_total / 1e3 / steps, e.count / steps,
               e.key[:90]))
    heatmap_ms = sum(e.self_device_time_total for e in kernels
                     if 'render_heatmaps_kernel' in e.key or
                     'soft_argmax_kernel' in e.key) / 1e3 / steps
    log('%s: the two heatmap kernels %.4f ms of device time a step (%.3f%% '
        'of the busy time)' % (what, heatmap_ms, 100 * heatmap_ms / busy_ms))

    # Forward, backward and update, each timed with CUDA events.
    model = state.model
    phases = {'forward': [], 'backward': [], 'update': []}
    for i in range(3):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record()
        out = model(batch, training=True,
                    generator=harness.kappa_generator(0, 10 + i))
        marks[1].record()
        out['full_loss'].backward()
        marks[2].record()
        state.step += 1
        step_lib.apply_update(state)
        marks[3].record()
        torch.cuda.synchronize(device)
        for j, name in enumerate(phases):
            phases[name].append(marks[j].elapsed_time(marks[j + 1]))
    log('%s: step phases (CUDA events, median of 3): %s'
        % (what, ', '.join('%s %.2f ms' % (k, float(np.median(v)))
                           for k, v in phases.items())))
    return busy_ms / wall_ms


def counted(hk, fn):
    """Run ``fn`` with the launch counts at 0; ``(result, launches)``."""
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(hk.LAUNCHES)


def compare_card_cpu(spec, card, what_='train'):
    """One training step's full_loss and RefineNet gradients, card vs
    CPU, from the same seeded weights, batch and kappas (see
    CMP_GRAD_L2). The card takes the step CMP_CARD_STEPS times, and each
    is held to the limits; the script prints the card's spread between
    its own steps and the CPU's under a weight perturbation beside it."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec)
    state_dict = random_state_dict(skeleton, seed=5)
    clips = synthetic_clips(7, CMP_B, CMP_T)
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    noise = torch.Generator().manual_seed(1)
    perturbed = {k: v * (1 + CMP_PERTURB * torch.randn(v.shape,
                                                       generator=noise))
                 if k.startswith('refine_net.') else v
                 for k, v in state_dict.items()}
    loss, grads = [], []
    runs = [('cpu', state_dict), ('cpu', perturbed)] + \
        [(card, state_dict)] * CMP_CARD_STEPS
    for device, weights in runs:
        model = eve_lib.build_model(spec, weights, device)
        out = step_lib.accumulate_gradients(
            model, eve_lib.batch_to_tensors(batch, device),
            harness.kappa_generator(0, 1000))
        loss.append(out['full_loss'].item())
        grads.append({n: p.grad.cpu() for n, p
                      in model.refine_net.named_parameters()
                      if p.grad is not None})
        if any(p.grad is not None for p in model.eye_net.parameters()):
            raise AssertionError('a frozen EyeNet parameter has a gradient')
    cpu, cpu_perturbed, cards = grads[0], grads[1], grads[2:]
    for card_loss in loss[2:]:
        np.testing.assert_allclose(card_loss, loss[0], **CMP_LOSS_TOL,
                                   err_msg='card vs CPU full_loss')
    layers = {}
    for name, g in cpu.items():
        layers.setdefault(name.rsplit('.', 1)[0], []).append(g.flatten())
    layer_max = {k: float(torch.cat(v).abs().max()) for k, v in layers.items()}
    layer_l2 = {k: float(torch.cat(v).norm()) for k, v in layers.items()}

    def worst(pairs):
        """Largest L2 error over the layer's norm and largest element
        error over the layer's largest element, each with its tensor."""
        l2 = elem = (0.0, '')
        for a, b in pairs:
            for name, g in b.items():
                layer = name.rsplit('.', 1)[0]
                d = a[name] - g
                l2 = max(l2, (float(d.norm()) / layer_l2[layer], name))
                elem = max(elem, (float(d.abs().max()) / layer_max[layer],
                                  name))
        return l2, elem

    results = {'card vs CPU': worst((c, cpu) for c in cards),
               'card vs card': worst((c, cards[0]) for c in cards[1:]),
               'CPU under a %g weight perturbation' % CMP_PERTURB:
               worst([(cpu_perturbed, cpu)])}
    for what, (l2, elem) in results.items():
        log('%s: %s, B=%d T=%d: worst L2 error %.3g of its layer\'s '
            'gradient norm (%s), worst element error %.3g of its layer\'s '
            'largest element (%s)' % (what_, what, CMP_B, CMP_T, l2[0], l2[1],
                                      elem[0], elem[1]))
    l2, elem = results['card vs CPU']
    if l2[0] > CMP_GRAD_L2 or elem[0] > CMP_GRAD_ELEM:
        raise AssertionError('card vs CPU gradients beyond the limits (L2 '
                             '%g, element %g): %s' % (
                                 CMP_GRAD_L2, CMP_GRAD_ELEM, results))
    log('%s: card vs CPU: full_loss %.7f on the CPU, %s on the card; all '
        '%d RefineNet gradients of %d card steps within %g (L2) and %g '
        '(element) of their layer\'s' % (
            what_, loss[0], ', '.join('%.7f' % x for x in loss[2:]), len(cpu),
            CMP_CARD_STEPS, CMP_GRAD_L2, CMP_GRAD_ELEM))
    return l2[0], elem[0]


def training_phase(hk, card):
    """Train the full-width configs/refine_net.json model; returns the
    training path's launch counts and per-step figures."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib

    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    train_sets = [spec('synthetic', 11, TRAIN_B * TRAIN_STEPS)]
    test_sets = [spec('synthetic_val', 12, VAL_CLIPS)]
    log('train: %d training and %d validation clips of T=%d, built as the '
        'harness builds them; eye_net_load_pretrained overridden to false '
        '(seeded init_weights, no released weights in the checkout)'
        % (TRAIN_B * TRAIN_STEPS, VAL_CLIPS, TRAIN_T))

    # --- the training main path, counted ---
    torch.cuda.reset_peak_memory_stats(card)
    (exp, losses, walls), launches = counted(hk, lambda: run_training(
        train_config(), train_sets, test_sets, card))
    peak = torch.cuda.max_memory_allocated(card)
    # --- end of the counted run ---
    steps = len(losses)
    eval_batches = 2 * -(-VAL_CLIPS // TRAIN_B)   # two live validations
    want = {'render_heatmaps': 3 * steps + 2 * eval_batches,
            'soft_argmax': steps + eval_batches}
    log('train: %d steps, full_loss %s' % (steps, ', '.join(
        '%.5f' % losses[k] for k in sorted(losses))))
    log('train: kernel launches %s over %d steps and %d eval batches (want '
        '%s)' % (launches, steps, eval_batches, want))
    if steps != TRAIN_STEPS or launches != want:
        raise AssertionError('training main path: %d steps, launches %s'
                             % (steps, launches))
    step_s = float(np.median(walls[2:]))
    log('train: step wall %.1f ms (median of steps 3-%d, data wait '
        'included), %.1f training frames/s, peak device memory %.2f GiB '
        '(%s)' % (1e3 * step_s, steps, TRAIN_B * TRAIN_T / step_s,
                  peak / 2 ** 30, card_line()))
    log('train: step walls ms %s' % ', '.join('%.1f' % (1e3 * w)
                                               for w in walls))

    model = exp.state.model
    init = eve_lib.init_model(exp.spec, torch.Generator().manual_seed(0),
                              'cpu')
    for k, v in sub_state(init, 'eye_net.').items():
        if not torch.equal(v, model.state_dict()[k].cpu()):
            raise AssertionError('frozen EyeNet parameter %s changed' % k)
    # Every RefineNet tensor moves but the CLSTM's gates: under
    # clstm_carry_only the cell's state never reaches the loss, so their
    # gradient is zero (and weight_decay is 0 in this config).
    unchanged = [k for k, v in sub_state(init, 'refine_net.').items()
                 if torch.equal(v, model.state_dict()[k].cpu())]
    n_refine = len(sub_state(init, 'refine_net.'))
    if any('.rnn_cells.' not in k for k in unchanged):
        raise AssertionError('RefineNet tensors unchanged: %s' % unchanged)
    ckpts = sorted(os.listdir(os.path.join(exp.output_dir, 'checkpoints')))
    files = sorted(os.listdir(os.path.join(exp.output_dir, 'checkpoints',
                                           ckpts[0])))
    log('train: EyeNet bitwise unchanged; %d of %d RefineNet tensors '
        'changed (unchanged: %s); checkpoints %s holding %s'
        % (n_refine - len(unchanged), n_refine, unchanged, ckpts, files))
    if ckpts != ['%07d.ckpt' % SAVE_EVERY, '%07d.ckpt' % TRAIN_STEPS] or \
            files != ['eye_net.npz', 'optimizer_torch.npz',
                      'refine_net.npz']:
        raise AssertionError('checkpoints: %s %s' % (ckpts, files))

    # --- resume from the step-4 checkpoint in a fresh Experiment ---
    resume_dir = os.path.join(TRAIN_OUT, 'resumed')
    os.makedirs(os.path.join(resume_dir, 'checkpoints'))
    shutil.copytree(os.path.join(exp.output_dir, 'checkpoints',
                                 '%07d.ckpt' % SAVE_EVERY),
                    os.path.join(resume_dir, 'checkpoints',
                                 '%07d.ckpt' % SAVE_EVERY))
    exp2, resumed, _ = run_training(train_config(), train_sets, test_sets,
                                    card, resume_from=resume_dir)
    if sorted(resumed) != list(range(SAVE_EVERY, TRAIN_STEPS)):
        raise AssertionError('resumed steps %s' % sorted(resumed))
    a = np.array([losses[k] for k in sorted(resumed)])
    b = np.array([resumed[k] for k in sorted(resumed)])
    np.testing.assert_allclose(b, a, **RESUME_LOSS_TOL,
                               err_msg='resumed vs uninterrupted full_loss')
    log('train: resumed from step %d: steps %d-%d full_loss %s vs '
        'uninterrupted %s, max rel err %.3g (limit rtol %g)'
        % (SAVE_EVERY, SAVE_EVERY + 1, TRAIN_STEPS,
           ', '.join('%.6f' % x for x in b), ', '.join('%.6f' % x for x in a),
           float(np.max(np.abs(b - a) / np.abs(a))),
           RESUME_LOSS_TOL['rtol']))

    # --- launches per training step and per eval batch; a profile ---
    loader = harness.init_datasets(train_config(), train_sets,
                                   test_sets)[0]['synthetic']['dataloader']
    from eve_tpu_torch.data.loader import to_device
    batch, _ = to_device(next(iter(loader)), card)
    _, per_step = counted(hk, lambda: step_lib.train_step(
        exp2.state, batch, harness.kappa_generator(0, 100)))
    _, per_eval = counted(hk, lambda: step_lib.eval_step(model, batch))
    log('train: kernel launches per training step %s, per eval batch %s'
        % (per_step, per_eval))
    if per_step != {'render_heatmaps': 3, 'soft_argmax': 1} or \
            per_eval != {'render_heatmaps': 2, 'soft_argmax': 1}:
        raise AssertionError('launches per step %s, per eval batch %s'
                             % (per_step, per_eval))
    busy = profile_train_step(exp2.state, batch, card)

    compare_card_cpu(exp.spec, card)
    return {'launches': launches, 'per_step': per_step,
            'per_eval_batch': per_eval, 'step_ms': 1e3 * step_s,
            'peak': peak, 'busy': busy}


# ---------------------------------------------------------------------------
# Train-CLI phase
# ---------------------------------------------------------------------------

def cli_argv(out_base):
    """The command line of the preempted run: configs/refine_net.json at
    full width, checkpoints, live validation and images every CLI_EVERY
    steps, the profiler on, ``--auto-resume yes``."""
    return [CONFIG, '--eye-net-load-pretrained', 'no',
            '--fully-reproducible', 'yes', '--auto-resume', 'yes',
            '--num-epochs', '1', '--base-learning-rate', str(CLI_BASE_LR),
            '--checkpoints-save-every-n-steps', str(CLI_EVERY),
            '--test-every-n-steps', str(CLI_EVERY),
            '--tensorboard-images-every-n-steps', str(CLI_EVERY),
            '--test-num-samples', str(VAL_CLIPS),
            '--test-batch-size', str(TRAIN_B),
            '--full-test-batch-size', str(TRAIN_B),
            '--full-test-data-workers', '2', '--train-data-workers', '4',
            '--profile-dir', os.path.join(out_base, 'profile'),
            '--device', 'cuda']


def train_cli_child(args):
    """A child process of the train-CLI phase: ``cli.train.run`` on
    in-memory clips with ``cli_argv``; writes what it saw (each step's
    full_loss and wall time, the images, the final test, the kernel
    launches of the whole run) to a JSON file, also when it exits 143."""
    record_path, out_base = args
    sys.path.insert(0, ROOT)
    from eve_tpu_torch.cli import train as train_cli
    from eve_tpu_torch.kernels import heatmap_kernels as hk
    from eve_tpu_torch.train import harness

    record = {'started': time.time(), 'losses': {}, 'walls': {},
              'images': {}, 'final_test': None}
    loop, final_test = harness.main_loop_iterator, harness.do_final_full_test

    def observed_loop(exp, train_data, test_data):
        t0 = time.perf_counter()
        for step, metrics, images in loop(exp, train_data, test_data):
            record['losses'][step] = float(metrics['full_loss'])  # syncs
            record['walls'][step] = time.perf_counter() - t0
            record.setdefault('first_step', time.time())
            record['images'][step] = {
                tag: [list(img.shape), float(np.min(img)), float(np.max(img)),
                      bool(np.isfinite(img).all())]
                for tag, img in images.items()}
            yield step, metrics, images
            t0 = time.perf_counter()

    def observed_final_test(exp, test_data):
        record['final_test'] = final_test(exp, test_data)
        return record['final_test']

    harness.main_loop_iterator = observed_loop
    harness.do_final_full_test = observed_final_test
    config, parsed = harness.script_init_common(cli_argv(out_base))
    hk.reset_launch_counts()
    try:
        train_cli.run(config, parsed.device,
                      [spec('synthetic', 11, CLI_CLIPS)],
                      [spec('synthetic_val', 12, VAL_CLIPS)],
                      output_dir_base=out_base)
    finally:
        record['launches'] = dict(hk.LAUNCHES)
        record['peak'] = torch.cuda.max_memory_allocated()
        with open(record_path, 'w') as f:
            json.dump(record, f)


class Child:
    """``python chip_smoke.py --train-cli-child`` (or the child ``argv``
    names, None standing for the record path) as a process whose log lines
    are kept (and written to ``<out_dir>/<name>.log``) as they come."""

    def __init__(self, name, out_base, argv=None, env=None, out_dir=CLI_OUT):
        self.name = name
        self.out_dir = out_dir
        self.record_path = os.path.join(out_dir, name + '.json')
        self.lines = []
        self.started = time.time()
        argv = [self.record_path if a is None else a for a in argv or [
            '--train-cli-child', None, out_base]]
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, 'chip_smoke.py')] + argv,
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        with open(os.path.join(self.out_dir, self.name + '.log'), 'w') as f:
            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                f.write(line)

    def wait_for(self, text, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline and self.proc.poll() is None:
            if any(text in line for line in self.lines):
                return
            time.sleep(0.05)
        raise AssertionError('%s: no log line with %r (exit %s); last lines:'
                             '\n%s' % (self.name, text, self.proc.poll(),
                                       '\n'.join(self.lines[-30:])))

    def finish(self, timeout):
        """Wait for the exit; ``(exit code, seconds, record)``."""
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.reader.join(timeout=30)
        with open(self.record_path) as f:
            record = json.load(f)
        for key in ('losses', 'walls', 'images'):
            record[key] = {int(k): v for k, v in record[key].items()}
        return code, time.time() - self.started, record

    def grep(self, text):
        return [line for line in self.lines if text in line]


def cli_launches_wanted():
    """Kernel launches of one whole CLI run: a training step 3 renders and
    1 soft-argmax; an image step, an eval batch of live validation or of
    the final test 2 and 1."""
    every = [s for s in range(CLI_STEPS) if s % CLI_EVERY == CLI_EVERY - 1]
    val_batches = -(-VAL_CLIPS // TRAIN_B)
    evals = len(every) * (1 + val_batches) + val_batches
    return {'render_heatmaps': 3 * CLI_STEPS + 2 * evals,
            'soft_argmax': CLI_STEPS + evals}


def preempt_and_resume():
    """(a): an uninterrupted CLI run, and the same run preempted with
    SIGTERM after step CLI_PREEMPT_AFTER and restarted with the same argv.
    Returns the uninterrupted run's launches and figures."""
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    os.makedirs(CLI_OUT)
    whole_base = os.path.join(CLI_OUT, 'whole')
    base = os.path.join(CLI_OUT, 'preempted')
    code, whole_s, whole = Child('whole', whole_base).finish(600)
    if code != 0:
        raise AssertionError('uninterrupted CLI run exited %d' % code)
    steps = sorted(whole['losses'])
    if steps != list(range(CLI_STEPS)):
        raise AssertionError('uninterrupted CLI run took steps %s' % steps)
    want = cli_launches_wanted()
    log('train-cli: uninterrupted run of %d steps (B=%d, T=%d, %d clips) '
        'exited 0 after %.1f s; kernel launches %s (want %s)'
        % (CLI_STEPS, TRAIN_B, TRAIN_T, CLI_CLIPS, whole_s,
           whole['launches'], want))
    if whole['launches'] != want:
        raise AssertionError('CLI run launched %s, want %s'
                             % (whole['launches'], want))

    first = Child('preempted', base)
    first.wait_for('Step %d,' % CLI_PREEMPT_AFTER, 600)
    sigterm_at = time.time()
    first.proc.send_signal(signal.SIGTERM)
    code, _, before = first.finish(CLI_EXIT_TIMEOUT)
    exit_s = time.time() - sigterm_at
    saved = first.grep('checkpoint saved at step')
    if code != 143 or not saved:
        raise AssertionError('preempted run exited %s, log %s; last lines:\n'
                             '%s' % (code, saved, '\n'.join(first.lines[-20:])))
    stop = int(saved[-1].split('checkpoint saved at step ')[1].split(';')[0])
    (run_dir,) = [os.path.join(base, 'EVE', d)
                  for d in os.listdir(os.path.join(base, 'EVE'))]
    ckpt = os.path.join(run_dir, 'checkpoints', '%07d.ckpt' % stop)
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    if stop != len(before['losses']) or files != [
            'eye_net.npz', 'optimizer_torch.npz', 'refine_net.npz']:
        raise AssertionError('preemption checkpoint %s holds %s after %d '
                             'steps' % (ckpt, files, len(before['losses'])))
    log('train-cli: SIGTERM after the log showed step %d: exit 143 %.2f s '
        'later, checkpoint %s (%s)' % (CLI_PREEMPT_AFTER, exit_s,
                                       os.path.relpath(ckpt, ROOT), files))

    second = Child('resumed', base)
    code, resumed_s, after = second.finish(600)
    continuing = second.grep('auto_resume: continuing')
    if code != 0 or not continuing or run_dir not in continuing[0]:
        raise AssertionError('restart exited %s, log %s' % (code, continuing))
    if sorted(after['losses']) != list(range(stop, CLI_STEPS)) or \
            not after['final_test']:
        raise AssertionError('restart took steps %s, final test %s'
                             % (sorted(after['losses']), after['final_test']))
    restart_s = after['first_step'] - after['started']
    log('train-cli: the restart logged "%s", took steps %d-%d, ran the final '
        'full test and exited 0; %.2f s from its start to its first step'
        % (continuing[0].split(' INFO ')[-1], stop + 1, CLI_STEPS, restart_s))
    a = np.array([whole['losses'][k] for k in range(CLI_STEPS)])
    b = np.array([before['losses'].get(k, after['losses'].get(k))
                  for k in range(CLI_STEPS)])
    np.testing.assert_allclose(b, a, **RESUME_LOSS_TOL,
                               err_msg='preempted+resumed vs uninterrupted')
    # A resume one batch (and one kappa draw) off would leave the
    # tolerance: the resumed losses against the uninterrupted run's shifted
    # by a step.
    resumed = b[stop:]
    for shift in (-1, 1):
        other = a[stop + shift:][:len(resumed)]
        if np.allclose(resumed[:len(other)], other, **RESUME_LOSS_TOL):
            raise AssertionError('the resumed losses also match the '
                                 'uninterrupted run shifted by %d' % shift)
    log('train-cli: preempted+resumed full_loss vs uninterrupted, max rel '
        'err %.3g before the SIGTERM (two runs) and %.3g after it (limit '
        'rtol %g; shifted by a step they differ by up to %.3g): %s vs %s' % (
            float(np.max(np.abs(b - a)[:stop] / np.abs(a[:stop]))),
            float(np.max(np.abs(b - a)[stop:] / np.abs(a[stop:]))),
            RESUME_LOSS_TOL['rtol'],
            float(np.max(np.abs(resumed[1:] - a[stop:-1]) /
                         np.abs(a[stop:-1]))),
            ', '.join('%.6f' % x for x in b),
            ', '.join('%.6f' % x for x in a)))
    tags = {'train/screen_plus_initial_history',
            'train/screen_plus_refined_history', 'train/0_gt_heatmap',
            'train/1_initial_heatmap', 'train/2_final_heatmap'}
    image_steps = {s: v for s, v in whole['images'].items() if v}
    if sorted(image_steps) != [s for s in range(CLI_STEPS)
                               if s % CLI_EVERY == CLI_EVERY - 1]:
        raise AssertionError('images at steps %s' % sorted(image_steps))
    for step, images in image_steps.items():
        if set(images) != tags or not all(
                ok and lo >= 0.0 and hi <= 1.0
                for _, lo, hi, ok in images.values()):
            raise AssertionError('step %d images %s' % (step, images))
    log('train-cli: images at steps %s: %s' % (
        [s + 1 for s in sorted(image_steps)],
        json.dumps(image_steps[sorted(image_steps)[0]])))
    full_test = whole['final_test']['synthetic_val']
    log('train-cli: final full test on %d clips: full_loss %.5f, '
        'metric_euc_PoG_px_final %.2f px' % (
            VAL_CLIPS, full_test['full_loss'],
            full_test['metric_euc_PoG_px_final']))
    traces = [os.path.join(whole_base, 'profile', f)
              for f in os.listdir(os.path.join(whole_base, 'profile'))]
    sizes = [os.path.getsize(t) for t in traces]
    if not traces or min(sizes) == 0:
        raise AssertionError('profile traces %s' % traces)
    log('train-cli: profiler traces %s (%s bytes)' % (
        [os.path.relpath(t, ROOT) for t in traces], sizes))
    walls = whole['walls']
    # A step's wall holds the harness's work after the step before it (a
    # checkpoint, a validation) and its own images.
    plain = [s for s in range(2, CLI_STEPS)
             if s % CLI_EVERY not in (0, CLI_EVERY - 1)]
    step_ms = 1e3 * float(np.median([walls[s] for s in plain]))
    log('train-cli: step wall %.1f ms (median of steps %s: no images, no '
        'checkpoint or validation before them; the loss read each step), '
        '%.1f training frames/s, peak device memory %.2f GiB (%s); walls ms '
        '%s' % (step_ms, [s + 1 for s in plain],
                TRAIN_B * TRAIN_T / (step_ms / 1e3),
            whole['peak'] / 2 ** 30, card_line(),
            ', '.join('%.1f' % (1e3 * walls[s]) for s in range(CLI_STEPS))))
    log('train-cli: SIGTERM to exit %.2f s, exit to the first resumed step '
        '%.2f s (process start, imports, clips, model and checkpoint load)'
        % (exit_s, after['first_step'] - sigterm_at - exit_s))
    return {'launches': whole['launches'], 'step_ms': step_ms,
            'exit_s': exit_s, 'restart_s': restart_s}


class CountingLoader:
    """A training loader that counts the batches it yields."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_size = inner.batch_size
        self.count = 0

    def __len__(self):
        return len(self.inner)

    def fast_forward(self, num_batches):
        self.inner.fast_forward(num_batches)

    def __iter__(self):
        for batch in self.inner:
            self.count += 1
            yield batch


def echo_multi_source(hk, card):
    """(b): two training sources with train_batch_echoing 2 for
    ECHO_STEPS steps in process."""
    from eve_tpu_torch.train import harness
    config = train_config(train_batch_echoing=ECHO, num_epochs=1.0,
                          checkpoints_save_every_n_steps=1000,
                          test_every_n_steps=1000,
                          tensorboard_images_every_n_steps=1000)
    sources = [spec('src_a', 21, 2 * TRAIN_B), spec('src_b', 22, TRAIN_B)]
    train_data, test_data = harness.init_datasets(
        config, sources, [spec('synthetic_val', 12, VAL_CLIPS)])
    for data in train_data.values():
        data['dataloader'] = CountingLoader(data['dataloader'])
    exp = harness.Experiment(config, os.path.join(TRAIN_OUT, 'multi'),
                             device=card)

    def loop():
        return [(step, {k: float(v) for k, v in metrics.items()})
                for step, metrics, _ in harness.main_loop_iterator(
                    exp, train_data, test_data)]

    try:
        steps, launches = counted(hk, loop)
    finally:
        exp.close()
    loads = {tag: d['dataloader'].count for tag, d in train_data.items()}
    want = {'render_heatmaps': 6 * len(steps), 'soft_argmax': 2 * len(steps)}
    log('train-cli: echo %d, two sources: %d steps, batches loaded %s, '
        'kernel launches %s (want %s: twice one source\'s 3 and 1 a step)'
        % (ECHO, len(steps), loads, launches, want))
    keys = steps[-1][1]
    if len(steps) != ECHO_STEPS or any(n * ECHO != len(steps)
                                       for n in loads.values()) or \
            launches != want:
        raise AssertionError('echo and two sources: %d steps, loads %s, '
                             'launches %s' % (len(steps), loads, launches))
    total = keys['src_a/full_loss'] + keys['src_b/full_loss']
    if not np.isclose(keys['full_loss'], total, rtol=1e-6) or \
            not all(np.isfinite(v) for _, m in steps for v in m.values()):
        raise AssertionError('two-source metrics %s' % keys)
    log('train-cli: last step full_loss %.5f = src_a %.5f + src_b %.5f'
        % (keys['full_loss'], keys['src_a/full_loss'],
           keys['src_b/full_loss']))
    return {k: v // len(steps) for k, v in launches.items()}


def eye_net_card_vs_cpu(spec_, card, what_='eye-net'):
    """One B=EYE_CMP_B, T=EYE_CMP_T step of the trainable EyeNet, card vs
    CPU, from the same seeded weights, batch and kappas: full_loss, and
    every EyeNet gradient against the limits of EYE_GRAD_LIMITS. Also
    prints the CPU's own spread under a weight perturbation."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    state_dict = random_state_dict(skeleton, seed=6)
    noise = torch.Generator().manual_seed(1)
    perturbed = {k: v * (1 + CMP_PERTURB * torch.randn(v.shape,
                                                       generator=noise))
                 for k, v in state_dict.items()}
    clips = synthetic_clips(8, EYE_CMP_B, EYE_CMP_T)
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    runs = {'CPU': ('cpu', state_dict, True),
            'card': (card, state_dict, True),
            'card without cuDNN': (card, state_dict, False),
            'CPU under a %g weight perturbation' % CMP_PERTURB:
            ('cpu', perturbed, True)}
    loss, grads = {}, {}
    for what, (device, weights, cudnn) in runs.items():
        model = eve_lib.build_model(spec_, weights, device)
        with torch.backends.cudnn.flags(enabled=cudnn, deterministic=False,
                                        benchmark=False, allow_tf32=False):
            out = step_lib.accumulate_gradients(
                model, eve_lib.batch_to_tensors(batch, device),
                harness.kappa_generator(0, 1000))
        loss[what] = out['full_loss'].item()
        grads[what] = {n: p.grad.cpu() for n, p in model.named_parameters()
                       if p.grad is not None}
    cpu = grads['CPU']
    if not cpu or any(not n.startswith('eye_net.') for n in cpu):
        raise AssertionError('EyeNet gradients: %s' % sorted(cpu)[:5])
    top = max(float(g.abs().max()) for g in cpu.values())
    worst = {}
    for what, got in grads.items():
        elem = l2 = (0.0, '')
        for name, want in cpu.items():
            d = got[name] - want
            scale = float(want.abs().max()) + EYE_GRAD_TOP * top
            elem = max(elem, (float(d.abs().max()) / scale, name))
            l2 = max(l2, (float(d.norm()) / (float(want.norm()) + EYE_GRAD_TOP
                                             * top * want.numel() ** 0.5),
                          name))
        worst[what] = (elem, l2)
        if what != 'CPU':
            log('%s: %s vs CPU, B=%d T=%d: full_loss %.7f vs %.7f; '
                'worst element error %.3g of its tensor\'s largest element '
                '(%s), worst L2 error %.3g of its norm (%s)' % (
                    what_, what, EYE_CMP_B, EYE_CMP_T, loss[what], loss['CPU'],
                    elem[0], elem[1], l2[0], l2[1]))
    for what, (elem_limit, l2_limit) in EYE_GRAD_LIMITS.items():
        np.testing.assert_allclose(loss[what], loss['CPU'], **CMP_LOSS_TOL,
                                   err_msg='EyeNet %s vs CPU full_loss' % what)
        elem, l2 = worst[what]
        if elem[0] > elem_limit or l2[0] > l2_limit:
            raise AssertionError('EyeNet %s vs CPU gradients beyond %g '
                                 '(element) and %g (L2): %s %s' % (
                                     what, elem_limit, l2_limit, elem, l2))
    log('%s: card vs CPU: %d EyeNet gradients within %s' % (
        what_, len(cpu), ', '.join('%g (element) and %g (L2) %s' % (e, l, w)
                            for w, (e, l) in EYE_GRAD_LIMITS.items())))


def eye_net_phase(hk, card, compute_dtype='float32', native=False):
    """(c): configs/eye_net.json at its own width, EyeNet trainable, in
    ``compute_dtype`` (the card-vs-CPU gradients at float32 only); with
    ``native``, eve_tpu's opt-in topology (the patchify stem)."""
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.data.loader import to_device
    from eve_tpu_torch.train import harness
    config = Config()
    config.import_json(os.path.join(ROOT, 'configs', 'eye_net.json'))
    config.import_dict({'num_epochs': 1.0, 'fully_reproducible': True,
                        'checkpoints_save_every_n_steps': 1000,
                        'test_every_n_steps': 1000,
                        'train_data_workers': 4,
                        'tpu_compute_dtype': compute_dtype,
                        'tpu_native_arch': native})
    what = ('native ' if native else '') + (
        'eye-net' if compute_dtype == 'float32' else 'bf16 eye-net')
    if (config.batch_size, config.max_sequence_len, config.eyes_size,
            config.refine_net_enabled, config.eye_net_frozen) != (
            EYE_B, TRAIN_T, [128, 128], False, False):
        raise AssertionError('configs/eye_net.json changed')
    train_data, test_data = harness.init_datasets(
        config, [spec('synthetic', 31, EYE_B * EYE_STEPS)],
        [spec('synthetic_val', 12, VAL_CLIPS)])
    exp = harness.Experiment(config, os.path.join(
        TRAIN_OUT, 'eye_net_' + compute_dtype + ('_native' if native
                                                 else '')), device=card)
    losses, walls = {}, []

    def loop():
        t0 = time.perf_counter()
        for step, metrics, _ in harness.main_loop_iterator(
                exp, train_data, test_data):
            losses[step] = float(metrics['full_loss'])  # syncs
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()

    torch.cuda.reset_peak_memory_stats(card)
    try:
        _, launches = counted(hk, loop)
    finally:
        exp.close()
    peak = torch.cuda.max_memory_allocated(card)
    step_s = float(np.median(walls[2:]))
    log('%s: configs/eye_net.json, B=%d T=%d, %d steps: full_loss %s; '
        'kernel launches %s (want none: no RefineNet)' % (
            what, EYE_B, TRAIN_T, len(losses),
            ', '.join('%.4f' % losses[k] for k in sorted(losses)), launches))
    if len(losses) != EYE_STEPS or any(launches.values()) or \
            not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError('%s run: %d steps, launches %s'
                             % (what, len(losses), launches))
    check_float32_state(exp.state, what)
    log('%s: step wall %.1f ms (median of steps 3-%d, data wait and a '
        'loss read included), %.1f training frames/s, peak device memory '
        '%.2f GiB (%s); walls ms %s' % (
            what, 1e3 * step_s, EYE_STEPS, EYE_B * TRAIN_T / step_s,
            peak / 2 ** 30, card_line(),
            ', '.join('%.1f' % (1e3 * w) for w in walls)))
    batch, _ = to_device(next(iter(train_data['synthetic']['dataloader'])),
                         card)
    busy = profile_train_step(exp.state, batch, card,
                              what=what + ' profile')
    if compute_dtype == 'float32':
        eye_net_card_vs_cpu(exp.spec, card, what)
    return {'step_ms': 1e3 * step_s, 'peak': peak, 'launches': launches,
            'busy': busy}


def train_cli_phase(hk, card):
    cli = preempt_and_resume()
    cli['per_step_two_sources'] = echo_multi_source(hk, card)
    cli['eye_net'] = eye_net_phase(hk, card)
    return cli


# ---------------------------------------------------------------------------
# Eval phase
# ---------------------------------------------------------------------------

LABEL_SUFFIXES = ('_tobii', '_tobii_validity', '_p', '_p_validity')


class EvalClips:
    """``n`` synthetic clips of ``t`` frames as the dataset reader gives
    them: uint8 frames, int64 nanosecond stamps, the sequence strings.
    Clip i belongs to sequence ``i * sequences // n``, whose stamps run on
    from clip to clip; without ``labels`` the gaze labels are dropped, as
    the test split withholds them."""

    def __init__(self, seed, n, t, sequences=1, labels=True):
        from eve_tpu_torch.data.synthetic import make_synthetic_batch
        batch = make_synthetic_batch(np.random.RandomState(seed),
                                     batch_size=n, sequence_len=t,
                                     eyes_size=128, frame_dtype=np.uint8)
        if not labels:
            batch = {k: v for k, v in batch.items()
                     if not k.endswith(LABEL_SUFFIXES)}
        per_seq = -(-n // sequences)
        self.clips = []
        for i in range(n):
            seq, pos = divmod(i, per_seq)
            clip = {k: v[i] for k, v in batch.items()}
            clip['timestamps'] = (int(1.6e18) + int(1e12) * seq +
                                  (pos * t + np.arange(t)) * 33333333
                                  ).astype(np.int64)
            clip.update(participant='test%02d' % (seq // 2 + 1),
                        subfolder='step%03d_image_eval' % (seq % 2 + 1),
                        camera='webcam_c')
            self.clips.append(clip)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]

    def sequence(self, participant, subfolder, camera):
        return [c for c in self.clips if (c['participant'], c['subfolder'],
                                          c['camera']) ==
                (participant, subfolder, camera)]


def eval_config(**overrides):
    from eve_tpu_torch.config import Config
    config = Config()
    config.import_json(CONFIG)
    config.import_dict(overrides)
    return config


def check_finite(outputs, keys, what):
    for k in keys:
        if k not in outputs or not np.all(np.isfinite(outputs[k])):
            raise AssertionError('%s: %s missing or not finite' % (what, k))


def eval_phase(hk, card):
    """Weights from a run directory, streaming inference with
    create_images, and the Codalab collection and submission."""
    from eve_tpu_torch import infer
    from eve_tpu_torch.cli import eval_codalab
    from eve_tpu_torch.data.loader import DataLoader, rebase_timestamps
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import step as step_lib
    from eve_tpu_torch.train.checkpoint import CheckpointManager

    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    run_dir = os.path.join(EVAL_OUT, 'run')
    config = eval_config(resume_from=run_dir)
    spec = eve_lib.EveSpec.from_config(config)

    # --- (a) weights from a run directory, bitwise ---
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec)
    state_dict = random_state_dict(skeleton, seed=21)
    cpu_model = eve_lib.build_model(spec, state_dict, 'cpu')
    CheckpointManager(run_dir).save_at_step(
        1, step_lib.create_train_state(config, cpu_model, 1))
    model = infer.model_setup(config, device=card)
    loaded = model.state_dict()
    if set(loaded) != set(state_dict) or not all(
            torch.equal(loaded[k].cpu(), v) for k, v in state_dict.items()):
        raise AssertionError('weights read back from %s differ' % run_dir)
    log('eval: %d tensors written to %s and read back bitwise through '
        'infer.model_setup' % (len(state_dict), os.path.relpath(run_dir,
                                                                 ROOT)))

    # --- (b) streaming inference with create_images, counted ---
    video = EvalClips(31, STREAM_CHUNKS, EVAL_T)
    image_keys = ('screen_frame', 'initial_gaze_history', 'initial_heatmap',
                  'final_heatmap', 'refined_gaze_history', 'gt_heatmap',
                  'left_g_gt', 'PoG_px_gt', 'left_g_initial',
                  'PoG_px_initial', 'g_final', 'PoG_px_final')
    list(infer.iterator(model, DataLoader(video, 1, num_workers=0),
                        streaming=True))  # warm-up
    streamed, stream_launches = counted(hk, lambda: list(infer.iterator(
        model, DataLoader(video, 1, num_workers=0), streaming=True)))
    log('eval: streamed %d chunks of T=%d at batch 1: kernel launches %s'
        % (STREAM_CHUNKS, EVAL_T, stream_launches))
    if stream_launches != {'render_heatmaps': 2 * STREAM_CHUNKS,
                           'soft_argmax': STREAM_CHUNKS}:
        raise AssertionError('streaming launched %s, want render 2 and '
                             'soft-argmax 1 a chunk' % stream_launches)
    for step, _, out in streamed:
        check_finite(out, image_keys, 'streamed chunk %d' % step)
    whole_batch = {k: np.stack([np.concatenate([c[k] for c in video.clips])])
                   for k in video[0] if k not in ('participant', 'subfolder',
                                                  'camera')}
    whole_batch['timestamps'] = rebase_timestamps(whole_batch['timestamps'])
    with torch.inference_mode():
        whole = model(eve_lib.batch_to_tensors(whole_batch, card),
                      output_predictions=True)
    got = {k: np.concatenate([o[k][0] for _, _, o in streamed])
           for k in ('PoG_px_initial', 'PoG_px_final', 'g_final',
                     'left_pupil_size')}
    stream_errs = compare(got, {k: v[0].cpu().numpy()
                                for k, v in whole.items() if k in got},
                          'streamed chunks vs one T=%d forward'
                          % (STREAM_CHUNKS * EVAL_T), CHUNK_PX_ATOL)
    log('eval: streamed chunks vs one T=%d forward, max abs err %s'
        % (STREAM_CHUNKS * EVAL_T, json.dumps(stream_errs)))
    cpu_first = next(infer.iterator(cpu_model, DataLoader(
        video, 1, num_workers=0), streaming=True))[2]
    first = streamed[0][2]
    compare(first, cpu_first, 'streamed chunk 0 card vs CPU', CPU_PX_ATOL)
    map_errs = {}
    for k in ('initial_heatmap', 'final_heatmap', 'gt_heatmap',
              'initial_gaze_history', 'refined_gaze_history',
              'screen_frame'):
        map_errs[k] = float(np.abs(first[k] - cpu_first[k]).max())
        atol = HISTORY_ATOL if k.endswith('history') else MAP_ATOL
        if not np.allclose(first[k], cpu_first[k], rtol=1e-4, atol=atol):
            raise AssertionError('chunk 0 %s: card vs CPU differ by %g '
                                 '(atol %g)' % (k, map_errs[k], atol))
    log('eval: chunk 0 card vs CPU, create_images maps max abs err %s'
        % json.dumps(map_errs))

    # --- (c) the Codalab collection and submission, counted ---
    clips = EvalClips(41, CODALAB_CLIPS, EVAL_T,
                      sequences=CODALAB_SEQUENCES, labels=False)
    batch_size = config.codalab_eval_batch_size
    if batch_size != CODALAB_BATCH:
        raise AssertionError('codalab_eval_batch_size %d' % batch_size)

    def loader(indices=None):
        return DataLoader(clips, batch_size, indices=indices,
                          num_workers=config.codalab_eval_data_workers)

    kept, walls = [], []

    def observed(batches):
        """Keep each batch's outputs and its wall time (loading, copies,
        forward and the copy back), then pass the batch on."""
        t0 = time.perf_counter()
        for item in batches:
            walls.append(time.perf_counter() - t0)
            kept.append(item[2])
            yield item
            t0 = time.perf_counter()

    next(infer.iterator(model, loader(range(batch_size)),
                        create_images=False,
                        materialize_inputs=False))  # warm-up
    torch.cuda.reset_peak_memory_stats(card)
    start = time.perf_counter()
    outputs_to_write, launches = counted(hk, lambda: eval_codalab.collect(
        observed(infer.iterator(model, loader(), create_images=False,
                                materialize_inputs=False))))
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(card)
    n_batches = len(kept)
    pkl_path, zip_path = eval_codalab.write_submission(outputs_to_write,
                                                       EVAL_OUT)
    log('eval: Codalab, %d clips of T=%d in %d batches of up to %d: kernel '
        'launches %s' % (CODALAB_CLIPS, EVAL_T, n_batches, batch_size,
                         launches))
    if n_batches != -(-CODALAB_CLIPS // batch_size) or launches != {
            'render_heatmaps': n_batches, 'soft_argmax': n_batches}:
        raise AssertionError('Codalab: %d batches, launches %s, want render '
                             '1 and soft-argmax 1 a batch'
                             % (n_batches, launches))
    log('eval: Codalab %.1f clips/s, %.1f frames/s (%.3f s for %d clips, '
        'loading and copies included); batch walls %s s; peak device '
        'memory %.2f GiB at batch %d (%s)'
        % (CODALAB_CLIPS / wall, CODALAB_CLIPS * EVAL_T / wall, wall,
           CODALAB_CLIPS, ', '.join('%.3f' % w for w in walls),
           peak / 2 ** 30, batch_size, card_line()))

    # The submission: nesting, keys, lengths, int64 stamps, the zip.
    import gzip
    import pickle
    import zipfile
    with gzip.open(pkl_path, 'rb') as f:
        written = pickle.load(f)
    with zipfile.ZipFile(zip_path) as zf:
        if zf.namelist() != [os.path.basename(pkl_path)]:
            raise AssertionError('zip holds %s' % zf.namelist())
    sequences = sorted({(c['participant'], c['subfolder'], c['camera'])
                        for c in clips.clips})
    found = sorted((p, s, c) for p, subs in written.items()
                   for s, cams in subs.items() for c in cams)
    if found != sequences:
        raise AssertionError('submission sequences %s, want %s'
                             % (found, sequences))
    for key in sequences:
        entry = written[key[0]][key[1]][key[2]]
        seq_clips = clips.sequence(*key)
        n = len(seq_clips) * EVAL_T
        stamps = np.concatenate([c['timestamps'] for c in seq_clips])
        if sorted(entry) != sorted(eval_codalab.KEYS_TO_STORE) or \
                entry['timestamps'].dtype != np.int64 or \
                not np.array_equal(entry['timestamps'], stamps) or \
                entry['PoG_px_final'].shape != (n, 2) or \
                entry['left_pupil_size'].shape != (n,):
            raise AssertionError('submission entry %s: %s' % (key, {
                k: (v.shape, v.dtype) for k, v in entry.items()}))
        check_finite(entry, eval_codalab.KEYS_TO_STORE, 'entry %s' % (key,))
    log('eval: %s (%d bytes) and its zip: %d sequences of %s frames, int64 '
        'stamps equal to the input stamps' % (
            os.path.relpath(pkl_path, ROOT), os.path.getsize(pkl_path),
            len(sequences), sorted({len(c) * EVAL_T for c in (
                clips.sequence(*k) for k in sequences)})))

    # The ragged batch's clips against the same clips inside a full batch.
    ragged = kept[-1]
    m = ragged['PoG_px_final'].shape[0]
    full = next(infer.iterator(model, loader(range(CODALAB_CLIPS - batch_size,
                                                   CODALAB_CLIPS)),
                               create_images=False,
                               materialize_inputs=False))[2]
    ragged_errs = compare(ragged, {k: v[-m:] for k, v in full.items()
                                   if np.ndim(v)},
                          'ragged batch vs full batch', CHUNK_PX_ATOL)
    log('eval: the ragged batch of %d clips vs the same clips in a full '
        'batch, max abs err %s' % (m, json.dumps(ragged_errs)))

    # Where one full batch's time goes.
    from eve_tpu_torch.data.loader import collate, to_device
    device_batch, _ = to_device(collate(clips.clips[:batch_size]), card)
    busy = profile_batch(model, device_batch, 'eval profile: Codalab batch '
                         'B=%d T=%d' % (batch_size, EVAL_T), steps=1,
                         warmup=0)['busy']
    return {'launches': {k: stream_launches[k] + launches[k]
                         for k in launches},
            'per_chunk': {k: v // STREAM_CHUNKS
                          for k, v in stream_launches.items()},
            'per_batch': {k: v // n_batches for k, v in launches.items()},
            'frames_per_s': CODALAB_CLIPS * EVAL_T / wall, 'peak': peak,
            'batch_s': walls[0], 'busy': busy}


# ---------------------------------------------------------------------------
# bfloat16 phase
# ---------------------------------------------------------------------------

def check_float32_state(state, what):
    """The parameters and Adam's moments are float32 (the networks may
    compute in bfloat16)."""
    dtypes = {p.dtype for p in state.model.parameters()} | {
        v.dtype for st in state.optimizer.state.values()
        for v in st.values() if isinstance(v, torch.Tensor) and v.ndim}
    if dtypes != {torch.float32}:
        raise AssertionError('%s: parameters and optimizer state in %s'
                             % (what, dtypes))


def input_types(model, batch):
    """The input types that every convolution of the ResNet and of
    RefineNet, and each EyeNet cell, receive in one forward of ``batch``:
    ``{'conv': {...}, 'cell': {...}}``."""
    seen = {'conv': set(), 'cell': set()}
    handles = []
    for root in (model.eye_net.cnn_layers, model.refine_net):
        for m in root.modules():
            if isinstance(m, torch.nn.Conv2d):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: seen['conv'].add(args[0].dtype)))
    for cell in model.eye_net.rnn_cells:
        handles.append(cell.register_forward_pre_hook(
            lambda mod, args: seen['cell'].update(
                a.dtype for a in args if isinstance(a, torch.Tensor))))
    try:
        with torch.inference_mode():
            model(batch, output_predictions=True)
    finally:
        for h in handles:
            h.remove()
    return seen


def drift_ratios(got, want, want32, what, limit):
    """Per key of BF16_KEYS: the largest error of ``got`` against the
    bfloat16 outputs ``want``, over the largest drift of ``want`` from the
    float32 outputs ``want32`` (lists of per-clip output dicts); each must
    stay below ``limit``."""
    ratios = {}
    for k in BF16_KEYS:
        a, b, c = (np.stack([np.asarray(o[k], np.float64) for o in outs])
                   for outs in (got, want, want32))
        err, drift = float(np.abs(a - b).max()), float(np.abs(b - c).max())
        ratios[k] = err / drift
        log('%s: %s error %.4g, bfloat16-vs-float32 drift %.4g, ratio %.3f'
            % (what, k, err, drift, ratios[k]))
        if not ratios[k] < limit:
            raise AssertionError('%s: %s error %g is not below %g of the '
                                 'drift %g' % (what, k, err, limit, drift))
    return ratios


def bf16_serve_phase(hk):
    """(a): the serve phase's model and sessions at bfloat16."""
    import dataclasses

    from eve_tpu_torch.config import Config
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.serve import ServingEngine

    config = Config()
    config.import_json(CONFIG)
    config.import_dict({'tpu_compute_dtype': 'bfloat16'})
    spec = eve_lib.EveSpec.from_config(config)
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec)
    state_dict = random_state_dict(skeleton)  # the serve phase's weights
    engine = ServingEngine(spec, state_dict, device='cuda',
                           max_batch=MAX_BATCH, max_delay_ms=20.0)
    try:
        streams = client_clips(1, SESSIONS, CHUNKS * T)
        engine.infer(client_clips(2, 3, T)[2], timeout=600)  # warm-up
        torch.cuda.synchronize()

        # --- the bfloat16 serving path, counted ---
        hk.reset_launch_counts()
        batches_before = engine.get_stats()['batches']
        start = time.perf_counter()
        sids = [engine.open_session() for _ in range(SESSIONS)]
        futures = {(s, c): engine.submit(
            {k: v[c * T:(c + 1) * T] for k, v in streams[s].items()}, sid)
            for c in range(CHUNKS) for s, sid in enumerate(sids)}
        results = {key: f.result(timeout=600) for key, f in futures.items()}
        wall = time.perf_counter() - start
        launches = dict(hk.LAUNCHES)
        dispatches = engine.get_stats()['batches'] - batches_before
        # --- end of the counted run ---
        log('bf16 serve: %d requests (%d frames) in %d dispatches, %.3f s, '
            '%.2f requests/s; kernel launches %s' % (
                len(results), len(results) * T, dispatches, wall,
                len(results) / wall, launches))
        for name in ('render_heatmaps', 'soft_argmax'):
            if launches[name] != dispatches or dispatches == 0:
                raise AssertionError('bf16 serve: %s launched %d times over '
                                     '%d dispatches' % (name, launches[name],
                                                        dispatches))
        for key, out in results.items():
            check_outputs(out, T, 'bf16 request %s' % (key,))

        model = engine.model
        model32 = eve_lib.build_model(
            dataclasses.replace(spec, compute_dtype='float32'), state_dict,
            'cuda')
        chunked = [{k: np.concatenate([results[(s, c)][k]
                                       for c in range(CHUNKS)])
                    for k in results[(s, 0)]} for s in range(SESSIONS)]
        drift_ratios(chunked, forward_clips(model, streams, 'cuda'),
                     forward_clips(model32, streams, 'cuda'),
                     'bf16 serve: chunked sessions vs one T=%d forward'
                     % (CHUNKS * T), BF16_CHUNK_RATIO)
        clips = [{k: v[:T] for k, v in st.items()}
                 for st in streams[:BF16_CPU_CLIPS]]
        cpu_model = eve_lib.build_model(spec, state_dict, 'cpu')
        drift_ratios(forward_clips(model, clips, 'cuda'),
                     forward_clips(cpu_model, clips, 'cpu'),
                     forward_clips(model32, clips, 'cuda'),
                     'bf16 serve: %d clips, card vs CPU' % len(clips),
                     BF16_CPU_RATIO)
        del cpu_model, model32

        from eve_tpu_torch.models.eve import batch_to_tensors
        first = {k: np.stack([st[k][:T] for st in streams])
                 for k in streams[0]}
        types = input_types(model, batch_to_tensors(first, 'cuda'))
        log('bf16 serve: convolutions receive %s, the EyeNet cells %s'
            % (sorted(map(str, types['conv'])),
               sorted(map(str, types['cell']))))
        if types != {'conv': {torch.bfloat16}, 'cell': {torch.float32}}:
            raise AssertionError('bf16 serve: input types %s' % types)
        profile = profile_forward(model, [{k: v[:T] for k, v in st.items()}
                                          for st in streams],
                                  what='bf16 profile')
        conv = {k: v for k, v in profile['kernels'].items()
                if any(w in k.lower() for w in ('conv', 'fprop'))}
        conv_bf16 = sum(v for k, v in conv.items() if 'bf16' in k.lower())
        log('bf16 profile: convolution kernels %.3f ms a forward, %.3f ms '
            'of them named bf16: %s' % (sum(conv.values()), conv_bf16,
                                        sorted(conv)[:8]))
        if not conv_bf16:
            raise AssertionError('bf16 serve: no bf16 convolution kernel in '
                                 'the profile: %s' % sorted(conv))
        return {'launches': launches, 'dispatches': dispatches,
                'requests_per_s': len(results) / wall, 'profile': profile}
    finally:
        engine.stop()


def bf16_gradients_card_vs_cpu(spec16, card):
    """One B=CMP_B, T=CMP_T bfloat16 training step (frozen EyeNet) from
    seeded weights, batch and kappas, on the card and on the CPU: full_loss
    within BF16_LOSS_RTOL, and the RefineNet gradients against their own
    bfloat16-vs-float32 drift on the card (a layer is a module's weight and
    bias together): all layers together within BF16_GRAD_RATIO of it, each
    layer within BF16_LAYER_RATIO. The card's spread between two of its own
    steps, and the CPU's under a CMP_PERTURB weight perturbation, are
    printed beside."""
    import dataclasses

    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec16)
    state_dict = random_state_dict(skeleton, seed=5)
    clips = synthetic_clips(7, CMP_B, CMP_T)
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    spec32 = dataclasses.replace(spec16, compute_dtype='float32')
    noise = torch.Generator().manual_seed(1)
    perturbed = {k: v * (1 + CMP_PERTURB * torch.randn(v.shape,
                                                       generator=noise))
                 if k.startswith('refine_net.') else v
                 for k, v in state_dict.items()}
    perturbed_what = 'CPU under a %g weight perturbation' % CMP_PERTURB
    loss, grads = {}, {}
    for what, spec_, device, weights in (
            ('CPU', spec16, 'cpu', state_dict),
            (perturbed_what, spec16, 'cpu', perturbed),
            ('card', spec16, card, state_dict),
            ('card again', spec16, card, state_dict),
            ('card float32', spec32, card, state_dict)):
        model = eve_lib.build_model(spec_, weights, device)
        out = step_lib.accumulate_gradients(
            model, eve_lib.batch_to_tensors(batch, device),
            harness.kappa_generator(0, 1000))
        loss[what] = out['full_loss'].item()
        grads[what] = {n: p.grad.cpu() for n, p
                       in model.refine_net.named_parameters()
                       if p.grad is not None}
        if {g.dtype for g in grads[what].values()} != {torch.float32}:
            raise AssertionError('bf16 gradients: %s' % what)

    def layer_sq(a, b):
        out = {}
        for name, g in a.items():
            layer = name.rsplit('.', 1)[0]
            out[layer] = out.get(layer, 0.0) + float(((g - b[name]) ** 2).sum())
        return out

    drift = layer_sq(grads['card'], grads['card float32'])
    ratios = {}
    for what in ('CPU', 'card again', perturbed_what):
        ref = 'CPU' if what == perturbed_what else 'card'
        err = layer_sq(grads[what], grads[ref])
        total = (sum(err.values()) / sum(drift.values())) ** 0.5
        worst = max(((err[k] / drift[k]) ** 0.5, k) for k in err if drift[k])
        ratios[what] = (total, worst)
        log('bf16 train: %s vs %s, B=%d T=%d: full_loss %.7f vs %.7f '
            '(float32 on the card %.7f); RefineNet gradients\' L2 error '
            '%.3g of their bfloat16-vs-float32 drift, worst layer %.3g (%s)'
            % (what, ref, CMP_B, CMP_T, loss[what], loss[ref],
               loss['card float32'], total, worst[0], worst[1]))
    total, worst = ratios['CPU']
    if abs(loss['CPU'] - loss['card']) > BF16_LOSS_RTOL * abs(loss['CPU']) \
            or not total < BF16_GRAD_RATIO or not worst[0] < BF16_LAYER_RATIO:
        raise AssertionError('bf16 card vs CPU step: full_loss %g vs %g, '
                             'gradients %s' % (loss['card'], loss['CPU'],
                                               ratios['CPU']))


def bf16_training_phase(hk, card):
    """(b): configs/refine_net.json training steps at bfloat16."""
    from eve_tpu_torch.data.loader import to_device
    from eve_tpu_torch.train import harness

    train_sets = [spec('synthetic_bf16', 13, TRAIN_B * BF16_STEPS)]
    test_sets = [spec('synthetic_val', 12, VAL_CLIPS)]
    config = train_config(tpu_compute_dtype='bfloat16',
                          checkpoints_save_every_n_steps=1000,
                          test_every_n_steps=1000)
    torch.cuda.reset_peak_memory_stats(card)
    (exp, losses, walls), launches = counted(hk, lambda: run_training(
        config, train_sets, test_sets, card))
    peak = torch.cuda.max_memory_allocated(card)
    steps = len(losses)
    log('bf16 train: %d steps, full_loss %s; kernel launches %s' % (
        steps, ', '.join('%.5f' % losses[k] for k in sorted(losses)),
        launches))
    if steps != BF16_STEPS or launches != {'render_heatmaps': 3 * steps,
                                           'soft_argmax': steps}:
        raise AssertionError('bf16 training: %d steps, launches %s'
                             % (steps, launches))
    check_float32_state(exp.state, 'bf16 train')
    step_s = float(np.median(walls[2:]))
    loader = harness.init_datasets(config, train_sets, test_sets)[0][
        'synthetic_bf16']['dataloader']
    batch, _ = to_device(next(iter(loader)), card)
    busy = profile_train_step(exp.state, batch, card,
                              what='bf16 train profile')
    bf16_gradients_card_vs_cpu(exp.spec, card)
    return {'launches': launches, 'step_ms': 1e3 * step_s, 'peak': peak,
            'busy': busy}


def codalab_batch_phase(hk, card, what, **overrides):
    """One Codalab batch of CODALAB_BATCH clips under ``overrides`` of
    configs/refine_net.json (the bf16 phase's (d), the native phase's
    (d))."""
    from eve_tpu_torch import infer
    from eve_tpu_torch.data.loader import DataLoader, collate, to_device
    from eve_tpu_torch.models import eve as eve_lib

    config = eval_config(**overrides)
    spec_ = eve_lib.EveSpec.from_config(config)
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    model = eve_lib.build_model(spec_, random_state_dict(skeleton, seed=21),
                                card)
    clips = EvalClips(41, CODALAB_BATCH, EVAL_T, sequences=CODALAB_SEQUENCES,
                      labels=False)

    def batches():
        return [out for _, _, out in infer.iterator(
            model, DataLoader(clips, CODALAB_BATCH,
                              num_workers=config.codalab_eval_data_workers),
            create_images=False, materialize_inputs=False)]

    batches()  # warm-up
    torch.cuda.reset_peak_memory_stats(card)
    start = time.perf_counter()
    outs, launches = counted(hk, batches)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(card)
    log('%s: Codalab batch of %d clips of T=%d: %.3f s, %.1f frames/s '
        '(loading and copies included), peak device memory %.2f GiB; '
        'kernel launches %s' % (what, CODALAB_BATCH, EVAL_T, wall,
                                CODALAB_BATCH * EVAL_T / wall,
                                peak / 2 ** 30, launches))
    if len(outs) != 1 or launches != {'render_heatmaps': 1,
                                      'soft_argmax': 1}:
        raise AssertionError('%s Codalab: %d batches, launches %s'
                             % (what, len(outs), launches))
    if outs[0]['PoG_px_final'].shape != (CODALAB_BATCH, EVAL_T, 2):
        raise AssertionError('%s Codalab: PoG_px_final %s'
                             % (what, outs[0]['PoG_px_final'].shape))
    check_finite(outs[0], ('PoG_px_initial', 'PoG_px_final', 'g_final',
                           'left_pupil_size'), what + ' Codalab batch')
    device_batch, _ = to_device(collate(clips.clips), card)
    busy = profile_batch(model, device_batch, '%s profile: Codalab batch '
                         'B=%d T=%d' % (what, CODALAB_BATCH, EVAL_T),
                         steps=1, warmup=0)['busy']
    return {'launches': launches, 'batch_s': wall, 'peak': peak,
            'busy': busy}


def bf16_phase(hk, card, f32):
    """The bfloat16 compute path at full width, each figure beside the
    float32 one of this run (``f32``)."""
    serve = bf16_serve_phase(hk)
    train = bf16_training_phase(hk, card)
    eye = eye_net_phase(hk, card, compute_dtype='bfloat16')
    codalab = codalab_batch_phase(hk, card, 'bf16 eval',
                                  tpu_compute_dtype='bfloat16')
    prof, prof32 = serve['profile'], f32['serve_profile']
    log('bf16 vs float32 (%s): serving forward B=%d T=%d %.2f ms wall vs '
        '%.2f, device busy %.2f ms vs %.2f, %.0f launches vs %.0f'
        % (card_line(), SESSIONS, T, prof['wall_ms'], prof32['wall_ms'],
           prof['busy_ms'], prof32['busy_ms'], prof['launches'],
           prof32['launches']))
    for what, ours, theirs, b in (
            ('configs/refine_net.json training', train, f32['train'],
             TRAIN_B),
            ('configs/eye_net.json training', eye, f32['eye_net'], EYE_B)):
        log('bf16 vs float32: %s step B=%d T=%d %.1f ms vs %.1f, %.1f '
            'training frames/s vs %.1f, peak %.2f GiB vs %.2f' % (
                what, b, TRAIN_T, ours['step_ms'], theirs['step_ms'],
                1e3 * b * TRAIN_T / ours['step_ms'],
                1e3 * b * TRAIN_T / theirs['step_ms'],
                ours['peak'] / 2 ** 30, theirs['peak'] / 2 ** 30))
    log('bf16 vs float32: Codalab batch B=%d T=%d %.3f s vs %.3f, %.1f '
        'frames/s vs %.1f, peak %.2f GiB vs %.2f' % (
            CODALAB_BATCH, EVAL_T, codalab['batch_s'], f32['eval']['batch_s'],
            CODALAB_BATCH * EVAL_T / codalab['batch_s'],
            CODALAB_BATCH * EVAL_T / f32['eval']['batch_s'],
            codalab['peak'] / 2 ** 30, f32['eval']['peak'] / 2 ** 30))
    return {'serve': serve['launches'], 'train': train['launches'],
            'eye_net': eye['launches'], 'codalab': codalab['launches'],
            'figures': {'serve_profile': prof, 'train': train,
                        'eye_net': eye, 'eval': codalab}}


# ---------------------------------------------------------------------------
# Serving modes (slice F)
# ---------------------------------------------------------------------------

def timed_engine(**kw):
    """A ServingEngine that records each dispatch's wall time (the
    dispatch ends with the served outputs on the host, so it holds the
    device's work too)."""
    from eve_tpu_torch.serve import ServingEngine

    class TimedEngine(ServingEngine):
        def __init__(self, **kwargs):
            self.walls = []
            super().__init__(**kwargs)

        def _dispatch(self, reqs):
            t0 = time.perf_counter()
            try:
                return super()._dispatch(reqs)
            finally:
                self.walls.append(time.perf_counter() - t0)

    return TimedEngine(**kw)


def settle(engine, dispatches, batches=0):
    """Wait until ``dispatches`` dispatches since the engine's count
    ``batches`` have finished and been timed (a dispatch resolves its
    requests before it counts and times itself); returns the count."""
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline and (
            engine.get_stats()['batches'] - batches < dispatches or
            len(engine.walls) < dispatches):
        time.sleep(0.001)
    return engine.get_stats()['batches'] - batches


def session_requests(streams, loose):
    """``{(session, chunk) or ('loose', i): request}``."""
    requests = {(s, c): {k: v[c * T:(c + 1) * T] for k, v in st.items()}
                for s, st in enumerate(streams) for c in range(CHUNKS)}
    requests.update({('loose', i): clip for i, clip in enumerate(loose)})
    return requests


def serve_rounds(engine, requests):
    """Chunk c of every session as round c, then the session-less requests
    as one round, each submitted together and awaited, so that every
    engine dispatches the same batches: ``(results by key, the sessions'
    final states)``."""
    sids = [engine.open_session() for _ in range(SESSIONS)]
    rounds = [[(s, c) for s in range(SESSIONS)] for c in range(CHUNKS)]
    rounds.append([key for key in requests if key[0] == 'loose'])
    results = {}
    for keys in rounds:
        futures = {key: engine.submit(
            requests[key], None if key[0] == 'loose' else sids[key[0]])
            for key in keys}
        results.update({k: f.result(timeout=600) for k, f in futures.items()})
    states = [engine._sessions[sid].state for sid in sids]
    for sid in sids:
        engine.close_session(sid)
    return results, states


def state_leaves(tree):
    """A session state's leaves as float64 numpy arrays."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in state_leaves(t)]
    if isinstance(tree, torch.Tensor):
        tree = tree.float().cpu().numpy()
    return [np.asarray(tree, np.float64)]


def profile_copies(fn, trace_path):
    """Run ``fn`` twice under torch.profiler, recording the second run (a
    first recorded run, started with the profiler, lost the memcpy events
    of its first dispatch): ``(device-busy ms, {'HtoD': bytes, 'DtoH':
    bytes})``, the bytes summed over the trace's memcpy events (None where
    the trace carries no byte counts)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    busy = []

    def recorded(prof):
        busy.append(sum(e.self_device_time_total for e in prof.key_averages()
                        if getattr(e, 'self_device_time_total', 0) > 0
                        and e.self_cpu_time_total == 0) / 1e3)
        prof.export_chrome_trace(trace_path)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=recorded) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    busy_ms, = busy
    with open(trace_path) as f:
        events = json.load(f).get('traceEvents', [])
    os.remove(trace_path)
    copies, counted_any = {'HtoD': 0, 'DtoH': 0}, False
    for e in events:
        nbytes = (e.get('args') or {}).get('bytes')
        if e.get('cat') != 'gpu_memcpy' or nbytes is None:
            continue
        counted_any = True
        for way in copies:
            if way in e.get('name', ''):
                copies[way] += int(nbytes)
    return busy_ms, (copies if counted_any else None)


def hold_modes(runs, what, ref=None):
    """Every served output and session state of the device-resident modes
    against the default engine's: bitwise, or else the largest difference
    printed and held to the chunked-vs-whole tolerances (at float32
    ``compare``'s; at bfloat16 the drift from the float32 default run
    ``ref``)."""
    base, base_states = runs['default']
    for mode in SERVING_MODES[1:]:
        results, states = runs[mode]
        out_diff = max(float(np.abs(np.asarray(results[key][k], np.float64) -
                                    np.asarray(v, np.float64)).max())
                       for key, out in base.items() for k, v in out.items())
        state_diff = max(float(np.abs(a - b).max()) for st, bst in
                         zip(states, base_states)
                         for a, b in zip(state_leaves(st),
                                         state_leaves(bst)))
        if out_diff == 0.0 and state_diff == 0.0:
            log('%s: %s outputs and session states bitwise equal to the '
                'default engine\'s (%d requests, %d sessions)'
                % (what, mode, len(base), len(states)))
            continue
        log('%s: %s vs default engine: largest output difference %.4g, '
            'largest session-state difference %.4g' % (what, mode, out_diff,
                                                      state_diff))
        keys = sorted(base, key=str)
        if ref is None:
            for key in keys:
                compare(results[key], base[key], '%s %s request %s'
                        % (what, mode, key), CHUNK_PX_ATOL)
            for st, bst in zip(states, base_states):
                for a, b in zip(state_leaves(st), state_leaves(bst)):
                    if not np.allclose(a, b, rtol=1e-4, atol=OTHER_ATOL):
                        raise AssertionError('%s %s: session state differs '
                                             'by %g' % (what, mode,
                                                        np.abs(a - b).max()))
        else:
            drift_ratios([results[k] for k in keys], [base[k] for k in keys],
                         [ref[0][k] for k in keys], '%s: %s vs default'
                         % (what, mode), BF16_CHUNK_RATIO)


def serving_modes(hk, spec_, state_dict, what, ref=None):
    """The serve phase's sessions (SESSIONS x CHUNKS chunks of T frames,
    then LOOSE session-less requests) through the engine in each of
    SERVING_MODES, counted and timed: launches once a dispatch, a
    dispatch's wall (host clock), device-busy time (profiler) and bytes
    copied each way, and every output and state of the resident modes
    against the default engine's (``hold_modes``; ``ref`` the float32
    default run for a bfloat16 one)."""
    streams = client_clips(1, SESSIONS, CHUNKS * T)
    host_requests = session_requests(streams, client_clips(2, LOOSE, T))
    log('%s: a request holds %d bytes of inputs' % (what, sum(
        v.nbytes for v in host_requests[(0, 0)].values())))
    card_requests = {key: {k: torch.from_numpy(np.ascontiguousarray(v))
                           .to('cuda') for k, v in clip.items()}
                     for key, clip in host_requests.items()}
    os.makedirs(SERVE_OUT, exist_ok=True)
    runs, launches, timing = {}, {}, {}
    for mode in SERVING_MODES:
        requests = card_requests if mode == 'loopback' else host_requests
        engine = timed_engine(spec=spec_, params=state_dict, device='cuda',
                              max_batch=MAX_BATCH, max_delay_ms=20.0,
                              device_resident=mode != 'default')
        try:
            # Warm-up: the same rounds (cuDNN's choices, the allocator).
            serve_rounds(engine, requests)
            settle(engine, CHUNKS + 1)
            engine.walls.clear()
            batches = engine.get_stats()['batches']
            # --- this mode's serving path, counted ---
            runs[mode], launches[mode] = counted(
                hk, lambda: serve_rounds(engine, requests))
            # --- end of the counted run ---
            dispatches = settle(engine, CHUNKS + 1, batches)
            walls = list(engine.walls)
            busy_ms, copies = profile_copies(
                lambda: serve_rounds(engine, requests),
                os.path.join(SERVE_OUT, 'trace.json'))
        finally:
            engine.stop()
        if dispatches != CHUNKS + 1 or any(
                launches[mode][name] != dispatches
                for name in ('render_heatmaps', 'soft_argmax')):
            raise AssertionError('%s %s: %d dispatches, launches %s, want '
                                 'one of each kernel a dispatch' % (
                                     what, mode, dispatches, launches[mode]))
        for key, out in runs[mode][0].items():
            check_outputs(out, T, '%s %s request %s' % (what, mode, key))
        wall_ms = 1e3 * float(np.mean(walls))
        device_ms = busy_ms / dispatches
        timing[mode] = {'wall_ms': wall_ms, 'device_ms': device_ms,
                        'host_ms': wall_ms - device_ms,
                        'h2d': copies and copies['HtoD'] / dispatches,
                        'd2h': copies and copies['DtoH'] / dispatches}
        log('%s %s: %d dispatches of B=%d T=%d, kernel launches %s; a '
            'dispatch: %.2f ms wall, %.2f ms device busy, %.2f ms host '
            '(wall - device), %s bytes host-to-device, %s device-to-host '
            '(%s)' % (what, mode, dispatches, MAX_BATCH, T, launches[mode],
                      wall_ms, device_ms, wall_ms - device_ms,
                      'not measured' if copies is None
                      else '%.0f' % timing[mode]['h2d'],
                      'not measured' if copies is None
                      else '%.0f' % timing[mode]['d2h'], card_line()))
        log('%s %s: dispatch walls ms %s' % (what, mode, ', '.join(
            '%.2f' % (1e3 * w) for w in walls)))
    hold_modes(runs, what, ref and ref['runs']['default'])
    return {'runs': runs, 'launches': launches, 'timing': timing,
            'streams': streams}


def resident_phase(hk):
    """Slice F: the serve phase's model, weights and sessions in each
    serving mode, at float32 and bfloat16."""
    from eve_tpu_torch.models import eve as eve_lib
    out = {}
    for dtype in ('float32', 'bfloat16'):
        config = eval_config(tpu_compute_dtype=dtype)
        spec_ = eve_lib.EveSpec.from_config(config)
        with torch.device('meta'):  # names and shapes only
            skeleton = eve_lib.EVE(spec_)
        torch.cuda.reset_peak_memory_stats()
        out[dtype] = serving_modes(
            hk, spec_, random_state_dict(skeleton),
            'modes' if dtype == 'float32' else 'bf16 modes',
            out.get('float32'))
        out[dtype]['peak'] = torch.cuda.max_memory_allocated()
    return out


# ---------------------------------------------------------------------------
# The opt-in topology (slice G)
# ---------------------------------------------------------------------------

def native_serve_phase(hk, compute_dtype, ref32=None):
    """(a): the native model served in each mode; chunks vs one T=30
    forward and 4 clips card vs CPU (float32: CHUNK_PX_ATOL and
    CPU_PX_ATOL; bfloat16: within the drift from float32), a profiled
    B=8, T=10 forward and the peak memory."""
    import dataclasses

    from eve_tpu_torch.models import eve as eve_lib
    what = 'native serve' if compute_dtype == 'float32' else \
        'native bf16 serve'
    spec_ = eve_lib.EveSpec.from_config(eval_config(
        tpu_native_arch=True, tpu_compute_dtype=compute_dtype))
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    state_dict = random_state_dict(skeleton, seed=31)
    torch.cuda.reset_peak_memory_stats()
    modes = serving_modes(hk, spec_, state_dict, what, ref32)
    peak = torch.cuda.max_memory_allocated()
    results, streams = modes['runs']['default'][0], modes['streams']
    model = eve_lib.build_model(spec_, state_dict, 'cuda')
    cpu_model = eve_lib.build_model(spec_, state_dict, 'cpu')
    chunked = [{k: np.concatenate([results[(s, c)][k] for c in range(CHUNKS)])
                for k in results[(s, 0)]} for s in range(SESSIONS)]
    whole = forward_clips(model, streams, 'cuda')
    clips = [{k: v[:T] for k, v in st.items()}
             for st in streams[:BF16_CPU_CLIPS]]
    card, cpu = (forward_clips(model, clips, 'cuda'),
                 forward_clips(cpu_model, clips, 'cpu'))
    if compute_dtype == 'float32':
        chunk_errs, cpu_errs = {}, {}
        for s in range(SESSIONS):
            for k, v in compare(chunked[s], whole[s], '%s: session %d chunks '
                                'vs T=%d' % (what, s, CHUNKS * T),
                                CHUNK_PX_ATOL).items():
                chunk_errs[k] = max(chunk_errs.get(k, 0.0), v)
        for i in range(len(clips)):
            for k, v in compare(card[i], cpu[i], '%s: clip %d card vs CPU'
                                % (what, i), CPU_PX_ATOL).items():
                cpu_errs[k] = max(cpu_errs.get(k, 0.0), v)
        log('%s: chunked sessions vs one T=%d forward, max abs err %s; %d '
            'clips card vs CPU, max abs err %s' % (
                what, CHUNKS * T, json.dumps(chunk_errs), len(clips),
                json.dumps(cpu_errs)))
    else:
        model32 = eve_lib.build_model(
            dataclasses.replace(spec_, compute_dtype='float32'), state_dict,
            'cuda')
        drift_ratios(chunked, whole, forward_clips(model32, streams, 'cuda'),
                     '%s: chunked sessions vs one T=%d forward'
                     % (what, CHUNKS * T), BF16_CHUNK_RATIO)
        drift_ratios(card, cpu, forward_clips(model32, clips, 'cuda'),
                     '%s: %d clips, card vs CPU' % (what, len(clips)),
                     BF16_CPU_RATIO)
        del model32
    del cpu_model
    profile = profile_forward(model, [{k: v[:T] for k, v in st.items()}
                                      for st in streams],
                              what=what + ' profile')
    log('%s: peak device memory %.2f GiB while serving' % (what,
                                                           peak / 2 ** 30))
    return {'modes': modes, 'profile': profile, 'peak': peak}


def native_training_phase(hk, card, compute_dtype):
    """(b): NATIVE_STEPS configs/refine_net.json steps of the native
    topology at B = TRAIN_B, T = TRAIN_T through the harness, the last one
    checkpointed and read back bitwise through ``infer.model_setup``, a
    profiled step and (float32) one B=CMP_B, T=CMP_T step card vs CPU."""
    from eve_tpu_torch import infer
    from eve_tpu_torch.data.loader import to_device
    from eve_tpu_torch.train import harness

    what = 'native train' if compute_dtype == 'float32' else \
        'native bf16 train'
    train_sets = [spec('synthetic_native', 15, TRAIN_B * NATIVE_STEPS)]
    test_sets = [spec('synthetic_val', 12, VAL_CLIPS)]
    overrides = {'tpu_native_arch': True, 'tpu_compute_dtype': compute_dtype}
    config = train_config(checkpoints_save_every_n_steps=NATIVE_STEPS,
                          test_every_n_steps=1000, **overrides)
    torch.cuda.reset_peak_memory_stats(card)
    (exp, losses, walls), launches = counted(hk, lambda: run_training(
        config, train_sets, test_sets, card))
    peak = torch.cuda.max_memory_allocated(card)
    steps = len(losses)
    log('%s: %d steps, full_loss %s; kernel launches %s' % (
        what, steps, ', '.join('%.5f' % losses[k] for k in sorted(losses)),
        launches))
    if steps != NATIVE_STEPS or launches != {'render_heatmaps': 3 * steps,
                                             'soft_argmax': steps}:
        raise AssertionError('%s: %d steps, launches %s' % (what, steps,
                                                            launches))
    check_float32_state(exp.state, what)
    step_s = float(np.median(walls[1:]))
    log('%s: step wall %.1f ms (median of steps 2-%d, data wait included), '
        '%.1f training frames/s, peak device memory %.2f GiB (%s); walls '
        'ms %s' % (what, 1e3 * step_s, steps, TRAIN_B * TRAIN_T / step_s,
                   peak / 2 ** 30, card_line(),
                   ', '.join('%.1f' % (1e3 * w) for w in walls)))
    loaded = infer.model_setup(train_config(resume_from=exp.output_dir,
                                            **overrides), device=card)
    trained = exp.state.model.state_dict()
    if loaded.state_dict().keys() != trained.keys() or not all(
            torch.equal(v, trained[k]) for k, v in
            loaded.state_dict().items()):
        raise AssertionError('%s: the checkpoint of step %d does not read '
                             'back bitwise' % (what, steps))
    log('%s: checkpoint %s read back bitwise through infer.model_setup '
        '(%d tensors)' % (what, sorted(os.listdir(os.path.join(
            exp.output_dir, 'checkpoints'))), len(trained)))
    loader = harness.init_datasets(config, train_sets, test_sets)[0][
        'synthetic_native']['dataloader']
    batch, _ = to_device(next(iter(loader)), card)
    busy = profile_train_step(exp.state, batch, card,
                              what=what + ' profile')
    if compute_dtype == 'float32':
        compare_card_cpu(exp.spec, card, what)
    return {'launches': launches, 'step_ms': 1e3 * step_s, 'peak': peak,
            'busy': busy}


def native_variants_phase(hk, card):
    """(c): configs/eye_net.json with the patchify stem trained on the card,
    and one labelled forward each of the 'gated' readout and the
    'patchify8' stem: finite, of the right shapes, the gate's metrics
    there, render 2 (estimate and labels) and soft-argmax 1."""
    from eve_tpu_torch.models import eve as eve_lib
    eye = eye_net_phase(hk, card, native=True)
    clips = synthetic_clips(16, SESSIONS, T)
    batch = eve_lib.batch_to_tensors(
        {k: np.stack([c[k] for c in clips]) for k in clips[0]}, card)
    launches = {}
    for name, overrides in (('gated', {'tpu_native_refine_head': 'gated'}),
                            ('patchify8', {'tpu_native_stem': 'patchify8'})):
        spec_ = eve_lib.EveSpec.from_config(eval_config(
            tpu_native_arch=True, **overrides))
        with torch.device('meta'):  # names and shapes only
            skeleton = eve_lib.EVE(spec_)
        model = eve_lib.build_model(
            spec_, random_state_dict(skeleton, seed=33), card)
        with torch.inference_mode():
            model(batch, output_predictions=True)  # warm-up
            out, launches[name] = counted(
                hk, lambda: model(batch, output_predictions=True))
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        check_finite(out, ('PoG_px_initial', 'PoG_px_final', 'g_final',
                           'left_pupil_size', 'full_loss'),
                     'native %s forward' % name)
        if out['PoG_px_final'].shape != (SESSIONS, T, 2) or launches[name] \
                != {'render_heatmaps': 2, 'soft_argmax': 1}:
            raise AssertionError('native %s forward: PoG_px_final %s, '
                                 'launches %s' % (name, out['PoG_px_final']
                                                  .shape, launches[name]))
        extra = ''
        if name == 'gated':
            check_finite(out, ('metric_euc_PoG_px_heatmap_final',
                               'metric_mean_refine_gate'),
                         'native gated forward')
            extra = ', mean gate %.4f, heatmap-readout error %.1f px' % (
                out['metric_mean_refine_gate'],
                out['metric_euc_PoG_px_heatmap_final'])
        log('native %s: labelled forward B=%d T=%d finite, PoG_px_final x '
            'in [%.1f, %.1f]%s; kernel launches %s' % (
                name, SESSIONS, T, out['PoG_px_final'][..., 0].min(),
                out['PoG_px_final'][..., 0].max(), extra, launches[name]))
    return {'eye_net': eye, 'launches': launches}


def native_phase(hk, card, ref):
    """Slice G at full width, each figure beside the reference topology's
    of this run (``ref``: float32 and bfloat16 serving modes, forward
    profiles, training steps and Codalab batches)."""
    out = {}
    for dtype in ('float32', 'bfloat16'):
        tag = 'native' if dtype == 'float32' else 'native bf16'
        serve = native_serve_phase(hk, dtype,
                                   out.get('float32', {}).get('serve', {})
                                   .get('modes'))
        train = native_training_phase(hk, card, dtype)
        codalab = codalab_batch_phase(hk, card, tag + ' eval',
                                      tpu_native_arch=True,
                                      tpu_compute_dtype=dtype)
        out[dtype] = {'serve': serve, 'train': train, 'codalab': codalab}
        r = ref[dtype]
        prof, rprof = serve['profile'], r['serve_profile']
        log('%s vs reference (%s): serving forward B=%d T=%d %.2f ms wall vs '
            '%.2f, device busy %.2f ms vs %.2f (%.0f%% vs %.0f%%), %.0f '
            'launches vs %.0f; serving peak %.2f GiB vs %.2f' % (
                tag, card_line(), SESSIONS, T, prof['wall_ms'],
                rprof['wall_ms'], prof['busy_ms'], rprof['busy_ms'],
                100 * prof['busy'], 100 * rprof['busy'], prof['launches'],
                rprof['launches'], serve['peak'] / 2 ** 30,
                r['modes']['peak'] / 2 ** 30))
        for mode in SERVING_MODES:
            a, b = serve['modes']['timing'][mode], r['modes']['timing'][mode]
            log('%s vs reference: %s dispatch %.2f ms wall vs %.2f, %.2f ms '
                'device vs %.2f, %.2f ms host vs %.2f' % (
                    tag, mode, a['wall_ms'], b['wall_ms'], a['device_ms'],
                    b['device_ms'], a['host_ms'], b['host_ms']))
        log('%s vs reference: configs/refine_net.json step B=%d T=%d %.1f ms '
            'vs %.1f, %.1f training frames/s vs %.1f, busy %.0f%% vs %.0f%%, '
            'peak %.2f GiB vs %.2f' % (
                tag, TRAIN_B, TRAIN_T, train['step_ms'], r['train']['step_ms'],
                1e3 * TRAIN_B * TRAIN_T / train['step_ms'],
                1e3 * TRAIN_B * TRAIN_T / r['train']['step_ms'],
                100 * train['busy'], 100 * r['train']['busy'],
                train['peak'] / 2 ** 30, r['train']['peak'] / 2 ** 30))
        log('%s vs reference: Codalab batch B=%d T=%d %.3f s vs %.3f, %.1f '
            'frames/s vs %.1f, busy %.0f%% vs %.0f%%, peak %.2f GiB vs %.2f'
            % (tag, CODALAB_BATCH, EVAL_T, codalab['batch_s'],
               r['eval']['batch_s'], CODALAB_BATCH * EVAL_T /
               codalab['batch_s'], CODALAB_BATCH * EVAL_T /
               r['eval']['batch_s'], 100 * codalab['busy'],
               100 * r['eval']['busy'], codalab['peak'] / 2 ** 30,
               r['eval']['peak'] / 2 ** 30))
    variants = native_variants_phase(hk, card)
    eye, reye = variants['eye_net'], ref['float32']['eye_net']
    log('native vs reference: configs/eye_net.json step B=%d T=%d %.1f ms vs '
        '%.1f, busy %.0f%% vs %.0f%%, peak %.2f GiB vs %.2f' % (
            EYE_B, TRAIN_T, eye['step_ms'], reye['step_ms'],
            100 * eye['busy'], 100 * reye['busy'], eye['peak'] / 2 ** 30,
            reye['peak'] / 2 ** 30))
    out['variants'] = variants
    return out


# ---------------------------------------------------------------------------
# AOT export and artifact serving (slice H), and remat
# ---------------------------------------------------------------------------

def export_child(args):
    """A child process of the export phase: ``cli.export_model.main`` on
    ``argv``; writes the export's wall time and the kernel launches of the
    whole process (tracing must launch none) to a JSON file."""
    record_path, argv = args[0], args[1:]
    sys.path.insert(0, ROOT)
    from eve_tpu_torch.cli import export_model
    from eve_tpu_torch.kernels import heatmap_kernels as hk
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    export_model.main(argv)
    with open(record_path, 'w') as f:
        json.dump({'seconds': time.perf_counter() - t0,
                   'launches': dict(hk.LAUNCHES)}, f)


def artifact_serve_child(args):
    """A child process of the export phase: ``ServingEngine(artifact=)``
    on the streaming artifact, the serve phase's rounds (SESSIONS x CHUNKS
    chunks, then LOOSE session-less requests) counted and timed as
    ``serving_modes`` times them, a foreign signature, and the
    non-streaming artifact (a session refused, the session-less round
    served); writes the outputs, the sessions' states, the launches, the
    times and the ``eve_tpu_torch.models`` modules it imported (there must
    be none) to a pickle. It waits for the artifact HTTP server on
    ``port``, which loads at the same time, before it times anything."""
    import pickle
    out_path, streaming_path, stateless_path, port = args
    sys.path.insert(0, ROOT)
    from eve_tpu_torch.kernels import heatmap_kernels as hk
    from eve_tpu_torch.serve import ServingEngine

    requests = session_requests(client_clips(1, SESSIONS, CHUNKS * T),
                                client_clips(2, LOOSE, T))
    t0 = time.perf_counter()
    engine = timed_engine(artifact=streaming_path, device='cuda',
                          max_batch=MAX_BATCH, max_delay_ms=20.0)
    record = {'load_s': time.perf_counter() - t0}
    try:
        wait_healthy(int(port), 300)
        serve_rounds(engine, requests)  # warm-up
        settle(engine, CHUNKS + 1)
        engine.walls.clear()
        batches = engine.get_stats()['batches']
        # --- the artifact's serving path, counted ---
        (results, states), record['launches'] = counted(
            hk, lambda: serve_rounds(engine, requests))
        # --- end of the counted run ---
        record['dispatches'] = settle(engine, CHUNKS + 1, batches)
        record['walls'] = list(engine.walls)
        record['busy_ms'], record['copies'] = profile_copies(
            lambda: serve_rounds(engine, requests),
            os.path.join(EXPORT_OUT, 'trace.json'))
        bad = {k: v[:T - 1] for k, v in requests[(0, 0)].items()}
        try:
            engine.infer(bad, timeout=300)
        except RuntimeError as e:
            record['foreign_signature'] = str(e)[:120]
    finally:
        engine.stop()
    record['results'] = results
    record['states'] = [state_leaves(s) for s in states]
    engine = ServingEngine(artifact=stateless_path, device='cuda',
                           max_batch=MAX_BATCH, max_delay_ms=20.0)
    try:
        try:
            engine.open_session()
        except RuntimeError as e:
            record['session_refused'] = str(e)[:120]
        loose = [key for key in requests if key[0] == 'loose']
        futures = {key: engine.submit(requests[key]) for key in loose}
        record['stateless'] = {k: f.result(timeout=600)
                               for k, f in futures.items()}
    finally:
        engine.stop()
    record['models'] = sorted(m for m in sys.modules
                              if m.startswith('eve_tpu_torch.models'))
    with open(out_path, 'wb') as f:
        pickle.dump(record, f)


class Process:
    """A child process whose output goes to ``<EXPORT_OUT>/<name>.log``."""

    def __init__(self, name, argv):
        self.name = name
        self.log_path = os.path.join(EXPORT_OUT, name + '.log')
        self.started = time.perf_counter()
        with open(self.log_path, 'w') as f:
            self.proc = subprocess.Popen(argv, cwd=ROOT, stdout=f,
                                         stderr=subprocess.STDOUT)

    def stop(self):
        """Kill the process if it still runs (a phase that failed)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, timeout, want=0):
        """Wait for the exit; raises unless it is ``want``; returns the
        seconds since the start."""
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        seconds = time.perf_counter() - self.started
        if code != want:
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            raise AssertionError('%s exited %s (want %s) after %.1f s:\n%s'
                                 % (self.name, code, want, seconds, tail))
        return seconds


def smoke_child(name, *args):
    return Process(name, [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
                          '--' + name.split('.')[0]] + list(args))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def wait_healthy(port, timeout, proc=None):
    """Wait until the server on ``port`` answers /healthz; ``proc``, if
    given, is its process, whose early exit raises with its log."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc is not None and proc.proc.poll() is not None:
            proc.finish(0)  # raises with its log
        try:
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=5)
            conn.request('GET', '/healthz')
            if conn.getresponse().status == 200:
                return
        except OSError:
            pass
        finally:
            conn.close()
        time.sleep(0.2)
    raise AssertionError('the artifact server did not come up in %d s'
                         % timeout)


def hold_against_live(got, want, what):
    """Served outputs (``{key: outputs}``) against the live engine's:
    bitwise, or within the chunked-vs-whole tolerances with the largest
    difference printed; returns it."""
    diff = max(float(np.abs(np.asarray(got[key][k], np.float64) -
                            np.asarray(want[key][k], np.float64)).max())
               for key in got for k in want[key])
    if diff == 0.0:
        log('%s: %d requests bitwise equal to the live engine\'s'
            % (what, len(got)))
        return diff
    log('%s: largest difference to the live engine %.4g' % (what, diff))
    for key in sorted(got, key=str):
        compare(got[key], want[key], '%s request %s' % (what, key),
                CHUNK_PX_ATOL)
    return diff


def artifact_forward(hk, spec_, state_dict, clips, what):
    """(c): ``spec_`` exported on the card (B = len(clips), T, uint8
    frames), loaded, and one dispatch of it counted; ``(outputs by clip,
    launches, export s, bytes)``."""
    from eve_tpu_torch.export import export_inference, load_exported
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob, launches = counted(hk, lambda: export_inference(
        spec_, state_dict, batch, device='cuda'))
    seconds = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError('%s: tracing launched %s' % (what, launches))
    artifact = load_exported(blob, 'cuda')
    artifact(batch)  # warm-up
    out, launches = counted(hk, lambda: artifact(batch))
    if launches != {'render_heatmaps': 1, 'soft_argmax': 1}:
        raise AssertionError('%s: a dispatch launched %s' % (what, launches))
    return ([{k: v[i].float().cpu().numpy() for k, v in out.items()}
             for i in range(len(clips))], launches, seconds, len(blob))


def op_overhead(hk, n=SESSIONS * T, calls=200):
    """Host microseconds a call of each custom op beside a direct call of
    its CUDA implementation (the same launch without the dispatcher), at
    the serving shape: a chain of ``calls`` calls, each kernel a few
    microseconds, so the host's enqueue time bounds the chain."""
    gen = np.random.RandomState(3)
    c = torch.from_numpy(gen.uniform(0, 1900, (n, 2)).astype(
        np.float32)).cuda()
    x = torch.from_numpy(gen.uniform(0, 1, (n, 72, 128)).astype(
        np.float32)).cuda()
    args = {'render_heatmaps': (c, [10.0], None, [128, 72], [1920.0, 1080.0]),
            'soft_argmax': (x, [128, 72], [1920.0, 1080.0], 100.0)}
    impls = {'render_heatmaps': (torch.ops.eve_tpu_torch.render_heatmaps,
                                 hk._render_cuda),
             'soft_argmax': (torch.ops.eve_tpu_torch.soft_argmax,
                             hk._soft_argmax_cuda)}
    out = {}
    with torch.inference_mode():
        for name, fns in impls.items():
            us = []
            for fn in fns + fns:  # op, direct, op, direct
                for _ in range(10):
                    fn(*args[name])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args[name])
                us.append(1e6 * (time.perf_counter() - t0) / calls)
                torch.cuda.synchronize()
            out[name] = {'op_us': min(us[0::2]), 'direct_us': min(us[1::2])}
            log('export: %s N=%d: %.1f us of host time a call through the '
                'custom op, %.1f us calling its CUDA implementation '
                'directly (%s)' % (name, n, out[name]['op_us'],
                                   out[name]['direct_us'], card_line()))
    return out


def grad_errors(got, want):
    """Worst L2 error over its layer's gradient norm and worst element
    error over its layer's largest element (a layer is a module's weight
    and bias together), each with its tensor."""
    layers = {}
    for name, g in want.items():
        layers.setdefault(name.rsplit('.', 1)[0], []).append(g.flatten())
    layer_max = {k: float(torch.cat(v).abs().max()) for k, v in layers.items()}
    layer_l2 = {k: float(torch.cat(v).norm()) for k, v in layers.items()}
    def ratio(err, scale):  # a layer without gradient must stay so
        return err / scale if scale else (0.0 if err == 0 else float('inf'))

    l2 = elem = (0.0, '')
    for name, g in want.items():
        layer = name.rsplit('.', 1)[0]
        d = got[name] - g
        l2 = max(l2, (ratio(float(d.norm()), layer_l2[layer]), name))
        elem = max(elem, (ratio(float(d.abs().max()), layer_max[layer]),
                          name))
    return l2, elem


def remat_run(hk, card, config, batch):
    """One ``config`` model from seeded weights (``random_state_dict``)
    on ``batch``: the gradients of one step, then REMAT_STEPS timed
    ``train_step``s after a warm-up; ``{'grads', 'step_ms', 'peak',
    'launches'}``."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib
    spec_ = eve_lib.EveSpec.from_config(config)
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    model = eve_lib.build_model(spec_, random_state_dict(skeleton, seed=7),
                                card)
    step_lib.accumulate_gradients(model, batch,
                                  harness.kappa_generator(0, 1000))
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    state = step_lib.create_train_state(config, model, 100)
    step_lib.train_step(state, batch, harness.kappa_generator(0, 0))
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    walls = []

    def steps():
        for i in range(REMAT_STEPS):
            t0 = time.perf_counter()
            step_lib.train_step(state, batch, harness.kappa_generator(0, i))
            torch.cuda.synchronize(card)
            walls.append(time.perf_counter() - t0)

    _, launches = counted(hk, steps)
    return {'grads': grads, 'step_ms': 1e3 * float(np.median(walls)),
            'peak': torch.cuda.max_memory_allocated(card),
            'launches': launches}


def remat_phase(hk, card, ref):
    """(d): ``tpu_remat`` 'refine' and 'all' on configs/refine_net.json at
    B = TRAIN_B, T = TRAIN_T, and 'eye' on configs/eye_net.json at
    B = EYE_B: step ms and peak GiB beside the no-remat run of the same
    model, weights and batch, and the gradients with remat held against
    those without at the card's float32 limits (CMP_GRAD_L2,
    CMP_GRAD_ELEM: the card is not deterministic)."""
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.models import eve as eve_lib

    def eye_config(**overrides):
        config = Config()
        config.import_json(os.path.join(ROOT, 'configs', 'eye_net.json'))
        config.import_dict(overrides)
        return config

    out = {}
    for name, make, b, modes, per_step, ref_ms, ref_peak in (
            ('refine_net.json', train_config, TRAIN_B, ('refine', 'all'),
             {'render_heatmaps': 3, 'soft_argmax': 1},
             ref['train']['step_ms'], ref['train']['peak']),
            ('eye_net.json', eye_config, EYE_B, ('eye',),
             {'render_heatmaps': 0, 'soft_argmax': 0},
             ref['eye_net']['step_ms'], ref['eye_net']['peak'])):
        clips = synthetic_clips(41, b, TRAIN_T)
        batch = eve_lib.batch_to_tensors(
            {k: np.stack([c[k] for c in clips]) for k in clips[0]}, card)
        runs = {mode: remat_run(hk, card, make(tpu_remat=mode), batch)
                for mode in ('none',) + modes}
        base = runs['none']
        for mode, run in runs.items():
            want = {k: v * REMAT_STEPS for k, v in per_step.items()}
            if run['launches'] != want:
                raise AssertionError('%s remat %s: %d steps launched %s'
                                     % (name, mode, REMAT_STEPS,
                                        run['launches']))
            if mode == 'none':
                continue
            l2, elem = grad_errors(run['grads'], base['grads'])
            log('remat: %s B=%d T=%d tpu_remat=%s: step %.1f ms vs %.1f '
                'without, peak %.2f GiB vs %.2f (training phase: %.1f ms, '
                '%.2f GiB) (%s); gradients vs without: worst L2 error %.3g '
                'of its layer\'s norm (%s), worst element error %.3g of its '
                'layer\'s largest (%s)' % (
                    name, b, TRAIN_T, mode, run['step_ms'], base['step_ms'],
                    run['peak'] / 2 ** 30, base['peak'] / 2 ** 30, ref_ms,
                    ref_peak / 2 ** 30, card_line(), l2[0], l2[1], elem[0],
                    elem[1]))
            if l2[0] > CMP_GRAD_L2 or elem[0] > CMP_GRAD_ELEM:
                raise AssertionError('%s remat %s: gradients beyond the '
                                     'limits: %s %s' % (name, mode, l2, elem))
            out['%s %s' % (name, mode)] = {
                k: run[k] for k in ('step_ms', 'peak', 'launches')}
            out['%s %s' % (name, mode)].update(
                base_ms=base['step_ms'], base_peak=base['peak'])
        del runs
    return out


def exported_variants(hk, card, live):
    """(c): one bfloat16 and one native forward of the serving shape
    exported on the card in this process, loaded, and one dispatch of each
    held to the live forward (bfloat16 within its drift from float32,
    native within the float32 tolerance); the dispatches' launches."""
    from eve_tpu_torch.models import eve as eve_lib
    streams = live['streams']
    clips = [{k: v[:T] for k, v in st.items()} for st in streams]
    variants = {}
    for tag, overrides, seed in (('bf16', {'tpu_compute_dtype': 'bfloat16'},
                                  0),
                                 ('native', {'tpu_native_arch': True}, 31)):
        vspec = eve_lib.EveSpec.from_config(eval_config(**overrides))
        with torch.device('meta'):  # names and shapes only
            vskeleton = eve_lib.EVE(vspec)
        vstate = random_state_dict(vskeleton, seed=seed)
        got, vlaunch, seconds, nbytes = artifact_forward(
            hk, vspec, vstate, clips, tag + ' artifact')
        want = forward_clips(eve_lib.build_model(vspec, vstate, card), clips,
                             card)
        if tag == 'bf16':
            import dataclasses
            want32 = forward_clips(eve_lib.build_model(
                dataclasses.replace(vspec, compute_dtype='float32'), vstate,
                card), clips, card)
            drift_ratios(got, want, want32, 'bf16 artifact vs live forward',
                         BF16_CHUNK_RATIO)
        else:
            errs = {}
            for i in range(len(clips)):
                for k, v in compare(got[i], want[i], 'native artifact clip %d'
                                    % i, CHUNK_PX_ATOL).items():
                    errs[k] = max(errs.get(k, 0.0), v)
            log('native artifact vs live forward: max abs err %s'
                % json.dumps(errs))
        log('%s artifact: exported on the card in %.1f s, %d bytes; a '
            'dispatch B=%d T=%d launched %s' % (tag, seconds, nbytes,
                                                 len(clips), T, vlaunch))
        variants[tag] = vlaunch
    return variants


def export_phase(hk, card, live, ref):
    """Slice H and remat, after the native phase: (a) the serve phase's
    weights written as a checkpoint and exported through the CLI in child
    processes, streaming and not, B = MAX_BATCH, T = T, uint8 frames; (b)
    ``ServingEngine(artifact=)`` in a child process that imports nothing
    of the model code, against the live default engine's outputs and
    states (``live``: the serving-modes phase's float32 run) and timed
    beside it, and one request over HTTP through ``cli.serve
    --serve-artifact``; (c) one bfloat16 and one native forward exported
    and held to the live forward; (d) remat (``remat_phase``)."""
    import pickle

    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import step as step_lib
    from eve_tpu_torch.train.checkpoint import CheckpointManager

    shutil.rmtree(EXPORT_OUT, ignore_errors=True)
    os.makedirs(EXPORT_OUT)
    run_dir = os.path.join(EXPORT_OUT, 'run')
    config = eval_config()
    spec_ = eve_lib.EveSpec.from_config(config)
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    state_dict = random_state_dict(skeleton)  # the serve phase's weights
    CheckpointManager(run_dir).save_at_step(1, step_lib.create_train_state(
        config, eve_lib.build_model(spec_, state_dict, 'cpu'), 1))

    # --- (a) export through the CLI, both artifacts at once ---
    paths = {kind: os.path.join(EXPORT_OUT, kind + '.pt2')
             for kind in ('streaming', 'stateless')}
    children = {kind: smoke_child(
        'export-child.' + kind, os.path.join(EXPORT_OUT, kind + '.json'),
        CONFIG, '--resume-from', run_dir, '--export-path', paths[kind],
        '--export-batch-size', str(MAX_BATCH), '--max-sequence-len', str(T),
        '--tpu-on-device-preprocess', 'yes', '--export-streaming',
        'yes' if kind == 'streaming' else 'no', '--device', 'cuda')
        for kind in paths}
    try:
        variants = exported_variants(hk, card, live)
        exports = {}
        for kind, child in children.items():
            seconds = child.finish(600)
            with open(os.path.join(EXPORT_OUT, kind + '.json')) as f:
                exports[kind] = dict(json.load(f), process_s=seconds,
                                     bytes=os.path.getsize(paths[kind]))
    finally:
        for child in children.values():
            child.stop()
    for kind, record in exports.items():
        if any(record['launches'].values()):
            raise AssertionError('%s export launched %s' % (
                kind, record['launches']))
        log('export: %s artifact B=%d T=%d uint8 through cli.export_model '
            'in a child: export %.1f s (process %.1f s), %d bytes, kernel '
            'launches %s' % (kind, MAX_BATCH, T, record['seconds'],
                             record['process_s'], record['bytes'],
                             record['launches']))

    # --- (b) serving from the artifacts, in children ---
    port = free_port()
    server = Process('serve-artifact', [
        sys.executable, '-m', 'eve_tpu_torch.cli.serve', '--serve-artifact',
        paths['streaming'], '--device', 'cuda', '--serve-port', str(port),
        '--serve-max-delay-ms', '5'])
    try:
        child = smoke_child('artifact-serve-child',
                            os.path.join(EXPORT_OUT, 'serve.pkl'),
                            paths['streaming'], paths['stateless'], str(port))
        child.finish(600)
        with open(os.path.join(EXPORT_OUT, 'serve.pkl'), 'rb') as f:
            rec = pickle.load(f)  # written by this script's child
        wait_healthy(port, 120, server)
        loose = client_clips(2, LOOSE, T)
        http_out = http_infer(('127.0.0.1', port), loose[0])
    finally:
        if server.proc.poll() is None:
            server.proc.send_signal(signal.SIGTERM)
        server.finish(60)
    if rec['models']:
        raise AssertionError('the artifact child imported %s' % rec['models'])
    if 'foreign_signature' not in rec or 'session_refused' not in rec:
        raise AssertionError('a foreign signature or a session on the '
                             'non-streaming artifact was served: %s' % {
                                 k: rec.get(k) for k in (
                                     'foreign_signature', 'session_refused')})
    launches = rec['launches']
    if rec['dispatches'] != CHUNKS + 1 or any(
            launches[k] != rec['dispatches'] for k in launches):
        raise AssertionError('artifact serving: %d dispatches, launches %s'
                             % (rec['dispatches'], launches))
    live_results, live_states = live['runs']['default']
    hold_against_live(rec['results'], live_results, 'artifact serve')
    state_diff = max(float(np.abs(a - np.asarray(b, np.float64)).max())
                     for st, lst in zip(rec['states'], live_states)
                     for a, b in zip(st, state_leaves(lst)))
    log('artifact serve: session states vs the live engine\'s: largest '
        'difference %.4g' % state_diff)
    for st, lst in zip(rec['states'], live_states):
        for a, b in zip(st, state_leaves(lst)):
            if not np.allclose(a, b, rtol=1e-4, atol=OTHER_ATOL):
                raise AssertionError('artifact session state differs by %g'
                                     % np.abs(a - b).max())
    hold_against_live(rec['stateless'], live_results,
                      'non-streaming artifact serve')
    hold_against_live({('loose', 0): http_out}, live_results,
                      'artifact over HTTP (cli.serve --serve-artifact)')
    wall_ms = 1e3 * float(np.mean(rec['walls']))
    device_ms = rec['busy_ms'] / rec['dispatches']
    timing = {'wall_ms': wall_ms, 'device_ms': device_ms,
              'host_ms': wall_ms - device_ms}
    base = live['timing']['default']
    log('artifact serve: %d dispatches of B=%d T=%d, kernel launches %s; a '
        'dispatch: %.2f ms wall, %.2f ms device busy, %.2f ms host vs the '
        'live default engine\'s %.2f, %.2f, %.2f (%s); load %.1f s; foreign '
        'signature refused (%s...); non-streaming artifact refused a '
        'session (%s...)' % (
            rec['dispatches'], MAX_BATCH, T, launches, wall_ms, device_ms,
            wall_ms - device_ms, base['wall_ms'], base['device_ms'],
            base['host_ms'], card_line(), rec['load_s'],
            rec['foreign_signature'][:40], rec['session_refused'][:40]))
    log('artifact serve: dispatch walls ms %s' % ', '.join(
        '%.2f' % (1e3 * w) for w in rec['walls']))

    overhead = op_overhead(hk)
    remat = remat_phase(hk, card, ref)
    return {'exports': exports, 'launches': launches, 'timing': timing,
            'variants': variants, 'remat': remat, 'overhead': overhead}



# ---------------------------------------------------------------------------
# Data parallelism (slice I): mesh serving, mesh eval, data-parallel training
# ---------------------------------------------------------------------------

def mesh_devices(replicas):
    """The phase's data mesh: the real ``make_mesh(1)``, or ``replicas``
    replicas that share cuda:0 (one card: the splitting, gathering and
    collectives run, the scaling does not)."""
    from eve_tpu_torch.parallel import mesh as mesh_lib
    if replicas == 1:
        return mesh_lib.make_mesh(1)
    return mesh_lib.make_mesh(devices=[torch.device('cuda', 0)] * replicas)


def mesh_serve_phase(hk, base):
    """(a): the serving-modes phase's sessions and weights through
    ``ServingEngine(mesh=)`` in each of MESH_SERVE_MODES, counted and timed
    as ``serving_modes`` times them; every output and session state held
    against the default engine's of that phase (``base``) at the serving
    tolerance (cuDNN may pick other algorithms at 4 slots than at 8)."""
    from eve_tpu_torch.models import eve as eve_lib
    spec_ = eve_lib.EveSpec.from_config(eval_config())
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    state_dict = random_state_dict(skeleton)  # the serving-modes weights
    requests = session_requests(client_clips(1, SESSIONS, CHUNKS * T),
                                client_clips(2, LOOSE, T))
    base_results, base_states = base['runs']['default']
    out = {'launches': {}, 'timing': {}}
    for name, replicas, resident in MESH_SERVE_MODES:
        engine = timed_engine(spec=spec_, params=state_dict,
                              mesh=mesh_devices(replicas),
                              max_batch=MAX_BATCH, max_delay_ms=20.0,
                              device_resident=resident)
        try:
            serve_rounds(engine, requests)  # warm-up
            settle(engine, CHUNKS + 1)
            engine.walls.clear()
            batches = engine.get_stats()['batches']
            # --- this mode's serving path, counted ---
            (results, states), launches = counted(
                hk, lambda: serve_rounds(engine, requests))
            # --- end of the counted run ---
            dispatches = settle(engine, CHUNKS + 1, batches)
            walls = list(engine.walls)
            busy_ms, _ = profile_copies(
                lambda: serve_rounds(engine, requests),
                os.path.join(SERVE_OUT, 'trace.json'))
        finally:
            engine.stop()
        want = {k: replicas * dispatches
                for k in ('render_heatmaps', 'soft_argmax')}
        if dispatches != CHUNKS + 1 or launches != want:
            raise AssertionError('%s: %d dispatches, launches %s, want %s'
                                 % (name, dispatches, launches, want))
        out_err = {}
        for key in sorted(base_results, key=str):
            check_outputs(results[key], T, '%s request %s' % (name, key))
            for k, e in compare(results[key], base_results[key],
                                '%s request %s vs the default engine'
                                % (name, key), CHUNK_PX_ATOL).items():
                out_err[k] = max(out_err.get(k, 0.0), e)
        state_err = 0.0
        for st, bst in zip(states, base_states):
            for a, b in zip(state_leaves(st), state_leaves(bst)):
                state_err = max(state_err, float(np.abs(a - b).max()))
                if not np.allclose(a, b, rtol=1e-4, atol=OTHER_ATOL):
                    raise AssertionError('%s: session state differs by %g'
                                         % (name, np.abs(a - b).max()))
        wall_ms = 1e3 * float(np.mean(walls))
        device_ms = busy_ms / dispatches
        out['launches'][name] = launches
        out['timing'][name] = {'wall_ms': wall_ms, 'device_ms': device_ms,
                               'host_ms': wall_ms - device_ms}
        log('mesh serve %s: %d dispatches of B=%d T=%d over %d replica(s) '
            'on cuda:0, kernel launches %s; a dispatch: %.2f ms wall, %.2f '
            'ms device busy, %.2f ms host (wall - device); walls ms %s (%s)'
            % (name, dispatches, MAX_BATCH, T, replicas, launches, wall_ms,
               device_ms, wall_ms - device_ms,
               ', '.join('%.2f' % (1e3 * w) for w in walls), card_line()))
        log('mesh serve %s vs the default engine (%d requests, %d '
            'sessions): max abs err %s, session states %.3g'
            % (name, len(base_results), len(states), json.dumps(out_err),
               state_err))
    return out


def mesh_eval_phase(hk, card):
    """(b): Codalab batches (CODALAB_CLIPS clips, a full batch of
    CODALAB_BATCH and a ragged one) through ``infer.iterator(mesh=)`` of
    two replicas on the card, against the same batches without a mesh;
    frames/s, batch walls and peak memory."""
    from eve_tpu_torch import infer
    from eve_tpu_torch.data.loader import DataLoader
    from eve_tpu_torch.models import eve as eve_lib
    spec_ = eve_lib.EveSpec.from_config(eval_config())
    with torch.device('meta'):  # names and shapes only
        skeleton = eve_lib.EVE(spec_)
    model = eve_lib.build_model(spec_, random_state_dict(skeleton, seed=21),
                                card)
    clips = EvalClips(23, CODALAB_CLIPS, EVAL_T, CODALAB_SEQUENCES,
                      labels=False)
    mesh = mesh_devices(2)

    def run(use_mesh, indices=None):
        loader = DataLoader(clips, batch_size=CODALAB_BATCH, num_workers=4,
                            indices=indices)
        walls, t0 = [], time.perf_counter()
        outs = []
        for _, _, o in infer.iterator(model, loader, create_images=False,
                                      materialize_inputs=False,
                                      mesh=mesh if use_mesh else None):
            walls.append(time.perf_counter() - t0)
            outs.append(o)
            t0 = time.perf_counter()
        return outs, walls

    # Warm-ups, a full batch each: cuDNN's choices at B = 128 and at the
    # replicas' B = 64.
    run(False, range(CODALAB_BATCH))
    torch.cuda.reset_peak_memory_stats(card)
    one, one_walls = run(False)
    one_peak = torch.cuda.max_memory_allocated(card)
    run(True, range(CODALAB_BATCH))
    torch.cuda.reset_peak_memory_stats(card)
    (two, walls), launches = counted(hk, lambda: run(True))
    peak = torch.cuda.max_memory_allocated(card)
    n_batches = len(two)
    want = {k: 2 * n_batches for k in ('render_heatmaps', 'soft_argmax')}
    if n_batches != -(-CODALAB_CLIPS // CODALAB_BATCH) or launches != want:
        raise AssertionError('mesh eval: %d batches, launches %s, want %s'
                             % (n_batches, launches, want))
    errs = {}
    for b, (got, ref) in enumerate(zip(two, one)):
        check_finite(got, ('PoG_px_initial', 'PoG_px_final',
                           'left_pupil_size'), 'mesh eval batch %d' % b)
        if not np.array_equal(got['timestamps'], ref['timestamps']):
            raise AssertionError('mesh eval batch %d: stamps differ' % b)
        for k, e in compare(got, ref, 'mesh eval batch %d vs one device' % b,
                            CHUNK_PX_ATOL).items():
            errs[k] = max(errs.get(k, 0.0), e)
    frames = CODALAB_CLIPS * EVAL_T
    log('mesh eval: %d clips of T=%d in %d batches of up to %d over 2 '
        'replicas on cuda:0 (%d clips a replica; the ragged batch padded to '
        'the full one, as eve_tpu pads it), kernel launches %s; %.1f '
        'frames/s (one device: %.1f), a full batch %.3f s (one device: '
        '%.3f), batch walls %s s (one device: %s), peak device memory %.2f '
        'GiB (one device: %.2f) (%s)' % (
            CODALAB_CLIPS, EVAL_T, n_batches, CODALAB_BATCH,
            CODALAB_BATCH // 2, launches, frames / sum(walls),
            frames / sum(one_walls), walls[0], one_walls[0],
            ', '.join('%.3f' % w for w in walls),
            ', '.join('%.3f' % w for w in one_walls), peak / 2 ** 30,
            one_peak / 2 ** 30, card_line()))
    log('mesh eval: outputs vs one device, max abs err %s' % json.dumps(errs))
    return {'launches': launches, 'frames_per_s': frames / sum(walls),
            'one_frames_per_s': frames / sum(one_walls), 'peak': peak,
            'one_peak': one_peak}


def dp_argv(steps):
    """The data-parallel runs' command line: configs/refine_net.json at
    full width, B = TRAIN_B, ``steps`` steps of one epoch, the final full
    test, ``--auto-resume yes``, the CLI phase's LR."""
    return [CONFIG, '--eye-net-load-pretrained', 'no',
            '--fully-reproducible', 'yes', '--auto-resume', 'yes',
            '--num-epochs', '1', '--base-learning-rate', str(CLI_BASE_LR),
            '--batch-size', str(TRAIN_B), '--log-every-n-steps', '1',
            '--checkpoints-save-every-n-steps', '1000',
            '--test-every-n-steps', '1000',
            '--test-num-samples', str(VAL_CLIPS),
            '--test-batch-size', str(TRAIN_B),
            '--full-test-batch-size', str(TRAIN_B),
            '--full-test-data-workers', '2', '--train-data-workers', '4',
            '--device', 'cuda:0']


def dp_child(args):
    """A child of the data-parallel phase: ``cli.train.run`` as the rank
    its environment names (none: one process), on ``steps`` x TRAIN_B
    in-memory clips, with the device group's ``backend`` ('' = the
    default, NCCL on the card); writes each step's full_loss and wall
    time, the final test and the kernel launches of the whole run."""
    record_path, out_base, steps, backend = args
    sys.path.insert(0, ROOT)
    from eve_tpu_torch.cli import train as train_cli
    from eve_tpu_torch.kernels import heatmap_kernels as hk
    from eve_tpu_torch.train import harness

    record = {'started': time.time(), 'losses': {}, 'walls': {},
              'images': {}, 'final_test': None}
    loop, final_test = harness.main_loop_iterator, harness.do_final_full_test

    def observed_loop(exp, train_data, test_data):
        t0 = time.perf_counter()
        for step, metrics, images in loop(exp, train_data, test_data):
            record['losses'][step] = float(metrics['full_loss'])  # syncs
            record['walls'][step] = time.perf_counter() - t0
            yield step, metrics, images
            t0 = time.perf_counter()

    def observed_final_test(exp, test_data):
        record['final_test'] = final_test(exp, test_data)
        return record['final_test']

    harness.main_loop_iterator = observed_loop
    harness.do_final_full_test = observed_final_test
    config, parsed = harness.script_init_common(dp_argv(int(steps)))
    hk.reset_launch_counts()
    try:
        train_cli.run(config, parsed.device,
                      [spec('synthetic', 11, int(steps) * TRAIN_B)],
                      [spec('synthetic_val', 12, VAL_CLIPS)],
                      output_dir_base=out_base, backend=backend or None)
    finally:
        record['launches'] = dict(hk.LAUNCHES)
        record['peak'] = torch.cuda.max_memory_allocated()
        with open(record_path, 'w') as f:
            json.dump(record, f)


class DpChild(Child):
    """``python chip_smoke.py --dp-child`` as rank ``rank`` of a
    torchrun-style world of ``world`` (``world`` 0: one process)."""

    def __init__(self, name, out_base, steps, world=0, rank=0, port=0,
                 backend=''):
        env = dict(os.environ)
        if world:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
        super().__init__(name, out_base, ['--dp-child', None, out_base,
                                          str(steps), backend], env,
                         DP_OUT)


def dp_world(name, steps, world, backend=''):
    """``world`` ranks (0: one process) started together; their
    ``(exit codes, records, children)``."""
    port = free_port()
    base = os.path.join(DP_OUT, name)
    children = [DpChild('%s-rank%d' % (name, r), base, steps, world, r,
                        port, backend) for r in range(max(world, 1))]
    results = [c.finish(900) for c in children]
    return [r[0] for r in results], [r[2] for r in results], children


def checkpoint_state(base, step):
    """The port's state dict of run ``base``'s checkpoint ``step``."""
    from eve_tpu_torch.utils import convert
    from eve_tpu_torch.utils.checkpoint import load_params
    (run_dir,) = [os.path.join(base, 'EVE', d)
                  for d in os.listdir(os.path.join(base, 'EVE'))]
    return convert.eve_state_dict(load_params(os.path.join(
        run_dir, 'checkpoints', '%07d.ckpt' % step))), run_dir


def hold_updates(got, want, initial, bound, what):
    """RefineNet's parameters after the run against the reference run's,
    as the CPU parity tests hold Adam's updates
    (``tests/test_torch_train_step.py``): every element within twice the
    step bound ``bound`` (the sum of the LRs) and 99% within 10% of it.
    Adam moves an element by about the LR whatever its gradient, so one
    whose gradient is float32 noise (a bias an instance norm cancels), or
    that the ill-conditioned gradient routes otherwise, may move either
    way. Returns the worst layer's difference over its reference update
    (final - initial) in L2 (a layer is a module's weight and bias
    together), printed, and the share of elements beyond 10% of the
    bound."""
    layers = {}
    for k in want:
        if k.startswith('refine_net.'):
            layers.setdefault(k.rsplit('.', 1)[0], []).append(k)
    worst, off, total = 0.0, 0, 0
    for layer, keys in sorted(layers.items()):
        diff = np.concatenate([(got[k] - want[k]).double().flatten().numpy()
                               for k in keys])
        upd = np.concatenate([(want[k] - initial[k]).double().flatten()
                              .numpy() for k in keys])
        l2 = np.linalg.norm(diff) / max(np.linalg.norm(upd), 1e-30)
        worst = max(worst, l2)
        if np.abs(diff).max() > 2.02 * bound:
            raise AssertionError('%s: layer %s parameters differ by %.3g of '
                                 'the step bound (element)'
                                 % (what, layer, np.abs(diff).max() / bound))
        off += int((np.abs(diff) > 0.1 * bound + 1e-7).sum())
        total += diff.size
    if off > 0.01 * total:
        raise AssertionError('%s: %d of %d parameters beyond 10%% of the '
                             'step bound' % (what, off, total))
    return worst, off / total


def dp_train_phase(hk):
    """(c): ``cli.train`` in child processes, ``configs/refine_net.json``
    at B = TRAIN_B, T = TRAIN_T, DP_STEPS steps and the final full test:
    one process; a world of one rank over NCCL; two ranks over gloo that
    share cuda:0 (B = TRAIN_B / 2 each): each held against the one
    process's losses and parameters at the card's limits. Then two gloo
    ranks for DP_PREEMPT_STEPS steps, SIGTERM to rank 1 only: both exit
    143 at the agreement step, and a restart with the same command
    continues there."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import optim as optim_lib
    shutil.rmtree(DP_OUT, ignore_errors=True)
    os.makedirs(DP_OUT)
    # The children need the card's memory that this process's caching
    # allocator keeps from the phases before.
    torch.cuda.empty_cache()
    runs = {}
    for name, world, backend in (('one', 0, ''), ('nccl', 1, ''),
                                 ('gloo', 2, 'gloo')):
        codes, records, children = dp_world(name, DP_STEPS, world, backend)
        if codes != [0] * len(codes):
            raise AssertionError('%s run exited %s; last lines:\n%s' % (
                name, codes, '\n'.join(l for c in children
                                       for l in c.lines[-20:])))
        for r in records:
            if sorted(r['losses']) != list(range(DP_STEPS)) or \
                    not r['final_test']:
                raise AssertionError('%s run: steps %s, final test %s'
                                     % (name, sorted(r['losses']),
                                        r['final_test']))
        runs[name] = {'records': records, 'children': children}
    for c in runs['nccl']['children']:
        if not c.grep('nccl device group'):
            raise AssertionError('the one-rank world did not run over NCCL')
    gloo = runs['gloo']['children']
    if not gloo[0].grep('gloo with CUDA tensors') or \
            not gloo[0].grep('> Saved parameters to') or \
            gloo[1].grep('> Saved parameters to'):
        raise AssertionError('two-rank run: gloo-on-CUDA log %s, saves by '
                             'rank 0 %d and rank 1 %d' % (
                                 gloo[0].grep('gloo with CUDA tensors'),
                                 len(gloo[0].grep('> Saved parameters')),
                                 len(gloo[1].grep('> Saved parameters'))))
    ref = runs['one']['records'][0]
    want = np.array([ref['losses'][s] for s in range(DP_STEPS)])
    config = train_config(base_learning_rate=CLI_BASE_LR)
    spec_ = eve_lib.EveSpec.from_config(config)
    initial = eve_lib.init_model(spec_, torch.Generator().manual_seed(0),
                                 'cpu').state_dict()
    schedule = optim_lib.make_schedule(config, DP_STEPS)
    bound = sum(schedule(u) for u in range(DP_STEPS))
    ref_state, _ = checkpoint_state(os.path.join(DP_OUT, 'one'), DP_STEPS)
    out = {'launches': {}, 'step_ms': {}}
    ref_ms = 1e3 * float(np.median([ref['walls'][s]
                                    for s in range(1, DP_STEPS)]))
    for name in ('nccl', 'gloo'):
        records = runs[name]['records']
        got = np.array([records[0]['losses'][s] for s in range(DP_STEPS)])
        for r in records[1:]:
            if [r['losses'][s] for s in range(DP_STEPS)] != got.tolist():
                raise AssertionError('%s: the ranks logged other losses'
                                     % name)
        np.testing.assert_allclose(got, want, **CMP_LOSS_TOL,
                                   err_msg='%s vs one process' % name)
        state, _ = checkpoint_state(os.path.join(DP_OUT, name), DP_STEPS)
        l2, off = hold_updates(state, ref_state, initial, bound,
                               '%s vs one process' % name)
        launches = {k: sum(r['launches'][k] for r in records)
                    for k in ('render_heatmaps', 'soft_argmax')}
        # A step renders 3 and soft-argmaxes 1 on every rank; the final
        # test's batches of TRAIN_B clips 2 and 1, split over the ranks.
        val_batches = len(records) * -(-VAL_CLIPS // TRAIN_B)
        wanted = {'render_heatmaps': 3 * DP_STEPS * len(records) +
                  2 * val_batches,
                  'soft_argmax': DP_STEPS * len(records) + val_batches}
        if launches != wanted:
            raise AssertionError('%s: launches %s, want %s'
                                 % (name, launches, wanted))
        step_ms = 1e3 * float(np.median([records[0]['walls'][s]
                                         for s in range(1, DP_STEPS)]))
        out['launches'][name] = launches
        out['step_ms'][name] = step_ms
        log('dp train %s (%d rank(s), B=%d T=%d a step, %d on each rank): '
            'full_loss %s vs one process %s, max rel err %.3g (limit rtol '
            '%g); parameters vs one process: %.3g%% of them beyond 10%% of '
            'the step bound %.3g (limit 1%%, all within twice it), the worst '
            'layer\'s difference %.3g of its update (L2); kernel launches %s'
            % (name, len(records), TRAIN_B, TRAIN_T,
               TRAIN_B // len(records), ', '.join('%.6f' % x for x in got),
               ', '.join('%.6f' % x for x in want),
               float(np.max(np.abs(got - want) / np.abs(want))),
               CMP_LOSS_TOL['rtol'], 100 * off, bound, l2, launches))
        log('dp train %s: step wall %.1f ms (median of steps 2-%d, rank 0) '
            'beside the one process\'s %.1f ms in this run; peak device '
            'memory %s GiB; one card (%s): not a scaling figure'
            % (name, step_ms, DP_STEPS, ref_ms, ', '.join(
                '%.2f' % (r['peak'] / 2 ** 30) for r in records),
               card_line()))
    out['step_ms']['one'] = ref_ms

    # --- SIGTERM to rank 1 of two: both stop at the agreement ---
    port, base = free_port(), os.path.join(DP_OUT, 'preempted')
    ranks = [DpChild('preempted-rank%d' % r, base, DP_PREEMPT_STEPS, 2, r,
                     port, 'gloo') for r in range(2)]
    ranks[1].wait_for('Step 2,', 600)
    ranks[1].proc.send_signal(signal.SIGTERM)
    results = [c.finish(300) for c in ranks]
    stop = DP_PREEMPT_STOP
    for c, (code, _, record) in zip(ranks, results):
        saved = c.grep('checkpoint saved at step')
        if code != 143 or not saved or \
                'checkpoint saved at step %d;' % stop not in saved[-1] or \
                sorted(record['losses']) != list(range(stop)):
            raise AssertionError('%s exited %s, log %s, steps %s'
                                 % (c.name, code, saved,
                                    sorted(record['losses'])))
    if ranks[1].grep('> Saved parameters to'):
        raise AssertionError('rank 1 wrote a checkpoint')
    _, run_dir = checkpoint_state(base, stop)
    log('dp train: SIGTERM to rank 1 of 2 after its log showed step 2: both '
        'ranks exited 143 with "checkpoint saved at step %d" (the agreement '
        'every 8 steps), rank 0 wrote %s' % (
            stop, os.path.relpath(os.path.join(run_dir, 'checkpoints',
                                               '%07d.ckpt' % stop), ROOT)))
    port = free_port()
    again = [DpChild('resumed-rank%d' % r, base, DP_PREEMPT_STEPS, 2, r, port,
                     'gloo') for r in range(2)]
    results = [c.finish(600) for c in again]
    for c, (code, _, record) in zip(again, results):
        if code != 0 or not c.grep('auto_resume: continuing %s' % run_dir) \
                or sorted(record['losses']) != list(
                    range(stop, DP_PREEMPT_STEPS)) or not record['final_test']:
            raise AssertionError('%s exited %s, steps %s' % (
                c.name, code, sorted(record['losses'])))
    log('dp train: the restart of both ranks continued %s at step %d, took '
        'steps %d-%d, ran the final test and exited 0' % (
            os.path.relpath(run_dir, ROOT), stop + 1, stop + 1,
            DP_PREEMPT_STEPS))
    return out


def main():
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA card visible (torch.cuda.is_available() '
            'is False)')
        return 2
    # The harness keeps an application's own SIGTERM handler: this one ends
    # the script, and the phases' finally blocks stop its child processes.
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    # cuDNN runs float32 convolutions in TF32 by default (about three
    # decimal digits); the port is held to float32 results, so TF32 is off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log('card:', card)
    log('torch %s, CUDA %s, python %s' % (torch.__version__,
                                         torch.version.cuda,
                                         sys.version.split()[0]))
    sys.path.insert(0, ROOT)
    from eve_tpu_torch.kernels import build
    from eve_tpu_torch.kernels import heatmap_kernels as hk

    path, seconds, compiler_out = build.compile_library(
        'heatmap_kernels', verbose=True)
    log('build: %s in %.1f s' % (os.path.relpath(path, ROOT), seconds))
    for line in compiler_out.splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ptxas:', line.strip())

    errs = kernel_phase(hk)
    timings = kernel_timings(hk, SESSIONS * T)
    timings_eval = kernel_timings(hk, CODALAB_N)
    launches, serve_profile = serve_phase(hk)
    resident = resident_phase(hk)
    train = training_phase(hk, torch.device('cuda', 0))
    cli = train_cli_phase(hk, torch.device('cuda', 0))
    evals = eval_phase(hk, torch.device('cuda', 0))
    f32 = {'serve_profile': serve_profile, 'train': train,
           'eye_net': cli['eye_net'], 'eval': evals,
           'modes': resident['float32']}
    bf16 = bf16_phase(hk, torch.device('cuda', 0), f32)
    native = native_phase(hk, torch.device('cuda', 0), {
        'float32': f32,
        'bfloat16': dict(bf16['figures'], modes=resident['bfloat16'])})
    exported = export_phase(hk, torch.device('cuda', 0), resident['float32'],
                            f32)
    mesh_serve = mesh_serve_phase(hk, resident['float32'])
    mesh_eval = mesh_eval_phase(hk, torch.device('cuda', 0))
    dp_train = dp_train_phase(hk)
    # Launch counts of the slice F and G paths, by JSON key.
    new_paths = {}
    for dtype, prefix in (('float32', ''), ('bfloat16', 'bf16_')):
        for mode in SERVING_MODES[1:]:
            new_paths[prefix + mode + '_serve_launches'] = \
                resident[dtype]['launches'][mode]
        nat = native[dtype]
        new_paths['native_%sserve_launches' % prefix] = \
            nat['serve']['modes']['launches']['default']
        new_paths['native_%sresident_serve_launches' % prefix] = \
            nat['serve']['modes']['launches']['resident']
        new_paths['native_%strain_launches' % prefix] = \
            nat['train']['launches']
        new_paths['native_%scodalab_launches' % prefix] = \
            nat['codalab']['launches']
    new_paths['native_eye_net_train_launches'] = \
        native['variants']['eye_net']['launches']
    for name, counts in native['variants']['launches'].items():
        new_paths['native_%s_forward_launches' % name] = counts
    # Slice H: tracing launches nothing; an artifact dispatch launches each
    # kernel once.
    for kind, record in exported['exports'].items():
        new_paths['%s_export_launches' % kind] = record['launches']
    new_paths['artifact_serve_launches'] = exported['launches']
    for tag, counts in exported['variants'].items():
        new_paths['%s_artifact_dispatch_launches' % tag] = counts
    for key, run in exported['remat'].items():
        new_paths['remat_%s_launches' % key.replace('.json', '').replace(
            ' ', '_')] = run['launches']
    # Slice I: each replica's forward launches each kernel once; each rank
    # renders 3 and soft-argmaxes 1 a step.
    for name, counts in mesh_serve['launches'].items():
        new_paths['%s_serve_launches' % name.replace(' ', '_')] = counts
    new_paths['mesh_2_codalab_launches'] = mesh_eval['launches']
    new_paths['dp_nccl_world1_train_launches'] = \
        dp_train['launches']['nccl']
    new_paths['dp_gloo_two_rank_train_launches'] = \
        dp_train['launches']['gloo']

    source = 'eve_tpu_torch/csrc/heatmap_kernels.cu'
    replaces = {'render_heatmaps': 'eve_tpu/kernels/heatmap_kernels.py:38',
                'soft_argmax': 'eve_tpu/kernels/heatmap_kernels.py:99'}
    kernels = [dict({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces[name],
                     'launches': launches[name],
                     'train_launches': train['launches'][name],
                     'launches_per_train_step': train['per_step'][name],
                     'launches_per_eval_batch': train['per_eval_batch'][name],
                     'train_cli_launches': cli['launches'][name],
                     'launches_per_two_source_step':
                         cli['per_step_two_sources'][name],
                     'eye_net_train_launches': cli['eye_net']['launches'][name],
                     'eval_launches': evals['launches'][name],
                     'launches_per_streamed_chunk': evals['per_chunk'][name],
                     'launches_per_codalab_batch': evals['per_batch'][name],
                     'bf16_serve_launches': bf16['serve'][name],
                     'bf16_train_launches': bf16['train'][name],
                     'bf16_eye_net_train_launches': bf16['eye_net'][name],
                     'bf16_codalab_launches': bf16['codalab'][name],
                     'max_abs_err': errs[name],
                     'n%d' % CODALAB_N: timings_eval[name]},
                    **{k: v[name] for k, v in new_paths.items()},
                    **timings[name])
               for name in ('render_heatmaps', 'soft_argmax')]
    for row in kernels:
        # Host time a call through the custom op and of the bare launch.
        row['op_host_us'] = exported['overhead'][row['name']]['op_us']
        row['direct_host_us'] = \
            exported['overhead'][row['name']]['direct_us']
    kernels[0]['s3'] = timings['render_heatmaps_s3']
    kernels[0]['n%d_s3' % CODALAB_N] = timings_eval['render_heatmaps_s3']
    log(json.dumps({'kernels': kernels}))
    log('card:', card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--train-cli-child']:
        train_cli_child(sys.argv[2:])
    elif sys.argv[1:2] == ['--export-child']:
        export_child(sys.argv[2:])
    elif sys.argv[1:2] == ['--artifact-serve-child']:
        artifact_serve_child(sys.argv[2:])
    elif sys.argv[1:2] == ['--dp-child']:
        dp_child(sys.argv[2:])
    else:
        sys.exit(main())
