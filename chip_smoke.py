#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Identifies the card (nvidia-smi name and power limit, torch and CUDA
   versions); exits non-zero without a card.
2. Builds the CUDA kernels from ``eve_tpu_torch/csrc`` with nvcc.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at N=0, 1, 17, 80, 240 (render for sigma 10, 3, 5 one at a time
   and all three with a validity mask in one launch; soft-argmax of 72x128
   maps in float32 and bfloat16, and of 144x256 maps at N=1, 17, 80; one
   backward through each ``autograd.Function``). Times both at the serving
   path's shapes (render also at S=3) beside an empty kernel of the same
   launch shape, the launch floor.
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
   an in-memory dataset of synthetic clips: 8 optimizer steps with a
   checkpoint and a live validation at step 4, then a fresh ``Experiment``
   resumed from that checkpoint runs steps 5-8 again. Checks finite
   losses, a bitwise unchanged EyeNet and a changed RefineNet, the
   checkpoint files, the resumed losses against the uninterrupted run's,
   the launches of each kernel per training step and per eval batch, one
   step on the card against the same step on the CPU (B = 2, T = 10), and
   prints step time, frames/s, peak memory, a profile of one step (the
   heatmap kernels' share included) and its forward, backward and update
   times.
6. Prints the kernel table as one JSON line, the card, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the run exits non-zero without the last line.
Imports nothing of JAX or eve_tpu.
"""

import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'refine_net.json')
# Run directories of the training phase (git-ignored).
TRAIN_OUT = os.path.join(ROOT, 'build', 'chip_smoke_train')

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
# Map counts the kernel phase holds the kernels at (80 = the serving shape,
# 240 = the training shape).
KERNEL_NS = (0, 1, 17, 80, 240)

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

    # The backward of each autograd.Function (the plain formula's, as
    # eve_tpu's custom_vjp), against autograd of the plain version on the
    # same inputs, at the serving and the training map counts.
    for n in (80, TRAIN_B * TRAIN_T):
        c = torch.from_numpy(gen.uniform(0, 1900, (n, 2)).astype(
            np.float32)).to(dev)
        mask = (torch.arange(n, device=dev) % 3 != 0).float()
        for sig, msk in (((10.0,), None), (sigmas, mask)):
            g = torch.randn((len(sig), n, 72, 128), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
            ci = c.clone().requires_grad_(True)
            hk.RenderHeatmaps.apply(ci, sig, msk, (128, 72),
                                    (1920.0, 1080.0)).backward(g)
            cr = c.clone().requires_grad_(True)
            hk.make_heatmaps_multi_plain(cr, sig, msk).backward(g)
            assert_close(ci.grad, cr.grad, 'render backward N=%d S=%d'
                         % (n, len(sig)), rtol=1e-4, atol=1e-6)
        x = _peaked_maps(gen, n, 72, 128, dev)
        xi = x.clone().requires_grad_(True)
        gp = torch.randn((n, 2), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
        hk.SoftArgmax.apply(xi, (128, 72), (1920.0, 1080.0),
                            100.0).backward(gp)
        xr = x.clone().requires_grad_(True)
        hk.soft_argmax_plain(xr).backward(gp)
        assert_close(xi.grad, xr.grad, 'soft_argmax backward N=%d' % n,
                     rtol=1e-4, atol=1e-4 * float(xr.grad.abs().max()))
    log('kernel phase: kernels match their plain versions at N=%s (render '
        'S=1 and S=3 masked; soft-argmax 72x128 and 144x256), backward at '
        'N=80 and %d; max abs err render %.3g, soft-argmax %.3g px'
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
    log('launch shapes: render %d CTAs (S=1), %d CTAs (S=3); soft-argmax '
        '%d CTAs in clusters of %d; %d SMs'
        % (render_ctas, render3_ctas, n * cluster, cluster, sms))
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


def http_infer(server, clip):
    buf = io.BytesIO()
    np.savez(buf, **clip)
    conn = http.client.HTTPConnection(*server.server_address, timeout=300)
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


def profile_forward(model, clips, steps=3):
    """Where one dispatch's time goes: wall ms, device-busy ms, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from eve_tpu_torch.models import eve as eve_lib
    batch = eve_lib.batch_to_tensors(
        {k: np.stack([c[k] for c in clips]) for k in clips[0]}, 'cuda')
    with torch.inference_mode():
        for _ in range(2):
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
    log('profile: forward B=%d T=%d: %.2f ms wall, %.2f ms device busy '
        '(%.0f%%), %.0f kernel launches'
        % (len(clips), T, wall_ms, busy_ms, 100 * busy_ms / wall_ms,
           launches))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log('profile:   %8.3f ms %5.0fx  %s'
            % (e.self_device_time_total / 1e3 / steps, e.count / steps,
               e.key[:90]))


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
        results[('loose', 1)] = http_infer(server, loose[1])
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
        profile_forward(model, [{k: v[:T] for k, v in st.items()}
                                for st in streams])
        labelled_forward_phase(hk, model, spec)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        http_thread.join(timeout=30)


# ---------------------------------------------------------------------------
# Training phase
# ---------------------------------------------------------------------------

class SyntheticClips:
    """An in-memory dataset of synthetic clips ('disc' eyes, uint8
    frames), built in one draw: ``dataset[i]`` is clip i's dict."""

    def __init__(self, seed, n, t, eyes=128):
        from eve_tpu_torch.data.synthetic import make_synthetic_batch
        batch = make_synthetic_batch(np.random.RandomState(seed),
                                     batch_size=n, sequence_len=t,
                                     eyes_size=eyes, frame_dtype=np.uint8)
        self.clips = [{k: v[i] for k, v in batch.items()} for i in range(n)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


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
    for step, metrics in harness.main_loop_iterator(exp, train_data,
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


def profile_train_step(state, batch, device, steps=2):
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
    log('train profile: step B=%d T=%d: %.2f ms wall (profiled), %.2f ms '
        'device busy (%.0f%%), %.0f kernel launches'
        % (TRAIN_B, TRAIN_T, wall_ms, busy_ms, 100 * busy_ms / wall_ms,
           launches))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log('train profile:   %8.3f ms %5.0fx  %s'
            % (e.self_device_time_total / 1e3 / steps, e.count / steps,
               e.key[:90]))
    heatmap_ms = sum(e.self_device_time_total for e in kernels
                     if 'render_heatmaps_kernel' in e.key or
                     'soft_argmax_kernel' in e.key) / 1e3 / steps
    log('train profile: the two heatmap kernels %.4f ms of device time a '
        'step (%.3f%% of the busy time)' % (heatmap_ms,
                                           100 * heatmap_ms / busy_ms))

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
    log('train profile: step phases (CUDA events, median of 3): %s'
        % ', '.join('%s %.2f ms' % (k, float(np.median(v)))
                    for k, v in phases.items()))
    return busy_ms / wall_ms


def counted(hk, fn):
    """Run ``fn`` with the launch counts at 0; ``(result, launches)``."""
    torch.cuda.synchronize()
    hk.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(hk.LAUNCHES)


def compare_card_cpu(spec, card):
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
    clips = SyntheticClips(7, CMP_B, CMP_T)
    batch = {k: np.stack([c[k] for c in clips.clips]) for k in clips[0]}
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
        log('train: %s, B=%d T=%d: worst L2 error %.3g of its layer\'s '
            'gradient norm (%s), worst element error %.3g of its layer\'s '
            'largest element (%s)' % (what, CMP_B, CMP_T, l2[0], l2[1],
                                      elem[0], elem[1]))
    l2, elem = results['card vs CPU']
    if l2[0] > CMP_GRAD_L2 or elem[0] > CMP_GRAD_ELEM:
        raise AssertionError('card vs CPU gradients beyond the limits (L2 '
                             '%g, element %g): %s' % (
                                 CMP_GRAD_L2, CMP_GRAD_ELEM, results))
    log('train: card vs CPU: full_loss %.7f on the CPU, %s on the card; all '
        '%d RefineNet gradients of %d card steps within %g (L2) and %g '
        '(element) of their layer\'s' % (
            loss[0], ', '.join('%.7f' % x for x in loss[2:]), len(cpu),
            CMP_CARD_STEPS, CMP_GRAD_L2, CMP_GRAD_ELEM))
    return l2[0], elem[0]


def training_phase(hk, card):
    """Train the full-width configs/refine_net.json model; returns the
    training path's launch counts and per-step figures."""
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import harness
    from eve_tpu_torch.train import step as step_lib

    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    t0 = time.perf_counter()
    train_sets = [('synthetic', SyntheticClips(11, TRAIN_B * TRAIN_STEPS,
                                               TRAIN_T))]
    test_sets = [('synthetic_val', SyntheticClips(12, VAL_CLIPS, TRAIN_T))]
    log('train: %d training and %d validation clips of T=%d built in %.1f s;'
        ' eye_net_load_pretrained overridden to false (seeded '
        'init_weights, no released weights in the checkout)'
        % (len(train_sets[0][1]), VAL_CLIPS, TRAIN_T,
           time.perf_counter() - t0))

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
            'busy': busy}


def main():
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA card visible (torch.cuda.is_available() '
            'is False)')
        return 2
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
    launches = serve_phase(hk)
    train = training_phase(hk, torch.device('cuda', 0))

    source = 'eve_tpu_torch/csrc/heatmap_kernels.cu'
    replaces = {'render_heatmaps': 'eve_tpu/kernels/heatmap_kernels.py:38',
                'soft_argmax': 'eve_tpu/kernels/heatmap_kernels.py:99'}
    kernels = [dict({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces[name],
                     'launches': launches[name],
                     'train_launches': train['launches'][name],
                     'launches_per_train_step': train['per_step'][name],
                     'launches_per_eval_batch': train['per_eval_batch'][name],
                     'max_abs_err': errs[name]}, **timings[name])
               for name in ('render_heatmaps', 'soft_argmax')]
    kernels[0]['s3'] = timings['render_heatmaps_s3']
    log(json.dumps({'kernels': kernels}))
    log('card:', card_line())
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
