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
5. Prints the kernel table as one JSON line, the card, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the run exits non-zero without the last line.
Imports nothing of JAX or eve_tpu.
"""

import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'refine_net.json')

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
# Map counts the kernel phase holds the kernels at (80 = the serving shape).
KERNEL_NS = (0, 1, 17, 80, 240)


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

    # One backward through each autograd.Function, against autograd of the
    # plain version on the same inputs.
    c = torch.from_numpy(gen.uniform(0, 1900, (80, 2)).astype(
        np.float32)).to(dev)
    mask = (torch.arange(80, device=dev) % 3 != 0).float()
    g = torch.randn((3, 80, 72, 128), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    ci = c.clone().requires_grad_(True)
    hk.RenderHeatmaps.apply(ci, sigmas, mask, (128, 72),
                            (1920.0, 1080.0)).backward(g)
    cr = c.clone().requires_grad_(True)
    hk.make_heatmaps_multi_plain(cr, sigmas, mask).backward(g)
    assert_close(ci.grad, cr.grad, 'render backward', rtol=1e-4, atol=1e-6)
    x = _peaked_maps(gen, 80, 72, 128, dev)
    xi = x.clone().requires_grad_(True)
    gp = torch.randn((80, 2), device=dev,
                     generator=torch.Generator(dev).manual_seed(1))
    hk.SoftArgmax.apply(xi, (128, 72), (1920.0, 1080.0), 100.0).backward(gp)
    xr = x.clone().requires_grad_(True)
    hk.soft_argmax_plain(xr).backward(gp)
    assert_close(xi.grad, xr.grad, 'soft_argmax backward', rtol=1e-4,
                 atol=1e-4 * float(xr.grad.abs().max()))
    log('kernel phase: kernels match their plain versions at N=%s (render '
        'S=1 and S=3 masked; soft-argmax 72x128 and 144x256); max abs err '
        'render %.3g, soft-argmax %.3g px'
        % (list(KERNEL_NS), errs['render_heatmaps'], errs['soft_argmax']))
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

    source = 'eve_tpu_torch/csrc/heatmap_kernels.cu'
    replaces = {'render_heatmaps': 'eve_tpu/kernels/heatmap_kernels.py:38',
                'soft_argmax': 'eve_tpu/kernels/heatmap_kernels.py:99'}
    kernels = [dict({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces[name],
                     'launches': launches[name],
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
