"""Recorded face video evaluated offline through ``infer.iterator``: the
Codalab-style evaluation path of a face model (Gaze360).

Unlabelled clips of the configuration's ``test_batch_size`` x
``max_sequence_len`` face frames (its ``face_size``, its frame rate),
uint8 on the host as the reader hands ``camera_frame_type='face'`` clips
(``frame``), with each frame's face origin and rotation (``face_o``,
``face_R``), the camera's transforms and px/mm, and int64 nanosecond
stamps, go through ``infer.iterator(model, batches, create_images=False,
materialize_inputs=False)``, the evaluation CLI's call;
``distinct_batches`` seeded batches are cycled. The window runs whole
batches until ``--seconds`` have passed; the rate is every frame of those
batches over the time they took.

A face frame is a seeded low-frequency pattern (4x4 colours, bilinearly
spread) under pixel noise, drawn on the card in one call: a random
backbone's pooled features barely tell frames of pure noise apart.

``correct``: once the window has closed and the model is gone, the
reference evaluates each distinct batch once in its literal windowed form,
in blocks of clips, and every batch the window produced is compared with
it: the mean angle between the gazes a frame (``gaze_deg_mean``) and the
mean gap between the points of gaze a frame in screen px
(``pog_px_mean``).
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import compare, harness, synthetic, weights as weights_lib
from benchmark.reference import gaze360 as ref

COMPARED = ('g_initial', 'PoG_px_initial')
CHECKS = ('gaze_deg_mean', 'pog_px_mean')
SCREEN_PX = (1920.0, 1080.0)
# Colours of a frame's low-frequency pattern, and its share of a frame.
PATTERN_PX = 4
PATTERN_SHARE = 0.75
# Faces whose statistics the norms' running statistics take.
CALIBRATION_FRAMES = 64


def shapes(cfg):
    """``(batch, sequence_len, face_px, frame_rate_hz)`` of a face
    configuration."""
    w, h = cfg['face_size']
    if w != h:
        raise ValueError('face_size %r is not square' % (cfg['face_size'],))
    return (cfg['test_batch_size'], cfg['max_sequence_len'], w,
            cfg['assumed_frame_rate'])


def face_frames(generator, n, px):
    """(n, px, px, 3) uint8 face frames on the host, drawn on
    ``generator``'s device."""
    device = generator.device
    low = torch.rand((n, 3, PATTERN_PX, PATTERN_PX), generator=generator,
                     device=device)
    noise = torch.rand((n, 3, px, px), generator=generator, device=device)
    x = PATTERN_SHARE * F.interpolate(low, size=(px, px), mode='bilinear',
                                      align_corners=False)
    x = (x + (1.0 - PATTERN_SHARE) * noise).mul_(255.0).round_()
    # NHWC and contiguous, as the reader hands frames.
    return x.to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


# The camera's and each clip's face's largest turn about x and y, rad.
CAMERA_TURN, FACE_TURN = 0.05, 0.15


def face_batch(rng, B, T, px, fps, generator):
    """A (B, T) clip batch of numpy arrays: the face frames and the
    geometry that places each face about 600 mm in front of the screen
    (the camera at the screen's centre, as ``benchmark.synthetic`` puts
    it), turned little enough that nearly every gaze of a random Gaze360
    meets the screen inside its edges."""
    ppm = np.array([SCREEN_PX[0] / synthetic.SCREEN_MM[0],
                    SCREEN_PX[1] / synthetic.SCREEN_MM[1]], np.float32)
    cam_T = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    face_R = np.zeros((B, T, 3, 3), np.float32)
    for b in range(B):
        cam_T[b, :, :3, :3] = synthetic._rotation(
            rng.uniform(-CAMERA_TURN, CAMERA_TURN, 2))
        cam_T[b, :, :3, 3] = np.array(
            [rng.uniform(-40, 40) - synthetic.CAMERA_MM[0],
             rng.uniform(-20, 20) - synthetic.CAMERA_MM[1],
             rng.uniform(-10, 10)], np.float32)
        face_R[b] = synthetic._rotation(rng.uniform(-FACE_TURN, FACE_TURN,
                                                    2))
    face_o = np.stack([rng.uniform(-30, 30, (B, T)),
                       rng.uniform(-20, 20, (B, T)),
                       rng.uniform(550, 650, (B, T))], -1).astype(np.float32)
    ones = np.ones((B, T), np.float32)
    return {
        'frame': face_frames(generator, B * T, px).reshape(B, T, px, px, 3),
        'face_o': face_o, 'face_o_validity': ones,
        'face_R': face_R, 'face_R_validity': ones.copy(),
        'camera_transformation': cam_T,
        'inv_camera_transformation': np.linalg.inv(cam_T).astype(
            np.float32),
        'millimeters_per_pixel': np.tile((1.0 / ppm).astype(np.float32),
                                         (B, T, 1)),
        'pixels_per_millimeter': np.tile(ppm, (B, T, 1)),
        # The reader's stamps: int64 nanoseconds, rebased by the iterator.
        'timestamps': (np.arange(T, dtype=np.int64) * int(1e9 / fps)
                       + 1_600_000_000_000_000_000)[None].repeat(B, 0),
    }


def make_batches(cell, seed, device):
    B, T, px, fps = shapes(cell.config['config'])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) + 1)
    rng = synthetic.rng_for(seed, 1)
    return [face_batch(rng, B, T, px, fps, gen)
            for _ in range(cell.params['distinct_batches'])]


def make_weights(cell, seed, device):
    """The seeded weights (``reference.gaze360.param_specs``), each norm's
    running statistics then set to those of its input over
    ``CALIBRATION_FRAMES`` seeded faces (``reference.gaze360.calibrated``,
    in float32): a random network whose norms hold its data's statistics,
    as a trained one's do. Drawn statistics leave a random backbone's
    features nearly the same for every frame, so that each seed's rounding
    would reach the gazes as one offset."""
    cfg = cell.config['config']
    weights = weights_lib.make_weights(ref.param_specs(cfg), seed, device,
                                       cell.config['weights'])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) + 2)
    frames = face_frames(gen, CALIBRATION_FRAMES, shapes(cfg)[2])
    with harness.float32_mode():
        return ref.calibrated(weights, torch.from_numpy(frames).to(device))


def build_program(cell, weights, device):
    """The program's model, as its configuration's ``gaze_net`` selects it
    (``models.zoo``), holding ``weights``."""
    from eve_tpu_torch.models import zoo
    spec = zoo.spec_from_config(harness.port_config(cell.config['config']))
    state = dict(weights)
    state.update({k: v.to(device) for k, v in ref.norm_buffers(
        ref.param_specs(cell.config['config'])).items()})
    return zoo.build_model(spec, state, device)


def run(cell, seed, seconds, trace, device, start):
    from eve_tpu_torch import infer
    p = cell.params
    cfg = cell.config['config']
    weights = make_weights(cell, seed, device)
    model = build_program(cell, weights, device)
    batches = make_batches(cell, seed, device)
    B, T, px, _ = shapes(cfg)
    frames = B * T

    def evaluate(feed):
        return infer.iterator(model, feed, create_images=False,
                              materialize_inputs=False)

    for _ in evaluate(batches):   # warm-up: every distinct batch once
        pass
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    def cycle():
        i = 0
        while True:
            yield batches[i % len(batches)]
            i += 1

    tracer = None
    if trace:
        from benchmark.trace import Tracer
        tracer = Tracer(device)
    first, last = p['trace_batches']
    kept = []
    t0 = time.perf_counter()
    setup_s = t0 - start
    for step, _, out in evaluate(cycle()):
        kept.append({k: out[k] for k in COMPARED})
        if tracer is not None and step + 1 == first:
            tracer.start()
        if tracer is not None and step + 1 == last:
            tracer.stop()
        if time.perf_counter() - t0 >= seconds and (
                tracer is None or tracer.stopped):
            break
    window_s = time.perf_counter() - t0
    record = {
        'setup_s': setup_s, 'window_s': window_s,
        'on_card': device.type == 'cuda',
        'units': len(kept), 'frames': len(kept) * frames,
        'stretch': tracer.read() if tracer else None,
        'stretch_units': last - first,
        'flops_per_unit': None, 'backbone_flops_per_unit': None,
        'peak_flops_dtype': cfg.get('tpu_compute_dtype', 'float32'),
    }
    if trace:
        from benchmark.reference import work
        record['backbone_flops_per_unit'] = work.gaze360_backbone(
            cfg, B * T, px)
        record['flops_per_unit'] = (record['backbone_flops_per_unit']
                                    + work.gaze360_temporal(cfg, B * T))
    harness.note('face_offline: %d batches of %d frames in %.3f s'
                 % (len(kept), frames, window_s))
    holder = {'model': model}

    def release():
        holder.clear()
        if device.type == 'cuda':
            torch.cuda.empty_cache()

    def check():
        return check_batches(cell, weights, batches, kept, device)

    return harness.Run(record=record, attempted=len(kept), failed=0,
                       release=release, check=check)


def reference_batch(cfg, weights, batch, device, block, quant=None):
    """The reference's outputs for one host batch, ``block`` clips at a
    time."""
    outs = {k: [] for k in COMPARED}
    B = batch['frame'].shape[0]
    for a in range(0, B, block):
        part = {k: torch.from_numpy(np.ascontiguousarray(v[a:a + block]))
                .to(device) for k, v in batch.items()
                if k != 'timestamps'}
        with torch.no_grad():
            out = ref.forward(weights, cfg, part,
                              quant=quant or (lambda t: t))
        for k in COMPARED:
            outs[k].append(out[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in outs.items()}


def angle_gaps_deg(got, want):
    """Each frame's angle in degrees between two (..., 2) (pitch, yaw)
    gaze arrays."""
    def vector(a):
        a = np.asarray(a, np.float64).reshape(-1, 2)
        p, y = a[:, 0], a[:, 1]
        return np.stack([np.cos(p) * np.sin(y), np.sin(p),
                         np.cos(p) * np.cos(y)], -1)
    cos = (vector(got) * vector(want)).sum(-1)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def collect(pairs, got, want):
    """Add each compared frame's program and reference outputs to
    ``pairs`` ({output: ([program arrays], [reference arrays])})."""
    for key in COMPARED:
        mine, theirs = pairs.setdefault(key, ([], []))
        mine.append(np.asarray(got[key]).reshape(-1, 2))
        theirs.append(np.asarray(want[key]).reshape(-1, 2))


def judged(pairs, limits):
    """``(checks, info)``: the mean angular gap a frame in degrees and the
    mean point-of-gaze gap a frame in px, each against its limit; the
    gaps' quantiles and the share of the reference's points of gaze that
    the screen's edge did not clamp beside them."""
    both = {k: (np.concatenate(a), np.concatenate(b))
            for k, (a, b) in pairs.items()}
    info = {'g_initial_deg': compare.summary(
                angle_gaps_deg(*both['g_initial'])),
            'PoG_px_initial': compare.summary(
                compare.frame_gaps(*both['PoG_px_initial']))}
    pog = both['PoG_px_initial'][1]
    inside = ((pog > 0.0) & (pog < np.array(SCREEN_PX))).all(-1)
    info['pog_unclamped_share'] = float(inside.mean())
    values = {'gaze_deg_mean': info['g_initial_deg']['mean'],
              'pog_px_mean': info['PoG_px_initial']['mean']}
    return [(name, values[name], limits[name]) for name in CHECKS], info


def check_batches(cell, weights, batches, kept, device):
    with harness.float32_mode():
        cfg = cell.config['config']
        want = [reference_batch(cfg, weights, b, device,
                                cell.params['check_block_clips'])
                for b in batches]
        pairs = {}
        for i, got in enumerate(kept):
            collect(pairs, got, want[i % len(batches)])
        return judged(pairs, cell.limits)
