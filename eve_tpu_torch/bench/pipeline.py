"""Host data pipeline against the compute it feeds: decode, pack, copy, step.

The counterpart of eve_tpu's ``bench_pipeline.py``:

    python -m eve_tpu_torch.bench.pipeline [--device cuda|cpu]
        [--datasrc DIR] [--workers 0 1 2 4] [--batch 4] [--seq 6]
        [--eyes 128] [--steps 16] [--uint8] [--frame-cache DIR]

prints one JSON line a measurement, each with eve_tpu's metric name and
keys plus ``card``: first ``{"metric": "pipeline_compute_ceiling_fps",
"value": N, "unit": "frames/s"}``, the forward alone on two batches that
live on the device, cycled; then for each worker count
``{"metric": "pipeline_end_to_end_fps", "workers": w, "value": N,
"unit": "frames/s", "pct_of_ceiling": p}``: the reader's video decode and
label reads in ``w`` loader threads, the host-to-device copies through
``DevicePrefetcher(loader, device)`` and the forward, over ``--steps``
batches. With ``--frame-cache DIR`` the decode-once disk cache is on, each
worker count first runs one populating pass over the loader, and the
metric is ``pipeline_end_to_end_fps_warm_cache``.

The configuration is eve_tpu's: the EyeNet alone (no RefineNet, no screen
content), 10 Hz, ``webcam_c``, ``image`` stimuli of ``train01`` and
``train02``, shuffled batches from seed 0, and a segmentation cache in the
dataset's own ``.segcache``. The forward is ``full_loss`` of a seeded
``init_model``. A ``--datasrc`` that does not exist is written first with
the port's ``write_synthetic_dataset`` (240 frames a participant).
``--uint8`` is accepted and changes nothing: the port's reader always
emits uint8 frames, which the model scales on the device (eve_tpu's
``--uint8`` path).

The reader needs ``h5py``, and ``cv2`` or an ``ffmpeg`` binary to decode
(``cv2`` to write the dataset); without them the tool raises an
``ImportError`` naming what is missing before it measures anything. It
never makes frames up.
"""

import argparse
import importlib
import os
import shutil
import sys
import tempfile
import time

import torch

from eve_tpu_torch.bench import common

PARTICIPANTS = ('train01', 'train02')
NUM_FRAMES = 240


def require_libraries(write):
    """Raise an ``ImportError`` naming what the reader (and, with
    ``write``, the dataset writer) lacks: ``h5py``, and ``cv2`` or an
    ``ffmpeg`` binary."""
    missing = []
    for name in ('h5py', 'cv2'):
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    ffmpeg = shutil.which('ffmpeg')
    if not ffmpeg:
        missing.append('ffmpeg')
    need_cv2 = write or not ffmpeg
    if 'h5py' in missing or ('cv2' in missing and need_cv2):
        raise ImportError(
            'bench.pipeline reads EVE videos and labels: it needs h5py, and '
            'cv2 or an ffmpeg binary to decode (cv2 to write the dataset); '
            'missing: %s' % ', '.join(missing))


def pipeline_config(args):
    """eve_tpu's pipeline configuration as the port's ``Config``."""
    from eve_tpu_torch.config import Config
    cfg = Config()
    cfg.import_dict({
        'datasrc_eve': args.datasrc, 'max_sequence_len': args.seq,
        'assumed_frame_rate': 10, 'eyes_size': [args.eyes, args.eyes],
        'load_screen_content': False, 'refine_net_enabled': False,
        'frame_cache_dir': args.frame_cache,
    })
    return cfg


def make_loader(args, cfg, workers):
    """The reader over ``PARTICIPANTS``' ``webcam_c`` image clips and a
    shuffled loader of ``args.batch`` clips with ``workers`` threads."""
    from eve_tpu_torch.data.dataset import EVESequencesBase
    from eve_tpu_torch.data.loader import DataLoader
    # A segmentation cache of the dataset's own: the cache file is keyed by
    # rate and length only, so a shared one could hold another dataset's
    # windows.
    ds = EVESequencesBase(args.datasrc, config=cfg,
                          participants_to_use=list(PARTICIPANTS),
                          cameras_to_use=['webcam_c'],
                          types_of_stimuli=['image'],
                          cache_dir=os.path.join(args.datasrc, '.segcache'))
    return DataLoader(ds, batch_size=args.batch, shuffle=True,
                      drop_last=True, num_workers=workers, seed=0)


def measure(args):
    """The tool's JSON lines without ``card``: the ceiling first, then one
    a worker count."""
    from eve_tpu_torch.data.loader import DevicePrefetcher, to_device
    from eve_tpu_torch.data.synthetic import write_synthetic_dataset
    from eve_tpu_torch.models import eve as eve_lib

    device = common.resolve_device(args.device)
    write = not os.path.isdir(args.datasrc)
    require_libraries(write)
    if args.uint8:
        common.note('--uint8 changes nothing: the port\'s reader always '
                    'emits uint8 frames, scaled on the device')
    if write:
        write_synthetic_dataset(args.datasrc, participants=PARTICIPANTS,
                                num_frames=NUM_FRAMES, eyes_size=args.eyes)
    cfg = pipeline_config(args)
    model = common.init_flagship(eve_lib.EveSpec.from_config(cfg),
                                 device).eval()

    def infer(batch):
        return model(batch)['full_loss']

    lines = []
    frames = args.batch * args.seq
    with torch.inference_mode():
        # The ceiling: two batches on the device, cycled.
        it = iter(make_loader(args, cfg, 0))
        on_device = []
        for _ in range(2):
            on_device.append(to_device(next(it), device)[0])
        for b in on_device:
            infer(b)
        common.sync(device)
        t0 = time.perf_counter()
        for i in range(args.steps):
            infer(on_device[i % 2])
        common.sync(device)
        ceiling = frames * args.steps / (time.perf_counter() - t0)
        lines.append({'metric': 'pipeline_compute_ceiling_fps',
                      'value': round(ceiling, 1), 'unit': 'frames/s'})

        for workers in args.workers:
            loader = make_loader(args, cfg, workers)
            if args.frame_cache:
                # The populating pass (epoch 1): the timed loop is then the
                # warm regime of epoch 2 on.
                for _ in loader:
                    pass
            n = steps = 0
            t0 = time.perf_counter()
            while steps < args.steps:
                for batch, _extras in DevicePrefetcher(loader, device):
                    infer(batch)
                    n += frames
                    steps += 1
                    if steps >= args.steps:
                        break
            common.sync(device)
            fps = n / (time.perf_counter() - t0)
            lines.append({
                'metric': ('pipeline_end_to_end_fps_warm_cache'
                           if args.frame_cache else 'pipeline_end_to_end_fps'),
                'workers': workers,
                'value': round(fps, 1), 'unit': 'frames/s',
                'pct_of_ceiling': round(100.0 * fps / ceiling, 1)})
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--datasrc', default=os.path.join(
        tempfile.gettempdir(), 'eve_pipeline_bench_data'))
    p.add_argument('--workers', type=int, nargs='+', default=[0, 1, 2, 4])
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--seq', type=int, default=6)
    p.add_argument('--eyes', type=int, default=128)
    p.add_argument('--steps', type=int, default=16)
    p.add_argument('--uint8', action='store_true',
                   help='accepted; changes nothing (the reader always emits '
                        'uint8)')
    p.add_argument('--frame-cache', default='',
                   help='enable the decode-once disk cache at this path; '
                        'measures the warm regime after one populating pass '
                        'a worker count')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    args = p.parse_args(argv)
    for line in measure(args):
        common.emit(line, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
