#!/usr/bin/env python3
"""Export a trained EVE model as a self-contained AOT artifact.

Usage:
    python -m eve_tpu_torch.cli.export_model [config.json ...] [--flags] \
        --resume-from <run_dir> --export-path m.pt2 \
        [--export-batch-size 1] [--export-streaming yes] [--device cuda]

The counterpart of eve_tpu's ``export_model.py``, with its defaults: the
full pipeline (RefineNet with screen content), weights from
``--resume-from`` or the released weights (it refuses to export random
ones), and an example batch of ``export_batch_size`` clips of
``max_sequence_len`` frames at the configured eye and screen sizes,
without labels, with uint8 frames if ``tpu_on_device_preprocess`` is set
and float32 frames otherwise. The artifact (``eve_tpu_torch/export.py``)
bakes the weights in and fixes that one input signature; it serves only on
the device type it was exported on (``--device``) and under the same torch
version: ``python -m eve_tpu_torch.cli.serve --serve-artifact m.pt2``, or
``eve_tpu_torch.export.load_exported('m.pt2')(batch)``.
"""

import logging
import time

import numpy as np

from eve_tpu_torch.cli import common

logger = logging.getLogger(__name__)


def parse_config(argv=None):
    """``(config, args)``; the full pipeline unless flags say otherwise."""
    return common.parse_config(
        argv, 'Export EVE as an AOT artifact.', defaults={
            'fully_reproducible': True, 'refine_net_enabled': True,
            'load_screen_content': True})


def main(argv=None):
    import torch

    from eve_tpu_torch import infer
    from eve_tpu_torch.data.synthetic import make_synthetic_batch
    from eve_tpu_torch.export import export_inference
    from eve_tpu_torch.models import zoo

    config, args = parse_config(argv)
    zoo.refuse('export', config)
    if not config.export_path:
        raise ValueError('--export-path is required')
    if config.eyes_size[0] != config.eyes_size[1]:
        raise ValueError('square eyes only, got eyes_size %s'
                         % (config.eyes_size,))
    # cuDNN runs float32 convolutions in TF32 by default (about three
    # decimal digits); the port exports the float32 model, so TF32 is off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = infer.model_setup(config, require_weights=True,
                              device=args.device)
    example = make_synthetic_batch(
        np.random.RandomState(0), batch_size=config.export_batch_size,
        sequence_len=config.max_sequence_len,
        eyes_size=config.eyes_size[0],
        screen_size=tuple(config.screen_size),
        with_screen=model.spec.load_screen_content, with_gt=False,
        frame_dtype=(np.uint8 if config.tpu_on_device_preprocess
                     else np.float32))
    start = time.perf_counter()
    blob = export_inference(model.spec, model.state_dict(), example,
                            streaming=config.export_streaming,
                            device=args.device)
    with open(config.export_path, 'wb') as f:
        f.write(blob)
    logger.info('Wrote %s (%.1f MB, streaming=%s, B=%d, T=%d, %s frames, '
                'device %s) in %.1f s', config.export_path, len(blob) / 1e6,
                config.export_streaming, config.export_batch_size,
                config.max_sequence_len,
                'uint8' if config.tpu_on_device_preprocess else 'float32',
                args.device, time.perf_counter() - start)


if __name__ == '__main__':
    main()
