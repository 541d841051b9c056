"""How long a checkpoint save blocks the training thread.

The counterpart of eve_tpu's ``bench_checkpoint.py``:

    python -m eve_tpu_torch.bench.checkpoint [--device cuda|cpu]
        [--reps 3] [--refine yes|no]

The state is ``create_train_state`` of the defaults (``Config()``, with
RefineNet and screen content under ``--refine yes``, the flagship) before
any update, saved through ``CheckpointManager(d, keep_n=3)`` in three
ways, each the median of ``--reps`` saves after one warm save:

- ``sync_blocked_s``: ``save_at_step(wait=True)``: snapshot, conversion
  and write inline;
- ``async_blocked_s`` (the ``value``): ``save_at_step(wait=False)``: only
  the host snapshot blocks;
- ``async_bg_write_s``: the background write that follows, joined with
  ``wait_for_writes()``: the budget it must fit inside the save interval.

Prints one JSON line, ``checkpoint_save_blocked_seconds`` with those keys,
``params`` (the parameter count, eve_tpu's for the same spec), ``refine``
and ``card``. A port checkpoint holds more files than eve_tpu's (its own
optimizer file beside eve_tpu's ``optimizer_0.npz``); their bytes go to
stderr, on a line before the JSON line.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

from eve_tpu_torch.bench import common


def measure_checkpoint(reps=3, refine=True, device='cuda'):
    """``(line, file bytes)``: the tool's JSON line without ``card``, and
    the bytes of each file of the last checkpoint."""
    from eve_tpu_torch.config import Config
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.train import step as step_lib
    from eve_tpu_torch.train.checkpoint import CheckpointManager

    device = common.resolve_device(device)
    config = Config()
    config.import_dict({'refine_net_enabled': refine,
                        'load_screen_content': refine})
    model = common.init_flagship(eve_lib.EveSpec.from_config(config), device)
    state = step_lib.create_train_state(config, model, 100)
    n_params = sum(p.numel() for p in state.model.parameters())
    sync_s, blocked_s, bg_s = [], [], []
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_n=3)
        try:
            mgr.save_at_step(0, state)  # warm: lazy imports, fs metadata
            step = 1
            for _ in range(reps):
                common.sync(device)
                t0 = time.perf_counter()
                mgr.save_at_step(step, state)
                sync_s.append(time.perf_counter() - t0)
                step += 1
            for _ in range(reps):
                common.sync(device)
                t0 = time.perf_counter()
                path = mgr.save_at_step(step, state, wait=False)
                t1 = time.perf_counter()
                mgr.wait_for_writes()
                blocked_s.append(t1 - t0)
                bg_s.append(time.perf_counter() - t1)
                step += 1
        finally:
            mgr.close()
        files = {name: os.path.getsize(os.path.join(path, name))
                 for name in sorted(os.listdir(path))}

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    return {
        'metric': 'checkpoint_save_blocked_seconds',
        'value': round(med(blocked_s), 4), 'unit': 's',
        'sync_blocked_s': round(med(sync_s), 4),
        'async_blocked_s': round(med(blocked_s), 4),
        'async_bg_write_s': round(med(bg_s), 4),
        'params': n_params, 'refine': refine,
    }, files


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--refine', default='yes',
                        help='flagship refine+screen state (no = eye only)')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda; raises without a '
                             'card)')
    args = parser.parse_args(argv)
    refine = args.refine.lower() in ('yes', 'true', '1')
    line, files = measure_checkpoint(args.reps, refine, args.device)
    common.note('checkpoint files: %s; %d bytes in all' % (
        ', '.join('%s %d bytes' % kv for kv in files.items()),
        sum(files.values())))
    common.emit(line, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
