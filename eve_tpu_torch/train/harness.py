"""Training harness on one device: datasets, run setup, the main loop.

The single-device part of ``eve_tpu/train/harness.py``:

- ``training_seed`` and ``init_datasets`` (taking dataset objects, which
  need only ``__len__`` and ``__getitem__``; one training source);
- ``Experiment``: the run directory ``EVE<suffix>/<timestamp>.<cfg hash>``
  (or ``resume_from``), the config written as ``configs/combined.json``,
  ``messages.log``, the scalar log and the checkpoint manager;
  ``build_training`` initialises the model (eve_tpu's initialisers, seed
  0), loads pretrained weights where the config asks for them (and raises
  where they are missing), and resumes from the newest checkpoint;
- ``main_loop_iterator``: steps per epoch, a kappa generator per step
  seeded from ``(training_seed, step)`` (so a resumed run draws the kappas
  the uninterrupted run would have drawn), the NaN watchdog (exit 1 before
  any save), the checkpoint cadence, live validation
  (``test_model_on_all``) and the final save.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
TF32 is off. The mesh, multi-host, preemption, Google Sheets, the profiler,
images and the final full test are later slices (ROADMAP.md).
"""

import hashlib
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from eve_tpu_torch.data.loader import DataLoader, DevicePrefetcher, to_device
from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.train import step as step_lib
from eve_tpu_torch.train.checkpoint import CheckpointManager
from eve_tpu_torch.train.logging_utils import Tensorboard
from eve_tpu_torch.utils import load_model

logger = logging.getLogger(__name__)


def training_seed(config):
    """Seed of the run-varying streams (shuffle order, kappa draws).

    0 under ``fully_reproducible`` (reruns are bit-identical on the CPU),
    else an entropy draw. Kept on the config object, so the loader and the
    training loop of one run agree.
    """
    seed = getattr(config, '_training_seed', None)
    if seed is None:
        seed = (0 if config.fully_reproducible
                else int.from_bytes(os.urandom(4), 'little'))
        config._training_seed = seed
        logger.info('Training seed: %d (fully_reproducible=%s)', seed,
                    config.fully_reproducible)
    return seed


def kappa_generator(seed, step):
    """The CPU generator of step ``step``'s kappa draws."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(mixed[0]))


def init_datasets(config, train_sets, test_sets):
    """Loaders for ``[(tag, dataset)]`` training and live-validation sets.

    The training loader yields micro-batches of ``batch_size /
    gradient_accumulation_steps`` clips, shuffled from ``training_seed``;
    each validation set is cut to ``test_num_samples`` clips drawn from a
    seed-0 permutation, as eve_tpu draws them.
    """
    if len(train_sets) != 1:
        raise NotImplementedError(
            'one training source; multi-source training is a later slice '
            '(ROADMAP.md)')
    accum = max(int(config.gradient_accumulation_steps), 1)
    if config.batch_size % accum:
        raise ValueError('batch_size %d must divide by '
                         'gradient_accumulation_steps %d'
                         % (config.batch_size, accum))
    train_data = {}
    for tag, dataset in train_sets:
        loader = DataLoader(dataset, batch_size=config.batch_size // accum,
                            shuffle=True, drop_last=True,
                            num_workers=config.train_data_workers,
                            seed=training_seed(config))
        train_data[tag] = {'dataset': dataset, 'dataloader': loader}
        logger.info('> Ready to use training dataset: %s (%d clips)',
                    tag, len(dataset))
    test_data = {}
    for tag, dataset in test_sets:
        indices = None
        if len(dataset) > config.test_num_samples:
            indices = sorted(np.random.RandomState(0).permutation(
                len(dataset))[:config.test_num_samples].tolist())
        loader = DataLoader(dataset, batch_size=config.test_batch_size,
                            num_workers=config.test_data_workers,
                            indices=indices)
        test_data[tag] = {'dataset': dataset, 'dataloader': loader}
        logger.info('> Ready to use evaluation dataset: %s (%d clips, '
                    'eval on %d)', tag, len(dataset), loader.num_entries)
    return train_data, test_data


def config_identity_hash(config):
    """md5[:6] of the config's values, ``resume_from`` left out (it says
    how the process was launched, not what it trains)."""
    values = config.get_all_key_values()
    values.pop('resume_from', None)
    return hashlib.md5(json.dumps(values, sort_keys=True).encode()
                       ).hexdigest()[:6]


def bootstrap_pretrained(config, model, pretrained_dir=None):
    """Load the pretrained submodules the config asks for; returns their
    names.

    Searched in ``pretrained_dir`` and ``$EVE_PRETRAINED_DIR``
    (``utils.load_model``): eve_tpu's native ``.npz`` first, then the
    released reference ``.pt``. With neither present this raises, so a run
    never trains against a random EyeNet that its config says is
    pretrained.
    """
    wanted = (['eye_net'] if config.eye_net_load_pretrained else []) + (
        ['refine_net'] if config.refine_net_enabled and
        config.refine_net_load_pretrained else [])
    for which in wanted:
        if not load_model.load_pretrained_into(model, config, which,
                                               pretrained_dir):
            raise FileNotFoundError(
                'config.%s_load_pretrained is set but neither %s nor %s was '
                'found (searched: %s); refusing to train against a randomly '
                'initialised %s' % (
                    which, *(load_model.pretrained_filename(config, which, e)
                             for e in ('.npz', '.pt')),
                    load_model.search_dirs(pretrained_dir) or ['<unset>'],
                    which))
    return wanted


class Experiment:
    """One training run: its directory, logs, model state and checkpoints."""

    def __init__(self, config, output_dir_base='./outputs', device='cuda'):
        self.config = config
        self.spec = eve_lib.EveSpec.from_config(config)
        self.device = torch.device(device)
        # float32 parity: cuDNN would run float32 convolutions in TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if config.resume_from:
            output_dir = config.resume_from
            self.identifier = '/'.join(output_dir.rstrip('/').split('/')[-2:])
        else:
            self.identifier = ('EVE' + config.identifier_suffix + '/' +
                               time.strftime('%y%m%d_%H%M%S') + '.' +
                               config_identity_hash(config))
            output_dir = os.path.join(output_dir_base, self.identifier)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        if not config.resume_from:
            os.makedirs(os.path.join(output_dir, 'configs'), exist_ok=True)
            with open(os.path.join(output_dir, 'configs', 'combined.json'),
                      'w') as f:
                json.dump(config.get_all_key_values(), f, indent=4,
                          sort_keys=True)
        self.tensorboard = Tensorboard(output_dir)
        self._log_handler = logging.FileHandler(
            os.path.join(output_dir, 'messages.log'))
        self._log_handler.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(message)s', '%d/%m %H:%M:%S'))
        logging.getLogger().addHandler(self._log_handler)
        self.checkpoint_manager = CheckpointManager(
            output_dir, keep_n=config.checkpoints_keep_n)
        self.state = None
        self.last_step = 0
        self.last_epoch = 0.0

    def build_training(self, updates_per_epoch):
        """Initialise the model and optimizer; load pretrained weights and
        resume where the config says so."""
        cfg = self.config
        model = eve_lib.init_model(self.spec, torch.Generator().manual_seed(0),
                                   self.device)
        logger.info('There are %d parameters (%d trainable).',
                    sum(p.numel() for p in model.parameters()),
                    sum(p.numel() for p in model.parameters()
                        if p.requires_grad))
        # Before the resume, so that the run's own checkpoints win.
        loaded = bootstrap_pretrained(cfg, model)
        if loaded:
            logger.info('Loaded pretrained components: %s', loaded)
        self.state = step_lib.create_train_state(cfg, model,
                                                 updates_per_epoch)
        if cfg.resume_from:
            self.last_step = self.checkpoint_manager.load_last_checkpoint(
                self.state)
        return self

    def close(self):
        """Finish checkpoint writes; close the logs."""
        try:
            self.checkpoint_manager.close()
        finally:
            self.tensorboard.close()
            logging.getLogger().removeHandler(self._log_handler)
            self._log_handler.close()


def step_modulo(current, interval_size):
    return current % interval_size == (interval_size - 1)


def main_loop_iterator(exp, train_data, test_data):
    """Generator over training steps; yields ``(step, metrics)``.

    ``metrics`` holds the step's 0-dim outputs and ``nan_flag`` as device
    tensors; the loop reads them on the host only at its log, checkpoint
    and test intervals. A step is a micro-step under gradient
    accumulation, as in eve_tpu.
    """
    config = exp.config
    ((tag, data),) = train_data.items()
    loader = data['dataloader']
    dataset_len = len(data['dataset'])
    local_batch = loader.batch_size
    accum = max(int(config.gradient_accumulation_steps), 1)
    steps_per_epoch = int(dataset_len / local_batch)
    num_training_steps = int(config.num_epochs * max(steps_per_epoch, 1))
    exp.build_training(max(1, max(steps_per_epoch, 1) // accum))
    seed = training_seed(config)
    if exp.last_step > 0:
        # Continue the data stream where the interrupted run stood.
        loader.fast_forward(exp.last_step)
    batches = None

    def next_batch():
        nonlocal batches
        for _ in range(2):
            if batches is None:
                batches = iter(DevicePrefetcher(loader, exp.device))
            try:
                return next(batches)[0]
            except StopIteration:
                batches = None
        raise RuntimeError('training loader %r yielded no batches (%d clips, '
                           'batch size %d, drop_last)'
                           % (tag, dataset_len, local_batch))

    def abort_if_nan(metrics):
        # Before any save, so that NaN parameters are never written.
        if bool(metrics['nan_flag']):
            logger.error('NaN encountered during training; aborting.')
            cleanup_and_quit(exp, exit_code=1)

    perf_t0 = time.perf_counter()
    perf_steps = 0
    perf_wait = 0.0
    for current_step in range(exp.last_step, num_training_steps):
        current_epoch = current_step * local_batch / dataset_len
        exp.tensorboard.update_current_step(current_step + 1)
        wait_start = time.perf_counter()
        batch = next_batch()
        perf_wait += time.perf_counter() - wait_start
        metrics = step_lib.train_step(exp.state, batch,
                                      kappa_generator(seed, current_step))
        exp.last_epoch = current_epoch
        exp.last_step = current_step
        yield current_step, metrics

        perf_steps += 1
        log_console = step_modulo(current_step, config.log_every_n_steps)
        log_scalars = step_modulo(current_step,
                                  config.tensorboard_scalars_every_n_steps)
        if log_console or log_scalars:
            abort_if_nan(metrics)
            keys = sorted(k for k in metrics if k != 'nan_flag')
            values = torch.stack([metrics[k].float() for k in keys]).tolist()
            host_metrics = dict(zip(keys, values))
            dt = time.perf_counter() - perf_t0
            steps_per_sec = perf_steps / max(dt, 1e-9)
            data_wait_pct = 100.0 * perf_wait / max(dt, 1e-9)
            perf_t0, perf_steps, perf_wait = time.perf_counter(), 0, 0.0
        if log_console:
            logger.info('Step %d, Epoch %.2f [%.2f steps/s, %.0f%% '
                        'data-wait]> %s', current_step + 1, current_epoch,
                        steps_per_sec, data_wait_pct,
                        ', '.join('%s: %.4g' % (k, host_metrics[k])
                                  for k in keys))
        if log_scalars:
            for key, value in host_metrics.items():
                if key.startswith('loss_'):
                    exp.tensorboard.add_scalar(
                        'train_losses/' + key[len('loss_'):], value)
                elif key.startswith('metric_'):
                    exp.tensorboard.add_scalar(
                        'train_metrics/' + key[len('metric_'):], value)
                else:
                    exp.tensorboard.add_scalar('train/' + key, value)
            exp.tensorboard.add_scalar('lr/epoch', current_epoch)
            exp.tensorboard.add_scalar('perf/steps_per_sec', steps_per_sec)
            exp.tensorboard.add_scalar('perf/data_wait_pct', data_wait_pct)
        if step_modulo(current_step,
                       config.tensorboard_learning_rate_every_n_steps):
            # The schedule's domain is optimizer updates.
            exp.tensorboard.add_scalar(
                'lr/optim_0', exp.state.schedule(current_step // accum))

        if step_modulo(current_step, config.checkpoints_save_every_n_steps):
            abort_if_nan(metrics)
            exp.checkpoint_manager.save_at_step(
                current_step + 1, exp.state,
                wait=not config.tpu_async_checkpoint)
        if step_modulo(current_step, config.test_every_n_steps):
            abort_if_nan(metrics)
            test_model_on_all(exp, test_data, current_step + 1)

    # The completed-step numbering of the periodic saves.
    exp.checkpoint_manager.save_at_step(exp.last_step + 1, exp.state)


def _pad_eval_batch(batch, full_size):
    """Pad a ragged eval batch to ``full_size`` clips with zero-validity
    copies of its last clip, so every eval batch has one shape. Every
    0-dim output is a validity-masked batch mean, so a padded clip adds 0
    to each; the caller weights the scalars by the padded size."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        fill = np.repeat(v[-1:], full_size - v.shape[0], axis=0)
        if k.endswith('_validity'):
            fill = np.zeros_like(fill)
        out[k] = np.concatenate([v, fill], axis=0)
    return out


def test_model_on_all(exp, test_data, current_step, log_key_prefix='test'):
    """Evaluate on every validation loader: per tag, the mean of each 0-dim
    output over its clips (batch means weighted by batch size)."""
    final_out = {}
    for tag, data_dict in test_data.items():
        loader = data_dict['dataloader']
        totals = {}
        for batch in loader:
            rows = next(v for v in batch.values()
                        if isinstance(v, np.ndarray)).shape[0]
            if rows < loader.batch_size:
                batch = _pad_eval_batch(batch, loader.batch_size)
                rows = loader.batch_size
            device_batch, _ = to_device(batch, exp.device)
            out = step_lib.eval_step(exp.state.model, device_batch)
            keys = sorted(k for k, v in out.items() if v.ndim == 0)
            values = torch.stack([out[k].float() for k in keys]).tolist()
            for k, v in zip(keys, values):
                totals[k] = totals.get(k, 0.0) + v * rows / loader.num_entries
        final_out[tag] = totals
        logger.info('%10s test: %s', '[%s]' % tag,
                    ', '.join('%s: %.4g' % (k, totals[k])
                              for k in sorted(totals)))
        exp.tensorboard.update_current_step(current_step)
        for k, v in totals.items():
            exp.tensorboard.add_scalar('%s_%s/%s' % (log_key_prefix, tag, k),
                                       v)
    return final_out


def cleanup_and_quit(exp, exit_code=0):
    exp.close()
    sys.exit(exit_code)
