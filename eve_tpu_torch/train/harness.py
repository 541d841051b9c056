"""Training harness on one device: CLI init, datasets, run setup, main loop.

The single-device part of ``eve_tpu/train/harness.py``:

- ``script_init_common``: the ``--flag`` CLI over every config key, JSON
  files then flags, ``np.random.seed(0)``;
- ``init_datasets`` over eve_tpu's spec tuples ``(tag, dataset_class,
  path, stimuli, cameras)``: it arms the SIGTERM handler first, builds one
  shuffled loader per training source and a ``SubsetLoader`` of
  ``test_num_samples`` clips per live-validation set (built with
  ``live_validation=True``);
- ``Experiment``: the run directory ``EVE<suffix>/<timestamp>.<cfg hash>``
  (or ``resume_from``, or with ``auto_resume`` the newest run of the same
  hash that holds a checkpoint), the config's provenance, ``messages.log``,
  the scalar and image log, the Google Sheets row and the checkpoint
  manager; ``build_training`` initialises the model (eve_tpu's
  initialisers, seed 0), loads pretrained weights where the config asks for
  them (and raises where they are missing), and resumes from the newest
  checkpoint;
- ``main_loop_iterator``: loop steps are micro-steps (``train_batch_echoing``
  of them a loaded batch, ``gradient_accumulation_steps`` of them an
  update); steps per epoch from the largest source; several sources train
  on the sum of their losses; a kappa generator per (seed, step, source)
  (so a resumed run draws the kappas the uninterrupted run would have
  drawn); the NaN watchdog (exit 1 before any save); preemption (SIGTERM:
  a checkpoint at the completed step and exit 143, checked after every
  step and every eval batch); the checkpoint cadence, live validation,
  training images, the profiler window and the final save; it yields
  ``(step, metrics, images)``;
- ``do_final_full_test`` and ``cleanup_and_quit``.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
TF32 is off. The mesh and multi-host are later slices (ROADMAP.md): this
is one process, so a preemption needs no agreement between hosts.
"""

import glob
import hashlib
import json
import logging
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from eve_tpu_torch.cli import common
from eve_tpu_torch.data.loader import DataLoader, DevicePrefetcher, to_device
from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.train import step as step_lib
from eve_tpu_torch.train.checkpoint import CheckpointManager
from eve_tpu_torch.train.gsheet import GoogleSheetLogger
from eve_tpu_torch.train.logging_utils import (
    Tensorboard, compose_training_images)
from eve_tpu_torch.utils import load_model

logger = logging.getLogger(__name__)

# Keys that say how a process was launched, not what it trains: left out
# of the run's identity hash, so a restart with the same argv plus
# ``--auto-resume yes`` finds the run it continues. (eve_tpu also leaves
# out its per-host wiring keys, which the port's config does not hold.)
NON_IDENTITY_KEYS = ('resume_from', 'auto_resume')
# Exit code of a preempted run: 128 + SIGTERM.
PREEMPTED_EXIT_CODE = 143


def script_init_common(argv=None, description='Train a gaze estimation model.'):
    """``(config, args)`` from JSON files and ``--flags``; seeds numpy's
    global stream with 0, as eve_tpu does."""
    config, args = common.parse_config(argv, description)
    np.random.seed(0)
    return config, args


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


def kappa_generator(seed, step, source=None):
    """The CPU generator of step ``step``'s kappa draws (of training
    source number ``source`` when there are several)."""
    entropy = (seed, step) if source is None else (seed, step, source)
    mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(mixed[0]))


def init_datasets(config, train_specs, test_specs):
    """Training and live-validation datasets and loaders.

    Spec tuples are ``(tag, dataset_class, path, stimuli, cameras)``, as
    eve_tpu's; a class is built as the EVE reader is,
    ``dataset_class(path, config=, cameras_to_use=, types_of_stimuli=)``.
    The SIGTERM handler is armed first: building datasets and the model
    takes a while, and a preemption notice in that window must not kill
    the process outright. Training loaders yield micro-batches of
    ``batch_size / gradient_accumulation_steps`` clips, shuffled from
    ``training_seed``; each validation set is cut to ``test_num_samples``
    clips drawn from a seed-0 permutation, as eve_tpu draws them.
    """
    _install_preemption_handler()
    accum = max(int(config.gradient_accumulation_steps), 1)
    if config.batch_size % accum:
        raise ValueError('batch_size %d must divide by '
                         'gradient_accumulation_steps %d'
                         % (config.batch_size, accum))
    train_data = {}
    for tag, dataset_class, path, stimuli, cameras in train_specs:
        dataset = dataset_class(path, config=config, cameras_to_use=cameras,
                                types_of_stimuli=stimuli)
        loader = DataLoader(dataset, batch_size=config.batch_size // accum,
                            shuffle=True, drop_last=True,
                            num_workers=config.train_data_workers,
                            seed=training_seed(config))
        train_data[tag] = {'dataset': dataset, 'dataloader': loader}
        logger.info('> Ready to use training dataset: %s (%d clips)',
                    tag, len(dataset))
    # eve_tpu draws the subsets from numpy's global stream just after
    # seeding it with 0.
    subsets = np.random.RandomState(0)
    test_data = {}
    for tag, dataset_class, path, stimuli, cameras in test_specs:
        dataset = dataset_class(path, config=config, cameras_to_use=cameras,
                                types_of_stimuli=stimuli,
                                live_validation=True)
        indices = None
        if len(dataset) > config.test_num_samples:
            indices = sorted(subsets.permutation(
                len(dataset))[:config.test_num_samples].tolist())
        loader = SubsetLoader(dataset, indices,
                              batch_size=config.test_batch_size,
                              num_workers=config.test_data_workers)
        test_data[tag] = {
            'dataset': dataset, 'dataset_class': dataset_class,
            'dataset_path': path, 'stimuli': stimuli, 'cameras': cameras,
            'dataloader': loader,
        }
        logger.info('> Ready to use evaluation dataset: %s (%d clips, '
                    'eval on %d)', tag, len(dataset), loader.num_entries)
    return train_data, test_data


def SubsetLoader(dataset, indices, batch_size, num_workers=0):
    """A loader over ``dataset`` (or its ``indices``) in order, the last
    batch ragged: live validation and the final full test."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=False,
                      drop_last=False, num_workers=num_workers,
                      indices=indices)


def config_identity_hash(config):
    """md5[:6] of the config's values, ``NON_IDENTITY_KEYS`` left out."""
    values = config.get_all_key_values()
    for key in NON_IDENTITY_KEYS:
        values.pop(key, None)
    return hashlib.md5(json.dumps(values, sort_keys=True).encode()
                       ).hexdigest()[:6]


def _latest_resumable_run(family_dir, cfg_hash):
    """The newest run directory ``<ts>.<cfg_hash>`` holding a checkpoint.

    Timestamps are ``%y%m%d_%H%M%S``, so the names sort by time. A
    directory without a checkpoint is skipped: resuming it would restart
    from step 0 on top of its logs.
    """
    candidates = sorted(
        d for d in glob.glob(os.path.join(family_dir, '*.' + cfg_hash))
        if os.path.isdir(d) and
        glob.glob(os.path.join(d, 'checkpoints', '*.ckpt')))
    return candidates[-1] if candidates else None


def bootstrap_pretrained(config, model, pretrained_dir=None):
    """Load the pretrained submodules the config asks for; returns their
    names.

    Searched in ``pretrained_dir`` and ``$EVE_PRETRAINED_DIR``
    (``utils.load_model``): eve_tpu's native ``.npz`` first, then the
    released reference ``.pt`` (never under the opt-in topology). With
    none present this raises, so a run never trains against a random
    EyeNet that its config says is pretrained.
    """
    wanted = (['eye_net'] if config.eye_net_load_pretrained else []) + (
        ['refine_net'] if config.refine_net_enabled and
        config.refine_net_load_pretrained else [])
    for which in wanted:
        if load_model.load_pretrained_into(model, config, which,
                                           pretrained_dir):
            continue
        search = load_model.search_dirs(pretrained_dir) or ['<unset>']
        if config.tpu_native_arch:
            fname = load_model.pretrained_filename(config, which, '.npz')
            raise FileNotFoundError(
                'config.%s_load_pretrained is set with tpu_native_arch but '
                '%s was not found (searched: %s). The TPU-native topology '
                'is NOT weight-compatible with the reference release .pt '
                'checkpoints: export a native stage instead (copy '
                '<run>/checkpoints/<N>.ckpt/%s.npz to '
                '$EVE_PRETRAINED_DIR/%s); refusing to train against a '
                'randomly initialised %s.'
                % (which, fname, search, which, fname, which))
        raise FileNotFoundError(
            'config.%s_load_pretrained is set but neither %s nor %s was '
            'found (searched: %s); refusing to train against a randomly '
            'initialised %s' % (
                which, *load_model.eligible_filenames(config, which),
                search, which))
    return wanted


class Experiment:
    """One training run: its directory, logs, model state and checkpoints."""

    def __init__(self, config, output_dir_base='./outputs', device='cuda'):
        self.config = config
        self.spec = eve_lib.EveSpec.from_config(config)
        self.device = torch.device(device)
        if config.tpu_num_devices > 1:
            raise NotImplementedError(
                'tpu_num_devices=%d: the port trains on one device; '
                'multi-GPU training is a later slice (ROADMAP.md)'
                % config.tpu_num_devices)
        if config.tpu_num_devices == 0 and torch.cuda.device_count() > 1:
            logger.warning('tpu_num_devices=0 (all devices): %d GPUs are '
                           'visible, and the port trains on one (%s)',
                           torch.cuda.device_count(), self.device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('device %s: no CUDA card is visible (pass '
                               '--device cpu to train on the CPU)' % device)
        # float32 parity: cuDNN would run float32 convolutions in TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg_hash = config_identity_hash(config)
        family = 'EVE' + config.identifier_suffix
        if config.auto_resume and not config.resume_from:
            # A restart with the same argv hashes the same and continues
            # the run it replaces.
            found = _latest_resumable_run(
                os.path.join(output_dir_base, family), cfg_hash)
            if found:
                logger.info('auto_resume: continuing %s', found)
                config.override('resume_from', found)
            else:
                logger.info('auto_resume: no earlier run with config hash '
                            '%s; starting fresh', cfg_hash)
        if config.resume_from:
            output_dir = config.resume_from
            self.identifier = '/'.join(output_dir.rstrip('/').split('/')[-2:])
        else:
            self.identifier = (family + '/' + time.strftime('%y%m%d_%H%M%S')
                               + '.' + cfg_hash)
            output_dir = os.path.join(output_dir_base, self.identifier)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        if not config.resume_from:
            config.write_file_contents(output_dir)
        self.tensorboard = Tensorboard(output_dir)
        self._log_handler = logging.FileHandler(
            os.path.join(output_dir, 'messages.log'))
        self._log_handler.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(message)s', '%d/%m %H:%M:%S'))
        logging.getLogger().addHandler(self._log_handler)
        self.gsheet_logger = GoogleSheetLogger(
            config, self.identifier, resuming=bool(config.resume_from))
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
        if cfg.profile_dir:
            self.tensorboard.add_graph(model)
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


# Preemption: SIGTERM sets this flag, and the loop checks it after every
# step and every eval batch: it saves a checkpoint of the completed steps
# and exits 143, so a restart resumes exactly where the signal landed.
_PREEMPTION = threading.Event()


def request_preemption_checkpoint(signum=None, frame=None):
    """Ask the loop to checkpoint and exit 143 (a signal handler)."""
    _PREEMPTION.set()


def _install_preemption_handler():
    """Make SIGTERM request a preemption checkpoint, where that is safe.

    Only on the main thread (``signal.signal`` raises elsewhere). A default
    (SIG_DFL) or ignored (SIG_IGN, usually inherited from a launcher)
    disposition is replaced; an application's own handler is kept (it can
    call ``request_preemption_checkpoint``). The flag is not cleared, so a
    request made before this runs survives it.
    """
    if threading.current_thread() is not threading.main_thread():
        logger.info('not on the main thread; preemption checkpointing on '
                    'SIGTERM is not armed')
        return
    current = signal.getsignal(signal.SIGTERM)
    if current in (signal.SIG_DFL, signal.SIG_IGN):
        signal.signal(signal.SIGTERM, request_preemption_checkpoint)
        if current == signal.SIG_IGN:
            logger.warning('SIGTERM was inherited as SIG_IGN; replaced '
                           'with the preemption-checkpoint handler')
    elif current is not request_preemption_checkpoint:
        logger.info('SIGTERM already has a custom handler; preemption '
                    'checkpointing is not armed (the handler may call '
                    'request_preemption_checkpoint itself)')


def _exit_for_preemption(exp):
    """Checkpoint the completed steps and exit 143.

    ``exp.state.step`` counts completed loop steps: ``exp.last_step + 1``
    inside the loop, and right also before the first step of a resumed
    run. The save is synchronous and ``exp.close`` joins the background
    writer, so the checkpoint is whole when the process ends.
    """
    if exp.state is not None:
        exp.checkpoint_manager.save_at_step(exp.state.step, exp.state)
        logger.warning(
            'Preemption signal received: checkpoint saved at step %d; '
            'resume with --resume-from %s (or the same command with '
            '--auto-resume yes)', exp.state.step, exp.output_dir)
    else:
        logger.warning('Preemption signal received: exiting (no training '
                       'state built yet, nothing to save)')
    cleanup_and_quit(exp, exit_code=PREEMPTED_EXIT_CODE)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir, first, last):
    """Stop the trace of loop steps ``first``..``last`` and write it as a
    Chrome trace into ``profile_dir``."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'steps_%07d-%07d.pt.trace.json'
                        % (first + 1, last + 1))
    profiler.export_chrome_trace(path)
    logger.info('> Wrote a profile of steps %d-%d to %s', first + 1,
                last + 1, path)


def main_loop_iterator(exp, train_data, test_data):
    """Generator over training steps; yields ``(step, metrics, images)``.

    ``metrics`` holds the step's 0-dim outputs and ``nan_flag`` as device
    tensors; the loop reads them on the host only at its log, checkpoint
    and test intervals. ``images`` is ``{tag: HWC image}`` at the image
    interval (with screen content), else empty.
    """
    config = exp.config
    if config.skip_training:
        # Evaluate only: the model (and its checkpoint) for the final test.
        exp.build_training(1)
        return
    tags = list(train_data)
    tag0 = tags[0]
    multi_source = len(tags) > 1
    local_batch = train_data[tag0]['dataloader'].batch_size  # micro-batch
    echo = max(int(config.train_batch_echoing), 1)
    accum = max(int(config.gradient_accumulation_steps), 1)
    max_dataset_len = max(len(d['dataset']) for d in train_data.values())
    steps_per_epoch = int(max_dataset_len / local_batch)
    # Loop steps are micro-steps: ``echo`` of them a loaded batch, ``accum``
    # of them an optimizer update, the LR schedule's unit.
    num_training_steps = int(config.num_epochs * max(steps_per_epoch, 1)
                             * echo)
    exp.build_training(max(1, (max(steps_per_epoch, 1) * echo) // accum))
    seed = training_seed(config)
    if exp.last_step > 0:
        # Continue each data stream where the interrupted run stood: one
        # batch a group of ``echo`` steps (a partial group reloads its
        # batch).
        for data in train_data.values():
            data['dataloader'].fast_forward(exp.last_step // echo)
    iterators = {}

    def next_batch(tag):
        data = train_data[tag]
        for _ in range(2):
            if tag not in iterators:
                iterators[tag] = iter(DevicePrefetcher(data['dataloader'],
                                                       exp.device))
            try:
                return next(iterators[tag])[0]
            except StopIteration:
                del iterators[tag]
        raise RuntimeError('training loader %r yielded no batches (%d clips, '
                           'batch size %d, drop_last)'
                           % (tag, len(data['dataset']), local_batch))

    def abort_if_nan(metrics):
        # Before any save, so that NaN parameters are never written.
        if bool(metrics['nan_flag']):
            logger.error('NaN encountered during training; aborting.')
            cleanup_and_quit(exp, exit_code=1)

    _install_preemption_handler()
    # The profiler window is steps +5..+10 of this process's loop.
    profile_first = exp.last_step + 5
    profiler = None
    batches = None
    perf_t0 = time.perf_counter()
    perf_steps = 0
    perf_wait = 0.0
    try:
        for current_step in range(exp.last_step, num_training_steps):
            current_epoch = ((current_step // echo) * local_batch
                             / max_dataset_len)
            exp.tensorboard.update_current_step(current_step + 1)
            if config.profile_dir and current_step == profile_first:
                profiler = _start_profiler(exp.device)
            if batches is None or current_step % echo == 0:
                wait_start = time.perf_counter()
                batches = {tag: next_batch(tag) for tag in tags}
                perf_wait += time.perf_counter() - wait_start
            if multi_source:
                metrics = step_lib.multi_source_train_step(
                    exp.state, batches,
                    {tag: kappa_generator(seed, current_step, i)
                     for i, tag in enumerate(sorted(tags))})
            else:
                metrics = step_lib.train_step(
                    exp.state, batches[tag0],
                    kappa_generator(seed, current_step))
            # Recorded here: live validation later in this iteration may
            # exit for a preemption, and its checkpoint counts this step.
            exp.last_epoch = current_epoch
            exp.last_step = current_step
            if profiler is not None and current_step == profile_first + 5:
                _stop_profiler(profiler, config.profile_dir, profile_first,
                               current_step)
                profiler = None

            images = {}
            if config.load_screen_content and step_modulo(
                    current_step, config.tensorboard_images_every_n_steps):
                images = compose_training_images(
                    step_lib.eval_step(exp.state.model, batches[tag0],
                                       create_images=True),
                    screen_size=tuple(config.screen_size))
            yield current_step, metrics, images

            if _PREEMPTION.is_set():
                abort_if_nan(metrics)  # never persist NaN parameters
                _exit_for_preemption(exp)

            perf_steps += 1
            log_console = step_modulo(current_step, config.log_every_n_steps)
            log_scalars = step_modulo(
                current_step, config.tensorboard_scalars_every_n_steps)
            if log_console or log_scalars:
                abort_if_nan(metrics)
                keys = sorted(k for k in metrics if k != 'nan_flag')
                values = torch.stack([metrics[k].float()
                                      for k in keys]).tolist()
                host_metrics = dict(zip(keys, values))
                dt = time.perf_counter() - perf_t0
                steps_per_sec = perf_steps / max(dt, 1e-9)
                data_wait_pct = 100.0 * perf_wait / max(dt, 1e-9)
                perf_t0, perf_steps, perf_wait = time.perf_counter(), 0, 0.0
            if log_console:
                logger.info('Step %d, Epoch %.2f [%.2f steps/s, %.0f%% '
                            'data-wait]> %s', current_step + 1,
                            current_epoch, steps_per_sec, data_wait_pct,
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
                exp.tensorboard.add_scalar('perf/steps_per_sec',
                                           steps_per_sec)
                exp.tensorboard.add_scalar('perf/data_wait_pct',
                                           data_wait_pct)
            if step_modulo(current_step,
                           config.tensorboard_learning_rate_every_n_steps):
                # The schedule's domain is optimizer updates.
                exp.tensorboard.add_scalar(
                    'lr/optim_0', exp.state.schedule(current_step // accum))

            if step_modulo(current_step,
                           config.checkpoints_save_every_n_steps):
                abort_if_nan(metrics)
                exp.checkpoint_manager.save_at_step(
                    current_step + 1, exp.state,
                    wait=not config.tpu_async_checkpoint)
            if step_modulo(current_step, config.test_every_n_steps):
                abort_if_nan(metrics)
                _, for_gsheet = test_model_on_all(exp, test_data,
                                                  current_step + 1)
                if for_gsheet is not None:
                    for_gsheet['Step'] = current_step + 1
                    for_gsheet['Epoch'] = current_epoch
                    exp.gsheet_logger.update_or_append_row(for_gsheet)
    finally:
        # Every exit path: the end of the loop, a run shorter than the
        # profile window, the NaN or preemption exits, the consumer
        # closing the generator.
        if profiler is not None:
            _stop_profiler(profiler, config.profile_dir, profile_first,
                           exp.last_step)
        for it in iterators.values():
            it.close()  # releases the prefetcher's thread

    # The completed-step numbering of the periodic saves.
    exp.checkpoint_manager.save_at_step(exp.state.step, exp.state)


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
    output over its clips (batch means weighted by batch size). Returns
    ``(results, row for the Google Sheet or None)``. A preemption request
    is honoured between batches."""
    final_out = {}
    for tag, data_dict in test_data.items():
        loader = data_dict['dataloader']
        totals = {}
        for batch in loader:
            if _PREEMPTION.is_set():
                _exit_for_preemption(exp)
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
        logger.info('%10s %s: %s', '[%s]' % tag, log_key_prefix,
                    ', '.join('%s: %.4g' % (k, totals[k])
                              for k in sorted(totals)))
        exp.tensorboard.update_current_step(current_step)
        for k, v in totals.items():
            exp.tensorboard.add_scalar('%s_%s/%s' % (log_key_prefix, tag, k),
                                       v)
    for_gsheet = None
    if exp.gsheet_logger.ready:
        for_gsheet = {'%s/%s/%s' % (log_key_prefix, tag, k): v
                      for tag, out in final_out.items()
                      for k, v in out.items()}
    return final_out, for_gsheet


def do_final_full_test(exp, test_data):
    """Rebuild each validation set whole (``is_final_test=True``) and
    evaluate it at ``full_test_batch_size``; returns the results.

    Logged at step ``exp.last_step + 1``, as eve_tpu logs it: after a
    training loop that is the count of its steps; without one
    (``skip_training``, or the resume of a finished run) it is one past
    the loaded checkpoint's step.
    """
    config = exp.config
    for tag, v in test_data.items():
        dataset = v['dataset_class'](
            v['dataset_path'], config=config, cameras_to_use=v['cameras'],
            types_of_stimuli=v['stimuli'], is_final_test=True)
        v['dataset'] = dataset
        v['dataloader'] = SubsetLoader(
            dataset, None, batch_size=config.full_test_batch_size,
            num_workers=config.full_test_data_workers)
        logger.info('> Full test on dataset %s: %d sequences', tag,
                    len(dataset))
    final_out, for_gsheet = test_model_on_all(
        exp, test_data, exp.last_step + 1, log_key_prefix='full_test')
    if for_gsheet is not None:
        exp.gsheet_logger.update_or_append_row(for_gsheet)
    return final_out


def cleanup_and_quit(exp, exit_code=0):
    """Close the run and exit with ``exit_code``. A preemption request
    that was not honoured is cleared, so it cannot exit a later run in the
    same process."""
    _PREEMPTION.clear()
    exp.close()
    sys.exit(exit_code)
