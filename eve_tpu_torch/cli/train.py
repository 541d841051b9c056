#!/usr/bin/env python3
"""Train the EVE gaze-estimation model.

Usage:
    python -m eve_tpu_torch.cli.train [config.json ...] [--flag value ...] \
        [--device cuda|cpu]

e.g. ``python -m eve_tpu_torch.cli.train configs/refine_net.json
--datasrc-eve /data/eve``, as ``python train.py`` trains eve_tpu. Every
config key is a ``--flag``. The run goes to ``./outputs/EVE<suffix>/
<timestamp>.<config hash>``; SIGTERM saves a checkpoint of the completed
steps and exits 143, and the same command with ``--auto-resume yes``
continues that run. After training, the validation split is tested whole
(the final full test). Reading the dataset needs ``h5py`` and ``ffmpeg``
or ``cv2``.

Several GPUs (one worker process a GPU, on eve_tpu's grid: the data axis,
and the model and seq axes of ``--tpu-model-parallelism`` and
``--tpu-sequence-shards``):

- ``--tpu-num-devices N`` (0, the default, is every visible card of every
  host) takes eve_tpu's rule: the model and seq axes claim their cards
  first, the data axis is the largest count of the rest that divides the
  per-step batch; it starts that many workers with
  ``torch.multiprocessing``, worker r on ``cuda:r``, meeting on localhost;
  the command's exit code is the workers' (143 when they were preempted,
  another non-zero code when one failed, after the others are stopped);
- under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT`` set) nothing is started: the process is the rank the
  environment names, on ``cuda:<LOCAL_RANK>``;
- several hosts: ``--tpu-multihost yes --tpu-coordinator-address
  <host 0>:<port> --tpu-num-processes <hosts> --tpu-process-id <this
  host>``, the same command on every host; eve_tpu's grid spans every
  host's cards, and each host starts its share of the ranks (a grid that
  does not split evenly over the hosts raises).

``main`` parses the command line and builds eve_tpu's dataset specs;
``run`` takes a config, a device and the specs, and does the rest, so any
dataset class with the reader's constructor can be trained on.
"""

import logging
import os
import signal
import socket
import sys
import threading
import time

import numpy as np
import torch

from eve_tpu_torch.data.dataset import EVESequences_train, EVESequences_val
from eve_tpu_torch.parallel import mesh as mesh_lib
from eve_tpu_torch.train import harness

logger = logging.getLogger(__name__)

# Seconds the launcher lets the other workers finish after one failed.
FAILED_WORKER_GRACE_S = 10.0


def worker_count(config, device, env=None):
    """How many workers to start on this host, or None to train in this
    process (one device, or a process that is already a rank).

    The grid is eve_tpu's (``harness.training_grid``) over every host's
    devices and the global per-step batch: ``tpu_num_devices`` when set,
    else the hosts times this host's cards. Each host starts its share of
    the grid's ranks. A grid that cannot form raises eve_tpu's
    ``ValueError``s; one that does not split evenly over the hosts raises
    too, naming the grid and the hosts."""
    env = os.environ if env is None else env
    if mesh_lib.launched_by_torchrun(env) or 'LOCAL_RANK' in env:
        return None
    device = torch.device(device)
    visible = torch.cuda.device_count() if device.type == 'cuda' else 1
    hosts = max(int(config.tpu_num_processes), 1) if config.tpu_multihost \
        else 1
    available = config.tpu_num_devices or hosts * visible
    axes = harness.training_grid(config, available)
    total = int(np.prod(list(axes.values())))
    if total % hosts:
        raise ValueError(
            "eve_tpu's grid %s of %d ranks does not split over the %d hosts"
            % (axes, total, hosts))
    count = total // hosts
    if count == 1:
        return None
    if device.type == 'cuda':
        if device.index is not None:
            raise ValueError('--device %s names one card; pass --device '
                             'cuda to train on %d' % (device, count))
        if count > visible:
            raise ValueError('need %d CUDA devices, have %d'
                             % (count, visible))
    return count


def rank_device(device, local_rank):
    """A worker's device: ``cuda:<local rank>`` for 'cuda', else the
    device as given (the CPU, or a card named explicitly)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', local_rank)
    return device


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _worker(local_rank, count, env, threads, args):
    """One worker process: its rank's environment, then the training."""
    os.environ.update(env, LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(count))
    if 'WORLD_SIZE' in env:
        os.environ['RANK'] = str(local_rank)
    logging.basicConfig(
        level=logging.INFO,
        format='%%(asctime)s %%(levelname)s [worker %d] %%(message)s'
        % local_rank, datefmt='%d/%m %H:%M:%S')
    if threads:
        torch.set_num_threads(threads)
    config, device, train_specs, validation_specs, output_dir_base = args
    run_rank(config, rank_device(device, local_rank), train_specs,
             validation_specs, output_dir_base)


def launch(count, config, device, train_specs, validation_specs,
           output_dir_base='./outputs'):
    """Start ``count`` workers on this host and wait for them; returns the
    exit code (the first failure's, else 143 if they were preempted, else
    0). SIGTERM to the launcher goes on to every worker."""
    if config.tpu_multihost:
        env = {}  # the coordinator keys name the rendezvous
    else:
        env = {'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(_free_port()),
               'WORLD_SIZE': str(count)}
    threads = (max(1, torch.get_num_threads() // count)
               if torch.device(device).type == 'cpu' else 0)
    context = torch.multiprocessing.get_context('spawn')
    args = (config, device, train_specs, validation_specs, output_dir_base)
    workers = [context.Process(target=_worker, name='eve-worker-%d' % r,
                               args=(r, count, env, threads, args))
               for r in range(count)]
    logger.info('> Starting %d workers (one a device) on %s', count, device)
    for w in workers:
        w.start()

    def forward(signum, frame):
        for w in workers:
            if w.exitcode is None:
                os.kill(w.pid, signum)

    # signal.signal works on the main thread only; elsewhere a SIGTERM to
    # the launcher does not reach the workers.
    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, forward) if main_thread else None
    failed_at = None
    try:
        while any(w.exitcode is None for w in workers):
            time.sleep(0.2)
            failed = [w for w in workers
                      if w.exitcode not in (None, 0, 143)]
            if failed and failed_at is None:
                failed_at = time.time()
                logger.error('%s exited %d; stopping the other workers',
                             failed[0].name, failed[0].exitcode)
            if failed_at and time.time() - failed_at > FAILED_WORKER_GRACE_S:
                for w in workers:
                    if w.exitcode is None:
                        w.kill()
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
        for w in workers:
            w.join()
    codes = [w.exitcode for w in workers]
    logger.info('> Workers exited %s', codes)
    failures = [c for c in codes if c not in (0, 143)]
    if failures:
        return failures[0] if failures[0] > 0 else 1
    return 143 if 143 in codes else 0


def run(config, device, train_specs, validation_specs,
        output_dir_base='./outputs', backend=None):
    """Train, run the final full test and exit 0 (``SystemExit``), as
    eve_tpu's ``main`` does after its specs; see ``harness.init_datasets``
    for the spec tuples. On several devices this starts the workers and
    exits with their code; ``backend`` overrides the device group's
    (NCCL on a card, gloo on the CPU) of a process that is a rank."""
    count = worker_count(config, device)
    if count is not None:
        sys.exit(launch(count, config, device, train_specs,
                        validation_specs, output_dir_base))
    run_rank(config, device, train_specs, validation_specs, output_dir_base,
             backend)


def run_rank(config, device, train_specs, validation_specs,
             output_dir_base='./outputs', backend=None):
    """``run`` in one process: alone, or as the rank of a process group
    that ``harness.init_process_group`` joins."""
    harness.init_process_group(config, device, backend)
    if mesh_lib.launched_by_torchrun():
        device = rank_device(device, mesh_lib.local_rank())
    train_data, test_data = harness.init_datasets(config, train_specs,
                                                  validation_specs)
    exp = harness.Experiment(config, output_dir_base=output_dir_base,
                             device=device)
    for _, _, images in harness.main_loop_iterator(exp, train_data,
                                                   test_data):
        # Composite images arrive every tensorboard_images_every_n_steps.
        for tag, img in images.items():
            exp.tensorboard.add_image(tag, img)
    harness.do_final_full_test(exp, test_data)
    harness.cleanup_and_quit(exp)


def main(argv=None):
    config, args = harness.script_init_common(argv)
    train_specs = [('eve_train', EVESequences_train, config.datasrc_eve,
                    config.train_stimuli, config.train_cameras)]
    validation_specs = [('eve_val', EVESequences_val, config.datasrc_eve,
                         config.test_stimuli, config.test_cameras)]
    run(config, args.device, train_specs, validation_specs)


if __name__ == '__main__':
    main()
