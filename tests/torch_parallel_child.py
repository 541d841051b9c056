"""Child processes of ``tests/test_torch_parallel_train.py`` (CPU, gloo).

    python -m tests.torch_parallel_child <mode> <json arguments>

Every mode writes what it saw to files in its working directory, not to
stdout: gloo writes its own lines into stdout.

- ``steps``: one rank of a two-process group started from the
  coordinator keys (``initialize_multihost``, one worker a host); runs
  the port's ``train_step`` (2 steps), ``multi_source_train_step`` and an
  accumulated update on its rows of the parent's batches;
- ``train``: one rank of a torchrun-style group (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) training through
  ``cli.train.run`` on in-memory clips; records each step's ``full_loss``,
  the final test and the loader's rows; ``sigterm_after`` makes rank 1
  send itself SIGTERM after it has read that many clips;
- ``launch``: ``cli.train.run`` with ``tpu_num_devices`` 2 on the CPU,
  which starts the two workers itself; ``fail_rank`` makes that worker's
  dataset raise;
- ``multihost``: ``harness.init_process_group`` from the ``tpu_multihost``
  keys, then the group's collectives.
"""

import json
import os
import signal
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'refine_net.json')


def _config(overrides):
    from eve_tpu_torch import config as tconfig
    cfg = tconfig.Config()
    cfg.import_json(CONFIG)
    cfg.import_dict(overrides)
    return cfg


class Clips:
    """In-memory synthetic clips with the reader's constructor (path =
    ``(seed, n, sigterm_after, fail_rank)``): rank 1 sends itself SIGTERM
    after reading ``sigterm_after`` clips, and rank ``fail_rank`` (None:
    none) raises at its first clip."""

    def __init__(self, path, config, cameras_to_use=None,
                 types_of_stimuli=None, live_validation=False,
                 is_final_test=False):
        from tests.torch_clips import SyntheticSequences
        seed, n, self.sigterm_after, self.fail_rank = path
        self.inner = SyntheticSequences((seed, n), config)
        self.reads = 0

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        rank = int(os.environ.get('RANK', -1))
        if rank == self.fail_rank:
            raise RuntimeError('rank %d fails on purpose' % rank)
        self.reads += 1
        if rank == 1 and self.reads == self.sigterm_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner[i]


def specs(tag, seed, n, sigterm_after=0, fail_rank=None):
    return (tag, Clips, (seed, n, sigterm_after, fail_rank), ['image'],
            ['webcam_c'])


def _rows(batch, rank, world):
    b = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def steps(args):
    """Two train steps, a two-source step and an accumulated update."""
    from eve_tpu_torch.models import eve as teve
    from eve_tpu_torch.parallel import mesh as mesh_lib
    from eve_tpu_torch.train import step as tstep
    torch.set_num_threads(1)
    rank = args['rank']
    mesh_lib.initialize_multihost(args['address'], 2, rank,
                                  backend='gloo')
    inputs = torch.load(os.path.join(args['dir'], 'inputs.pt'),
                        weights_only=False)
    out = {}

    def state(overrides):
        tc = _config(overrides)
        model = teve.build_model(teve.EveSpec.from_config(tc),
                                 inputs['state_dict'], 'cpu')
        st = tstep.create_train_state(tc, model, inputs['updates_per_epoch'])
        assert st.data_parallel
        return st

    def batch(name):
        return teve.batch_to_tensors(_rows(inputs[name], rank, 2), 'cpu')

    st = state(inputs['overrides'])
    for i in range(2):
        metrics = tstep.train_step(st, batch('batch'))
        out['step%d' % i] = {k: float(v) for k, v in metrics.items()}
        out['params%d' % i] = {k: v.clone()
                               for k, v in st.model.state_dict().items()}
    st = state(inputs['overrides'])
    metrics = tstep.multi_source_train_step(
        st, {'a': batch('batch_a'), 'b': batch('batch_b')})
    out['multi'] = {k: float(v) for k, v in metrics.items()}
    out['multi_params'] = dict(st.model.state_dict())
    st = state(inputs['accum_overrides'])
    for name in ('micro0', 'micro1'):
        tstep.train_step(st, batch(name))
    out['accum_params'] = dict(st.model.state_dict())
    torch.save(out, os.path.join(args['dir'], 'rank%d.pt' % rank))
    mesh_lib.shutdown()


def train(args):
    """One torchrun-style rank through ``cli.train.run``."""
    import logging
    from eve_tpu_torch.cli import train as train_cli
    from eve_tpu_torch.train import harness
    logging.basicConfig(level=logging.INFO)
    torch.set_num_threads(1)
    rank = int(os.environ.get('RANK', 0))
    record = {'losses': {}, 'rows': {}, 'tests': [], 'final_test': None}
    loop, final_test = harness.main_loop_iterator, harness.do_final_full_test
    test_all = harness.test_model_on_all
    load = harness.DataLoader.index_batches

    def index_batches(loader):
        batches = load(loader)
        if loader.shuffle:
            record['rows'].setdefault(str(loader.epoch), [
                [int(i) for i in b] for b in batches])
        return batches

    def observed_loop(exp, train_data, test_data):
        for step, metrics, images in loop(exp, train_data, test_data):
            record['losses'][str(step)] = float(metrics['full_loss'])
            yield step, metrics, images

    def observed_test_all(*a, **kw):
        results = test_all(*a, **kw)
        record['tests'].append(results[0])
        return results

    def observed_final_test(exp, test_data):
        record['final_test'] = final_test(exp, test_data)
        return record['final_test']

    harness.main_loop_iterator = observed_loop
    harness.do_final_full_test = observed_final_test
    harness.test_model_on_all = observed_test_all
    harness.DataLoader.index_batches = index_batches
    config = _config(args['overrides'])
    try:
        train_cli.run(config, 'cpu', [specs('train', 0, args['clips'],
                                            args.get('sigterm_after', 0))],
                      [specs('val', 1, args['val_clips'])],
                      output_dir_base=args['out'])
    finally:
        with open(os.path.join(args['dir'], 'record%d.json' % rank),
                  'w') as f:
            json.dump(record, f)


def launch(args):
    """``cli.train.run`` starting two CPU workers itself."""
    import logging
    from eve_tpu_torch.cli import train as train_cli
    logging.basicConfig(level=logging.INFO)
    train_cli.FAILED_WORKER_GRACE_S = 2.0
    config = _config(dict(args['overrides'], tpu_num_devices=2))
    train_cli.run(config, 'cpu', [specs('train', 0, args['clips'],
                                        fail_rank=args.get('fail_rank'))],
                  [specs('val', 1, args['val_clips'])],
                  output_dir_base=args['out'])


def multihost(args):
    """A rank of a group started from eve_tpu's multi-host keys."""
    from eve_tpu_torch.parallel import mesh as mesh_lib
    from eve_tpu_torch.train import harness
    config = _config({'tpu_multihost': True,
                      'tpu_coordinator_address': args['address'],
                      'tpu_num_processes': 2,
                      'tpu_process_id': args['host']})
    harness.init_process_group(config, 'cpu')
    harness.init_process_group(config, 'cpu')  # idempotent
    grads = [torch.full((3,), float(args['host'] + 1)), torch.ones(2)]
    mesh_lib.all_reduce_mean_(grads)
    params = [torch.full((2,), float(args['host']))]
    mesh_lib.broadcast_tensors_(params)
    out = {
        'rank': mesh_lib.process_index(), 'world': mesh_lib.process_count(),
        'host': mesh_lib.host_index(), 'hosts': mesh_lib.host_count(),
        'backend': torch.distributed.get_backend(),
        'slice': mesh_lib.local_data_slice(10),
        'name': mesh_lib.broadcast_string('run-of-host-%d' % args['host']),
        'flags': mesh_lib.all_gather_flags(args['host'] == 1),
        'mean': grads[0].tolist(), 'ones': grads[1].tolist(),
        'broadcast': params[0].tolist(),
        'primary': mesh_lib.is_primary_process(),
    }
    with open(os.path.join(args['dir'], 'host%d.json' % args['host']),
              'w') as f:
        json.dump(out, f)
    mesh_lib.shutdown()


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    {'steps': steps, 'train': train, 'launch': launch,
     'multihost': multihost}[sys.argv[1]](json.loads(sys.argv[2]))
