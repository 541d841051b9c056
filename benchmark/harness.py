"""What every run shares: the cell's files, the host's set-up, the card's
readings and the guard against the JAX package.

A cell is found by its name in ``BENCHMARK.json``: its configuration file
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names the driver ``traffic/<kind>.py``) and its own file
(``workloads/<cell>.json``: the parameters that belong to this pairing,
such as a session count, and the limits of ``correct``). Its metrics are
the ``BENCHMARK.json`` entries that name it, or that name none and move
an end-to-end metric it reports; each is read by
``metrics/<metric>.py`` or, where there is no such file, by the reader of
the name with its last dotted part dropped (``device.idle_pct.train`` by
``metrics/device.idle_pct.py``), so one reader serves a quantity in every
cell.

The sizes a cell runs at are its configuration's own (``shapes``): the
traffic mix holds only what is traffic.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names a run may never load: the JAX package and JAX.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'eve_tpu')
HOST_CORES = 4


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    params: dict        # the traffic mix with the cell's own parameters
    limits: dict        # number compared -> limit
    end_to_end: list    # BENCHMARK.json metric entries
    per_layer: list


class Run:
    """What a traffic driver hands back: ``record`` (what the metric
    readers read), ``attempted`` and ``failed``, ``release()`` (frees the
    program's state) and ``check()`` (``(checks, info)``: each number
    compared with its limit, and what is printed beside them)."""

    def __init__(self, record, attempted, failed, release, check):
        self.record, self.attempted, self.failed = record, attempted, failed
        self.release, self.check = release, check


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _applies(metric, cell_name, reported):
    """A metric with ``workloads`` applies to the cells it lists; one
    without, to every cell that reports what it ``moves``."""
    if 'workloads' in metric:
        return cell_name in metric['workloads']
    return metric.get('moves', metric['name']) in reported


def load_cell(name, root=ROOT):
    bench = _json(root, 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit('unknown workload %r (BENCHMARK.json has %s)'
                         % (name, ', '.join(sorted(cells))))
    entry = cells[name]
    config_file = {c['name']: c['file'] for c in bench['configs']}[
        entry['config']]
    traffic = _json(HERE, 'traffic', entry['traffic'] + '.json')
    own = _json(HERE, 'workloads', name + '.json')
    e2e = [m for m in bench['end_to_end']
           if 'workloads' not in m or name in m['workloads']]
    reported = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if _applies(m, name, reported)]
    return Cell(name=name, chips=entry['chips'],
                config=_json(root, config_file),
                params=dict(traffic, **own.get('params', {})),
                limits=own['limits'], end_to_end=e2e, per_layer=per_layer)


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_%s_%s' % (kind, name.replace('.', '_').replace('-', '_')),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric):
    """The ``read`` function of ``metric``'s reader (see above)."""
    name = metric
    while not os.path.exists(os.path.join(HERE, 'metrics', name + '.py')):
        if '.' not in name:
            raise FileNotFoundError('no reader for metric %r under %s'
                                    % (metric, os.path.join(HERE, 'metrics')))
        name = name.rsplit('.', 1)[0]
    return load_module('metrics', name).read


def shapes(cfg, batch_key='batch_size'):
    """``(batch, sequence_len, eye_px, frame_rate_hz)`` of configuration
    ``cfg``: its ``batch_key`` batch (``batch_size`` for training,
    ``test_batch_size`` for evaluation), ``max_sequence_len``, the side
    of its square ``eyes_size`` and ``assumed_frame_rate``."""
    h, w = cfg['eyes_size']
    if h != w:
        raise ValueError('eyes_size %r is not square' % (cfg['eyes_size'],))
    return (cfg[batch_key], cfg['max_sequence_len'], h,
            cfg['assumed_frame_rate'])


def note(*args):
    print(*args, file=sys.stderr, flush=True)


def require_devices(chips):
    """Exit without a result unless ``chips`` cards are visible."""
    import torch
    if not torch.cuda.is_available():
        note('no CUDA card is visible (torch.cuda.is_available() is False)')
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        note('the cell asks for %d cards, %d are visible'
             % (chips, torch.cuda.device_count()))
        sys.exit(2)


def pin_host():
    """Pin the process (and the threads it starts) to a fixed set of cores
    and give torch as many threads: the host's share of a run stays put."""
    import torch
    cores = sorted(os.sched_getaffinity(0))[:HOST_CORES]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))
    return cores


def host_probe():
    """Seconds of a fixed Python loop: the host's speed in this process."""
    t = time.perf_counter()
    sum(i * i for i in range(3_000_000))
    return time.perf_counter() - t


CARD_FIELDS = ('name', 'power.limit', 'clocks.sm', 'clocks.mem',
               'power.draw', 'temperature.gpu')


def card_reading():
    """``nvidia-smi``'s line for the card: name, power limit, clocks,
    draw and temperature."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=' + ','.join(CARD_FIELDS),
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return 'nvidia-smi failed: %s' % e
    return '; '.join(line.strip() for line in out.splitlines()
                     if line.strip())


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def port_config(values):
    """The program's ``Config`` holding ``values``."""
    from eve_tpu_torch.config import Config
    config = Config()
    config.import_dict(values)
    return config


class float32_mode:
    """TF32 off (or, with ``tf32=True``, on) for cuDNN and cuBLAS inside
    the block, restored after: full float32 while the reference runs, and
    the program's own TF32 path for the control of a float32
    configuration."""

    def __init__(self, tf32=False):
        self.tf32 = tf32

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def run_seconds(root=ROOT):
    """``BENCHMARK.json``'s ``run_seconds``."""
    return _json(root, 'BENCHMARK.json')['run_seconds']
