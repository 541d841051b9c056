"""The device mesh, the process group and eve_tpu's rank grid.

The counterpart of ``eve_tpu/parallel/mesh.py``. eve_tpu drives every
device from one process through a ``jax.sharding.Mesh``: GSPMD splits the
batch along ``P('data')``, shards the recurrences' T axis over ``seq``
(``eve_tpu/parallel/temporal.py``), places large parameters and their Adam
moments over ``model`` and all-reduces the gradients. The port maps that
onto PyTorch in two ways:

- Serving and evaluation stay in one process. A ``DataMesh`` is a tuple
  of ``torch.device``s on a 1-D ``data`` axis; ``replicate`` puts a module
  (or tensors) on each device, ``shard_batch`` splits a batch into equal
  contiguous row slices, so row i goes to device ``i // (B / n)`` as
  ``P('data')`` places it, and ``gather_rows`` joins the slices' outputs in
  row order. A device may appear more than once: its replicas share one
  module.
- Training runs a process per GPU in a ``torch.distributed`` process group
  (``initialize_multihost``). The device group carries device tensors
  (NCCL on the card, gloo on the CPU): the parameter broadcast and the
  gradient all-reduce. A second, gloo, group carries the host's small
  agreements (``broadcast_string``, ``all_gather_flags``,
  ``broadcast_object``), so they never touch the card. Multi-host uses the
  same group: eve_tpu's ``tpu_num_processes`` counts hosts and
  ``tpu_process_id`` is the host's index; the ranks of a host are its
  local workers, one per GPU.

The ranks form eve_tpu's grid (``make_mesh_nd``): axes ``{'data': d,
'model': m, 'seq': s}`` in the harness's order, rank ``r = (di*m + mi)*s +
si`` as ``devices[:total].reshape(sizes)`` places them. ``RankGrid`` gives
a rank its coordinates and one sub-group an axis, plus the data x seq group
that reduces the gradients; a ``seq`` rank holds frames ``[si*T/s,
(si+1)*T/s)`` of its data shard's clips (``parallel/temporal.py``), and a
``model`` rank owns one slice of each leaf that ``shard_model_tree``
places over the axis, with that slice's Adam moments (``ModelShards``).
Every handoff and gather uses ``broadcast`` and ``all_reduce`` only, the
two collectives that both NCCL and gloo carry on CUDA tensors; so the
same functions run two ranks that share one card over gloo.

Starting a grid: ``python -m eve_tpu_torch.cli.train configs/refine_net.json
--tpu-sequence-shards 2 --tpu-model-parallelism 2 --tpu-num-devices 4``
starts the 4 workers itself; under ``torchrun --nproc-per-node 4 -m
eve_tpu_torch.cli.train ...`` the same flags shape the world torchrun
made. ``python3 chip_smoke.py`` runs seq = 2, model = 2 and model 2 x
seq 2 as gloo ranks that share ``cuda:0``; the CPU tests are
``tests/test_torch_parallel_{seq,model}.py``.
"""

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# The process group's layout, set by ``initialize_multihost``: the host's
# index and count, the rank's index among the host's workers and their
# count, and the gloo group of the host-side agreements.
_STATE = {'host': 0, 'hosts': 1, 'local_rank': 0, 'local_world': 1,
          'host_group': None, 'grid': None, 'backend': None}
# Environment variables of a torchrun-style launch.
TORCHRUN_VARS = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


class DataMesh:
    """A 1-D mesh: a tuple of devices on one named axis."""

    def __init__(self, devices, axis_name='data'):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.axis_names = (axis_name,)

    @property
    def shape(self):
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self):
        return len(self.devices)


def make_mesh(num_devices=0, axis_name='data', devices=None):
    """1-D mesh over the first ``num_devices`` devices (0 = all).

    ``devices`` defaults to every visible CUDA card. Asking for more
    devices than exist raises, not a silent truncation: a run that expects
    8 data shards must not quietly use 4. An explicit ``devices`` list may
    repeat a device (replicas that share it).
    """
    if devices is None:
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices and num_devices > 0:
        if len(devices) < num_devices:
            raise ValueError('need %d devices, have %d'
                             % (num_devices, len(devices)))
        devices = devices[:num_devices]
    if not devices:
        raise ValueError('no CUDA device is visible for the mesh (pass '
                         'devices= to build one over the CPU)')
    return DataMesh(devices, axis_name)


def as_mesh(mesh, device='cuda'):
    """``mesh`` as a ``DataMesh``: None stays None, an int n is
    ``make_mesh(n)`` on the cards, or n replicas of ``device`` when that
    is not a CUDA device."""
    if mesh is None or isinstance(mesh, DataMesh):
        return mesh
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        device = torch.device(device)
        if device.type == 'cuda':
            return make_mesh(mesh)
        return make_mesh(devices=[device] * mesh)
    raise TypeError('mesh must be a DataMesh or a device count, got %r'
                    % (mesh,))


def data_axis_size(batch_size, available, what='batch'):
    """eve_tpu's device rule for the data axis: the largest count up to
    ``available`` that divides ``batch_size``, so every device takes an
    equal share, with a warning when that is fewer than ``available``."""
    n_use = max(d for d in range(1, max(available, 1) + 1)
                if batch_size % d == 0)
    if n_use < available:
        logger.warning('%s %d not divisible by %d devices; using %d', what,
                       batch_size, available, n_use)
    return n_use


def row_slices(batch_size, extent):
    """The ``(start, stop)`` rows of each of ``extent`` equal slices."""
    if batch_size % extent:
        raise ValueError('batch of %d rows does not divide by %d devices'
                         % (batch_size, extent))
    per = batch_size // extent
    return [(i * per, (i + 1) * per) for i in range(extent)]


def shard_batch(mesh, batch, axis_name='data'):
    """Split each (B, ...) tensor of ``batch`` into the mesh's equal row
    slices, each on its device; returns one dict per device. Values that
    are not tensors go whole to every slice."""
    extent = mesh.shape[axis_name]
    rows = next(v.shape[0] for v in batch.values()
                if isinstance(v, torch.Tensor))
    return [{k: (v[a:b].to(device, non_blocking=True)
                 if isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
            for device, (a, b) in zip(mesh.devices, row_slices(rows, extent))]


def replicate(mesh, tree):
    """A copy of ``tree`` on each of the mesh's devices (a list, in mesh
    order). ``tree`` is a module (moved copies; the copy on the module's
    own device is the module itself) or a dict of tensors. Replicas on one
    device are one object."""
    copies = {}
    out = []
    for device in mesh.devices:
        if device not in copies:
            copies[device] = _copy_to(tree, device)
        out.append(copies[device])
    return out


def _copy_to(tree, device):
    if isinstance(tree, torch.nn.Module):
        import copy
        here = next(iter(tree.parameters()), None)
        if here is not None and here.device == device:
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def gather_rows(parts, rows_per_part):
    """Join the per-slice output dicts in row order: tensors or arrays with
    a leading dim of ``rows_per_part`` concatenate, 0-dim values average
    (every slice's is a mean over equally many rows), anything else is the
    first slice's. One part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    out = {}
    for key, first in parts[0].items():
        values = [p[key] for p in parts]
        if isinstance(first, torch.Tensor):
            if first.ndim >= 1 and first.shape[0] == rows_per_part:
                out[key] = torch.cat([v.to(first.device) for v in values])
            elif first.ndim == 0:
                out[key] = torch.stack([v.to(first.device).float()
                                        for v in values]).mean()
            else:
                out[key] = first
        elif isinstance(first, np.ndarray):
            if first.ndim >= 1 and first.shape[0] == rows_per_part:
                out[key] = np.concatenate(values)
            elif first.ndim == 0:
                out[key] = np.mean(np.stack(values)).astype(first.dtype)
            else:
                out[key] = first
        else:
            out[key] = first
    return out


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------

def launched_by_torchrun(env=None):
    """Whether the environment holds a torchrun-style rendezvous."""
    env = os.environ if env is None else env
    return all(v in env for v in TORCHRUN_VARS)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, local_rank=None, local_world=None,
                         backend=None):
    """Join (or create) the process group; a second call does nothing.

    With ``coordinator_address`` (``host:port`` of host 0's rank 0) the
    rendezvous is ``tcp://``: ``num_processes`` hosts of ``local_world``
    workers each, this one host ``process_id``'s worker ``local_rank``
    (global rank ``process_id * local_world + local_rank``). Without it the
    environment of a torchrun-style launch is read (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``). ``backend`` is the device group's: 'nccl' by default
    when CUDA is available, else 'gloo'. A gloo group for the host-side
    agreements is created beside it. A failed rendezvous raises.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    env = os.environ
    if coordinator_address:
        hosts = int(num_processes or 1)
        host = int(process_id if process_id is not None and process_id >= 0
                   else 0)
        local_world = int(local_world or env.get('LOCAL_WORLD_SIZE', 1))
        local_rank = int(local_rank if local_rank is not None
                         else env.get('LOCAL_RANK', 0))
        if not 0 <= host < hosts:
            raise ValueError('tpu_process_id=%d outside %d hosts'
                             % (host, hosts))
        dist.init_process_group(
            backend, init_method='tcp://' + coordinator_address,
            world_size=hosts * local_world,
            rank=host * local_world + local_rank)
    elif launched_by_torchrun(env):
        world = int(env['WORLD_SIZE'])
        rank = int(env['RANK'])
        local_world = int(env.get('LOCAL_WORLD_SIZE', world))
        local_rank = int(env.get('LOCAL_RANK', rank % local_world))
        hosts, host = world // local_world, rank // local_world
        dist.init_process_group(backend, init_method='env://',
                                world_size=world, rank=rank)
    else:
        raise ValueError('initialize_multihost needs a coordinator address '
                         'or a torchrun-style environment (%s)'
                         % ', '.join(TORCHRUN_VARS))
    _STATE.update(host=host, hosts=hosts, local_rank=local_rank,
                  local_world=local_world)
    _STATE['host_group'] = (dist.group.WORLD if backend == 'gloo'
                            else dist.new_group(backend='gloo'))
    _STATE['backend'] = backend
    logger.info('> Process group: rank %d of %d (host %d of %d, worker %d '
                'of %d), %s device group, gloo host group',
                dist.get_rank(), dist.get_world_size(), host, hosts,
                local_rank, local_world, backend)


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(host=0, hosts=1, local_rank=0, local_world=1,
                  host_group=None, grid=None, backend=None)


def in_process_group():
    """Whether this process is a rank of a process group (of any size)."""
    return dist.is_initialized()


def process_index():
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The world size (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_process():
    return process_index() == 0


def host_index():
    return _STATE['host']


def host_count():
    return _STATE['hosts']


def local_rank():
    """This rank's index among its host's workers."""
    return _STATE['local_rank']


def local_world_size():
    """The number of workers (ranks) on this host."""
    return _STATE['local_world']


def local_data_slice(num_items, process_index=None, process_count=None):
    """Deterministic per-host indices of a clip list (multi-host input).

    Every host receives the same number of items (ceil(n / hosts)), the
    tail hosts wrapping around to the start of the list: unequal per-host
    lengths would give the hosts different step counts and deadlock the
    collective step when the short host stops first. The defaults are this
    process's host and the number of hosts.
    """
    if process_index is None:
        process_index = host_index()
    if process_count is None:
        process_count = host_count()
    per_host = -(-num_items // process_count)
    start = process_index * per_host
    return [(start + i) % num_items for i in range(per_host)]


def broadcast_object(obj, src=0):
    """Rank ``src``'s picklable ``obj`` on every rank (COLLECTIVE: all
    must call), over the host group; returns it unchanged without a
    group."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_STATE['host_group'])
    return box[0]


def broadcast_string(s, max_bytes=4096):
    """Process 0's string on every process (COLLECTIVE: all must call).

    For the run's identity (its directory and identifier) and the
    auto-resume decision: ranks that derived these themselves could
    diverge on per-host clocks or host-local filesystems.
    """
    data = s.encode('utf-8')
    if len(data) > max_bytes:
        raise ValueError('string exceeds %d utf-8 bytes' % max_bytes)
    if process_count() == 1:
        return s
    buf = torch.zeros(max_bytes, dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=_STATE['host_group'])
    return bytes(buf.numpy()).rstrip(b'\x00').decode('utf-8')


def all_gather_flags(flag):
    """Every rank's boolean ``flag`` (COLLECTIVE), over the host group."""
    if process_count() == 1:
        return [bool(flag)]
    local = torch.tensor([1 if flag else 0], dtype=torch.int32)
    out = [torch.zeros(1, dtype=torch.int32) for _ in range(process_count())]
    dist.all_gather(out, local, group=_STATE['host_group'])
    return [bool(t.item()) for t in out]


def gather_to_host(tree, skip_local=False, sharded=None, shards=None):
    """A host copy of a dict (or list) of tensors.

    Replicated leaves are a local copy, no collective. ``sharded`` maps
    keys of a dict ``tree`` whose values are this rank's slice over the
    model axis of ``shards`` (a ``ModelShards``) to the torch dim they are
    cut on: those are gathered to their full value first, a COLLECTIVE
    that every rank of the axis must call, as eve_tpu's
    ``process_allgather``. ``skip_local`` returns the tree's other leaves
    unchanged and the gathered ones on the device (a rank that writes
    nothing joins the collective and skips the copies).
    """
    if sharded:
        keys = sorted(k for k in tree if k in sharded)
        full = shards.gather([tree[k] for k in keys],
                             [sharded[k] for k in keys])
        tree = dict(tree, **dict(zip(keys, full)))
    if skip_local:
        return tree
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return tree


def _coalesced(tensors, op):
    """Run the collective ``op`` on one flat buffer of ``tensors`` and
    copy the result back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_(tensors, group=None, divide_by=1):
    """Sum ``tensors`` (same shapes and dtype on every rank) over ``group``
    (default: the device group), in place, in one coalesced all-reduce,
    then divide by ``divide_by``; a group of one rank runs it too. Without
    a process group, or with ``group`` None inside a grid axis of one rank
    (see ``RankGrid.group``), they are returned as they are."""
    if not dist.is_initialized() or not tensors or group is _NO_GROUP:
        return tensors

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        if divide_by != 1:
            flat.div_(divide_by)

    _coalesced(tensors, reduce)
    return tensors


def all_reduce_mean_(tensors, group=None):
    """Average ``tensors`` over ``group`` (default: every rank) in one
    coalesced all-reduce, in place (see ``all_reduce_``)."""
    if not dist.is_initialized() or group is _NO_GROUP:
        return tensors
    return all_reduce_(tensors, group, dist.get_world_size(group))


def broadcast_tensors_(tensors, src=0, group=None):
    """Rank ``src``'s (a global rank) values of ``tensors`` on every rank
    of ``group`` (default: the device group), in place, in one coalesced
    broadcast (a collective per dtype)."""
    if not dist.is_initialized() or not tensors or group is _NO_GROUP:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        _coalesced(same, lambda flat: dist.broadcast(flat, src=src,
                                                     group=group))
    return tensors


# ---------------------------------------------------------------------------
# The rank grid: eve_tpu's data x model x seq mesh over the process group
# ---------------------------------------------------------------------------

# The group of an axis of one rank: every collective over it is the
# identity (there is nothing to exchange), and none is issued.
_NO_GROUP = 'no group'
# The recurrent chains that hand a carry between seq ranks, each over pair
# groups of its own, so that the two chains' handoffs (the GRU's and the
# CLSTM's) never share a communicator and their order cannot deadlock.
CHAINS = ('eye', 'refine')


class Axis:
    """One axis of a rank's grid: the rank's ``index`` on it, its ``size``,
    the global ranks of its members in axis order and their group."""

    def __init__(self, name, index, size, ranks, group):
        self.name, self.index, self.size = name, index, size
        self.ranks = tuple(ranks)
        self.group = group
        self._pairs = {}

    def pair(self, chain, lower):
        """The group of members ``lower`` and ``lower + 1`` for ``chain``'s
        handoffs (seq axis)."""
        return self._pairs[chain, lower]


class RankGrid:
    """eve_tpu's N-D mesh (``make_mesh_nd``) over the process group's
    ranks, seen from one rank.

    ``shape`` holds the axis sizes in their order; ``coords`` the rank's
    index on each. ``axis(name)`` is an ``Axis`` (an axis the grid lacks
    has size 1); ``data_seq`` is the group of ranks that share this rank's
    model coordinate, over which the gradients are reduced.
    """

    def __init__(self, shape, rank, axes, data_seq):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.coords = {n: a.index for n, a in axes.items()}
        self._axes = axes
        self.data_seq = data_seq

    def axis(self, name):
        if name in self._axes:
            return self._axes[name]
        return Axis(name, 0, 1, (self.rank,), _NO_GROUP)

    def index(self, name):
        return self.axis(name).index

    def count(self, name):
        return self.axis(name).size


def _grid_rank(shape, coords):
    """The global rank at ``coords`` of a grid of ``shape`` (row-major, as
    ``reshape`` places ``devices[:total]``)."""
    names = tuple(shape)
    return int(np.ravel_multi_index(tuple(coords.get(n, 0) for n in names),
                                    tuple(shape[n] for n in names)))


def _coordinates(shape, axes):
    """Every coordinate of ``axes`` of a grid ``shape``, row-major, as
    dicts."""
    return [dict(zip(axes, (int(v) for v in values)))
            for values in np.ndindex(*[shape[n] for n in axes])]


def make_mesh_nd(axis_sizes):
    """The process group's ranks as eve_tpu's mesh with named axes, e.g.
    ``{'data': 2, 'seq': 2}``; returns this rank's ``RankGrid`` and keeps
    it (``grid()``).

    A COLLECTIVE: every rank creates every sub-group (``dist.new_group``)
    in the same order. The world must hold the grid exactly: fewer ranks
    raise eve_tpu's message, more would leave ranks idle and raise too.
    Without a process group the grid is one rank's.
    """
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = int(np.prod(sizes))
    world = process_count()
    if world < total:
        raise ValueError('need %d devices for mesh %r, have %d'
                         % (total, dict(axis_sizes), world))
    if world > total:
        raise ValueError('a mesh %r of %d ranks in a world of %d would '
                         'leave %d ranks idle' % (dict(axis_sizes), total,
                                                  world, world - total))
    rank = process_index()
    shape = dict(zip(names, sizes))
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    cache = {}

    def group_of(members, tag=''):
        # Every rank creates every group, in one order; a group of one
        # rank issues no collective.
        if len(members) == 1:
            return _NO_GROUP
        key = (tuple(members), tag)
        if key not in cache:
            cache[key] = dist.new_group(list(members))
        return cache[key]

    def groups(varying, tag=''):
        """Create the groups of the ``varying`` axes, one for every
        coordinate of the others; return this rank's ``(ranks, group)``."""
        mine = None
        for at in _coordinates(shape, [n for n in names
                                       if n not in varying]):
            ranks = [_grid_rank(shape, dict(at, **c))
                     for c in _coordinates(shape, varying)]
            group = group_of(ranks, tag)
            if rank in ranks:
                mine = (ranks, group)
        return mine

    axes = {}
    if not dist.is_initialized():
        for n in names:
            axes[n] = Axis(n, 0, 1, (0,), _NO_GROUP)
        data_seq = _NO_GROUP
    else:
        for n in names:
            ranks, group = groups([n])
            axes[n] = Axis(n, coords[n], shape[n], ranks, group)
        data_seq = groups([n for n in ('data', 'seq') if n in names])[1] \
            if any(n in names for n in ('data', 'seq')) else _NO_GROUP
        if shape.get('seq', 1) > 1:
            seq = axes['seq']
            for chain in CHAINS:
                for at in _coordinates(shape, [n for n in names
                                               if n != 'seq']):
                    for lower in range(shape['seq'] - 1):
                        pair = [_grid_rank(shape, dict(at, seq=lower + i))
                                for i in range(2)]
                        group = group_of(pair, chain)
                        if rank in pair:
                            seq._pairs[chain, lower] = group
    grid = RankGrid(shape, rank, axes, data_seq)
    _STATE['grid'] = grid
    if dist.is_initialized():
        logger.info('> Rank grid %s: rank %d at %s, %s device group', shape,
                    rank, coords, _STATE['backend'])
    return grid


def grid():
    """This rank's grid (``make_mesh_nd``), or None when none was made:
    then the whole world is the data axis."""
    return _STATE['grid']


def data_index():
    """This rank's coordinate on the data axis: its shard of the clips."""
    g = grid()
    return g.index('data') if g is not None else process_index()


def data_count():
    """The size of the data axis."""
    g = grid()
    return g.count('data') if g is not None else process_count()


def data_group():
    """The group of the data axis (None: the whole device group)."""
    g = grid()
    return g.axis('data').group if g is not None else None


def model_sharding_spec(shape, n, axis_name='model', min_size=4096):
    """eve_tpu's tensor-parallel placement rule on an eve_tpu leaf shape:
    the LAST dim (a convolution kernel's O of HWIO, a dense kernel's out of
    (in, out)) over the axis when it divides by ``n`` and the leaf has at
    least ``min_size`` elements, as a tuple in the form of a
    ``PartitionSpec``; else ``()`` (replicated)."""
    shape = tuple(shape)
    if len(shape) >= 1 and shape[-1] % n == 0 and \
            int(np.prod(shape)) >= min_size:
        return (None,) * (len(shape) - 1) + (axis_name,)
    return ()


def shard_model_tree(n, state_dict, axis_name='model', min_size=4096):
    """The leaves eve_tpu's ``shard_model_tree`` places over a model axis
    of ``n`` ranks (``n`` may be a ``RankGrid``): ``{name: torch dim}``
    of the port's state dict (or module) ``state_dict``.

    The rule is eve_tpu's and applies to eve_tpu's leaf shapes, which the
    weight map gives (``utils.convert.eve_layouts``): the dim is the torch
    dim that holds eve_tpu's last dim (a convolution's or a linear layer's
    dim 0, the dense cells' dim -1).
    """
    from eve_tpu_torch.utils import convert
    if isinstance(n, RankGrid):
        n = n.count(axis_name)
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    out = {}
    for name, (shape, dim) in convert.eve_layouts(state_dict).items():
        if model_sharding_spec(shape, n, axis_name, min_size):
            out[name] = dim
    return out


class ModelShards:
    """The model axis of a rank in the first form: each sharded leaf keeps
    its full value in the module for the forward (gathered after every
    update, so the forward is the one-process forward bitwise), and the
    rank's optimizer holds slice ``index`` of it along ``dims[name]``,
    with that slice's Adam moments. This object owns the map from each
    such slice to its leaf (``place``); the optimizer's other tensors are
    the module's parameters themselves."""

    def __init__(self, axis, dims):
        self.axis = axis
        self.dims = dict(dims)
        self._leaves = {}  # id of a slice -> (slice, name, full parameter)

    def __len__(self):
        """The number of leaves whose slices the optimizer holds."""
        return len(self._leaves)

    def chunk(self, full, dim, index=None):
        """Slice ``index`` (default: this rank's) of ``full`` along ``dim``,
        a view."""
        index = self.axis.index if index is None else index
        c = full.shape[dim] // self.axis.size
        return full.narrow(dim, index * c, c)

    def slice(self, name, full):
        """This rank's slice of leaf ``name``'s full value (a copy)."""
        return self.chunk(full, self.dims[name]).clone()

    def place(self, optimizer, model):
        """Replace each of ``optimizer``'s parameters that is a sharded
        leaf of ``model`` by this rank's slice of it, its Adam state
        sliced alike."""
        names = {id(p): n for n, p in model.named_parameters()}
        for group in optimizer.param_groups:
            for i, p in enumerate(group['params']):
                name = names[id(p)]
                if name not in self.dims:
                    continue
                piece = self.slice(name, p.detach())
                self._leaves[id(piece)] = (piece, name, p)
                optimizer.state[piece] = self.slice_state(
                    piece, optimizer.state.pop(p, {}))
                group['params'][i] = piece

    def slices(self):
        """``{leaf name: this rank's slice}`` of the placed leaves."""
        return {name: piece for piece, name, _ in self._leaves.values()}

    def full(self, p):
        """The module parameter that optimizer tensor ``p`` trains: its
        leaf for a slice, else ``p``."""
        leaf = self._leaves.get(id(p))
        return p if leaf is None else leaf[2]

    def slice_state(self, p, values):
        """Optimizer tensor ``p``'s state ``values`` with each tensor of
        the full leaf's shape cut to this rank's slice (``p`` a slice;
        others' are returned as they are)."""
        leaf = self._leaves.get(id(p))
        if leaf is None:
            return values
        _, name, full = leaf
        return {k: (self.slice(name, v)
                    if torch.is_tensor(v) and v.shape == full.shape else v)
                for k, v in values.items()}

    def sliced_dim(self, p, value):
        """The dim that ``value``, a state tensor of optimizer tensor
        ``p``, is cut on over the axis, or None when it is not a slice."""
        leaf = self._leaves.get(id(p))
        if leaf is None or value.shape != p.shape:
            return None
        return self.dims[leaf[1]]

    def step(self, optimizer):
        """``optimizer.step()`` on this rank's slices: each slice's
        gradient is cut from its leaf's full gradient, and the updated
        slices are gathered back into the leaves. A COLLECTIVE over the
        axis."""
        leaves = list(self._leaves.values())
        for piece, name, full in leaves:
            piece.grad = self.chunk(full.grad, self.dims[name]).clone()
        optimizer.step()
        if leaves:
            with torch.no_grad():
                self.gather([piece for piece, _, _ in leaves],
                            [self.dims[name] for _, name, _ in leaves],
                            out=[full for _, _, full in leaves])

    def gather(self, parts, dims, out=None):
        """The full tensors of this rank's slices ``parts`` (cut on
        ``dims``), written into ``out`` when given. A COLLECTIVE over the
        axis: one coalesced broadcast of each member's slices."""
        if out is None:
            out = []
            for p, d in zip(parts, dims):
                shape = list(p.shape)
                shape[d] *= self.axis.size
                out.append(p.new_empty(shape))
        for j, src in enumerate(self.axis.ranks):
            if j == self.axis.index:
                bufs = [p.clone() for p in parts]
            else:
                bufs = [torch.empty_like(p) for p in parts]
            broadcast_tensors_(bufs, src=src, group=self.axis.group)
            for full, d, b in zip(out, dims, bufs):
                self.chunk(full, d, j).copy_(b)
        return out
