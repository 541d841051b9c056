"""Data parallelism: the in-process device mesh and the process group.

The counterpart of ``eve_tpu/parallel/mesh.py``'s ``data`` axis. eve_tpu
drives every device from one process through a ``jax.sharding.Mesh``:
GSPMD splits the batch along ``P('data')``, replicates the parameters and
all-reduces the gradients. The port maps that onto PyTorch in two ways:

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
  gradient all-reduce (``all_reduce_mean_``). A second, gloo, group carries
  the host's small agreements (``broadcast_string``, ``all_gather_flags``,
  ``broadcast_object``), so they never touch the card. Multi-host uses the
  same group: eve_tpu's ``tpu_num_processes`` counts hosts and
  ``tpu_process_id`` is the host's index; the ranks of a host are its
  local workers, one per GPU.

``make_mesh_nd`` and ``shard_model_tree`` (the ``seq`` and ``model`` axes)
are not here yet (ROADMAP.md, Slice J).
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
          'host_group': None}
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
    logger.info('> Process group: rank %d of %d (host %d of %d, worker %d '
                'of %d), %s device group, gloo host group',
                dist.get_rank(), dist.get_world_size(), host, hosts,
                local_rank, local_world, backend)


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(host=0, hosts=1, local_rank=0, local_world=1,
                  host_group=None)


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


def gather_to_host(tree, skip_local=False):
    """A host copy of a dict (or list) of tensors.

    Data parallelism replicates every parameter, so this is a local copy
    and no collective; eve_tpu's signature is kept. ``skip_local`` returns
    the tree unchanged (a rank that writes nothing skips the copy).
    """
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
    """Run the device-group collective ``op`` on one flat buffer of
    ``tensors`` and copy the result back."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_(tensors):
    """Average ``tensors`` (same shapes and dtype on every rank) over the
    device group, in place, in one coalesced all-reduce; a group of one
    rank runs it too. Without a group they are returned as they are."""
    if not dist.is_initialized() or not tensors:
        return tensors
    world = dist.get_world_size()

    def reduce(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    _coalesced(tensors, reduce)
    return tensors


def broadcast_tensors_(tensors, src=0):
    """Rank ``src``'s values of ``tensors`` on every rank, in place, in one
    coalesced broadcast (a collective per dtype) over the device group."""
    if not dist.is_initialized() or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        _coalesced(group, lambda flat: dist.broadcast(flat, src=src))
    return tensors
