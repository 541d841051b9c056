"""Checkpoints in eve_tpu's on-disk layout, written and read by the port.

The counterpart of ``eve_tpu/train/checkpoint.py``. A checkpoint is a
directory ``<run>/checkpoints/%07d.ckpt`` (the number counts completed
training steps) holding one ``<prefix>.npz`` per top-level submodule
(``eye_net``, ``refine_net``): eve_tpu's parameter tree of that submodule,
'/'-flattened (``flatten_tree``), in eve_tpu's layouts
(``utils.convert.eve_params``). So eve_tpu's ``CheckpointManager.load``
reads the port's parameters, and the port reads eve_tpu's.

The optimizer state goes to two files. ``optimizer_torch.npz`` is the
port's own: Adam's moments and step count per parameter name, and, mid-way
through a gradient accumulation, the gradients summed so far; the port
reads it first, so its own runs resume exactly. ``optimizer_0.npz`` is
eve_tpu's: the '/'-flattened optax state that eve_tpu's ``build_optimizer
(...).init`` would hold after the same updates (``optax_state_flat``), so
eve_tpu resumes a run of the port with its Adam state. The tree follows the
config's chain layout (``optim.optax_layout``): the flat chain,
``multi_transform`` with a frozen EyeNet or per-submodule LR multipliers
(a subtree another label owns is an empty ``__empty__`` node),
``MultiSteps`` (its running mean of the accumulated gradients is the
port's sum over the micro-steps taken). Every ``count`` and
``gradient_step`` is the number of updates taken.

eve_tpu skips ``optimizer_*`` files when it reads parameters. A run of
eve_tpu resumes with its optax state from ``optimizer_0.npz``, or from
``optimizer_0.msgpack`` (older eve_tpu runs; ``utils.msgpack_tree``
decodes it), through ``optax_optimizer_tree``: every ``scale_by_adam``
node's ``mu``, ``nu`` and ``count`` become torch Adam's ``exp_avg``,
``exp_avg_sq`` and ``step``, through the transposes ``utils.convert``
applies to the parameters, and ``MultiSteps``' mean of the gradients
becomes the port's sum.

Writes are atomic (a ``.tmp`` directory, then a rename), the newest
``keep_n`` are kept, and ``save_at_step(wait=False)`` hands the file write
to a background thread after a synchronous host snapshot, so the written
bytes are exactly this step's state.

In a data-parallel run only rank 0 saves (``harness.save_checkpoint``):
every rank holds the same replicated state, so the snapshot is a local
copy (``parallel.mesh.gather_to_host``). Under the model axis each rank
holds its slices of the sharded leaves' Adam moments: ``snapshot`` gathers
them on every rank (a collective) before rank 0 writes, so the checkpoint
has one process's layout. On resume rank 0 reads, and ``snapshot``'s
optimizer part goes to the other ranks (``load_optimizer_snapshot``),
which slice what they own.
"""

import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from eve_tpu_torch.parallel.mesh import gather_to_host
from eve_tpu_torch.utils import convert, msgpack_tree
from eve_tpu_torch.utils.checkpoint import (
    available_checkpoints, load_params, unflatten_tree)

logger = logging.getLogger(__name__)

_SUFFIX = '.ckpt'
OPTIMIZER_FILE = 'optimizer_torch.npz'
# eve_tpu's optimizer state: the '/'-flattened optax state tree, and the
# older msgpack form.
OPTAX_OPTIMIZER_FILE = 'optimizer_0.npz'
OPTAX_MSGPACK_FILE = 'optimizer_0.msgpack'
_EMPTY = '__empty__'  # eve_tpu's marker of an empty optax node


def flatten_tree(tree, prefix=()):
    """Nested dicts of arrays -> ``{'a/b/c': array}``; an empty dict below
    the root becomes ``path/__empty__`` (eve_tpu's ``flatten_tree``).
    Torch tensors stay tensors."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) and not value:
            out['/'.join(path + (_EMPTY,))] = np.zeros(0, np.uint8)
        elif isinstance(value, dict):
            out.update(flatten_tree(value, path))
        elif isinstance(value, torch.Tensor):
            out['/'.join(path)] = value
        else:
            out['/'.join(path)] = np.asarray(value)
    return out


def snapshot(state, skip_local=False):
    """The state's parameters, optimizer state and partial gradients as
    CPU tensors the caller owns (a synchronous copy off the device).

    Under the model axis a COLLECTIVE (every rank of the axis calls it):
    the sharded Adam moments are gathered to their full values.
    ``skip_local`` (a rank that writes nothing) joins the gather and
    skips the copies."""
    model, optimizer = state.model, state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    opt, sharded = {}, {}
    sd = optimizer.state_dict()
    ordered = [p for g in optimizer.param_groups for p in g['params']]
    for index, values in sd['state'].items():
        p = ordered[index]
        name = names[id(state.leaf(p))]
        for k, v in values.items():
            key = 'state/%s/%s' % (name, k)
            opt[key] = torch.as_tensor(v)
            dim = (None if state.shards is None
                   else state.shards.sliced_dim(p, opt[key]))
            if dim is not None:
                sharded[key] = dim
    if state.step % state.accumulation_steps:
        for p in state.full_parameters():
            if p.grad is not None:
                opt['grad/' + names[id(p)]] = p.grad
    opt = gather_to_host(opt, skip_local, sharded, state.shards)
    if skip_local:
        return None, None
    return gather_to_host(model.state_dict()), opt


def load_optimizer_snapshot(state, opt):
    """Restore the optimizer part of ``snapshot`` into ``state``."""
    _load_optimizer(state, unflatten_tree(opt))


class CheckpointManager:
    """Save, load and prune checkpoints of a ``TrainState``."""

    def __init__(self, output_dir, keep_n=3):
        self.output_dir = output_dir
        self.keep_n = keep_n
        self._writer = None   # created at the first background save
        self._pending = None  # the outstanding background write, if any

    @property
    def checkpoint_dir(self):
        return os.path.join(self.output_dir, 'checkpoints')

    def _step_dir(self, step):
        return os.path.join(self.checkpoint_dir, ('%07d' % step) + _SUFFIX)

    def save_at_step(self, step, state, wait=True, write=True):
        """Write the state as checkpoint ``step``; returns its directory.

        ``wait=False`` returns after the host snapshot and writes on a
        background thread; its error surfaces at the next save, load,
        ``wait_for_writes`` or ``close``. ``write=False`` only joins the
        snapshot's collectives (a rank of the model axis that is not
        rank 0).
        """
        # At most one snapshot alive: join the previous write first.
        self.wait_for_writes()
        params, opt = snapshot(state, skip_local=not write)
        if not write:
            return None
        plan = (None if state.optax_layout is None
                else (state.optax_layout, state.step))
        if wait:
            return self._write(step, params, opt, plan)
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix='ckpt-writer')
        self._pending = self._writer.submit(self._write, step, params, opt,
                                            plan)
        return self._step_dir(step)

    def wait_for_writes(self):
        """Join the outstanding background write, re-raising its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        """Finish the outstanding write and stop the writer thread."""
        try:
            self.wait_for_writes()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def _write(self, step, params, opt, plan):
        """Write the snapshot ``params, opt``; ``plan`` is ``(optax layout,
        micro-step)`` of eve_tpu's ``optimizer_0.npz``, or None for no such
        file (a ``TrainState`` built without a layout)."""
        final_dir = self._step_dir(step)
        tmp_dir = final_dir + '.tmp'
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        tree = convert.eve_params({k: v.numpy() for k, v in params.items()})
        for prefix, subtree in tree.items():
            np.savez(os.path.join(tmp_dir, prefix + '.npz'),
                     **flatten_tree(subtree))
        np.savez(os.path.join(tmp_dir, OPTIMIZER_FILE),
                 **{k: v.numpy() for k, v in opt.items()})
        if plan is not None:
            np.savez(os.path.join(tmp_dir, OPTAX_OPTIMIZER_FILE),
                     **optax_flat(*plan, params, opt))
        if os.path.isdir(final_dir):
            shutil.rmtree(final_dir)
        os.rename(tmp_dir, final_dir)
        logger.info('> Saved parameters to: %s', final_dir)
        self._prune()
        return final_dir

    def _prune(self):
        available = available_checkpoints(self.output_dir)
        for _, path in available[:max(len(available) - self.keep_n, 0)]:
            shutil.rmtree(path)
            logger.info('> Removed checkpoint: %s', path)

    def load(self, path, state, load_optimizer=True):
        """Load checkpoint directory ``path`` into ``state``; returns the
        step it records. Submodules without a file keep their values."""
        self.wait_for_writes()
        model = state.model
        sd = convert.eve_state_dict(load_params(path))
        unexpected = sorted(set(sd) - set(model.state_dict()))
        if unexpected:
            raise KeyError('checkpoint %s holds parameters the model does '
                           'not have: %s' % (path, unexpected[:5]))
        model.load_state_dict(sd, strict=False)
        step = int(os.path.basename(path)[:-len(_SUFFIX)])
        state.step = step
        opt_path = os.path.join(path, OPTIMIZER_FILE)
        optax_path = os.path.join(path, OPTAX_OPTIMIZER_FILE)
        msgpack_path = os.path.join(path, OPTAX_MSGPACK_FILE)
        if load_optimizer and os.path.isfile(opt_path):
            with np.load(opt_path) as data:
                _load_optimizer(state, unflatten_tree(
                    {k: data[k] for k in data.files}))
            logger.info('> Loaded optimizer state from: %s', opt_path)
        elif load_optimizer and os.path.isfile(optax_path):
            with np.load(optax_path) as data:
                _load_optimizer(state, optax_optimizer_tree(
                    state, {k: data[k] for k in data.files}))
            logger.info('> Loaded eve_tpu optimizer state (optax) from: %s',
                        optax_path)
        elif load_optimizer and os.path.isfile(msgpack_path):
            with open(msgpack_path, 'rb') as f:
                flat = flatten_tree(msgpack_tree.loads(f.read()))
            _load_optimizer(state, optax_optimizer_tree(state, flat))
            logger.info('> Loaded eve_tpu optimizer state (optax, msgpack) '
                        'from: %s', msgpack_path)
        return step

    def load_last_checkpoint(self, state, load_optimizer=True):
        """Load the newest checkpoint; returns its step, or 0 if none."""
        self.wait_for_writes()
        available = available_checkpoints(self.output_dir)
        if not available:
            return 0
        return self.load(available[-1][1], state,
                         load_optimizer=load_optimizer)


def _load_optimizer(state, tree):
    """Restore Adam's per-parameter state (and partial gradients) by
    parameter name; a rank of the model axis keeps its slices of the
    sharded leaves' moments."""
    optimizer = state.optimizer
    params = dict(state.model.named_parameters())
    names = {id(p): n for n, p in params.items()}
    ordered = [p for g in optimizer.param_groups for p in g['params']]
    index = {names[id(state.leaf(p))]: i for i, p in enumerate(ordered)}
    sd = optimizer.state_dict()
    sd['state'] = {}
    for name, values in tree.get('state', {}).items():
        i = index[name]
        values = {k: torch.from_numpy(np.asarray(v))
                  for k, v in values.items()}
        if state.shards is not None:
            values = state.shards.slice_state(ordered[i], values)
        sd['state'][i] = values
    optimizer.load_state_dict(sd)
    for name, g in tree.get('grad', {}).items():
        p = params[name]
        p.grad = torch.from_numpy(np.asarray(g)).to(p.device)


def _adam_nodes(flat):
    """``{node path: [keys of its mu and nu leaves]}`` of every
    ``scale_by_adam`` state in a flattened optax tree: the first ``mu`` or
    ``nu`` component of a key whose node has a ``count`` beside it."""
    nodes = {}
    for key in flat:
        parts = key.split('/')
        for i, part in enumerate(parts[:-1]):
            if part in ('mu', 'nu'):
                node = '/'.join(parts[:i])
                if (node + '/count' if node else 'count') in flat:
                    nodes.setdefault(node, []).append(key)
                break
    return nodes


def _port_leaves(flat, prefix, what):
    """The leaves under ``prefix`` of a flattened eve_tpu tree, by the
    port's parameter names (``utils.convert``'s transposes)."""
    tree = unflatten_tree({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix) and
                           not k.endswith(_EMPTY)})
    unknown = sorted(set(tree) - {'eye_net', 'refine_net'})
    if unknown:
        raise KeyError('%s: optax leaves under %s%s have no counterpart in '
                       'the port' % (what, prefix, unknown[0]))
    try:
        return {k: v.numpy() for k, v in convert.eve_state_dict(tree).items()}
    except KeyError as exc:
        raise KeyError('%s: optax leaf %s has no counterpart in the port'
                       % (what, exc)) from None


def optax_optimizer_tree(state, flat):
    """eve_tpu's flattened optax state -> the tree ``_load_optimizer``
    takes: ``{'state': {name: {'step', 'exp_avg', 'exp_avg_sq'}},
    'grad': {name: summed gradient}}``.

    Every parameter the port's optimizer trains must get its moments from
    exactly one Adam node, and every moment must land on such a parameter;
    anything else raises, naming the leaf.
    """
    named = dict(state.model.named_parameters())
    held = {id(p) for p in state.full_parameters()}
    trainable = {n for n, p in named.items() if id(p) in held}
    moments = {}
    for node in sorted(_adam_nodes(flat)):
        base = node + '/' if node else ''
        count = np.float32(flat[base + 'count'])
        mu = _port_leaves(flat, base + 'mu/', 'optimizer_0.npz')
        nu = _port_leaves(flat, base + 'nu/', 'optimizer_0.npz')
        if set(mu) != set(nu):
            raise KeyError('optax node %s: mu and nu hold other leaves: %s'
                           % (node, sorted(set(mu) ^ set(nu))[:5]))
        for name in mu:
            if name not in named:
                raise KeyError('optax node %s holds Adam moments of %s, '
                               'which the port does not have' % (node, name))
            if name not in trainable:
                raise KeyError('optax node %s holds Adam moments of %s, '
                               'which the port does not train' % (node, name))
            if name in moments:
                raise KeyError('two optax Adam nodes hold moments of %s'
                               % name)
            moments[name] = {'step': count, 'exp_avg': mu[name],
                             'exp_avg_sq': nu[name]}
    missing = sorted(trainable - set(moments))
    if missing:
        raise KeyError('optimizer_0.npz holds no Adam moments of %d trained '
                       'parameters: %s' % (len(missing), missing[:5]))
    # optax's MultiSteps keeps the running mean of the micro-steps'
    # gradients; the port keeps their sum.
    mini_step = int(flat.get('mini_step', 0))
    if state.step % state.accumulation_steps != mini_step:
        raise ValueError(
            'checkpoint at micro-step %d under gradient_accumulation_steps '
            '%d, but its optax state is %d micro-steps into an update'
            % (state.step, state.accumulation_steps, mini_step))
    grads = {}
    if mini_step:
        acc = _port_leaves(flat, 'acc_grads/', 'optimizer_0.npz')
        unknown = sorted(set(acc) - set(named))
        if unknown:
            raise KeyError('optax acc_grads of %s, which the port does not '
                           'have' % unknown[:5])
        grads = {n: (v * np.float32(mini_step)).astype(np.float32)
                 for n, v in acc.items() if n in trainable}
    return {'state': moments, 'grad': grads}


def _eve_subtrees(arrays):
    """``{port parameter name: array}`` -> ``{submodule: eve_tpu tree}``
    (``utils.convert``'s transposes, one submodule at a time)."""
    subs = {}
    for name, v in arrays.items():
        prefix, rest = name.split('.', 1)
        subs.setdefault(prefix, {})[rest] = v
    to_eve = {'eye_net': convert.eye_net_params,
              'refine_net': convert.refine_net_params}
    return {k: to_eve[k](sd) for k, sd in subs.items()}


def optax_flat(layout, step, params, opt):
    """The '/'-flattened optax state of eve_tpu's chain ``layout``
    (``optim.OptaxLayout``) at micro-step ``step``, from a ``snapshot``'s
    ``params, opt``: the tree eve_tpu's ``flatten_tree(build_optimizer(
    ...).init(params))`` has, holding this state's values.

    The branches are ``build_optimizer``'s. Each top-level subtree has a
    label (``'frozen'`` for a frozen EyeNet, its own name under an LR
    multiplier other than 1, else ``'train'``); each Adam chain holds the
    moments of its label's subtrees and an empty node for the others.
    """
    updates = step // layout.accumulation
    count = np.asarray(updates, np.int32)
    keys = sorted({n.split('.', 1)[0] for n in params})
    custom = any(m != 1.0 for m in layout.multipliers.values())
    labels = {k: ('frozen' if layout.frozen and k == 'eye_net' else
                  k if custom and layout.multipliers.get(k, 1.0) != 1.0
                  else 'train') for k in keys}
    moments = {}
    for which in ('exp_avg', 'exp_avg_sq'):
        arrays = {}
        for name, p in params.items():
            if labels[name.split('.', 1)[0]] == 'frozen':
                continue
            v = opt.get('state/%s/%s' % (name, which))
            arrays[name] = (np.zeros(p.shape, np.float32) if v is None
                            else v.numpy())
        moments[which] = _eve_subtrees(arrays)

    def masked(tree, label):
        return {k: tree[k] if labels[k] == label else {} for k in keys}

    def inner(label):  # weight decay -> Adam -> LR
        return [{}] * layout.weight_decay + [
            {'count': count, 'mu': masked(moments['exp_avg'], label),
             'nu': masked(moments['exp_avg_sq'], label)},
            {'count': count}]

    def chain(parts):
        return {str(i): part for i, part in enumerate(parts)}

    clip = [{}] * layout.clip
    if not custom:
        tree = chain(clip + inner('train'))
        if layout.frozen:
            tree = {'inner_states': {'train': {'inner_state': tree},
                                     'frozen': {'inner_state': {}}}}
    else:
        transforms = {'train': chain(inner('train')), 'frozen': {}}
        for k, m in layout.multipliers.items():
            if m != 1.0:
                transforms[k] = chain(inner(k))
        if clip and layout.frozen:  # the clip masked off the EyeNet
            clip = [{'inner_state': {}}]
        tree = chain(clip + [{'inner_states': {
            label: {'inner_state': s} for label, s in transforms.items()}}])
    if layout.accumulation > 1:
        mini_step = step % layout.accumulation
        acc = {}
        for name, p in params.items():
            g = opt.get('grad/' + name)
            acc[name] = (g.numpy() / np.float32(mini_step)
                         if mini_step and g is not None
                         else np.zeros(p.shape, np.float32))
        tree = {'mini_step': np.asarray(mini_step, np.int32),
                'gradient_step': count, 'inner_opt_state': tree,
                'acc_grads': _eve_subtrees(acc), 'skip_state': {}}
    return flatten_tree(tree)


def optax_state_flat(state):
    """eve_tpu's flattened optax state of ``state`` (``optax_flat``), the
    inverse of ``optax_optimizer_tree``. Under the model axis a
    collective, as ``snapshot`` is."""
    params, opt = snapshot(state)
    return optax_flat(state.optax_layout, state.step, params, opt)
