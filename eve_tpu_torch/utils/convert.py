"""Carry eve_tpu parameter trees into the port's modules.

eve_tpu stores parameters as nested dicts of arrays in flax layout (conv
``(KH, KW, I, O)``, linear ``(I, O)``, instance-norm ``scale``/``bias``).
The port's modules use the reference's torch state_dict names and layouts
(conv ``(O, I, KH, KW)``, linear ``(O, I)``, ``weight``/``bias``), so a tree
maps onto them with the reference's own key mapping; this is a copy of
``eye_net_params_to_torch`` / ``refine_net_params_to_torch`` from
``eve_tpu/utils/torch_convert.py``. The released reference ``.pt`` files
then load into the same modules with plain ``load_state_dict``.

eve_tpu's opt-in topology (``tpu_native_arch``) has no reference layout
(eve_tpu's ``torch_convert`` refuses it), so its trees map onto port names
that keep eve_tpu's module names: the patchify stem as
``cnn_layers.stem_conv``, and RefineNetTPU's ``stem``, ``enc_blocks.K``,
``dec_blocks.K``, ``rnn_cells.i``, ``final_0``, ``final_2``, ``gate_fc1``
and ``gate_fc2``. A tree or state dict says which topology it holds: a
native EyeNet has ``stem_conv``, a native RefineNet ``stem``.

``eve_params`` is the inverse: a state dict of the port's ``EVE`` back to
eve_tpu's tree, which the checkpoint writer stores in eve_tpu's layout.
Both directions only transpose float32 arrays, so a round trip is exact.
``eve_layouts`` reads off that map each parameter's eve_tpu shape and the
torch dim that holds eve_tpu's last dim (the model axis's placement rule
applies to eve_tpu's shapes).
"""

import numpy as np
import torch


def _conv(v):
    """flax (KH, KW, I, O) -> torch (O, I, KH, KW)."""
    return np.ascontiguousarray(np.transpose(np.asarray(v), (3, 2, 0, 1)))


def _linear(v):
    """flax (I, O) -> torch (O, I)."""
    return np.ascontiguousarray(np.asarray(v).T)


def _conv_back(v):
    """torch (O, I, KH, KW) -> flax (KH, KW, I, O)."""
    return np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))


def _put(tree, path, value):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def eye_net_state_dict(params):
    """eve_tpu EyeNet params tree -> reference-named numpy state dict (the
    patchify stem as ``cnn_layers.stem_conv``)."""
    sd = {}
    for name, sub in params.items():
        if name == 'cnn':
            for mod, p in sub.items():
                if mod in ('conv1', 'stem_conv'):
                    sd['cnn_layers.%s.weight' % mod] = _conv(p['kernel'])
                elif mod == 'fc':
                    sd['cnn_layers.fc.weight'] = _linear(p['kernel'])
                    sd['cnn_layers.fc.bias'] = np.asarray(p['bias'])
                elif mod.startswith('layer'):
                    lname, idx = mod.split('_')
                    for cname, cp in p.items():
                        tkey = ('downsample.0' if cname == 'downsample_conv'
                                else cname)
                        sd['cnn_layers.%s.%s.%s.weight' % (lname, idx, tkey)] = \
                            _conv(cp['kernel'])
                else:
                    raise KeyError('Unmapped EyeNet cnn module: %s' % mod)
        elif name.startswith('rnn_cell_'):
            idx = name[len('rnn_cell_'):]
            for pkey, v in sub.items():
                sd['rnn_cells.%s.%s' % (idx, pkey)] = np.asarray(v)
        else:
            # fc_common_0 / fc_to_gaze_2 / fc_to_pupil_0 / static_fc_0
            mod, idx = name.rsplit('_', 1)
            sd['%s.%s.weight' % (mod, idx)] = _linear(sub['kernel'])
            if 'bias' in sub:  # fc_to_gaze.2 has no bias
                sd['%s.%s.bias' % (mod, idx)] = np.asarray(sub['bias'])
    return sd


_PREACT = {
    'in1': 'layers.0', 'conv1': 'layers.2', 'in2': 'layers.3',
    'conv2': 'layers.5', 'skip_in': 'skip_layer.0', 'skip_conv': 'skip_layer.2',
}


def _put_layer(sd, prefix, p):
    """A conv, dense or instance-norm node of a tree -> ``prefix.weight``
    (and ``prefix.bias``)."""
    if 'kernel' in p:
        k = np.asarray(p['kernel'])
        sd[prefix + '.weight'] = _conv(k) if k.ndim == 4 else _linear(k)
        if 'bias' in p:
            sd[prefix + '.bias'] = np.asarray(p['bias'])
    else:  # instance norm: scale/bias -> weight/bias
        sd[prefix + '.weight'] = np.asarray(p['scale'])
        sd[prefix + '.bias'] = np.asarray(p['bias'])


def refine_net_tpu_state_dict(params):
    """eve_tpu RefineNetTPU params tree -> the port's numpy state dict."""
    sd = {}
    for name, sub in params.items():
        if name in ('stem', 'final_0', 'final_2', 'gate_fc1', 'gate_fc2'):
            _put_layer(sd, name, sub)
        elif name[:3] in ('enc', 'dec') and name[3:].isdigit():
            for fname, p in sub.items():
                _put_layer(sd, '%s_blocks.%s.%s' % (name[:3], name[3:],
                                                    _PREACT[fname]), p)
        elif name.startswith('rnn_cell_'):
            for conv_name, p in sub.items():
                _put_layer(sd, 'rnn_cells.%s.%s' % (
                    name[len('rnn_cell_'):], conv_name), p)
        else:
            raise KeyError('Unmapped RefineNetTPU module: %s' % name)
    return sd


def refine_net_state_dict(params):
    """eve_tpu RefineNet params tree -> reference-named numpy state dict
    (RefineNetTPU's tree -> ``refine_net_tpu_state_dict``)."""
    if 'stem' in params:
        return refine_net_tpu_state_dict(params)
    sd = {}
    for name, sub in params.items():
        if name in ('initial_0', 'initial_1', 'initial_3', 'final_0',
                    'final_2'):
            mod, idx = name.rsplit('_', 1)
            _put_layer(sd, '%s.%s' % (mod, idx), sub)
        elif name.startswith('enc') or name.startswith('dec'):
            kind, rest = name[:3], name[3:]
            k, i = rest.split('_')
            prefix = 'network.' + 'between_module.' * int(k)
            tmod = 'encoder_blocks' if kind == 'enc' else 'decoder_blocks'
            for fname, p in sub.items():
                _put_layer(sd, '%s%s.%s.%s'
                           % (prefix, tmod, i, _PREACT[fname]), p)
        elif name.startswith('rnn_cell_'):
            idx = name[len('rnn_cell_'):]
            prefix = 'network.' + 'between_module.' * 5
            for conv_name, p in sub.items():
                _put_layer(sd, '%srnn_cells.%s.%s'
                           % (prefix, idx, conv_name), p)
        else:
            raise KeyError('Unmapped RefineNet module: %s' % name)
    return sd


def submodule_state_dict(which, tree):
    """eve_tpu tree of submodule ``which`` (``'eye_net'`` or
    ``'refine_net'``) -> its state dict (CPU float32 tensors)."""
    to_sd = (eye_net_state_dict if which == 'eye_net'
             else refine_net_state_dict)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in to_sd(tree).items()}


def eve_state_dict(params):
    """eve_tpu ``{'eye_net': ..., 'refine_net': ...}`` tree -> state dict of
    the port's ``EVE`` model (CPU float32 tensors)."""
    return {'%s.%s' % (which, k): v
            for which in ('eye_net', 'refine_net') if which in params
            for k, v in submodule_state_dict(which, params[which]).items()}


_PREACT_BACK = {v: k for k, v in _PREACT.items()}


def _layer_back(leaf, v):
    """A conv or instance-norm entry: ``(flax leaf name, value)``."""
    if leaf == 'bias':
        return 'bias', v
    return ('kernel', _conv_back(v)) if v.ndim == 4 else ('scale', v)


def eye_net_params(state_dict):
    """Reference-named EyeNet state dict -> eve_tpu EyeNet params tree."""
    tree = {}
    for key, v in state_dict.items():
        v = np.asarray(v, np.float32)
        parts = key.split('.')
        if parts[0] == 'cnn_layers':
            if parts[1] in ('conv1', 'stem_conv'):
                _put(tree, ('cnn', parts[1], 'kernel'), _conv_back(v))
            elif parts[1] == 'fc':
                _put(tree, ('cnn', 'fc', 'kernel' if parts[2] == 'weight'
                            else 'bias'), _linear(v) if v.ndim == 2 else v)
            else:  # layerN.i.{conv1,conv2,downsample.0}.weight
                conv = ('downsample_conv' if parts[3] == 'downsample'
                        else parts[3])
                _put(tree, ('cnn', '%s_%s' % (parts[1], parts[2]), conv,
                            'kernel'), _conv_back(v))
        elif parts[0] == 'rnn_cells':
            _put(tree, ('rnn_cell_' + parts[1], parts[2]), v)
        else:  # fc_common.0.weight and the other Linear stacks
            _put(tree, ('%s_%s' % (parts[0], parts[1]),
                        'kernel' if parts[2] == 'weight' else 'bias'),
                 _linear(v) if v.ndim == 2 else v)
    return tree


def refine_net_tpu_params(state_dict):
    """The port's RefineNetTPU state dict -> eve_tpu RefineNetTPU tree."""
    tree = {}
    for key, v in state_dict.items():
        v = np.asarray(v, np.float32)
        parts = key.split('.')
        if parts[0].startswith('gate_fc'):
            _put(tree, (parts[0], 'kernel' if parts[1] == 'weight'
                        else 'bias'), _linear(v) if v.ndim == 2 else v)
        elif parts[0] in ('stem', 'final_0', 'final_2'):
            leaf, value = _layer_back(parts[1], v)
            _put(tree, (parts[0], leaf), value)
        elif parts[0] == 'rnn_cells':
            leaf, value = _layer_back(parts[3], v)
            _put(tree, ('rnn_cell_' + parts[1], parts[2], leaf), value)
        else:  # {enc,dec}_blocks.K.{layers,skip_layer}.N.leaf
            leaf, value = _layer_back(parts[4], v)
            _put(tree, (parts[0][:3] + parts[1],
                        _PREACT_BACK['%s.%s' % (parts[2], parts[3])], leaf),
                 value)
    return tree


def refine_net_params(state_dict):
    """Reference-named RefineNet state dict -> eve_tpu RefineNet tree
    (RefineNetTPU's -> ``refine_net_tpu_params``)."""
    if 'stem.weight' in state_dict:
        return refine_net_tpu_params(state_dict)
    tree = {}
    for key, v in state_dict.items():
        v = np.asarray(v, np.float32)
        parts = key.split('.')
        if parts[0] in ('initial', 'final'):
            leaf, value = _layer_back(parts[2], v)
            _put(tree, ('%s_%s' % (parts[0], parts[1]), leaf), value)
            continue
        k = 0
        parts = parts[1:]  # 'network'
        while parts[0] == 'between_module':
            k += 1
            parts = parts[1:]
        if parts[0] == 'rnn_cells':
            leaf, value = _layer_back(parts[3], v)
            _put(tree, ('rnn_cell_' + parts[1], parts[2], leaf), value)
        else:  # {encoder,decoder}_blocks.i.{layers,skip_layer}.N.leaf
            kind = 'enc' if parts[0] == 'encoder_blocks' else 'dec'
            leaf, value = _layer_back(parts[4], v)
            _put(tree, ('%s%d_%s' % (kind, k, parts[1]),
                        _PREACT_BACK['%s.%s' % (parts[2], parts[3])], leaf),
                 value)
    return tree


def eve_params(state_dict):
    """State dict of the port's ``EVE`` -> eve_tpu ``{'eye_net': ...,
    'refine_net': ...}`` tree of float32 numpy arrays."""
    subs = {}
    for key, v in state_dict.items():
        prefix, rest = key.split('.', 1)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        subs.setdefault(prefix, {})[rest] = v
    out = {'eye_net': eye_net_params(subs['eye_net'])}
    if 'refine_net' in subs:
        out['refine_net'] = refine_net_params(subs['refine_net'])
    return out


def _tree_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _tree_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def eve_layouts(state_dict):
    """``{name: (eve_tpu shape, torch dim)}`` of a state dict of the port's
    ``EVE``: the shape of the leaf that ``eve_params`` makes of each
    parameter, and the torch dim that becomes that leaf's last dim (None
    for a 0-dim leaf or a last dim of size 1, which no axis splits).

    Read off the weight map itself: each parameter goes through the map
    alone as a probe holding its own flat indices, so the last dim's step
    in the probe is the stride of the torch dim it came from.
    """
    subs = {}
    for key, v in state_dict.items():
        prefix, rest = key.split('.', 1)
        subs.setdefault(prefix, {})[rest] = tuple(v.shape)
    out = {}
    for which, shapes in subs.items():
        if which == 'eye_net':
            to_tree = eye_net_params
        elif 'stem.weight' in shapes:
            to_tree = refine_net_tpu_params
        else:
            to_tree = refine_net_params
        for key, shape in shapes.items():
            probe = np.arange(int(np.prod(shape)), dtype=np.float32) \
                .reshape(shape)
            ((_, leaf),) = _tree_leaves(to_tree({key: probe}))
            dim = None
            if leaf.ndim and leaf.shape[-1] > 1:
                step = leaf[(0,) * (leaf.ndim - 1) + (1,)] - leaf.flat[0]
                strides = np.cumprod((1,) + shape[::-1])[-2::-1]
                dim = next(d for d in range(len(shape))
                           if shape[d] == leaf.shape[-1] and
                           strides[d] == step)
            out['%s.%s' % (which, key)] = (tuple(leaf.shape), dim)
    return out
