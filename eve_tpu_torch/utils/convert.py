"""Carry eve_tpu parameter trees into the port's modules.

eve_tpu stores parameters as nested dicts of arrays in flax layout (conv
``(KH, KW, I, O)``, linear ``(I, O)``, instance-norm ``scale``/``bias``).
The port's modules use the reference's torch state_dict names and layouts
(conv ``(O, I, KH, KW)``, linear ``(O, I)``, ``weight``/``bias``), so a tree
maps onto them with the reference's own key mapping; this is a copy of
``eye_net_params_to_torch`` / ``refine_net_params_to_torch`` from
``eve_tpu/utils/torch_convert.py``. The released reference ``.pt`` files
then load into the same modules with plain ``load_state_dict``.
"""

import numpy as np
import torch


def _conv(v):
    """flax (KH, KW, I, O) -> torch (O, I, KH, KW)."""
    return np.ascontiguousarray(np.transpose(np.asarray(v), (3, 2, 0, 1)))


def _linear(v):
    """flax (I, O) -> torch (O, I)."""
    return np.ascontiguousarray(np.asarray(v).T)


def eye_net_state_dict(params):
    """eve_tpu EyeNet params tree -> reference-named numpy state dict."""
    if 'stem_conv' in params.get('cnn', {}):
        raise ValueError(
            'This EyeNet uses the TPU-native patchify stem (tpu_native_arch), '
            'which has no reference-layout counterpart.')
    sd = {}
    for name, sub in params.items():
        if name == 'cnn':
            for mod, p in sub.items():
                if mod == 'conv1':
                    sd['cnn_layers.conv1.weight'] = _conv(p['kernel'])
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


def refine_net_state_dict(params):
    """eve_tpu RefineNet params tree -> reference-named numpy state dict."""
    if 'stem' in params:
        raise ValueError(
            'This RefineNet is the TPU-native topology (tpu_native_arch), '
            'which has no reference-layout counterpart.')
    sd = {}

    def put(prefix, p):
        if 'kernel' in p:
            sd[prefix + '.weight'] = _conv(p['kernel'])
            if 'bias' in p:
                sd[prefix + '.bias'] = np.asarray(p['bias'])
        else:  # instance norm: scale/bias -> weight/bias
            sd[prefix + '.weight'] = np.asarray(p['scale'])
            sd[prefix + '.bias'] = np.asarray(p['bias'])

    for name, sub in params.items():
        if name in ('initial_0', 'initial_1', 'initial_3', 'final_0',
                    'final_2'):
            mod, idx = name.rsplit('_', 1)
            put('%s.%s' % (mod, idx), sub)
        elif name.startswith('enc') or name.startswith('dec'):
            kind, rest = name[:3], name[3:]
            k, i = rest.split('_')
            prefix = 'network.' + 'between_module.' * int(k)
            tmod = 'encoder_blocks' if kind == 'enc' else 'decoder_blocks'
            for fname, p in sub.items():
                put('%s%s.%s.%s' % (prefix, tmod, i, _PREACT[fname]), p)
        elif name.startswith('rnn_cell_'):
            idx = name[len('rnn_cell_'):]
            prefix = 'network.' + 'between_module.' * 5
            for conv_name, p in sub.items():
                put('%srnn_cells.%s.%s' % (prefix, idx, conv_name), p)
        else:
            raise KeyError('Unmapped RefineNet module: %s' % name)
    return sd


def eve_state_dict(params):
    """eve_tpu ``{'eye_net': ..., 'refine_net': ...}`` tree -> state dict of
    the port's ``EVE`` model (CPU float32 tensors)."""
    sd = {'eye_net.' + k: v
          for k, v in eye_net_state_dict(params['eye_net']).items()}
    if 'refine_net' in params:
        sd.update({'refine_net.' + k: v
                   for k, v in refine_net_state_dict(
                       params['refine_net']).items()})
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}
