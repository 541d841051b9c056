"""Seeded weights for both sides, made on the device in one draw.

Every parameter of ``reference.eve.param_specs`` is cut from one
``torch.randn`` on a seeded ``torch.Generator`` of the device and scaled
by its kind, after eve_tpu's initialisers: convolutions kaiming-normal
(fan out, ReLU gain), linear layers and GRU cells with the standard
deviation of their uniform initialisers. Unlike a training start, nothing
is zero and the norms' affine terms are drawn too (``1 + 0.1 z`` and
``0.1 z``), so that every layer changes the outputs the check compares.
``std_overrides`` sets the scale of named leaves (the configuration's
``weights`` section): the layers that a training start zeroes.
``std_scales`` multiplies the scale of the leaves whose names match a
pattern (``fnmatch``).
"""

import fnmatch
import math

import torch


def _std(name, shape, kind, fan_in):
    if kind == 'conv':
        o, _, kh, kw = shape
        return math.sqrt(2.0 / (o * kh * kw))
    if kind == 'conv_bias':
        return 0.01
    if kind == 'linear':
        return 1.0 / math.sqrt(3.0 * fan_in)
    if kind == 'rnn':
        return 1.0 / math.sqrt(3.0 * (shape[0] // 3))
    if kind in ('norm_weight', 'norm_bias'):
        return 0.1
    raise ValueError('unknown parameter kind %r of %s' % (kind, name))


def make_weights(specs, seed, device, section=None):
    """``{name: float32 tensor}`` on ``device`` for ``specs`` (``[(name,
    shape, kind)]``) from ``seed``; ``section``: the configuration's
    ``weights`` (``std_overrides``, ``std_scales``)."""
    overrides = (section or {}).get('std_overrides', {})
    scales = (section or {}).get('std_scales', {})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset, fan_in = {}, 0, {}
    for (name, shape, kind), n in zip(specs, sizes):
        t = z[offset:offset + n].view(shape)
        offset += n
        layer = name.rsplit('.', 1)[0]
        if len(shape) == 2:
            # A linear layer's bias follows its weight.
            fan_in[layer] = shape[1]
        std = overrides.get(name, _std(name, shape, kind,
                                       fan_in.get(layer)))
        for pattern, factor in scales.items():
            if fnmatch.fnmatchcase(name, pattern):
                std *= factor
        out[name] = t * std + (1.0 if kind == 'norm_weight' else 0.0)
    return out
