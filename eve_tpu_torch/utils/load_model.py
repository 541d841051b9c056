"""Pretrained EyeNet / RefineNet weights: file names, search, loading.

The counterpart of ``eve_tpu/utils/load_model.py``. The reference releases
``eve_eyenet_<RNN|static>.pt`` and
``eve_refinenet_<RNN|static>[_oa][_skip].pt``
(https://github.com/swook/EVE/releases/download/v0.0/); eve_tpu's native
form is a checkpoint's ``<submodule>.npz`` under the same name with
``.npz``. Both are found in ``pretrained_dir`` and then in
``$EVE_PRETRAINED_DIR``, the ``.npz`` first. Nothing is downloaded.

The port's modules carry the reference's state_dict names, so a released
``.pt`` loads with ``load_state_dict`` as it is; an ``.npz`` goes through
``utils.convert``. Under eve_tpu's opt-in topology (``tpu_native_arch``)
the ``.npz`` names carry eve_tpu's markers, ``_tpu`` (``_tpu8`` for a
``patchify8`` EyeNet: the two stems have the same parameters, so only the
name tells them apart), and no ``.pt`` is eligible, since the released
weights cannot express that topology. A file whose shapes differ from the
configured model's raises eve_tpu's ``ValueError``.
"""

import logging
import os

import numpy as np
import torch

from eve_tpu_torch.utils import convert
from eve_tpu_torch.utils.checkpoint import unflatten_tree

logger = logging.getLogger(__name__)

SUBMODULES = ('eye_net', 'refine_net')


def pretrained_filename(config, which, ext):
    """The release name of ``which`` under ``config``, plus ``ext``
    (``'.pt'`` or ``'.npz'``, which carries the opt-in topology's
    marker)."""
    if which == 'eye_net':
        name = 'eve_eyenet_' + (config.eye_net_rnn_type
                                if config.eye_net_use_rnn else 'static')
    elif which == 'refine_net':
        name = 'eve_refinenet_' + (config.refine_net_rnn_type
                                   if config.refine_net_use_rnn else 'static')
        name += '_oa' if config.refine_net_do_offset_augmentation else ''
        name += '_skip' if config.refine_net_use_skip_connections else ''
    else:
        raise ValueError('Unknown component: %s' % which)
    if ext == '.npz' and config.tpu_native_arch:
        stem = config.tpu_native_stem
        if which == 'eye_net' and stem != 'patchify':
            name += {'patchify8': '_tpu8'}.get(stem, '_tpu_' + stem)
        else:
            name += '_tpu'
    return name + ext


def eligible_filenames(config, which):
    """The file names ``which`` may load from, in order of preference: the
    ``.npz``, then (not under the opt-in topology) the released ``.pt``."""
    exts = ('.npz',) if config.tpu_native_arch else ('.npz', '.pt')
    return [pretrained_filename(config, which, ext) for ext in exts]


def search_dirs(pretrained_dir=None):
    return [d for d in (pretrained_dir, os.environ.get('EVE_PRETRAINED_DIR'))
            if d]


def _load_npz(path, which):
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return convert.submodule_state_dict(which, tree)


def _load_pt(path, which):
    """A released ``.pt``: the state dict (or a module holding one), with a
    leading ``<which>.`` stripped where every key has it."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    prefix = which + '.'
    if sd and all(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()}
    return {k: v.float() for k, v in sd.items()}


def load_pretrained(config, which, pretrained_dir=None):
    """The state dict of submodule ``which`` (CPU float32 tensors, the
    reference's names) from the first file found, or None."""
    names = eligible_filenames(config, which)
    search = search_dirs(pretrained_dir)
    for d in search:
        for name in names:
            path = os.path.join(d, name)
            if os.path.isfile(path):
                logger.info('Loading pretrained %s from %s', which, path)
                return (_load_npz if name.endswith('.npz') else _load_pt)(
                    path, which)
    logger.warning('Pretrained weights %s not found (searched: %s)',
                   ' or '.join(names), search or '<unset>')
    return None


def load_pretrained_into(model, config, which, pretrained_dir=None):
    """Load ``which``'s pretrained weights into ``model.<which>`` (strict);
    returns whether a file was found."""
    sd = load_pretrained(config, which, pretrained_dir)
    if sd is None:
        return False
    module = getattr(model, which)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(
            'Pretrained %s does not match the configured architecture; '
            'mismatched entries: %s' % (which, diff[:10]))
    module.load_state_dict(sd, strict=True)
    return True
