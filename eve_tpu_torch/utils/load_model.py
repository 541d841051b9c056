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
``utils.convert``. eve_tpu's ``_tpu`` file-name markers of the opt-in
topology are left out: the port does not build that topology yet.
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
    (``'.pt'`` or ``'.npz'``)."""
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
    return name + ext


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
    names = [pretrained_filename(config, which, ext)
             for ext in ('.npz', '.pt')]
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
    getattr(model, which).load_state_dict(sd, strict=True)
    return True
