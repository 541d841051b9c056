"""The gaze networks the port runs, chosen by the ``gaze_net`` key.

- 'eve' (the default): ``models.eve`` (EyeNet, RefineNet), every entry
  point.
- 'gaze360': ``models.gaze360``, on the evaluation path only
  (``infer.model_setup``, ``infer.iterator``, ``cli.eval_codalab``).
  Serving, export and training refuse it with ``refuse``'s
  ``ValueError``; the inference CLI's overlay draws EVE's outputs.

Any other value raises ``ValueError``.
"""

from eve_tpu_torch.models import eve as eve_lib
from eve_tpu_torch.models import gaze360

GAZE_NETS = ('eve', 'gaze360')
# Why an entry point cannot run Gaze360.
WHY = {
    'serving': 'its output at frame t reads frames up to t+3, so serving '
               'needs a 3-frame look-ahead (each session keeping the last '
               '6 frames\' features and answering 3 frames late), which '
               'the engine does not have',
    'export': 'an artifact serves streaming sessions, which need a 3-frame '
              'look-ahead that the export does not have',
    'training': 'training needs the pinball loss and BatchNorm in training '
                'mode (batch statistics), which the port does not have',
}


def gaze_net(config):
    """The configuration's ``gaze_net``, checked."""
    name = config.gaze_net
    if name not in GAZE_NETS:
        raise ValueError('Unknown gaze_net %r (expected one of %s)'
                         % (name, ', '.join(repr(n) for n in GAZE_NETS)))
    return name


def spec_from_config(config):
    """The spec of the configuration's network: an ``eve.EveSpec`` or a
    ``gaze360.GazeSpec``."""
    if gaze_net(config) == 'gaze360':
        return gaze360.GazeSpec.from_config(config)
    return eve_lib.EveSpec.from_config(config)


def build_model(spec, state_dict, device='cuda'):
    """The network of ``spec`` in eval mode on ``device``, holding
    ``state_dict``."""
    if isinstance(spec, gaze360.GazeSpec):
        return gaze360.build_model(spec, state_dict, device)
    return eve_lib.build_model(spec, state_dict, device)


def refuse(entry, spec_or_config):
    """Raise ``ValueError`` when ``entry`` ('serving', 'export' or
    'training') is asked to run a network it cannot: Gaze360, by spec or
    by configuration."""
    if isinstance(spec_or_config, gaze360.GazeSpec) or getattr(
            spec_or_config, 'gaze_net', 'eve') == 'gaze360':
        raise ValueError("gaze_net 'gaze360' has no %s path: %s"
                         % (entry, WHY[entry]))
