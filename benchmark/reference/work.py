"""Floating-point operations of the face cell's work, counted as
``reference.flops`` counts: ``FlopCounterMode`` over the plain reference
at the cell's shapes on the ``meta`` device (matrix products and
convolutions).

The count is the work, not a literal form: Gaze360's reference runs the
backbone 7 times a frame, once in each window that holds it, where the
work is the backbone once a frame and the LSTM once a window
(``gaze360_backbone`` + ``gaze360_temporal``).
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import gaze360
from benchmark.reference.flops import META

GAZE360 = {'gaze_net': 'gaze360'}


def _gaze360_weights():
    return {name: torch.empty(shape, device=META)
            for name, shape, _ in gaze360.param_specs(GAZE360)}


def gaze360_backbone(cfg, frames, px):
    """The backbone's operations over ``frames`` (px x px) faces."""
    x = torch.empty((frames, 3, px, px), device=META)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        gaze360.backbone(_gaze360_weights(), x)
    return counter.get_total_flops()


def gaze360_temporal(cfg, windows):
    """The LSTM's and the head's operations over ``windows`` windows."""
    x = torch.empty((windows, gaze360.WINDOW, gaze360.FEATURES), device=META)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        gaze360.temporal(_gaze360_weights(), x)
    return counter.get_total_flops()

