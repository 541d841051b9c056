"""Floating-point operations of the work a cell asks for, counted on the
plain reference (never on the measured program, so the count does not
change with what implements it): ``torch.utils.flop_counter``'s
``FlopCounterMode`` over the reference at the cell's shapes on the
``meta`` device, which computes nothing. It counts the matrix products
and convolutions (forward and, for a training step, backward), the work
that the chip's peak rates are quoted for.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import eve as ref

META = torch.device('meta')


def _weights(cfg, requires_grad=False):
    return {name: torch.empty(shape, device=META,
                              requires_grad=requires_grad)
            for name, shape, _ in ref.param_specs(cfg)}


def _batch(cfg, B, T, eyes, labels):
    def t(*shape, dtype=torch.float32):
        return torch.empty((B, T) + shape, device=META, dtype=dtype)
    batch = {'left_eye_patch': t(eyes, eyes, 3, dtype=torch.uint8),
             'right_eye_patch': t(eyes, eyes, 3, dtype=torch.uint8),
             'left_h': t(2), 'right_h': t(2), 'left_o': t(3),
             'right_o': t(3), 'left_R': t(3, 3), 'right_R': t(3, 3),
             'inv_camera_transformation': t(4, 4),
             'pixels_per_millimeter': t(2)}
    if cfg.get('load_screen_content', False):
        w, h = cfg['screen_size']
        batch['screen_frame'] = t(h, w, 3, dtype=torch.uint8)
    if labels:
        for side in ('left', 'right'):
            batch[side + '_g_tobii'] = t(2)
            batch[side + '_g_tobii_validity'] = t()
            batch[side + '_p'] = t()
            batch[side + '_p_validity'] = t()
    return batch


def forward(cfg, B, T, eyes):
    """Operations of one inference forward over a (B, T) clip batch."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(_weights(cfg), cfg, _batch(cfg, B, T, eyes, False))
    return counter.get_total_flops()


def train_step(cfg, B, T, eyes):
    """Operations of EyeNet's loss and its gradient over a (B, T) clip
    batch (the optimizer's elementwise work is not counted)."""
    w = _weights(cfg, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        loss = ref.eye_net_loss(w, cfg, _batch(cfg, B, T, eyes, True))
        torch.autograd.grad(loss, list(w.values()))
    return counter.get_total_flops()
