"""Scalar and image logging for training runs.

The counterpart of ``eve_tpu/train/logging_utils.py``: ``Tensorboard``
keeps an internal ``current_step``, so call sites pass only
``(tag, value)``. It writes TensorBoard events through ``tensorboardX``
where that package is installed, and otherwise eve_tpu's fallback, one JSON
line per scalar in ``<output_dir>/scalars.jsonl`` (images are then dropped,
as in eve_tpu). Unlike eve_tpu's, it is an ordinary object, one per run.

``compose_training_images`` builds eve_tpu's composite training images
from a ``create_images=True`` forward. eve_tpu resizes the gaze-history
maps with ``cv2.resize(INTER_LINEAR)``; here
``torch.nn.functional.interpolate(mode='bilinear', align_corners=False)``
does, without antialiasing, which is what cv2's linear resize computes for
a shrinking resize too.
"""

import json
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def make_grid(images, nrow=8, padding=2, normalize=False, scale_each=False):
    """numpy NHWC (or NHW) image batch -> one HWC grid image."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    n, h, w, c = images.shape
    if normalize:
        def norm(x):
            lo, hi = x.min(), x.max()
            return (x - lo) / (hi - lo + 1e-8)
        images = (np.stack([norm(im) for im in images])
                  if scale_each else norm(images))
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), images.dtype)
    for idx in range(n):
        r, cidx = idx // ncol, idx % ncol
        y = r * (h + padding) + padding
        x = cidx * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


def compose_training_images(outputs, screen_size=(128, 72)):
    """eve_tpu's TensorBoard composites, ``{tag: HWC float image}``.

    With screen content, per clip a vertical stack [screen; screen *
    history; history] for the initial and the refined gaze history (the
    history resized to the screen frame, then clamped to [0, 1], in that
    order), and normalised grids of the ground-truth, initial and final
    heatmaps. ``outputs`` is a ``create_images=True`` forward's dict.
    """
    images = {}
    sw, sh = screen_size
    if 'screen_frame' in outputs:
        screen = _host(outputs['screen_frame'])            # (B, h, w, 3)
        for name, key in (('initial', 'initial_gaze_history'),
                          ('refined', 'refined_gaze_history')):
            if key not in outputs:
                continue
            hist = outputs[key].detach().float()           # (B, H, W)
            hist = torch.nn.functional.interpolate(
                hist[:, None], size=(sh, sw), mode='bilinear',
                align_corners=False)[:, 0]
            hist = _host(hist.clamp(0.0, 1.0))
            hist3 = np.repeat(hist[..., None], 3, axis=-1)
            stacked = np.concatenate([screen, screen * hist3, hist3], axis=1)
            images['train/screen_plus_%s_history' % name] = make_grid(
                stacked, normalize=True, scale_each=True)
    for tag, key in (('train/0_gt_heatmap', 'gt_heatmap'),
                     ('train/1_initial_heatmap', 'initial_heatmap'),
                     ('train/2_final_heatmap', 'final_heatmap')):
        if key in outputs:
            images[tag] = make_grid(_host(outputs[key]), normalize=True,
                                    scale_each=True)
    return images


class Tensorboard:
    """Step-stateful writer of one run directory; with ``output_dir`` None
    (every data-parallel rank but 0) it writes nothing."""

    def __init__(self, output_dir):
        self.output_dir = output_dir
        self.current_step = 0
        self._writer = None
        self._jsonl = None
        if output_dir is None:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._writer = SummaryWriter(output_dir)
        else:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, 'scalars.jsonl'), 'a')

    def update_current_step(self, step):
        self.current_step = step

    def add_scalar(self, tag, value):
        value = float(value)
        if self._writer is not None:
            self._writer.add_scalar(tag, value, self.current_step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {'tag': tag, 'value': value, 'step': self.current_step,
                 'time': time.time()}) + '\n')
            self._jsonl.flush()

    def add_image(self, tag, value):
        """An HWC (or CHW) numpy image in [0, 1]; dropped without a
        ``tensorboardX`` writer."""
        if self._writer is None:
            return
        img = np.asarray(value)
        if img.ndim == 3 and img.shape[0] in (1, 3) and \
                img.shape[-1] not in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        self._writer.add_image(tag, img, self.current_step, dataformats='HWC')

    def add_grid(self, tag, values):
        self.add_image(tag, make_grid(np.asarray(values)))

    def add_graph(self, model):
        """The module tree as text: ``model.txt`` in the run directory (the
        counterpart of eve_tpu's jaxpr dump), mirrored into TensorBoard."""
        if self.output_dir is None:
            return
        text = str(model)
        with open(os.path.join(self.output_dir, 'model.txt'), 'w') as f:
            f.write(text)
        if self._writer is not None:
            self._writer.add_text('model/modules', text[:100000],
                                  self.current_step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
