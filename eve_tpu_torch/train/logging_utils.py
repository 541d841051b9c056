"""Scalar logging for training runs.

The counterpart of the scalar surface of ``eve_tpu/train/logging_utils.py``:
``Tensorboard`` keeps an internal ``current_step``, so call sites pass only
``(tag, value)``. It writes TensorBoard events through ``tensorboardX``
where that package is installed, and otherwise eve_tpu's fallback, one JSON
line per scalar in ``<output_dir>/scalars.jsonl``. Unlike eve_tpu's, it is
an ordinary object, one per run. Image composition (``create_images``)
comes with the inference slice.
"""

import json
import logging
import os
import time

logger = logging.getLogger(__name__)


class Tensorboard:
    """Step-stateful scalar writer of one run directory."""

    def __init__(self, output_dir):
        self.output_dir = output_dir
        self.current_step = 0
        self._writer = None
        self._jsonl = None
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
        else:
            self._jsonl.write(json.dumps(
                {'tag': tag, 'value': value, 'step': self.current_step,
                 'time': time.time()}) + '\n')
            self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
