#!/usr/bin/env python3
"""Train the EVE gaze-estimation model.

Usage:
    python -m eve_tpu_torch.cli.train [config.json ...] [--flag value ...] \
        [--device cuda|cpu]

e.g. ``python -m eve_tpu_torch.cli.train configs/refine_net.json
--datasrc-eve /data/eve``, as ``python train.py`` trains eve_tpu. Every
config key is a ``--flag``. The run goes to ``./outputs/EVE<suffix>/
<timestamp>.<config hash>``; SIGTERM saves a checkpoint of the completed
steps and exits 143, and the same command with ``--auto-resume yes``
continues that run. After training, the validation split is tested whole
(the final full test). Reading the dataset needs ``h5py`` and ``ffmpeg``
or ``cv2``.

``main`` parses the command line and builds eve_tpu's dataset specs;
``run`` takes a config, a device and the specs, and does the rest, so any
dataset class with the reader's constructor can be trained on.
"""

import logging

from eve_tpu_torch.data.dataset import EVESequences_train, EVESequences_val
from eve_tpu_torch.train import harness

logger = logging.getLogger(__name__)


def run(config, device, train_specs, validation_specs,
        output_dir_base='./outputs'):
    """Train, run the final full test and exit 0 (``SystemExit``), as
    eve_tpu's ``main`` does after its specs; see ``harness.init_datasets``
    for the spec tuples."""
    train_data, test_data = harness.init_datasets(config, train_specs,
                                                  validation_specs)
    exp = harness.Experiment(config, output_dir_base=output_dir_base,
                             device=device)
    for _, _, images in harness.main_loop_iterator(exp, train_data,
                                                   test_data):
        # Composite images arrive every tensorboard_images_every_n_steps.
        for tag, img in images.items():
            exp.tensorboard.add_image(tag, img)
    harness.do_final_full_test(exp, test_data)
    harness.cleanup_and_quit(exp)


def main(argv=None):
    config, args = harness.script_init_common(argv)
    train_specs = [('eve_train', EVESequences_train, config.datasrc_eve,
                    config.train_stimuli, config.train_cameras)]
    validation_specs = [('eve_val', EVESequences_val, config.datasrc_eve,
                         config.test_stimuli, config.test_cameras)]
    run(config, args.device, train_specs, validation_specs)


if __name__ == '__main__':
    main()
