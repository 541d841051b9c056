"""Measuring tools: the counterparts of eve_tpu's ``bench*.py`` scripts.

Each tool is a module with plain functions and a ``main``, run as
``python -m eve_tpu_torch.bench.<tool>``, and prints eve_tpu's JSON lines
on stdout (one, but for ``pipeline``'s one a measurement) with eve_tpu's
metric names and keys, plus ``card`` (the card's name and power limit
from ``nvidia-smi``, or ``"cpu"``):

- ``inference`` (eve_tpu's ``bench.py``): inference frames/s of the
  flagship model at B = 16, T = 30, bf16, uint8 inputs on the device; the
  fused train step's ms (``measure_train_step_ms``); and eve_tpu's
  regression gate (``--check``/``--record``, ``run_check``) on the port's
  own bands, ``bench_bands.json`` beside the module.
- ``chain`` (``bench_chain.py``): device ms a batch, beside eve_tpu's
  chained wall formula, at B = 16 and at B = 1.
- ``serve`` (``bench_serve.py``): sustained closed-loop serving through
  ``ServingEngine``; ``--loopback`` adds the raw-step floors and the
  batcher's own cost.
- ``checkpoint`` (``bench_checkpoint.py``): how long a save blocks the
  training thread.
- ``phases`` (``bench_train.py`` and ``bench_infer_phases.py``): ms, GFLOP
  and operand bytes of each phase of the train step or of the forward.
- ``temporal`` (``bench_temporal.py``): ``parallel.temporal.sharded_scan``
  over n seq ranks (gloo processes the tool starts) against a plain loop.
- ``pipeline`` (``bench_pipeline.py``): the reader, the loader's threads
  and ``DevicePrefetcher`` feeding the EyeNet forward, against the forward
  alone; needs ``h5py``, and ``cv2`` or ``ffmpeg``.

Every tool takes ``--device`` (``cuda`` by default) and raises when it
names a card that is not there; nothing falls back to the CPU. TF32 is
off, as in every entry point of the port.
"""
