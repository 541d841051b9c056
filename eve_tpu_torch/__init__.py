"""eve_tpu_torch: the PyTorch and CUDA port of eve_tpu, for NVIDIA Hopper.

A second package beside ``eve_tpu``, which stays the reference. The module
tree mirrors ``eve_tpu``'s, so each counterpart sits at the same relative
path:

- ``eve_tpu_torch.config.Config``: the model, heatmap and serving keys
- ``eve_tpu_torch.models.eve``: ``EveSpec``, ``EVE``, ``init_stream_state``
- ``eve_tpu_torch.kernels``: the CUDA heatmap kernels, their plain
  versions and launch counts
- ``eve_tpu_torch.serve``: the micro-batching engine and HTTP front end
- ``eve_tpu_torch.cli.serve``: ``python -m eve_tpu_torch.cli.serve``
- ``eve_tpu_torch.tracing``: spans at the layer boundaries, recorded
  while a torch profiler records

The port imports ``torch`` and never ``jax`` or ``eve_tpu``. Entry points
run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``.
"""

__version__ = '0.1.0'
