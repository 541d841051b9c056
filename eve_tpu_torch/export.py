"""AOT export: the EVE inference step as a ``torch.export`` program.

The counterpart of ``eve_tpu/export.py``. The artifact bakes the weights
in, so serving needs only this one file: no model code, no checkpoint
directory and no tracing at serving time. The serving process loads it
(``load_exported``) and calls it; loading imports the heatmap and norm
kernels' custom ops, which the program calls, and nothing of
``eve_tpu_torch.models``.

Artifact layout: a 16-byte header (magic, version, flags; flag bit 0 means
streaming) followed by a ``torch.export.save`` archive. The archive's extra
file ``eve_tpu_torch.json`` holds the metadata: the streaming flag, the
batch signature ``(key, shape, dtype)``, the state tree's shapes and
types, the device type the program was exported for and the torch
version. The program is tied to both: tensors it makes in its graph (the
soft-argmax's grid, for example) are baked for the export device, and the
serialization is torch's own, so ``load_exported`` refuses an artifact of
another device type or torch version. eve_tpu's ``.eve`` artifacts hold
StableHLO, which the port cannot run; they are refused too.

The non-streaming program is ``f(batch) -> predictions``; the streaming
one ``f(batch, states) -> predictions + {'states'}``, carrying the
recurrent state across chunks (``models.eve.init_stream_state``). Both
return the keys of ``serve.DEFAULT_SERVED_OUTPUTS`` that the example batch
can produce; a batch without ground truth gives a predictions-only
artifact. Shapes are static: an artifact serves exactly one signature.
"""

import io
import json
import struct
import zipfile

import torch

from eve_tpu_torch.serve import DEFAULT_SERVED_OUTPUTS as EXPORTED_OUTPUTS
from eve_tpu_torch.utils.tensors import batch_to_tensors, tree_map

MAGIC = b'EVETORCH'
# eve_tpu's artifacts: StableHLO (jax.export) behind the same header.
EVE_TPU_MAGIC = b'EVETPU\x00\x01'
_HEADER = struct.Struct('<8sII')  # magic, version, flags
_VERSION = 1
_FLAG_STREAMING = 1
_METADATA = 'eve_tpu_torch.json'


class _InferenceStep(torch.nn.Module):
    """``EVE.forward`` for serving: predictions only, states if
    streaming."""

    def __init__(self, model, streaming):
        super().__init__()
        self.model = model
        self.streaming = streaming

    def forward(self, batch, states=None):
        out = self.model(batch, output_predictions=True,
                         initial_states=states,
                         return_states=self.streaming)
        keep = {k: out[k] for k in EXPORTED_OUTPUTS if k in out}
        if self.streaming:
            keep['states'] = out['states']
        return keep


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def _signature(batch):
    """``((key, shape, dtype), ...)`` of a tensor batch, sorted by key."""
    return tuple(sorted((k, tuple(v.shape), _dtype_name(v.dtype))
                        for k, v in batch.items()))


def _encode_states(tree):
    """A state tree as JSON: dicts stay dicts, tuples become lists, each
    tensor ``{'shape', 'dtype'}``."""
    if isinstance(tree, dict):
        return {k: _encode_states(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return [_encode_states(v) for v in tree]
    return {'shape': list(tree.shape), 'dtype': _dtype_name(tree.dtype)}


def _decode_states(tree):
    """``_encode_states``'s inverse, with meta tensors (shape and type, no
    data) as leaves."""
    if isinstance(tree, list):
        return tuple(_decode_states(v) for v in tree)
    if set(tree) == {'shape', 'dtype'}:
        return torch.empty(tree['shape'], dtype=getattr(torch, tree['dtype']),
                           device='meta')
    return {k: _decode_states(v) for k, v in tree.items()}


def export_inference(spec, state_dict, example_batch, streaming=False,
                     device='cuda'):
    """Export the inference step for ``example_batch``'s signature.

    Args:
      spec: ``models.eve.EveSpec``; ``state_dict`` (the port's ``EVE``
        names, see ``utils.convert.eve_state_dict``) is baked into the
        artifact.
      example_batch: dict of numpy arrays or tensors fixing the input keys,
        shapes and types. Build it without ground-truth keys to export a
        predictions-only serving artifact.
      streaming: export ``f(batch, states)``, carrying the recurrent state
        across chunks.
      device: the device the program is exported for, and so the only
        device type it serves on.

    Returns the artifact's bytes (write them to a file).
    """
    from eve_tpu_torch.models import eve as eve_lib
    from eve_tpu_torch.models import zoo

    zoo.refuse('export', spec)
    device = torch.device(device)
    model = eve_lib.build_model(spec, state_dict, device)
    batch = batch_to_tensors(example_batch, device)
    args = (batch,)
    if streaming:
        batch_size = next(iter(batch.values())).shape[0]
        args += (eve_lib.init_stream_state(spec, batch_size, device),)
    step = _InferenceStep(model, streaming)
    with torch.no_grad():
        program = torch.export.export(step, args, strict=False)
    metadata = {
        'streaming': bool(streaming),
        'batch': [[k, list(shape), dtype]
                  for k, shape, dtype in _signature(batch)],
        'states': _encode_states(args[1]) if streaming else {},
        'device': device.type,
        'torch': torch.__version__,
    }
    buf = io.BytesIO()
    buf.write(_HEADER.pack(MAGIC, _VERSION,
                           _FLAG_STREAMING if streaming else 0))
    torch.export.save(program, buf,
                      extra_files={_METADATA: json.dumps(metadata)})
    return buf.getvalue()


class ExportedModel:
    """A loaded artifact; call it like the exported step."""

    def __init__(self, program, metadata):
        self._module = program.module()
        self.streaming = metadata['streaming']
        self.device = torch.device(metadata['device'])
        self.input_signature = tuple((k, tuple(shape), dtype)
                                     for k, shape, dtype in metadata['batch'])
        self._states = _decode_states(metadata['states'])

    @property
    def batch_size(self):
        """The exported (and only) batch size."""
        return self.input_signature[0][1][0]

    def zero_state(self, batch_size):
        """Zero recurrent states for ``batch_size`` clips on the
        artifact's device (``{}`` for a non-streaming artifact)."""
        return tree_map(
            lambda leaf: torch.zeros((batch_size,) + tuple(leaf.shape[1:]),
                                     dtype=leaf.dtype, device=self.device),
            self._states)

    def __call__(self, batch, states=None):
        """Outputs of one batch (numpy arrays or tensors) as tensors on
        the artifact's device; a streaming artifact takes and returns
        ``states``."""
        # eve_tpu's assertions, raised so that they also hold under -O.
        if self.streaming and states is None:
            raise AssertionError('streaming artifact needs states')
        if not self.streaming and states is not None:
            raise AssertionError(
                'states passed to a non-streaming artifact (it would '
                'silently reset recurrent state every chunk); export with '
                'streaming=True')
        args = (batch_to_tensors(batch, self.device),)
        if self.streaming:
            args += (tree_map(
                lambda x, leaf: torch.as_tensor(x).to(self.device,
                                                      leaf.dtype),
                states, self._states),)
        with torch.no_grad():
            return self._module(*args)


def _read_metadata(archive):
    with zipfile.ZipFile(io.BytesIO(archive)) as zf:
        names = [n for n in zf.namelist()
                 if n.endswith('/extra/' + _METADATA)]
        if not names:
            raise ValueError('artifact holds no %s metadata' % _METADATA)
        return json.loads(zf.read(names[0]))


def load_exported(data, device='cuda'):
    """Load an artifact written by :func:`export_inference`.

    ``data`` is bytes or a file path; ``device`` the device type it must
    have been exported for. Returns an :class:`ExportedModel`.
    """
    # Registers the eve_tpu_torch:: ops the program calls.
    from eve_tpu_torch.kernels import heatmap_kernels  # noqa: F401
    from eve_tpu_torch.kernels import norm_kernels  # noqa: F401

    if not isinstance(data, bytes):
        with open(data, 'rb') as f:
            data = f.read()
    magic, version, flags = _HEADER.unpack_from(data.ljust(_HEADER.size))
    if magic == EVE_TPU_MAGIC:
        raise ValueError(
            'an eve_tpu artifact: it holds StableHLO (jax.export), which '
            'eve_tpu_torch cannot run; export the checkpoint with '
            'python -m eve_tpu_torch.cli.export_model')
    if magic != MAGIC:
        raise AssertionError('not an eve_tpu_torch export artifact')
    if version != _VERSION:
        raise AssertionError('unsupported artifact version %d' % version)
    archive = data[_HEADER.size:]
    metadata = _read_metadata(archive)
    if metadata['torch'] != torch.__version__:
        raise ValueError(
            'artifact exported under torch %s, this is torch %s: a '
            'torch.export archive is read by the torch that wrote it; '
            're-export' % (metadata['torch'], torch.__version__))
    device = torch.device(device)
    if metadata['device'] != device.type:
        raise ValueError(
            'artifact exported for %s, asked to serve on %s: its program '
            'holds tensors made for the export device; export on the '
            'device that serves' % (metadata['device'], device.type))
    if bool(flags & _FLAG_STREAMING) != metadata['streaming']:
        raise ValueError('artifact header and metadata disagree on '
                         'streaming')
    # cuDNN runs float32 convolutions in TF32 by default; the program is
    # held to float32 results, as the live model is.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return ExportedModel(torch.export.load(io.BytesIO(archive)), metadata)

