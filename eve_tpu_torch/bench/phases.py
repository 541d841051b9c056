"""ms, GFLOP and operand bytes of each phase of the train step or the forward.

The counterpart of eve_tpu's ``bench_train.py`` (``--mode train``) and
``bench_infer_phases.py`` (``--mode infer``):

    python -m eve_tpu_torch.bench.phases --mode train|infer
        [--device cuda|cpu]

``--mode train`` (B = 8, T = 30, bf16; float32 frames, as eve_tpu's tool
makes them) times, each over ``--iters`` calls that cycle 4 device batches:

- ``fwd``: ``forward(training=True)`` to the scalar loss, no graph;
- ``fwd_bwd``: the loss and its backward (no optimizer);
- ``full_step``: backward, the global-norm clip at 5 and an Adam update at
  LR 1e-3 (eve_tpu's tool's chain, every parameter trained);

and ``--remat-sweep`` times ``full_step`` under each ``tpu_remat``:
'none', 'eye', 'refine', 'all'. Prints ``eve_train_step_ms`` (``full_step``
ms) with eve_tpu's keys, plus ``phases`` (and ``remat``) rows and
``card``.

``--mode infer`` (B = 16, T = 30, bf16) times, under
``torch.inference_mode()``:

- ``eye_features``: ResNet-18/IN and ``fc_common`` on the (2·B·T, 128,
  128, 3) stack of both eyes' patches (``EyeNet.features``);
- ``eye_only``: the forward with ``refine_net_enabled=False`` (CNN, GRU,
  heads, geometry, the initial render);
- ``full``: the flagship forward (adds RefineNet, its CLSTM and the
  soft-argmax);

and prints ``eve_inference_phase_breakdown`` (``full`` ms) with the rows.

Each row gives ``ms`` (host clock, the card synchronised at both ends),
``gflop`` and ``gb_op_operands`` of one call, counted in a separate,
untimed call:

- ``gflop`` is ``torch.utils.flop_counter.FlopCounterMode``'s count: the
  matrix products and convolutions, forward and backward (2 a
  multiply-add), and the two heatmap ops by the formulas below. It counts
  no elementwise op, norm, pooling or resize: the numerator of a matmul
  and convolution utilisation.
- ``gb_op_operands`` is the sum, over every ATen op the call dispatches
  (views excepted: they move nothing), of its tensor operands' and
  results' sizes (``OperandBytes``): what an unfused eager run moves, op
  by op, if no operand is found in a cache. It stands where eve_tpu
  reports XLA's "bytes accessed" of a fused program, which has no eager
  counterpart.

The heatmap ops' formulas count the arithmetic the CUDA source
(``csrc/heatmap_kernels.cu``) does: the render 4 operations a pixel (an
add, a multiply, an exp, an add; 5 with a validity mask) plus a subtract
and a square for each row and column of each map; the soft-argmax 29
operations a quad of 4 pixels (4 max, 4 x (subtract, multiply, exp), and
13 for the three running sums).
"""

import argparse
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eve_tpu_torch.bench import common
from eve_tpu_torch.kernels import heatmap_kernels  # noqa: F401 - the ops

REMAT_MODES = ('none', 'eye', 'refine', 'all')


def render_flops(centres_shape, sigmas, multiplier_shape, heatmap_size,
                 actual_screen_size, out_shape=None, **kwargs):
    """Operations of one ``eve_tpu_torch::render_heatmaps`` launch."""
    w, h = heatmap_size
    maps = len(sigmas) * centres_shape[0]
    per_pixel = 4 + (multiplier_shape is not None)
    return maps * (h * w * per_pixel + 2 * (h + w))


def soft_argmax_flops(heatmaps_shape, heatmap_size, actual_screen_size,
                      beta, out_shape=None, **kwargs):
    """Operations of one ``eve_tpu_torch::soft_argmax`` launch."""
    n, h, w = heatmaps_shape
    return n * h * w // 4 * 29


OP_FLOPS = {torch.ops.eve_tpu_torch.render_heatmaps: render_flops,
            torch.ops.eve_tpu_torch.soft_argmax: soft_argmax_flops}


def _bytes(x):
    """Bytes of the tensors in ``x``, a tensor or a (nested) list, tuple or
    dict of them (an op's operands or results)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_bytes(v) for v in x.values())
    return 0


class OperandBytes(TorchDispatchMode):
    """Sums, over every op dispatched under it that is not a view, the
    bytes of its tensor operands and results (``nbytes``)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.nbytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def count_work(fn):
    """``(GFLOP, GB of op operands)`` of one call of ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False, custom_mapping=OP_FLOPS)
    moved = OperandBytes()
    with flops, moved:
        fn()
    return flops.get_total_flops() / 1e9, moved.nbytes / 1e9


def row(name, ms, fn):
    """One table row: ``ms`` and the work of one call of ``fn``."""
    gflop, gb = count_work(fn)
    r = {'phase': name, 'ms': round(ms, 3), 'gflop': gflop,
         'gb_op_operands': round(gb, 4),
         'gb_op_operands_per_s': round(gb / (ms / 1e3), 1)}
    common.note('%-14s %9.3f ms %12.3f GFLOP %10.3f GB op operands'
                % (name, ms, gflop, gb))
    return r


class Trainer:
    """eve_tpu's bench_train phases of one spec: the model (every
    parameter trained) and Adam at LR 1e-3 after a global-norm clip at 5."""

    def __init__(self, spec, device):
        self.model = common.init_flagship(spec, device).train()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=1e-3)

    def loss(self, batch):
        return self.model(batch, training=True,
                          generator=torch.Generator().manual_seed(0)
                          )['full_loss']

    def fwd(self, batch):
        with torch.no_grad():
            return self.loss(batch)

    def fwd_bwd(self, batch):
        loss = self.loss(batch)
        loss.backward()
        self.model.zero_grad(set_to_none=True)
        return loss

    def full_step(self, batch):
        from eve_tpu_torch.train import optim as optim_lib
        loss = self.loss(batch)
        loss.backward()
        optim_lib.clip_gradients(
            [p.grad for p in self.model.parameters() if p.grad is not None],
            'norm', 5.0)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss


def train_phases(batch_size=8, seq=30, iters=10, dtype='bfloat16',
                 refine=True, remat_sweep=False, tpu_native=False,
                 stem='patchify', device='cuda', eyes=common.EYES):
    """``(rows, remat rows)`` of the train step's phases."""
    device = common.resolve_device(device)
    batches = common.make_batches(batch_size, seq, device, eyes,
                                  input_dtype='float32', with_screen=refine)
    args = [(b,) for b in batches]

    def spec(remat):
        return common.flagship_spec(dtype, tpu_native, stem, refine, remat)

    trainer = Trainer(spec('none'), device)
    rows = [row(name, common.wall_ms(fn, args, iters, device),
                lambda fn=fn: fn(batches[0]))
            for name, fn in (('fwd', trainer.fwd),
                             ('fwd_bwd', trainer.fwd_bwd),
                             ('full_step', trainer.full_step))]
    del trainer
    remat_rows = []
    if remat_sweep:
        for mode in REMAT_MODES:
            t = Trainer(spec(mode), device)
            remat_rows.append(row(
                'remat=' + mode,
                common.wall_ms(t.full_step, args, iters, device),
                lambda: t.full_step(batches[0])))
            del t
    return rows, remat_rows


def infer_phases(batch_size=16, seq=30, iters=20, dtype='bfloat16',
                 tpu_native=False, device='cuda', eyes=common.EYES):
    """Rows of the forward's phases: ``eye_features``, ``eye_only`` and
    ``full``."""
    from eve_tpu_torch.models import eve as eve_lib

    device = common.resolve_device(device)
    batches = common.make_batches(batch_size, seq, device, eyes,
                                  input_dtype='float32')
    full_spec = common.flagship_spec(dtype, tpu_native)
    eye_spec = common.flagship_spec(dtype, tpu_native, refine=False)
    full = common.init_flagship(full_spec, device).eval()
    eye = eve_lib.build_model(
        eye_spec, {k: v for k, v in full.state_dict().items()
                   if k.startswith('eye_net.')}, device)
    B, T = batch_size, seq

    def eye_features(batch):
        patches = torch.cat([
            batch[k].to(full_spec.dtype).reshape((B * T,) + batch[k].shape[2:])
            for k in ('left_eye_patch', 'right_eye_patch')])
        head = torch.cat([batch['left_h'].reshape(B * T, 2),
                          batch['right_h'].reshape(B * T, 2)])
        return eye.eye_net.features(
            patches.permute(0, 3, 1, 2).contiguous(), head)

    def eye_only(batch):
        out = eye(batch, output_predictions=True)
        return (out['PoG_px_initial'], out['left_pupil_size'],
                out['right_pupil_size'])

    args = [(b,) for b in batches]
    rows = []
    with torch.inference_mode():
        for name, fn in (('eye_features', eye_features),
                         ('eye_only', eye_only),
                         ('full', lambda b: common.infer(full, b))):
            rows.append(row(name, common.wall_ms(fn, args, iters, device),
                            lambda fn=fn: fn(batches[0])))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--mode', choices=['train', 'infer'], default='train')
    p.add_argument('--batch', type=int, default=None,
                   help='default 8 (train) or 16 (infer)')
    p.add_argument('--seq', type=int, default=30)
    p.add_argument('--iters', type=int, default=None,
                   help='default 10 (train) or 20 (infer)')
    p.add_argument('--eyes', type=int, default=common.EYES,
                   help='eye patch size (eve_tpu fixes 128)')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--no-refine', action='store_true',
                   help='train: the eye-only model')
    p.add_argument('--remat-sweep', action='store_true',
                   help='train: full_step under each tpu_remat')
    p.add_argument('--tpu-native-arch', action='store_true',
                   help='the opt-in topology instead of the reference one')
    p.add_argument('--tpu-native-stem', default='patchify',
                   choices=['patchify', 'patchify8'],
                   help='train: the opt-in topology\'s EyeNet stem')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    args = p.parse_args(argv)
    train = args.mode == 'train'
    B = args.batch or (8 if train else 16)
    iters = args.iters or (10 if train else 20)
    frames = B * args.seq
    if train:
        refine = not args.no_refine
        rows, remat_rows = train_phases(
            B, args.seq, iters, args.dtype, refine, args.remat_sweep,
            args.tpu_native_arch, args.tpu_native_stem, args.device,
            args.eyes)
        ms = {r['phase']: r['ms'] for r in rows}
        common.note('# bwd-only ~ %.2f ms; optimizer+clip ~ %.2f ms'
                    % (ms['fwd_bwd'] - ms['fwd'],
                       ms['full_step'] - ms['fwd_bwd']))
        line = {
            'metric': 'eve_train_step_ms',
            'value': round(ms['full_step'], 2), 'unit': 'ms',
            'frames_per_sec': round(frames / (ms['full_step'] / 1e3), 1),
            'batch': B, 'seq': args.seq, 'dtype': args.dtype,
            'refine': refine, 'tpu_native_arch': args.tpu_native_arch,
            'tpu_native_stem': args.tpu_native_stem,
            'phases': rows,
        }
        if args.remat_sweep:
            line['remat'] = remat_rows
    else:
        rows = infer_phases(B, args.seq, iters, args.dtype,
                            args.tpu_native_arch, args.device, args.eyes)
        line = {
            'metric': 'eve_inference_phase_breakdown',
            'value': rows[-1]['ms'],
            'unit': 'ms/batch',
            'frames': frames,
            'tpu_native_arch': args.tpu_native_arch,
            'phases': rows,
        }
    common.emit(line, torch.device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
