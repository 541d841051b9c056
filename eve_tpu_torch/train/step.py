"""Train and eval steps and the TrainState.

The counterpart of ``eve_tpu/train/step.py``. eve_tpu fuses forward, loss,
backward, clip and the Adam update into one jitted step; here
``train_step`` runs them in order: ``forward(training=True)``,
``full_loss.backward()``, ``clip_gradients``, ``optimizer.step()``.

With ``gradient_accumulation_steps`` = k each call is one micro-step, as
each call of eve_tpu's step under optax's ``MultiSteps`` is: the gradients
of k micro-batches are summed, then averaged, clipped and applied in one
update. ``TrainState.step`` counts micro-steps; the LR schedule's domain is
optimizer updates, ``step // k``.

``multi_source_train_step`` is eve_tpu's ``make_multi_source_train_step``:
one backward of the sum of each source's ``full_loss``, each source's
scalars prefixed ``<tag>/``.

Every 0-dim output comes back as a device tensor, with a ``nan_flag``;
nothing here waits for the card, so the host syncs only where the caller
reads a value (the harness: at log, checkpoint and test intervals).

Data parallelism (``TrainState.data_parallel``, one process a rank of a
``torch.distributed`` group, of any size): each rank runs the step on its
rows of the global batch, and ``apply_update`` averages the gradients over
the ranks in one coalesced all-reduce before the clip, once an optimizer
update (after the last micro-step of an accumulation). Every loss is a
mean over clips of per-clip masked means, so the average over equal
slices is the global batch's gradient, as eve_tpu's GSPMD step computes
it. The 0-dim outputs are averaged over the ranks as well (one small
all-reduce a step), so every rank logs the global batch's means and
agrees on ``nan_flag``.
"""

import dataclasses
from typing import Callable

import torch

from eve_tpu_torch.parallel import mesh as mesh_lib
from eve_tpu_torch.train import optim as optim_lib


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, and the micro-step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clip_by: str = 'norm'        # 'norm', 'value' or '' (no clipping)
    clip_amount: float = 5.0
    accumulation_steps: int = 1
    step: int = 0
    data_parallel: bool = False  # average over the process group's ranks

    @property
    def updates(self):
        """Optimizer updates taken so far."""
        return self.step // self.accumulation_steps


def create_train_state(config, model, updates_per_epoch):
    """A TrainState for ``model`` under ``config``'s optimizer settings."""
    return TrainState(
        model=model,
        optimizer=optim_lib.build_optimizer(config, model),
        schedule=optim_lib.make_schedule(config, updates_per_epoch),
        clip_by=(config.gradient_clip_by if config.do_gradient_clipping
                 else ''),
        clip_amount=config.gradient_clip_amount,
        accumulation_steps=max(int(config.gradient_accumulation_steps), 1),
        data_parallel=mesh_lib.in_process_group())


def scalar_outputs(out, data_parallel=False):
    """The 0-dim tensors of an output dict, detached, plus ``nan_flag``;
    with ``data_parallel`` each is the mean over the ranks."""
    scalars = {k: v.detach() for k, v in out.items()
               if isinstance(v, torch.Tensor) and v.ndim == 0}
    if data_parallel:
        keys = sorted(scalars)
        stacked = torch.stack([scalars[k].float() for k in keys])
        mesh_lib.all_reduce_mean_([stacked])
        scalars = dict(zip(keys, stacked.unbind()))
    scalars['nan_flag'] = torch.isnan(
        torch.stack(list(scalars.values()))).any()
    return scalars


def accumulate_gradients(model, batch, generator=None):
    """One ``forward(training=True)`` and ``full_loss.backward()``; the
    gradients add to the parameters' ``.grad``. Returns the outputs."""
    out = model(batch, training=True, generator=generator)
    out['full_loss'].backward()
    return out


def train_step(state, batch, generator=None):
    """One micro-step; every ``accumulation_steps``-th one updates.

    ``generator`` (a CPU ``torch.Generator``) draws the kappas of the
    offset augmentation. Returns the 0-dim outputs and ``nan_flag`` as
    device tensors.
    """
    model = state.model
    model.train()
    out = accumulate_gradients(model, batch, generator)
    state.step += 1
    if state.step % state.accumulation_steps == 0:
        apply_update(state)
    return scalar_outputs(out, state.data_parallel)


def accumulate_multi_source_gradients(model, batches, generators=None):
    """One backward of the sum of every source's ``full_loss``.

    ``batches`` is ``{tag: batch}`` and ``generators`` ``{tag: CPU
    torch.Generator}`` (the kappa draws of each source's forward). Returns
    the 0-dim outputs, each source's prefixed ``<tag>/``, and the summed
    ``full_loss``.
    """
    total = 0.0
    scalars = {}
    for tag in sorted(batches):
        out = model(batches[tag], training=True,
                    generator=(generators or {}).get(tag))
        for k, v in out.items():
            if isinstance(v, torch.Tensor) and v.ndim == 0:
                scalars['%s/%s' % (tag, k)] = v
        total = total + out['full_loss']
    total.backward()
    scalars['full_loss'] = total
    return scalars


def multi_source_train_step(state, batches, generators=None):
    """``train_step`` over several sources: ``batches`` is ``{tag: batch}``
    and ``generators`` ``{tag: generator}``. Returns every source's 0-dim
    outputs prefixed ``<tag>/``, the summed ``full_loss`` and a
    ``nan_flag`` over them all."""
    state.model.train()
    out = accumulate_multi_source_gradients(state.model, batches, generators)
    state.step += 1
    if state.step % state.accumulation_steps == 0:
        apply_update(state)
    return scalar_outputs(out, state.data_parallel)


def apply_update(state):
    """One optimizer update from the summed gradients: average them over
    the ranks and the micro-steps, clip, set the LR of update
    ``state.updates - 1``, step Adam and clear the gradients."""
    optimizer = state.optimizer
    grads = optim_lib.trainable_gradients(optimizer)
    if state.data_parallel:
        mesh_lib.all_reduce_mean_(grads)
    if state.accumulation_steps > 1:
        torch._foreach_div_(grads, float(state.accumulation_steps))
    if state.clip_by:
        optim_lib.clip_gradients(grads, state.clip_by, state.clip_amount)
    optim_lib.set_learning_rate(optimizer, state.schedule(state.updates - 1))
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def eval_step(model, batch, create_images=False):
    """``forward(training=False)`` without a graph: the output dict (with
    the image outputs under ``create_images``)."""
    model.eval()
    with torch.inference_mode():
        return model(batch, training=False, create_images=create_images)
