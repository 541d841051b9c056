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

While a torch profiler records, each step is a ``train.step`` span
(``eve_tpu_torch.tracing``) with ``train.forward``, ``train.backward`` and
``train.update`` children, each also timed on the card by a CUDA event
pair.

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

On eve_tpu's grid (``parallel.mesh.make_mesh_nd``, ``TrainState.grid``):

- ``seq``: the forward runs on the rank's frames with the recurrences
  handed between ranks (``forward(seq_group=...)``), and every seq rank
  holds the whole clips' losses; each rank's gradient is its frames' part
  of the whole, so ``apply_update`` sums the gradients over the seq axis
  and averages them over the data axis: one coalesced all-reduce over the
  data x seq group, divided by the data axis's size. The 0-dim outputs are
  averaged over the data axis only.
- ``model`` (``TrainState.shards``, ``shard_model``): each leaf that
  eve_tpu's rule places over the axis keeps its full value in the module,
  so the forward is the one-process forward; the rank's optimizer holds
  its slice of it, with that slice's Adam moments. The model ranks of a
  data coordinate see the same frames, so each holds the full gradient
  after the all-reduce (which never crosses the model axis); the global
  norm of the clip is taken on it, then each rank updates its slices and
  the slices are gathered back into the full values (``ModelShards``).
"""

import dataclasses
from typing import Callable

import torch

from eve_tpu_torch import tracing
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
    grid: object = None          # the rank grid (parallel.mesh.RankGrid)
    shards: object = None        # the model axis (parallel.mesh.ModelShards)
    optax_layout: object = None  # eve_tpu's chain (optim.OptaxLayout)

    @property
    def updates(self):
        """Optimizer updates taken so far."""
        return self.step // self.accumulation_steps

    @property
    def seq(self):
        """The seq axis the forward splits the frames over, or None."""
        if self.grid is None or self.grid.count('seq') == 1:
            return None
        return self.grid.axis('seq')

    @property
    def data_group(self):
        """The group that averages the 0-dim outputs (None: every rank)."""
        return self.grid.axis('data').group if self.grid else None

    def leaf(self, p):
        """The module parameter that optimizer tensor ``p`` trains (a
        sharded leaf's full value for its slice)."""
        return p if self.shards is None else self.shards.full(p)

    def full_parameters(self):
        """The module's parameters that the optimizer trains, in its
        order."""
        return [self.leaf(p) for g in self.optimizer.param_groups
                for p in g['params']]


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
        data_parallel=mesh_lib.in_process_group(), grid=mesh_lib.grid(),
        optax_layout=optim_lib.optax_layout(config))


def shard_model(state, min_size=4096):
    """Put ``state``'s optimizer on the grid's model axis: each trainable
    leaf that eve_tpu's rule places over the axis (``shard_model_tree``)
    becomes this rank's slice of it in the optimizer, its Adam state
    sliced alike. Call it once every rank holds the same full parameters
    and optimizer state (after the broadcast and the resume). Returns the
    names of the sharded leaves (all of eve_tpu's, trained or not)."""
    grid = state.grid
    if grid is None or grid.count('model') == 1:
        return {}
    placed = mesh_lib.shard_model_tree(grid, state.model, min_size=min_size)
    state.shards = mesh_lib.ModelShards(grid.axis('model'), placed)
    state.shards.place(state.optimizer, state.model)
    return placed


def scalar_outputs(out, data_parallel=False, group=None):
    """The 0-dim tensors of an output dict, detached, plus ``nan_flag``;
    with ``data_parallel`` each is the mean over ``group``'s ranks (every
    rank by default; on a grid the data axis, since the seq and model ranks
    of a data coordinate hold the same values)."""
    scalars = {k: v.detach() for k, v in out.items()
               if isinstance(v, torch.Tensor) and v.ndim == 0}
    if data_parallel:
        keys = sorted(scalars)
        stacked = torch.stack([scalars[k].float() for k in keys])
        mesh_lib.all_reduce_mean_([stacked], group)
        scalars = dict(zip(keys, stacked.unbind()))
    scalars['nan_flag'] = torch.isnan(
        torch.stack(list(scalars.values()))).any()
    return scalars


def accumulate_gradients(model, batch, generator=None, seq=None):
    """One ``forward(training=True)`` and ``full_loss.backward()``; the
    gradients add to the parameters' ``.grad``. Returns the outputs.
    ``seq``: the seq axis the batch's frames are split over."""
    with tracing.span('train.forward', device=True):
        out = model(batch, training=True, generator=generator,
                    seq_group=seq)
    with tracing.span('train.backward', device=True):
        out['full_loss'].backward()
    return out


def train_step(state, batch, generator=None):
    """One micro-step; every ``accumulation_steps``-th one updates.

    ``generator`` (a CPU ``torch.Generator``) draws the kappas of the
    offset augmentation. Returns the 0-dim outputs and ``nan_flag`` as
    device tensors.
    """
    with tracing.span('train.step'):
        model = state.model
        model.train()
        out = accumulate_gradients(model, batch, generator, state.seq)
        state.step += 1
        if state.step % state.accumulation_steps == 0:
            with tracing.span('train.update', device=True):
                apply_update(state)
        return scalar_outputs(out, state.data_parallel, state.data_group)


def accumulate_multi_source_gradients(model, batches, generators=None,
                                      seq=None):
    """One backward of the sum of every source's ``full_loss``.

    ``batches`` is ``{tag: batch}`` and ``generators`` ``{tag: CPU
    torch.Generator}`` (the kappa draws of each source's forward). Returns
    the 0-dim outputs, each source's prefixed ``<tag>/``, and the summed
    ``full_loss``.
    """
    total = 0.0
    scalars = {}
    with tracing.span('train.forward', device=True):
        for tag in sorted(batches):
            out = model(batches[tag], training=True,
                        generator=(generators or {}).get(tag), seq_group=seq)
            for k, v in out.items():
                if isinstance(v, torch.Tensor) and v.ndim == 0:
                    scalars['%s/%s' % (tag, k)] = v
            total = total + out['full_loss']
    with tracing.span('train.backward', device=True):
        total.backward()
    scalars['full_loss'] = total
    return scalars


def multi_source_train_step(state, batches, generators=None):
    """``train_step`` over several sources: ``batches`` is ``{tag: batch}``
    and ``generators`` ``{tag: generator}``. Returns every source's 0-dim
    outputs prefixed ``<tag>/``, the summed ``full_loss`` and a
    ``nan_flag`` over them all."""
    with tracing.span('train.step'):
        state.model.train()
        out = accumulate_multi_source_gradients(state.model, batches,
                                                generators, state.seq)
        state.step += 1
        if state.step % state.accumulation_steps == 0:
            with tracing.span('train.update', device=True):
                apply_update(state)
        return scalar_outputs(out, state.data_parallel, state.data_group)


def apply_update(state):
    """One optimizer update from the summed gradients: reduce them over the
    ranks (a mean; on a grid a sum over seq and a mean over data) and
    average them over the micro-steps, clip, set the LR of update
    ``state.updates - 1``, step Adam (on this rank's slices under the model
    axis, then gather them) and clear the gradients."""
    optimizer = state.optimizer
    params = state.full_parameters()
    grads = optim_lib.trainable_gradients(params)
    if state.data_parallel:
        if state.grid is None:
            mesh_lib.all_reduce_mean_(grads)
        else:
            mesh_lib.all_reduce_(grads, state.grid.data_seq,
                                 state.grid.count('data'))
    if state.accumulation_steps > 1:
        torch._foreach_div_(grads, float(state.accumulation_steps))
    if state.clip_by:
        optim_lib.clip_gradients(grads, state.clip_by, state.clip_amount)
    optim_lib.set_learning_rate(optimizer, state.schedule(state.updates - 1))
    if state.shards is None:
        optimizer.step()
    else:
        state.shards.step(optimizer)
    optimizer.zero_grad(set_to_none=True)
    for p in params:
        p.grad = None


def eval_step(model, batch, create_images=False):
    """``forward(training=False)`` without a graph: the output dict (with
    the image outputs under ``create_images``)."""
    model.eval()
    with torch.inference_mode():
        return model(batch, training=False, create_images=create_images)
