"""Optimizer, LR schedule and gradient clipping with eve_tpu's semantics.

The counterpart of ``eve_tpu/train/optim.py``. eve_tpu's optax chain is
clip -> coupled weight decay -> Adam -> LR, per top-level subtree, with one
global clip; here:

- ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``:
  torch's ``weight_decay`` is the coupled form (L2 added to the gradient
  before the moments) that eve_tpu rebuilds with ``add_decayed_weights``
  before ``scale_by_adam``;
- one parameter group per top-level submodule (``eye_net``,
  ``refine_net``), each carrying its LR multiplier; a frozen EyeNet has no
  group at all, so it is outside both the clip norm and Adam;
- ``clip_gradients``: optax's ``clip_by_global_norm`` (``g / norm * max``
  when ``norm >= max``, else ``g`` unchanged) over the trainable
  parameters, or optax's ``clip`` by value. ``torch.nn.utils.
  clip_grad_norm_`` divides by ``norm + 1e-6`` instead, so it is not used;
- ``make_schedule``: eve_tpu's warmup and decay (``none``, ``exponential``,
  ``cyclic``) as a host function of the number of optimizer updates taken,
  with the ``reference_compat_lr_schedule`` quirk;
- ``optax_layout``: which of eve_tpu's optax chains a config builds, so
  the checkpoint writer can lay the Adam state out as eve_tpu's tree.

Under the model axis (``step.shard_model``) the optimizer holds this
rank's slices of the sharded leaves; ``clip_gradients`` is applied before
that, to the full gradients, so it sees eve_tpu's global norm.
"""

import collections
import math

import torch

# The top-level submodules that own parameter groups, with the config key
# of each one's LR multiplier.
SUBMODULES = (('eye_net', 'eye_net_learning_rate_multiplier'),
              ('refine_net', 'refine_net_learning_rate_multiplier'))


def learning_rate(update, *, base_lr, target_lr, updates_per_epoch,
                  num_warmup_epochs, strategy, decay_factor,
                  decay_epoch_interval, compat):
    """The LR of optimizer update ``update`` (0 for the first one).

    Linear warmup from ``base_lr`` to ``target_lr`` over the warmup
    updates, then ``target_lr`` decayed per interval of epochs. With
    ``compat`` the result is multiplied by ``target_lr`` once more: the
    reference installs its absolute-LR function as a LambdaLR factor.
    """
    num_warmup = float(int(updates_per_epoch * num_warmup_epochs))
    if update < num_warmup:
        lr = base_lr + (target_lr - base_lr) * update / num_warmup
    else:
        epoch = (update - num_warmup) / float(updates_per_epoch)
        interval = math.floor(epoch / decay_epoch_interval)
        if strategy == 'exponential':
            lr = target_lr * decay_factor ** interval
        elif strategy == 'cyclic':
            peak_a = target_lr * decay_factor ** interval
            peak_b = peak_a * decay_factor
            half = 0.5 * decay_epoch_interval
            mid = interval * decay_epoch_interval + half
            if epoch < mid:
                lr = -(peak_a - base_lr) / half * (epoch - mid) + base_lr
            else:
                lr = (peak_b - base_lr) / half * (epoch - mid) + base_lr
        elif strategy == 'none':
            lr = target_lr
        else:
            raise ValueError('Unknown lr_decay_strategy %r' % strategy)
    return lr * target_lr if compat else lr


def make_schedule(config, updates_per_epoch):
    """``schedule(update) -> LR`` from a config (see ``learning_rate``)."""
    target_lr = config.learning_rate
    kwargs = dict(
        base_lr=target_lr / config.batch_size, target_lr=target_lr,
        updates_per_epoch=updates_per_epoch,
        num_warmup_epochs=config.num_warmup_epochs,
        strategy=config.lr_decay_strategy,
        decay_factor=config.lr_decay_factor,
        decay_epoch_interval=config.lr_decay_epoch_interval,
        compat=config.reference_compat_lr_schedule)
    learning_rate(0, **kwargs)  # an unknown strategy raises here
    return lambda update: learning_rate(update, **kwargs)


def build_optimizer(config, model):
    """Adam over ``model``'s trainable top-level submodules.

    Each group carries ``name`` and ``lr_multiplier``; ``set_learning_rate``
    sets every group's LR from the schedule before an update.
    """
    if config.gradient_clip_by not in ('norm', 'value'):
        raise ValueError('gradient_clip_by must be norm or value, got %r'
                         % config.gradient_clip_by)
    groups = []
    for name, key in SUBMODULES:
        module = getattr(model, name, None)
        if module is None or (name == 'eye_net' and config.eye_net_frozen):
            continue
        params = [p for p in module.parameters() if p.requires_grad]
        if params:
            groups.append({'params': params, 'name': name,
                           'lr_multiplier': float(getattr(config, key))})
    return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)


# The branches of eve_tpu's ``build_optimizer``: a clip transform at the
# head, coupled weight decay before Adam, the EyeNet frozen, each
# submodule's LR multiplier, and the accumulation steps (``MultiSteps``
# when more than 1).
OptaxLayout = collections.namedtuple(
    'OptaxLayout', 'clip weight_decay frozen multipliers accumulation')


def optax_layout(config):
    """The ``OptaxLayout`` of eve_tpu's optax chain for ``config``, read
    off the config as eve_tpu's ``build_optimizer`` reads it."""
    return OptaxLayout(
        clip=bool(config.do_gradient_clipping) and
        config.gradient_clip_by in ('norm', 'value'),
        weight_decay=bool(config.weight_decay),
        frozen=bool(config.eye_net_frozen),
        multipliers={name: float(getattr(config, key))
                     for name, key in SUBMODULES},
        accumulation=max(int(config.gradient_accumulation_steps), 1))


def set_learning_rate(optimizer, lr):
    """Set each group's LR to ``lr`` times its multiplier."""
    for group in optimizer.param_groups:
        group['lr'] = lr * group['lr_multiplier']


def trainable_gradients(params):
    """The gradients of ``params`` (an optimizer: its parameters).

    A parameter the loss does not reach (the CLSTM gates under
    ``clstm_carry_only``) gets a zero gradient, as every leaf has one in
    eve_tpu: Adam then updates it as optax does, weight decay included.
    """
    if isinstance(params, torch.optim.Optimizer):
        params = [p for g in params.param_groups for p in g['params']]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def clip_gradients(grads, clip_by, amount):
    """Clip ``grads`` in place as optax does; returns the global norm.

    'norm': ``g / norm * amount`` for every gradient when the global norm
    is at least ``amount``, else unchanged (optax's
    ``clip_by_global_norm``). 'value': each element clamped to
    ``[-amount, amount]``. The norm stays on the device: no host sync.
    """
    if not grads:
        return None
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    if clip_by == 'norm':
        keep = norm < amount
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               torch.full_like(norm, amount)))
    elif clip_by == 'value':
        for g in grads:
            g.clamp_(-amount, amount)
    else:
        raise ValueError('clip_by must be norm or value, got %r' % clip_by)
    return norm
