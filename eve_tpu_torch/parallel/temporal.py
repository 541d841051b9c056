"""Sequence sharding: the recurrences' T axis over the grid's ``seq`` axis.

The counterpart of ``eve_tpu/parallel/temporal.py``. A ``seq`` rank ``si``
of ``s`` holds frames ``[si*T/s, (si+1)*T/s)`` of its data shard's clips
(``local_frames``). Everything outside the recurrences (the CNN stages,
the geometry, the render, RefineNet's encoder and decoder, the
soft-argmax, the losses) runs on those frames alone; only the cell chain
is sequential across ranks (``scan_shard``): rank ``si`` receives the
carry from ``si - 1``, runs its local loop and hands its carry to
``si + 1``. The carry is small (a 128-float GRU state per eye and clip, a
64x5x8 CLSTM state per clip), so a handoff costs latency, not bandwidth.

The backward pass runs the chain the other way, within the one
``backward()`` of the loss: the handoff's receiving end is an autograd
function whose backward returns the carry's gradient to the previous
rank, and the sending end wraps the local outputs, so its backward (which
runs once their gradients are complete) takes the next rank's carry
gradient in. Each chain (``mesh.CHAINS``: the GRU's, the CLSTM's) hands
off over pair groups of its own, so the two chains' transfers never
share a communicator. Every handoff is a ``broadcast`` over a group of
two ranks, a collective that both NCCL and gloo carry on CUDA tensors.

A rank waits only where its chain needs the carry, as eve_tpu's ``_scan``
substitution does: it computes its features first and blocks at its loop.

``sharded_scan`` is eve_tpu's function on global arrays: every rank
passes the same ``(T, B, ...)`` inputs, runs its block of them and gets
its block of the outputs, with eve_tpu's checks, and the final carry
replicated over the axis (``replicate_from_last``). The forward uses
``scan_shard`` on the rank's own frames, where the final carry is
replicated only when asked for (a streaming forward's states): a
training forward never reads it, and replicating it would make every rank
wait for the last one's loop.

``seq_sum`` is the all-reduce of the losses' per-clip sums and counts
(``losses.masked_mean``): forward a sum over the axis, backward the
identity, since every rank holds the same global loss and back-propagates
through its own frames only; the steps' gradients are then summed over
the axis (``train/step.py``).
"""

import torch

from eve_tpu_torch.parallel import mesh as mesh_lib


def _flatten(tree):
    """``(leaves, rebuild)`` of a pytree of tuples, lists and tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        counts = [len(p[0]) for p in parts]

        def rebuild(leaves):
            out, start = [], 0
            for (_, fn), n in zip(parts, counts):
                out.append(fn(leaves[start:start + n]))
                start += n
            return type(tree)(out)
        return [l for p in parts for l in p[0]], rebuild
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, rebuild = _flatten([tree[k] for k in keys])
        return leaves, lambda l: dict(zip(keys, rebuild(l)))
    raise TypeError('scan leaves must be tensors, got %r' % type(tree))


def _broadcast(tensors, src, group):
    """Rank ``src``'s ``tensors`` on both ranks of a pair group, in place,
    coalesced."""
    mesh_lib.broadcast_tensors_(tensors, src=src, group=group)
    return tensors


class _Receive(torch.autograd.Function):
    """The receiving end of a handoff: forward takes the previous rank's
    carry; backward sends the carry's gradient back to it. ``anchor`` is a
    tensor of this rank's graph that requires a gradient (it gets none):
    it makes autograd call the backward."""

    @staticmethod
    def forward(ctx, group, src, me, anchor, *templates):
        ctx.group, ctx.me = group, me
        ctx.zeros = [torch.zeros_like(t) for t in templates]
        return tuple(_broadcast([torch.empty_like(t) for t in templates],
                                src, group))

    @staticmethod
    def backward(ctx, *grads):
        out = [z if g is None else g.contiguous()
               for g, z in zip(grads, ctx.zeros)]
        ctx.zeros = None
        _broadcast(out, ctx.me, ctx.group)
        return (None, None, None, None) + (None,) * len(grads)


class _Send(torch.autograd.Function):
    """The sending end of a handoff: forward hands the carry to the next
    rank and returns the local outputs unchanged; backward, once their
    gradients are complete, takes in the next rank's carry gradient."""

    @staticmethod
    def forward(ctx, group, me, nxt, n_carry, *tensors):
        carry, ys = tensors[:n_carry], tensors[n_carry:]
        _broadcast([c.detach().clone() for c in carry], me, group)
        ctx.group, ctx.nxt = group, nxt
        ctx.carry = [torch.empty_like(c) for c in carry]
        return tuple(y.clone() for y in ys)

    @staticmethod
    def backward(ctx, *grad_ys):
        grads = _broadcast(ctx.carry, ctx.nxt, ctx.group)
        ctx.carry = None
        return (None, None, None, None) + tuple(grads) + tuple(grad_ys)


class _Tie(torch.autograd.Function):
    """``y`` unchanged, with the received carry as an input whose gradient
    is zero: it puts the receiving end on the loss's path even where the
    carry reaches no output (the CLSTM carries only its state), so its
    backward always answers the previous rank's wait."""

    @staticmethod
    def forward(ctx, y, *carry):
        ctx.n_carry = len(carry)
        return y.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * ctx.n_carry


class _SeqSum(torch.autograd.Function):
    """Sum over a group forward, identity backward (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, group, x):
        out = x.detach().clone()
        mesh_lib.all_reduce_([out], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def seq_sum(x, axis):
    """``x`` summed over the ranks of ``axis`` (a ``mesh.Axis``), with the
    identity as its backward."""
    if axis is None or axis.size == 1:
        return x
    return _SeqSum.apply(axis.group, x)


def frame_range(T, axis):
    """The frames ``[start, stop)`` of rank ``axis.index`` of a sequence
    of ``T`` frames."""
    assert T % axis.size == 0, (
        'sequence length %d not divisible by %d shards' % (T, axis.size))
    per = T // axis.size
    return axis.index * per, (axis.index + 1) * per


def local_frames(batch, axis):
    """This seq rank's frames of a ``(B, T, ...)`` batch: every tensor of
    two or more dims cut on dim 1 (views); anything else as it is."""
    if axis is None or axis.size == 1:
        return batch
    T = batch['left_eye_patch'].shape[1]
    start, stop = frame_range(T, axis)
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 2:
            if v.shape[1] != T:
                raise ValueError('batch entry %s has %d frames, not %d'
                                 % (k, v.shape[1], T))
            v = v[:, start:stop]
        out[k] = v
    return out


def scan_shard(step_fn, carry, xs, axis, chain, params=(), time_dim=0,
               replicate_final=False):
    """This seq rank's part of a scan over the whole sequence.

    ``step_fn(carry, x_t) -> (carry, y_t)`` as ``lax.scan``'s; ``xs`` a
    pytree of this rank's frames with time on ``time_dim``; ``carry`` the
    scan's initial carry (rank 0 starts from it; the others take the
    previous rank's). ``chain`` names the chain's pair groups; ``params``
    are the step's parameters (whether any needs a gradient decides, on
    every rank alike, whether the handoffs join the backward pass).
    Returns ``(final carry, ys)`` with ``ys`` stacked on ``time_dim``; the
    final carry is this rank's own unless ``replicate_final`` (then the
    last rank's, on every rank, without a gradient).
    """
    x_leaves, x_tree = _flatten(xs)
    c_leaves, c_tree = _flatten(carry)
    n, index = axis.size, axis.index
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in list(x_leaves) + list(params))
    anchor = next((t for t in list(x_leaves) + list(params)
                   if t.requires_grad), None) if grad else None
    me = axis.ranks[index]
    received = ()
    if index > 0:
        group, src = axis.pair(chain, index - 1), axis.ranks[index - 1]
        if grad:
            c_leaves = received = list(_Receive.apply(group, src, me, anchor,
                                                      *c_leaves))
        else:
            c_leaves = _broadcast([torch.empty_like(c) for c in c_leaves],
                                  src, group)
    state = c_tree(c_leaves)
    steps = x_leaves[0].shape[time_dim]
    outs = []
    for t in range(steps):
        x_t = x_tree([x.select(time_dim, t) for x in x_leaves])
        state, y = step_fn(state, x_t)
        outs.append(y)
    y_leaves_t = [_flatten(y)[0] for y in outs]
    y_tree = _flatten(outs[0])[1]
    ys = [torch.stack([y[i] for y in y_leaves_t], dim=time_dim)
          for i in range(len(y_leaves_t[0]))]
    final, _ = _flatten(state)
    if received:
        ys[0] = _Tie.apply(ys[0], *received)
    if index < n - 1:
        group, nxt = axis.pair(chain, index), axis.ranks[index + 1]
        if grad:
            ys = list(_Send.apply(group, me, nxt, len(final), *final, *ys))
        else:
            _broadcast([c.detach().clone() for c in final], me, group)
    if replicate_final:
        final = [c.detach().clone() for c in final]
        mesh_lib.broadcast_tensors_(final, src=axis.ranks[-1],
                                    group=axis.group)
    return c_tree(final), y_tree(ys)


def sharded_scan(step_fn, init_carry, xs, grid, axis_name='seq',
                 batch_axis=None, chain=mesh_lib.CHAINS[0], params=()):
    """The distributed equivalent of ``lax.scan(step_fn, init_carry, xs)``
    over ``grid``'s ``axis_name``, on global arrays.

    Every rank passes the same ``xs`` (a pytree of ``(T, ...)`` tensors; T
    must divide by the axis size) and ``init_carry``; with ``batch_axis``
    xs leaves are ``(T, B, ...)`` and carry leaves ``(B, ...)``, and the B
    dim is split over that axis too, with eve_tpu's checks: one uniform
    batch size over every xs leaf of rank >= 2 (dim 1) and every carry
    leaf (dim 0), no rank-0 carry, and a batch that divides by the axis.
    Returns ``(final carry, ys)``: this rank's block of the outputs (its
    frames, and its rows under ``batch_axis``) and the final carry of its
    rows, replicated over ``axis_name``.
    """
    axis = grid.axis(axis_name)
    n = axis.size
    x_leaves, x_tree = _flatten(xs)
    c_leaves, c_tree = _flatten(init_carry)
    T = x_leaves[0].shape[0]
    assert T % n == 0, 'sequence length %d not divisible by %d shards' % (
        T, n)
    nb = grid.count(batch_axis) if batch_axis is not None else 1
    if batch_axis is not None:
        batch_sizes = set()
        for x in x_leaves:
            if x.ndim >= 2:
                batch_sizes.add(x.shape[1])
        for c in c_leaves:
            if c.ndim < 1:
                raise ValueError(
                    'batch_axis=%r requires every carry leaf to have a '
                    'leading batch dim (got a rank-0 carry); pass '
                    'batch_axis=None for batch-free carries' % batch_axis)
            batch_sizes.add(c.shape[0])
        if len(batch_sizes) > 1:
            raise ValueError(
                'batch_axis=%r requires one uniform batch size across all '
                'xs (dim 1) and carry (dim 0) leaves; got %s'
                % (batch_axis, sorted(batch_sizes)))
        if batch_sizes and next(iter(batch_sizes)) % nb != 0:
            raise ValueError(
                'batch size %d not divisible by the %r mesh axis (%d)'
                % (next(iter(batch_sizes)), batch_axis, nb))
    start, stop = frame_range(T, axis)
    x_leaves = [x[start:stop] for x in x_leaves]
    if batch_axis is not None:
        bi = grid.index(batch_axis)
        x_leaves = [x.tensor_split(nb, dim=1)[bi] if x.ndim >= 2 else x
                    for x in x_leaves]
        c_leaves = [c.tensor_split(nb, dim=0)[bi] for c in c_leaves]
    return scan_shard(step_fn, c_tree(c_leaves), x_tree(x_leaves), axis,
                      chain, params, replicate_final=True)

