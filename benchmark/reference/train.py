"""Plain training steps for the reference: the loss's gradient, a clip
by the global norm and Adam with coupled weight decay, written out.

- Clip (optax's ``clip_by_global_norm``): every gradient times
  ``amount / norm`` when the global norm reaches ``amount``.
- Adam: ``g + wd * p`` into the moments (coupled decay), bias-corrected
  moments, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.
"""

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def clip_by_global_norm(grads, amount):
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if float(norm) >= amount:
        return {k: g * (amount / norm) for k, g in grads.items()}
    return grads


def run_steps(weights, batches, loss_fn, lr, weight_decay, clip_amount):
    """Train ``weights`` (a dict of float32 tensors, left untouched) on
    ``batches`` in order. Returns ``(losses, first_grads, raw_first_grads,
    final_weights)``: each step's loss, the first step's gradient as Adam
    takes it (clipped, plus the decay term) and before the clip and decay,
    and the weights after the last step."""
    p = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, raw_first = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        leaves = {k: x.requires_grad_(True) for k, x in p.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                raw_first = {k: g.clone() for k, g in grads.items()}
            grads = clip_by_global_norm(grads, clip_amount)
            new = {}
            for k, x in p.items():
                g = grads[k] + weight_decay * x
                if t == 1:
                    first[k] = g.clone()
                m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v2[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                m_hat = m[k] / (1.0 - BETA1 ** t)
                v_hat = v2[k] / (1.0 - BETA2 ** t)
                new[k] = x.detach() - lr * m_hat / (torch.sqrt(v_hat) + EPS)
            p = new
    return losses, first, raw_first, p
