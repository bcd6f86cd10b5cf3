"""The photometric loss, its gradients in blocks of rays, and Adam.

The loss of a step is the mean squared error of the coarse colour plus
that of the fine colour against the ground truth, over the rays and the
three channels. The gradients of the whole batch are summed over blocks of
rays, each block's loss scaled to its share of the batch's mean, so that a
fine pass's activations fit. Adam (Kingma and Ba, arXiv:1412.6980):
betas 0.9 and 0.999, eps added outside the square root, bias-corrected,
the learning rate ``init * (end / init)^(t / num_iter)`` at step ``t``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from nerfbench.reference import volume

BETAS = (0.9, 0.999)


def leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(path, tensor)`` of every leaf, keys sorted at every level."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in leaves(tree[key], prefix + (key,))]
    return [(prefix, tree)]


def loss_and_grads(field: Callable, params: Dict, o, d, gt, uniforms, near: float, far: float, hierarchical: bool,
                   block: int) -> Tuple[float, float, List[torch.Tensor]]:
    """``(loss, coarse loss, grads in leaves() order)`` of one batch of
    rays."""
    flat = [t for _, t in leaves(params)]
    total = [torch.zeros_like(t) for t in flat]
    n = o.shape[0]
    loss = coarse_loss = 0.0
    for a in range(0, n, block):
        b = slice(a, min(n, a + block))
        out = volume.render(field, params, o[b], d[b], [u[b] for u in uniforms], near, far, hierarchical)
        coarse = torch.sum((out["coarse"] - gt[b]) ** 2) / (n * 3)
        part = coarse
        if hierarchical:
            part = part + torch.sum((out["fine"] - gt[b]) ** 2) / (n * 3)
        coarse_loss += float(coarse.detach())
        grads = torch.autograd.grad(part, flat, allow_unused=True)
        for acc, g in zip(total, grads):
            if g is not None:
                acc += g
        loss += float(part.detach())
    return loss, coarse_loss, total


class Adam:
    """Adam over a list of f32 tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor], init_lr: float, end_lr: float, num_iter: int, eps: float):
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.init_lr, self.end_lr, self.num_iter, self.eps = init_lr, end_lr, num_iter, eps
        self.t = 0

    def step(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = BETAS
        lr = self.init_lr * (self.end_lr / self.init_lr) ** (self.t / self.num_iter)
        self.t += 1
        c1, c2 = 1.0 - b1**self.t, 1.0 - b2**self.t
        with torch.no_grad():
            for p, m, v, g in zip(self.params, self.m, self.v, grads):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
