"""The collectives of the parallel paths, written as autograd functions.

Counterpart of what GSPMD inserts for the JAX package's ``NamedSharding``
annotations and of the ``pmean`` of its ``shard_map`` step
(``torch_nerf_tpu/parallel/mesh.py``), on ``torch.distributed``:

* :func:`copy_to_group`: the identity forward, an ``all_reduce`` of the
  cotangent backward (the replicated input of a column-parallel layer);
* :func:`reduce_from_group`: an ``all_reduce`` forward, the identity
  backward (the partial sums of a row-parallel layer);
* :func:`gather_from_group`: an ``all_gather`` along the features forward,
  the rank's own slice of the cotangent backward;
* :func:`data_mean`: the mean of metrics and gradients over a data group,
  one flattened ``all_reduce``.

``torch.distributed.nn.functional``'s ``all_reduce`` and ``all_gather`` are
not used: their backward sums the cotangents over the ranks, and where what
follows is replicated every rank holds the same cotangent, so that sum
would multiply the tensor-parallel gradients by the group's size.

A group of the ``gloo`` backend is handed host tensors: a CUDA tensor is
copied to the host, reduced there and copied back, so the ranks that share
one card can talk through gloo whatever its CUDA support.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor on ``t``'s device."""
    if group_size(group) == 1:
        return t.clone()
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in the
    order of the ranks within the group."""
    size = group_size(group)
    if size == 1:
        return t.detach().clone()
    src = t.detach().cpu() if _staged(t, group) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank ``src``'s."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.detach().cpu()
        dist.broadcast(host, src=src, group=group)
        with torch.no_grad():
            t.copy_(host)
        return t
    dist.broadcast(t.detach(), src=src, group=group)
    return t


def _own_slice(t: torch.Tensor, group) -> torch.Tensor:
    width = t.shape[-1] // group_size(group)
    return t.narrow(-1, dist.get_rank(group) * width, width).contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group)


def data_mean(metrics: Dict[str, torch.Tensor], grads: List[torch.Tensor], group
              ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The mean over ``group`` of each scalar metric and each gradient, by
    one ``all_reduce`` of them flattened into one f32 buffer."""
    size = group_size(group)
    if size == 1:
        return metrics, grads
    keys = sorted(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [metrics[k].reshape(1).float() for k in keys])
    flat = all_reduce(flat, group) / size
    out_grads, offset = [], 0
    for g in grads:
        out_grads.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    out_metrics = {k: flat[offset + i].to(metrics[k].dtype) for i, k in enumerate(keys)}
    return out_metrics, out_grads
