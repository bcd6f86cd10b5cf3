"""The plain reference of every configuration: plain PyTorch in float32.

Nothing here imports ``jax``, the JAX package or the port: the reference
works out from the benchmark's own inputs (weights, images, poses, uniform
draws) whatever the port derives from them. Matrix products run with TF32
off (:func:`strict_f32`). Each model module (:mod:`.nerf`, :mod:`.ngp`)
gives its parameter layout, its field and its multiply-adds a point;
:mod:`.volume` holds rays, sampling and compositing, :mod:`.optim` the loss,
its gradients in blocks of rays and Adam, and :mod:`.lowp` the rounding of
the control, the reference computed one precision below the configuration.
"""

from __future__ import annotations

import importlib

import torch


def strict_f32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model(name: str):
    """The reference module a configuration names (``"reference"``)."""
    return importlib.import_module(f"{__name__}.{name}")
