"""Faults planted under the timed path, for the tests of the check: each a
context manager that patches one port function at its module attribute.

* ``unchanged``: a train step that returns its state unchanged (Adam not
  applied); a render that returns a frame of zeros, never rendered.
* ``half_batch``: the train step's ray batch cut to its first half, the
  loss's mean taken over the rest; each render chunk's second half of rays
  left black.
* ``altered``: an answer altered where it is produced: every gradient
  of the train step doubled (a loss weight off by two); every rendered
  colour raised by 0.05.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from torch_nerf_tpu_torch import renderer as port_renderer
from torch_nerf_tpu_torch import train as port_train
from torch_nerf_tpu_torch.renderer import RayUniforms

NAMES = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, attr: str, make) -> Iterator[None]:
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def _train_unchanged(original):
    def apply_grads(state, grads):
        state.step += 1

    return apply_grads


def _train_half(original):
    def make(*args, **kwargs):
        inner = original(*args, **kwargs)

        def step(state, o, d, gt, rand, aux=None):
            h = o.shape[0] // 2
            return inner(state, o[:h], d[:h], gt[:h], RayUniforms(*(u[:h] for u in rand)), aux)

        return step

    return make


def _train_altered(original):
    def make(*args, **kwargs):
        inner = original(*args, **kwargs)

        def grad_fn(*a, **k):
            metrics, grads = inner(*a, **k)
            return metrics, [g * 2.0 for g in grads]

        return grad_fn

    return make


def _render_unchanged(original):
    def render_image(field, pc, pf, camera, extrinsic, *args, **kwargs):
        return torch.zeros((camera.img_height, camera.img_width, 3), device=extrinsic.device)

    return render_image


def _render_rows(change):
    def wrap(original):
        def render_rays(*args, **kwargs):
            out = original(*args, **kwargs)
            key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
            out[key] = change(out[key].clone())
            return out

        return render_rays

    return wrap


def _black_half(rgb):
    rgb[rgb.shape[0] // 2:] = 0.0
    return rgb


def _shift(rgb):
    return rgb + 0.05


_TABLE = {
    ("train", "unchanged"): (port_train, "_apply_grads", _train_unchanged),
    ("train", "half_batch"): (port_train, "make_ray_train_step", _train_half),
    ("train", "altered"): (port_train, "make_ray_grad_fn", _train_altered),
    ("render", "unchanged"): (port_renderer, "render_image", _render_unchanged),
    ("render", "half_batch"): (port_renderer, "render_rays", _render_rows(_black_half)),
    ("render", "altered"): (port_renderer, "render_rays", _render_rows(_shift)),
}


def planted(job: str, name: str):
    """The fault ``name`` of a ``job`` ("train" or "render") cell."""
    module, attr, make = _TABLE[(job, name)]
    return _patched(module, attr, make)
