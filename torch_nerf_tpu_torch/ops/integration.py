"""Volume-rendering quadrature (alpha compositing) along rays.

Counterpart of ``torch_nerf_tpu/ops/integration.py:27-55``:
``T_i = exp(-sum_{j<i} sigma_j delta_j)``, ``alpha_i = 1 - exp(-sigma_i
delta_i)``, ``w_i = T_i alpha_i``, ``C = sum_i w_i c_i``.

:func:`composite` with ``use_kernel`` runs :func:`composite_fwd`, the
forward-only kernel ``csrc/composite_fwd.cu``, on f32 CUDA tensors: one
launch where the PyTorch version launches twelve. The frame loop
(``renderer.render_image``, in inference mode) asks for it; training, whose
composite is differentiated, and CPU tensors take the PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from torch_nerf_tpu_torch.ops import build, launch_count
from torch_nerf_tpu_torch.ops.fused_nerf import check_tensor

KERNEL = "composite_fwd"


def composite(
    sigma: torch.Tensor, radiance: torch.Tensor, delta: torch.Tensor, use_kernel: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sigma (N, S)``, ``radiance (N, S, 3)``, ``delta (N, S)`` ->
    ``(rgb (N, 3), weights (N, S))``; by the kernel where ``use_kernel`` and
    all three are f32 CUDA tensors."""
    if use_kernel and sigma.is_cuda and all(t.dtype == torch.float32 for t in (sigma, radiance, delta)):
        return composite_fwd(sigma, radiance, delta)
    sigma_delta = sigma * delta
    accum = torch.cumsum(sigma_delta, dim=-1)
    exclusive = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    transmittance = torch.exp(-exclusive)
    alpha = 1.0 - torch.exp(-sigma_delta)
    weights = transmittance * alpha
    rgb = torch.sum(weights[..., None] * radiance, dim=-2)
    return rgb, weights


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.composite_fwd.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
    lib.composite_fwd.restype = i32
    lib.composite_fwd_error_string.argtypes = [i32]
    lib.composite_fwd_error_string.restype = ctypes.c_char_p
    return lib


def composite_fwd(
    sigma: torch.Tensor, radiance: torch.Tensor, delta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`composite`'s forward by the kernel, on contiguous f32 CUDA
    tensors (or raise); no gradient reaches the inputs."""
    if sigma.dim() != 2:
        raise ValueError(f"sigma must be (N, S), got {tuple(sigma.shape)}")
    rays, samples = sigma.shape
    check_tensor("sigma", sigma, (rays, samples))
    check_tensor("radiance", radiance, (rays, samples, 3))
    check_tensor("delta", delta, (rays, samples))
    rgb = torch.empty((rays, 3), dtype=torch.float32, device=sigma.device)
    weights = torch.empty((rays, samples), dtype=torch.float32, device=sigma.device)
    if rays and samples:
        lib = _library()
        with torch.cuda.device(sigma.device):
            err = lib.composite_fwd(sigma.data_ptr(), radiance.data_ptr(), delta.data_ptr(), rgb.data_ptr(),
                                    weights.data_ptr(), rays, samples,
                                    torch.cuda.current_stream(sigma.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL} launch failed: {lib.composite_fwd_error_string(err).decode()} "
                               f"(cudaError {err})")
        launch_count.count(composite_fwd, (rays, samples))
    return rgb, weights


launch_count.reset(composite_fwd)
