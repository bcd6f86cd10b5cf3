"""Fused NeRF train pass: o + t d -> PE -> MLP -> composite -> MSE ->
backward -> parameter gradients, as hand-written Hopper kernels
(``csrc/fused_train.cu`` with ``csrc/nerf_mlp.cuh``).

Replaces the Pallas TPU kernel ``torch_nerf_tpu/ops/pallas/fused_train.py::
_train_kernel`` (via ``fused_train_pass`` and its ``pl.pallas_call``),
without its padding and relayout machinery. Bound on an H100 SXM: the
forward, the backward ``dh`` chain and dW at 3 x 1,186,816 FLOP per point
and 989 TFLOP/s dense bf16, 2.83 ms for the fine pass of a step (4096 x 192
points) and 0.94 ms for the coarse (4096 x 64). Hopper gets its own fusion
boundary: the Pallas tile holds ~45 MB in VMEM, an SM has 227 KB, so the
kernel stashes the activations and the ``dz``s of the pass in device memory
and computes dW = A^T dZ in a split-K GEMM of its own (the source's header
note gives the design). The composite and its VJP run in f32 (one warp per
ray), not as the TPU's bf16 masked-matmul scans.

:func:`fused_train_pass` launches the kernels for CUDA tensors (or raises)
and runs :func:`fused_train_pass_reference`, its plain version written out
in the same steps, for CPU tensors. ``fused_train_pass.launches`` counts
kernel launches (one per pass).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torch_nerf_tpu_torch.models.nerf import Params
from torch_nerf_tpu_torch.ops import build
from torch_nerf_tpu_torch.ops import fused_nerf as fn

KERNEL = "fused_train"


def composite_and_vjp(
    sigma: torch.Tensor,
    rgb: torch.Tensor,
    delta: torch.Tensor,
    rgb_gt: torch.Tensor,
    num_real_rays: int,
    first_ray: int = 0,
):
    """Emission-absorption composite of ``sigma (N, S)``, ``rgb (N, S, 3)``
    and the VJP of the per-ray MSE through it (``fused_train.py:45-55``):
    ``(C (N, 3), w (N, S), g_sigma (N, S), g_rgb (N, S, 3))`` in f32, the
    loss weight 2 / (3 N_real) on the first ``num_real_rays`` rays, 0 after.
    ``first_ray`` is the index of row 0 in the whole batch, for a caller
    that runs the batch in ray slices."""
    s = sigma * delta
    accum = torch.cumsum(s, dim=-1)
    trans = torch.exp(-torch.cat([torch.zeros_like(accum[:, :1]), accum[:, :-1]], dim=-1))
    att = torch.exp(-s)
    w = trans * (1.0 - att)
    c = torch.sum(w[..., None] * rgb, dim=-2)
    real = torch.arange(first_ray, first_ray + sigma.shape[0], device=sigma.device) < num_real_rays
    lossw = torch.where(real, 2.0 / (num_real_rays * 3.0), 0.0).to(torch.float32)
    g = (c - rgb_gt) * lossw[:, None]
    g_rgb = w[..., None] * g[:, None, :]
    gw = torch.sum(rgb * g[:, None, :], dim=-1)
    # strict suffix sum of gw * w: sum over k > i
    incl = torch.flip(torch.cumsum(torch.flip(gw * w, [-1]), dim=-1), [-1])
    sfx = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=-1)
    g_sigma = delta * (gw * trans * att - sfx)
    return c, w, g_sigma, g_rgb


def fused_train_pass_reference(
    params: Params,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    t: torch.Tensor,
    delta: torch.Tensor,
    rgb_gt: torch.Tensor,
    cfg: fn.FusedNeRFConfig,
    num_real_rays: int,
    first_ray: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """The plain version of the pass: the points, the forward, the
    composite and its VJP, and the MLP backward without input grads.
    ``first_ray`` as in :func:`composite_and_vjp`: the grads of ray slices
    of one batch sum to the batch's."""
    n, s = t.shape
    with torch.no_grad():
        pts = (ray_o[:, None, :] + t[..., None] * ray_d[:, None, :]).reshape(-1, 3)
        dirs = ray_d[:, None, :].expand(n, s, 3).reshape(-1, 3)
        acts = fn.forward_activations(params, pts, dirs, cfg)
        c, w, g_sigma, g_rgb = composite_and_vjp(
            acts["sigma"].reshape(n, s), acts["rgb"].reshape(n, s, 3), delta, rgb_gt, num_real_rays,
            first_ray,
        )
        grads, _, _ = fn.backward_from_activations(
            params, acts, g_sigma.reshape(-1), g_rgb.reshape(-1, 3), cfg, input_grads=False
        )
    return c, w, grads


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_train.cu``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.fused_train_pass.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ptrs] * 3 + [ctypes.c_void_p] * 3
        + [ptrs] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.fused_train_pass.restype = ctypes.c_int
    lib.fused_train_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_train_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_train_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_train_smem_bytes.restype = ctypes.c_size_t
    lib.fused_train_error_string.argtypes = [ctypes.c_int]
    lib.fused_train_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _launch(params: Params, ray_o, ray_d, t, delta, rgb_gt, cfg: fn.FusedNeRFConfig, num_real_rays: int):
    """Launch the pass on the current stream."""
    fn.check_config(cfg)
    n, s = t.shape
    for name, x, shape in (("ray_o", ray_o, (n, 3)), ("ray_d", ray_d, (n, 3)), ("t", t, (n, s)),
                           ("delta", delta, (n, s)), ("rgb_gt", rgb_gt, (n, 3))):
        fn.check_tensor(name, x, shape)
    if params["fc_in"]["w"].device != t.device:
        raise ValueError("the network's parameters must be on the same CUDA device as the rays")
    if not 0 < num_real_rays <= n:
        raise ValueError(f"num_real_rays must be in 1..{n}, got {num_real_rays}")
    if n * s >= 2**31:
        raise ValueError(f"{n} x {s} points exceed the kernel's 32-bit point index")
    lib = _library()
    pe_pad, de_pad = fn._round16(cfg.pos_enc_dim), fn._round16(cfg.dir_enc_dim)
    smem = lib.fused_train_smem_bytes(cfg.feat_dim, pe_pad, de_pad)
    if smem > fn._SMEM_LIMIT:
        raise ValueError(f"feat_dim {cfg.feat_dim} needs {smem} B of shared memory per block")
    frags, biases, frags_t = fn.training_layout(params, cfg)
    grads = fn.empty_grads(params)
    flat = fn._flat(grads)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=t.device)
    weights = torch.empty((n, s), dtype=torch.float32, device=t.device)
    workspace = torch.empty(
        lib.fused_train_workspace_bytes(n * s, cfg.feat_dim, pe_pad, de_pad),
        dtype=torch.uint8, device=t.device,
    )
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.fused_train_pass(
            ray_o.data_ptr(), ray_d.data_ptr(), t.data_ptr(), delta.data_ptr(), rgb_gt.data_ptr(),
            n, s, num_real_rays, fn.pointers(frags), fn.pointers(biases), fn.pointers(frags_t),
            workspace.data_ptr(), rgb.data_ptr(), weights.data_ptr(),
            fn.pointers(flat[0::2]), fn.pointers(flat[1::2]),
            cfg.feat_dim, cfg.coord_encode_level, cfg.dir_encode_level, int(cfg.include_input),
            cfg.pos_enc_dim, cfg.dir_enc_dim, pe_pad, de_pad, stream,
        )
    if err != 0:
        msg = lib.fused_train_error_string(err).decode()
        raise RuntimeError(f"fused_train_pass launch failed: {msg} (cudaError {err})")
    fused_train_pass.launches += 1
    return rgb, weights, grads


def fused_train_pass(
    params: Params,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    t: torch.Tensor,
    delta: torch.Tensor,
    rgb_gt: torch.Tensor,
    cfg: fn.FusedNeRFConfig,
    num_real_rays: int,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """One render pass with its loss gradient: ``(rgb (N, 3), weights (N,
    S), grads)``, ``grads`` the gradient of ``mean((rgb - rgb_gt)**2)`` over
    the first ``num_real_rays`` rays with respect to ``params`` (public
    layout, f32). ``t``/``delta`` ``(N, S)`` are the sample depths and
    quadrature intervals of each ray."""
    if t.device.type == "cpu":
        return fused_train_pass_reference(params, ray_o, ray_d, t, delta, rgb_gt, cfg, num_real_rays)
    return _launch(
        params, ray_o.contiguous(), ray_d.contiguous(), t.contiguous(), delta.contiguous(),
        rgb_gt.contiguous(), cfg, num_real_rays,
    )


fused_train_pass.launches = 0
