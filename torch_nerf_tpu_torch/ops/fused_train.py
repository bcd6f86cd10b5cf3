"""Fused NeRF train pass: o + t d -> PE -> MLP -> composite -> MSE ->
backward -> parameter gradients, as hand-written Hopper kernels
(``csrc/fused_train.cu`` with ``csrc/nerf_mlp_train.cuh``).

Replaces the Pallas TPU kernel ``torch_nerf_tpu/ops/pallas/fused_train.py::
_train_kernel`` (via ``fused_train_pass`` and its ``pl.pallas_call``),
without its padding and relayout machinery. Bound on an H100 SXM: the
forward, the backward ``dh`` chain and dW at 3 x 1,186,816 FLOP per point
and 989 TFLOP/s dense bf16, 2.83 ms for the fine pass of a step (4096 x 192
points) and 0.94 ms for the coarse (4096 x 64). Hopper gets its own fusion
boundary: the Pallas tile holds ~45 MB in VMEM, an SM has 227 KB, so the
kernel stashes the activations and the ``dz``s of the pass in device memory
and computes dW = A^T dZ in a split-K GEMM of its own, every product on
``wgmma`` from shared-memory tiles filled by bulk asynchronous copies (the
header's note gives the design). The composite and its VJP run in f32 (one warp per
ray), not as the TPU's bf16 masked-matmul scans. That is the ``wgmma``
route of ``fused_nerf.train_route``; every other config (bf16 or f32 at
any width up to 1024 and encodings up to 128 wide) takes the tensor-core
general route (``wgmma_general`` and ``f32_wgmma`` on
``csrc/nerf_mlp_tc.cuh``'s column passes, ``fused_tc_train.cu``: the
forward with its stash, the same composite, the chain and the dW GEMM of
``csrc/nerf_dw_tc.cuh``), its bound the same 3 x ``flops_per_point`` at the
card's rate for the compute type (f32: an eighth of bf16's, eight bf16
products a multiply-add).

:func:`fused_train_pass` launches the kernels for CUDA tensors (or raises)
and runs :func:`fused_train_pass_reference`, its plain version written out
in the same steps, for CPU tensors. ``fused_train_pass.launches`` counts
kernel launches (one per pass), ``fused_train_pass.shapes`` them by their
``(N, S)`` (:mod:`launch_count`), ``fused_train_pass.route_launches`` by
route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torch_nerf_tpu_torch import tracing
from torch_nerf_tpu_torch.models.nerf import Params
from torch_nerf_tpu_torch.ops import build, launch_count
from torch_nerf_tpu_torch.ops import fused_nerf as fn

KERNEL = "fused_train"
# the pass on the tensor-core general route (fn.TC_ROUTES)
KERNEL_TC = "fused_tc_train"


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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def phase_floors(cfg: fn.FusedNeRFConfig, points: int) -> dict:
    """Each kernel of one pass over ``points`` points with its operations
    and the device-memory bytes this design must move, each read once: the
    forward's stash writes, the composite's per-point inputs and outputs,
    the chain's dz stash writes and relu-bit reads, the dW GEMM's stash
    reads and partials, the reduce's partials (split as
    ``nerf_mlp_train.cuh``'s ``gemm_splits`` splits them).
    ``{kernel name: {"flops", "bytes"}}``."""
    f = cfg.feat_dim
    p, h = f // 64, max(1, f // 128)
    panels = 2 + 9 * p + h  # 64-column panels of each stash, 128 bytes a point
    flops = fn.flops_per_point(cfg) * points
    # (A panels, dz panels, column tiles) of each layer's dW GEMM
    gemms = [(1, p, 1)] + [(p, p, 1)] * 4 + [(1 + p, p, 1)] + [(p, p, 1)] * 2
    gemms += [(p, p + 1, 2), (p + 1, h, 1), (h, 1, 1)]
    tiles = sum(_ceil(na, 2) * groups for na, _, groups in gemms)
    m64 = _ceil(points, 64) * 64
    splits = _ceil(m64, max(512, _ceil(_ceil(m64 * tiles, 1056), 64) * 64))
    partials = 4 * splits * sum(64 * nd * (64 * na + 1) for na, nd, _ in gemms)
    return {
        "mlp_forward_stash": {"flops": flops, "bytes": points * (128 * panels + 9 * 32 + 16 + 4)},
        "composite": {"flops": 0, "bytes": points * 40},
        "mlp_backward_chain": {"flops": flops, "bytes": points * (128 * panels + 9 * 32 + 32)},
        "dw_gemm": {"flops": flops, "bytes": points * 2 * 128 * panels + partials},
        "dw_reduce": {"flops": 0, "bytes": partials},
    }


def general_stash_bytes(cfg: fn.FusedNeRFConfig, points: int) -> int:
    """Device-memory bytes a general-route train pass moves through its
    stashes over ``points``, each byte once (``nerf_stash.cuh``'s
    row-major stashes in the compute type): the forward writes every
    activation, the chain every dz, the dW GEMM reads both; on the
    tensor-core route (``nerf_mlp_tc.cuh``) the forward also writes the
    relu sign bits (nine 16-byte words a thread of a 64-point tile, 576
    bytes a point) and the chain reads them."""
    f = fn.padded_config(cfg).feat_dim
    size = torch.empty((), dtype=cfg.compute_dtype).element_size()
    pp, dp = -(-cfg.pos_enc_dim // 16) * 16, -(-cfg.dir_enc_dim // 16) * 16
    acts = pp + dp + 9 * f + f // 2
    dzs = 8 * f + (f + 16) + f // 2 + 16
    bits = 2 * 576 if fn.train_route(cfg) in fn.TC_ROUTES else 0
    return points * (2 * (acts + dzs) * size + bits)


def dw_floors(cfg: fn.FusedNeRFConfig, points: int) -> dict:
    """The general route's dW GEMM over ``points``: its operations (2 x
    rows x dz columns a point, every layer, at the stashes' padded widths)
    and the bytes it must move (each stash read once, the f32 grads
    written once): ``{"flops", "bytes"}``."""
    acts, dzs = fn.stash_widths(cfg)
    size = torch.empty((), dtype=cfg.compute_dtype).element_size()
    rows = [sum(acts[s] for s in segs) for segs in fn.DW_SEGMENTS]
    grads = sum(r * n + n for r, n in zip(rows, dzs))
    return {"flops": 2 * points * sum(r * n for r, n in zip(rows, dzs)),
            "bytes": points * (sum(acts.values()) + sum(dzs)) * size + 4 * grads}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_train.cu``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    args = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ptrs] * 3 + [ctypes.c_void_p] * 3
            + [ptrs] * 2 + [ctypes.c_int] * 6)
    lib.fused_train_pass.argtypes = args + [ctypes.c_void_p]
    lib.fused_train_pass.restype = ctypes.c_int
    lib.fused_train_workspace_bytes.argtypes = [ctypes.c_int] * 2
    lib.fused_train_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_train_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_train_smem_bytes.restype = ctypes.c_size_t
    lib.fused_train_error_string.argtypes = [ctypes.c_int]
    lib.fused_train_error_string.restype = ctypes.c_char_p
    return lib


def bind_tc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_tc_train.cu`` (the arguments
    of ``fused_train_pass``, the padded encodings' widths and f32)."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    args = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ptrs] * 3 + [ctypes.c_void_p] * 3
            + [ptrs] * 2 + [ctypes.c_int] * 9)
    lib.fused_train_pass_tc.argtypes = args + [ctypes.c_void_p]
    lib.fused_train_pass_tc.restype = ctypes.c_int
    lib.fused_train_tc_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_train_tc_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_tc_train_error_string.argtypes = [ctypes.c_int]
    lib.fused_tc_train_error_string.restype = ctypes.c_char_p
    lib.fused_tc_train_set_dw_fault.argtypes = [ctypes.c_int]
    lib.fused_tc_train_set_dw_fault.restype = None
    lib.fused_tc_train_dw_launches.argtypes = []
    lib.fused_tc_train_dw_launches.restype = ctypes.c_longlong
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _tc_library() -> ctypes.CDLL:
    return bind_tc(build.load(KERNEL_TC))


def weight_images(params: Params, cfg: fn.FusedNeRFConfig, route: str):
    """``(forward images, biases, chain images)`` of ``route`` for the
    parameters as they are at this call (:func:`fn.training_layout` on
    ``wgmma``, else :func:`fn.tc_layout`), counted as one of ``tracing``'s
    ``layout_builds`` with its ``layout_bytes``."""
    with tracing.span("field.layout"):
        images = (fn.training_layout if route == "wgmma" else fn.tc_layout)(params, cfg)
        tracing.add("layout_builds", 1)
        tracing.add("layout_bytes", sum(x.nbytes for group in images for x in group))
    return images


def _launch(params: Params, ray_o, ray_d, t, delta, rgb_gt, cfg: fn.FusedNeRFConfig, num_real_rays: int):
    """Launch the pass of ``fn.train_route(cfg)`` on the current stream."""
    route = fn.train_route(cfg)
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
    lib = _library() if route == "wgmma" else _tc_library()
    error_string = lib.fused_train_error_string if route == "wgmma" else lib.fused_tc_train_error_string
    dims = fn.kernel_dims(cfg)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=t.device)
    weights = torch.empty((n, s), dtype=torch.float32, device=t.device)
    if route == "wgmma":
        smem = lib.fused_train_smem_bytes(cfg.feat_dim)
        if smem > fn._SMEM_LIMIT:
            raise ValueError(f"feat_dim {cfg.feat_dim} needs {smem} B of shared memory per block")
        fwd, biases, chain = weight_images(params, cfg, route)
        with tracing.span("field.grads"):
            grads = fn.empty_grads(params)
            flat = fn._flat(grads)
            gw, gb = flat[0::2], flat[1::2]
        entry, extra = lib.fused_train_pass, []
        nbytes = lib.fused_train_workspace_bytes(n * s, cfg.feat_dim)
        dims = dims[:6]
    else:
        fwd, biases, chain = weight_images(params, cfg, route)
        with tracing.span("field.grads"):
            gw, gb = fn.empty_general_grads(cfg, t.device)
        f32 = int(cfg.compute_dtype == torch.float32)
        entry, extra = lib.fused_train_pass_tc, [f32]
        nbytes = lib.fused_train_tc_workspace_bytes(n * s, dims[0], dims[6], dims[7], f32)
        dw_before = lib.fused_tc_train_dw_launches()
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=t.device)
    with torch.cuda.device(t.device), tracing.span("field.train_pass"):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = entry(
            ray_o.data_ptr(), ray_d.data_ptr(), t.data_ptr(), delta.data_ptr(), rgb_gt.data_ptr(),
            n, s, num_real_rays, fn.pointers(fwd), fn.pointers(biases), fn.pointers(chain),
            workspace.data_ptr(), rgb.data_ptr(), weights.data_ptr(), fn.pointers(gw), fn.pointers(gb),
            *dims, *extra, stream,
        )
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"fused_train_pass ({route}) launch failed: {msg} (cudaError {err})")
    launch_count.count(fused_train_pass, (n, s))
    fused_train_pass.route_launches[route] += 1
    if route != "wgmma":
        fn.count_dw(route, n * s, lib.fused_tc_train_dw_launches() - dw_before)
        with tracing.span("field.grads"):
            grads = fn.grads_from_general(gw, gb, cfg)
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
    tracing.add("points", t.numel())
    if t.device.type == "cpu":
        with tracing.span("field.train_pass"):
            return fused_train_pass_reference(params, ray_o, ray_d, t, delta, rgb_gt, cfg, num_real_rays)
    return _launch(
        params, ray_o.contiguous(), ray_d.contiguous(), t.contiguous(), delta.contiguous(),
        rgb_gt.contiguous(), cfg, num_real_rays,
    )


def reset_launches() -> None:
    """Set the pass's launch counts, total, by shape and by route, to 0."""
    launch_count.reset(fused_train_pass)


fused_train_pass.route_launches = dict.fromkeys(fn.ROUTES, 0)
reset_launches()
