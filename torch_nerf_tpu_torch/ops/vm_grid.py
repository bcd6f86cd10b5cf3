"""TensoRF's vector-matrix (VM) encode, forward and backward, as hand-written
Hopper kernels (``csrc/vm_grid.cu``), with their plain PyTorch versions.

The encode of TensoRF-VM (Chen et al., ECCV 2022, arXiv:2203.09507, section
4) factorises a density and an appearance grid into three planes and three
lines each: plane m spans the axes (a, b) = (0, 1), (0, 2), (1, 2) of the
normalised point, its line the axis c = 2, 1, 0. Plane m is stored ``(R_b,
R_a, C)`` and line m ``(R_c, C)``, components fastest, and both are sampled
as ``grid_sample(align_corners=True)`` samples them (bilinear and linear,
``u = (x + 1) / 2 * (R - 1)``). For points ``xhat (N, 3)`` the encode gives
``sigma_feat (N,)``, the sum over m and the density components of plane
sample x line sample, and ``app (N, 3 * C_a)``, the appearance products,
plane-major. A point with any ``|xhat| > 1`` gives zeros.

The JAX package has no such field, so the kernels replace no TPU kernel.
:func:`vm_grid_fwd` and :func:`vm_grid_bwd` run the kernels on CUDA tensors
(or raise) and the plain versions on CPU tensors, and count their launches
(:mod:`launch_count`). :func:`vm_encode` is a ``torch.autograd.Function``
whose backward is the backward kernel; gradients reach the twelve factors
only, not the points. The plain versions gather the texels explicitly, in
slices of :data:`CHUNK` points, and the plain backward adds with
``index_add_``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from torch_nerf_tpu_torch import tracing
from torch_nerf_tpu_torch.ops import build, launch_count
from torch_nerf_tpu_torch.ops.fused_nerf import check_tensor

KERNEL = "vm_grid"
PLANE_AXES = ((0, 1), (0, 2), (1, 2))  # (a, b) of plane m, stored (R_b, R_a, C)
LINE_AXES = (2, 1, 0)  # the axis of line m
MAX_DENSITY_COMPONENTS = 32  # the density components lie in the first warp of a chunk
OUT_DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 1 << 14  # points a slice of the plain versions


class Factors(NamedTuple):
    """The twelve factors: three planes and three lines of the density,
    then of the appearance."""

    density_planes: Tuple[torch.Tensor, ...]
    density_lines: Tuple[torch.Tensor, ...]
    app_planes: Tuple[torch.Tensor, ...]
    app_lines: Tuple[torch.Tensor, ...]

    def flat(self) -> List[torch.Tensor]:
        return [*self.density_planes, *self.density_lines, *self.app_planes, *self.app_lines]

    @classmethod
    def of(cls, flat: Sequence[torch.Tensor]) -> "Factors":
        return cls(tuple(flat[0:3]), tuple(flat[3:6]), tuple(flat[6:9]), tuple(flat[9:12]))


def grid_of(f: Factors) -> Tuple[Tuple[int, int, int], int, int]:
    """``((R_x, R_y, R_z), C_d, C_a)`` of the factors; raises where a shape
    does not fit them."""
    res = (f.density_planes[0].shape[1], f.density_planes[0].shape[0], f.density_planes[1].shape[0])
    comps = (f.density_planes[0].shape[-1], f.app_planes[0].shape[-1])
    for planes, lines, c in ((f.density_planes, f.density_lines, comps[0]), (f.app_planes, f.app_lines, comps[1])):
        for m in range(3):
            (a, b), axis = PLANE_AXES[m], LINE_AXES[m]
            if tuple(planes[m].shape) != (res[b], res[a], c) or tuple(lines[m].shape) != (res[axis], c):
                raise ValueError(f"factor shapes do not fit one grid {res} with {comps} components: plane {m} "
                                 f"{tuple(planes[m].shape)}, line {m} {tuple(lines[m].shape)}")
    if min(res) < 2:
        raise ValueError(f"every axis needs 2 texels or more, got {res}")
    return res, comps[0], comps[1]


# ---------------------------------------------------------------------------
# the plain versions


def inside_box(xhat: torch.Tensor) -> torch.Tensor:
    """``(N,)``: every coordinate in [-1, 1]."""
    return (xhat.abs() <= 1.0).all(dim=-1)


def axis_taps(x: torch.Tensor, res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lower texel (int64, clamped to [0, R - 2]) and the upper one's
    weight of coordinates ``x`` on an axis of ``res`` texels."""
    u = (x + 1.0) * 0.5 * float(res - 1)
    i = torch.floor(u).clamp(0, res - 2)
    return i.long(), u - i


def _taps(xhat: torch.Tensor, res) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [axis_taps(xhat[:, axis], res[axis]) for axis in range(3)]


def _samples(planes, lines, taps, res) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each plane's and line's samples ``(P (N, C), v (N, C))`` at the
    points whose :func:`axis_taps` are ``taps``."""
    out = []
    for m in range(3):
        (a, b), c = PLANE_AXES[m], LINE_AXES[m]
        (ia, fa), (ib, fb), (ic, fc) = taps[a], taps[b], taps[c]
        flat = planes[m].reshape(-1, planes[m].shape[-1])
        cell = ib * res[a] + ia
        fa, fb, fc = fa[:, None], fb[:, None], fc[:, None]
        p = ((1.0 - fa) * (1.0 - fb) * flat[cell] + fa * (1.0 - fb) * flat[cell + 1]
             + (1.0 - fa) * fb * flat[cell + res[a]] + fa * fb * flat[cell + res[a] + 1])
        v = (1.0 - fc) * lines[m][ic] + fc * lines[m][ic + 1]
        out.append((p, v))
    return out


def vm_encode_reference(factors: Factors, xhat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel: ``(sigma_feat (N,), app (N,
    3 C_a))`` in f32, differentiable in the factors by autograd."""
    res, _, ca = grid_of(factors)
    n = xhat.shape[0]
    sigma = xhat.new_zeros((n,))
    app = xhat.new_zeros((n, 3 * ca))
    keep = torch.nonzero(inside_box(xhat)).squeeze(1)
    sig_parts, app_parts = [], []
    for a in range(0, keep.shape[0], CHUNK):
        taps = _taps(xhat[keep[a:a + CHUNK]], res)
        dens = _samples(factors.density_planes, factors.density_lines, taps, res)
        sig_parts.append(sum((p * v).sum(dim=-1) for p, v in dens))
        app_parts.append(torch.cat([p * v for p, v in _samples(factors.app_planes, factors.app_lines, taps, res)],
                                   -1))
    if sig_parts:
        sigma = sigma.index_put((keep,), torch.cat(sig_parts))
        app = app.index_put((keep,), torch.cat(app_parts))
    return sigma, app


def vm_backward_reference(g_sigma: torch.Tensor, g_app: torch.Tensor, xhat: torch.Tensor,
                          factors: Factors) -> List[torch.Tensor]:
    """The plain version of the backward kernel: the cotangents of
    ``sigma_feat (N,)`` and ``app (N, 3 C_a)`` -> the twelve factors'
    gradients (in :meth:`Factors.flat` order), added with ``index_add_`` in
    ``g_sigma``'s dtype (f64 for a reference that many points adding into
    one texel must not round)."""
    res, _, ca = grid_of(factors)
    dtype = g_sigma.dtype
    grads = [torch.zeros(t.shape, dtype=dtype, device=t.device) for t in factors.flat()]
    keep = torch.nonzero(inside_box(xhat)).squeeze(1)
    for a in range(0, keep.shape[0], CHUNK):
        idx = keep[a:a + CHUNK]
        taps = _taps(xhat[idx], res)
        gs = g_sigma[idx].to(dtype)[:, None]
        ga = g_app[idx].to(dtype)
        for kind, (planes, lines) in enumerate(((factors.density_planes, factors.density_lines),
                                                 (factors.app_planes, factors.app_lines))):
            for m, (p, v) in enumerate(_samples(planes, lines, taps, res)):
                g = gs if kind == 0 else ga[:, m * ca:(m + 1) * ca]
                p, v = p.to(dtype), v.to(dtype)
                (a_ax, b_ax), c_ax = PLANE_AXES[m], LINE_AXES[m]
                (ia, fa), (ib, fb), (ic, fc) = taps[a_ax], taps[b_ax], taps[c_ax]
                fa, fb, fc = fa.to(dtype)[:, None], fb.to(dtype)[:, None], fc.to(dtype)[:, None]
                cell = ib * res[a_ax] + ia
                dplane = grads[6 * kind + m].view(-1, planes[m].shape[-1])
                gv = g * v
                for off, w in ((0, (1 - fa) * (1 - fb)), (1, fa * (1 - fb)), (res[a_ax], (1 - fa) * fb),
                               (res[a_ax] + 1, fa * fb)):
                    dplane.index_add_(0, cell + off, w * gv)
                dline = grads[6 * kind + 3 + m]
                gp = g * p
                dline.index_add_(0, ic, (1 - fc) * gp)
                dline.index_add_(0, ic + 1, fc * gp)
    return grads


# ---------------------------------------------------------------------------
# the kernels' wrappers


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vm_encode_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.vm_encode_fwd.restype = i32
    lib.vm_encode_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.vm_encode_bwd.restype = i32
    lib.vm_grid_error_string.argtypes = [i32]
    lib.vm_grid_error_string.restype = ctypes.c_char_p
    return lib


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_kernel_inputs(factors: Factors, xhat: torch.Tensor):
    res, cd, ca = grid_of(factors)
    if cd > MAX_DENSITY_COMPONENTS:
        raise ValueError(f"the kernels take C_d <= {MAX_DENSITY_COMPONENTS}, got {cd}")
    check_tensor("xhat", xhat, (xhat.shape[0], 3))
    for t in factors.flat():
        check_tensor("factor", t, tuple(t.shape))
        if t.device != xhat.device:
            raise ValueError("the factors and xhat must be on the same device")
    return (ctypes.c_int * 5)(*res, cd, ca), ca


def _launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.vm_grid_error_string(err).decode()} (cudaError {err})")


def vm_grid_fwd(factors: Factors, xhat: torch.Tensor, out_dtype: torch.dtype = torch.float32):
    """The forward kernel on CUDA tensors (or raise), :func:`vm_encode_reference`
    on CPU tensors: ``(sigma_feat (N,) f32, app (N, 3 C_a) out_dtype)``."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"the products are written in {OUT_DTYPES}, not {out_dtype}")
    if xhat.device.type == "cpu":
        sigma, app = vm_encode_reference(factors, xhat)
        return sigma, app.to(out_dtype)
    dims, ca = _check_kernel_inputs(factors, xhat)
    n = xhat.shape[0]
    sigma = torch.empty((n,), dtype=torch.float32, device=xhat.device)
    app = torch.empty((n, 3 * ca), dtype=out_dtype, device=xhat.device)
    if n:
        _launch(_library(), "vm_encode_fwd", xhat.device, _pointers(factors.flat()), dims, xhat.data_ptr(),
                sigma.data_ptr(), app.data_ptr(), int(out_dtype == torch.bfloat16), n)
        launch_count.count(vm_grid_fwd, n)
    return sigma, app


def vm_grid_bwd(g_sigma: torch.Tensor, g_app: torch.Tensor, xhat: torch.Tensor, factors: Factors) -> List[torch.Tensor]:
    """The backward kernel on CUDA tensors (or raise),
    :func:`vm_backward_reference` on CPU tensors: the cotangents of
    ``sigma_feat (N,)`` f32 and ``app (N, 3 C_a)`` (f32 or bf16) -> the
    twelve factors' f32 gradients in :meth:`Factors.flat` order."""
    if xhat.device.type == "cpu":
        return vm_backward_reference(g_sigma, g_app, xhat, factors)
    dims, ca = _check_kernel_inputs(factors, xhat)
    n = xhat.shape[0]
    check_tensor("g_sigma", g_sigma, (n,))
    if g_app.dtype not in OUT_DTYPES or tuple(g_app.shape) != (n, 3 * ca) or not g_app.is_contiguous():
        raise ValueError(f"g_app must be a contiguous ({n}, {3 * ca}) tensor in {OUT_DTYPES}")
    grads = [torch.zeros_like(t) for t in factors.flat()]
    if n:
        _launch(_library(), "vm_encode_bwd", xhat.device, _pointers(factors.flat()), _pointers(grads), dims,
                xhat.data_ptr(), g_sigma.data_ptr(), g_app.data_ptr(), int(g_app.dtype == torch.bfloat16), n)
        launch_count.count(vm_grid_bwd, n)
    return grads


launch_count.reset(vm_grid_fwd, vm_grid_bwd)


class _VmEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xhat, out_dtype, *flat):
        ctx.save_for_backward(xhat, *flat)
        return vm_grid_fwd(Factors.of(flat), xhat, out_dtype)

    @staticmethod
    def backward(ctx, g_sigma, g_app):
        xhat, *flat = ctx.saved_tensors
        factors = Factors.of(flat)
        ca = factors.app_planes[0].shape[-1]
        if g_sigma is None:
            g_sigma = xhat.new_zeros((xhat.shape[0],))
        if g_app is None:
            g_app = xhat.new_zeros((xhat.shape[0], 3 * ca))
        with tracing.span("field.vm_encode_bwd"):
            grads = vm_grid_bwd(g_sigma.contiguous(), g_app.contiguous(), xhat, factors)
        return (None, None, *grads)


def vm_encode(factors: Factors, xhat: torch.Tensor, out_dtype: torch.dtype = torch.float32):
    """``(sigma_feat (N,) f32, app (N, 3 C_a) out_dtype)`` through the
    forward kernel, and the backward kernel for the factors' gradients
    (their plain versions on CPU tensors)."""
    return _VmEncode.apply(xhat.contiguous(), out_dtype, *factors.flat())
