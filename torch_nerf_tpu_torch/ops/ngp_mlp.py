"""The Instant-NGP field's forward after the hash encode as one hand-written
Hopper kernel: SH of the view direction, both small MLPs and their
activations, from the ``(N, L*F)`` hash features to ``(sigma, rgb)``.

``csrc/ngp_mlp_fwd.cu`` replaces no TPU kernel: the JAX package leaves the
two MLPs to XLA, and the port's tree route (``models/instant_ngp.py::
instant_ngp_apply``) runs them as cuBLAS GEMMs with PyTorch's elementwise
kernels and concatenations between them, every 64-wide activation through
device memory. The kernel keeps every activation in registers and reads
each point's features once; its source's header note gives its bound
(bytes, ~45 us a 1,048,576-point render chunk on an H100) and design.

It takes the configs :func:`takes` names: bf16 products, SH degree 4,
hidden widths 64 and an input of 32 (``hash``, ``bricked``, ``packed`` at
L 16 x F 2) or 64 (``packed_dual``) features. :func:`prepare` turns a
field's public tree into :class:`NgpWeights`, a forward-only handle built
once a frame: the tables (the encode still reads them), both MLPs' public
trees, and :func:`weight_image`, the bf16 image of both MLPs the kernel
copies into shared memory as it is. :func:`ngp_mlp_fwd` launches the
kernel on CUDA tensors (or raises) and runs :func:`ngp_mlp_reference`, its
plain version, on CPU tensors; ``ngp_mlp_fwd.launches`` counts the launches
and ``.shapes`` them by point count (:mod:`launch_count`).

The plain version computes SH once a ray and gathers it to the points (the
same f32 arithmetic as ``encoders.sh_encoding`` on every point), then runs
``instant_ngp.small_mlp_apply`` on both MLPs at ``compute_dtype`` bf16, as
the tree route does: ``2 ** x`` of the density output's first column in
f32, the colour output's sigmoid (``exp`` when HDR) in f32. On the CPU it
equals the tree route bit for bit; the kernel differs from it only in the
order of each product's f32 sums. At ``compute_dtype`` f32 it is the
yardstick both bf16 versions are held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, Tuple

import torch

from torch_nerf_tpu_torch import encoders, tracing
from torch_nerf_tpu_torch.models import instant_ngp
from torch_nerf_tpu_torch.ops import build, launch_count
from torch_nerf_tpu_torch.ops.fused_nerf import check_tensor, panel_image

KERNEL = "ngp_mlp_fwd"
HIDDEN = 64
SH_DEGREE = 4
IN_WIDTHS = (32, 64)
# the layers in the image's order, each with its rows in the image (its
# outputs, padded to a multiple of 8) and whether relu follows it
LAYERS = (("density_mlp", "fc_in", 64, False), ("density_mlp", "fc_hidden_0", 64, True),
          ("density_mlp", "fc_out", 16, False), ("color_mlp", "fc_in", 64, False),
          ("color_mlp", "fc_hidden_0", 64, True), ("color_mlp", "fc_hidden_1", 64, True),
          ("color_mlp", "fc_out", 8, False))
IMAGE_BYTES = sum(rows * 128 + 2 * rows for _, _, rows, _ in LAYERS)


def takes(in_dim: int, density_feat_dim: int, color_feat_dim: int, sh_degree: int,
          compute_dtype: torch.dtype) -> bool:
    """Whether the kernel computes this config: bf16, SH degree 4, both
    hidden widths 64, an input of 32 or 64 features."""
    return (compute_dtype == torch.bfloat16 and sh_degree == SH_DEGREE and density_feat_dim == HIDDEN
            and color_feat_dim == HIDDEN and in_dim in IN_WIDTHS)


@dataclasses.dataclass(frozen=True)
class NgpWeights:
    """A forward-only handle of one Instant-NGP network: its tables, both
    MLPs' public trees (detached) and their :func:`weight_image`."""

    tables: torch.Tensor
    density_mlp: Dict[str, Any]
    color_mlp: Dict[str, Any]
    image: torch.Tensor

    @property
    def in_dim(self) -> int:
        return self.density_mlp["fc_in"]["w"].shape[0]


def weight_image(params) -> torch.Tensor:
    """The flat bf16 image ``csrc/ngp_mlp_fwd.cu`` reads of a tree holding
    ``density_mlp`` and ``color_mlp``: each layer's bf16 W^T (rows its
    outputs, zero-padded to its rows in :data:`LAYERS`; 64 columns its
    inputs, zero past K) as one 128-byte swizzled panel
    (``fused_nerf.panel_image``), the layers in order, then their bf16
    biases in order, each zero-padded to its rows."""
    panels, biases = [], []
    for mlp, name, rows, _ in LAYERS:
        w, b = (params[mlp][name][k].detach().to(torch.bfloat16) for k in ("w", "b"))
        k, n = w.shape
        panels.append(panel_image(torch.nn.functional.pad(w.t(), (0, HIDDEN - k, 0, rows - n))))
        biases.append(torch.nn.functional.pad(b, (0, rows - n)))
    return torch.cat(panels + biases)


def prepare(params) -> NgpWeights:
    """A public Instant-NGP tree -> :class:`NgpWeights` (idempotent), on its
    device, detached. Counts one of ``tracing``'s ``layout_builds`` and its
    ``layout_bytes``."""
    if isinstance(params, NgpWeights):
        return params
    image = weight_image(params)
    tracing.add("layout_builds", 1)
    tracing.add("layout_bytes", image.nbytes)

    def detached(mlp):
        return {name: {k: t.detach() for k, t in layer.items()} for name, layer in params[mlp].items()}

    return NgpWeights(tables=params["tables"].detach(), density_mlp=detached("density_mlp"),
                      color_mlp=detached("color_mlp"), image=image)


def ngp_mlp_reference(w: NgpWeights, feats: torch.Tensor, ray_dirs: torch.Tensor, samples: int,
                      is_hdr: bool = False, compute_dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(sigma (N,), rgb (N, 3))`` f32 of ``feats (N,
    in_dim)`` and ``ray_dirs (N / samples, 3)``, point ``i`` on ray ``i //
    samples``, with products in ``compute_dtype``."""
    sh = encoders.sh_encoding(ray_dirs, SH_DEGREE)
    sh = sh[:, None, :].expand(-1, samples, -1).reshape(-1, sh.shape[-1])
    density_out = instant_ngp.small_mlp_apply(w.density_mlp, feats, compute_dtype)
    sigma = torch.exp2(density_out[..., 0])
    color_out = instant_ngp.small_mlp_apply(w.color_mlp, torch.cat([density_out, sh], dim=-1), compute_dtype)
    rgb = torch.exp(color_out) if is_hdr else torch.sigmoid(color_out)
    return sigma, rgb


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ngp_mlp_fwd.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ngp_mlp_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.ngp_mlp_fwd.restype = i32
    lib.ngp_mlp_fwd_image_bytes.argtypes = []
    lib.ngp_mlp_fwd_image_bytes.restype = i32
    lib.ngp_mlp_fwd_error_string.argtypes = [i32]
    lib.ngp_mlp_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    lib = bind(build.load(KERNEL))
    if lib.ngp_mlp_fwd_image_bytes() != IMAGE_BYTES:
        raise RuntimeError(f"{KERNEL} reads a {lib.ngp_mlp_fwd_image_bytes()}-byte image, not {IMAGE_BYTES}")
    return lib


def ngp_mlp_fwd(w: NgpWeights, feats: torch.Tensor, ray_dirs: torch.Tensor, samples: int,
                is_hdr: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors (or raise), :func:`ngp_mlp_reference` on
    CPU tensors: ``feats (N, in_dim)`` f32, ``ray_dirs (N / samples, 3)``
    f32 -> ``(sigma (N,), rgb (N, 3))`` f32."""
    if feats.device.type == "cpu":
        return ngp_mlp_reference(w, feats, ray_dirs, samples, is_hdr)
    n, in_dim = feats.shape if feats.dim() == 2 else (-1, -1)
    if in_dim != w.in_dim or in_dim not in IN_WIDTHS:
        raise ValueError(f"feats must be (N, {w.in_dim}) with {w.in_dim} in {IN_WIDTHS}, got {tuple(feats.shape)}")
    if samples < 1 or n % samples:
        raise ValueError(f"{n} points are not whole rays of {samples} samples")
    check_tensor("feats", feats, (n, in_dim))
    check_tensor("ray_dirs", ray_dirs, (n // samples, 3))
    if w.image.dtype != torch.bfloat16 or w.image.nbytes != IMAGE_BYTES or not w.image.is_contiguous():
        raise ValueError(f"the weight image must be {IMAGE_BYTES} contiguous bytes of bf16")
    if not (feats.device == ray_dirs.device == w.image.device):
        raise ValueError("feats, ray_dirs and the weights must be on the same CUDA device")
    sigma = torch.empty((n,), dtype=torch.float32, device=feats.device)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=feats.device)
    if n:
        lib = _library()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream(feats.device).cuda_stream
            err = lib.ngp_mlp_fwd(feats.data_ptr(), ray_dirs.data_ptr(), w.image.data_ptr(), sigma.data_ptr(),
                                  rgb.data_ptr(), n, in_dim, samples, int(is_hdr), stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL} launch failed: {lib.ngp_mlp_fwd_error_string(err).decode()} "
                               f"(cudaError {err})")
        launch_count.count(ngp_mlp_fwd, n)
    return sigma, rgb


launch_count.reset(ngp_mlp_fwd)
