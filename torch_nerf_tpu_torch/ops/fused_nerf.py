"""Fused NeRF field: positional encoding + the 11-layer MLP forward in one
hand-written Hopper kernel (``csrc/fused_nerf_fwd.cu``).

Replaces the Pallas TPU kernel ``torch_nerf_tpu/ops/pallas/fused_nerf.py::
_fwd_kernel`` (via ``_fused_forward`` and its ``pl.pallas_call``). Its bound
on an H100 SXM is the tensor cores: 1,186,816 FLOP per point at width 256,
0.94 ms for a 786,432-point fine chunk at 989 TFLOP/s bf16, against 40 bytes
of input and output per point. The kernel keeps every hidden activation in
shared memory and runs the products on the tensor cores (``mma.sync`` bf16,
f32 accumulation); the source's header note gives the design.

The TPU workarounds of the Pallas kernel are not carried over: the encode is
plain ``sincosf``, and the public parameter layout reaches the kernel with
only zero padding (pe 63->64, de 27->32, fc_8 257->264 columns, fc_out
3->8) and a reordering of each weight into tensor-core fragment order, both
done here by :func:`prepare`.

:func:`fused_nerf_apply` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors it runs the plain PyTorch version,
:func:`fused_nerf_apply_reference` (``nerf_apply`` of the positional
encodings). ``fused_nerf_apply.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, Params, nerf_apply
from torch_nerf_tpu_torch.ops import build

KERNEL = "fused_nerf_fwd"
# max dynamic shared memory of one block on Hopper
_SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class FusedNeRFConfig:
    coord_encode_level: int = 10
    dir_encode_level: int = 4
    include_input: bool = True
    feat_dim: int = 256
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def pos_enc_dim(self) -> int:
        return encoders.positional_encoding_dim(3, self.coord_encode_level, self.include_input)

    @property
    def dir_enc_dim(self) -> int:
        return encoders.positional_encoding_dim(3, self.dir_encode_level, self.include_input)


def flops_per_point(cfg: FusedNeRFConfig) -> int:
    """2 x the MLP's multiply-adds per point (the encode is not counted)."""
    f, p, d = cfg.feat_dim, cfg.pos_enc_dim, cfg.dir_enc_dim
    macs = p * f + 4 * f * f + (p + f) * f + 2 * f * f + f * (f + 1) + (f + d) * (f // 2) + (f // 2) * 3
    return 2 * macs


def fused_nerf_apply_reference(
    params: Params, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``nerf_apply`` of the encodings."""
    pe = encoders.positional_encoding(pts, cfg.coord_encode_level, cfg.include_input)
    de = encoders.positional_encoding(dirs, cfg.dir_encode_level, cfg.include_input)
    return nerf_apply(params, pe, de, compute_dtype=cfg.compute_dtype)


# ---------------------------------------------------------------------------
# kernel layout of the weights


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pad_rows(w: torch.Tensor, segments) -> torch.Tensor:
    """Zero-pad each row segment ``(length, padded_length)`` of ``w``."""
    parts, start = [], 0
    for length, padded in segments:
        part = w[start : start + length]
        parts.append(torch.nn.functional.pad(part, (0, 0, 0, padded - length)))
        start += length
    return torch.cat(parts, dim=0)


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """(K, N) with K % 16 == N % 8 == 0 -> (K/16 * N/8 * 32, 4): for k-tile
    ``kt``, n-tile ``nt`` and lane ``l``, the four values
    ``w[16kt + 2(l%4) + {0, 1, 8, 9}, 8nt + l//4]`` — the B operand of
    ``mma.m16n8k16`` held by lane ``l``, so one warp reads a fragment with one
    coalesced 256-byte load."""
    k, n = w.shape
    f = w.reshape(k // 16, 2, 4, 2, n // 8, 8)  # (kt, khalf, t, kpair, nt, g)
    return f.permute(0, 4, 5, 2, 1, 3).reshape(-1, 4).contiguous()


@dataclasses.dataclass(frozen=True)
class KernelWeights:
    """One network's parameters: the public tree plus, for parameters on the
    card, the kernel layout (bf16 fragments and padded biases per layer)."""

    public: Params
    frags: Optional[Tuple[torch.Tensor, ...]]
    biases: Optional[Tuple[torch.Tensor, ...]]


def kernel_layout(params: Params, cfg: FusedNeRFConfig):
    """Per-layer (padded weight (K, N), padded bias (N,)) in bf16, the K axis
    padded per concatenated segment, N to a multiple of 8."""
    f, p, d = cfg.feat_dim, cfg.pos_enc_dim, cfg.dir_enc_dim
    pp, dp = _round16(p), _round16(d)
    rows = {
        "fc_in": [(p, pp)],
        "fc_5": [(p, pp), (f, f)],
        "fc_9": [(f, f), (d, dp)],
    }
    out = []
    for name in LAYER_NAMES:
        w = params[name]["w"].to(torch.bfloat16)
        b = params[name]["b"].to(torch.bfloat16)
        w = _pad_rows(w, rows.get(name, [(w.shape[0], w.shape[0])]))
        n_pad = -(-w.shape[1] // 8) * 8
        w = torch.nn.functional.pad(w, (0, n_pad - w.shape[1]))
        b = torch.nn.functional.pad(b, (0, n_pad - b.shape[0]))
        out.append((w, b))
    return out


def prepare(params, cfg: FusedNeRFConfig) -> KernelWeights:
    """Public params -> :class:`KernelWeights` (idempotent). The kernel layout
    is built once here, not on every launch."""
    if isinstance(params, KernelWeights):
        return params
    if params["fc_in"]["w"].device.type != "cuda":
        return KernelWeights(public=params, frags=None, biases=None)
    layout = kernel_layout(params, cfg)
    return KernelWeights(
        public=params,
        frags=tuple(fragment_order(w) for w, _ in layout),
        biases=tuple(b.contiguous() for _, b in layout),
    )


# ---------------------------------------------------------------------------
# the wrapper


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/fused_nerf_fwd.cu`` (or a source with the same interface)."""
    lib.fused_nerf_fwd.argtypes = (
        [ctypes.c_void_p] * 2
        + [ctypes.POINTER(ctypes.c_void_p)] * 2
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    lib.fused_nerf_fwd.restype = ctypes.c_int
    lib.fused_nerf_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_nerf_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.fused_nerf_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_nerf_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _check_inputs(pts: torch.Tensor, dirs: torch.Tensor, w: KernelWeights, cfg: FusedNeRFConfig):
    if cfg.compute_dtype != torch.bfloat16:
        raise ValueError(f"the fused kernel computes in bfloat16, not {cfg.compute_dtype}")
    if cfg.feat_dim % 32 != 0:
        raise ValueError(f"the fused kernel needs feat_dim % 32 == 0, got {cfg.feat_dim}")
    for name, t in (("pts", pts), ("dirs", dirs)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (M, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pts.shape != dirs.shape or pts.device != dirs.device:
        raise ValueError("pts and dirs must have the same shape and device")
    if w.frags is None or w.frags[0].device != pts.device:
        raise ValueError("the network's parameters must be on the same CUDA device as pts")


def _launch(w: KernelWeights, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig):
    """Launch on the current stream."""
    _check_inputs(pts, dirs, w, cfg)
    lib = _library()
    pe_pad, de_pad = _round16(cfg.pos_enc_dim), _round16(cfg.dir_enc_dim)
    smem = lib.fused_nerf_fwd_smem_bytes(cfg.feat_dim, pe_pad, de_pad)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"feat_dim {cfg.feat_dim} needs {smem} B of shared memory per block")
    m = pts.shape[0]
    sigma = torch.empty((m,), dtype=torch.float32, device=pts.device)
    rgb = torch.empty((m, 3), dtype=torch.float32, device=pts.device)
    if m == 0:
        return sigma, rgb
    wptrs = (ctypes.c_void_p * len(w.frags))(*[t.data_ptr() for t in w.frags])
    bptrs = (ctypes.c_void_p * len(w.biases))(*[t.data_ptr() for t in w.biases])
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.fused_nerf_fwd(
            pts.data_ptr(), dirs.data_ptr(), wptrs, bptrs,
            sigma.data_ptr(), rgb.data_ptr(), m, cfg.feat_dim,
            cfg.coord_encode_level, cfg.dir_encode_level, int(cfg.include_input),
            cfg.pos_enc_dim, cfg.dir_enc_dim, pe_pad, de_pad, stream,
        )
    if err != 0:
        msg = lib.fused_nerf_fwd_error_string(err).decode()
        raise RuntimeError(f"fused_nerf_fwd launch failed: {msg} (cudaError {err})")
    fused_nerf_apply.launches += 1
    return sigma, rgb


def fused_nerf_apply(
    params, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma (M,), rgb (M, 3))`` for flat ``pts``/``dirs`` ``(M, 3)``.

    ``params`` is the public tree or its :func:`prepare` result. CUDA
    tensors go through the kernel (or raise); CPU tensors through
    :func:`fused_nerf_apply_reference`.
    """
    if pts.device.type == "cpu":
        public = params.public if isinstance(params, KernelWeights) else params
        return fused_nerf_apply_reference(public, pts, dirs, cfg)
    return _launch(prepare(params, cfg), pts, dirs, cfg)


fused_nerf_apply.launches = 0
