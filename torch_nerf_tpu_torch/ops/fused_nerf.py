"""Fused NeRF field: positional encoding + the 11-layer MLP, forward and
backward as hand-written Hopper kernels.

Forward (``csrc/fused_nerf_fwd.cu``) replaces the Pallas TPU kernel
``torch_nerf_tpu/ops/pallas/fused_nerf.py::_fwd_kernel`` (via
``_fused_forward`` and its ``pl.pallas_call``). Its bound on an H100 SXM is
the tensor cores: 1,186,816 FLOP per point at width 256, 0.94 ms for a
786,432-point fine chunk at 989 TFLOP/s bf16, against 40 bytes of input and
output per point. The kernel keeps every hidden activation in shared memory
and runs the products on the tensor cores (``mma.sync`` bf16, f32
accumulation); the source's header note gives the design.

Backward (``csrc/fused_nerf_bwd.cu`` with ``csrc/nerf_mlp.cuh``) replaces
``_bwd_kernel`` (via ``_fused_bwd``): the recomputed forward, the VJP to
the 22 parameter grads summed over every point, and to the points and view
directions. :func:`fused_nerf_bwd_reference` is its plain version, written
out step by step as ``_backward_tile`` is: the relu masks, every ``dh``
rounded to bf16 before its mask and its next product, dW and db summed in
f32, the skip split of ``dh`` into ``h4`` and ``pe``, the view-direction
split at fc_9.

The TPU workarounds of the Pallas kernels are not carried over: the encode
is plain ``sincosf``, and the public parameter layout reaches the kernels
with only zero padding (pe 63->64, de 27->32, fc_8 257->264 columns, fc_out
3->8) and a reordering of each weight (and, for the backward, its
transpose) into tensor-core fragment order, done here.

:func:`fused_nerf_apply` takes the public parameter tree through a
``torch.autograd.Function``: on CUDA tensors its forward launches the
forward kernel on a layout built from the parameters of that call, and its
backward launches the backward kernel; on CPU tensors both directions run
the plain versions. A :func:`prepare`-d :class:`KernelWeights` (serving:
built once per image) takes the forward kernel alone.
``fused_nerf_apply.launches`` and ``fused_nerf_bwd.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, Params, nerf_apply
from torch_nerf_tpu_torch.ops import build

KERNEL = "fused_nerf_fwd"
KERNEL_BWD = "fused_nerf_bwd"
# max dynamic shared memory of one block on Hopper
_SMEM_LIMIT = 232_448

_PRE_SKIP = ("fc_in", "fc_1", "fc_2", "fc_3", "fc_4")
_POST_SKIP = ("fc_5", "fc_6", "fc_7")


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
# the plain backward


def forward_activations(
    params: Params, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig
) -> Dict[str, torch.Tensor]:
    """Every activation of the forward in ``cfg.compute_dtype``, with the
    roundings of ``nerf_apply`` (its sigma and rgb, bit for bit): ``pe``,
    ``de``, each relu layer's output by layer name, ``z8`` (fc_8 before its
    sigma relu), ``sigma`` and ``rgb`` in f32."""
    dt = cfg.compute_dtype
    acts = {
        "pe": encoders.positional_encoding(pts, cfg.coord_encode_level, cfg.include_input).to(dt),
        "de": encoders.positional_encoding(dirs, cfg.dir_encode_level, cfg.include_input).to(dt),
    }

    def linear(name, x):
        return torch.matmul(x, params[name]["w"].to(dt)) + params[name]["b"].to(dt)

    h = acts["pe"]
    for name in _PRE_SKIP:
        h = acts[name] = torch.relu(linear(name, h))
    h = torch.cat([acts["pe"], h], dim=-1)
    for name in _POST_SKIP:
        h = acts[name] = torch.relu(linear(name, h))
    z8 = acts["z8"] = linear("fc_8", h)
    acts["fc_9"] = torch.relu(linear("fc_9", torch.cat([z8[:, 1:], acts["de"]], dim=-1)))
    acts["rgb"] = torch.sigmoid(linear("fc_out", acts["fc_9"]).float())
    acts["sigma"] = torch.relu(z8[:, 0]).float()
    return acts


def encode_vjp(x: torch.Tensor, g: torch.Tensor, levels: int, include_input: bool) -> torch.Tensor:
    """VJP of ``positional_encoding`` (columns ``[x, sin(2^0 x), cos(2^0 x),
    ...]``): ``(M, 3)`` points, ``(M, D)`` f32 cotangent -> ``(M, 3)``."""
    out = g[:, :3].clone() if include_input else torch.zeros_like(x)
    col = 3 if include_input else 0
    for level in range(levels):
        freq = float(2**level)
        y = freq * x
        out = out + freq * (torch.cos(y) * g[:, col : col + 3] - torch.sin(y) * g[:, col + 3 : col + 6])
        col += 6
    return out


def backward_from_activations(
    params: Params,
    acts: Dict[str, torch.Tensor],
    g_sigma: torch.Tensor,
    g_rgb: torch.Tensor,
    cfg: FusedNeRFConfig,
    input_grads: bool = True,
):
    """``_backward_tile`` in explicit steps -> ``(grads, dpe, dde)``: grads
    ``{name: {"w", "b"}}`` in the public layout, in f32; ``dpe``/``dde`` the
    f32 cotangents of the encodings, or None without ``input_grads``."""
    dt, f, p = cfg.compute_dtype, cfg.feat_dim, cfg.pos_enc_dim
    zero = torch.zeros((), dtype=dt, device=g_rgb.device)
    grads: Dict[str, Dict[str, torch.Tensor]] = {}

    def wt(name):
        return params[name]["w"].to(dt).t()

    def put(name, a, dz):
        # f32 sums of the rounded operands
        grads[name] = {"w": a.float().t() @ dz.float(), "b": dz.float().sum(dim=0)}

    def relu_grad(act, dh):
        return torch.where(act > 0, dh, zero)

    rgb = acts["rgb"]
    dz = (g_rgb * rgb * (1.0 - rgb)).to(dt)
    put("fc_out", acts["fc_9"], dz)
    dz = relu_grad(acts["fc_9"], dz @ wt("fc_out"))  # dh rounded to dt by the product
    put("fc_9", torch.cat([acts["z8"][:, 1:], acts["de"]], dim=-1), dz)
    dcat9 = dz @ wt("fc_9")
    dde = dcat9[:, f:].float() if input_grads else None
    # fc_8: a relu on the sigma column only
    dsig = torch.where(acts["z8"][:, 0].float() > 0, g_sigma, 0.0).to(dt)
    dz = torch.cat([dsig[:, None], dcat9[:, :f]], dim=-1)
    put("fc_8", acts["fc_7"], dz)
    dh = dz @ wt("fc_8")

    inputs = {
        "fc_7": acts["fc_6"],
        "fc_6": acts["fc_5"],
        "fc_5": torch.cat([acts["pe"], acts["fc_4"]], dim=-1),
        "fc_4": acts["fc_3"],
        "fc_3": acts["fc_2"],
        "fc_2": acts["fc_1"],
        "fc_1": acts["fc_in"],
        "fc_in": acts["pe"],
    }
    dpe = None
    for name in reversed(_PRE_SKIP + _POST_SKIP):
        dz = relu_grad(acts[name], dh)
        put(name, inputs[name], dz)
        if name == "fc_in" and not input_grads:
            break
        dh = dz @ wt(name)
        if name == "fc_5":  # the skip split: [pe, h4]
            dpe, dh = dh[:, :p].float(), dh[:, p:]
    if input_grads:
        dpe = dpe + dh.float()
    grads = {name: grads[name] for name in LAYER_NAMES}
    return grads, (dpe if input_grads else None), dde


def fused_nerf_bwd_reference(
    params: Params,
    pts: torch.Tensor,
    dirs: torch.Tensor,
    g_sigma: torch.Tensor,
    g_rgb: torch.Tensor,
    cfg: FusedNeRFConfig,
):
    """The plain version of the backward kernel: ``(grads, dpts, ddirs)`` of
    ``fused_nerf_apply`` at ``(pts, dirs)`` for cotangents ``g_sigma (M,)``
    and ``g_rgb (M, 3)``."""
    with torch.no_grad():
        acts = forward_activations(params, pts, dirs, cfg)
        grads, dpe, dde = backward_from_activations(params, acts, g_sigma, g_rgb, cfg)
        dpts = encode_vjp(pts, dpe, cfg.coord_encode_level, cfg.include_input)
        ddirs = encode_vjp(dirs, dde, cfg.dir_encode_level, cfg.include_input)
    return grads, dpts, ddirs


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


def transposed_fragments(w: torch.Tensor) -> torch.Tensor:
    """Fragments of ``w.T`` for a padded layer weight ``w (K, N)``: the B
    operand of the backward's ``dh = dz w^T``, its rows (N) padded to 16."""
    wt = w.t()
    return fragment_order(torch.nn.functional.pad(wt, (0, 0, 0, _round16(wt.shape[0]) - wt.shape[0])))


def _flat(params: Params) -> List[torch.Tensor]:
    return [params[name][leaf] for name in LAYER_NAMES for leaf in ("w", "b")]


def _tree(tensors: Sequence[torch.Tensor]) -> Params:
    return {name: {"w": tensors[2 * i], "b": tensors[2 * i + 1]} for i, name in enumerate(LAYER_NAMES)}


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
        w = params[name]["w"].detach().to(torch.bfloat16)
        b = params[name]["b"].detach().to(torch.bfloat16)
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
# the wrappers


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


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_nerf_bwd.cu``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.fused_nerf_bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ptrs] * 3 + [ctypes.c_void_p] + [ptrs] * 2
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.fused_nerf_bwd.restype = ctypes.c_int
    lib.fused_nerf_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_nerf_bwd_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_nerf_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_nerf_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.fused_nerf_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_nerf_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(build.load(KERNEL_BWD))


def pointers(tensors: Sequence[torch.Tensor]):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check_config(cfg: FusedNeRFConfig) -> None:
    if cfg.compute_dtype != torch.bfloat16:
        raise ValueError(f"the fused kernel computes in bfloat16, not {cfg.compute_dtype}")
    if cfg.feat_dim % 32 != 0:
        raise ValueError(f"the fused kernel needs feat_dim % 32 == 0, got {cfg.feat_dim}")


def check_tensor(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    """Raise unless ``t`` is a contiguous f32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(pts: torch.Tensor, dirs: torch.Tensor, w: KernelWeights, cfg: FusedNeRFConfig):
    check_config(cfg)
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (M, 3), got {tuple(pts.shape)}")
    check_tensor("pts", pts, tuple(pts.shape))
    check_tensor("dirs", dirs, tuple(pts.shape))
    if pts.device != dirs.device:
        raise ValueError("pts and dirs must be on the same device")
    if w.frags is None or w.frags[0].device != pts.device:
        raise ValueError("the network's parameters must be on the same CUDA device as pts")


def _launch(w: KernelWeights, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig):
    """Launch the forward kernel on the current stream."""
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
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.fused_nerf_fwd(
            pts.data_ptr(), dirs.data_ptr(), pointers(w.frags), pointers(w.biases),
            sigma.data_ptr(), rgb.data_ptr(), m, cfg.feat_dim,
            cfg.coord_encode_level, cfg.dir_encode_level, int(cfg.include_input),
            cfg.pos_enc_dim, cfg.dir_enc_dim, pe_pad, de_pad, stream,
        )
    if err != 0:
        msg = lib.fused_nerf_fwd_error_string(err).decode()
        raise RuntimeError(f"fused_nerf_fwd launch failed: {msg} (cudaError {err})")
    fused_nerf_apply.launches += 1
    return sigma, rgb


def training_layout(params: Params, cfg: FusedNeRFConfig):
    """``(frags, biases, frags_t)`` of the current parameters: the forward's
    fragments and biases and the backward's transposed fragments."""
    layout = kernel_layout(params, cfg)
    frags = [fragment_order(w) for w, _ in layout]
    frags_t = [transposed_fragments(w) for w, _ in layout]
    return frags, [b.contiguous() for _, b in layout], frags_t


def empty_grads(params: Params) -> Params:
    """f32 tensors of the public parameter shapes, for a kernel to fill."""
    return {
        name: {leaf: torch.empty(t.shape, dtype=torch.float32, device=t.device) for leaf, t in p.items()}
        for name, p in params.items()
    }


def _launch_bwd(params: Params, pts, dirs, g_sigma, g_rgb, cfg: FusedNeRFConfig):
    """Launch the backward kernel on the current stream."""
    check_config(cfg)
    m = pts.shape[0]
    for name, t, shape in (("pts", pts, (m, 3)), ("dirs", dirs, (m, 3)),
                           ("g_sigma", g_sigma, (m,)), ("g_rgb", g_rgb, (m, 3))):
        check_tensor(name, t, shape)
    if params["fc_in"]["w"].device != pts.device:
        raise ValueError("the network's parameters must be on the same CUDA device as pts")
    lib = _bwd_library()
    pe_pad, de_pad = _round16(cfg.pos_enc_dim), _round16(cfg.dir_enc_dim)
    smem = lib.fused_nerf_bwd_smem_bytes(cfg.feat_dim, pe_pad, de_pad)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"feat_dim {cfg.feat_dim} needs {smem} B of shared memory per block")
    grads = empty_grads(params)
    dpts = torch.empty_like(pts)
    ddirs = torch.empty_like(dirs)
    if m == 0:
        return {n: {k: t.zero_() for k, t in p.items()} for n, p in grads.items()}, dpts, ddirs
    frags, biases, frags_t = training_layout(params, cfg)
    workspace = torch.empty(
        lib.fused_nerf_bwd_workspace_bytes(m, cfg.feat_dim, pe_pad, de_pad),
        dtype=torch.uint8, device=pts.device,
    )
    flat = _flat(grads)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.fused_nerf_bwd(
            pts.data_ptr(), dirs.data_ptr(), g_sigma.data_ptr(), g_rgb.data_ptr(),
            pointers(frags), pointers(biases), pointers(frags_t), workspace.data_ptr(),
            pointers(flat[0::2]), pointers(flat[1::2]), dpts.data_ptr(), ddirs.data_ptr(),
            m, cfg.feat_dim, cfg.coord_encode_level, cfg.dir_encode_level,
            int(cfg.include_input), cfg.pos_enc_dim, cfg.dir_enc_dim, pe_pad, de_pad, stream,
        )
    if err != 0:
        msg = lib.fused_nerf_bwd_error_string(err).decode()
        raise RuntimeError(f"fused_nerf_bwd launch failed: {msg} (cudaError {err})")
    fused_nerf_bwd.launches += 1
    return grads, dpts, ddirs


def fused_nerf_bwd(params: Params, pts, dirs, g_sigma, g_rgb, cfg: FusedNeRFConfig):
    """``(grads, dpts, ddirs)``: the backward kernel on CUDA tensors (or
    raise), :func:`fused_nerf_bwd_reference` on CPU tensors."""
    if pts.device.type == "cpu":
        return fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    return _launch_bwd(params, pts, dirs, g_sigma.contiguous(), g_rgb.contiguous(), cfg)


fused_nerf_bwd.launches = 0


class _FusedField(torch.autograd.Function):
    """``(sigma, rgb)`` of the 22 public parameter tensors, ``pts`` and
    ``dirs``; the backward returns the 22 grads in the public layout plus
    ``dpts`` and ``ddirs``."""

    @staticmethod
    def forward(ctx, cfg, pts, dirs, *tensors):
        ctx.cfg = cfg
        ctx.save_for_backward(pts, dirs, *tensors)
        params = _tree(tensors)
        if pts.device.type == "cpu":
            return fused_nerf_apply_reference(params, pts, dirs, cfg)
        # the layout of this call's parameters, never one built before an
        # optimizer step
        return _launch(prepare(params, cfg), pts, dirs, cfg)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        pts, dirs, *tensors = ctx.saved_tensors
        grads, dpts, ddirs = fused_nerf_bwd(_tree(tensors), pts, dirs, g_sigma, g_rgb, ctx.cfg)
        return (None, dpts, ddirs, *_flat(grads))


def fused_nerf_apply(
    params, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma (M,), rgb (M, 3))`` for flat ``pts``/``dirs`` ``(M, 3)``.

    The public tree goes through the autograd ``Function`` (a loss through
    it gives every parameter, ``pts`` and ``dirs`` a gradient); a
    :func:`prepare` result runs the forward alone. CUDA tensors go through
    the kernels (or raise); CPU tensors through the plain versions.
    """
    if isinstance(params, KernelWeights):
        if pts.device.type == "cpu":
            return fused_nerf_apply_reference(params.public, pts, dirs, cfg)
        return _launch(prepare(params, cfg), pts, dirs, cfg)
    return _FusedField.apply(cfg, pts, dirs, *_flat(params))


fused_nerf_apply.launches = 0
