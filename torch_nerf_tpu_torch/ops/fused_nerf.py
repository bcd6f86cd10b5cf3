"""Fused NeRF field: positional encoding + the 11-layer MLP, forward and
backward as hand-written Hopper kernels.

Forward (``csrc/fused_nerf_fwd.cu``) replaces the Pallas TPU kernel
``torch_nerf_tpu/ops/pallas/fused_nerf.py::_fwd_kernel`` (via
``_fused_forward`` and its ``pl.pallas_call``). Its bound on an H100 SXM is
the card's arithmetic: 1,186,816 FLOP per point at width 256, 0.94 ms for a
786,432-point fine chunk at 989 TFLOP/s bf16 (17.7 ms in f32 at 67 TFLOP/s),
against 40 bytes of input and output per point. It runs on one of three
routes that :func:`forward_route` picks from the config: bf16 at widths 64,
128 and 256 with encodings up to 64 wide take ``wgmma``, the training
kernels' forward without its stash (``csrc/nerf_mlp_train.cuh``), reading
the forward images of :func:`forward_layout`; every other config up to
width 1024 and encodings 128 wide takes the tensor-core general route
(``csrc/nerf_mlp_tc.cuh``: column passes, :func:`tc_plan`), reading
:func:`tc_layout`: ``wgmma_general`` in bf16, ``f32_wgmma`` in f32 (three
bf16 pieces an operand). Every hidden activation stays in shared memory,
but for f32 past width 512, whose 64-point tile does not fit: there each
layer's outputs go to device memory and come back from L2 as the next
layer's input (kernel 1 through a scratch of two such buffers and h9's).
A width that is not a multiple of 32 is zero-padded to the next one
(:func:`pad_params`): the padded units are ``relu(0) = 0`` and add nothing
to any later layer.

Backward (``csrc/fused_nerf_bwd.cu``) replaces ``_bwd_kernel`` (via
``_fused_bwd``): the recomputed forward, the VJP to the 22 parameter grads
summed over every point, and to the points and view directions, on the
route :func:`train_route` picks: ``wgmma`` with the weights streamed into
shared memory by bulk asynchronous copies (``nerf_mlp_train.cuh``), or the
general route's stash, chain and dW GEMM. :func:`fused_nerf_bwd_reference`
is its plain version, written out step by step as ``_backward_tile`` is:
the relu masks, every ``dh`` rounded to the compute type before its mask
and its next product, dW and db summed in f32, the skip split of ``dh``
into ``h4`` and ``pe``, the view-direction split at fc_9.

The TPU workarounds of the Pallas kernels are not carried over: the encode
is plain ``sincosf``, and the public parameter layout reaches the kernels
with only zero padding and a reordering, done here: each weight, and for
the backward its transpose, as images of ``wgmma``'s 128-byte swizzled
shared-memory layout (:func:`training_layout`, :func:`panel_image`; on the
general route :func:`tc_layout`, :func:`tc_panel_image`).

:func:`fused_nerf_apply` takes the public parameter tree through a
``torch.autograd.Function``: on CUDA tensors its forward launches the
forward kernel on a layout built from the parameters of that call, and its
backward launches the backward kernel; on CPU tensors both directions run
the plain versions. A :func:`prepare`-d :class:`KernelWeights` (serving:
built once per image, in its route's layout only) takes the forward kernel
alone. ``fused_nerf_apply.launches`` and ``fused_nerf_bwd.launches`` count
kernel launches, their ``.shapes`` by point count (:mod:`launch_count`),
their ``.route_launches`` by route (each sums to ``.launches``). A build or
launch failure raises: no route gives way to another or to the plain
version.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from torch_nerf_tpu_torch import encoders, tracing
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, Params, nerf_apply
from torch_nerf_tpu_torch.ops import build, launch_count

KERNEL = "fused_nerf_fwd"
KERNEL_BWD = "fused_nerf_bwd"
# the tensor-core general route's kernels 1 and 2, sources of their own so
# that nvcc builds them beside the others
KERNEL_TC = "fused_tc_fwd"
KERNEL_TC_BWD = "fused_tc_bwd"
# max dynamic shared memory of one block on Hopper
_SMEM_LIMIT = 232_448  # a block's shared memory
_SMEM_PER_SM = 233_472  # an SM's, 1 KB of it reserved a block

# the widths of the wgmma route's templates (bf16, encodings up to 64 wide)
TRAIN_WIDTHS = (64, 128, 256)
WGMMA_MAX_ENC = 64
# the general route's limits: any width up to MAX_FEAT (padded to a multiple
# of 32), encodings up to MAX_ENC columns
MAX_FEAT = 1024
MAX_ENC = 128
ROUTES = ("wgmma", "wgmma_general", "f32_wgmma")
# the tensor-core general route (csrc/nerf_mlp_tc.cuh): bf16 on wgmma, f32 on
# wgmma's bf16 product over three bf16 pieces of each operand, at every
# padded width up to 1024
TC_ROUTES = ("wgmma_general", "f32_wgmma")
ROUTE_DTYPE = {"wgmma": torch.bfloat16, "wgmma_general": torch.bfloat16, "f32_wgmma": torch.float32}
DTYPES = (torch.bfloat16, torch.float32)
# what a forward library's fused_nerf_fwd reads (fused_nerf_fwd_layout(); a
# library without that symbol reads fragment order)
LAYOUT_FRAGMENTS, LAYOUT_IMAGES = 0, 1

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
    sigma relu), ``sigma`` and ``rgb`` in f32 (in f64 for a float64
    ``compute_dtype``, a reference one precision above the f32 route)."""
    dt = cfg.compute_dtype
    out = _sum_dtype(dt)
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
    acts["rgb"] = torch.sigmoid(linear("fc_out", acts["fc_9"]).to(out))
    acts["sigma"] = torch.relu(z8[:, 0]).to(out)
    return acts


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    """The type the plain versions sum grads and keep outputs in: f32, or
    f64 for a float64 compute type."""
    return torch.promote_types(dt, torch.float32)


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
    ``{name: {"w", "b"}}`` in the public layout, in f32 (f64 for a float64
    compute type); ``dpe``/``dde`` the cotangents of the encodings in that
    type, or None without ``input_grads``."""
    dt, f, p = cfg.compute_dtype, cfg.feat_dim, cfg.pos_enc_dim
    acc = _sum_dtype(dt)
    zero = torch.zeros((), dtype=dt, device=g_rgb.device)
    grads: Dict[str, Dict[str, torch.Tensor]] = {}

    def wt(name):
        return params[name]["w"].to(dt).t()

    def put(name, a, dz):
        # f32 sums of the rounded operands
        grads[name] = {"w": a.to(acc).t() @ dz.to(acc), "b": dz.to(acc).sum(dim=0)}

    def relu_grad(act, dh):
        return torch.where(act > 0, dh, zero)

    rgb = acts["rgb"]
    dz = (g_rgb * rgb * (1.0 - rgb)).to(dt)
    put("fc_out", acts["fc_9"], dz)
    dz = relu_grad(acts["fc_9"], dz @ wt("fc_out"))  # dh rounded to dt by the product
    put("fc_9", torch.cat([acts["z8"][:, 1:], acts["de"]], dim=-1), dz)
    dcat9 = dz @ wt("fc_9")
    dde = dcat9[:, f:].to(acc) if input_grads else None
    # fc_8: a relu on the sigma column only
    dsig = torch.where(acts["z8"][:, 0].to(acc) > 0, g_sigma, 0.0).to(dt)
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
            dpe, dh = dh[:, :p].to(acc), dh[:, p:]
    if input_grads:
        dpe = dpe + dh.to(acc)
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


def _flat(params: Params) -> List[torch.Tensor]:
    return [params[name][leaf] for name in LAYER_NAMES for leaf in ("w", "b")]


def _tree(tensors: Sequence[torch.Tensor]) -> Params:
    return {name: {"w": tensors[2 * i], "b": tensors[2 * i + 1]} for i, name in enumerate(LAYER_NAMES)}


@dataclasses.dataclass(frozen=True)
class KernelWeights:
    """One network's parameters: the public tree plus, for parameters on the
    card, the forward's route and its weight layout per layer (``wgmma``:
    forward panel images and biases in their row order; ``wgmma_general``
    and ``f32_wgmma``: :func:`tc_layout`'s). On the CPU only ``public`` is
    set."""

    public: Params
    route: Optional[str]
    weights: Optional[Tuple[torch.Tensor, ...]]
    biases: Optional[Tuple[torch.Tensor, ...]]


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def check_config(cfg: FusedNeRFConfig) -> None:
    """Raise unless some route takes ``cfg``: compute dtype bfloat16 or
    float32, 0 < feat_dim <= :data:`MAX_FEAT`, both encodings at most
    :data:`MAX_ENC` columns."""
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"the fused kernels compute in bfloat16 or float32, not {cfg.compute_dtype}")
    if not 0 < cfg.feat_dim <= MAX_FEAT:
        raise ValueError(f"the fused kernels take feat_dim up to {MAX_FEAT}, got {cfg.feat_dim}; "
                         "set parallel.use_pallas=false for the plain path")
    if max(cfg.pos_enc_dim, cfg.dir_enc_dim) > MAX_ENC:
        raise ValueError(f"the fused kernels take encodings up to {MAX_ENC} wide, got {cfg.pos_enc_dim}, "
                         f"{cfg.dir_enc_dim}; set parallel.use_pallas=false for the plain path")


def forward_route(cfg: FusedNeRFConfig) -> str:
    """The route of ``cfg`` (the forward's and, by :func:`train_route`, the
    training kernels'), chosen before any launch: ``"wgmma"`` for bfloat16
    at feat_dim 64, 128 or 256 with both encodings at most 64 wide; else
    ``"wgmma_general"`` for bfloat16 and ``"f32_wgmma"`` for float32 (the
    tensor-core general route, whose plan takes every config of
    :func:`check_config`: :func:`tc_plan`). Raises past the limits of
    :func:`check_config`."""
    check_config(cfg)
    f32 = cfg.compute_dtype == torch.float32
    if not f32 and cfg.feat_dim in TRAIN_WIDTHS and max(cfg.pos_enc_dim, cfg.dir_enc_dim) <= WGMMA_MAX_ENC:
        return "wgmma"
    if tc_plan(cfg) is None:
        raise ValueError(f"no route takes {cfg}: the tensor-core general route's plan does not fit")
    return "f32_wgmma" if f32 else "wgmma_general"


# the training kernels' (2 and 3) route for a config: the forward's
train_route = forward_route


# ---------------------------------------------------------------------------
# the general route's layout: zero padding to a width % 32 == 0, every
# concatenated input segment padded to 16, fc_8's sigma after its features


def padded_config(cfg: FusedNeRFConfig) -> FusedNeRFConfig:
    """``cfg`` at the general route's width: feat_dim rounded up to 32."""
    return dataclasses.replace(cfg, feat_dim=_round32(cfg.feat_dim))


def pad_params(params: Params, cfg: FusedNeRFConfig) -> Params:
    """The public tree at ``cfg.feat_dim`` -> the same network at
    :func:`padded_config`'s width F: zero weight columns and zero biases for
    the new units (``relu(0) = 0``: they add nothing to any later layer),
    zero weight rows where they are inputs, fc_5's rows kept as ``[pe, h4]``
    and fc_9's as ``[features, de]``; fc_9 gets F // 2 units. The identity
    at a width % 32 == 0."""
    f, fp, p = cfg.feat_dim, _round32(cfg.feat_dim), cfg.pos_enc_dim
    if f == fp:
        return params

    def pad(t, rows, cols):
        return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))

    out = {}
    for name in LAYER_NAMES:
        w, b = params[name]["w"], params[name]["b"]
        if name == "fc_in":
            w, n = pad(w, p, fp), fp
        elif name == "fc_5":
            w, n = torch.cat([pad(w[:p], p, fp), pad(w[p:], fp, fp)]), fp
        elif name == "fc_8":
            w, n = pad(w, fp, fp + 1), fp + 1
        elif name == "fc_9":
            w, n = torch.cat([pad(w[:f], fp, fp // 2), pad(w[f:], w.shape[0] - f, fp // 2)]), fp // 2
        elif name == "fc_out":
            w, n = pad(w, fp // 2, 3), 3
        else:
            w, n = pad(w, fp, fp), fp
        out[name] = {"w": w, "b": torch.nn.functional.pad(b, (0, n - b.shape[0]))}
    return out


def unpad_grads(grads: Params, cfg: FusedNeRFConfig) -> Params:
    """Grads of :func:`pad_params`'s network -> those of the public tree at
    ``cfg.feat_dim``: the padded rows and columns sliced away."""
    f, fp, p = cfg.feat_dim, _round32(cfg.feat_dim), cfg.pos_enc_dim
    if f == fp:
        return grads
    out = {}
    for name in LAYER_NAMES:
        w, b = grads[name]["w"], grads[name]["b"]
        if name == "fc_in":
            w, n = w[:, :f], f
        elif name == "fc_5":
            w, n = torch.cat([w[:p], w[p:p + f]])[:, :f], f
        elif name == "fc_8":
            w, n = w[:f, :f + 1], f + 1
        elif name == "fc_9":
            w, n = torch.cat([w[:f], w[fp:]])[:, :f // 2], f // 2
        elif name == "fc_out":
            w, n = w[:f // 2], 3
        else:
            w, n = w[:f, :f], f
        out[name] = {"w": w.contiguous(), "b": b[:n].contiguous()}
    return out


def general_biases(params: Params, cfg: FusedNeRFConfig) -> List[torch.Tensor]:
    """Each layer's bias of :func:`pad_params`'s network in
    ``cfg.compute_dtype``, in the general route's column order (fc_8's
    sigma after its features), padded to a multiple of 8."""
    padded = pad_params(params, cfg)
    out = []
    for name in LAYER_NAMES:
        b = padded[name]["b"].detach().to(cfg.compute_dtype)
        if name == "fc_8":
            b = torch.cat([b[1:], b[:1]])
        out.append(torch.nn.functional.pad(b, (0, -(-b.shape[0] // 8) * 8 - b.shape[0])).contiguous())
    return out


def general_grad_shapes(cfg: FusedNeRFConfig):
    """Per layer the ``(rows, columns)`` of the grads the general route's
    kernels write: the layer's inputs, each concatenated segment padded to
    16 (fc_in ``pe``; fc_5 ``[pe, h4]``; fc_9 ``[features, de]``), by the
    width of the layer's dz (fc_8: F + 16, its features then sigma; fc_out:
    16)."""
    fp, pp, dp = padded_config(cfg).feat_dim, _round16(cfg.pos_enc_dim), _round16(cfg.dir_enc_dim)
    shapes = {"fc_in": (pp, fp), "fc_5": (pp + fp, fp), "fc_8": (fp, fp + 16), "fc_9": (fp + dp, fp // 2),
              "fc_out": (fp // 2, 16)}
    return [shapes.get(name, (fp, fp)) for name in LAYER_NAMES]


def grads_from_general(grads_w: Sequence[torch.Tensor], grads_b: Sequence[torch.Tensor],
                       cfg: FusedNeRFConfig) -> Params:
    """The general route's grads (:func:`general_grad_shapes`) -> the public
    layout at ``cfg.feat_dim``: each padded input segment and fc_8's
    sigma-last order undone, then :func:`unpad_grads`."""
    fp, p, pp, d = padded_config(cfg).feat_dim, cfg.pos_enc_dim, _round16(cfg.pos_enc_dim), cfg.dir_enc_dim
    out = {}
    for name, w, b in zip(LAYER_NAMES, grads_w, grads_b):
        if name == "fc_in":
            w = w[:p]
        elif name == "fc_5":
            w = torch.cat([w[:p], w[pp:]])
        elif name == "fc_8":
            w = torch.cat([w[:, fp:fp + 1], w[:, :fp]], dim=1)
            b = torch.cat([b[fp:fp + 1], b[:fp]])
        elif name == "fc_9":
            w = torch.cat([w[:fp], w[fp:fp + d]])
        elif name == "fc_out":
            w, b = w[:, :3], b[:3]
        out[name] = {"w": w.contiguous(), "b": b.contiguous()}
    return unpad_grads(out, cfg)


# the tensor-core general route's plan (csrc/nerf_mlp_tc.cuh): 64-point
# tiles of 128-byte panels, a ring of 2-4 weight stages beside them, each
# stage one image's 64-column K-slice of a column pass's rows (f32: three,
# one a bf16 piece); a layer's outputs in passes of NP columns a warpgroup
_TC_ROWS = 64
_TC_PANEL = _TC_ROWS * 128
_TC_MAX_STAGES = 4
_TC_SLACK = 1024 + 2 * _TC_MAX_STAGES * 8
_TC_EXTRA = 128  # the input-grad products' rows (encodings padded to 128)
_TC_PASS_CAP = 128  # a warpgroup's columns a pass where a layer takes several
_TC_PASS_MIN = 96  # ... and at least this many
_TC_PAIR_MAX = 80  # the widest bf16 pass width two CTAs an SM hold
_TC_MAX_PASSES = 4
_TC_SIGMA_ROWS = 8  # fc_8's sigma group beside each pass's features
# f32: the widest config whose 64-point tile fits a block; the passes an f32
# tile kernel of several passes holds at each of its pass widths (their
# outputs wait as f32: (cap + 1) x NP / 2 registers <= 160); past the tile
# the kernels stream at these pass widths; a streaming kernel's sink
_TC_F32_TILE_MAX = 512
F32_PASS_CAP = {64: 4, 80: 3, 96: 2}
_TC_STREAM_NP = (96, 64)
_TC_TRASH = 256 * 8


def panel_cols(dtype: torch.dtype) -> int:
    """Columns of a 128-byte tile panel: 64 in bf16, 32 in f32."""
    return 128 // torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The tensor-core general route's plan of a config (``nerf_mlp_tc.cuh``'s
    ``choose`` and ``plan_of``): each layer's outputs in ``passes`` column
    passes of ``np`` columns a warpgroup (fc_9 ``np // 2``); each kernel's
    ring stages and shared memory (the forward, the chain, the chain with
    input grads); the sign-bit words a relu slot a thread; the CTAs an SM
    of the forward and the chain (two at a bf16 pass of at most 80
    columns, each in half an SM's shared memory, its consumers at 96
    registers, else one at 232; the chain with input grads one); a
    consumer thread's registers for a pass's f32 sums (f32: and its
    slice's), the outputs of a layer's earlier passes held until its last
    is done (bf16 packed, at the plan's passes; f32 as f32, every slot the
    kernel holds) and f32's A fragments (its three pieces; streaming, also
    two K-slices of raw f32); ``multi``: a tile kernel of several passes,
    its trunk read to F; ``stream``: f32 past the tile (width 512), every
    layer's outputs through device memory."""

    np: int
    passes: int
    stages: Tuple[int, int, int]
    smem_bytes: Tuple[int, int, int]
    bit_words: int
    ctas: int
    acc_registers: int
    held_registers: int
    a_registers: int = 0
    multi: bool = False
    stream: bool = False

    @property
    def registers(self) -> int:
        """The reckoned registers of the arrays a consumer thread keeps."""
        return self.acc_registers + self.held_registers + self.a_registers


def _tc_plan_at(cfg: FusedNeRFConfig, f: int, np_: int, passes: int, multi: bool = False,
                stream: bool = False) -> TcPlan:
    pc = panel_cols(cfg.compute_dtype)
    pe, de = -(-cfg.pos_enc_dim // pc), -(-cfg.dir_enc_dim // pc)
    p = 0 if stream else -(-max(f, 2 * np_ * passes) // pc)
    bf16 = cfg.compute_dtype == torch.bfloat16
    # the forward's tiles: the activations (every pass's columns; none where
    # it streams) and the encodings, one tile for both in a tile kernel of
    # several passes, else one each; its widest stage a pass of fc_8 (2 NP +
    # 8 rows); the chain's tiles the dz tile and one panel, its stages 2 NP
    # rows, 128 for the input-grad products; 128 bytes a row; a streaming
    # kernel's sink after the ring
    enc = max(pe, de) if multi and not stream else pe + de
    extra = _TC_TRASH if stream else 0
    cuts = (((p + enc) * _TC_PANEL + extra, 2 * np_ + _TC_SIGMA_ROWS), ((p + 1) * _TC_PANEL + extra, 2 * np_),
            ((p + 1) * _TC_PANEL + extra, max(2 * np_, _TC_EXTRA)))
    ctas = 2 if bf16 and np_ <= _TC_PAIR_MAX else 1
    # the chain with input grads keeps one CTA an SM
    blocks = [_SMEM_PER_SM // 2 - 1024 if ctas == 2 else _SMEM_LIMIT] * 2 + [_SMEM_LIMIT]
    stages = tuple(min(_TC_MAX_STAGES, (block - _TC_SLACK - tiles) // (rows * 128))
                   for block, (tiles, rows) in zip(blocks, cuts))
    smem = tuple(_TC_SLACK + tiles + n * rows * 128 for n, (tiles, rows) in zip(stages, cuts))
    words = passes * -(-(np_ // 2) // 32)
    if bf16:
        return TcPlan(np_, passes, stages, smem, words, ctas, np_ // 2, (passes - 1) * np_ // 4, 0, multi, stream)
    # f32: product_f32 sums a slice in a second accumulator beside the pass's
    held = (F32_PASS_CAP[np_] - 1) * np_ // 2 if multi else 0
    return TcPlan(np_, passes, stages, smem, words, ctas, np_, held, 12 + (64 if stream else 0), multi, stream)


def _f32_candidates(f: int):
    """f32's plans in ``choose_f32``'s order, ``(np, passes, multi,
    stream)``: one pass of C = F / 2 at F % 64 == 0 up to 256 (path A's
    engine); up to width 512 the tile kernel of several passes that covers
    C in the fewest columns (on a tie the fewest passes); streaming at NP
    96 or 64, whichever covers C in fewer columns (96 on a tie)."""
    c = f // 2
    out = [(c, 1, False, False)] if f % 64 == 0 and c <= _TC_PASS_CAP else []
    if f <= _TC_F32_TILE_MAX:
        tiles = [(np_ * -(-c // np_), -(-c // np_), np_) for np_, cap in F32_PASS_CAP.items() if -(-c // np_) <= cap]
        if tiles:
            _, passes, np_ = min(tiles)
            out.append((np_, passes, True, False))
    np_ = min(_TC_STREAM_NP, key=lambda n: n * -(-c // n))
    return out + [(np_, -(-c // np_), False, True)]


def tc_plan(cfg: FusedNeRFConfig, stash: bool = True) -> Optional[TcPlan]:
    """The tensor-core general route's plan of ``cfg``, or None where the
    route does not take it: every padded width F % 32 == 0 up to
    :data:`MAX_FEAT`, encodings up to :data:`MAX_ENC` columns, every
    kernel's ring two stages deep. bf16, C = F / 2 columns a warpgroup: up
    to 128 one pass of C rounded up to 16; else ceil(C / 128) passes of C /
    passes rounded up to 16, at least 96 (the widths of two passes of 128,
    480 and 512, in one pass of 256 where its ring keeps two stages, but
    for kernel 1, the forward alone: ``stash`` False). f32: the first of
    :func:`_f32_candidates` that fits."""
    if cfg.compute_dtype not in DTYPES:
        return None
    f = padded_config(cfg).feat_dim
    if f > MAX_FEAT or max(cfg.pos_enc_dim, cfg.dir_enc_dim) > MAX_ENC:
        return None
    c = f // 2
    if cfg.compute_dtype == torch.float32:
        candidates = _f32_candidates(f)
    elif c <= _TC_PASS_CAP:
        candidates = [(-(-c // 16) * 16, 1)]
    else:
        passes = -(-c // _TC_PASS_CAP)
        np_ = max(_TC_PASS_MIN, -(-(-(-c // passes)) // 16) * 16)
        merge = stash and passes == 2 and np_ == _TC_PASS_CAP
        candidates = ([(2 * _TC_PASS_CAP, 1)] if merge else []) + [(np_, passes)]
    for np_, passes, *flags in candidates:
        multi, stream = flags or (_TC_PASS_MIN <= np_ <= _TC_PASS_CAP, False)
        plan = _tc_plan_at(cfg, f, np_, passes, multi, stream)
        if min(plan.stages) >= 2:
            return plan
    return None


def tc_stages(cfg: FusedNeRFConfig) -> Optional[Tuple[int, int, int]]:
    """Depth of the weight ring of the tensor-core general route's kernels
    (:func:`tc_plan`): ``(forward, chain, chain with input grads)``, or None
    where the route does not take ``cfg``."""
    plan = tc_plan(cfg)
    return None if plan is None else plan.stages


def tc_pass_rows(cfg: FusedNeRFConfig, stash: bool = True) -> Tuple[List[int], List[int]]:
    """Rows a column pass of each matrix of :func:`tc_matrices` (its image
    is one panel image a pass): forward, the trunk 2 NP, fc_8 2 NP + 8, fc_9
    NP, fc_out 8; chain, fc_out NP, the input-grad products 128, the others
    2 NP; at :func:`tc_plan`'s passes for ``stash``."""
    np_ = tc_plan(cfg, stash).np
    forward = [2 * np_] * 8 + [2 * np_ + _TC_SIGMA_ROWS, np_, 8]
    chain = [_TC_EXTRA] + [2 * np_] * 9 + [np_, _TC_EXTRA, _TC_EXTRA]
    return forward, chain


def tc_matrices(params: Params, cfg: FusedNeRFConfig, stash: bool = True):
    """``(forward, chain)`` matrices of the tensor-core general route in
    ``cfg.compute_dtype``, before the panel images, from the public tree
    padded by :func:`pad_params` to F, at :func:`tc_plan`'s passes (NP
    columns a warpgroup, ``passes`` of them). ``forward``: per layer B =
    W^T, rows its outputs in pass order, an F-wide layer's padded to passes
    x 2 NP (fc_8 a pass's 2 NP feature rows, then sigma and 7 zero rows;
    fc_9 passes x NP; fc_out 8), columns its inputs, each segment padded to
    a 64-column slice: fc_5's ``[h4, pe]`` (the encoding last), fc_9's
    ``[features, de]``. ``chain``: 13 matrices B = W, rows the layer's
    inputs (F padded to passes x 2 NP), columns its outputs, each segment
    padded to 64: fc_out (passes x NP, 64); fc_9's feature rows; fc_8 with
    sigma first in the slice after the features'; fc_5's h4 rows; the
    others W; index 0 fc_in's pe rows, 11 fc_5's pe rows and 12 fc_9's de
    rows, each padded to 128 rows (the input-grad products). ``stash``
    False: kernel 1's passes."""
    plan = tc_plan(cfg, stash)
    if plan is None:
        raise ValueError(f"the tensor-core general route does not take {cfg}")
    dt = cfg.compute_dtype
    fp, p, d = padded_config(cfg).feat_dim, cfg.pos_enc_dim, cfg.dir_enc_dim
    pp, dp, hp, kp = _round64(p), _round64(d), _round64(fp // 2), _round64(fp)
    rows, rows9 = 2 * plan.np * plan.passes, plan.np * plan.passes
    w = {name: t["w"].detach().to(dt) for name, t in pad_params(params, cfg).items()}
    w8 = torch.cat([w["fc_8"][:, 1:], w["fc_8"][:, :1]], dim=1)  # [features, sigma]
    feats = _pad(w8[:, :fp].t(), rows, kp).reshape(plan.passes, 2 * plan.np, kp)
    sigma = _pad(w8[:, fp:].t(), _TC_SIGMA_ROWS, kp).expand(plan.passes, _TC_SIGMA_ROWS, kp)
    fwd = {
        "fc_in": _pad(_pad(w["fc_in"], pp, fp).t(), rows, pp),
        "fc_5": _pad(torch.cat([_pad(w["fc_5"][p:], kp, fp), _pad(w["fc_5"][:p], pp, fp)]).t(), rows, kp + pp),
        "fc_8": torch.cat([feats, sigma], dim=1).reshape(-1, kp),
        "fc_9": _pad(torch.cat([_pad(w["fc_9"][:fp], kp, fp // 2), _pad(w["fc_9"][fp:], dp, fp // 2)]).t(),
                     rows9, kp + dp),
        "fc_out": _pad(_pad(w["fc_out"], hp, 3).t(), 8, hp),
    }
    forward = [fwd[name] if name in fwd else _pad(w[name].t(), rows, kp) for name in LAYER_NAMES]
    chain = {
        "fc_in": _pad(w["fc_in"], _TC_EXTRA, kp),
        "fc_5": _pad(w["fc_5"][p:], rows, kp),
        "fc_8": _pad(torch.cat([_pad(w8[:, :fp], fp, kp), w8[:, fp:]], dim=1), rows, kp + 64),
        "fc_9": _pad(w["fc_9"][:fp], rows, hp),
        "fc_out": _pad(w["fc_out"], rows9, 64),
    }
    chains = [chain[name] if name in chain else _pad(w[name], rows, kp) for name in LAYER_NAMES]
    chains += [_pad(w["fc_5"][:p], _TC_EXTRA, kp), _pad(w["fc_9"][fp:], _TC_EXTRA, hp)]
    return [t.contiguous() for t in forward], [t.contiguous() for t in chains]


# ---------------------------------------------------------------------------
# the general route's dW GEMM (csrc/nerf_dw_tc.cuh): 128 x N tiles of each
# layer's dW over slices of the points, on wgmma from TMA-loaded stash tiles

_DW_SLICE = 4096  # points a CTA sums
_DW_MIN_SLICE = 1024
_DW_SMS = 132
_DW_WAVES = 8  # CTAs of a launch: at most _DW_WAVES x _DW_SMS
_DW_PANEL = 64 * 128
_DW_MAX_N = {torch.bfloat16: 256, torch.float32: 128}
# a CTA's shared memory: the ring (bf16: 4 stages of 2 A boxes and up to 4
# dZ boxes; f32: 2 stages of 4 f32 boxes), f32's bf16 pieces of two
# 32-point half-stages, the barriers and up to 1023 bytes to align
_DW_SMEM = {torch.bfloat16: 4 * 6 * _DW_PANEL + 1024 + 2 * 4 * 8,
            torch.float32: 2 * 8 * _DW_PANEL + 3 * 4 * _DW_PANEL + 1024 + 2 * 2 * 8}
# the stash activations, in carve_stash's order, and each layer's A segments
STASH_ACTS = ("pe", "de", "h0", "h1", "h2", "h3", "h4", "h5", "h6", "h7", "features", "h9")
DW_SEGMENTS = (("pe",), ("h0",), ("h1",), ("h2",), ("h3",), ("pe", "h4"), ("h5",), ("h6",), ("h7",),
               ("features", "de"), ("h9",))
# the dW GEMM's planted faults (nerf_dw::Fault), for chip_smoke.py's checks
DW_FAULTS = {"slice_skipped": 1, "db_dropped": 2, "swizzle_off_by_one_chunk": 3, "f32_low_piece_dropped": 4,
             "f32_low_and_mid_pieces_dropped": 5}


def stash_widths(cfg: FusedNeRFConfig) -> Tuple[Dict[str, int], List[int]]:
    """Columns of the general route's row-major stashes (``nerf_stash.cuh``'s
    ``act_width``, ``dz_width``): ``({activation: width}, [each
    layer's dz width])``, F the padded width, the encodings padded to 16,
    fc_8's dz F + 16 (features, sigma, zeros), fc_out's 16."""
    f = padded_config(cfg).feat_dim
    acts = dict.fromkeys(STASH_ACTS, f)
    acts.update(pe=_round16(cfg.pos_enc_dim), de=_round16(cfg.dir_enc_dim), h9=f // 2)
    return acts, [f] * 8 + [f + 16, f // 2, 16]


@dataclasses.dataclass(frozen=True)
class DwJob:
    """One CTA's tile: rows ``[128 kb, 128 kb + 128)`` of A segment ``seg``
    of ``layer`` (``row_off`` its first row in the layer's grad) by dz
    columns ``[col0, col0 + n)``; ``kbi`` the row block over both
    segments (0: the tile sums db)."""

    layer: int
    seg: int
    kb: int
    kbi: int
    col0: int
    n: int
    row_off: int
    width: int  # the segment's columns


@dataclasses.dataclass(frozen=True)
class DwPlan:
    jobs: Tuple[DwJob, ...]
    splits: int  # slices
    chunk: int  # points a slice
    points: int
    smem_bytes: int
    workspace_bytes: int
    window: int  # slices a launch
    windows: int  # launches

    def slices(self) -> List[Tuple[int, int]]:
        """Each slice's points ``[begin, end)``, in order."""
        return [(s * self.chunk, min(self.points, (s + 1) * self.chunk)) for s in range(self.splits)]

    def order(self) -> List[Tuple[int, int]]:
        """``(slice, job)`` of each CTA in launch order: a launch a window
        of ``window`` slices, its grid (jobs, slices), the job fastest, so
        every tile of a slice starts before the next slice's and walks it
        beside them."""
        return [(s, j) for s in range(self.splits) for j in range(len(self.jobs))]


def _dw_n_tiles(nwidth: int, maxn: int) -> List[Tuple[int, int]]:
    """``(col0, n)`` of the column tiles of a dz of ``nwidth`` columns:
    ``maxn``-wide ones, then the rest in 64s as 128 and 64."""
    w64 = -(-nwidth // 64) * 64
    out = [(c, maxn) for c in range(0, w64 - w64 % maxn, maxn)]
    col, rem = w64 - w64 % maxn, w64 % maxn
    if rem >= 128:
        out.append((col, 128))
        col, rem = col + 128, rem - 128
    if rem:
        out.append((col, 64))
    return out


def dw_tc_plan(cfg: FusedNeRFConfig, points: int) -> DwPlan:
    """The Python twin of ``nerf_dw::make_plan`` for ``points`` points: the
    jobs, layer by layer, row block by row block, column tiles fastest; the
    slices (``_DW_SLICE`` points, fewer where two waves of CTAs over 132
    SMs would not fill the card, at least ``_DW_MIN_SLICE``, a multiple of
    64) in windows of at most ``_DW_WAVES`` waves of CTAs, a launch each;
    a CTA's shared memory and the partials' workspace bytes (one ``128 x
    maxN + maxN`` f32 partial a (job, slice of a window) in each of two
    buffers, one where there is one window)."""
    dt = cfg.compute_dtype
    maxn = _DW_MAX_N[dt]
    acts, dzs = stash_widths(cfg)
    jobs = []
    for layer, (segs, nwidth) in enumerate(zip(DW_SEGMENTS, dzs)):
        tiles = _dw_n_tiles(nwidth, maxn)
        kbi, row_off = 0, 0
        for seg, name in enumerate(segs):
            for kb in range(-(-acts[name] // 128)):
                jobs.extend(DwJob(layer, seg, kb, kbi, col0, n, row_off, acts[name]) for col0, n in tiles)
                kbi += 1
            row_off += acts[name]
    m = max(points, 1)
    splits = -(-m // _DW_SLICE)
    splits = max(splits, min(-(-2 * _DW_SMS // len(jobs)), -(-m // _DW_MIN_SLICE)))
    chunk = -(-(-(-m // splits)) // 64) * 64
    splits = -(-m // chunk)
    windows = -(-splits // max(1, _DW_WAVES * _DW_SMS // len(jobs)))
    window = -(-splits // windows)
    part = 4 * (128 * maxn + maxn)
    buffers = min(windows, 2)
    return DwPlan(tuple(jobs), splits, chunk, m, _DW_SMEM[dt], -(-buffers * len(jobs) * window * part // 256) * 256,
                  window, windows)


def bf16_pieces(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 pieces of f32 ``x`` (``nerf_mlp_tc.cuh``'s
    ``split3``): ``x0 = bf16(x)``, ``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0
    - x1)``, each remainder exact in f32, so that ``x0 + x1 + x2 == x`` for
    a normal ``x`` (24 significand bits in three of 8)."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return x0, x1, (r - x1.float()).to(torch.bfloat16)


def tc_panel_image(mat: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """``(R, C)`` with ``C % 64 == 0`` -> the flat image the tensor-core
    route's weight ring copies as it is, one image a column pass of
    ``rows`` rows (all R rows by default), pass after pass: bf16,
    :func:`panel_image`; f32, each 64-column K-slice as the panel images of
    its three :func:`bf16_pieces`, the smallest first (``x2, x1, x0``: the
    kernel adds a slice's small products before its leading one)."""
    if rows is not None and rows < mat.shape[0]:
        return torch.cat([tc_panel_image(block) for block in mat.split(rows)])
    if mat.dtype == torch.bfloat16:
        return panel_image(mat)
    rows, cols = mat.shape
    parts = [panel_image(piece).reshape(cols // 64, rows * 64) for piece in reversed(bf16_pieces(mat))]
    return torch.stack(parts, dim=1).reshape(-1)


def tc_images(mats, rows) -> List[torch.Tensor]:
    """The :func:`tc_panel_image` of each matrix at its rows a pass."""
    return [tc_panel_image(m, r) for m, r in zip(mats, rows)]


def tc_biases(params: Params, cfg: FusedNeRFConfig, stash: bool = True) -> List[torch.Tensor]:
    """The biases of :func:`general_biases` (the forward's column order),
    zero-padded to every column of their layer's passes (:func:`tc_plan`:
    passes x 2 NP, fc_8 also its sigma group, fc_9 passes x NP): the
    kernels add a bias to each column of a pass, the padding's too."""
    plan = tc_plan(cfg, stash)
    cover = [2 * plan.np * plan.passes] * 9 + [plan.np * plan.passes, 8]
    return [torch.nn.functional.pad(b, (0, max(0, n - b.shape[0]))).contiguous()
            for b, n in zip(general_biases(params, cfg), cover)]


def tc_layout(params: Params, cfg: FusedNeRFConfig):
    """``(forward images, biases, chain images)`` the tensor-core general
    route's kernels read, of the parameters as they are at this call: the
    images of :func:`tc_matrices` pass by pass (:func:`tc_pass_rows`), the
    biases of :func:`tc_biases`."""
    forward, chain = tc_matrices(params, cfg)
    fwd_rows, chain_rows = tc_pass_rows(cfg)
    return tc_images(forward, fwd_rows), tc_biases(params, cfg), tc_images(chain, chain_rows)


def forward_layout(params: Params, cfg: FusedNeRFConfig):
    """``(forward images, biases)`` of the ``wgmma`` route: the
    :func:`panel_image` of each layer's forward matrix of
    :func:`training_matrices` and its bias in that matrix's row order (no
    chain images: the forward does not read them)."""
    mats = training_matrices(params, cfg)
    return [panel_image(fwd) for fwd, _, _ in mats], [b.contiguous() for _, b, _ in mats]


def prepare(params, cfg: FusedNeRFConfig) -> KernelWeights:
    """Public params -> :class:`KernelWeights` (idempotent): for parameters
    on the card, :func:`kernel_weights` of :func:`forward_route`, built once
    here, not on every launch."""
    if isinstance(params, KernelWeights):
        return params
    if params["fc_in"]["w"].device.type != "cuda":
        return KernelWeights(public=params, route=None, weights=None, biases=None)
    return kernel_weights(params, cfg, forward_route(cfg))


def kernel_weights(params: Params, cfg: FusedNeRFConfig, route: str) -> KernelWeights:
    """The forward's weight layout of ``route`` on the parameters' device:
    ``wgmma``, the forward images and biases of :func:`forward_layout`;
    ``wgmma_general`` and ``f32_wgmma``, the forward images and biases of
    :func:`tc_layout` at kernel 1's own passes (:func:`tc_plan`, ``stash``
    False). Each call counts one of ``tracing``'s ``layout_builds`` and
    its ``layout_bytes``."""
    if route == "wgmma":
        images, biases = forward_layout(params, cfg)
    elif route in TC_ROUTES:
        forward, _ = tc_matrices(params, cfg, stash=False)
        images, biases = tc_images(forward, tc_pass_rows(cfg, stash=False)[0]), tc_biases(params, cfg, stash=False)
    else:
        raise ValueError(f"unknown forward route {route!r}; routes are {ROUTES}")
    tracing.add("layout_builds", 1)
    tracing.add("layout_bytes", sum(x.nbytes for x in (*images, *biases)))
    return KernelWeights(public=params, route=route, weights=tuple(images), biases=tuple(biases))


# ---------------------------------------------------------------------------
# the wrappers


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/fused_nerf_fwd.cu``, or from an earlier version of it (which may
    have a ``fused_nerf_fwd_general``, not declared here, or no
    ``fused_nerf_fwd_layout`` and one entry, ``fused_nerf_fwd``, reading
    fragment order)."""
    args = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 9)
    lib.fused_nerf_fwd.argtypes = args + [ctypes.c_void_p]
    lib.fused_nerf_fwd.restype = ctypes.c_int
    if hasattr(lib, "fused_nerf_fwd_layout"):
        lib.fused_nerf_fwd_layout.argtypes = []
        lib.fused_nerf_fwd_layout.restype = ctypes.c_int
    lib.fused_nerf_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_nerf_fwd_error_string.restype = ctypes.c_char_p
    return lib


def library_layout(lib: ctypes.CDLL) -> int:
    """What ``lib.fused_nerf_fwd`` reads: :data:`LAYOUT_IMAGES` or, for a
    library without ``fused_nerf_fwd_layout``, :data:`LAYOUT_FRAGMENTS`."""
    return lib.fused_nerf_fwd_layout() if hasattr(lib, "fused_nerf_fwd_layout") else LAYOUT_FRAGMENTS


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_nerf_bwd.cu``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    args = ([ctypes.c_void_p] * 4 + [ptrs] * 3 + [ctypes.c_void_p] + [ptrs] * 2
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7)
    lib.fused_nerf_bwd.argtypes = args + [ctypes.c_void_p]
    lib.fused_nerf_bwd.restype = ctypes.c_int
    lib.fused_nerf_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 2
    lib.fused_nerf_bwd_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_nerf_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_nerf_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.fused_nerf_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_nerf_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bind_tc(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_tc_fwd.cu``: ``fused_tc_fwd``
    (``fused_nerf_fwd``'s arguments, the padded encodings' widths, f32 and
    kernel 1's scratch of ``fused_tc_fwd_workspace_bytes``);
    ``fused_tc_takes`` and ``fused_tc_plan``, the C++ side of
    :func:`tc_plan`."""
    args = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 10)
    lib.fused_tc_fwd.argtypes = args + [ctypes.c_void_p] * 2
    lib.fused_tc_fwd.restype = ctypes.c_int
    lib.fused_tc_fwd_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_tc_fwd_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_tc_takes.argtypes = [ctypes.c_int] * 6
    lib.fused_tc_takes.restype = ctypes.c_int
    lib.fused_tc_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_tc_plan.restype = None
    lib.fused_tc_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_tc_fwd_error_string.restype = ctypes.c_char_p
    return lib


def bind_tc_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/fused_tc_bwd.cu`` (kernel 2; the
    dW GEMM alone, :func:`general_dw`)."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    args = ([ctypes.c_void_p] * 4 + [ptrs] * 3 + [ctypes.c_void_p] + [ptrs] * 2
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10)
    lib.fused_nerf_bwd_tc.argtypes = args + [ctypes.c_void_p]
    lib.fused_nerf_bwd_tc.restype = ctypes.c_int
    lib.fused_nerf_bwd_tc_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_nerf_bwd_tc_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_tc_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_tc_bwd_error_string.restype = ctypes.c_char_p
    # the dW GEMM alone, its plan and its planted faults
    lib.fused_general_dw.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p, ptrs, ptrs,
                                                                               ctypes.c_void_p]
    lib.fused_general_dw.restype = ctypes.c_int
    lib.fused_general_dw_workspace_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_general_dw_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_general_dw_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_general_dw_plan.restype = None
    lib.fused_tc_bwd_set_dw_fault.argtypes = [ctypes.c_int]
    lib.fused_tc_bwd_set_dw_fault.restype = None
    lib.fused_tc_bwd_dw_launches.argtypes = []
    lib.fused_tc_bwd_dw_launches.restype = ctypes.c_longlong
    return lib


def _library() -> ctypes.CDLL:
    return bind(build.load(KERNEL))


def _tc_library() -> ctypes.CDLL:
    return bind_tc(build.load(KERNEL_TC))


def _tc_bwd_library() -> ctypes.CDLL:
    return bind_tc_bwd(build.load(KERNEL_TC_BWD))


def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(build.load(KERNEL_BWD))


def pointers(tensors: Sequence[torch.Tensor]):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


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
    dtype = ROUTE_DTYPE.get(w.route)
    if ((dtype is not None and dtype != cfg.compute_dtype) or (w.route == "wgmma" and forward_route(cfg) != "wgmma")
            or (w.route in TC_ROUTES and tc_stages(cfg) is None)):
        raise ValueError(f"route {w.route!r} does not take this config (its route is {forward_route(cfg)!r})")
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (M, 3), got {tuple(pts.shape)}")
    check_tensor("pts", pts, tuple(pts.shape))
    check_tensor("dirs", dirs, tuple(pts.shape))
    if pts.device != dirs.device:
        raise ValueError("pts and dirs must be on the same device")
    if w.weights is None or w.weights[0].device != pts.device:
        raise ValueError("the network's parameters must be on the same CUDA device as pts")


def kernel_dims(cfg: FusedNeRFConfig) -> list:
    """The C interface's config arguments: feat (padded to 32 for the
    general route), the levels, include_input, the encodings' widths and
    their widths padded to 16."""
    feat = padded_config(cfg).feat_dim
    return [feat, cfg.coord_encode_level, cfg.dir_encode_level, int(cfg.include_input), cfg.pos_enc_dim,
            cfg.dir_enc_dim, _round16(cfg.pos_enc_dim), _round16(cfg.dir_enc_dim)]


def _launch(w: KernelWeights, pts: torch.Tensor, dirs: torch.Tensor, cfg: FusedNeRFConfig):
    """Launch the forward kernel of ``w``'s route on the current stream."""
    _check_inputs(pts, dirs, w, cfg)
    m = pts.shape[0]
    sigma = torch.empty((m,), dtype=torch.float32, device=pts.device)
    rgb = torch.empty((m, 3), dtype=torch.float32, device=pts.device)
    if m == 0:
        return sigma, rgb
    if w.route == "wgmma":
        lib = _library()
        if library_layout(lib) != LAYOUT_IMAGES:
            raise ValueError("this library's fused_nerf_fwd reads fragment order, not the wgmma route's images")
        entry, error_string, extra = lib.fused_nerf_fwd, lib.fused_nerf_fwd_error_string, []
    else:
        lib = _tc_library()
        entry, error_string = lib.fused_tc_fwd, lib.fused_tc_fwd_error_string
        dims, f32 = kernel_dims(cfg), int(cfg.compute_dtype == torch.float32)
        # kernel 1's scratch where it streams its layers (f32 past 512)
        nbytes = lib.fused_tc_fwd_workspace_bytes(m, dims[0], dims[6], dims[7], f32)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=pts.device) if nbytes else None
        extra = [f32, scratch.data_ptr() if nbytes else None]
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = entry(pts.data_ptr(), dirs.data_ptr(), pointers(w.weights), pointers(w.biases),
                    sigma.data_ptr(), rgb.data_ptr(), m, *kernel_dims(cfg), *extra, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"fused_nerf_fwd ({w.route}) launch failed: {msg} (cudaError {err})")
    launch_count.count(fused_nerf_apply, m)
    fused_nerf_apply.route_launches[w.route] += 1
    return sigma, rgb


def swizzle128(row, col):
    """Byte offset of bf16 element ``(row, col)`` in a 64-column panel of
    128-byte rows under ``wgmma``'s 128-byte swizzle: the 16-byte chunk
    ``col // 8`` of row ``r`` sits at chunk ``(col // 8) ^ (r % 8)``
    (``csrc/nerf_mlp_train.cuh``'s ``swizzle128``). Takes ints or integer
    tensors."""
    return row * 128 + ((col // 8) ^ (row % 8)) * 16 + (col % 8) * 2


_PANEL_INDEX: Dict[Tuple[int, str], torch.Tensor] = {}


def _panel_index(rows: int, device) -> torch.Tensor:
    """Element offset in a panel of each (row, column) of a (rows, 64)
    slice, row-major; one tensor per shape and device."""
    key = (rows, str(device))
    if key not in _PANEL_INDEX:
        r = torch.arange(rows, device=device)[:, None]
        c = torch.arange(64, device=device)[None, :]
        _PANEL_INDEX[key] = (swizzle128(r, c) // 2).reshape(-1)
    return _PANEL_INDEX[key]


def panel_image(mat: torch.Tensor) -> torch.Tensor:
    """``(R, C)`` with ``C % 64 == 0`` -> the flat image the training kernels
    copy into shared memory as it is: K-slice ``s`` (columns ``[64s, 64s +
    64)`` of every row, 128 bytes a row, at :func:`swizzle128`) after slice
    ``s - 1``."""
    rows, cols = mat.shape
    src = mat.reshape(rows, cols // 64, 64).permute(1, 0, 2).reshape(cols // 64, rows * 64)
    out = torch.empty_like(src)
    out[:, _panel_index(rows, mat.device)] = src
    return out.reshape(-1)


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _round64(n: int) -> int:
    return -(-n // 64) * 64


def training_matrices(params: Params, cfg: FusedNeRFConfig):
    """Per layer ``(forward, bias, chain)`` in bf16, before the swizzle:
    ``forward`` the padded W^T (rows: the layer's outputs, fc_8's sigma
    moved after its features; columns: its inputs in the kernel's K order,
    each concatenated segment padded to 64), ``bias`` in the same row order,
    ``chain`` the padded W the backward's ``dh = dz W^T`` reads (rows: the
    inputs, fc_5's pe and fc_9's de rows after the others; columns: the
    outputs in the forward's order, padded to 64)."""
    f, p, d = cfg.feat_dim, cfg.pos_enc_dim, cfg.dir_enc_dim
    out = []
    for name in LAYER_NAMES:
        w = params[name]["w"].detach().to(torch.bfloat16)
        b = params[name]["b"].detach().to(torch.bfloat16)
        if name == "fc_in":
            w = _pad(w, 64, f)
            fwd, chain = w.t(), w
        elif name == "fc_5":  # inputs [pe, h4]
            pe = _pad(w[:p], 64, f)
            fwd, chain = torch.cat([pe, w[p:]]).t(), torch.cat([w[p:], pe])
        elif name == "fc_8":  # outputs [sigma, features] -> [features, sigma]
            w = torch.cat([w[:, 1:], w[:, :1]], dim=1)
            b = torch.nn.functional.pad(torch.cat([b[1:], b[:1]]), (0, 7))
            fwd, chain = _pad(w.t(), f + 8, f), _pad(w, f, f + 64)
        elif name == "fc_9":  # inputs [features, de]
            w = torch.cat([w[:f], _pad(w[f:], 64, f // 2)])
            fwd, chain = w.t(), _pad(w, f + 64, _round64(f // 2))
        elif name == "fc_out":
            b = torch.nn.functional.pad(b, (0, 5))
            fwd, chain = _pad(w.t(), 8, _round64(f // 2)), _pad(w, f // 2, 64)
        else:
            fwd, chain = w.t(), w
        out.append((fwd, b, chain))
    return out


def training_layout(params: Params, cfg: FusedNeRFConfig):
    """``(forward images, biases, chain images)`` of the parameters as they
    are at this call (an optimizer step reaches the next launch): the
    :func:`panel_image` of each layer's :func:`training_matrices`."""
    mats = training_matrices(params, cfg)
    return ([panel_image(fwd) for fwd, _, _ in mats], [b.contiguous() for _, b, _ in mats],
            [panel_image(chain) for _, _, chain in mats])


def empty_grads(params: Params) -> Params:
    """f32 tensors of the public parameter shapes, for a kernel to fill."""
    return {
        name: {leaf: torch.empty(t.shape, dtype=torch.float32, device=t.device) for leaf, t in p.items()}
        for name, p in params.items()
    }


def _launch_bwd(params: Params, pts, dirs, g_sigma, g_rgb, cfg: FusedNeRFConfig):
    """Launch the backward kernel of :func:`train_route` on the current
    stream."""
    route = train_route(cfg)
    m = pts.shape[0]
    for name, t, shape in (("pts", pts, (m, 3)), ("dirs", dirs, (m, 3)),
                           ("g_sigma", g_sigma, (m,)), ("g_rgb", g_rgb, (m, 3))):
        check_tensor(name, t, shape)
    if params["fc_in"]["w"].device != pts.device:
        raise ValueError("the network's parameters must be on the same CUDA device as pts")
    dpts = torch.empty_like(pts)
    ddirs = torch.empty_like(dirs)
    if m == 0:
        return {n: {k: torch.zeros_like(t, dtype=torch.float32) for k, t in p.items()}
                for n, p in params.items()}, dpts, ddirs
    if route == "wgmma":
        lib = _bwd_library()
        error_string = lib.fused_nerf_bwd_error_string
        grads, err = _launch_bwd_wgmma(lib, params, pts, dirs, g_sigma, g_rgb, cfg, dpts, ddirs)
    else:
        lib = _tc_bwd_library()
        error_string = lib.fused_tc_bwd_error_string
        dw_before = lib.fused_tc_bwd_dw_launches()
        grads, err = _launch_bwd_tc(lib, params, pts, dirs, g_sigma, g_rgb, cfg, dpts, ddirs)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"fused_nerf_bwd ({route}) launch failed: {msg} (cudaError {err})")
    launch_count.count(fused_nerf_bwd, m)
    fused_nerf_bwd.route_launches[route] += 1
    if route != "wgmma":
        count_dw(route, m, lib.fused_tc_bwd_dw_launches() - dw_before)
        grads = grads_from_general(*grads, cfg)
    return grads, dpts, ddirs


def count_dw(route: str, points: int, launches: int) -> None:
    """``launches`` launches of the general route's dW GEMM kernel over
    ``points`` (inside a kernel 2 or 3 launch of ``route``, or alone by
    :func:`general_dw`), as the library counted them where it launched
    them (its ``*_dw_launches``, read before and after the call)."""
    for _ in range(launches):
        launch_count.count(dw_gemm, points)
    dw_gemm.route_launches[route] += launches


def stash_views(workspace: torch.Tensor, points: int, cfg: FusedNeRFConfig):
    """The general route's stashes at the start of a kernel 2 or 3
    workspace (``nerf_stash.cuh``'s ``carve_stash``: each activation,
    then each layer's dz, ``(m_pad, width)`` row-major in the compute type,
    256-byte aligned, m_pad ``points`` rounded up to 64), as ``({activation:
    (points, width)}, [each layer's dz (points, width)])`` views."""
    acts, dzs = stash_widths(cfg)
    size = torch.empty((), dtype=cfg.compute_dtype).element_size()
    mp = -(-points // 64) * 64
    off, views = 0, []
    for width in list(acts.values()) + dzs:
        nbytes = mp * width * size
        views.append(workspace[off:off + nbytes].view(cfg.compute_dtype).view(mp, width)[:points])
        off += -(-nbytes // 256) * 256
    return dict(zip(acts, views[:len(acts)])), views[len(acts):]


def stash_nbytes(points: int, cfg: FusedNeRFConfig) -> int:
    """Bytes of the stashes :func:`stash_views` reads (``nerf_stash.cuh``'s
    ``stash_bytes``)."""
    acts, dzs = stash_widths(cfg)
    size = torch.empty((), dtype=cfg.compute_dtype).element_size()
    mp = -(-points // 64) * 64
    return sum(-(-mp * w * size // 256) * 256 for w in list(acts.values()) + dzs)


def general_stash(params: Params, pts, dirs, g_sigma, g_rgb, cfg: FusedNeRFConfig) -> torch.Tensor:
    """Kernel 2 on the config's general route, its workspace kept: the
    stashes of ``pts`` at its start (:func:`stash_views`), for the dW
    GEMM's checks and timings (:func:`general_dw`). Not counted as a
    launch of kernel 2."""
    route = train_route(cfg)
    if route == "wgmma":
        raise ValueError(f"{cfg} is not on a general route")
    lib = _tc_bwd_library()
    dims = kernel_dims(cfg)
    nbytes = lib.fused_nerf_bwd_tc_workspace_bytes(pts.shape[0], dims[0], dims[6], dims[7],
                                                    int(cfg.compute_dtype == torch.float32))
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=pts.device)
    _, err = _launch_bwd_tc(lib, params, pts, dirs, g_sigma, g_rgb, cfg, torch.empty_like(pts),
                            torch.empty_like(dirs), workspace=workspace)
    if err != 0:
        raise RuntimeError(f"fused_nerf_bwd ({route}, stash) launch failed: {lib.fused_tc_bwd_error_string(err).decode()}")
    return workspace


def general_dw(workspace: torch.Tensor, points: int, cfg: FusedNeRFConfig):
    """The general route's dW GEMM alone (``csrc/nerf_dw_tc.cuh``) over the
    stashes at the start of ``workspace`` (:func:`general_stash`, or any
    bytes laid out as :func:`stash_views` says): ``(grads_w, grads_b)`` in
    the kernel layout (:func:`general_grad_shapes`), f32. Launches on the
    current stream or raises; no plain path (the plain version is
    ``backward_from_activations``' products on those stashes)."""
    if workspace.device.type != "cuda":
        raise ValueError("the dW GEMM runs on the card only")
    lib = _tc_bwd_library()
    dims = kernel_dims(cfg)
    f32 = int(cfg.compute_dtype == torch.float32)
    part = torch.empty(lib.fused_general_dw_workspace_bytes(points, dims[0], dims[6], dims[7], f32),
                       dtype=torch.uint8, device=workspace.device)
    gw, gb = empty_general_grads(cfg, workspace.device)
    before = lib.fused_tc_bwd_dw_launches()
    with torch.cuda.device(workspace.device):
        stream = torch.cuda.current_stream(workspace.device).cuda_stream
        err = lib.fused_general_dw(workspace.data_ptr(), points, dims[0], dims[6], dims[7], f32, part.data_ptr(),
                                   pointers(gw), pointers(gb), stream)
    if err != 0:
        raise RuntimeError(f"dW GEMM launch failed: {lib.fused_tc_bwd_error_string(err).decode()} (cudaError {err})")
    count_dw(train_route(cfg), points, lib.fused_tc_bwd_dw_launches() - before)
    return gw, gb


def tc_plan_on_card(cfg: FusedNeRFConfig) -> Tuple[int, ...]:
    """The C++ side of :func:`tc_plan`: ``(NP, passes, the forward's, the
    chain's and the chain with input grads' stages, their shared-memory
    bytes, sign-bit words a slot, CTAs an SM, kernel 1's NP and passes, 1
    where the kernels stream)`` from the library, zeros where the route
    does not take ``cfg``."""
    lib = _tc_library()
    dims = kernel_dims(cfg)
    out = (ctypes.c_longlong * 13)()
    lib.fused_tc_plan(dims[0], dims[4], dims[5], dims[6], dims[7], int(cfg.compute_dtype == torch.float32), out)
    return tuple(out)


def dw_plan_on_card(cfg: FusedNeRFConfig, points: int) -> Tuple[int, ...]:
    """The C++ side of :func:`dw_tc_plan`: ``(tiles, slices, points a
    slice, shared memory a CTA, workspace bytes, slices a launch,
    launches)`` from the library."""
    lib = _tc_bwd_library()
    dims = kernel_dims(cfg)
    out = (ctypes.c_longlong * 7)()
    lib.fused_general_dw_plan(points, dims[0], dims[6], dims[7], int(cfg.compute_dtype == torch.float32), out)
    return tuple(out)


def _launch_bwd_wgmma(lib, params, pts, dirs, g_sigma, g_rgb, cfg, dpts, ddirs):
    m = pts.shape[0]
    smem = lib.fused_nerf_bwd_smem_bytes(cfg.feat_dim)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"feat_dim {cfg.feat_dim} needs {smem} B of shared memory per block")
    grads = empty_grads(params)
    fwd, biases, chain = training_layout(params, cfg)
    workspace = torch.empty(lib.fused_nerf_bwd_workspace_bytes(m, cfg.feat_dim), dtype=torch.uint8,
                            device=pts.device)
    flat = _flat(grads)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.fused_nerf_bwd(
            pts.data_ptr(), dirs.data_ptr(), g_sigma.data_ptr(), g_rgb.data_ptr(),
            pointers(fwd), pointers(biases), pointers(chain), workspace.data_ptr(),
            pointers(flat[0::2]), pointers(flat[1::2]), dpts.data_ptr(), ddirs.data_ptr(),
            m, *kernel_dims(cfg)[:6], stream,
        )
    return grads, err


def empty_general_grads(cfg: FusedNeRFConfig, device):
    """f32 ``(weights, biases)`` lists of :func:`general_grad_shapes`, for
    the general route's kernels to fill."""
    shapes = general_grad_shapes(cfg)
    return ([torch.empty(s, dtype=torch.float32, device=device) for s in shapes],
            [torch.empty((s[1],), dtype=torch.float32, device=device) for s in shapes])


def _launch_bwd_tc(lib, params, pts, dirs, g_sigma, g_rgb, cfg, dpts, ddirs, workspace=None):
    """Kernel 2 on the tensor-core general route, its weights laid out by
    :func:`tc_layout` at this call; a ``workspace`` given is used (and
    keeps the stash at its start)."""
    m = pts.shape[0]
    dims = kernel_dims(cfg)
    f32 = int(cfg.compute_dtype == torch.float32)
    fwd, biases, chain = tc_layout(params, cfg)
    gw, gb = empty_general_grads(cfg, pts.device)
    nbytes = lib.fused_nerf_bwd_tc_workspace_bytes(m, dims[0], dims[6], dims[7], f32)
    if workspace is None:
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=pts.device)
    elif workspace.numel() < nbytes:
        raise ValueError(f"the workspace holds {workspace.numel()} bytes, the kernel needs {nbytes}")
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.fused_nerf_bwd_tc(
            pts.data_ptr(), dirs.data_ptr(), g_sigma.data_ptr(), g_rgb.data_ptr(),
            pointers(fwd), pointers(biases), pointers(chain), workspace.data_ptr(),
            pointers(gw), pointers(gb), dpts.data_ptr(), ddirs.data_ptr(), m, *dims, f32, stream,
        )
    return (gw, gb), err


def fused_nerf_bwd(params: Params, pts, dirs, g_sigma, g_rgb, cfg: FusedNeRFConfig):
    """``(grads, dpts, ddirs)``: the backward kernel on CUDA tensors (or
    raise), :func:`fused_nerf_bwd_reference` on CPU tensors."""
    if pts.device.type == "cpu":
        return fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    return _launch_bwd(params, pts, dirs, g_sigma.contiguous(), g_rgb.contiguous(), cfg)



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
        # the layout of this call's parameters (the wgmma route: their
        # forward images), never one built before an optimizer step
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


def dw_gemm():
    """The general route's dW GEMM (``csrc/nerf_dw_tc.cuh``), launched
    inside every general-route kernel 2 and 3 launch and by
    :func:`general_dw`, ``dw_tc_plan(cfg, points).windows`` launches of
    its kernel a pass: its launch counts (``dw_gemm.launches``,
    ``.shapes`` by point count, ``.route_launches``), as the libraries
    counted them where they launched it."""


def reset_launches() -> None:
    """Set the forward's, the backward's and the dW GEMM's launch counts,
    total, by shape and by route, to 0."""
    launch_count.reset(fused_nerf_apply, fused_nerf_bwd, dw_gemm)


fused_nerf_apply.route_launches = dict.fromkeys(ROUTES, 0)
fused_nerf_bwd.route_launches = dict.fromkeys(ROUTES, 0)
dw_gemm.route_launches = dict.fromkeys(ROUTES, 0)
reset_launches()
