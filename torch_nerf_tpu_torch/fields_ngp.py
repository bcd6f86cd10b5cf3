"""Instant-NGP field: hash-grid encoding + SH view directions, and the
packed layouts' voxel-face smoothness loss.

Counterpart of ``torch_nerf_tpu/fields_ngp.py``: raw positions go into the
hash grid, the unnormalised ray directions into the SH encoder. The field
has no ``fused_cfg``, so training takes the generic autograd branch of
``train.make_ray_train_step``: one forward and one backward hash kernel a
render pass, and one more of each for the smoothness loss's probes. Where
``ops/ngp_mlp.py`` takes the config, ``prepare`` (the frame loop's, once a
frame) gives a forward-only handle whose ``apply`` is two kernels a render
pass: the hash encode, then SH, both MLPs and their activations in one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from torch_nerf_tpu_torch import encoders, tracing
from torch_nerf_tpu_torch.fields import Field
from torch_nerf_tpu_torch.models import instant_ngp
from torch_nerf_tpu_torch.models.hash_math import level_resolutions
from torch_nerf_tpu_torch.ops import ngp_mlp


def make_instant_ngp_field(
    num_level: int = 16,
    log_max_entry_per_level: int = 19,
    table_feat_dim: int = 2,
    min_res: int = 16,
    max_res: int = 512,
    density_feat_dim: int = 64,
    color_feat_dim: int = 64,
    sh_degree: int = 4,
    is_hdr: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    table_layout: str = "hash",
    use_kernel: Optional[bool] = None,
) -> Field:
    """Defaults mirror the reference's ``instant_nerf`` network and SH
    encoder. ``table_layout`` "hash" hashes each of a voxel's 8 corners
    (reference parity); "bricked" reads one 4^3-site brick row a (point,
    level); "packed" one row of the voxel's own 8 corners, and
    "packed_dual" one more from a grid staggered by half a voxel.
    ``use_kernel`` None or True takes the hash kernels on CUDA
    tensors and their plain versions on CPU tensors; False takes the plain
    versions on every device. With the kernels, in bf16, at SH degree 4,
    hidden widths 64 and an input of 32 or 64 features (``ngp_mlp.takes``),
    ``prepare`` builds an ``ngp_mlp.NgpWeights`` handle and ``apply`` of one
    takes ``ngp_mlp.ngp_mlp_fwd`` after the encode (forward only); every
    other config's ``prepare`` is the identity. ``apply`` of the public tree
    is differentiable."""
    instant_ngp.check_layout(table_layout)
    res_np = level_resolutions(num_level, min_res, max_res)
    res_on: Dict[torch.device, torch.Tensor] = {}
    view_dir_dim = encoders.sh_encoding_dim(sh_degree)
    kernel = use_kernel is None or bool(use_kernel)
    in_dim = instant_ngp.mlp_shapes(view_dir_dim, num_level, table_feat_dim, density_feat_dim, color_feat_dim,
                                    table_layout)["density_mlp"]["fc_in"][0]
    fused = kernel and ngp_mlp.takes(in_dim, density_feat_dim, color_feat_dim, sh_degree, compute_dtype)

    def resolutions(device: torch.device) -> torch.Tensor:
        if device not in res_on:
            res_on[device] = torch.as_tensor(res_np, device=device)
        return res_on[device]

    def init(generator: torch.Generator, device: Optional[torch.device] = None):
        return instant_ngp.init_instant_ngp_params(
            generator,
            view_dir_dim=view_dir_dim,
            num_level=num_level,
            log_max_entry_per_level=log_max_entry_per_level,
            table_feat_dim=table_feat_dim,
            density_feat_dim=density_feat_dim,
            color_feat_dim=color_feat_dim,
            table_layout=table_layout,
            device=device,
        )

    def apply(params, pts: torch.Tensor, dirs: torch.Tensor):
        tracing.add("points", pts.numel() // 3)
        if isinstance(params, ngp_mlp.NgpWeights):
            return fused_apply(params, pts, dirs)
        with tracing.span("field.sh"):
            dir_enc = encoders.sh_encoding(dirs, sh_degree)
        return instant_ngp.instant_ngp_apply(
            params, pts, dir_enc, resolutions(pts.device), is_hdr=is_hdr,
            compute_dtype=compute_dtype, table_layout=table_layout, use_kernel=kernel,
        )

    def fused_apply(w: ngp_mlp.NgpWeights, pts: torch.Tensor, dirs: torch.Tensor):
        batch_shape = pts.shape[:-1]
        flat_pos = pts.reshape(-1, 3).contiguous()
        with tracing.span("field.encode"):
            feats = instant_ngp.encode_features(w.tables, flat_pos, resolutions(pts.device), table_layout, in_dim)
        ray_dirs, samples = rays_of(dirs)
        with tracing.span("field.fused_mlp"):
            sigma, rgb = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples, is_hdr)
        return sigma.reshape(batch_shape), rgb.reshape(*batch_shape, 3)

    field = Field(init=init, apply=apply, name="instant_ngp" if kernel else "instant_ngp_plain")
    return dataclasses.replace(field, prepare=ngp_mlp.prepare) if fused else field


def rays_of(dirs: torch.Tensor):
    """``(ray_dirs (R, 3), samples)`` of per-point directions: a ray's
    direction expanded over its samples (``(R, S, 3)`` with stride 0 over
    S, as ``renderer._render_pass`` passes them) gives its R rays of S
    samples; any other layout gives each point as a ray of one sample."""
    if dirs.dim() == 3 and dirs.stride(1) == 0:
        return dirs[:, 0].contiguous(), dirs.shape[1]
    return dirs.reshape(-1, 3).contiguous(), 1


class SmoothnessDraws(NamedTuple):
    """The draws of one smoothness-loss evaluation, per (pseudo-level,
    probe): the face axis (int64 in {0, 1, 2}), the uniform in [0, 1) that
    picks the face plane, and the probe's position, uniform in [-bound,
    bound)^3."""

    axis: torch.Tensor  # (L', P)
    plane_u: torch.Tensor  # (L', P)
    pos: torch.Tensor  # (L', P, 3)


def make_encode_smoothness_loss(
    num_level: int,
    min_res: int = 16,
    max_res: int = 512,
    table_feat_dim: int = 2,
    table_layout: str = "packed",
    num_probes: int = 1024,
    bound: float = 2.5,
    use_kernel: Optional[bool] = None,
) -> Callable[[Dict[str, Any], SmoothnessDraws], torch.Tensor]:
    """Voxel-face consistency penalty of the packed layouts (``fields_ngp.
    py:81-152`` of the JAX package): a lattice corner is stored once per
    adjacent voxel, so the encode jumps at voxel faces; the loss is the
    mean over probes of the squared jump, summed over features, between the
    encodes at ``p - eps*e_a`` and ``p + eps*e_a`` for ``p`` on a random
    face plane of each (pseudo-)level, ``eps = 1e-3 / res``. All 2 * probes
    * L' points go through one encode call, at every level.

    Returns ``aux_loss(params, draws) -> scalar`` (unweighted; ``params``
    is one field's tree), with ``aux_loss.draw(generator) ->
    SmoothnessDraws`` drawing its randomness on the generator's device.
    ``use_kernel`` None or True encodes through kernels 8 and 9 (their
    plain versions on CPU tensors); False takes the plain version by
    autograd."""
    base = torch.as_tensor(level_resolutions(num_level, min_res, max_res))
    if table_layout == "packed_dual":
        res_all, off_all = instant_ngp.dual_resolutions_offsets(base)
    elif table_layout == "packed":
        res_all, off_all = base, torch.zeros_like(base)
    else:
        raise ValueError(f"Smoothness loss applies to packed layouts, not '{table_layout}'.")
    levels = res_all.shape[0]
    kernel = use_kernel is None or bool(use_kernel)
    on: Dict[torch.device, tuple] = {}

    def constants(device: torch.device):
        if device not in on:
            on[device] = (res_all.to(device), off_all.to(device))
        return on[device]

    def aux_loss(params: Dict[str, Any], draws: SmoothnessDraws) -> torch.Tensor:
        resolutions, offsets = constants(draws.pos.device)
        # the JAX package's order of operations, in f32
        max_plane = torch.floor(resolutions * bound).to(torch.int32)  # (L',)
        plane = torch.floor((2.0 * draws.plane_u - 1.0) * max_plane[:, None]).float()
        face_x = (plane - offsets[:, None]) / resolutions[:, None]
        onehot = torch.nn.functional.one_hot(draws.axis, 3).to(draws.pos.dtype)
        pos = draws.pos * (1.0 - onehot) + face_x[..., None] * onehot
        # an f32 1e-3 divided by res, as JAX divides (torch's scalar / tensor
        # multiplies by the reciprocal: another rounding)
        eps = (torch.full_like(resolutions, 1e-3) / resolutions)[:, None, None] * onehot
        p_minus = (pos - eps).reshape(-1, 3)
        p_plus = (pos + eps).reshape(-1, 3)
        both = torch.cat([p_minus, p_plus])
        enc = instant_ngp.hash_encode_packed(params["tables"], both, resolutions, table_feat_dim, offsets, kernel)
        half = p_minus.shape[0]
        jump = enc[:half] - enc[half:]
        return torch.mean(torch.sum(jump * jump, dim=-1))

    def draw(generator: torch.Generator) -> SmoothnessDraws:
        dev = generator.device
        axis = torch.randint(0, 3, (levels, num_probes), generator=generator, device=dev)
        plane_u = torch.rand((levels, num_probes), generator=generator, device=dev)
        pos = torch.rand((levels, num_probes, 3), generator=generator, device=dev) * (2.0 * bound) - bound
        return SmoothnessDraws(axis, plane_u, pos)

    aux_loss.draw = draw
    return aux_loss
