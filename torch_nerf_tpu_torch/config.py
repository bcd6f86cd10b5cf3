"""Typed configuration tree: a copy of ``torch_nerf_tpu/config.py``.

The same dataclass tree, presets, JSON/YAML load and save and dotted-key
overrides, with the same defaults, so a run directory written by either
package loads in the other. The one difference in meaning:
``device.platform=None`` selects the CUDA card here. YAML is used only where
PyYAML is installed; JSON (a subset of YAML) is written otherwise, and read
back by both packages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

try:
    import yaml  # type: ignore

    _HAVE_YAML = True
except ImportError:  # pragma: no cover
    _HAVE_YAML = False


@dataclasses.dataclass
class DeviceConfig:
    """Replaces ``configs/cuda/default.yaml`` — device selection + precision."""

    platform: Optional[str] = None  # None -> the CUDA card; "cpu" on request
    compute_dtype: str = "bfloat16"  # matmul dtype; f32 accumulate
    param_dtype: str = "float32"


@dataclasses.dataclass
class DataConfig:
    """Mirrors ``configs/data/nerf_synthetic.yaml`` / ``nerf_llff.yaml``."""

    dataset_type: str = "nerf_synthetic"  # nerf_synthetic | nerf_llff | gaussian_blobs
    data_root: str = "data/nerf_synthetic"
    scene_name: str = "lego"
    data_type: str = "train"
    half_res: bool = True
    white_bg: bool = True
    # gaussian_blobs (procedural) only: training resolution and views per
    # split; val/test render at 2x when half_res (mirroring Blender's
    # train-at-half / evaluate-at-full contract, reference train.py:68)
    img_size: int = 64
    num_views: int = 8
    # > 1 = multi-scene batched training (``torch_nerf_tpu/multiscene.py``):
    # N procedural scenes (seeded variants) train concurrently in one
    # jitted step with per-scene params/optimizer; gaussian_blobs only
    num_scenes: int = 1
    # LLFF-only knobs
    factor: int = 8
    recenter: bool = True
    bd_factor: float = 0.75
    spherify: bool = False


@dataclasses.dataclass
class NetworkConfig:
    """Mirrors ``configs/network/nerf.yaml`` / ``instant_nerf.yaml``."""

    type: str = "nerf"  # nerf | instant_nerf
    pos_dim: int = 3
    view_dir_dim: int = 3
    feat_dim: int = 256
    # instant-ngp knobs
    num_level: int = 16
    log_max_entry_per_level: int = 19
    table_feat_dim: int = 2
    min_res: int = 16
    max_res: int = 512
    # "hash" = reference-parity per-corner hashing (the default — identical
    # math to the reference, Pallas-accelerated on TPU); "bricked" =
    # corner-SHARED 4^3-site bricks, one gather/(point, level) at -0.12 dB
    # vs "hash" (the instant_nerf_tpu preset's layout, NGP_QUALITY.json);
    # "packed"/"packed_dual" = the round-2/3 voxel-packed layouts (fastest,
    # -4..-6 dB novel-view from per-voxel-private corner copies)
    table_layout: str = "hash"


@dataclasses.dataclass
class ObjectiveConfig:
    """Mirrors ``configs/objective/nerf.yaml``.

    The smoothness knobs have no reference counterpart: they weight the
    voxel-face consistency penalty of the packed hash-grid layouts
    (``fields_ngp.make_encode_smoothness_loss``); 0 disables it (and is
    required for the reference-parity "hash" layout).
    """

    loss_type: str = "nerf_default"  # MSE photometric
    encode_smoothness_weight: float = 0.0
    encode_smoothness_probes: int = 1024


@dataclasses.dataclass
class OptimSection:
    num_iter: int = 300_000
    optim_type: str = "adam"
    scheduler_type: str = "exp"
    init_lr: float = 5.0e-4
    end_lr: float = 5.0e-5
    eps: float = 1.0e-8
    # L2-through-Adam on hash-table leaves only (no reference counterpart;
    # 0 = reference-faithful). See train.make_optimizer.
    table_weight_decay: float = 0.0


@dataclasses.dataclass
class ValidationSection:
    validate_every: int = 10
    num_batch: int = 5


@dataclasses.dataclass
class LogSection:
    epoch_btw_ckpt: int = 50
    epoch_btw_vis: int = 10


@dataclasses.dataclass
class TrainParamsConfig:
    """Mirrors ``configs/train_params/nerf.yaml``."""

    optim: OptimSection = dataclasses.field(default_factory=OptimSection)
    validation: ValidationSection = dataclasses.field(default_factory=ValidationSection)
    log: LogSection = dataclasses.field(default_factory=LogSection)
    ckpt_path: Optional[str] = None


@dataclasses.dataclass
class SceneConfig:
    """Mirrors ``configs/scene/cube.yaml``."""

    type: str = "cube"


@dataclasses.dataclass
class RendererConfig:
    """Mirrors ``configs/renderer/volume_renderer_default.yaml``."""

    integrator_type: str = "quadrature"
    sampler_type: str = "stratified"
    num_pixels: int = 4096
    num_samples_coarse: int = 64
    num_samples_fine: int = 128
    t_near: float = 2.0
    t_far: float = 6.0
    project_to_ndc: bool = False


@dataclasses.dataclass
class OccupancySection:
    """Occupancy-grid sample pruning (``torch_nerf_tpu/occupancy.py``).

    No reference counterpart (the reference's sampler is purely stratified,
    ``ray_samplers/stratified_sampler.py:92-109``); this is the Instant-NGP
    empty-space-skipping acceleration re-designed for XLA static shapes.
    ``keep_samples`` is the static per-ray budget after pruning of the
    (coarse) stratified candidates — the compute knob; for hierarchical
    models ``keep_samples_fine`` additionally budgets the merged
    coarse+fine set of the fine pass (0 = fine set unpruned). Disabled by
    default so reference-faithful runs are untouched.
    """

    enabled: bool = False
    resolution: int = 64
    bound: float = 4.0
    update_every: int = 16
    decay: float = 0.95
    threshold: float = 1e-2
    keep_samples: int = 128
    warmup_steps: int = 512
    keep_samples_fine: int = 0


@dataclasses.dataclass
class SignalEncoderConfig:
    """Mirrors ``configs/signal_encoder/positional_encoding.yaml`` / ``spherical_harmonics.yaml``."""

    type: str = "pe"  # pe | sh
    coord_encode_level: int = 10
    dir_encode_level: int = 4
    include_input: bool = True
    degree: int = 4  # SH only


@dataclasses.dataclass
class ParallelConfig:
    """Mesh layout — no reference equivalent (single GPU there)."""

    data_axis_size: int = -1  # -1: all devices
    model_axis_size: int = 1
    # fused encode+MLP kernels; None or true = the kernels on a CUDA tensor
    # (bfloat16 or float32, feat_dim up to 1024, encodings up to 128 wide;
    # they raise past that) and their plain versions on a CPU tensor;
    # false = the plain PyTorch version
    use_pallas: Optional[bool] = None


@dataclasses.dataclass
class ExperimentConfig:
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    objective: ObjectiveConfig = dataclasses.field(default_factory=ObjectiveConfig)
    train_params: TrainParamsConfig = dataclasses.field(default_factory=TrainParamsConfig)
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    renderer: RendererConfig = dataclasses.field(default_factory=RendererConfig)
    signal_encoder: SignalEncoderConfig = dataclasses.field(default_factory=SignalEncoderConfig)
    occupancy: OccupancySection = dataclasses.field(default_factory=OccupancySection)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    log_dir: Optional[str] = None
    seed: int = 0


def instant_nerf_config() -> ExperimentConfig:
    """The ``configs/instant_nerf.yaml`` composition: hash-grid network, SH
    dir encoding, 256 coarse samples / no fine net, Adam 1e-2->1e-3 eps 1e-15."""
    cfg = ExperimentConfig()
    cfg.network.type = "instant_nerf"
    cfg.signal_encoder.type = "sh"
    cfg.renderer.num_pixels = 4096
    cfg.renderer.num_samples_coarse = 256
    cfg.renderer.num_samples_fine = 0
    cfg.train_params.optim.init_lr = 1.0e-2
    cfg.train_params.optim.end_lr = 1.0e-3
    cfg.train_params.optim.eps = 1.0e-15
    cfg.train_params.log.epoch_btw_ckpt = 500
    return cfg


def instant_nerf_tpu_config() -> ExperimentConfig:
    """TPU-production hash-grid preset: the corner-SHARED bricked layout at
    the reference's exact 16.8M-param budget and L16F2 geometry.

    One gathered line per (point, level) — packed-layout speed on the v5e's
    scalar-issue-bound gather/scatter — while lattice sites stay shared
    across each brick's 3^3 voxels, which is what preserves novel-view
    quality: measured -0.12 dB vs the reference-parity hash layout at equal
    steps and 16x less wall time (NGP_QUALITY.json `bricked_L16F2_T19`;
    the round-3 packed/dual presets plateaued 4-6 dB below reference).
    Occupancy pruning stays opt-in (``occupancy.enabled=true``): on real
    scenes with empty space its error is bounded by the density threshold;
    on soft/volumetric content it becomes a coarsened quadrature (kept
    samples absorb dropped-occupied intervals) measured at -0.84 dB on the
    procedural gaussian_blobs scene at 2:1 for a 1.8x step speedup.
    """
    cfg = instant_nerf_config()
    cfg.network.table_layout = "bricked"
    return cfg


PRESETS = {
    "default": ExperimentConfig,
    "nerf": ExperimentConfig,
    "instant_nerf": instant_nerf_config,
    "instant_nerf_tpu": instant_nerf_tpu_config,
}


# ----------------------------------------------------------------------------
# (de)serialization


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg


def _from_dict(cls, data: Dict[str, Any]):
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"Unknown config key '{key}' for {cls.__name__}")
        ftype = fields[key].type
        target = _resolve_dataclass(ftype)
        kwargs[key] = _from_dict(target, value) if target and isinstance(value, dict) else value
    return cls(**kwargs)


def _resolve_dataclass(ftype):
    if isinstance(ftype, str):
        ftype = globals().get(ftype, None)
    return ftype if dataclasses.is_dataclass(ftype) else None


def from_dict(data: Dict[str, Any]) -> ExperimentConfig:
    network = data.get("network")
    if isinstance(network, dict) and "table_layout" not in network:
        # run dirs created before the packed layout existed trained
        # reference-parity (L, T, F) "hash" tables; filling in today's
        # default would reinterpret their checkpoints (ADVICE.md r1)
        network = dict(network)
        network["table_layout"] = "hash"
        data = {**data, "network": network}
    return _from_dict(ExperimentConfig, data)


def save_config(cfg: ExperimentConfig, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = to_dict(cfg)
    if _HAVE_YAML and path.suffix in (".yaml", ".yml"):
        path.write_text(yaml.safe_dump(data, sort_keys=False))
    else:
        path.write_text(json.dumps(data, indent=2))


def load_config(path: str | Path) -> ExperimentConfig:
    path = Path(path)
    text = path.read_text()
    if _HAVE_YAML and path.suffix in (".yaml", ".yml"):
        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    return from_dict(data)


def apply_overrides(cfg: ExperimentConfig, overrides: List[str]) -> ExperimentConfig:
    """Apply Hydra-style dotted overrides, e.g. ``renderer.num_pixels=1024``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override must be key=value. Got '{item}'.")
        dotted, raw = item.split("=", 1)
        keys = dotted.split(".")
        obj = cfg
        for key in keys[:-1]:
            obj = getattr(obj, key)
        leaf = keys[-1]
        current = getattr(obj, leaf)
        setattr(obj, leaf, _coerce(raw, current))
    return cfg


def _coerce(raw: str, current: Any) -> Any:
    if raw.lower() in ("null", "none"):
        return None
    if current is None and raw.lower() in ("true", "false"):
        # an Optional[bool] left at None (parallel.use_pallas); the JAX
        # package's copy keeps the string here, which reads as true
        return raw.lower() == "true"
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def resolve(preset_or_path: str, overrides: Optional[List[str]] = None) -> ExperimentConfig:
    """Preset name or YAML/JSON path -> ExperimentConfig with overrides."""
    if preset_or_path in PRESETS:
        cfg = PRESETS[preset_or_path]()
    else:
        cfg = load_config(preset_or_path)
    return apply_overrides(cfg, overrides or [])
