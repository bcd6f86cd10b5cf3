"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

Drives the port's main paths through its own entry points (render a trained
classic NeRF; train one, by the fused train pass and by autograd through the
field; train, resume, render and evaluate both Instant-NGP presets and the
packed table layouts with their smoothness loss, a forward-facing LLFF scene
through NDC rays, occupancy-pruned runs and two-scene runs; score with
LPIPS; trace steps with the profiler) and holds every kernel on them
against its plain PyTorch version.
Each phase prints one JSON line; any failure exits non-zero. Then it prints
the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py

Phases: device, build (one nvcc per source and per part of one, all at
once, sm_90a); kernel
(the field's forward at full width, ragged tail, PyTorch-default and
He-scaled weights, on its wgmma route at widths 256, 128 and 64, the
tensor-core general route at path B's 512 with a 75-wide encoding, 48
(padded to 64), 384 and the wide configs (96, 160, 576, 1024 and 512 with
both encodings 123 wide) in bf16 (wgmma_general, in column passes) and
path A's 256 and 96, 320, 512 and 1024 in f32 (f32_wgmma), three
trunk faults planted in the wgmma route's forward images and in each of
paths A's and B's forward images, a later column pass's rows and a half
K-slice zeroed at the wide configs, and path A's f32 matrices rounded to
TF32 and to bf16, that the comparison must reject; the f32 limits have a
floor of 1e-5, bf16's 1e-3; the tensor-core route's plan twin against
its C++ side at every padded bf16 width);
kernel_bwd (the field's backward on 2^16 + 37 points and at the
train path's 4096 x 64 and 4096 x 192, every grad against the plain
version, three planted faults in the training kernels' weight images, a
second launch bit-identical; then kernel_bwd_general: the backward at
paths A and B (f32_wgmma against the plain f64 version, wgmma_general
against the plain f32) on the 786,432 fine points, a second launch
bit-identical, three faults and path A's two roundings planted in its
images, and the dW GEMM's own faults (a slice skipped, a tile's db
dropped, a panel's swizzle off by one chunk; in f32 the low and middle
pieces dropped); the backward at each wide config on 2^16 + 37 random
points, relaunched bit-identically, a chain image zeroed and the column
passes' faults planted; then dw_gemm: the general route's dW GEMM
(``csrc/nerf_dw_tc.cuh``) alone over kernel 2's stashes at paths A and B
(fine points and random ones), at f32 320 and 1024 and at bf16 1024 and 96, against
the plain version on the same stashes (f32 within 2x its error + 5e-7),
relaunched bit-identically, each planted fault, the f32 low piece dropped
too, failing that check at paths A and B's fine shape, and its plan's
Python twin against the library's); kernel_train (the fused train pass at
4096 x 64, 4096 x 192 and a ragged batch, rgb, weights and grads, planted
faults in the weight images and in the composite, a second launch
bit-identical; then kernel_train_general: the pass at paths A and B at
4096 x 64 and 4096 x 192, the same rules one precision up for f32, and at
each wide config at 4096 x 64 with the column passes' faults, and at
bf16 1024 and 96 at 4096 x 192 too);
serve (``run_render`` + ``evaluate`` on 128x128 test views, kernel launches
counted, the kernel's render held against the plain version's); train
(``run_train`` for 24 steps with a validation, a checkpoint and a
visualisation, a resume for 8 more, then ``run_render`` + ``evaluate``;
2 fused-pass launches per step, 2 forward launches per render chunk);
train_f32 and train_wide (paths A and B of the general route through the
same CLI sequence as train: the default preset with
``device.compute_dtype=float32`` (f32_wgmma), and ``network.feat_dim=512
signal_encoder.coord_encode_level=12`` (wgmma_general); every launch
counted by route from 0: kernel 3 twice a step and kernel 1 twice a chunk
on the path's route, none on the others);
train_1024 (the same CLI sequence at ``network.feat_dim=1024`` in bf16,
four column passes, 100x100 views: every launch on wgmma_general);
train_f32_1024 (the same at ``device.compute_dtype=float32
network.feat_dim=1024``, 1024 rays a step: every launch on f32_wgmma,
streaming its layers through device memory); train_bench
(train steps at ``bench.py``'s operating point, fused and through
autograd, each kernel timed beside its bound and its plain version);
train_bench_general (paths A and B at the same point, fused and
``force_generic``, kernel 1 held against its plain version at the path's
coarse and fine render chunks, kernels 1-3 timed alone; then kernels 1-3 on
f32_wgmma at f32 96, 320, 512 (level 12) and 1024 held against their plain
versions by the f32 rule (kernel 2 on the fine batch's points, kernel 3
at the coarse shape; at 1024 and 96 kernels 1 and 3 on the fine shape
too), relaunched bit-identically, the low bf16 piece of every weight
dropped at 320 (a tile) and 1024 (streaming) and rejected, every launch
on f32_wgmma, 320 and 1024 timed; and kernels 1-3 on wgmma_general at bf16 1024
and 96 timed, kernel 1 first held against its plain version on their fine
chunk); bench (800x800 frames at ``bench.py --render``'s operating point); kernel_hash (kernels 4-7, the bricked and
per-corner hash encodes forward and backward, at full width on the 2^20
points of a train batch plus 37 negative, integral and large ones, three
planted faults that must be rejected, then kernels 4-7 on the points of
the occupancy paths, a pruned step's 4096 x 128 and a sweep's 64^3, then
on three contention cases: every point in one voxel, long runs of samples along
rays, and integral points heading and inside runs of their voxel, then
every corner width at 16 and 3 levels on 1, 33 and 4099 points);
train_ngp (``run_train`` with the
``instant_nerf_tpu`` preset for 24 steps, a resume for 8, ``run_render`` +
``evaluate``, then 8 steps of ``instant_nerf``; one forward and one
backward hash launch per step); train_bench_ngp (NGP train steps at
``bench.py --model=instant_nerf``'s point, both layouts, each hash kernel
timed beside its bound and its plain version; then the packed layouts,
without and with the smoothness loss, and kernels 8-9 timed alone);
bench_ngp (800x800 NGP frames at ``bench.py --render
--model=instant_nerf``'s point, all four layouts, the frame loop's fused
NGP forward once a chunk); ngp_fused (the NGP field's fused forward
after the hash encode, ``csrc/ngp_mlp_fwd.cu``, against its plain version
at the render cell's 4096 x 256 points with 32 and 64 features and at
ragged shapes, two planted image faults rejected, NaN and +-inf where the
plain version puts them, timed beside its bound, its plain version and
the cuBLAS route it replaces); kernel_fold (kernels
8-9, the packed layouts' folded encode forward and backward, at full width
for ``packed`` and ``packed_dual`` on the same points, four planted faults
that must be rejected, then kernels 8-9 on two contention cases: every
point in one voxel, and long runs of samples along rays, then every
packed width F 1-16 of both layouts at 16 and 3 levels on 1, 33 and 4099
points); train_packed (``run_train`` of ``packed`` with the
smoothness loss for 24 steps, a resume for 8, ``run_render`` +
``evaluate``, then 8 steps of ``packed_dual``; two forward and two
backward fold launches per step, one forward per render chunk);
train_llff (``run_train`` of the classic defaults on a generated
forward-facing LLFF scene, 1008x756 PNGs minified by the loader to fern's
factor-8 size 504x378, NDC rays, 24 steps, a resume for 8, ``run_render`` +
``evaluate`` of the held-out view; 2 kernel-3 launches a step, t-bounds (0,
1); the held-out frame and the same view from an origin on z = 0 through
kernel 1 and the plain versions, non-finite pixels counted before any PNG
cast and the finite masks equal); train_occ (``run_train`` with occupancy
pruning, the grid sweeping every 4 steps after a warmup of 8: the classic
defaults at 32 + 128 kept samples through kernel 3, ``instant_nerf_tpu``
at 128 through kernels 4-5, 8 steps of ``instant_nerf`` through kernels
6-7; the sidecar at both checkpoints and restored bit for bit, the grid
at step 32 neither all occupied nor all empty, the sweep's and the pruned
passes' launches and shapes counted); train_multi (``run_train
data.num_scenes=2``, two gaussian_blobs scenes, 24 steps, a resume for 8,
``run_render --scene 1`` + ``evaluate`` against scene 1's ground truth, the
classic defaults at full width and ``instant_nerf_tpu``: kernel 3 twice a
scene a step, kernels 4 and 5 once, kernel 1 or 4 per render chunk of each
scene's validation; per-scene PSNR, each scene's loss falling);
train_multi_step (one 2-scene classic step equal to two single-scene steps
bit for bit, params, Adam's moments and losses; kernels 1, 3, 4 and 5 on
each scene's batch and its views of the stacked parameters against their
plain versions); train_bench_multi (2- and 4-scene classic steps and
2-scene bricked steps against S single-scene steps, in alternating turns);
lpips (the port's LPIPS on the card against the CPU on random weights, and
``evaluate`` printing it); profile (``run_train --profile-steps 2``: the
Chrome trace names kernel 3's CUDA functions). kernel_train holds
kernel 3 also on occupancy-pruned planes, and train_bench and
train_bench_ngp time the pruned steps beside the dense ones.

Then the parallel paths (``torch_nerf_tpu_torch/parallel/``), on ranks
that share the card and talk over gloo (NCCL refuses two ranks on one
card), spawned with a ``file://`` rendezvous: dp_step (2 ranks: the fused
DP step, kernel 3 on each rank's 2048 rays; the generic DP step, kernels
1-2; the bricked NGP image step with occupancy, kernels 4-5 and a sweep
split over the ranks; kernels 1-5 on each rank's shard against their plain
versions, the DP gradients against the halves' in one process and against
the plain version on the whole batch, and one NCCL rank's fused step bit
for bit); tp_step (TP over 2 ranks and DP x TP 2 x 2 at width 256 in f32
on 256 rays against the replicated step, and one TP gradient at 4096 rays
timed);
dp_render (an 800x800 frame over 2 ranks against ``render_image``, max-abs
0.0; the sample-axis composite); train_bench_dp (the 2-rank DP step, the
gloo all_reduce of the classic and bricked gradients, NCCL's on one
rank: ranks sharing one card, not a scaling number); train_dp (torchrun:
``run_train --distributed`` 24 + 8 steps, the checkpoint resumed by one
process, ``run_render --distributed`` against the single-process PNGs,
``evaluate``, then 2 scenes over the 2 ranks 24 + 8; launches per rank);
dryrun (``runners/dryrun_multichip.py`` on 4 ranks). A rank's failure
fails the phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import shutil
import sys
import time
from pathlib import Path

import torch

from torch_nerf_tpu_torch.ops import launch_count
from torch_nerf_tpu_torch.runners.timing import event_ms as cuda_ms
from torch_nerf_tpu_torch.runners.timing import nvidia_smi

# H100 SXM data-sheet peaks (dense bf16, HBM3); PCIe part where named so
_PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H100", 989e12, 3.35e12), ("H200", 989e12, 4.8e12))
# f32 outside the tensor cores, H100 SXM data sheet: the hash kernels' blend
F32_PEAK = 67e12

FULL = dict(coord_encode_level=10, dir_encode_level=4, feat_dim=256)
# the Instant-NGP presets' hash grid: L16 F2, 2^19 entries a level, res 16-512
NGP = dict(num_level=16, log_max_entry_per_level=19, table_feat_dim=2, min_res=16, max_res=512)
NGP_LAYOUTS = ("bricked", "hash")
PACKED_LAYOUTS = ("packed", "packed_dual")
# the general route's two configs, each run through the CLIs: path A, the
# default preset in f32 (route f32_wgmma); path B, width 512 with a 75-wide
# position encoding (level 12) in bf16 (route wgmma_general): both on the
# tensor-core general route (csrc/nerf_mlp_tc.cuh)
GENERAL = {"f32_wgmma": dict(feat_dim=256, coord_encode_level=10, dtype=torch.float32),
           "wgmma_general": dict(feat_dim=512, coord_encode_level=12, dtype=torch.bfloat16)}
GENERAL_OVERRIDES = {"f32_wgmma": ["device.compute_dtype=float32"],
                     "wgmma_general": ["network.feat_dim=512", "signal_encoder.coord_encode_level=12"]}
GENERAL_PHASES = {"f32_wgmma": "train_f32", "wgmma_general": "train_wide"}
# the f32 configs of the tensor-core engine off path A (route f32_wgmma), by
# name: (feat_dim, coord_encode_level, dir_encode_level). 96: a half K-slice
# (one pass of 64, its trunk read to F); 320: two passes of 80, the first
# held as f32 in registers; 512 with a 75-wide encoding: four passes of 64,
# the widest f32 tile; 1024: streaming, every layer through device memory.
# Kernels 1-3 are held against their plain versions at each
# (f32_route_checks), at F32_FINE on the fine shape too; the low bf16 piece
# of every weight is dropped at F32_FAULTED (one width of each design); 320
# and 1024 are timed, and 1024 runs the CLIs (train_f32_1024)
F32_WIDE = {"96": (96, 10, 4), "320": (320, 10, 4), "512/L12": (512, 12, 4), "1024": (1024, 10, 4)}
F32_FINE = ("1024", "96")
F32_FAULTED = ("320", "1024")
F32_TIMED = ("320", "1024")
# the bf16 configs the tensor-core engine took over from the mma.sync one
# (csrc/nerf_mlp_tc.cuh's column passes), by name: (feat_dim,
# coord_encode_level, dir_encode_level). Widths off the 64s (96, 160: each
# trunk input ends on a half K-slice), 576 and 1024 (three and four column
# passes, the outputs of the earlier ones held in registers) and 512 with
# both encodings two panels wide (one pass of 256, the encodings sharing a
# tile). Kernels 1-3 are held against their plain versions at each; 1024
# and 96 are timed in train_bench_general, and 1024 runs the CLIs
# (train_1024).
TC_WIDE = {"96": (96, 10, 4), "160": (160, 10, 4), "576": (576, 10, 4), "1024": (1024, 10, 4),
           "512/L20": (512, 20, 20)}
TC_TIMED = ("1024", "96")
# the floor of every limit that holds a kernel of one compute type against
# the plain version one precision up (2x the plain version's own error +
# the floor): 1e-3 for bf16; for f32 1e-5, 1/50 of TF32's unit roundoff
# (2^-11), so that the f32 route's weights rounded to TF32 or to bf16
# (:data:`PRECISION_CONTROLS`) fail where a right f32 chain passes
FLOOR = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# mantissa bits of the precision controls planted in the f32 route
PRECISION_CONTROLS = {"tf32_rounded": 10, "bf16_rounded": 7}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - _T0}), flush=True)


def card_peaks(name: str):
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
    return _PEAKS[1][1], _PEAKS[1][2]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap} < (9, 0)")
    smi = nvidia_smi("name,power.limit")
    emit("device", name=torch.cuda.get_device_name(0), capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvidia_smi=smi)
    return smi


def phase_build():
    from torch_nerf_tpu_torch.ops import build  # noqa: PLC0415

    t0 = time.perf_counter()
    reports = build.build(["fused_nerf_fwd", "fused_nerf_bwd", "fused_train", "hash_grid", "fused_tc_fwd",
                           "fused_tc_train", "fused_tc_bwd", "ngp_mlp_fwd"])
    seconds = time.perf_counter() - t0
    ptxas = {
        Path(src).stem: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for src, log in reports.items()
    }
    emit("build", seconds=seconds, ptxas=ptxas)


def _seeded_params(seed: int, device):
    from torch_nerf_tpu_torch.models.nerf import init_nerf_params  # noqa: PLC0415

    gen = torch.Generator(device=device).manual_seed(seed)
    return init_nerf_params(gen, 63, 27, 256, device=device)


def he_scaled(params):
    """``params`` with each weight scaled by sqrt(6), U(+-sqrt(6/fan_in)):
    the He gain keeps the signal's scale through every relu layer, so the
    outputs depend on every layer. PyTorch's default init, U(+-1/sqrt(fan_in)),
    shrinks it by about sqrt(1/6) a layer, leaving the outputs to the last
    layers' biases, and a fault in the trunk could hide under the tolerance."""
    return {n: {"w": v["w"] * math.sqrt(6.0), "b": v["b"]} for n, v in params.items()}


def width_cfg(feat: int = FULL["feat_dim"], dtype=torch.bfloat16, level: int = FULL["coord_encode_level"],
              dir_level: int = FULL["dir_encode_level"]):
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    return fn.FusedNeRFConfig(**dict(FULL, feat_dim=feat, coord_encode_level=level, dir_encode_level=dir_level),
                              compute_dtype=dtype)


def reference_of(params, tensors, cfg):
    """The higher-precision plain version that a kernel of ``cfg`` is held
    against, one precision up from ``cfg``'s own plain version: for bf16,
    f32 on the bf16-rounded weights; for f32, f64 (weights and inputs cast).
    -> ``(params, tensors, cfg)`` of that version."""
    if cfg.compute_dtype == torch.bfloat16:
        return bf16_rounded(params), tensors, dataclasses.replace(cfg, compute_dtype=torch.float32)
    double = {n: {k: t.double() for k, t in v.items()} for n, v in params.items()}
    return double, [t.double() for t in tensors], dataclasses.replace(cfg, compute_dtype=torch.float64)


def kernel_errors(params, pts, dirs, feat: int = FULL["feat_dim"], dtype=torch.bfloat16,
                  level: int = FULL["coord_encode_level"], dir_level: int = FULL["dir_encode_level"]) -> dict:
    """One kernel launch against the plain version one precision up
    (:func:`reference_of`: f32 on the same bf16-rounded weights for bf16,
    f64 for f32); the plain version's own error in the config's type is
    the scale. ``ok`` when the kernel's max-abs error is within 2x that +
    the type's :data:`FLOOR`."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    cfg = width_cfg(feat, dtype, level, dir_level)
    public = params.public if isinstance(params, fn.KernelWeights) else params
    ref_params, (rp, rd), ref_cfg = reference_of(public, [pts, dirs], cfg)
    before = fn.fused_nerf_apply.launches
    sigma, rgb = fn.fused_nerf_apply(params, pts, dirs, cfg)
    torch.cuda.synchronize()
    launched = fn.fused_nerf_apply.launches - before
    s32, c32 = fn.fused_nerf_apply_reference(ref_params, rp, rd, ref_cfg)
    sbf, cbf = fn.fused_nerf_apply_reference(public, pts, dirs, cfg)
    err = {"sigma": (sigma - s32).abs().max().item(), "rgb": (rgb - c32).abs().max().item()}
    scale = {"sigma": (sbf - s32).abs().max().item(), "rgb": (cbf - c32).abs().max().item()}
    floor = FLOOR[dtype]
    ok = launched == 1 and all(math.isfinite(err[k]) and err[k] <= 2.0 * scale[k] + floor for k in err)
    plain = "plain_bf16_err" if dtype == torch.bfloat16 else "plain_f32_err"
    return {"points": pts.shape[0], "feat_dim": feat, "coord_encode_level": level, "dir_encode_level": dir_level,
            "route": fn.forward_route(cfg),
            "reference": str(ref_cfg.compute_dtype), "max_abs_err": err, plain: scale,
            "tolerance": f"err <= 2 * {plain} + {floor}", "sigma_ref_max": s32.max().item(),
            "sigma_positive_share": (s32 > 0).float().mean().item(), "rgb_ref_std": c32.std().item(),
            "launches": launched, "ok": ok}


def compare_with_plain(params, pts, dirs, feat: int = FULL["feat_dim"], dtype=torch.bfloat16,
                       level: int = FULL["coord_encode_level"], dir_level: int = FULL["dir_encode_level"]) -> dict:
    """:func:`kernel_errors`, raising unless ``ok``."""
    result = kernel_errors(params, pts, dirs, feat, dtype, level, dir_level)
    if not result["ok"]:
        emit("kernel", **result)
        raise SystemExit("chip_smoke: kernel disagrees with its plain version")
    return result


def planted_faults(w, params) -> dict:
    """Copies of the wgmma route's forward images ``w`` with one trunk
    layer broken the way a wrong pointer, slice order or shared-memory
    layout in the kernel would break it: fc_1's image zeroed, fc_6's
    K-slices rolled by one slice, fc_3's image written without the
    128-byte swizzle."""
    import dataclasses  # noqa: PLC0415

    from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    i = {name: k for k, name in enumerate(LAYER_NAMES)}
    mats = fn.training_matrices(params, width_cfg())
    images = list(w.weights)
    zero, roll, plain = list(images), list(images), list(images)
    zero[i["fc_1"]] = torch.zeros_like(images[i["fc_1"]])
    rows = mats[i["fc_6"]][0].shape[0]  # one K-slice of fc_6's W^T: rows x 64 elements
    roll[i["fc_6"]] = torch.roll(images[i["fc_6"]], rows * 64)
    fwd3 = mats[i["fc_3"]][0]
    r, c = fwd3.shape
    plain[i["fc_3"]] = fwd3.reshape(r, c // 64, 64).permute(1, 0, 2).reshape(-1).contiguous()
    return {
        "fc_1_image_zeroed": dataclasses.replace(w, weights=tuple(zero)),
        "fc_6_k_slices_rolled": dataclasses.replace(w, weights=tuple(roll)),
        "fc_3_image_unswizzled": dataclasses.replace(w, weights=tuple(plain)),
    }


# (width, route, coord_encode_level[, dir_encode_level]) of every kernel-1
# check: the wgmma route at the training widths; the tensor-core general
# route at path B's config (512, a 75-wide encoding), a padded width (48 ->
# 64), 384 (two passes of 96), path A's config in f32 and every config of
# :data:`TC_WIDE`; f32 at every config of :data:`F32_WIDE`
KERNEL1_WIDTHS = ((256, "wgmma", 10), (128, "wgmma", 10), (64, "wgmma", 10), (256, "f32_wgmma", 10),
                  (512, "wgmma_general", 12), (48, "wgmma_general", 10), (384, "wgmma_general", 10),
                  *((f, "wgmma_general", lv, dl) for f, lv, dl in TC_WIDE.values()),
                  *((f, "f32_wgmma", lv, dl) for f, lv, dl in F32_WIDE.values()))


def route_dtype(route: str):
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    return fn.ROUTE_DTYPE[route]


def level_params(feat: int, level: int, seed: int, dev, dir_level: int = FULL["dir_encode_level"]):
    from torch_nerf_tpu_torch.models.nerf import init_nerf_params  # noqa: PLC0415

    cfg = width_cfg(feat, level=level, dir_level=dir_level)
    return init_nerf_params(torch.Generator(device=dev).manual_seed(seed), cfg.pos_enc_dim, cfg.dir_enc_dim,
                            feat, device=dev)


def rounded_to(x, bits: int):
    """f32 ``x`` rounded to nearest at ``bits`` mantissa bits (ties away
    from zero): 10 is TF32's, 7 bf16's."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


# faults planted in the tensor-core general route's images (csrc/
# nerf_mlp_tc.cuh), the way a wrong pointer, slice order or layout would
# break them: a layer zeroed, its K-slices rolled by one stage (one image's
# slice: a bf16 piece in f32), a layer written without the 128-byte swizzle
# (each image's slices row-major); and, in a layer of several column passes
# (``rows`` image rows a pass), its last pass's rows zeroed, or at a width
# off the 64s the half K-slice that ends each pass zeroed
def tc_fault(images, mats, index, kind, rows=None):
    if kind in ("later_pass_zeroed", "partial_slice_zeroed"):
        image = images[index].clone()
        cols = mats[index].shape[1]
        pieces = image.numel() // mats[index].numel()
        block = rows * cols * pieces  # one pass's image
        if kind == "later_pass_zeroed":
            image[-block:] = 0
        else:
            last = rows * 64 * pieces  # one K-slice of a pass
            for b in range(0, image.numel(), block):
                image[b + block - last:b + block] = 0
        images[index] = image
    elif kind == "zeroed":
        images[index] = torch.zeros_like(images[index])
    elif kind == "k_tiles_rolled":
        images[index] = torch.roll(images[index], mats[index].shape[0] * 64)
    else:
        from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

        m = mats[index]
        r, c = m.shape
        pieces = fn.bf16_pieces(m)[::-1] if m.dtype == torch.float32 else (m,)
        images[index] = torch.stack([p.reshape(r, c // 64, 64).permute(1, 0, 2).reshape(c // 64, r * 64)
                                     for p in pieces], dim=1).reshape(-1).contiguous()


def low_piece_dropped(images, rows):
    """f32 piece images with each K-slice's low bf16 piece (x2, the first
    of its three images) zeroed: every weight kept to its 16 leading
    significand bits, as a product that drops x_i w_2 would read it;
    ``rows`` each image's rows a pass."""
    out = []
    for image, r in zip(images, rows):
        image = image.clone()
        image.view(-1, 3, r * 64)[:, 0] = 0
        out.append(image)
    return out


def general_forward_faults(w, params, cfg) -> dict:
    """Copies of the general route's forward images ``w`` with fc_1
    zeroed, fc_6's k-tiles rolled, fc_3 in another layout; in f32 also
    every matrix rounded as :data:`PRECISION_CONTROLS` says."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    # kernel 1's images: its own passes (fused_nerf.tc_plan, stash False)
    mats = fn.tc_matrices(params, cfg, stash=False)[0]
    out = {}
    for name, index, kind in (("fc_1_zeroed", 1, "zeroed"), ("fc_6_k_tiles_rolled", 6, "k_tiles_rolled"),
                              ("fc_3_other_layout", 3, "other_layout")):
        images = list(w.weights)
        tc_fault(images, mats, index, kind)
        out[name] = dataclasses.replace(w, weights=tuple(images))
    if cfg.compute_dtype == torch.float32:
        for name, bits in PRECISION_CONTROLS.items():
            images = (fn.tc_panel_image(rounded_to(m, bits)) for m in mats)
            out[name] = dataclasses.replace(w, weights=tuple(images))
    return out


def tc_wide_forward_faults(w, params, cfg) -> dict:
    """Copies of the tensor-core route's forward images ``w`` at a config of
    :data:`TC_WIDE` with fc_2's last column pass zeroed (where a layer
    takes several passes) or the half K-slice that ends each of fc_2's
    passes zeroed (at a width off the 64s)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    mats, rows = fn.tc_matrices(params, cfg, stash=False)[0], fn.tc_pass_rows(cfg, stash=False)[0]
    out = {}
    for kind in tc_wide_kinds(cfg):
        images = list(w.weights)
        tc_fault(images, mats, 2, kind, rows[2])
        out[f"fc_2_{kind}"] = dataclasses.replace(w, weights=tuple(images))
    return out


def tc_wide_kinds(cfg) -> list:
    """The column passes' fault kinds a config can show: a later pass's
    rows where a layer takes several passes, a half K-slice at a width off
    the 64s."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    return ((["later_pass_zeroed"] if fn.tc_plan(cfg).passes > 1 else [])
            + (["partial_slice_zeroed"] if fn.padded_config(cfg).feat_dim % 64 else []))


def tc_wide_train_faults(cfg) -> dict:
    """name -> a context that plants it in the training kernels at a config
    of :data:`TC_WIDE`: a chain image zeroed, and each of
    :func:`tc_wide_kinds` in fc_2's forward image and fc_3's chain image."""
    out = {"chain_fc_6_zeroed": lambda: planted_general(6, "zeroed", 2)}
    for kind in tc_wide_kinds(cfg):
        out[f"fwd_fc_2_{kind}"] = lambda k=kind: planted_general(2, k, 0)
        out[f"chain_fc_3_{kind}"] = lambda k=kind: planted_general(3, k, 2)
    return out


# (width, coord_encode_level, dir_encode_level, dtype) whose plan the
# tensor-core general route's Python twin (fused_nerf.tc_plan) and its C++
# side (nerf_mlp_tc.cuh's choose and plan_of, through fused_tc_takes and
# fused_tc_plan) must share: every padded width in both types
TC_TWIN_CONFIGS = ([(f, lv, dl, dt) for f in range(32, 1025, 32) for lv, dl in ((10, 4), (20, 20))
                    for dt in (torch.bfloat16, torch.float32)]
                   + [(f, lv, dl, dt) for f in (64, 96, 192, 256, 320, 512, 576, 1000) for lv, dl in ((12, 4),)
                      for dt in (torch.bfloat16, torch.float32)])


def tc_twin_agrees() -> dict:
    """Each config of :data:`TC_TWIN_CONFIGS` taken or refused alike by
    ``fused_nerf.tc_plan`` and the library's ``fused_tc_takes``, and where
    taken at the same plan: pass width, passes, each kernel's stages and
    shared memory, sign-bit words, CTAs an SM, kernel 1's passes, whether
    it streams (``fused_tc_plan``)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    lib = fn._tc_library()
    rows, disagree = {}, []
    for feat, level, dir_level, dtype in TC_TWIN_CONFIGS:
        cfg = fn.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                 compute_dtype=dtype)
        key = f"{feat}/{level}/{dir_level}/{str(dtype)[6:]}"
        plan = fn.tc_plan(cfg)
        c_side = fn.tc_plan_on_card(cfg)
        alone = fn.tc_plan(cfg, stash=False)
        py = (0,) * 13 if plan is None else (plan.np, plan.passes, *plan.stages, *plan.smem_bytes, plan.bit_words,
                                             plan.ctas, alone.np, alone.passes, int(plan.stream))
        taken = bool(lib.fused_tc_takes(*fn.kernel_dims(cfg)[:1], *fn.kernel_dims(cfg)[4:8],
                                        int(dtype == torch.float32)))
        rows[key] = py if plan is not None else None
        if py != c_side or taken != (plan is not None):
            disagree.append({key: {"python": py, "library": c_side, "taken": taken}})
    return {"configs": len(rows), "plans": {k: v for k, v in rows.items() if k.endswith("/10/4/bfloat16")},
            "disagree": disagree, "ok": not disagree}


def phase_kernel():
    """Kernel 1 vs its plain version on 2^17 + 37 points (a ragged tail),
    with seeded port-init weights and their He-scaled copy, at every
    config of :data:`KERNEL1_WIDTHS` (each on its route, the launch counted
    on it); then three trunk faults planted in the forward images of the
    wgmma route at full width, and three in the forward matrices of each
    general route at paths A's and B's configs, and on the f32 route its
    matrices rounded to TF32 and to bf16 (:data:`PRECISION_CONTROLS`),
    which the check must reject with the He-scaled weights. The main
    path's chunk shapes are compared in the bench phases."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 2**17 + 37
    pts = torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0
    dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
    results, routes_ok = {}, True
    for feat, route, level, *dir_level in KERNEL1_WIDTHS:
        dl = dir_level[0] if dir_level else FULL["dir_encode_level"]
        base = level_params(feat, level, 0, dev, dl)
        for wname, params in (("port_init", base), ("he", he_scaled(base))):
            before = dict(fn.fused_nerf_apply.route_launches)
            key = f"{feat}/{route}/L{level}" + (f"/D{dl}" if dir_level else "") + f"/{wname}"
            results[key] = compare_with_plain(params, pts, dirs, feat, route_dtype(route), level, dl)
            counted = {k: fn.fused_nerf_apply.route_launches[k] - before[k] for k in before}
            routes_ok = routes_ok and results[key]["route"] == route and counted[route] == 1
    base = _seeded_params(0, dev)
    faults = {}
    for wname, params in (("port_init", base), ("he", he_scaled(base))):
        for fault, bad in planted_faults(fn.prepare(params, width_cfg()), params).items():
            r = kernel_errors(bad, pts, dirs)
            faults[f"{wname}/{fault}"] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
    for route, g in GENERAL.items():
        cfg = width_cfg(g["feat_dim"], g["dtype"], g["coord_encode_level"])
        base = level_params(g["feat_dim"], g["coord_encode_level"], 0, dev)
        for wname, params in (("port_init", base), ("he", he_scaled(base))):
            for fault, bad in general_forward_faults(fn.prepare(params, cfg), params, cfg).items():
                r = kernel_errors(bad, pts, dirs, g["feat_dim"], g["dtype"], g["coord_encode_level"])
                faults[f"{wname}/{route}/{fault}"] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
    # the column passes' faults: a later pass's rows, a half K-slice
    for name, (feat, level, dl) in TC_WIDE.items():
        cfg = width_cfg(feat, torch.bfloat16, level, dl)
        params = he_scaled(level_params(feat, level, 0, dev, dl))
        for fault, bad in tc_wide_forward_faults(fn.prepare(params, cfg), params, cfg).items():
            r = kernel_errors(bad, pts, dirs, feat, torch.bfloat16, level, dl)
            faults[f"he/wgmma_general/{name}/{fault}"] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
    twin = tc_twin_agrees()
    ok = routes_ok and twin["ok"] and all(v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel", weights=results, routes_ok=routes_ok, planted_faults=faults, tc_twin=twin,
         rule="each config on its route; every planted fault rejected with the he weights; the tensor-core "
              "route's Python twin takes the configs its C++ side takes", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel phase failed (a route, or a planted fault passed the comparison)")
    # the wgmma route's error (the preset kernel 1's entry) and each wide
    # config's
    wide = {name: max(e for k, r in results.items()
                      if k.startswith(f"{f}/wgmma_general/L{lv}/D{dl}/") for e in r["max_abs_err"].values())
            for name, (f, lv, dl) in TC_WIDE.items()}
    f32 = {name: max(e for k, r in results.items()
                     if k.startswith(f"{f}/f32_wgmma/L{lv}/D{dl}/") for e in r["max_abs_err"].values())
           for name, (f, lv, dl) in F32_WIDE.items()}
    return {"wgmma": max(e for k, r in results.items() if k.split("/")[1] == "wgmma"
                         for e in r["max_abs_err"].values()), "wide": wide, "f32": f32}


def rel_l2(got: dict, ref: dict) -> dict:
    """||got - ref|| / ||ref|| for each named tensor."""
    out = {}
    for k, r in ref.items():
        r = r.float()
        out[k] = (got[k].float() - r).norm().item() / max(r.norm().item(), 1e-30)
    return out


def named(grads, **extra) -> dict:
    """The 22 grads of a public parameter tree (and extra tensors) by name."""
    flat = {f"{n}.{k}": t for n, p in grads.items() for k, t in p.items()}
    flat.update(extra)
    return flat


def bf16_rounded(params):
    return {n: {k: t.to(torch.bfloat16).float() for k, t in v.items()} for n, v in params.items()}


def judge(err: dict, scale: dict, floor: float = FLOOR[torch.bfloat16]) -> dict:
    """``ok`` when every relative L2 error is at most 2x the plain bf16
    version's own (the plain version's in the config's type) + ``floor``;
    the worst entry by its share of that limit."""
    limit = {k: 2.0 * scale[k] + floor for k in err}
    worst = max(err, key=lambda k: err[k] / limit[k])
    ok = all(math.isfinite(err[k]) and err[k] <= limit[k] for k in err)
    return dict(ok=ok, worst=worst, worst_err=err[worst], worst_limit=limit[worst],
                max_rel_err=max(err.values()), max_plain_bf16_rel_err=max(scale.values()))


# faults planted in the training kernels' weight images, the way a wrong
# pointer, stride or descriptor would break them: a chain image zeroed (the
# backward's own operand), a forward image's K-slices rolled by one slice
# (a wrong slice order in the weight ring), and a layer's image written
# without the 128-byte swizzle (a wrong shared-memory layout)
def _fault_chain_zeroed(fwd, biases, chain, mats):
    chain[6] = torch.zeros_like(chain[6])


def _fault_fwd_slices_rolled(fwd, biases, chain, mats):
    rows = mats[2][0].shape[0]  # fc_2's W^T: one K-slice is rows x 64 elements
    fwd[2] = torch.roll(fwd[2], rows * 64)


def _fault_chain_unswizzled(fwd, biases, chain, mats):
    w = mats[3][2]  # fc_3's W, slice after slice, rows in plain order
    rows, cols = w.shape
    chain[3] = w.reshape(rows, cols // 64, 64).permute(1, 0, 2).reshape(-1).contiguous()


TRAIN_FAULTS = {
    "chain_fc_6_zeroed": _fault_chain_zeroed,
    "fwd_fc_2_k_slices_rolled": _fault_fwd_slices_rolled,
    "chain_fc_3_unswizzled": _fault_chain_unswizzled,
}


@contextlib.contextmanager
def planted(fault):
    """Route the training kernels' weight images through ``fault``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    real = fn.training_layout

    def broken(params, cfg):
        fwd, biases, chain = real(params, cfg)
        fault(fwd, biases, chain, fn.training_matrices(params, cfg))
        return fwd, biases, chain

    fn.training_layout = broken
    try:
        yield
    finally:
        fn.training_layout = real


def sum_trees(a, b):
    return b if a is None else {n: {k: a[n][k] + b[n][k] for k in b[n]} for n in b}


def reference_points(cfg) -> int:
    """Points a slice of the plain versions takes: 2^18, 2^16 past width
    512 (a slice's f64 activations at 1024 are ~2 GB each)."""
    return 2**18 if cfg.feat_dim <= 512 else 2**16


def bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg) -> dict:
    """The plain backward over slices of :func:`reference_points` points
    (the whole of a fine pass in f32 would hold tens of GB): the grads
    summed, dpts and ddirs joined, by name."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    total, dps, dds = None, [], []
    step = reference_points(cfg)
    for a in range(0, pts.shape[0], step):
        sl = slice(a, a + step)
        g, dp, dd = fn.fused_nerf_bwd_reference(params, pts[sl], dirs[sl], g_sigma[sl], g_rgb[sl], cfg)
        total = sum_trees(total, g)
        dps.append(dp)
        dds.append(dd)
    return named(total, dpts=torch.cat(dps), ddirs=torch.cat(dds))


def ray_points(o, d, t):
    """The points o + t d of every sample and their view directions, flat."""
    pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
    dirs = d[:, None, :].expand(-1, t.shape[1], -1).reshape(-1, 3).contiguous()
    return pts, dirs


def bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref32, scale, runs=None, cfg=None) -> dict:
    """One kernel-2 launch of ``cfg`` (default: the full-width bf16 config)
    against the plain version one precision up, ``ref32`` (by name, dpts
    and ddirs too): each within 2x the plain version's own relative L2
    error ``scale`` + the type's :data:`FLOOR`; one launch. With ``runs``, the kernel's grads
    are appended to it."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    cfg = cfg or fn.FusedNeRFConfig(**FULL)
    before = fn.fused_nerf_bwd.launches
    grads, dp, dd = fn.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg)
    torch.cuda.synchronize()
    got = named(grads, dpts=dp, ddirs=dd)
    if runs is not None:
        runs.append(got)
    verdict = judge(rel_l2(got, ref32), scale, FLOOR[cfg.compute_dtype])
    verdict["ok"] = verdict["ok"] and fn.fused_nerf_bwd.launches == before + 1
    verdict["max_abs_err"] = max((got[k].double() - ref32[k].double()).abs().max().item() for k in ref32)
    return verdict


def kernel2_verdict(params, pts, dirs, gen) -> dict:
    """Kernel 2 on these points with seeded random cotangents against its
    plain version, as kernel_bwd holds it (:func:`bwd_verdict`)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    g_sigma = torch.randn((pts.shape[0],), generator=gen, device=pts.device)
    g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=pts.device)
    ref32 = bwd_reference(bf16_rounded(params), pts, dirs, g_sigma, g_rgb,
                          fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32))
    scale = rel_l2(bwd_reference(params, pts, dirs, g_sigma, g_rgb, fn.FusedNeRFConfig(**FULL)), ref32)
    return dict(points=pts.shape[0], **bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref32, scale))


def phase_kernel_bwd(batch):
    """Kernel 2 (the field's backward) against its plain version at full
    width, with seeded random cotangents: on 2^16 + 37 random points and at
    the main path's shapes, the coarse and fine points of a train batch
    (4096 x 64 = 262,144 and 4096 x 192 = 786,432, each with its own split
    of the dW GEMMs); PyTorch-default weights and their He-scaled copy. Each
    of the 22 grads, dpts and ddirs within 2x the plain bf16 version's
    relative L2 error against f32 (on the same bf16-rounded weights) +
    1e-3; on the random points a second launch must give the same grads bit
    for bit (no atomics). Then the planted faults on the random points,
    each of which must fail that check with the He-scaled weights."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    m = 2**16 + 37
    cases = {
        "random": (torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0,
                   torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)),
        "coarse": ray_points(batch["o"], batch["d"], batch["t_c"]),
        "fine": ray_points(batch["o"], batch["d"], batch["t_f"]),
    }
    cfg = fn.FusedNeRFConfig(**FULL)
    cfg32 = fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32)
    base = _seeded_params(0, dev)
    results, faults, max_abs = {}, {}, 0.0
    for case, (pts, dirs) in cases.items():
        g_sigma = torch.randn((pts.shape[0],), generator=gen, device=dev)
        g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
        for wname, params in (("port_init", base), ("he", he_scaled(base))):
            ref32 = bwd_reference(bf16_rounded(params), pts, dirs, g_sigma, g_rgb, cfg32)
            scale = rel_l2(bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg), ref32)

            def check(runs=None):
                return bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref32, scale, runs)

            runs = []
            key = f"{case}/{wname}"
            results[key] = dict(points=pts.shape[0], **check(runs))
            max_abs = max(max_abs, results[key]["max_abs_err"])
            if case != "random":
                continue
            # a second launch on the same inputs: the same grads, bit for bit
            check(runs)
            same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
            results[key].update(relaunch_bit_identical=same, ok=results[key]["ok"] and same)
            for fname, fault in TRAIN_FAULTS.items():
                with planted(fault):
                    v = check()
                faults[f"{wname}/{fname}"] = {"rejected": not v["ok"], "worst": v["worst"],
                                             "worst_err": v["worst_err"], "worst_limit": v["worst_limit"]}
    general = general_bwd_checks(batch)
    ok = all(r["ok"] for r in results.values()) and all(
        v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel_bwd", cases=results, planted_faults=faults,
         tolerance="rel L2 <= 2 * plain bf16 rel L2 + 1e-3, each of 22 grads, dpts, ddirs",
         rule="every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_bwd failed")
    return {"max_abs_err": max_abs, "general": general}


@contextlib.contextmanager
def planted_general(index, kind, which):
    """Route the general route's layout (``fused_nerf.tc_layout``) through
    :func:`tc_fault` of layer ``index`` in its forward (``which`` 0) or
    chain (2) images."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    real = fn.tc_layout

    def broken(params, cfg):
        out = list(real(params, cfg))
        images = list(out[which])
        tc_fault(images, fn.tc_matrices(params, cfg)[which // 2], index, kind,
                 fn.tc_pass_rows(cfg)[which // 2][index])
        out[which] = images
        return tuple(out)

    fn.tc_layout = broken
    try:
        yield
    finally:
        fn.tc_layout = real


@contextlib.contextmanager
def planted_low_piece():
    """Route the f32 route's layout through :func:`low_piece_dropped`:
    every forward and chain image without its low bf16 piece."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    real = fn.tc_layout

    def broken(params, cfg):
        fwd, biases, chain = real(params, cfg)
        fwd_rows, chain_rows = fn.tc_pass_rows(cfg)
        return low_piece_dropped(fwd, fwd_rows), biases, low_piece_dropped(chain, chain_rows)

    fn.tc_layout = broken
    try:
        yield
    finally:
        fn.tc_layout = real


# the training kernels' faults on the general route: (layer, kind, matrices)
GENERAL_TRAIN_FAULTS = {
    "chain_fc_6_zeroed": (6, "zeroed", 2),
    "fwd_fc_2_k_tiles_rolled": (2, "k_tiles_rolled", 0),
    "chain_fc_3_other_layout": (3, "other_layout", 2),
}


@contextlib.contextmanager
def planted_rounding(bits: int):
    """Route the f32 route's matrices (``fused_nerf.tc_matrices``, before
    their bf16 pieces) through :func:`rounded_to`: every forward and chain
    matrix at ``bits`` mantissa bits, as a chain of TF32 or bf16 products
    would read its weights."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    real = fn.tc_matrices

    def rounded(params, cfg, stash=True):
        fwd, chain = real(params, cfg, stash)
        return [rounded_to(x, bits) for x in fwd], [rounded_to(x, bits) for x in chain]

    fn.tc_matrices = rounded
    try:
        yield
    finally:
        fn.tc_matrices = real


def general_train_faults(route: str) -> dict:
    """name -> a context that plants it in ``route``'s training kernels:
    :data:`GENERAL_TRAIN_FAULTS` in the route's own layout, and in f32 the
    :data:`PRECISION_CONTROLS`."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    from torch_nerf_tpu_torch.runners.general_check import planted_dw_fault  # noqa: PLC0415

    out = {name: (lambda spec=spec: planted_general(*spec)) for name, spec in GENERAL_TRAIN_FAULTS.items()}
    if fn.ROUTE_DTYPE[route] == torch.float32:
        out.update({name: (lambda b=bits: planted_rounding(b)) for name, bits in PRECISION_CONTROLS.items()})
    out.update({f"dw_{kind}": (lambda k=kind: planted_dw_fault(k)) for kind in DW_PATH_FAULTS[fn.ROUTE_DTYPE[route]]})
    return out


# the dW GEMM's planted faults the path checks must reject (the f32 low
# piece alone, 2^-16 of an operand, sits under their 1e-5 floor: dw_gemm's
# check of the dW alone at the fine shape, floor 5e-7, holds it)
DW_PATH_FAULTS = {torch.bfloat16: ("slice_skipped", "db_dropped", "swizzle_off_by_one_chunk"),
                  torch.float32: ("slice_skipped", "db_dropped", "swizzle_off_by_one_chunk",
                                  "f32_low_and_mid_pieces_dropped")}


def general_bwd_checks(batch) -> dict:
    """Kernel 2 at paths A and B (:data:`GENERAL`: path A's f32 config,
    path B's width 512 with a 75-wide encoding in bf16) at the main path's
    fine shape, 4096 x 192 = 786,432 points of a train batch, with seeded
    random cotangents, PyTorch-default weights and their He-scaled copy:
    every grad, dpts and ddirs by :func:`bwd_verdict` against the plain
    version one precision up (:func:`reference_of`), the plain version's
    own error the scale; a second launch bit-identical. Then the planted
    faults of :func:`general_train_faults` on 2^16 + 37 random points, each
    of which must fail that check with the He-scaled weights. -> ``{route:
    max-abs error}``; raises on a failure."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    m = 2**16 + 37
    rand = (torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0,
            torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1))
    fine = ray_points(batch["o"], batch["d"], batch["t_f"])
    results, faults, worst = {}, {}, {}
    for route, g in GENERAL.items():
        cfg = width_cfg(g["feat_dim"], g["dtype"], g["coord_encode_level"])
        base = level_params(g["feat_dim"], g["coord_encode_level"], 0, dev)
        worst[route] = 0.0
        for case, (pts, dirs) in (("fine", fine), ("random", rand)):
            g_sigma = torch.randn((pts.shape[0],), generator=gen, device=dev)
            g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
            for wname, params in (("port_init", base), ("he", he_scaled(base))):
                rparams, rt, rcfg = reference_of(params, [pts, dirs, g_sigma, g_rgb], cfg)
                ref = bwd_reference(rparams, *rt, rcfg)
                scale = rel_l2(bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg), ref)

                def check(runs=None):
                    return bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref, scale, runs, cfg)

                key = f"{route}/{case}/{wname}"
                if case == "fine":
                    runs = []
                    results[key] = dict(points=pts.shape[0], **check(runs))
                    check(runs)
                    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
                    results[key].update(relaunch_bit_identical=same, ok=results[key]["ok"] and same)
                    worst[route] = max(worst[route], results[key]["max_abs_err"])
                    continue
                for fname, plant in general_train_faults(route).items():
                    with plant():
                        v = check()
                    faults[f"{wname}/{route}/{fname}"] = {"rejected": not v["ok"], "worst": v["worst"],
                                                         "worst_err": v["worst_err"],
                                                         "worst_limit": v["worst_limit"]}
    wide, wide_faults = tc_wide_bwd_checks(rand, gen)
    results.update(wide)
    faults.update(wide_faults)
    for key, r in wide.items():
        worst[key.rsplit("/", 1)[0]] = max(worst.get(key.rsplit("/", 1)[0], 0.0), r["max_abs_err"])
    ok = all(r["ok"] for r in results.values()) and all(
        v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel_bwd_general", cases=results, planted_faults=faults, routes={r: str(g) for r, g in GENERAL.items()},
         tolerance="rel L2 <= 2 * the plain version's rel L2 + FLOOR (bf16 1e-3, f32 1e-5), each of 22 grads, dpts, "
                   "ddirs; the reference one precision up (bf16: f32 on bf16-rounded weights; f32: f64)",
         rule="a second launch bit-identical; every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_bwd_general failed")
    worst["dw_gemm"] = dw_gemm_checks(fine, rand, gen)
    return worst


def tc_wide_bwd_checks(rand, gen) -> tuple:
    """Kernel 2 at each config of :data:`TC_WIDE` on the 2^16 + 37 random
    points ``rand`` with seeded random cotangents, the He-scaled
    PyTorch-default weights (every layer's signal reaches the outputs;
    kernel 1 is held with both sets), by :func:`bwd_verdict` against the plain
    version one precision up (f32 on the bf16-rounded weights) within 2x
    the plain bf16 version's error + 1e-3, on wgmma_general, a second
    launch bit-identical; then with the He-scaled weights the planted
    faults of :func:`tc_wide_train_faults`, each of which must fail that
    check. -> ``({"wgmma_general/<name>/<weights>": verdict}, {fault:
    verdict})``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    pts, dirs = rand
    results, faults = {}, {}
    for name, (feat, level, dl) in TC_WIDE.items():
        cfg = width_cfg(feat, torch.bfloat16, level, dl)
        base = level_params(feat, level, 0, dev, dl)
        g_sigma = torch.randn((pts.shape[0],), generator=gen, device=dev)
        g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
        for wname, params in (("he", he_scaled(base)),):
            rparams, rt, rcfg = reference_of(params, [pts, dirs, g_sigma, g_rgb], cfg)
            ref = bwd_reference(rparams, *rt, rcfg)
            scale = rel_l2(bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg), ref)

            def check(runs=None):
                return bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref, scale, runs, cfg)

            before = fn.fused_nerf_bwd.route_launches["wgmma_general"]
            runs = []
            v = check(runs)
            check(runs)
            same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
            on_route = fn.fused_nerf_bwd.route_launches["wgmma_general"] == before + 2
            results[f"wgmma_general/{name}/{wname}"] = dict(
                v, points=pts.shape[0], route=fn.train_route(cfg), relaunch_bit_identical=same,
                ok=v["ok"] and same and on_route)
            for fname, plant in tc_wide_train_faults(cfg).items():
                with plant():
                    f = check()
                faults[f"he/wgmma_general/{name}/{fname}"] = {"rejected": not f["ok"], "worst": f["worst"],
                                                             "worst_err": f["worst_err"],
                                                             "worst_limit": f["worst_limit"]}
        torch.cuda.empty_cache()
    return results, faults


def f32_config(name: str) -> dict:
    """The config of :data:`F32_WIDE`'s ``name`` as :data:`GENERAL`'s are
    given."""
    feat, level, dl = F32_WIDE[name]
    return dict(feat_dim=feat, coord_encode_level=level, dir_encode_level=dl, dtype=torch.float32)


# the configs whose dW plan's Python twin (fused_nerf.dw_tc_plan) and C++
# side (fused_general_dw_plan) must agree, and the point counts
DW_TWIN_CONFIGS = [(f, lv, dt) for f in (64, 96, 160, 256, 320, 512, 576, 1000, 1024) for lv in (10, 12)
                   for dt in (torch.bfloat16, torch.float32)]
DW_TWIN_POINTS = (786_432, 262_144, 2**16 + 37, 4093 * 64, 1)


def dw_gemm_checks(fine, rand, gen) -> dict:
    """The general route's dW GEMM alone (``csrc/nerf_dw_tc.cuh``) over
    kernel 2's stashes (``fused_nerf.general_stash``): paths A and B
    (:data:`GENERAL`) on the fine batch's 786,432 points with port-init
    weights and on 2^16 + 37 random points with the He-scaled copy, the
    f32 configs of :data:`F32_TIMED` and the bf16 ones of :data:`TC_TIMED`
    on the random points; each layer's
    dW and db against the plain version (``backward_from_activations``'
    products) on the same stash, the exact f64 sums the reference, within
    2x the plain version's relative L2 + ``general_check.DW_FLOOR`` (bf16
    1e-3, f32 5e-7); a second launch bit-identical. Then, on paths A and
    B's fine stashes, every planted fault of the dW GEMM
    (``general_check.dw_fault_checks``), each of which must fail that
    check; and the plan's Python twin against the library's at
    :data:`DW_TWIN_CONFIGS` x :data:`DW_TWIN_POINTS`. Prints each config's
    route, tiles, slices, windows and workspace bytes at the fine shape.
    -> ``{route: {"max_abs_err", ...}}``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import general_check as gc  # noqa: PLC0415

    dev = torch.device("cuda")
    out, ok = {}, True
    wide = {f"wgmma_general/{n}": dict(feat_dim=TC_WIDE[n][0], coord_encode_level=TC_WIDE[n][1],
                                       dir_encode_level=TC_WIDE[n][2], dtype=torch.bfloat16) for n in TC_TIMED}
    wide.update({f"f32_wgmma/{n}": f32_config(n) for n in F32_TIMED})
    configs = [(r, g, True) for r, g in GENERAL.items()] + [(r, g, False) for r, g in wide.items()]
    for route, g, main_path in configs:
        dl = g.get("dir_encode_level", FULL["dir_encode_level"])
        cfg = width_cfg(g["feat_dim"], g["dtype"], g["coord_encode_level"], dl)
        base = level_params(g["feat_dim"], g["coord_encode_level"], 0, dev, dl)
        cases = {"random/he": (he_scaled(base), rand)}
        if main_path:
            cases = {"fine/port_init": (base, fine), **cases}
        checks, faults = {}, {}
        for case, (params, (pts, dirs)) in cases.items():
            g_sigma = torch.randn((pts.shape[0],), generator=gen, device=dev)
            g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
            workspace = fn.general_stash(params, pts, dirs, g_sigma, g_rgb, cfg)
            ref = gc.dw_reference(cfg, workspace, pts.shape[0])
            checks[case] = gc.dw_check(cfg, workspace, pts.shape[0], ref)
            if case.startswith("fine/"):
                faults = gc.dw_fault_checks(cfg, workspace, pts.shape[0], ref)
            del workspace, ref
        plan = fn.dw_tc_plan(cfg, fine[0].shape[0])
        row = dict(route=fn.train_route(cfg), config={k: str(v) for k, v in g.items()}, checks=checks,
                   fine_plan={"tiles": len(plan.jobs), "slices": plan.splits, "points_a_slice": plan.chunk,
                              "slices_a_launch": plan.window, "launches": plan.windows,
                              "smem_bytes": plan.smem_bytes, "workspace_bytes": plan.workspace_bytes},
                   max_abs_err=max(c["max_abs_err"] for c in checks.values()))
        if main_path:
            row["planted_faults_fine"] = faults
        row["ok"] = all(c["ok"] for c in checks.values()) and all(v["rejected"] for v in faults.values())
        ok = ok and row["ok"]
        out[route] = row
        torch.cuda.empty_cache()
    twin = {}
    for feat, level, dtype in DW_TWIN_CONFIGS:
        cfg = width_cfg(feat, dtype, level)
        for m in DW_TWIN_POINTS:
            p = fn.dw_tc_plan(cfg, m)
            twin[f"{feat}/{level}/{str(dtype)[6:]}/{m}"] = (
                (len(p.jobs), p.splits, p.chunk, p.smem_bytes, p.workspace_bytes, p.window, p.windows)
                == fn.dw_plan_on_card(cfg, m))
    ok = ok and all(twin.values())
    emit("dw_gemm", configs=out, twin_agrees={"configs": len(twin), "ok": all(twin.values()),
                                              "disagree": [k for k, v in twin.items() if not v]},
         tolerance="each layer's dW and db rel L2 <= 2 * the plain version's (f32 sums of the stash) + "
                   "general_check.DW_FLOOR (bf16 1e-3, f32 5e-7), the exact f64 sums the reference",
         rule="a second launch bit-identical; every planted fault fails the check at the fine shape", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: dw_gemm failed")
    return out


def train_reference(params, o, d, t, delta, gt, cfg, num_real):
    """The plain train pass over ray slices of about
    :func:`reference_points` points, the grads summed: the whole batch in
    f32 would hold tens of GB."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    n, s = t.shape
    step = max(1, reference_points(cfg) // s)
    rgbs, ws, total = [], [], None
    for a in range(0, n, step):
        b = min(n, a + step)
        c, w, g = ftm.fused_train_pass_reference(params, o[a:b], d[a:b], t[a:b], delta[a:b], gt[a:b],
                                                 cfg, num_real, first_ray=a)
        rgbs.append(c)
        ws.append(w)
        total = sum_trees(total, g)
    return torch.cat(rgbs), torch.cat(ws), total


def train_batch(dev, seed=3, rays=4096):
    """A ray batch of the train path: 4096 random pixels of a 400x400
    training view, their colours, the coarse depths of a real draw and the
    fine depths (192 a ray, sorted) drawn from the plain f32 coarse weights
    of the He-scaled network."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(seed)
    camera = cameras.CameraParams(480.0, 480.0, 400, 400)  # make_dataset(8, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    pix = torch.randperm(400 * 400, generator=gen, device=dev)[:rays]
    o, d = cameras.rays_for_pixels(pix, camera, pose)
    o, d = o.contiguous(), d.contiguous()
    gt = torch.rand((rays, 3), generator=gen, device=dev)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    uni = renderer.draw_uniforms(gen, rays, settings)
    t_c = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far)
    cfg32 = fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32)
    _, w_c, _ = train_reference(he_scaled(_seeded_params(0, dev)), o, d, t_c, sampling.t_deltas(t_c),
                                gt, cfg32, rays)
    return dict(o=o, d=d, gt=gt, t_c=t_c.contiguous(), t_f=fine_depths(w_c, uni, settings))


def fine_depths(w_coarse, uni, settings):
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    return sampling.hierarchical_t_samples_from_uniforms(
        w_coarse, settings.t_near, settings.t_far, uni.fine_coarse, uni.u, uni.fine
    ).contiguous()


def composite_errors(c, w, c32, w32, cbf, wbf, tail, floor: float = FLOOR[torch.bfloat16]) -> dict:
    """rgb (N, 3) and weights (N, S) of a pass against the plain f32
    version's, each measure within 2x the plain bf16 version's own +
    ``floor`` (for f32: against f64, the plain f32 version's the scale):
    the relative L2 error of each; the max-abs error of the weights but at
    the ray's tail, the intervals of ``tail`` (N, S) (delta 1e8: the last
    one of a dense plane, the last kept sample's of a pruned ray that took
    the tail), whose weight jumps between 0 and the ray's transmittance
    when sigma's bf16 rounding crosses 0 there; and the max-abs error of rgb
    on the rays where neither the pass nor the plain bf16 version moved a
    tail weight by more than 1e-3."""
    def moved(w_):
        return (((w_ - w32).abs() > 1e-3) & tail).any(dim=-1)

    flip = moved(w) | moved(wbf)
    keep = ~flip

    def measures(c_, w_):
        return {"rgb_rel_l2": rel_l2({"x": c_}, {"x": c32})["x"],
                "weights_rel_l2": rel_l2({"x": w_}, {"x": w32})["x"],
                "weights_max_abs_but_last": ((w_ - w32).abs() * ~tail).max().item(),
                "rgb_max_abs_unflipped": (c_[keep] - c32[keep]).abs().max().item() if keep.any() else 0.0}

    err, scale = measures(c, w), measures(cbf, wbf)
    limit = {k: 2.0 * scale[k] + floor for k in err}
    ok = all(math.isfinite(err[k]) and err[k] <= limit[k] for k in err)
    return dict(ok=ok, err=err, limit=limit, flipped_rays=int(flip.sum()),
                plain_flipped_rays=int(moved(wbf).sum()),
                max_abs_err=max((c - c32).abs().max().item(), (w - w32).abs().max().item()))


# faults planted in the pass's composite: the intervals of the next ray read
# in place of the ray's own (a wrong row stride into delta), and each of its
# two outputs stored one place off (the next sample's weight, the next
# ray's colour), with the grads left right, so only the composite's checks
# can see them
COMPOSITE_FAULTS = {
    "delta_of_next_ray": dict(delta=lambda x: torch.roll(x, -1, dims=0)),
    "weights_stored_one_sample_off": dict(out=lambda c, w: (c, torch.roll(w, 1, dims=1))),
    "rgb_stored_one_ray_off": dict(out=lambda c, w: (torch.roll(c, 1, dims=0), w)),
}


def pruned_planes(batch, dev):
    """The occupancy-pruned ``(t, delta)`` planes of the batch's rays
    (``occupancy.prune_t_samples``, bench.py --occupancy's budgets): K = 32
    of the 64 coarse depths and K = 128 of the 192 merged fine ones, on a
    64^3 grid over [-4, 4]^3 with 60% of its cells occupied at random (no
    warmup), so that some rays are over budget (the last kept sample takes
    the 1e8 tail where the last dense one is occupied) and some under (their
    padding after the kept samples, out of t order); with counts of each."""
    from torch_nerf_tpu_torch import occupancy  # noqa: PLC0415

    cfg = occupancy.OccupancyConfig(resolution=64, bound=4.0, threshold=0.4, warmup_steps=0)
    grid = torch.rand((64**3,), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    planes, stats = {}, {}
    for name, t, keep in (("pruned_coarse", batch["t_c"], 32), ("pruned_fine", batch["t_f"], 128)):
        pts = batch["o"][:, None, :] + t[..., None] * batch["d"][:, None, :]
        kept = occupancy.quota_keep_mask(occupancy.occupied_mask(grid, pts, cfg, 0), keep).sum(-1)
        tp, dp = occupancy.prune_t_samples(grid, cfg, batch["o"], batch["d"], t, 0, keep=keep)
        planes[name] = (tp.contiguous(), dp.contiguous())
        stats[name] = dict(shape=list(tp.shape), rays_over_budget=int((kept == keep).sum()),
                           rays_with_tail=int((dp >= 1e7).any(-1).sum()),
                           rays_padded_out_of_t_order=int(((tp[:, 1:] < tp[:, :-1]).any(-1) & (kept < keep)).sum()))
    return planes, stats


def phase_kernel_train(batch):
    """Kernel 3 (the fused train pass) against its plain version at the main
    path's shapes, 4096 x 64 and 4096 x 192 (sorted depths from a real
    draw), a ragged 4093-ray batch with 4090 real rays, and the occupancy-
    pruned planes of the same rays (:func:`pruned_planes`: 4096 x 32 and
    4096 x 128, covered spans as deltas, some rays with the 1e8 tail on
    their last kept sample and padding out of t order); PyTorch-default
    and He-scaled weights. rgb and weights as :func:`composite_errors`
    measures them; the 22 grads by relative L2 as in kernel_bwd; at the
    coarse and the pruned shapes a second launch bit-identical. Then, at the coarse shape,
    the planted weight-image faults and composite faults,
    each of which must fail the check with the He-scaled weights (the
    composite faults by rgb and weights alone)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = torch.device("cuda")
    cfg = fn.FusedNeRFConfig(**FULL)
    cfg32 = fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32)
    o, d, gt = batch["o"], batch["d"], batch["gt"]
    base = _seeded_params(0, dev)
    sets = {"port_init": base, "he": he_scaled(base)}
    planes, plane_stats = pruned_planes(batch, dev)
    cases = {"coarse": (4096, 4096, batch["t_c"], None), "fine": (4096, 4096, batch["t_f"], None),
             "ragged": (4093, 4090, batch["t_c"][:4093], None),
             **{name: (4096, 4096, tp, dp) for name, (tp, dp) in planes.items()}}
    results, faults, max_abs = {}, {}, 0.0
    for case, (n, real, t, delta) in cases.items():
        t = t.contiguous()
        delta = sampling.t_deltas(t) if delta is None else delta
        tail = delta >= 1e7
        args = (o[:n], d[:n], t, delta, gt[:n])
        for wname, params in sets.items():
            c32, w32, g32 = train_reference(bf16_rounded(params), *args, cfg32, real)
            cbf, wbf, gbf = train_reference(params, *args, cfg, real)
            ref32 = named(g32)
            scale = rel_l2(named(gbf), ref32)

            def check(delta_in=delta, out=None, runs=None):
                before = ftm.fused_train_pass.launches
                c, w, g = ftm.fused_train_pass(params, o[:n], d[:n], t, delta_in, gt[:n], cfg, real)
                torch.cuda.synchronize()
                if runs is not None:
                    runs.append(named(g, rgb=c, weights=w))
                if out is not None:
                    c, w = out(c, w)
                verdict = judge(rel_l2(named(g), ref32), scale)
                comp = composite_errors(c, w, c32, w32, cbf, wbf, tail)
                verdict.update(grads_ok=verdict["ok"], composite=comp)
                verdict["ok"] = (verdict["ok"] and comp["ok"]
                                 and ftm.fused_train_pass.launches == before + 1)
                verdict["max_abs_err"] = max([comp["max_abs_err"]] + [
                    (g[n_][k] - g32[n_][k]).abs().max().item() for n_ in g for k in g[n_]])
                return verdict

            runs = []
            key = f"{case}/{wname}"
            results[key] = check(runs=runs)
            max_abs = max(max_abs, results[key]["max_abs_err"])
            if case not in ("coarse", "pruned_coarse", "pruned_fine"):
                continue
            # a second launch on the same inputs: the same outputs, bit for bit
            check(runs=runs)
            same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
            results[key].update(relaunch_bit_identical=same, ok=results[key]["ok"] and same)
            if case != "coarse":
                continue
            for fname, fault in TRAIN_FAULTS.items():
                with planted(fault):
                    v = check()
                faults[f"{wname}/{fname}"] = {"rejected": not v["ok"], "worst": v["worst"],
                                             "worst_err": v["worst_err"], "worst_limit": v["worst_limit"]}
            for fname, fault in COMPOSITE_FAULTS.items():
                v = check(delta_in=fault.get("delta", lambda x: x)(delta).contiguous(), out=fault.get("out"))
                faults[f"{wname}/{fname}"] = {"rejected": not v["composite"]["ok"],
                                             "composite_err": v["composite"]["err"],
                                             "composite_limit": v["composite"]["limit"]}
    ok = all(r["ok"] for r in results.values()) and all(
        v["rejected"] for k, v in faults.items() if k.startswith("he/")) and all(
        v["rays_over_budget"] and v["rays_with_tail"] and v["rays_padded_out_of_t_order"] for v in plane_stats.values())
    emit("kernel_train", cases=results, pruned_planes=plane_stats, planted_faults=faults,
         tolerance="rgb, weights as composite_errors (rel L2; max-abs of weights but the last "
                   "interval; max-abs of rgb on unflipped rays), grads rel L2: each <= 2 * plain bf16 + 1e-3",
         rule="every planted fault rejected with the he weights (composite faults by rgb, weights alone)",
         ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_train failed")
    return {"max_abs_err": max_abs, "general": general_train_checks(batch)}


def general_train_checks(batch) -> dict:
    """Kernel 3 at paths A and B (:data:`GENERAL`) at the main path's
    shapes, 4096 x 64 and 4096 x 192 (the batch's sorted depths), with
    PyTorch-default weights and their He-scaled copy: rgb and weights as
    :func:`composite_errors` measures them and the 22 grads by relative L2,
    each against the plain version one precision up (:func:`reference_of`)
    within 2x the plain version's own error + the type's :data:`FLOOR`; a second launch
    bit-identical. Then, at the coarse shape, the planted faults of
    :func:`general_train_faults`, each of which must fail the check with
    the He-scaled weights. -> ``{route: max-abs error}``; raises on a
    failure."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = torch.device("cuda")
    o, d, gt = batch["o"], batch["d"], batch["gt"]
    results, faults, worst = {}, {}, {}
    for route, g in GENERAL.items():
        cfg = width_cfg(g["feat_dim"], g["dtype"], g["coord_encode_level"])
        base = level_params(g["feat_dim"], g["coord_encode_level"], 0, dev)
        worst[route] = 0.0
        for case, t in (("coarse", batch["t_c"]), ("fine", batch["t_f"])):
            delta = sampling.t_deltas(t)
            tail = delta >= 1e7
            args = (o, d, t, delta, gt)
            for wname, params in (("port_init", base), ("he", he_scaled(base))):
                rparams, rargs, rcfg = reference_of(params, list(args), cfg)
                cr, wr, gr = train_reference(rparams, *rargs, rcfg, 4096)
                cp, wp, gp = train_reference(params, *args, cfg, 4096)
                ref = named(gr)
                scale = rel_l2(named(gp), ref)

                def check(runs=None):
                    before = ftm.fused_train_pass.launches
                    c, w, g_ = ftm.fused_train_pass(params, *args, cfg, 4096)
                    torch.cuda.synchronize()
                    if runs is not None:
                        runs.append(named(g_, rgb=c, weights=w))
                    verdict = judge(rel_l2(named(g_), ref), scale, FLOOR[g["dtype"]])
                    comp = composite_errors(c, w, cr.float(), wr.float(), cp, wp, tail, FLOOR[g["dtype"]])
                    verdict.update(grads_ok=verdict["ok"], composite=comp)
                    verdict["ok"] = verdict["ok"] and comp["ok"] and ftm.fused_train_pass.launches == before + 1
                    verdict["max_abs_err"] = max([comp["max_abs_err"]] + [
                        (g_[n_][k].double() - gr[n_][k].double()).abs().max().item() for n_ in g_ for k in g_[n_]])
                    return verdict

                runs = []
                key = f"{route}/{case}/{wname}"
                results[key] = check(runs)
                check(runs)
                same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
                results[key].update(relaunch_bit_identical=same, ok=results[key]["ok"] and same)
                worst[route] = max(worst[route], results[key]["max_abs_err"])
                if case != "coarse":
                    continue
                for fname, plant in general_train_faults(route).items():
                    with plant():
                        v = check()
                    faults[f"{wname}/{route}/{fname}"] = {"rejected": not v["ok"], "worst": v["worst"],
                                                         "worst_err": v["worst_err"],
                                                         "worst_limit": v["worst_limit"]}
    wide, wide_faults = tc_wide_train_checks(batch)
    results.update(wide)
    faults.update(wide_faults)
    for key, r in wide.items():
        config = "/".join(key.split("/")[:2])
        worst[config] = max(worst.get(config, 0.0), r["max_abs_err"])
    ok = all(r["ok"] for r in results.values()) and all(
        v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel_train_general", cases=results, planted_faults=faults,
         routes={r: str(g) for r, g in GENERAL.items()},
         tolerance="rgb, weights as composite_errors, grads rel L2: each <= 2 * the plain version's + FLOOR (bf16 "
                   "1e-3, f32 1e-5), the reference one precision up (bf16: f32 on bf16-rounded weights; f32: f64)",
         rule="a second launch bit-identical; every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_train_general failed")
    return worst


def train_verdict(params, args, cfg, ref, scale, cr, wr, gr, cp, wp, tail, runs=None) -> dict:
    """One kernel-3 launch of ``cfg`` on ``args`` (o, d, t, delta, gt; 4096
    real rays) against the plain version one precision up (``cr, wr, gr``;
    the plain version's own ``cp, wp`` and grads' error ``scale``): rgb and
    weights by :func:`composite_errors`, the 22 grads by relative L2, each
    within 2x the plain version's error + the type's :data:`FLOOR`; one
    launch. With ``runs``, the kernel's outputs are appended to it."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    before = ftm.fused_train_pass.launches
    c, w, g_ = ftm.fused_train_pass(params, *args, cfg, 4096)
    torch.cuda.synchronize()
    if runs is not None:
        runs.append(named(g_, rgb=c, weights=w))
    verdict = judge(rel_l2(named(g_), ref), scale, FLOOR[cfg.compute_dtype])
    comp = composite_errors(c, w, cr.float(), wr.float(), cp, wp, tail, FLOOR[cfg.compute_dtype])
    verdict.update(grads_ok=verdict["ok"], composite=comp)
    verdict["ok"] = verdict["ok"] and comp["ok"] and ftm.fused_train_pass.launches == before + 1
    verdict["max_abs_err"] = max([comp["max_abs_err"]] + [
        (g_[n_][k].double() - gr[n_][k].double()).abs().max().item() for n_ in g_ for k in g_[n_]])
    return verdict


def tc_wide_train_checks(batch) -> tuple:
    """Kernel 3 at each config of :data:`TC_WIDE` at the coarse shape (the
    batch's 4096 x 64 sorted depths) and, for :data:`TC_TIMED`, at the fine
    shape too (4096 x 192: the multi-pass forward and chain and the
    windowed dW at 1024 as the CLIs run them), the He-scaled
    PyTorch-default weights, by :func:`train_verdict` on wgmma_general, a
    second launch bit-identical; then, at the coarse shape, the planted
    faults of :func:`tc_wide_train_faults`, each of which must fail that
    check. -> ``({"wgmma_general/<name>/<shape>/<weights>": verdict},
    {fault: verdict})``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = torch.device("cuda")
    results, faults = {}, {}
    cases = [(name, "coarse") for name in TC_WIDE] + [(name, "fine") for name in TC_TIMED]
    for name, shape in cases:
        feat, level, dl = TC_WIDE[name]
        t = batch["t_c" if shape == "coarse" else "t_f"]
        delta = sampling.t_deltas(t)
        args = (batch["o"], batch["d"], t, delta, batch["gt"])
        cfg = width_cfg(feat, torch.bfloat16, level, dl)
        base = level_params(feat, level, 0, dev, dl)
        for wname, params in (("he", he_scaled(base)),):
            rparams, rargs, rcfg = reference_of(params, list(args), cfg)
            cr, wr, gr = train_reference(rparams, *rargs, rcfg, 4096)
            cp, wp, gp = train_reference(params, *args, cfg, 4096)
            ref = named(gr)
            scale = rel_l2(named(gp), ref)

            def check(runs=None):
                return train_verdict(params, args, cfg, ref, scale, cr, wr, gr, cp, wp, delta >= 1e7, runs)

            before = ftm.fused_train_pass.route_launches["wgmma_general"]
            runs = []
            v = check(runs)
            check(runs)
            same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
            on_route = ftm.fused_train_pass.route_launches["wgmma_general"] == before + 2
            results[f"wgmma_general/{name}/{shape}/{wname}"] = dict(
                v, points=t.numel(), route=fn.train_route(cfg), relaunch_bit_identical=same,
                ok=v["ok"] and same and on_route)
            for fname, plant in tc_wide_train_faults(cfg).items() if shape == "coarse" else ():
                with plant():
                    f = check()
                faults[f"he/wgmma_general/{name}/{fname}"] = {"rejected": not f["ok"], "worst": f["worst"],
                                                             "worst_err": f["worst_err"],
                                                             "worst_limit": f["worst_limit"]}
            del cr, wr, gr, cp, wp, gp, ref
        torch.cuda.empty_cache()
    return results, faults


def _field_and_params(dev, use_kernel=True, dtype=torch.bfloat16):
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415

    field = make_nerf_field(compute_dtype=dtype, use_kernel=use_kernel)
    return field, {"coarse": _seeded_params(0, dev), "fine": _seeded_params(1, dev)}


def phase_serve(work: Path):
    """run_render -> evaluate on two 128x128 test views, kernel launches
    counted over the render CLI alone."""
    from torch_nerf_tpu_torch import checkpoints, config, metrics, renderer, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render  # noqa: PLC0415

    dev = torch.device("cuda")
    run, out, gt = work / "run", work / "render", work / "gt"
    cfg = config.resolve("default", ["data.dataset_type=gaussian_blobs"])
    config.save_config(cfg, run / "config.yaml")
    _, params = _field_and_params(dev)
    checkpoints.save_checkpoint(run, 0, params)

    fn.reset_launches()
    t0 = time.perf_counter()
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out)])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = fn.fused_nerf_apply.launches
    routes = dict(fn.fused_nerf_apply.route_launches)

    data = session.build_dataset(cfg, "test", device=dev)
    gt.mkdir(parents=True)
    for i in range(2):
        save_png(gt / f"{i:04d}.png", data.images[i])
    scores = evaluate.main([str(out), str(gt)])
    pngs = sorted(out.iterdir())
    shapes = [list(load_png(p).shape) for p in pngs]

    # the same view through the kernel (bf16) and the plain version (bf16
    # and f32), on the same draws, with the checkpoint's weights and their
    # He-scaled copy: finite, of the expected shape, and the kernel's PSNR
    # against f32 at most 12.04 dB (4x the RMS error) below the plain bf16's
    settings = session.build_render_settings(cfg, data)
    gen_seed = 1234
    draws = {}

    def uniforms(first, n):
        if first not in draws:
            g = torch.Generator(device=dev).manual_seed(gen_seed + first)
            draws[first] = renderer.draw_uniforms(g, n, settings)
        return draws[first]

    pose = torch.as_tensor(data.poses[0], device=dev)
    agree, ok = {}, True
    for wname, nets in (("port_init", params), ("he", {k: he_scaled(v) for k, v in params.items()})):
        images = {}
        for name, use_kernel, dtype in (("kernel", True, torch.bfloat16),
                                        ("plain_bf16", False, torch.bfloat16),
                                        ("plain_f32", False, torch.float32)):
            field, _ = _field_and_params(dev, use_kernel, dtype)
            images[name] = renderer.render_image(
                field, nets["coarse"], nets["fine"], data.camera, pose, 0, settings,
                chunk_size=cfg.renderer.num_pixels, uniforms_for_chunk=uniforms,
            )
        img, ref = images["kernel"], images["plain_f32"]
        finite = bool(torch.isfinite(img).all())
        kernel_psnr = metrics.psnr(img, ref)
        limit = metrics.psnr(images["plain_bf16"], ref) - 12.04
        agree[wname] = dict(finite=finite, kernel_vs_plain_f32_psnr=kernel_psnr, psnr_limit=limit,
                            kernel_vs_plain_f32_max_abs=(img - ref).abs().max().item(),
                            plain_bf16_vs_plain_f32_max_abs=(images["plain_bf16"] - ref).abs().max().item(),
                            plain_f32_std=ref.std().item())
        ok = ok and finite and list(img.shape) == [128, 128, 3] and kernel_psnr >= limit
    want = 2 * 4 * 2  # views x 4096-ray chunks of a 128x128 view x passes
    ok = (ok and launches == want and routes["wgmma"] == want and shapes == [[128, 128, 3]] * 2
          and all(math.isfinite(v) for v in scores.values()))
    emit("serve", render_seconds=render_s, launches=launches, route_launches=routes, expected_launches=want,
         png_shapes=shapes, psnr_vs_gt=scores["psnr"], ssim_vs_gt=scores["ssim"],
         kernel_vs_plain=agree,
         tolerance="kernel psnr vs plain f32 >= plain bf16 psnr vs plain f32 - 12.04 dB", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: serve phase failed")
    return launches


def phase_bench(smi: str):
    """800x800 frames at bench.py --render's operating point (64 coarse +
    128 fine samples, 4096-ray chunks), then the kernel alone at the
    main path's chunk shapes: held against the plain version, and timed
    (CUDA events) beside its bound and the plain version's time."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    field, params = _field_and_params(dev)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    camera = cameras.CameraParams(960.0, 960.0, 800, 800)  # make_dataset(1, 800)
    pose = torch.as_tensor(synthetic.split_poses(1, "train")[0], device=dev)

    def frame(seed):
        return renderer.render_image(field, params["coarse"], params["fine"], camera, pose, seed,
                                     settings, chunk_size=4096)

    img = frame(1)  # warm-up
    torch.cuda.synchronize()
    frames = 3
    before, before_wgmma = fn.fused_nerf_apply.launches, fn.fused_nerf_apply.route_launches["wgmma"]
    t0 = time.perf_counter()
    for i in range(frames):
        img = frame(2 + i)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    per_frame_launches = (fn.fused_nerf_apply.launches - before) / frames
    per_frame_wgmma = (fn.fused_nerf_apply.route_launches["wgmma"] - before_wgmma) / frames
    s_per_frame = elapsed / frames

    # the kernel at the fine and coarse chunk shapes, on points of a real chunk
    cfg = fn.FusedNeRFConfig(**FULL)
    prepared = fn.prepare(params["fine"], cfg)
    prepared_he = fn.prepare(he_scaled(params["fine"]), cfg)
    o, d = cameras.rays_for_pixels(torch.arange(4096, device=dev), camera, pose)
    gen = torch.Generator(device=dev).manual_seed(5)
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    shapes = {}
    for name, samples in (("fine", 192), ("coarse", 64)):
        t = torch.sort(2.0 + 4.0 * torch.rand((4096, samples), generator=gen, device=dev)).values
        pts, dirs = ray_points(o, d, t)
        m = pts.shape[0]
        check = compare_with_plain(prepared, pts, dirs)
        check_he = compare_with_plain(prepared_he, pts, dirs)
        kernel_ms = cuda_ms(lambda: fn.fused_nerf_apply(prepared, pts, dirs, cfg), 20)
        plain_ms = cuda_ms(lambda: fn.fused_nerf_apply_reference(params["fine"], pts, dirs, cfg), 5)
        flops = fn.flops_per_point(cfg) * m
        nbytes = m * (3 + 3 + 1 + 3) * 4 + sum(t.numel() * 2 for t in prepared.weights + prepared.biases)
        bound = max(flops / peak_flops, nbytes / peak_bw) * 1e3
        shapes[name] = dict(points=m, max_abs_err=check["max_abs_err"],
                            plain_bf16_err=check["plain_bf16_err"],
                            he_max_abs_err=check_he["max_abs_err"],
                            he_plain_bf16_err=check_he["plain_bf16_err"],
                            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by="operations" if flops / peak_flops >= nbytes / peak_bw else "bytes",
                            tflops=flops / kernel_ms / 1e9, share_of_bound=bound / kernel_ms)
    chunks = -(-800 * 800 // 4096)
    kernel_s = chunks * (shapes["fine"]["ms"] + shapes["coarse"]["ms"]) / 1e3
    ok = bool(torch.isfinite(img).all()) and per_frame_launches == per_frame_wgmma == 2 * chunks
    emit("bench", card=smi, sm_clock_temp_power=clocks, frames=frames,
         seconds_per_frame=s_per_frame,
         rays_per_sec=800 * 800 / s_per_frame, launches_per_frame=per_frame_launches,
         wgmma_launches_per_frame=per_frame_wgmma,
         kernel_seconds_per_frame=kernel_s, kernel_share_of_frame=kernel_s / s_per_frame,
         peak_flops=peak_flops, peak_bytes_per_s=peak_bw, kernel=shapes, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: bench phase failed")
    return shapes


def phase_train(work: Path):
    """run_train on the card: the default config on gaussian_blobs at
    400x400 (8 views), 24 steps with one validation, one checkpoint and one
    visualisation, then a resume for 8 more steps, then run_render +
    evaluate on two test views. Kernel 3 launches counted over the two
    train runs: exactly 2 per step. Kernel 1 launches counted over the
    three CLI calls, all on its wgmma route: 2 per 4096-ray chunk of the
    validation's 800x800 view and the visualisation's 400x400 one, none in
    the resume, 2 x 157 per 800x800 test view."""
    from torch_nerf_tpu_torch import config, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    run, out, gt = work / "train_run", work / "train_render", work / "train_gt"
    overrides = ["data.dataset_type=gaussian_blobs", "data.img_size=400",
                 "train_params.validation.validate_every=3", "train_params.validation.num_batch=1",
                 "train_params.log.epoch_btw_ckpt=3", "train_params.log.epoch_btw_vis=3"]
    logs, results, launches, k1 = [], [], [], []
    t0 = time.perf_counter()
    for max_steps in (24, 32):
        launch_count.reset(ftm.fused_train_pass)
        fn.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results.append(run_train.main(["--config", "default", "--log-dir", str(run),
                                           "--max-steps", str(max_steps)] + overrides))
        torch.cuda.synchronize()
        launches.append(ftm.fused_train_pass.launches)
        k1.append(dict(fn.fused_nerf_apply.route_launches))
        logs.append(buf.getvalue())
    train_s = time.perf_counter() - t0
    losses = results[0]["losses"] + results[1]["losses"]

    fn.reset_launches()
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "2", "--out-dir", str(out)])
    torch.cuda.synchronize()
    k1.append(dict(fn.fused_nerf_apply.route_launches))
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    want_k1 = [2 * (chunks_800 + chunks_400), 0, 2 * 2 * chunks_800]
    cfg = config.load_config(run / "config.yaml")
    data = session.build_dataset(cfg, "test", device=torch.device("cuda"))
    gt.mkdir(parents=True)
    for i in range(2):
        save_png(gt / f"{i:04d}.png", data.images[i])
    scores = evaluate.main([str(out), str(gt)])
    shapes = [list(load_png(p).shape) for p in sorted(out.iterdir())]
    vis = sorted(str(p.relative_to(run)) for p in (run / "vis").rglob("*.png"))
    val = [ln for log in logs for ln in log.splitlines() if ln.startswith("validation @")]
    first8, last8 = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    ok = (launches == [48, 16] and [c["wgmma"] for c in k1] == want_k1
          and all(v == 0 for c in k1 for r, v in c.items() if r != "wgmma")
          and len(losses) == 32 and all(math.isfinite(v) for v in losses)
          and last8 < first8 and "Resumed from step 24." in logs[1] and len(val) == 1
          and vis == ["vis/epoch_3/pred_imgs/view_000.png"]
          and (run / "ckpt" / "ckpt_000024.pt").exists() and (run / "ckpt" / "ckpt_000032.pt").exists()
          and shapes == [[800, 800, 3]] * 2 and all(math.isfinite(v) for v in scores.values()))
    emit("train", seconds=train_s, steps=[r["step"] for r in results], kernel3_launches=launches,
         expected_launches=[48, 16], kernel1_route_launches=k1, expected_kernel1_wgmma=want_k1, losses=losses, mean_loss_first8=first8, mean_loss_last8=last8,
         validation=val, resumed="Resumed from step 24." in logs[1], vis=vis,
         png_shapes=shapes, psnr_vs_gt=scores["psnr"], ssim_vs_gt=scores["ssim"], ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train phase failed")
    return {"fused_train_pass": sum(launches), "fused_nerf_fwd": sum(c["wgmma"] for c in k1)}


def dw_launches_due(cfg, *shape_counts) -> int:
    """The dW GEMM kernel's launches that general-route kernel 2 and 3
    launches owe, from their counts by shape (``{points or (rays,
    samples): launches}``): ``fused_nerf.dw_tc_plan``'s windows a pass."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    return sum(c * fn.dw_tc_plan(cfg, shape[0] * shape[1] if isinstance(shape, tuple) else shape).windows
               for shapes in shape_counts for shape, c in shapes.items())


def train_resume_render_routes(work: Path, route: str) -> dict:
    """Path A (``route`` f32_wgmma) or B (wgmma_general) through the CLIs: ``run_train
    --config default`` with :data:`GENERAL_OVERRIDES` on gaussian_blobs at
    400x400 (8 views), 24 steps with a validation (an 800x800 val view, 157
    chunks), a checkpoint and a visualisation (a 400x400 view, 40 chunks),
    a resume for 8 more, then ``run_render`` + ``evaluate`` of two 800x800
    test views (:func:`train_resume_render`). Each call's launches counted
    by route from 0: kernel 3 twice a step and kernel 1 twice a 4096-ray
    chunk, all on ``route``, none on the others; kernel 2 not at all; the
    dW GEMM's kernel, as its libraries counted it, as often as kernel 3's
    launches owe (:func:`dw_launches_due`), at least once each."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    counted = [ftm.fused_train_pass, fn.fused_nerf_apply, fn.fused_nerf_bwd, fn.dw_gemm]
    done = train_resume_render(work, GENERAL_PHASES[route], ["--config", "default"] + GENERAL_OVERRIDES[route]
                               + NGP_TRAIN_OVERRIDES, counted)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)

    def on_route(k3, k1, dw):
        return [{r: (k3 if r == route else 0) for r in fn.ROUTES}, {r: (k1 if r == route else 0) for r in fn.ROUTES},
                dict.fromkeys(fn.ROUTES, 0), {r: (dw if r == route else 0) for r in fn.ROUTES}]

    # the dW GEMM's launches, as its libraries counted them, against those
    # that kernel 3's launches of each shape owe (the plan's windows a pass)
    g = GENERAL[route]
    cfg = width_cfg(g["feat_dim"], g["dtype"], g["coord_encode_level"])
    dw_due = [dw_launches_due(cfg, shapes[0], shapes[2]) for shapes in done["shapes"] + [done["render_shapes"]]]
    want = [on_route(48, 2 * (chunks_800 + chunks_400), dw_due[0]), on_route(16, 0, dw_due[1]),
            on_route(0, 2 * 2 * chunks_800, dw_due[2])]
    got = done["route_launches"]
    ok = done["ok"] and got == want
    name = GENERAL_PHASES[route]
    emit(name, route=route, config=GENERAL_OVERRIDES[route], seconds=done["seconds"],
         route_launches_kernel3_kernel1_kernel2_dw={"train": got[0], "resume": got[1], "render": got[2]},
         expected={"train": want[0], "resume": want[1], "render": want[2]}, **done["report"], ok=ok)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} phase failed")
    return {"fused_train_pass": sum(c[0][route] for c in got), "fused_nerf_fwd": sum(c[1][route] for c in got),
            "dw_gemm": sum(c[3][route] for c in got)}


# the full-width CLI phases of the tensor-core engine's column passes: the
# default preset at width 1024 in bf16 (four passes of 128) and in f32
# (streaming, eight passes of 64, its kernel 3 ~8x bf16's: 1024 rays a
# step), its views at 200x200 (data.img_size 100) so that each phase is
# seconds of steps; by phase: (route, overrides, rays a step and a render
# chunk)
WIDE_PHASES = {"train_1024": ("wgmma_general", ["network.feat_dim=1024"], 4096),
               "train_f32_1024": ("f32_wgmma", ["network.feat_dim=1024", "device.compute_dtype=float32",
                                                "renderer.num_pixels=1024"], 1024)}


def phase_train_1024(work: Path, phase: str = "train_1024") -> dict:
    """Width 1024 through the CLIs on the route of :data:`WIDE_PHASES`
    ``phase``: ``run_train --config default network.feat_dim=1024`` (f32:
    ``device.compute_dtype=float32``) on gaussian_blobs at 100x100 (8
    views), 24 steps with a validation (a 200x200 view, 10 chunks), a
    checkpoint and a visualisation (100x100, 3 chunks), a resume for 8
    more, then ``run_render`` + ``evaluate`` of two 200x200 test views.
    Each call's launches counted by route from 0: kernel 3 twice a step and
    kernel 1 twice a render chunk (the phase's rays), all on the phase's route, none on
    another; kernel 2 not at all; the dW GEMM's kernel as often as kernel
    3's launches owe."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    route, overrides, rays = WIDE_PHASES[phase]
    counted = [ftm.fused_train_pass, fn.fused_nerf_apply, fn.fused_nerf_bwd, fn.dw_gemm]
    small = [o.replace("data.img_size=400", "data.img_size=100") for o in NGP_TRAIN_OVERRIDES]
    done = train_resume_render(work, phase, ["--config", "default"] + overrides + small, counted, size=200)
    chunks_val, chunks_vis = -(-200 * 200 // rays), -(-100 * 100 // rays)

    def on_route(k3, k1, dw):
        return [{r: (k3 if r == route else 0) for r in fn.ROUTES}, {r: (k1 if r == route else 0) for r in fn.ROUTES},
                dict.fromkeys(fn.ROUTES, 0), {r: (dw if r == route else 0) for r in fn.ROUTES}]

    cfg = width_cfg(1024, fn.ROUTE_DTYPE[route], 10)
    dw_due = [dw_launches_due(cfg, shapes[0], shapes[2]) for shapes in done["shapes"] + [done["render_shapes"]]]
    want = [on_route(48, 2 * (chunks_val + chunks_vis), dw_due[0]), on_route(16, 0, dw_due[1]),
            on_route(0, 2 * 2 * chunks_val, dw_due[2])]
    got = done["route_launches"]
    ok = done["ok"] and got == want and all(d > 0 for d in dw_due[:2])
    emit(phase, route=route, config=overrides, seconds=done["seconds"],
         route_launches_kernel3_kernel1_kernel2_dw={"train": got[0], "resume": got[1], "render": got[2]},
         expected={"train": want[0], "resume": want[1], "render": want[2]}, **done["report"], ok=ok)
    if not ok:
        raise SystemExit(f"chip_smoke: {phase} phase failed")
    return {"fused_train_pass": sum(c[0][route] for c in got), "fused_nerf_fwd": sum(c[1][route] for c in got),
            "dw_gemm": sum(c[3][route] for c in got)}


def bench_step(step, state, grid, images, poses, gen):
    """One image train step, threading the occupancy grid where there is one."""
    if grid is None:
        state, metrics = step(state, images, poses, gen)
    else:
        state, grid, metrics = step(state, grid, images, poses, gen)
    return state, grid, metrics


def phase_train_bench(smi: str):
    """Train steps at bench.py's operating point (8 views at 400x400, 4096
    rays, 64 + 128 samples, make_image_train_step(precrop=False)): 3 warm-up
    and 20 timed steps, fused, force_generic, and fused with occupancy
    pruning at ``bench.py --occupancy``'s point (32 of 64 coarse, 128 of 192
    fine, the default grid: its warmup of 512 steps reads every cell
    occupied, a sweep every 16 steps), with the launches of each path
    counted over its timed steps; then kernel 3 alone per coarse and
    fine pass and kernel 2 at the fine shape (CUDA events), beside their
    bounds and the plain versions' times."""
    from torch_nerf_tpu_torch import occupancy, renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners.train_ab import step_batch  # noqa: PLC0415

    dev = torch.device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images = torch.as_tensor(images, device=dev)
    poses = torch.as_tensor(poses, device=dev)
    field = make_nerf_field(compute_dtype=torch.bfloat16)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    timed = 20
    paths, states = {}, {}
    occ_bench = occupancy.OccupancyConfig(keep_samples=32, keep_samples_fine=128)
    for path, generic, occ in (("fused", False, None), ("generic", True, None), ("fused_occupancy", False, occ_bench)):
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic,
                                           occupancy_cfg=occ)
        grid = occupancy.init_grid(occ, dev) if occ else None
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(3):
            state, grid, _ = bench_step(step, state, grid, images, poses, gen)
        torch.cuda.synchronize()
        launch_count.reset(ftm.fused_train_pass)
        fn.reset_launches()
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            state, grid, metrics = bench_step(step, state, grid, images, poses, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        paths[path] = dict(ms_per_step=elapsed / timed * 1e3, rays_per_sec=4096 * timed / elapsed,
                           launches={"fused_train_pass": ftm.fused_train_pass.launches,
                                     "fused_nerf_fwd": fn.fused_nerf_apply.launches,
                                     "fused_nerf_bwd": fn.fused_nerf_bwd.launches},
                           kernel3_shapes={f"{n}x{s_}": c for (n, s_), c in ftm.fused_train_pass.shapes.items()},
                           loss_first=losses[0], loss_last=losses[-1],
                           finite=all(math.isfinite(v) for v in losses))
        if occ is None:
            states[path] = (state, step, gen)
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")

    # the kernels alone, on a batch of the fused path's own step
    state, step, gen = states["fused"]
    cfg = field.fused_cfg
    pc, pf = state.params["coarse"], state.params["fine"]
    o, d, gt, uni = step_batch(step, images, poses, camera, gen)
    t_c = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far)
    with torch.no_grad():
        _, w_c, _ = ftm.fused_train_pass(pc, o, d, t_c, sampling.t_deltas(t_c), gt, cfg, 4096)
        t_f = fine_depths(w_c, uni, settings)
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    param_bytes = 4 * sum(t.numel() for p in (pc,) for v in p.values() for t in v.values())
    kernels = {}
    with torch.no_grad():
        for name, params, t in (("coarse", pc, t_c), ("fine", pf, t_f)):
            delta = sampling.t_deltas(t)
            m = t.numel()
            ms = cuda_ms(lambda: ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, 4096), 10)
            plain = cuda_ms(lambda: train_reference(params, o, d, t, delta, gt, cfg, 4096), 2)
            flops = 3 * fn.flops_per_point(cfg) * m
            # t, delta in; weights out; rays' o, d, gt in, rgb out; params in, grads out
            nbytes = 12 * m + 48 * 4096 + 2 * param_bytes
            kernels[f"fused_train_pass/{name}"] = bound_entry(ms, plain, flops, nbytes, peak_flops, peak_bw, m)
        pts, dirs = ray_points(o, d, t_f)
        m = pts.shape[0]
        g = torch.Generator(device=dev).manual_seed(4)
        g_sigma = torch.randn((m,), generator=g, device=dev)
        g_rgb = torch.randn((m, 3), generator=g, device=dev)
        ms = cuda_ms(lambda: fn.fused_nerf_bwd(pf, pts, dirs, g_sigma, g_rgb, cfg), 5)
        plain = cuda_ms(lambda: bwd_reference(pf, pts, dirs, g_sigma, g_rgb, cfg), 2)
        # pts, dirs, g_sigma, g_rgb in; dpts, ddirs out; params in, grads out
        kernels["fused_nerf_bwd/fine"] = bound_entry(ms, plain, 3 * fn.flops_per_point(cfg) * m, 64 * m + 2 * param_bytes,
                                                     peak_flops, peak_bw, m)
    fused = paths["fused"]
    k3 = kernels["fused_train_pass/coarse"]["ms"] + kernels["fused_train_pass/fine"]["ms"]
    step_bound = kernels["fused_train_pass/coarse"]["bound_ms"] + kernels["fused_train_pass/fine"]["bound_ms"]
    ok = (all(p["finite"] for p in paths.values())
          and paths["fused"]["launches"] == {"fused_train_pass": 2 * timed, "fused_nerf_fwd": 0, "fused_nerf_bwd": 0}
          and paths["generic"]["launches"] == {"fused_train_pass": 0, "fused_nerf_fwd": 2 * timed,
                                               "fused_nerf_bwd": 2 * timed}
          # one sweep (state.step 16) among the timed steps 3..22
          and paths["fused_occupancy"]["launches"] == {"fused_train_pass": 2 * timed, "fused_nerf_fwd": 1,
                                                       "fused_nerf_bwd": 0}
          and paths["fused_occupancy"]["kernel3_shapes"] == {"4096x32": timed, "4096x128": timed})
    emit("train_bench", card=smi, sm_clock_temp_power=clocks, timed_steps=timed, paths=paths,
         kernels=kernels, kernel3_ms_per_step=k3, kernel3_share_of_step=k3 / fused["ms_per_step"],
         step_bound_ms=step_bound, peak_flops=peak_flops, peak_bytes_per_s=peak_bw, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_bench phase failed")
    return dict(kernels=kernels, generic_bwd_launches=paths["generic"]["launches"]["fused_nerf_bwd"])


def phase_train_bench_general(smi: str) -> dict:
    """Paths A and B at bench.py's train point (8 views at 400x400, 4096
    rays, 64 + 128 samples): 2 warm-up and 10 timed steps, fused and
    force_generic, the launches of each path counted by route over its
    timed steps; then kernel 1 held against its plain version
    (:func:`compare_with_plain`) at the path's render chunks, 4096 rays x 64
    coarse and x 192 fine depths of a step's batch, with the path's trained
    weights and seeded port-init weights and their He-scaled copy; then
    kernel 3 alone per coarse and fine pass, kernel 2 at the fine shape and
    kernel 1 on the fine chunk (786,432 points), by CUDA events, beside
    their bounds (:func:`route_peak`; kernel 3 also beside its stash floor)
    and the plain versions' times; then :func:`f32_route_checks` and
    :func:`tc_wide_timings`."""
    from torch_nerf_tpu_torch import renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners.train_ab import step_batch  # noqa: PLC0415

    dev = torch.device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images = torch.as_tensor(images, device=dev)
    poses = torch.as_tensor(poses, device=dev)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    bf16_peak, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    timed = 10
    out, ok = {}, True
    for route, g in GENERAL.items():
        field = make_nerf_field(coord_encode_level=g["coord_encode_level"], feat_dim=g["feat_dim"],
                                compute_dtype=g["dtype"])
        cfg = field.fused_cfg
        peak = route_peak(route, bf16_peak)
        paths, states = {}, {}
        for path, generic in (("fused", False), ("generic", True)):
            state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
            step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic)
            gen = torch.Generator(device=dev).manual_seed(1)
            for _ in range(2):
                state, _, _ = bench_step(step, state, None, images, poses, gen)
            torch.cuda.synchronize()
            fn.reset_launches()
            ftm.reset_launches()
            losses = []
            t0 = time.perf_counter()
            for _ in range(timed):
                state, _, metrics = bench_step(step, state, None, images, poses, gen)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            losses = [float(v) for v in losses]
            paths[path] = dict(ms_per_step=elapsed / timed * 1e3, rays_per_sec=4096 * timed / elapsed,
                               route_launches={"fused_train_pass": dict(ftm.fused_train_pass.route_launches),
                                               "fused_nerf_fwd": dict(fn.fused_nerf_apply.route_launches),
                                               "fused_nerf_bwd": dict(fn.fused_nerf_bwd.route_launches)},
                               loss_first=losses[0], loss_last=losses[-1],
                               finite=all(math.isfinite(v) for v in losses))
            states[path] = (state, step, gen)
        clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")

        state, step, gen = states["fused"]
        pc, pf = state.params["coarse"], state.params["fine"]
        o, d, gt, uni = step_batch(step, images, poses, camera, gen)
        t_c = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far)
        with torch.no_grad():
            _, w_c, _ = ftm.fused_train_pass(pc, o, d, t_c, sampling.t_deltas(t_c), gt, cfg, 4096)
            t_f = fine_depths(w_c, uni, settings)
        base = level_params(g["feat_dim"], g["coord_encode_level"], 0, dev)
        chunk_checks = {}
        for shape, t in (("coarse", t_c), ("fine", t_f)):
            pts, dirs = ray_points(o, d, t)
            for wname, params in (("trained", pc if shape == "coarse" else pf), ("port_init", base),
                                  ("he", he_scaled(base))):
                chunk_checks[f"{shape}/{wname}"] = compare_with_plain(
                    fn.prepare(params, cfg), pts, dirs, g["feat_dim"], g["dtype"], g["coord_encode_level"])
        param_bytes = 4 * sum(t.numel() for v in pc.values() for t in v.values())
        kernels = {}
        with torch.no_grad():
            for name, params, t in (("coarse", pc, t_c), ("fine", pf, t_f)):
                delta = sampling.t_deltas(t)
                m = t.numel()
                ms = cuda_ms(lambda: ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, 4096), 5)
                plain = cuda_ms(lambda: train_reference(params, o, d, t, delta, gt, cfg, 4096), 1)
                kernels[f"fused_train_pass/{name}"] = bound_entry(
                    ms, plain, 3 * fn.flops_per_point(cfg) * m, 12 * m + 48 * 4096 + 2 * param_bytes, peak, peak_bw, m)
                kernels[f"fused_train_pass/{name}"]["stash_floor_ms"] = stash_floor_ms(cfg, m, peak_bw)
            pts, dirs = ray_points(o, d, t_f)
            m = pts.shape[0]
            gk = torch.Generator(device=dev).manual_seed(4)
            g_sigma = torch.randn((m,), generator=gk, device=dev)
            g_rgb = torch.randn((m, 3), generator=gk, device=dev)
            ms = cuda_ms(lambda: fn.fused_nerf_bwd(pf, pts, dirs, g_sigma, g_rgb, cfg), 3)
            plain = cuda_ms(lambda: bwd_reference(pf, pts, dirs, g_sigma, g_rgb, cfg), 1)
            kernels["fused_nerf_bwd/fine"] = bound_entry(ms, plain, 3 * fn.flops_per_point(cfg) * m,
                                                         64 * m + 2 * param_bytes, peak, peak_bw, m)
            prepared = fn.prepare(pf, cfg)
            ms = cuda_ms(lambda: fn.fused_nerf_apply(prepared, pts, dirs, cfg), 5)
            plain = cuda_ms(lambda: fn.fused_nerf_apply_reference(pf, pts, dirs, cfg), 2)
            kernels["fused_nerf_fwd/fine"] = bound_entry(ms, plain, fn.flops_per_point(cfg) * m,
                                                         40 * m + param_bytes, peak, peak_bw, m)
        kernels["dw_gemm/fine"] = dw_bench(cfg, pf, pts, dirs, g_sigma, g_rgb, peak, peak_bw)
        zero = dict.fromkeys(fn.ROUTES, 0)
        want = {"fused": {"fused_train_pass": dict(zero, **{route: 2 * timed}), "fused_nerf_fwd": zero,
                          "fused_nerf_bwd": zero},
                "generic": {"fused_train_pass": zero, "fused_nerf_fwd": dict(zero, **{route: 2 * timed}),
                            "fused_nerf_bwd": dict(zero, **{route: 2 * timed})}}
        route_ok = all(p["finite"] for p in paths.values()) and all(
            paths[p]["route_launches"] == want[p] for p in paths)
        ok = ok and route_ok
        out[route] = dict(config=GENERAL_OVERRIDES[route], sm_clock_temp_power=clocks, timed_steps=timed,
                          paths=paths, expected_route_launches=want, kernels=kernels, peak_flops=peak, ok=route_ok,
                          fwd_chunk_checks=chunk_checks,
                          fwd_max_abs_err=max(e for r in chunk_checks.values() for e in r["max_abs_err"].values()),
                          generic_bwd_launches=paths["generic"]["route_launches"]["fused_nerf_bwd"][route])
    kept, kept_ok = f32_route_checks(o, d, gt, t_c, t_f, bf16_peak, peak_bw)
    wide = tc_wide_timings(o, d, gt, t_f, bf16_peak, peak_bw)
    ok = ok and kept_ok and all(w["ok"] for w in wide.values())
    out.update(kept)
    out.update(wide)
    emit("train_bench_general", card=smi, routes=out, peak_bytes_per_s=peak_bw, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_bench_general phase failed")
    return out


def tc_wide_timings(o, d, gt, t_f, bf16_peak, peak_bw) -> dict:
    """Kernels 1-3 of each config of :data:`TC_TIMED` on wgmma_general at
    the fine shape (4096 x 192 = 786,432 points of a step's batch): kernel
    1 first held against its plain version on that chunk
    (:func:`compare_with_plain`, port-init weights and their He-scaled
    copy), then each kernel, port-init weights, by CUDA events beside its
    bound (the bf16 tensor cores' peak; kernel 3 also beside its stash
    floor) and the plain version's time, every timed launch counted on the
    route; then its dW GEMM alone (:func:`dw_bench`). Kernels 2-3's checks
    against the plain versions are the kernel_bwd_general and
    kernel_train_general phases'. -> ``{"wgmma_general/<name>":
    results}``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    fpts, fdirs = ray_points(o, d, t_f)
    mf = fpts.shape[0]
    fs = torch.randn((mf,), generator=gen, device=dev)
    fr = torch.randn((mf, 3), generator=gen, device=dev)
    delta = sampling.t_deltas(t_f)
    out = {}
    for name in TC_TIMED:
        feat, level, dl = TC_WIDE[name]
        cfg = width_cfg(feat, torch.bfloat16, level, dl)
        params = level_params(feat, level, 0, dev, dl)
        param_bytes = 4 * sum(t.numel() for v in params.values() for t in v.values())
        flops = fn.flops_per_point(cfg) * mf
        chunk_checks = {wname: compare_with_plain(fn.prepare(p, cfg), fpts, fdirs, feat, torch.bfloat16, level, dl)
                        for wname, p in (("port_init", params), ("he", he_scaled(params)))}
        fn.reset_launches()
        ftm.reset_launches()
        kernels = {}
        with torch.no_grad():
            ms = cuda_ms(lambda: ftm.fused_train_pass(params, o, d, t_f, delta, gt, cfg, 4096), 2)
            plain = cuda_ms(lambda: train_reference(params, o, d, t_f, delta, gt, cfg, 4096), 1)
            kernels["fused_train_pass/fine"] = bound_entry(ms, plain, 3 * flops, 12 * mf + 48 * 4096 + 2 * param_bytes,
                                                           bf16_peak, peak_bw, mf)
            kernels["fused_train_pass/fine"]["stash_floor_ms"] = stash_floor_ms(cfg, mf, peak_bw)
            ms = cuda_ms(lambda: fn.fused_nerf_bwd(params, fpts, fdirs, fs, fr, cfg), 2)
            plain = cuda_ms(lambda: bwd_reference(params, fpts, fdirs, fs, fr, cfg), 1)
            kernels["fused_nerf_bwd/fine"] = bound_entry(ms, plain, 3 * flops, 64 * mf + 2 * param_bytes, bf16_peak,
                                                         peak_bw, mf)
            prepared = fn.prepare(params, cfg)
            ms = cuda_ms(lambda: fn.fused_nerf_apply(prepared, fpts, fdirs, cfg), 3)
            plain = cuda_ms(lambda: fn.fused_nerf_apply_reference(params, fpts, fdirs, cfg), 1)
            kernels["fused_nerf_fwd/fine"] = bound_entry(ms, plain, flops, 40 * mf + param_bytes, bf16_peak, peak_bw,
                                                         mf)
        launched = {"fused_nerf_fwd": dict(fn.fused_nerf_apply.route_launches),
                    "fused_nerf_bwd": dict(fn.fused_nerf_bwd.route_launches),
                    "fused_train_pass": dict(ftm.fused_train_pass.route_launches),
                    "dw_gemm": dict(fn.dw_gemm.route_launches)}
        on_route = all(c["wgmma_general"] > 0 and sum(c.values()) == c["wgmma_general"] for c in launched.values())
        kernels["dw_gemm/fine"] = dw_bench(cfg, params, fpts, fdirs, fs, fr, bf16_peak, peak_bw)
        out[f"wgmma_general/{name}"] = dict(config={"feat_dim": feat, "coord_encode_level": level,
                                                    "dir_encode_level": dl, "dtype": "torch.bfloat16"},
                                            plan=dataclasses.asdict(fn.tc_plan(cfg)), kernels=kernels,
                                            route_launches=launched, peak_flops=bf16_peak, ok=on_route,
                                            fwd_chunk_checks=chunk_checks,
                                            fwd_max_abs_err=max(e for r in chunk_checks.values()
                                                                for e in r["max_abs_err"].values()))
        torch.cuda.empty_cache()
    return out


def dw_bench(cfg, params, pts, dirs, g_sigma, g_rgb, peak: float, peak_bw: float) -> dict:
    """The dW GEMM alone over kernel 2's stash of ``pts`` (CUDA events,
    ``general_check.dw_times``): its ms beside its bound (the larger of its
    operations at ``peak`` and each stash read once at ``peak_bw``), the
    plain version's ms (``backward_from_activations``' products on the
    stash) and the library's (one cuBLAS GEMM a stash segment, timed here
    and nowhere on the path)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners.general_check import dw_times  # noqa: PLC0415

    m = pts.shape[0]
    workspace = fn.general_stash(params, pts, dirs, g_sigma, g_rgb, cfg)
    t = dw_times(cfg, workspace, m, iters=3)
    del workspace
    floors = ftm.dw_floors(cfg, m)
    entry = bound_entry(t["ms"], t["plain_ms"], floors["flops"], floors["bytes"], peak, peak_bw, m)
    entry.update(library_ms=t["library_ms"], library=t["library"],
                 floor_ops_ms=floors["flops"] / peak * 1e3, floor_bytes_ms=floors["bytes"] / peak_bw * 1e3)
    return entry


def route_peak(route: str, bf16_peak: float) -> float:
    """The peak of ``route``'s products: the bf16 tensor cores' (wgmma,
    wgmma_general), an eighth of it for f32_wgmma (eight bf16 products a
    multiply-add)."""
    return bf16_peak / 8 if route == "f32_wgmma" else bf16_peak


def stash_floor_ms(cfg, points: int, peak_bw: float) -> float:
    """The general route's stash traffic for a train pass over ``points``,
    each byte once (``fused_train.general_stash_bytes``), at ``peak_bw``."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    return ftm.general_stash_bytes(cfg, points) / peak_bw * 1e3


def f32_train_case(params, args, cfg) -> tuple:
    """Kernel 3 on ``args`` against the plain version one precision up
    (:func:`train_verdict`): ``(verdict, check)``, the verdict of two
    launches (bit-identical outputs required), ``check`` one more launch's
    verdict against the same references (for a planted fault)."""
    rparams, rargs, rcfg = reference_of(params, list(args), cfg)
    cr, wr, gr = train_reference(rparams, *rargs, rcfg, 4096)
    cp, wp, gp = train_reference(params, *args, cfg, 4096)
    ref = named(gr)
    scale = rel_l2(named(gp), ref)
    tail = args[3] >= 1e7

    def check(runs=None):
        return train_verdict(params, args, cfg, ref, scale, cr, wr, gr, cp, wp, tail, runs)

    runs = []
    v = check(runs)
    check(runs)
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    v.update(relaunch_bit_identical=same, ok=v["ok"] and same)
    return v, check


def f32_bwd_case(params, pts, dirs, g_sigma, g_rgb, cfg) -> tuple:
    """Kernel 2 on these points against the plain version one precision up
    (:func:`bwd_verdict`): ``(verdict, check)`` as :func:`f32_train_case`."""
    rparams, rt, rcfg = reference_of(params, [pts, dirs, g_sigma, g_rgb], cfg)
    ref = bwd_reference(rparams, *rt, rcfg)
    scale = rel_l2(bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg), ref)

    def check(runs=None):
        return bwd_verdict(params, pts, dirs, g_sigma, g_rgb, ref, scale, runs, cfg)

    runs = []
    v = check(runs)
    check(runs)
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    v.update(points=pts.shape[0], relaunch_bit_identical=same, ok=v["ok"] and same)
    return v, check


def f32_route_checks(o, d, gt, t_c, t_f, bf16_peak, peak_bw):
    """Kernels 1-3 on f32_wgmma at each config of :data:`F32_WIDE`, with
    port-init weights and their He-scaled copy, each against the plain
    version one precision up (f64) within 2x the plain f32 version's error
    (TF32 off) + 1e-5: kernel 1 on 2^16 + 37 random points, kernel 2 on the
    fine batch's 786,432 points with seeded random cotangents (a few
    thousand random points can miss by one relu mask flipped by a last
    bit), kernel 3 at the coarse shape (4096 x 64); at :data:`F32_FINE`
    kernels 1 and 3 on the fine shape (4096 x 192) too; kernels 2-3 launched
    twice for bit-identical outputs. At :data:`F32_FAULTED` (a tile and the
    streaming design) the low bf16 piece of every weight dropped
    (:func:`low_piece_dropped`) in kernel 1's images and in kernels 2-3's,
    and the column passes' faults in kernel 1's (:func:`tc_wide_forward_faults`),
    each of which must fail its check with the He-scaled weights. Every
    launch counted on f32_wgmma, none elsewhere. Then, at
    :data:`F32_TIMED`, each kernel timed at the fine shape beside its bound
    (989/8 TFLOP/s) and the plain version's time, and the dW GEMM alone.
    -> ``({"f32_wgmma/<name>": results}, ok)``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    m = 2**16 + 37
    pts = torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0
    dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
    fpts, fdirs = ray_points(o, d, t_f)
    mf = fpts.shape[0]
    fs = torch.randn((mf,), generator=gen, device=dev)
    fr = torch.randn((mf, 3), generator=gen, device=dev)
    route, peak = "f32_wgmma", route_peak("f32_wgmma", bf16_peak)
    out, ok = {}, True
    for name, (feat, level, dl) in F32_WIDE.items():
        cfg = width_cfg(feat, torch.float32, level, dl)
        base = level_params(feat, level, 0, dev, dl)
        fn.reset_launches()
        ftm.reset_launches()
        checks, faults = {}, {}
        shapes = (("coarse", t_c), ("fine", t_f)) if name in F32_FINE else (("coarse", t_c),)
        for wname, params in (("port_init", base), ("he", he_scaled(base))):
            w = fn.prepare(params, cfg)
            checks[f"fwd/random/{wname}"] = kernel_errors(w, pts, dirs, feat, torch.float32, level, dl)
            if name in F32_FINE:
                checks[f"fwd/fine/{wname}"] = kernel_errors(w, fpts, fdirs, feat, torch.float32, level, dl)
            checks[f"bwd/fine/{wname}"], bwd_check = f32_bwd_case(params, fpts, fdirs, fs, fr, cfg)
            train_checks = {}
            for shape, t in shapes:
                args = (o, d, t, sampling.t_deltas(t), gt)
                checks[f"train/{shape}/{wname}"], train_checks[shape] = f32_train_case(params, args, cfg)
            if wname == "he" and name in F32_FAULTED:
                rows = fn.tc_pass_rows(cfg, stash=False)[0]
                bad = {"fwd/low_piece_dropped": dataclasses.replace(w, weights=tuple(low_piece_dropped(w.weights, rows)))}
                bad.update({f"fwd/{k}": v for k, v in tc_wide_forward_faults(w, params, cfg).items()})
                for fname, weights in bad.items():
                    r = kernel_errors(weights, pts, dirs, feat, torch.float32, level, dl)
                    faults[fname] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
                for fname, check in (("bwd/low_piece_dropped", bwd_check),
                                     ("train/low_piece_dropped", train_checks["coarse"])):
                    with planted_low_piece():
                        v = check()
                    faults[fname] = {"rejected": not v["ok"], "worst": v["worst"], "worst_err": v["worst_err"],
                                     "worst_limit": v["worst_limit"]}
            torch.cuda.empty_cache()
        launched = {"fused_nerf_fwd": dict(fn.fused_nerf_apply.route_launches),
                    "fused_nerf_bwd": dict(fn.fused_nerf_bwd.route_launches),
                    "fused_train_pass": dict(ftm.fused_train_pass.route_launches),
                    "dw_gemm": dict(fn.dw_gemm.route_launches)}
        on_route = all(c[route] > 0 and sum(c.values()) == c[route] for c in launched.values())
        row_ok = on_route and all(c["ok"] for c in checks.values()) and all(f["rejected"] for f in faults.values())
        row = dict(config={"feat_dim": feat, "coord_encode_level": level, "dir_encode_level": dl,
                           "dtype": "torch.float32"},
                   plan=dataclasses.asdict(fn.tc_plan(cfg)), checks=checks, planted_faults=faults,
                   route_launches=launched, peak_flops=peak,
                   max_abs_err={"fused_nerf_fwd": max(max(c["max_abs_err"].values())
                                                      for k, c in checks.items() if k.startswith("fwd/")),
                                "fused_nerf_bwd": max(c["max_abs_err"] for k, c in checks.items()
                                                      if k.startswith("bwd/")),
                                "fused_train_pass": max(c["max_abs_err"] for k, c in checks.items()
                                                        if k.startswith("train/"))})
        if name in F32_TIMED:
            params = base
            param_bytes = 4 * sum(t.numel() for v in params.values() for t in v.values())
            flops = fn.flops_per_point(cfg) * mf
            kernels = {}
            with torch.no_grad():
                delta = sampling.t_deltas(t_f)
                ms = cuda_ms(lambda: ftm.fused_train_pass(params, o, d, t_f, delta, gt, cfg, 4096), 2)
                plain = cuda_ms(lambda: train_reference(params, o, d, t_f, delta, gt, cfg, 4096), 1)
                kernels["fused_train_pass/fine"] = bound_entry(ms, plain, 3 * flops,
                                                               12 * mf + 48 * 4096 + 2 * param_bytes, peak, peak_bw,
                                                               mf)
                kernels["fused_train_pass/fine"]["stash_floor_ms"] = stash_floor_ms(cfg, mf, peak_bw)
                ms = cuda_ms(lambda: fn.fused_nerf_bwd(params, fpts, fdirs, fs, fr, cfg), 2)
                plain = cuda_ms(lambda: bwd_reference(params, fpts, fdirs, fs, fr, cfg), 1)
                kernels["fused_nerf_bwd/fine"] = bound_entry(ms, plain, 3 * flops, 64 * mf + 2 * param_bytes, peak,
                                                             peak_bw, mf)
                prepared = fn.prepare(params, cfg)
                ms = cuda_ms(lambda: fn.fused_nerf_apply(prepared, fpts, fdirs, cfg), 2)
                plain = cuda_ms(lambda: fn.fused_nerf_apply_reference(params, fpts, fdirs, cfg), 1)
                kernels["fused_nerf_fwd/fine"] = bound_entry(ms, plain, flops, 40 * mf + param_bytes, peak, peak_bw,
                                                             mf)
            kernels["dw_gemm/fine"] = dw_bench(cfg, params, fpts, fdirs, fs, fr, peak, peak_bw)
            row["kernels"] = kernels
            row["timed_launches"] = {"fused_nerf_fwd": dict(fn.fused_nerf_apply.route_launches),
                                     "fused_nerf_bwd": dict(fn.fused_nerf_bwd.route_launches),
                                     "fused_train_pass": dict(ftm.fused_train_pass.route_launches),
                                     "dw_gemm": dict(fn.dw_gemm.route_launches)}
            row_ok = row_ok and all(c[route] > 0 and sum(c.values()) == c[route]
                                    for c in row["timed_launches"].values())
        row["ok"] = row_ok
        ok = ok and row_ok
        out[f"{route}/{name}"] = row
        torch.cuda.empty_cache()
    return out, ok


# ---------------------------------------------------------------------------
# Instant-NGP: kernels 4-7


def hash_ops(layout):
    """(forward wrapper, backward wrapper, plain forward, plain backward) of
    a table layout."""
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    if layout == "bricked":
        return hg.hash_brick_fwd, hg.hash_brick_bwd, hg.brick_encode_reference, hg.brick_backward_reference
    return hg.hash_corner_fwd, hg.hash_corner_bwd, hg.corner_encode_reference, hg.corner_backward_reference


def fold_ops():
    """(forward wrapper, backward wrapper) of the packed layouts."""
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    return hg.hash_fold_fwd, hg.hash_fold_bwd


def table_args(tables):
    """The backward's table arguments: T_b for bricks, (T, F) for corners."""
    return (tables.shape[1],) if tables.shape[2] == 128 else (tables.shape[1], tables.shape[2])


def ngp_resolutions(dev):
    from torch_nerf_tpu_torch.models.hash_math import level_resolutions  # noqa: PLC0415

    return torch.as_tensor(level_resolutions(NGP["num_level"], NGP["min_res"], NGP["max_res"]), device=dev)


def ngp_table_shape(layout):
    from torch_nerf_tpu_torch.ops.hash_grid import bricks_per_level  # noqa: PLC0415

    levels, log_t, f = NGP["num_level"], NGP["log_max_entry_per_level"], NGP["table_feat_dim"]
    if layout == "bricked":
        return (levels, bricks_per_level(log_t, f), 128)
    return (levels, 2**log_t, f)


def ngp_rays(gen, dev):
    """An NGP train batch's rays, 4096 random pixels of a 400x400 training
    view, and their 256 stratified depths in [2, 6]: ``(o, d, t)``."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    camera = cameras.CameraParams(480.0, 480.0, 400, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    pix = torch.randperm(400 * 400, generator=gen, device=dev)[:4096]
    o, d = cameras.rays_for_pixels(pix, camera, pose)
    uni = renderer.draw_uniforms(gen, 4096, renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0))
    return o, d, sampling.stratified_t_samples_from_uniforms(uni.coarse, 2.0, 6.0)


def ngp_points(dev, seed=6):
    """The 4096 x 256 = 2^20 sample points of an NGP train batch
    (:func:`ngp_rays`) and 37 more: 12 with negative coordinates, 12 with
    integral scaled coordinates on one or more axes, 13 far out (|x| up to
    900)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pts, _ = ray_points(*ngp_rays(gen, dev))
    negative = -1.5 * torch.rand((12, 3), generator=gen, device=dev)
    integral = torch.randint(-3, 4, (12, 3), generator=gen, device=dev).float()
    integral[6:, 0] += 0.3  # integral on the other two axes only
    far = torch.rand((13, 3), generator=gen, device=dev) * 1800.0 - 900.0
    return torch.cat([pts, negative, integral, far]).contiguous()


def occupancy_points(dev, seed=10) -> dict:
    """The points that the occupancy paths give kernels 4-7 (train_occ):
    a pruned NGP step's 4096 x 128, ``occupancy.prune_t_samples`` keeping
    128 of :func:`ngp_rays`' 256 depths on a 64^3 grid over [-4, 4]^3 with
    half its cells occupied at random (no warmup: rays over and under
    budget, padding after the kept samples), and one sweep's 64^3 jittered
    cell points (``occupancy.sweep_points``)."""
    from torch_nerf_tpu_torch import occupancy  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = occupancy.OccupancyConfig(resolution=64, bound=4.0, threshold=0.5, warmup_steps=0)
    grid = torch.rand((cfg.resolution**3,), generator=gen, device=dev)
    o, d, t = ngp_rays(gen, dev)
    t_sel, _ = occupancy.prune_t_samples(grid, cfg, o, d, t, 0, keep=128)
    pruned, _ = ray_points(o, d, t_sel)
    return {"pruned_step": pruned, "sweep": occupancy.sweep_points(occupancy.draw_jitter(gen, cfg), cfg).contiguous()}


def pair_verdict(fwd, bwd, run_fwd, run_bwd, ref_out, ref_grad) -> dict:
    """A forward and a backward kernel (``run_fwd()``, ``run_bwd()``) against
    the plain versions' results on the true inputs: the forward within
    max-abs 1e-5 and relative L2 1e-5 (f32 sums of 8 weighted unit-scale
    features in another order), the table gradient within relative L2 1e-5
    (atomics on both sides, in orders that change from run to run); one
    launch each."""
    before = (fwd.launches, bwd.launches)
    out = run_fwd()
    grad = run_bwd()
    torch.cuda.synchronize()
    err = {"fwd_max_abs": (out - ref_out).abs().max().item(),
           "fwd_rel_l2": rel_l2({"x": out}, {"x": ref_out})["x"],
           "grad_rel_l2": rel_l2({"x": grad}, {"x": ref_grad})["x"],
           "grad_max_abs": (grad - ref_grad).abs().max().item()}
    limit = {"fwd_max_abs": 1e-5, "fwd_rel_l2": 1e-5, "grad_rel_l2": 1e-5}
    ok = (all(math.isfinite(v) for v in err.values()) and all(err[k] <= limit[k] for k in limit)
          and (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1))
    return dict(ok=ok, err=err, limit=limit, out=out)


def hash_verdict(layout, tables, pts, res, g, ref_out, ref_grad) -> dict:
    """:func:`pair_verdict` of kernels 4-5 or 6-7 on these inputs."""
    fwd, bwd, _, _ = hash_ops(layout)
    return pair_verdict(fwd, bwd, lambda: fwd(tables, pts, res), lambda: bwd(g, pts, res, *table_args(tables)),
                        ref_out, ref_grad)


def phase_kernel_hash():
    """Kernels 4-7 against their plain versions at full width (L = 16,
    F = 2, 2^19 entries a level; the brick table (16, 8192, 128)) on
    :func:`ngp_points`, with U(-1, 1) tables (the init's U(+-1e-4) would put
    every feature under the tolerance) and a seeded random cotangent; the
    all-zero-weight quirk on the integral points. Then three faults planted
    in the kernels' inputs, each of which the check must reject: the table
    rolled by one row, two levels' resolutions swapped, one point's x and y
    swapped. Then kernels 4-7 on :func:`occupancy_points`, then
    :func:`hash_contention` and :func:`hash_widths`."""
    dev = torch.device("cuda")
    pts = ngp_points(dev)
    n = pts.shape[0]
    res = ngp_resolutions(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    integral = slice(n - 25, n - 19)  # integral on every axis
    results, max_abs = {}, {}
    for layout in NGP_LAYOUTS:
        _, _, fwd_ref, bwd_ref = hash_ops(layout)
        tables = torch.rand(ngp_table_shape(layout), generator=gen, device=dev) * 2.0 - 1.0
        g = torch.randn((n, 32), generator=gen, device=dev)
        ref_out = fwd_ref(tables, pts, res)
        ref_grad = bwd_ref(g, pts, res, *table_args(tables))
        verdict = hash_verdict(layout, tables, pts, res, g, ref_out, ref_grad)
        swapped_levels = res.clone()
        swapped_levels[[3, 11]] = res[[11, 3]]
        swapped_axes = pts.clone()
        swapped_axes[0] = pts[0, [1, 0, 2]]
        faults = {
            "table_rolled_one_row": (torch.roll(tables, 1, dims=1).contiguous(), pts, res),
            "levels_3_11_swapped": (tables, pts, swapped_levels),
            "point_0_x_y_swapped": (tables, swapped_axes, res),
        }
        rejected = {}
        for name, (t_, p_, r_) in faults.items():
            v = hash_verdict(layout, t_, p_, r_, g, ref_out, ref_grad)
            rejected[name] = {"rejected": not v["ok"], "err": v["err"]}
        quirk = ref_out[integral].abs().max().item()
        results[layout] = dict(points=n, table_shape=list(tables.shape), kernels_ok=verdict["ok"],
                               err=verdict["err"], limit=verdict["limit"], planted_faults=rejected,
                               integral_points_max_abs=quirk,
                               ok=verdict["ok"] and quirk == 0.0 and all(f["rejected"] for f in rejected.values()))
        max_abs[layout] = {"fwd": verdict["err"]["fwd_max_abs"], "bwd": verdict["err"]["grad_max_abs"]}
    occ = {}
    for case, p in occupancy_points(dev).items():
        for layout in NGP_LAYOUTS:
            _, _, fwd_ref, bwd_ref = hash_ops(layout)
            tables = torch.rand(ngp_table_shape(layout), generator=gen, device=dev) * 2.0 - 1.0
            g = torch.randn((p.shape[0], 32), generator=gen, device=dev)
            ref_out, ref_grad = fwd_ref(tables, p, res), bwd_ref(g, p, res, *table_args(tables))
            v = hash_verdict(layout, tables, p, res, g, ref_out, ref_grad)
            occ[f"{case}/{layout}"] = dict(points=p.shape[0], err=v["err"], limit=v["limit"], ok=v["ok"])
    contention = hash_contention(dev, gen)
    widths = hash_widths(dev, gen)
    ok = (all(r["ok"] for r in results.values()) and all(o["ok"] for o in occ.values())
          and all(c["ok"] for c in contention.values()) and all(w["ok"] for w in widths.values()))
    emit("kernel_hash", layouts=results, occupancy_points=occ, contention=contention, widths=widths,
         rule="kernels within the limits; every planted fault rejected; the occupancy paths' points within the "
              "limits; the contention cases within the limits against the f64 sum, integral points 0; every "
              "corner width and a ragged n within the limits", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_hash failed")
    return max_abs


def hash_widths(dev, gen) -> dict:
    """Kernels 6-7 at every feature width F in {1, 2, 4, 8}, at T = 2^16, at
    T = 1000 (the signed-remainder rows) and at T = 999 (odd: kernel 6
    reads no x-pairs), and kernels 4-5 at T_b = 512, on 1, 33 and 4099
    points (a ragged last window and tile) of :func:`ngp_points` at the
    presets' 16 levels and at 3 (the forwards' last level group partial,
    L*F = 6: no float4 stores), held as :func:`pair_verdict` holds them."""
    from torch_nerf_tpu_torch.ops.hash_grid import CORNER_FEATS  # noqa: PLC0415

    pts = ngp_points(dev)[-4099:].contiguous()  # the last 37 are the negative, integral and far ones
    shapes = [("bricked", (levels, 512, 128)) for levels in (16, 3)] + [
        ("hash", (levels, t, f)) for f in CORNER_FEATS for t in (2**16, 1000, 999) for levels in (16, 3)]
    out = {}
    for layout, shape in shapes:
        fwd, bwd, fwd_ref, bwd_ref = hash_ops(layout)
        res = ngp_resolutions(dev)[:shape[0]]
        tables = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
        for n in (1, 33, 4099):
            p = pts[-n:].contiguous()
            g = torch.randn((n, shape[0] * (2 if layout == "bricked" else shape[2])), generator=gen, device=dev)
            v = pair_verdict(fwd, bwd, lambda: fwd(tables, p, res), lambda: bwd(g, p, res, *table_args(tables)),
                             fwd_ref(tables, p, res), bwd_ref(g, p, res, *table_args(tables)))
            out[f"{layout}/{list(shape)}/n{n}"] = dict(ok=v["ok"], err=v["err"])
    return out


def integral_runs(dev, gen, n=2**20):
    """Kernel 7's trap at full width: ``n`` points in groups of 8 in the
    voxel of a point integral on every axis (every other group on y and z
    only, x + 0.3), within 1e-4 of it; that point heads its group in half
    the groups and sits 4th, behind three points of its voxel, in the rest.
    Its weights are all 0 and its ceil-side corners sit on the floor's
    vertex, so its rows are not its voxel's. -> (points, the integral
    points' indices)."""
    groups = n // 8
    c = torch.randint(-40, 41, (groups, 3), generator=gen, device=dev).float()
    c[1::2, 0] += 0.3
    near = c[:, None, :] + 1e-5 + 9e-5 * torch.rand((groups, 7, 3), generator=gen, device=dev)
    first = torch.arange(groups, device=dev) % 4 < 2
    heads = torch.cat([c[:, None], near], dim=1)
    inside = torch.cat([near[:, :3], c[:, None], near[:, 3:]], dim=1)
    pts = torch.where(first[:, None, None], heads, inside).reshape(-1, 3).contiguous()
    return pts, torch.arange(groups, device=dev) * 8 + torch.where(first, 0, 3)


def hash_contention(dev, gen) -> dict:
    """Kernels 4-7 on :func:`contention_points` and :func:`integral_runs`
    for both layouts, held as :func:`hash_verdict` holds them (the forward
    within max-abs and relative L2 1e-5 of its plain version, the table
    grad's plain version summed in f64: in f32 it rounds by about the
    limit where 2^20 points share a row; ``plain_f32_rel_l2`` says how
    much), each kernel's time beside, and on the integral runs the
    integral points' features exactly 0 and how many of them have the next
    point in their floor voxel on every level."""
    res = ngp_resolutions(dev)
    cases = {k: (v, None) for k, v in contention_points(dev, gen).items()}
    cases["integral_runs"] = integral_runs(dev, gen)
    out = {}
    for case, (pts, integral) in cases.items():
        for layout in NGP_LAYOUTS:
            fwd, bwd, fwd_ref, bwd_ref = hash_ops(layout)
            tables = torch.rand(ngp_table_shape(layout), generator=gen, device=dev) * 2.0 - 1.0
            g = torch.randn((pts.shape[0], res.shape[0] * NGP["table_feat_dim"]), generator=gen, device=dev)
            ref_out = fwd_ref(tables, pts, res)
            ref_grad = bwd_ref(g.double(), pts, res, *table_args(tables))
            plain32 = bwd_ref(g, pts, res, *table_args(tables))
            v = hash_verdict(layout, tables, pts, res, g, ref_out, ref_grad)
            entry = dict(points=pts.shape[0], err=v["err"], limit=v["limit"],
                         plain_f32_rel_l2=rel_l2({"x": plain32}, {"x": ref_grad})["x"],
                         fwd_ms=cuda_ms(lambda: fwd(tables, pts, res), 5),
                         bwd_ms=cuda_ms(lambda: bwd(g, pts, res, *table_args(tables)), 5))
            ok = v["ok"]
            if integral is not None:
                floor = torch.floor(res[:, None, None] * pts[None])
                entry["integral_points"] = integral.shape[0]
                entry["integral_max_abs"] = v["out"][integral].abs().max().item()
                entry["integral_with_next_in_voxel"] = int(
                    (floor[:, integral] == floor[:, integral + 1]).all(dim=-1).all(dim=0).sum())
                ok = ok and entry["integral_max_abs"] == 0.0 and entry["integral_with_next_in_voxel"] > 0
            out[f"{case}/{layout}"] = dict(entry, ok=ok)
    return out


NGP_TRAIN_OVERRIDES = ["data.dataset_type=gaussian_blobs", "data.img_size=400",
                       "train_params.validation.validate_every=3", "train_params.validation.num_batch=1",
                       "train_params.log.epoch_btw_ckpt=3", "train_params.log.epoch_btw_vis=3"]


def run_cli(fn, argv, counted):
    """``fn(argv)`` with its stdout captured and the launch counts of the
    ``counted`` wrappers, total and by shape, set to 0 just before and read
    just after: ``(result, stdout, launches, shapes)``."""
    launch_count.reset(*counted)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    torch.cuda.synchronize()
    return result, buf.getvalue(), [w.launches for w in counted], [dict(w.shapes) for w in counted]


def train_resume_render(work: Path, name: str, train_args, counted, size: int = 800) -> dict:
    """``run_train`` with ``train_args`` into ``work/<name>_run`` for 24
    steps (one validation, checkpoint and visualisation at 8 views), a
    resume for 8 more, then ``run_render`` + ``evaluate`` of two test views
    of ``size`` x ``size`` (twice ``data.img_size``); the ``counted``
    wrappers' launches over each CLI call."""
    from torch_nerf_tpu_torch import config, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    run, out, gt = work / f"{name}_run", work / f"{name}_render", work / f"{name}_gt"
    logs, results, launches, launch_shapes = [], [], [], []
    t0 = time.perf_counter()
    routes = []

    def by_route():
        # read right after run_cli, which set every count to 0 before the call
        return [dict(getattr(w, "route_launches", {})) for w in counted]

    for max_steps in (24, 32):
        r, log, c, sh = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", str(max_steps)] + train_args,
                                counted)
        routes.append(by_route())
        results.append(r)
        logs.append(log)
        launches.append(c)
        launch_shapes.append(sh)
    train_s = time.perf_counter() - t0
    _, _, render_launches, render_shapes = run_cli(run_render.main, [
        "--log-dir", str(run), "--render-test-views", "--num-views", "2", "--out-dir", str(out)], counted)
    routes.append(by_route())
    cfg = config.load_config(run / "config.yaml")
    data = session.build_dataset(cfg, "test", device=torch.device("cuda"))
    gt.mkdir(parents=True)
    for i in range(2):
        save_png(gt / f"{i:04d}.png", data.images[i])
    scores = evaluate.main([str(out), str(gt)])
    losses = results[0]["losses"] + results[1]["losses"]
    first8, last8 = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    resumed = "Resumed from step 24." in logs[1]
    shapes = [list(load_png(p).shape) for p in sorted(out.iterdir())]
    val = [ln for log in logs for ln in log.splitlines() if ln.startswith("validation @")]
    ok = (len(losses) == 32 and all(math.isfinite(v) for v in losses) and last8 < first8 and resumed
          and len(val) == 1 and (run / "ckpt" / "ckpt_000024.pt").exists()
          and (run / "ckpt" / "ckpt_000032.pt").exists() and shapes == [[size, size, 3]] * 2
          and all(math.isfinite(v) for v in scores.values()))
    return dict(ok=ok, seconds=train_s, results=results, launches=launches, render_launches=render_launches,
                route_launches=routes,
                shapes=launch_shapes, render_shapes=render_shapes, run=run,
                report=dict(steps=[r["step"] for r in results], losses=losses, mean_loss_first8=first8,
                            mean_loss_last8=last8, validation=val, resumed=resumed, png_shapes=shapes,
                            psnr_vs_gt=scores["psnr"], ssim_vs_gt=scores["ssim"]))


def phase_train_ngp(work: Path):
    """``run_train --config instant_nerf_tpu`` (bricked) on gaussian_blobs at
    400x400 (8 views) through :func:`train_resume_render` (the validation
    renders an 800x800 val view, 157 chunks; the visualisation a 400x400
    view, 40 chunks); then 8 steps of ``--config instant_nerf``
    (per-corner). Hash launches counted over each call: one forward and one
    backward per train step, one forward per render chunk, nothing of the
    other layout's kernels; the fused NGP forward once per render chunk
    (the presets are bf16: ``prepare`` takes it) and never in a train step."""
    from torch_nerf_tpu_torch.ops import ngp_mlp  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    counted = hash_ops("bricked")[:2] + hash_ops("hash")[:2] + (ngp_mlp.ngp_mlp_fwd,)
    done = train_resume_render(work, "ngp", ["--config", "instant_nerf_tpu"] + NGP_TRAIN_OVERRIDES, counted)
    hash_result, _, hash_launches, _ = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "ngp_hash_run"), "--max-steps", "8"]
        + NGP_TRAIN_OVERRIDES, counted)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    # [brick fwd, brick bwd, corner fwd, corner bwd, fused NGP fwd] per call
    want = [[24 + chunks_800 + chunks_400, 24, 0, 0, chunks_800 + chunks_400], [8, 8, 0, 0, 0]]
    want_render, want_hash = [2 * chunks_800, 0, 0, 0, 2 * chunks_800], [0, 0, 8, 8, 0]
    launches, render_launches = done["launches"], done["render_launches"]
    ok = (done["ok"] and launches == want and render_launches == want_render and hash_launches == want_hash
          and len(hash_result["losses"]) == 8 and all(math.isfinite(v) for v in hash_result["losses"]))
    emit("train_ngp", seconds=done["seconds"], hash_steps=hash_result["step"],
         launches_brick_fwd_bwd_corner_fwd_bwd_fused={"train": launches, "render": render_launches,
                                                       "hash_train": hash_launches},
         expected={"train": want, "render": want_render, "hash_train": want_hash},
         hash_losses=hash_result["losses"], **done["report"], ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_ngp phase failed")
    return {"hash_brick_fwd": launches[0][0] + launches[1][0] + render_launches[0],
            "hash_brick_bwd": launches[0][1] + launches[1][1],
            "hash_corner_fwd": hash_launches[2], "hash_corner_bwd": hash_launches[3],
            "ngp_mlp_fwd": launches[0][4] + launches[1][4] + render_launches[4]}


# ---------------------------------------------------------------------------
# Instant-NGP, packed layouts: kernels 8-9


def fold_grid(layout, dev):
    """(resolutions, offsets) of a packed layout's pseudo-levels."""
    from torch_nerf_tpu_torch.models.instant_ngp import dual_resolutions_offsets  # noqa: PLC0415

    res = ngp_resolutions(dev)
    if layout == "packed_dual":
        return dual_resolutions_offsets(res)
    return res, torch.zeros_like(res)


def fold_table_shape(layout):
    """The folded table of the presets' grid: 2^19 / 8 packed rows a level,
    8 a 128-float line; 2L levels for the dual layout."""
    levels = NGP["num_level"] * (2 if layout == "packed_dual" else 1)
    return (levels, 2 ** NGP["log_max_entry_per_level"] // 8 // (128 // (8 * NGP["table_feat_dim"])), 128)


def fold_verdict(tables, pts, res, off, g, ref_out, ref_grad) -> dict:
    """:func:`pair_verdict` of kernels 8-9 on these inputs."""
    fwd, bwd = fold_ops()
    f = NGP["table_feat_dim"]
    return pair_verdict(fwd, bwd, lambda: fwd(tables, pts, res, off, f),
                        lambda: bwd(g, pts, res, off, tables.shape[1], f), ref_out, ref_grad)


def phase_kernel_fold():
    """Kernels 8 and 9 against their plain versions at full width (L = 16,
    F = 2, 2^19 / 8 packed rows a level: the folded table (16, 8192, 128),
    (32, 8192, 128) for ``packed_dual``) on :func:`ngp_points`, with U(-1,
    1) tables and a seeded random cotangent. The all-zero-weight quirk on
    the integral points holds on the base levels' columns only: on the
    dual layout's staggered levels those points sit at half-integers. Then
    four faults planted in the kernels' inputs, each of which the check must
    reject: the table rolled by one packed row, two levels' resolutions
    swapped, one point's x and y swapped, and (dual) the offsets zeroed."""
    from torch_nerf_tpu_torch.models.instant_ngp import unfold_packed_table  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    dev = torch.device("cuda")
    pts = ngp_points(dev)
    n = pts.shape[0]
    f = NGP["table_feat_dim"]
    base = NGP["num_level"] * f  # the base levels' columns
    gen = torch.Generator(device=dev).manual_seed(9)
    integral = slice(n - 25, n - 19)  # integral on every axis
    results, max_abs = {}, {}
    for layout in PACKED_LAYOUTS:
        res, off = fold_grid(layout, dev)
        tables = torch.rand(fold_table_shape(layout), generator=gen, device=dev) * 2.0 - 1.0
        g = torch.randn((n, res.shape[0] * f), generator=gen, device=dev)
        ref_out = hg.fold_encode_reference(tables, pts, res, off, f)
        ref_grad = hg.fold_backward_reference(g, pts, res, off, tables.shape[1], f)
        verdict = fold_verdict(tables, pts, res, off, g, ref_out, ref_grad)
        swapped_levels = res.clone()
        swapped_levels[[3, 11]] = res[[11, 3]]
        swapped_axes = pts.clone()
        swapped_axes[0] = pts[0, [1, 0, 2]]
        rolled = unfold_packed_table(tables, f).roll(1, dims=1).reshape(tables.shape).contiguous()
        faults = {
            "table_rolled_one_packed_row": (rolled, pts, res, off),
            "levels_3_11_swapped": (tables, pts, swapped_levels, off),
            "point_0_x_y_swapped": (tables, swapped_axes, res, off),
        }
        if layout == "packed_dual":
            faults["dual_offsets_zeroed"] = (tables, pts, res, torch.zeros_like(off))
        rejected = {}
        for name, (t_, p_, r_, o_) in faults.items():
            v = fold_verdict(t_, p_, r_, o_, g, ref_out, ref_grad)
            rejected[name] = {"rejected": not v["ok"], "err": v["err"]}
        quirk = max(ref_out[integral, :base].abs().max().item(),
                    verdict["out"][integral, :base].abs().max().item())
        staggered = ref_out[integral, base:].abs().max().item() if layout == "packed_dual" else None
        ok = (verdict["ok"] and quirk == 0.0 and all(v["rejected"] for v in rejected.values())
              and (staggered is None or staggered > 0.0))
        results[layout] = dict(points=n, table_shape=list(tables.shape), kernels_ok=verdict["ok"],
                               err=verdict["err"], limit=verdict["limit"], planted_faults=rejected,
                               integral_points_base_levels_max_abs=quirk,
                               integral_points_staggered_levels_max_abs=staggered, ok=ok)
        max_abs[layout] = {"fwd": verdict["err"]["fwd_max_abs"], "bwd": verdict["err"]["grad_max_abs"]}
    contention = fold_contention(dev, gen)
    widths = fold_widths(dev, gen)
    ok = (all(r["ok"] for r in results.values()) and all(c["ok"] for c in contention.values())
          and all(w["ok"] for w in widths.values()))
    emit("kernel_fold", layouts=results, contention=contention, widths=widths,
         rule="kernels within the limits; every planted fault rejected; integral points 0 on the base "
              "levels only; the contention cases within the limits; every packed width and a ragged n "
              "within the limits", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_fold failed")
    return max_abs


def fold_widths(dev, gen) -> dict:
    """Kernels 8-9 at every feature width F in {1, 2, 4, 8, 16} (kernel 8's
    level group is 8 levels at F <= 2, then 16 / F), for ``packed`` and
    ``packed_dual``, at 2^13 packed rows a level, on 1, 33 and 4099 points
    (a ragged tile) of :func:`ngp_points` at the presets' 16 levels and at
    3 (a partial last group), held as :func:`pair_verdict` holds them."""
    from torch_nerf_tpu_torch.models.instant_ngp import dual_resolutions_offsets  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    fwd, bwd = fold_ops()
    pts = ngp_points(dev)[-4099:].contiguous()
    out = {}
    for f in hg.FOLD_FEATS:
        for levels in (16, 3):
            base = ngp_resolutions(dev)[:levels]
            for layout in PACKED_LAYOUTS:
                res, off = (base, torch.zeros_like(base)) if layout == "packed" else dual_resolutions_offsets(base)
                tables = torch.rand((res.shape[0], 2**13 // hg.fold_factor(f), 128), generator=gen,
                                    device=dev) * 2.0 - 1.0
                lines = tables.shape[1]
                for n in (1, 33, 4099):
                    p = pts[-n:].contiguous()
                    g = torch.randn((n, res.shape[0] * f), generator=gen, device=dev)
                    v = pair_verdict(fwd, bwd, lambda: fwd(tables, p, res, off, f),
                                     lambda: bwd(g, p, res, off, lines, f),
                                     hg.fold_encode_reference(tables, p, res, off, f),
                                     hg.fold_backward_reference(g, p, res, off, lines, f))
                    out[f"{layout}/{list(tables.shape)}/F{f}/n{n}"] = dict(ok=v["ok"], err=v["err"])
    return out


def contention_points(dev, gen):
    """The backwards' worst cases for their warp pre-reduction (kernels 5,
    7 and 9), 2^20 points each: ``one_voxel``, every point within 1e-4 of
    one point, chosen so that on every level of both packed layouts (the
    base levels are the bricked and hash layouts' too) they share one voxel
    (checked); and
    ``long_runs``, 4096 rays of 256 samples packed into t in [2, 2.05], so
    that runs of consecutive samples share a voxel on every level (about
    10 on the finest, whole warps on the coarse ones)."""
    from torch_nerf_tpu_torch import cameras  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415

    def one_voxel_per_level(pts, res, off):
        # the voxel of every point on every level, as packed_prep floors it
        v = torch.floor((res.double()[:, None, None] * pts.double()[None] + off.double()[:, None, None]).float())
        return bool((v.amin(dim=1) == v.amax(dim=1)).all())

    spread = torch.rand((2**20, 3), generator=gen, device=dev) * 1e-4
    for k in range(64):
        center = torch.tensor([0.3 + 0.0137 * k, -0.41 + 0.0071 * k, 0.17 - 0.0093 * k], device=dev)
        one = (center + spread).contiguous()
        if all(one_voxel_per_level(one, *fold_grid(layout, dev)) for layout in PACKED_LAYOUTS):
            break
    else:
        raise SystemExit("chip_smoke: no centre whose 1e-4 neighbourhood lies in one voxel of every level")
    camera = cameras.CameraParams(480.0, 480.0, 400, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    pix = torch.randperm(400 * 400, generator=gen, device=dev)[:4096]
    o, d = cameras.rays_for_pixels(pix, camera, pose)
    t = torch.sort(2.0 + 0.05 * torch.rand((4096, 256), generator=gen, device=dev)).values
    runs, _ = ray_points(o, d, t)
    return {"one_voxel": one, "long_runs": runs}


def fold_contention(dev, gen) -> dict:
    """Kernels 8-9 on :func:`contention_points` for both packed layouts,
    held as :func:`fold_verdict` holds them (the forward within max-abs and
    relative L2 1e-5, the table grad within relative L2 1e-5), with each
    kernel's time on each. The table grad's plain version
    sums in f64 here: with up to 2^20 points on one row, its f32
    ``index_add_`` rounds by about as much as the limit
    (``plain_f32_rel_l2`` says how much), so only the exact sum tells the
    kernel's error."""
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    f = NGP["table_feat_dim"]
    out = {}
    for case, pts in contention_points(dev, gen).items():
        for layout in PACKED_LAYOUTS:
            res, off = fold_grid(layout, dev)
            tables = torch.rand(fold_table_shape(layout), generator=gen, device=dev) * 2.0 - 1.0
            g = torch.randn((pts.shape[0], res.shape[0] * f), generator=gen, device=dev)
            ref_out = hg.fold_encode_reference(tables, pts, res, off, f)
            ref_grad = hg.fold_backward_reference(g.double(), pts, res, off, tables.shape[1], f)
            plain32 = hg.fold_backward_reference(g, pts, res, off, tables.shape[1], f)
            v = fold_verdict(tables, pts, res, off, g, ref_out, ref_grad)
            out[f"{case}/{layout}"] = dict(
                points=pts.shape[0], ok=v["ok"], err=v["err"], limit=v["limit"],
                plain_f32_rel_l2=rel_l2({"x": plain32}, {"x": ref_grad})["x"],
                fwd_ms=cuda_ms(lambda: hg.hash_fold_fwd(tables, pts, res, off, f), 5),
                bwd_ms=cuda_ms(lambda: hg.hash_fold_bwd(g, pts, res, off, tables.shape[1], f), 5))
    return out


SMOOTHNESS = ["objective.encode_smoothness_weight=0.001"]


def phase_train_packed(work: Path):
    """``run_train --config instant_nerf network.table_layout=packed
    objective.encode_smoothness_weight=0.001`` (1024 probes a level) on
    gaussian_blobs at 400x400 (8 views) through :func:`train_resume_render`;
    then 8 steps of ``packed_dual`` with the smoothness loss. Launches [fold
    fwd, fold bwd, brick fwd, brick bwd, corner fwd, corner bwd] counted
    over each call: two forward and two backward fold kernels per train step
    (the ray batch's and the probes'), one forward per render chunk, no
    kernel 4-7, the fused NGP forward once per render chunk; the last
    step's ``aux_loss`` above 0."""
    from torch_nerf_tpu_torch.ops import ngp_mlp  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    counted = fold_ops() + hash_ops("bricked")[:2] + hash_ops("hash")[:2] + (ngp_mlp.ngp_mlp_fwd,)
    done = train_resume_render(work, "packed", ["--config", "instant_nerf", "network.table_layout=packed"]
                               + SMOOTHNESS + NGP_TRAIN_OVERRIDES, counted)
    dual, _, dual_launches, _ = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "packed_dual_run"), "--max-steps", "8",
        "network.table_layout=packed_dual"] + SMOOTHNESS + NGP_TRAIN_OVERRIDES, counted)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    want = [[2 * 24 + chunks_800 + chunks_400, 2 * 24, 0, 0, 0, 0, chunks_800 + chunks_400],
            [2 * 8, 2 * 8, 0, 0, 0, 0, 0]]
    want_render, want_dual = [2 * chunks_800, 0, 0, 0, 0, 0, 2 * chunks_800], [2 * 8, 2 * 8, 0, 0, 0, 0, 0]
    launches, render_launches = done["launches"], done["render_launches"]
    aux = [r["metrics"].get("aux_loss", 0.0) for r in done["results"] + [dual]]
    ok = (done["ok"] and launches == want and render_launches == want_render and dual_launches == want_dual
          and len(dual["losses"]) == 8 and all(math.isfinite(v) for v in dual["losses"])
          and all(a > 0.0 for a in aux))
    emit("train_packed", seconds=done["seconds"], dual_steps=dual["step"],
         launches_fold_fwd_bwd_brick_fwd_bwd_corner_fwd_bwd_fused={"train": launches, "render": render_launches,
                                                                     "dual_train": dual_launches},
         expected={"train": want, "render": want_render, "dual_train": want_dual},
         dual_losses=dual["losses"],
         last_aux_loss={"packed_24": aux[0], "packed_32": aux[1], "packed_dual_8": aux[2]},
         **done["report"], ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_packed phase failed")
    calls = launches + [render_launches, dual_launches]
    return {"hash_fold_fwd": sum(c[0] for c in calls), "hash_fold_bwd": sum(c[1] for c in calls)}


# ---------------------------------------------------------------------------
# LLFF + NDC, and occupancy pruning: kernels 1, 3 and 4-7 on their paths

# fern's images as captured are 4032 x 3024; data.factor=2 of these makes
# 504 x 378, fern's size at the reference's factor 8
LLFF_SIZE = (756, 1008)  # (H, W) of the images written to disk
LLFF_FOCAL = 815.0  # fern's focal scaled to that width


def write_llff_scene(root: Path, views: int = 20, seed: int = 0) -> Path:
    """A forward-facing capture under ``root/fern``: ``views`` cameras on a
    4-wide grid of positions 0.1 apart, each moved and turned a little at
    random (0.05 rad about each axis, 0.05 in depth), looking down -z;
    ``poses_bounds.npy`` rows as LLFF writes them (bounds 2 and 6) and
    1008x756 PNGs of a smooth pattern that moves with the camera, plus
    noise."""
    import numpy as np  # noqa: PLC0415

    from torch_nerf_tpu_torch.logging_utils import save_png  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    h, w = LLFF_SIZE
    img_dir = root / "fern" / "images"
    img_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rows = []
    for i in range(views):
        a, b, c = rng.normal(0.0, 0.05, 3)
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
        pos = np.array([0.1 * (i % 4), 0.1 * (i // 4), rng.normal(0.0, 0.05)])
        c2w = np.concatenate([rx @ ry @ rz, pos[:, None]], axis=1)
        sx, sy = xx / w + 0.5 * pos[0], yy / h - 0.5 * pos[1]
        img = np.stack([0.5 + 0.4 * np.sin(6.0 * sx), 0.5 + 0.4 * np.cos(5.0 * sy),
                        0.5 + 0.3 * np.sin(4.0 * (sx + sy))], axis=-1)
        save_png(img_dir / f"img_{i:03d}.png", img + rng.normal(0.0, 0.015, img.shape))
        raw = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]], axis=1)
        hwf = np.array([[h], [w], [LLFF_FOCAL]])
        rows.append(np.concatenate([np.concatenate([raw, hwf], axis=1).reshape(-1), [2.0, 6.0]]))
    np.save(root / "fern" / "poses_bounds.npy", np.stack(rows))
    return root


def frame_agreement(images: dict) -> dict:
    """Kernel 1's frame against the plain versions' (bf16, f32) on the same
    draws: the non-finite pixels of each, whether the finite masks are
    equal, and on the finite pixels the kernel's PSNR against plain f32
    beside plain bf16's less 12.04 dB (4x the RMS error), as serve holds it."""
    from torch_nerf_tpu_torch import metrics  # noqa: PLC0415

    finite = {k: torch.isfinite(v).all(dim=-1) for k, v in images.items()}
    out = dict(non_finite_pixels={k: int((~m).sum()) for k, m in finite.items()},
               masks_equal=all(torch.equal(finite["kernel"], m) for m in finite.values()))
    mask = finite["plain_f32"]
    ok = out["masks_equal"]
    if mask.any():
        ref = images["plain_f32"][mask]
        out["kernel_vs_plain_f32_psnr"] = metrics.psnr(images["kernel"][mask], ref)
        out["psnr_limit"] = metrics.psnr(images["plain_bf16"][mask], ref) - 12.04
        ok = ok and out["kernel_vs_plain_f32_psnr"] >= out["psnr_limit"]
    out["ok"] = bool(ok)
    return out


def phase_train_llff(work: Path):
    """``run_train`` of the classic defaults on a forward-facing scene
    (:func:`write_llff_scene`, 20 views) with ``data.dataset_type=nerf_llff
    data.factor=2 renderer.project_to_ndc=true``: the loader pools the
    1008x756 images to 504x378 and writes its ``images_2/`` cache; 19
    training views (the view nearest the average pose held out), 24 steps
    with a validation, a checkpoint and a visualisation at the end of the
    first epoch, then a resume for 8 more; ``run_render`` + ``evaluate`` of
    the held-out view. Kernel 3 launches: 2 a step, at 4096 x 64 and 4096 x
    192; kernel 1: 2 a 4096-ray chunk of each render (47 chunks a view).
    The t-bounds must be (0, 1). Then the held-out view's frame through
    kernel 1 and the plain versions on the checkpoint's weights and the same
    draws, before any PNG cast, and the same view from its pose moved onto
    the plane z = 0, where every NDC ray's origin divides by 0 (the JAX
    package's NaN frame): the non-finite pixels counted, the finite masks
    equal, the finite pixels as serve holds them."""
    from torch_nerf_tpu_torch import checkpoints, config, renderer, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data_root = write_llff_scene(work / "llff_data")
    write_s = time.perf_counter() - t0
    run, out, gt = work / "llff_run", work / "llff_render", work / "llff_gt"
    over = ["data.dataset_type=nerf_llff", "data.scene_name=fern", f"data.data_root={data_root}", "data.factor=2",
            "renderer.project_to_ndc=true", "train_params.validation.validate_every=1",
            "train_params.validation.num_batch=1", "train_params.log.epoch_btw_ckpt=1",
            "train_params.log.epoch_btw_vis=1"]
    counted = [ftm.fused_train_pass, fn.fused_nerf_apply]
    results, logs, launches, shapes = [], [], [], []
    t0 = time.perf_counter()
    for max_steps in (24, 32):
        r, log, c, sh = run_cli(run_train.main, ["--config", "default", "--log-dir", str(run), "--max-steps",
                                                 str(max_steps)] + over, counted)
        results.append(r)
        logs.append(log)
        launches.append(c)
        shapes.append(sh)
    train_s = time.perf_counter() - t0
    _, _, render_launches, render_shapes = run_cli(run_render.main, [
        "--log-dir", str(run), "--render-test-views", "--num-views", "1", "--out-dir", str(out)], counted)
    cfg = config.load_config(run / "config.yaml")
    test = session.build_dataset(cfg, "test", device=dev)
    settings = session.build_render_settings(cfg, test)
    gt.mkdir(parents=True)
    save_png(gt / "0000.png", test.images[0])
    scores = evaluate.main([str(out), str(gt)])
    png_shape = list(load_png(out / "0000.png").shape)

    params = checkpoints.restore_latest(run, device=dev)["params"]
    draws = {}

    def uniforms(first, n):
        if first not in draws:
            draws[first] = renderer.draw_uniforms(torch.Generator(device=dev).manual_seed(77 + first), n, settings)
        return draws[first]

    pose = torch.as_tensor(test.poses[0], device=dev)
    planar = pose.clone()
    planar[2, 3] = 0.0
    frames = {}
    for view, p in (("held_out", pose), ("origin_on_z0", planar)):
        images = {}
        for name, use_kernel, dtype in (("kernel", True, torch.bfloat16), ("plain_bf16", False, torch.bfloat16),
                                        ("plain_f32", False, torch.float32)):
            field = make_nerf_field(compute_dtype=dtype, use_kernel=use_kernel)
            images[name] = renderer.render_image(field, params["coarse"], params["fine"], test.camera, p, 0,
                                                 settings, chunk_size=4096, uniforms_for_chunk=uniforms)
        frames[view] = frame_agreement(images)
    losses = results[0]["losses"] + results[1]["losses"]
    first8, last8 = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    chunks = -(-378 * 504 // 4096)
    want = [[48, 2 * 2 * chunks], [16, 0]]
    want_shapes = [{(4096, 64): 24, (4096, 192): 24}, {(4096, 64): 8, (4096, 192): 8}]
    val = [ln for log in logs for ln in log.splitlines() if ln.startswith("validation @")]
    ok = (launches == want and render_launches == [0, 2 * chunks] and [sh[0] for sh in shapes] == want_shapes
          and (settings.t_near, settings.t_far, settings.project_to_ndc) == (0.0, 1.0, True)
          and test.images.shape[1:3] == (378, 504) and (data_root / "fern" / "images_2").is_dir()
          and len(losses) == 32 and all(math.isfinite(v) for v in losses) and last8 < first8
          and "Resumed from step 24." in logs[1] and len(val) == 1 and png_shape == [378, 504, 3]
          and all(math.isfinite(v) for v in scores.values()) and all(f["ok"] for f in frames.values())
          and frames["held_out"]["non_finite_pixels"]["plain_f32"] == 0
          and frames["origin_on_z0"]["non_finite_pixels"]["plain_f32"] == 378 * 504)
    emit("train_llff", scene_seconds=write_s, seconds=train_s, steps=[r["step"] for r in results],
         image_size=list(test.images.shape[1:3]), t_bounds=[settings.t_near, settings.t_far],
         launches_kernel3_kernel1={"train": launches, "render": render_launches},
         expected={"train": want, "render": [0, 2 * chunks]},
         kernel3_shapes=[{f"{n}x{s_}": c for (n, s_), c in sh[0].items()} for sh in shapes],
         kernel1_points=[sh[1] for sh in shapes] + [render_shapes[1]], losses=losses, mean_loss_first8=first8,
         mean_loss_last8=last8, validation=val, png_shape=png_shape, psnr_vs_gt=scores["psnr"],
         ssim_vs_gt=scores["ssim"], frames=frames,
         tolerance="finite masks equal; finite pixels: kernel psnr vs plain f32 >= plain bf16's - 12.04 dB", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_llff phase failed")
    return {"fused_train_pass": sum(c[0] for c in launches),
            "fused_nerf_fwd": sum(c[1] for c in launches) + render_launches[1]}


# occupancy changed so that the grid prunes within a 24-step run: sweeps
# at every 4th step, the warmup over after 8, and the density threshold
# raised from 0.01, which every cell of these young fields exceeds. On an
# H100 the grids at step 32 read, at their 10th, 50th and 90th
# percentiles, 2.47, 2.89 and 3.53 (classic, at a threshold of 1.0 all
# occupied) and 1.033, 1.039 and 1.050 (bricked NGP: 2**out near 1)
OCC_RUN = ["occupancy.enabled=true", "occupancy.warmup_steps=8", "occupancy.update_every=4"]
OCC_THRESHOLD = {"classic": 3.0, "bricked": 1.05}


def resumed_grid_bit_exact(run: Path, step: int, train_args) -> bool:
    """Whether ``run_train`` restores the grid of ``ckpt_<step>`` bit for
    bit: a resume that runs no step saves the grid it restored, which must
    be the sidecar's bytes."""
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    sidecar = run / "ckpt" / f"ckpt_{step:06d}.occ.npy"
    saved = sidecar.read_bytes()
    _, log, _, _ = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", str(step)] + train_args, [])
    return f"Resumed from step {step}." in log and sidecar.read_bytes() == saved


def grid_report(run: Path, step: int, threshold: float) -> dict:
    """The saved grid's size, its share of cells above ``threshold`` and
    the 10th, 50th and 90th percentiles of its densities."""
    import numpy as np  # noqa: PLC0415

    grid = np.load(run / "ckpt" / f"ckpt_{step:06d}.occ.npy")
    return dict(cells=int(grid.size), threshold=threshold, occupied_share=float((grid > threshold).mean()),
                percentiles_10_50_90=[float(v) for v in np.percentile(grid, [10, 50, 90])])


def phase_train_occ(work: Path):
    """``run_train`` with ``occupancy.enabled=true`` (64^3 grid, sweeps every
    4 steps, warmup 8, the threshold raised: :data:`OCC_RUN`) on
    gaussian_blobs at 400x400 through :func:`train_resume_render`: the
    classic defaults at ``bench.py --occupancy``'s budgets (32 of 64 coarse,
    128 of the 192 merged fine) through the fused pruned step, and
    ``instant_nerf_tpu`` (bricked) at 128 of 256 through the generic one;
    then 8 steps of ``instant_nerf`` (per-corner) at 128. Each run: the
    sidecar beside both checkpoints, the grid restored from it bit for bit,
    the grid at step 32 neither all occupied nor all empty at its
    threshold, losses finite and falling, render and evaluate finite. Launches: kernel
    3 twice a step at 4096 x 32 and 4096 x 128; kernel 1 once a sweep at
    262,144 points besides the renders; kernels 4-5 (6-7) once a step at
    4096 x 128 points, kernel 4 (6) once a sweep; the fused NGP forward
    once a sweep (``occupancy.make_density_fn`` takes ``field.prepare``)
    and once a render chunk, never in a train step."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import ngp_mlp  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    cells, step_points = 64**3, 4096 * 128
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    sweeps = [6, 2]  # state.step % 4 == 0 in 0..23, then in 24..31
    classic_args = ["--config", "default", "occupancy.keep_samples=32", "occupancy.keep_samples_fine=128",
                    f"occupancy.threshold={OCC_THRESHOLD['classic']}"] + OCC_RUN
    classic = train_resume_render(work, "occ", classic_args + NGP_TRAIN_OVERRIDES, [ftm.fused_train_pass,
                                                                                   fn.fused_nerf_apply])
    ngp_args = ["--config", "instant_nerf_tpu", "occupancy.keep_samples=128",
                f"occupancy.threshold={OCC_THRESHOLD['bricked']}"] + OCC_RUN
    counted = hash_ops("bricked")[:2] + hash_ops("hash")[:2] + (ngp_mlp.ngp_mlp_fwd,)
    ngp = train_resume_render(work, "occ_ngp", ngp_args + NGP_TRAIN_OVERRIDES, counted)
    hash_result, _, hash_launches, hash_shapes = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "occ_hash_run"), "--max-steps", "8",
        "occupancy.keep_samples=128", f"occupancy.threshold={OCC_THRESHOLD['bricked']}"] + OCC_RUN
        + NGP_TRAIN_OVERRIDES, counted)

    renders = [2 * (chunks_800 + chunks_400), 0]
    want = {"classic": [[48, sweeps[0] + renders[0]], [16, sweeps[1]]],
            "classic_render": [0, 2 * 2 * chunks_800],
            "bricked": [[24 + sweeps[0] + renders[0] // 2, 24, 0, 0, sweeps[0] + renders[0] // 2],
                        [8 + sweeps[1], 8, 0, 0, sweeps[1]]],
            "bricked_render": [2 * chunks_800, 0, 0, 0, 2 * chunks_800], "hash": [0, 0, 8 + 2, 8, 2]}
    got = {"classic": classic["launches"], "classic_render": classic["render_launches"],
           "bricked": ngp["launches"], "bricked_render": ngp["render_launches"], "hash": hash_launches}
    k3_shapes = [{(4096, 32): n, (4096, 128): n} for n in (24, 8)]
    checks = {
        "launches": got == want,
        "kernel3_shapes": [sh[0] for sh in classic["shapes"]] == k3_shapes,
        # a sweep's 64^3 points are as many as a coarse render chunk's 4096 x 64
        "kernel1_sweeps": [sh[1] for sh in classic["shapes"]] == [
            {cells: sweeps[0] + chunks_800 + chunks_400, 4096 * 192: chunks_800 + chunks_400}, {cells: sweeps[1]}],
        "kernel4_steps_and_sweeps": [(sh[0].get(step_points, 0), sh[0].get(cells, 0)) for sh in ngp["shapes"]]
        == [(24, sweeps[0]), (8, sweeps[1])],
        "kernel5_steps": [sh[1] for sh in ngp["shapes"]] == [{step_points: 24}, {step_points: 8}],
        "kernel67_steps_and_sweeps": hash_shapes[2] == {step_points: 8, cells: 2} and hash_shapes[3] == {step_points: 8},
        "fused_ngp_sweeps": [sh[4].get(cells, 0) for sh in ngp["shapes"]] == [sweeps[0], sweeps[1]]
        and hash_shapes[4] == {cells: 2},
        "classic_run": classic["ok"], "bricked_run": ngp["ok"],
        "hash_losses_finite": len(hash_result["losses"]) == 8 and all(math.isfinite(v) for v in hash_result["losses"]),
    }
    runs = {}
    for name, done, args in (("classic", classic, classic_args), ("bricked", ngp, ngp_args)):
        run = done["run"]
        sidecars = sorted(p.name for p in (run / "ckpt").glob("*.occ.npy"))
        runs[name] = dict(sidecars=sidecars, grid_at_32=grid_report(run, 32, OCC_THRESHOLD[name]),
                          resumed_grid_bit_exact=resumed_grid_bit_exact(run, 32, args + NGP_TRAIN_OVERRIDES),
                          **done["report"])
        checks[f"{name}_sidecars"] = sidecars == ["ckpt_000024.occ.npy", "ckpt_000032.occ.npy"]
        checks[f"{name}_grid_bit_exact"] = runs[name]["resumed_grid_bit_exact"]
        checks[f"{name}_grid_prunes"] = 0.0 < runs[name]["grid_at_32"]["occupied_share"] < 1.0
    ok = all(checks.values())
    emit("train_occ", occupancy="64^3 over [-4, 4]^3; update_every 4, warmup_steps 8 and threshold 3.0 (classic) "
         "or 1.05 (NGP), changed from 16, 512 and 0.01 so that the grid prunes within the run",
         launches=got, expected=want,
         kernel3_shapes=[{f"{n}x{s_}": c for (n, s_), c in sh[0].items()} for sh in classic["shapes"]],
         kernel1_points=[sh[1] for sh in classic["shapes"]], bricked_points=ngp["shapes"], hash_points=hash_shapes,
         runs=runs, hash_losses=hash_result["losses"], checks=checks, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_occ phase failed")
    return {"fused_train_pass": sum(c[0] for c in classic["launches"]),
            "fused_nerf_fwd": sum(c[1] for c in classic["launches"]) + classic["render_launches"][1],
            "hash_brick_fwd": sum(c[0] for c in ngp["launches"]) + ngp["render_launches"][0],
            "hash_brick_bwd": sum(c[1] for c in ngp["launches"]),
            "hash_corner_fwd": hash_launches[2], "hash_corner_bwd": hash_launches[3],
            "ngp_mlp_fwd": sum(c[4] for c in ngp["launches"]) + ngp["render_launches"][4] + hash_launches[4]}


def ngp_field(layout, use_kernel=True):
    from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field  # noqa: PLC0415

    return make_instant_ngp_field(**NGP, compute_dtype=torch.bfloat16, table_layout=layout, use_kernel=use_kernel)


def phase_train_bench_ngp(smi: str):
    """NGP train steps at ``bench.py --model=instant_nerf``'s point (8 views
    at 400x400, 4096 rays x 256 samples, no fine network, Adam 1e-2 -> 1e-3
    at eps 1e-15, ``make_image_train_step(precrop=False)``), every layout,
    the packed ones also with the smoothness loss (weight 1e-3, 1024 probes
    a level), and ``bricked`` with occupancy pruning at ``bench.py
    --model=instant_nerf --occupancy``'s point (128 of 256, the default
    grid, a sweep every 16 steps): 3 warm-up and 20 timed steps, launches
    counted over the timed ones (the fused NGP forward only in the
    occupancy path's sweep); then each hash kernel alone on the 2^20
    points of a dense batch of the step's own, with a seeded random
    cotangent (CUDA events), beside its bound, its share of it and its
    plain version's time."""
    from torch_nerf_tpu_torch import config, occupancy, renderer, session, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import ngp_mlp, sampling  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners.train_ab import step_batch  # noqa: PLC0415

    dev = torch.device("cuda")
    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    _, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    f = NGP["table_feat_dim"]
    timed = 20
    paths, kernels = {}, {}
    variants = ([(x, None) for x in NGP_LAYOUTS + PACKED_LAYOUTS] + [(x, "smoothness") for x in PACKED_LAYOUTS]
                + [("bricked", "occupancy")])
    for layout, extra in variants:
        packed = layout in PACKED_LAYOUTS
        smooth = extra == "smoothness"
        fwd, bwd = fold_ops() if packed else hash_ops(layout)[:2]
        aux = None
        if smooth:
            aux = session.build_aux_loss(config.resolve("instant_nerf", [f"network.table_layout={layout}"]
                                                         + SMOOTHNESS))
        occ = occupancy.OccupancyConfig(keep_samples=128) if extra == "occupancy" else None
        path = f"{layout}+{extra}" if extra else layout
        field = ngp_field(layout)
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, aux_loss_fn=aux, occupancy_cfg=occ)
        grid = occupancy.init_grid(occ, dev) if occ else None
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(3):
            state, grid, _ = bench_step(step, state, grid, images, poses, gen)
        torch.cuda.synchronize()
        launch_count.reset(fwd, bwd, ngp_mlp.ngp_mlp_fwd)
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            state, grid, metrics = bench_step(step, state, grid, images, poses, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        per_step = 2 if smooth else 1
        # a pruned step's forward sees 4096 x 128 points, and one sweep
        # (state.step 16, 64^3 points) falls among the timed steps 3..22
        want_fwd = {4096 * 128: timed, 64**3: 1} if occ else None
        paths[path] = dict(ms_per_step=elapsed / timed * 1e3, rays_per_sec=4096 * timed / elapsed,
                           launches={"fwd": fwd.launches, "bwd": bwd.launches,
                                     "fused": dict(ngp_mlp.ngp_mlp_fwd.shapes)},
                           expected_launches={"fwd": per_step * timed + (1 if occ else 0), "bwd": per_step * timed,
                                              "fused": {64**3: 1} if occ else {}},
                           fwd_points=dict(fwd.shapes), expected_fwd_points=want_fwd,
                           loss_first=losses[0], loss_last=losses[-1],
                           aux_loss_last=float(metrics["aux_loss"]) if smooth else None,
                           finite=all(math.isfinite(v) for v in losses))
        if extra:
            continue
        o, d, _, uni = step_batch(step, images, poses, camera, gen)
        t = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far)
        pts, _ = ray_points(o, d, t)
        m = pts.shape[0]
        tables = state.params["coarse"]["tables"].detach()
        levels = tables.shape[0] if packed else NGP["num_level"]
        g = torch.randn((m, levels * f), generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        # the coordinates and the (N, L*F) output (or its cotangent), each
        # read or written once; besides, a forward reads the table's sectors
        # that this batch blends, and a backward writes its dense gradient
        # whole (the wrapper zeroes it, then the kernel adds)
        io_bytes = 4 * (3 * m + levels * f * m)
        # the blend's (or the scatter's) multiply and add of 8 sites x F a (point, level)
        flops = 2 * 8 * f * levels * m
        if packed:
            res, off = fold_grid(layout, dev)
            ops = (("fwd", lambda: fwd(tables, pts, res, off, f),
                    lambda: hg.fold_encode_reference(tables, pts, res, off, f)),
                   ("bwd", lambda: bwd(g, pts, res, off, tables.shape[1], f),
                    lambda: hg.fold_backward_reference(g, pts, res, off, tables.shape[1], f)))
        else:
            res = ngp_resolutions(dev)
            _, _, fwd_ref, bwd_ref = hash_ops(layout)
            off = None
            ops = (("fwd", lambda: fwd(tables, pts, res), lambda: fwd_ref(tables, pts, res)),
                   ("bwd", lambda: bwd(g, pts, res, *table_args(tables)),
                    lambda: bwd_ref(g, pts, res, *table_args(tables))))
        with torch.no_grad():
            table_bytes = {"fwd": forward_table_bytes(layout, tables, pts, res, off), "bwd": 4 * tables.numel()}
            for name, run, plain in ops:
                kernels[f"{layout}/{name}"] = bound_entry(cuda_ms(run, 20), cuda_ms(plain, 3), flops,
                                                          io_bytes + table_bytes[name], F32_PEAK, peak_bw, m)
        hash_ms = kernels[f"{layout}/fwd"]["ms"] + kernels[f"{layout}/bwd"]["ms"]
        paths[path].update(hash_kernels_ms_per_step=hash_ms,
                           hash_kernels_share_of_step=hash_ms / paths[path]["ms_per_step"])
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    ok = all(p["finite"] and p["launches"] == p["expected_launches"]
             and (p["expected_fwd_points"] is None or p["fwd_points"] == p["expected_fwd_points"])
             and (p["aux_loss_last"] is None or p["aux_loss_last"] > 0.0) for p in paths.values())
    emit("train_bench_ngp", card=smi, sm_clock_temp_power=clocks, timed_steps=timed, paths=paths,
         kernels=kernels, peak_bytes_per_s=peak_bw, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_bench_ngp phase failed")
    return kernels


def phase_bench_ngp(smi: str):
    """800x800 NGP frames at ``bench.py --render --model=instant_nerf``'s
    point (256 samples, no fine network, 4096-ray chunks: 157 forward hash
    launches and 157 of the fused forward after it a frame), every layout,
    seeded random weights: a warm-up and 2 timed frames each."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import ngp_mlp  # noqa: PLC0415

    dev = torch.device("cuda")
    settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
    camera = cameras.CameraParams(960.0, 960.0, 800, 800)
    pose = torch.as_tensor(synthetic.split_poses(1, "train")[0], device=dev)
    frames, layouts = 2, {}
    for layout in NGP_LAYOUTS + PACKED_LAYOUTS:
        fwd = fold_ops()[0] if layout in PACKED_LAYOUTS else hash_ops(layout)[0]
        field = ngp_field(layout)
        params = field.init(torch.Generator(device=dev).manual_seed(0), dev)

        def frame(seed):
            return renderer.render_image(field, params, None, camera, pose, seed, settings, chunk_size=4096)

        img = frame(1)
        torch.cuda.synchronize()
        launch_count.reset(fwd, ngp_mlp.ngp_mlp_fwd)
        t0 = time.perf_counter()
        for i in range(frames):
            img = frame(2 + i)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        layouts[layout] = dict(seconds_per_frame=elapsed / frames, rays_per_sec=800 * 800 * frames / elapsed,
                               launches_per_frame=fwd.launches / frames,
                               fused_launches_per_frame=ngp_mlp.ngp_mlp_fwd.launches / frames,
                               finite=bool(torch.isfinite(img).all()), shape=list(img.shape))
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    chunks = -(-800 * 800 // 4096)
    ok = all(v["finite"] and v["launches_per_frame"] == v["fused_launches_per_frame"] == chunks
             and v["shape"] == [800, 800, 3] for v in layouts.values())
    emit("bench_ngp", card=smi, sm_clock_temp_power=clocks, frames=frames, layouts=layouts, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: bench_ngp phase failed")
    return layouts


# ---------------------------------------------------------------------------
# the NGP field's fused forward after the hash encode (csrc/ngp_mlp_fwd.cu)

NGP_FUSED_SHAPE = (4096, 256)  # the render cell's chunk: rays x samples


def ngp_fused_case(layout, dev, seed, rays=NGP_FUSED_SHAPE[0], samples=NGP_FUSED_SHAPE[1]):
    """``(w, feats, ray_dirs, samples, params)`` of a bf16 NGP field at the
    render cell's init (tables U(-1, 1), MLP weights PyTorch's default x
    sqrt(6)): the hash encode's features of ``rays`` random pixels of a
    400x400 view x ``samples`` stratified depths in [2, 6], the rays'
    directions and the field's ``prepare``-d handle."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.models import instant_ngp  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(seed)
    field = ngp_field(layout)
    params = field.init(gen, dev)
    params["tables"].uniform_(-1.0, 1.0, generator=gen)
    for mlp in ("density_mlp", "color_mlp"):
        for layer in params[mlp].values():
            layer["w"].mul_(math.sqrt(6.0))
    camera = cameras.CameraParams(480.0, 480.0, 400, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[seed % 8], device=dev)
    pix = torch.randint(0, 400 * 400, (rays,), generator=gen, device=dev)
    o, d = cameras.rays_for_pixels(pix, camera, pose)
    uni = renderer.draw_uniforms(gen, rays, renderer.RenderSettings(num_samples_coarse=samples, num_samples_fine=0))
    t = sampling.stratified_t_samples_from_uniforms(uni.coarse, 2.0, 6.0)
    pts = sampling.points_along_rays(o, d, t).reshape(-1, 3).contiguous()
    w = field.prepare(params)
    res = ngp_resolutions(dev)
    with torch.no_grad():
        feats = instant_ngp.encode_features(w.tables, pts, res, layout, w.in_dim)
    return w, feats, d.contiguous(), samples, params


def ngp_fused_verdict(got, plain, ref) -> dict:
    """:func:`judge` of the kernel's (log2 sigma, rgb) against the plain
    version in f32 (the yardstick), by the plain bf16 version's own error; with the largest
    gaps between kernel and plain and the share of rgb values that
    differ."""
    def named_out(out):
        return {"log2_sigma": torch.log2(out[0]), "rgb": out[1]}

    ref_out = named_out(ref)
    verdict = judge(rel_l2(named_out(got), ref_out), rel_l2(named_out(plain), ref_out))
    verdict.update(max_abs_vs_plain={k: (a - b).abs().max().item() for (k, a), b in
                                     zip(named_out(got).items(), named_out(plain).values())},
                   rgb_differing_share=(got[1] != plain[1]).float().mean().item())
    return verdict


def phase_ngp_fused(smi: str):
    """The NGP field's fused forward (``ops/ngp_mlp.py``) against its plain
    version: at the render cell's shape (4096 rays x 256 samples) on the
    ``hash`` layout (32 features) and on ``packed_dual`` (64), and on ragged
    shapes (37 rays x 51 samples; 4099 points of their own directions);
    each held against the plain version in f32 by the plain bf16 version's error
    (:func:`judge`), two planted faults in the weight image (the colour
    fc_in's SH columns zeroed; the density hidden layer's panel without its
    swizzle) rejected, a second launch bit-identical, NaN and +-inf planted
    in the features coming out where the plain version puts them; then the
    kernel timed at the cell's shape beside its bound, its plain version and
    today's tree route after the encode (cuBLAS GEMMs and PyTorch's
    elementwise kernels: the library yardstick)."""
    from torch_nerf_tpu_torch import encoders  # noqa: PLC0415
    from torch_nerf_tpu_torch.models import instant_ngp  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import ngp_mlp  # noqa: PLC0415

    dev = torch.device("cuda")
    peak_flops, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    checks, timings = {}, {}
    launch_count.reset(ngp_mlp.ngp_mlp_fwd)
    launches = 0
    for name, layout, rays, samples in (("cell/hash", "hash", *NGP_FUSED_SHAPE),
                                        ("cell/packed_dual", "packed_dual", *NGP_FUSED_SHAPE),
                                        ("ragged/hash", "hash", 37, 51), ("ragged/packed_dual", "packed_dual", 37, 51),
                                        ("points/hash", "hash", 4099, 1)):
        w, feats, ray_dirs, samples, params = ngp_fused_case(layout, dev, 11, rays, samples)
        with torch.no_grad():
            got = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples)
            again = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples)
            launches += 2
            plain = ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples)
            ref = ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples, compute_dtype=torch.float32)
            torch.cuda.synchronize()
            entry = ngp_fused_verdict(got, plain, ref)
            entry["relaunch_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
            entry["points"] = feats.shape[0]
            if name.startswith("cell"):
                faults = {}
                color_in = params["color_mlp"]["fc_in"]
                no_sh = {**params, "color_mlp": {**params["color_mlp"], "fc_in": {
                    "w": torch.cat([color_in["w"][:16], torch.zeros_like(color_in["w"][16:])]), "b": color_in["b"]}}}
                faults["sh_columns_zeroed"] = dataclasses.replace(w, image=ngp_mlp.weight_image(no_sh))
                image = w.image.clone()
                hidden = slice(64 * 64, 2 * 64 * 64)  # the density hidden layer's panel, row-major
                image[hidden] = w.density_mlp["fc_hidden_0"]["w"].to(torch.bfloat16).t().reshape(-1)
                faults["density_hidden_unswizzled"] = dataclasses.replace(w, image=image)
                entry["faults_rejected"] = {
                    k: not ngp_fused_verdict(ngp_mlp.ngp_mlp_fwd(f, feats, ray_dirs, samples), plain, ref)["ok"]
                    for k, f in faults.items()}
                launches += len(faults)
                # NaN, +inf and -inf planted in three points' features
                bad = feats.clone()
                bad[5, 3], bad[1000, 0], bad[-1, -1] = float("nan"), float("inf"), float("-inf")
                k_out = ngp_mlp.ngp_mlp_fwd(w, bad, ray_dirs, samples)
                p_out = ngp_mlp.ngp_mlp_reference(w, bad, ray_dirs, samples)
                launches += 1
                entry["nonfinite_where_plain"] = all(
                    torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.isinf(a), torch.isinf(b))
                    for a, b in zip(k_out, p_out))
                entry["nonfinite_points"] = int((~torch.isfinite(k_out[1]).all(dim=-1)).sum())
                n, in_dim = feats.shape
                flops = 2 * n * sum(layer["w"].numel() for mlp in (w.density_mlp, w.color_mlp)
                                    for layer in mlp.values())
                nbytes = 4 * (n * in_dim + 3 * ray_dirs.shape[0] + 4 * n)
                dirs_points = ray_dirs[:, None, :].expand(-1, samples, -1)

                def library():
                    dir_enc = encoders.sh_encoding(dirs_points, ngp_mlp.SH_DEGREE).reshape(n, -1)
                    density_out = instant_ngp.small_mlp_apply(params["density_mlp"], feats, torch.bfloat16)
                    color_in = torch.cat([density_out, dir_enc], dim=-1)
                    color = instant_ngp.small_mlp_apply(params["color_mlp"], color_in, torch.bfloat16)
                    return torch.exp2(density_out[..., 0]), torch.sigmoid(color)

                timed = 20
                ms = cuda_ms(lambda: ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples), timed)
                launches += timed + 1
                timings[name] = bound_entry(ms, cuda_ms(lambda: ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples),
                                                        5),
                                            flops, nbytes, peak_flops, peak_bw, n)
                timings[name]["library_ms"] = cuda_ms(library, 5)
                timings[name]["library"] = "instant_ngp_apply after the encode: cuBLAS GEMMs, elementwise, cat"
        checks[name] = entry
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    ok = (all(e["ok"] and e["relaunch_equal"] for e in checks.values())
          and all(all(e["faults_rejected"].values()) and e["nonfinite_where_plain"]
                  for e in checks.values() if "faults_rejected" in e)
          and ngp_mlp.ngp_mlp_fwd.launches == launches)
    emit("ngp_fused", card=smi, sm_clock_temp_power=clocks, checks=checks, kernels=timings,
         launches=ngp_mlp.ngp_mlp_fwd.launches, expected_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: ngp_fused phase failed")
    return {"checks": checks, "kernels": timings}


# ---------------------------------------------------------------------------
# Multi-scene training (kernels 1, 3, 4 and 5 once a scene), LPIPS, profiler

MULTI_OVERRIDES = ["data.dataset_type=gaussian_blobs", "data.img_size=400", "data.num_scenes=2",
                   "train_params.validation.validate_every=3", "train_params.log.epoch_btw_ckpt=3"]


def max_abs_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def train_multi_run(work: Path, name: str, config_args, counted) -> dict:
    """A 2-scene ``run_train`` with ``config_args`` into ``work/<name>_run``
    (gaussian_blobs scenes 0 and 1 at 400x400, 8 views each): 24 steps (one
    validation of each scene's 800x800 val view 0, one checkpoint), a resume
    for 8 more, then ``run_render --scene 1`` of two 800x800 test views and
    ``evaluate`` against scene 1's own test ground truth; the ``counted``
    wrappers' launches over each CLI call. Each scene's loss must fall (its
    last 8 steps' mean below its first 8's), each scene's params move in the
    resume, and the two scenes' params differ."""
    from torch_nerf_tpu_torch import checkpoints, config, session, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    run, out, gt = work / f"{name}_run", work / f"{name}_render", work / f"{name}_gt"
    logs, results, launches = [], [], []
    t0 = time.perf_counter()
    for max_steps in (24, 32):
        r, log, c, _ = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", str(max_steps)]
                               + config_args + MULTI_OVERRIDES, counted)
        results.append(r)
        logs.append(log)
        launches.append(c)
    train_s = time.perf_counter() - t0
    _, render_log, render_launches, _ = run_cli(run_render.main, [
        "--log-dir", str(run), "--scene", "1", "--render-test-views", "--num-views", "2", "--out-dir", str(out)],
        counted)
    cfg = config.load_config(run / "config.yaml")
    data = session.build_multiscene_dataset(cfg, 1, "test", device=torch.device("cuda"))
    gt.mkdir(parents=True)
    for i in range(2):
        save_png(gt / f"{i:04d}.png", data.images[i])
    scores = evaluate.main([str(out), str(gt)])
    losses = results[0]["losses"] + results[1]["losses"]
    scene_losses = [a + b for a, b in zip(results[0]["scene_losses"], results[1]["scene_losses"])]
    first8 = [sum(v[:8]) / 8 for v in scene_losses]
    last8 = [sum(v[-8:]) / 8 for v in scene_losses]
    val = [ln for log in logs for ln in log.splitlines() if ln.startswith("validation @")]
    ckpt = {step: train.parameter_list(checkpoints.load_checkpoint(run / "ckpt" / f"ckpt_{step:06d}.pt")["params"])
            for step in (24, 32)}
    moved = [max_abs_diff([p[s] for p in ckpt[32]], [p[s] for p in ckpt[24]]) for s in range(2)]
    scenes_apart = max_abs_diff([p[0] for p in ckpt[32]], [p[1] for p in ckpt[32]])
    shapes = [list(load_png(p).shape) for p in sorted(out.iterdir())]
    resumed = "Resumed from step 24." in logs[1]
    ok = (len(losses) == 32 and all(len(v) == 32 and all(math.isfinite(x) for x in v) for v in scene_losses)
          and all(b < a for a, b in zip(first8, last8)) and resumed and len(val) == 1
          and "psnr_scene0=" in val[0] and "psnr_scene1=" in val[0] and all(m > 0.0 for m in moved)
          and scenes_apart > 0.0 and "Loaded scene 1 of a 2-scene checkpoint at step 32." in render_log
          and shapes == [[800, 800, 3]] * 2 and all(math.isfinite(v) for v in scores.values()))
    return dict(ok=ok, launches=launches, render_launches=render_launches, render_dir=out, gt_dir=gt,
                report=dict(seconds=train_s, steps=[r["step"] for r in results], mean_loss=losses,
                            scene_loss_first8=first8, scene_loss_last8=last8, validation=val, resumed=resumed,
                            params_moved_in_resume=moved, scenes_params_max_abs_apart=scenes_apart,
                            png_shapes=shapes, psnr_vs_scene1_gt=scores["psnr"], ssim_vs_scene1_gt=scores["ssim"]))


def phase_train_multi(work: Path):
    """``run_train data.num_scenes=2`` through :func:`train_multi_run`, the
    default classic config at full width (kernel 3 twice a scene a step,
    kernel 1 twice a 4096-ray chunk of each validation and render) and the
    bricked ``instant_nerf_tpu`` preset (kernels 4 and 5 once a scene a
    step, kernel 4 once a chunk)."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    chunks = -(-800 * 800 // 4096)
    runs = {
        # [kernel 3, kernel 1] per call; 2 scenes, 24 + 8 steps, a validation of both at step 24
        "classic": (["--config", "default"], [ftm.fused_train_pass, fn.fused_nerf_apply],
                    [[2 * 2 * 24, 2 * 2 * chunks], [2 * 2 * 8, 0]], [0, 2 * 2 * chunks]),
        # [kernel 4, kernel 5] per call
        "bricked": (["--config", "instant_nerf_tpu"], hash_ops("bricked")[:2],
                    [[2 * 24 + 2 * chunks, 2 * 24], [2 * 8, 2 * 8]], [2 * chunks, 0]),
    }
    report, done, ok = {}, {}, True
    for name, (args, counted, want, want_render) in runs.items():
        r = train_multi_run(work, f"multi_{name}", args, counted)
        good = r["ok"] and r["launches"] == want and r["render_launches"] == want_render
        report[name] = dict(launches={"train": r["launches"], "render": r["render_launches"]},
                            expected={"train": want, "render": want_render}, **r["report"], ok=good)
        ok = ok and good
        done[name] = r
    emit("train_multi", runs=report, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_multi phase failed")
    c, b = done["classic"], done["bricked"]
    return {"fused_train_pass": sum(x[0] for x in c["launches"]) + c["render_launches"][0],
            "fused_nerf_fwd": sum(x[1] for x in c["launches"]) + c["render_launches"][1],
            "hash_brick_fwd": sum(x[0] for x in b["launches"]) + b["render_launches"][0],
            "hash_brick_bwd": sum(x[1] for x in b["launches"]) + b["render_launches"][1],
            "render_dir": c["render_dir"], "gt_dir": c["gt_dir"]}


def multi_pools(num_scenes: int, dev):
    """``num_scenes`` gaussian_blobs scenes (``GaussianBlobScene.random(s)``),
    8 views at 400x400 each, stacked on the card: ``(images (S, 8, H*W, 3),
    poses (S, 8, 4, 4), camera)``."""
    import numpy as np  # noqa: PLC0415

    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415

    imgs, poses = [], []
    for s in range(num_scenes):
        i, p, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev,
                                                 scene=synthetic.GaussianBlobScene.random(s))
        imgs.append(i)
        poses.append(p)
    return torch.as_tensor(np.stack(imgs), device=dev), torch.as_tensor(np.stack(poses), device=dev), camera


def clone_tree(tree):
    """Detached copies of a parameter tree's leaves."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def single_state(params, optim):
    """A single-scene train state on copies of ``params``."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415

    params = clone_tree(params)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


def kernel3_verdict(params, o, d, t, gt):
    """Kernel 3 on ``params`` (a scene's views) against its plain version,
    as kernel_train holds it: grads by relative L2, rgb and weights by
    :func:`composite_errors`, each within 2x the plain bf16 version's error
    + 1e-3; one launch. ``(verdict, the plain f32 weights)``."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    cfg = fn.FusedNeRFConfig(**FULL)
    cfg32 = fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32)
    n = o.shape[0]
    delta = sampling.t_deltas(t)
    c32, w32, g32 = train_reference(bf16_rounded(params), o, d, t, delta, gt, cfg32, n)
    cbf, wbf, gbf = train_reference(params, o, d, t, delta, gt, cfg, n)
    before = ftm.fused_train_pass.launches
    c, w, g = ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, n)
    torch.cuda.synchronize()
    verdict = judge(rel_l2(named(g), named(g32)), rel_l2(named(gbf), named(g32)))
    comp = composite_errors(c, w, c32, w32, cbf, wbf, delta >= 1e7)
    max_abs = max([comp["max_abs_err"]] + [(g[a][k] - g32[a][k]).abs().max().item() for a in g for k in g[a]])
    ok = verdict["ok"] and comp["ok"] and ftm.fused_train_pass.launches == before + 1
    return dict(points=t.numel(), grads=verdict, composite=comp, max_abs_err=max_abs, ok=ok), w32


def multi_step_classic(images, poses, camera) -> dict:
    """One 2-scene classic step at full width against two single-scene
    steps, then kernels 3 and 1 on its inputs (:func:`phase_train_multi_step`)."""
    from torch_nerf_tpu_torch import multiscene, renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = images.device
    field = make_nerf_field(compute_dtype=torch.bfloat16)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    state = multiscene.create_multiscene_state(multiscene.scene_generators(0, 2, dev), field, settings, optim, 2, dev)
    # the stacked params before the step: the values its kernels read
    stacked_before = clone_tree(state.params)
    singles = [single_state(multiscene.scene_params(state, s), optim) for s in range(2)]
    step = multiscene.make_multiscene_train_step(field, settings, optim, camera, 2, 4096)
    single_step = train.make_image_train_step(field, settings, optim, camera, 4096)
    draws = step.draw(multiscene.scene_generators(1, 2, dev), 8)
    launch_count.reset(ftm.fused_train_pass)
    state, metrics = step(state, images, poses, draws=draws)
    torch.cuda.synchronize()
    multi_launches = ftm.fused_train_pass.launches
    diffs = {"params": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0, "coarse_loss": 0.0, "fine_loss": 0.0}
    stacked = train.parameter_list(state.params)
    for s in range(2):
        singles[s], m = single_step(singles[s], images[s], poses[s], draws=draws[s])
        ref = train.parameter_list(singles[s].params)
        diffs["params"] = max(diffs["params"], max_abs_diff([p[s] for p in stacked], ref))
        for key in ("exp_avg", "exp_avg_sq"):
            diffs[key] = max(diffs[key], max_abs_diff([state.optimizer.state[p][key][s] for p in stacked],
                                                      [singles[s].optimizer.state[p][key] for p in ref]))
        for key in ("coarse_loss", "fine_loss"):
            diffs[key] = max(diffs[key], abs(metrics[key][s].item() - m[key].item()))
    bit_equal = all(v == 0.0 for v in diffs.values())

    # the kernels on the multi-scene path's inputs: each scene's batch of the
    # step and its views of the stacked params
    kernels, errs = {}, {"fused_train_pass": 0.0, "fused_nerf_fwd": 0.0}
    for s in range(2):
        views = multiscene.slice_scene(stacked_before, s)
        o, d, gt = (x.contiguous() for x in single_step.ray_batch(images[s], poses[s], draws[s]))
        uni = draws[s].rays
        t_c = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far).contiguous()
        coarse, w32 = kernel3_verdict(views["coarse"], o, d, t_c, gt)
        fine, _ = kernel3_verdict(views["fine"], o, d, fine_depths(w32, uni, settings), gt)
        k1 = compare_with_plain(views["coarse"], *ray_points(o, d, t_c))
        kernels[f"scene{s}"] = {"kernel3_coarse": coarse, "kernel3_fine": fine, "kernel1_coarse_points": k1}
        errs["fused_train_pass"] = max(errs["fused_train_pass"], coarse["max_abs_err"], fine["max_abs_err"])
        errs["fused_nerf_fwd"] = max(errs["fused_nerf_fwd"], max(k1["max_abs_err"].values()))
    finite = all(torch.isfinite(v).all().item() for v in metrics.values())
    ok = bit_equal and multi_launches == 4 and finite and all(v["ok"] for k in kernels.values() for v in k.values())
    return dict(report=dict(max_abs_vs_single_scene_steps=diffs, bit_equal=bit_equal,
                            kernel3_launches=multi_launches, expected_kernel3_launches=4,
                            losses={k: v.tolist() for k, v in metrics.items()}, kernels=kernels, ok=ok),
                ok=ok, errs=errs)


def multi_step_bricked(images, poses, camera) -> dict:
    """One 2-scene bricked step (kernels 4 and 5 once a scene), then kernels
    4-5 on each scene's 2^20 batch points and its view of a stacked
    U(-1, 1) table (:func:`phase_train_multi_step`)."""
    from torch_nerf_tpu_torch import multiscene, renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    dev = images.device
    field = ngp_field("bricked")
    settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    state = multiscene.create_multiscene_state(multiscene.scene_generators(0, 2, dev), field, settings, optim, 2, dev)
    step = multiscene.make_multiscene_train_step(field, settings, optim, camera, 2, 4096)
    single_step = train.make_image_train_step(field, settings, optim, camera, 4096)
    draws = step.draw(multiscene.scene_generators(1, 2, dev), 8)
    fwd, bwd, fwd_ref, bwd_ref = hash_ops("bricked")
    launch_count.reset(fwd, bwd)
    state, metrics = step(state, images, poses, draws=draws)
    torch.cuda.synchronize()
    launches = [fwd.launches, bwd.launches]
    res = ngp_resolutions(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    stacked = torch.rand((2,) + ngp_table_shape("bricked"), generator=gen, device=dev) * 2.0 - 1.0
    kernels, errs = {}, {"hash_brick_fwd": 0.0, "hash_brick_bwd": 0.0}
    for s in range(2):
        o, d, _ = single_step.ray_batch(images[s], poses[s], draws[s])
        t = sampling.stratified_t_samples_from_uniforms(draws[s].rays.coarse, settings.t_near, settings.t_far)
        pts, _ = ray_points(o, d, t)
        tables = stacked[s]
        g = torch.randn((pts.shape[0], 32), generator=gen, device=dev)
        v = hash_verdict("bricked", tables, pts, res, g, fwd_ref(tables, pts, res),
                         bwd_ref(g, pts, res, *table_args(tables)))
        kernels[f"scene{s}"] = dict(points=pts.shape[0], table_offset_bytes=tables.data_ptr() - stacked.data_ptr(),
                                    err=v["err"], limit=v["limit"], ok=v["ok"])
        errs["hash_brick_fwd"] = max(errs["hash_brick_fwd"], v["err"]["fwd_max_abs"])
        errs["hash_brick_bwd"] = max(errs["hash_brick_bwd"], v["err"]["grad_max_abs"])
    finite = all(torch.isfinite(v).all().item() for v in metrics.values())
    ok = launches == [2, 2] and finite and all(k["ok"] for k in kernels.values())
    return dict(report=dict(launches_fwd_bwd=launches, expected=[2, 2],
                            losses={k: v.tolist() for k, v in metrics.items()}, kernels=kernels, ok=ok),
                ok=ok, errs=errs)


def phase_train_multi_step():
    """One 2-scene step on the card at full width with explicit draws
    (``step.draw``), the default classic config, against two single-scene
    ``make_image_train_step`` calls on copies of each scene's params with
    the same draws: params, Adam's moments and the losses must be equal,
    max-abs 0.0 (kernel 3 is bit-identical from launch to launch, Adam
    elementwise). Then, on each scene's own batch of that step and its
    params as the multi-scene step hands them (views of the stacked leaves),
    kernel 3 coarse and fine and kernel 1 on the coarse points against their
    plain versions; then one 2-scene bricked step (kernels 4 and 5 once a
    scene), and kernels 4-5 on each scene's 2^20 batch points and its view
    of a stacked U(-1, 1) table against their plain versions."""
    dev = torch.device("cuda")
    images, poses, camera = multi_pools(2, dev)
    classic = multi_step_classic(images, poses, camera)
    bricked = multi_step_bricked(images, poses, camera)
    ok = classic["ok"] and bricked["ok"]
    emit("train_multi_step", classic=classic["report"], bricked=bricked["report"],
         rule="classic: params, Adam's moments and losses of the 2-scene step equal to the single-scene steps' "
              "(max-abs 0.0); kernels 3 and 1 as kernel_train and kernel hold them, kernels 4-5 as kernel_hash",
         ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_multi_step phase failed")
    return {**classic["errs"], **bricked["errs"]}


def phase_train_bench_multi(smi: str, rounds: int = 5, steps: int = 10):
    """S-scene steps at ``bench.py``'s train point (8 views of 400x400 a
    scene, 4096 rays a scene) against S single-scene steps: classic S = 2
    and S = 4, bricked S = 2 (``bench.py --model=instant_nerf``'s point).
    After 3 warm-up steps each, ``rounds`` turns of ``steps`` synchronized
    steps of every variant, the order reversed every other turn; the median
    of the turns, their spread, and the ratio of the S-scene step to S
    single-scene steps (each turn's, and of the medians). Kernel 3's, or
    kernels 4-5's, launches counted over one turn of each variant."""
    import statistics  # noqa: PLC0415

    from torch_nerf_tpu_torch import multiscene, renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    dev = torch.device("cuda")
    images, poses, camera = multi_pools(4, dev)
    models = {
        "classic": (make_nerf_field(compute_dtype=torch.bfloat16),
                    renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128), train.OptimConfig(),
                    (1, 2, 4), [ftm.fused_train_pass], lambda s: [2 * s]),
        "bricked": (ngp_field("bricked"), renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0),
                    train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15),
                    (1, 2), list(hash_ops("bricked")[:2]), lambda s: [s, s]),
    }
    variants = {}
    for model, (field, settings, optim, counts, counted, per_step) in models.items():
        for s in counts:
            gens = multiscene.scene_generators(1, s, dev)
            state = multiscene.create_multiscene_state(multiscene.scene_generators(0, s, dev), field, settings,
                                                       optim, s, dev)
            if s == 1:
                state = single_state(multiscene.scene_params(state, 0), optim)
                step = train.make_image_train_step(field, settings, optim, camera, 4096)
                run = (lambda step=step, state=state, gen=gens[0]: step(state, images[0], poses[0], gen)[1])
            else:
                step = multiscene.make_multiscene_train_step(field, settings, optim, camera, s, 4096)
                run = (lambda step=step, state=state, gens=gens, s=s: step(state, images[:s], poses[:s], gens)[1])
            variants[f"{model}/S{s}"] = dict(run=run, scenes=s, counted=counted, want=per_step(s), ms=[], loss=[])
    for v in variants.values():
        for _ in range(3):
            v["run"]()
    torch.cuda.synchronize()
    names = list(variants)
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            v = variants[name]
            launch_count.reset(*v["counted"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                metrics = v["run"]()
            torch.cuda.synchronize()
            v["ms"].append((time.perf_counter() - t0) / steps * 1e3)
            v["loss"].append(float(metrics["loss"]))
            v["launches"] = [w.launches for w in v["counted"]]
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    report, ok = {}, True
    for name, v in variants.items():
        model, s = name.split("/")[0], v["scenes"]
        single = variants[f"{model}/S1"]
        entry = dict(scenes=s, ms_per_step=v["ms"], median_ms=statistics.median(v["ms"]), min_ms=min(v["ms"]),
                     max_ms=max(v["ms"]), rays_per_sec=4096 * s / statistics.median(v["ms"]) * 1e3,
                     launches_per_turn=v["launches"], expected_launches_per_turn=[steps * n for n in v["want"]],
                     losses=v["loss"])
        if s > 1:
            entry.update(ratio_to_s_single_steps=entry["median_ms"] / (s * statistics.median(single["ms"])),
                         ratio_by_turn=[a / (s * b) for a, b in zip(v["ms"], single["ms"])])
        good = entry["launches_per_turn"] == entry["expected_launches_per_turn"] and all(
            math.isfinite(x) for x in v["loss"])
        report[name] = dict(entry, ok=good)
        ok = ok and good
    emit("train_bench_multi", card=smi, sm_clock_temp_power=clocks, rounds=rounds, steps_per_turn=steps,
         variants=report, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_bench_multi phase failed")
    return report


def phase_lpips(work: Path, render_dir: Path, gt_dir: Path):
    """LPIPS on the card against the CPU: random AlexNet and lin weights
    (drawn as ``tests/test_lpips.py`` draws them) saved to a ``.npz`` in
    ``work``, two 400x400 images, within 1e-5; then ``evaluate`` on the card
    with ``$LPIPS_WEIGHTS`` naming that file must print an ``LPIPS:`` value
    (train_multi's scene-1 render against its ground truth)."""
    import os  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415

    from torch_nerf_tpu_torch import lpips  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate  # noqa: PLC0415

    rng = np.random.default_rng(0)
    convs, in_ch = [], 3
    for out_ch, k, _, _ in lpips.CONVS:
        convs.append((rng.normal(0, 0.1, (out_ch, in_ch, k, k)).astype(np.float32),
                      rng.normal(0, 0.05, (out_ch,)).astype(np.float32)))
        in_ch = out_ch
    lins = [np.abs(rng.normal(0, 0.2, (c,)).astype(np.float32)) for c in (64, 192, 384, 256, 256)]
    weights = lpips.LPIPSWeights(convs, lins)
    path = work / "lpips_random_weights.npz"
    lpips.export_weights_npz(weights, path)
    a = rng.uniform(0, 1, (400, 400, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    on_cpu = lpips.lpips_alex(a, b, weights, device=torch.device("cpu"))
    on_card = lpips.lpips_alex(a, b, weights, device=torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        lpips.lpips_alex(a, b, weights, device=torch.device("cuda"))
    card_ms = (time.perf_counter() - t0) / 5 * 1e3
    saved = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = str(path)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            scores = evaluate.main([str(render_dir), str(gt_dir)])
    finally:
        if saved is None:
            del os.environ["LPIPS_WEIGHTS"]
        else:
            os.environ["LPIPS_WEIGHTS"] = saved
    printed = [ln for ln in buf.getvalue().splitlines() if ln.startswith("LPIPS:")]
    err = abs(on_card - on_cpu)
    ok = (err <= 1e-5 and on_cpu > 0.0 and "lpips" in scores and math.isfinite(scores["lpips"])
          and printed == [f"LPIPS: {scores['lpips']:.4f}"])
    emit("lpips", image_shape=[400, 400, 3], cpu=on_cpu, card=on_card, abs_err=err, tolerance=1e-5,
         card_ms_per_pair=card_ms, evaluate_line=printed, evaluate_scores=scores, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: lpips phase failed")


# kernel 3's CUDA functions (nerf_mlp_train.cuh, fused_train.cu)
KERNEL3_FUNCTIONS = ("mlp_forward_stash", "composite", "mlp_backward_chain", "dw_gemm", "dw_reduce")


def phase_profile(work: Path):
    """``run_train --profile-steps 2 --max-steps 13`` of the default classic
    config at full width on 4 views of 200x200 (no validation, no
    visualisation): the Chrome trace of steps 10 and 11 must exist and name
    kernel 3's CUDA functions among its device kernels."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    run = work / "profile_run"
    result, log, launches, _ = run_cli(run_train.main, [
        "--config", "default", "--log-dir", str(run), "--max-steps", "13", "--profile-steps", "2",
        "data.dataset_type=gaussian_blobs", "data.img_size=200", "data.num_views=4",
        "train_params.validation.validate_every=0", "train_params.log.epoch_btw_vis=100",
        "train_params.log.epoch_btw_ckpt=100"], [ftm.fused_train_pass])
    trace = run / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"] if trace.exists() else []
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {f: sum(1 for k in kernels if f in k) for f in KERNEL3_FUNCTIONS}
    ok = (result["step"] == 13 and launches == [26] and f"profiler trace written to {run / 'profile'}" in log
          and all(found.values()))
    emit("profile", trace=str(trace.relative_to(work)), trace_bytes=trace.stat().st_size if trace.exists() else 0,
         device_kernel_events=len(kernels), kernel3_events=found, kernel3_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: profile phase failed")


# ---------------------------------------------------------------------------
# Multi-rank parallelism (parallel/): ranks that share cuda:0 over gloo, and
# one NCCL rank. NCCL refuses two ranks on one card, so these phases show
# the sharded paths' numerics and launches; their times are not scaling.

PAR_TIMEOUT = 300.0  # seconds a launch of ranks may take
DP_RAYS = 4096
TP_RAYS = 256  # TP's activations cross gloo through the host at every layer pair
CLASSIC_SETTINGS = dict(num_samples_coarse=64, num_samples_fine=128)


def par_flags() -> None:
    """The main process's matmul settings, in a spawned rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its kernels-line name."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    return {"fused_nerf_fwd": fn.fused_nerf_apply, "fused_nerf_bwd": fn.fused_nerf_bwd,
            "fused_train_pass": ftm.fused_train_pass, "hash_brick_fwd": hg.hash_brick_fwd,
            "hash_brick_bwd": hg.hash_brick_bwd, "hash_corner_fwd": hg.hash_corner_fwd,
            "hash_corner_bwd": hg.hash_corner_bwd, "hash_fold_fwd": hg.hash_fold_fwd,
            "hash_fold_bwd": hg.hash_fold_bwd}


def reset_counts() -> None:
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    launch_count.reset(*kernel_wrappers().values())
    fn.reset_launches()


def read_counts() -> dict:
    """The launches since :func:`reset_counts`, of the kernels that ran."""
    torch.cuda.synchronize()
    return {name: w.launches for name, w in kernel_wrappers().items() if w.launches}


def classic_settings():
    from torch_nerf_tpu_torch import renderer  # noqa: PLC0415

    return renderer.RenderSettings(**CLASSIC_SETTINGS)


def classic_inputs(dev, rays=DP_RAYS):
    """The classic step's batch at bench.py's train point: ``rays`` random
    pixels of a 400x400 training view, random colours and the step's draws,
    all from one seeded generator, so that every rank draws the same."""
    from torch_nerf_tpu_torch import cameras, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(21)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    pix = torch.randperm(400 * 400, generator=gen, device=dev)[:rays]
    o, d = cameras.rays_for_pixels(pix, cameras.CameraParams(480.0, 480.0, 400, 400), pose)
    gt = torch.rand((rays, 3), generator=gen, device=dev)
    return o.contiguous(), d.contiguous(), gt, train.draw_train_randomness(gen, rays, classic_settings())


def classic_state(field, dev):
    from torch_nerf_tpu_torch import train  # noqa: PLC0415

    return train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, classic_settings(),
                                    train.OptimConfig(), dev)


def halves(inputs):
    """The two halves of a batch's rows, as the two ranks of a DP step
    take them."""
    from torch_nerf_tpu_torch.parallel.steps import take_rows  # noqa: PLC0415

    n = inputs[0].shape[0] // 2
    return [tuple(take_rows(x, lo, n) for x in inputs) for lo in (0, n)]


def ray_grads(field, params, inputs, mesh=None, force_generic=False):
    """The classic step's metrics and gradients (``parameter_list`` order,
    on the host): the whole batch's, or this rank's rows' averaged over the
    data group of ``mesh``."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel.steps import DataParallel  # noqa: PLC0415

    grad_fn = train.make_ray_grad_fn(field, classic_settings(), force_generic)
    if mesh is not None:
        inputs = DataParallel(mesh).rows(*inputs)
    metrics, grads = grad_fn(params, *inputs)
    if mesh is not None:
        metrics, grads = DataParallel(mesh).mean(metrics, grads)
    return {k: float(v) for k, v in metrics.items()}, [g.detach().float().cpu() for g in grads]


def read_shapes() -> dict:
    """The shapes each kernel that ran was given since :func:`reset_counts`
    (``launch_count``'s keys: a point count, or kernel 3's ``(N, S)``)."""
    return {name: sorted(w.shapes) for name, w in kernel_wrappers().items() if w.launches}


def classic_dp(mesh, force_generic: bool, dev) -> dict:
    """One classic step at full width, single-process (``mesh`` None) or
    sharded over ``mesh``: its gradients, then the step itself with every
    kernel's launches (and their shapes) counted over it, and the params
    after Adam."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import mesh as pmesh, steps as psteps  # noqa: PLC0415

    field = make_nerf_field(compute_dtype=torch.bfloat16)
    optim = train.OptimConfig()
    state = classic_state(field, dev)
    if mesh is not None:
        state = pmesh.place_state(mesh, state, optim)
    inputs = classic_inputs(dev)
    metrics, grads = ray_grads(field, state.params, inputs, mesh, force_generic)
    if mesh is None:
        step = train.make_ray_train_step(field, classic_settings(), optim, force_generic)
    else:
        step = psteps.make_sharded_train_step(field, classic_settings(), optim, mesh, force_generic)
    reset_counts()
    state, step_metrics = step(state, *inputs)
    launches = read_counts()
    return dict(metrics=metrics, step_loss=float(step_metrics["loss"]), grads=grads, launches=launches,
                shapes=read_shapes(), params=[p.detach().cpu() for p in train.parameter_list(state.params)])


def classic_grads(dev, kind: str, force_generic: bool = False, split: bool = False):
    """The classic step's ``(loss, gradients)`` from the seed-0 state on
    :func:`classic_inputs`: on the kernels (``kind`` "kernel": the fused
    train pass, or with ``force_generic`` kernels 1-2 by autograd) or of
    the plain version in f32 or bf16 (``kind`` "f32", "bf16"); the whole
    batch's, or with ``split`` a list of each half's, the rows that the two
    ranks of a DP step take."""
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415

    if kind == "kernel":
        field = make_nerf_field(compute_dtype=torch.bfloat16)
    else:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
        field = make_nerf_field(**FULL, compute_dtype=dtype, use_kernel=False)
    params = classic_state(field, dev).params
    inputs = classic_inputs(dev)
    if split:
        return [classic_grads_on(field, params, half, force_generic) for half in halves(inputs)]
    return classic_grads_on(field, params, inputs, force_generic)


def classic_grads_on(field, params, inputs, force_generic: bool) -> tuple:
    metrics, grads = ray_grads(field, params, inputs, force_generic=force_generic)
    return metrics["loss"], grads


def classic_half_kernels(dev) -> tuple:
    """Kernels 1-3 on each half of the classic DP batch (the rows that a
    rank of the 2-rank DP step gives them) with the step's seed-0 params,
    against their plain versions: kernel 3 coarse (2048 x 64) and fine
    (2048 x 192, its depths drawn from the plain f32 coarse weights) as
    kernel_train holds it (:func:`kernel3_verdict`); kernel 1 on the half's
    coarse and fine points as the kernel phase holds it
    (:func:`kernel_errors`); kernel 2 on the same points with seeded random
    cotangents as kernel_bwd holds it (:func:`kernel2_verdict`). ``(the
    verdicts, the shapes checked by kernel, the largest max-abs error by
    kernel)``."""
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    settings = classic_settings()
    params = clone_tree(classic_state(make_nerf_field(compute_dtype=torch.bfloat16), dev).params)
    gen = torch.Generator(device=dev).manual_seed(33)
    verdicts, shapes = {}, {"fused_train_pass": set(), "fused_nerf_fwd": set(), "fused_nerf_bwd": set()}
    errs = dict.fromkeys(shapes, 0.0)
    for h, (o, d, gt, uni) in enumerate(halves(classic_inputs(dev))):
        t_c = sampling.stratified_t_samples_from_uniforms(uni.coarse, settings.t_near, settings.t_far).contiguous()
        coarse, w32 = kernel3_verdict(params["coarse"], o, d, t_c, gt)
        t_f = fine_depths(w32, uni, settings)
        fine, _ = kernel3_verdict(params["fine"], o, d, t_f, gt)
        v = {"kernel3_coarse": coarse, "kernel3_fine": fine}
        errs["fused_train_pass"] = max(errs["fused_train_pass"], coarse["max_abs_err"], fine["max_abs_err"])
        for net, t in (("coarse", t_c), ("fine", t_f)):
            pts, dirs = ray_points(o, d, t)
            v[f"kernel1_{net}"] = k1 = kernel_errors(params[net], pts, dirs)
            v[f"kernel2_{net}"] = k2 = kernel2_verdict(params[net], pts, dirs, gen)
            shapes["fused_train_pass"].add(tuple(t.shape))
            shapes["fused_nerf_fwd"].add(pts.shape[0])
            shapes["fused_nerf_bwd"].add(pts.shape[0])
            errs["fused_nerf_fwd"] = max(errs["fused_nerf_fwd"], *k1["max_abs_err"].values())
            errs["fused_nerf_bwd"] = max(errs["fused_nerf_bwd"], k2["max_abs_err"])
        verdicts[f"half{h}"] = v
    return verdicts, shapes, errs


def bricked_setup(mesh, dev) -> dict:
    """The bricked Instant-NGP image step at ``bench.py --model=instant_nerf
    --occupancy``'s point (4096 rays x 256 candidates, 128 kept, the 64^3
    grid), single-process (``mesh`` None) or sharded over ``mesh``, at its
    first step, which sweeps the grid: the field, the state (its table
    U(-1, 1)), the step's draws, the swept grid and the config whose
    threshold is that grid's median, the step and its ray batch."""
    from torch_nerf_tpu_torch import occupancy, renderer, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import mesh as pmesh, steps as psteps  # noqa: PLC0415

    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    field = ngp_field("bricked")
    settings = renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=300_000, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    occ = occupancy.OccupancyConfig(keep_samples=128, warmup_steps=0)
    state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
    with torch.no_grad():
        # U(-1, 1) tables, as kernel_hash's: the U(-1e-4, 1e-4) init gives
        # every cell about the same density, which no threshold splits
        state.params["coarse"]["tables"].mul_(1e4)
    density = occupancy.make_density_fn(field)

    def make_step(occ):
        if mesh is None:
            return train.make_image_train_step(field, settings, optim, camera, DP_RAYS, occupancy_cfg=occ)
        return psteps.make_sharded_image_train_step(field, settings, optim, camera, mesh, DP_RAYS,
                                                    occupancy_cfg=occ)

    if mesh is not None:
        state = pmesh.place_state(mesh, state, optim)
        density = psteps.DataParallel(mesh).density_fn(density)
    draws = make_step(occ).draw(torch.Generator(device=dev).manual_seed(1), 8, 0)
    grid0 = occupancy.init_grid(occ, dev)
    grid = occupancy.update_grid(grid0, density, state.params, draws.occ_jitter, occ)
    # the threshold at the swept grid's median: the pruned pass keeps the
    # samples of half the cells, by the grid and not by the quota alone
    occ = dataclasses.replace(occ, threshold=grid.median().item())
    step = make_step(occ)
    o, d, gt = step.ray_batch(images, poses, draws)
    return dict(field=field, settings=settings, occ=occ, state=state, grid0=grid0, grid=grid, draws=draws,
                step=step, images=images, poses=poses, rays=(o, d, gt, draws.rays))


def bricked_grads(ctx: dict, field, rays) -> tuple:
    """The pruned loss's metrics and gradients through ``field`` (the
    kernels' or the plain one) on ``rays``, with the params and the swept
    grid of :func:`bricked_setup`'s ``ctx``."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415

    params = ctx["state"].params
    loss, metrics = train.pruned_ray_loss_fn(field, params, ctx["grid"], ctx["occ"], *rays, ctx["settings"], 0)
    grads = list(torch.autograd.grad(loss, train.parameter_list(params)))
    return {k: v.detach() for k, v in metrics.items()}, [g.detach() for g in grads]


def bricked_dp(mesh, dev) -> dict:
    """The bricked step's sweep alone, the pruned loss's gradients on its
    grid (this rank's rows', averaged over the data group of ``mesh``),
    then the step itself with every kernel's launches (and their shapes)
    counted, single-process or sharded over ``mesh``."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import steps as psteps  # noqa: PLC0415

    ctx = bricked_setup(mesh, dev)
    rays = ctx["rays"]
    if mesh is not None:
        rays = psteps.DataParallel(mesh).rows(*rays)
    metrics, grads = bricked_grads(ctx, ctx["field"], rays)
    if mesh is not None:
        metrics, grads = psteps.DataParallel(mesh).mean(metrics, grads)
    reset_counts()
    state, step_grid, step_metrics = ctx["step"](ctx["state"], ctx["grid0"], ctx["images"], ctx["poses"],
                                                 draws=ctx["draws"])
    launches = read_counts()
    return dict(metrics={k: float(v) for k, v in metrics.items()}, step_loss=float(step_metrics["loss"]),
                grads=[g.float().cpu() for g in grads], launches=launches, shapes=read_shapes(),
                grid=ctx["grid"].cpu(), threshold=ctx["occ"].threshold, step_grid=step_grid.cpu(),
                params=[p.detach().cpu() for p in train.parameter_list(state.params)])


def bricked_single(dev) -> dict:
    """The single-process side of the bricked DP step, on its grid: the
    kernel path's ``(loss, gradients)`` of each half, and the plain
    version's (the hash encodes' plain versions, the field's own bf16 MLPs)
    of the whole batch and of each half; then kernels 4-5 on what a rank
    gives them, against their plain versions as kernel_hash holds them
    (:func:`hash_verdict`), with the step's table and seeded random
    cotangents: each rank's half of the sweep's cells (131,072 of 64^3)
    and each half's pruned points (2048 x 128)."""
    from torch_nerf_tpu_torch import occupancy  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    ctx = bricked_setup(None, dev)
    plain = ngp_field("bricked", use_kernel=False)

    def host(result):
        metrics, grads = result
        return float(metrics["loss"]), [g.float().cpu() for g in grads]

    parts = halves(ctx["rays"])
    out = dict(kernel_halves=[host(bricked_grads(ctx, ctx["field"], h)) for h in parts],
               plain_whole=host(bricked_grads(ctx, plain, ctx["rays"])),
               plain_halves=[host(bricked_grads(ctx, plain, h)) for h in parts])
    _, _, fwd_ref, bwd_ref = hash_ops("bricked")
    tables = ctx["state"].params["coarse"]["tables"].detach()
    res = ngp_resolutions(dev)
    gen = torch.Generator(device=dev).manual_seed(34)
    cells = occupancy.sweep_points(ctx["draws"].occ_jitter, ctx["occ"])
    share = cells.shape[0] // 2
    points = {}
    for h, (o, d, _, uni) in enumerate(parts):
        t = sampling.stratified_t_samples_from_uniforms(uni.coarse, ctx["settings"].t_near, ctx["settings"].t_far)
        t_sel, _ = occupancy.prune_t_samples(ctx["grid"], ctx["occ"], o, d, t, 0, keep=ctx["occ"].keep_samples)
        points[f"half{h}/sweep_cells"] = cells[h * share:(h + 1) * share].contiguous()
        points[f"half{h}/pruned"] = ray_points(o, d, t_sel)[0]
    verdicts, errs = {}, {"hash_brick_fwd": 0.0, "hash_brick_bwd": 0.0}
    for case, pts in points.items():
        g = torch.randn((pts.shape[0], 32), generator=gen, device=dev)
        v = hash_verdict("bricked", tables, pts, res, g, fwd_ref(tables, pts, res),
                         bwd_ref(g, pts, res, *table_args(tables)))
        verdicts[case] = dict(points=pts.shape[0], err=v["err"], limit=v["limit"], ok=v["ok"])
        errs["hash_brick_fwd"] = max(errs["hash_brick_fwd"], v["err"]["fwd_max_abs"])
        errs["hash_brick_bwd"] = max(errs["hash_brick_bwd"], v["err"]["grad_max_abs"])
    shapes = {"hash_brick_fwd": {p.shape[0] for p in points.values()},
              "hash_brick_bwd": {p.shape[0] for p in points.values()}}
    return dict(out, kernels=verdicts, shapes=shapes, errs=errs)


def to_host(tree):
    """A parameter tree's leaves copied to the host, requiring grad."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().requires_grad_(True)


def tp_grads(mesh, dev, dtype=torch.float32, host: bool = False, rays: int = TP_RAYS) -> dict:
    """The generic step's loss and whole gradients at width 256 on
    ``rays`` rays: through the TP field on ``mesh`` (its slices' grads
    averaged over the data group and gathered over the model group), or,
    with ``mesh`` None, through the replicated plain field, on the card or
    (``host``) on the same inputs copied to the host CPU."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import collectives, mesh as pmesh, steps as psteps  # noqa: PLC0415
    from torch_nerf_tpu_torch.renderer import RayUniforms  # noqa: PLC0415

    inputs = classic_inputs(dev, rays)
    if mesh is None:
        field = make_nerf_field(**FULL, compute_dtype=dtype, use_kernel=False)
        params = classic_state(field, dev).params
        if host:
            o, d, gt, rand = inputs
            inputs = (o.cpu(), d.cpu(), gt.cpu(), RayUniforms(*(u.cpu() for u in rand)))
            params = to_host(params)
        metrics, grads = ray_grads(field, params, inputs)
        return dict(loss=metrics["loss"], grads=grads)
    field = make_nerf_field(**FULL, compute_dtype=dtype)
    whole = classic_state(field, dev)
    dims = train.parameter_list(pmesh.nerf_param_spec(whole.params, mesh.model_size))
    state = pmesh.place_state(mesh, whole, train.OptimConfig())
    shapes = [list(p.shape) for p in train.parameter_list(state.params)]
    metrics, grads = ray_grads(psteps.step_field(field, mesh), state.params, inputs, mesh, force_generic=True)
    grads = [g if dim is None else collectives.all_gather(g, mesh.model_group, dim) for g, dim in zip(grads, dims)]
    return dict(loss=metrics["loss"], grads=grads, shapes=shapes,
                whole_shapes=[list(p.shape) for p in train.parameter_list(whole.params)], dims=dims)


def frame_inputs(dev):
    """An 800x800 frame's field, He-scaled seeded params, camera and pose."""
    from torch_nerf_tpu_torch import cameras  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415

    field = make_nerf_field(compute_dtype=torch.bfloat16)
    params = {"coarse": he_scaled(_seeded_params(3, dev)), "fine": he_scaled(_seeded_params(4, dev))}
    pose = torch.as_tensor(synthetic.split_poses(8, "test")[0], device=dev)
    return field, params, cameras.CameraParams(960.0, 960.0, 800, 800), pose


def render_frame(mesh, dev) -> dict:
    """The 800x800 frame by ``render_image`` (``mesh`` None) or sharded over
    ``mesh``, kernel 1's launches counted over it."""
    from torch_nerf_tpu_torch.parallel.steps import make_sharded_render  # noqa: PLC0415
    from torch_nerf_tpu_torch.renderer import render_image  # noqa: PLC0415

    field, params, camera, pose = frame_inputs(dev)
    reset_counts()
    t0 = time.perf_counter()
    if mesh is None:
        frame = render_image(field, params["coarse"], params["fine"], camera, pose, 0, classic_settings(), 4096)
    else:
        frame = make_sharded_render(field, classic_settings(), mesh, camera, 4096)(params["coarse"],
                                                                                 params["fine"], pose, 0)
    launches = read_counts()
    return dict(frame=frame.cpu(), launches=launches, seconds=time.perf_counter() - t0)


def composite_inputs(dev):
    """(sigma, radiance, delta) of 4096 rays x 192 samples, sorted depths in
    [2, 6] with the 1e8 tail."""
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(31)
    sigma = 3.0 * torch.rand((4096, 192), generator=gen, device=dev)
    radiance = torch.rand((4096, 192, 3), generator=gen, device=dev)
    t = torch.sort(2.0 + 4.0 * torch.rand((4096, 192), generator=gen, device=dev), dim=-1).values
    return sigma, radiance, sampling.t_deltas(t)


def time_ms(fn, iters: int = 10) -> float:
    """Host ms of ``fn`` after two warm-up calls, each call synchronised."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def grad_buffers(dev) -> dict:
    """Flat f32 buffers of the classic model's and the bricked model's
    gradients (every leaf of both networks, or of the one NGP network)."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(0)
    classic = 2 * sum(p.numel() for p in train.parameter_list(make_nerf_field().init(gen, dev)))
    bricked = sum(p.numel() for p in train.parameter_list(ngp_field("bricked").init(gen, dev)))
    return {"classic": torch.ones(classic, device=dev), "bricked": torch.ones(bricked, device=dev)}


def dp_bench(mesh, dev) -> dict:
    """The 2-rank DP fused image step at bench.py's train point (3 warm-up
    steps, 10 timed, host clock), and the data group's all_reduce of the
    classic and the bricked gradients."""
    from torch_nerf_tpu_torch import train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.fields import make_nerf_field  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import collectives, mesh as pmesh, steps as psteps  # noqa: PLC0415

    images, poses, camera, _ = synthetic.make_dataset(num_views=8, img_size=400, device=dev)
    images, poses = torch.as_tensor(images, device=dev), torch.as_tensor(poses, device=dev)
    field = make_nerf_field(compute_dtype=torch.bfloat16)
    optim = train.OptimConfig()
    state = pmesh.place_state(mesh, classic_state(field, dev), optim)
    step = psteps.make_sharded_image_train_step(field, classic_settings(), optim, camera, mesh, DP_RAYS)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        state, _ = step(state, images, poses, gen)
    torch.cuda.synchronize()
    reset_counts()
    timed, t0 = 10, time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, images, poses, gen)
    float(metrics["loss"])
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    buffers = grad_buffers(dev)
    allreduce = {k: time_ms(lambda b=b: collectives.all_reduce(b, mesh.data_group)) for k, b in buffers.items()}
    return dict(ms_per_step=elapsed / timed * 1e3, timed_steps=timed, launches=launches,
                allreduce_ms=allreduce, allreduce_bytes={k: 4 * b.numel() for k, b in buffers.items()})


def par_rank(rank, world, init_method):
    """The 2-rank checks, both ranks on cuda:0 over gloo: the DP steps
    (fused, generic, bricked with occupancy), TP over 2, the sharded frame,
    the sample-axis composite, then the DP bench."""
    from torch_nerf_tpu_torch.parallel import mesh as pmesh, sample_axis  # noqa: PLC0415

    par_flags()
    mesh = pmesh.init_mesh(rank, world, init_method, backend="gloo", device="cuda", timeout=PAR_TIMEOUT)
    dev = mesh.device
    out = {"device": str(dev), "backend": mesh.backend,
           "fused": classic_dp(mesh, False, dev), "generic": classic_dp(mesh, True, dev),
           "bricked": bricked_dp(mesh, dev)}
    tp_mesh = pmesh.make_mesh(dev, model_size=2, timeout=PAR_TIMEOUT)
    out["tp"] = tp_grads(tp_mesh, dev)
    # what the TP check would cost at the DP steps' batch: one TP gradient
    # at 4096 rays, timed, compared with nothing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp_grads(tp_mesh, dev, rays=DP_RAYS)
    out["tp_full_batch_seconds"] = time.perf_counter() - t0
    out["render"] = render_frame(mesh, dev)
    rgb, weights = sample_axis.make_sample_sharded_composite(mesh.data_group)(*composite_inputs(dev))
    out["sample"] = (rgb.cpu(), weights.cpu())
    out["bench"] = dp_bench(mesh, dev)
    return out


def nccl_rank(rank, world, init_method):
    """One NCCL rank: the fused DP step, and NCCL's all_reduce of the
    classic and bricked gradients (called directly: the DP mean skips a
    group of one)."""
    import torch.distributed as dist  # noqa: PLC0415

    from torch_nerf_tpu_torch.parallel import mesh as pmesh  # noqa: PLC0415

    par_flags()
    mesh = pmesh.init_mesh(rank, world, init_method, backend="nccl", device="cuda", timeout=PAR_TIMEOUT)
    fused = classic_dp(mesh, False, mesh.device)
    buffers = grad_buffers(mesh.device)
    allreduce = {k: time_ms(lambda b=b: dist.all_reduce(b, group=mesh.data_group)) for k, b in buffers.items()}
    return dict(backend=mesh.backend, fused=fused, allreduce_ms=allreduce)


def dptp_rank(rank, world, init_method):
    """DP x TP 2 x 2 on four ranks that share cuda:0 over gloo."""
    from torch_nerf_tpu_torch.parallel import mesh as pmesh  # noqa: PLC0415

    par_flags()
    mesh = pmesh.init_mesh(rank, world, init_method, data_size=2, model_size=2, backend="gloo", device="cuda",
                           timeout=PAR_TIMEOUT)
    return tp_grads(mesh, mesh.device)


def list_rel_l2(got, ref) -> list:
    return [(a.float() - b.float()).norm().item() / max(b.float().norm().item(), 1e-30) for a, b in zip(got, ref)]


def halves_mean(parts) -> list:
    """The mean of two halves' gradients, as the DP mean forms it."""
    return [(a + b) / 2 for a, b in zip(parts[0][1], parts[1][1])]


def params_equal_on_ranks(ranks: list, key: str) -> bool:
    return all(torch.equal(a, b) for r in ranks[1:] for a, b in zip(ranks[0][key]["params"], r[key]["params"]))


def shapes_checked(launched: dict, checked: dict) -> bool:
    """Whether every shape that a path gave a kernel was checked against
    the kernel's plain version."""
    def key(shape):
        return tuple(shape) if isinstance(shape, (list, tuple)) else shape

    return all({key(s) for s in shapes} <= checked.get(name, set()) for name, shapes in launched.items())


def classic_verdict(got: dict, kernel_halves: list, f32: tuple, bf16: tuple, ranks: list, key: str) -> dict:
    """A classic DP step (rank 0's ``got``) against the single process. Its
    averaged gradients equal, bit for bit, the mean of the kernel path's
    gradients of the two halves in one process (kernels 2-3 are
    deterministic: the sharding, the draws and the all_reduce add nothing).
    Its loss and each of its 44 gradient leaves, against the plain f32
    version's on the whole batch, by relative error: each within 2x the
    plain bf16 version's own + 1e-3, kernel_train's rule (:func:`judge`).
    The same params on every rank after the step."""
    vs_halves = max_abs_diff(got["grads"], halves_mean(kernel_halves))
    err = {f"grad_{i}": e for i, e in enumerate(list_rel_l2(got["grads"], f32[1]))}
    scale = {f"grad_{i}": e for i, e in enumerate(list_rel_l2(bf16[1], f32[1]))}
    err["loss"] = abs(got["metrics"]["loss"] - f32[0]) / abs(f32[0])
    scale["loss"] = abs(bf16[0] - f32[0]) / abs(f32[0])
    vs_plain = judge(err, scale)
    same = params_equal_on_ranks(ranks, key)
    return dict(grad_max_abs_vs_halves_mean=vs_halves, vs_plain_f32_whole_batch=vs_plain,
                loss_rel_err_vs_plain_f32=err["loss"], params_equal_on_ranks=same,
                ok=vs_halves == 0.0 and vs_plain["ok"] and same)


def bricked_verdict(got: dict, single: dict, ranks: list) -> dict:
    """The bricked DP step (rank 0's ``got``) against the single process.
    Its averaged gradients against the mean of the kernel path's gradients
    of the two halves in one process: each leaf within relative L2 1e-5
    (kernel 5 adds by f32 atomics; kernel_hash's limit). Its loss and
    gradients against the plain version's on the whole batch: the largest
    leaf's relative L2 within 2x the plain version's own split-versus-whole
    difference (the mean of its two halves' gradients against its whole
    batch's: the bf16 MLPs' weight gradients round otherwise) + 1e-6; the
    loss within 2x that difference's + 1e-5. The same params on every
    rank."""
    whole_loss, whole = single["plain_whole"]
    plain_mean = halves_mean(single["plain_halves"])
    split = max(list_rel_l2(plain_mean, whole))
    split_loss = abs(sum(p[0] for p in single["plain_halves"]) / 2 - whole_loss) / abs(whole_loss)
    vs_halves = max(list_rel_l2(got["grads"], halves_mean(single["kernel_halves"])))
    grad_err = max(list_rel_l2(got["grads"], whole))
    loss_err = abs(got["metrics"]["loss"] - whole_loss) / abs(whole_loss)
    limits = {"vs_halves": 1e-5, "grad": 2.0 * split + 1e-6, "loss": 2.0 * split_loss + 1e-5}
    same = params_equal_on_ranks(ranks, "bricked")
    return dict(grad_max_rel_l2_vs_halves_mean=vs_halves, grad_max_rel_l2_vs_plain_whole_batch=grad_err,
                loss_rel_err_vs_plain_whole_batch=loss_err,
                plain_split_vs_whole={"grad_max_rel_l2": split, "loss_rel": split_loss}, limits=limits,
                params_equal_on_ranks=same,
                ok=(vs_halves <= limits["vs_halves"] and grad_err <= limits["grad"] and loss_err <= limits["loss"]
                    and same))


def phase_parallel(smi: str, work: Path) -> dict:
    """dp_step, tp_step, dp_render and train_bench_dp: the single-process
    references here, then one launch of 2 gloo ranks on cuda:0
    (:func:`par_rank`), one NCCL rank (:func:`nccl_rank`) and 4 gloo ranks
    (:func:`dptp_rank`)."""
    from torch_nerf_tpu_torch.ops import integration  # noqa: PLC0415
    from torch_nerf_tpu_torch.parallel import launch  # noqa: PLC0415

    dev = torch.device("cuda")
    classic = {"f32": classic_grads(dev, "f32"), "bf16": classic_grads(dev, "bf16"),
               "fused": classic_grads(dev, "kernel", split=True),
               "generic": classic_grads(dev, "kernel", force_generic=True, split=True)}
    classic_kernels, classic_shapes, classic_errs = classic_half_kernels(dev)
    bricked = bricked_single(dev)
    single = {"fused": classic_dp(None, False, dev), "generic": classic_dp(None, True, dev),
              "bricked": bricked_dp(None, dev)}
    tp_ref = tp_grads(None, dev)
    tp_host = tp_grads(None, dev, host=True)
    frame = render_frame(None, dev)
    comp_ref = [x.cpu() for x in integration.composite(*composite_inputs(dev))]
    torch.cuda.empty_cache()
    spawn_dir = work / "ranks"
    t0 = time.perf_counter()
    ranks = launch.spawn(par_rank, 2, spawn_dir, timeout=PAR_TIMEOUT)
    nccl = launch.spawn(nccl_rank, 1, spawn_dir, timeout=PAR_TIMEOUT)[0]
    dptp = launch.spawn(dptp_rank, 4, spawn_dir, timeout=PAR_TIMEOUT)
    spawn_s = time.perf_counter() - t0

    # dp_step
    cases = {key: classic_verdict(ranks[0][key], classic[key], classic["f32"], classic["bf16"], ranks, key)
             for key in ("fused", "generic")}
    cases["bricked"] = bricked_verdict(ranks[0]["bricked"], bricked, ranks)
    checked = {**{k: classic_shapes[k] for k in ("fused_train_pass", "fused_nerf_fwd", "fused_nerf_bwd")},
               **bricked["shapes"]}
    for key, case in cases.items():
        case.update(launches_per_rank=[r[key]["launches"] for r in ranks],
                    shapes_per_rank=[r[key]["shapes"] for r in ranks],
                    single_process_launches=single[key]["launches"],
                    every_shape_checked=all(shapes_checked(r[key]["shapes"], checked) for r in ranks))
    kernels_ok = (all(v["ok"] for h in classic_kernels.values() for v in h.values())
                  and all(v["ok"] for v in bricked["kernels"].values()))
    grid = single["bricked"]["grid"]
    grids = {"sweep_vs_single": max((r["bricked"]["grid"] - grid).abs().max().item() for r in ranks),
             "step_vs_sweep": max((r["bricked"]["step_grid"] - r["bricked"]["grid"]).abs().max().item()
                                  for r in ranks),
             "threshold": single["bricked"]["threshold"],
             "occupied_share": (grid > single["bricked"]["threshold"]).float().mean().item()}
    want = {"fused": {"fused_train_pass": 2}, "generic": {"fused_nerf_fwd": 2, "fused_nerf_bwd": 2},
            "bricked": {"hash_brick_fwd": 2, "hash_brick_bwd": 1}}
    launches_ok = all(r[k]["launches"] == want[k] and single[k]["launches"] == want[k] for r in ranks for k in want)
    nccl_equal = (nccl["fused"]["step_loss"] == single["fused"]["step_loss"]
                  and all(torch.equal(a, b) for a, b in zip(nccl["fused"]["params"], single["fused"]["params"])))
    ok = (all(c["ok"] and c["every_shape_checked"] for c in cases.values()) and kernels_ok
          and grids["sweep_vs_single"] == 0.0 and grids["step_vs_sweep"] == 0.0
          and 0.0 < grids["occupied_share"] < 1.0
          and launches_ok and nccl_equal and nccl["fused"]["launches"] == want["fused"]
          and all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks) and nccl["backend"] == "nccl")
    failed = [] if ok else ["dp_step"]
    emit("dp_step", ranks=2, backend="gloo, both ranks on cuda:0", cases=cases,
         kernels_on_rank_shards={"classic": classic_kernels, "bricked": bricked["kernels"], "ok": kernels_ok},
         shapes_checked={k: sorted(v) for k, v in checked.items()}, grid=grids,
         expected_launches_per_rank=want, nccl_one_rank={"bit_equal_to_single_process": nccl_equal,
                                                          "launches": nccl["fused"]["launches"]},
         rule="kernels 1-5 on each rank's shard (the halves of the batch, the rank's sweep cells) as kernel, "
              "kernel_bwd, kernel_train and kernel_hash hold them, at every shape the ranks launched; classic: "
              "the DP gradients bit-equal to the mean of the halves' in one process, loss and each gradient "
              "leaf against the plain f32 whole batch within 2x the plain bf16 version's error + 1e-3; bricked: "
              "against the halves' mean within relative L2 1e-5, against the plain whole batch within 2x the "
              "plain version's split-versus-whole difference + 1e-6 (loss + 1e-5)",
         spawn_seconds=spawn_s, ok=ok)

    # tp_step: f32 sums in another order flip relus near 0 and move a
    # leaf whose sum cancels, so the scale is the replicated step's own
    # card-against-host difference (two f32 orders of the same step)
    host_err = list_rel_l2(tp_host["grads"], tp_ref["grads"])
    limit = 2.0 * max(host_err) + 1e-6
    tp = {}
    for name, results in (("tp_2", ranks[0]["tp"]), ("dp2_x_tp2", dptp[0])):
        errs = list_rel_l2(results["grads"], tp_ref["grads"])
        loss_err = abs(results["loss"] - tp_ref["loss"]) / abs(tp_ref["loss"])
        shapes_ok = all(s == [w // 2 if i == d else w for i, w in enumerate(full)] if d is not None else s == full
                        for s, full, d in zip(results["shapes"], results["whole_shapes"], results["dims"]))
        worst = max(range(len(errs)), key=errs.__getitem__)
        tp[name] = dict(grad_max_rel_l2=errs[worst], worst_leaf=worst, grad_limit=limit, loss_rel_err=loss_err,
                        sliced_shapes_ok=shapes_ok, sharded_leaves=sum(d is not None for d in results["dims"]),
                        ok=errs[worst] <= limit and loss_err <= 1e-5 and shapes_ok)
    ok = all(v["ok"] for v in tp.values())
    if not ok:
        failed.append("tp_step")
    emit("tp_step", rays=TP_RAYS, width=FULL["feat_dim"], dtype="float32", reference="the replicated plain step",
         rule="grads' relative L2 (each leaf's, the largest) <= 2x the replicated step's own card-against-host "
              "difference + 1e-6, loss within 1e-5 relative",
         replicated_card_vs_host={"grad_max_rel_l2": max(host_err),
                                  "worst_leaf": max(range(len(host_err)), key=host_err.__getitem__),
                                  "loss_rel": abs(tp_host["loss"] - tp_ref["loss"]) / abs(tp_ref["loss"])},
         cases=tp, tp_2_seconds_at_4096_rays=[r["tp_full_batch_seconds"] for r in ranks], ok=ok)

    # dp_render
    frame_err = max((r["render"]["frame"] - frame["frame"]).abs().max().item() for r in ranks)
    rgb, weights = ranks[0]["sample"]
    comp = {"rgb_max_abs": (rgb - comp_ref[0]).abs().max().item(),
            "weights_max_abs": (weights - comp_ref[1]).abs().max().item()}
    comp_ok = (torch.allclose(rgb, comp_ref[0], rtol=1e-5, atol=1e-6)
               and torch.allclose(weights, comp_ref[1], rtol=1e-5, atol=1e-6))
    want_k1 = {"fused_nerf_fwd": 2 * -(-800 * 800 // 4096)}
    ok = (frame_err == 0.0 and comp_ok and frame["launches"] == want_k1
          and all(r["render"]["launches"] == want_k1 for r in ranks))
    if not ok:
        failed.append("dp_render")
    emit("dp_render", frame=[800, 800], max_abs_vs_render_image=frame_err,
         launches_per_rank=[r["render"]["launches"] for r in ranks], single_process_launches=frame["launches"],
         seconds_per_rank=[r["render"]["seconds"] for r in ranks], single_process_seconds=frame["seconds"],
         sample_axis_composite=dict(rays=4096, samples=192, ranks=2, **comp, rule="rtol 1e-5, atol 1e-6",
                                    ok=comp_ok), ok=ok)

    bench = ranks[0]["bench"]
    ok = bench["launches"] == {"fused_train_pass": 2 * bench["timed_steps"]}
    emit("train_bench_dp", card=smi, note="2 ranks sharing one card over host-staged gloo: not a scaling number",
         dp_fused_ms_per_step=bench["ms_per_step"], timed_steps=bench["timed_steps"], launches=bench["launches"],
         gloo_allreduce_ms=bench["allreduce_ms"], nccl_one_rank_allreduce_ms=nccl["allreduce_ms"],
         allreduce_bytes=bench["allreduce_bytes"], ok=ok)
    if not ok:
        failed.append("train_bench_dp")
    if failed:
        raise SystemExit(f"chip_smoke: {', '.join(failed)} phase failed")
    dp_launches = {name: sum(c["launches_per_rank"][0].get(name, 0) for c in cases.values())
                   for name in kernel_wrappers()}
    return {"dp_step": {name: n for name, n in dp_launches.items() if n},
            "dp_step_errs": {**classic_errs, **bricked["errs"]},
            "dp_render": ranks[0]["render"]["launches"]}


def run_torchrun(argv, nproc: int, timeout: float = PAR_TIMEOUT) -> str:
    """``torchrun --standalone --nproc_per_node=nproc argv`` from the
    checkout's root, its whole process group killed at ``timeout``; raises
    unless it exits 0. Returns its stdout."""
    import os  # noqa: PLC0415
    import signal  # noqa: PLC0415
    import subprocess  # noqa: PLC0415

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"] + argv
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"chip_smoke: torchrun {argv[:3]} outlasted {timeout} s")
    if proc.returncode != 0:
        emit("torchrun", argv=argv, rc=proc.returncode, stdout=out[-3000:], stderr=err[-6000:], ok=False)
        raise SystemExit(f"chip_smoke: torchrun {argv[:3]} exited {proc.returncode}")
    return out


def cli_rank(module: str, prefix: str, argv) -> int:
    """One rank of a torchrun launch of ``runners.<module>.main(argv)``,
    every kernel's launches counted over it and written to
    ``<prefix>.rank<RANK>.json``."""
    import importlib  # noqa: PLC0415
    import os  # noqa: PLC0415

    main_fn = importlib.import_module(f"torch_nerf_tpu_torch.runners.{module}").main
    reset_counts()
    main_fn(argv)
    Path(f"{prefix}.rank{os.environ['RANK']}.json").write_text(json.dumps(read_counts()))
    return 0


def torchrun_cli(work: Path, name: str, module: str, argv, nproc: int = 2):
    """``runners.<module>`` on ``nproc`` gloo ranks through
    :func:`cli_rank`: ``(stdout, [each rank's launches])``."""
    prefix = work / f"{name}.launches"
    out = run_torchrun([str(Path(__file__).resolve()), "--cli-rank", module, str(prefix), *argv], nproc)
    return out, [json.loads(Path(f"{prefix}.rank{r}.json").read_text()) for r in range(nproc)]


def phase_train_dp(work: Path) -> dict:
    """The CLIs on 2 gloo ranks that share cuda:0 (torchrun): ``run_train
    --distributed`` of the default classic config at full width (24 steps
    with a validation and a visualisation rendered sharded, a resume for
    8), the DP checkpoint resumed by a single-process ``run_train`` for 8
    more (the reshard), ``run_render --distributed`` of two 800x800 test
    views equal to the single-process ``run_render``'s, ``evaluate``; then
    2 scenes over the 2 ranks, 24 steps and a resume for 8. Launches per
    rank: kernel 3 twice a step, kernel 1 twice a 4096-ray chunk."""
    from torch_nerf_tpu_torch import config, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    overrides = ["data.dataset_type=gaussian_blobs", "data.img_size=400",
                 "train_params.validation.validate_every=3", "train_params.validation.num_batch=1",
                 "train_params.log.epoch_btw_ckpt=3", "train_params.log.epoch_btw_vis=3"]
    dist = ["--distributed", "--dist-backend", "gloo"]
    run, out_dp, out_one, gt = (work / n for n in ("dp_run", "dp_render", "dp_render_one", "dp_gt"))
    t0 = time.perf_counter()
    logs, launches = [], []
    for max_steps in (24, 32):
        log, counts = torchrun_cli(work, f"dp_train{max_steps}", "run_train",
                                   dist + ["--config", "default", "--log-dir", str(run), "--max-steps",
                                           str(max_steps)] + overrides)
        logs.append(log)
        launches.append(counts)
    resumed, resumed_log, resumed_k3, _ = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", "40"],
                                                  [ftm.fused_train_pass])
    render_log, render_launches = torchrun_cli(work, "dp_render", "run_render",
                                               dist + ["--log-dir", str(run), "--render-test-views",
                                                       "--num-views", "2", "--out-dir", str(out_dp)])
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "2", "--out-dir",
                         str(out_one)])
    single_render = read_counts()
    cfg = config.load_config(run / "config.yaml")
    data = session.build_dataset(cfg, "test", device=torch.device("cuda"))
    gt.mkdir(parents=True)
    for i in range(2):
        save_png(gt / f"{i:04d}.png", data.images[i])
    scores = evaluate.main([str(out_dp), str(gt)])
    png_diff = max(float(abs(load_png(out_dp / f"{i:04d}.png") - load_png(out_one / f"{i:04d}.png")).max())
                   for i in range(2))
    classic_s = time.perf_counter() - t0

    multi = work / "dp_multi_run"
    multi_logs, multi_launches = [], []
    for max_steps in (24, 32):
        log, counts = torchrun_cli(work, f"dp_multi{max_steps}", "run_train",
                                   dist + ["--config", "default", "--log-dir", str(multi), "--max-steps",
                                           str(max_steps)] + MULTI_OVERRIDES)
        multi_logs.append(log)
        multi_launches.append(counts)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    want = {"train": [{"fused_train_pass": 48, "fused_nerf_fwd": 2 * (chunks_800 + chunks_400)},
                      {"fused_train_pass": 16}],
            "render": {"fused_nerf_fwd": 2 * 2 * chunks_800},
            # one scene a rank; each rank validates its scene's 800x800 view at step 24
            "multi": [{"fused_train_pass": 48, "fused_nerf_fwd": 2 * chunks_800}, {"fused_train_pass": 16}]}
    val = [ln for log in logs for ln in log.splitlines() if ln.startswith("validation @")]
    multi_val = [ln for log in multi_logs for ln in log.splitlines() if ln.startswith("validation @")]
    ckpts = sorted(p.name for p in (run / "ckpt").glob("ckpt_*.pt"))
    ok = (all(c == want["train"][i] for i, counts in enumerate(launches) for c in counts)
          and "Data-parallel training over 2 ranks (gloo)." in logs[0] and "Resumed from step 24." in logs[1]
          and len(val) == 1 and "Resumed from step 32." in resumed_log and resumed["step"] == 40
          and resumed_k3 == [16] and all(c == want["render"] for c in render_launches)
          and single_render == want["render"] and png_diff == 0.0
          and all(math.isfinite(v) for v in scores.values())
          and ckpts == ["ckpt_000024.pt", "ckpt_000032.pt", "ckpt_000040.pt"]
          and all(c == want["multi"][i] for i, counts in enumerate(multi_launches) for c in counts)
          and "Training 2 scenes over 2 ranks (gloo)." in multi_logs[0] and "Resumed from step 24." in multi_logs[1]
          and len(multi_val) == 1 and "psnr_scene1=" in multi_val[0])
    emit("train_dp", ranks=2, backend="gloo, both ranks on cuda:0", classic_seconds=classic_s,
         launches_per_rank={"train": launches, "render": render_launches, "multi": multi_launches},
         expected_per_rank=want, single_process_resume={"step": resumed["step"], "kernel3": resumed_k3},
         single_process_render=single_render, png_max_abs_dp_vs_one=png_diff, validation=val,
         multi_validation=multi_val, checkpoints=ckpts, psnr_vs_gt=scores["psnr"], ssim_vs_gt=scores["ssim"],
         ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_dp phase failed")
    total = {}
    for counts in [c[0] for c in launches + multi_launches] + [render_launches[0]]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_dryrun() -> None:
    """``runners/dryrun_multichip.py`` on 4 gloo ranks that share cuda:0:
    DP x TP 2 x 2, the fused DP step, bricked NGP with occupancy, scenes
    over the ranks with the plain and the fused field."""
    t0 = time.perf_counter()
    out = run_torchrun(["-m", "torch_nerf_tpu_torch.runners.dryrun_multichip", "--dist-backend", "gloo"], 4)
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    checks = ("dp+tp", "fused_dp", "ngp_bricked_occ", "multiscene", "multiscene_fused")
    ok = len(line) == 1 and "mesh={'data': 2, 'model': 2}" in line[0] and all(f"{c}:loss=" in line[0]
                                                                               for c in checks)
    emit("dryrun", ranks=4, line=line, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: dryrun phase failed")


SECTOR = 32  # bytes: the least that the card's memory moves to or from L2


def forward_table_bytes(layout, tables, pts, res, off) -> int:
    """The bytes of ``tables`` that a forward at ``pts`` must read: the
    distinct 32-byte sectors that hold a site it blends, counted on this
    batch (a coarse level's points reach few of its rows). A brick row is
    16 sectors, one an (x, y) line of 4 z-sites x F = 2, and a point reads
    the 4 lines of its floor site's (x, y) and the next; a corner row is F
    floats, 8 rows at F = 2 to a sector; a packed row is F sectors."""
    from torch_nerf_tpu_torch.models.hash_math import packed_prep  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415

    num_level, t = tables.shape[0], tables.shape[1]
    first = (torch.arange(num_level, device=pts.device) * t)[:, None]  # each level's first row
    seen = torch.zeros(tables.numel() * 4 // SECTOR, dtype=torch.bool, device=pts.device)
    for a in range(0, pts.shape[0], hg.CHUNK):
        p = pts[a:a + hg.CHUNK]
        if layout == "bricked":
            row, _ = hg.brick_prep(p, res, t)
            v = torch.floor(res[:, None, None] * p[None])  # (L, m, 3), as brick_prep
            site = (v - float(hg.STRIDE) * torch.floor(v / float(hg.STRIDE))).long()
            line = (row + first) * 16 + site[..., 0] * hg.BRICK_EDGE + site[..., 1]
            for dxy in (0, 1, hg.BRICK_EDGE, hg.BRICK_EDGE + 1):
                seen[line + dxy] = True
        elif layout == "hash":
            row, _ = hg.corner_prep(p, res, t)  # rows of the flat (L*T, F) table
            seen[row * tables.shape[2] * 4 // SECTOR] = True
        else:
            f = NGP["table_feat_dim"]
            rows = hg.check_fold_layout(tables.shape, f)
            row, _ = packed_prep(p, res, rows, off)
            flat = row + (torch.arange(num_level, device=pts.device) * rows)[:, None]
            seen[(flat * f)[..., None] + torch.arange(f, device=pts.device)] = True
    return int(seen.sum()) * SECTOR


def bound_entry(ms, plain_ms, flops, nbytes, peak_flops, peak_bw, points) -> dict:
    """A kernel's time beside its bound: the larger of its operations over
    the peak for their type and its bytes (each input read once, each output written
    once) over the memory rate."""
    bound = max(flops / peak_flops, nbytes / peak_bw) * 1e3
    return dict(points=points, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations" if flops / peak_flops >= nbytes / peak_bw else "bytes",
                share_of_bound=bound / ms, tflops=flops / ms / 1e9, library_ms=None)


# what the kernels line says of the forwards' design; their earlier
# thread-per-(point, level) form's times are in PERF.md section 6
HASH_FWD_DESIGNS = {
    "hash_brick_fwd": "level-group-major walk, groups of a 32-byte output sector, lane = point, warp = level, "
                      "each run of two z-sites read as one float4 where the floor site's z is even, the tile "
                      "staged in shared memory; replaces the thread-per-(point, level) form",
    "hash_corner_fwd": "level-group-major walk, groups of a 32-byte output sector, lane = point, warp = level, "
                       "corner rows read as x-pairs, the tile staged in shared memory; replaces the "
                       "thread-per-(point, level) form",
    "hash_fold_fwd": "level-group-major walk, groups of 64 output bytes, lane = point, warp = level, the tile "
                     "staged in shared memory; replaces the thread-per-(point, level) form",
}


def kernel_lines(done: dict) -> list:
    """The ``kernels`` line: each kernel with its main-path launches, its
    largest max-abs error against the plain f32 version, and its time,
    the plain version's and its bound at the main path's largest shape
    (kernel 1: its launches over ``train``'s CLI calls, renders included,
    and serve's beside them; the hash kernels: their launches over ``train_ngp``'s CLI calls, their
    errors from kernel_hash, their times at the NGP train step's 2^20
    points; the fold kernels: their launches over ``train_packed``'s CLI
    calls, their errors from kernel_fold, their times on the ``packed``
    layout's tables); ``launches_by_path`` adds each kernel's launches over
    ``train_llff``'s, ``train_occ``'s and ``train_multi``'s CLI calls, and
    on the parallel paths, one rank's (of two that share the card):
    dp_step's three sharded steps, dp_render's frame and train_dp's CLI
    calls; kernels 1, 3, 4 and 5's errors include train_multi_step's, and
    kernels 1-5's dp_step's (on each rank's shard)."""
    lines = _kernel_entries(done)
    for entry in lines:
        # the launches of the LLFF + NDC, occupancy, multi-scene and
        # parallel paths, each counted over its own calls
        entry["launches_by_path"] = {path: done[path][entry["name"]]
                                     for path in ("train_llff", "train_occ", "train_multi", "dp_step",
                                                  "dp_render", "train_dp")
                                     if entry["name"] in done[path]}
        entry["max_abs_err"] = max(entry["max_abs_err"], done["train_multi_step"].get(entry["name"], 0.0),
                                   done["dp_step_errs"].get(entry["name"], 0.0))
    return lines


def general_entries(done: dict) -> list:
    """The general route's entries of the ``kernels`` line: kernels 1-3 on
    each route of :data:`GENERAL` (the tensor-core engine), with their
    launches over the route's CLI phase (kernel 2: over train_bench_general's
    force_generic steps), their largest max-abs error against the plain
    version one precision up at the main path's shapes (kernel 1:
    train_bench_general's chunk checks), and their times and bounds at the
    fine shape from train_bench_general; then kernels 1-3 on wgmma_general
    at each config of :data:`TC_TIMED` (1024: kernels 1 and 3 launched over
    train_1024's CLI calls) and on f32_wgmma at each config of
    :data:`F32_TIMED` (1024: kernels 1 and 3 over train_f32_1024's, the
    others over train_bench_general's checks and timings); after each
    route's kernels, its dW GEMM (launched inside kernels 2 and 3: its
    kernel's launches over the same calls as its libraries counted them,
    its error from dw_gemm, its time at the fine shape beside the cuBLAS
    yardstick)."""
    out = []
    sources = {"fused_nerf_fwd": ("fused_tc_fwd.cu", "fused_nerf.py:397"),
               "fused_nerf_bwd": ("fused_tc_bwd.cu", "fused_nerf.py:487"),
               "fused_train_pass": ("fused_tc_train.cu", "fused_train.py:196")}
    # the CLI phase that launched a width-1024 config's kernels 1 and 3
    cli_1024 = {"wgmma_general/1024": "train_1024", "f32_wgmma/1024": "train_f32_1024"}
    for route in (list(GENERAL) + [f"wgmma_general/{n}" for n in TC_TIMED]
                  + [f"f32_wgmma/{n}" for n in F32_TIMED]):
        bench = done["train_bench_general"][route]
        if route in GENERAL:
            path = done[GENERAL_PHASES[route]]
            launches = {"fused_nerf_fwd": path["fused_nerf_fwd"], "fused_train_pass": path["fused_train_pass"],
                        "fused_nerf_bwd": bench["generic_bwd_launches"]}
            errors = {"fused_nerf_fwd": bench["fwd_max_abs_err"],
                      "fused_nerf_bwd": done["kernel_bwd"]["general"][route],
                      "fused_train_pass": done["kernel_train"]["general"][route]}
            where = {name: GENERAL_PHASES[route] if name != "fused_nerf_bwd" else "train_bench_general"
                     for name in sources}
            config = GENERAL_OVERRIDES[route]
            dw_launches, dw_where = path["dw_gemm"], GENERAL_PHASES[route]
        else:
            on, name = route.split("/", 1)
            launches = {k: bench["route_launches"][k][on] for k in sources}
            where = dict.fromkeys(sources, "train_bench_general")
            if on == "wgmma_general":
                errors = {"fused_nerf_fwd": max(done["kernel"]["wide"][name], bench["fwd_max_abs_err"]),
                          "fused_nerf_bwd": done["kernel_bwd"]["general"][route],
                          "fused_train_pass": done["kernel_train"]["general"][route]}
            else:
                errors = dict(bench["max_abs_err"])
                errors["fused_nerf_fwd"] = max(errors["fused_nerf_fwd"], done["kernel"]["f32"][name])
            dw_launches, dw_where = bench["route_launches"]["dw_gemm"][on], "train_bench_general"
            if route in cli_1024:
                cli = done[cli_1024[route]]
                launches.update(fused_nerf_fwd=cli["fused_nerf_fwd"], fused_train_pass=cli["fused_train_pass"])
                where.update(fused_nerf_fwd=cli_1024[route], fused_train_pass=cli_1024[route])
                dw_launches, dw_where = cli["dw_gemm"], cli_1024[route]
            config = bench["config"]
        for name, (src, replaces) in sources.items():
            k = bench["kernels"][f"{name}/fine"]
            out.append({"name": f"{name}/{route}", "route": "cuda",
                        "source": f"torch_nerf_tpu_torch/ops/csrc/{src} + nerf_mlp_tc.cuh",
                        "replaces": f"torch_nerf_tpu/ops/pallas/{replaces}", "launches": launches[name],
                        "launches_path": where[name], "config": config, "max_abs_err": errors[name],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": None,
                        **({"stash_floor_ms": k["stash_floor_ms"]} if "stash_floor_ms" in k else {})})
        # the dW GEMM, inside kernels 2 and 3: its own launches, checks and times
        k = bench["kernels"]["dw_gemm/fine"]
        dw = done["kernel_bwd"]["general"]["dw_gemm"][route]
        out.append({"name": f"dw_gemm/{route}", "route": "cuda",
                    "source": "torch_nerf_tpu_torch/ops/csrc/nerf_dw_tc.cuh",
                    "replaces": "torch_nerf_tpu/ops/pallas/fused_nerf.py:414",
                    "launches": dw_launches, "launches_path": dw_where,
                    "config": config, "max_abs_err": dw["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                    "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                    "library": k["library"], "floor_ops_ms": k["floor_ops_ms"],
                    "floor_bytes_ms": k["floor_bytes_ms"], "fine_plan": dw["fine_plan"]})
    return out


def _kernel_entries(done: dict) -> list:
    shapes = done["bench"]
    fine = shapes["fine"]
    k1_err = max([done["kernel"]["wgmma"]] + [e for s in shapes.values()
                                     for k in ("max_abs_err", "he_max_abs_err") for e in s[k].values()])
    tb = done["train_bench"]["kernels"]
    k2, k3 = tb["fused_nerf_bwd/fine"], tb["fused_train_pass/fine"]
    return [
        {"name": "fused_nerf_fwd", "route": "cuda",
         "source": "torch_nerf_tpu_torch/ops/csrc/fused_nerf_fwd.cu",
         "replaces": "torch_nerf_tpu/ops/pallas/fused_nerf.py:397",
         "launches": done["train"]["fused_nerf_fwd"], "serve_launches": done["serve"],
         "max_abs_err": k1_err, "ms": fine["ms"], "plain_ms": fine["plain_ms"],
         "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"], "library_ms": None},
        {"name": "fused_nerf_bwd", "route": "cuda",
         "source": "torch_nerf_tpu_torch/ops/csrc/fused_nerf_bwd.cu",
         "replaces": "torch_nerf_tpu/ops/pallas/fused_nerf.py:487",
         "launches": done["train_bench"]["generic_bwd_launches"], "max_abs_err": done["kernel_bwd"]["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_train_pass", "route": "cuda",
         "source": "torch_nerf_tpu_torch/ops/csrc/fused_train.cu",
         "replaces": "torch_nerf_tpu/ops/pallas/fused_train.py:196", "launches": done["train"]["fused_train_pass"],
         "max_abs_err": done["kernel_train"]["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": "torch_nerf_tpu_torch/ops/csrc/hash_grid.cu",
         "replaces": replaces, "launches": done["train_ngp"][name],
         "max_abs_err": done["kernel_hash"][layout][part], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         **({"design": HASH_FWD_DESIGNS[name]} if name in HASH_FWD_DESIGNS else {})}
        for name, layout, part, replaces in (
            ("hash_brick_fwd", "bricked", "fwd", "torch_nerf_tpu/ops/pallas/hash_brick.py:228"),
            ("hash_brick_bwd", "bricked", "bwd", "torch_nerf_tpu/ops/pallas/hash_brick.py:361"),
            ("hash_corner_fwd", "hash", "fwd", "torch_nerf_tpu/ops/pallas/hash_corner.py:173"),
            ("hash_corner_bwd", "hash", "bwd", "torch_nerf_tpu/ops/pallas/hash_corner.py:249"),
        )
        for k in (done["train_bench_ngp"][f"{layout}/{part}"],)
    ] + [
        {"name": name, "route": "cuda", "source": "torch_nerf_tpu_torch/ops/csrc/hash_grid.cu",
         "replaces": replaces, "launches": done["train_packed"][name],
         "max_abs_err": max(v[part] for v in done["kernel_fold"].values()), "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
         "packed_dual": {key: dual[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         **({"design": HASH_FWD_DESIGNS[name]} if name in HASH_FWD_DESIGNS else {})}
        for name, part, replaces in (
            ("hash_fold_fwd", "fwd", "torch_nerf_tpu/ops/pallas/hash_fold.py:199"),
            ("hash_fold_bwd", "bwd", "torch_nerf_tpu/ops/pallas/hash_fold.py:283"),
        )
        for k, dual in ((done["train_bench_ngp"][f"packed/{part}"], done["train_bench_ngp"][f"packed_dual/{part}"]),)
    ] + [
        {"name": "ngp_mlp_fwd", "route": "cuda", "source": "torch_nerf_tpu_torch/ops/csrc/ngp_mlp_fwd.cu",
         "replaces": "none: the JAX package leaves the NGP field's MLPs to XLA",
         "launches": done["bench_ngp"]["hash"]["fused_launches_per_frame"], "launches_path": "bench_ngp, a frame",
         "max_abs_err": max(v["max_abs_vs_plain"]["rgb"] for v in done["ngp_fused"]["checks"].values()),
         **{key: k[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "packed_dual": {key: dual[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for k, dual in ((done["ngp_fused"]["kernels"]["cell/hash"], done["ngp_fused"]["kernels"]["cell/packed_dual"]),)
    ]


def main() -> int:
    import torch_nerf_tpu_torch  # noqa: F401, PLC0415

    smi = phase_device()
    # plain versions in full f32 / f32-accumulated bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build()
    work = Path(__file__).resolve().parent / "outputs" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    batch = train_batch(torch.device("cuda"))
    done = {
        "kernel": phase_kernel(),
        "kernel_bwd": phase_kernel_bwd(batch),
        "kernel_train": phase_kernel_train(batch),
        "kernel_hash": phase_kernel_hash(),
        "kernel_fold": phase_kernel_fold(),
        "serve": phase_serve(work),
        "train": phase_train(work),
        "train_f32": train_resume_render_routes(work, "f32_wgmma"),
        "train_wide": train_resume_render_routes(work, "wgmma_general"),
        "train_1024": phase_train_1024(work),
        "train_f32_1024": phase_train_1024(work, "train_f32_1024"),
        "train_bench": phase_train_bench(smi),
        "train_bench_general": phase_train_bench_general(smi),
        "bench": phase_bench(smi),
        "train_ngp": phase_train_ngp(work),
        "train_packed": phase_train_packed(work),
        "train_llff": phase_train_llff(work),
        "train_occ": phase_train_occ(work),
        "train_multi": phase_train_multi(work),
        "train_multi_step": phase_train_multi_step(),
        "train_bench_ngp": phase_train_bench_ngp(smi),
        "bench_ngp": phase_bench_ngp(smi),
        "ngp_fused": phase_ngp_fused(smi),
        "train_bench_multi": phase_train_bench_multi(smi),
    }
    done.update(phase_parallel(smi, work))
    done["train_dp"] = phase_train_dp(work)
    phase_dryrun()
    phase_lpips(work, done["train_multi"]["render_dir"], done["train_multi"]["gt_dir"])
    phase_profile(work)
    print(smi)
    print(json.dumps({"kernels": kernel_lines(done) + general_entries(done)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # one rank of train_dp's torchrun launches
        sys.exit(cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
