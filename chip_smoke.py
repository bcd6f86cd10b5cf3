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

Phases: device, build (one nvcc per source, all at once, sm_90a); kernel
(the field's forward at full width, ragged tail, PyTorch-default and
He-scaled weights, on its wgmma route at widths 256, 128 and 64 and its
mma.sync route at width 96, three trunk faults planted in the forward
images that the comparison must reject); kernel_bwd (the field's backward on 2^16 + 37 points and at the
train path's 4096 x 64 and 4096 x 192, every grad against the plain
version, three planted faults in the training kernels' weight images, a
second launch bit-identical); kernel_train (the fused train pass at
4096 x 64, 4096 x 192 and a ragged batch, rgb, weights and grads, planted
faults in the weight images and in the composite, a second launch
bit-identical);
serve (``run_render`` + ``evaluate`` on 128x128 test views, kernel launches
counted, the kernel's render held against the plain version's); train
(``run_train`` for 24 steps with a validation, a checkpoint and a
visualisation, a resume for 8 more, then ``run_render`` + ``evaluate``;
2 fused-pass launches per step, 2 forward launches per render chunk);
train_bench (train steps at ``bench.py``'s
operating point, fused and through autograd, each kernel timed beside its
bound and its plain version); bench (800x800 frames at ``bench.py
--render``'s operating point); kernel_hash (kernels 4-7, the bricked and
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
--model=instant_nerf``'s point, all four layouts); kernel_fold (kernels
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
"""

from __future__ import annotations

import contextlib
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    reports = build.build(["fused_nerf_fwd", "fused_nerf_bwd", "fused_train", "hash_grid"])
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


def width_cfg(feat: int = FULL["feat_dim"], dtype=torch.bfloat16):
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    return fn.FusedNeRFConfig(**dict(FULL, feat_dim=feat), compute_dtype=dtype)


def kernel_errors(params, pts, dirs, feat: int = FULL["feat_dim"]) -> dict:
    """One kernel launch against the plain version in f32 on the same
    bf16-rounded weights; the plain bf16 version's own error is the scale.
    ``ok`` when the kernel's max-abs error is within 2x that + 1e-3."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    cfg, cfg32 = width_cfg(feat), width_cfg(feat, torch.float32)
    public = params.public if isinstance(params, fn.KernelWeights) else params
    params_r = {n: {k: t.to(torch.bfloat16).float() for k, t in v.items()} for n, v in public.items()}
    before = fn.fused_nerf_apply.launches
    sigma, rgb = fn.fused_nerf_apply(params, pts, dirs, cfg)
    torch.cuda.synchronize()
    launched = fn.fused_nerf_apply.launches - before
    s32, c32 = fn.fused_nerf_apply_reference(params_r, pts, dirs, cfg32)
    sbf, cbf = fn.fused_nerf_apply_reference(public, pts, dirs, cfg)
    err = {"sigma": (sigma - s32).abs().max().item(), "rgb": (rgb - c32).abs().max().item()}
    scale = {"sigma": (sbf - s32).abs().max().item(), "rgb": (cbf - c32).abs().max().item()}
    ok = launched == 1 and all(math.isfinite(err[k]) and err[k] <= 2.0 * scale[k] + 1e-3 for k in err)
    return dict(points=pts.shape[0], feat_dim=feat, route=fn.forward_route(cfg), max_abs_err=err,
                plain_bf16_err=scale, tolerance="err <= 2 * plain_bf16_err + 1e-3",
                sigma_f32_max=s32.max().item(), sigma_positive_share=(s32 > 0).float().mean().item(),
                rgb_f32_std=c32.std().item(), launches=launched, ok=ok)


def compare_with_plain(params, pts, dirs, feat: int = FULL["feat_dim"]) -> dict:
    """:func:`kernel_errors`, raising unless ``ok``."""
    result = kernel_errors(params, pts, dirs, feat)
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


# (width, route) of every kernel-1 check: the wgmma route at the training
# widths, the mma.sync route at a width outside them
KERNEL1_WIDTHS = ((256, "wgmma"), (128, "wgmma"), (64, "wgmma"), (96, "mma_sync"))


def phase_kernel():
    """Kernel 1 vs its plain version on 2^17 + 37 points (a ragged tail),
    with seeded port-init weights and their He-scaled copy, at every
    width of :data:`KERNEL1_WIDTHS` (each on its route, the launch counted
    on it); then, at full width, three trunk faults planted in the forward
    images, which the check must reject with the He-scaled weights. The
    main path's chunk shapes are compared in the bench phase."""
    from torch_nerf_tpu_torch.models.nerf import init_nerf_params  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 2**17 + 37
    pts = torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0
    dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
    results, routes_ok = {}, True
    for feat, route in KERNEL1_WIDTHS:
        base = init_nerf_params(torch.Generator(device=dev).manual_seed(0), 63, 27, feat, device=dev)
        for wname, params in (("port_init", base), ("he", he_scaled(base))):
            before = dict(fn.fused_nerf_apply.route_launches)
            results[f"{feat}/{wname}"] = compare_with_plain(params, pts, dirs, feat)
            counted = {k: fn.fused_nerf_apply.route_launches[k] - before[k] for k in before}
            routes_ok = routes_ok and results[f"{feat}/{wname}"]["route"] == route and counted[route] == 1
    base = _seeded_params(0, dev)
    faults = {}
    for wname, params in (("port_init", base), ("he", he_scaled(base))):
        for fault, bad in planted_faults(fn.prepare(params, width_cfg()), params).items():
            r = kernel_errors(bad, pts, dirs)
            faults[f"{wname}/{fault}"] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
    ok = routes_ok and all(v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel", weights=results, routes_ok=routes_ok, planted_faults=faults,
         rule="each width on its route; every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel phase failed (a route, or a planted fault passed the comparison)")
    return max(e for r in results.values() for e in r["max_abs_err"].values())


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


def judge(err: dict, scale: dict) -> dict:
    """``ok`` when every relative L2 error is at most 2x the plain bf16
    version's own + 1e-3; the worst entry by its share of that limit."""
    limit = {k: 2.0 * scale[k] + 1e-3 for k in err}
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


def bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg) -> dict:
    """The plain backward over slices of 2^18 points (the whole of a fine
    pass in f32 would hold tens of GB): the grads summed, dpts and ddirs
    joined, by name."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    total, dps, dds = None, [], []
    for a in range(0, pts.shape[0], 2**18):
        sl = slice(a, a + 2**18)
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
                before = fn.fused_nerf_bwd.launches
                grads, dp, dd = fn.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg)
                torch.cuda.synchronize()
                got = named(grads, dpts=dp, ddirs=dd)
                if runs is not None:
                    runs.append(got)
                verdict = judge(rel_l2(got, ref32), scale)
                verdict["ok"] = verdict["ok"] and fn.fused_nerf_bwd.launches == before + 1
                verdict["max_abs_err"] = max((got[k] - ref32[k]).abs().max().item() for k in ref32)
                return verdict

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
    ok = all(r["ok"] for r in results.values()) and all(
        v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel_bwd", cases=results, planted_faults=faults,
         tolerance="rel L2 <= 2 * plain bf16 rel L2 + 1e-3, each of 22 grads, dpts, ddirs",
         rule="every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: kernel_bwd failed")
    return max_abs


def train_reference(params, o, d, t, delta, gt, cfg, num_real):
    """The plain train pass over ray slices of about 2^18 points, the
    grads summed: the whole batch in f32 would hold tens of GB."""
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415

    n, s = t.shape
    step = max(1, 2**18 // s)
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


def composite_errors(c, w, c32, w32, cbf, wbf, tail) -> dict:
    """rgb (N, 3) and weights (N, S) of a pass against the plain f32
    version's, each measure within 2x the plain bf16 version's own + 1e-3:
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
    limit = {k: 2.0 * scale[k] + 1e-3 for k in err}
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
    return max_abs


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
    ok = (launches == [48, 16] and [c["wgmma"] for c in k1] == want_k1 and all(c["mma_sync"] == 0 for c in k1)
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
    return {"fused_train_pass": sum(launches), "fused_nerf_fwd": sum(c["wgmma"] + c["mma_sync"] for c in k1)}


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


def train_resume_render(work: Path, name: str, train_args, counted) -> dict:
    """``run_train`` with ``train_args`` into ``work/<name>_run`` for 24
    steps (one validation, checkpoint and visualisation at 8 views), a
    resume for 8 more, then ``run_render`` + ``evaluate`` of two 800x800
    test views; the ``counted`` wrappers' launches over each CLI call."""
    from torch_nerf_tpu_torch import config, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    run, out, gt = work / f"{name}_run", work / f"{name}_render", work / f"{name}_gt"
    logs, results, launches, launch_shapes = [], [], [], []
    t0 = time.perf_counter()
    for max_steps in (24, 32):
        r, log, c, sh = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", str(max_steps)] + train_args,
                                counted)
        results.append(r)
        logs.append(log)
        launches.append(c)
        launch_shapes.append(sh)
    train_s = time.perf_counter() - t0
    _, _, render_launches, render_shapes = run_cli(run_render.main, [
        "--log-dir", str(run), "--render-test-views", "--num-views", "2", "--out-dir", str(out)], counted)
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
          and (run / "ckpt" / "ckpt_000032.pt").exists() and shapes == [[800, 800, 3]] * 2
          and all(math.isfinite(v) for v in scores.values()))
    return dict(ok=ok, seconds=train_s, results=results, launches=launches, render_launches=render_launches,
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
    other layout's kernels."""
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    counted = hash_ops("bricked")[:2] + hash_ops("hash")[:2]
    done = train_resume_render(work, "ngp", ["--config", "instant_nerf_tpu"] + NGP_TRAIN_OVERRIDES, counted)
    hash_result, _, hash_launches, _ = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "ngp_hash_run"), "--max-steps", "8"]
        + NGP_TRAIN_OVERRIDES, counted)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    # [brick fwd, brick bwd, corner fwd, corner bwd] per call
    want = [[24 + chunks_800 + chunks_400, 24, 0, 0], [8, 8, 0, 0]]
    want_render, want_hash = [2 * chunks_800, 0, 0, 0], [0, 0, 8, 8]
    launches, render_launches = done["launches"], done["render_launches"]
    ok = (done["ok"] and launches == want and render_launches == want_render and hash_launches == want_hash
          and len(hash_result["losses"]) == 8 and all(math.isfinite(v) for v in hash_result["losses"]))
    emit("train_ngp", seconds=done["seconds"], hash_steps=hash_result["step"],
         launches_brick_fwd_bwd_corner_fwd_bwd={"train": launches, "render": render_launches,
                                                 "hash_train": hash_launches},
         expected={"train": want, "render": want_render, "hash_train": want_hash},
         hash_losses=hash_result["losses"], **done["report"], ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: train_ngp phase failed")
    return {"hash_brick_fwd": launches[0][0] + launches[1][0] + render_launches[0],
            "hash_brick_bwd": launches[0][1] + launches[1][1],
            "hash_corner_fwd": hash_launches[2], "hash_corner_bwd": hash_launches[3]}


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
    kernel 4-7; the last step's ``aux_loss`` above 0."""
    from torch_nerf_tpu_torch.runners import run_train  # noqa: PLC0415

    counted = fold_ops() + hash_ops("bricked")[:2] + hash_ops("hash")[:2]
    done = train_resume_render(work, "packed", ["--config", "instant_nerf", "network.table_layout=packed"]
                               + SMOOTHNESS + NGP_TRAIN_OVERRIDES, counted)
    dual, _, dual_launches, _ = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "packed_dual_run"), "--max-steps", "8",
        "network.table_layout=packed_dual"] + SMOOTHNESS + NGP_TRAIN_OVERRIDES, counted)
    chunks_800, chunks_400 = -(-800 * 800 // 4096), -(-400 * 400 // 4096)
    want = [[2 * 24 + chunks_800 + chunks_400, 2 * 24, 0, 0, 0, 0], [2 * 8, 2 * 8, 0, 0, 0, 0]]
    want_render, want_dual = [2 * chunks_800, 0, 0, 0, 0, 0], [2 * 8, 2 * 8, 0, 0, 0, 0]
    launches, render_launches = done["launches"], done["render_launches"]
    aux = [r["metrics"].get("aux_loss", 0.0) for r in done["results"] + [dual]]
    ok = (done["ok"] and launches == want and render_launches == want_render and dual_launches == want_dual
          and len(dual["losses"]) == 8 and all(math.isfinite(v) for v in dual["losses"])
          and all(a > 0.0 for a in aux))
    emit("train_packed", seconds=done["seconds"], dual_steps=dual["step"],
         launches_fold_fwd_bwd_brick_fwd_bwd_corner_fwd_bwd={"train": launches, "render": render_launches,
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
    4096 x 128 points, kernel 4 (6) once a sweep."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import fused_train as ftm  # noqa: PLC0415
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
    counted = hash_ops("bricked")[:2] + hash_ops("hash")[:2]
    ngp = train_resume_render(work, "occ_ngp", ngp_args + NGP_TRAIN_OVERRIDES, counted)
    hash_result, _, hash_launches, hash_shapes = run_cli(run_train.main, [
        "--config", "instant_nerf", "--log-dir", str(work / "occ_hash_run"), "--max-steps", "8",
        "occupancy.keep_samples=128", f"occupancy.threshold={OCC_THRESHOLD['bricked']}"] + OCC_RUN
        + NGP_TRAIN_OVERRIDES, counted)

    renders = [2 * (chunks_800 + chunks_400), 0]
    want = {"classic": [[48, sweeps[0] + renders[0]], [16, sweeps[1]]],
            "classic_render": [0, 2 * 2 * chunks_800],
            "bricked": [[24 + sweeps[0] + renders[0] // 2, 24, 0, 0], [8 + sweeps[1], 8, 0, 0]],
            "bricked_render": [2 * chunks_800, 0, 0, 0], "hash": [0, 0, 8 + 2, 8]}
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
            "hash_corner_fwd": hash_launches[2], "hash_corner_bwd": hash_launches[3]}


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
    counted over the timed ones; then each hash kernel alone on the 2^20
    points of a dense batch of the step's own, with a seeded random
    cotangent (CUDA events), beside its bound, its share of it and its
    plain version's time."""
    from torch_nerf_tpu_torch import config, occupancy, renderer, session, train  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import hash_grid as hg  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415
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
        launch_count.reset(fwd, bwd)
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
                           launches={"fwd": fwd.launches, "bwd": bwd.launches},
                           expected_launches={"fwd": per_step * timed + (1 if occ else 0), "bwd": per_step * timed},
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
    launches a frame), every layout, seeded random weights: a warm-up and 2
    timed frames each."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415

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
        launch_count.reset(fwd)
        t0 = time.perf_counter()
        for i in range(frames):
            img = frame(2 + i)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        layouts[layout] = dict(seconds_per_frame=elapsed / frames, rays_per_sec=800 * 800 * frames / elapsed,
                               launches_per_frame=fwd.launches / frames, finite=bool(torch.isfinite(img).all()),
                               shape=list(img.shape))
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    chunks = -(-800 * 800 // 4096)
    ok = all(v["finite"] and v["launches_per_frame"] == chunks and v["shape"] == [800, 800, 3]
             for v in layouts.values())
    emit("bench_ngp", card=smi, sm_clock_temp_power=clocks, frames=frames, layouts=layouts, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: bench_ngp phase failed")
    return layouts


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
    kernels 1, 3, 4 and 5's errors include train_multi_step's."""
    lines = _kernel_entries(done)
    for entry in lines:
        # the launches of the LLFF + NDC, occupancy and multi-scene paths,
        # each counted over its own CLI calls
        entry["launches_by_path"] = {path: done[path][entry["name"]]
                                     for path in ("train_llff", "train_occ", "train_multi")
                                     if entry["name"] in done[path]}
        entry["max_abs_err"] = max(entry["max_abs_err"], done["train_multi_step"].get(entry["name"], 0.0))
    return lines


def _kernel_entries(done: dict) -> list:
    shapes = done["bench"]
    fine = shapes["fine"]
    k1_err = max([done["kernel"]] + [e for s in shapes.values()
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
         "launches": done["train_bench"]["generic_bwd_launches"], "max_abs_err": done["kernel_bwd"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "fused_train_pass", "route": "cuda",
         "source": "torch_nerf_tpu_torch/ops/csrc/fused_train.cu",
         "replaces": "torch_nerf_tpu/ops/pallas/fused_train.py:196", "launches": done["train"]["fused_train_pass"],
         "max_abs_err": done["kernel_train"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
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
        "train_bench": phase_train_bench(smi),
        "bench": phase_bench(smi),
        "train_ngp": phase_train_ngp(work),
        "train_packed": phase_train_packed(work),
        "train_llff": phase_train_llff(work),
        "train_occ": phase_train_occ(work),
        "train_multi": phase_train_multi(work),
        "train_multi_step": phase_train_multi_step(),
        "train_bench_ngp": phase_train_bench_ngp(smi),
        "bench_ngp": phase_bench_ngp(smi),
        "train_bench_multi": phase_train_bench_multi(smi),
    }
    phase_lpips(work, done["train_multi"]["render_dir"], done["train_multi"]["gt_dir"])
    phase_profile(work)
    print(smi)
    print(json.dumps({"kernels": kernel_lines(done)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
