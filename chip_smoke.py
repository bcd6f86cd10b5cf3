"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

Drives the port's main paths through its own entry points (render a trained
classic NeRF; train one, by the fused train pass and by autograd through the
field; train, resume, render and evaluate both Instant-NGP presets and the
packed table layouts with their smoothness loss) and holds every kernel on
them against its plain PyTorch version.
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
planted faults that must be rejected, then kernels 4-7 on three
contention cases: every point in one voxel, long runs of samples along
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
backward fold launches per step, one forward per render chunk).
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


def composite_errors(c, w, c32, w32, cbf, wbf) -> dict:
    """rgb (N, 3) and weights (N, S) of a pass against the plain f32
    version's, each measure within 2x the plain bf16 version's own + 1e-3:
    the relative L2 error of each; the max-abs error of the weights without
    the last interval, whose weight jumps between 0 and the ray's
    transmittance when sigma's bf16 rounding crosses 0 there (its delta is
    1e8); and the max-abs error of rgb on the rays where neither the pass
    nor the plain bf16 version moved that weight by more than 1e-3."""
    flip = ((w[:, -1] - w32[:, -1]).abs() > 1e-3) | ((wbf[:, -1] - w32[:, -1]).abs() > 1e-3)
    keep = ~flip

    def measures(c_, w_):
        return {"rgb_rel_l2": rel_l2({"x": c_}, {"x": c32})["x"],
                "weights_rel_l2": rel_l2({"x": w_}, {"x": w32})["x"],
                "weights_max_abs_but_last": (w_[:, :-1] - w32[:, :-1]).abs().max().item(),
                "rgb_max_abs_unflipped": (c_[keep] - c32[keep]).abs().max().item() if keep.any() else 0.0}

    err, scale = measures(c, w), measures(cbf, wbf)
    limit = {k: 2.0 * scale[k] + 1e-3 for k in err}
    ok = all(math.isfinite(err[k]) and err[k] <= limit[k] for k in err)
    return dict(ok=ok, err=err, limit=limit, flipped_rays=int(flip.sum()),
                plain_flipped_rays=int(((wbf[:, -1] - w32[:, -1]).abs() > 1e-3).sum()),
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


def phase_kernel_train(batch):
    """Kernel 3 (the fused train pass) against its plain version at the main
    path's shapes, 4096 x 64 and 4096 x 192 (sorted depths from a real
    draw), and a ragged 4093-ray batch with 4090 real rays; PyTorch-default
    and He-scaled weights. rgb and weights as :func:`composite_errors`
    measures them; the 22 grads by relative L2 as in kernel_bwd; at the
    coarse shape a second launch bit-identical. Then, at the coarse shape,
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
    cases = {"coarse": (4096, 4096, batch["t_c"]), "fine": (4096, 4096, batch["t_f"]),
             "ragged": (4093, 4090, batch["t_c"][:4093])}
    results, faults, max_abs = {}, {}, 0.0
    for case, (n, real, t) in cases.items():
        t = t.contiguous()
        delta = sampling.t_deltas(t)
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
                comp = composite_errors(c, w, c32, w32, cbf, wbf)
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
            if case != "coarse":
                continue
            # a second launch on the same inputs: the same outputs, bit for bit
            check(runs=runs)
            same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
            results[key].update(relaunch_bit_identical=same, ok=results[key]["ok"] and same)
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
        v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel_train", cases=results, planted_faults=faults,
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
        ftm.fused_train_pass.launches = 0
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


def phase_train_bench(smi: str):
    """Train steps at bench.py's operating point (8 views at 400x400, 4096
    rays, 64 + 128 samples, make_image_train_step(precrop=False)): 3 warm-up
    and 20 timed steps, fused and force_generic, with the launches of each
    path counted over its timed steps; then kernel 3 alone per coarse and
    fine pass and kernel 2 at the fine shape (CUDA events), beside their
    bounds and the plain versions' times."""
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
    field = make_nerf_field(compute_dtype=torch.bfloat16)
    settings = renderer.RenderSettings(num_samples_coarse=64, num_samples_fine=128)
    optim = train.OptimConfig()
    timed = 20
    paths, states = {}, {}
    for path, generic in (("fused", False), ("generic", True)):
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, force_generic=generic)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(3):
            state, _ = step(state, images, poses, gen)
        torch.cuda.synchronize()
        ftm.fused_train_pass.launches = fn.fused_nerf_bwd.launches = 0
        fn.reset_launches()
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, images, poses, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        paths[path] = dict(ms_per_step=elapsed / timed * 1e3, rays_per_sec=4096 * timed / elapsed,
                           launches={"fused_train_pass": ftm.fused_train_pass.launches,
                                     "fused_nerf_fwd": fn.fused_nerf_apply.launches,
                                     "fused_nerf_bwd": fn.fused_nerf_bwd.launches},
                           loss_first=losses[0], loss_last=losses[-1],
                           finite=all(math.isfinite(v) for v in losses))
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
                                               "fused_nerf_bwd": 2 * timed})
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


def ngp_points(dev, seed=6):
    """The 4096 x 256 = 2^20 sample points of an NGP train batch (random
    pixels of a 400x400 training view, stratified depths in [2, 6]) and 37
    more: 12 with negative coordinates, 12 with integral scaled coordinates
    on one or more axes, 13 far out (|x| up to 900)."""
    from torch_nerf_tpu_torch import cameras, renderer  # noqa: PLC0415
    from torch_nerf_tpu_torch.datasets import synthetic  # noqa: PLC0415
    from torch_nerf_tpu_torch.ops import sampling  # noqa: PLC0415

    gen = torch.Generator(device=dev).manual_seed(seed)
    camera = cameras.CameraParams(480.0, 480.0, 400, 400)
    pose = torch.as_tensor(synthetic.split_poses(8, "train")[0], device=dev)
    pix = torch.randperm(400 * 400, generator=gen, device=dev)[:4096]
    o, d = cameras.rays_for_pixels(pix, camera, pose)
    uni = renderer.draw_uniforms(gen, 4096, renderer.RenderSettings(num_samples_coarse=256, num_samples_fine=0))
    t = sampling.stratified_t_samples_from_uniforms(uni.coarse, 2.0, 6.0)
    pts, _ = ray_points(o, d, t)
    negative = -1.5 * torch.rand((12, 3), generator=gen, device=dev)
    integral = torch.randint(-3, 4, (12, 3), generator=gen, device=dev).float()
    integral[6:, 0] += 0.3  # integral on the other two axes only
    far = torch.rand((13, 3), generator=gen, device=dev) * 1800.0 - 900.0
    return torch.cat([pts, negative, integral, far]).contiguous()


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
    swapped. Then :func:`hash_contention`."""
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
    contention = hash_contention(dev, gen)
    widths = hash_widths(dev, gen)
    ok = (all(r["ok"] for r in results.values()) and all(c["ok"] for c in contention.values())
          and all(w["ok"] for w in widths.values()))
    emit("kernel_hash", layouts=results, contention=contention, widths=widths,
         rule="kernels within the limits; every planted fault rejected; the contention cases within the limits "
              "against the f64 sum, integral points 0; every corner width and a ragged n within the limits", ok=ok)
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
    ``counted`` wrappers set to 0 just before and read just after."""
    for w in counted:
        w.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    torch.cuda.synchronize()
    return result, buf.getvalue(), [w.launches for w in counted]


def train_resume_render(work: Path, name: str, train_args, counted) -> dict:
    """``run_train`` with ``train_args`` into ``work/<name>_run`` for 24
    steps (one validation, checkpoint and visualisation at 8 views), a
    resume for 8 more, then ``run_render`` + ``evaluate`` of two 800x800
    test views; the ``counted`` wrappers' launches over each CLI call."""
    from torch_nerf_tpu_torch import config, session  # noqa: PLC0415
    from torch_nerf_tpu_torch.logging_utils import load_png, save_png  # noqa: PLC0415
    from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train  # noqa: PLC0415

    run, out, gt = work / f"{name}_run", work / f"{name}_render", work / f"{name}_gt"
    logs, results, launches = [], [], []
    t0 = time.perf_counter()
    for max_steps in (24, 32):
        r, log, c = run_cli(run_train.main, ["--log-dir", str(run), "--max-steps", str(max_steps)] + train_args,
                            counted)
        results.append(r)
        logs.append(log)
        launches.append(c)
    train_s = time.perf_counter() - t0
    _, _, render_launches = run_cli(run_render.main, ["--log-dir", str(run), "--render-test-views",
                                                      "--num-views", "2", "--out-dir", str(out)], counted)
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
    hash_result, _, hash_launches = run_cli(run_train.main, [
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
    dual, _, dual_launches = run_cli(run_train.main, [
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


def ngp_field(layout, use_kernel=True):
    from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field  # noqa: PLC0415

    return make_instant_ngp_field(**NGP, compute_dtype=torch.bfloat16, table_layout=layout, use_kernel=use_kernel)


def phase_train_bench_ngp(smi: str):
    """NGP train steps at ``bench.py --model=instant_nerf``'s point (8 views
    at 400x400, 4096 rays x 256 samples, no fine network, Adam 1e-2 -> 1e-3
    at eps 1e-15, ``make_image_train_step(precrop=False)``), every layout,
    the packed ones also with the smoothness loss (weight 1e-3, 1024 probes
    a level): 3 warm-up and 20 timed steps, launches counted over the timed
    ones; then each hash kernel alone on the 2^20 points of a batch of the
    step's own, with a seeded random cotangent (CUDA events), beside its
    bound, its share of it and its plain version's time."""
    from torch_nerf_tpu_torch import config, renderer, session, train  # noqa: PLC0415
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
    for layout, smooth in [(x, False) for x in NGP_LAYOUTS + PACKED_LAYOUTS] + [(x, True) for x in PACKED_LAYOUTS]:
        packed = layout in PACKED_LAYOUTS
        fwd, bwd = fold_ops() if packed else hash_ops(layout)[:2]
        aux = None
        if smooth:
            aux = session.build_aux_loss(config.resolve("instant_nerf", [f"network.table_layout={layout}"]
                                                         + SMOOTHNESS))
        path = f"{layout}+smoothness" if smooth else layout
        field = ngp_field(layout)
        state = train.create_train_state(torch.Generator(device=dev).manual_seed(0), field, settings, optim, dev)
        step = train.make_image_train_step(field, settings, optim, camera, 4096, aux_loss_fn=aux)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(3):
            state, _ = step(state, images, poses, gen)
        torch.cuda.synchronize()
        fwd.launches = bwd.launches = 0
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, images, poses, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        per_step = 2 if smooth else 1
        paths[path] = dict(ms_per_step=elapsed / timed * 1e3, rays_per_sec=4096 * timed / elapsed,
                           launches={"fwd": fwd.launches, "bwd": bwd.launches},
                           expected_launches={"fwd": per_step * timed, "bwd": per_step * timed},
                           loss_first=losses[0], loss_last=losses[-1],
                           aux_loss_last=float(metrics["aux_loss"]) if smooth else None,
                           finite=all(math.isfinite(v) for v in losses))
        if smooth:
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
        fwd.launches = 0
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
    layout's tables)."""
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
        "train_bench_ngp": phase_train_bench_ngp(smi),
        "bench_ngp": phase_bench_ngp(smi),
    }
    print(smi)
    print(json.dumps({"kernels": kernel_lines(done)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
