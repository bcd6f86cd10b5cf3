"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

Drives the port's main path (render a trained classic NeRF) through its own
entry points and holds every kernel on that path against its plain PyTorch
version. Each phase prints one JSON line; any failure exits non-zero. Then
it prints the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py

Phases: device, build (nvcc, sm_90a), kernel (full width, ragged tail,
against the plain version with PyTorch-default and He-scaled weights, and
three planted trunk faults that the comparison must reject), serve
(``run_render`` + ``evaluate`` CLIs on 128x128 test views, kernel launches
counted, the kernel's render held against the plain version's), bench
(800x800 frames at ``bench.py --render``'s operating point, kernel and plain
times).
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM data-sheet peaks (dense bf16, HBM3); PCIe part where named so
_PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H100", 989e12, 3.35e12), ("H200", 989e12, 4.8e12))

FULL = dict(coord_encode_level=10, dir_encode_level=4, feat_dim=256)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name: str):
    for key, flops, bw in _PEAKS:
        if key in name:
            return flops, bw
    return _PEAKS[1][1], _PEAKS[1][2]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>`` of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    reports = build.build(["fused_nerf_fwd"])
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


def kernel_errors(params, pts, dirs) -> dict:
    """One kernel launch against the plain version in f32 on the same
    bf16-rounded weights; the plain bf16 version's own error is the scale.
    ``ok`` when the kernel's max-abs error is within 2x that + 1e-3."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    cfg = fn.FusedNeRFConfig(**FULL)
    cfg32 = fn.FusedNeRFConfig(**FULL, compute_dtype=torch.float32)
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
    return dict(points=pts.shape[0], max_abs_err=err, plain_bf16_err=scale,
                tolerance="err <= 2 * plain_bf16_err + 1e-3",
                sigma_f32_max=s32.max().item(), sigma_positive_share=(s32 > 0).float().mean().item(),
                rgb_f32_std=c32.std().item(), launches=launched, ok=ok)


def compare_with_plain(params, pts, dirs) -> dict:
    """:func:`kernel_errors`, raising unless ``ok``."""
    result = kernel_errors(params, pts, dirs)
    if not result["ok"]:
        emit("kernel", **result)
        raise SystemExit("chip_smoke: kernel disagrees with its plain version")
    return result


def planted_faults(w) -> dict:
    """Copies of the kernel weights ``w`` with one trunk layer broken the
    way a wrong pointer or stride in the kernel would break it."""
    import dataclasses  # noqa: PLC0415

    from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES  # noqa: PLC0415

    i = {name: k for k, name in enumerate(LAYER_NAMES)}
    frags = list(w.frags)
    zero, swap, roll = list(frags), list(frags), list(frags)
    zero[i["fc_1"]] = torch.zeros_like(frags[i["fc_1"]])
    swap[i["fc_2"]], swap[i["fc_3"]] = frags[i["fc_3"]], frags[i["fc_2"]]
    f6 = frags[i["fc_6"]]  # (K/16 k-tiles x N/8 n-tiles x 32 lanes, 4)
    roll[i["fc_6"]] = torch.roll(f6, f6.shape[0] // (FULL["feat_dim"] // 16), dims=0)
    return {
        "fc_1_zeroed": dataclasses.replace(w, frags=tuple(zero)),
        "fc_2_fc_3_swapped": dataclasses.replace(w, frags=tuple(swap)),
        "fc_6_k_tiles_shifted": dataclasses.replace(w, frags=tuple(roll)),
    }


def phase_kernel():
    """Kernel vs plain version at full width on 2^17 + 37 points (a ragged
    tail), with the seeded port-init weights and their He-scaled copy; then
    three planted trunk faults, which the check must reject with the
    He-scaled weights. The main path's chunk shapes are compared in the
    bench phase."""
    from torch_nerf_tpu_torch.ops import fused_nerf as fn  # noqa: PLC0415

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 2**17 + 37
    pts = torch.rand((m, 3), generator=gen, device=dev) * 8.0 - 4.0
    dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
    base = _seeded_params(0, dev)
    weight_sets = {"port_init": base, "he": he_scaled(base)}
    results = {k: compare_with_plain(p, pts, dirs) for k, p in weight_sets.items()}
    faults = {}
    for wname, params in weight_sets.items():
        for fault, bad in planted_faults(fn.prepare(params, fn.FusedNeRFConfig(**FULL))).items():
            r = kernel_errors(bad, pts, dirs)
            faults[f"{wname}/{fault}"] = {"rejected": not r["ok"], "max_abs_err": r["max_abs_err"]}
    ok = all(v["rejected"] for k, v in faults.items() if k.startswith("he/"))
    emit("kernel", weights=results, planted_faults=faults,
         rule="every planted fault rejected with the he weights", ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: a planted kernel fault passed the comparison")
    return max(e for r in results.values() for e in r["max_abs_err"].values())


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

    fn.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out)])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = fn.fused_nerf_apply.launches

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
    ok = (ok and launches == want and shapes == [[128, 128, 3]] * 2
          and all(math.isfinite(v) for v in scores.values()))
    emit("serve", render_seconds=render_s, launches=launches, expected_launches=want,
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
    before = fn.fused_nerf_apply.launches
    t0 = time.perf_counter()
    for i in range(frames):
        img = frame(2 + i)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    clocks = nvidia_smi("clocks.sm,temperature.gpu,power.draw")
    per_frame_launches = (fn.fused_nerf_apply.launches - before) / frames
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
        pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
        dirs = d[:, None, :].expand(-1, samples, -1).reshape(-1, 3).contiguous()
        m = pts.shape[0]
        check = compare_with_plain(prepared, pts, dirs)
        check_he = compare_with_plain(prepared_he, pts, dirs)
        kernel_ms = cuda_ms(lambda: fn.fused_nerf_apply(prepared, pts, dirs, cfg), 20)
        plain_ms = cuda_ms(lambda: fn.fused_nerf_apply_reference(params["fine"], pts, dirs, cfg), 5)
        flops = fn.flops_per_point(cfg) * m
        nbytes = m * (3 + 3 + 1 + 3) * 4 + sum(t.numel() * 2 for t in prepared.frags + prepared.biases)
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
    ok = bool(torch.isfinite(img).all()) and per_frame_launches == 2 * chunks
    emit("bench", card=smi, sm_clock_temp_power=clocks, frames=frames,
         seconds_per_frame=s_per_frame,
         rays_per_sec=800 * 800 / s_per_frame, launches_per_frame=per_frame_launches,
         kernel_seconds_per_frame=kernel_s, kernel_share_of_frame=kernel_s / s_per_frame,
         peak_flops=peak_flops, peak_bytes_per_s=peak_bw, kernel=shapes, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: bench phase failed")
    return shapes


def main() -> int:
    import torch_nerf_tpu_torch  # noqa: F401, PLC0415  (fails at once outside a checkout)

    smi = phase_device()
    # plain versions in full f32 / f32-accumulated bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    phase_build()
    max_err = phase_kernel()
    work = Path(__file__).resolve().parent / "outputs" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    launches = phase_serve(work)
    shapes = phase_bench(smi)
    fine = shapes["fine"]
    max_err = max([max_err] + [e for s in shapes.values()
                               for k in ("max_abs_err", "he_max_abs_err") for e in s[k].values()])
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_nerf_fwd",
        "route": "cuda",
        "source": "torch_nerf_tpu_torch/ops/csrc/fused_nerf_fwd.cu",
        "replaces": "torch_nerf_tpu/ops/pallas/fused_nerf.py:397",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": fine["ms"],
        "plain_ms": fine["plain_ms"],
        "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
