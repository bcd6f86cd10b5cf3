"""Hold kernels 1-3 of the general routes against their plain versions on
the card, and time them against the mma.sync/FFMA engine in this checkout.

For each config (``FEAT:LEVEL`` in bf16, ``FEAT:LEVEL:f32`` in f32) on the
route ``fused_nerf.forward_route`` gives it: kernel 1 on ``--points``
random points, kernel 2 with seeded random cotangents (``--cotangent``:
both, only the rgb's, only sigma's) and kernel 3 on 256 rays x 64 sorted
depths, each with seeded port-init weights and their He-scaled copy,
against the plain version one precision up (f32 on the bf16-rounded
weights for bf16; f64 for f32): kernel 1's max-abs error, kernels 2-3's
relative L2 error of each grad (dpts, ddirs too), each beside the plain
version's own error in the config's type, and the worst grad's share of
the limit 2x that + the type's floor (1e-3 bf16, 1e-5 f32). Then, with
``--time``, kernels 1-3 at a step's fine shape (4096 rays x 192 depths,
786,432 points) on the config's route and on the mma.sync/FFMA route for the same
config (``mma_sync`` or ``f32``, forced by ``train_route``), in turns, by
CUDA events. One JSON line a config, then the card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.general_check --config 512:12 --config 256:10:f32 [--points N]
        [--cotangent both|rgb|sigma] [--time]
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.models.nerf import init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf as fn
from torch_nerf_tpu_torch.ops import fused_train as ftm
from torch_nerf_tpu_torch.ops import sampling
from torch_nerf_tpu_torch.runners.timing import event_ms, nvidia_smi

FLOOR = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# the mma.sync/FFMA engine's route of each compute type
MMA_FFMA = {torch.bfloat16: "mma_sync", torch.float32: "f32"}


def _up(params, tensors, cfg):
    """The plain version one precision up: its params, tensors and config."""
    up = torch.float64 if cfg.compute_dtype == torch.float32 else torch.float32
    params = {n: {k: v.to(cfg.compute_dtype).to(up) for k, v in p.items()} for n, p in params.items()}
    tensors = [t.to(up) if t.dtype == torch.float32 and up == torch.float64 else t for t in tensors]
    return params, tensors, fn.FusedNeRFConfig(coord_encode_level=cfg.coord_encode_level, feat_dim=cfg.feat_dim,
                                               compute_dtype=up)


def _named(grads, **extra):
    out = {f"{n}.{k}": v for n, p in grads.items() for k, v in p.items()}
    out.update(extra)
    return out


def _rel(got: dict, ref: dict) -> dict:
    return {k: ((got[k].double() - ref[k].double()).norm() / max(ref[k].double().norm().item(), 1e-30)).item()
            for k in ref}


def _verdict(err: dict, plain: dict, floor: float) -> dict:
    share = {k: err[k] / (2.0 * plain[k] + floor) for k in err}
    worst = max(share, key=share.get)
    return {"worst": worst, "err": err[worst], "plain_err": plain[worst], "share_of_limit": share[worst],
            "ok": all(math.isfinite(v) and v <= 1.0 for v in share.values())}


def check(cfg, params, pts, dirs, g_sigma, g_rgb, rays) -> dict:
    """Kernels 1-3 of ``cfg`` against the plain versions (module note)."""
    floor = FLOOR[cfg.compute_dtype]
    out = {}
    rp, (rpts, rdirs), rcfg = _up(params, [pts, dirs], cfg)
    got = fn.fused_nerf_apply(fn.prepare(params, cfg), pts, dirs, cfg)
    ref = fn.fused_nerf_apply_reference(rp, rpts, rdirs, rcfg)
    own = fn.fused_nerf_apply_reference(params, pts, dirs, cfg)
    out["kernel1_max_abs"] = [(a.double() - b.double()).abs().max().item() for a, b in zip(got, ref)]
    out["kernel1_plain_max_abs"] = [(a.double() - b.double()).abs().max().item() for a, b in zip(own, ref)]
    rp, (rpts, rdirs, rgs, rgr), rcfg = _up(params, [pts, dirs, g_sigma, g_rgb], cfg)
    g_ref, dp_ref, dd_ref = fn.fused_nerf_bwd_reference(rp, rpts, rdirs, rgs, rgr, rcfg)
    g_own, dp_own, dd_own = fn.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    g_got, dp_got, dd_got = fn.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg)
    ref = _named(g_ref, dpts=dp_ref, ddirs=dd_ref)
    out["kernel2"] = _verdict(_rel(_named(g_got, dpts=dp_got, ddirs=dd_got), ref),
                              _rel(_named(g_own, dpts=dp_own, ddirs=dd_own), ref), floor)
    o, d, t, gt = rays
    delta = sampling.t_deltas(t)
    rp, (ro, rd, rt, rdelta, rgt), rcfg = _up(params, [o, d, t, delta, gt], cfg)
    n = t.shape[0]
    ref = _named(ftm.fused_train_pass_reference(rp, ro, rd, rt, rdelta, rgt, rcfg, n)[2])
    own = _named(ftm.fused_train_pass_reference(params, o, d, t, delta, gt, cfg, n)[2])
    got = _named(ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, n)[2])
    out["kernel3"] = _verdict(_rel(got, ref), _rel(own, ref), floor)
    torch.cuda.synchronize()
    return out


def time_routes(cfg, params, gen, dev) -> dict:
    """Kernels 1-3 at the fine shape on the config's route and the
    mma.sync/FFMA one, in turns (that, the config's, the config's, that)."""
    n, s = 4096, 192
    o = torch.randn((n, 3), generator=gen, device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    t = torch.sort(torch.rand((n, s), generator=gen, device=dev) * 4 + 2, dim=-1).values
    delta = sampling.t_deltas(t)
    gt = torch.rand((n, 3), generator=gen, device=dev)
    pts = (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3).contiguous()
    dirs = d[:, None, :].expand(n, s, 3).reshape(-1, 3).contiguous()
    g_sigma = torch.randn((pts.shape[0],), generator=gen, device=dev)
    g_rgb = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
    route, old = fn.train_route(cfg), MMA_FFMA[cfg.compute_dtype]
    picked = fn.train_route
    out = {}
    for r in (old, route, route, old):
        w = fn.kernel_weights(params, cfg, r)
        fn.train_route = lambda c, r=r: r
        try:
            with torch.no_grad():
                row = {"kernel1_ms": event_ms(lambda: fn.fused_nerf_apply(w, pts, dirs, cfg), 3),
                       "kernel3_ms": event_ms(lambda: ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, n), 3),
                       "kernel2_ms": event_ms(lambda: fn.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg), 2)}
        finally:
            fn.train_route = picked
        out.setdefault(r, []).append(row)
    return out


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", action="append", help="FEAT:LEVEL (bf16) or FEAT:LEVEL:f32")
    parser.add_argument("--points", type=int, default=2**14 + 37)
    parser.add_argument("--cotangent", choices=("both", "rgb", "sigma"), default="both")
    parser.add_argument("--time", action="store_true", help="time each config against the mma.sync/FFMA route")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for spec in args.config or ["512:12", "256:10:f32"]:
        feat, level, *dtype = spec.split(":")
        cfg = fn.FusedNeRFConfig(coord_encode_level=int(level), feat_dim=int(feat),
                                 compute_dtype=torch.float32 if dtype == ["f32"] else torch.bfloat16)
        base = init_nerf_params(torch.Generator(device=dev).manual_seed(0), cfg.pos_enc_dim, cfg.dir_enc_dim,
                                cfg.feat_dim, device=dev)
        m = args.points
        pts = torch.rand((m, 3), generator=gen, device=dev) * 8 - 4
        dirs = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device=dev), dim=-1)
        g_sigma = torch.randn((m,), generator=gen, device=dev) * (args.cotangent != "rgb")
        g_rgb = torch.randn((m, 3), generator=gen, device=dev) * (args.cotangent != "sigma")
        o = torch.randn((256, 3), generator=gen, device=dev)
        d = torch.nn.functional.normalize(torch.randn((256, 3), generator=gen, device=dev), dim=-1)
        t = torch.sort(torch.rand((256, 64), generator=gen, device=dev) * 4 + 2, dim=-1).values
        rays = (o, d, t, torch.rand((256, 3), generator=gen, device=dev))
        row = {"config": spec, "route": fn.forward_route(cfg), "points": m, "cotangent": args.cotangent}
        for wname, params in (("port_init", base),
                              ("he", {n: {"w": v["w"] * math.sqrt(6.0), "b": v["b"]} for n, v in base.items()})):
            row[wname] = check(cfg, params, pts, dirs, g_sigma, g_rgb, rays)
        if args.time:
            row["ms"] = time_routes(cfg, base, gen, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"card": nvidia_smi("name,power.limit")}), flush=True)
    return rows


if __name__ == "__main__":
    main()
