"""Hold kernels 1-3 of the general routes against their plain versions on
the card, and time them.

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
786,432 points) on the config's route, in two turns, by CUDA events (to
hold them against another version, ``train_ab`` and ``forward_ab`` with
``--other``), and the dW GEMM alone (``csrc/nerf_dw_tc.cuh``) over
that shape's kernel-2 stash beside one cuBLAS GEMM a stash
segment (``dw_library``: a yardstick, never on the path), the plain
version and its floors by operations and by bytes (``dw_times``). With
``--library N`` only that yardstick, on random stashes of N points at the
config's widths (any config, the presets' too). One JSON line a config,
then the card's ``nvidia-smi`` line.

    python -m torch_nerf_tpu_torch.runners.general_check --config 512:12 --config 256:10:f32 [--points N]
        [--cotangent both|rgb|sigma] [--time]
    python -m torch_nerf_tpu_torch.runners.general_check --config 256:10 --library 786432 --library 262144
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import torch

from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf as fn
from torch_nerf_tpu_torch.ops import fused_train as ftm
from torch_nerf_tpu_torch.ops import sampling
from torch_nerf_tpu_torch.runners.timing import event_ms, nvidia_smi

FLOOR = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# H100 SXM data-sheet peaks: dense bf16, HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
LIBRARY = "torch.matmul(A.t(), dZ) a stash segment (bf16: f32 accumulate, bf16 out; f32: TF32 off)"


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


def _verdict(err: dict, plain: dict, floor: float, scale: float = 2.0) -> dict:
    share = {k: err[k] / (scale * plain[k] + floor) for k in err}
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


# ---------------------------------------------------------------------------
# the dW GEMM alone (csrc/nerf_dw_tc.cuh) over a kernel-2 stash


def dw_layers(cfg, workspace, m) -> list:
    """Each layer's ``(A segments, dZ)`` views of the stashes at the start
    of ``workspace`` (``fused_nerf.stash_views``)."""
    acts, dzs = fn.stash_views(workspace, m, cfg)
    return [([acts[s] for s in segs], dz) for segs, dz in zip(fn.DW_SEGMENTS, dzs)]


def dw_plain(layers, dtype=torch.float32) -> list:
    """``backward_from_activations``' ``put`` on the stashes in ``dtype``
    (the plain version: f32 sums of the rounded operands; f64 the exact
    reference): per layer ``(dW, db)`` in the kernel layout."""
    out = []
    for segs, dz in layers:
        a = torch.cat(segs, dim=1) if len(segs) > 1 else segs[0]
        z = dz.to(dtype)
        out.append((a.to(dtype).t() @ z, z.sum(dim=0)))
    return out


def dw_library(layers) -> list:
    """The yardstick: one cuBLAS GEMM ``torch.matmul(A.t(), dZ)`` a stash
    segment, on the stashes as they are (bf16: f32 accumulate, bf16 out;
    f32 with TF32 off), no db. Timed only, never on the path."""
    return [torch.matmul(a.t(), dz) for segs, dz in layers for a in segs]


def dw_rel(got, ref) -> dict:
    """Relative L2 of each layer's dW and db: ``{"fc_in.w": ...}``."""
    out = {}
    for name, (gw, gb), (rw, rb) in zip(LAYER_NAMES, got, ref):
        for leaf, g, r in (("w", gw, rw), ("b", gb, rb)):
            out[f"{name}.{leaf}"] = ((g.double() - r.double()).norm() / max(r.double().norm().item(), 1e-30)).item()
    return out


# the dW GEMM alone: each layer's dW and db within 2x the plain version's
# relative L2 + this floor. bf16 the type's (its faults move the sums by
# O(1)); f32 5e-7, under the 1e-5 of the kernels' checks: the f32 route's
# low piece, 2^-16 of an operand, reads ~3e-6 at the fine shape where the
# plain f32 version reads up to ~1e-6, and must fail it
DW_FLOOR = {torch.bfloat16: FLOOR[torch.bfloat16], torch.float32: 5e-7}


def dw_reference(cfg, workspace, m):
    """``(exact, plain)`` for :func:`dw_check`: the f64 sums of the stashes
    at the start of ``workspace``, and the plain f32 version's relative
    L2 from them."""
    layers = dw_layers(cfg, workspace, m)
    exact = dw_plain(layers, torch.float64)
    return exact, dw_rel(dw_plain(layers), exact)


def dw_check(cfg, workspace, m, ref=None) -> dict:
    """The dW GEMM over the stashes at the start of ``workspace`` against
    the plain version on the same stashes, the exact (f64) sums the
    reference (``ref``: :func:`dw_reference`'s, made here if not given):
    each layer's dW and db within 2x the plain f32 version's relative L2 +
    :data:`DW_FLOOR`; a second launch bit-identical."""
    exact, plain = ref or dw_reference(cfg, workspace, m)
    runs = [fn.general_dw(workspace, m, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    got = list(zip(*runs[0]))
    out = _verdict(dw_rel(got, exact), plain, DW_FLOOR[cfg.compute_dtype])
    out["relaunch_bit_identical"] = all(torch.equal(a, b) for r0, r1 in zip(runs[0], runs[1]) for a, b in zip(r0, r1))
    out["max_abs_err"] = max((g - e).abs().max().item() for (gw, gb), (ew, eb) in zip(got, exact)
                             for g, e in ((gw.double(), ew), (gb.double(), eb)))
    out["ok"] = out["ok"] and out["relaunch_bit_identical"]
    return out


@contextlib.contextmanager
def planted_dw_fault(kind: str):
    """The dW GEMM's planted fault ``kind`` (``fused_nerf.DW_FAULTS``) in
    every launch of the tensor-core libraries (kernels 2 and 3 on paths A
    and B, and ``fused_nerf.general_dw``) inside the block."""
    setters = (fn._tc_bwd_library().fused_tc_bwd_set_dw_fault, ftm._tc_library().fused_tc_train_set_dw_fault)
    for set_fault in setters:
        set_fault(fn.DW_FAULTS[kind])
    try:
        yield
    finally:
        for set_fault in setters:
            set_fault(0)


# the faults of each compute type's pieces (bf16 has none to drop)
DW_TYPE_FAULTS = {torch.bfloat16: ("slice_skipped", "db_dropped", "swizzle_off_by_one_chunk"),
                  torch.float32: tuple(fn.DW_FAULTS)}


def dw_fault_checks(cfg, workspace, m, ref=None) -> dict:
    """Each planted fault of :data:`DW_TYPE_FAULTS` in turn, :func:`dw_check`
    on the same stashes, which it must fail. -> ``{name: verdict +
    "rejected"}``."""
    ref = ref or dw_reference(cfg, workspace, m)
    out = {}
    for kind in DW_TYPE_FAULTS[cfg.compute_dtype]:
        with planted_dw_fault(kind):
            v = dw_check(cfg, workspace, m, ref)
        out[kind] = {"rejected": not v["ok"], "worst": v["worst"], "err": v["err"],
                     "share_of_limit": v["share_of_limit"]}
    return out


def dw_times(cfg, workspace, m, iters: int = 5) -> dict:
    """The dW GEMM's device ms over the stashes at the start of
    ``workspace`` beside the cuBLAS yardstick (:func:`dw_library`), the
    plain version (:func:`dw_plain`) and its floors by operations (at the
    route's peak: 989 TFLOP/s bf16, 989 / 8 for f32's eight bf16 products)
    and by bytes (each stash read once, ``fused_train.dw_floors``, 3.35
    TB/s), by CUDA events."""
    layers = dw_layers(cfg, workspace, m)
    floors = ftm.dw_floors(cfg, m)
    peak = PEAK_FLOPS / (8 if cfg.compute_dtype == torch.float32 else 1)
    with torch.no_grad():
        ms = event_ms(lambda: fn.general_dw(workspace, m, cfg), iters)
        library = event_ms(lambda: dw_library(layers), iters)
        plain = event_ms(lambda: dw_plain(layers), 1)
    return {"points": m, "ms": ms, "library_ms": library, "plain_ms": plain,
            "floor_ops_ms": floors["flops"] / peak * 1e3, "floor_bytes_ms": floors["bytes"] / PEAK_BYTES * 1e3,
            "library": LIBRARY}


def dw_library_ms(cfg, points: int, dev, iters: int = 5) -> float:
    """The cuBLAS yardstick (:func:`dw_library`) alone, on stashes of seeded
    random values laid out as the general route's at ``cfg``'s widths: for
    a config the general route does not take (the presets, whose own dW
    GEMM reads panel-major stashes), the same GEMMs' library time."""
    gen = torch.Generator(device=dev).manual_seed(7)
    workspace = torch.empty(fn.stash_nbytes(points, cfg), dtype=torch.uint8, device=dev)
    acts, dzs = fn.stash_views(workspace, points, cfg)
    for view in list(acts.values()) + dzs:
        view.copy_(torch.randn(view.shape, generator=gen, device=dev))
    layers = dw_layers(cfg, workspace, points)
    with torch.no_grad():
        return event_ms(lambda: dw_library(layers), iters)


def time_routes(cfg, params, gen, dev) -> dict:
    """Kernels 1-3 at the fine shape on the config's route, two turns."""
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
    route = fn.train_route(cfg)
    w = fn.prepare(params, cfg)
    out = {}
    for _ in range(2):
        with torch.no_grad():
            row = {"kernel1_ms": event_ms(lambda: fn.fused_nerf_apply(w, pts, dirs, cfg), 3),
                   "kernel3_ms": event_ms(lambda: ftm.fused_train_pass(params, o, d, t, delta, gt, cfg, n), 3),
                   "kernel2_ms": event_ms(lambda: fn.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg), 2)}
        out.setdefault(route, []).append(row)
    out["dw_gemm"] = dw_times(cfg, fn.general_stash(params, pts, dirs, g_sigma, g_rgb, cfg), pts.shape[0])
    return out


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", action="append", help="FEAT:LEVEL (bf16) or FEAT:LEVEL:f32")
    parser.add_argument("--points", type=int, default=2**14 + 37)
    parser.add_argument("--cotangent", choices=("both", "rgb", "sigma"), default="both")
    parser.add_argument("--time", action="store_true", help="time each config's kernels 1-3 and its dW GEMM")
    parser.add_argument("--library", type=int, action="append",
                        help="only the dW GEMM's cuBLAS yardstick on random stashes of this many points")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions and yardstick in full f32
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for spec in args.config or ["512:12", "256:10:f32"]:
        feat, level, *dtype = spec.split(":")
        cfg = fn.FusedNeRFConfig(coord_encode_level=int(level), feat_dim=int(feat),
                                 compute_dtype=torch.float32 if dtype == ["f32"] else torch.bfloat16)
        if args.library:
            row = {"config": spec, "route": fn.forward_route(cfg), "library": LIBRARY,
                   "library_ms": {m: dw_library_ms(cfg, m, dev) for m in args.library}}
            print(json.dumps(row), flush=True)
            rows.append(row)
            continue
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
