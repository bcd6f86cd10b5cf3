"""Whether what the timed path produced is correct: the comparison with
the plain reference, after the window. A cell compares the numbers its
``limits/<cell>.json`` names, each against its limit.

Train cells: the reference follows the checked steps from the same
weights, images and draws, with its own rays, sampling, loss, gradients
and Adam. The numbers: the worst step's loss gap (``loss_gap``, as a
share of the reference's loss); the first step's coarse-loss gap
(``coarse_loss1_gap``: the coarse pass's samples do not depend on an
earlier pass, so only precision moves it); the worst leaf's gap of first
gradient norms, the gradient as Adam's first moment holds it after one
step (``grad_gap``); the worst leaf's gap of change norms over the checked
steps (``change_gap``); the median leaf's norm of the difference of first
gradients (``grad_diff_gap``), steady from seed to seed where a norm's
gap is not. Each is measured against the larger of the reference's norm
of that leaf and of the median leaf; the change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone). The checked steps' rays come in order of brightness
(``inputs.by_brightness``), so that a step which leaves out half of its
batch moves the gradient far past precision's own spread.

Render cells: a sample of the window's chunks, drawn from the seed,
rendered again by the reference from the frame's pose and the chunk's
draws: the largest gap of a colour channel (``rgb_max_gap``), the root
mean square of the gaps (``rgb_rms_gap``) and the 90th percentile of
their magnitudes (``rgb_p90_gap``), and the share of the channels more
than ``FAR_GAP`` off (``rgb_far_share``), which a fault on a tenth of the
rays moves where the 90th percentile does not.

The control is the same reference with its products' operands rounded one
precision below the configuration's (``lowp.fp8``), in the program's place.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from nerfbench import inputs, reference
from nerfbench.reference import optim, volume
from nerfbench.reference.lowp import Rounding

GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient norm are left out of the change
FAR_GAP = 0.02  # a colour channel further than this from the reference's counts in ``rgb_far_share``


def _field(ref, cfg: Dict, rounding: Rounding):
    return lambda p, pts, dirs: ref.field(p, pts, dirs, cfg, rounding)


def train_rays(data: Dict, draws, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step's rays and colours, worked out from its draws: the top
    ``num_pixels`` of the pixel uniforms on the drawn image."""
    images, poses, cam = data["images"], data["poses"], data["camera"]
    pixels = torch.topk(draws.pixel_u, cfg["renderer.num_pixels"]).indices
    image = int(draws.image_index)
    o, d = volume.pixel_rays(pixels, cam.img_height, cam.img_width, cam.focal_x, poses[image])
    return o, d, images[image][pixels]


def reference_train(ref, cfg: Dict, data: Dict, block: int, rounding: Rounding = None) -> Dict:
    """The reference's losses, first gradients and parameters after the
    checked steps, in ``optim.leaves`` order."""
    params = inputs.clone(data["weights"])
    flat = [t for _, t in optim.leaves(params)]
    for t in flat:
        t.requires_grad_(True)
    adam = optim.Adam(flat, cfg["train_params.optim.init_lr"], cfg["train_params.optim.end_lr"],
                      cfg["train_params.optim.num_iter"], cfg["train_params.optim.eps"])
    hierarchical = cfg["renderer.num_samples_fine"] > 0
    losses, coarse_losses, first = [], [], None
    for draws in data["checked"]:
        o, d, gt = train_rays(data, draws, cfg)
        loss, coarse_loss, grads = optim.loss_and_grads(_field(ref, cfg, rounding), params, o, d, gt, list(draws.rays),
                                           cfg["renderer.t_near"], cfg["renderer.t_far"], hierarchical, block)
        losses.append(loss)
        coarse_losses.append(coarse_loss)
        if first is None:
            first = [g.clone() for g in grads]
        adam.step(grads)
    return {"losses": losses, "coarse_losses": coarse_losses, "first": first,
            "after": [t.detach().clone() for t in flat]}


def _norm_gaps(prog: List[float], ref: List[float]) -> List[float]:
    base = statistics.median(ref)
    return [abs(p - r) / max(r, base) if max(r, base) > 0 else math.inf for p, r in zip(prog, ref)]


def train_readings(program: Dict, ref_run: Dict, weights: Dict) -> Dict[str, float]:
    """The worst step's loss gap, the first step's coarse-loss gap, the
    worst leaf's gradient and change gaps (and which leaves they are), and
    the median leaf's first gradient difference."""
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref_run["losses"])]
    coarse = [abs(p - r) / abs(r) for p, r in zip(program["coarse_losses"][:1], ref_run["coarse_losses"][:1])]
    start = [t for _, t in optim.leaves(weights)]
    g_ref = [float(g.float().norm()) for g in ref_run["first"]]
    grad = _norm_gaps([float(g.float().norm()) for g in program["first"]], g_ref)
    base = statistics.median(g_ref)
    diff = [float((p.float() - r.float()).norm()) / max(n, base)
            for p, r, n in zip(program["first"], ref_run["first"], g_ref)]
    floor = GRAD_FLOOR * statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= floor]
    change = _norm_gaps([float((program["after"][i].float() - start[i]).norm()) for i in keep],
                        [float((ref_run["after"][i].float() - start[i]).norm()) for i in keep])
    names = ["/".join(path) for path, _ in optim.leaves(weights)]
    return {"loss_gap": max(loss), "coarse_loss1_gap": coarse[0], "grad_gap": max(grad), "change_gap": max(change),
            "grad_diff_gap": statistics.median(diff),
            # for the look at a tail, not compared: the leaves that the widest gaps come from
            "grad_worst_leaf": names[grad.index(max(grad))], "change_worst_leaf": names[keep[change.index(max(change))]]}


def checked_chunks(run_seed: int, frames: int, chunks_per_frame: int, count: int) -> List[Tuple[int, int]]:
    """The (frame, chunk) pairs of the check, drawn from the seed."""
    picks = inputs.sample(run_seed, "check", frames * chunks_per_frame, count)
    return [divmod(i, chunks_per_frame) for i in picks]


def reference_chunks(ref, cfg: Dict, tr: Dict, data: Dict, run_seed: int, picks, rounding: Rounding = None):
    """The reference's colours of each picked chunk."""
    cam, poses, size = data["camera"], data["poses"], tr["chunk_size"]
    total = cam.img_height * cam.img_width
    sc, sf = cfg["renderer.num_samples_coarse"], cfg["renderer.num_samples_fine"]
    hierarchical = sf > 0
    field = _field(ref, cfg, rounding)
    out = []
    with torch.no_grad():
        for f, c in picks:
            first = c * size
            pixels = torch.arange(first, min(total, first + size), device=poses.device)
            n = pixels.shape[0]
            uni = [u[:n] for u in inputs.chunk_uniforms(run_seed, f, first, size, sc, sf, poses.device)]
            o, d = volume.pixel_rays(pixels, cam.img_height, cam.img_width, cam.focal_x, poses[f % poses.shape[0]])
            rows = []
            for a in range(0, n, tr["reference_block"]):
                b = slice(a, a + tr["reference_block"])
                res = volume.render(field, data["weights"], o[b], d[b], [u[b] for u in uni], cfg["renderer.t_near"],
                                    cfg["renderer.t_far"], hierarchical)
                rows.append(res["fine"] if hierarchical else res["coarse"])
            out.append(torch.cat(rows))
    return out


def program_chunks(frames: List[torch.Tensor], picks, size: int) -> List[torch.Tensor]:
    out = []
    for f, c in picks:
        flat = frames[f].reshape(-1, 3)
        out.append(flat[c * size:(c + 1) * size].float())
    return out


def render_readings(prog: List[torch.Tensor], ref_rgb: List[torch.Tensor]) -> Dict[str, float]:
    """Gaps of the colour channels: the largest, the root mean square and
    the 90th percentile of their magnitudes."""
    gap = torch.cat([(p - r).reshape(-1) for p, r in zip(prog, ref_rgb)]).double()
    if not bool(torch.isfinite(gap).all()):
        return dict.fromkeys(("rgb_max_gap", "rgb_rms_gap", "rgb_p90_gap", "rgb_far_share"), math.inf)
    mag = gap.abs()
    return {"rgb_max_gap": float(mag.max()), "rgb_rms_gap": float(gap.pow(2).mean().sqrt()),
            "rgb_p90_gap": float(torch.quantile(mag.float(), 0.9)),
            "rgb_far_share": float((mag > FAR_GAP).double().mean())}


def readings(run, rounding: Rounding = None, as_program: bool = True) -> Dict[str, float]:
    """The run's readings against the f32 reference; with ``rounding`` and
    not ``as_program``, the control's (the reference at that rounding in
    the program's place) on the same inputs."""
    cell, ref = run.cell, reference.model(run.cell.config["reference"])
    cfg, tr = cell.config, cell.traffic
    reference.strict_f32()
    data = run.kept["data"]
    if cell.job == "train":
        exact = reference_train(ref, cfg, data, tr["reference_block"])
        program = run.kept["program"] if as_program else reference_train(ref, cfg, data, tr["reference_block"],
                                                                          rounding)
        return train_readings(program, exact, data["weights"])
    picks = checked_chunks(run.seed, run.units, run.chunks_per_frame, tr["checked_chunks"])
    exact = reference_chunks(ref, cfg, tr, data, run.seed, picks)
    if as_program:
        prog = program_chunks(run.kept["frames"], picks, tr["chunk_size"])
    else:
        prog = reference_chunks(ref, cfg, tr, data, run.seed, picks, rounding)
    return render_readings(prog, exact)


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell's limits name: correct when it names some, and each reading is
    finite and within its limit. A limit without a reading fails."""
    table = {k: {"value": values.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    ok = bool(table) and all(math.isfinite(e["value"]) and e["value"] <= e["limit"] for e in table.values())
    return ok, table
