"""Multi-rank dry run: one sharded train step of each parallel path.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (:46), on N ranks
under torchrun, each check printing its loss:

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m torch_nerf_tpu_torch.runners.dryrun_multichip [--device cpu] [--dist-backend gloo]

(a) the classic field's generic step data x tensor parallel ((N / 2) x 2
when N is even and at least 4, else N x 1); (b) the fused DP step (the
fused train pass, kernel 3 on the card); (c) the bricked Instant-NGP image
step with occupancy pruning, a sweep included; (d) scenes over the ranks,
one a rank, with the plain field; (e) the same with the fused field. Tiny
shapes, seeded draws; every loss must be finite. A rank that fails fails
the launch.
"""

from __future__ import annotations

import argparse
import math

import torch

from torch_nerf_tpu_torch import multiscene, occupancy, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.parallel import mesh as pmesh
from torch_nerf_tpu_torch.parallel import steps as psteps
from torch_nerf_tpu_torch.renderer import RenderSettings


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="One sharded train step of each parallel path.")
    parser.add_argument("--device", default=None, help="cuda (default, the card) or cpu")
    parser.add_argument("--dist-backend", choices=pmesh.BACKENDS, default=None,
                        help="the process group's backend (default: nccl on the card, gloo on the CPU)")
    return parser.parse_args(argv)


def _finite(name: str, metrics) -> float:
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss from {name}: {loss}")
    return loss


def _rays(n: int, device):
    gen = torch.Generator(device=device).manual_seed(0)
    o = torch.randn((n, 3), generator=gen, device=device)
    d = torch.randn((n, 3), generator=gen, device=device)
    return o, d, torch.rand((n, 3), generator=gen, device=device)


def run_checks(device: torch.device) -> dict:
    """The five checks on the joined world: ``{check: loss}``."""
    world = torch.distributed.get_world_size()
    # the kernels take bf16 on the card; the plain versions run f32 here
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    field = make_nerf_field(coord_encode_level=4, dir_encode_level=2, feat_dim=64, compute_dtype=dtype)
    plain = make_nerf_field(coord_encode_level=4, dir_encode_level=2, feat_dim=64, compute_dtype=dtype,
                            use_kernel=False)
    settings = RenderSettings(num_samples_coarse=16, num_samples_fine=16)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    model = 2 if world % 2 == 0 and world >= 4 else 1
    tp_mesh = pmesh.make_mesh(device, model_size=model)
    dp_mesh = pmesh.make_mesh(device)
    o, d, gt = _rays(16 * world, device)
    losses = {}

    def ray_step(name, field, mesh, force_generic):
        state = train.create_train_state(torch.Generator(device=device).manual_seed(0), field, settings, optim, device)
        state = pmesh.place_state(mesh, state, optim)
        step = psteps.make_sharded_train_step(field, settings, optim, mesh, force_generic)
        rand = train.draw_train_randomness(torch.Generator(device=device).manual_seed(1), o.shape[0], settings)
        state, metrics = step(state, o, d, gt, rand)
        if state.step != 1:
            raise RuntimeError(f"{name}: step {state.step} after one step")
        losses[name] = _finite(name, metrics)

    ray_step("dp+tp" if model > 1 else "dp", field, tp_mesh, True)
    ray_step("fused_dp", field, dp_mesh, False)

    images, poses, camera, _ = synthetic.make_dataset(num_views=2, img_size=16, device=device)
    images, poses = torch.as_tensor(images, device=device), torch.as_tensor(poses, device=device)
    ngp = make_instant_ngp_field(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=8,
                                 table_layout="bricked")
    ngp_settings = RenderSettings(num_samples_coarse=16, num_samples_fine=0)
    occ = occupancy.OccupancyConfig(resolution=4, keep_samples=8, warmup_steps=1, update_every=2)
    state = train.create_train_state(torch.Generator(device=device).manual_seed(4), ngp, ngp_settings, optim, device)
    state = pmesh.place_state(dp_mesh, state, optim)
    step = psteps.make_sharded_image_train_step(ngp, ngp_settings, optim, camera, dp_mesh, 16 * world,
                                                occupancy_cfg=occ)
    gen = torch.Generator(device=device).manual_seed(5)
    grid = occupancy.init_grid(occ, device)
    for _ in range(2):  # a sweep at step 0, pruning by the grid at step 1
        state, grid, metrics = step(state, grid, images, poses, gen)
    losses["ngp_bricked_occ"] = _finite("ngp_bricked_occ", metrics)

    pools = images.expand(1, *images.shape), poses.expand(1, *poses.shape)
    for name, scene_field in (("multiscene", plain), ("multiscene_fused", field)):
        state = multiscene.create_multiscene_state(multiscene.scene_generators(6, world, device), scene_field,
                                                   settings, optim, world, device)
        state = pmesh.place_state(dp_mesh, state, optim, pmesh.scene_spec(state.params), "data")
        step = psteps.make_multiscene_shard_step(scene_field, settings, optim, camera, world, dp_mesh, 16)
        gens = multiscene.scene_generators(7, world, device)[step.scenes.start:step.scenes.stop]
        _, metrics = step(state, *pools, gens)
        losses[name] = _finite(name, metrics)
    return {"mesh": {"data": tp_mesh.data_size, "model": tp_mesh.model_size}, "losses": losses}


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = pmesh.join_from_env(args.dist_backend, args.device)
    result = run_checks(device)
    if torch.distributed.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={result['mesh']}, "
              + ", ".join(f"{k}:loss={v:.5f}" for k, v in result["losses"].items()), flush=True)
    pmesh.destroy_mesh()
    return result


if __name__ == "__main__":
    main()
