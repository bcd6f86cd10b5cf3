"""The port's TensoRF-VM field against the benchmark's plain reference
(``nerfbench/reference/tensorf.py``, ``F.grid_sample``), on the CPU at a
small size: a 16^3 grid, 4 density and 12 appearance components a plane,
256 points, seeded random weights.

The field's sigma and rgb and the gradient of every leaf, on the kernels'
route (their plain versions on CPU tensors) and on the plain route; points
outside the box, on its faces and at its corners (the edge texels); the VM
encode's plain forward and backward against ``grid_sample`` and its
autograd; one generic train step's loss and gradients against the
reference's; the parameter tree against the reference's ``layout``; the
config's port-only keys, the FLOP count, and a tiny ``run_train`` ->
resume -> ``run_render``. The VM kernels themselves need a Hopper card:
``test_vm_kernels_match_plain_versions_on_the_card`` skips here.
"""

import numpy as np
import pytest
import torch

from nerfbench.reference import optim as ref_optim
from nerfbench.reference import tensorf as ref
from torch_nerf_tpu_torch import config, session, train
from torch_nerf_tpu_torch.models import tensorf
from torch_nerf_tpu_torch.ops import launch_count, vm_grid
from torch_nerf_tpu_torch.renderer import RayUniforms
from torch_nerf_tpu_torch.runners import run_render, run_train

SMALL = ["network.vm_grid_res=16", "network.vm_density_components=4", "network.vm_app_components=12",
         "device.compute_dtype=float32"]


def small_cfg(*extra):
    return config.resolve("tensorf", SMALL + list(extra))


def ref_cfg(cfg) -> dict:
    """The reference's flat keys of a port config."""
    net = cfg.network
    out = {f"network.{k}": getattr(net, k) for k in config.TENSORF_KEYS}
    out["device.compute_dtype"] = cfg.device.compute_dtype
    return out


def points(n: int = 256, seed: int = 0):
    """Points in and around the box [-1.5, 1.5]^3, the first ones on its
    faces, edges and corners; unnormalised directions."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.8, 1.8, (n, 3))
    pts[:8] = [[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5], [1.5, -0.3, 0.2], [0.1, -1.5, 1.5], [0.4, 0.2, -1.5],
               [1.5001, 0.0, 0.0], [-1.6, 0.5, 0.5], [0.0, 0.0, 0.0]]
    dirs = rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, (n, 1))
    return torch.as_tensor(pts, dtype=torch.float32), torch.as_tensor(dirs, dtype=torch.float32)


def seeded(cfg, seed: int = 0):
    """The field's init, with the density lifted so that sigma is not ~0."""
    params = session.build_field(cfg).init(torch.Generator().manual_seed(seed), torch.device("cpu"))
    ref.prepare({"coarse": params}, ref_cfg(cfg))
    return params


def grads_of(fn, params):
    leaves = train.parameter_list(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    sigma, rgb = fn(params)
    gen = torch.Generator().manual_seed(5)
    loss = (sigma * torch.rand(sigma.shape, generator=gen)).sum() + (rgb * torch.rand(rgb.shape, generator=gen)).sum()
    return (sigma, rgb), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_field_and_its_gradients_match_the_reference(route):
    cfg = small_cfg(*(["parallel.use_pallas=false"] if route == "plain" else []))
    field = session.build_field(cfg)
    assert field.name == ("tensorf" if route == "kernel" else "tensorf_plain") and field.fused_cfg is None
    params = seeded(cfg)
    pts, dirs = points()
    launch_count.reset(vm_grid.vm_grid_fwd, vm_grid.vm_grid_bwd)
    (sigma, rgb), grads = grads_of(lambda p: field.apply(p, pts, dirs), params)
    assert [vm_grid.vm_grid_fwd.launches, vm_grid.vm_grid_bwd.launches] == [0, 0]  # no kernel on the CPU
    (rs, rr), rgrads = grads_of(lambda p: ref.field(p, pts, dirs, ref_cfg(cfg)), params)
    torch.testing.assert_close(sigma, rs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb, rr, rtol=1e-5, atol=1e-6)
    sigma = sigma.detach()
    assert bool((sigma[[5, 6]] == 0).all()) and bool((sigma[:5] > 0).all()) and float(sigma.min()) >= 0
    for (path, _), g, r in zip(ref_optim.leaves(params), grads, rgrads):
        assert float((g - r).norm()) <= 1e-5 * float(r.norm()) + 1e-7, path


def test_faces_and_corners_read_the_edge_texels():
    cfg = small_cfg()
    params = seeded(cfg)
    xhat = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]])
    sigma, app = vm_grid.vm_encode_reference(tensorf.factors_of(params), xhat)
    for row, texel in ((0, -1), (1, 0)):
        want_sigma = sum((params["density_plane"][str(m)][texel, texel] * params["density_line"][str(m)][texel]).sum()
                         for m in range(3))
        want_app = torch.cat([params["app_plane"][str(m)][texel, texel] * params["app_line"][str(m)][texel]
                              for m in range(3)])
        torch.testing.assert_close(sigma[row], want_sigma, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(app[row], want_app, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grid", [(16, 4, 12), (7, 3, 33)])
def test_vm_plain_versions_match_grid_sample(grid):
    r, cd, ca = grid
    cfg = config.resolve("tensorf", [f"network.vm_grid_res={r}", f"network.vm_density_components={cd}",
                                     f"network.vm_app_components={ca}"])
    params = seeded(cfg, seed=3)
    pts, _ = points(300, seed=4)
    xhat = tensorf.normalize_points(pts, 1.5)
    factors = tensorf.factors_of(params)
    leaves = [t.clone().requires_grad_(True) for t in factors.flat()]
    sigma, app = vm_grid.vm_encode_reference(vm_grid.Factors.of(leaves), xhat)
    tree = {key: {str(m): leaves[3 * i + m] for m in range(3)} for i, key in enumerate(tensorf.FACTOR_KEYS)}
    rs, ra = ref.vm_encode(tree, xhat)
    torch.testing.assert_close(sigma, rs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(app, ra, rtol=1e-5, atol=1e-6)
    assert bool((app[5:7] == 0).all())
    gen = torch.Generator().manual_seed(2)
    gs, ga = torch.randn(sigma.shape, generator=gen), torch.randn(app.shape, generator=gen)
    want = torch.autograd.grad((rs * gs).sum() + (ra * ga).sum(), leaves)
    got = vm_grid.vm_backward_reference(gs.double(), ga.double(), xhat, factors)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g.float(), w, rtol=1e-5, atol=1e-5)
    # the CPU wrappers and the autograd Function take the same plain versions
    s2, a2 = vm_grid.vm_encode(factors, xhat, torch.bfloat16)
    assert a2.dtype == torch.bfloat16 and torch.equal(a2, app.detach().to(torch.bfloat16))
    with pytest.raises(ValueError, match="do not fit"):
        vm_grid.grid_of(vm_grid.Factors.of(factors.flat()[:3] + factors.flat()[4:] + factors.flat()[3:4]))


def test_one_generic_train_step_matches_the_reference():
    cfg = small_cfg("renderer.num_samples_coarse=32", "renderer.num_pixels=48")
    field = session.build_field(cfg)
    settings = session.build_render_settings(cfg)
    params = {"coarse": seeded(cfg, seed=1)}
    gen = torch.Generator().manual_seed(9)
    n, s = 48, 32
    o = torch.tensor([0.3, -0.2, 4.0]).expand(n, 3).contiguous()
    d = torch.cat([torch.rand((n, 2), generator=gen) * 0.6 - 0.3, -torch.ones((n, 1))], dim=-1)
    gt = torch.rand((n, 3), generator=gen)
    rand = RayUniforms(torch.rand((n, s), generator=gen), torch.rand((n, s), generator=gen),
                       torch.zeros((n, 0)), torch.zeros((n, 0)))
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    metrics, grads = train.make_ray_grad_fn(field, settings)(params, o, d, gt, rand)
    rloss, _, rgrads = ref_optim.loss_and_grads(lambda p, x, v: ref.field(p, x, v, ref_cfg(cfg)), params, o, d, gt,
                                                list(rand), 2.0, 6.0, False, 16)
    assert abs(float(metrics["loss"]) - rloss) <= 1e-5 * rloss
    for (path, _), g, r in zip(ref_optim.leaves(params), grads, rgrads):
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-8, path


def test_tree_flops_and_config_keys():
    cfg = config.resolve("tensorf")
    rc = {**ref_cfg(cfg), "renderer.num_samples_fine": 0}
    params = session.build_field(small_cfg()).init(torch.Generator().manual_seed(0), torch.device("cpu"))
    small = ref.layout(ref_cfg(small_cfg()))
    assert {("coarse",) + path: tuple(t.shape) for path, t in ref_optim.leaves(params)} == \
        {path: shape for path, shape, _, _ in small}
    assert ref.macs_per_point(rc) == 40_048
    r = cfg.renderer
    assert session.estimate_flops_per_step(cfg) == 6 * 40_048 * r.num_pixels * r.num_samples_coarse
    assert (r.num_pixels, r.num_samples_coarse, r.num_samples_fine) == (4096, 800, 0)
    # the TensoRF keys are written for a TensoRF network only
    assert "vm_grid_res" in config.to_dict(cfg)["network"]
    assert "vm_grid_res" not in config.to_dict(config.resolve("instant_nerf"))["network"]
    assert config.from_dict(config.to_dict(cfg)) == cfg


def test_train_resume_render_on_cpu(tmp_path, capsys):
    tiny = SMALL + ["data.dataset_type=gaussian_blobs", "data.img_size=8", "data.num_views=2",
                    "renderer.num_pixels=32", "renderer.num_samples_coarse=16", "train_params.optim.num_iter=4",
                    "train_params.validation.validate_every=0", "train_params.log.epoch_btw_ckpt=1",
                    "train_params.log.epoch_btw_vis=100"]
    log_dir = tmp_path / "run"
    base = ["--config", "tensorf", "--log-dir", str(log_dir), "--device", "cpu"]
    first = run_train.main(base + ["--max-steps", "2"] + tiny)
    assert first["step"] == 2 and all(np.isfinite(first["losses"]))
    saved = torch.load(log_dir / "ckpt" / "ckpt_000002.pt", weights_only=True)["params"]["coarse"]
    assert saved["app_plane"]["1"].shape == (16, 16, 12)
    resumed = run_train.main(base + ["--max-steps", "4"] + tiny)
    assert "Resumed from step 2." in capsys.readouterr().out and resumed["step"] == 4
    out_dir = tmp_path / "render"
    run_render.main(["--log-dir", str(log_dir), "--render-test-views", "--num-views", "1", "--out-dir",
                     str(out_dir), "--device", "cpu"])
    assert (out_dir / "0000.png").exists()


def test_vm_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the VM kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = config.resolve("tensorf")
    factors = vm_grid.Factors.of([t.to(dev) for t in tensorf.factors_of(seeded(cfg)).flat()])
    pts, _ = points(4099, seed=6)
    xhat = tensorf.normalize_points(pts.to(dev), 1.5)
    for dtype in (torch.float32, torch.bfloat16):
        sigma, app = vm_grid.vm_grid_fwd(factors, xhat, dtype)
        rs, ra = vm_grid.vm_encode_reference(factors, xhat)
        torch.testing.assert_close(sigma, rs, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(app.float(), ra.to(dtype).float(), rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
                                   atol=1e-5)
        gs, ga = torch.randn_like(sigma), torch.randn_like(app)
        got = vm_grid.vm_grid_bwd(gs, ga, xhat, factors)
        want = vm_grid.vm_backward_reference(gs.double(), ga.double(), xhat, factors)
        for g, w in zip(got, want):
            assert float((g.double() - w).norm()) <= 1e-5 * float(w.norm())
