"""The port's occupancy-pruning slice against the JAX package.

Inputs are made with numpy from a seed at small sizes (R 8, 12-64 rays, 8 +
8 samples, feat 32, PE 4/2), and every JAX function compared with is
jitted. Tolerances: cell indices, occupancy, the quota and the selection
bit-exact; ``prune_t_samples`` ``t`` bit-exact and ``delta`` rtol 1e-6 with
atol 2.4e-7, an ulp of the prefix sums (at most t_far - t_near = 2 before
the 1e8 tail) whose difference a span is: XLA and torch add them in
another order. This on grids that leave some rays over budget
(the 1e8 tail absorbed into the last kept sample) and some under (padding
after the kept samples, out of ``t`` order); ``scatter_weights_to_bins``
equal but for samples within an ulp of a bin edge (XLA may divide by the
bin size as a product by its reciprocal), at most 1 in 100; ``update_grid``
on the same jitter within 1e-5. The pruned steps get JAX's draws: the loss
rtol 1e-4, the gradients rtol 2e-3 / atol 1e-6 (the dense step tests'), the
params after Adam within 1e-4 where the JAX gradient is above rounding
(Adam's first step moves a parameter by about lr * sign(g)); the bricked
NGP step as ``test_torch_port_ngp.py`` holds the dense one. The fused step
runs JAX's Pallas train kernel in interpret mode and the port's plain
version of kernel 3. Then the budget errors, the config clamps, the grid
sidecar, and ``run_train`` with occupancy on ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import checkpoints as jckpt
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu import occupancy as jocc
from torch_nerf_tpu import renderer as jrend
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu import train as jtrain
from torch_nerf_tpu.fields_ngp import make_instant_ngp_field as jmake_ngp
from torch_nerf_tpu_torch import checkpoints, config, occupancy, renderer, session, train
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.ops import sampling
from torch_nerf_tpu_torch.runners import run_render, run_train

L_POS, L_DIR, FEAT = 4, 2, 32
CFG = occupancy.OccupancyConfig(resolution=8, bound=1.5, threshold=0.5, keep_samples=6, warmup_steps=0,
                                update_every=2, keep_samples_fine=10)
JCFG = jocc.OccupancyConfig(**vars(CFG))
JNP_FIELD = jfields.make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
JAX_FUSED_FIELD = jfields.make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT,
                                          use_pallas=True, pallas_interpret=True)
PORT_FIELD = make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT,
                             compute_dtype=torch.float32)
PLAIN_FIELD = make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, use_kernel=False)
NGP_SMALL = dict(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _grid(seed=0, r=8):
    """Densities in [0, 1): about half the cells above the 0.5 threshold."""
    return np.random.default_rng(seed).uniform(size=(r**3,)).astype(np.float32)


def _rays(n, seed, near=0.5, far=2.5, s=16):
    """Rays through the grid, their colours and sorted stratified depths."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    gt = rng.uniform(size=(n, 3)).astype(np.float32)
    bins = np.linspace(near, far, s + 1, dtype=np.float32)[:-1]
    t = (bins + (far - near) / s * rng.uniform(size=(n, s))).astype(np.float32)
    return o, d, gt, t


# ---------------------------------------------------------------------------
# the grid, the quota and the pruned planes


def test_cells_occupancy_quota_and_selection_are_bit_exact():
    grid = _grid(1)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.0, 2.0, (64, 16, 3)).astype(np.float32)  # some outside the grid
    pts[0, :4] = [[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5], [0.0, 0.0, 0.0], [0.375, -0.75, 1.125]]  # cell edges
    cells = jax.jit(jocc.cell_indices, static_argnums=1)(jnp.asarray(pts), JCFG)
    np.testing.assert_array_equal(occupancy.cell_indices(_t(pts), CFG).numpy(), np.asarray(cells))
    for step in (0, 3):
        cfg, jconf = (CFG, JCFG) if step == 0 else (occupancy.OccupancyConfig(resolution=8, bound=1.5, warmup_steps=4),
                                                     jocc.OccupancyConfig(resolution=8, bound=1.5, warmup_steps=4))
        occ = occupancy.occupied_mask(_t(grid), _t(pts), cfg, step)
        jmask = jax.jit(jocc.occupied_mask, static_argnums=2)(jnp.asarray(grid), jnp.asarray(pts), jconf, jnp.int32(step))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jmask))
        assert occ.all() if step < cfg.warmup_steps else 0.2 < occ.float().mean() < 0.8
    occ = occupancy.occupied_mask(_t(grid), _t(pts), CFG, 0)
    occ[1] = False  # a ray with nothing occupied
    for keep in (1, 4, 6, 16):
        jocc_arr = jnp.asarray(occ.numpy())
        np.testing.assert_array_equal(occupancy.quota_keep_mask(occ, keep).numpy(),
                                      np.asarray(jax.jit(jocc.quota_keep_mask, static_argnums=1)(jocc_arr, keep)))
        np.testing.assert_array_equal(occupancy.select_samples(occ, keep).numpy(),
                                      np.asarray(jax.jit(jocc.select_samples, static_argnums=1)(jocc_arr, keep)))


@pytest.mark.parametrize("keep,s", [(6, 16), (4, 16), (10, 16), (16, 16)])
def test_prune_t_samples_matches_jax(keep, s):
    grid = _grid(3)
    o, d, _, t = _rays(64, seed=keep, s=s)
    jt, jdelta = jax.jit(jocc.prune_t_samples, static_argnames=("cfg", "keep"))(
        jnp.asarray(grid), JCFG, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.int32(0), keep=keep)
    got_t, got_delta = occupancy.prune_t_samples(_t(grid), CFG, _t(o), _t(d), _t(t), 0, keep=keep)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(got_delta.numpy(), np.asarray(jdelta), rtol=1e-6, atol=2.4e-7)
    # both regimes are on these planes: rays over budget whose last kept
    # sample took the 1e8 tail, and rays with padding placed after the kept
    # samples, out of t order
    m = occupancy.quota_keep_mask(occupancy.occupied_mask(
        _t(grid), sampling.points_along_rays(_t(o), _t(d), _t(t)), CFG, 0), keep).sum(-1)
    tail = got_delta[:, -1] >= 1e7
    unsorted = (got_t[:, 1:] < got_t[:, :-1]).any(-1)
    if keep < s:
        assert (tail & (m == keep)).any() and (unsorted & (m < keep)).any()


def test_scatter_weights_to_bins_matches_jax():
    rng = np.random.default_rng(5)
    o, d, _, t = _rays(64, seed=5, s=16)
    t_sel, _ = occupancy.prune_t_samples(_t(_grid(6)), CFG, _t(o), _t(d), _t(t), 0, keep=6)
    w = rng.uniform(size=t_sel.shape).astype(np.float32)
    got = occupancy.scatter_weights_to_bins(t_sel, _t(w), 0.5, 2.5, 16).numpy()
    ref = np.asarray(jax.jit(jocc.scatter_weights_to_bins, static_argnums=(2, 3, 4))(
        jnp.asarray(t_sel.numpy()), jnp.asarray(w), 0.5, 2.5, 16))
    np.testing.assert_allclose(got.sum(-1), w.sum(-1), rtol=1e-6)
    mismatched_rays = (got != ref).any(-1).sum()
    assert mismatched_rays <= max(1, got.shape[0] // 100)
    np.testing.assert_allclose(got.sum(-1), ref.sum(-1), rtol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "fused", "bricked"])
def test_update_grid_matches_jax_on_the_same_jitter(kind):
    if kind == "bricked":
        jfield = jmake_ngp(**NGP_SMALL, table_layout="bricked")
        field = make_instant_ngp_field(**NGP_SMALL, table_layout="bricked")
        jparams = _np(jfield.init(jax.random.PRNGKey(2)))
        jparams["tables"] = jparams["tables"] * 1e4  # features that carry through the field
        jtree = {"coarse": jparams}
    else:
        jfield = JNP_FIELD if kind == "plain" else JAX_FUSED_FIELD
        field = PLAIN_FIELD if kind == "plain" else PORT_FIELD
        jtree = {"coarse": _np(JNP_FIELD.init(jax.random.PRNGKey(2))), "fine": _np(JNP_FIELD.init(jax.random.PRNGKey(9)))}
        # a density bias, so that sigma = relu(.) is above 0 at some cells
        jtree["coarse"]["fc_8"]["b"] = jtree["coarse"]["fc_8"]["b"] + np.eye(33, dtype=np.float32)[0] * 0.05
    grid = _grid(7) * 1e-3  # below the densities of the random field
    key = jax.random.PRNGKey(11)
    jgrid = jax.jit(lambda g, p, k: jocc.update_grid(g, jocc.make_density_fn(jfield), p, k, JCFG))(
        jnp.asarray(grid), jtree, key)
    jitter = _t(jax.random.uniform(key, (8**3, 3), jnp.float32))
    params = params_from_jax(jtree)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)  # as in training: the sweep builds no graph
    got = occupancy.update_grid(_t(grid), occupancy.make_density_fn(field), params, jitter, CFG)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jgrid), rtol=1e-5, atol=1e-5)
    assert (got.numpy() > CFG.decay * grid).any()  # the densities reached the grid
    # maybe_update_grid sweeps on every update_every-th step only
    assert occupancy.maybe_update_grid(_t(grid), None, params, None, 1, CFG).equal(_t(grid))
    with pytest.raises(ValueError, match="jitter"):
        occupancy.maybe_update_grid(_t(grid), None, params, None, 2, CFG)


# ---------------------------------------------------------------------------
# the pruned steps, with JAX's draws


def _port_state(jtree, optim):
    params = params_from_jax(jtree)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


def _render_uniforms(render_key, n, sc, sf):
    """The draws of JAX's pruned passes from their key: the single-pass
    loss draws its jitter from the key itself, the hierarchical ones split
    it as ``draw_train_randomness`` does."""
    if sf == 0:
        return renderer.RayUniforms(_t(jax.random.uniform(render_key, (n, sc), jnp.float32)), torch.zeros((n, sc)),
                                    torch.zeros((n, 0)), torch.zeros((n, 0)))
    rand = jtrain.draw_train_randomness(render_key, n, jrend.RenderSettings(num_samples_coarse=sc, num_samples_fine=sf))
    return renderer.RayUniforms(_t(rand["coarse_jitter"]), _t(rand["fine_coarse_jitter"]), _t(rand["fine_u"]),
                                _t(rand["fine_jitter"]))


def _check_step(jfield, field, jtree, settings, jsettings, optim, joptim, occ_cfg, jocc_cfg, seed, atol_params):
    """One occupancy step of both packages from the same params, grid and
    draws; returns the port's metrics."""
    n, sc, sf = 12, settings.num_samples_coarse, settings.num_samples_fine
    o, d, gt, _ = _rays(n, seed)
    grid = _grid(seed)
    key = jax.random.PRNGKey(seed)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt))
    state0 = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=jtree,
                               opt_state=jtrain.make_optimizer(joptim).init(jtree))
    jstep = jax.jit(jtrain.make_ray_train_step(jfield, jsettings, joptim, occupancy_cfg=jocc_cfg))
    jstate, jgrid, jmetrics = jstep(state0, jnp.asarray(grid), *args, key)

    occ_key, render_key, _ = jax.random.split(key, 3)
    jitter = _t(jax.random.uniform(occ_key, (occ_cfg.resolution**3, 3), jnp.float32))
    # JAX's gradients at the swept grid, for the tolerance on the params
    loss_fn = jtrain.pruned_hierarchical_loss_fn if sf else jtrain.pruned_ray_loss_fn
    grad_field = JNP_FIELD if jfield is JAX_FUSED_FIELD else jfield
    jgrads = jax.jit(jax.grad(lambda p, g: loss_fn(grad_field, p, g, jocc_cfg, *args, render_key, jsettings,
                                                   jnp.int32(0))[0]))(jtree, jgrid)
    state = _port_state(jtree, optim)
    step = train.make_ray_train_step(field, settings, optim, occupancy_cfg=occ_cfg)
    state, grid_out, metrics = step(state, _t(grid), _t(o), _t(d), _t(gt), _render_uniforms(render_key, n, sc, sf),
                                    None, jitter)
    assert state.step == 1
    np.testing.assert_allclose(grid_out.numpy(), np.asarray(jgrid), rtol=1e-5, atol=1e-5)
    assert set(metrics) == set(jmetrics)
    for name in jmetrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]), rtol=1e-4, err_msg=name)
    jflat = [np.asarray(g) for g in train.parameter_list(_np(jgrads))]
    scale = max(np.abs(g).max() for g in jflat)
    for leaf, ref, jg in zip(train.parameter_list(state.params), train.parameter_list(_np(jstate.params)), jflat):
        keep = np.abs(jg) > 1e-6 * scale
        np.testing.assert_allclose(leaf.detach().numpy()[keep], np.asarray(ref)[keep], rtol=0, atol=atol_params)
    return metrics


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("fine,keep_fine", [(0, 0), (8, 10), (8, 0)])
def test_pruned_ray_train_step_matches_jax(fused, fine, keep_fine):
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=fine, t_near=0.5, t_far=2.5)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=fine, t_near=0.5, t_far=2.5)
    occ_cfg = occupancy.OccupancyConfig(**{**vars(CFG), "keep_samples": 6, "keep_samples_fine": keep_fine})
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    jtree = {"coarse": _np(JNP_FIELD.init(jax.random.PRNGKey(0)))}
    if fine:
        jtree["fine"] = _np(JNP_FIELD.init(jax.random.PRNGKey(1)))
    metrics = _check_step(JAX_FUSED_FIELD if fused else JNP_FIELD, PORT_FIELD if fused else PLAIN_FIELD, jtree,
                          settings, jsettings, optim, joptim, occ_cfg, jocc.OccupancyConfig(**vars(occ_cfg)),
                          seed=20 + fine + keep_fine, atol_params=1e-4)
    assert np.isfinite(metrics["loss"].item())


def test_fused_pruned_loss_and_grad_matches_jax():
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=8, t_near=0.5, t_far=2.5)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=8, t_near=0.5, t_far=2.5)
    jtree = {"coarse": _np(JNP_FIELD.init(jax.random.PRNGKey(3))), "fine": _np(JNP_FIELD.init(jax.random.PRNGKey(4)))}
    o, d, gt, _ = _rays(16, seed=6)
    grid = _grid(8)
    key = jax.random.PRNGKey(6)
    jfn = jax.jit(jtrain.fused_pruned_loss_and_grad, static_argnames=("field", "occ_cfg", "settings"))
    jmetrics, jgrads = jfn(JAX_FUSED_FIELD, jtree, jnp.asarray(grid), JCFG, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(gt), key, jsettings, jnp.int32(0))
    metrics, grads = train.fused_pruned_loss_and_grad(PORT_FIELD, params_from_jax(jtree), _t(grid), CFG, _t(o), _t(d),
                                                      _t(gt), _render_uniforms(key, 16, 8, 8), settings, 0)
    for name in jmetrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]), rtol=1e-4, err_msg=name)
    for got, ref in zip(train.parameter_list(grads), train.parameter_list(_np(jgrads))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-6)


def test_pruned_bricked_ngp_step_matches_jax():
    jfield = jmake_ngp(**NGP_SMALL, table_layout="bricked")
    field = make_instant_ngp_field(**NGP_SMALL, table_layout="bricked")
    jparams = _np(jfield.init(jax.random.PRNGKey(6)))
    jparams["tables"] = jparams["tables"] * 1e4
    settings = renderer.RenderSettings(num_samples_coarse=16, num_samples_fine=0, t_near=0.5, t_far=2.5)
    jsettings = jrend.RenderSettings(num_samples_coarse=16, num_samples_fine=0, t_near=0.5, t_far=2.5)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    occ_cfg = occupancy.OccupancyConfig(**{**vars(CFG), "keep_samples": 8, "threshold": 1.0})
    metrics = _check_step(jfield, field, {"coarse": jparams}, settings, jsettings, optim, joptim, occ_cfg,
                          jocc.OccupancyConfig(**vars(occ_cfg)), seed=31, atol_params=1e-5)
    assert set(metrics) == {"coarse_loss", "loss"}


# ---------------------------------------------------------------------------
# budgets, config, sidecar, CLI


def test_budget_errors_and_config_clamps_match_jax(capsys):
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    for bad in (dict(keep_samples=9), dict(keep_samples=8, keep_samples_fine=17)):
        with pytest.raises(ValueError) as err:
            train.make_ray_train_step(PORT_FIELD, settings, train.OptimConfig(),
                                      occupancy_cfg=occupancy.OccupancyConfig(**bad))
        with pytest.raises(ValueError) as jerr:
            jtrain.make_ray_train_step(JNP_FIELD, jsettings, jtrain.OptimConfig(),
                                       occupancy_cfg=jocc.OccupancyConfig(**bad))
        assert str(err.value) == str(jerr.value)
    train.make_ray_train_step(PORT_FIELD, settings, train.OptimConfig(),
                              occupancy_cfg=occupancy.OccupancyConfig(keep_samples=8, keep_samples_fine=16))
    for over in ([], ["occupancy.enabled=true"],
                 ["occupancy.enabled=true", "occupancy.keep_samples=100", "occupancy.keep_samples_fine=300"]):
        over = over + ["renderer.num_samples_coarse=64", "renderer.num_samples_fine=128"]
        got = session.build_occupancy_cfg(config.resolve("default", over))
        out = capsys.readouterr().out
        ref = jsession.build_occupancy_cfg(jcfg.resolve("default", over))
        assert capsys.readouterr().out == out
        assert (got is None) == (ref is None)
        if got is not None:
            assert vars(got) == vars(ref)
    assert "clamped to renderer.num_samples_coarse=64" in out and "merged fine candidate count 192" in out
    assert session.estimate_flops_per_step(config.resolve("default", over)) == \
        jsession.estimate_flops_per_step(jcfg.resolve("default", over))


def test_grid_sidecar_round_trip_is_bit_exact(tmp_path):
    state = train.create_train_state(torch.Generator().manual_seed(0), PORT_FIELD,
                                     renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0),
                                     train.OptimConfig())
    grid = _t(_grid(9))
    path = checkpoints.save_checkpoint(tmp_path, 5, state.params, occ_grid=grid)
    assert checkpoints.occ_sidecar_path(path).name == "ckpt_000005.occ.npy"
    assert checkpoints.load_occupancy_grid(path).equal(grid)
    # the JAX package reads the same file
    np.testing.assert_array_equal(jckpt.load_occupancy_grid(tmp_path / "ckpt" / "ckpt_000005"), grid.numpy())
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["ckpt_000005.occ.npy", "ckpt_000005.pt"]
    assert checkpoints.latest_checkpoint(tmp_path) == path
    # a checkpoint without a sidecar still loads, and has no grid
    path6 = checkpoints.save_checkpoint(tmp_path, 6, state.params)
    assert checkpoints.load_occupancy_grid(path6) is None and checkpoints.load_checkpoint(path6)["step"] == 6


OCC_OVERRIDES = [
    "data.dataset_type=gaussian_blobs",
    "data.img_size=16",
    "data.num_views=4",
    f"network.feat_dim={FEAT}",
    f"signal_encoder.coord_encode_level={L_POS}",
    f"signal_encoder.dir_encode_level={L_DIR}",
    "renderer.num_pixels=64",
    "renderer.num_samples_coarse=8",
    "renderer.num_samples_fine=8",
    "train_params.optim.num_iter=8",
    "train_params.validation.validate_every=1000",
    "train_params.log.epoch_btw_ckpt=1",
    "train_params.log.epoch_btw_vis=1000",
    "occupancy.enabled=true",
    "occupancy.resolution=8",
    "occupancy.keep_samples=6",
    "occupancy.keep_samples_fine=10",
    "occupancy.warmup_steps=2",
    "occupancy.update_every=2",
]


@pytest.mark.parametrize("preset", ["default", "instant_nerf_tpu"])
def test_occupancy_cli_round_trip_on_cpu(tmp_path, capsys, preset):
    over = OCC_OVERRIDES
    if preset == "instant_nerf_tpu":
        over = over + ["network.log_max_entry_per_level=10", "network.max_res=32", "renderer.num_samples_coarse=16",
                       "renderer.num_samples_fine=0", "occupancy.keep_samples_fine=0"]
    run = tmp_path / "run"
    base = ["--config", preset, "--log-dir", str(run), "--device", "cpu"]
    first = run_train.main(base + ["--max-steps", "8"] + over)
    assert first["step"] == 8 and all(np.isfinite(first["losses"]))
    sidecars = sorted(p.name for p in (run / "ckpt").glob("*.occ.npy"))
    assert sidecars == [f"ckpt_{s:06d}.occ.npy" for s in (4, 8)]
    grid8 = checkpoints.load_occupancy_grid(run / "ckpt" / "ckpt_000008.pt")
    assert grid8.shape == (8**3,) and (grid8 > 0).any()
    capsys.readouterr()
    # a resume that runs no step saves the grid it restored: the same bytes
    saved = (run / "ckpt" / "ckpt_000008.occ.npy").read_bytes()
    run_train.main(base + ["--max-steps", "8"])
    assert "Resumed from step 8" in capsys.readouterr().out
    assert (run / "ckpt" / "ckpt_000008.occ.npy").read_bytes() == saved
    # without the sidecar the grid is rebuilt from the restored field
    (run / "ckpt" / "ckpt_000008.occ.npy").unlink()
    resumed = run_train.main(base + ["--max-steps", "10", "train_params.optim.num_iter=12"])
    assert resumed["step"] == 10 and all(np.isfinite(resumed["losses"]))
    assert (checkpoints.load_occupancy_grid(run / "ckpt" / "ckpt_000010.pt") > 0).any()
    out_dir = tmp_path / "render"
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "1", "--out-dir", str(out_dir),
                     "--device", "cpu"])
    assert (out_dir / "0000.png").exists()
