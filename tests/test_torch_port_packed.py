"""The port's packed and packed_dual layouts against the JAX package.

The same numpy-seeded inputs go through both packages at small sizes (L 2-3,
log T 10, 301 points: uniform in [-1.5, 1.5], negative, integral on every
or two axes, far (|x| <= 900) and on a staggered level's half-integer
plane; N not a multiple of 128). JAX's folded encode runs as its own tests
run it on the CPU: the Pallas kernels in interpret mode
(``hash_encode_packed128(..., interpret=True)``, f32 placement) and the XLA
path; every JAX call is jitted, because XLA then computes ``res * x + off``
with one rounding, as the port does (eager JAX rounds twice, which moves
``frac`` by an ulp of ``scaled`` for the dual layout's offset of 0.5). The
port's kernel wrappers run their plain versions on CPU tensors.

Tolerances: the packed rows bit-exact; the weights 1e-7 abs (the same f32
operations); encodes and table grads rtol 1e-5 / atol 1e-6 (the same sums
in another order); the model and field rtol 1e-5 / atol 1e-6; the render
atol 1e-4 (the composite's sums in another order, amplified by 2^x); the
smoothness loss and its grads rtol 1e-5; a train step's loss rtol 1e-5 and
its params after Adam 1e-5 where the JAX gradient is above rounding (Adam's
first step at eps 1e-15 moves a parameter by about lr * sign(g)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import renderer as jrend
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu import train as jtrain
from torch_nerf_tpu.fields_ngp import make_encode_smoothness_loss as jmake_smoothness
from torch_nerf_tpu.fields_ngp import make_instant_ngp_field as jmake_field
from torch_nerf_tpu.models import hash_math as jhash_math
from torch_nerf_tpu.models import instant_ngp as jngp
from torch_nerf_tpu_torch import cameras, checkpoints, config, renderer, session, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields_ngp import SmoothnessDraws, make_encode_smoothness_loss, make_instant_ngp_field
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.models import hash_math, instant_ngp
from torch_nerf_tpu_torch.models.nerf import params_from_jax, params_to_jax
from torch_nerf_tpu_torch.ops import hash_grid, launch_count
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=16)
LAYOUTS = ("packed", "packed_dual")
FOLD = (hash_grid.hash_fold_fwd, hash_grid.hash_fold_bwd)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(res, seed=0):
    """301 points: 250 uniform in [-1.5, 1.5]^3, 12 negative, 6 integral on
    every axis and 6 on two (the all-zero-weight quirk on base levels), 12
    far out, 15 on a half-integer plane of level 0 (integral on its
    staggered level)."""
    rng = np.random.default_rng(seed)
    integral = rng.integers(-3, 4, (12, 3)).astype(np.float32)
    integral[6:, 0] += 0.3
    half = rng.uniform(-1.5, 1.5, (15, 3))
    half[:, 1] = (rng.integers(-20, 20, 15) + 0.5) / res[0]
    pts = np.concatenate([
        rng.uniform(-1.5, 1.5, (250, 3)),
        -rng.uniform(0.0, 3.0, (12, 3)),
        integral,
        rng.uniform(-900.0, 900.0, (12, 3)),
        half,
    ]).astype(np.float32)
    assert pts.shape[0] % 128 and pts[262:268].astype(np.int64).astype(np.float32).tolist() == pts[262:268].tolist()
    return pts


def _grid(layout, res):
    """(resolutions, offsets) of a layout's pseudo-levels, as numpy."""
    if layout == "packed_dual":
        r, o = jngp.dual_resolutions_offsets(jnp.asarray(res))
        return np.asarray(r), np.asarray(o)
    return np.asarray(res), np.zeros_like(res)


# ---------------------------------------------------------------------------
# the packed lookup and the encode


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("feat_dim", [1, 4, 16])
def test_packed_prep_rows_bit_exact_and_weights(layout, feat_dim):
    res = jngp.level_resolutions(3, 4, 16)
    r, o = _grid(layout, res)
    pts = _points(res, seed=feat_dim)
    rows = 2**10 // 8
    fold = 128 // (8 * feat_dim)
    jidx, jw128 = jax.jit(lambda p: jhash_math.packed_prep(p, jnp.asarray(r), rows, feat_dim, jnp.asarray(o)))(
        jnp.asarray(pts))
    row, w = hash_math.packed_prep(_t(pts), _t(r), rows, _t(o))
    assert row.dtype == torch.int64 and row.shape == (r.shape[0], 301) and w.shape == (r.shape[0], 301, 8)
    assert row.min() >= 0 and row.max() < rows
    np.testing.assert_array_equal((row // fold).numpy(), np.asarray(jidx))
    # JAX's slotted 128-lane weight line, rebuilt from the rows and weights:
    # lane 8F*slot + F*c + f carries corner c's weight
    w128 = np.zeros((r.shape[0], 301, 128), np.float32)
    lanes = (8 * feat_dim * (row % fold).numpy()[..., None, None] + feat_dim * np.arange(8)[:, None]
             + np.arange(feat_dim)).reshape(r.shape[0], 301, -1)
    np.put_along_axis(w128, lanes, np.repeat(w.numpy(), feat_dim, axis=-1), axis=-1)
    np.testing.assert_allclose(w128, np.asarray(jw128), rtol=0, atol=1e-7)
    # the quirk on the base levels only: the staggered ones see a half-integer
    assert w[:3, 262:274].abs().max() == 0.0
    if layout == "packed_dual":
        assert w[3:, 262:268].abs().min() > 0.0
        # on the staggered level 0's integral plane, the weights vanish there
        assert w[3, 286:].abs().max() == 0.0 and w[0, 286:].abs().min() > 0.0


def _port_encode_and_grad(encode, tables, pts, r, o, f):
    tt = _t(tables).requires_grad_(True)
    out = encode(tt, _t(pts), _t(r), _t(o), f)
    torch.sum(out**2).backward()
    return out.detach().numpy(), tt.grad.numpy()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("feat_dim", [1, 2, 4, 8, 16])
def test_fold_encode_matches_jax_kernel_and_xla(layout, feat_dim):
    num_level = 2 if feat_dim == 16 else 3
    res = jngp.level_resolutions(num_level, 4, 16)
    r, o = _grid(layout, res)
    levels = r.shape[0]
    tables = np.asarray(jngp.init_packed_hash_table(jax.random.PRNGKey(feat_dim), levels, 10, feat_dim)) * 1e4
    pts = _points(res, seed=7 * feat_dim)

    def jloss(t, interpret):
        out = jngp.hash_encode_packed128(t, jnp.asarray(pts), jnp.asarray(r), feat_dim, interpret=interpret,
                                         offsets=jnp.asarray(o))
        return jnp.sum(out**2), out

    port = {
        "kernel_route": _port_encode_and_grad(hash_grid.fold_encode, tables, pts, r, o, feat_dim),
        "autograd": _port_encode_and_grad(hash_grid.fold_encode_reference, tables, pts, r, o, feat_dim),
    }
    for interpret in (True, False):
        (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True), static_argnums=1)(
            jnp.asarray(tables), interpret)
        jout = np.asarray(jout)
        assert np.abs(jout[:, levels * feat_dim:]).max() == 0.0
        for out, grad in port.values():
            assert out.shape == (301, levels * feat_dim)
            np.testing.assert_allclose(out, jout[:, : levels * feat_dim], **TOL)
            np.testing.assert_allclose(grad, np.asarray(jgrad), **TOL)
    out = port["kernel_route"][0]
    base = num_level * feat_dim
    assert np.abs(out[262:274, :base]).max() == 0.0 and np.abs(out[:250]).min(axis=1).max() > 0.0
    if layout == "packed_dual":
        assert np.abs(out[262:268, base:]).max() > 0.0
    # the packed-row helpers: the folded table is a pure reshape of the packed one
    unfolded = instant_ngp.unfold_packed_table(_t(tables), feat_dim)
    np.testing.assert_array_equal(unfolded.numpy(), np.asarray(jngp.unfold_packed_table(jnp.asarray(tables), feat_dim)))
    assert instant_ngp.hash_encode_packed(_t(tables), _t(pts), _t(r), feat_dim, _t(o)).shape == out.shape


def test_fold_layout_checks():
    for bad in (3, 32):
        with pytest.raises(ValueError, match="feat_dim must divide 16 lanes"):
            hash_grid.fold_factor(bad)
    with pytest.raises(ValueError, match="too small for feat_dim=2"):
        instant_ngp.init_packed_hash_table(torch.Generator(), 2, 5, 2)
    with pytest.raises(ValueError, match="too small"):
        jngp.init_packed_hash_table(jax.random.PRNGKey(0), 2, 5, 2)
    with pytest.raises(ValueError, match="power-of-two row count"):
        hash_grid.check_fold_layout((2, 3, 128), 16)
    with pytest.raises(ValueError, match="folded packed tables"):
        hash_grid.check_fold_layout((2, 16, 64), 2)
    assert hash_grid.check_fold_layout((16, 8192, 128), 2) == 2**16
    assert instant_ngp.init_packed_hash_table(torch.Generator(), 2, 7, 16).shape == (2, 16, 128)
    r, o = instant_ngp.dual_resolutions_offsets(torch.tensor([4.0, 16.0]))
    jr, jo = jngp.dual_resolutions_offsets(jnp.asarray([4.0, 16.0]))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


# ---------------------------------------------------------------------------
# model, field, render


def _jax_packed_params(layout, seed=0):
    jfield = jmake_field(**SMALL, table_layout=layout)
    params = _np(jfield.init(jax.random.PRNGKey(seed)))
    params["tables"] = params["tables"] * 1e4  # features above the MLPs' biases
    return jfield, params


@pytest.mark.parametrize("layout", LAYOUTS)
def test_instant_ngp_apply_and_field_match_jax(layout):
    jfield, jparams = _jax_packed_params(layout, seed=1)
    res = jngp.level_resolutions(3, 4, 16)
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.5, 1.5, (4, 16, 3)).astype(np.float32)
    dir_enc = rng.normal(size=(4, 16, 16)).astype(np.float32)
    japply = jax.jit(lambda p, x, d: jngp.instant_ngp_apply(p, x, d, jnp.asarray(res), table_layout=layout))
    jsigma, jrgb = japply(jparams, jnp.asarray(pos), jnp.asarray(dir_enc))
    params = params_from_jax(jparams)
    for use_kernel in (True, False):
        sigma, rgb = instant_ngp.instant_ngp_apply(params, _t(pos), _t(dir_enc), _t(res), table_layout=layout,
                                                   use_kernel=use_kernel)
        assert sigma.shape == (4, 16) and rgb.shape == (4, 16, 3)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), **TOL)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOL)
    # the field, on unnormalised directions; the folded tables round-trip
    field = make_instant_ngp_field(**SMALL, table_layout=layout)
    dirs = rng.normal(size=(4, 16, 3)).astype(np.float32) * 2.0
    jsigma, jrgb = jax.jit(jfield.apply)(jparams, jnp.asarray(pos), jnp.asarray(dirs))
    sigma, rgb = field.apply(params, _t(pos), _t(dirs))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), **TOL)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOL)
    back = params_from_jax(params_to_jax(params))
    for a, b in zip(train.parameter_list(back), train.parameter_list(params)):
        assert torch.equal(a, b)
    mine = field.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(np.shape, params_to_jax(mine)) == jax.tree_util.tree_map(np.shape, jparams)
    assert float(mine["tables"].abs().max()) <= 1e-4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_render_image_of_packed_field_matches_jax(layout):
    jfield, jparams = _jax_packed_params(layout, seed=5)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    pose = synthetic.split_poses(2, "test")[1]
    key = jax.random.PRNGKey(3)
    ref = jrend.render_image(jfield, jparams, None, jcam.CameraParams(19.2, 19.2, 12, 12),
                             jnp.asarray(pose), key, jsettings, chunk_size=48)

    def uniforms(first_pixel, n):
        coarse_key, _ = jax.random.split(jax.random.fold_in(key, jnp.int32(first_pixel)))
        coarse = _t(jax.random.uniform(coarse_key, (n, 8), jnp.float32))
        empty = torch.zeros((n, 0))
        return renderer.RayUniforms(coarse, torch.zeros_like(coarse), empty, empty)

    img = renderer.render_image(
        make_instant_ngp_field(**SMALL, table_layout=layout), params_from_jax(jparams), None,
        cameras.CameraParams(19.2, 19.2, 12, 12), _t(pose), 3, settings, chunk_size=48,
        uniforms_for_chunk=uniforms,
    )
    assert img.shape == (12, 12, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the smoothness loss, and one Adam step with it


def _jax_draws(key, levels, probes, bound=2.5):
    """The draws ``fields_ngp.make_encode_smoothness_loss`` makes from
    ``key``, as the port's :class:`SmoothnessDraws`."""
    axis_key, plane_key, pos_key = jax.random.split(key, 3)
    return SmoothnessDraws(
        _t(jax.random.randint(axis_key, (levels, probes), 0, 3)).long(),
        _t(jax.random.uniform(plane_key, (levels, probes))),
        _t(jax.random.uniform(pos_key, (levels, probes, 3), minval=-bound, maxval=bound)),
    )


@pytest.mark.parametrize("layout,feat_dim", [("packed", 4), ("packed", 2), ("packed_dual", 2)])
def test_smoothness_loss_and_grad_match_jax(layout, feat_dim):
    num_level, probes = 2, 64
    levels = 2 * num_level if layout == "packed_dual" else num_level
    jloss = jmake_smoothness(num_level, 4, 8, feat_dim, layout, num_probes=probes)
    tables = np.asarray(jngp.init_packed_hash_table(jax.random.PRNGKey(0), levels, 9, feat_dim)) * 1e4
    key = jax.random.PRNGKey(1)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda t: jloss({"tables": t}, key)))(jnp.asarray(tables))
    draws = _jax_draws(key, levels, probes)
    for use_kernel in (True, False):
        loss = make_encode_smoothness_loss(num_level, 4, 8, feat_dim, layout, num_probes=probes,
                                           use_kernel=use_kernel)
        tt = _t(tables).requires_grad_(True)
        val = loss({"tables": tt}, draws)
        val.backward()
        assert float(jval) > 0.0
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6 * np.abs(jgrad).max())
    # a constant table encodes every point to the same value: no jumps
    const = {"tables": torch.ones(tables.shape)}
    assert loss(const, draws).item() < 1e-10
    # the port's own draws: the JAX package's shapes and ranges
    mine = loss.draw(torch.Generator().manual_seed(0))
    assert mine.axis.shape == (levels, probes) and set(mine.axis.unique().tolist()) <= {0, 1, 2}
    assert 0.0 <= mine.plane_u.min() and mine.plane_u.max() < 1.0 and mine.pos.abs().max() <= 2.5
    with pytest.raises(ValueError, match="packed layouts"):
        make_encode_smoothness_loss(num_level, table_layout="bricked")


def _tiny_ngp_cfg(layout, *extra):
    overrides = [f"network.table_layout={layout}", "network.num_level=3", "network.log_max_entry_per_level=10",
                 "network.min_res=4", "network.max_res=16", "objective.encode_smoothness_weight=0.1",
                 "objective.encode_smoothness_probes=32", "device.compute_dtype=float32", *extra]
    return config.resolve("instant_nerf", overrides), jcfg.resolve("instant_nerf", overrides)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generic_train_step_with_the_smoothness_loss_matches_jax(layout):
    cfg, jc = _tiny_ngp_cfg(layout)
    jfield, jparams = _jax_packed_params(layout, seed=6)
    field = session.build_field(cfg)
    aux, jaux = session.build_aux_loss(cfg), jsession.build_aux_loss(jc)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    rng = np.random.default_rng(8)
    o = (rng.normal(size=(12, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(12, 3)) * 0.3).astype(np.float32)
    gt = rng.uniform(size=(12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jtree = {"coarse": jparams}
    state0 = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=jtree,
                               opt_state=jtrain.make_optimizer(joptim).init(jtree))
    jstep = jax.jit(jtrain.make_ray_train_step(jfield, jsettings, joptim, aux_loss_fn=jaux))
    jstate, jmetrics = jstep(state0, jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), key)
    # JAX's step splits its key into the render's and the aux loss's
    render_key, aux_key = jax.random.split(key)
    levels = 6 if layout == "packed_dual" else 3
    aux_draws = (_jax_draws(aux_key, levels, 32),)
    rand = jtrain.draw_train_randomness(render_key, 12, jsettings)
    uniforms = renderer.RayUniforms(_t(rand["coarse_jitter"]), torch.zeros((12, 8)), torch.zeros((12, 0)),
                                    torch.zeros((12, 0)))

    params = params_from_jax(jtree)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    state = train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))
    # the gradient of the whole loss, photometric + weighted smoothness
    photo, _ = train.ray_loss_fn(field, params, _t(o), _t(d), _t(gt), uniforms, settings)
    grads = torch.autograd.grad(photo + aux(params, aux_draws), train.parameter_list(params))
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda l, m: (l + jaux(p, aux_key), m))(
            *jtrain.ray_loss_fn(jfield, p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), render_key, jsettings)),
        has_aux=True))(jtree)
    jflat = [np.asarray(g) for g in train.parameter_list(_np(jgrads))]
    scale = max(np.abs(g).max() for g in jflat)
    for g, jg in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-6 * scale)

    step = train.make_ray_train_step(field, settings, optim, aux_loss_fn=aux)
    with pytest.raises(ValueError, match="aux_draws"):
        step(state, _t(o), _t(d), _t(gt), uniforms)
    state, metrics = step(state, _t(o), _t(d), _t(gt), uniforms, aux_draws)
    assert set(metrics) == set(jmetrics) == {"coarse_loss", "aux_loss", "loss"}
    assert metrics["aux_loss"].item() > 0.0
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5)
    before = train.parameter_list(jtree)
    for leaf, ref, jg in zip(train.parameter_list(state.params), train.parameter_list(_np(jstate.params)), jflat):
        keep = np.abs(jg) > 1e-6 * scale
        np.testing.assert_allclose(leaf.detach().numpy()[keep], np.asarray(ref)[keep], rtol=1e-5, atol=1e-5)
    moved = np.abs(state.params["coarse"]["tables"].detach().numpy() - before[-1])
    assert moved.max() == pytest.approx(1e-2, rel=1e-3)  # Adam's first step: lr * sign(g)


def test_image_step_draws_the_aux_probes_after_the_render():
    cfg, _ = _tiny_ngp_cfg("packed")
    field, aux = session.build_field(cfg), session.build_aux_loss(cfg)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    camera = cameras.CameraParams(9.6, 9.6, 8, 8)
    with_aux = train.make_image_train_step(field, settings, train.OptimConfig(), camera, 16, aux_loss_fn=aux)
    plain = train.make_image_train_step(field, settings, train.OptimConfig(), camera, 16)
    a = with_aux.draw(torch.Generator().manual_seed(3), 4)
    b = plain.draw(torch.Generator().manual_seed(3), 4)
    # without an aux loss the render's draws are as before; with one, its
    # probes come after them
    assert b.aux is None and len(a.aux) == 1 and a.aux[0].pos.shape == (3, 32, 3)
    assert torch.equal(a.pixel_u, b.pixel_u) and torch.equal(a.rays.coarse, b.rays.coarse)
    # a hierarchical config draws one set of probes a network
    fine_cfg, _ = _tiny_ngp_cfg("packed", "renderer.num_samples_fine=8")
    assert len(session.build_aux_loss(fine_cfg).draw(torch.Generator().manual_seed(0))) == 2


def test_build_aux_loss_errors():
    for layout in ("hash", "bricked"):
        cfg, jc = _tiny_ngp_cfg(layout)
        with pytest.raises(ValueError, match="packed instant-NGP layouts"):
            session.build_aux_loss(cfg)
        with pytest.raises(ValueError):
            jsession.build_aux_loss(jc)
    with pytest.raises(ValueError, match="network.type='nerf'"):
        session.build_aux_loss(config.resolve("default", ["objective.encode_smoothness_weight=0.1"]))
    assert session.build_aux_loss(config.resolve("instant_nerf", ["network.table_layout=packed"])) is None


# ---------------------------------------------------------------------------
# the CLIs, and the kernels on the card

TINY_DUAL = [
    "network.table_layout=packed_dual",
    "objective.encode_smoothness_weight=0.001",
    "objective.encode_smoothness_probes=64",
    "data.dataset_type=gaussian_blobs",
    "data.img_size=8",
    "data.num_views=4",
    "network.num_level=2",
    "network.log_max_entry_per_level=10",
    "network.max_res=32",
    "renderer.num_pixels=64",
    "renderer.num_samples_coarse=16",
    "train_params.optim.num_iter=8",
    "train_params.validation.validate_every=1",
    "train_params.validation.num_batch=1",
    "train_params.log.epoch_btw_ckpt=1",
    "train_params.log.epoch_btw_vis=1",
]


def test_packed_dual_train_resume_render_evaluate_on_cpu(tmp_path, capsys):
    launch_count.reset(*FOLD)
    log_dir = tmp_path / "run"
    base = ["--config", "instant_nerf", "--log-dir", str(log_dir), "--device", "cpu"]
    first = run_train.main(base + ["--max-steps", "4"] + TINY_DUAL)
    assert first["step"] == 4 and all(np.isfinite(first["losses"]))
    assert first["metrics"]["aux_loss"] > 0.0
    assert first["losses"][-1] == pytest.approx(first["metrics"]["coarse_loss"] + first["metrics"]["aux_loss"])
    assert "validation @ step 4" in capsys.readouterr().out
    state = torch.load(log_dir / "ckpt" / "ckpt_000004.pt", weights_only=True)
    tables = state["params"]["coarse"]["tables"]
    assert tables.shape == (4, 16, 128)  # 2L pseudo-levels of 2^10 / 8 rows, 8 a line
    assert state["params"]["coarse"]["density_mlp"]["fc_in"]["w"].shape == (8, 64)
    moments = state["optimizer"]["state"]
    assert moments[max(moments)]["exp_avg"].shape == tables.shape

    resumed = run_train.main(base + ["--max-steps", "8"] + TINY_DUAL)
    assert "Resumed from step 4." in capsys.readouterr().out
    assert resumed["step"] == 8 and len(resumed["losses"]) == 4 and all(np.isfinite(resumed["losses"]))
    assert resumed["metrics"]["aux_loss"] > 0.0

    out_dir, gt_dir = tmp_path / "render", tmp_path / "gt"
    run_render.main(["--log-dir", str(log_dir), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out_dir), "--device", "cpu"])
    cfg = config.load_config(log_dir / "config.yaml")
    assert cfg.network.table_layout == "packed_dual" and cfg.objective.encode_smoothness_weight == 0.001
    data = session.build_dataset(cfg, "test")
    gt_dir.mkdir()
    for i in range(2):
        save_png(gt_dir / f"{i:04d}.png", data.images[i])
        png = load_png(out_dir / f"{i:04d}.png")
        assert png.shape == data.images[i].shape == (16, 16, 3) and np.isfinite(png).all()
    scores = evaluate.main([str(out_dir), str(gt_dir), "--device", "cpu"])
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert [fn.launches for fn in FOLD] == [0, 0]
    assert checkpoints.latest_checkpoint(log_dir).name == "ckpt_000008.pt"


def test_fold_kernels_match_plain_version_on_the_card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.as_tensor(hash_math.level_resolutions(16, 16, 512), device=dev)
    pts = torch.rand((4099, 3), generator=gen, device=dev) * 3 - 1.5
    pts[-1] = torch.tensor([0.25, -0.5, 1.0], device=dev)
    for feat_dim in hash_grid.FOLD_FEATS:
        for res, off in ((base, torch.zeros_like(base)), instant_ngp.dual_resolutions_offsets(base)):
            levels = res.shape[0]
            tables = torch.rand((levels, 2**16 // hash_grid.fold_factor(feat_dim), 128), generator=gen,
                                device=dev) * 2 - 1
            g = torch.randn((4099, levels * feat_dim), generator=gen, device=dev)
            before = [fn.launches for fn in FOLD]
            out = hash_grid.hash_fold_fwd(tables, pts, res, off, feat_dim)
            dtab = hash_grid.hash_fold_bwd(g, pts, res, off, tables.shape[1], feat_dim)
            torch.cuda.synchronize()
            assert [fn.launches for fn in FOLD] == [b + 1 for b in before]
            torch.testing.assert_close(out, hash_grid.fold_encode_reference(tables, pts, res, off, feat_dim),
                                       rtol=1e-5, atol=1e-5)
            ref = hash_grid.fold_backward_reference(g, pts, res, off, tables.shape[1], feat_dim)
            assert ((dtab - ref).norm() / ref.norm()).item() < 1e-5
            assert out[-1, : 16 * feat_dim].abs().max().item() == 0.0
