"""The port's training slice against the JAX package.

Each piece runs on the same inputs in both packages: numpy draws from a
seeded generator, JAX's own uniforms handed to the port's ``*_from_uniforms``
cores, JAX weights carried across by ``params_from_jax``. JAX's Pallas
kernels run as its own tests run them on the CPU (interpret mode, float32);
the port's kernel wrappers run their plain versions on CPU tensors.
Tolerances: the train pass's rgb and weights rtol 1e-4 / atol 1e-6 and its
grads rtol 2e-3 / atol 1e-6 (``test_fused_train.py``'s); the field's
backward rtol 1e-4 / atol 1e-5 (XLA and torch sum in other orders); a train
step's loss rtol 1e-4 and its params after Adam rtol 5e-3 / atol 1e-6
(``test_fused_train.py:94-98``); Adam + schedule on fixed grads rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu import train as jtrain
from torch_nerf_tpu.ops import sampling as jsampling
from torch_nerf_tpu.ops.pallas import fused_nerf as jfused
from torch_nerf_tpu.ops.pallas.fused_train import fused_train_pass as jax_fused_train_pass
from torch_nerf_tpu.renderer import RenderSettings as JaxRenderSettings
from torch_nerf_tpu_torch import cameras, checkpoints, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params, params_from_jax
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train
from torch_nerf_tpu_torch.renderer import RayUniforms, RenderSettings

L_POS, L_DIR, FEAT = 4, 2, 64
CFG32 = fused_nerf.FusedNeRFConfig(
    coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, compute_dtype=torch.float32
)
JAX_CFG = jfused.FusedNeRFConfig(
    coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, tile=64,
    compute_dtype=jnp.float32, interpret=True,
)
JNP_FIELD = jfields.make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
JAX_FUSED_FIELD = jfields.make_nerf_field(
    coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, use_pallas=True, pallas_interpret=True
)
PORT_FIELD = make_nerf_field(
    coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, compute_dtype=torch.float32
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_net(seed):
    return _np(JNP_FIELD.init(jax.random.PRNGKey(seed)))


def _close_trees(got, ref, rtol, atol, label=""):
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(
                got[name][leaf].detach().numpy(), np.asarray(ref[name][leaf]), rtol=rtol, atol=atol,
                err_msg=f"{label}{name}.{leaf}",
            )


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    gt = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, gt


def _uniforms(rand, n, sc):
    """JAX's ``draw_train_randomness`` dict -> the port's RayUniforms."""
    empty = torch.zeros((n, 0))
    return RayUniforms(
        coarse=_t(rand["coarse_jitter"]),
        fine_coarse=_t(rand["fine_coarse_jitter"]) if "fine_u" in rand else torch.zeros((n, sc)),
        u=_t(rand["fine_u"]) if "fine_u" in rand else empty,
        fine=_t(rand["fine_jitter"]) if "fine_u" in rand else empty,
    )


# ---------------------------------------------------------------------------
# (a) the train pass, (b) the field's backward


def test_train_pass_reference_matches_jax_kernel_on_ragged_rays():
    n, s, real = 13, 8, 11
    o, d, gt = _rays(n, seed=1)
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=-1).astype(np.float32)
    delta = np.asarray(jsampling.t_deltas(jnp.asarray(t)))
    jparams = _jax_net(0)
    jrgb, jw, jgrads = jax_fused_train_pass(
        jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(delta), jnp.asarray(gt),
        JAX_CFG, real,
    )
    rgb, w, grads = fused_train.fused_train_pass(
        params_from_jax(jparams), _t(o), _t(d), _t(t), _t(delta), _t(gt), CFG32, real
    )
    assert rgb.shape == (n, 3) and w.shape == (n, s)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-6)
    _close_trees(grads, _np(jgrads), rtol=2e-3, atol=1e-6)
    # rays at or past num_real_rays carry no loss: the same grads without them
    _, _, head = fused_train.fused_train_pass(
        params_from_jax(jparams), _t(o[:real]), _t(d[:real]), _t(t[:real]), _t(delta[:real]), _t(gt[:real]),
        CFG32, real,
    )
    _close_trees(grads, _np(jax.tree_util.tree_map(lambda x: x.detach().numpy(), head)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [100, 192])  # a ragged count, and three 64-point tiles
def test_field_backward_matches_jax_vjp(n):
    jparams = _jax_net(3)
    rng = np.random.default_rng(n)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    g_sigma = rng.normal(size=(n,)).astype(np.float32)
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x, y: jfused.fused_nerf_apply(p, x, y, JAX_CFG), jparams,
                     jnp.asarray(pts), jnp.asarray(dirs))
    jgrads, jdpts, jddirs = _np(vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb))))
    tol = dict(rtol=1e-4, atol=1e-5)

    grads, dpts, ddirs = fused_nerf.fused_nerf_bwd_reference(
        params_from_jax(jparams), _t(pts), _t(dirs), _t(g_sigma), _t(g_rgb), CFG32
    )
    _close_trees(grads, jgrads, **tol, label="reference ")
    np.testing.assert_allclose(dpts.numpy(), jdpts, **tol)
    np.testing.assert_allclose(ddirs.numpy(), jddirs, **tol)

    # the autograd Function on CPU tensors routes every grad through the wrapper
    params = params_from_jax(jparams)
    leaves = [params[k][leaf].requires_grad_(True) for k in LAYER_NAMES for leaf in ("w", "b")]
    x, y = _t(pts).requires_grad_(True), _t(dirs).requires_grad_(True)
    sigma, rgb = fused_nerf.fused_nerf_apply(params, x, y, CFG32)
    torch.autograd.backward((sigma, rgb), (_t(g_sigma), _t(g_rgb)))
    assert all(leaf.grad is not None for leaf in leaves)
    _close_trees({k: {leaf: params[k][leaf].grad for leaf in ("w", "b")} for k in LAYER_NAMES}, jgrads,
                 **tol, label="Function ")
    np.testing.assert_allclose(x.grad.numpy(), jdpts, **tol)
    np.testing.assert_allclose(y.grad.numpy(), jddirs, **tol)
    assert fused_nerf.fused_nerf_bwd.launches == 0 and fused_nerf.fused_nerf_apply.launches == 0


def test_bf16_backward_reference_rounds_where_the_kernel_does():
    """In bf16, dz_out and every dh round to bf16 before the next product,
    and dW, db are f32 sums of the rounded operands (autograd of the bf16
    nerf_apply would return them in bf16)."""
    params = params_from_jax(_jax_net(4))
    rng = np.random.default_rng(5)
    pts, dirs = (_t(rng.uniform(-2, 2, size=(80, 3)).astype(np.float32)) for _ in range(2))
    gs, gr = _t(rng.normal(size=(80,)).astype(np.float32)), _t(rng.normal(size=(80, 3)).astype(np.float32))
    cfg16 = fused_nerf.FusedNeRFConfig(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    grads, dpts, _ = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, gs, gr, cfg16)
    acts = fused_nerf.forward_activations(params, pts, dirs, cfg16)
    bf = torch.bfloat16
    dz_out = (gr * acts["rgb"] * (1 - acts["rgb"])).to(bf)
    dh9 = dz_out @ params["fc_out"]["w"].to(bf).t()
    assert dh9.dtype == bf
    dz9 = torch.where(acts["fc_9"] > 0, dh9, torch.zeros((), dtype=bf))
    cat9 = torch.cat([acts["z8"][:, 1:], acts["de"]], dim=-1)
    assert torch.equal(grads["fc_out"]["w"], acts["fc_9"].float().t() @ dz_out.float())
    assert torch.equal(grads["fc_9"]["w"], cat9.float().t() @ dz9.float())
    assert torch.equal(grads["fc_9"]["b"], dz9.float().sum(dim=0))
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            assert grads[name][leaf].dtype == torch.float32 and torch.isfinite(grads[name][leaf]).all()
    assert dpts.dtype == torch.float32 and torch.isfinite(dpts).all()


def test_wrappers_take_the_plain_version_on_cpu_and_check_cuda_inputs():
    params = params_from_jax(_jax_net(6))
    o, d, gt = (_t(a) for a in _rays(4, seed=7))
    t = torch.linspace(2.0, 6.0, 8).repeat(4, 1)
    before = fused_train.fused_train_pass.launches
    fused_train.fused_train_pass(params, o, d, t, t, gt, CFG32, 4)
    assert fused_train.fused_train_pass.launches == before == 0
    with pytest.raises(ValueError, match="bfloat16"):
        fused_train._launch(params, o, d, t, t, gt, CFG32, 4)
    bf = fused_nerf.FusedNeRFConfig(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    with pytest.raises(ValueError, match="CUDA"):
        fused_train._launch(params, o, d, t, t, gt, bf, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_nerf._launch_bwd(params, o, d, t[:, 0], gt, bf)


def test_training_layout_follows_the_parameters_of_each_call():
    """The training kernels' layout is built from the parameters as they
    are at the call, so an optimizer step in place reaches the next launch."""
    bf = fused_nerf.FusedNeRFConfig(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    params = params_from_jax(_jax_net(8))
    frags, _, frags_t = fused_nerf.training_layout(params, bf)
    with torch.no_grad():
        params["fc_3"]["w"].add_(1.0)  # what an optimizer step does
    after, _, after_t = fused_nerf.training_layout(params, bf)
    i = LAYER_NAMES.index("fc_3")
    w = params["fc_3"]["w"].to(torch.bfloat16)
    assert torch.equal(after[i], fused_nerf.fragment_order(w))
    assert torch.equal(after_t[i], fused_nerf.transposed_fragments(w))
    assert not torch.equal(after[i], frags[i]) and not torch.equal(after_t[i], frags_t[i])
    assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(frags, after)) if k != i)


def test_field_fused_cfg_follows_the_kernel_route():
    assert PORT_FIELD.fused_cfg == CFG32
    assert make_nerf_field(feat_dim=FEAT, use_kernel=True).fused_cfg.feat_dim == FEAT
    assert make_nerf_field(feat_dim=FEAT, use_kernel=False).fused_cfg is None


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernels have no CPU mode")


def test_backward_kernel_matches_plain_version_on_the_card():
    _require_hopper()
    dev = torch.device("cuda")
    cfg = fused_nerf.FusedNeRFConfig()
    params = init_nerf_params(torch.Generator(device=dev).manual_seed(0), 63, 27, 256, dev)
    m = 4099
    pts, dirs = torch.rand((m, 3), device=dev) * 8 - 4, torch.randn((m, 3), device=dev)
    gs, gr = torch.randn((m,), device=dev), torch.randn((m, 3), device=dev)
    before = fused_nerf.fused_nerf_bwd.launches
    got, dp, dd = fused_nerf.fused_nerf_bwd(params, pts, dirs, gs, gr, cfg)
    torch.cuda.synchronize()
    assert fused_nerf.fused_nerf_bwd.launches == before + 1
    rounded = {k: {n: v.to(torch.bfloat16).float() for n, v in p.items()} for k, p in params.items()}
    cfg32 = fused_nerf.FusedNeRFConfig(compute_dtype=torch.float32)
    r32, p32, q32 = fused_nerf.fused_nerf_bwd_reference(rounded, pts, dirs, gs, gr, cfg32)
    rbf, pbf, qbf = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, gs, gr, cfg)
    for a, b, c in [(got[n][k], r32[n][k], rbf[n][k]) for n in LAYER_NAMES for k in ("w", "b")] + [
            (dp, p32, pbf), (dd, q32, qbf)]:
        assert (a - b).norm() <= 2 * (c - b).norm() + 1e-3 * b.norm()


def test_train_kernel_matches_plain_version_on_the_card():
    _require_hopper()
    dev = torch.device("cuda")
    cfg = fused_nerf.FusedNeRFConfig()
    params = init_nerf_params(torch.Generator(device=dev).manual_seed(0), 63, 27, 256, dev)
    n, s = 509, 64
    o, d = torch.randn((n, 3), device=dev), torch.randn((n, 3), device=dev)
    gt = torch.rand((n, 3), device=dev)
    t = torch.sort(2 + 4 * torch.rand((n, s), device=dev)).values
    delta = torch.diff(torch.cat([t, torch.full_like(t[:, :1], 1e8)], dim=-1), dim=-1)
    got = fused_train.fused_train_pass(params, o, d, t, delta, gt, cfg, n - 3)
    torch.cuda.synchronize()
    rounded = {k: {m: v.to(torch.bfloat16).float() for m, v in p.items()} for k, p in params.items()}
    ref = fused_train.fused_train_pass_reference(rounded, o, d, t, delta, gt,
                                                 fused_nerf.FusedNeRFConfig(compute_dtype=torch.float32), n - 3)
    bf = fused_train.fused_train_pass_reference(params, o, d, t, delta, gt, cfg, n - 3)
    for i in (0, 1):
        assert (got[i] - ref[i]).abs().max() <= 2 * (bf[i] - ref[i]).abs().max() + 1e-3
    for name in LAYER_NAMES:
        for k in ("w", "b"):
            a, b, c = got[2][name][k], ref[2][name][k], bf[2][name][k]
            assert (a - b).norm() <= 2 * (c - b).norm() + 1e-3 * b.norm()


# ---------------------------------------------------------------------------
# (c) loss, grads and one step; (d) Adam + schedule; (e) the image step


def _port_state(jparams, optim):
    params = params_from_jax(jparams)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_fused_loss_and_grad_matches_jax(hierarchical):
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8 if hierarchical else 0)
    jsettings = JaxRenderSettings(num_samples_coarse=8, num_samples_fine=8 if hierarchical else 0)
    jparams = {"coarse": _jax_net(0)}
    if hierarchical:
        jparams["fine"] = _jax_net(1)
    o, d, gt = _rays(12, seed=0)
    rand = jtrain.draw_train_randomness(jax.random.PRNGKey(42), 12, jsettings)
    jmetrics, jgrads = jtrain.fused_loss_and_grad(
        JAX_FUSED_FIELD, jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), rand, jsettings
    )
    metrics, grads = train.fused_loss_and_grad(
        PORT_FIELD, params_from_jax(jparams), _t(o), _t(d), _t(gt), _uniforms(rand, 12, 8), settings
    )
    assert set(metrics) == set(jmetrics)
    for name in jmetrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmetrics[name]), rtol=1e-4, err_msg=name)
    for branch in jgrads:
        _close_trees(grads[branch], _np(jgrads[branch]), rtol=2e-3, atol=1e-6, label=f"{branch}/")


@pytest.mark.parametrize("force_generic", [False, True])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_ray_train_step_matches_jax(force_generic, hierarchical):
    fine = 8 if hierarchical else 0
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=fine)
    jsettings = JaxRenderSettings(num_samples_coarse=8, num_samples_fine=fine)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    jfield = JNP_FIELD if force_generic else JAX_FUSED_FIELD
    state0 = jtrain.create_train_state(jax.random.PRNGKey(0), JNP_FIELD, jsettings, joptim)
    o, d, gt = _rays(12, seed=3)
    key = jax.random.PRNGKey(7)
    jstate, jmetrics = jtrain.make_ray_train_step(jfield, jsettings, joptim)(
        state0, jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), key
    )
    state = _port_state(_np(state0.params), optim)
    step = train.make_ray_train_step(PORT_FIELD, settings, optim, force_generic=force_generic)
    rand = _uniforms(jtrain.draw_train_randomness(key, 12, jsettings), 12, 8)
    state, metrics = step(state, _t(o), _t(d), _t(gt), rand)
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4)
    for branch in jstate.params:
        _close_trees(state.params[branch], _np(jstate.params[branch]), rtol=5e-3, atol=1e-6, label=f"{branch}/")


def test_adam_and_exponential_lr_match_optax():
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    rng = np.random.default_rng(9)
    params = {"a": {"w": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}}
    grads = [{"a": {"w": rng.normal(size=(5, 4)).astype(np.float32),
                    "b": (rng.normal(size=(4,)) * 1e-9).astype(np.float32)}} for _ in range(5)]
    tx = jtrain.make_optimizer(jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4))
    jp, opt_state = jax.tree_util.tree_map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    state = _port_state(params, optim)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        train._apply_grads(state, [_t(g["a"]["b"]), _t(g["a"]["w"])])
    for leaf in ("w", "b"):
        np.testing.assert_allclose(state.params["a"][leaf].detach().numpy(), np.asarray(jp["a"][leaf]), rtol=1e-6)
    lr = float(jtrain.lr_schedule(jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4))(5))
    assert state.scheduler.get_last_lr()[0] == pytest.approx(lr, rel=1e-6)


def test_precrop_and_pixel_sampling_match_jax():
    for h, w in ((16, 16), (400, 400), (9, 13)):
        np.testing.assert_array_equal(train.precrop_pixel_indices(h, w), jtrain.precrop_pixel_indices(h, w))
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jtrain.sample_pixels_without_replacement(key, 300, 40))
    u = _t(jax.random.uniform(key, (300,)))
    got = train.sample_pixels_without_replacement_from_uniforms(u, 40).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(train.sample_pixels_without_replacement(torch.Generator().manual_seed(0), 50, 50).tolist())) == 50


@pytest.mark.parametrize("precrop", [False, True])
def test_image_train_step_matches_jax(precrop):
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    jsettings = JaxRenderSettings(num_samples_coarse=8, num_samples_fine=8)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    images, poses, camera, _ = synthetic.make_dataset(num_views=3, img_size=12)
    jcamera = jcam.CameraParams(*camera)
    state0 = jtrain.create_train_state(jax.random.PRNGKey(1), JNP_FIELD, jsettings, joptim)
    key = jax.random.PRNGKey(5)
    jstep = jtrain.make_image_train_step(JNP_FIELD, jsettings, joptim, jcamera, num_pixels=16,
                                         precrop=precrop, donate=False)
    jstate, jmetrics = jstep(state0, jnp.asarray(images), jnp.asarray(poses), key)

    # JAX's draws from the key, handed to the port
    img_key, pix_key, render_key = jax.random.split(key, 3)
    step = train.make_image_train_step(PORT_FIELD, settings, optim, camera, num_pixels=16, precrop=precrop)
    candidates = train.precrop_pixel_indices(12, 12).size if precrop else 144
    draws = train.ImageDraws(
        image_index=int(jax.random.randint(img_key, (), 0, 3)),
        pixel_u=_t(jax.random.uniform(pix_key, (candidates,))),
        rays=_uniforms(jtrain.draw_train_randomness(render_key, step.num_pixels, jsettings), step.num_pixels, 8),
    )
    state = _port_state(_np(state0.params), optim)
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(poses), draws=draws)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-4)
    for branch in jstate.params:
        _close_trees(state.params[branch], _np(jstate.params[branch]), rtol=5e-3, atol=1e-6, label=f"{branch}/")
    # drawn by the step itself: the same shapes, and a different batch per call
    gen = torch.Generator().manual_seed(0)
    a, b = step.draw(gen, 3), step.draw(gen, 3)
    assert a.pixel_u.shape == (candidates,) and not torch.equal(a.pixel_u, b.pixel_u)


# ---------------------------------------------------------------------------
# (g) checkpoints


def _tiny_state(seed=0):
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    optim = train.OptimConfig(num_iter=50, init_lr=1e-3, end_lr=1e-4)
    state = train.create_train_state(torch.Generator().manual_seed(seed), PORT_FIELD, settings, optim)
    return state, settings, optim


def test_checkpoint_round_trip_continues_adam_and_the_schedule(tmp_path):
    state, settings, optim = _tiny_state()
    step = train.make_ray_train_step(PORT_FIELD, settings, optim)
    o, d, gt = (_t(a) for a in _rays(12, seed=11))
    gen = torch.Generator().manual_seed(3)
    batches = [train.draw_train_randomness(gen, 12, settings) for _ in range(3)]
    for rand in batches[:2]:
        state, _ = step(state, o, d, gt, rand)
    checkpoints.save_checkpoint(tmp_path, state.step, state.params, state.optimizer, state.scheduler)
    saved = checkpoints.restore_latest(tmp_path)
    assert saved["step"] == 2 and set(saved) == {"step", "params", "optimizer", "scheduler"}

    resumed, _, _ = _tiny_state(seed=1)  # other weights, fresh moments
    with torch.no_grad():
        for leaf, value in zip(train.parameter_list(resumed.params), train.parameter_list(saved["params"])):
            leaf.copy_(value)
    resumed.optimizer.load_state_dict(saved["optimizer"])
    resumed.scheduler.load_state_dict(saved["scheduler"])
    resumed.step = saved["step"]
    state, _ = step(state, o, d, gt, batches[2])
    resumed, _ = step(resumed, o, d, gt, batches[2])
    assert resumed.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    for a, b in zip(train.parameter_list(state.params), train.parameter_list(resumed.params)):
        assert torch.equal(a, b)


def test_params_only_checkpoint_still_loads(tmp_path):
    state, _, _ = _tiny_state()
    checkpoints.save_checkpoint(tmp_path, 7, state.params)
    saved = checkpoints.load_checkpoint(checkpoints.latest_checkpoint(tmp_path))
    assert set(saved) == {"step", "params"} and saved["step"] == 7
    for a, b in zip(train.parameter_list(state.params), train.parameter_list(saved["params"])):
        assert torch.equal(a.detach(), b)


def test_unported_branches_raise_and_name_their_slice():
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    with pytest.raises(NotImplementedError, match="occupancy slice"):
        train.make_ray_train_step(PORT_FIELD, settings, train.OptimConfig(), occupancy_cfg=object())
    with pytest.raises(NotImplementedError, match="packed-layout slice"):
        train.make_ray_train_step(PORT_FIELD, settings, train.OptimConfig(), aux_loss_fn=lambda p, k: 0)
