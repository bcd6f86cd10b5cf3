"""The port's Instant-NGP slice against the JAX package.

The same numpy-seeded inputs go through both packages at small sizes (L
2-5, log T 9-11, 64-128 points in [-1.5, 1.5] plus one point with integral
scaled coordinates). JAX's hash encodes run as its own tests run them on the
CPU: the Pallas kernels in interpret mode (``hash_encode_bricked128`` /
``hash_encode_corner128(..., interpret=True)``) and the XLA paths; the port's
kernel wrappers run their plain versions on CPU tensors. Tolerances:
encodes and table grads rtol 1e-5 / atol 1e-6 (the same sums in another
order); the model and field rtol 1e-5 / atol 1e-6 in f32, the render atol
1e-4 (the composite's sums in another order, amplified by 2^x); a train
step's loss and grads rtol 1e-5, the params after Adam within 1e-5 where
the JAX gradient is above rounding (Adam's first step at eps 1e-15 moves a
parameter by about lr * sign(g), so a gradient that is +-1e-12 from
rounding may flip it by 2 lr). bf16 is bounded separately.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import encoders as jenc
from torch_nerf_tpu import renderer as jrend
from torch_nerf_tpu import train as jtrain
from torch_nerf_tpu.fields_ngp import make_instant_ngp_field as jmake_field
from torch_nerf_tpu.models import hash_math as jhash_math
from torch_nerf_tpu.models import instant_ngp as jngp
from torch_nerf_tpu.ops.pallas.hash_brick import bricks_per_level as jbricks_per_level
from torch_nerf_tpu_torch import cameras, encoders, renderer, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.models import hash_math, instant_ngp
from torch_nerf_tpu_torch.models.nerf import params_from_jax, params_to_jax
from torch_nerf_tpu_torch.ops import hash_grid, ngp_mlp

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(n, seed):
    """``n`` points in [-1.5, 1.5]^3, the last with integral scaled
    coordinates at every level (the all-zero-weight quirk)."""
    pts = np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pts[-1] = [0.25, -0.5, 1.0]
    return pts


def _close_tree(got, ref, label="", **tol):
    if isinstance(ref, dict):
        assert set(got) == set(ref), label
        for k in ref:
            _close_tree(got[k], ref[k], f"{label}{k}.", **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=label, **tol)


# ---------------------------------------------------------------------------
# hash math and SH


@pytest.mark.parametrize("num_entries", [2**9, 2**19, 1000])
def test_spatial_hash_is_bit_exact(num_entries):
    rng = np.random.default_rng(num_entries)
    verts = np.concatenate([
        rng.integers(-2**31, 2**31, size=(200, 3)),  # the multiply wraps
        rng.integers(-600, 600, size=(200, 3)),  # negative lattice points
        np.array([[0, 0, 0], [-1, -1, -1], [2**31 - 1, -2**31, 1]]),
    ]).astype(np.int32)
    got = hash_math.spatial_hash(torch.from_numpy(verts), num_entries)
    ref = np.asarray(jhash_math.spatial_hash(jnp.asarray(verts), num_entries))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() >= 0 and got.max() < num_entries
    for args in ((16, 16, 512), (5, 4, 32), (1, 16, 512)):
        np.testing.assert_array_equal(hash_math.level_resolutions(*args), jhash_math.level_resolutions(*args))


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encoding_matches_jax(degree):
    dirs = np.random.default_rng(degree).normal(size=(50, 3)).astype(np.float32) * 1.7  # unnormalised
    got = encoders.sh_encoding(_t(dirs), degree)
    assert got.shape == (50, encoders.sh_encoding_dim(degree)) and encoders.sh_encoding_dim(degree) == jenc.sh_encoding_dim(degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.sh_encoding(jnp.asarray(dirs), degree)), **TOL)
    with pytest.raises(ValueError):
        encoders.sh_encoding(_t(dirs), 6)


# ---------------------------------------------------------------------------
# the encodes' plain versions, through the autograd Functions and by autograd


def _port_encode_and_grad(encode, tables, pts, res):
    tt = _t(tables).requires_grad_(True)
    out = encode(tt, _t(pts), _t(res))
    torch.sum(out**2).backward()
    return out.detach().numpy(), tt.grad.numpy()


@pytest.mark.parametrize("num_level,log_t,n", [(3, 11, 99), (5, 11, 65), (2, 10, 128)])
def test_brick_encode_matches_jax_kernel_and_xla(num_level, log_t, n):
    f = 2
    tables = np.asarray(jngp.init_bricked_hash_table(jax.random.PRNGKey(num_level), num_level, log_t, f)) * 1e4
    res = jngp.level_resolutions(num_level, 4, 32)
    pts = _points(n, seed=n)
    assert hash_grid.bricks_per_level(log_t, f) == jbricks_per_level(log_t, f) == tables.shape[1]

    def jloss(t, interpret):
        out = jngp.hash_encode_bricked128(t, jnp.asarray(pts), jnp.asarray(res), f, interpret=interpret)
        return jnp.sum(out**2), out

    port = {
        "kernel_route": _port_encode_and_grad(hash_grid.brick_encode, tables, pts, res),
        "autograd": _port_encode_and_grad(hash_grid.brick_encode_reference, tables, pts, res),
    }
    for interpret in (True, False):
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tables), interpret)
        jout = np.asarray(jout)
        assert np.abs(jout[:, num_level * f:]).max() == 0.0
        for out, grad in port.values():
            assert out.shape == (n, num_level * f)
            np.testing.assert_allclose(out, jout[:, : num_level * f], **TOL)
            np.testing.assert_allclose(grad, np.asarray(jgrad), **TOL)
    out = port["kernel_route"][0]
    assert np.abs(out[-1]).max() == 0.0 and np.abs(out[:-1]).max() > 0.0


@pytest.mark.parametrize("num_level,log_t,f", [(2, 9, 2), (3, 9, 4), (4, 10, 2)])
def test_corner_encode_matches_jax_kernel_and_xla(num_level, log_t, f):
    tables = np.asarray(jngp.init_hash_table(jax.random.PRNGKey(log_t), num_level, log_t, f)) * 1e4
    res = jngp.level_resolutions(num_level, 4, 16)
    pts = _points(77, seed=num_level)

    def jloss(t, kernel):
        if kernel:
            out = jngp.hash_encode_corner128(t, jnp.asarray(pts), jnp.asarray(res), interpret=True)[:, : num_level * f]
        else:
            out = jngp.hash_encode(t, jnp.asarray(pts), jnp.asarray(res))
        return jnp.sum(out**2), out

    port = {
        "kernel_route": _port_encode_and_grad(hash_grid.corner_encode, tables, pts, res),
        "autograd": _port_encode_and_grad(lambda *a: instant_ngp.hash_encode(*a, use_kernel=False), tables, pts, res),
    }
    for kernel in (True, False):
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tables), kernel)
        for out, grad in port.values():
            np.testing.assert_allclose(out, np.asarray(jout), **TOL)
            np.testing.assert_allclose(grad, np.asarray(jgrad), **TOL)
    assert np.abs(port["kernel_route"][0][-1]).max() == 0.0


def test_hash_encode_takes_any_table_size():
    """The per-corner formulation at a T that is not a power of two (the
    kernel's non-negative remainder path), on coordinates whose corners
    share rows: JAX's XLA path only, as its kernel needs a power of two."""
    num_level, f = 3, 2
    tables = np.random.default_rng(0).uniform(-1, 1, (num_level, 1000, f)).astype(np.float32)
    res = jngp.level_resolutions(num_level, 4, 16)
    pts = np.concatenate([_points(60, seed=5), np.random.default_rng(6).uniform(-900, 900, (4, 3))]).astype(np.float32)
    (_, jout), jgrad = jax.value_and_grad(
        lambda t: (lambda o: (jnp.sum(o**2), o))(jngp.hash_encode(t, jnp.asarray(pts), jnp.asarray(res))),
        has_aux=True,
    )(jnp.asarray(tables))
    out, grad = _port_encode_and_grad(hash_grid.corner_encode, tables, pts, res)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    np.testing.assert_allclose(grad, np.asarray(jgrad), **TOL)


def test_brick_and_corner_layout_checks():
    with pytest.raises(ValueError, match="F=2"):
        hash_grid.check_brick_layout((2, 16, 128), feat_dim=4)
    with pytest.raises(ValueError, match="F=2"):
        instant_ngp.init_bricked_hash_table(torch.Generator().manual_seed(0), 2, 10, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        hash_grid.check_brick_layout((2, 12, 128))
    with pytest.raises(ValueError, match="whole 128-float rows"):
        hash_grid.bricks_per_level(4, 2)
    hash_grid.check_brick_layout((16, 8192, 128))
    assert hash_grid.bricks_per_level(19, 2) == 8192
    # a CUDA-only check runs before any launch: bad F for the corner kernels
    with pytest.raises(ValueError, match="corner kernels"):
        hash_grid._check_corner_feat(3)


# ---------------------------------------------------------------------------
# model, field, render


def _jax_ngp_params(layout, seed=0, **size):
    size = {**SMALL, **size}
    jfield = jmake_field(**size, table_layout=layout)
    params = _np(jfield.init(jax.random.PRNGKey(seed)))
    # U(1e-4) tables give features far below the MLPs' biases; scale them so
    # that the encode carries signal through the field
    params["tables"] = params["tables"] * 1e4
    return jfield, params


@pytest.mark.parametrize("layout", ["hash", "bricked"])
def test_instant_ngp_apply_matches_jax(layout):
    _, jparams = _jax_ngp_params(layout, seed=1)
    res = jngp.level_resolutions(3, 4, 16)
    rng = np.random.default_rng(2)
    pos = rng.uniform(-1.5, 1.5, (4, 16, 3)).astype(np.float32)
    dir_enc = rng.normal(size=(4, 16, 16)).astype(np.float32)
    jsigma, jrgb = jngp.instant_ngp_apply(jparams, jnp.asarray(pos), jnp.asarray(dir_enc), jnp.asarray(res),
                                          table_layout=layout)
    params = params_from_jax(jparams)
    for use_kernel in (True, False):
        sigma, rgb = instant_ngp.instant_ngp_apply(params, _t(pos), _t(dir_enc), _t(res), table_layout=layout,
                                                   use_kernel=use_kernel)
        assert sigma.shape == (4, 16) and rgb.shape == (4, 16, 3)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), **TOL)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOL)
    # HDR colour is exp, not sigmoid
    _, jhdr = jngp.instant_ngp_apply(jparams, jnp.asarray(pos), jnp.asarray(dir_enc), jnp.asarray(res),
                                     is_hdr=True, table_layout=layout)
    _, hdr = instant_ngp.instant_ngp_apply(params, _t(pos), _t(dir_enc), _t(res), is_hdr=True, table_layout=layout)
    np.testing.assert_allclose(hdr.numpy(), np.asarray(jhdr), **TOL)
    # sigma = 2^x overflows to inf for a large density output, in both
    bias = np.array(jparams["density_mlp"]["fc_out"]["b"])
    bias[0] = 128.0  # about half the points' density outputs cross 2^128
    jparams["density_mlp"]["fc_out"]["b"] = bias
    jsigma, _ = jngp.instant_ngp_apply(jparams, jnp.asarray(pos), jnp.asarray(dir_enc), jnp.asarray(res),
                                       table_layout=layout)
    sigma, _ = instant_ngp.instant_ngp_apply(params_from_jax(jparams), _t(pos), _t(dir_enc), _t(res),
                                             table_layout=layout)
    jinf = np.isinf(np.asarray(jsigma))
    assert jinf.any() and not jinf.all()
    np.testing.assert_array_equal(np.isinf(sigma.numpy()), jinf)
    np.testing.assert_allclose(sigma.numpy()[~jinf], np.asarray(jsigma)[~jinf], **TOL)


@pytest.mark.parametrize("layout", ["hash", "bricked"])
def test_field_matches_jax_and_carries_params(layout):
    jfield, jparams = _jax_ngp_params(layout, seed=3)
    field = make_instant_ngp_field(**SMALL, table_layout=layout)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.5, 1.5, (5, 9, 3)).astype(np.float32)
    dirs = rng.normal(size=(5, 9, 3)).astype(np.float32) * 2.0  # unnormalised, as the renderer passes them
    jsigma, jrgb = jfield.apply(jparams, jnp.asarray(pts), jnp.asarray(dirs))
    params = params_from_jax(jparams)
    sigma, rgb = field.apply(params, _t(pts), _t(dirs))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), **TOL)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **TOL)
    # the tree round-trips, and the port's init has the JAX tree's shapes
    _close_tree(params_from_jax(params_to_jax(params)), jparams, rtol=0, atol=0)
    mine = field.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(np.shape, params_to_jax(mine)) == jax.tree_util.tree_map(np.shape, jparams)
    assert float(mine["tables"].abs().max()) <= 1e-4
    assert hash_grid.hash_brick_fwd.launches == hash_grid.hash_corner_fwd.launches == 0


def _jax_uniforms(key, settings):
    """``(first_pixel, n) -> RayUniforms``: the draws JAX's render_image
    makes for the chunk starting at ``first_pixel`` (coarse pass only)."""

    def draw(first_pixel, n):
        coarse_key, _ = jax.random.split(jax.random.fold_in(key, jnp.int32(first_pixel)))
        coarse = _t(jax.random.uniform(coarse_key, (n, settings.num_samples_coarse), jnp.float32))
        empty = torch.zeros((n, 0))
        return renderer.RayUniforms(coarse, torch.zeros_like(coarse), empty, empty)

    return draw


@pytest.mark.parametrize("layout", ["hash", "bricked"])
def test_render_image_of_ngp_field_matches_jax(layout):
    jfield, jparams = _jax_ngp_params(layout, seed=5)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    pose = synthetic.split_poses(2, "test")[1]
    key = jax.random.PRNGKey(3)
    ref = jrend.render_image(jfield, jparams, None, jcam.CameraParams(19.2, 19.2, 12, 12),
                             jnp.asarray(pose), key, jsettings, chunk_size=48)
    img = renderer.render_image(
        make_instant_ngp_field(**SMALL, table_layout=layout), params_from_jax(jparams), None,
        cameras.CameraParams(19.2, 19.2, 12, 12), _t(pose), 3, settings, chunk_size=48,
        uniforms_for_chunk=_jax_uniforms(key, settings),
    )
    assert img.shape == (12, 12, 3)
    # the composite's cumulative sums add in another order, and 2^x
    # densities amplify a last-ulp difference: atol 1e-4, as the NeRF render
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_small_mlp_bf16_bound():
    """bf16 on both sides rounds every product and bias add to bf16; the
    two frameworks may tie-break one bf16 ulp apart, which the next layers
    carry: outputs within 2e-2 of JAX's bf16 and of the f32 result."""
    jparams = _np(jngp.init_small_mlp(jax.random.PRNGKey(0), 32, 16, 64, 1))
    x = np.random.default_rng(7).normal(size=(64, 32)).astype(np.float32)
    params = params_from_jax(jparams)
    got = instant_ngp.small_mlp_apply(params, _t(x), torch.bfloat16)
    ref = np.asarray(jngp.small_mlp_apply(jparams, jnp.asarray(x), jnp.bfloat16))
    f32 = instant_ngp.small_mlp_apply(params, _t(x), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(f32.numpy(), np.asarray(jngp.small_mlp_apply(jparams, jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# the bf16 field at L 16 x F 2, where ``prepare`` takes the fused forward
# after the encode (``ops/ngp_mlp.py``; its plain version on the CPU)

FUSED = dict(num_level=16, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=64)


def _jax_bf16_field_and_port_handle(layout, seed):
    jfield, jparams = _jax_ngp_params(layout, seed=seed, **FUSED, compute_dtype=jnp.bfloat16)
    field = make_instant_ngp_field(**FUSED, table_layout=layout, compute_dtype=torch.bfloat16)
    w = field.prepare(params_from_jax(jparams))
    assert isinstance(w, ngp_mlp.NgpWeights) and w.in_dim == (64 if layout == "packed_dual" else 32)
    return jfield, jparams, field, w


def _counting_fused_forward(monkeypatch):
    """Count the field's calls of ``ngp_mlp.ngp_mlp_fwd``."""
    calls, fused = [], ngp_mlp.ngp_mlp_fwd

    def counted(*args, **kw):
        calls.append(args[1].shape[0])
        return fused(*args, **kw)

    monkeypatch.setattr(ngp_mlp, "ngp_mlp_fwd", counted)
    return calls


@pytest.mark.parametrize("layout", ["hash", "bricked", "packed", "packed_dual"])
def test_prepared_bf16_field_matches_jax(layout, monkeypatch):
    """bf16 on both sides, within :func:`test_small_mlp_bf16_bound`'s 2e-2
    (sigma = 2^x compared as x)."""
    jfield, jparams, field, w = _jax_bf16_field_and_port_handle(layout, seed=6)
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1.5, 1.5, (5, 9, 3)).astype(np.float32)
    ray_dirs = rng.normal(size=(5, 1, 3)).astype(np.float32) * 2.0  # unnormalised, as the renderer passes them
    dirs = np.broadcast_to(ray_dirs, pts.shape)
    jsigma, jrgb = jfield.apply(jparams, jnp.asarray(pts), jnp.asarray(dirs))
    calls = _counting_fused_forward(monkeypatch)
    # one ray's direction over its samples, as ``renderer._render_pass`` expands it
    sigma, rgb = field.apply(w, _t(pts), _t(ray_dirs).expand(5, 9, 3))
    assert calls == [45] and sigma.shape == (5, 9) and rgb.shape == (5, 9, 3)
    np.testing.assert_allclose(np.log2(sigma.numpy()), np.log2(np.asarray(jsigma)), rtol=0, atol=2e-2)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=0, atol=2e-2)


@pytest.mark.parametrize("layout", ["hash", "packed_dual"])
def test_render_image_of_prepared_bf16_field_matches_jax(layout, monkeypatch):
    """A frame of the bf16 field: the port's frame loop prepares it and
    takes the fused forward once a chunk; JAX's frame in bf16. Pixels
    within 2e-2, the fields' bf16 bound."""
    jfield, jparams, field, _ = _jax_bf16_field_and_port_handle(layout, seed=5)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    pose = synthetic.split_poses(2, "test")[1]
    key = jax.random.PRNGKey(3)
    ref = jrend.render_image(jfield, jparams, None, jcam.CameraParams(19.2, 19.2, 12, 12),
                             jnp.asarray(pose), key, jsettings, chunk_size=48)
    calls = _counting_fused_forward(monkeypatch)
    img = renderer.render_image(field, params_from_jax(jparams), None, cameras.CameraParams(19.2, 19.2, 12, 12),
                                _t(pose), 3, settings, chunk_size=48, uniforms_for_chunk=_jax_uniforms(key, settings))
    assert img.shape == (12, 12, 3) and calls == [48 * 8] * 3
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# one generic train step, and the table weight decay


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["hash", "bricked"])
def test_generic_train_step_matches_jax(layout, weight_decay):
    jfield, jparams = _jax_ngp_params(layout, seed=6)
    field = make_instant_ngp_field(**SMALL, table_layout=layout)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15, table_weight_decay=weight_decay)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15,
                                table_weight_decay=weight_decay)
    rng = np.random.default_rng(8)
    o = (rng.normal(size=(12, 3)) * 0.3).astype(np.float32)
    d = (rng.normal(size=(12, 3)) * 0.3).astype(np.float32)
    gt = rng.uniform(size=(12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt))
    jtree = {"coarse": jparams}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtrain.ray_loss_fn(jfield, p, *args, key, jsettings), has_aux=True)(jtree)
    state0 = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=jtree,
                               opt_state=jtrain.make_optimizer(joptim).init(jtree))
    jstate, jmetrics = jtrain.make_ray_train_step(jfield, jsettings, joptim)(state0, *args, key)

    params = params_from_jax(jtree)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    state = train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))
    rand = jtrain.draw_train_randomness(key, 12, jsettings)
    uniforms = renderer.RayUniforms(_t(rand["coarse_jitter"]), torch.zeros((12, 8)), torch.zeros((12, 0)),
                                    torch.zeros((12, 0)))
    loss, _ = train.ray_loss_fn(field, params, _t(o), _t(d), _t(gt), uniforms, settings)
    grads = torch.autograd.grad(loss, train.parameter_list(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = [np.asarray(g) for g in train.parameter_list(_np(jgrads))]
    scale = max(np.abs(g).max() for g in jflat)
    for g, jg in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-6 * scale)
    assert np.abs(jflat[-1]).max() > 0.0  # the tables get a gradient

    state, metrics = train.make_ray_train_step(field, settings, optim)(state, _t(o), _t(d), _t(gt), uniforms)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    before = train.parameter_list(jtree)
    for leaf, ref, jg, p0 in zip(train.parameter_list(state.params), train.parameter_list(_np(jstate.params)),
                                 jflat, before):
        # Adam's input: the gradient plus the decay on the tables
        g_in = jg + (weight_decay * p0 if leaf.shape == p0.shape and leaf.dim() == 3 else 0.0)
        keep = np.abs(g_in) > 1e-6 * scale
        np.testing.assert_allclose(leaf.detach().numpy()[keep], np.asarray(ref)[keep], rtol=1e-5, atol=1e-5)
    moved = np.abs(state.params["coarse"]["tables"].detach().numpy() - jparams["tables"])
    assert moved.max() == pytest.approx(1e-2, rel=1e-3)  # Adam's first step: lr * sign(g)


def test_table_weight_decay_matches_optax_and_keeps_the_leaf_order():
    optim = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4, table_weight_decay=0.5)
    rng = np.random.default_rng(9)
    tree = {
        "coarse": {
            "tables": rng.normal(size=(2, 4, 2)).astype(np.float32),
            "density_mlp": {"fc_in": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                                      "b": rng.normal(size=(3,)).astype(np.float32)}},
        },
        "fine": {"tables": rng.normal(size=(2, 4, 2)).astype(np.float32)},
    }
    assert train.table_flags(tree) == [False, False, True, True]
    tx = jtrain.make_optimizer(jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4, table_weight_decay=0.5))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(jp)
    params = params_from_jax(tree)
    opt = train.make_optimizer(params, optim)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.0, 0.5]
    assert [p for g in opt.param_groups for p in g["params"]] == train.parameter_list(params)
    state = train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))
    for _ in range(4):
        g = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        train._apply_grads(state, [_t(x) for x in train.parameter_list(g)])
    _close_tree(state.params, _np(jp), rtol=1e-6, atol=1e-7)
    # without decay: one group, as before
    assert len(train.make_optimizer(params, train.OptimConfig()).param_groups) == 1


def test_packed_layouts_and_their_loss_name_the_packed_layout_slice():
    """The packed layouts, once left to a later slice, build: their field
    and params at the JAX package's shapes, and their smoothness loss; an
    unknown layout still raises."""
    from torch_nerf_tpu_torch.fields_ngp import make_encode_smoothness_loss

    for layout, levels in (("packed", 3), ("packed_dual", 6)):
        field = make_instant_ngp_field(**SMALL, table_layout=layout)
        params = field.init(torch.Generator().manual_seed(0))
        jparams = jmake_field(**SMALL, table_layout=layout).init(jax.random.PRNGKey(0))
        assert jax.tree_util.tree_map(np.shape, params_to_jax(params)) == jax.tree_util.tree_map(np.shape, jparams)
        assert params["tables"].shape == (levels, 16, 128)
        assert params["density_mlp"]["fc_in"]["w"].shape == (levels * 2, 64)
        small = instant_ngp.init_instant_ngp_params(torch.Generator(), 16, 2, 9, 4, table_layout=layout)
        assert small["tables"].shape == (2 * levels // 3, 16, 128)  # 2^9 / 8 rows, 4 a line
        loss = make_encode_smoothness_loss(3, 4, 16, table_layout=layout, num_probes=8)
        assert loss(params, loss.draw(torch.Generator().manual_seed(1))).item() > 0.0
    with pytest.raises(ValueError, match="Unknown table_layout"):
        instant_ngp.check_layout("voxels")
