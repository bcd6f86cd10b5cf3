"""The general route's plain versions against the JAX package's Pallas
kernels, at configs off the ``wgmma`` templates, in f32.

The JAX package's Pallas kernels take any width and compute type; the
port's general route takes them on the card, held there against its plain
versions (``fused_nerf_apply_reference``, ``fused_nerf_bwd_reference``,
``fused_train_pass_reference``). Here those plain versions are held against
JAX's ``fused_nerf_apply`` (kernel 1), its VJP (kernel 2) and
``fused_train_pass`` (kernel 3), run as ``tests/test_fused_train.py`` runs
them on the CPU: interpret mode, f32. Widths 48 (padded to 64 on the card),
96 and 160; ``coord_encode_level`` 11 and 12 (69 and 75 encoded columns,
past the ``wgmma`` templates' 64); 12 rays x 8 samples (96 points), the
rays' points exact (below). Inputs
come from a seeded numpy generator and go to both sides; the weights are
JAX's init with the He gain, carried across by ``params_from_jax``. Tolerances: outputs rtol
1e-4 / atol 1e-5; each gradient leaf (and dpts, ddirs) within a relative
L2 of 1e-5 (both sides f32, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu.ops import sampling as jsampling
from torch_nerf_tpu.ops.pallas import fused_nerf as jfused
from torch_nerf_tpu.ops.pallas.fused_train import fused_train_pass as jax_fused_train_pass
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, params_from_jax
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train

CASES = [(feat, level) for feat in (48, 96, 160) for level in (11, 12)]
N_RAYS, SAMPLES = 12, 8


def _configs(feat, level):
    port = fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=4, feat_dim=feat,
                                      compute_dtype=torch.float32)
    jax_cfg = jfused.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=4, feat_dim=feat, tile=64,
                                     compute_dtype=jnp.float32, interpret=True)
    return port, jax_cfg


def _jax_params(feat, level, seed):
    """JAX's init with the He gain on each weight (x sqrt(6)), so that the
    outputs depend on every layer."""
    field = jfields.make_nerf_field(coord_encode_level=level, dir_encode_level=4, feat_dim=feat)
    params = jax.tree_util.tree_map(np.asarray, field.init(jax.random.PRNGKey(seed)))
    return {n: {"w": (v["w"] * np.float32(6**0.5)).astype(np.float32), "b": v["b"]} for n, v in params.items()}


def _points(seed):
    rng = np.random.default_rng(seed)
    n = N_RAYS * SAMPLES
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs, rng.normal(size=(n,)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close_grads(got, want, label=""):
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            g = got[name][leaf].detach().numpy()
            assert g.shape == np.shape(want[name][leaf]), f"{label}{name}.{leaf}"
            assert _rel(g, want[name][leaf]) < 1e-5, f"{label}{name}.{leaf}: {_rel(g, want[name][leaf])}"


@pytest.mark.parametrize("feat,level", CASES)
def test_plain_forward_matches_jax_kernel(feat, level):
    cfg, jcfg = _configs(feat, level)
    jparams = _jax_params(feat, level, seed=feat + level)
    pts, dirs, _, _ = _points(seed=feat)
    jsigma, jrgb = jfused.fused_nerf_apply(jparams, jnp.asarray(pts), jnp.asarray(dirs), jcfg)
    sigma, rgb = fused_nerf.fused_nerf_apply_reference(params_from_jax(jparams), torch.from_numpy(pts),
                                                       torch.from_numpy(dirs), cfg)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-5)
    assert float(sigma.max()) > 0.0 and float(rgb.std()) > 0.0


@pytest.mark.parametrize("feat,level", CASES)
def test_plain_backward_matches_jax_kernel_vjp(feat, level):
    cfg, jcfg = _configs(feat, level)
    jparams = _jax_params(feat, level, seed=feat + level + 1)
    pts, dirs, g_sigma, g_rgb = _points(seed=feat + 1)
    _, vjp = jax.vjp(lambda p, x, y: jfused.fused_nerf_apply(p, x, y, jcfg), jparams, jnp.asarray(pts),
                     jnp.asarray(dirs))
    jgrads, jdpts, jddirs = jax.tree_util.tree_map(np.asarray, vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb))))
    grads, dpts, ddirs = fused_nerf.fused_nerf_bwd_reference(
        params_from_jax(jparams), torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(g_sigma),
        torch.from_numpy(g_rgb), cfg)
    _close_grads(grads, jgrads)
    assert _rel(dpts.numpy(), jdpts) < 1e-5 and _rel(ddirs.numpy(), jddirs) < 1e-5


@pytest.mark.parametrize("feat,level", CASES)
def test_plain_train_pass_matches_jax_kernel(feat, level):
    cfg, jcfg = _configs(feat, level)
    jparams = _jax_params(feat, level, seed=feat + level + 2)
    rng = np.random.default_rng(feat + level)
    # o, d and t on a grid of sixteenths, so that every o + t d is exact: XLA
    # may fuse it into one FMA where torch rounds twice, and at these levels a
    # point one ulp apart moves sin(2^11 x) by ~1e-3
    o = (rng.integers(-8, 9, size=(N_RAYS, 3)) / 16).astype(np.float32)
    d = (rng.integers(-16, 17, size=(N_RAYS, 3)) / 16).astype(np.float32)
    gt = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    t = np.stack([np.sort(rng.choice(np.arange(32, 96), SAMPLES, replace=False)) for _ in range(N_RAYS)]) / 16
    t = t.astype(np.float32)
    delta = np.asarray(jsampling.t_deltas(jnp.asarray(t)))
    real = N_RAYS - 1
    jrgb, jw, jgrads = jax_fused_train_pass(jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                                            jnp.asarray(delta), jnp.asarray(gt), jcfg, real)
    rgb, w, grads = fused_train.fused_train_pass_reference(
        params_from_jax(jparams), *(torch.from_numpy(np.array(a)) for a in (o, d, t, delta, gt)), cfg, real)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    _close_grads(grads, jax.tree_util.tree_map(np.asarray, jgrads))
