"""The port's NeRF MLP and fused field against the JAX package.

The plain version ``fused_nerf_apply_reference`` is held against JAX's
``fused_nerf_apply`` run the way ``tests/test_pallas.py`` runs it on the
CPU (Pallas interpret mode, float32, tile 64), with the weights carried
across by ``params_from_jax``: rtol 1e-4 / atol 1e-5, since XLA and torch
sum the products in different orders. The kernel itself runs only on a
Hopper card (its weight layouts are held in ``test_torch_port_wide_tc.py``
and ``test_torch_port_f32_tc.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.models import nerf as jnerf
from torch_nerf_tpu.ops.pallas.fused_nerf import FusedNeRFConfig as JaxFusedConfig
from torch_nerf_tpu.ops.pallas.fused_nerf import fused_nerf_apply as jax_fused_nerf_apply
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models import nerf
from torch_nerf_tpu_torch.ops import fused_nerf

L_POS, L_DIR, FEAT = 4, 2, 64
PE_DIM, DE_DIM = 27, 15
CFG32 = fused_nerf.FusedNeRFConfig(
    coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, compute_dtype=torch.float32
)
JAX_CFG = JaxFusedConfig(
    coord_encode_level=L_POS,
    dir_encode_level=L_DIR,
    feat_dim=FEAT,
    tile=64,
    compute_dtype=jnp.float32,
    interpret=True,
)


def _jax_params(seed):
    tree = jnerf.init_nerf_params(jax.random.PRNGKey(seed), PE_DIM, DE_DIM, FEAT)
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs


@pytest.mark.parametrize("n", [128, 100])  # a tile multiple and a ragged count
def test_plain_version_matches_jax_fused_kernel(n):
    jparams = _jax_params(0)
    pts, dirs = _data(n, seed=n)
    sigma, rgb = fused_nerf.fused_nerf_apply_reference(
        nerf.params_from_jax(jparams), torch.from_numpy(pts), torch.from_numpy(dirs), CFG32
    )
    jsigma, jrgb = jax_fused_nerf_apply(jparams, jnp.asarray(pts), jnp.asarray(dirs), JAX_CFG)
    assert sigma.shape == (n,) and rgb.shape == (n, 3)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_apply_matches_jax(dtype):
    jparams = _jax_params(1)
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(40, PE_DIM)).astype(np.float32)
    view = rng.normal(size=(40, DE_DIM)).astype(np.float32)
    sigma, rgb = nerf.nerf_apply(
        nerf.params_from_jax(jparams), torch.from_numpy(pos), torch.from_numpy(view), getattr(torch, dtype)
    )
    jsigma, jrgb = jnerf.nerf_apply(jparams, pos, view, compute_dtype=jnp.dtype(dtype))
    # bf16: both round each layer to bf16, but may tie-break one ulp apart
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), **tol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), **tol)


def test_params_round_trip():
    tree = {"coarse": _jax_params(3), "fine": _jax_params(4)}
    port = nerf.params_from_jax(tree)
    assert port["fine"]["fc_8"]["w"].shape == (FEAT, FEAT + 1)
    assert port["coarse"]["fc_5"]["w"].dtype == torch.float32
    back = nerf.params_to_jax(port)
    for net in tree:
        for name in nerf.LAYER_NAMES:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(back[net][name][leaf], tree[net][name][leaf])


def test_init_matches_layer_dims_and_bounds():
    gen = torch.Generator().manual_seed(0)
    params = nerf.init_nerf_params(gen, PE_DIM, DE_DIM, FEAT)
    dims = nerf.layer_dims(PE_DIM, DE_DIM, FEAT)
    assert dims == jnerf.layer_dims(PE_DIM, DE_DIM, FEAT)
    assert tuple(params) == nerf.LAYER_NAMES == jnerf.LAYER_NAMES
    for name, (fan_in, fan_out) in dims.items():
        bound = 1.0 / np.sqrt(fan_in)
        assert params[name]["w"].shape == (fan_in, fan_out)
        assert params[name]["b"].shape == (fan_out,)
        assert params[name]["w"].abs().max() <= bound
    again = nerf.init_nerf_params(torch.Generator().manual_seed(0), PE_DIM, DE_DIM, FEAT)
    assert torch.equal(again["fc_9"]["w"], params["fc_9"]["w"])


def test_flops_per_point():
    assert fused_nerf.flops_per_point(fused_nerf.FusedNeRFConfig()) == 1_186_816
    dims = nerf.layer_dims(PE_DIM, DE_DIM, FEAT)
    assert fused_nerf.flops_per_point(CFG32) == 2 * sum(i * o for i, o in dims.values())


def test_wrapper_uses_plain_version_on_cpu_and_never_launches():
    before = fused_nerf.fused_nerf_apply.launches
    params = nerf.params_from_jax(_jax_params(7))
    pts, dirs = (torch.from_numpy(a) for a in _data(50, seed=8))
    out = fused_nerf.fused_nerf_apply(params, pts, dirs, CFG32)
    prepared = fused_nerf.prepare(params, CFG32)
    assert prepared.weights is None and prepared.route is None and fused_nerf.prepare(prepared, CFG32) is prepared
    out2 = fused_nerf.fused_nerf_apply(prepared, pts, dirs, CFG32)
    ref = fused_nerf.fused_nerf_apply_reference(params, pts, dirs, CFG32)
    for a, b, c in zip(out, out2, ref):
        assert torch.equal(a, c) and torch.equal(b, c)
    kernel_field = make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    plain_field = make_nerf_field(
        coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT, use_kernel=False
    )
    pts3, dirs3 = pts.reshape(5, 10, 3), dirs.reshape(5, 10, 3)
    ks, kr = kernel_field.apply(kernel_field.prepare(params), pts3, dirs3)
    ps, pr = plain_field.apply(plain_field.prepare(params), pts3, dirs3)
    assert ks.shape == (5, 10) and kr.shape == (5, 10, 3)
    assert torch.equal(ks, ps) and torch.equal(kr, pr)
    assert fused_nerf.fused_nerf_apply.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pts = torch.zeros(4, 3)
    params = nerf.params_from_jax(_jax_params(9))
    w = fused_nerf.prepare(params, CFG32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_nerf._check_inputs(pts, pts, w, dataclasses.replace(CFG32, compute_dtype=torch.float16))
    # weights laid out for the bf16 wgmma route do not run an f32 config
    with pytest.raises(ValueError, match="route 'wgmma'"):
        fused_nerf._check_inputs(pts, pts, dataclasses.replace(w, route="wgmma"), CFG32)
    bf_cfg = fused_nerf.FusedNeRFConfig(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    with pytest.raises(ValueError, match="CUDA"):
        fused_nerf._check_inputs(pts, pts, w, bf_cfg)


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernel has no CPU mode")


def test_kernel_matches_plain_version_on_the_card():
    _require_hopper()
    dev = torch.device("cuda")
    cfg = fused_nerf.FusedNeRFConfig()
    params = nerf.init_nerf_params(torch.Generator(device=dev).manual_seed(0), 63, 27, 256, dev)
    rounded = {k: {n: v.to(torch.bfloat16).float() for n, v in p.items()} for k, p in params.items()}
    pts = torch.rand((4099, 3), device=dev) * 8 - 4
    dirs = torch.randn((4099, 3), device=dev)
    before = fused_nerf.fused_nerf_apply.launches
    sigma, rgb = fused_nerf.fused_nerf_apply(params, pts, dirs, cfg)
    torch.cuda.synchronize()
    assert fused_nerf.fused_nerf_apply.launches == before + 1
    cfg32 = fused_nerf.FusedNeRFConfig(compute_dtype=torch.float32)
    s32, c32 = fused_nerf.fused_nerf_apply_reference(rounded, pts, dirs, cfg32)
    sbf, cbf = fused_nerf.fused_nerf_apply_reference(params, pts, dirs, cfg)
    assert (sigma - s32).abs().max() <= 2 * (sbf - s32).abs().max() + 1e-3
    assert (rgb - c32).abs().max() <= 2 * (cbf - c32).abs().max() + 1e-3
