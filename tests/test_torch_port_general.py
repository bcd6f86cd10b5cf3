"""The general route of kernels 1-3: every config off the ``wgmma``
templates (f32 and bf16 at any width up to 1024; encodings up to 128 wide).

The kernels (``csrc/nerf_mlp_tc.cuh``) run only on a Hopper card; here the
Python side of their contract is held on the CPU: the zero padding of a
width that is not a multiple of 32 (the padded network's plain forward and
gradients equal the unpadded ones; rtol 1e-6 / atol 1e-6, the same sums
over zero-padded operands), the routes and their limits, and the launch
counts by route. Inputs come from a seeded numpy generator.
"""

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import config, session
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train


def _cfg(feat=256, level=10, dtype=torch.float32, dir_level=4):
    return fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                      compute_dtype=dtype)


def _params(cfg, seed=0):
    """Seeded port-init weights with the He gain (every layer matters)."""
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.feat_dim)
    return {n: {"w": v["w"] * 6**0.5, "b": v["b"]} for n, v in params.items()}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-2, 2, size=(n, 3)).astype(np.float32))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    g_sigma = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    return pts, dirs, g_sigma, g_rgb


def _rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


# ---------------------------------------------------------------------------
# padding


@pytest.mark.parametrize("feat,padded", [(48, 64), (100, 128)])
def test_padded_network_is_the_network(feat, padded):
    cfg = _cfg(feat, level=11)
    assert fused_nerf.padded_config(cfg).feat_dim == padded
    params = _params(cfg, seed=feat)
    pts, dirs, g_sigma, g_rgb = _data(70, seed=feat)
    big = fused_nerf.pad_params(params, cfg)
    pcfg = fused_nerf.padded_config(cfg)
    assert big["fc_9"]["w"].shape == (padded + cfg.dir_enc_dim, padded // 2)
    assert big["fc_5"]["w"].shape == (cfg.pos_enc_dim + padded, padded)
    assert big["fc_8"]["w"].shape == (padded, padded + 1)
    tol = dict(rtol=1e-6, atol=1e-6)
    for got, want in zip(fused_nerf.fused_nerf_apply_reference(big, pts, dirs, pcfg),
                         fused_nerf.fused_nerf_apply_reference(params, pts, dirs, cfg)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    g_big, dp_big, dd_big = fused_nerf.fused_nerf_bwd_reference(big, pts, dirs, g_sigma, g_rgb, pcfg)
    grads, dpts, ddirs = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    back = fused_nerf.unpad_grads(g_big, cfg)
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            assert back[name][leaf].shape == params[name][leaf].shape, (name, leaf)
            np.testing.assert_allclose(back[name][leaf].numpy(), grads[name][leaf].numpy(), **tol,
                                       err_msg=f"{name}.{leaf}")
    np.testing.assert_allclose(dp_big.numpy(), dpts.numpy(), **tol)
    np.testing.assert_allclose(dd_big.numpy(), ddirs.numpy(), **tol)
    # the padded units' own grads are zero: nothing leaks into them
    assert not g_big["fc_1"]["w"][:, feat:].any() and not g_big["fc_1"]["b"][feat:].any()


def test_a_width_of_32s_is_not_padded():
    cfg = _cfg(96, dtype=torch.bfloat16)
    params = _params(cfg)
    assert fused_nerf.pad_params(params, cfg) is params
    assert fused_nerf.padded_config(cfg) == cfg


# ---------------------------------------------------------------------------
# routes and limits


@pytest.mark.parametrize("feat,level,dtype,route", [
    (256, 10, torch.bfloat16, "wgmma"), (64, 10, torch.bfloat16, "wgmma"),
    (256, 11, torch.bfloat16, "wgmma_general"), (96, 10, torch.bfloat16, "wgmma_general"),
    (48, 10, torch.bfloat16, "wgmma_general"), (512, 12, torch.bfloat16, "wgmma_general"),
    (1024, 20, torch.bfloat16, "wgmma_general"), (256, 10, torch.float32, "f32_wgmma"),
    (64, 10, torch.float32, "f32_wgmma"), (1000, 20, torch.float32, "f32_wgmma"),
    # the tensor-core general route: every padded width up to 1024 in
    # column passes, bf16 and f32 (past 512 streaming its layers)
    (192, 10, torch.bfloat16, "wgmma_general"), (320, 10, torch.bfloat16, "wgmma_general"),
    (384, 12, torch.bfloat16, "wgmma_general"), (500, 10, torch.bfloat16, "wgmma_general"),
    (512, 20, torch.bfloat16, "wgmma_general"), (160, 10, torch.bfloat16, "wgmma_general"),
    (576, 10, torch.bfloat16, "wgmma_general"), (128, 12, torch.float32, "f32_wgmma"),
    (192, 20, torch.float32, "f32_wgmma"), (256, 20, torch.float32, "f32_wgmma"),
    (320, 10, torch.float32, "f32_wgmma"), (96, 10, torch.float32, "f32_wgmma"),
])
def test_forward_and_train_routes_by_config(feat, level, dtype, route):
    cfg = _cfg(feat, level, dtype)
    assert fused_nerf.forward_route(cfg) == route
    assert fused_nerf.train_route(cfg) == route


@pytest.mark.parametrize("kwargs,match", [
    (dict(feat=1056), "feat_dim up to 1024"),
    (dict(feat=2048, dtype=torch.bfloat16), "feat_dim up to 1024"),
    (dict(level=21), "encodings up to 128 wide"),
    (dict(dir_level=21), "encodings up to 128 wide"),
    (dict(dtype=torch.float16), "bfloat16 or float32"),
])
def test_routes_raise_only_past_the_limits(kwargs, match):
    cfg = _cfg(**kwargs)
    with pytest.raises(ValueError, match=match) as err:
        fused_nerf.train_route(cfg)
    if "dtype" not in kwargs:
        assert "parallel.use_pallas=false" in str(err.value)
    with pytest.raises(ValueError, match=match):
        fused_nerf.forward_route(cfg)


def test_route_launch_counts_reset_for_every_route():
    for fn_ in (fused_nerf.fused_nerf_apply, fused_nerf.fused_nerf_bwd, fused_train.fused_train_pass):
        fn_.route_launches["wgmma_general"] += 3
        fn_.route_launches["f32_wgmma"] += 3
        fn_.launches += 6
    fused_nerf.reset_launches()
    fused_train.reset_launches()
    for fn_ in (fused_nerf.fused_nerf_apply, fused_nerf.fused_nerf_bwd, fused_train.fused_train_pass):
        assert fn_.launches == 0 and fn_.route_launches == {"wgmma": 0, "wgmma_general": 0, "f32_wgmma": 0}


@pytest.mark.parametrize("override", ["device.compute_dtype=float32", "network.feat_dim=48",
                                      "network.feat_dim=96", "network.feat_dim=512", "network.feat_dim=1024",
                                      "signal_encoder.coord_encode_level=12"])
def test_check_trainable_takes_every_config_within_the_limits(override):
    session.check_trainable(config.resolve("default", [override]), torch.device("cuda"))


@pytest.mark.parametrize("override,key", [("network.feat_dim=2048", "network.feat_dim"),
                                          ("signal_encoder.coord_encode_level=21",
                                           "signal_encoder.coord_encode_level")])
def test_check_trainable_refuses_past_the_limits(override, key):
    with pytest.raises(ValueError) as err:
        session.check_trainable(config.resolve("default", [override]), torch.device("cuda"))
    assert key in str(err.value) and "parallel.use_pallas=false" in str(err.value)


# ---------------------------------------------------------------------------
# on the card


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernels have no CPU mode")


@pytest.mark.parametrize("feat,level,dtype", [(256, 10, torch.float32), (48, 12, torch.bfloat16),
                                              (1024, 10, torch.bfloat16)])
def test_general_route_kernels_match_plain_versions_on_the_card(feat, level, dtype):
    _require_hopper()
    dev = torch.device("cuda")
    cfg = _cfg(feat, level, dtype)
    params = {n: {k: t.to(dev) for k, t in v.items()} for n, v in _params(cfg).items()}
    pts, dirs, g_sigma, g_rgb = (t.to(dev) for t in _data(1000, seed=1))
    up = torch.float64 if dtype == torch.float32 else torch.float32
    ref_cfg = fused_nerf.FusedNeRFConfig(**{**cfg.__dict__, "compute_dtype": up})
    cast = {n: {k: t.to(dtype).to(up) for k, t in v.items()} for n, v in params.items()}
    ref = fused_nerf.fused_nerf_bwd_reference(cast, pts.to(up), dirs.to(up), g_sigma.to(up), g_rgb.to(up), ref_cfg)
    plain = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    got = fused_nerf.fused_nerf_bwd(params, pts, dirs, g_sigma, g_rgb, cfg)
    torch.cuda.synchronize()
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            a, r, p = got[0][name][leaf], ref[0][name][leaf], plain[0][name][leaf]
            assert _rel(a, r) <= 2 * _rel(p, r) + 1e-3, (name, leaf)
    assert fused_nerf.fused_nerf_bwd.route_launches[fused_nerf.train_route(cfg)] >= 1
