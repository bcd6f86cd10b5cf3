"""The general route of kernels 1-3: every config off the ``wgmma``
templates (f32; bf16 at any width up to 1024; encodings up to 128 wide).

The kernels (``csrc/nerf_mlp_general.cuh``) run only on a Hopper card; here
the Python side of their contract is held on the CPU: the zero padding of a
width that is not a multiple of 32 (the padded network's plain forward and
gradients equal the unpadded ones), the routes and their limits, the tile
sizes, and a plain walk over the matrices of ``general_layout`` in the
kernels' steps (the forward with its stash, the backward chain with its
roundings and masks, dW = A^T dZ, the grads mapped back by
``grads_from_general``) against the plain versions. Inputs come from a
seeded numpy generator. Tolerances: padding rtol 1e-6 / atol 1e-6 (the
same sums over zero-padded operands); the f32 walk rtol 1e-5 / atol 1e-6
(sums in another order; dpts and ddirs by relative L2 1e-5, their
encode VJP cancels terms up to 2^(L-1) times the cotangent); the bf16 walk atol 2e-2 on outputs and a
relative L2 of 2e-2 on grads (a sum in another order can move one bf16
rounding, which the later layers carry).
"""

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import config, encoders, session
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
# routes, limits, tiles


@pytest.mark.parametrize("feat,level,dtype,route", [
    (256, 10, torch.bfloat16, "wgmma"), (64, 10, torch.bfloat16, "wgmma"),
    (256, 11, torch.bfloat16, "wgmma_general"), (96, 10, torch.bfloat16, "wgmma_general"),
    (48, 10, torch.bfloat16, "wgmma_general"), (512, 12, torch.bfloat16, "wgmma_general"),
    (1024, 20, torch.bfloat16, "wgmma_general"), (256, 10, torch.float32, "f32_wgmma"),
    (64, 10, torch.float32, "f32_wgmma"), (1000, 20, torch.float32, "f32"),
    # the tensor-core general route: every padded bf16 width up to 1024 in
    # column passes; f32 at widths % 64 == 0 up to 256
    (192, 10, torch.bfloat16, "wgmma_general"), (320, 10, torch.bfloat16, "wgmma_general"),
    (384, 12, torch.bfloat16, "wgmma_general"), (500, 10, torch.bfloat16, "wgmma_general"),
    (512, 20, torch.bfloat16, "wgmma_general"), (160, 10, torch.bfloat16, "wgmma_general"),
    (576, 10, torch.bfloat16, "wgmma_general"), (128, 12, torch.float32, "f32_wgmma"),
    (192, 20, torch.float32, "f32_wgmma"), (256, 20, torch.float32, "f32_wgmma"),
    (320, 10, torch.float32, "f32"), (96, 10, torch.float32, "f32"),
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


# the FFMA route's tiles (f32: every bf16 config is on the tensor cores)
@pytest.mark.parametrize("feat,dtype,rows", [(256, torch.float32, (32, 32, 32)), (640, torch.float32, (32, 32, 32)),
                                             (768, torch.float32, (16, 16, 16)), (512, torch.float32, (32, 32, 32)),
                                             (1024, torch.float32, (16, 16, 16)), (96, torch.float32, (32, 32, 32)),
                                             (896, torch.float32, (16, 16, 16))])
def test_tiles_shrink_where_32_points_do_not_fit(feat, dtype, rows):
    cfg = _cfg(feat, level=20, dtype=dtype)
    assert fused_nerf.tile_rows(cfg) == rows


def test_route_launch_counts_reset_for_every_route():
    for fn_ in (fused_nerf.fused_nerf_apply, fused_nerf.fused_nerf_bwd, fused_train.fused_train_pass):
        fn_.route_launches["f32"] += 3
        fn_.route_launches["f32_wgmma"] += 3
        fn_.launches += 6
    fused_nerf.reset_launches()
    fused_train.reset_launches()
    for fn_ in (fused_nerf.fused_nerf_apply, fused_nerf.fused_nerf_bwd, fused_train.fused_train_pass):
        assert fn_.launches == 0 and fn_.route_launches == {"wgmma": 0, "wgmma_general": 0, "f32_wgmma": 0,
                                                            "f32": 0}


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
# a plain walk over the general route's matrices, in the kernels' steps


def _layout(params, cfg):
    """The matrices the kernels read, (K, N) row-major, in f32."""
    fwd, biases, chain = fused_nerf.general_layout(params, cfg)
    mats = fused_nerf.general_matrices(params, cfg)
    for (f, b, c), w, wt in zip(mats, fwd, chain):
        assert torch.equal(w, f) and torch.equal(wt, c)
    return [w.float() for w in fwd], [b.float() for b in biases], [w.float() for w in chain]


def walk(params, pts, dirs, g_sigma, g_rgb, cfg):
    """The general route's kernels as plain steps on ``general_layout``:
    sigma, rgb, the public grads, dpts, ddirs."""
    bf16 = cfg.compute_dtype == torch.bfloat16

    def rnd(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    def pad(x, cols):
        return torch.nn.functional.pad(x, (0, cols - x.shape[1]))

    fwd, b, chain = _layout(params, cfg)
    fp = fused_nerf.padded_config(cfg).feat_dim
    pp, dp = -(-cfg.pos_enc_dim // 16) * 16, -(-cfg.dir_enc_dim // 16) * 16
    pe = pad(rnd(encoders.positional_encoding(pts, cfg.coord_encode_level)), pp)
    de = pad(rnd(encoders.positional_encoding(dirs, cfg.dir_encode_level)), dp)

    def lin(i, x):
        y = x @ fwd[i]
        return rnd(rnd(y) + b[i]) if bf16 else y + b[i]

    acts, inputs = [], []
    h = pe
    for i in range(8):
        x = torch.cat([pe, h], dim=1) if i == 5 else h
        inputs.append(x)
        h = torch.relu(lin(i, x))
        acts.append(h)
    inputs.append(h)
    z8 = lin(8, h)
    feat, sigma = z8[:, :fp], torch.relu(z8[:, fp])
    inputs.append(torch.cat([feat, de], dim=1))
    h9 = torch.relu(lin(9, inputs[9]))
    inputs.append(h9)
    rgb = torch.sigmoid(lin(10, h9)[:, :3])

    def mask(act, dh):
        return torch.where(act > 0, rnd(dh), 0.0)

    dz = [None] * 11
    dz[10] = pad(rnd(g_rgb * rgb * (1.0 - rgb)), 16)
    dz[9] = mask(h9, dz[10] @ chain[10])
    dcat = rnd(dz[9] @ chain[9])
    dde = dcat[:, fp:]
    dsig = rnd(torch.where(sigma > 0, g_sigma, 0.0))
    dz[8] = torch.cat([dcat[:, :fp], dsig[:, None], torch.zeros((pts.shape[0], 15))], dim=1)
    dz[7] = mask(acts[7], dz[8] @ chain[8])
    dz[6] = mask(acts[6], dz[7] @ chain[7])
    dz[5] = mask(acts[5], dz[6] @ chain[6])
    dcat = rnd(dz[5] @ chain[5])
    dpe = dcat[:, :pp]
    dz[4] = mask(acts[4], dcat[:, pp:])
    for i in (3, 2, 1, 0):
        dz[i] = mask(acts[i], dz[i + 1] @ chain[i + 1])
    dpe = dpe + rnd(dz[0] @ chain[0])
    gw = [a.t() @ z for a, z in zip(inputs, dz)]
    gb = [z.sum(dim=0) for z in dz]
    assert [tuple(w.shape) for w in gw] == fused_nerf.general_grad_shapes(cfg)
    grads = fused_nerf.grads_from_general(gw, gb, cfg)
    dpts = fused_nerf.encode_vjp(pts, dpe[:, :cfg.pos_enc_dim], cfg.coord_encode_level, True)
    ddirs = fused_nerf.encode_vjp(dirs, dde[:, :cfg.dir_enc_dim], cfg.dir_encode_level, True)
    return sigma, rgb, grads, dpts, ddirs


@pytest.mark.parametrize("feat,level,dtype", [(48, 11, torch.float32), (96, 12, torch.float32),
                                              (160, 10, torch.bfloat16), (48, 12, torch.bfloat16)])
def test_a_walk_over_the_general_layout_is_the_field_and_its_backward(feat, level, dtype):
    cfg = _cfg(feat, level, dtype)
    params = _params(cfg, seed=feat + level)
    pts, dirs, g_sigma, g_rgb = _data(90, seed=feat)
    sigma, rgb, grads, dpts, ddirs = walk(params, pts, dirs, g_sigma, g_rgb, cfg)
    ref_sigma, ref_rgb = fused_nerf.fused_nerf_apply_reference(params, pts, dirs, cfg)
    ref, ref_dpts, ref_ddirs = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    assert float(ref_sigma.max()) > 0.0 and float(ref_rgb.std()) > 0.0
    if dtype == torch.float32:
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sigma.numpy(), ref_sigma.numpy(), **tol)
        np.testing.assert_allclose(rgb.numpy(), ref_rgb.numpy(), **tol)
        for name in LAYER_NAMES:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(grads[name][leaf].numpy(), ref[name][leaf].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{name}.{leaf}")
        # the encode VJP sums terms up to 2^(L-1) x the cotangent, so an
        # element that cancels shows a sum order's difference: by relative L2
        assert _rel(dpts, ref_dpts) < 1e-5 and _rel(ddirs, ref_ddirs) < 1e-5
        return
    np.testing.assert_allclose(sigma.numpy(), ref_sigma.numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(rgb.numpy(), ref_rgb.numpy(), rtol=0, atol=2e-2)
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            assert _rel(grads[name][leaf], ref[name][leaf]) < 2e-2, (name, leaf)
    assert _rel(dpts, ref_dpts) < 2e-2 and _rel(ddirs, ref_ddirs) < 2e-2


def test_general_layout_puts_sigma_after_the_features_and_pads_each_segment():
    cfg = _cfg(48, level=11, dtype=torch.float32)
    params = _params(cfg)
    mats = fused_nerf.general_matrices(params, cfg)
    pe, de = cfg.pos_enc_dim, cfg.dir_enc_dim  # 69, 27
    fwd5 = mats[5][0]
    assert fwd5.shape == (80 + 64, 64)
    assert torch.equal(fwd5[:pe, :48], params["fc_5"]["w"][:pe]) and not fwd5[pe:80].any()
    assert torch.equal(fwd5[80:128, :48], params["fc_5"]["w"][pe:])
    fwd8, b8 = mats[8][0], mats[8][1]
    assert fwd8.shape == (64, 72)
    assert torch.equal(fwd8[:48, 64], params["fc_8"]["w"][:, 0]) and b8[64] == params["fc_8"]["b"][0]
    assert torch.equal(fwd8[:48, :48], params["fc_8"]["w"][:, 1:])
    fwd9 = mats[9][0]
    assert fwd9.shape == (64 + 32, 32)
    assert torch.equal(fwd9[64:64 + de, :24], params["fc_9"]["w"][48:]) and not fwd9[64 + de:].any()
    assert mats[10][2].shape == (16, 32) and mats[8][2].shape == (80, 64)


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
