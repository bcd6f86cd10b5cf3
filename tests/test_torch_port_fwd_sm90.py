"""The field's forward kernel (kernel 1) on its two routes, and the check
that refuses, before any data loads, a config the card cannot train.

Kernel 1 takes bf16 widths 64, 128 and 256 on ``wgmma``, reading the
training kernels' forward images, any other bf16 config up to width 1024
on ``wgmma_general`` (the tensor-core general route's column passes) and
f32 on ``f32_wgmma`` or ``f32``, reading the general route's images or
matrices (``fused_nerf.forward_route``). The
kernel runs only on a Hopper card; here the Python side of its contract
is held on the CPU: the forward images of ``kernel_weights`` turn back into
the padded W^T of ``training_matrices``, and a plain walk over the images,
one 64-wide K-slice at a time in the kernel's K order and with its
roundings, reproduces ``fused_nerf_apply_reference`` and the JAX package's
``fused_nerf_apply`` (the Pallas kernel in interpret mode, f32) and its XLA
reference ``nerf_apply`` in bf16. Inputs come from a seeded numpy
generator; the weights are bf16-rounded so that the f32 comparisons see the
images' own values. Tolerances: f32 rtol 1e-4 / atol 1e-4 (the same sums
in another order); bf16 atol 2e-2 against JAX (each layer rounds to bf16,
one tie may break one ulp apart: the bound of the existing parity tests)
and atol 1e-2 against the port's plain bf16 version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_sm90 import _unpanel

from torch_nerf_tpu import encoders as jencoders
from torch_nerf_tpu.models import nerf as jnerf
from torch_nerf_tpu.ops.pallas.fused_nerf import FusedNeRFConfig as JaxFusedConfig
from torch_nerf_tpu.ops.pallas.fused_nerf import fused_nerf_apply as jax_fused_nerf_apply
from torch_nerf_tpu_torch import config, encoders, session
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params, params_to_jax
from torch_nerf_tpu_torch.ops import fused_nerf
from torch_nerf_tpu_torch.runners import run_train

WIDTHS = (64, 128)


def _params(feat, seed=0):
    """Seeded port-init weights, rounded to bf16 (the images' values)."""
    params = init_nerf_params(torch.Generator().manual_seed(seed), 63, 27, feat)
    return {n: {k: t.to(torch.bfloat16).float() for k, t in v.items()} for n, v in params.items()}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.mark.parametrize("feat", WIDTHS)
def test_wgmma_weights_are_the_forward_images(feat):
    params = _params(feat)
    cfg = fused_nerf.FusedNeRFConfig(feat_dim=feat)
    w = fused_nerf.kernel_weights(params, cfg, "wgmma")
    mats = fused_nerf.training_matrices(params, cfg)
    assert w.route == "wgmma" and len(w.weights) == len(w.biases) == len(LAYER_NAMES)
    for i, name in enumerate(LAYER_NAMES):
        fwd, bias, _ = mats[i]
        assert w.weights[i].dtype == torch.bfloat16 and w.weights[i].dim() == 1, name
        assert torch.equal(_unpanel(w.weights[i], *fwd.shape), fwd), name
        assert torch.equal(w.biases[i], bias), name
    # the tensor-core general route reads tc_layout's forward images and
    # biases (any bf16 config; the mma.sync route is gone)
    tc = fused_nerf.kernel_weights(params, cfg, "wgmma_general")
    images, biases, _ = fused_nerf.tc_layout(params, cfg)
    assert tc.route == "wgmma_general"
    assert all(torch.equal(a, b) for a, b in zip(tc.weights, images))
    assert all(torch.equal(a, b) for a, b in zip(tc.biases, biases))
    for route in ("tensor_cores", "mma_sync"):
        with pytest.raises(ValueError, match="route"):
            fused_nerf.kernel_weights(params, cfg, route)


def _walk(image, rows, cols, x):
    """x (M, cols) times the image's (rows, cols) matrix transposed, one
    64-wide K-slice at a time, rows read at the swizzle's addresses; f32
    sums of the operands."""
    acc = torch.zeros((x.shape[0], rows))
    r = torch.arange(rows)[:, None]
    c = torch.arange(64)[None, :]
    for s in range(cols // 64):
        b = image[s * rows * 64 + fused_nerf.swizzle128(r, c) // 2].float()
        acc += x[:, 64 * s:64 * s + 64].float() @ b.t()
    return acc


def _pad64(x):
    return torch.nn.functional.pad(x, (0, -(-x.shape[1] // 64) * 64 - x.shape[1]))


def walk_forward(w, mats, pts, dirs, cfg):
    """The kernel's forward over its images: every layer a walk over its
    image's K-slices in the kernel's K order ([pe] for fc_in, [pe, h4] for
    fc_5, [features, de] for fc_9, each encoding padded to 64), the bias in
    the image's row order (fc_8's sigma at row F); in bf16 each output is
    bf16(bf16(acc) + b), in f32 acc + b. -> sigma (M,), rgb (M, 3) in f32."""
    f = cfg.feat_dim
    bf16 = cfg.compute_dtype == torch.bfloat16

    def layer(i, x):
        rows, cols = mats[i][0].shape
        acc = _walk(w.weights[i], rows, cols, x)
        b = w.biases[i].float()
        if bf16:
            return (acc.to(torch.bfloat16).float() + b).to(torch.bfloat16).float()
        return acc + b

    def act(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    pe = _pad64(act(encoders.positional_encoding(pts, cfg.coord_encode_level, cfg.include_input)))
    de = _pad64(act(encoders.positional_encoding(dirs, cfg.dir_encode_level, cfg.include_input)))
    h = torch.relu(layer(0, pe))
    for i in range(1, 8):
        h = torch.relu(layer(i, torch.cat([pe, h], dim=1) if i == 5 else h))
    z8 = layer(8, h)
    sigma = torch.relu(z8[:, f])
    h9 = torch.relu(layer(9, torch.cat([z8[:, :f], de], dim=1)))
    rgb = torch.sigmoid(layer(10, _pad64(h9))[:, :3])
    return sigma, rgb


@pytest.mark.parametrize("feat", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_walk_over_the_forward_images_is_the_field(feat, dtype):
    params = _params(feat, seed=feat)
    pts, dirs = _data(100, seed=feat)  # not a multiple of the 128-point tile
    cfg = fused_nerf.FusedNeRFConfig(feat_dim=feat, compute_dtype=getattr(torch, dtype))
    bcfg = fused_nerf.FusedNeRFConfig(feat_dim=feat)
    w = fused_nerf.kernel_weights(params, bcfg, "wgmma")
    mats = fused_nerf.training_matrices(params, bcfg)
    tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
    sigma, rgb = walk_forward(w, mats, tp, td, cfg)
    ref_sigma, ref_rgb = fused_nerf.fused_nerf_apply_reference(params, tp, td, cfg)
    jparams = params_to_jax(params)
    if dtype == "float32":
        jcfg = JaxFusedConfig(feat_dim=feat, tile=64, compute_dtype=jnp.float32, interpret=True)
        jsigma, jrgb = jax_fused_nerf_apply(jparams, jnp.asarray(pts), jnp.asarray(dirs), jcfg)
        tol = dict(rtol=1e-4, atol=1e-4)
        ref_tol = tol
    else:
        pe = jencoders.positional_encoding(jnp.asarray(pts), 10, True)
        de = jencoders.positional_encoding(jnp.asarray(dirs), 4, True)
        jsigma, jrgb = jnerf.nerf_apply(jparams, pe, de, compute_dtype=jnp.bfloat16)
        tol = dict(rtol=0, atol=2e-2)
        ref_tol = dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(sigma.numpy(), ref_sigma.numpy(), **ref_tol)
    np.testing.assert_allclose(rgb.numpy(), ref_rgb.numpy(), **ref_tol)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma, dtype=np.float32), **tol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb, dtype=np.float32), **tol)
    assert float(ref_sigma.max()) > 0.0 and float(rgb.std()) > 0.0


@pytest.mark.parametrize("feat,route", [(64, "wgmma"), (128, "wgmma"), (256, "wgmma"),
                                        (96, "wgmma_general"), (160, "wgmma_general")])
def test_forward_route_by_width(feat, route):
    assert fused_nerf.forward_route(fused_nerf.FusedNeRFConfig(feat_dim=feat)) == route


def test_forward_route_raises_and_keeps_every_width():
    # a width off the 32s is padded (48 to 64, onto the tensor-core general
    # route), f32 takes wgmma on bf16 pieces, 1024 four column passes (f32
    # at 1024: streaming its layers through device memory); past the limits
    # the route raises
    assert fused_nerf.forward_route(fused_nerf.FusedNeRFConfig(feat_dim=48)) == "wgmma_general"
    assert fused_nerf.forward_route(fused_nerf.FusedNeRFConfig(compute_dtype=torch.float32)) == "f32_wgmma"
    wide = fused_nerf.FusedNeRFConfig(feat_dim=1024)
    assert fused_nerf.forward_route(wide) == "wgmma_general" and fused_nerf.tc_plan(wide).passes == 4
    with pytest.raises(ValueError, match="feat_dim up to 1024"):
        fused_nerf.forward_route(fused_nerf.FusedNeRFConfig(feat_dim=1056))
    # encodings wider than 64 leave the wgmma route but are still served
    assert fused_nerf.forward_route(fused_nerf.FusedNeRFConfig(coord_encode_level=11)) == "wgmma_general"
    wide32 = dataclasses.replace(wide, compute_dtype=torch.float32)
    assert fused_nerf.forward_route(wide32) == "f32_wgmma" and fused_nerf.tc_plan(wide32).stream


def test_route_launch_counts_start_at_zero_and_reset():
    fused_nerf.fused_nerf_apply.route_launches["wgmma_general"] += 2
    fused_nerf.fused_nerf_apply.launches += 2
    fused_nerf.reset_launches()
    assert fused_nerf.fused_nerf_apply.launches == 0
    assert fused_nerf.fused_nerf_apply.route_launches == {"wgmma": 0, "wgmma_general": 0, "f32_wgmma": 0}


@pytest.mark.parametrize("override,key", [("network.feat_dim=2048", "network.feat_dim"),
                                          ("signal_encoder.coord_encode_level=21",
                                           "signal_encoder.coord_encode_level")])
def test_run_train_refuses_an_untrainable_config_before_any_data(override, key, tmp_path, monkeypatch):
    def no_data(*args, **kwargs):
        raise AssertionError("a dataset was built before the config was checked")

    # the device as run_train resolves it on a machine with a card; no
    # kernel runs before the check
    monkeypatch.setattr(run_train, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(session, "build_dataset", no_data)
    argv = ["--log-dir", str(tmp_path / "run"), "--device", "cuda", override,
            "data.dataset_type=nerf_synthetic", f"data.data_root={tmp_path / 'missing'}"]
    with pytest.raises(ValueError) as err:
        run_train.main(argv)
    assert key in str(err.value) and "parallel.use_pallas=false" in str(err.value)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("override", ["network.feat_dim=2048", "signal_encoder.coord_encode_level=21"])
def test_check_trainable_passes_on_the_plain_path_and_on_the_cpu(override):
    cfg = config.resolve("default", [override])
    with pytest.raises(ValueError, match="parallel.use_pallas=false"):
        session.check_trainable(cfg, torch.device("cuda"))
    session.check_trainable(cfg, torch.device("cpu"))
    session.check_trainable(config.resolve("default", [override, "parallel.use_pallas=false"]),
                            torch.device("cuda"))
    # what the kernels take passes, and so does an NGP field, which never reaches them
    session.check_trainable(config.resolve("default", []), torch.device("cuda"))
    session.check_trainable(config.resolve("instant_nerf", []), torch.device("cuda"))
