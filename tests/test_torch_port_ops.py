"""The port's geometry, encoding, sampling, compositing, config, IO and
metrics held against the JAX package on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6 for float32 ops (XLA and torch evaluate the
same formulas, with last-ulp differences in transcendental functions and in
summation order).
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import encoders as jenc
from torch_nerf_tpu import logging_utils as jlog
from torch_nerf_tpu import metrics as jmetrics
from torch_nerf_tpu.datasets import synthetic as jsyn
from torch_nerf_tpu.ops import integration as jint
from torch_nerf_tpu.ops import sampling as jsamp
from torch_nerf_tpu_torch import cameras, checkpoints, config, encoders, logging_utils, metrics
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.ops import integration, sampling

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port),
        np.asarray(ref),
        rtol=rtol,
        atol=atol,
    )


def t(x):
    return torch.from_numpy(np.array(x))


CAMERA = (30.0, 32.0, 16, 12)
POSE = jsyn.pose_spherical(40.0, -30.0, 4.0)


# ---------------------------------------------------------------------------
# cameras


def test_screen_coords_match_jax():
    idx = np.arange(16 * 12, dtype=np.int32)
    close(cameras.screen_coords_from_indices(t(idx), 12, 16), jcam.screen_coords_from_indices(idx, 12, 16))


@pytest.mark.parametrize("use_ndc", [False, True])
def test_rays_for_pixels_match_jax(use_ndc):
    idx = np.random.default_rng(0).integers(0, 16 * 12, size=50).astype(np.int32)
    o, d = cameras.rays_for_pixels(
        t(idx), cameras.CameraParams(*CAMERA), t(POSE), use_ndc=use_ndc, ndc_z_near=1.0
    )
    jo, jd = jcam.rays_for_pixels(
        jnp.asarray(idx), jcam.CameraParams(*CAMERA), jnp.asarray(POSE), use_ndc=use_ndc
    )
    close(o, jo)
    close(d, jd)


def test_ndc_rays_match_jax():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    o[:, 2] = -np.abs(o[:, 2]) - 0.5
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.1
    po, pd = cameras.ndc_rays(t(o), t(d), 25.0, 1.0, 12, 16)
    jo, jd = jcam.ndc_rays(jnp.asarray(o), jnp.asarray(d), 25.0, 1.0, 12, 16)
    close(po, jo)
    close(pd, jd)


# ---------------------------------------------------------------------------
# encoders


@pytest.mark.parametrize("levels,include", [(4, True), (10, True), (2, False)])
def test_positional_encoding_matches_jax(levels, include):
    x = np.random.default_rng(2).uniform(-4, 4, size=(64, 3)).astype(np.float32)
    out = encoders.positional_encoding(t(x), levels, include)
    ref = jenc.positional_encoding(jnp.asarray(x), levels, include)
    assert out.shape[-1] == encoders.positional_encoding_dim(3, levels, include)
    assert encoders.positional_encoding_dim(3, levels, include) == jenc.positional_encoding_dim(3, levels, include)
    # 2^9 * 4 rad arguments: a last-ulp difference in the argument reduction
    close(out, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# sampling and compositing


def test_t_bins_and_stratified_match_jax():
    bins, size = sampling.t_bins(2.0, 6.0, 8)
    jbins, jsize = jsamp.t_bins(2.0, 6.0, 8)
    close(bins, jbins)
    assert size == jsize
    jitter = np.random.default_rng(3).uniform(size=(5, 8)).astype(np.float32)
    close(
        sampling.stratified_t_samples_from_uniforms(t(jitter), 2.0, 6.0),
        jnp.asarray(jbins)[None, :] + jsize * jnp.asarray(jitter),
    )


def _coarse_weights(rng, n, s):
    w = rng.uniform(size=(n, s)).astype(np.float32) ** 4
    w[0] = 0.0  # an all-empty ray: the 1e-5 regularizer alone
    return w


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(4)
    n, sc, sf = 64, 8, 16
    bins = np.broadcast_to(np.asarray(jsamp.t_bins(2.0, 6.0, sc)[0]), (n, sc)).astype(np.float32)
    weights = _coarse_weights(rng, n, sc)
    u = rng.uniform(size=(n, sf)).astype(np.float32)
    jitter = rng.uniform(size=(n, sf)).astype(np.float32)
    out = sampling.sample_pdf_from_uniforms(t(bins), 0.5, t(weights), t(u), t(jitter)).numpy()
    ref = np.asarray(jsamp.sample_pdf_from_uniforms(bins, 0.5, weights, u, jitter))
    # a u within an ulp of a CDF edge may pick the neighbouring bin
    mismatch = ~np.isclose(out, ref, rtol=RTOL, atol=ATOL)
    assert mismatch.sum() <= 2, mismatch.sum()


def test_hierarchical_samples_match_jax():
    rng = np.random.default_rng(5)
    n, sc, sf = 64, 8, 16
    weights = _coarse_weights(rng, n, sc)
    cj = rng.uniform(size=(n, sc)).astype(np.float32)
    u = rng.uniform(size=(n, sf)).astype(np.float32)
    fj = rng.uniform(size=(n, sf)).astype(np.float32)
    out = sampling.hierarchical_t_samples_from_uniforms(t(weights), 2.0, 6.0, t(cj), t(u), t(fj)).numpy()
    ref = np.asarray(jsamp.hierarchical_t_samples_from_uniforms(weights, 2.0, 6.0, cj, u, fj))
    assert out.shape == (n, sc + sf)
    assert np.all(np.diff(out, axis=-1) >= 0)
    mismatch = ~np.isclose(out, ref, rtol=RTOL, atol=ATOL)
    assert mismatch.sum() <= 2 * 2, mismatch.sum()


def test_generator_paths_draw_in_documented_order():
    gen = torch.Generator().manual_seed(7)
    t_s = sampling.stratified_t_samples(gen, 4, 2.0, 6.0, 8)
    gen2 = torch.Generator().manual_seed(7)
    jitter = torch.rand((4, 8), generator=gen2)
    close(t_s, sampling.stratified_t_samples_from_uniforms(jitter, 2.0, 6.0))
    weights = torch.rand((4, 8), generator=gen2)
    gen3 = torch.Generator().manual_seed(11)
    h = sampling.hierarchical_t_samples(gen3, weights, 2.0, 6.0, 8, 16)
    gen4 = torch.Generator().manual_seed(11)
    cj, uu, fj = torch.rand((4, 8), generator=gen4), torch.rand((4, 16), generator=gen4), torch.rand((4, 16), generator=gen4)
    close(h, sampling.hierarchical_t_samples_from_uniforms(weights, 2.0, 6.0, cj, uu, fj))


def test_t_deltas_and_points_match_jax():
    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(2, 6, size=(10, 12)).astype(np.float32), axis=-1)
    close(sampling.t_deltas(t(ts)), jsamp.t_deltas(jnp.asarray(ts)))
    o = rng.normal(size=(10, 3)).astype(np.float32)
    d = rng.normal(size=(10, 3)).astype(np.float32)
    close(sampling.points_along_rays(t(o), t(d), t(ts)), jsamp.points_along_rays(o, d, ts))


def test_composite_matches_jax():
    rng = np.random.default_rng(8)
    sigma = rng.uniform(0, 5, size=(16, 24)).astype(np.float32)
    rad = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(2, 6, size=(16, 24)).astype(np.float32), axis=-1)
    delta = np.asarray(jsamp.t_deltas(jnp.asarray(ts)))
    rgb, w = integration.composite(t(sigma), t(rad), t(delta))
    jrgb, jw = jint.composite(jnp.asarray(sigma), jnp.asarray(rad), jnp.asarray(delta))
    close(rgb, jrgb)
    close(w, jw)


# ---------------------------------------------------------------------------
# procedural scene


def test_synthetic_scene_matches_jax():
    scene, jscene = synthetic.GaussianBlobScene.random(3), jsyn.GaussianBlobScene.random(3)
    assert scene == synthetic.GaussianBlobScene(**{f: getattr(jscene, f) for f in ("centers", "scales", "amplitudes", "colors")})
    pts = np.random.default_rng(9).uniform(-1, 1, size=(32, 3)).astype(np.float32)
    s, c = scene.field(t(pts))
    js, jc = jscene.field(jnp.asarray(pts))
    close(s, js, atol=1e-5)
    close(c, jc)
    for split in ("train", "val", "test"):
        np.testing.assert_allclose(synthetic.split_poses(3, split), jsyn.split_poses(3, split), atol=1e-6)
    np.testing.assert_allclose(synthetic.orbit_poses(5), jsyn.orbit_poses(5), atol=1e-6)


def test_ground_truth_images_match_jax():
    images, poses, camera, _ = synthetic.make_dataset(num_views=2, img_size=12, split="test")
    jimages, jposes, jcamera, _ = jsyn.make_dataset(num_views=2, img_size=12, split="test")
    assert tuple(camera) == tuple(jcamera)
    np.testing.assert_allclose(poses, jposes)
    np.testing.assert_allclose(images, jimages, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_config_defaults_equal_jax(preset):
    assert config.to_dict(config.PRESETS[preset]()) == jcfg.to_dict(jcfg.PRESETS[preset]())


@pytest.mark.parametrize("name", ["config.yaml", "config.json"])
def test_config_files_cross_load(tmp_path, name):
    cfg = config.resolve("default", ["renderer.num_pixels=1024", "parallel.use_pallas=false", "data.half_res=0"])
    config.save_config(cfg, tmp_path / name)
    assert jcfg.to_dict(jcfg.load_config(tmp_path / name)) == config.to_dict(cfg)
    jcfg.save_config(jcfg.resolve("default", ["network.feat_dim=64"]), tmp_path / ("j" + name))
    assert config.load_config(tmp_path / ("j" + name)).network.feat_dim == 64
    assert cfg.parallel.use_pallas is False and cfg.data.half_res is False
    with pytest.raises(ValueError):
        config.apply_overrides(cfg, ["no_equals_sign"])


# ---------------------------------------------------------------------------
# PNG, metrics, checkpoints


def _png_with_filters(pixels, filters):
    """Encode ``pixels`` (H, W, C) uint8 with the given filter type per row."""
    h, w, c = pixels.shape
    img = pixels.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        x = img[y]
        up = img[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = filters[y % len(filters)]
        pred = {
            0: 0,
            1: left,
            2: up,
            3: (left + up) >> 1,
            4: np.asarray(logging_utils._paeth(left, up, ul)),
        }[f]
        rows.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_handles_every_filter(channels):
    pixels = np.random.default_rng(10).integers(0, 256, size=(10, 7, channels)).astype(np.uint8)
    data = _png_with_filters(pixels, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(logging_utils.decode_png(data), pixels)
    np.testing.assert_array_equal(logging_utils.decode_png(logging_utils.encode_png(pixels)), pixels)


def test_save_png_reads_back_like_jax(tmp_path):
    img = np.random.default_rng(11).uniform(-0.1, 1.1, size=(9, 13, 3)).astype(np.float32)
    logging_utils.save_png(tmp_path / "port.png", img)
    jlog.save_png(tmp_path / "jax.png", img)
    np.testing.assert_array_equal(logging_utils.load_png(tmp_path / "port.png"), logging_utils.load_png(tmp_path / "jax.png"))


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    a = rng.uniform(size=(20, 18, 3))
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    assert metrics.psnr(a, b) == pytest.approx(jmetrics.psnr(a, b), rel=1e-9)
    assert metrics.ssim(a, b) == pytest.approx(jmetrics.ssim(a, b), rel=1e-9)
    assert metrics.ssim(a[:7, :9], b[:7, :9]) == pytest.approx(jmetrics.ssim(a[:7, :9], b[:7, :9]), rel=1e-9)
    assert metrics.psnr(a, a) == float("inf")
    (tmp_path / "p").mkdir()
    (tmp_path / "g").mkdir()
    for i in range(2):
        jlog.save_png(tmp_path / "p" / f"{i:04d}.png", a + 0.0 * i)
        jlog.save_png(tmp_path / "g" / f"{i:04d}.png", b)
    out = metrics.compare_directories(tmp_path / "p", tmp_path / "g")
    ref = jmetrics.compare_directories(tmp_path / "p", tmp_path / "g")
    assert out["psnr"] == pytest.approx(ref["psnr"], rel=1e-9)
    assert out["ssim"] == pytest.approx(ref["ssim"], rel=1e-9)


def test_checkpoints_latest_wins(tmp_path):
    assert checkpoints.restore_latest(tmp_path) is None
    p = {"coarse": {"fc_in": {"w": torch.ones(2, 3), "b": torch.zeros(3)}}}
    checkpoints.save_checkpoint(tmp_path, 5, p)
    q = {"coarse": {"fc_in": {"w": 2 * torch.ones(2, 3), "b": torch.zeros(3)}}}
    checkpoints.save_checkpoint(tmp_path, 12, q)
    assert checkpoints.latest_checkpoint(tmp_path).name == "ckpt_000012.pt"
    state = checkpoints.restore_latest(tmp_path, device=torch.device("cpu"))
    assert state["step"] == 12
    assert torch.equal(state["params"]["coarse"]["fc_in"]["w"], q["coarse"]["fc_in"]["w"])
