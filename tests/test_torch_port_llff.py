"""The port's LLFF + NDC slice against the JAX package.

Forward-facing scenes are written with numpy from a seed into ``tmp_path``
data roots (the loader writes its ``images_{factor}/`` cache there), one copy
for each package, since a first load returns the pooled floats and a later
one the cached 8-bit PNGs. Both loaders are numpy: images, poses, render
poses and bounds must be equal, bit for bit. The NDC render of the held-out
view goes through ``renderer.render_image`` on JAX's weights
(``params_from_jax``) and JAX's draws: the finite masks must be equal and
the finite values within 1e-4 (float32). A rig of cameras on the plane
z = 0, as ``test_cli.py``'s, puts every NDC ray's origin at z = 0, where
``cameras.ndc_rays`` divides by it: every pixel is NaN on both sides. Then
``run_train`` -> resume -> ``run_render`` -> ``evaluate`` on ``--device cpu``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu import renderer as jrend
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu.datasets import llff as jllff
from torch_nerf_tpu_torch import cameras, config, renderer, session
from torch_nerf_tpu_torch.datasets import llff
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

L_POS, L_DIR, FEAT = 4, 2, 32


def write_scene(root, planar=False, n_views=5, h=32, w=40, focal=40.0, seed=3):
    """A forward-facing LLFF scene under ``root/fern``: ``poses_bounds.npy``
    rows as ``test_cli.py`` builds them and smooth images with noise. The
    cameras sit on a lateral line (``planar``, ``test_cli.py``'s rig) or are
    jittered in position and turned by a few degrees about each axis."""
    rng = np.random.default_rng(seed)
    img_dir = root / "fern" / "images"
    img_dir.mkdir(parents=True)
    rows = []
    for i in range(n_views):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx / w, yy / h, np.full_like(xx, 0.5, dtype=float)], axis=-1)
        img = (img * 255 + rng.normal(0, 4, (h, w, 3))).clip(0, 255) / 255.0
        save_png(img_dir / f"img_{i:03d}.png", img)
        c2w = np.eye(4)[:3].copy()
        c2w[0, 3] = 0.06 * i
        if not planar:
            a, b, c = rng.normal(0.0, 0.05, 3)
            rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
            ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
            rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
            c2w[:, :3] = rx @ ry @ rz
            c2w[:, 3] += rng.normal(0.0, 0.2, 3)
        raw = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]], axis=1)
        hwf = np.array([[h], [w], [focal]])
        rows.append(np.concatenate([np.concatenate([raw, hwf], axis=1).reshape(-1), [2.0, 6.0]]))
    np.save(root / "fern" / "poses_bounds.npy", np.stack(rows))
    return root


@pytest.fixture
def two_roots(tmp_path):
    """The same scene in two data roots: the port's and JAX's."""
    port = write_scene(tmp_path / "port")
    shutil.copytree(port, tmp_path / "jax")
    return port, tmp_path / "jax"


def _same(got, ref):
    for name in ("images", "poses", "render_poses", "z_bounds"):
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tuple(got.camera) == tuple(ref.camera)
    assert got.image_names == ref.image_names


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("recenter,spherify", [(True, False), (False, False), (True, True), (False, True)])
def test_load_llff_matches_jax(two_roots, factor, recenter, spherify):
    port_root, jax_root = two_roots
    kwargs = dict(factor=factor, recenter=recenter, spherify=spherify)
    for _ in range(2):  # the first load pools, the second reads the cache
        got = llff.load_llff(port_root, "fern", **kwargs)
        ref = jllff.load_llff(jax_root, "fern", **kwargs)
        _same(got, ref)
    assert got.images.shape == (5, 32 // factor, 40 // factor, 3)
    assert (port_root / "fern" / f"images_{factor}").exists() == (factor > 1)
    assert llff.llff_holdout_index(got.poses) == jllff.llff_holdout_index(np.asarray(ref.poses))
    for ndc in (False, True):
        assert llff.llff_t_bounds(got.z_bounds, ndc) == jllff.llff_t_bounds(np.asarray(ref.z_bounds), ndc)


def test_llff_cache_and_errors(tmp_path):
    root = write_scene(tmp_path / "d")
    first = llff.load_llff(root, "fern", factor=2)
    cache = root / "fern" / "images_2"
    assert sorted(p.name for p in cache.iterdir()) == [f"img_{i:03d}.png" for i in range(5)]
    # later loads read the 8-bit cache: within half a level of the pooled floats
    np.testing.assert_allclose(llff.load_llff(root, "fern", factor=2).images, first.images, atol=0.5 / 255 + 1e-7)
    # a cache with fewer images than the source is stale and rebuilt
    (cache / "img_000.png").unlink()
    np.testing.assert_array_equal(llff.load_llff(root, "fern", factor=2).images, first.images)
    assert len(list(cache.iterdir())) == 5
    with pytest.raises(ValueError, match="Unsupported scene"):
        llff.load_llff(root, "lego")
    with pytest.raises(FileNotFoundError):
        llff.load_llff(tmp_path / "missing", "fern")
    assert llff.llff_t_bounds(np.array([[1.5, 4.0]]), False) == (pytest.approx(1.35), 4.0)


LLFF_OVERRIDES = [
    "data.dataset_type=nerf_llff",
    "data.scene_name=fern",
    "data.factor=2",
    "renderer.project_to_ndc=true",
    f"network.feat_dim={FEAT}",
    f"signal_encoder.coord_encode_level={L_POS}",
    f"signal_encoder.dir_encode_level={L_DIR}",
    "renderer.num_pixels=64",
    "renderer.num_samples_coarse=8",
    "renderer.num_samples_fine=8",
    "train_params.optim.num_iter=8",
    "train_params.validation.validate_every=1000",
    "train_params.log.epoch_btw_ckpt=2",
    "train_params.log.epoch_btw_vis=1000",
]


@pytest.mark.parametrize("split", ["train", "test"])
def test_session_llff_split_and_t_bounds_match_jax(two_roots, split):
    port_root, jax_root = two_roots
    for ndc in ("true", "false"):
        over = LLFF_OVERRIDES + [f"renderer.project_to_ndc={ndc}"]
        cfg = config.resolve("default", over + [f"data.data_root={port_root}"])
        jconf = jcfg.resolve("default", over + [f"data.data_root={jax_root}"])
        got, ref = session.build_dataset(cfg, split), jsession.build_dataset(jconf, split)
        _same(got, ref)
        assert got.num_views == (4 if split == "train" else 1)
        settings = session.build_render_settings(cfg, got)
        jsettings = jsession.build_render_settings(jconf, ref)
        assert (settings.t_near, settings.t_far, settings.project_to_ndc) == (
            jsettings.t_near, jsettings.t_far, jsettings.project_to_ndc)
        if ndc == "true":
            assert (settings.t_near, settings.t_far) == (0.0, 1.0)


def _jax_uniforms(key, settings):
    """JAX ``render_image``'s draws for the chunk at ``first_pixel``."""
    sc, sf = settings.num_samples_coarse, settings.num_samples_fine

    def draw(first_pixel, n):
        k = jax.random.fold_in(key, jnp.int32(first_pixel))
        coarse_key, fine_key = jax.random.split(k)
        ck, fk = jax.random.split(fine_key)
        uk, jk = jax.random.split(fk)
        arrays = [jax.random.uniform(coarse_key, (n, sc)), jax.random.uniform(ck, (n, sc)),
                  jax.random.uniform(uk, (n, sf)), jax.random.uniform(jk, (n, sf))]
        return renderer.RayUniforms(*(torch.from_numpy(np.array(a)) for a in arrays))

    return draw


@pytest.mark.parametrize("planar", [False, True])
def test_ndc_render_finite_mask_and_values_match_jax(tmp_path, planar):
    root = write_scene(tmp_path, planar=planar)
    over = LLFF_OVERRIDES + [f"data.data_root={root}"]
    cfg, jconf = config.resolve("default", over), jcfg.resolve("default", over)
    data, jdata = session.build_dataset(cfg, "test"), jsession.build_dataset(jconf, "test")
    settings, jsettings = session.build_render_settings(cfg, data), jsession.build_render_settings(jconf, jdata)
    jfield = jfields.make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(np.asarray, {"coarse": jfield.init(kc), "fine": jfield.init(kf)})
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jrend.render_image(jfield, jtree["coarse"], jtree["fine"], jcam.CameraParams(*jdata.camera),
                                        jnp.asarray(jdata.poses[0]), key, jsettings, chunk_size=64))
    ptree = params_from_jax(jtree)
    img = renderer.render_image(
        make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT), ptree["coarse"],
        ptree["fine"], data.camera, torch.from_numpy(data.poses[0]), 4, settings, chunk_size=64,
        uniforms_for_chunk=_jax_uniforms(key, settings),
    ).numpy()
    finite = np.isfinite(img)
    np.testing.assert_array_equal(finite, np.isfinite(ref))
    np.testing.assert_allclose(img[finite], ref[finite], rtol=0, atol=1e-4)
    # the planar rig's origins lie on z = 0, where the NDC projection divides
    assert finite.all() == (not planar) and finite.any() == (not planar)
    o, _ = cameras.rays_for_pixels(torch.arange(4), data.camera, torch.from_numpy(data.poses[0]))
    assert (o[:, 2] == 0).all() == planar


def test_llff_ndc_cli_round_trip_on_cpu(tmp_path, capsys):
    root = write_scene(tmp_path / "data")
    run = tmp_path / "run"
    base = ["--config", "default", "--log-dir", str(run), "--device", "cpu"]
    first = run_train.main(base + ["--max-steps", "8", f"data.data_root={root}"] + LLFF_OVERRIDES)
    # num_iter=8 over 4 training views: 2 epochs, 8 steps
    assert first["step"] == 8 and all(np.isfinite(first["losses"]))
    assert (root / "fern" / "images_2").exists()
    capsys.readouterr()
    resumed = run_train.main(base + ["--max-steps", "10", "train_params.optim.num_iter=12"])
    assert "Resumed from step 8" in capsys.readouterr().out
    assert resumed["step"] == 10 and all(np.isfinite(resumed["losses"]))

    out_dir, gt_dir = tmp_path / "render", tmp_path / "gt"
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "1", "--out-dir", str(out_dir),
                     "--device", "cpu"])
    data = session.build_dataset(config.load_config(run / "config.yaml"), "test")
    gt_dir.mkdir()
    save_png(gt_dir / "0000.png", data.images[0])
    assert load_png(out_dir / "0000.png").shape == data.images[0].shape == (16, 20, 3)
    scores = evaluate.main([str(out_dir), str(gt_dir), "--device", "cpu"])
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
