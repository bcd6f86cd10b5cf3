"""The port's render slice end to end against the JAX package.

``render_image`` is held against JAX's ``render_image`` on the same key:
each chunk's four uniform draws are regenerated in JAX from that key (fold
in the chunk's first pixel, split into the coarse and fine keys, and the
draws of ``sampling.stratified_t_samples`` and
``sampling.hierarchical_t_samples``) and handed to the port. float32 on
both sides, atol 1e-4 on pixels (inverse-CDF bins can move by one for a u
within an ulp of a CDF edge). Then the ``run_render`` -> ``evaluate`` CLIs
run with ``--device cpu`` from a checkpoint of carried-over JAX weights, and
their PNGs must match JAX's render of the same weights within 1/255.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu import logging_utils as jlog
from torch_nerf_tpu import metrics as jmetrics
from torch_nerf_tpu import renderer as jrend
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu_torch import cameras, checkpoints, config, renderer, session
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.ops import fused_nerf
from torch_nerf_tpu_torch.runners import evaluate, run_render

REPO = Path(__file__).resolve().parents[1]
L_POS, L_DIR, FEAT = 4, 2, 64
SMALL = [
    "data.dataset_type=gaussian_blobs",
    "data.img_size=8",
    "data.num_views=3",
    "network.feat_dim=64",
    "signal_encoder.coord_encode_level=4",
    "signal_encoder.dir_encode_level=2",
    "renderer.num_samples_coarse=8",
    "renderer.num_samples_fine=16",
    "renderer.num_pixels=64",
    "device.compute_dtype=float32",
]


def jax_uniforms(key, settings):
    """``(first_pixel, n) -> RayUniforms``: the draws JAX's render_image
    makes for the chunk starting at ``first_pixel``."""
    sc, sf = settings.num_samples_coarse, settings.num_samples_fine

    def draw(first_pixel, n):
        k = jax.random.fold_in(key, jnp.int32(first_pixel))
        coarse_key, fine_key = jax.random.split(k)
        ck, fk = jax.random.split(fine_key)
        uk, jk = jax.random.split(fk)
        arrays = [
            jax.random.uniform(coarse_key, (n, sc), jnp.float32),
            jax.random.uniform(ck, (n, sc), jnp.float32),
            jax.random.uniform(uk, (n, sf), jnp.float32),
            jax.random.uniform(jk, (n, sf), jnp.float32),
        ]
        return renderer.RayUniforms(*(torch.from_numpy(np.array(a)) for a in arrays))

    return draw


def _jax_nets(seed):
    jfield = jfields.make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    tree = {"coarse": jfield.init(kc), "fine": jfield.init(kf)}
    return jfield, jax.tree_util.tree_map(np.asarray, tree)


def _port_field():
    return make_nerf_field(coord_encode_level=L_POS, dir_encode_level=L_DIR, feat_dim=FEAT)


@pytest.mark.parametrize("chunk,fine", [(64, 16), (48, 16), (48, 0)])
def test_render_image_matches_jax(chunk, fine):
    jfield, jtree = _jax_nets(0)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=fine)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=fine)
    pose = synthetic.split_poses(2, "test")[1]
    key = jax.random.PRNGKey(3)
    fine_params = jtree["fine"] if fine else None
    ref = jrend.render_image(
        jfield, jtree["coarse"], fine_params, jcam.CameraParams(19.2, 19.2, 16, 16),
        jnp.asarray(pose), key, jsettings, chunk_size=chunk,
    )
    ptree = params_from_jax(jtree)
    img = renderer.render_image(
        _port_field(), ptree["coarse"], ptree["fine"] if fine else None,
        cameras.CameraParams(19.2, 19.2, 16, 16), torch.from_numpy(pose), 3, settings,
        chunk_size=chunk, uniforms_for_chunk=jax_uniforms(key, settings),
    )
    assert img.shape == (16, 16, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_render_rays_outputs_match_jax():
    jfield, jtree = _jax_nets(1)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=16)
    jsettings = jrend.RenderSettings(num_samples_coarse=8, num_samples_fine=16)
    pose = synthetic.split_poses(1, "train")[0]
    idx = np.arange(0, 256, 4, dtype=np.int32)
    jo, jd = jcam.rays_for_pixels(jnp.asarray(idx), jcam.CameraParams(19.2, 19.2, 16, 16), jnp.asarray(pose))
    key = jax.random.PRNGKey(5)
    jit_render_rays = jax.jit(jrend.render_rays, static_argnames=("field", "settings"))
    ref = jit_render_rays(jfield, jtree["coarse"], jtree["fine"], jo, jd, key, jsettings)
    # the draws JAX's render_rays makes from `key` itself
    sc, sf = 8, 16
    coarse_key, fine_key = jax.random.split(key)
    ck, fk = jax.random.split(fine_key)
    uk, jk = jax.random.split(fk)
    n = idx.size
    uniforms = renderer.RayUniforms(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(coarse_key, (n, sc)), jax.random.uniform(ck, (n, sc)),
        jax.random.uniform(uk, (n, sf)), jax.random.uniform(jk, (n, sf)),
    )))
    ptree = params_from_jax(jtree)
    out = renderer.render_rays(
        _port_field(), ptree["coarse"], ptree["fine"], torch.from_numpy(np.array(jo)),
        torch.from_numpy(np.array(jd)), None, settings, uniforms,
    )
    for name in ("rgb_coarse", "weights_coarse", "t_coarse", "rgb_fine", "weights_fine", "t_fine"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=1e-4, atol=1e-4)


def test_render_image_default_draws_are_seeded_per_chunk():
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=16)
    ptree = params_from_jax(_jax_nets(2)[1])
    cam = cameras.CameraParams(19.2, 19.2, 16, 16)
    pose = torch.from_numpy(synthetic.split_poses(1, "train")[0])
    field = _port_field()
    a = renderer.render_image(field, ptree["coarse"], ptree["fine"], cam, pose, 7, settings, chunk_size=64)
    b = renderer.render_image(field, ptree["coarse"], ptree["fine"], cam, pose, 7, settings, chunk_size=64)
    c = renderer.render_image(field, ptree["coarse"], ptree["fine"], cam, pose, 8, settings, chunk_size=64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert renderer.chunk_seed(7, 64) != renderer.chunk_seed(7, 0) != renderer.chunk_seed(8, 0)


def _write_run(tmp_path, jtree):
    run = tmp_path / "run"
    cfg = config.resolve("default", SMALL)
    config.save_config(cfg, run / "config.yaml")
    checkpoints.save_checkpoint(run, 42, params_from_jax(jtree))
    return run, cfg


def test_cli_render_evaluate_round_trip_matches_jax(tmp_path, monkeypatch):
    jfield, jtree = _jax_nets(4)
    run, cfg = _write_run(tmp_path, jtree)
    settings = session.build_render_settings(cfg)

    # the CLI renders view i with seed i; give each view JAX's draws for PRNGKey(i)
    def with_jax_draws(field, pc, pf, camera, extrinsic, seed, settings, chunk_size):
        return renderer.render_image(
            field, pc, pf, camera, extrinsic, seed, settings, chunk_size,
            uniforms_for_chunk=jax_uniforms(jax.random.PRNGKey(seed), settings),
        )

    monkeypatch.setattr(run_render, "render_image", with_jax_draws)
    run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "2", "--device", "cpu"])
    assert sorted(p.name for p in (run / "render").iterdir()) == ["0000.png", "0001.png"]

    jconf = jcfg.resolve("default", SMALL)
    jdata = jsession.build_dataset(jconf, "test")
    jsettings = jsession.build_render_settings(jconf, jdata)
    ref_dir, gt_dir = tmp_path / "jax", tmp_path / "gt"
    ref_dir.mkdir()
    gt_dir.mkdir()
    port_data = session.build_dataset(cfg, "test")
    np.testing.assert_allclose(port_data.images, jdata.images, rtol=1e-4, atol=1e-5)
    for i in range(2):
        img = jrend.render_image(
            jfield, jtree["coarse"], jtree["fine"], jdata.camera, jnp.asarray(jdata.poses[i]),
            jax.random.PRNGKey(i), jsettings, chunk_size=jconf.renderer.num_pixels,
        )
        jlog.save_png(ref_dir / f"{i:04d}.png", np.asarray(img))
        save_png(gt_dir / f"{i:04d}.png", port_data.images[i])
        port_png = load_png(run / "render" / f"{i:04d}.png").astype(int)
        jax_png = load_png(ref_dir / f"{i:04d}.png").astype(int)
        assert port_png.shape == (16, 16, 3)
        assert np.abs(port_png - jax_png).max() <= 1

    out = evaluate.main([str(run / "render"), str(gt_dir), "--device", "cpu"])
    ref = jmetrics.compare_directories(run / "render", gt_dir)
    assert out["psnr"] == pytest.approx(ref["psnr"], rel=1e-9)
    assert out["ssim"] == pytest.approx(ref["ssim"], rel=1e-9)


def test_build_field_selects_kernel_or_plain():
    cfg = config.resolve("default", ["network.feat_dim=64"])
    assert session.build_field(cfg).name == "nerf_fused"
    config.apply_overrides(cfg, ["parallel.use_pallas=false"])
    assert session.build_field(cfg).name == "nerf"
    cfg = config.resolve("default", ["device.compute_dtype=float32"])
    assert session.build_field(cfg).name == "nerf_fused"
    # the Blender and LLFF loaders read their scenes from data_root
    with pytest.raises(FileNotFoundError, match="transforms_test.json"):
        session.build_dataset(config.resolve("default", ["data.data_root=/nonexistent"]), "test")
    with pytest.raises(FileNotFoundError, match="poses_bounds.npy"):
        session.build_dataset(config.resolve("default", ["data.dataset_type=nerf_llff", "data.scene_name=fern",
                                                         "data.data_root=/nonexistent"]), "test")


def test_build_field_float32_config_takes_kernel_route(monkeypatch):
    """An f32 config with ``use_pallas`` unset still goes through the fused
    wrapper: its plain version on a CPU tensor, and on the card the kernel's
    f32 route, never the plain version silently."""
    cfg = config.resolve("default", ["network.feat_dim=64", "device.compute_dtype=float32"])
    field = session.build_field(cfg)
    calls = []
    real = fused_nerf.fused_nerf_apply

    def spy(params, pts, dirs, kcfg):
        calls.append(kcfg)
        return real(params, pts, dirs, kcfg)

    monkeypatch.setattr(fused_nerf, "fused_nerf_apply", spy)
    params = field.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-2, 2, (5, 7, 3)), dtype=torch.float32)
    dirs = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(5, 7, 3)), dtype=torch.float32), dim=-1)
    sigma, rgb = field.apply(field.prepare(params), pts, dirs)

    assert len(calls) == 1 and calls[0].compute_dtype == torch.float32
    ref_sigma, ref_rgb = fused_nerf.fused_nerf_apply_reference(params, pts.reshape(-1, 3), dirs.reshape(-1, 3), calls[0])
    torch.testing.assert_close(sigma, ref_sigma.reshape(5, 7), rtol=0, atol=0)
    torch.testing.assert_close(rgb, ref_rgb.reshape(5, 7, 3), rtol=0, atol=0)
    assert real.launches == 0
    # on the card the kernel takes f32 on its own route; it refuses CPU tensors
    assert fused_nerf.forward_route(calls[0]) == "f32_wgmma"
    laid_out = dataclasses.replace(fused_nerf.prepare(params, calls[0]), route="f32_wgmma")
    with pytest.raises(ValueError, match="CUDA"):
        fused_nerf._check_inputs(pts.reshape(-1, 3), dirs.reshape(-1, 3), laid_out, calls[0])


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points would use it")
    run, _ = _write_run(tmp_path, _jax_nets(6)[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_render.main(["--log-dir", str(run), "--render-test-views", "--num-views", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main([str(tmp_path), str(tmp_path)])
    assert fused_nerf.fused_nerf_apply.launches == 0


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, torch_nerf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'torch_nerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torch_nerf_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    pattern = re.compile(r"^\s*(import jax|from jax)|from torch_nerf_tpu |torch_nerf_tpu\.", re.M)
    sources = list((REPO / "torch_nerf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 15
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
