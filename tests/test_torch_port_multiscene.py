"""The port's multi-scene training against the JAX package.

At ``tests/test_multiscene.py``'s tiny shapes (feat 32, PE 2/1, 8 + 8
samples, 16x16 images, 2 views, 32 rays), the same stacked params and the
same per-scene draws (JAX's ``fold_in(key, s)`` split as its
``_scene_ray_batch`` splits it, handed over as ``ImageDraws``) go through
JAX's ``make_multiscene_image_train_step`` (vmap) and
``make_multiscene_shardmap_step`` (2-device virtual mesh) and the port's
``make_multiscene_train_step``: the scenes' losses within rtol 1e-4 and the
params after Adam within rtol 5e-3 / atol 1e-6 (``test_torch_port_train.py``'s
image-step tolerances), for the fused field (kernel 3's plain version on
the CPU) and the plain one. The bricked Instant-NGP field on 2 scenes is
held against the shard_map step at the NGP parity tolerances
(``test_torch_port_ngp.py``: loss rtol 1e-5, params within 1e-5 where JAX's
gradient is above rounding). Then the port alone: an S-scene step equals S
single-scene steps bit for bit, scene s's trajectory does not depend on how
many scenes train beside it, a checkpoint round trip continues the state
bit for bit; ``build_multiscene_dataset`` against JAX's; and the CLIs on
``--device cpu``: a 4-scene run with per-scene PSNR and a resume, and the
Blender train -> ``run_render --scene 1`` -> ``evaluate`` round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multiscene import _write_blender_scene
from torch_nerf_tpu import cameras as jcam
from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu import multiscene as jms
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu import train as jtrain
from torch_nerf_tpu.fields_ngp import make_instant_ngp_field as jmake_ngp_field
from torch_nerf_tpu.parallel import make_mesh
from torch_nerf_tpu.renderer import RenderSettings as JaxRenderSettings
from torch_nerf_tpu_torch import checkpoints, config, multiscene, session, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.logging_utils import save_png
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.renderer import RayUniforms, RenderSettings
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

FIELD_KW = dict(coord_encode_level=2, dir_encode_level=1, feat_dim=32)
JFIELD = jfields.make_nerf_field(**FIELD_KW)
PORT_FIELDS = {
    "fused": make_nerf_field(**FIELD_KW, compute_dtype=torch.float32),
    "plain": make_nerf_field(**FIELD_KW, compute_dtype=torch.float32, use_kernel=False),
}
SETTINGS = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
JSETTINGS = JaxRenderSettings(num_samples_coarse=8, num_samples_fine=8)
OPTIM = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
JOPTIM = jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
NUM_PIXELS = 32
NGP_SIZE = dict(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scene_data(num_scenes, img=16, views=2):
    """Stacked (S, V, H*W, 3) images and (S, V, 4, 4) poses of seeded blob
    scenes (numpy, fed to both packages), and the port's camera."""
    imgs, poses = [], []
    for s in range(num_scenes):
        i, p, camera, _ = synthetic.make_dataset(num_views=views, img_size=img,
                                                 scene=synthetic.GaussianBlobScene.random(100 + s))
        imgs.append(i)
        poses.append(p)
    return np.stack(imgs), np.stack(poses), camera


def _uniforms(rand, n, sc):
    """JAX's ``draw_train_randomness`` dict -> the port's RayUniforms."""
    empty = torch.zeros((n, 0))
    return RayUniforms(
        coarse=_t(rand["coarse_jitter"]),
        fine_coarse=_t(rand["fine_coarse_jitter"]) if "fine_u" in rand else torch.zeros((n, sc)),
        u=_t(rand["fine_u"]) if "fine_u" in rand else empty,
        fine=_t(rand["fine_jitter"]) if "fine_u" in rand else empty,
    )


def _jax_draws(key, num_scenes, num_views, num_pixels, jsettings):
    """Each scene's draws from ``fold_in(key, s)``, split as JAX's
    ``_scene_ray_batch`` splits it, as the port's ImageDraws."""
    draws = []
    for s in range(num_scenes):
        img_key, pix_key, render_key = jax.random.split(jax.random.fold_in(key, s), 3)
        draws.append(train.ImageDraws(
            image_index=int(jax.random.randint(img_key, (), 0, num_views)),
            pixel_u=_t(jax.random.uniform(pix_key, (16 * 16,))),
            rays=_uniforms(jtrain.draw_train_randomness(render_key, num_pixels, jsettings), num_pixels,
                           jsettings.num_samples_coarse),
        ))
    return draws


def _port_state(jparams, optim):
    params = params_from_jax(jparams)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


def _jax_state(key, jfield, jsettings, joptim, num_scenes):
    """JAX's stacked state, jitted (its eager vmap of the inits is slow)."""
    return jax.jit(lambda k: jms.create_multiscene_state(k, jfield, jsettings, joptim, num_scenes))(key)


def _shardmap_step(jfield, jsettings, joptim, jcamera, num_scenes, state, images, poses, key, num_pixels):
    mesh = make_mesh(("scene",), devices=jax.devices()[:2])
    build, place_state = jms.make_multiscene_shardmap_step(jfield, jsettings, joptim, jcamera, num_scenes, mesh,
                                                           num_pixels=num_pixels, donate=False)
    placed = place_state(state)
    return build(placed)(placed, jnp.asarray(images), jnp.asarray(poses), key)


@pytest.fixture(scope="module")
def classic_jax():
    """One 2-scene JAX step by each builder from one state and one key."""
    images, poses, camera = _scene_data(2)
    jcamera = jcam.CameraParams(*camera)
    state0 = _jax_state(jax.random.PRNGKey(0), JFIELD, JSETTINGS, JOPTIM, 2)
    key = jax.random.PRNGKey(7)
    vstep = jms.make_multiscene_image_train_step(JFIELD, JSETTINGS, JOPTIM, jcamera, 2, num_pixels=NUM_PIXELS,
                                                 donate=False)
    out = {"vmap": vstep(state0, jnp.asarray(images), jnp.asarray(poses), key),
           "shardmap": _shardmap_step(JFIELD, JSETTINGS, JOPTIM, jcamera, 2, state0, images, poses, key,
                                      NUM_PIXELS)}
    return dict(images=images, poses=poses, camera=camera, params0=_np(state0.params), key=key,
                results={b: (_np(s.params), _np(m)) for b, (s, m) in out.items()})


@pytest.mark.parametrize("path", ["fused", "plain"])
@pytest.mark.parametrize("builder", ["vmap", "shardmap"])
def test_multiscene_step_matches_jax(classic_jax, builder, path):
    jparams, jmetrics = classic_jax["results"][builder]
    state = _port_state(classic_jax["params0"], OPTIM)
    step = multiscene.make_multiscene_train_step(PORT_FIELDS[path], SETTINGS, OPTIM, classic_jax["camera"], 2,
                                                 num_pixels=NUM_PIXELS)
    draws = _jax_draws(classic_jax["key"], 2, 2, NUM_PIXELS, JSETTINGS)
    state, metrics = step(state, _t(classic_jax["images"]), _t(classic_jax["poses"]), draws=draws)
    assert state.step == 1 and metrics["coarse_loss"].shape == (2,)
    for name in ("coarse_loss", "fine_loss", "loss"):
        np.testing.assert_allclose(metrics[name].numpy(), np.asarray(jmetrics[name]), rtol=1e-4, err_msg=name)
    for got, ref in zip(train.parameter_list(state.params), train.parameter_list(jparams)):
        assert got.shape == ref.shape and got.shape[0] == 2
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=5e-3, atol=1e-6)


def test_bricked_ngp_multiscene_step_matches_jax_shardmap():
    jfield = jmake_ngp_field(**NGP_SIZE, table_layout="bricked")
    field = make_instant_ngp_field(**NGP_SIZE, table_layout="bricked")
    jsettings = JaxRenderSettings(num_samples_coarse=16, num_samples_fine=0)
    settings = RenderSettings(num_samples_coarse=16, num_samples_fine=0)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    optim = train.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    images, poses, camera = _scene_data(2)
    jcamera = jcam.CameraParams(*camera)
    state0 = _jax_state(jax.random.PRNGKey(2), jfield, jsettings, joptim, 2)
    # U(1e-4) tables carry no signal through the field: scale them, as the
    # NGP parity tests do (Adam's initial state does not depend on them)
    params0 = dict(_np(state0.params))
    params0["coarse"] = {**params0["coarse"], "tables": params0["coarse"]["tables"] * 1e4}
    state0 = jtrain.TrainState(step=state0.step, params=jax.tree_util.tree_map(jnp.asarray, params0),
                               opt_state=state0.opt_state)
    key = jax.random.PRNGKey(5)
    jstate, jmetrics = _shardmap_step(jfield, jsettings, joptim, jcamera, 2, state0, images, poses, key, 64)

    state = _port_state(params0, optim)
    step = multiscene.make_multiscene_train_step(field, settings, optim, camera, 2, num_pixels=64)
    state, metrics = step(state, _t(images), _t(poses), draws=_jax_draws(key, 2, 2, 64, jsettings))
    np.testing.assert_allclose(metrics["coarse_loss"].numpy(), np.asarray(jmetrics["coarse_loss"]), rtol=1e-5)
    # JAX's gradient of each scene, to leave out the leaves that Adam's first
    # step at eps 1e-15 moves by +-lr on a gradient of rounding size
    @jax.jit
    def scene_grads(params, images, poses, skey):
        o, d, gt, render_key = jms._scene_ray_batch(images, poses, skey, jcamera, jsettings, None, 64, 16 * 16)
        return jax.grad(lambda p: jtrain.ray_loss_fn(jfield, p, o, d, gt, render_key, jsettings)[0])(params)

    for s in range(2):
        jgrads = scene_grads(jms.scene_params(state0, s), jnp.asarray(images[s]), jnp.asarray(poses[s]),
                             jax.random.fold_in(key, s))
        jflat = [np.asarray(g) for g in train.parameter_list(_np(jgrads))]
        scale = max(np.abs(g).max() for g in jflat)
        assert np.abs(jflat[-1]).max() > 0.0  # the tables get a gradient
        for leaf, ref, g in zip(train.parameter_list(state.params), train.parameter_list(_np(jstate.params)), jflat):
            keep = np.abs(g) > 1e-6 * scale
            np.testing.assert_allclose(leaf[s].detach().numpy()[keep], ref[s][keep], rtol=1e-5, atol=1e-5)


def _single_state(params, optim):
    params = {k: {n: {leaf: v.detach().clone().requires_grad_(True) for leaf, v in layer.items()}
                  for n, layer in tree.items()} for k, tree in params.items()}
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


@pytest.mark.parametrize("path", ["fused", "plain"])
def test_multiscene_step_equals_single_scene_steps_bit_for_bit(path):
    field, num_scenes = PORT_FIELDS[path], 3
    images, poses, camera = _scene_data(num_scenes)
    images, poses = _t(images), _t(poses)
    state = multiscene.create_multiscene_state(multiscene.scene_generators(0, num_scenes), field, SETTINGS, OPTIM,
                                               num_scenes)
    singles = [_single_state(multiscene.scene_params(state, s), OPTIM) for s in range(num_scenes)]
    step = multiscene.make_multiscene_train_step(field, SETTINGS, OPTIM, camera, num_scenes, NUM_PIXELS,
                                                 precrop=True)
    single_step = train.make_image_train_step(field, SETTINGS, OPTIM, camera, NUM_PIXELS, precrop=True)
    gens = multiscene.scene_generators(1, num_scenes)
    for _ in range(2):
        draws = step.draw(gens, 2)
        state, metrics = step(state, images, poses, draws=draws)
        for s in range(num_scenes):
            singles[s], m = single_step(singles[s], images[s], poses[s], draws=draws[s])
            assert metrics["coarse_loss"][s].item() == m["coarse_loss"].item()
            assert metrics["fine_loss"][s].item() == m["fine_loss"].item()
    assert metrics["loss"].item() == torch.mean(metrics["coarse_loss"] + metrics["fine_loss"]).item()
    stacked = [state.optimizer.state[p] for p in train.parameter_list(state.params)]
    for s, single in enumerate(singles):
        for got, ref, st in zip(train.parameter_list(state.params), train.parameter_list(single.params), stacked):
            assert torch.equal(got[s], ref)
            ref_state = single.optimizer.state[ref]
            assert torch.equal(st["exp_avg"][s], ref_state["exp_avg"])
            assert torch.equal(st["exp_avg_sq"][s], ref_state["exp_avg_sq"])
        assert single.scheduler.get_last_lr() == state.scheduler.get_last_lr()


def test_scene_trajectory_does_not_depend_on_the_scene_count():
    field = PORT_FIELDS["fused"]
    images, poses, camera = _scene_data(3)
    params = {}
    for num_scenes in (2, 3):
        state = multiscene.create_multiscene_state(multiscene.scene_generators(4, num_scenes), field, SETTINGS,
                                                   OPTIM, num_scenes)
        step = multiscene.make_multiscene_train_step(field, SETTINGS, OPTIM, camera, num_scenes, NUM_PIXELS)
        gens = multiscene.scene_generators(5, num_scenes)
        for _ in range(2):
            state, _ = step(state, _t(images[:num_scenes]), _t(poses[:num_scenes]), gens)
        params[num_scenes] = train.parameter_list(state.params)
    for a, b in zip(params[2], params[3]):
        assert torch.equal(a, b[:2])
    assert multiscene.scene_seed(4, 0) != multiscene.scene_seed(4, 1) != multiscene.scene_seed(5, 1)


def test_checkpoint_round_trip_continues_the_stacked_state(tmp_path):
    field = PORT_FIELDS["fused"]
    images, poses, camera = _scene_data(2)
    images, poses = _t(images), _t(poses)
    step = multiscene.make_multiscene_train_step(field, SETTINGS, OPTIM, camera, 2, NUM_PIXELS)
    state = multiscene.create_multiscene_state(multiscene.scene_generators(0, 2), field, SETTINGS, OPTIM, 2)
    gens = multiscene.scene_generators(1, 2)
    batches = [step.draw(gens, 2) for _ in range(4)]
    for draws in batches[:2]:
        state, _ = step(state, images, poses, draws=draws)
    checkpoints.save_checkpoint(tmp_path, state.step, state.params, state.optimizer, state.scheduler, num_scenes=2)
    restored = checkpoints.restore_latest(tmp_path)
    assert restored["num_scenes"] == 2 and restored["step"] == 2
    fresh = multiscene.create_multiscene_state(multiscene.scene_generators(9, 2), field, SETTINGS, OPTIM, 2)
    run_train._restore(fresh, restored)
    for draws in batches[2:]:
        state, _ = step(state, images, poses, draws=draws)
        fresh, _ = step(fresh, images, poses, draws=draws)
    assert fresh.step == state.step == 4
    for a, b in zip(train.parameter_list(state.params), train.parameter_list(fresh.params)):
        assert torch.equal(a, b)
    # a single-scene checkpoint carries no scene count
    checkpoints.save_checkpoint(tmp_path / "single", 1, multiscene.scene_params(state, 0))
    assert "num_scenes" not in checkpoints.restore_latest(tmp_path / "single")


# ---------------------------------------------------------------------------
# datasets


def _blob_cfg(pkg, **extra):
    overrides = ["data.dataset_type=gaussian_blobs", "data.num_scenes=2", "data.img_size=12", "data.num_views=2",
                 "seed=3"] + [f"{k}={v}" for k, v in extra.items()]
    return pkg.resolve("default", overrides)


@pytest.mark.parametrize("split", ["train", "test"])
def test_blob_scenes_match_jax(split):
    cfg, jconf = _blob_cfg(config), _blob_cfg(jcfg)
    for s in range(2):
        got = session.build_multiscene_dataset(cfg, s, split)
        ref = jsession.build_multiscene_dataset(jconf, s, split)
        assert tuple(got.camera) == tuple(ref.camera) and got.image_names == ref.image_names
        np.testing.assert_array_equal(got.poses, ref.poses)
        np.testing.assert_array_equal(got.render_poses, ref.render_poses)
        # the ground truth is rendered by each package's own backend: the
        # synthetic dataset's tolerance (test_torch_port_ops.py)
        np.testing.assert_allclose(got.images, ref.images, rtol=1e-4, atol=1e-5)
    # half_res serves val and test at twice the training size
    assert session.build_multiscene_dataset(_blob_cfg(config, **{"data.half_res": "true"}), 1, split).images.shape[1] \
        == (24 if split == "test" else 12)


def _blender_cfg(pkg, root, names="alpha,beta", num_scenes=2):
    return pkg.resolve("default", ["data.dataset_type=nerf_synthetic", f"data.data_root={root}",
                                   f"data.scene_name={names}", f"data.num_scenes={num_scenes}",
                                   "data.half_res=false"])


def test_blender_scenes_match_jax_and_bad_configs_raise(tmp_path):
    _write_blender_scene(tmp_path, "alpha", seed=1)
    _write_blender_scene(tmp_path, "beta", seed=2)
    cfg, jconf = _blender_cfg(config, tmp_path), _blender_cfg(jcfg, tmp_path)
    assert session.multiscene_scene_names(cfg) == jsession.multiscene_scene_names(jconf) == ["alpha", "beta"]
    for s in range(2):
        for split in ("train", "val", "test"):
            got = session.build_multiscene_dataset(cfg, s, split)
            ref = jsession.build_multiscene_dataset(jconf, s, split)
            np.testing.assert_array_equal(got.images, ref.images)
            np.testing.assert_array_equal(got.poses, ref.poses)
            assert tuple(got.camera) == tuple(ref.camera)
    for pkg_cfg, pkg_session in ((config, session), (jcfg, jsession)):
        with pytest.raises(ValueError, match="comma-separated"):
            pkg_session.build_multiscene_dataset(_blender_cfg(pkg_cfg, tmp_path, "alpha", 2), 0)
        with pytest.raises(ValueError, match="supports dataset_type"):
            pkg_session.build_multiscene_dataset(
                pkg_cfg.resolve("default", ["data.dataset_type=nerf_llff", "data.num_scenes=2"]), 0)


@pytest.mark.parametrize("other, match", [(dict(size=20), "camera"), (dict(n_views=3), "view counts")])
def test_unequal_scenes_raise_before_training(tmp_path, other, match):
    _write_blender_scene(tmp_path, "alpha", seed=1)
    _write_blender_scene(tmp_path, "beta", seed=2, **other)
    with pytest.raises(ValueError, match=match):
        run_train.main(["--log-dir", str(tmp_path / "run"), "--device", "cpu"]
                       + [f"data.{k}" for k in ("dataset_type=nerf_synthetic", f"data_root={tmp_path}",
                                                "scene_name=alpha,beta", "num_scenes=2", "half_res=false")])


# ---------------------------------------------------------------------------
# the CLIs on the CPU

TINY = ["network.feat_dim=32", "signal_encoder.coord_encode_level=4", "signal_encoder.dir_encode_level=2",
        "renderer.num_pixels=64", "renderer.num_samples_coarse=8", "renderer.num_samples_fine=8"]


def test_four_scene_cli_reports_per_scene_psnr_and_resumes(tmp_path, capsys):
    overrides = ["data.dataset_type=gaussian_blobs", "data.num_scenes=4", "data.img_size=16", "data.num_views=2",
                 "data.half_res=false", "train_params.optim.num_iter=8", "train_params.validation.validate_every=4",
                 "train_params.log.epoch_btw_ckpt=4", "occupancy.enabled=true"] + TINY
    log_dir = tmp_path / "ms_run"
    argv = ["--config", "default", "--log-dir", str(log_dir), "--max-steps", "8", "--device", "cpu"] + overrides
    first = run_train.main(argv)
    out = capsys.readouterr().out
    assert "occupancy.enabled: not used by a multi-scene run" in out
    val = [ln for ln in out.splitlines() if ln.startswith("validation @ step 8")]
    assert len(val) == 1 and all(f"psnr_scene{s}=" in val[0] for s in range(4))
    assert first["step"] == 8 and len(first["losses"]) == 8
    assert len(first["scene_losses"]) == 4 and all(len(v) == 8 for v in first["scene_losses"])
    assert len(first["metrics"]["coarse_loss"]) == 4
    np.testing.assert_allclose(first["losses"], np.mean(first["scene_losses"], axis=0), rtol=1e-6)
    assert sorted(p.name for p in (log_dir / "ckpt").iterdir()) == ["ckpt_000008.pt"]
    assert checkpoints.restore_latest(log_dir)["num_scenes"] == 4

    resumed = run_train.main(argv)
    assert "Resumed from step 8" in capsys.readouterr().out
    assert resumed["step"] == 8 and resumed["losses"] == []


def test_blender_train_render_evaluate_round_trip(tmp_path, capsys):
    data_root = tmp_path / "blender"
    data_root.mkdir()
    _write_blender_scene(data_root, "alpha", seed=1)
    _write_blender_scene(data_root, "beta", seed=2)
    overrides = ["data.dataset_type=nerf_synthetic", f"data.data_root={data_root}", "data.scene_name=alpha,beta",
                 "data.num_scenes=2", "data.half_res=false", "train_params.optim.num_iter=4",
                 "train_params.validation.validate_every=2", "train_params.log.epoch_btw_ckpt=2"] + TINY
    log_dir = tmp_path / "ms_blender"
    run_train.main(["--config", "default", "--log-dir", str(log_dir), "--max-steps", "4", "--device", "cpu"]
                   + overrides)
    out = capsys.readouterr().out
    assert "psnr_scene0" in out and "psnr_scene1" in out

    render_dir = tmp_path / "render_scene1"
    run_render.main(["--log-dir", str(log_dir), "--scene", "1", "--render-test-views", "--num-views", "1",
                     "--out-dir", str(render_dir), "--device", "cpu"])
    assert "Loaded scene 1 of a 2-scene checkpoint at step 4." in capsys.readouterr().out
    assert (render_dir / "0000.png").exists()

    # scene 1's render against scene 1's own test ground truth
    ds = session.build_multiscene_dataset(config.load_config(log_dir / "config.yaml"), 1, split="test")
    gt_dir = tmp_path / "gt_scene1"
    gt_dir.mkdir()
    save_png(gt_dir / "0000.png", ds.images[0])
    scores = evaluate.main([str(render_dir), str(gt_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "PSNR:" in out and "SSIM:" in out and np.isfinite(scores["psnr"])

    for bad in ("5", "-1"):
        with pytest.raises(ValueError, match="out of range"):
            run_render.main(["--log-dir", str(log_dir), "--scene", bad, "--device", "cpu"])
