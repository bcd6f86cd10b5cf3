"""The port's Blender loader, session builders and the train CLI on the CPU.

``load_blender`` is held against the JAX package's on a generated RGBA
scene (PIL writes the fixture here, in the test only; the port decodes it
with its own PNG reader), at full and half resolution and with test-frame
skipping. Then ``run_train --device cpu`` with ``test_cli.py``'s tiny
overrides, a resume, ``run_render`` and ``evaluate``: the artifacts exist,
the resume continues from the checkpoint's step, and no kernel launches.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu.datasets import blender as jblender
from torch_nerf_tpu_torch import config, session
from torch_nerf_tpu_torch.datasets import load_blender
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train, launch_count
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

TINY_OVERRIDES = [
    "data.dataset_type=gaussian_blobs",
    "network.feat_dim=32",
    "signal_encoder.coord_encode_level=4",
    "signal_encoder.dir_encode_level=2",
    "renderer.num_pixels=128",
    "renderer.num_samples_coarse=8",
    "renderer.num_samples_fine=8",
    "train_params.optim.num_iter=16",
    "train_params.validation.validate_every=2",
    "train_params.validation.num_batch=1",
    "train_params.log.epoch_btw_ckpt=2",
    "train_params.log.epoch_btw_vis=2",
]


@pytest.fixture
def blender_root(tmp_path):
    scene = tmp_path / "lego"
    rng = np.random.default_rng(0)
    for split, count in (("train", 3), ("test", 4)):
        (scene / split).mkdir(parents=True)
        frames = []
        for i in range(count):
            img = rng.integers(0, 255, size=(16, 20, 4), dtype=np.uint8)
            img[:4, :6, 3] = 0  # transparent corner: white after loading
            Image.fromarray(img, "RGBA").save(scene / split / f"r_{i}.png")
            pose = np.eye(4)
            pose[2, 3] = 4.0 + i
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        meta = {"camera_angle_x": 0.6911112070083618, "frames": frames}
        (scene / f"transforms_{split}.json").write_text(json.dumps(meta))
    return tmp_path


@pytest.mark.parametrize("split,half_res,skip", [("train", False, 1), ("train", True, 1), ("test", False, 2)])
def test_load_blender_matches_jax(blender_root, split, half_res, skip):
    got = load_blender(blender_root, "lego", split, half_res=half_res, test_idx_skip=skip)
    ref = jblender.load_blender(blender_root, "lego", split, half_res=half_res, test_idx_skip=skip)
    np.testing.assert_allclose(got.images, ref.images, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got.poses, ref.poses)
    np.testing.assert_allclose(got.render_poses, ref.render_poses, rtol=1e-6, atol=1e-6)
    assert tuple(got.camera) == pytest.approx(tuple(ref.camera), rel=1e-12)
    assert got.image_names == ref.image_names and got.num_views == ref.num_views
    assert got.flat_images().shape == ref.flat_images().shape
    np.testing.assert_array_equal(got.images[0, 0, 0], [1.0, 1.0, 1.0])


def test_session_builders_match_jax(blender_root):
    overrides = [f"data.data_root={blender_root}"]
    cfg, jconf = config.resolve("default", overrides), jcfg.resolve("default", overrides)
    train_set = session.build_dataset(cfg)  # half resolution
    test_set = session.build_dataset(cfg, "test")  # full resolution, every frame
    np.testing.assert_allclose(train_set.images, jsession.build_dataset(jconf).images, atol=1e-7)
    np.testing.assert_allclose(test_set.images, jsession.build_dataset(jconf, "test").images, atol=1e-7)
    assert train_set.images.shape == (3, 8, 10, 3) and test_set.images.shape == (4, 16, 20, 3)

    for extra in ([], ["network.type=instant_nerf"], ["renderer.num_samples_fine=0", "renderer.num_pixels=512"]):
        assert session.estimate_flops_per_step(config.resolve("default", extra)) == \
            jsession.estimate_flops_per_step(jcfg.resolve("default", extra))
    assert session.build_optim_config(cfg) == type(session.build_optim_config(cfg))(**vars(jsession.build_optim_config(jconf)))
    for bad in (["train_params.optim.optim_type=sgd"], ["objective.loss_type=l1"], ["scene.type=sphere"]):
        with pytest.raises(ValueError):
            session.build_optim_config(config.resolve("default", bad))
    # LLFF is ported: a scene that is not an LLFF one is refused, as in JAX
    with pytest.raises(ValueError, match="Unsupported scene"):
        session.build_dataset(config.resolve("default", ["data.dataset_type=nerf_llff"]))


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    launch_count.reset(fused_train.fused_train_pass)
    fused_nerf.reset_launches()
    log_dir = tmp_path_factory.mktemp("port_cli_run")
    result = run_train.main(["--config", "default", "--log-dir", str(log_dir), "--max-steps", "16",
                             "--device", "cpu"] + TINY_OVERRIDES)
    return log_dir, result


def test_train_cli_round_trip_on_cpu(trained_run, tmp_path, capsys):
    log_dir, result = trained_run
    assert result["step"] == 16 and len(result["losses"]) == 16
    assert all(np.isfinite(result["losses"]))
    assert (log_dir / "config.yaml").exists()
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("val/psnr" in r for r in records)
    assert [p.name for p in sorted((log_dir / "ckpt").iterdir())] == ["ckpt_000016.pt"]
    assert sorted(p.relative_to(log_dir).as_posix() for p in (log_dir / "vis").rglob("*.png")) == [
        "vis/epoch_2/pred_imgs/view_000.png"]
    state = torch.load(log_dir / "ckpt" / "ckpt_000016.pt", weights_only=True)
    assert set(state) == {"step", "params", "optimizer", "scheduler"}
    capsys.readouterr()

    # the same log dir resumes from the checkpoint
    resumed = run_train.main(["--config", "default", "--log-dir", str(log_dir), "--max-steps", "18",
                              "--device", "cpu"] + TINY_OVERRIDES)
    assert "Resumed from step 16" in capsys.readouterr().out
    # num_iter=16 caps the run at 2 epochs of 8 views, as in the JAX CLI
    assert resumed["step"] == 16 and resumed["losses"] == []

    out_dir, gt_dir = tmp_path / "render", tmp_path / "gt"
    run_render.main(["--log-dir", str(log_dir), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out_dir), "--device", "cpu"])
    assert [p.name for p in sorted(out_dir.iterdir())] == ["0000.png", "0001.png"]
    data = session.build_dataset(config.load_config(log_dir / "config.yaml"), "test")
    gt_dir.mkdir()
    for i in range(2):
        save_png(gt_dir / f"{i:04d}.png", data.images[i])
        assert load_png(out_dir / f"{i:04d}.png").shape == data.images[i].shape
    scores = evaluate.main([str(out_dir), str(gt_dir), "--device", "cpu"])
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert fused_train.fused_train_pass.launches == 0
    assert fused_nerf.fused_nerf_apply.launches == 0 and fused_nerf.fused_nerf_bwd.launches == 0


def test_train_cli_raises_for_later_slices_and_without_a_card(tmp_path):
    base = ["--log-dir", str(tmp_path / "r"), "--device", "cpu"] + TINY_OVERRIDES
    for extra, match in ((["--distributed"], "parallelism"), (["parallel.data_axis_size=4"], "parallelism")):
        with pytest.raises(NotImplementedError, match=match):
            run_train.main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_train.main(["--log-dir", str(tmp_path / "card")] + TINY_OVERRIDES)
