"""The port's CLIs with the two Instant-NGP presets on the CPU.

``run_train --device cpu`` with ``instant_nerf_tpu`` (bricked tables) and
``instant_nerf`` (per-corner hashing) at a tiny size (L = 2, log T = 10, 64
rays, 16 samples, 4 steps), then a resume for 4 more, ``run_render`` and
``evaluate``: the losses are finite, the resume continues from the
checkpoint's step with the table's Adam moments, the PNGs are finite and of
the expected shape, and no kernel launches. The session builds the NGP
field on either route. The hash kernels themselves need a Hopper card:
``test_hash_kernels_match_plain_version_on_the_card`` skips here.
"""

import numpy as np
import pytest
import torch

from torch_nerf_tpu import config as jcfg
from torch_nerf_tpu import session as jsession
from torch_nerf_tpu_torch import checkpoints, config, session
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.models.hash_math import level_resolutions
from torch_nerf_tpu_torch.ops import hash_grid
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

TINY_NGP = [
    "data.dataset_type=gaussian_blobs",
    "data.img_size=8",
    "data.num_views=4",
    "network.num_level=2",
    "network.log_max_entry_per_level=10",
    "network.max_res=32",
    "renderer.num_pixels=64",
    "renderer.num_samples_coarse=16",
    "train_params.optim.num_iter=8",
    "train_params.validation.validate_every=1",
    "train_params.validation.num_batch=1",
    "train_params.log.epoch_btw_ckpt=1",
    "train_params.log.epoch_btw_vis=1",
]
PRESETS = {"instant_nerf_tpu": (hash_grid.hash_brick_fwd, hash_grid.hash_brick_bwd),
           "instant_nerf": (hash_grid.hash_corner_fwd, hash_grid.hash_corner_bwd)}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_ngp_train_resume_render_evaluate_on_cpu(preset, tmp_path, capsys):
    for fn in PRESETS[preset]:
        fn.launches = 0
    log_dir = tmp_path / "run"
    base = ["--config", preset, "--log-dir", str(log_dir), "--device", "cpu"]
    first = run_train.main(base + ["--max-steps", "4"] + TINY_NGP)
    assert first["step"] == 4 and len(first["losses"]) == 4 and all(np.isfinite(first["losses"]))
    assert "validation @ step 4" in capsys.readouterr().out
    state = torch.load(log_dir / "ckpt" / "ckpt_000004.pt", weights_only=True)
    tables = state["params"]["coarse"]["tables"]
    cfg = config.load_config(log_dir / "config.yaml")
    assert cfg.network.table_layout == ("bricked" if preset == "instant_nerf_tpu" else "hash")
    assert tables.shape == ((2, 16, 128) if preset == "instant_nerf_tpu" else (2, 1024, 2))
    assert set(state["params"]["coarse"]) == {"tables", "density_mlp", "color_mlp"}
    # the table's Adam moments are in the checkpoint, in parameter_list order (tables last)
    moments = state["optimizer"]["state"]
    assert moments[max(moments)]["exp_avg"].shape == tables.shape

    resumed = run_train.main(base + ["--max-steps", "8"] + TINY_NGP)
    assert "Resumed from step 4." in capsys.readouterr().out
    assert resumed["step"] == 8 and len(resumed["losses"]) == 4 and all(np.isfinite(resumed["losses"]))

    out_dir, gt_dir = tmp_path / "render", tmp_path / "gt"
    run_render.main(["--log-dir", str(log_dir), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out_dir), "--device", "cpu"])
    data = session.build_dataset(cfg, "test")
    gt_dir.mkdir()
    for i in range(2):
        save_png(gt_dir / f"{i:04d}.png", data.images[i])
        png = load_png(out_dir / f"{i:04d}.png")
        assert png.shape == data.images[i].shape == (16, 16, 3) and np.isfinite(png).all()
    scores = evaluate.main([str(out_dir), str(gt_dir), "--device", "cpu"])
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert [fn.launches for fn in PRESETS[preset]] == [0, 0]


def test_session_builds_the_ngp_field_on_either_route():
    cfg = config.resolve("instant_nerf_tpu", ["network.num_level=2", "network.log_max_entry_per_level=10"])
    field = session.build_field(cfg)
    assert field.name == "instant_ngp" and field.fused_cfg is None
    params = field.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert params["tables"].shape == (2, 16, 128)
    config.apply_overrides(cfg, ["parallel.use_pallas=false"])
    plain = session.build_field(cfg)
    assert plain.name == "instant_ngp_plain"
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-1, 1, (3, 5, 3)), dtype=torch.float32)
    dirs = torch.as_tensor(rng.normal(size=(3, 5, 3)), dtype=torch.float32)
    for a, b in zip(field.apply(params, pts, dirs), plain.apply(params, pts, dirs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for preset in ("instant_nerf", "instant_nerf_tpu"):
        assert session.estimate_flops_per_step(config.resolve(preset)) == \
            jsession.estimate_flops_per_step(jcfg.resolve(preset))
        assert session.build_optim_config(config.resolve(preset, ["train_params.optim.table_weight_decay=0.1"])) \
            .table_weight_decay == 0.1
    # the packed layouts and their smoothness loss come with a later slice
    with pytest.raises(NotImplementedError, match="packed-layout slice"):
        session.build_field(config.resolve("instant_nerf", ["network.table_layout=packed"]))
    assert session.build_aux_loss(config.resolve("instant_nerf")) is None
    with pytest.raises(NotImplementedError, match="packed-layout slice"):
        session.build_aux_loss(config.resolve("instant_nerf", ["network.table_layout=packed_dual",
                                                               "objective.encode_smoothness_weight=0.1"]))
    with pytest.raises(ValueError, match="packed instant-NGP layouts"):
        session.build_aux_loss(config.resolve("instant_nerf", ["objective.encode_smoothness_weight=0.1"]))


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernels have no CPU mode")


def test_hash_kernels_match_plain_version_on_the_card():
    _require_hopper()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = torch.as_tensor(level_resolutions(16, 16, 512), device=dev)
    pts = torch.rand((4099, 3), generator=gen, device=dev) * 3 - 1.5
    pts[-1] = torch.tensor([0.25, -0.5, 1.0], device=dev)
    g = torch.randn((4099, 32), generator=gen, device=dev)
    cases = (
        (hash_grid.hash_brick_fwd, hash_grid.hash_brick_bwd, hash_grid.brick_encode_reference,
         hash_grid.brick_backward_reference, (16, 8192, 128)),
        (hash_grid.hash_corner_fwd, hash_grid.hash_corner_bwd, hash_grid.corner_encode_reference,
         hash_grid.corner_backward_reference, (16, 2**19, 2)),
    )
    for fwd, bwd, fwd_ref, bwd_ref, shape in cases:
        tables = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        before = (fwd.launches, bwd.launches)
        out = fwd(tables, pts, res)
        extra = (shape[1],) if len(shape) == 3 and shape[2] == 128 else (shape[1], shape[2])
        dtab = bwd(g, pts, res, *extra)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(out, fwd_ref(tables, pts, res), rtol=1e-5, atol=1e-5)
        ref = bwd_ref(g, pts, res, *extra)
        assert ((dtab - ref).norm() / ref.norm()).item() < 1e-5
        assert out[-1].abs().max().item() == 0.0
