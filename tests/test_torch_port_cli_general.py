"""Path A of the general route through the port's CLIs on the CPU: the
default preset in f32, at a tiny size with a width that the card pads
(``network.feat_dim=48``) and an encoding past the ``wgmma`` templates
(``signal_encoder.coord_encode_level=11``, 69 columns).

``run_train`` -> a resume -> ``run_render`` -> ``evaluate``, as
``tests/test_torch_port_cli_train.py::test_train_cli_round_trip_on_cpu``
runs the default: the artifacts exist, the resume continues, the losses
are finite, and no kernel launches (on the CPU the wrappers run their plain
versions). The card runs the same sequence at full width in
``chip_smoke.py``'s train_f32 and train_wide phases.
"""

import json

import numpy as np
import torch

from torch_nerf_tpu_torch import config, session
from torch_nerf_tpu_torch.logging_utils import load_png, save_png
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

PATH_A = [
    "device.compute_dtype=float32",
    "network.feat_dim=48",
    "signal_encoder.coord_encode_level=11",
    "data.dataset_type=gaussian_blobs",
    "data.img_size=16",
    "data.num_views=4",
    "renderer.num_pixels=128",
    "renderer.num_samples_coarse=8",
    "renderer.num_samples_fine=8",
    "train_params.optim.num_iter=8",
    "train_params.validation.validate_every=1",
    "train_params.validation.num_batch=1",
    "train_params.log.epoch_btw_ckpt=1",
    "train_params.log.epoch_btw_vis=2",
]


def test_path_a_round_trip_on_cpu(tmp_path, capsys):
    fused_nerf.reset_launches()
    fused_train.reset_launches()
    cfg = config.resolve("default", PATH_A)
    fcfg = session.build_field(cfg).fused_cfg
    assert fused_nerf.train_route(fcfg) == "f32_wgmma" and fused_nerf.padded_config(fcfg).feat_dim == 64
    session.check_trainable(cfg, torch.device("cuda"))

    log_dir = tmp_path / "run"
    result = run_train.main(["--config", "default", "--log-dir", str(log_dir), "--max-steps", "4",
                             "--device", "cpu"] + PATH_A)
    assert result["step"] == 4 and len(result["losses"]) == 4 and all(np.isfinite(result["losses"]))
    saved = config.load_config(log_dir / "config.yaml")
    assert saved.device.compute_dtype == "float32" and saved.network.feat_dim == 48
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("val/psnr" in r for r in records)
    assert [p.name for p in sorted((log_dir / "ckpt").glob("*.pt"))] == ["ckpt_000004.pt"]
    state = torch.load(log_dir / "ckpt" / "ckpt_000004.pt", weights_only=True)
    assert state["params"]["coarse"]["fc_in"]["w"].shape == (69, 48)
    capsys.readouterr()

    resumed = run_train.main(["--config", "default", "--log-dir", str(log_dir), "--max-steps", "8",
                              "--device", "cpu"] + PATH_A)
    assert "Resumed from step 4" in capsys.readouterr().out
    assert resumed["step"] == 8 and len(resumed["losses"]) == 4 and all(np.isfinite(resumed["losses"]))

    out_dir, gt_dir = tmp_path / "render", tmp_path / "gt"
    run_render.main(["--log-dir", str(log_dir), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(out_dir), "--device", "cpu"])
    assert [p.name for p in sorted(out_dir.iterdir())] == ["0000.png", "0001.png"]
    data = session.build_dataset(saved, "test")
    gt_dir.mkdir()
    for i in range(2):
        save_png(gt_dir / f"{i:04d}.png", data.images[i])
        assert load_png(out_dir / f"{i:04d}.png").shape == data.images[i].shape
    scores = evaluate.main([str(out_dir), str(gt_dir), "--device", "cpu"])
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    for fn_ in (fused_train.fused_train_pass, fused_nerf.fused_nerf_apply, fused_nerf.fused_nerf_bwd):
        assert fn_.launches == 0 and not any(fn_.route_launches.values())
