"""The port's LPIPS against the JAX package's, and ``run_train --profile-steps``.

The same random AlexNet and lin weights (drawn as ``tests/test_lpips.py``
draws them) and the same images go through ``torch_nerf_tpu.lpips.lpips_alex``
and the port's: within 1e-5 (``test_lpips.py``'s oracle tolerance is rtol
1e-4). Then the weight search (``$LPIPS_WEIGHTS`` ``.npz``, the torch-hub
cache's ``.pth`` files, nothing found), ``evaluate`` and ``run_train``'s
validation with and without weights, and the profiler window of
``run_train --device cpu --profile-steps 2``, single- and multi-scene.
"""

import json

import numpy as np
import pytest
import torch

from torch_nerf_tpu import lpips as jlpips
from torch_nerf_tpu_torch import lpips, metrics
from torch_nerf_tpu_torch.logging_utils import save_png
from torch_nerf_tpu_torch.runners import evaluate, run_train


def _random_arrays(seed=0):
    rng = np.random.default_rng(seed)
    convs, in_ch = [], 3
    for out_ch, k, _, _ in lpips.CONVS:
        convs.append((rng.normal(0, 0.1, (out_ch, in_ch, k, k)).astype(np.float32),
                      rng.normal(0, 0.05, (out_ch,)).astype(np.float32)))
        in_ch = out_ch
    lins = [np.abs(rng.normal(0, 0.2, (c,)).astype(np.float32)) for c in (64, 192, 384, 256, 256)]
    return convs, lins


def _images(seed=1, shape=(64, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(64, 64, 3), (67, 90, 3)])
def test_lpips_matches_jax(shape):
    convs, lins = _random_arrays()
    a, b = _images(shape=shape)
    ours = lpips.lpips_alex(a, b, lpips.LPIPSWeights(convs, lins))
    ref = jlpips.lpips_alex(a, b, jlpips.LPIPSWeights(convs, lins))
    assert ours > 0.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # tensors in, as the train CLI's validation hands them
    assert lpips.lpips_alex(torch.from_numpy(a), torch.from_numpy(b), lpips.LPIPSWeights(convs, lins)) == ours


def test_identical_images_score_zero():
    a, _ = _images()
    assert lpips.lpips_alex(a, a, lpips.LPIPSWeights(*_random_arrays())) == pytest.approx(0.0, abs=1e-6)


def test_npz_round_trip_through_the_environment(tmp_path, monkeypatch):
    weights = lpips.LPIPSWeights(*_random_arrays(seed=2))
    path = tmp_path / "lpips_alex.npz"
    lpips.export_weights_npz(weights, path)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(path))
    loaded, jloaded = lpips.load_weights(), jlpips.load_weights()
    assert loaded is not None and metrics.lpips_available()
    for (w, b), (jw, jb), (w0, b0) in zip(loaded.convs, jloaded.convs, weights.convs):
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(jw, w0)
        np.testing.assert_array_equal(b, b0)
    a, b = _images(seed=3)
    assert metrics.lpips(a, b) == lpips.lpips_alex(a, b, weights)
    np.testing.assert_allclose(metrics.lpips(a, b), jlpips.lpips_alex(a, b, jloaded), rtol=0, atol=1e-5)
    # a directory named by the variable is searched for an .npz too
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path))
    assert lpips.load_weights().lins[4].tolist() == weights.lins[4].tolist()


def test_torch_hub_cache_checkpoints_load(tmp_path, monkeypatch):
    """torchvision's AlexNet state dict and a torchmetrics-style lin state
    dict in ``~/.cache/torch/hub/checkpoints/``, read as JAX reads them."""
    convs, lins = _random_arrays(seed=4)
    cache = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    backbone = {}
    for layer, (w, b) in zip((0, 3, 6, 8, 10), convs):
        backbone[f"features.{layer}.weight"] = torch.from_numpy(w)
        backbone[f"features.{layer}.bias"] = torch.from_numpy(b)
    backbone["classifier.1.weight"] = torch.zeros((4, 9216))
    torch.save(backbone, cache / "alexnet-owt-7be5be79.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(v).view(1, -1, 1, 1) for i, v in enumerate(lins)},
               cache / "lpips_lin_alex.pth")
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    loaded, jloaded = lpips.load_weights(), jlpips.load_weights()
    assert loaded is not None and jloaded is not None
    for got, ref in zip(loaded.lins, lins):
        np.testing.assert_array_equal(got, ref)
    a, b = _images(seed=5)
    np.testing.assert_allclose(lpips.lpips_alex(a, b, loaded), jlpips.lpips_alex(a, b, jloaded), rtol=0, atol=1e-5)


def _pair_dirs(tmp_path):
    a, b = _images(seed=6)
    for name, img in (("pred", a), ("gt", b)):
        (tmp_path / name).mkdir()
        save_png(tmp_path / name / "0000.png", img)
    return tmp_path / "pred", tmp_path / "gt"


def test_evaluate_reports_lpips_only_with_weights(tmp_path, monkeypatch, capsys):
    pred, gt = _pair_dirs(tmp_path)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "missing"))
    monkeypatch.setenv("HOME", str(tmp_path))  # no torch-hub cache either
    assert lpips.load_weights() is None and not metrics.lpips_available()
    assert metrics.lpips(*_images()) is None
    out = evaluate.main([str(pred), str(gt), "--device", "cpu"])
    assert "lpips" not in out
    assert "LPIPS: unavailable" in capsys.readouterr().out

    weights = lpips.LPIPSWeights(*_random_arrays(seed=7))
    lpips.export_weights_npz(weights, tmp_path / "w.npz")
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    out = evaluate.main([str(pred), str(gt), "--device", "cpu"])
    printed = capsys.readouterr().out
    a, b = metrics._load_image_pair(pred / "0000.png", gt / "0000.png")
    assert out["lpips"] == lpips.lpips_alex(a, b, weights) > 0.0
    assert f"LPIPS: {out['lpips']:.4f}" in printed


TINY = ["data.dataset_type=gaussian_blobs", "data.img_size=32", "data.num_views=4", "data.half_res=false",
        "network.feat_dim=32", "signal_encoder.coord_encode_level=4", "signal_encoder.dir_encode_level=2",
        "renderer.num_pixels=64", "renderer.num_samples_coarse=8", "renderer.num_samples_fine=8",
        "train_params.optim.num_iter=16", "train_params.validation.validate_every=3",
        "train_params.validation.num_batch=1", "train_params.log.epoch_btw_ckpt=4",
        "train_params.log.epoch_btw_vis=4"]


@pytest.mark.parametrize("num_scenes", [1, 2])
def test_profile_steps_write_a_trace(tmp_path, monkeypatch, capsys, num_scenes):
    """Steps 10 and 11 traced (the window after 10 steps), the trace written
    when the window ends; a single-scene validation logs ``val/lpips`` with
    weights found."""
    lpips.export_weights_npz(lpips.LPIPSWeights(*_random_arrays(seed=8)), tmp_path / "w.npz")
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    log_dir = tmp_path / "run"
    result = run_train.main(["--log-dir", str(log_dir), "--max-steps", "13", "--profile-steps", "2", "--device",
                             "cpu", f"data.num_scenes={num_scenes}"] + TINY)
    out = capsys.readouterr().out
    assert result["step"] == 13
    assert out.count("profiler trace written to") == 1 and str(log_dir / "profile") in out
    trace = json.loads((log_dir / "profile" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    val = [ln for ln in out.splitlines() if ln.startswith("validation @ step 12")]
    assert len(val) == 1
    if num_scenes == 1:
        assert "lpips=" in val[0]
        logged = [json.loads(ln) for ln in (log_dir / "metrics.jsonl").read_text().splitlines()]
        assert any("val/lpips" in rec.get("scalars", rec) for rec in logged)
    else:
        assert "psnr_scene1=" in val[0]
