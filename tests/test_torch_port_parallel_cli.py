"""The port's sharded checkpoints and its CLIs under torchrun, on the CPU.

* The reshard round trip of ``tests/test_checkpoint_reshard.py``: one DP
  step on 2 gloo ranks, the state gathered and saved by rank 0 (the file a
  single-process run writes), restored on one process with exact params
  and moments, and onto a 2 x 2 DP x TP mesh of 4 ranks, where the next
  step's loss equals the single process's (rtol 1e-5).
* ``torchrun --nproc_per_node=2 -m ...run_train --distributed --dist-backend
  gloo --device cpu``: a classic run of 4 steps resumed for 2 more, its
  params those of the single-process run of the same config (rtol 1e-4 /
  atol 1e-6);
  its checkpoint resumed by a single-process ``run_train`` (the reshard
  onto one process); ``run_render --distributed`` giving the PNGs of the
  single-process ``run_render``, scored by ``evaluate``; a 2-scene run
  over the 2 ranks, checkpointed twice and resumed, against the
  single-process 2-scene runs (params and Adam's moments bit for bit;
  a scene count that does not divide is refused in
  ``test_torch_port_parallel_image.py``).
* ``runners/dryrun_multichip.py`` on 4 ranks: every check's loss printed.
* ``--distributed`` without a card and without ``--device cpu`` raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import checkpoints, train
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.logging_utils import load_png
from torch_nerf_tpu_torch.parallel import launch, mesh as pmesh, steps
from torch_nerf_tpu_torch.renderer import RenderSettings, draw_uniforms
from torch_nerf_tpu_torch.runners import evaluate, run_render, run_train

REPO = Path(__file__).resolve().parents[1]
FIELD = make_nerf_field(coord_encode_level=2, dir_encode_level=1, feat_dim=32, compute_dtype=torch.float32)
SETTINGS = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
OPTIM = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
TIMEOUT = 60.0
TINY = ["data.dataset_type=gaussian_blobs", "data.img_size=16", "data.num_views=2", "data.half_res=false",
        "network.feat_dim=32", "signal_encoder.coord_encode_level=4", "signal_encoder.dir_encode_level=2",
        "renderer.num_pixels=64", "renderer.num_samples_coarse=8", "renderer.num_samples_fine=8",
        "train_params.optim.num_iter=8", "train_params.validation.validate_every=2",
        "train_params.log.epoch_btw_ckpt=2", "train_params.log.epoch_btw_vis=2"]


def batch(seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((64, 3), generator=gen), torch.randn((64, 3), generator=gen),
            torch.rand((64, 3), generator=gen), draw_uniforms(gen, 64, SETTINGS))


def fresh_state(seed=0):
    return train.create_train_state(torch.Generator().manual_seed(seed), FIELD, SETTINGS, OPTIM)


def _save_rank(rank, world, init_method, log_dir):
    """One DP step on 2 ranks, then the checkpoint: the ranks' params."""
    mesh = pmesh.init_mesh(rank, world, init_method, device="cpu", timeout=TIMEOUT)
    state = pmesh.place_state(mesh, fresh_state(), OPTIM)
    state, _ = steps.make_sharded_train_step(FIELD, SETTINGS, OPTIM, mesh)(state, *batch(1))
    run_train._save(log_dir, state, None, mesh=mesh)
    return [p.detach().clone() for p in train.parameter_list(state.params)]


def _restore_rank(rank, world, init_method, log_dir):
    """The checkpoint restored onto a 2 x 2 DP x TP mesh, one step on."""
    mesh = pmesh.init_mesh(rank, world, init_method, data_size=2, model_size=2, device="cpu", timeout=TIMEOUT)
    state = fresh_state(seed=9)
    run_train._restore(state, checkpoints.restore_latest(log_dir))
    state = pmesh.place_state(mesh, state, OPTIM)
    state, metrics = steps.make_sharded_train_step(FIELD, SETTINGS, OPTIM, mesh)(state, *batch(2))
    return state.step, metrics["loss"].item(), [tuple(p.shape) for p in train.parameter_list(state.params)]


def test_dp_checkpoint_restores_on_one_process_and_on_a_dp_x_tp_mesh(tmp_path):
    saved = launch.spawn(_save_rank, 2, tmp_path / "spawn", (tmp_path / "run",), timeout=180, threads=1)
    for a, b in zip(saved[0], saved[1]):
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "run" / "ckpt").iterdir()) == ["ckpt_000001.pt"]

    # one process: exact params and Adam state, then the next step
    restored = checkpoints.restore_latest(tmp_path / "run")
    state = fresh_state(seed=9)
    run_train._restore(state, restored)
    assert state.step == 1
    for a, b in zip(train.parameter_list(state.params), saved[0]):
        assert torch.equal(a.detach(), b)
    single = fresh_state()
    train.make_ray_train_step(FIELD, SETTINGS, OPTIM)(single, *batch(1))
    for p, q in zip(train.parameter_list(state.params), train.parameter_list(single.params)):
        np.testing.assert_allclose(state.optimizer.state[p]["exp_avg"].numpy(),
                                   single.optimizer.state[q]["exp_avg"].numpy(), rtol=1e-5, atol=1e-9)
    state, metrics = train.make_ray_train_step(FIELD, SETTINGS, OPTIM, force_generic=True)(state, *batch(2))
    assert state.step == 2

    # a 2 x 2 DP x TP mesh: the same loss
    ranks = launch.spawn(_restore_rank, 4, tmp_path / "spawn", (tmp_path / "run",), timeout=180, threads=1)
    for step, loss, shapes in ranks:
        assert step == 2
        np.testing.assert_allclose(loss, metrics["loss"].item(), rtol=1e-5)
    assert (32, 16) in ranks[0][2]  # fc_1's rows over the model axis of 2 (in 32, out 32)


def torchrun(module, args, nproc=2, timeout=240):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}", "-m",
           f"torch_nerf_tpu_torch.runners.{module}"] + args
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc.stdout


def _final_params(log_dir):
    """The params of a run's latest checkpoint, in parameter_list order."""
    return train.parameter_list(checkpoints.restore_latest(log_dir)["params"])


def test_torchrun_train_resume_reshard_render_evaluate(tmp_path, capsys):
    dp, one = tmp_path / "dp", tmp_path / "one"
    out = torchrun("run_train", ["--distributed", "--dist-backend", "gloo", "--device", "cpu", "--log-dir", str(dp),
                                 "--max-steps", "4"] + TINY)
    assert "Data-parallel training over 2 ranks (gloo)." in out
    assert out.count("validation @ step 4") == 1  # rank 0 prints alone
    out = torchrun("run_train", ["--distributed", "--device", "cpu", "--log-dir", str(dp), "--max-steps", "6"])
    assert "Resumed from step 4." in out and "Training complete at step 6." in out
    assert sorted(p.name for p in (dp / "ckpt").iterdir()) == ["ckpt_000004.pt", "ckpt_000006.pt"]
    # rank 0 alone logs: one validation (at epoch 2, step 4) in the run's metrics
    assert [json.loads(ln)["step"] for ln in (dp / "metrics.jsonl").read_text().splitlines()
            if "val/psnr" in ln] == [4]

    # the same runs on one process: the same state at step 6
    for max_steps in ("4", "6"):
        run_train.main(["--device", "cpu", "--log-dir", str(one), "--max-steps", max_steps] + TINY)
    for a, b in zip(_final_params(dp), _final_params(one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)

    # the DP checkpoint resumed by one process
    resumed = run_train.main(["--device", "cpu", "--log-dir", str(dp), "--max-steps", "8"])
    assert resumed["step"] == 8 and len(resumed["losses"]) == 2
    assert "Resumed from step 6." in capsys.readouterr().out

    # frames: sharded over 2 ranks, and on one process
    torchrun("run_render", ["--distributed", "--device", "cpu", "--log-dir", str(dp), "--render-test-views",
                            "--num-views", "2", "--out-dir", str(tmp_path / "r_dp")])
    run_render.main(["--device", "cpu", "--log-dir", str(dp), "--render-test-views", "--num-views", "2",
                     "--out-dir", str(tmp_path / "r_one")])
    for i in range(2):
        a, b = load_png(tmp_path / "r_dp" / f"{i:04d}.png"), load_png(tmp_path / "r_one" / f"{i:04d}.png")
        assert a.shape == (16, 16, 3)
        np.testing.assert_allclose(a, b, atol=1.0 / 255.0)
    scores = evaluate.main([str(tmp_path / "r_dp"), str(tmp_path / "r_one"), "--device", "cpu"])
    assert scores["psnr"] > 40.0


def test_torchrun_scenes_over_ranks_match_one_process(tmp_path):
    scenes = TINY + ["data.num_scenes=2"]
    out = torchrun("run_train", ["--distributed", "--device", "cpu", "--log-dir", str(tmp_path / "dp"),
                                 "--max-steps", "4"] + scenes)
    assert "Training 2 scenes over 2 ranks (gloo)." in out
    val = [ln for ln in out.splitlines() if ln.startswith("validation @ step 4")]
    assert len(val) == 1 and "psnr_scene0=" in val[0] and "psnr_scene1=" in val[0]
    # the run checkpointed twice at step 4 (epoch 2, and its end); the resume
    # trains on from the whole state
    out = torchrun("run_train", ["--distributed", "--device", "cpu", "--log-dir", str(tmp_path / "dp"),
                                 "--max-steps", "6"])
    assert "Resumed from step 4." in out and "Training complete at step 6." in out
    for max_steps in ("4", "6"):
        run_train.main(["--device", "cpu", "--log-dir", str(tmp_path / "one"), "--max-steps", max_steps] + scenes)
    dp_ckpt = checkpoints.restore_latest(tmp_path / "dp")
    assert dp_ckpt["num_scenes"] == 2 and dp_ckpt["step"] == 6
    one_ckpt = checkpoints.restore_latest(tmp_path / "one")
    for a, b in zip(train.parameter_list(dp_ckpt["params"]), train.parameter_list(one_ckpt["params"])):
        assert a.shape[0] == 2
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(dp_ckpt["optimizer"]["state"].values(), one_ckpt["optimizer"]["state"].values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_dryrun_multichip_on_four_ranks():
    out = torchrun("dryrun_multichip", ["--device", "cpu"], nproc=4)
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert len(line) == 1 and "mesh={'data': 2, 'model': 2}" in line[0]
    for check in ("dp+tp", "fused_dp", "ngp_bricked_occ", "multiscene", "multiscene_fused"):
        assert f"{check}:loss=" in line[0]


def test_distributed_entry_points_refuse_without_a_card_or_torchrun(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the entry points would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.join(0, 1, f"file://{tmp_path / 'rendezvous'}")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs torchrun's environment"):
        run_train.main(["--distributed", "--device", "cpu", "--log-dir", str(tmp_path / "run")] + TINY)
    with pytest.raises(ValueError, match="parallel.data_axis_size=2 on 1 rank"):
        run_train.main(["--device", "cpu", "--log-dir", str(tmp_path / "run2"), "parallel.data_axis_size=2"] + TINY)
    with pytest.raises(ValueError, match="model_axis_size=2"):
        run_train.main(["--device", "cpu", "--log-dir", str(tmp_path / "run3"), "parallel.model_axis_size=2"] + TINY)
    assert not torch.distributed.is_initialized()
