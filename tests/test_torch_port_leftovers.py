"""The last JAX modules' counterparts in the port, each against the JAX
package on the CPU.

``cameras.generate_screen_coords`` on ``tests/test_cameras.py``'s cases and
equal to JAX's table; ``fields.make_scene_field`` on
``tests/test_train.py``'s case, its active primitive equal to JAX's on the
same weights; ``models.nerf.params_from_torch_state_dict`` equal to JAX's
conversion, and the port's field held against the frozen reference
fixture ``tests/fixtures/torch_golden.npz`` in the three cases of
``tests/test_golden_fixtures.py`` at their tolerances (the fixture is only
read); ``MetricsLogger``'s TensorBoard writer and ``log_image``, and
``run_train``'s ``val/pred_vs_gt`` image. Inputs come from seeded numpy
generators.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import cameras as jcameras
from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu.models import nerf as jnerf
from torch_nerf_tpu_torch import cameras, encoders, fields, logging_utils
from torch_nerf_tpu_torch.models import nerf
from torch_nerf_tpu_torch.ops import integration, sampling
from torch_nerf_tpu_torch.runners import run_train

FIXTURE = Path(__file__).parent / "fixtures" / "torch_golden.npz"


# ---------------------------------------------------------------------------
# cameras.generate_screen_coords


def test_screen_coords_y_flip():
    coords = cameras.generate_screen_coords(6, 8).numpy()
    assert coords.shape == (48, 2) and coords.dtype == np.float32
    # pixel 0 = row 0, col 0 -> x=0, y=H-1
    np.testing.assert_array_equal(coords[0], [0.0, 5.0])
    # pixel (row 2, col 3) -> flat 2*8+3=19 -> x=3, y=5-2=3
    np.testing.assert_array_equal(coords[19], [3.0, 3.0])
    # last pixel -> x=W-1, y=0
    np.testing.assert_array_equal(coords[-1], [7.0, 0.0])
    np.testing.assert_array_equal(coords, np.asarray(jcameras.generate_screen_coords(6, 8)))


def test_screen_coords_from_indices_matches_table():
    table = cameras.generate_screen_coords(6, 8)
    arith = cameras.screen_coords_from_indices(torch.arange(48, dtype=torch.int32), 6, 8)
    assert torch.equal(arith, table)


# ---------------------------------------------------------------------------
# fields.make_scene_field


def test_scene_field_container_queries_active_primitive():
    """Init covers every primitive, apply hits the active one, as JAX's."""
    a = fields.make_nerf_field(coord_encode_level=2, dir_encode_level=1, feat_dim=16)
    b = fields.make_nerf_field(coord_encode_level=3, dir_encode_level=1, feat_dim=16)
    scene = fields.make_scene_field({"cube_a": a, "cube_b": b}, active="cube_b")
    params = scene.init(torch.Generator().manual_seed(0))
    assert set(params) == {"cube_a", "cube_b"}
    assert params["cube_b"]["fc_in"]["w"].shape == (21, 16) and params["cube_a"]["fc_in"]["w"].shape == (15, 16)

    pts = np.random.default_rng(0).normal(size=(4, 2, 3)).astype(np.float32)
    dirs = np.random.default_rng(1).normal(size=(4, 2, 3)).astype(np.float32)
    sigma, rgb = scene.apply(params, torch.from_numpy(pts), torch.from_numpy(dirs))
    s_b, r_b = b.apply(params["cube_b"], torch.from_numpy(pts), torch.from_numpy(dirs))
    assert torch.equal(sigma, s_b) and torch.equal(rgb, r_b)
    assert scene.prepare(params)["cube_a"] is params["cube_a"]

    # JAX's scene on the same weights
    ja = jfields.make_nerf_field(coord_encode_level=2, dir_encode_level=1, feat_dim=16)
    jb = jfields.make_nerf_field(coord_encode_level=3, dir_encode_level=1, feat_dim=16)
    jscene = jfields.make_scene_field({"cube_a": ja, "cube_b": jb}, active="cube_b")
    jparams = nerf.params_to_jax(params)
    jsigma, jrgb = jscene.apply(jparams, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError, match="cube_c"):
        fields.make_scene_field({"cube_a": a}, active="cube_c")


# ---------------------------------------------------------------------------
# models.nerf.params_from_torch_state_dict and the frozen fixture


@pytest.fixture(scope="module")
def golden():
    data = np.load(FIXTURE)
    state_dict = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    return data, state_dict, nerf.params_from_torch_state_dict(state_dict)


def test_state_dict_conversion_matches_jax(golden):
    _, state_dict, params = golden
    jparams = jnerf.params_from_torch_state_dict(state_dict)
    for name in nerf.LAYER_NAMES:
        assert params[name]["w"].shape == state_dict[f"{name}.weight"].shape[::-1]
        np.testing.assert_array_equal(params[name]["w"].numpy(), np.asarray(jparams[name]["w"]))
        np.testing.assert_array_equal(params[name]["b"].numpy(), np.asarray(jparams[name]["b"]))
    # torch tensors convert as numpy arrays do
    again = nerf.params_from_torch_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()})
    assert torch.equal(again["fc_8"]["w"], params["fc_8"]["w"])


def test_mlp_forward_matches_golden(golden):
    data, _, params = golden
    sigma, rgb = nerf.nerf_apply(params, torch.from_numpy(data["mlp_pos"]), torch.from_numpy(data["mlp_dirs"]))
    np.testing.assert_allclose(sigma.numpy(), data["mlp_sigma"], rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(rgb.numpy(), data["mlp_rgb"], rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_full_render_matches_golden(golden, use_kernel):
    """The port's field (through the fused kernel's wrapper, its plain
    version on the CPU, and the plain field) on the fixture's rays."""
    data, _, params = golden
    l_pos, l_dir = (int(x) for x in data["render_L"])
    field = fields.make_nerf_field(coord_encode_level=l_pos, dir_encode_level=l_dir,
                                   feat_dim=params["fc_1"]["w"].shape[0], use_kernel=use_kernel)
    o, d, ts = (torch.from_numpy(data[k]) for k in ("render_o", "render_d", "render_ts"))
    pts = sampling.points_along_rays(o, d, ts)
    dirs = d[:, None, :].expand(pts.shape)
    sigma, radiance = field.apply(field.prepare(params), pts, dirs)
    rgb, w = integration.composite(sigma, radiance, sampling.t_deltas(ts))
    np.testing.assert_allclose(rgb.numpy(), data["render_rgb"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), data["render_w"], rtol=1e-4, atol=1e-5)


def test_pixel_gradient_matches_golden(golden):
    data, _, params = golden
    leaf = params["fc_in"]["w"].clone().requires_grad_(True)
    p = {**params, "fc_in": {"w": leaf, "b": params["fc_in"]["b"]}}
    s, r = nerf.nerf_apply(p, torch.from_numpy(data["grad_pos"]), torch.from_numpy(data["grad_dirs"]))
    pix, _ = integration.composite(s.reshape(8, 8), r.reshape(8, 8, 3), torch.from_numpy(data["grad_delta"]))
    torch.mean(pix).backward()
    np.testing.assert_allclose(leaf.grad.numpy().T, data["grad_fc_in_w"], rtol=1e-3, atol=1e-6)


def test_fixture_encodings_are_the_ports():
    """The fixture's MLP inputs are positional encodings of L = 2 and 1: the
    port's encoder gives encodings of the same width."""
    data = np.load(FIXTURE)
    assert data["mlp_pos"].shape[1] == encoders.positional_encoding_dim(3, 2, True)
    assert data["mlp_dirs"].shape[1] == encoders.positional_encoding_dim(3, 1, True)


# ---------------------------------------------------------------------------
# MetricsLogger's TensorBoard writer, log_image, run_train's val image


def _event_files(log_dir):
    return sorted((Path(log_dir) / "tensorboard").glob("events.out.tfevents.*"))


def test_metrics_logger_writes_tensorboard_events_where_it_imports(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    logger = logging_utils.MetricsLogger(tmp_path)
    logger.log_scalars(3, {"train/loss": 0.5})
    logger.log_image(3, "val/pred_vs_gt", np.random.default_rng(0).uniform(size=(4, 8, 3)).astype(np.float32))
    logger.close()
    events = _event_files(tmp_path)
    assert len(events) == 1 and events[0].stat().st_size > 0
    assert (tmp_path / "metrics.jsonl").read_text().count("train/loss") == 1


def test_metrics_logger_goes_on_without_tensorboard(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    logger = logging_utils.MetricsLogger(tmp_path)
    assert logger._tb is None
    logger.log_scalars(1, {"val/psnr": 20.0})
    logger.log_image(1, "val/pred_vs_gt", np.zeros((2, 4, 3), np.float32))
    logger.close()
    assert not (tmp_path / "tensorboard").exists()
    assert "val/psnr" in (tmp_path / "metrics.jsonl").read_text()
    off = logging_utils.MetricsLogger(tmp_path / "off", use_tensorboard=False)
    assert off._tb is None
    off.close()


TINY = ["--device", "cpu", "data.dataset_type=gaussian_blobs", "data.img_size=16", "data.num_views=2",
        "network.feat_dim=32", "signal_encoder.coord_encode_level=4", "signal_encoder.dir_encode_level=2",
        "renderer.num_pixels=128", "renderer.num_samples_coarse=8", "renderer.num_samples_fine=8",
        "train_params.validation.validate_every=1", "train_params.validation.num_batch=1",
        "train_params.log.epoch_btw_ckpt=100", "train_params.log.epoch_btw_vis=100"]


def test_run_train_logs_the_validation_image(tmp_path, monkeypatch):
    images = []
    real = logging_utils.MetricsLogger.log_image

    def record(self, step, tag, image):
        images.append((step, tag, image.shape))
        real(self, step, tag, image)

    monkeypatch.setattr(logging_utils.MetricsLogger, "log_image", record)
    # an epoch is 2 steps (one a view), validated on the 32x32 val view
    out = run_train.main(["--log-dir", str(tmp_path / "run"), "--max-steps", "2"] + TINY)
    assert out["step"] == 2
    # view 0's prediction beside its ground truth, at the validation step
    assert images == [(2, "val/pred_vs_gt", (32, 64, 3))]
    if logging_utils.MetricsLogger(tmp_path / "probe")._tb is not None:
        assert len(_event_files(tmp_path / "run")) == 1
