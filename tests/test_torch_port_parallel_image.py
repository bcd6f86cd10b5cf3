"""The port's sharded image steps, sharded render and scenes over ranks.

Two gloo ranks on the CPU (``parallel.launch.spawn``, a ``file://``
rendezvous under ``tmp_path``) run every case of this file once
(:func:`_image_rank`, which imports nothing of JAX); the parent holds them
against the port's single-process paths and, where the JAX package has the
same path, against JAX on its 8-device virtual CPU mesh:

* ``make_sharded_image_train_step`` with occupancy pruning, a sweep at
  steps 0 and 2 and pruning after the warmup (the classic field through
  kernel 3's plain version, the bricked Instant-NGP field through the hash
  encodes' plain versions), and the packed layout with its smoothness aux
  loss, three steps each against the single-process image step on the same
  draws: losses rtol 1e-5, params rtol 1e-4 / atol 1e-6, the first step's
  gradient (from Adam's first moment) each leaf within relative L2 1e-5,
  the grid the same
  on both ranks bit for bit, and the single process's: bit for bit after
  the first sweep, rtol 1e-5 after the second (its params were averaged);
* ``make_sharded_render`` against ``render_image`` (its own draws, and
  JAX's handed over) and JAX's ``make_sharded_render`` (2e-5);
* scenes over ranks (2 scenes, 2 ranks) against the port's single-process
  multi-scene step (max-abs 0.0) and JAX's ``make_multiscene_shardmap_step``
  (``test_torch_port_multiscene.py``'s tolerances), and the refusal of a
  scene count that does not divide over the ranks.
"""

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import cameras, multiscene, occupancy, train
from torch_nerf_tpu_torch.datasets import synthetic
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.fields_ngp import make_encode_smoothness_loss, make_instant_ngp_field
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.parallel import launch, mesh as pmesh, steps
from torch_nerf_tpu_torch.renderer import RenderSettings, render_image
from tests.test_torch_port_parallel import _grads_close, applied_grads

FIELD_KW = dict(coord_encode_level=2, dir_encode_level=1, feat_dim=32)
FUSED = make_nerf_field(**FIELD_KW, compute_dtype=torch.float32)
NGP_SIZE = dict(num_level=3, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=16)
OPTIM = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
NGP_OPTIM = train.OptimConfig(num_iter=100, init_lr=1e-2, end_lr=1e-3)
# thresholds near the median density of the seeded fields' grids: some cells kept, some pruned
OCC = occupancy.OccupancyConfig(resolution=4, bound=2.0, update_every=2, threshold=0.12, keep_samples=6,
                                warmup_steps=1, keep_samples_fine=10)
RENDER_H, RENDER_W, CHUNK = 12, 16, 64
TIMEOUT = 60.0


def image_case(name: str):
    """``(field, settings, optim, aux loss or None, occupancy or None)``."""
    if name == "classic_occ":
        return FUSED, RenderSettings(num_samples_coarse=8, num_samples_fine=8), OPTIM, None, OCC
    ngp_settings = RenderSettings(num_samples_coarse=16, num_samples_fine=0)
    if name == "bricked_occ":
        occ = occupancy.OccupancyConfig(resolution=4, bound=2.0, update_every=2, threshold=1.1339452, keep_samples=8,
                                        warmup_steps=1)
        return make_instant_ngp_field(**NGP_SIZE, table_layout="bricked"), ngp_settings, NGP_OPTIM, None, occ
    raw = make_encode_smoothness_loss(3, min_res=4, max_res=16, table_feat_dim=2, table_layout="packed",
                                      num_probes=64)

    def aux(params, draws):
        return 0.1 * raw(params["coarse"], draws[0])

    aux.draw = lambda generator: (raw.draw(generator),)
    return make_instant_ngp_field(**NGP_SIZE, table_layout="packed"), ngp_settings, NGP_OPTIM, aux, None


def image_pool():
    images, poses, camera, _ = synthetic.make_dataset(num_views=2, img_size=16)
    return torch.as_tensor(images), torch.as_tensor(poses), camera


def image_run(name: str, mesh=None, num_steps: int = 3) -> dict:
    """``num_steps`` image steps of case ``name`` from seeded params and
    draws: each step's metrics, the params after, the grid, the first
    step's gradient."""
    field, settings, optim, aux, occ = image_case(name)
    images, poses, camera = image_pool()
    state = train.create_train_state(torch.Generator().manual_seed(0), field, settings, optim)
    if mesh is None:
        step = train.make_image_train_step(field, settings, optim, camera, 32, aux_loss_fn=aux, occupancy_cfg=occ)
    else:
        state = pmesh.place_state(mesh, state, optim)
        step = steps.make_sharded_image_train_step(field, settings, optim, camera, mesh, 32, aux_loss_fn=aux,
                                                   occupancy_cfg=occ)
    gen = torch.Generator().manual_seed(1)
    grid = occupancy.init_grid(occ) if occ is not None else None
    metrics, grids = [], []
    for _ in range(num_steps):
        if grid is None:
            state, m = step(state, images, poses, gen)
        else:
            state, grid, m = step(state, grid, images, poses, gen)
            grids.append(grid.clone())
        metrics.append({k: v.item() for k, v in m.items()})
        if len(metrics) == 1:
            first = applied_grads(state.optimizer.state_dict())
    return dict(metrics=metrics, params=[p.detach().clone() for p in train.parameter_list(state.params)], grids=grids,
                grads=first)


def sharded_frames(mesh, data) -> dict:
    camera = cameras.CameraParams(focal_x=20.0, focal_y=20.0, img_width=RENDER_W, img_height=RENDER_H)
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    params = params_from_jax(data["render_params"])
    pose = torch.as_tensor(_pose())
    table = data["chunk_draws"]
    frames = {}
    for name, draws in (("own", None), ("jax", lambda first, n: table[first])):
        render = steps.make_sharded_render(FUSED, settings, mesh, camera, CHUNK, uniforms_for_chunk=draws)
        frames[name] = render(params["coarse"], params["fine"], pose, 7)
    return frames


def scene_step(data, mesh=None) -> dict:
    """One 2-scene step from JAX's stacked params on its draws, whole or
    scenes over ``mesh``: the metrics and the whole params and moments."""
    images, poses = torch.as_tensor(data["scene_images"]), torch.as_tensor(data["scene_poses"])
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    params = params_from_jax(data["scene_params"])
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, OPTIM)
    state = train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, OPTIM))
    draws = data["scene_draws"]
    if mesh is None:
        step = multiscene.make_multiscene_train_step(FUSED, settings, OPTIM, data["camera"], 2, 32)
        state, metrics = step(state, images, poses, draws=draws)
        whole, opt_state = state.params, state.optimizer.state_dict()
    else:
        state = pmesh.place_state(mesh, state, OPTIM, pmesh.scene_spec(state.params), "data")
        step = steps.make_multiscene_shard_step(FUSED, settings, OPTIM, data["camera"], 2, mesh, 32)
        mine = step.scenes
        state, metrics = step(state, images[mine.start:mine.stop], poses[mine.start:mine.stop],
                              draws=draws[mine.start:mine.stop])
        whole, opt_state = pmesh.gather_state(mesh, state, pmesh.scene_spec(state.params), "data")
        # a second gather (a run checkpoints more than once) gives the same,
        # and leaves the rank's own moments as they were
        again = pmesh.gather_state(mesh, state, pmesh.scene_spec(state.params), "data")[1]
        assert all(torch.equal(again["state"][i][k], opt_state["state"][i][k])
                   for i in opt_state["state"] for k in ("exp_avg", "exp_avg_sq"))
        assert all(s["exp_avg"].shape == p.shape for p, s in state.optimizer.state.items())
    moments = [opt_state["state"][i][k] for i in sorted(opt_state["state"]) for k in ("exp_avg", "exp_avg_sq")]
    return dict(metrics={k: v.detach().clone() for k, v in metrics.items()},
                params=[p.detach().clone() for p in train.parameter_list(whole)], moments=moments)


def _image_rank(rank, world, init_method, data):
    mesh = pmesh.init_mesh(rank, world, init_method, device="cpu", timeout=TIMEOUT)
    out = {name: image_run(name, mesh) for name in ("classic_occ", "bricked_occ", "packed_smooth")}
    out["frames"] = sharded_frames(mesh, data)
    out["scenes"] = scene_step(data, mesh)
    try:
        steps.local_scenes(mesh, 3)
    except ValueError as err:
        out["scene_refusal"] = str(err)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's render params and draws, its sharded frame, and its shard_map
    multi-scene step with the port's draws of it."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from tests import test_torch_port_multiscene as ms  # noqa: PLC0415
    from tests.test_torch_port_render import jax_uniforms  # noqa: PLC0415
    from torch_nerf_tpu import cameras as jcam  # noqa: PLC0415
    from torch_nerf_tpu.fields import make_nerf_field as jmake_field  # noqa: PLC0415
    from torch_nerf_tpu.parallel import make_mesh, make_sharded_render  # noqa: PLC0415
    from torch_nerf_tpu.renderer import RenderSettings as JSettings  # noqa: PLC0415

    jfield = jmake_field(**FIELD_KW)
    jsettings = JSettings(num_samples_coarse=8, num_samples_fine=8)
    kc, kf = jax.random.split(jax.random.PRNGKey(3))
    render_params = {"coarse": ms._np(jfield.init(kc)), "fine": ms._np(jfield.init(kf))}
    camera = jcam.CameraParams(focal_x=20.0, focal_y=20.0, img_width=RENDER_W, img_height=RENDER_H)
    key = jax.random.PRNGKey(11)
    render = make_sharded_render(jfield, jsettings, make_mesh(("data",), devices=jax.devices()[:2]), camera,
                                 chunk_size=CHUNK)
    frame = np.asarray(render(render_params["coarse"], render_params["fine"], jnp.asarray(_pose()), key))
    draw = jax_uniforms(key, jsettings)
    chunk_draws = {first: draw(first, CHUNK) for first in range(0, RENDER_H * RENDER_W, CHUNK)}

    images, poses, scene_camera = ms._scene_data(2)
    state0 = ms._jax_state(jax.random.PRNGKey(0), ms.JFIELD, ms.JSETTINGS, ms.JOPTIM, 2)
    skey = jax.random.PRNGKey(7)
    jstate, jmetrics = ms._shardmap_step(ms.JFIELD, ms.JSETTINGS, ms.JOPTIM, jcam.CameraParams(*scene_camera), 2,
                                         state0, images, poses, skey, 32)
    data = dict(render_params=render_params, chunk_draws=chunk_draws, scene_images=images, scene_poses=poses,
                camera=scene_camera, scene_params=ms._np(state0.params),
                scene_draws=ms._jax_draws(skey, 2, 2, 32, ms.JSETTINGS))
    return dict(data=data, frame=frame, scene_params=train.parameter_list(ms._np(jstate.params)),
                scene_metrics=ms._np(jmetrics))


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    return pose


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    return launch.spawn(_image_rank, 2, tmp_path_factory.mktemp("spawn"), (jax_side["data"],), timeout=240,
                        threads=1)


@pytest.mark.parametrize("name", ["classic_occ", "bricked_occ", "packed_smooth"])
def test_sharded_image_step_matches_the_single_process(ranks, name):
    ref = image_run(name)
    for rank in ranks:
        got = rank[name]
        for step, (m, r) in enumerate(zip(got["metrics"], ref["metrics"])):
            assert set(m) == set(r)
            for key in r:
                np.testing.assert_allclose(m[key], r[key], rtol=1e-5, err_msg=f"step {step} {key}")
        for i, (a, b) in enumerate(zip(got["params"], ref["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6, err_msg=f"leaf {i}")
        _grads_close(got["grads"], ref["grads"])
    if name == "packed_smooth":
        assert all(m["aux_loss"] > 0.0 for m in ref["metrics"])
    else:
        # swept at steps 0 and 2, pruning from step 1 by a grid with some cells empty, some not
        occ = ref["grids"][0] > image_case(name)[4].threshold
        assert 0 < int(occ.sum()) < occ.numel()
        for rank in ranks:
            # the sweep of the same params gives the same grid; the second
            # sweep reads params that the DP mean rounded otherwise
            assert torch.equal(rank[name]["grids"][0], ref["grids"][0])
            np.testing.assert_allclose(rank[name]["grids"][-1].numpy(), ref["grids"][-1].numpy(), rtol=1e-5)
            assert torch.equal(rank[name]["grids"][-1], ranks[0][name]["grids"][-1])
    for a, b in zip(ranks[0][name]["params"], ranks[1][name]["params"]):
        assert torch.equal(a, b)


def test_sharded_render_matches_render_image_and_jax(ranks, jax_side):
    data = jax_side["data"]
    params = params_from_jax(data["render_params"])
    camera = cameras.CameraParams(focal_x=20.0, focal_y=20.0, img_width=RENDER_W, img_height=RENDER_H)
    settings = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
    pose = torch.as_tensor(_pose())
    table = data["chunk_draws"]
    own = render_image(FUSED, params["coarse"], params["fine"], camera, pose, 7, settings, chunk_size=CHUNK)
    theirs = render_image(FUSED, params["coarse"], params["fine"], camera, pose, 7, settings, chunk_size=CHUNK,
                          uniforms_for_chunk=lambda first, n: table[first])
    for rank in ranks:
        frames = rank["frames"]
        assert frames["own"].shape == (RENDER_H, RENDER_W, 3)
        np.testing.assert_allclose(frames["own"].numpy(), own.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(frames["jax"].numpy(), theirs.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(frames["jax"].numpy(), jax_side["frame"], rtol=2e-5, atol=2e-5)
    assert torch.equal(ranks[0]["frames"]["own"], ranks[1]["frames"]["own"])


def test_scenes_over_ranks_match_the_single_process_and_jax(ranks, jax_side):
    ref = scene_step(jax_side["data"])
    for rank in ranks:
        got = rank["scenes"]
        assert set(got["metrics"]) == set(ref["metrics"])
        for key in ref["metrics"]:
            assert torch.equal(got["metrics"][key], ref["metrics"][key]), key
        for a, b in zip(got["params"] + got["moments"], ref["params"] + ref["moments"]):
            assert a.shape[0] == 2 and torch.equal(a, b)
    got = ranks[0]["scenes"]
    for key in ("coarse_loss", "fine_loss", "loss"):
        np.testing.assert_allclose(got["metrics"][key].numpy(), np.asarray(jax_side["scene_metrics"][key]),
                                   rtol=1e-4, err_msg=key)
    for a, b in zip(got["params"], jax_side["scene_params"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=1e-6)


def test_a_scene_count_that_does_not_divide_over_the_ranks_raises(ranks):
    assert ranks[0]["scene_refusal"] == "num_scenes 3 must divide over 2 'data' shards"
