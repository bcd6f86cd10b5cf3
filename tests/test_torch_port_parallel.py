"""The port's parallel layouts and sharded ray steps against the JAX package.

At ``tests/test_parallel.py``'s tiny shapes (feat 32, PE 2/1, 8 + 8
samples, 64 rays), the JAX side on the 8-device virtual CPU mesh of
``conftest.py`` (2 or 4 of its devices), the port's side on 2 and 4 gloo
ranks on the CPU (``parallel.launch.spawn``, a ``file://`` rendezvous under
``tmp_path``), each rank's work in :func:`_core_rank`, which imports
nothing of JAX. The same JAX params and draws go to both:

* ``nerf_param_spec`` against JAX's ``PartitionSpec`` tree at model sizes
  2 and 4, classic and Instant-NGP params;
* the generic DP step against JAX's ``make_sharded_train_step`` (loss rtol
  1e-5, params rtol 1e-4 / atol 1e-6, ``test_parallel.py:47-55``), and
  against the port's own single-process step;
* the gradient each step applied (read back from Adam's first moment, see
  :func:`applied_grads`) against JAX's gradient of the batch's loss, each
  leaf within relative L2 1e-5: Adam's step barely moves when a gradient
  is scaled, so the params alone would pass a DP mean without its 1/W or
  a TP backward that sums replicated cotangents;
* the fused DP step (kernel 3's plain version on the CPU) against JAX's
  fused ``shard_map`` step in interpret mode and the single-process fused
  step;
* TP over 2 and 4 ranks and DP x TP 2 x 2 against JAX's TP step and the
  replicated step (loss rtol 1e-4, ``test_parallel.py:131-147``), the
  sliced leaves' shapes, the whole params gathered after Adam;
* the sample-axis composite against JAX's (rtol 1e-5 / atol 1e-6);
* the refusals: a batch that does not divide over the ranks, and the
  backends (NCCL on the CPU, without NCCL, ranks that share a device).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import train
from torch_nerf_tpu_torch.fields import make_nerf_field
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.ops import integration
from torch_nerf_tpu_torch.parallel import launch, mesh as pmesh, sample_axis, steps
from torch_nerf_tpu_torch.renderer import RayUniforms, RenderSettings

FIELD_KW = dict(coord_encode_level=2, dir_encode_level=1, feat_dim=32)
FUSED = make_nerf_field(**FIELD_KW, compute_dtype=torch.float32)
PLAIN = make_nerf_field(**FIELD_KW, compute_dtype=torch.float32, use_kernel=False)
SETTINGS = RenderSettings(num_samples_coarse=8, num_samples_fine=8)
OPTIM = train.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
N_RAYS = 64
TIMEOUT = 60.0


def _np(tree):
    import jax  # noqa: PLC0415

    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _uniforms(rand):
    """JAX's ``draw_train_randomness`` dict -> the port's RayUniforms."""
    return RayUniforms(*(_t(rand[k]) for k in ("coarse_jitter", "fine_coarse_jitter", "fine_u", "fine_jitter")))


def port_state(jparams, optim=OPTIM):
    params = params_from_jax(jparams)
    for leaf in train.parameter_list(params):
        leaf.requires_grad_(True)
    opt = train.make_optimizer(params, optim)
    return train.TrainState(step=0, params=params, optimizer=opt, scheduler=train.lr_schedule(opt, optim))


def _batch(data):
    return _t(data["o"]), _t(data["d"]), _t(data["gt"]), data["rand"]


def applied_grads(opt_state) -> list:
    """The gradient that a first Adam step applied, in parameter_list
    order, from the optimizer's state dict after it: its first moment is
    ``(1 - beta1) g``."""
    beta1 = opt_state["param_groups"][0]["betas"][0]
    return [opt_state["state"][i]["exp_avg"] / (1.0 - beta1) for i in sorted(opt_state["state"])]


def one_step(field, data, mesh=None, force_generic=False, rays=None):
    """One ray step from the JAX params: ``(metrics, whole params after it
    (parameter_list order), the rank's leaf shapes, the whole gradient it
    applied)``."""
    state = port_state(data["params"])
    o, d, gt, rand = _batch(data) if rays is None else rays
    if mesh is None:
        step = train.make_ray_train_step(field, SETTINGS, OPTIM, force_generic)
    else:
        state = pmesh.place_state(mesh, state, OPTIM)
        step = steps.make_sharded_train_step(field, SETTINGS, OPTIM, mesh, force_generic)
    shapes = [tuple(p.shape) for p in train.parameter_list(state.params)]
    state, metrics = step(state, o, d, gt, rand)
    if mesh is None:
        params, opt_state = state.params, state.optimizer.state_dict()
    else:
        params, opt_state = pmesh.gather_state(mesh, state)
    return ({k: v.item() for k, v in metrics.items()},
            [p.detach().clone() for p in train.parameter_list(params)], shapes, applied_grads(opt_state))


def _core_rank(rank, world, init_method, data):
    """Every case of this file on one rank of ``world``."""
    out = {}
    if world == 2:
        dp = pmesh.init_mesh(rank, world, init_method, device="cpu", timeout=TIMEOUT)
        out["dp_generic"] = one_step(FUSED, data, dp, force_generic=True)
        out["dp_plain"] = one_step(PLAIN, data, dp)
        out["dp_fused"] = one_step(FUSED, data, dp)
        o, d, gt, rand = _batch(data)
        cut = (o[:-1], d[:-1], gt[:-1], RayUniforms(*(u[:-1] for u in rand)))
        for name, field in (("generic", PLAIN), ("fused", FUSED)):
            try:
                one_step(field, data, dp, rays=cut)
            except ValueError as err:
                out[f"refused_{name}"] = str(err)
        out["tp"] = one_step(FUSED, data, pmesh.make_mesh(dp.device, model_size=2, timeout=TIMEOUT))
        comp = sample_axis.make_sample_sharded_composite(dp.data_group)
        rgb, weights = comp(_t(data["sigma"]), _t(data["radiance"]), _t(data["delta"]))
        out["sample"] = (rgb, weights)
    else:
        mesh = pmesh.init_mesh(rank, world, init_method, data_size=2, model_size=2, device="cpu", timeout=TIMEOUT)
        out["dp_tp"] = one_step(FUSED, data, mesh)
        out["tp4"] = one_step(FUSED, data, pmesh.make_mesh(mesh.device, model_size=4, timeout=TIMEOUT))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's params, batch and draws, and its steps on them."""
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415

    from torch_nerf_tpu import train as jtrain  # noqa: PLC0415
    from torch_nerf_tpu.fields import make_nerf_field as jmake_field  # noqa: PLC0415
    from torch_nerf_tpu.ops import sampling as jsampling  # noqa: PLC0415
    from torch_nerf_tpu.parallel import make_mesh, make_sample_sharded_composite, make_sharded_train_step  # noqa: PLC0415
    from torch_nerf_tpu.renderer import RenderSettings as JSettings  # noqa: PLC0415

    jfield = jmake_field(**FIELD_KW)
    jfused = jmake_field(**FIELD_KW, use_pallas=True, pallas_interpret=True)
    jsettings = JSettings(num_samples_coarse=8, num_samples_fine=8)
    joptim = jtrain.OptimConfig(num_iter=100, init_lr=1e-3, end_lr=1e-4)
    state = jtrain.create_train_state(jax.random.PRNGKey(0), jfield, jsettings, joptim)
    rng = np.random.default_rng(0)
    o, d = rng.normal(size=(N_RAYS, 3)).astype(np.float32), rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    gt = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    batch = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(gt), key)
    devices = jax.devices()

    def grads(fused):
        """JAX's gradient of the whole batch's loss, parameter_list order."""
        if fused:
            rand = jtrain.draw_train_randomness(key, N_RAYS, jsettings)
            g = jtrain.fused_loss_and_grad(jfused, state.params, *batch[:3], rand, jsettings)[1]
        else:
            g = jax.grad(lambda p: jtrain.ray_loss_fn(jfield, p, *batch, jsettings)[0])(state.params)
        return train.parameter_list(_np(g))

    def sharded(field, shape, model_axis=None):
        names = ("data", "model") if model_axis else ("data",)
        mesh = make_mesh(names, shape=shape, devices=devices[:int(np.prod(shape))])
        build, place = make_sharded_train_step(field, jsettings, joptim, mesh, model_axis=model_axis)
        placed = place(jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state))  # the step donates it
        new, metrics = build(placed)(placed, *batch)
        return {k: float(v) for k, v in metrics.items()}, train.parameter_list(_np(jax.device_get(new.params)))

    s = 64  # the sample-axis case: (16, 64) over 2 ranks
    sigma = rng.uniform(0, 3, size=(16, s)).astype(np.float32)
    radiance = rng.uniform(size=(16, s, 3)).astype(np.float32)
    delta = np.asarray(jsampling.t_deltas(jnp.sort(jnp.asarray(rng.uniform(2, 6, size=(16, s)).astype(np.float32)),
                                                   axis=-1)))
    jrgb, jweights = make_sample_sharded_composite(make_mesh(("samples",), devices=devices[:2]), "samples")(
        jnp.asarray(sigma), jnp.asarray(radiance), jnp.asarray(delta))
    return dict(
        data=dict(params=_np(state.params), o=o, d=d, gt=gt,
                  rand=_uniforms(jtrain.draw_train_randomness(key, N_RAYS, jsettings)),
                  sigma=sigma, radiance=radiance, delta=delta),
        dp=sharded(jfield, (2,)), fused_dp=sharded(jfused, (2,)), tp=sharded(jfield, (1, 2), "model"),
        dp_tp=sharded(jfield, (2, 2), "model"), tp4=sharded(jfield, (1, 4), "model"),
        sample=(np.asarray(jrgb), np.asarray(jweights)), grads=grads(False), fused_grads=grads(True),
    )


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Both launches' results: ``{world: [rank 0's, rank 1's, ...]}``."""
    work = tmp_path_factory.mktemp("spawn")
    return {world: launch.spawn(_core_rank, world, work, (jax_side["data"],), timeout=240, threads=1)
            for world in (2, 4)}


@pytest.fixture(scope="module")
def single(jax_side):
    """The port's single-process steps on the same params and draws."""
    data = jax_side["data"]
    return {"generic": one_step(FUSED, data, force_generic=True), "plain": one_step(PLAIN, data),
            "fused": one_step(FUSED, data)}


def _grads_close(got, ref, tol=1e-5):
    """Each leaf's relative L2 error within ``tol`` (a leaf whose
    reference is all zero: the got leaf all zero too)."""
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.linalg.norm(b)
        err = np.linalg.norm(a - b) / scale if scale > 0 else np.linalg.norm(a)
        assert err <= tol, f"leaf {i} {b.shape}: relative L2 {err}, reference norm {scale}"


def _close(got, ref, rtol, atol):
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=f"leaf {i}")


def _jspec_dims(spec):
    """JAX's PartitionSpec tree -> the port's ``{leaf: dim or None}``."""
    from jax.sharding import PartitionSpec  # noqa: PLC0415

    if isinstance(spec, dict):
        return {k: _jspec_dims(v) for k, v in spec.items()}
    assert isinstance(spec, PartitionSpec)
    return spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("net", ["classic", "ngp"])
def test_param_spec_matches_jax(net, model_size):
    import jax  # noqa: PLC0415

    from torch_nerf_tpu.fields import make_nerf_field as jmake_field  # noqa: PLC0415
    from torch_nerf_tpu.fields_ngp import make_instant_ngp_field  # noqa: PLC0415
    from torch_nerf_tpu.parallel.mesh import nerf_param_spec as jspec  # noqa: PLC0415

    if net == "classic":
        jfield = jmake_field()  # the flagship widths: fc_5 takes 256 + 63, fc_8 gives 257
    else:
        jfield = make_instant_ngp_field(num_level=2, log_max_entry_per_level=10, min_res=4, max_res=8,
                                        table_layout="bricked")
    params = _np({"coarse": jfield.init(jax.random.PRNGKey(0)), "fine": jfield.init(jax.random.PRNGKey(1))})
    got = pmesh.nerf_param_spec(params, model_size)
    assert got == _jspec_dims(jspec(params, "model", model_size))
    if net == "classic":
        assert got["coarse"]["fc_in"] == {"w": 1, "b": 0} and got["coarse"]["fc_1"] == {"w": 0, "b": None}
        assert got["fine"]["fc_5"] == got["fine"]["fc_8"] == {"w": None, "b": None}
    else:
        assert all(d is None for d in train.parameter_list(got))
    # one rank's slices: the columns of fc_in, the rows of fc_1
    for rank in range(model_size):
        mine = pmesh.shard_params_from_jax(params, model_size, rank)
        if net == "classic":
            width = 256 // model_size
            np.testing.assert_array_equal(mine["coarse"]["fc_in"]["w"].numpy(),
                                          params["coarse"]["fc_in"]["w"][:, rank * width:(rank + 1) * width])
            np.testing.assert_array_equal(mine["coarse"]["fc_1"]["w"].numpy(),
                                          params["coarse"]["fc_1"]["w"][rank * width:(rank + 1) * width])
            assert mine["coarse"]["fc_5"]["w"].shape == (256 + 63, 256)


@pytest.mark.parametrize("path", ["dp_generic", "dp_plain"])
def test_generic_dp_step_matches_jax_and_the_single_process(ranks, jax_side, single, path):
    metrics, params, _, grads = ranks[2][0][path]
    jmetrics, jparams = jax_side["dp"]
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-5)
    _close(params, jparams, rtol=1e-4, atol=1e-6)
    _grads_close(grads, jax_side["grads"])
    ref = single["generic" if path == "dp_generic" else "plain"]
    np.testing.assert_allclose(metrics["loss"], ref[0]["loss"], rtol=1e-6)
    _close(params, ref[1], rtol=1e-5, atol=1e-7)
    _grads_close(grads, ref[3])
    for a, b in zip(params, ranks[2][1][path][1]):
        assert torch.equal(a, b)  # the same params on every rank


def test_fused_dp_step_matches_jax_interpret_and_the_single_process(ranks, jax_side, single):
    metrics, params, _, grads = ranks[2][0]["dp_fused"]
    jmetrics, jparams = jax_side["fused_dp"]
    for name in ("coarse_loss", "fine_loss", "loss"):
        np.testing.assert_allclose(metrics[name], jmetrics[name], rtol=1e-5, err_msg=name)
    _close(params, jparams, rtol=1e-4, atol=1e-6)
    _grads_close(grads, jax_side["fused_grads"])
    _grads_close(grads, single["fused"][3])
    np.testing.assert_allclose(metrics["loss"], single["fused"][0]["loss"], rtol=1e-6)
    _close(params, single["fused"][1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["tp", "dp_tp", "tp4"])
def test_tensor_parallel_step_matches_jax_and_the_replicated_step(ranks, jax_side, single, case):
    world = 2 if case == "tp" else 4
    model = 4 if case == "tp4" else 2
    metrics, params, shapes, grads = ranks[world][0][case]
    jmetrics, jparams = jax_side[case]
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(metrics["loss"], single["generic"][0]["loss"], rtol=1e-4)
    _close(params, jparams, rtol=1e-4, atol=1e-6)
    _close(params, single["generic"][1], rtol=1e-4, atol=1e-6)
    _grads_close(grads, jax_side["grads"])
    _grads_close(grads, single["generic"][3])
    # the sliced leaves: sorted order coarse/fine, layers by name, b before w
    dims = train.parameter_list(pmesh.nerf_param_spec(jax_side["data"]["params"], model))
    whole = [tuple(np.shape(p)) for p in train.parameter_list(jax_side["data"]["params"])]
    # w and b of the 4 column layers, w of fc_1, fc_3 and fc_7 (fc_5 takes 32 + 15 columns), in 2 networks
    assert sum(d is not None for d in dims) == 2 * (4 * 2 + 3)
    for shape, full, dim in zip(shapes, whole, dims):
        want = list(full)
        if dim is not None:
            want[dim] //= model
        assert shape == tuple(want)
    for rank in range(1, world):
        for a, b in zip(params, ranks[world][rank][case][1]):
            assert torch.equal(a, b)


def test_sample_axis_composite_matches_jax_and_the_whole(ranks, jax_side):
    data = jax_side["data"]
    rgb, weights = ranks[2][0]["sample"]
    np.testing.assert_allclose(rgb.numpy(), jax_side["sample"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(weights.numpy(), jax_side["sample"][1], rtol=1e-5, atol=1e-6)
    ref_rgb, ref_w = integration.composite(_t(data["sigma"]), _t(data["radiance"]), _t(data["delta"]))
    np.testing.assert_allclose(rgb.numpy(), ref_rgb.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(weights.numpy(), ref_w.numpy(), rtol=1e-5, atol=1e-6)
    assert data["delta"][:, -1].min() >= 1e7  # the 1e8 tail sits in the last rank's samples
    assert torch.equal(rgb, ranks[2][1]["sample"][0])


def test_a_batch_that_does_not_divide_over_the_ranks_raises(ranks):
    for name in ("generic", "fused"):
        assert "ray batch 63 must divide over 2 'data' shards" in ranks[2][0][f"refused_{name}"]


def test_backends_refuse_what_they_cannot_run():
    pmesh.check_backend("gloo", "cuda", 4, 1, False)
    pmesh.check_backend("gloo", "cpu", 4, 0, False)
    pmesh.check_backend("nccl", "cuda", 1, 1, True)
    with pytest.raises(ValueError, match="use gloo on the CPU"):
        pmesh.check_backend("nccl", "cpu", 1, 0, True)
    with pytest.raises(RuntimeError, match="no NCCL; use the gloo backend"):
        pmesh.check_backend("nccl", "cuda", 1, 1, False)
    with pytest.raises(ValueError, match="refuses two ranks on one device; use the gloo backend"):
        pmesh.check_backend("nccl", "cuda", 2, 1, True)
    with pytest.raises(ValueError, match="unknown backend"):
        pmesh.check_backend("mpi", "cpu", 1, 0, False)
    # the refusals come before any process group forms
    with pytest.raises(ValueError, match="use gloo on the CPU"):
        pmesh.init_mesh(0, 1, "file:///nonexistent/rendezvous", backend="nccl", device="cpu")
    with pytest.raises(ValueError, match=r"mesh shape \(3, 2\) does not cover 4 ranks"):
        pmesh.init_mesh(0, 4, "file:///nonexistent/rendezvous", data_size=3, model_size=2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(launch.RankFailed, match="rank 1 exited with code 1"):
        launch.spawn(_failing_rank, 2, tmp_path, timeout=TIMEOUT, threads=1)


def _failing_rank(rank, world, init_method):
    mesh = pmesh.init_mesh(rank, world, init_method, device="cpu", timeout=TIMEOUT)
    if rank == 1:
        raise RuntimeError("planted failure")
    # rank 0 waits on rank 1 in a collective; the launch must not wait for its timeout
    steps.DataParallel(mesh).mean({"x": torch.zeros(())}, [torch.zeros(3)])
    return Path(init_method).name
