"""The Instant-NGP field's fused forward after the hash encode
(``ops/ngp_mlp.py``, ``csrc/ngp_mlp_fwd.cu``).

On the CPU: the prepared route's plain version against the tree route
(``instant_ngp_apply``) bit for bit at every layout, bf16, a point count
off the 64s; ``prepare`` the identity wherever the kernel does not take
the config; a frame through ``prepare`` equal to the tree route's; a
render chunk's unit holding one ``field.fused_mlp`` span and one launch a
pass; an occupancy sweep's densities through the fused route; the train
step never preparing; the weight image decoded where the
kernel reads each layer and bias; the accumulator-to-A-fragment repack and
the kernel's SH order, transcribed, against the plain versions.

On a Hopper card (skipped elsewhere): the kernel against its plain version
at the render cell's shape (4096 rays x 256 samples) with 32 and 64
features and at ragged shapes, each held against the plain version in
f32 (the yardstick) by the plain bf16 version's own error (2x it + 1e-3, relative L2: only the order
of the f32 sums differs); NaN and +-inf features coming out where the
plain version puts them; a relaunch bit-identical.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch import cameras, encoders, occupancy, renderer, tracing, train
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field, rays_of
from torch_nerf_tpu_torch.ops import launch_count, ngp_mlp
from torch_nerf_tpu_torch.ops.fused_nerf import swizzle128

LAYOUTS = ("hash", "bricked", "packed", "packed_dual")
# L 16 x F 2 (x 2 levels when dual): the inputs the kernel takes, small tables
GRID = dict(num_level=16, log_max_entry_per_level=10, table_feat_dim=2, min_res=4, max_res=64)
BF16 = dict(GRID, compute_dtype=torch.bfloat16)


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def field_and_params(layout="hash", seed=0, **kw):
    field = make_instant_ngp_field(**{**BF16, "table_layout": layout, **kw})
    params = field.init(torch.Generator().manual_seed(seed))
    # the render cell's init: tables U(-1, 1), MLP weights x sqrt(6)
    params["tables"] = params["tables"] * 1e4
    for mlp in ("density_mlp", "color_mlp"):
        for layer in params[mlp].values():
            layer["w"] = layer["w"] * math.sqrt(6.0)
    return field, params


def ray_points(rays, samples, seed=1):
    gen = torch.Generator().manual_seed(seed)
    o = torch.randn(rays, 3, generator=gen) * 0.3
    d = torch.randn(rays, 3, generator=gen)
    t = torch.rand(rays, samples, generator=gen) * 2.0 + 0.5
    pts = o[:, None] + t[..., None] * d[:, None]
    return pts, d[:, None, :].expand_as(pts)


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prepared_route_equals_the_tree_route_bit_for_bit(layout, is_hdr):
    field, params = field_and_params(layout, is_hdr=is_hdr)
    w = field.prepare(params)
    assert isinstance(w, ngp_mlp.NgpWeights) and w.in_dim == (64 if layout == "packed_dual" else 32)
    assert field.prepare(w) is w
    pts, dirs = ray_points(7, 19)  # 133 points: off the kernel's 64-point tiles
    sigma, rgb = field.apply(params, pts, dirs)
    got_sigma, got_rgb = field.apply(w, pts, dirs)
    assert got_sigma.shape == (7, 19) and got_rgb.shape == (7, 19, 3)
    assert torch.equal(got_sigma, sigma) and torch.equal(got_rgb, rgb)
    # each point its own ray: the same outputs
    flat_sigma, flat_rgb = field.apply(w, pts.reshape(-1, 3), dirs.reshape(-1, 3))
    assert torch.equal(flat_sigma, sigma.reshape(-1)) and torch.equal(flat_rgb, rgb.reshape(-1, 3))


@pytest.mark.parametrize("change", [dict(compute_dtype=torch.float32), dict(sh_degree=3), dict(sh_degree=5),
                                    dict(density_feat_dim=32), dict(color_feat_dim=128), dict(use_kernel=False),
                                    dict(num_level=8), dict(num_level=24)])
def test_prepare_is_the_identity_where_the_kernel_does_not_take_the_config(change):
    field = make_instant_ngp_field(**{**BF16, **change})
    params = field.init(torch.Generator().manual_seed(0))
    assert field.prepare(params) is params


def test_render_image_through_prepare_equals_the_tree_route():
    field, params = field_and_params("hash")
    tree_field = dataclasses.replace(field, prepare=lambda p: p)
    cam = cameras.CameraParams(focal_x=12.0, focal_y=12.0, img_width=10, img_height=9)
    pose = torch.eye(4)
    pose[2, 3] = 1.5
    settings = renderer.RenderSettings(num_samples_coarse=24, num_samples_fine=0, t_near=0.5, t_far=2.5)
    before = ngp_mlp.ngp_mlp_fwd.launches
    img = renderer.render_image(field, params, None, cam, pose, 3, settings, chunk_size=40)
    ref = renderer.render_image(tree_field, params, None, cam, pose, 3, settings, chunk_size=40)
    assert img.shape == (9, 10, 3) and torch.equal(img, ref)
    assert ngp_mlp.ngp_mlp_fwd.launches == before  # the plain version runs on the CPU


def test_a_render_chunk_records_the_fused_span_and_one_launch_a_pass(monkeypatch):
    """A frame whose fused forward counts its launch as the card's does (the
    plain version computes it here)."""
    field, params = field_and_params("hash")
    wrapper = ngp_mlp.ngp_mlp_fwd

    def on_card(w, feats, ray_dirs, samples, is_hdr=False):
        launch_count.count(wrapper, feats.shape[0])
        return ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples, is_hdr)

    monkeypatch.setattr(ngp_mlp, "ngp_mlp_fwd", on_card)
    cam = cameras.CameraParams(focal_x=8.0, focal_y=8.0, img_width=8, img_height=8)
    settings = renderer.RenderSettings(num_samples_coarse=5, num_samples_fine=0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        renderer.render_image(field, params, None, cam, torch.eye(4), 5, settings, chunk_size=32)
    records = tracing.records()
    by_id = {r.id: r for r in records}
    chunks = [r for r in records if r.name == "render.chunk"]
    frame = [r for r in records if r.name == "render.frame"][0]
    assert len(chunks) == 2
    for c in chunks:
        inside = [r.name for r in records if r.unit == c.id]
        assert inside.count("field.fused_mlp") == 1 and inside.count("field.encode") == 1
        assert not {"field.sh", "field.density_mlp", "field.color_in", "field.color_mlp"} & set(inside)
        assert c.attrs["counters"] == {"ngp_mlp_fwd": 1, "points": 32 * 5}
    fused = [r for r in records if r.name == "field.fused_mlp"]
    assert {by_id[r.parent].name for r in fused} == {"render.chunk"}
    # the frame's prepare builds the image once
    assert frame.attrs["counters"]["layout_builds"] == 1
    assert frame.attrs["counters"]["layout_bytes"] == ngp_mlp.IMAGE_BYTES


def test_an_occupancy_sweep_takes_the_fused_route(monkeypatch):
    """``occupancy.make_density_fn`` prepares the field, as a frame does:
    one fused forward a sweep, each cell its own ray, the tree route's
    densities bit for bit."""
    field, params = field_and_params("bricked")
    tree_field = dataclasses.replace(field, prepare=lambda p: p)
    calls, fused = [], ngp_mlp.ngp_mlp_fwd

    def counted(w, feats, ray_dirs, samples, is_hdr=False):
        calls.append((feats.shape[0], samples))
        return fused(w, feats, ray_dirs, samples, is_hdr)

    monkeypatch.setattr(ngp_mlp, "ngp_mlp_fwd", counted)
    pts = torch.rand((6**3, 3), generator=torch.Generator().manual_seed(3)) * 2.0 - 1.0
    got = occupancy.make_density_fn(field)({"coarse": params}, pts)
    assert calls == [(6**3, 1)]
    assert torch.equal(got, occupancy.make_density_fn(tree_field)({"coarse": params}, pts))


def test_the_train_step_never_prepares():
    """Training keeps the differentiable tree route: a step of a field
    whose ``prepare`` raises runs, and gives the tables a gradient."""
    field, _ = field_and_params("hash")

    def refuse(_):
        raise AssertionError("a train step prepared the field")

    field = dataclasses.replace(field, prepare=refuse)
    settings = renderer.RenderSettings(num_samples_coarse=6, num_samples_fine=0)
    optim = train.OptimConfig(num_iter=10, init_lr=1e-2, end_lr=1e-3, eps=1e-15)
    gen = torch.Generator().manual_seed(0)
    state = train.create_train_state(gen, field, settings, optim)
    tables = state.params["coarse"]["tables"].detach().clone()
    step = train.make_ray_train_step(field, settings, optim)
    o, d = torch.zeros(8, 3), torch.nn.functional.normalize(torch.randn(8, 3, generator=gen), dim=-1)
    state, metrics = step(state, o, d, torch.rand(8, 3, generator=gen), renderer.draw_uniforms(gen, 8, settings))
    assert math.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.params["coarse"]["tables"], tables)


def test_weight_image_holds_each_layer_where_the_kernel_reads_it():
    _, params = field_and_params("packed_dual")
    w = ngp_mlp.prepare(params)
    image = w.image
    assert image.dtype == torch.bfloat16 and image.nbytes == ngp_mlp.IMAGE_BYTES == 44720
    offset, bias_at = 0, sum(rows * 128 for *_, rows, _ in ngp_mlp.LAYERS) // 2
    r, c = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    for mlp, name, rows, _ in ngp_mlp.LAYERS:
        assert offset % 1024 == 0  # a 128-byte swizzle panel starts 1024-aligned
        wt, b = (params[mlp][name][k].to(torch.bfloat16) for k in ("w", "b"))
        k, n = wt.shape
        want = torch.zeros(rows, 64, dtype=torch.bfloat16)
        want[:n, :k] = wt.t()
        got = image[(offset + swizzle128(r[:rows], c[:rows])) // 2]
        assert torch.equal(got, want), (mlp, name)
        want_b = torch.zeros(rows, dtype=torch.bfloat16)
        want_b[:n] = b
        assert torch.equal(image[bias_at:bias_at + rows], want_b), (mlp, name)
        offset, bias_at = offset + rows * 128, bias_at + rows
    assert bias_at * 2 == ngp_mlp.IMAGE_BYTES


def acc_row_col(lane, i):
    """Row and column of accumulator ``i`` of thread ``lane`` of a
    warpgroup (``nerf_mlp_train.cuh``'s acc_row, acc_col)."""
    return 16 * (lane >> 5) + ((lane & 31) >> 2) + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)


def fragment_row_col(lane, step, reg, half):
    """Row and column of bf16 ``half`` of A-fragment register ``reg`` of k16
    step ``step`` (``wgmma_ops.cuh``'s note)."""
    g, q = (lane & 31) >> 2, lane & 3
    return 16 * (lane >> 5) + g + 8 * (reg & 1), 16 * step + 8 * (reg >> 1) + 2 * q + half


@pytest.mark.parametrize("n", [64, 16])
def test_accumulator_pairs_are_the_next_layers_a_fragment(n):
    """``to_a`` puts the pair at accumulator i into register (i >> 1) & 3 of
    k16 step i >> 3; the features' and the SH terms' loads fill register
    2h + r with row r0 + 8r, columns 16s + 8h + 2q: the same element as the
    layer's output there."""
    for lane in range(128):
        for i in range(n // 2):
            assert acc_row_col(lane, i) == fragment_row_col(lane, i >> 3, (i >> 1) & 3, i & 1)
        r0, q = 16 * (lane >> 5) + ((lane & 31) >> 2), lane & 3
        for s in range(4):
            for h in range(2):
                for r in range(2):
                    for half in range(2):
                        assert fragment_row_col(lane, s, 2 * h + r, half) == (r0 + 8 * r, 16 * s + 8 * h + 2 * q + half)


def kernel_sh16(x, y, z):
    """``csrc/ngp_mlp_fwd.cu``'s sh16, transcribed in numpy f32 (every
    product and difference rounded alone)."""
    f = np.float32
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    zz4_xx_yy = (f(4) * zz - xx) - yy
    return np.stack([
        np.full_like(x, f(0.28209479177387814)), f(-0.4886025119029199) * y, f(0.4886025119029199) * z,
        f(-0.4886025119029199) * x, f(1.0925484305920792) * xy, f(-1.0925484305920792) * yz,
        f(0.31539156525252005) * ((f(2) * zz - xx) - yy), f(-1.0925484305920792) * xz,
        f(0.5462742152960396) * (xx - yy), (f(-0.5900435899266435) * y) * (f(3) * xx - yy),
        (f(2.890611442640554) * xy) * z, (f(-0.4570457994644658) * y) * zz4_xx_yy,
        (f(0.3731763325901154) * z) * ((f(2) * zz - f(3) * xx) - f(3) * yy),
        (f(-0.4570457994644658) * x) * zz4_xx_yy, (f(1.445305721320277) * z) * (xx - yy),
        (f(-0.5900435899266435) * x) * (xx - f(3) * yy),
    ], axis=-1)


def test_kernel_sh_order_equals_sh_encoding_bit_for_bit():
    dirs = np.random.default_rng(4).normal(size=(4096, 3)).astype(np.float32)
    dirs[:1024] *= np.float32(37.5)  # unnormalised, as the renderer feeds them
    got = kernel_sh16(dirs[:, 0], dirs[:, 1], dirs[:, 2])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, encoders.sh_encoding(torch.from_numpy(dirs), 4).numpy())


def test_rays_of_reads_the_rays_back():
    pts, dirs = ray_points(5, 7)
    ray_dirs, samples = rays_of(dirs)
    assert samples == 7 and torch.equal(ray_dirs, dirs[:, 0]) and ray_dirs.is_contiguous()
    flat = dirs.reshape(-1, 3).contiguous()
    ray_dirs, samples = rays_of(flat)
    assert samples == 1 and torch.equal(ray_dirs, flat)


# ---------------------------------------------------------------------------
# on the card


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernel has no CPU mode")


def card_case(in_dim, rays, samples, seed=2):
    dev = torch.device("cuda")
    layout = "packed_dual" if in_dim == 64 else "hash"
    field = make_instant_ngp_field(**{**BF16, "table_layout": layout})
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = field.init(gen, dev)
    for mlp in ("density_mlp", "color_mlp"):
        for layer in params[mlp].values():
            layer["w"].mul_(math.sqrt(6.0))
    feats = torch.rand((rays * samples, in_dim), generator=gen, device=dev) * 2.0 - 1.0
    ray_dirs = torch.randn((rays, 3), generator=gen, device=dev)
    return field.prepare(params), feats, ray_dirs, samples


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("in_dim,rays,samples", [(32, 4096, 256), (64, 4096, 256), (32, 37, 51), (64, 4099, 1)])
def test_kernel_matches_plain_version_on_the_card(in_dim, rays, samples):
    _require_hopper()
    torch.backends.cuda.matmul.allow_tf32 = False
    w, feats, ray_dirs, samples = card_case(in_dim, rays, samples)
    before = ngp_mlp.ngp_mlp_fwd.launches
    with torch.no_grad():
        sigma, rgb = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples)
        again = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples)
        p_sigma, p_rgb = ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples)
        ref_sigma, ref_rgb = ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ngp_mlp.ngp_mlp_fwd.launches == before + 2
    assert torch.equal(again[0], sigma) and torch.equal(again[1], rgb)
    ref_d = torch.log2(ref_sigma)
    assert rel_l2(torch.log2(sigma), ref_d) <= 2 * rel_l2(torch.log2(p_sigma), ref_d) + 1e-3
    assert rel_l2(rgb, ref_rgb) <= 2 * rel_l2(p_rgb, ref_rgb) + 1e-3


def test_nonfinite_features_come_out_where_the_plain_version_puts_them():
    _require_hopper()
    w, feats, ray_dirs, samples = card_case(32, 64, 33)
    feats[5, 3], feats[1000, 0], feats[-1, -1] = float("nan"), float("inf"), float("-inf")
    with torch.no_grad():
        got = ngp_mlp.ngp_mlp_fwd(w, feats, ray_dirs, samples)
        plain = ngp_mlp.ngp_mlp_reference(w, feats, ray_dirs, samples)
    for a, b in zip(got, plain):
        assert torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.isinf(a), torch.isinf(b))
    assert not torch.isfinite(got[1][5]).any()
