"""The frame loop's compositing kernel (``ops/csrc/composite_fwd.cu``).

On the CPU: ``integration.composite`` takes the kernel only where the frame
loop asks for it (``render_image``, in inference mode), never outside
inference mode (a train step's composite is differentiated); CPU tensors
always take the PyTorch version.

On a Hopper card (skipped elsewhere): the kernel against the PyTorch
composite at the Instant-NGP render cell's shape and at odd shapes, a
relaunch bit-identical, and one launch a chunk of ``render_image``.
"""

import pytest
import torch

from torch_nerf_tpu_torch import cameras, renderer
from torch_nerf_tpu_torch.fields_ngp import make_instant_ngp_field
from torch_nerf_tpu_torch.ops import integration, sampling


def composite_case(rays, samples, seed=0, device="cpu"):
    """sigma spanning empty to opaque samples, t over [2, 6] with the
    renderer's 1e8 last interval, radiance in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sigma = torch.exp(torch.randn((rays, samples), generator=gen, device=device) * 3.0)
    t = torch.sort(2.0 + 4.0 * torch.rand((rays, samples), generator=gen, device=device), dim=-1).values
    radiance = torch.rand((rays, samples, 3), generator=gen, device=device)
    return sigma, radiance, sampling.t_deltas(t)


@pytest.fixture
def calls(monkeypatch):
    """The ``use_kernel`` of every ``integration.composite`` call."""
    seen = []
    plain = integration.composite

    def recording(sigma, radiance, delta, use_kernel=False):
        seen.append(use_kernel)
        return plain(sigma, radiance, delta, use_kernel)

    monkeypatch.setattr(integration, "composite", recording)
    return seen


def tiny_ngp(device="cpu", use_kernel=False):
    field = make_instant_ngp_field(num_level=4, log_max_entry_per_level=10, table_feat_dim=2,
                                   use_kernel=use_kernel)
    params = field.init(torch.Generator(device=device).manual_seed(0), torch.device(device))
    return field, params


def frame(field, params, samples, width, height, chunk_size, device="cpu"):
    settings = renderer.RenderSettings(num_samples_coarse=samples, num_samples_fine=0)
    pose = torch.eye(4, device=device)[:3]
    pose[2, 3] = 4.0
    cam = cameras.CameraParams(float(width), float(width), width, height)
    return renderer.render_image(field, params, None, cam, pose, 3, settings, chunk_size=chunk_size)


def test_the_frame_loop_asks_for_the_kernel_and_render_rays_outside_it_does_not(calls):
    field, params = tiny_ngp()
    img = frame(field, params, 8, 5, 6, 16)
    assert img.shape == (6, 5, 3) and calls == [True, True]

    del calls[:]
    gen = torch.Generator().manual_seed(1)
    origins, dirs = torch.zeros((4, 3)), torch.nn.functional.normalize(torch.randn((4, 3), generator=gen), dim=-1)
    settings = renderer.RenderSettings(num_samples_coarse=8, num_samples_fine=0)
    renderer.render_rays(field, params, None, origins, dirs, gen, settings)
    assert calls == [False]


@pytest.mark.parametrize("rays,samples", [(33, 64), (5, 1), (7, 45)])
def test_cpu_tensors_take_the_pytorch_version(rays, samples):
    sigma, radiance, delta = composite_case(rays, samples)
    before = integration.composite_fwd.launches
    got = integration.composite(sigma, radiance, delta, use_kernel=True)
    want = integration.composite(sigma, radiance, delta)
    assert integration.composite_fwd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_kernel_wrapper_raises_on_cpu_tensors():
    sigma, radiance, delta = composite_case(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        integration.composite_fwd(sigma, radiance, delta)


# ---------------------------------------------------------------------------
# on the card


def _require_hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA card of compute capability 9.0 (Hopper); the kernel has no CPU mode")


@pytest.mark.parametrize("rays,samples", [(4096, 256), (4096, 192), (37, 51), (1, 1), (3, 33)])
def test_kernel_matches_the_pytorch_composite_on_the_card(rays, samples):
    """Only the order of the f32 sums differs (the exclusive sum by rounds
    of 32 samples, rgb by lanes): the weights and rgb lie in [0, 1], so 1e-5
    is ~80 ulps at 1 and far under any change to the quadrature."""
    _require_hopper()
    sigma, radiance, delta = composite_case(rays, samples, seed=rays + samples, device="cuda")
    before = integration.composite_fwd.launches
    rgb, weights = integration.composite(sigma, radiance, delta, use_kernel=True)
    again = integration.composite_fwd(sigma, radiance, delta)
    want_rgb, want_weights = integration.composite(sigma, radiance, delta)
    torch.cuda.synchronize()
    assert integration.composite_fwd.launches == before + 2
    assert torch.equal(again[0], rgb) and torch.equal(again[1], weights)
    assert (rgb - want_rgb).abs().max().item() <= 1e-5
    assert (weights - want_weights).abs().max().item() <= 1e-5


def test_render_image_launches_the_kernel_once_a_chunk_on_the_card(monkeypatch):
    """600 pixels in chunks of 128: five launches, and the frame the
    PyTorch composite gives within the kernel test's 1e-5."""
    _require_hopper()
    field, params = tiny_ngp("cuda", use_kernel=True)
    before = integration.composite_fwd.launches
    img = frame(field, params, 64, 30, 20, 128, device="cuda")
    assert integration.composite_fwd.launches == before + 5
    plain = integration.composite
    monkeypatch.setattr(integration, "composite", lambda s, r, d, use_kernel=False: plain(s, r, d))
    want = frame(field, params, 64, 30, 20, 128, device="cuda")
    assert integration.composite_fwd.launches == before + 5
    assert (img - want).abs().max().item() <= 1e-5
