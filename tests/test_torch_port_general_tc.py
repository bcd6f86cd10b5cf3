"""The tensor-core general route of kernels 1-3 (``csrc/nerf_mlp_tc.cuh``:
``wgmma_general`` in bf16 and ``f32_wgmma`` in f32 up to width 1024;
its column passes at the widths the mma.sync engine held:
``test_torch_port_wide_tc.py``).

The kernels run only on a Hopper card; here the Python side of their
contract is held on the CPU: the three bf16 pieces of the f32 weights (each
a bf16 value, their sum the weight exactly), the swizzled panel images
against a plain loop index for index, the Python twin of the engine's
shared-memory cut (``tc_stages``) against the sizes worked out by hand, a
plain walk over ``tc_matrices`` in the kernels' steps (forward, chain with
its masks and the input-grad products) against the plain f64 version, and
an emulation of the f32 products through the plain forward and backward at
width 64: three bf16 pieces and 8 products within the f32 route's limit
(2x the plain f32 version's error against f64 + 1e-5), one TF32 product
far outside it, and 3xTF32 (two TF32 pieces) between the two. Inputs come
from a seeded numpy generator. The route table by config is
``test_torch_port_general.py::test_forward_and_train_routes_by_config``.
Tolerances: the walk 1e-9 in f64 (f32 weights, bf16 weights exactly
representable), since it repeats the plain version's sums in another
grouping.
"""

import math

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf


def _cfg(feat=256, level=10, dtype=torch.float32, dir_level=4):
    return fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                      compute_dtype=dtype)


def _params(cfg, seed=0):
    """Seeded port-init weights with the He gain (every layer matters)."""
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg.pos_enc_dim, cfg.dir_enc_dim, cfg.feat_dim)
    return {n: {"w": v["w"] * 6**0.5, "b": v["b"]} for n, v in params.items()}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-2, 2, size=(n, 3)).astype(np.float32))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    g_sigma = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    return pts, dirs, g_sigma, g_rgb


def _unimage(image, rows, cols, pieces):
    """The inverse of ``tc_panel_image``: ``pieces`` (rows, cols) bf16
    matrices, read back by the swizzle function."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(64)[None, :]
    index = (fused_nerf.swizzle128(r, c) // 2).reshape(-1)
    slices = image.reshape(cols // 64, pieces, rows * 64)
    return [slices[:, i][:, index].reshape(cols // 64, rows, 64).permute(1, 0, 2).reshape(rows, cols)
            for i in range(pieces)]


# ---------------------------------------------------------------------------
# the f32 weights' pieces and the panel images


@pytest.mark.parametrize("feat,level", [(64, 10), (256, 10), (192, 12)])
def test_three_bf16_pieces_are_the_f32_weights(feat, level):
    cfg = _cfg(feat, level)
    forward, chain = fused_nerf.tc_matrices(_params(cfg), cfg)
    images, _, chain_images = fused_nerf.tc_layout(_params(cfg), cfg)
    for mat, image in zip(forward + chain, images + chain_images):
        assert image.dtype == torch.bfloat16 and image.numel() == 3 * mat.numel()
        pieces = _unimage(image, mat.shape[0], mat.shape[1], 3)
        # each piece a bf16 value (the low 16 bits of its f32 pattern zero)
        for piece in pieces:
            assert ((piece.float().view(torch.int32) & 0xFFFF) == 0).all()
        assert torch.equal(sum(p.double() for p in pieces), mat.double())
        # stored smallest first; each within half an ulp of the next: x1
        # within 2^-8 of x0
        x0, x1 = pieces[2].float().abs(), pieces[1].float().abs()
        assert (x1 <= x0 * 2.0**-8).all()


@pytest.mark.parametrize("feat,level,dtype,layer", [
    (512, 10, torch.bfloat16, "fc_1"), (512, 12, torch.bfloat16, "fc_5"), (256, 10, torch.float32, "fc_8"),
    (64, 12, torch.float32, "fc_in"), (192, 11, torch.float32, "fc_9"),
])
def test_panel_images_equal_a_plain_loop(feat, level, dtype, layer):
    # level 12: an 80-wide (75 padded to 16) encoding, padded to 128 columns
    cfg = _cfg(feat, level, dtype)
    params = _params(cfg)
    forward, _ = fused_nerf.tc_matrices(params, cfg)
    images, _, _ = fused_nerf.tc_layout(params, cfg)
    i = LAYER_NAMES.index(layer)
    mat, image = forward[i], images[i].view(torch.int16).numpy()
    rows, cols = mat.shape
    pieces = fused_nerf.bf16_pieces(mat)[::-1] if dtype == torch.float32 else (mat,)
    pieces = [p.view(torch.int16).numpy() for p in pieces]
    slice_elems = rows * 64
    for s in range(cols // 64):
        for k, piece in enumerate(pieces):
            base = (s * len(pieces) + k) * slice_elems
            for r in range(rows):
                for j in range(8):
                    at = base + r * 64 + (j ^ (r % 8)) * 8
                    np.testing.assert_array_equal(image[at:at + 8], piece[r, 64 * s + 8 * j:64 * s + 8 * j + 8])


def test_matrices_put_the_encodings_last_and_pad_to_slices():
    cfg = _cfg(512, 12, torch.bfloat16)
    params = _params(cfg)
    forward, chain = fused_nerf.tc_matrices(params, cfg)
    p = cfg.pos_enc_dim
    w5 = params["fc_5"]["w"].to(torch.bfloat16)
    # fc_5's inputs [h4, pe]: the 75-wide pe padded to 128
    assert forward[5].shape == (512, 512 + 128)
    assert torch.equal(forward[5][:, :512], w5[p:].t()) and torch.equal(forward[5][:, 512:512 + p], w5[:p].t())
    assert not forward[5][:, 512 + p:].any()
    # fc_8's sigma at row F; fc_out 8 rows over F/2 inputs padded to 64
    assert forward[8].shape == (520, 512) and torch.equal(forward[8][512], params["fc_8"]["w"][:, 0].bfloat16())
    assert forward[10].shape == (8, 256)
    # chain: fc_8 with sigma at column F, the input-grad rows padded to 128
    assert chain[8].shape == (512, 576) and torch.equal(chain[8][:, 512], params["fc_8"]["w"][:, 0].bfloat16())
    assert [chain[i].shape for i in (0, 11, 12)] == [(128, 512), (128, 512), (128, 256)]


# ---------------------------------------------------------------------------
# the shared-memory cut


@pytest.mark.parametrize("feat,level,dir_level,dtype,stages", [
    # path B: tiles 64 + 16 + 8 KB, fc_8's stage 520 x 128 B: 2 deep
    (512, 12, 4, torch.bfloat16, (2, 2, 2)),
    # path A: tiles 64 + 16 + 8 KB (f32 panels of 32 columns), stages 264
    # and 256 rows of one bf16 piece image: 4 deep
    (256, 10, 4, torch.float32, (4, 4, 4)),
    (64, 12, 4, torch.bfloat16, (4, 4, 4)),
    (512, 20, 4, torch.bfloat16, (2, 2, 2)),
    (256, 20, 4, torch.float32, (3, 4, 4)),
    # two column passes of 96 (one tile for both encodings): stages of 200
    # and 192 rows
    (384, 12, 12, torch.bfloat16, (4, 4, 4)),
    # both encodings two panels at 512: two passes of 128
    (512, 12, 12, torch.bfloat16, (4, 4, 4)),
    # three passes of 96; one pass of 48 (96 ends on a half K-slice)
    (576, 10, 4, torch.bfloat16, (4, 4, 4)),
    # f32 at 320: two passes of 80 (one tile for both encodings)
    (320, 10, 4, torch.float32, (4, 4, 4)),
    (96, 10, 4, torch.bfloat16, (4, 4, 4)),
])
def test_shared_memory_cut_by_config(feat, level, dir_level, dtype, stages):
    cfg = _cfg(feat, level, dtype, dir_level)
    assert fused_nerf.tc_stages(cfg) == stages
    if stages is not None:
        pc = fused_nerf.panel_cols(dtype)
        plan = fused_nerf.tc_plan(cfg)
        pe, de = -(-cfg.pos_enc_dim // pc), -(-cfg.dir_enc_dim // pc)
        shared = plan.passes > 1 or (dtype == torch.bfloat16 and 96 <= plan.np <= 128)
        tiles = (-(-feat // pc) + (max(pe, de) if shared else pe + de)) * 64 * 128
        stage = (2 * plan.np + 8) * 128  # a pass of fc_8: the forward's widest stage
        used = 1024 + 64 + tiles + stages[0] * stage
        block = 232_448 if plan.ctas == 1 else 233_472 // 2 - 1024
        assert used <= block < used + stage or stages[0] == 4


# ---------------------------------------------------------------------------
# a plain walk over the matrices in the kernels' steps


def _padc(x, cols):
    return torch.nn.functional.pad(x, (0, cols - x.shape[1]))


def _walk(params, cfg, pts, dirs, g_sigma, g_rgb):
    """The forward and the chain as the kernels take the matrices of
    ``tc_matrices``, in f64: ``(sigma, rgb, dz by layer, dpe, dde)``."""
    f = fused_nerf.padded_config(cfg).feat_dim
    forward, chain = fused_nerf.tc_matrices(params, cfg)
    fw = [m.double() for m in forward]
    ch = [m.double() for m in chain]
    bias = [b.double() for b in fused_nerf.general_biases(params, cfg)]
    pe = encoders.positional_encoding(pts.double(), cfg.coord_encode_level, cfg.include_input)
    de = encoders.positional_encoding(dirs.double(), cfg.dir_encode_level, cfg.include_input)
    pe, de = _padc(pe, -(-pe.shape[1] // 64) * 64), _padc(de, -(-de.shape[1] // 64) * 64)
    acts, h = [], pe
    for l in range(8):
        h = torch.relu((torch.cat([h, pe], 1) if l == 5 else h) @ fw[l].t() + bias[l])
        acts.append(h)
    z8 = h @ fw[8].t() + bias[8]
    sigma = torch.relu(z8[:, f])
    h9 = torch.relu(torch.cat([z8[:, :f], de], 1) @ fw[9].t() + bias[9])
    rgb = torch.sigmoid((_padc(h9, fw[10].shape[1]) @ fw[10].t() + bias[10])[:, :3])
    # the chain
    dz = {10: _padc((g_rgb.double() * rgb * (1 - rgb)), 64)}
    dz[9] = torch.where(h9 > 0, dz[10] @ ch[10].t(), 0.0)
    dz9 = _padc(dz[9], ch[9].shape[1])
    dfeat = dz9 @ ch[9].t()
    dde = (dz9 @ ch[12].t())[:, :cfg.dir_enc_dim]
    dsig = torch.where(sigma > 0, g_sigma.double(), 0.0)
    dz[8] = torch.cat([dfeat, _padc(dsig[:, None], 64)], 1)
    dh = dz[8] @ ch[8].t()
    dpe = None
    for l in range(7, -1, -1):  # dz of fc_l = dh masked by the relu of h_l
        dz[l] = torch.where(acts[l] > 0, dh, 0.0)
        if l >= 1:
            dh = dz[l] @ ch[l].t()
        if l == 5:
            dpe = (dz[l] @ ch[11].t())[:, :cfg.pos_enc_dim]
    dpe = dpe + (dz[0] @ ch[0].t())[:, :cfg.pos_enc_dim]
    return sigma, rgb, dz, dpe, dde


@pytest.mark.parametrize("feat,level,dtype", [(64, 10, torch.float32), (192, 12, torch.bfloat16),
                                              (48, 11, torch.bfloat16)])
def test_walk_over_the_matrices_is_the_plain_version(feat, level, dtype):
    cfg = _cfg(feat, level, dtype)
    params = _params(cfg)
    pts, dirs, g_sigma, g_rgb = _data(40, 7)
    sigma, rgb, dz, dpe, dde = _walk(params, cfg, pts, dirs, g_sigma, g_rgb)
    # the plain version in f64 on the same (bf16-rounded) weights
    exact = {n: {k: v.to(dtype).double() for k, v in p.items()} for n, p in params.items()}
    cfg64 = _cfg(feat, level, torch.float64)
    acts = fused_nerf.forward_activations(exact, pts.double(), dirs.double(), cfg64)
    _, ref_dpe, ref_dde = fused_nerf.backward_from_activations(exact, acts, g_sigma.double(), g_rgb.double(), cfg64)
    assert float(acts["sigma"].max()) > 0
    torch.testing.assert_close(sigma, acts["sigma"], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(rgb, acts["rgb"], rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dpe, ref_dpe, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(dde, ref_dde, rtol=1e-9, atol=1e-9)
    # a padded width's extra units are zero in every dz
    assert not any(dz[l][:, feat:fused_nerf.padded_config(cfg).feat_dim].any() for l in range(8))


# ---------------------------------------------------------------------------
# the f32 products emulated through the plain forward and backward


def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, scheme):
    """``a @ b`` of f32 operands as the card computes it under ``scheme``,
    the products exact and summed in f64, rounded once to f32."""
    if scheme == "tf32":
        return (_tf32(a).double() @ _tf32(b).double()).float()
    if scheme == "3xtf32":
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return (ah.double() @ bh.double() + al.double() @ bh.double() + ah.double() @ bl.double()).float()
    pa = [p.double() for p in fused_nerf.bf16_pieces(a.contiguous())]
    pb = [p.double() for p in fused_nerf.bf16_pieces(b.contiguous())]
    return sum(pa[i] @ pb[j] for i in range(3) for j in range(3) if i + j <= 3).float()


class _Products(TorchFunctionMode):
    """Every f32 matrix product under ``scheme`` (the rest as it is)."""

    def __init__(self, scheme):
        super().__init__()
        self.scheme = scheme

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.__matmul__) and args[0].dtype == torch.float32:
            return _product(args[0], args[1], self.scheme)
        return func(*args, **(kwargs or {}))


def _outputs(params, pts, dirs, g_sigma, g_rgb, cfg):
    sigma, rgb = fused_nerf.fused_nerf_apply_reference(params, pts, dirs, cfg)
    grads, dpts, ddirs = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    out = {f"{n}.{k}": v for n, p in grads.items() for k, v in p.items()}
    out.update(dpts=dpts, ddirs=ddirs)
    return sigma, rgb, out


def _errors(got, ref):
    """sigma, rgb: max-abs; each grad, dpts, ddirs: relative L2."""
    (s, c, g), (rs, rc, rg) = got, ref
    err = {"sigma": (s.double() - rs).abs().max().item(), "rgb": (c.double() - rc).abs().max().item()}
    err.update({k: ((g[k].double() - rg[k]).norm() / rg[k].norm()).item() for k in rg})
    return err


@pytest.fixture(scope="module")
def emulated():
    cfg = _cfg(64, 10, torch.float32)
    params = _params(cfg, seed=2)
    pts, dirs, g_sigma, g_rgb = _data(512, 5)
    double = {n: {k: v.double() for k, v in p.items()} for n, p in params.items()}
    ref = _outputs(double, pts.double(), dirs.double(), g_sigma.double(), g_rgb.double(), _cfg(64, 10, torch.float64))
    plain = _errors(_outputs(params, pts, dirs, g_sigma, g_rgb, cfg), ref)
    limit = {k: 2.0 * v + 1e-5 for k, v in plain.items()}
    errors = {}
    for scheme in ("bf16x8", "3xtf32", "tf32"):
        with _Products(scheme):
            errors[scheme] = _errors(_outputs(params, pts, dirs, g_sigma, g_rgb, cfg), ref)
    return errors, limit, ref


def test_three_bf16_pieces_meet_the_f32_limit(emulated):
    errors, limit, ref = emulated
    assert float(ref[0].max()) > 0 and float(ref[1].std()) > 0
    over = {k: (v, limit[k]) for k, v in errors["bf16x8"].items() if not v <= limit[k]}
    assert not over


def test_one_tf32_product_fails_the_f32_limit(emulated):
    errors, limit, _ = emulated
    assert sum(errors["tf32"][k] > limit[k] for k in limit) >= len(limit) // 2
    assert errors["tf32"]["sigma"] > 10 * limit["sigma"]


def test_3xtf32_sits_between_one_tf32_product_and_three_bf16_pieces(emulated):
    errors, _, _ = emulated
    for k in ("sigma", "rgb", "fc_1.w", "dpts"):
        assert errors["bf16x8"][k] < errors["3xtf32"][k] < errors["tf32"][k], k
    assert math.isfinite(errors["3xtf32"]["sigma"])
