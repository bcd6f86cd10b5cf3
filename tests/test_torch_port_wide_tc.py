"""The tensor-core general route at every bf16 width (``csrc/nerf_mlp_tc.cuh``
with column passes: ``wgmma_general`` from width 32 to 1024, widths off the
64s without padding to them, encodings up to 128 wide).

The kernels run only on a Hopper card; here the Python side of their
contract is held on the CPU: the plan's Python twin (``tc_plan``: pass
width, passes, each kernel's ring stages and shared memory, a consumer
thread's registers) against the sizes worked out by hand and at every
padded bf16 width with encodings 27 to 128 wide; the pass-major panel
images, a half K-slice included, against a plain loop, with zeros past the
real rows and columns; a plain f64 walk over ``tc_matrices`` in the
kernels' order (each pass's rows, each K-slice read for its k16 steps from
tiles whose columns past the real ones hold NaN, a layer's outputs written
only after its last pass) against ``forward_activations`` and
``backward_from_activations``; and the port's field against the JAX
package's ``fused_nerf_apply`` (the Pallas kernel in interpret mode) in bf16
at a width off the 64s and one past 512. Inputs come from a seeded numpy
generator. Tolerances: the walk 1e-9 in f64 (bf16 weights exactly
representable; the same sums in another grouping); bf16 against JAX atol
2e-2, the bound of the other bf16 parity tests (each layer rounds to bf16,
a tie may break one ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu.ops.pallas.fused_nerf import FusedNeRFConfig as JaxFusedConfig
from torch_nerf_tpu.ops.pallas.fused_nerf import fused_nerf_apply as jax_fused_nerf_apply
from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params, params_to_jax
from torch_nerf_tpu_torch.ops import fused_nerf

SMEM = 232_448


def _cfg(feat, level=10, dir_level=4, dtype=torch.bfloat16):
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


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("feat,level,dir_level,dtype,want", [
    # 96: one pass of 48, two CTAs an SM; tiles 2 + 1 + 1 panels (32 KB:
    # a pass's kernel keeps a tile an encoding); fc_8's stage 104 rows
    # (13,312 B), 4 deep: 1088 + 32,768 + 53,248 <= half an SM's 115,712;
    # the chain's 96 rows, 128 with the input grads
    (96, 10, 4, torch.bfloat16, (48, 1, (4, 4, 4), (87_104, 74_816, 91_200), 1, 2, 24, 0)),
    # 160: one pass of 80, two CTAs; the trunk ends on a half K-slice (160 =
    # 128 + 32); fc_8's stage 168 rows (21,504 B): (115,712 - 1,088 -
    # 40,960) // 21,504 = 3; the chain with input grads one CTA, 4 stages
    (160, 10, 4, torch.bfloat16, (80, 1, (3, 3, 4), (106_560, 95_296, 115_776), 2, 2, 40, 0)),
    # 320: two passes of 96 (384 columns: the passes' floor of 96), one CTA
    (320, 10, 4, torch.bfloat16, (96, 2, (4, 4, 4), (160_832, 156_736, 156_736), 4, 1, 48, 24)),
    # 576: three passes of 96 (2 x 96 x 3 = 576); 9 + 1 panels; stages of
    # 200 and 192 rows; two passes' outputs held, 2 x 24 registers
    (576, 10, 4, torch.bfloat16, (96, 3, (4, 4, 4), (185_408, 181_312, 181_312), 6, 1, 48, 48)),
    # 1024: four passes of 128; the activation tile 128 KB, 16 + 1 panels
    # (several passes: one tile for both encodings); fc_8's stage 264 rows
    # (33,792 B): (232,448 - 1,088 - 139,264) // 33,792 = 2; three passes'
    # outputs held, 96 registers beside 64
    (1024, 10, 4, torch.bfloat16, (128, 4, (2, 2, 2), (207_936, 205_888, 205_888), 8, 1, 64, 96)),
    # both encodings 123 wide share one tile of 2 panels: 18 panels
    (1024, 20, 20, torch.bfloat16, (128, 4, (2, 2, 2), (216_128, 205_888, 205_888), 8, 1, 64, 96)),
    # 512 with both encodings two panels wide: one pass of 256 beside 8 + 2
    # + 2 panels gets one stage of fc_8's 520 rows, so two passes of 128
    # (one encoding tile), four stages
    (512, 20, 20, torch.bfloat16, (128, 2, (4, 4, 4), (218_176, 205_888, 205_888), 4, 1, 64, 32)),
    # path B as it was: one pass of 256, 8 + 2 + 1 panels
    (512, 12, 4, torch.bfloat16, (256, 1, (2, 2, 2), (224_320, 205_888, 205_888), 4, 1, 128, 0)),
    # 384: two passes of 96 (the engine's 192-column pass is gone)
    (384, 12, 12, torch.bfloat16, (96, 2, (4, 4, 4), (169_024, 156_736, 156_736), 4, 1, 48, 24)),
    # path A, f32: one pass of 128, f32 panels of 32 columns, 8 + 2 + 1
    # panels; product_f32 sums a slice in a second accumulator
    (256, 10, 4, torch.float32, (128, 1, (4, 4, 4), (226_368, 205_888, 205_888), 2, 1, 128, 0)),
])
def test_plan_by_config(feat, level, dir_level, dtype, want):
    plan = fused_nerf.tc_plan(_cfg(feat, level, dir_level, dtype))
    assert (plan.np, plan.passes, plan.stages, plan.smem_bytes, plan.bit_words, plan.ctas, plan.acc_registers,
            plan.held_registers) == want
    assert fused_nerf.tc_stages(_cfg(feat, level, dir_level, dtype)) == want[2]


@pytest.mark.parametrize("feat,level,kernel_1,train", [(512, 12, (128, 2), (256, 1)), (480, 10, (128, 2), (256, 1)),
                                                       (1024, 10, (128, 4), (128, 4)), (96, 10, (48, 1), (48, 1))])
def test_kernel_1_takes_two_passes_of_128_where_kernels_2_3_take_one_of_256(feat, level, kernel_1, train):
    """Kernel 1 (the forward alone) at its own passes; its forward images
    (``kernel_weights``) laid out by them, the same matrices' values."""
    cfg = _cfg(feat, level)
    alone, plan = fused_nerf.tc_plan(cfg, stash=False), fused_nerf.tc_plan(cfg)
    assert (alone.np, alone.passes) == kernel_1 and (plan.np, plan.passes) == train
    params = _params(cfg)
    weights = fused_nerf.kernel_weights(params, cfg, "wgmma_general").weights
    mats = fused_nerf.tc_matrices(params, cfg, stash=False)[0]
    assert all(torch.equal(a, b) for a, b in zip(weights, fused_nerf.tc_images(
        mats, fused_nerf.tc_pass_rows(cfg, stash=False)[0])))
    for i in (1, 5, 9):  # the trunk, the skip and fc_9 are the same matrices at either passes
        assert torch.equal(mats[i], fused_nerf.tc_matrices(params, cfg)[0][i])


@pytest.mark.parametrize("feat,dtype", [(1056, torch.float32), (2048, torch.float32), (1056, torch.bfloat16)])
def test_plan_refuses_what_the_engine_does_not_hold(feat, dtype):
    # past 1024 nothing, in either type (f32 takes every width up to it)
    assert fused_nerf.tc_plan(_cfg(feat, dtype=dtype)) is None


def test_every_bf16_width_and_encoding_fits_two_stages():
    """Every padded bf16 width 32..1024 at encodings 27..128 wide: a plan
    whose three kernels each fit a block's 232,448 bytes (two CTAs an SM:
    115,712 each, the chain with input grads one CTA) with a ring of at
    least two stages, its passes cover the width, and a consumer thread's
    sums and held outputs leave room in its 232 registers (two CTAs: 96)."""
    seen = set()
    for feat in range(32, 1025, 32):
        for level in (4, 10, 12, 20):
            for dir_level in (4, 10, 20):
                cfg = _cfg(feat, level, dir_level)
                plan = fused_nerf.tc_plan(cfg)
                assert plan is not None, cfg
                block = SMEM if plan.ctas == 1 else 233_472 // 2 - 1024
                assert min(plan.stages) >= 2 and max(plan.smem_bytes[:2]) <= block, cfg
                assert plan.smem_bytes[2] <= SMEM, cfg
                assert plan.passes <= 4 and plan.np % 16 == 0 and (plan.passes == 1 or 96 <= plan.np <= 128), cfg
                assert (plan.ctas == 2) == (plan.np <= 80), cfg
                # each pass's columns rounded up to 16 a warpgroup, and to
                # at least 96 where a layer takes several passes
                assert feat <= 2 * plan.np * plan.passes <= max(feat + 32 * plan.passes,
                                                                192 * plan.passes if plan.passes > 1 else 0), cfg
                assert plan.acc_registers + plan.held_registers <= (40 if plan.ctas == 2 else 160), cfg
                if feat not in (64, 128, 256) or max(cfg.pos_enc_dim, cfg.dir_enc_dim) > 64:
                    assert fused_nerf.forward_route(cfg) == "wgmma_general"
                seen.add((plan.np, plan.passes))
    # the pass widths the kernels are built at
    assert {np_ for np_, _ in seen} == {16, 32, 48, 64, 80, 96, 112, 128, 256}


# ---------------------------------------------------------------------------
# the pass-major images


@pytest.mark.parametrize("feat,level,which,layer", [
    (96, 10, "forward", "fc_2"), (96, 10, "chain", "fc_8"), (160, 12, "forward", "fc_5"),
    (576, 10, "forward", "fc_8"), (576, 10, "chain", "fc_out"), (576, 10, "forward", "fc_9"),
])
def test_pass_major_images_equal_a_plain_loop(feat, level, which, layer):
    cfg = _cfg(feat, level)
    params = _params(cfg)
    mats = fused_nerf.tc_matrices(params, cfg)[which == "chain"]
    images = fused_nerf.tc_layout(params, cfg)[2 if which == "chain" else 0]
    i = LAYER_NAMES.index(layer)
    rows = fused_nerf.tc_pass_rows(cfg)[which == "chain"][i]
    mat, image = mats[i].view(torch.int16).numpy(), images[i].view(torch.int16).numpy()
    total, cols = mat.shape
    assert image.size == mat.size and total % rows == 0 and cols % 64 == 0
    k = 0
    for p in range(total // rows):  # pass after pass, each K-slice after K-slice
        for s in range(cols // 64):
            for r in range(rows):
                for j in range(8):
                    at = k + r * 64 + (j ^ (r % 8)) * 8
                    np.testing.assert_array_equal(image[at:at + 8], mat[p * rows + r, 64 * s + 8 * j:64 * s + 8 * j + 8])
            k += rows * 64


@pytest.mark.parametrize("feat", [96, 160, 352])
def test_matrices_are_zero_past_the_width(feat):
    # F off the 64s: every K segment padded to 64 columns, the rows of the
    # last pass past F zero (352: two passes of 96 cover 384 rows)
    cfg = _cfg(feat)
    params = _params(cfg)
    forward, chain = fused_nerf.tc_matrices(params, cfg)
    plan = fused_nerf.tc_plan(cfg)
    kp = -(-feat // 64) * 64
    for i in (1, 2, 3, 4, 6, 7):
        assert forward[i].shape == (2 * plan.np * plan.passes, kp)
        assert not forward[i][feat:].any() and not forward[i][:, feat:].any()
        assert not chain[i][feat:].any() and not chain[i][:, feat:].any()
        assert torch.equal(forward[i][:feat, :feat], params[LAYER_NAMES[i]]["w"].t().bfloat16())
    # fc_5's pe after h4's padded slices; fc_8's sigma first in the slice
    # after the features'
    p = cfg.pos_enc_dim
    assert torch.equal(forward[5][:feat, kp:kp + p], params["fc_5"]["w"][:p].t().bfloat16())
    assert torch.equal(chain[8][:feat, kp], params["fc_8"]["w"][:, 0].bfloat16())
    assert not chain[8][:, feat:kp].any() and not chain[8][:, kp + 1:].any()


# ---------------------------------------------------------------------------
# a plain walk over the matrices in the kernels' pass order


def _steps(cols):
    """K-slices of a K of ``cols`` columns and the k16 steps of the last."""
    n = -(-cols // 64)
    return n, -(-(cols - 64 * (n - 1)) // 16)


def _tile(x, cols_total):
    """A tile of ``cols_total`` columns holding x, NaN past it: a read past
    the columns a product takes shows in every sum."""
    t = torch.full((x.shape[0], cols_total), float("nan"), dtype=torch.float64)
    t[:, :x.shape[1]] = x
    return t


def _product(segments, mat, rows):
    """The tile segments ``[(tile, cols)]`` times image rows ``rows`` of
    ``mat`` as the kernel reads them: each segment's K-slices from the
    image's K offset (segments padded to 64), the last for its k16 steps."""
    out, k0 = 0.0, 0
    for tile, cols in segments:
        n, last = _steps(cols)
        for s in range(n):
            ks = 16 * (last if s == n - 1 else 4)
            out = out + tile[:, 64 * s:64 * s + ks] @ mat[rows, k0 + 64 * s:k0 + 64 * s + ks].t()
        k0 += 64 * n
    return out


def _layer(segments, mat, n, np_, width, block=None, epi=lambda c, v: v):
    """One layer in passes: pass p's rows of each warpgroup w (columns (2p
    + w) np_ ..), ``block`` image rows a pass (default 2 np_), the outputs
    at or past ``width`` dropped; all of it returned only after the last
    pass (the kernel holds the earlier passes' outputs)."""
    block = block or 2 * np_
    held = []
    for p in range(n):
        for w in (0, 1):
            r0 = p * block + w * np_
            c0 = (2 * p + w) * np_
            keep = max(0, min(np_, width - c0))
            if keep:
                cols = torch.arange(c0, c0 + keep)
                held.append((cols, epi(cols, _product(segments, mat, slice(r0, r0 + keep)))))
    return held


def _write(tile, held):
    tile = tile.clone()
    for cols, v in held:
        tile[:, cols] = v
    return tile


def _walk(params, cfg, pts, dirs, g_sigma, g_rgb, stash=True):
    """The forward and the chain in the kernels' order over tc_matrices (at
    kernel 1's passes where ``stash`` is False), in f64: ``(sigma, rgb,
    relu outputs by layer, dpe, dde)``."""
    plan = fused_nerf.tc_plan(cfg, stash)
    n, np_ = plan.passes, plan.np
    f = fused_nerf.padded_config(cfg).feat_dim
    kp = -(-f // 64) * 64
    forward, chain = fused_nerf.tc_matrices(params, cfg, stash)
    fw = [m.double() for m in forward]
    ch = [m.double() for m in chain]
    bias = [b.double() for b in fused_nerf.general_biases(params, cfg)]
    pe_dim, de_dim = cfg.pos_enc_dim, cfg.dir_enc_dim
    pe = encoders.positional_encoding(pts.double(), cfg.coord_encode_level, cfg.include_input)
    de = encoders.positional_encoding(dirs.double(), cfg.dir_encode_level, cfg.include_input)
    # the encode zeroes its tile past the encoding, to the panel's end
    enc = torch.nn.functional.pad(pe, (0, -(-pe_dim // 64) * 64 - pe_dim))
    act = torch.full((pts.shape[0], kp), float("nan"), dtype=torch.float64)
    acts = []

    def relu(b):
        return lambda cols, v: torch.relu(v + b[cols])

    for l in range(8):
        segs = [(enc, pe_dim)] if l == 0 else [(act, f)] + ([(enc, pe_dim)] if l == 5 else [])
        held = _layer(segs, fw[l], n, np_, f, epi=relu(bias[l]))
        if l == 5:  # fc_5 was pe's last reader: de takes its tile
            enc = torch.nn.functional.pad(de, (0, -(-de_dim // 64) * 64 - de_dim))
        act = _write(act, held)
        acts.append(act[:, :f])
    sigma = torch.relu(_product([(act, f)], fw[8], slice(2 * np_, 2 * np_ + 1))[:, 0] + bias[8][f])
    act = _write(act, _layer([(act, f)], fw[8], n, np_, f, block=2 * np_ + 8,
                             epi=lambda cols, v: v + bias[8][cols]))
    act = _write(act, _layer([(act, f), (enc, de_dim)], fw[9], n, np_ // 2, f // 2, block=np_, epi=relu(bias[9])))
    h9 = act[:, :f // 2]
    rgb = torch.sigmoid(_product([(act, f // 2)], fw[10], slice(0, 3)) + bias[10][:3])

    # the chain: dz_out in x's columns 0..2 of a 16-column step, NaN past
    # the panel's 64 columns is never read either
    x = _tile(torch.nn.functional.pad(g_rgb.double() * rgb * (1 - rgb), (0, 13)), 64)
    dz = torch.full_like(act, float("nan"))
    dz = _write(dz, _layer([(x, 16)], ch[10], n, np_ // 2, f // 2, block=np_,
                           epi=lambda cols, v: torch.where(h9[:, cols] > 0, v, 0.0)))
    dde = _product([(dz, f // 2)], ch[12], slice(0, 128))[:, :de_dim]
    dz = _write(dz, _layer([(dz, f // 2)], ch[9], n, np_, f))
    x = _tile(torch.nn.functional.pad(torch.where(sigma > 0, g_sigma.double(), 0.0)[:, None], (0, 15)), 64)
    dpe = None
    for l in range(8, 0, -1):
        segs = [(dz, f)] + ([(x, 16)] if l == 8 else [])
        if l == 5:
            dpe = _product(segs, ch[11], slice(0, 128))[:, :pe_dim]
        below = acts[l - 1]
        dz = _write(dz, _layer(segs, ch[l], n, np_, f,
                               epi=lambda cols, v, h=below: torch.where(h[:, cols] > 0, v, 0.0)))
    dpe = dpe + _product([(dz, f)], ch[0], slice(0, 128))[:, :pe_dim]
    return sigma, rgb, acts, dpe, dde


# weight seeds whose sigma is positive at some of the points; 512 at kernel
# 1's two passes of 128
@pytest.mark.parametrize("feat,level,dir_level,seed,stash", [(96, 10, 4, 0, True), (160, 12, 4, 160, True),
                                                             (576, 10, 12, 0, True), (512, 12, 4, 0, False)])
def test_walk_in_pass_order_is_the_plain_version(feat, level, dir_level, seed, stash):
    cfg = _cfg(feat, level, dir_level)
    params = _params(cfg, seed)
    pts, dirs, g_sigma, g_rgb = _data(24, 3)
    sigma, rgb, acts, dpe, dde = _walk(params, cfg, pts, dirs, g_sigma, g_rgb, stash)
    # the plain version in f64 on the same bf16-rounded weights
    exact = {n: {k: v.to(torch.bfloat16).double() for k, v in p.items()} for n, p in params.items()}
    cfg64 = _cfg(feat, level, dir_level, torch.float64)
    ref = fused_nerf.forward_activations(exact, pts.double(), dirs.double(), cfg64)
    _, ref_dpe, ref_dde = fused_nerf.backward_from_activations(exact, ref, g_sigma.double(), g_rgb.double(), cfg64)
    assert float(ref["sigma"].max()) > 0 and all(torch.isfinite(a).all() for a in acts)
    tol = dict(rtol=1e-9, atol=1e-9)
    for l, name in enumerate(LAYER_NAMES[:8]):
        torch.testing.assert_close(acts[l], ref[name], **tol)
    torch.testing.assert_close(sigma, ref["sigma"], **tol)
    torch.testing.assert_close(rgb, ref["rgb"], **tol)
    torch.testing.assert_close(dpe, ref_dpe, **tol)
    torch.testing.assert_close(dde, ref_dde, **tol)


# ---------------------------------------------------------------------------
# the field against the JAX package


@pytest.mark.parametrize("feat", [96, 576])
def test_field_matches_jax_kernel_in_bf16(feat):
    cfg = _cfg(feat, 10, 4)
    params = _params(cfg, seed=feat)
    pts, dirs, _, _ = _data(40, feat)
    assert fused_nerf.forward_route(cfg) == "wgmma_general"
    sigma, rgb = fused_nerf.fused_nerf_apply(params, pts, dirs, cfg)
    jcfg = JaxFusedConfig(feat_dim=feat, tile=64, compute_dtype=jnp.bfloat16, interpret=True)
    jsigma, jrgb = jax_fused_nerf_apply(params_to_jax(params), jnp.asarray(pts.numpy()), jnp.asarray(dirs.numpy()),
                                        jcfg)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma, dtype=np.float32), rtol=0, atol=2e-2)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb, dtype=np.float32), rtol=0, atol=2e-2)
    assert float(sigma.max()) > 0.0 and float(rgb.std()) > 0.0
