"""The tensor-core general route in f32 at every width (``csrc/nerf_mlp_tc.cuh``,
route ``f32_wgmma``: every padded width 32..1024, encodings up to 128 wide;
three bf16 pieces an operand, 8 products a multiply-add).

The kernels run only on a Hopper card; here the Python side of their
contract is held on the CPU: the plan's Python twin (``tc_plan``) at every
padded f32 width with encodings 63-123 wide (a plan, every ring two
stages deep, every kernel within a block's shared memory, a consumer
thread's reckoned registers within ``setmaxnreg``'s 232; a tile kernel up
to width 512, the streaming design past it); the f32 weights' three piece
images in the kernels' pass order against a plain loop; a walk over
``tc_matrices`` in the kernels' order (each pass's image rows, each K-slice
read for its k16 steps, a width off the 64s ending on a half K-slice, the
8 piece products of a slice summed and folded into an f32 sum, a tile
kernel's layer written after its last pass, a streaming kernel's layers
through row-major buffers of exactly the layer's width, kernel 1's two in
turn and h9's) against the plain f64 version by the f32 rule; and the port's field
and train pass against the JAX package's Pallas kernels in interpret mode
at f32 96 and 320. Inputs come from a seeded numpy generator. Tolerances:
the walk within 2x the plain f32 version's error against f64 + 1e-5
(max-abs on sigma and rgb, relative L2 on each grad), the rule the card's
checks hold the kernels to; against JAX as ``test_torch_port_general_jax.py``:
outputs rtol 1e-4 / atol 1e-5, each grad a relative L2 of 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_nerf_tpu import fields as jfields
from torch_nerf_tpu.ops import sampling as jsampling
from torch_nerf_tpu.ops.pallas import fused_nerf as jfused
from torch_nerf_tpu.ops.pallas.fused_train import fused_train_pass as jax_fused_train_pass
from torch_nerf_tpu_torch import encoders
from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params, params_from_jax
from torch_nerf_tpu_torch.ops import fused_nerf, fused_train

SMEM = 232_448
FLOOR = 1e-5  # the f32 rule's floor: 2x the plain f32 error + this


def _cfg(feat, level=10, dir_level=4):
    return fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=dir_level, feat_dim=feat,
                                      compute_dtype=torch.float32)


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


def _rel(a, b):
    return float((a.double() - b.double()).norm() / max(float(b.double().norm()), 1e-30))


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("feat", range(32, 1025, 32))
def test_every_f32_width_and_encoding_fits_two_stages(feat):
    """Every padded f32 width at encodings 63 (level 10) and 123 (level
    20) wide: a plan whose three kernels each fit a block's 232,448 bytes
    with a ring of at least two stages, whose passes cover the width, and
    whose consumer thread keeps its sums, held outputs and A fragments
    within 232 registers; a tile kernel up to 512 (one pass of F / 2 at
    F % 64 == 0 up to 256, path A's engine), streaming past it; kernel 1
    at the same passes."""
    for level in (10, 20):
        cfg = _cfg(feat, level, level)
        plan = fused_nerf.tc_plan(cfg)
        assert plan is not None, cfg
        assert fused_nerf.forward_route(cfg) == fused_nerf.train_route(cfg) == "f32_wgmma"
        assert min(plan.stages) >= 2 and max(plan.smem_bytes) <= SMEM and plan.ctas == 1, plan
        assert plan.registers <= 232 - 56, plan  # ~56 left for addresses, masks and the loop
        assert feat <= 2 * plan.np * plan.passes <= feat + 2 * 64 * plan.passes, plan
        assert plan.stream == (feat > 512), plan
        if feat % 64 == 0 and feat <= 256:
            assert (plan.np, plan.passes, plan.multi) == (feat // 2, 1, False)
        elif not plan.stream:
            assert plan.multi and plan.passes <= fused_nerf.F32_PASS_CAP[plan.np], plan
        else:
            assert plan.np in (64, 96) and not plan.multi, plan
        alone = fused_nerf.tc_plan(cfg, stash=False)
        assert (alone.np, alone.passes, alone.stream) == (plan.np, plan.passes, plan.stream)


@pytest.mark.parametrize("feat,want", [
    # half K-slices (96 = 64 + 32): one pass of 64, its trunk read to F
    (96, (64, 1, True, False)),
    # two passes of 80 beside one encoding tile: 10 + 2 panels, fc_8's
    # stage 168 rows (21,504 B), four deep: 1,088 + 98,304 + 86,016
    (320, (80, 2, True, False)),
    # four passes of 64: 16 + 2 panels, stages of 136 rows
    (512, (64, 4, True, False)),
    # streaming: 2 + 1 encoding panels and the 2 KB sink beside four
    # stages of 136 rows; eight passes of 64
    (1024, (64, 8, False, True)),
])
def test_f32_plan_by_config(feat, want):
    plan = fused_nerf.tc_plan(_cfg(feat))
    assert (plan.np, plan.passes, plan.multi, plan.stream) == want
    assert plan.stages == (4, 4, 4)
    smem = {96: 119_872, 320: 185_408, 512: 218_176, 1024: 1_088 + 3 * 8_192 + 2_048 + 4 * 136 * 128}
    assert plan.smem_bytes[0] == smem[feat]


# ---------------------------------------------------------------------------
# the piece images in pass order


@pytest.mark.parametrize("feat,which,layer", [(96, "forward", "fc_2"), (320, "forward", "fc_8"),
                                              (320, "chain", "fc_5"), (1024, "forward", "fc_9"),
                                              (1024, "chain", "fc_out")])
def test_piece_images_in_pass_order_equal_a_plain_loop(feat, which, layer):
    """Each image is pass after pass, each pass's K-slices in order, each
    slice the three bf16 pieces' swizzled panels, the smallest first."""
    cfg = _cfg(feat)
    params = _params(cfg)
    i = LAYER_NAMES.index(layer)
    mat = fused_nerf.tc_matrices(params, cfg)[which == "chain"][i]
    rows = fused_nerf.tc_pass_rows(cfg)[which == "chain"][i]
    # the image tc_layout builds for this layer (tc_images of each matrix at its rows a pass)
    image = fused_nerf.tc_images([mat], [rows])[0].view(torch.int16).numpy()
    pieces = [p.view(torch.int16).numpy() for p in reversed(fused_nerf.bf16_pieces(mat))]
    total, cols = mat.shape
    assert image.size == 3 * mat.numel() and total % rows == 0 and cols % 64 == 0
    # row r's 16-byte chunk d holds the piece's chunk d ^ (r % 8): want[p,
    # s, piece, r, d] = pieces[piece][p rows + r, 64 s + 8 (d ^ (r % 8)) ..]
    stacked = np.stack(pieces).reshape(3, total // rows, rows, cols // 64, 8, 8)
    src = np.arange(8)[None, :] ^ (np.arange(rows) % 8)[:, None]
    swizzled = np.take_along_axis(stacked, src[None, None, :, None, :, None], axis=4)
    want = swizzled.transpose(1, 3, 0, 2, 4, 5).reshape(-1)  # pass, slice, piece, row, chunk, element
    np.testing.assert_array_equal(image, want)


# ---------------------------------------------------------------------------
# a walk in the kernels' order


def _steps(cols):
    """K-slices of a K of ``cols`` columns and the k16 steps of the last."""
    n = -(-cols // 64)
    return n, -(-(cols - 64 * (n - 1)) // 16)


def _pieces(x):
    return [p.double() for p in fused_nerf.bf16_pieces(x.float())]


def _product(segments, mat, rows):
    """A's segments ``[(buffer, cols)]`` times image rows ``rows`` of
    ``mat`` as the kernels compute it in f32: each K-slice of each segment
    (the image's K offset padded to 64) read for its k16 steps from a
    buffer that must hold them (no column past it exists), the 8 piece
    products x_i w_j (i + j <= 3) of a slice exact and summed, rounded to
    f32, and folded into the f32 sum slice by slice by a rounding add.
    (Every slice's products at once: a slice's columns past its k16 steps
    are zeros on both sides, so they add nothing.)"""
    w_rows = mat[rows]
    slices, k0 = [], 0
    for buf, cols in segments:
        n, last = _steps(cols)
        assert 64 * (n - 1) + 16 * last <= buf.shape[1], "a read past the buffer"
        a = torch.nn.functional.pad(buf[:, :64 * (n - 1) + 16 * last], (0, 64 * n - 64 * (n - 1) - 16 * last))
        w = torch.zeros((w_rows.shape[0], 64 * n), dtype=w_rows.dtype)
        w[:, :64 * (n - 1) + 16 * last] = w_rows[:, k0:k0 + 64 * (n - 1) + 16 * last]
        ap = [x.reshape(x.shape[0], n, 64) for x in _pieces(a)]
        wp = [x.reshape(x.shape[0], n, 64) for x in _pieces(w)]
        part = sum(torch.einsum("msk,rsk->smr", ap[i], wp[j]) for i in range(3) for j in range(3) if i + j <= 3)
        slices.extend(part.float())
        k0 += 64 * n
    acc = slices[0]
    for part in slices[1:]:
        acc = acc + part
    return acc


def _layer(segments, mat, plan, width, block=None, np_=None):
    """One layer's outputs in passes: pass p's image rows ``[p block, p
    block + 2 np_)``, warpgroup w's half to columns ``(2p + w) np_ ..``;
    the columns at or past ``width`` (a pass's padding) dropped. Returns
    ``[(columns, f32 sums)]`` in pass order (every pass's rows multiplied
    at once: each output column's sums are its own)."""
    np_ = np_ or plan.np
    block = block or 2 * np_
    picks = []
    for p in range(plan.passes):
        for w in (0, 1):
            c0 = (2 * p + w) * np_
            keep = max(0, min(np_, width - c0))
            if keep:
                picks.append((c0, p * block + w * np_, keep))
    rows = torch.cat([torch.arange(r0, r0 + keep) for _, r0, keep in picks])
    sums = _product(segments, mat, rows)
    out, at = [], 0
    for c0, _, keep in picks:
        out.append((torch.arange(c0, c0 + keep), sums[:, at:at + keep]))
        at += keep
    return out


def _store(buf, held):
    """The layer's outputs into ``buf`` (f32): a tile kernel writes them
    all after its last pass; a streaming kernel writes each pass's to a
    buffer its layer does not read, so the order is the same."""
    buf = buf.clone()
    for cols, v in held:
        buf[:, cols] = v
    return buf


def _walk(params, cfg, pts, dirs, g_sigma, g_rgb, stash=True):
    """Kernels 1 (``stash`` False) or 2 in the kernels' order in f32:
    ``(sigma, rgb, grads, dpts, ddirs)``, the grads by an f64 dW over the
    walk's stashes (the dW GEMM is held on its own elsewhere); None for the
    backward's outputs without ``stash``."""
    plan = fused_nerf.tc_plan(cfg, stash)
    f = fused_nerf.padded_config(cfg).feat_dim
    forward, chain = fused_nerf.tc_matrices(params, cfg, stash)
    bias = [b.float() for b in fused_nerf.general_biases(params, cfg)]
    m, pe_dim, de_dim = pts.shape[0], cfg.pos_enc_dim, cfg.dir_enc_dim
    pe = encoders.positional_encoding(pts, cfg.coord_encode_level, cfg.include_input).float()
    de = encoders.positional_encoding(dirs, cfg.dir_encode_level, cfg.include_input).float()
    # the encode zeroes its tile past the encoding, to the 32-column panel's end
    enc_pe = torch.nn.functional.pad(pe, (0, -(-pe_dim // 32) * 32 - pe_dim))
    enc_de = torch.nn.functional.pad(de, (0, -(-de_dim // 32) * 32 - de_dim))
    # a tile's K: F for a kernel of several passes or a streaming one, else
    # 2 NP; its columns past F never read (NaN here); a streaming kernel's
    # buffers exactly a layer's width, kernel 1's two in turn
    k = f if plan.multi or plan.stream else 2 * plan.np
    nan = float("nan")
    if plan.stream:
        scratch = [torch.full((m, f), nan), torch.full((m, f), nan)]

        def out_buf(slot, width):
            if stash or slot == 9:  # kernel 1's h9: a buffer of its own
                return torch.full((m, width), nan)
            return scratch[slot % 2]
    else:
        tile = torch.full((m, max(f, 2 * plan.np * plan.passes)), nan)

        def out_buf(slot, width):
            return tile

    def relu(held, b):
        return [(c, torch.relu(v + b[c])) for c, v in held]

    acts, inputs = [], []
    h = None
    for l in range(8):
        segs = [(enc_pe, pe_dim)] if l == 0 else [(h, k)] + ([(enc_pe, pe_dim)] if l == 5 else [])
        inputs.append(torch.cat([pe, h[:, :f]], 1) if l == 5 else (pe if l == 0 else h[:, :f]))
        out = _store(out_buf(l, f), relu(_layer(segs, forward[l], plan, f), bias[l]))
        if not plan.stream:
            out[:, f:] = nan
        h = out
        acts.append(h[:, :f])
    sigma = torch.relu(_product([(h, k)], forward[8], slice(2 * plan.np, 2 * plan.np + 1))[:, 0] + bias[8][f])
    held = [(c, v + bias[8][c]) for c, v in _layer([(h, k)], forward[8], plan, f, block=2 * plan.np + 8)]
    inputs.append(h[:, :f])
    feats = _store(out_buf(8, f), held)
    if not plan.stream:
        feats[:, f:] = nan
    inputs.append(torch.cat([feats[:, :f], de], 1))
    h9 = _store(out_buf(9, f // 2), relu(_layer([(feats, k), (enc_de, de_dim)], forward[9], plan, f // 2,
                                                 block=plan.np, np_=plan.np // 2), bias[9]))
    h9 = h9[:, :f // 2].clone()
    inputs.append(h9)
    rgb = torch.sigmoid(_product([(h9, k // 2)], forward[10], slice(0, 3)) + bias[10][:3])
    if not stash:
        return sigma, rgb, None, None, None

    # the chain: every dz row-major (stream) or through the tile, masked by
    # its input's relu; the x panel's 16 columns beside
    def masked(held, act):
        return [(c, torch.where(act[:, c] > 0, v, 0.0)) for c, v in held]

    dzs = [None] * 11
    dz_out = torch.nn.functional.pad(g_rgb * rgb * (1.0 - rgb), (0, 13))
    dzs[10] = dz_out
    dz9 = _store(torch.zeros((m, f // 2)), masked(_layer([(dz_out, 16)], chain[10], plan, f // 2,
                                                         np_=plan.np // 2), h9))
    dzs[9] = dz9
    dde = _product([(dz9, k // 2)], chain[12], slice(0, 128))[:, :de_dim]
    dfeat = _store(torch.zeros((m, f)), _layer([(dz9, k // 2)], chain[9], plan, f))
    dsig = torch.where(sigma > 0, g_sigma, 0.0)
    x = torch.nn.functional.pad(dsig[:, None], (0, 15))
    dzs[8] = torch.cat([dfeat, x], 1)
    dz = dfeat
    dpe = None
    for l in range(8, 0, -1):
        segs = [(dz, k)] + ([(x, 16)] if l == 8 else [])
        if l == 5:
            dpe = _product(segs, chain[11], slice(0, 128))[:, :pe_dim]
        dz = _store(torch.zeros((m, f)), masked(_layer(segs, chain[l], plan, f), acts[l - 1]))
        dzs[l - 1] = dz
    dpe = dpe + _product([(dz, k)], chain[0], slice(0, 128))[:, :pe_dim]
    # dW = A^T dz in f64 over the stashes, the grads mapped to the public
    # layout as the kernels' are
    def seg16(a, widths):
        parts, c = [], 0
        for w in widths:
            parts.append(torch.nn.functional.pad(a[:, c:c + w], (0, -(-w // 16) * 16 - w)))
            c += w
        return torch.cat(parts, 1)

    pp = -(-pe_dim // 16) * 16
    segs = {0: [pe_dim], 5: [pe_dim, f], 9: [f, de_dim]}
    gw = [seg16(a, segs.get(i, [a.shape[1]])).double().t() @ z.double() for i, (a, z) in enumerate(zip(inputs, dzs))]
    gb = [z.double().sum(0) for z in dzs]
    gw[8] = gw[8][:, :f + 16]
    assert [tuple(w.shape) for w in gw] == fused_nerf.general_grad_shapes(cfg) and pp == gw[0].shape[0]
    grads = fused_nerf.grads_from_general([w.float() for w in gw], [b.float() for b in gb], cfg)
    dpts = fused_nerf.encode_vjp(pts, dpe, cfg.coord_encode_level, cfg.include_input)
    ddirs = fused_nerf.encode_vjp(dirs, dde, cfg.dir_encode_level, cfg.include_input)
    return sigma, rgb, grads, dpts, ddirs


def _named(grads, **extra):
    out = {f"{n}.{k}": v for n, p in grads.items() for k, v in p.items()}
    out.update(extra)
    return out


@pytest.mark.parametrize("feat,level,stash", [(96, 10, True), (224, 12, True), (320, 10, True), (608, 10, True),
                                              (1024, 10, False)])
def test_a_walk_in_the_kernels_order_meets_the_f32_rule(feat, level, stash):
    """96: one pass of 64, a half K-slice; 224: two passes of 64, a half
    K-slice; 320: two passes of 80; 608: streaming, five passes of 64 and
    a half K-slice; 1024 kernel 1: streaming through its two scratch
    buffers."""
    cfg = _cfg(feat, level)
    params = _params(cfg, seed=feat)
    pts, dirs, g_sigma, g_rgb = _data(48, seed=feat)
    d64 = fused_nerf.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=4, feat_dim=feat,
                                     compute_dtype=torch.float64)
    p64 = {n: {k: t.double() for k, t in v.items()} for n, v in params.items()}
    sigma, rgb, grads, dpts, ddirs = _walk(params, cfg, pts, dirs, g_sigma, g_rgb, stash)
    ref = fused_nerf.fused_nerf_apply_reference(p64, pts.double(), dirs.double(), d64)
    own = fused_nerf.fused_nerf_apply_reference(params, pts, dirs, cfg)
    assert float(ref[0].max()) > 0.0 and float(ref[1].std()) > 0.0
    for got, want, plain in zip((sigma, rgb), ref, own):
        err, scale = (got.double() - want).abs().max(), (plain.double() - want).abs().max()
        assert err <= 2 * scale + FLOOR, (float(err), float(scale))
    if not stash:
        return
    g64, dp64, dd64 = fused_nerf.fused_nerf_bwd_reference(p64, pts.double(), dirs.double(), g_sigma.double(),
                                                          g_rgb.double(), d64)
    g32, dp32, dd32 = fused_nerf.fused_nerf_bwd_reference(params, pts, dirs, g_sigma, g_rgb, cfg)
    got, want, plain = (_named(g, dpts=a, ddirs=b) for g, a, b in ((grads, dpts, ddirs), (g64, dp64, dd64),
                                                                    (g32, dp32, dd32)))
    for key in want:
        assert _rel(got[key], want[key]) <= 2 * _rel(plain[key], want[key]) + FLOOR, key


# ---------------------------------------------------------------------------
# the port's field and train pass against the JAX package's kernels


N_RAYS, SAMPLES = 12, 8


def _jax_params(feat, level, seed):
    field = jfields.make_nerf_field(coord_encode_level=level, dir_encode_level=4, feat_dim=feat)
    params = jax.tree_util.tree_map(np.asarray, field.init(jax.random.PRNGKey(seed)))
    return {n: {"w": (v["w"] * np.float32(6**0.5)).astype(np.float32), "b": v["b"]} for n, v in params.items()}


def _jax_cfg(feat, level):
    return jfused.FusedNeRFConfig(coord_encode_level=level, dir_encode_level=4, feat_dim=feat, tile=64,
                                  compute_dtype=jnp.float32, interpret=True)


def _close_grads(got, want):
    for name in LAYER_NAMES:
        for leaf in ("w", "b"):
            g = got[name][leaf].detach().double()
            w = torch.from_numpy(np.asarray(want[name][leaf], np.float64))
            assert g.shape == w.shape and _rel(g, w) < 1e-5, f"{name}.{leaf}"


@pytest.mark.parametrize("feat", [96, 320])
def test_field_and_its_backward_match_the_jax_kernel(feat):
    """The port's field (``fused_nerf_apply`` through its autograd
    function) and its backward against JAX's kernel 1 and its VJP."""
    cfg, jcfg = _cfg(feat), _jax_cfg(feat, 10)
    jparams = _jax_params(feat, 10, seed=feat)
    pts, dirs, g_sigma, g_rgb = (t.numpy() for t in _data(N_RAYS * SAMPLES, seed=feat + 1))
    (jsigma, jrgb), vjp = jax.vjp(lambda p, x, y: jfused.fused_nerf_apply(p, x, y, jcfg), jparams,
                                  jnp.asarray(pts), jnp.asarray(dirs))
    jgrads, jdpts, jddirs = jax.tree_util.tree_map(np.asarray, vjp((jnp.asarray(g_sigma), jnp.asarray(g_rgb))))
    params = {n: {k: torch.from_numpy(np.asarray(t)).requires_grad_() for k, t in v.items()}
              for n, v in params_from_jax(jparams).items()}
    x, y = torch.from_numpy(pts).requires_grad_(), torch.from_numpy(dirs).requires_grad_()
    sigma, rgb = fused_nerf.fused_nerf_apply(params, x, y, cfg)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-5)
    assert float(sigma.detach().max()) > 0.0 and float(rgb.detach().std()) > 0.0
    torch.autograd.backward((sigma, rgb), (torch.from_numpy(g_sigma), torch.from_numpy(g_rgb)))
    _close_grads({n: {k: t.grad for k, t in v.items()} for n, v in params.items()}, jgrads)
    assert _rel(x.grad, torch.from_numpy(np.array(jdpts))) < 1e-5 and _rel(y.grad, torch.from_numpy(np.array(jddirs))) < 1e-5


@pytest.mark.parametrize("feat", [96, 320])
def test_train_pass_matches_the_jax_kernel(feat):
    cfg, jcfg = _cfg(feat), _jax_cfg(feat, 10)
    jparams = _jax_params(feat, 10, seed=feat + 2)
    rng = np.random.default_rng(feat)
    # points on a grid of sixteenths: every o + t d exact on both sides
    o = (rng.integers(-8, 9, size=(N_RAYS, 3)) / 16).astype(np.float32)
    d = (rng.integers(-16, 17, size=(N_RAYS, 3)) / 16).astype(np.float32)
    gt = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    t = (np.stack([np.sort(rng.choice(np.arange(32, 96), SAMPLES, replace=False)) for _ in range(N_RAYS)])
         / 16).astype(np.float32)
    delta = np.asarray(jsampling.t_deltas(jnp.asarray(t)))
    real = N_RAYS - 1
    jrgb, jw, jgrads = jax_fused_train_pass(jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                                            jnp.asarray(delta), jnp.asarray(gt), jcfg, real)
    rgb, w, grads = fused_train.fused_train_pass(
        params_from_jax(jparams), *(torch.from_numpy(np.array(a)) for a in (o, d, t, delta, gt)), cfg, real)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    _close_grads(grads, jax.tree_util.tree_map(np.asarray, jgrads))
