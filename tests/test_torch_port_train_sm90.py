"""The training kernels' weight images (``fused_nerf.training_layout``).

The Hopper training kernels read every layer's weight, and its transpose,
as images of ``wgmma``'s 128-byte swizzled shared-memory layout. These
tests hold the Python side of that contract on the CPU: the swizzle's
address function, that each image turns back into the padded bf16 weight
(forward: W^T; chain: W), and that a plain walk over an image, slice by
slice in the kernels' K order, reproduces the layer's product. Inputs come
from a seeded numpy generator; products are compared in f32 on bf16
operands (rtol 1e-5: the same sums in another order).
"""

import numpy as np
import pytest
import torch

from torch_nerf_tpu_torch.models.nerf import LAYER_NAMES, init_nerf_params
from torch_nerf_tpu_torch.ops import fused_nerf

WIDTHS = (64, 128, 256)


def _params(feat, seed=0):
    return init_nerf_params(torch.Generator().manual_seed(seed), 63, 27, feat)


def _cfg(feat):
    return fused_nerf.FusedNeRFConfig(feat_dim=feat)


def _unpanel(image, rows, cols):
    """The (rows, cols) matrix of a panel image, read element by element
    at the swizzle's addresses, slice after slice."""
    s = torch.arange(cols // 64)[:, None, None]
    r = torch.arange(rows)[None, :, None]
    c = torch.arange(64)[None, None, :]
    idx = s * rows * 64 + fused_nerf.swizzle128(r, c) // 2
    return image[idx].permute(1, 0, 2).reshape(rows, cols)


@pytest.mark.parametrize("row0", [0, 8, 120])
def test_swizzle128_is_a_bijection_on_each_atom_and_xors_the_chunk(row0):
    rows = torch.arange(row0, row0 + 8)[:, None]
    cols = torch.arange(64)[None, :]
    off = fused_nerf.swizzle128(rows, cols) - row0 * 128
    # one 8-row x 128-byte atom, every bf16 slot once
    assert sorted(off.reshape(-1).tolist()) == list(range(0, 1024, 2))
    # 16-byte chunk (col // 8) ^ (row % 8) of the row, the element at (col % 8) * 2 in it
    assert torch.equal(off // 128, rows - row0 + 0 * cols)
    assert torch.equal((off % 128) // 16, (cols // 8) ^ (rows % 8))
    assert torch.equal(off % 16, (cols % 8) * 2 + 0 * rows)


def test_panel_image_places_each_slice_after_the_last():
    x = torch.arange(3 * 128, dtype=torch.float32).reshape(3, 128)
    image = fused_nerf.panel_image(x)
    assert image.shape == (3 * 128,)
    # slice 1 (columns 64..127) starts after slice 0's three 128-byte rows
    assert image[3 * 64 + fused_nerf.swizzle128(2, 5) // 2] == x[2, 64 + 5]
    assert torch.equal(_unpanel(image, 3, 128), x)


@pytest.mark.parametrize("feat", WIDTHS)
def test_images_turn_back_into_the_padded_weight_and_its_transpose(feat):
    params = _params(feat)
    cfg = _cfg(feat)
    f, p, d = feat, cfg.pos_enc_dim, cfg.dir_enc_dim
    fwd_images, biases, chain_images = fused_nerf.training_layout(params, cfg)
    mats = fused_nerf.training_matrices(params, cfg)
    for i, name in enumerate(LAYER_NAMES):
        fwd, bias, chain = mats[i]
        assert torch.equal(_unpanel(fwd_images[i], *fwd.shape), fwd), name
        assert torch.equal(_unpanel(chain_images[i], *chain.shape), chain), name
        assert torch.equal(biases[i], bias)
        w = params[name]["w"].to(torch.bfloat16)
        b = params[name]["b"].to(torch.bfloat16)
        if name == "fc_in":
            assert torch.equal(fwd[:, :p], w.t()) and not fwd[:, p:].any()
            assert torch.equal(chain, fwd.t())
        elif name == "fc_5":  # forward K order [pe, h4], chain rows [h4, pe]
            assert torch.equal(fwd[:, :p], w[:p].t()) and not fwd[:, p:64].any()
            assert torch.equal(fwd[:, 64:], w[p:].t())
            assert torch.equal(chain[:f], w[p:]) and torch.equal(chain[f:f + p], w[:p]) and not chain[f + p:].any()
        elif name == "fc_8":  # sigma (public column 0) after the features
            assert fwd.shape == (f + 8, f) and chain.shape == (f, f + 64)
            assert torch.equal(fwd[:f], w[:, 1:].t()) and torch.equal(fwd[f], w[:, 0]) and not fwd[f + 1:].any()
            assert torch.equal(chain[:, :f + 1], fwd[:f + 1].t()) and not chain[:, f + 1:].any()
            assert torch.equal(bias[:f], b[1:]) and bias[f] == b[0] and not bias[f + 1:].any()
        elif name == "fc_9":  # inputs [features, de], de padded to 64
            assert torch.equal(fwd[:, :f], w[:f].t()) and torch.equal(fwd[:, f:f + d], w[f:].t())
            assert not fwd[:, f + d:].any()
            assert torch.equal(chain[:, :f // 2], fwd.t()) and not chain[:, f // 2:].any()
        elif name == "fc_out":
            assert torch.equal(fwd[:3, :f // 2], w.t()) and not fwd[3:].any() and not fwd[:, f // 2:].any()
            assert torch.equal(chain[:, :3], w) and not chain[:, 3:].any()
            assert torch.equal(bias[:3], b) and not bias[3:].any()
        else:
            assert torch.equal(fwd, w.t()) and torch.equal(chain, w)


def _walk(image, rows, cols, x):
    """x (M, cols) times the image's (rows, cols) matrix transposed, one
    64-wide K-slice at a time as the kernels' k-loop runs, rows read at the
    swizzle's addresses."""
    acc = torch.zeros((x.shape[0], rows))
    r = torch.arange(rows)[:, None]
    c = torch.arange(64)[None, :]
    for s in range(cols // 64):
        b = image[s * rows * 64 + fused_nerf.swizzle128(r, c) // 2].float()  # (rows, 64)
        acc += x[:, 64 * s:64 * s + 64].float() @ b.t()
    return acc


def _pad_cols(x, segments):
    """Columns of x split into (length, padded) segments, each zero-padded."""
    parts, start = [], 0
    for length, padded in segments:
        parts.append(torch.nn.functional.pad(x[:, start:start + length], (0, padded - length)))
        start += length
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("feat", WIDTHS)
def test_a_plain_walk_over_the_images_reproduces_each_layer(feat):
    params = _params(feat, seed=1)
    cfg = _cfg(feat)
    f, p, d = feat, cfg.pos_enc_dim, cfg.dir_enc_dim
    fwd_images, _, chain_images = fused_nerf.training_layout(params, cfg)
    mats = fused_nerf.training_matrices(params, cfg)
    rng = np.random.default_rng(feat)
    # the kernels' K order of each layer's input, and of its output (the chain's K)
    in_segments = {"fc_in": [(p, 64)], "fc_5": [(p, 64), (f, f)], "fc_9": [(f, f), (d, 64)],
                   "fc_out": [(f // 2, -(-f // 2 // 64) * 64)]}
    for i, name in enumerate(LAYER_NAMES):
        w = params[name]["w"].to(torch.bfloat16).float()
        k_in, n_out = w.shape
        x = torch.from_numpy(rng.normal(size=(5, k_in)).astype(np.float32)).to(torch.bfloat16).float()
        want = x @ w
        fwd_rows, fwd_cols = mats[i][0].shape
        got = _walk(fwd_images[i], fwd_rows, fwd_cols, _pad_cols(x, in_segments.get(name, [(k_in, k_in)])))
        if name == "fc_8":
            got = torch.cat([got[:, f:f + 1], got[:, :f]], dim=1)
        np.testing.assert_allclose(got[:, :n_out].numpy(), want.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        assert not got[:, n_out:].any(), name

        # the chain: dh = dz W^T, dz in the forward's output order
        dz = torch.from_numpy(rng.normal(size=(5, n_out)).astype(np.float32)).to(torch.bfloat16).float()
        want = dz @ w.t()
        if name == "fc_8":
            dz = torch.cat([dz[:, 1:], dz[:, :1]], dim=1)
        chain_rows, chain_cols = mats[i][2].shape
        got = _walk(chain_images[i], chain_rows, chain_cols,
                    torch.nn.functional.pad(dz, (0, chain_cols - n_out)))
        if name == "fc_5":  # rows [h4, pe]
            got = torch.cat([got[:, f:f + p], got[:, :f]], dim=1)
        elif name == "fc_9":  # rows [features, de]
            got = got[:, :f + d]
        np.testing.assert_allclose(got[:, :k_in].numpy(), want.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_training_route_takes_its_widths_and_raises_on_others():
    # the wgmma templates keep their widths; the tensor-core general route
    # takes every other bf16 config up to the general route's limits
    for feat in WIDTHS:
        assert fused_nerf.train_route(_cfg(feat)) == "wgmma"
    assert fused_nerf.train_route(_cfg(96)) == "wgmma_general"
    assert fused_nerf.train_route(fused_nerf.FusedNeRFConfig(coord_encode_level=11)) == "wgmma_general"
    assert fused_nerf.train_route(fused_nerf.FusedNeRFConfig(compute_dtype=torch.float32)) == "f32_wgmma"
    with pytest.raises(ValueError, match="feat_dim up to 1024"):
        fused_nerf.train_route(_cfg(1056))
    with pytest.raises(ValueError, match="128 wide"):
        fused_nerf.train_route(fused_nerf.FusedNeRFConfig(coord_encode_level=21))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_nerf.train_route(fused_nerf.FusedNeRFConfig(compute_dtype=torch.float16))
