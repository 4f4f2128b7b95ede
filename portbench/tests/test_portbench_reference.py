"""The benchmark's plain reference against the port's CPU path at a tiny
size: the same keys, draws, PHY bits, weights and losses from the same
seed. (The reference itself imports nothing of the port; these tests do,
to hold the two against each other.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests._tiny import SEED


def test_threefry_copy_matches_the_port():
    from repro_torch.core import prng

    from portbench.reference import threefry

    for seed in (0, SEED, 2**32 + 5):
        a, b = threefry.PRNGKey(seed), prng.PRNGKey(seed)
        assert torch.equal(threefry.split(a, 7), prng.split(b, 7))
        assert torch.equal(threefry.randint(threefry.fold_in(a, 3), (5,), 0,
                                            2**31 - 1),
                           prng.randint(prng.fold_in(b, 3), (5,), 0,
                                        2**31 - 1))
        assert torch.equal(threefry.normal(a, (9, 4)), prng.normal(b, (9, 4)))


@pytest.mark.parametrize("first_tile", [0, 262_143])
def test_tile_chain_matches_the_kernels_plain_version(first_tile):
    from repro_torch.kernels import ref as kref

    from portbench.reference import phy_tile

    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 2048), generator=g) * 0.01
    seeds = torch.tensor([5, 2**31 + 7, 99])
    npow = torch.full((3,), 1e-4)
    gain = torch.full((3,), 1e-3)
    w = torch.full((3,), 1.0 / 3.0)
    a = phy_tile.approx_channel_batch_aggregate_ref(x, seeds, npow, gain, w)
    b = kref.approx_channel_batch_aggregate_ref(x, seeds, npow, gain, w)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # one row's tiles from tile ``first_tile`` on, as the LLM check runs K0's
    want, _ = kref.approx_channel_batch_ref(x[:1], seeds[:1], npow[:1],
                                            gain[:1], first_tile=first_tile)
    tiles = torch.arange(2, dtype=torch.int64) + first_tile
    got = phy_tile.channel_tile(
        phy_tile.f32_to_bits(x[0]).reshape(2, 1024), seeds[:1].reshape(1, 1),
        ((tiles * 1024 * 16) & 0xFFFFFFFF)[:, None], npow[:1].reshape(1, 1),
        gain[:1].reshape(1, 1), bits_per_symbol=2, fading="rayleigh",
        fade_block=64, block_words=1024) & 0xBFFFFFFF
    assert torch.equal(phy_tile.bits_to_f32(got.reshape(-1)), want[0])


def test_layered_chain_matches_the_port():
    from repro_torch.core import channel, transport

    from portbench.reference import phy_layered, threefry

    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 777), generator=g) * 0.02
    cfg = transport.TransportConfig(
        mode="approx", channel=channel.ChannelConfig(snr_db=10.0),
        simulate_fec=False)
    got, stats = transport._uncoded(
        x, transport.client_keys(threefry.PRNGKey(SEED), 3), cfg, True)
    want, errs = phy_layered.uncoded_batch(
        x, threefry.fold_in(threefry.PRNGKey(SEED), torch.arange(3)),
        bits_per_symbol=2, fading="rayleigh",
        large_scale_gain=cfg.channel.large_scale_gain,
        noise_power=cfg.channel.noise_power, clamp_mask=0xBFFFFFFF)
    assert torch.equal(got, want)
    assert torch.equal(stats.bit_errors, errs.to(torch.float32))


def test_cnn_weights_and_gradients_match_the_port():
    from repro_torch.configs.mnist_cnn import MnistCnnConfig
    from repro_torch.core import prng
    from repro_torch.fl import cnn

    from portbench.reference import cnn as cnn_ref
    from portbench.reference import threefry
    from portbench.tests._tiny import tiny_cell

    model = tiny_cell("cnn-approx-k2").config["model"]
    port = cnn.init_params(prng.PRNGKey(SEED),
                           MnistCnnConfig(lr=model["lr"]), "cpu")
    ref = cnn_ref.init_params(threefry.PRNGKey(SEED), model, "cpu")
    assert all(torch.equal(port[k], ref[k]) for k in cnn_ref.PARAM_KEYS)
    g = torch.Generator().manual_seed(5)
    xb = torch.rand((2, 4, 28, 28), generator=g)
    yb = torch.randint(0, 10, (2, 4), generator=g)
    prec = cnn_ref.precision("fp32", "cpu")
    want = cnn_ref.client_grads(ref, xb, yb, prec)
    got = torch.stack([torch.cat([t.reshape(-1) for t in (
        torch.func.grad(cnn.loss_fn)(port, xb[m], yb[m])[k]
        for k in cnn_ref.PARAM_KEYS)]) for m in range(2)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_qwen2_weights_and_loss_match_the_port():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import prng, transport
    from repro_torch.launch import steps

    from portbench.reference import qwen2, threefry
    from portbench.tests._tiny import tiny_cell

    model = tiny_cell("qwen2-1.5b-k0-s256").config["model"]
    fields = {f.name for f in dataclasses.fields(get_config("qwen2-1.5b"))}
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              **{k: v for k, v in model.items()
                                 if k in fields})
    from repro_torch.models import registry

    port = registry.init_params(prng.PRNGKey(SEED), cfg)
    ref = qwen2.init_params(threefry.PRNGKey(SEED), model)
    pl, _ = transport.tree_flatten(port)
    assert all(torch.equal(a, b) for a, b in zip(pl, qwen2.flat_leaves(ref)))
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, model["vocab_size"], (2, 9)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss, grads = steps.value_and_grad(cfg, port, batch)
    rloss, rgrads = qwen2.loss_and_grads(ref, batch["tokens"],
                                         batch["labels"], model)
    assert float(loss) == pytest.approx(rloss, rel=2e-3)
    from portbench.core import compare

    gl = [g.float() for g in transport.tree_flatten(grads)[0]]
    # bfloat16 against float32: norms within a percent, elements within a
    # tenth of the leaf's RMS
    assert compare.worst(compare.leaf_gaps(compare.leaf_norms(gl),
                                           compare.leaf_norms(rgrads))) < 0.01
    assert compare.worst(compare.leaf_errs(gl, rgrads)) < 0.1
