"""Plain PyTorch reference of the paper's CNN (Sec. V) and of its FedSGD
rounds over the approximate uplink, written from the paper's description
and the port's documented layouts, importing nothing of the program.

Model: 28x28 -> conv(1->10, k5) -> ReLU -> maxpool 2 -> conv(10->20, k5)
-> ReLU -> maxpool 2 -> flatten (320) -> fc 50 -> ReLU -> fc 10, mean
cross-entropy of the log-softmax. Conv weights are OIHW, FC weights
``(in, out)`` applied as ``x @ W``; the payload order of a parameter dict
is its keys sorted. He-normal weights and zero biases, drawn with the
threefry schedule: ``split(key, 4)``, one normal draw per weight on the
key's device (the CPU), scaled by ``sqrt(float32(2 / fan_in))``.

A round (paper eq. (4)-(6)): each client's gradient on its minibatch, the
``(M, D)`` payloads through M uplinks (K2's per-tile chain with in-chain
aggregation in client order, or the layered PHY and a mean over clients),
then ``w <- w - eta * g`` in float32. Client ``i`` of a round keyed ``rk``
draws ``fold_in(rk, i)``; the kernel seed of a key is
``randint(key, (), 0, 2**31 - 1)`` as uint32. The benchmark's comparison
follows the program round by round: each round's gradients at the
program's parameters of that round (at its own weights for the first),
the uplink of the program's payloads, the update of its aggregate.

``precision`` runs the convolutions and matmuls in float32 (``"fp32"``,
TF32 off) or in TF32 (``"tf32"``: on CUDA the library's TF32 paths, on the
CPU the operands rounded to TF32's 10-bit mantissa), the control of the
benchmark's comparison.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import phy_layered, phy_tile
from portbench.reference import threefry as prng

__all__ = ["init_params", "loss_fn", "client_grads", "uplink",
           "round_inputs", "leaf_sizes", "precision", "PARAM_KEYS"]

PARAM_KEYS = ("conv1_b", "conv1_w", "conv2_b", "conv2_w", "fc1_b", "fc1_w",
              "fc2_b", "fc2_w")


def init_params(key, cfg: dict, device) -> dict:
    """He-normal weights and zero biases of ``cfg`` from ``key`` (CPU)."""
    k = prng.split(key, 4)
    c1, c2 = cfg["conv_channels"]
    K = cfg["kernel"]
    flat = c2 * 4 * 4
    hidden, classes = cfg["fc_hidden"], cfg["n_classes"]

    def he(kk, shape, fan):
        scale = torch.sqrt(torch.tensor(2.0 / fan, dtype=torch.float32))
        return (prng.normal(kk, shape) * scale).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "conv1_w": he(k[0], (c1, 1, K, K), K * K), "conv1_b": zeros(c1),
        "conv2_w": he(k[1], (c2, c1, K, K), c1 * K * K), "conv2_b": zeros(c2),
        "fc1_w": he(k[2], (flat, hidden), flat), "fc1_b": zeros(hidden),
        "fc2_w": he(k[3], (hidden, classes), hidden), "fc2_b": zeros(classes),
    }


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


class precision:
    """Convolutions and matmuls in float32 (``"fp32"``) or TF32 (``"tf32"``)
    inside ``scope()``; ``op`` is what they read of an operand."""

    def __init__(self, precision: str, device):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.emulate = precision == "tf32" and torch.device(device).type != "cuda"
        self.precision = precision

    def op(self, x):
        """``x`` as the matmul or convolution reads it (rounded values, the
        gradient passed straight through)."""
        return x + (_tf32(x.detach()) - x).detach() if self.emulate else x

    @contextlib.contextmanager
    def scope(self):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def _logits(p, images, prec):
    q = prec.op
    x = images[:, None]
    x = F.relu(F.conv2d(q(x), q(p["conv1_w"])) + p["conv1_b"][None, :, None, None])
    x = F.max_pool2d(x, 2)
    x = F.relu(F.conv2d(q(x), q(p["conv2_w"])) + p["conv2_b"][None, :, None, None])
    x = F.max_pool2d(x, 2)
    x = x.reshape(x.shape[0], -1)
    x = F.relu(q(x) @ q(p["fc1_w"]) + p["fc1_b"])
    return q(x) @ q(p["fc2_w"]) + p["fc2_b"]


def loss_fn(p, images, labels, prec) -> torch.Tensor:
    logp = F.log_softmax(_logits(p, images, prec), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def client_grads(params, xb, yb, prec) -> torch.Tensor:
    """Each client's gradient, flattened in sorted-key order: ``(M, D)``."""
    rows = []
    for m in range(xb.shape[0]):
        req = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = torch.autograd.grad(loss_fn(req, xb[m], yb[m], prec),
                                [req[k] for k in PARAM_KEYS])
        rows.append(torch.cat([t.reshape(-1) for t in g]))
    return torch.stack(rows)


def uplink(flat, rk, link: dict):
    """The round's uplink of the ``(M, D)`` payloads keyed by round key ``rk``:
    ``(received, bit errors (M,))``, the received aggregate ``(D,)`` of
    K2's chain, or the ``(M, D)`` received rows of the layered PHY."""
    M, D = flat.shape
    dev = flat.device
    keys = prng.fold_in(rk, torch.arange(M, dtype=torch.int64))
    npow = np.float32(link["large_scale_gain"]
                      / (10.0 ** (link["snr_db"] / 10.0)))
    gain = np.float32(link["large_scale_gain"])
    clamp = int(link["clamp_mask"], 16)
    w = torch.ones((M,), dtype=torch.float32)
    w = (w / w.sum()).to(dev)
    if link["path"] == "k2":
        seeds = (prng.randint(keys, (), 0, 2**31 - 1) & prng.M32).to(dev)
        pad = (-D) % link["block_words"]
        xp = F.pad(flat, (0, pad))
        agg, errs = phy_tile.approx_channel_batch_aggregate_ref(
            xp, seeds, torch.full((M,), float(npow), device=dev),
            torch.full((M,), float(gain), device=dev), w,
            bits_per_symbol=link["bits_per_symbol"], fading=link["fading"],
            clamp_mask=clamp, block_words=link["block_words"],
            valid_words=D)
        return agg[:D], errs.to(torch.int64)
    x_hat, errs = phy_layered.uncoded_batch(
        flat, keys, bits_per_symbol=link["bits_per_symbol"],
        fading=link["fading"], large_scale_gain=link["large_scale_gain"],
        noise_power=link["large_scale_gain"] / (10.0 ** (link["snr_db"] / 10.0)),
        clamp_mask=clamp)
    return x_hat, errs


def round_inputs(seed: int, data, *, n_rounds: int, batch_per_round: int,
                 device):
    """The first ``n_rounds`` rounds' inputs from ``seed``: ``(params key,
    [(round key, minibatch images (M, B, 28, 28), labels (M, B))])``. The
    key schedule is ``key -> (key, params key)``, then ``key -> (key, round
    key)`` a round; each client's minibatch is ``batch_per_round`` draws of
    ``numpy.random.default_rng(seed).integers`` over its samples."""
    cx, cy = data[0], data[1]
    key = prng.PRNGKey(seed)
    sk = prng.split(key)
    key, pk = sk[0], sk[1]
    rng = np.random.default_rng(seed)
    M = cx.shape[0]
    rounds = []
    for _ in range(n_rounds):
        sk = prng.split(key)
        key, rk = sk[0], sk[1]
        take = rng.integers(0, cx.shape[1], (M, batch_per_round))
        xb = np.take_along_axis(cx, take[:, :, None, None], axis=1)
        yb = np.take_along_axis(cy, take, axis=1)
        rounds.append((rk, torch.from_numpy(np.ascontiguousarray(xb)).to(device),
                       torch.from_numpy(yb.astype(np.int64)).to(device)))
    return pk, rounds


def leaf_sizes(cfg: dict) -> dict:
    """Element count of each parameter of ``cfg``."""
    c1, c2 = cfg["conv_channels"]
    K, h, n = cfg["kernel"], cfg["fc_hidden"], cfg["n_classes"]
    return {"conv1_b": c1, "conv1_w": c1 * K * K, "conv2_b": c2,
            "conv2_w": c2 * c1 * K * K, "fc1_b": h, "fc1_w": c2 * 16 * h,
            "fc2_b": n, "fc2_w": h * n}
