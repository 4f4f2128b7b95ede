"""The paper's FL model (Sec. V): 2x conv(k5) + 2x maxpool(2) + 2x FC.

28x28 -> conv(1->10,k5) -> pool2 -> conv(10->20,k5) -> pool2 -> flatten(320)
-> fc(50) -> fc(10); ReLU hidden, log-softmax output, cross-entropy loss.

Counterpart of ``repro.fl.cnn`` as plain functions on a parameter dict
with the reference's keys and layouts: conv weights OIHW, FC weights
``(in, out)`` applied as ``x @ W``. Keeping the layout keeps the uplink
payload's float order the reference's (``transport.tree_flatten``).

ReLU and the 2x2 max-pool carry the reference's derivatives, which differ
from PyTorch's at non-finite activations (a naive leg has no clamp, so a
received model may hold NaN or inf):

* ``jax.nn.relu``'s derivative is ``select(x > 0, g, 0)``: 0 at NaN, where
  ``torch.relu`` passes the gradient;
* ``lax.reduce_window`` max routes the gradient by XLA's select-and-scatter
  walk over the window in row-major order, keeping the current pick while
  ``pick >= next`` and else taking ``next``; ``max_pool2d`` routes it to a
  NaN instead.

Both keep PyTorch's forward values (``relu(NaN) = NaN``, the pool's max
propagates NaN) and, on finite inputs, PyTorch's gradient bits. They are
written with ``torch.where`` on native ops, so ``torch.func``'s vmap of
grad batches them as any other op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng

__all__ = ["init_params", "logits_fn", "loss_fn", "accuracy", "relu",
           "pool2"]


def init_params(key: torch.Tensor, cfg, device=None) -> dict:
    """He-initialized parameters, drawn with the reference's key schedule.

    The normals agree with the reference's to a few ULP (``prng.normal``);
    load the reference's weights with ``repro_torch.convert`` where the
    comparison must start from identical parameters.
    """
    k = prng.split(key, 4)
    c1, c2 = cfg.conv_channels
    K = cfg.kernel
    flat = c2 * 4 * 4  # 28 -> 24 -> 12 -> 8 -> 4

    def he(kk, shape, fan):
        scale = torch.sqrt(torch.tensor(2.0 / fan, dtype=torch.float32))
        return (prng.normal(kk, shape) * scale).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "conv1_w": he(k[0], (c1, 1, K, K), K * K),
        "conv1_b": zeros(c1),
        "conv2_w": he(k[1], (c2, c1, K, K), c1 * K * K),
        "conv2_b": zeros(c2),
        "fc1_w": he(k[2], (flat, cfg.fc_hidden), flat),
        "fc1_b": zeros(cfg.fc_hidden),
        "fc2_w": he(k[3], (cfg.fc_hidden, cfg.n_classes), cfg.fc_hidden),
        "fc2_b": zeros(cfg.n_classes),
    }


def _conv(x, w, b):
    # x: (B, C, H, W); w: (O, C, K, K); bias added after, as the reference.
    return F.conv2d(x, w) + b[None, :, None, None]


def relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.relu``'s value with the reference's derivative ``select(x >
    0, g, 0)``: the gradient takes the ``x`` branch only where ``x > 0``;
    elsewhere the value comes from the detached ``relu(x)`` (0, or NaN at
    NaN)."""
    return torch.where(x > 0, x, torch.relu(x.detach()))


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, with the reference's gradient routing.

    The pick walks each window in row-major order and moves to the next
    element unless ``pick >= next`` (so ties keep the first maximum, and
    any comparison with NaN moves on); ``torch.where`` routes the gradient
    along the walk. Where a window holds a NaN the value is NaN, as
    ``max_pool2d``'s: the detached addend is NaN there and ``-0.0``, which
    leaves every other value's bits alone, elsewhere. On windows without
    a NaN the pick is ``max_pool2d``'s own element, so value and gradient
    are PyTorch's, bit for bit."""
    pick = x[..., 0::2, 0::2]
    for v in (x[..., 0::2, 1::2], x[..., 1::2, 0::2], x[..., 1::2, 1::2]):
        pick = torch.where(pick >= v, pick, v)
    peak = F.max_pool2d(x.detach(), 2)
    return pick + torch.where(torch.isnan(peak), peak, -0.0)


def logits_fn(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28) -> logits (B, 10)."""
    x = images[:, None]
    x = relu(_conv(x, params["conv1_w"], params["conv1_b"]))
    x = pool2(x)
    x = relu(_conv(x, params["conv2_w"], params["conv2_b"]))
    x = pool2(x)
    x = x.reshape(x.shape[0], -1)
    x = relu(x @ params["fc1_w"] + params["fc1_b"])
    return x @ params["fc2_w"] + params["fc2_b"]


def loss_fn(params: dict, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``(B, 28, 28)`` images vs integer labels."""
    logp = F.log_softmax(logits_fn(params, images), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def accuracy(params: dict, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy of the model on ``(B, 28, 28)`` images."""
    pred = torch.argmax(logits_fn(params, images), dim=-1)
    return torch.mean((pred == labels).to(torch.float32))
