"""Gradient-bound certificates (port; paper Sec. III).

A copy of ``repro.core.bounds`` (pure Python, no JAX): the port keeps its
own so it imports nothing of the reference package.

The paper proves that, for fully connected networks with cross-entropy loss
and softmax output, the final-layer error delta^L = p - y lies in (-1, 1)
(eq. 15), and that with sigmoid hidden activations (sigma' in (0, 1/4)) and
weights bounded in (-1, 1), the gradient dC/dw^l is bounded by a layer-wise
constant B^l that depends on the fan-outs of the layers above l (eq. 10) —
and similarly for the 3-layer CNN sketch (eq. 16-17).

This module computes those certificates for concrete layer stacks so the
transport layer can choose a *certified* exponent-clamp mask
(``float_codec.exponent_clamp_mask``) rather than only the empirical |g| < 1
assumption. The recursion implemented here is exactly the paper's:

    |delta^L_j| <= 1
    |delta^l_j| <= n_{l+1} * W * S' * max_j |delta^{l+1}_j|
    |dC/dw^l_{jk}| <= |delta^l_j| * A

with W the weight bound, S' the activation-derivative bound, A the
activation-output bound (1 for sigmoid; input bound for the first layer).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["ActivationInfo", "ACTIVATIONS", "LayerSpec", "gradient_bound", "certified_clamp_bound"]


@dataclasses.dataclass(frozen=True)
class ActivationInfo:
    """Worst-case activation bounds used by the gradient certificate."""

    name: str
    output_bound: float  # sup |a| (inf -> depends on input)
    deriv_bound: float  # sup |sigma'|


ACTIVATIONS = {
    "sigmoid": ActivationInfo("sigmoid", 1.0, 0.25),
    "tanh": ActivationInfo("tanh", 1.0, 1.0),
    "relu": ActivationInfo("relu", math.inf, 1.0),
    "softmax_xent": ActivationInfo("softmax_xent", 1.0, 1.0),  # final layer
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One fully-connected layer of the certified stack (input->output)."""

    fan_out: int  # neurons in this layer (summation width seen from below)
    activation: str = "sigmoid"
    weight_bound: float = 1.0


def gradient_bound(layers: list[LayerSpec], input_bound: float = 1.0) -> list[float]:
    """Per-layer bound B^l on |dC/dw^l| for an FC stack, paper Sec. III-A.

    ``layers`` is ordered input->output; the final layer is assumed
    softmax+cross-entropy (delta^L in (-1,1)). Returns one bound per layer.
    Unbounded activations (ReLU with unbounded input) yield ``inf`` — the
    honest answer; the paper's certificate needs sigmoid-family hidden acts.
    """
    L = len(layers)
    delta = [math.inf] * L
    delta[L - 1] = 1.0  # |p - y| < 1, eq. (15)
    for l in range(L - 2, -1, -1):
        nxt = layers[l + 1]
        act = ACTIVATIONS[layers[l].activation]
        delta[l] = nxt.fan_out * nxt.weight_bound * act.deriv_bound * delta[l + 1]
    bounds = []
    for l in range(L):
        if l == 0:
            a_prev = input_bound
        else:
            a_prev = ACTIVATIONS[layers[l - 1].activation].output_bound
            if math.isinf(a_prev):
                a_prev = math.inf
        bounds.append(delta[l] * a_prev)
    return bounds


def certified_clamp_bound(layers: list[LayerSpec], input_bound: float = 1.0) -> float:
    """Tightest power-of-two clamp bound covering every layer's certificate.

    Falls back to the paper's default 2.0 (bit-30-only clamp) when any layer
    is uncertified (inf) or the certificate exceeds 2.
    """
    bs = gradient_bound(layers, input_bound)
    worst = max(bs)
    if math.isinf(worst) or worst >= 2.0:
        return 2.0
    return 2.0 ** math.ceil(math.log2(worst))
