"""The benchmark's yardstick arithmetic: the card's peaks, the least time
of the approximate-channel kernels at a shape, and the model FLOPs of a
round or a step.

Frozen copies, each from where it was first written:

* ``ops_per_symbol`` and ``kernel_bound`` are ``chip_smoke.py``'s
  ``_k1_ops_per_symbol`` and ``_bound``: every operation (each libdevice
  call and divide as one) at the float32 rate, each input byte read once
  and each output byte written once at the HBM rate; K0's bound is K1's
  at C = 1 on the row.
* ``dense_param_counts`` and ``train_flops`` are
  ``src/repro_torch/launch/roofline.py``'s ``n_active_params`` and
  ``model_flops`` for the dense family, worked out from the configuration's
  widths instead of parameter shapes on the meta device: ``6 * N_active *
  tokens``, the embedding table (gathered, not multiplied) not active.
* ``cnn_forward_flops`` counts the paper CNN's multiply-accumulates as two
  FLOPs; forward and backward count three times the forward.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES", "PEAK_F32", "PEAK_BF16", "ops_per_symbol",
           "kernel_bound", "padded_words", "dense_param_counts",
           "train_flops", "cnn_forward_flops", "cnn_round_flops"]

PEAK_BYTES = 3.35e12   # B/s, HBM3
PEAK_F32 = 67e12       # FLOP/s, float32 outside the tensor cores
PEAK_BF16 = 989e12     # FLOP/s, bf16 dense on the tensor cores


def ops_per_symbol(k: int, fading: str) -> tuple[int, int]:
    """(float ops, integer ops) of one symbol of the channel chain."""
    p = k // 2
    gauss_f, gauss_i = 14, 40
    f = 8 + gauss_f + 2 + 4 + 10 + 14
    i = 2 + 8 * p + 12 + 3 + gauss_i + 4 + 8 * p + 2
    if fading == "awgn":
        f += 1 - 4
    else:
        f += gauss_f
        i += gauss_i + (1 if fading == "block_rayleigh" else 0)
    return f, i


def kernel_bound(c: int, n: int, k: int, fading: str, word_bits: int,
                 kernel: str) -> dict:
    """Least time of K1 (or K0, as K1 at ``c = 1``) or K2 over ``c`` rows of
    ``n`` words: ``{"bytes", "ops", "bytes_ms", "ops_ms", "bound_ms",
    "bound_by"}``."""
    wb = word_bits // 8
    s = word_bits // k
    f_sym, i_sym = ops_per_symbol(k, fading)
    ops = c * n * (s * (f_sym + i_sym) + 3) + 3 * c
    if kernel in ("k0", "k1"):
        nbytes = c * n * wb * 2 + c * 12 + c * 4
    elif kernel == "k2":
        ops += c * n * 2
        nbytes = c * n * wb + n * 4 + c * 16 + c * 4
    else:
        raise ValueError(kernel)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def padded_words(n: int, block_words: int = 1024) -> int:
    """A row of ``n`` words padded to whole tiles, as the kernels run it."""
    return -(-n // block_words) * block_words


def dense_param_counts(cfg: dict) -> tuple[float, float]:
    """``(active, total)`` parameters of a dense decoder configuration:
    per layer two norm scales, Q/K/V/O (with Q/K/V biases when
    ``qkv_bias``) and a SwiGLU FFN; the final norm, the head and the
    embedding table. The table is gathered, not multiplied, so it is not
    active; the head is multiplied, and counts as active also where it is
    the embedding table itself (``tie_embeddings``), which then adds
    nothing to the total. (The port's ``n_active_params`` leaves a tied
    head out of the active count.)"""
    D, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KVH, F = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = cfg.get("head_dim") or D // H
    attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
    if cfg.get("qkv_bias"):
        attn += H * hd + 2 * KVH * hd
    layer = 2 * D + attn + 3 * D * F
    embed = 0 if cfg.get("tie_embeddings") else V * D
    active = float(L * layer + D + D * V)
    return active, active + embed


def train_flops(cfg: dict, tokens: int) -> float:
    """``6 * N_active * tokens`` of one training step."""
    return 6.0 * dense_param_counts(cfg)[0] * tokens


def cnn_forward_flops(cfg: dict) -> int:
    """FLOPs of one 28x28 sample's forward pass (a MAC is two)."""
    c1, c2 = cfg["conv_channels"]
    K = cfg["kernel"]
    s1 = cfg["image_size"] - K + 1            # 24
    s2 = s1 // 2 - K + 1                      # 8
    flat = c2 * (s2 // 2) ** 2                # 320
    macs = (s1 * s1 * c1 * K * K + s2 * s2 * c2 * c1 * K * K
            + flat * cfg["fc_hidden"] + cfg["fc_hidden"] * cfg["n_classes"])
    return 2 * macs


def cnn_round_flops(cfg: dict, clients: int, batch: int) -> int:
    """Forward and backward (3x the forward) of every client's minibatch."""
    return 3 * cnn_forward_flops(cfg) * clients * batch
