"""Shared neural-net building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:

* params are nested dicts of tensors; layer-stacked leaves have a leading
  ``L`` dimension (the reference scans over it, the port loops);
* the compute dtype is the config's (bf16 by default), normalizations and
  softmax run in float32;
* initializers take explicit PRNG keys (``repro_torch.core.prng``), so a
  key gives the reference's draws: the threefry bits are exact, the
  normals agree to a few ULP before the cast (``torch.erfinv`` is not
  XLA's ``erf_inv``) and mostly exactly after the cast to bf16.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import prng

__all__ = [
    "dtype_of", "dense_init", "embed_init", "rmsnorm", "layernorm", "dot",
    "rope_freqs", "apply_rope", "rotate", "yarn_mscale", "yarn_freqs",
    "yarn_softmax_scale", "swiglu", "gelu_mlp", "sinusoidal_positions",
    "unstack_tree", "maybe_shard",
]

Params = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    """The parameter / compute dtype a config names."""
    return _DTYPES[cfg.dtype]


def dense_init(key, shape, in_axis: int = -2, dtype=torch.bfloat16):
    """LeCun-normal in float32 on the key's device, cast to ``dtype``."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return (prng.normal(key, shape) * std).to(dtype)


def embed_init(key, shape, dtype=torch.bfloat16):
    """Embedding table: normal * 0.02 in float32, cast to ``dtype``."""
    return (prng.normal(key, shape) * 0.02).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in float32 with a zero-centred scale (``1 + scale``)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm in float32: the mean, then the mean of the squared
    deviations (``jnp.var``), cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    out = c * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, as ``jnp.einsum`` types it: a
    float32 activation against bf16 weights upcasts the weights (exact)
    and gives float32; ``torch.matmul`` refuses mixed dtypes."""
    t = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(t), w.to(t))


def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary half-pairs actually rotated."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    i = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of the head dim.

    x: ``(..., S, H, hd)``; positions: broadcastable to ``(..., S)``.
    ``fraction < 1`` is partial rotary (ChatGLM's 2D-RoPE rotates half the
    head dim; the rest passes through unrotated).
    """
    return rotate(x, positions, rope_freqs(x.shape[-1], fraction, theta,
                                           x.device))


def rotate(x: torch.Tensor, positions: torch.Tensor,
           inv: torch.Tensor) -> torch.Tensor:
    """Turn adjacent pairs ``(x[2i], x[2i+1])`` of the leading ``2 *
    len(inv)`` dims by ``position * inv[i]``; the rest passes through.

    x: ``(..., S, H, hd)``; positions: broadcastable to ``(..., S)``.
    """
    rot = inv.shape[0] * 2
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    xp = xr.reshape(*xr.shape[:-1], rot // 2, 2)
    x1 = xp[..., 0]
    x2 = xp[..., 1]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor ``m(s, a) = 0.1 a ln s + 1`` (1 for ``s <=
    1``)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(dim: int, theta: float, factor: float, original_max: int,
               beta_fast: float, beta_slow: float,
               device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of a ``dim``-wide rotary part (the
    DeepSeek-V3 form): ``f_e = theta^(-2i/dim)``, ``f_i = f_e / factor``,
    blended by a ramp between the correction dims of ``beta_fast`` and
    ``beta_slow``: ``corr(b) = dim ln(L0 / (2 pi b)) / (2 ln theta)``,
    ``low = floor(corr(beta_fast))``, ``high = ceil(corr(beta_slow))``,
    ``ramp = clip((i - low) / (high - low), 0, 1)``, ``inv = f_i ramp +
    f_e (1 - ramp)``. ``factor`` 1 gives plain RoPE."""
    f_e = rope_freqs(dim, 1.0, theta, device)
    if factor <= 1:
        return f_e

    def corr(b):
        return dim * math.log(original_max / (b * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
    return f_e / factor * ramp + f_e * (1.0 - ramp)


def yarn_softmax_scale(qk_head_dim: int, factor: float,
                       mscale_all_dim: float) -> float:
    """The attention's softmax scale under YaRN: ``qk_head_dim^-0.5 *
    m(factor, mscale_all_dim)^2``."""
    m = yarn_mscale(factor, mscale_all_dim)
    return qk_head_dim ** -0.5 * m * m


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN in the params' dtype; the gate's SiLU in float32."""
    h = torch.matmul(x, wi)
    g = torch.matmul(x, wg)
    return torch.matmul(F.silu(g.to(torch.float32)).to(h.dtype) * h, wo)


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor, bi, wo: torch.Tensor, bo):
    """GELU FFN with biases; GELU is the tanh form, ``jax.nn.gelu``'s
    default. A float32 ``x`` against bf16 weights runs in float32
    (:func:`dot`)."""
    h = dot(x, wi) + bi
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dot(h, wo) + bo


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """``(max_len, dim)`` sin / cos position table."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def unstack_tree(params: Params, idx: int) -> Params:
    """Take layer ``idx`` from a stacked param tree."""
    if isinstance(params, dict):
        return {k: unstack_tree(v, idx) for k, v in params.items()}
    return params[idx]


def maybe_shard(x: torch.Tensor, *axes_per_dim) -> torch.Tensor:
    """The reference's sharding hint, an identity here.

    The reference pins layouts inside an ambient XLA mesh. The port runs
    one process per rank with whole tensors (data parallelism only), so
    there is no layout to constrain and ``x`` is returned as it is.
    """
    return x
