"""Family -> implementation dispatch + input specs for every shape (port of
``repro.models.registry``).

The port runs every family: ``dense``, ``moe``, ``vlm`` and ``hybrid``
(``models/transformer.py``, with ``models/moe.py``), ``ssm``
(``models/ssm.py``) and ``audio`` (``models/audio.py``); a moe config with
``moe_impl="expert_parallel"`` runs ``models/moe.py``'s expert-parallel
dispatch inside a data-parallel step's ``expert_group`` scope and the
dense dispatch outside it. The port-only ``kimi-k2-instruct`` (a moe
config with latent attention and a held share of the experts) trains and
prefills; its ``init_cache`` and ``decode_step`` raise
``NotImplementedError``. The shape helpers
(``uses_ring_cache``, ``cache_len_for``, ``supports_shape``,
``input_specs``) answer for every family, as they are data.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import prng
from repro_torch.models import audio, ssm, transformer

__all__ = [
    "TensorSpec", "family_module", "init_params", "loss_fn", "forward",
    "init_cache", "decode_step", "uses_ring_cache", "cache_len_for",
    "supports_shape", "input_specs", "make_batch",
]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one model input (no allocation): the port's
    ``jax.ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype


def family_module(cfg: ModelConfig):
    """The module that implements ``cfg.family``."""
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        transformer.check_family(cfg)
        return transformer
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "audio":
        return audio
    raise ValueError(cfg.family)


def init_params(key, cfg: ModelConfig):
    """Random params from ``key``, on the key's device."""
    return family_module(cfg).init_params(key, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    return family_module(cfg).loss_fn(params, batch, cfg)


def forward(params, batch, cfg: ModelConfig):
    return family_module(cfg).forward(params, batch, cfg)


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None):
    return family_module(cfg).init_cache(cfg, batch_size, cache_len,
                                         device=device)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *, ring=False):
    return family_module(cfg).decode_step(params, cache, tokens, pos, cfg,
                                          ring=ring)


def uses_ring_cache(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k decodes through ring (sliding-window) caches."""
    return shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm")


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if uses_ring_cache(cfg, shape):
        return cfg.decode_window
    if cfg.family == "hybrid":
        return min(shape.seq_len, cfg.local_window)
    return shape.seq_len


def supports_shape(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-not): the reference's skip list."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return False, ("enc-dec full attention; decoder spec'd <=448 "
                           "positions, 500k-token transcript decode has no "
                           "analogue (DESIGN.md Sec.4)")
        return True, ""
    return True, ""


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """:class:`TensorSpec` stand-ins for every model input."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, S), i32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = TensorSpec(
                (B, cfg.n_patches, cfg.vision_dim), f32)
        if cfg.family == "audio":
            specs["frames"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model), f32)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": TensorSpec((B, 1), i32)}


def make_batch(cfg: ModelConfig, shape: InputShape, key) -> dict:
    """Concrete random batch matching :func:`input_specs`, on the key's
    device: the reference's draws (integers exact, normals to a few
    ULP)."""
    specs = input_specs(cfg, shape)
    ks = prng.split(key, len(specs))
    out = {}
    for (name, spec), k in zip(sorted(specs.items()), ks):
        if spec.dtype == torch.int32:
            out[name] = prng.randint(k, spec.shape, 0, cfg.vocab_size).to(
                torch.int32)
        else:
            out[name] = prng.normal(k, spec.shape).to(spec.dtype)
    return out
