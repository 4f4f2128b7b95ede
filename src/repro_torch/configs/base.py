"""Architecture / input-shape / run configuration schema and registry
(port).

Counterpart of ``repro.configs.base``, field for field: the configs are
data, so every architecture module is ported, whatever family the port
runs yet (``repro_torch.models.registry`` says which).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "register",
           "register_port_only", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    # rotary / attention
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 = full causal attention (training variant)
    attn_impl: str = "naive"  # "naive" | "blockwise" (flash-style online softmax)
    decode_window: int = 4096  # ring-buffer window used for long_500k decode
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0  # FFN width of the leading dense layers (MoE models)
    first_dense_layers: int = 0
    capacity_factor: float = 1.5
    aux_loss_coef: float = 0.01
    moe_impl: str = "dense"  # "dense" | "expert_parallel" (shard_map all_to_all)
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    expand: int = 2
    # hybrid (RG-LRU + local attention)
    attn_period: int = 0  # every attn_period-th block is local attention
    local_window: int = 0
    lru_width: int = 0  # 0 -> d_model
    # audio (enc-dec) / vlm frontends (stubs provide embeddings)
    encoder_layers: int = 0
    encoder_seq: int = 0
    n_patches: int = 0
    vision_dim: int = 0
    max_position: int = 8192  # learned-positional models only (audio)
    # misc
    tie_embeddings: bool = False
    scan_unroll: bool = False  # unroll layer scans (dry-run cost extraction)
    dtype: str = "bfloat16"
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_subquadratic(self) -> bool:
        """Can this config decode a 500k context? (constant/windowed state)"""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense-family archs run long_500k via the sliding-window variant
        return self.family in ("dense", "moe", "vlm")

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (CPU friendly)."""
        small = dict(
            n_layers=2,
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            max_position=512,
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=128,
                         dense_d_ff=256,
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            small.update(ssm_state=8)
        if self.attn_period:
            small.update(attn_period=self.attn_period, local_window=64, lru_width=128)
        if self.encoder_layers:
            small.update(encoder_layers=2, encoder_seq=64)
        if self.n_patches:
            small.update(n_patches=16, vision_dim=64)
        if self.sliding_window:
            small.update(sliding_window=64)
        small.update(decode_window=128)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
# configs the port runs and the reference has no counterpart of; kept out
# of list_configs(), which mirrors the reference's registry
_PORT_ONLY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def register_port_only(name: str):
    """Register a config that only the port has (``get_config`` finds it
    after the shared table; ``list_configs`` does not list it)."""
    def deco(fn):
        _PORT_ONLY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY and name not in _PORT_ONLY:
        from repro_torch import configs as _c  # ensure submodules imported
    for table in (_REGISTRY, _PORT_ONLY):
        if name in table:
            return table[name]()
    raise KeyError(f"unknown arch {name!r}; have "
                   f"{sorted(_REGISTRY) + sorted(_PORT_ONLY)}")


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
