"""Kimi K2 as published (Kimi-K2-Instruct, arXiv:2507.20534; settings from
https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json),
cut to one expert-parallel rank's share. A port-only config.

Published: 61 layers, d_model 7,168, vocabulary 163,840, untied head,
RMSNorm eps 1e-6, SiLU; multi-head latent attention (MLA) with 64 heads,
``q_lora_rank`` 1,536, ``kv_lora_rank`` 512, ``qk_nope_head_dim`` 128,
``qk_rope_head_dim`` 64, ``v_head_dim`` 128; RoPE theta 50,000 with YaRN
(factor 32 over ``original_max_position_embeddings`` 4,096, beta_fast =
beta_slow = mscale = mscale_all_dim = 1); ``first_k_dense_replace`` 1 (a
dense SwiGLU of 18,432); 60 MoE layers of 384 routed experts of 2,048, 8 a
token, and 1 shared expert of 2,048; the router ``scoring_func`` sigmoid
with ``topk_method`` ``noaux_tc`` (one group), ``norm_topk_prob``,
``routed_scaling_factor`` 2.827 and the sequence-wise balance loss.

The cut (the deployment it stands for): each MoE layer's 384 experts lie
over 48 chips, 8 a chip (expert parallel); MLA, the dense layer, the
router (all 384 outputs) and the shared expert are whole on every chip
(data parallel); the embedding and the head are sliced over 8 chips
(vocabulary parallel); the layers left out lie on further pipeline
stages. This chip holds the dense layer and 4 MoE layers, experts 0-7 of
each, and 20,480 vocabulary rows: 2,792,119,296 parameters at the
published widths.

Why a port-only table: the reference package has no MLA, no sigmoid
router and no held-expert layer, and the shared configs stay field for
field equal to the reference's, so the extra settings live in the
subclass :class:`MLAMoEConfig` and the name stays out of ``list_configs``
and ``ARCH_IDS``.

Departures, each also in ``portbench/reference/kimi_k2.py``:

* the correction bias ``e_score_correction_bias`` is drawn from
  ``router_bias_seed`` at ``router_bias_std`` and held fixed (its
  load-based update is no gradient and not on the uplink);
* the balance loss weight alpha = 1e-4 is DeepSeek-V3's
  (arXiv:2412.19437 Sec. 2.1.2): the published config gives ``seq_aux``
  and no alpha;
* no multi-token prediction (``num_nextn_predict_layers`` is 0);
* norm scales are zero-centred (``1 + scale``) and the rotary embedding
  turns adjacent pairs, the port's conventions; the published code's
  de-interleave then rotate-half gives the same scores.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, register_port_only


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig(ModelConfig):
    """A moe config with MLA attention, YaRN, the ``noaux_tc`` router and
    a held share of the routed experts (the fields the shared
    :class:`ModelConfig` does not have)."""

    # multi-head latent attention
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN (rope_factor 1: plain RoPE and a qk_head_dim ** -0.5 scale)
    rope_factor: float = 1.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 1.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 1.0
    # router: "sigmoid" (noaux_tc, one group) or "softmax"
    scoring_func: str = "sigmoid"
    routed_scaling_factor: float = 1.0
    router_bias_std: float = 0.0
    router_bias_seed: int = 0
    # the routed experts this chip holds: [expert_offset, + n_experts_held)
    n_experts_held: int = 0
    expert_offset: int = 0
    dropless: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def reduced(self, **overrides) -> "MLAMoEConfig":
        """A CPU-sized MLA moe config: every width cut, the ratios kept
        (d_model 128, 4 heads, 16 experts of which 4 held, top-4,
        vocabulary 512); YaRN at the published factor and original
        length, so both sides of its ramp are present."""
        small = dict(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=0, vocab_size=512, q_lora_rank=32,
                     kv_lora_rank=16, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16, n_experts=16,
                     n_experts_held=4, expert_offset=0, top_k=4,
                     moe_d_ff=32, dense_d_ff=64, max_position=512,
                     decode_window=128)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@register_port_only("kimi-k2-instruct")
def config() -> MLAMoEConfig:
    return MLAMoEConfig(
        name="kimi-k2-instruct",
        family="moe",
        n_layers=5,               # 1 dense + 4 MoE of the published 61
        d_model=7168,
        n_heads=64,
        n_kv_heads=64,
        d_ff=0,
        vocab_size=20480,         # 1/8 of the published 163,840
        rope_theta=5e4,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_factor=32.0,
        rope_original_max_position=4096,
        n_experts=384,
        n_experts_held=8,         # experts 0-7 of 384
        top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        dense_d_ff=18432,
        first_dense_layers=1,
        scoring_func="sigmoid",
        routed_scaling_factor=2.827,
        router_bias_std=0.04,
        aux_loss_coef=1e-4,
        source="hf:moonshotai/Kimi-K2-Instruct",
    )
