"""The port's Kimi K2 (``configs/kimi_k2_instruct.py``: MLA with YaRN, the
sigmoid ``noaux_tc`` router, a held share of the routed experts, dropless)
against the benchmark's plain reference ``portbench/reference/kimi_k2.py``
on seeded random weights, at a small size on the CPU (d_model 64, 4 heads,
16 experts of which 4 held, top-4, a 512-row vocabulary slice).

The reference package has no such model, so the reference here is the
benchmark's. Float32 configs are held to float32 rounding; the bfloat16
config as the benchmark's comparison holds it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import compare, mla_moe_flops  # noqa: E402
from portbench.drivers import llm_mla_moe_train_approx as drv  # noqa: E402
from portbench.reference import kimi_k2 as ref  # noqa: E402
from portbench.reference import threefry  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.transport import tree_flatten  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

torch.set_num_threads(1)

SEED = 2**31 + 4099
PUBLISHED = json.loads(
    (ROOT / "portbench" / "configs" / "kimi-k2-instruct.json").read_text())


def tiny(**over) -> dict:
    """The published configuration file at a CPU test's widths."""
    c = json.loads(json.dumps(PUBLISHED))
    c.update(num_hidden_layers=3, hidden_size=64, intermediate_size=96,
             vocab_size=512, num_attention_heads=4, num_key_value_heads=4,
             q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
             qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=16,
             n_experts_held=4, num_experts_per_tok=4,
             moe_intermediate_size=16)
    assumed = dict(c["assumed"])
    for k in list(over):
        if k in assumed:
            assumed[k] = over.pop(k)
    c["assumed"] = assumed
    c.update(over)
    return c


def both(c: dict, seed=SEED):
    """``(port cfg, port params, reference cfg, reference params)``."""
    cfg = drv.program_config(c, seed)
    m = drv.reference_config(c)
    return (cfg, R.init_params(prng.PRNGKey(seed), cfg), m,
            ref.init_params(threefry.PRNGKey(seed), m))


def batch(vocab, B=2, S=24, seed=1):
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def rel(u, v) -> float:
    """Relative error in norm: float32 rounding gives about 1e-7 a step."""
    return float((u - v).double().norm() / v.double().norm().clamp_min(1e-30))


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


# ------------------------------------------------------------------ config


def test_config_is_port_only_and_published():
    cfg = TC.get_config("kimi-k2-instruct")
    assert isinstance(cfg, TC.base.ModelConfig) and cfg.family == "moe"
    assert "kimi-k2-instruct" not in TC.list_configs()
    assert "kimi-k2-instruct" not in TC.ARCH_IDS
    with pytest.raises(KeyError):
        TC.get_config("kimi-k2-instruct-no-such")
    # the benchmark's file, under the published keys, maps onto it
    assert drv.program_config(PUBLISHED, 0) == cfg
    assert (cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_head_dim, cfg.v_head_dim, cfg.n_experts, cfg.top_k,
            cfg.n_experts_held, cfg.moe_d_ff, cfg.dense_d_ff) == (
        7168, 64, 1536, 512, 192, 128, 384, 8, 8, 2048, 18432)


def test_parameter_counts_at_published_widths():
    """The meta device's tree against the benchmark's arithmetic:
    2,792,119,296 parameters, N_active with each held expert at 8/384."""
    from repro_torch.launch import roofline

    cfg = TC.get_config("kimi-k2-instruct")
    act, total = roofline.n_active_params(cfg)
    want_act, want_total = mla_moe_flops.param_counts(
        drv.reference_config(PUBLISHED))
    assert total == want_total == 2_792_119_296
    assert act == pytest.approx(want_act, rel=1e-12)
    assert want_act == 1_265_392_640


def test_decode_is_not_implemented():
    cfg = TC.get_config("kimi-k2-instruct").reduced()
    with pytest.raises(NotImplementedError):
        R.init_cache(cfg, 1, 8)
    with pytest.raises(NotImplementedError):
        R.decode_step({}, {}, torch.zeros((1, 1), dtype=torch.int32), 0, cfg)


# ------------------------------------------------------------------ YaRN


def test_yarn_against_the_closed_form():
    d, theta, s, L0 = 64, 5e4, 32.0, 4096
    inv = L.yarn_freqs(d, theta, s, L0, 1.0, 1.0)
    corr = d * math.log(L0 / (2 * math.pi)) / (2 * math.log(theta))
    assert corr == pytest.approx(19.16, abs=5e-3)
    low, high = math.floor(corr), math.ceil(corr)
    assert (low, high) == (19, 20)
    i = np.arange(d // 2)
    f_e = theta ** (-2.0 * i / d)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = f_e / s * ramp + f_e * (1 - ramp)
    np.testing.assert_allclose(inv.numpy(), want, rtol=2e-6)
    torch.testing.assert_close(inv, ref.yarn_inv_freq(
        drv.reference_config(PUBLISHED)), rtol=2e-6, atol=0)
    scale = L.yarn_softmax_scale(192, s, 1.0)
    assert scale == pytest.approx(192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2)
    assert scale == pytest.approx(0.13086, abs=5e-6)
    assert scale == ref.softmax_scale(drv.reference_config(PUBLISHED))
    # factor 1 is plain RoPE and a 192^-0.5 scale (the no_yarn fault)
    torch.testing.assert_close(L.yarn_freqs(d, theta, 1.0, L0, 1.0, 1.0),
                               L.rope_freqs(d, 1.0, theta))
    assert L.yarn_softmax_scale(192, 1.0, 1.0) == 192 ** -0.5


# ------------------------------------------------------------------ weights


def test_init_matches_the_reference_draw():
    cfg, p, m, r = both(tiny())
    pl, _ = tree_flatten(p)
    rl = ref.flat_leaves(r)
    assert ref.leaf_names(p) == ref.leaf_names(r)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(pl, rl))
    # the bias: the program's cache and the reference's draw
    torch.testing.assert_close(
        MOE.correction_bias(cfg, 2, "cpu"),
        ref.correction_bias(SEED, m), rtol=0, atol=0)


# ------------------------------------------------------------------ MLA


def test_mla_forward_and_gradients():
    cfg, p, m, r = both(tiny(dtype="float32"))
    w = ref.shapes(m)
    a = f32(p["layers"]["attn"])
    a = {k: v[0].clone().requires_grad_() for k, v in a.items()}
    x = torch.randn((24, 64), generator=torch.Generator().manual_seed(3))
    x.requires_grad_()
    pos = torch.arange(24, dtype=torch.int32)[None, :]
    out = MLA.attention(x[None], a, cfg, pos, MLA.rope_tables(cfg, "cpu"))[0]
    ar = {k: v.detach().clone().requires_grad_() for k, v in a.items()}
    xr = x.detach().clone().requires_grad_()
    want = ref._attention(xr, ar, w, ref._rope_tables(m, "cpu"), False)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad((out * g).sum(), [x] + list(a.values()))
    exp = torch.autograd.grad((want * g).sum(), [xr] + list(ar.values()))
    for u, v in zip(got, exp):
        assert rel(u, v) < 1e-5


# ------------------------------------------------------------------ router


def _router_inputs(cfg, seed=5, T=48):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, cfg.d_model), generator=g)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=g) * 0.2
    return x, router


def test_router_selection_with_the_bias_and_its_weights():
    cfg, _, m, _ = both(tiny())
    x, router = _router_inputs(cfg)
    bias = ref.correction_bias(SEED, m)[0]
    s, sel, w = MOE.route_noaux_tc(x, router, bias, cfg)
    rs, rsel, rw = ref.route(x, router, bias, m)
    assert torch.equal(torch.sort(sel, -1).values, torch.sort(rsel, -1).values)
    order = torch.argsort(sel, -1)
    rorder = torch.argsort(rsel, -1)
    torch.testing.assert_close(w.gather(1, order), rw.gather(1, rorder),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(w.sum(-1), torch.full((48,), 2.827),
                               rtol=1e-6, atol=0)
    # the bias changes selections: by the scores alone they differ
    plain = torch.topk(s, cfg.top_k, -1).indices
    assert not torch.equal(torch.sort(plain, -1).values,
                           torch.sort(sel, -1).values)


def test_balance_loss():
    cfg, _, m, _ = both(tiny())
    B, S = 3, 16
    x, router = _router_inputs(cfg, T=B * S)
    bias = ref.correction_bias(SEED, m)[1]
    s, sel, _ = MOE.route_noaux_tc(x, router, bias, cfg)
    got = MOE.seq_balance_loss(s, sel, B, S, cfg.n_experts)
    want = sum(ref.balance(s[b * S:(b + 1) * S], sel[b * S:(b + 1) * S],
                           cfg.n_experts) for b in range(B)) / B
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # uniform routing and scores give 1
    E, K = cfg.n_experts, cfg.top_k
    sel_u = (torch.arange(S * K) % E).reshape(1, S, K).reshape(S, K)
    assert float(MOE.seq_balance_loss(torch.ones((S, E)), sel_u, 1, S,
                                      E)) == pytest.approx(1.0)


# ------------------------------------------------------------------ experts


def _moe_params(cfg, seed=SEED):
    p = MOE.init_moe_held(prng.PRNGKey(seed), cfg, torch.float32)
    return p


def test_dropless_dispatch_under_a_skewed_router():
    """A router that sends most tokens to held expert 1: every assignment
    is computed (the counter equals the routed count) and the output is
    the reference's loop; with capacity 1.5 the same layer drops."""
    cfg, _, m, _ = both(tiny())
    p = _moe_params(cfg)
    p["router"][:, 1] += 0.5   # expert 1 (held) wins most tokens
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    bias = torch.zeros(cfg.n_experts)
    with spans.counting("cpu") as counts:
        out, aux = MOE.moe_ffn_held(x, p, cfg, bias, obs=spans.capture(),
                                    index=0)
    _, sel, _ = MOE.route_noaux_tc(x.reshape(-1, cfg.d_model), p["router"],
                                   bias, cfg)
    routed = int(((sel >= 0) & (sel < 4)).sum())
    loads = torch.bincount(sel.reshape(-1), minlength=16)[:4]
    cap = MOE.capacity(64, cfg)
    assert int(loads.max()) > cap, "the router is not skewed past capacity"
    assert counts["moe_assignments_held"] == [routed]
    assert counts["moe_max_expert_load"] == [int(loads.max())]
    w = ref.shapes(m)
    want = torch.stack([ref._moe_ffn(x[b], p, bias, w, m, False)[0]
                        for b in range(2)])
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    drop = dataclasses.replace(cfg, dropless=False)
    with spans.counting("cpu") as counts:
        out_d, _ = MOE.moe_ffn_held(x, p, drop, bias, obs=spans.capture(),
                                    index=0)
    assert counts["moe_assignments_held"][0] < routed
    assert counts["moe_max_expert_load"] == [cap]
    assert not torch.allclose(out_d, out)


def _share(cfg, offset):
    return dataclasses.replace(cfg, n_experts_held=4, expert_offset=offset)


def test_shares_add_up_to_the_uncut_layer():
    """Offsets 0, 4, 8, 12 of 16: the shares' outputs, with the shared
    expert counted once, add up to the layer holding all 16; so do the
    gradients of the input and the router, and each share's expert
    gradients are the uncut layer's for those experts."""
    cfg, _, m, _ = both(tiny())
    full = dataclasses.replace(cfg, n_experts_held=16, expert_offset=0)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 20, cfg.d_model), generator=g)
    up = torch.randn(x.shape, generator=g)
    bias = ref.correction_bias(SEED, m)[0]

    def run(c):
        p = {k: (v.requires_grad_() if torch.is_tensor(v) else
                 {kk: vv.requires_grad_() for kk, vv in v.items()})
             for k, v in _moe_params(c).items()}
        xx = x.clone().requires_grad_()
        out, aux = MOE.moe_ffn_held(xx, p, c, bias)
        gx, gr, gi, gsh = torch.autograd.grad((out * up).sum(), [
            xx, p["router"], p["wi"], p["shared"]["wi"]])
        shared = L.swiglu(x.reshape(-1, c.d_model), p["shared"]["wi"],
                          p["shared"]["wg"], p["shared"]["wo"])
        gsx = torch.autograd.grad((shared.reshape(x.shape) * up).sum(),
                                  [p["shared"]["wi"]])[0]
        return out.detach(), aux.detach(), gx, gr, gi, shared.detach(), gsx

    whole = run(full)
    parts = [run(_share(cfg, o)) for o in (0, 4, 8, 12)]
    shared = whole[5].reshape(x.shape)
    total = sum(p[0] for p in parts) - 3 * shared
    torch.testing.assert_close(total, whole[0], rtol=1e-5, atol=1e-5)
    for p in parts:   # the router, and so the balance loss, is every share's
        torch.testing.assert_close(p[1], whole[1], rtol=0, atol=0)
    # d(out . up)/dx of the shared expert alone, counted once
    xs = x.clone().requires_grad_()
    sp = _moe_params(cfg)["shared"]
    sh = L.swiglu(xs.reshape(-1, cfg.d_model), sp["wi"], sp["wg"], sp["wo"])
    gsh_x = torch.autograd.grad((sh.reshape(x.shape) * up).sum(), [xs])[0]
    torch.testing.assert_close(sum(p[2] for p in parts) - 3 * gsh_x,
                               whole[2], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(p[3] for p in parts), whole[3],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(torch.cat([p[4] for p in parts]), whole[4],
                               rtol=1e-5, atol=1e-7)
    for p in parts:
        torch.testing.assert_close(p[6], whole[6], rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ model


def test_loss_and_gradients_match_the_reference_float32():
    cfg, p, m, r = both(tiny(dtype="float32"))
    b = batch(cfg.vocab_size)
    loss, grads = steps.value_and_grad(cfg, p, b)
    bias = ref.correction_bias(SEED, m)
    rloss, rgrads = ref.loss_and_grads(r, b["tokens"], b["labels"], bias, m)
    assert float(loss) == pytest.approx(rloss, rel=1e-5)
    gl = tree_flatten(grads)[0]
    assert compare.worst(compare.leaf_gaps(compare.leaf_norms(gl),
                                           compare.leaf_norms(rgrads))) < 1e-4
    assert compare.worst(compare.leaf_errs(gl, rgrads)) < 1e-3


def test_loss_and_gradients_match_the_reference_bfloat16():
    cfg, p, m, r = both(tiny())
    b = batch(cfg.vocab_size)
    loss, grads = steps.value_and_grad(cfg, p, b)
    bias = ref.correction_bias(SEED, m)
    rloss, _ = ref.loss_and_grads(r, b["tokens"], b["labels"], bias, m)
    assert float(loss) == pytest.approx(rloss, rel=5e-3)
    assert all(torch.isfinite(g).all() for g in tree_flatten(grads)[0])


def test_spans_and_counters_cover_forward_recomputation_and_backward():
    cfg, p, m, _ = both(tiny())
    b = batch(cfg.vocab_size)
    with spans.record("cpu") as rec, spans.collect("cpu") as sums, \
            spans.counting("cpu") as counts:
        with spans.span("grad"):
            steps.value_and_grad(cfg, p, b)
    names = [s.name for s in rec.spans]
    # 3 layers' MLA and 2 MoE FFNs (with their experts), each forward,
    # recomputed and backward
    assert names.count("mla") == 9
    assert names.count("moe") == 6
    assert names.count("experts") == 6
    grad = names.index("grad")
    assert all(rec.spans[i].parent == grad
               for i, n in enumerate(names) if n in ("mla", "moe"))
    assert set(sums) >= {"grad", "mla", "moe", "experts"}
    assert sums["mla"] + sums["moe"] < sums["grad"]
    assert len(counts["moe_assignments_held"]) == 2
    assert all(0 < n <= 2 * 24 * cfg.top_k
               for n in counts["moe_assignments_held"])


def test_train_main_runs_kimi_k2_instruct():
    """``train.main --arch kimi-k2-instruct`` (the plain step here: K0's
    plain version over the reduced row takes half a minute a step on the
    CPU; the approx step runs in ``portbench/tests/test_portbench_kimi.py``
    through ``make_train_step_approx``)."""
    from repro_torch.launch import train

    seen = []
    loss = train.main(["--arch", "kimi-k2-instruct", "--reduced", "--steps",
                       "2", "--batch", "2", "--seq", "16", "--mode",
                       "perfect", "--device", "cpu"],
                      on_step=lambda i, l, s, ph: seen.append(ph))
    assert math.isfinite(loss)
    assert {"mla", "moe", "experts"} <= set(seen[0])
