"""Driver of the MLA moe cells: FedSGD steps of Kimi K2 as published, on
one expert-parallel rank's share (``configs/kimi-k2-instruct.json``),
through ``launch/steps.py::make_train_step_approx`` as
``launch/train.py::main`` builds it: a world of one, SGD, the
approximate uplink on the kernel path, closed loop, each step ending in a
synchronise (``float(loss)``).

It is ``drivers/llm_train_approx.py``'s loop (and reuses its sample of
the row, its per-leaf places, its K0 chain and its step keys) with four
differences:

* the configuration is read under the published config's own keys and
  mapped onto the port's port-only ``kimi-k2-instruct``
  (:func:`program_config`). That config lives in a table of its own
  (``configs/base.py::register_port_only``): the shared configs stay field
  for field equal to the JAX package's, which has no MLA, no sigmoid
  router and no held-expert layer. The correction bias is drawn from the
  run's seed (``router_bias_seed``);
* the reference is ``reference/kimi_k2.py``, and the gradients are
  compared by unit: each layer of a stacked leaf, and each held expert of
  each layer of an expert leaf, so that one layer's or one expert's fault
  is not averaged away in a stack of them;
* a traced run keeps, beside the approx step's spans, the spans ``mla``,
  ``moe`` and ``experts`` (``models/transformer.py``; each sums forward,
  recomputation and backward) and, per step and MoE layer, the counters
  ``moe_assignments_held`` and ``moe_max_expert_load`` (``obs/spans.py``'s
  ``counting``), read after the step's loss read;
* the faults of this model: ``bias_ignored`` (the program selects by the
  scores alone), ``softmax_router`` (a softmax in place of the sigmoid),
  ``no_yarn`` (plain RoPE frequencies and a ``192^-0.5`` scale) and
  ``capacity_drop`` (capacity factor 1.5 with drops), beside ``control``
  (the reference's gradients in float8 e4m3 in the program's place),
  ``half_batch``, ``state_unchanged`` and ``answer_altered``.

An MLA moe run keeps two copies of the weights (5.6 GB each at the
published widths) in host memory for its comparison, as the LLM driver
does. The comparison also notes (not compared) the share of the routed
selections that the correction bias changes and the held experts' largest
load over the capacity a dropping router would give them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.core import compare
from portbench.core import mla_moe_flops
from portbench.core import roofline
from portbench.core import trace as trace_lib
from portbench.core.bench import Checks, log
from portbench.drivers.llm_train_approx import (_checksums, _k0_reference,
                                                _leaf_samples, _like, _Sample,
                                                _step_keys, _leaves,
                                                _program_transport)
from portbench.reference import kimi_k2 as ref
from portbench.reference import phy_tile
from portbench.reference import threefry
from portbench.traffic.tokens import TokenStream

__all__ = ["run", "judge", "program_config", "reference_config", "units",
           "FAULTS"]

# the program's config as each fault plants it
FAULTS = {"bias_ignored": {"router_bias_std": 0.0},
          "softmax_router": {"scoring_func": "softmax"},
          "no_yarn": {"rope_factor": 1.0},
          "capacity_drop": {"dropless": False, "capacity_factor": 1.5}}

# settings the port runs and no other (checked, not mapped)
_FIXED = {"hidden_act": "silu", "topk_method": "noaux_tc", "n_group": 1,
          "topk_group": 1, "norm_topk_prob": True, "attention_bias": False,
          "scoring_func": "sigmoid", "num_nextn_predict_layers": 0,
          "moe_layer_freq": 1, "rms_norm_eps": 1e-6}


def reference_config(config: dict) -> dict:
    """The configuration file with its ``assumed`` sizes at the top level,
    as the reference reads it."""
    return {**config, **config.get("assumed", {})}


def program_config(config: dict, seed: int = 0, fault: str | None = None):
    """The port's ``kimi-k2-instruct`` with the file's published keys, the
    seed's correction bias and a planted fault's change. Raises
    ``KeyError`` where the port has no such config and ``ValueError`` for
    a setting the port does not run."""
    from repro_torch.configs import get_config

    m = reference_config(config)
    for k, v in _FIXED.items():
        if m[k] != v:
            raise ValueError(f"{k} = {m[k]!r}: the port runs {v!r} only")
    r = m["rope_scaling"]
    cfg = dataclasses.replace(
        get_config(m["name"]),
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        vocab_size=m["vocab_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], q_lora_rank=m["q_lora_rank"],
        kv_lora_rank=m["kv_lora_rank"],
        qk_nope_head_dim=m["qk_nope_head_dim"],
        qk_rope_head_dim=m["qk_rope_head_dim"], v_head_dim=m["v_head_dim"],
        rope_theta=float(m["rope_theta"]), rope_factor=float(r["factor"]),
        rope_original_max_position=r["original_max_position_embeddings"],
        rope_beta_fast=float(r["beta_fast"]),
        rope_beta_slow=float(r["beta_slow"]), rope_mscale=float(r["mscale"]),
        rope_mscale_all_dim=float(r["mscale_all_dim"]),
        first_dense_layers=m["first_k_dense_replace"],
        dense_d_ff=m["intermediate_size"], n_experts=m["n_routed_experts"],
        n_experts_held=m["n_experts_held"],
        expert_offset=m.get("expert_offset", 0),
        top_k=m["num_experts_per_tok"], moe_d_ff=m["moe_intermediate_size"],
        n_shared_experts=m["n_shared_experts"],
        routed_scaling_factor=float(m["routed_scaling_factor"]),
        router_bias_std=float(m["router_bias_std"]), router_bias_seed=seed,
        aux_loss_coef=float(m["seq_aux_alpha"]),
        tie_embeddings=m["tie_word_embeddings"], dtype=m["dtype"])
    if fault in FAULTS:
        cfg = dataclasses.replace(cfg, **FAULTS[fault])
    return cfg


def units(leaves: list, names: list) -> tuple:
    """The comparison's units of a tree's leaves (sorted-key order):
    ``(views, names)``, a view ``(n, size)`` a leaf whose rows are its
    units: each layer of a stacked leaf (``dense_layers.*``,
    ``layers.*``), each layer and held expert of an expert leaf
    (``layers.moe.wi`` / ``wg`` / ``wo``), the leaf itself otherwise."""
    views, out_names = [], []
    for t, n in zip(leaves, names):
        if n in ("layers.moe.wi", "layers.moe.wg", "layers.moe.wo"):
            v = t.reshape(t.shape[0] * t.shape[1], -1)
        elif n.startswith(("dense_layers.", "layers.")):
            v = t.reshape(t.shape[0], -1)
        else:
            v = t.reshape(1, -1)
        views.append(v)
        out_names += [f"{n}[{i}]" for i in range(v.shape[0])]
    return views, out_names


# the integer view of a leaf dtype, for word-for-word compares
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _take_by_leaf(sample: _Sample, leaves) -> list:
    """The sampled words of each leaf, in the leaf's dtype, on the host
    (the router is float32 beside bfloat16 leaves)."""
    return [l.reshape(-1)[i].cpu() for l, i in zip(leaves, sample.per_leaf)]


def _apply_differ(before: list, after: list, received: torch.Tensor,
                  lr: float) -> int:
    """Sampled words unlike ``dtype(p - lr * g)``, leaf by leaf, with ``g``
    the received float32 words in row order."""
    n, off = 0, 0
    for pb, pa in zip(before, after):
        g = received[off:off + pb.numel()]
        off += pb.numel()
        want = (pb.to(torch.float32) - lr * g.to(torch.float32)).to(pa.dtype)
        n += int((want.view(_BITS[pa.dtype]) != pa.view(_BITS[pa.dtype]))
                 .sum())
    return n


def _unit_norms(views) -> list:
    return [float(x) for v in views for x in torch.linalg.vector_norm(
        v.detach().to(torch.float64), dim=1)]


def _unit_take(views, at) -> list:
    rows = [r for v in views for r in v.unbind(0)]
    return [r[i.to(r.device)].cpu() for r, i in zip(rows, at)]


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None) -> dict:
    """One run of an MLA moe cell (see the module docstring)."""
    # the config first: a program without it fails here, before any weight
    cfg = program_config(cell.config, seed, fault)
    from repro_torch.core import aggregation as agg_lib
    from repro_torch.core import prng
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import registry as R
    from repro_torch.obs import spans
    from repro_torch.optim.sgd import sgd as make_sgd

    log(t_start, "imported")
    traffic, spec = cell.traffic, cell.spec
    model = reference_config(cell.config)
    link = traffic["link"]
    dev = torch.device(device)
    lr = traffic["lr"]
    opt = make_sgd(lr)
    key = prng.PRNGKey(seed, device=dev)
    params = R.init_params(key, cfg)
    opt_state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, traffic["seq_len"], traffic["batch"],
                         seed=seed)
    step = steps_lib.make_train_step_approx(
        cfg, opt, _program_transport(link), world_mesh(None))
    leaves = _leaves(params)
    names = ref.leaf_names(params)
    log(t_start, "weights made")
    sample = _Sample(seed, [l.numel() for l in leaves],
                     spec["sample_tiles"], link["block_words"], dev)
    views, unit_names = units(leaves, names)
    grad_at = _leaf_samples(seed, [v.shape[1] for v in views
                                   for _ in range(v.shape[0])],
                            spec["grad_samples"], dev)
    n_check = traffic["check_steps"]
    prog = {"init": _checksums(leaves), "loss": [], "grad_norms": [],
            "grad_samples": [], "grad_at": [i.cpu() for i in grad_at],
            "sent": [], "received": [], "stats": [], "unit_names": unit_names,
            "batches": [], "p_before": [], "p_after": [], "states": []}

    orig_allreduce = agg_lib.approx_allreduce
    now = {}
    # the next batch is drawn while the device runs the step's tail (K0 and
    # the update), as a data loader prefetches: the stream's 4,096-position
    # loop takes 60-100 ms of host time a batch
    pending = [stream.next_batch()]

    def observed_allreduce(local_grads, key, cfg_, group=None):
        if fault == "control":
            local_grads = _control_grads(local_grads, now["params"],
                                         now["batch"], model, seed)
        g = _leaves(local_grads)
        gv, _ = units(g, names)
        prog["grad_norms"].append(_unit_norms(gv))
        prog["grad_samples"].append(_unit_take(gv, grad_at))
        prog["sent"].append(sample.take(g))
        out, stats = orig_allreduce(local_grads, key, cfg_, group)
        if fault == "answer_altered":
            first = _leaves(out)[0]
            first.view(-1)[0] = first.view(-1)[0] * 4.0 + 1.0
        prog["received"].append(sample.take(_leaves(out)))
        prog["stats"].append((float(stats.data_symbols), float(stats.n_bits)))
        return out, stats

    def one_step(params, opt_state):
        nonlocal key
        batch = pending[0]
        fed = batch
        if fault == "half_batch":
            half = batch["tokens"].shape[0] // 2
            fed = {k: v[:half] for k, v in batch.items()}
        ks = prng.split(key)
        key, sk = ks[0], ks[1]
        now.update(params=params, batch=fed)
        new, new_state, loss, _ = step(params, opt_state, fed, sk)
        now.clear()
        pending[0] = stream.next_batch()
        if fault == "state_unchanged":
            new = params
        return new, new_state, float(loss), batch, sk

    agg_lib.approx_allreduce = observed_allreduce
    try:
        for i in range(n_check):
            prog["p_before"].append(_take_by_leaf(sample, _leaves(params)))
            params, opt_state, loss, batch, sk = one_step(params, opt_state)
            prog["loss"].append(loss)
            prog["p_after"].append(_take_by_leaf(sample, _leaves(params)))
            prog["batches"].append({k: np.array(v) for k, v in batch.items()})
            if i + 1 < n_check:
                prog["states"].append([l.cpu() for l in _leaves(params)])
    finally:
        agg_lib.approx_allreduce = orig_allreduce

    log(t_start, f"{n_check} check steps run")
    tokens_per_step = traffic["batch"] * traffic["seq_len"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_w0 = time.perf_counter()
    close = t_w0 + seconds
    done, span_log, count_log, t_last = [], [], [], t_w0
    while time.perf_counter() < close:
        t0 = time.perf_counter()
        if trace:
            with spans.collect(dev) as parts, spans.counting(dev) as counts:
                params, opt_state, _, _, _ = one_step(params, opt_state)
            span_log.append(dict(parts))
            count_log.append(dict(counts))
        else:
            params, opt_state, _, _, _ = one_step(params, opt_state)
        t1 = time.perf_counter()
        if t1 <= close:
            done.append(t1 - t0)
            t_last = t1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(t_start, f"window closed ({len(done)} steps in it)")
    out = {"attempted": len(done), "failed": 0, "peak_bytes": peak}
    span = t_last - t_w0 if done else seconds
    out["end_to_end"] = {
        "llm_tokens_per_s": (len(done) * tokens_per_step / span, "tokens/s"),
        "peak_mem_gib": (peak / 2**30, "GiB"),
        "setup_s": (t_w0 - t_start, "s"),
    }
    if trace:
        summary = None
        if dev.type == "cuda":
            with trace_lib.profiled(dev) as tr:
                for _ in range(spec["profile_steps"]):
                    params, opt_state, _, _, _ = one_step(params, opt_state)
            summary = trace_lib.summarize(tr)
            log(t_start, "trace read")
        n_words = sum(l.numel() for l in leaves)
        out["records"] = {
            "window_s": span,
            "steps": [{"dur_s": d, "spans": s, "counters": c}
                      for d, s, c in zip(done, span_log, count_log)],
            "step_flops": mla_moe_flops.train_flops(model, tokens_per_step),
            "expert_flops_per_assignment":
                mla_moe_flops.expert_flops_per_assignment(model),
            "profile": summary,
            "k0_bound_ms": roofline.kernel_bound(
                1, roofline.padded_words(n_words, link["block_words"]),
                link["bits_per_symbol"], link["fading"], 32,
                "k0")["bound_ms"],
        }
        if summary is not None:
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}

    del params, opt_state, step, leaves, views, now
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(prog, seed, model, link, lr, sample, spec, dev)
    log(t_start, "reference compared")
    return out


def _control_grads(local_grads, params, batch, model: dict, seed: int):
    """The control in the program's place: the reference's gradients with
    float8 e4m3 matmul operands at the program's parameters and batch, in
    the program's tree and leaf dtypes."""
    from repro_torch.core import transport as transport_lib

    leaves, treedef = transport_lib.tree_flatten(local_grads)
    dev = leaves[0].device
    tree = _like(_structure(params), iter(_leaves(params)))
    tok = torch.as_tensor(np.asarray(batch["tokens"]), device=dev)
    lab = torch.as_tensor(np.asarray(batch["labels"]), device=dev)
    _, grads = ref.loss_and_grads(tree, tok, lab,
                                  ref.correction_bias(seed, model, dev),
                                  model, precision="fp8")
    out = [g.to(l.dtype) for g, l in zip(grads, leaves)]
    del grads, tree
    if dev.type == "cuda":
        # the reference's float32 blocks, freed, would leave K0's 10 GiB
        # row no room in one piece
        torch.cuda.empty_cache()
    return transport_lib.tree_unflatten(treedef, out)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def judge(prog: dict, seed: int, model: dict, link: dict, lr: float,
          sample: _Sample, spec: dict, device) -> Checks:
    """The MLA moe cell's numbers, as ``llm_train_approx.judge`` takes
    them, with the gradients compared by unit (:func:`units`) against
    ``reference/kimi_k2.py``; the routing's notes (the share of
    selections the bias changes, the held loads over a capacity) as
    information."""
    c = Checks(spec["limits"])
    ref_params = ref.init_params(threefry.PRNGKey(seed, device=device), model)
    names = ref.leaf_names(ref_params)
    ref_leaves = ref.flat_leaves(ref_params)
    c.add("init_differ", sum(a != b for a, b in
                             zip(_checksums(ref_leaves), prog["init"])))
    bias = ref.correction_bias(seed, model, device)
    loss_gap = 0.0
    gaps, errs = [], []
    n = len(prog["loss"])
    for i in range(n):
        if i > 0:
            ref_leaves = [t.to(device) for t in prog["states"][i - 1]]
            ref_params = _like(ref_params, iter(ref_leaves))
        b = prog["batches"][i]
        tok = torch.from_numpy(np.asarray(b["tokens"])).to(device)
        lab = torch.from_numpy(np.asarray(b["labels"])).to(device)
        if i == 0:
            for k, v in ref.routing_notes(ref_params, tok[0].long(), bias,
                                          model).items():
                c.add(k, v)
        loss, grads = ref.loss_and_grads(ref_params, tok, lab, bias, model)
        loss_gap = max(loss_gap, compare.rel_gap(prog["loss"][i], loss))
        if i < len(prog["grad_norms"]):
            gv, _ = units(grads, names)
            gaps.append(compare.leaf_gaps(prog["grad_norms"][i],
                                          _unit_norms(gv)))
            errs.append(compare.leaf_errs(prog["grad_samples"][i],
                                          _unit_take(gv, prog["grad_at"])))
            del gv
        del grads
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    c.add("loss_gap", loss_gap)
    if len(gaps) < n:
        gaps = errs = []
    compare.add_grad_checks(c, gaps, errs, prog["unit_names"])
    del ref_params, ref_leaves, bias
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    k0 = apply = 0
    keys = _step_keys(seed, n)
    for i in range(n):
        if i >= len(prog["sent"]):
            k0 += sample.valid.sum().item()
            continue
        rx = _k0_reference(prog["sent"][i], sample, keys[i], link, device)
        k0 += int((phy_tile.f32_to_bits(prog["received"][i]) != rx).sum())
        apply += _apply_differ(prog["p_before"][i], prog["p_after"][i],
                               prog["received"][i], lr)
    c.add("k0_words_differ", k0)
    c.add("apply_differ", apply)
    n_words = sample.n
    want = (float(np.float32(n_words * 32 // link["bits_per_symbol"])),
            float(np.float32(n_words * 32)))
    c.add("counts_differ", sum(s != want for s in prog["stats"])
          + abs(len(prog["stats"]) - n))
    return c
