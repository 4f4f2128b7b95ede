"""Driver of the LLM cells: FedSGD steps of a published decoder through
``launch/steps.py::make_train_step_approx``, built as
``launch/train.py::main`` builds it (a world of one, SGD, the approximate
uplink on the kernel path), closed loop: a step starts when the last one
ends, and each step ends in a synchronise (``float(loss)``, as the
driver's own loop reads it).

Set-up makes the weights on the card from ``PRNGKey(seed)``, the token
stream from the seed (the benchmark's copy of ``TokenStream``), builds the
step once and runs its first ``check_steps`` steps through it; those
steps warm every shape and are the ones the comparison reads. The window
then runs the same step on the next batches of the stream; the rate is
the tokens of the steps that end inside it over the time from its start
to the end of the last of them.

What the comparison needs of the check steps is taken as they run, by an
observer around ``core/aggregation.py::approx_allreduce`` (the uplink's
entry): each leaf's gradient norm as it goes on the wire, and the sent and
received words of a seeded sample of the row's tiles; the parameters at
the same places before and after each step; the losses; and the whole
parameters after steps 1 .. ``check_steps - 1``, kept on the host. The
reference runs after the window, with the program's state freed.

Faults for the comparison's own test are planted with ``fault=``; they
are never set by ``run.py``. ``fault="control"`` is the comparison's
control: the reference's gradients in float8 e4m3 (the step below the
configuration's bfloat16), at the program's parameters and batch, put in
the program's place on the wire.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.core import compare, roofline
from portbench.core import trace as trace_lib
from portbench.core.bench import Checks, log
from portbench.reference import phy_tile
from portbench.reference import qwen2 as qwen2_ref
from portbench.reference import threefry
from portbench.traffic.tokens import TokenStream

__all__ = ["run", "judge"]

_SAMPLE_STREAM = 0x5EED


def _program_config(model: dict):
    from repro_torch.configs import get_config

    base = get_config(model["arch"])
    fields = {k: v for k, v in model.items()
              if k in {f.name for f in dataclasses.fields(base)}}
    return dataclasses.replace(base, **fields)


def _program_transport(link: dict):
    from repro_torch.core import channel as channel_lib
    from repro_torch.core import transport as transport_lib

    return transport_lib.TransportConfig(
        mode=link["mode"], modulation=link["modulation"],
        channel=channel_lib.ChannelConfig(
            snr_db=link["snr_db"], fading=link["fading"],
            tx_power=link["tx_power"], distance=link["distance"],
            pathloss_exp=link["pathloss_exp"]),
        clamp_bound=link["clamp_bound"], simulate_fec=False,
        ecrt_expected_tx=1.1, use_kernel=link["use_kernel"])


def _leaves(tree):
    from repro_torch.core import transport as transport_lib

    return transport_lib.tree_flatten(tree)[0]


class _Sample:
    """A seeded sample of the uplink row's tiles (the first and last tile
    always in it) and, per leaf, the places of its sampled words."""

    def __init__(self, seed: int, sizes: list, n_tiles: int, bw: int, device):
        n = sum(sizes)
        total = -(-n // bw)
        rng = np.random.default_rng([seed % 2**63, _SAMPLE_STREAM])
        pick = rng.choice(total, size=min(n_tiles, total), replace=False)
        self.tiles = np.unique(np.concatenate([pick, [0, total - 1]]))
        self.bw, self.n = bw, n
        words = (self.tiles[:, None] * bw + np.arange(bw)[None, :]).reshape(-1)
        self.valid = torch.from_numpy(words < n)
        words = words[words < n]
        self.per_leaf, off = [], 0
        for size in sizes:
            lo, hi = np.searchsorted(words, [off, off + size])
            self.per_leaf.append(torch.from_numpy(words[lo:hi] - off).to(device))
            off += size

    def take(self, leaves) -> torch.Tensor:
        """The sampled words of a tree's leaves, in row order, on the host."""
        return torch.cat([l.reshape(-1)[i] for l, i in
                          zip(leaves, self.per_leaf)]).cpu()


def _leaf_samples(seed: int, sizes: list, per_leaf: int, device) -> list:
    """Seeded places in each leaf (all of a leaf no larger than
    ``per_leaf``) at which the gradients are compared element by element."""
    rng = np.random.default_rng([seed % 2**63, _SAMPLE_STREAM, 1])
    out = []
    for size in sizes:
        idx = (np.arange(size) if size <= per_leaf
               else np.sort(rng.choice(size, per_leaf, replace=False)))
        out.append(torch.from_numpy(idx).to(device))
    return out


def _checksums(leaves) -> list:
    return [(float(t.double().sum()), float((t.double() ** 2).sum()))
            for t in leaves]


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None) -> dict:
    """One run of an LLM cell (see the module docstring)."""
    from repro_torch.core import aggregation as agg_lib
    from repro_torch.core import prng
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import registry as R
    from repro_torch.obs import spans
    from repro_torch.optim.sgd import sgd as make_sgd

    log(t_start, "imported")
    traffic, spec, model = cell.traffic, cell.spec, cell.config["model"]
    link = traffic["link"]
    dev = torch.device(device)
    cfg = _program_config(model)
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
    log(t_start, "weights made")
    sample = _Sample(seed, [l.numel() for l in leaves],
                     spec["sample_tiles"], link["block_words"], dev)
    grad_at = _leaf_samples(seed, [l.numel() for l in leaves],
                            spec["grad_samples"], dev)
    n_check = traffic["check_steps"]
    prog = {"init": _checksums(leaves), "loss": [], "grad_norms": [],
            "grad_samples": [], "grad_at": [i.cpu() for i in grad_at],
            "sent": [], "received": [], "stats": [],
            "batches": [], "p_before": [], "p_after": [], "states": []}

    orig_allreduce = agg_lib.approx_allreduce
    now = {}

    def observed_allreduce(local_grads, key, cfg_, group=None):
        if fault == "control":
            local_grads = _control_grads(local_grads, now["params"],
                                         now["batch"], model)
        g = _leaves(local_grads)
        prog["grad_norms"].append(compare.leaf_norms(g))
        prog["grad_samples"].append(
            [l.reshape(-1)[i].cpu() for l, i in zip(g, grad_at)])
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
        batch = stream.next_batch()
        fed = batch
        if fault == "half_batch":
            half = batch["tokens"].shape[0] // 2
            fed = {k: v[:half] for k, v in batch.items()}
        ks = prng.split(key)
        key, sk = ks[0], ks[1]
        now.update(params=params, batch=fed)
        new, new_state, loss, _ = step(params, opt_state, fed, sk)
        now.clear()
        if fault == "state_unchanged":
            new = params
        return new, new_state, float(loss), batch, sk

    agg_lib.approx_allreduce = observed_allreduce
    try:
        for i in range(n_check):
            prog["p_before"].append(sample.take(_leaves(params)))
            params, opt_state, loss, batch, sk = one_step(params, opt_state)
            prog["loss"].append(loss)
            prog["p_after"].append(sample.take(_leaves(params)))
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
    done, span_log, t_last = [], [], t_w0
    while time.perf_counter() < close:
        t0 = time.perf_counter()
        if trace:
            with spans.collect(dev) as parts:
                params, opt_state, _, _, _ = one_step(params, opt_state)
            span_log.append(dict(parts))
        else:
            params, opt_state, _, _, _ = one_step(params, opt_state)
        t1 = time.perf_counter()
        if t1 <= close:
            done.append(t1 - t0)
            t_last = t1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(t_start, f"window closed ({len(done)} steps in it)")
    out = {"attempted": len(done), "failed": 0, "peak_bytes": peak}
    # the window runs from its start to the end of the last step that ends
    # inside it: every step completed, over the time they took
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
            "steps": [{"dur_s": d, "spans": s}
                      for d, s in zip(done, span_log)],
            "step_flops": roofline.train_flops(model, tokens_per_step),
            "profile": summary,
            "k0_bound_ms": roofline.kernel_bound(
                1, roofline.padded_words(n_words, link["block_words"]),
                link["bits_per_symbol"], link["fading"], 32,
                "k0")["bound_ms"],
        }
        if summary is not None:
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}

    del params, opt_state, step, leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(prog, seed, model, link, lr, sample, spec, dev)
    log(t_start, "reference compared")
    return out


def _control_grads(local_grads, params, batch, model: dict):
    """The control in the program's place: the reference's gradients in
    float8 e4m3 at the program's parameters and batch, in the program's
    tree and leaf dtypes."""
    from repro_torch.core import transport as transport_lib

    leaves, treedef = transport_lib.tree_flatten(local_grads)
    it = iter(_leaves(params))
    ref_params = _like(qwen2_ref.structure(model), it)
    tok = torch.as_tensor(np.asarray(batch["tokens"]),
                          device=leaves[0].device)
    lab = torch.as_tensor(np.asarray(batch["labels"]),
                          device=leaves[0].device)
    _, grads = qwen2_ref.loss_and_grads(ref_params, tok, lab, model,
                                        precision="fp8")
    return transport_lib.tree_unflatten(
        treedef, [g.to(l.dtype) for g, l in zip(grads, leaves)])


def _step_keys(seed: int, n: int) -> list:
    """The keys of the first ``n`` steps, from the seed: ``PRNGKey(seed)``,
    then ``key -> (key, step key)`` a step, as ``train.main`` splits it."""
    key, out = threefry.PRNGKey(seed), []
    for _ in range(n):
        ks = threefry.split(key)
        key = ks[0]
        out.append(ks[1])
    return out


def _k0_reference(sent: torch.Tensor, sample: _Sample, key, link: dict,
                  device) -> torch.Tensor:
    """The per-tile chain on the sampled tiles of a row whose words are
    ``sent`` (the program's, on the wire): the received words, as uint32
    values in ``int64``."""
    seed = int(threefry.randint(threefry.fold_in(key, 0), (), 0, 2**31 - 1)
               & threefry.M32)
    bw = sample.bw
    lsg = link["tx_power"] * link["distance"] ** (-link["pathloss_exp"])
    npow = np.float32(lsg / (10.0 ** (link["snr_db"] / 10.0)))
    words = torch.zeros(sample.valid.numel(), dtype=torch.float32)
    words[sample.valid] = sent
    u_all = phy_tile.f32_to_bits(words).reshape(-1, bw)
    tiles = torch.from_numpy(sample.tiles).to(torch.int64)
    s_per_word = 32 // link["bits_per_symbol"]
    out = []
    chunk = 1024
    for lo in range(0, len(tiles), chunk):
        u = u_all[lo:lo + chunk].to(device)
        t = tiles[lo:lo + chunk].to(device)
        base = ((t * (bw * s_per_word)) & threefry.M32)[:, None]
        u_hat = phy_tile.channel_tile(
            u, torch.tensor(seed, device=device).reshape(1, 1), base,
            torch.tensor(float(npow), device=device).reshape(1, 1),
            torch.tensor(float(np.float32(lsg)), device=device).reshape(1, 1),
            bits_per_symbol=link["bits_per_symbol"], fading=link["fading"],
            fade_block=link["fade_block"], block_words=bw)
        out.append((u_hat & int(link["clamp_mask"], 16)).cpu())
    return torch.cat(out).reshape(-1)[sample.valid]


def judge(prog: dict, seed: int, model: dict, link: dict, lr: float,
          sample: _Sample, spec: dict, device) -> Checks:
    """The LLM cell's numbers, following the program step by step: the
    weights at init (leaves whose checksums differ); each check step's loss,
    its gradient's norms by the worst leaf and its gradient at seeded places
    of each leaf (the worst leaf's error), against the reference at the
    program's parameters of that step (at its own weights for the first);
    K0's received words on the sampled tiles of the program's row (words
    that differ); the SGD update at the sampled places (words that
    differ); and the uplink's counts."""
    c = Checks(spec["limits"])
    ref_params = qwen2_ref.init_params(
        threefry.PRNGKey(seed, device=device), model)
    ref_leaves = qwen2_ref.flat_leaves(ref_params)
    c.add("init_differ", sum(a != b for a, b in
                             zip(_checksums(ref_leaves), prog["init"])))
    loss_gap = 0.0
    gaps, errs = [], []
    n = len(prog["loss"])
    for i in range(n):
        if i > 0:
            ref_leaves = [t.to(device) for t in prog["states"][i - 1]]
            it = iter(ref_leaves)
            ref_params = _like(ref_params, it)
        b = prog["batches"][i]
        tok = torch.from_numpy(np.asarray(b["tokens"])).to(device)
        lab = torch.from_numpy(np.asarray(b["labels"])).to(device)
        loss, grads = qwen2_ref.loss_and_grads(ref_params, tok, lab, model)
        loss_gap = max(loss_gap, compare.rel_gap(prog["loss"][i], loss))
        if i < len(prog["grad_norms"]):
            gaps.append(compare.leaf_gaps(prog["grad_norms"][i],
                                          compare.leaf_norms(grads)))
            errs.append(compare.leaf_errs(
                prog["grad_samples"][i],
                [g.reshape(-1)[at.to(g.device)].cpu()
                 for g, at in zip(grads, prog["grad_at"])]))
        del grads
    c.add("loss_gap", loss_gap)
    if len(gaps) < n:
        gaps = errs = []
    compare.add_grad_checks(c, gaps, errs, qwen2_ref.leaf_names(ref_params))
    del ref_params, ref_leaves
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
        want = (prog["p_before"][i].to(torch.float32)
                - lr * prog["received"][i].to(torch.float32)).to(
                    prog["p_after"][i].dtype)
        apply += int((want.view(torch.int16)
                      != prog["p_after"][i].view(torch.int16)).sum())
    c.add("k0_words_differ", k0)
    c.add("apply_differ", apply)
    n_words = sample.n
    want = (float(np.float32(n_words * 32 // link["bits_per_symbol"])),
            float(np.float32(n_words * 32)))
    c.add("counts_differ", sum(s != want for s in prog["stats"])
          + abs(len(prog["stats"]) - n))
    return c


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(tree[k], it) for k in sorted(tree)}
    return next(it)
