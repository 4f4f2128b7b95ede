"""Uplink traffic model and model-FLOP counts (port of the parts of
``repro.launch.roofline`` that are functions of shapes).

``uplink_traffic`` counts HBM bytes per payload float for the three
uplink paths, as the reference does; the seconds use the NVIDIA H100
SXM's HBM3 rate (``HBM_BW``, 3.35 TB/s on the data sheet), not the TPU
v5e constants of the reference. ``n_active_params`` and ``model_flops``
count parameters on the meta device (the reference's ``jax.eval_shape``),
and ``extrapolate`` is the reference's arithmetic on two reduced-depth
records. ``load_artifacts`` and ``analyze`` read XLA dry-run artifacts
and have no torch meaning.

MODEL_FLOPS, the useful-compute yardstick:
    train:  6 * N_active * tokens      decode/prefill: 2 * N_active * tokens
"""

from __future__ import annotations

__all__ = ["HBM_BW", "uplink_traffic", "transport_traffic",
           "n_active_params", "model_flops", "extrapolate"]

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

HBM_BW = 3.35e12  # B/s, NVIDIA H100 SXM (HBM3), data sheet

_WIRE_BITS = {"float32": 32, "bfloat16": 16}


def uplink_traffic(num_clients: int, *, bits_per_symbol: int = 2,
                   wire_dtype: str = "float32",
                   n_floats: int | None = None) -> dict:
    """Analytic HBM bytes per payload float for one full round.

    Per payload float with ``wb``-bit wire words and ``n_sym = wb / k``
    symbols, the layered pipeline materializes:

        wire words in+out (r/w each)      4 * wb/8
        tx symbol indices, int32 (w+r)    8 * n_sym
        complex64 channel stream (w+r)   16 * n_sym
        equalized stream (read)           8 * n_sym
        rx symbol indices, int32 (w+r)    8 * n_sym
        ------------------------------------------
        uplink total             wb/2 + 40 * n_sym   (= 656 B at QPSK f32)

    The batch kernel (K1) reads 4 B and writes 4 B per float; the fused
    kernel (K2) writes each aggregate word once for all C clients
    (4 + 4/C). The unfused paths add the aggregation pass (4 + 4/C).
    These are the reference's counts (its layered stream is int32 /
    complex64); the port's layered PHY holds int64 words, so it moves more.

    Returns bytes/float per path, ratios vs the fused kernel, and — with
    ``n_floats`` — memory-bound seconds per round at ``HBM_BW`` (H100).
    """
    wb = _WIRE_BITS[wire_dtype]
    c = float(num_clients)
    n_sym = wb / bits_per_symbol
    layered_uplink = wb / 2.0 + 40.0 * n_sym
    agg_pass = 4.0 + 4.0 / c  # read x_hat + amortized aggregate write
    bpf = {
        "jnp_layered": layered_uplink + agg_pass,
        "kernel_batch": 8.0 + agg_pass,
        "kernel_fused": 4.0 + 4.0 / c,
    }
    out = {
        "num_clients": num_clients,
        "bits_per_symbol": bits_per_symbol,
        "wire_dtype": wire_dtype,
        "bytes_per_float": bpf,
        "ratio_vs_fused": {k: v / bpf["kernel_fused"] for k, v in bpf.items()},
    }
    if n_floats is not None:
        out["hbm_s"] = {k: num_clients * n_floats * v / HBM_BW
                        for k, v in bpf.items()}
    return out


def transport_traffic(cfg, num_clients: int,
                      n_floats: int | None = None) -> dict:
    """:func:`uplink_traffic` with the modulation order and wire dtype of a
    ``repro_torch.core.transport.TransportConfig``."""
    return uplink_traffic(num_clients,
                          bits_per_symbol=cfg.scheme.bits_per_symbol,
                          wire_dtype=cfg.wire_dtype, n_floats=n_floats)


def _leaves_with_keystr(tree, prefix: str = ""):
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order
    (dict keys sorted, list items in order), each path spelled as
    ``jax.tree_util.keystr`` spells it: ``['layers']['attn']['wq']``,
    ``['tail'][0]['rec']['w_x']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keystr(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_keystr(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def n_active_params(cfg) -> tuple[float, float]:
    """``(active, total)`` parameter counts, MoE-aware, incl. lm_head, from
    the parameter shapes built on the meta device (no memory). Embedding
    tables (not positional) are gathered, not multiplied, so they are not
    active; an expert leaf counts ``top_k / n_experts`` of itself (a
    config holding a share of the experts, ``n_experts_held`` of
    ``n_experts``, so counts each held expert at its expected evaluations
    a token; the MLA leaves count whole). Summed
    as float64 in the reference's leaf order, so the floats are equal."""
    from repro_torch.core import prng
    from repro_torch.models import registry as R

    shapes = R.init_params(prng.PRNGKey(0, device="meta"), cfg)
    total = active = 0.0
    for path, leaf in _leaves_with_keystr(shapes):
        pstr = path.lower()
        n = 1.0
        for s in leaf.shape:
            n *= s
        total += n
        if "embed" in pstr and "pos" not in pstr:
            continue  # gather, not matmul
        if "moe" in pstr and "router" not in pstr and "shared" not in pstr:
            # stacked (L, E, ...): only top_k of E experts fire per token
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return active, total


def model_flops(cfg, shape) -> float:
    """``6 * N_active * tokens`` for a train shape, ``2 * N_active *
    tokens`` for prefill and decode (one token a sequence)."""
    act, _ = n_active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * act * tokens


def _body_counts(cfg, k: int):
    """Layers contributing to the extrapolation at reduced depth k."""
    nd = cfg.first_dense_layers
    return k - nd if nd else k


def extrapolate(cfg, r1, r2, full_layers: int):
    """Linear extrapolation of per-device costs to the full depth, from
    two records at ``reduced_layers`` depths: ``delta = (c2 - c1) / (k2 -
    k1)``, ``total(L) = c1 + (L - k1) * delta``."""
    k1 = _body_counts(cfg, r1["reduced_layers"])
    k2 = _body_counts(cfg, r2["reduced_layers"])
    L = _body_counts(cfg, full_layers)
    out = {}
    for key in ("flops_per_device", "bytes_per_device"):
        c1, c2 = r1[key], r2[key]
        d = (c2 - c1) / (k2 - k1)
        out[key] = c1 + (L - k1) * d
    coll = {}
    for kind in list(_COLL_KINDS) + ["_total"]:
        c1 = r1["collective_bytes_per_device"].get(kind, 0.0)
        c2 = r2["collective_bytes_per_device"].get(kind, 0.0)
        d = (c2 - c1) / (k2 - k1)
        coll[kind] = max(0.0, c1 + (L - k1) * d)
    out["collective_bytes_per_device"] = coll
    return out
