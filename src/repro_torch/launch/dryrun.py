"""Dry run on the meta device: every (arch x shape x world) builds and runs.

Port of the part of ``repro.launch.dryrun`` that has a torch meaning. For
each combination this module:

  1. builds meta stand-ins for params, optimizer state (``sgd``), inputs
     (``registry.input_specs``) and caches (``init_cache``): shapes and
     dtypes, no memory;
  2. runs the step's model part on the meta device under
     ``torch.utils.flop_counter.FlopCounterMode``: the plain train step
     (``value_and_grad`` and the SGD update) for a train shape,
     ``make_prefill_step`` for prefill, ``make_serve_step`` for decode;
  3. adds the uplink's HBM bytes for a train shape with an uplink from
     ``roofline.transport_traffic`` (the PHY itself does not run on meta);
  4. returns (and with ``out_dir`` writes) a JSON record.

The world is the port's data-parallel group: every rank holds the whole
model (nothing shards a tensor) and ``global_batch / world`` rows of the
batch, or the whole batch where it does not split (the reference
replicates such a batch). A rank's step is run as a world of one on its
rows, so a moe config runs its dense dispatch here: expert parallelism
moves tokens between ranks and changes no FLOP count.

The record keeps the reference's keys where they mean something:
``status``, ``reason``, ``flops_per_device``, ``memory.argument_bytes`` and
``memory.output_bytes`` (per rank), ``wire_dtype``, ``overrides`` and
``reduced_layers``; ``world`` replaces ``n_chips``. Left out, because
only XLA gives them: ``lower_s`` and ``compile_s``, ``memory.temp_bytes``
and ``peak_bytes``, ``bytes_per_device`` (``cost_analysis``),
``collective_bytes_per_device`` (``parse_collectives`` of the post-SPMD
HLO), the TPU meshes and ``--fsdp``. No ``XLA_FLAGS`` are set.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --world 1,8 --out artifacts/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core import channel as channel_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.launch import roofline
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry as R
from repro_torch.optim.sgd import sgd as make_sgd

__all__ = ["run_one", "default_uplink", "main"]

META = torch.device("meta")


def _nbytes(tree) -> int:
    leaves, _ = transport_lib.tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _rows(shape, world: int) -> int:
    """A rank's rows of the global batch."""
    b = shape.global_batch
    return b // world if b % world == 0 else b


def _meta_inputs(cfg, shape, rows: int) -> dict:
    return {k: torch.empty((rows,) + tuple(s.shape[1:]), dtype=s.dtype,
                           device=META)
            for k, s in R.input_specs(cfg, shape).items()}


def _run_step(cfg, shape, world: int):
    """``(args, outputs, flops)`` of one rank's step on the meta device."""
    rows = _rows(shape, world)
    params = R.init_params(prng.PRNGKey(0, device=META), cfg)
    inputs = _meta_inputs(cfg, shape, rows)
    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        opt = make_sgd(1e-2)
        opt_state = opt.init(params)
        key = torch.empty((2,), dtype=torch.int64, device=META)
        step = steps_lib.make_train_step(cfg, opt)
        with counter:
            out = step(params, opt_state, inputs, key)
        args = (params, opt_state, inputs, key)
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg)
        with counter:
            out = step(params, inputs)
        args = (params, inputs)
    else:  # decode
        ring = R.uses_ring_cache(cfg, shape)
        clen = R.cache_len_for(cfg, shape)
        cache = R.init_cache(cfg, rows, clen, device=META)
        # the port's decode takes the position as a Python int: the
        # cache's last slot, an int32 scalar among the arguments
        pos = torch.empty((), dtype=torch.int32, device=META)
        step = steps_lib.make_serve_step(cfg, ring=ring)
        with torch.no_grad(), counter:
            out = step(params, cache, inputs["tokens"], clen - 1)
        args = (params, cache, inputs["tokens"], pos)
    return args, out, float(counter.get_total_flops())


def _reduce_depth(cfg, reduced_layers: int):
    over = {"n_layers": reduced_layers}
    if cfg.encoder_layers:
        over["encoder_layers"] = reduced_layers
    if cfg.first_dense_layers:
        over["first_dense_layers"] = min(cfg.first_dense_layers, 1)
    return dataclasses.replace(cfg, **over)


def run_one(arch: str, shape_name: str, world: int = 1,
            uplink: str | None = None, out_dir: str | None = None,
            reduced_layers: int = 0, overrides: dict | None = None,
            wire_dtype: str = "float32") -> dict:
    """One (arch, shape, world) on the meta device; returns its record
    (``status`` ``ok`` or ``skip`` with the ``supports_shape`` reason)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if reduced_layers:
        cfg = _reduce_depth(cfg, reduced_layers)
    shape = INPUT_SHAPES[shape_name]
    uplink = uplink or default_uplink(arch, shape_name)
    ok, reason = R.supports_shape(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "world": world, "uplink": uplink,
        "reduced_layers": reduced_layers, "status": "skip", "reason": reason,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "wire_dtype": wire_dtype,
    }
    if not ok:
        print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        return rec
    args, out, flops = _run_step(cfg, shape, world)
    rec.update(
        status="ok",
        flops_per_device=flops,
        model_flops=roofline.model_flops(cfg, shape),
        memory={"argument_bytes": _nbytes(list(args)),
                "output_bytes": _nbytes(list(out) if isinstance(out, tuple)
                                        else out)},
    )
    if shape.kind == "train" and uplink != "none":
        tcfg = transport_lib.TransportConfig(
            mode="approx", channel=channel_lib.ChannelConfig(snr_db=10.0),
            wire_dtype=wire_dtype)
        n = sum(t.numel() for t in transport_lib.tree_flatten(args[0])[0])
        rec["uplink_traffic"] = roofline.transport_traffic(tcfg, 1,
                                                           n_floats=n)
    print(f"[dryrun] OK {arch} x {shape_name} x world {world} "
          f"(uplink={uplink}, L={reduced_layers or cfg.n_layers}): "
          f"args {rec['memory']['argument_bytes'] / 2**30:.2f} GiB/rank, "
          f"flops/rank {flops:.3g}, model flops {rec['model_flops']:.3g}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__w{world}__{uplink}"
        if reduced_layers:
            tag += f"__L{reduced_layers}"
        for k, v in (overrides or {}).items():
            tag += f"__{k}-{v}"
        if wire_dtype != "float32":
            tag += f"__wire-{wire_dtype}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def default_uplink(arch: str, shape_name: str) -> str:
    """The reference's choice: no uplink off a train shape; kimi-k2's
    weights cannot replicate over the client axes, so it takes the
    per-shard uplink; every other arch the per-client one."""
    if INPUT_SHAPES[shape_name].kind != "train":
        return "none"
    return "per_shard" if arch == "kimi-k2-1t-a32b" else "per_client"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--world", default="1",
                    help="comma-separated data-parallel world sizes")
    ap.add_argument("--uplink", default=None,
                    choices=[None, "none", "per_client", "per_shard"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--reduced-layers", type=int, default=0,
                    help="override layer count")
    ap.add_argument("--moe-impl", default="",
                    choices=["", "dense", "expert_parallel"])
    ap.add_argument("--attn-impl", default="",
                    choices=["", "naive", "blockwise"])
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    overrides = {}
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    worlds = [int(w) for w in args.world.split(",")]

    failures = []
    for arch in archs:
        for shape in shapes:
            for world in worlds:
                try:
                    run_one(arch, shape, world, args.uplink, args.out,
                            args.reduced_layers, overrides or None,
                            args.wire_dtype)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, world, repr(e)))
                    print(f"[dryrun] FAIL {arch} x {shape} x world {world}: "
                          f"{e}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
