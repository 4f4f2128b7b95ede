"""Training driver: FedSGD with the approximate wireless uplink (port of
``repro.launch.train``).

Runs a real training loop on the GPU (``--device cpu`` for the CPU),
one process per rank; under ``torch.distributed`` each rank is one
client cohort of the data axis. For example, at reduced width on the
CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --steps 20 --batch 8 --seq 256 --mode approx --device cpu

and at full width on a GPU, the approx uplink on the CUDA kernel:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 3 --mode approx --use-kernel

The key schedule is the reference's: ``PRNGKey(0)`` makes the params and
each step splits the key once. ``approx``/``naive`` run
``make_train_step_approx``; ``perfect`` the plain step; ``ecrt`` the plain
step with per-shard corruption. Each printed step line splits its time
into the approx step's spans (``repro_torch.obs.spans``): ``grad``
(forward and backward), ``uplink`` with its parts in brackets
(``flatten``, ``keys``, ``kernel``, ``unflatten``), ``apply``
and the whole ``step``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import channel as channel_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import world_mesh
from repro_torch.models import registry as R
from repro_torch.obs import spans
from repro_torch.optim.sgd import sgd as make_sgd

__all__ = ["main", "parse_args"]

UPLINK_PARTS = ("flatten", "keys", "kernel", "unflatten")


def span_parts(phase_s: dict) -> str:
    """A step's span seconds as the step line prints them: the uplink's
    parts in brackets after it."""
    def ms(k):
        return f"{k} {phase_s[k] * 1e3:.1f}ms"

    out = []
    for k in phase_s:
        if k in UPLINK_PARTS:
            continue
        out.append(ms(k))
        if k == "uplink":
            inner = ", ".join(ms(p) for p in UPLINK_PARTS if p in phase_s)
            out[-1] += f" ({inner})" if inner else ""
    return " ".join(out)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--mode", default="approx",
                    choices=["perfect", "naive", "approx", "ecrt"])
    ap.add_argument("--snr-db", type=float, default=10.0)
    ap.add_argument("--modulation", default="qpsk")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the current GPU)")
    return ap.parse_args(argv)


def main(argv=None, *, on_step=None):
    """Run the driver; returns the last step's loss (a float).

    ``on_step(i, loss, stats, phase_s)``, when given, is called after each
    step with its loss tensor, its uplink ``TxStats`` (``None`` on the
    plain steps) and its span seconds.
    """
    args = parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=256, d_ff=512, vocab_size=1024)

    tcfg = transport_lib.TransportConfig(
        mode=args.mode,
        modulation=args.modulation,
        channel=channel_lib.ChannelConfig(snr_db=args.snr_db),
        simulate_fec=False,
        ecrt_expected_tx=1.1,
        use_kernel=args.use_kernel,
    )
    opt = make_sgd(args.lr)

    shape = (tuple(int(x) for x in args.mesh_shape.split(","))
             if args.mesh_shape else None)
    mesh = world_mesh(shape)
    print(f"mesh {dict(mesh.shape)} device={device}")

    key = prng.PRNGKey(0, device=device)
    params = R.init_params(key, cfg)
    opt_state = opt.init(params)
    leaves, _ = transport_lib.tree_flatten(params)
    n_params = sum(p.numel() for p in leaves)
    print(f"{args.arch} ({'reduced' if args.reduced else 'full'}): "
          f"{n_params/1e6:.1f}M params, mode={args.mode}")

    stream = TokenStream(cfg.vocab_size, args.seq, args.batch)
    if args.mode in ("approx", "naive"):
        step = steps_lib.make_train_step_approx(cfg, opt, tcfg, mesh)
    else:
        t = None if args.mode == "perfect" else tcfg
        step = steps_lib.make_train_step(cfg, opt, transport_cfg=t, mesh=mesh)
    loss = float("nan")
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch = stream.next_batch()
        ks = prng.split(key)
        key, sk = ks[0], ks[1]
        with spans.collect(device) as phase_s:
            out = step(params, opt_state, batch, sk)
            # the loss read synchronises: the spans' device pairs resolve
            # when the scope closes
            loss = float(out[2])
        params, opt_state, loss_t = out[0], out[1], out[2]
        stats = out[3] if len(out) > 3 else None
        if on_step is not None:
            on_step(i, loss_t, stats, dict(phase_s))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            parts = span_parts(phase_s)
            print(f"step {i:4d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s{'; ' if parts else ''}"
                  f"{parts})")
    if args.checkpoint:
        from repro_torch.checkpoint import io as ckpt

        ckpt.save(args.checkpoint, params, step=args.steps)
        print("saved", args.checkpoint)
    return loss


if __name__ == "__main__":
    main()
