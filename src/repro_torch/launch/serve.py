"""Serving driver: batched greedy decode against a KV cache (port of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Without ``--reduced`` the config runs at its published widths (the
reference's ``--reduced`` is always on); ``--device`` defaults to the
current GPU. The prompt is ``prng.randint(PRNGKey(0), ...)``, the
reference's draw; it is fed token by token through the cache, then the
server decodes greedily.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry as R

__all__ = ["main"]


def main(argv=None):
    """Run the server; returns ``(prompt, generated, tokens_per_s)``: int32
    tensors ``(B, prompt_len)`` and ``(B, gen)``, and the decode loop's
    rate (host clock between device synchronises)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the current GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    key = prng.PRNGKey(0, device=device)
    params = R.init_params(key, cfg)
    cache_len = args.prompt_len + args.gen if not args.ring else cfg.decode_window
    cache = R.init_cache(cfg, args.batch, cache_len, device=device)
    step = steps_lib.make_serve_step(cfg, ring=args.ring)

    prompt = prng.randint(key, (args.batch, args.prompt_len), 0,
                          cfg.vocab_size).to(torch.int32)
    # prefill token-by-token (exercises the cache path end to end)
    tok = prompt[:, :1]
    generated = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for pos in range(args.prompt_len + args.gen - 1):
        nxt, cache = step(params, cache, tok, pos)
        if pos + 1 < args.prompt_len:
            tok = prompt[:, pos + 1:pos + 2]
        else:
            tok = nxt
            generated.append(nxt)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.batch * (args.prompt_len + args.gen)
    print(f"{args.arch}: {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, batch={args.batch}, ring={args.ring})")
    print("sample continuation:",
          torch.cat([prompt[:1, -4:], nxt[:1]], 1).tolist())
    gen = (torch.cat(generated, dim=1) if generated
           else prompt[:, :0])
    return prompt, gen, total / dt


if __name__ == "__main__":
    main()
