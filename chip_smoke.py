#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # on a machine with a CUDA GPU
    python3 chip_smoke.py --cpu    # rehearsal on the CPU, at small sizes

Drives the port (``src/repro_torch``) through its main path — the paper's
FedSGD rounds over the approximate uplink, then the link-adaptation,
FedAvg, downlink and sparse-uplink rounds built on it, with the
observability sinks attached, the buffered asynchronous engine's
waves, the LLM trainer and server at qwen2-1.5b's full width, the
moe, vlm, hybrid, ssm and audio families at phi3.5-moe's, pixtral-12b's,
recurrentgemma-2b's, falcon-mamba-7b's and whisper-large-v3's published
widths, recurrentgemma-2b at full depth through K0 on a row past 2**31 -
1 words, the optimizers, and the meta-device dry run — and
holds its CUDA kernels against their plain PyTorch versions: K0, K1 and
K2 of the approximate channel, and the layered PHY's channel stage. Phases, each of which
fails the run
(non-zero exit) when it fails:

1. Device: name, count, and ``nvidia-smi``'s name and power limit.
2. Build: the kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   (time, and ``-Xptxas -v``'s registers, spills and the blocks an SM
   they allow, per family K0 / K1 / K2; a build reused from an earlier
   run in the same checkout reports the log saved with it), and the SASS
   of one symbol of the main-path instances (k=2, rayleigh, f32 wire) of
   all three counted by class with ``cuobjdump`` (``sass_symbol_loop``);
   then the channel stage's ``csrc/phy_channel.cu`` the same way (its
   three fading instances' registers and spills, and one QPSK Rayleigh
   symbol's hot path: ``sass_stage_symbol_loop``).
3. K1 against its plain version on the card: k in {2,4,8} x fading in
   {rayleigh, awgn, block_rayleigh} x wire in {f32, bf16} at C=8,
   N=16,384; C=37 (across the kernels' client chunk of 32, no multiple
   of their 8 client slots) x k in {2,8} x {rayleigh, block_rayleigh} x
   both wires; masked
   ``num_active`` in {1,3,5}; and naive mode. Identical
   bits and errors at noise power 0. With noise identical is expected;
   any word that differs must trace to a symbol whose demod pre-round
   value lies within 1e-4 of a half-integer (``EDGE``).
4. K2 against its plain version (same sweep, same rule) and K2 against
   K1 followed by ``fedsgd_aggregate_batch`` inside the port, bit for bit;
   in naive mode finite lanes bit for bit and NaN positions equal.
5. The main path at full width: the paper CNN (D = 21,840 parameters) on
   100 non-iid clients, QPSK approx uplink at 10 dB on the kernel path,
   3 layered rounds (K1) and 3 fused rounds (K2). Launch counters are set
   to 0 just before each path and read just after; each kernel must have
   launched once per round, and the channel stage's counter
   (``channel_stage.launches``) must read 0, since the kernel path skips
   the layered PHY. Each round's time is split into gradients,
   uplink (with its key-schedule and kernel parts), apply and eval. A
   4-client world run on the GPU and on the CPU checks the result against
   the CPU plain path.
5c. The layered PHY and the ECRT baseline, which launch none of K0, K1
   and K2 (on the card the layered PHY's channel stage is one launch of
   its own kernel):
   (a) QPSK BER over Rayleigh at 10 and 20 dB (2^20 symbols) within 5
   binomial standard deviations of the closed form; (b) Table I on 16-QAM,
   MSB error rate below the LSB's; (c) layered ``transmit_batch`` on the
   card against the CPU (C=8, N=4,096, k x fading x wire x naive/approx,
   row 0 noiseless and exact, any other differing word within
   ``_layered_edge`` of a decision edge); (d) LDPC encode/syndrome on the
   card, the real ECRT chain on one client x 1,024 floats, and
   ``calibrate_ecrt`` at 10 and 20 dB (48 codewords, ``max_tx`` 6) timed
   on the card beside the CPU; (e) the paper's Fig. 3 arms at full width
   (100 clients, paper CNN, QPSK 10 dB, 3 rounds each of approx and naive
   on the layered PHY and ECRT resolved by the engine): K0-K2 counters
   0, the channel stage's counter 1 a round on the card for approx and
   naive (0 on the CPU, and for ECRT, which the engine prices
   analytically), per-round phase times, peak memory, airtime per client
   against
   ``round_airtime``'s formula and the ECRT/approx ratio against
   ``(2 E 349,440 1.05 / 13e6 + 200e-6 E) / (349,440 / 13e6 + 200e-6)``,
   and the layered uplink alone beside its channel stage alone (one
   ``_through_channel`` call at the round's shape).
5d. Link adaptation at full width (the same world and CNN): the
   ``vehicular`` scenario with E[tx] calibrated, over an approx QPSK
   ``use_kernel`` base at 10 dB, 3 rounds each of bucketed layered,
   bucketed fused and select, then 2 rounds of ``iot-flaky`` (dropout,
   stragglers, stale CSI, 16 pilots). Counters set to 0 before each run
   and read after it, and per round: K1 (layered) or K2 (fused) launched
   exactly once per non-empty uncoded mode bucket, nothing on select.
   Per round: mode counts, active clients, stragglers, phase times (with
   the host-side ``link`` step), launches, airtime; each run's peak
   memory. On round 0's real buckets (k, capacity, ``num_active``,
   per-client SNR, the round's keys): K1 and K2 against their plain
   versions as in phase 3+4; bucketed with kernel rows cleared against
   select, bit for bit; a 6-client scenario run on the card against the
   CPU plain path; the link step timed on the host and on the card.
5e. FedAvg and the downlink broadcast at full width (the same world and
   base): (a) FedAvg (4 local steps of 32) layered ``none``, fused
   ``none`` and layered ``max_abs``; (b) FedSGD and FedAvg behind an
   approx downlink at the uplink's SNR, layered and fused; (c)
   ``static-noisy-dl`` and ``vehicular-noisy-dl`` with FedAvg under
   bucketed layered, bucketed fused and select; 3 rounds each. Per
   round: K1 launches = the broadcast's kernel buckets (one for a
   single-mode ``use_kernel`` downlink, under every dispatch as in the
   reference; one per non-empty uncoded downlink bucket of an adaptive
   downlink, none under select) + the uplink's on layered rounds, K2 =
   the uplink's on fused rounds; phases (with ``downlink``,
   ``downlink_keys`` and ``downlink_kernel``), modes and downlink modes;
   each run's peak memory. Then ``payload`` against ``payload_from``
   for both algorithms, timed; (d) round 0's broadcast at the main-path
   shape through ``transmit_broadcast`` (K1) against the plain K1 on the
   same tile, and again at N = 22,528 (whole tiles): 0 differing words;
   a perfect downlink equal to no downlink bit for bit (FedSGD layered,
   FedAvg fused); a 6-client FedAvg ``max_abs`` run on
   ``vehicular-noisy-dl`` on the card against the CPU plain path. The
   payload times run twice over: with PyTorch's own relu and max-pool
   derivatives (the CNN before its repair) and with the reference's, in
   the order before, after, after, before.
5f. Sparse uplinks at full width (the same world and base), 3 rounds
   each: (a) FedSGD driverless with top-k 0.02 and a Gray header, with a
   perfect header, and rand-k with an ECRT header; (b) FedSGD top-k
   behind an approx downlink at the uplink's SNR; (c) FedAvg ``max_abs``,
   top-k; (d) ``iot-lowrate`` (its own top-k, per-mode budgets) under the
   bucketed dispatch; (e) ``vehicular`` with ``k=437`` under select. Per
   round: K1 launches = the broadcast's + one for the value leg (or one
   per non-empty uncoded bucket; none under select), K2 none; phases,
   modes and ``comp_ratio`` / ``comp_bits_on_air`` /
   ``comp_residual_norm``, with ``comp_bits_on_air`` checked against
   value bits plus header bits per active client; each run's peak
   memory. Then round 0's value leg through K1 against the plain K1 (0
   differing words); round 0's Gray header on the card against the CPU
   (differing indices only on symbols within ``_layered_edge`` of an
   edge); error feedback on the card (``scatter(values) + residual ==
   acc`` bit for bit, dropped clients keep their accumulation) and top-k's
   order on NaN, +-inf, +-0 and ties against the CPU; a 6-client
   ``iot-lowrate`` run on the card against the CPU: the same modes and
   selected indices at every round, accuracy within 2 test images.
5g. The observability sinks at full width (the same world and base), 3
   rounds each, every run twice, with its sinks and without: (a)
   driverless FedSGD, layered (K1) and fused (K2), with a ledger and phase
   timers; (b) ``vehicular`` under bucketed layered, bucketed fused and
   select with a ledger, timers and sketches; (c) FedSGD top-k behind an
   approx downlink with a ledger and timers. Each run with sinks equals
   its twin without them and the earlier phase's run of its shape (5, 5d)
   bit for bit: params, accuracy, airtime, link, launches a round (one K1
   or K2 a round on (a), one per uncoded bucket on (b), two K1 on (c)).
   Each round's ``ber`` sketch counts the active clients and ``snr_db``
   every client; (c)'s records carry the ``comp_*`` and ``downlink_*``
   fields and their link view equals the twin's link. Every ledger (under
   ``build/chip_smoke_obs/``) validates, reads back to ``FLResult.link``,
   renders as OpenMetrics text through ``registry_from_ledger``, and its
   provenance names the card. Round 0's per-client arrays of (b), copied
   to the CPU, give the card's bucket counts and exemplars there. Printed
   per run: the timers' report, the ``telemetry`` scope's first and
   steady median time, and the wall and round times with and without the
   sinks.
5h. Buffered asynchronous rounds at full width (the same world and base,
   ``AsyncRoundEngine``): (a) degenerate runs (``buffer_k`` the cohort,
   simultaneous arrivals, constant weights), driverless layered (K1) and
   fused (K2) and ``vehicular`` bucketed layered and fused, each equal
   bit for bit to its sync twin (params, accuracy, airtime, link,
   launches a round or wave) and the twin to phase 5's / 5d's run; (b)
   ``metro-rush`` (its compute and arrival models) with ``buffer_k=25``,
   polynomial staleness (alpha 0.5), 8 aggregations, a ledger, a trace,
   timers and sketches, and with ``buffer_k=100``, 3 aggregations: per
   wave K1 launches = the non-empty uncoded buckets over all 100 rows
   (non-members ride as mask fodder); the ledger validates with its
   event stream and eval stamps, the trace exports, the staleness
   histogram is non-empty; event seconds per aggregation of the two
   arms; (c) ``global-churn`` (churn, idle gaps) with ``buffer_k=25``,
   inverse staleness and top-k 0.02: one K1 value-leg batch per uncoded
   bucket a wave, and every absent client's EF residual row unchanged by
   the wave, bit for bit. ``event_s`` one non-decreasing stamp per eval
   everywhere. Per wave: members, modes, launches, phase times; each
   run's peak memory. Then a 6-client ``metro-rush`` buffered run on the
   card against the CPU: the same event stream, ``event_s`` and link
   records, accuracy within 2 test images.
5i. The LLM trainer (``python -m repro_torch.launch.train``'s ``main``):
   qwen2-1.5b at its published widths (1,777,088,000 params, bf16),
   ``TokenStream(vocab, 256, 8)``, 3 FedSGD steps at approx QPSK 10 dB
   Rayleigh on the kernel path, a world of one. Launch counters from 0
   just before, read just after: K0 once a step, K1 and K2 never. Per
   step: the loss (finite), forward and backward, uplink keys, K0 and
   apply (spans), the row's int32 bit-error count beside 2**31, peak
   memory. Then step 0 by hand: ``init_params``' time and peak; its loss
   equal to the trainer's; a perfect uplink leaving the gradient bit for
   bit and a perfect step equal to SGD on it; ``transmit_pytree`` of step
   0's gradient under the trainer's key with the trainer's error count,
   tiles 0, 262,143, 262,144 (either side of the uint32 symbol counter's
   wrap) and the last, padded one against the plain version on the card
   and the CPU; K0's whole row through K0's row kernel and through K1 at
   C=1 (the path K0 took before it had a kernel of its own), timed in
   turns old, new, new, old, each beside the issue-rate floor of its own
   SASS, and both held against one pass of the plain version tile range
   by tile range (0 differing words, errors equal modulo 2**32); a 2**28
   + 1,024-word row through K0 likewise; one layered approx step at the
   trainer's ``--reduced`` widths (no launch).
5j. The server (``repro_torch.launch.serve``'s ``main``) at full width,
   batch 4, 32 prompt + 16 generated tokens, full and ring caches:
   tokens a second and peak memory; then decode at the 32 prompt
   positions against ``forward`` (and the prefill step against its last
   position, bit for bit), within ``DECODE_RTOL`` and ``DECODE_ULPS``.
5k. The moe family: phi3.5-moe-42b-a6.6b at its published widths (d_model
   4,096, 32 heads, 8 KV heads, 16 experts top-2, ``moe_d_ff`` 6,400,
   vocab 32,064, bf16) cut to one layer (1,562,980,352 params; the cut
   dates from K0's old 2**31 - 1-word limit), from ``PRNGKey(0)``: 3
   approx steps (QPSK 10 dB
   Rayleigh on the kernel path, lr 0.1, a world of one) of
   ``make_train_step_approx`` on ``train.main``'s key schedule and
   ``TokenStream(32064, 256, 8)`` (2,048 tokens, capacity 385 an
   expert). Launch counters from 0 just before, read just after: K0 once
   a step, K1 and K2 never. Per step: loss and aux loss (finite), the
   spans, the row's int32 bit-error count, peak memory. Step 0 by hand:
   its loss equal to the trainer's, K0 on its gradient with the
   trainer's count, the row's flipped bits equal to that count modulo
   2**32, tiles 0, 262,143, 262,144 and the last against the plain
   version on the card and the CPU (words and errors; no whole-row
   plain pass). The server's decode path on the initial weights (batch 4,
   32 + 16 tokens, full cache): tokens a second, peak; decode at the 32
   prompt positions against ``forward`` at ``capacity_factor =
   n_experts / top_k``, where ``capacity(128) == 128`` and forward drops
   no token (decode routes 4 tokens and never drops), within
   ``DECODE_RTOL`` / ``DECODE_ULPS`` away from a router near-tie
   (``MOE_NEAR_TIE``). kimi-k2 at ``cfg.reduced()`` in float32 (a dense
   layer, a moe layer with a shared expert): loss, logits and gradients on
   the card against the CPU within the CPU tests' bounds.
5l. The vlm family: pixtral-12b at its published widths (d_model 5,120,
   32 heads, 8 KV heads, vocab 131,072, 256 patches of width 1,024, bf16)
   cut to two layers (1,892,705,280 params): 3 approx steps as in 5k on
   batches of ``registry.make_batch`` (8 x 256 tokens and their patches:
   the trunk runs 512 positions, the head 256), K0 once a step, the
   spans, the row's error count and peak; step 0 by hand as in 5k; the
   prefill step on step 0's batch, bit for bit the forward's last
   position, timed; ``cfg.reduced()`` in float32 on the card against the
   CPU.
5m. The hybrid family: recurrentgemma-2b at its published widths
   (d_model 2,560, lru_width 2,560, 10 heads, MQA, vocab 256,000,
   local_window 2,048, bf16) cut to five layers (one (rec, rec, attn)
   group and a list tail of two rec blocks: 1,751,201,280 params): 3
   approx steps on ``TokenStream(256000, 256, 8)`` as in 5k, step 0 by
   hand; the server (batch 4, 32 + 16 tokens) in tokens a second; decode
   at the 32 prompt positions against ``forward`` within
   ``DECODE_RTOL`` / ``DECODE_ULPS``; the RG-LRU scan alone at (8, 256,
   2,560) (forward, the odd/even recursion alone, forward and backward;
   CUDA events); ``cfg.reduced()`` (no group, a tail of two) and
   ``reduced(n_layers=5)`` in float32 on the card against the CPU.
5n. The ssm family: falcon-mamba-7b at its published widths (d_model
   4,096, Di 8,192, ssm_state 16, conv 4, dt_rank 256, vocab 65,024,
   bf16) cut to 12 of 64 layers (1,796,427,776 params): 3 approx steps on
   ``TokenStream(65024, 256, 8)`` as in 5k, step 0 by hand; the server;
   decode at the 32 prompt positions against ``forward`` within
   ``SSM_DECODE_REL`` (forward rounds the conv and SiLU outputs to bf16,
   decode does not, as in the reference); the selective scan alone at
   (8, 256, 8,192, 16) (forward, the odd/even recursion alone, forward
   and backward, each with its peak memory; CUDA events);
   ``cfg.reduced()`` in float32 on the card against the CPU, 6 decode
   steps included.
5o. The audio family: whisper-large-v3 at its published widths and full
   depth (32 encoder and 32 decoder layers, d_model 1,280, 20 heads,
   d_ff 5,120, vocab 51,866, 1,500 frames, bf16 weights: 1,588,016,640
   params): 3 approx steps as in 5k on ``registry.make_batch``'s float32
   frames and 8 x 256 tokens (the encoder runs in float32, as ``jnp``
   promotes), step 0 by hand; the server on the full cache (its
   cross-attention reads the zero cache ``init_cache`` makes, as in the
   reference, so no decode-against-forward check); ``cfg.reduced()`` in
   float32 on the card against the CPU, frames and 6 decode steps
   included.
5p. K0 on a row past 2**31 - 1 words: recurrentgemma-2b at its
   published widths and full depth (26 layers: 8 (rec, rec, attn) groups
   and a tail of 2 rec blocks, 3,549,795,840 params, bf16): 3 approx
   steps on ``TokenStream(256000, 256, 8)`` as in 5k, K0 once a step on
   the 3,549,796,352-word padded row, peak memory a step; step 0 by hand
   as in 5k with tiles 2,097,151 and 2,097,152 (either side of word
   2**31) among the sampled ones; the server; K0 alone on a seeded row of
   the same length, timed (median of 3), with its bound and issue-rate
   floor, every tile against one pass of the plain version (0 differing
   words) and its int32 count equal to the plain version's modulo 2**32,
   past 2**32.
5q. The optimizers at qwen2-1.5b's full width (1,777,088,000 bf16
   params): 3 updates each of ``momentum_sgd`` and ``adam`` under
   ``warmup_cosine`` on gradients drawn from a seed, timed with CUDA
   events, peak memory; the sampled leaves ``OPTIM_SAMPLED`` against the
   same updates on the CPU within ``OPTIM_REL`` of the leaf's largest
   value; the int32 step.
5r. The dry run and the world of one: ``python -m
   repro_torch.launch.dryrun --all`` on the meta device, started in its
   own process (no card) after phase 2 so that it runs beside the card's
   phases: every arch x shape record ``ok`` or a ``supports_shape`` skip;
   the total parameter count of each config phases 5i and 5k-5p built,
   from the meta device, equal to the count the phase measured; model
   FLOPs (``roofline.model_flops`` of the step's batch) over each LLM
   phase's fastest grad span, as TFLOP/s and a share of the card's bf16
   dense peak; phi3.5-moe reduced with ``moe_impl="expert_parallel"`` at
   a world of one: a train step and the prefill step equal the dense
   dispatch's bit for bit.
6. Times at the main-path shape (C=100, N=22,528, QPSK, f32; K0 on the
   first client's row, beside K1 at C=1 on it):
   kernel and plain version with CUDA events (median of single launches
   after a warm-up), each kernel's bound from bytes and operations, the
   floor its SASS implies at the card's issue rate, and the
   per-round key schedule (client keys + kernel seeds) on the host and on
   the card; then K1 and K2 at each bucket shape of phase 5d's round 0
   (one median per k, capacity and ``num_active``) beside their bounds;
   then K1 at phase 5f's sparse value-leg shapes (C = 100, k = 437, and
   round 0's ``iot-lowrate`` uncoded buckets), one padded tile a client,
   beside the bound of the ``k`` words. Last, the channel stage at the
   ``cnn-approx-layered`` cell's shape (C=100 rows of 21,840 words x 16
   QPSK symbols, Rayleigh, 10 dB): ``y`` and ``c`` from the kernel equal
   the eager ``modulate -> transmit -> equalize`` chain's on the same
   inputs bit for bit; both timed with CUDA events (eager, kernel,
   kernel, eager; the kernel as the round calls it, ``y`` alone), beside
   the bound from bytes and operations and the floor its SASS implies.
7. The result: a JSON line of the kernels (``launches`` counts phase 5's,
   5e's, 5f's, 5g's, 5h's, 5i's and 5k's to 5p's runs; K0's row is the
   trainer's row from 5i: its time, plain time, bound and error; the
   channel stage's row counts phase 5c(e)'s launches and has no TPU
   kernel it replaces),
   ``nvidia-smi``'s line, and as the last line ``{"ok": true, "device":
   {...}}``.

Needs one GPU, no network, and finishes in a few minutes. Exits non-zero,
printing no result, without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import os

# cuBLAS needs this before its first call for deterministic algorithms.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
EDGE = 1e-4  # demod pre-round proximity to a half-integer that may flip
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/approx_channel.cu"
STAGE_SOURCE = "src/repro_torch/kernels/csrc/phy_channel.cu"
K0_REPLACES = "src/repro/kernels/approx_channel.py:52"
K1_REPLACES = "src/repro/kernels/approx_channel.py:405"
K2_REPLACES = "src/repro/kernels/approx_channel.py:294"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and float32
# operations/s outside the tensor cores. Integer operations are counted
# against the same float32 rate, which no integer unit exceeds, so the
# bound stays a lower bound.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


class PhaseError(RuntimeError):
    """A phase found the port at fault."""


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ------------------------------------------------------------------ helpers


class Clock:
    """Device-side timing: CUDA events on the GPU, the host clock on the
    CPU rehearsal. ``median_ms`` times single calls after a warm-up."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def host_median_ms(self, fn, reps: int, warmup: int = 2) -> float:
        """Median host-clock time of ``fn`` between device synchronises:
        for steps whose cost is launching work, not the work itself."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def median_ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        self.sync()
        times = []
        for _ in range(reps):
            if self.device.type == "cuda":
                start = self.torch.cuda.Event(enable_timing=True)
                end = self.torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def _k1_ops_per_symbol(k: int, fading: str) -> tuple[int, int]:
    """(float ops, integer ops) of one symbol of the channel chain, each
    libdevice call (log, sqrt, cos, sin, rint) and divide counted as one.

    Per symbol: symbol and axis-bit extraction (2 + 8p int), two Gray
    decodes (12 int), constellation point (8 float), symbol index (3 int),
    a noise Gauss pair (two hashes of 19 int, two uniforms of 1 int +
    3 float, Box-Muller 8 float), noise scaling (2 float), the fading pair
    (the same again plus 4 float; 1 float for awgn; +1 int for the block
    index), |c|^2 (4 float), equalisation (10 float), two demods (14
    float), two Gray encodes (4 int), reassembly (8p + 2 int).
    """
    p = k // 2
    gauss_f, gauss_i = 14, 40
    f = 8 + gauss_f + 2 + 4 + 10 + 14
    i = 2 + 8 * p + 12 + 3 + gauss_i + 4 + 8 * p + 2
    if fading == "awgn":
        f += 1 - 4
    else:
        f += gauss_f
        i += gauss_i + (1 if fading == "block_rayleigh" else 0)
    return f, i


def _bound(c: int, n: int, k: int, fading: str, word_bits: int,
           kernel: str) -> dict:
    """Least time for K1 or K2 at this shape: bytes over the memory rate
    vs operations over the float32 rate. Each input read once, each
    output written once."""
    wb = word_bits // 8
    s = word_bits // k
    f_sym, i_sym = _k1_ops_per_symbol(k, fading)
    # per word: clamp, xor, popcount (3 int); per client: 2 sqrt + 1 mul
    ops = c * n * (s * (f_sym + i_sym) + 3) + 3 * c
    if kernel == "k1":
        nbytes = c * n * wb * 2 + c * 12 + c * 4
    else:
        ops += c * n * 2  # w * x_hat, then + acc
        nbytes = c * n * wb + n * 4 + c * 16 + c * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _stage_bound(c: int, s: int) -> dict:
    """Least time for the channel stage on ``(c, s)`` QPSK symbols over
    Rayleigh fading, writing ``y`` alone as the round does: bytes over the
    memory rate vs operations over the float32 rate, ``erfinvf`` and each
    divide counted as one operation.

    Per symbol: four draws, each a threefry-2x32 hash (2 + 20 x 3 + 5 x 3
    integer ops) and the uniform's bits (xor, shift, or: 3 int), then
    subtract, fma, max, erfinvf, * sqrt 2 and * scale (6 float); the Gray
    map (10 int, 4 float); the gain (2 float); the channel product and
    noise (8 float); Smith's division (|.| twice, compare, 3 divides, 3
    multiplies, 3 adds: 12 float). In: the int64 index; out: complex64
    ``y``; a row's two key words and its noise scale.
    """
    f_sym = 4 * 6 + 4 + 2 + 8 + 12
    i_sym = 4 * (2 + 20 * 3 + 5 * 3 + 3) + 10
    ops = c * s * (f_sym + i_sym)
    nbytes = c * s * (8 + 8) + c * (16 + 4)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# SASS classes of ``sass_symbol_loop``, matched on the opcode in order.
SASS_CLASSES = (
    ("conversion/MUFU/popc", r"(I2F|F2I|F2F|FRND|MUFU|POPC|FLO)"),
    ("float32", r"(FADD|FMUL|FFMA|FMNMX|FSEL|FSETP|FCHK|FSET)"),
    ("float64", r"D"),
    ("memory", r"(LD|ST|ATOM|RED|SHFL)"),
    ("control", r"(BRA|BSSY|BSYNC|CALL|RET|EXIT|BAR|NOP|WARPSYNC|YIELD)"),
    ("uniform", r"U"),
    ("integer", r"(IMAD|IADD|LOP|SHF|LEA|ISETP|SEL|MOV|VIADD|PRMT|IABS|"
                r"IMNMX|BMSK|SGXT|CS2R|S2R|P2R|R2P|PLOP|VIMNMX|IMUL|VOTE)"),
)


def _sass_function(lib, tag: str):
    """``[(address, instruction), ...]`` of the first function of the built
    library ``lib`` whose mangled name holds ``tag``, from ``cuobjdump
    -sass``; None without cuobjdump."""
    import shutil

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump")
    if cuobjdump is None:
        try:
            cand = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
        except RuntimeError:
            return None
        cuobjdump = str(cand) if cand.is_file() else None
    if cuobjdump is None:
        return None
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    func = next(f for f in re.split(r"\n(?=\s*Function : )", text)
                if tag in f.lstrip().split("\n", 1)[0])
    return [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]


def _sass_opcode(t: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]


def _sass_target(t: str):
    m = re.search(r"\bBRA\s+.*?(0x[0-9a-f]+)", t)
    return int(m.group(1), 16) if m else None


def _sass_loop(ins):
    """The innermost loop of ``ins`` that holds a MUFU (the sqrt, log and
    divide seeds), as a slice of ``ins``."""
    where = {a: k for k, (a, _) in enumerate(ins)}
    loops = [(where[_sass_target(t)], k) for k, (a, t) in enumerate(ins)
             if _sass_target(t) is not None and _sass_target(t) < a]
    lo, hi = min((lh for lh in loops if any(
        _sass_opcode(t).startswith("MUFU") for _, t in ins[lh[0]:lh[1] + 1])),
        key=lambda lh: lh[1] - lh[0])
    return ins[lo:hi + 1]


def _sass_counts(body, cold) -> dict:
    """``{"total": n, class: n, ...}`` of the instructions of ``body`` whose
    index is not in ``cold``."""
    import collections

    counts = collections.Counter()
    for j, (_, t) in enumerate(body):
        if j not in cold:
            op = _sass_opcode(t)
            counts[next((name for name, pat in SASS_CLASSES
                         if re.match(pat, op)), "other")] += 1
    order = [name for name, _ in SASS_CLASSES] + ["other"]
    return {"total": sum(counts.values()),
            **{name: counts[name] for name in order if counts[name]}}


def sass_symbol_loop(lib, kernel: str):
    """Instructions of one symbol of the main-path instance of ``kernel``
    ("k0", "k1" or "k2"; k=2, rayleigh, f32 wire) in the built library
    ``lib``, by class: ``{"total": n, class: n, ...}``, or None without
    cuobjdump.

    The symbol loop is the innermost loop that holds a MUFU (the sqrt and
    divide seeds). For K0 that is its full chain's loop (``row_full``),
    which runs every symbol only where the link's settling test is off
    (rho < 1); the floors printed for K0 take it on the symbols that the
    launch's counter reports open (``_k0_open_share``), a floor of the
    chain's work alone. Its hot path leaves out every forward branch over at
    most 150 instructions that hold a call, a local-memory access or a
    global load: the slow paths of sqrt and divide and the large-argument
    reduction of sincos, which no argument of this chain reaches.
    """
    tag = {"k0": "k0_approx_channel_row", "k1": "k1_approx_channel_batch",
           "k2": "k2_approx_channel_aggregate"}
    ins = _sass_function(lib, tag[kernel] + "ILi2ELi0ELi32E")
    if ins is None:
        return None
    body = _sass_loop(ins)
    cold = set()
    for k, (a, t) in enumerate(body):
        tgt = _sass_target(t)
        if not t.startswith("@") or tgt is None or tgt <= a:
            continue
        skipped = [j for j in range(k + 1, len(body)) if body[j][0] < tgt]
        if len(skipped) <= 150 and any(_sass_opcode(body[j][1]).startswith(
                ("CALL", "STL", "LDL", "LDG")) for j in skipped):
            cold.update(skipped)
    return _sass_counts(body, cold)


def sass_stage_symbol_loop(lib):
    """Instructions of one symbol of the channel stage's Rayleigh instance
    (``phy_channel_stage<0>``) in the built library ``lib``, by class, as
    :func:`sass_symbol_loop` gives them; None without cuobjdump.

    The symbol loop is the innermost loop that holds a MUFU. Its hot path
    falls through every predicated forward branch and leaves out: what an
    unconditional forward branch jumps over (the side of an if / else not
    taken: ``erfinvf``'s rare tail, ``|c_r| < |c_i|``'s side of Smith's
    division); a forward branch's skip of at most 8 instructions that holds
    a call (the slow paths of log, sqrt and divide); and the body of any
    loop inside it (the Gray bits' loop unrolled by four, which k=2 does
    not enter). It still counts the bits' remainder steps of larger k,
    about 25 instructions, so it overstates a QPSK symbol's path a little.
    """
    ins = _sass_function(lib, "phy_channel_stageILi0E")
    if ins is None:
        return None
    body = _sass_loop(ins)
    end, cold = body[-1][0], set()
    for k, (a, t) in enumerate(body):
        tgt = _sass_target(t)
        if tgt is None:
            continue
        if tgt < a and k != len(body) - 1:
            cold.update(j for j in range(k + 1) if body[j][0] >= tgt)
            continue
        if tgt <= a or tgt > end:
            continue
        skipped = [j for j in range(k + 1, len(body)) if body[j][0] < tgt]
        if not t.startswith("@") or (len(skipped) <= 8 and any(
                _sass_opcode(body[j][1]).startswith("CALL")
                for j in skipped)):
            cold.update(skipped)
    return _sass_counts(body, cold)


def _issue_floor_ms(symbols: int, sass: dict, sms: int, mhz: float) -> float:
    """Least time for ``symbols`` symbols at ``sass["total"]`` instructions
    each when every scheduler issues one warp instruction per clock (4 per
    SM, 32 lanes each) at the card's top SM clock."""
    return symbols * sass["total"] / (sms * 4 * 32 * mhz * 1e6) * 1e3


def _k0_open_share(counts: dict) -> float:
    """The share of K0's symbols that its settling test left to the full
    chain, from the counters of a ``spans.counting`` scope around one
    launch (1.0 where the scope caught none: the plain version on the
    CPU). K0's full-chain floor holds on that share of its symbols; the
    magnitude tests of the rest come on top."""
    slow, total = counts.get("k0_symbols_slow"), counts.get("k0_symbols")
    return slow[0] / total[0] if slow and total else 1.0


# ------------------------------------------------------------------- phases


def phase_device(torch, device) -> tuple:
    """``(nvidia-smi's name and power limit, top SM clock in MHz)``."""
    _log("== phase 1: device")
    if device.type == "cpu":
        _log("device: cpu (rehearsal; no GPU numbers are produced)")
        return "cpu (rehearsal)", None
    _log(f"device: {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    smi = proc.stdout.strip().splitlines()[0]
    _log(f"nvidia-smi: {smi}")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    _check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    mhz = float(proc.stdout.strip().splitlines()[0])
    _log(f"top SM clock: {mhz:.0f} MHz")
    return smi, mhz


def phase_build(device) -> dict:
    """Builds the kernels; returns ``sass_symbol_loop`` of K0, K1 and K2
    and, under "stage", ``sass_stage_symbol_loop`` of the channel stage."""
    _log("== phase 2: build")
    if device.type == "cpu":
        _log("build: skipped on the CPU (no nvcc; wrappers run the plain "
             "versions)")
        return {}
    from repro_torch.kernels import build

    lib, log, seconds = build.build("approx_channel")
    if seconds:
        _log(f"build: {lib.name} in {seconds:.1f} s")
    else:
        _log(f"build: {lib.name} reused from an earlier build in this "
             f"checkout (same source and flags); its ptxas log:")
    # -Xptxas -v, folded per kernel family: instances, registers, spills
    summary, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next(k for k in ("k0", "k1", "k2")
                          if f"{k}_approx_channel_" in line)
            summary.setdefault(kernel, {"n": 0, "regs": [], "spill": 0})
            summary[kernel]["n"] += 1
        elif kernel and "spill stores" in line:
            summary[kernel]["spill"] += int(line.split("bytes spill stores")[0]
                                            .split(",")[-1])
        elif kernel and "Used" in line and "registers" in line:
            summary[kernel]["regs"].append(
                int(line.split("Used")[1].split("registers")[0]))
    for kernel, st in sorted(summary.items()):
        # 256-thread blocks, registers allocated 8 a thread at a time
        blocks = min(8, 65536 // (-(-max(st['regs']) // 8) * 8 * 256))
        _log(f"  ptxas {kernel}: {st['n']} instances, registers "
             f"{min(st['regs'])}-{max(st['regs'])}, spill stores "
             f"{st['spill']} bytes; at most {blocks} blocks of 256 threads "
             f"an SM by registers")
    _check(set(summary) == {"k0", "k1", "k2"},
           f"ptxas reported kernels {sorted(summary)}, not k0, k1 and k2")
    sass = {}
    for kernel in ("k0", "k1", "k2"):
        counts = sass_symbol_loop(lib, kernel)
        if counts is None:
            _log("  SASS: not counted (no cuobjdump)")
            break
        sass[kernel] = counts
        _log(f"  SASS {kernel} (k=2, rayleigh, f32), one symbol, hot path: "
             + ", ".join(f"{k} {v}" for k, v in counts.items()))
    lib, log, seconds = build.build("phy_channel")
    _log(f"build: {lib.name} in {seconds:.1f} s" if seconds else
         f"build: {lib.name} reused from an earlier build in this checkout")
    regs, spill, stage = [], 0, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            stage = "phy_channel_stage" in line
        elif stage and "spill stores" in line:
            spill += int(line.split("bytes spill stores")[0].split(",")[-1])
        elif stage and "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
    _check(len(regs) == 3, f"ptxas reported {len(regs)} channel-stage "
           "instances, not 3 (one a fading)")
    _log(f"  ptxas stage: 3 instances, registers {min(regs)}-{max(regs)}, "
         f"spill stores {spill} bytes")
    counts = sass_stage_symbol_loop(lib)
    if counts is not None:
        sass["stage"] = counts
        _log("  SASS stage (k=2, rayleigh), one symbol, hot path: "
             + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return sass


def _sweep_inputs(torch, device, c, n, word_bits, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((c, n), generator=g) * 1.8 - 0.9)
    x = x.to(torch.bfloat16 if word_bits == 16 else torch.float32)
    seeds = torch.randint(0, 2**32, (c,), generator=g, dtype=torch.int64)
    npow = torch.full((c,), 1e-4, dtype=torch.float32)  # 10 dB at G0 = 1e-3
    npow[0] = 0.0  # row 0 noiseless: the exact grade
    gains = torch.full((c,), 1e-3, dtype=torch.float32)
    w = torch.rand((c,), generator=g) * 1.8 + 0.2
    return [t.to(device) for t in (x, seeds, npow, gains, w)]


def _bits(torch, t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _compare_k1(torch, x, seeds, npow, gains, kw, num_active=None):
    """K1 kernel vs plain. Returns (words differing, max |err| over finite
    values, the kernel's output, the plain version's edge distances)."""
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ref

    xk, ek = ac.approx_channel_batch_kernel(x, seeds, npow, gains,
                                            num_active=num_active, **kw)
    xp, ep, edges = ref.approx_channel_batch_ref(
        x, seeds, npow, gains, num_active=num_active, with_edges=True, **kw)
    bk, bp = _bits(torch, xk), _bits(torch, xp)
    diff = bk != bp
    noiseless = npow == 0
    _check(not bool(diff[noiseless].any()),
           f"K1 differs on a noiseless row ({kw})")
    _check(bool(torch.equal(ek[noiseless], ep[noiseless])),
           f"K1 error count differs on a noiseless row ({kw})")
    _check(bool((edges[diff] < EDGE).all()),
           f"K1 word differs away from a decision edge ({kw})")
    if not bool(diff.any()):
        _check(bool(torch.equal(ek, ep)), f"K1 error counts differ ({kw})")
    err = (xk.float() - xp.float()).abs()
    err = err[torch.isfinite(err)]
    return int(diff.sum()), float(err.max()) if err.numel() else 0.0, \
        xk, edges


def _compare_k2(torch, x, seeds, npow, gains, w, kw, xk1, edges,
                num_active=None):
    """K2 kernel vs plain and vs K1 + fedsgd_aggregate_batch."""
    from repro_torch.core import aggregation
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ref

    ak, ek = ac.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, w, num_active=num_active, **kw)
    ap, ep = ref.approx_channel_batch_aggregate_ref(
        x, seeds, npow, gains, w, num_active=num_active, **kw)
    rows = x.shape[0] if num_active is None else num_active
    calm = (edges[:rows] >= EDGE).all(dim=0)
    nan_k, nan_p = torch.isnan(ak), torch.isnan(ap)
    _check(bool(torch.equal(nan_k[calm], nan_p[calm])),
           f"K2 NaN positions differ ({kw})")
    fin = calm & ~nan_p
    _check(bool(torch.equal(_bits(torch, ak)[fin], _bits(torch, ap)[fin])),
           f"K2 differs from its plain version ({kw})")
    if bool(calm.all()):
        _check(bool(torch.equal(ek, ep)), f"K2 error counts differ ({kw})")
    # K2 with normalized weights == K1's rows through fedsgd_aggregate_batch
    # (which normalizes the same weights the same way on the same device).
    wk = torch.zeros_like(w)
    wk[:rows] = aggregation.normalize_weights(w[:rows])
    ak_n, _ = ac.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, wk, num_active=num_active, **kw)
    lay = aggregation.fedsgd_aggregate_batch(xk1[:rows].float(), w[:rows])
    nan_l = torch.isnan(lay)
    _check(bool(torch.equal(nan_l, torch.isnan(ak_n))),
           f"K2 vs K1+aggregate NaN positions differ ({kw})")
    _check(bool(torch.equal(_bits(torch, lay)[~nan_l],
                            _bits(torch, ak_n)[~nan_l])),
           f"K2 differs from K1 + fedsgd_aggregate_batch ({kw})")
    err = (ak - ap).abs()
    err = err[torch.isfinite(err)]
    return float(err.max()) if err.numel() else 0.0


def phase_kernels(torch, device, small: bool) -> None:
    _log("== phase 3+4: K1 and K2 against their plain versions")
    c, n = (4, 2048) if small else (8, 16384)
    total_diff = 0
    for word_bits in (32, 16):
        mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
        for k in (2, 4, 8):
            for fading in ("rayleigh", "awgn", "block_rayleigh"):
                x, seeds, npow, gains, w = _sweep_inputs(
                    torch, device, c, n, word_bits, seed=k * 10 + word_bits)
                kw = dict(bits_per_symbol=k, fading=fading,
                          clamp_mask=mask, word_bits=word_bits)
                nd, e1, xk, edges = _compare_k1(torch, x, seeds, npow, gains,
                                                kw)
                e2 = _compare_k2(torch, x, seeds, npow, gains, w, kw, xk,
                                 edges)
                total_diff += nd
                _log(f"  wire={word_bits} k={k} {fading:14s} K1 words "
                     f"differing {nd} (edge-bound), max|err| K1 {e1:.3g} "
                     f"K2 {e2:.3g}")
    # 37 clients: one full chunk of 32 and a ragged one, no multiple of the
    # 8 client slots; weights drawn in [0.2, 2], so the order shows.
    for word_bits in (32, 16):
        mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
        for k in (2, 8):
            for fading in ("rayleigh", "block_rayleigh"):
                x, seeds, npow, gains, w = _sweep_inputs(
                    torch, device, 37, n, word_bits, seed=k * 37 + word_bits)
                kw = dict(bits_per_symbol=k, fading=fading,
                          clamp_mask=mask, word_bits=word_bits)
                nd, e1, xk, edges = _compare_k1(torch, x, seeds, npow, gains,
                                                kw)
                e2 = _compare_k2(torch, x, seeds, npow, gains, w, kw, xk,
                                 edges)
                total_diff += nd
                _log(f"  C=37 wire={word_bits} k={k} {fading:14s} K1 words "
                     f"differing {nd} (edge-bound), max|err| K1 {e1:.3g} "
                     f"K2 {e2:.3g}")
    x, seeds, npow, gains, w = _sweep_inputs(torch, device, c, n, 32, 99)
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xBFFFFFFF,
              word_bits=32)
    for na in (1, 3, 5):
        na = min(na, c)
        nd, _, xk, edges = _compare_k1(torch, x, seeds, npow, gains, kw,
                                       num_active=na)
        _check(not bool(xk[na:].any()), "K1 masked rows are not zero")
        _compare_k2(torch, x, seeds, npow, gains, w, kw, xk, edges,
                    num_active=na)
        total_diff += nd
        _log(f"  num_active={na}: masked K1/K2 match")
    npow = torch.full_like(npow, 1e-3)  # 0 dB, no clamp: NaN payloads
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xFFFFFFFF,
              word_bits=32)
    nd, _, xk, edges = _compare_k1(torch, x, seeds, npow, gains, kw)
    _check(bool(torch.isnan(xk).any()), "naive mode produced no NaN")
    _compare_k2(torch, x, seeds, npow, gains, w, kw, xk, edges)
    total_diff += nd
    _log(f"  naive mode: NaN contract holds; words differing in the whole "
         f"sweep: {total_diff}")


def _world(n_clients, small: bool):
    from repro_torch.data import synth_mnist
    from repro_torch.fl import partition

    (img, lab), (ti, tl) = (synth_mnist.train_test(30, 10) if small
                            else synth_mnist.train_test(300, 60))
    parts = partition.non_iid_partition(img, lab, n_clients=n_clients)
    cx, cy = partition.stack_clients(parts, per_client=96)
    return cx, cy, ti, tl


def phase_main_path(torch, device, small: bool) -> tuple:
    """Phase 5: the main path at full width. Returns its launches and its
    two results (layered, fused), which phase 5g holds sinks-on runs
    against."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, prng, transport
    from repro_torch.fl import cnn
    from repro_torch.fl.loop import run_fl
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import phy_channel

    _log("== phase 5: main path at full width")
    n_clients = 4 if small else 100
    cx, cy, ti, tl = _world(n_clients, small)
    cfg = config()
    tcfg = transport.TransportConfig(
        mode="approx", modulation="qpsk",
        channel=channel.ChannelConfig(snr_db=10.0), use_kernel=True)
    rounds = 3
    launches, results = {}, {}
    for fused, kernel in ((False, "k1"), (True, "k2")):
        ac.reset_launch_counts()
        phy_channel.channel_stage.launches = 0
        res = run_fl(cfg, tcfg, cx, cy, ti, tl, n_rounds=rounds,
                     batch_per_round=32, eval_every=1, seed=0,
                     fused_aggregate=fused, device=device)
        counts = ac.launch_counts()
        stage = phy_channel.channel_stage.launches
        _check(stage == 0, f"the kernel path launched the channel stage "
               f"{stage} times")
        launches[kernel] = counts[kernel]
        launches["k0"] = launches.get("k0", 0) + counts["k0"]
        want = rounds if device.type == "cuda" else 0
        other = "k2" if kernel == "k1" else "k1"
        _check(counts[kernel] == want and counts[other] == 0
               and counts["k0"] == 0,
               f"{'fused' if fused else 'layered'} path launched {counts}, "
               f"expected {want} {kernel} launches")
        _check(all(math.isfinite(a) for a in res.accuracy),
               "accuracy is not finite")
        _check(all(math.isfinite(a) and a > 0 for a in res.airtime_s),
               "airtime is not finite")
        results[fused] = res
        name = "fused (K2)" if fused else "layered (K1)"
        _log(f"  {name}: {n_clients} clients, launches {counts}, accuracy "
             f"{res.accuracy}, airtime {res.airtime_s} s")
        for r, ph in enumerate(res.phase_s):
            rest = ph["uplink"] - ph["uplink_keys"] - ph["uplink_kernel"]
            _log(f"    round {r}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms" for k, v in ph.items())
                + f", uplink_rest {rest * 1e3:.3f} ms")
    leaves, _ = transport.tree_flatten(
        cnn.init_params(prng.PRNGKey(0), cfg, "cpu"))
    payload = sum(v.numel() for v in leaves)
    _check(payload == 21840, f"paper CNN has {payload} parameters, not 21840")
    return launches, results


def phase_reference(torch, device) -> None:
    """A small world on the GPU and through the CPU plain path."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, transport
    from repro_torch.fl.loop import run_fl

    _log("== phase 5b: small-world run against the CPU plain path")
    cx, cy, ti, tl = _world(4, small=True)
    cfg = dataclasses.replace(config(), lr=0.1)
    tcfg = transport.TransportConfig(
        mode="approx", channel=channel.ChannelConfig(snr_db=10.0),
        use_kernel=True)
    kw = dict(n_rounds=3, batch_per_round=8, eval_every=1, seed=3)
    for fused in (False, True):
        a = run_fl(cfg, tcfg, cx, cy, ti, tl, fused_aggregate=fused,
                   device=device, **kw)
        b = run_fl(cfg, tcfg, cx, cy, ti, tl, fused_aggregate=fused,
                   device="cpu", **kw)
        # conv/matmul sum in another order on the card: trajectory grade,
        # at most 2 of the 100 test images apart at each eval point.
        tol = 2 / len(tl) + 1e-6
        _check(all(abs(p - q) <= tol for p, q in zip(a.accuracy, b.accuracy)),
               f"GPU {a.accuracy} vs CPU {b.accuracy} accuracy")
        _check(all(abs(p - q) <= 1e-6 * q
                   for p, q in zip(a.airtime_s, b.airtime_s)),
               "GPU and CPU airtime differ")
        _log(f"  fused={fused}: GPU {a.accuracy} vs CPU {b.accuracy}")


def _layered_edge(levels: int) -> float:
    """Decision margin within which a layered-PHY word may differ between
    two implementations: the noise and fading normals agree to 128 ULP
    (``prng.normal``), so a pre-round value ``(y/a + L-1)/2`` inside the
    grid, where ``|y/a| <= 2L``, moves by at most about
    ``0.5 * 2L * 2 * 128 * 2**-23 = L * 3.1e-5``; ``L * 2**-14`` doubles it."""
    return levels * 2.0**-14


def _layered_card_vs_cpu(torch, device, small: bool) -> None:
    """(c) Layered ``transmit_batch`` on the card against the same call on
    the CPU, row 0 noiseless."""
    from repro_torch.core import channel, prng, transport

    c, n = (4, 512) if small else (8, 4096)
    g = torch.Generator().manual_seed(5)
    snr = (math.inf, 10.0, 10.0, 20.0, 20.0, 5.0, 5.0, 10.0)[:c]
    worst, total = 0.0, 0
    for k, mod in ((2, "qpsk"), (4, "16qam"), (8, "256qam")):
        for fading in ("rayleigh", "awgn", "block_rayleigh"):
            for wire in ("float32", "bfloat16"):
                for mode in ("naive", "approx"):
                    x = torch.rand((c, n), generator=g) * 1.8 - 0.9
                    cfg = transport.TransportConfig(
                        mode=mode, modulation=mod, wire_dtype=wire,
                        channel=channel.ChannelConfig(snr_db=snr,
                                                      fading=fading))
                    key = prng.PRNGKey(k * 100 + len(fading))
                    xg, sg = transport.transmit_batch(x, key, cfg,
                                                      device=device)
                    xc, sc = transport.transmit_batch(x, key, cfg,
                                                      device="cpu")
                    bg = xg.cpu().view(torch.int32)
                    bc = xc.view(torch.int32)
                    diff = (bg != bc) & ~(torch.isnan(xg.cpu())
                                          & torch.isnan(xc))
                    tag = f"k={k} {fading} {wire} {mode}"
                    _check(not bool(diff[0].any()),
                           f"layered card vs CPU differ at noise 0 ({tag})")
                    for f in ("data_symbols", "transmissions", "n_bits",
                              "bits_on_air"):
                        _check(torch.equal(getattr(sg, f).cpu(),
                                           getattr(sc, f)),
                               f"layered stats {f} differ ({tag})")
                    if bool(diff.any()):
                        margins = transport._word_margins(
                            x, transport.client_keys(key, c), cfg,
                            channel.snr_db_vector(snr, c))
                        m = float(margins[diff].max())
                        worst = max(worst, m)
                        _check(m < _layered_edge(1 << (k // 2)),
                               f"layered word differs {m:.3g} from a "
                               f"decision edge ({tag})")
                    else:
                        _check(torch.equal(sg.bit_errors.cpu(),
                                           sc.bit_errors),
                               f"layered bit errors differ ({tag})")
                    total += int(diff.sum())
    _log(f"  (c) layered transmit_batch card vs CPU, C={c}, N={n}, 36 "
         f"configurations: words differing {total}, largest decision "
         f"margin among them {worst:.3g} (allowed L * 2^-14)")


def _ecrt_checks(torch, device, small: bool) -> dict:
    """(d) LDPC encode/syndrome on the card, the real ECRT chain on one
    client, and ``calibrate_ecrt`` on the card and on the CPU."""
    from repro_torch.core import channel, ecrt, latency, prng, transport

    code = ecrt.LdpcCode()
    msgs = prng.randint(prng.PRNGKey(8, device=device), (8, code.k), 0, 2)
    cw = ecrt.encode(msgs, code)
    _check(torch.equal(cw.cpu(), ecrt.encode(msgs.cpu(), code)),
           "LDPC encode differs between the card and the CPU")
    _check(bool(ecrt.syndrome_ok(cw, code).all()), "codewords fail H c = 0")
    flipped = cw.clone()
    flipped[0, 17] ^= 1
    _check(not bool(ecrt.syndrome_ok(flipped, code)[0]),
           "a flipped bit passes the syndrome")
    x = torch.randn((1024,), generator=torch.Generator().manual_seed(9)) * 0.01
    cfg = transport.TransportConfig(
        mode="ecrt", channel=channel.ChannelConfig(snr_db=10.0))
    t0 = time.perf_counter()
    xh, st = transport.transmit_flat(x, prng.PRNGKey(9), cfg, device=device)
    secs = time.perf_counter() - t0
    _check(torch.equal(xh.cpu(), x), "real ECRT did not return the payload")
    _check(float(st.transmissions) >= 1 and float(st.bit_errors) == 0,
           f"real ECRT stats {st}")
    _log(f"  (d) LDPC encode/syndrome on the card match the CPU; real ECRT, "
         f"1 client x 1,024 floats at 10 dB: payload exact, mean "
         f"transmissions {float(st.transmissions):.4f}, "
         f"{float(st.data_symbols):.0f} symbols, {secs:.3f} s")
    e_tx = {}
    for snr in (10.0, 20.0):
        latency._calibrate_ecrt.cache_clear()
        t0 = time.perf_counter()
        e_dev = latency.calibrate_ecrt(
            snr, n_codewords=latency.DEFAULT_CALIB_CODEWORDS,
            max_tx=latency.DEFAULT_CALIB_MAX_TX, device=device)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_cpu = latency.calibrate_ecrt(
            snr, n_codewords=latency.DEFAULT_CALIB_CODEWORDS,
            max_tx=latency.DEFAULT_CALIB_MAX_TX, device="cpu")
        t_cpu = time.perf_counter() - t0
        _check(1.0 <= e_dev <= latency.DEFAULT_CALIB_MAX_TX,
               f"E[tx] {e_dev} out of range")
        # Each codeword's count may move by one where a posterior sits at
        # 0 to rounding, so the two devices may differ by 1/48 per such.
        _check(abs(e_dev - e_cpu) <= 2 / latency.DEFAULT_CALIB_CODEWORDS,
               f"calibrate_ecrt {snr} dB: card {e_dev} vs CPU {e_cpu}")
        e_tx[snr] = e_dev
        _log(f"  (d) calibrate_ecrt({snr:g} dB, 48 codewords, max_tx 6): "
             f"E[tx] {e_dev!r} on {device.type} in {t_dev:.3f} s, "
             f"{e_cpu!r} on the CPU in {t_cpu:.3f} s")
    return e_tx


def _fig3_arms(torch, device, small: bool) -> None:
    """(e) The paper's Fig. 3 arms at full width through ``run_fl``."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, latency, prng, transport
    from repro_torch.fl import engine
    from repro_torch.fl.loop import run_fl
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import phy_channel

    n_clients = 4 if small else 100
    cx, cy, ti, tl = _world(n_clients, small)
    cfg = config()
    rounds, snr = 3, 10.0
    ch = channel.ChannelConfig(snr_db=snr)
    arms = {
        "approx": transport.TransportConfig(mode="approx", channel=ch),
        "naive": transport.TransportConfig(mode="naive", channel=ch),
        "ecrt": transport.TransportConfig(mode="ecrt", channel=ch,
                                          simulate_fec=True),
    }
    tm = latency.PhyTimings()
    payload = 21840
    air, stage_launches = {}, 0
    for name, tcfg in arms.items():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ac.reset_launch_counts()
        phy_channel.channel_stage.launches = 0
        res = run_fl(cfg, tcfg, cx, cy, ti, tl, n_rounds=rounds,
                     batch_per_round=32, eval_every=1, seed=0, device=device)
        counts = ac.launch_counts()
        stage = phy_channel.channel_stage.launches
        _check(counts == {"k0": 0, "k1": 0, "k2": 0},
               f"{name} arm launched kernels: {counts}")
        # the layered arms' uplink is one channel-stage launch a round on
        # the card; ECRT is priced analytically and draws nothing
        want = rounds if device.type == "cuda" and name != "ecrt" else 0
        _check(stage == want, f"{name} arm launched the channel stage "
               f"{stage} times, not {want}")
        stage_launches += stage
        _check(all(math.isfinite(a) for a in res.accuracy),
               f"{name} accuracy is not finite")
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
                if device.type == "cuda" else "not measured on the CPU")
        # Per-client airtime from round_airtime's formula on the stats.
        if name == "ecrt":
            resolved, scale = engine.resolve_ecrt_analytic(tcfg, n_clients,
                                                           device)
            _check(scale is None, "homogeneous ECRT got an airtime scale")
            e = resolved.ecrt_expected_tx
            sym = 2 * payload * 32 / 2 * e
            want = sym / tm.symbol_rate * (1 + tm.fec_encode_overhead) \
                + e * tm.t_overhead
        else:
            want = payload * 16 / tm.symbol_rate + tm.t_overhead
        per_client = [a / ((r + 1) * n_clients)
                      for r, a in enumerate(res.airtime_s)]
        # float32 pricing and sums: 16 ULP of float32
        _check(all(abs(p - want) <= 2**-20 * want for p in per_client),
               f"{name} per-client airtime {per_client} != {want}")
        air[name] = res.airtime_s
        _log(f"  (e) {name}: {n_clients} clients, launches {counts}, "
             f"channel stage {stage}, accuracy {res.accuracy}, cumulative "
             f"airtime {res.airtime_s} s, peak memory {peak}")
        for r, ph in enumerate(res.phase_s):
            _log(f"    round {r}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms" for k, v in ph.items()))
    # Where a layered-PHY uplink's time goes: the whole batched call at the
    # round's shape, and its channel stage alone (Gray QAM, the draws,
    # fading, noise and zero-forcing: one kernel launch on the card).
    clock = Clock(torch, device)
    x = torch.randn((n_clients, payload), generator=torch.Generator()
                    .manual_seed(10)).mul_(1e-2).to(device)
    key = prng.PRNGKey(10)
    reps = 5 if device.type == "cuda" else 2
    up_ms = clock.median_ms(lambda: transport.transmit_batch(
        x, key, arms["approx"], device=device), reps, warmup=1)
    keys = transport.client_keys(key, n_clients).to(device)
    sym = prng.randint(prng.PRNGKey(11, device=device),
                       (n_clients, payload * 16), 0, 4)
    ch_ms = clock.median_ms(lambda: transport._through_channel(
        sym, keys, arms["approx"]), reps, warmup=1)
    _log(f"  (e) layered uplink alone, {n_clients} x {payload} floats: "
         f"{up_ms:.3f} ms; of it the channel stage "
         f"({'one kernel launch' if device.type == 'cuda' else 'eager'}) "
         f"{ch_ms:.3f} ms ({ch_ms / up_ms:.1%}) (medians of {reps})")
    ratio = air["ecrt"][-1] / air["approx"][-1]
    want = ((2 * e * 349440 * 1.05 / 13e6 + e * 200e-6)
            / (349440 / 13e6 + 200e-6))
    _check(abs(ratio - want) <= 2**-20 * want,
           f"ECRT/approx airtime ratio {ratio} != {want}")
    _log(f"  (e) ECRT/approx airtime ratio {ratio!r} (formula {want!r}, "
         f"E[tx] {e!r})")
    return stage_launches


def phase_layered(torch, device, small: bool) -> int:
    """Phase 5c: the layered PHY and the ECRT baseline, which launch none
    of K0, K1 and K2; on the card the layered PHY's channel stage is one
    launch of its own kernel. Returns (e)'s channel-stage launches."""
    from repro_torch.core import modulation, prng

    _log("== phase 5c: layered PHY and ECRT")
    qpsk, qam16 = modulation.MOD_SCHEMES["qpsk"], modulation.MOD_SCHEMES["16qam"]
    n = 1 << (16 if small else 20)
    for snr in (10.0, 20.0):
        ber = float(modulation.measure_ber(prng.PRNGKey(1), qpsk, snr,
                                           n_symbols=n, device=device))
        p = modulation.rayleigh_qpsk_ber(snr)
        sigma = math.sqrt(p * (1 - p) / (2 * n))
        _check(abs(ber - p) <= 5 * sigma,
               f"QPSK Rayleigh BER {ber} at {snr} dB vs closed form {p}")
        _log(f"  (a) QPSK Rayleigh {snr:g} dB, {n} symbols: BER {ber:.6g}, "
             f"closed form {p:.6g} ({(ber - p) / sigma:+.2f} sigma)")
    k1, k2 = prng.split(prng.PRNGKey(4, device=device))
    sym = prng.randint(k1, (1 << 16,), 0, qam16.points)
    noise = torch.complex(prng.normal(k2, sym.shape),
                          prng.normal(prng.PRNGKey(5, device=device),
                                      sym.shape)) * 0.25
    rx = modulation.demod_hard(modulation.modulate(sym, qam16) + noise, qam16)
    diff = sym ^ rx
    msb = float(((diff >> 3) & 1).float().mean())
    lsb = float((diff & 1).float().mean())
    _check(msb < lsb, f"Table I: MSB error rate {msb} >= LSB {lsb}")
    _log(f"  (b) Table I, 16-QAM: MSB error rate {msb:.5f} < LSB {lsb:.5f}")
    if device.type == "cuda":
        _layered_card_vs_cpu(torch, device, small)
    _ecrt_checks(torch, device, small)
    return _fig3_arms(torch, device, small)


def _round0_uplink_key(seed: int):
    """Round 0's uplink key in the engine's schedule for a scenario run:
    ``key -> (key, params key) -> (key, link-init key) -> (key, round
    key)``, then ``round key -> (link key, uplink key)``."""
    from repro_torch.core import prng

    key = prng.PRNGKey(seed)
    for _ in range(3):
        key, sub = prng.split(key)
    return prng.split(sub)[1]


def _base_cfg():
    """The runs' uplink: approx QPSK at 10 dB on the kernel path."""
    from repro_torch.core import channel, transport

    return transport.TransportConfig(
        mode="approx", modulation="qpsk",
        channel=channel.ChannelConfig(snr_db=10.0), use_kernel=True)


def _scenario_run(torch, device, cx, cy, ti, tl, scen, rounds, dispatch,
                  fused, capture=None, algo=None, downlink=None,
                  compression=None, buffered=None, on_wave=None, **sinks):
    """One run through ``RoundEngine`` (FedSGD unless ``algo`` is given;
    driverless with ``scen=None``; ``sinks`` are the observability
    arguments), or through ``AsyncRoundEngine`` with ``buffered`` its
    arguments (``buffer_k``, ``staleness``, ...): launch counts per round or
    wave (read after each round body, which ends with the uplink), the
    result, the peak memory and the engine. ``on_wave(engine, member,
    residual before)`` runs after each round body."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import async_engine, engine
    from repro_torch.kernels import approx_channel as ac

    tcfg = _base_cfg()
    if algo is None:
        algo = engine.FedSGD(config(), batch_per_round=32)
    kw = dict(n_rounds=rounds, seed=0, eval_every=1, scenario=scen,
              adaptive_dispatch=dispatch, fused_aggregate=fused,
              downlink=downlink, compression=compression, device=device,
              **sinks)
    eng = (engine.RoundEngine(algo, tcfg, cx, cy, ti, tl, **kw)
           if buffered is None else async_engine.AsyncRoundEngine(
               algo, tcfg, cx, cy, ti, tl, **buffered, **kw))
    per_round = []
    body = eng._round_body

    def counted_body(*args, **kw):  # one call a round or wave
        before = (None if eng._ef_residual is None
                  else eng._ef_residual.clone())
        out = body(*args, **kw)
        per_round.append(ac.launch_counts())
        if on_wave is not None:
            member = args[4] if len(args) > 4 else kw.get("member")
            on_wave(eng, member, before)
        return out

    eng._round_body = counted_body
    if capture is not None:
        link_round = eng.driver.round

        def captured_round(*args, **kw):
            out = link_round(*args, **kw)
            capture.append(out[1])
            return out

        eng.driver.round = captured_round
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ac.reset_launch_counts()
    res = eng.run()
    total = ac.launch_counts()
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "not measured on the CPU")
    deltas, prev = [], {"k0": 0, "k1": 0, "k2": 0}
    for c in per_round:
        deltas.append({k: c[k] - prev[k] for k in c})
        prev = c
    _check(total == prev, f"launches after the last round {total} != {prev}")
    return res, deltas, total, peak, eng


def phase_link(torch, device, small: bool) -> tuple:
    """Phase 5d: scenario-driven FedSGD rounds over the mixed-mode uplink.
    Returns round 0's uncoded buckets as ``(k, capacity, count)`` and the
    ``vehicular`` runs' ``(result, launches per round)`` by label, which
    phase 5g holds sinks-on runs against."""
    from repro_torch.core import aggregation, channel, prng, transport
    from repro_torch.kernels import ops
    from repro_torch.link import scenario as scenario_lib

    _log("== phase 5d: link adaptation at full width")
    n_clients = 8 if small else 100
    cx, cy, ti, tl = _world(n_clients, small)
    vehicular = scenario_lib.get_scenario("vehicular")
    _check(vehicular.ecrt_expected_tx is None, "vehicular is not calibrated")
    runs = (("vehicular", "bucketed layered (K1)", "bucketed", False, 3),
            ("vehicular", "bucketed fused (K2)", "bucketed", True, 3),
            ("vehicular", "select (layered PHY)", "select", False, 3),
            ("iot-flaky", "bucketed layered (K1)", "bucketed", False, 2))
    rnds, first, results = [], None, {}
    for name, label, dispatch, fused, rounds in runs:
        t0 = time.perf_counter()
        res, deltas, total, peak, eng = _scenario_run(
            torch, device, cx, cy, ti, tl, name, rounds, dispatch, fused,
            capture=rnds if first is None else None)
        drv = eng.driver
        secs = time.perf_counter() - t0
        kernel = "k2" if fused else "k1"
        for r, (link, d, ph) in enumerate(zip(res.link, deltas,
                                              res.phase_s)):
            uncoded = sum(1 for m, c in zip(link["mode_counts"],
                                            drv.mode_cfgs)
                          if m and c.mode in ("approx", "naive"))
            want = 0 if (dispatch == "select" or device.type != "cuda") \
                else uncoded
            other = "k1" if fused else "k2"
            _check(d[kernel] == want and d[other] == 0 and d["k0"] == 0,
                   f"{name} {label} round {r}: launches {d}, expected "
                   f"{want} {kernel} ({uncoded} uncoded buckets)")
            _log(f"    {name} {label} round {r}: modes {link['mode_counts']}"
                 f", active {link['n_active']}, stragglers "
                 f"{link['n_stragglers']}, launches {d}, airtime "
                 f"{link['airtime_s']:.6f} s; " + ", ".join(
                     f"{k} {v * 1e3:.3f} ms" for k, v in ph.items()))
        _check(all(math.isfinite(a) for a in res.accuracy),
               f"{name} {label}: accuracy is not finite")
        _check(all(math.isfinite(a) and a > 0 for a in res.airtime_s),
               f"{name} {label}: airtime is not finite")
        _log(f"  {name} {label}: {n_clients} clients x {rounds} rounds in "
             f"{secs:.2f} s, launches {total}, accuracy {res.accuracy}, "
             f"cumulative airtime {res.airtime_s} s, peak memory {peak}, "
             f"E[tx] of the ECRT row {drv.mode_cfgs[0].ecrt_expected_tx!r}")
        if name == "vehicular":
            results[label] = (res, deltas)
        if first is None:
            first = drv
    # Round 0's real buckets through K1 and K2 against their plain versions.
    rnd = rnds[0]
    modes = rnd.mode.cpu().numpy()
    k_tx = _round0_uplink_key(0)
    keys = transport.client_keys(k_tx, n_clients)
    n = 22528 if not small else 2048
    g = torch.Generator().manual_seed(7)
    x = torch.randn((n_clients, n), generator=g) * 1e-2
    snr_vec = channel.snr_db_vector(rnd.snr_db, n_clients)
    buckets = []
    w_all = aggregation.normalize_weights(rnd.active)
    for m, cfg in enumerate(first.mode_cfgs):
        idx = (modes == m).nonzero()[0]
        if cfg.mode not in ("approx", "naive") or idx.size == 0:
            continue
        count, cap = int(idx.size), transport._bucket_capacity(int(idx.size))
        xb, kb, sb = transport._gather_bucket(x, keys, snr_vec, idx, count,
                                              cap)
        seeds = ops._seed_from_key(kb).to(device)
        npow, gains = transport._link_params(cfg, cap, sb.to(device), device)
        wb = torch.zeros(cap)
        wb[:count] = w_all[torch.from_numpy(idx)]
        k = cfg.scheme.bits_per_symbol
        kw = dict(bits_per_symbol=k, fading="rayleigh", clamp_mask=0xBFFFFFFF,
                  word_bits=32)
        xd = xb.to(device).contiguous()
        nd, e1, xk, edges = _compare_k1(torch, xd, seeds, npow, gains, kw,
                                        num_active=count)
        _check(not bool(xk[count:].any()), "masked bucket rows are not zero")
        e2 = _compare_k2(torch, xd, seeds, npow, gains, wb.to(device), kw,
                         xk, edges, num_active=count)
        buckets.append((k, cap, count))
        _log(f"  round 0 bucket {cfg.modulation}: k={k}, capacity {cap}, "
             f"num_active {count}, SNR {float(sb[:count].min()):.2f}.."
             f"{float(sb[:count].max()):.2f} dB: K1 words differing {nd} "
             f"(edge-bound), max|err| K1 {e1:.3g}, K2 {e2:.3g}")
    # Bucketed with kernel rows cleared against select, on the round's modes.
    cleared = transport.clear_kernel_rows(first.mode_cfgs)
    x = (torch.randn((n_clients, 21840 if not small else 1000),
                     generator=g) * 1e-2).to(device)
    xb, sb_ = transport.transmit_batch_adaptive(
        x, k_tx, cleared, modes, snr_db=rnd.snr_db, dispatch="bucketed",
        device=device)
    xs, ss_ = transport.transmit_batch_adaptive(
        x, k_tx, cleared, modes, snr_db=rnd.snr_db, dispatch="select",
        device=device)
    _check(torch.equal(_bits(torch, xb), _bits(torch, xs))
           and torch.equal(sb_.bit_errors, ss_.bit_errors),
           "bucketed (kernel rows cleared) differs from select")
    _log(f"  bucketed (kernel rows cleared) == select, bit for bit, on "
         f"round 0's modes ({n_clients} x {x.shape[1]} floats)")
    if device.type == "cuda":
        _link_card_vs_cpu(torch, device)
    _link_step_times(torch, device, n_clients, first)
    return buckets, results


def _link_card_vs_cpu(torch, device) -> None:
    """A 6-client scenario run on the card against the CPU plain path."""
    from repro_torch.link import scenario as scenario_lib

    cx, cy, ti, tl = _world(6, small=True)
    scen = dataclasses.replace(scenario_lib.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0, dropout_prob=0.1)
    for dispatch, fused in (("bucketed", False), ("bucketed", True),
                            ("select", False)):
        a = _scenario_run(torch, device, cx, cy, ti, tl, scen, 3, dispatch,
                          fused)[0]
        b = _scenario_run(torch, torch.device("cpu"), cx, cy, ti, tl, scen,
                          3, dispatch, fused)[0]
        tol = 2 / len(tl) + 1e-6
        _check([r["mode_counts"] for r in a.link]
               == [r["mode_counts"] for r in b.link]
               and [r["n_active"] for r in a.link]
               == [r["n_active"] for r in b.link],
               f"scenario modes differ between the card and the CPU "
               f"({dispatch}, fused={fused})")
        _check(all(abs(p - q) <= tol for p, q in zip(a.accuracy, b.accuracy)),
               f"scenario GPU {a.accuracy} vs CPU {b.accuracy} accuracy")
        _check(all(abs(p - q) <= 1e-6 * q
                   for p, q in zip(a.airtime_s, b.airtime_s)),
               "scenario GPU and CPU airtime differ")
        _log(f"  6-client vehicular, {dispatch} fused={fused}: modes "
             f"{[r['mode_counts'] for r in a.link]}, GPU {a.accuracy} vs "
             f"CPU {b.accuracy}")


def _link_step_times(torch, device, n_clients, driver) -> None:
    """The link step (dynamics, estimator, policy, Bernoullis) for the
    cohort, on the host where the engine runs it and on the device."""
    from repro_torch.core import prng
    from repro_torch.link import scenario as scenario_lib

    clock = Clock(torch, device)
    reps = 20 if device.type == "cuda" else 3
    for name in ("vehicular", "iot-flaky"):
        drv = scenario_lib.ScenarioDriver(
            dataclasses.replace(scenario_lib.get_scenario(name),
                                ecrt_expected_tx=2.0), driver.mode_cfgs[1],
            device=device)
        for where in ("cpu", device):
            key = prng.PRNGKey(3, device=where)
            state, mode, est = drv.init(key, n_clients)
            ms = clock.host_median_ms(
                lambda: drv.round(state, mode, est, key), reps)
            _log(f"  link step ({name}, {n_clients} clients) on "
                 f"{torch.device(where).type}: {ms:.3f} ms (median of "
                 f"{reps})")


def _uncoded_kernel(cfg) -> bool:
    return cfg.use_kernel and cfg.mode in ("approx", "naive")


def _downlink_buckets(eng, link) -> int:
    """K1 launches a round's broadcast should make: one per non-empty
    uncoded ``use_kernel`` mode of an adaptive downlink (none under select,
    whose kernel rows are cleared), else one if the broadcast's config is
    on the kernel path."""
    dl = eng.downlink
    if dl is None:
        return 0
    if dl.adaptive:
        if eng.dispatch == "select":
            return 0
        return sum(1 for m, c in zip(link["downlink_mode_counts"],
                                     eng.driver.mode_cfgs)
                   if m and _uncoded_kernel(c))
    return int(_uncoded_kernel(eng.dl_cfg))


def _uplink_buckets(eng, link) -> int:
    """K1 (layered) or K2 (fused) launches of a round's uplink."""
    if eng.driver is None:
        return int(_uncoded_kernel(eng.transport_cfg))
    if eng.dispatch == "select":
        return 0
    return sum(1 for m, c in zip(link["mode_counts"], eng.driver.mode_cfgs)
               if m and _uncoded_kernel(c))


def _log_rounds(label, res, deltas) -> None:
    for r, (d, ph) in enumerate(zip(deltas, res.phase_s)):
        link = res.link[r] if res.link else {}
        modes = ""
        if "mode_counts" in link:
            modes = f"modes {link['mode_counts']}, "
        if "downlink_mode_counts" in link:
            modes += f"downlink modes {link['downlink_mode_counts']}, "
        if "comp_ratio" in link:
            modes += (f"comp_ratio {link['comp_ratio']:.6f}, comp_bits_on_air "
                      f"{link['comp_bits_on_air']:.0f}, comp_residual_norm "
                      f"{link['comp_residual_norm']:.6g}, ")
        dl = ""
        if "downlink_ber" in link:
            dl = (f"downlink BER {link['downlink_ber']:.5f}, airtime "
                  f"{link['downlink_airtime_s']:.6f} s; ")
        _log(f"    {label} round {r}: {modes}launches {d}, {dl}" + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in ph.items()))


def phase_downlink(torch, device, small: bool) -> dict:
    """Phase 5e: FedAvg and the downlink broadcast at full width. Returns
    the K1/K2 launches of its runs, which are main-path launches."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import engine
    from repro_torch.link import scenario as scenario_lib

    _log("== phase 5e: FedAvg and the downlink at full width")
    n_clients = 8 if small else 100
    cx, cy, ti, tl = _world(n_clients, small)
    on_card = device.type == "cuda"
    approx_dl = scenario_lib.DownlinkConfig(mode="approx", snr_offset_db=0.0)

    def fedavg(scale="none"):
        return engine.FedAvg(config(), local_steps=4, batch_per_step=32,
                             scale_mode=scale)

    def fedsgd():
        return engine.FedSGD(config(), batch_per_round=32)

    runs = [  # label, algorithm, scenario, dispatch, fused, downlink
        ("(a) FedAvg none, layered (K1)", fedavg, None, "bucketed", False,
         None),
        ("(a) FedAvg none, fused (K2)", fedavg, None, "bucketed", True,
         None),
        ("(a) FedAvg max_abs, layered (K1)", lambda: fedavg("max_abs"),
         None, "bucketed", False, None),
        ("(b) FedSGD + approx downlink, layered", fedsgd, None, "bucketed",
         False, approx_dl),
        ("(b) FedSGD + approx downlink, fused", fedsgd, None, "bucketed",
         True, approx_dl),
        ("(b) FedAvg + approx downlink, layered", fedavg, None, "bucketed",
         False, approx_dl),
        ("(b) FedAvg + approx downlink, fused", fedavg, None, "bucketed",
         True, approx_dl),
    ]
    for preset in ("static-noisy-dl", "vehicular-noisy-dl"):
        for dispatch, fused, shape in (("bucketed", False, "bucketed layered"),
                                       ("bucketed", True, "bucketed fused"),
                                       ("select", False, "select")):
            runs.append((f"(c) {preset}, FedAvg, {shape}", fedavg, preset,
                         dispatch, fused, None))
    launches = {"k0": 0, "k1": 0, "k2": 0}
    for label, make, scen, dispatch, fused, dl in runs:
        t0 = time.perf_counter()
        res, deltas, total, peak, eng = _scenario_run(
            torch, device, cx, cy, ti, tl, scen, 3, dispatch, fused,
            algo=make(), downlink=dl)
        secs = time.perf_counter() - t0
        _log_rounds(label, res, deltas)
        for r, d in enumerate(deltas):
            link = res.link[r] if res.link else {}
            down, up = _downlink_buckets(eng, link), _uplink_buckets(eng,
                                                                     link)
            want = {"k0": 0, "k1": down + (0 if fused else up),
                    "k2": up if fused else 0}
            if not on_card:
                want = {"k0": 0, "k1": 0, "k2": 0}
            _check(d == want, f"{label} round {r}: launches {d}, expected "
                              f"{want} ({down} downlink, {up} uplink)")
        _check(all(math.isfinite(a) for a in res.accuracy),
               f"{label}: accuracy is not finite")
        _check(all(math.isfinite(a) and a > 0 for a in res.airtime_s),
               f"{label}: airtime is not finite")
        if eng.downlink is not None:
            _check(len(res.link) == 3 and all(
                "downlink_airtime_s" in l for l in res.link),
                f"{label}: no downlink telemetry")
        for k in launches:
            launches[k] += total[k]
        _log(f"  {label}: {n_clients} clients x 3 rounds in {secs:.2f} s, "
             f"launches {total}, accuracy {res.accuracy}, cumulative "
             f"airtime {res.airtime_s} s, peak memory {peak}")
    _gradient_repair_times(torch, device, cx, cy)
    _broadcast_vs_plain(torch, device, small)
    _perfect_equals_none(torch, device, cx, cy, ti, tl)
    if on_card:
        _fedavg_card_vs_cpu(torch, device)
    return launches


def _payload_times(torch, device, cx, cy, label="") -> None:
    """Each algorithm's payload from the shared global model (``payload``)
    and from per-client copies (``payload_from``, batched-weight convs),
    on one round's batches: host-clock medians between synchronises, in
    the order shared, per-client, per-client, shared."""
    import numpy as np

    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import prng
    from repro_torch.fl import cnn, engine

    clock = Clock(torch, device)
    reps = 10 if device.type == "cuda" else 2
    params = cnn.init_params(prng.PRNGKey(0), config(), device)
    m = cx.shape[0]
    recv = {k: v.expand((m,) + tuple(v.shape)).contiguous()
            for k, v in params.items()}
    for name, algo in (("FedSGD", engine.FedSGD(config())),
                       ("FedAvg, 4 local steps", engine.FedAvg(config()))):
        xb, yb = algo.sample(np.random.default_rng(0), cx, cy, device)
        shared = lambda: algo.payload(params, xb, yb)  # noqa: E731
        own = lambda: algo.payload_from(recv, xb, yb)  # noqa: E731
        s1 = clock.host_median_ms(shared, reps)
        o1 = clock.host_median_ms(own, reps)
        o2 = clock.host_median_ms(own, reps)
        s2 = clock.host_median_ms(shared, reps)
        _log(f"  {label}{name}, {m} clients: payload (shared weights) "
             f"{min(s1, s2):.3f} ms (runs {s1:.3f}, {s2:.3f}), payload_from "
             f"(per-client weights) {min(o1, o2):.3f} ms (runs {o1:.3f}, "
             f"{o2:.3f}) (medians of {reps})")


def _gradient_repair_times(torch, device, cx, cy) -> None:
    """The gradient phase with PyTorch's own relu and max-pool derivatives
    (the CNN before its repair) and with the reference's (``cnn.relu``,
    ``cnn.pool2``), in the order before, after, after, before: the same
    forward values, so only the backward differs."""
    import torch.nn.functional as F

    from repro_torch.fl import cnn

    repaired = (cnn.relu, cnn.pool2)
    plain = (torch.relu, lambda x: F.max_pool2d(x, 2))
    try:
        for label, (relu, pool) in (
                ("before the repair (torch derivatives): ", plain),
                ("after the repair (reference derivatives): ", repaired),
                ("after the repair (reference derivatives): ", repaired),
                ("before the repair (torch derivatives): ", plain)):
            cnn.relu, cnn.pool2 = relu, pool
            _payload_times(torch, device, cx, cy, label)
    finally:
        cnn.relu, cnn.pool2 = repaired


def _broadcast_vs_plain(torch, device, small: bool) -> None:
    """(d) Round 0's broadcast at the main-path shape (the round-0 model,
    100 clients, the round key on the downlink lane) through
    ``transmit_broadcast`` (K1 on the card) against the plain K1 on the
    same tile: 0 differing words; again at N = 22,528, whole tiles, which
    the wrapper hands to the kernel without a padding copy."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, prng, transport
    from repro_torch.fl import cnn
    from repro_torch.kernels import ops, ref

    c = 8 if small else 100
    key = prng.PRNGKey(0)
    key, pk = prng.split(key)
    _, rk = prng.split(key)
    params = cnn.init_params(pk, config(), device)
    flat, _ = transport.pack(transport.tree_flatten(params)[0])
    cfg = transport.TransportConfig(
        mode="approx", modulation="qpsk",
        channel=channel.ChannelConfig(snr_db=10.0), use_kernel=True)
    keys = transport.client_keys(rk, c, transport.DOWNLINK_KEY_LANE)
    seeds = ops._seed_from_key(keys).to(device)
    npow, gains = transport._link_params(cfg, c, None, device)
    g = torch.Generator().manual_seed(12)
    whole = (torch.randn((22528,), generator=g) * 1e-2).to(device)
    for name, x in (("round-0 model", flat), ("whole tiles", whole)):
        n = x.shape[0]
        xg, sg = transport.transmit_broadcast(x, rk, cfg, c, device=device)
        tile = torch.nn.functional.pad(x.expand(c, n), (0, (-n) % 1024))
        xp, ep, edges = ref.approx_channel_batch_ref(
            tile, seeds, npow, gains, bits_per_symbol=2, fading="rayleigh",
            clamp_mask=0xBFFFFFFF, word_bits=32, with_edges=True)
        diff = _bits(torch, xg) != _bits(torch, xp[:, :n])
        pad_errs = ops._padding_errors(xp[:, n:], 32)
        _check(not bool(diff.any()),
               f"broadcast ({name}) through K1 differs from the plain "
               f"version in {int(diff.sum())} words")
        _check(torch.equal(sg.bit_errors.to(torch.int32),
                           (ep - pad_errs).to(torch.int32)),
               f"broadcast ({name}) bit errors differ from the plain version")
        err = (xg - xp[:, :n]).abs()
        err = err[torch.isfinite(err)]
        _log(f"  (d) broadcast, {name}: {c} x {n} floats through "
             f"transmit_broadcast vs the plain K1: words differing "
             f"{int(diff.sum())}, max|err| "
             f"{float(err.max()) if err.numel() else 0.0:.3g}, mean BER "
             f"{float(sg.ber.mean()):.5f}")


def _perfect_equals_none(torch, device, cx, cy, ti, tl) -> None:
    """(d) A perfect downlink equals no downlink, bit for bit (FedSGD
    layered and FedAvg fused, 2 rounds at full width)."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, transport
    from repro_torch.fl import engine
    from repro_torch.link import scenario as scenario_lib

    tcfg = transport.TransportConfig(
        mode="approx", modulation="qpsk",
        channel=channel.ChannelConfig(snr_db=10.0), use_kernel=True)
    for label, make, fused in (
            ("FedSGD layered", lambda: engine.FedSGD(config()), False),
            ("FedAvg fused", lambda: engine.FedAvg(config()), True)):
        out = []
        for dl in (None, scenario_lib.DownlinkConfig(mode="perfect")):
            eng = engine.RoundEngine(make(), tcfg, cx, cy, ti, tl,
                                     n_rounds=2, seed=0, eval_every=1,
                                     fused_aggregate=fused, downlink=dl,
                                     device=device)
            out.append((eng.run(), eng.params))
        (a, pa), (b, pb) = out
        same = all(torch.equal(_bits(torch, pa[k]), _bits(torch, pb[k]))
                   for k in pa)
        _check(same and a.accuracy == b.accuracy,
               f"perfect downlink differs from no downlink ({label})")
        _log(f"  (d) perfect downlink == no downlink, bit for bit ({label}, "
             f"2 rounds): accuracy {b.accuracy}, airtime {a.airtime_s} -> "
             f"{b.airtime_s} s")


def _fedavg_card_vs_cpu(torch, device) -> None:
    """(d) A 6-client FedAvg ``max_abs`` run on ``vehicular-noisy-dl``
    (bucketed, kernel rows), on the card and on the CPU."""
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import engine
    from repro_torch.link import scenario as scenario_lib

    cx, cy, ti, tl = _world(6, small=True)
    scen = dataclasses.replace(
        scenario_lib.get_scenario("vehicular-noisy-dl"),
        ecrt_expected_tx=2.0)
    out = []
    for dev in (device, torch.device("cpu")):
        algo = engine.FedAvg(config(), local_steps=2, batch_per_step=8,
                             scale_mode="max_abs")
        out.append(_scenario_run(torch, dev, cx, cy, ti, tl, scen, 3,
                                 "bucketed", False, algo=algo)[0])
    a, b = out
    tol = 2 / len(tl) + 1e-6
    for f in ("mode_counts", "downlink_mode_counts", "n_active"):
        _check([r[f] for r in a.link] == [r[f] for r in b.link],
               f"FedAvg max_abs {f} differ between the card and the CPU")
    _check(all(abs(p - q) <= tol for p, q in zip(a.accuracy, b.accuracy)),
           f"FedAvg max_abs GPU {a.accuracy} vs CPU {b.accuracy} accuracy")
    _check(all(abs(p - q) <= 1e-6 * q
               for p, q in zip(a.airtime_s, b.airtime_s)),
           "FedAvg max_abs GPU and CPU airtime differ")
    _log(f"  (d) 6-client FedAvg max_abs, vehicular-noisy-dl, bucketed: "
         f"modes {[r['mode_counts'] for r in a.link]}, downlink modes "
         f"{[r['downlink_mode_counts'] for r in a.link]}, GPU {a.accuracy} "
         f"vs CPU {b.accuracy}")


def _sparse_bits_on_air(cfg, k: int, comp, dim: int) -> float:
    """Bits one client puts on the air for a ``k``-slot sparse frame on
    ``cfg``: the value leg (32 bits a value uncoded or perfect; rate-1/2
    coded times E[tx] on ECRT) plus the index header, ``index_bits(dim)``
    bits a slot: Gray (two bits a symbol), perfect (full packing) or ECRT
    (packed 32-bit words, coded, times the header's E[tx])."""
    from repro_torch.compress import framing

    b, km = framing.index_bits(dim), cfg.scheme.bits_per_symbol
    value = 2 * 32 * k * cfg.ecrt_expected_tx if cfg.mode == "ecrt" \
        else 32 * k
    if comp.header == "gray":
        header = -(-k * b // 2) * km
    elif comp.header == "perfect":
        header = -(-k * b // km) * km
    else:
        header = 2 * 32 * -(-k * b // 32) * comp.header_ecrt_expected_tx
    return value + header


def _check_comp_bits(label, eng, res, rnds) -> None:
    """``comp_bits_on_air`` of every round against
    :func:`_sparse_bits_on_air` summed over the round's active clients."""
    m, dim = eng.num_clients, eng._comp_dim
    for r, link in enumerate(res.link):
        if eng.driver is None:
            modes, active = [0] * m, [1.0] * m
            cfgs, ks = [eng.transport_cfg], [eng._comp_k]
        else:
            modes = rnds[r].mode.cpu().tolist()
            active = rnds[r].active.cpu().tolist()
            cfgs, ks = eng.driver.mode_cfgs, eng._comp_ks
        want = sum(a * _sparse_bits_on_air(cfgs[md], ks[md], eng.compression,
                                           dim)
                   for md, a in zip(modes, active))
        got = link["comp_bits_on_air"]
        _check(abs(got - want) <= 1e-6 * want,
               f"{label} round {r}: comp_bits_on_air {got} != {want}")


def phase_sparse(torch, device, small: bool) -> tuple:
    """Phase 5f: sparse uplinks at full width. Returns the K1/K2 launches
    of its runs (main-path launches) and the sparse value-leg shapes for
    phase 6 as ``(label, clients, k, bits_per_symbol)``."""
    from repro_torch.compress import framing, sparsify
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import engine
    from repro_torch.link import scenario as scenario_lib

    _log("== phase 5f: sparse uplinks at full width")
    n_clients = 8 if small else 100
    cx, cy, ti, tl = _world(n_clients, small)
    on_card = device.type == "cuda"
    topk = sparsify.CompressionConfig()
    approx_dl = scenario_lib.DownlinkConfig(mode="approx", snr_offset_db=0.0)

    def fedsgd():
        return engine.FedSGD(config(), batch_per_round=32)

    def fedavg_max_abs():
        return engine.FedAvg(config(), local_steps=4, batch_per_step=32,
                             scale_mode="max_abs")

    runs = [  # label, algorithm, scenario, dispatch, compression, downlink
        ("(a) FedSGD top-k 0.02, Gray header", fedsgd, None, "bucketed",
         topk, None),
        ("(a) FedSGD top-k 0.02, perfect header", fedsgd, None, "bucketed",
         dataclasses.replace(topk, header="perfect"), None),
        ("(a) FedSGD rand-k 0.02, ECRT header", fedsgd, None, "bucketed",
         sparsify.CompressionConfig(method="randk", header="ecrt"), None),
        ("(b) FedSGD top-k + approx downlink", fedsgd, None, "bucketed",
         topk, approx_dl),
        ("(c) FedAvg max_abs, top-k", fedavg_max_abs, None, "bucketed",
         topk, None),
        ("(d) iot-lowrate, bucketed", fedsgd, "iot-lowrate", "bucketed",
         None, None),
        ("(e) vehicular, k=437, select", fedsgd, "vehicular", "select",
         sparsify.CompressionConfig(k=437), None),
    ]
    # Round 0's value leg and header of the first run, as the engine hands
    # them to the sparse batch.
    legs, inner = [], framing.sparse_batch_with_keys

    def captured(values, indices, dim, keys, cfg, snr_vec, comp=None):
        legs.append((values, indices, dim, keys, cfg, snr_vec, comp))
        return inner(values, indices, dim, keys, cfg, snr_vec, comp)

    launches = {"k0": 0, "k1": 0, "k2": 0}
    shapes, leg0 = [], None
    for label, make, scen, dispatch, comp, dl in runs:
        rnds = []
        framing.sparse_batch_with_keys = captured if leg0 is None else inner
        t0 = time.perf_counter()
        try:
            res, deltas, total, peak, eng = _scenario_run(
                torch, device, cx, cy, ti, tl, scen, 3, dispatch, False,
                capture=rnds if scen else None, algo=make(), downlink=dl,
                compression=comp)
        finally:
            framing.sparse_batch_with_keys = inner
        secs = time.perf_counter() - t0
        if leg0 is None:
            leg0 = legs[0]
        _log_rounds(label, res, deltas)
        for r, d in enumerate(deltas):
            link = res.link[r]
            down, up = _downlink_buckets(eng, link), _uplink_buckets(eng,
                                                                     link)
            want = {"k0": 0, "k1": down + up, "k2": 0}
            if not on_card:
                want = {"k0": 0, "k1": 0, "k2": 0}
            _check(d == want, f"{label} round {r}: launches {d}, expected "
                              f"{want} ({down} downlink, {up} uplink)")
        _check_comp_bits(label, eng, res, rnds)
        _check(all(math.isfinite(a) for a in res.accuracy),
               f"{label}: accuracy is not finite")
        _check(all(math.isfinite(a) and a > 0 for a in res.airtime_s),
               f"{label}: airtime is not finite")
        for k in launches:
            launches[k] += total[k]
        if scen == "iot-lowrate":
            ks = eng._comp_ks
            modes = rnds[0].mode.cpu().numpy()
            for m, cfg in enumerate(eng.driver.mode_cfgs):
                count = int((modes == m).sum())
                if count and _uncoded_kernel(cfg):
                    shapes.append((f"iot-lowrate round 0 {cfg.modulation}",
                                   count, ks[m], cfg.scheme.bits_per_symbol))
        _log(f"  {label}: {n_clients} clients x 3 rounds in {secs:.2f} s, "
             f"launches {total}, accuracy {res.accuracy}, cumulative "
             f"airtime {res.airtime_s} s, peak memory {peak}")
    shapes.insert(0, ("main path, driverless", n_clients,
                      int(leg0[0].shape[1]), 2))
    _sparse_leg_vs_plain(torch, device, leg0)
    _gray_header_card_vs_cpu(torch, device, leg0)
    _ef_and_order_card_vs_cpu(torch, device, small)
    if on_card:
        _sparse_card_vs_cpu(torch, device)
    return launches, shapes


def _sparse_leg_vs_plain(torch, device, leg) -> None:
    """Round 0's value leg, ``(M, k)`` words on the clients' keys, through
    ``transport._batch_with_keys`` (one K1 launch on the card) against the
    plain K1 on the same zero-padded tile: 0 differing words, the same bit
    errors (the padding's subtracted)."""
    from repro_torch.core import transport
    from repro_torch.kernels import ops, ref

    values, _, _, keys, cfg, snr_vec, _ = leg
    c, k = values.shape
    xg, sg = transport._batch_with_keys(values, keys, cfg, snr_vec)
    tile = torch.nn.functional.pad(values, (0, (-k) % 1024))
    seeds = ops._seed_from_key(keys).to(device)
    npow, gains = transport._link_params(cfg, c, snr_vec, device)
    wb, mask, kbits = transport._transport_kernel_params(cfg)
    xp, ep = ref.approx_channel_batch_ref(
        tile, seeds, npow, gains, bits_per_symbol=kbits,
        fading=cfg.channel.fading, fade_block=cfg.channel.block_len,
        clamp_mask=mask, word_bits=wb)
    diff = _bits(torch, xg) != _bits(torch, xp[:, :k])
    _check(not bool(diff.any()),
           f"sparse value leg through K1 differs from the plain version in "
           f"{int(diff.sum())} words")
    _check(torch.equal(sg.bit_errors.to(torch.int32),
                       (ep - ops._padding_errors(xp[:, k:], wb)).to(
                           torch.int32)),
           "sparse value leg bit errors differ from the plain version")
    _log(f"  value leg, round 0: {c} x {k} words (one {tile.shape[1]}-word "
         f"tile each) through K1 vs the plain K1: words differing "
         f"{int(diff.sum())}, mean BER {float(sg.ber.mean()):.5f}")


def _gray_header_card_vs_cpu(torch, device, leg) -> None:
    """Round 0's Gray header on the device against the CPU: any received
    index that differs must carry a bit of a symbol within
    ``_layered_edge`` of a decision edge (on the CPU's channel draws)."""
    from repro_torch.compress import framing
    from repro_torch.core import modulation, prng, transport

    _, indices, dim, keys, cfg, _, comp = leg
    c, k = indices.shape
    hk = prng.fold_in(keys, framing.HEADER_KEY_LANE)
    got, st = framing._header_batch(indices, dim, hk, cfg, comp, None)
    cpu_idx = indices.cpu()
    want, sw = framing._header_batch(cpu_idx, dim, hk, cfg, comp, None)
    bits = framing._index_bit_vector(cpu_idx, dim)
    n_hdr, b = bits.shape[1], framing.index_bits(dim)
    bp = torch.nn.functional.pad(bits, (0, n_hdr % 2)).reshape(c, -1, 2)
    km = cfg.scheme.bits_per_symbol
    sym = (bp[..., 0] << (km - 1)) | (bp[..., 1] << (km - 2))
    y, _ = transport._through_channel(sym, hk, cfg, None)
    near = modulation.decision_margin(y, cfg.scheme) < _layered_edge(
        cfg.scheme.levels)
    # symbol s carries header bits 2s and 2s + 1, of slots (2s) // b, ...
    slot_near = torch.zeros((c, k), dtype=torch.bool)
    for bit in (0, 1):
        pos = (2 * torch.arange(sym.shape[1]) + bit).clamp(max=n_hdr - 1)
        slot_near |= torch.zeros((c, k), dtype=torch.int32).index_add_(
            1, pos // b, near.to(torch.int32)).bool()
    differ = got.cpu() != want
    _check(not bool((differ & ~slot_near).any()),
           "Gray header: a received index differs between the card and the "
           "CPU away from a decision edge")
    _log(f"  Gray header, round 0: {c} x {k} indices ({sym.shape[1]} "
         f"symbols each) on the {device.type} vs the CPU: indices differing "
         f"{int(differ.sum())} (edge-bound: {int(slot_near.sum())} slots "
         f"near an edge), header bit errors {float(st.bit_errors.sum()):.0f}"
         f" vs {float(sw.bit_errors.sum()):.0f}")


def _ef_and_order_card_vs_cpu(torch, device, small: bool) -> None:
    """Error feedback on the device: ``scatter(values) + residual == acc``
    bit for bit for active clients, the whole accumulation kept by dropped
    ones; and top-k's order on NaN, +-inf, +-0 and ties, the device
    against the CPU."""
    from repro_torch.compress import sparsify

    m, d, k = (8, 1000, 20) if small else (100, 21840, 437)
    g = torch.Generator().manual_seed(16)
    res = torch.randn((m, d), generator=g) * 1e-2
    grads = torch.round(torch.randn((m, d), generator=g) * 64) / 2**12
    active = (torch.rand((m,), generator=g) > 0.1).float()
    active[1] = 0.0
    cfg = sparsify.CompressionConfig(k=k)
    out = {}
    for where in ("cpu", device):
        r, gr, a = res.to(where), grads.to(where), active.to(where)
        vals, idx, new = sparsify.ef_select_batch(r, gr, k, cfg, active=a)
        acc = r + gr
        sent = sparsify.scatter_dense_batch(vals, idx, d)
        on = a.bool()
        _check(torch.equal(_bits(torch, (sent + new)[on]),
                           _bits(torch, acc[on]))
               and torch.equal(_bits(torch, new[~on]), _bits(torch, acc[~on])),
               f"error-feedback identity fails on the {torch.device(where)}")
        out[torch.device(where).type] = (idx.cpu(), _bits(torch, new).cpu())
    if device.type == "cuda":
        _check(torch.equal(out["cpu"][0], out["cuda"][0])
               and torch.equal(out["cpu"][1], out["cuda"][1]),
               "error-feedback selection or residual differs between the "
               "card and the CPU")
    special = grads.clone()
    special[:, :12] = torch.tensor(
        [float("nan"), float("nan"), float("inf"), float("-inf"), 0.0, -0.0,
         0.0, -0.0, float("inf"), float("nan"), float("-inf"), 5.0])
    special[:, -3:] = float("nan")
    i_cpu = sparsify.select_topk(special, k)[1]
    i_dev = sparsify.select_topk(special.to(device), k)[1].cpu()
    _check(torch.equal(i_cpu, i_dev),
           "top-k order on NaN/inf/0/ties differs between the device and the "
           "CPU")
    _check(not bool(torch.isnan(special.gather(1, i_dev)).any()),
           "top-k selected a NaN ahead of a finite coordinate")
    _log(f"  error feedback on the {device.type}: identity bit for bit over "
         f"{int(active.sum())} active clients, {m - int(active.sum())} "
         f"dropped keep their accumulation; top-k order with NaN/inf/0/ties "
         f"equal to the CPU's ({m} x {d}, k = {k})")


def _sparse_card_vs_cpu(torch, device) -> None:
    """A 6-client compressed run (``iot-lowrate``: top-k, Gray header,
    per-mode budgets, bucketed) on the card and on the CPU: the same modes
    and selected indices at every round, accuracy within 2 test images."""
    from repro_torch.compress import sparsify
    from repro_torch.link import scenario as scenario_lib

    cx, cy, ti, tl = _world(6, small=True)
    scen = dataclasses.replace(scenario_lib.get_scenario("iot-lowrate"),
                               ecrt_expected_tx=2.0)
    inner = sparsify.select_batch
    out = []
    for dev in (device, torch.device("cpu")):
        picks = []

        def recorded(x, k, cfg, keys=None):
            vals, idx = inner(x, k, cfg, keys)
            picks.append(idx.cpu())
            return vals, idx

        sparsify.select_batch = recorded
        try:
            res = _scenario_run(torch, dev, cx, cy, ti, tl, scen, 3,
                                "bucketed", False)[0]
        finally:
            sparsify.select_batch = inner
        out.append((res, picks))
    (a, pa), (b, pb) = out
    tol = 2 / len(tl) + 1e-6
    _check([r["mode_counts"] for r in a.link]
           == [r["mode_counts"] for r in b.link]
           and [r["n_active"] for r in a.link]
           == [r["n_active"] for r in b.link],
           "compressed run: modes differ between the card and the CPU")
    _check(len(pa) == len(pb) and all(torch.equal(p, q)
                                      for p, q in zip(pa, pb)),
           "compressed run: selected indices differ between the card and "
           "the CPU")
    _check(all(abs(p - q) <= tol for p, q in zip(a.accuracy, b.accuracy)),
           f"compressed run: GPU {a.accuracy} vs CPU {b.accuracy} accuracy")
    _log(f"  6-client iot-lowrate, bucketed: modes "
         f"{[r['mode_counts'] for r in a.link]}, {len(pa)} bucket "
         f"selections equal on the card and the CPU, GPU {a.accuracy} vs "
         f"CPU {b.accuracy}")


_TOP_PHASES = ("link", "downlink", "gradients", "uplink", "apply", "eval")
_SAMPLE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+")


def _openmetrics_ok(text: str) -> bool:
    """OpenMetrics text: every line a ``# HELP`` / ``# TYPE`` comment or a
    ``name[{labels}] value`` sample with a numeric value, then ``# EOF``."""
    lines = text.split("\n")
    if lines[-2:] != ["# EOF", ""]:
        return False
    for line in lines[:-2]:
        if line.startswith(("# HELP ", "# TYPE ")):
            continue
        if not _SAMPLE.fullmatch(line):
            return False
        try:
            float(line.rsplit(" ", 1)[1])
        except ValueError:
            return False
    return True


def _check_ledger(torch, device, label, path, res):
    """A ledger the port wrote: it validates, reads back to
    ``FLResult.link``, renders as OpenMetrics text, and its provenance
    names the device."""
    from repro_torch.obs import ledger, metrics

    problems = ledger.validate_ledger(path)
    _check(problems == [], f"{label}: ledger does not validate: {problems}")
    data = ledger.read_ledger(path)
    _check(data.link == res.link, f"{label}: the ledger's link view differs "
                                  f"from FLResult.link")
    text = metrics.registry_from_ledger(path).render()
    _check(_openmetrics_ok(text), f"{label}: registry_from_ledger did not "
                                  f"render OpenMetrics text")
    prov = data.manifest["provenance"]
    want = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    _check(prov["device"] == want and prov["backend"] == device.type,
           f"{label}: provenance names {prov['device']!r} / "
           f"{prov['backend']!r}, not {want!r}")
    return data, text


def _obs_pair(torch, device, label, world, scen, dispatch, fused, out,
              ref=None, **kw):
    """One shape with the sinks attached and again without, 3 rounds each:
    params, accuracy, airtime, link and launches per round bit for bit;
    against ``ref`` (an earlier phase's sinks-off ``(result, launches per
    round)``) too. Returns ``(result, launches per round, ledger data, the
    sinks-off result, launches of both runs)``."""
    from repro_torch.obs import PhaseTimers

    path = str(out / (re.sub(r"[^a-z0-9]+", "-", label.lower()).strip("-")
                      + ".jsonl"))
    timers = PhaseTimers()
    sinks = dict(ledger=path, phase_timers=timers)
    if scen is not None:
        sinks["sketches"] = kw.pop("sketcher", True)
    res, deltas, total, _, eng = _scenario_run(
        torch, device, *world, scen, 3, dispatch, fused, **kw, **sinks)
    bare, bdeltas, btotal, _, beng = _scenario_run(
        torch, device, *world, scen, 3, dispatch, fused, **kw)
    for k in eng.params:
        _check(torch.equal(eng.params[k], beng.params[k]),
               f"{label}: {k} differs with the sinks attached")
    _check((res.accuracy, res.airtime_s, res.link, deltas)
           == (bare.accuracy, bare.airtime_s, bare.link, bdeltas),
           f"{label}: accuracy, airtime, link or launches differ with the "
           f"sinks attached")
    if ref is not None:
        ref_res, ref_deltas = ref
        _check((res.accuracy, res.airtime_s, res.link)
               == (ref_res.accuracy, ref_res.airtime_s, ref_res.link)
               and (ref_deltas is None or deltas == ref_deltas),
               f"{label}: differs from the earlier phase's run of this shape")
    _check(len(res.records) == 3 and res.link == [
        r.to_link_dict() for r in res.records if r.has_link_fields()],
        f"{label}: FLResult.link is not the records' link view")
    data, text = _check_ledger(torch, device, label, path, res)
    launches = {k: total[k] + btotal[k] for k in total}
    tel = timers.summary()["telemetry"]
    _log(f"  {label}: launches a round {deltas} (equal without sinks), "
         f"accuracy {res.accuracy}; ledger {len(data.rounds)} rounds, "
         f"{len(data.evals)} evals, {len(text.splitlines())} OpenMetrics "
         f"lines, provenance {data.manifest['provenance']['device']!r}")
    _log("    " + timers.report().replace("\n", "\n    "))
    _log(f"    telemetry scope: first {tel['first_s'] * 1e3:.3f} ms, steady "
         f"median {tel['steady_median_s'] * 1e3:.3f} ms; wall "
         f"{res.wall_s * 1e3:.1f} ms with sinks, {bare.wall_s * 1e3:.1f} ms "
         f"without; round (phase_s sum) with / without: " + ", ".join(
             f"{sum(a.get(k, 0.0) for k in _TOP_PHASES) * 1e3:.2f} / "
             f"{sum(b.get(k, 0.0) for k in _TOP_PHASES) * 1e3:.2f} ms"
             for a, b in zip(res.phase_s, bare.phase_s)))
    return res, deltas, data, bare, launches


def phase_obs(torch, device, small: bool, main_runs: dict,
              link_runs: dict) -> dict:
    """Phase 5g: the observability sinks at full width. Returns the K1/K2
    launches of its runs (main-path launches)."""
    from repro_torch.compress import sparsify
    from repro_torch.link import scenario as scenario_lib
    from repro_torch.obs import metrics

    _log("== phase 5g: observability at full width")
    on_card = device.type == "cuda"
    out = ROOT / "build" / "chip_smoke_obs"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    launches = {"k0": 0, "k1": 0, "k2": 0}

    def add(more):
        for k in launches:
            launches[k] += more[k]

    # (a) Driverless FedSGD, layered (K1) and fused (K2): ledger + timers,
    # against phase 5's runs.
    n_main = 4 if small else 100
    world = _world(n_main, small)
    for fused, kernel in ((False, "k1"), (True, "k2")):
        label = f"(a) driverless FedSGD, {'fused' if fused else 'layered'}"
        res, deltas, _, _, more = _obs_pair(
            torch, device, label, world, None, "bucketed", fused, out,
            ref=(main_runs[fused], None))
        add(more)
        want = {"k0": 0, "k1": 0, "k2": 0}
        want[kernel] = 1 if on_card else 0
        _check(all(d == want for d in deltas),
               f"{label}: launches {deltas}, expected {want} a round")
        _check(res.link == [] and len(res.records) == 3
               and all(r.uplink_bits > 0 for r in res.records),
               f"{label}: records without the uplink_* fields")
    # (b) vehicular under the three round shapes, all three sinks, against
    # phase 5d's runs; round 0's sketch inputs captured for the CPU check.
    n_link = 8 if small else 100
    world = _world(n_link, small)
    sketcher = metrics.RoundSketcher(n_link, device=device)
    inputs, inner = [], sketcher.round_group

    def captured(key, **kw):
        inputs.append((key, kw))
        return inner(key, **kw)

    sketcher.round_group = captured
    for label, dispatch, fused in (
            ("bucketed layered (K1)", "bucketed", False),
            ("bucketed fused (K2)", "bucketed", True),
            ("select (layered PHY)", "select", False)):
        kw = dict(sketcher=sketcher) if not inputs else {}
        res, _, _, _, more = _obs_pair(
            torch, device, f"(b) vehicular, {label}", world, "vehicular",
            dispatch, fused, out, ref=link_runs[label], **kw)
        add(more)
        for r, rec in enumerate(res.records):
            sk = rec.sketches
            _check(sk["ber"]["total"] == rec.n_active
                   and sk["snr_db"]["total"] == n_link
                   and sk["est_db"]["total"] == n_link,
                   f"(b) {label} round {r}: sketch totals ber "
                   f"{sk['ber']['total']} (active {rec.n_active}), snr "
                   f"{sk['snr_db']['total']}")
        if kw:
            group0 = res.records[0].sketches
    # Card against the CPU: round 0's per-client arrays (SNR, estimate,
    # BER, airtime, mode, active) copied over, through a fresh sketcher.
    key0, arrs0 = inputs[0]
    arrs0_host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in arrs0.items()}
    host = metrics.RoundSketcher(n_link, device="cpu").round_group(
        key0.cpu(), **arrs0_host)
    _check(json.dumps(host) == json.dumps(group0),
           "round 0's sketch counts or exemplars on the card differ from "
           "the CPU's")
    ex = group0["exemplars"]
    _log(f"  round 0 sketches, card == CPU: counts of "
         f"{sorted(k for k in group0 if k != 'exemplars')}, worst-BER "
         f"clients {[e['client'] for e in ex['worst_ber']]}, reservoir "
         f"clients {[e['client'] for e in ex['reservoir']]}; ber counts "
         f"(non-zero slots) {[(i, c) for i, c in enumerate(group0['ber']['counts']) if c]}")
    # The sketch reduction alone, as the engine calls it (the link step's
    # tensors on the host, BER and airtime on the device) and on a host
    # sketcher (BER and airtime copied over): medians of 20 calls.
    clock = Clock(torch, device)
    card_sk = metrics.RoundSketcher(n_link, device=device)
    host_sk = metrics.RoundSketcher(n_link, device="cpu")
    t_dev = clock.host_median_ms(
        lambda: card_sk.round_group(key0, **arrs0), 20)
    t_host = clock.host_median_ms(lambda: host_sk.round_group(
        key0, **{k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in arrs0.items()}), 20)
    _log(f"  round_group alone ({n_link} clients, 5 metrics): "
         f"{device.type} sketcher {t_dev:.3f} ms, host sketcher "
         f"{t_host:.3f} ms (median of 20)")
    # (c) Compressed (top-k) behind an approx downlink, with a ledger.
    world = _world(8 if small else 100, small)
    res, deltas, data, bare, more = _obs_pair(
        torch, device, "(c) FedSGD top-k + approx downlink", world, None,
        "bucketed", False, out, compression=sparsify.CompressionConfig(),
        downlink=scenario_lib.DownlinkConfig(mode="approx",
                                             snr_offset_db=0.0))
    add(more)
    want = {"k0": 0, "k1": 2 if on_card else 0, "k2": 0}
    _check(all(d == want for d in deltas),
           f"(c): launches {deltas}, expected {want} a round")
    fields = ("comp_ratio", "comp_bits_on_air", "comp_residual_norm",
              "downlink_airtime_s", "downlink_ber")
    _check(all(getattr(r, f) is not None for r in data.rounds
               for f in fields), "(c): records lack comp_* / downlink_*")
    _check([r.to_link_dict() for r in res.records] == bare.link,
           "(c): the records' link view differs from the sinks-off link")
    return launches


def _same_run(torch, label, a, b, da, db, ea=None, eb=None) -> None:
    """Two runs bit for bit: accuracy, airtime, link, launches a round
    (``None`` skips them) and, given both engines, the final params."""
    _check((a.accuracy, a.airtime_s, a.link) == (b.accuracy, b.airtime_s,
                                                  b.link)
           and (da is None or db is None or da == db),
           f"{label}: accuracy, airtime, link or launches a round differ")
    if ea is not None:
        for k in ea.params:
            _check(torch.equal(ea.params[k], eb.params[k]),
                   f"{label}: {k} differs")


def _check_event_s(label, res) -> None:
    _check(len(res.event_s) == len(res.rounds) == len(res.accuracy)
           and all(t2 >= t1 for t1, t2 in zip(res.event_s, res.event_s[1:])),
           f"{label}: event_s {res.event_s} is not one non-decreasing stamp "
           f"per eval")


def _log_waves(label, res, deltas, members) -> None:
    for w, (d, ph) in enumerate(zip(deltas, res.phase_s)):
        link = res.link[w] if res.link else {}
        comp = ""
        if "comp_ratio" in link:
            comp = (f"comp_bits_on_air {link['comp_bits_on_air']:.0f}, "
                    f"comp_residual_norm {link['comp_residual_norm']:.6g}, ")
        _log(f"    {label} wave {w}: {members[w]:.0f} members, modes "
             f"{link.get('mode_counts')}, active {link.get('n_active')}, "
             f"{comp}launches {d}; " + ", ".join(
                 f"{k} {v * 1e3:.3f} ms" for k, v in ph.items()))


def _buffered_card_vs_cpu(torch, device) -> None:
    """A 6-client ``metro-rush`` buffered run on the card against the CPU:
    the event schedule is the host's, so it is the same."""
    from repro_torch.link import scenario as scenario_lib
    from repro_torch.obs import trace as trace_lib

    cx, cy, ti, tl = _world(6, small=True)
    scen = dataclasses.replace(scenario_lib.get_scenario("metro-rush"),
                               ecrt_expected_tx=2.0)
    runs = []
    for dev in (device, torch.device("cpu")):
        tr = trace_lib.TraceRecorder()
        res = _scenario_run(torch, dev, cx, cy, ti, tl, scen, 4, "bucketed",
                            False, buffered=dict(buffer_k=2, trace=tr,
                                                 staleness="polynomial"))[0]
        runs.append((res, [(e.kind, e.wave, e.client, e.version)
                           for e in tr.events]))
    (a, ea), (b, eb) = runs
    tol = 2 / len(tl) + 1e-6
    _check(ea == eb, "6-client metro-rush: the event stream differs between "
                     "the card and the CPU")
    _check(all(abs(p - q) <= 1e-6 * q for p, q in zip(a.event_s, b.event_s))
           and [(r["mode_counts"], r["n_active"]) for r in a.link]
           == [(r["mode_counts"], r["n_active"]) for r in b.link],
           "6-client metro-rush: event_s or link records differ between the "
           "card and the CPU")
    _check(all(abs(p - q) <= tol for p, q in zip(a.accuracy, b.accuracy)),
           f"6-client metro-rush: GPU {a.accuracy} vs CPU {b.accuracy}")
    _log(f"  6-client metro-rush buffer_k=2, card == CPU: {len(ea)} events, "
         f"event_s {a.event_s}; accuracy GPU {a.accuracy} vs CPU "
         f"{b.accuracy}")


def phase_buffered(torch, device, small: bool, main_runs: dict,
                   link_runs: dict) -> dict:
    """Phase 5h: buffered asynchronous rounds at full width. Returns the
    K1/K2 launches of its runs (main-path launches)."""
    from repro_torch.compress import sparsify
    from repro_torch.link import scenario as scenario_lib
    from repro_torch.obs import PhaseTimers
    from repro_torch.obs import ledger as ledger_lib

    _log("== phase 5h: buffered asynchronous rounds at full width")
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    out = ROOT / "build" / "chip_smoke_async"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    launches = {"k0": 0, "k1": 0, "k2": 0}

    def add(*totals):
        for t in totals:
            for k in launches:
                launches[k] += t[k]

    # (a) Degenerate runs (buffer_k = the cohort, simultaneous arrivals,
    # constant weights) against their sync twins and phase 5's / 5d's runs.
    n_main, n_link = (4, 8) if small else (100, 100)
    world = _world(n_main, small)
    for fused, kernel in ((False, "k1"), (True, "k2")):
        label = f"(a) driverless FedSGD, {'fused' if fused else 'layered'}"
        s, sd, st, _, se = _scenario_run(torch, device, *world, None, 3,
                                         "bucketed", fused)
        b, bd, bt, peak, be = _scenario_run(torch, device, *world, None, 3,
                                            "bucketed", fused, buffered={})
        add(st, bt)
        ref = main_runs[fused]
        _same_run(torch, f"{label}, sync twin vs phase 5", s, ref, None,
                  None)
        _same_run(torch, f"{label}, buffered vs sync", b, s, bd, sd, be, se)
        want = {"k0": 0, "k1": 0, "k2": 0}
        want[kernel] = 1 if on_card else 0
        _check(all(d == want for d in bd),
               f"{label}: launches {bd}, expected {want} a wave")
        _check_event_s(label, b)
        _log(f"  {label}: buffered == sync == phase 5, launches a wave "
             f"{bd}, event_s {b.event_s}, peak memory {peak}")
        _log_waves(label, b, bd, [n_main] * len(bd))
    world = _world(n_link, small)
    base = _base_cfg()
    drivers = {name: scenario_lib.ScenarioDriver(
        scenario_lib.get_scenario(name), base, device=device)
        for name in ("vehicular", "metro-rush", "global-churn")}
    for label, fused in (("bucketed layered (K1)", False),
                         ("bucketed fused (K2)", True)):
        s, sd, st, _, se = _scenario_run(torch, device, *world,
                                         drivers["vehicular"], 3, "bucketed",
                                         fused)
        b, bd, bt, peak, be = _scenario_run(torch, device, *world,
                                            drivers["vehicular"], 3,
                                            "bucketed", fused, buffered={})
        add(st, bt)
        ref_res, ref_deltas = link_runs[label]
        _same_run(torch, f"(a) vehicular {label}, sync twin vs phase 5d", s,
                  ref_res, sd, ref_deltas)
        _same_run(torch, f"(a) vehicular {label}, buffered vs sync", b, s,
                  bd, sd, be, se)
        _check_event_s(f"(a) vehicular {label}", b)
        _log(f"  (a) vehicular {label}: buffered == sync == phase 5d, "
             f"launches a wave {bd}, event_s {b.event_s}, "
             f"peak memory {peak}")
        _log_waves(f"(a) vehicular {label}", b, bd, [n_link] * len(bd))

    def check_waves(label, res, deltas, eng):
        for w, (link, d) in enumerate(zip(res.link, deltas)):
            want = _uplink_buckets(eng, link) if on_card else 0
            _check(d == {"k0": 0, "k1": want, "k2": 0},
                   f"{label} wave {w}: launches {d}, expected {want} K1 "
                   f"(the uncoded buckets over all rows)")
        _check(all(math.isfinite(a) for a in res.accuracy),
               f"{label}: accuracy is not finite")
        _check_event_s(label, res)

    def wave_members(path):
        return [e.value for e in ledger_lib.read_ledger(path).events
                if e.kind == "wave"]

    # (b) metro-rush, the async study's two arms: buffer_k = 25 with
    # polynomial staleness (ledger, trace, timers, sketches), and the
    # cohort-sized buffer.
    k25 = 2 if small else 25
    rows = []
    for arm, rounds, bk in (("buffer_k=%d" % k25, 8, k25),
                            ("buffer_k=%d" % n_link, 3, None)):
        label = f"(b) metro-rush {arm}"
        stem = re.sub(r"[^a-z0-9]+", "-", label.lower()).strip("-")
        lpath, tpath = out / f"{stem}.jsonl", out / f"{stem}.trace.json"
        timers = PhaseTimers()
        t0 = time.perf_counter()
        res, deltas, total, peak, eng = _scenario_run(
            torch, device, *world, drivers["metro-rush"], rounds,
            "bucketed", False, ledger=str(lpath), phase_timers=timers,
            sketches=True, buffered=dict(buffer_k=bk, staleness="polynomial",
                                         staleness_alpha=0.5,
                                         trace=str(tpath)))
        secs = time.perf_counter() - t0
        add(total)
        check_waves(label, res, deltas, eng)
        problems = ledger_lib.validate_ledger(str(lpath))
        _check(problems == [], f"{label}: ledger does not validate: "
                               f"{problems}")
        data = ledger_lib.read_ledger(str(lpath))
        kinds = {e.kind for e in data.events}
        _check({"wave", "compute", "uplink", "arrival", "aggregate",
                "buffer"} <= kinds
               and [e["event_s"] for e in data.evals] == res.event_s,
               f"{label}: ledger events {sorted(kinds)} or eval stamps "
               f"incomplete")
        with open(tpath) as f:
            trace = json.load(f)
        _check(len(trace["traceEvents"]) > 0, f"{label}: empty trace")
        stale = eng.sketcher.run["staleness"]
        _check(stale.total > 0, f"{label}: the staleness histogram is empty")
        per_agg = [t2 - t1 for t1, t2 in zip([0.0] + res.event_s,
                                             res.event_s)]
        slots = [(i, c) for i, c in enumerate(stale.to_dict()["counts"])
                 if c]
        members = wave_members(str(lpath))
        _log(f"  {label}: {len(deltas)} waves, {len(res.rounds)} "
             f"aggregations in {secs:.2f} s, launches {total}, accuracy "
             f"{res.accuracy}, event_s {res.event_s}, event seconds per "
             f"aggregation {per_agg}, staleness observed "
             f"{stale.total} (non-zero slots {slots}), "
             f"peak memory {peak}; ledger {len(data.events)} events, trace "
             f"{len(trace['traceEvents'])} entries")
        _log("    " + timers.report().replace("\n", "\n    "))
        # The event loop's own host work: the run's wall time outside the
        # timer scopes and the applies (draws, heap, records, events).
        scoped = sum(v["total_s"] for v in timers.summary().values())
        applied = sum(ph.get("apply", 0.0) for ph in res.phase_s)
        _log(f"    event loop outside the scopes and applies: "
             f"{(res.wall_s - scoped - applied) * 1e3 / len(deltas):.3f} ms "
             f"a wave (wall {res.wall_s * 1e3:.1f} ms, scopes "
             f"{scoped * 1e3:.1f} ms, applies {applied * 1e3:.1f} ms)")
        _log_waves(label, res, deltas, members)
        rows.append((arm, per_agg))
    _log("  metro-rush event seconds per aggregation: " + "; ".join(
        f"{arm}: mean {statistics.fmean(p):.4f} s over {len(p)}"
        for arm, p in rows))
    # The event layer's draws alone, on the host where the engine makes
    # them (the wave key stays there): medians of 20.
    from repro_torch.core import prng
    from repro_torch.link import dynamics

    scen, key = drivers["metro-rush"].scenario, prng.PRNGKey(5)
    clock = Clock(torch, device)
    joined = torch.ones(n_link)
    churn = drivers["global-churn"].scenario.arrival
    _log(f"  event-layer draws on the host, {n_link} clients: " + ", ".join(
        f"{name} {clock.host_median_ms(fn, 20):.3f} ms" for name, fn in (
            ("compute_times", lambda: dynamics.compute_times(
                key, scen.compute, n_link)),
            ("idle_gaps", lambda: dynamics.idle_gaps(key, n_link,
                                                     scen.arrival)),
            ("churn_step", lambda: dynamics.churn_step(key, joined,
                                                       churn)))))

    # (c) global-churn, buffer_k = 25, inverse staleness, top-k 0.02: the
    # value leg one K1 batch per uncoded bucket; absent clients keep their
    # EF residual rows bit for bit.
    label = f"(c) global-churn buffer_k={k25} top-k"
    kept = []

    def residual_kept(eng, member, before):
        absent = member.to(before.device) == 0
        kept.append(int(absent.sum()))
        _check(torch.equal(eng._ef_residual[absent], before[absent]),
               f"{label}: an absent client's EF residual moved")

    t0 = time.perf_counter()
    res, deltas, total, peak, eng = _scenario_run(
        torch, device, *world, drivers["global-churn"], 6, "bucketed", False,
        compression=sparsify.CompressionConfig(), on_wave=residual_kept,
        ledger=str(out / "global-churn.jsonl"),
        buffered=dict(buffer_k=k25, staleness="inverse"))
    add(total)
    check_waves(label, res, deltas, eng)
    _check(sum(kept) > 0, f"{label}: every wave held the whole cohort")
    _log(f"  {label}: {len(deltas)} waves, {len(res.rounds)} aggregations "
         f"in {time.perf_counter() - t0:.2f} s, launches {total}, accuracy "
         f"{res.accuracy}, event_s {res.event_s}, absent clients a wave "
         f"{kept} (residuals kept bit for bit), peak memory {peak}")
    _log_waves(label, res, deltas,
               wave_members(str(out / "global-churn.jsonl")))
    if on_card:
        _buffered_card_vs_cpu(torch, device)
    _log(f"  phase 5h: {time.perf_counter() - t_phase:.1f} s, launches "
         f"{launches}")
    return launches


# ------------------------------------------- phases 5i / 5j: the LLM


LLM_ARCH = "qwen2-1.5b"
LLM_PARAMS = 1_777_088_000
# Each LLM phase's trainer run, for phase 5r: (phase, cfg, measured
# parameter count, batch, seq, the fastest step's grad span in seconds).
LLM_RUNS = []
COUNTER_WRAP_TILE = 262_144  # 2**32 symbols / (1024 words x 16 symbols)
PLAIN_CHUNK_TILES = 2048  # tiles per plain-version chunk (~9 GB of temps)
# Decode against forward in bf16: the reference test's rtol
# (test_models_smoke.py::test_decode_matches_forward, 2 layers at d_model
# 128, atol 5e-2). At full width the logits are bf16 matmul outputs of a
# hidden state that went through 28 layers of bf16 rounding, which decode
# (one row a layer) and forward (128 rows) sum in other orders: the
# absolute term is DECODE_ULPS bf16 ULPs of the largest logit.
DECODE_RTOL, DECODE_ULPS = 3e-2, 4


def _llm_cfg(small: bool):
    """qwen2-1.5b at its published widths; on the CPU rehearsal the
    trainer's ``--reduced`` widths."""
    from repro_torch.configs import get_config

    cfg = get_config(LLM_ARCH)
    return cfg.reduced(n_layers=4, d_model=256, d_ff=512,
                       vocab_size=1024) if small else cfg


def _gib(torch, device) -> float:
    if device.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _timed(torch, device, fn):
    """``(fn(), ms)``: CUDA events on the GPU, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _flat_words(torch, leaves, lo: int, hi: int):
    """Words ``[lo, hi)`` of the sorted-key concatenation of ``leaves``
    as float32, without building the whole flat payload."""
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            out.append(leaf.reshape(-1)[a - off:b - off].to(torch.float32))
        off += n
    return torch.cat(out)


def _k0_vs_plain(torch, device, xp, outs, seed, npow, gain, label):
    """Every tile of each padded row in ``outs`` (a dict of a kernel's
    name to its output on ``xp``) against one pass of the plain version of
    ``xp``, chunk by chunk on the card (``first_tile``). Returns
    ``(differing words, max |err|)`` (dicts by name), the plain version's
    errors and its ms."""
    from repro_torch.kernels import ref

    tiles = xp.numel() // 1024
    diff = dict.fromkeys(outs, 0)
    max_err = dict.fromkeys(outs, 0.0)
    errs, ms = 0, 0.0
    for t in range(0, tiles, PLAIN_CHUNK_TILES):
        n = min(PLAIN_CHUNK_TILES, tiles - t)
        xs = xp[t * 1024:(t + n) * 1024]
        (got, e), dt = _timed(torch, device, lambda: ref.ref_approx_channel(
            xs, seed, npow, gain, first_tile=t))
        ms += dt
        errs += int(e)
        for name, out in outs.items():
            kk = out[t * 1024:(t + n) * 1024]
            diff[name] += int((_bits(torch, kk) != _bits(torch, got)).sum())
            dv = (kk - got).abs()
            dv = dv[torch.isfinite(dv)]
            if dv.numel():
                max_err[name] = max(max_err[name], float(dv.max()))
    _log(f"  {label}: {tiles:,} tiles against the plain version in chunks "
         f"of {PLAIN_CHUNK_TILES}: differing words "
         + ", ".join(f"{k} {v}" for k, v in diff.items())
         + f"; plain errors {errs:,}, plain {ms:.1f} ms in all")
    return diff, max_err, errs, ms


def phase_trainer(torch, device, small: bool, sass: dict, mhz) -> tuple:
    """Phase 5i: the LLM FedSGD trainer. Returns ``(launches, K0's row of
    the kernels line)``."""
    from repro_torch.core import aggregation, channel, prng, transport
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import registry as R
    from repro_torch.obs import spans
    from repro_torch.optim.sgd import sgd

    _log(f"== phase 5i: the LLM trainer ({LLM_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'full width'})")
    t_phase = time.perf_counter()
    cfg = _llm_cfg(small)
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    argv = ["--arch", LLM_ARCH, "--steps", str(n_steps), "--mode", "approx",
            "--use-kernel", "--snr-db", "10", "--batch", str(batch),
            "--seq", str(seq), "--lr", "0.1", "--device", str(device)]
    if small:
        argv.append("--reduced")
    records = []

    def on_step(i, loss, stats, phase_s):
        records.append({
            "loss": float(loss), "phase_s": phase_s,
            "k0": ac.launch_counts()["k0"],
            "errors": float(stats.bit_errors), "n_bits": float(stats.n_bits),
            "peak": _gib(torch, device)})
        _reset_peak(torch, device)

    # (a) The main path: train.main, counters from 0 just before it and
    # read just after.
    _reset_peak(torch, device)
    ac.reset_launch_counts()
    train.main(argv, on_step=on_step)
    counts = ac.launch_counts()
    want = n_steps if device.type == "cuda" else 0
    _check(counts == {"k0": want, "k1": 0, "k2": 0},
           f"trainer launched {counts}, expected {want} K0 launches")
    prev = 0
    for i, r in enumerate(records):
        ph = r["phase_s"]
        _log(f"  step {i}: loss {r['loss']:.4f}; grad (forward + backward) "
             f"{ph.get('grad', 0) * 1e3:.1f} ms, uplink keys "
             f"{ph.get('keys', 0) * 1e3:.2f} ms, K0 "
             f"{ph.get('kernel', 0) * 1e3:.2f} ms, apply "
             f"{ph.get('apply', 0) * 1e3:.1f} ms; K0 launches "
             f"{r['k0'] - prev}; bit errors {r['errors']:.0f} of "
             f"{r['n_bits']:.0f} bits (the int32 count, as float32; read "
             f"as uint32 {int(r['errors']) % 2**32:,}; 2**31 = {2**31:,}); "
             f"peak {r['peak']:.3f} GiB")
        _check(math.isfinite(r["loss"]), f"step {i}: loss not finite")
        _check(r["k0"] - prev == (1 if device.type == "cuda" else 0),
               f"step {i}: K0 launched {r['k0'] - prev} times")
        _check(r["errors"] != 0, f"step {i}: no bit errors at 10 dB")
        prev = r["k0"]

    # (b) Step 0 again by hand: init time and peak, the gradient, a
    # perfect uplink and step.
    clock = Clock(torch, device)
    clock.sync()
    _reset_peak(torch, device)
    t0 = time.perf_counter()
    params = R.init_params(prng.PRNGKey(0, device=device), cfg)
    clock.sync()
    t_init = time.perf_counter() - t0
    leaves, _ = transport.tree_flatten(params)
    n_params = sum(p.numel() for p in leaves)
    _log(f"  init_params: {n_params:,} params in {t_init:.2f} s, peak "
         f"{_gib(torch, device):.3f} GiB")
    _check(small or n_params == LLM_PARAMS, f"{n_params} params")
    LLM_RUNS.append(("5i", cfg, n_params, batch, seq, min(
        r["phase_s"].get("grad", 0) for r in records)))
    b0 = TokenStream(cfg.vocab_size, seq, batch).next_batch()
    local = {k: torch.as_tensor(v).to(device) for k, v in b0.items()}
    loss0, grads = steps.value_and_grad(cfg, params, local)
    g32 = transport.tree_map(lambda g: g.to(torch.float32), grads)
    del grads
    _check(float(loss0) == records[0]["loss"],
           f"step 0's loss {float(loss0)} != the trainer's "
           f"{records[0]['loss']}")
    sk = prng.split(prng.PRNGKey(0, device=device))[1]
    perfect = transport.TransportConfig(mode="perfect")
    same, _ = aggregation.approx_allreduce(g32, sk, perfect)
    _check(all(torch.equal(a, b) for a, b in zip(
        transport.tree_flatten(same)[0], transport.tree_flatten(g32)[0])),
           "a perfect uplink changed the gradient")
    del same
    opt = sgd(0.1)
    want_params, _ = opt.update(g32, opt.init(params), params)
    step = steps.make_train_step_approx(cfg, opt, perfect)
    got_params, _, lossp, stp = step(params, opt.init(params), b0, sk)
    _check(all(torch.equal(a, b) for a, b in zip(
        transport.tree_flatten(got_params)[0],
        transport.tree_flatten(want_params)[0])),
           "a perfect step differs from SGD on the raw gradient")
    _check(float(stp.bit_errors) == 0, "a perfect uplink counted errors")
    _log(f"  --mode perfect step: loss {float(lossp):.4f}; the uplink leaves "
         f"the gradient bit for bit, params = SGD on it bit for bit")
    del got_params, want_params, params, leaves

    # (c) K0 on step 0's payload (the trainer's uplink under
    # fold_in(key, rank 0)): the same errors as the main path's step 0,
    # sampled tiles against the plain version on the card and the CPU.
    tcfg = transport.TransportConfig(
        mode="approx", channel=channel.ChannelConfig(snr_db=10.0),
        simulate_fec=False, ecrt_expected_tx=1.1, use_kernel=True)
    # rank 0's shard key, as approx_allreduce folds it: lint: ignore[keylane]
    shard_key = prng.fold_in(sk, 0)
    g_leaves, _ = transport.tree_flatten(g32)
    n = sum(v.numel() for v in g_leaves)
    tiles = -(-n // 1024)
    ac.reset_launch_counts()
    hat, stats = transport.transmit_pytree(g32, shard_key, tcfg,
                                           device=device)
    _check(ac.launch_counts()["k0"] == (1 if device.type == "cuda" else 0),
           "transmit_pytree did not launch K0 once")
    _check(float(stats.bit_errors) == records[0]["errors"],
           f"K0 on step 0's payload: {float(stats.bit_errors)} errors, the "
           f"trainer's step 0 {records[0]['errors']}")
    hat_leaves, _ = transport.tree_flatten(hat)
    seed = ops._seed_from_key(shard_key).to(device)
    npow = torch.tensor(tcfg.channel.noise_power, dtype=torch.float32,
                        device=device)
    gain = torch.tensor(tcfg.channel.large_scale_gain, dtype=torch.float32,
                        device=device)
    sampled = sorted({0, COUNTER_WRAP_TILE - 1, COUNTER_WRAP_TILE,
                      tiles - 1} & set(range(tiles)))
    for t in sampled:
        lo, hi = t * 1024, min((t + 1) * 1024, n)
        xt = torch.nn.functional.pad(_flat_words(torch, g_leaves, lo, hi),
                                     (0, 1024 - (hi - lo)))
        kt = _flat_words(torch, hat_leaves, lo, hi).cpu()
        for where in (device, torch.device("cpu")):
            pt, _ = ref.ref_approx_channel(
                xt.to(where), seed.to(where), npow.to(where),
                gain.to(where), first_tile=t)
            nd = int((_bits(torch, kt)
                      != _bits(torch, pt[:hi - lo].cpu())).sum())
            _check(nd == 0, f"K0 tile {t}: {nd} words differ from the "
                   f"plain version on the {where.type}")
        _log(f"  transmit_pytree, tile {t:,} (words {lo:,}-{hi - 1:,}): 0 "
             f"differing words against the plain version on the card and "
             f"on the CPU")
    del hat, hat_leaves

    # (d) The same row through K0's row kernel and through K1 at C=1 (the
    # path K0 took before it had its own kernel), timed in turns old, new,
    # new, old; then every tile of both against one pass of the plain
    # version, chunk by chunk.
    flat = torch.cat([v.reshape(-1) for v in g_leaves])
    del g32, g_leaves
    xp = ops._tiled(flat, 32, 1024)
    del flat
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xBFFFFFFF,
              word_bits=32)
    one = [t.reshape(1) for t in (seed, npow, gain)]
    new = lambda: ac.approx_channel_kernel(  # noqa: E731
        xp, seed, npow, gain, **kw)
    old = lambda: ac.approx_channel_batch_kernel(  # noqa: E731
        xp[None], *one, **kw)
    reps = 3 if device.type == "cuda" else 1
    t_old = [clock.median_ms(old, reps, warmup=1)]
    t_new = [clock.median_ms(new, reps, warmup=1)]
    t_new.append(clock.median_ms(new, reps, warmup=1))
    t_old.append(clock.median_ms(old, reps, warmup=1))
    k0_ms, k1c1_ms = min(t_new), min(t_old)
    with spans.counting(device) as k0_counts:
        out, errs = new()
        clock.sync()
    out1, errs1 = old()
    # The count is int32 in both packages (the kernel's atomicAdd, the
    # reference's sum): it wraps past 2**31 - 1, and the TxStats float32
    # rounds it; compare modulo 2**32 and through float32.
    errs_row = int(errs) - int(ops._padding_errors(out[None, n:], 32)[0])
    _check(float(torch.tensor(errs_row, dtype=torch.float32))
           == records[0]["errors"],
           f"K0 row errors {errs_row} != step 0's {records[0]['errors']}")
    diff, max_errs, errs_plain, plain_ms = _k0_vs_plain(
        torch, device, xp, {"k0": out, "k1 at C=1": out1[0]}, seed, npow,
        gain, f"K0 and K1 at C=1, row of {n:,} words")
    for name, e in (("k0", errs), ("k1 at C=1", errs1[0])):
        _check(diff[name] == 0 and (errs_plain - int(e)) % 2**32 == 0,
               f"{name} row: {diff[name]} words differ, errors {int(e)} vs "
               f"plain {errs_plain}")
    max_err = max_errs["k0"]
    _log(f"  K0 row bit errors: {errs_plain:,} by the plain version (Python "
         f"int); the kernels' int32 count {int(errs):,} "
         f"({'wrapped past' if errs_plain >= 2**31 else 'under'} 2**31 = "
         f"{2**31:,}); BER {errs_plain / (tiles * 1024 * 32):.4f}")
    del xp, out, out1
    b = _bound(1, tiles * 1024, 2, "rayleigh", 32, "k1")
    _log(f"  at N = {n:,} ({tiles:,} tiles): K0's row kernel {k0_ms:.2f} ms "
         f"(runs {t_new[0]:.2f}, {t_new[1]:.2f}; median of {reps}), K1 at "
         f"C=1 {k1c1_ms:.2f} ms (runs {t_old[0]:.2f}, {t_old[1]:.2f}), K0 / "
         f"K1 {k0_ms / k1c1_ms:.3f}; plain {plain_ms:.1f} ms; bound "
         f"{b['bound_ms']:.2f} ms ({b['bound_by']}: "
         f"{b['bytes'] / 1e9:.2f} GB -> {b['bytes_ms']:.2f} ms, "
         f"{b['ops'] / 1e12:.2f} T ops -> {b['ops_ms']:.2f} ms)")
    if sass and mhz:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        for name, tag, ms, share in (
                ("K0", "k0", k0_ms, _k0_open_share(k0_counts)),
                ("K1 at C=1", "k1", k1c1_ms, 1.0)):
            floor = share * _issue_floor_ms(tiles * 1024 * 16, sass[tag], sms,
                                            mhz)
            _log(f"  {name}: issue-rate floor {floor:.2f} ms "
                 f"({sass[tag]['total']} instructions a symbol of "
                 f"{tag}'s SASS on the {share:.1%} of symbols it ran the "
                 f"full chain on); kernel at {floor / ms:.0%} of it")

    # (e) A row of 2**28 + 1,024 words (tile 262,144 sees tile 0's draws:
    # the uint32 symbol counter wraps there, as in the reference).
    nw = 4 * 1024 + 512 if small else 2**28 + 1024
    g = torch.Generator(device=device).manual_seed(19)
    xw = torch.randn(nw, generator=g, device=device) * 1e-3
    xwp = ops._tiled(xw, 32, 1024)
    outw, errsw = ac.approx_channel_kernel(xwp, seed, npow, gain, **kw)
    diffw, _, errs_pw, _ = _k0_vs_plain(torch, device, xwp, {"k0": outw},
                                        seed, npow, gain,
                                        f"K0 row of {nw:,} words")
    _check(diffw["k0"] == 0 and errs_pw == int(errsw),
           f"K0 2**28 row: {diffw['k0']} words differ, errors {int(errsw)} "
           f"vs plain {errs_pw}")
    del xw, xwp, outw

    # (f) One layered approx step (no kernel) at the trainer's --reduced
    # widths: at full width even two layers carry 560 M floats, 9e9
    # symbols, which the layered PHY cannot hold.
    ac.reset_launch_counts()
    lr = train.main(["--arch", LLM_ARCH, "--reduced", "--steps", "1",
                     "--mode", "approx", "--batch", "2", "--seq", "16",
                     "--device", str(device)])
    _check(math.isfinite(lr) and ac.launch_counts() == {"k0": 0, "k1": 0,
                                                        "k2": 0},
           f"layered step: loss {lr}, launches {ac.launch_counts()}")
    _log(f"  layered approx step (--reduced): loss {lr:.4f}, no launches")
    _log(f"  phase 5i: {time.perf_counter() - t_phase:.1f} s")
    row = {"name": "k0_approx_channel_row", "route": "cuda",
           "source": KERNEL_SOURCE,
           "replaces": K0_REPLACES, "launches": counts["k0"],
           "max_abs_err": max_err, "ms": k0_ms, "plain_ms": plain_ms,
           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
           "library_ms": None}
    return {"k0": counts["k0"], "k1": counts["k1"]}, row


def phase_server(torch, device, small: bool) -> None:
    """Phase 5j: the server, full and ring caches, and decode against the
    training forward at the prompt's positions."""
    from repro_torch.core import prng
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.launch import serve, steps
    from repro_torch.models import registry as R

    _log(f"== phase 5j: the server ({LLM_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'full width'})")
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(LLM_ARCH).reduced() if small else get_config(LLM_ARCH)
    argv = ["--arch", LLM_ARCH, "--batch", "4", "--prompt-len", "32", "--gen",
            "16", "--device", str(device)] + (["--reduced"] if small else [])
    for ring in (False, True):
        _reset_peak(torch, device)
        ac.reset_launch_counts()
        prompt, gen, rate = serve.main(argv + (["--ring"] if ring else []))
        _check(tuple(gen.shape) == (4, 16) and int(gen.min()) >= 0
               and int(gen.max()) < cfg.vocab_size,
               f"ring={ring}: tokens {gen}")
        _check(ac.launch_counts() == {"k0": 0, "k1": 0, "k2": 0},
               "the server launched a channel kernel")
        _log(f"  serve ring={ring}: {rate:.1f} tokens/s (batch 4, 32 + 16 "
             f"tokens, token-by-token), peak {_gib(torch, device):.3f} GiB")
    # decode == forward at the prompt's positions
    key = prng.PRNGKey(0, device=device)
    params = R.init_params(key, cfg)
    prompt = prng.randint(key, (4, 32), 0, cfg.vocab_size).to(torch.int32)
    with torch.no_grad():
        ref_logits, _ = R.forward(params, {"tokens": prompt}, cfg)
    last = steps.make_prefill_step(cfg)(params, {"tokens": prompt})
    _check(torch.equal(last, ref_logits[:, -1]),
           "prefill step != forward's last position")
    for ring in (False, True):
        cache = R.init_cache(cfg, 4, cfg.decode_window if ring else 32,
                             device=device)
        outs = []
        for t in range(32):
            lg, cache = R.decode_step(params, cache, prompt[:, t:t + 1], t,
                                      cfg, ring=ring)
            outs.append(lg[:, 0])
        got = torch.stack(outs, dim=1)
        err = (got - ref_logits).abs()
        top = float(ref_logits.abs().max())
        atol = DECODE_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
        tol = atol + DECODE_RTOL * ref_logits.abs()
        agree = float((got.argmax(-1) == ref_logits.argmax(-1)).float().mean())
        _log(f"  decode ring={ring} vs forward at 32 positions: max |diff| "
             f"{float(err.max()):.4f}, max |diff| - tol "
             f"{float((err - tol).max()):.4f} (rtol {DECODE_RTOL}, atol "
             f"{atol:.4f} = {DECODE_ULPS} bf16 ULPs of max |logit| "
             f"{top:.3f}); argmax agreement {agree:.4f}")
        _check(bool((err <= tol).all()),
               f"decode ring={ring} differs from forward beyond the bound")
    _log(f"  phase 5j: {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------- phase 5k: the moe family


MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_PARAMS = 1_562_980_352  # one layer at the published widths
MOE_CHECK_ARCH = "kimi-k2-1t-a32b"
# Decode against forward: the hidden state reaching the router went
# through bf16 matmuls of other shapes (4 rows against 128), so a token
# whose K-th and K+1-th router probabilities in the forward lie within
# MOE_NEAR_TIE (relative) of each other may route to the other expert in
# decode. Such positions are excused from the bound and counted; with one
# layer a flipped route changes only its own position's logits.
MOE_NEAR_TIE = 1e-2
POPCOUNT_CHUNK = 2**26  # words per chunk of the row's popcount


def _moe_cfg(small: bool):
    """phi3.5-moe at its published widths with the depth cut to one layer
    (cut when K0 refused rows past 2**31 - 1 words; phase 5p now runs such
    a row); on the CPU rehearsal
    the trainer's ``--reduced`` widths at one layer."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    if small:
        return cfg.reduced(n_layers=1, d_model=256, vocab_size=1024)
    return dataclasses.replace(cfg, n_layers=1)


def _flips(torch, a_leaves, b_leaves) -> int:
    """Bits that differ between two trees' float32 leaves (a Python
    int), chunk by chunk."""
    from repro_torch.core import float_codec as fc
    from repro_torch.core import modulation as mod

    total = 0
    for a, b in zip(a_leaves, b_leaves):
        a, b = a.reshape(-1), b.reshape(-1)
        for lo in range(0, a.numel(), POPCOUNT_CHUNK):
            hi = lo + POPCOUNT_CHUNK
            total += int(mod.popcount(fc.f32_to_bits(a[lo:hi])
                                      ^ fc.f32_to_bits(b[lo:hi])).sum())
    return total


def _as_f32_count(torch, n: int) -> float:
    """``n`` as the int32 count the kernel keeps (wrapped modulo 2**32),
    read as float32, as ``TxStats.bit_errors`` holds it."""
    wrapped = (n + 2**31) % 2**32 - 2**31
    return float(torch.tensor(wrapped, dtype=torch.float32))


def _router_gaps(torch, params, tokens, cfg):
    """``(p_K - p_K+1) / p_K`` of each token's router probabilities at
    the moe layer of ``forward`` on ``tokens`` (one layer, no dense
    layers)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = T._embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    pl = T._unstack_layers(params["layers"], 1)[0]
    h = T._attn_block(x, pl, cfg, positions, cfg.sliding_window)
    h = L.rmsnorm(h, pl["ln2"]).reshape(-1, cfg.d_model)
    probs = torch.softmax(h.to(torch.float32) @ pl["moe"]["router"], dim=-1)
    s = torch.sort(probs, dim=-1, descending=True).values
    k = cfg.top_k
    return ((s[:, k - 1] - s[:, k]) / s[:, k - 1]).reshape(tokens.shape)


def _moe_card_vs_cpu(torch, device) -> None:
    """kimi-k2 at ``cfg.reduced()`` (a dense layer, then a moe layer with
    a shared expert) in float32: ``loss_fn``, ``forward`` and the
    gradients on the card against the CPU on the same weights, within the
    CPU tests' bounds (loss 2e-6, logits 2e-6 and gradients 1e-5 of each
    leaf's largest)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng, transport
    from repro_torch.launch import steps
    from repro_torch.models import registry as R

    cfg = get_config(MOE_CHECK_ARCH).reduced(dtype="float32")
    p_cpu = R.init_params(prng.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for where in (device, torch.device("cpu")):
        p = transport.tree_map(lambda t: t.to(where), p_cpu)
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.no_grad():
            logits, aux = R.forward(p, b, cfg)
        loss, grads = steps.value_and_grad(cfg, p, b)
        out[where.type] = (float(loss), float(aux), logits.cpu(),
                           [t.cpu() for t in transport.tree_flatten(grads)[0]])
    (la, aa, ga, gra), (lb, ab, gb, grb) = out[device.type], out["cpu"]
    d_logit = float((ga - gb).abs().max()) / float(gb.abs().max())
    d_grad = max(float((x - y).abs().max()) / (float(y.abs().max()) or 1.0)
                 for x, y in zip(gra, grb))
    _log(f"  kimi-k2 reduced (float32, {cfg.first_dense_layers} dense + "
         f"{cfg.n_layers - cfg.first_dense_layers} moe layer, "
         f"{cfg.n_shared_experts} shared expert), {device.type} vs cpu: "
         f"loss {la:.6f} vs {lb:.6f}, aux {aa:.6f} vs {ab:.6f}; logits "
         f"{d_logit:.3g}, grads {d_grad:.3g} of their largest")
    _check(abs(la - lb) <= 2e-6 and abs(aa - ab) <= 1e-6 and d_logit <= 2e-6
           and d_grad <= 1e-5, "kimi-k2 reduced: card and CPU differ beyond "
           "the bounds")


def _llm_tcfg():
    """The trainer's uplink: approx QPSK at 10 dB, Rayleigh, on the kernel
    path (K0 on one row a step)."""
    from repro_torch.core import channel, transport

    return transport.TransportConfig(
        mode="approx", channel=channel.ChannelConfig(snr_db=10.0),
        simulate_fec=False, ecrt_expected_tx=1.1, use_kernel=True)


def _llm_train(torch, device, cfg, next_batch, n_steps: int, label: str,
               sass: dict, mhz, want_params=None, init_note: str = "",
               step_extra=None) -> tuple:
    """``train.main``'s schedule and step (``make_train_step_approx``, a
    world of one, lr 0.1): ``PRNGKey(0)`` makes the params, each step
    splits the key once and takes ``next_batch(i)``. ``init_params``' time
    and peak, the parameter count (against ``want_params``), and per step
    the loss, the spans, K0's launches (once a step on the card, K1 and K2
    never), the int32 error count and the peak; K0's bound and issue-rate
    floor at the row. ``step_extra(params, batch)`` adds named floats to a
    step's record (and its line). Returns ``(records, first batch,
    parameter count, launch counts)``."""
    from repro_torch.core import prng, transport
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import registry as R
    from repro_torch.obs import spans
    from repro_torch.optim.sgd import sgd

    tcfg, opt, clock = _llm_tcfg(), sgd(0.1), Clock(torch, device)
    clock.sync()
    _reset_peak(torch, device)
    t0 = time.perf_counter()
    key = prng.PRNGKey(0, device=device)
    params = R.init_params(key, cfg)
    clock.sync()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in transport.tree_flatten(params)[0])
    _log(f"  init_params: {n_params:,} params in {t_init:.2f} s, peak "
         f"{_gib(torch, device):.3f} GiB{init_note}")
    _check(want_params is None or n_params == want_params,
           f"{label}: {n_params} params, expected {want_params}")
    opt_state = opt.init(params)
    step = steps.make_train_step_approx(cfg, opt, tcfg, world_mesh())
    records, b0 = [], None
    _reset_peak(torch, device)
    ac.reset_launch_counts()
    for i in range(n_steps):
        b = next_batch(i)
        if i == 0:
            b0 = b
        ks = prng.split(key)
        key, sk = ks[0], ks[1]
        extra = step_extra(params, b) if step_extra else {}
        with spans.collect(device) as phase_s, \
                spans.counting(device) as step_counts:
            params, opt_state, loss, stats = step(params, opt_state, b, sk)
            loss = float(loss)  # a synchronise: the spans resolve at close
        records.append({
            "loss": loss, "extra": extra, "phase_s": dict(phase_s),
            "k0_open": _k0_open_share(step_counts),
            "k0": ac.launch_counts()["k0"], "sk": sk,
            "errors": float(stats.bit_errors), "n_bits": float(stats.n_bits),
            "peak": _gib(torch, device)})
        _reset_peak(torch, device)
    counts = ac.launch_counts()
    want = n_steps if device.type == "cuda" else 0
    _check(counts == {"k0": want, "k1": 0, "k2": 0},
           f"{label} trainer launched {counts}, expected {want} K0 launches")
    LLM_RUNS.append((label, cfg, n_params) + tuple(b0["tokens"].shape) + (
        min(r["phase_s"].get("grad", 0) for r in records),))
    tiles = -(-n_params // 1024)
    b = _bound(1, tiles * 1024, 2, "rayleigh", 32, "k1")
    prev = 0
    for i, r in enumerate(records):
        ph = r["phase_s"]
        more = "".join(f", {k} {v:.4f}" for k, v in r["extra"].items())
        _log(f"  step {i}: loss {r['loss']:.4f}{more}; grad (forward + "
             f"backward) {ph.get('grad', 0) * 1e3:.1f} ms, uplink keys "
             f"{ph.get('keys', 0) * 1e3:.2f} ms, K0 "
             f"{ph.get('kernel', 0) * 1e3:.2f} ms (bound "
             f"{b['bound_ms']:.2f} ms), apply {ph.get('apply', 0) * 1e3:.1f}"
             f" ms; K0 launches {r['k0'] - prev}; bit errors "
             f"{r['errors']:.0f} of {r['n_bits']:.0f} bits (the int32 "
             f"count, as float32); peak {r['peak']:.3f} GiB")
        _check(math.isfinite(r["loss"])
               and all(math.isfinite(v) for v in r["extra"].values()),
               f"{label} step {i}: loss {r['loss']}, {r['extra']}")
        _check(r["k0"] - prev == (1 if device.type == "cuda" else 0),
               f"{label} step {i}: K0 launched {r['k0'] - prev} times")
        _check(r["errors"] != 0, f"{label} step {i}: no bit errors at 10 dB")
        prev = r["k0"]
    _log(f"  K0 row: {n_params:,} words ({tiles:,} tiles); bound "
         f"{b['bound_ms']:.2f} ms ({b['bound_by']}: {b['bytes'] / 1e9:.2f} "
         f"GB -> {b['bytes_ms']:.2f} ms, {b['ops'] / 1e12:.2f} T ops -> "
         f"{b['ops_ms']:.2f} ms)")
    if sass and mhz:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        fast = min(records, key=lambda r: r["phase_s"].get("kernel", 0))
        k0_ms = fast["phase_s"].get("kernel", 0) * 1e3
        floor = fast["k0_open"] * _issue_floor_ms(tiles * 1024 * 16,
                                                  sass["k0"], sms, mhz)
        _log(f"  K0: issue-rate floor {floor:.2f} ms ({sass['k0']['total']} "
             f"instructions a symbol on the {fast['k0_open']:.1%} of symbols "
             f"it ran the full chain on); the fastest step's K0 span at "
             f"{floor / k0_ms:.0%} of it")
    return records, b0, n_params, counts


def _llm_step0_by_hand(torch, device, cfg, b0, records, n_words: int,
                       label: str, extra_tiles=()):
    """Step 0 by hand on the initial weights: its loss (the trainer's), K0
    on its gradient under the trainer's key (rank 0's shard key) with the
    trainer's errors, the row's flipped bits against the kernel's int32
    count modulo 2**32, and tiles 0, 262,143, 262,144, ``extra_tiles``
    and the last against the plain version on the card and the CPU.
    Returns the initial params."""
    from repro_torch.core import prng, transport
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import registry as R

    tcfg = _llm_tcfg()
    params = R.init_params(prng.PRNGKey(0, device=device), cfg)
    local = {k: torch.as_tensor(v).to(device) for k, v in b0.items()}
    loss0, grads = steps.value_and_grad(cfg, params, local)
    _check(float(loss0) == records[0]["loss"],
           f"{label} step 0's loss {float(loss0)} != the trainer's "
           f"{records[0]['loss']}")
    g32 = transport.tree_map(lambda g: g.to(torch.float32), grads)
    del grads
    # rank 0's shard key, as approx_allreduce folds it: lint: ignore[keylane]
    shard_key = prng.fold_in(records[0]["sk"], 0)
    ac.reset_launch_counts()
    hat, st0 = transport.transmit_pytree(g32, shard_key, tcfg, device=device)
    _check(ac.launch_counts()["k0"] == (1 if device.type == "cuda" else 0),
           "transmit_pytree did not launch K0 once")
    _check(float(st0.bit_errors) == records[0]["errors"],
           f"K0 on {label} step 0's payload: {float(st0.bit_errors)} errors, "
           f"the trainer's step 0 {records[0]['errors']}")
    g_leaves, _ = transport.tree_flatten(g32)
    hat_leaves, _ = transport.tree_flatten(hat)
    flips = _flips(torch, g_leaves, hat_leaves)
    _check(_as_f32_count(torch, flips) == records[0]["errors"],
           f"the row's {flips} flipped bits != K0's count "
           f"{records[0]['errors']} modulo 2**32")
    _log(f"  step 0 by hand: loss {float(loss0):.4f} (the trainer's); K0 on "
         f"its gradient: {flips:,} flipped bits in the row (BER "
         f"{flips / (n_words * 32):.4f}) = the kernel's int32 count modulo "
         f"2**32 ({'wrapped past' if flips >= 2**31 else 'under'} 2**31)")
    seed = ops._seed_from_key(shard_key).to(device)
    npow = torch.tensor(tcfg.channel.noise_power, dtype=torch.float32,
                        device=device)
    gain = torch.tensor(tcfg.channel.large_scale_gain, dtype=torch.float32,
                        device=device)
    tiles = -(-n_words // 1024)
    sampled = sorted({0, COUNTER_WRAP_TILE - 1, COUNTER_WRAP_TILE,
                      tiles - 1, *extra_tiles} & set(range(tiles)))
    for t in sampled:
        lo, hi = t * 1024, min((t + 1) * 1024, n_words)
        xt = torch.nn.functional.pad(_flat_words(torch, g_leaves, lo, hi),
                                     (0, 1024 - (hi - lo)))
        kt = _flat_words(torch, hat_leaves, lo, hi).cpu()
        k_err = _flips(torch, [xt[:hi - lo].cpu()], [kt])
        for where in (device, torch.device("cpu")):
            pt, pe = ref.ref_approx_channel(
                xt.to(where), seed.to(where), npow.to(where),
                gain.to(where), first_tile=t)
            nd = int((_bits(torch, kt)
                      != _bits(torch, pt[:hi - lo].cpu())).sum())
            p_err = _flips(torch, [xt[:hi - lo].cpu()], [pt[:hi - lo].cpu()])
            _check(nd == 0 and k_err == p_err,
                   f"{label} K0 tile {t}: {nd} words differ from the plain "
                   f"version on the {where.type}, errors {k_err} vs {p_err}")
        _log(f"  K0 tile {t:,} (words {lo:,}-{hi - 1:,}"
             f"{', padded' if hi - lo < 1024 else ''}): 0 differing words "
             f"and {k_err} bit errors, as the plain version on the card and "
             f"on the CPU")
    return params


def _serve_loop(torch, device, cfg, params, label: str):
    """The server's decode path (``serve.main``'s loop and
    ``make_serve_step``): batch 4, a 32-token prompt fed token by token,
    then 16 greedy tokens, full cache; no kernel launch. Returns the
    prompt."""
    from repro_torch.core import prng
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.launch import steps
    from repro_torch.models import registry as R

    clock = Clock(torch, device)
    pkey = prng.PRNGKey(0, device=device)
    prompt = prng.randint(pkey, (4, 32), 0, cfg.vocab_size).to(torch.int32)
    serve_step = steps.make_serve_step(cfg)
    _reset_peak(torch, device)
    ac.reset_launch_counts()
    cache = R.init_cache(cfg, 4, 48, device=device)
    tok, generated = prompt[:, :1], []
    clock.sync()
    t0 = time.perf_counter()
    for pos in range(47):
        nxt, cache = serve_step(params, cache, tok, pos)
        if pos + 1 < 32:
            tok = prompt[:, pos + 1:pos + 2]
        else:
            tok = nxt
            generated.append(nxt)
    clock.sync()
    dt = time.perf_counter() - t0
    gen = torch.cat(generated, dim=1)
    _check(tuple(gen.shape) == (4, 16) and int(gen.min()) >= 0
           and int(gen.max()) < cfg.vocab_size
           and ac.launch_counts() == {"k0": 0, "k1": 0, "k2": 0},
           f"{label} serve: tokens {gen.shape}, launches "
           f"{ac.launch_counts()}")
    _log(f"  serve: {4 * 48 / dt:.1f} tokens/s (batch 4, 32 + 16 tokens, "
         f"token-by-token, full cache), peak {_gib(torch, device):.3f} GiB")
    return prompt


def _decode_vs_forward(torch, device, cfg, params, prompt):
    """Decode at the 32 prompt positions against ``forward``: ``(logits
    from decode, from forward, max |diff|, atol)``, the absolute term
    ``DECODE_ULPS`` bf16 ULPs of the largest logit."""
    from repro_torch.models import registry as R

    with torch.no_grad():
        ref_logits, _ = R.forward(params, {"tokens": prompt}, cfg)
    cache = R.init_cache(cfg, 4, 32, device=device)
    outs = []
    for t in range(32):
        lg, cache = R.decode_step(params, cache, prompt[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    top = float(ref_logits.abs().max())
    atol = DECODE_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    return got, ref_logits, float((got - ref_logits).abs().max()), atol


def phase_moe(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5k: the moe family (phi3.5-moe at one layer): the trainer's
    approx steps with K0 on the uplink, the server, decode against forward
    at no-drop capacity, and kimi-k2 reduced on the card against the CPU.
    Returns the trainer's launches."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import moe
    from repro_torch.models import registry as R

    _log(f"== phase 5k: the moe family ({MOE_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, 1 "
         f"layer)")
    t_phase = time.perf_counter()
    cfg = _moe_cfg(small)
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    stream = TokenStream(cfg.vocab_size, seq, batch)

    def aux_of(params, b):  # this step's aux loss, on the same batch
        with torch.no_grad():
            _, aux = R.forward(params, {"tokens": torch.as_tensor(
                b["tokens"]).to(device)}, cfg)
        return {"aux": float(aux)}

    # (a) The trainer, (b) step 0 by hand.
    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, lambda i: stream.next_batch(), n_steps, "moe",
        sass, mhz, None if small else MOE_PARAMS,
        f"; {cfg.n_experts} experts, top-{cfg.top_k}, moe_d_ff "
        f"{cfg.moe_d_ff}; capacity {moe.capacity(batch * seq, cfg)} of "
        f"{batch * seq} tokens", aux_of)
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "moe")

    # (c) The server's decode path on the initial weights.
    prompt = _serve_loop(torch, device, cfg, params, "moe")

    # (d) Decode at the 32 prompt positions against forward, at
    # capacity_factor = n_experts / top_k: forward's capacity(128) is then
    # 128 and it drops no token; decode routes 4 tokens (capacity 4) and
    # never drops.
    cfg_nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    _check(moe.capacity(4 * 32, cfg_nd) == 4 * 32, "forward would drop")
    got, ref_logits, max_err, atol = _decode_vs_forward(
        torch, device, cfg_nd, params, prompt)
    with torch.no_grad():
        gaps = _router_gaps(torch, params, prompt, cfg_nd)
    err = (got - ref_logits).abs()
    over = ((err - (atol + DECODE_RTOL * ref_logits.abs())) > 0).any(-1)
    near = gaps <= MOE_NEAR_TIE
    agree = float((got.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    over_gaps = ", ".join(f"{float(g):.2e}" for g in gaps[over])
    _log(f"  decode vs forward at 32 positions (capacity_factor "
         f"{cfg_nd.capacity_factor}): max |diff| {max_err:.4f} (rtol "
         f"{DECODE_RTOL}, atol {atol:.4f} = {DECODE_ULPS} bf16 ULPs of max "
         f"|logit| {float(ref_logits.abs().max()):.3f}); positions over the "
         f"bound {int(over.sum())} of {over.numel()} (router gaps "
         f"{over_gaps or '-'}), of them near router ties (gap <= "
         f"{MOE_NEAR_TIE}) {int((over & near).sum())}; near ties in all "
         f"{int(near.sum())}; argmax agreement {agree:.4f}")
    _check(not bool((over & ~near).any()),
           "moe decode differs from forward beyond the bound away from a "
           "router near-tie")
    del params, ref_logits, got

    # (e) kimi-k2 reduced on the card against the CPU.
    _moe_card_vs_cpu(torch, device)
    _log(f"  phase 5k: {time.perf_counter() - t_phase:.1f} s")
    return counts


# ------------------------------------- phases 5l / 5m: the vlm and hybrid


VLM_ARCH = "pixtral-12b"
VLM_PARAMS = 1_892_705_280  # two layers at the published widths
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_PARAMS = 1_751_201_280  # five layers: one (rec, rec, attn) group
SCAN_SHAPE = (8, 256, 2560)  # the trainer's batch x tokens x lru_width
# Card against CPU, float32 logits relative to the largest: the dense
# family's 2e-6, except where an RG-LRU state carries each position's
# rounding down the sequence (five hybrid layers measured 2.2e-6 and
# 2.4e-6 on the H100): the gradients' 1e-5, as the CPU tests bound the
# hybrid's decode; the ssm's state carries it the same way. The audio
# family has no recurrence: the dense bound.
LOGIT_REL = {"vlm": 2e-6, "hybrid": 1e-5, "ssm": 1e-5, "audio": 2e-6}


def _family_card_vs_cpu(torch, device, cfg, label: str,
                        decode_steps: int = 0) -> None:
    """``cfg`` (a ``reduced()`` config) in float32: ``loss_fn``,
    ``forward`` and the gradients on the card against the CPU on the same
    weights: the loss within 2e-6, the logits within ``LOGIT_REL`` of
    their largest, the gradients within 1e-5 of each leaf's largest. A vlm
    batch draws ``patch_embeds`` and an audio batch ``frames``. With
    ``decode_steps``, that many decode steps from ``init_cache`` too, each
    step's logits within ``LOGIT_REL`` of their largest."""
    from repro_torch.core import prng, transport
    from repro_torch.launch import steps
    from repro_torch.models import registry as R

    cfg = dataclasses.replace(cfg, dtype="float32")
    p_cpu = R.init_params(prng.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(12)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.n_patches, cfg.vision_dim), generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=g)
    out = []
    for where in (device, torch.device("cpu")):
        p = transport.tree_map(lambda t: t.to(where), p_cpu)
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.no_grad():
            logits, _ = R.forward(p, b, cfg)
        loss, grads = steps.value_and_grad(cfg, p, b)
        dec, cache = [], R.init_cache(cfg, 2, decode_steps, device=where)
        for t in range(decode_steps):
            lg, cache = R.decode_step(p, cache, b["tokens"][:, t:t + 1], t,
                                      cfg)
            dec.append(lg.cpu())
        out.append((float(loss), logits.cpu(),
                    [t.cpu() for t in transport.tree_flatten(grads)[0]],
                    dec))
    (la, ga, gra, da), (lb, gb, grb, db) = out
    d_logit = float((ga - gb).abs().max()) / float(gb.abs().max())
    d_grad = max(float((x - y).abs().max()) / (float(y.abs().max()) or 1.0)
                 for x, y in zip(gra, grb) if y.numel())
    d_dec = max((float((x - y).abs().max()) / float(y.abs().max())
                 for x, y in zip(da, db)), default=0.0)
    more = (f", {decode_steps} decode steps {d_dec:.3g}" if decode_steps
            else "")
    _log(f"  {label} (float32), {device.type} vs cpu: loss {la:.6f} vs "
         f"{lb:.6f}; logits {d_logit:.3g}, grads {d_grad:.3g}{more} of their "
         f"largest")
    rel = LOGIT_REL[cfg.family]
    _check(abs(la - lb) <= 2e-6 and d_logit <= rel and d_grad <= 1e-5
           and d_dec <= rel, f"{label}: card and CPU differ beyond the "
           "bounds")


def phase_vlm(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5l: the vlm family (pixtral-12b at two layers): the trainer's
    approx steps on batches with patches, K0 on the uplink, step 0 by
    hand, the prefill step, and the reduced config on the card against
    the CPU. Returns the trainer's launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import prng
    from repro_torch.launch import steps
    from repro_torch.models import registry as R

    _log(f"== phase 5l: the vlm family ({VLM_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, 2 "
         f"layers)")
    t_phase = time.perf_counter()
    full = get_config(VLM_ARCH)
    cfg = (full.reduced(n_layers=2, d_model=256, vocab_size=1024) if small
           else dataclasses.replace(full, n_layers=2))
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    shape = InputShape("chip_smoke", seq, batch, "train")

    batch_keys = prng.split(prng.PRNGKey(1, device=device), n_steps)

    def next_batch(i):  # tokens, labels and patches from registry.make_batch
        return R.make_batch(cfg, shape, batch_keys[i])

    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, next_batch, n_steps, "vlm", sass, mhz,
        None if small else VLM_PARAMS,
        f"; {cfg.n_patches} patches of width {cfg.vision_dim} before "
        f"{seq} tokens ({cfg.n_patches + seq} positions in the trunk)")
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "vlm")

    # The prefill step on step 0's batch (patches and tokens): the
    # forward's last token position, bit for bit.
    pre = {k: v for k, v in b0.items() if k != "labels"}
    prefill = steps.make_prefill_step(cfg)
    prefill(params, pre)
    (last, ms) = _timed(torch, device, lambda: prefill(params, pre))
    with torch.no_grad():
        full_logits, _ = R.forward(params, pre, cfg)
    _check(tuple(last.shape) == (batch, cfg.vocab_size)
           and bool(torch.isfinite(last).all())
           and torch.equal(last, full_logits[:, -1]),
           "vlm prefill: not the forward's last position")
    _log(f"  prefill (batch {batch}, {cfg.n_patches} patches + {seq} "
         f"tokens): {ms:.1f} ms, last-position logits {tuple(last.shape)} = "
         f"forward's, bit for bit")
    del params, full_logits

    _family_card_vs_cpu(torch, device, full.reduced(),
                        f"{VLM_ARCH} reduced ({full.reduced().n_patches} "
                        f"patches)")
    _log(f"  phase 5l: {time.perf_counter() - t_phase:.1f} s")
    return counts


def _scan_times(torch, device, params, cfg, small: bool) -> None:
    """The RG-LRU alone at the trainer's shape: ``_rglru_scan`` (gates,
    decay and the odd/even recursion) forward, the recursion
    ``_assoc_scan`` alone, and ``_rglru_scan``'s forward and backward, on
    group 0's first rec block; medians of single calls, CUDA events."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    clock = Clock(torch, device)
    B, S, W = (2, 16, cfg.lru_width) if small else SCAN_SHAPE
    g = torch.Generator().manual_seed(13)
    xg = torch.randn((B, S, W), generator=g).to(device, L.dtype_of(cfg))
    rec = {k: v[0].detach() for k, v in params["groups"]["rec0"]["rec"].items()}
    with torch.no_grad():
        r = torch.sigmoid(torch.matmul(xg, rec["w_r"]).to(torch.float32))
        a = torch.exp(-8.0 * T._softplus(rec["lam"]) * r)
        b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * xg.to(
            torch.float32)
        reps = 5 if device.type == "cuda" else 2
        t_scan = clock.median_ms(lambda: T._rglru_scan(xg, rec), reps)
        t_rec = clock.median_ms(lambda: T._assoc_scan(a, b), reps)
    xr = xg.clone().requires_grad_()

    def fwd_bwd():
        y, _ = T._rglru_scan(xr, rec)
        torch.autograd.grad(y.sum(), xr)

    t_fb = clock.median_ms(fwd_bwd, reps)
    how = "CUDA events" if device.type == "cuda" else "host clock"
    _log(f"  RG-LRU scan at {(B, S, W)}: _rglru_scan forward {t_scan:.3f} ms,"
         f" the odd/even recursion alone {t_rec:.3f} ms, forward + backward "
         f"{t_fb:.3f} ms (medians of {reps}, {how})")


def phase_hybrid(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5m: the hybrid family (recurrentgemma-2b at five layers: one
    group and a tail of two): the trainer's approx steps with K0 on the
    uplink, step 0 by hand, the server, decode against forward, the RG-LRU
    scan alone, and the reduced configs on the card against the CPU.
    Returns the trainer's launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream

    _log(f"== phase 5m: the hybrid family ({HYBRID_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, 5 "
         f"layers)")
    t_phase = time.perf_counter()
    full = get_config(HYBRID_ARCH)
    cfg = (full.reduced(n_layers=5, d_model=256, vocab_size=1024) if small
           else dataclasses.replace(full, n_layers=5))
    G, tail_n = divmod(cfg.n_layers, cfg.attn_period)
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    stream = TokenStream(cfg.vocab_size, seq, batch)
    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, lambda i: stream.next_batch(), n_steps,
        "hybrid", sass, mhz, None if small else HYBRID_PARAMS,
        f"; {G} (rec, rec, attn) group and a tail of {tail_n} rec blocks, "
        f"lru_width {cfg.lru_width}, local_window {cfg.local_window}")
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "hybrid")
    prompt = _serve_loop(torch, device, cfg, params, "hybrid")
    got, ref_logits, max_err, atol = _decode_vs_forward(
        torch, device, cfg, params, prompt)
    over = (((got - ref_logits).abs()
             - (atol + DECODE_RTOL * ref_logits.abs())) > 0).any(-1)
    agree = float((got.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    _log(f"  decode vs forward at 32 positions: max |diff| {max_err:.4f} "
         f"(rtol {DECODE_RTOL}, atol {atol:.4f} = {DECODE_ULPS} bf16 ULPs of "
         f"max |logit| {float(ref_logits.abs().max()):.3f}); positions over "
         f"the bound {int(over.sum())} of {over.numel()}; argmax agreement "
         f"{agree:.4f}")
    _check(not bool(over.any()), "hybrid decode differs from forward "
           "beyond the bound")
    del got, ref_logits
    _scan_times(torch, device, params, cfg, small)
    del params
    for kw in ({}, dict(n_layers=5)):
        red = full.reduced(**kw)
        _family_card_vs_cpu(torch, device, red,
                            f"{HYBRID_ARCH} reduced, {red.n_layers} layers")
    _log(f"  phase 5m: {time.perf_counter() - t_phase:.1f} s")
    return counts


# -------------------------------------- phases 5n / 5o: the ssm and audio


SSM_ARCH = "falcon-mamba-7b"
SSM_LAYERS = 12  # of 64: the depth nearest qwen2-1.5b's row (15 would fit)
SSM_PARAMS = 1_796_427_776
SSM_SCAN_SHAPE = (8, 256, 8192, 16)  # batch x tokens x Di x ssm_state
# Decode against forward in the ssm, bf16: the reference's forward rounds
# the conv's output and SiLU's output to bf16 before the scan
# (src/repro/models/ssm.py:68, :105) and its decode keeps both in float32
# (:159-161), so the scan's inputs differ by up to half a bf16 ULP at
# every position and the state carries the difference down the sequence
# and through the layers. The port copies both. The bound is on the
# largest difference, relative to the largest logit: the dense family's
# bf16 logits bound (measured 1.2e-2 at 3 layers of cfg.reduced() on the
# CPU, in the port and in the reference alike).
SSM_DECODE_REL = 3e-2
AUDIO_ARCH = "whisper-large-v3"
AUDIO_PARAMS = 1_588_016_640  # full depth: 32 encoder + 32 decoder layers


def _ssm_scan_times(torch, device, params, cfg, small: bool) -> None:
    """The selective scan alone at the trainer's shape, on layer 0:
    ``_ssm_scan`` (projections, softplus, the ``(B, S, Di, N)`` decays and
    inputs, the odd/even recursion, the read-out) forward, the recursion
    ``_assoc_scan`` alone, and ``_ssm_scan``'s forward and backward, with
    the peak memory of each; medians of single calls, CUDA events."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T

    clock = Clock(torch, device)
    B, S, Di, N = ((2, 16, cfg.expand * cfg.d_model, cfg.ssm_state) if small
                   else SSM_SCAN_SHAPE)
    R = ssm._dt_rank(cfg)
    g = torch.Generator().manual_seed(14)
    xc = torch.randn((B, S, Di), generator=g).to(device, L.dtype_of(cfg))
    p = {k: v[0].detach() for k, v in params["layers"].items()}
    reps = 5 if device.type == "cuda" else 2
    with torch.no_grad():
        proj = torch.matmul(xc, p["x_proj"]).to(torch.float32)
        dt = T._softplus(torch.matmul(proj[..., :R], p["dt_proj"].to(
            torch.float32)) + p["dt_bias"])
        a = torch.exp(dt[..., None] * -torch.exp(p["A_log"]))
        b = (dt * xc.to(torch.float32))[..., None] * proj[..., None, R:R + N]
        del proj, dt
        _reset_peak(torch, device)
        t_scan = clock.median_ms(lambda: ssm._ssm_scan(xc, p, cfg), reps)
        pk_scan = _gib(torch, device)
        _reset_peak(torch, device)
        t_rec = clock.median_ms(lambda: T._assoc_scan(a, b), reps)
        pk_rec = _gib(torch, device)
        del a, b
    xr = xc.clone().requires_grad_()

    def fwd_bwd():
        y, _ = ssm._ssm_scan(xr, p, cfg)
        torch.autograd.grad(y.to(torch.float32).sum(), xr)

    _reset_peak(torch, device)
    t_fb = clock.median_ms(fwd_bwd, reps)
    pk_fb = _gib(torch, device)
    how = "CUDA events" if device.type == "cuda" else "host clock"
    gib = B * S * Di * N * 4 / 2**30
    _log(f"  selective scan at {(B, S, Di, N)} ({gib:.2f} GiB a float32 "
         f"tensor): _ssm_scan forward {t_scan:.3f} ms (peak "
         f"{pk_scan:.3f} GiB), the odd/even recursion alone {t_rec:.3f} ms "
         f"(peak {pk_rec:.3f} GiB), forward + backward {t_fb:.3f} ms (peak "
         f"{pk_fb:.3f} GiB) (medians of {reps}, {how})")


def phase_ssm(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5n: the ssm family (falcon-mamba-7b at 12 layers): the
    trainer's approx steps with K0 on the uplink, step 0 by hand, the
    server, decode against forward within ``SSM_DECODE_REL``, the
    selective scan alone, and the reduced config on the card against the
    CPU. Returns the trainer's launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import ssm

    full = get_config(SSM_ARCH)
    cfg = (full.reduced(n_layers=3, d_model=256, vocab_size=1024) if small
           else dataclasses.replace(full, n_layers=SSM_LAYERS))
    _log(f"== phase 5n: the ssm family ({SSM_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, "
         f"{cfg.n_layers} layers)")
    t_phase = time.perf_counter()
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    stream = TokenStream(cfg.vocab_size, seq, batch)
    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, lambda i: stream.next_batch(), n_steps, "ssm",
        sass, mhz, None if small else SSM_PARAMS,
        f"; Di {cfg.expand * cfg.d_model}, ssm_state {cfg.ssm_state}, conv "
        f"{cfg.ssm_conv}, dt_rank {ssm._dt_rank(cfg)}")
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "ssm")
    prompt = _serve_loop(torch, device, cfg, params, "ssm")
    got, ref_logits, max_err, _ = _decode_vs_forward(
        torch, device, cfg, params, prompt)
    top = float(ref_logits.abs().max())
    per_pos = (got - ref_logits).abs().amax(dim=(0, 2)) / top
    agree = float((got.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    _log(f"  decode vs forward at 32 positions (bf16; forward rounds the "
         f"conv and SiLU outputs, decode does not): max |diff| {max_err:.4f}"
         f" = {max_err / top:.4g} of max |logit| {top:.3f} (bound "
         f"{SSM_DECODE_REL}); by position {float(per_pos[0]):.3g} at 0, "
         f"{float(per_pos[15]):.3g} at 15, {float(per_pos[31]):.3g} at 31; "
         f"argmax agreement {agree:.4f}")
    _check(max_err <= SSM_DECODE_REL * top, "ssm decode differs from "
           "forward beyond SSM_DECODE_REL")
    del got, ref_logits
    _ssm_scan_times(torch, device, params, cfg, small)
    del params
    _family_card_vs_cpu(torch, device, full.reduced(),
                        f"{SSM_ARCH} reduced", decode_steps=6)
    _log(f"  phase 5n: {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_audio(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5o: the audio family (whisper-large-v3 at full depth): the
    trainer's approx steps on ``registry.make_batch``'s frames and tokens
    with K0 on the uplink, step 0 by hand, the server on the full cache,
    and the reduced config on the card against the CPU (forward, gradients
    and decode steps). Returns the trainer's launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import prng
    from repro_torch.models import registry as R

    full = get_config(AUDIO_ARCH)
    cfg = (full.reduced(d_model=256, vocab_size=1024) if small else full)
    _log(f"== phase 5o: the audio family ({AUDIO_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, "
         f"{cfg.encoder_layers} + {cfg.n_layers} layers)")
    t_phase = time.perf_counter()
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    shape = InputShape("chip_smoke", seq, batch, "train")
    batch_keys = prng.split(prng.PRNGKey(1, device=device), n_steps)

    def next_batch(i):  # frames, tokens and labels from registry.make_batch
        return R.make_batch(cfg, shape, batch_keys[i])

    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, next_batch, n_steps, "audio", sass, mhz,
        None if small else AUDIO_PARAMS,
        f"; {cfg.encoder_seq} float32 frames of width {cfg.d_model} into "
        f"the encoder (float32 against the bf16 weights, as jnp promotes), "
        f"{seq} tokens into the decoder, the head tied")
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "audio")
    # No decode against forward: decode cross-attends to the zero cache
    # init_cache makes, as in the reference (ROADMAP Queue 3).
    _serve_loop(torch, device, cfg, params, "audio")
    del params
    _family_card_vs_cpu(torch, device, full.reduced(),
                        f"{AUDIO_ARCH} reduced", decode_steps=6)
    _log(f"  phase 5o: {time.perf_counter() - t_phase:.1f} s")
    return counts


# --------------------------- phase 5p: K0 on a row past 2**31 - 1 words


HYBRID_FULL_PARAMS = 3_549_795_840  # 26 layers: 8 groups and a tail of 2
# Either side of word 2**31: tile 2,097,152 starts there.
WORD_2_31_TILES = (2**31 // 1024 - 1, 2**31 // 1024)


def _k0_long_row(torch, device, n_words: int, sass: dict, mhz, small: bool):
    """K0 alone on a seeded row of ``n_words`` words (padded to whole
    tiles): its time (median of 3, CUDA events), bound and issue-rate
    floor, and every tile against one pass of the plain version tile range
    by tile range, with the error counts equal modulo 2**32."""
    from repro_torch.core import prng
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ops
    from repro_torch.obs import spans

    tcfg, clock = _llm_tcfg(), Clock(torch, device)
    tiles = -(-n_words // 1024)
    g = torch.Generator(device=device).manual_seed(24)
    xp = torch.randn(tiles * 1024, generator=g, device=device).mul_(1e-3)
    seed = ops._seed_from_key(prng.PRNGKey(24, device=device))
    npow = torch.tensor(tcfg.channel.noise_power, dtype=torch.float32,
                        device=device)
    gain = torch.tensor(tcfg.channel.large_scale_gain, dtype=torch.float32,
                        device=device)
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xBFFFFFFF,
              word_bits=32)
    k0 = lambda: ac.approx_channel_kernel(xp, seed, npow, gain, **kw)  # noqa: E731
    reps = 3 if device.type == "cuda" else 1
    ms = clock.median_ms(k0, reps, warmup=1)
    _reset_peak(torch, device)
    with spans.counting(device) as counts:
        out, errs = k0()
        clock.sync()
    peak = _gib(torch, device)
    diff, max_errs, errs_plain, plain_ms = _k0_vs_plain(
        torch, device, xp, {"k0": out}, seed, npow, gain,
        f"K0 alone, row of {tiles * 1024:,} words")
    _check(diff["k0"] == 0 and (errs_plain - int(errs)) % 2**32 == 0,
           f"K0 long row: {diff['k0']} words differ, errors {int(errs)} vs "
           f"plain {errs_plain}")
    b = _bound(1, tiles * 1024, 2, "rayleigh", 32, "k1")
    side = "past" if tiles * 1024 > 2**31 - 1 else "under"
    _log(f"  K0 alone at N = {tiles * 1024:,} ({tiles:,} tiles, {side} "
         f"2**31 - 1 = {2**31 - 1:,}): {ms:.2f} ms (median of {reps}), bound "
         f"{b['bound_ms']:.2f} ms ({b['bound_by']}: {b['bytes'] / 1e9:.2f} "
         f"GB -> {b['bytes_ms']:.2f} ms, {b['ops'] / 1e12:.2f} T ops -> "
         f"{b['ops_ms']:.2f} ms); plain {plain_ms:.1f} ms in all; the "
         f"launch's peak {peak:.3f} GiB")
    _log(f"  K0 alone: {errs_plain:,} bit errors by the plain version "
         f"(Python int; BER {errs_plain / (tiles * 1024 * 32):.4f}; "
         f"{'past' if errs_plain >= 2**32 else 'under'} 2**32 = "
         f"{2**32:,}); the kernel's int32 count {int(errs):,} equals it "
         f"modulo 2**32")
    _check(small or errs_plain >= 2**32, "the long row's errors did not "
           "pass 2**32")
    if sass and mhz:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        share = _k0_open_share(counts)
        floor = share * _issue_floor_ms(tiles * 1024 * 16, sass["k0"], sms,
                                        mhz)
        _log(f"  K0 alone: issue-rate floor {floor:.2f} ms "
             f"({sass['k0']['total']} instructions a symbol on the "
             f"{share:.1%} of symbols it ran the full chain on); kernel at "
             f"{floor / ms:.0%} of it")
    return ms, plain_ms, b, max_errs["k0"]


def phase_long_row(torch, device, small: bool, sass: dict, mhz) -> dict:
    """Phase 5p: recurrentgemma-2b at its published 26 layers, a row past
    2**31 - 1 words: the trainer's approx steps with K0 once a step, step
    0 by hand (tiles either side of word 2**31 included), the server, and
    K0 alone on a row of the same length against the plain version over
    every tile. Returns the trainer's launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream

    full = get_config(HYBRID_ARCH)
    cfg = (full.reduced(n_layers=5, d_model=256, vocab_size=1024) if small
           else full)
    G, tail_n = divmod(cfg.n_layers, cfg.attn_period)
    _log(f"== phase 5p: K0 past 2**31 - 1 words ({HYBRID_ARCH}, "
         f"{'reduced (rehearsal)' if small else 'published widths'}, "
         f"{cfg.n_layers} layers)")
    t_phase = time.perf_counter()
    batch, seq, n_steps = (2, 16, 1) if small else (8, 256, 3)
    stream = TokenStream(cfg.vocab_size, seq, batch)
    records, b0, n_params, counts = _llm_train(
        torch, device, cfg, lambda i: stream.next_batch(), n_steps,
        "hybrid, full depth", sass, mhz,
        None if small else HYBRID_FULL_PARAMS,
        f"; {G} (rec, rec, attn) groups and a tail of {tail_n} rec blocks; "
        f"{n_steps} steps")
    _check(small or n_params > 2**31 - 1,
           f"{n_params} params do not pass 2**31 - 1 words")
    params = _llm_step0_by_hand(torch, device, cfg, b0, records, n_params,
                                "hybrid, full depth", WORD_2_31_TILES)
    _serve_loop(torch, device, cfg, params, "hybrid, full depth")
    del params
    _k0_long_row(torch, device, n_params, sass, mhz, small)
    _log(f"  phase 5p: {time.perf_counter() - t_phase:.1f} s")
    return counts


# --------------------------------------- phase 5q: the optimizers at width


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


OPTIM_SAMPLED = ("final_norm", "layers/attn/bq", "layers/attn/wk",
                 "layers/ln2")
# Card against CPU, relative to the leaf's largest value: the CPU tests'
# bound for the reference under jax.jit (tests/test_torch_optim.py); the
# eager updates agreed bit for bit there.
OPTIM_REL = 2.0**-20


def _adam_roots(torch, device, state) -> None:
    """Why ``adam`` takes its root in float64: PyTorch's float32 ``sqrt``
    on the card and on the CPU against numpy's (IEEE, correctly rounded,
    as XLA's is on normal inputs), on the second moments of one sampled
    leaf, and ``adam._sqrt_rn`` on the card against it."""
    import numpy as np

    from repro_torch.optim.adam import _sqrt_rn

    v = dict(_leaf_paths(state["v"]))["layers/attn/wk"].reshape(-1)
    v = v / float(v.abs().max().clamp(min=1e-30))
    want = torch.from_numpy(np.sqrt(v.cpu().numpy())).view(torch.int32)

    def differ(root):
        return int((root.cpu().view(torch.int32) != want).sum())

    rn = differ(_sqrt_rn(v))
    _check(rn == 0, f"adam's float64 root differs from the correctly "
           f"rounded float32 root on {rn} values")
    _log(f"  float32 sqrt of {v.numel():,} scaled second moments against "
         f"numpy's correctly rounded root: torch.sqrt on the "
         f"{device.type} {differ(torch.sqrt(v)):,} differ, on the CPU "
         f"{differ(torch.sqrt(v.cpu())):,}; the float64 root adam takes 0")


def phase_optim(torch, device, small: bool) -> None:
    """Phase 5q: ``momentum_sgd`` and ``adam`` under ``warmup_cosine`` at
    qwen2-1.5b's full width (bf16 params), 3 updates each on gradients
    drawn from a seed, timed with CUDA events; sampled leaves against the
    same updates on the CPU."""
    from repro_torch import optim
    from repro_torch.core import prng, transport
    from repro_torch.models import registry as R

    cfg = _llm_cfg(small)
    _log(f"== phase 5q: the optimizers at {LLM_ARCH}'s "
         f"{'reduced widths (rehearsal)' if small else 'full width'}")
    t_phase = time.perf_counter()
    clock = Clock(torch, device)
    params0 = R.init_params(prng.PRNGKey(0, device=device), cfg)
    n = sum(p.numel() for p in transport.tree_flatten(params0)[0])
    _check(small or n == LLM_PARAMS, f"{n} params")
    for name in ("momentum_sgd", "adam"):
        sched = optim.warmup_cosine(0.1 if name == "momentum_sgd" else 1e-3,
                                    1, 3)
        opt = getattr(optim, name)(sched)
        params, state = params0, opt.init(params0)
        cpu_p = {k: v.cpu() for k, v in _leaf_paths(params0)
                 if k in OPTIM_SAMPLED}
        cpu_opt = getattr(optim, name)(sched)
        cpu_s = cpu_opt.init(cpu_p)
        g = torch.Generator(device=device).manual_seed(5)
        times = []
        _reset_peak(torch, device)
        for _ in range(3):
            grads = transport.tree_map(lambda p: (torch.randn(
                p.shape, generator=g, device=device) * 1e-2).to(p.dtype),
                params)
            (params, state), ms = _timed(
                torch, device, lambda: opt.update(grads, state, params))
            times.append(ms)
            cg = {k: v.cpu() for k, v in _leaf_paths(grads)
                  if k in OPTIM_SAMPLED}
            cpu_p, cpu_s = cpu_opt.update(cg, cpu_s, cpu_p)
            del grads
        peak = _gib(torch, device)
        worst, differing = 0.0, 0
        for k, v in _leaf_paths(params):
            if k not in OPTIM_SAMPLED:
                continue
            a, b = v.cpu().to(torch.float32), cpu_p[k].to(torch.float32)
            differing += int((a != b).sum())
            top = max(float(b.abs().max()), 1e-30)
            worst = max(worst, float((a - b).abs().max()) / top)
        _check(all(math.isfinite(v) for v in times) and worst <= OPTIM_REL
               and state["step"].dtype == torch.int32
               and int(state["step"]) == 3,
               f"{name}: card vs CPU {worst:.3g} of the largest (bound "
               f"{OPTIM_REL:.3g}), step {state['step']}")
        if name == "adam":
            _adam_roots(torch, device, state)
        _log(f"  {name} (warmup_cosine, 3 updates of {n:,} params): "
             f"{', '.join(f'{t:.2f}' for t in times)} ms (CUDA events"
             f"{'' if device.type == 'cuda' else ': host clock'}); peak "
             f"{peak:.3f} GiB; sampled leaves {', '.join(OPTIM_SAMPLED)} "
             f"against the CPU: {differing} differing values, largest "
             f"difference {worst:.3g} of the leaf's largest (bound "
             f"{OPTIM_REL:.3g})")
        del params, state
    _log(f"  phase 5q: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------ phase 5r: the dry run and the world of one


BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s, data sheet
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"


def start_dryrun():
    """``python -m repro_torch.launch.dryrun --all`` on the meta device in
    a process of its own (no card: CUDA_VISIBLE_DEVICES is empty), so it
    runs beside the card's phases. Returns the process."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(DRYRUN_OUT)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def phase_dryrun(torch, device, small: bool, proc) -> None:
    """Phase 5r: the dry run's records (every arch x shape ``ok`` or a
    ``supports_shape`` skip); the parameter counts of the configs the LLM
    phases built, from the meta device, against what they measured; the
    expert-parallel dispatch at a world of one against the dense one;
    model FLOPs over each LLM phase's fastest grad span."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import prng, transport
    from repro_torch.launch import roofline, steps
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import registry as R
    from repro_torch.optim.sgd import sgd

    _log("== phase 5r: the dry run and the world of one")
    t_phase = time.perf_counter()
    try:
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(proc.returncode == 0, f"dryrun exited {proc.returncode}: "
           f"{log[-2000:]}")
    # a record is written for each combination that runs; a skip writes none
    recs = [json.loads(f.read_text()) for f in sorted(
        DRYRUN_OUT.glob("*.json"))]
    runs = {(a, sh) for a in ARCH_IDS for sh in INPUT_SHAPES
            if R.supports_shape(get_config(a), INPUT_SHAPES[sh])[0]}
    _check({(r["arch"], r["shape"]) for r in recs} == runs
           and all(r["status"] == "ok" for r in recs),
           f"dry run: {len(recs)} records, not one 'ok' for each of the "
           f"{len(runs)} supported combinations")
    skips = len(ARCH_IDS) * len(INPUT_SHAPES) - len(runs)
    _log(f"  dryrun --all (meta device, world 1, its own process beside the "
         f"card's phases): {len(recs)} ok, {skips} supports_shape "
         f"skip(s) (\"[dryrun] SKIP\" lines: "
         f"{log.count('[dryrun] SKIP')}); e.g. " + "; ".join(
             f"{r['arch']} x {r['shape']}: flops/rank "
             f"{r['flops_per_device']:.4g}, args "
             f"{r['memory']['argument_bytes'] / 2**30:.2f} GiB"
             for r in recs if r["status"] == "ok"
             and r["shape"] == "train_4k")
         )
    for label, cfg, n_meas, b, sq, grad_s in LLM_RUNS:
        n_meta = roofline.n_active_params(cfg)[1]
        _check(n_meta == n_meas, f"{label}: {n_meta} params on the meta "
               f"device, {n_meas} measured")
        mf = roofline.model_flops(cfg, InputShape("step", sq, b, "train"))
        rate = mf / grad_s if grad_s else float("nan")
        _log(f"  {label} ({cfg.name}, {cfg.n_layers} layers): "
             f"{n_meas:,} params = the meta count; model FLOPs "
             f"{mf:.4g} (6 x {roofline.n_active_params(cfg)[0]:.4g} active"
             f" x {b} x {sq} tokens) over the fastest grad span "
             f"{grad_s * 1e3:.1f} ms = {rate / 1e12:.1f} TFLOP/s, "
             f"{rate / BF16_PEAK:.1%} of the bf16 dense peak")
    # The expert-parallel dispatch in a world of one is the dense one.
    dense = get_config(MOE_ARCH).reduced()
    ep = dataclasses.replace(dense, moe_impl="expert_parallel")
    rng = prng.PRNGKey(3, device=device)
    batch = {k: prng.randint(kk, (4, 32), 0, dense.vocab_size).to(
        torch.int32) for k, kk in zip(("labels", "tokens"),
                                      prng.split(rng))}
    outs = {}
    for name, c in (("dense", dense), ("ep", ep)):
        params = R.init_params(prng.PRNGKey(0, device=device), c)
        opt = sgd(0.1)
        new, _, loss = steps.make_train_step(c, opt, mesh=world_mesh())(
            params, opt.init(params), batch, rng)
        pre = steps.make_prefill_step(c, world_mesh())(
            params, {"tokens": batch["tokens"]})
        outs[name] = (transport.tree_flatten(new)[0], loss, pre)
    same = (all(torch.equal(a, b) for a, b in zip(outs["ep"][0],
                                                  outs["dense"][0]))
            and torch.equal(outs["ep"][1], outs["dense"][1])
            and torch.equal(outs["ep"][2], outs["dense"][2]))
    _check(same, "expert_parallel at a world of one differs from the dense "
           "dispatch")
    _log(f"  {MOE_ARCH} reduced, moe_impl='expert_parallel' at a world of "
         f"one: a train step (loss {float(outs['ep'][1]):.6f}) and the "
         f"prefill step equal the dense dispatch's bit for bit")
    _log(f"  phase 5r: {time.perf_counter() - t_phase:.1f} s")


def phase_times(torch, device, small: bool, launches: dict, sass: dict,
                mhz, buckets=(), sparse_shapes=(), k0_row=None) -> list:
    from repro_torch.core import aggregation, prng, transport
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import spans

    _log("== phase 6: times at the main-path shape")
    c, n = (4, 2048) if small else (100, 22528)
    clock = Clock(torch, device)
    g = torch.Generator().manual_seed(6)
    x = (torch.randn((c, n), generator=g) * 1e-2).to(device)
    seeds = ops._seed_from_key(transport.client_keys(prng.PRNGKey(6), c)).to(
        device)
    npow = torch.full((c,), 1e-4, dtype=torch.float32, device=device)
    gains = torch.full((c,), 1e-3, dtype=torch.float32, device=device)
    w = aggregation.normalize_weights(torch.ones(c)).to(device)
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xBFFFFFFF,
              word_bits=32)
    nd, e1, xk, edges = _compare_k1(torch, x, seeds, npow, gains, kw)
    e2 = _compare_k2(torch, x, seeds, npow, gains, w, kw, xk, edges)
    _log(f"  at C={c}, N={n}: K1 words differing {nd}, max|err| K1 {e1:.3g},"
         f" K2 {e2:.3g}")
    reps, preps = (50, 5) if device.type == "cuda" else (3, 2)
    # The round's key schedule on the host, where the engine runs it
    # (seeds then copied over), and on the device.
    for where in ("cpu", device):
        key = prng.PRNGKey(6, device=where)
        ms = clock.host_median_ms(lambda: ops._seed_from_key(
            transport.client_keys(key, c)).to(device), reps)
        _log(f"  key schedule (client_keys + kernel seeds, {c} clients) on "
             f"{torch.device(where).type}: {ms:.3f} ms (median of {reps})")
    # K0: the first client's row alone, against the plain version.
    x0, s0, p0, g0 = x[0].contiguous(), seeds[0], npow[0], gains[0]
    with spans.counting(device) as k0_counts:
        xk0, _ = ac.approx_channel_kernel(x0, s0, p0, g0, **kw)
        clock.sync()
    xp0, _, edges0 = ref.approx_channel_batch_ref(
        x[:1], seeds[:1], npow[:1], gains[:1], with_edges=True, **kw)
    diff0 = _bits(torch, xk0) != _bits(torch, xp0[0])
    _check(bool((edges0[0][diff0] < EDGE).all()),
           "K0 word differs away from a decision edge")
    e0 = (xk0 - xp0[0]).abs()
    e0 = float(e0[torch.isfinite(e0)].max())
    _log(f"  K0 at C=1, N={n}: words differing {int(diff0.sum())}, "
         f"max|err| {e0:.3g}")
    arms = {
        "k0": (lambda: ac.approx_channel_kernel(x0, s0, p0, g0, **kw),
               lambda: ref.ref_approx_channel(x0, s0, p0, g0, **kw), e0,
               K0_REPLACES),
        "k1": (lambda: ac.approx_channel_batch_kernel(x, seeds, npow, gains,
                                                       **kw),
               lambda: ref.approx_channel_batch_ref(x, seeds, npow, gains,
                                                    **kw), e1, K1_REPLACES),
        "k2": (lambda: ac.approx_channel_batch_aggregate_kernel(
                   x, seeds, npow, gains, w, **kw),
               lambda: ref.approx_channel_batch_aggregate_ref(
                   x, seeds, npow, gains, w, **kw), e2, K2_REPLACES),
    }
    rows = []
    for name, (kern, plain, err, replaces) in arms.items():
        # plain, kernel, kernel, plain: the two orders average out drift
        p1 = clock.median_ms(plain, preps)
        k1 = clock.median_ms(kern, reps)
        k2 = clock.median_ms(kern, reps)
        p2 = clock.median_ms(plain, preps)
        b = (_bound(1, n, 2, "rayleigh", 32, "k1") if name == "k0"
             else _bound(c, n, 2, "rayleigh", 32, name))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        _log(f"  {name}: kernel {ms:.4f} ms (runs {k1:.4f}, {k2:.4f}), "
             f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
             f"({b['bound_by']}: {b['bytes'] / 1e6:.2f} MB -> "
             f"{b['bytes_ms']:.4f} ms, {b['ops'] / 1e9:.2f} G ops -> "
             f"{b['ops_ms']:.4f} ms); library call: n/a")
        counts = sass.get(name)
        if counts and mhz:
            # K0's full chain runs on the symbols its test left open
            share = _k0_open_share(k0_counts) if name == "k0" else 1.0
            symbols = (1 if name == "k0" else c) * n * 16 * share
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            floor = _issue_floor_ms(symbols, counts, sms, mhz)
            _log(f"  {name}: issue-rate floor {floor:.4f} ms ({counts['total']}"
                 f" instructions x {symbols / 1e6:.2f} M symbols over {sms} "
                 f"SMs x 128 lanes at {mhz:.0f} MHz); kernel at "
                 f"{floor / ms:.0%} of it")
        if name == "k0":
            # K1 at C=1 on the same row, the path K0 took before it had
            # its own kernel
            one = [t.reshape(1) for t in (s0, p0, g0)]
            t1 = clock.median_ms(lambda: ac.approx_channel_batch_kernel(
                x0[None], *one, **kw), reps)
            _log(f"  k1 at C=1 on K0's row: {t1:.4f} ms")
        if name == "k0" and k0_row is not None:
            # the main path's K0 is the trainer's row (phase 5i)
            rows.append(k0_row)
            continue
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None,
        })
    # K1 and K2 at phase 5d's round-0 bucket shapes: capacity rows, the
    # tail past num_active masked; the bound counts the active rows.
    for k, cap, count in buckets:
        xb = (torch.randn((cap, n), generator=g) * 1e-2).to(device)
        sb = ops._seed_from_key(transport.client_keys(prng.PRNGKey(k), cap)
                                ).to(device)
        pb = torch.full((cap,), 1e-4, dtype=torch.float32, device=device)
        gb = torch.full((cap,), 1e-3, dtype=torch.float32, device=device)
        wb = torch.zeros(cap, device=device)
        wb[:count] = 1.0 / count
        kwb = dict(kw, bits_per_symbol=k)
        for name, kern, plain in (
                ("k1", lambda: ac.approx_channel_batch_kernel(
                    xb, sb, pb, gb, num_active=count, **kwb),
                 lambda: ref.approx_channel_batch_ref(
                     xb, sb, pb, gb, num_active=count, **kwb)),
                ("k2", lambda: ac.approx_channel_batch_aggregate_kernel(
                    xb, sb, pb, gb, wb, num_active=count, **kwb),
                 lambda: ref.approx_channel_batch_aggregate_ref(
                     xb, sb, pb, gb, wb, num_active=count, **kwb))):
            p1 = clock.median_ms(plain, preps)
            t1 = clock.median_ms(kern, reps)
            t2 = clock.median_ms(kern, reps)
            p2 = clock.median_ms(plain, preps)
            b = _bound(count, n, k, "rayleigh", 32, name)
            _log(f"  {name} bucket k={k} capacity {cap} num_active {count}: "
                 f"kernel {min(t1, t2):.4f} ms (runs {t1:.4f}, {t2:.4f}), "
                 f"plain {min(p1, p2):.3f} ms; bound {b['bound_ms']:.4f} ms "
                 f"({b['bound_by']}: {b['bytes'] / 1e6:.2f} MB, "
                 f"{b['ops'] / 1e9:.2f} G ops)")
    # K1 at phase 5f's sparse value-leg shapes: C clients of k words, one
    # zero-padded 1,024-word tile each (as the wrapper pads them); the
    # bound counts the k words the leg needs.
    for label, cs, ks, kbits in sparse_shapes:
        xs = torch.nn.functional.pad(
            (torch.randn((cs, ks), generator=g) * 1e-2).to(device),
            (0, (-ks) % 1024))
        ss = ops._seed_from_key(transport.client_keys(prng.PRNGKey(ks), cs)
                                ).to(device)
        ps = torch.full((cs,), 1e-4, dtype=torch.float32, device=device)
        gs = torch.full((cs,), 1e-3, dtype=torch.float32, device=device)
        kws = dict(kw, bits_per_symbol=kbits)
        kern = lambda: ac.approx_channel_batch_kernel(  # noqa: E731
            xs, ss, ps, gs, **kws)
        plain = lambda: ref.approx_channel_batch_ref(  # noqa: E731
            xs, ss, ps, gs, **kws)
        p1 = clock.median_ms(plain, preps)
        t1 = clock.median_ms(kern, reps)
        t2 = clock.median_ms(kern, reps)
        p2 = clock.median_ms(plain, preps)
        b = _bound(cs, ks, kbits, "rayleigh", 32, "k1")
        _log(f"  k1 sparse value leg ({label}): C={cs}, k={ks} words "
             f"(tile {xs.shape[1]}), {kbits} bits/symbol: kernel "
             f"{min(t1, t2):.4f} ms (runs {t1:.4f}, {t2:.4f}), plain "
             f"{min(p1, p2):.3f} ms; bound {b['bound_ms']:.5f} ms "
             f"({b['bound_by']}: {b['bytes'] / 1e6:.3f} MB, "
             f"{b['ops'] / 1e9:.3f} G ops)")
    rows.append(_stage_times(torch, device, small, launches, sass, mhz))
    return rows


def _stage_times(torch, device, small: bool, launches: dict, sass: dict,
                 mhz) -> dict:
    """The channel stage at the ``cnn-approx-layered`` cell's shape: kernel
    against the eager chain bit for bit, both timed; its ``kernels`` row."""
    from repro_torch.core import channel, modulation, prng, transport

    c, s = (4, 2048 * 16) if small else (100, 21840 * 16)
    clock = Clock(torch, device)
    cfg = transport.TransportConfig(
        modulation="qpsk", channel=channel.ChannelConfig(snr_db=10.0))
    sym = prng.randint(prng.PRNGKey(6, device=device), (c, s), 0, 4)
    keys = transport.client_keys(prng.PRNGKey(7, device=device), c)

    def eager():
        r, cc = channel.transmit(modulation.modulate(sym, cfg.scheme), keys,
                                 cfg.channel)
        return channel.equalize(r, cc), cc

    y, cc = transport._through_channel(sym, keys, cfg, gain=True)
    want_y, want_c = eager()
    differ = 0
    for got, want in ((y, want_y), (cc, want_c)):
        a, b = torch.view_as_real(got), torch.view_as_real(want)
        differ += int(((_bits(torch, a) != _bits(torch, b))
                       & ~(torch.isnan(a) & torch.isnan(b))).sum())
    _check(differ == 0, f"channel stage: {differ} values of y and c differ "
           "from the eager chain")
    err = float((y - want_y).abs().max())
    del y, cc, want_y, want_c
    reps, preps = (50, 3) if device.type == "cuda" else (3, 2)
    kern = lambda: transport._through_channel(sym, keys, cfg)  # noqa: E731
    # eager, kernel, kernel, eager: the two orders average out drift
    p1 = clock.median_ms(eager, preps, warmup=1)
    k1 = clock.median_ms(kern, reps)
    k2 = clock.median_ms(kern, reps)
    p2 = clock.median_ms(eager, preps, warmup=1)
    b = _stage_bound(c, s)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    where = "kernel" if device.type == "cuda" else "eager (CPU)"
    _log(f"  channel stage at C={c}, S={s} (QPSK, rayleigh, 10 dB): y and c "
         f"equal the eager chain's bit for bit; {where} {ms:.4f} ms (runs "
         f"{k1:.4f}, {k2:.4f}), eager {plain_ms:.3f} ms (runs {p1:.3f}, "
         f"{p2:.3f}); bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
         f"{b['bytes'] / 1e6:.2f} MB -> {b['bytes_ms']:.4f} ms, "
         f"{b['ops'] / 1e9:.2f} G ops -> {b['ops_ms']:.4f} ms)")
    counts = sass.get("stage")
    if counts and mhz:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        floor = _issue_floor_ms(c * s, counts, sms, mhz)
        _log(f"  channel stage: issue-rate floor {floor:.4f} ms "
             f"({counts['total']} instructions x {c * s / 1e6:.2f} M symbols "
             f"over {sms} SMs x 128 lanes at {mhz:.0f} MHz); kernel at "
             f"{floor / ms:.0%} of it")
    return {"name": "phy_channel", "route": "cuda", "source":
            STAGE_SOURCE, "replaces": None,
            "launches": launches["phy_channel"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on the CPU at small sizes")
    args = parser.parse_args(argv)
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "false); use --cpu to rehearse", file=sys.stderr)
        return 2
    else:
        from repro_torch import resolve_device

        device = resolve_device()
        torch.use_deterministic_algorithms(True)
    small = device.type == "cpu"
    t0 = time.perf_counter()
    dry = None
    try:
        smi, mhz = phase_device(torch, device)
        sass = phase_build(device)
        dry = start_dryrun()
        phase_kernels(torch, device, small)
        launches, main_runs = phase_main_path(torch, device, small)
        if device.type == "cuda":
            phase_reference(torch, device)
        launches["phy_channel"] = phase_layered(torch, device, small)
        buckets, link_runs = phase_link(torch, device, small)
        for k, v in phase_downlink(torch, device, small).items():
            launches[k] += v
        sparse_launches, sparse_shapes = phase_sparse(torch, device, small)
        for k, v in sparse_launches.items():
            launches[k] += v
        for k, v in phase_obs(torch, device, small, main_runs,
                              link_runs).items():
            launches[k] += v
        for k, v in phase_buffered(torch, device, small, main_runs,
                                   link_runs).items():
            launches[k] += v
        llm_launches, k0_row = phase_trainer(torch, device, small, sass, mhz)
        for k, v in llm_launches.items():
            launches[k] += v
        phase_server(torch, device, small)
        for phase in (phase_moe, phase_vlm, phase_hybrid, phase_ssm,
                      phase_audio, phase_long_row):
            for k, v in phase(torch, device, small, sass, mhz).items():
                launches[k] += v
        phase_optim(torch, device, small)
        phase_dryrun(torch, device, small, dry)
        k0_row["launches"] = launches["k0"]
        rows = phase_times(torch, device, small, launches, sass, mhz,
                           buckets, sparse_shapes, k0_row)
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if dry is not None and dry.poll() is None:
            dry.kill()
            dry.wait()
    _log(f"== done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    if device.type == "cuda":
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
    else:
        print(json.dumps({"ok": True, "device": {
            "platform": "cpu", "kind": "cpu", "count": 0}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
