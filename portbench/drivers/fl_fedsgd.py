"""Driver of the FL cells: the paper's FedSGD rounds through the port's
round engine, as ``fl/loop.py::run_fl`` builds it (``FedSGD`` under
``RoundEngine``, driverless, one uplink mode), closed loop: a round starts
when the last one ends.

Set-up builds the world from the seed with the benchmark's own copies of
the data generator and the non-iid split, builds one engine, and runs its
first ``check_rounds`` rounds through ``RoundEngine.run``; those rounds
warm every shape (the payload, the uplink, the eval set) and are the ones
the reference follows. The same engine then runs the window: ``n_rounds``
is sized from the warm-up rounds to outlast the window (a further run
follows if it falls short), and only rounds that end inside the window
count: the rate is those rounds over the time from the window's start to
the end of the last of them. Each round is timed from its start to the next round's start (the
last one to the run's end) by a ``phase_timers=`` sink that notes the
start of each round's ``sample`` scope; the engine's phase times
(``FLResult.phase_s``) split it.

Faults for the comparison's own test are planted with ``fault=``; they
are never set by ``run.py``. ``fault="control"`` is the comparison's
control: the reference's client gradients in TF32 (the step below the
configuration's float32), at the program's parameters and minibatches,
put in the program's place as the round's payload.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from portbench.core import compare, roofline
from portbench.core import trace as trace_lib
from portbench.core.bench import Checks, log
from portbench.reference import cnn as cnn_ref
from portbench.traffic import partition, synth_mnist

__all__ = ["run", "build_world"]


def build_world(seed: int, world: dict):
    """``(client_x (M, n, 28, 28), client_y (M, n), test_x, test_y)``."""
    (img, lab), (tx, ty) = synth_mnist.train_test(
        world["train_per_class"], world["test_per_class"], seed=seed)
    parts = partition.non_iid_partition(
        img, lab, n_clients=world["n_clients"],
        digits_per_client=world["digits_per_client"], seed=seed)
    cx, cy = partition.stack_clients(parts, per_client=world["per_client"],
                                     seed=seed)
    return cx, cy, tx, ty


def _link(traffic: dict) -> dict:
    ln = dict(traffic["link"])
    ln["large_scale_gain"] = ln["tx_power"] * ln["distance"] ** (
        -ln["pathloss_exp"])
    return ln


def _program_transport(link: dict):
    from repro_torch.core import channel as channel_lib
    from repro_torch.core import transport as transport_lib

    return transport_lib.TransportConfig(
        mode=link["mode"], modulation=link["modulation"],
        channel=channel_lib.ChannelConfig(
            snr_db=link["snr_db"], fading=link["fading"],
            tx_power=link["tx_power"], distance=link["distance"],
            pathloss_exp=link["pathloss_exp"]),
        clamp_bound=link["clamp_bound"], use_kernel=link["use_kernel"])


def _round_clock():
    from repro_torch.obs.timers import PhaseTimers

    class RoundClock(PhaseTimers):
        """A ``phase_timers=`` sink that notes when each round starts."""

        def __init__(self):
            super().__init__()
            self.starts: list = []

        @contextlib.contextmanager
        def scope(self, name: str):
            if name == "sample":
                self.starts.append(time.perf_counter())
            yield None

    return RoundClock()


class _Capture:
    """Observes the engine's first rounds: the payloads each uplink sends,
    what it receives and its ``TxStats``, and the parameters after each
    apply; plants a fault when asked."""

    def __init__(self, engine, transport_lib, fused: bool, fault):
        self.engine, self.tl, self.fault, self.fused = (
            engine, transport_lib, fault, fused)
        self.fn = ("transmit_pytree_batch_aggregate" if fused
                   else "transmit_pytree_batch")
        self.params, self.payloads, self.received = [], [], []
        self.bits, self.symbols = [], []
        self.recording = True
        self._orig_apply = engine.algo.apply
        self._orig_payload = engine.algo.payload
        self._orig_tx = getattr(transport_lib, self.fn)

    def apply(self, params, aux, agg):
        if self.fault == "answer_altered":
            first = sorted(agg)[0]
            agg = dict(agg, **{first: agg[first] * 4.0})
        if self.fault == "state_unchanged":
            new = params
        else:
            new, aux = self._orig_apply(params, aux, agg)
        if self.recording:
            self.params.append({k: v.detach().clone() for k, v in new.items()})
        return new, aux

    def half_payload(self, params, xb, yb):
        """The clients' gradients; with the half-batch fault, each client's
        mean over the first half of its minibatch only."""
        half = xb.shape[1] // 2
        return self._orig_payload(params, xb[:, :half], yb[:, :half])

    @staticmethod
    def control_payload(params, xb, yb):
        """The reference's TF32 client gradients as the payload's tree."""
        prec = cnn_ref.precision("tf32", xb.device)
        with prec.scope():
            flat = cnn_ref.client_grads(params, xb, yb, prec)
        out, off = {}, 0
        for k in cnn_ref.PARAM_KEYS:
            n = params[k].numel()
            out[k] = flat[:, off:off + n].reshape(
                (flat.shape[0],) + tuple(params[k].shape))
            off += n
        return out

    def transmit(self, tree, key, cfg, *args, **kw):
        keys = sorted(tree)
        if self.recording:
            self.payloads.append(torch.cat(
                [tree[k].reshape(tree[k].shape[0], -1) for k in keys],
                dim=1).detach().clone())
        out, stats = self._orig_tx(tree, key, cfg, *args, **kw)
        if self.recording:
            lead = (lambda t: t.reshape(-1)) if self.fused else (
                lambda t: t.reshape(t.shape[0], -1))
            self.received.append(torch.cat([lead(out[k]) for k in keys],
                                           dim=-1).detach().clone())
            self.bits.append(stats.bit_errors.detach().double().cpu().numpy())
            self.symbols.append(
                stats.data_symbols.detach().double().cpu().numpy())
        return out, stats

    def __enter__(self):
        self.engine.algo.apply = self.apply
        if self.fault in ("half_batch", "control"):
            self.engine.algo.payload = (self.half_payload
                                        if self.fault == "half_batch"
                                        else self.control_payload)
        setattr(self.tl, self.fn, self.transmit)
        return self

    def __exit__(self, *exc):
        del self.engine.algo.apply
        if self.fault in ("half_batch", "control"):
            del self.engine.algo.payload
        setattr(self.tl, self.fn, self._orig_tx)


def _window(engine, clock, seconds: float, est_round_s: float):
    """Rounds from now until ``seconds`` have passed: ``(rounds, t0)`` with
    each round ``(start, end, phase_s)``; the engine runs on past the close
    to the end of its ``n_rounds``."""
    n = math.ceil(seconds / est_round_s * 1.1) + 2
    t0 = time.perf_counter()
    close = t0 + seconds
    rounds = []
    while True:
        clock.starts = []
        engine.n_rounds = n
        res = engine.run()
        t_end = time.perf_counter()
        ends = clock.starts[1:] + [t_end]
        rounds += list(zip(clock.starts, ends, res.phase_s))
        if t_end >= close:
            return rounds, t0
        n = math.ceil((close - t_end) / est_round_s * 1.1) + 2


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault: str | None = None) -> dict:
    """One run of an FL cell (see the module docstring)."""
    from repro_torch.core import transport as transport_lib
    from repro_torch.configs.mnist_cnn import MnistCnnConfig
    from repro_torch.fl import engine as engine_lib

    traffic, spec, model = cell.traffic, cell.spec, cell.config["model"]
    dev = torch.device(device)
    link = _link(traffic)
    fused = bool(traffic["fused_aggregate"])
    log(t_start, "imported")
    data = build_world(seed, traffic["world"])
    log(t_start, "world built")
    cx, cy, tx, ty = data
    cfg = MnistCnnConfig(
        image_size=model["image_size"],
        conv_channels=tuple(model["conv_channels"]), kernel=model["kernel"],
        fc_hidden=model["fc_hidden"], n_classes=model["n_classes"],
        lr=model["lr"])
    clock = _round_clock()
    n_check = traffic["check_rounds"]
    engine = engine_lib.RoundEngine(
        engine_lib.FedSGD(cfg, batch_per_round=traffic["batch_per_round"]),
        _program_transport(link), cx, cy, tx, ty, n_rounds=n_check,
        seed=seed, eval_every=traffic["eval_every"], fused_aggregate=fused,
        phase_timers=clock, device=dev)
    p0 = {k: v.detach().clone() for k, v in engine.params.items()}
    log(t_start, "engine built")

    with _Capture(engine, transport_lib, fused, fault) as cap:
        engine.run()
        est = float(np.mean(np.diff(clock.starts + [time.perf_counter()])[1:]))
        cap.recording = False
        log(t_start, f"{n_check} check rounds run")

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rounds, t_w0 = _window(engine, clock, seconds, est)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        setup_s = t_w0 - t_start
        log(t_start, f"window closed ({len(rounds)} rounds run)")
        close = t_w0 + seconds
        done = [r for r in rounds if r[1] <= close]
        durs = [r[1] - r[0] for r in done]
        # the window runs from its start to the end of the last round that
        # ends inside it: every round completed, over the time they took
        span = (done[-1][1] - t_w0) if done else seconds
        out = {"attempted": len(done), "failed": 0, "peak_bytes": peak}
        out["end_to_end"] = {
            "fl_rounds_per_s": (len(done) / span, "rounds/s"),
            "fl_round_p95_ms": (float(np.percentile(durs, 95)) * 1e3
                                if durs else math.inf, "ms"),
            "peak_mem_gib": (peak / 2**30, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        if trace:
            summary = None
            if dev.type == "cuda":
                engine.n_rounds = spec["profile_rounds"]
                with trace_lib.profiled(dev) as tr:
                    engine.run()
                summary = trace_lib.summarize(tr)
                log(t_start, "trace read")
            n_words = sum(int(v.numel()) for v in p0.values())
            out["records"] = {
                "window_s": span,
                "rounds": [{"dur_s": r[1] - r[0], "phase_s": r[2]}
                           for r in done],
                "round_flops": roofline.cnn_round_flops(
                    model, traffic["world"]["n_clients"],
                    traffic["batch_per_round"]),
                "eval_flops": roofline.cnn_forward_flops(model) * len(ty),
                "profile": summary,
                "k2_bound_ms": (roofline.kernel_bound(
                    traffic["world"]["n_clients"],
                    roofline.padded_words(n_words, link["block_words"]),
                    link["bits_per_symbol"], link["fading"], 32,
                    "k2")["bound_ms"] if fused and link["use_kernel"]
                    else None),
            }
            if summary is not None:
                out["breakdown"] = {"device_ops": summary["device_ops"],
                                    "idle_gaps": summary["idle_gaps"]}

    prog = {"params": [p0] + cap.params, "payload": cap.payloads,
            "received": cap.received, "bits": cap.bits,
            "symbols": cap.symbols}
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(prog, seed, data, model, traffic, link,
                          spec["limits"], dev)
    log(t_start, "reference compared")
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def _blocks(flat: torch.Tensor, sizes: dict) -> list:
    """The ``(M, D)`` rows cut into the parameters' ``(M, n)`` blocks."""
    out, off = [], 0
    for k in cnn_ref.PARAM_KEYS:
        out.append(flat[:, off:off + sizes[k]])
        off += sizes[k]
    return out


def grad_numbers(payload: torch.Tensor, ref: torch.Tensor, sizes: dict):
    """``(gaps of norms, errors)`` of each parameter's ``(M, n)`` block of
    the clients' gradients (``compare.leaf_gaps`` / ``leaf_errs``)."""
    pb, rb = _blocks(payload, sizes), _blocks(ref, sizes)
    return (compare.leaf_gaps(compare.leaf_norms(pb), compare.leaf_norms(rb)),
            compare.leaf_errs(pb, rb))


def judge(prog: dict, seed: int, data, model: dict, traffic: dict,
          link: dict, limits: dict, device) -> Checks:
    """The FL cell's numbers, following the program round by round: its
    first parameters against the reference's (exact); each round's client
    gradients against the reference's at the program's parameters of that
    round (the first at the reference's own), by the worst parameter; the
    uplink of the program's payloads against the reference's chain (words
    that differ, exact); the SGD update of the received aggregate (words
    that differ, exact); and each client's bit errors and data symbols
    (exact)."""
    c = Checks(limits)
    n = len(prog["payload"])
    pk, rounds = cnn_ref.round_inputs(
        seed, data, n_rounds=n, batch_per_round=traffic["batch_per_round"],
        device=device)
    p0 = cnn_ref.init_params(pk, model, device)
    keys = cnn_ref.PARAM_KEYS
    c.add("init_differ", sum(int((_bits(prog["params"][0][k])
                                  != _bits(p0[k])).sum()) for k in keys))
    sizes = cnn_ref.leaf_sizes(model)
    prec = cnn_ref.precision("fp32", device)
    gaps, errs_ = [], []
    up = app = cnt = 0
    for r, (rk, xb, yb) in enumerate(rounds):
        params = p0 if r == 0 else prog["params"][r]
        with prec.scope():
            g = cnn_ref.client_grads(params, xb, yb, prec)
        rg, re = grad_numbers(prog["payload"][r], g, sizes)
        gaps.append(rg)
        errs_.append(re)
        rx, errs = cnn_ref.uplink(prog["payload"][r], rk, link)
        got = prog["received"][r]
        up += (int((_bits(rx) != _bits(got)).sum()) if got.shape == rx.shape
               else rx.numel())
        if rx.dim() == 1:
            agg = dict(zip(keys, rx.split([sizes[k] for k in keys])))
        else:
            agg = {k: b.mean(dim=0) for k, b in zip(
                keys, rx.split([sizes[k] for k in keys], dim=1))}
        if r + 1 < len(prog["params"]):
            before, after = prog["params"][r], prog["params"][r + 1]
            for k in keys:
                want = (before[k].to(torch.float32) - model["lr"]
                        * agg[k].reshape(before[k].shape).to(torch.float32))
                app += int((_bits(want) != _bits(after[k])).sum())
        else:
            app += sum(sizes.values())
        errs = errs.cpu().numpy().astype(np.float64)
        sym = np.full(errs.shape, prog["payload"][r].shape[1] * 32
                      // link["bits_per_symbol"], np.float64)
        bits, syms = prog["bits"][r], prog["symbols"][r]
        if bits.shape != errs.shape:
            cnt += int(errs.sum() + sym.sum())
        else:
            cnt += int(np.abs(bits - errs).sum() + np.abs(syms - sym).sum())
    compare.add_grad_checks(c, gaps, errs_, keys)
    c.add("uplink_differ", up)
    c.add("apply_differ", app + abs(len(prog["params"]) - 1 - n))
    c.add("counts_differ", cnt)
    return c
