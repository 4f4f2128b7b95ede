"""Buffered asynchronous FL engine (port): FedBuff-style rounds on an
event clock.

Counterpart of ``repro.fl.async_engine``. The synchronous
:class:`~repro_torch.fl.engine.RoundEngine` closes a barrier every round;
this engine dispatches clients in *waves* and lets each update land at

    t_arrival = t_dispatch + downlink_wait + compute_time + uplink_airtime

(``core.latency.arrival_times``; compute times from
``link.dynamics.compute_times``, airtime priced as in the sync engine).
The server aggregates whenever ``buffer_k`` updates have landed, weighting
each by a staleness function of how many aggregations it missed while in
flight (:func:`staleness_weight`: constant / polynomial / inverse).

A wave is the sync round's body (``RoundEngine._round_body``: link step,
downlink, payloads, uplink) over the **full cohort**, with a ``member``
mask: non-members' rows are sent and dropped, so the kernels launch as in
a sync round (one K1 per wave or per uncoded mode bucket; K2 on fused
waves, weighted by ``normalize_weights(member)`` or
``normalize_weights(member * active)``). The link step observes only
members (``ScenarioDriver.round(observed=member)``), and only members'
previous estimate and EF residual move, so a client that skips waves
re-enters with its state bit for bit.

Key schedule: one ``split`` of the run key per dispatch attempt that
reaches the churn / wave draw (never on a plain nobody-is-ready miss);
compute times, churn and idle gaps ride reserved ``fold_in`` lanes of the
wave key, and the frozen speed factors ``fold_in(key, COMPUTE_KEY_LANE)``
of the post-init key. The keys stay on the host, so the schedule is the
same on every device; the event clock is host float64 with a ``heapq`` of
``(t_arrival, wave_id, client)`` for a deterministic tie order.

With simultaneous arrivals (the default ``ComputeTimeConfig``), ``buffer_k
= num_clients`` and constant weights every wave is one sync round, and the
run is bit for bit the sync engine's: a driverless buffer of one complete
uniform wave takes the sync ``mean(dim=0)``; one entry takes
``tensordot(w, g) / where(total > 0, total, 1)``, equal to
``dropout_weighted_mean`` for 0/1 weights; several entries go through
:func:`weighted_buffer_mean`.

Observability: ``ledger=`` adds the manifest's ``engine``, ``buffer_k``,
``staleness`` and ``staleness_alpha`` (fingerprint re-derived over them
and the event-layer configs, equal to the reference's), the event stream
(``join`` / ``leave``, ``wave``, ``compute``, ``uplink``, ``arrival``,
``buffer``, ``aggregate``) and ``event_s`` on each eval line; ``trace=``
(a path or a ``TraceRecorder``) records the same events as a Chrome
trace; ``phase_timers=`` times ``sample`` / ``wave`` / ``telemetry`` /
``eval``, each closed after a device synchronise on CUDA; ``sketches=``
sketches each wave over its members and the staleness of every folded
update. ``FLResult.phase_s`` holds one dict per dispatched wave with the
sync keys; ``apply`` and ``eval`` land on the newest wave folded into an
aggregation.
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from repro_torch.core import keylanes
from repro_torch.core import latency as latency_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.fl import engine as engine_lib
from repro_torch.kernels import approx_channel as ac
from repro_torch.link import dynamics as dynamics_lib
from repro_torch.obs import ledger as ledger_lib
from repro_torch.obs import records as records_lib
from repro_torch.obs import spans
from repro_torch.obs import trace as trace_lib

__all__ = [
    "STALENESS_KINDS",
    "staleness_weight",
    "weighted_buffer_mean",
    "AsyncRoundEngine",
    "run_fl_buffered",
    "run_fedavg_buffered",
]

STALENESS_KINDS = ("constant", "polynomial", "inverse")


def staleness_weight(staleness, kind: str = "constant",
                     alpha: float = 0.5) -> torch.Tensor:
    """Aggregation weight of an update that missed ``staleness``
    aggregations, float32: ``constant`` is 1.0, ``polynomial`` ``(1 +
    s)^-alpha``, ``inverse`` ``1 / (1 + s)``. Each is non-negative, 1 at
    ``s = 0`` and non-increasing; :func:`weighted_buffer_mean` normalizes.
    """
    s = torch.as_tensor(staleness, dtype=torch.float32)
    one = torch.ones_like(s)
    if kind == "constant":
        return one
    if kind == "polynomial":
        return torch.pow(one + s, torch.tensor(-alpha, dtype=torch.float32))
    if kind == "inverse":
        return one / (one + s)
    raise ValueError(
        f"unknown staleness kind {kind!r}; pick one of {STALENESS_KINDS}")


def _weighted_mean(tree, wvec):
    """``tensordot(w, g) / where(total > 0, total, 1)`` over the client
    axis of every leaf: an all-zero ``wvec`` gives zeros."""
    leaves, spec = transport_lib.tree_flatten(tree)
    w = torch.as_tensor(wvec, dtype=torch.float32).to(leaves[0].device)
    total = w.sum()
    denom = torch.where(total > 0, total, torch.ones_like(total))
    return transport_lib.tree_unflatten(spec, [
        torch.tensordot(w, g, dims=([0], [0])) / denom for g in leaves])


def weighted_buffer_mean(entries):
    """Staleness-weighted mean of buffered wave payloads.

    ``entries``: ``(wave_id, hat, wvec)`` with ``hat`` a tree of ``(M,
    ...)`` leaves and ``wvec`` the ``(M,)`` weights (0 for clients not in
    the buffer). Sorted by wave id before any float op, so the result does
    not depend on arrival order; an all-zero total gives zeros.
    """
    entries = sorted(entries, key=lambda e: e[0])
    if not entries:
        raise ValueError("weighted_buffer_mean needs at least one entry")
    part, total, spec = None, None, None
    for _, hat, wvec in entries:
        leaves, spec = transport_lib.tree_flatten(hat)
        w = torch.as_tensor(wvec, dtype=torch.float32).to(leaves[0].device)
        p = [torch.tensordot(w, g, dims=([0], [0])) for g in leaves]
        part = p if part is None else [a + b for a, b in zip(part, p)]
        total = w.sum() if total is None else total + w.sum()
    denom = torch.where(total > 0, total, torch.ones_like(total))
    return transport_lib.tree_unflatten(spec, [g / denom for g in part])


class AsyncRoundEngine(engine_lib.RoundEngine):
    """Buffered asynchronous round driver over the sync engine.

    Construction is :class:`~repro_torch.fl.engine.RoundEngine`'s (the
    scenario, downlink and compression resolution, ECRT pricing, the key
    schedule, ``device``) plus ``buffer_k`` (``None`` = the cohort),
    ``staleness`` / ``staleness_alpha``, the event-layer configs
    ``compute`` / ``arrival`` (default: the scenario's) and ``trace=``.
    ``n_rounds`` counts aggregations (model versions).

    Waves go out at aggregation boundaries and on buffer drains, carrying
    every joined, idle client past its post-upload gap. Dropped clients
    (``dropout_prob``) send nothing and are ready again at their arrival
    time; churned-out clients keep an upload in flight but are not sent
    again until they rejoin. A run in which no client can ever arrive
    raises ``RuntimeError``.
    """

    def __init__(self, algorithm, transport_cfg, client_x, client_y,
                 test_x, test_y, *, n_rounds: int, buffer_k: int | None = None,
                 staleness: str = "constant", staleness_alpha: float = 0.5,
                 compute: dynamics_lib.ComputeTimeConfig | None = None,
                 arrival: dynamics_lib.ArrivalConfig | None = None,
                 seed: int = 0, eval_every: int = 2,
                 timings: latency_lib.PhyTimings | None = None,
                 scenario=None, adaptive_dispatch: str = "bucketed",
                 downlink=None, compression=None,
                 fused_aggregate: bool = False, ledger=None, trace=None,
                 phase_timers=None, sketches=None, device=None):
        super().__init__(
            algorithm, transport_cfg, client_x, client_y, test_x, test_y,
            n_rounds=n_rounds, seed=seed, eval_every=eval_every,
            timings=timings, scenario=scenario,
            adaptive_dispatch=adaptive_dispatch, downlink=downlink,
            compression=compression, fused_aggregate=fused_aggregate,
            ledger=ledger, phase_timers=phase_timers, sketches=sketches,
            device=device)
        self.trace = trace_lib.as_trace(trace)
        M = self.num_clients
        self.buffer_k = M if buffer_k is None else int(buffer_k)
        if not 1 <= self.buffer_k <= M:
            raise ValueError(
                f"buffer_k must be in [1, {M}], got {self.buffer_k}")
        if self.fused_aggregate and self.buffer_k != M:
            # Only a full-wave buffer knows its weights (all staleness 0)
            # when the fused transport pass runs.
            raise ValueError(
                "fused_aggregate=True needs buffer_k == num_clients "
                f"({M}): partial buffers weight updates by staleness at "
                "aggregation time, after the fused transport pass")
        if staleness not in STALENESS_KINDS:
            raise ValueError(
                f"staleness must be one of {STALENESS_KINDS}, got "
                f"{staleness!r}")
        self.staleness = staleness
        self.staleness_alpha = float(staleness_alpha)
        scen = None if self.driver is None else self.driver.scenario
        self.compute_cfg = (compute
                            or (scen.compute if scen is not None else None)
                            or dynamics_lib.ComputeTimeConfig())
        self.arrival_cfg = (arrival if arrival is not None
                            else (scen.arrival if scen is not None else None))
        self._speed = dynamics_lib.client_speed_factors(
            prng.fold_in(self._key, keylanes.COMPUTE_KEY_LANE), M,
            self.compute_cfg)

    # ------------------------------------------------------- observability

    def _manifest(self) -> dict:
        """The sync manifest plus the buffering axis; the fingerprint is
        re-derived over it and the event-layer configs, as the
        reference's."""
        man = super()._manifest()
        man["engine"] = "async"
        man["buffer_k"] = self.buffer_k
        man["staleness"] = self.staleness
        man["staleness_alpha"] = self.staleness_alpha
        man["fingerprint"] = ledger_lib.config_fingerprint(
            man["fingerprint"], self.buffer_k, self.staleness,
            self.staleness_alpha, self.compute_cfg, self.arrival_cfg)
        return man

    @property
    def _obs_events(self) -> bool:
        """Whether any sink wants the event stream."""
        return (self.trace is not None
                or (self.ledger is not None and self.ledger.events))

    def _emit(self, **kw) -> None:
        """One event record to the ledger and the trace."""
        ev = records_lib.EventRecord(**kw)
        if self.ledger is not None:
            self.ledger.write_event(ev)
        if self.trace is not None:
            self.trace.add(ev)

    def _staleness_om(self, s: int) -> float:
        """Host float weight of staleness ``s`` (float32 arithmetic)."""
        return float(staleness_weight(s, self.staleness,
                                      self.staleness_alpha))

    # ---------------------------------------------------------------- run

    def run(self) -> engine_lib.FLResult:
        """Drive ``n_rounds`` buffered aggregations; returns the
        ``FLResult`` with ``event_s`` beside the usual curves."""
        algo, driver, dev = self.algo, self.driver, self.device
        obs = self._obs_events
        M, K = self.num_clients, self.buffer_k
        params, aux, key = self.params, self.aux, self._key
        rng = np.random.default_rng(self.seed)
        res = engine_lib.FLResult([], [], [], 0.0, 0.0)
        t_start = time.perf_counter()
        if self.ledger is not None:
            self.ledger.write_manifest(self._manifest())
        cum_air, t_now, version, next_wave, buffered = 0.0, 0.0, 0, 0, 0
        ready_t = np.zeros(M, np.float64)
        in_flight = np.zeros(M, bool)
        joined = np.ones(M, np.float32)
        heap = []  # (t_arrival, wave_id, client): deterministic tie order
        waves = {}  # wave_id -> hat / agg, version, arrived, pending, ...

        def idle_now():
            return (joined > 0) & ~in_flight & (ready_t <= t_now)

        def dispatch() -> bool:
            """Send one wave of every joined, idle, ready client; True if
            one went out. One key split per attempt that reaches the churn
            or wave draw."""
            nonlocal key, cum_air, next_wave
            w_id = next_wave
            idle = idle_now()
            if self.arrival_cfg is None and not idle.any():
                return False
            with spans.collect(dev) as split, spans.span("key"):
                key, rk = prng.split(key)
            if self.arrival_cfg is not None:
                prev = joined.copy()
                joined[:] = dynamics_lib.churn_step(
                    rk, torch.from_numpy(prev), self.arrival_cfg).numpy()
                if obs:
                    for i in np.nonzero(prev != joined)[0]:
                        self._emit(t=t_now, client=int(i),
                                   kind="join" if joined[i] > 0 else "leave")
                idle = idle_now()
                if not idle.any():
                    return False
            member_np = idle.astype(np.float32)
            member = torch.from_numpy(member_np)
            before = ac.launch_counts()
            with spans.collect(dev) as top, spans.span("round", id=w_id):
                with self._scope("sample"), spans.span("sample"):
                    xb, yb = algo.sample(rng, self.client_x,
                                         self.client_y, dev)
                with self._scope("wave"):
                    hat, agg, stats, dstats, rnd, phases = self._round_body(
                        params, xb, yb, rk, member, aggregate=False)
                member_dev = member.to(dev)
                with self._scope("telemetry"), spans.span("telemetry"):
                    if driver is None:
                        per_air = latency_lib.round_airtime(
                            stats, self.timings, self.transport_cfg.mode)
                        if self.ecrt_air_scale is not None:
                            per_air = per_air * self.ecrt_air_scale
                        per_air = per_air * member_dev
                        rec = records_lib.RoundRecord(round=w_id)
                        active = member
                    else:
                        per_air = driver.airtime(stats, rnd,
                                                 self.timings) * member_dev
                        rec = records_lib.scenario_round_record(
                            w_id, rnd, per_air, len(driver.mode_cfgs))
                        active = member * rnd.active
                    cum_air += float(torch.sum(per_air))
                    if self.compression is not None:
                        self._compression_record(rec, stats, rnd)
                    dl_wait = 0.0
                    if dstats is not None:
                        dl_wait = self._downlink_record(rec, dstats)
                        cum_air += dl_wait
            comp_s = dynamics_lib.compute_times(
                rk, self.compute_cfg, M, self._speed).numpy().astype(
                    np.float64)
            air_np = per_air.cpu().numpy().astype(np.float64)
            arr = latency_lib.arrival_times(t_now, comp_s, air_np, dl_wait)
            gaps = np.zeros(M, np.float64)
            if self.arrival_cfg is not None:
                gaps = dynamics_lib.idle_gaps(
                    rk, M, self.arrival_cfg).numpy().astype(np.float64)
            active_b = active.numpy() > 0
            members = np.nonzero(member_np > 0)[0]
            pending = 0
            for i in members:
                i = int(i)
                if active_b[i]:
                    heapq.heappush(heap, (float(arr[i]), w_id, i))
                    in_flight[i] = True
                    pending += 1
                else:
                    # Dropped: no uplink (air 0); back after the broadcast
                    # wait and the compute time.
                    ready_t[i] = float(arr[i])
            if obs:
                landed = [float(arr[i]) for i in members if active_b[i]]
                self._emit(t=t_now, kind="wave", wave=w_id,
                           dur=(max(landed) - t_now) if landed else 0.0,
                           value=float(len(members)))
                for i in members:
                    i = int(i)
                    self._emit(t=t_now + dl_wait, kind="compute", wave=w_id,
                               client=i, dur=float(comp_s[i]))
                    if active_b[i]:
                        self._emit(t=t_now + dl_wait + float(comp_s[i]),
                                   kind="uplink", wave=w_id, client=i,
                                   dur=float(air_np[i]))
            if self.sketcher is not None:
                with spans.collect(dev) as more, self._scope("telemetry"), \
                        spans.span("telemetry", id=w_id):
                    rec.sketches = self.sketcher.round_group(
                        rk, snr_db=rnd.snr_db, est_db=rnd.est_db,
                        ber=stats.client_metrics()["ber"],
                        airtime_s=per_air, mode=rnd.mode,
                        active=rnd.active, member=member,
                        downlink_ber=None if dstats is None else dstats.ber)
                top["telemetry"] += more["telemetry"]
            rec.t_event = t_now
            self._finish_record(res, rec, stats)
            phases = {"key": split["key"], "sample": top["sample"], **phases,
                      "telemetry": top["telemetry"]}
            res.phase_s.append(phases)
            res.counters.append(engine_lib.launch_deltas(before))
            waves[w_id] = {"hat": hat, "agg": agg, "version": version,
                           "arrived": np.zeros(M, np.float32),
                           "pending": pending, "gaps": gaps,
                           "phases": phases}
            next_wave += 1
            return True

        def aggregate() -> None:
            """Fold the buffer into the model (one model version), entries
            in wave-id order; a fused run holds one wave whose transport
            pass made the aggregate already."""
            nonlocal params, aux, version, buffered
            if self.fused_aggregate:
                newest = max(waves)
                arrived = waves[newest]["arrived"]
                folded = [(newest, arrived, 0)]
            else:
                folded = [(w, info["arrived"], version - info["version"])
                          for w, info in sorted(waves.items())
                          if info["arrived"].any()]
                newest = folded[-1][0] if folded else max(waves)
            if self.sketcher is not None and folded:
                # One staleness observation per folded client update.
                self.sketcher.observe_staleness(np.concatenate([
                    np.full(int(mask.sum()), s, np.float32)
                    for _, mask, s in folded]))
            if obs:
                self._emit(t=t_now, kind="aggregate", version=version,
                           value=float(sum(int(m.sum())
                                           for _, m, _ in folded)))
                self._emit(t=t_now, kind="buffer", value=0.0)
            with spans.collect(dev) as folds:
                with spans.span("apply", device=True, id=newest):
                    if self.fused_aggregate:
                        agg = waves.pop(newest)["agg"]
                    else:
                        entries = [(w, waves[w]["hat"], mask,
                                    self._staleness_om(s))
                                   for w, mask, s in folded]
                        if not entries:
                            # Every member of the flushed wave dropped out:
                            # the sync engine still applies its (zero)
                            # mean, so do the same.
                            agg = _weighted_mean(waves[newest]["hat"],
                                                 np.zeros(M, np.float32))
                        elif (driver is None and len(entries) == 1
                              and entries[0][3] > 0
                              and bool(entries[0][2].all())):
                            # One complete uniform driverless wave: the
                            # sync mean.
                            agg = {k: g.mean(dim=0)
                                   for k, g in entries[0][1].items()}
                        elif len(entries) == 1:
                            _, hat, mask, om = entries[0]
                            agg = _weighted_mean(hat, mask * np.float32(om))
                        else:
                            agg = weighted_buffer_mean(
                                [(w, hat, mask * np.float32(om))
                                 for w, hat, mask, om in entries])
                        for w, *_ in entries:
                            waves[w]["arrived"][:] = 0.0
                        for w in [w for w, info in waves.items()
                                  if info["pending"] == 0
                                  and not info["arrived"].any()]:
                            del waves[w]
                    params, aux = algo.apply(params, aux, agg)
                engine_lib._sync(dev)
                r, acc = version, None
                if r % self.eval_every == 0 or r == self.n_rounds - 1:
                    with self._scope("eval"):
                        acc = self._eval_acc(params)
            ph = res.phase_s[newest]
            ph["apply"] = ph.get("apply", 0.0) + folds["apply"]
            ph["eval"] = ph.get("eval", 0.0) + folds.get("eval", 0.0)
            buffered = 0
            version += 1
            if acc is not None:
                res.rounds.append(r)
                res.accuracy.append(acc)
                res.airtime_s.append(cum_air)
                res.event_s.append(t_now)
                if self.ledger is not None:
                    self.ledger.write_eval(r, acc, cum_air, event_s=t_now)

        dispatch()
        stalls = 0
        while version < self.n_rounds:
            if buffered >= K or (not heap and waves):
                # K updates landed, or the pipeline drained with waves
                # outstanding (a wave short of its dropouts, or dropped
                # whole): aggregate before any new dispatch, as the sync
                # rounds do.
                aggregate()
                if version < self.n_rounds:
                    dispatch()
                continue
            if heap:
                t_arr, w, i = heapq.heappop(heap)
                t_now = t_arr
                info = waves[w]
                info["arrived"][i] = 1.0
                info["pending"] -= 1
                in_flight[i] = False
                ready_t[i] = t_arr + info["gaps"][i]
                buffered += 1
                if obs:
                    self._emit(t=t_arr, kind="arrival", wave=w, client=i)
                    self._emit(t=t_arr, kind="buffer", value=float(buffered))
                continue
            # Empty buffer, nothing in flight: dispatch, or move the clock
            # to the next ready client, or churn until someone rejoins.
            if dispatch():
                stalls = 0
                continue
            cand = ready_t[(joined > 0) & ~in_flight]
            if cand.size and cand.min() > t_now:
                t_now = float(cand.min())
                continue
            stalls += 1
            if (self.arrival_cfg is None
                    or self.arrival_cfg.p_rejoin <= 0 or stalls > 100_000):
                raise RuntimeError(
                    "buffered run stalled: no client can ever arrive "
                    f"(version {version}/{self.n_rounds})")

        self.params, self.aux, self._key = params, aux, key
        res.wall_s = time.perf_counter() - t_start
        res.final_accuracy = res.accuracy[-1]
        self._finish_run(res)
        if self.trace is not None and self.trace.path is not None:
            self.trace.export()
        return res


def run_fl_buffered(cfg, transport_cfg, client_x, client_y, test_x, test_y,
                    n_rounds: int = 40, batch_per_round: int = 32,
                    seed: int = 0, eval_every: int = 2, timings=None,
                    scenario=None, adaptive_dispatch: str = "bucketed",
                    downlink=None, compression=None,
                    fused_aggregate: bool = False,
                    buffer_k: int | None = None,
                    staleness: str = "constant",
                    staleness_alpha: float = 0.5,
                    compute=None, arrival=None, ledger=None, trace=None,
                    phase_timers=None, sketches=None,
                    device=None) -> engine_lib.FLResult:
    """Buffered (FedBuff-style) FedSGD over the simulated wireless uplink.

    The counterpart of :func:`repro_torch.fl.loop.run_fl`: the same
    arguments plus ``buffer_k`` (``None`` = the cohort), ``staleness``
    (``constant`` / ``polynomial`` / ``inverse``, exponent
    ``staleness_alpha``), ``compute`` / ``arrival`` (default: the
    scenario's) and ``trace=``. With ``buffer_k=None``, the default compute
    model and constant weights the result is bit for bit ``run_fl``'s.
    ``device=None`` is the GPU.
    """
    algo = engine_lib.FedSGD(cfg, batch_per_round=batch_per_round)
    return AsyncRoundEngine(
        algo, transport_cfg, client_x, client_y, test_x, test_y,
        n_rounds=n_rounds, buffer_k=buffer_k, staleness=staleness,
        staleness_alpha=staleness_alpha, compute=compute, arrival=arrival,
        seed=seed, eval_every=eval_every, timings=timings, scenario=scenario,
        adaptive_dispatch=adaptive_dispatch, downlink=downlink,
        compression=compression, fused_aggregate=fused_aggregate,
        ledger=ledger, trace=trace, phase_timers=phase_timers,
        sketches=sketches, device=device,
    ).run()


def run_fedavg_buffered(cfg, transport_cfg, client_x, client_y, test_x,
                        test_y, n_rounds: int = 40, local_steps: int = 4,
                        batch_per_step: int = 32, scale_mode: str = "none",
                        seed: int = 0, eval_every: int = 2, timings=None,
                        scenario=None, adaptive_dispatch: str = "bucketed",
                        downlink=None, compression=None,
                        fused_aggregate: bool = False,
                        buffer_k: int | None = None,
                        staleness: str = "constant",
                        staleness_alpha: float = 0.5,
                        compute=None, arrival=None, ledger=None, trace=None,
                        phase_timers=None, sketches=None,
                        device=None) -> engine_lib.FLResult:
    """Buffered (FedBuff-style) FedAvg, the counterpart of
    :func:`repro_torch.fl.fedavg.run_fedavg`; see :func:`run_fl_buffered`
    for the buffering arguments."""
    algo = engine_lib.FedAvg(cfg, local_steps=local_steps,
                             batch_per_step=batch_per_step,
                             scale_mode=scale_mode)
    return AsyncRoundEngine(
        algo, transport_cfg, client_x, client_y, test_x, test_y,
        n_rounds=n_rounds, buffer_k=buffer_k, staleness=staleness,
        staleness_alpha=staleness_alpha, compute=compute, arrival=arrival,
        seed=seed, eval_every=eval_every, timings=timings, scenario=scenario,
        adaptive_dispatch=adaptive_dispatch, downlink=downlink,
        compression=compression, fused_aggregate=fused_aggregate,
        ledger=ledger, trace=trace, phase_timers=phase_timers,
        sketches=sketches, device=device,
    ).run()
