"""The port's span recorder: named time spans at every layer boundary,
summed per name inside a collecting scope and kept whole inside a
recording scope, without synchronising the device.

A call site marks a step with ``with span(name):`` (host work) or
``with span(name, device=True):`` (work that runs on the device). Outside
any scope a span costs one context-variable read. Inside a scope:

* a host span keeps its host-clock time;
* a device span on a CUDA scope records a pair of CUDA events on the
  current stream, and its time is the device's time between them. The
  pair is resolved only after a synchronise the program makes anyway:
  :func:`settle` after it (the round engine's phase-end sync calls it),
  or the end of a scope, which the caller closes after a synchronise of
  its own (the LLM step's ``float(loss)``, the eval's accuracy read). A
  pair still running when the outermost scope closes is a caller's error
  and raises ``RuntimeError``: this module never waits for the device.
  On the CPU every span is host time.

:func:`collect` yields ``{name: seconds}``, each name summed over the
spans closed inside it (inside nested scopes too). :func:`record` yields a
:class:`Recording` whose ``spans`` hold every span closed inside it as a
:class:`Span`: its name, its parent (index into ``spans``), its round or
step id (given on a root span, inherited below it), its host start and end
in Unix-epoch nanoseconds (the clock the profiler's trace uses:
``kineto_results.trace_start_ns()`` plus its relative times), and its
device seconds. Scopes nest freely: a collect inside a recording scope
hides nothing from it.

The span tree (``FLResult.phase_s`` keys in brackets)::

    round (id: round)                      fl/engine.py, run
      key               host   [key]       the round key's split (threefry)
      sample            host   [sample]    numpy gather + host-to-device copy
      link              host   [link]      scenario rounds' link step
      downlink          dev    [downlink]  the broadcast, parts as the uplink's
      gradients         dev    [gradients] FedSGD.payload / FedAvg local steps
      uplink            dev    [uplink]
        keys            host   [uplink_keys]    key schedule, kernel seeds
        kernel          dev    [uplink_kernel]  K1 / K2 (on the CPU: plain)
        codec           dev    [uplink_codec]   layered PHY: bits, symbols,
                                                interleave; back to words,
                                                clamp, popcount, floats
        channel         dev    [uplink_channel] Gray QAM, channel draws, ZF
        demod           dev    [uplink_demod]   ML demod, deinterleave
        mean            dev    [uplink_mean]    the PS mean (layered rounds)
      apply             dev    [apply]
      telemetry         host   [telemetry] airtime, record, ledger, sketches
      eval              dev    [eval]

    step (id: call)                        launch/steps.py, approx step
      grad              dev    forward and backward
      uplink            dev    wire cast + approx_allreduce
        flatten         dev    wire cast, transmit_pytree's pack (the
                               row padded to whole tiles as it is built)
        keys            host   fold_in, kernel seed
        kernel          dev    K0
        unflatten       dev    unpack: per-leaf views of the received row
      apply             dev    opt.update

    grad's parts in an MLA moe config (``models/transformer.py``; each
    sums the block's forward, its checkpoint recomputation and its
    backward, see :func:`traced`):
        mla             dev    each MLA block (norm, attention, residual)
        moe             dev    each held-expert MoE FFN (norm, router,
                               dispatch, shared expert, residual)
          experts       dev    the held experts' GEMMs

Counters beside the spans: ``FLResult.counters`` holds one
``{"k0", "k1", "k2"}`` dict a round, the round's launches of each kernel
(deltas of ``kernels.approx_channel.launch_counts()``; 0 on the CPU, whose
plain versions launch nothing). Inside a :func:`counting` scope,
:func:`count` keeps per-layer numbers by name and layer: the MLA moe
config's ``moe_assignments_held`` (token-expert pairs its held experts
computed) and ``moe_max_expert_load`` (the busiest held expert's tokens),
and K0's ``k0_symbols`` (the row's symbols) and ``k0_symbols_slow`` (those
its settling test left to the full chain), at index 0.

This module has no counterpart in the reference. :mod:`repro_torch.obs.
timers` (``PhaseTimers``, the reference's API) stays the engine's
``phase_timers=`` sink; the engine's own phase times are these spans.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch

__all__ = ["Span", "Recording", "collect", "record", "settle", "span",
           "capture", "traced", "counting", "count"]


@dataclasses.dataclass
class Span:
    """One closed span of a recording scope."""

    name: str
    parent: int | None   # index of the enclosing span in ``spans``
    id: int | None       # the round or step it belongs to
    t0_ns: int           # host start, Unix-epoch ns
    t1_ns: int           # host end, Unix-epoch ns
    device_s: float | None = None  # device seconds (CUDA event pair)

    @property
    def seconds(self) -> float:
        """Device seconds for a device span on CUDA, host seconds else."""
        if self.device_s is not None:
            return self.device_s
        return (self.t1_ns - self.t0_ns) * 1e-9


class Recording:
    """The spans of a :func:`record` scope, and the anchor that maps the
    host's ``perf_counter_ns`` onto Unix-epoch ns."""

    def __init__(self):
        self.spans: list = []
        self.epoch_ns = time.time_ns()
        self.perf_ns = time.perf_counter_ns()

    def epoch(self, perf_ns: int) -> int:
        return self.epoch_ns + (perf_ns - self.perf_ns)


class _Root:
    """Device pairs waiting for a synchronise, shared by nested scopes."""

    def __init__(self):
        self.pending: list = []

    def settle(self) -> None:
        left = []
        for item in self.pending:
            name, start, end, sums, rec = item
            if not end.query():
                left.append(item)
                continue
            sec = start.elapsed_time(end) * 1e-3
            for d in sums:
                d[name] = d.get(name, 0.0) + sec
            if rec is not None:
                rec.device_s = sec
        self.pending = left


@dataclasses.dataclass(frozen=True)
class _State:
    sums: tuple          # the dicts of every enclosing collect scope
    rec: Recording | None
    cuda: bool           # device spans take CUDA events
    root: _Root
    parent: int | None = None  # the innermost open span, in rec.spans
    id: int | None = None
    counts: tuple = ()   # the dicts of every enclosing counting scope


_ACTIVE = contextvars.ContextVar("repro_torch_spans", default=None)


@contextlib.contextmanager
def _scope(device, sums=None, rec=None, counts=None):
    outer = _ACTIVE.get()
    cuda = torch.device(device).type == "cuda"
    more = () if counts is None else (counts,)
    if outer is None:
        state = _State(() if sums is None else (sums,), rec, cuda, _Root(),
                       counts=more)
    else:
        state = dataclasses.replace(
            outer, cuda=cuda,
            sums=outer.sums + (() if sums is None else (sums,)),
            counts=outer.counts + more,
            **({} if rec is None else {"rec": rec, "parent": None}))
    token = _ACTIVE.set(state)
    failed = True
    try:
        yield
        failed = False
    finally:
        _ACTIVE.reset(token)
        if state.root.pending:
            state.root.settle()
        if outer is None and state.root.pending and not failed:
            names = sorted({p[0] for p in state.root.pending})
            raise RuntimeError(
                f"spans {names} still running on the device when their "
                "scope closed: close it after a synchronise")


@contextlib.contextmanager
def collect(device):
    """Collect the spans closed inside this scope: yields ``{name:
    seconds}``, each name summed over its spans. ``device`` is the one the
    spans' work runs on (CUDA: device spans are timed by events)."""
    sums: dict = {}
    with _scope(device, sums=sums):
        yield sums


@contextlib.contextmanager
def record(device):
    """Keep every span closed inside this scope whole: yields a
    :class:`Recording`, complete when the scope closes."""
    rec = Recording()
    with _scope(device, rec=rec):
        yield rec


def settle() -> None:
    """Resolve the device pairs of the active scopes that have finished;
    call it after a synchronise the program makes."""
    state = _ACTIVE.get()
    if state is not None and state.root.pending:
        state.root.settle()


@contextlib.contextmanager
def counting(device):
    """Keep the :func:`count` calls made inside this scope: yields
    ``{name: [value per index, in index order]}``, filled when the scope
    closes (close it after a synchronise of the caller's own)."""
    counts: dict = {}
    out: dict = {}
    with _scope(device, counts=counts):
        yield out
    for name, by_index in counts.items():
        out[name] = [float(v) for _, v in sorted(by_index.items())]


def count(name: str, index: int, value, state=None) -> None:
    """Set counter ``name`` at ``index`` (a layer) to ``value``, a number
    or a device tensor, in every enclosing :func:`counting` scope; nothing
    outside one. Setting, not adding: a checkpoint's recomputation counts
    the same layer again with the same value. ``state``: a scope taken by
    :func:`capture`, for code that runs outside the context (autograd's
    thread)."""
    state = _ACTIVE.get() if state is None else state
    if state is None:
        return
    for d in state.counts:
        d.setdefault(name, {})[index] = value


def capture():
    """The active scope, or ``None``: hand it to :func:`span`,
    :func:`traced` and :func:`count` in code that may run where the
    context is not set (a checkpoint's recomputation and the backward run
    on autograd's device thread)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def span(name: str, *, device: bool = False, id: int | None = None,
         state=None):
    """Time the enclosed step under ``name`` when a scope is active; do
    nothing otherwise. ``device``: the step's work runs on the device;
    ``id``: the round or step a root span opens; ``state``: a scope taken
    by :func:`capture` (default: the active one)."""
    state = _ACTIVE.get() if state is None else state
    if state is None:
        yield
        return
    sid = state.id if id is None else id
    rec = idx = None
    if state.rec is not None:
        idx = len(state.rec.spans)
        rec = Span(name, state.parent, sid, 0, 0)
        state.rec.spans.append(rec)
    start = None
    if device and state.cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter_ns()
    token = _ACTIVE.set(dataclasses.replace(state, parent=idx, id=sid))
    try:
        yield
    finally:
        _ACTIVE.reset(token)
        t1 = time.perf_counter_ns()
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            state.root.pending.append((name, start, end, state.sums, rec))
        else:
            sec = (t1 - t0) * 1e-9
            for d in state.sums:
                d[name] = d.get(name, 0.0) + sec
        if rec is not None:
            rec.t0_ns, rec.t1_ns = state.rec.epoch(t0), state.rec.epoch(t1)


class _BackwardSpan:
    """One device span of a block's backward, opened by its exit marker's
    backward and closed by its entry marker's."""

    def __init__(self, name: str, state: _State):
        self.name, self.state = name, state
        self.start = self.rec = None
        self.t0 = 0

    def open(self) -> None:
        st = self.state
        if st.rec is not None:
            self.rec = Span(self.name, st.parent, st.id, 0, 0)
            st.rec.spans.append(self.rec)
        if st.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        st = self.state
        t1 = time.perf_counter_ns()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            st.root.pending.append((self.name, self.start, end, st.sums,
                                    self.rec))
        else:
            for d in st.sums:
                d[self.name] = d.get(self.name, 0.0) + (t1 - self.t0) * 1e-9
        if self.rec is not None:
            self.rec.t0_ns, self.rec.t1_ns = (st.rec.epoch(self.t0),
                                              st.rec.epoch(t1))


class _Enter(torch.autograd.Function):
    """Identity at a block's entry; its backward, the block's last, closes
    the block's backward span."""

    @staticmethod
    def forward(ctx, x, bw):
        ctx.bw = bw
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.bw.close()
        return grad, None


class _Exit(torch.autograd.Function):
    """Identity on a block's outputs; its backward, the block's first,
    opens the block's backward span. It saves its inputs, so that under a
    checkpoint their unpacking runs the recomputation before the span
    opens."""

    @staticmethod
    def forward(ctx, bw, *xs):
        ctx.bw = bw
        ctx.save_for_backward(*xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # the recomputation, if any, runs here
        ctx.bw.open()
        return (None,) + grads


def traced(name: str, fn, x: torch.Tensor, *args, state=None):
    """``fn(x, *args)`` (a tensor or a tuple of tensors) timed as the
    device span ``name``: its forward (and a checkpoint's recomputation of
    it) by a :func:`span`, and, when gradients flow, its backward by a
    pair of identity markers around it, whose backward functions record
    the pair on autograd's thread with the captured ``state``. So the
    span's sum is forward + recomputation + backward. With no scope
    (``state`` ``None``) it is ``fn(x, *args)`` and nothing more."""
    if state is None:
        return fn(x, *args)
    grads = torch.is_grad_enabled() and x.requires_grad
    bw = _BackwardSpan(name, state)
    if grads:
        x = _Enter.apply(x, bw)
    with span(name, device=True, state=state):
        out = fn(x, *args)
    if not grads:
        return out
    if isinstance(out, tuple):
        return _Exit.apply(bw, *out)
    return _Exit.apply(bw, out)[0]
