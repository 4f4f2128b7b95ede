"""Central registry of reserved ``fold_in`` key lanes (port copy).

A copy of ``repro.core.keylanes`` with the same lanes and the same integer
values, so the port folds every auxiliary draw onto the same key lanes as
the reference: the uplink folds the client index onto the round key, the
downlink broadcast folds ``DOWNLINK_KEY_LANE + i``, the event layer folds
``COMPUTE_KEY_LANE + i`` / ``EVENT_KEY_LANE + i``, and the sparse-framing
legs fold ``HEADER_KEY_LANE`` / ``SELECT_KEY_LANE`` onto the *client* key.
``fold_in`` here is :func:`repro_torch.core.prng.fold_in`.

:func:`reserve` claims an explicit ``[base, base + span)`` range inside a
named key *space* and raises at import time if two reservations overlap.
Two spaces exist because lanes are folded onto two different keys:

* ``"round"`` — lanes folded onto a **round/base key** (uplink client
  index, downlink broadcast, event-layer compute/churn/gap draws).
* ``"client"`` — lanes folded onto an already-derived **client key**
  (chunk indices, the sparse index header, rand-k selection).

A :class:`Lane` is an ``int`` subclass, so arithmetic like
``COMPUTE_KEY_LANE + i`` and ``fold_in(key, LANE)`` behave as plain
integers; the attached ``span`` powers the runtime guards
(:func:`check_cohort`, :func:`check_range`).
"""

from __future__ import annotations

__all__ = [
    "Lane",
    "Registry",
    "REGISTRY",
    "reserve",
    "registry",
    "lane_table",
    "check_cohort",
    "check_range",
    "UPLINK_KEY_LANE",
    "DOWNLINK_KEY_LANE",
    "COMPUTE_KEY_LANE",
    "EVENT_KEY_LANE",
    "EVENT_GAP_KEY_LANE",
    "OBS_KEY_LANE",
    "CHUNK_KEY_LANE",
    "HEADER_KEY_LANE",
    "SELECT_KEY_LANE",
]


class Lane(int):
    """A reserved fold_in lane: an ``int`` base with range metadata.

    Being an ``int`` subclass keeps every historical use site bit-identical
    (``fold_in(key, LANE)``, ``LANE + i``, dataclass defaults, jnp
    conversion); ``name``/``span``/``space`` carry the reservation so
    guards and the static checker can validate client-indexed uses.
    """

    name: str
    span: int
    space: str

    def __new__(cls, name: str, base: int, span: int, space: str) -> "Lane":
        """Build the lane; ``base`` is the integer value of the object."""
        if span < 1:
            raise ValueError(f"lane {name!r}: span must be >= 1, got {span}")
        if base < 0:
            raise ValueError(f"lane {name!r}: base must be >= 0, got {base}")
        self = super().__new__(cls, base)
        self.name = name
        self.span = span
        self.space = space
        return self

    @property
    def base(self) -> int:
        """The first index of the reserved range (== ``int(self)``)."""
        return int(self)

    @property
    def end(self) -> int:
        """One past the last reserved index (``base + span``)."""
        return int(self) + self.span

    def __repr__(self) -> str:
        """``Lane(name, base=…, span=…, space=…)`` — debugging aid."""
        return (f"Lane({self.name!r}, base={int(self)}, "
                f"span={self.span}, space={self.space!r})")


class Registry:
    """Overlap-rejecting collection of :class:`Lane` reservations.

    The module-level :data:`REGISTRY` instance holds the repo's canonical
    table; tests construct private instances to exercise the overlap
    rejection without disturbing it.
    """

    def __init__(self) -> None:
        """Start empty; lanes arrive via :meth:`reserve`."""
        self._lanes: dict[str, Lane] = {}

    def reserve(self, name: str, *, base: int, span: int,
                space: str = "round", owner: str = "") -> Lane:
        """Claim ``[base, base + span)`` in ``space``; raise on any overlap.

        ``owner`` names the module that historically declared (and still
        re-exports) the lane — documentation only, surfaced by
        :meth:`table`. Returns the :class:`Lane` (an ``int`` equal to
        ``base``).
        """
        lane = Lane(name, base, span, space)
        lane.owner = owner
        if name in self._lanes:
            raise ValueError(f"key lane {name!r} already reserved")
        for other in self._lanes.values():
            if other.space != space:
                continue
            if lane.base < other.end and other.base < lane.end:
                raise ValueError(
                    f"key lane {name!r} [{lane.base}, {lane.end}) overlaps "
                    f"{other.name!r} [{other.base}, {other.end}) in the "
                    f"{space!r} key space")
        self._lanes[name] = lane
        return lane

    def lanes(self) -> tuple[Lane, ...]:
        """All reservations, sorted by ``(space, base)``."""
        return tuple(sorted(self._lanes.values(),
                            key=lambda l: (l.space, l.base)))

    def table(self) -> list[dict]:
        """The lane table as plain dicts (docs / ``tools.lint`` output)."""
        return [{"name": l.name, "base": l.base, "span": l.span,
                 "space": l.space, "owner": getattr(l, "owner", "")}
                for l in self.lanes()]


REGISTRY = Registry()


def reserve(name: str, *, base: int, span: int, space: str = "round",
            owner: str = "") -> Lane:
    """Reserve a lane in the canonical :data:`REGISTRY` (see that class)."""
    return REGISTRY.reserve(name, base=base, span=span, space=space,
                            owner=owner)


def registry() -> tuple[Lane, ...]:
    """The canonical reservations, sorted by ``(space, base)``."""
    return REGISTRY.lanes()


def lane_table() -> list[dict]:
    """The canonical lane table as plain dicts."""
    return REGISTRY.table()


def check_cohort(lane: Lane, num_clients: int) -> None:
    """Validate a client-indexed use ``lane + i`` for ``i < num_clients``.

    Mirrors the broadcast leg's historical guard: ``num_clients`` must be
    in ``[1, lane.span]`` or the per-client draws would walk out of the
    reserved range into the next lane, silently correlating two error
    processes. Raises ``ValueError`` (message mentions ``num_clients``,
    which callers' tests match on).
    """
    if not 0 < num_clients <= lane.span:
        raise ValueError(
            f"num_clients must be in [1, {lane.span}] (the {lane.name!r} "
            f"key lane width); got {num_clients}")


def check_range(offset, count: int, space: str = "round") -> None:
    """Validate that ``[offset, offset + count)`` sits inside one lane.

    The guard for generic schedules like ``transport.client_keys`` where
    the caller passes a lane base as ``offset``: the whole folded range
    must fall within a single reservation of ``space``. ``offset`` may be
    a traced value (sharded dispatch passes per-shard offsets); validation
    is skipped when it is not a concrete Python int.
    """
    if not isinstance(offset, int):  # traced / array offsets: runtime-only
        return
    if count <= 0:
        return
    for lane in REGISTRY.lanes():
        if lane.space != space:
            continue
        if lane.base <= offset and offset + count <= lane.end:
            return
    raise ValueError(
        f"fold_in range [{offset}, {offset + count}) does not fit any "
        f"reserved {space!r} key lane; register it in "
        f"repro_torch.core.keylanes or shrink the cohort")


# --------------------------------------------------------------------------
# The canonical table. Values are pinned by the golden bit-identity suites:
# do not renumber — reserve new, disjoint ranges instead. ``tools/lint``
# parses these declarations statically (keep them literal ``reserve()``
# calls with int-expression base/span).
# --------------------------------------------------------------------------

# round space: lanes folded onto a round/base key ---------------------------
# uplink client i draws fold_in(round_key, i)
UPLINK_KEY_LANE = reserve(
    "uplink", base=0, span=1 << 20, owner="repro.core.transport")
# downlink-broadcast client i draws fold_in(round_key, DOWNLINK + i)
DOWNLINK_KEY_LANE = reserve(
    "downlink", base=1 << 20, span=1 << 20, owner="repro.core.transport")
# async event layer: per-(wave, client) compute-time draw
COMPUTE_KEY_LANE = reserve(
    "compute", base=1 << 22, span=1 << 20, owner="repro.link.dynamics")
# async event layer: per-(attempt, client) churn uniform
EVENT_KEY_LANE = reserve(
    "event-churn", base=3 << 21, span=1 << 20, owner="repro.link.dynamics")
# async event layer: post-upload idle gap — historically written as
# EVENT_KEY_LANE + (1 << 20) + i; same integers, now a first-class lane
EVENT_GAP_KEY_LANE = reserve(
    "event-gap", base=(3 << 21) + (1 << 20), span=1 << 20,
    owner="repro.link.dynamics")
# observability reservoir exemplars: per-client tag fold_in(round_key,
# OBS + i). Disjoint from every training lane, so sketches-on stays
# bit-identical to sketches-off on model weights.
OBS_KEY_LANE = reserve(
    "obs-reservoir", base=1 << 23, span=1 << 20, owner="repro.obs.sketch")

# client space: lanes folded onto an already-derived client key -------------
# chunked uncoded transport folds the chunk index onto the client key
CHUNK_KEY_LANE = reserve(
    "chunk", base=0, span=1 << 21, space="client",
    owner="repro.core.transport")
# sparse index header channel realization
HEADER_KEY_LANE = reserve(
    "header", base=1 << 21, span=1, space="client",
    owner="repro.compress.framing")
# rand-k selection draw
SELECT_KEY_LANE = reserve(
    "select", base=(1 << 21) + 1, span=1, space="client",
    owner="repro.compress.sparsify")
