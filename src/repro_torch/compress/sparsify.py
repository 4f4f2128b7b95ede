"""Gradient sparsification settings (port, part).

Counterpart of ``repro.compress.sparsify`` for :class:`CompressionConfig`
and its validation only: the ``iot-lowrate`` scenario preset carries one.
The selection functions (top-k with the reference's lower-index
tie-break, rand-k, threshold), the error-feedback residuals and the
sparse wire format are ROADMAP Queue 1, item 6; the engine refuses a
compressed run until then.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import keylanes

__all__ = ["SELECT_KEY_LANE", "CompressionConfig"]

SELECT_KEY_LANE = keylanes.SELECT_KEY_LANE


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How a client compresses its uplink payload before the sparse wire.

    ``method`` is ``"topk"``, ``"randk"`` or ``"threshold"``; ``k`` (or
    ``max(1, round(ratio * dim))``) coordinates go out per client per
    round; ``threshold`` is the magnitude floor of ``"threshold"``;
    ``error_feedback`` keeps the untransmitted remainder; ``header`` is how
    the index header rides the wire (``"gray"``, ``"ecrt"`` or
    ``"perfect"``), priced with ``header_ecrt_expected_tx`` or the real
    chain (``header_simulate_fec``).
    """

    method: str = "topk"  # topk | randk | threshold
    ratio: float = 0.02
    k: int | None = None
    threshold: float = 0.0
    error_feedback: bool = True
    header: str = "gray"  # gray | ecrt | perfect
    header_ecrt_expected_tx: float = 1.0
    header_simulate_fec: bool = False

    def __post_init__(self):
        if self.method not in ("topk", "randk", "threshold"):
            raise ValueError(
                f"unknown compression method {self.method!r}; "
                "use topk|randk|threshold")
        if self.header not in ("gray", "ecrt", "perfect"):
            raise ValueError(
                f"unknown header protection {self.header!r}; "
                "use gray|ecrt|perfect")
        if self.k is None and not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {self.ratio}")
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
