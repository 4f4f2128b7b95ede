"""ECRT baseline: rate-1/2 QC-LDPC FEC + retransmission (port; paper Sec. V).

Counterpart of ``repro.core.ecrt``: the same 802.11n-structured code
(n = 648, R = 1/2, Z = 27; base matrix of 12 x 24 circulants with a
dual-diagonal parity part), built by the same numpy code from the same
seed, so ``H`` and ``P`` are the reference's bit for bit, and the same
normalized min-sum decoder. The retransmission loop lives in
``transport.py``.

GF(2) products (``encode``, ``syndrome_ok``) run as float32 matmuls and
then ``% 2``: CUDA has no integer matmul, and every partial sum is an
integer below 2**24, so float32 is exact in any summation order (on the
card too with TF32, which holds 0 and 1 exactly and accumulates in
float32).

The decoder keeps one message per edge of the Tanner graph (1,593 edges)
where the reference keeps a dense ``(m, n)`` = 324 x 648 edge space with
masked non-edges. Every check-node message is computed by the same exact
operations (masked min, second min, sign product, ``alpha * sign * min``)
and is the reference's value; a variable node adds its edges' messages in
row order, one add at a time, where the reference reduces a dense column
of mostly zeros in XLA's order. So posteriors agree to float32 rounding
of those 2-4 term sums, and a hard bit can differ only where its posterior
lies within that rounding of 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["LdpcCode", "make_code", "encode", "decode", "syndrome_ok"]

N_DEFAULT = 648
Z_DEFAULT = 27


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """Immutable code description (hashable; arrays exposed via properties)."""

    n: int = N_DEFAULT
    z: int = Z_DEFAULT
    seed: int = 0
    iters: int = 30
    alpha: float = 0.8  # min-sum normalization factor

    @property
    def k(self) -> int:
        """Information bits per codeword (rate-1/2: ``n // 2``)."""
        return self.n // 2

    @functools.cached_property
    def _matrices(self):
        return _build_matrices(self.n, self.z, self.seed)

    @property
    def H(self) -> np.ndarray:
        """``(n-k, n)`` uint8 parity-check matrix."""
        return self._matrices[0]

    @property
    def P(self) -> np.ndarray:
        """``(n-k, k)`` uint8 generator part: ``parity = P @ m (mod 2)``."""
        return self._matrices[1]


def _circulant(z: int, shift: int) -> np.ndarray:
    return np.roll(np.eye(z, dtype=np.uint8), shift, axis=1)


def _build_matrices(n: int, z: int, seed: int):
    """The reference's construction, draw for draw (``numpy`` generator)."""
    nb = n // z  # block columns (24)
    mb = nb // 2  # block rows (12)
    kb = nb - mb
    rng = np.random.default_rng(seed)
    # Information part A: column weight 3 per block-column.
    base = -np.ones((mb, nb), dtype=np.int64)  # -1 = zero block
    for c in range(kb):
        rows = rng.choice(mb, size=3, replace=False)
        for r in rows:
            base[r, c] = rng.integers(0, z)
    # Dual-diagonal parity part T (shift-0 identities).
    for r in range(mb):
        base[r, kb + r] = 0
        if r > 0:
            base[r, kb + r - 1] = 0
    H = np.zeros((mb * z, nb * z), dtype=np.uint8)
    for r in range(mb):
        for c in range(nb):
            if base[r, c] >= 0:
                H[r * z:(r + 1) * z, c * z:(c + 1) * z] = _circulant(
                    z, base[r, c])
    A = H[:, :kb * z]
    # T is lower block-bidiagonal with identity blocks: solve T x = e_j by
    # forward substitution, x_0 = b_0, x_r = b_r + x_{r-1}.
    m = mb * z
    Tinv = np.zeros((m, m), dtype=np.uint8)
    for j in range(m):
        b = np.zeros(m, dtype=np.uint8)
        b[j] = 1
        x = np.zeros(m, dtype=np.uint8)
        for r in range(mb):
            blk = b[r * z:(r + 1) * z].copy()
            if r > 0:
                blk ^= x[(r - 1) * z:r * z]
            x[r * z:(r + 1) * z] = blk
        Tinv[:, j] = x
    P = (Tinv @ A) % 2
    # Sanity: H @ [m ; P m] = A m + T (Tinv A m) = 0.
    mtest = rng.integers(0, 2, size=(kb * z,)).astype(np.uint8)
    cw = np.concatenate([mtest, (P @ mtest) % 2])
    if ((H @ cw) % 2).any():
        raise RuntimeError("LDPC construction failed: H c != 0")
    return H.astype(np.uint8), P.astype(np.uint8)


def make_code(**kw) -> LdpcCode:
    """Build an :class:`LdpcCode` (convenience constructor; same kwargs)."""
    return LdpcCode(**kw)


@functools.lru_cache(maxsize=8)
def _tensors(code: LdpcCode, device: str) -> dict:
    """The code's matrices and Tanner-graph layout on ``device``.

    ``row_cols`` ``(m, dmax)``: the columns of each check's edges, in column
    order, padded (``row_valid`` False). ``col_slots`` ``(n, cmax)``: for
    each variable, the flat ``(m * dmax)`` slots of its edges in row
    order, padded with the index ``m * dmax`` of an appended zero.
    """
    H = code.H
    m, n = H.shape
    rows, cols = np.nonzero(H)  # row-major: by row, then column
    deg = np.bincount(rows, minlength=m)
    dmax = int(deg.max())
    pos = np.arange(rows.size) - np.repeat(np.cumsum(deg) - deg, deg)
    row_cols = np.zeros((m, dmax), np.int64)
    row_cols[rows, pos] = cols
    row_valid = np.zeros((m, dmax), bool)
    row_valid[rows, pos] = True
    slot = rows * dmax + pos
    by_col = np.lexsort((rows, cols))  # by column, then row
    cdeg = np.bincount(cols, minlength=n)
    cmax = int(cdeg.max())
    cpos = np.arange(rows.size) - np.repeat(np.cumsum(cdeg) - cdeg, cdeg)
    col_slots = np.full((n, cmax), m * dmax, np.int64)
    col_slots[cols[by_col], cpos] = slot[by_col]
    dev = torch.device(device)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return {
        "H_T": t(H.T, torch.float32),
        "P_T": t(code.P.T, torch.float32),
        "row_cols": t(row_cols, torch.int64),
        "row_valid": t(row_valid, torch.bool),
        "col_slots": t(col_slots, torch.int64),
    }


def _gf2(bits: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """``bits @ mat_t (mod 2)`` as int64, through an exact float32 matmul."""
    return torch.remainder(bits.to(torch.float32) @ mat_t, 2).to(torch.int64)


def encode(msg_bits: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """Systematic encode. ``msg_bits``: ``(..., k)`` in {0,1} -> ``(..., n)``
    int64."""
    msg = msg_bits.to(torch.int64)
    parity = _gf2(msg, _tensors(code, str(msg.device))["P_T"])
    return torch.cat([msg, parity], dim=-1)


def syndrome_ok(hard_bits: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """True where ``H c = 0`` (per codeword). ``hard_bits``: ``(..., n)``."""
    syn = _gf2(hard_bits, _tensors(code, str(hard_bits.device))["H_T"])
    return (syn == 0).all(dim=-1)


def _minsum_posterior(llr: torch.Tensor, code: LdpcCode) -> torch.Tensor:
    """Posterior LLRs ``(..., n)`` after ``code.iters`` normalized min-sum
    iterations on channel LLRs ``(..., n)`` (positive = bit 0 likelier)."""
    g = _tensors(code, str(llr.device))
    row_cols, valid, col_slots = g["row_cols"], g["row_valid"], g["col_slots"]
    llr = llr.to(torch.float32)
    v2c = llr[..., row_cols]  # (..., m, dmax) variable -> check messages
    zero = torch.zeros(llr.shape[:-1] + (1,), device=llr.device)
    total = llr
    for _ in range(code.iters):
        # Check node: sign product and the least magnitude over the row,
        # each edge taking the least of the others.
        mag = torch.where(valid, v2c.abs(), torch.inf)
        neg = v2c < 0
        row_sign = 1.0 - 2.0 * ((neg & valid).sum(-1, keepdim=True) % 2)
        min1 = mag.amin(-1, keepdim=True)
        first = mag.argmin(-1, keepdim=True)
        min2 = mag.scatter(-1, first, torch.inf).amin(-1, keepdim=True)
        use_min = torch.where(mag == min1, min2, min1)
        self_sign = torch.where(neg, -1.0, 1.0)
        c2v = (code.alpha * row_sign * self_sign
               * torch.where(valid, use_min, 0.0))
        c2v = torch.where(torch.isfinite(c2v), c2v, 0.0)
        # Variable node: the channel LLR plus the column's messages, added
        # in row order.
        flat = torch.cat([c2v.flatten(-2), zero], dim=-1)
        col = flat[..., col_slots]  # (..., n, cmax)
        acc = col[..., 0]
        for j in range(1, col.shape[-1]):
            acc = acc + col[..., j]
        total = llr + acc
        v2c = total[..., row_cols] - c2v
    return total


def decode(llr: torch.Tensor, code: LdpcCode):
    """Normalized min-sum decode.

    ``llr``: ``(..., n)`` channel LLRs (positive = bit 0 likelier).
    Returns ``(hard_bits (..., n) int64, ok (...,) bool)``.
    """
    hard = (_minsum_posterior(llr, code) < 0).to(torch.int64)
    return hard, syndrome_ok(hard, code)
