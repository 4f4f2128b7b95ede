"""Lossy gradient compression over the approximate wire (port).

Counterpart of ``repro.compress``: :mod:`repro_torch.compress.sparsify`
(top-k / rand-k / threshold selection with error-feedback residuals) and
:mod:`repro_torch.compress.framing` (the sparse wire: protected index
header + value payload). The FL engine threads a :class:`CompressionConfig`
through every round; ``compression=None`` leaves the dense engine as it
is.
"""

from repro_torch.compress.framing import (  # noqa: F401
    HEADER_KEY_LANE,
    index_bits,
    pack_index_bits,
    scatter_received,
    sparse_batch_with_keys,
    transmit_header,
    transmit_sparse,
    transmit_sparse_batch,
    transmit_sparse_batch_adaptive,
    unpack_index_bits,
)
from repro_torch.compress.sparsify import (  # noqa: F401
    SELECT_KEY_LANE,
    CompressionConfig,
    ef_select,
    ef_select_batch,
    resolve_k,
    scatter_dense,
    scatter_dense_batch,
    select,
    select_batch,
    select_randk,
    select_threshold,
    select_topk,
    selection_keys,
)

__all__ = [
    "CompressionConfig",
    "HEADER_KEY_LANE",
    "SELECT_KEY_LANE",
    "ef_select",
    "ef_select_batch",
    "index_bits",
    "pack_index_bits",
    "resolve_k",
    "scatter_dense",
    "scatter_dense_batch",
    "scatter_received",
    "select",
    "select_batch",
    "select_randk",
    "select_threshold",
    "select_topk",
    "selection_keys",
    "sparse_batch_with_keys",
    "transmit_header",
    "transmit_sparse",
    "transmit_sparse_batch",
    "transmit_sparse_batch_adaptive",
    "unpack_index_bits",
]
