from maxk_gnn.ops.spmm_xla import spmm_segsum, spmm_tiles_xla
from maxk_gnn.ops.spgemm import maxk_spgemm, spmm
from maxk_gnn.ops.dispatch import KernelMode, resolve_mode

__all__ = [
    "spmm_segsum",
    "spmm_tiles_xla",
    "maxk_spgemm",
    "spmm",
    "KernelMode",
    "resolve_mode",
]
