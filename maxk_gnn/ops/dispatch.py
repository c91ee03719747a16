"""Kernel implementation selection: the one dispatch rule.

Role of the reference's `--kernel_mode {auto,maxk,cusparse,dgl}` flag
(`utils/config.py:62-67`). An explicit mode is used as given. `auto` is
decided once per (device, graph) by `choose_mode`, from constants measured
on that device kind (`DEVICE_CONSTANTS`), before the graph is built: the
graph then carries exactly the schedule the rule chose, and `resolve_mode`
reads that choice back at trace time.

A device kind missing from the table is an error, not a default: measure
it (`python -m maxk_gnn.bench.kernel_choice`) and add a row, or pass an
explicit `--kernel_mode`.
"""

from __future__ import annotations

import dataclasses
import enum
import os

import jax


class KernelMode(str, enum.Enum):
    AUTO = "auto"
    HYBRID = "hybrid"  # degree-sorted symmetric-strip dense-matmul decomposition
    # hybrid with per-column int8-quantized features on the strip
    # matmuls. LOSSY (~0.5% feature quant error) — explicit opt-in only,
    # AUTO never selects it; requires an int8 strip; single-device (the
    # sharded path ignores it and stays exact)
    HYBRID_INT8 = "hybrid_int8"
    TILES_XLA = "tiles_xla"  # XLA over the tile schedule (one-shot)
    TILES_SCAN = "tiles_scan"  # XLA tile schedule, memory-bounded scan
    SEGSUM = "segsum"  # gather + segment_sum


@dataclasses.dataclass(frozen=True)
class DeviceConstants:
    """What the dispatch rule needs to know about one device kind.

    gather_s_per_edge: time per edge slot of the segsum SpMM over
        (V, 256) features — the cost every edge pays off the strip.
    matmul_flops: sustained bf16 rate of the strip's dense products.
    source: where the numbers come from.
    """

    gather_s_per_edge: float
    matmul_flops: float
    source: str


DEVICE_CONSTANTS = {
    # tests and CPU runs: no planning rates, so `auto` is always segsum
    "cpu": None,
    "NVIDIA H100 80GB HBM3": DeviceConstants(
        # reddit (V=232,965, 114.8M edge slots, D=256), one card at 700 W:
        # segsum SpMM of bf16 features 18.7 ms; bf16 16384^3 matmul
        # 757 TFLOP/s (`python -m maxk_gnn.bench.kernel_choice`). With
        # these rates `hybrid_profitable` rejects the strip on reddit, as
        # the measured MaxK-SAGE 256x4 step did: 144.2 ms with the strip
        # against 99.7 ms with segsum (PERF.md).
        gather_s_per_edge=1.63e-10,
        matmul_flops=7.57e14,
        source="kernel_choice on one H100 SXM 80GB at 700 W",
    ),
}


def device_constants(device=None) -> DeviceConstants | None:
    """The planning rates of `device`'s kind; None for the host CPU,
    where `auto` always runs segsum."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in DEVICE_CONSTANTS:
        raise ValueError(
            f"no dispatch constants for device kind {kind!r}: pass an "
            f"explicit --kernel_mode (segsum, tiles_scan or hybrid), or "
            f"measure this device with `python -m maxk_gnn.bench."
            f"kernel_choice` and add it to ops/dispatch.DEVICE_CONSTANTS"
        )
    return DEVICE_CONSTANTS[kind]


def memory_bytes(device=None) -> int:
    """Bytes one array program may use on `device`: the allocator's
    `bytes_limit` on an accelerator, physical memory on the host CPU."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def choose_mode(
    mode, csr, dim: int, compute_dtype=None, num_shards: int = 1, device=None
) -> KernelMode:
    """The dispatch rule: which aggregation kernel to build for this graph.

    Explicit modes pass through. `auto` builds the strip hybrid where the
    device has planning rates, the compute dtype is bf16 (the strip
    products take bf16 features), and `hybrid_profitable` says its dense
    products beat the gather every live edge otherwise pays, at the width
    and dtypes the builder will use; else segsum.
    """
    mode = KernelMode(mode)
    if mode != KernelMode.AUTO:
        return mode
    c = device_constants(device)
    if c is None or compute_dtype is None:
        return KernelMode.SEGSUM
    import numpy as np

    from maxk_gnn.sparse.hybrid import hybrid_profitable, strip_int8_exact

    e_live = int(np.asarray(csr.indptr[-1]))
    v = -(-csr.num_nodes // num_shards)  # rows of the strip per device
    if hybrid_profitable(
        v, e_live // num_shards, dim=dim,
        io_itemsize=2,
        strip_itemsize=1 if strip_int8_exact(csr) else 2,
        constants=c, memory=memory_bytes(device),
    ):
        return KernelMode.HYBRID
    return KernelMode.SEGSUM


def resolve_mode(
    mode: str | KernelMode, has_tiles: bool, has_hybrid: bool = False
) -> KernelMode:
    """Trace-time reading of a built graph: explicit modes as given;
    `auto` runs whatever schedule the graph carries."""
    mode = KernelMode(mode)
    if mode != KernelMode.AUTO:
        return mode
    if has_hybrid:
        return KernelMode.HYBRID
    if has_tiles:
        return KernelMode.TILES_SCAN
    return KernelMode.SEGSUM
