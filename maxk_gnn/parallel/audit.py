"""Compiled-HLO collective audit — makes the collective-traffic model
checkable.

`model_recv_bytes_fwd_bwd` is an analytic model of per-device collective
traffic of the sharded aggregation. This module closes the loop: it
parses the COMPILED HLO of a sharded program and returns the collective
operations XLA actually emitted, so a test can assert `hlo receive bytes
== model receive bytes` exactly
(tests/test_shard.py::test_collective_bytes_match_analytic). The virtual
CPU mesh compiles the same SPMD program as a real multi-GPU mesh —
collective op shapes are platform-independent — which is what makes this
audit meaningful without several cards.

No reference counterpart: the reference is single-GPU by design
(SURVEY §2.3); this subsystem belongs to the distribution capability this
framework adds.
"""

from __future__ import annotations

import re
from typing import List, Tuple

_ITEMSIZE = {
    "f64": 8, "s64": 8, "u64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# `%op.N = <result shapes> <collective-op>(...)`; the result section may
# be one shape (`f32[512,4]{1,0}`) or a tuple when XLA's combiner merged
# several operands (`(f32[512,4], s32[512,4])`). Accelerator compilation
# often splits a collective into `-start`/`-done` pairs (async); count the
# `-start` (it carries the result shape) and ignore the `-done`.
_OP_RE = re.compile(
    r"=\s+(?P<res>[^=]*?)\s+(?P<op>"
    + "|".join(_COLLECTIVES)
    + r")(?P<async>-start)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def hlo_collectives(compiled_text: str) -> List[Tuple[str, str, tuple, int]]:
    """All collective ops of a compiled HLO module.

    Returns one entry per result array: (op, dtype, shape, result_bytes).
    Use `compiled = jax.jit(f).lower(*args).compile(); compiled.as_text()`.
    """
    out = []
    for m in _OP_RE.finditer(compiled_text):
        op = m.group("op")
        shapes = [
            (dtype, dims)
            for dtype, dims in _SHAPE_RE.findall(m.group("res"))
            if dtype in _ITEMSIZE  # drop tokens / layout annotations
        ]
        if m.group("async") and op in ("all-gather", "collective-permute") \
                and len(shapes) >= 2:
            # async `-start` of these ops returns an (input, output, ...)
            # buffer tuple — only the OUTPUT is the collective's result;
            # counting the operand too would double the audited bytes
            shapes = shapes[1:2]
        for dtype, dims in shapes:
            shape = tuple(int(x) for x in dims.split(",") if x)
            n_elem = 1
            for s in shape:
                n_elem *= s
            out.append((op, dtype, shape, n_elem * _ITEMSIZE[dtype]))
    return out


def recv_bytes_per_device(collectives, n: int) -> float:
    """Per-device RECEIVE volume of the parsed collectives (ring model).

    all-gather:      result is the full gathered array; each device
                     receives the (n-1)/n of it that it didn't hold.
    reduce-scatter:  result is the local 1/n shard; each device receives
                     (n-1) shard-sized partial blocks.
    all-reduce:      ring = reduce-scatter + all-gather over the same
                     array: 2·(n-1)/n of the (full-size) result.
    all-to-all /     result-sized exchange, (n-1)/n of it remote.
    collective-permute: result-sized, fully remote — count 1×.
    """
    total = 0.0
    for op, _dtype, _shape, nbytes in collectives:
        if op == "all-gather":
            total += nbytes * (n - 1) / n
        elif op == "reduce-scatter":
            total += nbytes * (n - 1)
        elif op == "all-reduce":
            total += nbytes * 2 * (n - 1) / n
        elif op == "all-to-all":
            total += nbytes * (n - 1) / n
        elif op == "collective-permute":
            total += nbytes
    return total


def model_recv_bytes_fwd_bwd(
    arm: str,
    n: int,
    vp: int,
    d: int,
    k: int = 0,
    vals_itemsize: int = 4,
    sel_itemsize: int = 4,
    x_itemsize: int = 4,
    ct_itemsize: int = 4,
    s_cols: int = 0,
) -> float:
    """Analytic per-device receive bytes for ONE aggregation fwd+bwd.

    The HLO audit test asserts it equals what XLA compiles, shape for
    shape:

      maxk (tile/segsum path):
        fwd  all_gather of the compressed CBSR: Vp·k·(vals+sel bytes)
        bwd  psum_scatter of (Vp, D) cotangent partials
      relu (tile/segsum path):
        fwd  all_gather of dense rows: Vp·D·x bytes
        bwd  psum_scatter of (Vp, D) partials
      maxk_hybrid:
        fwd  CBSR all_gather + (S, D) f32 hub psum (all-reduce)
        bwd  cotangent all_gather (Vp, D) + (S, D) f32 hub psum
      relu_hybrid: same with a dense forward gather
    """
    r = (n - 1) / n
    hub = 2 * r * s_cols * d * 4  # one (S, D) f32 all-reduce, ring
    if arm == "maxk":
        return r * vp * k * (vals_itemsize + sel_itemsize) + r * vp * d * ct_itemsize
    if arm == "relu":
        return r * vp * d * (x_itemsize + ct_itemsize)
    if arm == "maxk_hybrid":
        return (
            r * vp * k * (vals_itemsize + sel_itemsize)
            + r * vp * d * ct_itemsize
            + 2 * hub
        )
    if arm == "relu_hybrid":
        return r * vp * d * (x_itemsize + ct_itemsize) + 2 * hub
    raise ValueError(f"unknown arm {arm!r}")
