"""The work a kernel launch needs, counted from its shapes, and the
published peaks of the card.

Operation counts follow chip_smoke.py (commit 7ecd7fc: dp_cells, k3_work
and the per-cell and per-site constants counted from the recurrences).
Bytes are what the algorithm needs, each input read once and each output
written once, whatever padding the program's tensors carry: for K1 the
profile's cost tables, the reads' bases, the band of each read and the
traced path out; for K3 the three messages and the mask at each live
lane's masked sites, the lanes' scalars and their outputs.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

K1_OPS_PER_CELL = 40
CONV_OPS = 40
DOT_OPS = 14
FP_STEP_OPS = 6


def dp_cells(meta, n_rows, K, n_regions, max_regions, region_width) -> int:
    """DP cells the banded regions of one batch allow (rows up to each
    read's length): the work the data needs.  meta [B, 8 + max_regions *
    region_width] int, the launch's band table."""
    meta = np.asarray(meta, np.int64)
    B = meta.shape[0]
    reg = meta[:, 8:8 + max_regions * region_width] \
        .reshape(B, max_regions, region_width)[:, :n_regions, :, None]
    j_lo, j_hi, i_lo, i_hi, _, diag, lo_d, hi_d = \
        (reg[:, :, c] for c in range(region_width))
    i = np.arange(1, n_rows + 1)[None, None, :]
    ci = i - i_lo
    lo = np.where(diag != 0, np.maximum(np.maximum(j_lo, 1),
                                        j_lo + ci - hi_d), np.maximum(j_lo, 1))
    hi = np.where(diag != 0, np.minimum(np.minimum(j_hi, K),
                                        j_lo + ci - lo_d), np.minimum(j_hi, K))
    w = np.where((i >= i_lo) & (i <= i_hi), np.maximum(hi - lo + 1, 0), 0)
    live = i[0] <= meta[:, 0:1]
    return int((w.sum(1) * live).sum())


def k1_work(meta, n_rows, K, n_regions, max_regions, region_width):
    """(bytes, operations) of one K1 launch."""
    meta = np.asarray(meta, np.int64)
    B = meta.shape[0]
    lengths = np.minimum(meta[:, 0], n_rows)
    tables = (K + 1) * (9 + 2 * 4) * 4                 # f32 costs
    bases = int(lengths.sum())                         # a byte a base
    bands = B * n_regions * region_width * 4
    path = int(lengths.sum()) * 2 + B * 5 * 4          # states and ends
    ops = K1_OPS_PER_CELL * dp_cells(meta, n_rows, K, n_regions,
                                     max_regions, region_width)
    return tables + bases + bands + path, float(ops)


def k3_work(sites, live, n_rates, outer, inner):
    """(bytes, operations) of one K3 launch.  sites [M] masked sites of
    each lane, live [M], outer / inner [M] the trip counts the lanes
    took; per live lane and masked site two branch set-ups an outer
    trip, a fixed-point step an inner trip and the root loglik."""
    lv = np.asarray(live).astype(bool)
    s = np.asarray(sites, np.float64)[lv]
    o = np.asarray(outer, np.float64)[lv]
    i = np.asarray(inner, np.float64)[lv]
    M = len(lv)
    NR = n_rates
    mix = 4 * (3 * NR + 3) if NR > 1 else 0
    setup = NR * 2 * CONV_OPS + mix + 3 * DOT_OPS + 8
    final = NR * 3 * CONV_OPS + mix + DOT_OPS
    ops = float((s * (o * 2 * setup + i * FP_STEP_OPS + final)).sum())
    n_bytes = float(s.sum()) * (3 * 4 * 4 + 4) + M * (3 * 4) + 64 * 4 \
        + M * 6 * 4
    return n_bytes, ops


def roofline_pct(n_bytes: float, n_ops: float, seconds: float):
    """(share of the roofline in %, the bound's name): the least time the
    card could take over the time the kernel took."""
    tb = n_bytes / PEAK_BYTES_S
    to = n_ops / PEAK_F32_OPS_S
    least, name = (tb, "bytes") if tb >= to else (to, "operations")
    return 100.0 * least / seconds, name
