"""The dense Schur step's yardstick: the least bytes and operations of one
assembly of S by camera pairs, counted from a configuration's shapes, and
its least time on an H100 (the peaks of `perfbench/yardstick.py`).

The configuration's rows are spread as `perfbench/gen.py` spreads them:
``k = nobs // npnts`` rows a point, ``k + 1`` for ``nobs mod npnts``
points. Each point of ``n`` rows has ``n (n + 1) / 2`` pairs of rows
``(k, l)``, ``k <= l`` (15,102,831 at Venice-1778). One assembly reads W's
true rows at their storage width, the inverse point blocks and the plan
(two 4-byte row ids a pair, a 12-byte chunk a block of S's lower
triangle) once, and writes S, (9 ncams)^2 float32, once; it computes
``Y = W Hpp_inv`` once a row (162 operations: 9x3 times 3x3, an FMA two)
and ``Y_i W_j'`` once a pair (486: 9x3 times 3x9). Scratch and re-reads
are not counted.
"""

from __future__ import annotations

from perfbench.yardstick import PEAK_F32_FLOPS_S, PEAK_HBM_BYTES_S

# The kernels of one assembly (`csrc/dense_pairs.cu`): their function
# names start so.
PREFIX = "ba_pair_"
FLOPS_PER_ROW = 162
FLOPS_PER_PAIR = 486


def pairs(cfg: dict) -> int:
    """The camera pairs of a configuration's rows."""
    npt, nobs = int(cfg["npnts"]), int(cfg["nobs"])
    k, extra = divmod(nobs, npt)
    return (npt - extra) * k * (k + 1) // 2 + extra * (k + 1) * (k + 2) // 2


def assembly_bytes(cfg: dict, w_itemsize: int = 4) -> int:
    nc, npt, nobs = int(cfg["ncams"]), int(cfg["npnts"]), int(cfg["nobs"])
    blocks = nc * (nc + 1) // 2
    return (27 * nobs * w_itemsize + 36 * npt + 8 * pairs(cfg) + 12 * blocks
            + 4 * (9 * nc) ** 2)


def assembly_flops(cfg: dict) -> int:
    return FLOPS_PER_ROW * int(cfg["nobs"]) + FLOPS_PER_PAIR * pairs(cfg)


def assembly_least_s(cfg: dict, w_itemsize: int = 4) -> float:
    """One assembly's least seconds on an H100: its bytes over the HBM
    rate or its operations over the float32 rate, the larger."""
    return max(assembly_bytes(cfg, w_itemsize) / PEAK_HBM_BYTES_S,
               assembly_flops(cfg) / PEAK_F32_FLOPS_S)
