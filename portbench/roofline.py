"""The least time the H100 could take for the work of each hand-written
kernel on the verification path, from the shapes of a chunk and the match
table's counts. Peaks and formulas are copies of the kernel table's
(`chip_smoke.py`, PR 7's figures), frozen here so that a change to the
program cannot move them.

A kernel's bound is the larger of its operations over the peak rate of
the route it takes and its bytes over HBM bandwidth, each input byte read
once and each output byte written once. Where the work depends on the
data, the valid (matched) points that these inputs have are counted.
"""

from __future__ import annotations

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W power limit)
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
PEAK_F32 = 67e12          # float32 operations/s outside the tensor cores
PEAK_INT8 = 1979e12       # int8 tensor-core operations/s
# integer pipes per SM and clock for compute capability 9.0: 32-bit add
# and bitwise 64, population count 16; 132 SMs at the 1.98 GHz boost clock
N_SM, CLOCK_HZ = 132, 1.98e9
INT_PER_CLK, POPC_PER_CLK = 64, 16
# float32 operations of one residual: rigid (R p + t, difference, squared
# norm, compare) and Sampson (E f1, two rows of E^T f2, numerator,
# denominator, division, compare)
OPS_RIGID, OPS_SAMPSON = 26, 40
# K6's float32 operations per (candidate, hypothesis) at 8 Gauss-Newton
# iterations: the 5 x 9 design's nullspace once, the polish once per
# start (counted from the plain version's elementwise arithmetic, PR 7)
FIVEPT_OPS_NULLSPACE = 1630
FIVEPT_OPS_PER_START = {8: 16639}


def f32_ms(n_bytes: float, n_ops: float) -> float:
    """A float32 kernel's bound: every multiply-add pair one FFMA."""
    return max(n_ops / PEAK_F32, n_bytes / PEAK_BYTES) * 1e3


def hamming_ms(pairs: float, n_bytes: float) -> float:
    """Hamming top-2 over `pairs` (query, target) pairs of 256-bit rows:
    the faster of packed words (8 XOR + 8 POPC + 8 ADD a pair on the
    integer pipes) and an int8 tensor-core product of the bits (2 x 256
    operations a pair), each no faster than its bytes."""
    words = 8 * pairs
    popc_ms = words / (POPC_PER_CLK * N_SM * CLOCK_HZ) * 1e3
    xor_add_ms = 2 * words / (INT_PER_CLK * N_SM * CLOCK_HZ) * 1e3
    tc_ms = 2 * 256 * pairs / PEAK_INT8 * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return min(max(popc_ms, xor_add_ms, bytes_ms), max(tc_ms, bytes_ms))


def pair_top2(C: int, Kq: int, Kt: int) -> float:
    """K1: descriptors in, (d1, d2, i1) out, the target mask in."""
    return hamming_ms(C * Kq * Kt, C * (Kq + Kt) * 32 + C * Kt
                      + 3 * C * Kq * 4)


def permute_cols(C: int, K: int, n_cols: int) -> float:
    """K5: (C, 3, K) float32 through (C, K) int32 indices that reach
    `n_cols` distinct (candidate, column) pairs."""
    return f32_ms(n_cols * 3 * 4 + C * K * 4 + C * 3 * K * 4, 0)


def sample_gather(C: int, H: int, k: int, n_cols: int) -> float:
    """K3: (C, 3, k H) float32 gathered through (C, H, k) indices that
    reach `n_cols` distinct columns."""
    return f32_ms(n_cols * 3 * 4 + C * H * k * 4 + C * 3 * k * H * 4, 0)


def sample_gather_perm(C: int, H: int, k: int) -> float:
    """K4: (C, 3 k, H) float32 out, (C, H, k) picks in. The columns and
    permutation entries the picks reach are left out: they depend on the
    draws (at most K a candidate: up to a third of this kernel's bytes at
    K = 704, H = 500, under 1 % of a chunk's bound). The bound is a lower
    one."""
    return f32_ms(C * H * k * 4 + C * 3 * k * H * 4, 0)


def fivept_models(C: int, H: int, S: int, gn_iters: int) -> float:
    """K6: raw models of every (candidate, hypothesis, start)."""
    if gn_iters not in FIVEPT_OPS_PER_START:
        raise ValueError(f"no operation count at gn_iters={gn_iters}")
    ops = C * H * (FIVEPT_OPS_NULLSPACE
                   + S * FIVEPT_OPS_PER_START[gn_iters])
    return f32_ms(2 * C * 15 * H * 4 + C * 9 * S * H * 4, ops)


def presel_counts(C: int, H: int, S: int, P: int, n_validp: int) -> float:
    """K7: Sampson counts of every (hypothesis, start) model on the first
    P valid points (`n_validp` of them over the chunk)."""
    return f32_ms(C * 9 * S * H * 4 + 2 * C * 3 * P * 4 + C * P
                  + C * H * S * 4, H * S * n_validp * OPS_SAMPSON)


def rigid_counts(C: int, K: int, H: int, n_valid: int) -> float:
    """K8: rigid inlier counts of H models over the valid points."""
    return f32_ms(C * H * 12 * 4 + 2 * n_valid * 3 * 4 + C * K + C * H * 4,
                  H * n_valid * OPS_RIGID)


def essential_counts(C: int, K: int, H: int, n_valid: int) -> float:
    """K9: Sampson inlier counts of H models over the valid points."""
    return f32_ms(C * H * 9 * 4 + 2 * n_valid * 3 * 4 + C * K + C * H * 4,
                  H * n_valid * OPS_SAMPSON)


# the 5-point gate's fixed settings (ransac_essential_5pt's defaults, as
# make_verifier calls it)
N_STARTS, GN_ITERS, PRESEL_PTS, PRESEL_MODELS = 8, 8, 64, 128


def chunk_launches(solver: str) -> dict:
    """Hand-written launches of one `verify_many` chunk, by kernel."""
    common = {"pair_top2": 1, "permute_cols": 2, "sample_gather_perm_t": 4,
              "rigid_counts": 1, "essential_counts": 1}
    if solver == "stewenius_5pt":
        return {**common, "sample_gather_t": 2, "fivept_models": 1,
                "presel_counts": 1}
    return common


def chunk_bounds(solver: str, C: int, K: int, H: int, n_valid: int,
                 n_validp: int, n_cols: int) -> dict:
    """Bound in ms of each hand-written kernel over one chunk, summed over
    its launches. n_valid: matched points of the chunk; n_validp: of those,
    the ones among each candidate's first PRESEL_PTS; n_cols: distinct
    (candidate, target column) pairs the match table reaches."""
    out = {"pair_top2": pair_top2(C, K, K),
           "permute_cols": 2 * permute_cols(C, K, n_cols),
           "rigid_counts": rigid_counts(C, K, H, n_valid)}
    if solver == "stewenius_5pt":
        P = PRESEL_PTS
        out["sample_gather_perm_t"] = (2 * sample_gather_perm(C, H, 5)
                                       + 2 * sample_gather_perm(C, H, 3))
        out["sample_gather_t"] = 2 * sample_gather(C, P, 1, C * min(P, K))
        out["fivept_models"] = fivept_models(C, H, N_STARTS, GN_ITERS)
        out["presel_counts"] = presel_counts(C, H, N_STARTS, P, n_validp)
        out["essential_counts"] = essential_counts(C, K, PRESEL_MODELS,
                                                   n_valid)
    else:
        out["sample_gather_perm_t"] = (2 * sample_gather_perm(C, H, 8)
                                       + 2 * sample_gather_perm(C, H, 3))
        out["essential_counts"] = essential_counts(C, K, H, n_valid)
    return out
