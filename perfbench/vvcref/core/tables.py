"""H.266/VVC constant tables.

Sources: ITU-T H.266 spec tables; numeric data extracted by
tools/extract_spec_tables.py into core/data/*.json (transform matrices,
CABAC init values — the same spec constants the reference encoder embeds in
the reference's src/{transformer.rs:934,cabac_contexts.rs:245}).
Derived/procedural tables (diagonal scan, DCT-II subsampling) are generated
here per the spec definitions.
"""
import functools
import json
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load(name):
    with open(os.path.join(_DATA, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Intra prediction tables (spec 8.4.5.2; cf. reference common.rs:145-221,
# intra_predictor.rs:36-54)
# ---------------------------------------------------------------------------

# intraPredAngle for predModeIntra in [-14..80], indexed by mode+14 (Table 27).
INTRA_ANGLE_TABLE = np.array([
    512, 341, 256, 171, 128, 102, 86, 73, 64, 57, 51, 45, 39, 35, 0, 0,
    32, 29, 26, 23, 20, 18, 16, 14, 12, 10, 8, 6, 4, 3, 2, 1,
    0, -1, -2, -3, -4, -6, -8, -10, -12, -14, -16, -18, -20, -23, -26, -29,
    -32, -29, -26, -23, -20, -18, -16, -14, -12, -10, -8, -6, -4, -3, -2, -1,
    0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29,
    32, 35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512,
], dtype=np.int32)

# 4-tap intra interpolation filters (Table 28): fC (cubic) / fG (gaussian),
# 32 phases x 4 taps.
_FC_HALF = [
    (0, 64, 0, 0), (-1, 63, 2, 0), (-2, 62, 4, 0), (-2, 60, 7, -1),
    (-2, 58, 10, -2), (-3, 57, 12, -2), (-4, 56, 14, -2), (-4, 55, 15, -2),
    (-4, 54, 16, -2), (-5, 53, 18, -2), (-6, 52, 20, -2), (-6, 49, 24, -3),
    (-6, 46, 28, -4), (-5, 44, 29, -4), (-4, 42, 30, -4), (-4, 39, 33, -4),
    (-4, 36, 36, -4),
]
F_C = np.array(_FC_HALF + [t[::-1] for t in _FC_HALF[15:0:-1]], dtype=np.int32)
F_G = np.array([
    [16, 32, 16, 0], [16, 32, 16, 0], [15, 31, 17, 1], [15, 31, 17, 1],
    [14, 30, 18, 2], [14, 30, 18, 2], [13, 29, 19, 3], [13, 29, 19, 3],
    [12, 28, 20, 4], [12, 28, 20, 4], [11, 27, 21, 5], [11, 27, 21, 5],
    [10, 26, 22, 6], [10, 26, 22, 6], [9, 25, 23, 7], [9, 25, 23, 7],
    [8, 24, 24, 8], [8, 24, 24, 8], [7, 23, 25, 9], [7, 23, 25, 9],
    [6, 22, 26, 10], [6, 22, 26, 10], [5, 21, 27, 11], [5, 21, 27, 11],
    [4, 20, 28, 12], [4, 20, 28, 12], [3, 19, 29, 13], [3, 19, 29, 13],
    [2, 18, 30, 14], [2, 18, 30, 14], [1, 17, 31, 15], [1, 17, 31, 15],
], dtype=np.int32)

# PDPC distance weights, indexed by [n_scale][distance] (spec 8.4.5.2.15).
PDPC_WEIGHTS = np.zeros((3, 64), dtype=np.int32)
PDPC_WEIGHTS[0, :3] = [32, 8, 2]
PDPC_WEIGHTS[1, :6] = [32, 16, 8, 4, 2, 1]
PDPC_WEIGHTS[2, :12] = [32, 32, 16, 16, 8, 8, 4, 4, 2, 2, 1, 1]

# CCLM slope significand lookup (spec 8.4.5.2.14).
CCLM_DIV_SIG_TABLE = np.array(
    [0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0], dtype=np.int32)

# ---------------------------------------------------------------------------
# Scan order (spec 6.5.2 up-right diagonal scan)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def diag_scan(log2_h, log2_w):
    """Up-right diagonal scan order for a (1<<log2_h) x (1<<log2_w) block.

    Returns an (N, 2) int array of (x, y) positions in scan order
    (cf. reference ctu.rs:14-81 / spec 6.5.2).
    """
    h, w = 1 << log2_h, 1 << log2_w
    order = []
    for d in range(w + h - 1):
        # along a diagonal, scan from bottom-left to top-right (y descending)
        for y in range(min(d, h - 1), -1, -1):
            x = d - y
            if x < w:
                order.append((x, y))
    return np.array(order, dtype=np.int32)


# ---------------------------------------------------------------------------
# Transform matrices (spec 8.7.4.4; data extracted to transform_matrices.json)
# ---------------------------------------------------------------------------

_TM = _load("transform_matrices.json")


@functools.lru_cache(maxsize=None)
def dct2_matrix(n):
    """Forward DCT-II matrix of size n x n (n in {1,2,4,8,16,32,64}), int32.

    Row k of the n-point matrix = row k*(64/n) of the 64-point base matrix,
    first n columns (spec derivation; cf. transformer.rs:1195-1234).
    """
    half = np.array(_TM["dct2_base64_half"], dtype=np.int32)  # 64 x 32
    signs = 1 - 2 * (np.arange(64, dtype=np.int32) & 1)
    full = np.concatenate([half, half[:, ::-1] * signs[:, None]], axis=1)
    step = 64 // n
    return np.ascontiguousarray(full[::step, :n])


@functools.lru_cache(maxsize=None)
def dst7_matrix(n):
    """Forward DST-VII matrix (n in {4,8,16,32}); for n=32 only 16 rows exist
    (MTS zero-out keeps <=16 coefficients)."""
    return np.array(_TM[f"dst7_{n}"], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def dct8_matrix(n):
    """Forward DCT-VIII matrix (n in {4,8,16,32}); n=32 stores 16 rows."""
    return np.array(_TM[f"dct8_{n}"], dtype=np.int32)


def trans_matrix(tr_type, n):
    """Forward transform matrix for tr_type (0=DCT2, 1=DST7, 2=DCT8), size n.

    Shape (rows, n); rows < n only for the 32-point MTS matrices.
    """
    if tr_type == 0:
        return dct2_matrix(n)
    if tr_type == 1:
        return dst7_matrix(n)
    return dct8_matrix(n)


# ---------------------------------------------------------------------------
# Quantization (spec 8.7.3; cf. quantizer.rs:8)
# ---------------------------------------------------------------------------

LEVEL_SCALE = np.array([[40, 45, 51, 57, 64, 72],
                        [57, 64, 72, 80, 90, 102]], dtype=np.int32)

# Dependent-quantization state machine (spec Table 125):
# next_state = Q_STATE_TRANS[state][level & 1]
Q_STATE_TRANS = np.array([[0, 2], [2, 0], [1, 3], [3, 1]], dtype=np.int32)

# ---------------------------------------------------------------------------
# CABAC (spec 9.3; Table 51 data extracted to cabac_init.json)
# ---------------------------------------------------------------------------

_CAB = _load("cabac_init.json")

# Rice parameter from local sum of absolute levels (spec Table 126).
C_RICE_PARAMS = np.array(_CAB["c_rice_params"], dtype=np.int32)


class SE:
    """Syntax-element ids for CABAC context bookkeeping.

    Numbering matches the reference's CabacContext enum (cabac_contexts.rs:16)
    so the extracted Table-51 data indexes directly.
    """
    AlfSaoMergeLeftFlag = 7
    AlfSaoMergeUpFlag = 8
    AlfSaoTypeIdxLuma = 9
    AlfSaoTypeIdxChroma = 10
    SplitCuFlag = 16
    SplitQtFlag = 17
    MttSplitCuVerticalFlag = 18
    MttSplitCuBinaryFlag = 19
    NonInterFlag = 20
    CuSkipFlag = 21
    PredModeIbcFlag = 22
    PredModeFlag = 23
    PredModePltFlag = 24
    CuActEnabledFlag = 25
    IntraBdpcmLumaFlag = 26
    IntraBdpcmLumaDirFlag = 27
    IntraMipFlag = 28
    IntraLumaRefIdx = 31
    IntraSubpartitionsModeFlag = 32
    IntraSubpartitionsSplitFlag = 33
    IntraLumaMpmFlag = 34
    IntraLumaNotPlanarFlag = 35
    IntraLumaMpmIdx = 36
    IntraLumaMpmRemainder = 37
    IntraBdpcmChromaFlag = 38
    IntraBdpcmChromaDirFlag = 39
    CclmModeFlag = 40
    CclmModeIdx = 41
    IntraChromaPredMode = 42
    CuCodedFlag = 61
    LfnstIdx = 66
    MtsIdx = 67
    TuYCodedFlag = 87
    TuCbCodedFlag = 88
    TuCrCodedFlag = 89
    CuQpDeltaAbs = 90
    CuQpDeltaSignFlag = 91
    CuChromaQpOffsetFlag = 92
    TransformSkipFlag = 94
    TuJointCbcrResidualFlag = 95
    LastSigCoeffXPrefix = 96
    LastSigCoeffYPrefix = 97
    LastSigCoeffXSuffix = 98
    LastSigCoeffYSuffix = 99
    SbCodedFlag = 100
    SigCoeffFlag = 101
    ParLevelFlag = 102
    AbsLevelGtxFlag = 103
    AbsRemainder = 104
    DecAbsLevel = 105
    CoeffSignFlag = 106
    EndOfSliceOneBit = 107
    EndOfTileOneBit = 108
    EndOfSubsetOneBit = 109


def cabac_ctx_entry(se_id):
    """(init_values, shift_idx) arrays for syntax element `se_id`.

    Each is a (3, num_ctx) int array indexed by init type (0=I, 1=P, 2=B).
    """
    e = _CAB["ctx_table"][se_id]
    if e is None:
        raise KeyError(f"no context entry for syntax element {se_id}")
    return (np.array(e["init"], dtype=np.int32),
            np.array(e["shift"], dtype=np.int32))


@functools.lru_cache(maxsize=None)
def cabac_ctx_layout():
    """Flat context-table layout over all syntax elements that have contexts.

    Returns (offsets, init_values, shift_idx) where offsets maps se_id -> base
    index into the flat arrays; init_values/shift_idx have shape (3, total).
    """
    offsets = {}
    inits, shifts = [], []
    total = 0
    for se_id, e in enumerate(_CAB["ctx_table"]):
        if e is None:
            continue
        n = len(e["init"][0])
        offsets[se_id] = total
        total += n
        inits.append(np.array(e["init"], dtype=np.int32))
        shifts.append(np.array(e["shift"], dtype=np.int32))
    return (offsets,
            np.concatenate(inits, axis=1),
            np.concatenate(shifts, axis=1))


# ---------------------------------------------------------------------------
# LFNST matrices (spec 8.7.4.3) — loaded lazily; LFNST is disabled in the
# default tool set but the data ships for completeness.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def lfnst_matrix(n_tr_s, set_idx, lfnst_idx):
    lf = _load("lfnst_matrices.json")
    return np.array(lf[f"{n_tr_s}_{set_idx}_{lfnst_idx}"], dtype=np.int32)
