"""Coding-tree decision structures shared by search, entropy, and decoder.

The RD search produces one `CtNode` tree per CTU; the entropy layer codes
it; the decoder parses bitstreams back into the same structures and
reconstructs from them.
"""
from dataclasses import dataclass, field


@dataclass(slots=True)
class CuDecision:
    x: int
    y: int
    log2: int            # luma block size log2
    tree: str            # 'S' single, 'L' dual-tree luma, 'C' dual-tree chroma
    luma_mode: int = 0
    chroma_mode: int = 0  # actual chroma prediction mode (incl. 81..83 CCLM)
    # stored quantized levels per component (the dequantizer's q form);
    # None for inactive components
    coeffs: list = field(default_factory=lambda: [None, None, None])
    # stage-A luma candidate modes for commit-time re-decision (optional)
    cands: list = None
    # explicit MTS index (always 0 from this encoder; parsed by the decoder)
    mts_idx: int = 0
    # per-component transform_skip flags (selected by the search when
    # cfg.transform_skip_search is on; parsed by the decoder)
    ts: list = field(default_factory=lambda: [0, 0, 0])
    # QP-group delta (always 0 from this fixed-QP encoder)
    qp_delta: int = 0
    # target QpY for the CU's QG (qp_delta_pattern mode); None = slice QP.
    # The syntax encoder signals delta = qp_y - predicted QP (spec 8.7.1)
    qp_y: int = None


@dataclass(slots=True)
class CtuSao:
    """Per-CTU SAO parameters (ctu.rs:84-135; syntax ctu_encoder.rs:2611).

    type_idx / eo_class are [luma, chroma] (cb and cr share them);
    offsets and band_position are per component."""
    merge_left: int = 0
    merge_up: int = 0
    type_idx: list = field(default_factory=lambda: [0, 0])
    offset_abs: list = field(
        default_factory=lambda: [[0] * 4 for _ in range(3)])
    offset_sign: list = field(
        default_factory=lambda: [[0] * 4 for _ in range(3)])
    band_position: list = field(default_factory=lambda: [0, 0, 0])
    eo_class: list = field(default_factory=lambda: [0, 0])


@dataclass(slots=True)
class CtNode:
    x: int
    y: int
    log2: int
    cqt_depth: int = 0
    tree: str = 'S'
    mode_type: str = 'ALL'   # 'ALL' | 'INTRA' (SCIPU)
    split: bool = False
    children: list = field(default_factory=list)
    cu: CuDecision = None
    # commit-time QT refinement: evaluate both the merged leaf (alt_cu)
    # and the split children on the true reconstruction, keep the cheaper
    refine: bool = False
    alt_cu: CuDecision = None
    # per-CTU SAO parameters (only meaningful on CTU-root nodes and only
    # when SAO is signalled; None codes as type 0 = off)
    sao: CtuSao = None

    @property
    def size(self):
        return 1 << self.log2


def make_scipu(x, y):
    """8x8 single-tree QT split -> 4 dual-tree-luma 4x4 + 1 chroma node."""
    node = CtNode(x, y, 3, split=True)
    half = 4
    for i in range(4):
        cx, cy = x + (i % 2) * half, y + (i // 2) * half
        node.children.append(CtNode(cx, cy, 2, tree='L', mode_type='INTRA'))
    node.children.append(CtNode(x, y, 3, tree='C', mode_type='INTRA'))
    return node
