"""Neighbouring-sample availability (spec 6.4.1 / 6.4.4).

For a quad-tree-only partitioning every coding block is a power-of-two
aligned square, so "the neighbouring block precedes the current block in
decoding order" reduces to a Morton (z-scan) order comparison inside the
CTU plus CTU raster order across CTUs. The reference implements the same
rule structurally by walking its tree (ctu.rs is_above_right_available /
encoder_context.rs:918 derive_neighbouring_block_availability); the Morton
form is equivalent for QT-aligned blocks and is what both our encoder and
decoder use, so the two always agree.
"""
import numpy as np


def _morton(x, y):
    """Interleave bits of x and y (y high) -> z-scan index. x, y < 2**16."""
    x = int(x)
    y = int(y)
    z = 0
    for b in range(16):
        z |= ((x >> b) & 1) << (2 * b)
        z |= ((y >> b) & 1) << (2 * b + 1)
    return z


class Availability:
    """Availability oracle for one picture."""

    def __init__(self, width, height, log2_ctu=5, wpp=False):
        self.width = width
        self.height = height
        self.log2_ctu = log2_ctu
        self.wpp = wpp

    def available(self, cur_x, cur_y, nb_x, nb_y):
        """Is the sample at luma position (nb_x, nb_y) decoded before the
        block whose top-left luma sample is (cur_x, cur_y)?
        """
        if nb_x < 0 or nb_y < 0 or nb_x >= self.width or nb_y >= self.height:
            return False
        l2 = self.log2_ctu
        cur_cx, cur_cy = cur_x >> l2, cur_y >> l2
        nb_cx, nb_cy = nb_x >> l2, nb_y >> l2
        if nb_cy > cur_cy:
            return False
        if nb_cy < cur_cy:
            # CTU in a previous row: decoded unless it is beyond the
            # above-right column limit (raster order) — above row is fully
            # decoded in raster order, but WPP restricts to <= cur column + 1.
            if self.wpp and nb_cx > cur_cx + 1:
                return False
            return True
        # same CTU row
        if nb_cx > cur_cx:
            return False
        if nb_cx < cur_cx:
            return True
        # same CTU: z-scan comparison
        m = (1 << l2) - 1
        return _morton(nb_x & m, nb_y & m) < _morton(cur_x & m, cur_y & m)

    def available_vec(self, cur_x, cur_y, nb_x, nb_y):
        """Vectorized `available` over arrays of neighbour positions."""
        nb_x = np.asarray(nb_x)
        nb_y = np.asarray(nb_y)
        out = np.zeros(np.broadcast(nb_x, nb_y).shape, dtype=bool)
        it = np.nditer([nb_x, nb_y, out], op_flags=[["readonly"], ["readonly"],
                                                    ["writeonly"]])
        for xx, yy, oo in it:
            oo[...] = self.available(cur_x, cur_y, int(xx), int(yy))
        return out
