"""Picture partitioning model: tiles, slices, subpictures (spec 6.5.1).

The structural counterpart of the reference's tile.rs / slice.rs /
subpicture.rs and the Unit*Splitters (tile_splitter.rs:13,
slice_splitter.rs, subpicture_splitter.rs): tile grids are derived from
explicit column widths / row heights with uniform fill, slices map onto
tiles in raster or rectangular layouts, and CTU coding order follows the
tile scan. The reference ships this machinery but always instantiates the
1-tile/1-slice/1-subpicture layout (main.rs:354-361); `single_layout` is
that operating point and is what the encoder uses, while the general
mapping is unit-tested against multi-tile layouts.
"""
from dataclasses import dataclass, field


def _fill_uniform(explicit, total):
    """Spec 6.5.1 tile boundary derivation: explicit sizes first, then the
    last explicit size repeats (uniform fill) until the picture is covered."""
    sizes = []
    used = 0
    for s in explicit:
        if used + s > total:
            break
        sizes.append(s)
        used += s
    last = explicit[-1] if explicit else total
    while used < total:
        s = min(last, total - used)
        sizes.append(s)
        used += s
    return sizes


@dataclass
class TileGrid:
    """Tile layout over a CTU grid (spec 6.5.1; tile.rs / pps tile syntax)."""
    ctus_wide: int
    ctus_high: int
    col_widths: list                     # CTU columns per tile column
    row_heights: list                    # CTU rows per tile row

    @classmethod
    def make(cls, ctus_wide, ctus_high, exp_col_widths=None,
             exp_row_heights=None):
        cols = _fill_uniform(exp_col_widths or [ctus_wide], ctus_wide)
        rows = _fill_uniform(exp_row_heights or [ctus_high], ctus_high)
        return cls(ctus_wide, ctus_high, cols, rows)

    @property
    def num_tile_cols(self):
        return len(self.col_widths)

    @property
    def num_tile_rows(self):
        return len(self.row_heights)

    @property
    def num_tiles(self):
        return self.num_tile_cols * self.num_tile_rows

    def col_bd(self):
        bd = [0]
        for w in self.col_widths:
            bd.append(bd[-1] + w)
        return bd

    def row_bd(self):
        bd = [0]
        for h in self.row_heights:
            bd.append(bd[-1] + h)
        return bd

    def tile_of_ctu(self, cx, cy):
        """Tile index (raster over the tile grid) containing CTU (cx, cy)."""
        col = sum(1 for b in self.col_bd()[1:-1] if cx >= b)
        row = sum(1 for b in self.row_bd()[1:-1] if cy >= b)
        return row * self.num_tile_cols + col

    def ctus_of_tile(self, tile_idx):
        """CTU (cx, cy) list of one tile in raster order within the tile."""
        tc, tr = tile_idx % self.num_tile_cols, tile_idx // self.num_tile_cols
        cb, rb = self.col_bd(), self.row_bd()
        return [(cx, cy)
                for cy in range(rb[tr], rb[tr + 1])
                for cx in range(cb[tc], cb[tc + 1])]

    def ctu_tile_scan(self):
        """All CTUs in tile-scan coding order (tiles raster, CTUs raster
        within each tile) — the order slice_encoder.rs:353-363 walks."""
        out = []
        for t in range(self.num_tiles):
            out.extend(self.ctus_of_tile(t))
        return out


@dataclass
class SliceStruct:
    """One slice: an ordered list of tile indices (raster slices) or a
    rectangle of tiles (rect slices) — slice.rs:8-26."""
    tiles: list

    def ctus(self, grid):
        out = []
        for t in self.tiles:
            out.extend(grid.ctus_of_tile(t))
        return out


def raster_slices(grid, tiles_per_slice):
    """Raster-scan slice layout: consecutive runs of tiles
    (pps_rect_slice_flag = 0)."""
    slices = []
    t = 0
    for n in tiles_per_slice:
        assert t + n <= grid.num_tiles, "slice layout exceeds tile count"
        slices.append(SliceStruct(list(range(t, t + n))))
        t += n
    assert t == grid.num_tiles, "slices must cover every tile"
    return slices


def rect_slices(grid, rects):
    """Rectangular slice layout: (top_left_tile_idx, w_tiles, h_tiles)
    per slice (pps_rect_slice_flag = 1)."""
    covered = set()
    slices = []
    for tl, w, h in rects:
        tc, tr = tl % grid.num_tile_cols, tl // grid.num_tile_cols
        assert tc + w <= grid.num_tile_cols and tr + h <= grid.num_tile_rows
        tiles = [(tr + dy) * grid.num_tile_cols + (tc + dx)
                 for dy in range(h) for dx in range(w)]
        assert not (covered & set(tiles)), "overlapping rect slices"
        covered.update(tiles)
        slices.append(SliceStruct(tiles))
    assert covered == set(range(grid.num_tiles)), "rects must cover picture"
    return slices


@dataclass
class PictureLayout:
    """Tiles + slices + subpictures of one picture."""
    grid: TileGrid
    slices: list
    num_subpics: int = 1

    def ctu_order(self):
        """Coding order of all CTUs: slices in order, tile scan within."""
        out = []
        for s in self.slices:
            out.extend(s.ctus(self.grid))
        return out


def single_layout(ctus_wide, ctus_high):
    """The operating point: 1 tile, 1 slice, 1 subpicture per picture
    (tile_splitter.rs:13, slice_splitter.rs, subpicture_splitter.rs)."""
    grid = TileGrid.make(ctus_wide, ctus_high)
    return PictureLayout(grid, raster_slices(grid, [1]), 1)
