"""Batched reference-sample construction.

Builds, for every aligned block of a given size in a frame, the unified
reference vector u = [corner, left_0..left_{2s-1}, above_0..above_{2s-1}]
with spec availability marking + substitution (8.4.5.2.8) applied, fully
vectorized. Availability is geometric (picture bounds + z-scan order), so
masks are cached per (frame size, block size, component).

Substitution order matches the spec: bottom-left sample upward through the
corner, then above samples left-to-right — a forward fill along that scan
permutation, seeded by the first available sample in scan order (128 fill
when nothing is available).
"""
import functools

import numpy as np

from .. import trace
from ..spec.avail import Availability


@functools.lru_cache(maxsize=None)
@trace.table
def block_grid(width, height, size, c_idx=0):
    """Positions (component domain) of all aligned size x size blocks."""
    sh = 0 if c_idx == 0 else 1
    w, h = width >> sh, height >> sh
    ys, xs = np.mgrid[0:h:size, 0:w:size]
    return xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)


@functools.lru_cache(maxsize=None)
@trace.table
def avail_masks(width, height, size, c_idx=0, log2_ctu=5):
    """(N, L) availability of each reference sample of each aligned block."""
    av = Availability(width, height, log2_ctu)
    xs, ys = block_grid(width, height, size, c_idx)
    sh = 0 if c_idx == 0 else 1
    L = 4 * size + 1
    masks = np.zeros((len(xs), L), dtype=bool)
    for i, (cx, cy) in enumerate(zip(xs, ys)):
        lx, ly = int(cx) << sh, int(cy) << sh
        masks[i, 0] = av.available(lx, ly, (int(cx) - 1) << sh,
                                   (int(cy) - 1) << sh)
        for k in range(2 * size):
            masks[i, 1 + k] = av.available(lx, ly, (int(cx) - 1) << sh,
                                           (int(cy) + k) << sh)
            masks[i, 1 + 2 * size + k] = av.available(lx, ly,
                                                      (int(cx) + k) << sh,
                                                      (int(cy) - 1) << sh)
    return masks


@functools.lru_cache(maxsize=None)
def _subst_perm(size):
    """Scan permutation for substitution: bottom-left -> corner -> above."""
    L = 4 * size + 1
    left = list(range(2 * size, -1, -1))      # u[2s] .. u[0]
    above = list(range(2 * size + 1, L))
    return np.array(left + above, dtype=np.int64)


def gather_u(plane, xs, ys, size):
    """Raw (pre-substitution) u vectors for blocks at (xs, ys) on `plane`.

    Out-of-bounds samples are clamped reads (masked off by availability).
    Returns (N, L) int32.
    """
    plane = np.asarray(plane)
    H, W = plane.shape
    N = len(xs)
    L = 4 * size + 1
    u = np.zeros((N, L), dtype=np.int32)
    cx = np.clip(xs - 1, 0, W - 1)
    cy = np.clip(ys - 1, 0, H - 1)
    u[:, 0] = plane[cy, cx]
    k = np.arange(2 * size)
    lyy = np.clip(ys[:, None] + k[None, :], 0, H - 1)
    u[:, 1:1 + 2 * size] = plane[lyy, cx[:, None]]
    axx = np.clip(xs[:, None] + k[None, :], 0, W - 1)
    u[:, 1 + 2 * size:] = plane[cy[:, None], axx]
    return u


def substitute(u, masks, size, fill=128):
    """Spec reference-sample substitution, vectorized over blocks."""
    perm = _subst_perm(size)
    up = u[:, perm]
    mp = masks[:, perm]
    N, L = up.shape
    idx = np.where(mp, np.arange(L)[None, :], -1)
    ff = np.maximum.accumulate(idx, axis=1)
    any_avail = mp.any(axis=1)
    first = np.argmax(mp, axis=1)
    ff = np.where(ff < 0, first[:, None], ff)
    vals = up[np.arange(N)[:, None], ff]
    vals = np.where(any_avail[:, None], vals, fill)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(L)
    return vals[:, inv].astype(np.int32)


def build_ref_vectors(plane, width, height, size, c_idx=0, log2_ctu=5,
                      xs=None, ys=None, masks=None):
    """u vectors (substituted) for all aligned blocks — or a custom set of
    positions with precomputed masks."""
    if xs is None:
        xs, ys = block_grid(width, height, size, c_idx)
        masks = avail_masks(width, height, size, c_idx, log2_ctu)
    u = gather_u(plane, np.asarray(xs), np.asarray(ys), size)
    return substitute(u, masks, size), xs, ys


@functools.lru_cache(maxsize=None)
@trace.table
def subst_gather(width, height, size, c_idx=0, log2_ctu=5):
    """Static substitution-as-gather: for every aligned block, the flat
    plane index each (substituted) reference sample reads from.

    Substitution only depends on geometry (availability), so u can be built
    on device as `where(fill, 128, plane_flat[src_idx])` — no host ref
    construction. Returns (src_idx (N, L) int32, fill (N,) bool).
    """
    xs, ys = block_grid(width, height, size, c_idx)
    masks = avail_masks(width, height, size, c_idx, log2_ctu)
    sh = 0 if c_idx == 0 else 1
    w, h = width >> sh, height >> sh
    N = len(xs)
    L = 4 * size + 1
    # plane coords of each ref slot (clamped; unavailable slots unused)
    coord = np.zeros((N, L), dtype=np.int64)
    cxm = np.clip(xs - 1, 0, w - 1).astype(np.int64)
    cym = np.clip(ys - 1, 0, h - 1).astype(np.int64)
    coord[:, 0] = cym * w + cxm
    k = np.arange(2 * size)
    lyy = np.clip(ys[:, None] + k[None, :], 0, h - 1)
    coord[:, 1:1 + 2 * size] = lyy * w + cxm[:, None]
    axx = np.clip(xs[:, None] + k[None, :], 0, w - 1)
    coord[:, 1 + 2 * size:] = cym[:, None] * w + axx
    # forward-fill along the substitution scan permutation (cf. substitute)
    perm = _subst_perm(size)
    mp = masks[:, perm]
    cp = coord[:, perm]
    idx = np.where(mp, np.arange(L)[None, :], -1)
    ff = np.maximum.accumulate(idx, axis=1)
    first = np.argmax(mp, axis=1)
    ff = np.where(ff < 0, first[:, None], ff)
    src = cp[np.arange(N)[:, None], ff]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(L)
    src = src[:, inv].astype(np.int32)
    fill = ~mp.any(axis=1)
    return src, fill


@functools.lru_cache(maxsize=None)
@trace.table
def filter121_indices(size):
    """Static (prev, next, passthrough) index arrays for the 121 reference
    filter on a unified u vector (cf. intra_mats.filter_ref_vector)."""
    L = 4 * size + 1
    h = w = size
    pi = np.arange(L, dtype=np.int32)
    ni = np.arange(L, dtype=np.int32)
    keep = np.zeros(L, dtype=bool)
    pi[0], ni[0] = 1, 1 + 2 * h
    for y in range(2 * h - 1):
        pi[1 + y], ni[1 + y] = 2 + y, y
    keep[2 * h] = True
    a0 = 1 + 2 * h
    pi[a0], ni[a0] = 0, a0 + 1
    for x in range(2 * w - 2):
        pi[a0 + 1 + x], ni[a0 + 1 + x] = a0 + x, a0 + 2 + x
    keep[L - 1] = True
    return pi, ni, keep
