"""The synthetic frames every cell encodes, made from the seed.

The generator is bench.py's (and chip_smoke.synth_frames'), with its
constants read from the traffic file's `content` group: frame i of a pool
is luma = clip(sin(x / x_period + i * x_phase_step) * x_amp
+ cos(y / y_period - i * y_phase_step) * y_amp + base + uniform noise in
[-noise, noise]), chroma derived from the subsampled luma as
cb = y / 2 + cb_offset and cr = cr_offset - y / 2. Every seed gives the
same pattern and differs in the noise, so every seed asks the encoder for
the same kind of work.

Frames are made at the configuration's picture size and padded to its
coded size by repeating the last row and column, as an encoder pads a
picture whose size is not a multiple of its CTU.
"""
import numpy as np


def seed_sequence(seed, stream):
    """A numpy generator for (seed, stream): any integer seed, negative
    or beyond 64 bits included; streams keep the pool, the warm-up frames
    and the check's sample apart."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def make_frames(params, picture, coded, n, rng):
    """n frames (Y, Cb, Cr) uint8 4:2:0 of `picture` = (width, height),
    padded to `coded` = (width, height)."""
    if params.get("generator") != "sinusoid_noise":
        raise ValueError(f"unknown content generator {params.get('generator')!r}")
    w, h = picture
    cw, ch = coded
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = np.clip((np.sin(xx / params["x_period"] + i * params["x_phase_step"])
                     * params["x_amp"]
                     + np.cos(yy / params["y_period"] - i * params["y_phase_step"])
                     * params["y_amp"] + params["base"])
                    + rng.integers(-params["noise"], params["noise"] + 1, (h, w)),
                    0, 255).astype(np.uint8)
        sub = y[::2, ::2]
        cb = (sub // 2 + params["cb_offset"]).astype(np.uint8)
        cr = (params["cr_offset"] - sub // 2).astype(np.uint8)
        frames.append((_pad(y, cw, ch), _pad(cb, cw // 2, ch // 2),
                       _pad(cr, cw // 2, ch // 2)))
    return frames


def _pad(plane, w, h):
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")
