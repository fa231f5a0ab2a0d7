"""Raw YUV420 8-bit planar IO (the reference's input format, main.rs:318)."""
import numpy as np


def read_yuv420(path_or_file, width, height, num_frames=None):
    """Read planar YUV420 frames -> list of (Y, Cb, Cr) uint8 arrays."""
    own = isinstance(path_or_file, (str, bytes))
    f = open(path_or_file, "rb") if own else path_or_file
    try:
        frames = []
        ysz = width * height
        csz = (width // 2) * (height // 2)
        while num_frames is None or len(frames) < num_frames:
            data = f.read(ysz + 2 * csz)
            if len(data) < ysz + 2 * csz:
                break
            y = np.frombuffer(data, np.uint8, ysz).reshape(height, width)
            cb = np.frombuffer(data, np.uint8, csz, ysz).reshape(height // 2,
                                                                 width // 2)
            cr = np.frombuffer(data, np.uint8, csz, ysz + csz) \
                .reshape(height // 2, width // 2)
            frames.append((y.copy(), cb.copy(), cr.copy()))
        return frames
    finally:
        if own:
            f.close()


def write_yuv420(path_or_file, frames):
    """Write (Y, Cb, Cr) planar frames."""
    own = isinstance(path_or_file, (str, bytes))
    f = open(path_or_file, "wb") if own else path_or_file
    try:
        for y, cb, cr in frames:
            f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(cb, dtype=np.uint8).tobytes())
            f.write(np.ascontiguousarray(cr, dtype=np.uint8).tobytes())
    finally:
        if own:
            f.close()
