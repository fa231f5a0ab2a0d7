"""Multi-device decomposition helpers: mesh construction.

Counterpart of wrenc_tpu/dist/__init__.py. The JAX search is
single-controller (one process drives every local device), and so is the
port: a mesh is a grid of torch devices that one process drives, not a
torch.distributed process group. The sharded compute lives in
search/wavefront.py: frame cells run the fused luma stage A on their
frames, and under a `row` axis each cell runs `fused_luma_band_stage_a`
on its CTU-row band with a one-row halo copied from the band above.

A device may appear in several cells (a one-card mesh of several cells,
or N copies of the CPU device): every cell then runs on that device in
turn, with the same results as on distinct devices.
"""
import numpy as np
import torch


class Mesh:
    """A grid of torch devices with named axes, the shape of
    jax.sharding.Mesh: `devices` an object array of torch.device,
    `axis_names` one name per dimension, `shape` {name: size}, so
    mesh.shape.get('row', 1) reads as it does in JAX."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size


def cuda_devices():
    """Every CUDA device of this process, in index order."""
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, frame_axis=None):
    """Build a (frame, row) mesh from `devices` (None: every CUDA device;
    a device may repeat).

    The two axes are the codec's decomposition dimensions: `frame` =
    independent all-intra frames (pure data parallelism), `row` = CTU-row
    bands within a frame (a one-row halo from the band above). Without
    `frame_axis` the factorisation is the square-ish one of the JAX
    package: the largest divisor of n up to sqrt(n)."""
    devices = list(cuda_devices() if devices is None else devices)
    n = len(devices)
    if n == 0:
        raise RuntimeError("make_mesh: no device (no CUDA device visible)")
    if frame_axis is None:
        frame_axis = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                frame_axis = f
                break
    rows = n // frame_axis
    grid = np.empty(frame_axis * rows, dtype=object)
    for i, d in enumerate(devices[:frame_axis * rows]):
        grid[i] = d
    return Mesh(grid.reshape(frame_axis, rows), ("frame", "row"))
