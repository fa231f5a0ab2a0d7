"""The sharded stage A's band loop, over one process or a process group.

WavefrontSearch._dispatch_mesh runs its grid of (frame, row) cells
through `band_stage_a` as rank 0 of a world of 1: one process drives
every cell and no collective runs. With a torch.distributed group the
same loop splits the grid among the ranks, as jax.distributed splits a
global mesh among processes: the cells in row-major order, cut into
world_size equal consecutive runs, rank r owning the r-th (devices
ordered by rank, as jax.devices() orders them). Each rank reads only its
own cells' rows and runs them; the one-row halo a band needs from the
band above comes from the cell that owns that band: on the same rank it
is copied from that band on its device, across ranks it goes by send /
recv of a CPU tensor. `gather_cells` brings every rank's results to every
rank by all_gather of CPU tensors.

Every collective moves CPU tensors, so the group's backend is gloo even
when the cells are on cards: two ranks may share one card, which NCCL
does not allow.
"""
import contextlib
import datetime
import socket

import torch
import torch.distributed as tdist


def free_port():
    """A TCP port on 127.0.0.1 that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank, world_size, port, timeout_s=120):
    """Join the gloo process group at tcp://127.0.0.1:<port> as `rank` of
    `world_size` (both given explicitly; nothing is read from the
    environment). A peer missing for `timeout_s` raises."""
    tdist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def owner(cell, shape, world_size):
    """The rank that owns cell (f, r) of a (frame, row) grid."""
    nf, nr = shape
    per = nf * nr // world_size
    return (cell[0] * nr + cell[1]) // per


def rank_cells(shape, rank, world_size):
    """The (frame, row) cells of `rank`, in row-major order."""
    nf, nr = shape
    if (nf * nr) % world_size:
        raise ValueError(f"a {nf} x {nr} grid does not split into "
                         f"{world_size} equal runs of cells")
    per = nf * nr // world_size
    return [divmod(i, nr) for i in range(rank * per, (rank + 1) * per)]


def _on(dev):
    """Make `dev` the current card for the block (hand kernels launch on
    the current device's stream); nothing for the CPU."""
    if dev.type == 'cuda':
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def band_stage_a(planes, devices, upload, run_cell, rank=0, world_size=1):
    """This rank's cells of the sharded stage A.

    planes: (F, H, W) uint8 numpy, F a multiple of the frame axis (the
    band stage A asserts that the bands are CTU-row-aligned); devices: the (frame, row) object array of torch.device;
    upload(rows, dev): host rows -> uint8 on dev; run_cell(band, halo, r,
    dev): the stage A of row band r on dev, band (F/nf, H/nr, W) and halo
    (F/nf, W) uint8, or None without a row axis (band 0's halo is zeros,
    which its fill flags mask). Each cell runs under its device. Cells run
    in row-major order, so a band's halo comes from an earlier cell: this
    rank's own, or another rank's, which sends it before running its
    cell and never waits on this one. Returns [[run_cell's outputs per
    row band] per frame cell], None for the cells of other ranks."""
    nf, nr = devices.shape
    F, H, W = planes.shape
    if F % nf:
        raise ValueError(f"{F} frames do not split over {nf} frame cells")
    fl, bh = F // nf, H // nr
    out = [[None] * nr for _ in range(nf)]
    bands, sends = {}, []
    for f, r in rank_cells((nf, nr), rank, world_size):
        dev = devices[f, r]
        with _on(dev):
            band = upload(planes[f * fl:(f + 1) * fl, r * bh:(r + 1) * bh],
                          dev)
            bands[(f, r)] = band
            halo = None
            if nr > 1 and r == 0:
                halo = torch.zeros((fl, W), dtype=torch.uint8, device=dev)
            elif nr > 1 and (f, r - 1) in bands:
                halo = bands[(f, r - 1)][:, -1, :].to(dev, non_blocking=True)
            elif nr > 1:
                got = torch.empty((fl, W), dtype=torch.uint8)
                tdist.recv(got, src=owner((f, r - 1), (nf, nr), world_size))
                halo = got.to(dev)
            if r + 1 < nr and owner((f, r + 1), (nf, nr), world_size) != rank:
                row = band[:, -1, :].cpu().contiguous()
                sends.append((tdist.isend(
                    row, dst=owner((f, r + 1), (nf, nr), world_size)), row))
            out[f][r] = run_cell(band, halo, r, dev)
    for work, _ in sends:
        work.wait()
    return out


def gather_cells(cells, world_size):
    """band_stage_a's grid with every rank's cells filled in, on every rank,
    by all_gather of CPU tensors (each rank's cells stacked in row-major
    order); search/wavefront._fetch_cells assembles it. cells: [[{s: tuple
    of tensors} or None per row band] per frame cell]."""
    nf, nr = len(cells), len(cells[0])
    mine = [(f, r) for f in range(nf) for r in range(nr)
            if cells[f][r] is not None]
    first = cells[mine[0][0]][mine[0][1]]
    grid = [[{} for _ in range(nr)] for _ in range(nf)]
    for s in first:
        parts = []
        for i in range(len(first[s])):
            local = torch.stack([cells[f][r][s][i].cpu() for f, r in mine])
            got = [torch.empty_like(local) for _ in range(world_size)]
            tdist.all_gather(got, local)
            parts.append(torch.cat(got))            # (cells, ...) row-major
        for k in range(nf * nr):
            grid[k // nr][k % nr][s] = tuple(p[k] for p in parts)
    return grid
