"""What luma stage A hands on, kept from the window's sampled calls.

The window's calls run stage A inside `Encoder.encode`. To judge it, the
harness wraps three names of the program's search module for the whole
run (`fused_luma_stage_a`, the chunk's luma stage A; `_select_modes_dev`,
its selection per QT size; `fused_chroma_stage_a`, the chunk's chroma
stage A where it runs on the card); the wrappers call through unchanged.
In a call that the seed sampled (`active`), they keep references to the
chunk's frames on the card, per luma size the selection's inputs (base
costs and candidates) and outputs (ranked candidates, best and top-2
costs), and chroma stage A's derived modes and outputs: no copy and no
wait inside the window. `fetch()` brings them to the host once the
window has closed.
"""


class StageACapture:
    def __init__(self, search_module):
        self.mod = search_module
        self.active = False
        self.chunks = []          # per chunk: {"planes", "sizes": [...]}
        self.chroma = []          # per chunk: fused_chroma_stage_a's
        self._cur = None
        self._orig = (search_module.fused_luma_stage_a,
                      search_module._select_modes_dev,
                      search_module.fused_chroma_stage_a)

    def install(self):
        stage_a, select, chroma = self._orig

        def fused(planes, *args, **kw):
            if not self.active:
                return stage_a(planes, *args, **kw)
            self._cur = {"planes": planes, "sizes": []}
            try:
                return stage_a(planes, *args, **kw)
            finally:
                self.chunks.append(self._cur)
                self._cur = None

        def sel(base, cands, nbh, nbw, *args, **kw):
            out = select(base, cands, nbh, nbw, *args, **kw)
            if self._cur is not None:
                self._cur["sizes"].append((nbh, nbw, base, cands, out))
            return out

        def fused_c(py, pcb, pcr, W, H, log2_ctu, css, cclm, scipu,
                    trellis, dmodes, scipu_modes, *args, **kw):
            out = chroma(py, pcb, pcr, W, H, log2_ctu, css, cclm, scipu,
                         trellis, dmodes, scipu_modes, *args, **kw)
            if self.active:
                self.chroma.append({
                    "planes": (py, pcb, pcr), "W": W, "H": H, "css": css,
                    "cclm": cclm, "trellis": trellis, "dmodes": dmodes,
                    "scipu_modes": scipu_modes if scipu else None,
                    "out": out})
            return out

        self.mod.fused_luma_stage_a = fused
        self.mod._select_modes_dev = sel
        self.mod.fused_chroma_stage_a = fused_c
        return self

    def uninstall(self):
        (self.mod.fused_luma_stage_a, self.mod._select_modes_dev,
         self.mod.fused_chroma_stage_a) = self._orig

    def take(self):
        """The chunks kept since the last take, still on the card:
        {"luma": [...], "chroma": [...]}."""
        out = {"luma": self.chunks, "chroma": self.chroma}
        self.chunks, self.chroma = [], []
        return out

    @staticmethod
    def fetch(kept):
        """Kept chunks on the host: {"luma": [{"planes": (F', H, W) uint8,
        "sizes": [(nbh, nbw, base, cands, ranked, best, top2)]}], "chroma":
        [{"planes": (Y, Cb, Cr) each (F', H, W) / (F', H/2, W/2), "css",
        "cclm", "trellis", "dmodes": {cs: (F', N)}, "scipu_modes": (F', N4)
        or None, "out": {key: array or (array, array)}}]}."""
        def np_(x):
            return x.detach().cpu().numpy()
        luma = [{"planes": np_(c["planes"]),
                 "sizes": [(nbh, nbw, np_(b), np_(k)) + tuple(np_(o)
                                                           for o in out)
                           for nbh, nbw, b, k, out in c["sizes"]]}
                for c in kept["luma"]]
        chroma = []
        for c in kept["chroma"]:
            W, H = c["W"], c["H"]
            py, pcb, pcr = (np_(p) for p in c["planes"])
            F = py.shape[0]
            chroma.append({
                "planes": (py.reshape(F, H, W),
                           pcb.reshape(F, H // 2, W // 2),
                           pcr.reshape(F, H // 2, W // 2)),
                "css": tuple(c["css"]), "cclm": c["cclm"],
                "trellis": c["trellis"],
                "dmodes": {cs: np_(m) for cs, m in c["dmodes"].items()},
                "scipu_modes": (None if c["scipu_modes"] is None
                                else np_(c["scipu_modes"])),
                "out": {k: (tuple(np_(x) for x in v) if isinstance(v, tuple)
                            else np_(v)) for k, v in c["out"].items()}})
        return {"luma": luma, "chroma": chroma}
