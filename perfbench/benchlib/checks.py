"""The comparison that decides `correct`.

The program's answer to a call is a stream and its reconstruction of each
frame it was given. Independent parts judge it, none of them the
program's or a copy of its encoder: the pure-Python spec decoder in
`vvcref/` (use_native=False) and the scalar spec model of stage A in
`stage_a_ref.py`. After the window has closed, with the numbers of every
call or of the calls that the seed sampled before the window:

pictures_missing          over every call: how far the pictures in its
                          stream (slice NAL units) and in its returned
                          reconstruction fall short of, or exceed, the
                          frames it was given;
decode_samples_differing  sampled calls, `check_pictures` of their
                          pictures each, drawn from the seed (all when
                          null): samples where the spec decoder's decode
                          differs from the program's reconstruction, a
                          picture missing on either side counting all the
                          samples of its frame (commit, CABAC, headers);
pictures_nearer_another_frame  sampled calls: reconstructed pictures
                          nearer (Y mean squared error) to another frame
                          of the run than to the frame they were given
                          for (a stale or misplaced answer);
stage_a_cands_differing   sampled luma blocks of the sampled calls:
                          blocks whose K + 2 candidate modes differ from
                          the spec model's; and every block of a chunk row
                          that holds none of the call's frames;
stage_a_cost_gap          sampled luma and chroma blocks: the largest
                          relative gap between a cost the program handed
                          on (f32) and the spec model's: each luma
                          candidate's base cost; chroma's derived, SCIPU
                          and best CCLM costs, the last also against the
                          model's cost of the program's CCLM pick;
stage_a_picks_differing   every block of the sampled calls' chunks: luma
                          blocks whose ranked candidates, best or top-2
                          costs differ from the spec selection's run on
                          the program's base costs (the selection alone);
                          chroma blocks whose derived or SCIPU mode is not
                          the luma pick it comes from.
"""
import numpy as np

from . import stage_a_ref

LIMITS = {"pictures_missing": 0, "decode_samples_differing": 0,
          "pictures_nearer_another_frame": 0, "stage_a_cands_differing": 0,
          "stage_a_cost_gap": 1e-3, "stage_a_picks_differing": 0}
# numbers that take the largest over calls; the others add up
_MAX = {"stage_a_cost_gap"}
# the cost gap of a candidate that is no mode, or of a cost that is not a
# finite number
UNREAD = 1e9


def pictures_in(stream):
    """Slice NAL units in an Annex-B stream (one per picture here); 0 for
    a stream that does not parse."""
    from vvcref.bitstream import nal
    try:
        return sum(1 for nut, _, _ in nal.parse_annexb(bytes(stream))
                   if nut in (nal.IDR_W_RADL, nal.IDR_N_LP, nal.TRAIL_NUT))
    except Exception:
        return 0


def pictures_missing(n_frames, stream, recons):
    return (abs(n_frames - pictures_in(stream))
            + abs(n_frames - len(recons)))


def samples_differing(got, want, frames):
    """Samples of the frames' pictures where `got` and `want` (lists of
    (Y, Cb, Cr)) differ; a picture that either lacks, or has in another
    shape, counts all the samples of its frame, and a picture beyond the
    frames all of its own."""
    total = 0
    for k, fr in enumerate(frames):
        for c in range(3):
            size = int(np.size(fr[c]))
            if k >= len(got) or k >= len(want):
                total += size
                continue
            g, w = np.asarray(got[k][c]), np.asarray(want[k][c])
            if g.shape != np.shape(fr[c]) or w.shape != np.shape(fr[c]):
                total += size
            else:
                total += int(np.count_nonzero(g != w))
    for extra in (got[len(frames):], want[len(frames):]):
        total += sum(int(np.size(p)) for pic in extra for p in pic)
    return total


_SLICES = (7, 8, 0)             # IDR_W_RADL, IDR_N_LP, TRAIL_NUT


def decode_pictures(stream, picks):
    """{k: (Y, Cb, Cr)} for the pictures k in `picks` (in stream order) of
    an all-intra stream, decoded by the spec decoder alone: every
    parameter set and picture header is parsed, and only the picked
    pictures' slices are decoded (each picture is one intra slice that
    reads no other picture)."""
    from vvcref.bitstream import nal
    from vvcref.bitstream.headers import parse_ph, parse_pps, parse_sps
    from vvcref.decoder import Decoder
    assert _SLICES == (nal.IDR_W_RADL, nal.IDR_N_LP, nal.TRAIL_NUT)
    dec, out, k = Decoder(use_native=False), {}, 0
    for nut, _, rbsp in nal.parse_annexb(bytes(stream)):
        if nut == nal.SPS_NUT:
            parse_sps(rbsp, dec.p)
        elif nut == nal.PPS_NUT:
            parse_pps(rbsp, dec.p)
        elif nut == nal.PH_NUT:
            parse_ph(rbsp, dec.p)
        elif nut in _SLICES:
            if k in picks:
                dec._decode_slice(rbsp)
                out[k] = dec.frames[-1]
            k += 1
    return out


def decode_samples_differing(frames, stream, recons, picks, log=None):
    """Samples of the picked pictures where the spec decoder's decode
    differs from the program's reconstruction; a picture missing on
    either side, or in another shape, counts all the samples of its
    frame."""
    try:
        dec = decode_pictures(stream, set(picks))
    except Exception as e:       # a corrupt stream fails the check
        if log:
            log(f"check: the spec decoder rejects the stream: {e!r}")
        dec = {}
    return sum(samples_differing([dec[k]] if k in dec else [],
                                 list(recons[k:k + 1]), [frames[k]])
               for k in picks)


def _mse(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.mean(d * d))


def pictures_nearer_another_frame(frames, recons, others):
    """Pictures of recons nearer to one of `others` (every other frame of
    the run) than to their own frame; a missing picture counts."""
    n = 0
    for k, fr in enumerate(frames):
        if k >= len(recons) or np.shape(recons[k][0]) != np.shape(fr[0]):
            n += 1
            continue
        own = _mse(recons[k][0], fr[0])
        n += any(_mse(recons[k][0], o[0]) <= own for o in others
                 if o is not fr)
    return n


def _rows(planes, frames):
    """The index in `frames` of the frame that each chunk row holds (all
    its planes equal), or None."""
    return [next((k for k, fr in enumerate(frames)
                  if all(np.array_equal(p[r], fr[c])
                         for c, p in enumerate(planes))), None)
            for r in range(planes[0].shape[0])]


def _gap(prog, want):
    """Relative gap of the program's f32 cost to the model's; UNREAD
    where either is not a finite number."""
    g = abs(float(prog) - float(want)) / max(float(want), 1.0)
    return g if np.isfinite(g) else UNREAD


def stage_a_numbers(kept, frames, qp, config, blocks_per_size, rng):
    """The three stage-A numbers of one call from what its chunks handed
    on (capture.StageACapture.fetch()). Each chunk row is matched to the
    call's frame it holds. Luma: every block's selection is rerun on the
    program's base costs, and `blocks_per_size` blocks of each QT size,
    drawn from the seed over the call's frames, are rebuilt by the spec
    model (candidates and costs). Chroma, where it ran on the card: every
    block's derived and SCIPU modes must be the luma picks they come from,
    and `blocks_per_size` blocks of each chroma size are rebuilt (derived,
    SCIPU and CCLM costs, the CCLM pick by its cost)."""
    ec = config["encoder_config"]
    log2_ctu = ec["log2_ctu_size"]
    prm = stage_a_ref.Params(qp, ec.get("dep_quant_enabled", True))
    cands_diff, gap, picks_diff = 0, 0.0, 0
    pool, picks = {}, {}     # size -> [(frame, row arrays)]; (frame, s) ->
    for ch in kept["luma"]:
        planes = ch["planes"]
        rows = _rows((planes,), frames)
        H = planes.shape[1]
        for nbh, nbw, base, cands, ranked, best, top2 in ch["sizes"]:
            s = H // nbh
            rk, b0, t2 = stage_a_ref.select(base, cands, nbh, nbw, s,
                                            1 << log2_ctu, prm)
            bad = ((rk != ranked).any(-1) | (b0 != best)
                   | (t2 != top2).any(-1))
            picks_diff += int(bad.sum())
            for r, k in enumerate(rows):
                if k is None:
                    cands_diff += nbh * nbw
                elif (k, s) not in picks:
                    picks[(k, s)] = ranked[r, :, 0].astype(np.int64)
                    pool.setdefault(s, []).append((k, cands[r], base[r],
                                                   nbw))
    for s in sorted(pool):
        entries = pool[s]
        N = entries[0][1].shape[0]
        for pick in rng.choice(len(entries) * N,
                               size=min(blocks_per_size, len(entries) * N),
                               replace=False):
            k, cands, base, nbw = entries[int(pick) // N]
            j = int(pick) % N
            bx, by = (j % nbw) * s, (j // nbw) * s
            ref = stage_a_ref.Block(frames[k][0], bx, by, s, log2_ctu, prm)
            mine = np.asarray(cands[j], np.int64)
            if not np.array_equal(ref.cands, mine):
                cands_diff += 1
            if ((mine < 0) | (mine > 66)).any():
                gap = max(gap, UNREAD)
                continue
            for prog, want in zip(base[j], ref.costs(mine)):
                gap = max(gap, _gap(prog, want))

    cpool = {}                       # cs -> [(frame, chunk, row)]
    for ch in kept["chroma"]:
        rows = _rows(ch["planes"], frames)
        hh, hw = ch["planes"][1].shape[1:]
        for cs in ch["css"]:
            n = (hh // cs) * (hw // cs)
            seen = set()
            for r, k in enumerate(rows):
                if k is None:
                    cands_diff += n
                    continue
                luma = picks.get((k, 2 * cs))
                dm = ch["dmodes"][cs][r].astype(np.int64)
                picks_diff += (n if luma is None
                               else int((dm != luma).sum()))
                sm = ch["scipu_modes"]
                if cs == 4 and sm is not None:
                    l4 = picks.get((k, 4))
                    want = (None if l4 is None else l4.reshape(
                        2 * hh // 4, 2 * hw // 4)[1::2, 1::2].reshape(-1))
                    picks_diff += (n if want is None else int(
                        (sm[r].astype(np.int64) != want).sum()))
                if k not in seen:
                    seen.add(k)
                    cpool.setdefault(cs, []).append((k, ch, r))
    for cs in sorted(cpool):
        entries = cpool[cs]
        hw = entries[0][1]["planes"][1].shape[2]
        n = entries[0][1]["dmodes"][cs].shape[1]
        for pick in rng.choice(len(entries) * n,
                               size=min(blocks_per_size, len(entries) * n),
                               replace=False):
            k, ch, r = entries[int(pick) // n]
            j = int(pick) % n
            cx, cy = (j % (hw // cs)) * cs, (j // (hw // cs)) * cs
            ref = stage_a_ref.ChromaBlock(frames[k], cx, cy, cs, log2_ctu,
                                          prm)
            out = ch["out"]
            modes = [(("d", cs), ch["dmodes"][cs])]
            if ("sc", cs) in out:
                modes.append((("sc", cs), ch["scipu_modes"]))
            for key, m in modes:
                mode = int(m[r, j])
                gap = max(gap, UNREAD if not 0 <= mode <= 66 else
                          _gap(out[key][r, j], ref.mode_cost(mode)))
            if ("cc", cs) in out:
                best, pk = out[("cc", cs)]
                want = ref.cclm_costs()
                p = int(pk[r, j])
                gap = max(gap, _gap(best[r, j], want.min()),
                          UNREAD if not 0 <= p <= 2 else
                          _gap(best[r, j], want[p]))
    return {"stage_a_cands_differing": cands_diff, "stage_a_cost_gap": gap,
            "stage_a_picks_differing": picks_diff}


def psnr_avg(ref, rec):
    """tools/evaluate.frame_psnr_avg's arithmetic (copied): PSNR of Y, U,
    V and their 4:1:1 weighted mean."""
    mses, out = [], {}
    for name, r, d in zip("YUV", ref, rec):
        mse = _mse(r, d)
        mses.append(mse)
        out[name] = 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    wmse = (4 * mses[0] + mses[1] + mses[2]) / 6.0
    out["Avg"] = 99.0 if wmse == 0 else 10.0 * np.log10(255.0 ** 2 / wmse)
    return out


def add(total, numbers):
    for k, v in numbers.items():
        total[k] = (max(total.get(k, v), v) if k in _MAX
                    else total.get(k, 0) + v)
    return total


def passes(numbers):
    return all(k in numbers and numbers[k] <= LIMITS[k] for k in LIMITS)
