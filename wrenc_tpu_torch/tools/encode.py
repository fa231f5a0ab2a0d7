"""CLI encoder of the PyTorch/CUDA port — the flags of
wrenc_tpu.tools.encode, plus --device. --dp N shards stage A's frames
over N cards (0, the default: every card, when there are more than one;
with --device cpu, N copies of the CPU device); the environment switches
of the search (WRENC_COMMIT_ENGINE, WRENC_CHROMA_STAGE_A) apply. Stage A
selects the luma winners on the device (the --dp mesh has no row axis,
the one place where the host selects them).

    python -m wrenc_tpu_torch.tools.encode -i in.yuv -o out.vvc \
        --input-size 352x288 --output-size 352x288 --num-pictures 30 \
        --qp 32 [--max-split-depth 3] [--reconst rec.yuv] \
        [--extra-params K=V,...] [--search wavefront|scalar] \
        [--dp N] [--device cuda|cpu]
"""
import argparse
import sys
import time


def parse_size(s):
    w, h = s.split("x")
    return int(w), int(h)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="wrenc-tpu VVC all-intra encoder (PyTorch/CUDA port)")
    ap.add_argument("-i", "--input", required=True,
                    help="raw YUV420 input ('-' for stdin)")
    ap.add_argument("-o", "--output", required=True,
                    help="output bitstream ('-' for stdout)")
    ap.add_argument("-r", "--reconst", default=None,
                    help="write reconstructed YUV")
    ap.add_argument("--input-size", required=True)
    ap.add_argument("--output-size", required=True)
    ap.add_argument("--num-pictures", type=int, required=True)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--max-split-depth", type=int, default=3)
    ap.add_argument("--extra-params", default=None,
                    help="rate-model overrides KEY=VAL,...")
    ap.add_argument("--search", choices=["wavefront", "scalar"],
                    default="wavefront")
    ap.add_argument("--wpp", action="store_true",
                    help="entropy_coding_sync: one CABAC subset per CTU row "
                         "with slice-header entry points")
    ap.add_argument("--batch", type=int, default=8,
                    help="accepted for interface parity; stage-A chunks "
                         "follow the search's batch buckets")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard the frame batch over N devices (0 = all "
                         "available when >1, 1 = single device; on the "
                         "CPU, N copies of the CPU device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for stage A (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.config import EncoderConfig
    from ..encoder import Encoder
    from . import yuv

    w, h = parse_size(args.output_size)
    cfg = EncoderConfig(width=w, height=h, qp=args.qp,
                        max_split_depth=args.max_split_depth)
    if args.wpp:
        cfg.entropy_coding_sync_enabled = True
        cfg.entry_point_offsets_present = True
    if args.extra_params:
        cfg.rate_model.apply_extra_params(
            dict(kv.split("=") for kv in args.extra_params.split(",")))
    if args.search == "wavefront":
        from ..search import WavefrontSearch
        mesh = None
        if args.dp != 1:
            import torch
            from ..dist import Mesh, cuda_devices
            dev = torch.device(args.device)
            devs = cuda_devices() if dev.type == "cuda" else [dev]
            n = args.dp if args.dp > 0 else len(devs)
            if dev.type != "cuda":
                devs = [dev] * n
            if n > 1 and len(devs) >= n:
                mesh = Mesh(devs[:n], ("frame",))
                print(f"frame-parallel over {n} devices", file=sys.stderr)
        search = WavefrontSearch(cfg, mesh=mesh, device=(
            args.device if mesh is None else None))
    else:
        from ..spec.encoder import ScalarEncoder
        search = ScalarEncoder(cfg)        # host only: --device unused
    enc = Encoder(cfg, search=search)

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    frames = yuv.read_yuv420(fin, w, h, args.num_pictures)
    if fin is not sys.stdin.buffer:
        fin.close()
    if not frames:
        print("error: no input frames", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    dt = time.perf_counter() - t0

    fout = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    fout.write(stream)
    if fout is not sys.stdout.buffer:
        fout.close()
    if args.reconst:
        yuv.write_yuv420(args.reconst, recons)
    print(f"encoded {len(frames)} pictures, {len(stream)} bytes, "
          f"{len(frames) / dt:.3f} fps", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
