"""CLI decoder of the port: decode an Annex-B stream to YUV.

    python -m wrenc_tpu_torch.tools.decode -i in.vvc -o out.yuv
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="wrenc-tpu VVC subset decoder")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--independent", action="store_true",
                    help="clean-room conformance oracle (not ported)")
    args = ap.parse_args(argv)
    if args.independent:
        raise NotImplementedError(
            "the clean-room conformance decoder is not ported to "
            "wrenc_tpu_torch yet (ROADMAP.md, 'Modules still to port')")

    from ..decoder import decode_annexb
    from . import yuv

    with open(args.input, "rb") as f:
        data = f.read()
    frames = decode_annexb(data)
    yuv.write_yuv420(args.output, frames)
    print(f"decoded {len(frames)} pictures", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
