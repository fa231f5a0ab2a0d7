"""CLI decoder of the port: decode an Annex-B stream to YUV.

    python -m wrenc_tpu_torch.tools.decode -i in.vvc -o out.yuv \
        [--independent]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="wrenc-tpu VVC subset decoder")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--independent", action="store_true",
                    help="decode with the clean-room conformance oracle "
                         "(wrenc_tpu_torch.conformance) instead of the "
                         "shipped decoder")
    args = ap.parse_args(argv)

    from . import yuv

    with open(args.input, "rb") as f:
        data = f.read()
    if args.independent:
        from ..conformance import decode_annexb_independent
        frames = decode_annexb_independent(data)
    else:
        from ..decoder import decode_annexb
        frames = decode_annexb(data)
    yuv.write_yuv420(args.output, frames)
    print(f"decoded {len(frames)} pictures"
          + (" (independent oracle)" if args.independent else ""),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
