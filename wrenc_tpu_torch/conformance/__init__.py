from .refdec import (ConformanceError, decode_annexb_independent,
                     split_annexb)

__all__ = ["ConformanceError", "decode_annexb_independent", "split_annexb"]
