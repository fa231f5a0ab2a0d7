from .loader import (available, chroma_stage_a_native, commit_frames_native,
                     commit_frames_tree_native, cu_ranks_native,
                     decode_slice_native, decode_supported,
                     encode_slice_native, encode_slice_wpp_native,
                     greedy_quant_native, trellis_quant_native,
                     wpp_supported)
