from .decode import Decoder, decode_annexb
