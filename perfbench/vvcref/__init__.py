"""vvcref: the benchmark's frozen VVC decoder and scalar spec model.

NumPy only. `decoder.decode_annexb(stream, use_native=False)` is the
pure-Python conformance decoder (spec parsing, CABAC, reconstruction);
`spec/` holds the scalar integer models of intra prediction, the
transforms, quantization and availability; `core/` the tables and the
rate model's constants. See FROZEN.md.
"""
