"""Scalar NumPy golden model of the VVC intra coding path.

Bit-exact integer implementations of reference-sample handling, intra
prediction (PLANAR/DC/angular/PDPC/CCLM), DCT-II/DST-VII/DCT-VIII transforms,
and (dependent) quantization. This is the oracle the JAX/Pallas kernels are
golden-tested against, and the reconstruction model shared by the encoder's
RD search and the conformance decoder.
"""
