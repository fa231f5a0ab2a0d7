"""PyTorch kernels of the port: batched intra prediction (all modes as
exact f32 matmuls), integer DCT-II, dependent quantization, and the two
hand-written CUDA scans (greedy dep-quant K2, trellis Viterbi K1).
Every function is held bit-exact against its `wrenc_tpu.kernels`
counterpart by the tests."""
