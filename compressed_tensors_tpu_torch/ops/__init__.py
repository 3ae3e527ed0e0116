"""Compute ops of the port: the int32 codec, quantization math, quantized
linear algebra, projection fusion and the kernels."""
