"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit): the rate of each
precision's products, the HBM3 bandwidth, and the bytes of an element."""
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
         "tf32": 495e12, "float8": 1979e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "tf32": 4,
         "float8": 1, "int8": 1}
