"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

#: device memory bytes per second
BYTES_PER_S = 3.35e12
#: f32 operations per second outside the tensor cores (TF32 off)
F32_FLOPS = 67e12
#: bf16 operations per second on the tensor cores, dense
BF16_FLOPS = 989e12
#: device memory, bytes
MEMORY_BYTES = 80e9
