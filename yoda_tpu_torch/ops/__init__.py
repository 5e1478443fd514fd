"""The fleet arrays, the fleet evaluation and its CUDA kernel (counterpart
of yoda_tpu/ops)."""
