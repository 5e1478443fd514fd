"""The fake TPU node agent (counterpart of yoda_tpu/agent)."""
