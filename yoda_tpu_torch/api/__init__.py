"""API types, quantities and pod-label requests (counterpart of yoda_tpu/api)."""
