"""The in-memory fake API server and the informer cache (counterpart of
yoda_tpu/cluster)."""
