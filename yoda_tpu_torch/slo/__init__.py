"""SLO targets (counterpart of yoda_tpu/slo)."""
