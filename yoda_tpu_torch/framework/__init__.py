"""Scheduling framework: extension points, cycle state, queue, runtime and
loop (counterpart of yoda_tpu/framework)."""
