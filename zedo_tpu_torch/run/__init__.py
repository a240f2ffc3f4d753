"""Batch command-line entry points (port of zedo_tpu/run/)."""
