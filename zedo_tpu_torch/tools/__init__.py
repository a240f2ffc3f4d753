"""Command-line tools of the port (`python -m zedo_tpu_torch.tools.<name>`):
bench_kernel, validate_dtype, convert_checkpoint."""
