"""Command-line tools of the port (`python -m zedo_tpu_torch.tools.<name>`):
bench_kernel, validate_dtype, convert_checkpoint, bench_train, bench_serving,
make_clusters, make_trained_fixture, repeat_check."""
