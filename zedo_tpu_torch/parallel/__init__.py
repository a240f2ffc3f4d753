"""Multi-GPU data and tensor parallelism (port of zedo_tpu/parallel/): one
process per GPU under torch.distributed, with JAX's mesh axes and results.

`mesh` builds the process group and the data x model mesh, `collectives`
runs the collectives over its axes, `tensor_parallel` shards the ScoreMLP
over the model axis and `multiprocess_check` runs the two-process checks;
utils.rng gives a rank the random draws of the global batch."""
