"""zedo_tpu_torch: the ZeDO zero-shot 3D pose solver in PyTorch for NVIDIA
Hopper GPUs.

A port of the JAX package `zedo_tpu`, which stays the reference. Modules
keep `zedo_tpu`'s layout and names. The fused ScoreMLP forward of the OIL
loop runs in a hand-written CUDA kernel (ops/kernels/score_kernel.py,
csrc/score_mlp.cu); its split variant, the whole forward in one launch, is
a second one (ops/kernels/score_kernel_split.py, csrc/score_mlp_split.cu),
run by tools/bench_kernel.py --split. The batch CLIs (run/opt_main.py,
run/inference.py) read a dataset (data/), solve it and score it with
MPJPE and PA-MPJPE on the card (data/evaluation.py, ops/procrustes.py).
On several GPUs (parallel/) the solves, the serving estimator and the
train step run one process per GPU under torch.distributed. Entry points run on `cuda` unless the caller passes `device="cpu"`. The
package imports torch and numpy, never jax.
"""
