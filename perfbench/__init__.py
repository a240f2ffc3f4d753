"""The benchmark of zedo_tpu_torch, the PyTorch and CUDA port: BENCHMARK.json's
cells, run by `python3 -m perfbench.run`. It imports neither JAX nor the JAX
package; the plain reference under `reference/` imports nothing of the port.
"""
