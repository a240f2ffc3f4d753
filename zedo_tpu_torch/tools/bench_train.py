"""Training throughput: the train step (loss, backward, clip, Adam, EMA) of
the full-size ScoreMLP (hidden 1024, embed 512, 2 blocks, dropout on) at
the reference's batch sizes, in fp32 and in bf16 mixed precision.

    python -m zedo_tpu_torch.tools.bench_train [--steps 50] [--rows 5000,50000]
        [--dtype fp32|bf16|both] [--device cuda]

Port of tools/bench_train.py (its `--rbg` picks a JAX random number
generator and has no counterpart). Times come from CUDA events around
`--steps` steps after two warm-up steps; on the card a profile of three more
steps gives the device's busy share of a step (the sum of its kernels'
times over the wall-clock) and its kernels by time. Prints one line per
dtype and batch size, ms per step and rows (poses) per second, and on the
card the step's most expensive kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zedo_tpu_torch.diffusion import losses as losses_lib
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.presets import Config
from zedo_tpu_torch.utils.config import resolve_device

PROFILED_STEPS = 3
TOP_KERNELS = 8


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train-step throughput")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--rows", type=str, default="5000,50000",
                        help="comma-separated batch sizes (infant and adult defaults)")
    parser.add_argument("--dtype", type=str, default="both", choices=["fp32", "bf16", "both"])
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def _profile(step, dev):
    """(device busy time of PROFILED_STEPS steps over their wall-clock,
    [(kernel name, ms a step)] of the TOP_KERNELS longest kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3 / PROFILED_STEPS)
               for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms in kernels) * PROFILED_STEPS / 1e3
    return busy / wall, sorted(kernels, key=lambda k: -k[1])[:TOP_KERNELS]


def main(argv=None) -> list[dict]:
    """Run the benchmark; returns one record per dtype and batch size."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = score_mlp.ScoreMLPConfig()  # full size: hidden 1024, embed 512
    optim = Config(optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8, warmup=5000, grad_clip=1.0,
                   weight_decay=0)
    optimizer = losses_lib.get_optimizer(Config(optim=optim))
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=1.0)

    def model_apply(p, x, labels, cond, msk, train=False, generator=None):
        return score_mlp.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

    rng = np.random.RandomState(0)
    dtypes = ["fp32", "bf16"] if args.dtype == "both" else [args.dtype]
    records = []
    for dtype in dtypes:
        apply = losses_lib.mixed_precision_apply(model_apply) if dtype == "bf16" else model_apply
        step_fn = losses_lib.get_step_fn(sde, apply, optimizer, train=True, reduce_mean=True)
        for rows in map(int, args.rows.split(",")):
            params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
            state = losses_lib.init_train_state(params, optimizer, ema_decay=0.9999)
            data = torch.as_tensor(rng.randn(rows, 17, 3).astype(np.float32) * 0.3, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)

            def step():
                return step_fn(state, gen, data)[1]

            for _ in range(2):  # warm-up
                step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.steps):
                    loss = step()
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / args.steps
            else:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    loss = step()
                ms = (time.perf_counter() - t0) * 1e3 / args.steps
            final = float(loss)
            if not np.isfinite(final):
                raise RuntimeError(f"{dtype} batch {rows}: loss {final}")
            busy, top = _profile(step, dev) if dev.type == "cuda" else (None, [])
            record = {"dtype": dtype, "rows": rows, "ms_per_step": ms,
                      "rows_per_s": rows / ms * 1e3, "loss": final, "device_busy_share": busy,
                      "top_kernels_ms": top}
            busy_note = f", device busy {busy:.3f}" if busy is not None else ""
            print(f"{dtype} batch {rows:>6}: {ms:8.3f} ms/step  {record['rows_per_s'] / 1e6:6.3f}M "
                  f"poses/s  (loss {final:.4f}{busy_note})", flush=True)
            for name, kernel_ms in top:
                print(f"    {kernel_ms:8.3f} ms  {name[:100]}", flush=True)
            records.append(record)
    return records


if __name__ == "__main__":
    main()
