"""Microbenchmark of the fused score-kernel variants against the unfused
forward, on the card: ms per step at the production batch (N*S rows) over a
dependency chain of steps, in both GroupNorm statistics modes.

    python -m zedo_tpu_torch.tools.bench_kernel [--rows 44300] [--iters 200]
        [--split] [--device cuda]

Port of tools/bench_kernel.py (its kernel harness; the --probe variants,
rejected TPU experiments, are not ported). Variants:
  * kernel gn=bf16|f32: `fused_score_forward` (csrc/score_mlp.cu) on the
    path its width takes, the wgmma kernel at the published width;
  * with --split, split tile=56 gn=bf16|f32: `fused_score_forward_split`
    (csrc/score_mlp_split.cu), the 56 rows of its block, and its max |diff|
    against the kernel on 1024 rows;
  * library chain bf16: bf16 torch.matmul calls with GroupNorm and SiLU as
    torch ops, the same function (a yardstick, never used by the port);
  * unfused bf16: score_mlp.apply_with_temb on bf16 weights.
On the card each step is timed with CUDA events; on the CPU (--device cpu,
the plain versions) with the host clock.
"""
from __future__ import annotations

import argparse
import time

import torch

from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops.kernels import score_kernel as sk
from zedo_tpu_torch.ops.kernels import score_kernel_split as split
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.utils.table import Table


def library_forward(x, packed, vecs):
    """The fused forward's function as a chain of bf16 torch.matmul calls
    with GroupNorm and SiLU as torch ops: x [B, C] f32 -> [B, C] f32."""
    b, c = x.shape
    io_pad, h = packed.w_pre.shape
    g = h // packed.group_size

    def gn_silu(v, row):
        vg = v.view(b, g, packed.group_size)
        xn = (vg * torch.rsqrt(vg.pow(2).mean(-1, keepdim=True) + sk.GN_EPS)).view(b, h)
        return torch.nn.functional.silu(xn * packed.gn_scale[row] + packed.gn_bias[row])

    def dense(a, w, row):
        return torch.matmul(a.to(torch.bfloat16), w).float() + vecs[row]

    hcur = gn_silu(dense(torch.nn.functional.pad(x, (0, io_pad - c)), packed.w_pre, 0), 0)
    for blk in range(2):
        h1 = gn_silu(dense(hcur, packed.w_b[2 * blk], 1 + 2 * blk), 1 + 2 * blk)
        hcur = hcur + gn_silu(dense(h1, packed.w_b[2 * blk + 1], 2 + 2 * blk), 2 + 2 * blk)
    return (torch.matmul(hcur.to(torch.bfloat16), packed.w_post).float()
            + packed.bias_post)[:, :c]


def step_ms(fn, x, iters: int) -> float:
    """ms per step of `iters` chained steps h <- fn(h) * 0.999 (each step
    waits for the one before), after one warm-up step."""
    out = fn(x)
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    h = x
    for _ in range(iters):
        h = fn(h) * 0.999
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        ms = (time.perf_counter() - t0) * 1e3 / iters
    if not (torch.isfinite(out).all() and torch.isfinite(h).all()):
        raise RuntimeError("non-finite output in the timed chain")
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=44300)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--split", action="store_true",
                    help="also time the split kernel and compare it with the kernel")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = score_mlp.ScoreMLPConfig()
    params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    params = tree_map(lambda a: a.to(torch.bfloat16), params)
    temb = score_mlp.time_embedding(params, cfg, torch.full((1,), 42.0, device=dev))[0]
    io = cfg.n_joints * cfg.joint_dim
    x = torch.randn(args.rows, io, generator=torch.Generator().manual_seed(1)).to(dev)

    results = {}
    packed = {}
    for gn_name, gn_dt in (("bf16", None), ("f32", torch.float32)):
        p = packed[gn_name] = sk.pack_weights(params, cfg, gn_dtype=gn_dt)
        vecs = sk.step_vectors(p, temb).contiguous()
        results[f"kernel gn={gn_name}"] = step_ms(
            lambda h, p=p, v=vecs: sk.fused_score_forward(h, p, v), x, args.iters)
        if args.split:
            results[f"split tile={split.tile_rows(cfg.hidden_dim)} gn={gn_name}"] = step_ms(
                lambda h, p=p, v=vecs: split.fused_score_forward_split(h, p, v), x, args.iters)
    vecs = sk.step_vectors(packed["bf16"], temb).contiguous()
    results["library chain bf16"] = step_ms(
        lambda h: library_forward(h, packed["bf16"], vecs), x, args.iters)
    results["unfused bf16"] = step_ms(
        lambda h: score_mlp.apply_with_temb(params, cfg, h.view(-1, cfg.n_joints, cfg.joint_dim)
                                            .to(torch.bfloat16), temb).float().view(-1, io),
        x, args.iters)

    table = Table(["variant", "ms/step"])
    for name, ms in results.items():
        table.add_row([name, f"{ms:.4f}"])
    print(table, flush=True)
    if args.split:
        xs = torch.randn(1024, io, generator=torch.Generator().manual_seed(3)).to(dev)
        a = split.fused_score_forward_split(xs, packed["bf16"], vecs)
        b = sk.fused_score_forward(xs, packed["bf16"], vecs)
        results["split_max_abs_diff"] = (a - b).abs().max().item()
        print(f"split max |diff| vs kernel: {results['split_max_abs_diff']:.3e}", flush=True)
    timed = {k: v for k, v in results.items() if k != "split_max_abs_diff"}
    best = min(timed, key=timed.get)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"\nBEST: {best} at {timed[best]:.4f} ms/step ({args.rows} rows, {kind})",
          flush=True)
    return results


if __name__ == "__main__":
    main()
