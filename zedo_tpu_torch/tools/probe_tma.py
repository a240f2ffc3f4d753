"""How fast the card's SMs take tiles in through TMA, measured by a kernel
that does nothing else (csrc/tma_probe.cu), on the card:

    python -m zedo_tpu_torch.tools.probe_tma [--reps 5] [--mb-per-block 48]

Each block keeps a ring of TMA box loads (boxes of box_rows x 64 bf16, 128-byte
rows under the 128-byte swizzle, the form of the score kernels' weight tiles)
in flight and a consumer thread hands each stage back as its box lands.
The first case is the split score kernel's weight stream (8 KB boxes of a
1024-column matrix, a ring of 13, one producer thread, one block an SM, all
blocks reading the same 8.4 MB, each starting at another column tile); every
other case changes one thing: the ring's depth, the box, the producer
threads, the blocks an SM holds, whether the blocks read the same region or
each its own (L2 holds either), whether a box is one contiguous piece of
memory. The table gives each case's time and its rate over all SMs and per
SM; the best rate is what a design that streams its operands can count on.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess

import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.utils.table import Table

SOURCE = build.CSRC / "tma_probe.cu"
SMEM_LIMIT = 232448  # dynamic shared memory of an H100 block
SHARED_ROWS = 4096  # rows of the region all blocks share: 8.4 MB at 1024 columns


@dataclasses.dataclass(frozen=True)
class Case:
    """One launch of the probe; the defaults are the split kernel's stream."""
    box_rows: int = 64
    stages: int = 13
    producers: int = 1
    blocks_per_sm: int = 1
    cols: int = 1024
    private_rows: int = 0  # rows of a block's own region; 0: all blocks read the same
    stagger: bool = True

    @property
    def box_bytes(self) -> int:
        return self.box_rows * 128

    def smem_bytes(self) -> int:
        """What a block asks for: its ring, or so much that an SM holds
        only `blocks_per_sm` of them."""
        need = 1024 + self.stages * self.box_bytes + 2 * 64 * 8
        return max(need, SMEM_LIMIT // self.blocks_per_sm - 1024 * (self.blocks_per_sm > 1))

    def label(self) -> str:
        region = (f"own {self.private_rows * self.cols * 2 // 1024} KB" if self.private_rows
                  else "same region")
        return (f"box {self.box_bytes // 1024} KB, ring {self.stages}, {self.producers} "
                f"producer(s), {self.blocks_per_sm} block(s)/SM, {self.cols} cols, {region}"
                + ("" if self.stagger else ", no stagger"))


BASE = Case()
CASES = [
    BASE,
    *(dataclasses.replace(BASE, stages=s) for s in (2, 4, 8, 26)),
    *(dataclasses.replace(BASE, box_rows=r, stages=s)
      for r, s in ((32, 26), (128, 6), (256, 3), (128, 13), (256, 6))),
    *(dataclasses.replace(BASE, producers=n) for n in (2, 4)),
    dataclasses.replace(BASE, blocks_per_sm=2, stages=6),
    dataclasses.replace(BASE, blocks_per_sm=2, stages=13),
    dataclasses.replace(BASE, blocks_per_sm=4, stages=6),
    dataclasses.replace(BASE, stagger=False),
    dataclasses.replace(BASE, private_rows=64),
    dataclasses.replace(BASE, private_rows=64, blocks_per_sm=2, stages=13),
    # a box that is one contiguous piece of memory: a 64-column matrix
    dataclasses.replace(BASE, cols=64),
    dataclasses.replace(BASE, cols=64, box_rows=256, stages=6),
    dataclasses.replace(BASE, cols=64, box_rows=256, stages=3, blocks_per_sm=2),
]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mb-per-block", type=float, default=48.0,
                    help="what a block takes in per launch (the split kernel's SM: 52 MB)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_tma builds and times a CUDA kernel: it needs the card")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    out_dir = build.BUILD_ROOT / "probe_tma"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libzedo_tma_probe.so"
    nvcc = subprocess.run(build.nvcc_command(SOURCE, so), capture_output=True, text=True)
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{nvcc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.zedo_tma_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2
    lib.zedo_tma_probe_blocks_per_sm.argtypes = [ctypes.c_int]

    table = Table(["case", "blocks", "GB a launch", "ms", "TB/s", "GB/s per SM", "ns a box",
                   "producer cycles a box: free stage / announce / TMA / loop"])
    results = []
    for case in CASES:
        blocks = sms * case.blocks_per_sm
        smem = case.smem_bytes()
        held = lib.zedo_tma_probe_blocks_per_sm(smem)
        if held != case.blocks_per_sm:
            raise RuntimeError(f"{case.label()}: an SM holds {held} blocks of {smem} bytes")
        # the same bytes in all: 8.4 MB shared, or a block's own rows
        rows = blocks * case.private_rows or SHARED_ROWS * 1024 // case.cols
        region = case.private_rows or rows
        w = torch.zeros((rows, case.cols), dtype=torch.bfloat16, device=dev)
        boxes = int(args.mb_per_block * 1e6 / case.blocks_per_sm) // case.box_bytes
        stream = torch.cuda.current_stream(dev).cuda_stream

        cycles = torch.zeros((blocks, 4), dtype=torch.int64, device=dev)

        def launch(timed=False):
            err = lib.zedo_tma_probe(w.data_ptr(), rows, case.cols, case.box_rows, case.stages,
                                     case.producers, boxes, region, int(bool(case.private_rows)),
                                     int(case.stagger), blocks, smem,
                                     cycles.data_ptr() if timed else None, stream)
            if err != 0:
                raise RuntimeError(f"{case.label()}: CUDA error {err}")

        launch()  # brings the region into L2
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.reps
        # once more with the first producer thread's clock readings
        launch(timed=True)
        per_box = cycles.double().mean(0) / (boxes / case.producers)
        n_bytes = blocks * boxes * case.box_bytes
        results.append((case, ms, n_bytes, per_box.tolist()))
        table.add_row([case.label(), blocks, f"{n_bytes / 1e9:.3f}", f"{ms:.4f}",
                       f"{n_bytes / ms / 1e9:.3f}", f"{n_bytes / ms / 1e6 / sms:.2f}",
                       f"{ms * 1e6 / boxes:.0f}", " / ".join(f"{c:.0f}" for c in per_box.tolist())])
    print(table, flush=True)
    print(f"({torch.cuda.get_device_name(dev)}, {sms} SMs)", flush=True)
    return results


if __name__ == "__main__":
    main()
