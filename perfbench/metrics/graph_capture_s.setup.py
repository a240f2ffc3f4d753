"""Seconds of the program's CUDA graph warm-ups and captures (the span
zedo.capture, counted in `compiled.cache_info()["capture_s"]`). Nothing is
captured once the window starts, so the process's total, read after the
run, is the set-up's; a program without the counter gives None."""


def read(run):
    from zedo_tpu_torch.utils import compiled

    return compiled.cache_info().get("capture_s")
