"""Kernel #3's share of its roofline bound in the adapter's batch solves:
the least time of a forward on the products the kernel executes
(roofline_control.kernel_bound_s) over kernel #3's device time a forward,
its kernels found by name, its forwards from the program's counter over the
traced units (drivers/batch_solve_control.py); None for a program without
kernel #3."""
from perfbench import roofline_control

# kernel #3's kernels by name in the device trace (csrc/score_mlp_control.cu)
KERNEL3 = ("control_layer", "control_input_bf16")


def read(run):
    forwards = getattr(run, "control_forwards_traced", 0)
    if run.traced is None or not forwards:
        return None
    seconds = run.traced.device_seconds(*KERNEL3)
    if seconds <= 0:
        return None
    bound, _ = roofline_control.kernel_bound_s(run.rows_per_forward, run.config["model"])
    return 100.0 * bound / (seconds / forwards)
