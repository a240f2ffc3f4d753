"""One IPO Adam step (zeroshot/ipo.py) for every row: kernel #4 and its
plain version.

The kernel is `csrc/ipo_step.cu` (its header says what bounds it and how it
is laid out). Both versions take the step in closed form, as autograd's
gradient of the IPO loss would give it: the quaternion rotation with its
2/|q|^2 factor, the clamped translation scale, the pinhole projection, the
L1 residual of every key (abs backward is sign, 0 at 0; clamp backward
passes where min <= s <= max, bounds included), then optax's Adam on each
learned leaf at the step counter's row of the corrections table. Both
update the carry's params and moments in place and write each row's L1 sum
(at the step's entry parameters) into the carry's loss, [B]; `group_loss`
reduces it to the sum of per-group means once, after the scan.

`pack` lays the step's constants out [5 * keys + 12, B], once a solve.
`ipo_step` launches the kernel for CUDA tensors and takes the plain version
(`ipo_step_reference`, the kernel's arithmetic op for op, in the kernel's
order, so that the two agree bit for bit) only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.utils import compiled

# threads a row in the kernel: key j on lane j % LANES, partial sums met as
# ((l0 + l1) + (l2 + l3))
LANES = 4
AXES = "xyz"

# steps of the CUDA kernel; one a launch, counted on each replay of a CUDA
# graph that holds it (utils/compiled.py)
launch_counts = {"ipo_step": 0}
compiled.register_counters(launch_counts)


def reset_launch_counts() -> None:
    launch_counts["ipo_step"] = 0


def pack(pose: torch.Tensor, target: torch.Tensor, t: torch.Tensor,
         k: torch.Tensor) -> torch.Tensor:
    """The step's constants [5 * keys + 12, B]: per key the root-relative
    point (3) and its observed pixel (2), then the translation T (3) and the
    intrinsics K (9, row-major). pose [B, keys, 3], target [B, keys, 2], t
    [B, 1, 3], k [B, 3, 3]."""
    b, keys = pose.shape[:2]
    per_key = torch.cat([pose, target], -1).permute(1, 2, 0).reshape(5 * keys, b)
    return torch.cat([per_key, t.reshape(b, 3).T, k.reshape(b, 9).T]).contiguous()


def group_loss(row_loss: torch.Tensor, n_groups: int, keys: int) -> torch.Tensor:
    """The IPO loss from the rows' L1 sums [B]: the sum over the folded
    groups of each group's mean absolute residual."""
    rows = row_loss.reshape(n_groups, -1)
    return (rows.sum(1) / (rows.shape[1] * keys * 2)).sum()


def _leaves(params: dict) -> list:
    """The learned leaves' names in the kernel's order: w, x, y, z, scale
    (an axis that is not learned: None)."""
    return (["rot_vect"] + [f"rot_vect_{a}" if f"rot_vect_{a}" in params else None
                            for a in AXES] + ["scale"])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _l1_sign(r: torch.Tensor, weight: float) -> torch.Tensor:
    """weight times abs's derivative at r (0 at 0), in r's dtype."""
    wt = torch.full_like(r, weight)
    return torch.where(r > 0, wt, torch.where(r < 0, -wt, torch.zeros_like(r)))


def ipo_step_reference(consts: torch.Tensor, carry: dict, corrections: torch.Tensor,
                       counter: torch.Tensor, *, weight: float, lr: float, lo: float, hi: float,
                       b1: float, b2: float, eps: float) -> None:
    """Plain PyTorch version of kernel #4: one step of every row, in place
    on carry's params, mu and nu ([B, 1] each; scale [B, 1, 1]), the rows'
    L1 sums into carry["loss"] [B]. The corrections table holds the
    reciprocals of Adam's bias corrections on CUDA, which the step
    multiplies by, and the corrections themselves on the CPU, which it
    divides by (ipo.adam_corrections)."""
    params, mu, nu = carry["params"], carry["mu"], carry["nu"]
    names = _leaves(params)
    w = params["rot_vect"].view(-1)
    zero = torch.zeros_like(w)
    v = [zero if n is None else params[n].view(-1) for n in names[1:4]]
    s = params["scale"].view(-1)
    keys = (consts.shape[0] - 12) // 5
    norm = ((w * w + v[0] * v[0]) + v[1] * v[1]) + v[2] * v[2]
    rn = torch.reciprocal(norm)
    f = rn * 2.0
    t = consts[5 * keys:5 * keys + 3]
    tt = [t[i] * s.clamp(lo, hi) for i in range(3)]
    k = consts[5 * keys + 3:]

    zeros = [torch.zeros_like(w) for _ in range(9)]
    lanes = [list(zeros) for _ in range(LANES)]  # sg0-2, gr, gc1, gv0-2, loss
    for j in range(keys):
        p = consts[5 * j:5 * j + 3]
        tu, tv = consts[5 * j + 3], consts[5 * j + 4]
        a = _cross(v, p)
        b = _cross(v, a)
        r = [w * a[i] + b[i] for i in range(3)]
        x = [(p[i] + f * r[i]) + tt[i] for i in range(3)]
        pa, pb, pc = (_dot(k[3 * i:3 * i + 3], x) for i in range(3))
        rc = torch.reciprocal(pc)
        u, vv = pa * rc, pb * rc
        ru, rv = u - tu, vv - tv
        eu, ev = _l1_sign(ru, weight), _l1_sign(rv, weight)
        ga, gb = eu * rc, ev * rc
        gc = -((eu * u + ev * vv) * rc)
        g = [(ga * k[i] + gb * k[3 + i]) + gc * k[6 + i] for i in range(3)]
        vp, gv = _dot(v, p), _dot(g, v)
        gp2 = _dot(g, p) * 2.0
        q = _cross(p, g)
        terms = g + [_dot(g, r), _dot(g, a)] + [
            ((w * q[i] + g[i] * vp) + p[i] * gv) - gp2 * v[i] for i in range(3)]
        acc = lanes[j % LANES]
        for i, term in enumerate(terms):
            acc[i] = acc[i] + term
        acc[8] = (acc[8] + ru.abs()) + rv.abs()
    sg0, sg1, sg2, gr, gc1, gv0, gv1, gv2, loss = (
        (lanes[0][i] + lanes[1][i]) + (lanes[2][i] + lanes[3][i]) for i in range(9))

    carry["loss"].copy_(loss)
    m2 = ((gr * f) * rn) * 2.0
    inside = (s >= lo) & (s <= hi)
    grads = [f * gc1 - m2 * w] + [f * gi - m2 * vi for gi, vi in zip((gv0, gv1, gv2), v)] + [
        torch.where(inside, _dot((sg0, sg1, sg2), t), torch.zeros_like(s))]
    c1, c2 = corrections.index_select(0, counter).reshape(2).unbind(0)
    for name, g in zip(names, grads):
        if name is None:
            continue
        p, m_, v_ = params[name].view(-1), mu[name].view(-1), nu[name].view(-1)
        m = m_ * b1 + g * (1 - b1)
        vv = v_ * b2 + (g * g) * (1 - b2)
        if corrections.is_cuda:
            upd = (m * c1) / (torch.sqrt(vv * c2) + eps)
        else:
            upd = (m / c1) / (torch.sqrt(vv / c2) + eps)
        m_.copy_(m)
        v_.copy_(vv)
        p.copy_(p - upd * lr)


_lib = None


def load_library() -> ctypes.CDLL:
    """Kernel #4's library, built at first use. Raises when CUDA or nvcc is
    missing; there is no fallback."""
    global _lib
    if _lib is None:
        lib = build.load("ipo_step")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.zedo_ipo_step.argtypes = [ptr, i32, i32] + [ptr] * 18 + [f32] * 9 + [ptr]
        lib.zedo_ipo_step.restype = i32
        _lib = lib
    return _lib


def check_operands(consts: torch.Tensor, carry: dict, corrections: torch.Tensor,
                   counter: torch.Tensor):
    """Device, dtype, shape and contiguity of a kernel call's operands."""
    dev, f32 = consts.device, torch.float32
    if consts.dim() != 2 or consts.shape[0] < 17 or (consts.shape[0] - 12) % 5:
        raise ValueError(f"consts: want [5 * keys + 12, B], got {tuple(consts.shape)}")
    b = consts.shape[1]
    if consts.dtype != f32 or consts.device.type != "cuda" or not consts.is_contiguous():
        raise ValueError(f"consts: want contiguous float32 on CUDA, got {consts.dtype} on "
                         f"{consts.device}")
    for part in ("params", "mu", "nu"):
        for name, leaf in carry[part].items():
            if (leaf.device != dev or leaf.dtype != f32 or leaf.numel() != b
                    or not leaf.is_contiguous()):
                raise ValueError(f"{part}[{name}]: want {b} contiguous float32 on {dev}, got "
                                 f"{leaf.dtype} {tuple(leaf.shape)} on {leaf.device}")
    loss = carry["loss"]
    if loss.device != dev or loss.dtype != f32 or tuple(loss.shape) != (b,):
        raise ValueError(f"loss: want float32 ({b},) on {dev}, got {loss.dtype} "
                         f"{tuple(loss.shape)} on {loss.device}")
    if (corrections.device != dev or corrections.dtype != f32 or corrections.dim() != 2
            or corrections.shape[1] != 2 or not corrections.is_contiguous()):
        raise ValueError(f"corrections: want contiguous float32 [iterations, 2] on {dev}")
    if counter.device != dev or counter.dtype != torch.int64 or counter.numel() != 1:
        raise ValueError(f"counter: want one int64 on {dev}")


def ipo_step(consts: torch.Tensor, carry: dict, corrections: torch.Tensor,
             counter: torch.Tensor, *, weight: float, lr: float, lo: float, hi: float,
             b1: float, b2: float, eps: float) -> None:
    """One IPO Adam step of every row, in place on the carry (see
    `ipo_step_reference`). CPU tensors take the plain version; CUDA tensors
    launch the kernel (float32 only) or raise."""
    scalars = dict(weight=weight, lr=lr, lo=lo, hi=hi, b1=b1, b2=b2, eps=eps)
    if consts.device.type == "cpu":
        return ipo_step_reference(consts, carry, corrections, counter, **scalars)
    if consts.device.type != "cuda":
        raise ValueError(f"ipo_step: unsupported device {consts.device}")
    lib = load_library()
    check_operands(consts, carry, corrections, counter)
    params, mu, nu = carry["params"], carry["mu"], carry["nu"]
    leaves = []
    for name in _leaves(params):
        leaves += ([0, 0, 0] if name is None
                   else [params[name].data_ptr(), mu[name].data_ptr(), nu[name].data_ptr()])
    err = lib.zedo_ipo_step(
        consts.data_ptr(), consts.shape[1], (consts.shape[0] - 12) // 5, *leaves,
        corrections.data_ptr(), counter.data_ptr(), carry["loss"].data_ptr(), weight, lr, lo, hi,
        b1, 1 - b1, b2, 1 - b2, eps, torch.cuda.current_stream(consts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"IPO step kernel launch failed: CUDA error {err}")
    launch_counts["ipo_step"] += 1
