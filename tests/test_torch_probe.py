"""Kernel #1's decomposition probes (zedo_tpu_torch/ops/kernels/
score_kernel_probe.py): each variant's plain version against JAX's own probe
body, taken from tools/bench_kernel.py's source, put in place of the Pallas
kernel's `_gn_silu` and run in interpret mode; the wrapper on the CPU; the
gn_bcast_vpu kernel's fragment layout; `bench_kernel --probe` on the CPU. The
CUDA kernels are held against the plain versions in tests/test_torch_gpu.py."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.ops.pallas import score_kernel as jsk
from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_probe as tprobe
from zedo_tpu_torch.tools import bench_kernel
from zedo_tpu_torch.utils.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, EMBED, ROWS = 256, 128, 256  # 32 GroupNorm groups, as the probe bodies assume


def _jax_probes():
    """{variant: JAX body}, in the order of the probe loop of
    tools/bench_kernel.py's `main`, from its source: the loop's (name, fn)
    pairs, each fn a function nested in `main` (exec'd with jax and jnp) or
    `orig`, which `main` binds to the shipped `_gn_silu`."""
    with open(os.path.join(REPO, "tools", "bench_kernel.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = {n.name: n for n in ast.walk(main) if isinstance(n, ast.FunctionDef)}
    loops = [n for n in ast.walk(main) if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)
             and all(isinstance(e, ast.Tuple) and len(e.elts) == 2
                     and isinstance(e.elts[0], ast.Constant) and isinstance(e.elts[1], ast.Name)
                     for e in n.iter.elts)]
    assert len(loops) == 1
    pairs = [(e.elts[0].value, e.elts[1].id) for e in loops[0].iter.elts]
    orig = [n for n in ast.walk(main) if isinstance(n, ast.Assign)
            and [t.id for t in n.targets if isinstance(t, ast.Name)] == ["orig"]]
    assert len(orig) == 1 and ast.unparse(orig[0].value) == "sk._gn_silu"
    module = ast.Module(body=[defs[fn] for _, fn in pairs if fn != "orig"], type_ignores=[])
    namespace = {"jax": jax, "jnp": jnp}
    exec(compile(ast.fix_missing_locations(module), "tools/bench_kernel.py", "exec"), namespace)
    return {name: jsk._gn_silu if fn == "orig" else namespace[fn] for name, fn in pairs}


@pytest.fixture(scope="module")
def weights():
    jcfg = jsm.ScoreMLPConfig(hidden_dim=HIDDEN, embed_dim=EMBED)
    tcfg = tsm.ScoreMLPConfig(hidden_dim=HIDDEN, embed_dim=EMBED)
    jparams = jsm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    # JAX's probe: pack_weights(params, cfg), bf16 weights and GroupNorm statistics
    jpacked = jsk.pack_weights(jparams, jcfg)
    tpacked = tsk.pack_weights(tparams, tcfg)
    jvecs = jsk.step_vectors(jpacked, jsm.time_embedding(jparams, jcfg,
                                                         jnp.full((1,), 42.0))[0])
    tvecs = tsk.step_vectors(tpacked, tsm.time_embedding(tparams, tcfg,
                                                         torch.full((1,), 42.0))[0])
    return jpacked, jvecs, tpacked, tvecs


def test_variants_are_jax_probes_in_jax_order():
    assert tuple(_jax_probes()) == tprobe.PROBE_VARIANTS
    assert tuple(tprobe.EPILOGUES) == tprobe.PROBE_VARIANTS


@pytest.mark.parametrize("variant", tprobe.PROBE_VARIANTS)
def test_plain_probe_matches_jax_probe_body(variant, weights, monkeypatch):
    """The plain version against the Pallas kernel (interpret mode) with
    JAX's probe body in place of `_gn_silu` (monkeypatch.setattr), through
    `fused_score_forward.__wrapped__` as the TPU tool runs it (the jitted
    function would reuse the first variant's trace). Tolerance: that of
    test_plain_forward_matches_pallas_bf16, the median of |got - want| /
    (|want| + 1e-2) below 0.02 (the same products on the same bf16 operands;
    the f32 sums' order can flip a bf16 rounding between layers), and the
    tighter bounds below."""
    jpacked, jvecs, tpacked, tvecs = weights
    x = np.random.RandomState(5).randn(ROWS, 51).astype(np.float32)
    x_pad = jsk.pad_rows(jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - 51))), tile=128)

    def jax_forward(body):
        monkeypatch.setattr(jsk, "_gn_silu", body)
        return np.asarray(jsk.fused_score_forward.__wrapped__(
            x_pad, jpacked, jvecs, tile=128, interpret=True))[:ROWS, :51]

    def median_err(got, want):
        return np.median(np.abs(got - want) / (np.abs(want) + 1e-2))

    bodies = _jax_probes()
    want = jax_forward(bodies[variant])
    got = tprobe.fused_score_forward_probe(torch.from_numpy(x), tpacked, tvecs, variant).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = median_err(got, want)
    assert err < 0.02, err
    # That tolerance admits a neighbouring variant (full and bf16_silu, gn_vpu
    # and gn_bcast_vpu are 3e-3 to 7e-3 apart), so each case is also held to
    # what tells them apart. An f32 body computes JAX's function up to the
    # order of f32 sums (a median of ~1e-7 here). bf16_silu's bf16 chain is
    # rounded at every step in torch, while XLA on the CPU may keep some of
    # its steps in f32 (~4e-3 apart): it has to be nearer its own body than
    # the shipped one.
    if variant == "bf16_silu":
        assert err < median_err(got, jax_forward(bodies["full"])), err
    else:
        assert err < 1e-5, err


def test_wrapper_rejects_what_it_does_not_take_and_runs_plain_on_the_cpu(weights):
    _, _, packed, vecs = weights
    x = torch.from_numpy(np.random.RandomState(6).randn(9, 51).astype(np.float32))
    with pytest.raises(ValueError, match="unknown probe variant"):
        tprobe.fused_score_forward_probe(x, packed, vecs, "no_such_variant")
    with pytest.raises(ValueError, match="unknown probe variant"):
        tprobe.fused_score_forward_probe_reference(x, packed, vecs, "gn_silu")
    # a tensor that is not on the CPU never reaches the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        tprobe.fused_score_forward_probe(torch.zeros(4, 51, device="meta"), packed, vecs, "full")
    # the probe bodies fix 32 GroupNorm groups
    cfg16 = tsm.ScoreMLPConfig(hidden_dim=HIDDEN, embed_dim=EMBED, group_norm_groups=16)
    p16 = tsk.pack_weights(tsm.init_params(torch.Generator().manual_seed(0), cfg16,
                                           device="cpu"), cfg16)
    with pytest.raises(ValueError, match="32 GroupNorm groups"):
        tprobe.fused_score_forward_probe(x, p16, vecs, "full")
    before = dict(tprobe.launch_counts), tsk.launch_counts["fused_score_forward"]
    for variant in tprobe.PROBE_VARIANTS:
        got = tprobe.fused_score_forward_probe(x, packed, vecs, variant)
        want = tsk.fused_score_forward_reference(x, packed, vecs, tprobe.EPILOGUES[variant])
        assert torch.equal(got, want)
    # the shipped epilogue is `full`, and the kernel's plain version is it
    assert torch.equal(tprobe.fused_score_forward_probe(x, packed, vecs, "full"),
                       tsk.fused_score_forward(x, packed, vecs))
    assert (dict(tprobe.launch_counts), tsk.launch_counts["fused_score_forward"]) == before


def test_bcast_fragments_sum_each_group():
    """gn_bcast_vpu's statistics as the kernel lays them out (csrc/
    score_mlp.cuh: stage_ind, bcast_rstd), in numpy for one warp's 16 rows of
    a 128-column tile: the accumulators of 16 columns repacked as mma.sync
    m16n8k16 A fragments, `ind`'s 8 columns that hold the tile's groups as B
    (staged transposed, IND_LD words a row), and the product's D read back
    through the quad into each group's sum of squares / 32."""
    rng = np.random.RandomState(7)
    hidden, group = 1024, 32
    ind = np.zeros((hidden, 128), np.float32)
    for g in range(hidden // group):
        ind[g * group:(g + 1) * group, g] = 1.0 / group
    ind_ld = 128 // 2 + 4
    for col0 in (0, 128, 384, 896):
        v = rng.randn(16, 128).astype(np.float32)
        sq = v * v
        # stage_ind: sInd[n][k] = ind[col0 + k][nb + n], n-major, as 16-bit halves of words
        nb, n0 = (col0 // group) & ~7, (col0 // group) & 7
        s_ind = np.zeros((8, 2 * ind_ld), np.float32)
        s_ind[:, :128] = ind[col0:col0 + 128, nb:nb + 8].T
        d = np.zeros((32, 4))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # acc[4j + e]: row g (e < 2) or g + 8, column 8j + 2t + e % 2
            acc = np.array([sq[g + 8 * (e // 2), 8 * j + 2 * t + e % 2]
                            for j in range(16) for e in range(4)])
            for kb in range(8):
                j0, j1 = 8 * kb, 8 * kb + 4
                a_regs = (acc[j0:j0 + 2], acc[j0 + 2:j0 + 4], acc[j1:j1 + 2], acc[j1 + 2:j1 + 4])
                # the PTX A layout: regs 0/2 row g, 1/3 row g + 8; 2/3 columns + 8
                want = (sq[g, 16 * kb + 2 * t:16 * kb + 2 * t + 2],
                        sq[g + 8, 16 * kb + 2 * t:16 * kb + 2 * t + 2],
                        sq[g, 16 * kb + 8 + 2 * t:16 * kb + 8 + 2 * t + 2],
                        sq[g + 8, 16 * kb + 8 + 2 * t:16 * kb + 8 + 2 * t + 2])
                for got_r, want_r in zip(a_regs, want):
                    np.testing.assert_array_equal(got_r, want_r)
                # B words b[8kb] and b[8kb + 4] from sInd + n * IND_LD + t
                words = s_ind[g].reshape(-1, 2)
                b0, b1 = words[8 * kb + t], words[8 * kb + 4 + t]
                np.testing.assert_array_equal(b0, ind[col0 + 16 * kb + 2 * t:
                                                      col0 + 16 * kb + 2 * t + 2, nb + g])
                np.testing.assert_array_equal(b1, ind[col0 + 16 * kb + 8 + 2 * t:
                                                      col0 + 16 * kb + 8 + 2 * t + 2, nb + g])
        # D: lane (g, t) holds rows g, g + 8 at columns 2t, 2t + 1 of sq @ B
        prod = sq @ ind[col0:col0 + 128, nb:nb + 8]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            d[lane] = prod[g, 2 * t], prod[g, 2 * t + 1], prod[g + 8, 2 * t], prod[g + 8, 2 * t + 1]
        # each lane's rb[q][h], read from lane (lane & ~3) | (n >> 1), n = n0 + q
        for lane in range(32):
            g = lane // 4
            for q in range(128 // group):
                n = n0 + q
                src = (lane & ~3) | (n >> 1)
                for h in range(2):
                    var = d[src, 2 * h + (n & 1)]
                    want = sq[g + 8 * h, q * group:(q + 1) * group].mean()
                    np.testing.assert_allclose(var, want, rtol=1e-6)


def test_bench_kernel_probe_prints_the_variants_in_jax_order(capsys):
    """`bench_kernel --probe` on the CPU (plain versions): the kernel in both
    GroupNorm modes, then one line a variant in the TPU tool's order, and it
    returns there."""
    res = bench_kernel.main(["--probe", "--rows", "256", "--iters", "1", "--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("probe ")]
    names = [line.split(":")[0][len("probe "):] for line in lines]
    assert names == list(_jax_probes())
    assert all(line.endswith(" ms/step") for line in lines)
    assert list(res) == (["kernel gn=bf16", "kernel gn=f32"]
                         + [f"probe {v}" for v in tprobe.PROBE_VARIANTS])
    assert all(np.isfinite(ms) and ms > 0 for ms in res.values())
