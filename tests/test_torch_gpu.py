"""Tests of the zedo_tpu_torch CUDA kernels; they need the card and skip
without one. This file imports no jax, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
from zedo_tpu_torch.ops.kernels import score_kernel_probe as tprobe
from zedo_tpu_torch.ops.kernels import score_kernel_split as tsplit

# max |kernel - plain|: the same bf16 operands, f32 sums in another order,
# which can flip a bf16 rounding between layers
TOL = 2e-2
GN = {"bf16": None, "f32": torch.float32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m gpu` on the card")
    return torch.device("cuda")


def _packed(dev, hidden, gn, embed=512, groups=32):
    tcfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed, group_norm_groups=groups)
    params = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=dev)
    packed = tsk.pack_weights(params, tcfg, dtype=torch.bfloat16, gn_dtype=GN[gn])
    temb = tsm.time_embedding(params, tcfg, torch.full((1,), 47.3, device=dev))[0]
    return packed, tsk.step_vectors(packed, temb).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
def test_cuda_kernel_takes_12_joints(cuda_device, gn):
    """SyRIP's 12 joints: x of 36 columns, padded to 64 for the first
    layer's loads, the post layer's first 36 columns written out."""
    tcfg = tsm.ScoreMLPConfig(n_joints=12, hidden_dim=1024, embed_dim=512)
    params = tsm.init_params(torch.Generator().manual_seed(0), tcfg, device=cuda_device)
    packed = tsk.pack_weights(params, tcfg, dtype=torch.bfloat16, gn_dtype=GN[gn])
    temb = tsm.time_embedding(params, tcfg, torch.full((1,), 47.3, device=cuda_device))[0]
    vecs = tsk.step_vectors(packed, temb).contiguous()
    gen = torch.Generator().manual_seed(2)
    for n in (10000, 129, 1):
        x = torch.randn(n, 36, generator=gen).to(cuda_device)
        got = tsk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert got.shape == (n, 36)
        assert (got - tsk.fused_score_forward_reference(x, packed, vecs)).abs().max().item() < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden,rows", [(1024, (4096, 1001, 129, 1)), (384, (2048,)),
                                         (768, (2048,)), (2048, (2048, 77)),
                                         (256, (2048, 130)), (128, (300,)), (512, (300,))])
def test_cuda_kernel_matches_plain_version(cuda_device, hidden, rows, gn):
    """The CUDA kernel against its plain version in both GroupNorm modes, on
    tile-aligned and ragged row counts: the wgmma kernel at the published
    width (groups of 32) and at groups of 4, 8, 16 and 64, the wmma kernel at
    the widths (384, 768) whose groups of 12 and 24 reduce through shared
    memory. Each
    width runs the path `kernel_path` names."""
    packed, vecs = _packed(cuda_device, hidden, gn)
    path = tsk.kernel_path(hidden, packed.group_size)
    gen = torch.Generator().manual_seed(1)
    for n in rows:
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        before = (tsk.launch_counts["fused_score_forward"], tsk.path_launches[path],
                  tsk.row_launches.get(n, 0))
        got = tsk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsk.launch_counts["fused_score_forward"] == before[0] + 1
        assert tsk.path_launches[path] == before[1] + 1
        assert tsk.row_launches[n] == before[2] + 1
        want = tsk.fused_score_forward_reference(x, packed, vecs)
        assert (got - want).abs().max().item() < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (128, 128, 128), (300, 1024, 256), (1, 64, 128)])
def test_wgmma_product_matches_matmul(cuda_device, m, k, n):
    """The wgmma kernel's product alone (TMA boxes, the 128-byte swizzle,
    the K-major A and MN-major B descriptors) against torch.matmul: exact
    bf16 products, f32 sums in another order."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(m, k, generator=gen).to(cuda_device).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen).to(cuda_device).to(torch.bfloat16)
    want = a.float() @ w.float()
    got = tsk.wgmma_product(a, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", tprobe.PROBE_VARIANTS)
def test_probe_kernel_matches_plain_version(cuda_device, variant):
    """Kernel #1 with each of the eight epilogue variants (the probe library)
    against its plain version at the published width, GroupNorm statistics
    in bf16, on 4,096 and a ragged 1,001 rows: TOL, bf16_silu twice that (it
    rounds to bf16 at three more places a layer). Its launches count under
    the variant, never under kernel #1's counters; an f32-statistics pack
    raises."""
    packed, vecs = _packed(cuda_device, 1024, "bf16")
    gen = torch.Generator().manual_seed(3)
    tol = 2 * TOL if variant == "bf16_silu" else TOL
    for n in (4096, 1001):
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        before = tprobe.launch_counts[variant], tsk.launch_counts["fused_score_forward"]
        got = tprobe.fused_score_forward_probe(x, packed, vecs, variant)
        torch.cuda.synchronize()
        assert (tprobe.launch_counts[variant], tsk.launch_counts["fused_score_forward"]) == (
            before[0] + 1, before[1])
        want = tprobe.fused_score_forward_probe_reference(x, packed, vecs, variant)
        assert got.shape == (n, 51) and torch.isfinite(got).all()
        assert (got - want).abs().max().item() < tol
    assert tprobe.load_library().zedo_score_mlp_probe_blocks_per_sm(
        tprobe.PROBE_VARIANTS.index(variant)) == 2
    pf, vf = _packed(cuda_device, 1024, "f32")
    with pytest.raises(ValueError, match="bf16 GroupNorm statistics"):
        tprobe.fused_score_forward_probe(x, pf, vf, variant)


@pytest.mark.gpu
def test_kernel_path_mirrors_the_library(cuda_device):
    lib = tsk.load_library()
    for hidden in range(128, 2049, 128):
        group = hidden // 32
        tile = tsk.column_tile(hidden, group)
        took = bool(lib.zedo_score_mlp_takes_wgmma(hidden, group, tile))
        assert took == (tsk.kernel_path(hidden, group) == "wgmma"), hidden
    assert lib.zedo_score_mlp_padded_input(51) == tsk.padded_input_columns(51)
    assert lib.zedo_score_mlp_wgmma_blocks_per_sm() == 2


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden,groups", [(1024, 32), (512, 32), (256, 32), (768, 24),
                                           (1024, 16), (128, 32)])
def test_split_kernel_matches_plain_version_and_kernel(cuda_device, hidden, groups, gn):
    """Kernel #2 against its plain version and against kernel #1 in both
    GroupNorm modes: at 2 to 16 channel tiles a layer (an odd count a
    warpgroup at hidden 768), at groups of 4, 8, 16, 32 and 64 channels, on a
    full grid and on ragged row counts (1, R - 1, R + 1 and 2R + 1)."""
    packed, vecs = _packed(cuda_device, hidden, gn, groups=groups)
    tile = tsplit.tile_rows(hidden)
    gen = torch.Generator().manual_seed(2)
    for n in (4096, 1001, 2 * tile + 1, tile + 1, tile - 1, 1):
        x = torch.randn(n, 51, generator=gen).to(cuda_device)
        want = tsplit.fused_score_forward_split_reference(x, packed, vecs)
        one = tsk.fused_score_forward(x, packed, vecs)
        before = tsplit.launch_counts["fused_score_forward_split"]
        got = tsplit.fused_score_forward_split(x, packed, vecs)
        torch.cuda.synchronize()
        assert tsplit.launch_counts["fused_score_forward_split"] == before + 1
        assert (got - want).abs().max().item() < TOL, n
        assert (got - one).abs().max().item() < TOL, n


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (100, 512, 64), (300, 1024, 256),
                                   (57, 1024, 1024), (1, 192, 64)])
def test_split_product_matches_matmul(cuda_device, m, k, n):
    """Kernel #2's transposed product alone (the weight tile as the MN-major
    A operand from the TMA ring, the rows as the K-major B operand written
    through the swizzle function) against
    torch.matmul: exact bf16 products, f32 sums in another order."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(m, k, generator=gen).to(cuda_device).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen).to(cuda_device).to(torch.bfloat16)
    want = a.float() @ w.float()
    got = tsplit.split_product(a, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 24, 64, 128])
def test_swizzle_function_matches_tma(cuda_device, rows):
    """The address function the epilogue writes the next layer's operand
    with, against a TMA load of the same matrix under the 128-byte swizzle,
    and both against the pure-Python mirror."""
    src = torch.randn(rows, 64, generator=torch.Generator().manual_seed(6))
    src = src.to(cuda_device).to(torch.bfloat16)
    by_tma, by_function = tsplit.swizzle_images(src)
    torch.cuda.synchronize()
    assert torch.equal(by_tma, by_function)
    mirror = torch.empty_like(by_tma)
    offsets = torch.tensor([tsplit.swizzle128(2 * i) // 2 for i in range(rows * 64)],
                           device=cuda_device)
    mirror[offsets] = src.view(-1)
    assert torch.equal(by_tma, mirror)


@pytest.mark.gpu
def test_split_tile_rows_mirror_the_library(cuda_device):
    lib = tsplit.load_library()
    for hidden in range(64, 2049, 64):
        assert lib.zedo_score_mlp_split_tile_rows(hidden) == tsplit.tile_rows(hidden), hidden
        if tsplit.tile_rows(hidden):
            stages = lib.zedo_score_mlp_split_stages(hidden)
            assert stages == tsplit.ring_stages(hidden) >= tsplit.MIN_STAGES
            assert lib.zedo_score_mlp_split_smem_bytes(hidden) == tsplit.smem_bytes(
                hidden, stages) <= tsplit.SMEM_LIMIT
    assert lib.zedo_score_mlp_split_smem_limit() == tsplit.SMEM_LIMIT


@pytest.mark.gpu
def test_kernels_raise_on_widths_they_cannot_hold(cuda_device):
    """Groups of 68 channels need a 272-column tile; the split kernel holds a
    layer's output in registers only up to hidden 1024. Both raise, naming
    the width."""
    packed, vecs = _packed(cuda_device, 2176, "bf16")
    with pytest.raises(ValueError, match="hidden 2176"):
        tsk.fused_score_forward(torch.zeros(8, 51, device=cuda_device), packed, vecs)
    packed, vecs = _packed(cuda_device, 2048, "bf16")
    with pytest.raises(ValueError, match="hidden 2048"):
        tsplit.fused_score_forward_split(torch.zeros(8, 51, device=cuda_device), packed, vecs)


@pytest.mark.gpu
def test_evaluation_on_the_card_matches_the_cpu(cuda_device):
    """Batched Procrustes on the card (cuSOLVER's SVD, whose singular-vector
    signs may differ from LAPACK's) gives the CPU's alignment and errors:
    random, mirrored and near-collinear poses; PA-MPJPE, argmin, PCK/AUC and
    hypothesis std of the multi-hypothesis evaluation. 1e-5 of the poses'
    scale, as the CPU tests against the JAX package."""
    import numpy as np

    from zedo_tpu_torch.data import evaluation
    from zedo_tpu_torch.ops import procrustes

    rng = np.random.RandomState(0)
    gt = rng.randn(200, 17, 3).astype(np.float32) * 0.3
    preds = (gt[:, None] + rng.randn(200, 8, 17, 3) * 0.05).astype(np.float32)
    preds[:, 1] *= np.array([-1.0, 1.0, 1.0], np.float32)  # mirrored
    t = rng.randn(200, 17, 1).astype(np.float32)
    preds[:, 2] = t * rng.randn(200, 1, 3) + rng.randn(200, 17, 3) * 1e-3  # near-collinear
    cpu, card = torch.from_numpy(preds), torch.from_numpy(preds).to(cuda_device)
    gt_b = torch.from_numpy(gt)[:, None].expand(cpu.shape)
    for reflection in ("best", True, False):
        want = procrustes.procrustes(gt_b, cpu, reflection=reflection).z
        got = procrustes.procrustes(gt_b.to(cuda_device), card, reflection=reflection).z
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max() + 1e-7
    for protocol2 in (False, True):
        kw = dict(protocol2=protocol2, actions=np.arange(200) % 15 + 2, with_pck_auc=True,
                  with_hypo_std=True)
        want = evaluation.multi_hypothesis_eval(cpu, gt, **kw)
        got = evaluation.multi_hypothesis_eval(card, gt, **kw)
        np.testing.assert_allclose(got.error, want.error, rtol=1e-5)
        np.testing.assert_allclose(got.per_sample_min, want.per_sample_min, rtol=0,
                                   atol=1e-5 * want.per_sample_min.max())
        np.testing.assert_array_equal(got.min_hypothesis, want.min_hypothesis)
        assert (got.pck, got.auc) == (want.pck, want.auc)
        np.testing.assert_allclose(got.hypo_std, want.hypo_std, rtol=1e-5)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """The train step of a hidden-256 ScoreMLP on the card against the CPU,
    with the (t, z) draws injected on both. The f32 loss within rtol 1e-5
    and each f32 gradient leaf within 1e-4 of the CPU's in relative norm;
    the bf16 loss within rtol 1e-5 and each bf16 gradient leaf within a
    quarter of its distance from the f32 one. One f32 step (no warm-up,
    clipping, fused Adam) moves the card's parameters by exactly the update
    worked out by hand from the card's gradients (atol 3e-7, two f32 ulps
    at the GroupNorm weights' 1.0, against updates of lr = 2e-3). The
    parameters after Adam are not held against the CPU's: Adam's first
    update is g / (|g| + eps), whose sign flips where a gradient cancels to
    ~1e-7 and the two devices round it differently."""
    import numpy as np

    from zedo_tpu_torch.diffusion import losses as tlosses
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.models.nn import tree_map, tree_replace, tree_to_flat
    from zedo_tpu_torch.presets import Config
    from zedo_tpu_torch.train import trainer as ttrainer

    rs = np.random.RandomState(0)
    batch = rs.randn(64, 17, 3).astype(np.float32) * 0.3
    u = rs.rand(64).astype(np.float32)
    z = rs.randn(64, 17, 3).astype(np.float32)
    # the draws placed on each device before the steps: the compiled step's
    # graph reads them there (a copy from the host cannot be captured)
    placed = {(name, dev.type): torch.from_numpy(a).to(dev) for name, a in (("u", u), ("z", z))
              for dev in (torch.device("cpu"), cuda_device)}
    monkeypatch.setattr(tlosses, "_uniform", lambda gen, n, like: placed[("u", like.device.type)])
    monkeypatch.setattr(tlosses, "_randn",
                        lambda gen, shape, like: placed[("z", like.device.type)])
    cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128, dropout=0.0)
    sde = SubVPSDE(t_max=0.1)
    params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def apply(p, x, labels, cond, msk, train=False, generator=None):
        return tsm.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

    def grads(dev, dtype):
        model = tlosses.mixed_precision_apply(apply) if dtype == "bf16" else apply
        loss_fn = tlosses.get_sde_loss_fn(sde, model, True, reduce_mean=True)
        leaves = {k: v.to(dev, copy=True).requires_grad_(not tlosses.is_buffer(k))
                  for k, v in tree_to_flat(params).items()}
        loss = loss_fn(tree_replace(params, leaves), None, torch.from_numpy(batch).to(dev))
        names = [k for k in leaves if not tlosses.is_buffer(k)]
        return loss.item(), dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))

    runs = {(str(dev), dtype): grads(dev, dtype)
            for dev in ("cpu", cuda_device) for dtype in ("fp32", "bf16")}
    for dtype in ("fp32", "bf16"):
        np.testing.assert_allclose(runs[("cuda", dtype)][0], runs[("cpu", dtype)][0], rtol=1e-5)
    cpu32, card32 = runs[("cpu", "fp32")][1], runs[("cuda", "fp32")][1]
    cpu16, card16 = runs[("cpu", "bf16")][1], runs[("cuda", "bf16")][1]
    for name, want in cpu32.items():
        assert (card32[name].cpu() - want).norm() <= 1e-4 * want.norm(), name
        assert (card16[name].cpu() - cpu16[name]).norm() <= 0.25 * (want - cpu16[name]).norm(), name

    lr, clip = 2e-3, 0.5
    optimizer = tlosses.get_optimizer(Config(optim=Config(
        optimizer="Adam", lr=lr, beta1=0.9, eps=1e-8, warmup=0, grad_clip=clip,
        weight_decay=0)))
    step = ttrainer.make_train_step(sde, tsm.apply, cfg, optimizer, reduce_mean=True)
    state = tlosses.init_train_state(tree_map(lambda a: a.to(cuda_device), params),
                                     optimizer, 0.9999)
    step(state, None, torch.from_numpy(batch).to(cuda_device))
    norm = torch.sqrt(sum((g ** 2).sum() for g in card32.values()))
    coef = min(1.0, clip / (norm.item() + 1e-6))
    for name, p in tree_to_flat(state.params).items():
        before = tree_to_flat(params)[name].to(cuda_device)
        if name in card32:
            g = card32[name] * coef
            torch.testing.assert_close(p, before - lr * g / (g.abs() + 1e-8), atol=3e-7, rtol=0,
                                       msg=name)
        else:
            assert torch.equal(p, before), name


@pytest.mark.gpu
def test_config_file_estimator_launches_the_kernel(cuda_device):
    """ZeDOEstimator from examples/quickstart_config.py (the stock H36M file
    at the trained fixture's widths) on the card: bf16 serving launches
    kernel #1 on every OIL forward and returns the bits of the estimator
    built from the preset at the same widths."""
    import os

    import numpy as np

    from zedo_tpu_torch import bench_trained as tbt
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.serving import ZeDOEstimator

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "examples", "quickstart_config.py")
    gt, k, px = tbt.make_scenes(np.load(os.path.join(tbt.FIXTURE, "family.npz")), 8)
    by_file = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config_path=config, dtype="bf16", batch_bucket=8,
        device=cuda_device).low_latency()
    by_preset = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=presets.h36m(hidden_dim=256, embed_dim=128),
        dtype="bf16", batch_bucket=8, device=cuda_device).low_latency()
    assert by_file.model_cfg == by_preset.model_cfg and by_file.model_cfg.hidden_dim == 256
    tsk.reset_launch_counts()
    got = by_file.predict(px, k)
    assert tsk.launch_counts["fused_score_forward"] == by_file.zcfg.oil.iterations == 200
    assert tsk.row_launches == {8 * len(by_file.clusters): 200}
    want = by_preset.predict(px, k)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert np.isfinite(got["poses"]).all()


def _solve_inputs(dev, n=64, s=5, seed=0):
    """A scene of n poses, s cluster hypotheses and a short schedule."""
    import numpy as np

    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.zeroshot import ipo, oil, pipeline

    rng = np.random.RandomState(seed)
    pose = rng.randn(n, 17, 3).astype(np.float32) * 0.25
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1000.0
    k[:, :2, 2] = 500.0
    k[:, 2, 2] = 1.0
    cam = np.einsum("nij,nkj->nki", k, pose + np.array([0.0, 0.0, 4.0], np.float32))
    px = cam[..., :2] / cam[..., 2:] + rng.randn(n, 17, 2).astype(np.float32)
    clusters = rng.randn(s, 17, 3).astype(np.float32) * 0.25
    sde = SubVPSDE(n=30, t_max=0.1)
    zcfg = pipeline.ZeDOConfig(ipo=ipo.IPOConfig(iterations=20),
                               oil=oil.OILConfig(iterations=30, track_reproj=True))
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return sde, zcfg, put(clusters), put(px.astype(np.float32)), put(k)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["kernel", "generic"])
def test_solve_jit_is_bit_equal_to_solve(cuda_device, path):
    """The compiled solve (IPO and OIL steps replayed as CUDA graphs) against
    the eager solve at 64 x 5 at the published width: kernel #1 on bf16
    weights, or the generic path (a Langevin corrector drawing from the
    caller's generator, which stands where the eager solve leaves it)."""
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.zeroshot import pipeline

    sde, zcfg, clusters, px, k = _solve_inputs(cuda_device)
    cfg = tsm.ScoreMLPConfig()
    params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device=cuda_device)
    if path == "kernel":
        params = tree_map(lambda a: a.to(torch.bfloat16), params)
        sampler = PCSampler(sde=sde, eps=0.01)
    else:
        sampler = PCSampler(sde=sde, eps=0.01, corrector="langevin")
    results, states = [], []
    for solve in (pipeline.solve, pipeline.solve_jit, pipeline.solve_jit):
        gen = torch.Generator(cuda_device).manual_seed(7)
        with torch.no_grad():
            results.append(solve(params, cfg, sde, sampler, zcfg, clusters, px, None, k,
                                 generator=gen))
        states.append(gen.get_state())
    for got in results[1:]:
        assert torch.equal(got.poses, results[0].poses)
        assert torch.equal(got.translations, results[0].translations)
        assert torch.equal(got.reproj_px, results[0].reproj_px)
    for state in states[1:]:
        assert torch.equal(state, states[0])
    assert torch.isfinite(results[0].poses).all()


@pytest.mark.gpu
def test_replays_count_kernel_launches(cuda_device):
    """Kernel #1's counters count the forwards the OIL graphs replay: one a
    step on every call, the first (warm-up and capture) included."""
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.utils import compiled
    from zedo_tpu_torch.zeroshot import pipeline

    sde, zcfg, clusters, px, k = _solve_inputs(cuda_device, n=48, s=3, seed=1)
    cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128)
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      tsm.init_params(torch.Generator().manual_seed(1), cfg, device=cuda_device))
    compiled.clear_cache()
    for call in range(3):
        tsk.reset_launch_counts()
        with torch.no_grad():
            pipeline.solve_jit(params, cfg, sde, PCSampler(sde=sde, eps=0.01), zcfg, clusters,
                               px, None, k)
        steps = zcfg.oil.iterations
        assert tsk.launch_counts["fused_score_forward"] == steps, call
        assert tsk.path_launches == {"wgmma": steps, "wmma": 0}
        assert tsk.gn_mode_launches == {"bf16": steps, "f32": 0}
        assert tsk.row_launches == {48 * 3: steps}
    assert compiled.cache_info()["entries"] == 2  # IPO and OIL, captured once


@pytest.mark.gpu
def test_capture_seconds_count_the_first_solve_only(cuda_device):
    """`cache_info()`'s capture counters grow with the first solve's
    captures (inside the span zedo.capture) and not with its replays."""
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.utils import compiled, profiling
    from zedo_tpu_torch.zeroshot import pipeline

    sde, zcfg, clusters, px, k = _solve_inputs(cuda_device, n=48, s=3, seed=2)
    cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128)
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      tsm.init_params(torch.Generator().manual_seed(2), cfg, device=cuda_device))
    compiled.clear_cache()
    before = compiled.cache_info()
    profiling.clear()
    with profiling.recording(), torch.no_grad():
        pipeline.solve_jit(params, cfg, sde, PCSampler(sde=sde, eps=0.01), zcfg, clusters,
                           px, None, k)
        first = compiled.cache_info()
        pipeline.solve_jit(params, cfg, sde, PCSampler(sde=sde, eps=0.01), zcfg, clusters,
                           px, None, k)
    second = compiled.cache_info()
    log = profiling.spans()
    profiling.clear()
    assert first["capture_s"] > before["capture_s"] and first["captures"] > before["captures"]
    assert (second["capture_s"], second["captures"]) == (first["capture_s"], first["captures"])
    captures = [s for s in log if s.name == "zedo.capture"]
    assert len(captures) == 2 and {log[s.parent].name for s in captures} == {"zedo.ipo",
                                                                              "zedo.oil"}
    spent = sum(s.end_ns - s.start_ns for s in captures) * 1e-9
    assert 0 < spent <= first["capture_s"] - before["capture_s"]


CAPTURE_FAILS = """
import functools, sys, torch
from zedo_tpu_torch.utils import compiled

def body(carry, consts, ys, counter, generator, variant, *, scale):
    host = torch.tensor([scale])  # pageable host memory, copied in the step
    return {"x": carry["x"] + host.to(carry["x"].device)}

carry = {"x": torch.zeros(4, device="cuda")}
try:
    compiled.scan(functools.partial(body, scale=2.0), (None,) * 3, carry, {}, {}, compiled=True)
except Exception as exc:
    assert compiled.cache_info()["entries"] == 0, compiled.cache_info()
    assert torch.equal(carry["x"], torch.zeros(4, device="cuda"))
    print("raised", type(exc).__name__)
    sys.exit(0)
print("no error: the capture ran")
sys.exit(1)
"""


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda_device):
    """A step whose capture fails (it copies pageable host memory to the
    card) raises from the compiled scan, caches nothing and leaves the
    caller's carry as it was: there is no fallback to the eager loop. Run in
    a process of its own, as a failed capture may leave its stream's state
    to that process."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised" in out.stdout


@pytest.mark.gpu
def test_ipo_corrections_apply_as_a_python_float_division(cuda_device):
    """IPO's table on CUDA holds what PyTorch's CUDA division by a Python
    float multiplies by, so the scan's step is the Adam step written with
    Python-float corrections, bit for bit."""
    from zedo_tpu_torch.zeroshot import ipo

    x = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0)).to(cuda_device) * 3
    for dtype in (torch.float32, torch.float64):
        table = ipo.adam_corrections(500, dtype, cuda_device)
        xx = x.to(dtype)
        for step in (1, 2, 7, 100, 500):
            for col, decay in enumerate((ipo.B1, ipo.B2)):
                assert torch.equal(xx * table[step - 1, col], xx / (1.0 - decay ** step))


# ------------------------------------------------- the compiled programs


def _train_states(dev, rows=256, hidden=256, dtype="fp32", seed=0):
    """(eager step, compiled step, two TrainStates from one seeded init, the
    batch) of a small ScoreMLP with dropout on."""
    import numpy as np

    from zedo_tpu_torch.diffusion import losses as tlosses
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.presets import Config

    cfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=hidden // 2, dropout=0.1)
    optimizer = tlosses.get_optimizer(Config(optim=Config(
        optimizer="Adam", lr=2e-3, beta1=0.9, eps=1e-8, warmup=3, grad_clip=1.0,
        weight_decay=0)))

    def apply(p, x, labels, cond, msk, train=False, generator=None):
        return tsm.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

    model = tlosses.mixed_precision_apply(apply) if dtype == "bf16" else apply
    steps = [tlosses.get_step_fn(SubVPSDE(t_max=0.1), model, optimizer, train=True,
                                 reduce_mean=True, compiled=c) for c in (False, True)]
    params = tsm.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    states = [tlosses.init_train_state(params, optimizer, 0.999) for _ in range(2)]
    batch = torch.from_numpy(np.random.RandomState(seed).randn(rows, 17, 3).astype(np.float32)
                             * 0.3).to(dev)
    return steps, states, batch


def _same_state(a, b):
    from zedo_tpu_torch.models.nn import tree_to_flat

    for tree_a, tree_b in ((a.params, b.params), (a.ema.shadow_params, b.ema.shadow_params)):
        fa, fb = tree_to_flat(tree_a), tree_to_flat(tree_b)
        for name in fa:
            assert torch.equal(fa[name], fb[name]), name
    assert torch.equal(a.ema.num_updates, b.ema.num_updates)
    for (_, pa), (_, pb) in zip(a.leaves(), b.leaves()):
        sa, sb = a.opt_state.state[pa], b.opt_state.state[pb]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_compiled_train_steps_are_bit_equal_to_eager(cuda_device, dtype):
    """5 train steps (warm-up from lr 0, clipping, fused capturable Adam,
    EMA, dropout from the step's generator) at 256 rows: the compiled step's
    graph replayed on the state's own tensors against the eager step, the
    losses, params, Adam's moments and step counts and the EMA bit-equal,
    and each step's generator where the eager step leaves it."""
    from zedo_tpu_torch.utils import compiled

    compiled.clear_cache()
    steps, states, batch = _train_states(cuda_device, dtype=dtype)
    losses = [[], []]
    for i in range(5):
        for k in range(2):
            gen = torch.Generator(cuda_device).manual_seed(100 + i)
            states[k], loss = steps[k](states[k], gen, batch)
            losses[k].append((loss, gen.get_state()))
    for (la, ga), (lb, gb) in zip(*losses):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    _same_state(*states)
    assert states[1].step == 5
    assert compiled.cache_info()["entries"] == 1
    assert states[1].opt_state.param_groups[0]["capturable"] == (cuda_device.type == "cuda")


def _sampling_inputs(dev, rows=64, steps=50):
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.diffusion.score import get_score_fn
    from zedo_tpu_torch.diffusion.sde import SubVPSDE

    cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128)
    params = tsm.init_params(torch.Generator().manual_seed(3), cfg, device=dev)
    sde = SubVPSDE(n=steps, t_max=1.0)

    def score_fn(x, t, condition=None, mask=None):
        return get_score_fn(sde, lambda *a: tsm.apply(params, cfg, *a), True)(x, t, condition,
                                                                            mask)

    sampler = PCSampler(sde=sde, corrector="langevin", probability_flow=False, eps=1e-3)
    return cfg, params, sde, sampler, score_fn


@pytest.mark.gpu
def test_compiled_sample_loop_is_bit_equal_to_eager(cuda_device):
    """sample_loop with a Langevin corrector, comp3d imputation, a warm start,
    symmetry guidance and the trajectory at 64 rows x 50 steps: the compiled
    scan (a CUDA graph a step, autograd's guidance inside it) against the
    eager loop, bit-equal, the generator after it where the eager loop
    leaves it; a second call with new weights of the same shapes captures
    nothing anew."""
    import numpy as np

    from zedo_tpu_torch.diffusion import sampling
    from zedo_tpu_torch.diffusion.guidance import get_sym_gradient_fn
    from zedo_tpu_torch.utils import compiled

    cfg, params, sde, sampler, score_fn = _sampling_inputs(cuda_device)
    shape = (64, 17, 3)
    cond = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda_device) * 0.3
    mask = torch.from_numpy(sampling.make_task_mask("comp3d", shape, jlist="14,15,16")).to(
        cuda_device)
    kw = dict(condition=cond, mask=mask, warm_start_steps=5, return_trajectory=True)
    compiled.clear_cache()
    outs = []
    for run in range(3):
        gen = torch.Generator(cuda_device).manual_seed(9)
        with torch.no_grad():
            if run == 0:
                out = sampler.sample_loop(score_fn, gen, shape,
                                          guidance_fn=get_sym_gradient_fn(0.5), **kw)
            else:
                out = sampler.sample_loop_jit(tsm.apply, params, cfg, gen, shape,
                                              guidance_fn=get_sym_gradient_fn(0.5), **kw)
        outs.append((out, gen.get_state()))
    for (trajs, x), state in outs[1:]:
        assert torch.equal(trajs, outs[0][0][0]) and torch.equal(x, outs[0][0][1])
        assert torch.equal(state, outs[0][1])
    assert torch.isfinite(outs[0][0][1]).all()
    new = tree_map(lambda a: a * 0.5, params)
    with torch.no_grad():
        got = sampler.sample_loop_jit(tsm.apply, new, cfg, torch.Generator(cuda_device), shape,
                                      guidance_fn=get_sym_gradient_fn(0.5), **kw)[1]
    assert compiled.cache_info() == {**compiled.cache_info(), "entries": 1, "misses": 1}
    assert not torch.equal(got, outs[0][0][1])
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.gpu
def test_compiled_rk45_takes_the_eager_steps(cuda_device):
    """The probability-flow ODE at 64 rows: the compiled while loop (chunks of
    masked steps as CUDA graphs, one host read a chunk) against the eager
    one, the samples bit-equal and the NFE equal."""
    from zedo_tpu_torch.diffusion import ode
    from zedo_tpu_torch.utils import compiled

    cfg, params, sde, _, score_fn = _sampling_inputs(cuda_device)
    sampler = ode.ODESampler(sde=sde, shape=(64, 17, 3), denoise=True)
    z = torch.randn(sampler.shape, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    compiled.clear_cache()
    with torch.no_grad():
        want, nfe = sampler.sample(score_fn, z=z)
        reads = compiled.host_reads()
        for _ in range(2):
            got, got_nfe = sampler.sample_jit(tsm.apply, params, cfg, z=z)
            assert torch.equal(got, want) and got_nfe == nfe
    assert nfe % 7 == 1 and nfe > 8
    assert compiled.host_reads() == 3 * reads
    assert compiled.cache_info()["entries"] == 1


@pytest.mark.gpu
def test_compiled_evaluation_and_packing_are_bit_equal(cuda_device):
    """The hypothesis errors (both protocols, both subset orders; the SVD
    between the two graphs) and serving's rank-and-pack, compiled against
    eager on the card."""
    import numpy as np

    from zedo_tpu_torch import serving
    from zedo_tpu_torch.data import evaluation

    rs = np.random.RandomState(2)
    gt = torch.from_numpy((rs.randn(40, 17, 3) * 0.3).astype(np.float32)).to(cuda_device)
    preds = gt[:, None] + torch.from_numpy((rs.randn(40, 6, 17, 3) * 0.05).astype(
        np.float32)).to(cuda_device)
    for protocol2 in (False, True):
        for subset, first in ((None, True), ((1, 2, 3, 5, 9), True), ((1, 2, 3, 5, 9), False)):
            want = evaluation._hypothesis_errors(preds, gt, protocol2, subset, first)
            for _ in range(2):
                got = evaluation._hypothesis_errors_jit(preds, gt, protocol2, subset, first)
                assert torch.equal(got, want), (protocol2, subset, first)
    k = torch.tensor([[1000.0, 0, 500], [0, 1000.0, 500], [0, 0, 1]]).expand(40, 3, 3)
    k = k.contiguous().to(cuda_device)
    trans = torch.zeros(40, 6, 1, 3, device=cuda_device)
    trans[..., 2] = 4.0
    kp = torch.rand(40, 17, 2, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    want = serving._rank_and_pack(preds, trans, kp * 1000, k)
    assert torch.equal(serving._rank_and_pack_jit(preds, trans, kp * 1000, k), want)


CAPTURES_FAIL = """
import functools, sys, torch
from zedo_tpu_torch.utils import compiled

def body(carry, consts, ys, counter, generator, variant):
    host = torch.tensor([2.0])  # pageable host memory, copied in the step
    return {"x": carry["x"] + host.to(carry["x"].device)}

def going(carry, consts):
    return carry["x"].sum() < 10

name = sys.argv[1]
calls = {"step": lambda c: compiled.step(functools.partial(body), c, {}, compiled=True,
                                         donate=True),
         "while_loop": lambda c: compiled.while_loop(going, functools.partial(body), c, {},
                                                     compiled=True)}
carry = {"x": torch.zeros(4, device="cuda")}
try:
    calls[name](carry)
except Exception as exc:
    assert compiled.cache_info()["entries"] == 0, compiled.cache_info()
    assert torch.equal(carry["x"], torch.zeros(4, device="cuda")), name
    print("raised", name, type(exc).__name__)
    sys.exit(0)
print("no error: the capture ran", name)
sys.exit(1)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("program", ["step", "while_loop"])
def test_failed_captures_of_step_and_while_loop_raise(cuda_device, program):
    """A donated compiled step and a compiled while loop whose capture fails
    (the body copies pageable host memory to the card) raise, cache nothing
    and leave the caller's carry as it was (the donated step's warm-up put
    back): nothing falls back to the eager loop. Each in a process of its
    own."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", CAPTURES_FAIL, program], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised" in out.stdout


# ------------------------------------------------ kernel #3 (the control adapter)


def _control_operands(dev, hidden, gn, joints=12, seed=3):
    """Kernel #3's packed operands at one t, on the adapter's seeded weights
    (every leaf its own draw: the copy branch is not the trunk's copy)."""
    from perfbench import weights, weights_control
    from zedo_tpu_torch.ops.kernels import control_kernel as ck

    cfg = tsm.ScoreMLPConfig(n_joints=joints, hidden_dim=hidden, embed_dim=512)
    spec = {"n_joints": joints, "joint_dim": 3, "hidden_dim": hidden, "embed_dim": 512,
            "n_blocks": 2, "sigma_min": 0.01, "sigma_max": 50, "num_scales": 1000}
    params = weights.nested(weights_control.make(seed, spec, dev, torch.bfloat16))
    packed = ck.pack_weights(params, cfg, dtype=torch.bfloat16, gn_dtype=GN[gn])
    temb = tsm.time_embedding(params, cfg, torch.full((1,), 47.3, device=dev))[0]
    return ck, packed, ck.step_vectors(params, cfg, temb).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("gn", ["bf16", "f32"])
@pytest.mark.parametrize("hidden,rows", [(1024, (10000, 1001, 129, 1)), (256, (2048, 77))])
def test_control_kernel_matches_plain_version(cuda_device, hidden, rows, gn):
    """Kernel #3 against its plain version at SyRIP's 36 columns: the
    published width at the cell's 10,000 rows and ragged counts, and hidden
    256 (groups of 8 channels). TOL as kernel #1's: the same bf16 operands,
    f32 sums in another order."""
    ck, packed, vecs = _control_operands(cuda_device, hidden, gn)
    gen = torch.Generator().manual_seed(2)
    for n in rows:
        x = torch.randn(n, 36, generator=gen).to(cuda_device)
        got = ck.fused_control_forward(x, packed, vecs)
        torch.cuda.synchronize()
        assert got.shape == (n, 36)
        want = ck.fused_control_forward_reference(x, packed, vecs)
        assert (got - want).abs().max().item() < TOL, (n, (got - want).abs().max().item())
    assert ck.load_library().zedo_control_blocks_per_sm() >= 1


@pytest.mark.gpu
def test_the_adapter_solves_on_kernel_3(cuda_device, monkeypatch):
    """The ControlNet adapter on bf16 weights through the compiled infant
    solve takes the fast path: kernel #3 once a step, no zedo_pc_step and no
    kernel #1; the conditional model still takes the generic path."""
    from perfbench import weights, weights_control
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.models import control_mlp, score_mlp_cond
    from zedo_tpu_torch.ops.kernels import control_kernel as ck
    from zedo_tpu_torch.zeroshot import infant

    sde, zcfg, clusters, px, k = _solve_inputs(cuda_device, n=40, s=2, seed=4)
    cfg = tsm.ScoreMLPConfig()
    spec = {"n_joints": 17, "joint_dim": 3, "hidden_dim": 1024, "embed_dim": 512,
            "n_blocks": 2, "sigma_min": 0.01, "sigma_max": 50, "num_scales": 1000}
    params = weights.nested(weights_control.make(5, spec, cuda_device, torch.bfloat16))
    steps = []
    real_step = PCSampler.zedo_pc_step

    def counted(self, *a, **kw):
        steps.append(1)
        return real_step(self, *a, **kw)

    monkeypatch.setattr(PCSampler, "zedo_pc_step", counted)
    tsk.reset_launch_counts()
    before = ck.launch_counts["fused_control_forward"]
    with torch.no_grad():
        res = infant.solve_infant_jit(params, control_mlp.apply, cfg, sde,
                                      PCSampler(sde=sde, eps=0.01), zcfg, clusters, px, k)
    assert ck.launch_counts["fused_control_forward"] - before == zcfg.oil.iterations
    assert not steps and tsk.launch_counts["fused_score_forward"] == 0
    assert torch.isfinite(res.poses).all()
    cond = tree_map(lambda a: a.to(torch.bfloat16),
                    score_mlp_cond.init_params(torch.Generator().manual_seed(0), cfg,
                                               device=cuda_device))
    with torch.no_grad():
        infant.solve_infant_jit(cond, score_mlp_cond.apply, cfg, sde,
                                PCSampler(sde=sde, eps=0.01), zcfg, clusters, px, k,
                                condition=px / 500.0 - 1.0)
    assert steps


# ------------------------------------------------- IPO's step (kernel #4)

IPO_SHAPES = {"h36m": (44300, (0, 1, 4), "z", 50), "syrip": (10000, tuple(range(12)), "xyz", 20),
              "serving": (160, (0, 1, 4), "z", 5)}


def _ipo_scene(dev, rows, keys, seed=0):
    """rows root-relative poses of 17 joints, keypoints projected from them
    under a random rotation about z, with pixel noise, and intrinsics."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pose = rng.randn(rows, 17, 3).astype(np.float32) * 0.25
    pose -= pose[:, :1]
    angle = rng.uniform(-0.5, 0.5, rows)
    rot = np.zeros((rows, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(angle)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(angle), np.sin(angle)
    rot[:, 2, 2] = 1.0
    k = np.zeros((rows, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, :2, 2] = 512.0
    k[:, 2, 2] = 1.0
    cam = np.einsum("nij,nkj->nki", k, np.einsum("nij,nkj->nki", rot, pose)
                    + np.array([0.1, -0.2, 4.5], np.float32))
    px = cam[..., :2] / cam[..., 2:] + rng.randn(rows, 17, 2).astype(np.float32) * 2
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return put(pose), put(px), put(k)


def _ipo_carry(dev, rows, axes, seed=1):
    """A state mid-way through a solve: parameters, moments and a loss."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * scale + mean).to(dev)

    params = {"rot_vect": draw(rows, 1, scale=0.2, mean=1.0),
              "scale": draw(rows, 1, 1, scale=0.4, mean=1.2)}
    for a in axes:
        params[f"rot_vect_{a}"] = draw(rows, 1, scale=0.2)
    return {"params": params,
            "mu": {n: draw(*p.shape, scale=0.05) for n, p in params.items()},
            "nu": {n: draw(*p.shape, scale=0.01).abs() for n, p in params.items()},
            "loss": torch.zeros(rows, device=dev)}


def _same_tree(a, b):
    from zedo_tpu_torch.utils.compiled import _leaves

    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(IPO_SHAPES))
def test_ipo_kernel_matches_plain_version(cuda_device, shape, monkeypatch):
    """Kernel #4 against its plain version on the same card tensors, bit for
    bit: one step from a state mid-way through a solve, and whole runs of
    `run_ipo` (500 steps; 100 at the serving bucket), the plain version's
    step substituted in the eager loop."""
    import functools

    from zedo_tpu_torch.ops.kernels import ipo_kernel
    from zedo_tpu_torch.zeroshot import ipo

    rows, keys, axes, s = IPO_SHAPES[shape]
    pose, px, k = _ipo_scene(cuda_device, rows, keys)
    kl = list(keys)
    t = ipo.init_translation(px, k, 3.0)
    consts = ipo_kernel.pack(pose[:, kl], px[:, kl], t, k)
    corrections = ipo.adam_corrections(500, torch.float32, cuda_device)
    counter = torch.tensor([6], device=cuda_device)
    scalars = dict(weight=1.0 / (rows // s * len(keys) * 2), lr=0.1, lo=0.5, hi=2.0, b1=ipo.B1,
                   b2=ipo.B2, eps=ipo.EPS)
    got, want = _ipo_carry(cuda_device, rows, axes), _ipo_carry(cuda_device, rows, axes)
    before = ipo_kernel.launch_counts["ipo_step"]
    ipo_kernel.ipo_step(consts, got, corrections, counter, **scalars)
    torch.cuda.synchronize()
    assert ipo_kernel.launch_counts["ipo_step"] == before + 1
    ipo_kernel.ipo_step_reference(consts, want, corrections, counter, **scalars)
    _same_tree(got, want)
    assert torch.isfinite(got["loss"]).all() and (got["loss"] > 0).all()

    cfg = ipo.IPOConfig(iterations=100 if shape == "serving" else 500, keypoint_list=keys,
                        rot_axes=axes)
    run = functools.partial(ipo.run_ipo, pose, px, k, cfg, n_groups=s)
    got = run()
    monkeypatch.setattr(ipo_kernel, "ipo_step", ipo_kernel.ipo_step_reference)
    want = run()
    _same_tree(tuple(got), tuple(want))


@pytest.mark.gpu
def test_ipo_kernel_counts_a_step_a_replay(cuda_device):
    """`launch_counts["ipo_step"]` counts one a step through graph replays:
    500 in a `solve_jit` and in a `solve_infant_jit`, 100 in a low-latency
    `predict`, and 0 for a solve on the CPU."""
    import dataclasses

    import numpy as np

    from zedo_tpu_torch import bench_trained as tbt
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.ops.kernels import ipo_kernel
    from zedo_tpu_torch.serving import ZeDOEstimator
    from zedo_tpu_torch.zeroshot import infant, ipo, pipeline

    sde, zcfg, clusters, px, k = _solve_inputs(cuda_device, n=40, s=3, seed=2)
    zcfg = dataclasses.replace(zcfg, ipo=ipo.IPOConfig(iterations=500))
    cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128)
    params = tree_map(lambda a: a.to(torch.bfloat16),
                      tsm.init_params(torch.Generator().manual_seed(1), cfg, device=cuda_device))
    sampler = PCSampler(sde=sde, eps=0.01)
    for call in range(2):
        ipo_kernel.reset_launch_counts()
        with torch.no_grad():
            pipeline.solve_jit(params, cfg, sde, sampler, zcfg, clusters, px, None, k)
        assert ipo_kernel.launch_counts["ipo_step"] == 500, call
        ipo_kernel.reset_launch_counts()
        with torch.no_grad():
            infant.solve_infant_jit(params, tsm.apply, cfg, sde, sampler, zcfg, clusters, px, k)
        assert ipo_kernel.launch_counts["ipo_step"] == 500, call
    est = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=presets.h36m(hidden_dim=256, embed_dim=128),
        dtype="bf16", batch_bucket=8, device=cuda_device).low_latency()
    _, kk, kp = tbt.make_scenes(np.load(f"{tbt.FIXTURE}/family.npz"), 8)
    ipo_kernel.reset_launch_counts()
    est.predict(kp, kk)
    assert ipo_kernel.launch_counts["ipo_step"] == est.zcfg.ipo.iterations == 100
    ipo_kernel.reset_launch_counts()
    cpu = tree_map(lambda a: a.float().cpu(), params)
    with torch.no_grad():
        pipeline.solve_jit(cpu, cfg, sde, sampler, zcfg, clusters.cpu(), px.cpu(), None, k.cpu())
    assert ipo_kernel.launch_counts["ipo_step"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["syrip", "serving"])
def test_ipo_kernel_compiled_is_bit_equal_to_eager(cuda_device, shape):
    """`run_ipo` on kernel #4: the compiled scan (a graph a step, replayed)
    against the eager loop, and a second compiled call against the first,
    bit for bit."""
    from zedo_tpu_torch.zeroshot import ipo

    rows, keys, axes, s = IPO_SHAPES[shape]
    pose, px, k = _ipo_scene(cuda_device, rows, keys, seed=3)
    cfg = ipo.IPOConfig(iterations=200, keypoint_list=keys, rot_axes=axes, max_scale_t=8.0)
    eager = ipo.run_ipo(pose, px, k, cfg, n_groups=s)
    for _ in range(2):
        _same_tree(tuple(ipo.run_ipo(pose, px, k, cfg, n_groups=s, compiled=True)), tuple(eager))
