"""Tests of the zedo_tpu_torch CUDA kernels; they need the card and skip
without one. This file imports no jax, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from zedo_tpu_torch.models import score_mlp as tsm
from zedo_tpu_torch.ops.kernels import score_kernel as tsk
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
    monkeypatch.setattr(tlosses, "_uniform",
                        lambda gen, n, like: torch.from_numpy(u).to(like.device))
    monkeypatch.setattr(tlosses, "_randn",
                        lambda gen, shape, like: torch.from_numpy(z).to(like.device))
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
