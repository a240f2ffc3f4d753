"""zedo_tpu_torch's train step and training loop on a mesh of two Gloo ranks
on the CPU (train.trainer.make_sharded_train_step, train_loop(mesh=...),
parallel.tensor_parallel, run.train_pose_mini --mesh) against the JAX
package's sharded train step on a 2-device mesh and against the port's own
single-device step.

One two-rank run (a timeout of 120 s) computes the port's results for all
but the last test, which runs four ranks on a dp2,tp2 mesh (120 s). Tolerances: dp2 against JAX's step with the same injected
(t, z) draws as tests/test_torch_train.py holds the single-device step
(loss 2e-5 relative, parameters 1e-4 + 1e-3 relative), the gradients 1e-4
of their largest; the tensor-parallel forward 2e-5 absolute against the
replicated one (tests/test_cli_e2e.py:507); the tensor-parallel step and
the mesh training loops against one device: losses and gradients at f32
rounding (1e-5 relative), parameters as the JAX comparison (1e-4 + 1e-3
relative: Adam's m / sqrt(v) turns the rounding of a gradient near zero
into a fraction of the learning rate); a resume under the same mesh bit
for bit."""
import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import chip_smoke
from zedo_tpu.diffusion import losses as jlosses
from zedo_tpu.diffusion import sde as jsde
from zedo_tpu.models import score_mlp as jsm
from zedo_tpu.train import trainer as jtrainer
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch.parallel import multiprocess_check as mpc

EPS, T, B = 1e-5, 0.1, 8
OPTIM = dict(optimizer="Adam", lr=2e-3, beta1=0.9, eps=1e-8, warmup=0, grad_clip=0.5,
             weight_decay=0)

CHILD = r"""
import os
import sys
sys.modules["torch.utils.tensorboard"] = None  # TensorBoard is optional; its import is slow
import numpy as np
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import mesh as mesh_lib
mesh_lib.init_distributed(device="cpu")
import chip_smoke
from zedo_tpu_torch import presets
from zedo_tpu_torch.diffusion import losses
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_to_flat
from zedo_tpu_torch.parallel import collectives
from zedo_tpu_torch.parallel import tensor_parallel as tp_lib
from zedo_tpu_torch.run import train_pose_mini
from zedo_tpu_torch.train import trainer
from zedo_tpu_torch.utils import rng
from zedo_tpu_torch.utils.checkpoint import params_from_numpy, restore_native

root = sys.argv[1]
inp = np.load(root + "/inputs.npy", allow_pickle=True).item()
rank = dist.get_rank()
out = {}
dp2 = mesh_lib.mesh_from_spec("dp2", device="cpu")
tp2 = mesh_lib.mesh_from_spec("dp1,tp2", device="cpu")
sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=inp["T"])
conf = presets.Config(optim=presets.Config(inp["OPTIM"]))

grads = []
step_orig = losses.Optimizer.step
def recording_step(self, adam, trainable, step, grad_norm=None):
    grads.append([p.grad.clone() for p in trainable])  # after the mesh's mean
    return step_orig(self, adam, trainable, step, grad_norm)
losses.Optimizer.step = recording_step

def flat(tree):
    return {k: v.detach().numpy() for k, v in tree_to_flat(tree).items()}

# 1. dp2, one step, the draws of the global batch injected (as into JAX's)
raw_orig = rng._raw
def injected(kind, gen, shape, dtype, device, high=None):
    a = {"rand": inp["u"], "randn": inp["z"]}[kind]
    assert tuple(shape) == a.shape, (kind, shape)
    return torch.from_numpy(a)
rng._raw = injected
cfg = score_mlp.ScoreMLPConfig(hidden_dim=128, embed_dim=64, dropout=0.0)
params = params_from_numpy(inp["params"], device="cpu")
optimizer = losses.get_optimizer(conf)
state = losses.init_train_state(params, optimizer, 0.9999)
step, rows = trainer.make_sharded_train_step(dp2, sde, score_mlp.apply, cfg, optimizer,
                                             reduce_mean=True)
batch = torch.from_numpy(inp["batch"])
state, loss = step(state, None, batch[rows(len(batch))])
names = [n for n, _ in state.leaves()]
out["dp_loss"] = loss.item()
out.update({"dp_grad/" + n: g.numpy() for n, g in zip(names, grads[-1])})
out.update({"dp_param/" + n: v for n, v in flat(state.params).items()})
rng._raw = raw_orig

# 2. dp1,tp2: the forward, and one step with dropout, against one device
cfg = score_mlp.ScoreMLPConfig(hidden_dim=128, embed_dim=64, dropout=0.25)
full = params_from_numpy(inp["params"], device="cpu")
rules = tp_lib.check(full, cfg, tp2)
B = len(batch)
labels = torch.full((B,), 42.0)
with torch.no_grad():
    out["tp_forward"] = tp_lib.make_apply(tp2)(tp_lib.shard_tree(full, rules, tp2), cfg, batch,
                                               labels).numpy()
    out["full_forward"] = score_mlp.apply(full, cfg, batch, labels).numpy()
single = losses.init_train_state(full, optimizer, 0.9999)
one = trainer.make_train_step(sde, score_mlp.apply, cfg, optimizer, reduce_mean=True)
single, single_loss = one(single, torch.Generator().manual_seed(3), batch)
single_grads = grads[-1]
sharded = losses.init_train_state(tp_lib.shard_tree(full, rules, tp2), optimizer, 0.9999)
step, rows = trainer.make_sharded_train_step(tp2, sde, score_mlp.apply, cfg, optimizer,
                                             reduce_mean=True, tp_rules=rules)
sharded, tp_loss = step(sharded, torch.Generator().manual_seed(3), batch[rows(B)])
out["tp_loss"], out["tp_single_loss"] = tp_loss.item(), single_loss.item()
for n, g, s in zip(names, grads[-1], single_grads):
    out["tp_grad/" + n] = tp_lib.gather_leaf(g, rules[n], tp2).numpy()
    out["tp_single_grad/" + n] = s.numpy()
for n, v in tree_to_flat(tp_lib.gather_tree(sharded.params, rules, tp2)).items():
    out["tp_param/" + n] = v.detach().numpy()
    out["tp_single_param/" + n] = tree_to_flat(single.params)[n].detach().numpy()
    out["tp_init/" + n] = tree_to_flat(full)[n].detach().numpy()
# the same step with the replicated leaves' gradients left unsummed over the
# model axis: a fault chip_smoke's training check has to reject
def unsummed(self, names, grads, loss):
    *grads, loss = self._all_reduce(list(grads) + [loss.detach()], self.data_axis, mean=True)
    return grads, loss
reduce_orig, trainer.MeshSync.reduce = trainer.MeshSync.reduce, unsummed
faulty = losses.init_train_state(tp_lib.shard_tree(full, rules, tp2), optimizer, 0.9999)
faulty, _ = step(faulty, torch.Generator().manual_seed(3), batch[rows(B)])
trainer.MeshSync.reduce = reduce_orig
for n, v in tree_to_flat(tp_lib.gather_tree(faulty.params, rules, tp2)).items():
    out["unsummed_param/" + n] = v.detach().numpy()

# 3. the training loop on one device, dp2 and dp1,tp2, and resumes
config = presets.optim_config("mini")
config.training.batch_size, config.model.num_scales, config.eval.batch_size = 16, 20, 16
config.optim.warmup = 0  # lr 2e-4 from the first step, so the weights move
class FakeDS:
    db_3d = np.random.RandomState(0).randn(64, 17, 3).astype(np.float32) * 0.1
    db_2d = np.zeros((64, 17, 2), np.float32)
mcfg = score_mlp.ScoreMLPConfig(hidden_dim=128, embed_dim=64, n_blocks=1, num_scales=20)

def loop(mesh, tag, epochs, eval_freq=100, restore=None):
    state, hist, _ = trainer.train_loop(
        config, FakeDS(), output_dir=f"{root}/{tag}", model_cfg=mcfg, device="cpu",
        mesh=mesh, restore_dir=restore,
        trainer_cfg=trainer.TrainerConfig(n_epochs=epochs, eval_freq=eval_freq, seed=0))
    p, ema = state.params, state.ema.shadow_params
    if mesh is not None and mesh.axis_size("model") > 1:
        mrules = tp_lib.check(score_mlp.init_params(torch.Generator(), mcfg, device="cpu"),
                              mcfg, mesh)
        p, ema = (tp_lib.gather_tree(t, mrules, mesh) for t in (p, ema))
    out[f"loop_{tag}_hist"] = np.array(hist)
    out[f"loop_{tag}_w"] = p["pre_dense"]["weight"].detach().numpy()
    out[f"loop_{tag}_ema"] = ema["post_dense"]["weight"].detach().numpy()

if rank == 0:
    loop(None, "single", 2)
collectives.barrier(dp2)
loop(dp2, "dp", 2)
loop(tp2, "tp", 2)
loop(dp2, "a", 3, eval_freq=2)
loop(dp2, "full", 5)
loop(dp2, "resumed_dp", 5, restore=f"{root}/a/checkpoint_2.pth")
loop(tp2, "resumed_tp", 5, restore=f"{root}/a/checkpoint_2.pth")
loop(tp2, "b", 1, eval_freq=1)  # a checkpoint written under tensor parallelism
back = restore_native(f"{root}/b/checkpoint_0.pth", device="cpu")
out["tp_ckpt_shape"] = np.array(back["params"]["b1_dense1"]["weight"].shape)

# 4. the CLI with --mesh dp2 against --mesh off on a MINI-RGBD workspace
os.chdir(root)
if rank == 0:
    chip_smoke.write_mini_workspace(".", np.random.RandomState(0), 16, n_train=96)
collectives.barrier(dp2)
cli = ["--config", "mini", "--device", "cpu", "--epochs", "2", "--override", "OUTPUT_DIR=out",
       "--override", "model.hidden_dim=128", "--override", "model.embed_dim=64",
       "--override", "training.batch_size=32", "--override", "eval.batch_size=16",
       "--override", "model.num_scales=20", "--override", "optim.warmup=0"]
res = train_pose_mini.main(cli + ["--mesh", "dp2", "--log_name", "dp"])
out["cli_dp_hist"] = np.array(res["history"])
if rank == 0:
    res = train_pose_mini.main(cli + ["--mesh", "off", "--log_name", "off"])
    out["cli_off_hist"] = np.array(res["history"])
collectives.barrier(dp2)
np.savez(f"{root}/out{rank}.npz", **out)
print("RESULT ok")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train2")
    rng = np.random.RandomState(0)
    jcfg = jsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64, dropout=0.0)
    jparams = jsm.init_params(jax.random.PRNGKey(4), jcfg)
    batch = rng.randn(B, 17, 3).astype(np.float32) * 0.3
    t_fix = rng.rand(B).astype(np.float32) * (T - EPS) + EPS
    z = rng.randn(B, 17, 3).astype(np.float32)
    inputs = dict(params=jax.tree.map(np.asarray, jparams), batch=batch, T=T, OPTIM=OPTIM,
                  u=((t_fix - EPS) / (T - EPS)).astype(np.float32), z=z)
    np.save(d / "inputs.npy", inputs, allow_pickle=True)
    mpc.run_ranks(["-c", CHILD, str(d)], 2, timeout=120, env={"OMP_NUM_THREADS": "2"})
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(2)]
    return inputs, jcfg, jparams, outs


def _close(got, want, rtol=1e-4):
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-12))


def _pick(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def test_dp2_step_matches_jax_sharded_step(run, monkeypatch):
    inputs, jcfg, jparams, outs = run
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(inputs["u"]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(inputs["z"], dtype))
    jconf = ml_collections.ConfigDict()
    jconf.optim = ml_collections.ConfigDict(OPTIM)
    optimizer = jlosses.get_optimizer(jconf)
    sde = jsde.SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=T)
    mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    step, bsh = jtrainer.make_sharded_train_step(mesh, sde, jsm.apply, jcfg, optimizer,
                                                 reduce_mean=True)
    state = jlosses.init_train_state(jparams, optimizer, 0.9999)
    new, loss = step(state, jax.random.PRNGKey(0), jax.device_put(inputs["batch"], bsh),
                     None, None)

    def apply(p, x, labels, cond, msk, train=False, rng=None):
        return jsm.apply(p, jcfg, x, labels, cond, msk, train=train, rng=rng)

    loss_fn = jlosses.get_sde_loss_fn(sde, apply, train=True, reduce_mean=True)
    jgrads = jckpt.tree_to_flat(jax.grad(loss_fn)(jparams, jax.random.PRNGKey(0),
                                                  jnp.asarray(inputs["batch"])))
    out = outs[0]
    np.testing.assert_allclose(out["dp_loss"], float(loss), rtol=2e-5)
    grads = _pick(out, "dp_grad/")
    assert set(grads) == set(jgrads) - {"sigmas"}
    for name, g in grads.items():
        _close(g, np.asarray(jgrads[name]))
    want = jckpt.tree_to_flat(new.params)
    for name, p in _pick(out, "dp_param/").items():
        np.testing.assert_allclose(p, np.asarray(want[name]), atol=1e-4, rtol=1e-3, err_msg=name)


def test_dp2_replicas_stay_bit_identical(run):
    _, _, _, outs = run
    for key in outs[0]:
        if key.startswith(("dp_", "loop_", "cli_dp")) and key in outs[1]:
            np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)


def test_tp_forward_matches_replicated_and_jax(run):
    inputs, _, _, outs = run
    out = outs[0]
    np.testing.assert_allclose(out["tp_forward"], out["full_forward"], atol=2e-5)
    cfg = jsm.ScoreMLPConfig(hidden_dim=128, embed_dim=64)
    want = jsm.apply(jax.tree.map(jnp.asarray, inputs["params"]), cfg,
                     jnp.asarray(inputs["batch"]), jnp.full((B,), 42.0))
    np.testing.assert_allclose(out["tp_forward"], np.asarray(want), atol=2e-5)


def test_tp_step_matches_one_device(run):
    """dp1,tp2 with dropout 0.25: the masks of the global batch, each rank
    its channels; loss, gradients (the replicated leaves' summed over the
    model axis, the clip's norm global) and parameters after the step."""
    _, _, _, outs = run
    out = outs[0]
    np.testing.assert_allclose(out["tp_loss"], out["tp_single_loss"], rtol=1e-5)
    for name, g in _pick(out, "tp_grad/").items():
        _close(g, out["tp_single_grad/" + name], rtol=1e-5)
    for name, p in _pick(out, "tp_param/").items():
        np.testing.assert_allclose(p, out["tp_single_param/" + name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    for key in out:
        if key.startswith("tp_"):  # both model ranks hold the same gathered values
            np.testing.assert_array_equal(out[key], outs[1][key], err_msg=key)


def test_smoke_update_check_rejects_unsummed_tp_gradients(run):
    """chip_smoke's training check on the card (each leaf's update from the
    start against one device's, in L2 norm) passes the dp1,tp2 step and
    rejects the same step with the replicated leaves' gradients left
    unsummed over the model axis, and an unchanged state."""
    out = run[3][0]

    def leaves(prefix):
        return {n: torch.from_numpy(v) for n, v in _pick(out, prefix).items()}

    init, want = leaves("tp_init/"), leaves("tp_single_param/")
    tol = chip_smoke.TRAIN_UPDATE_RTOL
    for params, ok in ((leaves("tp_param/"), True), (leaves("unsummed_param/"), False),
                       (init, False)):
        worst = max(chip_smoke.train_update_errors(init, params, want).values())
        assert (worst <= tol) == ok, worst


@pytest.mark.parametrize("tag", ["dp", "tp"])
def test_train_loop_on_a_mesh_matches_one_device(run, tag):
    """train_loop(mesh=...) (dropout 0.25, eval epoch 0): the epoch losses
    and weights of one device, as tests/test_cli_e2e.py:958 holds JAX's."""
    out = run[3][0]
    np.testing.assert_allclose(out[f"loop_{tag}_hist"], out["loop_single_hist"], rtol=1e-5)
    np.testing.assert_allclose(out[f"loop_{tag}_w"], out["loop_single_w"], atol=1e-4, rtol=1e-3)


def test_resume_under_a_mesh(run):
    """From a dp2 checkpoint of epoch 3: under dp2 bit for bit the
    uninterrupted dp2 run; under dp1,tp2 the same run at f32 rounding. A
    checkpoint written under tensor parallelism holds the full layout."""
    out = run[3][0]
    assert len(out["loop_resumed_dp_hist"]) == 2
    for key in ("w", "ema"):
        np.testing.assert_array_equal(out[f"loop_resumed_dp_{key}"], out[f"loop_full_{key}"])
    np.testing.assert_array_equal(out["loop_resumed_dp_hist"], out["loop_full_hist"][3:])
    np.testing.assert_allclose(out["loop_resumed_tp_hist"], out["loop_full_hist"][3:], rtol=1e-5)
    np.testing.assert_allclose(out["loop_resumed_tp_w"], out["loop_full_w"], atol=1e-4, rtol=1e-3)
    assert tuple(out["tp_ckpt_shape"]) == (128, 128)


def test_train_cli_mesh_dp2_matches_mesh_off(run):
    out = run[3][0]
    assert len(out["cli_dp_hist"]) == 2 and np.isfinite(out["cli_dp_hist"]).all()
    np.testing.assert_allclose(out["cli_dp_hist"], out["cli_off_hist"], rtol=1e-5)


CHILD_DP2_TP2 = r"""
import sys
sys.modules["torch.utils.tensorboard"] = None
import numpy as np
import torch
import torch.distributed as dist
from zedo_tpu_torch.parallel import mesh as mesh_lib
mesh_lib.init_distributed(device="cpu")
from zedo_tpu_torch import presets
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.parallel import tensor_parallel as tp_lib
from zedo_tpu_torch.train import trainer

root = sys.argv[1]
config = presets.optim_config("mini")
config.training.batch_size, config.model.num_scales, config.eval.batch_size = 16, 20, 16
config.optim.warmup = 0  # lr 2e-4 from the first step, so the weights move
class FakeDS:
    db_3d = np.random.RandomState(0).randn(64, 17, 3).astype(np.float32) * 0.1
mcfg = score_mlp.ScoreMLPConfig(hidden_dim=128, embed_dim=64, n_blocks=1, num_scales=20)
mesh = mesh_lib.mesh_from_spec("dp2,tp2", device="cpu")
assert mesh.shape == {"data": 2, "model": 2}
tcfg = trainer.TrainerConfig(n_epochs=2, eval_freq=100, seed=0)
state, hist, _ = trainer.train_loop(config, FakeDS(), output_dir=f"{root}/mesh", model_cfg=mcfg,
                                    device="cpu", mesh=mesh, trainer_cfg=tcfg)
rules = tp_lib.check(score_mlp.init_params(torch.Generator(), mcfg, device="cpu"), mcfg, mesh)
w = tp_lib.gather_tree(state.params, rules, mesh)["pre_dense"]["weight"].detach().numpy()
out = {"hist": np.array(hist), "w": w}
if dist.get_rank() == 0:
    single, single_hist, _ = trainer.train_loop(config, FakeDS(), output_dir=f"{root}/single",
                                                model_cfg=mcfg, device="cpu", trainer_cfg=tcfg)
    out["single_hist"] = np.array(single_hist)
    out["single_w"] = single.params["pre_dense"]["weight"].detach().numpy()
np.savez(f"{root}/out{dist.get_rank()}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def test_train_loop_on_dp2_tp2_matches_one_device(tmp_path):
    """Four Gloo ranks, a 2 x 2 mesh: each rank's rows of the global batch
    and its channels of the model; the replicated leaves' gradients summed
    over the model axis, then every gradient averaged over the data axis.
    The epoch losses and weights of one device (1e-5 relative; 1e-4 + 1e-3
    relative), the same on all four ranks."""
    mpc.run_ranks(["-c", CHILD_DP2_TP2, str(tmp_path)], 4, timeout=120,
                  env={"OMP_NUM_THREADS": "1"})
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(4)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["hist"], outs[0]["hist"])
        np.testing.assert_array_equal(out["w"], outs[0]["w"])
    np.testing.assert_allclose(outs[0]["hist"], outs[0]["single_hist"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["w"], outs[0]["single_w"], atol=1e-4, rtol=1e-3)
