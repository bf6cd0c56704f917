"""The port's data parallelism (``imm_tpu_torch.parallel``, the ``mesh``
paths of ``train/steps.py``, ``train/loop.py`` and ``experiment.py``) on the
CPU: ranks are ``gloo`` processes started by
``imm_tpu_torch.parallel.dryrun.spawn``, and held to one process and to the
JAX package's 8-way ``shard_map`` step on the same weights and images.

Tolerances. One SGD step, 2 ranks x 8 images against 1 process x 16 and
against JAX's 8 x 2: parameters and BatchNorm statistics 1e-5 absolute and
the loss 1e-5 relative, as ``tests/test_parallel.py`` holds JAX's sharded
step to its single-device step (float32 sums in another order; the ranks'
BatchNorm takes E[x^2] - E[x]^2 where one process takes the two-pass
variance). Between ranks: equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from imm_tpu.data import PairConfig as JaxPairConfig
from imm_tpu.data import PairSynthesizer as JaxPairSynthesizer
from imm_tpu.data.datasets import get_dataset as jax_get_dataset
from imm_tpu.losses.perceptual import PerceptualLossConfig as JaxLossConfig
from imm_tpu.losses.perceptual import ReconstructionLoss as JaxLoss
from imm_tpu.models.imm import IMM as JaxIMM
from imm_tpu.models.imm import IMMConfig as JaxIMMConfig
from imm_tpu.parallel import make_mesh as jax_make_mesh
from imm_tpu.parallel import replicate as jax_replicate
from imm_tpu.parallel import shard_batch as jax_shard_batch
from imm_tpu.parallel.distributed import shard_items as jax_shard_items
from imm_tpu.train import state as jax_state
from imm_tpu.train import steps as jax_steps
from imm_tpu_torch.configs import get_preset
from imm_tpu_torch.data.datasets import get_dataset
from imm_tpu_torch.models.convert import collection_from_flax
from imm_tpu_torch.models.imm import IMMConfig
from imm_tpu_torch.parallel import dryrun
from imm_tpu_torch.parallel.distributed import initialize_multihost
from imm_tpu_torch.parallel.mesh import make_mesh, rank_seed, replicate, shard_batch
from imm_tpu_torch.utils.config import DataConfig, PerceptualLossConfig, TrainConfig
from tests.test_torch_data import make_celeba
from tests.torch_parity import TINY, images, jax_model, n, port_model, t

B = 16
LOSS = dict(feature_source="pixel", weights=(1.0, 0.5, 2.0))
SGD = dict(optimizer="sgd", learning_rate=1e-3, lr_boundaries=(), lr_factors=(1.0,))


def _ranks(tmp_path, worker, inputs, n=2):
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    dryrun.spawn(worker, n, str(path), "cpu", device="cpu", threads=1)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)]


def test_two_ranks_one_step_equal_one_process_and_jax_shard_map(tmp_path):
    _, variables = jax_model()
    imgs = images(21, batch=B)
    inputs = dict(
        model=IMMConfig(**TINY), loss=PerceptualLossConfig(**LOSS), train=TrainConfig(**SGD),
        state_dict=port_model(variables).state_dict(), loss_ema=torch.ones(3),
        source=t(imgs), target=t(imgs),
    )
    one = dryrun.injected_steps(inputs, "cpu")
    r0, r1 = _ranks(tmp_path, dryrun.injected_step_worker, inputs)
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    assert torch.equal(r0["loss_ema"], r1["loss_ema"]) and r0["metrics"] == r1["metrics"]

    # JAX: 8-way shard_map, BatchNorm over the 'data' axis; warp and jitter
    # off, so source = target = the images, as injected above
    jmodel = JaxIMM(JaxIMMConfig(**TINY, axis_name="data"))
    jloss = JaxLoss(JaxLossConfig(**LOSS))
    jtc = jax_state.TrainConfig(batch_size=B, **SGD)
    jopt = jax_state.make_optimizer(jtc)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=jopt.init(params), loss_ema=jnp.ones((3,), jnp.float32), ema_params=None,
    )
    mesh = jax_make_mesh(8)
    pair = JaxPairSynthesizer(JaxPairConfig(enable_warp=False, enable_jitter=False))
    step = jax_steps.make_train_step(jmodel, jloss, jtc, pair, "tps", donate=False, mesh=mesh)
    jout, jm = step(jax_replicate(jstate, mesh), jax_shard_batch({"image": jnp.asarray(imgs)}, mesh),
                    jax.random.PRNGKey(7))
    want = collection_from_flax(jout.params)
    want.update(collection_from_flax(jout.batch_stats, "batch_stats"))

    loss2, loss1 = r0["metrics"]["loss/total"], one["metrics"]["loss/total"]
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    np.testing.assert_allclose(loss2, float(jm["loss/total"]), rtol=1e-5)
    np.testing.assert_allclose(n(r0["loss_ema"]), n(one["loss_ema"]), rtol=1e-5)
    np.testing.assert_allclose(n(r0["loss_ema"]), n(jout.loss_ema), rtol=1e-5)
    before = inputs["state_dict"]
    for k, v in r0["state_dict"].items():
        np.testing.assert_allclose(n(v), n(one["state_dict"][k]), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(n(v), n(want[k]), atol=1e-5, err_msg=k)
        if "running" in k:  # every batch statistic moved, on the global batch's values
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("equi_weight", [0.0, 0.5], ids=["plain", "equivariance"])
def test_two_rank_synthetic_windows_keep_the_ranks_identical(tmp_path, equi_weight):
    """Two windows of two steps each, every rank drawing its own images:
    the ranks' parameters, statistics and loss EMA stay equal bit for bit."""
    cfg = get_preset("tiny_cpu")
    cfg = dataclasses.replace(cfg, eval_every=0, train=dataclasses.replace(
        cfg.train, batch_size=B, steps_per_call=2, equi_weight=equi_weight))
    r0, r1 = _ranks(tmp_path, dryrun.experiment_worker, dict(config=cfg, steps=4))
    for r in (r0, r1):
        assert r["world"] == 2 and r["host_step"] == 4 and r["same_on_every_rank"]
        assert all(np.isfinite(v) for h in r["history"] for v in h.values())
        assert ("loss/equi" in r["history"][-1]) == (equi_weight > 0)
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    assert torch.equal(r0["loss_ema"], r1["loss_ema"])
    # the averaged metrics are the same on both ranks; the rates are each rank's own
    metrics = [{k: v for k, v in r["history"][-1].items() if k != "images_per_sec"} for r in (r0, r1)]
    assert metrics[0] == metrics[1]


def test_two_rank_run_in_pieces_equals_the_uncut_run_on_each_rank(tmp_path):
    """Two ranks trained 2N steps in one experiment, and N steps, then a
    fresh experiment resuming from the workdir for N more, all in one
    process group: equal bit for bit on each rank, generators included.
    Rank 0's checkpoint holds both ranks' generator states."""
    cfg = get_preset("tiny_cpu")
    cfg = dataclasses.replace(cfg, eval_every=0, train=dataclasses.replace(
        cfg.train, batch_size=B, steps_per_call=1))
    n_steps, calls = 2, []
    for name, workdir, steps in (("whole", "whole_w", 2 * n_steps), ("piece1", "pieces_w", n_steps),
                                 ("piece2", "pieces_w", 2 * n_steps)):
        (tmp_path / name).mkdir()
        inputs = dict(config=dataclasses.replace(cfg, workdir=str(tmp_path / workdir)), steps=steps)
        torch.save(inputs, tmp_path / name / "inputs.pt")
        calls.append((dryrun.experiment_worker, (str(tmp_path / name / "inputs.pt"), "cpu")))
    dryrun.spawn(dryrun.worker_sequence, 2, calls, device="cpu", threads=1)

    def out(name, r):
        return torch.load(tmp_path / name / f"rank{r}.pt", weights_only=False)

    flat = torch.load(tmp_path / "pieces_w" / "checkpoints" / str(n_steps) / "state.pt",
                      weights_only=True)
    for r in (0, 1):
        whole, pieced = out("whole", r), out("piece2", r)
        assert pieced["host_step"] == whole["host_step"] == 2 * n_steps
        for k, v in whole["state_dict"].items():
            assert torch.equal(v, pieced["state_dict"][k]), (r, k)
        assert torch.equal(whole["loss_ema"], pieced["loss_ema"])
        assert torch.equal(whole["rng"], pieced["rng"])
        assert torch.equal(flat[f"trainer/rng/{r}"], out("piece1", r)["rng"])
    assert not torch.equal(out("whole", 0)["rng"], out("whole", 1)["rng"])  # streams of their own


def test_two_rank_run_on_files_shards_them_as_the_jax_package(tmp_path):
    """``celeba`` on the committed fixtures, 8 images a step over 2 ranks:
    each rank feeds 4 images from its interleaved half of the files, from
    ``seed + rank``, the same images as ``imm_tpu``'s loader of that shard;
    the ranks end with the same parameters."""
    root = tmp_path / "celeba"
    make_celeba(str(root))
    cfg = get_preset("tiny_cpu")
    cfg = dataclasses.replace(
        cfg, eval_every=0, data=DataConfig(source="celeba", root=str(root), pair_mode="tps"),
        train=dataclasses.replace(cfg.train, batch_size=8, steps_per_call=2))
    ranks = _ranks(tmp_path, dryrun.experiment_worker, dict(config=cfg, steps=4))
    for r in ranks:
        assert r["host_step"] == 4 and r["same_on_every_rank"]
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k
    files = []
    for rank in range(2):
        port = get_dataset("celeba", str(root), image_size=32, device="cpu")
        ref = jax_get_dataset("celeba", str(root), image_size=32)
        shard = port._sharded_train_files((rank, 2))
        assert shard == jax_shard_items(ref._train_files(), (rank, 2))
        files += shard
        seed = cfg.train.seed + rank
        got = next(port.train_batches(4, seed=seed, n_batches=1, shard=(rank, 2)))
        want = next(ref.train_batches(4, seed=seed, n_batches=1, shard=(rank, 2)))
        np.testing.assert_array_equal(got["image"].numpy(), want["image"])
    assert sorted(files) == sorted(port._train_files())


def test_single_process_helpers():
    assert initialize_multihost(device="cpu") is False  # no launcher: a no-op
    assert initialize_multihost(device="cpu") is False  # and twice
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.shape) == (1, 0, None, {"data": 1})
    assert make_mesh(1) == mesh
    with pytest.raises(ValueError, match="only 1 visible"):
        make_mesh(2)
    batch = {"image": torch.arange(6.0).reshape(6, 1)}
    assert torch.equal(shard_batch(batch, mesh)["image"], batch["image"])
    two = dataclasses.replace(mesh, size=2, rank=1)
    assert torch.equal(shard_batch(batch, two)["image"], batch["image"][3:])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(torch.zeros(5), two)
    x = torch.ones(3)
    assert replicate(x, mesh) is x
    assert rank_seed(7, 0) == 7 and len({rank_seed(7, r) for r in range(4)}) == 4


def test_dryrun_multichip_two_ranks(capsys):
    """``python -m imm_tpu_torch.parallel.dryrun 2 --device cpu`` (the card
    is the default)."""
    assert dryrun.main(["2", "--device", "cpu"]) == 0
    assert "2 steps of tiny_cpu on 2 gloo ranks (cpu)" in capsys.readouterr().out


def test_batchnorm_variance_follows_axis_name():
    """Train-mode BatchNorm with ``axis_name`` takes flax's E[x^2] - E[x]^2
    in one process too (what the ranks take, and flax's default), without
    it the two-pass variance; on inputs whose mean is large against their
    spread the two differ."""
    from imm_tpu_torch.models.nets import FlaxBatchNorm

    x = (np.random.default_rng(5).standard_normal((8, 6, 6, 4)) * 0.05 + 3.0).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    mean = xt.mean(dim=(0, 2, 3))
    fast_var = torch.clamp(xt.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
    two_var = xt.var(dim=(0, 2, 3), unbiased=False)
    assert not torch.equal(fast_var, two_var)
    for axis_name, var in ((None, two_var), ("data", fast_var)):
        bn = FlaxBatchNorm(4, axis_name=axis_name).train()
        y = bn(xt)
        want = (xt - mean[:, None, None]) * torch.rsqrt(var + bn.eps)[:, None, None]
        assert torch.equal(y, want), axis_name
        assert torch.equal(bn.running_var, 0.9 + 0.1 * var), axis_name


def test_step_refuses_a_mesh_without_batchnorm_axis():
    """Several ranks over BatchNorm without ``axis_name`` would normalise each
    rank with its own statistics: refused."""
    from imm_tpu_torch.data.pairs import PairSynthesizer
    from imm_tpu_torch.losses.perceptual import ReconstructionLoss
    from imm_tpu_torch.models.imm import init_model
    from imm_tpu_torch.train import steps

    model = init_model(IMMConfig(**TINY), device="cpu")
    loss = ReconstructionLoss(PerceptualLossConfig(**LOSS), device="cpu")
    two = dataclasses.replace(make_mesh(), size=2)
    with pytest.raises(ValueError, match="axis_name"):
        steps.make_train_step(model, loss, TrainConfig(), PairSynthesizer(), mesh=two)
    with pytest.raises(ValueError, match="unknown pair mode"):
        steps.make_train_step(model, loss, TrainConfig(), PairSynthesizer(), "video")
