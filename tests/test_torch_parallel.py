"""PyTorch port, data parallelism (`parallel/`) in one process, held against
the JAX package on the CPU:

- the FSDP placement (`parallel/fsdp.py::param_shard_dim`) equals JAX's
  `fsdp_spec` on every parameter of the flagship and of path A at full
  width (the flax kernel (in, out) read as the port's weight (out, in)),
  for 2, 4 and 8 ranks;
- `local_rows` shares a batch as `shard_batch` does, and raises for one
  the ranks cannot share;
- the global loss reduction, emulated over the two halves of a batch with
  ragged masks (`BatchShard` with the other half's mask count): the two
  shares add up to JAX's loss over the whole batch within 1e-6, their
  gradients to JAX's within 1e-5, while the mean of the halves' own losses
  (a DDP wrapper's reduction) misses by more than 1e-3;
- the normaliser's statistics updated by two halves in lockstep (two
  threads whose `reduce` sums over both) equal the whole batch's update in
  one process within 1e-6;
- `trainer.strategy`: the strategies not ported (pp, dp_pp) and the model
  axis's (dp_tp, sp, dp_ep) in one process raise NotImplementedError
  naming ROADMAP Queue 1 item 7, an unknown one ValueError, fsdp without a
  process group NotImplementedError (tests/test_strategy.py's
  `test_strategy_validation` is the JAX counterpart);
- one process starts no process group; PFM_MULTIHOST=1 outside torchrun
  raises; importing every module of the port, `parallel/` included (the
  mesh and the tensor and expert placements too), loads no JAX.

Two processes: tests/test_torch_parallel_multiproc.py (against JAX dp) and
tests/test_torch_parallel_cli.py (the entry points under torchrun).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.losses import flow_matching as jloss
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.parallel.fsdp import fsdp_spec
from particle_fm_tpu_torch.config.core import compose
from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.nets.norm_layer import IterativeNormLayer
from particle_fm_tpu_torch.parallel import dist
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.fsdp import param_shard_dim
from particle_fm_tpu_torch.train import CONFIG_DIR
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from tests.torch_port_helpers import YAML_FLAGSHIP, cloud, grads_by_name, model_pair, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH_A = ["experiment=jetnet/fm_tops150_cond", "model=fm_droid_transformer"]
FLAGSHIP = ["experiment=jetnet/fm_tops150_cond"]


def _model_cfg(overrides):
    cfg = compose(CONFIG_DIR, "train", overrides)["model"]
    return {k: v for k, v in cfg.items() if k not in ("_target_", "optimizer", "scheduler")}


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("overrides", [FLAGSHIP, PATH_A], ids=["flagship", "path_A"])
def test_fsdp_placement_equals_jax_fsdp_spec(overrides, world):
    cfg = _model_cfg(overrides)
    shapes = jax.eval_shape(lambda: JaxModel(**cfg).init(jax.random.PRNGKey(0)))["params"]
    flax = state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    net = PortModel(**cfg).init(device="cpu")
    names = [n for n, _ in net.named_parameters()]
    assert sorted(names) == sorted(flax)
    sharded = 0
    for name, p in net.named_parameters():
        jax_shape = tuple(flax[name].shape)
        transposed = name.rpartition(".")[2] in ("weight", "weight_v") and p.ndim == 2
        spec = fsdp_spec(jax_shape[::-1] if transposed else jax_shape, world)
        jax_dim = next((i for i, a in enumerate(spec) if a == "data"), None)
        if transposed and jax_dim is not None:
            jax_dim = 1 - jax_dim
        assert param_shard_dim(name, tuple(p.shape), world) == jax_dim, (name, p.shape, spec)
        sharded += jax_dim is not None
    assert sharded >= len(names) // 2


def test_local_rows_share_a_batch_as_shard_batch_does():
    assert [dist.local_rows(12, r, 3) for r in range(3)] == [slice(0, 4), slice(4, 8),
                                                             slice(8, 12)]
    assert dist.local_rows(5) == slice(0, 5)  # one process: every row
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        dist.local_rows(7, 0, 2)


def _halves_shards(mask: np.ndarray, world: int = 2):
    """A BatchShard per half whose `reduce` turns the half's mask count into
    the whole batch's (what the all-reduce returns)."""
    total = float(mask.sum())
    halves = [float(mask[dist.local_rows(len(mask), r, world)].sum()) for r in range(world)]

    def reduce_of(r):
        def reduce(v):
            assert float(v) == halves[r]
            return torch.tensor(total)
        return reduce
    return [BatchShard(r, world, reduce_of(r)) for r in range(world)]


def test_global_loss_over_two_halves_equals_jax_and_local_means_miss(monkeypatch):
    cfg = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6)
    jm, variables, pm, net = model_pair(cfg, fill=0.1)
    x, mask, cond, _ = cloud(b=8, n=16, seed=30)
    rs = np.random.RandomState(2)
    t_arr, z_arr = rs.rand(8).astype(np.float32), rs.randn(*x.shape).astype(np.float32)
    counts = [mask[:4].sum(), mask[4:].sum()]
    assert counts[0] != counts[1]  # the halves hold different numbers of real particles
    monkeypatch.setattr(jloss, "_sample_t", lambda _r, size, _w: jnp.asarray(t_arr))
    monkeypatch.setattr(jloss, "_normal", lambda _r, shape, _w: jnp.asarray(z_arr))

    def jax_loss(params):
        return jm.loss({"params": params}, jax.random.PRNGKey(0), jnp.asarray(x),
                       mask=jnp.asarray(mask), cond=jnp.asarray(cond), train=True)[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss))(variables["params"])
    j_grads = grads_by_name(j_grads)

    def pinned(ts, zs):
        monkeypatch.setattr(ploss, "_sample_t", lambda _g, size, d: t(ts))
        monkeypatch.setattr(ploss, "_normal", lambda _g, shape, d: t(zs))

    pinned(t_arr, z_arr)  # the global draws: each shard keeps its rows
    shares, grads = [], []
    for shard in _halves_shards(mask):
        rows = dist.local_rows(8, shard.rank, 2)
        loss = pm.loss(net, torch.Generator(), t(x[rows]), mask=t(mask[rows]),
                       cond=t(cond[rows]), train=True, shard=shard)
        grads.append(pstep._grads(loss, list(net.parameters())))
        shares.append(float(loss.detach()))
    np.testing.assert_allclose(sum(shares), float(j_loss), rtol=1e-6)
    for (name, _), g0, g1 in zip(net.named_parameters(), *grads):
        np.testing.assert_allclose((g0 + g1).numpy(), j_grads[name], atol=1e-5, err_msg=name)
    # each half normalised by its own mask count, the two averaged
    local = []
    for r in range(2):
        rows = dist.local_rows(8, r, 2)
        pinned(t_arr[rows], z_arr[rows])
        with torch.no_grad():
            local.append(float(pm.loss(net, torch.Generator(), t(x[rows]), mask=t(mask[rows]),
                                       cond=t(cond[rows]), train=True)))
    assert abs(np.mean(local) - float(j_loss)) > 1e-3 * abs(float(j_loss))
    # the accumulation weight of a shard is the global microbatch's mass
    w = pm.loss_accum_weight(t(x[:4]), t(mask[:4]), shard=_halves_shards(mask)[0])
    assert float(w) == float(mask.sum())


def test_normaliser_update_over_two_halves_in_lockstep_equals_the_whole_batch():
    rs = np.random.RandomState(4)
    x, mask, _, _ = cloud(b=8, n=16, seed=31)
    x = (x * 3.0 + 1.5) * mask
    barrier, box = threading.Barrier(2), {}

    def reduce_of(r):
        def reduce(v):  # the sum over the two threads, as an all-reduce returns it
            box[r] = v.clone()
            barrier.wait()
            out = box[0] + box[1]
            barrier.wait()
            return out
        return reduce

    whole = IterativeNormLayer(3)
    halves = [IterativeNormLayer(3) for _ in range(2)]
    for layer in [whole] + halves:  # a second update: the Welford branch
        with torch.no_grad():
            layer.means.copy_(torch.from_numpy(rs.randn(3).astype(np.float32)))
            layer.n.fill_(40.0)
    halves[1].load_state_dict(halves[0].state_dict())
    whole.load_state_dict(halves[0].state_dict())
    whole.update(t(x), t(mask))

    def run(r):
        rows = dist.local_rows(8, r, 2)
        halves[r].update(t(x[rows]), t(mask[rows]), BatchShard(r, 2, reduce_of(r)))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    for half in halves:
        for key, v in whole.state_dict().items():
            np.testing.assert_allclose(half.state_dict()[key].numpy(), v.numpy(), rtol=1e-6,
                                       err_msg=key)
    assert float(halves[0].n) == 40.0 + float(mask.sum())


@pytest.mark.parametrize("strategy,error,match", [
    ("dp_tp", NotImplementedError, "Queue 1 item 7"),
    ("sp", NotImplementedError, "Queue 1 item 7"),
    ("pp", ValueError, "divisible by model_axis_size"),  # one process: one stage only
    ("dp_pp", ValueError, "divisible by model_axis_size"),
    ("dp_ep", NotImplementedError, "Queue 1 item 7"),
    ("ddp", ValueError, "unknown trainer.strategy"),
    ("bogus", ValueError, "unknown trainer.strategy"),
    ("fsdp", NotImplementedError, "process group"),
])
def test_strategy_validation(strategy, error, match):
    model = PortModel(**dict(YAML_FLAGSHIP))
    with pytest.raises(error, match=match):
        Trainer(model=model, datamodule=None, optimizer=pstep.make_optimizer(),
                strategy=strategy, device="cpu")


def test_summed_tensors_start_aligned_in_the_flat_buffer(monkeypatch):
    """Each tensor of a summed list is a view that starts 16-byte aligned
    (the clip's CUDA `_foreach_norm` sums a misaligned view in another
    order: ROADMAP Queue 3 item 15), with the values of a plain sum."""
    monkeypatch.setattr(dist, "all_reduce_sum_", lambda t, group=None: t * 2)
    ts = [torch.randn(()), torch.randn(3, 5), torch.randn(7), torch.randn(2, 2, 3)]
    out = dist.all_reduce_tensors_(ts)
    assert [o.shape for o in out] == [t.shape for t in ts]
    assert all(torch.equal(o, 2 * t) for o, t in zip(out, ts))
    assert all(o.data_ptr() % dist.SEGMENT_ALIGN_BYTES == 0 for o in out)


def test_one_process_starts_no_group_and_multihost_needs_torchrun(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "PFM_MULTIHOST"):
        monkeypatch.delenv(key, raising=False)
    assert dist.maybe_initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world_size(), dist.is_rank_zero()) == (0, 1, True)
    monkeypatch.setenv("PFM_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="torchrun"):
        dist.maybe_initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


# the port's scripts of the reference import, the classifier test and the
# other JAX scripts: each is imported, and none names JAX or its package in an
# import, lazy ones included
PORTED_SCRIPTS = ["torch_import_reference_ckpt", "torch_classifier_test", "torch_guidance_sweep",
                  "torch_generate_jets_jetclass", "torch_timing_plots",
                  "torch_prepare_dataset_jetclass", "torch_preprocessing_calo_challenge"]


def test_importing_every_module_of_the_port_loads_no_jax():
    code = (f"SCRIPTS = {PORTED_SCRIPTS!r}\n"
            "import pkgutil, importlib, sys, particle_fm_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "assert 'particle_fm_tpu_torch.parallel.dist' in mods, mods\n"
            "assert 'particle_fm_tpu_torch.parallel.fsdp' in mods, mods\n"
            "assert 'particle_fm_tpu_torch.parallel.mesh' in mods, mods\n"
            "assert 'particle_fm_tpu_torch.parallel.tp' in mods, mods\n"
            "assert 'particle_fm_tpu_torch.parallel.pp' in mods, mods\n"
            "new = {'training.epochs', 'training.stopping', 'training.hparam', "
            "'utils.torch_import', 'utils.helpers', 'utils.pylogger'}\n"
            "assert {'particle_fm_tpu_torch.' + m for m in new} <= set(mods), mods\n"
            "[importlib.import_module(m) for m in mods]\n"
            "import ast\n"
            "for name in SCRIPTS:\n"
            "    importlib.import_module('scripts.' + name)\n"
            "    tree = ast.parse(open(f'scripts/{name}.py').read())\n"
            "    for node in ast.walk(tree):\n"
            "        if isinstance(node, (ast.Import, ast.ImportFrom)):\n"
            "            names = [a.name for a in node.names] if isinstance(node, ast.Import) "
            "else [node.module or '']\n"
            "            assert not [n for n in names if n.split('.')[0] in "
            "('jax', 'flax', 'optax', 'particle_fm_tpu')], (name, names)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'particle_fm_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=300)
