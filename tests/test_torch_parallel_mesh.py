"""PyTorch port, the (data, model) mesh (`parallel/mesh.py`, `parallel/tp.py`)
in one process, held against the JAX package on the CPU:

- the rank -> (data, model) coordinates equal the places of
  `make_mesh(data, model, devices)`'s devices;
- for each parameter, the entries each model rank holds equal those of
  JAX's `tree_shardings` under `epic_tp_rules` (dp_tp) and `moe_ep_rules`
  (dp_ep), the flax kernel (in, out) read as the port's weight (out, in),
  with the even-divide rule (H = 30 over 4 ranks, 3 experts over 2); except
  the row-parallel `fc_local2`/`fc_l2` weights, where the port splits the H
  particle columns and keeps the per-set columns whole: pinned here, equal
  to JAX's where the layer has no per-set columns (ROADMAP.md Queue 3);
- the parts in two threads whose collectives sum or gather over both
  (`ModelAxis` emulated) equal the whole network in one thread, forward and
  backward, within 1e-6 of the largest value: the Megatron EPiC net, the sp
  pool, the sp EPiC net and the sp transformer at an odd particle count
  (the last rank padded), the expert-parallel MoE transformer, and the sp
  training loss (the threads' shares add up to the whole loss, their
  gradients to its gradient);
- every refusal: pp and dp_pp, one process, a model axis that does not
  divide the world, sp on the families it does not run (cross-attention,
  MDMA, experts, CFM-OT), rules that split nothing, a sharded Dense folded.

Four processes: tests/test_torch_parallel_model_axis.py.
"""

from __future__ import annotations

import copy
import threading

import jax
import numpy as np
import pytest
import torch

from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from particle_fm_tpu.parallel.tp import epic_tp_rules, moe_ep_rules, tree_shardings
from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.ops.masked import meansum_pool
from particle_fm_tpu_torch.parallel import dist, tp
from particle_fm_tpu_torch.parallel.dist import BatchShard
from particle_fm_tpu_torch.parallel.mesh import ModelAxis, coords, sequence_parallel
from particle_fm_tpu_torch.training import step as pstep
from particle_fm_tpu_torch.training import trainer as ptrainer
from particle_fm_tpu_torch.training.trainer import Trainer
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from tests.torch_port_helpers import MDMA_SMALL, YAML_FLAGSHIP, cloud, droid_configs, t

TOL = 1e-6  # of the largest value, forward and backward
EPIC = dict(YAML_FLAGSHIP, t_emb="sincos", frequencies=6)
EPIC_NO_SET = dict(EPIC, t_local_cat=False, local_cond_dim=0)  # fc_local2 reads x_local1 alone
TRANSFORMER = droid_configs()["transformer"][0]
CROSS = droid_configs()["crossattention"][0]
MOE = copy.deepcopy(TRANSFORMER)
MOE["net_config"]["te_config"]["moe_config"] = dict(num_experts=4, hddn_dim=16,
                                                    capacity_factor=2.0)


def _with_experts(n: int) -> dict:
    cfg = copy.deepcopy(MOE)
    cfg["net_config"]["te_config"]["moe_config"]["num_experts"] = n
    return cfg


@pytest.mark.parametrize("data,model", [(2, 2), (4, 2), (2, 4)])
def test_rank_coordinates_equal_jax_make_mesh(data, model):
    devices = jax.devices()[:data * model]
    grid = np.array(jax_make_mesh(data=data, model=model, devices=devices).devices)
    for r, dev in enumerate(devices):
        assert tuple(int(i) for i in np.argwhere(grid == dev)[0]) == coords(r, model)


# ----------------------------------------------------------------- placements
def _jax_held(cfg, rules, data, model, j):
    """{port name: bool mask} of the entries model rank j (data coordinate 0)
    holds under JAX's rules, in the port's names and layouts."""
    jm = JaxModel(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    shardings = tree_shardings(params, mesh, epic_tp_rules() if rules == "epic" else moe_ep_rules())
    dev = mesh.devices[0, j]

    def held(a, sh):
        m = np.zeros(a.shape, np.float32)
        m[sh.devices_indices_map(a.shape)[dev]] = 1.0
        return m

    masks = jax.tree_util.tree_map(held, params, shardings)
    return {k: v.numpy().astype(bool) for k, v in state_dict_from_flax(masks).items()}


def _port_held(pl, shape, j, size):
    m = np.zeros(shape, bool)
    if pl is None:
        m[...] = True
    else:
        m[np.ix_(*pl.indices(shape, j, size))] = True
    return m


def _row_expected(cfg, name, shape, j, size):
    """The port's row-parallel placement of an EPiC second local Dense: the
    per-set columns whole, the particle columns of rank j."""
    tl = 2 * cfg["frequencies"] if cfg.get("t_local_cat") else 0
    h = cfg["hidden_dim"]
    if h % size:
        return np.ones(shape, bool)
    m = np.zeros(shape, bool)
    k = h // size
    m[:, :tl] = True
    m[:, tl + h:] = True
    m[:, tl + j * k: tl + (j + 1) * k] = True
    return m


@pytest.mark.parametrize("rules,cfg,data,size", [
    ("epic", EPIC, 2, 2),
    ("epic", EPIC_NO_SET, 2, 2),
    ("epic", dict(EPIC, hidden_dim=30), 2, 4),  # 30 does not split over 4: replicated
    ("moe", MOE, 2, 2),
    ("moe", MOE, 2, 4),
    ("moe", _with_experts(3), 2, 2),  # 3 experts do not split over 2: replicated
], ids=["epic-2", "epic_no_set_columns-2", "epic_h30-4", "moe-2", "moe-4", "moe_e3-2"])
def test_placements_equal_jax_tree_shardings(rules, cfg, data, size):
    net = PortModel(**cfg).init(device="cpu")
    placed = tp.placements(net, rules, size)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    split = [n for n, pl in placed.items() if pl is not None]
    divides = (cfg.get("hidden_dim", 0) % size == 0 if rules == "epic"
               else cfg["net_config"]["te_config"]["moe_config"]["num_experts"] % size == 0)
    assert bool(split) == divides
    rows = [n for n in shapes if n.rpartition(".")[0].endswith(("fc_local2", "fc_l2"))
            and n.endswith(("weight_v", "weight"))]
    for j in range(size):
        jax_held = _jax_held(cfg, rules, data, size, j)
        assert sorted(jax_held) == sorted(shapes)
        for name, shape in shapes.items():
            got = _port_held(placed[name], shape, j, size)
            if name in rows:
                np.testing.assert_array_equal(got, _row_expected(cfg, name, shape, j, size), name)
                if cfg is EPIC_NO_SET:  # no per-set columns: JAX's even split is the port's
                    np.testing.assert_array_equal(got, jax_held[name], name)
                continue
            np.testing.assert_array_equal(got, jax_held[name], f"{name} rank {j}")
    if cfg is EPIC:  # the per-set columns make the two row placements differ
        j0 = _jax_held(cfg, rules, data, size, 0)
        assert any(not np.array_equal(_port_held(placed[n], shapes[n], 0, size), j0[n])
                   for n in rows)


# ------------------------------------------------------- two threads in step
def thread_axes(size: int) -> list[ModelAxis]:
    """`size` model axes whose sum and gather run over the threads that
    call them in lockstep."""
    barrier, box = threading.Barrier(size), {}

    def axis(r):
        def exchange(v, combine):
            box[r] = v.detach().clone()
            barrier.wait()
            out = combine([box[i] for i in range(size)])
            barrier.wait()
            return out

        return ModelAxis(r, size, lambda v: exchange(v, lambda vs: sum(vs[1:], vs[0].clone())),
                         lambda v, dim: exchange(v, lambda vs: torch.cat(vs, dim=dim)))

    return [axis(r) for r in range(size)]


def in_threads(fn, size: int = 2) -> list:
    """fn(axis) on `size` threads in lockstep; their results."""
    axes, out, errors = thread_axes(size), [None] * size, []

    def run(r):
        try:
            out[r] = fn(axes[r])
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    return out


def _close(got, want, what: str):
    scale = max(float(want.detach().abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{what}: {err} against {scale}"


def _net(cfg, seed=0):
    net = PortModel(**cfg).init(seed=seed, device="cpu")
    with torch.no_grad():  # no zero-initialised layer: every path carries a value
        gen = torch.Generator().manual_seed(seed + 1)
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return net


def _inputs(n=15, b=4, feats=3, cond_dim=2, seed=3):
    x, mask, cond, tt = cloud(b=b, n=n, feats=feats, cond_dim=cond_dim, seed=seed)
    return t(x), t(mask), t(cond), t(tt)


def _whole(net, x, mask, cond, tt, real=None):
    out = net(tt, x, cond=cond, mask=mask)
    if real is not None:  # padding slots out of the loss, as the sp loss drops them
        out = out * real
    loss = torch.sum(out * torch.cos(out))
    return out.detach(), torch.autograd.grad(loss, list(net.parameters()))


@pytest.mark.parametrize("rules,cfg", [("epic", EPIC), ("moe", MOE)], ids=["dp_tp", "dp_ep"])
def test_model_axis_parts_equal_the_whole_net(rules, cfg):
    """The Megatron EPiC net (column-then-row local MLPs, one all-reduce a
    layer, the encoder's residual gathered) and the MoE transformer's
    expert-parallel combine, each model rank holding its parameters' part;
    and the gradient clip's global norm from the ranks' parts."""
    net = _net(cfg)
    x, mask, cond, tt = _inputs(n=16)
    want_out, want_grads = _whole(net, x, mask, cond, tt)
    names = [n for n, _ in net.named_parameters()]

    def part(axis):
        state = pstep.create_train_state(PortModel(**cfg), pstep.make_optimizer(), device="cpu")
        state.net.load_state_dict(net.state_dict())
        state.ema_params = [p.detach().clone() for p in state.net.parameters()]
        state = tp.shard_state_tp(state, axis, rules)
        held = {n: tuple(p.shape) for n, p in state.net.named_parameters()}
        out, grads = _whole(state.net, x, mask, cond, tt)
        whole = [g if pl is None else pl.whole(g, axis)
                 for g, pl in zip(grads, state.sharding.placed)]
        return out, whole, held, state.sharding.global_norm(list(grads))

    parts = in_threads(part)
    want_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(want_grads))))
    for out, grads, held, norm in parts:
        _close(out, want_out, "forward")
        # the clip's norm: split entries summed over the ranks, replicated ones once
        _close(norm, want_norm, "global norm")
        for n, g, w in zip(names, grads, want_grads):
            _close(g, w, f"gradient {n}")
    held = parts[0][2]
    if rules == "epic":
        h = cfg["hidden_dim"]
        assert held["flows.0.net.epic_layer_0.fc_local1.weight_v"][0] == h // 2
        assert held["flows.0.net.fc_l1.g"] == (h // 2,)
        assert held["flows.0.net.epic_layer_1.fc_local2.bias"] == (h,)
    else:
        assert held["flows.0.net.te.layer_0.moe.w1"][0] == 2  # 2 of the 4 experts
        assert held["flows.0.net.te.layer_0.moe.router.weight"] == tuple(
            net.state_dict()["flows.0.net.te.layer_0.moe.router.weight"].shape)


def test_sp_pool_parts_equal_the_whole():
    """The pool's sums and counts over the model axis, forward and backward
    (every rank's pooled values reach every rank's share of the loss), at an
    odd particle count (the last rank padded with masked particles)."""
    rs = np.random.RandomState(0)
    x, mask, _, _ = _inputs(n=15)
    wm, ws = t(rs.randn(x.shape[-1])), t(rs.randn(x.shape[-1]))
    xw = x.clone().requires_grad_(True)
    mean, summed = meansum_pool(xw, mask)
    (gx,) = torch.autograd.grad(torch.sum(mean * wm + torch.sin(summed) * ws), xw)

    def part(axis):
        shard = BatchShard(0, 1, lambda v: v, seq=axis).at_particles(15)
        xl = shard.local_particles(x).clone().requires_grad_(True)
        with sequence_parallel(axis):
            m, s = meansum_pool(xl, shard.local_particles(mask))
        # each rank's loss is its share: here the pooled values, read by every rank
        share = torch.sum(m * wm + torch.sin(s) * ws) / axis.size
        (g,) = torch.autograd.grad(share, xl)
        return m.detach(), s.detach(), g

    parts = in_threads(part)
    for m, s, _ in parts:
        _close(m, mean, "mean")
        _close(s, summed, "sum")
    g = torch.cat([p[2] for p in parts], dim=1)
    assert g.shape[1] == 16 and float(g[:, 15:].abs().max()) == 0.0
    _close(g[:, :15], gx, "gradient")


@pytest.mark.parametrize("cfg", [EPIC, TRANSFORMER], ids=["epic", "transformer"])
def test_sp_parts_equal_the_whole_net(cfg):
    """Each rank its particles of every set (15 over 2: 8 and 7, padded):
    the EPiC net's pools and the transformer's gathered keys and values."""
    net = _net(cfg)
    x, mask, cond, tt = _inputs(n=15)
    want_out, want_grads = _whole(net, x, mask, cond, tt)

    def part(axis):
        shard = BatchShard(0, 1, lambda v: v, seq=axis).at_particles(15)
        with sequence_parallel(axis):
            out, grads = _whole(net, shard.local_particles(x), cond=cond, tt=tt,
                                mask=shard.local_particles(mask),
                                real=shard.local_particles(torch.ones(1, 15, 1)))
        return out, grads

    parts = in_threads(part)
    out = torch.cat([p[0] for p in parts], dim=1)
    _close(out[:, :15], want_out, "forward")
    for i, (n, _) in enumerate(net.named_parameters()):
        _close(parts[0][1][i] + parts[1][1][i], want_grads[i], f"gradient {n}")


@pytest.mark.parametrize("base", [EPIC, TRANSFORMER], ids=["epic", "transformer"])
def test_sp_training_loss_shares_add_up_to_the_whole(monkeypatch, base):
    """The loss of eight rows at 15 particles in four threads (two data
    rows of the mesh, each of two model ranks): the noises drawn for the
    whole sets and sliced, the mask count summed over every thread, the
    padding slot's field dropped (the transformer's is not masked), the
    normaliser's statistics over the particles of every rank and the cond's
    over the data rows only."""
    cfg = dict(base, use_normaliser=True)
    net = _net(cfg)
    model = PortModel(**cfg)
    b, n = 8, 15
    x, mask, cond, _ = _inputs(n=n, b=b, seed=4)
    x = (x * 2.0 + 0.7) * mask
    rs = np.random.RandomState(1)
    t_arr, z_arr = rs.rand(b).astype(np.float32), rs.randn(b, n, 3).astype(np.float32)
    monkeypatch.setattr(ploss, "_sample_t", lambda _g, size, d: t(t_arr))
    monkeypatch.setattr(ploss, "_normal", lambda _g, shape, d: t(z_arr))
    whole = copy.deepcopy(net)
    loss = model.loss(whole, torch.Generator(), x, mask=mask, cond=cond, train=True)
    want = torch.autograd.grad(loss, list(whole.parameters()))
    stats = whole.state_dict()
    model_axes = [thread_axes(2) for _ in range(2)]  # the model group of each data row
    data_axes = [thread_axes(2) for _ in range(2)]  # the data group of each model column

    def part(world_axis):
        d, m = coords(world_axis.rank, 2)
        shard = BatchShard(d, 2, world_axis.all_reduce, seq=model_axes[d][m],
                           reduce_rows=data_axes[m][d].all_reduce)
        own = copy.deepcopy(net)
        rows = dist.local_rows(b, d, 2)
        got = model.loss(own, torch.Generator(), x[rows], mask=mask[rows], cond=cond[rows],
                         train=True, shard=shard)
        return got.detach(), torch.autograd.grad(got, list(own.parameters())), own.state_dict()

    parts = in_threads(part, size=4)
    np.testing.assert_allclose(float(sum(p[0] for p in parts)), float(loss), rtol=TOL)
    for i, (name, _) in enumerate(net.named_parameters()):
        _close(sum(p[1][i] for p in parts), want[i], f"gradient {name}")
    for p in parts:  # every rank's statistics are the whole batch's
        for key in ("normaliser.means", "normaliser.vars", "ctxt_normaliser.means",
                    "ctxt_normaliser.vars", "normaliser.n", "ctxt_normaliser.n"):
            _close(p[2][key], stats[key], key)


# ------------------------------------------------------------------ refusals
@pytest.mark.parametrize("strategy", ["dp_tp", "sp", "dp_ep"])
def test_pipeline_and_one_process_strategies_raise_naming_item_7(strategy):
    """The model axis in one process (pp trains in one process with one
    stage: tests/test_torch_parallel_pipeline.py)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Trainer(model=PortModel(**EPIC), datamodule=None, optimizer=pstep.make_optimizer(),
                strategy=strategy, device="cpu")


@pytest.mark.parametrize("strategy,cfg,size,error,match", [
    ("dp_tp", EPIC, 3, ValueError, "divisible by model_axis_size"),
    ("sp", EPIC, 3, ValueError, "divisible by model_axis_size"),
    ("sp", CROSS, 2, NotImplementedError, "Queue 1 item 7"),
    ("sp", MDMA_SMALL, 2, NotImplementedError, "Queue 1 item 7"),
    ("sp", MOE, 2, NotImplementedError, "Queue 1 item 7"),
    ("sp", dict(EPIC, loss_type="CFM-OT"), 2, NotImplementedError, "Queue 1 item 7"),
], ids=["dp_tp-axis3", "sp-axis3", "sp-crossattention", "sp-mdma", "sp-moe", "sp-cfm_ot"])
def test_model_axis_checks_in_a_group_of_four(monkeypatch, strategy, cfg, size, error, match):
    """The Trainer's checks as four ranks make them (the group emulated)."""
    monkeypatch.setattr(ptrainer.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ptrainer.dist, "world_size", lambda: 4)
    monkeypatch.setattr(ptrainer, "make_mesh", lambda m: pytest.fail("checks passed"))
    with pytest.raises(error, match=match):
        Trainer(model=PortModel(**cfg), datamodule=None, optimizer=pstep.make_optimizer(),
                strategy=strategy, model_axis_size=size, device="cpu")


@pytest.mark.parametrize("cfg,what", [(CROSS, "cross-attention"), (MDMA_SMALL, "MDMA"),
                                      (MOE, "mixture-of-experts")],
                         ids=["crossattention", "mdma", "moe"])
def test_networks_refuse_sequence_parallelism(cfg, what):
    net = PortModel(**cfg).init(device="cpu")
    feats, cond_dim = cfg["features"], cfg["global_cond_dim"]
    x, mask, cond, tt = _inputs(n=16, feats=feats, cond_dim=cond_dim)

    def part(axis):
        with sequence_parallel(axis), pytest.raises(NotImplementedError,
                                                    match=f"{what}.*Queue 1 item 7"):
            net(tt, x[:, :8], cond=cond, mask=mask[:, :8])

    in_threads(part)


def test_rules_that_split_nothing_raise_and_sharded_dense_do_not_fold():
    axis = ModelAxis(0, 2, lambda v: v, lambda v, d: v)
    for cfg, rules in ((TRANSFORMER, "epic"), (EPIC, "moe"), (dict(EPIC, hidden_dim=31), "epic")):
        state = pstep.create_train_state(PortModel(**cfg), pstep.make_optimizer(), device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            tp.shard_state_tp(state, axis, rules)
    state = pstep.create_train_state(PortModel(**EPIC), pstep.make_optimizer(), device="cpu")
    state = tp.shard_state_tp(state, axis, "epic")
    with pytest.raises(RuntimeError, match="training only"):
        PortModel.fold_weight_norm(state.net)
    with pytest.raises(ValueError, match="unknown rules"):
        tp.placements(state.net, "heads", 2)
