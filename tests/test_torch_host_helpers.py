"""PyTorch port, the host helpers copied from the JAX package (numpy, no
torch): `data/utils.py::sort_consts`, `sort_jets`,
`get_pt_of_selected_multiplicities` and `eval/lhco_utils.py::sort_by_pt`,
each held bit for bit against its JAX-package counterpart on seeded arrays:
every `sort_by`, `high_to_low` both ways, and `shuffle` under one
`np.random.seed` on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest

from particle_fm_tpu.data import utils as jutils
from particle_fm_tpu.eval import lhco_utils as jlhco
from particle_fm_tpu_torch.data import utils as putils
from particle_fm_tpu_torch.eval import lhco_utils as plhco


def _clouds(seed: int, shape) -> np.ndarray:
    """Seeded clouds with ties and zero-padded rows, so that stability shows."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0])
    x[..., -3:, :] = 0.0  # padding: ties in every feature
    x[..., 1, 0] = x[..., 2, 0]
    return x


def _both(fn_j, fn_p, *args, shuffle_seed=None, **kw):
    outs = []
    for fn in (fn_j, fn_p):
        if shuffle_seed is not None:
            np.random.seed(shuffle_seed)
        outs.append(fn(*args, **kw))
    return outs


@pytest.mark.parametrize("high_to_low", [True, False])
@pytest.mark.parametrize("sort_by", ["pt", "eta", "phi", "shuffle"])
def test_sort_consts_is_the_jax_packages(sort_by, high_to_low):
    x = _clouds(0, (5, 2, 12, 3))
    got_j, got_p = _both(jutils.sort_consts, putils.sort_consts, x, sort_by=sort_by,
                         high_to_low=high_to_low, shuffle_seed=7)
    assert got_p.shape == x.shape
    np.testing.assert_array_equal(got_p, got_j)
    if sort_by != "shuffle":
        key = got_p[..., {"pt": 0, "eta": 1, "phi": 2}[sort_by]]
        step = np.diff(key, axis=-1)
        assert (step <= 0).all() if high_to_low else (step >= 0).all()


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("high_to_low", [True, False])
@pytest.mark.parametrize("sort_by", ["pt", "eta", "phi", "mass", "shuffle"])
def test_sort_jets_is_the_jax_packages(sort_by, high_to_low, with_mask):
    rs = np.random.RandomState(1)
    jets = rs.randn(6, 4, 4).astype(np.float32)
    consts = _clouds(2, (6, 4, 10, 3))
    mask = (consts[..., :1] != 0).astype(np.float32) if with_mask else None
    got_j, got_p = _both(jutils.sort_jets, putils.sort_jets, jets, consts, mask=mask,
                         sort_by=sort_by, high_to_low=high_to_low, shuffle_seed=11)
    assert len(got_p) == (3 if with_mask else 2) == len(got_j)
    for a, b in zip(got_p, got_j):
        np.testing.assert_array_equal(a, b)


def test_sort_rejects_an_unknown_key():
    x = _clouds(0, (2, 6, 3))
    for fn in (putils.sort_consts, jutils.sort_consts):
        with pytest.raises(ValueError, match="sort_by"):
            fn(x, sort_by="mass")
    for fn in (putils.sort_jets, jutils.sort_jets):
        with pytest.raises(ValueError, match="sort_by"):
            fn(np.zeros((2, 2, 4)), np.zeros((2, 2, 3, 3)), sort_by="energy")


@pytest.mark.parametrize("multiplicities,num_jets", [((10, 20, 30), 150), ((3, 5), 4)])
def test_pt_of_selected_multiplicities_is_the_jax_packages(multiplicities, num_jets):
    rs = np.random.RandomState(3)
    x = np.abs(rs.randn(200, 30, 3)).astype(np.float32)
    counts = rs.randint(1, 31, size=200)
    x[np.arange(30)[None, :] >= counts[:, None]] = 0.0
    got_j, got_p = _both(jutils.get_pt_of_selected_multiplicities,
                         putils.get_pt_of_selected_multiplicities, x,
                         selected_multiplicities=multiplicities, num_jets=num_jets)
    assert list(got_p) == list(got_j) == [str(i) for i in range(len(multiplicities))]
    for k in got_j:
        np.testing.assert_array_equal(got_p[k], got_j[k])
    assert any(len(v) for v in got_p.values())


def test_sort_by_pt_is_the_jax_packages():
    x = _clouds(4, (8, 2, 20, 3))
    got = plhco.sort_by_pt(x)
    np.testing.assert_array_equal(got, jlhco.sort_by_pt(x))
    assert (np.diff(got[..., 0], axis=-1) <= 0).all()
