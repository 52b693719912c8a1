"""PyTorch port, the LHCO datamodules (`particle_fm_tpu_torch/data/lhco.py`)
held against the JAX package's on synthetic events (`synthetic=True`, 400
events): every array the datamodule exposes (the splits, masks,
conditioning, the `*_sr` signal-region twins, mjj, the raw arrays, means and
stds) is equal bit for bit, in value and dtype, and so is the batch stream
for a seed. LHCODataModule for every jet type (x, y, all, all_one_pc) plain,
with multiplicity conditioning, with log_pt and with pt_standardization;
the whole-event datamodule; the jet-feature datamodule flat and as a set.
The synthetic generators (`synthetic_lhco`, `synthetic_calo`) are equal to
the JAX package's, draw for draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from particle_fm_tpu.data import lhco as jlhco
from particle_fm_tpu.data import synthetic as jsyn
from particle_fm_tpu_torch.data import lhco as plhco
from particle_fm_tpu_torch.data import synthetic as psyn

EVENTS = 400


def assert_same_datamodule(jdm, pdm) -> None:
    """Every dataclass field of the JAX datamodule equal in the port's:
    arrays bit for bit with their dtypes, splits array by array, anything
    else by ==."""
    for f in dataclasses.fields(jdm):
        a, b = getattr(jdm, f.name), getattr(pdm, f.name)
        if hasattr(a, "x") and hasattr(a, "cond"):  # a Split
            for key in ("x", "mask", "cond"):
                assert_same_array(getattr(a, key), getattr(b, key), f"{f.name}.{key}")
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert_same_array(a, b, f.name)
        else:
            assert a == b, f.name


def assert_same_array(a, b, name) -> None:
    if a is None or b is None:
        assert a is None and b is None, name
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_stream(jdm, pdm, seed: int = 3) -> None:
    for got, want in ((pdm.train_batches(seed), jdm.train_batches(seed)),
                      (pdm.val_batches(), jdm.val_batches())):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert_same_array(b, a, "batch")


def build(module, cls, **kw):
    dm = getattr(module, cls)(synthetic=True, batch_size=32, **kw)
    dm.setup()
    return dm


def test_synthetic_generators_match_jax():
    for a, b in zip(psyn.synthetic_lhco(50, 40, seed=2), jsyn.synthetic_lhco(50, 40, seed=2)):
        assert_same_array(b, a, "lhco")
    for a, b in zip(psyn.synthetic_calo(50, 64, seed=2), jsyn.synthetic_calo(50, 64, seed=2)):
        assert_same_array(b, a, "calo")


VARIANTS = {
    "plain": {},
    "multiplicity": {"multiplicity_conditioning": True},
    "log_pt": {"log_pt": True},
    "pt_standardization": {"pt_standardization": True},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("jet_type", ["x", "y", "all", "all_one_pc"])
def test_lhco_datamodule_matches_jax(jet_type, variant):
    kw = dict(jet_type=jet_type, num_particles=48, synthetic_num_events=EVENTS,
              **VARIANTS[variant])
    if jet_type == "all_one_pc":
        kw["relative_coords"] = False  # as lhco/bigPC
    jdm, pdm = build(jlhco, "LHCODataModule", **kw), build(plhco, "LHCODataModule", **kw)
    assert len(pdm.tensor_test_sr) > 0 and len(pdm.tensor_train) > 0
    assert_same_datamodule(jdm, pdm)
    assert_same_stream(jdm, pdm)


def test_whole_event_datamodule_matches_jax():
    kw = dict(num_particles=96, synthetic_num_events=EVENTS)
    jdm = build(jlhco, "LHCOWholeEventDataModule", **kw)
    pdm = build(plhco, "LHCOWholeEventDataModule", **kw)
    assert pdm.train.x.shape[1:] == (96, 3) and pdm.train.cond.shape[1] == 1
    assert_same_datamodule(jdm, pdm)
    assert_same_stream(jdm, pdm)


@pytest.mark.parametrize("set_data", [False, True])
def test_jet_feature_datamodule_matches_jax(set_data):
    kw = dict(set_data=set_data, synthetic_num_events=EVENTS, synthetic_num_particles=64)
    jdm = build(jlhco, "LHCOJetFeatureDataModule", **kw)
    pdm = build(plhco, "LHCOJetFeatureDataModule", **kw)
    assert pdm.train.x.shape[1:] == ((2, 5) if set_data else (10,))
    assert_same_datamodule(jdm, pdm)
    assert_same_stream(jdm, pdm)
