"""PyTorch port, the classifier datamodules held bit for bit against the JAX
package's: `GenVsRealDataModule` (sets with masks, flat vectors, super-set
groups through the shuffle, the splits and the batches; in memory and from
h5 files) and `JetClassClassifierDataModule` (`derive_pf_features`, the
synthetic pair with the feature lists of the shipped experiments, one jet
flavour, the high-level features, and the classifier h5 of `eval_ckpt
--write_classifier_h5` with its substructure twin). Where h5py is missing,
reading a file raises an error that names it.
"""

from __future__ import annotations

import sys
from unittest import mock

import numpy as np
import pytest

from particle_fm_tpu.data import classifier as jdata
from particle_fm_tpu.data import jetclass_classifier as jjc
from particle_fm_tpu_torch.data import classifier as pdata
from particle_fm_tpu_torch.data import jetclass_classifier as pjc

SPLIT_KEYS = ("means", "stds", "tensor_test", "mask_test", "tensor_conditioning_test",
              "variable_jet_sizes")


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


def _hold(jdm, pdm, extra=()):
    for split in ("train", "val", "test"):
        js, ps = getattr(jdm, split), getattr(pdm, split)
        for key in ("x", "mask", "cond"):
            _same(getattr(js, key), getattr(ps, key))
    for key in SPLIT_KEYS + tuple(extra):
        _same(getattr(jdm, key), getattr(pdm, key))
    for jb, pb in zip(jdm.train_batches(seed=5), pdm.train_batches(seed=5), strict=True):
        for a, b in zip(jb, pb):
            _same(a, b)
    for jb, pb in zip(jdm.test_batches(), pdm.test_batches(), strict=True):
        for a, b in zip(jb, pb):
            _same(a, b)


def _clouds(n=203, parts=12, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for shift in (0.5, -0.5):
        counts = rs.randint(1, parts + 1, size=(n, 1))
        mask = (np.arange(parts)[None, :] < counts).astype(np.float32)[..., None]
        out += [(rs.randn(n, parts, 3).astype(np.float32) + shift) * mask, mask]
    return out


@pytest.mark.parametrize("kw", [dict(), dict(normalize=False), dict(num_sup_sets=2, seed=3),
                                dict(flat=True), dict(flat=True, num_sup_sets=3,
                                                      batch_size=24)])
def test_gen_vs_real_matches_jax(kw):
    kw = dict(kw)
    real, real_mask, gen, gen_mask = _clouds()
    if kw.pop("flat", False):
        real, gen, real_mask, gen_mask = real[:, 0], gen[:, 0], None, None
    args = dict(dict(real=real, real_mask=real_mask, gen=gen[:190], batch_size=16,
                     gen_mask=None if gen_mask is None else gen_mask[:190]), **kw)
    jdm, pdm = jdata.GenVsRealDataModule(**args), pdata.GenVsRealDataModule(**args)
    jdm.setup(), pdm.setup()
    _hold(jdm, pdm)
    s = kw.get("num_sup_sets", 1)
    if s > 1:  # events stay whole: labels constant within every group of s rows
        for x, _, y in pdm.train_batches(seed=1):
            assert (y.reshape(-1, s) == y.reshape(-1, s)[:, :1]).all()


def test_gen_vs_real_reads_h5_files_as_jax(tmp_path):
    import h5py

    real, real_mask, gen, gen_mask = _clouds(n=64)
    for name, x, m in (("real", real, real_mask), ("gen", gen, gen_mask)):
        with h5py.File(tmp_path / f"{name}.h5", "w") as f:
            f["x"], f["mask"] = x, m
    with h5py.File(tmp_path / "flat.h5", "w") as f:
        f["x"] = real[:, 0]
    files = dict(real_file=str(tmp_path / "real.h5"), gen_file=str(tmp_path / "gen.h5"),
                 batch_size=8)
    jdm, pdm = jdata.GenVsRealDataModule(**files), pdata.GenVsRealDataModule(**files)
    jdm.setup(), pdm.setup()
    _hold(jdm, pdm)
    inmem = pdata.GenVsRealDataModule(real=real, real_mask=real_mask, gen=gen,
                                      gen_mask=gen_mask, batch_size=8)
    inmem.setup()
    _same(inmem.train.x, pdm.train.x)
    flat = pdata.GenVsRealDataModule(real_file=str(tmp_path / "flat.h5"),
                                     gen_file=str(tmp_path / "flat.h5"), batch_size=8)
    flat.setup()
    assert flat.train.mask is None and flat.train.x.ndim == 2
    with mock.patch.dict(sys.modules, {"h5py": None}):
        with pytest.raises(ImportError, match="h5py"):
            pdata.GenVsRealDataModule(**files).setup()


def test_gen_vs_real_refuses_what_jax_refuses():
    real, real_mask, gen, gen_mask = _clouds(n=20)
    with pytest.raises(ValueError, match="multiple of num_sup_sets"):
        pdata.GenVsRealDataModule(real=real, gen=gen, num_sup_sets=3, batch_size=16).setup()
    with pytest.raises(ValueError, match="real\\+gen"):
        pdata.GenVsRealDataModule(real=real).setup()


EPIC_FEATURES = ["part_etarel", "part_dphi", "log_part_pt", "log_part_energy", "log_part_ptrel",
                 "log_part_energyrel", "part_deltaR", "part_charge", "part_isChargedHadron",
                 "part_isNeutralHadron", "part_isPhoton", "part_isElectron", "part_isMuon",
                 "tanh_part_d0val", "part_d0err", "tanh_part_dzval", "part_dzerr"]


@pytest.mark.parametrize("kw", [
    dict(used_flavor="QCD", set_energy_equal_to_p=True, set_neutral_particle_ips_zero=True),
    dict(used_flavor="Hbb", pf_features_list=EPIC_FEATURES),
    dict(used_flavor=None, kin_only=True),
    dict(used_flavor="QCD", use_hl_features=True, hl_features_list=["tau1", "tau2", "tau3"]),
])
def test_jetclass_classifier_synthetic_matches_jax(kw):
    args = dict(synthetic=True, synthetic_num_jets=300, synthetic_num_particles=20,
                batch_size=16, train_val_test_split=(0.5, 0.1, 0.4), **kw)
    jdm, pdm = jjc.JetClassClassifierDataModule(**args), pjc.JetClassClassifierDataModule(**args)
    jdm.setup(), pdm.setup()
    _hold(jdm, pdm, extra=("names_pf_features", "names_hl_features"))
    if kw.get("use_hl_features"):
        assert pdm.train.mask is None and pdm.train.x.shape[1] == 3


def _write_classifier_h5(path, arrays, part_names, cond_names, hl):
    import h5py

    with h5py.File(path, "w") as f:
        for key, arr in arrays.items():
            d = f.create_dataset(key, data=arr)
            if key.startswith("part_data"):
                d.attrs["names"] = part_names
            elif key.startswith("cond_data"):
                d.attrs["names"] = cond_names
    with h5py.File(str(path).replace(".h5", "_substructure.h5"), "w") as f:
        for key, arr in hl.items():
            f[key] = arr


def test_jetclass_classifier_reads_the_classifier_h5_as_jax(tmp_path):
    src = pjc.JetClassClassifierDataModule(synthetic=True, synthetic_num_jets=200,
                                           synthetic_num_particles=16)
    arrays, part_names, cond_names, hl = src._load_synthetic()
    path = tmp_path / "classifier_data.h5"
    _write_classifier_h5(path, arrays, part_names, cond_names, hl)
    for kw in (dict(used_flavor="Hcc"), dict(used_flavor="QCD", use_hl_features=True),
               dict(used_flavor=None, number_of_jets=150, pf_features_list=EPIC_FEATURES)):
        args = dict(data_file=str(path), batch_size=8, **kw)
        jdm = jjc.JetClassClassifierDataModule(**args)
        pdm = pjc.JetClassClassifierDataModule(**args)
        jdm.setup(), pdm.setup()
        _hold(jdm, pdm, extra=("names_pf_features", "names_hl_features"))
    with mock.patch.dict(sys.modules, {"h5py": None}):
        with pytest.raises(ImportError, match="h5py"):
            pjc.JetClassClassifierDataModule(data_file=str(path)).setup()
    with pytest.raises(ValueError, match="data_file"):
        pjc.JetClassClassifierDataModule().setup()


def test_derive_pf_features_matches_jax():
    rs = np.random.RandomState(4)
    b, n = 40, 12
    counts = rs.randint(1, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    names = ["part_etarel", "part_dphi", "part_ptrel", "part_energyrel", "part_charge",
             "part_isChargedHadron", "part_isElectron", "part_d0val", "part_d0err"]
    parts = rs.rand(b, n, len(names)).astype(np.float32) * mask
    cond_names = [b"jet_pt", b"jet_eta", b"jet_energy"]
    cond = (rs.rand(b, 3) * 500 + 1).astype(np.float32)
    cond[:, 1] = rs.randn(b) * 1.5  # jet_eta
    for kw in (dict(), dict(set_energy_equal_to_p=True, set_neutral_particle_ips_zero=True)):
        ref = jjc.derive_pf_features(parts, mask, cond, names, cond_names, **kw)
        out = pjc.derive_pf_features(parts, mask, cond, names, cond_names, **kw)
        assert list(out) == list(ref)
        for key in ref:
            _same(ref[key], out[key])
    assert pjc.HL_NAMES == jjc.HL_NAMES and pjc.PF_FEATURES_KIN == jjc.PF_FEATURES_KIN
