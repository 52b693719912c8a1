"""PyTorch port, the two dataset scripts held against the JAX scripts on their
`--synthetic` inputs: scripts/torch_prepare_dataset_jetclass.py
(scripts/prepare_dataset_jetclass.py) and
scripts/torch_preprocessing_calo_challenge.py
(scripts/preprocessing_calo_challenge.py).

- JetClass: every dataset of the three split files and every `names_*`
  attribute equal to the JAX script's, bit for bit (the same numpy
  arithmetic on the same merged arrays).
- CaloChallenge: the point clouds and the energies of the npz bit for bit;
  the fitted scaler (the port's numpy pipeline against sklearn's
  FunctionTransformer(log1p) + StandardScaler, DQ the same) transforms and
  inverts the pooled hits to within 1e-6 of the JAX script's pickled
  scaler, and its fitted mean and scale within 1e-12 relative.
"""

from __future__ import annotations

import pickle
import sys

import h5py
import joblib
import numpy as np
import pytest

from scripts import prepare_dataset_jetclass as jprep
from scripts import preprocessing_calo_challenge as jcalo
from scripts import torch_prepare_dataset_jetclass as pprep
from scripts import torch_preprocessing_calo_challenge as pcalo


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    module.main()


def test_prepare_jetclass_matches_jax(tmp_path, monkeypatch):
    _run_jax(monkeypatch, jprep, ["--synthetic", "--out_dir", str(tmp_path / "jax"), "--seed", "3"])
    written = pprep.main(["--synthetic", "--out_dir", str(tmp_path / "port"), "--seed", "3"])
    assert [p.rsplit("/", 1)[1] for p in written] == ["train.h5", "val.h5", "test.h5"]
    for split in ("train", "val", "test"):
        with h5py.File(tmp_path / "jax" / f"{split}.h5") as fj, \
                h5py.File(tmp_path / "port" / f"{split}.h5") as fp:
            assert sorted(fp) == sorted(fj)
            for key in fj:
                assert fp[key].dtype == fj[key].dtype
                np.testing.assert_array_equal(fp[key][:], fj[key][:], err_msg=key)
                assert sorted(fp[key].attrs) == sorted(fj[key].attrs)
                for name, value in fj[key].attrs.items():
                    np.testing.assert_array_equal(fp[key].attrs[name], value)
    with pytest.raises(FileNotFoundError, match="no raw"):
        (tmp_path / "empty").mkdir()
        pprep.main(["--raw_dir", str(tmp_path / "empty"), "--out_dir", str(tmp_path / "o")])


def test_calo_preprocessing_matches_jax(tmp_path, monkeypatch):
    argv = ["--synthetic", "--max_showers", "60", "--num_z", "9", "--num_alpha", "8",
            "--num_r", "5"]
    _run_jax(monkeypatch, jcalo, argv + ["--out", str(tmp_path / "jax.npz"),
                                         "--scaler_out", str(tmp_path / "jax.pkl")])
    pcalo.main(argv + ["--out", str(tmp_path / "port.npz"),
                       "--scaler_out", str(tmp_path / "port.pkl")])
    want = np.load(tmp_path / "jax.npz", allow_pickle=True)
    got = np.load(tmp_path / "port.npz", allow_pickle=True)
    np.testing.assert_array_equal(got["energies"], want["energies"])
    assert len(got["showers"]) == len(want["showers"]) == 60
    for a, b in zip(got["showers"], want["showers"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)

    jsc = joblib.load(tmp_path / "jax.pkl")  # the JAX script saves with joblib where it imports
    with open(tmp_path / "port.pkl", "rb") as f:
        psc = pickle.load(f)
    j_std, p_std = jsc.transfs[0].steps[-1][1], psc.transfs[0].steps[-1][1]
    np.testing.assert_allclose(p_std.mean_, j_std.mean_, rtol=1e-12)
    np.testing.assert_allclose(p_std.scale_, j_std.scale_, rtol=1e-12)
    pooled = np.concatenate([s for s in got["showers"] if len(s)])
    fwd_p, fwd_j = psc.transform(pooled), jsc.transform(pooled)
    np.testing.assert_allclose(fwd_p, fwd_j, atol=1e-6)  # the DQ streams advance alike
    np.testing.assert_allclose(psc.inverse_transform(fwd_p), jsc.inverse_transform(fwd_j),
                               rtol=1e-6, atol=1e-6)
    # the showers to point clouds step alone, on a hand-made grid
    grid = np.zeros((1, 2 * 3 * 2))
    grid[0, 7] = 4.0  # z=1, alpha=0, r=1
    (pc,) = pcalo.showers_to_pointclouds(grid, 2, 3, 2)
    np.testing.assert_array_equal(pc, [[4.0, 1.0, 0.0, 1.0]])
    np.testing.assert_array_equal(pc, jcalo.showers_to_pointclouds(grid, 2, 3, 2)[0])
