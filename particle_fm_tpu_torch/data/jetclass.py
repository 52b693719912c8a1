"""JetClass datamodule; counterpart of particle_fm_tpu/data/jetclass.py,
array for array (numpy only).

The JetClass files are pre-split, pre-standardised h5 files, one per split,
with the keys
  part_features (B, N, F)  standardised particle features
  part_mask     (B, N)
  jet_features  (B, J)     (jet_pt, jet_eta, ..., jet_type)
  labels        (B, n_types) one-hot
  part_means / part_stds   the standardisation constants
and each key's names in the attribute `names_<key>`. Each split is read
through one function, `_read_split`, which takes an h5 path (h5py is imported
only then) or the same arrays in memory: `synthetic=True` hands it the
arrays of `synthetic_jetclass_arrays` and opens no file, so the datamodule
needs no h5py. `write_jetclass_h5` writes such arrays as a file.

As in the JAX package: feature selection ([etarel, dphi, ptrel] + the
additional ones), a fixed shuffle of each split (seed 332211), jet-type
filtering, one-hot jet-type conditioning (not normalised), training arrays
= standardised * normalize_sigma, evaluation arrays (`tensor_*`)
un-standardised, and an optional generated-conditioning file (mask_gen /
tensor_conditioning_gen).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from particle_fm_tpu_torch.data.base import ArrayDataModule, Split

JETCLASS_TYPES = ["QCD", "Hbb", "Hcc", "Hgg", "H4q", "Hqql", "Zqq", "Wqq", "Tbqq", "Tbl"]
# the particle features beyond the kinematics (configs/experiment/jetclass/jetclass_cond.yaml)
ADDITIONAL_PART_FEATURES = [
    "part_d0val", "part_d0err", "part_dzval", "part_dzerr", "part_charge",
    "part_isChargedHadron", "part_isNeutralHadron", "part_isPhoton", "part_isElectron",
    "part_isMuon",
]


def _decode(n) -> str:
    return n.decode() if isinstance(n, bytes) else str(n)


def get_feat_index(names_array, name: str) -> int:
    names_list = [_decode(n) for n in np.asarray(names_array).tolist()]
    if name not in names_list:
        raise KeyError(f"Feature {name} not found. Available: {names_list}")
    return names_list.index(name)


def synthetic_jetclass_arrays(num_jets: int = 1000, num_particles: int = 32,
                              num_types: int = 3, seed: int = 0,
                              additional_features: bool = False) -> dict:
    """The arrays of one synthetic JetClass split: {key: array} and
    {"names": {key: names}}, with the keys of a JetClass file. Without
    `additional_features` they are those of the JAX package's
    `synthetic_jetclass_file`, draw for draw.

    Kinematics as in data/synthetic.py: pt-ordered exponential ptrel
    normalised to sum 1, prong-structured (etarel, dphi); the jet type sets
    the multiplicity, the angular width and the prong count (1/2/3 prongs
    for type % 3 = 0/1/2). `additional_features` appends the 10
    ADDITIONAL_PART_FEATURES, drawn after the rest from the same stream:
    a particle class (charged or neutral hadron, photon, electron, muon)
    with its one-hot flags, a charge of +-1 on the charged ones and
    impact parameters (d0, dz and their errors) on those, 0 elsewhere."""
    rs = np.random.RandomState(seed)
    n, npart = num_jets, num_particles
    types = rs.randint(0, num_types, size=n)
    t3 = types % 3
    # multiplicity: higher-prong classes are fuller; a fraction sits at the
    # cap like real truncated files
    mult = np.clip(
        (npart * rs.beta(3.0 + 1.5 * t3, 1.5, size=n)).astype(int), 3, npart
    )
    mult = np.where(rs.rand(n) < 0.25, npart, mult)
    mask = (np.arange(npart)[None, :] < mult[:, None]).astype(np.float32)

    # ptrel: pt-ordered exponential falloff, normalized to sum 1 per jet
    raw = rs.exponential(1.0, size=(n, npart)) * mask
    raw = -np.sort(-raw, axis=1)
    ptrel = raw / np.maximum(raw.sum(axis=1, keepdims=True), 1e-9)

    # angular structure: per-jet prong centers, class-dependent count/width
    width = (0.10 + 0.05 * t3)[:, None]
    nprong = (1 + t3)[:, None]
    prong_idx = rs.randint(0, 3, size=(n, npart)) % nprong
    prong_eta = rs.normal(0.0, 0.22, size=(n, 3))
    prong_phi = rs.normal(0.0, 0.22, size=(n, 3))
    etarel = np.take_along_axis(prong_eta, prong_idx, axis=1)
    dphi = np.take_along_axis(prong_phi, prong_idx, axis=1)
    etarel = (etarel + rs.normal(0.0, 1.0, size=(n, npart)) * width) * mask
    dphi = (dphi + rs.normal(0.0, 1.0, size=(n, npart)) * width) * mask
    feats = np.stack(
        [etarel, dphi, (ptrel * mask)], axis=-1
    ).astype(np.float32)

    jet_pt = rs.uniform(400, 1000, n)
    jet_eta = rs.normal(0, 1.5, n)
    # sdmass label = realized constituent-level relative mass x jet pt
    pm = ptrel * mask
    px = (pm * np.cos(dphi)).sum(axis=1)
    py = (pm * np.sin(dphi)).sum(axis=1)
    pz = (pm * np.sinh(etarel)).sum(axis=1)
    e = (pm * np.cosh(etarel)).sum(axis=1)
    m_rel = np.sqrt(np.maximum(e**2 - px**2 - py**2 - pz**2, 0.0))
    jet_features = np.stack(
        [
            jet_pt,                                          # jet_pt
            jet_eta,                                         # jet_eta
            rs.uniform(-np.pi, np.pi, n),                    # jet_phi
            jet_pt * np.cosh(np.clip(jet_eta, -2.5, 2.5)),   # jet_energy
            m_rel * jet_pt,                                  # jet_sdmass
            mult.astype(float),                              # jet_nparticles
            types.astype(float),                             # jet_type
        ],
        axis=-1,
    ).astype(np.float32)
    labels = np.eye(num_types, dtype=np.float32)[types]
    names_part = [b"part_etarel", b"part_dphi", b"part_ptrel"]
    if additional_features:
        # class 0 charged hadron, 1 neutral hadron, 2 photon, 3 electron, 4 muon
        cls = rs.choice(5, size=(n, npart), p=[0.6, 0.1, 0.25, 0.03, 0.02])
        charged = np.isin(cls, (0, 3, 4))
        charge = np.where(charged, rs.choice([-1.0, 1.0], size=(n, npart)), 0.0)
        d0 = rs.normal(0.0, 0.05, size=(n, npart)) * charged
        d0err = np.abs(rs.normal(0.02, 0.01, size=(n, npart))) * charged
        dz = rs.normal(0.0, 0.08, size=(n, npart)) * charged
        dzerr = np.abs(rs.normal(0.03, 0.01, size=(n, npart))) * charged
        flags = [(cls == k).astype(float) for k in range(5)]
        extra = np.stack([d0, d0err, dz, dzerr, charge, *flags], axis=-1) * mask[..., None]
        feats = np.concatenate([feats, extra.astype(np.float32)], axis=-1)
        names_part += [f.encode() for f in ADDITIONAL_PART_FEATURES]
    names_part = np.array(names_part)
    n_feats = len(names_part)
    return {
        "part_features": feats,
        "part_mask": mask,
        "jet_features": jet_features,
        "labels": labels,
        "part_means": np.zeros(n_feats, np.float32),
        "part_stds": np.ones(n_feats, np.float32),
        "names": {
            "part_features": names_part,
            "jet_features": np.array(
                [b"jet_pt", b"jet_eta", b"jet_phi", b"jet_energy", b"jet_sdmass",
                 b"jet_nparticles", b"jet_type"]),
            "labels": np.array([f"label_{t}".encode() for t in JETCLASS_TYPES[:num_types]]),
            "part_means": names_part,
            "part_stds": names_part,
        },
    }


def write_jetclass_h5(path: str, arrays: dict) -> None:
    """Write one split's arrays (as synthetic_jetclass_arrays gives them) as a
    JetClass h5 file."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            if key == "names":
                continue
            d = f.create_dataset(key, data=value)
            if key in arrays["names"]:
                d.attrs[f"names_{key}"] = arrays["names"][key]


def synthetic_jetclass_file(path: str, num_jets: int = 1000, num_particles: int = 32,
                            num_types: int = 3, seed: int = 0) -> None:
    """Write a synthetic JetClass h5 split, the JAX package's file."""
    write_jetclass_h5(path, synthetic_jetclass_arrays(num_jets, num_particles, num_types, seed))


def _read_split(source) -> tuple[dict, dict]:
    """({key: array}, {key: names}) of one split: from an h5 path, or from
    the arrays themselves (a dict as synthetic_jetclass_arrays gives it)."""
    if isinstance(source, dict):
        return ({k: np.asarray(v) for k, v in source.items() if k != "names"},
                {k: np.asarray(v) for k, v in source["names"].items()})
    if not os.path.isfile(source):
        raise FileNotFoundError(f"File {source} does not exist.")
    import h5py

    with h5py.File(source, "r") as f:
        return ({k: np.asarray(f[k]) for k in f.keys()},
                {k: np.asarray(f[k].attrs[f"names_{k}"]) for k in f.keys() if "mask" not in k})


@dataclass
class JetClassDataModule(ArrayDataModule):
    filename_dict: dict = field(default_factory=dict)
    additional_part_features: Optional[list] = None
    used_jet_types: Optional[list] = None
    number_of_used_jets: Optional[int] = None
    number_of_used_jets_val: Optional[int] = None
    normalize: bool = True
    normalize_sigma: float = 5
    conditioning_pt: bool = True
    conditioning_energy: bool = False
    conditioning_eta: bool = False
    conditioning_mass: bool = True
    conditioning_num_particles: bool = False
    conditioning_jet_type: bool = True
    conditioning_jet_type_all: bool = False
    conditioning_gen_filename: Optional[str] = None
    # in-memory synthetic splits (synthetic_jetclass_arrays, all 10 types and
    # the 10 additional particle features; seeds 0, 1, 2) in place of
    # filename_dict's files: train synthetic_num_jets jets, val and test a
    # quarter of that each
    synthetic: bool = False
    synthetic_num_jets: int = 4096
    synthetic_num_particles: int = 128

    names_particle_features: Optional[np.ndarray] = None
    names_conditioning: Optional[list] = None
    labels_train: Optional[np.ndarray] = None
    labels_val: Optional[np.ndarray] = None
    labels_test: Optional[np.ndarray] = None
    mask_gen: Optional[np.ndarray] = None
    tensor_conditioning_gen: Optional[np.ndarray] = None
    min_max_train_dict: dict = field(default_factory=dict)

    @property
    def num_cond_features(self) -> int:
        base = sum(
            [
                self.conditioning_pt,
                self.conditioning_energy,
                self.conditioning_eta,
                self.conditioning_mass,
                self.conditioning_num_particles,
            ]
        )
        if self.conditioning_jet_type:
            base += len(self._categories)
        return base

    def setup(self) -> None:
        if self.train is not None:
            return
        arrays, names = {}, {}
        for split, source in self._sources().items():
            arrays[split], names[split] = _read_split(source)

        names_part = names["train"]["part_features"]
        names_jet = names["train"]["jet_features"]
        names_labels = [
            s.decode() if isinstance(s, bytes) else str(s)
            for s in names["train"]["labels"]
        ]

        base = [
            get_feat_index(names_part, "part_etarel"),
            get_feat_index(names_part, "part_dphi"),
            get_feat_index(names_part, "part_ptrel"),
        ]
        if self.additional_part_features:
            base += [get_feat_index(names_part, f) for f in self.additional_part_features]
        self.names_particle_features = names_part[base]

        data = {}
        for split in ("train", "val", "test"):
            rs = np.random.RandomState(332211)
            perm = rs.permutation(len(arrays[split]["jet_features"]))
            data[split] = dict(
                x=arrays[split]["part_features"][:, :, base][perm],
                mask=arrays[split]["part_mask"][..., None][perm],
                jets=arrays[split]["jet_features"][perm],
                labels=arrays[split]["labels"][perm],
            )
        part_means = arrays["train"]["part_means"][base]
        part_stds = arrays["train"]["part_stds"][base]

        # jet-type filtering
        type_map = {lbl.split("_")[-1]: i for i, lbl in enumerate(names_labels)}
        used = self.used_jet_types or list(type_map.keys())
        for jt in used:
            if jt not in type_map:
                raise ValueError(f"Jet type {jt} not in {list(type_map.keys())}")
        used_vals = [type_map[jt] for jt in used]
        idx_type = get_feat_index(names_jet, "jet_type")
        for split in data.values():
            keep = np.isin(split["jets"][:, idx_type], used_vals)
            for k in split:
                split[k] = split[k][keep]

        if self.number_of_used_jets:
            for split in ("train", "test"):
                for k in data[split]:
                    data[split][k] = data[split][k][: self.number_of_used_jets]
        if self.number_of_used_jets_val:
            for k in data["val"]:
                data["val"][k] = data["val"][k][: self.number_of_used_jets_val]

        self._categories = (
            np.arange(len(names_labels))
            if self.conditioning_jet_type_all
            else np.unique(data["train"]["jets"][:, idx_type])
        )

        conds = {}
        for split in ("train", "val", "test"):
            conds[split], self.names_conditioning = self._handle_conditioning(
                data[split]["jets"], names_jet, names_labels
            )

        if self.conditioning_gen_filename:
            import h5py

            with h5py.File(self.conditioning_gen_filename, "r") as f:
                jf = np.asarray(f["jet_features"])
                pm = np.asarray(f["part_mask"])
                nm = np.asarray(f["jet_features"].attrs["names_jet_features"])
                keep = np.isin(jf[:, get_feat_index(nm, "jet_type")], used_vals)
                cond_gen, _ = self._handle_conditioning(jf[keep], nm, names_labels)
                self.mask_gen = pm[keep][..., None].astype(np.float32)
                self.tensor_conditioning_gen = cond_gen.astype(np.float32)

        self.labels_train = data["train"]["labels"]
        self.labels_val = data["val"]["labels"]
        self.labels_test = data["test"]["labels"]

        # un-standardized eval tensors + training min/max per feature.
        # means/stds are only exposed when training data IS standardized —
        # consumers key "needs inverse-normalization" off `means is not None`
        if self.normalize:
            self.means, self.stds = part_means, part_stds
        unstd = {}
        for split in ("train", "val", "test"):
            x, m = data[split]["x"], data[split]["mask"]
            unstd[split] = (x * part_stds + part_means) * m
        for i, nm_ in enumerate(self.names_particle_features):
            key = nm_.decode() if isinstance(nm_, bytes) else str(nm_)
            tr = unstd["train"][..., i][data["train"]["mask"][..., 0] != 0]
            self.min_max_train_dict[key] = {"min": tr.min(), "max": tr.max()}

        self.tensor_train = unstd["train"]
        self.mask_train = data["train"]["mask"].astype(np.float32)
        self.tensor_val, self.mask_val = unstd["val"], data["val"]["mask"].astype(np.float32)
        self.tensor_test, self.mask_test = unstd["test"], data["test"]["mask"].astype(np.float32)
        self.tensor_conditioning_train = conds["train"]
        self.tensor_conditioning_val = conds["val"]
        self.tensor_conditioning_test = conds["test"]

        sigma = self.normalize_sigma if self.normalize else None

        def dl(split):
            if sigma is not None:
                return data[split]["x"].astype(np.float32) * sigma
            return unstd[split].astype(np.float32)

        arrays = {name: dl(name) for name in ("train", "val", "test")}
        for name, arr in arrays.items():
            if np.isnan(arr).any():
                raise ValueError("NaNs found in particle data!")
        self.train = Split(arrays["train"], self.mask_train, conds["train"])
        self.val = Split(arrays["val"], self.mask_val, conds["val"])
        self.test = Split(arrays["test"], self.mask_test, conds["test"])

    def _sources(self) -> dict:
        """{split: an h5 path, or a dict of synthetic arrays}."""
        if self.synthetic:
            n = self.synthetic_num_jets
            sizes = {"train": n, "val": max(n // 4, 1), "test": max(n // 4, 1)}
            return {split: synthetic_jetclass_arrays(
                        size, self.synthetic_num_particles, num_types=len(JETCLASS_TYPES),
                        seed=k, additional_features=True)
                    for k, (split, size) in enumerate(sizes.items())}
        for split in ("train", "val", "test"):
            if split not in self.filename_dict:
                raise ValueError("filename_dict must contain 'train', 'val' and 'test'")
        return dict(self.filename_dict)

    def _handle_conditioning(self, jet_data, names_jet, names_labels):
        """One-hot the jet type + selected jet kinematics. Conditioning is
        not normalized (reference TODO at jetclass_datamodule.py:402-406)."""
        idx_type = get_feat_index(names_jet, "jet_type")
        cats = self._categories
        onehot = (jet_data[:, idx_type][:, None] == np.asarray(cats)[None, :]).astype(
            np.float32
        )
        cols, names = [], []
        if self.conditioning_jet_type:
            cols.append(onehot)
            names += [f"jet_type_label_{names_labels[int(i)].split('_')[-1]}" for i in cats]
        for flag, feat in [
            (self.conditioning_pt, "jet_pt"),
            (self.conditioning_energy, "jet_energy"),
            (self.conditioning_eta, "jet_eta"),
            (self.conditioning_mass, "jet_sdmass"),
            (self.conditioning_num_particles, "jet_nparticles"),
        ]:
            if flag:
                cols.append(jet_data[:, [get_feat_index(names_jet, feat)]].astype(np.float32))
                names.append(feat)
        if not cols:
            return None, None
        return np.concatenate(cols, axis=-1), names
