"""Binned dataset container + metadata.

PyTorch counterpart of ``lightgbm_tpu/dataset.py`` (``TpuDataset``) on its
dense numerical ``from_data`` path: the same row sample, the same
``BinMapper`` construction (ref: dataset_loader.cpp:988
ConstructBinMappersFromTextData) and the same binning, so both packages bin
a matrix identically. The binned ``[num_data, num_used_features]`` matrix
is kept on the host and, as ``bins_dev``, on the training device.

Categorical features, sparse input and monotone constraints are not ported
yet and raise. Exclusive feature bundling is not ported either: where the
JAX package's fused engine bundles mutually exclusive columns
(``enable_bundle``, on by default), the port trains on the unbundled
columns, which gives the same trees (tests/test_torch_efb_gap.py); the
bundling itself is ROADMAP Queue A item 6.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .binning import BIN_NUMERICAL, BinMapper, effective_bin_counts
from .config import Config
from .utils import log


class Metadata:
    """Label / weight holder (ref: include/LightGBM/dataset.h:42,
    src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        log.check(label.size == self.num_data,
                  f"label size {label.size} != num_data {self.num_data}")
        self.label = label

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        log.check(weight.size == self.num_data,
                  f"weight size {weight.size} != num_data {self.num_data}")
        log.check(bool(np.all(weight >= 0)), "weights should be non-negative")
        self.weight = weight


def _sample_rows(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


class BinnedDataset:
    """The binned training matrix (counterpart of ``TpuDataset``).

    ``bins``: host ``[num_data, num_used_features]`` uint8/uint16;
    ``bins_dev``: the same matrix on ``device``; ``mappers`` holds one
    BinMapper per original feature (trivial ones included, for model IO).
    """

    def __init__(self):
        self.bins: Optional[np.ndarray] = None
        self.bins_dev: Optional[torch.Tensor] = None
        self.device = torch.device("cpu")
        self.mappers: List[BinMapper] = []
        self.used_features: List[int] = []
        self.num_data = 0
        self.num_total_features = 0
        self.feature_names: List[str] = []
        self.metadata: Optional[Metadata] = None
        self.max_num_bin = 1
        self.num_bin_per_feat = np.zeros(0, np.int32)
        self.missing_types = np.zeros(0, np.int32)

    @classmethod
    def from_data(cls, data: np.ndarray, config: Config, device,
                  feature_names: Optional[List[str]] = None
                  ) -> "BinnedDataset":
        """Build from a dense float matrix: sample rows, construct one
        mapper per feature, bin every row, and place the bins on
        ``device``."""
        self = cls()
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("data must be 2-dimensional")
        if config.categorical_feature:
            log.fatal("categorical features are not ported to "
                      "lightgbm_tpu_torch yet")
        if config.monotone_constraints and any(
                int(m) != 0 for m in config.monotone_constraints):
            log.fatal("monotone constraints are not ported to "
                      "lightgbm_tpu_torch yet")
        n, f = data.shape
        self.num_data = n
        self.num_total_features = f
        self.feature_names = (list(feature_names) if feature_names
                              else [f"Column_{i}" for i in range(f)])
        self.metadata = Metadata(n)
        sample_idx = _sample_rows(n, config.bin_construct_sample_cnt,
                                  config.data_random_seed)
        sample = np.asarray(data[sample_idx], dtype=np.float64)
        mb_by_feat = list(config.max_bin_by_feature or [])
        if mb_by_feat and len(mb_by_feat) != f:
            log.fatal("max_bin_by_feature has %d entries but the data has "
                      "%d features" % (len(mb_by_feat), f))
        for j in range(f):
            m = BinMapper()
            col = sample[:, j]
            # the reference feeds only the non-zero sampled values plus the
            # total count (zeros implicit)
            nz = col[(np.abs(col) > 1e-35) | np.isnan(col)]
            m.find_bin(nz, total_sample_cnt=len(col),
                       max_bin=int(mb_by_feat[j]) if mb_by_feat
                       else config.max_bin,
                       min_data_in_bin=config.min_data_in_bin,
                       min_split_data=config.min_data_in_leaf
                       if config.feature_pre_filter else 0,
                       pre_filter=config.feature_pre_filter,
                       bin_type=BIN_NUMERICAL,
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
            self.mappers.append(m)
        self.used_features = [j for j in range(f)
                              if not self.mappers[j].is_trivial]
        if not self.used_features:
            log.warning("There are no meaningful features which satisfy "
                        "the provided configuration.")
        used = [self.mappers[j] for j in self.used_features]
        self.num_bin_per_feat = effective_bin_counts(used)
        self.max_num_bin = (int(self.num_bin_per_feat.max())
                            if self.used_features else 1)
        self.missing_types = np.array([m.missing_type for m in used],
                                      np.int32)
        self.bins = self.bin_rows(data)
        self.device = torch.device(device)
        # widened so bins >= 128 stay positive in a signed tensor
        wide = np.int16 if self.bins.dtype == np.uint8 else np.int32
        self.bins_dev = torch.from_numpy(self.bins.astype(wide)).to(
            self.device)
        return self

    def bin_rows(self, data: np.ndarray) -> np.ndarray:
        """Bin a [rows, num_total_features] float block against the mappers
        -> [rows, num_used_features] uint8/uint16."""
        dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
        dataT = np.ascontiguousarray(data.T)
        outT = np.empty((len(self.used_features), data.shape[0]), dtype)
        for k, j in enumerate(self.used_features):
            outT[k] = self.mappers[j].value_to_bin(dataT[j]).astype(
                dtype, copy=False)
        return np.ascontiguousarray(outT.T)

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def real_feature_index(self, inner_idx: int) -> int:
        return self.used_features[inner_idx]

    def default_bins(self) -> np.ndarray:
        return np.array([self.mappers[j].default_bin
                         for j in self.used_features], np.int32)

    def feature_infos(self) -> List[str]:
        """Per-original-feature info strings for the model text format
        (ref: gbdt_model_text.cpp feature_infos ``[min:max]``)."""
        return ["none" if m.is_trivial else f"[{m.min_val:g}:{m.max_val:g}]"
                for m in self.mappers]
