"""Batched on-device prediction over stacked tree tensors.

PyTorch counterpart of ``lightgbm_tpu/models/predictor.py``: a model is
packed ONCE into ``[T, N]`` tree tensors on the device, and every call
scores all its trees in one launch of ``ops.predict.predict_pass`` (the
hand-written CUDA kernel ``csrc/predict_pass.cu``; on the CPU its plain
version). Two routing variants share it:

- :class:`DevicePredictor` — **binned** routing: the rows are binned
  through the training BinMappers (exactly the training-time
  quantization; on the card by ``binning.values_to_bins``, on the CPU and
  in the serving engine's :meth:`encode` on the host), then compared with
  threshold bins on the device. Needs a training dataset.
- :class:`RawDevicePredictor` — **raw-value** routing for boosters without
  training BinMappers (model files, the serving case): float32 compares
  against thresholds pre-rounded by :func:`threshold_to_f32`, so any
  float32-representable input routes as the float64 walk does; per-node
  missing semantics from the model's decision_type bitfield.

Scores accumulate in float32 (the walk in ``ops/predict.py`` carries
float64; the difference is ~1e-7 relative). A model the stack cannot hold
gives ``ok = False`` and a ``reason`` (``no_trees``, ``linear_tree``,
``no_used_features``, ``filtered_feature``, ``feature_out_of_range``,
``cat_vocab_too_large``, ``cat_mask_too_large``), as the JAX package's
does; its callers take the walk then. :meth:`_StackedPredictor.from_packed`
builds a predictor from arrays packed elsewhere (the JAX package's, in the
tests).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import device_bin_tables, values_to_bins
from ..ops.predict import FIELDS, RECORDS, pack_records, predict_pass

# raw-variant categorical vocabulary cap: the per-node mask is a [T, N, C]
# bool tensor over raw category values; a vocabulary past this is a reason
# to take the walk, not an allocation surprise
RAW_CAT_VALUE_CAP = 4096
# ... and so is a mask whose total size explodes (64M bool elements)
RAW_CAT_MASK_MAX_ELEMS = 64 * 1024 * 1024


def _round_up_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def threshold_to_f32(thr: np.ndarray) -> np.ndarray:
    """Largest float32 <= each float64 threshold. With thresholds rounded
    this way, ``v32 <= t32`` in float32 agrees with ``float64(v32) <= t64``
    for every float32 value v32, so raw-value routing on the device matches
    the float64 walk whenever the input is float32-representable."""
    t64 = np.asarray(thr, np.float64)
    t32 = t64.astype(np.float32)
    over = t32.astype(np.float64) > t64
    t32[over] = np.nextafter(t32[over], np.float32(-np.inf))
    return t32


def _tree_depth(t) -> int:
    """A tree's depth for ``max_steps``: its leaf_depth where it has one
    (trained trees), else its internal-node count (model-file trees parse
    with an all-zero leaf_depth; never a fake depth of 0)."""
    ld = getattr(t, "leaf_depth", None)
    if ld is not None and len(ld) and int(np.max(ld)) > 0:
        return int(np.max(ld))
    return t.num_internal


def _cat_words(t, i: int) -> Sequence[int]:
    ci = int(t.threshold[i])
    return t.cat_threshold[t.cat_boundaries[ci]:t.cat_boundaries[ci + 1]]


class _StackedPredictor:
    """The packed stack on one device and its chunked predict loop."""

    variant = ""

    def __init__(self, device=None):
        self.ok = True
        self.reason = ""
        self.k = 1
        self.max_steps = 1
        self.device = torch.device("cpu" if device is None else device)
        self.stack: Dict[str, Optional[torch.Tensor]] = {}
        self.enc_width = 0
        self.enc_dtype = ""

    def _place(self, arrays: Dict[str, Optional[np.ndarray]]) -> None:
        """The stack on the device: ``FIELDS[variant]``, then the tiled
        kernel's ``RECORDS`` packed from them once (``pack_records``)."""
        self.stack = {
            name: None if arrays.get(name) is None else torch.as_tensor(
                np.ascontiguousarray(arrays[name])).to(self.device)
            for name in FIELDS[self.variant]}
        self.stack.update(zip(RECORDS, pack_records(
            tuple(self.stack.values()), self.variant)))

    @classmethod
    def from_packed(cls, arrays: Dict[str, Optional[np.ndarray]], k: int,
                    max_steps: int, enc_width: int,
                    device=None) -> "_StackedPredictor":
        """A predictor over stacks packed elsewhere: ``arrays`` maps each
        name of ``ops.predict.FIELDS[variant]`` to a numpy array (``cf`` and
        ``cm`` None without categorical nodes)."""
        self = cls.__new__(cls)
        _StackedPredictor.__init__(self, device)
        self.k, self.max_steps = int(k), int(max_steps)
        self.enc_width = int(enc_width)
        self.enc_dtype = "int32" if cls.variant == "binned" else "float32"
        self._place(arrays)
        return self

    @property
    def num_trees(self) -> int:
        sf = self.stack.get("sf")
        return 0 if sf is None else int(sf.shape[0])

    @property
    def packed_nbytes(self) -> int:
        """Device bytes of the packed stack (the serving residency
        manager's accounting unit)."""
        return int(sum(a.numel() * a.element_size()
                       for a in self.stack.values() if a is not None))

    def encode(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def run_args(self, lo: int, hi: int) -> Tuple[Tuple, torch.Tensor]:
        """(the stack's operands for trees [lo, hi) in ``FIELDS`` order,
        then ``RECORDS``; each tree's class): views of the packed tensors,
        no copy; the per-feature tensors whole."""
        per_feature = {"num_bin", "missing", "default_bin", "fmiss"}
        ops = tuple(None if a is None else a if name in per_feature
                    else a[lo:hi] for name, a in self.stack.items())
        tids = torch.arange(lo, hi, dtype=torch.int32) % self.k
        return ops, tids.to(self.device)

    def run(self, enc: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """[k, R] float32 raw scores of trees [lo, hi) on encoded rows
        already on the device: one ``predict_pass``."""
        ops, tids = self.run_args(lo, hi)
        return predict_pass(enc, ops, tids, self.k, self.max_steps,
                            self.variant)

    def predict_raw(self, X, lo: int, hi: int,
                    chunk_rows: int = 2_000_000) -> np.ndarray:
        """Sum of leaf values of trees [lo, hi) per class, [k, R] float64.
        A scipy sparse matrix is densified per chunk of at most 262,144
        rows (routing reads logical values, whatever the training-side
        bundle storage)."""
        try:
            import scipy.sparse as sp
            sparse_in = sp.issparse(X)
        except ImportError:  # pragma: no cover
            sparse_in = False
        if sparse_in:
            X = X.tocsr()
            chunk_rows = min(chunk_rows, 262_144)
        n = X.shape[0]
        out = np.zeros((self.k, n), np.float64)
        for c0 in range(0, n, chunk_rows):
            sl = slice(c0, min(n, c0 + chunk_rows))
            Xc = X[sl].toarray() if sparse_in else X[sl]
            out[:, sl] = self.run(self.encode_on_device(Xc), lo,
                                  hi).cpu().numpy()
        return out

    def encode_on_device(self, X: np.ndarray) -> torch.Tensor:
        """:meth:`encode` of raw rows ``X``, on the stack's device."""
        return torch.from_numpy(self.encode(X)).to(self.device)


class DevicePredictor(_StackedPredictor):
    """Stacked-tree predictor routing on training bins."""

    variant = "binned"

    def __init__(self, models: List, ds, num_tree_per_iteration: int):
        """``models``: HostTrees; ``ds``: the training BinnedDataset
        (mappers, used features), whose device the stack goes to."""
        super().__init__(ds.device)
        self.ds = ds
        self.bin_tables = None        # made at the first device binning
        self.k = num_tree_per_iteration
        T = len(models)
        if T == 0:
            self.ok, self.reason = False, "no_trees"
            return
        if any(getattr(t, "is_linear", False) for t in models):
            # linear leaves compute base + coeff . x from raw values; the
            # stacked leaf-value lookup cannot represent them
            self.ok, self.reason = False, "linear_tree"
            return
        if not ds.used_features:
            self.ok, self.reason = False, "no_used_features"
            return
        inner_of = {j: i for i, j in enumerate(ds.used_features)}
        N = max(max(t.num_internal for t in models), 1)
        L = max(max(t.num_leaves for t in models), 2)
        B = int(max(m.num_bin for m in ds.mappers)) if ds.mappers else 2
        depth = 1
        sf = np.zeros((T, N), np.int32)
        tb = np.zeros((T, N), np.int32)
        dl = np.zeros((T, N), bool)
        lc = np.full((T, N), -1, np.int32)
        rc = np.full((T, N), -1, np.int32)
        lv = np.zeros((T, L), np.float32)
        has_cat = any(t.cat_threshold for t in models)
        cf = np.zeros((T, N), bool) if has_cat else None
        cm = np.zeros((T, N, B), bool) if has_cat else None
        for ti, t in enumerate(models):
            ni = t.num_internal
            if ni == 0:
                lv[ti, 0] = t.leaf_value[0]
                continue
            for i in range(ni):
                real_f = int(t.split_feature[i])
                inner = inner_of.get(real_f, -1)
                if inner < 0:
                    self.ok, self.reason = False, "filtered_feature"
                    return
                sf[ti, i] = inner
                m = ds.mappers[real_f]
                d = int(t.decision_type[i])
                if d & 1:
                    # value bitset -> bin mask through the category vocab
                    cf[ti, i] = True
                    words = _cat_words(t, i)
                    for b, cat in enumerate(m.bin_2_categorical):
                        if cat < 0:
                            continue
                        w, bit = divmod(int(cat), 32)
                        if w < len(words) and (words[w] >> bit) & 1:
                            cm[ti, i, b] = True
                else:
                    tb[ti, i] = int(t.threshold_bin[i]) \
                        if len(t.threshold_bin) > i \
                        else int(m.value_to_bin(t.threshold[i]))
                    dl[ti, i] = bool(d & 2)
            lc[ti, :ni] = t.left_child
            rc[ti, :ni] = t.right_child
            lv[ti, :t.num_leaves] = t.leaf_value
            depth = max(depth, _tree_depth(t))
        self.max_steps = _round_up_pow2(depth + 1)
        self._place({
            "sf": sf, "tb": tb, "dl": dl, "lc": lc, "rc": rc, "lv": lv,
            "cf": cf, "cm": cm,
            "num_bin": np.asarray(ds.num_bin_per_feat, np.int32),
            "missing": np.asarray(ds.missing_types, np.int32),
            "default_bin": np.array([ds.mappers[j].default_bin
                                     for j in ds.used_features], np.int32)})
        # the encoded rows' width and type (the serving engine's signature)
        self.enc_width = ds.num_features
        self.enc_dtype = "int32"

    def encode(self, X: np.ndarray) -> np.ndarray:
        """[R, used features] int32 training bins of raw rows ``X``."""
        ds = self.ds
        out = np.empty((X.shape[0], ds.num_features), np.int32)
        for k, j in enumerate(ds.used_features):
            out[:, k] = ds.mappers[j].value_to_bin(
                np.asarray(X[:, j], np.float64))
        return out

    def used_values(self, X: np.ndarray) -> np.ndarray:
        """[R, used features] float64 of raw rows ``X``: what
        :meth:`encode` bins (no copy where X already is exactly that)."""
        used = self.ds.used_features
        X = np.asarray(X)
        if X.ndim == 2 and used == list(range(X.shape[1])):
            return np.ascontiguousarray(X, np.float64)
        return np.ascontiguousarray(X[:, used], np.float64)

    def encode_on_device(self, X: np.ndarray) -> torch.Tensor:
        """The training bins of raw rows ``X`` binned where the stack lives:
        on the card the used columns go up once as float64 and are binned
        there (``binning.values_to_bins``, the host's bins bit for bit); on
        the CPU :meth:`encode`."""
        if self.device.type == "cpu":
            return torch.from_numpy(self.encode(X))
        if self.bin_tables is None:
            ds = self.ds
            self.bin_tables = device_bin_tables(
                [ds.mappers[j] for j in ds.used_features], self.device)
        return values_to_bins(
            torch.from_numpy(self.used_values(X)).to(self.device),
            self.bin_tables)


class RawDevicePredictor(_StackedPredictor):
    """Stacked-tree predictor routing on raw feature values: the device
    path of boosters with no training dataset (model files, serving)."""

    variant = "raw"

    def __init__(self, models: List, num_features: int,
                 num_tree_per_iteration: int,
                 cat_value_cap: int = RAW_CAT_VALUE_CAP, device=None):
        super().__init__(device)
        self.k = num_tree_per_iteration
        self.num_features = int(num_features)
        self.max_split_feature = -1
        T = len(models)
        if T == 0:
            self.ok, self.reason = False, "no_trees"
            return
        if any(getattr(t, "is_linear", False) for t in models):
            self.ok, self.reason = False, "linear_tree"
            return
        N = max(max(t.num_internal for t in models), 1)
        L = max(max(t.num_leaves for t in models), 2)
        has_cat = any(t.cat_threshold for t in models)
        C = 0
        if has_cat:
            # the highest category any bitset holds sets the mask width
            for t in models:
                for i in range(t.num_internal):
                    if not int(t.decision_type[i]) & 1:
                        continue
                    words = _cat_words(t, i)
                    for wi in range(len(words) - 1, -1, -1):
                        w = int(words[wi])
                        if w:
                            C = max(C, wi * 32 + w.bit_length())
                            break
            if C > cat_value_cap:
                self.ok, self.reason = False, "cat_vocab_too_large"
                return
            C = max(C, 1)
            if T * N * C > RAW_CAT_MASK_MAX_ELEMS:
                self.ok, self.reason = False, "cat_mask_too_large"
                return
        depth = 1
        sf = np.zeros((T, N), np.int32)
        th = np.zeros((T, N), np.float32)
        dl = np.zeros((T, N), bool)
        mt = np.zeros((T, N), np.int32)
        lc = np.full((T, N), -1, np.int32)
        rc = np.full((T, N), -1, np.int32)
        lv = np.zeros((T, L), np.float32)
        cf = np.zeros((T, N), bool) if has_cat else None
        cm = np.zeros((T, N, C), bool) if has_cat else None
        for ti, t in enumerate(models):
            ni = t.num_internal
            if ni == 0:
                lv[ti, 0] = t.leaf_value[0]
                continue
            for i in range(ni):
                f = int(t.split_feature[i])
                if f >= self.num_features:
                    self.ok, self.reason = False, "feature_out_of_range"
                    return
                sf[ti, i] = f
                d = int(t.decision_type[i])
                dl[ti, i] = bool(d & 2)
                mt[ti, i] = (d >> 2) & 3
                if d & 1:
                    cf[ti, i] = True
                    for wi, w in enumerate(_cat_words(t, i)):
                        w = int(w)
                        while w:
                            bit = (w & -w).bit_length() - 1
                            cm[ti, i, wi * 32 + bit] = True
                            w &= w - 1
            # a categorical node's slot holds its (unused) bitset index
            th[ti, :ni] = threshold_to_f32(np.asarray(t.threshold[:ni]))
            lc[ti, :ni] = t.left_child
            rc[ti, :ni] = t.right_child
            lv[ti, :t.num_leaves] = t.leaf_value
            depth = max(depth, _tree_depth(t))
        self.max_steps = _round_up_pow2(depth + 1)
        self._place({"sf": sf, "th": th, "dl": dl, "mt": mt, "lc": lc,
                     "rc": rc, "lv": lv, "cf": cf, "cm": cm})
        self.enc_width = self.num_features
        self.enc_dtype = "float32"
        # the widest feature a split reads: narrower inputs that cover it
        # are fine (the walk takes them too)
        self.max_split_feature = int(sf.max())

    def encode(self, X: np.ndarray) -> np.ndarray:
        """[R, num_features] float32 rows: narrower inputs padded with
        zeros past the last feature a split reads, wider ones trimmed (one
        width per model)."""
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        nf = self.num_features
        if X.shape[1] < nf:
            if X.shape[1] <= self.max_split_feature:
                raise ValueError(
                    f"prediction data has {X.shape[1]} columns but the "
                    f"model splits on feature {self.max_split_feature}")
            X = np.concatenate(
                [X, np.zeros((X.shape[0], nf - X.shape[1]), X.dtype)],
                axis=1)
        return np.ascontiguousarray(X[:, :nf], np.float32)
