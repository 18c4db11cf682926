"""Carry state from the JAX package (or LightGBM) into this port.

Takes numpy arrays and model text only, so it needs no JAX: the tests fetch
``lightgbm_tpu``'s arrays with ``jax.device_get`` and hand the numpy dict
over. A GBDT's weights are its trees and its bin mappers; the mappers come
across as a model text's thresholds, or rebuilt from the same data (both
packages bin identically). Monotone constraints cross as the model text's
``monotone_constraints=`` line and as ``FeatureMeta.monotone``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .basic import Booster
from .models.learner import FeatureMeta
from .models.tree import TreeArrays

_I32 = ("split_feature", "threshold_bin", "left_child", "right_child",
        "leaf_depth")
_F32 = ("split_gain", "internal_value", "internal_count", "internal_weight",
        "leaf_value", "leaf_count", "leaf_weight")


def tree_arrays_from_numpy(d: Dict[str, np.ndarray],
                           device="cpu") -> TreeArrays:
    """A dict of numpy arrays with the JAX package's ``TreeArrays`` fields
    (``jax.device_get(tree)._asdict()``) -> this port's ``TreeArrays``,
    categorical nodes (``cat_flag``, ``cat_mask``) included."""
    out = {"num_leaves": int(np.asarray(d["num_leaves"]))}
    for k in _I32:
        out[k] = torch.as_tensor(np.asarray(d[k], np.int32), device=device)
    for k in _F32:
        out[k] = torch.as_tensor(np.asarray(d[k], np.float32), device=device)
    for k in ("default_left", "cat_flag", "cat_mask"):
        out[k] = torch.as_tensor(np.asarray(d[k], bool), device=device)
    return TreeArrays(**out)


def feature_meta_from_numpy(d: Dict[str, np.ndarray],
                            device="cpu") -> FeatureMeta:
    """A dict of numpy arrays with the ``FeatureMeta`` fields -> this port's
    ``FeatureMeta`` (int32 metadata; ``is_cat`` kept when present)."""
    is_cat = d.get("is_cat")
    return FeatureMeta(
        *[torch.as_tensor(np.asarray(d[k], np.int32), device=device)
          for k in ("num_bin", "missing_type", "default_bin", "monotone")],
        is_cat=(None if is_cat is None
                else torch.as_tensor(np.asarray(is_cat, bool),
                                     device=device)))


def booster_from_model_string(s: str, device_type: str = "cuda") -> Booster:
    """Load a model text that the JAX package or LightGBM wrote into a
    port ``Booster`` predicting on ``device_type``; its
    ``monotone_constraints=`` header line crosses too, so the port writes
    it back out."""
    bst = Booster(params={"device_type": device_type}, model_str=s)
    for line in s.split("\n"):
        if line.startswith("monotone_constraints="):
            bst.monotone_constraints = np.asarray(
                line.split("=", 1)[1].split(), np.int32)
        elif line.startswith("Tree="):
            break
    return bst
