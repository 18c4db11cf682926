"""Model text serialization in the LightGBM format (a copy of
``lightgbm_tpu/io/model_io.py``, trimmed to the text writer and parser).

Behavioral analog of ref: src/boosting/gbdt_model_text.cpp (SaveModelToString
:311, LoadModelFromString :421, DumpModel).  The text format is kept
compatible with the reference so models interoperate: a model saved here loads
in stock LightGBM and vice versa (numerical splits; categorical bitsets follow
the same cat_boundaries/cat_threshold encoding).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.tree import HostTree
from ..utils import log

MODEL_VERSION = "v3"


def _fmt(x: float) -> str:
    """Shortest round-trip float formatting (the reference uses
    Common::DoubleToStr with %.17g semantics)."""
    return np.format_float_positional(
        x, unique=True, trim="0") if np.isfinite(x) else repr(float(x))


def _fmt_arr(arr, high_precision=False) -> str:
    out = []
    for v in arr:
        if isinstance(v, (int, np.integer)):
            out.append(str(int(v)))
        elif high_precision:
            out.append(f"{float(v):.17g}")
        else:
            out.append(f"{float(v):g}")
    return " ".join(out)


def tree_to_string(tree: HostTree) -> str:
    """(ref: src/io/tree.cpp:336 Tree::ToString)"""
    nl = tree.num_leaves
    ni = max(0, nl - 1)
    num_cat = len(tree.cat_boundaries) - 1 if tree.cat_threshold else 0
    lines = [
        f"num_leaves={nl}",
        f"num_cat={num_cat}",
        "split_feature=" + _fmt_arr(tree.split_feature[:ni]),
        "split_gain=" + _fmt_arr(tree.split_gain[:ni]),
        "threshold=" + _fmt_arr(tree.threshold[:ni], high_precision=True),
        "decision_type=" + _fmt_arr(tree.decision_type[:ni]),
        "left_child=" + _fmt_arr(tree.left_child[:ni]),
        "right_child=" + _fmt_arr(tree.right_child[:ni]),
        "leaf_value=" + _fmt_arr(tree.leaf_value[:nl], high_precision=True),
        "leaf_weight=" + _fmt_arr(tree.leaf_weight[:nl],
                                  high_precision=True),
        "leaf_count=" + _fmt_arr(tree.leaf_count[:nl]),
        "internal_value=" + _fmt_arr(tree.internal_value[:ni]),
        "internal_weight=" + _fmt_arr(tree.internal_weight[:ni]),
        "internal_count=" + _fmt_arr(tree.internal_count[:ni]),
    ]
    if num_cat > 0:
        lines.append("cat_boundaries=" + _fmt_arr(tree.cat_boundaries))
        lines.append("cat_threshold=" + _fmt_arr(tree.cat_threshold))
    lines.append(f"is_linear={1 if tree.is_linear else 0}")
    if tree.is_linear:
        # ref: tree.cpp ToString is_linear block
        lines.append("leaf_const=" + _fmt_arr(tree.leaf_const,
                                              high_precision=True))
        nf = [len(c) for c in tree.leaf_coeff]
        lines.append("num_features=" + _fmt_arr(nf))
        flat_f = [f for fs in tree.leaf_features for f in fs]
        flat_c = [c for cs in tree.leaf_coeff for c in cs]
        lines.append("leaf_features=" + _fmt_arr(flat_f))
        lines.append("leaf_coeff=" + _fmt_arr(flat_c, high_precision=True))
    lines.append(f"shrinkage={tree.shrinkage:g}")
    return "\n".join(lines) + "\n"


def tree_from_block(kv: Dict[str, str]) -> HostTree:
    """(ref: src/io/tree.cpp Tree::Tree(const char*, size_t*))"""
    nl = int(kv["num_leaves"])
    tree = HostTree(nl, shrinkage=float(kv.get("shrinkage", 1.0)))
    ni = max(0, nl - 1)

    def arr(key, dtype, n):
        if n == 0 or key not in kv or not kv[key].strip():
            return np.zeros(n, dtype)
        return np.asarray(kv[key].split(), dtype=dtype)

    tree.split_feature = arr("split_feature", np.int32, ni)
    tree.split_gain = arr("split_gain", np.float64, ni)
    tree.threshold = arr("threshold", np.float64, ni)
    tree.decision_type = arr("decision_type", np.int32, ni)
    tree.left_child = arr("left_child", np.int32, ni)
    tree.right_child = arr("right_child", np.int32, ni)
    tree.leaf_value = arr("leaf_value", np.float64, nl)
    tree.leaf_weight = arr("leaf_weight", np.float64, nl)
    tree.leaf_count = arr("leaf_count", np.int64, nl)
    tree.internal_value = arr("internal_value", np.float64, ni)
    tree.internal_weight = arr("internal_weight", np.float64, ni)
    tree.internal_count = arr("internal_count", np.int64, ni)
    num_cat = int(kv.get("num_cat", 0))
    if num_cat > 0:
        tree.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
        tree.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
    tree.is_linear = bool(int(kv.get("is_linear", 0)))
    if tree.is_linear:
        import numpy as _np
        tree.leaf_const = _np.array(
            [float(x) for x in kv.get("leaf_const", "").split()] or
            [0.0] * nl, _np.float64)
        nf = [int(x) for x in kv.get("num_features", "").split()] or \
            [0] * nl
        flat_f = [int(x) for x in kv.get("leaf_features", "").split()]
        flat_c = [float(x) for x in kv.get("leaf_coeff", "").split()]
        tree.leaf_features, tree.leaf_coeff = [], []
        pos = 0
        for n in nf:
            tree.leaf_features.append(flat_f[pos:pos + n])
            tree.leaf_coeff.append(flat_c[pos:pos + n])
            pos += n
    return tree


def feature_importance(models: List[HostTree], num_features: int,
                       importance_type: int = 0) -> np.ndarray:
    """(ref: gbdt.cpp FeatureImportance — 0=split count, 1=total gain)"""
    imp = np.zeros(num_features, np.float64)
    for t in models:
        ni = max(0, t.num_leaves - 1)
        for i in range(ni):
            if t.split_gain[i] <= 0:
                continue
            f = int(t.split_feature[i])
            if importance_type == 0:
                imp[f] += 1.0
            else:
                imp[f] += t.split_gain[i]
    return imp


def save_model_to_string(booster, start_iteration: int = 0,
                         num_iteration: int = -1,
                         importance_type: int = 0) -> str:
    """(ref: gbdt_model_text.cpp:311 SaveModelToString).

    ``booster`` duck-types: models, num_tree_per_iteration, objective,
    feature_names, feature_infos, max_feature_idx, num_class,
    average_output, config (optional).
    """
    ss = ["tree", f"version={MODEL_VERSION}",
          f"num_class={booster.num_class}",
          f"num_tree_per_iteration={booster.num_tree_per_iteration}",
          f"label_index={getattr(booster, 'label_index', 0)}",
          f"max_feature_idx={booster.max_feature_idx}"]
    if booster.objective is not None:
        ss.append(f"objective={booster.objective.to_string()}")
    if getattr(booster, "average_output", False):
        ss.append("average_output")
    ss.append("feature_names=" + " ".join(booster.feature_names))
    if getattr(booster, "monotone_constraints", None) is not None:
        ss.append("monotone_constraints="
                  + " ".join(str(int(m))
                             for m in booster.monotone_constraints))
    ss.append("feature_infos=" + " ".join(booster.feature_infos))

    models = booster.models
    k = booster.num_tree_per_iteration
    total_iteration = len(models) // k
    start_iteration = min(max(start_iteration, 0), total_iteration)
    num_used_model = len(models)
    if num_iteration > 0:
        num_used_model = min((start_iteration + num_iteration) * k,
                             num_used_model)
    start_model = start_iteration * k

    tree_strs = []
    for i in range(start_model, num_used_model):
        s = f"Tree={i - start_model}\n" + tree_to_string(models[i]) + "\n"
        tree_strs.append(s)
    ss.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    ss.append("")
    body = "\n".join(ss) + "\n" + "".join(tree_strs) + "end of trees\n"

    imp = feature_importance(models[start_model:num_used_model],
                             booster.max_feature_idx + 1, importance_type)
    pairs = sorted([(int(imp[i]), booster.feature_names[i])
                    for i in range(len(imp)) if imp[i] > 0],
                   key=lambda p: -p[0])
    body += "\nfeature_importances:\n"
    for cnt, name in pairs:
        body += f"{name}={cnt}\n"
    if getattr(booster, "loaded_parameter", ""):
        body += "\nparameters:\n" + booster.loaded_parameter \
                + "\nend of parameters\n"
    elif getattr(booster, "config", None) is not None:
        body += "\nparameters:\n"
        for kk, vv in booster.config.to_dict().items():
            if kk in _INGEST_TRANSPORT_KEYS:
                # data-loading transport knobs (chunked ingest, binary
                # cache maintenance) select HOW the shard reached the
                # device, never what was learned: the streamed/cached
                # paths' bit-identical-serialization contract
                # (docs/Data.md) requires they not echo, like `resume`
                continue
            if isinstance(vv, list):
                vv = ",".join(str(x) for x in vv)
            body += f"[{kk}: {vv}]\n"
        body += "end of parameters\n"
    return body


# scrubbed from the serialized parameters block — see above
_INGEST_TRANSPORT_KEYS = frozenset(
    ("two_round", "ingest_chunk_rows", "ingest_prefetch", "save_binary"))


def parse_model_string(model_str: str) -> Tuple[Dict[str, str],
                                                List[HostTree], str]:
    """Parse the text format into (header key/values, trees, parameter blob)
    (ref: gbdt_model_text.cpp:421 LoadModelFromString)."""
    header: Dict[str, str] = {}
    lines = model_str.split("\n")
    i = 0
    # header until first Tree= or tree_sizes consumed
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if line == "end of trees":
            break
        if "=" in line:
            key, v = line.split("=", 1)
            header[key.strip()] = v.strip()
        elif line == "average_output":
            header["average_output"] = "1"
        i += 1

    trees: List[HostTree] = []
    cur: Optional[Dict[str, str]] = None
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            if cur is not None:
                trees.append(tree_from_block(cur))
            cur = {}
        elif line == "end of trees":
            if cur is not None:
                trees.append(tree_from_block(cur))
                cur = None
            break
        elif "=" in line and cur is not None:
            key, v = line.split("=", 1)
            cur[key.strip()] = v.strip()
        i += 1

    # parameters blob
    params = ""
    if "\nparameters:" in model_str:
        start = model_str.index("\nparameters:") + len("\nparameters:\n")
        end = model_str.find("\nend of parameters", start)
        if end > 0:
            params = model_str[start:end]
    return header, trees, params

