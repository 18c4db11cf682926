"""Tree routing on raw feature values, on the device.

PyTorch counterpart of ``route_raw_rows_to_leaves`` in
``lightgbm_tpu/ops/predict.py``: one tree level per step for every row at
once, with the reference's numerical decision (ref: tree.h
NumericalDecision) — ``missing_type`` per node from the decision_type
bitfield, NaN treated as 0.0 unless the node's missing type is NaN, and the
zero band ``|v| <= 1e-35`` missing for missing type Zero. Values and
thresholds are float64, so routing is bit-identical to the host walk
(``HostTree.predict_rows``). A categorical node (decision_type bit 0)
sends a row left iff its value, truncated to an integer, is a category in
the node's bitset (ref: tree.h CategoricalDecision): NaN, negative values
and categories past the bitset go right (``lightgbm_tpu/ops/predict.py``
``route_raw_rows_to_leaves``, ``models/tree.py`` ``_cat_decision``).

:func:`route_binned_rows_to_leaves` is the same walk on the training bins
(``route_rows_to_leaves`` of the JAX package), and :func:`add_tree_score`
adds one tree's leaf values to a score row through it: the per-tree
valid-score update, and ``rollback_one_iter``'s subtraction. A categorical
node there goes left iff its ``cat_mask`` row holds the row's bin. On a
sparse-built (prebundled) dataset the bins are EFB bundle columns, and
``bundle`` = (col_of_feat, offset_of_feat, most_freq_bin) decodes each
node's logical bin from its feature's column (``lightgbm_tpu/ops/
predict.py:31-60``). The JAX
package computes these outside any Pallas kernel, in plain XLA; here they
are plain torch.

:func:`predict_raw`, :func:`predict_raw_early_stop` and
:func:`predict_leaf` take linear trees too: they route as any other tree,
and :func:`tree_outputs` gives their per-row linear outputs
(``ops/linear.py``).

:func:`predict_pass` is the stacked traversal of the device predictor
(``models/predictor.py``; the JAX package's ``_run_binned_body`` /
``_run_raw_body``): every row through every tree of a packed ``[T, N]``
stack, leaf values summed per class in float32, in one launch of the
hand-written CUDA kernel ``csrc/predict_pass.cu``, which walks 16-byte
node records packed once per model (:func:`pack_records`, shape by
:func:`tiled_plan`). Its plain version :func:`predict_pass_plain`
routes tree by tree on the per-field stacks through
:func:`route_binned_rows_to_leaves` or, in float32 against thresholds
pre-rounded by ``models.predictor.threshold_to_f32``,
:func:`route_raw_rows_to_leaves`; it is a different function from the
float64 walk of :func:`predict_raw`, which stays exact.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .linear import linear_leaf_outputs

K_ZERO_THRESHOLD = 1e-35

# predict_pass's operands after the encoded rows, per variant (the order of
# the JAX package's run_args without tids)
BINNED_FIELDS = ("sf", "tb", "dl", "lc", "rc", "lv", "cf", "cm", "num_bin",
                 "missing", "default_bin")
RAW_FIELDS = ("sf", "th", "dl", "mt", "lc", "rc", "lv", "cf", "cm")
FIELDS = {"binned": BINNED_FIELDS, "raw": RAW_FIELDS}
_DTYPES = {"sf": torch.int32, "tb": torch.int32, "th": torch.float32,
           "dl": torch.bool, "mt": torch.int32, "lc": torch.int32,
           "rc": torch.int32, "lv": torch.float32, "cf": torch.bool,
           "cm": torch.bool, "num_bin": torch.int32, "missing": torch.int32,
           "default_bin": torch.int32}

# the kernel's operands, after a variant's FIELDS (pack_records):
# one 16-byte record per node, and the binned features' missing bins
RECORDS = ("nodes", "fmiss")
FEATURE_BITS = 24           # a record's split feature: bits 0-23

# predict_pass wrapper calls and CUDA kernel launches since the last reset
# (CPU calls never count), beside ops/fused_level's counters; and the calls
# by variant, "+cat" where the stack has categorical nodes
launches: Dict[str, int] = {"predict_pass": 0}
cuda_launches: Dict[str, int] = {"predict_pass": 0}
variant_launches: Dict[str, int] = dict.fromkeys(
    ["predict_pass:" + v + c for v in FIELDS for c in ("", "+cat")], 0)
# the calls by CUDA stream and variant, ``(stream handle, "predict_pass:"
# + variant)``: a serving fleet's launches per lane (each lane has its own
# stream)
stream_launches: Dict[Tuple[int, str], int] = {}
# the serving fleet's lane workers launch from several threads at once
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for counts in (launches, cuda_launches, variant_launches):
            for k in counts:
                counts[k] = 0
        stream_launches.clear()


def route_raw_rows_to_leaves(values: torch.Tensor,
                             split_feature: torch.Tensor,
                             threshold: torch.Tensor,
                             default_left: torch.Tensor,
                             missing_type: torch.Tensor,
                             left_child: torch.Tensor,
                             right_child: torch.Tensor,
                             max_steps: int,
                             cat_flag: torch.Tensor = None,
                             cat_mask: torch.Tensor = None) -> torch.Tensor:
    """Leaf index per row for one tree (child >= 0 internal node, < 0 is
    ~leaf). ``values`` [R, F] and ``threshold`` [N] of one dtype: float64
    for the exact walk, float32 with ``threshold_to_f32`` thresholds for
    :func:`predict_pass_plain`; per-node arrays [N]; ``max_steps`` must be
    >= the tree's depth. ``cat_flag`` [N] and ``cat_mask`` [N, C]
    (indexed by the integer category value) route the categorical
    nodes."""
    R = values.shape[0]
    node = torch.zeros(R, dtype=torch.int64, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for _ in range(max_steps):
        is_internal = node >= 0
        nd = node.clamp(min=0)
        f = split_feature[nd]
        v = torch.gather(values, 1, f[:, None])[:, 0]
        mt = missing_type[nd]
        nan_mask = torch.isnan(v)
        zero_mask = torch.abs(v) <= K_ZERO_THRESHOLD
        is_missing = torch.where(mt == 2, nan_mask,
                                 (mt == 1) & (zero_mask | nan_mask))
        v_eff = torch.where(nan_mask & (mt != 2), zero, v)
        go_left = torch.where(is_missing, default_left[nd],
                              v_eff <= threshold[nd])
        if cat_flag is not None:
            C = cat_mask.shape[1]
            # range-checked before the cast; (-1, 0) truncates to 0 as the
            # host walk's int cast does
            bad = nan_mask | (v <= -1.0) | (v >= C)
            iv = torch.where(bad, -1.0, v).to(torch.int64)
            cat_left = cat_mask[nd, iv.clamp(0, C - 1)] & (iv >= 0)
            go_left = torch.where(cat_flag[nd], cat_left, go_left)
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        node = torch.where(is_internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def route_binned_rows_to_leaves(bins: torch.Tensor,
                                split_feature: torch.Tensor,
                                threshold_bin: torch.Tensor,
                                default_left: torch.Tensor,
                                left_child: torch.Tensor,
                                right_child: torch.Tensor,
                                num_bin: torch.Tensor,
                                missing_type: torch.Tensor,
                                default_bin: torch.Tensor,
                                max_steps: int,
                                cat_flag: torch.Tensor = None,
                                cat_mask: torch.Tensor = None,
                                bundle: tuple = None) -> torch.Tensor:
    """Leaf index per row for one tree on binned rows ``bins`` [R, F]:
    ``split_feature`` holds inner feature indices; a row whose bin is the
    feature's missing bin (its default bin for missing type Zero, the last
    bin for NaN) follows ``default_left``, others go left iff
    bin <= threshold_bin (ref: src/io/dense_bin.hpp Split); a categorical
    node (``cat_flag`` [N]) goes left iff its ``cat_mask`` [N, B] row holds
    the bin. ``bundle`` (col_of_feat, offset_of_feat, most_freq_bin), when
    ``bins`` holds EFB bundle columns: a node's logical bin is its
    column's value less the feature's offset inside the feature's window,
    else (a bundle-default row) the feature's most-frequent bin."""
    R = bins.shape[0]
    node = torch.zeros(R, dtype=torch.int64, device=bins.device)
    for _ in range(max_steps):
        is_internal = node >= 0
        nd = node.clamp(min=0)
        f = split_feature[nd].long()
        if bundle is None:
            b = torch.gather(bins, 1, f[:, None])[:, 0].long()
        else:
            col_of_feat, offset_of_feat, mfb = bundle
            raw = torch.gather(bins, 1, col_of_feat[f][:, None].long())[:, 0] \
                .long()
            off = offset_of_feat[f].long()
            in_win = (raw >= off) & (raw < off + num_bin[f])
            b = torch.where(in_win, raw - off, mfb[f].long())
        mt = missing_type[f]
        missing = (((mt == 1) & (b == default_bin[f]))
                   | ((mt == 2) & (b == num_bin[f] - 1)))
        go_left = torch.where(missing, default_left[nd],
                              b <= threshold_bin[nd])
        if cat_flag is not None:
            go_left = torch.where(cat_flag[nd], cat_mask[nd, b], go_left)
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        node = torch.where(is_internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def add_tree_score(score: torch.Tensor, bins: torch.Tensor,
                   leaf_value: torch.Tensor, split_feature: torch.Tensor,
                   threshold_bin: torch.Tensor, default_left: torch.Tensor,
                   left_child: torch.Tensor, right_child: torch.Tensor,
                   num_bin: torch.Tensor, missing_type: torch.Tensor,
                   default_bin: torch.Tensor,
                   max_steps: int, cat_flag: torch.Tensor = None,
                   cat_mask: torch.Tensor = None,
                   bundle: tuple = None) -> torch.Tensor:
    """``score + leaf_value[route(row)]`` for one tree on binned rows
    (``add_tree_score`` of the JAX package's ``ops/predict.py``); a new
    tensor, ``score`` [R] and ``leaf_value`` [L] of one dtype. ``bundle``
    as for :func:`route_binned_rows_to_leaves`."""
    leaves = route_binned_rows_to_leaves(
        bins, split_feature, threshold_bin, default_left, left_child,
        right_child, num_bin, missing_type, default_bin, max_steps,
        cat_flag, cat_mask, bundle)
    return score + leaf_value[leaves]


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    depth = 0
    frontier = [0]
    while frontier:
        depth += 1
        nxt = []
        for nd in frontier:
            for c in (int(left[nd]), int(right[nd])):
                if c >= 0:
                    nxt.append(c)
        frontier = nxt
    return depth


def cat_value_masks(tree):
    """(cat_flag [N], cat_mask [N, C]) of a host tree's categorical nodes
    over category values: cat_mask[i, c] iff bit c of node i's bitset is
    set, C = 32 x the widest bitset; None when no node is categorical."""
    ni = tree.num_internal
    flag = (np.asarray(tree.decision_type[:ni]) & 1) != 0
    if not flag.any():
        return None
    words = {i: tree.cat_bitset(i) for i in np.nonzero(flag)[0]}
    C = 32 * max(len(w) for w in words.values())
    mask = np.zeros((ni, C), bool)
    for i, ws in words.items():
        bits = np.asarray(ws, np.uint32)[:, None] >> np.arange(
            32, dtype=np.uint32)[None, :]
        mask[i, :32 * len(ws)] = (bits & 1).reshape(-1).astype(bool)
    return flag, mask


def tree_leaves(t, X: torch.Tensor) -> torch.Tensor:
    """[n] int64 leaf index of every row of ``X`` [n, F] float64 in the
    HostTree ``t`` (leaf 0 for a one-leaf tree), routed on X's device;
    a linear tree routes as any other."""
    dev = X.device
    if t.num_leaves <= 1:
        return torch.zeros(X.shape[0], dtype=torch.int64, device=dev)
    ni = t.num_internal

    def a(x, dt):
        return torch.as_tensor(np.asarray(x[:ni]), dtype=dt, device=dev)
    d = np.asarray(t.decision_type[:ni])
    cat = cat_value_masks(t)
    return route_raw_rows_to_leaves(
        X, a(t.split_feature, torch.int64), a(t.threshold, torch.float64),
        torch.as_tensor((d & 2) != 0, device=dev),
        torch.as_tensor((d >> 2) & 3, device=dev),
        a(t.left_child, torch.int64), a(t.right_child, torch.int64),
        tree_depth(t.left_child, t.right_child),
        *([] if cat is None else
          [torch.as_tensor(c, device=dev) for c in cat]))


def tree_outputs(t, X: torch.Tensor) -> torch.Tensor:
    """[n] float64 output of the HostTree ``t`` for every row of ``X``:
    its leaf's value, or a linear tree's per-row linear output
    (``ops.linear.linear_leaf_outputs``)."""
    leaves = tree_leaves(t, X)
    if getattr(t, "is_linear", False):
        return linear_leaf_outputs(t, X, leaves)
    return torch.as_tensor(np.asarray(t.leaf_value, np.float64),
                           device=X.device)[leaves]


def predict_raw(models: List, X: torch.Tensor, k: int) -> torch.Tensor:
    """Raw scores [k, n] float64 of ``models`` (HostTrees) on ``X``
    [n, F] float64, summed in tree order like the JAX package's host walk
    (basic.host_walk_raw)."""
    raw = torch.zeros((k, X.shape[0]), dtype=torch.float64, device=X.device)
    for i, t in enumerate(models):
        raw[i % k] += tree_outputs(t, X)
    return raw


def predict_leaf(models: List, X: torch.Tensor) -> torch.Tensor:
    """[n, len(models)] int32 leaf of every row in every tree (the JAX
    package's ``pred_leaf``, ``basic.py:996-1000``)."""
    out = torch.zeros((X.shape[0], len(models)), dtype=torch.int32,
                      device=X.device)
    for i, t in enumerate(models):
        out[:, i] = tree_leaves(t, X).to(torch.int32)
    return out


def predict_raw_early_stop(models: List, X: torch.Tensor, k: int,
                           freq: int, margin: float):
    """Margin-based prediction early stopping (ref:
    src/boosting/prediction_early_stop.cpp; the JAX package's
    ``_predict_raw_early_stop``, ``basic.py:1016-1038``): trees add to a
    row's raw scores in tree order until, at a check after every ``freq *
    k`` trees, its margin exceeds ``margin`` (binary: |raw|; multiclass:
    the top score less the second); the row then takes no more trees.
    Returns (raw [k, n] float64, active [n] bool: the rows never
    stopped). The checks run on the device: no host read."""
    dev = X.device
    raw = torch.zeros((k, X.shape[0]), dtype=torch.float64, device=dev)
    active = torch.ones(X.shape[0], dtype=torch.bool, device=dev)
    for i, t in enumerate(models):
        c = i % k
        raw[c] = torch.where(active, raw[c] + tree_outputs(t, X), raw[c])
        if (i + 1) % (freq * k) == 0:
            if k == 1:
                done = raw[0].abs() > margin
            else:
                top = torch.topk(raw, 2, dim=0).values
                done = (top[0] - top[1]) > margin
            active &= ~done
    return raw, active


# ----------------------------------------------------- the stacked traversal
def _check_pass_inputs(enc, packed, tids, k, variant):
    if variant not in FIELDS:
        raise ValueError(f"variant must be 'binned' or 'raw', not {variant!r}")
    names = FIELDS[variant]
    if len(packed) != len(names) + len(RECORDS):
        raise ValueError(f"a {variant} stack has {len(names)} operands "
                         f"{names}, then {RECORDS}; got {len(packed)}")
    records = tuple(packed[len(names):])
    packed = tuple(packed[:len(names)])
    want = torch.float32 if variant == "raw" else torch.int32
    if enc.dim() != 2 or enc.dtype != want:
        raise ValueError(f"enc must be [R, F] {want} for the {variant} "
                         f"variant, got {tuple(enc.shape)} {enc.dtype}")
    ops = dict(zip(names, packed))
    for name, a in ops.items():
        if a is None:
            if name not in ("cf", "cm"):
                raise ValueError(f"operand {name} is missing")
            continue
        if a.dtype != _DTYPES[name] or a.device != enc.device:
            raise ValueError(f"operand {name} must be {_DTYPES[name]} on "
                             f"{enc.device}, got {a.dtype} on {a.device}")
    if (ops["cf"] is None) != (ops["cm"] is None):
        raise ValueError("cf and cm come together")
    T, N = ops["sf"].shape
    F = enc.shape[1]
    for name, a in ops.items():
        if a is None:
            continue
        lead = (F,) if name in ("num_bin", "missing", "default_bin") \
            else (T,) if name == "lv" else (T, N)
        ndim = {"lv": 2, "cm": 3}.get(name, len(lead))
        if a.dim() != ndim or tuple(a.shape[:len(lead)]) != lead:
            raise ValueError(f"operand {name} must be {lead} + "
                             f"{ndim - len(lead)} more dims, got "
                             f"{tuple(a.shape)}")
    if tids.dtype != torch.int32 or tuple(tids.shape) != (T,) \
            or tids.device != enc.device:
        raise ValueError(f"tids must be [{T}] int32 on {enc.device}")
    if k < 1:
        raise ValueError("k must be >= 1")
    nodes, fmiss = records
    if nodes is None or nodes.dtype != torch.int32 \
            or tuple(nodes.shape) != (T, N, 4) \
            or nodes.device != enc.device:
        raise ValueError(f"nodes must be [{T}, {N}, 4] int32 on "
                         f"{enc.device}")
    if (fmiss is None) != (variant == "raw") or (
            fmiss is not None and (fmiss.dtype != torch.int32
                                   or tuple(fmiss.shape) != (F,)
                                   or fmiss.device != enc.device)):
        raise ValueError(f"fmiss must be [{F}] int32 on {enc.device} "
                         "for the binned variant, None for raw")
    ops.update(zip(RECORDS, records))
    return ops


def pack_records(packed: Sequence, variant: str):
    """The kernel's operands of a stack (``packed`` in
    ``FIELDS[variant]`` order), made once per model on the stack's device:
    ``nodes`` [T, N, 4] int32, one 16-byte record per node (x = split
    feature | default left << 24 | missing type << 25 | categorical << 27,
    the binned variant's missing type its feature's; y = the threshold bin,
    or the float32 threshold's bits; z, w = the children), and ``fmiss``
    [F] int32, each binned feature's missing bin (its default bin for
    missing type Zero, its last bin for NaN, else -1; None for raw)."""
    o = dict(zip(FIELDS[variant], packed))
    sf = o["sf"]
    if sf.numel() and (int(sf.min()) < 0
                       or int(sf.max()) >= 1 << FEATURE_BITS):
        raise ValueError(f"split features must lie in [0, "
                         f"2**{FEATURE_BITS})")
    i32 = torch.int32
    if variant == "binned":
        miss = o["missing"]
        mt = miss[sf.long()]
        thr = o["tb"]
        fmiss = torch.where(miss == 1, o["default_bin"],
                            torch.where(miss == 2, o["num_bin"] - 1,
                                        -1)).to(i32).contiguous()
    else:
        mt, thr, fmiss = o["mt"], o["th"].contiguous().view(i32), None
    cf = torch.zeros_like(o["dl"]) if o["cf"] is None else o["cf"]
    w0 = sf.to(i32) | (o["dl"].to(i32) << 24) | (mt.to(i32) << 25) \
        | (cf.to(i32) << 27)
    nodes = torch.stack([w0, thr.to(i32), o["lc"].to(i32),
                         o["rc"].to(i32)], -1).contiguous()
    return nodes, fmiss


def predict_pass_plain(enc: torch.Tensor, packed: Sequence, tids: torch.Tensor,
                       k: int, max_steps: int, variant: str) -> torch.Tensor:
    """Plain version of :func:`predict_pass`: per tree, its leaves through
    :func:`route_binned_rows_to_leaves` (``variant="binned"``) or
    :func:`route_raw_rows_to_leaves` in float32 (``"raw"``), then
    ``raw[tids[t]] += lv[t][leaves]`` in float32, in tree order (the JAX
    package's ``_run_binned_body`` / ``_run_raw_body``). It walks the
    per-field operands and leaves the ``RECORDS`` to the kernel, so a
    packing fault shows as a disagreement. Returns [k, R] float32 on
    ``enc``'s device."""
    ops = _check_pass_inputs(enc, packed, tids, k, variant)
    R = enc.shape[0]
    raw = torch.zeros((k, R), dtype=torch.float32, device=enc.device)
    cf, cm = ops["cf"], ops["cm"]
    for t, tid in enumerate(tids.tolist()):
        cat = () if cf is None else (cf[t], cm[t])
        if variant == "binned":
            leaves = route_binned_rows_to_leaves(
                enc, ops["sf"][t], ops["tb"][t], ops["dl"][t], ops["lc"][t],
                ops["rc"][t], ops["num_bin"], ops["missing"],
                ops["default_bin"], max_steps, *cat)
        else:
            leaves = route_raw_rows_to_leaves(
                enc, ops["sf"][t].long(), ops["th"][t], ops["dl"][t],
                ops["mt"][t], ops["lc"][t], ops["rc"][t], max_steps, *cat)
        raw[tid] += ops["lv"][t][leaves]
    return raw


# shared memory a block of the tiled design may fill (two blocks per SM)
TILED_SMEM = 100 * 1024
TILED_ROWS_SMEM_MAX = 64 * 1024


def tiled_plan(R: int, F: int, T: int, N: int, L: int,
               sms: int) -> Dict[str, int]:
    """The tiled design's launch shape on a card of ``sms`` SMs: RT rows
    per block (128, 256 or 512: the most that still gives one and a half
    blocks per SM; each block stages every tree once, so wider tiles read
    the stack fewer times), TS tree splits per row tile (where the row
    tiles alone leave SMs idle) of Ts trees, TC trees per shared-memory
    chunk, and whether the rows and the trees are staged in shared
    memory. An empty stack (T = 0) is one split of one tree's room: the
    launch writes zeros."""
    RT = next((rt for rt in (512, 256) if 2 * R >= 3 * sms * rt), 128)
    rows_bytes = RT * F * 4 + F * 4
    rows_smem = int(rows_bytes <= TILED_ROWS_SMEM_MAX)
    room = TILED_SMEM - rows_smem * rows_bytes
    per_tree = 16 * N + 4 * L
    nodes_smem = int(per_tree <= room)
    tiles = -(-R // RT)
    TS = 1 if tiles >= sms or T <= 1 else min(T, -(-2 * sms // tiles))
    Ts = max(1, -(-T // TS))
    TS = max(1, -(-T // Ts))
    TC = min(Ts, room // per_tree) if nodes_smem else Ts
    return {"RT": RT, "TS": TS, "Ts": Ts, "TC": TC, "rows_smem": rows_smem,
            "nodes_smem": nodes_smem, "tiles": tiles}


_SMS: Dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def predict_pass(enc: torch.Tensor, packed: Sequence, tids: torch.Tensor,
                 k: int, max_steps: int, variant: str) -> torch.Tensor:
    """Raw scores [k, R] float32 of a packed tree stack (``packed`` holds
    the operands of ``FIELDS[variant]`` in order, ``cf``/``cm`` None
    without categorical nodes, then the ``RECORDS`` that
    :func:`pack_records` makes of them once per model) on the encoded rows
    ``enc`` [R, F] (int32 bins for ``"binned"``, float32 values for
    ``"raw"``); tree t adds to class ``tids[t]``; ``max_steps`` >= every
    tree's depth. On a CPU tensor the plain version; on the card one
    launch of ``csrc/predict_pass.cu`` on the current stream (the same
    bits), or it raises."""
    ops = _check_pass_inputs(enc, packed, tids, k, variant)
    if enc.device.type == "cpu":
        return predict_pass_plain(enc, packed, tids, k, max_steps, variant)
    from .cuda_build import library
    from .fused_level import _raise_on, _require_cuda, _stream
    _require_cuda(enc, tids, *(a for a in ops.values() if a is not None))
    R, F = enc.shape
    T, N = ops["sf"].shape
    L = ops["lv"].shape[1]
    cm = ops["cm"]
    out = torch.empty((k, R), dtype=torch.float32, device=enc.device)
    if R == 0:
        return out

    def ptr(a) -> Optional[int]:
        return None if a is None else a.data_ptr()
    plan = tiled_plan(R, F, T, N, L, _sm_count(enc.device))
    stream = _stream(enc.device)
    scratch = done = None
    if plan["TS"] > 1:
        scratch = torch.empty((T, R), dtype=torch.float32, device=enc.device)
        done = torch.zeros(plan["tiles"], dtype=torch.int32,
                           device=enc.device)
    rc = library().lgbt_predict_pass(
        enc.data_ptr(), int(variant == "raw"), R, F, T, N, L,
        0 if cm is None else cm.shape[2], k, max_steps,
        ops["nodes"].data_ptr(), ops["lv"].data_ptr(), tids.data_ptr(),
        ptr(cm), ptr(ops["fmiss"]), out.data_ptr(), ptr(scratch), ptr(done),
        plan["RT"], plan["TS"], plan["Ts"], plan["TC"], plan["rows_smem"],
        plan["nodes_smem"], stream)
    _raise_on(rc, "predict_pass")
    name = "predict_pass:" + variant + ("" if cm is None else "+cat")
    with _COUNT_LOCK:
        launches["predict_pass"] += 1
        cuda_launches["predict_pass"] += 1
        variant_launches[name] += 1
        stream_launches[(stream, name)] = \
            stream_launches.get((stream, name), 0) + 1
    return out
