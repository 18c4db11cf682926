"""The stacked-tree predictor of the port against the JAX package's.

The port's ``models/predictor.py`` packs a model into the same [T, N]
stacks as ``lightgbm_tpu/models/predictor.py`` (checked array by array on
one model text parsed by both packages: a categorical column, NaN-heavy
columns, zero-as-missing columns, a single-leaf tree);
``ops.predict.predict_pass_plain`` on the JAX package's own packed arrays
gives the JAX runner's leaves exactly and its float32 scores within rtol
1e-6 (the sums add the same f32 values in the same order; the largest
difference is recorded); ``threshold_to_f32`` is equal; and
``Booster.predict`` switches between the device predictor and the float64
walk by the JAX package's rules (``tests/test_predict_paths.py``).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import predictor as jpred
from lightgbm_tpu.models.tree import HostTree as JTree
from lightgbm_tpu.ops import predict as jops
from lightgbm_tpu_torch.models import predictor as tpred
from lightgbm_tpu_torch.models.tree import HostTree as TTree
from lightgbm_tpu_torch.ops import predict as tops
from torch_parity import random_stack

FORCE_DEV = {"pred_device_min_work": 0}
FORCE_HOST = {"pred_device_min_work": 10**15}
CPU = {"device_type": "cpu"}
SINGLE_LEAF_TREE = 3      # replaced by a one-leaf tree in both packages


def _rows(n, seed):
    """Column 0 categorical (12 codes), 1-2 NaN-heavy, 3 mostly zeros."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 10)
    X[:, 0] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.35, 1] = np.nan
    X[rng.rand(n) < 0.35, 2] = np.nan
    X[rng.rand(n) < 0.5, 3] = 0.0
    z = ((X[:, 0] % 3) == 1) + np.nan_to_num(X[:, 1]) - X[:, 3] \
        + 0.5 * X[:, 4] + 0.2 * rng.randn(n)
    return X, (z > 0.6).astype(np.float64)


@pytest.fixture(scope="module", params=["nan", "zero"])
def case(request):
    """One port-trained model (2,000 x 10 rows, 15 leaves, 10 rounds) as
    model text, its tree 3 made a single leaf after parsing."""
    X, y = _rows(2000, 0)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 5,
              "zero_as_missing": request.param == "zero"}
    ds = lt.Dataset(X, label=y, categorical_feature=[0],
                    params=dict(params, **CPU))
    text = lt.train(dict(params, **CPU), ds, 10).model_to_string()
    return {"X": X, "y": y, "params": params, "text": text}


def _one_leaf(tree_cls, value=0.125):
    t = tree_cls(1)
    t.leaf_value = np.array([value])
    return t


def _loaded(case):
    """(port booster, JAX booster) from the model text, tree 3 one leaf."""
    tb = lt.Booster(params=CPU, model_str=case["text"])
    jb = jlgb.Booster(model_str=case["text"])
    tb.models[SINGLE_LEAF_TREE] = _one_leaf(TTree)
    jb.models[SINGLE_LEAF_TREE] = _one_leaf(JTree)
    return tb, jb


def _datasets(case):
    """The training rows binned by each package with the same params."""
    X, y, p = case["X"], case["y"], case["params"]
    tds = lt.Dataset(X, label=y, categorical_feature=[0],
                     params=dict(p, **CPU)).construct()._inner
    jds = jlgb.Dataset(X, label=y, categorical_feature=[0],
                       params=dict(p)).construct()._inner
    return tds, jds


def _predictors(case, variant):
    tb, jb = _loaded(case)
    if variant == "binned":
        tds, jds = _datasets(case)
        return (tpred.DevicePredictor(tb.models, tds, 1),
                jpred.DevicePredictor(jb.models, jds, 1))
    nf = tb.max_feature_idx + 1
    return (tpred.RawDevicePredictor(tb.models, nf, 1, device="cpu"),
            jpred.RawDevicePredictor(jb.models, nf, 1))


def _jax_arrays(jp):
    """The JAX predictor's stacks by the port's operand names."""
    names = tops.FIELDS[jp.variant]
    return {n: None if getattr(jp, n) is None else np.array(getattr(jp, n))
            for n in names}


@pytest.mark.parametrize("variant", ["binned", "raw"])
def test_packed_stacks_equal_jax(case, variant):
    tp, jp = _predictors(case, variant)
    assert tp.ok and jp.ok
    assert (tp.k, tp.max_steps, tp.enc_width, tp.enc_dtype) == \
        (jp.k, jp.max_steps, jp.enc_width, jp.enc_dtype)
    want = _jax_arrays(jp)
    assert want["cf"] is not None and want["cf"].any()   # categorical
    assert list(tp.stack) == list(tops.FIELDS[variant] + tops.RECORDS)
    for name in tops.FIELDS[variant]:
        a = tp.stack[name]
        if want[name] is None:
            assert a is None, name
            continue
        assert a.numpy().dtype == want[name].dtype, name
        np.testing.assert_array_equal(a.numpy(), want[name], err_msg=name)
    # the tiled kernel's records, packed from those fields
    records = tops.pack_records(tuple(
        None if want[n] is None else torch.as_tensor(want[n])
        for n in tops.FIELDS[variant]), variant)
    for name, a, b in zip(tops.RECORDS, records,
                          (tp.stack[n] for n in tops.RECORDS)):
        assert (a is None) == (b is None) == (
            name == "fmiss" and variant == "raw"), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
    # the single-leaf tree and the missing types of the case
    assert (want["lc"][SINGLE_LEAF_TREE] == -1).all()
    mt = want["missing"] if variant == "binned" else want["mt"]
    assert (2 if case["params"]["zero_as_missing"] is False else 1) in mt
    X = case["X"][:300]
    np.testing.assert_array_equal(tp.encode(X), np.asarray(jp.encode(X)))


def _jax_leaves(variant, enc, a, t, steps):
    cat = (None, None) if a["cf"] is None else (a["cf"][t], a["cm"][t])
    if variant == "binned":
        return np.asarray(jops.route_rows_to_leaves(
            enc, a["sf"][t], a["tb"][t], a["dl"][t], a["lc"][t], a["rc"][t],
            a["num_bin"], a["missing"], a["default_bin"], steps, *cat))
    return np.asarray(jops.route_raw_rows_to_leaves(
        enc, a["sf"][t], a["th"][t], a["dl"][t], a["mt"][t], a["lc"][t],
        a["rc"][t], steps, *cat))


def _port_leaves(variant, enc, ops, t, steps):
    o = dict(zip(tops.FIELDS[variant], ops))
    cat = () if o["cf"] is None else (o["cf"][t], o["cm"][t])
    if variant == "binned":
        return tops.route_binned_rows_to_leaves(
            enc, o["sf"][t], o["tb"][t], o["dl"][t], o["lc"][t], o["rc"][t],
            o["num_bin"], o["missing"], o["default_bin"], steps,
            *cat).numpy()
    return tops.route_raw_rows_to_leaves(
        enc, o["sf"][t].long(), o["th"][t], o["dl"][t], o["mt"][t],
        o["lc"][t], o["rc"][t], steps, *cat).numpy()


def _hold_plain_to_jax(variant, enc, arrays, tids, k, steps,
                       record_property, tag):
    import jax.numpy as jnp
    ops = tuple(None if arrays[n] is None else torch.as_tensor(arrays[n])
                for n in tops.FIELDS[variant])
    t_enc, t_tids = torch.as_tensor(enc), torch.as_tensor(tids)
    got = tops.predict_pass_plain(t_enc, ops + tops.pack_records(
        ops, variant), t_tids, k, steps, variant).numpy()
    # the JAX runner's operand order: tids after lv
    names = tops.FIELDS[variant]
    cut = names.index("lv") + 1
    jargs = [None if arrays[n] is None else jnp.asarray(arrays[n])
             for n in names]
    jargs = jargs[:cut] + [jnp.asarray(tids)] + jargs[cut:]
    want = np.asarray(jpred.stacked_run_fn(variant)(
        jnp.asarray(enc), *jargs, k=k, max_steps=steps))
    for t in range(arrays["sf"].shape[0]):
        np.testing.assert_array_equal(
            _port_leaves(variant, t_enc, ops, t, steps),
            _jax_leaves(variant, jnp.asarray(enc), arrays, t, steps),
            err_msg=f"tree {t}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                      1e-30)))
    record_property(f"max_rel_diff_{tag}", err)


@pytest.mark.parametrize("variant", ["binned", "raw"])
def test_plain_pass_on_jax_packed_equals_jax_runner(case, variant,
                                                    record_property):
    """The JAX package's own packed arrays (carried across as numpy)
    through predict_pass_plain against its stacked_run_fn."""
    _, jp = _predictors(case, variant)
    X, _ = _rows(500, 7)
    X[:5] = np.nan
    X[5:10, 3] = 0.0
    X[10, 0] = 40.0                       # an unseen category
    X = X.astype(np.float32).astype(np.float64)
    enc = np.asarray(jp.encode(X))
    arrays = _jax_arrays(jp)
    tids = np.zeros(arrays["sf"].shape[0], np.int32)
    _hold_plain_to_jax(variant, enc, arrays, tids, 1, jp.max_steps,
                       record_property,
                       f"{variant}_zero_as_missing="
                       f"{case['params']['zero_as_missing']}")
    # the same through the port's predictor built from those arrays
    port = (tpred.DevicePredictor if variant == "binned"
            else tpred.RawDevicePredictor).from_packed(
        arrays, 1, jp.max_steps, jp.enc_width)
    ref = np.asarray(jp.predict_raw(X, 0, arrays["sf"].shape[0]))
    np.testing.assert_allclose(port.run(torch.as_tensor(enc), 0,
                                        port.num_trees).numpy(), ref,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", ["binned", "raw"])
def test_plain_pass_random_stacks_equal_jax_runner(variant,
                                                   record_property):
    """Random stacks with categorical nodes, k = 3 and every missing rule
    hold predict_pass_plain to the JAX runner."""
    enc, arrays, tids, steps = random_stack(variant, R=400, T=15, k=3,
                                            cat=True, seed=5)
    _hold_plain_to_jax(variant, enc, arrays, tids, 3, steps,
                       record_property, f"random_{variant}")


def test_threshold_to_f32_equal():
    rng = np.random.RandomState(0)
    thr = np.concatenate([rng.randn(2000) * 10.0 ** rng.randint(-30, 30, 2000),
                          [0.0, -0.0, 1e-35, -1e-35, 1e300, -1e300,
                           np.float64(np.float32(0.1)), 0.1, 3.4e38,
                           -3.4e38, np.nextafter(1.0, 2.0)]])
    np.testing.assert_array_equal(tpred.threshold_to_f32(thr),
                                  jpred.threshold_to_f32(thr))
    assert tpred._round_up_pow2(9) == jpred._round_up_pow2(9) == 16


# ------------------------------------------------ Booster.predict dispatch
def _train(X, y, rounds=3, **extra):
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "min_data_in_leaf": 5, **CPU}
    p.update(extra)
    return lt.train(p, lt.Dataset(X, label=y), rounds)


def test_threshold_key_switches_paths():
    rng = np.random.RandomState(0)
    X = rng.rand(250, 6).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    bst = _train(X, y, **FORCE_DEV)
    assert bst.config.pred_device_min_work == 0
    dev = bst.predict(X[:10])
    pred = bst._device_predictor
    assert isinstance(pred, tpred.DevicePredictor) and pred.ok
    bst.predict(X[:10])
    assert bst._device_predictor is pred          # cached
    bst.config.update(FORCE_HOST)
    assert bst._pred_device_min_work() == 10**15
    np.testing.assert_allclose(dev, bst.predict(X[:10]), rtol=1e-6)
    bst.config.update(FORCE_DEV)
    bst.update()                                   # the trees change
    bst.predict(X[:10])
    assert bst._device_predictor is not pred       # packed again
    # with the default threshold a small predict stays on the walk
    b2 = _train(X, y, rounds=2)
    assert b2.config.pred_device_min_work == 2_000_000
    b2.predict(X[:10])
    assert b2._device_predictor is None


def test_raw_routing_needs_f32_input_or_the_key(tmp_path):
    """A file-loaded model: float32 input at or above the threshold takes
    the raw device predictor, float64 input the walk unless the key is
    set; each agrees with the JAX package's predict on the same text."""
    rng = np.random.RandomState(7)
    X = rng.rand(600, 10).astype(np.float32)
    X[rng.rand(*X.shape) < 0.2] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 2]) > 0) \
        .astype(np.float32)
    text = _train(X, y, rounds=6, num_leaves=31).model_to_string()
    Xq = rng.rand(120, 10).astype(np.float32)
    Xq[rng.rand(*Xq.shape) < 0.3] = np.nan
    small = {"pred_device_min_work": 100}
    b = lt.Booster(params=CPU, model_str=text)
    b.params["pred_device_min_work"] = 100
    b._pred_min_work_cache = None
    b.predict(Xq.astype(np.float64))
    assert b._device_predictor is not None         # the key was set
    plain = lt.Booster(params=dict(CPU), model_str=text)
    plain._pred_min_work_cache = 100               # a default, not set
    walk = plain.predict(Xq.astype(np.float64))
    assert plain._device_predictor is None
    dev = plain.predict(Xq)                        # float32 input
    assert isinstance(plain._device_predictor, tpred.RawDevicePredictor)
    np.testing.assert_allclose(dev, walk, rtol=1e-6, atol=1e-7)
    jb = jlgb.Booster(model_str=text, params=small)
    np.testing.assert_allclose(dev, jb.predict(Xq), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(walk, jlgb.Booster(model_str=text).predict(
        Xq.astype(np.float64)), rtol=1e-12, atol=1e-15)


def test_multiclass_start_num_iteration_paths():
    rng = np.random.RandomState(8)
    X = rng.rand(400, 6)
    y = (X[:, 0] * 3).astype(int) % 3
    bst = lt.train({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "verbose": -1, "min_data_in_leaf": 5,
                    **CPU}, lt.Dataset(X, label=y), 4)
    jb = jlgb.Booster(model_str=bst.model_to_string(), params=FORCE_DEV)
    Xq = rng.rand(40, 6)
    for kw in ({}, {"raw_score": True},
               {"start_iteration": 1, "num_iteration": 2}):
        bst.config.update(FORCE_HOST)
        host = bst.predict(Xq, **kw)
        bst.config.update(FORCE_DEV)
        dev = bst.predict(Xq, **kw)
        assert bst._device_predictor.k == 3
        np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dev, jb.predict(Xq.astype(np.float32),
                                                   **kw),
                                   rtol=1e-5, atol=1e-6)


def test_linear_model_stays_on_walk():
    rng = np.random.RandomState(8)
    X = rng.rand(300, 4)
    y = X @ np.array([1.0, 2.0, -1.0, 0.5]) + 0.05 * rng.randn(300)
    p = {"objective": "regression", "num_leaves": 5, "verbose": -1,
         "linear_tree": True, "min_data_in_leaf": 10, **CPU}
    blin = lt.train(p, lt.Dataset(X, label=y, params=p), 2)
    host = blin.predict(X[:20])
    blin.config.update(FORCE_DEV)
    dev = blin.predict(X[:20])
    pred = blin._device_predictor
    assert not pred.ok and pred.reason == "linear_tree"
    np.testing.assert_array_equal(dev, host)


def test_ineligible_reasons_match_jax():
    assert tpred.RawDevicePredictor([], 3, 1).reason == \
        jpred.RawDevicePredictor([], 3, 1).reason == "no_trees"
    t, j = TTree(3), JTree(3)
    for tree in (t, j):
        tree.split_feature = np.array([5, 0], np.int32)
        tree.threshold = np.array([0.5, 0.5])
        tree.decision_type = np.array([0, 0], np.int32)
        tree.left_child = np.array([1, -1], np.int32)
        tree.right_child = np.array([-2, -3], np.int32)
        tree.leaf_value = np.array([0.1, 0.2, 0.3])
    assert tpred.RawDevicePredictor([t], 3, 1).reason == \
        jpred.RawDevicePredictor([j], 3, 1).reason == "feature_out_of_range"
    for tree in (t, j):
        tree.split_feature = np.array([0, 1], np.int32)
        tree.decision_type = np.array([1, 0], np.int32)
        tree.threshold = np.array([0.0, 0.5])
        tree.cat_boundaries = [0, 200]
        tree.cat_threshold = [0] * 199 + [1]
    assert tpred.RawDevicePredictor([t], 3, 1).reason == \
        jpred.RawDevicePredictor([j], 3, 1).reason == "cat_vocab_too_large"
    big = [t] * 20000
    assert tpred.RawDevicePredictor(big, 3, 1, cat_value_cap=10**6).reason \
        == jpred.RawDevicePredictor([j] * 20000, 3, 1,
                                    cat_value_cap=10**6).reason \
        == "cat_mask_too_large"
