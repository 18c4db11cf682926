"""lightgbm_tpu_torch package contracts: binning parity with the reference
fixture, the params registry shared with the JAX package, device
selection, unported options, and that the package and chip_smoke.py import
no JAX."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import BinnedDataset

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
PORT = REPO / "lightgbm_tpu_torch"


def test_bin_assignment_matches_reference_fixture():
    """The port's BinMapper bins every value as the reference's
    GreedyFindBin does (mirrors test_ref_parity's bin check)."""
    X = np.load(FIX / "parity_X.npy")
    want = np.load(FIX / "ref_bins.npy")
    cfg = TConfig({"max_bin": 63, "min_data_in_bin": 3, "verbose": -1,
                   "feature_pre_filter": False})
    ds = BinnedDataset.from_data(np.asarray(X[:, :5], np.float64), cfg,
                                 "cpu")
    assert ds.bins.shape == want.shape
    mismatch = (ds.bins != want).mean(axis=0)
    assert (mismatch == 0).all(), f"bin mismatch rates per feature {mismatch}"
    assert torch.equal(ds.bins_dev.cpu(),
                       torch.as_tensor(ds.bins.astype(np.int16)))


def test_config_keeps_every_jax_key():
    t, j = TConfig().to_dict(), JConfig().to_dict()
    assert set(t) == set(j)
    assert t["device_type"] == "cuda"
    assert TConfig({"device": "cpu"}).device_type == "cpu"
    assert {k: v for k, v in t.items() if k != "device_type"} == \
        {k: v for k, v in j.items() if k != "device_type"}


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    X = np.random.RandomState(0).randn(64, 3)
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(lt.LightGBMError, match="CUDA"):
        lt.train({"objective": "binary", "verbose": -1},
                 lt.Dataset(X, label=y), num_boost_round=1)
    with pytest.raises(lt.LightGBMError, match="CUDA"):
        lt.Dataset(X, label=y, params={"device_type": "cuda"}).construct()


@pytest.mark.parametrize("params", [{"telemetry_out": "telemetry.jsonl"}])
def test_unported_options_raise(params):
    X = np.random.RandomState(0).randn(64, 3)
    y = (X[:, 0] > 0).astype(float)
    p = dict({"objective": "binary", "verbose": -1, "device_type": "cpu"},
             **params)
    with pytest.raises(lt.LightGBMError, match="not ported"):
        lt.train(p, lt.Dataset(X, label=y), num_boost_round=1)


def test_tree_learner_without_a_group_trains_serially():
    """``tree_learner=data`` with no process group (or a group of one
    rank) warns and trains the serial model, the JAX package's rule for
    fewer than two devices (lightgbm_tpu/boosting/gbdt.py:1486-1494)."""
    from lightgbm_tpu_torch.utils import log
    X = np.random.RandomState(0).randn(256, 3)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "verbose": -1, "device_type": "cpu",
         "num_leaves": 7}
    serial = lt.train(p, lt.Dataset(X, label=y), num_boost_round=2)
    said = []
    log.register_logger(said.append)
    try:
        dp = lt.train(dict(p, tree_learner="data"), lt.Dataset(X, label=y),
                      num_boost_round=2)
    finally:
        log.register_logger(None)
    assert any("only one device is visible; training serially" in m
               for m in said), said
    assert dp.model_to_string().replace("tree_learner: data", "") == \
        serial.model_to_string().replace("tree_learner: serial", "")


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        mods.append(".".join(rel.parts).replace(".__init__", ""))
    return mods


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh process:
    neither jax nor lightgbm_tpu ends up in sys.modules."""
    assert {"lightgbm_tpu_torch.metric", "lightgbm_tpu_torch.callback",
            "lightgbm_tpu_torch.engine", "lightgbm_tpu_torch.boosting",
            "lightgbm_tpu_torch.objective.multiclass",
            "lightgbm_tpu_torch.objective.xentropy",
            "lightgbm_tpu_torch.objective.rank",
            "lightgbm_tpu_torch.utils.dcg",
            "lightgbm_tpu_torch.utils.random",
            "lightgbm_tpu_torch.ops.efb", "lightgbm_tpu_torch.io.shap",
            "lightgbm_tpu_torch.ops.linear",
            "lightgbm_tpu_torch.models.predictor",
            "lightgbm_tpu_torch.obs.registry",
            "lightgbm_tpu_torch.obs.reqtrace",
            "lightgbm_tpu_torch.serve.engine",
            "lightgbm_tpu_torch.serve.batcher",
            "lightgbm_tpu_torch.serve.residency",
            "lightgbm_tpu_torch.serve.service"} <= set(_port_modules())
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'lightgbm_tpu'"
        " or m.startswith('lightgbm_tpu.')]\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_import():
    for p in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "lightgbm_tpu"), \
                    f"{p.relative_to(REPO)} imports {n}"


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo (or on a
    machine without a card) exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _tiny():
    X = np.random.RandomState(0).randn(256, 4)
    return X, (X[:, 0] > 0).astype(float)


@pytest.mark.parametrize("params", [{}, {"tpu_engine": "auto"},
                                    {"tpu_engine": "fused"}],
                         ids=["default", "auto", "fused"])
def test_tpu_engine_auto_and_fused_train_the_fused_engine(params):
    X, y = _tiny()
    p = dict({"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device_type": "cpu"}, **params)
    g = lt.train(p, lt.Dataset(X, label=y), num_boost_round=2)._gbdt
    assert not g.use_frontier and g._use_epilogue()
    assert hasattr(g, "fused_bins_T") and not hasattr(g, "bins_i32")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_tpu_engine_frontier_trains_the_frontier_engine(impl):
    X, y = _tiny()
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "device_type": "cpu", "tpu_engine": "frontier",
         "tpu_histogram_impl": impl}
    bst = lt.train(p, lt.Dataset(X, label=y), num_boost_round=2)
    g = bst._gbdt
    assert g.use_frontier and not g._use_epilogue()
    assert hasattr(g, "bins_i32") and not hasattr(g, "fused_bins_T")
    assert bst.num_trees() == 2 and bst.models[0].num_leaves > 1


@pytest.mark.parametrize("params,want", [
    ({"forcedsplits_filename": "f.json"}, "leafwise"),
    ({"cegb_penalty_feature_lazy": [1.0] * 3}, "depthwise"),
    ({"cegb_penalty_split": 1.0}, "depthwise"),
    ({"tpu_engine": "xla"}, "leafwise"),
    ({"tpu_engine": "frontier", "tpu_histogram_impl": "segment"},
     "leafwise"),
    ({"tpu_engine": "frontier", "tpu_histogram_impl": "onehot"},
     "leafwise"),
], ids=["forcedsplits_filename", "cegb_penalty_feature_lazy",
        "cegb_penalty_split", "xla", "frontier-segment", "frontier-onehot"])
def test_engine_resolution(params, want, tmp_path):
    """Forced splits, CEGB, tpu_engine=xla and the frontier engine with the
    XLA histograms (once refused as not ported) train the XLA engine's
    grower that the JAX package resolves for them (gbdt.py:1956-2106, its
    TPU resolution: the port's card takes a TPU's place)."""
    import lightgbm_tpu as lj
    X, _ = _tiny()
    y = 10.0 * (X[:, 0] > 0)        # gains far above the CEGB costs
    params = dict(params)
    if "forcedsplits_filename" in params:
        path = tmp_path / params["forcedsplits_filename"]
        path.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
        params["forcedsplits_filename"] = str(path)
    p = dict({"objective": "regression", "num_leaves": 7, "verbose": -1,
              "min_data_in_leaf": 5}, **params)
    bst = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y),
                   num_boost_round=1)
    g = bst._gbdt
    gj = lj.Booster(dict(p), lj.Dataset(X, label=y))._gbdt
    gj.on_tpu = True
    gj._setup_engine(gj.config)
    assert (g.use_fused, g.use_frontier, g.grow_policy) \
        == (gj.use_fused, gj.use_frontier, gj.grow_policy) \
        == (False, False, want)
    assert g.use_cegb == gj.use_cegb == ("cegb" in str(params))
    assert bst.models[0].num_leaves > 1
    if "forcedsplits_filename" in params:
        assert bst.models[0].split_feature[0] == 1
