"""lightgbm_tpu_torch on the card: the CUDA kernels against their plain
PyTorch versions, and CUDA training against CPU training.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import fused_level as tfl
from lightgbm_tpu_torch.ops import layout as tlayout
from lightgbm_tpu_torch.ops import pallas_histogram as tph
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops.layout import feature_layout
from torch_parity import kernel_slabs, level_operands, odd_route_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _operands(R, F, B, nch, seed):
    """Random level operands: rows in leaves 0..2, three active slots on
    features with no, zero and NaN missing types, five inactive slots."""
    rng = np.random.RandomState(seed)
    nb = np.resize(np.array([B, B - 3, B, 7, B], np.int32), F)
    mt = np.resize(np.array([0, 1, 2, 0, 2], np.int32), F)
    db = np.resize(np.array([0, 4, 0, 0, 0], np.int32), F)
    bins = np.stack([rng.randint(0, nb[f], size=R) for f in range(F)])
    F_oh, _ = feature_layout(F, B)
    bins_T = np.zeros((max(F_oh, 8), R), np.int64)
    bins_T[:F] = bins
    t = torch.as_tensor
    dt = torch.int8 if B <= 128 else torch.int16
    leaf = t(rng.randint(0, 3, R).astype(np.int32)[None, :])
    gh = tfl.pack_gh(t(rng.randn(R).astype(np.float32)),
                     t(rng.rand(R).astype(np.float32)),
                     torch.ones(R), nch)
    feat = t(np.array([1, 2, 3, -1, -1, -1, -1, -1], np.int32))
    thr = t(np.array([5, 7, 2, 0, 0, 0, 0, 0], np.int32))
    dl = t(np.array([1, 0, 1, 0, 0, 0, 0, 0], bool))
    W = tfl.build_route_table(feat, thr, dl, t(nb), t(mt), t(db), 8, F_oh, B)
    tbl = np.zeros((8, 128), np.int32)
    tbl[:, 0] = [0, 1, 2, -2, -2, -2, -2, -2]
    tbl[:3, 1] = 3
    tbl[:3, 2] = [1, 0, 1]
    return (t(bins_T).to(dt), leaf, gh, W, t(tbl)), F_oh


@pytest.mark.parametrize("nch,B", [(5, 16), (3, 16), (5, 256)])
def test_kernels_match_plain(cuda_device, nch, B):
    ops, F_oh = _operands(4096, 5, B, nch, seed=B + nch)
    ops_c = [a.to(cuda_device) for a in ops]
    bins, leaf, gh, W, tbl = ops
    n0 = dict(tfl.launches)
    hist_c, leaf_c = tfl.level_pass(*ops_c, num_bins=B, f_oh=F_oh, nch=nch)
    route_c = tfl.route_pass(ops_c[0], ops_c[1], ops_c[3], ops_c[4],
                             num_bins=B, f_oh=F_oh)
    table = torch.randn(3, generator=torch.Generator().manual_seed(0))
    look_c = tfl.table_lookup(leaf_c, table.to(cuda_device))
    torch.cuda.synchronize()
    hist_p, leaf_p = tfl.level_pass_plain(*ops, num_bins=B, f_oh=F_oh,
                                          nch=nch)
    assert {k: tfl.launches[k] - n0[k] for k in n0} == \
        {"level_pass": 1, "route_pass": 1, "table_lookup": 1,
         "epilogue_pass": 0, "hist_pass": 0}
    assert torch.equal(leaf_c.cpu(), leaf_p)
    assert torch.equal(route_c.cpu(), leaf_p)
    assert torch.equal(look_c.cpu(), tfl.table_lookup_plain(leaf_p, table))
    # atomics reorder the f32 sums; the weight channel counts rows exactly
    np.testing.assert_allclose(hist_c.cpu().numpy(), hist_p.numpy(),
                               rtol=1e-5, atol=1e-5)
    w = slice((nch - 1) * 8, nch * 8)
    assert torch.equal(hist_c[:, w].cpu(), hist_p[:, w])


def test_wrappers_refuse_mixed_devices(cuda_device):
    ops, F_oh = _operands(1024, 5, 16, 5, seed=0)
    bins, leaf, gh, W, tbl = ops
    with pytest.raises(ValueError):
        tfl.level_pass(bins.to(cuda_device), leaf, gh, W, tbl, num_bins=16,
                       f_oh=F_oh)


def test_cuda_training_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 8)
    X[rng.rand(5000) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1}
    bc = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 3)
    tfl.reset_launch_counts()
    bg = lt.train(dict(p, device_type="cuda"), lt.Dataset(X, label=y), 3)
    assert all(tfl.launches[k] > 0
               for k in ("level_pass", "route_pass", "table_lookup"))
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def _epilogue_operands(R, F, B, nch, kind, seed):
    """Level operands plus a 7-entry leaf-value table, scores, the kind's
    operand rows and ~30% zero bag weights (padding rows zero)."""
    (bins, leaf, _, W, tbl), F_oh = _operands(R, F, B, nch, seed)
    rng = np.random.RandomState(seed)
    t = torch.as_tensor
    lv = t((rng.randn(7) * 0.1).astype(np.float32))
    score = t(rng.randn(1, R).astype(np.float32))
    ops = np.zeros((8, R), np.float32)
    ops[0] = (np.where(rng.rand(R) < 0.4, 1.0, -1.0) if kind == "binary"
              else rng.randn(R))
    ops[1] = rng.uniform(0.5, 2.0, R)
    bag = t((rng.rand(1, R) >= 0.3).astype(np.float32))
    return (bins, leaf, W, tbl, lv, score, t(ops), bag), F_oh


@pytest.mark.parametrize("nch,B,F,kind", [
    (5, 16, 5, "binary"), (3, 16, 5, "l2"), (5, 256, 5, "l2"),
    # 64 features at Bp=256: two feature groups on grid.y
    (5, 256, 64, "binary")])
def test_epilogue_kernel_matches_plain(cuda_device, nch, B, F, kind):
    ops, F_oh = _epilogue_operands(4096, F, B, nch, kind, seed=B + F)
    kw = dict(num_bins=B, f_oh=F_oh, nch=nch, kind=kind)
    n0 = tfl.launches["epilogue_pass"]
    hist_c, score_c, gh_c = tfl.epilogue_pass(
        *[a.to(cuda_device) for a in ops], **kw)
    torch.cuda.synchronize()
    hist_p, score_p, gh_p = tfl.epilogue_pass_plain(*ops, **kw)
    assert tfl.launches["epilogue_pass"] - n0 == 1
    np.testing.assert_allclose(score_c.cpu().numpy(), score_p.numpy(),
                               rtol=1e-6)
    # the card's expf against the CPU's exp: an ulp apart, g may round to
    # the other bf16 hi, and lo (a remainder up to 2^-8 of g, rounded to 8
    # bits) then leaves hi + lo up to 2^-16 of g from g on each side, so
    # the decoded values may differ by 2^-15 of the value and those ulps
    def decoded(gh):
        x = gh.float().cpu()
        if nch == tfl.NCH_PRECISE:
            return torch.stack([x[0] + x[1], x[2] + x[3], x[4]])
        return x[:3]
    np.testing.assert_allclose(decoded(gh_c).numpy(), decoded(gh_p).numpy(),
                               rtol=4e-5, atol=1e-7)
    assert not gh_c[nch:].any()
    planes_c = tfl.hist_planes(hist_c.cpu(), nch, 8, F_oh, B)
    planes_p = tfl.hist_planes(hist_p, nch, 8, F_oh, B)
    for a, b in zip(planes_c[:2], planes_p[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(planes_c[2], planes_p[2])     # row counts
    live = torch.zeros(nch * 8, dtype=torch.bool)
    live[::8] = True
    assert not hist_c.cpu()[:, ~live].any()


def test_epilogue_wrapper_refuses_mixed_devices_and_dtypes(cuda_device):
    ops, F_oh = _epilogue_operands(1024, 5, 16, 5, "binary", seed=0)
    on_card = [a.to(cuda_device) for a in ops]
    kw = dict(num_bins=16, f_oh=F_oh)
    with pytest.raises(ValueError):
        tfl.epilogue_pass(*on_card[:5], ops[5], *on_card[6:], **kw)
    with pytest.raises(ValueError):
        tfl.epilogue_pass(*on_card[:7], on_card[7].double(), **kw)
    with pytest.raises(ValueError):
        tfl.epilogue_pass(on_card[0].int(), *on_card[1:], **kw)


def test_cuda_update_matches_cpu(cuda_device):
    """Booster.update() (the epilogue body) with bagging and
    feature_fraction on the card against the same on the CPU."""
    rng = np.random.RandomState(1)
    X = rng.randn(5000, 8)
    X[rng.rand(5000) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "bagging_fraction": 0.7, "bagging_freq": 1,
         "feature_fraction": 0.8, "verbose": -1}
    out = {}
    for dev in ("cpu", "cuda"):
        tfl.reset_launch_counts()
        bst = lt.Booster(params=dict(p, device_type=dev),
                         train_set=lt.Dataset(X, label=y))
        for _ in range(4):
            bst.update()
        assert bst._gbdt._use_epilogue()
        out[dev] = (bst, dict(tfl.launches))
    (bc, _), (bg, n) = out["cpu"], out["cuda"]
    assert n["epilogue_pass"] == 4 and n["level_pass"] > 0
    assert n["route_pass"] == n["table_lookup"] == 0
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.train_scores().cpu().numpy(),
                               bc.train_scores().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def _hist_operands(R, F, B, S, quant_bits, seed):
    """[R, Fp] int32 bins, ~30% of rows at slot -1 with non-zero gh, and
    gh as f32 (g, h, w) or the int8 channels of ``quant_bits``."""
    rng = np.random.RandomState(seed)
    Fp, Bp = tph.pad_feature_layout(F, B)
    bins = np.zeros((R, Fp), np.int32)
    bins[:, :F] = rng.randint(0, B, (R, F))
    slot = rng.randint(0, S, R).astype(np.int32)
    slot[rng.rand(R) < 0.3] = -1
    t = torch.as_tensor
    gh = t(np.stack([rng.randn(R), rng.rand(R), np.ones(R)], 1)
           .astype(np.float32))
    if quant_bits:
        g, h = gh[:, 0], gh[:, 1]
        scales = tq.quant_scales(g, h, quant_bits)
        gh = torch.stack(tq.encode_channels(
            *tq.quantize_gh(g, h, scales, quant_bits, seed), gh[:, 2],
            quant_bits), 1).contiguous()
    return t(bins), gh, t(slot), Bp


@pytest.mark.parametrize("R,F,B,S,bits", [
    (5000, 28, 64, 64, 0),    # 7 shared-memory feature groups of 4
    (3001, 28, 64, 8, 0),     # every feature in one group
    (5000, 28, 64, 64, 8),
    (4099, 28, 64, 13, 16),
    # one feature's [5, 64, 256] int32 slab (320 KB) exceeds a block's
    # shared memory: the kernel adds straight into global memory
    (5000, 28, 256, 64, 16),
    (5000, 5, 256, 64, 0),
])
def test_hist_pass_matches_plain(cuda_device, R, F, B, S, bits):
    bins, gh, slot, Bp = _hist_operands(R, F, B, S, bits, seed=R + B + S)
    quant = bool(bits)
    nch = gh.shape[1]
    kw = dict(S=S, Bp=Bp, nch=nch, quant=quant)
    n0 = tfl.launches["hist_pass"]
    out_c = tph.hist_pass(bins.to(cuda_device), gh.to(cuda_device),
                          slot.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tfl.launches["hist_pass"] - n0 == 1
    out_p = tph.hist_pass_plain(bins, gh, slot, **kw)
    assert out_c.shape == out_p.shape and out_c.dtype == out_p.dtype
    if quant:       # integer sums: exact
        assert torch.equal(out_c.cpu(), out_p)
        return
    # atomics reorder the f32 sums; the weight channel counts rows exactly
    for c in range(2):
        np.testing.assert_allclose(
            out_c[c].cpu().numpy(), out_p[c].numpy(), rtol=1e-5,
            atol=1e-5 * float(out_p[c].abs().max()))
    assert torch.equal(out_c[2].cpu(), out_p[2])
    # unslotted rows added nothing
    assert float(out_p[2].sum()) == (slot >= 0).sum().item() * bins.shape[1]


def test_hist_pass_on_cuda_never_runs_the_plain_version(cuda_device,
                                                        monkeypatch):
    bins, gh, slot, Bp = _hist_operands(2048, 6, 16, 4, 0, seed=0)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")
    monkeypatch.setattr(tph, "hist_pass_plain", refuse)
    out = tph.hist_pass(bins.to(cuda_device), gh.to(cuda_device),
                        slot.to(cuda_device), S=4, Bp=Bp, nch=3)
    torch.cuda.synchronize()
    assert out.is_cuda and float(out[2].sum()) > 0
    with pytest.raises(ValueError):
        tph.hist_pass(bins.to(cuda_device), gh, slot.to(cuda_device), S=4,
                      Bp=Bp, nch=3)


def test_cuda_frontier_training_matches_cpu(cuda_device):
    rng = np.random.RandomState(2)
    X = rng.randn(5000, 8)
    X[rng.rand(5000) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "tpu_engine": "frontier", "bagging_fraction": 0.7,
         "bagging_freq": 1, "feature_fraction": 0.8, "verbose": -1}
    bc = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 3)
    tfl.reset_launch_counts()
    bg = lt.train(dict(p, device_type="cuda"), lt.Dataset(X, label=y), 3)
    n = dict(tfl.launches)
    assert bg._gbdt.use_frontier and n.pop("hist_pass") > 0
    assert not any(n.values())           # no fused-engine kernel ran
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.train_scores().cpu().numpy(),
                               bc.train_scores().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------ histogram-plane cuts
PLANE_NUM_BIN = np.array([9] * 4 + [63] * 4 + [8] * 3, np.int32)


def _plane_operands(R, quant_bits, packed, Sp=8, seed=0):
    """Level operands on a mixed-cardinality layout (the narrow features
    first, so the packed layout permutes bins_T's rows): rows in leaves
    0..2, three active slots, gh from pack_gh or pack_gh_quant."""
    rng = np.random.RandomState(seed)
    F = len(PLANE_NUM_BIN)
    F_oh, Bp = feature_layout(F, 63)
    pk = (tlayout.packed_feature_layout(PLANE_NUM_BIN, 63, f_oh=F_oh)
          if packed else None)
    order = np.asarray(pk.feat_order) if packed else np.arange(F)
    bins = np.stack([rng.randint(0, nb, R) for nb in PLANE_NUM_BIN])
    bins_T = np.zeros((max(F_oh, 8), R), np.int8)
    bins_T[:F] = bins[order]
    t = torch.as_tensor
    zeros = np.zeros(F, np.int32)
    feat = np.array([5, 1, 9] + [-1] * (Sp - 3), np.int32)
    thr = np.array([40, 3, 4] + [0] * (Sp - 3), np.int32)
    W = tfl.build_route_table(t(feat), t(thr), t(np.zeros(Sp, bool)),
                              t(PLANE_NUM_BIN), t(zeros), t(zeros), Sp,
                              F_oh, Bp)
    if packed:
        W = tfl.pack_route_table(W, pk)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = [0, 1, 2] + [-2] * (Sp - 3)
    tbl[:3, 1] = 3
    tbl[:3, 2] = [1, 0, 1]
    g = t(rng.randn(R).astype(np.float32))
    h = t(rng.rand(R).astype(np.float32))
    w = t((rng.rand(R) < 0.8).astype(np.float32))
    if quant_bits:
        gh, scales = tfl.pack_gh_quant(g * w, h * w, w, quant_bits, seed=5)
        nch = tq.QNCH[quant_bits]
    else:
        gh, scales, nch = tfl.pack_gh(g * w, h * w, w, 5), None, 5
    leaf = t(rng.randint(0, 3, R).astype(np.int32)[None, :])
    ops = (t(bins_T), leaf, gh, W, t(tbl))
    return ops, dict(num_bins=Bp, f_oh=F_oh, nch=nch, quant_bits=quant_bits,
                     packed=pk)


@pytest.mark.parametrize("quant_bits,packed,masked", [
    (8, False, False), (16, False, False), (0, True, False),
    (16, True, False), (0, False, True), (8, True, True)],
    ids=["quant8", "quant16", "packed-f32", "packed-quant16", "fmask-f32",
         "packed-quant8-fmask"])
def test_level_pass_cut_variants_match_plain(cuda_device, quant_bits,
                                             packed, masked):
    ops, kw = _plane_operands(5000, quant_bits, packed, seed=quant_bits)
    fm = None
    if masked:           # slot 1 splits on feature 1: its rows go right
        fm = torch.ones(kw["f_oh"], dtype=torch.bool)
        fm[[1, 6]] = False
    n0 = dict(tfl.variant_launches)
    hist_c, leaf_c = tfl.level_pass(
        *[a.to(cuda_device) for a in ops],
        None if fm is None else fm.to(cuda_device), **kw)
    torch.cuda.synchronize()
    hist_p, leaf_p = tfl.level_pass_plain(*ops, fm, **kw)
    ran = {k: tfl.variant_launches[k] - n0[k] for k in n0}
    variant = "level_pass:" + tfl.variant_name(quant_bits, packed, masked)
    assert ran == {k: int(k == variant) for k in n0}
    assert torch.equal(leaf_c.cpu(), leaf_p)
    assert hist_c.dtype == hist_p.dtype and hist_c.shape == hist_p.shape
    if quant_bits:                   # int32 sums: bit for bit
        assert torch.equal(hist_c.cpu(), hist_p)
    else:
        np.testing.assert_allclose(hist_c.cpu().numpy(), hist_p.numpy(),
                                   rtol=1e-5, atol=1e-5)
        w = slice((kw["nch"] - 1) * 8, kw["nch"] * 8)
        assert torch.equal(hist_c[:, w].cpu(), hist_p[:, w])
    if masked:
        keep = tfl.expand_feature_mask(fm, kw["f_oh"], kw["num_bins"],
                                       kw["packed"])
        assert not hist_c.cpu()[~keep].any()


def test_route_pass_packed_matches_plain(cuda_device):
    (bins, leaf, _, W, tbl), kw = _plane_operands(5000, 0, True, seed=3)
    kw = dict(num_bins=kw["num_bins"], f_oh=kw["f_oh"], packed=kw["packed"])
    out = tfl.route_pass(bins.to(cuda_device), leaf.to(cuda_device),
                         W.to(cuda_device), tbl.to(cuda_device), **kw)
    torch.cuda.synchronize()
    want = tfl.route_pass_plain(bins, leaf, W, tbl, **kw)
    assert torch.equal(out.cpu(), want) and (want != leaf).any()


def test_quant16_packed_equals_padded(cuda_device):
    """The packed layout re-indexes the padded one: its int32 planes,
    unpacked, are the padded kernel's, bit for bit, on every real feature
    (the padding feature, F_oh = 12 > 11, exists in the padded layout
    only)."""
    out = {}
    for packed in (False, True):
        ops, kw = _plane_operands(5000, 16, packed, seed=7)
        hist, leaf = tfl.level_pass(*[a.to(cuda_device) for a in ops],
                                    **kw)
        if packed:
            hist = tfl.unpack_packed_flat(hist, kw["packed"])
        out[packed] = (hist.cpu(), leaf.cpu())
    torch.cuda.synchronize()
    real = len(PLANE_NUM_BIN) * kw["num_bins"]
    assert torch.equal(out[True][0][:real], out[False][0][:real])
    assert out[False][0][:real].any() and not out[True][0][real:].any()
    assert torch.equal(out[True][1], out[False][1])


def test_cut_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    import dataclasses
    ops, kw = _plane_operands(1024, 8, True)
    bins, leaf, gh, W, tbl = [a.to(cuda_device) for a in ops]
    with pytest.raises(ValueError):        # int8 gh_T with quant_bits 0
        tfl.level_pass(bins, leaf, gh, W, tbl, **dict(kw, quant_bits=0))
    bad = dataclasses.replace(kw["packed"],
                              widths=kw["packed"].widths[:-1])
    with pytest.raises(ValueError):        # a slab table one row short
        tfl.level_pass(bins, leaf, gh, W, tbl, **dict(kw, packed=bad))
    with pytest.raises(ValueError):
        tfl.route_pass(bins, leaf, W, tbl, num_bins=kw["num_bins"],
                       f_oh=kw["f_oh"], packed=bad)


def test_cuda_cuts_training_matches_cpu(cuda_device):
    """train() with all three cuts on the card against the same on the
    CPU: the int32 histograms are exact, so the trees are equal."""
    rng = np.random.RandomState(3)
    X = rng.rand(5000, 8)
    X[:, :4] = np.floor(X[:, :4] * 8.0) / 8.0
    y = (X[:, 5] + 0.5 * X[:, 1] + 0.1 * rng.randn(5000) > 0.8) \
        .astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "tpu_quantized_grad": 16,
         "tpu_adaptive_bins": True, "tpu_gain_screening": True,
         "tpu_screening_warmup": 1, "tpu_screening_explore_period": 3}
    bc = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), 4)
    tfl.reset_launch_counts()
    bg = lt.train(dict(p, device_type="cuda"), lt.Dataset(X, label=y), 4)
    n = dict(tfl.variant_launches)
    assert n["level_pass:quant16+packed+fmask"] \
        == tfl.launches["level_pass"] > 0
    assert n["route_pass:packed"] == tfl.launches["route_pass"]
    assert bg._gbdt.fused_packed is not None
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------- level_pass stages (slot tiles)
# (R, Rp, num_bin, Bp, Sp, operand keywords): the dynamic shared-memory
# tile (Bp=256 int16, Sp=64: 143,360 B), a layout wide enough to need two
# feature groups (64 features of 256 bins), Sp=128 with nch=3, the root
# (one slot, every row), the mixed 8-bin rows at Sp=8 (hot cells), Rp not
# a multiple of any block's rows, and the cuts
STAGE_SHAPES = {
    "bp256-sp64": (40000, 40960, [255] * 28, 256, 64, {}),
    "two-groups": (20000, 20480, [255] * 64, 256, 8, {}),
    "sp128-nch3": (60000, 61440, [63] * 28, 64, 128, dict(nch=3)),
    "root": (50000, 51200, [63] * 28, 64, 1, {}),
    "root-quant16-packed-masked": (50000, 51200, [63] * 14 + [8] * 14, 64, 1,
                                   dict(quant_bits=16, packed=True,
                                        masked=True)),
    "mixed-sp8": (60000, 61440, [63] * 14 + [8] * 14, 64, 8, {}),
    "mixed-sp8-quant8": (60000, 61440, [63] * 14 + [8] * 14, 64, 8,
                         dict(quant_bits=8)),
    "ragged-rp": (12001, 12345, [63] * 28, 64, 16, dict(masked=True)),
    "quant16-packed-masked": (60000, 61440, [63] * 14 + [8] * 14, 64, 64,
                              dict(quant_bits=16, packed=True, masked=True)),
}


def _assert_hist_close(got, want, nch, Sp, quant):
    """int32 planes exact; f32 within 1e-5 of each plane's largest
    magnitude (atomics reorder the sums), the weight channel exact."""
    if quant:
        assert torch.equal(got, want)
        return
    for ch in range(nch):
        g, w = got[:, ch * Sp:(ch + 1) * Sp], want[:, ch * Sp:(ch + 1) * Sp]
        if ch == nch - 1:
            assert torch.equal(g, w), "weight channel"
        else:
            scale = float(w.abs().max()) or 1.0
            assert float((g - w).abs().max()) <= 1e-5 * scale, ch


@pytest.mark.parametrize("shape", list(STAGE_SHAPES))
def test_level_stages_match_plain(cuda_device, shape):
    R, Rp, num_bin, Bp, Sp, extra = STAGE_SHAPES[shape]
    ops, fm, kw = level_operands(R, Rp, num_bin, Bp, Sp, seed=Sp + Bp,
                                 device=cuda_device, **extra)
    nch, quant = kw["nch"], kw["quant_bits"]
    n0, c0 = dict(tfl.launches), dict(tfl.cuda_launches)
    # stage 1
    mark_k = tfl.level_mark(*ops, fm, **kw)
    mark_p = tfl.level_mark_plain(*ops, fm, **kw)
    for name, a, b in zip(("new_leaf", "row_slot", "counts"), mark_k,
                          mark_p):
        assert torch.equal(a, b), name
    new_leaf, row_slot, counts = mark_p
    n = int(counts.sum())
    assert n > 0
    # stage 2: each slot's bucket holds the same records (the order
    # inside a bucket is the kernel's own), compared sorted bytewise
    stage_k = tfl.level_partition(ops[0], ops[2], row_slot, counts, **kw)
    stage_p = tfl.level_partition_plain(ops[0], ops[2], row_slot, counts,
                                        **kw)
    rec_k, rec_p = stage_k[:n].cpu().numpy(), stage_p[:n].cpu().numpy()
    off = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    for k in range(Sp):
        a, b = rec_k[off[k]:off[k + 1]], rec_p[off[k]:off[k + 1]]
        assert np.array_equal(a[np.lexsort(a.T[::-1])],
                              b[np.lexsort(b.T[::-1])]), k
    # stage 3 on the kernel's records
    bb = dict(bin_bytes=ops[0].element_size())
    hist_k = tfl.level_hist(stage_k, counts, fm, **bb, **kw)
    hist_p = tfl.level_hist_plain(stage_k, counts, fm, **bb, **kw)
    _assert_hist_close(hist_k, hist_p, nch, Sp, quant)
    # the three stages in one wrapper call
    hist_l, leaf_l = tfl.level_pass(*ops, fm, **kw)
    hist_r, leaf_r = tfl.level_pass_plain(*ops, fm, **kw)
    torch.cuda.synchronize()
    assert torch.equal(leaf_l, leaf_r)
    _assert_hist_close(hist_l, hist_r, nch, Sp, quant)
    assert hist_r.abs().sum() > 0
    if fm is not None:
        keep = tfl.expand_feature_mask(fm, kw["f_oh"], Bp, kw["packed"])
        assert not hist_l[~keep].any()
    assert {k: tfl.launches[k] - n0[k] for k in n0}["level_pass"] == 1
    assert {k: tfl.cuda_launches[k] - c0[k] for k in c0
            if k.startswith("level_")} == {"level_slabs": 2,
                                           "level_mark": 2,
                                           "level_partition": 2,
                                           "level_hist": 2}


def test_level_hist_groups_on_the_card(cuda_device):
    """The wide layout really runs as two feature groups."""
    F_oh = 64
    budget = tfl._smem_budget(cuda_device)
    assert budget >= 200 * 1024          # the H100 opts into 227 KB
    assert tfl.hist_groups(F_oh, 256, 5, budget) == (32, 32)
    assert tfl.hist_groups(28, 256, 5, budget) == (28, 32)


def test_level_pass_refused_launch_raises(cuda_device, monkeypatch):
    """A histogram tile larger than the card lets a block have: the launch
    is refused and the wrapper raises; the plain versions are never run."""
    ops, fm, kw = level_operands(4000, 4096, [255] * 64, 256, 8, seed=1,
                                 device=cuda_device)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(tfl, "_smem_budget", lambda dev: 1 << 20)
    for name in ("level_pass_plain", "level_mark_plain",
                 "level_partition_plain", "level_hist_plain", "_hist_plain"):
        monkeypatch.setattr(tfl, name, plain)
    assert tfl.hist_groups(64, 256, 5, 1 << 20) == (64, 32)   # 327,680 B
    c0 = dict(tfl.cuda_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfl.level_pass(*ops, fm, **kw)
    # the C entry reports the kernels launched before the refusal
    assert {k: tfl.cuda_launches[k] - c0[k] for k in tfl.LEVEL_KERNELS} \
        == {"level_slabs": 1, "level_mark": 1, "level_partition": 1,
            "level_hist": 0}
    monkeypatch.undo()
    torch.cuda.synchronize()            # the context is still sound
    hist, leaf = tfl.level_pass(*ops, fm, **kw)
    hist_p, leaf_p = tfl.level_pass_plain(*ops, fm, **kw)
    assert torch.equal(leaf, leaf_p)
    _assert_hist_close(hist, hist_p, kw["nch"], 8, False)


@pytest.mark.parametrize("R,L,offset", [(1_001_472, 255, 0), (1001, 255, 1),
                                        (4099, 5000, 0), (3, 255, 0)])
def test_table_lookup_matches_plain(cuda_device, R, L, offset):
    """Four rows per thread on aligned pointers, a scalar tail, an
    unaligned index view (all scalar), and a table too large to stage."""
    rng = np.random.RandomState(R)
    idx = rng.randint(-1, L + 2, R + offset).astype(np.int32)
    idx_T = torch.as_tensor(idx[None, :], device=cuda_device)[:, offset:]
    table = torch.as_tensor(rng.randn(L).astype(np.float32),
                            device=cuda_device)
    out = tfl.table_lookup(idx_T, table)
    assert torch.equal(out, tfl.table_lookup_plain(idx_T, table))


def test_level_mark_routes_any_route_table(cuda_device):
    """The mark kernel reads one slab per slot where the slot's W row is
    non-zero on one kernel row only (as the grower builds it); a row that
    spans two slabs takes the full sum, an all-zero row sends every row
    right. Both against the plain version's full sum."""
    ops, fm, kw = level_operands(30000, 30720, [63] * 28, 64, 8, seed=4,
                                 device=cuda_device)
    bins_T, leaf_T, gh_T, W, tbl = ops
    W = W.clone()
    j0 = int(W[0].view(-1, 64).float().sum(1).nonzero()[0])
    j2 = (j0 + 5) % 28
    W[0, j2 * 64:j2 * 64 + 20] = 1           # slot 0: two slabs
    W[2] = 0                                 # slot 2: none
    ops = (bins_T, leaf_T, gh_T, W, tbl)
    for a, b in zip(tfl.level_mark(*ops, fm, **kw),
                    tfl.level_mark_plain(*ops, fm, **kw)):
        assert torch.equal(a, b)
    hist, leaf = tfl.level_pass(*ops, fm, **kw)
    hist_p, leaf_p = tfl.level_pass_plain(*ops, fm, **kw)
    assert torch.equal(leaf, leaf_p)
    _assert_hist_close(hist, hist_p, kw["nch"], 8, False)
    moved = leaf_p != leaf_T
    assert bool(moved[leaf_T == 0].any()) and bool((~moved)[leaf_T == 0]
                                                   .any())
    assert bool(moved[leaf_T == 2].all())


@pytest.mark.parametrize("packed,odd,Rp,offset", [
    (False, False, 30720, 0), (False, True, 30003, 0),
    (True, False, 30001, 1), (True, True, 30720, 0)])
def test_route_pass_routes_any_route_table(cuda_device, packed, odd, Rp,
                                           offset):
    """route_pass reads one slab per slot through its slab table: the
    grower's W, a W row over two slabs and an all-zero one route as the
    plain version's full sum; Rp not a multiple of 4 and a leaf view off
    16-byte alignment take the scalar path. Two CUDA kernels per call."""
    ops, _, kw = level_operands(Rp - 7, Rp, [63] * 14 + [8] * 14, 64, 8,
                                packed=packed, seed=Rp + odd,
                                device=cuda_device)
    bins_T, leaf_T, _, W, tbl = ops
    if odd:
        W = odd_route_table(W, kernel_slabs(kw), Rp)
    if offset:
        store = torch.empty(Rp + offset, dtype=torch.int32,
                            device=cuda_device)
        leaf_T = store[offset:].view(1, Rp)
        leaf_T.copy_(ops[1])
    rkw = dict(num_bins=64, f_oh=kw["f_oh"], packed=kw["packed"])
    n0, c0 = dict(tfl.launches), dict(tfl.cuda_launches)
    got = tfl.route_pass(bins_T, leaf_T, W, tbl, **rkw)
    want = tfl.route_pass_plain(bins_T, leaf_T, W, tbl, **rkw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want != leaf_T).any())
    assert tfl.launches["route_pass"] - n0["route_pass"] == 1
    assert {k: tfl.cuda_launches[k] - c0[k] for k in tfl.ROUTE_KERNELS} \
        == {"route_slabs": 1, "route_pass": 1}
    slab_of = tfl.slab_table_plain(W, **rkw)
    if odd:
        assert slab_of[0] == tfl.SLAB_MANY and slab_of[2] == tfl.SLAB_NONE


def _epilogue_card_operands(R, Rp, B, nch, kind, table, seed, dev):
    """level_operands' rows and route (Sp = 8) with a 255-entry leaf-value
    table (routed leaves past it add 0), scores, the kind's operand rows
    and ~30% zero bag weights; ``table`` grower, odd (two slabs and an
    all-zero row) or inactive (every slot -2, W zero)."""
    (bins_T, leaf_T, _, W, tbl), _, kw = level_operands(
        R, Rp, [B - 1] * 28, B, 8, nch=nch, seed=seed, device=dev)
    if table == "odd":
        W = odd_route_table(W, kernel_slabs(kw), seed)
    elif table == "inactive":
        W = torch.zeros_like(W)
        tbl = tbl.clone()
        tbl[:, 0] = -2
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    score = np.zeros((1, Rp), np.float32)
    score[0, :R] = rng.randn(R)
    ops = np.zeros((8, Rp), np.float32)
    ops[0, :R] = (np.where(rng.rand(R) < 0.4, 1.0, -1.0)
                  if kind == "binary" else rng.randn(R) * 3.0)
    ops[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, Rp), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    lv = t((rng.randn(255) * 0.1).astype(np.float32))
    args = (bins_T, leaf_T, W, tbl, lv, t(score), t(ops), t(bag))
    return args, dict(num_bins=B, f_oh=kw["f_oh"], nch=nch, kind=kind)


def _assert_epilogue_close(got, want, bins_T, B, f_oh, nch):
    """chip_smoke.py's tolerances: new_score rtol 1e-6; decoded channels
    rtol 4e-5, atol 1e-7 (the card's expf against torch's exp); rows >= nch
    zero; g/h planes within 1e-5 of the plane's largest per-cell sum of
    |channel|, the weight channel exact, slots 1-7 zero."""
    (hist_k, score_k, gh_k), (hist_p, score_p, gh_p) = got, want
    assert torch.allclose(score_k, score_p, rtol=1e-6, atol=0)

    def decoded(gh):
        x = gh.float()
        if nch == tfl.NCH_PRECISE:
            return torch.stack([x[0] + x[1], x[2] + x[3], x[4]])
        return x[:3]
    assert torch.allclose(decoded(gh_k), decoded(gh_p), rtol=4e-5, atol=1e-7)
    assert not gh_k[nch:].any()
    live = torch.zeros(nch * 8, dtype=torch.bool, device=hist_k.device)
    live[::8] = True
    assert not hist_k[:, ~live].any()
    abs_sum = tfl.root_hist_plain(bins_T, gh_p.float().abs().to(
        torch.bfloat16), num_bins=B, f_oh=f_oh, nch=nch)
    for c in range(nch - 1):
        err = float((hist_k[:, 8 * c] - hist_p[:, 8 * c]).abs().max())
        assert err <= 1e-5 * float(abs_sum[:, 8 * c].max()), c
    assert torch.equal(hist_k[:, 8 * (nch - 1)], hist_p[:, 8 * (nch - 1)])


@pytest.mark.parametrize("B,nch,kind,table,R,Rp", [
    (64, 5, "binary", "grower", 30000, 30720),
    (64, 3, "l2", "odd", 29990, 30003),
    (16, 5, "l2", "odd", 4000, 4099),
    (256, 5, "l2", "odd", 12000, 12345),
    (256, 3, "binary", "grower", 20000, 20480),
    (64, 5, "binary", "inactive", 5000, 5120)])
def test_epilogue_pass_any_route_table(cuda_device, B, nch, kind, table, R,
                                       Rp):
    """The epilogue's kernels against the plain version on the grower's W,
    a W with a row over two slabs and an all-zero row, and an inactive
    table; Rp not a multiple of the 256-row chunk or of 8 (the staging's
    plain-load path); Bp 16, 64 and 256 (int16, channel groups on
    grid.z). Four CUDA kernels per call, and the fixed-order reduce gives
    the same histogram bits every call."""
    args, kw = _epilogue_card_operands(R, Rp, B, nch, kind, table,
                                       seed=B + nch + Rp, dev=cuda_device)
    n0, c0 = dict(tfl.launches), dict(tfl.cuda_launches)
    got = tfl.epilogue_pass(*args, **kw)
    want = tfl.epilogue_pass_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tfl.launches["epilogue_pass"] - n0["epilogue_pass"] == 1
    assert {k: tfl.cuda_launches[k] - c0[k] for k in tfl.EPILOGUE_KERNELS} \
        == dict.fromkeys(tfl.EPILOGUE_KERNELS, 1)
    _assert_epilogue_close(got, want, args[0], B, kw["f_oh"], nch)
    again = tfl.epilogue_pass(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if table != "grower":
        moved = tfl.route_pass_plain(*args[:4], num_bins=B, f_oh=kw["f_oh"])
        if table == "inactive":
            assert torch.equal(moved, args[1])
        else:
            rows = args[1][0] == 2
            assert torch.equal(moved[0, rows],
                               args[1][0, rows] + args[3][2, 1])


def test_epilogue_pass_refused_launch_raises(cuda_device, monkeypatch):
    """Histogram tiles sized for more shared memory than the card lets a
    block have: the hist kernel's launch is refused and the wrapper raises
    before it launches anything; the plain versions are never run, and the
    card is sound afterwards."""
    args, kw = _epilogue_card_operands(3000, 3072, 64, 5, "binary", "grower",
                                       seed=1, dev=cuda_device)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    sms = tfl._device_limits(cuda_device)[0]
    monkeypatch.setattr(tfl, "_device_limits", lambda dev: (sms, 1 << 20))
    for name in ("epilogue_pass_plain", "route_pass_plain",
                 "root_hist_plain", "epilogue_rows_plain"):
        monkeypatch.setattr(tfl, name, plain)
    c0 = dict(tfl.cuda_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfl.epilogue_pass(*args, **kw)
    assert all(tfl.cuda_launches[k] == c0[k] for k in tfl.EPILOGUE_KERNELS)
    monkeypatch.undo()
    torch.cuda.synchronize()
    got = tfl.epilogue_pass(*args, **kw)
    _assert_epilogue_close(got, tfl.epilogue_pass_plain(*args, **kw),
                           args[0], 64, kw["f_oh"], 5)
