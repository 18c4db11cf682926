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
from torch_parity import (cat_route_table, kernel_slabs, level_operands,
                          odd_route_table, random_stack)

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


def _hist_operands(R, F, B, S, quant_bits, seed, slots="random", nch=3):
    """[R, Fp] int32 bins, gh as f32 (g, h, w and nch - 3 more random
    channels) or the int8 channels of ``quant_bits``, and the slots:
    ``random`` in [0, S) with ~30% of rows
    at -1 (their gh non-zero); ``root`` every row in slot 0 (the root
    level); ``none`` every row at -1; ``odd`` random, with ~2% of the bins
    outside [0, Bp), ~10% of the rows' channels all zero and ~2% of the
    slots past Sp."""
    rng = np.random.RandomState(seed)
    Fp, Bp = tph.pad_feature_layout(F, B)
    bins = np.zeros((R, Fp), np.int32)
    bins[:, :F] = rng.randint(0, B, (R, F))
    slot = rng.randint(0, S, R).astype(np.int32)
    slot[rng.rand(R) < 0.3] = -1
    if slots == "root":
        slot[:] = 0
    elif slots == "none":
        slot[:] = -1
    gh = np.stack([rng.randn(R), rng.rand(R), np.ones(R)]
                  + [rng.randn(R) for _ in range(nch - 3)], 1)
    if slots == "odd":
        odd = rng.rand(R, Fp) < 0.02
        bins[odd] = rng.choice([-1, Bp, Bp + 5, 1 << 20], odd.sum())
        gh[rng.rand(R) < 0.1] = 0.0
        slot[rng.rand(R) < 0.02] = 1 << 16
    t = torch.as_tensor
    gh = t(gh.astype(np.float32))
    if quant_bits:
        g, h = gh[:, 0], gh[:, 1]
        scales = tq.quant_scales(g, h, quant_bits)
        gh = torch.stack(tq.encode_channels(
            *tq.quantize_gh(g, h, scales, quant_bits, seed), gh[:, 2],
            quant_bits), 1).contiguous()
    return t(bins), gh, t(slot), Bp


@pytest.mark.parametrize("R,F,B,S,bits,slots", [
    (5000, 28, 64, 64, 0, "random"),    # the deep levels' shape
    (3001, 28, 64, 8, 0, "random"),
    (5000, 28, 64, 64, 8, "random"),
    (4099, 28, 64, 13, 16, "random"),
    # Bp=256, nch=5: a block takes 3 (then 2) of the channels; every add
    # stays in shared memory
    (5000, 28, 256, 64, 16, "random"),
    (5000, 5, 256, 64, 0, "random"),
    (6000, 28, 64, 8, 0, "root"),       # the root level: one slot
    (6000, 28, 64, 8, 16, "root"),
    (2500, 28, 64, 64, 0, "none"),      # no row slotted
    (0, 28, 64, 8, 0, "random"),        # no row
    (3000, 70, 64, 16, 0, "odd"),       # three feature groups of 32
    (3000, 70, 64, 16, 8, "odd"),
    (3000, 6, 1024, 8, 0, "random"),    # MAX_CARD_BINS: one bin group
    (3000, 6, 2048, 8, 16, "random"),   # two bin groups
    (1500, 7, 16, 1100, 0, "random"),   # three windows of slots
    (4000, 28, 64, 64, 0, "random5"),   # f32, 5 channels: 32-byte records
])
def test_hist_pass_matches_plain(cuda_device, R, F, B, S, bits, slots):
    nch = 5 if slots == "random5" else 3
    bins, gh, slot, Bp = _hist_operands(R, F, B, S, bits, seed=R + B + S,
                                        slots=slots.rstrip("5"), nch=nch)
    quant = bool(bits)
    nch = gh.shape[1]
    kw = dict(S=S, Bp=Bp, nch=nch, quant=quant)
    windows = -(-max(S, 8) // tph.HIST_WINDOW)
    n0 = tfl.launches["hist_pass"]
    c0 = {k: tfl.cuda_launches[k] for k in tfl.HIST_KERNELS}
    args = (bins.to(cuda_device), gh.to(cuda_device), slot.to(cuda_device))
    out_c = tph.hist_pass(*args, **kw)
    torch.cuda.synchronize()
    assert tfl.launches["hist_pass"] - n0 == 1
    assert {k: tfl.cuda_launches[k] - c0[k] for k in tfl.HIST_KERNELS} \
        == dict.fromkeys(tfl.HIST_KERNELS, windows)
    # the same bits on a second call: a fixed summation order
    assert torch.equal(tph.hist_pass(*args, **kw), out_c)
    out_p = tph.hist_pass_plain(bins, gh, slot, **kw)
    assert out_c.shape == out_p.shape and out_c.dtype == out_p.dtype
    if quant:       # integer sums: exact
        assert torch.equal(out_c.cpu(), out_p)
        return
    # the f32 sums in another order; the weight channel counts rows exactly
    for c in range(2):
        np.testing.assert_allclose(
            out_c[c].cpu().numpy(), out_p[c].numpy(), rtol=1e-5,
            atol=1e-5 * float(out_p[c].abs().max()))
    assert torch.equal(out_c[2].cpu(), out_p[2])
    if slots != "odd":      # unslotted rows added nothing
        assert float(out_p[2].sum()) == (slot >= 0).sum().item() * \
            bins.shape[1]
    for c in range(3, nch):
        np.testing.assert_allclose(
            out_c[c].cpu().numpy(), out_p[c].numpy(), rtol=1e-5,
            atol=1e-5 * float(out_p[c].abs().max()))


@pytest.mark.parametrize("bits", [0, 16])
def test_hist_buckets_match_the_plain_order(cuda_device, bits):
    """The card's slot buckets list each slot's live rows in row order,
    as hist_bucket_plain does, and its offsets are the plain ones."""
    S = 13
    bins, gh, slot, Bp = _hist_operands(20000, 28, 64, S, bits, seed=4,
                                        slots="odd")
    args = [a.to(cuda_device) for a in (bins, gh, slot)]
    kw = dict(Bp=Bp, nch=gh.shape[1], quant=bool(bits))
    buf = tph.hist_buffers(args[0], S=S, **kw)
    tph._hist_launch(tfl.HIST_KERNELS[:3], *args, buf, **kw)
    off_p, brow_p = tph.hist_bucket_plain(gh, slot, S=S, quant=bool(bits))
    torch.cuda.synchronize()
    assert torch.equal(buf["slot_off"].cpu(), off_p)
    assert torch.equal(tph.bucket_rows(buf, brow_p.numel()).cpu(), brow_p)


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
    magnitude (the kernel sums in f32 in its own order, the plain version
    in float64), the weight channel exact."""
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
    n = int(counts[-1])
    assert n > 0
    # stage 2: each slot's bucket holds the same records in the same
    # order (row order: the kernel's order is fixed)
    stage_k = tfl.level_partition(ops[0], ops[2], row_slot, counts, **kw)
    stage_p = tfl.level_partition_plain(ops[0], ops[2], row_slot, counts,
                                        **kw)
    assert torch.equal(stage_k[:n], stage_p[:n])
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
            if k.startswith("level_")} == dict.fromkeys(tfl.LEVEL_KERNELS, 2)
    # the same bits on a second call (no atomic orders an f32 sum)
    hist_2, _ = tfl.level_pass(*ops, fm, **kw)
    assert torch.equal(hist_2, hist_l)


def test_level_hist_groups_on_the_card(cuda_device):
    """The wide layout really runs as two kernel-row groups, and Bp=256
    as four bin groups of 64, each with 25 warps' tiles."""
    F_oh = 64
    budget = tfl._smem_budget(cuda_device)
    assert budget >= 200 * 1024          # the H100 opts into 227 KB
    assert tfl.level_tile_shape(F_oh, 256, 5, budget) == (32, 64, 5)
    assert tfl.level_tile_shape(28, 256, 5, budget) == (28, 64, 5)


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
    Cw, Bw, nr = tfl.level_tile_shape(64, 256, 5, 1 << 20)
    assert 5 * nr * Bw * 32 * 4 > 232448     # more than the H100's 227 KB
    c0 = dict(tfl.cuda_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfl.level_pass(*ops, fm, **kw)
    # the C entry reports the kernels launched before the refusal
    assert {k: tfl.cuda_launches[k] - c0[k] for k in tfl.LEVEL_KERNELS} \
        == {"level_slabs": 1, "level_mark": 1, "level_scan": 1,
            "level_partition": 1, "level_tiles": 0, "level_reduce": 0}
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
    elif table == "categorical":
        W = cat_route_table(W, kernel_slabs(kw), tbl, seed)
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
    (64, 5, "binary", "inactive", 5000, 5120),
    (64, 5, "binary", "categorical", 30000, 30720),
    (256, 3, "l2", "categorical", 12000, 12345)])
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
    if table not in ("grower", "categorical"):
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


# ------------------------------------------------ valid sets and metrics
def _valid_fixture():
    """Binary rows, a valid set from the same labelling function and the
    same valid rows with their labels permuted (nothing to learn)."""
    rng = np.random.RandomState(4)
    X = rng.randn(6000, 8)
    X[rng.rand(6000) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) + 0.3 * rng.randn(6000)
         > 0).astype(float)
    return X[:4000], y[:4000], X[4000:], y[4000:], \
        np.random.RandomState(5).permutation(y[4000:])


def test_add_tree_score_on_cuda_matches_cpu(cuda_device):
    """One valid-score update of a grown tree, routed on the card and on
    the CPU: the same leaves, so the same f32 sums."""
    from lightgbm_tpu_torch.ops.predict import add_tree_score
    X, y, Xv, yv, _ = _valid_fixture()
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "device_type": "cpu"}
    ds = lt.Dataset(X, label=y)
    bst = lt.train(p, ds, 2)
    dv = lt.Dataset(Xv, label=yv, reference=ds).construct()
    g = bst._gbdt
    ht = bst.models[-1]
    ni = ht.num_internal
    inner = [ds._inner.used_features.index(int(f))
             for f in ht.split_feature[:ni]]
    args = [np.asarray(ht.leaf_value, np.float32), np.asarray(inner),
            ht.threshold_bin[:ni], (ht.decision_type[:ni] & 2) != 0,
            ht.left_child[:ni], ht.right_child[:ni],
            g.fused_meta.num_bin, g.fused_meta.missing_type,
            g.fused_meta.default_bin]
    score = np.random.RandomState(0).randn(len(yv)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        t = [torch.as_tensor(np.asarray(a), device=dev) for a in args]
        out[str(dev)] = add_tree_score(
            torch.as_tensor(score, device=dev),
            dv._inner.bins_dev.to(dev), t[0], *t[1:], 12).cpu()
    assert torch.equal(out["cpu"], out[str(cuda_device)])


@pytest.mark.parametrize("name,objective", [
    ("binary_logloss", "binary"), ("binary_error", "binary"),
    ("auc", "binary"), ("l2", "regression"), ("rmse", "regression"),
    ("l1", "regression"), ("huber", "regression"), ("quantile", "regression"),
    ("mape", "regression")])
def test_eval_device_on_cuda_matches_host(cuda_device, name, objective):
    """Each metric's device form on the card (f32 sums) against its host
    form (float64) on the same 250,000 rows, with and without weights."""
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.metric import create_metric
    from lightgbm_tpu_torch.objective import create_objective
    n = 250_000
    rng = np.random.RandomState(len(name))
    score = rng.randn(1, n)
    label = ((score[0] + rng.randn(n) > 0).astype(np.float64)
             if objective == "binary" else rng.uniform(0.1, 3.0, n))
    for w in (None, rng.uniform(0.5, 2.0, n)):
        md = Metadata(n)
        md.set_label(label)
        md.set_weight(w)
        cfg = lt.Config({"objective": objective})
        obj = create_objective(cfg)
        obj.init(md, n, cuda_device)
        m = create_metric(name, cfg)
        m.init(md, n)
        got = m.eval_device(torch.as_tensor(score.astype(np.float32),
                                            device=cuda_device), obj, {})
        assert got[0].device.type == "cuda"
        np.testing.assert_allclose([float(v) for v in got],
                                   m.eval(score, obj), rtol=1e-5)


def test_cuda_early_stopping_matches_cpu(cuda_device):
    """train() with a valid set and a label-permuted one, early_stopping(3):
    the same best iteration, tree count and curves on the card as on the
    CPU, and the card's valid scores equal predict."""
    X, y, Xv, yv, yp = _valid_fixture()
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "metric": ["binary_logloss", "auc"]}
    runs = {}
    for dev in ("cpu", "cuda"):
        ds = lt.Dataset(X, label=y)
        valid = [lt.Dataset(Xv, label=yv, reference=ds),
                 lt.Dataset(Xv, label=yp, reference=ds)]
        ev = {}
        bst = lt.train(dict(p, device_type=dev), ds, 40, valid_sets=valid,
                       callbacks=[lt.early_stopping(3, verbose=False),
                                  lt.record_evaluation(ev)])
        runs[dev] = (bst, ev)
    (bc, ec), (bg, eg) = runs["cpu"], runs["cuda"]
    assert 0 < bg.best_iteration == bc.best_iteration < 37
    assert bg.num_trees() == bc.num_trees() == bg.best_iteration + 3
    for name in ec:
        for m in ec[name]:
            np.testing.assert_allclose(eg[name][m], ec[name][m], rtol=1e-4)
    np.testing.assert_allclose(bg.valid_scores(0).cpu().numpy(),
                               bg.predict(Xv, raw_score=True,
                                          num_iteration=-1),
                               rtol=1e-5, atol=1e-5)


def _class_fixture(n=6000, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.05, 2] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) - 0.4 * X[:, 5] \
        + 0.3 * rng.randn(n)
    return X, z


def _train_both(p, X, y, rounds):
    out = {}
    for dev in ("cpu", "cuda"):
        tfl.reset_launch_counts()
        bst = lt.train(dict(p, device_type=dev), lt.Dataset(X, label=y),
                       rounds)
        out[dev] = (bst, dict(tfl.launches))
    return out


def _assert_same_structure(bc, bg):
    assert bc.num_trees() == bg.num_trees()
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)


def test_cuda_multiclass_megastep_matches_cpu(cuda_device):
    """The k-class megastep body (3 classes) on the card against the CPU:
    the same trees, [n, 3] predictions within rtol 1e-5, and per tree one
    route_pass and one table_lookup launched on the card."""
    X, z = _class_fixture()
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 31,
         "max_bin": 63, "verbose": -1}
    out = _train_both(p, X, y, 4)
    (bc, _), (bg, n) = out["cpu"], out["cuda"]
    assert bg.num_trees() == 12 and bg._gbdt._fast_path_reason() is None
    assert n["route_pass"] == n["table_lookup"] == 12
    assert n["level_pass"] > 12 and n["epilogue_pass"] == 0
    _assert_same_structure(bc, bg)
    got = bg.predict(X)
    assert got.shape == (6000, 3)
    np.testing.assert_allclose(got, bc.predict(X), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("params,label", [
    ({"objective": "binary", "boosting": "goss", "learning_rate": 0.5},
     "binary"),
    ({"objective": "binary", "feature_fraction_bynode": 0.5,
      "interaction_constraints": [[0, 1, 2, 3], [4, 5, 6, 7]]}, "binary"),
    ({"objective": "regression_l1"}, "regression"),
], ids=["goss", "node-masks", "l1-renewal"])
def test_cuda_sync_body_matches_cpu(cuda_device, params, label):
    """The synchronous body on the card (GOSS sampling from iteration 2,
    node masks, L1 leaf renewal) against the CPU: the same trees and
    predictions, and per tree one route_pass and one table_lookup."""
    X, z = _class_fixture()
    y = (z > 0).astype(float) if label == "binary" else z
    p = dict(params, num_leaves=31, max_bin=63, verbose=-1)
    out = _train_both(p, X, y, 4)
    (bc, _), (bg, n) = out["cpu"], out["cuda"]
    assert bg._gbdt._fast_path_reason() is not None
    assert n["route_pass"] == n["table_lookup"] == bg.num_trees() == 4
    _assert_same_structure(bc, bg)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------- categorical route tables
@pytest.mark.parametrize("B,packed,nch", [(64, False, 5), (256, False, 3),
                                          (64, True, 5)])
def test_level_and_route_pass_categorical_route_table(cuda_device, B, packed,
                                                      nch):
    """level_pass and route_pass on a categorical route table (every
    active row a bin set with holes inside its slab, bin 0 out) against
    their plain versions: new leaves equal (route_pass_plain is the full
    W @ one-hot sum), the histogram as test_kernels_match_plain holds it."""
    nb = [B - 1] * 14 + [8] * 14 if packed else [B - 1] * 28
    ops, fm, kw = level_operands(30000, 30720, nb, B, 8, nch=nch,
                                 packed=packed, seed=B + nch,
                                 device=cuda_device)
    bins_T, leaf_T, gh_T, W, tbl = ops
    W = cat_route_table(W, kernel_slabs(kw), tbl, seed=B)
    ops = (bins_T, leaf_T, gh_T, W, tbl)
    hist, leaf = tfl.level_pass(*ops, fm, **kw)
    hist_p, leaf_p = tfl.level_pass_plain(*ops, fm, **kw)
    rkw = dict(num_bins=B, f_oh=kw["f_oh"], packed=kw["packed"])
    route = tfl.route_pass(bins_T, leaf_T, W, tbl, **rkw)
    torch.cuda.synchronize()
    assert torch.equal(leaf, leaf_p)
    assert torch.equal(route, tfl.route_pass_plain(bins_T, leaf_T, W, tbl,
                                                   **rkw))
    assert torch.equal(route, leaf_p)
    assert bool((leaf_p != leaf_T).any())
    _assert_hist_close(hist, hist_p, nch, 8, False)


# ------------------------------------------------ ranking, categorical
def _rank_fixture(Q=300, seed=2):
    """Queries of 1-240 documents (one of exactly 240: the chip run's
    widest), grades 0-4."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 241, Q)
    sizes[0] = 240
    n = int(sizes.sum())
    X = rng.randn(n, 8)
    z = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    y = np.digitize(z, np.quantile(z, [0.52, 0.84, 0.97, 0.99]))
    return X, y.astype(np.float32), sizes


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_rank_gradients_on_cuda_match_cpu(cuda_device, objective):
    """The ranking gradients on the card against the CPU's at D = 240,
    within rtol 1e-5, atol 1e-6 (the card's expf and its reduction order;
    each lambda sums up to 30 x 240 pair terms)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    _, y, sizes = _rank_fixture()
    md = Metadata(len(y))
    md.set_label(y)
    md.set_group(sizes)
    rng = np.random.RandomState(1)
    scores = [np.zeros(len(y), np.float32),
              rng.randn(len(y)).astype(np.float32)]
    out = {}
    for dev in ("cpu", "cuda"):
        obj = create_objective(Config({"objective": objective}))
        obj.init(md, len(y), torch.device(dev))
        assert obj._labels.shape[1] == 240
        out[dev] = [obj.get_gradients(torch.as_tensor(s[None], device=dev))
                    for s in scores]
    for (gc, hc), (gg, hg) in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(gg.cpu().numpy(), gc.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cuda_rank_training_matches_cpu(cuda_device):
    """lambdarank on the megastep body with an ndcg valid set: the same
    trees on the card as on the CPU, predictions within rtol 1e-5, the
    device ndcg within 1e-6 of the CPU's."""
    X, y, sizes = _rank_fixture()
    p = {"objective": "lambdarank", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "metric": "ndcg", "eval_at": [10]}
    out = {}
    for dev in ("cpu", "cuda"):
        tfl.reset_launch_counts()
        ds = lt.Dataset(X, label=y, group=sizes)
        ev = {}
        bst = lt.train(dict(p, device_type=dev), ds, 4, valid_sets=[ds],
                       callbacks=[lt.record_evaluation(ev)])
        out[dev] = (bst, dict(tfl.launches), ev)
    (bc, _, ec), (bg, n, eg) = out["cpu"], out["cuda"]
    assert n["route_pass"] == n["table_lookup"] == 4
    _assert_same_structure(bc, bg)
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(eg["training"]["ndcg@10"],
                               ec["training"]["ndcg@10"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("megastep", [True, False],
                         ids=["train", "update"])
def test_cuda_categorical_training_matches_cpu(cuda_device, megastep):
    """Categorical splits through train() (megastep body) and the update()
    loop (epilogue body) on the card: the same trees and category bitsets
    as on the CPU, predictions within rtol 1e-5."""
    rng = np.random.RandomState(6)
    n = 6000
    X = rng.randn(n, 6)
    X[:, 0] = rng.randint(0, 12, n)
    X[:, 3] = rng.randint(0, 40, n)
    y = (np.isin(X[:, 0], [1, 4, 7]) + 0.5 * np.isin(X[:, 3], [3, 9, 27])
         + 0.3 * X[:, 1] + 0.2 * rng.randn(n) > 0.6).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "min_data_per_group": 20, "cat_smooth": 1.0}
    out = {}
    for dev in ("cpu", "cuda"):
        tfl.reset_launch_counts()
        ds = lt.Dataset(X, label=y, categorical_feature=[0, 3])
        if megastep:
            bst = lt.train(dict(p, device_type=dev), ds, 4)
        else:
            bst = lt.Booster(dict(p, device_type=dev), ds)
            for _ in range(4):
                bst.update()
        out[dev] = (bst, dict(tfl.launches))
    (bc, _), (bg, n_l) = out["cpu"], out["cuda"]
    if megastep:
        assert n_l["route_pass"] == n_l["table_lookup"] == 4
    else:
        assert n_l["epilogue_pass"] == 4
    assert all((m.decision_type & 1).any() for m in bg.models)
    _assert_same_structure(bc, bg)
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.decision_type, b.decision_type)
        assert a.cat_threshold == b.cat_threshold
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_cuda_training_gives_the_same_model_twice(cuda_device):
    """level_pass adds no f32 in a varying order (no atomic), so two
    train() calls on one seed give the same model text: chip_smoke's
    phase 3 configuration (bench.py's Higgs-shaped draw with seed 1,
    max_bin 63, 255 leaves), cut to 250,000 rows and 5 rounds."""
    rng = np.random.RandomState(1)
    X = rng.rand(250_000, 28).astype(np.float32)
    w = rng.randn(28).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(250_000) > 0).astype(np.float32)
    p = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
         "learning_rate": 0.1, "min_data_in_leaf": 1,
         "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
         "device_type": "cuda"}
    texts = [lt.train(p, lt.Dataset(X, label=y), 5).model_to_string()
             for _ in range(2)]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("Bc_p", [256, 4096])
def test_bundled_kernels_match_plain(cuda_device, Bc_p):
    """level_pass, route_pass and epilogue_pass on bundle columns of Bc_p
    bins (int16) and a bundled route table with a categorical member, as
    the plain versions give them: new leaves equal, f32 planes within 1e-5
    of each plane's largest magnitude with the weight channel exact, the
    epilogue's scores and root histogram likewise."""
    from lightgbm_tpu_torch.ops import efb
    rng = np.random.RandomState(Bc_p)
    if Bc_p == 256:
        nb = np.array([63] * 4 + [40] * 18, np.int32)
        bundles = [[f] for f in range(4)] + [list(range(4 + 6 * i,
                                                        10 + 6 * i))
                                             for i in range(3)]
    else:
        nb = np.full(64, 63, np.int32)
        bundles = [list(range(64))]
    layout = efb.BundleLayout(bundles, nb)
    C_oh, Bcp = feature_layout(layout.num_columns, max(layout.col_num_bin))
    assert Bcp == Bc_p
    R, Rp = 50_000, 51_200
    F = len(nb)
    bins = np.zeros((max(C_oh, 8), Rp), np.int64)
    for ci, members in enumerate(bundles):
        owner = rng.randint(-1 if len(members) > 1 else 0, len(members), R)
        o = np.maximum(owner, 0)
        b = 1 + (rng.rand(R) * (nb[members][o] - 1)).astype(np.int64)
        bins[ci, :R] = np.where(owner >= 0, layout.offset_of_feat[members][o]
                                + b, 0)
    Sp = 8
    feat = rng.randint(0, F, Sp).astype(np.int32)
    feat[-1] = -1
    mt = np.zeros(F, np.int32)
    mt[F - 1] = 2
    t = lambda a: torch.as_tensor(np.asarray(a), device=cuda_device)  # noqa
    cat_flag = np.zeros(Sp, bool)
    cat_flag[0] = True
    cat_mask = rng.rand(Sp, 64) < 0.4
    W = tfl.build_route_table_bundled(
        t(feat), t((rng.rand(Sp) * (nb[feat] - 1)).astype(np.int32)),
        t(rng.rand(Sp) < 0.5), t(nb), t(mt), t(np.zeros(F, np.int32)),
        t(np.zeros(F, np.int32)), t(layout.col_of_feat),
        t(layout.offset_of_feat), C_oh, Bc_p, cat_flag=t(cat_flag),
        cat_mask=t(cat_mask))
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = np.where(feat >= 0, np.arange(Sp), -2)
    tbl[:, 1] = np.where(feat >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    leaf = np.full((1, Rp), -1, np.int32)
    leaf[0, :R] = rng.randint(0, Sp - 1, R)
    g = np.zeros(Rp, np.float32)
    h = np.zeros(Rp, np.float32)
    wt = np.zeros(Rp, np.float32)
    g[:R], h[:R], wt[:R] = rng.randn(R), rng.rand(R), 1.0
    gh = tfl.pack_gh(t(g), t(h), t(wt), 5)
    ops = (t(bins).to(torch.int16), t(leaf), gh, W, t(tbl))
    kw = dict(num_bins=Bc_p, f_oh=C_oh, nch=5)
    hist, new_leaf = tfl.level_pass(*ops, **kw)
    hist_p, leaf_p = tfl.level_pass_plain(*ops, **kw)
    assert torch.equal(new_leaf, leaf_p)
    _assert_hist_close(hist, hist_p, 5, Sp, False)
    assert torch.equal(tfl.route_pass(ops[0], ops[1], W, ops[4], **{
        k: kw[k] for k in ("num_bins", "f_oh")}), leaf_p)
    score = t(np.where(np.arange(Rp) < R, rng.randn(Rp), 0)
              .astype(np.float32)[None, :])
    opsr = np.zeros((8, Rp), np.float32)
    opsr[0, :R] = np.where(rng.rand(R) < 0.4, 1.0, -1.0)
    opsr[1, :R] = 1.0
    lv = t((rng.randn(255) * 0.1).astype(np.float32))
    args = (ops[0], ops[1], W, ops[4], lv, score, t(opsr), t(wt[None, :]))
    ekw = dict(kw, kind="binary")
    hist_e, score_e, gh_e = tfl.epilogue_pass(*args, **ekw)
    hist_q, score_q, gh_q = tfl.epilogue_pass_plain(*args, **ekw)
    torch.testing.assert_close(score_e, score_q, rtol=1e-6, atol=0)
    live = hist_q[:, ::8]
    for c in range(5):
        scale = float(live[:, c].abs().max()) or 1.0
        err = float((hist_e[:, 8 * c] - live[:, c]).abs().max())
        assert err <= (0 if c == 4 else 1e-5 * scale), (c, err)


def test_cuda_bundled_training_matches_cpu(cuda_device):
    """A sparse-built dataset (CSR, bundled at ingestion) and dense EFB
    train on the card as on the CPU: the same trees (leaf values within
    1e-5) on train() and update()."""
    import scipy.sparse as sp
    rng = np.random.RandomState(3)
    n = 20_000
    dense = rng.randn(n, 3)
    onehot = np.zeros((n, 24))
    k = rng.randint(0, 24, n)
    onehot[np.arange(n), k] = 1.0
    X = np.hstack([dense, onehot])
    y = (dense[:, 0] + 1.5 * (k < 6) + 0.3 * rng.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    for data in (sp.csr_matrix(X), X):
        models = []
        for dev in ("cuda", "cpu"):
            b = lt.Booster(dict(p, device_type=dev),
                           lt.Dataset(data, label=y))
            assert b._gbdt.use_bundles
            for _ in range(3):
                b.update()
            models.append(b.models)
        for a, c in zip(*models):
            np.testing.assert_array_equal(a.split_feature, c.split_feature)
            np.testing.assert_array_equal(a.left_child, c.left_child)
            np.testing.assert_allclose(a.leaf_value, c.leaf_value,
                                       rtol=1e-5, atol=1e-6)


def _mono_rows(n=250_000):
    """The determinism test's draw with the labelling weights' signs as
    constraints on the 8 columns of largest |w| (chip_smoke phase 12)."""
    rng = np.random.RandomState(1)
    X = rng.rand(n, 28).astype(np.float32)
    w = rng.randn(28).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(n) > 0).astype(np.float32)
    mono = np.zeros(28, np.int32)
    top = np.argsort(-np.abs(w))[:8]
    mono[top] = np.sign(w[top]).astype(np.int32)
    return X, y, mono


@pytest.mark.parametrize("method", ["basic", "intermediate"])
def test_cuda_monotone_training_gives_the_same_model_twice(cuda_device,
                                                           method):
    """A monotone train() (250,000 rows, 255 leaves, 3 rounds) gives the
    same model text twice on the card, with the constraints in it."""
    X, y, mono = _mono_rows()
    p = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
         "learning_rate": 0.1, "min_data_in_leaf": 1,
         "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
         "device_type": "cuda", "monotone_constraints": mono.tolist(),
         "monotone_constraints_method": method}
    texts = [lt.train(p, lt.Dataset(X, label=y), 3).model_to_string()
             for _ in range(2)]
    assert texts[0] == texts[1]
    assert "monotone_constraints=" + " ".join(map(str, mono)) in texts[0]


def test_cuda_pred_leaf_matches_the_bin_router(cuda_device):
    """predict(pred_leaf=True) on the card (float64 routing of raw values)
    gives every training row the leaf the trainer's bin router gives it."""
    X, y, _ = _mono_rows()
    p = {"objective": "binary", "max_bin": 63, "num_leaves": 63,
         "verbose": -1, "device_type": "cuda"}
    bst = lt.train(p, lt.Dataset(X, label=y), 3)
    leaves = bst.predict(X, pred_leaf=True)
    g = bst._gbdt
    for i, ht in enumerate(bst.models):
        want = g._host_tree_leaves(g.train_data.bins_dev, ht)
        np.testing.assert_array_equal(leaves[:, i], want.cpu().numpy())


def test_cuda_binary_cache_round_trip(cuda_device, tmp_path):
    """save_binary/load_binary on the card: the loaded bins reach the card
    only when a booster is built, equal to the original's there, and the
    model trains to the same text."""
    X, y, _ = _mono_rows(50_000)
    p = {"objective": "binary", "max_bin": 63, "num_leaves": 63,
         "verbose": -1, "device_type": "cuda"}
    ds = lt.Dataset(X, label=y, params=dict(p)).construct()
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    loaded = lt.Dataset(path, params={"device_type": "cuda"}).construct()
    assert loaded._inner._bins_dev is None
    bst = lt.train(p, loaded, 3)
    assert loaded._inner.bins_dev.is_cuda
    assert torch.equal(loaded._inner.bins_dev, ds._inner.bins_dev)
    ds.params = {}
    assert bst.model_to_string() == lt.train(p, ds, 3).model_to_string()


def _slice_rows(n=5000):
    rng = np.random.RandomState(3)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.05, 2] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) + 0.3 * X[:, 3] \
        + 0.3 * rng.randn(n)
    return X, z


@pytest.mark.parametrize("extra", [
    {"objective": "binary", "boosting": "dart", "skip_drop": 0.0,
     "drop_rate": 0.3},
    {"objective": "binary", "boosting": "rf", "bagging_fraction": 0.6,
     "bagging_freq": 1, "feature_fraction": 0.8},
    {"objective": "regression", "linear_tree": True, "linear_lambda": 0.1},
], ids=["dart", "rf", "linear"])
def test_cuda_dart_rf_linear_match_cpu(cuda_device, extra):
    """DART, RF and linear_tree train() on the card (through level_pass,
    route_pass and table_lookup) as on the CPU: the same drop sets and
    tree structures, predictions within rtol 1e-5, atol 1e-6."""
    X, z = _slice_rows()
    y = z if extra["objective"] == "regression" else (z > 0).astype(float)
    p = dict({"num_leaves": 31, "max_bin": 63, "min_data_in_leaf": 20,
              "verbose": -1}, **extra)
    out = {}
    for dev in ("cpu", "cuda"):
        tfl.reset_launch_counts()
        bst = lt.Booster(dict(p, device_type=dev), lt.Dataset(X, label=y))
        drops = []
        for _ in range(5):
            bst.update()
            drops.append(list(getattr(bst._gbdt, "drop_index", [])))
        out[dev] = bst, drops, dict(tfl.launches)
    (bc, dc, _), (bg, dg, n) = out["cpu"], out["cuda"]
    assert dc == dg
    assert all(n[k] > 0 for k in ("level_pass", "route_pass"))
    if not extra.get("linear_tree"):
        assert n["table_lookup"] > 0
    assert bg._gbdt.scores.is_cuda
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
        assert a.leaf_features == b.leaf_features
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


def test_cuda_pred_contrib_matches_cpu(cuda_device):
    """pred_contrib on the card equals the CPU's within 1e-9 and adds up
    to predict(raw_score=True)."""
    X, z = _slice_rows()
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "device_type": "cuda"}
    text = lt.train(p, lt.Dataset(X, label=(z > 0).astype(float)),
                    5).model_to_string()
    bg = lt.Booster(params={"device_type": "cuda"}, model_str=text)
    bc = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    got = bg.predict(X[:2000], pred_contrib=True)
    np.testing.assert_allclose(got, bc.predict(X[:2000], pred_contrib=True),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.sum(1),
                               bg.predict(X[:2000], raw_score=True),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("R,F,B,S,slots", [
    (5000, 28, 64, 1, "random"),     # a leaf-wise step: one slot
    (5000, 28, 64, 255, "random"),   # a depth-wise level: S = L
    (6000, 28, 64, 1, "root"),
    (3000, 88, 256, 64, "random"),   # bundle columns
    (1500, 7, 16, 600, "random"),    # two windows of slots
])
def test_hist_pass_unrounded_matches_plain(cuda_device, R, F, B, S, slots):
    """The XLA engine's variant: the f32 channels as given (no bf16
    rounding), the same bits on a second call, within 1e-5 of the plain
    version's float64 sums; the weight channel exact."""
    bins, gh, slot, Bp = _hist_operands(R, F, B, S, 0, seed=R + S,
                                        slots=slots)
    kw = dict(S=S, Bp=Bp, nch=3, unrounded=True)
    args = (bins.to(cuda_device), gh.to(cuda_device), slot.to(cuda_device))
    out_c = tph.hist_pass(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tph.hist_pass(*args, **kw), out_c)
    out_p = tph.hist_pass_plain(bins, gh, slot, **kw)
    for c in range(2):
        np.testing.assert_allclose(
            out_c[c].cpu().numpy(), out_p[c].numpy(), rtol=1e-5,
            atol=1e-5 * float(out_p[c].abs().max()))
    assert torch.equal(out_c[2].cpu(), out_p[2])
    rounded = tph.hist_pass_plain(bins, gh, slot, S=S, Bp=Bp, nch=3)
    assert not torch.equal(rounded[:2], out_p[:2])


@pytest.mark.parametrize("extra", [
    {"tpu_engine": "xla"},
    {"tpu_engine": "xla", "grow_policy": "depthwise"},
    {"tpu_engine": "xla", "cegb_penalty_split": 1e-4,
     "cegb_penalty_feature_lazy": [0, 0, 0, 0, 1e-3, 1e-3, 0, 0]},
], ids=["leafwise", "depthwise", "cegb"])
def test_cuda_xla_engine_matches_cpu_and_repeats(cuda_device, extra):
    """The XLA engine's growers on the card: two train() calls give the
    same model text (no f32 atomic in hist_pass), the trees equal the
    CPU's and the predictions agree within rtol 1e-5, atol 1e-6; every
    histogram went through hist_pass."""
    X, z = _slice_rows()
    y = (z > 0).astype(float)
    p = dict({"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1}, **extra)
    texts, boosters = [], {}
    for dev in ("cuda", "cuda", "cpu"):
        tfl.reset_launch_counts()
        bst = lt.train(dict(p, device_type=dev), lt.Dataset(X, label=y), 4)
        if dev == "cuda":
            texts.append(bst.model_to_string())
            assert tfl.launches["hist_pass"] > 0
            assert tfl.launches["level_pass"] == 0
        boosters[dev] = bst
    assert texts[0] == texts[1]
    bg, bc = boosters["cuda"], boosters["cpu"]
    for a, b in zip(bc.models, bg.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_allclose(bg.predict(X, raw_score=True),
                               bc.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_xla_growers_never_wait_for_the_card(cuda_device, policy,
                                            monkeypatch, tmp_path):
    """No operation inside either XLA grower synchronizes with the card:
    under ``torch.cuda.set_sync_debug_mode("error")`` any that does (a
    read to the host, a copy from pageable host memory) raises. The
    leaf-wise run takes forced splits, the advanced monotone mode, a
    categorical column and by-node sampling; the depth-wise run CEGB with
    lazy costs, the intermediate mode and the same. The tree's one read,
    its leaf count after the loop (``learner._finish``), is left to the
    caller here. PyTorch calls the mode a prototype that does not detect
    every synchronizing operation; the test also checks that it catches
    ``.item()``."""
    import json
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.models import learner as tlearn
    X, z = _slice_rows()
    X[:, 5] = np.random.RandomState(8).randint(0, 6, len(X))
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 20, "verbose": -1, "tpu_engine": "xla",
         "grow_policy": policy, "feature_fraction_bynode": 0.8,
         "device_type": "cuda"}
    mono = [1, 0, 0, 1, 0, 0, 0, 0]
    if policy == "leafwise":
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 4, "threshold": 0.0,
                                    "left": {"feature": 6,
                                             "threshold": 0.0}}))
        p.update(forcedsplits_filename=str(path),
                 monotone_constraints_method="advanced")
    else:
        p.update(cegb_penalty_split=1e-4,
                 cegb_penalty_feature_lazy=[0, 0, 1e-3, 0, 0, 0, 0, 1e-3],
                 monotone_constraints_method="intermediate")
    grower = "grow_tree_" + policy
    real = getattr(gbdt_mod, grower)

    def strict(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    monkeypatch.setattr(gbdt_mod, grower, strict)
    monkeypatch.setattr(tlearn, "_finish",
                        lambda tree, nl: tree._replace(num_leaves=nl))
    ds = lt.Dataset(X, label=(z > 0).astype(float), categorical_feature=[5],
                    params={"monotone_constraints": mono})
    bst = lt.train(p, ds, 3)
    g = bst._gbdt
    assert g.grow_policy == policy and not g.use_fused
    assert g.mono_mode == ("advanced" if policy == "leafwise"
                           else "intermediate")
    assert g.use_cegb == (policy == "depthwise")
    assert bst.num_trees() == 3 and all(m.num_leaves > 1
                                        for m in bst.models)
    # the check itself catches a read to the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(1, device=cuda_device).item()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _stack_tensors(variant, device, **kw):
    """A random stack: its fields, then the records packed from them."""
    from lightgbm_tpu_torch.ops.predict import FIELDS, pack_records
    enc, arrays, tids, steps = random_stack(variant, **kw)

    def t(a):
        return None if a is None else torch.as_tensor(a).to(device)
    ops = tuple(t(arrays[n]) for n in FIELDS[variant])
    return t(enc), ops + pack_records(ops, variant), t(tids), steps


@pytest.mark.parametrize("variant", ["binned", "raw"])
@pytest.mark.parametrize("cat,k", [(False, 1), (True, 1), (False, 3),
                                   (True, 3), (True, 9)])
def test_predict_pass_matches_plain(cuda_device, variant, cat, k):
    """The stacked traversal on the card gives the plain version's bits,
    twice (no atomics; class sums in tree order); k = 9 takes the
    accumulator in the output column instead of registers."""
    from lightgbm_tpu_torch.ops import predict as tpred
    enc, ops, tids, steps = _stack_tensors(variant, "cpu", R=3000, T=24,
                                           k=k, cat=cat, seed=k + 2 * cat)
    want = tpred.predict_pass_plain(enc, ops, tids, k, steps, variant)
    dev = [None if a is None else a.to(cuda_device) for a in ops]
    n0 = dict(tpred.launches)
    a = tpred.predict_pass(enc.to(cuda_device), dev, tids.to(cuda_device),
                           k, steps, variant)
    b = tpred.predict_pass(enc.to(cuda_device), dev, tids.to(cuda_device),
                           k, steps, variant)
    torch.cuda.synchronize()
    assert tpred.launches["predict_pass"] - n0["predict_pass"] == 2
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


def test_predict_pass_raises_on_bad_operands(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: an operand left on
    the CPU is refused, never routed to the plain version."""
    from lightgbm_tpu_torch.ops import predict as tpred
    enc, ops, tids, steps = _stack_tensors("raw", "cpu", R=64)
    with pytest.raises(ValueError):
        tpred.predict_pass(enc.to(cuda_device), ops, tids, 1, steps, "raw")


def test_service_on_card_one_launch_per_dispatch(cuda_device, tmp_path):
    """A service on the card: after warmup, every request is one dispatch
    and one predict_pass launch, no new signature, and the answers agree
    with the float64 walk (rtol 1e-5); the file model's leaves are the
    walk's on float32 input."""
    from lightgbm_tpu_torch.ops import predict as tpred
    X, z = _slice_rows()
    X = X.astype(np.float32)
    bst = lt.train({"objective": "binary", "num_leaves": 31, "verbose": -1,
                    "device_type": "cuda"},
                   lt.Dataset(X, label=(z > 0).astype(float)), 8)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    svc = lt.serve.PredictionService({"live": bst, "file": path},
                                     max_batch_rows=256, min_bucket_rows=16,
                                     max_delay_ms=1.0, serve_devices=1)
    try:
        svc.warmup()
        s0 = svc.stats()
        n0 = tpred.launches["predict_pass"]
        rng = np.random.RandomState(3)
        walk = lt.Booster(params={"device_type": "cuda"},
                          model_file=path)
        for i, rows in enumerate([1, 7, 16, 100, 256, 33]):
            Xq = X[rng.randint(0, len(X), rows)]
            got = svc.predict(("live", "file")[i % 2], Xq)
            want = walk.predict(Xq.astype(np.float64))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        s1 = svc.stats()
        dispatches = s1["dispatches"] - s0["dispatches"]
        assert dispatches == 6
        assert tpred.launches["predict_pass"] - n0 == dispatches
        assert s1["compiles"] == s0["compiles"]
        assert s1["dispatches_per_request"] == 1.0
        eng = svc.residency.get("file")
        assert eng.variant == "raw" and eng.device_ok
        Xq = X[:256]
        for ti in range(3):
            one = lt.serve.ServingEngine(walk, max_batch_rows=256,
                                         min_bucket_rows=256,
                                         start_iteration=ti,
                                         num_iteration=1)
            got = one.predict_raw(Xq)[0].astype(np.float32)
            want = walk.predict(Xq.astype(np.float64), raw_score=True,
                                start_iteration=ti, num_iteration=1)
            np.testing.assert_array_equal(got, want.astype(np.float32))
    finally:
        svc.close()


@pytest.mark.parametrize("R", [100, 3000, 20_000, 70_000, 140_000])
@pytest.mark.parametrize("variant", ["binned", "raw"])
def test_predict_tiled_shapes_match_plain(cuda_device, R, variant):
    """Every launch shape (trees split across blocks below 132 row tiles,
    one split above; 128, 256 and 512 rows a block): the plain version's
    bits, twice; categorical nodes, k = 9 (the output column as
    accumulator) and max_steps 256."""
    from lightgbm_tpu_torch.ops import predict as tpred
    for cat, k, steps in ((True, 3, None), (False, 9, 256)):
        enc, ops, tids, st = _stack_tensors(variant, "cpu", R=R, T=12,
                                            k=k, cat=cat, seed=R % 97 + k)
        steps = steps or st
        want = tpred.predict_pass_plain(enc, ops, tids, k, steps, variant)
        dev = [None if a is None else a.to(cuda_device) for a in ops]
        e, t = enc.to(cuda_device), tids.to(cuda_device)
        a = tpred.predict_pass(e, dev, t, k, steps, variant)
        b = tpred.predict_pass(e, dev, t, k, steps, variant)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a.cpu(), want)


@pytest.mark.parametrize("R", [1024, 140_000])
def test_predict_empty_tree_range(cuda_device, R):
    """``Booster.predict`` from the last iteration takes the device
    predictor over no trees: zeros, as the plain version gives."""
    from lightgbm_tpu_torch.ops import predict as tpred
    enc, ops, tids, steps = _stack_tensors("binned", cuda_device, R=R,
                                           T=6, k=3)
    empty = tuple(None if a is None else a if a.dim() == 1 else a[:0]
                  for a in ops)
    out = tpred.predict_pass(enc, empty, tids[:0], 3, steps, "binned")
    torch.cuda.synchronize()
    assert tuple(out.shape) == (3, R) and not out.any()
    X, z = _slice_rows()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device_type": "cuda", "pred_device_min_work": 1},
                   lt.Dataset(X, label=(z > 0).astype(float)), 3)
    got = bst.predict(X, start_iteration=3, raw_score=True)
    np.testing.assert_array_equal(got, np.zeros(len(X)))
