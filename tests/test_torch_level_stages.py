"""The three stages of lightgbm_tpu_torch's ``level_pass`` on the CPU.

On the card ``level_pass`` runs as mark (route, smaller-child slot,
per-slot counts), partition (each marked row's bins and channels copied,
as one staging record, into its slot's bucket) and a slot-tiled histogram
over the records. Their plain versions (``level_mark_plain``,
``level_partition_plain``, ``level_hist_plain``) composed must give
``level_pass_plain`` — which tests/test_torch_fused_level.py and
tests/test_torch_plane_kernels.py hold against the JAX package — exactly
on int32 planes and new leaves, within rel 1e-6 of each f32 plane's
largest magnitude (the same values, summed per cell in the same row
order; the tolerance leaves room for another reduction order) with the
weight channel exact. Also: the partition is a permutation of the marked
rows grouped by slot with the scanned counts, each record holding its
row's bins and channels; the root pass (Sp = 1,
every row in one slot), an empty slot, an inactive slot and padding
rows; the histogram's feature groups. Small shapes, no JAX: a few
seconds. tests/test_torch_cuda.py holds the CUDA stages against these
plain versions on the card.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import fused_level as tfl
from torch_parity import level_operands

torch.set_num_threads(1)

NUM_BIN = np.array([63, 63, 63, 8, 8, 8, 17, 2], np.int32)
R, RP = 1500, 2048
CASES = {
    "f32-nch5": dict(),
    "f32-nch3": dict(nch=3),
    "quant8": dict(quant_bits=8),
    "quant16": dict(quant_bits=16),
    "packed": dict(packed=True),
    "masked": dict(masked=True),
    "quant16-packed-masked": dict(quant_bits=16, packed=True, masked=True),
    "root": dict(Sp=1),
    "root-quant16-packed-masked": dict(Sp=1, quant_bits=16, packed=True,
                                       masked=True),
    "bp256-int16": dict(Bp=256, Sp=4),
}


def _operands(name, seed=3):
    kw = dict(CASES[name])
    Bp, Sp = kw.pop("Bp", 64), kw.pop("Sp", 8)
    num_bin = NUM_BIN if Bp == 64 else np.array([255, 200, 9, 3], np.int32)
    return level_operands(R, RP, num_bin, Bp, Sp, seed=seed, **kw)


def _stages(ops, fm, kw):
    new_leaf, row_slot, counts = tfl.level_mark_plain(*ops, fm, **kw)
    order = tfl.partition_order_plain(row_slot, counts)
    stage = tfl.level_partition_plain(ops[0], ops[2], row_slot, counts,
                                      **kw)
    hist = tfl.level_hist_plain(stage, counts, fm,
                                bin_bytes=ops[0].element_size(), **kw)
    return new_leaf, row_slot, counts, order, stage, hist


def _assert_planes_match(got, want, nch, Sp, quant):
    if quant:
        assert torch.equal(got, want)
        return
    for ch in range(nch):
        g, w = got[:, ch * Sp:(ch + 1) * Sp], want[:, ch * Sp:(ch + 1) * Sp]
        if ch == nch - 1:
            assert torch.equal(g, w), "weight channel"
        else:
            scale = float(w.abs().max()) or 1.0
            assert float((g - w).abs().max()) <= 1e-6 * scale, ch


@pytest.mark.parametrize("name", list(CASES))
def test_stages_compose_to_level_pass(name):
    ops, fm, kw = _operands(name)
    new_leaf, _, _, _, _, hist = _stages(ops, fm, kw)
    hist_ref, leaf_ref = tfl.level_pass_plain(*ops, fm, **kw)
    assert torch.equal(new_leaf, leaf_ref)
    assert hist.dtype == hist_ref.dtype and hist.shape == hist_ref.shape
    _assert_planes_match(hist, hist_ref, kw["nch"], ops[4].shape[0],
                         kw["quant_bits"])
    assert hist_ref.abs().sum() > 0
    # the wrappers take the plain versions on CPU tensors
    got = tfl.level_mark(*ops, fm, **kw)
    for a, b in zip(got, tfl.level_mark_plain(*ops, fm, **kw)):
        assert torch.equal(a, b)
    stage = tfl.level_partition(ops[0], ops[2], got[1], got[2], **kw)
    assert torch.equal(tfl.level_hist(stage, got[2], fm,
                                      bin_bytes=ops[0].element_size(),
                                      **kw), hist)


@pytest.mark.parametrize("name", ["f32-nch5", "quant8", "packed", "root"])
def test_partition_groups_marked_rows_by_slot(name):
    ops, fm, kw = _operands(name)
    bins_T, leaf_T, gh_T, W, tbl = ops
    new_leaf, row_slot, counts, order, stage, _ = _stages(ops, fm, kw)
    Sp = tbl.shape[0]
    # marked: in an active slot's leaf, on its smaller child's side, with
    # a non-zero channel
    leaf = leaf_T[0]
    slot_of = torch.full_like(leaf, -1)
    for k in range(Sp):
        slot_of[leaf == tbl[k, 0]] = k
    left = new_leaf[0] == leaf
    small = (slot_of >= 0) & (left == (tbl[slot_of.clamp(min=0), 2] > 0))
    marked = small & (gh_T[:kw["nch"]] != 0).any(0)
    assert torch.equal(row_slot, torch.where(marked, slot_of, -1)
                       .to(torch.int8))
    assert torch.equal(counts, torch.bincount(
        slot_of[marked], minlength=Sp).to(torch.int32))
    n = int(counts.sum())
    assert n == int(marked.sum()) > 0
    assert torch.equal(order[:n].sort().values,
                       torch.nonzero(marked).squeeze(1).to(torch.int32))
    assert bool((order[n:] == -1).all())
    off = np.concatenate([[0], np.cumsum(counts.numpy())])
    for k in range(Sp):
        bucket = order[off[k]:off[k + 1]].long()
        assert bool((row_slot[bucket] == k).all()), k
    # record q: row order[q]'s K bins from byte 0, its channels from the
    # next 4-byte boundary, zeros elsewhere and past the last bucket
    K = len(kw["packed"].feat_order) if kw["packed"] else kw["f_oh"]
    bb, cb = bins_T.element_size(), gh_T.element_size()
    ch_off, nbytes = tfl.record_layout(K, bb, kw["nch"], cb)
    assert stage.shape == (RP, nbytes) and nbytes % 16 == 0
    rows = order[:n].long()
    assert torch.equal(stage[:n, :K * bb].contiguous().view(bins_T.dtype),
                       bins_T[:K, rows].t())
    assert torch.equal(stage[:n, ch_off:ch_off + kw["nch"] * cb]
                       .contiguous().view(gh_T.dtype),
                       gh_T[:kw["nch"], rows].t())
    pad = torch.ones(nbytes, dtype=torch.bool)
    pad[:K * bb] = False
    pad[ch_off:ch_off + kw["nch"] * cb] = False
    assert not stage[:n, pad].any() and not stage[n:].any()


def test_root_pass_puts_every_live_row_in_one_slot():
    ops, fm, kw = _operands("root")
    gh_T = ops[2]
    new_leaf, row_slot, counts, order, _, _ = _stages(ops, fm, kw)
    live = (gh_T[:kw["nch"]] != 0).any(0)
    assert live[R:].sum() == 0
    assert counts.tolist() == [int(live.sum())]
    assert torch.equal(new_leaf, ops[1])             # every row goes left
    assert torch.equal(order[:int(live.sum())],
                       torch.nonzero(live).squeeze(1).to(torch.int32))


def test_empty_inactive_slots_and_padding_rows():
    ops, fm, kw = _operands("f32-nch5")
    leaf_T, tbl = ops[1], ops[4]
    new_leaf, row_slot, counts, _, _, hist = _stages(ops, fm, kw)
    Sp = tbl.shape[0]
    assert tbl[1, 0] == 1 and not bool((leaf_T == 1).any())
    assert tbl[Sp - 1, 0] == -2
    assert counts[1] == 0 and counts[Sp - 1] == 0 and counts.sum() > 0
    for k in (1, Sp - 1):                  # empty and inactive: all zero
        assert not hist[:, k::Sp].any()
    assert bool((row_slot[R:] == -1).all())
    assert bool((new_leaf[0, R:] == -1).all())


@pytest.mark.parametrize("K,bin_bytes,nch,ch_bytes,want", [
    (28, 1, 5, 2, (28, 48)), (28, 2, 5, 2, (56, 80)), (28, 1, 3, 1, (28, 32)),
    (7, 1, 5, 2, (8, 32)), (1, 2, 3, 2, (4, 16))])
def test_record_layout(K, bin_bytes, nch, ch_bytes, want):
    assert tfl.record_layout(K, bin_bytes, nch, ch_bytes) == want


@pytest.mark.parametrize("K,width,nch,budget,want", [
    (28, 64, 5, 232448 - 1024, (28, 32)),      # one 40,960 B tile
    (28, 256, 5, 232448 - 1024, (28, 32)),     # 163,840 B
    (64, 256, 5, 232448 - 1024, (32, 32)),     # two groups
    (64, 256, 3, 232448 - 1024, (64, 32)),
    (28, 2048, 5, 232448 - 1024, (5, 5)),      # a band of 32 is too wide
    (28, 64, 5, 10000, (7, 7)),
])
def test_hist_groups_fit_the_budget(K, width, nch, budget, want):
    Kg, Cw = tfl.hist_groups(K, width, nch, budget)
    assert (Kg, Cw) == want
    assert -(-Kg // Cw) * width * Cw * nch * 4 <= budget
