"""The tiled ``predict_pass``'s operands: the 16-byte node records that
``ops.predict.pack_records`` packs once per model, and the launch shape of
``tiled_plan``.

The records decode to the fields they were packed from; the plain version,
given a stack with its records, equals the JAX package's stacked runner
(``_run_binned_body`` / ``_run_raw_body`` through ``stacked_run_fn``:
float32 sums within rtol 1e-6), also at ``max_steps`` 256 (model-file
trees) with k = 3 and categorical nodes, and walks the fields, not the
records, so that the kernel's walk of the records is held to an
independent one; a stack without its records, or with malformed ones, is
refused; the launch shape splits the trees across blocks only where the
row tiles leave the card's SMs idle, stays inside its shared-memory
budget, and takes an empty stack.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.models import predictor as jpred
from lightgbm_tpu_torch.ops import predict as tops
from torch_parity import random_stack


def _tensors(arrays, variant):
    return tuple(None if arrays[n] is None else torch.as_tensor(arrays[n])
                 for n in tops.FIELDS[variant])


@pytest.mark.parametrize("variant", ["binned", "raw"])
def test_records_decode_to_their_fields(variant):
    _, arrays, _, _ = random_stack(variant, R=8, T=9, k=1, cat=True, seed=3)
    nodes, fmiss = tops.pack_records(_tensors(arrays, variant), variant)
    T, N = arrays["sf"].shape
    assert nodes.dtype == torch.int32 and tuple(nodes.shape) == (T, N, 4)
    n = nodes.numpy()
    w0 = n[..., 0]
    np.testing.assert_array_equal(w0 & 0xFFFFFF, arrays["sf"])
    np.testing.assert_array_equal((w0 >> 24) & 1, arrays["dl"])
    np.testing.assert_array_equal((w0 >> 27) & 1, arrays["cf"])
    np.testing.assert_array_equal(n[..., 2], arrays["lc"])
    np.testing.assert_array_equal(n[..., 3], arrays["rc"])
    if variant == "raw":
        assert fmiss is None
        np.testing.assert_array_equal((w0 >> 25) & 3, arrays["mt"])
        np.testing.assert_array_equal(n[..., 1].view(np.float32),
                                      arrays["th"])
        return
    miss = arrays["missing"]
    np.testing.assert_array_equal((w0 >> 25) & 3, miss[arrays["sf"]])
    np.testing.assert_array_equal(n[..., 1], arrays["tb"])
    want = np.where(miss == 1, arrays["default_bin"],
                    np.where(miss == 2, arrays["num_bin"] - 1, -1))
    np.testing.assert_array_equal(fmiss.numpy(), want)


@pytest.mark.parametrize("variant,k,steps", [("binned", 3, None),
                                             ("raw", 3, 256),
                                             ("raw", 1, None)])
def test_repacked_plain_equals_jax_runner(variant, k, steps):
    enc, arrays, tids, st = random_stack(variant, R=300, T=12, k=k,
                                         cat=True, seed=7 + k)
    steps = steps or st
    ops = _tensors(arrays, variant)
    records = tops.pack_records(ops, variant)
    got = tops.predict_pass_plain(torch.as_tensor(enc), ops + records,
                                  torch.as_tensor(tids), k, steps,
                                  variant).numpy()
    names = tops.FIELDS[variant]
    cut = names.index("lv") + 1
    jargs = [None if arrays[n] is None else jnp.asarray(arrays[n])
             for n in names]
    jargs = jargs[:cut] + [jnp.asarray(tids)] + jargs[cut:]
    want = np.asarray(jpred.stacked_run_fn(variant)(
        jnp.asarray(enc), *jargs, k=k, max_steps=steps))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the plain version walks the fields: records packed wrongly (every
    # default-left bit flipped) leave its answer as it was
    nodes, fmiss = records
    again = tops.predict_pass_plain(torch.as_tensor(enc),
                                    ops + (nodes ^ (1 << 24), fmiss),
                                    torch.as_tensor(tids), k, steps,
                                    variant).numpy()
    np.testing.assert_array_equal(got, again)


def test_bad_records_are_refused():
    enc, arrays, tids, steps = random_stack("binned", R=20, T=4, seed=1)
    ops = _tensors(arrays, "binned")
    nodes, fmiss = tops.pack_records(ops, "binned")
    for bad in ((nodes[:, :-1], fmiss), (nodes, None),
                (nodes, fmiss[:-1]), (nodes.long(), fmiss), ()):
        with pytest.raises(ValueError):
            tops.predict_pass(torch.as_tensor(enc), ops + bad,
                              torch.as_tensor(tids), 1, steps, "binned")


@pytest.mark.parametrize("R,RT,TS", [(1024, 128, 29), (16, 128, 200),
                                     (65_536, 256, 1),
                                     (1_000_000, 512, 1)])
def test_tiled_plan_fills_the_card(R, RT, TS):
    """Phase 15's shapes (200 trees of 255 leaves, 28 features) on 132
    SMs: trees split across blocks below 132 row tiles."""
    p = tops.tiled_plan(R, 28, 200, 254, 255, 132)
    assert (p["RT"], p["TS"]) == (RT, TS)
    assert p["rows_smem"] == p["nodes_smem"] == 1
    assert p["TS"] * p["Ts"] >= 200 > (p["TS"] - 1) * p["Ts"]
    assert 1 <= p["TC"] <= p["Ts"]
    smem = p["TC"] * (16 * 254 + 4 * 255) + p["RT"] * 28 * 4 + 28 * 4
    assert smem <= tops.TILED_SMEM


def test_tiled_plan_reads_what_does_not_fit_from_memory():
    wide = tops.tiled_plan(4096, 20_000, 10, 30, 31, 132)
    assert wide["rows_smem"] == 0 and wide["nodes_smem"] == 1
    deep = tops.tiled_plan(4096, 28, 10, 20_000, 20_001, 132)
    assert deep["nodes_smem"] == 0 and deep["TC"] == deep["Ts"]


@pytest.mark.parametrize("R", [1024, 1_000_000])
def test_tiled_plan_of_an_empty_stack(R):
    """No trees (``Booster.predict`` from the last iteration): one split
    of one tree's room, so the launch writes zeros."""
    p = tops.tiled_plan(R, 28, 0, 254, 255, 132)
    assert p["TS"] == p["Ts"] == 1 and 1 <= p["TC"]


def test_empty_stack_scores_zero():
    enc, arrays, tids, steps = random_stack("raw", R=20, T=4, seed=2)
    ops = tuple(None if a is None else a[:0]
                for a in _tensors(arrays, "raw"))
    ops = ops + tops.pack_records(ops, "raw")
    out = tops.predict_pass(torch.as_tensor(enc), ops,
                            torch.as_tensor(tids[:0]), 2, steps, "raw")
    assert tuple(out.shape) == (2, 20) and not out.any()
