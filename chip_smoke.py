#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero (it prints no result line then):

1. environment and build: the card's name and power limit (nvidia-smi),
   torch and CUDA versions; the CUDA kernels built from ``csrc/``, with
   each kernel instance's registers, spills and shared memory (ptxas);
   then the instructions the epilogue's histogram stage compiled to
   (cuobjdump: no matrix instruction, no atomic; PERF.md has the
   tensor-core design it replaced), and the atomics of every kernel of
   ``hist_pass`` (none in the f32 instances, native integer shared-memory
   adds in the int32 ones: no compare-and-swap loop, no global atomic);
2. each kernel against its plain PyTorch version on the card, at the
   slices' shapes: Rp = 1,001,472 rows, 28 features, Bp=64 with int8 bins
   and Bp=256 with int16 bins, Sp in {8, max_slot_cap}, nch in {5, 3}, a
   255-entry lookup table; ``route_pass`` also on a route table with a
   row over two slabs and an all-zero row; ``epilogue_pass`` also for
   kind binary and l2, on such a route table for each Bp and nch, and
   once with an all-inactive deferred table, with ~30% zero bag weights,
   and each of its CUDA kernels timed alone at the main shape;
   ``hist_pass`` at R = 1,000,000 rows, Fp = 28, Bp in {64, 256},
   S in {8, 64}, f32 (nch 3) and quantized to 8 bits (nch 3) and 16 bits
   (nch 5), ~30% of rows at slot -1 with non-zero gh, and the root level
   (S = 8, every row in slot 0), each called twice (the same bits), its
   CUDA kernels counted per call and, at the main shape, each timed
   alone; its unrounded f32 variant (the XLA engine's) at S in {1, 256},
   Bp in {64, 256}, and on a bundled layout (88 columns, Bp = 256); the
   histogram-plane
   variants of ``level_pass`` (quantized to 8 and 16 bits, packed,
   masked, and all three at once as run (b) of phase 6 runs them; f32
   padded on the same rows as their yardstick) and the packed
   ``route_pass`` at Rp = 1,001,472, F_oh = 28, Bp = 64, Sp in {8, 64} on
   the mixed-cardinality layout of phase 6 (14 features of 63 bins, 14 of
   8), each quantized plane also against the other layout's after
   unpacking; ``level_pass``, ``route_pass`` and ``epilogue_pass`` also on
   a categorical route table (every active row a bin set with holes
   inside its slab, bin 0 out); every f32 ``level_pass`` called twice on
   the same inputs (the same plane bits); ``level_pass`` (f32 and
   quantized to 16 bits), ``route_pass`` and ``epilogue_pass`` on bundle
   columns at Bc_p in {256, 512, 4096, 16384} (int16 bins, route tables
   from ``build_route_table_bundled`` with a categorical, a zero-missing
   and a NaN-missing member, Sp = max_slot_cap); with the errors, their
   tolerances, each kernel's device
   time per launch (``cuda_ms``: a CUDA graph of 20 calls replayed),
   each ``level_pass`` stage's time alone and its histogram tile;
3. end to end through ``lightgbm_tpu_torch.train`` on 1,000,000 x 28 rows
   of ``bench.py``'s synthetic binary data (seed 1), the Higgs-shaped
   configuration (max_bin=63, num_leaves=255, learning_rate=0.1,
   min_data_in_leaf=1), 10 rounds (the megastep body): sec/iter, training
   AUC (> 0.75), the kernels' launch counts (level_pass, route_pass and
   table_lookup each > 0), and ``Booster.predict`` against the trainer's
   scores;
4. the loop ``bench.py`` times, ``Booster(params, train_set)`` then
   ``update()`` (the epilogue body), on the same dataset: 2 warm-up and 10
   timed updates, (a) as bench.py has it, twice, in turns with the same
   loop on the megastep body (m) that ``train()`` runs, and (b) with
   bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.8: sec/iter,
   AUC (> 0.75), leaves, predict agreement, host syncs per tree, every
   kernel's launches (epilogue_pass > 0 on the epilogue body);
5. the frontier-v1 engine end to end: ``train()`` with
   ``tpu_engine="frontier"`` on the same dataset and parameters, 10 rounds:
   sec/iter after the first round, AUC (> 0.75), leaves per tree,
   ``hist_pass`` calls (10 per 255-leaf tree, each one launch of each of
   its CUDA kernels) and no launch of the fused engine's kernels, host
   syncs per tree (9), and ``Booster.predict`` against the trainer's
   scores;
6. the histogram-plane cuts end to end (``plane_cuts_train``): ``train()``
   on the same rows with columns 14-27 floored to 8 levels (bench.py's
   all-cuts leg), 10 rounds each of (a) f32 with no cuts, (b) quant16 +
   gain screening + adaptive bins (tests/test_hist_plane.py's KNOBS), (c)
   quant8 alone, and (d) quant16, (e) adaptive bins, (f) gain screening,
   each alone: sec/iter, launches per tree by kernel and variant (on the
   card exactly the megastep schedule of a full 255-leaf tree), host
   syncs per tree, AUC (within 0.05 of run a), predict agreement, the
   packed flat width against F_oh * Bp, the features screening keeps;
7. valid sets, metrics, callbacks, early stopping and ``cv`` through
   ``train()`` (``eval_train``), on phase 3's dataset and a valid set of
   250,000 rows from the same labelling function (binned against it),
   ``metric=["binary_logloss", "auc"]``: (a) bench.py's eval leg
   (``early_stopping_round=25``, ``log_evaluation(1)``,
   ``record_evaluation``) on the megastep body, 10 rounds: sec/iter,
   launches and host syncs per tree beside phase 3's, the device time of
   one valid update and of one evaluation of the metrics, the last
   recorded values against a float64 recomputation from ``predict``
   (rtol 1e-5), valid AUC > 0.75, the valid scores against ``predict``;
   (b) ``early_stopping(3)`` on the valid set and a copy with permuted
   labels, 30 rounds: the best iteration the callback's rule gives on the
   recorded curves, best + 3 trees, ``model_to_string`` and ``predict``
   keeping the best; (c) a numpy logloss ``feval`` (the classic loop, the
   epilogue body): equal to ``binary_logloss`` within rtol 1e-6; (d)
   ``tpu_engine="frontier"`` with the valid set: ``hist_pass`` launched,
   valid scores against ``predict``; (e) ``init_model`` = run (a)'s
   booster, 5 more rounds: the valid scores against the sum of both
   boosters' predictions; (f) ``cv``, 3 stratified folds, 5 rounds: the
   result keys and lengths, each mean the mean of the folds'
   ``eval_valid``;
8. multiclass, GOSS, per-node feature masks and the pointwise objectives
   through ``train()`` (``class_train``) on phase 3's dataset, its labels
   from the same draw's score z: (a) ``multiclass``, 5 classes (the
   quintiles of z), 10 rounds on the megastep body with
   ``metric=["multi_logloss", "multi_error"]`` on phase 7's valid rows:
   the recorded valid ``multi_logloss`` against a float64 recomputation
   from ``predict`` (rtol 1e-5), ``predict`` [250000, 5] with rows summing
   to 1 within 1e-6; (b) ``multiclassova``, 5 rounds; (c) GOSS
   (top_rate 0.2, other_rate 0.1), binary, 15 rounds on the synchronous
   body: the bag holds every row for 10 iterations (1/learning_rate),
   then the rows at or above the top 20% threshold of |g·h| (300,000
   where no rows tie at it) plus 100,000 of the rest, recounted from the
   gradients; (d)
   ``feature_fraction_bynode=0.5`` with interaction constraints
   [[0..13], [14..27]], binary, 10 rounds: every root-to-leaf path within
   one group, phase 3's host syncs per tree; (e) ``regression_l1`` (leaf
   renewal on the synchronous body), 10 rounds; (f) ``cross_entropy`` on
   sigmoid(z), 10 rounds (megastep body). Each: sec/iter after the first
   iteration, wrapper calls and CUDA launches per tree (1 ``route_pass``
   and 1 ``table_lookup`` each, and 9 ``level_pass`` for a tree that fills
   its 255 leaves in the scheduled levels, up to 11 where a level selects
   fewer splits than its cap), host syncs per tree, and training AUC >
   0.75 (binary runs) or a training loss that falls from the first
   iteration to the last;
9. ranking (``rank_train``) on MS-LTR-shaped queries: 1,000,000
   documents x 136 standard normal features in ~8,300 queries of 1-240
   documents, grades 0-4 (52/32/13/2/1%) from a score on the features,
   phase 3's tree parameters, a 200,000-document valid set with
   ``metric=["ndcg", "map"]`` at ``eval_at=[1, 3, 5, 10]``: (a)
   ``lambdarank`` and (b) ``rank_xendcg``, 10 rounds each on the megastep
   body: sec/iter, launches and CUDA launches per tree (the level
   schedule of ``max_slot_cap`` at 136 features: 19 ``level_pass``, 1
   ``route_pass`` and 1 ``table_lookup`` for a full tree, up to 3 more
   level passes where a level selects fewer splits than its cap), host
   syncs per tree, the recorded valid NDCG@10 per round against a
   float64 recomputation from ``predict`` (rtol 1e-5); (c) ``cv`` with 3
   query-aligned folds, 3 rounds: every fold's test rows whole queries;
10. categorical splits (``cat_train``) on phase 3's rows with columns 0-3
   as category codes (3, 12, 31 and 60 categories, each column's bucket
   through a fixed permutation), ``categorical_feature=[0, 1, 2, 3]``:
   (a) ``train()``, binary, 10 rounds (megastep body: ``level_pass``,
   ``route_pass``, ``table_lookup``); (b) the bare ``update()`` loop, 10
   rounds (epilogue body: ``level_pass``, ``epilogue_pass``); (c)
   ``multiclass``, 5 classes, 3 rounds: categorical splits per tree
   (> 0 on every tree of a and b), launches per tree, ``predict`` on the
   raw values against the trainer's scores (rtol, atol 1e-5), the model
   text round trip; then ``level_pass``, ``route_pass`` (also against the
   full W @ one-hot sum) and ``epilogue_pass`` against their plain
   versions on the route tables of the first trees of (a) and (b) whose W
   holds a categorical row with holes;
11. exclusive feature bundling and sparse input (``bundle_train``): (a)
   an Allstate-shaped CSR draw (Ke et al. 2017, Table 1: 4,228 sparse
   one-hot features): 1,000,000 rows of 28 dense columns and 30
   categorical fields of 140 levels one-hot encoded (value 1.0), bundled
   at ingestion (``Dataset`` on the CSR matrix), phase 3's parameters, 10
   rounds through ``train()``: the bundle columns and Bc_p (int16 bins),
   sec/iter, training AUC (> 0.75), launches and host syncs per tree,
   ``Booster.predict`` on 100,000 CSR rows against the trainer's scores
   (rtol, atol 1e-6), the model's split features logical column indices;
   (b) dense default-on EFB, 500,000 rows of 28 dense and 512 mutually
   exclusive columns, the bare ``update()`` loop (epilogue body) with a
   100,000-row valid set: ``use_bundles``, the bundle columns, Bc and
   Bc_p, ``epilogue_pass`` launched every update, valid AUC (> 0.75), and
   ``rollback_one_iter`` after one more update restoring the training
   and valid scores (within 1e-6: the last tree's f32 values are
   subtracted, as in the JAX package); (c) 64 exclusive columns of 63 bins
   and no dense column, one 4,033-bin bundle column (Bc_p = 4096), 5
   updates: ``epilogue_pass`` on every update beyond the old 1024-bin
   cap, training AUC (> ``WIDE_AUC_FLOOR``), ``predict`` within rtol,
   atol 1e-6 of the trainer's scores; after each run its own operands
   (``level_pass``'s ``CAPTURE_LEVEL_CALL``-th call, 11a's first
   ``route_pass`` call, the second ``epilogue_pass`` call of 11b and
   11c) through phase 2's bundled checks, with errors and times at the
   run's own layout (88 columns at Bc_p 256, 102 at 512, 1 at 4096);
12. monotone constraints and the rest of Booster and Dataset
   (``mono_train``), on phase 3's rows binned again with
   ``monotone_constraints`` = sign(w) on the 8 columns of largest |w| of
   the labelling weights (``mono_constraints``): (a) the basic and (b)
   the intermediate mode through ``train()`` (megastep body), 10 rounds,
   and (c) ``monotone_penalty=2.0`` through the bare ``update()`` loop
   (epilogue body, ``epilogue_pass`` on every update), each with
   sec/iter, training AUC (> 0.75; the gap to phase 3's unconstrained
   AUC recorded: the fences cap the trees below 255 leaves), launches
   and host syncs per tree, and the worst step of ``predict`` along each
   constrained column over a 200-point grid at 64 random rows (>= -1e-6
   in the constraint's direction); (d) on 12a's model, 100,000 rows:
   ``predict(pred_leaf=True)`` equal to the leaves the trainer routed
   them to, ``pred_early_stop`` (rows never stopped equal to the full
   prediction; the stopped rows counted), ``dump_model``'s tree count,
   ``feature_importance`` (split counts summing to the splits), ``refit``
   on 100,000 fresh rows (AUC > 0.75), and a ``save_binary`` /
   ``Dataset(path)`` round trip of phase 3's Dataset (bins on the host
   until a booster is built, then equal on the card) that trains one
   round to the same model text; after each of (a)-(c) its own operands
   (``level_pass``'s ``CAPTURE_LEVEL_CALL``-th call and the first
   ``route_pass`` of (a) and (b), the second ``epilogue_pass`` of (c))
   through phase 2's checks (``check_captured``);
13. DART, RF, linear-tree leaves and TreeSHAP (``slice_train``) on phase
   3's rows at its width, each through ``train()`` on the synchronous
   body (``run_slice_train``): (a) DART at LightGBM's drop defaults,
   ``drop_seed=4``, 20 rounds with phase 7's valid set (the drops per
   iteration, at least one; training and valid scores against
   ``predict``, rtol/atol 1e-5; training AUC > 0.75; sec/iter, launches
   and host syncs per tree; its 6th ``level_pass`` call held to the plain
   version on its own operands), (b) RF with bagging 0.632 and
   feature_fraction 0.8, 10 rounds with the valid set (``predict`` equal
   to the summed scores over 10, the ``average_output`` line,
   ``eval_valid``'s AUC equal to that of the averaged scores, 1e-6, and
   its logloss to the metric's on ``predict``, rtol 1e-5), (c)
   ``linear_tree`` regression on the latent z, 10 rounds with the raw
   columns on the card (``predict`` against the trainer's scores, 1e-5;
   one tree's fit redone by the device and the plain form on its own
   operands, rtol 1e-6; the fit's ms per tree; the L2 loss against 10
   rounds of constant leaves), (d) ``pred_contrib`` on (a)'s model:
   100,000 rows on the card adding up to the float64 walk (1e-6) and
   equal to the plain form on 200 rows (1e-9), with its seconds;
14. the XLA engine (``xla_train``) on phase 3's rows: (a)
   ``tpu_engine="xla"`` (the leaf-wise grower), 10 rounds: sec/iter,
   training AUC (> 0.75), predict against the trainer's scores, hist_pass
   calls per tree (1: the root), leaf_partition and leaf_hist calls per
   tree (254: one each per step, on the rows listed per leaf), CUDA
   launches per iteration, host syncs per tree; one captured step's
   leaf_partition (exactly) and leaf_hist (1e-5 of the abs sum, weights
   exact) against their plain versions on its own operands, the same
   bits twice, times against ``torch.sort`` and ``index_add_`` on the
   same rows and against the five-kernel hist_pass on the same child,
   and the root both ways; a captured root's hist_pass (S = 1) checked;
   then 2 rounds of
   ``tpu_engine="fused", grow_policy="leafwise"`` give (a)'s first two
   trees; (b) ``grow_policy="depthwise"`` with CEGB (a split penalty,
   coupled costs on four columns, lazy costs on four others), 10 rounds:
   AUC, the penalised columns' splits against (a)'s, the level passes per
   tree, a captured level's histogram (S = 255) checked; (c) leaf-wise
   with a three-level forced-splits JSON on three low-signal columns and
   ``monotone_constraints_method="advanced"`` on phase 12's columns, 10
   rounds: every tree's first seven nodes are the JSON's, the worst step
   along each constrained column >= -1e-6; (d) phase 11a's CSR draw cut
   to 100,000 rows (bundle columns on the leaf-wise grower), 3 rounds,
   predict on the CSR rows against the trainer's scores, and its first
   step's leaf_partition and leaf_hist checked as (a)'s are, at the
   bundle columns' widths;
15. serving on the card (``serve``): (a) phase 3's configuration trained
   for 200 rounds, served as ``live`` (binned routing through the
   training mappers) and from its model text as ``file`` (raw float32
   routing) by one ``PredictionService`` (max_batch_rows=1024,
   max_delay_ms=1, min_bucket_rows=16), warmed up, then bench.py's
   closed-loop stream (200 requests of 1-1024 float32 rows from
   RandomState(7), the models in turns): p50/p95/p99, exactly 1.0
   dispatch and one ``predict_pass`` launch per request, 0 compiles per
   1,000 requests, rows/s; the same 200 submitted at once (rows/s,
   requests per batch); (b) every response within rtol 1e-5, atol 1e-6
   of the float64 walk (the JAX package's serving tolerance), each
   model's routing equal to the walk's leaves (the float32 sums of the
   leaves' values bit for bit, and three one-tree engines), and where a
   request's time goes, from the closed loop's own ``serve_access``
   records (the engine's host encode, pinned staging, copy in, kernel and
   copy out, its dispatch, and per request the hand-off: the caller's
   wall time less the dispatch); (c) 20 rounds
   on 200,000 rows of phase 10's categorical codes, served through both
   variants (category masks on the card), its rows binned on the card
   against ``value_to_bin`` bit for bit; (d) ``Booster.predict`` on the
   1M rows, which takes the device predictor and bins the rows on the
   card: its seconds by part (the used columns on the host, the upload,
   the binning, the kernel), the device bins against ``value_to_bin`` on
   every row and on edge rows, bit for bit, against the float64 walk it
   replaced (the same tolerance, its raw scores the float32 sums of the
   walk's leaves, and faster than the walk in the same run); phases 3-14
   predict through ``walk_predict``, the float64 walk at any rows x
   trees, so their checks against predict keep a reference that does
   not bin the rows;
   (e) ``predict_pass`` against its plain version on the phase's operands
   (binned and raw at 1,024 and 65,536 rows, the categorical stacks of
   (c), a synthetic k = 3 stack, and (d)'s 1M rows): the same bits twice
   and equal to the plain version, time per launch, plain time, bound
   (the rows and the output, and of the stacks
   only the nodes, leaves and category-mask rows that some row reaches);
16. distributed training (``dist_train``): two ranks of the port
   (``parallel.spawn``), both on cuda:0 over gloo (one card; NCCL refuses
   two ranks on one device), each with its block of phase 3's draw cut to
   2 x 499,712 rows: (a) ``tree_learner=data``, fused, f32: identical
   model texts, trees of identical structure against the serial model on
   the same rows (the first must be), AUC within 1e-4; (b) the same with
   ``tpu_quantized_grad=16``: every tree exactly the serial quantized
   model's; (c) ``voting``, ``top_k=5``: AUC > 0.75 and the collective
   bytes per tree against (a)'s; (d) data-parallel on the XLA engine,
   leaf-wise, 3 rounds: ``leaf_partition`` and ``leaf_hist`` launched on
   each rank, trees against the serial XLA run; (e) at the grower level,
   rows replicated: the feature-parallel depth-wise XLA and fused trees
   equal the serial growers' to the last bit; (f) one rank over nccl:
   ``record_psum`` on a CUDA tensor, and ``tree_learner=data`` warns and
   trains phase 3's model. Each run prints per rank sec/iter, the device
   span per iteration, kernel launches, collective calls and bytes per
   tree and the collectives' share of the wall time (gloo's host-staged
   round trips);
17. the ``kernels`` line: every ported kernel and variant with its
   wrapper calls and CUDA kernel launches on the main path where it runs
   (every level_pass, route_pass, epilogue_pass and hist_pass call in
   phases 3-13 held to one launch of each of its CUDA kernels), its
   launches in phase 7's runs (a), (c) and (d), in phase 8's, 9's,
   10's, 11's, 12's and 13's runs, error, time per launch, plain time,
   bound and library time, the bundled rows on each phase-11 run's own
   operands with that run's launches and on phase 2's Bc_p = 16384
   layout with none, the ``mono`` rows on each phase-12 run's own
   operands, the ``dart`` rows on 13a's, the unrounded ``hist_pass`` rows
   on 14a's (a root) and 14b's with their launches, ``leaf_partition``
   and ``leaf_hist`` on 14a's step with 14a's launches, and per-kernel
   times of
   ``level_pass``, ``epilogue_pass`` and ``hist_pass``, and the
   ``predict_pass`` rows of phase 15 with their launches there, and
   each kernel's launches per rank in phase 16's runs;
18. the last line: ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package. It exits non-zero when no CUDA
device is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
ROWS = 1_000_000
FEATURES = 28
ROUNDS = 10
# bench.py's generator draws the label weights after the rows, so they
# depend on the row count: at 1,000,000 x 28 seed 0 makes 29 positive rows,
# seed 1 makes 34% positive
DATA_SEED = 1
DEVICE = "cuda"   # the card; a rehearsal on the CPU may set "cpu"
UPDATES = 10
VALID_ROWS = 250_000     # phase 7's and phase 8's valid set
CLASS_GROUPS = [list(range(14)), list(range(14, 28))]   # phase 8 run (d)
WARMUP_UPDATES = 2
TRAIN_PATH_KERNELS = ("level_pass", "route_pass", "table_lookup")
FRONTIER_KERNELS = ("hist_pass",)
# bench.py's all-cuts leg: columns 14-27 floored to 8 levels (8 bins each)
NARROW_FROM = 14
PLANE_NUM_BIN = np.array([63] * NARROW_FROM + [8] * (28 - NARROW_FROM),
                         np.int32)
SCREENING = {"tpu_gain_screening": True, "tpu_screening_warmup": 2,
             "tpu_screening_explore_period": 4}
KNOBS = {"tpu_quantized_grad": 16, "tpu_adaptive_bins": True, **SCREENING}
# phase 6: (a) the yardstick, (b) tests/test_hist_plane.py's KNOBS, (c)
# quant8 alone, and each of (b)'s cuts alone: (d) quant16, (e) adaptive
# bins, (f) gain screening
PLANE_RUNS = (("a", {}), ("b", KNOBS), ("c", {"tpu_quantized_grad": 8}),
              ("d", {"tpu_quantized_grad": 16}),
              ("e", {"tpu_adaptive_bins": True}), ("f", SCREENING))
# the level_pass variants checked on the mixed layout, as (quant_bits,
# packed, masked); each row of the kernels line pairs a variant's check
# with the phase-6 run whose every level_pass launch is that variant
PLANE_VARIANTS = ((0, False, False), (8, False, False), (16, False, False),
                  (0, True, False), (0, False, True), (16, True, True))
VARIANT_RUNS = {"quant8": "c", "quant16": "d", "packed": "e", "fmask": "f",
                "quant16+packed+fmask": "b"}
# phase 9: MS-LTR-shaped ranking (BASELINE.md's MS-LTR row, the
# reference's docs/Experiments.rst:150): 136 dense features, queries of
# 1-240 documents, grades 0-4 in MSLR-WEB30K's 52/32/13/2/1% skew, cut from
# its 2,270,296 documents to fit the smoke's time limit
RANK_DOCS = 1_000_000
RANK_VALID_DOCS = 200_000
RANK_FEATURES = 136
RANK_MAX_DOCS = 240
RANK_GRADES = (0.52, 0.84, 0.97, 0.99)
RANK_EVAL_AT = [1, 3, 5, 10]
RANK_CV_ROUNDS = 3
# phase 10: columns 0-3 of phase 3's rows as category codes; 3 categories
# is under max_cat_to_onehot=4 (one-vs-rest splits), the others take the
# sorted-subset scan
CAT_CARDINALITIES = (3, 12, 31, 60)
CAT_CLASS_ROUNDS = 3
BUNDLE_WIDTHS = (256, 512, 4096, 16384)     # phase 2's bundled layouts
SPARSE_ROWS = 1_000_000         # phase 11a: Allstate-shaped CSR draw
SPARSE_DENSE = 28
SPARSE_FIELDS, SPARSE_LEVELS = 30, 140      # 4,200 one-hot columns
EFB_ROWS = 500_000              # phases 11b and 11c
EFB_VALID_ROWS = 100_000
EFB_EXCLUSIVE = 512             # phase 11b: 28 dense + 512 exclusive
WIDE_MEMBERS = 64               # phase 11c: 64 x 63 bins -> one column
WIDE_UPDATES = 5
CAPTURE_LEVEL_CALL = 6          # phases 11, 12: the level_pass call checked
# each of 11c's 64 columns moves 1/65 of the rows, and a level-wise tree
# of depth 8 tests at most 8 of them on a path: 0.70 after 3 updates at
# 30,000 rows on the CPU, bundled or not
WIDE_AUC_FLOOR = 0.6
MONO_COLUMNS = 8                # phase 12: the constrained columns
MONO_BASE_ROWS = 64             # phase 12's monotonicity sweep: base rows
MONO_GRID = 200                 # and grid points along each column
MONO_PENALTY = 2.0              # phase 12c
API_ROWS = 100_000              # phase 12d: pred_leaf, early stop, refit
EARLY_STOP_FREQ = 2
DART_ROUNDS = 20                # phase 13a
DART_DROP_SEED = 4
RF_ROUNDS = 10                  # phase 13b
LINEAR_ROUNDS = 10              # phase 13c
CAPTURE_FIT_CALL = 3            # phase 13c: the linear fit checked (tree 5)
CHECK_ROWS = 100_000            # phase 13: rows predict is held to
SHAP_ROWS = 100_000             # phase 13d: the device form's rows
SHAP_PLAIN_ROWS = 200           # and the plain form's
CAPTURE_XLA_CALL = 100          # phase 14a: the leaf-wise step checked (its
#                                 leaf_partition and leaf_hist calls)
CAPTURE_XLA_ROOT = 1            # phase 14a: the hist_pass call checked (a
#                                 tree's root, S = 1)
CAPTURE_DEPTH_CALL = 5          # phase 14b: a level's hist_pass (S = L)
FUSED_LEAFWISE_ROUNDS = 2       # phase 14a: fused + leafwise against xla
CEGB_SPLIT = 1e-5               # phase 14b: cost per split and leaf row,
CEGB_COUPLED = 1e3              # per first use of a coupled column,
CEGB_LAZY = 1e-2                # per row first using a lazy column
XLA_CSR_ROWS = 100_000          # phase 14d: phase 11a's draw, cut
CAPTURE_CSR_CALL = 1            # phase 14d: the leaf-wise step checked (the
#                                 first: a child of about half the rows, on
#                                 the bundle columns)
XLA_CSR_ROUNDS = 3
# the unrounded variant replaces no pallas_call: the XLA engine's histogram
XLA_REPLACES = "lightgbm_tpu/ops/histogram.py:71 (build_histograms)"
# the leaf-wise step's two row passes (phase 14a, csrc/data_partition.cu):
# neither replaces a pallas_call
LIST_REPLACES = {
    "leaf_partition": "lightgbm_tpu/models/learner.py:735 (grow_tree_"
                      "leafwise's partition: jnp.where over all R rows)",
    "leaf_hist": "lightgbm_tpu/ops/histogram.py:71 (build_histograms at one "
                 "slot: the leaf-wise step's smaller child, learner.py:741)"}
BUNDLED_COLUMNS = 88            # phase 11a's bundle columns
SERVE_ROUNDS = 200              # phase 15: the served model's trees
SERVE_REQUESTS = 200            # bench.py's serve stream (bench.py:1092)
SERVE_MAX_BATCH = 1024          # request sizes 1..1024, the largest bucket
SERVE_MIN_BUCKET = 16
SERVE_SEED = 7
SERVE_CAT_ROWS = 200_000        # phase 15c: phase 10's codes, cut
SERVE_CAT_ROUNDS = 20
SERVE_CHECK_BUCKETS = (1024, 65_536)    # phase 15e's operands
DIST_ROWS = 2 * 499_712         # phase 16: two unpadded rank blocks
DIST_WORLD = 2                  # phase 16: ranks, both on cuda:0 (gloo)
DIST_TOP_K = 5                  # phase 16c: 10 of 28 columns exchanged
DIST_XLA_ROUNDS = 3             # phase 16d
DIST_DEADLINE_S = 600           # phase 16: the parent kills the ranks after
DIST_TIMEOUT_S = 120            # phase 16: every group's collective timeout
# served probabilities against the float64 walk: the JAX package's serving
# tolerance for float32 sums (tests/test_serve.py); the routing itself is
# held exactly, to the float32 sums of the walk's leaves
SERVE_RTOL = {"rtol": 1e-5, "atol": 1e-6}
SERVE_TOL = "rtol=1e-5 atol=1e-6"
# predict_pass replaces no pallas_call: the JAX package's stacked traversal
PREDICT_REPLACES = ("lightgbm_tpu/models/predictor.py:69 (_run_binned_body)"
                    ", :93 (_run_raw_body)")
REPLACES = {
    "level_pass": "lightgbm_tpu/ops/fused_level.py:402",
    "route_pass": "lightgbm_tpu/ops/fused_level.py:575",
    "table_lookup": "lightgbm_tpu/ops/fused_level.py:811",
    "epilogue_pass": "lightgbm_tpu/ops/fused_level.py:641",
    "hist_pass": "lightgbm_tpu/ops/pallas_histogram.py:60",
}
SOURCES = {
    "level_pass": "lightgbm_tpu_torch/csrc/level_pass.cu",
    "route_pass": "lightgbm_tpu_torch/csrc/route_pass.cu",
    "table_lookup": "lightgbm_tpu_torch/csrc/table_lookup.cu",
    "epilogue_pass": "lightgbm_tpu_torch/csrc/epilogue_pass.cu",
    "hist_pass": "lightgbm_tpu_torch/csrc/hist_pass.cu",
    "predict_pass": "lightgbm_tpu_torch/csrc/predict_pass.cu",
    "leaf_partition": "lightgbm_tpu_torch/csrc/data_partition.cu",
    "leaf_hist": "lightgbm_tpu_torch/csrc/data_partition.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _make_data(n_rows: int, n_feat: int, seed: int = 0,
               with_w: bool = False):
    # the synthetic binary data of bench.py (copied, not imported); with
    # ``with_w`` also the labelling function's weights
    rng = np.random.RandomState(seed)
    X = rng.rand(n_rows, n_feat).astype(np.float32)
    w = rng.randn(n_feat).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(n_rows) > 0).astype(np.float32)
    return (X, y, w) if with_w else (X, y)


def _valid_rows(n_rows: int, w: np.ndarray, seed: int):
    """Rows drawn from the labelling function ``w`` of a _make_data
    draw."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_rows, len(w)).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(n_rows) > 0).astype(np.float32)
    return X, y


# timings that could not be captured in a CUDA graph (see cuda_ms)
timing_notes = []


def cuda_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per launch (ms): ``reps`` calls of ``fn`` captured in one
    CUDA graph, replayed ``replays`` times between two CUDA events; the
    median replay over ``reps``. The wrappers launch on the current stream
    and allocate only through torch, so they capture, and their host time
    (argument checks, allocation, the ctypes call) stays out of the window.
    A function that cannot be captured is timed as ``reps`` back-to-back
    calls between two events instead, and ``timing_notes`` says so."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):          # the library, attributes, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    except RuntimeError as e:
        torch.cuda.synchronize()
        timing_notes.append(f"{getattr(fn, '__name__', fn)}: not capturable "
                            f"({str(e).splitlines()[0][:120]}); timed as "
                            f"{reps} back-to-back calls between two events")

        def run():
            for _ in range(reps):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def call_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms): one event pair around one
    host call, so the window holds the call's host time too. The plain
    versions are timed so (they sync on the host), and table_lookup and
    its yardstick also so, beside their graph times, to show what the
    host's share of one call is."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# the template instances' arguments in ptxas's mangled names (an int
# argument as its value, a bool as true or false)
_MANGLED_TYPES = {"a": "int8", "s": "int16", "13__nv_bfloat16": "bf16",
                  "f": "f32", "i": "int32", "NS_6RawF32E": "f32_unrounded"}
_MANGLED = r"(a|s|f|i|13__nv_bfloat16|NS_6RawF32E|L[ib]\d+E)"


def _demangled_arg(t: str) -> str:
    if t.startswith("Li"):
        return t[2:-1]
    if t.startswith("Lb"):
        return "true" if t[2] == "1" else "false"
    return _MANGLED_TYPES[t]


def ptxas_summary(report: str):
    """Each kernel instance of nvcc's ``-Xptxas -v`` report: registers,
    static shared memory bytes and spill bytes."""
    import re
    out = []
    for block in report.split("Compiling entry function")[1:]:
        m = re.search(r"lgbt\d+(\w+?_kernel)(?:I" + _MANGLED + _MANGLED
                      + "?" + _MANGLED + r"?E)?", block)
        used = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                         block, re.M)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if not (m and used):
            continue
        args = [_demangled_arg(t) for t in m.groups()[1:] if t]
        out.append({"kernel": m.group(1) + (f"<{','.join(args)}>"
                                            if args else ""),
                    "registers": int(used.group(1)),
                    "smem_bytes": int(used.group(2) or 0),
                    "spill_bytes": int(spill.group(1)) + int(spill.group(2))
                    if spill else 0})
    return out


def walk_predict(bst, X, **kw):
    """``bst.predict`` on the exact float64 walk, whatever its rows x
    trees: the checks of phases 3-14 hold the trainer to it as a reference
    of its own. At or above ``pred_device_min_work`` predict takes the
    float32 stacked predictor, which bins the rows with the trainer's own
    mappers, so a binning or binned-routing fault would show on both
    sides and pass; phase 15 drives that predictor and holds it to the
    walk."""
    bst._pred_device_min_work = lambda: float("inf")
    try:
        return bst.predict(X, **kw)
    finally:
        del bst._pred_device_min_work


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_stages(launches, cuda, run) -> None:
    """Every level_pass, route_pass, epilogue_pass, hist_pass,
    leaf_partition and leaf_hist call launched each CUDA kernel of its
    stages once, as the C entries report each launch (``cuda_launches``;
    hist_pass: at most 512 slots, one window)."""
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import fused_level as fl
    for wrapper, kernels in (("level_pass", fl.LEVEL_KERNELS),
                             ("route_pass", fl.ROUTE_KERNELS),
                             ("epilogue_pass", fl.EPILOGUE_KERNELS),
                             ("hist_pass", fl.HIST_KERNELS),
                             ("leaf_partition", dp.PARTITION_KERNELS),
                             ("leaf_hist", dp.LEAF_HIST_KERNELS)):
        got = {k: cuda.get(k, 0) for k in kernels}
        if got != dict.fromkeys(kernels, launches.get(wrapper, 0)):
            raise AssertionError(f"{run}: {launches[wrapper]} {wrapper} "
                                 f"calls launched the CUDA kernels {got}")


def kernel_cuda_launches(name, cuda):
    """The CUDA kernel launches of one wrapper in a run's counts."""
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import fused_level as fl
    kernels = {"level_pass": fl.LEVEL_KERNELS,
               "route_pass": fl.ROUTE_KERNELS,
               "epilogue_pass": fl.EPILOGUE_KERNELS,
               "hist_pass": fl.HIST_KERNELS,
               "leaf_partition": dp.PARTITION_KERNELS,
               "leaf_hist": dp.LEAF_HIST_KERNELS}.get(name, (name,))
    return {k: cuda.get(k, 0) for k in kernels}


def odd_route_table(W, slabs, seed):
    """The route table with slot 0's row spread over a second kernel row's
    slab and slot 2's row all zero (``slabs``: each kernel row's offset
    and width): any 0/1 W must route as the full W @ one-hot sum does,
    though the grower's has one slab per row."""
    W = W.clone()
    K = len(slabs)
    j0 = next(j for j, (o, w) in enumerate(slabs) if bool(W[0, o:o + w].any()))
    o, w = slabs[(j0 + 1 + seed % (K - 1)) % K]
    W[0, o:o + max(1, w // 2)] = 1
    W[2] = 0
    return W


def kernel_slabs(K, B, pk):
    """(offset, width) of each kernel row's slab on the flat axis."""
    if pk is not None:
        return [(int(o), int(w)) for o, w in zip(pk.flat_offsets, pk.widths)]
    return [(j * B, B) for j in range(K)]


def sass_hist_ops(lib_path):
    """How many tensor-core (HMMA), shared-atomic (ATOMS), global-atomic
    (RED, ATOMG) and shared load/store and f32 add instructions each
    epilogue_hist_kernel instance of the built library holds (cuobjdump
    -sass; bin type x channels x bin groups, 20 instances): the root
    histogram's adds as compiled."""
    import re
    from pathlib import Path
    from lightgbm_tpu_torch.ops import cuda_build
    tool = str(Path(cuda_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*epilogue_hist_kernelI(a|s)Li(\d)ELb(\d)E", block)
        if not m:
            continue
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         block, re.M)
        out[f"epilogue_hist_kernel<{_MANGLED_TYPES[m.group(1)]},"
            f"{m.group(2)},{'true' if m.group(3) == '1' else 'false'}>"] = {
            op: ops.count(op) for op in ("HMMA", "ATOMS", "RED", "ATOMG",
                                         "LDS", "STS", "FADD", "LDGSTS")}
    return out


def sass_hist_pass_atomics(lib_path):
    """Every atomic instruction (with its modifiers) of each kernel of
    hist_pass in the built library (cuobjdump -sass), by mangled name."""
    import re
    from pathlib import Path
    from lightgbm_tpu_torch.ops import cuda_build
    tool = str(Path(cuda_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(r"lgbt\d+hist_(count|scan|bucket|tiles|reduce)_"
                         r"kernel", name):
            continue
        out[name] = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                               r"((?:ATOM|RED)[A-Z0-9_.]*)", block, re.M)
    return out


def hist_atomics_ok(atomics) -> bool:
    """hist_pass adds with no f32 atomic: none in its f32 instances (their
    tiles are private to a warp), and in the int32 ones (AccT = int,
    ``IiL`` in the mangled tile kernel) only native shared-memory integer
    adds — no compare-and-swap loop (ATOMS.CAST.SPIN), no global atomic."""
    for name, ops in atomics.items():
        int32 = "hist_tiles_kernelIi" in name
        for op in ops:
            if not (int32 and op.startswith("ATOMS.") and "CAS" not in op
                    and "CAST" not in op):
                return False
    return bool(atomics)


def _level_inputs(Rp, R, num_bin, B, Sp, nch, seed, quant_bits=0,
                  packed=False):
    """Random level-pass operands: feature f's bins in [0, num_bin[f]),
    every real row in one of Sp leaves, Sp-1 active slots on random
    features (the last inactive), missing types None/Zero/NaN, ~30% zero
    bag weights; padding rows at leaf -1 with zero channels. ``quant_bits``
    packs the int8 channels (nch from quantize.QNCH); ``packed`` lays the
    rows out on the adaptive layout (bins_T's rows in feat_order, the route
    table re-indexed), and the same seed gives the same rows in both
    layouts. Returns ((bins_T, leaf_T, gh_T, W, tbl), the wrappers'
    keywords)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops import layout
    from lightgbm_tpu_torch.ops.quantize import QNCH
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = np.asarray(num_bin, np.int32)
    F = len(nb)
    mt = rng.randint(0, 3, F).astype(np.int32)
    db = (rng.rand(F) * (nb - 1)).astype(np.int32)
    nb_t = torch.as_tensor(nb, device=dev)
    bins = (torch.rand((F, Rp), generator=gen, device=dev)
            * nb_t[:, None]).to(torch.int8 if B <= 128 else torch.int16)
    bins[:, R:] = 0
    leaf = torch.randint(0, Sp, (Rp,), generator=gen, device=dev,
                         dtype=torch.int32)
    leaf[R:] = -1
    w = (torch.rand(Rp, generator=gen, device=dev) >= 0.3).float()
    w[R:] = 0
    g = torch.randn(Rp, generator=gen, device=dev) * w
    h = torch.rand(Rp, generator=gen, device=dev) * 0.25 * w
    if quant_bits:
        nch = QNCH[quant_bits]
        gh_T, _ = fl.pack_gh_quant(g, h, w, quant_bits, seed=seed)
    else:
        gh_T = fl.pack_gh(g, h, w, nch)
    lof = np.arange(Sp, dtype=np.int32)
    lof[-1] = -2
    feat = np.where(lof >= 0, rng.randint(0, F, Sp), -1).astype(np.int32)
    thr = (rng.rand(Sp) * (nb[np.maximum(feat, 0)] - 1)).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    W = fl.build_route_table(t(feat), t(thr), t(dl), nb_t, t(mt), t(db),
                             Sp, F, B)
    pk = None
    if packed:
        pk = layout.packed_feature_layout(nb, B - 1, f_oh=F)
        bins = bins[list(pk.feat_order)]
        W = fl.pack_route_table(W, pk)
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = lof
    tbl[:, 1] = np.where(lof >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    kw = dict(num_bins=B, f_oh=F, nch=nch, quant_bits=quant_bits, packed=pk)
    return (bins.contiguous(), leaf[None, :], gh_T, W, t(tbl)), kw


def _route_slabs(W, K, B, pk, keep):
    """[Sp] int64: how many kernel rows' slabs of each W row hold a
    non-zero (outside ``keep``, if given, nothing routes)."""
    import torch
    dev = W.device
    owner = torch.full((W.shape[1],), -1, dtype=torch.long, device=dev)
    for j in range(K):
        st, w = (int(pk.flat_offsets[j]), pk.widths[j]) if pk is not None \
            else (j * B, B)
        owner[st:st + w] = j
    nz = W != 0
    if keep is not None:
        nz &= keep[None, :]
    hit = torch.zeros((W.shape[0], K + 1), dtype=torch.bool, device=dev)
    rows, cols = torch.nonzero(nz, as_tuple=True)
    hit[rows, owner[cols] + 1] = True
    return hit[:, 1:].sum(1)


def _n_small(leaf_T, new_leaf, tbl) -> int:
    """Rows this level histograms: in an active slot's leaf and on the
    side of its smaller child."""
    member = leaf_T[0][None, :] == tbl[:, 0][:, None]
    left = (new_leaf[0] == leaf_T[0])[None, :]
    return int((member & (left == (tbl[:, 2] > 0)[:, None])).any(0).sum())


def cat_route_table(W, slabs, tbl, seed):
    """The grower's route table with every active slot's row replaced by a
    categorical left set on its own slab: a random set of bins with holes
    inside the slab, bin 0 (NaN/other) always out, as
    ``best_categorical_split_cm`` makes them."""
    import torch
    W = W.clone()
    gen = torch.Generator(device=W.device).manual_seed(seed)
    for k in range(W.shape[0]):
        if int(tbl[k, 0]) < 0:
            continue
        o, w = next((o, w) for o, w in slabs if bool(W[k, o:o + w].any()))
        keep = torch.rand(w, generator=gen, device=W.device) < 0.4
        keep[:4] = torch.tensor([False, True, False, True])   # slabs >= 4
        W[k, o:o + w] = keep.to(W.dtype)
    return W


def has_holes(W, slabs):
    """[Sp] bool: the W row's non-zero bins on one slab leave bin 0 out and
    are not one run (a categorical left set, never a threshold's)."""
    import torch
    out = torch.zeros(W.shape[0], dtype=torch.bool, device=W.device)
    for o, w in slabs:
        nz = W[:, o:o + w] != 0
        cnt = nz.sum(1)
        idx = torch.arange(w, device=W.device)
        first = torch.where(nz, idx, w).min(1).values
        last = torch.where(nz, idx, -1).max(1).values
        out |= (cnt > 0) & (first > 0) & (last - first + 1 > cnt)
    return out


def level_hist_rel_err(hist_k, hist_p, Sp, nch, what):
    """The largest f32 plane error over the plane's largest magnitude
    (atomics reorder the sums: held to 1e-5); the weight channel (the
    last) exact."""
    rel = 0.0
    for ch in range(nch):
        k = hist_k[:, ch * Sp:(ch + 1) * Sp]
        p = hist_p[:, ch * Sp:(ch + 1) * Sp]
        err = float((k - p).abs().max())
        if ch == nch - 1:
            if err != 0.0:
                raise AssertionError(f"{what}: weight channel differs by "
                                     f"{err}")
        else:
            rel = max(rel, err / (float(p.abs().max()) or 1.0))
    if rel > 1e-5:
        raise AssertionError(f"{what}: hist rel err {rel} > 1e-5")
    return rel


def check_level_tables(ops, fm, kw, what):
    """level_pass and route_pass against their plain versions on one set
    of operands (route_pass_plain is the full W @ one-hot sum): new
    leaves equal, f32 planes as ``level_hist_rel_err`` holds them, int32
    planes exact. Returns the f32 planes' relative error (0 for int32)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    bins_T, leaf_T, gh_T, W, tbl = ops
    rkw = {k: kw[k] for k in ("num_bins", "f_oh", "packed")}
    hist_k, leaf_k = fl.level_pass(*ops, fm, **kw)
    hist_p, leaf_p = fl.level_pass_plain(*ops, fm, **kw)
    route_k = fl.route_pass(bins_T, leaf_T, W, tbl, **rkw)
    route_p = fl.route_pass_plain(bins_T, leaf_T, W, tbl, **rkw)
    torch.cuda.synchronize()
    # (a masked slab routes nothing in level_pass; route_pass takes no
    # mask)
    if not (torch.equal(leaf_k, leaf_p) and torch.equal(route_k, route_p)
            and (fm is not None or torch.equal(route_k, leaf_p))):
        raise AssertionError(f"{what}: new leaves differ")
    if kw["quant_bits"]:
        if not torch.equal(hist_k, hist_p):
            raise AssertionError(f"{what}: int32 planes differ")
        return 0.0
    return level_hist_rel_err(hist_k, hist_p, W.shape[0], kw["nch"], what)


def check_level(Rp, R, num_bin, B, Sp, seed, nch=5, quant_bits=0,
                packed=False, masked=False):
    """level_pass and route_pass against their plain versions on the card,
    padded f32 or one combination of the histogram-plane cuts: new leaves
    equal; f32 planes within 1e-5 of the plane's largest magnitude (atomics
    reorder the sums) with the weight channel exact; int32 planes
    (``quant_bits``) bit-exact, and equal to the other layout's on the same
    rows after unpacking; ``masked``: the grower's screening mask with half
    the features off (logical feature 0 and the first kernel row's feature
    kept on), their slabs exactly zero."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    ops, kw = _level_inputs(Rp, R, num_bin, B, Sp, nch, seed, quant_bits,
                            packed)
    bins_T, leaf_T, gh_T, W, tbl = ops
    pk, nch, F = kw["packed"], kw["nch"], len(num_bin)
    dev = bins_T.device
    fm = None
    if masked:
        fm = torch.arange(F, device=dev) % 2 == 0
        fm[0] = True
        fm[pk.feat_order[0] if pk is not None else 0] = True
    rkw = dict(num_bins=B, f_oh=F, packed=pk)
    variant = fl.variant_name(quant_bits, packed, masked)
    n0 = dict(fl.launches)
    v0 = dict(fl.variant_launches)
    c0 = dict(fl.cuda_launches)
    hist_k, leaf_k = fl.level_pass(*ops, fm, **kw)
    route_k = fl.route_pass(bins_T, leaf_T, W, tbl, **rkw)
    launched = {k: fl.launches[k] - n0[k] for k in n0
                if fl.launches[k] != n0[k]}
    launched.update({k: fl.variant_launches[k] - v0[k] for k in v0
                     if fl.variant_launches[k] != v0[k]})
    cuda_launched = {k: fl.cuda_launches[k] - c0[k] for k in c0
                     if fl.cuda_launches[k] != c0[k]}
    hist_p, leaf_p = fl.level_pass_plain(*ops, fm, **kw)
    route_p = fl.route_pass_plain(bins_T, leaf_T, W, tbl, **rkw)
    hist_again, _ = fl.level_pass(*ops, fm, **kw)
    torch.cuda.synchronize()
    if not torch.equal(hist_again, hist_k):
        raise AssertionError(f"level_pass[{variant}] planes differ between "
                             f"two calls (B={B} Sp={Sp})")
    if not torch.equal(leaf_k, leaf_p):
        raise AssertionError(f"level_pass[{variant}] new_leaf differs "
                             f"(B={B} Sp={Sp})")
    if not torch.equal(route_k, route_p):
        raise AssertionError(f"route_pass new_leaf differs (B={B} Sp={Sp} "
                             f"packed={packed})")
    # any 0/1 route table: a row over two slabs, an all-zero row
    K_rows = len(pk.feat_order) if pk is not None else F
    W_odd = odd_route_table(W, kernel_slabs(K_rows, B, pk), seed)
    if not torch.equal(fl.route_pass(bins_T, leaf_T, W_odd, tbl, **rkw),
                       fl.route_pass_plain(bins_T, leaf_T, W_odd, tbl,
                                           **rkw)):
        raise AssertionError(f"route_pass new_leaf differs on a W over "
                             f"several slabs (B={B} Sp={Sp} packed={packed})")
    # categorical left sets: holes inside each slab, bin 0 out
    slabs = kernel_slabs(K_rows, B, pk)
    W_cat = cat_route_table(W, slabs, tbl, seed)
    if not bool(has_holes(W_cat, slabs)[tbl[:, 0] >= 0].all()):
        raise AssertionError("cat_route_table made a row without holes")
    cat_rel = check_level_tables((bins_T, leaf_T, gh_T, W_cat, tbl), fm, kw,
                                 f"level_pass[{variant}] on a categorical "
                                 f"W (B={B} Sp={Sp})")
    out = {"variant": variant, "B": B, "Sp": Sp, "nch": nch,
           "bins": str(bins_T.dtype).replace("torch.", ""),
           "num_bin": sorted({int(v) for v in num_bin}), "FB": W.shape[1],
           "launches": launched, "cuda_launches": cuda_launched,
           "route_pass_equal_on": ["grower W", "W with a row over two "
                                   "slabs and an all-zero row",
                                   "categorical W (holes, bin 0 out)"],
           "categorical_W_hist_max_rel_err": cat_rel,
           "same_bits_on_two_calls": True}
    abs_err = float((hist_k.double() - hist_p.double()).abs().max())
    if quant_bits:
        if not torch.equal(hist_k, hist_p):
            raise AssertionError(f"level_pass[{variant}] int32 planes "
                                 f"differ by {abs_err} (Sp={Sp})")
        # the same rows on the other layout: equal after unpacking
        ops2, kw2 = _level_inputs(Rp, R, num_bin, B, Sp, nch, seed,
                                  quant_bits, not packed)
        hist2, leaf2 = fl.level_pass(*ops2, fm, **kw2)
        pk_ = pk if packed else kw2["packed"]
        hist_pk, hist_pd = (hist_k, hist2) if packed else (hist2, hist_k)
        if not (torch.equal(fl.unpack_packed_flat(hist_pk, pk_), hist_pd)
                and torch.equal(leaf2, leaf_k)):
            raise AssertionError(f"level_pass[{variant}] packed differs "
                                 "from padded after unpack")
        out.update(tol="exact", packed_equals_padded_after_unpack=True)
    else:
        rel = level_hist_rel_err(hist_k, hist_p, Sp, nch,
                                 f"level_pass[{variant}]")
        out.update(hist_max_rel_err=rel, tol="rel 1e-5 of the plane max; "
                   "weight channel exact")
    if fm is not None:
        if hist_k[~fl.expand_feature_mask(fm, F, B, pk)].any():
            raise AssertionError(f"level_pass[{variant}] masked slabs not "
                                 "zero")
        out["masked_slabs_zero"] = True

    # bytes each function must move on this run's rows (each read once):
    # the leaf in and the new leaf out of every row; for each slotted row
    # the bins of the kernel rows its slot's W row routes on (one, the
    # split slab, as the grower builds W; masked slabs route nothing); the
    # nch channels of the smaller-child rows (to find the live ones); the
    # remaining live bins of the marked rows (smaller child, a non-zero
    # channel); W, tbl, the layout tables and the mask; the histogram out.
    # ops: one compare per routing bin, nch adds per live kernel row of
    # each marked row. route_pass: the leaf in and out, the routing bins
    # (unmasked), W, tbl and the layout tables.
    K = bins_T.shape[0]
    bb, chb = bins_T.element_size(), gh_T.element_size()
    k_live = K if fm is None else int(fm[list(pk.feat_order)].sum()
                                      if pk is not None else fm.sum())
    keep = (fl.expand_feature_mask(fm, F, B, pk) if fm is not None
            else torch.ones(W.shape[1], dtype=torch.bool, device=dev))
    route_slabs = _route_slabs(W, K, B, pk, None)          # [Sp]
    mark_slabs = _route_slabs(W, K, B, pk, keep)
    slot = torch.full_like(leaf_T[0], -1)
    for k in range(Sp):
        slot[leaf_T[0] == tbl[k, 0]] = k
    in_slot = int((slot >= 0).sum())
    per_slot = torch.bincount(slot[slot >= 0].long(), minlength=Sp)
    n_small = _n_small(leaf_T, leaf_p, tbl)
    marked = fl.slot_counts(fl.level_mark_plain(*ops, fm, **kw)[2],
                            Rp).long()                       # per slot
    n_marked = int(marked.sum())
    route_bins = int((per_slot * route_slabs).sum())
    mark_bins = int((per_slot * mark_slabs).sum())
    hist_bins = int((marked * (k_live - mark_slabs)).sum())
    tables = W.numel() * 2 + tbl.numel() * 4 + (K * 8 if pk else 0)
    lvl_bound, lvl_by = bound(
        Rp * 8 + (mark_bins + hist_bins) * bb + n_small * nch * chb + tables
        + (K if fm is not None else 0) + hist_p.numel() * 4,
        mark_bins + n_marked * k_live * nch)
    rt_bound, rt_by = bound(Rp * 8 + route_bins * bb + tables, route_bins)
    out.update(marked_rows=n_marked, routing_bins=mark_bins)
    out.update(slotted_rows=in_slot, smaller_child_rows=n_small,
               live_kernel_rows=k_live)
    # the tiles stage's shape: Cw kernel rows per group (32 // Cw lanes
    # each), Bw bins per bin group, nch x nr warps' private tiles; the
    # staging record's bytes
    width = max(pk.widths) if pk is not None else B
    Cw, Bw, nr = fl.level_tile_shape(K_rows, width, nch,
                                     fl._smem_budget(dev))
    out["hist_tile"] = {"Cw": Cw, "Bw": Bw, "record_lanes": nr,
                        "width": width, "row_groups": -(-K_rows // Cw),
                        "bin_groups": -(-width // Bw),
                        "bytes": nch * nr * Bw * 32 * 4,
                        "record_bytes": fl.record_layout(
                            K_rows, bb, nch, chb)[1]}
    out["level_pass"] = {
        "max_abs_err": abs_err,
        "kernel_ms": cuda_ms(lambda: fl.level_pass(*ops, fm, **kw)),
        "plain_ms": call_ms(lambda: fl.level_pass_plain(*ops, fm, **kw),
                            reps=3, warmup=1),
        "library_ms": None, "bound_ms": lvl_bound, "bound_by": lvl_by}
    # each stage alone, through its own wrapper (level_mark's includes the
    # memset of its counts buffer, which the other two read as it is)
    _, row_slot, counts = fl.level_mark(*ops, fm, **kw)
    stage = fl.level_partition(bins_T, gh_T, row_slot, counts, **kw)
    out["level_pass"]["stages_ms"] = {
        "level_mark": cuda_ms(lambda: fl.level_mark(*ops, fm, **kw)),
        "level_partition": cuda_ms(lambda: fl.level_partition(
            bins_T, gh_T, row_slot, counts, **kw)),
        "level_hist": cuda_ms(lambda: fl.level_hist(
            stage, counts, fm, bin_bytes=bins_T.element_size(), **kw))}
    out["route_pass"] = {
        "max_abs_err": 0, "tol": 0,
        "kernel_ms": cuda_ms(lambda: fl.route_pass(bins_T, leaf_T, W, tbl,
                                                   **rkw)),
        "plain_ms": call_ms(lambda: fl.route_pass_plain(
            bins_T, leaf_T, W, tbl, **rkw), reps=3, warmup=1),
        "library_ms": None, "bound_ms": rt_bound, "bound_by": rt_by}
    return out


def check_lookup(Rp, R, L, seed):
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    idx = np.full(Rp, -1, np.int32)
    idx[:R] = rng.randint(0, L, R)
    idx_T = torch.as_tensor(idx[None, :], device=dev)
    table = torch.as_tensor(rng.randn(L).astype(np.float32), device=dev)
    n0 = fl.launches["table_lookup"]
    out_k = fl.table_lookup(idx_T, table)
    out_p = fl.table_lookup_plain(idx_T, table)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if err != 0.0:
        raise AssertionError(f"table_lookup differs by {err}")
    # the library yardstick computes the kernel's function: one
    # torch.take into the table with a zero appended at index L, through
    # an int64 index prepared beforehand with rows outside [0, L) mapped
    # to L (it reads 8 B of index per row, the kernel 4)
    table0 = torch.cat([table, table.new_zeros(1)])
    flat = torch.where((idx_T[0] >= 0) & (idx_T[0] < L), idx_T[0],
                       L).long()
    out_lib = torch.take(table0, flat)
    if not torch.equal(out_lib, out_p[0]):
        raise AssertionError("the torch.take yardstick differs from the "
                             "plain version")
    b, by = bound(Rp * 8 + L * 4, 0)
    return {
        "Rp": Rp, "L": L, "max_abs_err": err, "tol": 0,
        "launches": fl.launches["table_lookup"] - n0,
        "kernel_ms": cuda_ms(lambda: fl.table_lookup(idx_T, table)),
        "kernel_ms_per_call": call_ms(lambda: fl.table_lookup(idx_T,
                                                              table)),
        "plain_ms": call_ms(lambda: fl.table_lookup_plain(idx_T, table)),
        "library_ms": cuda_ms(lambda: torch.take(table0, flat)),
        "library_ms_per_call": call_ms(lambda: torch.take(table0, flat)),
        "library_call": "torch.take(table ++ [0], int64 index with rows "
                        "outside [0, L) mapped to L, prepared beforehand)",
        "bound_ms": b, "bound_by": by}


def check_epilogue(Rp, R, B, Sp, nch, kind, table, seed, L=255,
                   stages=False):
    """epilogue_pass against its plain version: rows in Sp leaves before
    the deferred route — ``table`` "grower" (the grower's W), "odd" (a W
    row over two slabs and an all-zero row) or "inactive" (an all-inactive
    table) —, a 255-entry leaf-value table (routed leaves past it add 0),
    ~30% zero bag weights, padding rows at leaf -1 with zero operands and
    bag. ``stages`` also times each of its CUDA kernels alone."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    dev = torch.device(DEVICE)
    (bins_T, leaf_T, _, W, tbl), _ = _level_inputs(
        Rp, R, np.full(FEATURES, B - 1, np.int32), B, Sp, nch, seed)
    if table == "odd":
        W = odd_route_table(W, kernel_slabs(FEATURES, B, None), seed)
    elif table == "categorical":
        W = cat_route_table(W, kernel_slabs(FEATURES, B, None), tbl, seed)
    elif table == "inactive":
        W = torch.zeros_like(W)
        tbl = tbl.clone()
        tbl[:, 0] = -2
    rng = np.random.RandomState(seed + 1)
    lv = torch.as_tensor((rng.randn(L) * 0.1).astype(np.float32), device=dev)
    score = np.zeros((1, Rp), np.float32)
    score[0, :R] = rng.randn(R)
    ops = np.zeros((8, Rp), np.float32)
    if kind == "binary":
        ops[0, :R] = np.where(rng.rand(R) < 0.4, 1.0, -1.0)
    else:
        ops[0, :R] = rng.randn(R) * 3.0
    ops[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, Rp), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    args = (bins_T, leaf_T, W, tbl, lv, t(score), t(ops), t(bag))
    kw = dict(num_bins=B, f_oh=FEATURES, nch=nch, kind=kind, sigmoid=1.0)
    n0 = fl.launches["epilogue_pass"]
    c0 = dict(fl.cuda_launches)
    errs, gh_p = compare_epilogue(args, kw)
    launched = fl.launches["epilogue_pass"] - n0
    cuda_launched = {k: fl.cuda_launches[k] - c0[k]
                     for k in fl.EPILOGUE_KERNELS}
    if launched != 1 or set(cuda_launched.values()) != {1}:
        raise AssertionError(f"epilogue_pass launched {launched} calls, "
                             f"CUDA kernels {cuda_launched}")

    # bytes: bins, leaf, score in/out, the two operand rows, bag, the 8
    # bf16 channels out, W, tbl, leaf values, the [FB, nch*8] histogram;
    # ops: the route's gather-adds for rows in a selected leaf, ~20 flops
    # of gradient and pack per row, F*nch adds per row with a non-zero
    # channel (this run's counts)
    bb = bins_T.element_size()
    in_slot = int((leaf_T[0][:, None] == tbl[:, 0][None, :]).any(1).sum())
    nonzero = int((gh_p[:nch].float() != 0).any(0).sum())
    nbytes = (Rp * (FEATURES * bb + 4 + 8 + 8 + 4 + 16) + W.numel() * 2
              + tbl.numel() * 4 + L * 4 + FEATURES * B * nch * 8 * 4)
    nops = in_slot * FEATURES + Rp * 20 + nonzero * FEATURES * nch
    b_ms, b_by = bound(nbytes, nops)
    out = {}
    if stages:
        # each CUDA kernel alone on the same inputs, into one set of
        # buffers filled by a whole call first (the pass reads the slab
        # table, the reduce the partial histograms)
        buf = fl.epilogue_buffers(bins_T, Sp, num_bins=B, f_oh=FEATURES,
                                  nch=nch)
        fl._epilogue_launch(fl.EPILOGUE_KERNELS, *args, buf, **kw)

        def stage(kernel):
            return lambda: fl._epilogue_launch((kernel,), *args, buf, **kw)
        out["stages_ms"] = {k: cuda_ms(stage(k)) for k in fl.EPILOGUE_KERNELS}
        out["row_blocks"] = buf["blocks"]
    return {
        "B": B, "bins": str(bins_T.dtype).replace("torch.", ""), "Sp": Sp,
        "nch": nch, "kind": kind, "deferred_table": table,
        "launches": launched, "cuda_launches": cuda_launched, **out, **errs,
        "kernel_ms": cuda_ms(lambda: fl.epilogue_pass(*args, **kw)),
        "plain_ms": call_ms(lambda: fl.epilogue_pass_plain(*args, **kw),
                            reps=3, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def _root_hist64(bins_T, gh, B, F, nch, absolute=False):
    """[F*B, nch] float64 root histogram of the channels ``gh`` (or of their
    magnitudes): every row's value added to its bin's cell of each
    feature."""
    import torch
    dev = bins_T.device
    out = torch.zeros(F * B * nch, dtype=torch.float64, device=dev)
    vals = gh[:nch].double()
    if absolute:
        vals = vals.abs()
    for f in range(F):
        cell = (f * B + bins_T[f].long()) * nch
        out.index_add_(0, (cell[None, :] + torch.arange(
            nch, device=dev)[:, None]).reshape(-1), vals.reshape(-1))
    return out.reshape(F * B, nch)


def compare_epilogue(args, kw, float64_hist=False):
    """epilogue_pass against its plain version on one set of operands:
    new scores within rtol 1e-6, decoded channels within rtol 4e-5, atol
    1e-7, histogram slots 1-7 zero, the weight channel exact, the g/h
    planes within 1e-5 of each plane's largest sum of |values| per cell,
    against the plain version's planes, or with ``float64_hist`` against
    the float64 sum of the kernel's own channels (the plain version's f32
    sums are then held to the same bar against theirs where they meet it,
    and reported). The float64 reference serves real trees' operands:
    at a tree's first epilogue every row holds the init score, so a hot
    cell adds hundreds of thousands of equal values, and one f32
    accumulator in any order drifts from the sum by more than the bar.
    Returns (the errors, the plain channels)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    bins_T = args[0]
    dev = bins_T.device
    B, F, nch = kw["num_bins"], kw["f_oh"], kw["nch"]
    hist_k, score_k, gh_k = fl.epilogue_pass(*args, **kw)
    hist_p, score_p, gh_p = fl.epilogue_pass_plain(*args, **kw)
    torch.cuda.synchronize()

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    score_err = float((score_k - score_p).abs().max())
    if not torch.allclose(score_k, score_p, rtol=1e-6, atol=0):
        raise AssertionError(f"epilogue new_score differs by {score_err}")
    # decoded channels (hi + lo): if the two exps were an ulp apart, g may
    # round to the other bf16 hi, and hi + lo may then differ by 2^-15 of
    # the value and those ulps
    ch_k, ch_p = gh_k.float(), gh_p.float()
    if nch == fl.NCH_PRECISE:
        dec_k = torch.stack([ch_k[0] + ch_k[1], ch_k[2] + ch_k[3], ch_k[4]])
        dec_p = torch.stack([ch_p[0] + ch_p[1], ch_p[2] + ch_p[3], ch_p[4]])
    else:
        dec_k, dec_p = ch_k[:3], ch_p[:3]
    gh_err = float((dec_k - dec_p).abs().max())
    if not torch.allclose(dec_k, dec_p, rtol=4e-5, atol=1e-7):
        raise AssertionError(f"epilogue gh_T differs by {gh_err}")
    if ch_k[nch:].abs().max() != 0:
        raise AssertionError("epilogue gh_T rows >= nch are not zero")
    # histogram: slots 1-7 exactly zero; the weight channel exact; g/h
    # planes within 1e-5 of the plane's largest |value| sum per cell (the
    # scale of any f32 summation order's rounding error)
    live = torch.zeros(nch * 8, dtype=torch.bool, device=dev)
    live[::8] = True
    if hist_k[:, ~live].abs().max() != 0:
        raise AssertionError("epilogue hist slots 1-7 are not zero")
    abs_hist = _root_hist64(bins_T, gh_p, B, F, nch, absolute=True)
    ref_k = _root_hist64(bins_T, gh_k, B, F, nch) if float64_hist else None
    ref_p = _root_hist64(bins_T, gh_p, B, F, nch) if float64_hist else None
    hist_abs_err = 0.0
    hist_rel_sum = 0.0
    hist_rel_max = 0.0
    plain_rel_sum = 0.0
    for c in range(nch):
        k, p = hist_k[:, 8 * c], hist_p[:, 8 * c]
        want = ref_k[:, c] if float64_hist else p.double()
        err = float((k.double() - want).abs().max())
        hist_abs_err = max(hist_abs_err, err)
        if c == nch - 1:
            if err != 0.0:
                raise AssertionError(f"epilogue weight channel differs by "
                                     f"{err}")
            continue
        hist_rel_sum = max(hist_rel_sum, err / float(abs_hist[:, c].max()))
        hist_rel_max = max(hist_rel_max, err / (float(want.abs().max())
                                                or 1.0))
        if float64_hist:
            plain_rel_sum = max(plain_rel_sum, float(
                (p.double() - ref_p[:, c]).abs().max())
                / float(abs_hist[:, c].max()))
    out = {
        "new_score_max_abs_err": score_err, "new_score_tol": "rtol=1e-6",
        "gh_max_abs_err": gh_err, "gh_max_rel_err": rel(dec_k, dec_p),
        "gh_tol": "rtol=4e-5 atol=1e-7",
        "hist_reference": ("float64 sum of the kernel's channels"
                           if float64_hist else "the plain version"),
        "hist_max_abs_err": hist_abs_err,
        "hist_rel_err_of_abs_sum": hist_rel_sum, "hist_tol": 1e-5,
        "hist_rel_err_of_plane_max": hist_rel_max,
        "weight_channel_exact": True}
    if float64_hist:
        out["plain_hist_rel_err_of_abs_sum_vs_float64"] = plain_rel_sum
    if hist_rel_sum > 1e-5:
        raise AssertionError(f"epilogue hist rel err {hist_rel_sum} > 1e-5: "
                             f"{out}")
    return out, gh_p


def check_hist(R, Fp, B, S, quant_bits, seed, slots="random",
               stages=False, unrounded=False):
    """hist_pass against its plain version: int32 bins [R, Fp] in [0, B-1),
    slots in [0, S) with ~30% of rows at -1 (their gh non-zero), or every
    row in slot 0 (``slots="root"``, the root level), gh as f32 (g, h, w)
    (bf16-rounded, or as given by the ``unrounded`` variant of the XLA
    engine) or the int8 channels of ``quant_bits``. Called twice: the same
    bits. ``stages`` also times each of its CUDA kernels alone."""
    import torch
    from lightgbm_tpu_torch.ops import quantize as q
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B - 1, (R, Fp), generator=gen, device=dev,
                         dtype=torch.int32)
    slot = torch.randint(0, S, (R,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot[torch.rand(R, generator=gen, device=dev) < 0.3] = -1
    if slots == "root":
        slot.zero_()
    g = torch.randn(R, generator=gen, device=dev)
    h = torch.rand(R, generator=gen, device=dev) * 0.25
    w = torch.ones(R, device=dev)
    if quant_bits:
        scales = q.quant_scales(g, h, quant_bits)
        gh = torch.stack(q.encode_channels(
            *q.quantize_gh(g, h, scales, quant_bits, seed), w, quant_bits),
            1).contiguous()
    else:
        gh = torch.stack([g, h, w], 1).contiguous()
    return {"slots": slots,
            **hist_operand_check(bins, gh, slot, S, B, quant_bits, stages,
                                 unrounded)}


def hist_operand_check(bins, gh, slot, S, B, quant_bits=0, stages=False,
                       unrounded=False):
    """hist_pass on given operands against its plain version (the checks
    and timings of ``check_hist``): one call launching each CUDA kernel
    once, the same bits on a second call, the f32 planes within 1e-5 of the
    per-cell sum of |value| and the weight channel (or every int32 plane)
    exact; kernel, plain, ``index_add_`` and bound times."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops import pallas_histogram as ph
    dev = bins.device
    R, Fp = bins.shape
    nch = gh.shape[1]
    kw = dict(S=S, Bp=B, nch=nch, quant=bool(quant_bits))
    if unrounded:
        kw["unrounded"] = True
    n0 = fl.launches["hist_pass"]
    c0 = {k: fl.cuda_launches[k] for k in fl.HIST_KERNELS}
    out_k = ph.hist_pass(bins, gh, slot, **kw)
    launched = fl.launches["hist_pass"] - n0
    cuda_launched = {k: fl.cuda_launches[k] - c0[k] for k in fl.HIST_KERNELS}
    out_again = ph.hist_pass(bins, gh, slot, **kw)
    out_p = ph.hist_pass_plain(bins, gh, slot, **kw)
    torch.cuda.synchronize()
    if launched != 1 or set(cuda_launched.values()) != {1}:
        raise AssertionError(f"hist_pass launched {launched} calls, CUDA "
                             f"kernels {cuda_launched}")
    same_bits = bool(torch.equal(out_k.view(torch.int32),
                                 out_again.view(torch.int32)))
    if not same_bits:
        raise AssertionError(f"hist_pass gave other bits on a second call "
                             f"(B={B} S={S} quant{quant_bits})")
    abs_err = float((out_k - out_p).abs().max())
    rel_sum = 0.0
    if quant_bits:
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"hist_pass quant{quant_bits} differs by "
                                 f"{abs_err} (B={B} S={S})")
    else:
        # g/h planes within 1e-5 of the largest per-cell sum of |value|
        # (the scale of any f32 summation order's rounding error); the
        # weight channel counts rows exactly
        abs_sum = ph.hist_pass_plain(bins, gh.abs(), slot, **kw)
        for c in range(2):
            err = float((out_k[c] - out_p[c]).abs().max())
            rel_sum = max(rel_sum, err / float(abs_sum[c].max()))
        if not torch.equal(out_k[2], out_p[2]):
            raise AssertionError("hist_pass weight channel differs")
        if rel_sum > 1e-5:
            raise AssertionError(f"hist_pass rel err {rel_sum} > 1e-5")

    # bytes this run's data needs: every slot, the bins and channels of
    # the slotted rows, the histogram out; ops: Fp*nch adds per slotted row
    rows = torch.nonzero(slot >= 0).squeeze(1)
    n_slot = int(rows.numel())
    nbytes = (R * 4 + n_slot * (Fp * 4 + nch * gh.element_size())
              + out_p.numel() * 4)
    b_ms, b_by = bound(nbytes, n_slot * Fp * nch)
    # the library yardstick: one index_add_ over precomputed flat indices
    cell = ((slot[rows].long()[:, None] * Fp
             + torch.arange(Fp, device=dev)) * B + bins[rows].long())
    src = (gh[rows].int() if quant_bits else gh[rows] if unrounded
           else gh[rows].to(torch.bfloat16).float())
    src = src[:, None, :].expand(-1, Fp, -1).reshape(-1, nch)
    cell = cell.reshape(-1)
    flat_len = out_p.numel() // nch
    acc = out_p.dtype

    def library():
        return torch.zeros((flat_len, nch), dtype=acc,
                           device=dev).index_add_(0, cell, src)
    if quant_bits and not torch.equal(library().t().reshape(out_p.shape),
                                      out_p):
        raise AssertionError("the index_add_ yardstick differs from the "
                             "plain version")
    out = {}
    if stages:
        # each CUDA kernel alone on the same inputs, into one set of
        # buffers a whole call filled first (a kernel reads what the
        # earlier ones wrote)
        lkw = dict(Bp=B, nch=nch, quant=bool(quant_bits),
                   unrounded=unrounded)
        buf = ph.hist_buffers(bins, S=S, **lkw)
        ph._hist_launch(fl.HIST_KERNELS, bins, gh, slot, buf, **lkw)

        def stage(kernel):
            return lambda: ph._hist_launch((kernel,), bins, gh, slot, buf,
                                           **lkw)
        out["stages_ms"] = {k: cuda_ms(stage(k)) for k in fl.HIST_KERNELS}
        out.update(tile_blocks=buf["blocks"],
                   channels_per_block=buf["channels_per_block"],
                   adding_warps=buf["warps"])
    return {
        "R": R, "Fp": Fp, "Bp": B, "S": S, "nch": nch,
        "variant": (f"quant{quant_bits}" if quant_bits else
                    "f32_unrounded" if unrounded else "f32"),
        "slotted_rows": n_slot, "launches": launched,
        "cuda_launches": cuda_launched, "same_bits_twice": same_bits, **out,
        "max_abs_err": abs_err,
        "rel_err_of_abs_sum": rel_sum,
        "tol": "exact" if quant_bits else "1e-5 of abs sum; w exact",
        "kernel_ms": cuda_ms(lambda: ph.hist_pass(bins, gh, slot, **kw)),
        # the same timing again: the run-to-run spread a comparison must
        # exceed
        "kernel_ms_repeat": cuda_ms(
            lambda: ph.hist_pass(bins, gh, slot, **kw)),
        "plain_ms": call_ms(lambda: ph.hist_pass_plain(bins, gh, slot, **kw),
                            reps=3, warmup=1),
        "library_ms": cuda_ms(library, reps=5),
        "bound_ms": b_ms, "bound_by": b_by}


def list_partition_check(call, run):
    """leaf_partition on one captured leaf-wise step (phase ``run``: the list
    state before the split, the split's column and left table) against
    its plain version, exactly, and the same output on a second call;
    kernel ms (each timed call starts from the captured state: three
    restoring copies, timed alone and taken off), plain ms, the library
    yardstick (one stable ``torch.sort`` of the segment's precomputed left
    flags) and the bound (the segment's ids read, their bins gathered,
    the ids written: 12 B a row, and the table)."""
    import torch
    from lightgbm_tpu_torch.ops import data_partition as dp
    (order, scratch, begin, rows, l1, new1, ds, kbins, col, table), _ = call
    lf = int(l1)
    b, n = int(begin[lf]), int(rows[lf])
    if not bool(ds):
        raise AssertionError(f"{run}: the captured leaf-wise step does not "
                             f"split")
    op = (l1, new1, ds, kbins, col, table)

    def state():
        return order.clone(), begin.clone(), rows.clone()
    want = state()
    dp.leaf_partition_plain(*want, *op)
    c0 = {k: dp.cuda_launches[k] for k in dp.PARTITION_KERNELS}
    outs = []
    for _ in range(2):
        got = state()
        dp.leaf_partition(got[0], scratch, got[1], got[2], *op)
        outs.append(got)
    torch.cuda.synchronize()
    cuda_launched = {k: dp.cuda_launches[k] - c0[k]
                     for k in dp.PARTITION_KERNELS}
    exact = all(torch.equal(a, w) for got in outs
                for a, w in zip(got, want))
    same = all(torch.equal(a, c) for a, c in zip(*outs))
    if not (exact and same) or set(cuda_launched.values()) != {2}:
        raise AssertionError(f"{run} leaf_partition: equal to plain {exact}, "
                             f"the same twice {same}, CUDA {cuda_launched}")
    o, bg, rw = state()
    seg, bg0, rw0 = order[b:b + n].clone(), begin.clone(), rows.clone()

    def restore():
        o[b:b + n].copy_(seg)
        bg.copy_(bg0)
        rw.copy_(rw0)

    def kernel():
        restore()
        dp.leaf_partition(o, scratch, bg, rw, *op)

    def plain():
        restore()
        dp.leaf_partition_plain(o, bg, rw, *op)
    flags = table[kbins[seg.long(), int(col)].long().clamp(
        0, table.numel() - 1)]
    keys = (~flags).to(torch.uint8)

    def library():
        return torch.sort(keys, stable=True)
    restore_ms = cuda_ms(restore)
    with_restore = cuda_ms(kernel)
    with_restore_2 = cuda_ms(kernel)
    n_left = int(flags.sum())
    b_ms, b_by = bound(12 * n + table.numel(), n)
    return {"segment_rows": n, "left_rows": n_left,
            "right_rows": n - n_left, "Bk": int(table.numel()),
            "launches": 2, "cuda_launches": cuda_launched,
            "equal_to_plain": exact, "same_twice": same,
            "max_abs_err": 0.0, "tol": "exact",
            "kernel_ms": with_restore - restore_ms,
            "kernel_ms_repeat": with_restore_2 - restore_ms,
            "restore_ms": restore_ms, "kernel_with_restore_ms": with_restore,
            "plain_ms": call_ms(plain, reps=5, warmup=1),
            "library_ms": cuda_ms(library),
            "library_call": "torch.sort(left flags, stable=True)",
            "bound_ms": b_ms, "bound_by": b_by}


def list_hist_check(call, run):
    """leaf_hist on one captured leaf-wise step (phase ``run``: the smaller
    child's listed rows) against its plain version (g and h within 1e-5 of
    the per-cell sum of |value|, the weight channel exact), the same bits
    on a second call; kernel ms and a repeat, plain ms, the bound (the
    listed rows' ids, bins and channels read, the planes written; 3 adds a
    row and feature), ``index_add_`` over the child's precomputed cells,
    the five-kernel ``hist_pass`` on ``slot = (row_leaf == target)`` for
    the same child (held to the plain version as leaf_hist is), and the
    root both ways (every row listed, or slotted)."""
    import torch
    from lightgbm_tpu_torch.models import learner as tlearn
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import pallas_histogram as ph
    args, kw = call
    kbins, gh, order, begin, rows, target, ds = args
    Bk = kw["num_bins"]
    R, Fp = kbins.shape
    dev = kbins.device
    lf = int(target)
    b, n = int(begin[lf]), int(rows[lf])
    c0 = dp.cuda_launches["leaf_hist"]
    out_k = dp.leaf_hist(*args, num_bins=Bk)
    again = dp.leaf_hist(*args, num_bins=Bk)
    out_p = dp.leaf_hist_plain(*args, num_bins=Bk)
    abs_sum = dp.leaf_hist_plain(kbins, gh.abs(), *args[2:], num_bins=Bk)
    torch.cuda.synchronize()
    cuda_launched = dp.cuda_launches["leaf_hist"] - c0
    same = bool(torch.equal(out_k.view(torch.int32),
                            again.view(torch.int32)))
    rel = max(float((out_k[c] - out_p[c]).abs().max())
              / max(float(abs_sum[c].max()), 1e-30) for c in range(2))
    w_exact = bool(torch.equal(out_k[2], out_p[2]))
    if not (same and w_exact and rel <= 1e-5) or cuda_launched != 2:
        raise AssertionError(f"{run} leaf_hist: same twice {same}, rel "
                             f"{rel}, w exact {w_exact}, CUDA "
                             f"{cuda_launched}")
    listed = order[b:b + n].long()
    nbytes = n * 4 + n * (Fp * 4 + 3 * 4) + out_p.numel() * 4
    b_ms, b_by = bound(nbytes, n * Fp * 3)
    cell = (torch.arange(Fp, device=dev) * Bk
            + kbins[listed].long()).reshape(-1)
    src = gh[listed][:, None, :].expand(-1, Fp, -1).reshape(-1, 3)

    def library():
        return torch.zeros((Fp * Bk, 3), device=dev).index_add_(0, cell,
                                                                 src)
    row_leaf = tlearn._rows_to_leaves(order, begin, rows)
    slot = torch.where(row_leaf == lf, 0, -1).to(torch.int32)
    hkw = dict(S=1, Bp=Bk, nch=3, unrounded=True)
    five = ph.hist_pass(kbins, gh, slot, **hkw)[:, 0]
    five_rel = max(float((five[c] - out_p[c]).abs().max())
                   / max(float(abs_sum[c].max()), 1e-30) for c in range(2))
    if not (five_rel <= 1e-5 and torch.equal(five[2], out_p[2])):
        raise AssertionError(f"{run}: the five-kernel hist_pass on leaf_hist's "
                             f"child: rel {five_rel}, w exact "
                             f"{bool(torch.equal(five[2], out_p[2]))}")
    # the root: every row listed (leaf 0 of a fresh list) or slotted
    all_rows = torch.arange(R, dtype=torch.int32, device=dev)
    root_begin = torch.zeros_like(begin)
    root_rows = torch.zeros_like(rows)
    root_rows[:1].fill_(R)
    root_leaf = torch.zeros(1, dtype=torch.int64, device=dev)
    zero_slot = torch.zeros(R, dtype=torch.int32, device=dev)
    return {"listed_rows": n, "R": R, "Fp": Fp, "Bk": Bk,
            "grid": list(dp.hist_grid(Fp, Bk)),
            "launches": 2, "cuda_launches": cuda_launched,
            "same_bits_twice": same,
            "max_abs_err": float((out_k - out_p).abs().max()),
            "rel_err_of_abs_sum": rel,
            "tol": "1e-5 of abs sum; w exact",
            "kernel_ms": cuda_ms(lambda: dp.leaf_hist(*args, num_bins=Bk)),
            "kernel_ms_repeat": cuda_ms(
                lambda: dp.leaf_hist(*args, num_bins=Bk)),
            "plain_ms": call_ms(lambda: dp.leaf_hist_plain(
                *args, num_bins=Bk), reps=3, warmup=1),
            "library_ms": cuda_ms(library, reps=5),
            "library_call": "index_add_ over the child's precomputed cells",
            "bound_ms": b_ms, "bound_by": b_by,
            "five_kernel_hist_pass_ms": cuda_ms(
                lambda: ph.hist_pass(kbins, gh, slot, **hkw)),
            "five_kernel_rel_err_of_abs_sum": five_rel,
            "root_leaf_hist_ms": cuda_ms(lambda: dp.leaf_hist(
                kbins, gh, all_rows, root_begin, root_rows, root_leaf, ds,
                num_bins=Bk)),
            "root_hist_pass_ms": cuda_ms(
                lambda: ph.hist_pass(kbins, gh, zero_slot, **hkw))}


def auc(scores: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = y > 0
    n_pos = pos.sum()
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def auc_ties(scores: np.ndarray, y: np.ndarray) -> float:
    """AUC in float64 with tied scores credited one half (the trapezoid
    over groups of equal scores)."""
    order = np.argsort(-scores, kind="stable")
    s, pos = scores[order], (y[order] > 0).astype(np.float64)
    start = np.concatenate([[True], s[1:] != s[:-1]])
    gid = np.cumsum(start) - 1
    g_pos = np.bincount(gid, weights=pos)
    g_neg = np.bincount(gid) - g_pos
    before = np.concatenate([[0.0], np.cumsum(g_pos)[:-1]])
    return float(np.sum(g_neg * (before + 0.5 * g_pos))
                 / (pos.sum() * (len(y) - pos.sum())))


def logloss(raw: np.ndarray, y: np.ndarray) -> float:
    """Binary logloss in float64 of raw scores."""
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1.0 - 1e-15)
    return float(-np.mean(np.where(y > 0, np.log(p), np.log(1.0 - p))))


def es_rule(ev, rounds: int):
    """The early_stopping callback's rule on recorded curves: the first
    (iteration, curve) at which a curve has not improved for ``rounds``
    iterations gives its best iteration (1-based); None if none stops."""
    curves = [(vals, m == "auc") for name in ev for m, vals in
              ev[name].items()]
    best = [(None, 0)] * len(curves)
    for i in range(len(curves[0][0])):
        for j, (vals, bigger) in enumerate(curves):
            v, (b, bi) = vals[i], best[j]
            if b is None or (v > b if bigger else v < b):
                best[j] = (v, i)
            if i - best[j][1] >= rounds:
                return best[j][1] + 1
    return None


def run_eval_train(lgb, params, ds, X, y, w, e2e):
    """Phase 7: valid sets, metrics, callbacks, early stopping and cv
    through train() on the card (runs a-f). Returns the wrappers' launches
    of runs (a), (c) and (d) (each with the CUDA kernels' under
    ``cuda:<kernel>``)."""
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    metric = ["binary_logloss", "auc"]
    t0 = time.perf_counter()
    Xv, yv = _valid_rows(VALID_ROWS, w, seed=DATA_SEED + 100)
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    yp = np.random.RandomState(7).permutation(yv)
    dp = lgb.Dataset(Xv, label=yp, reference=ds).construct()
    construct_s = time.perf_counter() - t0
    out = {}

    def counted(fn):
        """fn() with the launch and host-sync counts set to 0 just before
        and read just after."""
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        frontier2.host_syncs["count"] = 0
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        return res, dt, dict(fl.launches), dict(fl.cuda_launches), \
            frontier2.host_syncs["count"]

    def train(p, rounds, valid, names, callbacks=(), **kw):
        ds.params = {}      # each run trains on its own parameters alone
        ev = {}
        bst = lgb.train(p, ds, rounds, valid_sets=valid, valid_names=names,
                        callbacks=[lgb.record_evaluation(ev), *callbacks],
                        **kw)
        return bst, ev

    def check_predict(bst, run, i=0):
        pred = walk_predict(bst, Xv, raw_score=True, num_iteration=-1)
        got = bst.valid_scores(i).float().cpu().numpy()
        err = float(np.abs(pred - got).max())
        if not np.allclose(got, pred, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"run ({run}) valid scores differ from "
                                 f"predict by {err}")
        return pred, err

    # (a) bench.py's eval leg on the megastep body
    pa = dict(params, metric=metric, early_stopping_round=25)

    def run_a(rounds):
        return train(pa, rounds, [dv], ["valid"],
                     [lgb.log_evaluation(1)])
    stash = {}
    upd = GBDT._update_valid_from_trees

    def keep_tree(self, trees):
        stash["trees"], stash["gbdt"] = trees, self
        return upd(self, trees)
    GBDT._update_valid_from_trees = keep_tree
    try:
        run_a(1)                              # warm-up
        _, t_one, *_ = counted(lambda: run_a(1))
        (bst, ev), t_all, launches, cuda, syncs = counted(
            lambda: run_a(ROUNDS))
    finally:
        GBDT._update_valid_from_trees = upd
    n_trees = bst.num_trees()
    pred, pred_err = check_predict(bst, "a")
    want = {"binary_logloss": logloss(pred, yv), "auc": auc_ties(pred, yv)}
    got = {m: ev["valid"][m][-1] for m in metric}
    # the device time of one iteration's valid update (every valid row
    # routed through the last device tree) and of its metrics, each a CUDA
    # graph replayed (cuda_ms), on the trained state
    g = stash["gbdt"]
    vs0 = g.valid_scores[0].clone()
    upd_ms = cuda_ms(lambda: g._update_valid_from_trees(stash["trees"]))
    g.valid_scores[0].copy_(vs0)
    eval_ms = cuda_ms(lambda: g.eval_metric_set(
        "valid", g.valid_metrics[0], g.valid_scores[0]))
    res = {"phase": "eval_train", "run": "a", "body": "megastep",
           "valid_rows": VALID_ROWS, "construct_valid_s": construct_s,
           "metric": metric, "rounds": ROUNDS, "trees": n_trees,
           "curve_lengths": {m: len(v) for m, v in ev["valid"].items()},
           "valid_last": got, "valid_last_float64_from_predict": want,
           "valid_auc": got["auc"],
           "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
           "phase3_sec_per_iter_after_first":
               e2e["sec_per_iter_after_first"],
           "launches_per_tree": {k: v / max(n_trees, 1)
                                 for k, v in launches.items()},
           "phase3_launches_per_tree": {k: v / e2e["trees"] for k, v in
                                        e2e["launches"].items()},
           "host_syncs_per_tree": syncs / max(n_trees, 1),
           "phase3_host_syncs_per_tree": e2e["host_syncs_per_tree"],
           "eval_fetches_per_iter": 1,
           "valid_update_device_ms_per_iter": upd_ms,
           "metrics_device_ms_per_iter": eval_ms,
           "predict_max_abs_err": pred_err,
           "predict_tol": "rtol=1e-5 atol=1e-5", "best_iteration":
               bst.best_iteration, "launches": launches,
           "cuda_launches": cuda}
    emit(res)
    if n_trees != ROUNDS or set(res["curve_lengths"].values()) != {ROUNDS}:
        raise AssertionError(f"run (a): {n_trees} trees, curves "
                             f"{res['curve_lengths']}")
    if not got["auc"] > 0.75:
        raise AssertionError(f"run (a) valid AUC {got['auc']} <= 0.75")
    for m in metric:
        if not np.isclose(got[m], want[m], rtol=1e-5, atol=0):
            raise AssertionError(f"run (a) recorded {m} {got[m]} is not "
                                 f"the float64 {want[m]} within rtol 1e-5")
    for name in TRAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"run (a) never launched {name}")
    if launches["epilogue_pass"] or launches["hist_pass"]:
        raise AssertionError("run (a) left the megastep body")
    check_stages(launches, cuda, "run (a)")
    out["a"] = dict(launches, **{"cuda:" + k: v for k, v in cuda.items()})

    # (b) early stopping on [valid, permuted]
    rounds_b = 30
    bst_b, ev_b = train(dict(params, metric=metric), rounds_b,
                        [dv, dp], ["valid", "permuted"],
                        [lgb.early_stopping(3, verbose=False)])
    rule = es_rule(ev_b, 3)
    text_trees = lgb.Booster(model_str=bst_b.model_to_string()).num_trees()
    by_default = walk_predict(bst_b, Xv[:10_000], raw_score=True)
    at_best = walk_predict(bst_b, Xv[:10_000], raw_score=True,
                           num_iteration=bst_b.best_iteration)
    emit({"phase": "eval_train", "run": "b", "rounds": rounds_b,
          "trees": bst_b.num_trees(), "best_iteration": bst_b.best_iteration,
          "rule_best_iteration": rule, "model_text_trees": text_trees,
          "best_score": {k: dict(v) for k, v in bst_b.best_score.items()}})
    if not (bst_b.num_trees() < rounds_b and rule is not None
            and bst_b.best_iteration == rule
            and bst_b.num_trees() == rule + 3 and text_trees == rule
            and np.array_equal(by_default, at_best)):
        raise AssertionError(f"run (b): {bst_b.num_trees()} trees, best "
                             f"{bst_b.best_iteration}, rule {rule}, model "
                             f"text {text_trees} trees")

    # (c) feval: the classic loop, the epilogue body
    def np_logloss(score, data):
        return "np_logloss", logloss(score, data.get_label()), False
    (bst_c, ev_c), _, launches, cuda, _ = counted(lambda: train(
        dict(params, metric=metric), ROUNDS, [dv], ["valid"],
        feval=np_logloss))
    dev_ll, np_ll = ev_c["valid"]["binary_logloss"], ev_c["valid"][
        "np_logloss"]
    emit({"phase": "eval_train", "run": "c", "body": "epilogue",
          "trees": bst_c.num_trees(), "valid_binary_logloss": dev_ll,
          "feval_np_logloss": np_ll, "launches": launches,
          "cuda_launches": cuda})
    if launches["epilogue_pass"] <= 0 or len(np_ll) != ROUNDS:
        raise AssertionError("run (c) never launched epilogue_pass")
    if not np.allclose(np_ll, dev_ll, rtol=1e-6, atol=0):
        raise AssertionError("run (c): feval and binary_logloss differ "
                             "beyond rtol 1e-6")
    check_stages(launches, cuda, "run (c)")
    out["c"] = dict(launches, **{"cuda:" + k: v for k, v in cuda.items()})

    # (d) the frontier body with a valid set
    (bst_d, ev_d), _, launches, cuda, _ = counted(lambda: train(
        dict(params, metric=metric, tpu_engine="frontier"), ROUNDS, [dv],
        ["valid"]))
    _, err_d = check_predict(bst_d, "d")
    emit({"phase": "eval_train", "run": "d", "engine": "frontier",
          "trees": bst_d.num_trees(), "valid_auc": ev_d["valid"]["auc"][-1],
          "predict_max_abs_err": err_d, "launches": launches,
          "cuda_launches": cuda})
    if launches["hist_pass"] <= 0 or bst_d.num_trees() != ROUNDS:
        raise AssertionError("run (d) never launched hist_pass")
    check_stages(launches, cuda, "run (d)")
    out["d"] = dict(launches, **{"cuda:" + k: v for k, v in cuda.items()})

    # (e) continued training from run (a)'s booster
    bst_e, ev_e = train(dict(params, metric=metric), 5, [dv], ["valid"],
                        init_model=bst)
    both = (walk_predict(bst, Xv, raw_score=True, num_iteration=-1)
            + walk_predict(bst_e, Xv, raw_score=True))
    got_e = bst_e.valid_scores(0).float().cpu().numpy()
    err_e = float(np.abs(got_e - both).max())
    emit({"phase": "eval_train", "run": "e", "trees": bst_e.num_trees(),
          "valid_auc": ev_e["valid"]["auc"][-1],
          "valid_scores_vs_both_predicts_max_abs_err": err_e})
    if bst_e.num_trees() != 5 or not np.allclose(got_e, both, rtol=1e-5,
                                                 atol=1e-5):
        raise AssertionError(f"run (e): valid scores differ from the sum "
                             f"of both boosters' predictions by {err_e}")
    # train(init_model=...) writes the model's raw predictions into its
    # Datasets' init scores, as LightGBM's does: the later runs on these
    # Datasets start from zero again
    ds.set_init_score(None)
    dv.set_init_score(None)

    # (f) cv: 3 stratified folds, 5 rounds
    ds.params = {}
    t = time.perf_counter()
    cvres = lgb.cv(dict(params, metric=metric), ds, num_boost_round=5,
                   nfold=3, stratified=True, return_cvbooster=True)
    cv_s = time.perf_counter() - t
    folds = cvres.pop("cvbooster").eval_valid()
    keys = {f"valid {m}-{s}" for m in metric for s in ("mean", "stdv")}
    means = {m: float(np.mean([[v for _, n, v, _ in f if n == m][0]
                               for f in folds])) for m in metric}
    emit({"phase": "eval_train", "run": "f", "nfold": 3, "cv_s": cv_s,
          "results_last": {k: v[-1] for k, v in cvres.items()},
          "fold_eval_valid_means": means})
    if set(cvres) != keys or {len(v) for v in cvres.values()} != {5}:
        raise AssertionError(f"run (f): cv result {sorted(cvres)}")
    for m in metric:
        if cvres[f"valid {m}-mean"][-1] != means[m]:
            raise AssertionError(f"run (f): the {m} mean is not the mean of "
                                 "the folds' eval_valid")
    ds.params = {}
    return out


def _class_rows(n_rows: int, n_feat: int, seed: int):
    """``_make_data``'s draw (the same X and labelling weights) with the
    score z its binary label thresholds at 0."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_rows, n_feat).astype(np.float32)
    w = rng.randn(n_feat).astype(np.float32)
    z = X @ w + 0.5 * rng.randn(n_rows)
    return X, z, w


def _valid_z(n_rows: int, w: np.ndarray, seed: int):
    """``_valid_rows``'s draw with its score z."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_rows, len(w)).astype(np.float32)
    return X, X @ w + 0.5 * rng.randn(n_rows)


def class_loss(objective: str, raw: np.ndarray, y: np.ndarray) -> float:
    """Float64 training loss of raw predictions ([n] or [n, k])."""
    if objective == "multiclass":
        m = raw - raw.max(1, keepdims=True)
        logp = m - np.log(np.exp(m).sum(1, keepdims=True))
        return float(-np.mean(logp[np.arange(len(y)), y.astype(int)]))
    if objective == "multiclassova":
        onehot = y.astype(int)[:, None] == np.arange(raw.shape[1])
        p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1.0 - 1e-15)
        return float(-np.mean(np.where(onehot, np.log(p), np.log(1 - p))))
    if objective == "regression_l1":
        return float(np.mean(np.abs(y - raw)))
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1.0 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def class_runs(z: np.ndarray):
    """Phase 8's runs: (name, extra params, labels, rounds, body). Labels
    from the draw's score z: quintiles (5 balanced classes), z itself (L1),
    sigmoid(z) (cross_entropy), z > 0 (the binary runs)."""
    cuts = np.quantile(z, [0.2, 0.4, 0.6, 0.8])
    y_mc = np.digitize(z, cuts).astype(np.float32)
    y_bin = (z > 0).astype(np.float32)
    return cuts, [
        ("a", {"objective": "multiclass", "num_class": 5,
               "metric": ["multi_logloss", "multi_error"]}, y_mc, 10,
         "megastep"),
        ("b", {"objective": "multiclassova", "num_class": 5}, y_mc, 5,
         "megastep"),
        ("c", {"objective": "binary", "boosting": "goss", "top_rate": 0.2,
               "other_rate": 0.1}, y_bin, 15, "sync"),
        ("d", {"objective": "binary", "feature_fraction_bynode": 0.5,
               "interaction_constraints": CLASS_GROUPS}, y_bin, 10, "sync"),
        ("e", {"objective": "regression_l1"}, z.astype(np.float32), 10,
         "sync"),
        ("f", {"objective": "cross_entropy"},
         (1.0 / (1.0 + np.exp(-z))).astype(np.float32), 10, "megastep")]


def _root_to_leaf_features(tree, node=0, path=()):
    if node < 0:
        yield set(path)
        return
    f = int(tree.split_feature[node])
    yield from _root_to_leaf_features(tree, int(tree.left_child[node]),
                                      path + (f,))
    yield from _root_to_leaf_features(tree, int(tree.right_child[node]),
                                      path + (f,))


def run_class_train(lgb, params, ds, y, z, w, e2e):
    """Phase 8: multiclass, multiclassova, GOSS, per-node feature masks,
    L1 leaf renewal and cross_entropy through train() on phase 3's
    dataset (its labels swapped per run, its bins kept). Returns each
    run's wrapper launches (with the CUDA kernels' under ``cuda:<k>``)."""
    import torch
    from lightgbm_tpu_torch.boosting.gbdt import GOSS, abs_gh_class_sum
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    cuts, runs = class_runs(z)
    Xv, zv = _valid_z(VALID_ROWS, w, seed=DATA_SEED + 100)
    yv_mc = np.digitize(zv, cuts).astype(np.float32)
    Xs = ds.data[:100_000]
    out = {}
    goss_bagging = GOSS._bagging
    for name, extra, labels, rounds, body in runs:
        ds.set_label(labels)
        ds.params = {}
        valid, names = None, None
        if name == "a":
            valid = [lgb.Dataset(Xv, label=yv_mc, reference=ds)]
            names = ["valid"]
        stamps, ev, bag_cnt, bag_want = [], {}, [], []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        def record_bag(self, it, grad=None, hess=None):
            n = self.num_data
            if it >= int(1.0 / self.config.learning_rate):
                # the rows at or above the top_rate quantile of |g·h|
                # (ties included), plus other_rate * n of the rest
                g = abs_gh_class_sum(grad, hess).cpu().numpy()
                top_k, other_k = int(n * 0.2), int(n * 0.1)
                top = int((g >= np.partition(g, n - top_k)[n - top_k])
                          .sum())
                bag_want.append(top + min(other_k, n - top))
            else:
                bag_want.append(n)
            res = goss_bagging(self, it, grad, hess)
            bag_cnt.append(self.bag_cnt)
            return res
        GOSS._bagging = record_bag
        try:
            torch.cuda.synchronize()
            fl.reset_launch_counts()
            frontier2.host_syncs["count"] = 0
            bst = lgb.train(dict(params, **extra), ds, rounds,
                            valid_sets=valid, valid_names=names,
                            callbacks=[stamp, lgb.record_evaluation(ev)])
            torch.cuda.synchronize()
        finally:
            GOSS._bagging = goss_bagging
        launches, cuda = dict(fl.launches), dict(fl.cuda_launches)
        syncs = frontier2.host_syncs["count"]
        g = bst._gbdt
        k = g.num_tree_per_iteration
        n_trees = bst.num_trees()
        got_body = "megastep" if g._fast_path_reason() is None else "sync"
        res = {"phase": "class_train", "run": name,
               "params": {a: b for a, b in extra.items()
                          if a != "interaction_constraints"},
               "body": got_body, "rounds": rounds,
               "trees_per_iter": k, "trees": n_trees,
               "leaves": sorted({m.num_leaves for m in bst.models}),
               "sec_per_iter_after_first":
                   (stamps[-1] - stamps[0]) / (rounds - 1),
               "phase3_sec_per_iter_after_first":
                   e2e["sec_per_iter_after_first"],
               "launches_per_tree": {a: v / max(n_trees, 1)
                                     for a, v in launches.items()},
               "cuda_launches_per_tree": {a: v / max(n_trees, 1)
                                          for a, v in cuda.items()},
               "host_syncs_per_tree": syncs / max(n_trees, 1),
               "phase3_host_syncs_per_tree": e2e["host_syncs_per_tree"]}
        if extra["objective"] == "binary":
            res["train_auc"] = auc(bst.train_scores().float().cpu().numpy(),
                                   labels)
            ok_quality = res["train_auc"] > 0.75
        else:
            obj = extra["objective"]
            first = class_loss(obj, walk_predict(bst, Xs, raw_score=True,
                                                 num_iteration=1),
                               labels[:100_000])
            last = class_loss(obj, walk_predict(bst, Xs, raw_score=True,
                                                num_iteration=-1),
                              labels[:100_000])
            res["train_loss_after_1_and_all"] = [first, last]
            ok_quality = last < first
        if name == "a":
            prob = walk_predict(bst, Xv)
            p_true = np.clip(prob[np.arange(len(yv_mc)),
                                  yv_mc.astype(int)], 1e-15, None)
            want = float(-np.mean(np.log(p_true.astype(np.float64))))
            got = ev["valid"]["multi_logloss"][-1]
            res.update({"predict_shape": list(prob.shape),
                        "predict_row_sum_max_err":
                            float(np.abs(prob.sum(1) - 1.0).max()),
                        "valid_multi_logloss": ev["valid"]["multi_logloss"],
                        "valid_multi_error_last":
                            ev["valid"]["multi_error"][-1],
                        "valid_last_float64_from_predict": want})
            if not (prob.shape == (VALID_ROWS, 5)
                    and res["predict_row_sum_max_err"] <= 1e-6
                    and np.isclose(got, want, rtol=1e-5, atol=0)
                    and ev["valid"]["multi_logloss"][-1]
                    < ev["valid"]["multi_logloss"][0]):
                raise AssertionError(f"run (a): predict {prob.shape}, rows "
                                     f"sum to 1 within "
                                     f"{res['predict_row_sum_max_err']}, "
                                     f"recorded {got}, float64 {want}")
        if name == "c":
            n = ds.num_data()
            start = int(1.0 / params["learning_rate"])
            res["bag_cnt"] = bag_cnt
            res["bag_cnt_recomputed"] = bag_want
            if not (bag_cnt[:start] == [n] * start and bag_cnt == bag_want
                    and len(bag_cnt) == rounds
                    and all(c < n for c in bag_cnt[start:])):
                raise AssertionError(f"run (c): bag counts {bag_cnt}, "
                                     f"recomputed {bag_want}")
        if name == "d":
            paths = [p for t in bst.models
                     for p in _root_to_leaf_features(t)]
            res["paths_in_one_group"] = sum(
                any(p <= set(gr) for gr in CLASS_GROUPS) for p in paths)
            res["paths"] = len(paths)
            if res["paths_in_one_group"] != len(paths) \
                    or res["host_syncs_per_tree"] \
                    != e2e["host_syncs_per_tree"]:
                raise AssertionError(f"run (d): {res['paths_in_one_group']} "
                                     f"of {len(paths)} paths in one group, "
                                     f"{res['host_syncs_per_tree']} host "
                                     f"syncs per tree")
        emit(res)
        if not ok_quality:
            raise AssertionError(f"run ({name}) did not learn: {res}")
        if got_body != body or n_trees != k * rounds \
                or res["leaves"] != [255]:
            raise AssertionError(f"run ({name}): body {got_body}, "
                                 f"{n_trees} trees of {res['leaves']} "
                                 f"leaves")
        # a full 255-leaf tree takes 9 level passes (the root, 8 levels)
        # and one route-only pass; a level that selects fewer splits than
        # its cap (a leaf under min_sum_hessian_in_leaf) adds a pass
        if not (launches["route_pass"] == launches["table_lookup"]
                == n_trees and launches["epilogue_pass"] == 0
                and launches["hist_pass"] == 0
                and 9 * n_trees <= launches["level_pass"] <= 11 * n_trees):
            raise AssertionError(f"run ({name}) launched {launches} for "
                                 f"{n_trees} trees")
        check_stages(launches, cuda, f"run ({name})")
        out[name] = dict(launches,
                         **{"cuda:" + a: v for a, v in cuda.items()})
    ds.set_label(y)
    ds.params = {}
    return out


def level_schedule(num_leaves: int, slot_cap: int, extra_levels: int = 3):
    """(level passes, route passes, host syncs) of one tree that selects
    every level's cap: the root pass, a level pass per scheduled level
    until the one that spends the leaf budget (a route-only pass), and one
    n_sel read per scheduled level (``models/frontier2.py``)."""
    from lightgbm_tpu_torch.models.frontier2 import level_caps
    caps = level_caps(num_leaves, -1, extra_levels, slot_cap)
    nl, passes = 1, 1
    for c in caps:
        n_sel = min(c, num_leaves - nl)
        if n_sel == 0:
            break
        nl += n_sel
        if nl == num_leaves:
            return passes, 1, len(caps)
        passes += 1
    return passes, 1, len(caps)


def _rank_rows(n_docs: int, seed: int, w: np.ndarray):
    """MS-LTR-shaped queries: sizes uniform in 1-240 until ``n_docs``
    documents (the last query cut to fit), 136 standard normal features
    (float32), and the score z = x·w + a per-query offset + noise that
    grades them."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, RANK_MAX_DOCS + 1, n_docs // 60)
    ends = np.cumsum(sizes)
    q = int(np.searchsorted(ends, n_docs))
    sizes = sizes[:q + 1].copy()
    sizes[-1] -= int(ends[q] - n_docs)
    X = rng.standard_normal((n_docs, RANK_FEATURES), dtype=np.float32)
    z = (X @ w + 0.5 * np.repeat(rng.standard_normal(len(sizes)), sizes)
         + 0.5 * rng.standard_normal(n_docs))
    return X, z, sizes


def rank_data(n_docs: int, n_valid: int):
    """Phase 9's training and valid queries: (X, y, sizes, Xv, yv, sv), the
    grades cut at the training score's RANK_GRADES quantiles."""
    w = (np.random.default_rng(DATA_SEED + 300)
         .standard_normal(RANK_FEATURES) / np.sqrt(RANK_FEATURES)) \
        .astype(np.float32)
    X, z, sizes = _rank_rows(n_docs, DATA_SEED, w)
    cuts = np.quantile(z, RANK_GRADES)
    Xv, zv, sv = _rank_rows(n_valid, DATA_SEED + 200, w)
    return (X, np.digitize(z, cuts).astype(np.float32), sizes, Xv,
            np.digitize(zv, cuts).astype(np.float32), sv)


def ndcg_at(score, label, sizes, k: int) -> float:
    """Mean NDCG@k over the queries in float64 (gain 2^l - 1, discount
    1/log2(2 + position), documents by descending score with ties in row
    order; a query with no relevant document counts 1)."""
    qid = np.repeat(np.arange(len(sizes)), sizes)
    pos = np.arange(len(qid)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    disc = np.where(pos < k, 1.0 / np.log2(2.0 + pos), 0.0)
    gain = 2.0 ** np.asarray(label, np.float64) - 1.0

    def dcg(key):
        order = np.lexsort((-np.asarray(key, np.float64), qid))
        return np.bincount(qid, weights=gain[order] * disc,
                           minlength=len(sizes))
    got, ideal = dcg(score), dcg(label)
    safe = np.where(ideal > 0, ideal, 1.0)
    return float(np.mean(np.where(ideal > 0, got / safe, 1.0)))


def _timed_run(fn):
    """(result, seconds) of ``fn()`` between two synchronizes."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _run_counts():
    """Reset the wrappers' and the grower's counters; returns a reader of
    (launches, CUDA launches, host syncs) since (the leaf-wise list
    kernels' counts, ``ops/data_partition.py``, beside the rest)."""
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import data_partition as dp
    from lightgbm_tpu_torch.ops import fused_level as fl
    fl.reset_launch_counts()
    dp.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    return lambda: (dict(fl.launches, **dp.launches),
                    dict(fl.cuda_launches, **dp.cuda_launches),
                    frontier2.host_syncs["count"])


def run_rank_train(lgb, base, e2e):
    """Phase 9: lambdarank (a) and rank_xendcg (b), 10 rounds each on the
    megastep body, then cv with 3 query-aligned folds (c), on MS-LTR-shaped
    queries with a 200,000-document valid set and ndcg/map at 1, 3, 5, 10.
    Returns each run's wrapper launches (the CUDA kernels' under
    ``cuda:<k>``)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops.layout import feature_layout
    X, y, sizes, Xv, yv, sv = rank_data(RANK_DOCS, RANK_VALID_DOCS)
    params = dict(base, metric=["ndcg", "map"], eval_at=RANK_EVAL_AT)
    ds, construct_s = _timed_run(lambda: lgb.Dataset(
        X, label=y, group=sizes, params=params).construct())
    dv = lgb.Dataset(Xv, label=yv, group=sv, reference=ds)
    F_oh, Bp = feature_layout(ds._inner.num_features, ds._inner.max_num_bin)
    cap = fl.max_slot_cap(F_oh * Bp, fl.NCH_PRECISE)
    want_level, want_route, want_syncs = level_schedule(255, cap)
    shape = {"docs": RANK_DOCS, "queries": len(sizes),
             "docs_per_query": [int(sizes.min()), int(sizes.max())],
             "features": RANK_FEATURES, "F_oh": F_oh, "Bp": Bp,
             "slot_cap": cap, "valid_docs": RANK_VALID_DOCS,
             "valid_queries": len(sv),
             "grade_counts": np.bincount(y.astype(int),
                                         minlength=5).tolist(),
             "construct_s": construct_s,
             "predicted_per_tree": {"level_pass": want_level,
                                    "route_pass": want_route,
                                    "table_lookup": 1,
                                    "host_syncs": want_syncs}}
    emit({"phase": "rank_train", "run": "shape", **shape})
    out = {}
    for run, obj in (("a", "lambdarank"), ("b", "rank_xendcg")):
        ds.params = {}
        stamps, ev = [], {}

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        counts = _run_counts()
        bst, train_s = _timed_run(lambda: lgb.train(
            dict(params, objective=obj), ds, ROUNDS, valid_sets=[dv],
            valid_names=["valid"],
            callbacks=[stamp, lgb.record_evaluation(ev)]))
        launches, cuda, syncs = counts()
        g = bst._gbdt
        n_trees = bst.num_trees()
        recorded = ev["valid"]["ndcg@10"]
        want = [ndcg_at(walk_predict(bst, Xv, raw_score=True,
                                     num_iteration=i + 1),
                        yv, sv, 10) for i in range(ROUNDS)]
        err = float(np.max(np.abs(np.asarray(recorded) - want)
                           / np.abs(want)))
        res = {"phase": "rank_train", "run": run, "objective": obj,
               "body": "megastep" if g._fast_path_reason() is None
               else "sync", "rounds": ROUNDS, "trees": n_trees,
               "leaves": sorted({m.num_leaves for m in bst.models}),
               "train_s": train_s,
               "sec_per_iter_after_first":
                   (stamps[-1] - stamps[0]) / (ROUNDS - 1),
               "phase3_sec_per_iter_after_first":
                   e2e["sec_per_iter_after_first"],
               "launches_per_tree": {k: v / n_trees
                                     for k, v in launches.items()},
               "cuda_launches_per_tree": {k: v / n_trees
                                          for k, v in cuda.items()},
               "host_syncs_per_tree": syncs / n_trees,
               "valid_ndcg@10": recorded,
               "valid_ndcg@10_float64_from_predict": want,
               "valid_ndcg@10_max_rel_err": err,
               "valid_map@10_last": ev["valid"]["map@10"][-1],
               "valid_last": {k: v[-1] for k, v in ev["valid"].items()}}
        emit(res)
        if not (res["body"] == "megastep" and n_trees == ROUNDS
                and res["leaves"] == [255] and err <= 1e-5
                and recorded[-1] > recorded[0]):
            raise AssertionError(f"rank run ({run}): {res}")
        if not (launches["route_pass"] == launches["table_lookup"]
                == n_trees and launches["epilogue_pass"] == 0
                and launches["hist_pass"] == 0
                and want_level * n_trees <= launches["level_pass"]
                <= (want_level + 3) * n_trees):
            raise AssertionError(f"rank run ({run}) launched {launches} for "
                                 f"{n_trees} trees")
        check_stages(launches, cuda, f"rank run ({run})")
        out[run] = dict(launches, **{"cuda:" + k: v for k, v in cuda.items()})

    # (c) cv: whole queries per fold
    ds.params = {}
    counts = _run_counts()
    cvr, cv_s = _timed_run(lambda: lgb.cv(
        dict(params, objective="lambdarank"), ds, RANK_CV_ROUNDS, nfold=3,
        return_cvbooster=True))
    launches, cuda, syncs = counts()
    boosters = cvr["cvbooster"].boosters
    n_trees = sum(b.num_trees() for b in boosters)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    whole, covered = [], np.zeros(RANK_DOCS, np.int64)
    for b in boosters:
        te = np.asarray(b.valid_sets[0].used_indices)
        covered[te] += 1
        q = np.searchsorted(qb, te, side="right") - 1
        uq = np.unique(q)
        whole.append(bool(np.array_equal(np.bincount(q)[uq], sizes[uq])))
    res = {"phase": "rank_train", "run": "c", "objective": "lambdarank",
           "nfold": 3, "rounds": RANK_CV_ROUNDS, "trees": n_trees,
           "cv_s": cv_s, "sec_per_round": cv_s / RANK_CV_ROUNDS,
           "folds_hold_whole_queries": whole,
           "every_doc_in_one_test_fold": bool((covered == 1).all()),
           "launches_per_tree": {k: v / n_trees for k, v in launches.items()},
           "host_syncs_per_tree": syncs / n_trees,
           "valid_ndcg@10_mean": cvr["valid ndcg@10-mean"]}
    emit(res)
    if not (all(whole) and res["every_doc_in_one_test_fold"]
            and n_trees == 3 * RANK_CV_ROUNDS
            and launches["route_pass"] == n_trees):
        raise AssertionError(f"rank run (c): {res}")
    check_stages(launches, cuda, "rank run (c)")
    out["c"] = dict(launches, **{"cuda:" + k: v for k, v in cuda.items()})
    return out


def _cat_codes(X: np.ndarray, seed: int) -> np.ndarray:
    """Columns 0-3 of the uniform rows as category codes (3, 12, 31 and 60
    categories): the column's bucket through a fixed permutation, so the
    codes carry the draw's signal in no numerical order."""
    rng = np.random.RandomState(seed)
    Xc = X.copy()
    for j, n in enumerate(CAT_CARDINALITIES):
        bucket = np.minimum((X[:, j] * n).astype(np.int64), n - 1)
        Xc[:, j] = rng.permutation(n)[bucket]
    return Xc


def _capture_holes(module, name, w_arg, K, B, store):
    """Wrap ``module.name`` (a level or epilogue wrapper) so that its first
    call is kept in ``store[name + ":any"]`` and its first call whose route
    table has an active categorical row with holes in ``store[name]``
    (operands cloned, with the count of such rows); returns the undo."""
    orig = getattr(module, name)

    def keep(args, kw, rows):
        return ([a.clone() if hasattr(a, "clone") else a for a in args],
                dict(kw), rows)

    def wrapper(*args, **kw):
        if name + ":any" not in store:
            store[name + ":any"] = keep(args, kw, 0)
        if name not in store:
            W, tbl = args[w_arg], args[w_arg + 1]
            rows = has_holes(W, kernel_slabs(K, B, None)) & (tbl[:, 0] >= 0)
            if bool(rows.any()):
                store[name] = keep(args, kw, int(rows.sum()))
        return orig(*args, **kw)
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def run_cat_train(lgb, params, X, y, z, e2e):
    """Phase 10: categorical splits on phase 3's rows with columns 0-3 as
    category codes: (a) train(), binary, on the megastep body; (b) the bare
    update() loop on the epilogue body; (c) multiclass, 5 classes; then
    level_pass, route_pass and epilogue_pass against their plain versions
    on the route tables of the first categorical trees whose W holds a row
    with holes (epilogue_pass on run b's deferred table where it has such
    a row, else on run b's first level table with that level's rows and
    the epilogue's own score, operand and bag rows). Returns each run's
    wrapper launches and the check."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops.layout import feature_layout
    Xc = _cat_codes(X, DATA_SEED + 400)
    cats = list(range(len(CAT_CARDINALITIES)))
    ds, construct_s = _timed_run(lambda: lgb.Dataset(
        Xc, label=y, categorical_feature=cats, params=params).construct())
    K, B = feature_layout(ds._inner.num_features, ds._inner.max_num_bin)
    cuts, _ = class_runs(z)
    y_mc = np.digitize(z, cuts).astype(np.float32)
    store = {}
    undo = [_capture_holes(frontier2, "level_pass", 3, K, B, store),
            _capture_holes(gbdt_mod, "epilogue_pass", 2, K, B, store)]
    out, n_rows = {}, 100_000
    try:
        for run, extra, labels, rounds in (
                ("a", {}, y, ROUNDS), ("b", {}, y, UPDATES),
                ("c", {"objective": "multiclass", "num_class": 5}, y_mc,
                 CAT_CLASS_ROUNDS)):
            ds.set_label(labels)
            ds.params = {}
            p = dict(params, **extra)
            if run == "b":
                def fit():
                    b = lgb.Booster(params=p, train_set=ds)
                    for _ in range(rounds):
                        b.update()
                    return b
            else:
                def fit():
                    return lgb.train(p, ds, rounds)
            counts = _run_counts()
            bst, train_s = _timed_run(fit)
            launches, cuda, syncs = counts()
            g = bst._gbdt
            k = g.num_tree_per_iteration
            n_trees = bst.num_trees()
            cat_splits = [int((m.decision_type[:m.num_internal] & 1).sum())
                          for m in bst.models]
            scores = bst.train_scores().float().cpu().numpy()
            raw = walk_predict(bst, Xc[:n_rows], raw_score=True)
            want = scores[..., :n_rows] if k == 1 else scores[:, :n_rows].T
            pred_err = float(np.abs(raw - want).max())
            again = lgb.Booster(params={"device_type": DEVICE},
                                model_str=bst.model_to_string())
            text_equal = bool(np.array_equal(
                walk_predict(again, Xc[:n_rows], raw_score=True), raw))
            res = {"phase": "cat_train", "run": run,
                   "objective": p["objective"],
                   "body": ("epilogue" if run == "b" and g._use_epilogue()
                            else "megastep"), "rounds": rounds,
                   "trees": n_trees, "construct_s": construct_s,
                   "leaves": sorted({m.num_leaves for m in bst.models}),
                   "categorical_splits_per_tree": cat_splits,
                   "train_s": train_s, "sec_per_iter": train_s / rounds,
                   "phase3_sec_per_iter_after_first":
                       e2e["sec_per_iter_after_first"],
                   "launches_per_tree": {a: v / n_trees
                                         for a, v in launches.items()},
                   "cuda_launches_per_tree": {a: v / n_trees
                                              for a, v in cuda.items()},
                   "host_syncs_per_tree": syncs / n_trees,
                   "predict_max_abs_err": pred_err,
                   "predict_tol": "rtol=1e-5 atol=1e-5",
                   "model_text_round_trip_equal": text_equal}
            if k == 1:
                res["train_auc"] = auc(scores, labels)
                ok_quality = res["train_auc"] > 0.75
            else:
                first = class_loss("multiclass", walk_predict(
                    bst, Xc[:n_rows], raw_score=True, num_iteration=1),
                    labels[:n_rows])
                last = class_loss("multiclass", raw, labels[:n_rows])
                res["train_loss_after_1_and_all"] = [first, last]
                ok_quality = last < first
            emit(res)
            if not (ok_quality and text_equal and n_trees == k * rounds
                    and np.allclose(raw, want, rtol=1e-5, atol=1e-5)
                    and (run == "c" or min(cat_splits) > 0)
                    and sum(cat_splits) > 0):
                raise AssertionError(f"cat run ({run}): {res}")
            lv = launches["level_pass"]
            if run == "b":
                ok = (launches["epilogue_pass"] == n_trees
                      and launches["route_pass"] == 0
                      and launches["table_lookup"] == 0
                      and 8 * n_trees <= lv <= 10 * n_trees)
            else:
                ok = (launches["route_pass"] == launches["table_lookup"]
                      == n_trees and launches["epilogue_pass"] == 0
                      and 9 * n_trees <= lv <= 11 * n_trees)
            if not ok or launches["hist_pass"]:
                raise AssertionError(f"cat run ({run}) launched {launches} "
                                     f"for {n_trees} trees")
            check_stages(launches, cuda, f"cat run ({run})")
            out[run] = dict(launches,
                            **{"cuda:" + a: v for a, v in cuda.items()})
            if "level_pass" in store:       # each run's first such table
                store["level_pass@" + run] = store.pop("level_pass")
    finally:
        for u in undo:
            u()
        ds.set_label(y)
        ds.params = {}
    # the kernels on a real categorical tree's route tables
    missing = {"level_pass@a", "level_pass@b", "epilogue_pass:any"} \
        - set(store)
    if missing:
        raise AssertionError(f"no route table with holes reached "
                             f"{sorted(missing)}")
    rel = {}
    for run in ("a", "b"):
        args, kw, rows = store["level_pass@" + run]
        ops, fm = tuple(args[:5]), args[5] if len(args) > 5 else None
        rel[run] = check_level_tables(ops, fm, kw, f"level_pass on run "
                                      f"({run})'s categorical W")
    if "epilogue_pass" in store:
        eargs, ekw, erows = store["epilogue_pass"]
        etable = "the deferred table of run (b)"
    else:
        eargs, ekw, _ = store["epilogue_pass:any"]
        largs, _, erows = store["level_pass@b"]
        eargs = [eargs[0], largs[1], largs[3], largs[4]] + eargs[4:]
        etable = "run (b)'s first level table with holes"
    errs, _ = compare_epilogue(tuple(eargs), ekw, float64_hist=True)
    args, kw, rows = store["level_pass@a"]
    ops = tuple(args[:5])
    W = ops[3]
    k0 = int(np.nonzero((has_holes(W, kernel_slabs(K, B, None))
                         & (ops[4][:, 0] >= 0)).cpu().numpy())[0][0])
    j0 = int(W[k0].nonzero()[0]) // B
    check = {"phase": "cat_train", "run": "kernel_check",
             "level_pass_W_rows_with_holes": rows,
             "epilogue_pass_W_rows_with_holes": erows,
             "epilogue_pass_table": etable,
             "example_row_feature": j0,
             "example_row_left_bins": (W[k0, j0 * B:(j0 + 1) * B]
                                       .nonzero()[:, 0].tolist()),
             "level_pass_hist_max_rel_err": rel,
             "level_pass_tol": "rel 1e-5 of the plane max; weight "
                               "channel exact; new leaves equal",
             "route_pass_equal_to_full_sum": True,
             "epilogue_pass": errs}
    emit(check)
    out["kernel_check"] = check
    return out


def run_updates(lgb, params, ds, X, y, megastep=False):
    """bench.py's loop on the card: Booster(params, train_set), warm-up
    updates, then UPDATES timed ones, each ending in a synchronize; on the
    megastep body (what train() runs) when ``megastep``, else on the
    epilogue body. Returns (the phase's JSON, the wrappers' launches and
    the CUDA kernels' launches in the timed run)."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    ds.params = {}      # each run trains on its own parameters alone
    bst = lgb.Booster(params=params, train_set=ds)
    bst._gbdt.arm_megastep(megastep)
    for _ in range(WARMUP_UPDATES):
        bst.update()
    torch.cuda.synchronize()
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    times = []
    for _ in range(UPDATES):
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = walk_predict(bst, X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    epilogue = not megastep and bst._gbdt._use_epilogue()
    res = {"body": "epilogue" if epilogue else "megastep",
           "updates": UPDATES, "warmup_updates": WARMUP_UPDATES,
           "trees": n_trees, "sec_per_iter": float(np.mean(times)),
           "sec_per_iter_median": float(np.median(times)),
           "train_auc": train_auc, "launches": launches,
           "cuda_launches": cuda,
           "host_syncs_per_tree": syncs / UPDATES,
           "predict_max_abs_err": pred_err,
           "predict_tol": "rtol=1e-5 atol=1e-5",
           "leaves": [m.num_leaves for m in bst.models]}
    if n_trees != UPDATES + WARMUP_UPDATES:
        raise AssertionError(f"update() grew {n_trees} trees")
    if not train_auc > 0.75:
        raise AssertionError(f"update() training AUC {train_auc} <= 0.75")
    if epilogue and launches["epilogue_pass"] <= 0:
        raise AssertionError("epilogue_pass never launched on the "
                             "update() path")
    if not ok_pred:
        raise AssertionError(f"update() predict differs from the "
                             f"trainer's scores by {pred_err}")
    check_stages(launches, cuda, "update()")
    return res, launches, cuda


def run_frontier(lgb, params, ds, X, y):
    """train() on the frontier-v1 engine, timed as phase 3 times the fused
    engine; returns the wrappers' and the CUDA kernels' launches in the
    ROUNDS-round run."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    p = dict(params, tpu_engine="frontier")

    def timed_train(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.params = {}
        b = lgb.train(p, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    timed_train(1)                        # warm-up
    _, t_one = timed_train(1)
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    bst, t_all = timed_train(ROUNDS)
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = walk_predict(bst, X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    emit({"phase": "frontier_train", "engine": "frontier",
          "use_frontier": bool(bst._gbdt.use_frontier),
          "bagging": bool(bst._gbdt.is_bagging), "rounds": ROUNDS,
          "trees": n_trees,
          "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
          "train_s": t_all, "train_auc": train_auc, "launches": launches,
          "cuda_launches": cuda,
          "hist_pass_per_tree": launches["hist_pass"] / max(n_trees, 1),
          "host_syncs_per_tree": syncs / max(n_trees, 1),
          "predict_max_abs_err": pred_err,
          "predict_tol": "rtol=1e-5 atol=1e-5",
          "leaves": [m.num_leaves for m in bst.models]})
    if not bst._gbdt.use_frontier:
        raise AssertionError("tpu_engine=frontier did not take the "
                             "frontier engine")
    if n_trees != ROUNDS:
        raise AssertionError(f"frontier trained {n_trees} trees")
    if not train_auc > 0.75:
        raise AssertionError(f"frontier training AUC {train_auc} <= 0.75")
    for name, n in launches.items():
        if (n > 0) != (name in FRONTIER_KERNELS):
            raise AssertionError(f"kernel {name} launched {n} times on the "
                                 "frontier train() path")
    # a full tree: the root and one histogram per level, one n_sel read per
    # level (frontier.level_count); smaller trees (a rehearsal on the CPU
    # at a few thousand rows) take fewer
    from lightgbm_tpu_torch.models.frontier import level_count
    L = params["num_leaves"]
    levels = level_count(L, -1, 64)
    per_tree = launches["hist_pass"] / max(n_trees, 1)
    if DEVICE == "cuda" and (per_tree != levels + 1
                             or syncs / max(n_trees, 1) != levels
                             or {m.num_leaves for m in bst.models} != {L}):
        raise AssertionError(f"frontier trees left the schedule: "
                             f"{per_tree} hist_pass calls and "
                             f"{syncs / max(n_trees, 1)} syncs per tree "
                             f"({levels + 1} and {levels} for {L} leaves)")
    if not ok_pred:
        raise AssertionError(f"frontier predict differs from the trainer's "
                             f"scores by {pred_err}")
    check_stages(launches, cuda, "frontier train()")
    return launches, cuda


def run_plane_cuts(lgb, params, X, y):
    """Phase 6: train() on the mixed-cardinality rows, the runs of
    PLANE_RUNS, each timed as phase 3 times the fused engine. Returns
    each run's kernel and variant launches in its ROUNDS-round run, and
    its CUDA kernels' launches under ``cuda:<kernel>``."""
    import torch
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import fused_level as fl
    X = X.copy()
    X[:, NARROW_FROM:] = np.floor(X[:, NARROW_FROM:] * 8.0) / 8.0
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    construct_s = time.perf_counter() - t0
    nb = ds._inner.num_bin_per_feat
    out = {}
    for name, extra in PLANE_RUNS:
        p = dict(params, **extra)

        def timed_train(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ds.params = {}
            b = lgb.train(p, ds, num_boost_round=rounds)
            torch.cuda.synchronize()
            return b, time.perf_counter() - t

        timed_train(1)                    # warm-up
        _, t_one = timed_train(1)
        fl.reset_launch_counts()
        frontier2.host_syncs["count"] = 0
        bst, t_all = timed_train(ROUNDS)
        launches = dict(fl.launches)
        cuda = dict(fl.cuda_launches)
        variants = {k: v for k, v in fl.variant_launches.items() if v}
        syncs = frontier2.host_syncs["count"]
        g = bst._gbdt
        n_trees = bst.num_trees()
        scores = bst.train_scores().float().cpu().numpy()
        train_auc = auc(scores, y)
        pred = walk_predict(bst, X[:100_000], raw_score=True)
        pred_err = float(np.abs(pred - scores[:100_000]).max())
        ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                                   atol=1e-5))
        fb = (g.fused_packed.fb if g.fused_packed is not None
              else g.fused_f_oh * g.fused_Bp)
        res = {"phase": "plane_cuts_train", "run": name, "params": extra,
               "rows": ROWS, "features": FEATURES,
               "narrow_features_num_bin": sorted({int(v) for v in
                                                  nb[NARROW_FROM:]}),
               "construct_s": construct_s, "rounds": ROUNDS,
               "trees": n_trees,
               "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
               "train_s": t_all, "train_auc": train_auc,
               "quant_bits": g.quant_bits, "nch": g.fused_nch,
               "launches": launches, "variant_launches": variants,
               "cuda_launches": cuda,
               "launches_per_tree": {k: v / max(n_trees, 1)
                                     for k, v in launches.items()},
               "host_syncs_per_tree": syncs / max(n_trees, 1),
               "flat_width": fb,
               "padded_flat_width": g.fused_f_oh * g.fused_Bp,
               "screening_active_features": g.screening_active_features(),
               "predict_max_abs_err": pred_err,
               "predict_tol": "rtol=1e-5 atol=1e-5",
               "leaves": [m.num_leaves for m in bst.models]}
        emit(res)
        out[name] = res
        if n_trees != ROUNDS:
            raise AssertionError(f"run ({name}) trained {n_trees} trees")
        if not ok_pred:
            raise AssertionError(f"run ({name}) predict differs from the "
                                 f"trainer's scores by {pred_err}")
        if launches["epilogue_pass"] or launches["hist_pass"]:
            raise AssertionError(f"run ({name}) left the megastep body")
        check_stages(launches, cuda, f"run ({name})")
    # the megastep schedule: one n_sel read per scheduled level, one
    # lookup per tree; a full tree (num_leaves leaves, as every tree of
    # these rows grows on the card) takes a root pass plus one pass per
    # level until the leaf budget is spent, the last of them route-only.
    # quant8 (nch 3) has a wider slot cap, so one level fewer than (a).
    # A rehearsal on the CPU at a few thousand rows grows smaller trees:
    # there the passes are only bounded by the schedule
    a = out["a"]
    L = params["num_leaves"]
    for name, r in out.items():
        n = r["launches_per_tree"]
        cap = fl.max_slot_cap(r["padded_flat_width"], r["nch"])
        caps = frontier2.level_caps(L, -1, 3, cap)
        full = frontier2.level_caps(L, -1, 0, cap)
        if DEVICE == "cuda":
            left = (n["level_pass"] != len(full) or n["route_pass"] != 1
                    or r["host_syncs_per_tree"] != len(caps)
                    or set(r["leaves"]) != {L})
        else:
            left = (n["route_pass"] > 1
                    or n["level_pass"] + n["route_pass"] > 1 + len(caps)
                    or r["host_syncs_per_tree"] > len(caps))
        if left or n["table_lookup"] != 1:
            raise AssertionError(
                f"run ({name}) left the megastep schedule ({len(full)} "
                f"passes and {len(caps)} syncs per {L}-leaf tree): {n}, "
                f"{r['host_syncs_per_tree']} syncs, leaves {r['leaves']}")
        if r["host_syncs_per_tree"] > a["host_syncs_per_tree"]:
            raise AssertionError(f"run ({name}) makes more host syncs per "
                                 "tree than run (a)")
        if abs(r["train_auc"] - a["train_auc"]) > 0.05:
            raise AssertionError(f"run ({name}) AUC {r['train_auc']} is "
                                 f"not within 0.05 of run (a)'s")
    b = out["b"]
    if not b["flat_width"] < b["padded_flat_width"]:
        raise AssertionError("adaptive bins did not pack the flat axis")
    return {name: dict(r["launches"], **r["variant_launches"],
                       **{"cuda:" + k: v
                          for k, v in r["cuda_launches"].items()})
            for name, r in out.items()}


def _bundle_layout(Bc_p):
    """A synthetic bundle layout whose widest column pads to ``Bc_p``:
    (num_bin, missing_type, default_bin, most_freq_bin per logical
    feature, the bundles, the categorical feature). 256: 6 dense
    singletons of 63 bins and 10 bundles of six 40-bin members (241
    bins); 512: 8 bundles of seven 63-bin members (442 bins, phase 11b's
    layout); 4096: one bundle of 64 members of 63 bins (4,033, phase
    11c's); 16384: one of 256 such members (16,129). Each layout has a
    member with missing type Zero (default bin 5), one with NaN (the last
    bin) and a categorical one."""
    if Bc_p == 256:
        nb = [63] * 6 + [40] * 60
        bundles = [[f] for f in range(6)] + [list(range(6 + 6 * i,
                                                        12 + 6 * i))
                                             for i in range(10)]
    else:
        m, c = {512: (7, 8), 4096: (64, 1), 16384: (256, 1)}[Bc_p]
        nb = [63] * (m * c)
        bundles = [list(range(m * i, m * (i + 1))) for i in range(c)]
    F = len(nb)
    nb = np.asarray(nb, np.int32)
    mt = np.zeros(F, np.int32)
    db = np.zeros(F, np.int32)
    mfb = np.zeros(F, np.int32)
    mt[F - 1], db[F - 1] = 1, 5          # zero-missing member
    mt[F - 2] = 2                        # NaN member: the last bin
    return nb, mt, db, mfb, bundles, F - 3


def _bundle_inputs(Rp, R, Bc_p, seed, quant_bits=0):
    """Level-pass operands over bundle columns: each column's rows owned
    by one member at random (or by none: bundle bin 0), the member's
    logical bin uniform in [1, num_bin) encoded at its offset (ops/efb.py);
    Sp = max_slot_cap(C_oh * Bc_p, nch) slots on random members, one
    categorical (a random bin set, bin 0 out), the last slot inactive;
    route table from build_route_table_bundled. Returns ((bins_T, leaf_T,
    gh_T, W, tbl), the wrappers' keywords, the layout summary)."""
    import torch
    from lightgbm_tpu_torch.ops import efb
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops.layout import feature_layout
    from lightgbm_tpu_torch.ops.quantize import QNCH
    dev = torch.device(DEVICE)
    nb, mt, db, mfb, bundles, cat_f = _bundle_layout(Bc_p)
    layout = efb.BundleLayout(bundles, nb)
    C = layout.num_columns
    C_oh, Bcp = feature_layout(C, max(layout.col_num_bin))
    assert Bcp == Bc_p, (Bcp, Bc_p)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.zeros((max(C_oh, 8), Rp), dtype=torch.int16, device=dev)
    for ci, members in enumerate(bundles):
        owner = torch.randint(-1 if len(members) > 1 else 0, len(members),
                              (R,), generator=gen, device=dev)
        m_nb = torch.as_tensor(nb[members], device=dev)
        m_off = torch.as_tensor(layout.offset_of_feat[members], device=dev)
        o = owner.clamp(min=0)
        b = 1 + (torch.rand(R, generator=gen, device=dev)
                 * (m_nb[o] - 1)).long()
        bins[ci, :R] = torch.where(owner >= 0, m_off[o] + b, 0).to(
            torch.int16)
    nch = QNCH[quant_bits] if quant_bits else fl.NCH_PRECISE
    Sp = fl.max_slot_cap(C_oh * Bc_p, nch)
    leaf = torch.randint(0, Sp - 1, (Rp,), generator=gen, device=dev,
                         dtype=torch.int32)
    leaf[R:] = -1
    w = (torch.rand(Rp, generator=gen, device=dev) >= 0.3).float()
    w[R:] = 0
    g = torch.randn(Rp, generator=gen, device=dev) * w
    h = torch.rand(Rp, generator=gen, device=dev) * 0.25 * w
    if quant_bits:
        gh_T, _ = fl.pack_gh_quant(g, h, w, quant_bits, seed=seed)
    else:
        gh_T = fl.pack_gh(g, h, w, nch)
    rng = np.random.RandomState(seed)
    F = len(nb)
    feat = rng.randint(0, F, Sp).astype(np.int32)
    feat[:3] = [cat_f, F - 1, F - 2]     # categorical, Zero, NaN members
    feat[-1] = -1
    thr = (rng.rand(Sp) * (nb[feat] - 1)).astype(np.int32)
    dl = rng.rand(Sp) < 0.5
    Bl = 64
    cat_flag = np.zeros(Sp, bool)
    cat_flag[0] = True
    cat_mask = rng.rand(Sp, Bl) < 0.4
    cat_mask[:, 0] = False
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    W = fl.build_route_table_bundled(
        t(feat), t(thr), t(dl), t(nb), t(mt), t(db), t(mfb),
        t(layout.col_of_feat), t(layout.offset_of_feat), C_oh, Bc_p,
        cat_flag=t(cat_flag), cat_mask=t(cat_mask))
    tbl = np.zeros((Sp, 128), np.int32)
    tbl[:, 0] = np.where(feat >= 0, np.arange(Sp), -2)
    tbl[:, 1] = np.where(feat >= 0, Sp, 0)
    tbl[:, 2] = rng.randint(0, 2, Sp)
    kw = dict(num_bins=Bc_p, f_oh=C_oh, nch=nch, quant_bits=quant_bits,
              packed=None)
    summary = {"logical_features": F, "bundle_columns": C, "C_oh": C_oh,
               "Bc": max(layout.col_num_bin), "Bc_p": Bc_p, "Sp": Sp,
               "FB": C_oh * Bc_p, "bins": "int16"}
    return (bins.contiguous(), leaf[None, :], gh_T, W, t(tbl)), kw, summary


def bundled_level_rows(ops, fm, kw, what):
    """``level_pass`` f32 (``check_level_tables``: new leaves equal, planes
    within 1e-5 of the plane max, the weight channel exact) and
    ``route_pass`` against their plain versions on one set of bundled
    operands, the f32 planes' bits equal on a second call, each active W
    row's slab found (the owning column); each timed per launch, with
    bounds from these operands' rows. Returns the fields and the rows."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    bins_T, leaf_T, gh_T, W, tbl = ops
    K, B, nch = kw["f_oh"], kw["num_bins"], kw["nch"]
    Rp = bins_T.shape[1]
    slab_k = fl.slab_table_plain(W, num_bins=B, f_oh=K)
    if not bool((slab_k[tbl[:, 0] >= 0] >= 0).all()):
        raise AssertionError(f"{what}: an active W row spans several slabs")
    rel = check_level_tables(ops, fm, kw, what + " f32")
    hist_a, _ = fl.level_pass(*ops, fm, **kw)
    hist_b, _ = fl.level_pass(*ops, fm, **kw)
    torch.cuda.synchronize()
    if not torch.equal(hist_a, hist_b):
        raise AssertionError(f"{what}: level_pass f32 planes differ between "
                             "two calls")
    hist_p, _ = fl.level_pass_plain(*ops, fm, **kw)
    abs_err = float((hist_a.double() - hist_p.double()).abs().max())
    # bytes: leaf in and out of every row, the routed bin of each slotted
    # row, the K bins and nch channels of each marked row, W, tbl, the
    # histogram out; ops: a compare per routed row, K*nch adds per marked
    # row (these operands' counts)
    in_slot = int((leaf_T[0][:, None] == tbl[:, 0][None, :]).any(1).sum())
    marked = int(fl.level_mark_plain(*ops, fm, **kw)[2][-1])
    lvl_b, lvl_by = bound(Rp * 8 + in_slot * 2 + marked * (K * 2 + nch * 2)
                          + W.numel() * 2 + tbl.numel() * 4
                          + hist_p.numel() * 4, in_slot + marked * K * nch)
    rt_b, rt_by = bound(Rp * 8 + in_slot * 2 + W.numel() * 2, in_slot)
    Cw, Bw, nr = fl.level_tile_shape(K, B, nch, fl._smem_budget(
        bins_T.device))
    rkw = dict(num_bins=B, f_oh=K)
    out = {"C_oh": K, "Bc_p": B, "Sp": tbl.shape[0], "FB": W.shape[1],
           "bins": str(bins_T.dtype).replace("torch.", ""),
           "level_f32_hist_max_rel_err": rel, "level_f32_abs_err": abs_err,
           "level_tol": "rel 1e-5 of the plane max; weight channel exact",
           "same_bits_on_two_calls": True, "marked_rows": marked,
           "slotted_rows": in_slot,
           "hist_tile": {"Cw": Cw, "Bw": Bw, "record_lanes": nr,
                         "row_groups": -(-K // Cw),
                         "bin_groups": -(-B // Bw)},
           "level_pass": {
               "max_abs_err": abs_err,
               "kernel_ms": cuda_ms(lambda: fl.level_pass(*ops, fm, **kw)),
               "plain_ms": call_ms(lambda: fl.level_pass_plain(
                   *ops, fm, **kw), reps=3, warmup=1),
               "library_ms": None, "bound_ms": lvl_b, "bound_by": lvl_by},
           "route_pass": {
               "max_abs_err": 0,
               "kernel_ms": cuda_ms(lambda: fl.route_pass(
                   bins_T, leaf_T, W, tbl, **rkw)),
               "plain_ms": call_ms(lambda: fl.route_pass_plain(
                   bins_T, leaf_T, W, tbl, **rkw), reps=3, warmup=1),
               "library_ms": None, "bound_ms": rt_b, "bound_by": rt_by}}
    return out


def bundled_epilogue_row(args, ekw, float64_hist=False):
    """``epilogue_pass`` against its plain version on one set of bundled
    operands (``compare_epilogue``), timed per launch, with the bound from
    these operands' rows."""
    from lightgbm_tpu_torch.ops import fused_level as fl
    bins_T, leaf_T, W, tbl, lv = args[:5]
    K, B, nch = ekw["f_oh"], ekw["num_bins"], ekw["nch"]
    Rp = bins_T.shape[1]
    n0 = fl.launches["epilogue_pass"]
    errs, gh_p = compare_epilogue(tuple(args), ekw, float64_hist)
    if fl.launches["epilogue_pass"] - n0 != 1:
        raise AssertionError(f"bundled Bc_p={B}: epilogue_pass did not "
                             "launch")
    in_slot = int((leaf_T[0][:, None] == tbl[:, 0][None, :]).any(1).sum())
    nonzero = int((gh_p[:nch].float() != 0).any(0).sum())
    e_b, e_by = bound(Rp * (K * 2 + 4 + 8 + 8 + 4 + 16) + W.numel() * 2
                      + tbl.numel() * 4 + lv.numel() * 4
                      + K * B * nch * 8 * 4,
                      in_slot + Rp * 20 + nonzero * K * nch)
    return {**errs,
            "max_abs_err": max(errs["hist_max_abs_err"],
                               errs["gh_max_abs_err"],
                               errs["new_score_max_abs_err"]),
            "kernel_ms": cuda_ms(lambda: fl.epilogue_pass(*args, **ekw)),
            "plain_ms": call_ms(lambda: fl.epilogue_pass_plain(*args, **ekw),
                                reps=3, warmup=1),
            "library_ms": None, "bound_ms": e_b, "bound_by": e_by}


def check_bundled(Rp, R, Bc_p, seed):
    """Phase 2 on a synthetic bundle layout of ``Bc_p`` bins
    (``_bundle_inputs``): ``bundled_level_rows``, ``level_pass`` quantized
    to 16 bits exact against its plain version, and ``epilogue_pass`` on
    the same route table as its deferred table
    (``bundled_epilogue_row``)."""
    import torch
    from lightgbm_tpu_torch.ops import fused_level as fl
    ops, kw, out = _bundle_inputs(Rp, R, Bc_p, seed)
    bins_T, leaf_T, gh_T, W, tbl = ops
    what = f"bundled Bc_p={Bc_p}"
    out.update(bundled_level_rows(ops, None, kw, what))
    ops_q, kw_q, _ = _bundle_inputs(Rp, R, Bc_p, seed, quant_bits=16)
    check_level_tables(ops_q, None, kw_q, what + " quant16")
    out["level_tol"] += "; quant16 exact"
    out["level_pass"]["quant16_ms"] = cuda_ms(
        lambda: fl.level_pass(*ops_q, **kw_q))
    # the epilogue on the same table (deferred), binary
    dev = bins_T.device
    rng = np.random.RandomState(seed + 1)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    L = 255
    lv = t((rng.randn(L) * 0.1).astype(np.float32))
    score = np.zeros((1, Rp), np.float32)
    score[0, :R] = rng.randn(R)
    opsr = np.zeros((8, Rp), np.float32)
    opsr[0, :R] = np.where(rng.rand(R) < 0.4, 1.0, -1.0)
    opsr[1, :R] = rng.uniform(0.5, 2.0, R)
    bag = np.zeros((1, Rp), np.float32)
    bag[0, :R] = rng.rand(R) >= 0.3
    args = (bins_T, leaf_T, W, tbl, lv, t(score), t(opsr), t(bag))
    ekw = dict(num_bins=Bc_p, f_oh=kw["f_oh"], nch=kw["nch"], kind="binary",
               sigmoid=1.0)
    out["epilogue_pass"] = bundled_epilogue_row(args, ekw)
    return out


def bundled_row(kernel, res, launches, launches_in, tag="bundled"):
    """A kernels-line row of ``kernel`` on one captured or synthetic layout
    (``res``: ``bundled_level_rows`` with the epilogue's row), its
    launches those of the one run that gave it these operands; ``tag``
    names the layout's kind."""
    r = res[kernel]
    Sp = r.get("Sp", res["Sp"])
    return {"name": f"{kernel}[{tag} C_oh={res['C_oh']} Bc_p="
                    f"{res['Bc_p']} Sp={Sp}]",
            "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches,
            "launches_in": launches_in, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}


def _capture_call(module, name, index, store):
    """Wrap ``module.name`` (a kernel wrapper) so that the operands of its
    call number ``index`` (from 0) are kept, cloned, in ``store[name]``
    (the clones are queued on the stream: no host sync); returns the
    undo."""
    orig = getattr(module, name)
    seen = [0]

    def wrapper(*args, **kw):
        if seen[0] == index:
            store[name] = ([a.clone() if hasattr(a, "clone") else a
                            for a in args], dict(kw))
        seen[0] += 1
        return orig(*args, **kw)
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def captured(fit, kernels):
    """((fit(), seconds), store): ``fit`` timed (``_timed_run``) with the
    calls of ``kernels`` ((module, wrapper, call index) each) captured
    into ``store`` (``_capture_call``)."""
    store = {}
    undo = [_capture_call(mod, name, index, store)
            for mod, name, index in kernels]
    try:
        return _timed_run(fit), store
    finally:
        for u in undo:
            u()


def check_captured(store, run, phase="bundle_train", number=11):
    """Phase ``number`` run ``run``'s kernels against their plain versions
    on the operands the run gave them (``_capture_call``): ``level_pass``
    (and ``route_pass`` on the level's table) through
    ``bundled_level_rows``; the run's own ``route_pass`` call exact;
    ``epilogue_pass`` through ``bundled_epilogue_row`` against the float64
    sum (a tree's epilogue sums many equal values: ``compare_epilogue``).
    Returns the fields and rows, emitted as the run's kernel check."""
    from lightgbm_tpu_torch.ops import fused_level as fl
    import torch
    name = f"{number}{run}"
    out = {}
    if "level_pass" in store:
        args, kw = store.pop("level_pass")
        ops, fm = tuple(args[:5]), args[5] if len(args) > 5 else None
        out = bundled_level_rows(ops, fm, kw, f"{name} level_pass")
    elif "epilogue_pass" not in store:
        raise AssertionError(f"{name}: no kernel call was captured")
    if "route_pass" in store:
        args, rkw = store.pop("route_pass")
        got = fl.route_pass(*args, **rkw)
        if not torch.equal(got, fl.route_pass_plain(*args, **rkw)):
            raise AssertionError(f"{name}: route_pass differs from its "
                                 "plain version on the run's last level")
        r = out["route_pass"]
        r["kernel_ms"] = cuda_ms(lambda: fl.route_pass(*args, **rkw))
        r["plain_ms"] = call_ms(lambda: fl.route_pass_plain(*args, **rkw),
                                reps=3, warmup=1)
        r["Sp"] = args[3].shape[0]
        in_slot = int((args[1][0][:, None] == args[3][:, 0][None, :])
                      .any(1).sum())
        r["bound_ms"], r["bound_by"] = bound(
            args[0].shape[1] * 8 + in_slot * 2 + args[2].numel() * 2,
            in_slot)
    if "epilogue_pass" in store:
        args, ekw = store.pop("epilogue_pass")
        out["epilogue_pass"] = bundled_epilogue_row(args, ekw,
                                                    float64_hist=True)
        out.setdefault("C_oh", ekw["f_oh"])
        out.setdefault("Bc_p", ekw["num_bins"])
        out.setdefault("Sp", args[3].shape[0])
    emit({"phase": phase, "run": run, "kernel_check": out})
    return out


def _sparse_rows(n, seed):
    """Phase 11a's Allstate-shaped CSR draw (Ke et al. 2017, Table 1:
    Allstate, 4,228 sparse one-hot features): SPARSE_DENSE standard normal
    columns, then SPARSE_FIELDS categorical fields of SPARSE_LEVELS levels,
    one-hot encoded (one 1.0 per field and row); a binary label from two
    dense columns and a few levels, with noise. Built as CSR directly."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, SPARSE_DENSE).astype(np.float32)
    levels = rng.randint(0, SPARSE_LEVELS, (n, SPARSE_FIELDS))
    nnz = SPARSE_DENSE + SPARSE_FIELDS
    indices = np.empty((n, nnz), np.int32)
    indices[:, :SPARSE_DENSE] = np.arange(SPARSE_DENSE)
    indices[:, SPARSE_DENSE:] = (SPARSE_DENSE + np.arange(SPARSE_FIELDS)
                                 * SPARSE_LEVELS + levels)
    data = np.ones((n, nnz), np.float32)
    data[:, :SPARSE_DENSE] = dense
    X = sp.csr_matrix((data.ravel(), indices.ravel(),
                       np.arange(0, n * nnz + 1, nnz, dtype=np.int64)),
                      shape=(n, SPARSE_DENSE + SPARSE_FIELDS * SPARSE_LEVELS))
    z = (dense[:, 0] + 0.6 * dense[:, 1] + 1.0 * (levels[:, 0] < 30)
         - 1.2 * (levels[:, 1] == 7) + 0.8 * (levels[:, 2] % 3 == 0)
         + 0.5 * rng.randn(n))
    return X, (z > 0).astype(np.float32)


def _exclusive_rows(n, dense, members, seed):
    """``dense`` standard normal columns and ``members`` mutually
    exclusive ones (each row sets at most one, uniform in [0.5, 3)),
    float32; a binary label from the dense columns and the exclusive
    columns' values, with noise."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, dense + members), np.float32)
    X[:, :dense] = rng.randn(n, dense)
    owner = rng.randint(-1, members, n)
    rows = np.nonzero(owner >= 0)[0]
    vals = rng.uniform(0.5, 3.0, rows.size).astype(np.float32)
    X[rows, dense + owner[rows]] = vals
    sign = np.where(np.arange(members) % 3 == 0, 1.0, -0.7)
    z = 0.5 * rng.randn(n)
    if dense:
        z += X[:, 0] + 0.5 * X[:, 1]
    z[rows] += sign[owner[rows]] * (vals - 1.5) * 2.0
    return X, (z > 0).astype(np.float32)


def _bundle_summary_of(ds, params):
    """The bundle layout a booster on ``ds`` trains with (phase 11's
    fields), without training."""
    import lightgbm_tpu_torch as lgb
    ds.params = {}
    return _bundle_summary(lgb.Booster(params=params, train_set=ds))


def _bundle_summary(bst):
    """The booster's bundle layout as phase 11 reports it."""
    g = bst._gbdt
    cols = int(g.bundle_bins_dev.shape[1]) if g.use_bundles else 0
    return {"use_bundles": bool(g.use_bundles), "bundle_columns": cols,
            "Bc": int(getattr(g, "bundle_col_bins", 0)),
            "C_oh": int(g.fused_bundle_cols),
            "Bc_p": int(g.fused_bundle_col_bins),
            "bins_T": str(g.fused_bins_T.dtype).replace("torch.", ""),
            "logical_features": int(g.train_data.num_features)}


def run_bundle_train(lgb, params):
    """Phase 11: exclusive feature bundling and sparse input on the card.
    (a) the Allstate-shaped CSR draw through train() (megastep body,
    prebundled at ingestion); (b) dense default-on EFB, 28 dense and 512
    exclusive columns, through update() (epilogue body) with a valid set,
    then a rollback; (c) 64 exclusive columns of 63 bins, one 4,033-bin
    bundle column (Bc_p = 4096), through update(). Each run's kernels are
    then held to their plain versions on the operands the run gave them
    (``check_captured``: its CAPTURE_LEVEL_CALL-th level_pass call, 11a's
    first route_pass call, the second epilogue_pass call of 11b and 11c).
    Returns (each run's wrapper launches, each run's kernel check)."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.models import frontier2
    out, checks = {}, {}
    level = (frontier2, "level_pass", CAPTURE_LEVEL_CALL)
    # (a) sparse-built, train()
    (X, y), make_s = _timed_run(lambda: _sparse_rows(SPARSE_ROWS,
                                                     DATA_SEED + 500))
    ds, construct_s = _timed_run(lambda: lgb.Dataset(
        X, label=y, params=params).construct())
    counts = _run_counts()
    (bst, t_all), store = captured(lambda: lgb.train(params, ds, ROUNDS),
                                   [level, (frontier2, "route_pass", 0)])
    launches, cuda, syncs = counts()
    ds.params = {}
    _, t_one = _timed_run(lambda: lgb.train(params, ds, 1))
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    n_rows = 100_000
    raw = walk_predict(bst, X[:n_rows], raw_score=True)
    pred_err = float(np.abs(raw - scores[:n_rows]).max())
    feats = sorted({int(f) for m in bst.models
                    for f in m.split_feature[:m.num_internal]})
    text = bst.model_to_string()
    res = {"phase": "bundle_train", "run": "a", "input": "csr",
           "rows": SPARSE_ROWS, "columns": X.shape[1], "nnz": int(X.nnz),
           "make_s": make_s, "construct_s": construct_s,
           **_bundle_summary(bst), "rounds": ROUNDS, "trees": n_trees,
           "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
           "train_s": t_all, "train_auc": train_auc, "auc_floor": 0.75,
           "launches_per_tree": {k: v / n_trees for k, v in launches.items()
                                 if v},
           "cuda_launches_per_tree": {k: v / n_trees
                                      for k, v in cuda.items() if v},
           "host_syncs_per_tree": syncs / n_trees,
           "predict_rows": n_rows, "predict_max_abs_err": pred_err,
           "predict_tol": "rtol=1e-6 atol=1e-6",
           "split_features": {"count": len(feats), "min": feats[0],
                              "max": feats[-1], "one_hot": sum(
                                  f >= SPARSE_DENSE for f in feats)},
           "leaves": [m.num_leaves for m in bst.models]}
    emit(res)
    out["a"] = launches
    if not (res["use_bundles"] and res["Bc_p"] == 256
            and res["bins_T"] == "int16"
            and res["bundle_columns"] < ds._inner.num_features):
        raise AssertionError(f"11a bundled as {_bundle_summary(bst)}")
    if n_trees != ROUNDS or not train_auc > 0.75:
        raise AssertionError(f"11a: {n_trees} trees, AUC {train_auc}")
    if not np.allclose(raw, scores[:n_rows], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"11a: predict on the CSR rows differs from "
                             f"the trainer's scores by {pred_err}")
    if feats[-1] >= X.shape[1] or not res["split_features"]["one_hot"] \
            or f"max_feature_idx={X.shape[1] - 1}" not in text:
        raise AssertionError(f"11a: split features {feats[:5]}..."
                             f"{feats[-5:]} are not logical columns")
    if launches["level_pass"] <= 0 or launches["route_pass"] <= 0:
        raise AssertionError(f"11a launched {launches}")
    check_stages(launches, cuda, "11a")
    checks["a"] = check_captured(store, "a")
    del X, ds, bst, store
    # (b) dense default-on EFB, update() with a valid set, rollback
    X, y = _exclusive_rows(EFB_ROWS, 28, EFB_EXCLUSIVE, DATA_SEED + 600)
    Xv, yv = _exclusive_rows(EFB_VALID_ROWS, 28, EFB_EXCLUSIVE,
                             DATA_SEED + 601)
    ds, construct_s = _timed_run(lambda: lgb.Dataset(
        X, label=y, params=params).construct())
    dv = lgb.Dataset(Xv, label=yv, reference=ds)
    p = dict(params, metric=["auc"])
    counts = _run_counts()

    def fit_b():
        b = lgb.Booster(params=p, train_set=ds)
        b.add_valid(dv, "valid")
        for _ in range(UPDATES):
            b.update()
        return b
    (bst, t_all), store = captured(fit_b, [
        level, (gbdt_mod, "epilogue_pass", 1)])
    launches, cuda, syncs = counts()
    g = bst._gbdt
    valid_auc = dict((m, v) for _, m, v, _ in bst.eval_valid())["auc"]
    before = (g.scores.clone(), g.valid_scores[0].clone(), bst.num_trees())
    bst.update()
    bst.rollback_one_iter()
    d_train = float((g.scores - before[0]).abs().max())
    d_valid = float((g.valid_scores[0] - before[1]).abs().max())
    res = {"phase": "bundle_train", "run": "b", "input": "dense",
           "rows": EFB_ROWS, "valid_rows": EFB_VALID_ROWS,
           "columns": X.shape[1], "construct_s": construct_s,
           **_bundle_summary(bst), "body": "epilogue"
           if g._use_epilogue() else "megastep", "updates": UPDATES,
           "sec_per_iter": t_all / UPDATES, "valid_auc": valid_auc,
           "auc_floor": 0.75,
           "launches_per_tree": {k: v / UPDATES for k, v in launches.items()
                                 if v},
           "host_syncs_per_tree": syncs / UPDATES,
           "rollback_train_max_abs_diff": d_train,
           "rollback_valid_max_abs_diff": d_valid,
           "rollback_bitwise": bool(d_train == 0.0 and d_valid == 0.0),
           "rollback_tol": 1e-6, "leaves": [m.num_leaves
                                            for m in bst.models]}
    emit(res)
    out["b"] = launches
    if not (res["use_bundles"] and res["bundle_columns"] < X.shape[1]
            and launches["epilogue_pass"] == UPDATES):
        raise AssertionError(f"11b: {res}")
    if not valid_auc > 0.75:
        raise AssertionError(f"11b: valid AUC {valid_auc}")
    if bst.num_trees() != before[2] or max(d_train, d_valid) > 1e-6:
        raise AssertionError(f"11b: rollback left {bst.num_trees()} trees, "
                             f"scores off by {d_train}, {d_valid}")
    check_stages(launches, cuda, "11b")
    checks["b"] = check_captured(store, "b")
    del X, Xv, ds, dv, bst, store
    # (c) the widest column: one bundle of 64 x 63 bins, update()
    X, y = _exclusive_rows(EFB_ROWS, 0, WIDE_MEMBERS, DATA_SEED + 700)
    ds = lgb.Dataset(X, label=y, params=params).construct()
    counts = _run_counts()

    def fit_c():
        b = lgb.Booster(params=params, train_set=ds)
        for _ in range(WIDE_UPDATES):
            b.update()
        return b
    (bst, t_all), store = captured(fit_c, [
        level, (gbdt_mod, "epilogue_pass", 1)])
    launches, cuda, syncs = counts()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    raw = walk_predict(bst, X[:n_rows], raw_score=True)
    pred_err = float(np.abs(raw - scores[:n_rows]).max())
    res = {"phase": "bundle_train", "run": "c", "input": "dense",
           "rows": EFB_ROWS, "columns": X.shape[1], **_bundle_summary(bst),
           "updates": WIDE_UPDATES, "sec_per_iter": t_all / WIDE_UPDATES,
           "train_auc": train_auc, "auc_floor": WIDE_AUC_FLOOR,
           "launches_per_tree": {k: v / WIDE_UPDATES
                                 for k, v in launches.items() if v},
           "host_syncs_per_tree": syncs / WIDE_UPDATES,
           "predict_max_abs_err": pred_err,
           "predict_tol": "rtol=1e-6 atol=1e-6",
           "leaves": [m.num_leaves for m in bst.models]}
    emit(res)
    out["c"] = launches
    if not (res["use_bundles"] and res["Bc_p"] == 4096
            and res["bundle_columns"] == 1
            and launches["epilogue_pass"] == WIDE_UPDATES):
        raise AssertionError(f"11c: {res}")
    if not train_auc > WIDE_AUC_FLOOR:
        raise AssertionError(f"11c: training AUC {train_auc}")
    if not np.allclose(raw, scores[:n_rows], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"11c: predict differs from the trainer's "
                             f"scores by {pred_err}")
    check_stages(launches, cuda, "11c")
    checks["c"] = check_captured(store, "c")
    return out, checks


def mono_constraints(w: np.ndarray) -> np.ndarray:
    """sign(w) on the MONO_COLUMNS columns of largest |w|, 0 elsewhere:
    ``_make_data``'s label rises with column j exactly when w[j] > 0."""
    mono = np.zeros(len(w), np.int32)
    top = np.argsort(-np.abs(w))[:MONO_COLUMNS]
    mono[top] = np.sign(w[top]).astype(np.int32)
    return mono


def mono_worst_steps(bst, X, mono, seed):
    """Per constrained column: the worst step of the raw prediction in the
    constraint's direction along a MONO_GRID-point grid over [0, 1], at
    MONO_BASE_ROWS random rows of X (one predict call)."""
    rng = np.random.RandomState(seed)
    base = X[rng.choice(len(X), MONO_BASE_ROWS, replace=False)]
    grid = np.linspace(0.0, 1.0, MONO_GRID, dtype=np.float32)
    cols = np.nonzero(mono)[0]
    Xg = np.repeat(np.tile(base[None, :, None, :], (len(cols), 1, 1, 1)),
                   MONO_GRID, axis=2)                 # [C, B, G, F]
    for i, c in enumerate(cols):
        Xg[i, :, :, c] = grid
    raw = walk_predict(bst, Xg.reshape(-1, X.shape[1]), raw_score=True)
    steps = np.diff(raw.reshape(len(cols), MONO_BASE_ROWS, MONO_GRID),
                    axis=2) * mono[cols][:, None, None]
    return {int(c): float(v) for c, v in zip(cols, steps.min(axis=(1, 2)))}


def _root_on_constrained(bst, mono) -> float:
    """The share of the model's trees whose root splits on a constrained
    column."""
    roots = [int(m.split_feature[0]) for m in bst.models if m.num_leaves > 1]
    return float(np.mean([mono[f] != 0 for f in roots])) if roots else 0.0


def run_mono_train(lgb, params, ds, X, y, w, e2e):
    """Phase 12: monotone constraints on phase 3's rows
    (``mono_constraints(w)``) and the rest of the Booster and Dataset API.
    (a) basic and (b) intermediate mode through train() (megastep body),
    10 rounds; (c) ``monotone_penalty`` through the bare update() loop
    (epilogue body); each with sec/iter, training AUC (> 0.75; its gap to
    phase 3's recorded), launches and host syncs per tree, and the
    worst step of predict along each constrained column
    (``mono_worst_steps``, >= -1e-6). (d) on 12a's model: pred_leaf on
    API_ROWS rows equal to the leaves the trainer routed them to,
    pred_early_stop (the rows still active equal to the full prediction,
    the stopped rows counted), dump_model, feature_importance, refit on
    API_ROWS fresh rows, and a save_binary/load_binary round trip of phase
    3's Dataset that trains one round to the same model text. After each
    of (a)-(c), its kernels are held to their plain versions on its own
    operands (``check_captured``: the CAPTURE_LEVEL_CALL-th level_pass and
    the first route_pass of (a) and (b), the second epilogue_pass of (c)).
    Returns (each run's wrapper launches, each run's kernel check)."""
    import os
    import tempfile
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops.predict import predict_raw_early_stop
    mono = mono_constraints(w)
    out, checks, boosters = {}, {}, {}
    level = (frontier2, "level_pass", CAPTURE_LEVEL_CALL)
    # the constraints are the dataset's (given where it is binned, as in
    # LightGBM): phase 3's rows binned again with them
    dsm, construct_s = _timed_run(lambda: lgb.Dataset(
        X, label=y, params=dict(params, monotone_constraints=mono.tolist()))
        .construct())

    def records(run, bst, launches, cuda, syncs, n_trees):
        scores = bst.train_scores().float().cpu().numpy()
        train_auc = auc(scores, y)
        worst = mono_worst_steps(bst, X, mono, DATA_SEED + 1200)
        return {"phase": "mono_train", "run": run,
                "construct_s": construct_s,
                "mono_mode": bst._gbdt.mono_mode,
                "constraints": mono.tolist(), "train_auc": train_auc,
                "phase3_train_auc": e2e["train_auc"],
                "auc_gap_to_phase3": e2e["train_auc"] - train_auc,
                "auc_floor": 0.75,
                "launches_per_tree": {k: v / n_trees
                                      for k, v in launches.items() if v},
                "cuda_launches_per_tree": {k: v / n_trees
                                           for k, v in cuda.items() if v},
                "host_syncs_per_tree": syncs / n_trees,
                "phase3_host_syncs_per_tree": e2e["host_syncs_per_tree"],
                "worst_step_by_column": worst,
                "worst_step": min(worst.values()), "worst_step_floor": -1e-6,
                "root_on_constrained_share": _root_on_constrained(bst, mono),
                "leaves": [m.num_leaves for m in bst.models]}

    def gate(res, n_trees, want_trees, launches, cuda, name):
        if n_trees != want_trees:
            raise AssertionError(f"{name}: {n_trees} trees")
        if not res["train_auc"] > 0.75:
            raise AssertionError(f"{name}: training AUC {res['train_auc']}")
        if not res["worst_step"] >= -1e-6:
            raise AssertionError(f"{name}: predict breaks a constraint: "
                                 f"{res['worst_step_by_column']}")
        check_stages(launches, cuda, name)

    # (a) basic and (b) intermediate through train(); (a) also records the
    # leaves its trainer routed the first API_ROWS rows to
    trainer_leaves = []
    orig_grow = gbdt_mod.grow_tree_fused

    def recording_grow(*a, **kw):
        res = orig_grow(*a, **kw)
        trainer_leaves.append(res[1][:API_ROWS].clone())
        return res
    for run, method in (("a", "basic"), ("b", "intermediate")):
        p = dict(params, monotone_constraints_method=method)

        def fit(rounds):
            dsm.params = {}
            return lgb.train(p, dsm, rounds)
        _, t_one = _timed_run(lambda: fit(1))
        counts = _run_counts()
        if run == "a":
            gbdt_mod.grow_tree_fused = recording_grow
        try:
            (bst, t_all), store = captured(lambda: fit(ROUNDS), [
                level, (frontier2, "route_pass", 0)])
        finally:
            gbdt_mod.grow_tree_fused = orig_grow
        launches, cuda, syncs = counts()
        n_trees = bst.num_trees()
        res = records(run, bst, launches, cuda, syncs, n_trees)
        res.update({"body": "megastep", "rounds": ROUNDS,
                    "sec_per_iter_after_first": (t_all - t_one)
                    / (ROUNDS - 1), "train_s": t_all,
                    "phase3_sec_per_iter_after_first":
                    e2e["sec_per_iter_after_first"]})
        emit(res)
        gate(res, n_trees, ROUNDS, launches, cuda, f"12{run}")
        if res["mono_mode"] != method:
            raise AssertionError(f"12{run} trained in {res['mono_mode']}")
        for name in TRAIN_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"12{run}: {name} never launched")
        out[run] = launches
        boosters[run] = bst
        checks[run] = check_captured(store, run, "mono_train", 12)
    # (c) the penalty through the bare update() loop (epilogue body)
    p = dict(params, monotone_penalty=MONO_PENALTY)

    def fit_c():
        dsm.params = {}
        b = lgb.Booster(params=p, train_set=dsm)
        for _ in range(UPDATES):
            b.update()
        return b
    counts = _run_counts()
    (bst, t_all), store = captured(fit_c, [(gbdt_mod, "epilogue_pass", 1)])
    launches, cuda, syncs = counts()
    res = records("c", bst, launches, cuda, syncs, UPDATES)
    res.update({"body": "epilogue" if bst._gbdt._use_epilogue()
                else "megastep", "updates": UPDATES,
                "monotone_penalty": MONO_PENALTY,
                "sec_per_iter": t_all / UPDATES})
    emit(res)
    gate(res, bst.num_trees(), UPDATES, launches, cuda, "12c")
    if res["body"] != "epilogue" or launches["epilogue_pass"] != UPDATES:
        raise AssertionError(f"12c: {res['body']} body, epilogue_pass "
                             f"launched {launches['epilogue_pass']} times")
    out["c"] = launches
    checks["c"] = check_captured(store, "c", "mono_train", 12)
    del bst, store
    # (d) the rest of the Booster and Dataset API on 12a's model
    bst = boosters["a"]
    Xs = X[:API_ROWS]
    leaves, leaf_s = _timed_run(lambda: bst.predict(Xs, pred_leaf=True))
    routed = torch.stack(trainer_leaves, 1).cpu().numpy()
    full = walk_predict(bst, Xs, raw_score=True)
    margin = float(np.median(np.abs(full)))
    es, es_s = _timed_run(lambda: bst.predict(
        Xs, raw_score=True, pred_early_stop=True,
        pred_early_stop_freq=EARLY_STOP_FREQ,
        pred_early_stop_margin=margin))
    _, active = predict_raw_early_stop(
        bst.models, torch.as_tensor(Xs.astype(np.float64), device=DEVICE),
        1, EARLY_STOP_FREQ, margin)
    active = active.cpu().numpy()
    dump = bst.dump_model()
    imp_split = bst.feature_importance("split")
    imp_gain = bst.feature_importance("gain")
    n_splits = sum(int((m.split_gain[:m.num_internal] > 0).sum())
                   for m in bst.models)
    Xr, zr = _valid_z(API_ROWS, w, DATA_SEED + 1300)
    yr = (zr > 0).astype(np.float32)
    refit, refit_s = _timed_run(lambda: bst.refit(Xr, yr, decay_rate=0.9))
    refit_auc = auc(walk_predict(refit, Xr, raw_score=True), yr)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "phase3.bin")
    try:
        _, save_s = _timed_run(lambda: ds.save_binary(path))
        loaded = lgb.Dataset(path, params={"device_type": DEVICE})
        _, load_s = _timed_run(loaded.construct)
        on_host = loaded._inner._bins_dev is None
        ds.params = {}
        want = lgb.train(params, ds, 1).model_to_string()
        got = lgb.train(params, loaded, 1).model_to_string()
        bins_equal = bool(torch.equal(loaded._inner.bins_dev,
                                      ds._inner.bins_dev))
        file_mb = os.path.getsize(path) / 2 ** 20
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    res = {"phase": "mono_train", "run": "d", "rows": API_ROWS,
           "pred_leaf_shape": list(leaves.shape), "pred_leaf_s": leaf_s,
           "pred_leaf_equals_trainer": bool(np.array_equal(leaves, routed)),
           "early_stop_freq": EARLY_STOP_FREQ, "early_stop_margin": margin,
           "early_stop_s": es_s, "early_stopped_rows": int((~active).sum()),
           "active_rows_equal_full": bool(np.array_equal(es[active],
                                                         full[active])),
           "dump_model_trees": len(dump["tree_info"]),
           "num_trees": bst.num_trees(),
           "importance_split": imp_split.astype(int).tolist(),
           "importance_gain": [round(float(v), 3) for v in imp_gain],
           "refit_rows": API_ROWS, "refit_s": refit_s,
           "refit_auc": refit_auc,
           "auc_before_refit": auc(walk_predict(bst, Xr, raw_score=True),
                                   yr),
           "cache_mb": file_mb, "save_binary_s": save_s,
           "load_binary_s": load_s, "bins_on_host_until_train": on_host,
           "cache_bins_equal": bins_equal,
           "cache_model_text_equal": got == want}
    emit(res)
    if not (res["pred_leaf_equals_trainer"]
            and routed.shape == leaves.shape == (API_ROWS, ROUNDS)):
        raise AssertionError("12d: pred_leaf differs from the trainer's "
                             "leaves")
    if not (res["early_stopped_rows"] > 0 and res["active_rows_equal_full"]):
        raise AssertionError(f"12d: early stop {res}")
    if res["dump_model_trees"] != res["num_trees"] \
            or int(imp_split.sum()) != n_splits \
            or not np.isfinite(imp_gain).all():
        raise AssertionError(f"12d: dump/importance {res}")
    if not refit_auc > 0.75:
        raise AssertionError(f"12d: refit AUC {refit_auc}")
    if not (on_host and bins_equal and res["cache_model_text_equal"]):
        raise AssertionError(f"12d: binary cache round trip {res}")
    del dsm
    return out, checks


def _fit_rows_equal(got, want, rtol, atol) -> float:
    """The largest difference of two per-leaf linear fits (None, or
    (columns, coefficients, intercept) per leaf); raises where a leaf
    fits in one and not the other, or on other columns."""
    worst = 0.0
    for leaf, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None):
            raise AssertionError(f"13c: leaf {leaf} fits in one form only")
        if a is None:
            continue
        if a[0] != b[0]:
            raise AssertionError(f"13c: leaf {leaf} columns {a[0]}/{b[0]}")
        va, vb = np.asarray(a[1] + [a[2]]), np.asarray(b[1] + [b[2]])
        if not np.allclose(va, vb, rtol=rtol, atol=atol):
            raise AssertionError(f"13c: leaf {leaf} coefficients {va} / "
                                 f"{vb}")
        worst = max(worst, float(np.abs(va - vb).max()))
    return worst


def _numerical_paths(tree):
    """Per leaf of a HostTree, the sorted real columns of the numerical
    splits on its root path."""
    paths = [[] for _ in range(tree.num_leaves)]
    stack = [(0, set())]
    while stack:
        node, cols = stack.pop()
        if not int(tree.decision_type[node]) & 1:
            cols = cols | {int(tree.split_feature[node])}
        for child in (int(tree.left_child[node]),
                      int(tree.right_child[node])):
            if child < 0:
                paths[~child] = sorted(cols)
            else:
                stack.append((child, cols))
    return paths


def run_slice_train(lgb, params, ds, X, y, z, w, e2e):
    """Phase 13: DART, RF, linear-tree leaves and TreeSHAP on phase 3's
    rows at the slice's width, each through train(). (a) DART at
    LightGBM's defaults (drop_rate 0.1, skip_drop 0.5, max_drop 50),
    drop_seed 4, DART_ROUNDS rounds with phase 7's valid set: the drops
    per iteration, the training scores against predict on CHECK_ROWS rows
    and the valid scores against predict on the valid rows (rtol/atol
    1e-5: ``_normalize``'s bookkeeping), training AUC > 0.75, and the
    CAPTURE_LEVEL_CALL-th level_pass held to its plain version on its
    own operands (``check_captured``). (b) RF (bagging 0.632 every
    iteration, feature_fraction 0.8), RF_ROUNDS rounds with the valid set:
    predict equals the summed training and valid scores over RF_ROUNDS
    (1e-5), the model text says ``average_output``, and eval_valid reports
    the AUC of the averaged f32 valid scores and of predict's float64
    (1e-6 each; the two differ where f32 sums tie rows that float64
    parts) and the logloss its metric gives predict's scores (rtol 1e-5).
    (c) ``linear_tree`` regression on the latent z, LINEAR_ROUNDS rounds,
    the raw columns on the card: predict equals the trainer's scores on
    CHECK_ROWS rows (1e-5); the CAPTURE_FIT_CALL-th fit took its tree's
    numerical path columns (walked here), the fits the tree kept
    (unshrunk) and the device form redone on the call's operands equal
    the plain form there (rtol 1e-6), and the device form gives the same
    bits twice and the bits the tree kept; the fit's time per tree, and
    the L2 loss against the same rounds with constant leaves. (d)
    ``pred_contrib`` on (a)'s model: the device form on SHAP_ROWS rows
    adds up to the float64 walk (1e-6) and equals the plain form on
    SHAP_PLAIN_ROWS rows (1e-9), pattern keys over several words there
    (1e-12) and a second call (the same bits). Returns (each run's wrapper
    launches, (a)'s kernel check)."""
    import torch
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.io import shap
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import linear
    metric = ["binary_logloss", "auc"]
    Xv, yv = _valid_rows(VALID_ROWS, w, seed=DATA_SEED + 100)
    dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
    Xc = X[:CHECK_ROWS]
    out, boosters = {}, {}

    def per_tree(counts, n):
        return {k: v / n for k, v in counts.items() if v}

    def scores_match(bst, n_iter, what):
        """(predict on CHECK_ROWS rows and on the valid rows, their worst
        gaps to the trainer's scores, averaged over n_iter)."""
        g = bst._gbdt
        pred = walk_predict(bst, Xc, raw_score=True)
        got = g.scores[0, :CHECK_ROWS].double().cpu().numpy() / n_iter
        err = float(np.abs(pred - got).max())
        if not np.allclose(pred, got, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: predict differs from the "
                                 f"trainer's scores by {err}")
        errs = {"predict_max_abs_err": err}
        if g.valid_scores:
            pv = walk_predict(bst, Xv, raw_score=True)
            gv = g.valid_scores[0][0].double().cpu().numpy() / n_iter
            errs["valid_predict_max_abs_err"] = float(np.abs(pv - gv).max())
            if not np.allclose(pv, gv, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{what}: predict differs from the "
                                     f"valid scores by {errs}")
            errs["valid_pred"] = pv
        return errs

    # (a) DART
    pa = dict(params, boosting="dart", drop_seed=DART_DROP_SEED,
              metric=metric)
    drops = []

    def rec_drops(env):
        drops.append(list(env.model._gbdt.drop_index))

    def fit_a(rounds):
        ds.params = {}
        return lgb.train(pa, ds, rounds, valid_sets=[dv],
                         valid_names=["valid"], callbacks=[rec_drops])
    _, t_one = _timed_run(lambda: fit_a(1))
    drops.clear()
    counts = _run_counts()
    (bst, t_all), store = captured(lambda: fit_a(DART_ROUNDS), [
        (frontier2, "level_pass", CAPTURE_LEVEL_CALL)])
    launches, cuda, syncs = counts()
    n_trees = bst.num_trees()
    errs = scores_match(bst, 1, "13a")
    errs.pop("valid_pred")
    train_auc = auc(bst.train_scores().float().cpu().numpy(), y)
    res = {"phase": "slice_train", "run": "a", "boosting": "dart",
           "rounds": DART_ROUNDS, "trees": n_trees,
           "drop_rate": 0.1, "skip_drop": 0.5, "max_drop": 50,
           "drop_seed": DART_DROP_SEED,
           "drops_per_iter": [len(d) for d in drops],
           "dropped": drops, "body": bst._gbdt._fast_path_reason(),
           "sec_per_iter_after_first": (t_all - t_one) / (DART_ROUNDS - 1),
           "train_s": t_all,
           "phase3_sec_per_iter_after_first":
           e2e["sec_per_iter_after_first"],
           "launches_per_tree": per_tree(launches, n_trees),
           "cuda_launches_per_tree": per_tree(cuda, n_trees),
           "host_syncs_per_tree": syncs / n_trees, "train_auc": train_auc,
           "auc_floor": 0.75, **errs, "predict_tol": "rtol=1e-5 atol=1e-5",
           "leaves": [m.num_leaves for m in bst.models]}
    emit(res)
    if n_trees != DART_ROUNDS:
        raise AssertionError(f"13a: {n_trees} trees")
    if len(drops) != DART_ROUNDS or not any(drops):
        raise AssertionError(f"13a: no iteration dropped a tree: {drops}")
    if not train_auc > 0.75:
        raise AssertionError(f"13a: training AUC {train_auc}")
    for name in TRAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"13a: {name} never launched")
    check_stages(launches, cuda, "13a")
    out["a"] = launches
    boosters["a"] = bst
    check = check_captured(store, "a", "slice_train", 13)
    del store

    # (b) RF
    pb = dict(params, boosting="rf", bagging_fraction=0.632, bagging_freq=1,
              feature_fraction=0.8, metric=metric)

    def fit_b(rounds):
        ds.params = {}
        return lgb.train(pb, ds, rounds, valid_sets=[dv],
                         valid_names=["valid"])
    _, t_one = _timed_run(lambda: fit_b(1))
    counts = _run_counts()
    bst, t_all = _timed_run(lambda: fit_b(RF_ROUNDS))
    launches, cuda, syncs = counts()
    n_trees = bst.num_trees()
    errs = scores_match(bst, RF_ROUNDS, "13b")
    pv = errs.pop("valid_pred")
    reported = dict((m, v) for _, m, v, _ in bst.eval_valid())
    # the scores the metrics see: the f32 sums over the iterations
    seen = (bst._gbdt.valid_scores[0][0].cpu().numpy()
            / np.float32(RF_ROUNDS)).astype(np.float64)
    auc_seen = auc_ties(seen, yv)
    # the same metric (its device form, f32) on predict's averaged scores
    g = bst._gbdt
    loss_pred = float(g.eval_metric_set("valid", g.valid_metrics[0][:1],
                                        torch.as_tensor(
                                            pv[None, :].astype(np.float32),
                                            device=DEVICE))[0][2])
    auc_pred = auc_ties(pv, yv)
    text_has = "\naverage_output\n" in bst.model_to_string()
    res = {"phase": "slice_train", "run": "b", "boosting": "rf",
           "rounds": RF_ROUNDS, "trees": n_trees, "bagging_fraction": 0.632,
           "feature_fraction": 0.8, "body": bst._gbdt._fast_path_reason(),
           "sec_per_iter_after_first": (t_all - t_one) / (RF_ROUNDS - 1),
           "train_s": t_all,
           "launches_per_tree": per_tree(launches, n_trees),
           "cuda_launches_per_tree": per_tree(cuda, n_trees),
           "host_syncs_per_tree": syncs / n_trees, **errs,
           "valid_auc_reported": reported["auc"],
           "valid_auc_of_averaged_scores": auc_seen, "auc_tol": 1e-6,
           "valid_auc_from_predict": auc_pred,
           "valid_logloss_reported": reported["binary_logloss"],
           "valid_logloss_of_predict": loss_pred,
           "valid_logloss_float64_of_predict": logloss(pv, yv),
           "logloss_tol": "rtol=1e-5",
           "model_text_average_output": text_has,
           "leaves": [m.num_leaves for m in bst.models]}
    emit(res)
    if n_trees != RF_ROUNDS or not text_has:
        raise AssertionError(f"13b: {res}")
    # the AUC on the averaged f32 scores; the logloss (which, unlike the
    # AUC, an unaveraged sum would change) against the same metric on
    # predict's averaged scores
    if abs(reported["auc"] - auc_seen) > 1e-6 \
            or abs(reported["auc"] - auc_pred) > 1e-6 or not np.isclose(
            reported["binary_logloss"], loss_pred, rtol=1e-5, atol=0):
        raise AssertionError(f"13b: eval_valid {reported} vs AUC "
                             f"{auc_seen} of the averaged scores, AUC "
                             f"{auc_pred} and logloss {loss_pred} from "
                             f"predict")
    check_stages(launches, cuda, "13b")
    out["b"] = launches
    del bst

    # (c) linear-tree leaves on the latent z, and constant leaves beside
    pc = dict(params, objective="regression", linear_tree=True,
              linear_lambda=0.1, metric=["l2"])
    dl, construct_s = _timed_run(lambda: lgb.Dataset(
        X, label=z, params=dict(pc)).construct())

    def fit_c(p, rounds):
        dl.params = {}
        return lgb.train(p, dl, rounds)
    _, t_one = _timed_run(lambda: fit_c(pc, 1))
    counts = _run_counts()
    (bst, t_all), store = captured(lambda: fit_c(pc, LINEAR_ROUNDS), [
        (gbdt_mod, "fit_linear_leaves", CAPTURE_FIT_CALL)])
    launches, cuda, syncs = counts()
    n_trees = bst.num_trees()
    errs = scores_match(bst, 1, "13c")
    args, _ = store.pop("fit_linear_leaves")
    # the tree that call fitted (the first tree fits nothing), its paths
    # walked here, and the fits it kept, unshrunk
    tree = bst.models[CAPTURE_FIT_CALL + 1]
    if args[5] != _numerical_paths(tree):
        raise AssertionError("13c: the fit took other columns than the "
                             "tree's numerical path columns")
    rate = bst._gbdt.shrinkage_rate
    kept = [(f, [c / rate for c in cs], lc / rate) if f else None
            for f, cs, lc in zip(tree.leaf_features, tree.leaf_coeff,
                                 tree.leaf_const)]
    dev_fit = linear.fit_linear_leaves(*args)
    repeat_equal = linear.fit_linear_leaves(*args) == dev_fit
    # the same sums in the same order: the bits the trainer kept
    kept_equal = all(
        (f is None) == (not cs) and (f is None or (
            [c * rate for c in f[1]] == cs and f[2] * rate == lc))
        for f, cs, lc in zip(dev_fit, tree.leaf_coeff, tree.leaf_const))
    host = [a.cpu().numpy() if hasattr(a, "cpu") else a for a in args]
    plain_fit, plain_s = _timed_run(
        lambda: linear.fit_linear_leaves_plain(*host))
    fit_err = _fit_rows_equal(dev_fit, plain_fit, 1e-6, 1e-9)
    kept_err = _fit_rows_equal(kept, plain_fit, 1e-6, 1e-9)
    fit_ms = call_ms(lambda: linear.fit_linear_leaves(*args), reps=5,
                     warmup=1)
    del store, args
    l2 = float(np.mean((bst.train_scores().double().cpu().numpy() - z)
                       ** 2))
    const = fit_c(dict(pc, linear_tree=False), LINEAR_ROUNDS)
    l2_const = float(np.mean(
        (const.train_scores().double().cpu().numpy() - z) ** 2))
    res = {"phase": "slice_train", "run": "c", "objective": "regression",
           "linear_tree": True, "linear_lambda": 0.1,
           "rounds": LINEAR_ROUNDS, "trees": n_trees,
           "construct_s": construct_s,
           "raw_data_on": str(dl._inner.raw_data.device),
           "body": bst._gbdt._fast_path_reason(),
           "sec_per_iter_after_first": (t_all - t_one)
           / (LINEAR_ROUNDS - 1), "train_s": t_all,
           "launches_per_tree": per_tree(launches, n_trees),
           "cuda_launches_per_tree": per_tree(cuda, n_trees),
           "host_syncs_per_tree": syncs / n_trees, **errs,
           "fit_call": CAPTURE_FIT_CALL,
           "fit_leaves": sum(f is not None for f in dev_fit),
           "fit_columns_max": max((len(f[0]) for f in dev_fit if f),
                                  default=0),
           "fit_ms_per_tree": fit_ms, "plain_fit_ms": plain_s * 1e3,
           "fit_max_abs_diff_to_plain": fit_err, "fit_tol": "rtol=1e-6",
           "kept_fit_max_abs_diff_to_plain": kept_err,
           "fit_repeat_bit_equal": repeat_equal,
           "kept_fit_bit_equal_to_refit": kept_equal,
           "train_l2": l2, "train_l2_constant_leaves": l2_const,
           "linear_leaves": sum(len(f) > 0 for m in bst.models
                                for f in m.leaf_features)}
    emit(res)
    if n_trees != LINEAR_ROUNDS or res["fit_leaves"] == 0 \
            or not (repeat_equal and kept_equal):
        raise AssertionError(f"13c: {res}")
    if not (res["raw_data_on"].startswith(DEVICE) and l2 < l2_const):
        raise AssertionError(f"13c: {res}")
    for name in ("level_pass", "route_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"13c: {name} never launched")
    check_stages(launches, cuda, "13c")
    out["c"] = launches
    del bst, const, dl

    # (d) TreeSHAP on (a)'s model
    bst = boosters.pop("a")
    Xs = X[:SHAP_ROWS]
    contrib, shap_s = _timed_run(lambda: bst.predict(Xs, pred_contrib=True))
    # the float64 walk SHAP adds up to (at 100,000 rows x 20 trees predict
    # takes the float32 device predictor)
    from lightgbm_tpu_torch.basic import host_walk_raw
    raw = host_walk_raw(bst.models, Xs, 0, bst.num_trees(), 1, DEVICE)[0]
    add_err = float(np.abs(contrib.sum(1) - raw).max())
    Xp = X[:SHAP_PLAIN_ROWS].astype(np.float64)
    plain, plain_s = _timed_run(lambda: shap.predict_contrib_plain(
        bst.models, Xp, 1, X.shape[1]))
    plain_err = float(np.abs(contrib[:SHAP_PLAIN_ROWS] - plain).max())
    # the pattern keys over several int64 words (4 path elements a word),
    # and a second call's bits
    bits = shap._BITS
    shap._BITS = 4
    try:
        words = bst.predict(Xp, pred_contrib=True)
    finally:
        shap._BITS = bits
    words_err = float(np.abs(words - contrib[:SHAP_PLAIN_ROWS]).max())
    again = bst.predict(Xp, pred_contrib=True)
    repeat_equal = np.array_equal(bst.predict(Xp, pred_contrib=True), again)
    res = {"phase": "slice_train", "run": "d", "pred_contrib_rows":
           SHAP_ROWS, "shape": list(contrib.shape), "trees": bst.num_trees(),
           "device_s": shap_s, "device_s_per_100k_rows":
           shap_s * 100_000 / SHAP_ROWS,
           "additivity_max_abs_err": add_err, "additivity_tol": 1e-6,
           "plain_rows": SHAP_PLAIN_ROWS, "plain_s": plain_s,
           "plain_max_abs_err": plain_err, "plain_tol": 1e-9,
           "several_words_max_abs_err": words_err, "several_words_tol":
           1e-12, "repeat_bit_equal": repeat_equal}
    emit(res)
    if contrib.shape != (SHAP_ROWS, X.shape[1] + 1) \
            or not np.allclose(contrib.sum(1), raw, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"13d: {res}")
    if not np.allclose(contrib[:SHAP_PLAIN_ROWS], plain, rtol=1e-9,
                       atol=1e-9):
        raise AssertionError(f"13d: the device form differs from the plain "
                             f"one by {plain_err}")
    if not (words_err <= 1e-12 and repeat_equal):
        raise AssertionError(f"13d: {res}")
    return out, check


def forced_splits_json(w: np.ndarray, mono: np.ndarray) -> dict:
    """Phase 14c's forced splits: three levels (seven nodes) at 0.5 on the
    three columns of least |w| (little signal) that carry no constraint,
    one column per level."""
    a, b, c = [int(f) for f in np.argsort(np.abs(w)) if mono[f] == 0][:3]

    def node(f, child=None):
        out = {"feature": f, "threshold": 0.5}
        if child is not None:
            out.update(left=child(), right=child())
        return out
    return node(a, lambda: node(b, lambda: node(c)))


def cegb_columns(w: np.ndarray):
    """Phase 14b's penalised columns: coupled costs on the four of largest
    |w|, lazy costs on the next four."""
    order = [int(f) for f in np.argsort(-np.abs(w))]
    return order[:4], order[4:8]


def _split_uses(bst, cols) -> int:
    """How many of the model's splits are on ``cols``."""
    return int(sum(np.isin(m.split_feature[:m.num_internal], cols).sum()
                   for m in bst.models))


def _trees_text(text: str) -> str:
    """The model text's tree blocks (the parameters after them differ)."""
    return text[text.index("Tree=0"):text.index("end of trees")]


def run_xla_train(lgb, params, ds, X, y, w, e2e):
    """Phase 14: the XLA engine (leaf-wise and depth-wise growers; the
    depth-wise levels and the leaf-wise roots through hist_pass's unrounded
    f32 variant, each leaf-wise step through leaf_partition and leaf_hist
    on the rows listed per leaf) on phase 3's rows. (a)
    ``tpu_engine="xla"`` (leaf-wise) through train(), ROUNDS rounds:
    sec/iter, training AUC (> 0.75), predict against the trainer's
    scores, hist_pass calls per tree (the root: 1), leaf_partition and
    leaf_hist calls per tree (one per step: L - 1), CUDA launches per
    iteration, host syncs per tree; its CAPTURE_XLA_CALL-th step's
    leaf_partition and leaf_hist operands (``list_partition_check``,
    ``list_hist_check``) and its CAPTURE_XLA_ROOT-th hist_pass call (a
    root, S = 1) held to their plain versions; then 2 rounds of
    ``tpu_engine="fused",
    grow_policy="leafwise"`` give the same trees as (a)'s first two. (b)
    ``grow_policy="depthwise"`` with CEGB (a split penalty, coupled costs on
    four columns, lazy costs on four others): AUC, the penalised columns'
    splits against (a)'s, the level passes per tree, and its
    CAPTURE_DEPTH_CALL-th hist_pass call (a level, S = L) checked. (c)
    leaf-wise with forced splits (three levels on three low-signal
    columns) and ``monotone_constraints_method="advanced"`` on phase 12's
    constrained columns: every tree's first nodes are the JSON's, the mode
    stays advanced, the worst step along each constrained column >= -1e-6.
    (d) phase 11a's CSR draw cut to XLA_CSR_ROWS rows (bundle columns on
    the leaf-wise grower), XLA_CSR_ROUNDS rounds, predict on the CSR rows
    against the trainer's scores, and its CAPTURE_CSR_CALL-th step's list
    kernels checked as (a)'s are, on the bundle columns' operands. Returns (each run's wrapper launches,
    the captured checks of (a) and (b), with the list kernels of (a) and
    (d) under "<run>_leaf_partition" and "<run>_leaf_hist"); each run's
    launches carry its CUDA kernel launches under "cuda"."""
    import json as json_mod
    import os
    import tempfile
    from lightgbm_tpu_torch.models import learner as lmod
    from lightgbm_tpu_torch.ops import histogram as hmod
    out, checks = {}, {}

    def fit(p, rounds, data=ds):
        data.params = {}
        return lgb.train(p, data, rounds)

    def common(run, bst, t_all, t_one, launches, cuda, syncs, rounds,
               data_y):
        n_trees = bst.num_trees()
        scores = bst.train_scores().float().cpu().numpy()
        g = bst._gbdt
        return {"phase": "xla_train", "run": run,
                "engine": {"use_fused": g.use_fused,
                           "use_frontier": g.use_frontier,
                           "grow_policy": g.grow_policy,
                           "fast_path_reason": g._fast_path_reason()},
                "rounds": rounds, "trees": n_trees,
                "sec_per_iter_after_first": (t_all - t_one) / (rounds - 1),
                "train_s": t_all, "train_auc": auc(scores, data_y),
                "hist_pass_calls_per_tree": launches["hist_pass"] / n_trees,
                "leaf_partition_calls_per_tree":
                launches["leaf_partition"] / n_trees,
                "leaf_hist_calls_per_tree": launches["leaf_hist"] / n_trees,
                "launches_per_tree": {k: v / n_trees
                                      for k, v in launches.items() if v},
                "cuda_launches_per_iter": {k: v / rounds
                                           for k, v in cuda.items() if v},
                "host_syncs_per_tree": syncs / n_trees,
                "phase3_sec_per_iter_after_first":
                e2e["sec_per_iter_after_first"],
                "leaves": [m.num_leaves for m in bst.models]}, scores

    def gate(res, launches, cuda, name, want_trees):
        if res["trees"] != want_trees:
            raise AssertionError(f"{name}: {res['trees']} trees")
        if res["engine"]["use_fused"] or res["engine"]["use_frontier"]:
            raise AssertionError(f"{name}: not the XLA engine: {res}")
        if launches["hist_pass"] <= 0 or launches["level_pass"]:
            raise AssertionError(f"{name}: launches {launches}")
        # the leaf-wise grower: one leaf_partition and one leaf_hist call
        # per step, L - 1 steps a tree; the depth-wise grower neither
        steps = (want_trees * (params["num_leaves"] - 1)
                 if res["engine"]["grow_policy"] == "leafwise" else 0)
        if not launches["leaf_partition"] == launches["leaf_hist"] == steps:
            raise AssertionError(f"{name}: {launches['leaf_partition']} "
                                 f"leaf_partition and "
                                 f"{launches['leaf_hist']} leaf_hist calls, "
                                 f"want {steps} each")
        check_stages(launches, cuda, name)

    def list_checks(store, run, step):
        # the run's captured leaf-wise step: both list kernels against
        # their plain versions on its own operands (each check raises)
        for check, name in ((list_partition_check, "leaf_partition"),
                            (list_hist_check, "leaf_hist")):
            key = f"{run}_{name}"
            checks[key] = dict(check(store.pop(name), f"14{run}"),
                               step=step)
            emit({"phase": "xla_train", "run": run, "kernel_check": {
                "kernel": name, "operands": f"step {step} of 14{run}'s "
                f"first tree", **checks[key]}})

    def captured_check(store, run, S):
        args, kw = store.pop("hist_pass")
        bins, gh, slot = args
        res = hist_operand_check(bins, gh, slot, kw["S"], kw["Bp"],
                                 unrounded=True)
        res["slotted_rows"] = int((slot >= 0).sum())
        if kw["S"] != S:
            raise AssertionError(f"14{run}: captured S={kw['S']}, want {S}")
        emit({"phase": "xla_train", "run": run, "kernel_check": res})
        return res

    # (a) the leaf-wise grower
    pa = dict(params, tpu_engine="xla")
    _, t_one = _timed_run(lambda: fit(pa, 1))
    counts = _run_counts()
    (bst_a, t_all), store = captured(lambda: fit(pa, ROUNDS), [
        (hmod, "hist_pass", CAPTURE_XLA_ROOT),
        (lmod, "leaf_partition", CAPTURE_XLA_CALL - 1),
        (lmod, "leaf_hist", CAPTURE_XLA_CALL - 1)])
    launches, cuda, syncs = counts()
    res, scores = common("a", bst_a, t_all, t_one, launches, cuda, syncs,
                         ROUNDS, y)
    pred = walk_predict(bst_a, X[:CHECK_ROWS], raw_score=True)
    res["predict_max_abs_err"] = float(np.abs(pred
                                              - scores[:CHECK_ROWS]).max())
    res["predict_tol"] = "rtol=1e-5 atol=1e-5"
    text_a = bst_a.model_to_string(num_iteration=FUSED_LEAFWISE_ROUNDS)
    (bst_f, t_f) = _timed_run(lambda: fit(dict(
        params, tpu_engine="fused", grow_policy="leafwise"),
        FUSED_LEAFWISE_ROUNDS))
    res["fused_leafwise"] = {
        "rounds": FUSED_LEAFWISE_ROUNDS, "train_s": t_f,
        "grow_policy": bst_f._gbdt.grow_policy,
        "use_fused": bst_f._gbdt.use_fused,
        "same_trees_as_xla": _trees_text(bst_f.model_to_string())
        == _trees_text(text_a)}
    emit(res)
    gate(res, launches, cuda, "14a", ROUNDS)
    if not res["train_auc"] > 0.75:
        raise AssertionError(f"14a: training AUC {res['train_auc']}")
    # one hist_pass call per tree (its root): the steps' histograms are
    # leaf_hist's (gate)
    if res["engine"]["grow_policy"] != "leafwise" \
            or launches["hist_pass"] != ROUNDS:
        raise AssertionError(f"14a: {res['engine']}, "
                             f"{launches['hist_pass']} hist_pass calls")
    if not np.allclose(pred, scores[:CHECK_ROWS], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"14a: predict differs from the trainer's "
                             f"scores by {res['predict_max_abs_err']}")
    if not res["fused_leafwise"]["same_trees_as_xla"] \
            or res["fused_leafwise"]["use_fused"]:
        raise AssertionError(f"14a: fused + leafwise: "
                             f"{res['fused_leafwise']}")
    out["a"] = dict(launches, cuda=cuda)
    list_checks(store, "a", CAPTURE_XLA_CALL)
    checks["a"] = captured_check(store, "a", 1)

    # (b) the depth-wise grower with CEGB
    coupled, lazy = cegb_columns(w)
    F = X.shape[1]
    pen_c = [CEGB_COUPLED if f in coupled else 0.0 for f in range(F)]
    pen_l = [CEGB_LAZY if f in lazy else 0.0 for f in range(F)]
    pb = dict(params, tpu_engine="xla", grow_policy="depthwise",
              cegb_penalty_split=CEGB_SPLIT,
              cegb_penalty_feature_coupled=pen_c,
              cegb_penalty_feature_lazy=pen_l)
    _, t_one = _timed_run(lambda: fit(pb, 1))
    counts = _run_counts()
    (bst_b, t_all), store = captured(lambda: fit(pb, ROUNDS), [
        (hmod, "hist_pass", CAPTURE_DEPTH_CALL)])
    launches, cuda, syncs = counts()
    res, _ = common("b", bst_b, t_all, t_one, launches, cuda, syncs, ROUNDS,
                    y)
    g = bst_b._gbdt
    res.update({"cegb_penalty_split": CEGB_SPLIT,
                "coupled_columns": coupled, "coupled_penalty": CEGB_COUPLED,
                "lazy_columns": lazy, "lazy_penalty": CEGB_LAZY,
                "use_cegb": g.use_cegb, "use_cegb_lazy": g.use_cegb_lazy,
                "level_passes_per_tree":
                res["hist_pass_calls_per_tree"] - 1,
                "coupled_splits": _split_uses(bst_b, coupled),
                "lazy_splits": _split_uses(bst_b, lazy),
                "phase14a_coupled_splits": _split_uses(bst_a, coupled),
                "phase14a_lazy_splits": _split_uses(bst_a, lazy),
                "cegb_used": [int(f) for f in
                              np.nonzero(g.cegb_used.cpu().numpy())[0]],
                "cegb_used_rf_share": float(g.cegb_used_rf.float().mean())})
    emit(res)
    gate(res, launches, cuda, "14b", ROUNDS)
    if not (g.use_cegb and g.use_cegb_lazy
            and res["engine"]["grow_policy"] == "depthwise"):
        raise AssertionError(f"14b: {res['engine']}, CEGB {g.use_cegb}")
    if not np.isfinite(res["train_auc"]) or res["train_auc"] <= 0.5:
        raise AssertionError(f"14b: training AUC {res['train_auc']}")
    out["b"] = dict(launches, cuda=cuda)
    checks["b"] = captured_check(store, "b", params["num_leaves"])

    # (c) leaf-wise with forced splits and the advanced monotone mode, on
    # phase 3's rows binned again with phase 12's constraints
    mono = mono_constraints(w)
    spec = forced_splits_json(w, mono)
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as fh:
        json_mod.dump(spec, fh)
    try:
        dsm, construct_s = _timed_run(lambda: lgb.Dataset(
            X, label=y, params=dict(params,
                                    monotone_constraints=mono.tolist()))
            .construct())
        pc = dict(params, tpu_engine="xla", forcedsplits_filename=path,
                  monotone_constraints_method="advanced")
        _, t_one = _timed_run(lambda: fit(pc, 1, dsm))
        counts = _run_counts()
        bst_c, t_all = _timed_run(lambda: fit(pc, ROUNDS, dsm))
        launches, cuda, syncs = counts()
    finally:
        os.unlink(path)
    res, _ = common("c", bst_c, t_all, t_one, launches, cuda, syncs, ROUNDS,
                    y)
    g = bst_c._gbdt
    want_f = g.forced_feat.tolist()
    want_t = g.forced_thr.tolist()
    n = len(want_f)
    forced_ok = all(
        [int(g.train_data.used_features.index(int(f)))
         for f in m.split_feature[:n]] == want_f
        and [int(t) for t in m.threshold_bin[:n]] == want_t
        for m in bst_c.models)
    worst = mono_worst_steps(bst_c, X, mono, DATA_SEED + 1400)
    res.update({"construct_s": construct_s, "forced_splits": spec,
                "n_forced": n, "forced_features": want_f,
                "forced_bins": want_t, "forced_nodes_as_json": forced_ok,
                "mono_mode": g.mono_mode, "constraints": mono.tolist(),
                "worst_step_by_column": worst,
                "worst_step": min(worst.values()),
                "worst_step_floor": -1e-6})
    emit(res)
    gate(res, launches, cuda, "14c", ROUNDS)
    if not (forced_ok and n == 7 and g.mono_mode == "advanced"
            and res["worst_step"] >= -1e-6):
        raise AssertionError(f"14c: forced {forced_ok} ({n}), mode "
                             f"{g.mono_mode}, worst {res['worst_step']}")
    out["c"] = dict(launches, cuda=cuda)

    # (d) phase 11a's CSR draw, cut: bundle columns on the leaf-wise grower
    (Xs, ys), _ = _timed_run(lambda: _sparse_rows(XLA_CSR_ROWS,
                                                 DATA_SEED + 500))
    dss = lgb.Dataset(Xs, label=ys, params=params).construct()
    pd_ = dict(params, tpu_engine="xla")
    _, t_one = _timed_run(lambda: fit(pd_, 1, dss))
    counts = _run_counts()
    (bst_d, t_all), store = captured(lambda: fit(pd_, XLA_CSR_ROUNDS, dss), [
        (lmod, "leaf_partition", CAPTURE_CSR_CALL - 1),
        (lmod, "leaf_hist", CAPTURE_CSR_CALL - 1)])
    launches, cuda, syncs = counts()
    res, scores = common("d", bst_d, t_all, t_one, launches, cuda, syncs,
                         XLA_CSR_ROUNDS, ys)
    raw = walk_predict(bst_d, Xs, raw_score=True)
    g = bst_d._gbdt
    res.update({"input": "csr", "rows": XLA_CSR_ROWS,
                "columns": Xs.shape[1], "use_bundles": bool(g.use_bundles),
                "bundle_columns": int(g.xla_bins.shape[1]),
                "Bc": int(g.bundle_col_bins),
                "hist_bins": list(g.xla_hist_bins.shape),
                "logical_features": int(g.train_data.num_features),
                "predict_max_abs_err": float(np.abs(raw - scores).max()),
                "predict_tol": "rtol=1e-5 atol=1e-5"})
    emit(res)
    gate(res, launches, cuda, "14d", XLA_CSR_ROUNDS)
    if not (bst_d._gbdt.use_bundles
            and np.allclose(raw, scores, rtol=1e-5, atol=1e-5)):
        raise AssertionError(f"14d: bundles {bst_d._gbdt.use_bundles}, "
                             f"predict error {res['predict_max_abs_err']}")
    out["d"] = dict(launches, cuda=cuda)
    list_checks(store, "d", CAPTURE_CSR_CALL)
    return out, checks




def _tree_paths(lc, rc, num_leaves, N) -> np.ndarray:
    """[L, N] mask of the internal nodes a row passes on its way to each
    leaf of one tree (a one-leaf tree's rows read node 0 once)."""
    L = max(int(num_leaves), 1)
    on = np.zeros((L, N), bool)
    if L == 1:
        on[0, 0] = True
        return on
    todo = [(0, [0])]
    while todo:
        node, path = todo.pop()
        for c in (int(lc[node]), int(rc[node])):
            if c >= 0:
                todo.append((c, path + [c]))
            else:
                on[~c, path] = True
    return on


class _PassUse:
    """What one predict_pass run's rows need of a stack [T, N] / [T, L]:
    the node visits, and the internal nodes and leaves that some row
    reaches. The bound counts only those nodes' and leaves' bytes."""

    def __init__(self, ops, variant):
        from lightgbm_tpu_torch.ops.predict import FIELDS
        o = dict(zip(FIELDS[variant], ops))
        T, N = o["lc"].shape
        self.visits = 0
        self.nodes = np.zeros((T, N), bool)
        self.leaves = np.zeros((T, o["lv"].shape[1]), bool)
        self._paths = {}

    def add(self, t, lc, rc, num_leaves, leaves):
        """Rows reaching ``leaves`` [R] in tree ``t`` (of the stack)."""
        if t not in self._paths:
            self._paths[t] = _tree_paths(lc, rc, num_leaves,
                                         self.nodes.shape[1])
        paths = self._paths[t]
        self.visits += int(paths.sum(1)[leaves].sum())
        hit = np.unique(leaves)
        self.leaves[t, hit] = True
        self.nodes[t] |= paths[hit].any(0)

    def add_models(self, models, leaves):
        """Rows' ``leaves`` [R, T] in HostTrees ``models``."""
        for t, m in enumerate(models):
            self.add(t, m.left_child, m.right_child, m.num_leaves,
                     leaves[:, t])


def _pass_bound(enc, ops, tids, k, variant, use):
    """The least time of one predict_pass: the bytes it must move (its
    rows and output once, the per-feature arrays and tids whole, and of
    the stacks only what some row reaches: the per-node fields of the
    visited nodes, the leaf values of the reached leaves, the category
    mask rows of the visited categorical nodes) over the memory rate,
    against one compare per node visit and one add per row and tree
    (this run's data) over the f32 rate."""
    from lightgbm_tpu_torch.ops.predict import FIELDS
    R = enc.shape[0]
    o = dict(zip(FIELDS[variant], ops))
    nbytes = enc.numel() * enc.element_size() + k * R * 4 \
        + tids.numel() * 4
    for name, a in o.items():
        if a is None:
            continue
        if name == "lv":
            nbytes += int(use.leaves.sum()) * a.element_size()
        elif name == "cm":
            cat = use.nodes & o["cf"].cpu().numpy()
            nbytes += int(cat.sum()) * a.shape[2] * a.element_size()
        elif a.dim() == 2:              # per-node fields [T, N]
            nbytes += int(use.nodes.sum()) * a.element_size()
        else:                           # per-feature arrays
            nbytes += a.numel() * a.element_size()
    return bound(nbytes, use.visits + R * tids.numel())


def _f32_sums(models, leaves, k) -> np.ndarray:
    """[k, R] float32 sums, in tree order, of each tree's leaf value (as
    float32) at the given leaves [R, T]: what predict_pass computes when
    its routing equals the leaves'."""
    vals = np.stack([np.asarray(t.leaf_value, np.float64).astype(
        np.float32)[leaves[:, i]] for i, t in enumerate(models)], 1)
    out = np.zeros((k, leaves.shape[0]), np.float32)
    for c in range(k):
        out[c] = np.add.accumulate(vals[:, c::k], axis=1,
                                   dtype=np.float32)[:, -1]
    return out


def _synthetic_stack(R, T, F, L, k, seed):
    """A random binned stack with categorical nodes and k classes (each
    row's bins in range, the missing bins hit often) for phase 15e."""
    import torch
    from lightgbm_tpu_torch.ops.predict import FIELDS
    rng = np.random.RandomState(seed)
    N = L - 1
    lc = np.full((T, N), -1, np.int32)
    rc = np.full((T, N), -1, np.int32)
    depth = 1
    for t in range(T):
        left, right, slot = [], [], {0: None}
        for i in range(N):              # split a random leaf
            leaf = int(rng.randint(0, i + 1))
            left.append(~leaf)
            right.append(~(i + 1))
            if slot[leaf] is not None:
                node, side = slot[leaf]
                (left if side == 0 else right)[node] = i
            slot[leaf], slot[i + 1] = (i, 0), (i, 1)
        lc[t], rc[t] = left, right
        d, frontier = 0, [0]
        while frontier:
            d += 1
            frontier = [c for nd in frontier for c in (left[nd], right[nd])
                        if c >= 0]
        depth = max(depth, d)
    num_bin = rng.randint(8, 64, F).astype(np.int32)
    sf = rng.randint(0, F, (T, N)).astype(np.int32)
    default_bin = (rng.randint(0, 10**6, F) % num_bin).astype(np.int32)
    arrays = {"sf": sf, "tb": (rng.randint(0, 10**6, (T, N))
                               % num_bin[sf]).astype(np.int32),
              "dl": rng.rand(T, N) < 0.5, "lc": lc, "rc": rc,
              "lv": rng.randn(T, L).astype(np.float32),
              "cf": rng.rand(T, N) < 0.2,
              "cm": rng.rand(T, N, int(num_bin.max())) < 0.5,
              "num_bin": num_bin,
              "missing": np.resize(np.array([0, 1, 2], np.int32), F),
              "default_bin": default_bin}
    enc = (rng.randint(0, 10**6, (R, F)) % num_bin).astype(np.int32)
    hit = rng.rand(R, F)
    enc = np.where(hit < 0.1, default_bin, enc)
    enc = np.where(hit > 0.9, num_bin - 1, enc).astype(np.int32)
    from lightgbm_tpu_torch.ops.predict import pack_records
    dev = DEVICE
    ops = tuple(torch.as_tensor(arrays[n]).to(dev)
                for n in FIELDS["binned"])
    ops = ops + pack_records(ops, "binned")
    tids = torch.as_tensor((np.arange(T) % k).astype(np.int32)).to(dev)
    steps = 1 << max(1, depth.bit_length())
    # what the rows need of the stack, for the bound: the port's per-tree
    # routing
    from lightgbm_tpu_torch.ops.predict import route_binned_rows_to_leaves
    enc_t = torch.as_tensor(enc).to(dev)
    o = dict(zip(FIELDS["binned"], ops))
    use = _PassUse(ops, "binned")
    for t in range(T):
        leaves = route_binned_rows_to_leaves(
            enc_t, o["sf"][t], o["tb"][t], o["dl"][t], o["lc"][t],
            o["rc"][t], o["num_bin"], o["missing"], o["default_bin"], steps,
            o["cf"][t], o["cm"][t])
        use.add(t, lc[t], rc[t], L, leaves.cpu().numpy())
    return enc_t, ops, tids, steps, use


def check_predict_pass(name, enc, ops, tids, k, steps, variant, use,
                       launches):
    """predict_pass against its plain version on one operand set: two
    calls give the same bits, equal to the plain version's; the device
    time per launch (a CUDA graph of 20 calls), the plain version's one
    call (it loops over trees and steps on the host), the bound."""
    import torch
    from lightgbm_tpu_torch.ops import predict as tp
    a = tp.predict_pass(enc, ops, tids, k, steps, variant)
    b = tp.predict_pass(enc, ops, tids, k, steps, variant)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = tp.predict_pass_plain(enc, ops, tids, k, steps, variant)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    same = bool(torch.equal(a, b))
    equal = bool(torch.equal(a, want))
    ms = cuda_ms(lambda: tp.predict_pass(enc, ops, tids, k, steps,
                                         variant))
    plan = tp.tiled_plan(int(enc.shape[0]), int(enc.shape[1]),
                         int(tids.numel()), int(ops[0].shape[1]),
                         int(ops[list(tp.FIELDS[variant]).index("lv")]
                             .shape[1]),
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    b_ms, b_by = _pass_bound(enc, ops, tids, k, variant, use)
    res = {"name": name, "variant": variant,
           "categorical": ops[list(tp.FIELDS[variant]).index("cf")]
           is not None, "rows": int(enc.shape[0]),
           "features": int(enc.shape[1]), "trees": int(tids.numel()),
           "k": k, "max_steps": steps, "node_visits": use.visits,
           "nodes_visited": int(use.nodes.sum()),
           "leaves_reached": int(use.leaves.sum()),
           "same_bits_twice": same, "equal_to_plain": equal,
           "max_abs_err": float((a - want).abs().max()) if a.numel()
           else 0.0, "kernel_ms": ms, "plan": plan,
           "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "launches": launches}
    emit({"phase": "kernel_check", "predict_pass": res})
    if not (same and equal):
        raise AssertionError(f"predict_pass {name}: twice the same bits "
                             f"{same}, equal to the plain version {equal}")
    return res


def _edge_rows(pred) -> np.ndarray:
    """Rows whose every column takes each edge value in turn: NaN, +-inf,
    +-0.0, the zero band, huge and out-of-int64 values, negative, unseen
    and non-integer categories, and every used column's finite bin upper
    bounds with their neighbours on either side."""
    F = pred.ds.num_total_features
    vals = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-36, -1e-36, 1e300,
            -1e300, 2.0 ** 63, -2.0 ** 63, -1.0, -0.5, 0.5, 2.5, 3.0,
            7.999, 1e9]
    for j in pred.ds.used_features:
        b = np.asarray(pred.ds.mappers[j].bin_upper_bound, np.float64)
        b = b[np.isfinite(b)]
        vals += list(b) + list(np.nextafter(b, np.inf)) \
            + list(np.nextafter(b, -np.inf))
    return np.tile(np.asarray(vals)[:, None], (1, F))


def device_bins_check(pred, X) -> dict:
    """A binned predictor's rows binned on the card against its host
    ``encode`` (``value_to_bin`` per column) on ``X`` and on the edge rows,
    bit for bit."""
    import torch
    from lightgbm_tpu_torch.binning import device_bin_tables, values_to_bins
    tables = pred.bin_tables or device_bin_tables(
        [pred.ds.mappers[j] for j in pred.ds.used_features], DEVICE)
    out = {}
    for name, rows in (("rows", X), ("edge_rows", _edge_rows(pred))):
        got = values_to_bins(torch.from_numpy(pred.used_values(rows))
                             .to(DEVICE), tables).cpu().numpy()
        out[name] = int(rows.shape[0])
        out[name + "_equal"] = bool(np.array_equal(got, pred.encode(rows)))
    return out


def request_breakdown(svc, walls, trace_ids, mids) -> dict:
    """Where a request's time goes, per model: medians over the requests
    of the parts that the engine's own dispatch recorded in each one's
    ``serve_access`` record (``reqtrace.DISPATCH_PARTS``: the host encode,
    the staging into the pinned buffer, the host's wait for the card, and
    the card's copy in, kernel and copy back between CUDA events), its
    dispatch, queue and batch times, and per request its hand-off: the
    caller's wall time less the dispatch (the queue, the batcher's worker
    thread and the wake-up)."""
    from lightgbm_tpu_torch.obs.reqtrace import DISPATCH_PARTS
    acc = {e["trace_id"]: e for e in svc.tel.snapshot()["events"]
           if e.get("event") == "serve_access"}
    missing = [t for t in trace_ids if t not in acc]
    if missing:
        raise AssertionError(f"request breakdown: {len(missing)} requests "
                             "without a serve_access record")
    out = {}
    for mid in sorted(set(mids)):
        rows = [(w, acc[t]) for w, t, m in zip(walls, trace_ids, mids)
                if m == mid]
        parts = {k: [e[k] for _, e in rows if k in e]
                 for k in DISPATCH_PARTS + ("dispatch_ms", "queue_ms",
                                            "batch_ms")}
        parts = {k: v for k, v in parts.items() if v}
        parts["request_ms"] = [w for w, _ in rows]
        parts["hand_off_ms"] = [w - e["dispatch_ms"] for w, e in rows]
        med = {k: float(np.median(v)) for k, v in parts.items()}
        med["requests"] = len(rows)
        out[mid] = med
    return out


def run_serve(lgb, params, ds, X, y, e2e):
    """Phase 15: serving on the card. (a) phase 3's configuration trained
    for SERVE_ROUNDS rounds, served as ``live`` (binned routing) and from
    its model text as ``file`` (raw routing) by one PredictionService;
    bench.py's closed-loop stream (200 requests of 1..1024 float32 rows
    from RandomState(7), the models in turns) then the same 200 submitted
    at once; (b) every response against the float64 walk; (c) a
    categorical model served through both variants; (d) Booster.predict
    on the 1M rows; (e) predict_pass against its plain version on the
    phase's operands. Returns the kernels-line rows."""
    import os
    import tempfile

    import torch
    from lightgbm_tpu_torch.basic import host_walk_raw
    from lightgbm_tpu_torch.binning import device_bin_tables, values_to_bins
    from lightgbm_tpu_torch.ops import predict as tp
    out_rows = []

    def fit(dset, rounds, extra=None):
        dset.params = {}
        return _timed_run(lambda: lgb.train(dict(params, **(extra or {})),
                                            dset, rounds))

    def counts():
        tp.reset_launch_counts()
        return lambda: dict(tp.variant_launches)

    # ---- (a) the model, the service, the closed and open loops
    bst, train_s = fit(ds, SERVE_ROUNDS)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "serve_model.txt")
    bst.save_model(path)
    svc = lgb.serve.PredictionService(
        {"live": bst, "file": path}, max_batch_rows=SERVE_MAX_BATCH,
        max_delay_ms=1.0, min_bucket_rows=SERVE_MIN_BUCKET,
        batch_events=False, serve_devices=1, device_type=DEVICE)
    (warm, warm_s) = _timed_run(svc.warmup)
    rng = np.random.RandomState(SERVE_SEED)
    sizes = rng.randint(1, SERVE_MAX_BATCH + 1, size=SERVE_REQUESTS)
    mids = [("live", "file")[i % 2] for i in range(SERVE_REQUESTS)]
    reqs = [rng.rand(int(s), X.shape[1]).astype(np.float32) for s in sizes]
    s0 = svc.stats()
    read = counts()
    lat, answers, trace_ids = [], [], []
    t0 = time.perf_counter()
    for mid, Xq in zip(mids, reqs):
        r0 = time.perf_counter()
        fut = svc.submit(mid, Xq)         # svc.predict's own two steps
        answers.append(fut.result())
        lat.append((time.perf_counter() - r0) * 1000.0)
        trace_ids.append(fut.trace_id)
    closed_s = time.perf_counter() - t0
    # where a request's time goes, per model, from the closed loop's own
    # serve_access records
    breakdown = request_breakdown(svc, lat, trace_ids, mids)
    closed_launches = read()
    s1 = svc.stats()
    lat = np.sort(lat)

    def q(p):
        return float(lat[min(len(lat) - 1, int(p * (len(lat) - 1) + 0.5))])
    dispatches = s1["dispatches"] - s0["dispatches"]
    n_pass = sum(closed_launches.values())
    closed = {"requests": SERVE_REQUESTS, "rows": int(sizes.sum()),
              "p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99),
              "dispatches_per_request": dispatches / SERVE_REQUESTS,
              "compiles_per_1k_requests":
                  (s1["compiles"] - s0["compiles"]) * 1000.0
                  / SERVE_REQUESTS,
              "rows_per_s": float(sizes.sum()) / closed_s,
              "predict_pass_launches": closed_launches,
              "dispatches": dispatches}
    read = counts()
    b0 = svc.stats()
    t0 = time.perf_counter()
    futs = [svc.submit(mid, Xq) for mid, Xq in zip(mids, reqs)]
    open_answers = [f.result(timeout=600) for f in futs]
    open_s = time.perf_counter() - t0
    b1 = svc.stats()
    batches = b1["batches"] - b0["batches"]
    open_loop = {"rows_per_s": float(sizes.sum()) / open_s,
                 "batches": batches,
                 "requests_per_batch": SERVE_REQUESTS / max(batches, 1),
                 "dispatches": b1["dispatches"] - b0["dispatches"],
                 "predict_pass_launches": read()}

    # ---- (b) every response against the float64 walk; the file model's
    # routing against the walk's leaves, bit for bit
    walk = lgb.Booster(params={"device_type": DEVICE}, model_file=path)
    Xall = np.concatenate(reqs).astype(np.float64)
    want = walk.predict(Xall)
    got = np.concatenate(answers)
    got_open = np.concatenate(open_answers)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                      1e-30)))
    leaves = walk.predict(Xall, pred_leaf=True)
    file_eng = svc.residency.get("file")
    live_eng = svc.residency.get("live")
    sums = _f32_sums(walk.models, leaves, 1)
    file_leaves_equal = bool(np.array_equal(file_eng.predict_raw(
        Xall.astype(np.float32)).astype(np.float32), sums))
    live_leaves_equal = bool(np.array_equal(live_eng.predict_raw(
        Xall.astype(np.float32)).astype(np.float32), sums))
    tree_leaves_equal = []
    for ti in range(3):                 # one tree at a time, exactly
        one = lgb.serve.ServingEngine(
            walk, max_batch_rows=SERVE_MAX_BATCH,
            min_bucket_rows=SERVE_MAX_BATCH, start_iteration=ti,
            num_iteration=1)
        Xq = reqs[0]
        lv = np.asarray(walk.models[ti].leaf_value, np.float64)[
            walk.predict(Xq, pred_leaf=True)[:, ti]].astype(np.float32)
        tree_leaves_equal.append(bool(np.array_equal(
            one.predict_raw(Xq)[0].astype(np.float32), lv)))
    res = {"phase": "serve", "run": "a", "model": "phase 3's, "
           f"{SERVE_ROUNDS} rounds", "trees": bst.num_trees(),
           "leaves_max": max(m.num_leaves for m in bst.models),
           "train_s": train_s, "warmup_s": warm_s,
           "warmed_buckets": warm["live"]["warmed"],
           "variants": {"live": live_eng.variant, "file": file_eng.variant},
           "max_steps": {"live": live_eng.pred.max_steps,
                         "file": file_eng.pred.max_steps},
           "packed_bytes": {"live": live_eng.packed_nbytes,
                            "file": file_eng.packed_nbytes},
           "closed_loop": closed, "open_loop": open_loop,
           "request_breakdown": breakdown,
           "max_rel_err_to_float64_walk": err, "tol": SERVE_TOL,
           "open_loop_equal_to_closed": bool(np.array_equal(got_open, got)),
           "file_routing_equal_to_walk_leaves": file_leaves_equal,
           "live_routing_equal_to_walk_leaves": live_leaves_equal,
           "one_tree_engines_equal_leaf_values": tree_leaves_equal,
           "latency_ms_service": s1["latency_ms"]}
    emit(res)
    if not (closed["dispatches_per_request"] == 1.0
            and closed["compiles_per_1k_requests"] == 0
            and n_pass == dispatches == SERVE_REQUESTS):
        raise AssertionError(f"serve (a): {closed}")
    if not (np.allclose(got, want, **SERVE_RTOL)
            and res["open_loop_equal_to_closed"] and file_leaves_equal
            and live_leaves_equal and all(tree_leaves_equal)):
        raise AssertionError(f"serve (b): relative error {err} to the "
                             f"float64 walk, routing equal to the walk's "
                             f"leaves: file {file_leaves_equal}, live "
                             f"{live_leaves_equal}, {tree_leaves_equal}")
    serve_launches = {k: closed_launches.get(k, 0)
                      + open_loop["predict_pass_launches"].get(k, 0)
                      for k in tp.variant_launches}

    # ---- (e) operands of (a): buckets 1024 and 65,536 of the stream's
    # rows (and of X past 1024 rows), both variants
    checks = {}
    X64k = np.concatenate([Xall, X[:SERVE_CHECK_BUCKETS[1]]])[
        :SERVE_CHECK_BUCKETS[1]]
    for eng, key in ((live_eng, "binned"), (file_eng, "raw")):
        for R in SERVE_CHECK_BUCKETS:
            Xr = X64k[:R]
            enc = torch.from_numpy(eng.pred.encode(Xr)).to(DEVICE)
            use = _PassUse(eng._ops, key)
            use.add_models(walk.models, walk.predict(Xr, pred_leaf=True))
            r = check_predict_pass(
                f"{key}[R={R}]", enc, eng._ops, eng._tids, 1,
                eng.pred.max_steps, key, use,
                serve_launches["predict_pass:" + key])
            checks[(key, R)] = r
    svc.close()
    del svc, live_eng, file_eng

    # ---- (c) categorical: phase 10's codes, both variants
    Xc = _cat_codes(X[:SERVE_CAT_ROWS], DATA_SEED + 400)
    dc = lgb.Dataset(Xc, label=y[:SERVE_CAT_ROWS],
                     categorical_feature=list(range(len(CAT_CARDINALITIES))),
                     params=params).construct()
    bst_c, cat_train_s = fit(dc, SERVE_CAT_ROUNDS)
    path_c = os.path.join(tmp, "serve_cat.txt")
    bst_c.save_model(path_c)
    svc = lgb.serve.PredictionService(
        {"cat_live": bst_c, "cat_file": path_c},
        max_batch_rows=SERVE_MAX_BATCH, max_delay_ms=1.0,
        min_bucket_rows=SERVE_MIN_BUCKET, batch_events=False,
        serve_devices=1, device_type=DEVICE)
    svc.warmup()
    read = counts()
    cat_reqs = [Xc[SERVE_MAX_BATCH * i:SERVE_MAX_BATCH * i + int(s)]
                for i, s in enumerate(sizes[:20])]
    cat_answers = [svc.predict(("cat_live", "cat_file")[i % 2], Xq)
                   for i, Xq in enumerate(cat_reqs)]
    cat_launches = read()
    walk_c = lgb.Booster(params={"device_type": DEVICE}, model_file=path_c)
    Xcall = np.concatenate(cat_reqs).astype(np.float64)
    want_c = walk_c.predict(Xcall)
    got_c = np.concatenate(cat_answers)
    err_c = float(np.max(np.abs(got_c - want_c)
                         / np.maximum(np.abs(want_c), 1e-30)))
    leaves_c = walk_c.predict(Xcall, pred_leaf=True)
    fc = svc.residency.get("cat_file")
    lc_eng = svc.residency.get("cat_live")
    cat_equal = bool(np.array_equal(
        fc.predict_raw(Xcall.astype(np.float32)).astype(np.float32),
        _f32_sums(walk_c.models, leaves_c, 1)))
    cat_splits = sum(int((m.decision_type[:m.num_internal] & 1).sum())
                     for m in bst_c.models)
    cat_bins = device_bins_check(lc_eng.pred, Xc)
    res_c = {"phase": "serve", "run": "c", "rows": SERVE_CAT_ROWS,
             "rounds": SERVE_CAT_ROUNDS, "train_s": cat_train_s,
             "categorical_splits": cat_splits,
             "variants": {"cat_live": lc_eng.variant,
                          "cat_file": fc.variant},
             "mask_widths": {"cat_live": int(lc_eng._ops[7].shape[2]),
                             "cat_file": int(fc._ops[8].shape[2])},
             "requests": len(cat_reqs), "predict_pass_launches":
             cat_launches, "max_rel_err_to_float64_walk": err_c,
             "tol": SERVE_TOL, "file_routing_equal_to_walk_leaves":
             cat_equal, "device_bins": cat_bins}
    emit(res_c)
    if not (cat_splits > 0 and np.allclose(got_c, want_c, **SERVE_RTOL)
            and cat_equal and cat_bins["rows_equal"]
            and cat_bins["edge_rows_equal"]
            and cat_launches["predict_pass:binned+cat"] > 0
            and cat_launches["predict_pass:raw+cat"] > 0):
        raise AssertionError(f"serve (c): {res_c}")
    for eng, key in ((lc_eng, "binned"), (fc, "raw")):
        Xr = Xcall[:SERVE_CHECK_BUCKETS[0]]
        enc = torch.from_numpy(eng.pred.encode(Xr)).to(DEVICE)
        use = _PassUse(eng._ops, key)
        use.add_models(walk_c.models, walk_c.predict(Xr, pred_leaf=True))
        checks[(key + "+cat", SERVE_CHECK_BUCKETS[0])] = check_predict_pass(
            f"{key}+cat[R={SERVE_CHECK_BUCKETS[0]}]", enc, eng._ops,
            eng._tids, 1, eng.pred.max_steps, key, use,
            cat_launches["predict_pass:" + key + "+cat"])
    svc.close()
    del svc, lc_eng, fc, dc, bst_c

    # ---- (e) a synthetic stack of k = 3 classes (no main-path launches)
    enc, ops, tids, steps, use = _synthetic_stack(
        SERVE_CHECK_BUCKETS[0], 60, X.shape[1], 63, 3, seed=15)
    checks[("k3", SERVE_CHECK_BUCKETS[0])] = check_predict_pass(
        "binned+cat[k=3]", enc, ops, tids, 3, steps, "binned", use, 0)

    # ---- (d) Booster.predict at scale: the 1M rows, 200 trees
    read = counts()
    pred_all, predict_s = _timed_run(lambda: bst.predict(X))
    scale_launches = read()
    pred = bst._device_predictor
    # its parts: the used columns as float64 on the host, their upload,
    # the binning on the card, the kernel
    vals, used_s = _timed_run(lambda: pred.used_values(X))
    vals_dev, upload_s = _timed_run(lambda: torch.from_numpy(vals)
                                    .to(DEVICE))
    del vals
    tables = pred.bin_tables or device_bin_tables(
        [pred.ds.mappers[j] for j in pred.ds.used_features], DEVICE)
    enc_dev, bin_s = _timed_run(lambda: values_to_bins(vals_dev, tables))
    bin_ms = cuda_ms(lambda: values_to_bins(vals_dev, tables), reps=5,
                     replays=3)
    del vals_dev
    # the device bins against the host's value_to_bin on every row, and on
    # the edge rows
    enc_np, enc_s = _timed_run(lambda: pred.encode(X))
    bins_equal = bool(np.array_equal(enc_dev.cpu().numpy(), enc_np))
    del enc_np
    edges = _edge_rows(pred)
    edge_dev = values_to_bins(torch.from_numpy(pred.used_values(edges))
                              .to(DEVICE), tables).cpu().numpy()
    edges_equal = bool(np.array_equal(edge_dev, pred.encode(edges)))
    ops_d, tids_d = pred.run_args(0, pred.num_trees)

    def pass_d():
        return tp.predict_pass(enc_dev, ops_d, tids_d, 1, pred.max_steps,
                               "binned")
    kernel_ms = cuda_ms(pass_d, reps=5, replays=3)
    raw_d = pass_d().cpu().numpy()[0]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    plain_d = tp.predict_pass_plain(enc_dev, ops_d, tids_d, 1,
                                    pred.max_steps, "binned")
    e1.record()
    e1.synchronize()
    plain_ms_d = e0.elapsed_time(e1)
    plain_equal = bool(np.array_equal(plain_d.cpu().numpy()[0], raw_d))
    del plain_d
    # the float64 walk this path took before pred_device_min_work was
    # honoured, timed on the same rows and trees
    walk_raw, walk_s = _timed_run(lambda: host_walk_raw(
        bst.models, X, 0, bst.num_trees(), 1, DEVICE))
    walk_all = bst.objective.convert_output(walk_raw[0])
    err_d = float(np.max(np.abs(pred_all - walk_all)
                         / np.maximum(np.abs(walk_all), 1e-30)))
    # the walk's leaves: what the rows need of the stack, for the bound,
    # and predict_pass's float32 sums bit for bit
    use_d, bits_d = _PassUse(ops_d, "binned"), True
    for c0 in range(0, X.shape[0], 250_000):
        leaves_d = bst.predict(X[c0:c0 + 250_000], pred_leaf=True)
        use_d.add_models(bst.models, leaves_d)
        bits_d &= bool(np.array_equal(
            raw_d[c0:c0 + 250_000], _f32_sums(bst.models, leaves_d, 1)[0]))
    del leaves_d
    bound_d = _pass_bound(enc_dev, ops_d, tids_d, 1, "binned", use_d)
    kernel_s = kernel_ms / 1e3
    res_d = {"phase": "serve", "run": "d", "rows": int(X.shape[0]),
             "trees": bst.num_trees(), "predictor": type(pred).__name__,
             "pred_device_min_work": bst._pred_device_min_work(),
             "predict_s": predict_s, "float64_walk_s": walk_s,
             "faster_than_walk": predict_s < walk_s,
             "breakdown_s": {
                 "used_columns_host": used_s, "upload": upload_s,
                 "device_binning": bin_s, "device_binning_kernel_time":
                 bin_ms / 1e3, "predict_pass": kernel_s,
                 "rest_host": predict_s - used_s - upload_s - bin_s
                 - kernel_s},
             "host_binning_s": enc_s,
             "device_bins_equal_value_to_bin": bins_equal,
             "edge_rows": int(edges.shape[0]),
             "edge_bins_equal_value_to_bin": edges_equal,
             "kernel_ms": kernel_ms, "plain_ms": plain_ms_d,
             "equal_to_plain": plain_equal,
             "bound_ms": bound_d[0], "bound_by": bound_d[1],
             "node_visits": use_d.visits,
             "nodes_visited": int(use_d.nodes.sum()),
             "leaves_reached": int(use_d.leaves.sum()),
             "predict_pass_launches": scale_launches,
             "max_rel_err_to_float64_walk": err_d, "tol": SERVE_TOL,
             "raw_equal_to_f32_sums_of_walk_leaves": bits_d}
    emit(res_d)
    if not (type(pred).__name__ == "DevicePredictor"
            and sum(scale_launches.values()) > 0 and bits_d
            and bins_equal and edges_equal and plain_equal
            and np.allclose(pred_all, walk_all, **SERVE_RTOL)):
        raise AssertionError(f"serve (d): {res_d}")
    if not predict_s < walk_s:
        raise AssertionError(f"serve (d): Booster.predict {predict_s} s, "
                             f"the float64 walk {walk_s} s")
    checks[("binned", int(X.shape[0]))] = {
        "rows": int(X.shape[0]), "features": int(enc_dev.shape[1]),
        "trees": bst.num_trees(), "k": 1, "max_steps": pred.max_steps,
        "max_abs_err": 0.0 if plain_equal else float("nan"),
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms_d, "bound_ms": bound_d[0],
        "bound_by": bound_d[1], "launches": 0}
    del enc_dev

    # the kernels line's rows: each variant on (a)'s or (c)'s operands at
    # bucket 1024 with its phase-15 launches, the k = 3 stack with none
    for key, label in (("binned", "binned"), ("raw", "raw"),
                       ("binned+cat", "binned,categorical"),
                       ("raw+cat", "raw,categorical")):
        r = checks[(key, SERVE_CHECK_BUCKETS[0])]
        n = r["launches"] + (scale_launches.get("predict_pass:" + key, 0))
        out_rows.append(_predict_row(f"predict_pass[{label}]", r, n))
    out_rows[0]["serve_p50_ms"] = closed["p50_ms"]
    out_rows.append(_predict_row(
        f"predict_pass[binned,R={X.shape[0]}]",
        checks[("binned", int(X.shape[0]))],
        scale_launches.get("predict_pass:binned", 0)))
    out_rows.append(_predict_row("predict_pass[binned,R=65536]",
                                 checks[("binned", SERVE_CHECK_BUCKETS[1])],
                                 checks[("binned", SERVE_CHECK_BUCKETS[1])]
                                 ["launches"]))
    out_rows.append(_predict_row("predict_pass[raw,R=65536]",
                                 checks[("raw", SERVE_CHECK_BUCKETS[1])],
                                 checks[("raw", SERVE_CHECK_BUCKETS[1])]
                                 ["launches"]))
    out_rows.append(_predict_row("predict_pass[binned,categorical,k=3]",
                                 checks[("k3", SERVE_CHECK_BUCKETS[0])], 0))
    return out_rows


def _predict_row(name, r, launches):
    return {"name": name, "route": "cuda", "source": SOURCES["predict_pass"],
            "replaces": PREDICT_REPLACES, "launches": launches,
            "cuda_launches": {"predict_pass": launches},
            "operands": f"{r['rows']} rows x {r['features']} features, "
                        f"{r['trees']} trees, k={r['k']}, max_steps "
                        f"{r['max_steps']}",
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None}


def _dist_cfg():
    """The constants phase 16's ranks run with (a rank loads this file
    afresh, so a rehearsal's settings travel with the call)."""
    return {k: globals()[k] for k in ("DEVICE", "ROWS", "DIST_ROWS",
                                      "ROUNDS", "DIST_XLA_ROUNDS")}


def _set_dist_cfg(cfg) -> None:
    globals().update(cfg)
    globals()["DIST_RUNS"] = (
        ("a", {"tree_learner": "data"}, ROUNDS),
        ("b", {"tree_learner": "data", "tpu_quantized_grad": 16}, ROUNDS),
        ("c", {"tree_learner": "voting", "top_k": DIST_TOP_K}, ROUNDS),
        ("d", {"tree_learner": "data", "tpu_engine": "xla"},
         DIST_XLA_ROUNDS))


def _dev_sync() -> None:
    import torch
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def _dist_rows(rank: int, world: int):
    """Phase 16's rows: phase 3's draw cut to DIST_ROWS, and this rank's
    contiguous block of them (world 1: all of them)."""
    from lightgbm_tpu_torch.parallel.mesh import shard_rows
    X, z, _ = _class_rows(ROWS, FEATURES, seed=DATA_SEED)
    X, y = X[:DIST_ROWS], (z[:DIST_ROWS] > 0).astype(np.float32)
    return shard_rows(X, rank, world), shard_rows(y, rank, world)


def _dist_params(every_row_binned: bool = True):
    """Phase 3's parameters; by default every row goes into the binning
    sample, so the ranks' gathered samples (each rank's rows) and the
    serial run's are the same rows and give the same mappers."""
    p = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
         "learning_rate": 0.1, "min_data_in_leaf": 1,
         "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
         "device_type": DEVICE}
    if every_row_binned:
        p["bin_construct_sample_cnt"] = DIST_ROWS
    return p


DIST_RUNS = ()      # set by _set_dist_cfg


def _timed_dist_train(lgb, params, ds, rounds):
    """train() under a timed CollectiveTrace: (booster, its numbers)."""
    import torch
    from lightgbm_tpu_torch.ops.collectives import CollectiveTrace
    reader = _run_counts()
    _dev_sync()
    ds.params = {}
    on_card = DEVICE != "cpu"
    if on_card:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
    with CollectiveTrace(timed=True) as rec:
        t0 = time.perf_counter()
        if on_card:
            e0.record()
        bst = lgb.train(params, ds, num_boost_round=rounds)
        if on_card:
            e1.record()
        _dev_sync()
        wall = time.perf_counter() - t0
    launches, cuda, syncs = reader()
    n = bst.num_trees()
    return bst, {
        "trees": n, "train_s": wall, "sec_per_iter": wall / rounds,
        "device_span_ms_per_iter": (e0.elapsed_time(e1) / rounds
                                    if on_card else None),
        "launches": launches, "host_syncs_per_tree": syncs / max(1, n),
        "collective_calls_per_tree": rec.count / max(1, n),
        "collective_bytes_per_tree": rec.bytes / max(1, n),
        "collective_by_dtype": {k: list(v) for k, v in rec.by_dtype.items()},
        "collective_s": rec.seconds,
        "collective_share_of_wall": rec.seconds / wall}


def _feature_grower_check(rank, world):
    """Phase 16e on this rank, rows replicated: the feature-parallel
    depth-wise XLA tree and the fused tree (each rank scanning its half of
    the columns) against the serial growers' trees on the same rows, every
    array to the last bit."""
    import torch
    import torch.distributed as dist
    from lightgbm_tpu_torch.models.frontier2 import grow_tree_fused
    from lightgbm_tpu_torch.models.learner import (FeatureMeta,
                                                   grow_tree_depthwise)
    from lightgbm_tpu_torch.ops.fused_level import pack_gh
    from lightgbm_tpu_torch.ops.layout import feature_layout
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.parallel import make_feature_parallel_grow_fn
    dev = torch.device(DEVICE)
    X, y = _dist_rows(0, 1)
    B, L, F = 63, 255, FEATURES
    bins = torch.as_tensor(np.minimum(X * B, B - 1).astype(np.uint8),
                           device=dev)
    yt = torch.as_tensor(y, device=dev)
    gh = torch.stack([0.5 - yt, torch.full_like(yt, 0.25),
                      torch.ones_like(yt)], 1).contiguous()
    params = SplitParams(min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3)
    z = torch.zeros(F, dtype=torch.int32, device=dev)
    meta = FeatureMeta(torch.full((F,), B, dtype=torch.int32, device=dev),
                       z, z, z)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    group = dist.group.WORLD
    out = {}

    def same(t1, r1, t2, r2):
        keys = [k for k in t1._fields if k != "num_leaves"
                and getattr(t1, k) is not None]
        diff = [k for k in keys
                if not torch.equal(getattr(t1, k), getattr(t2, k))]
        if t1.num_leaves != t2.num_leaves:
            diff.append("num_leaves")
        if not torch.equal(r1, r2):
            diff.append("row_leaf")
        return diff
    reader = _run_counts()
    fn = make_feature_parallel_grow_fn(group, params, L, B)
    t_f, r_f = fn(bins, gh, meta, fm)
    launches = reader()[0]
    t_s, r_s = grow_tree_depthwise(bins, gh, meta, fm, params, L, B)
    out["xla_depthwise"] = {"leaves": int(t_f.num_leaves),
                            "differs": same(t_f, r_f, t_s, r_s),
                            "hist_pass_launches": launches["hist_pass"]}
    F_oh, Bp = feature_layout(F, 64)
    Rp = ((X.shape[0] + 2047) // 2048) * 2048
    bins_T = torch.zeros((max(F_oh, 8), Rp), dtype=torch.int8, device=dev)
    bins_T[:F, :X.shape[0]] = bins.t().to(torch.int8)
    pad = Rp - X.shape[0]
    gh_T = pack_gh(*(torch.nn.functional.pad(gh[:, i], (0, pad))
                     for i in range(3)), 5)
    nb = torch.zeros(F_oh, dtype=torch.int32, device=dev)
    nb[:F] = B
    zf = torch.zeros(F_oh, dtype=torch.int32, device=dev)
    fmeta = FeatureMeta(nb, zf, zf, zf)
    ffm = torch.arange(F_oh, device=dev) < F
    shard = torch.arange(F_oh, device=dev) // (F_oh // world) == rank
    kw = dict(num_rows=X.shape[0], nch=5)
    reader = _run_counts()
    t_f, r_f = grow_tree_fused(bins_T, gh_T, fmeta, ffm, params, L, Bp, F_oh,
                               group=group, parallel_mode="feature",
                               feature_shard_mask=shard, **kw)
    launches = reader()[0]
    t_s, r_s = grow_tree_fused(bins_T, gh_T, fmeta, ffm, params, L, Bp, F_oh,
                               **kw)
    out["fused"] = {"leaves": int(t_f.num_leaves),
                    "differs": same(t_f, r_f, t_s, r_s),
                    "level_pass_launches": launches["level_pass"],
                    "route_pass_launches": launches["route_pass"]}
    return out


def dist_rank(rank: int, world: int, cfg):
    """Phase 16's program on one rank (``parallel.spawn``, gloo, cuda:0):
    runs (a)-(d) through train() on this rank's block of DIST_ROWS rows,
    then (e) at the grower level on every row. Returns each run's model
    text, host trees, local training scores and numbers."""
    import torch
    import torch.distributed as dist
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import mesh
    _set_dist_cfg(cfg)
    Xr, yr = _dist_rows(rank, world)
    params = _dist_params()
    t0 = time.perf_counter()
    # a parallel tree_learner in the Dataset's params: the ranks bin from
    # the gathered sample
    ds = lgb.Dataset(Xr, label=yr, params=dict(
        params, tree_learner="data")).construct()
    from lightgbm_tpu_torch.binning import mappers_digest
    out = {"construct_s": time.perf_counter() - t0,
           "mappers": mappers_digest(ds._inner.mappers),
           "backend": dist.get_backend(),
           "host_backend": dist.get_backend(mesh.host_group()),
           "device": (str(torch.device("cuda", torch.cuda.current_device()))
                      if DEVICE != "cpu" else DEVICE)}
    for run, extra, rounds in DIST_RUNS:
        bst, res = _timed_dist_train(lgb, dict(params, **extra), ds, rounds)
        res.update(text=bst.model_to_string(), models=bst.models,
                   scores=bst.train_scores().float().cpu().numpy())
        out[run] = res
    out["e"] = _feature_grower_check(rank, world)
    return out


def dist_nccl_rank(rank: int, world: int, cfg):
    """Phase 16f on a group of one rank over nccl: record_psum on a CUDA
    tensor, then tree_learner=data on phase 3's rows, which warns and
    trains serially."""
    import torch
    import torch.distributed as dist
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops.collectives import record_psum
    from lightgbm_tpu_torch.utils import log
    _set_dist_cfg(cfg)
    x = torch.arange(12, dtype=torch.float32, device=DEVICE)
    s = record_psum(x, dist.group.WORLD)
    X, z, _ = _class_rows(ROWS, FEATURES, seed=DATA_SEED)
    y = (z > 0).astype(np.float32)
    said = []
    log.register_logger(said.append)
    try:
        bst = lgb.train(dict(_dist_params(False), tree_learner="data"),
                        lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    finally:
        log.register_logger(None)
    return {"backend": dist.get_backend(),
            "psum_ok": bool(torch.equal(s, x))
            and s.is_cuda == (DEVICE != "cpu"),
            "warned": [m for m in said if "training serially" in m],
            "models": bst.models}


def _leading_nodes_equal(m1, m2) -> int:
    """How many internal nodes, in node order (level order on the fused
    grower, split order on the leaf-wise one), have the same split
    feature, threshold and children before the first that differs."""
    n = min(m1.num_leaves, m2.num_leaves) - 1
    for i in range(n):
        if any(getattr(m1, k)[i] != getattr(m2, k)[i]
               for k in ("split_feature", "threshold", "left_child",
                         "right_child")):
            return i
    return n


def _same_structure(m1, m2):
    return (m1.num_leaves == m2.num_leaves
            and all(np.array_equal(getattr(m1, k), getattr(m2, k))
                    for k in ("split_feature", "threshold", "left_child",
                              "right_child", "leaf_count")))


def run_dist_train(lgb, bst3):
    """Phase 16: distributed training over torch.distributed. Two ranks of
    the port (``parallel.spawn``), both on cuda:0 over gloo (NCCL refuses
    two ranks on one device, and the machine has one card), each holding
    its block of phase 3's draw cut to DIST_ROWS rows (two unpadded blocks
    of 499,712): (a) tree_learner=data on the fused engine, f32: the ranks'
    model texts identical, against the serial model on the same rows the
    trees of identical structure and leaf counts counted (the first must
    be), AUC within 1e-4 of the serial model's; (b) the same with
    tpu_quantized_grad=16: every tree equal to the serial quantized
    model's, leaf values exactly; (c) tree_learner=voting, top_k=5: the
    ranks agree, AUC > 0.75, the collective bytes per tree against (a)'s;
    (d) data-parallel on the XLA engine, leaf-wise, DIST_XLA_ROUNDS rounds:
    each rank runs leaf_partition and leaf_hist on its own lists, the ranks
    agree, the trees against the serial XLA run as in (a); (e) at the
    grower level, rows replicated: the feature-parallel depth-wise XLA tree
    and fused tree equal the serial growers' to the last bit. Then (f) one
    rank over nccl: record_psum on a CUDA tensor, and tree_learner=data
    warns and trains phase 3's model. The collective times are gloo's:
    host-staged round trips, not NCCL or NVLink."""
    import shutil
    import tempfile
    from lightgbm_tpu_torch.parallel.spawn import run_ranks
    here = os.path.abspath(__file__)
    t_phase = time.perf_counter()
    cfg = _dist_cfg()
    _set_dist_cfg(cfg)
    wd = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    ranks = run_ranks(here + ":dist_rank", DIST_WORLD, (cfg,), workdir=wd,
                      device_type=DEVICE, backend="gloo",
                      deadline_s=DIST_DEADLINE_S, timeout_s=DIST_TIMEOUT_S)
    ranks_s = time.perf_counter() - t_phase
    # the serial references on the same rows, in this process
    X, y = _dist_rows(0, 1)
    params = _dist_params()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    from lightgbm_tpu_torch.binning import mappers_digest
    if any(r["mappers"] != mappers_digest(ds._inner.mappers)
           for r in ranks):
        raise AssertionError("phase 16: a rank's bin mappers (from the "
                             "gathered sample) differ from the serial ones")
    serial = {}
    for run, extra, rounds in DIST_RUNS:
        if run == "c":
            continue
        p = dict(params, **{k: v for k, v in extra.items()
                            if k != "tree_learner"})
        bst, res = _timed_dist_train(lgb, p, ds, rounds)
        res["scores"] = bst.train_scores().float().cpu().numpy()
        serial[run] = (bst.models, res)
    out = {}
    for run, extra, rounds in DIST_RUNS:
        r0, r1 = ranks[0][run], ranks[1][run]
        if r0["text"] != r1["text"]:
            raise AssertionError(f"phase 16 run {run}: the ranks' model "
                                 "texts differ")
        scores = np.concatenate([r0["scores"], r1["scores"]])
        res = {"phase": "dist_train", "run": run, "params": extra,
               "rows": DIST_ROWS, "ranks": DIST_WORLD,
               "backend": ranks[0]["backend"],
               "host_backend": ranks[0]["host_backend"],
               "devices": [r["device"] for r in ranks],
               "trees": r0["trees"], "train_auc": auc(scores, y),
               "per_rank": [{k: r[run][k] for k in (
                   "sec_per_iter", "device_span_ms_per_iter",
                   "host_syncs_per_tree", "collective_calls_per_tree",
                   "collective_bytes_per_tree", "collective_by_dtype",
                   "collective_s", "collective_share_of_wall")}
                   | {"launches": {k: v for k, v in r[run]["launches"].items()
                                   if v}} for r in ranks],
               "collective_note": "gloo on cuda:0: host-staged round trips"}
        if run in serial:
            s_models, s_res = serial[run]
            same = [_same_structure(a, b) for a, b in zip(r0["models"],
                                                           s_models)]
            exact = [bool(_same_structure(a, b) and np.array_equal(
                a.leaf_value, b.leaf_value))
                for a, b in zip(r0["models"], s_models)]
            res.update(serial_trees=len(s_models),
                       first_tree_leading_nodes_equal=_leading_nodes_equal(
                           r0["models"][0], s_models[0]),
                       first_tree_internal_nodes=r0["models"][0].num_leaves
                       - 1,
                       leading_nodes_equal=[
                           _leading_nodes_equal(a, b)
                           for a, b in zip(r0["models"], s_models)],
                       trees_same_structure=int(sum(same)),
                       trees_exact=int(sum(exact)),
                       serial_auc=auc(s_res["scores"], y),
                       serial_sec_per_iter=s_res["sec_per_iter"],
                       serial_device_span_ms_per_iter=s_res[
                           "device_span_ms_per_iter"])
            res["auc_gap"] = abs(res["train_auc"] - res["serial_auc"])
        out[run] = res
        emit(res)
        kern = ("leaf_partition", "leaf_hist") if run == "d" \
            else TRAIN_PATH_KERNELS
        for r in ranks:
            for k in kern:
                # (the plain versions of a CPU rehearsal count nothing)
                if DEVICE != "cpu" and r[run]["launches"].get(k, 0) <= 0:
                    raise AssertionError(f"phase 16 run {run}: {k} never "
                                         "launched on a rank")
        if run in ("a", "d"):
            # (a): the fused plane sums bf16 hi/lo parts, and the two
            # ranks' planes summed gave the serial bits in every tree; (d):
            # leaf_hist sums f32 values in list order, so the ranks'
            # partial sums may differ from the serial ones by an ulp and a
            # near-tie of a later tree flip (the first tree must match)
            want = r0["trees"] if run == "a" else 1
            if not (len(same) == r0["trees"] == len(s_models)
                    and all(same[:want])):
                raise AssertionError(
                    f"phase 16 run {run}: {sum(same)} of {r0['trees']} "
                    f"trees have the serial structure (serial "
                    f"{len(s_models)}; {want} must)")
            if res["auc_gap"] > 1e-4:
                raise AssertionError(f"phase 16 run {run}: AUC "
                                     f"{res['train_auc']} vs serial "
                                     f"{res['serial_auc']}")
        if run == "b" and (res["trees_exact"] != len(s_models)
                           or len(s_models) != r0["trees"]):
            raise AssertionError("phase 16 run b: the quantized trees differ "
                                 "from the serial quantized model's")
        if run == "c" and not res["train_auc"] > 0.75:
            raise AssertionError(f"phase 16 run c: AUC {res['train_auc']}")
    vote_ratio = (out["c"]["per_rank"][0]["collective_bytes_per_tree"]
                  / out["a"]["per_rank"][0]["collective_bytes_per_tree"])
    e = [r["e"] for r in ranks]
    emit({"phase": "dist_train", "run": "e", "grower": e,
          "voting_bytes_over_data": vote_ratio,
          "vote_fraction": 2 * DIST_TOP_K / FEATURES})
    # the levels exchange 10 of 28 columns; the full root exchange, the
    # int32 votes and the different trees keep the ratio above 10/28
    if not vote_ratio < 0.6:
        raise AssertionError(f"phase 16 run c: voting moved {vote_ratio} "
                             f"of data-parallel's bytes per tree")
    for r in e:
        for g in ("xla_depthwise", "fused"):
            if r[g]["differs"]:
                raise AssertionError(f"phase 16 run e: the feature-parallel "
                                     f"{g} tree differs from the serial one "
                                     f"in {r[g]['differs']}")
        if DEVICE != "cpu" and (
                r["xla_depthwise"]["hist_pass_launches"] <= 0
                or r["fused"]["level_pass_launches"] <= 0):
            raise AssertionError("phase 16 run e: a grower's kernel never "
                                 "launched")
    f = run_ranks(here + ":dist_nccl_rank", 1, (cfg,), workdir=wd + "/f",
                  device_type=DEVICE, deadline_s=DIST_DEADLINE_S,
                  timeout_s=DIST_TIMEOUT_S)[0]
    f_same = [_same_structure(a, b) and np.allclose(
        a.leaf_value, b.leaf_value, rtol=1e-5, atol=1e-6)
        for a, b in zip(f["models"], bst3.models)]
    emit({"phase": "dist_train", "run": "f", "backend": f["backend"],
          "record_psum_cuda_ok": f["psum_ok"], "warning": f["warned"][:1],
          "trees_equal_phase3": int(sum(f_same)),
          "phase3_trees": len(bst3.models)})
    if not (f["backend"] == ("nccl" if DEVICE != "cpu" else "gloo")
            and f["psum_ok"] and f["warned"]
            and all(f_same) and len(f_same) == len(bst3.models)):
        raise AssertionError("phase 16 run f failed")
    shutil.rmtree(wd, ignore_errors=True)
    emit({"phase": "dist_train", "phase_s": time.perf_counter() - t_phase,
          "ranks_s": ranks_s})
    return {run: [r[run]["launches"] for r in ranks]
            for run, _, _ in DIST_RUNS} | {
        "e": [{"hist_pass": r["e"]["xla_depthwise"]["hist_pass_launches"],
               "level_pass": r["e"]["fused"]["level_pass_launches"],
               "route_pass": r["e"]["fused"]["route_pass_launches"]}
              for r in ranks]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models import frontier2
    from lightgbm_tpu_torch.ops import cuda_build
    from lightgbm_tpu_torch.ops import fused_level as fl
    from lightgbm_tpu_torch.ops.layout import feature_layout

    # ---- 1. environment and build
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(str(cuda_build.build_info.get("ptxas", "")))
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "nvcc_build_s": cuda_build.build_info.get(
              "seconds"), "ptxas": ptxas})
    # what the epilogue's histogram stage compiled to: its adds are plain
    # shared-memory loads, f32 adds and stores (no matrix instruction, no
    # atomic); PERF.md has the tensor-core design it replaced
    sass = sass_hist_ops(cuda_build.build())
    hist_atomics = sass_hist_pass_atomics(cuda_build.build())
    emit({"phase": "sass", "epilogue_hist_kernel": sass,
          "hist_pass_atomics": hist_atomics})
    if len(sass) != 20 or any(n["ATOMS"] or n["RED"] or n["ATOMG"]
                             or not (n["LDS"] and n["STS"] and n["FADD"])
                             for n in sass.values()):
        raise AssertionError(f"the epilogue's histogram stage compiled to "
                             f"other instructions than expected: {sass}")
    if not hist_atomics_ok(hist_atomics):
        raise AssertionError(f"hist_pass compiled to other atomics than "
                             f"native integer shared-memory adds: "
                             f"{hist_atomics}")

    # ---- 2. kernels against their plain versions at the slice's shapes
    Rp = ((ROWS + 2047) // 2048) * 2048
    checks = []
    main_cfg = None
    for B in (64, 256):
        for nch in (fl.NCH_PRECISE, fl.NCH_FAST):
            cap = fl.max_slot_cap(FEATURES * B, nch)
            for Sp in sorted({8, cap}):
                res = check_level(Rp, ROWS, np.full(FEATURES, B - 1,
                                                    np.int32), B, Sp,
                                  seed=B + Sp + nch, nch=nch)
                emit({"phase": "kernel_check", **res})
                checks.append(res)
                if B == 64 and nch == fl.NCH_PRECISE and Sp == cap:
                    main_cfg = res
    lookup = check_lookup(Rp, ROWS, 255, seed=7)
    emit({"phase": "kernel_check", "table_lookup": lookup})
    epi_main = None
    for B in (64, 256):
        for nch in (fl.NCH_PRECISE, fl.NCH_FAST):
            cap = fl.max_slot_cap(FEATURES * B, nch)
            for kind in ("binary", "l2"):
                for Sp in sorted({8, cap}):
                    main = (B, nch, kind, Sp) == (64, fl.NCH_PRECISE,
                                                  "binary", cap)
                    res = check_epilogue(Rp, ROWS, B, Sp, nch, kind,
                                         "grower", stages=main,
                                         seed=B + Sp + nch + len(kind))
                    emit({"phase": "kernel_check", "epilogue_pass": res})
                    if main:
                        epi_main = res
            for table in ("odd", "categorical"):
                res = check_epilogue(Rp, ROWS, B, cap, nch,
                                     "binary" if nch == fl.NCH_PRECISE
                                     else "l2", table, seed=B + nch + 5)
                emit({"phase": "kernel_check", "epilogue_pass": res})
    res = check_epilogue(Rp, ROWS, 64, 64, fl.NCH_PRECISE, "binary",
                         "inactive", seed=3)
    emit({"phase": "kernel_check", "epilogue_pass": res})
    hist_main = None
    for B in (64, 256):
        for S in (8, 64):
            for bits in (0, 8, 16):
                main = (B, S, bits) == (64, 64, 0)
                res = check_hist(ROWS, FEATURES, B, S, bits,
                                 seed=B + S + bits, stages=main)
                emit({"phase": "kernel_check", "hist_pass": res})
                if main:
                    hist_main = res
    res = check_hist(ROWS, FEATURES, 64, 8, 0, seed=72, slots="root")
    emit({"phase": "kernel_check", "hist_pass": res})
    # the XLA engine's unrounded f32 variant: a leaf-wise step (S = 1) and
    # a depth-wise level (S = 256), and on a bundled layout (11a's 88
    # columns of up to 256 bins, the int16 bins widened to the kernel's
    # int32 copy)
    unrounded = {}
    for B in (64, 256):
        for S in (1, 256):
            res = check_hist(ROWS, FEATURES, B, S, 0, seed=B + S + 3,
                             stages=(B, S) == (64, 1), unrounded=True)
            emit({"phase": "kernel_check", "hist_pass": res})
            if B == 64:
                unrounded[S if S == 1 else "level"] = res
    res = check_hist(ROWS, BUNDLED_COLUMNS, 256, 256, 0, seed=88,
                     unrounded=True)
    emit({"phase": "kernel_check", "hist_pass": {"layout": "bundled",
                                                 **res}})
    bundled = {}
    for i, Bc_p in enumerate(BUNDLE_WIDTHS):
        res = check_bundled(Rp, ROWS, Bc_p, seed=90 + i)
        emit({"phase": "kernel_check", "bundled": res})
        bundled[Bc_p] = res
    plane_main = {}
    for Sp in (8, 64):
        for i, (bits, packed, masked) in enumerate(PLANE_VARIANTS):
            res = check_level(Rp, ROWS, PLANE_NUM_BIN, 64, Sp, seed=Sp + i,
                              quant_bits=bits, packed=packed, masked=masked)
            emit({"phase": "kernel_check", "plane": res})
            if Sp == 64:
                plane_main[res["variant"]] = res

    # ---- 3. end to end through lightgbm_tpu_torch.train
    X, z, w = _class_rows(ROWS, FEATURES, seed=DATA_SEED)
    y = (z > 0).astype(np.float32)     # _make_data's labels
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 1e-3, "verbose": -1,
              "device_type": DEVICE}
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=params).construct()
    construct_s = time.perf_counter() - t0
    F_oh, Bp = feature_layout(ds._inner.num_features, ds._inner.max_num_bin)
    # a Booster merges its parameters into its Dataset's, as LightGBM's
    # does, and a later Booster on that Dataset inherits them: every run
    # below clears the Dataset's parameters first (the dataset stays
    # binned), so bagging or tpu_engine never leak from one run into the
    # next

    def timed_train(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.params = {}
        b = lgb.train(params, ds, num_boost_round=rounds)
        torch.cuda.synchronize()
        return b, time.perf_counter() - t

    timed_train(1)                        # warm-up (allocator, library)
    _, t_one = timed_train(1)
    fl.reset_launch_counts()
    frontier2.host_syncs["count"] = 0
    bst, t_all = timed_train(ROUNDS)      # the main path
    launches = dict(fl.launches)
    cuda = dict(fl.cuda_launches)
    syncs = frontier2.host_syncs["count"]
    n_trees = bst.num_trees()
    scores = bst.train_scores().float().cpu().numpy()
    train_auc = auc(scores, y)
    pred = walk_predict(bst, X[:100_000], raw_score=True)
    pred_err = float(np.abs(pred - scores[:100_000]).max())
    ok_pred = bool(np.allclose(pred, scores[:100_000], rtol=1e-5,
                               atol=1e-5))
    e2e = {"phase": "end_to_end", "rows": ROWS, "features": FEATURES,
           "F_oh": F_oh, "Bp": Bp, "rounds": ROUNDS, "trees": n_trees,
           "construct_s": construct_s,
           "sec_per_iter_after_first": (t_all - t_one) / (ROUNDS - 1),
           "train_s": t_all, "train_auc": train_auc,
           "launches": launches, "cuda_launches": cuda,
           "host_syncs_per_tree": syncs / n_trees,
           "predict_max_abs_err": pred_err, "predict_tol":
           "rtol=1e-5 atol=1e-5", "leaves": [m.num_leaves
                                              for m in bst.models]}
    emit(e2e)
    if n_trees != ROUNDS:
        raise AssertionError(f"trained {n_trees} trees, wanted {ROUNDS}")
    if not train_auc > 0.75:
        raise AssertionError(f"training AUC {train_auc} <= 0.75")
    for name in TRAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "train() path")
    if not ok_pred:
        raise AssertionError(f"predict differs from the trainer's scores "
                             f"by {pred_err}")
    check_stages(launches, cuda, "train()")

    # ---- 4. the loop bench.py times: Booster(params, train_set).update(),
    # on the epilogue body (a) and, in turns with it, the megastep body
    # train() runs (m); then (b) with bagging and feature_fraction
    bagged = {"bagging_fraction": 0.5, "bagging_freq": 1,
              "feature_fraction": 0.8}
    upd_launches = upd_cuda = None
    for name, extra, megastep in (("m", {}, True), ("a", {}, False),
                                  ("a", {}, False), ("m", {}, True),
                                  ("b", bagged, False)):
        res, n_launch, n_cuda = run_updates(lgb, dict(params, **extra), ds,
                                            X, y, megastep)
        emit({"phase": "update_path", "run": name, "params": extra, **res})
        if name == "a" and upd_launches is None:
            upd_launches, upd_cuda = n_launch, n_cuda

    # ---- 5. the frontier-v1 engine through train()
    fr_launches, fr_cuda = run_frontier(lgb, params, ds, X, y)

    # ---- 6. the histogram-plane cuts through train()
    plane_launches = run_plane_cuts(lgb, params, X, y)

    # ---- 7. valid sets, metrics, callbacks, early stopping and cv
    eval_launches = run_eval_train(lgb, params, ds, X, y, w, e2e)

    # ---- 8. multiclass, GOSS, node masks and the pointwise objectives
    class_launches = run_class_train(lgb, params, ds, y, z, w, e2e)

    # ---- 9. ranking: lambdarank, rank_xendcg, ndcg/map, query folds
    rank_launches = run_rank_train(lgb, params, e2e)

    # ---- 10. categorical splits through the same kernels
    cat_launches = run_cat_train(lgb, params, X, y, z, e2e)

    # ---- 11. exclusive feature bundling and sparse input
    del X
    bundle_launches, bundle_checks = run_bundle_train(lgb, params)

    # ---- 12. monotone constraints, and the rest of Booster and Dataset,
    # on phase 3's rows (drawn again)
    X, _, _ = _class_rows(ROWS, FEATURES, seed=DATA_SEED)
    mono_launches, mono_checks = run_mono_train(lgb, params, ds, X, y, w,
                                                e2e)

    # ---- 13. DART, RF, linear-tree leaves and TreeSHAP on phase 3's rows
    slice_launches, slice_check = run_slice_train(lgb, params, ds, X, y, z,
                                                  w, e2e)

    # ---- 14. the XLA engine: leaf-wise and depth-wise growers, CEGB,
    # forced splits, advanced monotone, bundle columns
    xla_launches, xla_checks = run_xla_train(lgb, params, ds, X, y, w, e2e)

    # ---- 15. serving on the card: the stacked-tree predictor through
    # predict_pass, Booster.predict at scale, the PredictionService
    serve_rows = run_serve(lgb, params, ds, X, y, e2e)
    del X

    # ---- 16. distributed training: two ranks on cuda:0 over gloo
    dist_launches = run_dist_train(lgb, bst)

    # ---- 17. the kernels line (level/route at Bp=64 int8, nch=5, Sp=64;
    # the epilogue at Bp=64 int8, nch=5, binary, Sp=64; hist_pass at Bp=64,
    # Sp=64, f32). Launches: the train() run for the three kernels of its
    # path, update() run (a) for the epilogue, the frontier train() run for
    # hist_pass; and each kernel's in phase 7's runs (a), (c) and (d) and
    # in every run of phases 8, 9 and 10
    lv, rt = main_cfg["level_pass"], main_cfg["route_pass"]
    rows = []
    for name, r, err, n, n_cuda in (
            ("level_pass", lv, lv["max_abs_err"], launches["level_pass"],
             cuda),
            ("route_pass", rt, rt["max_abs_err"], launches["route_pass"],
             cuda),
            ("table_lookup", lookup, lookup["max_abs_err"],
             launches["table_lookup"], cuda),
            ("epilogue_pass", epi_main,
             max(epi_main["hist_max_abs_err"], epi_main["gh_max_abs_err"],
                 epi_main["new_score_max_abs_err"]),
             upd_launches["epilogue_pass"], upd_cuda),
            ("hist_pass", hist_main, hist_main["max_abs_err"],
             fr_launches["hist_pass"], fr_cuda)):
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": n,
               "cuda_launches": kernel_cuda_launches(name, n_cuda),
               "max_abs_err": err, "ms": r["kernel_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name == "table_lookup":
            row.update({k: r[k] for k in ("kernel_ms_per_call",
                                          "library_ms_per_call",
                                          "library_call")})
        if name in ("level_pass", "epilogue_pass", "hist_pass"):
            row["stages_ms"] = r["stages_ms"]
        if name == "hist_pass":
            row["ms_repeat"] = r["kernel_ms_repeat"]
        row["eval_train_launches"] = {run: eval_launches[run][name]
                                      for run in ("a", "c", "d")}
        row["class_train_launches"] = {run: v[name]
                                       for run, v in class_launches.items()}
        row["rank_train_launches"] = {run: v[name]
                                      for run, v in rank_launches.items()}
        row["cat_train_launches"] = {run: cat_launches[run][name]
                                     for run in ("a", "b", "c")}
        row["bundle_train_launches"] = {run: bundle_launches[run][name]
                                        for run in ("a", "b", "c")}
        row["mono_train_launches"] = {run: mono_launches[run][name]
                                      for run in ("a", "b", "c")}
        for run, key in (("a", "dart_train_launches"),
                         ("b", "rf_train_launches"),
                         ("c", "linear_train_launches")):
            row[key] = slice_launches[run][name]
        row["xla_train_launches"] = {run: v[name]
                                     for run, v in xla_launches.items()}
        row["dist_train_launches_per_rank"] = {
            run: [v.get(name, 0) for v in per_rank]
            for run, per_rank in dist_launches.items()}
        rows.append(row)
    # hist_pass's unrounded f32 variant, the XLA engine's histogram: on
    # phase 14a's (a leaf-wise root, S = 1) and 14b's (a depth-wise level,
    # S = L) own operands, each with its run's launches; phase 2's
    # synthetic checks of the variant beside them
    for run, S in (("a", 1), ("b", params["num_leaves"])):
        r = xla_checks[run]
        rows.append({
            "name": f"hist_pass[f32_unrounded,S={S}]", "route": "cuda",
            "source": SOURCES["hist_pass"], "replaces": XLA_REPLACES,
            "launches": xla_launches[run]["hist_pass"],
            "launches_per_tree": xla_launches[run]["hist_pass"] / ROUNDS,
            "cuda_launches": kernel_cuda_launches(
                "hist_pass", xla_launches[run]["cuda"]),
            "operands": (f"phase 14 run {run}, its own"
                         + (" (a tree's root)" if run == "a" else "")),
            "S": r["S"],
            "slotted_rows": r["slotted_rows"],
            "max_abs_err": r["max_abs_err"],
            "rel_err_of_abs_sum": r["rel_err_of_abs_sum"],
            "ms": r["kernel_ms"], "ms_repeat": r["kernel_ms_repeat"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "phase2": {k: unrounded[S if S == 1 else "level"][k]
                       for k in ("R", "Fp", "Bp", "S", "max_abs_err",
                                 "kernel_ms", "kernel_ms_repeat",
                                 "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}})
    # the leaf-wise step's list kernels (csrc/data_partition.cu) on phase
    # 14a's own operands (logical columns) and 14d's (bundle columns), each
    # with its run's launches (every run's beside them)
    for run, name in [(run, name) for run in ("a", "d")
                      for name in ("leaf_partition", "leaf_hist")]:
        r = xla_checks[f"{run}_{name}"]
        rounds = ROUNDS if run == "a" else XLA_CSR_ROUNDS
        row = {"name": name if run == "a" else f"{name}[bundled]",
               "route": "cuda", "source": SOURCES[name],
               "replaces": LIST_REPLACES[name],
               "launches": xla_launches[run][name],
               "launches_per_tree": xla_launches[run][name] / rounds,
               "cuda_launches": kernel_cuda_launches(
                   name, xla_launches[run]["cuda"]),
               "operands": f"phase 14 run {run}, step {r['step']}",
               "max_abs_err": r["max_abs_err"], "tol": r["tol"],
               "ms": r["kernel_ms"], "ms_repeat": r["kernel_ms_repeat"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "library_call": r["library_call"],
               "xla_train_launches": {run: v[name]
                                      for run, v in xla_launches.items()}}
        if run == "a":      # phase 16 runs the list kernels on logical columns
            row["dist_train_launches_per_rank"] = {
                d_run: [v.get(name, 0) for v in per_rank]
                for d_run, per_rank in dist_launches.items()}
        if name == "leaf_partition":
            row.update(segment_rows=r["segment_rows"],
                       restore_ms=r["restore_ms"])
        else:
            row.update({k: r[k] for k in (
                "listed_rows", "Fp", "Bk", "grid", "rel_err_of_abs_sum",
                "five_kernel_hist_pass_ms", "root_leaf_hist_ms",
                "root_hist_pass_ms")})
        rows.append(row)
    # the kernels on bundle columns: each phase-11 run's own operands
    # (check_captured) with that run's launches; phase 2's widest synthetic
    # layout, which no run reaches, with none
    for run, res in bundle_checks.items():
        for kernel in ("level_pass", "route_pass", "epilogue_pass"):
            if kernel not in res or (kernel == "route_pass" and run != "a"):
                continue
            rows.append(bundled_row(
                kernel, res, bundle_launches[run][kernel],
                f"phase 11 run {run}, on its own operands"))
    wide = bundled[max(BUNDLE_WIDTHS)]
    for kernel in ("level_pass", "route_pass", "epilogue_pass"):
        rows.append(bundled_row(kernel, wide, 0, "none (phase 2 only)"))
    # the kernels on each phase-12 run's own operands, with its launches
    for run, res in mono_checks.items():
        for kernel in ("level_pass", "route_pass", "epilogue_pass"):
            if kernel in res:
                rows.append(bundled_row(
                    kernel, res, mono_launches[run][kernel],
                    f"phase 12 run {run}, on its own operands",
                    tag="mono"))
    # the kernels on phase 13a's own operands (DART), with its launches
    for kernel in ("level_pass", "route_pass"):
        if kernel in slice_check:
            rows.append(bundled_row(
                kernel, slice_check, slice_launches["a"][kernel],
                "phase 13 run a, on its own operands", tag="dart"))
    # the variants at Sp=64 on the mixed layout, each with the launches of
    # the phase-6 run that takes it on every level_pass (VARIANT_RUNS); the
    # packed route_pass with run (b)'s
    variant_rows = [("level_pass", v, run, "level_pass:" + v)
                    for v, run in VARIANT_RUNS.items()]
    variant_rows.append(("route_pass", "quant16+packed+fmask", "b",
                         "route_pass:packed"))
    for kernel, check, run, counter in variant_rows:
        r = plane_main[check][kernel]
        n = plane_launches[run].get(counter, 0)
        if n <= 0 or n != plane_launches[run][kernel]:
            raise AssertionError(f"run ({run}) launched {kernel} "
                                 f"{plane_launches[run][kernel]} times, "
                                 f"{n} of them as {counter}")
        name = kernel + "[" + counter.split(":")[1] + "]"
        run_cuda = {k[5:]: v for k, v in plane_launches[run].items()
                    if k.startswith("cuda:")}
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                     "launches": n,
                     "cuda_launches": kernel_cuda_launches(kernel, run_cuda),
                     "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    # predict_pass (phase 15): each variant on its phase's own operands
    rows.extend(serve_rows)
    emit({"phase": "timing", "ms": "device time per launch: a CUDA graph "
          "of 20 wrapper calls replayed 5 times between two events, "
          "median", "plain_ms": "median of 20 (3 for the plain level, route, "
          "epilogue and hist passes) one-call event pairs, host included",
          "not_captured": timing_notes})
    emit({"kernels": rows})
    emit({"phase": "done", "smoke_s": time.perf_counter() - t_start})

    # ---- 18. the result line
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
