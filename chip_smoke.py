#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mallorn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its wall time on its own line:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: every CUDA source of the port, with plain ``nvcc``;
3. kernel checks: the Cholesky-inverse kernel (K2) against its plain
   PyTorch version (float32 and float64), two launches bit for bit equal:
   the blocked kernel (T <= 320) at B=2048, T=64/128/160/184/192/240/256/
   288/320 (256 is the wide server's width), a ragged B=2047, T=72 and
   B=64, T=256/320; the cluster kernel (320 < T <= 784) at B=64,
   T=336/400/512 and the widest width of each cluster size (432, 576,
   784), at B=2048, T=400 (the XL server's width) and a ragged B=63,
   T=344; the tiled kernel beyond (T > 784) at B=8, T=800, B=64 and 512,
   T=1024 (the XXL server's width and batch) and a ragged B=63, T=1000,
   with its launches per call; a non-SPD matrix giving NaN in that matrix
   only (T=64/72/184/240/256/288/320, 400/512/784 on the cluster kernel,
   800/1024 on the tiled one), each width on its own kernel alone (launch
   counters), and times (kernel, plain, a two-call library yardstick, the
   roofline bound); one GP Adam step (``gp.batched_nll_grad``) at B=2048,
   T=64/160 split into the kernel matrix, K2, ``Linv^T Linv`` and the rest;
   the factor-only Cholesky kernel (K6, the same kernels without the
   inverse) against its plain version at B=2048, T=64/160/192/240 and B=64,
   T=256/320 (blocked), B=64, T=400/512 (cluster) and B=8, T=800 and B=64,
   T=1024 (tiled) (rtol / atol 2e-5, upper triangle exactly 0, two
   launches bit for bit equal), a non-SPD matrix giving NaN in that matrix
   only (T=64/320/400/512/800), the same dispatch by width, and its times
   (library: ``cholesky_ex``);
4. serving: the 7,124-object test split of ``.bench_data_v2.npz`` through
   ``V92dServer`` at full v92d width (5 folds x 500 trees of depth 5 over
   222 columns, random weights from a fixed seed, bin edges fitted on the
   served matrix), as 4 requests of <= 2048 objects with 100 GP steps;
   the kernel's launch count must equal the GP schedule's prediction, with
   launches at the coarse width (64) and at the server's;
5. reference: 128 of those objects through the server's feature
   families on the CPU (the kernels' plain versions) and through bin +
   forest on both devices; each column must agree within its family's
   stated gate;
6. histogram kernel checks: the depthwise level-histogram kernel (K1)
   at the fit shapes of training and of the ensemble's 25-lane members and
   every node count they use, and the leaf-wise segment-histogram kernel
   (K3) at the v114d member's shapes (25 lanes, 228 columns; the root, a
   pair of children, a pair with 70% of rows inactive, a pair with half
   its bins in the missing bin), each against its plain version (float32
   and float64, and bit for bit against its fixed-point arithmetic in
   plain PyTorch), two launches of each bit for bit equal, and times
   (kernel, plain, a one-call ``scatter_add_`` yardstick, the bound; K1's
   and K3's launch alone beside the wrapper); K3 also at its edges (1, 17, 2,443
   rows with a ragged last feature group, an all-inactive lane, NaN and
   -inf lanes beside finite ones, the segment limit); K1 also at the
   runners' fit shapes (the baseline's 5 folds x 127 columns at every node
   count of depth 6, up to 16; the seed ensemble's 50 lanes x 222 columns
   at 8 nodes) and at the policies' fit shapes (the symmetric v118 CV's 5
   folds x 224 columns and the multiclass v62 head's 5 folds x 4 classes
   = 20 lanes x 224 columns, 1-8 nodes), K3 also at the v110 CV's (5
   lanes x 224 columns, a 15-leaf step's pair); then the histogram modes'
   kernels, K5 (int8
   fixed-point digits) bit for bit equal to its plain version and K4 (bf16
   digits) bit for bit equal to its fixed-point twin and within rtol 1e-5 /
   atol 1e-4 of the float64 oracle, at every K1 shape, the ragged one and
   17 nodes,
   two launches of each bit for bit equal, with the same times, the
   launch alone on prepared digits (``kernel_only_ms``) and the distance
   from the float64 oracle (``max_abs_err_f64``); then K1's and K3's
   external-scale int64 entries (the mesh's histograms) at the v92d CV's
   shape (1, 2, 4, 8 and 64 nodes) and the v114d pair, the rows in two
   halves at one global scale: each half bit for bit its int64 twin, the
   halves adding up to the whole, the converted total bit for bit the
   float32 entry's, a NaN lane zeros, with the same times (the library
   yardstick an int64 ``scatter_add_``);
7. kernel against plain in training: a 600 x 30 fixture (NaNs, subsample
   and colsample 0.8, 20 rounds of depth 5) fitted with K1 twice and once
   with the kernel's fixed-point arithmetic in plain PyTorch, and the same
   fixture fitted leaf-wise (8 leaves) with K3 twice and once with its
   fixed-point arithmetic, then a depth-6 squarederror fit early-stopped
   on rmse at base_score 0.5 (K1 twice, its fixed-point arithmetic once)
   and a 31-leaf fit at the baseline's leaf-wise parameters (no L1 / L2,
   min_child_weight 1e-3; K3 twice, its fixed-point arithmetic once), then
   a symmetric fit (K1), a leaf-wise DART fit (K3) and a 3-class fit
   (K1, its classes as lanes), each twice with the kernel and once with
   its fixed-point arithmetic: each set of forests bit for bit equal;
8. training: the 10,178-object v92d workload of ``.bench_data_v2.npz``
   (``train_v92d``: features of both splits, the top-120 selection CV,
   assembly, adversarial weights, the 5-fold v92d CV, the threshold sweep)
   with the seconds of each stage; OOF F1 must reach 0.633 and the K1
   launch count must equal the rounds each fit ran times its depth;
   then the histogram modes: the same workload with
   ``hist_dtype="int8"`` (K5) and ``"i8bf16"`` (K4) in all three fits,
   each with its stage seconds, OOF F1 (gate 0.633) and test F1, the mode
   kernel's launches equal to rounds x depth and no K1 launch;
9. serving the trained model: the v92d winner saved with
   ``save_cv_models``, loaded back and served over the test split through
   ``V92dServer`` at that split's ``serving_config``; the served
   probabilities held against the training run's own test predictions
   of the same fold models (the GP chunk-invariance gate and a bound on
   the largest difference), the rows that flip at the OOF threshold
   counted; served again in the training run's own count-sorted GP chunks
   (one server per chunk width), where every row must agree; then a
   server built for objects of up to 256 points (the blocked K2's
   384-thread instantiation, one launch per GP step) serves the first
   request, held to the same gate; and a server built for objects of up
   to 400 points (the cluster K2, 18 launches at T = 400) serves it too,
   with its wall time and objects/s, and a server built for objects of up
   to 1,024 points (the tiled K2, 18 calls at T = 1024) serves the
   request's first 512 objects, held to the same gate;
10. the shipped Kaggle ensemble (``train_kaggle_ensemble``: the training
   phase's features and selection, the research family of both splits,
   adversarial weights, v92d, v34a and the leaf-wise v114d at 5 seeds x 5
   fixed folds, the blend and its threshold sweep) with the seconds of
   each stage; ensemble OOF F1 must reach 0.637 and v114d's 0.641, K3
   launches must equal 8 x v114d's rounds and K1 launches 5 x the depthwise
   members' rounds + 3 x the adversarial rounds;
11. the runners, each once on its reference's matrix, reusing the
   training phase's features, selection, adversarial weights and winner
   and the ensemble phase's research family: ``run_baseline`` (127
   statistical columns, a depth-6 and a 31-leaf CV), ``run_v34a`` (224
   columns), and on the 222-column v92d matrix with the adversarial
   weights ``run_label_smoothing`` (eps 0.05), ``run_distillation`` (the
   winner's OOF as teacher), ``run_soft_pseudo`` and ``run_pseudo_label``
   (the winner's test probabilities), ``run_mixup`` (3 seeds),
   ``run_seed_ensemble`` (10 seeds x 5 folds, 50 lanes in one fit),
   ``run_easy_ensemble`` (10 models) and ``run_v115`` (+ 11 research
   columns), then ``ensembles.stack_oof`` over their OOFs and the
   winner's: each runner's seconds, rounds, OOF and test F1, its K1
   launches equal to rounds x depth and K3 launches to 31 x the baseline's
   leaf-wise rounds (0 elsewhere), every output finite; OOF F1 gates v34a
   0.629 and the seed ensemble 0.633;
12. the other tree policies and the multiclass head, on the runners'
   224-column v34a matrix: the symmetric v118 CV, the leaf-wise v110 CV,
   its DART twin v111 (all 600 rounds), the v119 stack over the runners'
   v34a and v110 and v118 (``ensembles.stack_oof``), and v62: the train
   split regenerated with the port's generator and held column for column
   against ``.bench_data_v2.npz``, then ``run_v62`` on its spectral types
   (the 4-class head's OOF accuracy and TDE F1, the final 230-column CV):
   each run's seconds, rounds, OOF and test F1 (ungated), K1 launches equal
   to rounds x depth (v118, both v62 CVs) and K3 launches to 15 x rounds
   (v110, v111), every output finite;
13. the families and the training tools, reusing the training phase's
   splits, features, selection, adversarial weights and winner, the
   ensemble's blend and the runners' v34a: the four Levenberg-Marquardt
   families (powerlaw, tde_models' hybrid model, blackbody,
   advanced_physics) extracted on both splits (seconds, columns, finite
   share) and held against the CPU on the first 128 test objects (NaN
   lanes identical, the closed-form columns at features_v4's gate, the
   fits by Bazin's bar on their cost); the command line's backbone-plus-
   family experiments v55, v64, v30, v57 (dereddened twins), v45
   (categorical bins) and v105 (the top 30 interactions) on the 224-column
   v34a matrix, K1 launches = rounds x depth; an 8-trial TPE search on the
   v92d matrix (each trial's seconds, rounds and K1 launches), then depth
   8 with and without subtraction (K1 at 64 and 128 nodes, rounds x depth
   launches; the forests' differing split slots counted) and depth-8
   single fits bit for bit K1's fixed-point twin; Platt and isotonic
   calibration (test Brier score), threshold variants, the error analysis
   and the prediction agreement of v92d, v34a and the ensemble; SMOTE and
   ADASYN at ratio 0.5, every synthetic row on a minority segment. The
   kernel phase also checks K1 at depth 8's 64 and 128 nodes (two and
   three chunks of nodes on the grid's z axis);
14. families 2, reusing the training phase's splits and the runners' v34a
   matrix: the twelve remaining families (gp1d, whose 150 Adam steps and
   final NLL run K2 at the band view's width, dtw against templates built
   once from the train split, advanced, cesium, high_snr, fourier, fwhm,
   temp_fwhm, peak_ordering, powerlaw_ratio, enhanced_colors,
   time_to_decline) extracted on both splits in chunks of 2,048 objects
   (seconds, columns, finite share), gp1d's K2 launches equal to chunks x
   151 at each split's width, the first 128 test objects held against the
   CPU (names and NaN lanes identical, the closed-form columns and DTW's
   distances at features_v4's gate, DTW's warp fractions equal on >= 98%
   of lanes, gp1d at multiband_gp's gate); the command line's experiments
   v9, v20, v35, v40, v47, v48, v56, v58, v59b, v65 and v66 (the family's
   columns on the 224-column v34a matrix, ``train_cv`` at V34A_PARAMS cut
   to 250 rounds; K1 launches = rounds x depth); ``augment_dataset`` over one copy of the
   train split on the card and on the CPU (masks equal, times, fluxes and
   errors within rtol 1e-5) and the transforms' invariants on the card.
   The kernel phase also checks K2 at gp1d's shapes (B = 12,288 and
   12,287 at T = 40, B = 12,288 at T = 48);
15. the DL models, reusing the training phase's splits and the runners'
   v34a matrix: the sequence models v10 (LSTM), v13 (transformer), v22
   (ATAT, its tabular tower on the standardised 224 columns) and v27
   (band-parallel GRU) at their default widths for the command line's 100
   epochs on the train split's stratified 80/20 holdout, then a forward of
   the test split (each model's seconds, ms per epoch, first and last
   loss, validation F1 and threshold, test F1 and peak memory; losses
   finite and falling, probabilities finite); v14's 5-fold residual MLP
   (150 AdamW steps a fold) on the 224 columns; astromer's 146 columns of
   both splits (4 bands x 10,178 objects through the pretrained encoder,
   one batched forward per split), the first 128 test objects held
   against the CPU (names and NaN lanes identical, columns at
   features_v4's gate), then v26 (the columns on the 224-column matrix,
   ``train_cv`` at V34A_PARAMS; K1 launches = rounds x depth); and
   masked-reconstruction pretraining at the artifact's configuration
   (d 48, 2 layers, batch 256) on the train split's bands, whose loss must
   fall;
16. the command line (``mallorn_tpu_torch.cli.main``, in-process, on a
   temporary workspace): the bench split written in the reference's CSV
   layout (20 shards per split) and read back through the native parser,
   its packed tensors and metadata bit for bit ``load_split``'s (write and
   read seconds, rows per second); ``extract`` of the v92d families at 100
   GP steps (K2 launches = the GP schedule's prediction); ``train --config
   v92`` (the selection CV, adversarial weights, all four variants; v92a-c
   F1s printed ungated, v92d's gated at 0.633) and ``train --config v34a``
   (the cached selection; gate 0.629), K1 launches = rounds x depth of
   every fit; ``predict`` from the saved v92d models, its submission equal
   to train's on every row farther than 1e-4 from the threshold, then once
   more under ``utils.profiling.device_trace`` (one Chrome trace holding
   CUDA kernels, the same probabilities; kernel time printed); each
   command's seconds;
17. the mesh (``mallorn_tpu_torch.parallel``), reusing the training
   phase's bundles, selection and adversarial weights and the command
   line phase's workspace: (a) ``run_v92`` on a world-size-1 NCCL mesh in
   this process, its v92d forests bit for bit the training phase's, K1's
   external-scale entry launched rounds x depth times and the float32
   entry never; (b) two gloo ranks both on this card (collectives through
   pinned host memory): the v92d CV at 50 rounds and a v114d leaf-wise CV
   at 10 against their single-device fits (features and split bins equal,
   leaf values within rtol 2e-4 / atol 2e-5, eval history within rtol
   1e-4, best iterations equal; whether every forest is also bit for bit
   printed), each rank's K1 / K3 launches (rounds x depth, 8 x rounds) and
   int64 bytes all-reduced per round; (c) the train split's v34a families
   extracted with the objects split over the two ranks, against the
   training phase's bundle (rtol 2e-4 / atol 1e-5, Bazin >= 85% of lanes),
   K2 launches per rank; (d) ``train --config v34a --mesh 1`` (one NCCL
   rank) in the command line's workspace, its result JSON equal to that
   phase's, and ``--mesh`` beyond the card count refused.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
``mallorn_tpu_torch`` package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import (Metadata, pack_lightcurves, pad_time_axes,
                                            unify_time_padding)
from mallorn_tpu_torch.data.synthetic import generate_dataset
from mallorn_tpu_torch.data import augmentation
from mallorn_tpu_torch.features import (advanced, advanced_physics, astromer, blackbody,
                                         cesium, dtw,
                                         enhanced_colors, fourier, fwhm, gp1d, high_snr,
                                         multiband_gp, peak_ordering, powerlaw, powerlaw_ratio,
                                         tde_models, temp_fwhm, time_to_decline)
from mallorn_tpu_torch.features.categorical import add_categorical_features
from mallorn_tpu_torch.features.extinction import dered_matrix
from mallorn_tpu_torch.features.interactions import (create_physics_interactions,
                                                     select_top_interactions)
from mallorn_tpu_torch.models.astromer import BandSequences, normalize_band, pretrain
from mallorn_tpu_torch.io.model_store import (GBDTModel, forest_from_numpy, load_cv_models,
                                              save_cv_models)
from mallorn_tpu_torch.ops import chol_cuda, gp, hist_cuda
from mallorn_tpu_torch.features.base import chunked_extract, feature_matrix, merge
from mallorn_tpu_torch.serving import (SHIFT_FEATURES, V92dServer,
                                       assemble_v34a_matrix, drop_shift_features,
                                       extract_bundle)
from mallorn_tpu_torch.train import analysis, calibration, hpo, oversample
from mallorn_tpu_torch.train.adversarial import ADV_PARAMS
from mallorn_tpu_torch.train.cv import f1_score, threshold_sweep, train_cv
from mallorn_tpu_torch.train.ensembles import stack_oof
from mallorn_tpu_torch.train.pipelines import (BASELINE_LGBM_PARAMS, BASELINE_PARAMS,
                                               KAGGLE_ENSEMBLE_WEIGHTS, SOFT_LABEL_PARAMS,
                                               V62_MC_PARAMS, V110_PARAMS, V111_PARAMS,
                                               V114D_PARAMS, V118_PARAMS, DL_CONFIGS,
                                               _finite_or_nan, finite_or_nan,
                                               run_baseline, run_distillation, run_dl_model,
                                               run_easy_ensemble, run_label_smoothing,
                                               run_mixup, run_pseudo_label,
                                               run_seed_ensemble, run_soft_pseudo, run_v34a,
                                               run_v14, run_v26, run_v62, run_v115,
                                               simplify_spectype,
                                               train_kaggle_ensemble, train_v92d)
from mallorn_tpu_torch.trees import objectives
from mallorn_tpu_torch.trees.binning import fit_bins
from mallorn_tpu_torch.trees.gbdt import (V34A_PARAMS, GBDTParams, predict_margin_models,
                                          train_gbdt)
from mallorn_tpu_torch.utils import cuda_build, prng
from mallorn_tpu_torch.utils.constants import LSST_BANDS, WAVELENGTHS_A

ROOT = Path(__file__).resolve().parent
DATA = ROOT / ".bench_data_v2.npz"
WATCHDOG_S = 1100  # a hang dumps its stack and exits non-zero

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_FOLDS, N_TREES, DEPTH, N_COLS, N_SELECTED = 5, 500, 5, 222, 120
GP_STEPS = 100
REQUEST = 2048  # objects per served request
SEED = 92

# tolerances: the JAX package's own bars for this kernel
# (tests/test_chol_pallas.py), |a - b| <= atol + rtol |b| elementwise
TOL = {"linv": (5e-5, 5e-5), "logdet": (1e-5, 1e-4), "kinv": (1e-4, 1e-5),
       "alpha": (1e-4, 1e-4)}

# the level histogram (K1): the JAX package's bar for its histogram
# kernels (tests/test_hist_pallas.py:56), rtol / atol
HIST_TOL = (1e-5, 1e-4)
N_BINS_TOT = V34A_PARAMS.n_bins + 1
# training's fit shapes, all 5 folds in one launch: (fit, K, F, N padded
# fold rows, node counts of the levels built with subtraction)
HIST_SHAPES = (("selection", 5, 307, 2444, (1, 1, 2, 4, 8)),
               ("adversarial", 5, 222, 8143, (1, 1, 2)),
               ("v92d", 5, 222, 2444, (1, 1, 2, 4, 8)),
               ("kaggle", 25, 224, 2444, (1, 1, 2, 4, 8)))
# K1 at the runners' new fit shapes: the baseline's depth-6 CV on the 127
# statistical columns (every node count a depth-6 level builds with
# subtraction) and the seed ensemble's 10 seeds x 5 folds on the v92d
# columns at its deepest level
RUNNER_HIST_SHAPES = (("baseline", 5, 127, 2444, (1, 1, 2, 4, 8, 16)),
                      ("seed_ensemble", 50, 222, 2444, (8,)))
# K1 at the policies' fit shapes: the symmetric v118 CV (5 folds, the 224
# v34a columns) and the multiclass v62 head (5 folds x 4 classes as 20
# lanes), every node count a depth-5 level builds with subtraction; K3 at
# the 15-leaf v110 / v111 CVs' pair of children (5 lanes, 224 columns)
POLICY_HIST_SHAPES = (("symmetric", 5, 224, 2444, (1, 1, 2, 4, 8)),
                      ("multiclass", 20, 224, 2444, (1, 1, 2, 4, 8)))
POLICY_SEG_SHAPE = ("v110_pair", 5, 224, 2444, 2)
# K1 at depth 8, the top of HPO's space, on the v92d matrix: the last
# level's 64 nodes (subtraction) and 128 (none), two and three chunks of
# nodes on the grid's z axis
FAMILY_HIST_SHAPES = (("depth8", 5, 222, 2444, (64, 128)),)
# the bench split's generator call (bench.py): its train split regenerated
# gives v62 the spectral types the npz does not store
BENCH_SPLITS = dict(n_train=3054, seed=20260816, tde_frac=0.05)
# the leaf-wise v114d member's K3 calls: 25 lanes, 222 + 6 columns, the
# padded fold rows; (name, rows, nodes, share of rows inactive, share of
# (row, feature) bins moved to the missing bin): the root, a pair of
# children, a pair with 70% of rows inactive, a pair whose features miss
# half their rows (atomics crowding one cell)
SEG_LANES, SEG_F, SEG_SHAPES = 25, 228, (("root", 2444, 1, 0.0, 0.0),
                                         ("pair", 2444, 2, 0.0, 0.0),
                                         ("ragged", 2443, 2, 0.7, 0.0),
                                         ("crowded", 2444, 2, 0.0, 0.5))
# OOF F1 gate: the JAX package's lowest recorded OOF F1 on this data
# (0.6702) less the reference's fold-F1 std (0.0375)
F1_GATE = 0.633
# the ensemble's gates: the JAX package's full-scale run
# (tools/probe_kaggle_scale.json: ensemble 0.6743, v114d 0.6781) less the
# same fold-F1 std
ENSEMBLE_F1_GATE, V114D_F1_GATE = 0.637, 0.641
# the runners' gates: v34a, the reference's own v34a OOF F1 (0.6667,
# BASELINE.md:20) less the same std; the seed ensemble, v92d's model
# averaged over 10 fold seeds, takes v92d's gate
V34A_F1_GATE, SEED_ENSEMBLE_F1_GATE = 0.629, F1_GATE
# a served probability agrees with the training run's when within rtol
# 1e-4 (atol 1e-4 of the largest); at least this share must (the GP
# chunk-invariance gate of tests/test_torch_gp.py), and no row may differ
# by more than SERVE_MAX_DP (the largest difference read on an H100 was
# 0.093). Served in the training run's own GP chunks, every row must agree.
SERVE_RTOL, SERVE_SHARE, SERVE_MAX_DP = 1e-4, 0.97, 0.15
WIDE_T = 256  # the wide server's GP width (> 240: K2's 384-thread instantiation)
XL_T = 400  # the XL server's GP width (> 320: K2's cluster kernel, 2 CTAs per matrix)
# the XXL server's GP width (> 784: K2's tiled kernel) and the objects it
# serves (one [512, 1024, 1024] float32 tensor is 2 GiB)
XXL_T, XXL_OBJECTS = 1024, 512
# the factor-only Cholesky (K6): the bars of tests/test_chol_pallas.py:19
CHOL_TOL = (2e-5, 2e-5)
# the histogram modes run through the training path, in this order, and
# the kernel each runs: (row name, launch counter, wrapper, plain version
# with the kernel's arithmetic, equal to it bit for bit)
MODES = ("int8", "i8bf16")
MODE_KERNELS = {
    "int8": ("hist_i8", "i8_launches", hist_cuda.build_histograms_i8,
             hist_cuda.build_histograms_i8_plain),
    "i8bf16": ("hist_bf16", "bf16_launches", hist_cuda.build_histograms_bf16,
               hist_cuda.build_histograms_bf16_fixed),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        log(f"== phase {self.name}: {time.perf_counter() - self.t0:.3f} s")
        return False


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit (NaN included)."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def close(a, b, rtol, atol):
    """(max |a-b|, max |a-b|/max|b|, within tolerance) over finite b."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    ok = bool((d <= atol + rtol * b.abs()).all())
    return d.max().item(), (d.max() / b.abs().max().clamp(min=1e-30)).item(), ok


def spd_batch(B: int, T: int, seed: int) -> torch.Tensor:
    """Seeded SPD [B, T, T] float64 (A A^T / T + I) with the last 0..T/4
    rows and columns of each matrix identity-padded, as the GP's masks do."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, T, T, generator=g, device="cuda", dtype=torch.float64)
    K = A @ A.transpose(1, 2) / T + torch.eye(T, device="cuda", dtype=torch.float64)
    n_pad = torch.randint(0, T // 4 + 1, (B,), generator=g, device="cuda")
    keep = torch.arange(T, device="cuda")[None, :] < (T - n_pad)[:, None]
    mm = keep[:, :, None] & keep[:, None, :]
    eye = torch.eye(T, device="cuda", dtype=torch.float64).expand(B, T, T)
    return torch.where(mm, K, eye)


def check_kernel(B: int, T: int, seed: int) -> dict:
    K64 = spd_batch(B, T, seed)
    K = K64.float().contiguous()
    r = torch.randn(B, T, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                    device="cuda", dtype=torch.float32)
    Linv, ld = chol_cuda.chol_inv(K)
    Linv2, ld2 = chol_cuda.chol_inv(K)
    Linv5, ld5 = chol_cuda.chol_inv(K[:5].contiguous())  # a matrix's result is B's alone
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(Linv, Linv2) and torch.equal(ld, ld2)
                        and bits_equal(Linv5, Linv[:5]) and bits_equal(ld5, ld[:5]))
    Lp, ldp = chol_cuda.chol_inv_plain(K)
    L64, ld64 = chol_cuda.chol_inv_plain(K.double())
    Kinv = torch.matmul(Linv.transpose(1, 2), Linv)
    Kinv64 = torch.matmul(L64.transpose(1, 2), L64)
    alpha = torch.matmul(Kinv, r.unsqueeze(-1)).squeeze(-1)
    alpha64 = torch.matmul(Kinv64, r.double().unsqueeze(-1)).squeeze(-1)
    rows = {
        "linv_vs_plain": close(Linv, Lp, *TOL["linv"]),
        "linv_vs_f64": close(Linv, L64, *TOL["linv"]),
        "logdet_vs_plain": close(ld, ldp, *TOL["logdet"]),
        "logdet_vs_f64": close(ld, ld64, *TOL["logdet"]),
        "kinv_vs_f64": close(Kinv, Kinv64, *TOL["kinv"]),
        "alpha_vs_f64": close(alpha, alpha64, *TOL["alpha"]),
    }
    for name, (abs_e, rel_e, ok) in rows.items():
        tol = TOL[name.split("_")[0]]
        log(f"  B={B} T={T} {name}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={tol[0]:g}, atol={tol[1]:g}) {'ok' if ok else 'FAIL'}")
    log(f"  B={B} T={T} two launches bit for bit equal, and equal to a launch on the first 5 "
        f"matrices alone: {repeat_equal}")
    bad = [n for n, (_, _, ok) in rows.items() if not ok]
    if bad or not repeat_equal:
        raise AssertionError(f"chol_inv B={B} T={T} outside tolerance {bad} or not "
                             f"repeatable")

    eye = torch.eye(T, device="cuda").expand(B, T, T)

    def library():
        L, _ = torch.linalg.cholesky_ex(K)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        return Li, 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)

    ms = cuda_ms(lambda: chol_cuda.chol_inv(K), reps=20)
    plain_ms = cuda_ms(lambda: chol_cuda.chol_inv_plain(K), reps=2, warmup=1)
    library_ms = cuda_ms(library, reps=10)
    # K's lower triangle in (all the kernel reads), Linv and logdet out
    n_bytes = B * (T * (T + 1) // 2 + T * T) * 4 + B * 4
    n_flop = B * 2.0 * T ** 3 / 3.0  # Cholesky T^3/3 + triangular inverse T^3/3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / F32_FLOP_PER_S * 1e3
    res = {"B": B, "T": T, "max_abs_err": rows["linv_vs_plain"][0], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_flop),
           "bound_by": "bytes" if t_bytes >= t_flop else "operations"}
    log(f"  B={B} T={T} times: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (cholesky_ex + solve_triangular against I: "
        f"a two-call yardstick the port never calls) bound_ms={res['bound_ms']:.4f} "
        f"({res['bound_by']}: {n_bytes / 1e6:.1f} MB, {n_flop / 1e9:.2f} GFLOP)")
    return res


def check_non_spd(T: int = 64) -> None:
    K = spd_batch(4, T, 7).float()
    K[1, 10, 10] = -1.0
    Linv, ld = chol_cuda.chol_inv(K.contiguous())
    torch.cuda.synchronize()
    Lp, ldp = chol_cuda.chol_inv_plain(K)
    nan_k = torch.isnan(ld).tolist()
    nan_linv = torch.isnan(Linv).flatten(1).any(dim=1).tolist()
    log(f"  T={T} non-SPD matrix 1 of 4: logdet={ld.tolist()} matrices of Linv with "
        f"NaN: {nan_linv}")
    if nan_k != [False, True, False, False] or nan_linv != nan_k:
        raise AssertionError("a non-positive pivot must give NaN in that matrix only")
    if torch.isnan(ldp).tolist() != nan_k:
        raise AssertionError("plain version disagrees on the NaN lanes")


def time_gp_step(B: int, T: int, seed: int) -> None:
    """One GP Adam step (``gp.batched_nll_grad``) at [B, T] split into its
    parts, each timed alone on the same inputs: the kernel matrix
    (``_masked_kernel``), K2 on it, ``Linv^T Linv``, and the rest (alpha, W
    and the four gradient reductions) as the difference. Inputs are the
    phase-1 initial state of seeded lightcurves, 3/4 to all of the T points
    valid."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_valid = torch.randint(3 * T // 4, T + 1, (B, 1), generator=g, device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] < n_valid
    t = torch.sort(torch.rand(B, T, generator=g, device="cuda") * 300.0, dim=1).values
    bands = torch.randint(0, len(WAVELENGTHS_A), (B, T), generator=g, device="cuda")
    lam = torch.tensor(WAVELENGTHS_A, device="cuda")[bands]
    y = torch.randn(B, T, generator=g, device="cuda")
    yerr = 0.05 + 0.2 * torch.rand(B, T, generator=g, device="cuda")
    params = torch.stack([torch.zeros(B, device="cuda"), torch.zeros(B, device="cuda"),
                          torch.full((B,), 2.0 * math.log(100.0), device="cuda"),
                          torch.full((B,), 2.0 * math.log(6000.0), device="cuda")], dim=1)
    dt2 = (t[:, :, None] - t[:, None, :]) ** 2
    dl2 = (lam[:, :, None] - lam[:, None, :]) ** 2
    args = (params, dt2, dl2, y, yerr, mask)
    K = gp._masked_kernel(params, dt2, dl2, mask, yerr, True)[1]
    Linv, _ = chol_cuda.chol_inv(K)
    res = {"step_ms": cuda_ms(lambda: gp.batched_nll_grad(*args), reps=10),
           "kernel_matrix_ms": cuda_ms(
               lambda: gp._masked_kernel(params, dt2, dl2, mask, yerr, True), reps=10),
           "k2_ms": cuda_ms(lambda: chol_cuda.chol_inv(K), reps=10),
           "kinv_matmul_ms": cuda_ms(lambda: torch.matmul(Linv.transpose(1, 2), Linv),
                                     reps=10)}
    res["rest_ms"] = (res["step_ms"] - res["kernel_matrix_ms"] - res["k2_ms"]
                      - res["kinv_matmul_ms"])
    log(f"  GP Adam step B={B} T={T}: step_ms={res['step_ms']:.4f} = kernel matrix "
        f"{res['kernel_matrix_ms']:.4f} + K2 {res['k2_ms']:.4f} + Linv^T Linv "
        f"{res['kinv_matmul_ms']:.4f} + the rest {res['rest_ms']:.4f} (alpha, W, the four "
        f"gradient reductions); K2 is {res['k2_ms'] / res['step_ms']:.1%} of the step")


def check_cholesky(B: int, T: int, seed: int) -> dict:
    """K6 (``chol_cuda.cholesky``) against its plain version (float32 and
    float64) at CHOL_TOL, its upper triangle exactly 0, two launches bit for
    bit equal; times (kernel, plain, ``cholesky_ex``, the bound)."""
    K = spd_batch(B, T, seed).float().contiguous()
    L = chol_cuda.cholesky(K)
    L2 = chol_cuda.cholesky(K)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(L, L2))
    upper_zero = float(torch.triu(L, 1).abs().max()) == 0.0
    rows = {"vs_plain": close(L, chol_cuda.cholesky_plain(K), *CHOL_TOL),
            "vs_f64": close(L, chol_cuda.cholesky_plain(K.double()), *CHOL_TOL)}
    tag = f"cholesky B={B} T={T}"
    for name, (abs_e, rel_e, ok) in rows.items():
        log(f"  {tag} {name}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={CHOL_TOL[0]:g}, atol={CHOL_TOL[1]:g}) {'ok' if ok else 'FAIL'}")
    log(f"  {tag} upper triangle exactly 0: {upper_zero}; two launches bit for bit "
        f"equal: {repeat_equal}")
    if not (repeat_equal and upper_zero) or not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"K6 {tag} failed its checks")

    ms = cuda_ms(lambda: chol_cuda.cholesky(K), reps=20)
    plain_ms = cuda_ms(lambda: chol_cuda.cholesky_plain(K), reps=2, warmup=1)
    library_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps=10)
    # K's lower triangle in, L out; T^3/3 flops per matrix
    n_bytes = B * (T * (T + 1) // 2 + T * T) * 4
    n_flop = B * T ** 3 / 3.0
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / F32_FLOP_PER_S * 1e3
    res = {"B": B, "T": T, "max_abs_err": rows["vs_plain"][0], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(t_bytes, t_flop),
           "bound_by": "bytes" if t_bytes >= t_flop else "operations"}
    log(f"  {tag} times: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (cholesky_ex, a yardstick the port never calls) "
        f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: {n_bytes / 1e6:.1f} MB, "
        f"{n_flop / 1e9:.2f} GFLOP)")
    return res


def check_cholesky_non_spd(T: int) -> None:
    K = spd_batch(4, T, 7).float()
    K[1, 10, 10] = -1.0
    L = chol_cuda.cholesky(K.contiguous())
    torch.cuda.synchronize()
    nan_k = torch.isnan(L).flatten(1).any(dim=1).tolist()
    plain_k = torch.isnan(chol_cuda.cholesky_plain(K)).flatten(1).any(dim=1).tolist()
    log(f"  cholesky T={T} non-SPD matrix 1 of 4: matrices with NaN {nan_k} (plain "
        f"version {plain_k})")
    if nan_k != [False, True, False, False] or plain_k != nan_k:
        raise AssertionError("K6: a non-positive pivot must give NaN in that matrix only")


def column_agreement(got: dict, want: dict, rtol: float) -> dict:
    """{column: share of its cells where the card and the CPU agree}: both
    NaN, or |a - b| <= rtol (|b| + the median |b| of the column's finite
    CPU cells)."""
    out = {}
    for k in want:
        a, b = got[k].cpu().double(), want[k].double()
        fin = b[torch.isfinite(b)].abs()
        typical = fin.median().item() if fin.numel() else 0.0
        close = (a - b).abs() <= rtol * (b.abs() + typical)
        close |= torch.isnan(a) & torch.isnan(b)
        out[k] = close.double().mean().item()
    return out


def load_test_split(device):
    with np.load(DATA, allow_pickle=False) as z:
        cols = {k: z[f"te_{k}"] for k in ("object_index", "time", "flux", "flux_err", "band")}
        n = len(z["te_object_ids"])
        zz, ebv = z["te_z"], z["te_ebv"]
    packed = pack_lightcurves(cols["object_index"], cols["time"], cols["flux"],
                              cols["flux_err"], cols["band"], n, device=device)
    return packed, zz, ebv


def requests(n: int):
    return [(s, min(s + REQUEST, n)) for s in range(0, n, REQUEST)]


def random_models(rng: np.random.Generator, X: np.ndarray, device) -> list:
    """5 v92d-shaped folds with random trees; each fold's bin edges are
    fitted (``fit_bins``) on a random 80% of the served matrix's rows."""
    n_int, n_heap = 2 ** DEPTH - 1, 2 ** (DEPTH + 1) - 1
    models = []
    for k in range(N_FOLDS):
        rows = rng.permutation(len(X))[: int(0.8 * len(X))]
        spec = fit_bins(X[rows], n_bins=V34A_PARAMS.n_bins, device=device)
        forest = forest_from_numpy(
            feature=rng.integers(0, N_COLS, (N_TREES, n_int)),
            split_bin=rng.integers(0, V34A_PARAMS.n_bins, (N_TREES, n_int)),
            default_left=rng.random((N_TREES, n_int)) < 0.5,
            is_leaf=rng.random((N_TREES, n_int)) < 0.03,
            leaf_value=rng.normal(0.0, V34A_PARAMS.learning_rate, (N_TREES, n_heap)),
            device=device)
        best = -1 if k % 2 == 0 else N_TREES - 1 - 37 * k  # early-stopped folds
        models.append(GBDTModel(forest=forest, bin_spec=spec, params=V34A_PARAMS,
                                best_iteration=best))
    return models


def expected_launches(n_objects: int, server) -> int:
    """K2 launches the GP schedule predicts for serving ``n_objects`` as the
    smoke run's requests: per request, gp_steps Adam steps + the final NLL,
    (phase 2: max(gp_steps // 6, 8) steps + its final NLL), + the predict."""
    n = server.gp_steps
    per_request = n + 1 + 1 + ((max(n // 6, 8) + 1) if server.gp_two_phase else 0)
    return per_request * len(requests(n_objects))


# (rtol, least share of each column's cells, least mean share over the
# family's columns). Closed-form families: the parity tests' rtol 1e-4 and
# the JAX package's per-column gate for them (tests/test_sharded_pipeline.py:
# 0.98; a value exactly at a threshold, such as interp_at's gap limit, can
# flip to NaN under last-digit differences). The 2D-GP (116 Adam steps) is
# an iterative fit whose float32 summation order moves some lanes: the GP
# family's gates of tests/test_torch_gp.py. Bazin's 40 LM iterations end
# on either side of a fit bifurcation for some lanes, and its cross-band
# consistency columns amplify one flipped band: its values are held at the
# JAX package's own gates for that (tests/test_sharded_pipeline.py), and
# its fits by their quality (``check_bazin_fit_quality``).
GATES = {"features_v4": (1e-4, 0.98, 0.98), "tde_physics": (1e-4, 0.98, 0.98),
         "multiband_gp": (2e-3, 0.90, 0.97), "bazin": (1e-3, 0.60, 0.90)}


def check_bazin_fit_quality(got: dict, want: dict) -> None:
    """The card's Bazin fits are as good as the CPU's, by the bar the port's
    parity test holds them to against the JAX package
    (tests/test_torch_features.py): per band, on >= 98% of the lanes the
    CPU fitted, the card's reduced chi^2 <= 1.05 x the CPU's + 0.5; the
    median ratio over all bands within [0.99, 1.01]."""
    ratios = []
    for band in LSST_BANDS:
        a = want[f"{band}_bazin_fit_chi2"].double()
        b = got[f"{band}_bazin_fit_chi2"].cpu().double()
        fit = torch.isfinite(a)
        share = (b[fit] <= a[fit] * 1.05 + 0.5).double().mean().item() if bool(fit.any()) else 1.0
        ratios.append(b[fit] / a[fit].clamp(min=1e-9))
        log(f"  bazin {band}: {int(fit.sum())} fitted lanes, {share:.4f} with the "
            f"card's chi^2 <= 1.05 x the CPU's + 0.5 (needs 0.98)")
        if share < 0.98:
            raise AssertionError(f"Bazin fits on the card are worse than the CPU's in {band}")
    med = torch.cat(ratios).median().item()
    log(f"  bazin: median chi^2 ratio card / CPU {med:.5f} (needs 0.99..1.01)")
    if not 0.99 <= med <= 1.01:
        raise AssertionError("Bazin fit quality on the card differs from the CPU's")


def reference_check(server, models, names, selected, packed, zz, ebv, m=128):
    """``m`` served objects through the server's feature families on the
    card and on the CPU (the kernels' plain versions), each column held
    to its family's gate (``GATES``), then the card's matrix through bin +
    forest on both devices."""
    cpu_server = V92dServer(models, names, selected, gp_steps=server.gp_steps,
                            gp_t_compact=server.gp_t_compact,
                            gp_two_phase=server.gp_two_phase, device="cpu")
    sub = packed.map(lambda x: x[:m])
    got_b = server.bundle(sub, zz[:m], ebv[:m])
    want_b = cpu_server.bundle(sub.to("cpu"), zz[:m], ebv[:m])
    for fam, (rtol, col_need, mean_need) in GATES.items():
        got, want = got_b[fam], want_b[fam]
        fracs = column_agreement(got, want, rtol)
        worst = sorted(fracs, key=fracs.get)[:3]
        mean = float(np.mean(list(fracs.values())))
        log(f"  {fam}: {len(fracs)} columns, mean {mean:.4f} of cells within "
            f"rtol {rtol:g} of the CPU (needs {mean_need:g}); worst columns "
            + ", ".join(f"{k} {fracs[k]:.4f}" for k in worst)
            + f" (each needs {col_need:g})")
        if list(got) != list(want) or fracs[worst[0]] < col_need or mean < mean_need:
            raise AssertionError(f"{fam} on the card disagrees with the CPU reference")
    check_bazin_fit_quality(got_b["bazin"], want_b["bazin"])
    # the same matrix through bin + forest on both devices
    full = merge({k: got_b["features_v4"][k] for k in selected}, got_b["tde_physics"],
                 got_b["multiband_gp"], got_b["bazin"], pandas_suffix=True)
    mat = server.matrix(full)
    bin_g = server.binned(mat)
    bin_c = cpu_server.binned(mat.cpu())
    dp = (server.predict_binned(bin_g).cpu() - cpu_server.predict_binned(bin_c)).abs()
    log(f"  bin + forest: binned matrices equal: {bool((bin_g.cpu() == bin_c).all())}; "
        f"max |p_gpu - p_cpu| {dp.max().item():.3e} (needs <= 1e-5)")
    if not bool((bin_g.cpu() == bin_c).all()) or dp.max().item() > 1e-5:
        raise AssertionError("bin + forest on the card disagrees with the CPU reference")


def hist_inputs(K: int, F: int, N: int, k_nodes: int, seed: int, inactive: float = 0.0):
    """Seeded K1 inputs: int16 bins [K, F, N] over all 257 bins, int32 node
    ids [K, N] in [0, k_nodes] (k_nodes = inactive, plus a share
    ``inactive`` of rows forced inactive), float32 (g, h) [K, N, 2] shaped
    like logistic gradients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binned = torch.randint(0, N_BINS_TOT, (K, F, N), generator=g, device="cuda").to(torch.int16)
    node_q = torch.randint(0, k_nodes + 1, (K, N), generator=g, device="cuda")
    node_q[torch.rand(K, N, generator=g, device="cuda") < inactive] = k_nodes
    p = torch.rand(K, N, generator=g, device="cuda")
    y = (torch.rand(K, N, generator=g, device="cuda") < 0.1).float()
    w = 0.5 + 1.5 * torch.rand(K, N, generator=g, device="cuda")
    gh = torch.stack([w * (p - y), w * p * (1 - p)], dim=-1).contiguous()
    return binned.contiguous(), node_q.to(torch.int32).contiguous(), gh


def check_hist(fit: str, K: int, F: int, N: int, k_nodes: int, seed: int,
               inactive: float = 0.0) -> dict:
    binned, node_q, gh = hist_inputs(K, F, N, k_nodes, seed, inactive)
    a = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
    b = hist_cuda.build_histograms(binned, node_q, gh, k_nodes, N_BINS_TOT)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(a, b))
    fixed_equal = bool(torch.equal(a, hist_cuda.build_histograms_fixed(
        binned, node_q, gh, k_nodes, N_BINS_TOT)))
    plain = hist_cuda.build_histograms_plain(binned, node_q, gh, k_nodes, N_BINS_TOT)
    f64 = hist_cuda.build_histograms_plain(binned, node_q, gh.double(), k_nodes, N_BINS_TOT)
    rows = {"vs_plain": close(a, plain, *HIST_TOL), "vs_f64": close(a, f64, *HIST_TOL)}
    tag = f"{fit} K={K} F={F} N={N} nodes={k_nodes}"
    for name, (abs_e, rel_e, ok) in rows.items():
        log(f"  {tag} {name}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={HIST_TOL[0]:g}, atol={HIST_TOL[1]:g}) {'ok' if ok else 'FAIL'}")
    log(f"  {tag} two launches bit for bit equal: {repeat_equal}; equal to its "
        f"fixed-point arithmetic in plain PyTorch: {fixed_equal}")
    if not (repeat_equal and fixed_equal) or not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"K1 {tag} failed its checks")
    # the launch alone, beside the wrapper's time (hist_times)
    chunk, n_chunks, group, tile_rows, _ = hist_cuda.hist_plan(k_nodes, N_BINS_TOT)
    out = torch.empty_like(a)
    launch_ms = cuda_ms(lambda: hist_cuda.launch_hist_kernel(binned, node_q, gh, out, k_nodes,
                                                             N_BINS_TOT), reps=50)
    torch.cuda.synchronize()
    if not bits_equal(out, a):
        raise AssertionError(f"K1 {tag}: the launch alone disagrees with the wrapper")
    log(f"  {tag} launch_ms={launch_ms:.4f} (the launch alone; G={group}, "
        f"{tile_rows}-row tiles, {n_chunks} chunk(s) of {chunk} nodes)")
    return {"fit": fit, "K": K, "F": F, "N": N, "nodes": k_nodes,
            "max_abs_err": rows["vs_plain"][0], "launch_ms": launch_ms,
            "features_per_cta": group, "tile_rows": tile_rows, "node_chunks": n_chunks,
            **hist_times(tag, hist_cuda.build_histograms, hist_cuda.build_histograms_plain,
                         binned, node_q, gh, k_nodes)}


def hist_times(tag: str, kernel, plain, binned, node_q, gh, k_nodes: int) -> dict:
    """Times of a level-histogram wrapper (K1, K4, K5) and its plain
    version, a one-call ``scatter_add_`` yardstick, and the bound."""
    K, F, N = binned.shape
    # the yardstick: one scatter_add_ over every (fold, feature, node, bin)
    # segment (the segment ids and the expanded values are set-up, untimed)
    nq = node_q.long()
    active = (nq >= 0) & (nq < k_nodes)
    n_seg = K * F * k_nodes * N_BINS_TOT
    kf = (torch.arange(K, device="cuda")[:, None] * F + torch.arange(F, device="cuda")[None, :])
    seg = (kf[:, :, None] * k_nodes + nq[:, None, :]) * N_BINS_TOT + binned.long()
    seg = torch.where(active[:, None, :], seg, n_seg).reshape(-1, 1).expand(-1, 2)
    vals = gh[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    sink = torch.zeros(n_seg + 1, 2, device="cuda")

    ms = cuda_ms(lambda: kernel(binned, node_q, gh, k_nodes, N_BINS_TOT), reps=50)
    plain_ms = cuda_ms(lambda: plain(binned, node_q, gh, k_nodes, N_BINS_TOT), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: sink.scatter_add_(0, seg, vals), reps=20)
    # bins, node ids and (g, h) in, the histograms out; two adds per active
    # (row, feature)
    n_bytes = K * F * N * 2 + K * N * 4 + K * N * 8 + K * F * k_nodes * N_BINS_TOT * 2 * 4
    n_ops = 2.0 * F * float(active.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"  {tag} times: kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (one scatter_add_, a yardstick the port never "
        f"calls) bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: "
        f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} M adds)")
    return res


def check_mode_hist(mode: str, fit: str, K: int, F: int, N: int, k_nodes: int, seed: int,
                    inactive: float = 0.0) -> dict:
    """A histogram mode's kernel (K5 for "int8", K4 for "i8bf16") at one of
    K1's shapes: bit for bit equal to its plain version (K5's plain version,
    K4's fixed-point twin), K4 also within HIST_TOL of the float64 oracle;
    two launches bit for bit equal; times, with the launch alone on
    prepared digits beside the wrapper's."""
    name, _, kernel, plain_fn = MODE_KERNELS[mode]
    int8 = mode == "int8"
    binned, node_q, gh = hist_inputs(K, F, N, k_nodes, seed, inactive)
    a = kernel(binned, node_q, gh, k_nodes, N_BINS_TOT)
    b = kernel(binned, node_q, gh, k_nodes, N_BINS_TOT)
    torch.cuda.synchronize()
    repeat_equal = bool(torch.equal(a, b))
    plain = plain_fn(binned, node_q, gh, k_nodes, N_BINS_TOT)
    plain_equal = bool(torch.equal(a, plain))
    f64 = hist_cuda.build_histograms_plain(binned, node_q, gh.double(), k_nodes, N_BINS_TOT)
    tag = f"{name} {fit} K={K} F={F} N={N} nodes={k_nodes} inactive={inactive:g}"
    vs_plain = close(a, plain, *HIST_TOL)
    vs_f64 = close(a, f64, *HIST_TOL)
    if int8:
        # the quantization's bound (hist_pallas.py:317-329): N s 2^-27
        q_bound = (N * gh.abs().amax(dim=1) * 2.0 ** -27).max().item()
        log(f"  {tag}: bit for bit equal to its plain version: {plain_equal}; vs_f64 "
            f"max_abs={vs_f64[0]:.3e} (quantization bound N s 2^-27 = {q_bound:.3e})")
        ok = plain_equal
    else:
        f32 = close(a, hist_cuda.build_histograms_bf16_plain(binned, node_q, gh, k_nodes,
                                                             N_BINS_TOT), *HIST_TOL)
        log(f"  {tag}: bit for bit equal to its fixed-point twin: {plain_equal}; vs_f64 "
            f"max_abs={vs_f64[0]:.3e} max_rel={vs_f64[1]:.3e} (rtol={HIST_TOL[0]:g}, "
            f"atol={HIST_TOL[1]:g}) {'ok' if vs_f64[2] else 'FAIL'}; vs the float32 "
            f"index_add_ version: max_abs={f32[0]:.3e}")
        ok = plain_equal and vs_f64[2]
    log(f"  {tag} two launches bit for bit equal: {repeat_equal}")
    if not (ok and repeat_equal):
        raise AssertionError(f"{name} {tag} failed its checks")
    # the launch alone, on the digits and scales the wrapper would prepare
    digits, scale = hist_cuda.launch_inputs(int8, gh)
    out = torch.empty_like(a)
    kernel_only_ms = cuda_ms(lambda: hist_cuda.launch_mode_kernel(
        int8, binned, node_q, digits, scale, out, k_nodes, N_BINS_TOT), reps=50)
    torch.cuda.synchronize()
    if not torch.equal(out, a):
        raise AssertionError(f"{name} {tag}: the launch alone disagrees with the wrapper")
    log(f"  {tag} kernel_only_ms={kernel_only_ms:.4f} (the launch on prepared digits)")
    return {"fit": fit, "K": K, "F": F, "N": N, "nodes": k_nodes,
            "max_abs_err": vs_plain[0], "max_abs_err_f64": vs_f64[0],
            "kernel_only_ms": kernel_only_ms,
            **hist_times(tag, kernel, plain_fn, binned, node_q, gh, k_nodes)}


def seg_inputs(K: int, F: int, N: int, n_nodes: int, seed: int, inactive: float = 0.0,
               missing: float = 0.0, root: bool = False):
    """K3's inputs from K1's (``hist_inputs``): segment bases node x 257
    (inactive rows at n_nodes x 257 = n_seg; every row at 0 for a tree's
    root), a share ``missing`` of (row, feature) bins moved to the missing
    bin 256."""
    binned, node_q, gh = hist_inputs(K, F, N, n_nodes, seed, inactive)
    if root:
        node_q = torch.zeros_like(node_q)
    if missing:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        binned[torch.rand(K, F, N, generator=g, device="cuda") < missing] = N_BINS_TOT - 1
    return binned, (node_q * N_BINS_TOT).contiguous(), gh


def seg_hist_holds(tag: str, binned, seg_base, gh, n_seg: int):
    """K3 twice against ``build_seg_histograms_fixed`` (bit for bit) and
    the float32 and float64 plain versions (HIST_TOL, over the lanes whose
    (g, h) are finite: the kernel makes every cell of any other lane NaN);
    raises on any failure. Returns (output, rows of (max abs, max rel,
    ok))."""
    a = hist_cuda.build_seg_histograms(binned, seg_base, gh, n_seg)
    b = hist_cuda.build_seg_histograms(binned, seg_base, gh, n_seg)
    torch.cuda.synchronize()
    repeat_equal = bits_equal(a, b)
    fixed_equal = bits_equal(a, hist_cuda.build_seg_histograms_fixed(binned, seg_base, gh, n_seg))
    plain = hist_cuda.build_seg_histograms_plain(binned, seg_base, gh, n_seg)
    f64 = hist_cuda.build_seg_histograms_plain(binned, seg_base, gh.double(), n_seg)
    lanes = torch.isfinite(gh).flatten(1).all(dim=1)
    rows = {"vs_plain": close(a[lanes], plain[lanes], *HIST_TOL),
            "vs_f64": close(a[lanes], f64[lanes], *HIST_TOL)}
    for rname, (abs_e, rel_e, ok) in rows.items():
        log(f"  {tag} {rname}: max_abs={abs_e:.3e} max_rel={rel_e:.3e} "
            f"(rtol={HIST_TOL[0]:g}, atol={HIST_TOL[1]:g}) {'ok' if ok else 'FAIL'}")
    log(f"  {tag} two launches bit for bit equal: {repeat_equal}; equal to its "
        f"fixed-point arithmetic in plain PyTorch: {fixed_equal}")
    if not (repeat_equal and fixed_equal) or not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"K3 {tag} failed its checks")
    return a, rows


def check_seg_hist(name: str, K: int, F: int, N: int, n_nodes: int, seed: int,
                   inactive: float, missing: float) -> dict:
    """K3 at one of the leaf-wise fit's shapes, held as K1 is, with the
    launch alone timed beside the wrapper."""
    binned, seg_base, gh = seg_inputs(K, F, N, n_nodes, seed, inactive, missing,
                                      root=name == "root")
    n_seg = n_nodes * N_BINS_TOT
    tag = (f"seg {name} K={K} F={F} N={N} n_seg={n_seg} inactive={inactive:g} "
           f"missing={missing:g}")
    a, rows = seg_hist_holds(tag, binned, seg_base, gh, n_seg)

    # the yardstick: one scatter_add_ over every (lane, feature, segment)
    sb = seg_base.long()
    active = sb < n_seg
    n_all = K * F * n_seg
    kf = (torch.arange(K, device="cuda")[:, None] * F + torch.arange(F, device="cuda")[None, :])
    seg = kf[:, :, None] * n_seg + sb[:, None, :] + binned.long()
    seg = torch.where(active[:, None, :], seg, n_all).reshape(-1, 1).expand(-1, 2)
    vals = gh[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    sink = torch.zeros(n_all + 1, 2, device="cuda")

    layout = hist_cuda.seg_hist_layout(n_seg)
    out = torch.empty_like(a)
    ms = cuda_ms(lambda: hist_cuda.build_seg_histograms(binned, seg_base, gh, n_seg), reps=50)
    launch_ms = cuda_ms(lambda: hist_cuda.launch_seg_kernel(binned, seg_base, gh, out, n_seg),
                        reps=50)
    torch.cuda.synchronize()
    if not bits_equal(out, a):
        raise AssertionError(f"K3 {tag}: the launch alone disagrees with the wrapper")
    plain_ms = cuda_ms(lambda: hist_cuda.build_seg_histograms_plain(binned, seg_base, gh, n_seg),
                       reps=3, warmup=1)
    library_ms = cuda_ms(lambda: sink.scatter_add_(0, seg, vals), reps=20)
    # bins, segment bases and (g, h) in, the histograms out; two adds per
    # active (row, feature)
    n_bytes = K * F * N * 2 + K * N * 4 + K * N * 8 + K * F * n_seg * 2 * 4
    n_ops = 2.0 * F * float(active.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    res = {"name": name, "K": K, "F": F, "N": N, "n_seg": n_seg,
           "max_abs_err": rows["vs_plain"][0], "ms": ms, "launch_ms": launch_ms,
           "features_per_cta": layout[0], "tile_rows": layout[1],
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"  {tag} times: kernel_ms={ms:.4f} launch_ms={launch_ms:.4f} (G={layout[0]}, "
        f"{layout[1]}-row tiles) plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} (one "
        f"scatter_add_, a yardstick the port never calls) bound_ms={res['bound_ms']:.4f} "
        f"({res['bound_by']}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} M adds)")
    return res


def check_seg_hist_edges() -> None:
    """K3 at its edges, each held by ``seg_hist_holds``: 1, 17 and 2,443
    rows with F not a multiple of the features per CTA (a ragged last
    group), an all-inactive lane, a NaN and a -inf lane beside finite
    ones, and the most segments the kernel takes."""
    G = hist_cuda.seg_hist_layout(2 * N_BINS_TOT)[0]
    for i, N in enumerate((1, 17, 2443)):
        binned, seg_base, gh = seg_inputs(5, 2 * G + 1, N, 2, seed=4100 + i, inactive=0.3)
        seg_hist_holds(f"seg edge N={N} F={2 * G + 1}", binned, seg_base, gh, 2 * N_BINS_TOT)
    binned, seg_base, gh = seg_inputs(5, 9, 700, 2, seed=4110)
    seg_base[1] = 2 * N_BINS_TOT
    a, _ = seg_hist_holds("seg edge lane 1 inactive", binned, seg_base, gh, 2 * N_BINS_TOT)
    if bool((a[1] != 0).any()) or not bool((a[0] != 0).any()):
        raise AssertionError("K3: an all-inactive lane is not zero")
    binned, seg_base, gh = seg_inputs(5, 9, 700, 2, seed=4111)
    gh[1, 3, 0] = float("nan")
    gh[3, 699, 1] = -float("inf")
    a, _ = seg_hist_holds("seg edge NaN lane 1, -inf lane 3", binned, seg_base, gh,
                          2 * N_BINS_TOT)
    nan_lanes = [bool(torch.isnan(a[k]).all()) for k in range(5)]
    finite_lanes = [bool(torch.isfinite(a[k]).all()) for k in range(5)]
    log(f"  seg edge: all-NaN lanes {nan_lanes}, all-finite lanes {finite_lanes}")
    if nan_lanes != [False, True, False, True, False] or finite_lanes != [True, False, True,
                                                                          False, True]:
        raise AssertionError("K3: the NaN rule does not hold lane by lane")
    lim = hist_cuda.SEG_MAX_SEGMENTS
    g = torch.Generator(device="cuda").manual_seed(4112)
    binned, _, gh = seg_inputs(2, 3, 500, 1, seed=4113)
    seg_base = torch.randint(0, lim - N_BINS_TOT + 60, (2, 500), generator=g, device="cuda",
                             dtype=torch.int32)
    seg_hist_holds(f"seg edge n_seg={lim} (layout {hist_cuda.seg_hist_layout(lim)})",
                   binned, seg_base, gh, lim)


# K1's and K3's external-scale int64 entries (the mesh's histograms): K1 at
# the v92d CV's shape and every node count of its levels plus one level of
# 64 nodes (two chunks of nodes), K3 at the v114d member's pair
I64_SHAPES = (("K1", "v92d", 5, 222, 2444, (1, 2, 4, 8, 64)),
              ("K3", "v114d_pair", SEG_LANES, SEG_F, 2444, (2,)))


def check_hist_i64(kernel: str, fit: str, K: int, F: int, N: int, nodes: int,
                   seed: int) -> dict:
    """The external-scale entry of K1 (``build_histograms_i64``) or K3
    (``build_seg_histograms_i64``) at one shape, with the rows split in two
    halves that share one global scale: each half's launch bit for bit its
    int64 twin, the halves' sums adding up to the whole's launch, and the
    total converted once bit for bit the float32 entry's output on every
    row; a lane with a NaN g is zeros. Times: the wrapper, the launch alone,
    the plain twin, one int64 ``scatter_add_`` yardstick and the bound."""
    binned, node_q, gh = hist_inputs(K, F, N, nodes, seed)
    gh[K - 1, N // 3, 0] = float("nan")
    if kernel == "K1":
        ids, size, n_seg = node_q, (nodes, N_BINS_TOT), nodes * N_BINS_TOT
        entry, twin, f32 = (hist_cuda.build_histograms_i64, hist_cuda.build_histograms_i64_fixed,
                            hist_cuda.build_histograms)
    else:
        ids, size, n_seg = (node_q * N_BINS_TOT).contiguous(), (nodes * N_BINS_TOT,), nodes * N_BINS_TOT
        entry, twin, f32 = (hist_cuda.build_seg_histograms_i64,
                            hist_cuda.build_seg_histograms_i64_fixed,
                            hist_cuda.build_seg_histograms)
    halves = [slice(0, N // 2), slice(N // 2, N)]
    part = [(binned[:, :, h].contiguous(), ids[:, h].contiguous(), gh[:, h].contiguous())
            for h in halves]
    m = torch.maximum(*[hist_cuda.lane_maxabs(g) for _, _, g in part]).contiguous()
    sums = [entry(b, i, g, *size, m, N) for b, i, g in part]
    twins = [twin(b, i, g, *size, m, N) for b, i, g in part]
    whole = entry(binned, ids, gh, *size, m, N)
    torch.cuda.synchronize()
    twin_equal = all(torch.equal(a, b) for a, b in zip(sums, twins))
    adds_up = torch.equal(sums[0] + sums[1], whole)
    conv = hist_cuda.from_fixed_sums(sums[0] + sums[1], m, N)
    f32_equal = bits_equal(conv, f32(binned, ids, gh, *size))
    nan_lane = bool((whole[K - 1] == 0).all()) and bool(torch.isnan(conv[K - 1]).all())
    tag = f"{kernel} external scale {fit} K={K} F={F} N={N} " + (
        f"nodes={nodes}" if kernel == "K1" else f"n_seg={n_seg}")
    log(f"  {tag}: each half bit for bit its int64 twin {twin_equal}; the halves add up to "
        f"the whole {adds_up}; converted, bit for bit the float32 entry {f32_equal}; NaN "
        f"lane zeros {nan_lane}")
    if not (twin_equal and adds_up and f32_equal and nan_lane):
        raise AssertionError(f"{tag} failed its checks")
    out = torch.empty_like(whole)
    log2n = hist_cuda._log2_ceil(N)
    launcher = hist_cuda.launch_hist_kernel if kernel == "K1" else hist_cuda.launch_seg_kernel
    launch_ms = cuda_ms(lambda: launcher(binned, ids, gh, out, *size, m, log2n), reps=50)
    if not torch.equal(out, whole):
        raise AssertionError(f"{tag}: the launch alone disagrees with the wrapper")
    ms = cuda_ms(lambda: entry(binned, ids, gh, *size, m, N), reps=50)
    plain_ms = cuda_ms(lambda: twin(binned, ids, gh, *size, m, N), reps=3, warmup=1)
    # the yardstick: one int64 scatter_add_ of the rows' q into every (lane,
    # feature, segment) cell (q and the segment ids are set-up, untimed)
    q, _, _ = hist_cuda._fixed_point(gh, m, N)
    base = ids.long() * (N_BINS_TOT if kernel == "K1" else 1)
    active = base < n_seg
    seg = base[:, None, :] + binned.long()
    act = active[:, None, :] & (seg < n_seg)
    kf = torch.arange(K * F, device="cuda").view(K, F, 1) * n_seg
    idx = torch.where(act, kf + seg, K * F * n_seg).reshape(-1, 1).expand(-1, 2)
    vals = q[:, None, :, :].expand(K, F, N, 2).reshape(-1, 2)
    sink = torch.zeros(K * F * n_seg + 1, 2, dtype=torch.int64, device="cuda")
    library_ms = cuda_ms(lambda: sink.scatter_add_(0, idx, vals), reps=20)
    # bins, ids, (g, h) and the maxima in, the int64 sums out; two adds per
    # active (row, feature)
    n_bytes = K * F * N * 2 + K * N * 4 + K * N * 8 + K * 8 + K * F * n_seg * 2 * 8
    n_ops = 2.0 * F * float(active.sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
    res = {"kernel": kernel, "fit": fit, "K": K, "F": F, "N": N, "nodes": nodes,
           "max_abs_err": 0.0, "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"  {tag} times: kernel_ms={ms:.4f} launch_ms={launch_ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (one int64 scatter_add_, a yardstick the port never "
        f"calls) bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: {n_bytes / 1e6:.2f} MB)")
    return res


def check_training_kernel_vs_plain(device) -> None:
    """A small fit with K1 twice and once with the kernel's arithmetic in
    plain PyTorch (``build_histograms_fixed``): the three forests must be
    identical, bit for bit. The float32 plain version on the card adds with
    atomics in a varying order, so its last bits, and the exact ties they
    decide, change from run to run: its fit is reported, not held to
    identity."""
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(600, 30)).astype(np.float32)
    y = (0.8 * X[:, 3] - 0.5 * X[:, 11] + 0.5 * rng.normal(size=600) > 0.6).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    p = GBDTParams(n_rounds=20, max_depth=5, learning_rate=0.1, subsample=0.8,
                   colsample_bytree=0.8)
    spw = float((y == 0).sum() / (y == 1).sum())

    def fit(hist_fn):
        return train_gbdt(X, y, p, scale_pos_weight=spw, device=device,
                          hist_fn=hist_fn).forest

    k1 = [fit(hist_cuda.build_histograms) for _ in range(2)]
    plain = fit(hist_cuda.build_histograms_fixed)
    plain32 = fit(hist_cuda.build_histograms_plain)
    same_k1 = all(torch.equal(a, b) for a, b in zip(*k1))
    same_plain = all(torch.equal(a, b) for a, b in zip(k1[0], plain))
    n_split = int((~k1[0].is_leaf & (k1[0].split_bin >= 0)).sum())
    diff32 = int(((k1[0].feature != plain32.feature) | (k1[0].split_bin != plain32.split_bin)
                  | (k1[0].default_left != plain32.default_left)).sum())
    log(f"  600 x 30, 20 rounds, depth 5: {n_split} splits; K1 twice bit for bit equal: "
        f"{same_k1}; K1 vs its arithmetic in plain PyTorch: forests bit for bit equal "
        f"{same_plain}; float32 plain (atomic order): {diff32} of "
        f"{k1[0].feature.numel()} split slots differ")
    if not (same_k1 and same_plain):
        raise AssertionError("training with K1 and with the plain histogram disagree")

    # the same fixture leaf-wise: K3 twice and its arithmetic in plain PyTorch
    pl = p._replace(grow_policy="lossguide", max_leaves=8)

    def fit_lg(seg_fn):
        return train_gbdt(X, y, pl, scale_pos_weight=spw, device=device,
                          seg_hist_fn=seg_fn).forest

    k3 = [fit_lg(hist_cuda.build_seg_histograms) for _ in range(2)]
    plain = fit_lg(hist_cuda.build_seg_histograms_fixed)
    same_k3 = all(torch.equal(a, b) for a, b in zip(*k3))
    same_plain = all(torch.equal(a, b) for a, b in zip(k3[0], plain))
    n_split = int((~k3[0].is_leaf & (k3[0].split_bin >= 0)).sum())
    log(f"  leaf-wise, 8 leaves, depth cap 5: {n_split} splits; K3 twice bit for bit "
        f"equal: {same_k3}; K3 vs its arithmetic in plain PyTorch: forests bit for bit "
        f"equal {same_plain}")
    if not (same_k3 and same_plain):
        raise AssertionError("leaf-wise training with K3 and with its plain version disagree")

    # the runners' new fits: a depth-6 squarederror regression on soft
    # targets early-stopped on rmse at base_score 0.5 (K1 up to 16 nodes),
    # and a 31-leaf fit without L1 / L2 at min_child_weight 1e-3 (K3 at the
    # baseline's leaf-wise parameters)
    ys = np.where(y == 1, 0.95, 0.05).astype(np.float32)
    ps = SOFT_LABEL_PARAMS._replace(n_rounds=20, learning_rate=0.1)

    def fit_soft(hist_fn):
        m = train_gbdt(X[:480], ys[:480], ps, objective=objectives.squarederror,
                       X_val=X[480:], y_val=ys[480:], early_stopping_rounds=5,
                       device=device, hist_fn=hist_fn)
        return m.forest, m.best_iteration

    soft = [fit_soft(hist_cuda.build_histograms) for _ in range(2)]
    plain = fit_soft(hist_cuda.build_histograms_fixed)
    same_k1 = forests_bits_equal(soft[0][0], soft[1][0]) and soft[0][1] == soft[1][1]
    same_plain = forests_bits_equal(soft[0][0], plain[0]) and soft[0][1] == plain[1]
    n_split = int((~soft[0][0].is_leaf & (soft[0][0].split_bin >= 0)).sum())
    log(f"  squarederror / rmse, depth 6, base_score 0.5: {n_split} splits, best iteration "
        f"{soft[0][1]}; K1 twice bit for bit equal: {same_k1}; K1 vs its arithmetic in plain "
        f"PyTorch: forests bit for bit equal {same_plain}")
    if not (same_k1 and same_plain):
        raise AssertionError("the squarederror fit with K1 and with the plain histogram disagree")
    pb = BASELINE_LGBM_PARAMS._replace(n_rounds=10)

    def fit_lg31(seg_fn):
        return train_gbdt(X, y, pb, scale_pos_weight=spw, device=device,
                          seg_hist_fn=seg_fn).forest

    k3 = [fit_lg31(hist_cuda.build_seg_histograms) for _ in range(2)]
    plain = fit_lg31(hist_cuda.build_seg_histograms_fixed)
    same_k3 = forests_bits_equal(k3[0], k3[1])
    same_plain = forests_bits_equal(k3[0], plain)
    n_split = int((~k3[0].is_leaf & (k3[0].split_bin >= 0)).sum())
    log(f"  leaf-wise, 31 leaves, depth cap 6, reg_lambda 0, min_child_weight 1e-3: "
        f"{n_split} splits; K3 twice bit for bit equal: {same_k3}; K3 vs its arithmetic in "
        f"plain PyTorch: forests bit for bit equal {same_plain}")
    if not (same_k3 and same_plain):
        raise AssertionError("the 31-leaf fit with K3 and with its plain version disagree")

    # the policies' new fits: a symmetric fit (K1, one split per level), a
    # leaf-wise DART fit (K3; the scaled margins through one batched
    # product per round) and a 3-class fit (K1 over 3 class lanes)
    y3 = np.digitize(X[:, 3] - 0.5 * X[:, 11], [-0.5, 0.5]).astype(np.float32)
    fixtures = (
        ("symmetric, depth 5", p._replace(grow_policy="symmetric"), y, "hist_fn",
         hist_cuda.build_histograms, hist_cuda.build_histograms_fixed),
        ("leaf-wise DART, 8 leaves, drop rate 0.15",
         p._replace(grow_policy="lossguide", max_leaves=8, dart_rate=0.15), y, "seg_hist_fn",
         hist_cuda.build_seg_histograms, hist_cuda.build_seg_histograms_fixed),
        ("3 classes, depth 5", p._replace(num_class=3), y3, "hist_fn",
         hist_cuda.build_histograms, hist_cuda.build_histograms_fixed))
    for tag, pp, yy, arg, kernel, plain_fn in fixtures:
        def fit_p(fn):
            m = train_gbdt(X[:480], yy[:480], pp, X_val=X[480:], y_val=yy[480:],
                           early_stopping_rounds=5, device=device, **{arg: fn})
            return m.forest, m.best_iteration

        runs = [fit_p(kernel) for _ in range(2)]
        plain = fit_p(plain_fn)
        same_k = forests_bits_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
        same_plain = forests_bits_equal(runs[0][0], plain[0]) and runs[0][1] == plain[1]
        f = runs[0][0]
        n_split = int((~f.is_leaf & (f.split_bin >= 0)).sum())
        log(f"  {tag}: forest {tuple(f.feature.shape)}, {n_split} splits, best iteration "
            f"{runs[0][1]}; kernel twice bit for bit equal: {same_k}; kernel vs its "
            f"arithmetic in plain PyTorch: forests bit for bit equal {same_plain}")
        if not (same_k and same_plain):
            raise AssertionError(f"the {tag} fit with the kernel and with its plain version "
                                 f"disagree")


def forests_bits_equal(a, b) -> bool:
    """Two forests equal field by field, float fields bit for bit (NaN
    included)."""
    return all(bits_equal(u, v) if u.dtype == torch.float32 else torch.equal(u, v)
               for u, v in zip(a, b))


def load_split(tag: str, device):
    with np.load(DATA, allow_pickle=False) as z:
        cols = {k: z[f"{tag}_{k}"] for k in ("object_index", "time", "flux", "flux_err", "band")}
        meta = Metadata(object_ids=z[f"{tag}_object_ids"], z=z[f"{tag}_z"],
                        ebv=z[f"{tag}_ebv"], target=z[f"{tag}_target"])
    packed = pack_lightcurves(cols["object_index"], cols["time"], cols["flux"],
                              cols["flux_err"], cols["band"], len(meta.z), device=device)
    return packed, meta


def expected_training_chol(tr_packed, te_packed, gp_steps: int) -> int:
    """K2 launches of training's GP features: per count-sorted chunk of each
    split, gp_steps Adam steps + the final NLL (+ phase 2's steps and final
    NLL) + the predict, as ``multiband_gp.extract`` schedules them."""
    total = 0
    for packed in unify_time_padding(tr_packed, te_packed):
        counts = multiband_gp._use_mask(packed).sum(dim=1).cpu().numpy()
        two_phase, widths = multiband_gp.gp_schedule(counts, packed.all_time.shape[1],
                                                     gp_steps)
        per_chunk = gp_steps + 1 + 1 + ((max(gp_steps // 6, 8) + 1) if two_phase else 0)
        total += per_chunk * len(widths)
    return total


def run_training(device) -> dict:
    tr_packed, tr_meta = load_split("tr", device)
    te_packed, te_meta = load_split("te", device)
    log(f"train split {tr_packed.n_objects} objects ({int(tr_meta.target.sum())} TDEs), "
        f"test split {te_packed.n_objects} ({int(te_meta.target.sum())} TDEs)")
    hist_cuda.reset_launches()
    chol_cuda.reset_launches()
    out = train_v92d(tr_packed, tr_meta, te_packed, te_meta, gp_steps=GP_STEPS,
                     selection_cache=None, device=device)
    torch.cuda.synchronize()
    launches, chol_launches = hist_cuda.launches, chol_cuda.launches
    chol_by_t = dict(chol_cuda.launches_by_t)
    log("training stages (s): " + ", ".join(f"{k}={v:.3f}" for k, v in out.timings.items()))
    depth = {"selection": V34A_PARAMS.max_depth, "adversarial": ADV_PARAMS.max_depth,
             "v92d": V34A_PARAMS.max_depth}
    want = sum(out.rounds_run[k] * depth[k] for k in depth)
    log("rounds run: " + ", ".join(f"{k}={v}" for k, v in out.rounds_run.items())
        + f"; K1 launches {launches} (rounds x depth predicts {want})")
    want_chol = expected_training_chol(tr_packed, te_packed, GP_STEPS)
    log(f"chol_inv launches in training {chol_launches} (GP schedule predicts {want_chol}); "
        f"by width {chol_by_t}")
    if launches != want or launches == 0 or chol_launches != want_chol:
        raise AssertionError("training's kernel launch counts disagree with the prediction")

    adv, win = out.adversarial, out.winner
    w = adv.sample_weights
    log(f"selection: {len(out.selection.selected)} of 307 features_v4 columns; "
        f"v92d matrix {len(out.feature_names)} columns")
    log(f"adversarial AUC {adv.auc:.4f} (shift {adv.distribution_shift}), weights "
        f"[{w.min():.3f}, {w.max():.3f}] std {w.std():.3f}")
    log(f"v92d OOF F1 {win.best_f1:.4f} @ {win.best_threshold:.3f}; fold F1 "
        + ", ".join(f"{f:.4f}" for f in win.fold_f1s)
        + f"; best iterations {[m.best_iteration for m in win.models]}")
    log(f"TEST F1 under shift {out.test_f1:.4f} ({int(te_meta.target.sum())} TDEs in test)")
    oof, test = win.oof_preds, win.test_preds
    if (oof.shape != (tr_packed.n_objects,) or test.shape != (te_packed.n_objects,)
            or not (np.isfinite(oof).all() and np.isfinite(test).all())
            or min(oof.min(), test.min()) < 0 or max(oof.max(), test.max()) > 1):
        raise AssertionError("training produced malformed probabilities")
    ref = json.loads((ROOT / "REFBASE.json").read_text())["hgb_oracle"]
    d_f1 = win.best_f1 - ref["oof_f1"]
    log(f"[oracle] sklearn HGB (REFBASE.json): OOF F1={ref['oof_f1']:.4f} @ "
        f"{ref['threshold']:.3f} | ours {win.best_f1:.4f} (dF1={d_f1:+.4f}; "
        f"gate ours >= oracle-0.02: {'PASS' if d_f1 >= -0.02 else 'FAIL'})")
    log(f"OOF F1 gate: {win.best_f1:.4f} >= {F1_GATE} "
        f"{'ok' if win.best_f1 >= F1_GATE else 'FAIL'}")
    if win.best_f1 < F1_GATE:
        raise AssertionError(f"v92d OOF F1 {win.best_f1:.4f} below the gate {F1_GATE}")
    return {"launches": launches, "chol_launches": chol_launches, "oof_f1": win.best_f1,
            "total_s": out.timings["total"], "out": out, "te": (te_packed, te_meta),
            "tr": (tr_packed, tr_meta)}


def run_mode_training(mode: str, trained: dict, dev) -> dict:
    """``train_v92d`` with every fit (selection, adversarial, v92d) in the
    histogram mode ``mode``: stage seconds, OOF F1 (gate F1_GATE), test F1,
    and the mode kernel's launches, which must equal the rounds each fit ran
    times its depth, with no launch of K1 or of the other mode's kernel."""
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    name, counter, _, _ = MODE_KERNELS[mode]
    hist_cuda.reset_launches()
    out = train_v92d(tr_packed, tr_meta, te_packed, te_meta, gp_steps=GP_STEPS,
                     selection_cache=None, params=V34A_PARAMS._replace(hist_dtype=mode),
                     adv_params=ADV_PARAMS._replace(hist_dtype=mode), device=dev)
    torch.cuda.synchronize()
    counts = {c: getattr(hist_cuda, c)
              for c in ("launches", "bf16_launches", "i8_launches", "seg_launches")}
    launches = counts.pop(counter)
    log(f"[{mode}] training stages (s): "
        + ", ".join(f"{k}={v:.3f}" for k, v in out.timings.items()))
    depth = {"selection": V34A_PARAMS.max_depth, "adversarial": ADV_PARAMS.max_depth,
             "v92d": V34A_PARAMS.max_depth}
    want = sum(out.rounds_run[k] * depth[k] for k in depth)
    win = out.winner
    log(f"[{mode}] rounds run: " + ", ".join(f"{k}={v}" for k, v in out.rounds_run.items())
        + f"; {name} launches {launches} (rounds x depth predicts {want}); other "
        f"histogram kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    log(f"[{mode}] v92d OOF F1 {win.best_f1:.4f} @ {win.best_threshold:.3f}; fold F1 "
        + ", ".join(f"{f:.4f}" for f in win.fold_f1s)
        + f"; TEST F1 under shift {out.test_f1:.4f}; adversarial AUC {out.adversarial.auc:.4f}")
    if launches != want or launches == 0 or any(counts.values()):
        raise AssertionError(f"[{mode}] the histogram launch counts disagree with the prediction")
    oof, test = win.oof_preds, win.test_preds
    if (oof.shape != (tr_packed.n_objects,) or test.shape != (te_packed.n_objects,)
            or not (np.isfinite(oof).all() and np.isfinite(test).all())):
        raise AssertionError(f"[{mode}] training produced malformed probabilities")
    log(f"[{mode}] OOF F1 gate: {win.best_f1:.4f} >= {F1_GATE} "
        f"{'ok' if win.best_f1 >= F1_GATE else 'FAIL'}")
    if win.best_f1 < F1_GATE:
        raise AssertionError(f"[{mode}] v92d OOF F1 {win.best_f1:.4f} below the gate {F1_GATE}")
    return {"launches": launches, "oof_f1": win.best_f1, "total_s": out.timings["total"]}


def agreement(got: np.ndarray, want: np.ndarray) -> float:
    """Share of rows within SERVE_RTOL (atol SERVE_RTOL x max |want|)."""
    return float(np.isclose(got, want, rtol=SERVE_RTOL,
                            atol=SERVE_RTOL * np.abs(want).max()).mean())


def serve_trained(trained: dict, dev) -> dict:
    """The trained v92d winner through the model files and ``V92dServer``.

    The server averages the fold margins, then takes the sigmoid (the JAX
    flagship's forward); ``winner.test_preds`` averages the folds'
    probabilities. The served probabilities are held against the same fold
    models' margins on the training run's own test matrix, aggregated as
    the server does; the flips count against ``winner.test_preds`` at the
    OOF threshold."""
    out = trained["out"]
    te_packed, te_meta = trained["te"]
    win = out.winner
    model_dir = ROOT / "build" / "chip_smoke_v92d"
    save_cv_models(model_dir, win.models, win.best_threshold, out.feature_names)
    models, man = load_cv_models(model_dir, device=dev)
    same = all(torch.equal(a, b) for m, w in zip(models, win.models)
               for a, b in zip(m.forest, w.forest))
    log(f"model files: {man['n_folds']} folds, {len(man['feature_names'])} columns, "
        f"threshold {man['threshold']:.3f}; forests read back bit for bit equal: {same}")
    if not same or man["feature_names"] != out.feature_names:
        raise AssertionError("the saved v92d model does not read back as trained")

    # the training run's test matrix through the same fold models
    X224, names224 = assemble_v34a_matrix(out.bundles[1], out.selection.selected)
    X222, _ = drop_shift_features(names224, X224)
    ref = torch.sigmoid(predict_margin_models(models, finite_or_nan(X222)).mean(dim=0))
    ref = ref.cpu().numpy()

    n = te_packed.n_objects
    gp_tc, gp_two_phase = multiband_gp.serving_config(te_packed, GP_STEPS)
    server = V92dServer(models, man["feature_names"], out.selection.selected,
                        gp_steps=GP_STEPS, gp_t_compact=gp_tc, gp_two_phase=gp_two_phase,
                        device=dev)
    zz, ebv = te_meta.z, te_meta.ebv
    chol_cuda.reset_launches()
    hist_cuda.reset_launches()
    timings: dict = {}
    t0 = time.perf_counter()
    probs = torch.cat([server(te_packed.map(lambda x: x[s:e]), zz[s:e], ebv[s:e],
                              timings=timings) for s, e in requests(n)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p = probs.cpu().numpy()
    share = agreement(p, ref)
    thr = win.best_threshold
    flips = int(((p > thr) != (win.test_preds > thr)).sum())
    max_dp = float(np.abs(p - ref).max())
    log(f"served the trained model: {n} objects (GP width {gp_tc}, two-phase "
        f"{gp_two_phase}) in {wall:.3f} s, {n / wall:.1f} objects/s; phases (s): "
        + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()))
    log(f"  vs the training run's predictions of the same models: {share:.4f} of rows "
        f"within rtol {SERVE_RTOL:g} (needs {SERVE_SHARE}), max |dp| {max_dp:.3e} (needs "
        f"<= {SERVE_MAX_DP}); vs winner.test_preds (fold-mean probabilities): max |dp| "
        f"{np.abs(p - win.test_preds).max():.3e}, {flips} of {n} rows flip at the OOF "
        f"threshold {thr:.3f}")
    if (p.shape != (n,) or not np.isfinite(p).all() or share < SERVE_SHARE
            or max_dp > SERVE_MAX_DP):
        raise AssertionError("the served trained model disagrees with its training run")
    if chol_cuda.launches != expected_launches(n, server):
        raise AssertionError("serving's chol_inv launches disagree with the GP schedule")

    # the cause of the rows that differ: training fitted the test split's GP
    # in count-sorted chunks, each at its own width; served in those same
    # chunks (one server per chunk width), every row must agree
    te_u = unify_time_padding(trained["tr"][0], te_packed)[1]
    counts = multiband_gp._use_mask(te_u).sum(dim=1).cpu().numpy()
    two_phase, widths = multiband_gp.gp_schedule(counts, te_u.all_time.shape[1], GP_STEPS,
                                                 REQUEST)
    order = np.argsort(counts, kind="stable")
    p_ch = np.empty(n, np.float32)
    for (s, e), tc in zip(requests(n), widths):
        idx = order[s:e]
        tidx = torch.from_numpy(idx).to(dev)
        srv = V92dServer(models, man["feature_names"], out.selection.selected,
                         gp_steps=GP_STEPS, gp_t_compact=tc, gp_two_phase=two_phase,
                         device=dev)
        p_ch[idx] = srv(te_u.map(lambda x: x[tidx]), zz[idx], ebv[idx]).cpu().numpy()
    share_ch, max_ch = agreement(p_ch, ref), float(np.abs(p_ch - ref).max())
    log(f"  served in the training run's GP chunks (widths {widths}): {share_ch:.4f} of "
        f"rows within rtol {SERVE_RTOL:g} (needs 1.0), max |dp| {max_ch:.3e}")
    if share_ch < 1.0:
        raise AssertionError("served in training's chunks, the model still disagrees")

    # a server built for objects of up to WIDE_T points (the blocked K2 at
    # 384 threads), its request packed to that width
    wide = V92dServer(models, man["feature_names"], out.selection.selected,
                      gp_steps=GP_STEPS, gp_t_compact=WIDE_T, gp_two_phase=gp_two_phase,
                      device=dev)
    s, e = requests(n)[0]
    sub = te_packed.map(lambda x: x[s:e])
    sub = pad_time_axes(sub, sub.band_time.shape[-1], WIDE_T)
    chol_cuda.reset_launches()
    t0 = time.perf_counter()
    pw = wide(sub, zz[s:e], ebv[s:e]).cpu().numpy()
    wall_w = time.perf_counter() - t0
    by_t_w, large = dict(chol_cuda.launches_by_t), chol_cuda.large_launches
    n_phase2 = (max(GP_STEPS // 6, 8) + 1) if gp_two_phase else GP_STEPS + 1
    # (phase 2's) steps + final NLL, then the predict; one blocked launch each
    want_wide = n_phase2 + 1
    share_w = agreement(pw, p[s:e])
    log(f"wide server (GP width {WIDE_T}): {e - s} objects in {wall_w:.3f} s; chol_inv "
        f"launches by width {by_t_w} (predicted {want_wide} at {WIDE_T}, the rest the "
        f"coarse phase), tiled {large} (predicted 0); {share_w:.4f} of rows within "
        f"rtol {SERVE_RTOL:g} of the width-{gp_tc} server's (needs {SERVE_SHARE})")
    if (by_t_w.get(WIDE_T, 0) != want_wide or large or share_w < SERVE_SHARE
            or not np.isfinite(pw).all()):
        raise AssertionError("the wide server failed its checks")

    # a server built for objects of up to XL_T points (the cluster K2), the
    # same request packed to that width
    xl = V92dServer(models, man["feature_names"], out.selection.selected,
                    gp_steps=GP_STEPS, gp_t_compact=XL_T, gp_two_phase=gp_two_phase,
                    device=dev)
    raw = te_packed.map(lambda x: x[s:e])
    sub = pad_time_axes(raw, raw.band_time.shape[-1], XL_T)
    chol_cuda.reset_launches()
    t0 = time.perf_counter()
    px = xl(sub, zz[s:e], ebv[s:e]).cpu().numpy()
    wall_x = time.perf_counter() - t0
    cluster_x, blocked_x = dict(chol_cuda.cluster_launches_by_t), dict(chol_cuda.launches_by_t)
    large = chol_cuda.large_launches
    share_x = agreement(px, p[s:e])
    log(f"XL server (GP width {XL_T}): {e - s} objects in {wall_x:.3f} s, "
        f"{(e - s) / wall_x:.1f} objects/s")
    log(f"  XL server: cluster K2 launches by width {cluster_x} (predicted {want_wide} at "
        f"{XL_T}), blocked {blocked_x} (the coarse phase; none predicted at {XL_T}), tiled "
        f"{large} (predicted 0); {share_x:.4f} of rows within rtol {SERVE_RTOL:g} of the "
        f"width-{gp_tc} server's (needs {SERVE_SHARE})")
    if (cluster_x.get(XL_T, 0) != want_wide or blocked_x.get(XL_T, 0) or large
            or share_x < SERVE_SHARE or not np.isfinite(px).all()):
        raise AssertionError("the XL server failed its checks")

    # a server built for objects of up to XXL_T points (the tiled K2), the
    # request's first XXL_OBJECTS objects packed to that width
    xxl = V92dServer(models, man["feature_names"], out.selection.selected,
                     gp_steps=GP_STEPS, gp_t_compact=XXL_T, gp_two_phase=gp_two_phase,
                     device=dev)
    e = s + XXL_OBJECTS
    raw = te_packed.map(lambda x: x[s:e])
    sub = pad_time_axes(raw, raw.band_time.shape[-1], XXL_T)
    chol_cuda.reset_launches()
    t0 = time.perf_counter()
    pxx = xxl(sub, zz[s:e], ebv[s:e]).cpu().numpy()
    wall_xx = time.perf_counter() - t0
    tiled_xx = dict(chol_cuda.large_launches_by_t)
    other_xx = (chol_cuda.launches_by_t.get(XXL_T, 0)
                + chol_cuda.cluster_launches_by_t.get(XXL_T, 0))
    share_xx = agreement(pxx, p[s:e])
    log(f"XXL server (GP width {XXL_T}): {e - s} objects in {wall_xx:.3f} s, "
        f"{(e - s) / wall_xx:.1f} objects/s")
    log(f"  XXL server: tiled K2 calls by width {tiled_xx} (predicted {want_wide} at {XXL_T}, "
        f"{chol_cuda.tiled_plan(XXL_T)[2]} kernel launches each), blocked or cluster launches "
        f"at {XXL_T}: {other_xx} (predicted 0; blocked {dict(chol_cuda.launches_by_t)} is the "
        f"coarse phase); {share_xx:.4f} of rows within rtol {SERVE_RTOL:g} of the "
        f"width-{gp_tc} server's (needs {SERVE_SHARE})")
    if (tiled_xx != {XXL_T: want_wide} or other_xx or share_xx < SERVE_SHARE
            or not np.isfinite(pxx).all()):
        raise AssertionError("the XXL server failed its checks")
    return {"wide_launches": by_t_w[WIDE_T], "xl_launches": cluster_x[XL_T],
            "xxl_launches": tiled_xx[XXL_T], "objects_per_s": n / wall}


def run_ensemble(trained: dict, dev) -> dict:
    """``train_kaggle_ensemble`` on the training phase's features and
    selection; gates and launch counts."""
    out = trained["out"]
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    hist_cuda.reset_launches()
    chol_cuda.reset_launches()
    ens = train_kaggle_ensemble(tr_packed, tr_meta, te_packed, te_meta, gp_steps=GP_STEPS,
                                bundles=out.bundles, selected=out.selection.selected,
                                device=dev)
    torch.cuda.synchronize()
    k1, k3 = hist_cuda.launches, hist_cuda.seg_launches
    r, rr = ens.result, ens.rounds_run
    log("ensemble stages (s): " + ", ".join(f"{k}={v:.3f}" for k, v in ens.timings.items()))
    log("rounds run: " + ", ".join(f"{k}={v}" for k, v in rr.items()))
    for m, pm in r.per_model.items():
        log(f"  {m}: seed-averaged OOF F1 {pm['oof_f1']:.4f} @ {pm['threshold']:.3f}; per "
            f"seed " + ", ".join(f"{sd}:{f:.4f}" for sd, f in pm["seed_f1s"].items()))
    log(f"ensemble OOF F1 {r.oof_f1:.4f} @ {r.threshold:.3f} (weights "
        f"{KAGGLE_ENSEMBLE_WEIGHTS}); TEST F1 {ens.test_f1:.4f}; adversarial AUC "
        f"{r.adversarial.auc:.4f}")
    want_k1 = V34A_PARAMS.max_depth * (rr["v92d"] + rr["v34a"]) + ADV_PARAMS.max_depth * rr[
        "adversarial"]
    want_k3 = V114D_PARAMS.max_leaves * rr["v114d"]
    log(f"K3 launches {k3} (8 x v114d rounds predicts {want_k3}); K1 launches {k1} "
        f"(5 x depthwise rounds + 3 x adversarial rounds predicts {want_k1}); chol_inv "
        f"launches {chol_cuda.launches + chol_cuda.large_launches} (features reused)")
    if k3 != want_k3 or k3 == 0 or k1 != want_k1:
        raise AssertionError("the ensemble's kernel launch counts disagree with the prediction")
    for pm in r.per_model.values():
        if not (np.isfinite(pm["oof"]).all() and np.isfinite(pm["test"]).all()):
            raise AssertionError("the ensemble produced non-finite probabilities")
    v114d = r.per_model["v114d"]["oof_f1"]
    ref = json.loads((ROOT / "tools" / "probe_kaggle_scale.json").read_text())
    log(f"[reference] the JAX package's full-scale run: ensemble {ref['ensemble_oof_f1']} "
        f"@ {ref['threshold']}, members {ref['model_f1s']}")
    log(f"OOF F1 gates: ensemble {r.oof_f1:.4f} >= {ENSEMBLE_F1_GATE} "
        f"{'ok' if r.oof_f1 >= ENSEMBLE_F1_GATE else 'FAIL'}; v114d {v114d:.4f} >= "
        f"{V114D_F1_GATE} {'ok' if v114d >= V114D_F1_GATE else 'FAIL'}")
    if r.oof_f1 < ENSEMBLE_F1_GATE or v114d < V114D_F1_GATE:
        raise AssertionError("the ensemble's OOF F1 is below its gate")
    return {"k1": k1, "k3": k3, "total_s": ens.timings["total"], "research": ens.research,
            "test": r.ensemble_test}


def fit_rounds(models, lanes: int) -> list:
    """Rounds each batched fit of ``lanes`` consecutive models ran."""
    return [max(int(np.isfinite(m.eval_history).sum()) for m in models[i:i + lanes])
            for i in range(0, len(models), lanes)]


def run_runners(trained: dict, ensemble: dict, dev) -> dict:
    """Every other binary runner once, on its reference's own matrix and
    weights, reusing the training phase's features, selection, adversarial
    weights and winner and the ensemble phase's research family: the
    baseline (its 127 statistical columns), v34a (224 columns), and on the
    v92d matrix (222 columns, the adversarial weights) v102, v108, v97,
    v42, v106, v104 (50 lanes in one fit), v93 and v115; then stacking over
    their OOFs and the winner's. Each runner's seconds, rounds, F1s and K1 /
    K3 launches, held against rounds x depth (K1) and 31 x rounds (the
    baseline's K3); gates on v34a's and v104's OOF F1."""
    out = trained["out"]
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    y, y_te = np.asarray(tr_meta.target), np.asarray(te_meta.target)
    X224, names224 = assemble_v34a_matrix(out.bundles[0], out.selection.selected)
    X224_te, _ = assemble_v34a_matrix(out.bundles[1], out.selection.selected)
    X224, X224_te = X224.cpu().numpy(), X224_te.cpu().numpy()
    keep = [i for i, n in enumerate(names224) if n not in SHIFT_FEATURES]
    X, X_te = X224[:, keep], X224_te[:, keep]
    if [names224[i] for i in keep] != out.feature_names:
        raise AssertionError("the v92d matrix's columns differ from the training run's")
    w, win = out.adversarial.sample_weights, out.winner
    res_tr, res_te = ensemble["research"]
    d5, d6 = V34A_PARAMS.max_depth, SOFT_LABEL_PARAMS.max_depth
    L = BASELINE_LGBM_PARAMS.max_leaves

    def cv_run(cv, depth, lanes=5):
        """(OOF probabilities or margins, test ones, OOF F1, threshold, the
        rounds of each batched fit of ``lanes`` lanes, the K1 and K3
        predictions) of a CVResult."""
        rounds = fit_rounds(cv.models, lanes)
        return cv.oof_preds, cv.test_preds, cv.best_f1, cv.best_threshold, rounds, \
            depth * sum(rounds), 0

    def baseline():
        r = run_baseline(tr_packed, tr_meta, te_packed, te_meta, device=dev)
        rd, rl = r.cv.rounds_run, r.lgbm_cv.rounds_run
        log(f"  baseline: {len(r.feature_names)} columns; depthwise OOF F1 {r.oof_f1:.4f}, "
            f"leaf-wise OOF F1 {r.lgbm_cv.best_f1:.4f}; the TEST F1 below is the 50/50 "
            f"blend's at 0.5; stages (s): "
            + ", ".join(f"{k}={v:.3f}" for k, v in r.timings.items()))
        return (r.cv.oof_preds, r.blend_test_preds, r.oof_f1, 0.5, [rd, rl],
                BASELINE_PARAMS.max_depth * rd, L * rl)

    def v104():
        rr = {}
        oof, test, f1s = run_seed_ensemble(X, y, X_te, sample_weight=w, device=dev, rounds=rr)
        f1, thr = threshold_sweep(y, oof)
        log("  v104 per seed OOF F1: " + ", ".join(f"{k}:{v:.4f}" for k, v in f1s.items()))
        return oof, test, f1, thr, [rr["fit"]], d5 * rr["fit"], 0

    def v115():
        r = run_v115(X224, y, names224, res_tr, X224_te, res_te, adv=out.adversarial,
                     device=dev)
        return cv_run(r.winner, d5)

    def v42():
        cv = run_pseudo_label(X, y, X_te, win.test_preds, sample_weight=w, device=dev)
        log(f"  v42: {len(cv.oof_preds) - len(y)} pseudo-labelled test rows joined training")
        return (cv.oof_preds[:len(y)],) + cv_run(cv, d5)[1:]

    runners = {
        "baseline": baseline,
        "v34a": lambda: cv_run(run_v34a(tr_packed, tr_meta, te_packed, te_meta,
                                        bundles=out.bundles, selected=out.selection.selected,
                                        device=dev).cv, d5),
        "v102": lambda: cv_run(run_label_smoothing(X, y, X_te, epsilon=0.05, sample_weight=w,
                                                   device=dev), d6),
        "v108": lambda: cv_run(run_distillation(X, y, win.oof_preds, X_te, sample_weight=w,
                                                device=dev), d6),
        "v97": lambda: cv_run(run_soft_pseudo(X, y, X_te, win.test_preds, sample_weight=w,
                                              device=dev), d6),
        "v42": v42,
        "v106": lambda: cv_run(run_mixup(X, y, X_te, sample_weight=w, device=dev), d6),
        "v104": v104,
        "v93": lambda: cv_run(run_easy_ensemble(X, y, X_te, sample_weight=w, device=dev), d5,
                              lanes=10),
        "v115": v115,
    }
    rows, k1_all, k3_all = {}, 0, 0
    for name, fn in runners.items():
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oof, test, f1, thr, rounds, want_k1, want_k3 = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k3 = hist_cuda.launches, hist_cuda.seg_launches
        k1_all, k3_all = k1_all + k1, k3_all + k3
        test_f1 = f1_score(y_te, np.asarray(test) > thr)
        log(f"  {name}: {secs:.3f} s; rounds {rounds}; OOF F1 {f1:.4f} @ {thr:.3f}; TEST F1 "
            f"{test_f1:.4f}; K1 launches {k1} (rounds x depth predicts {want_k1}); K3 "
            f"launches {k3} (predicted {want_k3})")
        if k1 != want_k1 or k3 != want_k3 or k1 == 0:
            raise AssertionError(f"{name}: the histogram launch counts disagree with the "
                                 f"prediction")
        if (np.shape(oof) != (len(y),) or np.shape(test) != (len(y_te),)
                or not (np.isfinite(oof).all() and np.isfinite(test).all())):
            raise AssertionError(f"{name}: malformed or non-finite outputs")
        rows[name] = {"s": secs, "rounds": rounds, "oof_f1": f1, "threshold": thr,
                      "test_f1": test_f1, "k1": k1, "k3": k3, "oof": oof, "test": test}
    # v93's sweep is in-sample (its "OOF" is the training rows' own
    # prediction): it does not join the stack
    stacked = [n for n in rows if n != "v93"]
    st = stack_oof([win.oof_preds] + [rows[n]["oof"] for n in stacked], y,
                   [win.test_preds] + [rows[n]["test"] for n in stacked])
    st_test = f1_score(y_te, st["test_preds"] > st["threshold"])
    log(f"  stacking (v119) over the v92d winner and {', '.join(stacked)}: OOF F1 "
        f"{st['best_f1']:.4f} @ {st['threshold']:.3f}; TEST F1 {st_test:.4f}")
    if not (np.isfinite(st["oof_preds"]).all() and np.isfinite(st["test_preds"]).all()):
        raise AssertionError("stacking produced non-finite outputs")
    gates = (("v34a", V34A_F1_GATE), ("v104", SEED_ENSEMBLE_F1_GATE))
    log("OOF F1 gates: " + "; ".join(
        f"{n} {rows[n]['oof_f1']:.4f} >= {g} {'ok' if rows[n]['oof_f1'] >= g else 'FAIL'}"
        for n, g in gates))
    if any(rows[n]["oof_f1"] < g for n, g in gates):
        raise AssertionError("a runner's OOF F1 is below its gate")
    log(f"runners: K1 launches {k1_all}, K3 launches {k3_all}; "
        + ", ".join(f"{n}={r['s']:.3f}s" for n, r in rows.items()))
    return {"k1": k1_all, "k3": k3_all,
            "runners": {n: {k: v for k, v in r.items() if k not in ("oof", "test")}
                        for n, r in rows.items()},
            "v34a": rows["v34a"], "X224": (X224, X224_te, names224)}


def regenerate_train_split(device):
    """The bench split's train half from the port's generator, held column
    for column (bit for bit) against ``.bench_data_v2.npz``; returns its
    spectral types."""
    t0 = time.perf_counter()
    _, meta, cols = generate_dataset(BENCH_SPLITS["n_train"], seed=BENCH_SPLITS["seed"],
                                     tde_frac=BENCH_SPLITS["tde_frac"], device=device)
    got = dict(cols, object_ids=meta.object_ids, z=meta.z, ebv=meta.ebv, target=meta.target)
    with np.load(DATA, allow_pickle=False) as z:
        bad = [k for k in ("object_index", "time", "flux", "flux_err", "band", "object_ids",
                           "z", "ebv", "target")
               if got[k].shape != z[f"tr_{k}"].shape or not np.array_equal(got[k], z[f"tr_{k}"])]
    kinds, counts = np.unique(meta.spec_type, return_counts=True)
    log(f"  regenerated the train split in {time.perf_counter() - t0:.3f} s: "
        f"{len(meta.z)} objects, {len(cols['time'])} observations; columns differing from "
        f"the npz: {bad or 'none'}; spectral types "
        + ", ".join(f"{k} {c}" for k, c in zip(kinds, counts)))
    if bad:
        raise AssertionError(f"the regenerated train split differs from the npz in {bad}")
    return meta.spec_type


def run_policies(trained: dict, runners: dict, dev) -> dict:
    """The other tree policies and the multiclass head, each once on the
    runners' 224-column v34a matrix: v118 (symmetric), v110 (leaf-wise),
    v111 (leaf-wise DART, every round), the v119 stack over the runners'
    v34a and these v110 and v118, and v62 on the regenerated spectral
    types. Each run's seconds, rounds, F1s and K1 / K3 launches, held
    against rounds x depth (K1) and 15 x rounds (K3)."""
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    y, y_te = np.asarray(tr_meta.target), np.asarray(te_meta.target)
    X, X_te, names = runners["X224"]
    L = V110_PARAMS.max_leaves

    def cv(params):
        r = train_cv(X, y, X_te, params, device=dev)
        return r.oof_preds, r.test_preds, r.best_f1, r.best_threshold, r

    def v62():
        spec = regenerate_train_split(dev)
        r = run_v62(X, y, spec, names, X_te, device=dev)
        cls_idx = {c: i for i, c in enumerate(r.mc_classes)}
        y_mc = np.asarray([cls_idx[c] for c in simplify_spectype(spec)])
        acc = float((r.mc_oof.argmax(axis=1) == y_mc).mean())
        mc_rounds = fit_rounds(r.mc_models, 5)[0]
        log(f"  v62: classes {', '.join(map(str, r.mc_classes))}; multiclass head "
            f"{mc_rounds} rounds, OOF accuracy {acc:.4f}, TDE F1 {r.mc_tde_f1:.4f}; final "
            f"CV on {len(r.feature_names)} columns")
        if not (np.isfinite(r.mc_oof).all() and np.isfinite(r.mc_test).all()):
            raise AssertionError("v62: non-finite class probabilities")
        rounds = [mc_rounds, r.cv.rounds_run]
        extra = {"mc_accuracy": acc, "mc_tde_f1": r.mc_tde_f1, "mc_rounds": mc_rounds}
        return (r.cv.oof_preds, r.cv.test_preds, r.oof_f1, r.threshold, rounds,
                V62_MC_PARAMS.max_depth * mc_rounds + V34A_PARAMS.max_depth * rounds[1], 0,
                extra)

    def with_rounds(res, k1_per_round, k3_per_round):
        oof, test, f1, thr, r = res
        rounds = r.rounds_run
        best = [m.best_iteration for m in r.models]
        q = np.quantile(oof, [0.5, 0.9, 0.99])
        log(f"    best iterations {best}; OOF probabilities: median {q[0]:.4f}, 90th "
            f"percentile {q[1]:.4f}, 99th {q[2]:.4f}, max {oof.max():.4f}")
        return (oof, test, f1, thr, [rounds], k1_per_round * rounds, k3_per_round * rounds,
                {"best_iterations": best})

    runs = {
        "v118": lambda: with_rounds(cv(V118_PARAMS), V118_PARAMS.max_depth, 0),
        "v110": lambda: with_rounds(cv(V110_PARAMS), 0, L),
        "v111": lambda: with_rounds(cv(V111_PARAMS), 0, L),
        "v62": v62,
    }
    rows, k1_all, k3_all = {}, 0, 0
    for name, fn in runs.items():
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oof, test, f1, thr, rounds, want_k1, want_k3, extra = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k3 = hist_cuda.launches, hist_cuda.seg_launches
        k1_all, k3_all = k1_all + k1, k3_all + k3
        test_f1 = f1_score(y_te, np.asarray(test) > thr)
        log(f"  {name}: {secs:.3f} s; rounds {rounds}; OOF F1 {f1:.4f} @ {thr:.3f}; TEST F1 "
            f"{test_f1:.4f}; K1 launches {k1} (predicted {want_k1}); K3 launches {k3} "
            f"(predicted {want_k3})")
        if k1 != want_k1 or k3 != want_k3 or k1 + k3 == 0:
            raise AssertionError(f"{name}: the histogram launch counts disagree with the "
                                 f"prediction")
        if (np.shape(oof) != (len(y),) or np.shape(test) != (len(y_te),)
                or not (np.isfinite(oof).all() and np.isfinite(test).all())):
            raise AssertionError(f"{name}: malformed or non-finite outputs")
        rows[name] = {"s": secs, "rounds": rounds, "oof_f1": f1, "threshold": thr,
                      "test_f1": test_f1, "k1": k1, "k3": k3, "oof": oof, "test": test,
                      **extra}
    if rows["v111"]["rounds"] != [V111_PARAMS.n_rounds]:
        raise AssertionError("v111 (DART) did not run every round")
    # v119: stacking over the v34a, v110 and v118 CVs (cli/main.py's bases)
    v34a = runners["v34a"]
    bases = [v34a, rows["v110"], rows["v118"]]
    st = stack_oof([b["oof"] for b in bases], y, [b["test"] for b in bases])
    st_test = f1_score(y_te, st["test_preds"] > st["threshold"])
    log(f"  v119 stack over v34a ({v34a['oof_f1']:.4f}), v110 ({rows['v110']['oof_f1']:.4f}) "
        f"and v118 ({rows['v118']['oof_f1']:.4f}): OOF F1 {st['best_f1']:.4f} @ "
        f"{st['threshold']:.3f}; TEST F1 {st_test:.4f}")
    if not (np.isfinite(st["oof_preds"]).all() and np.isfinite(st["test_preds"]).all()):
        raise AssertionError("v119 stacking produced non-finite outputs")
    rows["v119"] = {"oof_f1": st["best_f1"], "threshold": st["threshold"], "test_f1": st_test}
    log(f"policies: K1 launches {k1_all}, K3 launches {k3_all}; "
        + ", ".join(f"{n}={r['s']:.3f}s" for n, r in rows.items() if "s" in r))
    return {"k1": k1_all, "k3": k3_all,
            "runs": {n: {k: v for k, v in r.items() if k not in ("oof", "test")}
                     for n, r in rows.items()}}


# ---------------------------------------------------------------------------
# The families phase: the LM feature families, the command line's
# backbone-plus-family experiments, HPO and the training tools

# (name, extract) of the families fitted by batched Levenberg-Marquardt
LM_FAMILIES = (("powerlaw", powerlaw.extract), ("tde_models", tde_models.extract),
               ("blackbody", blackbody.extract), ("advanced_physics", advanced_physics.extract))
# objects per extraction chunk: tde_models' Jacobian is [6 x chunk, 3, T, 6]
FAMILY_CHUNK = 2048
# the fit columns' cost (reduced chi^2; powerlaw's R^2 becomes its residual
# sum of squares) and the columns that do not come out of a fit, which the
# CPU holds at the closed-form families' gate (GATES["features_v4"])
FIT_COST_COLUMNS = {"tde_models": [f"{b}_tde_fit_chi2" for b in LSST_BANDS],
                    "blackbody": [f"T_chi2_{e}" for e in blackbody.EPOCH_NAMES],
                    "advanced_physics": [f"temp_chi2_epoch_{int(e)}d"
                                         for e in advanced_physics.TEMP_EPOCHS]}
# HPO: TPE over DEFAULT_SPACE on the v92d matrix, then depth 8
HPO_TRIALS, HPO_STARTUP, HPO_ROUNDS, HPO_SEED = 8, 4, 200, 19
DEPTH8_ROUNDS = 10  # the depth-8 single fits held against K1's fixed-point twin


def not_fitted(family: str, name: str) -> bool:
    if family == "blackbody":
        return name.startswith("L_proxy_")
    if family == "advanced_physics":
        return not name.startswith(("temp_", "cooling_rate_", "sed_quality_"))
    return False


def powerlaw_ss_tot(packed) -> torch.Tensor:
    """[N, 3] ss_tot of the post-peak g/r/i fluxes, as the family takes it
    (float64, on the CPU)."""
    t = packed.band_time[:, 1:4].cpu().double()
    f = packed.band_flux[:, 1:4].cpu().double()
    m = packed.band_mask[:, 1:4].cpu()
    pt = torch.gather(t, -1, torch.where(m, f, -1e30).argmax(dim=-1, keepdim=True))
    post = m & (t > pt)
    mu = torch.where(post, f, 0.0).sum(-1) / post.sum(-1).clamp(min=1)
    return torch.where(post, (f - mu[..., None]) ** 2, 0.0).sum(-1)


def family_costs(family: str, feats: dict, packed) -> torch.Tensor:
    """[N, lanes] float64 fit costs of a family's output (NaN where no fit)."""
    if family == "powerlaw":
        ss = powerlaw_ss_tot(packed)
        cols = [(1.0 - feats[f"{b}_{m}_r2"].cpu().double()) * ss[:, bi]
                for bi, b in enumerate("gri") for m in powerlaw.MODEL_NAMES]
        return torch.stack(cols, 1)
    return torch.stack([feats[k].cpu().double() for k in FIT_COST_COLUMNS[family]], 1)


def check_family_reference(family: str, fn, packed, m: int = 128) -> dict:
    """The first ``m`` objects of ``packed`` through the family on the card
    and on the CPU (the same port code): names and NaN lanes identical,
    the columns that do not come out of a fit at the closed-form families'
    gate, and the fits by Bazin's bar: on >= 98% of the lanes the CPU
    fitted, the card's cost <= 1.05 x the CPU's + 0.5, the median ratio
    over the fits that leave a residual within [0.99, 1.01]."""
    sub = packed.map(lambda x: x[:m])
    got = fn(sub)
    want = fn(sub.to("cpu"))
    if list(got) != list(want):
        raise AssertionError(f"{family}: the card's columns differ from the CPU's")
    nan_diff = [k for k in want if not torch.equal(torch.isnan(got[k].cpu()), torch.isnan(want[k]))]
    rtol, col_need, mean_need = GATES["features_v4"]
    plain = {k: want[k] for k in want if not_fitted(family, k)}
    fracs = column_agreement({k: got[k] for k in plain}, plain, rtol)
    a = family_costs(family, want, sub.to("cpu"))
    b = family_costs(family, got, sub.to("cpu"))
    fit = torch.isfinite(a)
    share = (b[fit] <= a[fit] * 1.05 + 0.5).double().mean().item()
    res = fit & (a >= 1e-6)
    med = (b[res] / a[res]).median().item() if bool(res.any()) else 1.0
    worst = min(fracs.values()) if fracs else 1.0
    mean = float(np.mean(list(fracs.values()))) if fracs else 1.0
    log(f"  {family} on the card vs the CPU, {m} objects: {len(want)} columns, NaN lanes "
        f"differ in {nan_diff or 'none'}; {len(fracs)} closed-form columns, mean {mean:.4f} "
        f"of cells within rtol {rtol:g} (worst {worst:.4f}; needs {col_need:g} / "
        f"{mean_need:g}); {int(fit.sum())} fitted lanes, {share:.4f} with the card's cost <= "
        f"1.05 x the CPU's + 0.5 (needs 0.98), median ratio {med:.5f} over "
        f"{int(res.sum())} fits with a residual (needs 0.99..1.01)")
    if nan_diff or worst < col_need or mean < mean_need or share < 0.98 \
            or not 0.99 <= med <= 1.01:
        raise AssertionError(f"{family} on the card disagrees with the CPU")
    return {"fit_share": share, "median_ratio": med, "nan_lanes_equal": True}


def on_minority_segments(X_new: np.ndarray, Xm: np.ndarray, nn: np.ndarray,
                         device) -> np.ndarray:
    """[M] whether each synthetic row is Xm[i] + lam (Xm[j] - Xm[i]) for a
    minority row i, one of its k nearest minority neighbours j and
    0 <= lam <= 1 (NaN where either end is NaN)."""
    Xn = torch.as_tensor(X_new, dtype=torch.float64, device=device)
    A = torch.as_tensor(Xm, dtype=torch.float64, device=device)
    ok = torch.zeros(len(Xn), dtype=torch.bool, device=device)
    for i in range(len(A)):
        D = A[nn[i]] - A[i]  # [k, F]
        R = Xn - A[i]  # [M, F]
        nan_ok = (torch.isnan(R)[:, None, :] == torch.isnan(D)[None, :, :]).all(-1)
        Dz, Rz = torch.nan_to_num(D), torch.nan_to_num(R)
        lam = (Rz @ Dz.T) / (Dz * Dz).sum(-1).clamp(min=1e-300)  # [M, k]
        err = (Rz[:, None, :] - lam[..., None] * Dz[None]).abs().amax(-1)
        scale = 1e-6 * (1.0 + Dz.abs().amax(-1))[None, :]
        ok |= (nan_ok & (err <= scale) & (lam >= -1e-9) & (lam <= 1 + 1e-9)).any(-1)
    return ok.cpu().numpy()


def run_families(trained: dict, ensemble: dict, runners: dict, dev) -> dict:
    """The families phase, on the training run's packed splits, bundles,
    selection, adversarial weights and winner and the runners' v34a OOF:

    - powerlaw, tde_models (hybrid), blackbody and advanced_physics
      extracted on both splits on the card (seconds, columns, finite
      share), the first 128 test objects held against the CPU;
    - v55, v64, v30 (+ those families), v57 (+ dereddened twins), v45
      (+ categorical bins) and v105 (+ the top 30 interactions, chosen on
      train), each a ``train_cv`` at V34A_PARAMS on the 224-column v34a
      matrix plus its columns; K1 launches = rounds x depth;
    - an 8-trial TPE search on the v92d matrix with the adversarial
      weights, then depth 8 (K1 at 64 nodes with subtraction, 128
      without), and depth-8 single fits bit for bit K1's fixed-point twin;
    - calibration, error analysis, prediction agreement, SMOTE and ADASYN.
    """
    out = trained["out"]
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    y, y_te = np.asarray(tr_meta.target), np.asarray(te_meta.target)
    X224, X224_te, names224 = runners["X224"]
    keep = [i for i, n in enumerate(names224) if n not in SHIFT_FEATURES]
    X, X_te = X224[:, keep], X224_te[:, keep]
    w, win = out.adversarial.sample_weights, out.winner
    rows, k1_all = {}, 0

    # ---- the LM families on both splits ----
    fams = {}
    for fam, fn in LM_FAMILIES:
        mats = []
        for tag, packed in (("train", tr_packed), ("test", te_packed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = chunked_extract(fn, packed, chunk_size=FAMILY_CHUNK)
            mat, fam_names = feature_matrix(feats)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            mats.append(mat.cpu().numpy())
            log(f"  {fam} {tag}: {packed.n_objects} objects, {secs:.3f} s, {len(fam_names)} "
                f"columns, finite share {float(np.isfinite(mats[-1]).mean()):.4f}")
        ref = check_family_reference(fam, fn, te_packed)
        fams[fam] = (mats[0], mats[1], fam_names, ref)

    # ---- the backbone-plus-family experiments (cli/main.py v55 ... v105) ----
    def with_cols(extra_tr, extra_te):
        return (_finite_or_nan(np.concatenate([X224, extra_tr], axis=1)),
                _finite_or_nan(np.concatenate([X224_te, extra_te], axis=1)))

    def columns(d: dict, keys, n: int) -> np.ndarray:
        return (np.stack([d[k] for k in keys], axis=1).astype(np.float32) if keys
                else np.zeros((n, 0), np.float32))

    def cats(Xm):
        c, c_names = add_categorical_features(dict(zip(names224, Xm.astype(np.float64).T)))
        return columns(c, c_names, len(Xm)), c_names

    inter_tr = create_physics_interactions(dict(zip(names224, X224.astype(np.float64).T)))
    inter_te = create_physics_interactions(dict(zip(names224, X224_te.astype(np.float64).T)))
    top = select_top_interactions(inter_tr, y, top_k=30)
    log(f"  v105: {len(inter_tr)} interactions, the top {len(top)} chosen on train")
    d_tr, d_names = dered_matrix(X224, names224, np.asarray(tr_meta.ebv))
    d_te, _ = dered_matrix(X224_te, names224, np.asarray(te_meta.ebv))
    c_tr, c_names = cats(X224)
    c_te, _ = cats(X224_te)
    experiments = {
        "v55": fams["powerlaw"][:2], "v64": fams["blackbody"][:2],
        "v30": fams["advanced_physics"][:2], "v57": (d_tr, d_te), "v45": (c_tr, c_te),
        "v105": (columns(inter_tr, top, len(y)), columns(inter_te, top, len(y_te))),
    }
    log(f"  v57: {len(d_names)} dereddened twins; v45: {len(c_names)} categorical columns")
    for name, (e_tr, e_te) in experiments.items():
        Xtr2, Xte2 = with_cols(e_tr, e_te)
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(Xtr2, y, Xte2, V34A_PARAMS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, want_k1 = hist_cuda.launches, V34A_PARAMS.max_depth * cv.rounds_run
        k1_all += k1
        test_f1 = f1_score(y_te, cv.test_preds > cv.best_threshold)
        log(f"  {name}: {Xtr2.shape[1]} columns, {secs:.3f} s; rounds {cv.rounds_run}; OOF F1 "
            f"{cv.best_f1:.4f} @ {cv.best_threshold:.3f}; TEST F1 {test_f1:.4f}; K1 launches "
            f"{k1} (rounds x depth predicts {want_k1})")
        if k1 != want_k1 or k1 == 0:
            raise AssertionError(f"{name}: K1 launches disagree with rounds x depth")
        if not (np.isfinite(cv.oof_preds).all() and np.isfinite(cv.test_preds).all()):
            raise AssertionError(f"{name}: non-finite outputs")
        rows[name] = {"s": secs, "columns": Xtr2.shape[1], "rounds": cv.rounds_run,
                      "oof_f1": cv.best_f1, "threshold": cv.best_threshold,
                      "test_f1": test_f1, "k1": k1}

    # ---- HPO: TPE on the v92d matrix, each trial timed ----
    trials_log = []

    def timed_cv(*args, **kwargs):
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(*args, **kwargs)
        torch.cuda.synchronize()
        trials_log.append((time.perf_counter() - t0, args[3], cv, hist_cuda.launches,
                           dict(hist_cuda.launches_by_nodes)))
        return cv

    hpo.train_cv = timed_cv
    try:
        t0 = time.perf_counter()
        trials = hpo.tpe_search(X, y, n_trials=HPO_TRIALS, n_startup=HPO_STARTUP,
                                sample_weight=w, seed=HPO_SEED, n_rounds=HPO_ROUNDS,
                                base=V34A_PARAMS, device=dev)
        hpo_s = time.perf_counter() - t0
    finally:
        hpo.train_cv = train_cv
    for i, (secs, p, cv, k1, by_nodes) in enumerate(trials_log):
        want_k1 = cv.rounds_run * p.max_depth
        log(f"  trial {i + 1}{' (tpe)' if i >= HPO_STARTUP else ''}: "
            + ", ".join(f"{k}={getattr(p, k):.4g}" for k in hpo.DEFAULT_SPACE)
            + f"; {secs:.3f} s, rounds {cv.rounds_run}; OOF F1 {cv.best_f1:.4f} @ "
            f"{cv.best_threshold:.3f}; K1 launches {k1} (rounds x depth predicts {want_k1}) "
            f"by level width {by_nodes}")
        if k1 != want_k1:
            raise AssertionError(f"HPO trial {i + 1}: K1 launches disagree with rounds x depth")
        k1_all += k1
    log(f"  TPE: {len(trials)} trials in {hpo_s:.3f} s; best OOF F1 {trials[0].oof_f1:.4f} "
        f"at max_depth {trials[0].params.max_depth}")
    rows["hpo"] = {"s": hpo_s, "trials": len(trials), "best_oof_f1": trials[0].oof_f1,
                   "best": {k: getattr(trials[0].params, k) for k in hpo.DEFAULT_SPACE},
                   "depths": [p.max_depth for _, p, _, _, _ in trials_log]}

    # ---- depth 8: the top of DEFAULT_SPACE, with and without subtraction ----
    p8 = V34A_PARAMS._replace(n_rounds=HPO_ROUNDS, max_depth=8)
    forests = {}
    for sub, width in ((True, 64), (False, 128)):
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(X, y, X_te, p8._replace(hist_subtract=sub), sample_weight=w, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by_nodes = dict(hist_cuda.launches_by_nodes)
        k1_all += hist_cuda.launches
        log(f"  depth 8, hist_subtract={sub}: {secs:.3f} s; rounds {cv.rounds_run}; OOF F1 "
            f"{cv.best_f1:.4f} @ {cv.best_threshold:.3f}; K1 launches {hist_cuda.launches} by "
            f"level width {by_nodes} (rounds x depth predicts {8 * cv.rounds_run}; "
            f"{cv.rounds_run} at {width} nodes)")
        if (hist_cuda.launches != 8 * cv.rounds_run or by_nodes.get(width) != cv.rounds_run
                or max(by_nodes) != width):
            raise AssertionError(f"depth 8 (hist_subtract={sub}): K1 launches disagree")
        forests[sub] = [m.forest for m in cv.models]
        split = torch.stack([~f.is_leaf & (f.split_bin >= 0) for f in forests[sub]])
        deepest = max((d for d in range(8) if bool(split[..., 2 ** d - 1:2 ** (d + 1) - 1].any())),
                      default=-1)
        log(f"    its deepest split level: {deepest} (0 = the root)")
        rows[f"depth8_{'subtract' if sub else 'direct'}"] = {
            "s": secs, "rounds": cv.rounds_run, "oof_f1": cv.best_f1, "k1": hist_cuda.launches,
            f"k1_at_{width}_nodes": by_nodes[width]}
    # the two fits differ where float32 subtraction (parent - left) rounds
    # a right child's sums otherwise than its direct sum and that decides a
    # near tie: counted, not held (their splits agree in most slots)
    slots = sum(int(((a.feature != b.feature) | (a.split_bin != b.split_bin)).sum())
                for a, b in zip(forests[True], forests[False])
                if a.feature.shape == b.feature.shape)
    total = sum(a.feature.numel() for a in forests[True])
    log(f"  depth 8: subtracted and direct forests differ in {slots} of {total} split slots "
        f"(float32 parent - left rounds otherwise than the direct sum)")
    # the same two settings as single fits, K1 against its fixed-point twin;
    # min_child_weight 1e-3 lets the trees reach the 64 / 128-node level
    fit_rows = int(0.8 * len(y))
    for sub in (True, False):
        p = p8._replace(n_rounds=DEPTH8_ROUNDS, hist_subtract=sub, min_child_weight=1e-3)
        fs = [train_gbdt(X[:fit_rows], y[:fit_rows], p, sample_weight=w[:fit_rows],
                         device=dev, hist_fn=fn).forest
              for fn in (hist_cuda.build_histograms, hist_cuda.build_histograms_fixed)]
        same = forests_bits_equal(*fs)
        deep = int((~fs[0].is_leaf[..., 2 ** 7 - 1:] & (fs[0].split_bin[..., 2 ** 7 - 1:] >= 0))
                   .sum())
        log(f"  depth 8 single fit, {fit_rows} rows, {DEPTH8_ROUNDS} rounds, hist_subtract="
            f"{sub}: {deep} splits on the last level; K1 vs its fixed-point twin: forests bit "
            f"for bit equal {same}")
        if not same or deep == 0:
            raise AssertionError(f"depth 8 (hist_subtract={sub}): K1 and its fixed-point twin "
                                 f"disagree")

    # ---- calibration and analysis on the winner's OOF / test ----
    oof, test = win.oof_preds, win.test_preds
    brier = {"raw": float(np.mean((test - y_te) ** 2))}
    platt, ab = calibration.platt_scale(oof, y, test)
    brier["platt"] = float(np.mean((platt - y_te) ** 2))
    brier["isotonic"] = float(np.mean((calibration.isotonic_calibrate(oof, y, test) - y_te) ** 2))
    variants = {t: int(v.sum()) for t, v in
                calibration.threshold_variants(test, [0.3, 0.5, 0.7]).items()}
    log(f"  calibration (test Brier score): raw {brier['raw']:.5f}, Platt (a={ab[0]:.4f}, "
        f"b={ab[1]:.4f}) {brier['platt']:.5f}, isotonic {brier['isotonic']:.5f}; positives "
        f"at 0.3 / 0.5 / 0.7: {variants}")
    if not all(np.isfinite(v) for v in brier.values()):
        raise AssertionError("calibration produced non-finite probabilities")
    rep = analysis.error_analysis(y, oof, win.best_threshold, X=X,
                                  feature_names=out.feature_names,
                                  importance_gain=win.importance_gain,
                                  object_ids=tr_meta.object_ids, z=tr_meta.z,
                                  other_models={"v34a": runners["v34a"]["oof"]})
    analysis.print_error_analysis(rep)
    c = rep["confusion"]
    if c != win.confusion(y):
        raise AssertionError("error_analysis' confusion disagrees with the CV's")
    agree = analysis.prediction_agreement({"v92d": test, "v34a": runners["v34a"]["test"],
                                           "ensemble": ensemble["test"]},
                                          threshold=win.best_threshold)
    pairs = [(i, a, b) for i, a in enumerate(agree) for b in list(agree)[i + 1:]]
    log(f"  prediction agreement on the test split at {win.best_threshold:.3f}: " + "; ".join(
        f"{a} / {b} {agree[b][i]:.4f}" for i, a, b in pairs))
    rows["calibration"] = {"brier": brier, "positives": variants, "confusion": c}

    # ---- oversampling on the v92d training matrix ----
    for name, fn in (("smote", oversample.smote), ("adasyn", oversample.adasyn)):
        t0 = time.perf_counter()
        Xo, yo = fn(X, y, ratio=0.5, seed=SEED)
        secs = time.perf_counter() - t0
        pos = np.where(y == 1)[0]
        X_new = Xo[len(y):]
        on_seg = on_minority_segments(X_new, X[pos], oversample._knn_minority(X[pos], 5), dev)
        log(f"  {name} (ratio 0.5): {len(y)} -> {len(yo)} rows ({len(X_new)} synthetic, "
            f"{int(yo.sum())} positives), {secs:.3f} s; on a segment between a minority row "
            f"and one of its 5 nearest minority neighbours: {int(on_seg.sum())} of "
            f"{len(X_new)}")
        if len(X_new) == 0 or not on_seg.all() or not (yo[len(y):] == 1).all():
            raise AssertionError(f"{name}: a synthetic row is off its minority segment")
        rows[name] = {"s": secs, "rows": len(yo), "synthetic": len(X_new)}
    log(f"families: K1 launches {k1_all}")
    return {"k1": k1_all, "rows": rows,
            "families": {f: {"columns": len(v[2]), **v[3]} for f, v in fams.items()}}


# The families 2 phase: the twelve remaining feature families, the command
# line's experiments on them, and augmentation

GP1D_STEPS = 150  # the command line's default (its --gp-steps)
# (name, extract(packed, meta, templates)) in the order they are ported
FAMILIES2 = (
    ("gp1d", lambda p, m, tpl: gp1d.extract(p, n_steps=GP1D_STEPS)),
    ("dtw", lambda p, m, tpl: dtw.extract(p, tpl)),
    ("advanced", lambda p, m, tpl: advanced.extract(p, m)),
    ("cesium", lambda p, m, tpl: cesium.extract(p)),
    ("high_snr", lambda p, m, tpl: high_snr.extract(p)),
    ("fourier", lambda p, m, tpl: fourier.extract(p)),
    ("fwhm", lambda p, m, tpl: fwhm.extract(p)),
    ("temp_fwhm", lambda p, m, tpl: temp_fwhm.extract(p)),
    ("peak_ordering", lambda p, m, tpl: peak_ordering.extract(p)),
    ("powerlaw_ratio", lambda p, m, tpl: powerlaw_ratio.extract(p)),
    ("enhanced_colors", lambda p, m, tpl: enhanced_colors.extract(p)),
    ("time_to_decline", lambda p, m, tpl: time_to_decline.extract(p)),
)
# the command line's backbone-plus-family experiments on them
FAMILY2_EXPERIMENTS = (("v9", "dtw"), ("v20", "advanced"), ("v35", "cesium"),
                       ("v40", "fourier"), ("v47", "enhanced_colors"),
                       ("v48", "time_to_decline"), ("v56", "peak_ordering"),
                       ("v58", "fwhm"), ("v59b", "temp_fwhm"), ("v65", "powerlaw_ratio"),
                       ("v66", "high_snr"))
# gp1d's K2 shapes: a 2,048-object chunk is 12,288 lanes; the test split's
# band view is 40 wide, the train split's 48
GP1D_K2_SHAPES = ((12288, 40), (12287, 40), (12288, 48))
WARP_SHARE = 0.98  # DTW's warp fractions equal on at least this share of lanes
# rounds of each families 2 experiment (V34A_PARAMS' 500 cut to pay for the
# mesh phase)
FAMILY2_ROUNDS = 250
AUG_KEY = 20  # augment_dataset's key: prng.PRNGKey(AUG_KEY)
AUG_RTOL = 1e-5


def check_family2_reference(family: str, fn, packed, meta, templates, m: int = 128) -> dict:
    """The first ``m`` objects through the family on the card and on the
    CPU (the same port code): names and NaN lanes identical; gp1d at
    multiband_gp's gate, DTW's warp fractions equal on >= WARP_SHARE of
    lanes, every other column at features_v4's gate."""
    sub = packed.map(lambda x: x[:m])
    sub_meta = Metadata(*[None if x is None else x[:m] for x in
                          (meta.object_ids, meta.z, meta.ebv, meta.target, meta.spec_type)])
    got = fn(sub, sub_meta, templates)
    want = fn(sub.to("cpu"), sub_meta, templates.cpu())
    if list(got) != list(want):
        raise AssertionError(f"{family}: the card's columns differ from the CPU's")
    nan_diff = [k for k in want if not torch.equal(torch.isnan(got[k].cpu()), torch.isnan(want[k]))]
    warp = [k for k in want if family == "dtw" and "warp" in k]
    rtol, col_need, mean_need = GATES["multiband_gp" if family == "gp1d" else "features_v4"]
    held = [k for k in want if k not in warp]
    fracs = column_agreement({k: got[k] for k in held}, {k: want[k] for k in held}, rtol)
    worst = min(fracs.values())
    mean = float(np.mean(list(fracs.values())))
    warp_share = (float(np.mean([((got[k].cpu() == want[k])
                                  | (torch.isnan(got[k].cpu()) & torch.isnan(want[k])))
                                 .double().mean().item() for k in warp])) if warp else 1.0)
    log(f"  {family} on the card vs the CPU, {m} objects: {len(want)} columns, NaN lanes "
        f"differ in {nan_diff or 'none'}; {len(fracs)} columns at rtol {rtol:g}, mean "
        f"{mean:.4f} of cells (worst {worst:.4f}; needs {col_need:g} / {mean_need:g})"
        + (f"; warp fractions equal on {warp_share:.4f} of lanes (needs {WARP_SHARE:g})"
           if warp else ""))
    if nan_diff or worst < col_need or mean < mean_need or warp_share < WARP_SHARE:
        raise AssertionError(f"{family} on the card disagrees with the CPU")
    return {"mean_share": mean, "worst_share": worst, "warp_share": warp_share}


def check_augmentation(tr_packed, tr_meta) -> dict:
    """``augment_dataset`` over one copy of the train split with a fixed key
    on the card and on the CPU (masks equal, times, fluxes and errors within
    rtol AUG_RTOL), then the transforms' invariants on the card's results."""
    key = prng.PRNGKey(AUG_KEY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_meta = augmentation.augment_dataset(tr_packed, tr_meta, key, n_copies=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want, _ = augmentation.augment_dataset(tr_packed.to("cpu"), tr_meta, key, n_copies=1)
    n = tr_packed.n_objects
    masks_equal = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                      for f in ("band_mask", "all_mask", "all_band"))
    worst = {}
    for f in ("band_time", "band_flux", "band_err", "all_time", "all_flux", "all_err"):
        a, b = getattr(got, f).cpu().double(), getattr(want, f).double()
        d = (a - b).abs() / b.abs().clamp(min=1e-30)
        worst[f] = d[(a != b)].max().item() if bool((a != b).any()) else 0.0
    log(f"  augment_dataset: {n} -> {got.n_objects} objects on the card in {secs:.3f} s; "
        f"masks equal to the CPU's {masks_equal}; largest relative difference "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (needs <= {AUG_RTOL:g})")
    if (not masks_equal or max(worst.values()) > AUG_RTOL or got.n_objects != 2 * n
            or len(got_meta.object_ids) != 2 * n):
        raise AssertionError("augment_dataset on the card disagrees with the CPU")
    m = tr_packed.band_mask
    kept = got.band_mask[n:].sum(-1)
    had = m.sum(-1)
    # the invariants of tests/test_augmentation.py, on the card
    shifted = augmentation.time_shift(tr_packed, prng.PRNGKey(AUG_KEY + 1))
    dt_old = torch.where(m[..., 1:] & m[..., :-1], torch.diff(tr_packed.band_time), 0.0)
    dt_new = torch.where(m[..., 1:] & m[..., :-1], torch.diff(shifted.band_time), 0.0)
    cadence = bool(torch.allclose(dt_new, dt_old, rtol=1e-5, atol=1e-3))
    min_kept = bool((kept[had >= 5] >= 5).all()) and int(kept.sum()) < int(had.sum())
    degraded = augmentation.snr_degradation(tr_packed, prng.PRNGKey(AUG_KEY + 2))
    inflated = bool((degraded.band_err[m] >= tr_packed.band_err[m] - 1e-6).all())
    mixed = augmentation.tde_mixup(tr_packed, tr_meta, prng.PRNGKey(AUG_KEY + 3))
    non = torch.as_tensor(np.asarray(tr_meta.target) == 0, device=m.device)
    tde = ~non
    only_tdes = (bool(torch.equal(mixed.band_flux[non], tr_packed.band_flux[non]))
                 and not bool(torch.equal(mixed.band_flux[tde], tr_packed.band_flux[tde])))
    log(f"  invariants on the card: time_shift keeps the cadence {cadence}; dropout keeps >= 5 "
        f"points in every band that had them {min_kept} ({int(kept.sum())} of {int(had.sum())} "
        f"points kept); snr_degradation inflates the errors {inflated}; tde_mixup changes the "
        f"TDEs' fluxes alone {only_tdes}")
    if not (cadence and min_kept and inflated and only_tdes):
        raise AssertionError("an augmentation invariant fails on the card")
    return {"s": secs, "worst_rel": worst}


def run_families2(trained: dict, runners: dict, dev) -> dict:
    """The families 2 phase, on the training run's packed splits and the
    runners' 224-column v34a matrix:

    - the twelve families extracted on both splits on the card in chunks
      of FAMILY_CHUNK objects (DTW's templates built once from the train
      split), gp1d's K2 launches = chunks x (GP1D_STEPS + 1) at each
      split's band width, the first 128 test objects held against the CPU;
    - v9 ... v66, each a ``train_cv`` at V34A_PARAMS cut to FAMILY2_ROUNDS
      on the v34a matrix plus the family's columns; K1 launches = rounds x
      depth;
    - ``augment_dataset`` on the card against the CPU, and the invariants.
    """
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    y, y_te = np.asarray(tr_meta.target), np.asarray(te_meta.target)
    X224, X224_te, _ = runners["X224"]
    rows, k1_all = {}, 0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    templates = dtw.build_templates(tr_packed, tr_meta.target)
    torch.cuda.synchronize()
    log(f"  dtw templates {tuple(templates.shape)} from the train split's labels in "
        f"{time.perf_counter() - t0:.3f} s")

    mats, refs, gp1d_k2 = {}, {}, {}
    for fam, fn in FAMILIES2:
        mats[fam] = []
        for tag, packed, meta in (("train", tr_packed, tr_meta), ("test", te_packed, te_meta)):
            chol_cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = chunked_extract(fn, packed, meta, templates, chunk_size=FAMILY_CHUNK)
            mat, fam_names = feature_matrix(feats)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            mats[fam].append(mat.cpu().numpy())
            log(f"  {fam} {tag}: {packed.n_objects} objects, {secs:.3f} s, {len(fam_names)} "
                f"columns, finite share {float(np.isfinite(mats[fam][-1]).mean()):.4f}")
            by_t = dict(chol_cuda.launches_by_t)
            if fam == "gp1d":
                T = packed.band_time.shape[-1]
                want = -(-packed.n_objects // FAMILY_CHUNK) * (GP1D_STEPS + 1)
                log(f"  gp1d {tag}: K2 launches by width {by_t} (chunks x {GP1D_STEPS + 1} "
                    f"predicts {want} at T = {T}); cluster {chol_cuda.cluster_launches}, "
                    f"tiled {chol_cuda.large_launches}")
                if by_t != {T: want} or chol_cuda.cluster_launches or chol_cuda.large_launches:
                    raise AssertionError("gp1d's K2 launches disagree with the prediction")
                gp1d_k2[T] = gp1d_k2.get(T, 0) + want
            elif by_t:
                raise AssertionError(f"{fam} launched K2 ({by_t})")
        mats[fam].append(fam_names)
        refs[fam] = check_family2_reference(fam, fn, te_packed, te_meta, templates)

    for name, fam in FAMILY2_EXPERIMENTS:
        Xtr2 = _finite_or_nan(np.concatenate([X224, mats[fam][0]], axis=1))
        Xte2 = _finite_or_nan(np.concatenate([X224_te, mats[fam][1]], axis=1))
        hist_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = train_cv(Xtr2, y, Xte2, V34A_PARAMS._replace(n_rounds=FAMILY2_ROUNDS),
                      device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, want_k1 = hist_cuda.launches, V34A_PARAMS.max_depth * cv.rounds_run
        k1_all += k1
        test_f1 = f1_score(y_te, cv.test_preds > cv.best_threshold)
        log(f"  {name} (+ {fam}): {Xtr2.shape[1]} columns, {secs:.3f} s; rounds "
            f"{cv.rounds_run}; OOF F1 {cv.best_f1:.4f} @ {cv.best_threshold:.3f}; TEST F1 "
            f"{test_f1:.4f}; K1 launches {k1} (rounds x depth predicts {want_k1})")
        if k1 != want_k1 or k1 == 0:
            raise AssertionError(f"{name}: K1 launches disagree with rounds x depth")
        if not (np.isfinite(cv.oof_preds).all() and np.isfinite(cv.test_preds).all()):
            raise AssertionError(f"{name}: non-finite outputs")
        rows[name] = {"family": fam, "s": secs, "columns": Xtr2.shape[1],
                      "rounds": cv.rounds_run, "oof_f1": cv.best_f1,
                      "threshold": cv.best_threshold, "test_f1": test_f1, "k1": k1}

    rows["augmentation"] = check_augmentation(tr_packed, tr_meta)
    log(f"families 2: K1 launches {k1_all}; gp1d's K2 launches by width {gp1d_k2}")
    return {"k1": k1_all, "gp1d_k2": gp1d_k2, "rows": rows,
            "families": {f: {"columns": len(mats[f][2]), **refs[f]} for f in mats}}


DL_EPOCHS = 100  # the command line's default for v10 / v13 / v22 / v27
V14_STEPS = 150  # the command line's default for v14
PRETRAIN_STEPS = 300
PRETRAIN_BATCH = 256
ASTROMER_MIN_POINTS = 5  # pretraining's corpus: bands with >= 5 valid points


def run_dl(trained: dict, runners: dict, dev) -> dict:
    """The DL models phase, on the training run's packed splits and the
    runners' 224-column v34a matrix: v10 / v13 / v22 / v27 (DL_EPOCHS
    epochs each), v14, astromer's columns against the CPU, v26 (K1 =
    rounds x depth) and pretraining."""
    tr_packed, tr_meta = trained["tr"]
    te_packed, te_meta = trained["te"]
    y, y_te = np.asarray(tr_meta.target), np.asarray(te_meta.target)
    X224, X224_te, names224 = runners["X224"]
    rows = {}
    log(f"  views: train all-band {tuple(tr_packed.all_time.shape)}, band "
        f"{tuple(tr_packed.band_time.shape)}; test all-band {tuple(te_packed.all_time.shape)}, "
        f"band {tuple(te_packed.band_time.shape)}; tabular {X224.shape[1]} columns")

    for config in DL_CONFIGS:
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_dl_model(config, tr_packed, tr_meta, te_packed, te_meta, X_tab=X224,
                           X_tab_test=X224_te, n_epochs=DL_EPOCHS, timings=timings, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = res.losses
        test_f1 = f1_score(y_te, res.test_preds > res.threshold)
        ms_epoch = 1e3 * timings["train"] / DL_EPOCHS
        log(f"  {config} ({type(res.model).__name__}): {res.n_train} / {res.n_val} objects, "
            f"{secs:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            + f"); {ms_epoch:.2f} ms per epoch incl. the validation sweep; loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}; val F1 {res.val_f1:.4f} @ "
            f"{res.threshold:.3f}; TEST F1 {test_f1:.4f}; peak memory {peak:.2f} GiB")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and np.isfinite(res.val_probs).all() and np.isfinite(res.test_preds).all()
                and res.test_preds.shape == (te_packed.n_objects,)):
            raise AssertionError(f"{config}: non-finite or non-falling training")
        rows[config] = {"model": type(res.model).__name__, "s": secs, "ms_per_epoch": ms_epoch,
                        "epochs": DL_EPOCHS, "loss_first": float(losses[0]),
                        "loss_last": float(losses[-1]), "val_f1": res.val_f1,
                        "threshold": res.threshold, "test_f1": test_f1, "peak_gib": peak,
                        **{f"{k}_s": v for k, v in timings.items()}}
        del res

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_v14(X224, y, X224_te, n_epochs=V14_STEPS, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    test_f1 = f1_score(y_te, out["test_preds"] > out["threshold"])
    log(f"  v14 (residual MLP, 5 folds x {V14_STEPS} steps): {secs:.3f} s; OOF F1 "
        f"{out['best_f1']:.4f} @ {out['threshold']:.3f}; TEST F1 {test_f1:.4f}")
    if not (np.isfinite(out["oof"]).all() and np.isfinite(out["test_preds"]).all()):
        raise AssertionError("v14: non-finite outputs")
    rows["v14"] = {"s": secs, "oof_f1": out["best_f1"], "threshold": out["threshold"],
                   "test_f1": test_f1}

    # the family takes no templates: an empty stand-in
    ref = check_family2_reference("astromer", lambda p, m, t: astromer.extract(p), te_packed,
                                  te_meta, torch.empty(0))
    timings = {}
    hist_cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v26 = run_v26(X224, y, names224, tr_packed, X224_te, te_packed, params=V34A_PARAMS,
                  timings=timings, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cv = v26.cv
    k1, want_k1 = hist_cuda.launches, V34A_PARAMS.max_depth * cv.rounds_run
    n_seq = 4 * (tr_packed.n_objects + te_packed.n_objects)
    finite = float(np.isfinite(v26.astromer_test).mean())
    test_f1 = f1_score(y_te, cv.test_preds > cv.best_threshold)
    log(f"  astromer: {n_seq} single-band sequences of both splits encoded in "
        f"{timings['astromer']:.3f} s; 146 columns, finite share (test) {finite:.4f}")
    log(f"  v26 (+ astromer): {len(v26.feature_names)} columns, {secs:.3f} s; rounds "
        f"{cv.rounds_run}; OOF F1 {cv.best_f1:.4f} @ {cv.best_threshold:.3f}; TEST F1 "
        f"{test_f1:.4f}; K1 launches {k1} (rounds x depth predicts {want_k1})")
    if k1 != want_k1 or k1 == 0:
        raise AssertionError("v26: K1 launches disagree with rounds x depth")
    if not (np.isfinite(cv.oof_preds).all() and np.isfinite(cv.test_preds).all()):
        raise AssertionError("v26: non-finite outputs")
    rows["v26"] = {"s": secs, "astromer_s": timings["astromer"], "sequences": n_seq,
                   "columns": len(v26.feature_names), "rounds": cv.rounds_run,
                   "oof_f1": cv.best_f1, "threshold": cv.best_threshold, "test_f1": test_f1,
                   "k1": k1, "reference": ref}

    n_b = tr_packed.n_objects * 6
    seqs = normalize_band(*(getattr(tr_packed, a).reshape(n_b, -1)
                            for a in ("band_time", "band_flux", "band_err", "band_mask")))
    keep = seqs.n_valid >= ASTROMER_MIN_POINTS
    seqs = BandSequences(*(a[keep] for a in seqs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, hist = pretrain(seqs, d_model=48, n_layers=2, n_heads=4, n_steps=PRETRAIN_STEPS,
                          batch_size=PRETRAIN_BATCH, eval_every=50, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  pretraining: {seqs.times.shape[0]} band sequences of {seqs.times.shape[1]} points, "
        f"{PRETRAIN_STEPS} steps of {PRETRAIN_BATCH} in {secs:.3f} s "
        f"({1e3 * secs / PRETRAIN_STEPS:.2f} ms per step); masked-reconstruction loss "
        + ", ".join(f"{i}: {v:.4f}" for i, v in hist))
    if not (np.isfinite([v for _, v in hist]).all() and hist[-1][1] < hist[0][1]):
        raise AssertionError("pretraining's loss did not fall")
    rows["pretrain"] = {"s": secs, "sequences": int(seqs.times.shape[0]),
                        "loss": [list(h) for h in hist]}
    log(f"DL models: K1 launches {k1}")
    return {"k1": k1, "rows": rows}


# The command line phase: the port's user surface from CSV files in the
# reference's layout to a submission, run in-process on a temporary
# workspace at the full bench split.
CLI_SHARDS = 20  # the reference's split_01..split_20
CLI_FAMILIES = "features_v4,tde_physics,multiband_gp,bazin"
CLI_MARGIN = 1e-4  # predict's rows this close to the threshold may flip


class FitLog:
    """Records (depth, rounds run) of every batched fit ``train_cv`` runs,
    from the fold models it returns, while installed (the K1 prediction of
    a command's fits: rounds x depth each)."""

    def __init__(self):
        self.fits = []
        self._orig = None

    def __enter__(self):
        from mallorn_tpu_torch.train import cv as cv_module

        self._module, self._orig = cv_module, cv_module.train_gbdt_folds

        def recorded(folds, params, *args, **kwargs):
            models = self._orig(folds, params, *args, **kwargs)
            rounds = max(int(np.isfinite(m.eval_history).sum()) for m in models)
            self.fits.append((params.max_depth, rounds))
            return models

        cv_module.train_gbdt_folds = recorded
        return self

    def __exit__(self, *exc):
        self._module.train_gbdt_folds = self._orig

    def k1(self) -> int:
        return sum(d * r for d, r in self.fits)


def run_cli(trained: dict, dev, work: Path) -> dict:
    """The command line phase: the bench split written in the reference's
    CSV layout and read back through the native parser (bit for bit
    ``load_split``'s tensors), then ``extract`` (K2 launches = the GP
    schedule's prediction), ``train --config v92`` (all four variants; K1 =
    rounds x depth; v92d's gate), ``train --config v34a`` (the selection
    from the cache; its gate) and ``predict`` from the saved v92d models
    (agreeing with train's submission away from the threshold), each
    command's seconds; predict once more under ``device_trace``. ``work``
    holds the workspace (the mesh phase trains in it again)."""
    from mallorn_tpu_torch.cli.main import main as cli_main
    from mallorn_tpu_torch.data.loader import load_all_data
    from mallorn_tpu_torch.data.synthetic import write_reference_layout
    from mallorn_tpu_torch.io import native
    from mallorn_tpu_torch.train import pipelines
    from mallorn_tpu_torch.utils.profiling import device_trace

    data, cache, out = work / "data", work / "cache", work / "artifacts"
    secs = {}
    t0 = time.perf_counter()
    n_rows = 0
    with np.load(DATA, allow_pickle=False) as z:
        for tag, split in (("tr", "train"), ("te", "test")):
            cols = {k: z[f"{tag}_{k}"]
                    for k in ("object_index", "time", "flux", "flux_err", "band")}
            meta = Metadata(object_ids=z[f"{tag}_object_ids"], z=z[f"{tag}_z"],
                            ebv=z[f"{tag}_ebv"], target=z[f"{tag}_target"])
            write_reference_layout(data, cols, meta, n_splits=CLI_SHARDS, split=split)
            n_rows += len(cols["time"])
    secs["write"] = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in data.rglob("*.csv"))
    t0 = time.perf_counter()
    native.build()
    secs["parser build"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_all_data(data, device=dev)
    torch.cuda.synchronize()
    secs["read"] = time.perf_counter() - t0
    log(f"  layout: {n_rows:,} rows in {CLI_SHARDS} shards per split, {size / 1e6:.1f} MB; "
        f"write {secs['write']:.3f} s ({n_rows / secs['write']:,.0f} rows/s), parser "
        f"build {secs['parser build']:.3f} s, read + pack {secs['read']:.3f} s "
        f"({n_rows / secs['read']:,.0f} rows/s)")
    want = unify_time_padding(trained["tr"][0], trained["te"][0])
    for split, w, (_, w_meta) in zip(("train", "test"), want, (trained["tr"], trained["te"])):
        got, meta = loaded[f"{split}_packed"], loaded[f"{split}_meta"]
        same = (got.time_offset == w.time_offset and all(
            bits_equal(a, b) if a.dtype == torch.float32 else torch.equal(a, b)
            for a, b in zip(got.tensors(), w.tensors())))
        same_meta = (np.array_equal(meta.object_ids, w_meta.object_ids)
                     and np.array_equal(meta.z.view(np.uint32), w_meta.z.view(np.uint32))
                     and np.array_equal(meta.ebv.view(np.uint32),
                                        w_meta.ebv.view(np.uint32))
                     and (np.array_equal(meta.target, w_meta.target) if split == "train"
                          else meta.target is None))
        log(f"  {split}: packed {tuple(got.band_time.shape)} / {tuple(got.all_time.shape)} "
            f"bit for bit load_split's: {same}; metadata equal: {same_meta}")
        if not (same and same_meta):
            raise AssertionError(f"the {split} split read from CSV differs from load_split's")
    del loaded

    def timed(name, argv):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        log(f"  {name}: {secs[name]:.3f} s")

    chol_cuda.reset_launches()
    hist_cuda.reset_launches()
    timed("extract", ["extract", "--data", str(data), "--cache", str(cache),
                      "--families", CLI_FAMILIES, "--gp-steps", str(GP_STEPS)])
    want_chol = expected_training_chol(trained["tr"][0], trained["te"][0], GP_STEPS)
    log(f"  extract: K2 launches {chol_cuda.launches} (GP schedule predicts {want_chol}); "
        f"by width {dict(chol_cuda.launches_by_t)}; cluster {chol_cuda.cluster_launches}, "
        f"tiled {chol_cuda.large_launches}")
    if chol_cuda.launches != want_chol:
        raise AssertionError("extract's K2 launches disagree with the GP schedule")
    k2, k2_by_t = chol_cuda.launches, dict(chol_cuda.launches_by_t)

    k1 = {}
    v92_runs = []
    run_v92 = pipelines.run_v92

    def keep_v92(*args, **kwargs):
        v92_runs.append(run_v92(*args, **kwargs))
        return v92_runs[-1]

    results = {}
    for config in ("v92", "v34a"):
        hist_cuda.reset_launches()
        pipelines.run_v92 = keep_v92
        try:
            with FitLog() as fits:
                timed(f"train {config}", ["train", "--data", str(data), "--cache",
                                          str(cache), "--config", config, "--out",
                                          str(out)])
        finally:
            pipelines.run_v92 = run_v92
        k1[config] = hist_cuda.launches
        results[config] = json.loads((out / f"result_{config}.json").read_text())
        log(f"  train {config}: fits (depth, rounds) {fits.fits}; K1 launches {k1[config]} "
            f"(rounds x depth predicts {fits.k1()})")
        if k1[config] != fits.k1() or k1[config] == 0:
            raise AssertionError(f"train {config}: K1 launches disagree with rounds x depth")
    v92 = v92_runs[0]
    for name, cv in v92.variants.items():
        log(f"  v92 {name}: OOF F1 {cv.best_f1:.4f} @ {cv.best_threshold:.3f}, rounds "
            f"{cv.rounds_run}")
    f1_92, f1_34 = results["v92"]["oof_f1"], results["v34a"]["oof_f1"]
    log(f"  v92d OOF F1 {f1_92:.4f} (gate {F1_GATE}; the training phase's "
        f"{trained['oof_f1']:.4f}, equal: {f1_92 == trained['oof_f1']}); v34a OOF F1 "
        f"{f1_34:.4f} (gate {V34A_F1_GATE}); adversarial AUC {results['v92']['adv_auc']:.4f}")
    if f1_92 < F1_GATE or f1_34 < V34A_F1_GATE:
        raise AssertionError("the command line's OOF F1 is below its gate")

    timed("predict", ["predict", "--data", str(data), "--cache", str(cache), "--model",
                      str(out / "models_v92"), "--out", str(work / "pred")])
    probs = np.load(work / "pred" / "probs_test.npy")
    thr = results["v92"]["threshold"]

    def labels(path):
        return np.array([int(line.rsplit(",", 1)[1])
                         for line in path.read_text().splitlines()[1:]])

    sub_pred = labels(work / "pred" / "submission_test.csv")
    sub_train = labels(out / "submission_v92.csv")
    far = np.abs(probs - thr) > CLI_MARGIN
    diff = float(np.abs(probs - v92.winner.test_preds).max())
    log(f"  predict: {len(probs)} probabilities, finite {bool(np.isfinite(probs).all())}; "
        f"max |predict - train| {diff:.3g}; {int((sub_pred != sub_train).sum())} labels "
        f"differ from train's submission, {int((far & (sub_pred != sub_train)).sum())} of "
        f"them farther than {CLI_MARGIN:g} from the threshold {thr:.4f}; "
        f"{int(sub_pred.sum())} TDEs")
    if (probs.shape != (len(sub_train),) or not np.isfinite(probs).all()
            or (far & (sub_pred != sub_train)).any()):
        raise AssertionError("predict's submission disagrees with train's")

    with device_trace(str(work / "trace")) as prof:
        t = time.perf_counter()
        cli_main(["predict", "--data", str(data), "--cache", str(cache), "--model",
                  str(out / "models_v92"), "--out", str(work / "pred_traced")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traces = list((work / "trace").glob("trace_*.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if traces else []
    kern = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kern) / 1e6
    traced = np.load(work / "pred_traced" / "probs_test.npy")
    log(f"  predict traced (torch.profiler, CPU + CUDA): {wall:.3f} s, {len(traces)} trace "
        f"file(s), {len(events)} events, {len(kern)} CUDA kernels, {1e3 * busy:.3f} ms of "
        f"kernel time (at most {busy / wall:.4f} of the traced wall time); probabilities "
        f"equal to the untraced run's: {np.array_equal(traced, probs)}")
    if len(traces) != 1 or not kern or not np.array_equal(traced, probs):
        raise AssertionError("the traced predict wrote no trace of CUDA kernels, or "
                             "its probabilities differ from the untraced run's")

    def dev_us(a):  # the profiler's name for device time changed across versions
        us = getattr(a, "self_device_time_total", None)
        return getattr(a, "self_cuda_time_total", 0) if us is None else us

    for a in sorted(prof.key_averages(), key=lambda a: -dev_us(a))[:5]:
        log(f"    {a.key[:60]}: {a.count} calls, {dev_us(a) / 1e3:.3f} ms on the card")
    log("  command seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return {"k1": sum(k1.values()), "k2": k2, "k2_by_t": k2_by_t, "secs": secs,
            "v92_f1s": {k: v.best_f1 for k, v in v92.variants.items()}}



# the mesh phase: the two-rank v92d CV's rounds (training's 500 cut to
# this), the leaf-wise v114d CV's, and the sharded extraction's chunks
# (the single-device bundle's, so that each chunk's GP width is the same)
MESH_ROUNDS, MESH_LG_ROUNDS, MESH_CHUNK = 50, 10, 2048
# a sharded forest against the single-device one (tests/test_sharded_training.py:35-45,
# :107-122): leaf values, eval history; the extraction's bars
# (tests/test_sharded_pipeline.py:42-56) and Bazin's share of close lanes
MESH_LEAF_TOL, MESH_HIST_TOL = (2e-4, 2e-5), (1e-4, 1e-5)
MESH_FEAT_TOL, MESH_BAZIN_TOL, MESH_BAZIN_SHARE = (2e-4, 1e-5), (1e-3, 1e-4), 0.85
V92D_GRID = np.linspace(0.05, 0.5, 200)  # run_v92's threshold grid


def mesh_v92(mesh, X224, y, names, X224_te):
    """``run_v92``'s v92d variant with every CV on ``mesh``."""
    from mallorn_tpu_torch.train.pipelines import V92D_ONLY, run_v92

    return run_v92(X224, y, names, X224_te, params=V34A_PARAMS, variants=V92D_ONLY,
                   mesh=mesh)


def mesh_ranks(mesh, X, y, w, packed, meta):
    """The mesh phase on each of its gloo ranks: the v92d CV at MESH_ROUNDS,
    one v114d leaf-wise CV at MESH_LG_ROUNDS, and the train split's v34a
    families extracted with the objects split over the ranks. Returns rank
    0's results with every rank's launches, bytes and seconds."""
    from mallorn_tpu_torch.parallel.pipeline import extract_v34a_bundle_sharded

    def counted(fn):
        hist_cuda.reset_launches()
        chol_cuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh.record() as calls:
            res = fn()
        torch.cuda.synchronize()
        hist_bytes = sum(b for k, s, b in calls if k == "all_reduce_sum" and s.startswith("int64"))
        return res, [time.perf_counter() - t0, hist_cuda.i64_launches,
                     hist_cuda.seg_i64_launches,
                     hist_cuda.launches + hist_cuda.seg_launches,
                     chol_cuda.launches + chol_cuda.cluster_launches + chol_cuda.large_launches,
                     hist_bytes, sum(b for _, _, b in calls), len(calls)]

    cv, c_cv = counted(lambda: train_cv(
        X, y, None, V34A_PARAMS._replace(n_rounds=MESH_ROUNDS), sample_weight=w,
        threshold_grid=V92D_GRID, mesh=mesh))
    lg, c_lg = counted(lambda: train_cv(
        X, y, None, V114D_PARAMS._replace(n_rounds=MESH_LG_ROUNDS), sample_weight=w,
        threshold_grid=V92D_GRID, mesh=mesh))
    bundle, c_ex = counted(lambda: extract_v34a_bundle_sharded(
        mesh, packed, meta, GP_STEPS, chunk_size=MESH_CHUNK))
    stats = torch.tensor([c_cv, c_lg, c_ex], dtype=torch.float64, device=mesh.device)
    per_rank = mesh.all_gather(stats[None]).cpu().numpy()
    return {"cv": cv, "lg": lg, "per_rank": per_rank,
            "bundle": {f: {k: v.cpu() for k, v in fs.items()} for f, fs in bundle.items()}}


def forests_close(name: str, got, want) -> bool:
    """Sharded fold models against single-device ones at the JAX package's
    sharded-training bars (raises where they differ); returns whether every
    forest and eval history is also equal bit for bit."""
    exact = True
    for k, (a, b) in enumerate(zip(got, want)):
        fa, fb = (type(a.forest)(*[t.cpu() for t in m.forest]) for m in (a, b))
        same = torch.equal(fa.feature, fb.feature) and torch.equal(fa.split_bin, fb.split_bin)
        leaf = close(fa.leaf_value, fb.leaf_value, *MESH_LEAF_TOL)
        hist = np.allclose(a.eval_history, b.eval_history, *MESH_HIST_TOL)
        bits = forests_bits_equal(fa, fb) and np.array_equal(a.eval_history, b.eval_history)
        exact = exact and bits
        log(f"  {name} fold {k}: features and split bins equal {same}; leaf values max "
            f"|d| {leaf[0]:.3e} (rtol {MESH_LEAF_TOL[0]:g}, atol {MESH_LEAF_TOL[1]:g}) "
            f"{'ok' if leaf[2] else 'FAIL'}; eval history within rtol {MESH_HIST_TOL[0]:g} "
            f"{hist}; best iteration {a.best_iteration} / {b.best_iteration}; forest and "
            f"history bit for bit {bits}")
        if not (same and leaf[2] and hist and a.best_iteration == b.best_iteration):
            raise AssertionError(f"{name}: the sharded fold {k} differs from single-device")
    return exact


def run_mesh(trained: dict, workspace, dev) -> dict:
    """The mesh phase: (a) ``run_v92`` on a world-size-1 NCCL mesh in this
    process (forests bit for bit the training phase's, K1's external-scale
    entry launched rounds x depth times); (b) two gloo ranks on this card:
    the v92d CV at MESH_ROUNDS and a v114d leaf-wise CV against their
    single-device fits, (c) the train split's sharded extraction against
    the training phase's bundle; (d) ``train --config v34a --mesh 1`` in the
    command line phase's workspace, its result JSON equal to that phase's,
    and ``--mesh 2`` refused."""
    from mallorn_tpu_torch.cli.main import main as cli_main
    from mallorn_tpu_torch.parallel.mesh import default_mesh, launch

    out = trained["out"]
    tr_packed, tr_meta = trained["tr"]
    te_packed, _ = trained["te"]
    y = np.asarray(tr_meta.target)
    X224, names224 = assemble_v34a_matrix(out.bundles[0], out.selection.selected)
    X224_te, _ = assemble_v34a_matrix(out.bundles[1], out.selection.selected)
    X224, X224_te = X224.cpu().numpy(), X224_te.cpu().numpy()
    res = {}

    # (a) world size 1 over NCCL, in this process
    hist_cuda.reset_launches()
    t0 = time.perf_counter()
    v92 = launch(mesh_v92, 1, (X224, y, names224, X224_te), device=dev, spawn=False)
    torch.cuda.synchronize()
    res["ws1_s"] = time.perf_counter() - t0
    rr = out.rounds_run
    want = ADV_PARAMS.max_depth * rr["adversarial"] + V34A_PARAMS.max_depth * rr["v92d"]
    same = all(forests_bits_equal(a.forest, b.forest)
               for a, b in zip(v92.winner.models, out.winner.models))
    res["ws1_k1"] = hist_cuda.i64_launches
    log(f"  (a) run_v92 on a world-size-1 NCCL mesh: {res['ws1_s']:.3f} s; v92d forests bit "
        f"for bit the training phase's: {same}; OOF F1 {v92.winner.best_f1:.4f} (training "
        f"{out.winner.best_f1:.4f}); adversarial AUC {v92.adversarial.auc:.4f} "
        f"({out.adversarial.auc:.4f}); K1's external-scale launches {hist_cuda.i64_launches} "
        f"(rounds x depth predicts {want}), float32 K1 {hist_cuda.launches}")
    if (not same or v92.winner.best_f1 != out.winner.best_f1 or hist_cuda.i64_launches != want
            or hist_cuda.launches or default_mesh() is not None):
        raise AssertionError("(a) the world-size-1 mesh differs from the training phase")

    # (b), (c) two gloo ranks on this card
    keep = [i for i, n in enumerate(names224) if n not in SHIFT_FEATURES]
    X = _finite_or_nan(X224[:, keep])
    w = out.adversarial.sample_weights
    tr_u, _ = unify_time_padding(tr_packed, te_packed)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    r = launch(mesh_ranks, 2, (X, y, w, tr_u.map(lambda x: x.to(cpu)), tr_meta), device=dev,
               shared_device=True, timeout=600)
    res["ranks_s"] = time.perf_counter() - t0
    pr = r["per_rank"]  # [rank, stage (cv, lg, extract), counter]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cv_ref = train_cv(X, y, None, V34A_PARAMS._replace(n_rounds=MESH_ROUNDS), sample_weight=w,
                      threshold_grid=V92D_GRID, device=dev)
    torch.cuda.synchronize()
    res["single_cv_s"] = time.perf_counter() - t0
    lg_ref = train_cv(X, y, None, V114D_PARAMS._replace(n_rounds=MESH_LG_ROUNDS),
                      sample_weight=w, threshold_grid=V92D_GRID, device=dev)
    log(f"  (b) two gloo ranks on one card (collectives through pinned host memory): "
        f"{res['ranks_s']:.3f} s for the call, rank seconds v92d CV {pr[:, 0, 0].round(3)}, "
        f"v114d CV {pr[:, 1, 0].round(3)}, extraction {pr[:, 2, 0].round(3)}; the v92d CV "
        f"on one card without a mesh {res['single_cv_s']:.3f} s")
    cv_rounds, lg_rounds = r["cv"].rounds_run, r["lg"].rounds_run
    for rank in range(2):
        log(f"    rank {rank}: K1 external-scale launches {int(pr[rank, 0, 1])} (v92d, "
            f"{cv_rounds} rounds x 5 predicts {cv_rounds * V34A_PARAMS.max_depth}), K3 "
            f"{int(pr[rank, 1, 2])} (v114d, {lg_rounds} rounds x {V114D_PARAMS.max_leaves} "
            f"predicts {lg_rounds * V114D_PARAMS.max_leaves}), float32 K1 / K3 "
            f"{int(pr[rank, 0, 3] + pr[rank, 1, 3])}; int64 bytes all-reduced per round "
            f"{pr[rank, 0, 5] / cv_rounds:,.0f} (v92d) and {pr[rank, 1, 5] / lg_rounds:,.0f} "
            f"(v114d); {int(pr[rank, 0, 7])} collectives in the v92d CV")
    res["bits"] = (forests_close("v92d CV", r["cv"].models, cv_ref.models)
                   and forests_close("v114d CV", r["lg"].models, lg_ref.models))
    log(f"  v92d CV OOF F1 {r['cv'].best_f1:.4f} / single-device {cv_ref.best_f1:.4f}; v114d "
        f"{r['lg'].best_f1:.4f} / {lg_ref.best_f1:.4f}; every sharded forest bit for bit the "
        f"single-device one: {res['bits']}")
    if ((pr[:, 0, 1] != cv_rounds * V34A_PARAMS.max_depth).any()
            or (pr[:, 1, 2] != lg_rounds * V114D_PARAMS.max_leaves).any()
            or (pr[:, :2, 3] != 0).any()):
        raise AssertionError("(b) a rank's launches disagree with the prediction")

    # (c) the sharded extraction against the training phase's bundle
    want_b = out.bundles[0]
    worst = {}
    for fam, cols in want_b.items():
        got = r["bundle"][fam]
        if list(got) != list(cols):
            raise AssertionError(f"(c) {fam}: the sharded columns differ from single-device")
        rt, at = MESH_BAZIN_TOL if fam == "bazin" else MESH_FEAT_TOL
        shares = [float(torch.isclose(got[k].double(), cols[k].cpu().double(), rtol=rt, atol=at,
                                      equal_nan=True).double().mean()) for k in cols]
        worst[fam] = min(shares)
    log(f"  (c) sharded extraction of {tr_packed.n_objects} objects on 2 ranks: K2 launches per "
        f"rank {pr[:, 2, 4].astype(int).tolist()}; the smallest share of close lanes per "
        f"family {worst} (bazin >= {MESH_BAZIN_SHARE}, the others 1.0)")
    if any(v < 1.0 for f, v in worst.items() if f != "bazin") or worst["bazin"] < MESH_BAZIN_SHARE:
        raise AssertionError("(c) the sharded extraction differs from the single-device bundle")
    res.update(k1_ranks=pr[:, 0, 1].astype(int).tolist(), k3_ranks=pr[:, 1, 2].astype(int).tolist(),
               k2_ranks=pr[:, 2, 4].astype(int).tolist(),
               bytes_per_round=float(pr[0, 0, 5] / cv_rounds))

    # (d) the command line on the mesh
    if workspace is not None:
        data, cache, single = (workspace / d for d in ("data", "cache", "artifacts"))
        t0 = time.perf_counter()
        cli_main(["train", "--data", str(data), "--cache", str(cache), "--config", "v34a",
                  "--out", str(workspace / "artifacts_mesh"), "--mesh", "1"])
        res["cli_s"] = time.perf_counter() - t0
        a = json.loads((single / "result_v34a.json").read_text())
        b = json.loads((workspace / "artifacts_mesh" / "result_v34a.json").read_text())
        refused = ""
        try:
            cli_main(["train", "--data", str(data), "--cache", str(cache), "--config", "v34a",
                      "--out", str(workspace / "artifacts_mesh2"), "--mesh",
                      str(torch.cuda.device_count() + 1)])
        except SystemExit as e:
            refused = str(e)
        log(f"  (d) train --config v34a --mesh 1: {res['cli_s']:.3f} s, result JSON equal to "
            f"the single-device run's: {a == b} (OOF F1 {b['oof_f1']:.4f}); --mesh "
            f"{torch.cuda.device_count() + 1}: {refused!r}")
        if a != b or "devices available" not in refused or default_mesh() is not None:
            raise AssertionError("(d) the command line's mesh run differs or was not refused")
    return res


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kernels = []

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        log(smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    with Phase("build"):
        t0 = time.perf_counter()
        so = cuda_build.build(verbose=True)
        cuda_build.load()
        log(f"build: {time.perf_counter() - t0:.3f} s -> {so.relative_to(ROOT)}")

    with Phase("kernel checks"):
        results = [check_kernel(B, T, seed=1000 + T)
                   for B, T in ((2048, 64), (2048, 128), (2048, 160), (2048, 184), (2048, 192),
                                (2048, 240), (2047, 72))]
        for T in (64, 72, 184, 240):
            check_non_spd(T)
        for T in (64, 160):
            time_gp_step(REQUEST, T, seed=7000 + T)
        # gp1d's shapes: a chunk's 12,288 lanes (and one fewer) at the band
        # view's widths
        gp1d_results = [check_kernel(B, T, seed=8000 + B % 7 + T)
                        for B, T in GP1D_K2_SHAPES]
        # K2 beyond 240: each width on its own kernel alone (launch counters):
        # the blocked kernel up to MAX_T, the cluster kernel up to
        # MAX_T_CLUSTER, the tiled kernel beyond
        chol_cuda.reset_launches()
        wide_results = [check_kernel(B, T, seed=3000 + T)
                        for B, T in ((REQUEST, WIDE_T), (REQUEST, 288), (REQUEST, 320),
                                     (64, 256), (64, 320))]
        for T in (256, 288, 320):
            check_non_spd(T)
        log(f"  T <= {chol_cuda.MAX_T}: blocked launches by width "
            f"{dict(chol_cuda.launches_by_t)}, cluster {chol_cuda.cluster_launches}, tiled "
            f"{chol_cuda.large_launches}")
        if chol_cuda.large_launches or chol_cuda.cluster_launches or not chol_cuda.launches:
            raise AssertionError(f"T <= {chol_cuda.MAX_T} took another kernel than the blocked")
        # the cluster kernel (MAX_T < T <= MAX_T_CLUSTER), never another
        for T in (336, 432, 512, 576, 592, 784):
            C = chol_cuda.cluster_size(T)
            log(f"  T={T}: clusters of {C} CTAs, {chol_cuda.cluster_smem_bytes(T, C)} bytes of "
                f"shared memory each; {chol_cuda.cluster_occupancy(T)} clusters resident")
        chol_cuda.reset_launches()
        cluster_results = [check_kernel(B, T, seed=3000 + T)
                           for B, T in ((64, 336), (64, 400), (64, 512), (64, 432), (64, 576),
                                        (64, 784), (REQUEST, XL_T), (63, 344))]
        for T in (400, 512, 784):
            check_non_spd(T)
        by_c = dict(chol_cuda.cluster_launches_by_t)
        log(f"  {chol_cuda.MAX_T} < T <= {chol_cuda.MAX_T_CLUSTER}: cluster launches by width "
            f"{by_c}, blocked {chol_cuda.launches}, tiled {chol_cuda.large_launches}")
        if (chol_cuda.launches or chol_cuda.large_launches
                or set(by_c) != {r["T"] for r in cluster_results}):
            raise AssertionError(f"{chol_cuda.MAX_T} < T <= {chol_cuda.MAX_T_CLUSTER} did not "
                                 f"take the cluster kernel alone")
        # the tiled kernel beyond MAX_T_CLUSTER, never another: B = 8,
        # T = 800 (the column loop's row before it), the XXL server's width
        # at two batches (its own, 512) and a width not a multiple of 64
        chol_cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        tiled_results = [check_kernel(B, T, seed=seed) for B, T, seed in (
            (8, 800, 3800), (64, XXL_T, 4088), (XXL_OBJECTS, XXL_T, 4536), (63, 1000, 4063))]
        for T in (800, XXL_T):
            check_non_spd(T)
        by_l = dict(chol_cuda.large_launches_by_t)
        log(f"  T > {chol_cuda.MAX_T_CLUSTER}: tiled calls by width {by_l} ("
            + ", ".join(f"{chol_cuda.tiled_plan(T)[2]} kernel launches per call at T = {T}"
                        for T in sorted(by_l))
            + f"), cluster {chol_cuda.cluster_launches}, blocked {chol_cuda.launches}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if (chol_cuda.launches or chol_cuda.cluster_launches
                or set(by_l) != {r["T"] for r in tiled_results}):
            raise AssertionError(f"T > {chol_cuda.MAX_T_CLUSTER} did not take the tiled kernel "
                                 f"alone")
        # K6: its launches in this phase (checks and timing) are its rows'
        # counts: no path of the port calls it
        chol_cuda.reset_launches()
        chol_results = [check_cholesky(B, T, seed=5000 + T)
                        for B, T in ((2048, 64), (2048, 160), (2048, 192), (2048, 240),
                                     (64, 256), (64, 320))]
        check_cholesky_non_spd(64)
        check_cholesky_non_spd(320)
        k6_launches = chol_cuda.chol_launches
        if chol_cuda.chol_large_launches or chol_cuda.chol_cluster_launches or not k6_launches:
            raise AssertionError(f"K6 at T <= {chol_cuda.MAX_T} took another kernel than the "
                                 f"blocked")
        chol_cuda.reset_launches()
        chol_cluster_results = [check_cholesky(64, T, seed=5000 + T) for T in (400, 512)]
        for T in (400, 512):
            check_cholesky_non_spd(T)
        k6_cluster_launches = chol_cuda.chol_cluster_launches
        if chol_cuda.chol_launches or chol_cuda.chol_large_launches or not k6_cluster_launches:
            raise AssertionError("K6 at T = 400 / 512 did not take the cluster kernel alone")
        chol_cuda.reset_launches()
        chol_tiled_results = [check_cholesky(B, T, seed=seed)
                              for B, T, seed in ((8, 800, 5800), (64, XXL_T, 6088))]
        check_cholesky_non_spd(800)
        k6_tiled_calls = chol_cuda.chol_large_launches
        log(f"  K6 launches: blocked {k6_launches} (T <= {chol_cuda.MAX_T}), cluster "
            f"{k6_cluster_launches} (T = 400 / 512), tiled {k6_tiled_calls} calls (T = 800 / "
            f"{XXL_T}; {chol_cuda.tiled_plan(800, False)[2]} / "
            f"{chol_cuda.tiled_plan(XXL_T, False)[2]} kernel launches per call; blocked "
            f"{chol_cuda.chol_launches}, cluster {chol_cuda.chol_cluster_launches})")
        if chol_cuda.chol_launches or chol_cuda.chol_cluster_launches or not k6_tiled_calls:
            raise AssertionError(f"K6 at T > {chol_cuda.MAX_T_CLUSTER} did not take the tiled "
                                 f"kernel alone")

    with Phase("serving data + model"):
        packed, zz, ebv = load_test_split(dev)
        n = packed.n_objects
        # the GP's width and path are model state, fixed from the served set
        gp_tc, gp_two_phase = multiband_gp.serving_config(packed, GP_STEPS)
        log(f"test split: {n} objects, band view {tuple(packed.band_time.shape)}, "
            f"all-band view {tuple(packed.all_time.shape)}; GP width {gp_tc}, "
            f"two-phase {gp_two_phase}")
        # one feature pass over the served data, to fit the bin edges on the
        # served matrix and to draw the selected-120 from its names
        parts = [extract_bundle(packed.map(lambda x: x[s:e]), zz[s:e], ebv[s:e],
                                GP_STEPS, gp_tc, gp_two_phase)
                 for s, e in requests(n)]
        bundle = {fam: {k: torch.cat([p[fam][k] for p in parts]) for k in parts[0][fam]}
                  for fam in parts[0]}
        rng = np.random.default_rng(SEED)
        # v92d's selection holds both shift features, which it then drops
        v4_names = [k for k in bundle["features_v4"] if k not in SHIFT_FEATURES]
        picks = rng.choice(len(v4_names), N_SELECTED - len(SHIFT_FEATURES), replace=False)
        selected = list(SHIFT_FEATURES) + [v4_names[i] for i in picks]
        X224, names224 = assemble_v34a_matrix(bundle, selected)
        X, names = drop_shift_features(names224, X224)
        if len(names) != N_COLS:
            raise AssertionError(f"v92d matrix has {len(names)} columns, expected {N_COLS}")
        models = random_models(rng, X.cpu().numpy(), dev)
        server = V92dServer(models, names, selected, gp_steps=GP_STEPS,
                            gp_t_compact=gp_tc, gp_two_phase=gp_two_phase, device=dev)
        del parts, bundle, X224, X

    with Phase("serving"):
        chol_cuda.reset_launches()
        hist_cuda.reset_launches()
        timings: dict = {}
        t0 = time.perf_counter()
        probs = []
        for s, e in requests(n):
            sub = packed.map(lambda x: x[s:e])
            probs.append(server(sub, zz[s:e], ebv[s:e], timings=timings))
        probs = torch.cat(probs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = chol_cuda.launches
        by_t = dict(chol_cuda.launches_by_t)
        want = expected_launches(n, server)
        log(f"serving: {n} objects in {len(requests(n))} requests, {wall:.3f} s, "
            f"{n / wall:.1f} objects/s")
        log("serving phases (s): " + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()))
        log(f"chol_inv launches: {launches} (GP schedule predicts {want}); by width {by_t}")
        # the coarse phase's width and the server's (phase 2 and predict)
        widths = (multiband_gp._T_COARSE, gp_tc) if gp_two_phase else (gp_tc,)
        if launches != want or launches == 0 or any(by_t.get(w, 0) == 0 for w in widths):
            raise AssertionError(f"chol_inv launched {launches} times ({by_t}), expected "
                                 f"{want} with launches at every width of {widths}")
        p = probs.cpu().numpy()
        if p.shape != (n,) or not np.isfinite(p).all() or p.min() < 0 or p.max() > 1:
            raise AssertionError(f"bad probabilities: shape {p.shape}, "
                                 f"finite {np.isfinite(p).all()}, range [{p.min()}, {p.max()}]")
        log(f"probabilities: {n} finite in [{p.min():.4f}, {p.max():.4f}], mean {p.mean():.4f}")

    with Phase("reference on the CPU"):
        reference_check(server, models, names, selected, packed, zz, ebv)
        del server, models, packed

    with Phase("histogram kernel checks"):
        hist_results = [check_hist(fit, K, F, N, k, seed=2000 + 17 * i + k)
                        for i, (fit, K, F, N, nodes) in enumerate(HIST_SHAPES)
                        for k in sorted(set(nodes))]
        check_hist("ragged", 5, 222, 2443, 4, seed=2999, inactive=0.3)
        runner_hist = [check_hist(fit, K, F, N, k, seed=2500 + 17 * i + k)
                       for i, (fit, K, F, N, nodes) in enumerate(RUNNER_HIST_SHAPES)
                       for k in sorted(set(nodes))]
        policy_hist = [check_hist(fit, K, F, N, k, seed=2700 + 17 * i + k)
                       for i, (fit, K, F, N, nodes) in enumerate(POLICY_HIST_SHAPES)
                       for k in sorted(set(nodes))]
        family_hist = [check_hist(fit, K, F, N, k, seed=2900 + 17 * i + k)
                       for i, (fit, K, F, N, nodes) in enumerate(FAMILY_HIST_SHAPES)
                       for k in sorted(set(nodes))]
        name, K, F, N, nodes = POLICY_SEG_SHAPE
        policy_seg = check_seg_hist(name, K, F, N, nodes, seed=4100, inactive=0.0, missing=0.0)
        seg_results = [check_seg_hist(name, SEG_LANES, SEG_F, N, nodes, seed=4000 + i,
                                      inactive=inactive, missing=missing)
                       for i, (name, N, nodes, inactive, missing) in enumerate(SEG_SHAPES)]
        check_seg_hist_edges()
        mode_results = {mode: [check_mode_hist(mode, fit, K, F, N, k, seed=6000 + 17 * i + k)
                               for i, (fit, K, F, N, nodes) in enumerate(HIST_SHAPES)
                               for k in sorted(set(nodes))]
                        for mode in MODES}
        for mode in MODES:
            check_mode_hist(mode, "ragged", 5, 222, 2443, 4, seed=6999, inactive=0.3)
            # three node groups of the grid's z axis (8 + 8 + 1 nodes)
            check_mode_hist(mode, "nodes17", 5, 222, 2444, 17, seed=6998)
        i64_results = [check_hist_i64(kernel, fit, K, F, N, k, seed=9000 + 17 * i + k)
                       for i, (kernel, fit, K, F, N, nodes) in enumerate(I64_SHAPES)
                       for k in nodes]

    with Phase("kernel against plain in training"):
        check_training_kernel_vs_plain(dev)

    with Phase("training"):
        trained = run_training(dev)

    with Phase("histogram modes"):
        mode_runs = {mode: run_mode_training(mode, trained, dev) for mode in MODES}

    with Phase("serving the trained model"):
        served = serve_trained(trained, dev)

    with Phase("kaggle ensemble"):
        ensemble = run_ensemble(trained, dev)

    with Phase("runners"):
        runners = run_runners(trained, ensemble, dev)

    with Phase("policies"):
        policies = run_policies(trained, runners, dev)

    with Phase("families"):
        families = run_families(trained, ensemble, runners, dev)

    with Phase("families 2"):
        families2 = run_families2(trained, runners, dev)

    with Phase("DL models"):
        dl = run_dl(trained, runners, dev)

    cli_work = Path(tempfile.mkdtemp(prefix="mallorn_cli_"))
    try:
        with Phase("command line"):
            cli = run_cli(trained, dev, cli_work)

        with Phase("mesh"):
            mesh = run_mesh(trained, cli_work, dev)
    finally:
        shutil.rmtree(cli_work, ignore_errors=True)

    # K2's rows: the server's GP width (phase 2 and the predict) and the
    # coarse phase's width, each with serving's launches at that width
    for name, width in (("chol_inv", gp_tc), ("chol_inv_coarse", multiband_gp._T_COARSE)):
        r = next(r for r in results if (r["B"], r["T"]) == (REQUEST, width))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mallorn_tpu_torch/csrc/chol_inv_blocked.cu",
            "replaces": "mallorn_tpu/ops/chol_pallas.py:60",
            "launches": by_t.get(width, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [REQUEST, width, width],
        })
    kernels[-2]["cli_launches_by_t"] = cli["k2_by_t"]
    # K2 at gp1d's shapes, with the families 2 phase's launches at T = 40
    # (the test split) and all its launches by width
    r = gp1d_results[0]
    kernels.append({
        "name": "chol_inv_gp1d", "route": "cuda",
        "source": "mallorn_tpu_torch/csrc/chol_inv_blocked.cu",
        "replaces": "mallorn_tpu/ops/chol_pallas.py:60",
        "launches": families2["gp1d_k2"].get(r["T"], 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "shape": [r["B"], r["T"], r["T"]],
        "launches_by_t": families2["gp1d_k2"],
        "shapes": [{k: q[k] for k in ("B", "T", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")} for q in gp1d_results],
    })
    # K2 beyond 240: the blocked kernel at the wide server's width, the
    # cluster kernel at the XL server's and the tiled kernel at the XXL
    # server's, each with its server's launches (the tiled kernel's count
    # calls, each of tiled_plan(T)[2] kernel launches)
    main_wide = next(r for r in wide_results if (r["B"], r["T"]) == (REQUEST, WIDE_T))
    main_xl = next(r for r in cluster_results if (r["B"], r["T"]) == (REQUEST, XL_T))
    main_xxl = next(r for r in tiled_results if (r["B"], r["T"]) == (XXL_OBJECTS, XXL_T))
    for name, source, r, n_launches in (
            ("chol_inv_wide_server", "chol_inv_blocked.cu", main_wide, served["wide_launches"]),
            ("chol_inv_cluster", "chol_inv_cluster.cu", main_xl, served["xl_launches"]),
            ("chol_inv_tiled", "chol_tiled.cu", main_xxl, served["xxl_launches"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mallorn_tpu_torch/csrc/{source}",
            "replaces": "mallorn_tpu/ops/chol_pallas.py:60",
            "launches": n_launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [r["B"], r["T"], r["T"]],
        })
    # the tiled kernel's other shapes, and its kernel launches per call
    tiled_keys = ("B", "T", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")
    kernels[-1]["kernel_launches_per_call"] = chol_cuda.tiled_plan(XXL_T)[2]
    kernels[-1]["kernel_phase_calls"] = by_l
    kernels[-1]["shapes"] = [dict({k: r[k] for k in tiled_keys},
                                  kernel_launches_per_call=chol_cuda.tiled_plan(r["T"])[2])
                             for r in tiled_results]
    # the level histogram's rows: the deepest level of the v92d CV, with
    # training's launches, and of the ensemble's 25-lane members, with the
    # ensemble's
    # (the v92d row also carries the runners phase's launches, and K1 at the
    # runners' new shapes)
    for name, fit, n_launches in (("hist", "v92d", trained["launches"]),
                                  ("hist_ensemble", "kaggle", ensemble["k1"])):
        r = next(r for r in hist_results if (r["fit"], r["nodes"]) == (fit, 8))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mallorn_tpu_torch/csrc/hist.cu",
            "replaces": "mallorn_tpu/ops/hist_pallas.py:508",
            "launches": n_launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "launch_ms": r["launch_ms"],
            "features_per_cta": r["features_per_cta"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [r["K"], r["F"], r["N"], r["nodes"]],
        })
    shape_keys = ("fit", "K", "F", "N", "nodes", "max_abs_err", "ms", "launch_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels[-2]["runners_launches"] = runners["k1"]
    kernels[-2]["runner_shapes"] = [{k: r[k] for k in shape_keys} for r in runner_hist]
    kernels[-2]["policies_launches"] = policies["k1"]
    kernels[-2]["policy_shapes"] = [{k: r[k] for k in shape_keys} for r in policy_hist]
    kernels[-2]["families_launches"] = families["k1"]
    kernels[-2]["families2_launches"] = families2["k1"]
    kernels[-2]["dl_launches"] = dl["k1"]
    kernels[-2]["cli_launches"] = cli["k1"]
    kernels[-2]["family_shapes"] = [dict({k: r[k] for k in shape_keys},
                                         node_chunks=r["node_chunks"]) for r in family_hist]
    # the segment histogram's row: a v114d split step's pair of children
    main_seg = next(r for r in seg_results if r["name"] == "pair")
    kernels.append({
        "name": "seg_hist", "route": "cuda",
        "source": "mallorn_tpu_torch/csrc/hist.cu",
        "replaces": "mallorn_tpu/ops/hist_pallas.py:42",
        "launches": ensemble["k3"],
        "max_abs_err": main_seg["max_abs_err"], "ms": main_seg["ms"],
        "launch_ms": main_seg["launch_ms"], "features_per_cta": main_seg["features_per_cta"],
        "plain_ms": main_seg["plain_ms"], "bound_ms": main_seg["bound_ms"],
        "bound_by": main_seg["bound_by"], "library_ms": main_seg["library_ms"],
        "shape": [main_seg["K"], main_seg["F"], main_seg["N"], main_seg["n_seg"]],
        "runners_launches": runners["k3"],
        "policies_launches": policies["k3"],
        "policy_shapes": [{k: policy_seg[k] for k in (
            "name", "K", "F", "N", "n_seg", "max_abs_err", "ms", "launch_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}],
    })
    # K1's and K3's external-scale int64 entries: the v92d CV's deepest level
    # and the v114d pair, launches from the mesh phase (every rank's)
    for name, kernel, fit, nodes, n_launches, replaces in (
            ("hist_i64", "K1", "v92d", 8, mesh["ws1_k1"] + sum(mesh["k1_ranks"]),
             "mallorn_tpu/ops/hist_pallas.py:508"),
            ("seg_hist_i64", "K3", "v114d_pair", 2, sum(mesh["k3_ranks"]),
             "mallorn_tpu/ops/hist_pallas.py:42")):
        r = next(r for r in i64_results if (r["kernel"], r["nodes"]) == (kernel, nodes))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mallorn_tpu_torch/csrc/hist.cu",
            "replaces": replaces,
            "launches": n_launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "launch_ms": r["launch_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [r["K"], r["F"], r["N"], r["nodes"]],
        })
    # K1's and K3's launches under a mesh, on their float32 rows: the mesh
    # phase's external-scale launches at world size 1 over NCCL in this
    # process and on each gloo rank (the hist_i64 / seg_hist_i64 rows'
    # ``launches`` are their sums)
    by_name = {k["name"]: k for k in kernels}
    by_name["hist"]["mesh_launches"] = {"world_size_1_nccl": mesh["ws1_k1"],
                                        "two_gloo_ranks": mesh["k1_ranks"]}
    by_name["seg_hist"]["mesh_launches"] = {"two_gloo_ranks": mesh["k3_ranks"]}
    # the histogram modes' rows: the v92d CV's deepest level, launches from
    # the mode's training run; max_abs_err and plain_ms against the plain
    # version with the kernel's arithmetic (K4's fixed-point twin), and
    # max_abs_err_f64 the distance from the float64 oracle
    for mode in MODES:
        name = MODE_KERNELS[mode][0]
        r = next(r for r in mode_results[mode] if (r["fit"], r["nodes"]) == ("v92d", 8))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mallorn_tpu_torch/csrc/hist.cu",
            "replaces": ("mallorn_tpu/ops/hist_pallas.py:368" if mode == "int8"
                         else "mallorn_tpu/ops/hist_pallas.py:202"),
            "launches": mode_runs[mode]["launches"],
            "max_abs_err": r["max_abs_err"], "max_abs_err_f64": r["max_abs_err_f64"],
            "ms": r["ms"], "kernel_only_ms": r["kernel_only_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [r["K"], r["F"], r["N"], r["nodes"]],
        })
    # the factor-only Cholesky's rows: the blocked kernel at the GP's batch
    # and T = 160, the cluster kernel at B = 64, T = 400, the tiled kernel at
    # B = 64, T = 1024
    main_chol = next(r for r in chol_results if (r["B"], r["T"]) == (2048, 160))
    for name, source, r, n_launches in (
            ("chol", "chol_inv_blocked.cu", main_chol, k6_launches),
            ("chol_cluster", "chol_inv_cluster.cu", chol_cluster_results[0], k6_cluster_launches),
            ("chol_tiled", "chol_tiled.cu", chol_tiled_results[1], k6_tiled_calls)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mallorn_tpu_torch/csrc/{source}",
            "replaces": "mallorn_tpu/ops/chol_pallas.py:28",
            "launches": n_launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": [r["B"], r["T"], r["T"]],
        })
    kernels[-1]["kernel_launches_per_call"] = chol_cuda.tiled_plan(XXL_T, False)[2]
    kernels[-1]["shapes"] = [dict({k: r[k] for k in tiled_keys},
                                  kernel_launches_per_call=chol_cuda.tiled_plan(r["T"], False)[2])
                             for r in chol_tiled_results]
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(f"card: {smi}")  # every time above was taken on this card, at this limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
